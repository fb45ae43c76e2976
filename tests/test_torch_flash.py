"""The streaming kNN attention of the port (kernels/flash.py, the
fuse_pairwise=True path) against the JAX package on the CPU: the SH
payload and the basis constants, the plain stream against the JAX XLA
stream and the interpret-mode Pallas kernel (masked, prefixed, ragged,
fully masked rows, bf16 h), the recompute backward against jax.grad, and
fuse_pairwise twins of flagship_fast (output, loss and every gradient)
against the JAX model, against the port's own unfused model, and under a
per-block rule. Inputs and parameters are made from a seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu import SE3TransformerModule as JaxModule
from se3_transformer_tpu.kernels import pallas_flash as pf
from se3_transformer_torch import (
    SE3TransformerModule, convert_flax_params, denoise_loss,
)
from se3_transformer_torch.kernels import flash as kf

# one intra-op thread: these models are tiny, and pytest-xdist's workers
# would otherwise oversubscribe the CPU with spinning thread pools
torch.set_num_threads(1)

# the plain stream vs the JAX one: the same float32 products in other orders
RTOL = 1e-5

B, K, HEADS, KV_H, DIM_HEAD, MID = 1, 6, 2, 1, 4, 8
PAIRS = ((0, 2), (1, 2), (2, 3))
D_OUT = 1
DH = DIM_HEAD * (2 * D_OUT + 1)
IF = sum(c * (2 * min(d, D_OUT) + 1) for d, c in PAIRS)
O = KV_H * DIM_HEAD
SCALE = DIM_HEAD ** -0.5


def _inputs(n=13, prefix=1, masked=True, seed=0):
    """numpy operands of one call (h in bf16 values), with node 3's
    neighbors all masked."""
    rng = np.random.RandomState(seed)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)
    ops = dict(q=f32(B, n, HEADS, DH),
               xs=tuple(f32(B, n, c, 2 * d + 1) for d, c in PAIRS),
               idx=rng.randint(0, n, (B, n, K)),
               h_v=f32(B, n, K, MID), h_k=f32(B, n, K, MID),
               wv=f32(MID, IF, O), bv=f32(IF, O), wk=f32(MID, IF, O),
               bk=f32(IF, O), rel=f32(B, n, K, 3), nmask=None,
               prefix_k=None, prefix_v=None)
    if masked:
        ops['nmask'] = rng.rand(B, n, K) > 0.3
        ops['nmask'][:, 3] = False
    if prefix:
        ops['prefix_k'] = f32(B, n, prefix, KV_H * DH)
        ops['prefix_v'] = f32(B, n, prefix, KV_H * DH)
    return ops


def _run_jax(ops, h_dtype=jnp.bfloat16, interpret=False, **over):
    j = {k: (None if v is None else jnp.asarray(v))
         for k, v in ops.items() if k != 'xs'}
    args = dict(pairs=PAIRS, d_out=D_OUT, heads=HEADS, kv_heads=KV_H,
                scale=SCALE, h_k=j['h_k'].astype(h_dtype), wk=j['wk'],
                bk=j['bk'], sh=pf.flash_sh_payload(j['rel'], 2),
                prefix_k=j['prefix_k'], prefix_v=j['prefix_v'],
                pallas=False, interpret=interpret)
    args.update(over)
    return pf.flash_attention(j['q'], tuple(map(jnp.asarray, ops['xs'])),
                              j['idx'].astype(jnp.int32), j['nmask'],
                              j['h_v'].astype(h_dtype), j['wv'], j['bv'],
                              **args)


def _torch_ops(ops, h_dtype=torch.bfloat16):
    t = {k: (None if v is None else torch.from_numpy(np.asarray(v)))
         for k, v in ops.items() if k != 'xs'}
    t['xs'] = tuple(torch.from_numpy(x) for x in ops['xs'])
    t['h_v'], t['h_k'] = t['h_v'].to(h_dtype), t['h_k'].to(h_dtype)
    t['sh'] = kf.flash_sh_payload(t.pop('rel'), 2)
    return t


def _run_port(t, **over):
    args = dict(pairs=PAIRS, d_out=D_OUT, heads=HEADS, kv_heads=KV_H,
                scale=SCALE, h_k=t['h_k'], wk=t['wk'], bk=t['bk'],
                sh=t['sh'], prefix_k=t['prefix_k'], prefix_v=t['prefix_v'])
    args.update(over)
    return kf.flash_attention(t['q'], t['xs'], t['idx'], t['nmask'],
                              t['h_v'], t['wv'], t['bv'], **args)


def _close(out, ref, rtol=RTOL):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else out
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= rtol * np.abs(ref).max()


@pytest.mark.parametrize('max_degree', [1, 2, 3])
def test_sh_payload_matches_jax(max_degree):
    rel = np.random.RandomState(1).normal(size=(3, 5, 3)).astype(np.float32)
    rel[0, 0] = 0.      # the clamped origin
    ref = pf.flash_sh_payload(jnp.asarray(rel), max_degree)
    out = kf.flash_sh_payload(torch.from_numpy(rel), max_degree)
    assert out.shape == ref.shape == (3, 5, (2 * max_degree + 1) ** 2)
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-6


def test_pair_cg_matches_jax():
    for d_in in range(4):
        for d_out in range(4):
            ref = pf._pair_cg(d_in, d_out)
            out = kf._pair_cg(d_in, d_out)
            assert out.shape == ref.shape
            assert np.abs(out - ref).max() <= 1e-6, (d_in, d_out)


# kernel #7's radial product (csrc/flash_fwd.cu) at d_out 3's widths (mid
# 128, IF = 64 * (1 + 3 + 5 + 7), O 64) for one CTA's 64 edges: W3 split
# into bf16 hi + lo, each pass a product of bf16 values (exact in float32)
# summed in float32, against the float32 product of _kv_block's einsum
RADIAL_E, RADIAL_MID, RADIAL_IF, RADIAL_O = 64, 128, 1024, 64
# the passes against the float32 product, relative to its largest value
RADIAL_RTOL = 1e-4


def _bf16_split(t):
    """t as bf16 hi + lo (hi = bf16(t), lo = bf16(t - hi)), in float32."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _radial_case(h_dtype):
    """h [E, mid] (bf16 values for 'bfloat16'), W3 [mid, IF, O] and the
    JAX product einsum('...m,mio->...io', h, w3) in float32."""
    rng = np.random.RandomState(3)
    hj = jnp.asarray(rng.normal(size=(RADIAL_E, RADIAL_MID)), jnp.float32)
    if h_dtype == 'bfloat16':
        hj = hj.astype(jnp.bfloat16)
    w3 = (rng.normal(size=(RADIAL_MID, RADIAL_IF, RADIAL_O))
          * RADIAL_MID ** -0.5).astype(np.float32)
    ref = np.asarray(jnp.einsum('...m,mio->...io', hj, jnp.asarray(w3),
                                preferred_element_type=jnp.float32))
    h = torch.from_numpy(np.array(hj.astype(jnp.float32)))
    return h, torch.from_numpy(w3).reshape(RADIAL_MID, -1), ref


def _passes_error(terms, ref):
    """max |sum of the passes h_part . w_part - ref| over max |ref|."""
    out = sum(torch.matmul(hp, wp) for hp, wp in terms)
    out = out.reshape(RADIAL_E, RADIAL_IF, RADIAL_O).numpy()
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('h_dtype', ['bfloat16', 'float32'])
def test_kernel_radial_passes_match_the_float32_product(h_dtype):
    """Two bf16 passes (h.W_hi + h.W_lo) with bf16 h, three (h_hi.W_hi +
    h_hi.W_lo + h_lo.W_hi) with float32 h: what the kernel's mma.sync
    passes compute."""
    h, w3, ref = _radial_case(h_dtype)
    w_hi, w_lo = _bf16_split(w3)
    if h_dtype == 'bfloat16':
        assert torch.equal(h.to(torch.bfloat16).float(), h)
        terms = [(h, w_hi), (h, w_lo)]
    else:
        h_hi, h_lo = _bf16_split(h)
        terms = [(h_hi, w_hi), (h_hi, w_lo), (h_lo, w_hi)]
    assert _passes_error(terms, ref) <= RADIAL_RTOL


def test_one_bf16_pass_misses_the_float32_product():
    """W_hi alone (bf16 W3) is not within the tolerance: the lo pass is
    needed."""
    h, w3, ref = _radial_case('bfloat16')
    w_hi, _ = _bf16_split(w3)
    assert _passes_error([(h, w_hi)], ref) > RADIAL_RTOL


@pytest.mark.parametrize('case', [
    dict(), dict(prefix=0), dict(prefix=2, n=37), dict(masked=False)])
def test_plain_matches_jax_stream(case):
    """Masked and prefixed; a fully masked row with no prefix (the uniform
    average); two ragged node chunks (n = 37); no mask. bf16 h on both
    sides."""
    ops = _inputs(**case)
    _close(_run_port(_torch_ops(ops)), _run_jax(ops))


def test_plain_matches_jax_interpret_kernel():
    """The JAX Pallas kernel in interpret mode: online softmax over slot
    blocks, node and slot padding (n = 13, K = 6)."""
    ops = _inputs()
    _close(_run_port(_torch_ops(ops)), _run_jax(ops, interpret=True))


def test_padded_rows_leave_the_real_rows_unchanged():
    ops = _inputs()
    out = _run_port(_torch_ops(ops))
    rng, pad = np.random.RandomState(9), 7
    padded = dict(ops)
    for key in ('q', 'idx', 'nmask', 'h_v', 'h_k', 'rel', 'prefix_k',
                'prefix_v'):
        a = ops[key]
        extra = np.zeros((B, pad) + a.shape[2:], a.dtype)
        padded[key] = np.concatenate([a, extra], axis=1)
    padded['xs'] = tuple(np.concatenate(
        [x, rng.normal(size=(B, pad) + x.shape[2:]).astype(np.float32)],
        axis=1) for x in ops['xs'])
    out_p = _run_port(_torch_ops(padded))
    assert torch.equal(out_p[:, :13], out)


def test_online_softmax_fold_matches_row_attention():
    """The kernel's softmax (the prefix folded first, then slot blocks,
    slots past K with no weight) equals the row softmax of the stream."""
    rng = np.random.RandomState(4)
    cfg = kf.FlashConfig(pairs=PAIRS, d_out=D_OUT, heads=HEADS,
                         kv_heads=KV_H, scale=SCALE, prefix=1)
    q = torch.from_numpy(rng.normal(size=(5, HEADS, DH)).astype(np.float32))
    kf_, vf = (torch.from_numpy(rng.normal(size=(5, 1 + K, KV_H, DH))
                                .astype(np.float32)) for _ in range(2))
    mask = torch.from_numpy(rng.rand(5, 1 + K) > 0.3)
    mask[:, 0] = True
    mask[2, 1:] = False
    ref = kf._row_attention(cfg, q, kf_, vf, mask)
    qr = q.reshape(5, KV_H, HEADS // KV_H, DH)
    m, l, acc = kf._init_state(qr, kf_[:, :1], vf[:, :1], SCALE, DH)
    bj = 4                                 # K = 6: one padded block
    for j0 in range(1, 1 + K, bj):
        idx = torch.arange(j0, j0 + bj)
        inb = idx < 1 + K
        idx = idx.clamp(max=K)
        m, l, acc = kf._attend_block(qr, kf_[:, idx], vf[:, idx],
                                     mask[:, idx], m, l, acc, SCALE, inb)
    out = (acc / l[..., None]).reshape(q.shape)
    _close(out, ref.numpy())


def test_recompute_backward_matches_jax_grad():
    """The op's backward (the plain stream replayed chunk by chunk under
    autograd) against jax.grad of the JAX custom_vjp, for q, a node
    feature, h_v, wv, bk and the prefix, on two node chunks."""
    ops = _inputs(n=37)

    def loss_jax(q, x0, h_v, wv, bk, pk):
        xs = (x0,) + tuple(map(jnp.asarray, ops['xs'][1:]))
        j = {k: (None if v is None else jnp.asarray(v))
             for k, v in ops.items() if k != 'xs'}
        out = pf.flash_attention(
            q, xs, j['idx'].astype(jnp.int32), j['nmask'], h_v, wv, j['bv'],
            pairs=PAIRS, d_out=D_OUT, heads=HEADS, kv_heads=KV_H,
            scale=SCALE, h_k=j['h_k'], wk=j['wk'], bk=bk,
            sh=pf.flash_sh_payload(j['rel'], 2), prefix_k=pk,
            prefix_v=j['prefix_v'], pallas=False)
        return (out ** 2).sum()
    names = ('q', 'x0', 'h_v', 'wv', 'bk', 'prefix_k')
    vals = [ops['q'], ops['xs'][0], ops['h_v'], ops['wv'], ops['bk'],
            ops['prefix_k']]
    ref = jax.jit(jax.grad(loss_jax, argnums=tuple(range(6))))(
        *map(jnp.asarray, vals))
    t = _torch_ops(ops, h_dtype=torch.float32)
    leaves = [torch.from_numpy(v).requires_grad_() for v in vals]
    t.update(q=leaves[0], h_v=leaves[2], wv=leaves[3], bk=leaves[4],
             prefix_k=leaves[5])
    t['xs'] = (leaves[1],) + t['xs'][1:]
    (_run_port(t) ** 2).sum().backward()
    for name, leaf, want in zip(names, leaves, ref):
        assert leaf.grad is not None, name
        _close(leaf.grad, want)


@pytest.mark.parametrize('over', [dict(arm_v='so2', wv_scale=1.0),
                                  dict(wk_scale=1.0), dict(wv_scale=1.0)])
def test_unported_options_raise(over):
    """The quantized scales are ported (tests/test_torch_quant.py); a scale
    that is not a float32 [1, IF, O] tensor is refused before any arm or
    operand check."""
    t = _torch_ops(_inputs())
    with pytest.raises(TypeError, match='_scale must be a float32 tensor'):
        _run_port(t, **over)


# ---------------------------------------------------------------------- #
# the model: flagship_fast's fields with fuse_pairwise
# ---------------------------------------------------------------------- #
TWIN = dict(dim=8, depth=1, num_degrees=4, heads=8, dim_head=8,
            attend_self=True, num_neighbors=5, valid_radius=1e5,
            shared_radial_hidden=True, fuse_basis=True, reversible=True,
            remat_policy='save_conv_outputs', output_degrees=2,
            reduce_dim_out=True)
N = 14
# float32 trunk: summation order only. bf16 trunk: XLA keeps excess float32
# precision across some flax bf16 ops of the radial trunk that the port
# rounds (ROADMAP.md §C); with this seed the vector output and gradients
# differ from JAX by up to 2.5e-2 of their largest magnitude, as the
# unfused twin's do (2.3e-2, tests/test_torch_training.py), and the bound
# is that file's. Both relative to each leaf's largest magnitude.
MODEL_RTOL_F32 = 1e-4
MODEL_RTOL_BF16 = 5e-2


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    batch = dict(feats=rng.normal(size=(1, N, 8)).astype(np.float32),
                 coords=(rng.normal(size=(1, N, 3)) * 2).astype(np.float32),
                 masks=np.ones((1, N), bool))
    batch['masks'][0, -3:] = False
    return batch, rng.normal(size=(1, N, 3)).astype(np.float32)


def _random_params(shapes, seed):
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = str(path[-1].key)
        if name.startswith('scale'):
            v = 1 + 0.1 * rng.normal(size=s.shape)
        elif name == 'bias' or name.startswith('b3_'):
            v = 0.1 * rng.normal(size=s.shape)
        else:
            v = rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_value_and_grad(cfg, batch, noise, seed=1):
    jm = JaxModule(**cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch['feats'], batch['coords'],
        mask=batch['masks'], return_type=1))['params']
    params = _random_params(shapes, seed)

    def loss_fn(params, batch):
        noised = batch['coords'] + batch['noise']
        out = jm.apply({'params': params}, batch['feats'], noised,
                       mask=batch['masks'], return_type=1)
        sq = (((noised + out) - batch['coords']) ** 2).sum(-1)
        m = batch['masks']
        return jnp.where(m, sq, 0.).sum() / jnp.maximum(m.sum(), 1), out
    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, dict(batch, noise=noise))
    return params, (np.asarray(out), float(loss), grads)


def _port_value_and_grad(cfg, params, batch, noise):
    tm = SE3TransformerModule(**cfg, device='cpu')
    tm.load_state_dict(convert_flax_params(params, tm))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tnoise = torch.from_numpy(noise)
    out = tm(tb['feats'], tb['coords'] + tnoise, mask=tb['masks'],
             return_type=1)
    loss = denoise_loss(tm, tb, tnoise)
    loss.backward()
    grads = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None
             else p.grad.numpy() for k, p in tm.named_parameters()}
    return tm, (out.detach().numpy(), loss.item(), grads)


def _assert_twins(ref, got, rtol):
    (ref_out, ref_loss, ref_grads), (out, loss, grads) = ref, got
    assert out.shape == ref_out.shape == (1, N, 3)
    assert np.isfinite(out).all()
    assert np.abs(out - ref_out).max() <= rtol * np.abs(ref_out).max()
    assert abs(loss - ref_loss) <= rtol * abs(ref_loss)
    assert set(grads) == set(ref_grads)
    for key in ref_grads:
        assert np.isfinite(grads[key]).all(), key
        scale = np.abs(ref_grads[key]).max()
        assert np.abs(grads[key] - ref_grads[key]).max() <= rtol * scale, key


@pytest.mark.parametrize('bf16,rtol', [(False, MODEL_RTOL_F32),
                                       (True, MODEL_RTOL_BF16)])
def test_fused_twin_matches_jax(bf16, rtol):
    """Output, loss and every parameter's gradient (through the recompute
    backward inside the reversible blocks' checkpoints) against the JAX
    fuse_pairwise model and jax.grad."""
    cfg = dict(TWIN, radial_bf16=bf16, fuse_pairwise=True)
    batch, noise = _batch()
    params, ref = _jax_value_and_grad(cfg, batch, noise)
    tm, got = _port_value_and_grad(cfg, params, batch, noise)
    ref = (ref[0], ref[1], {k: v.numpy() for k, v in
                            convert_flax_params(ref[2], tm).items()})
    _assert_twins(ref, got, rtol)


def test_fused_model_matches_the_unfused_port():
    """The same weights through the streaming path and through the
    unfused convs and einsum attention, float32 trunk."""
    batch, noise = _batch(seed=2)
    cfg = dict(TWIN, radial_bf16=False)
    params, _ = _jax_value_and_grad(cfg, batch, noise, seed=3)
    _, unfused = _port_value_and_grad(cfg, params, batch, noise)
    _, fused = _port_value_and_grad(dict(cfg, fuse_pairwise=True), params,
                                    batch, noise)
    _assert_twins(unfused, fused, MODEL_RTOL_F32)


def test_rule_tuple_fuses_block0_only(monkeypatch):
    """fuse_pairwise=(('attn_block0', 'flash'),): block 0 streams, block 1
    stays unfused (no rule matches: 'xla'); the forward matches the JAX
    model under the same rule, and only block 0 calls the flash op."""
    rules = (('attn_block0', 'flash'),)
    cfg = dict(TWIN, depth=2, radial_bf16=False, fuse_pairwise=rules)
    batch, _ = _batch(seed=4)
    jm = JaxModule(**cfg)
    params = _random_params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch['feats'], batch['coords'],
        mask=batch['masks'], return_type=1))['params'], seed=5)
    ref = np.asarray(jax.jit(lambda p: jm.apply(
        {'params': p}, batch['feats'], batch['coords'], mask=batch['masks'],
        return_type=1))(params))
    tm = SE3TransformerModule(**cfg, device='cpu')
    tm.load_state_dict(convert_flax_params(params, tm))
    assert tm.fused_attention == (True, False)
    assert tm.trunk.attn_block0.attn.fuse_pairwise
    assert not tm.trunk.attn_block1.attn.fuse_pairwise
    calls = []
    plain = kf.flash_attention_plain
    monkeypatch.setattr(kf, 'flash_attention_plain',
                        lambda *a: calls.append(1) or plain(*a))
    with torch.no_grad():
        out = tm(*(torch.from_numpy(batch[k]) for k in
                   ('feats', 'coords', 'masks')), return_type=1)
    assert len(calls) == TWIN['num_degrees']
    _close(out, ref, MODEL_RTOL_F32)


def test_flash_calls_per_training_step(monkeypatch):
    """Under save_conv_outputs the checkpoint replay recomputes the flash
    op (the policy saves only the pairwise convs), and the op's backward
    replays the plain stream: per step, 2 forward calls per degree and
    block; no CPU call counts a launch."""
    calls = []
    plain = kf.flash_attention_plain
    monkeypatch.setattr(kf, 'flash_attention_plain',
                        lambda *a: calls.append(1) or plain(*a))
    depth = 2
    model = SE3TransformerModule(**dict(TWIN, depth=depth,
                                        fuse_pairwise=True),
                                 device='cpu',
                                 generator=torch.Generator().manual_seed(6))
    batch, noise = _batch(seed=7)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    before = kf.flash_attention_fwd.launches
    denoise_loss(model, tb, torch.from_numpy(noise)).backward()
    assert len(calls) == 2 * depth * TWIN['num_degrees']
    assert kf.flash_attention_fwd.launches == before


@pytest.mark.parametrize('field,value', [('rotary_position', True),
                                         ('linear_proj_keys', True),
                                         ('conv_bf16', True)])
def test_fuse_pairwise_refuses_what_jax_refuses(field, value):
    with pytest.raises(ValueError):
        SE3TransformerModule(**dict(TWIN, fuse_pairwise=True,
                                    **{field: value}), device='cpu')
    with pytest.raises(ValueError):
        SE3TransformerModule(**dict(TWIN, fuse_pairwise=(('.', 'maybe'),)),
                             device='cpu')
