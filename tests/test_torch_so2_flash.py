"""The so2 arm of the streaming attentions (kernels #7 and 7g) in the port
against the JAX package on the CPU: the kNN plain stream (untied, tied,
and with mixed arms) against the JAX XLA stream and the interpret-mode
Pallas kernel, its recompute backward (the frames' gradient included)
against jax.grad; the global plain stream likewise, its replay backward
with the coordinates' gradient through the in-tile frames; the
fuse_pairwise and global models' outputs and gradients on converted
weights; the kernels' so2 constants; mixed arms routed past #7 on a
card. Inputs come from a numpy seed; the layers and the kNN model are in
tests/test_torch_so2.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_flash as tflash
import test_torch_global as tglobal
import test_torch_modules as tmodules
from se3_transformer_tpu.so2 import frames as jfr
from se3_transformer_torch import SE3TransformerModule, convert_flax_params
from se3_transformer_torch.kernels import flash as kf
from se3_transformer_torch.so2 import canonical as pcan
from se3_transformer_torch.so2 import frames as pfr
from se3_transformer_torch.so3 import rot

# one intra-op thread, as the other port tests
torch.set_num_threads(1)

# the plain streams against JAX's: the same float32 products in other
# orders, relative to the largest magnitude of each output or gradient
RTOL = 1e-5
# the models and their gradients, float32 trunk
MODEL_RTOL = 1e-5
# the JAX package's own global bar (tests/test_assembly.py)
EQ_TOL = 1e-5
# the frames' degree the kNN model passes (num_degrees - 1): wider than
# the pairs' degrees 0..2, so the streams slice them
FRAME_DEGREE = 3


def _rel_err(out, ref):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def _knn_case(seed=0, arm_k='so2', tie=False):
    """tests/test_torch_flash.py's operands (n 13, K 6, three input
    degrees into d_out 1, bf16-valued h, a masked row, one prefix slot)
    with the offsets' first slot on a pole; JAX and port keywords for the
    values' so2 arm and the keys' `arm_k`."""
    ops = tflash._inputs(seed=seed)
    ops['rel'][:, :, 0] = [0., 0., 1.3]
    rel = ops['rel']
    jax_kw = dict(arm_v='so2', arm_k=arm_k,
                  frames=jfr.edge_frames(jnp.asarray(rel), FRAME_DEGREE))
    port_kw = dict(arm_v='so2', arm_k=arm_k,
                   frames=pfr.edge_frames(torch.from_numpy(rel),
                                          FRAME_DEGREE))
    if tie:
        for kw in (jax_kw, port_kw):
            kw.update(h_k=None, wk=None, bk=None)
    return ops, jax_kw, port_kw


@pytest.mark.parametrize('case', ['untied', 'tied', 'mixed'])
def test_so2_plain_matches_jax_stream(case):
    """The so2 arm for keys and values, tied (one block), and mixed (keys
    by the dense arm from the SH stack, values by the so2 arm)."""
    ops, jax_kw, port_kw = _knn_case(
        arm_k='dense' if case == 'mixed' else 'so2', tie=case == 'tied')
    t = tflash._torch_ops(ops)
    if case != 'mixed':
        port_kw['sh'] = None
    ref = tflash._run_jax(ops, **jax_kw)
    assert _rel_err(tflash._run_port(t, **port_kw), ref) <= RTOL


def test_so2_plain_matches_jax_interpret_kernel():
    """The JAX Pallas kernel's so2 arm in interpret mode (kv blocks through
    the online softmax, the frames as a kernel input)."""
    ops, jax_kw, port_kw = _knn_case(seed=1)
    ref = tflash._run_jax(ops, interpret=True, pallas=True, **jax_kw)
    t = tflash._torch_ops(ops)
    assert _rel_err(tflash._run_port(t, sh=None, **port_kw), ref) <= RTOL


def test_so2_recompute_backward_matches_jax_grad():
    """The op's backward (the plain stream replayed chunk by chunk) against
    jax.grad, float32 h: q, a node feature, h_v, wv, bk, the prefix, and
    the offsets through differentiable frames (the pole slot included)."""
    ops, _, _ = _knn_case(seed=2)
    names = ('q', 'x0', 'h_v', 'wv', 'bk', 'prefix_k', 'rel')

    def loss_jax(q, x0, h_v, wv, bk, pk, rel):
        fr = jfr.edge_frames(rel, FRAME_DEGREE, differentiable=True)
        out = tflash._run_jax(
            dict(ops, q=q, xs=(x0,) + ops['xs'][1:], h_v=h_v, wv=wv, bk=bk,
                 prefix_k=pk), h_dtype=jnp.float32, arm_v='so2', frames=fr)
        return (out ** 2).sum()
    vals = [ops['q'], ops['xs'][0], ops['h_v'], ops['wv'], ops['bk'],
            ops['prefix_k'], ops['rel']]
    ref = jax.jit(jax.grad(loss_jax, argnums=tuple(range(7))))(
        *map(jnp.asarray, vals))
    t = tflash._torch_ops(ops, h_dtype=torch.float32)
    leaves = [torch.from_numpy(np.asarray(v)).requires_grad_()
              for v in vals]
    t.update(q=leaves[0], h_v=leaves[2], wv=leaves[3], bk=leaves[4],
             prefix_k=leaves[5])
    t['xs'] = (leaves[1],) + t['xs'][1:]
    fr = pfr.edge_frames(leaves[6], FRAME_DEGREE, differentiable=True)
    (tflash._run_port(t, arm_v='so2', sh=None, frames=fr) ** 2).sum() \
        .backward()
    for name, leaf, want in zip(names, leaves, ref):
        assert leaf.grad is not None, name
        assert _rel_err(leaf.grad, want) <= RTOL, name


def test_so2_operands_for_the_kernel():
    """flash_operands packs the frames [..., 4 L1] in FRAME_KEYS order and
    drops the SH stack when no arm reads it; the wrapper's checks take the
    packed frames (S = 4 L1); the so2 constants hold J_1..J_3 at their
    offsets and each pair's canonical blocks a, b at its offset."""
    ops, _, port_kw = _knn_case(seed=3)
    t = tflash._torch_ops(ops)
    cfg, kops = kf.flash_operands(
        t['q'], t['xs'], t['idx'], t['nmask'], t['h_v'], t['wv'], t['bv'],
        pairs=tflash.PAIRS, d_out=tflash.D_OUT, heads=tflash.HEADS,
        kv_heads=tflash.KV_H, scale=tflash.SCALE, h_k=t['h_k'], wk=t['wk'],
        bk=t['bk'], sh=t['sh'], **port_kw)
    assert (cfg.arm_v, cfg.arm_k) == ('so2', 'so2') and kops['sh'] is None
    L1 = FRAME_DEGREE + 1
    assert kops['fr'].shape == (1, 13, tflash.K, 4 * L1)
    back = kf.unpack_frames(kops['fr'])
    for key in pfr.FRAME_KEYS:
        assert torch.equal(back[key], port_kw['frames'][key])
    assert kf.flash_limit(tflash.PAIRS, 1, 8, 8, 8, 32, 1,
                          h_dtype=torch.bfloat16, arms=('so2', 'so2')) is None
    assert 'mixed contraction arms' in kf.flash_limit(
        tflash.PAIRS, 1, 8, 8, 8, 32, 1, arms=('dense', 'so2'))
    buf, offs = kf._so2_buffer((0, 1, 2, 3), 2, torch.device('cpu'))
    for l in (1, 2, 3):
        N = 2 * l + 1
        J = buf[kf._J_OFFSETS[l - 1]:kf._J_OFFSETS[l - 1] + N * N]
        assert np.allclose(J.numpy().reshape(N, N), pfr.j_matrix(l),
                           atol=1e-7)
    for d_in, off in zip((0, 1, 2, 3), offs):
        a, b = pcan.canonical_blocks(d_in, 2)
        got = buf[off:off + a.size + b.size].numpy()
        assert np.allclose(got, np.concatenate([a.ravel(), b.ravel()]),
                           atol=1e-7)


# ---------------------------------------------------------------------- #
# global mode
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize('interpret', [False, True])
@pytest.mark.parametrize('d_out', [0, 1])
def test_so2_global_plain_matches_jax(d_out, interpret):
    """n = 37 in two row chunks, the last 5 nodes padded at the origin
    (their pairs, and the diagonal, at zero length on the identity frame)
    and masked, the [null, self] prefix: against the JAX XLA stream and
    the interpret-mode Pallas kernel with arm='so2'."""
    ops = tglobal._inputs(d_out, seed=7)
    ref = tglobal._run_jax(ops, d_out, arm='so2', pallas=False,
                           interpret=interpret)
    out = tglobal._run_port(tglobal._torch(ops), d_out, arm='so2')
    assert _rel_err(out, ref) <= RTOL


def test_so2_global_replay_backward_matches_jax_grad():
    """The replay backward against jax.grad for q, a node feature, the
    coordinates (through the frames built per chunk), wv and bk."""
    d_out = 1
    ops = tglobal._inputs(d_out, seed=8)
    names = ('q', 'x1', 'coords', 'wv', 'bk')

    def loss_jax(q, x1, coords, wv, bk):
        out = tglobal._run_jax(dict(ops, q=q, xs=(ops['xs'][0], x1),
                                    coords=coords, wv=wv, bk=bk),
                               d_out, arm='so2', pallas=False)
        return (out ** 2).sum()
    vals = [ops['q'], ops['xs'][1], ops['coords'], ops['wv'], ops['bk']]
    ref = jax.jit(jax.grad(loss_jax, argnums=tuple(range(5))))(
        *map(jnp.asarray, vals))
    t = tglobal._torch(ops)
    leaves = [torch.from_numpy(np.asarray(v)).requires_grad_()
              for v in vals]
    t.update(q=leaves[0], coords=leaves[2], wv=leaves[3], bk=leaves[4])
    t['xs'] = (t['xs'][0], leaves[1])
    (tglobal._run_port(t, d_out, arm='so2') ** 2).sum().backward()
    for name, leaf, want in zip(names, leaves, ref):
        assert leaf.grad is not None, name
        assert _rel_err(leaf.grad, want) <= RTOL, name


# ---------------------------------------------------------------------- #
# the models
# ---------------------------------------------------------------------- #
def _twin_grads(tm, params, got_out, ref_out, ref_grads):
    assert _rel_err(got_out, ref_out) <= MODEL_RTOL
    want = convert_flax_params(ref_grads, tm)
    for name, p in tm.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert _rel_err(got, want[name]) <= MODEL_RTOL, name


def test_fused_so2_twin_matches_jax():
    """flagship_fast's fields with fuse_pairwise and conv_backend='so2'
    (degrees 0..3, float32 trunk; not reversible, which
    tests/test_torch_flash.py covers): output, loss and every parameter's
    gradient through the recompute backward against jax.grad, on
    converted weights."""
    cfg = dict(tflash.TWIN, radial_bf16=False, fuse_pairwise=True,
               conv_backend='so2', reversible=False, remat_policy=None)
    batch, noise = tflash._batch(seed=4)
    params, ref = tflash._jax_value_and_grad(cfg, batch, noise)
    tm, got = tflash._port_value_and_grad(cfg, params, batch, noise)
    assert tm.fused_attention == (True,)
    ref = (ref[0], ref[1], {k: v.numpy() for k, v in
                            convert_flax_params(ref[2], tm).items()})
    tflash._assert_twins(ref, got, MODEL_RTOL)


def test_fused_mixed_arms_equal_the_unfused_model():
    """to_v by the so2 arm, the rest dense (the mixed arms kernel #7 does
    not build): the fused model's plain stream and the unfused convs and
    einsum attention agree on the same weights."""
    cfg = dict(tflash.TWIN, radial_bf16=False,
               conv_backend=(('to_v', 'so2'), ('.*', 'dense')))
    batch, noise = tflash._batch(seed=5)
    gen = torch.Generator().manual_seed(6)
    state = SE3TransformerModule(**cfg, device='cpu',
                                 generator=gen).state_dict()
    outs = []
    for fused in (False, True):
        tm = SE3TransformerModule(**cfg, fuse_pairwise=fused, device='cpu')
        tm.load_state_dict(state)
        with torch.no_grad():
            outs.append(tm(*(torch.from_numpy(batch[k]) for k in
                             ('feats', 'coords', 'masks')), return_type=1))
    assert _rel_err(outs[1], outs[0].numpy()) <= MODEL_RTOL


def test_mixed_arms_route_past_the_kernel_on_a_card(monkeypatch):
    """Decided as on a card: a fused block with mixed arms is past
    flash_limit, counted in .routed with the mixed-arms warning, and gives
    the plain stream's output; a uniform so2 block is not routed."""
    batch, _ = tflash._batch(seed=7)
    inputs = [torch.from_numpy(batch[k]) for k in ('feats', 'coords',
                                                   'masks')]
    outs = {}
    for spec in ('so2', (('to_k', 'dense'), ('.*', 'so2'))):
        tm = SE3TransformerModule(**tflash.TWIN, fuse_pairwise=True,
                                  conv_backend=spec, device='cpu',
                                  generator=torch.Generator().manual_seed(8))
        with torch.no_grad():
            ref = tm(*inputs, return_type=1)
        tmodules._on_a_card(monkeypatch)
        if spec == 'so2':
            with torch.no_grad():
                outs[spec] = tm(*inputs, return_type=1)
            assert kf.flash_attention_fwd.routed == 0
        else:
            with pytest.warns(UserWarning, match='mixed contraction arms'):
                with torch.no_grad():
                    outs[spec] = tm(*inputs, return_type=1)
            # one block, one call per output degree
            assert kf.flash_attention_fwd.routed == 4
        assert torch.equal(outs[spec], ref)


ASSEMBLY_SO2 = dict(conv_backend='so2')


def test_global_so2_twin_matches_jax():
    """The assembly model with conv_backend='so2' (n = 40, 5 padded):
    the vector output and every parameter's gradient through the replay
    backward against jax.grad, on converted weights."""
    batch = tglobal._batch(seed=9, n=40)
    jm, params = tglobal._jax_model(batch, seed=10, **ASSEMBLY_SO2)
    target = np.random.RandomState(11).normal(size=(1, 40, 3)) \
        .astype(np.float32)

    def loss(p):
        out = jm.apply({'params': p}, *batch[:2], mask=batch[2],
                       return_type=1)
        return ((out - target) ** 2).sum(), out
    (_, ref_out), ref_grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    tm = tglobal._port_model(params, **ASSEMBLY_SO2)
    out = tm(*(torch.from_numpy(a) for a in batch), return_type=1)
    ((out - torch.from_numpy(target)) ** 2).sum().backward()
    _twin_grads(tm, params, out, ref_out, ref_grads)


def test_global_so2_equivariance():
    """tests/test_assembly.py's bar on the so2 assembly model: the max
    per-node L2 error of f(R c) against f(c) R, rotation in float64."""
    tokens, coords, mask = tglobal._batch(seed=12, n=29, pad=0)
    tm = SE3TransformerModule(**tglobal.KW, **ASSEMBLY_SO2, device='cpu',
                              generator=torch.Generator().manual_seed(13))
    R = rot(-0.8, 0.4, 1.9)
    c64 = coords.astype(np.float64)

    def f(c):
        with torch.no_grad():
            return tm(torch.from_numpy(tokens),
                      torch.from_numpy(c.astype(np.float32)),
                      torch.from_numpy(mask), return_type=1).double().numpy()
    err = np.sqrt(((f(c64 @ R) - f(c64) @ R) ** 2).sum(-1)).max()
    assert err < EQ_TOL
