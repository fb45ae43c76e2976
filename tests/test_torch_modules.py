"""The port's ConvSE3 and AttentionBlockSE3 against the JAX package's on
converted parameters (convert_flax_params), on the basis-fused branch and
on the grouped branch (fuse_basis=False, with and without edge_chunks), and
the ConvSE3's own equivariance. Parameters and inputs are made from a seed
with numpy."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu.basis import get_basis as jax_get_basis
from se3_transformer_tpu.ops.attention import AttentionBlockSE3 as JAttnBlock
from se3_transformer_tpu.ops.conv import ConvSE3 as JConv
from se3_transformer_tpu.ops.fiber import Fiber as JFiber
from se3_transformer_torch import (
    SE3TransformerModule, convert_flax_params, flagship, flagship_fast,
)
from se3_transformer_torch.basis import get_basis
from se3_transformer_torch.kernels import attention as ka
from se3_transformer_torch.kernels import flash as kf
from se3_transformer_torch.kernels import pairwise as kp
from se3_transformer_torch.kernels import routing
from se3_transformer_torch.ops import AttentionBlockSE3, ConvSE3, Fiber
from se3_transformer_torch.ops.conv import _basis_is_flat, unflatten_basis
from se3_transformer_torch.so3 import rot, wigner_d_from_rotation

# one intra-op thread: these modules are tiny, and pytest-xdist's workers
# would otherwise oversubscribe the CPU with spinning thread pools
torch.set_num_threads(1)

# float32 throughout (radial_bf16=False): the two sides differ only in
# summation order — relative to the output's largest magnitude
RTOL = 1e-5


def random_params(shapes, seed):
    """A flax param tree of the given shapes with seeded values: unit-ish
    scales, small biases, fan-in-scaled weights."""
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


def graph_inputs(fiber_in, b=1, n=9, k=4, seed=0):
    rng = np.random.RandomState(seed)
    feats = {str(d): rng.normal(size=(b, n, c, 2 * d + 1)).astype(np.float32)
             for d, c in fiber_in}
    idx = rng.randint(0, n, size=(b, n, k)).astype(np.int32)
    mask = rng.rand(b, n, k) > 0.25
    rel_pos = rng.normal(size=(b, n, k, 3)).astype(np.float32)
    return feats, idx, mask, rel_pos


def run_both(jax_mod, torch_cls, torch_kwargs, fiber_in, max_degree, seed,
             layout='pfq_flat', n=9):
    feats, idx, mask, rel_pos = graph_inputs(fiber_in, n=n, seed=seed)
    rel_dist = np.linalg.norm(rel_pos, axis=-1).astype(np.float32)
    j_args = ({k: jnp.asarray(v) for k, v in feats.items()},
              (jnp.asarray(idx), jnp.asarray(mask), None),
              jnp.asarray(rel_dist),
              jax_get_basis(jnp.asarray(rel_pos), max_degree))
    shapes = jax.eval_shape(lambda: jax_mod.init(jax.random.PRNGKey(0),
                                                 *j_args))['params']
    params = random_params(shapes, seed)
    ref = jax.jit(lambda p: jax_mod.apply({'params': p}, *j_args))(params)

    mod = torch_cls(**torch_kwargs)
    mod.load_state_dict(convert_flax_params(params, mod))
    with torch.no_grad():
        out = mod({k: torch.from_numpy(v) for k, v in feats.items()},
                  (torch.from_numpy(idx).long(), torch.from_numpy(mask), None),
                  torch.from_numpy(rel_dist),
                  get_basis(torch.from_numpy(rel_pos), max_degree,
                            layout=layout))
    return {k: np.asarray(v) for k, v in ref.items()}, \
        {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize('deg_in,deg_out,pool', [(1, 4, True), (4, 4, True),
                                                 (4, 1, True), (4, 4, False)])
def test_conv_matches_jax(deg_in, deg_out, pool):
    fin, fout = Fiber.create(deg_in, 3), Fiber.create(deg_out, 5)
    kw = dict(pool=pool, self_interaction=pool)
    jmod = JConv(JFiber.create(deg_in, 3), JFiber.create(deg_out, 5),
                 shared_radial_hidden=True, fuse_basis=True, **kw)
    ref, out = run_both(jmod, ConvSE3, dict(fiber_in=fin, fiber_out=fout,
                                            fuse_basis=True,
                                            shared_radial_hidden=True, **kw),
                        fin, max(deg_in, deg_out) - 1, seed=deg_in + deg_out)
    assert set(out) == set(ref)
    scale = max(np.abs(v).max() for v in ref.values())
    for d in ref:
        assert out[d].shape == ref[d].shape
        assert np.abs(out[d] - ref[d]).max() <= RTOL * scale, d


def test_attention_block_matches_jax():
    fiber = Fiber.create(4, 4)
    jmod = JAttnBlock(JFiber.create(4, 4), dim_head=4, heads=2,
                      attend_self=True, shared_radial_hidden=True,
                      fuse_basis=True)
    ref, out = run_both(jmod, AttentionBlockSE3,
                        dict(fiber=fiber, dim_head=4, heads=2,
                             attend_self=True, shared_radial_hidden=True,
                             fuse_basis=True), fiber, 3, seed=5)
    scale = max(np.abs(v).max() for v in ref.values())
    for d in ref:
        assert out[d].shape == ref[d].shape
        assert np.abs(out[d] - ref[d]).max() <= RTOL * scale, d


def test_conv_is_equivariant():
    """Rotating the offsets by R and every degree-d input by D_d(R)
    rotates every degree-d output by D_d(R) (float32, 1e-4 — the JAX
    package's equivariance bound)."""
    torch.manual_seed(0)
    fiber = Fiber.create(4, 3)
    conv = ConvSE3(fiber, fiber, fuse_basis=True, shared_radial_hidden=True)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape) * 0.3)
    feats, idx, mask, rel_pos = graph_inputs(fiber, seed=3)
    R = rot(0.4, 1.1, -2.3)
    D = {d: wigner_d_from_rotation(d, R) for d in range(4)}

    def run(feats, rel_pos):
        rel = torch.from_numpy(rel_pos.astype(np.float32))
        with torch.no_grad():
            out = conv({k: torch.from_numpy(v.astype(np.float32))
                        for k, v in feats.items()},
                       (torch.from_numpy(idx).long(),
                        torch.from_numpy(mask), None),
                       rel.norm(dim=-1), get_basis(rel, 3, layout='pfq_flat'))
        return {k: v.double().numpy() for k, v in out.items()}

    out = run(feats, rel_pos)
    out_r = run({k: v.astype(np.float64) @ D[int(k)].T
                 for k, v in feats.items()},
                rel_pos.astype(np.float64) @ R.T)
    for k in out:
        assert np.abs(out_r[k] - out[k] @ D[int(k)].T).max() < 1e-4, k


# edge_chunks: none, a count that divides n = 9 (3), one that does not
# (2: the node axis is zero-padded to 10), and more chunks than nodes
@pytest.mark.parametrize('edge_chunks', [None, 3, 2, 12])
@pytest.mark.parametrize('deg_in,deg_out,pool', [(1, 4, True), (4, 4, True),
                                                 (4, 2, False)])
def test_grouped_conv_matches_jax(deg_in, deg_out, pool, edge_chunks):
    """The grouped branch (V2 by einsum from the structured basis, one
    contraction per output degree) against the JAX ConvSE3 with
    shared_radial_hidden=True, fuse_basis=False, at 1e-4."""
    fin, fout = Fiber.create(deg_in, 3), Fiber.create(deg_out, 5)
    kw = dict(pool=pool, self_interaction=pool, edge_chunks=edge_chunks)
    jmod = JConv(JFiber.create(deg_in, 3), JFiber.create(deg_out, 5),
                 shared_radial_hidden=True, fuse_basis=False, **kw)
    ref, out = run_both(jmod, ConvSE3, dict(fiber_in=fin, fiber_out=fout,
                                            fuse_basis=False,
                                            shared_radial_hidden=True, **kw),
                        fin, max(deg_in, deg_out) - 1, seed=deg_in + deg_out,
                        layout='pqf')
    assert set(out) == set(ref)
    scale = max(np.abs(v).max() for v in ref.values())
    for d in ref:
        assert out[d].shape == ref[d].shape
        assert np.abs(out[d] - ref[d]).max() <= 1e-4 * scale, d


@pytest.mark.parametrize('edge_chunks', [None, 2])
def test_grouped_attention_block_matches_jax(edge_chunks):
    """The attention block with grouped to_k/to_v convs, given the flat
    basis layout (which the grouped branch unflattens)."""
    fiber = Fiber.create(4, 4)
    jmod = JAttnBlock(JFiber.create(4, 4), dim_head=4, heads=2,
                      attend_self=True, shared_radial_hidden=True,
                      fuse_basis=False, edge_chunks=edge_chunks)
    ref, out = run_both(jmod, AttentionBlockSE3,
                        dict(fiber=fiber, dim_head=4, heads=2,
                             attend_self=True, shared_radial_hidden=True,
                             edge_chunks=edge_chunks), fiber, 3, seed=6)
    scale = max(np.abs(v).max() for v in ref.values())
    for d in ref:
        assert out[d].shape == ref[d].shape
        assert np.abs(out[d] - ref[d]).max() <= 1e-4 * scale, d


def test_unflatten_basis_is_the_structured_layout():
    rel = torch.from_numpy(np.random.RandomState(4).normal(size=(2, 5, 3))
                           .astype(np.float32))
    flat, structured = (get_basis(rel, 3, layout=lay)
                        for lay in ('pfq_flat', 'pqf'))
    x = torch.zeros(2, 5, 3, 7)
    for key, b in structured.items():
        d_in, d_out = map(int, key.split(','))
        P, Q, F = 2 * d_out + 1, 2 * d_in + 1, 2 * min(d_in, d_out) + 1
        assert _basis_is_flat(flat[key], x[..., :Q])
        assert not _basis_is_flat(b, x[..., :Q])
        assert torch.equal(unflatten_basis(flat[key], P, Q, F), b)


def test_fused_branch_refuses_the_structured_basis():
    """The fused branch used to refuse the structured basis (kernel #2 was
    unported); as the JAX ConvSE3 it now takes it, and gives the flat
    basis's output."""
    fiber = Fiber.create(2, 3)
    feats, idx, mask, rel_pos = graph_inputs(fiber, seed=1)
    conv = ConvSE3(fiber, fiber, fuse_basis=True, shared_radial_hidden=True)
    with torch.no_grad():
        for i, p in enumerate(conv.parameters()):
            p.copy_(torch.from_numpy(np.random.RandomState(i).normal(
                size=tuple(p.shape)).astype(np.float32)) * 0.3)
    rel = torch.from_numpy(rel_pos)
    outs = [conv({k: torch.from_numpy(v) for k, v in feats.items()},
                 (torch.from_numpy(idx).long(), torch.from_numpy(mask), None),
                 rel.norm(dim=-1), get_basis(rel, 1, layout=layout))
            for layout in ('pqf', 'pfq_flat')]
    for d in outs[1]:
        scale = outs[1][d].abs().max()
        assert (outs[0][d] - outs[1][d]).abs().max() <= 1e-6 * scale, d


@pytest.mark.parametrize('fuse_basis', [False, True])
def test_edge_chunks_leave_the_conv_and_its_gradients_unchanged(fuse_basis):
    """Streaming the node axis (padded: n = 9 in 4 chunks) gives the
    unchunked output and gradients, up to float32 summation order."""
    fiber = Fiber.create(3, 3)
    feats, idx, mask, rel_pos = graph_inputs(fiber, seed=7)
    rel = torch.from_numpy(rel_pos)
    basis = get_basis(rel, 2, layout='pfq_flat' if fuse_basis else 'pqf')
    results = []
    for chunks in (None, 4):
        conv = ConvSE3(fiber, fiber, fuse_basis=fuse_basis,
                       edge_chunks=chunks, shared_radial_hidden=True)
        with torch.no_grad():
            for i, p in enumerate(conv.parameters()):
                p.copy_(torch.from_numpy(np.random.RandomState(i).normal(
                    size=tuple(p.shape)).astype(np.float32)) * 0.3)
        x = {k: torch.from_numpy(v).requires_grad_() for k, v in feats.items()}
        out = conv(x, (torch.from_numpy(idx).long(),
                       torch.from_numpy(mask), None),
                   rel.norm(dim=-1), basis)
        sum((v * v).sum() for v in out.values()).backward()
        results.append(({k: v.detach() for k, v in out.items()},
                        {n: p.grad for n, p in conv.named_parameters()},
                        {k: v.grad for k, v in x.items()}))
    for ref, got in zip(results[0], results[1]):
        for key in ref:
            scale = ref[key].abs().max()
            assert (got[key] - ref[key]).abs().max() <= 1e-5 * scale, key


# ---------------------------------------------------------------------- #
# routing past a kernel's limits (decided in the layer, before a launch)
# ---------------------------------------------------------------------- #
F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize('device_type', ['cuda', 'cpu'])
def test_conv_route_decision_is_a_function_of_widths(monkeypatch,
                                                     device_type):
    """On 'cuda' the flagship widths (mid 128, O 64, degrees <= 3, either
    dtype) take the kernels; the DenoiseConfig widths (O 8 or 16) and O =
    32 take #3 and kernels A and B (their narrow arms) and route past #1
    and #2, and past #3 with bf16 V2 (conv_bf16); O = 128 and 192 take
    every forward kernel. Any other device never routes (its tensors take
    the plain versions). Kernels A and B take exactly the widths #3 takes,
    so the backward of a call that launched never needs a decision of its
    own."""
    monkeypatch.setattr(routing, '_WARNED', set())
    on_card = device_type == 'cuda'

    def routes(kernel, *widths):
        return routing.route(ROUTED[kernel], device_type,
                             kp.pairwise_limit(kernel, *widths), widths)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        for kernel in ('bxf', 'bx', 'fwd'):
            for P in (1, 3, 5, 7):
                for dtype in (F32, BF16):
                    assert not routes(kernel, 128, 64, P, 7, dtype)
                    assert kp.pairwise_limit('bwd', 128, 64, P, 7,
                                             dtype) is None
            for O in (8, 16, 32):
                narrow = kernel == 'fwd'
                assert routes(kernel, 128, O, 3, 3) is (on_card
                                                        and not narrow)
                assert kp.pairwise_limit('bwd', 128, O, 3, 3) is None
                if not narrow:
                    assert kp.pairwise_limit(kernel, 128, O, 3, 3) == \
                        f'O = {O} exceeds the built O: a multiple of 64'
                for k in ('fwd', 'bwd'):
                    assert 'conv_bf16' in kp.pairwise_limit(
                        k, 128, O, 3, 3, operand_dtype=BF16)
                assert routes('fwd', 128, O, 3, 3, F32, BF16) is on_card
            for O in (128, 192):
                assert not routes(kernel, 128, O, 3, 3)
                assert kp.pairwise_limit('bwd', 128, O, 3, 3) is None


def _kernel_widths(model):
    """Every kernel call's widths in a model: (kernel, mid, O, P, Q) of
    each ConvSE3 pair, the fused attention's (J, D) per degree."""
    calls = []
    for conv in model.modules():
        if isinstance(conv, ConvSE3) and not (conv.fuse_pairwise
                                              or conv.global_radial):
            for d_out, c_out in conv.fiber_out:
                for d_in, _ in conv.fiber_in:
                    calls.append(('bxf' if conv.fuse_basis else 'fwd', 128,
                                  c_out, 2 * d_out + 1, 2 * d_in + 1))
    return calls


@pytest.mark.parametrize('recipe', [flagship_fast, flagship])
def test_flagship_widths_never_route(recipe):
    """Both recipes at full width: no conv, attention or flash call of
    theirs is past a kernel's limits, so a card runs every one of them on
    its kernel."""
    model = recipe(depth=1, output_degrees=2, reduce_dim_out=True,
                   device='cpu')
    dtype = BF16 if model.conv_in.radial_dtype else F32
    calls = _kernel_widths(model)
    assert len(calls) == 4 + 2 * 16 + 8      # conv_in, one block, conv_out
    for kernel, mid, O, P, Q in calls:
        assert kp.pairwise_limit(kernel, mid, O, P, Q, dtype) is None
        assert kp.pairwise_limit('bwd', mid, O, P, Q, dtype) is None
    for d in range(4):
        assert ka.attention_limit(33, 8 * (2 * d + 1)) is None
        assert kf.flash_limit(tuple((e, 64) for e in range(4)), d, 8, 8, 8,
                              32, 1, 128, dtype) is None
    assert kf.global_limit(((0, 8), (1, 8)), 1, 2, 2, 8, 2) is None


def _on_a_card(monkeypatch):
    """Take every route decision as for a CUDA tensor, so that the CPU
    runs the routed branch; fresh warnings and counts."""
    real = routing.route
    monkeypatch.setattr(routing, 'route', lambda wrapper, device_type, limit,
                        shape: real(wrapper, 'cuda', limit, shape))
    monkeypatch.setattr(routing, '_WARNED', set())
    for wrapper in ROUTED.values():
        monkeypatch.setattr(wrapper, 'routed', 0)


ROUTED = dict(bxf=kp.fused_pairwise_conv_bxf, bx=kp.fused_pairwise_conv_bx,
              fwd=kp.fused_pairwise_conv,
              attn=ka.fused_attention_fwd,
              flash=kf.flash_attention_fwd,
              glob=kf.flash_global_attention_fwd)


def _value_and_grads(model, inputs):
    out = model(*inputs)
    (out ** 2).sum().backward()
    return out.detach(), {k: p.grad.clone() for k, p in
                          model.named_parameters() if p.grad is not None}


# the DenoiseConfig widths (dim 8, heads 2, dim_head 8, two degrees), and
# beside them the attention knobs at widths past their kernels' limits
DENOISE = dict(dim=8, heads=2, dim_head=8, depth=1, num_degrees=2,
               shared_radial_hidden=True, num_neighbors=4)


@pytest.mark.parametrize('fields,routed', [
    # conv_in 2 pairs, the kv convs 2 x 4, conv_out 2; grouped: one call
    # per output degree and node chunk (#3's narrow arms take float32 V2 at
    # these widths; bf16 V2 routes past them)
    (dict(fuse_basis=True), dict(bxf=12)),
    (dict(fuse_basis=False, edge_chunks=2, conv_bf16=True),
     dict(fwd=(2 + 2 * 2 + 1) * 2)),
    # D = 64 * 5 = 320 features at degree 2 exceed #5's 256; degrees 0 and
    # 1 fit it; the kv convs' O = 128 takes #1 and kernels A and B
    (dict(fuse_basis=True, num_degrees=3, dim_head=64,
          pallas_attention=True), dict(bxf=3 + 3, attn=1)),
    (dict(fuse_basis=True, fuse_pairwise=True), dict(bxf=4, flash=2)),
    (dict(num_tokens=5, attention_mode='global', use_null_kv=True,
          dim_head=16), dict(glob=2))])
def test_routed_model_runs_the_plain_bodies(monkeypatch, fields, routed):
    """A model past its kernels' limits, its route decided as on a card:
    each routed call is counted in its wrapper's .routed and warned once
    per (kernel, shape) with the limit, and the plain bodies under
    autograd give the unrouted CPU model's output and gradients."""
    cfg = dict(DENOISE, **fields)
    rng = np.random.RandomState(0)
    n = 10
    feats = rng.randint(0, 5, (1, n)) if 'num_tokens' in cfg else \
        rng.normal(size=(1, n, 8)).astype(np.float32)
    inputs = [torch.from_numpy(feats),
              torch.from_numpy(rng.normal(size=(1, n, 3)).astype(np.float32)),
              torch.from_numpy(np.arange(n)[None] < n - 2)]
    models = [SE3TransformerModule(**cfg, device='cpu',
                                   generator=torch.Generator().manual_seed(1))
              for _ in range(2)]
    ref_out, ref_grads = _value_and_grads(models[0], inputs)
    _on_a_card(monkeypatch)
    with pytest.warns(UserWarning) as caught:
        out, grads = _value_and_grads(models[1], inputs)
    assert {k: w.routed for k, w in ROUTED.items() if w.routed} == routed
    texts = [str(w.message) for w in caught
             if 'using the plain path' in str(w.message)]
    assert texts and all(' kernel: ' in t and ' exceeds ' in t for t in texts)
    assert len(texts) == len(set(texts))
    assert torch.equal(out, ref_out)
    assert set(grads) == set(ref_grads)
    for key, ref in ref_grads.items():
        assert (grads[key] - ref).abs().max() <= 1e-5 * ref.abs().max(), key


@pytest.mark.parametrize('fuse_basis,layout,kernel', [
    (True, 'pfq_flat', 'bxf'), (True, 'pqf', 'bx'), (False, 'pqf', 'fwd')])
def test_routed_conv_runs_the_plain_body(monkeypatch, fuse_basis, layout,
                                         kernel):
    """One ConvSE3 (8 channels, degrees 0..2) routed past its kernel: the
    plain body's output and gradients, one .routed per pair (or per output
    degree on the grouped branch, with bf16 V2: #3's narrow arm takes
    float32 V2 at O = 8)."""
    fiber = Fiber.create(3, 8)
    feats, idx, mask, rel_pos = graph_inputs(fiber, seed=3)
    rel = torch.from_numpy(rel_pos)
    basis = get_basis(rel, 2, layout=layout)
    results = []
    for routed in (False, True):
        torch.manual_seed(0)
        conv = ConvSE3(fiber, fiber, fuse_basis=fuse_basis,
                       shared_radial_hidden=True, conv_bf16=not fuse_basis)
        with torch.no_grad():
            for p in conv.parameters():
                p.normal_(0, 0.3)
        if routed:
            _on_a_card(monkeypatch)
        xs = {k: torch.from_numpy(v).requires_grad_() for k, v in
              feats.items()}
        out = conv(xs, (torch.from_numpy(idx).long(),
                        torch.from_numpy(mask), None), rel.norm(dim=-1),
                   basis)
        sum((o ** 2).sum() for o in out.values()).backward()
        results.append(([out[k].detach() for k in sorted(out)],
                        [xs[k].grad for k in sorted(xs)]
                        + [p.grad for p in conv.parameters()]))
    assert ROUTED[kernel].routed == (9 if fuse_basis else 3)
    for a, b in zip(results[0][0], results[1][0]):
        assert torch.equal(a, b)
    for a, b in zip(results[0][1], results[1][1]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
