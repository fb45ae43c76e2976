"""The port's ConvSE3 and AttentionBlockSE3 against the JAX package's on
converted parameters (convert_flax_params), on the basis-fused branch and
on the grouped branch (fuse_basis=False, with and without edge_chunks), and
the ConvSE3's own equivariance. Parameters and inputs are made from a seed
with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu.basis import get_basis as jax_get_basis
from se3_transformer_tpu.ops.attention import AttentionBlockSE3 as JAttnBlock
from se3_transformer_tpu.ops.conv import ConvSE3 as JConv
from se3_transformer_tpu.ops.fiber import Fiber as JFiber
from se3_transformer_torch import convert_flax_params
from se3_transformer_torch.basis import get_basis
from se3_transformer_torch.ops import AttentionBlockSE3, ConvSE3, Fiber
from se3_transformer_torch.ops.conv import _basis_is_flat, unflatten_basis
from se3_transformer_torch.so3 import rot, wigner_d_from_rotation

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
                  (torch.from_numpy(idx).long(), torch.from_numpy(mask)),
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
                                            fuse_basis=True, **kw),
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
    conv = ConvSE3(fiber, fiber, fuse_basis=True)
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
                       (torch.from_numpy(idx).long(), torch.from_numpy(mask)),
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
                                            fuse_basis=False, **kw),
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
    conv = ConvSE3(fiber, fiber, fuse_basis=True)
    with torch.no_grad():
        for i, p in enumerate(conv.parameters()):
            p.copy_(torch.from_numpy(np.random.RandomState(i).normal(
                size=tuple(p.shape)).astype(np.float32)) * 0.3)
    rel = torch.from_numpy(rel_pos)
    outs = [conv({k: torch.from_numpy(v) for k, v in feats.items()},
                 (torch.from_numpy(idx).long(), torch.from_numpy(mask)),
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
                       edge_chunks=chunks)
        with torch.no_grad():
            for i, p in enumerate(conv.parameters()):
                p.copy_(torch.from_numpy(np.random.RandomState(i).normal(
                    size=tuple(p.shape)).astype(np.float32)) * 0.3)
        x = {k: torch.from_numpy(v).requires_grad_() for k, v in feats.items()}
        out = conv(x, (torch.from_numpy(idx).long(), torch.from_numpy(mask)),
                   rel.norm(dim=-1), basis)
        sum((v * v).sum() for v in out.values()).backward()
        results.append(({k: v.detach() for k, v in out.items()},
                        {n: p.grad for n, p in conv.named_parameters()},
                        {k: v.grad for k, v in x.items()}))
    for ref, got in zip(results[0], results[1]):
        for key in ref:
            scale = ref[key].abs().max()
            assert (got[key] - ref[key]).abs().max() <= 1e-5 * scale, key
