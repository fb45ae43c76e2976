"""The kernel block-config table and its tuner (se3_transformer_torch.
kernels.tuning, kernels.tune) against the JAX package's (kernels/tuning.py,
scripts/tune_kernels.py), on the CPU.

  * the table's semantics on the kinds both packages resolve on the CPU
    ('so2', 'flash_stream', 'flash_global'): the same sequence of promote,
    lookup, force, an inadmissible entry, a corrupt, a truncated and a
    version-bumped file gives the same picks, lookups, warnings, consult
    logs and admissible candidates, each package in its own temporary
    cache directory;
  * with an empty table every pick is the pre-table heuristic's: kernel
    #3's i split and kernel A's edge splits at every shape of the smoke's
    main paths, pinned (tests/fixtures/torch_split_pins.json);
  * a shape-pinned force steers its own shape and dtype only, a 'plain'
    entry never reaches kernel B, a warmed pick makes no file-system call,
    clear_kernel_caches drops the memo and raises when it clears nothing;
  * the tuner on a tiny so2 model ends 'consulted' and its records
    validate under both schemas; its promotion rule at margin 0;
  * an engine's warmup reports its picks in stats()['kernel_tuning'].
"""
import builtins
import contextlib
import json
import os
import warnings

import numpy as np
import pytest
import torch

import se3_transformer_torch as st
from se3_transformer_torch.kernels import flash as kf
from se3_transformer_torch.kernels import pairwise as kp
from se3_transformer_torch.kernels import tune, tuning
from se3_transformer_torch.observability import schema as tschema
from se3_transformer_torch.so2 import contract as tso2
from se3_transformer_tpu.kernels import tuning as jtuning
from se3_transformer_tpu.kernels.pallas_flash import _pick_stream_chunks
from se3_transformer_tpu.observability import schema as jschema
from se3_transformer_tpu.so2.contract import _pick_so2_chunks

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ENV = ('SE3_TPU_SO2_CHUNKS', 'SE3_TPU_FLASH_CHUNKS', 'SE3_TPU_BLOCK_E',
       'SE3_TPU_BLOCK_IF', 'SE3_TPU_BLOCK_CB', *tuning.ENV_OVERRIDES.values())


@pytest.fixture
def tables(tmp_path, monkeypatch):
    """Each package's table in a temporary directory of its own, no env
    override, empty consult logs and no resolved pick."""
    monkeypatch.setenv('SE3_TPU_CACHE_PATH', str(tmp_path / 'jax'))
    monkeypatch.setenv('SE3_TORCH_CACHE_PATH', str(tmp_path / 'torch'))
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    tuning.clear_kernel_caches()
    tuning.reset_consults()
    jtuning.reset_consults()
    yield tmp_path
    tuning.clear_kernel_caches()
    tuning.reset_consults()
    jtuning.reset_consults()


# --------------------------------------------------------------------- #
# the table against JAX's
# --------------------------------------------------------------------- #
SHAPES = {
    'so2': ((64, 8, 8, 3, 3, 3), (48, 8, 8, 5, 5, 3)),
    'flash_stream': ((128, 8, 1, 2, 2, 24, 128, 40, 3, 256),
                     (96, 8, 1, 2, 2, 8, 128, 16, 1, 128)),
    'flash_global': ((4096, 0, 2, 2, 2, 24, 128, 40, 3, 256),
                     (512, 0, 2, 2, 2, 8, 128, 16, 1, 128)),
}


def _port_pick(kind, shape):
    # the port resolves once per shape: drop the memo, as JAX re-resolves
    # at every trace
    tuning.clear_kernel_caches()
    if kind == 'so2':
        return tso2.pick_so2_chunks(shape, 'float32', 'cpu')
    return kf.pick_stream_chunks(kind, shape, 'float32', 'cpu')


def _jax_pick(kind, shape):
    if kind == 'so2':
        return _pick_so2_chunks(shape, 'float32')
    return _pick_stream_chunks(shape, 'float32', kind=kind)


def _table_sequence(pkg, pick_kind, kind):
    """The sequence both packages run: (the log of picks and lookups, the
    warnings raised, the consult log, the admissible candidates)."""
    def pick(shape):
        return pick_kind(kind, shape)
    a, b = SHAPES[kind]
    ladder = [c[0] for c in pkg.admissible_candidates(kind, a)]
    heur = pick(a)
    c1, c2 = [c for c in ladder if c != heur][:2]
    log = [heur, pkg.lookup(kind, a, dtype='float32')]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        pkg.promote(kind, a, (c1,), dtype='float32', device_kind='cpu',
                    provenance=dict(code_rev='test'))
        log += [pick(a), pick(b), pkg.lookup(kind, a, dtype='float32'),
                pkg.lookup(kind, a, dtype='bfloat16')]
        with pkg.force(kind, (c2,), shape=a, dtype='float32'):
            log += [pick(a), pick(b), pkg.lookup(kind, a, dtype='float32')]
        log.append(pick(a))
        # an inadmissible entry: warned, the heuristic used
        pkg.promote(kind, a, (3,), dtype='float32', device_kind='cpu',
                    provenance=dict(code_rev='test'))
        log.append(pick(a))
        path = pkg.cache_file()
        with open(path) as f:
            good = f.read()
        for text in ('{"version": 1, "entries": ', good[:len(good) // 2],
                     json.dumps(dict(version=pkg.CACHE_VERSION + 1,
                                     entries=json.loads(good)['entries'],
                                     note='bumped'))):
            with open(path, 'w') as f:
                f.write(text)
            log += [pick(a), pkg.lookup(kind, a, dtype='float32')]
        pkg.promote(kind, b, (c1,), dtype='float32', device_kind='cpu',
                    provenance=dict(code_rev='test'))
        log += [pick(a), pick(b)]
    cands = [pkg.admissible_candidates(kind, s)
             for s in (a, b, (1,) + a[1:], (8192,) + a[1:])]
    return log, len(caught), pkg.consults(), cands


@pytest.mark.parametrize('kind', sorted(SHAPES))
def test_table_semantics_match_jax(tables, kind):
    ours = _table_sequence(tuning, _port_pick, kind)
    ref = _table_sequence(jtuning, _jax_pick, kind)
    assert ours[0] == ref[0]
    assert ours[1] == ref[1] == 1
    assert ours[2] == ref[2]
    assert ours[3] == ref[3]


@pytest.mark.parametrize('kind,jax_env', [
    ('so2', 'SE3_TPU_SO2_CHUNKS'), ('flash_stream', 'SE3_TPU_FLASH_CHUNKS'),
    ('flash_global', 'SE3_TPU_FLASH_CHUNKS')])
def test_env_override_wins(tables, monkeypatch, kind, jax_env):
    shape = SHAPES[kind][0]
    for pkg in (tuning, jtuning):
        pkg.promote(kind, shape, (2,), device_kind='cpu',
                    provenance=dict(code_rev='test'))
    monkeypatch.setenv(tuning.ENV_OVERRIDES[kind], '4')
    monkeypatch.setenv(jax_env, '4')
    with tuning.force(kind, (8,), shape=shape, dtype='float32'), \
            jtuning.force(kind, (8,), shape=shape, dtype='float32'):
        assert _port_pick(kind, shape) == _jax_pick(kind, shape) == 4
    assert tuning.consults() == jtuning.consults()
    assert tuning.consults()[-1]['source'] == 'env'


def test_env_override_of_the_split(tables, monkeypatch):
    shape = (12288, 96, 192, 3, 128)
    tuning.promote('plain', shape, (16,), device_kind='cpu')
    monkeypatch.setenv('SE3_TORCH_I_PER_SPLIT', '40')
    assert kp.fwd_i_per_split(*shape, torch.float32, 'cpu') == 40
    monkeypatch.delenv('SE3_TORCH_I_PER_SPLIT')
    tuning.clear_kernel_caches()
    assert kp.fwd_i_per_split(*shape, torch.float32, 'cpu') == 16
    assert {c['source'] for c in tuning.consults()} == {'env', 'cache'}


# --------------------------------------------------------------------- #
# the picks with an empty table
# --------------------------------------------------------------------- #
def smoke_shapes():
    """(E, IF, O, P, mid) of every #3 (and A and B) launch on chip_smoke's
    main paths, from its own shape tables."""
    import chip_smoke as cs
    out = set()
    for E in (4096, 32768):                      # flagship, flagship_fast
        for d in range(4):
            out.add((E, cs.grouped_if(d), 64, 2 * d + 1, 128))
            out.add((E, 64, 64, 2 * d + 1, 128))
            for d_in in range(4):                # so2: a pair's band
                F = 2 * min(d_in, d) + 1
                out.add((E, 64 * F, 64, F, 128))
    for E in (cs.AF2_E, cs.MOL_E):               # af2_refinement, molecular
        for O in (cs.AF2_O, 32):
            for d_in in range(2):
                for d_out in range(2):
                    out.add((E, 32 * (2 * min(d_in, d_out) + 1), O,
                             2 * d_out + 1, 128))
    for P in (1, 3):                             # egnn_stress's conv_in
        out.add((cs.EGNN_N * 16, 16, 16, P, 128))
    for P, IF, O in cs.DENOISE_SHAPES:           # the DenoiseConfig trainer
        out.add((cs.DENOISE_E, IF, O, P, 128))
    for _, _, P, IF in cs.v2_launch_shapes():    # se3_v2
        out.add((cs.V2_E, IF, cs.V2_DIM, P, 32))
    for _, _, P, IF in cs.v2_launch_shapes(dim=cs.V2_SWEEP_DIM):
        out.add((cs.V2_SWEEP_E, IF, cs.V2_SWEEP_DIM, P, 32))
    return sorted(out)


def test_empty_table_picks_are_the_pinned_heuristics(tables):
    with open(os.path.join(HERE, 'fixtures', 'torch_split_pins.json')) as f:
        pins = json.load(f)
    assert sorted(tuple(p[:5]) for p in pins) == smoke_shapes()
    for E, IF, O, P, mid, per, splits in pins:
        assert kp.fwd_i_per_split(E, IF, O, P, mid, torch.float32,
                                  'cpu') == per
        assert kp.fwd_i_per_split(E, IF, O, P, mid, torch.bfloat16,
                                  'cpu') == per
        assert kp.i_per_split(E, IF, O) == per
        assert kp.bwd_splits(E, IF, O) == splits
        assert (per,) in tuning.admissible_candidates('plain',
                                                      (E, IF, O, P, mid))
    assert {c['source'] for c in tuning.consults()} == {'heuristic'}
    assert kp.target_ctas() == kp.SPLIT_TARGET_CTAS == 132


@pytest.mark.parametrize('shape,ladder', [
    ((12288, 96, 192, 3, 128), [96, 48, 32, 16]),
    ((12288, 32, 32, 1, 128), [32, 16, 12, 8, 4]),
    ((32768, 768, 64, 2, 32), None)])
def test_plain_admission_follows_the_kernels_chunks(shape, ladder):
    got = [c[0] for c in tuning.admissible_candidates('plain', shape)]
    if ladder is not None:
        assert got == ladder
    IF, O = shape[1], shape[2]
    chunk = kp.NARROW_I_CHUNK if O in kp.NARROW_O else kp.FWD_I_CHUNK
    for per in got:
        assert per == IF or per % chunk == 0
        assert 1 <= -(-IF // per) <= -(-IF // chunk)
    assert len(set(-(-IF // per) for per in got)) == len(got)


def test_forced_split_steers_its_shape_only(tables):
    a, b = (12288, 96, 192, 3, 128), (12288, 32, 192, 3, 128)
    heur_a = kp.i_per_split(*a[:3])
    with tuning.force('plain', (16,), shape=a, dtype='float32'):
        assert kp.fwd_i_per_split(*a, torch.float32, 'cpu') == 16
        assert kp.fwd_i_per_split(*b, torch.float32, 'cpu') == \
            kp.i_per_split(*b[:3])
        assert kp.fwd_i_per_split(*a, torch.bfloat16, 'cpu') == heur_a
    assert kp.fwd_i_per_split(*a, torch.float32, 'cpu') == heur_a
    sources = {(tuple(c['shape']), c['dtype'], c['source'])
               for c in tuning.consults()}
    assert (a, 'float32', 'forced') in sources
    assert (b, 'float32', 'forced') not in sources


class _FakeLib:
    """A kernel library whose kernel-B entry records its i split."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        entry.__name__ = name
        return entry


def test_plain_entry_leaves_kernel_b_alone(tables, monkeypatch):
    E, IF, O, P, mid = 12288, 96, 192, 3, 128
    tuning.promote('plain', (E, IF, O, P, mid), (16,), device_kind='cpu')
    assert kp.fwd_i_per_split(E, IF, O, P, mid, torch.float32, 'cpu') == 16
    lib = _FakeLib()
    from se3_transformer_torch.kernels import build
    monkeypatch.setattr(build, 'load_library', lambda: lib)
    monkeypatch.setattr(kp, '_stream', lambda t: None)
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda d: contextlib.nullcontext())
    w3 = torch.zeros(mid, IF, O)
    kp._launch_bwd_b(w3, torch.zeros(E, P, IF), torch.zeros(E, P, O),
                     E, IF, O, P)
    (name, args), = lib.calls
    assert name == 'se3_pairwise_bwd_b'
    # (w3, v2, g, dh, work, split, E, IF, O, P, per, ...)
    assert args[6:11] == (E, IF, O, P, kp.i_per_split(E, IF, O)) != \
        (E, IF, O, P, 16)


def test_warm_pick_is_one_lookup_and_the_memo_clears(tables, monkeypatch):
    shape = (12288, 96, 192, 3, 128)
    per = kp.fwd_i_per_split(*shape, torch.float32, 'cpu')
    assert tuning.consults()[0]['count'] == 1

    def refuse(*args, **kwargs):
        raise AssertionError('a warmed pick touched the file system')
    with monkeypatch.context() as m:
        m.setattr(os, 'stat', refuse)
        m.setattr(builtins, 'open', refuse)
        for _ in range(3):
            assert kp.fwd_i_per_split(*shape, torch.float32, 'cpu') == per
    assert tuning.consults()[0]['count'] == 1
    assert tuning.clear_kernel_caches() == 2
    kp.fwd_i_per_split(*shape, torch.float32, 'cpu')
    assert tuning.consults()[0]['count'] == 2
    with monkeypatch.context() as m:
        m.setattr(tuning, '_caches', lambda: [])
        with pytest.raises(RuntimeError, match='cleared nothing'):
            tuning.clear_kernel_caches()


# --------------------------------------------------------------------- #
# the tuner
# --------------------------------------------------------------------- #
SMOKE = ['--smoke', '--device', 'cpu', '--kinds', 'so2', '--conv-backend',
         'so2', '--nodes', '16', '--max-targets', '1', '--max-candidates',
         '1', '--pairs', '1', '--steps', '1']


def _run(tmp_path, argv):
    out = str(tmp_path / 'tune.jsonl')
    rc = tune.main(argv + ['--out', out])
    with open(out) as f:
        return rc, [json.loads(line) for line in f]


def test_cpu_tuner_run_ends_consulted(tables):
    rc, records = _run(tables, SMOKE + ['--margin', '-1'])
    assert rc == 0
    tunes = [r for r in records if r['kind'] == 'tune']
    assert [r['verdict'] for r in tunes] == ['promoted', 'consulted']
    assert tunes[-1]['kernel'] == 'so2' and tunes[-1]['promoted']
    assert records[0]['kind'] == 'run_meta'
    for rec in records:
        tschema.validate_record(rec)
        jschema.validate_record(rec)
    entry, = tuning.entries().values()
    assert entry['blocks'] == tunes[-1]['blocks']


@pytest.mark.parametrize('candidate_rate,verdicts', [
    (11.0, ['promoted', 'consulted']), (10.0, ['rejected'])])
def test_margin_zero_promotes_only_a_win_in_every_pair(
        tables, monkeypatch, candidate_rate, verdicts):
    """At --margin 0 a candidate must be faster than the incumbent in
    every pair (a tie is no win); the windows' rates are given."""
    real = tune._measure_window

    def window(state, steps):
        if steps == 1:     # the warm-up and resolution steps run for real
            return real(state, steps)
        return candidate_rate if tuning._forced else 10.0
    monkeypatch.setattr(tune, '_measure_window', window)
    rc, records = _run(tables, SMOKE + ['--margin', '0', '--pairs', '2',
                                        '--steps', '2'])
    assert rc == 0
    assert [r['verdict'] for r in records if r['kind'] == 'tune'] == verdicts
    assert bool(tuning.entries()) == (verdicts[0] == 'promoted')
    for rec in records:
        jschema.validate_record(rec)


def test_engine_reports_its_picks(tables):
    model = st.SE3TransformerModule(
        dim=8, depth=1, num_degrees=2, heads=2, dim_head=8, num_neighbors=4,
        conv_backend='so2', device='cpu')
    engine = st.InferenceEngine(model, buckets=(12,), device='cpu')
    consults = engine.stats()['kernel_tuning']
    assert consults and {c['kernel'] for c in consults} == {'so2'}
    assert {c['source'] for c in consults} == {'heuristic'}
    # a re-warmup of warmed buckets keeps them; a second engine in the
    # same process resolves its picks again
    engine.warmup()
    assert engine.stats()['kernel_tuning'] == consults
    again = st.InferenceEngine(model, buckets=(12,), device='cpu')
    assert again.stats()['kernel_tuning'] == consults
    rng = np.random.RandomState(0)
    out = engine.predict(rng.normal(size=(10, 8)).astype(np.float32),
                         np.cumsum(rng.normal(size=(10, 3)), 0)
                         .astype(np.float32))
    assert out.shape == (10, 8) and np.isfinite(out).all()
