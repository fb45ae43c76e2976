"""The port's DenoiseConfig / DenoiseTrainer surface
(se3_transformer_torch.training.denoise) against the JAX package's
training/denoise.py: the config's fields and defaults, the synthetic
protein batches draw for draw, the masked-MSE loss on the same parameters
and noise (with the adjacency, ROADMAP C1), and three accumulated Adam
steps of the trainer from JAX's initial parameters with JAX's own noise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_transformer_tpu.training import denoise as jden
from se3_transformer_torch import convert_flax_params
from se3_transformer_torch.training import cli
from se3_transformer_torch.training import denoise as tden

# one intra-op thread, as the other port tests
torch.set_num_threads(1)

# the loss of one forward on the same parameters and noise: float32
# summation order only
LOSS_RTOL = 1e-5
# three steps: the parameters drift apart by float32 rounding, and the
# losses after them by that drift
TRAJ_RTOL = 1e-4


def test_config_fields_and_defaults_are_jax_s():
    jf = {f.name: f.default for f in dataclasses.fields(jden.DenoiseConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tden.DenoiseConfig)}
    assert tf == jf


@pytest.mark.parametrize('field,value,item', [
    ('use_mesh', True, 'A7'), ('tensor_parallel', True, 'A7'),
    ('fsdp', True, 'A7'), ('composed', True, 'A7'),
    ('telemetry', True, 'A8'), ('flush_every', 5, 'A8'),
    ('cost_record', True, 'A8')])
def test_unported_fields_refuse_with_their_roadmap_item(field, value, item):
    """The fields whose machinery is not ported refuse with their ROADMAP
    item; telemetry and flush_every, ported with the guarded loop, and
    cost_record, ported with the attribution half of A8, are accepted (the
    first two give the trainer its telemetry)."""
    if field in tden.UNPORTED_FIELDS:
        with pytest.raises(ValueError, match=f'ROADMAP {item}'):
            tden.DenoiseConfig(**{field: value})
    else:
        cfg = tden.DenoiseConfig(num_nodes=12, **{field: value})
        assert getattr(cfg, field) == value
        trainer = tden.DenoiseTrainer(cfg, device='cpu')
        assert (trainer.metric_acc is not None) == cfg.telemetry
    assert set(tden.UNPORTED_FIELDS) == {'use_mesh', 'tensor_parallel',
                                         'fsdp', 'composed'}
    # donate_batch has no torch counterpart and is accepted
    assert tden.DenoiseConfig(donate_batch=True).donate_batch


def test_synthetic_batches_are_jax_s_draw_for_draw():
    cfg = dict(batch_size=2, num_nodes=18)
    jr, tr = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(2):
        ref = jden.synthetic_protein_batch_host(jden.DenoiseConfig(**cfg), jr)
        got = tden.synthetic_protein_batch_host(tden.DenoiseConfig(**cfg), tr)
        assert sorted(got) == sorted(ref)
        for key in ref:
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key])
        assert not got['adj_mat'].flags.writeable
    dev = tden.synthetic_protein_batch(tden.DenoiseConfig(**cfg),
                                       np.random.RandomState(3), 'cpu')
    np.testing.assert_array_equal(dev['coords'].numpy(), jden.
                                  synthetic_protein_batch_host(
                                      jden.DenoiseConfig(**cfg),
                                      np.random.RandomState(3))['coords'])


def _jax_params(module, batch, seed):
    """Random parameters of the JAX module's shapes, made with numpy."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), batch['seqs'], batch['coords'],
        mask=batch['masks'], adj_mat=batch['adj_mat'],
        return_type=1))['params']
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = str(path[-1].key)
        if name.startswith('scale'):
            v = 1 + 0.1 * rng.normal(size=s.shape)
        elif name in ('bias', 'b3') or name.startswith('b3_'):
            v = 0.1 * rng.normal(size=s.shape)
        else:
            v = rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_loss_passes_the_adjacency_and_matches_jax():
    """ROADMAP C1: the port's denoise_loss passes batch['adj_mat'] and
    reads batch['seqs'], so the DenoiseConfig model (bonded attention only)
    trains; on the same parameters and JAX's own noise (drawn from the key
    JAX's loss uses, handed over as an array) it is JAX's loss."""
    cfg = tden.DenoiseConfig(num_nodes=24)
    batch = tden.synthetic_protein_batch_host(cfg, np.random.RandomState(5))
    jm = jden.DenoiseConfig(num_nodes=24).build_module()
    params = _jax_params(jm, batch, seed=6)
    key = jax.random.PRNGKey(11)
    ref, _ = jax.jit(jden.denoise_loss_fn(jm))(params, batch, key)
    noise = jax.random.normal(key, batch['coords'].shape, jnp.float32)
    model = cfg.build_module(device='cpu')
    model.load_state_dict(convert_flax_params(params, model))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss = tden.denoise_loss(model, tbatch, torch.from_numpy(
        np.asarray(noise)))
    loss = float(loss.detach())
    assert abs(loss - float(ref)) <= LOSS_RTOL * abs(float(ref))
    wrapped, aux = tden.denoise_loss_fn(model)(tbatch, torch.from_numpy(
        np.asarray(noise)))
    assert float(wrapped) == float(loss) == float(aux['loss'])


def _step_noise(key, accum, shape):
    """The noise of one JAX train_step from the trainer's key, split as
    the step splits it: (key', sub) = split(key), then per micro-batch
    (sub, s) = split(sub) and normal(s)."""
    key, sub = jax.random.split(key)
    noise = []
    for _ in range(accum):
        sub, s = jax.random.split(sub)
        noise.append(np.asarray(jax.random.normal(s, shape, jnp.float32)))
    return key, np.stack(noise)


def test_trainer_three_steps_match_jax():
    """ROADMAP A2.6, parity under trained weights: DenoiseConfig(num_nodes
    = 24, accum_steps = 2), JAX's initial parameters (converted), JAX's
    batches (the same np_rng stream) and JAX's per-step noise; the loss
    trajectory within TRAJ_RTOL relative. The final parameters within 2 *
    lr * steps (6e-4) of JAX's, the most by which Adam's normalized update
    can move a parameter whose gradient is at rounding level and so may
    flip sign between the two; in the median, within 1e-6 of JAX's."""
    jcfg = jden.DenoiseConfig(num_nodes=24, accum_steps=2)
    jt = jden.DenoiseTrainer(jcfg)
    tr = tden.DenoiseTrainer(tden.DenoiseConfig(num_nodes=24, accum_steps=2),
                             device='cpu')
    # JAX's init as its first train_step makes it (the first step's
    # batch, then init's 3-way key split), its parameters kept on the host:
    # the step donates the device buffers
    first = jt.micro_batches_host()
    jt.init(jax.tree_util.tree_map(lambda v: v[0], first))
    init_params = jax.device_get(jt.params)
    tfirst = tr.micro_batches_host()
    for key in first:
        np.testing.assert_array_equal(tfirst[key], first[key])
    tr.init(tfirst)
    tr.model.load_state_dict(convert_flax_params(init_params, tr.model))
    shape = (jcfg.batch_size, jcfg.num_nodes, 3)
    for step in range(3):
        jb = first if step == 0 else jt.micro_batches_host()
        tb = tfirst if step == 0 else tr.micro_batches_host()
        _, noise = _step_noise(jt.rng, 2, shape)
        ref = float(jt.train_step(jb))
        got = float(tr.train_step(tb, noise=noise))
        assert abs(got - ref) <= TRAJ_RTOL * abs(ref), step
        np.testing.assert_allclose(tr.last_micro_losses.numpy(),
                                   np.asarray(jt.last_micro_losses),
                                   rtol=TRAJ_RTOL)
    assert tr.step_count == jt.step_count == 3
    want = convert_flax_params(jax.device_get(jt.params), tr.model)
    diffs = np.concatenate([(tr.params[k] - v).abs().flatten().numpy()
                            for k, v in want.items()])
    assert diffs.max() <= 2 * jcfg.learning_rate * 3
    assert np.median(diffs) <= 1e-6


def test_trainer_surface_and_refusals():
    tr = tden.DenoiseTrainer(tden.DenoiseConfig(num_nodes=12, accum_steps=2),
                             device='cpu')
    # the guarded loop rides the telemetry accumulator
    with pytest.raises(ValueError, match='telemetry=True'):
        tr.train_guarded(1, None)
    host = tr.micro_batches_host()
    assert host['seqs'].shape == (2, 1, 12) and host['adj_mat'].shape == \
        (2, 1, 12, 12)
    dev = tr.micro_batches()
    assert dev['coords'].shape == (2, 1, 12, 3)
    history = tr.train(2)
    assert [h['step'] for h in history] == [1, 2]
    assert all(np.isfinite(h['loss']) for h in history)
    assert tr.last_micro_losses.shape == (2,)
    plain = tden.DenoiseTrainer(tr.model, device='cpu')
    with pytest.raises(RuntimeError, match='DenoiseConfig form'):
        plain.micro_batches()
    # cfg.pipeline: train is train_pipelined, the same losses as the
    # synchronous loop from the same seed
    cfg = dict(num_nodes=12, accum_steps=2)
    sync = tden.DenoiseTrainer(tden.DenoiseConfig(**cfg), device='cpu')
    piped = tden.DenoiseTrainer(tden.DenoiseConfig(**cfg, pipeline=True),
                                device='cpu').train(2)
    assert piped[-1]['kind'] == 'pipeline' and piped[-1]['steps'] == 2
    assert [h['loss'] for h in piped[:-1]] == \
        [h['loss'] for h in sync.train(2)]


@pytest.mark.parametrize('flag', ['--mesh', '--telemetry', '--guarded',
                                  '--metrics'])
def test_cli_refuses_unported_flags(flag, capsys):
    """--mesh is still refused with its ROADMAP item; --telemetry,
    --guarded (with its --ckpt-dir) and --metrics, ported with the guarded
    loop, parse as denoise.py's."""
    if flag in cli.UNPORTED_FLAGS:
        with pytest.raises(SystemExit):
            cli.parse_args([flag])
        assert 'ROADMAP A' in capsys.readouterr().err
        return
    argv = {'--telemetry': ['--telemetry'],
            '--guarded': ['--guarded', '--ckpt-dir', 'd'],
            '--metrics': ['--metrics', 'm.jsonl']}[flag]
    args = cli.parse_args(argv)
    assert args.telemetry == (flag != '--metrics')
    assert args.guarded == (flag == '--guarded')
    assert args.metrics == ('m.jsonl' if flag == '--metrics' else None)
