"""The port's checkpoint manager (se3_transformer_torch.training.checkpoint)
with the DenoiseConfig trainer on the CPU: save, restore and resume give
the uninterrupted run's next loss; max_to_keep; the model-family guard; a
torn newest entry falls back; save_async ahead of an in-place step holds
the named step's state; restore_params; the CLI's resume. The JAX
manager's semantics (se3_transformer_tpu/training/checkpoint.py) in the
port's own torch.save format."""
import os

import numpy as np
import pytest
import torch

from se3_transformer_torch.training import cli
from se3_transformer_torch.training.checkpoint import (
    CheckpointManager, ModelFamilyMismatch, snapshot_device_arrays,
)
from se3_transformer_torch.training.denoise import (
    DenoiseConfig, DenoiseTrainer,
)

torch.set_num_threads(1)

CFG = dict(num_nodes=12, accum_steps=2)


def _trainer():
    return DenoiseTrainer(DenoiseConfig(**CFG), device='cpu')


def _state(tr):
    return (tr.params, tr.opt_state, tr.step_count)


def test_save_restore_resume_gives_the_same_next_loss(tmp_path):
    """A trainer restored from step 2 takes the uninterrupted run's third
    step to the same bits: the model, Adam's moments and its step count
    come back exactly (the batch and the noise are handed to both)."""
    tr = _trainer()
    tr.train(2)
    batch = tr.micro_batches_host()
    noise = np.random.RandomState(0).normal(size=(2, 1, 12, 3)).astype(
        np.float32)
    with CheckpointManager(str(tmp_path)) as cm:
        cm.save(tr.step_count, _state(tr))
        assert cm.all_steps() == [2] and cm.latest_step() == 2
        want = float(tr.train_step(batch, noise=noise))
        fresh = _trainer()
        fresh.init()
        fresh.restore(cm.restore(like=_state(fresh)))
    assert fresh.step_count == 2
    assert float(fresh.train_step(batch, noise=noise)) == want
    for key, value in tr.params.items():
        assert torch.equal(fresh.params[key], value), key


def test_max_to_keep(tmp_path):
    cm = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4):
        cm.save(step, ({'w': torch.full((3,), float(step))}, {}, step))
    assert cm.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ['step_00000003.pt',
                                            'step_00000004.pt']


def test_family_guard_raises(tmp_path):
    CheckpointManager(str(tmp_path), model_family='se3_v1').save(
        1, ({'w': torch.zeros(2)}, {}, 1))
    assert os.path.exists(tmp_path / 'step_00000001.meta.json')
    other = CheckpointManager(str(tmp_path), model_family='se3_v2')
    with pytest.raises(ModelFamilyMismatch, match="'se3_v1'"):
        other.restore()
    with pytest.raises(ModelFamilyMismatch):
        other.restore_params(1)
    # an unguarded manager reads it
    assert CheckpointManager(str(tmp_path)).restore()[2] == 1


def test_truncated_newest_entry_falls_back(tmp_path):
    cm = CheckpointManager(str(tmp_path), max_to_keep=5)
    for step in (1, 2):
        cm.save(step, ({'w': torch.full((4,), float(step))}, {}, step))
    path = tmp_path / 'step_00000002.pt'
    path.write_bytes(path.read_bytes()[:40])
    fresh = CheckpointManager(str(tmp_path))
    with pytest.warns(RuntimeWarning, match='step 2'):
        state = fresh.restore()
    assert fresh.last_restored_step == 1 and state[2] == 1
    assert not fresh.verify_step(2) and fresh.verify_step(1)
    with pytest.raises(Exception):
        fresh.restore(step=2)


def test_save_async_ahead_of_an_in_place_step_holds_its_step(tmp_path):
    """torch's Adam updates in place: save_async snapshots before it
    returns, so steps run while the write is in flight change nothing in
    the checkpoint it names."""
    tr = _trainer()
    tr.train(1)
    want = {k: v.clone() for k, v in tr.params.items()}
    want_m = {k: v['exp_avg'].clone() for k, v in
              tr.optimizer.state_dict()['state'].items()}
    cm = CheckpointManager(str(tmp_path))
    cm.save_async(1, _state(tr))
    tr.train(2)                      # in place, while the write may run
    cm.wait_until_finished()
    assert not cm.save_in_flight
    params, opt_state, step = cm.restore()
    assert step == 1
    for key, value in want.items():
        assert torch.equal(params[key], value), key
    for key, value in want_m.items():
        assert torch.equal(opt_state['state'][key]['exp_avg'], value)
    moved = [k for k in want if not torch.equal(tr.params[k], want[k])]
    assert moved


def test_snapshot_copies_cpu_tensors():
    t = torch.ones(3)
    snap = snapshot_device_arrays(({'a': t}, [t], 5))
    t.add_(1)
    assert torch.equal(snap[0]['a'], torch.ones(3)) and snap[2] == 5


def test_restore_params(tmp_path):
    tr = _trainer()
    tr.train(1)
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _state(tr))
    params = cm.restore_params()
    assert cm.last_restored_step == 1
    assert sorted(params) == sorted(tr.params)
    model = DenoiseConfig(**CFG).build_module(device='cpu')
    model.load_state_dict(params)
    for key, value in model.state_dict().items():
        assert torch.equal(value, tr.params[key])


def test_async_write_failure_surfaces(tmp_path):
    """A failed write on the writer thread surfaces at the next barrier."""
    cm = CheckpointManager(str(tmp_path / 'gone'))
    os.rmdir(tmp_path / 'gone')      # the write has nowhere to go
    cm.save_async(1, ({'w': torch.zeros(2)}, {}, 1))
    with pytest.raises(RuntimeError, match='async checkpoint write failed'):
        cm.wait_until_finished()


def test_cli_resumes_and_saves_at_exit(tmp_path, capsys):
    args = ['--cpu', '--steps', '1', '--nodes', '12', '--accum', '2',
            '--ckpt-dir', str(tmp_path)]
    cli.main(args)
    cli.main(args)
    out = capsys.readouterr().out
    assert 'resumed from step 1' in out and 'checkpointed at step 2' in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [1, 2]
