"""The coordinate-denoising trainer: the port of
se3_transformer_tpu/training/denoise.py (DenoiseConfig, the synthetic
protein batches, denoise_loss_fn, DenoiseTrainer with train,
train_pipelined, its telemetry and train_guarded) and of the step bench.py
times
(parallel/sharding.py::make_sharded_train_step with optax.adam, and its
grad-accumulation variant make_accumulating_train_step).

The model sees the coordinates plus Gaussian noise and predicts, per node,
the vector that maps the noised coordinates back to the clean ones
(return_type=1 of a model with output_degrees=2 and reduce_dim_out=True),
trained with a masked MSE and gradient accumulation.

DenoiseTrainer takes either a DenoiseConfig (the JAX trainer's surface:
the model cfg.build_module() builds, synthetic or dataset batches, the
pipelined loop, checkpoints through training.checkpoint) or a built model
(the recipe paths: flagship_fast, flagship, af2_refinement,
molecular_edges, egnn_stress) with any loss of the trainer's signature
(the counterpart of make_sharded_train_step(loss_fn)): `property_loss` is
the molecular property regression of examples/molecular_property.py, on
batches drawn by `molecular_batch`.

With cfg.telemetry the step folds its loss (per micro-batch) and the global
L2 norm of the gradients it applies into an on-device MetricAccumulator
(no host sync), a PhaseTimer bills the process's first step to `warmup`
and the rest to `step` (and times `data` and `checkpoint`), a
RetraceWatchdog counts the one-time host work after the first step, and
`train` / `train_pipelined` write one schema'd `flush` record every
cfg.flush_every steps (one device-to-host copy each) and a `summary` at the
end. `train_guarded` is training.guardian's self-healing loop. Meshes and
FSDP (ROADMAP A7) are not ported: their config fields refuse any value but
their defaults.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import itertools
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..models.se3_transformer import SE3TransformerModule, init_parameters
from ..utils.graph import chain_adjacency
from ..utils.helpers import resolve_device
from .pipeline import _host_tensor

Batch = Dict[str, torch.Tensor]


def flagship_batch(rng: np.random.RandomState, b: int, n: int,
                   dim: int) -> Dict[str, np.ndarray]:
    """bench.py's flagship batch, draw for draw: continuous degree-0
    features normal [b, n, dim], chain coordinates (a cumulative sum of
    normal steps, centred) [b, n, 3], an all-true mask [b, n]."""
    feats = rng.normal(size=(b, n, dim)).astype(np.float32)
    coords = np.cumsum(rng.normal(size=(b, n, 3)), axis=1).astype(np.float32)
    coords = coords - coords.mean(axis=1, keepdims=True)
    return dict(feats=feats, coords=coords, masks=np.ones((b, n), bool))


def molecular_batch(rng: np.random.RandomState, b: int, n: int,
                    num_tokens: int, num_bonds: int) -> Dict[str, np.ndarray]:
    """A synthetic molecule batch, drawn as examples/molecular_property.py's
    build_batch draws it: atom tokens [b, n], a chain skeleton
    (cumulative normal steps of scale 0.7, centred) [b, n, 3], symmetric
    bond-type tokens with a zero diagonal [b, n, n], and the invariant
    target [b] (the mean pairwise distance plus the mean atom type over
    num_tokens); with the chain adjacency [b, n, n] and an all-true mask
    [b, n]."""
    tokens = rng.randint(0, num_tokens, (b, n))
    coords = np.cumsum(rng.normal(scale=0.7, size=(b, n, 3)), axis=1)
    coords = (coords - coords.mean(1, keepdims=True)).astype(np.float32)
    bonds = np.triu(rng.randint(0, num_bonds, (b, n, n)), 1)
    bonds = bonds + bonds.transpose(0, 2, 1)
    d = np.linalg.norm(coords[:, :, None] - coords[:, None, :], axis=-1)
    target = (d.mean((1, 2)) + tokens.mean(1) / num_tokens) \
        .astype(np.float32)
    adj_mat = np.broadcast_to(chain_adjacency(n), (b, n, n)).copy()
    return dict(tokens=tokens, coords=coords, edges=bonds, adj_mat=adj_mat,
                masks=np.ones((b, n), bool), target=target)


def property_loss(model: torch.nn.Module, batch: Batch,
                  noise=None) -> torch.Tensor:
    """The squared error of the pooled type-0 readout's channel mean
    against batch['target'], averaged over the batch (the loss of
    examples/molecular_property.py). `noise` is unused: the trainer's loss
    signature."""
    pooled = model(batch['tokens'], batch['coords'], mask=batch['masks'],
                   adj_mat=batch['adj_mat'], edges=batch['edges'],
                   return_type=0, return_pooled=True)
    return ((pooled.mean(-1) - batch['target']) ** 2).mean()


def denoise_loss(model: torch.nn.Module, batch: Batch,
                 noise: Union[torch.Tensor, torch.Generator]) -> torch.Tensor:
    """The masked MSE of denoise_loss_fn: sum over xyz of the squared error
    of (noised + model(seqs, noised)) against the clean coordinates,
    averaged over the real nodes. The model input is batch['seqs'] (the
    JAX batch's tokens) or else batch['feats'] (bench.py's flagship
    batch); batch['adj_mat'], when the batch has it, goes to the model as
    JAX's loss passes it. `noise` is the coordinate noise itself, or a
    torch.Generator on the batch's device to draw it from."""
    coords, masks = batch['coords'], batch['masks']
    if isinstance(noise, torch.Generator):
        noise = torch.randn(coords.shape, generator=noise,
                            dtype=coords.dtype, device=coords.device)
    noised = coords + noise
    extra = {'adj_mat': batch['adj_mat']} if 'adj_mat' in batch else {}
    out = model(batch['seqs'] if 'seqs' in batch else batch['feats'], noised,
                mask=masks, return_type=1, **extra)
    sq = (((noised + out) - coords) ** 2).sum(-1)
    total = torch.where(masks, sq, torch.zeros_like(sq)).sum()
    return total / masks.sum().clamp(min=1).to(sq.dtype)


# the JAX DenoiseConfig fields whose machinery the port has not, each with
# the ROADMAP item that ports it: a value other than the default raises
UNPORTED_FIELDS = {
    'use_mesh': 'ROADMAP A7 (parallelism)',
    'tensor_parallel': 'ROADMAP A7 (parallelism)',
    'fsdp': 'ROADMAP A7 (parallelism)',
    'composed': 'ROADMAP A7 (parallelism)',
}


@dataclasses.dataclass
class DenoiseConfig:
    """The JAX DenoiseConfig: every field, with its default.

    The model (toy_denoise's fields: tokens 24, dim 8, 2 heads of 8, depth
    2, degrees 0 and 1 with a vector head, bonded attention over the 2-hop
    chain adjacency), the data (batch_size x num_nodes nodes, 96 = 32
    residues x 3 backbone atoms), Adam at learning_rate with accum_steps
    micro-batches an update (the CLI's default is 16), the seed, the
    trainer telemetry (telemetry, flush_every: see DenoiseTrainer) and the
    pipelined data path (pipeline, prefetch_depth, producer_capacity).
    noise_scale is carried as JAX carries it: neither package's loss reads
    it (the coordinate noise is standard normal).

    use_mesh, tensor_parallel, fsdp and composed (ROADMAP A7) refuse any
    value but their defaults. cost_record writes one `cost` record of a
    warm training step after the first step of train() / train_pipelined()
    (DenoiseTrainer.cost_record; on a card only: the CPU has no allocator
    peak, and a failed record warns and never stops the run).
    donate_batch is accepted and changes nothing: JAX donates the batch's
    device buffers to the jitted step so that XLA may reuse them; the
    port's step holds no reference to a batch past the call, so the
    caching allocator reuses its memory as soon as the caller drops it,
    and there is nothing to donate."""
    num_tokens: int = 24
    dim: int = 8
    dim_head: int = 8
    heads: int = 2
    depth: int = 2
    num_degrees: int = 2
    output_degrees: int = 2
    num_neighbors: int = 0
    attend_sparse_neighbors: bool = True
    max_sparse_neighbors: int = 8
    num_adj_degrees: int = 2
    adj_dim: int = 4
    batch_size: int = 1
    num_nodes: int = 96
    noise_scale: float = 1.0
    learning_rate: float = 1e-4
    accum_steps: int = 1
    seed: int = 0
    use_mesh: bool = False
    tensor_parallel: bool = False
    fsdp: bool = False
    composed: bool = False
    log_every: int = 1
    telemetry: bool = False
    flush_every: int = 10
    pipeline: bool = False
    prefetch_depth: int = 2
    producer_capacity: int = 4
    donate_batch: bool = False
    cost_record: bool = False

    def __post_init__(self):
        for name, item in UNPORTED_FIELDS.items():
            default = DenoiseConfig.__dataclass_fields__[name].default
            if getattr(self, name) != default:
                raise ValueError(
                    f'DenoiseConfig.{name}={getattr(self, name)!r}: its '
                    f'machinery is not ported ({item}); leave it at '
                    f'{default!r}')

    def build_module(self, device='cuda',
                     generator: Optional[torch.Generator] = None
                     ) -> SE3TransformerModule:
        return SE3TransformerModule(
            num_tokens=self.num_tokens, dim=self.dim, dim_head=self.dim_head,
            heads=self.heads, depth=self.depth, attend_self=True,
            input_degrees=1, num_degrees=self.num_degrees,
            output_degrees=self.output_degrees, reduce_dim_out=True,
            differentiable_coors=True, num_neighbors=self.num_neighbors,
            attend_sparse_neighbors=self.attend_sparse_neighbors,
            max_sparse_neighbors=self.max_sparse_neighbors,
            num_adj_degrees=self.num_adj_degrees, adj_dim=self.adj_dim,
            device=device, generator=generator)


@functools.lru_cache(maxsize=64)
def _chain_adjacency_cached(n: int) -> np.ndarray:
    """The chain adjacency of n nodes, computed once per process and marked
    read-only: every consumer broadcasts or copies it."""
    adj = chain_adjacency(n)
    adj.setflags(write=False)
    return adj


def synthetic_protein_batch_host(cfg: DenoiseConfig,
                                 rng: np.random.RandomState) -> dict:
    """JAX's host batch, draw for draw: residue tokens seqs [b, n] int32, a
    random-walk chain of unit steps x 1.5 centred, coords [b, n, 3], an
    all-true mask [b, n], and adj_mat [b, n, n], a read-only broadcast view
    of the cached chain adjacency. Pure numpy: the producer thread's half
    of the pipelined data path."""
    b, n = cfg.batch_size, cfg.num_nodes
    seqs = rng.randint(0, cfg.num_tokens, size=(b, n)).astype(np.int32)
    steps = rng.normal(size=(b, n, 3)).astype(np.float32)
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
    coords = np.cumsum(1.5 * steps, axis=1).astype(np.float32)
    coords -= coords.mean(axis=1, keepdims=True)
    masks = np.ones((b, n), dtype=bool)
    adj = np.broadcast_to(_chain_adjacency_cached(n)[None], (b, n, n))
    return dict(seqs=seqs, coords=coords, masks=masks, adj_mat=adj)


def synthetic_protein_batch(cfg: DenoiseConfig, rng: np.random.RandomState,
                            device='cuda') -> Batch:
    """synthetic_protein_batch_host's batch as tensors on `device` (the
    same values)."""
    dev = resolve_device(device)
    return {k: _host_tensor(v).to(dev)
            for k, v in synthetic_protein_batch_host(cfg, rng).items()}


def denoise_loss_fn(module: torch.nn.Module) -> Callable:
    """JAX's denoise_loss_fn(module): loss_fn(batch, noise) -> (loss,
    dict(loss=loss)), the masked MSE of denoise_loss on `module`."""
    def loss_fn(batch: Batch, noise):
        loss = denoise_loss(module, batch, noise)
        return loss, dict(loss=loss)
    return loss_fn


class DenoiseTrainer:
    """Adam on the denoise loss (or `loss_fn`), with gradient accumulation.

        trainer = DenoiseTrainer(DenoiseConfig(accum_steps=16))
        history = trainer.train(20, checkpoint_manager=CheckpointManager(d))

        trainer = DenoiseTrainer(flagship_fast(output_degrees=2,
                                               reduce_dim_out=True))
        loss = trainer.train_step(flagship_batch(rng, 1, 1024, 64))

    Adam is torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8), the update
    of optax.adam's defaults. With accum_steps > 1 every batch leaf carries
    a leading [accum_steps] axis, and the step averages the micro-batches'
    gradients before one update. loss_fn(model, batch, noise) -> a scalar
    (denoise_loss by default; property_loss for molecular_edges);
    `noise` is the step's coordinate noise or the trainer's generator.

    Given a DenoiseConfig, the trainer is the JAX DenoiseTrainer's
    surface: the model is cfg.build_module() with weights drawn from a CPU
    generator seeded cfg.seed (init() draws them again), lr and
    accum_steps are the config's, batches come from a
    np.random.RandomState(cfg.seed) (`np_rng`, JAX's stream draw for draw)
    and the noise from a torch.Generator on the trainer's device seeded
    cfg.seed. The model and optimizer state are `params` and `opt_state`
    (state dicts), and `restore((params, opt_state, step_count))` adopts a
    checkpoint. torch's Adam updates them in place: a checkpoint must be
    taken as a snapshot (training.checkpoint does).

    With cfg.telemetry the trainer keeps `metric_acc` (MetricAccumulator
    of 'loss' and 'grad_norm' on its device), `phase_timer` and `watchdog`
    (RetraceWatchdog, armed after the process's first step);
    `telemetry_flush` and `telemetry_close` write the `flush` and `summary`
    records (module docstring).

    Given a model, `lr`, `accum_steps` and `generator` (seeded 0 when
    None) are the arguments'."""

    def __init__(self, model: Union[torch.nn.Module, DenoiseConfig], *,
                 lr: float = 1e-4, accum_steps: int = 1, device='cuda',
                 generator: Optional[torch.Generator] = None,
                 loss_fn: Callable = denoise_loss):
        self.device = resolve_device(device)
        self.cfg = None
        self.np_rng = None
        seed = 0
        if isinstance(model, DenoiseConfig):
            self.cfg = model
            seed = self.cfg.seed
            model = self.cfg.build_module(
                device='cpu', generator=torch.Generator().manual_seed(seed))
            lr, accum_steps = self.cfg.learning_rate, \
                max(1, self.cfg.accum_steps)
            self.np_rng = np.random.RandomState(seed)
        if accum_steps < 1:
            raise ValueError(f'accum_steps must be >= 1, got {accum_steps}')
        self.model = model.to(self.device).train()
        self.accum_steps = int(accum_steps)
        self.loss_fn = loss_fn
        self.lr = lr
        self.optimizer = self._adam()
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(seed)
        self.generator = generator
        self.step_count = 0
        # the per-micro-batch losses of the last step (accum_steps > 1)
        self.last_micro_losses = None
        # the config form initializes at its first step (or init()), as
        # JAX's trainer does
        self._initialized = self.cfg is None
        self.metric_acc = None
        self.phase_timer = None
        self.watchdog = None
        if self.cfg is not None and self.cfg.telemetry:
            from ..observability import (
                MetricAccumulator, PhaseTimer, RetraceWatchdog,
            )
            self.metric_acc = MetricAccumulator.zero(('loss', 'grad_norm'),
                                                     self.device)
            self.phase_timer = PhaseTimer()
            self.watchdog = RetraceWatchdog(device=self.device)
            self._cum_metrics = None     # the host-side merge of windows
            self._flush_count = 0
            self._last_flush_step = 0
            self._first_loss = None      # device tensors, synced at close
            self._last_loss = None
            # the first step of this process (not of the run: a resumed
            # trainer has step_count > 0) builds the device constants and
            # loads the kernel library: billed to 'warmup'
            self._warmed_up = False

    def _adam(self) -> torch.optim.Adam:
        return torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                betas=(0.9, 0.999), eps=1e-8)

    @property
    def params(self) -> dict:
        """The model's state dict (live tensors: snapshot before the next
        step to keep it)."""
        return self.model.state_dict()

    @property
    def opt_state(self) -> dict:
        """The optimizer's state dict (live tensors, as `params`)."""
        return self.optimizer.state_dict()

    def init(self, batch=None) -> dict:
        """Draw the weights (from a CPU generator seeded cfg.seed) and a
        fresh Adam state; returns `params`. With no batch one batch is drawn
        from np_rng, as JAX's init draws one, so that the batch stream
        after it is JAX's; a given batch is only its shapes' witness."""
        if self.cfg is None:
            raise RuntimeError('init() belongs to the DenoiseConfig form; a '
                               'trainer given a model trains its weights')
        if batch is None:
            synthetic_protein_batch_host(self.cfg, self.np_rng)
        init_parameters(self.model,
                        torch.Generator().manual_seed(self.cfg.seed))
        self.optimizer = self._adam()
        self._initialized = True
        return self.params

    def restore(self, state) -> None:
        """Adopt a (params, opt_state, step_count) checkpoint tuple (state
        dicts on any device). Every tensor is copied onto the trainer's:
        Adam updates its state in place, and the optimizer would adopt a
        tensor already on its device and dtype as it is, so the trainer
        shares no storage with `state`."""
        params, opt_state, step_count = state
        self.model.load_state_dict(params)
        self.optimizer.load_state_dict(copy.deepcopy(opt_state))
        self.step_count = int(step_count)
        self._initialized = True

    def to_device(self, batch) -> Batch:
        """numpy or torch leaves -> tensors on the trainer's device."""
        return {k: _host_tensor(v).to(self.device) for k, v in batch.items()}

    def train_step(self, batch, noise: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """One optimizer step. `noise` (shaped like batch['coords']) is
        drawn from the trainer's generator when None. Returns the loss (the
        mean over micro-batches) as a device tensor, without a host
        sync. With cfg.telemetry the step is timed ('warmup' for the
        process's first, 'step' after: dispatch time, no synchronize) and
        its losses and gradient norm fold into `metric_acc`."""
        batch = self.to_device(batch)
        if not self._initialized:
            self.init(batch if self.accum_steps == 1
                      else {k: v[0] for k, v in batch.items()})
        if noise is not None:
            noise = torch.as_tensor(noise, device=self.device)
        if self.metric_acc is None:
            return self._step(batch, noise)
        with self.phase_timer.phase('step' if self._warmed_up
                                    else 'warmup'):
            loss = self._step(batch, noise)
        if not self._warmed_up:
            # one-time host work after this step is a regression
            self._warmed_up = True
            self.watchdog.arm()
        if self._first_loss is None:
            self._first_loss = loss
        self._last_loss = loss
        return loss

    def _step(self, batch: Batch, noise: Optional[torch.Tensor]
              ) -> torch.Tensor:
        single = self.accum_steps == 1
        self.optimizer.zero_grad(set_to_none=True)
        losses = []
        for j in range(self.accum_steps):
            micro = batch if single else {k: v[j] for k, v in batch.items()}
            eps = self.generator if noise is None else \
                (noise if single else noise[j])
            loss = self.loss_fn(self.model, micro, eps)
            (loss / self.accum_steps).backward()
            losses.append(loss.detach())
        micro_losses = torch.stack(losses)
        if self.metric_acc is not None:
            # the global L2 norm of the (averaged) gradients Adam applies,
            # on the device: one norm per tensor, then the norm of those
            grads = [p.grad for p in self.model.parameters()
                     if p.grad is not None]
            grad_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            self.metric_acc = self.metric_acc.update(loss=micro_losses,
                                                     grad_norm=grad_norm)
        self.optimizer.step()
        self.last_micro_losses = None if single else micro_losses
        self.step_count += 1
        return micro_losses.mean()

    # ------------------------------------------------------------------ #
    # the cost ledger (observability.costs)
    # ------------------------------------------------------------------ #
    def cost_record(self, batch, metric_logger=None) -> dict:
        """The `cost` record of one training step on `batch`: the
        allocator's peak over one step, the argument bytes of the
        parameters, the optimizer state and the batch (step_cost_payload).
        The step runs on a snapshot: the parameters, the optimizer state,
        the noise generator, the telemetry accumulator and the step count
        are put back after it, so that training goes on as if it had not
        run. Writes the record through `metric_logger` when given; returns
        its fields either way. Needs a card."""
        from ..observability.costs import step_cost_payload
        batch = self.to_device(batch)
        if not self._initialized:
            self.init(batch if self.accum_steps == 1
                      else {k: v[0] for k, v in batch.items()})

        def host(tree):
            return torch.utils._pytree.tree_map(
                lambda t: t.detach().to('cpu', copy=True)
                if isinstance(t, torch.Tensor) else t, tree)
        params, opt_state = host(self.params), host(self.opt_state)
        kept = (self.generator.get_state(), self.metric_acc,
                self.step_count, self.last_micro_losses)
        try:
            fields = step_cost_payload(
                lambda: self._step(batch, None),
                label=self._telemetry_label()
                if self.cfg is not None else 'denoise_step',
                state=[*self.model.parameters(), *[
                    t for st in self.optimizer.state.values()
                    for t in st.values() if isinstance(t, torch.Tensor)]],
                batch=batch.values(), device=self.device)
        finally:
            self.model.load_state_dict(params)
            self.optimizer.load_state_dict(opt_state)
            (state, self.metric_acc, self.step_count,
             self.last_micro_losses) = kept
            self.generator.set_state(state)
        if metric_logger is not None:
            return metric_logger.log_record('cost', mirror=False, **fields)
        return dict(fields, kind='cost')

    def _maybe_cost_record(self, batch, metric_logger, history):
        """The first-step hook of train / train_pipelined (JAX's): with
        cfg.cost_record, one cost_record of `batch` into `history`. A
        failed record warns and never stops the run."""
        if not self.cfg.cost_record:
            return
        try:
            history.append(self.cost_record(batch, metric_logger))
        except Exception as e:  # noqa: BLE001 - the ledger never costs the
            # training run
            import warnings
            warnings.warn(f'cost record failed ({type(e).__name__}: {e})',
                          stacklevel=2)

    # ------------------------------------------------------------------ #
    # the DenoiseConfig form's batches and loops
    # ------------------------------------------------------------------ #
    def _config(self) -> DenoiseConfig:
        if self.cfg is None:
            raise RuntimeError('the batch builders and loops belong to the '
                               'DenoiseConfig form of the trainer')
        return self.cfg

    def micro_batches_host(self) -> dict:
        """accum_steps synthetic host batches stacked on a leading axis
        (one batch when accum_steps is 1), numpy, from np_rng."""
        cfg = self._config()
        batches = [synthetic_protein_batch_host(cfg, self.np_rng)
                   for _ in range(self.accum_steps)]
        if self.accum_steps == 1:
            return batches[0]
        return {k: np.stack([b[k] for b in batches]) for k in batches[0]}

    def micro_batches(self) -> Batch:
        """micro_batches_host's batch as tensors on the trainer's device
        (the same values, the same stream)."""
        return self.to_device(self.micro_batches_host())

    def _nodes_per_step(self) -> int:
        cfg = self._config()
        return cfg.batch_size * cfg.num_nodes * self.accum_steps

    def _log_record(self, loss, i, t0, log, extra=''):
        loss = float(loss)   # the host sync, at the log interval only
        rate = self._nodes_per_step() * (i + 1) / (time.time() - t0)
        rec = dict(step=self.step_count, loss=loss,
                   nodes_steps_per_sec=rate)
        if self.last_micro_losses is not None:
            # the mean alone hides a diverging micro-batch
            ml = self.last_micro_losses.tolist()
            rec.update(micro_loss_min=min(ml), micro_loss_max=max(ml))
            extra = f' micro [{min(ml):.4f}, {max(ml):.4f}]' + extra
        log(f'step {self.step_count} loss {loss:.4f} '
            f'nodes*steps/sec {rate:.1f}{extra}')
        return rec

    def _state(self):
        return (self.params, self.opt_state, self.step_count)

    # ------------------------------------------------------------------ #
    # telemetry: the flush cadence is the host's
    # ------------------------------------------------------------------ #
    def _telemetry(self):
        if self.metric_acc is None:
            raise RuntimeError('trainer telemetry needs '
                               'DenoiseConfig(telemetry=True)')

    def _phase(self, name: str):
        """The phase timer's `name` phase, or nothing without telemetry."""
        return self.phase_timer.phase(name) if self.phase_timer is not None \
            else contextlib.nullcontext()

    def _telemetry_label(self) -> str:
        c = self.cfg
        return (f'denoise,dim={c.dim},depth={c.depth},n={c.num_nodes},'
                f'deg={c.num_degrees},accum={self.accum_steps}')

    def telemetry_flush(self, metric_logger=None) -> dict:
        """Flush the window: one device-to-host copy (the accumulator), the
        phase percentiles and the watchdog's snapshot, as one schema'd
        `flush` record (through `metric_logger` when given; a
        `retrace_warning` record beside it when one-time host work ran
        since the last check). Returns the record fields."""
        from ..observability import merge_windows
        self._telemetry()
        window, self.metric_acc = self.metric_acc.flush()
        timing = self.phase_timer.window_summary()
        runtime = self.watchdog.check()
        self._cum_metrics = merge_windows(self._cum_metrics, window)
        self._flush_count += 1
        fields = dict(step=self.step_count, window=window, timing=timing,
                      runtime=runtime)
        self._last_flush_step = self.step_count
        step_t = timing.get('step')
        if step_t and step_t['mean_ms'] > 0:
            # the rate over the steps this window timed (the warmup step
            # is billed to its own phase)
            fields['nodes_steps_per_sec'] = round(
                self._nodes_per_step() / (step_t['mean_ms'] / 1e3), 2)
        if runtime['retraced'] and metric_logger is not None:
            metric_logger.log_record('retrace_warning',
                                     step=self.step_count,
                                     retraced=runtime['retraced'])
        if metric_logger is not None:
            return metric_logger.log_record('flush', **fields)
        return fields

    def telemetry_close(self, metric_logger=None) -> dict:
        """The residual window's flush and the cumulative `summary` record:
        run-wide phase percentiles, the merged metric windows, throughput,
        the first and last loss (the run's only other host syncs) and the
        retrace warnings in all."""
        self._telemetry()
        if self.step_count > self._last_flush_step:
            self.telemetry_flush(metric_logger)
        steps = self.phase_timer.total_count('step')
        total_step_s = self.phase_timer.total_seconds('step')
        fields = dict(
            steps=self.step_count,
            label=self._telemetry_label(),
            metrics=self._cum_metrics or {},
            timing=self.phase_timer.cumulative_summary(),
            retrace_warnings_total=self.watchdog.warnings_total)
        if steps and total_step_s > 0:
            fields['nodes_steps_per_sec'] = round(
                self._nodes_per_step() * steps / total_step_s, 2)
        if self._first_loss is not None:
            first = float(self._first_loss)
            last = float(self._last_loss)
            fields.update(loss_first=round(first, 4),
                          loss_last=round(last, 4),
                          loss_decreased=bool(last < first)
                          and bool(np.isfinite(first))
                          and bool(np.isfinite(last)))
        if metric_logger is not None:
            return metric_logger.log_record('summary', **fields)
        return fields

    def _pipeline_record(self, stats, metric_logger=None) -> dict:
        """One schema'd `pipeline` record of the prefetch stats."""
        fields = dict(stats.snapshot(), step=self.step_count)
        if metric_logger is not None:
            return metric_logger.log_record('pipeline', **fields)
        fields['kind'] = 'pipeline'
        return fields

    # ------------------------------------------------------------------ #
    # the loops
    # ------------------------------------------------------------------ #
    def train(self, num_steps: int, log=print, checkpoint_manager=None,
              checkpoint_every: int = 0, metric_logger=None):
        """JAX's train loop: micro_batches() a step, a checkpoint every
        `checkpoint_every` steps through `checkpoint_manager`, a log record
        every cfg.log_every steps (the only host syncs). With cfg.telemetry
        the log records give way to a `flush` record every
        cfg.flush_every steps and a `summary` at the end (through
        `metric_logger` when given). With cfg.pipeline it is
        train_pipelined. Returns the records."""
        cfg = self._config()
        if cfg.pipeline:
            return self.train_pipelined(
                num_steps, log=log, checkpoint_manager=checkpoint_manager,
                checkpoint_every=checkpoint_every,
                metric_logger=metric_logger)
        telemetry = self.metric_acc is not None
        history = []
        t0 = time.time()
        for i in range(num_steps):
            with self._phase('data'):
                batch = self.micro_batches()
            loss = self.train_step(batch)
            if i == 0:
                # after the first step: the record's step is warm
                self._maybe_cost_record(batch, metric_logger, history)
            if (checkpoint_manager is not None and checkpoint_every > 0
                    and self.step_count % checkpoint_every == 0):
                with self._phase('checkpoint'):
                    checkpoint_manager.save(self.step_count, self._state())
            if telemetry:
                if (i + 1) % cfg.flush_every == 0:
                    history.append(self.telemetry_flush(metric_logger))
            elif (i + 1) % cfg.log_every == 0:
                history.append(self._log_record(loss, i, t0, log))
        if telemetry:
            history.append(self.telemetry_close(metric_logger))
        return history

    def train_pipelined(self, num_steps: int, batch_source=None, log=print,
                        checkpoint_manager=None, checkpoint_every: int = 0,
                        metric_logger=None, async_checkpoint: bool = True):
        """`train` with the host off the critical path: batches built on a
        BatchProducer thread (default source: micro_batches_host; any
        iterator of host batch dicts, e.g. pipeline.dataset_batch_source,
        trains from files), placed cfg.prefetch_depth steps ahead by
        device_prefetch, and checkpoints written by save_async (whose
        snapshot is taken before it returns). Source exhaustion ends
        training early; a source exception propagates. With cfg.telemetry
        the flush records gain `host_wait` and `prefetch` phases and every
        flush writes a `pipeline` record too. The last record is the
        PipelineStats snapshot (hits, stalls, host wait, verdict) as a
        `pipeline` record."""
        from .pipeline import BatchProducer, PipelineStats, device_prefetch
        cfg = self._config()
        telemetry = self.metric_acc is not None
        if batch_source is None:
            batch_source = (self.micro_batches_host()
                            for _ in range(num_steps))
        stats = PipelineStats(depth=cfg.prefetch_depth,
                              capacity=cfg.producer_capacity)
        history = []
        t0 = time.time()
        with BatchProducer(batch_source,
                           capacity=cfg.producer_capacity) as producer:
            stats.bind_source(producer)
            batches = device_prefetch(producer, depth=cfg.prefetch_depth,
                                      device=self.device, stats=stats,
                                      phase_timer=self.phase_timer)
            for i, batch in enumerate(itertools.islice(batches, num_steps)):
                loss = self.train_step(batch)
                if i == 0:
                    self._maybe_cost_record(batch, metric_logger, history)
                if (checkpoint_manager is not None and checkpoint_every > 0
                        and self.step_count % checkpoint_every == 0):
                    with self._phase('checkpoint'):
                        if async_checkpoint:
                            checkpoint_manager.save_async(self.step_count,
                                                          self._state())
                        else:
                            checkpoint_manager.save(self.step_count,
                                                    self._state())
                if telemetry:
                    if (i + 1) % cfg.flush_every == 0:
                        history.append(self.telemetry_flush(metric_logger))
                        history.append(self._pipeline_record(
                            stats, metric_logger))
                elif (i + 1) % cfg.log_every == 0:
                    history.append(self._log_record(
                        loss, i, t0, log, f' [pipelined: {stats.hits} hits '
                        f'{stats.stalls} stalls]'))
        if checkpoint_manager is not None:
            checkpoint_manager.wait_until_finished()
        if telemetry:
            history.append(self.telemetry_close(metric_logger))
        history.append(self._pipeline_record(stats, metric_logger))
        return history

    def train_guarded(self, num_steps: int, checkpoint_manager, guard=None,
                      injector=None, metric_logger=None,
                      restart: bool = False, step_hook=None, log=print):
        """`train` inside the training fault domain (training.guardian's
        run_guarded): window-level non-finite and spike detection off the
        telemetry accumulator (no extra host sync on clean steps), bounded
        rollback to the newest restorable checkpoint with deterministic
        replay, SIGTERM/SIGINT -> one synchronous emergency save and a
        resumable exit, and a schema'd `guard` record. Needs
        cfg.telemetry; honours cfg.pipeline. Returns a GuardResult
        (`.exit_code`: 0 clean, 1 diverged, 75 preempted and
        resumable)."""
        from .guardian import run_guarded
        return run_guarded(self, num_steps, checkpoint_manager, guard=guard,
                           injector=injector, metric_logger=metric_logger,
                           restart=restart, step_hook=step_hook, log=log)
