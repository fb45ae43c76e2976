"""The bucketed inference engine: the port of
se3_transformer_tpu/inference/engine.py.

Requests are padded to fixed bucket lengths, so a deployment sees a
small, known set of shapes. JAX compiles one executable per bucket ahead
of time; the port runs eagerly, and its counterpart is the warmup: one
forward per bucket at construction (`precompile=True`), on a full mask
of seeded chain coordinates, so that every one-time cost a request could
otherwise pay is paid before the first request: the kernel library's
build and load, each kernel's first launch, each device constant
(observability.runtime counts those), the caching allocator's blocks.
`compile_seconds` holds each bucket's warmup wall time, `executables`
the warmed keys `(bucket_len, batch_size, dtype)`, and on a card
`cost_payloads` each bucket's measured `cost` record body
(observability.costs). A warmup that fails raises out of the
constructor. Capturing each bucket's forward as a CUDA graph is work for
a performance PR.

Every `run` ends in a device synchronize inside its bucket's PhaseTimer
phase, so the recorded percentiles are device latencies. With
with_chain_adjacency (the default) every call passes its bucket's chain
adjacency (i and j bonded iff |i - j| == 1) as adj_mat, which a model
without adjacency fields ignores; requests carry no edges.

  * `activation_dtype=torch.bfloat16` rounds the coordinates to bf16 on
    the way in, as JAX casts them; the model then computes in float32 and
    the output is float32 (JAX's bf16 coordinates meet float32 weights
    and flax promotes to float32 at the first such op).
  * `precision='int8_mix'` (or 'fp8_mix', 'bf16', 'fp32', or a
    quant.rules rule list) quantizes the module's parameters on the host
    (quant.quantize_params) before the module moves to the device; None
    and 'fp32' serve the module as it is. A module that is already
    quantized is served as it is, `precision_name` 'prequantized'.
  * `engine.params = state` is the weight swap (and the checkpoint
    refresh): the values of a state dict (the port's names, as
    `module.state_dict()` or `CheckpointManager.restore_params` give
    them) are copied into the placed tensors in place. Nothing is
    rebuilt and no second copy of the model is allocated on the device;
    an engine with a precision mix re-quantizes a float32 state at its
    own mix on the host first (a state already in the engine's form
    passes through); a missing key, a shape or a dtype that differs
    raises before anything is copied.
  * `from_checkpoint(module, dir, step)` restores the params alone
    through `CheckpointManager.restore_params`, with its model-family
    check.

`mesh` and `partition_rules` (ROADMAP A7) and `fault_injector` (ROADMAP
A8) refuse any value but None. `donate_buffers` is accepted and does
nothing: JAX donates the coordinates' device buffer to XLA for reuse;
eagerly, the caching allocator reuses a request's memory as soon as it is
released. `stats()['kernel_tuning']` stays empty until the tuning table
(ROADMAP A6).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..observability import PhaseTimer, cost_payload
from ..quant import (
    is_quantized, mix_name, quantize_params, quantize_state, resolve_mix,
)
from ..utils.graph import chain_adjacency
from ..utils.helpers import resolve_device
from .admission import fit_bucket, oversize_error

# the arguments of the JAX engine that belong to a later ROADMAP item
_UNPORTED = {'mesh': 'ROADMAP A7 (parallelism)',
             'partition_rules': 'ROADMAP A7 (parallelism)',
             'fault_injector': 'ROADMAP A8 (fleet and observability)'}


def bucket_phase(bucket: int) -> str:
    """The PhaseTimer phase name for a bucket's execute latency."""
    return f'bucket_{bucket}'


def pad_to_bucket(feat_seqs, coord_seqs, bucket_len: int,
                  batch_size: Optional[int] = None):
    """Ragged (feats [n_i, d], coords [n_i, 3]) sequences -> feats
    [B, bucket_len, d] / coords [B, bucket_len, 3] float32 zero-padded, and
    mask [B, bucket_len]; sequences longer than the bucket are truncated,
    and all-padding rows fill the batch up to `batch_size`. Integer token
    sequences [n_i] (a num_tokens model) pad to tokens [B, bucket_len]
    int64 with token 0, as the JAX package pads them."""
    count = len(feat_seqs)
    B = count if batch_size is None else batch_size
    if count > B:
        raise ValueError(f'{count} sequences do not fit a batch of {B}')
    first = np.asarray(feat_seqs[0])
    tokens = first.ndim == 1 and np.issubdtype(first.dtype, np.integer)
    dtype = np.int64 if tokens else np.float32
    feats = np.zeros((B, bucket_len) + first.shape[1:], dtype)
    coords = np.zeros((B, bucket_len, 3), np.float32)
    mask = np.zeros((B, bucket_len), bool)
    for i, (f, c) in enumerate(zip(feat_seqs, coord_seqs)):
        f = np.asarray(f, dtype)[:bucket_len]
        c = np.asarray(c, np.float32).reshape(-1, 3)[:bucket_len]
        feats[i, :len(f)] = f
        coords[i, :len(c)] = c
        mask[i, :len(f)] = True
    return feats, coords, mask


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class InferenceEngine:
    """Answer fixed-shape padded batches with a model placed on one device.

        engine = InferenceEngine(flagship_fast(), buckets=(256, 1024))
        out = engine.predict(feats, coords)            # one request
        out = engine.run(1024, feats, coords, mask)    # a padded batch
        engine = InferenceEngine.from_checkpoint(module, '/ckpts/run1',
                                                 buckets=(64, 128))

    feats are float features [n, d], or integer tokens [n] for a
    num_tokens model. `run` is the `MicroBatcher` runner; `predict` pads
    one request to the smallest fitting bucket. `return_type` is the
    output degree the module returns (1 by default, as in the JAX engine;
    a module with one output degree returns degree 0 whatever it is).
    `apply_kwargs` are passed to every forward. The module docstring has
    the rest.
    """

    def __init__(self, module: torch.nn.Module, *,
                 buckets: Sequence[int] = (64, 128, 256, 512),
                 batch_size: int = 1, return_type: int = 1,
                 activation_dtype: Optional[torch.dtype] = None,
                 with_chain_adjacency: bool = True,
                 donate_buffers: Optional[bool] = None,
                 apply_kwargs: Optional[dict] = None,
                 timer: Optional[PhaseTimer] = None,
                 mesh=None, partition_rules=None, precision=None,
                 precompile: bool = True, fault_injector=None,
                 device='cuda'):
        for name, value in (('mesh', mesh),
                            ('partition_rules', partition_rules),
                            ('fault_injector', fault_injector)):
            if value is not None:
                raise ValueError(f'InferenceEngine({name}=...): its '
                                 f'machinery is not ported '
                                 f'({_UNPORTED[name]})')
        if activation_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f'activation_dtype {activation_dtype} is not '
                             f'float32 or bfloat16')
        self.device = resolve_device(device)
        self.model_family = getattr(module, 'model_family', 'se3_v1')
        self.return_type = return_type
        self.activation_dtype = None if activation_dtype == torch.float32 \
            else activation_dtype
        # does nothing eagerly (module docstring)
        self.donate_buffers = bool(donate_buffers)
        self.apply_kwargs = dict(apply_kwargs or {})
        # None and 'fp32' serve the module as it is, as in JAX: precision
        # 'fp32', no quant_report
        self.precision = None if precision in (None, 'fp32') else precision
        self.precision_name = 'fp32'
        self.quant_report = None
        if self.precision is not None:
            resolve_mix(self.precision)
        if is_quantized(module):
            # served as it is: its mix is not known here
            self.precision_name = 'prequantized'
        elif self.precision is not None:
            self.precision_name = mix_name(self.precision)
            module, self.quant_report = quantize_params(module,
                                                        self.precision)
        self.module = module.to(self.device).eval()
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets:
            raise ValueError('no buckets')
        self.batch_size = int(batch_size)
        self.adjacency = {b: torch.as_tensor(chain_adjacency(b),
                                             device=self.device)
                          for b in self.buckets} \
            if with_chain_adjacency else None
        self.timer = timer if timer is not None else PhaseTimer()
        self._executables: Set[Tuple[int, int, str]] = set()
        self.compile_seconds: Dict[Tuple[int, int, str], float] = {}
        self.cost_payloads: Dict[Tuple[int, int, str], dict] = {}
        self.batches_served = {b: 0 for b in self.buckets}
        self.rows_served = {b: 0 for b in self.buckets}
        if precompile:
            self.warmup()

    # ------------------------------------------------------------------ #
    @classmethod
    def from_checkpoint(cls, module, checkpoint_dir: str,
                        step: Optional[int] = None, **kwargs
                        ) -> 'InferenceEngine':
        """Params-only restore (`CheckpointManager.restore_params`): the
        optimizer state is dropped on the host. The module's
        `model_family` rides into the manager, so a checkpoint of another
        family fails with ModelFamilyMismatch before any tensor is read."""
        from ..training.checkpoint import CheckpointManager
        params = CheckpointManager(
            checkpoint_dir,
            model_family=getattr(module, 'model_family', None),
        ).restore_params(step)
        precompile = kwargs.pop('precompile', True)
        engine = cls(module, precompile=False, **kwargs)
        engine.params = params
        if precompile:
            engine.warmup()
        return engine

    # ------------------------------------------------------------------ #
    @property
    def params(self) -> dict:
        """The placed module's state dict (live tensors)."""
        return self.module.state_dict()

    @params.setter
    def params(self, state):
        if self.precision_name != 'fp32':
            state = quantize_state(self.module, state)
        own = self.module.state_dict()
        missing = sorted(set(own) - set(state))
        extra = sorted(set(state) - set(own))
        if missing or extra:
            raise ValueError(f'weight swap: the state lacks {missing[:8]} '
                             f'and has unknown {extra[:8]}')
        values = {}
        for key, placed in own.items():
            value = state[key]
            if not isinstance(value, torch.Tensor):
                value = torch.as_tensor(np.asarray(value))
            if value.shape != placed.shape or value.dtype != placed.dtype:
                raise ValueError(
                    f'weight swap: {key} is {tuple(value.shape)} '
                    f'{value.dtype}, the engine holds '
                    f'{tuple(placed.shape)} {placed.dtype}')
            values[key] = value
        with torch.no_grad():
            for key, placed in own.items():
                placed.copy_(values[key])

    @property
    def dtype_name(self) -> str:
        return 'bfloat16' if self.activation_dtype is not None \
            else 'float32'

    def _key(self, bucket: int) -> Tuple[int, int, str]:
        # the precision mix folds into the key's dtype slot, as in JAX (the
        # bucket stays slot 0: telemetry reads key[0])
        dt = self.dtype_name
        if self.precision is not None:
            dt = f'{dt}+{self.precision_name}'
        return (int(bucket), self.batch_size, dt)

    @property
    def executables(self) -> Set[Tuple[int, int, str]]:
        """The warmed keys."""
        return set(self._executables)

    # ------------------------------------------------------------------ #
    def _warmup_batch(self, bucket: int):
        """A full batch at the bucket's shape: every row a full mask of
        seeded chain coordinates (unit steps x 1.5, centred), with seeded
        tokens or features."""
        rng = np.random.RandomState(bucket)
        B = self.batch_size
        steps = rng.normal(size=(B, bucket, 3))
        steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
        coords = np.cumsum(1.5 * steps, axis=1)
        coords = (coords - coords.mean(axis=1, keepdims=True)) \
            .astype(np.float32)
        emb = getattr(self.module, 'token_emb', None)
        if emb is not None:
            feats = rng.randint(0, emb.num_embeddings, size=(B, bucket))
        else:
            feats = rng.normal(size=(B, bucket, self.module.fiber_in[0])) \
                .astype(np.float32)
        return feats, coords, np.ones((B, bucket), bool)

    def _place(self, bucket: int, feats, coords, mask):
        expect = (self.batch_size, bucket)
        feats = torch.as_tensor(feats)
        feats = feats.to(self.device, torch.float32 if
                         feats.is_floating_point() else torch.int64)
        coords = torch.as_tensor(coords, dtype=torch.float32,
                                 device=self.device)
        if self.activation_dtype is not None:
            coords = coords.to(self.activation_dtype).float()
        mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        for name, t in (('feats', feats), ('coords', coords), ('mask', mask)):
            if tuple(t.shape[:2]) != expect:
                raise ValueError(f'{name} has shape {tuple(t.shape)}; the '
                                 f'bucket takes {expect}')
        return feats, coords, mask

    def _forward(self, bucket: int, feats, coords, mask) -> torch.Tensor:
        adj_mat = None if self.adjacency is None else self.adjacency[bucket]
        with torch.inference_mode():
            return self.module(feats, coords, mask, adj_mat=adj_mat,
                               return_type=self.return_type,
                               **self.apply_kwargs)

    def compile_bucket(self, bucket: int) -> None:
        """Warm one bucket (idempotent): one forward of its shape, its wall
        time in `compile_seconds`, and on a card its measured `cost`
        record body in `cost_payloads`."""
        key = self._key(bucket)
        if key in self._executables:
            return
        if bucket not in self.buckets:
            raise ValueError(f'{bucket} is not a configured bucket')
        cuda = self.device.type == 'cuda'
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            base = torch.cuda.memory_allocated(self.device)
        t0 = time.perf_counter()
        inputs = self._place(bucket, *self._warmup_batch(bucket))
        out = self._forward(bucket, *inputs)
        if cuda:
            torch.cuda.synchronize(self.device)
        self.compile_seconds[key] = round(time.perf_counter() - t0, 3)
        self._executables.add(key)
        if cuda:
            state = _nbytes([*self.module.parameters(),
                             *self.module.buffers()])
            args = state + _nbytes(inputs) + (
                _nbytes([self.adjacency[bucket]]) if self.adjacency else 0)
            body = cost_payload(
                label=f'bucket_{bucket},b={self.batch_size},'
                      f'dtype={self.dtype_name},'
                      f'precision={self.precision_name}',
                argument_bytes=args, output_bytes=_nbytes([out]),
                peak_bytes=torch.cuda.max_memory_allocated(self.device)
                - base + state)
            body['precision_mix'] = self.precision_name
            if self.quant_report is not None:
                body['quant'] = dict(self.quant_report)
            self.cost_payloads[key] = body

    def warmup(self) -> Dict[Tuple[int, int, str], float]:
        """Warm every bucket; returns each key's warmup seconds. Arm a
        RetraceWatchdog after it: a healthy engine then sets off no more
        one-time work."""
        for b in self.buckets:
            self.compile_bucket(b)
        return dict(self.compile_seconds)

    # ------------------------------------------------------------------ #
    def bucket_for(self, length: int) -> Optional[int]:
        return fit_bucket(self.buckets, length)

    @property
    def max_len(self) -> int:
        return self.buckets[-1]

    def run(self, bucket: int, feats, coords, mask) -> torch.Tensor:
        """One padded batch: feats [B, bucket, d] (or tokens [B, bucket]),
        coords [B, bucket, 3], mask [B, bucket] -> the module's output of
        degree `return_type` on the engine's device, float32. Returns after
        the device has finished; the bucket's phase times the forward and
        that synchronize (the inputs are placed before it)."""
        if bucket not in self.buckets:
            raise ValueError(f'{bucket} is not a configured bucket')
        if self._key(bucket) not in self._executables:
            self.compile_bucket(bucket)
        inputs = self._place(bucket, feats, coords, mask)
        with self.timer.phase(bucket_phase(bucket), device=self.device):
            out = self._forward(bucket, *inputs)
        self.batches_served[bucket] += 1
        self.rows_served[bucket] += int(np.asarray(mask).any(-1).sum())
        return out.float()

    def predict(self, feats, coords) -> np.ndarray:
        """One request end to end: pad to the smallest fitting bucket, run,
        return only the real rows as a numpy array. Longer than the largest
        bucket: RequestRejected('oversize')."""
        length = len(feats)
        bucket = self.bucket_for(length)
        if bucket is None:
            raise oversize_error(length, self.max_len)
        f, c, m = pad_to_bucket([feats], [coords], bucket,
                                batch_size=self.batch_size)
        out = self.run(bucket, f, c, m)
        return out[0, :length].cpu().numpy()

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        """Engine-side counters for the serve telemetry record (JAX's
        keys, and the device)."""
        return dict(
            device=str(self.device), buckets=list(self.buckets),
            batch_size=self.batch_size, dtype=self.dtype_name,
            sharding=None, precision=self.precision_name,
            model_family=self.model_family,
            quant=(dict(self.quant_report)
                   if self.quant_report is not None else None),
            executables=[list(k) for k in sorted(self._executables)],
            compile_seconds={str(k[0]): v
                             for k, v in self.compile_seconds.items()},
            batches_served={str(b): n
                            for b, n in self.batches_served.items() if n},
            rows_served={str(b): n
                         for b, n in self.rows_served.items() if n},
            # measured on a card (observability.costs); empty on the CPU
            peak_hbm_by_bucket={str(k[0]): v['peak_bytes']
                                for k, v in self.cost_payloads.items()},
            kernel_tuning=[])
