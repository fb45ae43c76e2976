"""A minimal bucketed inference engine: the port of
se3_transformer_tpu/inference/engine.py's serving surface.

Requests are padded to fixed bucket lengths (so a deployment sees a small,
known set of shapes), parameters are placed on the device once at
construction, and every call ends in a device synchronize so the recorded
latencies are the device's. With with_chain_adjacency (the default, as in
the JAX engine) every call passes its bucket's chain adjacency (i and j
bonded iff |i - j| == 1) as adj_mat, which a model without adjacency
fields ignores; requests carry no edges.

Quantized serving: `precision='int8_mix'` (or 'fp8_mix', 'bf16', 'fp32',
or an explicit quant.rules rule list) quantizes the module's parameters on
the host (quant.quantize_params) before it is moved to the device, so a
module built on the CPU never has its float32 weights in device memory;
`precision_name` and `quant_report` keep the mix and its report; None and
'fp32' serve the module as it is (`precision_name` 'fp32', no report). A
module
that is already quantized is served as it is, with `precision_name`
'prequantized' and no report. Ahead-of-time capture,
weight swaps, meshes and telemetry are not ported yet.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from ..quant import is_quantized, mix_name, quantize_params, resolve_mix
from ..utils.graph import chain_adjacency
from ..utils.helpers import resolve_device


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


class InferenceEngine:
    """Answer fixed-shape padded batches with a model placed on one device.

        engine = InferenceEngine(flagship_fast(), buckets=(256, 1024))
        out = engine.predict(feats, coords)            # one request
        out = engine.run(1024, feats, coords, mask)    # a padded batch

    feats are float features [n, d], or integer tokens [n] for a
    num_tokens model. `return_type` is the output degree the module
    returns (1 by default, as in the JAX engine; a module with one output
    degree returns degree 0 whatever it is). `precision` (None: the module
    as it is) is a quant mix name or rule list: the module is quantized in
    place on the host before it is placed (module docstring); an unknown
    mix raises here.
    """

    def __init__(self, module: torch.nn.Module, *,
                 buckets: Sequence[int] = (64, 128, 256, 512),
                 batch_size: int = 1, return_type: int = 1,
                 with_chain_adjacency: bool = True, device='cuda',
                 precision=None):
        self.device = resolve_device(device)
        self.return_type = return_type
        # None and 'fp32' serve the module as it is, as in JAX: precision
        # 'fp32', no quant_report
        self.precision_name = 'fp32'
        self.quant_report = None
        if precision == 'fp32':
            precision = None
        if precision is not None:
            resolve_mix(precision)
        if is_quantized(module):
            # served as it is: its mix is not known here
            self.precision_name = 'prequantized'
        elif precision is not None:
            self.precision_name = mix_name(precision)
            module, self.quant_report = quantize_params(module, precision)
        self.module = module.to(self.device).eval()
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets:
            raise ValueError('no buckets')
        self.batch_size = int(batch_size)
        self.adjacency = {b: torch.as_tensor(chain_adjacency(b),
                                             device=self.device)
                          for b in self.buckets} \
            if with_chain_adjacency else None
        self.batches_served = {b: 0 for b in self.buckets}
        self.rows_served = {b: 0 for b in self.buckets}
        # the most recent latencies per bucket (bounded for long runs)
        self.latency_s = {b: deque(maxlen=4096) for b in self.buckets}

    def bucket_for(self, length: int) -> Optional[int]:
        return next((b for b in self.buckets if b >= length), None)

    def run(self, bucket: int, feats, coords, mask) -> torch.Tensor:
        """One padded batch: feats [B, bucket, d] (or tokens [B, bucket]),
        coords [B, bucket, 3], mask [B, bucket] -> the module's output of
        degree `return_type` on the engine's device.
        Returns after the device has finished; the recorded latency runs
        from the host-to-device copies to that synchronize."""
        if bucket not in self.buckets:
            raise ValueError(f'{bucket} is not a configured bucket')
        expect = (self.batch_size, bucket)
        t0 = time.perf_counter()
        feats = torch.as_tensor(feats)
        feats = feats.to(self.device, torch.float32 if
                         feats.is_floating_point() else torch.int64)
        coords = torch.as_tensor(coords, dtype=torch.float32,
                                 device=self.device)
        mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        for name, t in (('feats', feats), ('coords', coords), ('mask', mask)):
            if tuple(t.shape[:2]) != expect:
                raise ValueError(f'{name} has shape {tuple(t.shape)}; the '
                                 f'bucket takes {expect}')
        adj_mat = None if self.adjacency is None else self.adjacency[bucket]
        with torch.inference_mode():
            out = self.module(feats, coords, mask, adj_mat=adj_mat,
                              return_type=self.return_type)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.latency_s[bucket].append(time.perf_counter() - t0)
        self.batches_served[bucket] += 1
        self.rows_served[bucket] += int(mask.any(-1).sum())
        return out

    def predict(self, feats, coords) -> np.ndarray:
        """One request end to end: pad to the smallest fitting bucket, run,
        return only the real rows as a numpy array."""
        length = len(feats)
        bucket = self.bucket_for(length)
        if bucket is None:
            raise ValueError(f'request of {length} nodes exceeds the largest '
                             f'bucket ({self.buckets[-1]})')
        f, c, m = pad_to_bucket([feats], [coords], bucket,
                                batch_size=self.batch_size)
        out = self.run(bucket, f, c, m)
        return out[0, :length].float().cpu().numpy()

    def stats(self) -> dict:
        def ms(values, q):
            return float(np.percentile(list(values), q) * 1e3) if values \
                else None
        return dict(
            device=str(self.device), buckets=list(self.buckets),
            batch_size=self.batch_size, precision=self.precision_name,
            quant=self.quant_report,
            batches_served={str(b): n for b, n in self.batches_served.items()
                            if n},
            rows_served={str(b): n for b, n in self.rows_served.items() if n},
            latency_ms_p50={str(b): ms(v, 50) for b, v in
                            self.latency_s.items() if v},
            latency_ms_max={str(b): ms(v, 100) for b, v in
                            self.latency_s.items() if v})
