"""The cost ledger: the `cost` record body of one warmed bucket
(cost_payload) or of one training step (step_cost_payload), the port of
se3_transformer_tpu/observability/costs.py.

JAX reads a compiled executable's static analysis (XLA's flops and its
argument/output/temp memory split). An eager forward has no such
analysis, so the port measures its one warmup forward on the card
instead:

  * `peak_bytes` is the card's measured peak over that forward
    (`torch.cuda.reset_peak_memory_stats` / `max_memory_allocated`),
    counted from the memory in use before it with the module's own
    parameter and buffer bytes added: what the bucket needs on its own;
  * `memory.argument_bytes` is those parameters and buffers plus the
    bucket's inputs, `memory.output_bytes` the output, both from tensor
    sizes; `memory.temp_bytes` is the rest of the peak;
  * `source` is 'unavailable' and `flops` and `bytes_accessed` are None:
    nothing here is XLA's cost analysis or an estimate of it, and a count
    of the PyTorch ops' flops would miss the hand-written kernels, which
    do most of the work (as JAX's count misses Pallas).

A training step's record (step_cost_payload) is measured the same way
over one warm step: the allocator's peak over the step, its argument
bytes the parameters, the optimizer state and the batch, its output the
loss. Its `source` stays 'unavailable' and `flops` None (JAX's
cost.source names XLA's analysis or an HLO estimate only); the analytic
FLOP count of the step (utils.flops) rides the `profile` record's
roofline instead.

On the CPU there is no allocator peak to read, and the port writes no
cost record rather than a zero one (JAX refuses a zero-memory record for
the same reason). A single card has no collectives: the ledger is empty.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch


def nbytes(tensors: Iterable[torch.Tensor]) -> int:
    """The bytes of the tensors' elements."""
    return sum(t.numel() * t.element_size() for t in tensors)


def cost_payload(*, label: str, argument_bytes: int, output_bytes: int,
                 peak_bytes: int) -> dict:
    """The schema'd `cost` record body (kind='cost', minus run_id) of one
    measured bucket forward."""
    argument_bytes, output_bytes = int(argument_bytes), int(output_bytes)
    peak = max(int(peak_bytes), argument_bytes + output_bytes)
    return dict(label=label, source='unavailable', flops=None,
                bytes_accessed=None,
                memory=dict(argument_bytes=argument_bytes,
                            output_bytes=output_bytes,
                            temp_bytes=peak - argument_bytes - output_bytes),
                peak_bytes=peak, collectives={})


def step_cost_payload(step: Callable[[], torch.Tensor], *, label: str,
                      state: Iterable[torch.Tensor],
                      batch: Iterable[torch.Tensor], device) -> dict:
    """The `cost` record body of one training step: runs `step()` once on
    the card `device` under the allocator's peak. `state` is the
    parameters and the optimizer state, `batch` the step's inputs (their
    bytes are the argument bytes); the step's return value is its
    output."""
    device = torch.device(device)
    if device.type != 'cuda':
        raise ValueError(f'a cost record measures the allocator peak of a '
                         f'card; {device} has none')
    args = nbytes(state) + nbytes(batch)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    out = step()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base + args
    return cost_payload(label=label, argument_bytes=args,
                        output_bytes=nbytes([out]), peak_bytes=peak)
