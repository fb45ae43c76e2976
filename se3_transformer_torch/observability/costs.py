"""The per-bucket cost ledger: the `cost` record body of one warmed
bucket, the port of se3_transformer_tpu/observability/costs.py.

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

On the CPU there is no allocator peak to read, and the port writes no
cost record rather than a zero one (JAX refuses a zero-memory record for
the same reason). A single card has no collectives: the ledger is empty.
"""
from __future__ import annotations


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
