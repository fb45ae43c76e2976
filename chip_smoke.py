#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (se3_transformer_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). Phases, each fatal on
failure:

  1. device   require CUDA; print the card's name and power limit; TF32 off.
  2. build    compile every kernel of the port from csrc/ with nvcc (sm_90a),
              one nvcc per source, all started together.
  3. kernels  hold each forward kernel against its plain PyTorch version on
              the card and time both: the basis-fused kernel (bxf) at the 16
              flagship_fast pairs, the V2-given kernel (fwd) at the four
              grouped output degrees of a flagship hidden conv, E = 4096 (one
              node chunk) and 32768, float32 and bf16; beside each, the time
              of the one PyTorch call that computes the same conv from V2
              (einsum('em,mio,epi->epo') with b3 as a row of W3), timed
              only.
  4. backward hold backward kernels A (dV2, dW3, dB3) and B (dH) against
              their plain versions at both flagship recipes' training shapes
              and af2_refinement's (O = 192: three O tiles, each O-tile
              design held and timed), time each (and the autograd backward
              of the same einsum, timed only), and require dW3/dB3 to be
              bit-identical across two runs. molecular: #3, A and B at
              molecular_edges' kv-conv pairs (C 32, O 192, float32) at
              E = 768 (n 128, K 6) and 762 (a ragged last edge tile),
              held and timed.
  narrow      the narrow-O arms of #3, A and B (csrc/pairwise_narrow.cuh:
              O = 8, 16, 32) at the DenoiseConfig trainer's six shapes (E =
              768, IF 8 or 24) and at af2_refinement's and molecular_edges'
              O = 32 pairs, each against its plain version within
              NARROW_RTOL and the same bits on a repeat; at the six shapes
              and af2's largest pair timed by run_ms beside the plain
              version, the library einsum (and its autograd), the bound
              (the radial product on the tensor cores) and the bound of
              every product on float32 FMAs (`narrow` lines; a
              `narrow_step` line weighs the six shapes by one step's
              launches).
  5. attention  the fused attention kernels (#5 forward, #6 backward)
              against their plain versions at the flagship's four per-degree
              shapes (B*h 8, n 1024, J 33, D 8..56, masked), the backward's
              bits over two runs, and the time of the one PyTorch call that
              computes the same function (scaled_dot_product_attention,
              query length 1, boolean mask; forward, and its backward),
              timed only; all of these by device time per launch over a
              run of launches on operand sets cold in L2 (run_ms), beside
              one call's time (call_ms_*); the streaming kNN attention kernel (#7) against
              its plain version at the four flagship_fast output degrees;
              the global attention kernel (7g) against its plain stream at
              the assembly model's served shapes (n 4096, the last 57
              nodes masked, two prefix slots, d_out 0 and 1). The tied
              variants (tie_key_values: one conv pass, or one trunk and one
              radial product, a tile) of #7 at the four flagship_fast
              degrees with the [null, self] prefix and of 7g at the
              assembly shapes, each against its tied plain stream and
              timed beside the untied kernel on the same operands.
              The scaled arms (quantized serving): #3's at the flagship
              unit (int8 and fp8 with float32 h, int8 with bf16 h) and
              #7's at the flagship_fast block (int8 and fp8, dense and
              so2, untied and tied), each within QUANT_RTOL of its plain
              version, timed beside the float arm on the dequantized
              weights (`fwd_q`, `flash_q` lines).
  conv_bf16   the bf16-storage arms (conv_bf16: the equivariant operand
              stored bf16, upcast exactly where it is used): #1's at the 16
              flagship_fast pairs (E = 32768, bf16 h; #2's structured basis
              the same bits), #3's at the flagship's four output degrees
              and A's and B's at its grouped training shapes (float32 h, E
              = 4096 and 32768), each within KERNEL_RTOL of its plain
              version on the same bf16 operands and the same bits on a
              repeat, timed beside the float32 arm on the upcast operands,
              its bound counting 2-byte operands, the plain version's and
              the library einsum's times (`kernel_v16`, `fwd_v16`,
              `backward_v16` lines).
  tune        the block-config table's tuner (kernels/tune.py) in-process
              over af2_refinement's step (n 1024) in a temporary
              SE3_TORCH_CACHE_PATH: the step's #3 picks (wide O = 192 and
              narrow O = 32), every admissible i split at each forced onto
              a launch and held against the plain version (KERNEL_RTOL,
              `tune_split` lines, timed alone); then the tuner once at
              JAX's tune-smoke settings (margin -1, 1 target, 1 candidate,
              1 pair of 2 steps; the measured candidate wins): schema-valid
              `tune` records ending 'promoted', 'consulted', no table left
              behind.
  profile     per-scope device time (observability.profiling, device
              events only) of one flagship_fast request at bucket 1024 and
              one training step (n 1024, vector head), both at DEPTH:
              `profile_record` lines (the MODEL_SCOPES shares, coverage,
              the top unattributed ops, the roofline of utils.flops'
              analytic FLOPs against the card's bf16 peak), the warm
              trainer's `cost_record` line (training left as it was), a
              schema-valid stream, the request's coverage at least
              PROFILE_COVERAGE, the engine's kernel_tuning non-empty; a
              `roofline` line with the card's name and power limit.
  bx          kernel #2's path: a hidden ConvSE3 of flagship_fast given
              the structured basis at E = 32768, exactly 16 launches of #2;
              the conv against the flat basis through #1 (the same bits),
              its 16 pair contractions and one backward against their
              plain versions.
  serve_stream  the serving stack (AdmissionController -> MicroBatcher ->
              InferenceEngine.run under ServeTelemetry and a MetricLogger
              writing JSONL) over STREAM_REQUESTS requests whose lengths
              cycle across the buckets and one oversize request, which
              must be rejected: flagship_fast (dim 64, DEPTH, seeded and
              conditioned weights) at buckets (512, 1024), batch 1, with a
              weight swap to a second seeded state after half the stream;
              af2_refinement (dim 32, depth 2) on an N/CA/C backbone at
              buckets (256, 512, 1024), batch 2. Every admitted request
              answered and equal to the same request served alone by
              predict; post_warmup_compiles 0; the stream valid under the
              port's schema; exactly the per-request launch counts of the
              serve paths per batch, nothing routed; after the swap the
              answers of a fresh engine on that state, bit for bit, and
              peak memory growth under half the parameter bytes. Prints
              warmup seconds and measured peak bytes per bucket,
              p50/p95/p99 per bucket, queue wait, batch fill, launches per
              batch and per request, a profiled batch's busy and idle
              share (`serve_stream` lines).
  serve_cli   `python -m se3_transformer_torch.inference.serve` at its
              defaults in a subprocess: exit 0, a schema-valid stream, no
              one-time work after warmup (`serve_cli` line); the same
              entry with `--replicas 2 --async-dispatch --swap-at 4`
              (exit 0, a swap on both replicas; `serve_cli_multi` line);
              both arms of `python -m se3_transformer_torch.serving.chaos`
              (the clean arm exits 0, `--weaken drop` exits 1; `chaos`
              lines); these three run at once.
  serve_multi  flagship_fast (dim 64, DEPTH, seeded and conditioned) at
              buckets (512, 1024), batch 1, as replicas behind
              serving.Router, each over its own copy of the module, one
              shared PhaseTimer, RouterTelemetry writing JSONL: the same
              MULTI_REQUESTS-request stream (and one oversize request)
              through one replica, two sync replicas, two async replicas
              (each on its own dispatch thread and CUDA stream), and two
              async replicas with a rolling swap to a second seeded state
              after MULTI_SWAP_AT admitted requests, as many requests in
              flight as replicas. Every answer equal to the request alone
              through one engine on the state in effect; no one-time work
              after warmup; a schema-valid stream; the serve path's
              launches per batch, nothing routed; each replica's swap
              under half its parameter bytes of peak growth; replica 1's
              weights bit for bit the old ones after replica 0's swap.
              Prints requests/s, per-bucket p50/p95/p99 of the forward,
              request latency, served rows per replica, warmup seconds and
              peak bytes per replica, the swap's wall time and a profiled
              async pair's device busy (union of the two streams) and idle
              share (`serve_multi` lines).
  global serve  the assembly model (attention_mode='global', seeded and
              conditioned weights), untied and with tie_key_values, served
              by InferenceEngine at bucket 4096 with return_type=1 on
              requests of 4096, 4039 and 3000 nodes: per request latency,
              device busy and idle share, host syncs, peak memory, exactly
              2 launches of 7g and none of any other kernel; rotation
              equivariance of the vector output.
  6. serve    each path's forward (dim=64, depth=DEPTH, 4 degrees, 8
              heads, k=32, random seeded weights; the tie, so2, quant and
              conv_bf16 variants at VARIANT_DEPTH) served by InferenceEngine
              at bucket 1024: finite outputs, exactly the counted kernel
              launches per request (at DEPTH 4: flagship_fast: 136 bxf;
              with pallas_attention=True, at VARIANT_DEPTH 2, 72 bxf and 8
              fused-attention forwards; with fuse_pairwise=True 8 bxf and
              16 streaming attentions, and 8 bxf and 8 tied ones with
              tie_key_values and use_null_kv at VARIANT_DEPTH 2 (#7's
              tied variant, the [null, self] prefix); flagship: 296 fwd,
              no bxf),
              rotation invariance of the scalar
              output; af2_refinement (dim 32, depth 2, degrees 0 and 1, k 12,
              a radial trunk per pair) on requests of 32 features: 16 fwd
              and 6 by #3's narrow-O arm (conv_in's and conv_out's O = 32
              pairs) per request, nothing routed, equivariance of its
              vector output.
              Quantized, at VARIANT_DEPTH 2:
              flagship(precision='int8_mix') (168 #3 launches a request,
              all by the scaled arm) and
              flagship_fast(fuse_pairwise=True, precision='fp8_mix') (8
              scaled #7, 8 #1 on the transient dequant), each built on
              the host and quantized by the engine before it is placed:
              the device parameter bytes against the same weights in
              float32 (at most QUANT_MAX_BYTES_RATIO; `quant_placed`),
              and a `quant_serve` line.
              molecular_edges (dim 32, depth 2, edge tokens, the 2-hop
              chain adjacency, bonded neighbors only, K 6) called with
              adj_mat and edges at n = 128: three forwards (all atoms;
              the last 28 masked; rotated in float64 on the host), 16
              launches of #3 and 4 of its narrow-O arm (conv_in's and
              conv_out's O = 32 pairs) each, invariance of its scalar
              output, a profiled forward.
              conv_bf16, at VARIANT_DEPTH 2: flagship_fast(conv_bf16=True)
              (72 #1 a request,
              all by the bf16 basis/x arm) and flagship(conv_bf16=True)
              (168 #3, all by the bf16-V2 arm), invariance within
              ROTATION_RTOL. egnn_stress (the EGNN backbone,
              dim 16, depth 12, k 16) at bucket EGNN_N = 512, return_type 1
              ([n, 16, 3]): 2 launches of #3's narrow-O arm a forward
              (conv_in's O = 16 pairs), equivariance, busy, idle share and
              peak memory (`egnn_serve`).
  7. train    the denoise training step (the vector head: output_degrees=2,
              reduce_dim_out=True) at n=1024 with Adam, for flagship_fast,
              flagship_fast(pallas_attention=True) and flagship: finite
              decreasing losses, finite gradients, exactly the counted
              launches per step (at DEPTH 4: flagship_fast,
              save_conv_outputs: 140 forward, 136 + 136 backward, 268
              forward under remat_policy None; with pallas_attention, at
              VARIANT_DEPTH 2, 76 forward, 72 + 72 backward, 16 attention
              forwards (the checkpoint replay recomputes them) and 8
              backwards; with tie_key_values (no to_k convs, at
              VARIANT_DEPTH 2) 44 forward, 40 + 40 backward; flagship, no
              policy: 560 forward, 296 + 296 backward, 304 forward under
              save_conv_outputs;
              af2_refinement: 16 + 6 narrow fwd, 16 + 4 narrow A and as
              many B; molecular_edges: property_loss on its pooled scalar
              head, 16 + 4 narrow fwd, 16 + 4 narrow A and B;
              at VARIANT_DEPTH 2, flagship_fast(conv_bf16): 76
              #1 by the bf16 arm, 72 + 72 A and B by the float32 arm;
              flagship(conv_bf16): 304 #3, 168 + 168 A and B, all by the
              bf16-V2 arm; egnn_stress at n = 512 on
              scripts/run_baselines.py's objective, the mean square of its
              degree-1 output: 2 narrow fwd, 2 + 2 narrow A and B), step
              time, nodes*steps/s, peak memory and a profile. After the
              flagship_fast steps, a checkpoint round trip of its state
              (`checkpoint`: save_async, an in-place step while it writes,
              the saved state bit for bit, a fresh trainer restored from it
              taking that step to the same loss).
  denoise     the JAX trainer's path: DenoiseTrainer(DenoiseConfig(
              accum_steps=16)) (96 nodes, batch 1, 2 degrees) for
              DENOISE_STEPS steps, every contraction on the narrow-O arms
              (352 #3, 320 + 320 A and B a step, nothing routed), a
              save_async checkpoint after step 5 restored into a fresh
              trainer whose next loss is the uninterrupted run's, median
              step time, nodes*steps/s, busy and idle share
              (`denoise_train`); then the sidechainnet fixture converted
              and trained from through dataset_batch_source, the
              BatchProducer and device_prefetch for 5 steps with async
              checkpoints, the PipelineStats snapshot
              (`denoise_pipelined`); then the guarded loop
              (training.guardian) over DenoiseConfig(accum_steps=4,
              telemetry=True, flush_every=2, pipeline=True), 8 steps an
              arm: two uninterrupted controls; a weakened arm (no
              rollback, a NaN batch) that must exit 1; a chaos arm in a
              subprocess (`chip_smoke.py --guarded-worker DIR`: a NaN
              batch and a failing dispatch, each rolled back and
              replayed) sent SIGTERM mid-run, which must exit 75; the CLI
              (`--guarded`) resuming it to exit 0 on the control's
              parameters (bit for bit, or within twice the controls'
              spread), a cumulative guard record, a valid stream, no
              one-time work after its first step; 88 #3, 80 + 80 A and B
              narrow launches a step, the poisoned and replayed steps
              too; no host sync in a clean telemetry step, one in a
              flush (`denoise_guarded`).
  route       C1's repair: models past the kernels' limits (the JAX
              DenoiseConfig widths, dim 8, heads 2, dim_head 8, two
              degrees; and with fuse_pairwise, heads * dim_head = 16,
              also with one kv head) served on the card: every pairwise
              (and streaming attention) call routed to its plain version,
              counted in the wrappers'
              .routed, warned, no kernel launched, and the output within
              REF_RTOL_F32 of the same model on the CPU. A ConvSE3 of
              128 channels (O = 128, two O tiles): without grad it launches
              #1 / #3, with grad kernels A and B too, routing nothing; card
              vs CPU. Every main path above and below shows .routed == 0.
  v2          the SE3TransformerV2 family (se3_transformer_torch.v2) on the
              mid-32, two-row arms of #3, A and B: each arm against its
              plain version (KERNEL_RTOL) and timed beside the library
              einsum and its bound at the hidden V2ConvSE3's seven
              distinct (P, IF) shapes (E = 32768, O = 64, float32 h; two
              with bf16 h), conv_in's, and the JAX sweep's shapes on the
              narrow arms (O = 8, E = 1536); `v2_unit` lines weigh the
              hidden shapes by the block's 28 launches. Then the model
              (dim 64, depth 2, degree 6, k 32, mid 32, the S2 grid
              nonlinearity, float32; flagship_fast's graph and widths)
              served at bucket 1024 (requests of 1024, 1000, 700 nodes;
              exactly v2_counts()'s launches, all by the mid-32 arm,
              nothing routed; equivariance of the vector output within
              V2_EQUIVARIANCE_RTOL; a profiled request) and trained for 1
              + 3 steps (vector head, Adam 1e-4, n 1024; a profiled step).
  8. reference  small models of both flagship recipes, both attention knobs
              (fuse_pairwise also tied with the null slot; pallas_attention
              also with one kv head and the null slot) and af2_refinement's
              fields, and molecular_edges at depth 1
              (n 40, 6 atoms masked), on the card (kernel path) against
              the same weights on the CPU
              (plain path): the forward, and one training step's loss and
              every gradient (the fuse_pairwise step runs the streaming
              attention's recompute backward on the card); the assembly
              model, untied and tied, at n 64 on the card against the CPU,
              forward and one backward through the replay; small
              quantized models (QUANT_CASES, int8_mix and fp8_mix) on
              the card against the same quantized weights on the CPU; the
              rest of the model surface (FIELD_CASES: conv_bf16 under
              both recipes, norm_gated_scale, the EGNN trunk plain and with
              adjacency edges, pallas=False, which launches and routes
              nothing, precomputed neighbor lists), the vector output and
              one step's loss and every gradient.

Prints per-shape, per-request and per-step lines, then the nvidia-smi line,
a {"kernels": [...]} JSON line and, last, {"ok": true, "device": {...}}.
Exits non-zero, printing no result, without CUDA or without the package.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# the card's peaks and every kernel's cost model (each kernel's bound_ms)
from se3_transformer_torch.utils.flops import (
    attention_cost, flash_cost, fwd_cost, fwd_q_cost, global_cost,
    pairwise_bwd_cost, pairwise_cost, peaks_for,
)

# per-kernel check tolerance: kernel and plain version sum the same exact
# products in float32 and differ only in summation order
KERNEL_RTOL = 1e-4

# the share of a flagship_fast request's device time the model's profiler
# scopes must account for (JAX's profile-smoke gate)
PROFILE_COVERAGE = 0.8
# float32 #2 (three bf16 passes: each product within 2^-17 of float32's,
# measured at ~5e-6 of max|plain|) and 7g (the same float32 products in
# other orders, its online softmax against the stream's row softmax)
F32_RTOL = 1e-5
# scalar-output invariance under rotation at full size (conditioned random
# weights, see condition_weights): float32 rounding of the rotated
# geometry, carried through 6 blocks; a distance that a rotation moves
# across a bf16 rounding boundary would add one bf16 step of one edge
ROTATION_RTOL = 1e-3
# small-model card-vs-CPU agreement: float32 radial trunk (summation order
# only) and bf16 radial trunk (bf16 roundings of CPU and CUDA kernels)
REF_RTOL_F32 = 1e-4
REF_RTOL_BF16 = 1e-3
# one training step card vs CPU, per gradient leaf relative to its largest
# CPU value: float32 trunk (summation order: kernels, cuBLAS and CPU
# matmuls) and bf16 trunk (bf16 roundings of cuBLAS and the CPU kernels,
# which the backward passes through every bf16 op of the radial trunk)
REF_GRAD_RTOL_F32 = 1e-3
REF_GRAD_RTOL_BF16 = 5e-2
# both recipes at full width (dim 64) and DEPTH blocks of 2 convs: 6 before
# the V2 phases came, cut to 4 (and the pallas_attention paths to
# VARIANT_DEPTH) to keep the smoke inside its time limit with them
DEPTH = 4
TRUNK_CONVS = 2 * DEPTH
# forward launches of one flagship_fast(output_degrees=2) forward: conv_in
# 1x4 pairs, DEPTH blocks x 2 convs x 4x4 pairs, conv_out 4x2 pairs. The
# backward launches kernels A and B once per pair that the loss reaches:
# return_type=1 reads only the degree-1 head, so conv_out's 4 pairs into
# degree 0 get no cotangent and autograd runs no backward for them.
# remat_policy=None replays the trunk's pairs.
REPLAY_LAUNCHES = TRUNK_CONVS * 16
TRAIN_LAUNCHES = 4 + REPLAY_LAUNCHES + 8
TRAIN_BWD_LAUNCHES = 4 + REPLAY_LAUNCHES + 4
TRAIN_STEPS = 3
# the conservative flagship: one fused_pairwise_conv launch per output
# degree of each ConvSE3, per node chunk (edge_chunks=8). Serving: conv_in
# 4 degrees, DEPTH blocks x 2 convs x 4, conv_out 1, each x 8. The
# training forward's conv_out has 2 degrees; the whole-block replay (no
# remat policy) runs the trunk's contractions again; kernels A and B run
# once per chunk of every contraction the loss reaches (not conv_out's
# degree-0 head).
CHUNKS = 8
FLAGSHIP_REPLAY_LAUNCHES = TRUNK_CONVS * 4 * CHUNKS
FLAGSHIP_SERVE_LAUNCHES = 4 * CHUNKS + FLAGSHIP_REPLAY_LAUNCHES + CHUNKS
FLAGSHIP_TRAIN_LAUNCHES = FLAGSHIP_SERVE_LAUNCHES + CHUNKS
FLAGSHIP_BWD_LAUNCHES = FLAGSHIP_SERVE_LAUNCHES
# the attention kernels: one launch per block and degree. With
# pallas_attention=True a training step's checkpoint replay runs each block's
# forward again (save_conv_outputs saves only the pairwise convs), so the
# forward kernel launches twice per step and the backward once. With
# fuse_pairwise=True the streaming kernel replaces both kv convs of every
# block: bxf runs only for conv_in (1 x 4 pairs) and conv_out (4 x 1).
ATTN_LAUNCHES = DEPTH * 4
FLASH_BXF_LAUNCHES = 4 + 4
# flagship_fast with tie_key_values: no to_k conv, so each block's pairs are
# to_v's 16 alone. A training step: conv_in 4, DEPTH x 16, conv_out 4 x 2
# forward (save_conv_outputs), kernels A and B on conv_in's, to_v's and
# conv_out's degree-1 head (4 + DEPTH x 16 + 4). Served with fuse_pairwise
# (and the null slot), the kv convs are programs either way: 8 bxf and 24
# streaming attentions a request, as untied.
TIE_REPLAY_LAUNCHES = DEPTH * 16
TIE_TRAIN_LAUNCHES = 4 + TIE_REPLAY_LAUNCHES + 8
TIE_BWD_LAUNCHES = 4 + TIE_REPLAY_LAUNCHES + 4
# flagship_fast with conv_backend='so2': fuse_basis does not apply (as in
# JAX), and every grouped so2 conv runs kernel #3 once per output degree on
# the band z padded to P. A request: conv_in 4, DEPTH blocks x (to_v 4 +
# to_k 4), conv_out 1. A training step's forward has conv_out's 2 degrees
# (save_conv_outputs: no replay), kernels A and B on all but conv_out's
# degree-0 head. With fuse_pairwise the kv convs are programs: #3 runs for
# conv_in and conv_out only, the so2 arm of #7 once per block and degree.
SO2_SERVE_LAUNCHES = 4 + DEPTH * 8 + 1
SO2_TRAIN_LAUNCHES = 4 + DEPTH * 8 + 2
SO2_BWD_LAUNCHES = 4 + DEPTH * 8 + 1
SO2_FLASH_FWD_LAUNCHES = 4 + 1
# the variant paths (tie, so2, quant, conv_bf16) run at VARIANT_DEPTH, so
# that the smoke keeps to its time limit with the serving phases: the
# kernel phases hold their kernels at full width either way, and the
# flagship_fast and flagship paths stay at DEPTH. variant_counts() gives
# the counts above at that depth.
VARIANT_DEPTH = 2


def variant_counts(depth=VARIANT_DEPTH):
    """The launch counts above (REPLAY_LAUNCHES ... SO2_BWD_LAUNCHES) for a
    model of `depth` blocks."""
    replay = 2 * depth * 16
    flagship_replay = 2 * depth * 4 * CHUNKS
    flagship_serve = 4 * CHUNKS + flagship_replay + CHUNKS
    return dict(
        replay=replay, train=4 + replay + 8, train_bwd=4 + replay + 4,
        flagship_replay=flagship_replay, flagship_serve=flagship_serve,
        flagship_train=flagship_serve + CHUNKS, flagship_bwd=flagship_serve,
        attn=depth * 4, tie_train=4 + depth * 16 + 8,
        tie_bwd=4 + depth * 16 + 4, so2_serve=4 + depth * 8 + 1,
        so2_train=4 + depth * 8 + 2, so2_bwd=4 + depth * 8 + 1)

# conv_bf16 (the bf16 storage of V2, or of the basis and x): served as
# flagship_fast, a request launches #1 as the float32 model does, every
# launch by its bf16-storage arm; a step's backward rebuilds V2 in float32
# from the upcast residuals, so A and B run their float32 arm. flagship's
# #3, A and B launches (its replay's included) all take the bf16-V2 arm.
# The rounding of rotating tensors to bf16 costs equivariance, in the JAX
# package as here, but the served scalar output stays invariant within
# ROTATION_RTOL of max|out| as every other path's does.
# egnn_stress (dim 16, depth 12 EGNN layers and feedforwards, k = 16) at
# scripts/run_baselines.py's n = 512: its only convolution is conv_in, a
# radial trunk per pair (0 -> 0, 0 -> 1) of O = 16: 2 launches of #3's
# narrow-O arm a forward, and of A's and B's a training step
EGNN_N = 512
EGNN_NARROW = 2
# the SE3TransformerV2 family (ROADMAP A5) at flagship_fast's graph and
# widths (n 1024, k 32, dim 64) and degree 6, the degree the family exists
# for (PERF_BUDGETS.json: v2_sweep), depth 2 (the module's default and the
# JAX sweep's, bench.py): mid 32, the full band, the S2 grid nonlinearity,
# float32. Every contraction is one launch of #3's mid-32 arm per (output
# degree, m) of each V2ConvSE3 (v2_launch_shapes), O = 64: P = 1 at m = 0,
# P = 2 (the -m, +m rows) past it.
V2_DIM, V2_DEPTH, V2_N, V2_K = 64, 2, 1024, 32
V2_MODEL = dict(num_degrees=7, num_neighbors=V2_K)
V2_E = V2_N * V2_K
# the JAX sweep's V2 shape (bench.py's v2 sweep: dim 8, n 128, k 12, degree
# 6): every launch on the narrow arms (O = 8)
V2_SWEEP_DIM, V2_SWEEP_E = 8, 128 * 12
# equivariance of the served vector output, relative to max|out|: the
# kernels' three-pass products (within 2^-17 of float32 each) through 4
# convs and 3 activations. It is served on an N/CA/C backbone
# (BACKBONE_BONDS): with one bond length a node's two chain neighbors tie,
# and a rotation may flip which of them a k-nearest cut keeps.
V2_EQUIVARIANCE_RTOL = 1e-4


def v2_launch_shapes(dim=V2_DIM, depth=V2_DEPTH, num_degrees=7,
                     output_degrees=2):
    """(conv, d_out, P, IF) of every #3 launch of one V2 forward, in launch
    order: per V2ConvSE3 and output degree, one per m = 0 .. M (M =
    min(d_out, the top input degree)), IF the channels of every input
    degree whose band reaches m (2 C a degree past m = 0)."""
    hidden = [(d, dim) for d in range(num_degrees)]
    convs = [('conv_in', [(0, dim)], hidden)]
    convs += [(f'block{i}', hidden, hidden) for i in range(depth)]
    convs += [('conv_out', hidden, [(d, dim) for d in range(output_degrees)])]
    shapes = []
    for name, fin, fout in convs:
        top = max(d for d, _ in fin)
        for d_out, _ in fout:
            for m in range(min(d_out, top) + 1):
                IF = sum(c * (1 if m == 0 else 2) for d, c in fin
                         if min(d, d_out) >= m)
                shapes.append((name, d_out, 1 if m == 0 else 2, IF))
    return shapes


def v2_counts(**fields):
    """(forward, backward) launches of #3 and of each of A and B for one V2
    request and one training step on the vector head: the backward runs
    for every launch the loss reaches, all but conv_out's into the
    degree-0 head."""
    shapes = v2_launch_shapes(**fields)
    return len(shapes), sum(1 for conv, d_out, _, _ in shapes
                            if not (conv == 'conv_out' and d_out == 0))

# the launch counters, in the order of every launch tuple below; the so2
# arms', the scaled arms', the conv_bf16 arms' and the narrow-O arms'
# launches count in their kernel's total too
COUNT_NAMES = ('bxf', 'fwd', 'A', 'B', 'attn_fwd', 'attn_bwd', 'flash', 'bx',
               'global', 'flash_so2', 'global_so2', 'fwd_q', 'flash_q',
               'bxf_v16', 'fwd_v16', 'A_v16', 'B_v16', 'fwd_n', 'A_n', 'B_n',
               'fwd_m32', 'A_m32', 'B_m32')
# the wrappers' counts of calls routed past the kernel to its plain
# version, by the layer that calls them (kernels A and B take every width
# the pairwise forwards take, so the backward of a launched call runs
# them, and a routed call's backward is its plain version's autograd)
ROUTE_NAMES = ('bxf', 'fwd', 'attn_fwd', 'flash', 'bx', 'global')
NO_ROUTES = (0,) * len(ROUTE_NAMES)
# af2_refinement (the JAX default model surface: a radial trunk per degree
# pair, float32) at its full width and depth: dim 32, depth 2, degrees 0
# and 1, k = 12, 8 heads of 24. A request launches #3 once per pair of
# every kv conv (2 blocks x to_k, to_v x 4 pairs, O = 192); conv_in (2
# pairs) and conv_out (4) have O = 32, which #3's narrow-O arm takes. A
# training step runs the same forward, and kernels A and B once per pair
# the loss reaches: conv_out's pairs into the degree-0 head get no
# cotangent.
AF2_DIM, AF2_O, AF2_E = 32, 8 * 24, 1024 * 12
AF2_LAUNCHES = 2 * 2 * 4
AF2_NARROW = 2 + 4
AF2_NARROW_BWD = 2 + 2
# molecular_edges (edge tokens, the 2-hop chain adjacency, bonded
# neighbors only) at its full width and depth: dim 32, depth 2, degrees 0
# and 1, 8 heads of 24, at n = 128 atoms. num_neighbors = 0 and at most 6
# bonded a row make K = 6 slots (2 to 4 of them bonded, the rest invalid),
# E = 128 * 6. A forward launches #3 once per pair of every kv conv (2
# blocks x to_k, to_v x 4 pairs, O = 192); conv_in's two pairs and
# conv_out's two (the scalar head) have O = 32: #3's narrow-O arm. A
# training step (property_loss on the pooled scalar head, which every pair
# reaches) runs kernels A and B once per launched pair.
MOL_N, MOL_DIM, MOL_K = 128, 32, 6
MOL_E = MOL_N * MOL_K
MOL_LAUNCHES = 2 * 2 * 4
MOL_NARROW = 2 + 2
# atoms masked in the second served request
MOL_MASKED = 28

# the JAX trainer's path: DenoiseTrainer(DenoiseConfig(accum_steps=16)),
# the CLI's defaults (denoise.py: 96 nodes, batch 1, 2 degrees, 16
# micro-batches a step). Its model (dim 8, 2 heads of 8, bonded attention
# over max_sparse_neighbors = 8 slots: E = 96 * 8 a micro-batch) runs
# every pairwise contraction on the narrow-O arms: per micro-batch #3 at
# these (P, IF, O) shapes so many times, A and B at the same shapes (the
# conv_out pairs into the degree-0 head, which the loss does not read,
# excepted): 22 forward and 20 + 20 backward launches.
DENOISE_ACCUM = 16
DENOISE_E = 96 * 8
DENOISE_SHAPES = {(1, 8, 8): (3, 1), (3, 8, 8): (2, 2), (1, 8, 16): (8, 8),
                  (3, 8, 16): (4, 4), (3, 24, 8): (1, 1), (3, 24, 16): (4, 4)}
DENOISE_FWD = sum(f for f, _ in DENOISE_SHAPES.values()) * DENOISE_ACCUM
DENOISE_BWD = sum(b for _, b in DENOISE_SHAPES.values()) * DENOISE_ACCUM
DENOISE_STEPS = 10
DENOISE_RESUME_AT = 5
DENOISE_PIPELINED_STEPS = 5
# the guarded loop (training.guardian) over DenoiseConfig(accum_steps=
# GUARDED_ACCUM, telemetry=True, flush_every=GUARDED_WINDOW, pipeline=True):
# GUARDED_STEPS steps an arm; the chaos arm's injector poisons build
# GUARDED_NAN_AT (step index 2) with NaN and fails step_dispatch call
# GUARDED_FAIL_AT (step index 4's first attempt, after the NaN window's
# replay), and the parent sends it SIGTERM once it reports step >=
# GUARDED_KILL_AT
GUARDED_ACCUM = 4
GUARDED_STEPS = 8
GUARDED_WINDOW = 2
GUARDED_NAN_AT = 3
GUARDED_FAIL_AT = 7
GUARDED_KILL_AT = 5
GUARDED_FWD = DENOISE_FWD // DENOISE_ACCUM * GUARDED_ACCUM
GUARDED_BWD = DENOISE_BWD // DENOISE_ACCUM * GUARDED_ACCUM
# the chaos and resume subprocesses' time limit
GUARDED_SUBPROCESS_S = 300
# a restored trainer's next loss against the uninterrupted run's, relative:
# the same forward on the same bits, the same batch and noise; equal but
# for any float32 sum whose order the card does not fix (the run-to-run
# spread of the same step is printed beside)
RESUME_RTOL = 1e-6
# the narrow-O arms (csrc/pairwise_narrow.cuh) at the DenoiseConfig shapes
# and at the O = 32 pairs of af2_refinement (E = 12288) and
# molecular_edges (E = 768): conv_in's (0, 0) and (0, 1), conv_out's
# (0, 0), (1, 0), (0, 1) and (1, 1); float32 h and W3, as the models run
NARROW_CASES = tuple(
    [(dict(model='DenoiseConfig'), DENOISE_E, P, IF, O)
     for P, IF, O in DENOISE_SHAPES]
    + [(dict(model=recipe, pair=[di, do]), E, 2 * do + 1,
        32 * (2 * min(di, do) + 1), 32)
       for recipe, E in (('af2_refinement', AF2_E),
                         ('molecular_edges', MOL_E))
       for di in range(2) for do in range(2)])
# the narrow cases that are timed as well as held: the DenoiseConfig
# shapes and af2_refinement's largest pair (conv_out's (1, 1), IF 96)
NARROW_TIMED = (dict(model='af2_refinement', pair=[1, 1]),)
# the narrow arms against their plain versions, relative to max|plain|:
# the wide arms' KERNEL_RTOL, for their arithmetic is the wide arms' (three
# bf16 passes for float32 operands, each product within 2^-17 of
# float32's; up to ~1.5e-5 of max|plain| at af2's largest pair)
NARROW_RTOL = KERNEL_RTOL

# quantized serving (se3_transformer_torch.quant): the device parameter
# bytes of a quantized model against the same weights in float32 stay
# under the JAX package's quant-smoke ceiling
QUANT_MAX_BYTES_RATIO = 0.6
# the scaled arms against their plain versions, relative to max|plain|:
# the same exact products (int8 and e4m3 exact in bf16; float32 h as bf16
# hi + lo, each product exact) summed in float32 in other orders
QUANT_RTOL = 1e-5

# the forward kernels' names in a profile (kernel #3's W3 split and
# i-split reduce and its narrow-O arm included)
FORWARD_KERNELS = ('pairwise_bxf_kernel', 'pairwise_fwd_kernel',
                   'fwd_reduce_kernel', 'fwd_w3_split_kernel',
                   'se3n::fwd_kernel')
# the attention kernels' names in a profile
ATTENTION_KERNELS = ('attention_fwd_kernel', 'attention_bwd_kernel',
                     'flash_fwd_kernel', 'flash_global_kernel')

HERE = os.path.dirname(os.path.abspath(__file__))


# when main() started, for the phase lines
_T0 = []


def tick(label, since=None):
    """One `phase:` line: the seconds since main() started (and, given the
    perf_counter() at the phase's start, the phase's own seconds)."""
    if _T0:
        now = time.perf_counter()
        took = '' if since is None else f' (took {now - since:.1f} s)'
        log(f'phase: {label} done at {now - _T0[0]:.0f} s{took}')


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of fn() over `reps` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# the run over which run_ms times a kernel, in launches, and its repeats;
# a plain version or library call launches ~10-25 kernels a call, and the
# device's launch queue holds ~1000, so their runs are shorter
RUN_LAUNCHES = 60
RUN_CALLS = 20
RUN_REPEATS = 3


def run_ms(calls, launches: int = RUN_LAUNCHES,
           repeats: int = RUN_REPEATS) -> float:
    """Device time per launch, for a kernel of a few microseconds: one pair
    of CUDA events around a run of `launches` calls queued back to back,
    divided by the count; the median of `repeats` runs. The calls rotate
    over `calls` (one per operand set, enough sets that each launch finds
    its operands cold in L2). A spin kernel (torch.cuda._sleep) holds the
    device while the host queues the run, so that the events time the
    kernels and not the host's Python and ctypes between them; it is
    lengthened until it outlasts the queueing, which fails for a call that
    waits for the device, or for a run of more kernels than the device's
    launch queue holds."""
    def queue():
        for i in range(launches):
            calls[i % len(calls)]()
    queue()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    queue()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # cycles at 2 GHz, above the card's clock: the spin lasts longer
        torch.cuda._sleep(int(2 * host_s * 2e9) + 1000)
        t0 = time.perf_counter()
        start.record()
        queue()
        end.record()
        queued_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if queued_s > 1.5 * host_s:    # the spin may have ended first
            host_s = queued_s
            continue
        times.append(start.elapsed_time(end) / launches)
        if len(times) == repeats:
            return float(np.median(times))
    raise AssertionError(f'run_ms: the host kept outlasting the spin '
                         f'({queued_s * 1e3:.1f} ms to queue a run)')


def radial_library(h, w3, b3):
    """The operands of the one PyTorch call that computes a pairwise conv
    from V2 (timed only; the port never calls it): h with a ones column and
    W3 with a b3 row, float32, so that
    einsum('em,mio,epi->epo', h_aug, w3_aug, v2) = V2 . (h.W3 + b3). The
    operands are in the order the contraction runs (R first, then the
    per-edge apply)."""
    ones = torch.ones(h.shape[0], 1, device=h.device)
    return (torch.cat([h.float(), ones], 1),
            torch.cat([w3.float(), b3.float()[None]], 0))


def library_conv(h_aug, w3_aug, v2):
    return torch.einsum('em,mio,epi->epo', h_aug, w3_aug, v2)


def check_bxf(st, kp, gen, E, mid=128, C=64, O=64):
    """Kernels #1 and #2 on every (d_in, d_out) pair at E and at a ragged
    E - 37, in bf16 and float32: each within KERNEL_RTOL of max|plain|, #1
    the same bits on a repeat, #2 (the structured basis) the same bits as
    #1 (the flat one). Returns {dtype: worst relative error}."""
    rel = torch.randn(E, 3, device='cuda', generator=gen) * 4.0
    flat, pqf = (st.get_basis(rel, 3, layout=lay)
                 for lay in ('pfq_flat', 'pqf'))
    worst = {}
    for hdt in (torch.bfloat16, torch.float32):
        for e in (E, E - 37):
            for di in range(4):
                for do in range(4):
                    P, Q, F = 2 * do + 1, 2 * di + 1, 2 * min(di, do) + 1
                    h = torch.randn(e, mid, device='cuda',
                                    generator=gen).to(hdt)
                    w3 = (torch.randn(mid, C * F, O, device='cuda',
                                      generator=gen) * mid ** -0.5).to(hdt)
                    b3 = torch.randn(C * F, O, device='cuda',
                                     generator=gen) * 0.1
                    x = torch.randn(e, C, Q, device='cuda', generator=gen)
                    bf = flat[f'{di},{do}'][:e].contiguous()
                    args = (h, w3, bf, x, (P, Q, F), b3)
                    out = kp.fused_pairwise_conv_bxf(*args)
                    again = kp.fused_pairwise_conv_bxf(*args)
                    structured = kp.fused_pairwise_conv_bx(
                        h, w3, pqf[f'{di},{do}'][:e].contiguous(), x, b3)
                    ref = kp.fused_pairwise_conv_bxf_plain(*args)
                    err = float((out - ref).abs().max() / ref.abs().max())
                    what = f'#1/#2 ({di},{do}) E={e} {hdt}'
                    if not (np.isfinite(err) and err <= KERNEL_RTOL):
                        raise AssertionError(f'{what}: max_abs_err {err} > '
                                             f'{KERNEL_RTOL} of max|plain|')
                    if not torch.equal(out, again):
                        raise AssertionError(f'{what}: a repeat differs')
                    if not torch.equal(out, structured):
                        raise AssertionError(f'{what}: #2 differs from #1')
                    worst[str(hdt)] = max(worst.get(str(hdt), 0.0), err)
    log('kernel', json.dumps(dict(check='#1 and #2, 16 pairs x E '
                                  f'{E}, {E - 37} x bf16, float32',
                                  worst_rel_err=worst)))
    return worst


def phase_kernels(st, peaks):
    from se3_transformer_torch.kernels import pairwise as kp
    gen = torch.Generator(device='cuda').manual_seed(0)
    dev = 'cuda'
    E, mid, C, O = 32768, 128, 64, 64
    check_bxf(st, kp, gen, E, mid, C, O)
    rel = torch.randn(E, 3, device=dev, generator=gen) * 4.0
    basis = st.get_basis(rel, 3, layout='pfq_flat')
    cases = [(di, do, E, torch.bfloat16) for di in range(4)
             for do in range(4)]
    cases += [(2, 1, E - 37, torch.bfloat16), (3, 3, E, torch.float32)]
    rows, worst = [], 0.0
    for di, do, e, hdt in cases:
        P, Q, F = 2 * do + 1, 2 * di + 1, 2 * min(di, do) + 1
        h = torch.randn(e, mid, device=dev, generator=gen).to(hdt)
        w3 = (torch.randn(mid, C * F, O, device=dev, generator=gen)
              * mid ** -0.5).to(hdt)
        b3 = torch.randn(C * F, O, device=dev, generator=gen) * 0.1
        bf = basis[f'{di},{do}'][:e].contiguous()
        x = torch.randn(e, C, Q, device=dev, generator=gen)
        args = (h, w3, bf, x, (P, Q, F), b3)
        out = kp.fused_pairwise_conv_bxf(*args)
        torch.cuda.synchronize()
        ref = kp.fused_pairwise_conv_bxf_plain(*args)
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        if not (np.isfinite(err) and err <= KERNEL_RTOL * scale):
            raise AssertionError(
                f'kernel ({di},{do}) E={e} {hdt}: max_abs_err {err} > '
                f'{KERNEL_RTOL} * max|plain| {scale}')
        worst = max(worst, err)
        ms = cuda_ms(lambda: kp.fused_pairwise_conv_bxf(*args), reps=10)
        plain_ms = cuda_ms(lambda: kp.fused_pairwise_conv_bxf_plain(*args),
                           reps=3)
        v2 = torch.einsum('epfq,ecq->epcf', bf.reshape(e, P, F, Q),
                          x).reshape(e, P, C * F)
        lib = (*radial_library(h, w3, b3), v2)
        library_ms = cuda_ms(lambda: library_conv(*lib), reps=3)
        del v2, lib
        bound_ms, bound_by, flops, bound_ms_fma = pairwise_cost(
            e, mid, C, O, P, Q, F, 2 if hdt == torch.bfloat16 else 4, peaks)
        row = dict(pair=[di, do], E=e, h_dtype=str(hdt).split('.')[-1],
                   max_abs_err=err, max_abs_plain=scale, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   tflops=flops / ms / 1e9)
        if hdt == torch.float32:
            row['bound_ms_fma'] = bound_ms_fma
        rows.append(row)
        log('kernel', json.dumps(row))
        del out, ref, args, h, w3, b3, bf, x
    return rows, worst


def grouped_if(d_out, C=64, degrees=4):
    """IF of one output degree of a hidden ConvSE3: every input degree's
    C * F concatenated."""
    return C * sum(2 * min(d_in, d_out) + 1 for d_in in range(degrees))


def phase_fwd(kp, peaks):
    """fused_pairwise_conv against its plain version for the four output
    degrees of a hidden ConvSE3 (IF = 256, 640, 896, 1024; P = 1..7), at
    the flagship's per-chunk E = 4096 and unchunked E = 32768, in float32
    (the recipe's dtype) and bf16, and bit-identity across two runs."""
    cases = [(dict(d_out=do), E, 2 * do + 1, grouped_if(do), hdt, 64)
             for E in (4096, 32768) for hdt in (torch.float32, torch.bfloat16)
             for do in range(4)]
    rows, worst = check_fwd(kp, peaks, cases, seed=8)
    for E in (4096, 32768):
        for dtype in ('float32', 'bfloat16'):
            conv = [r for r in rows if r['E'] == E and r['h_dtype'] == dtype]
            log('fwd', json.dumps(dict(
                conv='hidden 4x64 -> 4x64, four launches', E=E, h_dtype=dtype,
                **{k: sum(r[k] for r in conv) for k in (
                    'ms', 'plain_ms', 'library_ms', 'bound_ms',
                    'bound_ms_fma')})))
    return rows, worst


def check_fwd(kp, peaks, cases, seed, v16=False, mid=128):
    """Each case (label, E, P, IF, h dtype, O): kernel #3 against its plain
    version, bit-identical across two runs, and the times: kernel, plain
    version, and the library yardstick (the einsum that computes the same
    conv from V2). With `v16` V2 is stored bf16 (conv_bf16): the arm's
    launches, its plain version on the same bf16 V2, the bound with 2-byte
    V2, and beside them the float32 arm's time on the upcast V2
    (float_ms). `mid`: the radial width (32: the V2 arms)."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    dev = 'cuda'
    rows, worst = [], 0.0
    for label, E, P, IF, hdt, O in cases:
        h = torch.randn(E, mid, device=dev, generator=gen).to(hdt)
        w3 = (torch.randn(mid, IF, O, device=dev, generator=gen)
              * mid ** -0.5).to(hdt)
        v2 = torch.randn(E, P, IF, device=dev, generator=gen)
        if v16:
            v2 = v2.to(torch.bfloat16)
        b3 = torch.randn(IF, O, device=dev, generator=gen) * 0.1
        args = (h, w3, v2, b3)
        out = kp.fused_pairwise_conv(*args)
        again = kp.fused_pairwise_conv(*args)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f'fused_pairwise_conv {label} E={E} {hdt}: '
                                 f'two runs differ')
        ref = kp.fused_pairwise_conv_plain(*args)
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        if not (np.isfinite(err) and err <= KERNEL_RTOL * scale):
            raise AssertionError(
                f'fused_pairwise_conv {label} E={E} {hdt}: max_abs_err '
                f'{err} > {KERNEL_RTOL} * max|plain| {scale}')
        worst = max(worst, err)
        del out, again, ref
        ms = cuda_ms(lambda: kp.fused_pairwise_conv(*args), reps=10)
        float_args = (h, w3, v2.float(), b3)
        float_ms = cuda_ms(lambda: kp.fused_pairwise_conv(*float_args),
                           reps=10) if v16 else None
        plain_ms = cuda_ms(lambda: kp.fused_pairwise_conv_plain(*args),
                           reps=3)
        lib = (*radial_library(h, w3, b3), v2.float())
        library_ms = cuda_ms(lambda: library_conv(*lib), reps=3)
        del lib, float_args
        bound_ms, bound_by, flops, bound_ms_fma = fwd_cost(
            E, mid, IF, O, P, 2 if hdt == torch.bfloat16 else 4, peaks,
            v2.element_size())
        row = dict(label, P=P, IF=IF, O=O, E=E, mid=mid,
                   h_dtype=str(hdt).split('.')[-1],
                   i_per_split=kp.i_per_split(E, IF, O),
                   max_abs_err=err, max_abs_plain=scale, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_ms_fma=bound_ms_fma, tflops=flops / ms / 1e9)
        if v16:
            row.update(v2_dtype='bfloat16', float_ms=float_ms)
        rows.append(row)
        log('fwd_v16' if v16 else 'fwd', json.dumps(row))
        del args, h, w3, v2, b3
        torch.cuda.empty_cache()
    return rows, worst


def quantized(w, storage):
    """(q, scale) on the card of a float32 weight [mid, IF, O] quantized
    on the host by quant.quantize (per output channel, contracted axis 0),
    as quant.quantize_params stores it."""
    from se3_transformer_torch import quant
    qt = quant.quantize(w.cpu(), (0,), storage)
    return qt.q.cuda(), qt.scale.cuda()


def phase_fwd_q(kp, peaks):
    """#3's scaled arm (quantized serving, w3_scale) against its plain
    version at the flagship unit (the four output degrees of a hidden
    conv: IF 256..1024, O 64, E = 32768): int8 and fp8 storage with
    float32 h (flagship's trunk), and int8 with bf16 h. Each within
    QUANT_RTOL of max|plain| and the same bits on a repeat; its time, its
    bound, its plain version's, the float arm's on the same operands
    (the dequantized weight in h's dtype), and the library einsum's on the
    dequantized weight. Returns the rows and the worst error."""
    gen = torch.Generator(device='cuda').manual_seed(31)
    E, mid, O = 32768, 128, 64
    rows, worst = [], 0.0
    for storage, hdt in (('int8', torch.float32), ('fp8_e4m3', torch.float32),
                         ('int8', torch.bfloat16)):
        for d_out in range(4):
            P, IF = 2 * d_out + 1, grouped_if(d_out)
            h = torch.randn(E, mid, device='cuda', generator=gen).to(hdt)
            q, sc = quantized(torch.randn(mid, IF, O, device='cuda',
                                          generator=gen) * mid ** -0.5,
                              storage)
            v2 = torch.randn(E, P, IF, device='cuda', generator=gen)
            b3 = torch.randn(IF, O, device='cuda', generator=gen) * 0.1
            label = f'fwd_q {storage} {str(hdt)[6:]} d_out={d_out}'

            def run():
                return kp.fused_pairwise_conv(h, q, v2, b3, w3_scale=sc)

            def plain():
                return kp.fused_pairwise_conv_plain(h, q, v2, b3, w3_scale=sc)
            err, scale = check_twice(label, run, plain, QUANT_RTOL)
            worst = max(worst, err)
            w_float = (q.float() * sc).to(hdt)
            ms = cuda_ms(run, reps=5)
            unscaled_ms = cuda_ms(lambda: kp.fused_pairwise_conv(
                h, w_float, v2, b3), reps=5)
            plain_ms = cuda_ms(plain, reps=1, warmup=0)
            # the library yardstick on the dequantized weight: the same
            # function up to rounding, v2 . ((h . q) * s + b3)
            lib = (*radial_library(h, q.float() * sc, b3), v2)
            library_ms = cuda_ms(lambda: library_conv(*lib), reps=3)
            del lib
            bound_ms, bound_by = fwd_q_cost(E, mid, IF, O, P,
                                            h.element_size(), peaks)
            row = dict(storage=storage, h_dtype=str(hdt)[6:], d_out=d_out,
                       P=P, IF=IF, O=O, E=E, max_abs_err=err,
                       max_abs_plain=scale, ms=ms, plain_ms=plain_ms,
                       unscaled_ms=unscaled_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms)
            rows.append(row)
            log('fwd_q', json.dumps(row))
            del h, q, sc, v2, b3, w_float
            torch.cuda.empty_cache()
        unit = [r for r in rows if (r['storage'], r['h_dtype'])
                == (storage, str(hdt)[6:])]
        log('fwd_q', json.dumps(dict(
            conv='hidden 4x64 -> 4x64, four launches', E=E, storage=storage,
            h_dtype=str(hdt)[6:], **{k: sum(r[k] for r in unit) for k in (
                'ms', 'plain_ms', 'unscaled_ms', 'bound_ms', 'library_ms')})))
    return rows, worst


def phase_backward(kp, peaks):
    """Kernels A and B against their plain versions at every pair shape of
    the flagship_fast training step (E = 32768 edges of n=1024, k=32; the
    16 hidden (d_in, d_out) pairs, which include conv_in's (0, d_out) and
    conv_out's (d_in, 0/1) shapes), a ragged E and a float32 h/w3 case."""
    E, C, bf16 = 32768, 64, torch.bfloat16

    def case(di, do, e=E, hdt=bf16):
        return (dict(pair=[di, do]), e, 2 * do + 1,
                C * (2 * min(di, do) + 1), hdt, 64)
    cases = [case(di, do) for di in range(4) for do in range(4)]
    cases += [case(2, 1, e=E - 37), case(3, 3, hdt=torch.float32)]
    return check_backward(kp, peaks, cases, seed=3)


def phase_backward_grouped(kp, peaks):
    """Kernels A and B at the conservative flagship's grouped shapes: the
    four output degrees of a hidden ConvSE3 (IF = 256 .. 1024), float32,
    at the per-chunk E = 4096 and unchunked E = 32768."""
    cases = [(dict(d_out=do), E, 2 * do + 1, grouped_if(do), torch.float32,
              64) for E in (4096, 32768) for do in range(4)]
    return check_backward(kp, peaks, cases, seed=9)


def phase_backward_af2(kp, peaks):
    """Kernels A and B at af2_refinement's training shapes: the four (d_in,
    d_out) pairs of a kv conv (E = 12288 edges of n = 1024, k = 12; C = 32,
    so IF = 32 or 96; P = 1 or 3; O = heads * dim_head = 192, three O
    tiles; float32 h and W3), held against the plain versions and timed."""
    cases = [(dict(pair=[di, do], recipe='af2_refinement'), AF2_E,
              2 * do + 1, AF2_DIM * (2 * min(di, do) + 1), torch.float32,
              AF2_O) for di in range(2) for do in range(2)]
    return check_backward(kp, peaks, cases, seed=23)


def phase_backward_molecular(kp, peaks):
    """Kernel #3 and kernels A and B at molecular_edges' shapes: the four
    (d_in, d_out) pairs of a kv conv (C = 32, so IF = 32 or 96; P = 1 or 3;
    O = 192, three O tiles; float32 h and W3) at E = 768 (n = 128, K = 6)
    and E = 762 (n = 127, a ragged last edge tile), each against its plain
    version and timed (its O = 32 pairs, conv_in's and conv_out's, are
    phase_pairwise_narrow's). Returns (#3's rows, its worst error, A's and
    B's rows, their worst errors)."""
    cases = [(dict(pair=[di, do], recipe='molecular_edges'), E, 2 * do + 1,
              MOL_DIM * (2 * min(di, do) + 1), torch.float32, AF2_O)
             for E in (MOL_E, MOL_E - 6) for di in range(2)
             for do in range(2)]
    fwd_rows, fwd_worst = check_fwd(kp, peaks, cases, seed=25)
    bwd_rows, bwd_worst = check_backward(kp, peaks, cases, seed=26)
    return fwd_rows, fwd_worst, bwd_rows, bwd_worst


def phase_pairwise_narrow(kp, peaks):
    """The narrow-O arms of #3, A and B (O = 8, 16, 32) at NARROW_CASES,
    float32 h and W3: each output against its plain version within
    NARROW_RTOL of max|plain|, the same bits on a repeat; device time per
    call, at the DenoiseConfig shapes and NARROW_TIMED, by run_ms over
    operand sets that exceed L2 (the kernel, its plain
    version, and the library yardstick: the einsum that computes the
    forward from V2 and, for A and B, autograd of it), beside the bounds
    of fwd_cost and pairwise_bwd_cost. Returns the rows and the worst
    errors by kernel."""
    gen = torch.Generator(device='cuda').manual_seed(31)
    mid = 128
    rows, worst = [], dict(fwd=0.0, a=0.0, b=0.0)
    for label, E, P, IF, O in NARROW_CASES:
        timed = label['model'] == 'DenoiseConfig' or label in NARROW_TIMED
        per_set = 4 * (E * mid + E * P * (IF + O) + mid * IF * O)
        sets = []
        for _ in range(max(2, int(COLD_BYTES // per_set) + 1) if timed
                       else 1):
            sets.append((
                torch.randn(E, mid, device='cuda', generator=gen),
                torch.randn(mid, IF, O, device='cuda', generator=gen)
                * mid ** -0.5,
                torch.randn(E, P, IF, device='cuda', generator=gen),
                torch.randn(E, P, O, device='cuda', generator=gen),
                torch.randn(IF, O, device='cuda', generator=gen) * 0.1))
        h, w3, v2, g, b3 = sets[0]
        shape = kp._check_bwd(h, w3, v2, g, b3)
        out = kp.fused_pairwise_conv(h, w3, v2, b3)
        dw3, dv2, db3 = kp._launch_bwd_a(h, w3, v2, g, b3, *shape)
        dh = kp._launch_bwd_b(w3, v2, g, *shape)
        again = (kp.fused_pairwise_conv(h, w3, v2, b3),
                 *kp._launch_bwd_a(h, w3, v2, g, b3, *shape),
                 kp._launch_bwd_b(w3, v2, g, *shape))
        torch.cuda.synchronize()
        refs = (kp.fused_pairwise_conv_plain(h, w3, v2, b3),
                *kp.fused_pairwise_conv_bwd_a_plain(h, w3, v2, g, b3),
                kp.fused_pairwise_conv_bwd_b_plain(w3, v2, g))
        errs = {}
        for name, kernel, got, rep_, ref in zip(
                ('out', 'dw3', 'dv2', 'db3', 'dh'),
                ('fwd', 'a', 'a', 'a', 'b'), (out, dw3, dv2, db3, dh), again,
                refs):
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            if not (np.isfinite(err) and err <= NARROW_RTOL * scale):
                raise AssertionError(
                    f'narrow {label} E={E} P={P} IF={IF} O={O} {name}: '
                    f'max_abs_err {err} > {NARROW_RTOL} * max|plain| {scale}')
            if not torch.equal(got, rep_):
                raise AssertionError(f'narrow {label} O={O} {name}: two '
                                     f'runs differ')
            errs[name] = err
            worst[kernel] = max(worst[kernel], err)
        del out, dw3, dv2, db3, dh, again, refs
        row = dict(label, E=E, P=P, IF=IF, O=O, o_tile=kp.o_tile(O),
                   h_dtype='float32', i_per_split=kp.i_per_split(E, IF, O),
                   a_splits=kp.bwd_splits(E, IF, O), max_abs_err=errs)
        if not timed:
            log('narrow', json.dumps(row))
            continue
        libs = [(*radial_library(h, w3, b3), v2) for h, w3, v2, _, b3 in sets]
        graphs = []
        for lib, (*_, g, _) in zip(libs, sets):
            leaves = [t.detach().requires_grad_() for t in lib]
            graphs.append((leaves, library_conv(*leaves), g))
        row.update(ms=run_ms([lambda s=s: kp.fused_pairwise_conv(
                       s[0], s[1], s[2], s[4]) for s in sets]),
                   plain_ms=run_ms([lambda s=s: kp.fused_pairwise_conv_plain(
                       s[0], s[1], s[2], s[4]) for s in sets], RUN_CALLS),
                   library_ms=run_ms([lambda x=x: library_conv(*x)
                                      for x in libs], RUN_CALLS),
                   ms_a=run_ms([lambda s=s: kp._launch_bwd_a(
                       *s[:4], s[4], *shape) for s in sets]),
                   plain_ms_a=run_ms([
                       lambda s=s: kp.fused_pairwise_conv_bwd_a_plain(
                           *s[:4], s[4]) for s in sets], RUN_CALLS),
                   library_ms_a=run_ms([lambda x=x: torch.autograd.grad(
                       x[1], x[0][1:], x[2], retain_graph=True)
                       for x in graphs], RUN_CALLS),
                   ms_b=run_ms([lambda s=s: kp._launch_bwd_b(
                       s[1], s[2], s[3], *shape) for s in sets]),
                   plain_ms_b=run_ms([
                       lambda s=s: kp.fused_pairwise_conv_bwd_b_plain(
                           s[1], s[2], s[3]) for s in sets], RUN_CALLS),
                   library_ms_b=run_ms([lambda x=x: torch.autograd.grad(
                       x[1], x[0][:1], x[2], retain_graph=True)
                       for x in graphs], RUN_CALLS))
        # the bounds of the wide arms' cost models at this call's own O:
        # the products on the tensor cores (three bf16 passes for float32
        # operands), the rest on the float32 CUDA cores, as the arms do the
        # work; beside them the bound of every product on float32 FMAs
        (row['bound_ms'], row['bound_by'], _,
         row['bound_ms_fma']) = fwd_cost(E, mid, IF, O, P, 4, peaks)
        for kernel in ('a', 'b'):
            (row[f'bound_ms_{kernel}'], row[f'bound_by_{kernel}'],
             row[f'bound_ms_fma_{kernel}']) = pairwise_bwd_cost(
                 kernel, E, mid, IF, O, P, 4, peaks)
        rows.append(row)
        log('narrow', json.dumps(row))
        del sets, libs, graphs
        torch.cuda.empty_cache()
    # one DenoiseConfig training step's narrow launches at these times
    step = dict.fromkeys(('ms', 'bound_ms', 'bound_ms_fma', 'ms_a',
                          'bound_ms_a', 'bound_ms_fma_a', 'ms_b',
                          'bound_ms_b', 'bound_ms_fma_b'), 0.0)
    for r in rows:
        if r['model'] != 'DenoiseConfig':
            continue
        fwd_n, bwd_n = DENOISE_SHAPES[(r['P'], r['IF'], r['O'])]
        for k in step:
            step[k] += DENOISE_ACCUM * r[k] * (
                bwd_n if k.endswith(('_a', '_b')) else fwd_n)
    log('narrow_step', json.dumps(dict(model='DenoiseConfig',
                                       accum_steps=DENOISE_ACCUM, **step)))
    return rows, worst


def phase_conv_bf16_bxf(st, kp, peaks):
    """conv_bf16's arm of kernels #1 and #2 (the basis and x stored bf16,
    upcast where V2 is built) at the flagship_fast unit: the 16 pairs of a
    hidden ConvSE3 at E = 32768 (and a ragged E for one pair), bf16 h. Each
    within KERNEL_RTOL of its plain version on the same bf16 operands, the
    same bits on a repeat, and #2 (the structured bf16 basis) the same bits
    as #1; its time, its bound (2-byte basis and x), its plain version's,
    the float32 arm's on the upcast operands (float_ms) and the library
    einsum's on the upcast V2. Returns the rows and the worst error."""
    gen = torch.Generator(device='cuda').manual_seed(33)
    E, mid, C, O = 32768, 128, 64, 64
    bf16 = torch.bfloat16
    rel = torch.randn(E, 3, device='cuda', generator=gen) * 4.0
    flat, pqf = (st.get_basis(rel, 3, layout=lay)
                 for lay in ('pfq_flat', 'pqf'))
    cases = [(di, do, E) for di in range(4) for do in range(4)]
    cases.append((2, 1, E - 37))
    rows, worst = [], 0.0
    for di, do, e in cases:
        P, Q, F = 2 * do + 1, 2 * di + 1, 2 * min(di, do) + 1
        h = torch.randn(e, mid, device='cuda', generator=gen).to(bf16)
        w3 = (torch.randn(mid, C * F, O, device='cuda', generator=gen)
              * mid ** -0.5).to(bf16)
        b3 = torch.randn(C * F, O, device='cuda', generator=gen) * 0.1
        b16 = flat[f'{di},{do}'][:e].to(bf16).contiguous()
        s16 = pqf[f'{di},{do}'][:e].to(bf16).contiguous()
        x16 = torch.randn(e, C, Q, device='cuda', generator=gen).to(bf16)
        args = (h, w3, b16, x16, (P, Q, F), b3)
        label = f'#1 conv_bf16 ({di},{do}) E={e}'
        err, scale = check_twice(
            label, lambda: kp.fused_pairwise_conv_bxf(*args),
            lambda: kp.fused_pairwise_conv_bxf_plain(*args), KERNEL_RTOL)
        if not torch.equal(kp.fused_pairwise_conv_bx(h, w3, s16, x16, b3),
                           kp.fused_pairwise_conv_bxf(*args)):
            raise AssertionError(f'{label}: #2 differs from #1')
        worst = max(worst, err)
        float_args = (h, w3, b16.float(), x16.float(), (P, Q, F), b3)
        ms = cuda_ms(lambda: kp.fused_pairwise_conv_bxf(*args), reps=10)
        float_ms = cuda_ms(lambda: kp.fused_pairwise_conv_bxf(*float_args),
                           reps=10)
        plain_ms = cuda_ms(lambda: kp.fused_pairwise_conv_bxf_plain(*args),
                           reps=3)
        v2 = torch.einsum('epfq,ecq->epcf', float_args[2].reshape(
            e, P, F, Q), float_args[3]).reshape(e, P, C * F)
        lib = (*radial_library(h, w3, b3), v2)
        library_ms = cuda_ms(lambda: library_conv(*lib), reps=3)
        del v2, lib, float_args
        bound_ms, bound_by, flops, _ = pairwise_cost(
            e, mid, C, O, P, Q, F, 2, peaks, v_bytes=2)
        row = dict(pair=[di, do], E=e, h_dtype='bfloat16',
                   operand_dtype='bfloat16', max_abs_err=err,
                   max_abs_plain=scale, ms=ms, float_ms=float_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   tflops=flops / ms / 1e9)
        rows.append(row)
        log('kernel_v16', json.dumps(row))
        del args, h, w3, b3, b16, s16, x16
        torch.cuda.empty_cache()
    unit = [r for r in rows if r['E'] == E]
    log('kernel_v16', json.dumps(dict(
        conv='hidden 4x64 -> 4x64, 16 pairs, bf16 basis and x', E=E,
        **{k: sum(r[k] for r in unit) for k in (
            'ms', 'float_ms', 'plain_ms', 'library_ms', 'bound_ms')})))
    return rows, worst


def phase_conv_bf16_fwd(kp, peaks):
    """conv_bf16's arm of kernel #3 (V2 stored bf16, upcast on the staged
    tile) at the flagship unit: the four output degrees of a hidden
    ConvSE3, float32 h (the recipe's trunk), at the per-chunk E = 4096 of
    its path and unchunked E = 32768 (check_fwd with v16)."""
    cases = [(dict(d_out=do), E, 2 * do + 1, grouped_if(do), torch.float32,
              64) for E in (4096, 32768) for do in range(4)]
    rows, worst = check_fwd(kp, peaks, cases, seed=34, v16=True)
    for E in (4096, 32768):
        conv = [r for r in rows if r['E'] == E]
        log('fwd_v16', json.dumps(dict(
            conv='hidden 4x64 -> 4x64, four launches, bf16 V2', E=E,
            h_dtype='float32', **{k: sum(r[k] for r in conv) for k in (
                'ms', 'float_ms', 'plain_ms', 'library_ms', 'bound_ms')})))
    return rows, worst


def phase_conv_bf16_backward(kp, peaks):
    """conv_bf16's arm of kernels A and B (V2 stored bf16) at the flagship
    training shapes: the four output degrees of a hidden ConvSE3, float32,
    at E = 4096 and 32768 (check_backward with v16)."""
    cases = [(dict(d_out=do), E, 2 * do + 1, grouped_if(do), torch.float32,
              64) for E in (4096, 32768) for do in range(4)]
    return check_backward(kp, peaks, cases, seed=35, v16=True)


# the hidden V2ConvSE3's launches of the served V2 model, by (P, IF)
def v2_unit_shapes():
    """{(P, IF): launches} of one hidden V2ConvSE3 (block0) of the served
    V2 model: 28 launches, seven distinct shapes."""
    unit = {}
    for conv, _, P, IF in v2_launch_shapes():
        if conv == 'block0':
            unit[P, IF] = unit.get((P, IF), 0) + 1
    return unit


def weighted(rows, keys):
    """The rows' `keys` summed with each row's launches (its `mult`)."""
    return {k: sum(r[k] * r['mult'] for r in rows) for k in keys}


def phase_v2_kernels(kp, peaks):
    """The mid-32, two-row arms of #3, A and B against their plain versions
    and timed (check_fwd, check_backward at mid 32): the hidden
    V2ConvSE3's seven distinct (P, IF) at E = V2_E, O = 64, float32 h (the
    model's), the largest P = 1 and P = 2 of them with bf16 h
    (radial_bf16), conv_in's (1, 64); the JAX sweep's distinct shapes (dim
    8: O = 8, the narrow arms, E = 1536), float32. Prints `v2_unit` lines:
    the float32 hidden shapes weighed by the block's launches (the unit of
    PERF.md's rows 3v, 4Av, 4Bv). Returns (rows of #3, rows of A/B, the
    worst errors)."""
    f32, bf16 = torch.float32, torch.bfloat16
    unit = v2_unit_shapes()
    cases = [(dict(model='se3_v2', unit='block', mult=k), V2_E, P, IF, f32,
              V2_DIM) for (P, IF), k in sorted(unit.items())]
    cases += [(dict(model='se3_v2', unit='block', mult=0), V2_E, P, IF, bf16,
               V2_DIM) for P, IF in ((1, 448), (2, 768))]
    cases.append((dict(model='se3_v2', unit='conv_in', mult=0), V2_E, 1,
                  V2_DIM, f32, V2_DIM))
    sweep = sorted({(P, IF) for _, _, P, IF in v2_launch_shapes(
        dim=V2_SWEEP_DIM)})
    cases += [(dict(model='se3_v2 sweep', unit='sweep', mult=0), V2_SWEEP_E,
               P, IF, f32, V2_SWEEP_DIM) for P, IF in sweep]
    fwd_rows, fwd_worst = check_fwd(kp, peaks, cases, seed=24, mid=32)
    bwd_rows, bwd_worst = check_backward(kp, peaks, cases, seed=25, mid=32)
    log('v2_unit', json.dumps(dict(
        kernel='fused_pairwise_conv (mid 32)', launches=sum(unit.values()),
        E=V2_E, sum_IF=sum(IF * k for (_, IF), k in unit.items()),
        **weighted([r for r in fwd_rows if r['mult']], (
            'ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_ms_fma')))))
    for k in ('a', 'b'):
        log('v2_unit', json.dumps(dict(
            kernel=f'fused_pairwise_conv_bwd_{k} (mid 32)',
            launches=sum(unit.values()), E=V2_E,
            **weighted([r for r in bwd_rows if r['mult']],
                       (f'ms_{k}', f'plain_ms_{k}', f'library_ms_{k}',
                        f'bound_ms_{k}', f'bound_ms_fma_{k}')))))
    return fwd_rows, bwd_rows, fwd_worst, bwd_worst


def v2_module(**fields):
    """The served and trained V2 model (V2_MODEL with the recipe
    arguments phase_serve and phase_train give)."""
    from se3_transformer_torch.v2 import SE3TransformerV2Module
    return SE3TransformerV2Module(**V2_MODEL, **fields)


def check_backward(kp, peaks, cases, seed, v16=False, mid=128):
    """Each case (label, E, P, IF, h dtype, O): kernels A and B against
    their plain versions, dW3/dB3 and dH bit-identical across two runs (E =
    4096 splits kernel B's i range: its partials' reduce), and the times:
    kernel, plain version, and the library yardstick (torch.autograd.grad
    of the einsum that computes the forward). With `v16` V2 is stored bf16
    (conv_bf16): the arms' launches, their plain versions on the same bf16
    V2, the bounds with 2-byte V2, and beside them the float32 arms' times
    on the upcast V2 (float_ms_a, float_ms_b). `mid`: the radial width
    (32: the V2 arms)."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    dev = 'cuda'
    rows, worst = [], {'a': 0.0, 'b': 0.0}
    for label, e, P, IF, hdt, O in cases:
        h = torch.randn(e, mid, device=dev, generator=gen).to(hdt)
        w3 = (torch.randn(mid, IF, O, device=dev, generator=gen)
              * mid ** -0.5).to(hdt)
        v2 = torch.randn(e, P, IF, device=dev, generator=gen)
        if v16:
            v2 = v2.to(torch.bfloat16)
        g = torch.randn(e, P, O, device=dev, generator=gen)
        b3 = torch.randn(IF, O, device=dev, generator=gen) * 0.1
        shape = kp._check_bwd(h, w3, v2, g, b3)
        dw3, dv2, db3 = kp._launch_bwd_a(h, w3, v2, g, b3, *shape)
        dh = kp._launch_bwd_b(w3, v2, g, *shape)
        dw3_2, _, db3_2 = kp._launch_bwd_a(h, w3, v2, g, b3, *shape)
        dh_2 = kp._launch_bwd_b(w3, v2, g, *shape)
        torch.cuda.synchronize()
        if not (torch.equal(dw3, dw3_2) and torch.equal(db3, db3_2)):
            raise AssertionError(f'backward {label} E={e}: dW3/dB3 differ '
                                 f'between two runs')
        if not torch.equal(dh, dh_2):
            raise AssertionError(f'backward {label} E={e}: dH differs '
                                 f'between two runs')
        errs = {}
        ref_w3, ref_v2, ref_b3 = kp.fused_pairwise_conv_bwd_a_plain(
            h, w3, v2, g, b3)
        ref_h = kp.fused_pairwise_conv_bwd_b_plain(w3, v2, g)
        for name, out, ref in (('dh', dh, ref_h), ('dw3', dw3, ref_w3),
                               ('dv2', dv2, ref_v2), ('db3', db3, ref_b3)):
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            if not (np.isfinite(err) and err <= KERNEL_RTOL * scale):
                raise AssertionError(
                    f'backward {label} E={e} {hdt} O={O} {name}: max_abs_err '
                    f'{err} > {KERNEL_RTOL} * max|plain| {scale}')
            errs[name] = (err, scale)
        worst['a'] = max(worst['a'], *(errs[k][0] for k in
                                       ('dw3', 'dv2', 'db3')))
        worst['b'] = max(worst['b'], errs['dh'][0])
        del ref_w3, ref_v2, ref_b3, ref_h, dw3_2, db3_2, dh_2
        torch.cuda.empty_cache()
        hb = 2 if hdt == torch.bfloat16 else 4
        # the library yardstick: autograd of the one einsum that computes
        # the forward, its graph built outside the timed calls; kernel A's
        # outputs are the gradients of W3 (with its b3 row) and V2, kernel
        # B's that of h
        leaves = [t.detach().requires_grad_()
                  for t in (*radial_library(h, w3, b3), v2.float())]
        graph = library_conv(*leaves)
        library = {k: cuda_ms(lambda: torch.autograd.grad(
            graph, wrt, g, retain_graph=True), reps=3)
            for k, wrt in (('a', leaves[1:]), ('b', leaves[:1]))}
        del graph, leaves
        torch.cuda.empty_cache()
        row = dict(label, E=e, P=P, IF=IF, O=O, mid=mid,
                   h_dtype=str(hdt).split('.')[-1],
                   b_i_per_split=kp.i_per_split(e, IF, O),
                   max_abs_err={k: v[0] for k, v in errs.items()},
                   max_abs_plain={k: v[1] for k, v in errs.items()},
                   ms_a=cuda_ms(lambda: kp._launch_bwd_a(h, w3, v2, g, b3,
                                                         *shape), reps=5),
                   ms_b=cuda_ms(lambda: kp._launch_bwd_b(w3, v2, g, *shape),
                                reps=5),
                   plain_ms_a=cuda_ms(lambda: kp.fused_pairwise_conv_bwd_a_plain(
                       h, w3, v2, g, b3), reps=3),
                   plain_ms_b=cuda_ms(lambda: kp.fused_pairwise_conv_bwd_b_plain(
                       w3, v2, g), reps=3),
                   library_ms_a=library['a'], library_ms_b=library['b'])
        if v16:
            v2f = v2.float()
            row.update(v2_dtype='bfloat16', float_ms_a=cuda_ms(
                lambda: kp._launch_bwd_a(h, w3, v2f, g, b3, *shape), reps=5),
                float_ms_b=cuda_ms(
                    lambda: kp._launch_bwd_b(w3, v2f, g, *shape), reps=5))
            del v2f
        for k in ('a', 'b'):
            (row[f'bound_ms_{k}'], row[f'bound_by_{k}'],
             row[f'bound_ms_fma_{k}']) = pairwise_bwd_cost(
                k, e, mid, IF, O, P, hb, peaks, v2.element_size())
        rows.append(row)
        log('backward_v16' if v16 else 'backward', json.dumps(row))
        del h, w3, v2, g, b3, dw3, dv2, db3, dh
        torch.cuda.empty_cache()
    return rows, worst


# the flagship's per-degree attention shapes: B*h = 8 rows of n = 1024
# nodes, J = 33 slots (self + 32 neighbors), D = dim_head * (2d + 1)
ATTN_SHAPES = tuple((8, 1024, 33, 8 * (2 * d + 1)) for d in range(4))


# operand sets of the attention rows: k and v across the sets fill the
# 50 MB L2 more than twice over, so that each launch of a run finds its k
# and v cold, as the path does (the mask, [1, n, J], stays shared and hot,
# as it is on the path)
COLD_BYTES = 128e6


def phase_attention(peaks):
    """Kernels #5 and #6 against their plain versions at the four flagship
    per-degree shapes (masked: the self slot always valid, about a tenth of
    the neighbors masked), the backward's outputs bit-identical over two
    runs, and the one PyTorch call that computes the same function:
    scaled_dot_product_attention over a batch of B*h*n rows of query length
    1 with a boolean mask (its forward, and the backward of its autograd
    graph), timed only. ms_*, plain_ms_* and library_ms_* are device times
    per launch by run_ms over runs that rotate among cold operand sets;
    call_ms_* time one call between two events (the host's wrapper and
    ctypes included, the operands hot in L2)."""
    import torch.nn.functional as F
    from se3_transformer_torch.kernels import attention as ka
    gen = torch.Generator(device='cuda').manual_seed(11)
    rows, worst = [], {'fwd': 0.0, 'bwd': 0.0}
    for BH, n, J, D in ATTN_SHAPES:
        def rand(*shape):
            return torch.randn(*shape, device='cuda', generator=gen)
        mask = torch.rand(1, n, J, device='cuda', generator=gen) > 0.1
        mask[..., 0] = True
        scale = 8 ** -0.5
        count = max(2, -(-int(COLD_BYTES) // (2 * BH * n * J * D * 4)))
        sets = [(rand(BH, n, D), rand(BH, n, J, D), rand(BH, n, J, D),
                 rand(BH, n, D)) for _ in range(count)]
        q, k, v, g = sets[0]
        args = (q, k, v, mask, BH, scale)
        out = ka.fused_attention_fwd(*args)
        grads = ka.fused_attention_bwd(q, k, v, mask, g, BH, scale)
        again = ka.fused_attention_bwd(q, k, v, mask, g, BH, scale)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f'attention backward D={D}: two runs differ')
        errs = {}
        refs = (ka.fused_attention_plain(*args),
                *ka.fused_attention_bwd_plain(q, k, v, mask, g, BH, scale))
        for name, got, ref in zip(('out', 'dq', 'dk', 'dv'), (out, *grads),
                                  refs):
            err = float((got - ref).abs().max())
            scale_ref = float(ref.abs().max())
            if not (np.isfinite(err) and err <= KERNEL_RTOL * scale_ref):
                raise AssertionError(f'attention D={D} {name}: max_abs_err '
                                     f'{err} > {KERNEL_RTOL} * max|plain| '
                                     f'{scale_ref}')
            errs[name] = err
        worst['fwd'] = max(worst['fwd'], errs['out'])
        worst['bwd'] = max(worst['bwd'], errs['dq'], errs['dk'], errs['dv'])
        # the library yardstick: one query row per (b*h, node)
        ms = mask.expand(BH, n, J).reshape(BH * n, 1, J)

        def sdpa(a, b, c):
            return F.scaled_dot_product_attention(a, b, c, attn_mask=ms,
                                                  scale=scale)
        flat = [(sq.reshape(BH * n, 1, D), sk.reshape(BH * n, J, D),
                 sv.reshape(BH * n, J, D), sg.reshape(BH * n, 1, D))
                for sq, sk, sv, sg in sets]
        sdpa_err = float((sdpa(*flat[0][:3]).reshape(BH, n, D)
                          - refs[0]).abs().max())
        graphs = []
        for fq, fk, fv, fg in flat:
            leaves = [t.detach().requires_grad_() for t in (fq, fk, fv)]
            graphs.append((sdpa(*leaves), leaves, fg))

        def each(fn):
            return [lambda s=s: fn(*s) for s in sets]
        row = dict(
            BH=BH, n=n, J=J, D=D, operand_sets=count, max_abs_err=errs,
            sdpa_max_abs_err=sdpa_err,
            ms_fwd=run_ms(each(lambda q, k, v, g: ka.fused_attention_fwd(
                q, k, v, mask, BH, scale))),
            ms_bwd=run_ms(each(lambda q, k, v, g: ka.fused_attention_bwd(
                q, k, v, mask, g, BH, scale))),
            plain_ms_fwd=run_ms(each(lambda q, k, v, g:
                                     ka.fused_attention_plain(
                                         q, k, v, mask, BH, scale)),
                                RUN_CALLS),
            plain_ms_bwd=run_ms(each(lambda q, k, v, g:
                                     ka.fused_attention_bwd_plain(
                                         q, k, v, mask, g, BH, scale)),
                                RUN_CALLS),
            library_ms_fwd=run_ms([lambda f=f: sdpa(*f[:3]) for f in flat],
                                  RUN_CALLS),
            library_ms_bwd=run_ms([
                lambda t=t: torch.autograd.grad(t[0], t[1], t[2],
                                                retain_graph=True)
                for t in graphs], RUN_CALLS),
            call_ms_fwd=cuda_ms(lambda: ka.fused_attention_fwd(*args),
                                reps=20),
            call_ms_bwd=cuda_ms(lambda: ka.fused_attention_bwd(
                q, k, v, mask, g, BH, scale), reps=20))
        for key, bwd in (('fwd', False), ('bwd', True)):
            row[f'bound_ms_{key}'], row[f'bound_by_{key}'] = attention_cost(
                BH, n, J, D, bwd, peaks)
        rows.append(row)
        log('attention', json.dumps(row))
        del graphs, flat, sets, out, grads, again, refs
        torch.cuda.empty_cache()
    return rows, worst


def flash_operands(gen, n, K, d_out, h_dtype, prefix, heads=8, mid=128):
    """(cfg, ops) of one flash_attention call at the flagship_fast widths:
    four input degrees of 64 channels, the self slot as the prefix, float32
    w3 scaled to keep k and v O(1), a 5% neighbor mask."""
    from se3_transformer_torch.kernels import flash as kf
    pairs = tuple((d, 64) for d in range(4))
    Dh = 8 * (2 * d_out + 1)
    IF = sum(c * (2 * min(d, d_out) + 1) for d, c in pairs)
    w = (mid * IF) ** -0.5

    def rand(*shape, s=1.0):
        return torch.randn(*shape, device='cuda', generator=gen) * s
    ops = dict(q=rand(1, n, heads, Dh),
               xs=tuple(rand(1, n, c, 2 * d + 1) for d, c in pairs),
               idx=torch.randint(0, n, (1, n, K), device='cuda',
                                 generator=gen),
               nmask=torch.rand(1, n, K, device='cuda', generator=gen) > 0.05,
               h_v=rand(1, n, K, mid).to(h_dtype),
               h_k=rand(1, n, K, mid).to(h_dtype),
               wv=rand(mid, IF, 64, s=w), wk=rand(mid, IF, 64, s=w),
               bv=rand(IF, 64, s=0.1), bk=rand(IF, 64, s=0.1),
               sh=kf.flash_sh_payload(rand(1, n, K, 3), 3),
               prefix_k=rand(1, n, prefix, heads * Dh) if prefix else None,
               prefix_v=rand(1, n, prefix, heads * Dh) if prefix else None)
    cfg = kf.FlashConfig(pairs=pairs, d_out=d_out, heads=heads,
                         kv_heads=heads, scale=8 ** -0.5, prefix=prefix)
    return cfg, ops


def phase_flash(peaks):
    """Kernel #7 against its plain version (the chunked stream) at the
    four flagship_fast output degrees (n 1024, K 32, the self slot as the
    one prefix slot, four input degrees of 64 channels, bf16 h), then with
    float32 h at d_out 3 and on a ragged call (n 1023, K 30, no prefix,
    bf16 h, d_out 2): each within KERNEL_RTOL of max|plain| and the same
    bits on a repeat; times and bounds. The block's rows (the four
    degrees) are returned for the kernels line, the other two logged."""
    from se3_transformer_torch.kernels import flash as kf
    gen = torch.Generator(device='cuda').manual_seed(12)
    cases = [(1024, 32, d_out, torch.bfloat16, 1) for d_out in range(4)]
    cases += [(1024, 32, 3, torch.float32, 1), (1023, 30, 2, torch.bfloat16, 0)]
    rows, worst = [], 0.0
    for n, K, d_out, h_dtype, prefix in cases:
        cfg, ops = flash_operands(gen, n, K, d_out, h_dtype, prefix)
        label = (f'flash d_out={d_out} n={n} K={K} '
                 f'{str(h_dtype).split(".")[-1]}')
        out = kf.flash_attention_fwd(cfg, ops)
        again = kf.flash_attention_fwd(cfg, ops)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f'{label}: two runs differ')
        ref = kf.flash_attention_plain(cfg, ops)
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        if not (np.isfinite(err) and err <= KERNEL_RTOL * scale):
            raise AssertionError(f'{label}: max_abs_err {err} > '
                                 f'{KERNEL_RTOL} * max|plain| {scale}')
        worst = max(worst, err)
        del out, again, ref
        ms = cuda_ms(lambda: kf.flash_attention_fwd(cfg, ops), reps=5)
        plain_ms = cuda_ms(lambda: kf.flash_attention_plain(cfg, ops),
                           reps=2)
        P, Dh = 2 * d_out + 1, 8 * (2 * d_out + 1)
        h_bytes = 2 if h_dtype == torch.bfloat16 else 4
        bound_ms, bound_by, flops, bound_ms_fma = flash_cost(
            n, K, cfg.pairs, d_out, cfg.heads, Dh, ops['sh'].shape[-1],
            prefix, h_bytes, peaks)
        row = dict(d_out=d_out, P=P, IF=ops['wk'].shape[1], n=n, K=K,
                   prefix=prefix, h_dtype=str(h_dtype).split('.')[-1],
                   max_abs_err=err, max_abs_plain=scale, rel_err=err / scale,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bound_ms_fma=bound_ms_fma,
                   tflops=flops / ms / 1e9)
        if (n, K, h_dtype) == (1024, 32, torch.bfloat16):
            rows.append(row)
        log('flash', json.dumps(row))
        del ops
        torch.cuda.empty_cache()
    return rows, worst


def tied(cfg, ops, names=('h_k', 'wk', 'bk')):
    """A kernel call's (cfg, ops) with the keys tied to the values: the
    same operands without the keys' own."""
    return cfg._replace(tie=True), dict(ops, **{k: None for k in names})


def phase_flash_tie(peaks):
    """Kernel #7's tied variant (tie_key_values: one conv pass a tile, read
    as k and as v) against the tied plain stream at the four
    flagship_fast output degrees with the [null, self] prefix (n 1024, K
    32, heads 8 of 8, four input degrees of 64 channels, bf16 h): within
    KERNEL_RTOL of max|plain|, the same bits on a repeat; its time beside
    the untied kernel's on the same operands (untied, tied, tied, untied:
    one cuda_ms each), the tied and untied bounds. Returns the rows and
    the worst error."""
    from se3_transformer_torch.kernels import flash as kf
    gen = torch.Generator(device='cuda').manual_seed(21)
    rows, worst = [], 0.0
    for d_out in range(4):
        n, K, prefix = 1024, 32, 2
        ucfg, uops = flash_operands(gen, n, K, d_out, torch.bfloat16, prefix)
        cfg, ops = tied(ucfg, uops)
        label = f'flash tie d_out={d_out}'
        out = kf.flash_attention_fwd(cfg, ops)
        again = kf.flash_attention_fwd(cfg, ops)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f'{label}: two runs differ')
        ref = kf.flash_attention_plain(cfg, ops)
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        if not (np.isfinite(err) and err <= KERNEL_RTOL * scale):
            raise AssertionError(f'{label}: max_abs_err {err} > '
                                 f'{KERNEL_RTOL} * max|plain| {scale}')
        worst = max(worst, err)
        del out, again, ref
        untied_ms = [cuda_ms(lambda: kf.flash_attention_fwd(ucfg, uops),
                             reps=5)]
        ms = [cuda_ms(lambda: kf.flash_attention_fwd(cfg, ops), reps=5)
              for _ in range(2)]
        untied_ms.append(cuda_ms(lambda: kf.flash_attention_fwd(ucfg, uops),
                                 reps=5))
        plain_ms = cuda_ms(lambda: kf.flash_attention_plain(cfg, ops), reps=2)
        P, Dh = 2 * d_out + 1, 8 * (2 * d_out + 1)
        cost = (n, K, cfg.pairs, d_out, cfg.heads, Dh, ops['sh'].shape[-1],
                prefix, 2, peaks)
        bound_ms, bound_by, flops, _ = flash_cost(*cost, convs=1)
        untied_bound_ms = flash_cost(*cost)[0]
        row = dict(d_out=d_out, P=P, IF=ops['wv'].shape[1], n=n, K=K,
                   prefix=prefix, h_dtype='bfloat16', tie=True,
                   max_abs_err=err, max_abs_plain=scale, rel_err=err / scale,
                   ms=float(np.mean(ms)), ms_runs=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   untied_ms=float(np.mean(untied_ms)),
                   untied_ms_runs=untied_ms, untied_bound_ms=untied_bound_ms,
                   tflops=flops / np.mean(ms) / 1e9)
        rows.append(row)
        log('flash_tie', json.dumps(row))
        del ops, uops
        torch.cuda.empty_cache()
    return rows, worst


def so2_frames(gen, n, K):
    """Packed so2 frames [1, n, K, 16] (degree 3) of random offsets, slot 0
    of every node on the +z pole and slot 1 at zero length (the identity
    frame of a padded edge)."""
    from se3_transformer_torch.kernels import flash as kf
    from se3_transformer_torch.so2.frames import edge_frames
    rel = torch.randn(1, n, K, 3, device='cuda', generator=gen)
    rel[0, :, 0] = torch.tensor([0., 0., 1.5], device='cuda')
    rel[0, :, 1] = 0.
    return kf.pack_frames(edge_frames(rel, 3)).contiguous()


def check_twice(label, run, plain, rtol):
    """A kernel call against its plain version: the same bits on a repeat,
    finite, within rtol of max|plain|. Returns (error, max|plain|)."""
    out, again = run(), run()
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f'{label}: two runs differ')
    ref = plain()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if not (torch.isfinite(out).all() and err <= rtol * scale):
        raise AssertionError(f'{label}: max_abs_err {err} > {rtol} * '
                             f'max|plain| {scale}')
    return err, scale


def phase_flash_so2(peaks):
    """Kernel #7's so2 arm (conv_backend='so2': each edge's basis from its
    frame) against the so2 plain stream at the four flagship_fast output
    degrees with the [null, self] prefix (n 1024, K 32, heads 8 of 8, four
    input degrees of 64 channels, bf16 h; a pole and a zero-length slot a
    node): within KERNEL_RTOL of max|plain|, the same bits on a repeat;
    its time beside the dense arm's on the same operands (dense, so2, so2,
    dense: one cuda_ms each), the so2 and dense bounds. Then the tied so2
    variant at d_out 3, logged. Returns the untied rows and the worst
    error."""
    from se3_transformer_torch.kernels import flash as kf
    gen = torch.Generator(device='cuda').manual_seed(23)
    n, K, prefix = 1024, 32, 2
    rows, worst = [], 0.0
    for d_out, tie in [(d, False) for d in range(4)] + [(3, True)]:
        dcfg, dops = flash_operands(gen, n, K, d_out, torch.bfloat16, prefix)
        cfg = dcfg._replace(arm_v='so2', arm_k='so2')
        ops = dict(dops, sh=None, fr=so2_frames(gen, n, K))
        if tie:
            (cfg, ops), (dcfg, dops) = tied(cfg, ops), tied(dcfg, dops)
        label = f'flash so2 d_out={d_out}{" tie" if tie else ""}'
        err, scale = check_twice(
            label, lambda: kf.flash_attention_fwd(cfg, ops),
            lambda: kf.flash_attention_plain(cfg, ops), KERNEL_RTOL)
        worst = max(worst, err)
        dense_ms = [cuda_ms(lambda: kf.flash_attention_fwd(dcfg, dops),
                            reps=5)]
        ms = [cuda_ms(lambda: kf.flash_attention_fwd(cfg, ops), reps=5)
              for _ in range(2)]
        dense_ms.append(cuda_ms(lambda: kf.flash_attention_fwd(dcfg, dops),
                                reps=5))
        plain_ms = cuda_ms(lambda: kf.flash_attention_plain(cfg, ops), reps=2)
        P, Dh = 2 * d_out + 1, 8 * (2 * d_out + 1)
        convs = 1 if tie else 2
        bound_ms, bound_by, flops, _ = flash_cost(
            n, K, cfg.pairs, d_out, cfg.heads, Dh, ops['fr'].shape[-1],
            prefix, 2, peaks, convs=convs, arm='so2')
        dense_bound_ms = flash_cost(
            n, K, cfg.pairs, d_out, cfg.heads, Dh, dops['sh'].shape[-1],
            prefix, 2, peaks, convs=convs)[0]
        row = dict(d_out=d_out, P=P, IF=ops['wv'].shape[1], n=n, K=K,
                   prefix=prefix, h_dtype='bfloat16', arm='so2', tie=tie,
                   max_abs_err=err, max_abs_plain=scale, rel_err=err / scale,
                   ms=float(np.mean(ms)), ms_runs=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   dense_ms=float(np.mean(dense_ms)), dense_ms_runs=dense_ms,
                   dense_bound_ms=dense_bound_ms,
                   tflops=flops / np.mean(ms) / 1e9)
        if not tie:
            rows.append(row)
        log('flash_so2', json.dumps(row))
        del ops, dops
        torch.cuda.empty_cache()
    return rows, worst


def phase_flash_q(peaks):
    """#7's scaled arm (quantized serving: wv_scale, wk_scale) against its
    plain stream at the four flagship_fast output degrees (n 1024, K 32,
    bf16 h; the self slot, or [null, self] when tied), int8 and fp8, dense
    and so2, untied and tied: each within QUANT_RTOL of max|plain| and the
    same bits on a repeat; its time, its bound, its plain stream's, and the
    float arm's on the same operands (the dequantized weights). Returns the
    rows of the served variant (fp8, dense, untied) for the kernels line,
    all rows, and the worst error."""
    from se3_transformer_torch.kernels import flash as kf
    gen = torch.Generator(device='cuda').manual_seed(33)
    n, K = 1024, 32
    rows, worst = [], 0.0
    for storage in ('int8', 'fp8_e4m3'):
        for arm in ('dense', 'so2'):
            for tie in (False, True):
                for d_out in range(4):
                    prefix = 2 if tie else 1
                    cfg, ops = flash_operands(gen, n, K, d_out,
                                              torch.bfloat16, prefix)
                    if arm == 'so2':
                        cfg = cfg._replace(arm_v='so2', arm_k='so2')
                        ops = dict(ops, sh=None, fr=so2_frames(gen, n, K))
                    if tie:
                        cfg, ops = tied(cfg, ops)
                    float_ops = dict(ops)
                    for c in ('v',) if tie else ('k', 'v'):
                        q, sc = quantized(ops[f'w{c}'], storage)
                        ops[f'w{c}'], ops[f'w{c}_scale'] = q, sc
                        float_ops[f'w{c}'] = q.float() * sc
                    label = (f'flash_q {storage} {arm} '
                             f'{"tie " if tie else ""}d_out={d_out}')

                    def run():
                        return kf.flash_attention_fwd(cfg, ops)

                    def plain():
                        return kf.flash_attention_plain(cfg, ops)
                    err, scale = check_twice(label, run, plain, QUANT_RTOL)
                    worst = max(worst, err)
                    ms = cuda_ms(run, reps=3)
                    unscaled_ms = cuda_ms(
                        lambda: kf.flash_attention_fwd(cfg, float_ops), reps=3)
                    plain_ms = cuda_ms(plain, reps=1, warmup=0)
                    payload = ops['fr' if arm == 'so2' else 'sh']
                    bound_ms, bound_by, _, _ = flash_cost(
                        n, K, cfg.pairs, d_out, cfg.heads, 8 * (2 * d_out + 1),
                        payload.shape[-1], prefix, 2, peaks,
                        convs=1 if tie else 2, arm=arm, scaled=True)
                    row = dict(storage=storage, arm=arm, tie=tie, d_out=d_out,
                               n=n, K=K, prefix=prefix, h_dtype='bfloat16',
                               max_abs_err=err, max_abs_plain=scale, ms=ms,
                               plain_ms=plain_ms, unscaled_ms=unscaled_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=None)
                    rows.append(row)
                    log('flash_q', json.dumps(row))
                    del ops, float_ops
                    torch.cuda.empty_cache()
                block = rows[-4:]
                log('flash_q', json.dumps(dict(
                    block='four output degrees', storage=storage, arm=arm,
                    tie=tie, **{k: sum(r[k] for r in block) for k in (
                        'ms', 'plain_ms', 'unscaled_ms', 'bound_ms')})))
    served = [r for r in rows if (r['storage'], r['arm'], r['tie'])
              == ('fp8_e4m3', 'dense', False)]
    return served, rows, worst


def phase_bx(st, peaks):
    """Kernel #2 on its path: one hidden ConvSE3 of flagship_fast (4
    degrees of 64 channels, bf16 radial trunk, fuse_basis, conditioned
    weights) given get_basis's structured 'pqf' basis at n 1024, k 32 (E =
    32768), with the counts reset just before and read just after: 16
    launches of #2 and none of any other kernel. The conv is held against
    the same conv given the flat basis (kernel #1: the same tile, so the
    same bits), each of its 16 pair contractions against the plain version
    (bf16 trunk, and one pair in float32 at 1e-5), and one backward
    through the custom op against autograd through the plain version.
    Returns (rows, worst error, the path's launches)."""
    from se3_transformer_torch.kernels import pairwise as kp
    from se3_transformer_torch.models.se3_transformer import init_parameters
    from se3_transformer_torch.utils.helpers import batched_index_select
    gen = torch.Generator(device='cuda').manual_seed(13)
    n, k, C, mid = 1024, 32, 64, 128
    fiber = st.Fiber.create(4, C)
    conv = st.ConvSE3(fiber, fiber, fuse_basis=True, radial_bf16=True,
                      shared_radial_hidden=True)
    init_parameters(conv, torch.Generator().manual_seed(13))
    conv = condition_weights(conv.cuda())
    feats = {str(d): torch.randn(1, n, C, 2 * d + 1, device='cuda',
                                 generator=gen) for d in range(4)}
    idx = torch.randint(0, n, (1, n, k), device='cuda', generator=gen)
    mask = torch.rand(1, n, k, device='cuda', generator=gen) > 0.05
    rel = torch.randn(1, n, k, 3, device='cuda', generator=gen) * 4.0
    rel_dist = rel.norm(dim=-1)
    basis, flat = (st.get_basis(rel, 3, layout=lay)
                   for lay in ('pqf', 'pfq_flat'))

    def forward(b):
        with torch.inference_mode():
            return conv(feats, (idx, mask, None), rel_dist, b)
    reset_counts()
    out = forward(basis)
    torch.cuda.synchronize()
    launched = counts()
    want = tuple(16 if name == 'bx' else 0 for name in COUNT_NAMES)
    if launched != want:
        raise AssertionError(f'bx conv: launches {COUNT_NAMES} = {launched}, '
                             f'want {want}')
    out_flat = forward(flat)
    conv_ms = cuda_ms(lambda: forward(basis), reps=5)
    torch.cuda.synchronize()
    flat_err = max(float((out[d] - out_flat[d]).abs().max()) for d in out)
    if flat_err != 0:
        raise AssertionError(f'bx conv vs the flat basis: {flat_err}, '
                             f'want the same bits (one tile)')

    # the 16 pair contractions on the conv's own operands
    with torch.inference_mode():
        hidden = conv.radial_hidden(rel_dist[..., None]).reshape(-1, mid)
    E = hidden.shape[0]
    rows, worst = [], 0.0
    cases = [(di, do, torch.bfloat16) for di in range(4) for do in range(4)]
    cases.append((3, 3, torch.float32))
    for di, do, hdt in cases:
        P, Q, F = 2 * do + 1, 2 * di + 1, 2 * min(di, do) + 1
        h = hidden.float().to(hdt).contiguous()
        w3 = getattr(conv, f'w3_{di}_{do}').detach().to(hdt).contiguous()
        b3 = getattr(conv, f'b3_{di}_{do}').detach()
        bp = basis[f'{di},{do}'].reshape(E, P, Q, F).contiguous()
        x = batched_index_select(feats[str(di)], idx, dim=1).reshape(
            E, C, Q).contiguous()
        args = (h, w3, bp, x, b3)
        got = kp.fused_pairwise_conv_bx(*args)
        torch.cuda.synchronize()
        ref = kp.fused_pairwise_conv_bx_plain(*args)
        err = float((got - ref).abs().max())
        ref_max = float(ref.abs().max())
        tol = KERNEL_RTOL if hdt == torch.bfloat16 else F32_RTOL
        if not (np.isfinite(err) and err <= tol * ref_max):
            raise AssertionError(f'bx ({di},{do}) {hdt}: max_abs_err {err} > '
                                 f'{tol} * max|plain| {ref_max}')
        worst = max(worst, err)
        bound_ms, bound_by, flops, _ = pairwise_cost(
            E, mid, C, 64, P, Q, F, 2 if hdt == torch.bfloat16 else 4, peaks)
        ms = cuda_ms(lambda: kp.fused_pairwise_conv_bx(*args), reps=10)
        lib = (*radial_library(h, w3, b3), torch.einsum(
            'epqf,ecq->epcf', bp, x).reshape(E, P, C * F))
        library_ms = cuda_ms(lambda: library_conv(*lib), reps=3)
        del lib
        row = dict(pair=[di, do], E=E, h_dtype=str(hdt).split('.')[-1],
                   max_abs_err=err, max_abs_plain=ref_max, ms=ms,
                   plain_ms=cuda_ms(lambda: kp.fused_pairwise_conv_bx_plain(
                       *args), reps=3), library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   tflops=flops / ms / 1e9)
        rows.append(row)
        log('bx', json.dumps(row))
        del got, ref, args
    # one backward: kernels A and B and the einsums against autograd
    # through the plain version, float32 h/w3, the (2, 1) pair
    P, Q, F = 3, 5, 3
    leaves = [hidden.float().detach(),
              conv.w3_2_1.detach().float(), conv.b3_2_1.detach(),
              basis['2,1'].reshape(E, P, Q, F).contiguous(),
              batched_index_select(feats['2'], idx, dim=1).reshape(E, C, Q)
              .contiguous()]
    g = torch.randn(E, P, 64, device='cuda', generator=gen)
    grads = []
    for fn in (kp.pairwise_contract_bx,
               lambda h, w3, b3, b, x: kp.fused_pairwise_conv_bx_plain(
                   h, w3, b, x, b3)):
        ls = [t.clone().requires_grad_() for t in leaves]
        torch.autograd.backward(fn(*ls), g)
        grads.append([t.grad for t in ls])
    bwd_err = {}
    for name, got, ref in zip(('dh', 'dw3', 'db3', 'dbasis', 'dx'), *grads):
        err = float((got - ref).abs().max())
        ref_max = float(ref.abs().max())
        bwd_err[name] = err / ref_max
        if not err <= KERNEL_RTOL * ref_max:
            raise AssertionError(f'bx backward {name}: {err} > {KERNEL_RTOL} '
                                 f'* {ref_max}')
    conv_rows = [r for r in rows if r['h_dtype'] == 'bfloat16']
    log('bx', json.dumps(dict(
        conv='hidden 4x64 -> 4x64, pqf basis', E=E, launches=launched,
        conv_forward_ms=conv_ms, flat_basis_max_abs_diff=flat_err,
        ms=sum(r['ms'] for r in conv_rows),
        plain_ms=sum(r['plain_ms'] for r in conv_rows),
        library_ms=sum(r['library_ms'] for r in conv_rows),
        bound_ms=sum(r['bound_ms'] for r in conv_rows),
        backward_rel_err=bwd_err)))
    del conv, feats, basis, flat, hidden, leaves, grads
    torch.cuda.empty_cache()
    return rows, worst, launched


# the assembly model (the JAX package's global configuration,
# tests/test_assembly.py / scripts/assembly_smoke.py) and its bucket
ASSEMBLY = dict(num_tokens=24, dim=8, depth=1, num_degrees=2,
                output_degrees=2, reduce_dim_out=True, attend_self=True,
                use_null_kv=True, heads=2, dim_head=8,
                attention_mode='global')
GLOBAL_BUCKET = 4096
GLOBAL_PAIRS = ((0, 8), (1, 8))


def phase_flash_global(peaks):
    """Kernel 7g against its plain version (the chunked stream) at the
    served shapes: n 4096 of random-walk coordinates, the last 57 nodes
    padded at the origin and masked, the [null, self] prefix slots, the
    assembly model's two input degrees of 8 channels, d_out 0 and 1;
    relative error (within F32_RTOL, the same bits on a repeat), times,
    the bound (and the all-FMA one), the weights' L2 bytes and rate, and
    TFLOP/s."""
    from se3_transformer_torch.kernels import flash as kf
    gen = torch.Generator(device='cuda').manual_seed(14)
    n, heads, dim_head, mid, pad = GLOBAL_BUCKET, 2, 8, 128, 57

    def rand(*shape, s=1.0):
        return torch.randn(*shape, device='cuda', generator=gen) * s

    def trunk():
        return (rand(1, mid), rand(1, mid, s=0.1), 1 + rand(1, mid, s=0.1),
                rand(1, mid, s=0.1), rand(mid, mid, s=mid ** -0.5),
                rand(1, mid, s=0.1), 1 + rand(1, mid, s=0.1),
                rand(1, mid, s=0.1))
    coords = torch.cumsum(rand(1, n, 3), dim=1)
    coords[:, n - pad:] = 0.
    node_mask = (torch.arange(n, device='cuda') < n - pad)[None]
    xs = tuple(rand(1, n, c, 2 * d + 1) for d, c in GLOBAL_PAIRS)
    rp_v, rp_k = trunk(), trunk()
    rows, worst = [], 0.0
    for d_out in (0, 1):
        P = 2 * d_out + 1
        O = heads * dim_head
        IF = sum(c * (2 * min(d, d_out) + 1) for d, c in GLOBAL_PAIRS)
        w = (mid * IF) ** -0.5
        ops = dict(q=rand(1, n, heads, dim_head * P), xs=xs, coords=coords,
                   rp_v=rp_v, rp_k=rp_k, wv=rand(mid, IF, O, s=w),
                   bv=rand(IF, O, s=0.1), wk=rand(mid, IF, O, s=w),
                   bk=rand(IF, O, s=0.1), node_mask=node_mask,
                   prefix_k=rand(1, n, 2, O * P),
                   prefix_v=rand(1, n, 2, O * P))
        cfg = kf.FlashConfig(pairs=GLOBAL_PAIRS, d_out=d_out, heads=heads,
                             kv_heads=heads, scale=dim_head ** -0.5,
                             prefix=2, mode='global', exclude_self=True)
        out = kf.flash_global_attention_fwd(cfg, ops)
        again = kf.flash_global_attention_fwd(cfg, ops)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f'flash_global d_out={d_out}: two runs '
                                 f'differ')
        t0 = time.perf_counter()
        ref = kf.flash_global_plain(cfg, ops)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        if not (torch.isfinite(out).all() and err <= F32_RTOL * scale):
            raise AssertionError(f'flash_global d_out={d_out}: max_abs_err '
                                 f'{err} > {F32_RTOL} * max|plain| {scale}')
        worst = max(worst, err)
        del out, again, ref
        ms = cuda_ms(lambda: kf.flash_global_attention_fwd(cfg, ops), reps=3)
        bound_ms, bound_by, flops, bound_ms_fma, w_l2_gb = global_cost(
            n, GLOBAL_PAIRS, d_out, heads, dim_head, 2, peaks)
        row = dict(d_out=d_out, P=P, IF=IF, n=n, masked=pad,
                   max_abs_err=err, max_abs_plain=scale, rel_err=err / scale,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bound_ms_fma=bound_ms_fma,
                   w_l2_gb=w_l2_gb, w_l2_tb_s=w_l2_gb / ms,
                   tflop=flops / 1e12, tflops=flops / ms / 1e9)
        rows.append(row)
        log('flash_global', json.dumps(row))
        del ops
        torch.cuda.empty_cache()
    return rows, worst


def phase_global_tie(peaks):
    """Kernel 7g's tied variant (one trunk and one radial product a tile)
    against the tied plain stream at the assembly model's served shapes
    (n 4096, the last 57 nodes masked, the [null, self] prefix, two input
    degrees of 8 channels, d_out 0 and 1): within F32_RTOL, the same bits
    on a repeat; its time beside the untied kernel's on the same operands
    (untied, tied, tied, untied), the tied and untied bounds. Returns the
    rows and the worst error."""
    from se3_transformer_torch.kernels import flash as kf
    gen = torch.Generator(device='cuda').manual_seed(22)
    n, heads, dim_head, mid, pad = GLOBAL_BUCKET, 2, 8, 128, 57

    def rand(*shape, s=1.0):
        return torch.randn(*shape, device='cuda', generator=gen) * s

    def trunk():
        return (rand(1, mid), rand(1, mid, s=0.1), 1 + rand(1, mid, s=0.1),
                rand(1, mid, s=0.1), rand(mid, mid, s=mid ** -0.5),
                rand(1, mid, s=0.1), 1 + rand(1, mid, s=0.1),
                rand(1, mid, s=0.1))
    coords = torch.cumsum(rand(1, n, 3), dim=1)
    coords[:, n - pad:] = 0.
    node_mask = (torch.arange(n, device='cuda') < n - pad)[None]
    xs = tuple(rand(1, n, c, 2 * d + 1) for d, c in GLOBAL_PAIRS)
    rp_v, rp_k = trunk(), trunk()
    rows, worst = [], 0.0
    for d_out in (0, 1):
        P, O = 2 * d_out + 1, heads * dim_head
        IF = sum(c * (2 * min(d, d_out) + 1) for d, c in GLOBAL_PAIRS)
        w = (mid * IF) ** -0.5
        uops = dict(q=rand(1, n, heads, dim_head * P), xs=xs, coords=coords,
                    rp_v=rp_v, rp_k=rp_k, wv=rand(mid, IF, O, s=w),
                    bv=rand(IF, O, s=0.1), wk=rand(mid, IF, O, s=w),
                    bk=rand(IF, O, s=0.1), node_mask=node_mask,
                    prefix_k=rand(1, n, 2, O * P),
                    prefix_v=rand(1, n, 2, O * P))
        ucfg = kf.FlashConfig(pairs=GLOBAL_PAIRS, d_out=d_out, heads=heads,
                              kv_heads=heads, scale=dim_head ** -0.5,
                              prefix=2, mode='global', exclude_self=True)
        cfg, ops = tied(ucfg, uops, ('wk', 'bk'))
        ops['rp_k'] = ()
        label = f'flash_global tie d_out={d_out}'
        out = kf.flash_global_attention_fwd(cfg, ops)
        again = kf.flash_global_attention_fwd(cfg, ops)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f'{label}: two runs differ')
        t0 = time.perf_counter()
        ref = kf.flash_global_plain(cfg, ops)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        if not (torch.isfinite(out).all() and err <= F32_RTOL * scale):
            raise AssertionError(f'{label}: max_abs_err {err} > {F32_RTOL} '
                                 f'* max|plain| {scale}')
        worst = max(worst, err)
        del out, again, ref
        untied_ms = [cuda_ms(lambda: kf.flash_global_attention_fwd(
            ucfg, uops), reps=3)]
        ms = [cuda_ms(lambda: kf.flash_global_attention_fwd(cfg, ops),
                      reps=3) for _ in range(2)]
        untied_ms.append(cuda_ms(lambda: kf.flash_global_attention_fwd(
            ucfg, uops), reps=3))
        cost = (n, GLOBAL_PAIRS, d_out, heads, dim_head, 2, peaks)
        bound_ms, bound_by, flops, _, w_l2_gb = global_cost(*cost, trunks=1)
        untied_bound_ms = global_cost(*cost)[0]
        row = dict(d_out=d_out, P=P, IF=IF, n=n, masked=pad, tie=True,
                   max_abs_err=err, max_abs_plain=scale, rel_err=err / scale,
                   ms=float(np.mean(ms)), ms_runs=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   untied_ms=float(np.mean(untied_ms)),
                   untied_ms_runs=untied_ms, untied_bound_ms=untied_bound_ms,
                   w_l2_gb=w_l2_gb, tflops=flops / np.mean(ms) / 1e9)
        rows.append(row)
        log('flash_global_tie', json.dumps(row))
        del ops, uops
        torch.cuda.empty_cache()
    return rows, worst


def phase_global_so2(peaks):
    """Kernel 7g's so2 arm (each pair's frame from its offset, the
    diagonal and the padded nodes' pairs at zero length on the identity
    frame) against the so2 plain stream at the assembly model's served
    shapes (n 4096, the last 57 nodes padded at the origin and masked, the
    [null, self] prefix, two input degrees of 8 channels, d_out 0 and 1):
    within F32_RTOL, the same bits on a repeat; its time beside the dense
    arm's on the same operands (dense, so2, so2, dense), the so2 and dense
    bounds. Then the tied so2 variant at d_out 1, logged. Returns the
    untied rows and the worst error."""
    from se3_transformer_torch.kernels import flash as kf
    gen = torch.Generator(device='cuda').manual_seed(24)
    n, heads, dim_head, mid, pad = GLOBAL_BUCKET, 2, 8, 128, 57

    def rand(*shape, s=1.0):
        return torch.randn(*shape, device='cuda', generator=gen) * s

    def trunk():
        return (rand(1, mid), rand(1, mid, s=0.1), 1 + rand(1, mid, s=0.1),
                rand(1, mid, s=0.1), rand(mid, mid, s=mid ** -0.5),
                rand(1, mid, s=0.1), 1 + rand(1, mid, s=0.1),
                rand(1, mid, s=0.1))
    coords = torch.cumsum(rand(1, n, 3), dim=1)
    coords[:, n - pad:] = 0.
    node_mask = (torch.arange(n, device='cuda') < n - pad)[None]
    xs = tuple(rand(1, n, c, 2 * d + 1) for d, c in GLOBAL_PAIRS)
    rp_v, rp_k = trunk(), trunk()
    rows, worst = [], 0.0
    for d_out, tie in ((0, False), (1, False), (1, True)):
        P, O = 2 * d_out + 1, heads * dim_head
        IF = sum(c * (2 * min(d, d_out) + 1) for d, c in GLOBAL_PAIRS)
        w = (mid * IF) ** -0.5
        dops = dict(q=rand(1, n, heads, dim_head * P), xs=xs, coords=coords,
                    rp_v=rp_v, rp_k=rp_k, wv=rand(mid, IF, O, s=w),
                    bv=rand(IF, O, s=0.1), wk=rand(mid, IF, O, s=w),
                    bk=rand(IF, O, s=0.1), node_mask=node_mask,
                    prefix_k=rand(1, n, 2, O * P),
                    prefix_v=rand(1, n, 2, O * P))
        dcfg = kf.FlashConfig(pairs=GLOBAL_PAIRS, d_out=d_out, heads=heads,
                              kv_heads=heads, scale=dim_head ** -0.5,
                              prefix=2, mode='global', exclude_self=True)
        if tie:
            dcfg, dops = tied(dcfg, dops, ('wk', 'bk'))
            dops['rp_k'] = ()
        cfg, ops = dcfg._replace(arm_v='so2', arm_k='so2'), dops
        label = f'flash_global so2 d_out={d_out}{" tie" if tie else ""}'
        t0 = time.perf_counter()
        err, scale = check_twice(
            label, lambda: kf.flash_global_attention_fwd(cfg, ops),
            lambda: kf.flash_global_plain(cfg, ops), F32_RTOL)
        torch.cuda.synchronize()
        check_s = time.perf_counter() - t0
        worst = max(worst, err)
        t0 = time.perf_counter()
        kf.flash_global_plain(cfg, ops)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        dense_ms = [cuda_ms(lambda: kf.flash_global_attention_fwd(
            dcfg, dops), reps=3)]
        ms = [cuda_ms(lambda: kf.flash_global_attention_fwd(cfg, ops),
                      reps=3) for _ in range(2)]
        dense_ms.append(cuda_ms(lambda: kf.flash_global_attention_fwd(
            dcfg, dops), reps=3))
        cost = (n, GLOBAL_PAIRS, d_out, heads, dim_head, 2, peaks)
        trunks = 1 if tie else 2
        bound_ms, bound_by, flops, _, w_l2_gb = global_cost(
            *cost, trunks=trunks, arm='so2')
        dense_bound_ms = global_cost(*cost, trunks=trunks)[0]
        row = dict(d_out=d_out, P=P, IF=IF, n=n, masked=pad, arm='so2',
                   tie=tie, max_abs_err=err, max_abs_plain=scale,
                   rel_err=err / scale, ms=float(np.mean(ms)), ms_runs=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   dense_ms=float(np.mean(dense_ms)), dense_ms_runs=dense_ms,
                   dense_bound_ms=dense_bound_ms, w_l2_gb=w_l2_gb,
                   check_s=check_s, tflops=flops / np.mean(ms) / 1e9)
        if not tie:
            rows.append(row)
        log('flash_global_so2', json.dumps(row))
        del ops, dops
        torch.cuda.empty_cache()
    return rows, worst


def phase_global_serve(st, want, label='assembly', **fields):
    """The assembly model (seeded weights, conditioned; `fields` change
    its fields, `label` names it in the lines) served through
    InferenceEngine(buckets=(4096,)) with return_type=1 on requests of
    4096, 4039 and 3000 nodes (token sequences on random-walk chains):
    per request the latency, exactly `want` launches (COUNT_NAMES order),
    peak memory, and a profiled run's device busy time, idle share and
    host syncs; rotation equivariance of the vector output on the
    4039-node request. Returns the launches of the whole phase."""
    from se3_transformer_torch.so3 import rot
    rng = np.random.RandomState(15)
    model = condition_weights(st.SE3TransformerModule(
        **dict(ASSEMBLY, **fields),
        generator=torch.Generator().manual_seed(15)))
    engine = st.InferenceEngine(model, buckets=(GLOBAL_BUCKET,),
                                return_type=1)
    requests = [(rng.randint(0, 24, n), chain_coords(rng, n))
                for n in (4096, 4039, 3000)]

    reset_counts()
    engine.predict(*requests[1])    # warm-up: allocator, cuBLAS handles
    forwards = 1
    outs, rows = [], []
    for i, (tokens, coords) in enumerate(requests):
        before = counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = engine.predict(tokens, coords)
        dt = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        forwards += 1
        launched = tuple(a - b for a, b in zip(counts(), before))
        n = len(tokens)
        if out.shape != (n, 3) or not np.isfinite(out).all():
            raise AssertionError(f'{label} request {i}: shape {out.shape} '
                                 f'or non-finite output')
        if launched != want:
            raise AssertionError(f'{label} request {i}: launches '
                                 f'{COUNT_NAMES} = {launched}, want {want}')
        outs.append(out)
        rows.append(dict(model=label, request=i, n=n, bucket=GLOBAL_BUCKET,
                         latency_ms=dt * 1e3, nodes_per_s=n / dt,
                         launches=launched, max_memory_allocated_gb=peak_gb))
    # where the time goes: each request once more under the profiler,
    # after the timed ones. A request right after a profiler session takes
    # ~300 ms more host time (device time unchanged): one unmeasured
    # request absorbs it before the next measurement.
    settle_ms = []
    for row, request in zip(rows, requests):
        _, _, attn_ms, device_ms, wall_ms, syncs, _, _ = profile_request(
            engine, request)
        t0 = time.perf_counter()
        engine.predict(*request)
        settle_ms.append((time.perf_counter() - t0) * 1e3)
        forwards += 3
        log('global_serve', json.dumps(dict(
            row, profiled_wall_ms=wall_ms, device_busy_ms=device_ms,
            global_kernel_ms=attn_ms, idle_share=1 - device_ms / wall_ms,
            host_syncs_per_forward=syncs)))
    # rotation equivariance of the vector output (rotation in float64)
    R = rot(0.37, 1.12, -0.64)
    tokens, coords = requests[1]
    out_r = engine.predict(tokens, (coords.astype(np.float64) @ R)
                           .astype(np.float32))
    forwards += 1
    err = float(np.sqrt(((out_r.astype(np.float64)
                          - outs[1].astype(np.float64) @ R) ** 2)
                        .sum(-1)).max())
    scale = float(np.abs(outs[1]).max())
    launches = counts()
    if launches != tuple(w * forwards for w in want):
        raise AssertionError(f'{label} serve: launches {launches} for '
                             f'{forwards} forwards')
    log('global_serve', json.dumps(dict(
        model=label, equivariance_l2=err, max_abs_out=scale,
        rtol=ROTATION_RTOL,
        latency_ms_after_profiler=settle_ms, forwards=forwards, launches=launches, stats=engine.stats())))
    if not err <= ROTATION_RTOL * scale:
        raise AssertionError(f'{label} serve: equivariance {err} > '
                             f'{ROTATION_RTOL} * max|out| {scale}')
    del engine, model
    torch.cuda.empty_cache()
    return launches


def phase_global_reference(st):
    """The assembly model at n = 64 (5 padded), with tied keys and values,
    and with conv_backend='so2', on the card (kernel 7g) and on the CPU
    (the plain stream) from the same weights."""
    for fields in (dict(), dict(tie_key_values=True),
                   dict(conv_backend='so2')):
        global_reference(st, **fields)


def global_reference(st, **fields):
    """One assembly model (`fields` changed) at n = 64 (5 padded) on the
    card and on the CPU from the same weights: the vector output, then
    one backward (the replay of the plain stream, on the card's cuBLAS)
    and every parameter's gradient."""
    rng = np.random.RandomState(16)
    n = 64
    tokens = rng.randint(0, 24, (1, n))
    coords = chain_coords(rng, n)[None]
    mask = np.arange(n)[None] < n - 5
    target = rng.normal(size=(1, n, 3)).astype(np.float32)
    results = []
    for device in ('cuda', 'cpu'):
        model = condition_weights(st.SE3TransformerModule(
            **dict(ASSEMBLY, **fields), device=device,
            generator=torch.Generator().manual_seed(17)))
        args = [torch.as_tensor(a, device=device)
                for a in (tokens, coords, mask)]
        out = model(*args, return_type=1)
        ((out - torch.as_tensor(target, device=device)) ** 2).sum().backward()
        results.append((out.detach().cpu().numpy(),
                        {k: p.grad.cpu() for k, p in model.named_parameters()
                         if p.grad is not None}))
    (out_c, grads_c), (out_h, grads_h) = results
    err = float(np.abs(out_c - out_h).max())
    scale = float(np.abs(out_h).max())
    worst, worst_key = 0.0, None
    if set(grads_c) != set(grads_h):
        raise AssertionError('global reference: card and CPU differ in which '
                             'parameters have gradients')
    for key, ref in grads_h.items():
        rel = float((grads_c[key] - ref).abs().max()) / max(
            float(ref.abs().max()), 1e-30)
        if not np.isfinite(rel):
            raise AssertionError(f'global reference: {key} not finite')
        if rel > worst:
            worst, worst_key = rel, key
    log('global_reference', json.dumps(dict(
        n=n, fields=fields, max_abs_err=err, max_abs_cpu=scale,
        rtol=REF_RTOL_F32,
        worst_grad_rel_err=worst, worst_grad=worst_key, leaves=len(grads_h),
        grad_rtol=REF_GRAD_RTOL_F32)))
    if not (np.isfinite(out_c).all() and err <= REF_RTOL_F32 * scale):
        raise AssertionError(f'global card vs CPU: {err} > {REF_RTOL_F32} * '
                             f'{scale}')
    if worst > REF_GRAD_RTOL_F32:
        raise AssertionError(f'global card vs CPU gradient {worst_key}: '
                             f'{worst} > {REF_GRAD_RTOL_F32}')


def chain_coords(rng, n, bonds=(3.8,)):
    """A random-walk chain whose steps cycle through `bonds` in length:
    3.8-unit steps (a CA trace's shape), or the N-CA, CA-C and C-N bonds of
    an N/CA/C backbone (BACKBONE_BONDS). With one step length every node
    has its two chain neighbors at the same distance, so a neighbor count
    that cuts between them (k = 12 can) picks one by rounding, and a
    rotation may pick the other."""
    steps = rng.normal(size=(n, 3))
    lengths = np.resize(np.asarray(bonds, np.float64), n)[:, None]
    steps *= lengths / np.linalg.norm(steps, axis=-1, keepdims=True)
    return np.cumsum(steps, axis=0).astype(np.float32)


# an N/CA/C protein backbone's bond lengths (N-CA, CA-C, C-N), in the
# units of chain_coords
BACKBONE_BONDS = (1.458, 1.525, 1.329)


def condition_weights(model, power=-0.5):
    """Scale every ConvSE3's w3_{d_in}_{d_out} (or its pair_{d_in}_{d_out}'s
    w3, without the shared trunk) by 1/sqrt(sum over d_in of c_in * F): the
    contraction sums that many O(1) terms, so with the
    flax-scheme init each conv multiplies the residual stream by ~20 and a
    depth-6 model is chaotic (float32 rounding differences between two
    rotations of the input grow to ~10% of the output). Conditioned, the
    output stays O(1) and rotation invariance is measurable. power=+0.5
    undoes it. A V2ConvSE3's per-m blocks wm{m}_{d_in}_{d_out} are scaled
    alike, by 1/sqrt of their (d_out, m) contraction's width."""
    from se3_transformer_torch.ops.conv import ConvSE3
    from se3_transformer_torch.utils.helpers import to_order
    from se3_transformer_torch.v2 import V2ConvSE3
    with torch.no_grad():
        for conv in model.modules():
            if isinstance(conv, V2ConvSE3):
                for d_out, _ in conv.fiber_out:
                    for m in range(conv.band_order(d_out) + 1):
                        blocks = [getattr(conv, f'wm{m}_{d_in}_{d_out}')
                                  for d_in, _ in conv._reaching(d_out, m)]
                        fan = sum(w.shape[1] for w in blocks)
                        for w in blocks:
                            w.mul_(fan ** power)
            if not isinstance(conv, ConvSE3):
                continue
            for d_out, _ in conv.fiber_out:
                fan = sum(c * to_order(min(d_in, d_out))
                          for d_in, c in conv.fiber_in)
                for d_in, _ in conv.fiber_in:
                    w3 = getattr(conv, f'w3_{d_in}_{d_out}') \
                        if conv.shared_radial_hidden \
                        else getattr(conv, f'pair_{d_in}_{d_out}').w3
                    w3.mul_(fan ** power)
    return model


def weight_bytes(module, device=None):
    """Bytes of a module's parameters and buffers (its QuantTensors' q and
    scale included), those on `device` alone when it is given."""
    return sum(t.numel() * t.element_size()
               for t in (*module.parameters(), *module.buffers())
               if device is None or t.device.type == device)


def phase_serve(st, recipe, want, label=None, dim=64, depth=DEPTH,
                vector=False, bonds=(3.8,), precision=None, module=None,
                rotation_rtol=ROTATION_RTOL, **fields):
    """A recipe's forward at full size (dim=64, depth=6, 4 degrees, 8 heads,
    k=32 for the flagship recipes; `dim`, `depth` and `fields` set or add
    model fields; random seeded weights, conditioned) served by
    InferenceEngine at bucket 1024 on chain_coords of `bonds`: finite
    outputs, exactly `want`
    launches (COUNT_NAMES order) and no routed call per request, rotation
    invariance
    of the scalar output (with `vector`, equivariance of the vector
    output), a profile. With `precision` (a quant mix) the model is built
    on the host and the engine quantizes it before placing it: its
    parameter bytes on the device against the same weights in float32
    (at most QUANT_MAX_BYTES_RATIO), and a `quant_serve` line with the
    requests, busy, top kernels, idle share and peak memory. The rotation
    check holds to `rotation_rtol` of max|out|. `module` builds a model
    that is not a recipe (the V2 family), with the recipe's arguments.
    Returns the launches of the whole phase."""
    from se3_transformer_torch.so3 import rot
    recipe, name = label or recipe, recipe
    rng = np.random.RandomState(0)
    build = dict(device='cpu') if precision else {}
    model = condition_weights((module or getattr(st, name))(
        dim=dim, depth=depth, generator=torch.Generator().manual_seed(0),
        **build, **fields))
    fp32_bytes = weight_bytes(model)
    torch.cuda.reset_peak_memory_stats()
    allocated = torch.cuda.memory_allocated()
    engine = st.InferenceEngine(model, buckets=(1024,), precision=precision)
    if precision:
        quant_bytes = weight_bytes(engine.module, 'cuda')
        placed = dict(
            recipe=recipe, precision=precision,
            param_bytes_device=quant_bytes, param_bytes_fp32=fp32_bytes,
            ratio=quant_bytes / fp32_bytes,
            allocated_bytes=torch.cuda.memory_allocated() - allocated,
            report=engine.quant_report)
        log('quant_placed', json.dumps(placed))
        if weight_bytes(engine.module, 'cpu') or \
                placed['ratio'] > QUANT_MAX_BYTES_RATIO:
            raise AssertionError(f'{recipe}: quantized parameter bytes on '
                                 f'the device {placed}')
    requests = [(rng.normal(size=(n, dim)).astype(np.float32),
                 chain_coords(rng, n, bonds)) for n in (1024, 1000, 700)]
    R = rot(0.31, -1.2, 0.7)

    def rotated(out):
        return out.astype(np.float64) @ R.T if vector else out

    reset_counts()
    engine.predict(*requests[0])    # warm-up: allocator, cuBLAS handles
    forwards = 1
    results = []
    for i, (feats, coords) in enumerate(requests):
        before, routed_before = counts(), routed()
        t0 = time.perf_counter()
        out = engine.predict(feats, coords)
        dt = time.perf_counter() - t0
        forwards += 1
        launched = tuple(a - b for a, b in zip(counts(), before))
        routes = tuple(a - b for a, b in zip(routed(), routed_before))
        n = len(feats)
        if out.shape != (n, 3 if vector else dim) or \
                not np.isfinite(out).all():
            raise AssertionError(f'{recipe} request {i}: shape {out.shape} '
                                 f'or non-finite output')
        if launched != want or routes != NO_ROUTES:
            raise AssertionError(f'{recipe} request {i}: launches '
                                 f'{COUNT_NAMES} = {launched}, want {want}; '
                                 f'routed {ROUTE_NAMES} = {routes}')
        row = dict(recipe=recipe, request=i, n=n, bucket=1024,
                   latency_ms=dt * 1e3, nodes_per_s=n / dt,
                   launches=launched, routed=routes)
        results.append((out, row))
        log('serve', json.dumps(row))
    # rotation invariance of the scalar output, or equivariance of the
    # vector one (rotation in float64)
    feats, coords = requests[0]
    coords_r = (coords.astype(np.float64) @ R.T).astype(np.float32)
    out_r = engine.predict(feats, coords_r)
    forwards += 1
    out0 = results[0][0]
    inv = float(np.abs(out_r - rotated(out0)).max())
    scale = float(np.abs(out0).max())
    # where the time goes: one more request under the profiler
    top, kernel_ms, attn_ms, device_ms, wall_ms, syncs, us, _ = \
        profile_request(engine, requests[0])
    forwards += 2
    log('profile', json.dumps(dict(
        recipe=recipe, request_wall_ms=wall_ms, device_busy_ms=device_ms,
        pairwise_kernel_ms=kernel_ms, attention_kernel_ms=attn_ms,
        attention_us_per_launch=us, host_syncs_per_forward=syncs,
        top_device_ops=top)))
    if precision:
        log('quant_serve', json.dumps(dict(
            recipe=recipe, precision=precision,
            request_ms=[r['latency_ms'] for _, r in results],
            request_wall_ms=wall_ms, device_busy_ms=device_ms,
            idle_share=1 - device_ms / wall_ms,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            param_bytes_device=placed['param_bytes_device'],
            param_bytes_fp32=fp32_bytes, bytes_ratio=placed['ratio'],
            rotation_max_abs_diff=inv, max_abs_out=scale,
            host_syncs=syncs, sync_ops=LAST_SYNCS, top_device_ops=top[:6])))
    else:
        # the flax-scheme weights (conditioning undone): chaotic at depth
        # 6, reported, not asserted
        condition_weights(model, power=0.5)
        raw, raw_r = (engine.predict(feats, c) for c in (coords, coords_r))
        forwards += 2
        log('serve', json.dumps(dict(
            recipe=recipe, flax_scheme_weights=True,
            max_abs_out=float(np.abs(raw).max()),
            rotation_max_abs_diff=float(np.abs(raw_r - rotated(raw)).max()))))
    launches = counts()
    if launches != tuple(w * forwards for w in want):
        raise AssertionError(f'{recipe}: launches {launches} for {forwards} '
                             f'forwards')
    routed_exactly(recipe, NO_ROUTES)
    if inv > rotation_rtol * scale:
        raise AssertionError(f'{recipe}: rotation invariance {inv} > '
                             f'{rotation_rtol} * max|out| {scale}')
    log('serve', json.dumps(dict(recipe=recipe, rotation_max_abs_diff=inv,
                                 max_abs_out=scale, forwards=forwards,
                                 launches=launches,
                                 peak_gb=torch.cuda.max_memory_allocated()
                                 / 1e9, stats=engine.stats())))
    del engine, model
    torch.cuda.empty_cache()
    return launches


# serve_stream: the serving stack (AdmissionController -> MicroBatcher ->
# InferenceEngine.run under ServeTelemetry and a MetricLogger) over a
# mixed-length stream: flagship_fast at buckets (512, 1024), batch 1, with
# one weight swap mid-stream; af2_refinement on an N/CA/C backbone at
# buckets (256, 512, 1024), batch 2
STREAM_MODELS = (
    dict(label='flagship_fast', recipe='flagship_fast', buckets=(512, 1024),
         batch=1, dim=64, depth=DEPTH, bonds=(3.8,), swap=True),
    dict(label='af2_refinement', recipe='af2_refinement',
         buckets=(256, 512, 1024), batch=2, dim=AF2_DIM, depth=2,
         bonds=BACKBONE_BONDS, swap=False))
STREAM_REQUESTS = 12
STREAM_WAIT_MS = 20.0


def stream_lengths(rng, buckets, count=STREAM_REQUESTS):
    """Lengths cycling across the buckets (each in its own bucket), and one
    oversize request in the middle."""
    lows = [1] + [b + 1 for b in buckets[:-1]]
    lengths = [int(rng.randint(lows[i % len(buckets)],
                               buckets[i % len(buckets)] + 1))
               for i in range(count)]
    lengths.insert(count // 2 - 1, buckets[-1] + 7)
    return lengths


def phase_serve_stream(st, want_by_label):
    """Each STREAM_MODELS model (seeded weights, conditioned) served through
    AdmissionController -> MicroBatcher -> InferenceEngine.run under
    ServeTelemetry and a MetricLogger writing JSONL to a temporary
    directory: STREAM_REQUESTS requests whose lengths cycle across the
    buckets and one oversize request, which must be rejected. Checks: every
    admitted request answered; each answer equal to the request served
    alone by predict within REF_RTOL_F32 of max|out|; post_warmup_compiles
    0 (and no one-time work for the rest of the phase); the stream valid
    under the port's schema; exactly `want_by_label[label]` launches a
    batch (COUNT_NAMES order) and nothing routed. flagship_fast swaps to a
    second seeded state after half the stream: its later answers equal a
    fresh engine's on that state bit for bit, and the swap's peak memory
    growth stays under half the parameter bytes. Prints warmup seconds and
    measured peak bytes per bucket, p50/p95/p99 per bucket, queue wait,
    batch fill, launches per batch and per request, and a profiled batch's
    device busy and idle share (after the timed requests). Returns the
    launches of the whole phase."""
    import tempfile
    from se3_transformer_torch import inference as inf
    from se3_transformer_torch.observability import MetricLogger
    from se3_transformer_torch.observability.schema import validate_stream
    from se3_transformer_torch.utils.helpers import ONE_TIME_WORK
    tmp = tempfile.TemporaryDirectory(prefix='serve_stream')
    reset_counts()
    for spec in STREAM_MODELS:
        label, buckets, dim = spec['label'], spec['buckets'], spec['dim']
        rng = np.random.RandomState(22)
        model = condition_weights(getattr(st, spec['recipe'])(
            dim=dim, depth=spec['depth'],
            generator=torch.Generator().manual_seed(0)))
        state1 = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
        events0 = ONE_TIME_WORK[0]
        engine = st.InferenceEngine(model, buckets=buckets,
                                    batch_size=spec['batch'])
        warmup_events = ONE_TIME_WORK[0] - events0
        param_bytes = weight_bytes(engine.module, 'cuda')
        # the runner, timed at its start: queue wait = batch start - submit
        starts = []

        def runner(bucket, *batch):
            starts.append(time.monotonic())
            return engine.run(bucket, *batch)

        admission = inf.AdmissionController(max_len=engine.max_len,
                                            max_queue_depth=64)
        batcher = inf.MicroBatcher(runner, buckets=buckets,
                                   batch_size=spec['batch'],
                                   max_wait_ms=STREAM_WAIT_MS,
                                   admission=admission)
        path = os.path.join(tmp.name, f'{label}.jsonl')
        logger = MetricLogger(path, mirror=None, run_meta=dict(
            mode='serve_stream', model=label, buckets=list(buckets),
            batch_size=spec['batch']))
        tele = inf.ServeTelemetry(engine, batcher, admission, logger)
        tele.arm()
        lengths = stream_lengths(rng, buckets)
        requests = [(rng.normal(size=(n, dim)).astype(np.float32),
                     chain_coords(rng, n, spec['bonds'])) for n in lengths]
        before, routed_before = counts(), routed()
        pending, rejected, swap, flushed_at = [], [], None, 0
        t_stream = time.perf_counter()
        for i, (feats, coords) in enumerate(requests):
            if spec['swap'] and i == len(requests) // 2:
                batcher.drain()
                model2 = condition_weights(getattr(st, spec['recipe'])(
                    dim=dim, depth=spec['depth'], device='cpu',
                    generator=torch.Generator().manual_seed(1)))
                state2 = {k: v.clone() for k, v in model2.state_dict().items()}
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                allocated = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                engine.params = state2
                torch.cuda.synchronize()
                swap = dict(seconds=time.perf_counter() - t0,
                            peak_growth_bytes=torch.cuda.max_memory_allocated()
                            - allocated, param_bytes=param_bytes,
                            after_request=len(pending))
            try:
                pending.append((batcher.submit(feats, coords), i))
            except inf.RequestRejected as e:
                rejected.append(e.to_record())
                logger.log_record('step', mirror=False, step=i,
                                  rejected=e.to_record())
            batcher.pump()
            if batcher.batches_dispatched - flushed_at >= 2:
                tele.flush()
                flushed_at = batcher.batches_dispatched
        while batcher.queue_depth:
            time.sleep(batcher.next_deadline() or 0)
            batcher.pump()
        stream_s = time.perf_counter() - t_stream
        launched = tuple(a - b for a, b in zip(counts(), before))
        routes = tuple(a - b for a, b in zip(routed(), routed_before))
        batches = batcher.batches_dispatched
        tele.flush()
        summary = tele.close()
        logger.close()
        info = validate_stream(path)
        waits = [max(s for s in starts if s <= p.completed_at)
                 - p.submitted_at for p, _ in pending]
        answered = [p for p, _ in pending if p.ok]
        want = want_by_label[label]
        # each answer against the request served alone (pre-swap requests
        # on the first state, swapped back), and after a swap against a
        # fresh engine on the second state, bit for bit
        worst = 0.0
        fresh_equal = None
        if swap:
            later = [(p, i) for p, i in pending
                     if p.request_id >= swap['after_request']]
            fresh = st.InferenceEngine(model2, buckets=buckets,
                                       batch_size=spec['batch'])
            fresh_equal = all(np.array_equal(
                fresh.predict(*requests[i]), p.result) for p, i in later)
            del fresh, model2
        groups = [(pending, None)] if not swap else [
            ([(p, i) for p, i in pending
              if p.request_id >= swap['after_request']], None),
            ([(p, i) for p, i in pending
              if p.request_id < swap['after_request']], state1)]
        for group, state in groups:
            if state is not None:
                engine.params = state
            for p, i in group:
                alone = engine.predict(*requests[i])
                worst = max(worst, float(np.abs(alone - p.result).max())
                            / max(float(np.abs(alone).max()), 1e-30))
        # where the time goes: one batch of the largest bucket under the
        # profiler, after the timed requests
        big = [requests[i] for p, i in pending
               if p.bucket == buckets[-1]][:spec['batch']]
        padded = inf.pad_to_bucket([f for f, _ in big], [c for _, c in big],
                                   buckets[-1], batch_size=spec['batch'])
        engine.run(buckets[-1], *padded)
        prof = profile_call(lambda: engine.run(buckets[-1], *padded))
        wall_ms, busy_ms = prof.wall_ms, prof_busy_ms(prof)
        late = tele.watchdog.check()['compile_events_delta']
        stats = engine.stats()
        line = dict(
            model=label, buckets=list(buckets), batch_size=spec['batch'],
            requests=len(requests), admitted=admission.admitted,
            answered=len(answered), rejected=rejected, batches=batches,
            stream_s=stream_s, warmup_s=stats['compile_seconds'],
            warmup_one_time_events=warmup_events,
            peak_bytes_by_bucket=stats['peak_hbm_by_bucket'],
            cost={str(k[0]): v['memory'] for k, v in
                  engine.cost_payloads.items()},
            latency_by_bucket={k: {q: v[q] for q in
                                   ('count', 'p50_ms', 'p95_ms', 'p99_ms',
                                    'max_ms')}
                               for k, v in summary['timing'].items()},
            request_latency_ms=summary['metrics']['request_latency_ms'],
            queue_wait_ms=dict(mean=1e3 * float(np.mean(waits)),
                               max=1e3 * float(np.max(waits))),
            batch_fill=summary['metrics']['batch_fill'],
            launches_per_batch=tuple(n // max(batches, 1) for n in launched),
            launches_per_request=tuple(n / max(len(answered), 1)
                                       for n in launched),
            routed=routes, post_warmup_compiles=tele.post_warmup_compiles,
            one_time_events_after_stream=late, schema=info['kinds'],
            max_rel_err_vs_alone=worst, rtol=REF_RTOL_F32,
            profiled_batch=dict(bucket=buckets[-1], wall_ms=wall_ms,
                                device_busy_ms=busy_ms,
                                idle_share=1 - busy_ms / wall_ms),
            swap=swap, swap_equals_fresh_engine=fresh_equal,
            param_bytes=param_bytes)
        log('serve_stream', json.dumps(line))
        if len(rejected) != 1 or rejected[0]['code'] != 'oversize' or \
                len(answered) != len(pending) or \
                len(pending) != len(requests) - 1:
            raise AssertionError(f'serve_stream {label}: {len(answered)} of '
                                 f'{len(pending)} admitted answered, '
                                 f'rejected {rejected}')
        if launched != tuple(w * batches for w in want) or \
                routes != NO_ROUTES:
            raise AssertionError(f'serve_stream {label}: launches '
                                 f'{launched} for {batches} batches of '
                                 f'{want}; routed {routes}')
        if tele.post_warmup_compiles or late:
            raise AssertionError(f'serve_stream {label}: one-time work '
                                 f'after warmup ({tele.post_warmup_compiles}'
                                 f', then {late})')
        if not worst <= REF_RTOL_F32:
            raise AssertionError(f'serve_stream {label}: batched vs alone '
                                 f'{worst} > {REF_RTOL_F32}')
        if swap and (not fresh_equal or
                     swap['peak_growth_bytes'] >= param_bytes / 2):
            raise AssertionError(f'serve_stream {label}: swap {swap}, equal '
                                 f'to a fresh engine: {fresh_equal}')
        del engine, model
        torch.cuda.empty_cache()
    tmp.cleanup()
    return counts()


def phase_serve_cli():
    """The serve entry point at its defaults on the card, as a subprocess:
    `python -m se3_transformer_torch.inference.serve --metrics ... --out
    ...` exits 0 with a schema-valid stream and no one-time work after
    warmup."""
    import tempfile
    from se3_transformer_torch.observability.schema import validate_stream
    with tempfile.TemporaryDirectory(prefix='serve_cli') as tmp:
        metrics, out = (os.path.join(tmp, f) for f in ('serve.jsonl',
                                                       'report.json'))
        (rc, wall, stdout, stderr), = run_modules(
            [['se3_transformer_torch.inference.serve', '--metrics', metrics,
              '--out', out]], 600, tmp)
        if rc != 0:
            raise AssertionError(f'serve entry point exited {rc}:\n'
                                 f'{stdout[-3000:]}\n{stderr[-3000:]}')
        with open(out) as f:
            report = json.load(f)
        info = validate_stream(metrics)
    log('serve_cli', json.dumps(dict(
        wall_s=wall, schema=info['kinds'], **report)))
    if not report['ok'] or report['post_warmup_compiles']:
        raise AssertionError(f'serve entry point: {report}')


def run_modules(runs, timeout, tmp):
    """`python -m <args>` from the checkout for each of `runs`, all started
    at once, their output to files in `tmp`: a list of (exit code, wall
    seconds, stdout, stderr). A run past `timeout` is killed, and every
    process is gone when this returns."""
    procs = []
    try:
        for k, args in enumerate(runs):
            out = open(os.path.join(tmp, f'run{k}.out'), 'w+')
            err = open(os.path.join(tmp, f'run{k}.err'), 'w+')
            procs.append((subprocess.Popen(
                [sys.executable, '-m', *args], cwd=HERE, stdout=out,
                stderr=err, text=True), time.perf_counter(), out, err))
        results = []
        for proc, t0, out, err in procs:
            rc = proc.wait(timeout=max(1.0, t0 + timeout
                                       - time.perf_counter()))
            wall = time.perf_counter() - t0
            out.seek(0)
            err.seek(0)
            results.append((rc, wall, out.read(), err.read()))
        return results
    finally:
        for proc, _, out, err in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()


def phase_serve_multi_cli(smi):
    """The multi-replica entry and the chaos harness on the card, as three
    subprocesses run at once (gates, not timings): `python -m
    se3_transformer_torch.inference.serve --replicas 2 --async-dispatch
    --swap-at 4` exits 0 with a swap on both replicas and a schema-valid
    stream; `python -m se3_transformer_torch.serving.chaos` exits 0 and
    with `--weaken drop` exits 1."""
    import tempfile
    from se3_transformer_torch.observability.schema import validate_stream
    with tempfile.TemporaryDirectory(prefix='serve_multi_cli') as tmp:
        metrics, out = (os.path.join(tmp, f) for f in ('serve.jsonl',
                                                       'report.json'))
        arms = (('none', 0), ('drop', 1))
        chaos = {weaken: (os.path.join(tmp, f'chaos_{weaken}.json'),
                          os.path.join(tmp, f'chaos_{weaken}.jsonl'))
                 for weaken, _ in arms}
        results = run_modules(
            [['se3_transformer_torch.inference.serve', '--replicas', '2',
              '--async-dispatch', '--swap-at', '4', '--metrics', metrics,
              '--out', out]]
            + [['se3_transformer_torch.serving.chaos', '--weaken', weaken,
                '--metrics', chaos[weaken][1], '--out', chaos[weaken][0]]
               for weaken, _ in arms], 600, tmp)
        rc, wall, stdout, stderr = results[0]
        if rc != 0:
            raise AssertionError(f'serve --replicas 2 exited {rc}:\n'
                                 f'{stdout[-3000:]}\n{stderr[-3000:]}')
        with open(out) as f:
            report = json.load(f)
        info = validate_stream(metrics)
        log('serve_cli_multi', json.dumps(dict(
            card=smi, wall_s=wall, schema=info['kinds'],
            **{k: report[k] for k in (
                'ok', 'replicas', 'async_dispatch', 'precision_mixes',
                'requests', 'batches', 'continuous_admissions', 'swaps',
                'post_warmup_compiles', 'per_replica', 'latency_by_bucket',
                'request_latency_ms')})))
        if not report['ok'] or report['swaps']['count'] != 2 or \
                report['post_warmup_compiles']:
            raise AssertionError(f'serve --replicas 2: {report}')
        for (weaken, want), (rc, wall, stdout, stderr) in zip(
                arms, results[1:]):
            out, metrics = chaos[weaken]
            report = {}
            if os.path.exists(out):
                with open(out) as f:
                    report = json.load(f)
            log('chaos', json.dumps(dict(
                card=smi, weaken=weaken, rc=rc, wall_s=wall,
                **{k: report.get(k) for k in (
                    'device', 'requests', 'injections', 'recoveries',
                    'retries', 'request_failures', 'timeouts', 'swap_tag',
                    'post_warmup_compiles', 'batches',
                    'request_latency_ms')})))
            if rc != want or report.get('device', '').split(':')[0] != \
                    'cuda':
                raise AssertionError(f'chaos --weaken {weaken} exited {rc} '
                                     f'(want {want}):\n{stdout[-3000:]}\n'
                                     f'{stderr[-3000:]}')
            if weaken == 'none':
                validate_stream(metrics)


# serve_multi: flagship_fast replicas behind the router on the one card
MULTI_BUCKETS = (512, 1024)
MULTI_REQUESTS = 24
MULTI_SWAP_AT = 12
MULTI_WAIT_MS = 20.0


def union_busy_ms(prof):
    """The device's busy time of a profile: the union of its device events'
    intervals (two streams' overlapping kernels count once), and the plain
    sum of their exclusive times."""
    from se3_transformer_torch.observability import profiling
    events, selector, _ = profiling.device_events(prof)
    if selector != 'device':
        raise AssertionError(f'profile: the device time reads {selector}')
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, prof_busy_ms(prof)


def phase_serve_multi(st, want, smi):
    """flagship_fast replicas behind serving.Router on the one card (the
    docstring's serve_multi). `want` is the serve path's launches per batch
    (COUNT_NAMES order). Returns the launches of the whole phase."""
    import copy
    import tempfile
    from se3_transformer_torch import inference as inf
    from se3_transformer_torch.observability import MetricLogger, PhaseTimer
    from se3_transformer_torch.observability.schema import validate_stream
    from se3_transformer_torch.serving import (
        ReplicaWorker, Router, RouterTelemetry,
    )
    from se3_transformer_torch.utils.helpers import ONE_TIME_WORK
    tmp = tempfile.TemporaryDirectory(prefix='serve_multi')
    reset_counts()

    def host_model(seed):
        return condition_weights(st.flagship_fast(
            dim=64, depth=DEPTH, device='cpu',
            generator=torch.Generator().manual_seed(seed)))
    host = host_model(0)
    state1 = {k: v.clone() for k, v in host.state_dict().items()}
    state2 = {k: v.clone() for k, v in host_model(1).state_dict().items()}
    timer = PhaseTimer()
    engines, warm = [], []
    for i in range(2):
        # one after another, each over its own copy of the module
        t0 = time.perf_counter()
        engine = st.InferenceEngine(copy.deepcopy(host),
                                    buckets=MULTI_BUCKETS, batch_size=1,
                                    timer=timer)
        stats = engine.stats()
        warm.append(dict(replica=i, seconds=time.perf_counter() - t0,
                         bucket_s=stats['compile_seconds'],
                         peak_bytes=stats['peak_hbm_by_bucket']))
        engines.append(engine)
    reference = st.InferenceEngine(copy.deepcopy(host),
                                   buckets=MULTI_BUCKETS, batch_size=1)
    param_bytes = weight_bytes(engines[0].module, 'cuda')
    rng = np.random.RandomState(26)
    lengths = stream_lengths(rng, MULTI_BUCKETS, MULTI_REQUESTS)
    requests = [(rng.normal(size=(n, 64)).astype(np.float32),
                 chain_coords(rng, n)) for n in lengths]
    in_range = [i for i, n in enumerate(lengths) if n <= MULTI_BUCKETS[-1]]
    alone1 = {i: reference.predict(*requests[i]) for i in in_range}
    reference.params = state2
    alone2 = {i: reference.predict(*requests[i])
              for i in in_range[MULTI_SWAP_AT:]}
    del reference
    events0 = ONE_TIME_WORK[0]

    def rolling_swap(router, sink):
        """Drain the router (so that the peak-memory reading is the swap's
        own), then the rolling swap to state2, each replica's swap
        measured; before replica 1's swap, its weights must still be
        state1 bit for bit while replica 0's are state2."""
        router.drain()
        for w in router.workers:
            orig = w.swap_weights

            def measured(params, _w=w, _orig=orig):
                sibling = {}
                if _w.id == 1:
                    sibling = dict(
                        replica1_still_old=all(
                            torch.equal(v.cpu(), state1[k])
                            for k, v in _w.engine.params.items()),
                        replica0_new=all(
                            torch.equal(v.cpu(), state2[k])
                            for k, v in router.workers[0].engine.params
                            .items()))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                allocated = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                event = _orig(params)
                torch.cuda.synchronize()
                sink.append(dict(
                    replica=_w.id, seconds=time.perf_counter() - t0,
                    peak_growth_bytes=torch.cuda.max_memory_allocated()
                    - allocated, **sibling))
                return event
            w.swap_weights = measured
        t0 = time.perf_counter()
        router.swap_weights(state2, tag='seed_1')
        return time.perf_counter() - t0

    lines, failures = [], []
    runs = (('1 replica', 1, False, False), ('2 sync', 2, False, False),
            ('2 async', 2, True, False), ('2 async + swap', 2, True, True))
    for label, n, async_dispatch, swap in runs:
        run_timer = PhaseTimer()
        for e in engines:
            e.timer = run_timer
        workers = [ReplicaWorker(i, engines[i], max_wait_ms=MULTI_WAIT_MS,
                                 async_dispatch=async_dispatch)
                   for i in range(n)]
        admission = inf.AdmissionController(max_len=MULTI_BUCKETS[-1],
                                            max_queue_depth=64)
        path = os.path.join(tmp.name, f'run{len(lines)}.jsonl')
        logger = MetricLogger(path, mirror=None, run_meta=dict(
            mode='serve_multi', run=label, replicas=n,
            async_dispatch=async_dispatch, buckets=list(MULTI_BUCKETS),
            batch_size=1))
        before, routed_before = counts(), routed()
        served_before = [w.served_rows for w in workers]
        pending, rejected, swaps, swap_s = [], [], [], None
        with Router(workers, admission=admission) as router:
            tele = RouterTelemetry(router, admission, logger)
            tele.arm()
            t_stream = time.perf_counter()
            for i, (feats, coords) in enumerate(requests):
                if swap and len(pending) == MULTI_SWAP_AT and \
                        swap_s is None:
                    swap_s = rolling_swap(router, swaps)
                # as many requests in flight as replicas
                while router.queue_depth >= n:
                    time.sleep(0.0002)
                    router.pump()
                try:
                    pending.append((router.submit(feats, coords), i))
                except inf.RequestRejected as e:
                    rejected.append(e.to_record())
                    logger.log_record('step', mirror=False, step=i,
                                      rejected=e.to_record())
                router.pump()
            while router.queue_depth:
                time.sleep(router.next_deadline() or 0.0002)
                router.pump()
            stream_s = time.perf_counter() - t_stream
        launched = tuple(a - b for a, b in zip(counts(), before))
        routes = tuple(a - b for a, b in zip(routed(), routed_before))
        batches = router.batches_dispatched
        tele.flush()
        summary = tele.close()
        logger.close()
        info = validate_stream(path)
        worst = 0.0
        for k, (p, i) in enumerate(pending):
            ref = alone2[i] if swap and k >= MULTI_SWAP_AT else alone1[i]
            if not p.ok:
                worst = float('inf')
                continue
            worst = max(worst, float(np.abs(ref - p.result).max())
                        / max(float(np.abs(ref).max()), 1e-30))
        answered = [p for p, _ in pending if p.ok]
        lat = [p.latency_s * 1e3 for p in answered]
        line = dict(
            card=smi, run=label, replicas=n, async_dispatch=async_dispatch,
            requests=len(requests), admitted=admission.admitted,
            answered=len(answered), rejected=rejected, batches=batches,
            stream_s=stream_s, requests_per_s=len(answered) / stream_s,
            forward_ms_by_bucket={
                k: {q: v[q] for q in ('count', 'p50_ms', 'p95_ms',
                                      'p99_ms', 'max_ms')}
                for k, v in summary['timing'].items()},
            request_latency_ms=dict(
                p50=float(np.percentile(lat, 50)),
                p95=float(np.percentile(lat, 95)),
                p99=float(np.percentile(lat, 99)), max=max(lat)),
            served_rows={str(w.id): w.served_rows - served_before[w.id]
                         for w in router.workers},
            batches_by_replica={str(w.id): w.batcher.batches_dispatched
                                for w in router.workers},
            continuous_admissions=router.continuous_admissions,
            launches_per_batch=tuple(x // max(batches, 1) for x in launched),
            routed=routes, post_warmup_compiles=tele.post_warmup_compiles,
            schema=info['kinds'], max_rel_err_vs_alone=worst,
            rtol=REF_RTOL_F32)
        if swap:
            line.update(swap_s=swap_s, swaps=swaps, param_bytes=param_bytes)
        log('serve_multi', json.dumps(line))
        lines.append(line)
        if len(rejected) != 1 or rejected[0]['code'] != 'oversize' or \
                len(answered) != len(pending) or \
                len(pending) != len(requests) - 1:
            failures.append(f'{label}: {len(answered)} of {len(pending)} '
                            f'admitted answered, rejected {rejected}')
        if launched != tuple(w * batches for w in want) or \
                routes != NO_ROUTES:
            failures.append(f'{label}: launches {launched} for {batches} '
                            f'batches of {want}; routed {routes}')
        if tele.post_warmup_compiles:
            failures.append(f'{label}: one-time work after warmup')
        if not worst <= REF_RTOL_F32:
            failures.append(f'{label}: routed answers vs alone {worst}')
        if swap and (len(swaps) != 2 or any(
                x['peak_growth_bytes'] >= param_bytes / 2 for x in swaps)
                or not swaps[1].get('replica1_still_old')
                or not swaps[1].get('replica0_new')):
            failures.append(f'{label}: swaps {swaps}, param bytes '
                            f'{param_bytes}')
    # where the async pair's time goes: one 1024 request on each replica
    # at once, under the profiler
    big = [requests[i] for i in in_range
           if lengths[i] > MULTI_BUCKETS[0]][:2]
    workers = [ReplicaWorker(i, engines[i], async_dispatch=True)
               for i in range(2)]
    with Router(workers) as router:
        def pair():
            for feats, coords in big:
                router.submit(feats, coords)
            router.drain()
        pair()
        prof = profile_call(pair)
    union_ms, summed_ms = union_busy_ms(prof)
    late = ONE_TIME_WORK[0] - events0
    log('serve_multi', json.dumps(dict(
        card=smi, warmup=warm, param_bytes=param_bytes,
        profiled_async_pair=dict(
            bucket=MULTI_BUCKETS[-1], wall_ms=prof.wall_ms,
            device_busy_ms=union_ms, device_kernel_sum_ms=summed_ms,
            idle_share=1 - union_ms / prof.wall_ms,
            overlap=summed_ms / union_ms),
        throughput_vs_one_replica={
            x['run']: x['requests_per_s'] / lines[0]['requests_per_s']
            for x in lines},
        one_time_events_after_warmup=late)))
    if late:
        failures.append(f'one-time work after the warmups: {late}')
    if failures:
        raise AssertionError('serve_multi: ' + '; '.join(failures))
    del engines
    torch.cuda.empty_cache()
    tmp.cleanup()
    return counts()


# the messages of the last count_host_syncs call's synchronizing ops
LAST_SYNCS = []


def count_host_syncs(fn):
    """Run fn() and count the operations that made the host wait for the
    device (torch.cuda's sync debug mode): each leaves the device idle
    while the host catches up. Their messages go to LAST_SYNCS."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's own notice ("... does not yet detect all synchronizing
    # operations", once a process) is not a synchronizing call
    LAST_SYNCS[:] = [f'{w.filename}:{w.lineno}: {w.message}'[-200:]
                     for w in caught
                     if 'called a synchronizing' in str(w.message)]
    return len(LAST_SYNCS)


def profile_call(fn):
    """One call of fn() under torch.profiler (CPU and CUDA activity), ended
    by a device synchronize: the package's StepProfile
    (observability.profiling), its wall time in `wall_ms`."""
    from se3_transformer_torch.observability import profiling
    return profiling.capture_step_profile(fn, device='cuda')


def per_launch_us(prof):
    """Device microseconds per launch of kernels #5 and #6 in a profile
    (None where the profile launched none): the in-path times."""
    from se3_transformer_torch.observability import profiling
    rows = profiling.device_time_by_op(prof)
    out = {}
    for key, name in (('attn_fwd', 'attention_fwd_kernel'),
                      ('attn_bwd', 'attention_bwd_kernel')):
        hits = [r for r in rows if name in r[0]]
        calls = sum(r[1] for r in hits)
        out[key] = sum(r[2] for r in hits) * 1e3 / calls if calls else None
    return out


def top_device_ops(prof):
    from se3_transformer_torch.observability import profiling
    return [dict(op=name[:90], calls=n, ms=ms)
            for name, n, ms in profiling.device_time_by_op(prof)[:12]]


def kernels_ms(prof, names):
    """Device ms of the profile's kernels whose names hold one of
    `names`."""
    from se3_transformer_torch.observability import profiling
    return profiling.kernels_ms(prof, names)


def prof_busy_ms(prof):
    """The profile's device time (exclusive, kernels, copies and sets):
    device events only, never CPU time."""
    from se3_transformer_torch.observability import profiling
    selector = profiling.device_events(prof)[1]
    if selector != 'device':
        raise AssertionError(f'profile: the device time reads {selector}')
    return sum(us for _, us in prof.pairs()) / 1e3


def profile_request(engine, request):
    """Device time by op for one request (observability.profiling): the top
    ops, the pairwise and attention kernels' totals, the device's busy
    time and the request's wall time, in ms, the host syncs of the
    forward, #5's per-launch time; and the profile itself."""
    prof = profile_call(lambda: engine.predict(*request))
    # the forward alone: predict() copies to and from the host and ends in
    # a synchronize of its own
    from se3_transformer_torch.inference import pad_to_bucket
    padded = [torch.as_tensor(a, device='cuda') for a in pad_to_bucket(
        [request[0]], [request[1]], engine.buckets[-1], batch_size=1)]

    def forward():
        with torch.inference_mode():
            engine.module(*padded)
    syncs = count_host_syncs(forward)
    return top_device_ops(prof), kernels_ms(prof, FORWARD_KERNELS), \
        kernels_ms(prof, ATTENTION_KERNELS), prof_busy_ms(prof), \
        prof.wall_ms, syncs, per_launch_us(prof), prof


def profile_step(trainer, batch, noise):
    """Device time by op for one training step (observability.profiling):
    the top ops, the forward kernel's and kernels A's and B's totals, the
    device's busy time and the step's wall time, in ms; and the
    profile itself (under `profile`, popped by the caller)."""
    prof = profile_call(lambda: trainer.train_step(batch, noise=noise))
    syncs = count_host_syncs(lambda: trainer.train_step(batch, noise=noise))
    from torch.autograd import DeviceType
    host = sorted((e for e in prof.prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return dict(step_wall_ms=prof.wall_ms, host_syncs_per_step=syncs,
                device_busy_ms=prof_busy_ms(prof),
                forward_kernel_ms=kernels_ms(prof, FORWARD_KERNELS),
                attention_kernel_ms=kernels_ms(prof, ATTENTION_KERNELS),
                attention_us_per_launch=per_launch_us(prof),
                kernel_a_ms=kernels_ms(prof, ('bwd_a_kernel',
                                              'bwd_reduce_kernel')),
                kernel_b_ms=kernels_ms(prof, ('bwd_b_',)),
                top_device_ops=top_device_ops(prof),
                host_op_ms=sum(e.self_cpu_time_total for e in host) / 1e3,
                top_host_ops=[dict(op=e.key[:60], calls=e.count,
                                   ms=e.self_cpu_time_total / 1e3)
                              for e in host[:10]], profile=prof)


# the tune phase: the tuner (kernels/tune.py) in-process over the
# af2_refinement step, whose #3 launches take the wide (O = 192) and the
# narrow (O = 32) tiles, at JAX's tune-smoke settings (Makefile
# tune-smoke: one target, one candidate, one pair of 2 steps, margin -1,
# so that the measured candidate wins and the promote and consult path
# runs whatever the host's spread)
TUNE_ARGS = ('--recipe', 'af2_refinement', '--nodes', '1024', '--kinds',
             'plain', '--max-targets', '1', '--max-candidates', '1',
             '--pairs', '1', '--steps', '2', '--margin', '-1')


def check_splits(kp, shapes):
    """Every admissible i split of kernel #3 (tuning.admissible_candidates
    'plain') at each (shape, dtype) of `shapes`, forced onto the launch,
    against the plain version (KERNEL_RTOL of max|plain|), timed alone
    (`tune_split` lines): before any tuning, every split the tuner may
    promote is held."""
    from se3_transformer_torch.kernels import tuning
    gen = torch.Generator(device='cuda').manual_seed(25)
    worst, rows = 0.0, []
    for shape, dtype in shapes:
        E, IF, O, P, mid = shape
        hdt = getattr(torch, dtype)
        h = torch.randn(E, mid, device='cuda', generator=gen).to(hdt)
        w3 = (torch.randn(mid, IF, O, device='cuda', generator=gen)
              * mid ** -0.5).to(hdt)
        v2 = torch.randn(E, P, IF, device='cuda', generator=gen)
        b3 = torch.randn(IF, O, device='cuda', generator=gen) * 0.1
        ref = kp.fused_pairwise_conv_plain(h, w3, v2, b3)
        scale = float(ref.abs().max())
        heuristic = kp.i_per_split(E, IF, O)
        for cand in tuning.admissible_candidates('plain', shape):
            with tuning.force('plain', cand, shape=shape, dtype=dtype):
                per = kp.fwd_i_per_split(E, IF, O, P, mid, hdt, h.device)
                before = kp.fused_pairwise_conv.launches
                out = kp.fused_pairwise_conv(h, w3, v2, b3)
                launched = kp.fused_pairwise_conv.launches - before
                ms = cuda_ms(lambda: kp.fused_pairwise_conv(h, w3, v2, b3),
                             reps=5)
            err = float((out - ref).abs().max())
            row = dict(shape=list(shape), dtype=dtype, i_per_split=per,
                       splits=-(-IF // per), heuristic=per == heuristic,
                       max_abs_err=err, max_abs_plain=scale, ms=ms)
            rows.append(row)
            log('tune_split', json.dumps(row))
            if per != cand[0] or launched != 1:
                raise AssertionError(f'tune {shape}: the forced split {cand} '
                                     f'took {per}, {launched} launches')
            if not (np.isfinite(err) and err <= KERNEL_RTOL * scale):
                raise AssertionError(
                    f'tune {shape} i_per_split {per}: max_abs_err {err} > '
                    f'{KERNEL_RTOL} * max|plain| {scale}')
            worst = max(worst, err)
        del h, w3, v2, b3, ref
    torch.cuda.empty_cache()
    return rows, worst


def phase_tune(kp):
    """The tuner over af2_refinement's step (n 1024) in a temporary
    SE3_TORCH_CACHE_PATH: the step's #3 shapes (the 'plain' picks it
    resolves, both tiles), every admissible split at each held against the
    plain version (check_splits), then `python -m
    se3_transformer_torch.kernels.tune` in-process with TUNE_ARGS: every
    `tune` record schema-valid (the tuner validates before it writes), the
    last two 'promoted', then 'consulted'. Leaves no table behind."""
    import shutil
    import tempfile
    from se3_transformer_torch.kernels import tune, tuning
    default_table = tuning.cache_file()
    had_table = os.path.exists(default_table)
    workdir = tempfile.mkdtemp(prefix='se3_tune_')
    saved = os.environ.get('SE3_TORCH_CACHE_PATH')
    os.environ['SE3_TORCH_CACHE_PATH'] = os.path.join(workdir, 'cache')
    try:
        state = tune._build_step(tune.parse_args(TUNE_ARGS))
        shapes = sorted({(tuple(c['shape']), c['dtype'])
                         for c in tune._resolved(state)
                         if c['kernel'] == 'plain'})
        del state
        arms = {tuning.target_arm('plain', shape) for shape, _ in shapes}
        if arms != {'plain:wide', 'plain:narrow'}:
            raise AssertionError(f'tune: af2 #3 picks {shapes} cover the arms '
                                 f'{arms}, want the wide and the narrow')
        split_rows, worst = check_splits(kp, shapes)
        out = os.path.join(workdir, 'tune.jsonl')
        rc = tune.main(list(TUNE_ARGS) + ['--out', out])
        with open(out) as f:
            records = [json.loads(line) for line in f]
        tunes = [r for r in records if r['kind'] == 'tune']
        if rc != 0 or not tunes:
            raise AssertionError(f'tune: exit {rc}, records {records}')
        if [r['verdict'] for r in tunes][-2:] != ['promoted', 'consulted']:
            raise AssertionError(f'tune: the records end {tunes[-2:]}, '
                                 f'want promoted, then consulted')
    finally:
        if saved is None:
            os.environ.pop('SE3_TORCH_CACHE_PATH', None)
        else:
            os.environ['SE3_TORCH_CACHE_PATH'] = saved
        shutil.rmtree(workdir, ignore_errors=True)
        tuning.clear_kernel_caches()
    if os.path.exists(default_table) != had_table or \
            os.path.exists(workdir):
        raise AssertionError('tune: a table was left behind')
    tunes = [r for r in records if r['kind'] == 'tune']
    log('tune', json.dumps(dict(
        shapes=[list(s) + [d] for s, d in shapes],
        splits_checked=len(split_rows), worst_max_abs_err=worst,
        runs=sum(r['kind'] == 'run_meta' for r in records),
        verdicts=[r['verdict'] for r in tunes])))
    return split_rows, worst


def phase_profile(st, device_name, smi):
    """Per-scope device time (observability.profiling) of one flagship_fast
    request at bucket 1024 and one flagship_fast training step (n 1024,
    vector head), both at DEPTH with conditioned weights: their `profile`
    records (coverage of MODEL_SCOPES; the analytic FLOPs of utils.flops
    against the card's peaks), schema-valid in a stream written by
    report.write_record_stream; the request's coverage at least
    PROFILE_COVERAGE (JAX's profile-smoke gate); both read device events
    only; the engine's stats()['kernel_tuning'] non-empty. The warm
    trainer's `cost` record (check_cost_record) joins the stream. A
    `roofline` line names the card and its power limit."""
    import tempfile
    from se3_transformer_torch.observability import (
        profile_payload, validate_stream, write_record_stream,
    )
    from se3_transformer_torch.utils.flops import (
        forward_flops_estimate, train_step_flops_estimate,
    )
    rng = np.random.RandomState(0)
    model = condition_weights(st.flagship_fast(
        dim=64, depth=DEPTH, generator=torch.Generator().manual_seed(0)))
    engine = st.InferenceEngine(model, buckets=(1024,))
    consults = engine.stats()['kernel_tuning']
    if not consults:
        raise AssertionError('profile: the engine resolved no kernel pick')
    request = (rng.normal(size=(1024, 64)).astype(np.float32),
               chain_coords(rng, 1024))
    engine.predict(*request)
    prof = profile_call(lambda: engine.predict(*request))
    served = dict(kind='profile', **profile_payload(
        prof, label=f'flagship_fast request, bucket 1024, depth {DEPTH}',
        flops_per_step=forward_flops_estimate(model, 1024, 32),
        device_name=device_name), kernel_tuning=consults)
    del engine, model, prof
    torch.cuda.empty_cache()
    model = condition_weights(st.flagship_fast(
        dim=64, depth=DEPTH, output_degrees=2, reduce_dim_out=True,
        generator=torch.Generator().manual_seed(4)))
    trainer = st.DenoiseTrainer(model, lr=1e-4)
    batch = trainer.to_device(st.flagship_batch(rng, 1, 1024, 64))
    trainer.train_step(batch)
    prof = profile_call(lambda: trainer.train_step(batch))
    step = dict(kind='profile', **profile_payload(
        prof, label=f'flagship_fast train step, n 1024, depth {DEPTH}',
        flops_per_step=train_step_flops_estimate(model, 1024, 32),
        device_name=device_name))
    cost = check_cost_record(trainer, batch)
    del trainer, model, prof
    torch.cuda.empty_cache()
    for rec in (served, step):
        log('profile_record', json.dumps(rec))
        if rec['tracks']['selector'] != 'device' or 'roofline' not in rec:
            raise AssertionError(f'profile: {rec["label"]} read '
                                 f'{rec["tracks"]["selector"]}, roofline '
                                 f'{rec.get("roofline")}')
    log('cost_record', json.dumps(cost))
    path = os.path.join(tempfile.mkdtemp(prefix='se3_profile_'),
                        'profile.jsonl')
    write_record_stream(path, 'chip-smoke-profile', [served, step, cost])
    validate_stream(path)
    os.remove(path)
    os.rmdir(os.path.dirname(path))
    log('roofline', json.dumps(dict(
        device=device_name, nvidia_smi=smi, program=step['label'],
        coverage=step['coverage'], device_time_ms=step['device_time_ms'],
        wall_ms=step['wall_ms'], unattributed_top=step['unattributed_top'],
        **step['roofline'])))
    if served['coverage'] < PROFILE_COVERAGE:
        raise AssertionError(f'profile: the request attributes '
                             f'{served["coverage"]} of its device time to '
                             f'the model scopes, want >= {PROFILE_COVERAGE}')
    return served, step


def check_cost_record(trainer, batch):
    """DenoiseTrainer.cost_record on a warm trainer: its `cost` record (the
    allocator's peak over one step on a snapshot) valid under the port's
    schema, every parameter and Adam state tensor after it equal to before
    it, and the next step's loss, on fixed noise, equal to the loss of the
    same step on the same state without the record."""
    from se3_transformer_torch.observability import validate_record
    coords = batch['coords']
    noise = torch.randn(coords.shape, dtype=coords.dtype,
                        device=coords.device, generator=torch.Generator(
                            coords.device).manual_seed(5))
    params = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    opt_state = copy.deepcopy(trainer.optimizer.state_dict())
    step_count = trainer.step_count
    without = trainer.train_step(batch, noise=noise)
    trainer.model.load_state_dict(params)
    # load_state_dict keeps the tensors it is given: hand it a copy
    trainer.optimizer.load_state_dict(copy.deepcopy(opt_state))
    trainer.step_count = step_count
    rec = trainer.cost_record(batch)
    validate_record(dict(rec, run_id='chip-smoke-cost'))
    kept = all(torch.equal(v, params[k])
               for k, v in trainer.model.state_dict().items())
    after = trainer.optimizer.state_dict()['state']
    kept_opt = all(torch.equal(torch.as_tensor(v), torch.as_tensor(
        after[key][name])) for key, st in opt_state['state'].items()
        for name, v in st.items())
    with_record = trainer.train_step(batch, noise=noise)
    if not (kept and kept_opt and trainer.step_count == step_count + 1 and
            torch.equal(without, with_record)):
        raise AssertionError(
            f'cost_record: parameters kept {kept}, Adam state kept '
            f'{kept_opt}, step count {trainer.step_count} (want '
            f'{step_count + 1}), next loss {float(with_record)} against '
            f'{float(without)} without the record')
    if not rec['peak_bytes'] > rec['memory']['argument_bytes'] > 0:
        raise AssertionError(f'cost_record: {rec}')
    return rec


def counters():
    """(wrapper, attribute) of every launch counter, in COUNT_NAMES order:
    the pairwise forwards bxf and fwd, backward kernels A and B, the fused
    attention forward and backward, the streaming attention, the
    structured-basis forward bx, the global attention; then the so2 arm's
    launches of the streaming and the global attention, the scaled arm's
    of #3 and #7, the conv_bf16 arm's of #1, #3, A and B, the narrow-O
    arm's of #3, A and B, and the mid-32 arm's of #3, A and B (each
    counted in its kernel's total too)."""
    from se3_transformer_torch.kernels import attention as ka
    from se3_transformer_torch.kernels import flash as kf
    from se3_transformer_torch.kernels import pairwise as kp
    return ((kp.fused_pairwise_conv_bxf, 'launches'),
            (kp.fused_pairwise_conv, 'launches'),
            (kp.fused_pairwise_conv_bwd, 'launches_a'),
            (kp.fused_pairwise_conv_bwd, 'launches_b'),
            (ka.fused_attention_fwd, 'launches'),
            (ka.fused_attention_bwd, 'launches'),
            (kf.flash_attention_fwd, 'launches'),
            (kp.fused_pairwise_conv_bx, 'launches'),
            (kf.flash_global_attention_fwd, 'launches'),
            (kf.flash_attention_fwd, 'so2_launches'),
            (kf.flash_global_attention_fwd, 'so2_launches'),
            (kp.fused_pairwise_conv, 'scaled_launches'),
            (kf.flash_attention_fwd, 'scaled_launches'),
            (kp.fused_pairwise_conv_bxf, 'conv_bf16_launches'),
            (kp.fused_pairwise_conv, 'conv_bf16_launches'),
            (kp.fused_pairwise_conv_bwd, 'conv_bf16_launches_a'),
            (kp.fused_pairwise_conv_bwd, 'conv_bf16_launches_b'),
            (kp.fused_pairwise_conv, 'narrow_launches'),
            (kp.fused_pairwise_conv_bwd, 'narrow_launches_a'),
            (kp.fused_pairwise_conv_bwd, 'narrow_launches_b'),
            (kp.fused_pairwise_conv, 'mid32_launches'),
            (kp.fused_pairwise_conv_bwd, 'mid32_launches_a'),
            (kp.fused_pairwise_conv_bwd, 'mid32_launches_b'))


def counts():
    """Launches so far, in COUNT_NAMES order."""
    return tuple(getattr(fn, attr) for fn, attr in counters())


def route_counters():
    """The wrappers whose .routed counts calls sent past the kernel, in
    ROUTE_NAMES order."""
    wrappers = dict(zip(COUNT_NAMES, (fn for fn, _ in counters())))
    return tuple(wrappers[name] for name in ROUTE_NAMES)


def routed():
    """Routed calls so far, in ROUTE_NAMES order."""
    return tuple(fn.routed for fn in route_counters())


def reset_counts():
    for fn, attr in counters():
        setattr(fn, attr, 0)
    for fn in route_counters():
        fn.routed = 0


def not_routed(label, launches):
    """A main path's launches, after checking that none of its calls was
    routed past a kernel (the flagship widths never are)."""
    routed_exactly(label, NO_ROUTES)
    return launches


def routed_exactly(label, want):
    """Check that exactly `want` calls (ROUTE_NAMES order) were routed past
    a kernel since the counts were last reset; a phase line."""
    tick(label)
    if routed() != tuple(want):
        raise AssertionError(f'{label}: routed calls {ROUTE_NAMES} = '
                             f'{routed()}, want {tuple(want)}')


# C1's routing phase: the JAX DenoiseConfig widths (se3_transformer_tpu/
# training/denoise.py: dim 8, heads 2, dim_head 8), two degrees, the
# basis-fused kNN convs, float32 trunk; with fuse_pairwise the streaming
# attention is past #7's heads * dim_head = 64 as well
ROUTE_MODEL = dict(dim=8, heads=2, dim_head=8, depth=1, num_degrees=2,
                   fuse_basis=True, shared_radial_hidden=True,
                   num_neighbors=16, output_degrees=2, reduce_dim_out=True)
ROUTE_CASES = (('denoise widths', dict(), ('bxf',)),
               ('denoise widths + fuse_pairwise', dict(fuse_pairwise=True),
                ('bxf', 'flash')),
               # one kv head: kernel #7 is built for heads == kv_heads
               ('denoise widths + fuse_pairwise + one-headed kv',
                dict(fuse_pairwise=True, one_headed_key_values=True),
                ('bxf', 'flash')))


def phase_route(st):
    """Models past the kernels' limits served by InferenceEngine on the
    card and on the CPU from the same weights (return_type=1): on the
    card every pairwise (and streaming attention) call is routed to its
    plain version, counted and warned, and no kernel launches; the vector
    outputs agree within REF_RTOL_F32."""
    rng = np.random.RandomState(18)
    n = 60
    feats = rng.normal(size=(n, 8)).astype(np.float32)
    coords = chain_coords(rng, n)
    for label, fields, want in ROUTE_CASES:
        outs = []
        for device in ('cuda', 'cpu'):
            model = st.SE3TransformerModule(
                **ROUTE_MODEL, **fields, device=device,
                generator=torch.Generator().manual_seed(19))
            # warmed lazily: the first request's routing warning is read
            engine = st.InferenceEngine(model, buckets=(64,), device=device,
                                        return_type=1, precompile=False)
            reset_counts()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter('always')
                outs.append(engine.predict(feats, coords))
            if device == 'cuda':
                launched, got = counts(), routed()
                texts = sorted({str(w.message) for w in caught
                                if 'using the plain path' in str(w.message)})
        err = float(np.abs(outs[0] - outs[1]).max())
        scale = float(np.abs(outs[1]).max())
        log('route', json.dumps(dict(
            model=label, n=n, routed=dict(zip(ROUTE_NAMES, got)),
            launches=dict(zip(COUNT_NAMES, launched)), warnings=texts,
            max_abs_err=err, max_abs_cpu=scale, rtol=REF_RTOL_F32)))
        if any(launched):
            raise AssertionError(f'route {label}: kernels launched '
                                 f'{launched} past their limits')
        if not all(got[ROUTE_NAMES.index(name)] > 0 for name in want):
            raise AssertionError(f'route {label}: routed {got}, want '
                                 f'{want} > 0')
        if not texts:
            raise AssertionError(f'route {label}: no routing warning')
        if not (np.isfinite(outs[0]).all() and err <= REF_RTOL_F32 * scale):
            raise AssertionError(f'route {label}: card vs CPU {err} > '
                                 f'{REF_RTOL_F32} * {scale}')
    reset_counts()


def phase_route_wide(st):
    """A ConvSE3 of 128 channels, degrees 0 and 1 (O = 128: two O tiles of
    #1, #3 and kernels A and B), on the card and on the CPU from the same
    weights, basis-fused (#1) and grouped (#3). Without grad its forward
    launches the kernel and routes nothing; with grad the forward launches
    again and the backward launches kernels A and B once per contraction,
    routing nothing. Output within REF_RTOL_F32 of the CPU, gradients
    within REF_GRAD_RTOL_F32."""
    from se3_transformer_torch.models.se3_transformer import init_parameters
    gen = torch.Generator().manual_seed(21)
    n, k, C = 64, 16, 128
    fiber = st.Fiber.create(2, C)
    feats = {str(d): torch.randn(1, n, C, 2 * d + 1, generator=gen)
             for d in range(2)}
    idx = torch.randint(0, n, (1, n, k), generator=gen)
    mask = torch.rand(1, n, k, generator=gen) > 0.05
    rel = torch.randn(1, n, k, 3, generator=gen) * 4.0
    for fuse_basis, kernel, pairs in ((True, 'bxf', 4), (False, 'fwd', 2)):
        conv = st.ConvSE3(fiber, fiber, fuse_basis=fuse_basis,
                          shared_radial_hidden=True)
        init_parameters(conv, torch.Generator().manual_seed(22))
        results = {}
        for device in ('cuda', 'cpu'):
            conv = conv.to(device)
            xs = {d: v.to(device).requires_grad_() for d, v in feats.items()}
            r = rel.to(device)
            basis = st.get_basis(r, 1, layout='pfq_flat' if fuse_basis
                                 else 'pqf')
            args = (xs, (idx.to(device), mask.to(device), None),
                    r.norm(dim=-1), basis)
            reset_counts()
            with torch.no_grad():
                conv(*args)
            if device == 'cuda':
                nograd = (counts(), routed())
            reset_counts()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter('always')
                out = conv(*args)
                loss = sum((o ** 2).sum() for o in out.values())
                grads = torch.autograd.grad(loss, [xs['0'], xs['1']]
                                            + list(conv.parameters()))
            if device == 'cuda':
                torch.cuda.synchronize()
                grad = (counts(), routed())
                texts = sorted({str(w.message) for w in caught
                                if 'using the plain path' in str(w.message)})
            results[device] = ([o.detach().cpu() for o in out.values()],
                               [g.cpu() for g in grads])
        out_err = max(float((a - b).abs().max()) for a, b in
                      zip(results['cuda'][0], results['cpu'][0]))
        out_max = max(float(b.abs().max()) for b in results['cpu'][0])
        grad_rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in
                       zip(results['cuda'][1], results['cpu'][1]))
        log('route', json.dumps(dict(
            model=f'ConvSE3 O=128 {kernel}', n=n, k=k,
            nograd=dict(launches=dict(zip(COUNT_NAMES, nograd[0])),
                        routed=dict(zip(ROUTE_NAMES, nograd[1]))),
            grad=dict(launches=dict(zip(COUNT_NAMES, grad[0])),
                      routed=dict(zip(ROUTE_NAMES, grad[1]))),
            warnings=texts, max_abs_err=out_err, max_abs_cpu=out_max,
            grad_rel_err=grad_rel)))
        want = tuple(pairs if name == kernel else 0 for name in COUNT_NAMES)
        want_grad = tuple(pairs if name in (kernel, 'A', 'B') else 0
                          for name in COUNT_NAMES)
        no_route = (0,) * len(ROUTE_NAMES)
        if nograd != (want, no_route):
            raise AssertionError(f'route wide {kernel} without grad: '
                                 f'{nograd}, want {want} and no route')
        if grad != (want_grad, no_route):
            raise AssertionError(f'route wide {kernel} with grad: {grad}, '
                                 f'want {want_grad} and no route')
        if texts:
            raise AssertionError(f'route wide {kernel}: routing warnings '
                                 f'{texts}')
        if not (out_err <= REF_RTOL_F32 * out_max
                and grad_rel <= REF_GRAD_RTOL_F32):
            raise AssertionError(f'route wide {kernel}: card vs CPU {out_err}'
                                 f' of {out_max}, gradients {grad_rel}')
    reset_counts()


def phase_train(st, recipe, want, other_policy, want_other, label=None,
                dim=64, depth=DEPTH, n=1024, loss_fn=None,
                round_trip=False, module=None, **fields):
    """A recipe's denoise step (the vector head: output_degrees=2,
    reduce_dim_out=True; `dim`, `depth` and `fields` set or add model
    fields) at n nodes (1024) with Adam; with `loss_fn` (the trainer's
    loss) the recipe's own head: one warm-up step, then TRAIN_STEPS timed
    ones, each with exactly `want` launches (COUNT_NAMES order) and no
    routed call; one
    profiled step; with `round_trip`, checkpoint_round_trip of the
    trainer's state into a fresh trainer of the same model (a denoise
    loss); unless
    `want_other` is None, one step under `other_policy` with `want_other`
    launches. `module` builds a model that is not a recipe (the V2
    family). Returns the launches of the warm-up and timed steps."""
    recipe, name = label or recipe, recipe
    head = {} if loss_fn else dict(output_degrees=2, reduce_dim_out=True)
    model = condition_weights((module or getattr(st, name))(
        dim=dim, depth=depth, generator=torch.Generator().manual_seed(4),
        **head, **fields))
    trainer = st.DenoiseTrainer(model, lr=1e-4, **(
        dict(loss_fn=loss_fn) if loss_fn else {}))
    batch = trainer.to_device(st.flagship_batch(np.random.RandomState(0), 1,
                                                n, dim))
    noise = torch.randn(batch['coords'].shape, device='cuda',
                        generator=torch.Generator('cuda').manual_seed(5))

    reset_counts()
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(1 + TRAIN_STEPS):
        before, routed_before = counts(), routed()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_step(batch, noise=noise)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = tuple(a - b for a, b in zip(counts(), before))
        routes = tuple(a - b for a, b in zip(routed(), routed_before))
        losses.append(float(loss))
        if launched != want or routes != NO_ROUTES:
            raise AssertionError(f'{recipe} train step {step}: launches '
                                 f'{COUNT_NAMES} = {launched}, want '
                                 f'{want}; routed {ROUTE_NAMES} = {routes}')
        if step:
            step_ms.append(dt * 1e3)
        log('train', json.dumps(dict(recipe=recipe, step=step,
                                     warmup=step == 0, loss=losses[-1],
                                     step_ms=dt * 1e3, launches=launched,
                                     routed=routes)))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = counts()
    routed_exactly(recipe, NO_ROUTES)
    bad = [name for name, p in model.named_parameters()
           if p.grad is not None and not torch.isfinite(p.grad).all()]
    if not np.isfinite(losses).all() or losses[-1] >= losses[0] or bad:
        raise AssertionError(f'{recipe} train: losses {losses}, non-finite '
                             f'gradients in {bad}')
    ms = float(np.median(step_ms))
    log('train', json.dumps(dict(
        recipe=recipe, n=n, steps=TRAIN_STEPS, step_ms_median=ms,
        step_ms=step_ms,
        nodes_steps_per_s=n * TRAIN_STEPS / (sum(step_ms) / 1e3),
        max_memory_allocated_gb=peak_gb, first_loss=losses[0],
        last_loss=losses[-1], launches=launches)))
    profiled = profile_step(trainer, batch, noise)
    profiled.pop('profile')
    log('train_profile', json.dumps(dict(recipe=recipe, **profiled)))
    if round_trip:
        # the fresh trainer's model: a copy with every parameter zeroed, so
        # that only the restore can give it the trainer's weights
        fresh = copy.deepcopy(model)
        with torch.no_grad():
            for p in fresh.parameters():
                p.zero_()
        checkpoint_round_trip(recipe, trainer, st.DenoiseTrainer(
            fresh, lr=1e-4), batch, noise)
        del fresh
    if want_other is None:
        del trainer, model
        torch.cuda.empty_cache()
        return launches

    other = st.DenoiseTrainer(condition_weights((module or getattr(st, name))(
        dim=dim, depth=depth, output_degrees=2, reduce_dim_out=True,
        remat_policy=other_policy,
        generator=torch.Generator().manual_seed(4), **fields)), lr=1e-4)
    del trainer, model
    torch.cuda.empty_cache()
    before = counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    other.train_step(batch, noise=noise)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = tuple(a - b for a, b in zip(counts(), before))
    log('train', json.dumps(dict(recipe=recipe, remat_policy=other_policy,
                                 step_ms=dt * 1e3, launches=launched,
                                 max_memory_allocated_gb=(
                                     torch.cuda.max_memory_allocated() / 1e9))))
    if launched != want_other:
        raise AssertionError(f'{recipe} remat_policy={other_policy} step: '
                             f'launches {launched}, want {want_other}')
    del other
    torch.cuda.empty_cache()
    return launches


def check_step(label, step, before, want):
    """The launches and routed calls of one step since `before` (counts,
    routed): exactly `want` and none routed."""
    launched = tuple(a - b for a, b in zip(counts(), before[0]))
    routes_ = tuple(a - b for a, b in zip(routed(), before[1]))
    if launched != want or routes_ != NO_ROUTES:
        raise AssertionError(f'{label} step {step}: launches {COUNT_NAMES} = '
                             f'{launched}, want {want}; routed {routes_}')
    return launched


def phase_denoise_train(st, want):
    """The JAX trainer's path: DenoiseTrainer(DenoiseConfig(accum_steps=
    DENOISE_ACCUM)) on the card for DENOISE_STEPS steps on its own
    synthetic batches (np_rng) and seeded noise, each with exactly `want`
    launches and nothing routed; after step DENOISE_RESUME_AT a checkpoint
    by save_async, written while the next step updates the weights in
    place; the checkpoint holding that step's weights bit for bit; a fresh
    trainer restored from it taking the next step on the same batch and
    noise to the uninterrupted run's loss within RESUME_RTOL (and the same
    step again, for the run-to-run spread); finite losses; the median step
    time, nodes*steps/s, and the device busy time and idle share of one
    profiled micro-batch (a step is DENOISE_ACCUM of them and one Adam
    update; a whole step's ~10^5 events take the profiler ~50 s to
    summarize). Returns the launches of the uninterrupted run."""
    import tempfile
    from se3_transformer_torch.training import CheckpointManager
    cfg = st.DenoiseConfig(accum_steps=DENOISE_ACCUM)
    trainer = st.DenoiseTrainer(cfg)
    rng = np.random.RandomState(41)
    shape = (cfg.accum_steps, cfg.batch_size, cfg.num_nodes, 3)
    losses, step_ms = [], []
    with tempfile.TemporaryDirectory() as d, CheckpointManager(d) as cm:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        for step in range(1, DENOISE_STEPS + 1):
            batch = trainer.micro_batches()
            noise = torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                                    device='cuda')
            before = counts(), routed()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = trainer.train_step(batch, noise=noise)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            check_step('denoise train', step, before, want)
            losses.append(float(loss))
            if step == DENOISE_RESUME_AT:
                t0 = time.perf_counter()
                cm.save_async(step, (trainer.params, trainer.opt_state,
                                     trainer.step_count))
                save_async_ms = (time.perf_counter() - t0) * 1e3
                saved = {k: v.clone() for k, v in trainer.params.items()}
            elif step == DENOISE_RESUME_AT + 1:
                resume = (batch, noise, losses[-1])
        launches = counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        cm.wait_until_finished()
        fresh = st.DenoiseTrainer(cfg)
        fresh.init()
        like = (fresh.params, fresh.opt_state, 0)
        state = cm.restore(step=DENOISE_RESUME_AT, like=like)
        stale = [k for k, v in saved.items()
                 if not torch.equal(state[0][k].to(v.device), v)]
        if stale or state[2] != DENOISE_RESUME_AT:
            raise AssertionError(f'denoise checkpoint of step '
                                 f'{DENOISE_RESUME_AT} does not hold its '
                                 f'weights: {stale[:5]}, step {state[2]}')
        fresh.restore(state)
        batch, noise, want_loss = resume
        got = float(fresh.train_step(batch, noise=noise))
        fresh.restore(cm.restore(step=DENOISE_RESUME_AT, like=like))
        again = float(fresh.train_step(batch, noise=noise))
    rel = abs(got - want_loss) / abs(want_loss)
    if not (np.isfinite(losses).all() and rel <= RESUME_RTOL):
        raise AssertionError(f'denoise train: losses {losses}; resumed step '
                             f'{DENOISE_RESUME_AT + 1} loss {got} vs '
                             f'{want_loss} ({rel} > {RESUME_RTOL})')
    micro = {k: v[0] for k, v in batch.items()}
    prof = profile_call(lambda: trainer.loss_fn(
        trainer.model, micro, noise[0]).backward())
    micro_ms, busy_ms = prof.wall_ms, prof_busy_ms(prof)
    ms = float(np.median(step_ms[1:]))
    nodes = cfg.batch_size * cfg.num_nodes * cfg.accum_steps
    log('denoise_train', json.dumps(dict(
        config='DenoiseConfig(accum_steps=16)', nodes=cfg.num_nodes,
        accum_steps=cfg.accum_steps, steps=DENOISE_STEPS, losses=losses,
        step_ms=step_ms, step_ms_median=ms, nodes_steps_per_s=nodes / ms * 1e3,
        launches_per_step=dict(zip(COUNT_NAMES, want)),
        resume=dict(step=DENOISE_RESUME_AT + 1, loss=got,
                    uninterrupted_loss=want_loss, rel_err=rel,
                    rerun_rel_spread=abs(again - got) / abs(got),
                    save_async_ms=save_async_ms),
        micro_batch_profile=dict(
            wall_ms=micro_ms, device_busy_ms=busy_ms,
            idle_share=1 - busy_ms / micro_ms,
            narrow_kernel_ms=kernels_ms(prof, ('se3n::',)),
            top_device_ops=top_device_ops(prof)[:8]),
        max_memory_allocated_gb=peak_gb)))
    del trainer, fresh
    torch.cuda.empty_cache()
    return launches


def phase_denoise_pipelined(st, want):
    """The fixture sidechainnet export (tests/fixtures/mini_sidechainnet.pkl,
    every split) converted to a PointCloudDataset, and
    DenoiseTrainer(DenoiseConfig(accum_steps=DENOISE_ACCUM,
    pipeline=True)).train_pipelined on it through dataset_batch_source
    (bucket 96:
    the proteins of at most 32 residues; the longer ones dropped, as the
    dataset counts them), a BatchProducer thread and device_prefetch, for
    DENOISE_PIPELINED_STEPS steps with a save_async checkpoint every 2:
    exactly `want` launches a step and nothing routed, finite losses, the
    newest checkpoint restorable, and the PipelineStats snapshot. Returns
    the launches."""
    import tempfile
    from se3_transformer_torch.training import (
        CheckpointManager, PointCloudDataset, convert_sidechainnet,
        dataset_batch_source,
    )
    steps = DENOISE_PIPELINED_STEPS
    cfg = st.DenoiseConfig(accum_steps=DENOISE_ACCUM, pipeline=True)
    trainer = st.DenoiseTrainer(cfg)
    with tempfile.TemporaryDirectory() as d, CheckpointManager(d) as cm:
        path = convert_sidechainnet(
            os.path.join(HERE, 'tests', 'fixtures', 'mini_sidechainnet.pkl'),
            os.path.join(d, 'scn.npz'), splits=('train', 'valid-10', 'test'))
        dataset = PointCloudDataset.load(path)
        reset_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            history = trainer.train_pipelined(
                steps, batch_source=dataset_batch_source(
                    dataset, cfg.batch_size, cfg.num_nodes,
                    accum_steps=cfg.accum_steps, num_steps=steps),
                log=lambda msg: None, checkpoint_manager=cm,
                checkpoint_every=2)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = counts()
        restored = cm.restore()
        kept = cm.all_steps()
    records, pipeline = history[:-1], history[-1]
    losses = [r['loss'] for r in records]
    want_total = tuple(w * steps for w in want)
    if (launches != want_total or routed() != NO_ROUTES
            or len(records) != steps or not np.isfinite(losses).all()
            or pipeline['steps'] != steps or kept != [2, 4]
            or restored[2] != 4):
        raise AssertionError(f'denoise pipelined: launches {launches}, want '
                             f'{want_total}; routed {routed()}; losses '
                             f'{losses}; pipeline {pipeline}; checkpoints '
                             f'{kept}')
    log('denoise_pipelined', json.dumps(dict(
        dataset=dict(sequences=len(dataset), dropped=dataset.last_dropped,
                     warnings=sorted({str(w.message)[:120] for w in caught})),
        steps=steps, losses=losses, wall_s=wall_s,
        nodes_steps_per_s=(cfg.num_nodes * cfg.accum_steps * steps / wall_s),
        checkpoints=kept, pipeline=pipeline)))
    del trainer
    torch.cuda.empty_cache()
    return launches


def guarded_config(st, **over):
    """The guarded phase's DenoiseConfig: the CLI's defaults (96 nodes,
    batch 1, 2 degrees) at --accum GUARDED_ACCUM --flush-every
    GUARDED_WINDOW --pipelined --guarded."""
    return st.DenoiseConfig(accum_steps=GUARDED_ACCUM, telemetry=True,
                            flush_every=GUARDED_WINDOW, pipeline=True,
                            **over)


class StepLaunches:
    """A guarded loop's step_hook: each step's launches and routed calls
    (the counts since the previous hook: a step that raised launched
    nothing) and, with `sync`, the wall ms since the previous hook, ended
    by a synchronize; with `progress`, the step count published in that
    file for a parent process."""

    def __init__(self, sync=False, progress=None):
        self.sync, self.progress = sync, progress
        self.steps, self.launches, self.routes, self.ms = [], [], [], []
        self._last = (counts(), routed())
        self._t = time.perf_counter()

    def __call__(self, step):
        if self.sync:
            torch.cuda.synchronize()
        now, t = (counts(), routed()), time.perf_counter()
        self.steps.append(step)
        self.launches.append(tuple(a - b for a, b in zip(now[0],
                                                         self._last[0])))
        self.routes.append(tuple(a - b for a, b in zip(now[1],
                                                       self._last[1])))
        self.ms.append((t - self._t) * 1e3)
        self._last, self._t = now, t
        if self.progress:
            tmp = self.progress + '.tmp'
            with open(tmp, 'w') as f:
                f.write(str(step))
            os.replace(tmp, self.progress)

    def step_ms(self):
        """The intervals that hold one step and no window end: those that
        follow a step inside a window (fetch, dispatch, the step)."""
        return [ms for prev, ms in zip(self.steps, self.ms[1:])
                if prev % GUARDED_WINDOW]


def check_guarded_steps(label, steps, launches, routes, want):
    bad = [(s, l, r) for s, l, r in zip(steps, launches, routes)
           if tuple(l) != tuple(want) or tuple(r) != NO_ROUTES]
    if bad or not steps:
        raise AssertionError(f'{label}: steps whose launches {COUNT_NAMES} '
                             f'or routed calls {ROUTE_NAMES} are not {want}: '
                             f'{bad[:3]} (of {len(steps)} steps)')


def timed_calls(obj, name, sink, sync=False):
    """Shadow obj.name with a wrapper that appends each call's ms to sink
    (ended by a synchronize with `sync`)."""
    inner = getattr(obj, name)

    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out
    setattr(obj, name, call)


def params_max_abs_diff(a, b):
    """The largest |a - b| over two state dicts' tensors (0 when every one
    is equal bit for bit; inf where a NaN stands)."""
    worst = 0.0
    for key, value in a.items():
        other = b[key].to(value.device)
        if torch.equal(value, other):
            continue
        diff = (value.double() - other.double()).abs()
        worst = max(worst, float('inf') if diff.isnan().any()
                    else float(diff.max()))
    return worst


def guarded_worker(workdir):
    """The chaos arm of phase_denoise_guarded, run by `chip_smoke.py
    --guarded-worker DIR` in a process of its own: the guarded loop
    (train_guarded) with an injector that poisons build GUARDED_NAN_AT
    with NaN and fails step_dispatch call GUARDED_FAIL_AT, its progress
    published in DIR/progress for the parent's SIGTERM, checkpoints in
    DIR/ckpt, its records in DIR/chaos.jsonl; writes DIR/chaos.json
    (result, counters, each step's launches and routed calls, the flushed
    windows, the injector's log, the ms of the rollback's restores, the
    emergency save and the async saves) and exits with the result's exit
    code (RESUMABLE_RC when preempted)."""
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False',
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import se3_transformer_torch as st
    from se3_transformer_torch.faults import FaultInjector
    from se3_transformer_torch.observability import MetricLogger
    from se3_transformer_torch.training import CheckpointManager
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainer = st.DenoiseTrainer(guarded_config(st))
    inj = FaultInjector(seed=0)
    inj.plan('step_batch', 'nan', at=(GUARDED_NAN_AT,))
    inj.plan('step_dispatch', 'exception', at=(GUARDED_FAIL_AT,))
    hook = StepLaunches(progress=os.path.join(workdir, 'progress'))
    ms = dict(restore_load=[], restore_adopt=[], emergency_save=[],
              save_async=[])
    with CheckpointManager(os.path.join(workdir, 'ckpt')) as mgr, \
            MetricLogger(os.path.join(workdir, 'chaos.jsonl'),
                         mirror=None) as logger:
        timed_calls(mgr, 'restore', ms['restore_load'])
        timed_calls(trainer, 'restore', ms['restore_adopt'], sync=True)
        timed_calls(mgr, 'save', ms['emergency_save'])
        timed_calls(mgr, 'save_async', ms['save_async'])
        res = trainer.train_guarded(GUARDED_STEPS, mgr, injector=inj,
                                    metric_logger=logger, step_hook=hook)
    report = dict(
        exit_code=res.exit_code, steps=res.steps, preempted=res.preempted,
        counters=res.counters, hook_steps=hook.steps,
        launches=hook.launches, routes=hook.routes, injected=inj.injected,
        windows=[dict(step=h['step'], loss=h['window']['loss'])
                 for h in res.history if h.get('kind') == 'flush'],
        ms=ms)
    with open(os.path.join(workdir, 'chaos.json'), 'w') as f:
        json.dump(report, f)
    return res.exit_code


def phase_denoise_guarded(st, want):
    """The guarded training loop (training.guardian) on the card: the port
    of scripts/train_chaos_smoke.py over guarded_config (every contraction
    on the narrow-O arms). Arms, GUARDED_STEPS steps each:
      * control, twice in this process, no injector: the parity oracle and
        its run-to-run spread;
      * weakened, in this process: GuardConfig(rollback=False), NaN at
        build GUARDED_NAN_AT: it must end diverged with exit code 1;
      * chaos, a subprocess (guarded_worker): NaN at build GUARDED_NAN_AT
        and a failing dispatch; SIGTERM once it reports step >=
        GUARDED_KILL_AT: exit RESUMABLE_RC;
      * resume, the CLI itself (`-m se3_transformer_torch.training.cli
        --guarded` on the chaos arm's checkpoints): exit 0.
    Checks: every guarded step of the in-process arms and of the chaos arm
    (the poisoned one and the replays too) launches exactly `want` and
    routes nothing; the poisoned window's loss is non-finite and the
    replayed windows' finite; the resumed run's final parameters equal the
    control's bit for bit (or, when the two controls differ, within twice
    their max-abs difference); the CLI's stream validates, its cumulative
    guard record has rollbacks and injections_total >= 1, preemptions and
    restarts 1, diverged false, and the resumed process did no one-time
    host work after its first step; a clean telemetry train_step makes no
    host sync and telemetry_flush exactly one. Prints the arms' exit codes
    and walls, the guarded step against an unguarded one, the flush,
    restore, emergency-save and save_async ms (`denoise_guarded`). Returns
    the launches of the in-process arms."""
    import signal
    import tempfile
    from se3_transformer_torch.observability import validate_stream
    from se3_transformer_torch.training import CheckpointManager
    from se3_transformer_torch.training.guardian import (
        RESUMABLE_RC, GuardConfig, StepGuard,
    )
    from se3_transformer_torch.faults import FaultInjector
    t_phase = time.perf_counter()
    cfg = guarded_config(st)
    quiet = lambda msg: None  # noqa: E731
    reset_counts()
    walls, controls, flush_ms = {}, [], []
    with tempfile.TemporaryDirectory(prefix='guarded') as d:
        for i in range(2):
            trainer = st.DenoiseTrainer(cfg)
            hook = StepLaunches(sync=i == 0)
            if i == 0:
                timed_calls(trainer, 'telemetry_flush', flush_ms)
            t0 = time.perf_counter()
            with CheckpointManager(os.path.join(d, f'control{i}')) as mgr:
                res = trainer.train_guarded(GUARDED_STEPS, mgr,
                                            step_hook=hook, log=quiet)
            walls[f'control{i}'] = time.perf_counter() - t0
            check_guarded_steps(f'guarded control {i}', hook.steps,
                                hook.launches, hook.routes, want)
            if res.exit_code or any(res.counters.values()) \
                    or res.steps != GUARDED_STEPS:
                raise AssertionError(f'guarded control {i}: {res.counters}, '
                                     f'rc {res.exit_code}')
            controls.append({k: v.detach().clone()
                             for k, v in trainer.params.items()})
            if i == 0:
                guarded_step_ms = hook.step_ms()
                summary = [h for h in res.history if 'label' in h][-1]
            del trainer
        spread = params_max_abs_diff(controls[0], controls[1])

        weak = st.DenoiseTrainer(cfg)
        inj = FaultInjector(seed=0)
        inj.plan('step_batch', 'nan', at=(GUARDED_NAN_AT,))
        hook = StepLaunches()
        t0 = time.perf_counter()
        with CheckpointManager(os.path.join(d, 'weak')) as mgr, \
                warnings.catch_warnings(record=True):
            warnings.simplefilter('always')
            weak_res = weak.train_guarded(
                GUARDED_STEPS, mgr, injector=inj, step_hook=hook, log=quiet,
                guard=StepGuard(GuardConfig(rollback=False)))
        walls['weakened'] = time.perf_counter() - t0
        check_guarded_steps('guarded weakened', hook.steps, hook.launches,
                            hook.routes, want)
        if not (weak_res.diverged and weak_res.exit_code == 1
                and weak_res.counters['rollbacks'] == 0):
            raise AssertionError(f'guarded weakened arm: rc '
                                 f'{weak_res.exit_code}, {weak_res.counters}')
        del weak

        work = os.path.join(d, 'chaos')
        os.makedirs(work)
        progress = os.path.join(work, 'progress')
        t0 = time.perf_counter()
        with open(os.path.join(work, 'chaos.out'), 'w') as out:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 '--guarded-worker', work], cwd=HERE, stdout=out,
                stderr=subprocess.STDOUT)
            try:
                reached = 0
                while proc.poll() is None and \
                        time.perf_counter() - t0 < GUARDED_SUBPROCESS_S:
                    try:
                        with open(progress) as f:
                            reached = int(f.read() or 0)
                    except (OSError, ValueError):
                        pass
                    if reached >= GUARDED_KILL_AT:
                        break
                    time.sleep(0.05)
                if proc.poll() is None:
                    proc.send_signal(signal.SIGTERM)
                chaos_rc = proc.wait(timeout=GUARDED_SUBPROCESS_S)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        walls['chaos'] = time.perf_counter() - t0
        with open(os.path.join(work, 'chaos.out')) as f:
            chaos_out = f.read()[-3000:]
        if chaos_rc != RESUMABLE_RC or reached < GUARDED_KILL_AT:
            raise AssertionError(f'guarded chaos arm: rc {chaos_rc} (want '
                                 f'{RESUMABLE_RC}) at step {reached}:\n'
                                 f'{chaos_out}')
        with open(os.path.join(work, 'chaos.json')) as f:
            chaos = json.load(f)
        check_guarded_steps('guarded chaos', chaos['hook_steps'],
                            chaos['launches'], chaos['routes'], want)
        means = [w['loss']['mean'] for w in chaos['windows']
                 if w['loss']['count']]
        poisoned = [i for i, m in enumerate(means) if not np.isfinite(m)]
        if poisoned != [1] or not np.isfinite(means[2:]).all():
            raise AssertionError(f'guarded chaos arm: window loss means '
                                 f'{means} (the poisoned window second, the '
                                 f'replays finite)')

        metrics = os.path.join(d, 'resume.jsonl')
        ckpt = os.path.join(work, 'ckpt')
        t0 = time.perf_counter()
        resume = subprocess.run(
            [sys.executable, '-m', 'se3_transformer_torch.training.cli',
             '--guarded', '--ckpt-dir', ckpt, '--steps', str(GUARDED_STEPS),
             '--accum', str(GUARDED_ACCUM), '--flush-every',
             str(GUARDED_WINDOW), '--pipelined', '--metrics', metrics],
            cwd=HERE, capture_output=True, text=True,
            timeout=GUARDED_SUBPROCESS_S)
        walls['resume'] = time.perf_counter() - t0
        if resume.returncode != 0:
            raise AssertionError(f'guarded resume (the CLI): rc '
                                 f'{resume.returncode}\n'
                                 f'{(resume.stdout + resume.stderr)[-3000:]}')
        info = validate_stream(metrics)
        with open(metrics) as f:
            records = [json.loads(line) for line in f if line.strip()]
        guard = [r for r in records if r['kind'] == 'guard'][-1]
        summary_cli = [r for r in records if r['kind'] == 'summary'][-1]
        post_first = sum(r['runtime']['compile_events_delta']
                         for r in records if r['kind'] == 'flush')
        state = CheckpointManager(ckpt).restore()
        final_diff = params_max_abs_diff(controls[0], state[0])
    if not ({'flush', 'pipeline', 'guard', 'summary'} <= set(info['kinds'])
            and guard['rollbacks'] >= 1 and guard['injections_total'] >= 1
            and guard['preemptions'] == 1 and guard['restarts'] == 1
            and guard['diverged'] is False and state[2] == GUARDED_STEPS
            and summary_cli['retrace_warnings_total'] == 0
            and post_first == 0):
        raise AssertionError(f'guarded resume: kinds {info["kinds"]}, guard '
                             f'{guard}, final step {state[2]}, retrace '
                             f'warnings {summary_cli["retrace_warnings_total"]}'
                             f', one-time work after the first step '
                             f'{post_first}')
    if final_diff > 2 * spread:
        raise AssertionError(f'guarded resume: final parameters differ from '
                             f'the control by {final_diff} (two controls '
                             f'differ by {spread})')

    # a clean telemetry step against an unguarded one (no telemetry) on the
    # same device batch and noise, in turns; the host syncs of each
    tele = st.DenoiseTrainer(cfg)
    plain = st.DenoiseTrainer(st.DenoiseConfig(accum_steps=GUARDED_ACCUM))
    batch = tele.to_device(tele.micro_batches_host())
    noise = torch.randn(batch['coords'].shape, device='cuda',
                        generator=torch.Generator('cuda').manual_seed(5))
    step_ms = {'telemetry': [], 'plain': []}
    for name in ('telemetry', 'plain') + ('telemetry', 'plain', 'plain',
                                         'telemetry') * 2:
        trainer = tele if name == 'telemetry' else plain
        before = counts(), routed()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, noise=noise)
        torch.cuda.synchronize()
        step_ms[name].append((time.perf_counter() - t0) * 1e3)
        check_step(f'guarded {name}', len(step_ms[name]), before, want)
    before = counts(), routed()
    step_syncs = count_host_syncs(lambda: tele.train_step(batch,
                                                          noise=noise))
    step_sync_msgs = list(LAST_SYNCS)
    check_step('guarded sync count', 0, before, want)
    flush_syncs = count_host_syncs(tele.telemetry_flush)
    if step_syncs != 0 or flush_syncs != 1:
        raise AssertionError(f'guarded: {step_syncs} host syncs in a clean '
                             f'telemetry step (want 0: {step_sync_msgs[:3]}),'
                             f' {flush_syncs} in a flush (want 1: '
                             f'{LAST_SYNCS[:3]})')
    launches = counts()
    del tele, plain
    torch.cuda.empty_cache()
    tel = float(np.median(step_ms['telemetry'][1:]))
    pl = float(np.median(step_ms['plain'][1:]))
    ms = chaos['ms']
    log('denoise_guarded', json.dumps(dict(
        config=f'DenoiseConfig(accum_steps={GUARDED_ACCUM}, telemetry=True, '
               f'flush_every={GUARDED_WINDOW}, pipeline=True)',
        steps=GUARDED_STEPS,
        rc=dict(control=0, weakened=weak_res.exit_code, chaos=chaos_rc,
                resume=resume.returncode),
        wall_s=walls, phase_s=time.perf_counter() - t_phase,
        launches_per_step=dict(zip(COUNT_NAMES, want)),
        chaos=dict(counters=chaos['counters'], steps=chaos['steps'],
                   killed_at=reached, window_loss_means=means,
                   injected=chaos['injected']),
        guard=guard, control_spread=spread, final_max_abs_diff=final_diff,
        bit_exact=final_diff == 0.0,
        guarded_step_ms=guarded_step_ms,
        guarded_step_ms_median=float(np.median(guarded_step_ms)),
        telemetry_step_ms=step_ms['telemetry'], plain_step_ms=step_ms['plain'],
        telemetry_step_ms_median=tel, plain_step_ms_median=pl,
        telemetry_overhead=tel / pl - 1,
        host_syncs=dict(telemetry_step=step_syncs, flush=flush_syncs),
        flush_ms=flush_ms, restore_load_ms=ms['restore_load'],
        restore_adopt_ms=ms['restore_adopt'],
        emergency_save_ms=ms['emergency_save'], save_async_ms=ms['save_async'],
        control_summary=dict(nodes_steps_per_sec=summary.get(
            'nodes_steps_per_sec'), loss_first=summary.get('loss_first'),
            loss_last=summary.get('loss_last')),
        resume_summary=dict(nodes_steps_per_sec=summary_cli.get(
            'nodes_steps_per_sec'), retrace_warnings_total=summary_cli[
            'retrace_warnings_total']),
        stream=info['kinds'])))
    return launches


def checkpoint_round_trip(recipe, trainer, fresh, batch, noise):
    """The checkpoint manager at full width: save_async of the trainer's
    (params, opt_state, step), one in-place step while the write may run,
    the checkpoint holding the saved state bit for bit (weights and Adam's
    moments), and `fresh` restored from it taking that step to the same
    loss within RESUME_RTOL."""
    import tempfile
    from se3_transformer_torch.training import CheckpointManager
    params = {k: v.clone() for k, v in trainer.params.items()}
    moments = {i: v['exp_avg'].clone()
               for i, v in trainer.optimizer.state_dict()['state'].items()}
    step = trainer.step_count
    with tempfile.TemporaryDirectory() as d, CheckpointManager(d) as cm:
        t0 = time.perf_counter()
        cm.save_async(step, (trainer.params, trainer.opt_state, step))
        save_async_ms = (time.perf_counter() - t0) * 1e3
        want = float(trainer.train_step(batch, noise=noise))
        t0 = time.perf_counter()
        cm.wait_until_finished()
        wait_ms = (time.perf_counter() - t0) * 1e3
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for f in os.listdir(d))
        t0 = time.perf_counter()
        state = cm.restore(like=(fresh.params, fresh.opt_state, 0))
        restore_ms = (time.perf_counter() - t0) * 1e3
    stale = [k for k, v in params.items()
             if not torch.equal(state[0][k].to(v.device), v)]
    stale += [i for i, v in moments.items()
              if not torch.equal(state[1]['state'][i]['exp_avg'].to(v.device),
                                 v)]
    fresh.restore(state)
    got = float(fresh.train_step(batch, noise=noise))
    rel = abs(got - want) / abs(want)
    log('checkpoint', json.dumps(dict(
        recipe=recipe, step=step, bytes=nbytes, save_async_ms=save_async_ms,
        wait_ms=wait_ms, restore_ms=restore_ms, next_loss=got,
        uninterrupted_loss=want, rel_err=rel)))
    if stale or state[2] != step or rel > RESUME_RTOL:
        raise AssertionError(f'{recipe} checkpoint round trip: stale '
                             f'{stale[:5]}, step {state[2]}, next loss {got} '
                             f'vs {want}')


def egnn_loss(model, batch, noise):
    """scripts/run_baselines.py's objective for an EGNN model: the mean
    square of its degree-1 output (the hidden fiber's, [b, n, dim, 3]) on
    the noised coordinates."""
    out = model(batch['feats'], batch['coords'] + noise,
                mask=batch['masks'], return_type=1)
    return (out ** 2).mean()


def phase_egnn_serve(st, want):
    """egnn_stress (the JAX recipe: dim 16, depth 12 EGNN layers with
    feedforward blocks, clamp 2, k = 16, reversible; seeded flax-scheme
    weights, conv_in conditioned) served by InferenceEngine at bucket
    EGNN_N with return_type=1 on requests of EGNN_N, EGNN_N - 12 and
    EGNN_N * 2 // 3 nodes of an N/CA/C backbone: outputs [n, 16, 3], finite;
    exactly `want` launches (conv_in's two O = 16 pairs, #3's narrow-O
    arm) and no routed call per forward; equivariance of
    the vector output; a profile (device busy, idle share) and the peak
    memory. Returns the launches of the phase."""
    from se3_transformer_torch.so3 import rot
    rng = np.random.RandomState(40)
    model = condition_weights(st.egnn_stress(
        generator=torch.Generator().manual_seed(40)))
    dim = model.fiber_in[0]
    torch.cuda.reset_peak_memory_stats()
    engine = st.InferenceEngine(model, buckets=(EGNN_N,), return_type=1)
    requests = [(rng.normal(size=(n, dim)).astype(np.float32),
                 chain_coords(rng, n, BACKBONE_BONDS))
                for n in (EGNN_N, EGNN_N - 12, EGNN_N * 2 // 3)]
    reset_counts()
    engine.predict(*requests[0])    # warm-up
    forwards, latencies = 1, []
    for i, (feats, coords) in enumerate(requests):
        before, routed_before = counts(), routed()
        t0 = time.perf_counter()
        out = engine.predict(feats, coords)
        latencies.append((time.perf_counter() - t0) * 1e3)
        forwards += 1
        launched = tuple(a - b for a, b in zip(counts(), before))
        routes = tuple(a - b for a, b in zip(routed(), routed_before))
        if out.shape != (len(feats), dim, 3) or not np.isfinite(out).all():
            raise AssertionError(f'egnn_stress request {i}: shape '
                                 f'{out.shape} or non-finite output')
        if launched != want or routes != NO_ROUTES:
            raise AssertionError(f'egnn_stress request {i}: launches '
                                 f'{launched}, want {want}; routed {routes}')
        log('serve', json.dumps(dict(recipe='egnn_stress', request=i,
                                     n=len(feats), bucket=EGNN_N,
                                     latency_ms=latencies[-1],
                                     launches=launched, routed=routes)))
    R = rot(0.31, -1.2, 0.7)
    feats, coords = requests[0]
    out = engine.predict(feats, coords)
    out_r = engine.predict(feats, (coords.astype(np.float64) @ R.T)
                           .astype(np.float32))
    forwards += 2
    equi = float(np.abs(out_r - out.astype(np.float64) @ R.T).max())
    scale = float(np.abs(out).max())
    top, kernel_ms, attn_ms, device_ms, wall_ms, syncs, _, _ = \
        profile_request(engine, requests[0])
    forwards += 2
    log('egnn_serve', json.dumps(dict(
        recipe='egnn_stress', request_ms=latencies, request_wall_ms=wall_ms,
        device_busy_ms=device_ms, idle_share=1 - device_ms / wall_ms,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        rotation_max_abs_diff=equi, max_abs_out=scale,
        host_syncs_per_forward=syncs, top_device_ops=top[:8])))
    if equi > ROTATION_RTOL * scale:
        raise AssertionError(f'egnn_stress: equivariance {equi} > '
                             f'{ROTATION_RTOL} * max|out| {scale}')
    launches = counts()
    if launches != tuple(w * forwards for w in want):
        raise AssertionError(f'egnn_stress: launches {launches} for '
                             f'{forwards} forwards')
    routed_exactly('egnn_stress', NO_ROUTES)
    del engine, model
    torch.cuda.empty_cache()
    return launches


def molecular_inputs(st, seed, n=MOL_N, device='cuda'):
    """molecular_batch's draw (atom tokens, a chain skeleton, symmetric
    bond tokens, the chain adjacency, the invariant target) as tensors on
    `device`."""
    batch = st.molecular_batch(np.random.RandomState(seed), 1, n, 28, 4)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def phase_molecular_serve(st, want):
    """molecular_edges at its full width and depth (seeded weights,
    conditioned) called with adj_mat and edges at n = 128: three timed
    forwards (all atoms real; the last MOL_MASKED masked; the coordinates
    rotated in float64 on the host), each with exactly `want` launches
    (COUNT_NAMES order) and no routed call, finite outputs, the scalar
    output invariant under the rotation within ROTATION_RTOL; a profiled
    forward. Returns the phase's launches."""
    from se3_transformer_torch.so3 import rot
    model = condition_weights(st.molecular_edges(
        generator=torch.Generator().manual_seed(24))).eval()
    t = molecular_inputs(st, 24)
    masked = t['masks'].clone()
    masked[0, -MOL_MASKED:] = False
    R = rot(-0.42, 0.93, 1.71)
    coords_r = torch.as_tensor(
        (t['coords'].cpu().numpy().astype(np.float64) @ R.T)
        .astype(np.float32), device='cuda')

    def forward(coords=t['coords'], mask=t['masks']):
        with torch.inference_mode():
            out = model(t['tokens'], coords, mask, adj_mat=t['adj_mat'],
                        edges=t['edges'])
        torch.cuda.synchronize()
        return out

    reset_counts()
    forward()                       # warm-up: allocator, cuBLAS handles
    forwards = 1
    outs = {}
    for label, coords, mask in (('full', t['coords'], t['masks']),
                                ('masked', t['coords'], masked),
                                ('rotated', coords_r, t['masks'])):
        before, routed_before = counts(), routed()
        t0 = time.perf_counter()
        out = forward(coords, mask)
        dt = time.perf_counter() - t0
        forwards += 1
        launched = tuple(a - b for a, b in zip(counts(), before))
        routes_ = tuple(a - b for a, b in zip(routed(), routed_before))
        out = out.float().cpu().numpy()
        if out.shape != (1, MOL_N, MOL_DIM) or not np.isfinite(out).all():
            raise AssertionError(f'molecular_edges {label}: shape '
                                 f'{out.shape} or non-finite output')
        if launched != want or routes_ != NO_ROUTES:
            raise AssertionError(f'molecular_edges {label}: launches '
                                 f'{COUNT_NAMES} = {launched}, want {want}; '
                                 f'routed {ROUTE_NAMES} = {routes_}')
        outs[label] = out
        log('serve', json.dumps(dict(
            recipe='molecular_edges', request=label, n=MOL_N, E=MOL_E,
            real_atoms=int(mask.sum()), latency_ms=dt * 1e3,
            launches=launched, routed=routes_)))
    inv = float(np.abs(outs['rotated'] - outs['full']).max())
    scale = float(np.abs(outs['full']).max())
    prof = profile_call(forward)
    syncs = count_host_syncs(forward)
    forwards += 2
    wall_ms, device_ms = prof.wall_ms, prof_busy_ms(prof)
    log('profile', json.dumps(dict(
        recipe='molecular_edges', request_wall_ms=wall_ms,
        device_busy_ms=device_ms, idle_share=1 - device_ms / wall_ms,
        pairwise_kernel_ms=kernels_ms(prof, FORWARD_KERNELS),
        host_syncs_per_forward=syncs, top_device_ops=top_device_ops(prof))))
    launches = counts()
    if launches != tuple(w * forwards for w in want):
        raise AssertionError(f'molecular_edges: launches {launches} for '
                             f'{forwards} forwards')
    routed_exactly('molecular_edges serve', NO_ROUTES)
    log('serve', json.dumps(dict(recipe='molecular_edges',
                                 rotation_max_abs_diff=inv, max_abs_out=scale,
                                 rtol=ROTATION_RTOL, forwards=forwards,
                                 launches=launches)))
    if inv > ROTATION_RTOL * scale:
        raise AssertionError(f'molecular_edges: rotation invariance {inv} > '
                             f'{ROTATION_RTOL} * max|out| {scale}')
    del model
    torch.cuda.empty_cache()
    return launches


def phase_molecular_train(st, want):
    """molecular_edges' property regression (property_loss on the pooled
    scalar head against molecular_batch's invariant target) at n = 128
    with Adam 1e-4: one warm-up step, then TRAIN_STEPS timed ones, each
    with exactly `want` launches and no routed call; finite
    decreasing losses, finite gradients, step time, nodes*steps/s, peak
    memory and a profiled step. Returns the launches of the steps."""
    model = condition_weights(st.molecular_edges(
        generator=torch.Generator().manual_seed(27)))
    trainer = st.DenoiseTrainer(model, lr=1e-4, loss_fn=st.property_loss)
    batch = molecular_inputs(st, 27)
    reset_counts()
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(1 + TRAIN_STEPS):
        before, routed_before = counts(), routed()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_step(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = tuple(a - b for a, b in zip(counts(), before))
        routes_ = tuple(a - b for a, b in zip(routed(), routed_before))
        losses.append(float(loss))
        if launched != want or routes_ != NO_ROUTES:
            raise AssertionError(f'molecular_edges train step {step}: '
                                 f'launches {COUNT_NAMES} = {launched}, want '
                                 f'{want}; routed {ROUTE_NAMES} = {routes_}')
        if step:
            step_ms.append(dt * 1e3)
        log('train', json.dumps(dict(recipe='molecular_edges', step=step,
                                     warmup=step == 0, loss=losses[-1],
                                     step_ms=dt * 1e3, launches=launched,
                                     routed=routes_)))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = counts()
    routed_exactly('molecular_edges train', NO_ROUTES)
    bad = [name for name, p in model.named_parameters()
           if p.grad is not None and not torch.isfinite(p.grad).all()]
    if not np.isfinite(losses).all() or losses[-1] >= losses[0] or bad:
        raise AssertionError(f'molecular_edges train: losses {losses}, '
                             f'non-finite gradients in {bad}')
    log('train', json.dumps(dict(
        recipe='molecular_edges', n=MOL_N, steps=TRAIN_STEPS,
        step_ms_median=float(np.median(step_ms)), step_ms=step_ms,
        nodes_steps_per_s=MOL_N * TRAIN_STEPS / (sum(step_ms) / 1e3),
        max_memory_allocated_gb=peak_gb, first_loss=losses[0],
        last_loss=losses[-1], launches=launches)))
    profiled = profile_step(trainer, batch, None)
    profiled.pop('profile')
    log('train_profile', json.dumps(dict(recipe='molecular_edges',
                                         **profiled)))
    del trainer, model
    torch.cuda.empty_cache()
    return launches


def molecular_reference(st, train):
    """molecular_edges at depth 1 (n = 40, the last 6 atoms masked) on the
    card (#3, A and B at O = 192) and on the CPU from the same weights:
    the forward (REF_RTOL_F32), or with `train` one property_loss step's
    loss and every gradient (REF_GRAD_RTOL_F32)."""
    results = []
    for device in ('cuda', 'cpu'):
        model = st.molecular_edges(depth=1, device=device,
                                   generator=torch.Generator().manual_seed(28))
        batch = molecular_inputs(st, 29, n=40, device=device)
        batch['masks'][0, -6:] = False
        if train:
            trainer = st.DenoiseTrainer(model, lr=1e-4, device=device,
                                        loss_fn=st.property_loss)
            loss = float(trainer.train_step(batch))
            results.append((loss, {k: p.grad.float().cpu() for k, p in
                                   model.named_parameters()
                                   if p.grad is not None}))
            continue
        with torch.inference_mode():
            results.append(model.eval()(
                batch['tokens'], batch['coords'], batch['masks'],
                adj_mat=batch['adj_mat'], edges=batch['edges'])
                .float().cpu().numpy())
    if not train:
        err = float(np.abs(results[0] - results[1]).max())
        scale = float(np.abs(results[1]).max())
        log('reference', json.dumps(dict(recipe='molecular_edges',
                                         max_abs_err=err, max_abs_cpu=scale,
                                         rtol=REF_RTOL_F32)))
        if not (np.isfinite(results[0]).all() and err <= REF_RTOL_F32 * scale):
            raise AssertionError(f'card vs CPU (molecular_edges): {err} > '
                                 f'{REF_RTOL_F32} * {scale}')
        return
    (loss_c, grads_c), (loss_h, grads_h) = results
    if set(grads_c) != set(grads_h):
        raise AssertionError('molecular_edges: card and CPU differ in which '
                             'parameters have gradients')
    rel = {k: float((grads_c[k] - g).abs().max())
           / max(float(g.abs().max()), 1e-30) for k, g in grads_h.items()}
    worst_key = max(rel, key=rel.get)
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    log('train_reference', json.dumps(dict(
        recipe='molecular_edges', loss_card=loss_c, loss_cpu=loss_h,
        loss_rel_err=loss_rel, worst_grad_rel_err=rel[worst_key],
        worst_grad=worst_key, leaves=len(grads_h), rtol=REF_GRAD_RTOL_F32)))
    if not all(np.isfinite(list(rel.values()))) or \
            loss_rel > REF_GRAD_RTOL_F32 or rel[worst_key] > REF_GRAD_RTOL_F32:
        raise AssertionError(f'train card vs CPU (molecular_edges): loss '
                             f'{loss_rel}, gradient {worst_key} '
                             f'{rel[worst_key]} > {REF_GRAD_RTOL_F32}')


# the small models that the reference phases run on the card and the CPU:
# flagship_fast's fields (float32 and bf16 radial trunk; with the fused
# attention; with the streaming attention in float32 and bf16) and
# flagship's (grouped convs, float32, 64 nodes in 3 padded node chunks)
SMALL = dict(dim=64, depth=1, num_degrees=4, heads=8, dim_head=8,
             attend_self=True, num_neighbors=16, shared_radial_hidden=True,
             reversible=True)
SMALL_FAST = dict(SMALL, fuse_basis=True, remat_policy='save_conv_outputs')
SMALL_CASES = (
    ('flagship_fast', dict(SMALL_FAST, radial_bf16=False), False),
    ('flagship_fast', dict(SMALL_FAST, radial_bf16=True), True),
    ('flagship_fast+pallas_attention',
     dict(SMALL_FAST, radial_bf16=False, pallas_attention=True), False),
    ('flagship_fast+fuse_pairwise',
     dict(SMALL_FAST, radial_bf16=False, fuse_pairwise=True), False),
    ('flagship_fast+fuse_pairwise',
     dict(SMALL_FAST, radial_bf16=True, fuse_pairwise=True), True),
    # the attention variants: tied keys and values with the null slot
    # through #7's tied variant; one kv head and the null slot through
    # #5 and #6 (a group of 8 query heads over one kv head)
    ('flagship_fast+fuse_pairwise+tie',
     dict(SMALL_FAST, radial_bf16=False, fuse_pairwise=True,
          tie_key_values=True, use_null_kv=True), False),
    ('flagship_fast+pallas_attention+one_headed',
     dict(SMALL_FAST, radial_bf16=False, pallas_attention=True,
          one_headed_key_values=True, use_null_kv=True), False),
    ('flagship', dict(SMALL, edge_chunks=3), False),
    # conv_backend='so2': grouped (#3 on the band z), per pair (#3 on the
    # band rows of each pair), and through #7's so2 arm
    ('flagship_fast+so2', dict(SMALL_FAST, radial_bf16=False,
                               conv_backend='so2'), False),
    ('per-pair+so2', dict(SMALL, shared_radial_hidden=False, reversible=False,
                          conv_backend='so2'), False),
    ('flagship_fast+so2+fuse_pairwise',
     dict(SMALL_FAST, radial_bf16=False, fuse_pairwise=True,
          conv_backend='so2'), False),
    # af2_refinement's fields (a radial trunk per pair, coordinate
    # gradients) at dim 64: the kv convs' O = 192 takes #3 and kernels A
    # and B with three O tiles
    ('af2_refinement', dict(dim=64, depth=1, num_degrees=2, attend_self=True,
                            num_neighbors=16, differentiable_coors=True),
     False))


def phase_train_reference(st):
    """Small model: one DenoiseTrainer step on the card (kernels) and on the
    CPU (plain versions) from the same weights and noise; the loss and
    every gradient compared."""
    rng = np.random.RandomState(6)
    n = 64
    batch = dict(feats=rng.normal(size=(1, n, 64)).astype(np.float32),
                 coords=chain_coords(rng, n)[None],
                 masks=np.ones((1, n), bool))
    batch['masks'][0, -5:] = False
    noise = rng.normal(size=(1, n, 3)).astype(np.float32)
    for recipe, fields, bf16 in SMALL_CASES:
        tol = REF_GRAD_RTOL_BF16 if bf16 else REF_GRAD_RTOL_F32
        cfg = dict(fields, output_degrees=2, reduce_dim_out=True)
        results = []
        for device in ('cuda', 'cpu'):
            model = st.SE3TransformerModule(
                **cfg, device=device,
                generator=torch.Generator().manual_seed(7))
            trainer = st.DenoiseTrainer(model, lr=1e-4, device=device)
            loss = float(trainer.train_step(batch, noise=noise))
            results.append((loss, {k: p.grad.float().cpu()
                                   for k, p in model.named_parameters()
                                   if p.grad is not None}))
        (loss_c, grads_c), (loss_h, grads_h) = results
        if set(grads_c) != set(grads_h):
            raise AssertionError('card and CPU differ in which parameters '
                                 'have gradients')
        worst, worst_key = 0.0, None
        for key, ref in grads_h.items():
            scale = float(ref.abs().max())
            rel = float((grads_c[key] - ref).abs().max()) / max(scale, 1e-30)
            if not np.isfinite(rel):
                raise AssertionError(f'train reference: {key} not finite')
            if rel > worst:
                worst, worst_key = rel, key
        loss_rel = abs(loss_c - loss_h) / abs(loss_h)
        log('train_reference', json.dumps(dict(
            recipe=recipe, radial_bf16=bf16, loss_card=loss_c, loss_cpu=loss_h,
            loss_rel_err=loss_rel, worst_grad_rel_err=worst,
            worst_grad=worst_key, leaves=len(grads_h), rtol=tol)))
        if loss_rel > tol or worst > tol:
            raise AssertionError(f'train card vs CPU ({recipe}, '
                                 f'radial_bf16={bf16}): '
                                 f'loss {loss_rel}, gradient {worst_key} '
                                 f'{worst} > {tol}')
    molecular_reference(st, train=True)


def phase_reference(st):
    """Small model: card (kernel path) vs the same weights on the CPU."""
    rng = np.random.RandomState(1)
    n = 64
    feats = rng.normal(size=(1, n, 64)).astype(np.float32)
    coords = chain_coords(rng, n)[None]
    mask = np.ones((1, n), bool)
    mask[0, -5:] = False
    for recipe, cfg, bf16 in SMALL_CASES:
        tol = REF_RTOL_BF16 if bf16 else REF_RTOL_F32
        outs = []
        for device in ('cuda', 'cpu'):
            model = st.SE3TransformerModule(
                **cfg, device=device,
                generator=torch.Generator().manual_seed(2)).eval()
            with torch.inference_mode():
                args = [torch.as_tensor(a, device=device)
                        for a in (feats, coords, mask)]
                outs.append(model(*args).float().cpu().numpy())
        err = float(np.abs(outs[0] - outs[1]).max())
        scale = float(np.abs(outs[1]).max())
        log('reference', json.dumps(dict(recipe=recipe, radial_bf16=bf16,
                                         max_abs_err=err, max_abs_cpu=scale,
                                         rtol=tol)))
        if not (np.isfinite(outs[0]).all() and err <= tol * scale):
            raise AssertionError(f'card vs CPU ({recipe}, radial_bf16='
                                 f'{bf16}): {err} > {tol} * {scale}')
    molecular_reference(st, train=False)


# the rest of the model surface on small models, card against CPU: each
# case (label, fields, bf16 tolerances, the forward's extra input). The
# conv_bf16 ones round V2 (or the basis and x) to bf16 from float32 values
# that differ in their last bits between the card's kernels and the CPU's
# plain versions, as the bf16 radial trunk rounds its own: the bf16
# tolerances. EGNN cases train at flax's init (its Dense kernels
# normal(1e-3)), where the self slot's cancellation (tests/test_torch_egnn.py)
# stays ~1e-5 of the gradients; at that init every EGNN update is ~1e-6 of
# the features, so their forward is also compared with the EGNN layers'
# Dense kernels redrawn at normal / sqrt(fan in) (redraw_egnn_dense).
FIELD_CASES = (
    ('flagship+conv_bf16', dict(SMALL, edge_chunks=3, conv_bf16=True), True,
     None),
    ('flagship_fast+conv_bf16', dict(SMALL_FAST, radial_bf16=True,
                                     conv_bf16=True), True, None),
    ('flagship+norm_gated_scale', dict(SMALL, edge_chunks=3,
                                       norm_gated_scale=True), False, None),
    ('egnn', dict(dim=16, depth=2, num_degrees=2, num_neighbors=16,
                  use_egnn=True, egnn_hidden_dim=16,
                  egnn_weights_clamp_value=2.0, egnn_feedforward=True),
     False, None),
    ('egnn+adjacency_edges', dict(dim=16, depth=2, num_degrees=2,
                                  num_neighbors=0, use_egnn=True,
                                  attend_sparse_neighbors=True,
                                  max_sparse_neighbors=4, num_adj_degrees=2,
                                  adj_dim=4), False, 'adj_mat'),
    ('flagship_fast+pallas_false', dict(SMALL_FAST, radial_bf16=False,
                                        pallas=False), False, None),
    ('flagship_fast+neighbors', dict(SMALL_FAST, radial_bf16=False), False,
     'neighbors'))


def knn_lists(coords, mask, k):
    """Each node's k nearest real nodes but itself (host numpy): the
    precomputed neighbor lists a graph builder hands the forward, [1, n,
    k] indices and their validity."""
    d = np.linalg.norm(coords[0][:, None] - coords[0][None], axis=-1)
    d[~mask[0]] = np.inf
    d[:, ~mask[0]] = np.inf
    np.fill_diagonal(d, np.inf)
    idx = np.argsort(d, axis=1, kind='stable')[:, :k]
    return idx[None].astype(np.int64), \
        np.isfinite(np.take_along_axis(d, idx, 1))[None]


def redraw_egnn_dense(model, seed):
    """Every EGNN layer's Dense kernel redrawn in place at normal / sqrt(fan
    in) (0.10-0.25 at these widths) from a CPU generator, the scale the CPU
    tests draw them at, so that a wrong update term shows in the output."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, layer in model.egnn_net.named_modules():
            if name.startswith('egnn') and isinstance(layer, torch.nn.Linear):
                w = torch.randn(layer.weight.shape, generator=gen)
                layer.weight.copy_(w / layer.weight.shape[1] ** 0.5)


def phase_fields_reference(st):
    """FIELD_CASES on the card (kernels; conv_bf16 through the bf16-storage
    arms) against the same weights on the CPU: the vector output
    (return_type=1) and one Adam step of the mean square of it on noised
    coordinates (scripts/run_baselines.py's objective), its loss and every
    gradient; an EGNN case's vector output also with redraw_egnn_dense's
    kernels. pallas=False launches nothing and routes nothing on the
    card."""
    from se3_transformer_torch.utils.graph import chain_adjacency
    rng = np.random.RandomState(9)
    n = 40
    feats = rng.normal(size=(1, n, 64)).astype(np.float32)
    coords = chain_coords(rng, n, BACKBONE_BONDS)[None]
    mask = np.ones((1, n), bool)
    mask[0, -4:] = False
    noise = rng.normal(size=(1, n, 3)).astype(np.float32)
    extras = dict(adj_mat=chain_adjacency(n),
                  neighbors=knn_lists(coords, mask, 16))
    for label, fields, bf16, extra in FIELD_CASES:
        cfg = dict(fields)
        if not cfg.get('use_egnn'):
            cfg.update(output_degrees=2, reduce_dim_out=True)
        dim = cfg['dim']
        tol = REF_RTOL_BF16 if bf16 else REF_RTOL_F32
        grad_tol = REF_GRAD_RTOL_BF16 if bf16 else REF_GRAD_RTOL_F32
        results, redrawn = [], []
        reset_counts()
        for device in ('cuda', 'cpu'):
            model = st.SE3TransformerModule(
                **cfg, device=device,
                generator=torch.Generator().manual_seed(10))
            kw = {}
            if extra:
                value = extras[extra]
                kw[extra] = tuple(torch.as_tensor(v, device=device)
                                  for v in value) \
                    if isinstance(value, tuple) else \
                    torch.as_tensor(value, device=device)
            args = [torch.as_tensor(a, device=device)
                    for a in (feats[..., :dim], coords, mask)]
            with torch.inference_mode():
                out = model.eval()(*args, return_type=1, **kw)
            model.train()

            def loss_fn(m, batch, eps, kw=kw):
                return (m(batch['feats'], batch['coords'] + eps,
                          mask=batch['masks'], return_type=1, **kw)
                        ** 2).mean()
            trainer = st.DenoiseTrainer(model, lr=1e-4, device=device,
                                        loss_fn=loss_fn)
            loss = float(trainer.train_step(
                dict(feats=feats[..., :dim], coords=coords, masks=mask),
                noise=noise))
            results.append((out.float().cpu().numpy(), loss,
                            {k: p.grad.float().cpu() for k, p in
                             model.named_parameters() if p.grad is not None}))
            if device == 'cuda':
                launched = dict(zip(COUNT_NAMES, counts()))
                card_routed = routed()
            if cfg.get('use_egnn'):
                redraw_egnn_dense(model, 11)
                with torch.inference_mode():
                    redrawn.append(model.eval()(*args, return_type=1, **kw)
                                   .float().cpu().numpy())
        (out_c, loss_c, grads_c), (out_h, loss_h, grads_h) = results
        err = float(np.abs(out_c - out_h).max())
        scale = float(np.abs(out_h).max())
        if set(grads_c) != set(grads_h):
            raise AssertionError(f'{label}: card and CPU differ in which '
                                 f'parameters have gradients')
        rel = {k: float((grads_c[k] - g).abs().max())
               / max(float(g.abs().max()), 1e-30) for k, g in grads_h.items()}
        worst_key = max(rel, key=rel.get)
        loss_rel = abs(loss_c - loss_h) / abs(loss_h)
        log('fields_reference', json.dumps(dict(
            recipe=label, max_abs_err=err, max_abs_cpu=scale, rtol=tol,
            loss_card=loss_c, loss_cpu=loss_h, loss_rel_err=loss_rel,
            worst_grad_rel_err=rel[worst_key], worst_grad=worst_key,
            leaves=len(grads_h), grad_rtol=grad_tol,
            launches={k: v for k, v in launched.items() if v},
            routed=card_routed)))
        if not (np.isfinite(out_c).all() and err <= tol * scale):
            raise AssertionError(f'card vs CPU ({label}): {err} > {tol} * '
                                 f'{scale}')
        if redrawn:
            err_w = float(np.abs(redrawn[0] - redrawn[1]).max())
            scale_w = float(np.abs(redrawn[1]).max())
            log('fields_reference', json.dumps(dict(
                recipe=label + '+redrawn_egnn_dense', max_abs_err=err_w,
                max_abs_cpu=scale_w, rtol=tol)))
            if not (np.isfinite(redrawn[0]).all()
                    and err_w <= tol * scale_w):
                raise AssertionError(f'card vs CPU ({label}, redrawn EGNN '
                                     f'kernels): {err_w} > {tol} * '
                                     f'{scale_w}')
        if not all(np.isfinite(list(rel.values()))) or \
                loss_rel > grad_tol or rel[worst_key] > grad_tol:
            raise AssertionError(f'train card vs CPU ({label}): loss '
                                 f'{loss_rel}, gradient {worst_key} '
                                 f'{rel[worst_key]} > {grad_tol}')
        if cfg.get('pallas') is False and (any(launched.values())
                                           or any(card_routed)):
            raise AssertionError(f'{label}: pallas=False launched '
                                 f'{launched} and routed {card_routed}')
        if cfg.get('conv_bf16') and not (launched['bxf_v16']
                                         + launched['fwd_v16']):
            raise AssertionError(f'{label}: no conv_bf16 arm launched')
    reset_counts()


# small quantized models for the card-vs-CPU check: the grouped #3
# (flagship), #7 untied and tied (fuse_pairwise, float32 h), and so2 (#3
# per pair, and #7's so2 arm)
QUANT_CASES = (
    ('flagship', dict(SMALL, edge_chunks=3)),
    ('flagship_fast+fuse_pairwise',
     dict(SMALL_FAST, radial_bf16=False, fuse_pairwise=True)),
    ('flagship_fast+fuse_pairwise+tie',
     dict(SMALL_FAST, radial_bf16=False, fuse_pairwise=True,
          tie_key_values=True, use_null_kv=True)),
    ('per-pair+so2', dict(SMALL, shared_radial_hidden=False, reversible=False,
                          conv_backend='so2')),
    ('flagship_fast+so2+fuse_pairwise',
     dict(SMALL_FAST, radial_bf16=False, fuse_pairwise=True,
          conv_backend='so2')))


def phase_quant_reference(st):
    """Small quantized models (QUANT_CASES, int8_mix and fp8_mix) on the
    card (the scaled arms) against the same quantized weights on the CPU
    (their plain versions): the forward within REF_RTOL_F32, and the
    scaled arms launched on the card."""
    import copy
    from se3_transformer_torch import quant
    rng = np.random.RandomState(3)
    n = 64
    feats = rng.normal(size=(1, n, 64)).astype(np.float32)
    coords = chain_coords(rng, n)[None]
    mask = np.ones((1, n), bool)
    mask[0, -5:] = False
    for recipe, cfg in QUANT_CASES:
        for mix in ('int8_mix', 'fp8_mix'):
            host = st.SE3TransformerModule(
                **cfg, device='cpu',
                generator=torch.Generator().manual_seed(4)).eval()
            quant.quantize_params(host, mix)
            card = copy.deepcopy(host).to('cuda')
            outs = []
            reset_counts()
            for model, device in ((card, 'cuda'), (host, 'cpu')):
                with torch.inference_mode():
                    args = [torch.as_tensor(a, device=device)
                            for a in (feats, coords, mask)]
                    outs.append(model(*args).float().cpu().numpy())
            launched = dict(zip(COUNT_NAMES, counts()))
            err = float(np.abs(outs[0] - outs[1]).max())
            scale = float(np.abs(outs[1]).max())
            log('quant_reference', json.dumps(dict(
                recipe=recipe, precision=mix, max_abs_err=err,
                max_abs_cpu=scale, rtol=REF_RTOL_F32,
                scaled_launches={k: launched[k]
                                 for k in ('fwd_q', 'flash_q')})))
            if not launched['fwd_q'] + launched['flash_q']:
                raise AssertionError(f'quant reference {recipe} {mix}: no '
                                     f'scaled arm launched')
            if not (np.isfinite(outs[0]).all()
                    and err <= REF_RTOL_F32 * scale):
                raise AssertionError(f'quantized card vs CPU ({recipe}, '
                                     f'{mix}): {err} > {REF_RTOL_F32} * '
                                     f'{scale}')
            del card, host
    reset_counts()


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import se3_transformer_torch as st
    from se3_transformer_torch.kernels import build
    from se3_transformer_torch.kernels import pairwise as kp

    # 1. device
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peak_key, peaks = peaks_for(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f'device: {name} | {smi} | torch {torch.__version__} cuda '
        f'{torch.version.cuda} | peaks of {peak_key}')

    # 2. build
    t_start = t0 = time.perf_counter()
    _T0.append(t_start)
    lib = build.library_path()
    build.load_library()
    log(f'build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib, HERE)}')
    entry = ''
    for line in build.build_log.splitlines():
        if 'Compiling entry function' in line:
            entry = line.split("'")[1]
        elif 'registers' in line or 'spill' in line and ' 0 bytes' not in line:
            log('ptxas:', entry[-64:], line.split(':', 1)[-1].strip())

    # 3. forward kernels vs plain: bxf at the flagship_fast pairs, fwd at
    # the flagship's grouped output degrees
    rows, worst = phase_kernels(st, peaks)
    tick('bxf')
    fwd_rows, fwd_worst = phase_fwd(kp, peaks)
    fwd_q_rows, fwd_q_worst = phase_fwd_q(kp, peaks)
    tick('fwd')

    # 4. backward kernels vs plain, at both recipes' shapes
    bwd_rows, bwd_worst = phase_backward(kp, peaks)
    grouped_rows, grouped_worst = phase_backward_grouped(kp, peaks)
    af2_rows, af2_worst = phase_backward_af2(kp, peaks)
    _, mol_fwd_worst, _, mol_worst = phase_backward_molecular(kp, peaks)
    tick('backward')
    # the narrow-O arms of #3, A and B
    narrow_rows, narrow_worst = phase_pairwise_narrow(kp, peaks)
    tick('pairwise_narrow')
    # conv_bf16's bf16-storage arms of #1, #3, A and B
    v16_bxf_rows, v16_bxf_worst = phase_conv_bf16_bxf(st, kp, peaks)
    v16_fwd_rows, v16_fwd_worst = phase_conv_bf16_fwd(kp, peaks)
    v16_bwd_rows, v16_bwd_worst = phase_conv_bf16_backward(kp, peaks)
    tick('conv_bf16')
    # the V2 family's mid-32, two-row arms of #3, A and B
    v2_fwd_rows, v2_bwd_rows, v2_fwd_worst, v2_bwd_worst = \
        phase_v2_kernels(kp, peaks)
    tick('v2_kernels')

    # 5. the attention kernels vs plain, with the library yardstick
    attn_rows, attn_worst = phase_attention(peaks)
    tick('attention')
    flash_rows, flash_worst = phase_flash(peaks)
    tie_rows, tie_worst = phase_flash_tie(peaks)
    so2_rows, so2_worst = phase_flash_so2(peaks)
    flash_q_rows, flash_q_all, flash_q_worst = phase_flash_q(peaks)
    tick('flash')
    gflash_rows, gflash_worst = phase_flash_global(peaks)
    gtie_rows, gtie_worst = phase_global_tie(peaks)
    gso2_rows, gso2_worst = phase_global_so2(peaks)
    tick('flash_global')
    log(f'phase: kernels done at {time.perf_counter() - t_start:.0f} s')

    # the block-config table's tuner, then the per-scope profile
    t_phase = time.perf_counter()
    phase_tune(kp)
    tick('tune', t_phase)
    t_phase = time.perf_counter()
    phase_profile(st, name, smi)
    tick('profile', t_phase)
    reset_counts()

    # 6-7. the main paths, each with the counts reset just before and read
    # just after; launch tuples in COUNT_NAMES order
    def launches(bxf=0, fwd=0, a=0, b=0, attn_fwd=0, attn_bwd=0, flash=0,
                 bx=0, glob=0, flash_so2=0, glob_so2=0, fwd_q=0, flash_q=0,
                 bxf_v16=0, fwd_v16=0, a_v16=0, b_v16=0, fwd_n=0, a_n=0,
                 b_n=0, fwd_m32=0, a_m32=0, b_m32=0):
        # the so2 arm's launches count in flash and glob as well, the
        # scaled arms' (of the dense arm) in fwd and flash, the conv_bf16
        # arms', the narrow-O arms' and the (wide) mid-32 arms' in bxf,
        # fwd, A and B
        return (bxf + bxf_v16, fwd + fwd_q + fwd_v16 + fwd_n + fwd_m32,
                a + a_v16 + a_n + a_m32, b + b_v16 + b_n + b_m32, attn_fwd,
                attn_bwd, flash + flash_so2 + flash_q, bx, glob + glob_so2,
                flash_so2, glob_so2, fwd_q, flash_q, bxf_v16, fwd_v16, a_v16,
                b_v16, fwd_n, a_n, b_n, fwd_m32, a_m32, b_m32)
    fast_bwd = dict(a=TRAIN_BWD_LAUNCHES, b=TRAIN_BWD_LAUNCHES)
    var = variant_counts()
    vd = dict(depth=VARIANT_DEPTH)
    v2_fwd, v2_bwd = v2_counts()
    bx_rows, bx_worst, bx_launches = phase_bx(st, peaks)
    paths = [not_routed('bx', bx_launches)]
    # the serving stack over mixed-length streams, then its entry point
    paths.append(not_routed('serve_stream', phase_serve_stream(st, {
        'flagship_fast': launches(bxf=4 + REPLAY_LAUNCHES + 4),
        'af2_refinement': launches(fwd=AF2_LAUNCHES, fwd_n=AF2_NARROW)})))
    phase_serve_cli()
    phase_serve_multi_cli(smi)
    tick('serve_cli')
    # the router over flagship_fast replicas on the one card
    paths.append(not_routed('serve_multi', phase_serve_multi(
        st, launches(bxf=4 + REPLAY_LAUNCHES + 4), smi)))
    paths += [
        # the assembly model: one 7g launch per output degree (2), untied
        # and tied
        not_routed('global serve', phase_global_serve(st, launches(glob=2))),
        not_routed('global serve tie', phase_global_serve(
            st, launches(glob=2), label='assembly+tie',
            tie_key_values=True)),
        not_routed('flagship_fast serve', phase_serve(
            st, 'flagship_fast', launches(bxf=4 + REPLAY_LAUNCHES + 4))),
        # with a checkpoint round trip of the trainer's state
        not_routed('flagship_fast train', phase_train(
            st, 'flagship_fast', launches(bxf=TRAIN_LAUNCHES, **fast_bwd),
            None, launches(bxf=TRAIN_LAUNCHES + REPLAY_LAUNCHES,
                           **fast_bwd), round_trip=True)),
        not_routed('flagship_fast+pallas_attention serve', phase_serve(
            st, 'flagship_fast', launches(bxf=4 + var['replay'] + 4,
                                          attn_fwd=var['attn']),
            label='flagship_fast+pallas_attention', pallas_attention=True,
            **vd)),
        not_routed('flagship_fast+pallas_attention train', phase_train(
            st, 'flagship_fast',
            launches(bxf=var['train'], attn_fwd=2 * var['attn'],
                     attn_bwd=var['attn'], a=var['train_bwd'],
                     b=var['train_bwd']), None,
            launches(bxf=var['train'] + var['replay'],
                     attn_fwd=2 * var['attn'], attn_bwd=var['attn'],
                     a=var['train_bwd'], b=var['train_bwd']),
            label='flagship_fast+pallas_attention', pallas_attention=True,
            **vd)),
        not_routed('flagship_fast+fuse_pairwise serve', phase_serve(
            st, 'flagship_fast',
            launches(bxf=FLASH_BXF_LAUNCHES, flash=ATTN_LAUNCHES),
            label='flagship_fast+fuse_pairwise', fuse_pairwise=True)),
        # tied keys and values with the null slot: #7's tied variant
        not_routed('flagship_fast+fuse_pairwise+tie serve', phase_serve(
            st, 'flagship_fast',
            launches(bxf=FLASH_BXF_LAUNCHES, flash=var['attn']),
            label='flagship_fast+fuse_pairwise+tie', fuse_pairwise=True,
            tie_key_values=True, use_null_kv=True, **vd)),
        not_routed('flagship_fast+tie train', phase_train(
            st, 'flagship_fast',
            launches(bxf=var['tie_train'], a=var['tie_bwd'],
                     b=var['tie_bwd']), None, None,
            label='flagship_fast+tie', tie_key_values=True, **vd)),
        not_routed('flagship serve', phase_serve(
            st, 'flagship', launches(fwd=FLAGSHIP_SERVE_LAUNCHES))),
        not_routed('flagship train', phase_train(
            st, 'flagship',
            launches(fwd=FLAGSHIP_TRAIN_LAUNCHES + FLAGSHIP_REPLAY_LAUNCHES,
                     a=FLAGSHIP_BWD_LAUNCHES, b=FLAGSHIP_BWD_LAUNCHES),
            'save_conv_outputs',
            launches(fwd=FLAGSHIP_TRAIN_LAUNCHES, a=FLAGSHIP_BWD_LAUNCHES,
                     b=FLAGSHIP_BWD_LAUNCHES))),
        # af2_refinement: the O = 32 pairs of conv_in and conv_out on the
        # narrow-O arms, nothing routed
        not_routed('af2_refinement serve', phase_serve(
            st, 'af2_refinement', launches(fwd=AF2_LAUNCHES, fwd_n=AF2_NARROW),
            dim=AF2_DIM, depth=2, vector=True, bonds=BACKBONE_BONDS)),
        not_routed('af2_refinement train', phase_train(
            st, 'af2_refinement', launches(
                fwd=AF2_LAUNCHES, fwd_n=AF2_NARROW, a=AF2_LAUNCHES,
                a_n=AF2_NARROW_BWD, b=AF2_LAUNCHES, b_n=AF2_NARROW_BWD),
            None, None, dim=AF2_DIM, depth=2)),
        # molecular_edges: likewise its 4 O = 32 pairs
        phase_molecular_serve(st, launches(fwd=MOL_LAUNCHES,
                                           fwd_n=MOL_NARROW)),
        phase_molecular_train(st, launches(
            fwd=MOL_LAUNCHES, fwd_n=MOL_NARROW, a=MOL_LAUNCHES,
            a_n=MOL_NARROW, b=MOL_LAUNCHES, b_n=MOL_NARROW)),
        # conv_backend='so2' (the so2 arms of #7 and 7g, #3 on the band z)
        not_routed('flagship_fast+so2 serve', phase_serve(
            st, 'flagship_fast', launches(fwd=var['so2_serve']),
            label='flagship_fast+so2', conv_backend='so2', **vd)),
        not_routed('flagship_fast+so2+fuse_pairwise serve', phase_serve(
            st, 'flagship_fast', launches(fwd=SO2_FLASH_FWD_LAUNCHES,
                                          flash_so2=var['attn']),
            label='flagship_fast+so2+fuse_pairwise', fuse_pairwise=True,
            conv_backend='so2', **vd)),
        not_routed('global serve so2', phase_global_serve(
            st, launches(glob_so2=2), label='assembly+so2',
            conv_backend='so2')),
        not_routed('flagship_fast+so2 train', phase_train(
            st, 'flagship_fast',
            launches(fwd=var['so2_train'], a=var['so2_bwd'],
                     b=var['so2_bwd']), None, None,
            label='flagship_fast+so2', conv_backend='so2', **vd)),
        # quantized serving: every #3 launch of flagship(int8_mix) takes
        # the scaled arm (float32 h); flagship_fast(fuse_pairwise,
        # fp8_mix) runs #7's scaled arm (bf16 h) and #1 on the transient
        # dequant of conv_in's and conv_out's w3
        not_routed('flagship+int8_mix serve', phase_serve(
            st, 'flagship', launches(fwd_q=var['flagship_serve']),
            label='flagship+int8_mix', precision='int8_mix', **vd)),
        not_routed('flagship_fast+fuse_pairwise+fp8_mix serve', phase_serve(
            st, 'flagship_fast',
            launches(bxf=FLASH_BXF_LAUNCHES, flash_q=var['attn']),
            label='flagship_fast+fuse_pairwise+fp8_mix', fuse_pairwise=True,
            precision='fp8_mix', **vd)),
        # conv_bf16: flagship_fast's #1 launches all by the bf16 basis/x
        # arm, its backward's A and B by the float32 arm; flagship's #3, A
        # and B all by the bf16-V2 arm
        not_routed('flagship_fast+conv_bf16 serve', phase_serve(
            st, 'flagship_fast',
            launches(bxf_v16=4 + var['replay'] + 4),
            label='flagship_fast+conv_bf16', conv_bf16=True, **vd)),
        not_routed('flagship_fast+conv_bf16 train', phase_train(
            st, 'flagship_fast', launches(bxf_v16=var['train'],
                                          a=var['train_bwd'],
                                          b=var['train_bwd']),
            None, None, label='flagship_fast+conv_bf16', conv_bf16=True,
            **vd)),
        not_routed('flagship+conv_bf16 serve', phase_serve(
            st, 'flagship', launches(fwd_v16=var['flagship_serve']),
            label='flagship+conv_bf16', conv_bf16=True, **vd)),
        not_routed('flagship+conv_bf16 train', phase_train(
            st, 'flagship', launches(
                fwd_v16=var['flagship_train'] + var['flagship_replay'],
                a_v16=var['flagship_bwd'], b_v16=var['flagship_bwd']),
            None, None, label='flagship+conv_bf16', conv_bf16=True, **vd)),
        # egnn_stress: conv_in's two O = 16 pairs on the narrow-O arms
        phase_egnn_serve(st, launches(fwd_n=EGNN_NARROW)),
        not_routed('egnn_stress train', phase_train(
            st, 'egnn_stress', launches(fwd_n=EGNN_NARROW, a_n=EGNN_NARROW,
                                        b_n=EGNN_NARROW), None, None,
            dim=16, depth=12, n=EGNN_N, loss_fn=egnn_loss)),
        # the JAX trainer (DenoiseConfig): every contraction on the
        # narrow-O arms; synthetic batches with a checkpoint and a resume,
        # then the converted sidechainnet fixture through the pipeline
        not_routed('denoise train', phase_denoise_train(st, launches(
            fwd_n=DENOISE_FWD, a_n=DENOISE_BWD, b_n=DENOISE_BWD))),
        not_routed('denoise pipelined', phase_denoise_pipelined(
            st, launches(fwd_n=DENOISE_FWD, a_n=DENOISE_BWD,
                         b_n=DENOISE_BWD))),
        # the guarded loop: rollback, kill and resume, the weakened arm
        not_routed('denoise guarded', phase_denoise_guarded(
            st, launches(fwd_n=GUARDED_FWD, a_n=GUARDED_BWD,
                         b_n=GUARDED_BWD))),
        # the V2 family: every contraction on the mid-32 arms, O = 64
        not_routed('se3_v2 serve', phase_serve(
            st, 'se3_v2', launches(fwd_m32=v2_fwd), dim=V2_DIM,
            depth=V2_DEPTH, vector=True, bonds=BACKBONE_BONDS,
            module=v2_module, rotation_rtol=V2_EQUIVARIANCE_RTOL,
            output_degrees=2, reduce_dim_out=True)),
        not_routed('se3_v2 train', phase_train(
            st, 'se3_v2', launches(fwd_m32=v2_fwd, a_m32=v2_bwd,
                                   b_m32=v2_bwd), None, None, dim=V2_DIM,
            depth=V2_DEPTH, n=V2_N, module=v2_module))]
    total = [sum(p[i] for p in paths) for i in range(len(COUNT_NAMES))]
    log(f'phase: main paths done at {time.perf_counter() - t_start:.0f} s')

    # C1: models past the kernels' limits route to the plain versions
    phase_route(st)
    phase_route_wide(st)
    log(f'phase: route done at {time.perf_counter() - t_start:.0f} s')

    # 8. references on small inputs
    phase_reference(st)
    tick('reference')
    phase_train_reference(st)
    tick('train_reference')
    phase_global_reference(st)
    phase_quant_reference(st)
    phase_fields_reference(st)
    log(f'phase: references done at {time.perf_counter() - t_start:.0f} s')

    def unchunked(table, dtype):
        return [r for r in table
                if r['E'] == 32768 and r['h_dtype'] == dtype]

    def bound_by(table, key):
        total_ms = sum(r[f'bound_ms{key}'] for r in table)
        ops = sum(r[f'bound_ms{key}'] for r in table
                  if r[f'bound_by{key}'] == 'operations')
        return 'operations' if ops * 2 >= total_ms else 'bytes'

    def entry(name, source, replaces, launched, err, table, key='',
              tie=None, dense=False):
        """One kernel's line: times and bounds summed over the table's rows
        (one hidden ConvSE3's launches at E = 32768, or one attention
        block's four degrees); with `tie`, the tied variant's rows, summed
        into tie_* keys (its untied time on the same operands beside); with
        `dense` (an so2 arm's rows), the dense arm's time and bound on the
        same operands as dense_ms and dense_bound_ms."""
        library = [r.get(f'library_ms{key}') for r in table]
        line = dict(name=name, route='cuda', source=src + source,
                    replaces=replaces, launches=launched, max_abs_err=err,
                    ms=sum(r[f'ms{key}'] for r in table),
                    plain_ms=sum(r[f'plain_ms{key}'] for r in table),
                    bound_ms=sum(r[f'bound_ms{key}'] for r in table),
                    bound_by=bound_by(table, key),
                    library_ms=None if None in library else sum(library))
        if dense:
            line.update({k: sum(r[k] for r in table)
                         for k in ('dense_ms', 'dense_bound_ms')})
        if tie:
            line.update({f'tie_{k}': sum(r[k] for r in tie)
                         for k in ('ms', 'plain_ms', 'bound_ms', 'untied_ms',
                                   'untied_bound_ms')})
            line['tie_bound_by'] = bound_by(tie, '')
        return line

    src = 'se3_transformer_torch/kernels/csrc/'
    tpu = 'se3_transformer_tpu/kernels/'
    pallas = tpu + 'pallas_pairwise.py:'
    bwd = unchunked(bwd_rows, 'bfloat16')
    kernels = [
        entry('fused_pairwise_conv_bxf', 'pairwise_bxf.cu', pallas + '593',
              total[0] - total[13], worst, unchunked(rows, 'bfloat16')),
        entry('fused_pairwise_conv', 'pairwise_fwd.cu', pallas + '254',
              total[1] - total[11] - total[14] - total[17] - total[20],
              max(fwd_worst, mol_fwd_worst), unchunked(fwd_rows, 'float32'))]
    for i, (k, line) in enumerate((('a', 861), ('b', 907))):
        kernels.append(entry(
            f'fused_pairwise_conv_bwd_{k}', 'pairwise_bwd.cu',
            f'{pallas}{line}',
            total[2 + i] - total[15 + i] - total[18 + i] - total[21 + i],
            max(bwd_worst[k], grouped_worst[k], af2_worst[k],
                mol_worst[k]), bwd,
            f'_{k}'))
    # the narrow-O arms at the DenoiseConfig trainer's six shapes (each
    # once); narrow_step lines weigh them by a step's launches
    # (bound_ms_fma beside: every product on float32 FMAs, as they run)
    narrow = [r for r in narrow_rows if r['model'] == 'DenoiseConfig']
    kernels += [dict(
        entry('fused_pairwise_conv_narrow', 'pairwise_narrow.cuh',
              pallas + '254', total[17], narrow_worst['fwd'], narrow),
        bound_ms_fma=sum(r['bound_ms_fma'] for r in narrow))]
    for i, (k, line) in enumerate((('a', 861), ('b', 907))):
        kernels.append(dict(entry(
            f'fused_pairwise_conv_bwd_{k}_narrow', 'pairwise_narrow.cuh',
            f'{pallas}{line}', total[18 + i], narrow_worst[k], narrow,
            f'_{k}'), bound_ms_fma=sum(r[f'bound_ms_fma_{k}']
                                       for r in narrow)))
    # the conv_bf16 arms at their units (E = 32768): #1's at the 16
    # flagship_fast pairs (bf16 h), #3's, A's and B's at the flagship's four
    # output degrees (float32 h); the float32 arm's time on the upcast
    # operands beside
    v16_unit = [r for r in v16_bxf_rows if r['E'] == 32768]
    v16_fwd = [r for r in v16_fwd_rows if r['E'] == 32768]
    v16_bwd = [r for r in v16_bwd_rows if r['E'] == 32768]
    kernels += [
        dict(entry('fused_pairwise_conv_bxf_conv_bf16', 'pairwise_bxf.cu',
                   pallas + '611', total[13], v16_bxf_worst, v16_unit),
             float_ms=sum(r['float_ms'] for r in v16_unit)),
        dict(entry('fused_pairwise_conv_conv_bf16', 'pairwise_fwd.cu',
                   pallas + '286', total[14], v16_fwd_worst, v16_fwd),
             float_ms=sum(r['float_ms'] for r in v16_fwd))]
    for i, (k, line) in enumerate((('a', 880), ('b', 917))):
        kernels.append(dict(entry(
            f'fused_pairwise_conv_bwd_{k}_conv_bf16', 'pairwise_bwd.cu',
            f'{pallas}{line}', total[15 + i], v16_bwd_worst[k], v16_bwd,
            f'_{k}'), float_ms=sum(r[f'float_ms_{k}'] for r in v16_bwd)))
    # the mid-32 arms (the V2 family) at their unit: one hidden
    # V2ConvSE3's 28 launches at E = 32768, float32 h, each shape's row
    # weighed by its launches
    def v2_unit(rows, key=''):
        return [dict(weighted([r], (f'ms{key}', f'plain_ms{key}',
                                    f'library_ms{key}', f'bound_ms{key}')),
                     **{f'bound_by{key}': r[f'bound_by{key}']})
                for r in rows if r['mult']]
    kernels.append(entry('fused_pairwise_conv_mid32', 'pairwise_fwd.cu',
                         pallas + '254', total[20], v2_fwd_worst,
                         v2_unit(v2_fwd_rows)))
    for i, (k, line) in enumerate((('a', 861), ('b', 907))):
        kernels.append(entry(
            f'fused_pairwise_conv_bwd_{k}_mid32', 'pairwise_bwd.cu',
            f'{pallas}{line}', total[21 + i], v2_bwd_worst[k],
            v2_unit(v2_bwd_rows, f'_{k}'), f'_{k}'))
    kernels += [
        entry('fused_attention_fwd', 'attention.cu',
              tpu + 'pallas_attention.py:74', total[4], attn_worst['fwd'],
              attn_rows, '_fwd'),
        entry('fused_attention_bwd', 'attention.cu',
              tpu + 'pallas_attention.py:267', total[5], attn_worst['bwd'],
              attn_rows, '_bwd'),
        entry('flash_attention', 'flash_fwd.cu', tpu + 'pallas_flash.py:699',
              total[6] - total[9] - total[12], max(flash_worst, tie_worst),
              flash_rows, tie=tie_rows),
        entry('flash_attention_so2', 'flash_fwd.cu',
              tpu + 'pallas_flash.py:289', total[9], so2_worst, so2_rows,
              dense=True),
        entry('fused_pairwise_conv_bx', 'pairwise_bxf.cu', pallas + '794',
              total[7], bx_worst, [r for r in bx_rows
                                   if r['h_dtype'] == 'bfloat16']),
        entry('flash_global_attention', 'flash_global.cu',
              tpu + 'pallas_flash.py:1073', total[8] - total[10],
              max(gflash_worst, gtie_worst), gflash_rows, tie=gtie_rows),
        entry('flash_global_attention_so2', 'flash_global.cu',
              tpu + 'pallas_flash.py:289', total[10], gso2_worst, gso2_rows,
              dense=True)]
    # the scaled arms: #3's at the served form (int8, float32 h), #7's at
    # the served form (fp8, dense, untied); the float arm's time on the
    # same operands beside, and every measured variant's sums
    def variants(table, keys, fields=('ms', 'unscaled_ms', 'plain_ms',
                                      'bound_ms')):
        out = {}
        for r in table:
            v = out.setdefault('/'.join(str(r[k]) for k in keys),
                               dict.fromkeys(fields, 0.0))
            for k in v:
                v[k] += r[k]
        return out
    served_fwd_q = [r for r in fwd_q_rows
                    if (r['storage'], r['h_dtype']) == ('int8', 'float32')]
    kernels += [
        dict(entry('fused_pairwise_conv_scaled', 'pairwise_fwd.cu',
                   pallas + '254', total[11], fwd_q_worst, served_fwd_q),
             unscaled_ms=sum(r['unscaled_ms'] for r in served_fwd_q),
             variants=variants(fwd_q_rows, ('storage', 'h_dtype'),
                               ('ms', 'unscaled_ms', 'plain_ms', 'bound_ms',
                                'library_ms'))),
        dict(entry('flash_attention_scaled', 'flash_fwd.cu',
                   tpu + 'pallas_flash.py:298', total[12], flash_q_worst,
                   flash_q_rows),
             unscaled_ms=sum(r['unscaled_ms'] for r in flash_q_rows),
             variants=variants(flash_q_all, ('storage', 'arm', 'tie')))]
    missing = [k['name'] for k in kernels if not k['launches']]
    if missing:
        raise AssertionError(f'kernels never launched on a main path: '
                             f'{missing}')
    log(smi)
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--guarded-worker']:
        sys.exit(guarded_worker(sys.argv[2]))
    sys.exit(main())
