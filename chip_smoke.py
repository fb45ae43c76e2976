#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (se3_transformer_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). Phases, each fatal on
failure:

  1. device   require CUDA; print the card's name and power limit; TF32 off.
  2. build    compile every kernel of the port from csrc/ with nvcc (sm_90a),
              one nvcc per source, all started together.
  3. kernels  hold the forward kernel against its plain PyTorch version on
              the card, at the shapes the forward gives it, and time both.
  4. backward hold backward kernels A (dV2, dW3, dB3) and B (dH) against
              their plain versions at the training step's shapes, time each,
              and require dW3/dB3 to be bit-identical across two runs.
  5. serve    the flagship_fast forward (dim=64, depth=6, 4 degrees, 8 heads,
              k=32, random seeded weights) served by InferenceEngine at
              bucket 1024: finite outputs, exactly 200 kernel launches per
              request, rotation invariance of the scalar output.
  6. train    the flagship_fast denoise training step (the vector head:
              output_degrees=2, reduce_dim_out=True; reversible with
              save_conv_outputs) at n=1024 with Adam: finite decreasing
              losses, finite gradients, exactly 204 forward and 204 + 204
              backward launches per step (396 forward under remat_policy
              None), step time, nodes*steps/s, peak memory and a profile.
  7. reference  small models on the card (kernel path) against the same
              weights on the CPU (plain path): the forward, and one training
              step's loss and every gradient.

Prints per-shape, per-request and per-step lines, then the nvidia-smi line,
a {"kernels": [...]} JSON line and, last, {"ok": true, "device": {...}}.
Exits non-zero, printing no result, without CUDA or without the package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# per-kernel check tolerance: kernel and plain version sum the same exact
# products in float32 and differ only in summation order
KERNEL_RTOL = 1e-4
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
# forward launches of one flagship_fast(output_degrees=2) forward: conv_in
# 1x4 pairs, 6 blocks x 2 convs x 4x4 pairs, conv_out 4x2 pairs. The
# backward launches kernels A and B once per pair that the loss reaches:
# return_type=1 reads only the degree-1 head, so conv_out's 4 pairs into
# degree 0 get no cotangent and autograd runs no backward for them.
# remat_policy=None replays the 192 trunk pairs.
TRAIN_LAUNCHES = 4 + 192 + 8
TRAIN_BWD_LAUNCHES = 4 + 192 + 4
REPLAY_LAUNCHES = 192
TRAIN_STEPS = 5

# published dense peaks by card (NVIDIA data sheets): bf16 tensor core,
# float32 CUDA core (FLOP/s), device memory bandwidth (bytes/s)
PEAKS = {
    'H100 PCIe': (756e12, 51e12, 2.0e12),
    'H100': (989e12, 67e12, 3.35e12),
    'H200': (989e12, 67e12, 4.8e12),
}

HERE = os.path.dirname(os.path.abspath(__file__))


def log(*args):
    print(*args, flush=True)


def peaks_for(name: str):
    for key in ('H100 PCIe', 'H200', 'H100'):
        if key in name:
            return key, PEAKS[key]
    return 'H100 (assumed)', PEAKS['H100']


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


def pairwise_cost(E, mid, C, O, P, Q, F, h_bytes, peaks):
    """(bound_ms, bound_by, flops) of one fused_pairwise_conv_bxf call:
    each input read once, the output written once. The V2 build and apply
    run at the float32 CUDA-core rate. With bf16 h the radial product runs
    on the tensor cores at the same time, so the operations take the
    longer of the two pipes; with float32 h both share the CUDA cores."""
    bf16_peak, f32_peak, mem = peaks
    radial = 2.0 * E * mid * C * F * O
    apply = 2.0 * E * P * C * F * O + 2.0 * E * P * F * C * Q
    if h_bytes == 2:
        ops_s = max(radial / bf16_peak, apply / f32_peak)
    else:
        ops_s = (radial + apply) / f32_peak
    nbytes = (E * mid * h_bytes + mid * C * F * O * h_bytes + C * F * O * 4
              + E * P * F * Q * 4 + E * C * Q * 4 + E * P * O * 4)
    bytes_s = nbytes / mem
    bound_by = 'operations' if ops_s >= bytes_s else 'bytes'
    return max(ops_s, bytes_s) * 1e3, bound_by, radial + apply


def phase_kernels(st, peaks):
    from se3_transformer_torch.kernels.pairwise import (
        fused_pairwise_conv_bxf, fused_pairwise_conv_bxf_plain,
    )
    gen = torch.Generator(device='cuda').manual_seed(0)
    dev = 'cuda'
    E, mid, C, O = 32768, 128, 64, 64
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
        out = fused_pairwise_conv_bxf(*args)
        torch.cuda.synchronize()
        ref = fused_pairwise_conv_bxf_plain(*args)
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        if not (np.isfinite(err) and err <= KERNEL_RTOL * scale):
            raise AssertionError(
                f'kernel ({di},{do}) E={e} {hdt}: max_abs_err {err} > '
                f'{KERNEL_RTOL} * max|plain| {scale}')
        worst = max(worst, err)
        ms = cuda_ms(lambda: fused_pairwise_conv_bxf(*args), reps=10)
        plain_ms = cuda_ms(lambda: fused_pairwise_conv_bxf_plain(*args),
                           reps=3)
        bound_ms, bound_by, flops = pairwise_cost(
            e, mid, C, O, P, Q, F, 2 if hdt == torch.bfloat16 else 4, peaks)
        row = dict(pair=[di, do], E=e, h_dtype=str(hdt).split('.')[-1],
                   max_abs_err=err, max_abs_plain=scale, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   tflops=flops / ms / 1e9)
        rows.append(row)
        log('kernel', json.dumps(row))
        del out, ref, args, h, w3, b3, bf, x
    return rows, worst


def pairwise_bwd_cost(kernel, E, mid, IF, O, P, h_bytes, peaks):
    """(bound_ms, bound_by) of backward kernel 'a' (R recompute, dV2, dR,
    dW3, dB3) or 'b' (dR, dH) as the kernels do the work: each input read
    once, each output written once. With bf16 h/w3 the R recompute is one
    tensor-core pass and dW3 and dH two each (dR split into bf16 hi and
    lo), at the bf16 rate, while the P-contractions and dB3 run on the
    float32 CUDA cores at the same time: the operations take the longer of
    the two pipes. With float32 h/w3 everything shares the CUDA cores."""
    bf16_peak, f32_peak, mem = peaks
    radial = 2.0 * E * mid * IF * O
    pcontract = 2.0 * E * P * IF * O
    if kernel == 'a':
        tensor, cuda = 3 * radial, 2 * pcontract + E * IF * O
        f32_ops = radial * 2 + cuda
        nbytes = (E * mid * h_bytes + mid * IF * O * h_bytes + IF * O * 4
                  + 2 * E * P * IF * 4 + E * P * O * 4 + mid * IF * O * 4
                  + IF * O * 4)
    else:
        tensor, cuda = 2 * radial, pcontract
        f32_ops = radial + cuda
        nbytes = (mid * IF * O * h_bytes + E * P * IF * 4 + E * P * O * 4
                  + E * mid * 4)
    ops_s = max(tensor / bf16_peak, cuda / f32_peak) if h_bytes == 2 \
        else f32_ops / f32_peak
    bytes_s = nbytes / mem
    return max(ops_s, bytes_s) * 1e3, \
        'operations' if ops_s >= bytes_s else 'bytes'


def phase_backward(kp, peaks):
    """Kernels A and B against their plain versions at every pair shape of
    the training step (E = 32768 edges of n=1024, k=32; the 16 hidden
    (d_in, d_out) pairs, which include conv_in's (0, d_out) and conv_out's
    (d_in, 0/1) shapes), a ragged E and a float32 h/w3 case."""
    gen = torch.Generator(device='cuda').manual_seed(3)
    dev = 'cuda'
    E, mid, C, O = 32768, 128, 64, 64
    cases = [(di, do, E, torch.bfloat16) for di in range(4)
             for do in range(4)]
    cases += [(2, 1, E - 37, torch.bfloat16), (3, 3, E, torch.float32)]
    rows, worst = [], {'a': 0.0, 'b': 0.0}
    for di, do, e, hdt in cases:
        P, F = 2 * do + 1, 2 * min(di, do) + 1
        IF = C * F
        h = torch.randn(e, mid, device=dev, generator=gen).to(hdt)
        w3 = (torch.randn(mid, IF, O, device=dev, generator=gen)
              * mid ** -0.5).to(hdt)
        v2 = torch.randn(e, P, IF, device=dev, generator=gen)
        g = torch.randn(e, P, O, device=dev, generator=gen)
        b3 = torch.randn(IF, O, device=dev, generator=gen) * 0.1
        shape = kp._check_bwd(h, w3, v2, g, b3)
        dw3, dv2, db3 = kp._launch_bwd_a(h, w3, v2, g, b3, *shape)
        dh = kp._launch_bwd_b(w3, v2, g, *shape)
        dw3_2, _, db3_2 = kp._launch_bwd_a(h, w3, v2, g, b3, *shape)
        torch.cuda.synchronize()
        if not (torch.equal(dw3, dw3_2) and torch.equal(db3, db3_2)):
            raise AssertionError(f'backward ({di},{do}) E={e}: dW3/dB3 '
                                 f'differ between two runs')
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
                    f'backward ({di},{do}) E={e} {hdt} {name}: max_abs_err '
                    f'{err} > {KERNEL_RTOL} * max|plain| {scale}')
            errs[name] = (err, scale)
        worst['a'] = max(worst['a'], *(errs[k][0] for k in
                                       ('dw3', 'dv2', 'db3')))
        worst['b'] = max(worst['b'], errs['dh'][0])
        del ref_w3, ref_v2, ref_b3, ref_h, dw3_2, db3_2
        hb = 2 if hdt == torch.bfloat16 else 4
        row = dict(pair=[di, do], E=e, h_dtype=str(hdt).split('.')[-1],
                   max_abs_err={k: v[0] for k, v in errs.items()},
                   max_abs_plain={k: v[1] for k, v in errs.items()},
                   ms_a=cuda_ms(lambda: kp._launch_bwd_a(h, w3, v2, g, b3,
                                                         *shape), reps=5),
                   ms_b=cuda_ms(lambda: kp._launch_bwd_b(w3, v2, g, *shape),
                                reps=5),
                   plain_ms_a=cuda_ms(lambda: kp.fused_pairwise_conv_bwd_a_plain(
                       h, w3, v2, g, b3), reps=3),
                   plain_ms_b=cuda_ms(lambda: kp.fused_pairwise_conv_bwd_b_plain(
                       w3, v2, g), reps=3))
        for k in ('a', 'b'):
            row[f'bound_ms_{k}'], row[f'bound_by_{k}'] = pairwise_bwd_cost(
                k, e, mid, IF, O, P, hb, peaks)
        rows.append(row)
        log('backward', json.dumps(row))
        del h, w3, v2, g, b3, dw3, dv2, db3, dh
    torch.cuda.empty_cache()
    return rows, worst


def chain_coords(rng, n):
    """A random-walk chain of 3.8-unit steps (a protein backbone's shape)."""
    steps = rng.normal(size=(n, 3))
    steps *= 3.8 / np.linalg.norm(steps, axis=-1, keepdims=True)
    return np.cumsum(steps, axis=0).astype(np.float32)


def condition_weights(model, power=-0.5):
    """Scale every ConvSE3's w3_{d_in}_{d_out} by 1/sqrt(sum over d_in of
    c_in * F): the contraction sums that many O(1) terms, so with the
    flax-scheme init each conv multiplies the residual stream by ~20 and a
    depth-6 model is chaotic (float32 rounding differences between two
    rotations of the input grow to ~10% of the output). Conditioned, the
    output stays O(1) and rotation invariance is measurable. power=+0.5
    undoes it."""
    from se3_transformer_torch.ops.conv import ConvSE3
    from se3_transformer_torch.utils.helpers import to_order
    with torch.no_grad():
        for conv in model.modules():
            if not isinstance(conv, ConvSE3):
                continue
            for d_out, _ in conv.fiber_out:
                fan = sum(c * to_order(min(d_in, d_out))
                          for d_in, c in conv.fiber_in)
                for d_in, _ in conv.fiber_in:
                    getattr(conv, f'w3_{d_in}_{d_out}').mul_(fan ** power)
    return model


def phase_serve(st, kp):
    from se3_transformer_torch.so3 import rot
    rng = np.random.RandomState(0)
    model = condition_weights(st.flagship_fast(
        generator=torch.Generator().manual_seed(0)))
    engine = st.InferenceEngine(model, buckets=(1024,))
    requests = [(rng.normal(size=(n, 64)).astype(np.float32),
                 chain_coords(rng, n)) for n in (1024, 1000, 700)]
    R = rot(0.31, -1.2, 0.7)

    reset_counts(kp)
    engine.predict(*requests[0])    # warm-up: allocator, cuBLAS handles
    forwards = 1
    results = []
    for i, (feats, coords) in enumerate(requests):
        before = kp.fused_pairwise_conv_bxf.launches
        t0 = time.perf_counter()
        out = engine.predict(feats, coords)
        dt = time.perf_counter() - t0
        forwards += 1
        launched = kp.fused_pairwise_conv_bxf.launches - before
        n = len(feats)
        if out.shape != (n, 64) or not np.isfinite(out).all():
            raise AssertionError(f'request {i}: shape {out.shape} or '
                                 f'non-finite output')
        if launched != 200:
            raise AssertionError(f'request {i}: {launched} kernel launches, '
                                 f'want 200')
        row = dict(request=i, n=n, bucket=1024, latency_ms=dt * 1e3,
                   nodes_per_s=n / dt, launches=launched)
        results.append((out, row))
        log('serve', json.dumps(row))
    # rotation invariance of the scalar output (rotation in float64)
    feats, coords = requests[0]
    coords_r = (coords.astype(np.float64) @ R.T).astype(np.float32)
    out_r = engine.predict(feats, coords_r)
    forwards += 1
    out0 = results[0][0]
    inv = float(np.abs(out_r - out0).max())
    scale = float(np.abs(out0).max())
    # where the time goes: one more request under the profiler
    top, kernel_ms, device_ms, wall_ms, syncs = profile_request(
        engine, requests[0])
    forwards += 2
    log('profile', json.dumps(dict(
        request_wall_ms=wall_ms, device_busy_ms=device_ms,
        pairwise_kernel_ms=kernel_ms, host_syncs_per_forward=syncs,
        top_device_ops=top)))
    # the flax-scheme weights (conditioning undone): chaotic at depth 6,
    # reported, not asserted
    condition_weights(model, power=0.5)
    raw, raw_r = (engine.predict(feats, c) for c in (coords, coords_r))
    forwards += 2
    log('serve', json.dumps(dict(
        flax_scheme_weights=True, max_abs_out=float(np.abs(raw).max()),
        rotation_max_abs_diff=float(np.abs(raw_r - raw).max()))))
    launches = kp.fused_pairwise_conv_bxf.launches
    if launches != 200 * forwards:
        raise AssertionError(f'{launches} launches for {forwards} forwards')
    if counts(kp)[1:] != (0, 0):
        raise AssertionError(f'serving launched backward kernels: '
                             f'{counts(kp)}')
    if inv > ROTATION_RTOL * scale:
        raise AssertionError(f'rotation invariance {inv} > {ROTATION_RTOL} '
                             f'* max|out| {scale}')
    log('serve', json.dumps(dict(rotation_max_abs_diff=inv,
                                 max_abs_out=scale, forwards=forwards,
                                 launches=launches,
                                 stats=engine.stats())))
    return launches


def count_host_syncs(fn):
    """Run fn() and count the operations that made the host wait for the
    device (torch.cuda's sync debug mode): each leaves the device idle
    while the host catches up."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum('synchronizing' in str(w.message) for w in caught)


def dev_us(e):
    return getattr(e, 'self_device_time_total',
                   getattr(e, 'self_cuda_time_total', 0))


def device_events(prof):
    """The profile's device-side events (kernels, copies, sets), largest
    first. CPU ops are left out: one that launches a kernel from a ctypes
    call (the pairwise custom op) is charged that kernel's time as its own
    device time, which would count it twice."""
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and dev_us(e) > 0]
    return sorted(events, key=dev_us, reverse=True)


def profile_request(engine, request):
    """Device time by op for one request (torch.profiler, CUDA activity):
    the top ops, the pairwise kernel's total, the device's busy time and
    the request's wall time, in ms."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict(*request)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the forward alone: predict() copies to and from the host and ends in
    # a synchronize of its own
    from se3_transformer_torch.inference import pad_to_bucket
    padded = [torch.as_tensor(a, device='cuda') for a in pad_to_bucket(
        [request[0]], [request[1]], engine.buckets[-1], batch_size=1)]

    def forward():
        with torch.inference_mode():
            engine.module(*padded)
    syncs = count_host_syncs(forward)

    events = device_events(prof)
    device_ms = sum(dev_us(e) for e in events) / 1e3
    kernel_ms = sum(dev_us(e) for e in events
                    if 'pairwise_bxf_kernel' in e.key) / 1e3
    top = [dict(op=e.key[:90], calls=e.count, ms=dev_us(e) / 1e3)
           for e in events[:12]]
    return top, kernel_ms, device_ms, wall_ms, syncs


def profile_step(trainer, batch, noise):
    """Device time by op for one training step (torch.profiler, CUDA
    activity): the top ops, the forward kernel's and kernels A's and B's
    totals, the device's busy time and the step's wall time, in ms."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch, noise=noise)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    syncs = count_host_syncs(lambda: trainer.train_step(batch, noise=noise))

    events = device_events(prof)

    def kernel_ms(*names):
        return sum(dev_us(e) for e in events
                   if any(n in e.key for n in names)) / 1e3
    from torch.autograd import DeviceType
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return dict(step_wall_ms=wall_ms, host_syncs_per_step=syncs,
                device_busy_ms=sum(dev_us(e) for e in events) / 1e3,
                forward_kernel_ms=kernel_ms('pairwise_bxf_kernel'),
                kernel_a_ms=kernel_ms('bwd_a_kernel', 'bwd_reduce_kernel'),
                kernel_b_ms=kernel_ms('bwd_b_'),
                top_device_ops=[dict(op=e.key[:90], calls=e.count,
                                     ms=dev_us(e) / 1e3)
                                for e in events[:12]],
                host_op_ms=sum(e.self_cpu_time_total for e in host) / 1e3,
                top_host_ops=[dict(op=e.key[:60], calls=e.count,
                                   ms=e.self_cpu_time_total / 1e3)
                              for e in host[:10]])


def counts(kp):
    return (kp.fused_pairwise_conv_bxf.launches,
            kp.fused_pairwise_conv_bwd.launches_a,
            kp.fused_pairwise_conv_bwd.launches_b)


def reset_counts(kp):
    kp.fused_pairwise_conv_bxf.launches = 0
    kp.fused_pairwise_conv_bwd.launches_a = 0
    kp.fused_pairwise_conv_bwd.launches_b = 0


def phase_train(st, kp):
    """The flagship_fast denoise step at n=1024: one warm-up step, then
    TRAIN_STEPS timed ones, one profiled, one under remat_policy=None."""
    n, dim = 1024, 64
    model = condition_weights(st.flagship_fast(
        dim=dim, output_degrees=2, reduce_dim_out=True,
        generator=torch.Generator().manual_seed(4)))
    trainer = st.DenoiseTrainer(model, lr=1e-4)
    batch = trainer.to_device(st.flagship_batch(np.random.RandomState(0), 1,
                                                n, dim))
    noise = torch.randn(batch['coords'].shape, device='cuda',
                        generator=torch.Generator('cuda').manual_seed(5))

    reset_counts(kp)
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(1 + TRAIN_STEPS):
        before = counts(kp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_step(batch, noise=noise)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = tuple(a - b for a, b in zip(counts(kp), before))
        losses.append(float(loss))
        want = (TRAIN_LAUNCHES, TRAIN_BWD_LAUNCHES, TRAIN_BWD_LAUNCHES)
        if launched != want:
            raise AssertionError(f'train step {step}: launches (forward, A, '
                                 f'B) = {launched}, want {want}')
        if step:
            step_ms.append(dt * 1e3)
        log('train', json.dumps(dict(step=step, warmup=step == 0,
                                     loss=losses[-1], step_ms=dt * 1e3,
                                     launches=launched)))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = counts(kp)
    bad = [name for name, p in model.named_parameters()
           if p.grad is not None and not torch.isfinite(p.grad).all()]
    if not np.isfinite(losses).all() or losses[-1] >= losses[0] or bad:
        raise AssertionError(f'train: losses {losses}, non-finite gradients '
                             f'in {bad}')
    ms = float(np.median(step_ms))
    log('train', json.dumps(dict(
        n=n, steps=TRAIN_STEPS, step_ms_median=ms, step_ms=step_ms,
        nodes_steps_per_s=n * TRAIN_STEPS / (sum(step_ms) / 1e3),
        max_memory_allocated_gb=peak_gb, first_loss=losses[0],
        last_loss=losses[-1], launches=launches)))
    log('train_profile', json.dumps(profile_step(trainer, batch, noise)))

    # remat_policy=None replays the trunk's pairs in the backward
    replay = st.DenoiseTrainer(condition_weights(st.flagship_fast(
        dim=dim, output_degrees=2, reduce_dim_out=True, remat_policy=None,
        generator=torch.Generator().manual_seed(4))), lr=1e-4)
    del trainer, model
    torch.cuda.empty_cache()
    before = counts(kp)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    replay.train_step(batch, noise=noise)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = tuple(a - b for a, b in zip(counts(kp), before))
    want = (TRAIN_LAUNCHES + REPLAY_LAUNCHES, TRAIN_BWD_LAUNCHES,
            TRAIN_BWD_LAUNCHES)
    log('train', json.dumps(dict(remat_policy=None, step_ms=dt * 1e3,
                                 launches=launched,
                                 max_memory_allocated_gb=(
                                     torch.cuda.max_memory_allocated() / 1e9))))
    if launched != want:
        raise AssertionError(f'remat_policy=None step: launches {launched}, '
                             f'want {want}')
    return launches


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
    for bf16, tol in ((False, REF_GRAD_RTOL_F32), (True, REF_GRAD_RTOL_BF16)):
        cfg = dict(dim=64, depth=1, num_degrees=4, heads=8, dim_head=8,
                   attend_self=True, num_neighbors=16,
                   shared_radial_hidden=True, fuse_basis=True,
                   radial_bf16=bf16, reversible=True,
                   remat_policy='save_conv_outputs', output_degrees=2,
                   reduce_dim_out=True)
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
            radial_bf16=bf16, loss_card=loss_c, loss_cpu=loss_h,
            loss_rel_err=loss_rel, worst_grad_rel_err=worst,
            worst_grad=worst_key, leaves=len(grads_h), rtol=tol)))
        if loss_rel > tol or worst > tol:
            raise AssertionError(f'train card vs CPU (radial_bf16={bf16}): '
                                 f'loss {loss_rel}, gradient {worst_key} '
                                 f'{worst} > {tol}')


def phase_reference(st):
    """Small model: card (kernel path) vs the same weights on the CPU."""
    rng = np.random.RandomState(1)
    n = 64
    feats = rng.normal(size=(1, n, 64)).astype(np.float32)
    coords = chain_coords(rng, n)[None]
    mask = np.ones((1, n), bool)
    mask[0, -5:] = False
    for bf16, tol in ((False, REF_RTOL_F32), (True, REF_RTOL_BF16)):
        cfg = dict(dim=64, depth=1, num_degrees=4, heads=8, dim_head=8,
                   attend_self=True, num_neighbors=16,
                   shared_radial_hidden=True, fuse_basis=True,
                   radial_bf16=bf16, reversible=True)
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
        log('reference', json.dumps(dict(radial_bf16=bf16, max_abs_err=err,
                                         max_abs_cpu=scale, rtol=tol)))
        if not (np.isfinite(outs[0]).all() and err <= tol * scale):
            raise AssertionError(f'card vs CPU (radial_bf16={bf16}): {err} '
                                 f'> {tol} * {scale}')


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
    t0 = time.perf_counter()
    lib = build.library_path()
    build.load_library()
    log(f'build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib, HERE)}')
    entry = ''
    for line in build.build_log.splitlines():
        if 'Compiling entry function' in line:
            entry = line.split("'")[1]
        elif 'registers' in line or 'spill' in line and ' 0 bytes' not in line:
            log('ptxas:', entry[:60], line.split(':', 1)[-1].strip())

    # 3. forward kernel vs plain
    rows, worst = phase_kernels(st, peaks)

    # 4. backward kernels vs plain
    bwd_rows, bwd_worst = phase_backward(kp, peaks)

    # 5. serve: the first main path, counts reset just before, read after
    serve_launches = phase_serve(st, kp)

    # 6. train: the second main path, counts reset just before, read after
    train_launches = phase_train(st, kp)

    # 7. references on small inputs
    phase_reference(st)
    phase_train_reference(st)

    def flagship(table):
        return [r for r in table
                if r['E'] == 32768 and r['h_dtype'] == 'bfloat16']

    def bound_by(table, key):
        total = sum(r[f'bound_ms{key}'] for r in table)
        ops = sum(r[f'bound_ms{key}'] for r in table
                  if r[f'bound_by{key}'] == 'operations')
        return 'operations' if ops * 2 >= total else 'bytes'

    src = 'se3_transformer_torch/kernels/csrc/'
    pallas = 'se3_transformer_tpu/kernels/pallas_pairwise.py'
    fwd, bwd = flagship(rows), flagship(bwd_rows)
    kernels = [dict(
        name='fused_pairwise_conv_bxf', route='cuda',
        source=src + 'pairwise_bxf.cu', replaces=f'{pallas}:593',
        launches=serve_launches + train_launches[0], max_abs_err=worst,
        ms=sum(r['ms'] for r in fwd),
        plain_ms=sum(r['plain_ms'] for r in fwd),
        bound_ms=sum(r['bound_ms'] for r in fwd),
        bound_by=bound_by(fwd, ''), library_ms=None)]
    for k, line in (('a', 861), ('b', 907)):
        kernels.append(dict(
            name=f'fused_pairwise_conv_bwd_{k}', route='cuda',
            source=src + 'pairwise_bwd.cu', replaces=f'{pallas}:{line}',
            launches=train_launches[1 if k == 'a' else 2],
            max_abs_err=bwd_worst[k],
            ms=sum(r[f'ms_{k}'] for r in bwd),
            plain_ms=sum(r[f'plain_ms_{k}'] for r in bwd),
            bound_ms=sum(r[f'bound_ms_{k}'] for r in bwd),
            bound_by=bound_by(bwd, f'_{k}'), library_ms=None))
    log(smi)
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
