#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (se3_transformer_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). Phases, each fatal on
failure:

  1. device   require CUDA; print the card's name and power limit; TF32 off.
  2. build    compile every kernel of the port from csrc/ with nvcc (sm_90a).
  3. kernels  hold each kernel against its plain PyTorch version on the card,
              at the shapes the serving forward gives it, and time both.
  4. serve    the flagship_fast forward (dim=64, depth=6, 4 degrees, 8 heads,
              k=32, random seeded weights) served by InferenceEngine at
              bucket 1024: finite outputs, exactly 200 kernel launches per
              request, rotation invariance of the scalar output.
  5. reference  a small model on the card (kernel path) against the same
              weights on the CPU (plain path).

Prints per-shape and per-request lines, then the nvidia-smi line, a
{"kernels": [...]} JSON line and, last, {"ok": true, "device": {...}}.
Exits non-zero, printing no result, without CUDA or without the package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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

    kp.fused_pairwise_conv_bxf.launches = 0
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
    top, kernel_ms, device_ms, wall_ms = profile_request(
        engine, requests[0])
    forwards += 1
    log('profile', json.dumps(dict(
        request_wall_ms=wall_ms, device_busy_ms=device_ms,
        pairwise_kernel_ms=kernel_ms, top_device_ops=top)))
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
    if inv > ROTATION_RTOL * scale:
        raise AssertionError(f'rotation invariance {inv} > {ROTATION_RTOL} '
                             f'* max|out| {scale}')
    log('serve', json.dumps(dict(rotation_max_abs_diff=inv,
                                 max_abs_out=scale, forwards=forwards,
                                 launches=launches,
                                 stats=engine.stats())))
    return launches


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

    def dev_us(e):
        return getattr(e, 'self_device_time_total',
                       getattr(e, 'self_cuda_time_total', 0))
    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    events.sort(key=dev_us, reverse=True)
    device_ms = sum(dev_us(e) for e in events) / 1e3
    kernel_ms = sum(dev_us(e) for e in events
                    if 'pairwise_bxf_kernel' in e.key) / 1e3
    top = [dict(op=e.key[:90], calls=e.count, ms=dev_us(e) / 1e3)
           for e in events[:12]]
    return top, kernel_ms, device_ms, wall_ms


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
    for line in build.build_log.splitlines():
        if 'registers' in line or 'spill' in line and ' 0 bytes' not in line:
            log('ptxas:', line.strip())

    # 3. kernels vs plain
    rows, worst = phase_kernels(st, peaks)

    # 4. serve: the main path, counts reset just before and read just after
    launches = phase_serve(st, kp)

    # 5. reference on a small input
    phase_reference(st)

    flagship = [r for r in rows if r['E'] == 32768 and r['h_dtype'] == 'bfloat16']
    bound_ms = sum(r['bound_ms'] for r in flagship)
    ops_ms = sum(r['bound_ms'] for r in flagship if r['bound_by'] == 'operations')
    kernels = [dict(
        name='fused_pairwise_conv_bxf', route='cuda',
        source='se3_transformer_torch/kernels/csrc/pairwise_bxf.cu',
        replaces='se3_transformer_tpu/kernels/pallas_pairwise.py:593',
        launches=launches, max_abs_err=worst,
        ms=sum(r['ms'] for r in flagship),
        plain_ms=sum(r['plain_ms'] for r in flagship),
        bound_ms=bound_ms,
        bound_by='operations' if ops_ms * 2 >= bound_ms else 'bytes',
        library_ms=None)]
    log(smi)
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
