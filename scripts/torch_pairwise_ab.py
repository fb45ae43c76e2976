"""Same-call A/B of the port's pairwise kernels (#1, #3, A, B) between two
source trees: the tree given on the command line is put first on the path,
its kernels are built (or loaded from its build directory), and each
kernel is timed at the units of PERF.md's kernel table, by CUDA events
(the median of 10 calls; 5 for A and B): #1 at the 16 flagship_fast pairs
(E = 32768, bf16 h, float32 basis and x), A and B at the same pairs (bf16
h), #3 at the flagship's four output degrees (float32 h), A and B there
(float32). Prints one line `AB {...}`. Run each tree in its own process,
in the order parent, change, change, parent:

    python3 scripts/torch_pairwise_ab.py /path/to/parent
    python3 scripts/torch_pairwise_ab.py .

Needs a CUDA card and nvcc; imports torch and the tree's
se3_transformer_torch only.
"""
import json, os, sys, time
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
import numpy as np
import torch
from se3_transformer_torch import get_basis
from se3_transformer_torch.kernels import build, pairwise as kp
assert kp.__file__.startswith(tree), kp.__file__
torch.backends.cuda.matmul.allow_tf32 = False
t = time.perf_counter(); build.load_library(); built = time.perf_counter() - t

def ms(fn, reps=10):
    fn(); torch.cuda.synchronize(); out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); torch.cuda.synchronize(); out.append(a.elapsed_time(b))
    return float(np.median(out))

gen = torch.Generator(device='cuda').manual_seed(0)
E, mid, C, O = 32768, 128, 64, 64
rel = torch.randn(E, 3, device='cuda', generator=gen) * 4.0
flat = get_basis(rel, 3, layout='pfq_flat')
res = dict(tree=tree, build_s=built)
bxf = 0.0
a16 = b16 = 0.0
for di in range(4):
    for do in range(4):
        P, Q, F = 2 * do + 1, 2 * di + 1, 2 * min(di, do) + 1
        h = torch.randn(E, mid, device='cuda', generator=gen).to(torch.bfloat16)
        w3 = (torch.randn(mid, C * F, O, device='cuda', generator=gen) * mid ** -0.5).to(torch.bfloat16)
        b3 = torch.randn(C * F, O, device='cuda', generator=gen) * 0.1
        x = torch.randn(E, C, Q, device='cuda', generator=gen)
        bf = flat[f'{di},{do}'].contiguous()
        bxf += ms(lambda: kp.fused_pairwise_conv_bxf(h, w3, bf, x, (P, Q, F), b3))
        v2 = torch.randn(E, P, C * F, device='cuda', generator=gen)
        g = torch.randn(E, P, O, device='cuda', generator=gen)
        shape = kp._check_bwd(h, w3, v2, g, b3)
        a16 += ms(lambda: kp._launch_bwd_a(h, w3, v2, g, b3, *shape), 5)
        b16 += ms(lambda: kp._launch_bwd_b(w3, v2, g, *shape), 5)
        del h, w3, b3, x, bf, v2, g
res.update(bxf_bf16_unit_ms=bxf, a_bf16_unit_ms=a16, b_bf16_unit_ms=b16)
fwd = a32 = b32 = 0.0
for do in range(4):
    P, IF = 2 * do + 1, C * sum(2 * min(d, do) + 1 for d in range(4))
    h = torch.randn(E, mid, device='cuda', generator=gen)
    w3 = torch.randn(mid, IF, O, device='cuda', generator=gen) * mid ** -0.5
    v2 = torch.randn(E, P, IF, device='cuda', generator=gen)
    b3 = torch.randn(IF, O, device='cuda', generator=gen) * 0.1
    g = torch.randn(E, P, O, device='cuda', generator=gen)
    fwd += ms(lambda: kp.fused_pairwise_conv(h, w3, v2, b3))
    shape = kp._check_bwd(h, w3, v2, g, b3)
    a32 += ms(lambda: kp._launch_bwd_a(h, w3, v2, g, b3, *shape), 5)
    b32 += ms(lambda: kp._launch_bwd_b(w3, v2, g, *shape), 5)
    del h, w3, v2, b3, g
    torch.cuda.empty_cache()
res.update(fwd_f32_unit_ms=fwd, a_f32_grouped_ms=a32, b_f32_grouped_ms=b32)
print('AB', json.dumps(res), flush=True)
