"""Build and load the port's hand-written CUDA kernels.

Each source under `csrc/` (`pairwise_bxf.cu` and `pairwise_fwd.cu`, the
pairwise forwards; `pairwise_bwd.cu`, their backward; `pairwise_narrow.cu`,
the narrow-O arms of #3, A and B, which the float32 pairwise units'
entry points call; `attention.cu`, the fused attention and its backward;
`flash_fwd.cu`, the streaming kNN attention; `flash_global.cu`, the
global attention) is compiled by its
own `nvcc -c` for Hopper (`sm_90a`), all started together (the two flash
sources twice, once per contraction arm, `-DSE3_SO2=0` and `=1`: each object holds one arm's
instantiations and entry point; `flash_fwd.cu` twice more for its scaled
arm, `-DSE3_QUANT=1`; each 64-wide pairwise source twice, its float32
arm and, with `-DSE3_V16=1`, its conv_bf16 arm, the bf16-stored V2, basis
and x; `pairwise_fwd.cu`, `pairwise_bwd.cu` and `pairwise_narrow.cu` once
more with `-DSE3_M32=1`, the radial width 32 of kernels #3, A and B that
the SE3TransformerV2 family runs),
and the objects are linked into
one shared library with a plain C interface that `ctypes` loads. The build
happens at first use, never at import, into `kernels/build/` beside this
file (listed in .gitignore). The library's file name carries a hash of
every source, header and flag, so an edited source is rebuilt and a stale
library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

from ..utils.helpers import ONE_TIME_WORK

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, 'csrc')
SOURCES = tuple(os.path.join(CSRC_DIR, f)
                for f in ('pairwise_bxf.cu', 'pairwise_fwd.cu',
                          'pairwise_bwd.cu', 'pairwise_narrow.cu',
                          'attention.cu', 'flash_fwd.cu', 'flash_global.cu'))
HEADERS = tuple(os.path.join(CSRC_DIR, f)
                for f in ('common.cuh', 'pairwise_narrow.cuh',
                          'pairwise_narrow.h'))
# the compilation units, (source, its extra nvcc flags): each flash source
# once per contraction arm, flash_fwd.cu also once per W3 form (float, or
# the scaled arm's quantized storage); each pairwise source once per storage
# of its equivariant operand (float32, or conv_bf16's bf16); the narrow
# arms and the attention once; #3, A and B (pairwise_fwd.cu, pairwise_bwd.cu
# and their narrow arms) once more at the radial width 32 (-DSE3_M32=1)
ONCE = ('pairwise_narrow.cu', 'attention.cu')
MID32 = ('pairwise_fwd.cu', 'pairwise_bwd.cu', 'pairwise_narrow.cu')
UNITS = tuple(
    (src, (f'-DSE3_SO2={arm}',) + quant)
    for src in SOURCES for arm in (0, 1)
    for quant in ((), ('-DSE3_QUANT=1',))
    if os.path.basename(src).startswith('flash') and (
        not quant or os.path.basename(src) == 'flash_fwd.cu')) + tuple(
    (src, v16) for src in SOURCES
    if os.path.basename(src).startswith('pairwise')
    and os.path.basename(src) not in ONCE
    for v16 in ((), ('-DSE3_V16=1',))) + tuple(
    (src, ()) for src in SOURCES if os.path.basename(src) in ONCE) + tuple(
    (src, ('-DSE3_M32=1',)) for src in SOURCES
    if os.path.basename(src) in MID32)
BUILD_DIR = os.path.join(_HERE, 'build')

COMPILE_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
                 '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v', '-lineinfo')
LINK_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-shared')

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build printed (the ptxas register / spill report)
build_log = ''


def _fingerprint() -> str:
    digest = hashlib.sha1(' '.join(COMPILE_FLAGS + LINK_FLAGS + tuple(
        f for _, flags in UNITS for f in flags)).encode())
    for path in SOURCES + HEADERS:
        with open(path, 'rb') as fh:
            digest.update(fh.read())
    return digest.hexdigest()[:16]


def find_nvcc() -> str:
    cands = [shutil.which('nvcc')]
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    if cuda_home:
        cands.append(os.path.join(cuda_home, 'bin', 'nvcc'))
    cands.append('/usr/local/cuda/bin/nvcc')
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError('nvcc not found: the CUDA kernels are built from '
                       'source with the CUDA toolkit (PATH, $CUDA_HOME or '
                       '/usr/local/cuda)')


def _run_all(cmds, timeout=900):
    """Start every command at once; raise with its output if any fails.
    Returns the commands' combined stdout and stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, failed = [], []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=timeout)
            outs.append(out)
            if proc.returncode != 0:
                failed.append(f'{" ".join(cmd)}\n{out}')
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return ''.join(outs)


def library_path() -> str:
    """Build (if needed) and return the path of the kernels' library."""
    global build_log
    lib = os.path.join(BUILD_DIR, f'libse3_torch_kernels-{_fingerprint()}.so')
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = find_nvcc(), f'{os.getpid()}.tmp'
    objs = [os.path.join(BUILD_DIR, os.path.basename(src)
                         + ''.join(flags) + f'.{tag}.o')
            for src, flags in UNITS]
    try:
        log = _run_all([[nvcc, *COMPILE_FLAGS, *flags, '-c', src, '-o', obj]
                        for (src, flags), obj in zip(UNITS, objs)])
        tmp = f'{lib}.{tag}'
        log += _run_all([[nvcc, *LINK_FLAGS, *objs, '-o', tmp]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    build_log = log
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded kernels' library with its C signatures declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(library_path())
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            # (h, w3, b3, basis, x, out, w3_split, E, C, O, P, Q, chunk,
            #  stage_c, h_is_bf16, stream), the flat basis (bxf) or the
            #  structured one (bx)
            # (the _v16 entries: the conv_bf16 arm, the same arguments with
            #  the equivariant operand bf16)
            for fn in (lib.se3_pairwise_bxf, lib.se3_pairwise_bx,
                       lib.se3_pairwise_bxf_v16, lib.se3_pairwise_bx_v16):
                fn.argtypes = [vp] * 7 + [ci] * 8 + [vp]
            # (h, w3, b3, v2, out, work, w3_split, E, IF, O, P,
            #  i_per_split, h_is_bf16, stream)
            # (se3_pairwise_fwd_m32: the same at the radial width 32)
            for fn in (lib.se3_pairwise_fwd, lib.se3_pairwise_fwd_v16,
                       lib.se3_pairwise_fwd_m32):
                fn.argtypes = [vp] * 7 + [ci] * 6 + [vp]
            # the scaled arm: (h, q, scale, b3, v2, out, work, E, IF, O, P,
            #  i_per_split, h_is_bf16, fp8, stream)
            lib.se3_pairwise_fwd_q.argtypes = [vp] * 7 + [ci] * 7 + [vp]
            # (h, w3, b3, v2, g, dv2, dv2_work, work, split, dw3, db3, E,
            #  IF, O, P, splits, h_is_bf16, stream)
            for fn in (lib.se3_pairwise_bwd_a, lib.se3_pairwise_bwd_a_v16,
                       lib.se3_pairwise_bwd_a_m32):
                fn.argtypes = [vp] * 11 + [ci] * 6 + [vp]
            # (w3, v2, g, dh, work, split, E, IF, O, P, i_per_split,
            #  w3_is_bf16, stream)
            for fn in (lib.se3_pairwise_bwd_b, lib.se3_pairwise_bwd_b_v16,
                       lib.se3_pairwise_bwd_b_m32):
                fn.argtypes = [vp] * 6 + [ci] * 6 + [vp]
            # (q, k, v, mask, out, BH, BKV, n, J, D, heads, scale, stream)
            lib.se3_attention_fwd.argtypes = [vp] * 5 + [ci] * 6 + [cf, vp]
            # (q, k, v, mask, g, dq, dk, dv, BH, BKV, n, J, D, heads, scale,
            #  stream)
            lib.se3_attention_bwd.argtypes = [vp] * 8 + [ci] * 6 + [cf, vp]
            # (q, x0..x3, idx, nmask, h_v, h_k, wv, wk, bv, bk, sh,
            #  prefix_k, prefix_v, cg, out, w_split, pair_d[4], pair_c[4],
            #  cg_off[4], n_pairs, B, n, K, S, S0, heads, IF, P, h_is_bf16,
            #  tie, so2, scale, stream)
            # (se3_flash_fwd_so2: the same, the so2 arm)
            for fn in (lib.se3_flash_fwd, lib.se3_flash_fwd_so2):
                fn.argtypes = [vp] * 19 + [ci] * 24 + [cf, vp]
            # the scaled arm (se3_flash_fwd_q, se3_flash_fwd_so2_q): the
            # same with (wv_scale, wk_scale) in place of w_split and fp8
            # after so2
            for fn in (lib.se3_flash_fwd_q, lib.se3_flash_fwd_so2_q):
                fn.argtypes = [vp] * 20 + [ci] * 25 + [cf, vp]
            # (q, x0..x3, coords, nodemask, rp, wk, wv, bk, bv, prefix_k,
            #  prefix_v, cg, shk, out, w_split, pair_d[4], pair_c[4],
            #  cg_off[4], n_pairs, B, n, S0, heads, IF, P, L, exclude_self,
            #  tie, so2, scale, stream)
            # (se3_flash_global_so2: the same, the so2 arm)
            for fn in (lib.se3_flash_global, lib.se3_flash_global_so2):
                fn.argtypes = [vp] * 18 + [ci] * 23 + [cf, vp]
            for fn in (lib.se3_pairwise_bxf, lib.se3_pairwise_bx,
                       lib.se3_flash_global, lib.se3_pairwise_fwd,
                       lib.se3_pairwise_bwd_a, lib.se3_pairwise_bwd_b,
                       lib.se3_attention_fwd, lib.se3_attention_bwd,
                       lib.se3_flash_fwd, lib.se3_flash_fwd_so2,
                       lib.se3_flash_global_so2, lib.se3_pairwise_fwd_q,
                       lib.se3_flash_fwd_q, lib.se3_flash_fwd_so2_q,
                       lib.se3_pairwise_bxf_v16, lib.se3_pairwise_bx_v16,
                       lib.se3_pairwise_fwd_v16, lib.se3_pairwise_bwd_a_v16,
                       lib.se3_pairwise_bwd_b_v16, lib.se3_pairwise_fwd_m32,
                       lib.se3_pairwise_bwd_a_m32, lib.se3_pairwise_bwd_b_m32):
                fn.restype = ci
            _lib = lib
            ONE_TIME_WORK[0] += 1
        return _lib
