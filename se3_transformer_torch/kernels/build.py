"""Build and load the port's hand-written CUDA kernels.

Each source under `csrc/` (`pairwise_bxf.cu`, the forward;
`pairwise_bwd.cu`, the backward) is compiled by its own `nvcc -c` for
Hopper (`sm_90a`), all started together, and the objects are linked into
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

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, 'csrc')
SOURCES = tuple(os.path.join(CSRC_DIR, f)
                for f in ('pairwise_bxf.cu', 'pairwise_bwd.cu'))
HEADERS = (os.path.join(CSRC_DIR, 'common.cuh'),)
BUILD_DIR = os.path.join(_HERE, 'build')

COMPILE_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
                 '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v', '-lineinfo')
LINK_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-shared')

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build printed (the ptxas register / spill report)
build_log = ''


def _fingerprint() -> str:
    digest = hashlib.sha1(' '.join(COMPILE_FLAGS + LINK_FLAGS).encode())
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
    objs = [os.path.join(BUILD_DIR, os.path.basename(src) + f'.{tag}.o')
            for src in SOURCES]
    try:
        log = _run_all([[nvcc, *COMPILE_FLAGS, '-c', src, '-o', obj]
                        for src, obj in zip(SOURCES, objs)])
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
            vp, ci = ctypes.c_void_p, ctypes.c_int
            # (h, w3, b3, basis, x, out, E, C, O, P, Q, h_is_bf16, stream)
            lib.se3_pairwise_bxf.argtypes = [vp, vp, vp, vp, vp, vp,
                                             ci, ci, ci, ci, ci, ci, vp]
            # (h, w3, b3, v2, g, dv2, work, dw3, db3, E, IF, P, splits,
            #  h_is_bf16, stream)
            lib.se3_pairwise_bwd_a.argtypes = [vp] * 9 + [ci] * 5 + [vp]
            # (w3, v2, g, dh, E, IF, P, w3_is_bf16, stream)
            lib.se3_pairwise_bwd_b.argtypes = [vp] * 4 + [ci] * 4 + [vp]
            for fn in (lib.se3_pairwise_bxf, lib.se3_pairwise_bwd_a,
                       lib.se3_pairwise_bwd_b):
                fn.restype = ci
            _lib = lib
        return _lib
