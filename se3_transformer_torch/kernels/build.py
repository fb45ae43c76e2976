"""Build and load the port's hand-written CUDA kernels.

The one source, `csrc/pairwise_bxf.cu`, is compiled by `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface that `ctypes`
loads. The build happens at first use, never at import, into
`kernels/build/` beside this file (listed in .gitignore). The library's
file name carries a hash of the source and flags, so an edited source is
rebuilt and a stale library is never loaded.
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
SOURCE = os.path.join(CSRC_DIR, 'pairwise_bxf.cu')
BUILD_DIR = os.path.join(_HERE, 'build')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v', '-lineinfo',
              '-shared')

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build printed (the ptxas register / spill report)
build_log = ''


def _fingerprint() -> str:
    digest = hashlib.sha1(' '.join(NVCC_FLAGS).encode())
    with open(SOURCE, 'rb') as fh:
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


def library_path() -> str:
    """Build (if needed) and return the path of the kernels' library."""
    global build_log
    lib = os.path.join(BUILD_DIR, f'libse3_torch_kernels-{_fingerprint()}.so')
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{lib}.{os.getpid()}.tmp'
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, SOURCE, '-o', tmp],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f'kernel build failed:\n{proc.stdout}{proc.stderr}')
    build_log = proc.stdout + proc.stderr
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
            lib.se3_pairwise_bxf.restype = ci
            _lib = lib
        return _lib
