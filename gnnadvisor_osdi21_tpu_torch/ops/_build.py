"""Build and load the package's CUDA kernels (``csrc/*.cu``).

One ``nvcc`` call compiles every source for Hopper (``sm_90a``) into a
shared library with a plain C interface, named by the hash of the
sources and flags and kept in ``_build/`` beside the package (the only
place the port writes).  It is loaded with ``ctypes``: pointers and the
CUDA stream travel as ``c_void_p``, and every C entry point returns
``cudaGetLastError()`` after its launch, which ``check`` turns into an
exception.  Nothing here runs at import; the first CUDA launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types (every one returns a cudaError_t as int)
SIGNATURES = {
    # bits, w16, block, table, R, D, Dp, bf16, out, stream
    "gnna_slab_matmul_t": (_P, _I, _I, _P, _I, _I, _I, _I, _P, _P),
    # diag_bits, diag_w16, diag_b, diag_table, hot_bits, hot_w16,
    # hot_table, R, D, Dp, bf16, out, stream
    "gnna_fused_slab_matmul_t": (
        _P, _I, _I, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P,
    ),
    # mask_s, s16, ob, num_tiles, rows_t, block_ptr, num_rows, D, bf16,
    # out, stream
    "gnna_residual_combine_t": (_P, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P),
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path() -> str:
    """Path of the built library for the current sources (may not exist)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fp:
            h.update(fp.read())
    return os.path.join(BUILD_DIR, f"libgnna_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, str]:
    """Compile the sources unless the library for them exists.  Returns
    the library's path and nvcc's output ("" when nothing was built); with
    ``-Xptxas -v`` the output lists each kernel's registers, shared memory
    and spills."""
    so = _library_path()
    if os.path.exists(so):
        return so, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so, proc.stdout + proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(build()[0])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(name: str, rc: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
