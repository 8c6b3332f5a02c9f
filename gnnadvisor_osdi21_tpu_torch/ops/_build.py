"""Build and load the package's CUDA kernels (``csrc/*.cu``).

One ``nvcc`` process per source, all started together, compiles the
sources for Hopper (``sm_90a``), and one more links them into a shared
library with a plain C interface, named by the hash of the sources and
flags and kept in ``_build/`` beside the package (the only place the port
writes).  It is loaded with ``ctypes``: pointers and the
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argument types (every one returns a cudaError_t as int)
SIGNATURES = {
    # bits, w16, block, table, R, D, Dp, bf16, transposed, out, stream
    "gnna_slab_matmul": (_P, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P),
    # diag_bits, diag_w16, diag_b, diag_table, hot_bits, hot_w16,
    # hot_table, R, D, Dp, bf16, transposed, out, stream
    "gnna_fused_slab_matmul": (
        _P, _I, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P,
    ),
    # mask_s, s16, ob, num_tiles, x, rows, Dx, src, block_ptr, num_rows,
    # D, addend, bf16, out, stream
    "gnna_residual_combine_t": (
        _P, _I, _I, _I, _P, _I, _I, _P, _P, _I, _I, _P, _I, _P, _P,
    ),
    # mask, W, num_tiles, S, x, rows, Dx, src, D, block_ptr, num_rows,
    # addend, bf16, out, stream
    "gnna_residual_combine": (
        _P, _I, _I, _I, _P, _I, _I, _P, _I, _P, _I, _P, _I, _P, _P,
    ),
    # the probes' bit slabs, walked over their set bits (csrc/bit_walk.cu):
    # bits, w32, R, x_t, table (scratch), block_rows, out, stream
    "gnna_bit_slab_t": (_P, _I, _I, _P, _P, _I, _P, _P),
    # bits, R, w32, x, x_f32, block_rows, out, stream
    "gnna_bit_slab": (_P, _I, _I, _P, _I, _I, _P, _P),
    # the probes' dense slabs (csrc/dense_slab.cu):
    # a, K, R, x_t, frags, out, stream
    "gnna_i8_slab_t": (_P, _I, _I, _P, _P, _P, _P),
    # a, a_bf16, K, R, x, x_f32, frags, out, stream
    "gnna_dense_slab": (_P, _I, _I, _I, _P, _I, _P, _P, _P),
    # a, R, K, x, block_rows, frags, out, stream (the format probe's)
    "gnna_i8_slab": (_P, _I, _I, _P, _I, _P, _P, _P),
    # the format probe's other kernels (csrc/fmt_probe.cu):
    # a, src, g, block_bytes, s, out, stream
    "gnna_stream_sum": (_P, _I, _I, _L, _P, _P, _P),
    # vals, masks, segs, t2b, first, T, tile, ob, n_blocks, s, out, stream
    "gnna_seg_reduce": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
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
    nvcc, tag = _nvcc(), f"{os.getpid()}"
    objs = [
        os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        for src in _sources()
    ]
    jobs = [
        [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        for src, obj in zip(_sources(), objs)
    ]
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for cmd in jobs
    ]
    outputs = [proc.communicate()[0] for proc in procs]  # waits for all
    tmp = f"{so}.{tag}.tmp"
    link = [nvcc, "-shared", "-o", tmp, *objs]
    try:
        for cmd, proc, out in zip(jobs, procs, outputs):
            _check_nvcc(cmd, proc.returncode, out)
        proc = subprocess.run(link, capture_output=True, text=True)
        _check_nvcc(link, proc.returncode, proc.stdout + proc.stderr)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so, "".join(outputs)


def _check_nvcc(cmd: list[str], returncode: int, output: str) -> None:
    if returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {returncode}:\n{' '.join(cmd)}\n"
            f"{output}"
        )


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
