"""ctypes binding of the native graph tools (``graphtools.cpp``): the
edge-list parser, the rabbit reordering permutation and the ragged
neighbor-group builder.

The port's copy of ``gnnadvisor_osdi21_tpu/native/graphtools.py``.  The
source is byte-identical to the JAX package's; the library is built with
``g++ -O3 -march=native -fopenmp -shared -fPIC`` at first use into the
package's git-ignored ``_build/``, under a name keyed by a hash of the
source and the flags (as ``ops/_build.py`` names the kernel library), and
never beside its source.  ``available()`` says whether the library can be
had; callers fall back to NumPy only when it cannot (no ``g++``).  A
failed build or a non-zero return raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "graphtools.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.c_int64
# C entry point -> (return type, argument types)
SIGNATURES = {
    # path, src, dst, capacity -> edges parsed (-1: unreadable)
    "gt_parse_edge_list": (_I64, (ctypes.c_char_p, _I64P, _I64P, _I64)),
    # src, dst, num_edges, num_nodes, perm -> 0, or -1 on a bad edge id
    "gt_rabbit_permutation": (ctypes.c_int, (_I64P, _I64P, _I64, _I64, _I64P)),
    # row_ptr, n, part_size, part_ptr, part2node, capacity -> parts
    "gt_build_parts": (_I64, (_I32P, _I64, _I64, _I32P, _I32P, _I64)),
}


def library_path() -> str:
    """Where the library for the current source and flags lives (it may
    not exist yet)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as fp:
        h.update(fp.read())
    return os.path.join(BUILD_DIR, f"libgraphtools_{h.hexdigest()[:16]}.so")


def available() -> bool:
    """True when the library is built or ``g++`` can build it."""
    return os.path.exists(library_path()) or shutil.which("g++") is not None


def build() -> str:
    """Compile the library unless it exists; returns its path."""
    so = library_path()
    if os.path.exists(so):
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native graph tools cannot build")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, SRC, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"g++ failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    lib = ctypes.CDLL(build())
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def parse_edge_list(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse 'src dst' lines (# comments, blank lines skipped) into
    (src, dst) int64 arrays, in file order."""
    lib = get_lib()
    n = lib.gt_parse_edge_list(path.encode(), None, None, 0)
    if n < 0:
        raise OSError(f"cannot parse {path}")
    src = np.empty(n, dtype=np.int64)
    dst = np.empty(n, dtype=np.int64)
    n2 = lib.gt_parse_edge_list(
        path.encode(), _ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64), n
    )
    if n2 != n:
        raise OSError(f"{path} changed while it was parsed")
    return src, dst


def rabbit_permutation(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Community-reordering permutation (old id -> new id)."""
    lib = get_lib()
    src = np.ascontiguousarray(edge_index[0], dtype=np.int64)
    dst = np.ascontiguousarray(edge_index[1], dtype=np.int64)
    perm = np.empty(num_nodes, dtype=np.int64)
    rc = lib.gt_rabbit_permutation(
        _ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64),
        len(src), num_nodes, _ptr(perm, ctypes.c_int64),
    )
    if rc != 0:
        raise ValueError(
            f"rabbit_permutation: an edge id falls outside [0, {num_nodes})"
        )
    return perm


def build_parts(
    row_pointers: np.ndarray, part_size: int
) -> tuple[np.ndarray, np.ndarray]:
    """Ragged (partPtr, part2Node) descriptors (GNNAdvisor.cpp:210-251)."""
    if part_size < 1:
        raise ValueError("part_size must be >= 1")
    lib = get_lib()
    rp = np.ascontiguousarray(row_pointers, dtype=np.int32)
    n = len(rp) - 1
    count = lib.gt_build_parts(_ptr(rp, ctypes.c_int32), n, part_size, None,
                               None, 0)
    part_ptr = np.empty(count + 1, dtype=np.int32)
    part2node = np.empty(count, dtype=np.int32)
    lib.gt_build_parts(
        _ptr(rp, ctypes.c_int32), n, part_size,
        _ptr(part_ptr, ctypes.c_int32), _ptr(part2node, ctypes.c_int32), count,
    )
    return part_ptr, part2node
