"""The measurement probes' three slab kernels (a bit slab and two dense
slabs), their plain versions and their launch counts.

TPU kernels replaced (``gnnadvisor_osdi21_tpu/bench/``):

- ``_bit_t_kernel`` (fixprobe.py:63, wrapper ``bit_slab_t``,
  ``csrc/bit_walk.cu``): ``out[16, R] = x_t @ unpack(bits)`` from the legacy
  uint32 transposed bit slab ``[K/32, R]``, column j in word ``j % (K/32)``
  at bit ``j // (K/32)`` (the transpose of ``graphs.hybrid.pack_slab_bits``);
- ``_i8_t_kernel`` (fixprobe.py:94, ``i8_slab_t``, ``csrc/dense_slab.cu``):
  ``out[16, R] = x_t @ A`` with a dense int8 ``A [K, R]`` cast to x's dtype;
- ``_dense_kernel`` (stepprobe.py:69, ``dense_slab``,
  ``csrc/dense_slab.cu``): ``out[R, 16] = Aᵀ x`` with a dense int8 or bf16
  ``A [K, R]`` and bf16 or f32 ``x [K, 16]``.

As in ``spmm_cuda``: each wrapper checks device, dtype, shape and
contiguity, runs the plain version for CPU tensors only, and for CUDA
tensors launches its kernel or raises; ``launches`` counts the kernel
launches.  The kernels compute 16 features (one MMA tile): the probes'
width.

``bit_slab_t`` walks the set bits (``csrc/bit_walk.cu``): persistent
blocks of one producer warp, which streams the slab's words through a ring
of shared-memory stages as boxes of a 2-D tensor map, and eight consumer
warps of 16 graph rows, two lanes a row, which list the columns of their
row's set bits and add those feature rows in f32 registers (``x_t`` is
first copied row-major into a scratch ``[K, 16]`` table, the rows the walk
reads).  ``i8_slab_t`` and ``dense_slab`` run on a streamed slab ring
(``csrc/dense_slab.cu``): persistent blocks of one producer warp, which
keeps a ring of slab columns full with boxes of a 2-D tensor map, and four
consumer warps of 64 graph rows, which widen int8 to bf16 with byte
permutes and one bf16x2 FMA (no I2F) and run ``mma.sync`` m16n8k16.  A
small pass first writes the features in the MMA's fragment order into a
scratch buffer; f32 features are split there exactly into three bf16
terms (``split3``), so the int8/f32 pair runs on the tensor cores too,
with no TF32.  All three
kernels size their own tiles: they take ``block_rows`` (the graph rows of
one CUDA block of threads, 32 to 512, a multiple of 32; the probe scripts
map the TPU's grid-step rows ``br`` to ``br // 16``) and check it, so the
scripts keep the JAX sweeps, and every value launches the same kernel
(``BIT_BLOCK`` and ``DENSE_BLOCK`` name it on the scripts' lines).
"""

from __future__ import annotations

import torch

from gnnadvisor_osdi21_tpu_torch.ops import _build
from gnnadvisor_osdi21_tpu_torch.ops.spmm_cuda import _on_cpu, _stream

KERNELS = ("bit_slab_t", "i8_slab_t", "dense_slab")
# kernel name -> launches since the last reset_launches()
launches = dict.fromkeys(KERNELS, 0)

FEATURES = 16  # the kernels' feature width
K_STEP = 16  # the MMA's k16 step: K must be a multiple
FRAG_BYTES = 512  # one k16 step's features in fragment order, per term
# the CUDA blocks of the kernels, whatever block_rows says
BIT_BLOCK = "the walk's own (persistent, 288 thr, 128-row tiles)"
DENSE_BLOCK = "the kernel's own (persistent, 160 thr, 256-row tiles)"
# the (slab, features) dtypes of dense_slab's path (stepprobe.py:104-105)
DENSE_DTYPES = (
    (torch.int8, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
    (torch.int8, torch.float32),
)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def block_rows_for(br: int) -> int:
    """CUDA block rows for a TPU grid step of ``br`` rows (the probes'
    sweep points, 512 to 8192)."""
    return br // 16


def unpack_bits32(bits: torch.Tensor) -> torch.Tensor:
    """uint32 ``[K/32, N]`` bit-major words -> f32 0/1 ``[K, N]``: row j is
    word ``j % (K/32)``, bit ``j // (K/32)``."""
    w32 = bits.shape[0]
    j = torch.arange(w32 * 32, device=bits.device)
    # an arithmetic shift keeps bit k of the word at bit 0
    words = bits.view(torch.int32)
    shift = (j // w32).to(torch.int32)[:, None]
    return ((words[j % w32] >> shift) & 1).to(torch.float32)


# ---------------------------------------------------------------------------
# Plain versions: the 0/1 slab in f32 and one f32 product.
# ---------------------------------------------------------------------------


def bit_slab_t_plain(bits_t: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
    """out[D, R] f32 = x_t @ unpack(bits_t)."""
    return x_t.to(torch.float32) @ unpack_bits32(bits_t)


def i8_slab_t_plain(a_t: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
    """out[D, R] f32 = x_t @ a_t (a_t's values cast to f32: exact)."""
    return x_t.to(torch.float32) @ a_t.to(torch.float32)


def dense_slab_plain(a_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[R, D] f32 = a_tᵀ @ x."""
    return a_t.to(torch.float32).t() @ x.to(torch.float32)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------


def _check_2d(name: str, t: torch.Tensor, dtypes) -> None:
    if t.dtype not in dtypes or t.dim() != 2:
        raise ValueError(f"{name} must be a 2-D tensor of "
                         f"{', '.join(map(str, dtypes))}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_launch(k: int, r: int, d: int, block_rows: int, *tensors) -> None:
    """What the CUDA kernels take: 16 features, K a multiple of 16, R of 8,
    16-byte-aligned operands, a block of 32 to 512 rows."""
    if d != FEATURES or k % K_STEP or k == 0 or r % 8 or r == 0:
        raise ValueError(f"the probe kernels take {FEATURES} features, K a "
                         f"multiple of {K_STEP} and R of 8; got D={d}, "
                         f"K={k}, R={r}")
    if block_rows < 32 or block_rows > 512 or block_rows % 32:
        raise ValueError(f"block_rows {block_rows} must be a multiple of 32 "
                         "from 32 to 512")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("operands must be 16-byte aligned")


def _frags(k: int, terms: int, device) -> torch.Tensor:
    """Scratch for the features in fragment order."""
    return torch.empty(k // K_STEP * terms * FRAG_BYTES, dtype=torch.uint8,
                       device=device)


def bit_slab_t(bits_t: torch.Tensor, x_t: torch.Tensor,
               block_rows: int = 256) -> torch.Tensor:
    """out[D, R] f32 = x_t @ unpack(bits_t); ``bits_t`` uint32 [K/32, R],
    ``x_t`` bf16 [D, K].  ``block_rows`` is checked, and does not change
    the CUDA launch."""
    _check_2d("bits_t", bits_t, (torch.uint32,))
    _check_2d("x_t", x_t, (torch.bfloat16,))
    k, r = bits_t.shape[0] * 32, bits_t.shape[1]
    if x_t.shape[1] != k:
        raise ValueError(f"x_t has {x_t.shape[1]} columns, the slab K {k}")
    if _on_cpu(bits_t, x_t):
        return bit_slab_t_plain(bits_t, x_t)
    _check_launch(k, r, x_t.shape[0], block_rows, bits_t, x_t)
    return _bit_slab_t_cuda(bits_t, x_t, block_rows)


def _bit_slab_t_cuda(bits_t, x_t, block_rows: int) -> torch.Tensor:
    r = bits_t.shape[1]
    out = torch.empty((FEATURES, r), dtype=torch.float32, device=x_t.device)
    # scratch for x_t's row-major copy (at most 128 KB at the probes' K)
    table = torch.empty((x_t.shape[1], FEATURES), dtype=torch.bfloat16,
                        device=x_t.device)
    with torch.cuda.device(x_t.device):
        rc = _build.library().gnna_bit_slab_t(
            bits_t.data_ptr(), bits_t.shape[0], r, x_t.data_ptr(),
            table.data_ptr(), block_rows, out.data_ptr(), _stream(x_t.device),
        )
    _build.check("bit_slab_t", rc)
    launches["bit_slab_t"] += 1
    return out


def i8_slab_t(a_t: torch.Tensor, x_t: torch.Tensor,
              block_rows: int = 256) -> torch.Tensor:
    """out[D, R] f32 = x_t @ a_t; ``a_t`` int8 [K, R], ``x_t`` bf16 [D, K].
    ``block_rows`` is checked, and does not change the CUDA launch."""
    _check_2d("a_t", a_t, (torch.int8,))
    _check_2d("x_t", x_t, (torch.bfloat16,))
    k, r = a_t.shape
    if x_t.shape[1] != k:
        raise ValueError(f"x_t has {x_t.shape[1]} columns, the slab K {k}")
    if _on_cpu(a_t, x_t):
        return i8_slab_t_plain(a_t, x_t)
    _check_launch(k, r, x_t.shape[0], block_rows, a_t, x_t)
    return _i8_slab_t_cuda(a_t, x_t)


def _i8_slab_t_cuda(a_t, x_t) -> torch.Tensor:
    k, r = a_t.shape
    out = torch.empty((FEATURES, r), dtype=torch.float32, device=x_t.device)
    frags = _frags(k, 1, x_t.device)
    with torch.cuda.device(x_t.device):
        rc = _build.library().gnna_i8_slab_t(
            a_t.data_ptr(), k, r, x_t.data_ptr(), frags.data_ptr(),
            out.data_ptr(), _stream(x_t.device),
        )
    _build.check("i8_slab_t", rc)
    launches["i8_slab_t"] += 1
    return out


def dense_slab(a_t: torch.Tensor, x: torch.Tensor,
               block_rows: int = 64) -> torch.Tensor:
    """out[R, D] f32 = a_tᵀ @ x; (``a_t`` [K, R], ``x`` [K, D]) dtypes one
    of ``DENSE_DTYPES``.  ``block_rows`` is checked, and does not change
    the CUDA launch."""
    _check_2d("a_t", a_t, (torch.int8, torch.bfloat16))
    _check_2d("x", x, (torch.bfloat16, torch.float32))
    if (a_t.dtype, x.dtype) not in DENSE_DTYPES:
        raise ValueError(f"slab {a_t.dtype} with features {x.dtype} is not "
                         "a dtype pair of the probe")
    k, r = a_t.shape
    if x.shape[0] != k:
        raise ValueError(f"x has {x.shape[0]} rows, the slab K {k}")
    if _on_cpu(a_t, x):
        return dense_slab_plain(a_t, x)
    _check_launch(k, r, x.shape[1], block_rows, a_t, x)
    return _dense_slab_cuda(a_t, x)


def _dense_slab_cuda(a_t, x) -> torch.Tensor:
    k, r = a_t.shape
    x_f32 = x.dtype == torch.float32
    out = torch.empty((r, FEATURES), dtype=torch.float32, device=x.device)
    frags = _frags(k, 3 if x_f32 else 1, x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().gnna_dense_slab(
            a_t.data_ptr(), int(a_t.dtype == torch.bfloat16), k, r,
            x.data_ptr(), int(x_f32), frags.data_ptr(), out.data_ptr(),
            _stream(x.device),
        )
    _build.check("dense_slab", rc)
    launches["dense_slab"] += 1
    return out
