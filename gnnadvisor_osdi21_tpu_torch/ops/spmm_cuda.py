"""The hybrid layout's three transposed kernels, their plain versions and
their launch counts.

Each kernel has:

- a plain PyTorch version (``*_plain``): an explicit unpack of the bits to
  a 0/1 matrix and an f32 product, the same arithmetic as the JAX
  package's reference branches (ops/hybrid_agg.py:189-207, 269-285).  The
  CPU tests use it, and chip_smoke.py holds the kernel against it on the
  card;
- a wrapper that checks device, dtype, shape and contiguity, runs the
  plain version for CPU tensors only, and for CUDA tensors launches the
  hand-written kernel in ``csrc/`` or raises;
- a launch count in ``launches``, raised by one each time the wrapper
  launches its kernel and nowhere else.

TPU kernels replaced (gnnadvisor_osdi21_tpu/ops/spmm_pallas.py):
``slab_matmul_t`` (:469) -> csrc/slab_t.cu, ``fused_slab_matmul_t``
(:556) -> csrc/slab_t.cu, ``residual_combine_t`` (:649) ->
csrc/residual_t.cu.

Bit layout: a slab is uint16 ``[K/16, R]`` with column j in word
``j % (K/16)`` at bit ``j // (K/16)``; a residual mask is uint16
``[S/16, T·OB]`` with slot s of tile i and out row o in word ``s % S16``,
bit ``s // S16``, lane ``i·OB + o``.  Accumulation is f32 throughout.
"""

from __future__ import annotations

import torch

from gnnadvisor_osdi21_tpu_torch.ops import _build

KERNELS = ("slab_matmul_t", "fused_slab_matmul_t", "residual_combine_t")
# kernel name -> launches since the last reset_launches()
launches = dict.fromkeys(KERNELS, 0)

FEATURE_DTYPES = (torch.float32, torch.bfloat16)
MAX_RES_TILE = 256  # slots per residual tile the CUDA kernel stages


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_width(k: int) -> None:
    """The uint16 bit-test layout addresses K < 65536 columns
    (spmm_pallas.py:113-121, ``_pow2_col``)."""
    if k >= 65536:
        raise ValueError(f"slab width {k} overflows the uint16 bit-test layout")


def _check_bits(name: str, bits: torch.Tensor) -> int:
    if bits.dtype != torch.uint16 or bits.dim() != 2 or bits.shape[0] == 0:
        raise ValueError(f"{name} must be a non-empty 2-D uint16 tensor, got "
                         f"{bits.dtype} {tuple(bits.shape)}")
    if not bits.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    k = bits.shape[0] * 16
    _check_width(k)
    return k


def _check_features(name: str, x: torch.Tensor) -> None:
    if x.dtype not in FEATURE_DTYPES or x.dim() != 2:
        raise ValueError(f"{name} must be a 2-D float32 or bfloat16 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU operands, False for operands on one CUDA device;
    anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) == 1:
        (dev,) = devices
        if dev.type in ("cpu", "cuda"):
            return dev.type == "cpu"
    raise ValueError(
        "operands must all lie on the CPU or all on one CUDA device, got "
        + ", ".join(sorted(str(d) for d in devices))
    )


def unpack_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint16 ``[K/16, N]`` bit-major words -> f32 0/1 ``[K, N]``: row j is
    word ``j % (K/16)``, bit ``j // (K/16)``."""
    w16 = bits.shape[0]
    j = torch.arange(w16 * 16, device=bits.device)
    words = bits.view(torch.int16).to(torch.int32) & 0xFFFF
    shift = (j // w16).to(torch.int32)[:, None]
    return ((words[j % w16] >> shift) & 1).to(torch.float32)


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def slab_matmul_t_plain(
    bits_t: torch.Tensor, x_t: torch.Tensor, table_block_cols: int | None = None
) -> torch.Tensor:
    """out[D, R] f32 = x_t @ unpack(bits_t); hot wiring (global [D, K]
    table) when ``table_block_cols`` is None, else the diagonal wiring
    (column block i reads ``x_t[:, i·B:(i+1)·B]``)."""
    a = unpack_bits(bits_t)  # [K, R]
    x = x_t.to(torch.float32)
    if table_block_cols is None:
        return x @ a
    k, r = a.shape
    d, nb = x.shape[0], r // k
    return torch.einsum(
        "dnc,cnr->dnr", x.reshape(d, nb, k), a.reshape(k, nb, k)
    ).reshape(d, r)


def fused_slab_matmul_t_plain(
    diag_bits_t: torch.Tensor, hot_bits_t: torch.Tensor, x_t: torch.Tensor,
    x_hot_t: torch.Tensor, diag_b: int,
) -> torch.Tensor:
    """Diagonal plus hot tier in one call: out[D, R] f32."""
    return (
        slab_matmul_t_plain(diag_bits_t, x_t, table_block_cols=diag_b)
        + slab_matmul_t_plain(hot_bits_t, x_hot_t)
    )


def residual_combine_t_plain(
    rows_t: torch.Tensor, mask_s: torch.Tensor, t2b: torch.Tensor,
    num_rows: int, res_ob: int,
) -> torch.Tensor:
    """out[D, num_rows] f32: every tile's rows @ its unpacked [S, OB] mask,
    summed into the tile's output block; blocks no tile visits are 0."""
    s = mask_s.shape[0] * 16
    t = t2b.shape[0]
    d = rows_t.shape[0]
    n_blocks = num_rows // res_ob
    a = unpack_bits(mask_s).reshape(s, t, res_ob)
    rows = rows_t.to(torch.float32).reshape(d, t, s)
    chunks = torch.einsum("dts,sto->tdo", rows, a).reshape(t, d * res_ob)
    # segment sum over the sorted tile -> block map as one 0/1 product
    # (deterministic, unlike index_add_ on CUDA)
    onehot = (
        t2b.to(torch.int64)[None, :]
        == torch.arange(n_blocks, device=t2b.device)[:, None]
    ).to(torch.float32)
    blocks = (onehot @ chunks).reshape(n_blocks, d, res_ob)
    return blocks.permute(1, 0, 2).reshape(d, num_rows)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------


def _table_width(d: int) -> int:
    """Row width of the kernels' row-major tables: one feature tile of a
    multiple of 8 up to 32, else whole tiles of 32 (csrc/slab_t.cu)."""
    return _round_up(d, 8) if d <= 32 else _round_up(d, 32)


def _row_table(x_t: torch.Tensor, width: int) -> torch.Tensor:
    """[D, T] -> row-major [T, width], zero-padded: one set bit then reads
    one contiguous row."""
    d, t = x_t.shape
    table = x_t.new_zeros((t, width))
    table[:, :d] = x_t.t()
    return table


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def slab_matmul_t(
    bits_t: torch.Tensor, x_t: torch.Tensor, table_block_cols: int | None = None
) -> torch.Tensor:
    """out[D, R] f32 = x_t @ unpack(bits_t) (global or block-local table).

    ``bits_t`` uint16 [K/16, R]; ``x_t`` [D, K] (hot) or [D, R] (diagonal,
    ``table_block_cols == K``), float32 or bfloat16."""
    k = _check_bits("bits_t", bits_t)
    _check_features("x_t", x_t)
    r = bits_t.shape[1]
    if table_block_cols is None:
        if x_t.shape[1] != k:
            raise ValueError(f"hot table cols {x_t.shape[1]} != slab K {k}")
    elif table_block_cols != k or x_t.shape[1] != r or r % k:
        raise ValueError(
            f"diag block {table_block_cols}: slab K {k}, x cols "
            f"{x_t.shape[1]}, slab cols {r} (must be K, R, a multiple of K)"
        )
    if _on_cpu(bits_t, x_t):
        return slab_matmul_t_plain(bits_t, x_t, table_block_cols)
    return _slab_matmul_t_cuda(bits_t, x_t, table_block_cols or 0)


def _slab_matmul_t_cuda(bits_t, x_t, block: int) -> torch.Tensor:
    d, r = x_t.shape[0], bits_t.shape[1]
    width = _table_width(d)
    table = _row_table(x_t, width)
    out = torch.empty((d, r), dtype=torch.float32, device=x_t.device)
    with torch.cuda.device(x_t.device):
        rc = _build.library().gnna_slab_matmul_t(
            bits_t.data_ptr(), bits_t.shape[0], block, table.data_ptr(), r, d,
            width, int(x_t.dtype == torch.bfloat16), out.data_ptr(),
            _stream(x_t.device),
        )
    _build.check("slab_matmul_t", rc)
    launches["slab_matmul_t"] += 1
    return out


def fused_slab_matmul_t(
    diag_bits_t: torch.Tensor, hot_bits_t: torch.Tensor, x_t: torch.Tensor,
    x_hot_t: torch.Tensor, diag_b: int,
) -> torch.Tensor:
    """out[D, R] = x_t @ blockdiag(diag) + x_hot_t @ hot, one column pass."""
    b = _check_bits("diag_bits_t", diag_bits_t)
    k = _check_bits("hot_bits_t", hot_bits_t)
    _check_features("x_t", x_t)
    _check_features("x_hot_t", x_hot_t)
    r = diag_bits_t.shape[1]
    if (
        b != diag_b or hot_bits_t.shape[1] != r or x_t.shape[1] != r
        or r % b or x_hot_t.shape[1] != k or x_hot_t.shape[0] != x_t.shape[0]
        or x_hot_t.dtype != x_t.dtype
    ):
        raise ValueError(
            f"fused slabs: diag K {b} (diag_b {diag_b}), hot K {k}, cols "
            f"{r}/{hot_bits_t.shape[1]}, x {tuple(x_t.shape)} {x_t.dtype}, "
            f"x_hot {tuple(x_hot_t.shape)} {x_hot_t.dtype}"
        )
    if _on_cpu(diag_bits_t, hot_bits_t, x_t, x_hot_t):
        return fused_slab_matmul_t_plain(
            diag_bits_t, hot_bits_t, x_t, x_hot_t, diag_b
        )
    return _fused_slab_matmul_t_cuda(
        diag_bits_t, hot_bits_t, x_t, x_hot_t, diag_b
    )


def _fused_slab_matmul_t_cuda(diag_bits_t, hot_bits_t, x_t, x_hot_t, diag_b):
    d, r = x_t.shape[0], diag_bits_t.shape[1]
    width = _table_width(d)
    diag_table = _row_table(x_t, width)
    hot_table = _row_table(x_hot_t, width)
    out = torch.empty((d, r), dtype=torch.float32, device=x_t.device)
    with torch.cuda.device(x_t.device):
        rc = _build.library().gnna_fused_slab_matmul_t(
            diag_bits_t.data_ptr(), diag_bits_t.shape[0], diag_b,
            diag_table.data_ptr(), hot_bits_t.data_ptr(), hot_bits_t.shape[0],
            hot_table.data_ptr(), r, d, width,
            int(x_t.dtype == torch.bfloat16), out.data_ptr(),
            _stream(x_t.device),
        )
    _build.check("fused_slab_matmul_t", rc)
    launches["fused_slab_matmul_t"] += 1
    return out


def residual_combine_t(
    rows_t: torch.Tensor, mask_s: torch.Tensor, t2b: torch.Tensor,
    block_ptr: torch.Tensor, num_rows: int, res_ob: int,
) -> torch.Tensor:
    """out[D, num_rows] f32: residual-tier combine.

    ``rows_t`` [D, T·S] gathered slot rows; ``mask_s`` uint16 [S/16, T·OB];
    ``t2b`` int32 [T] tile -> out block, sorted ascending; ``block_ptr``
    int32 [num_rows/OB + 1], the tile range of each block (the offsets of
    ``t2b``'s runs).  Blocks with no tile come out as zeros."""
    s = _check_bits("mask_s", mask_s)
    _check_features("rows_t", rows_t)
    for name, v in (("t2b", t2b), ("block_ptr", block_ptr)):
        if v.dtype != torch.int32 or v.dim() != 1 or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
    t = t2b.shape[0]
    if (
        res_ob <= 0 or num_rows % res_ob or mask_s.shape[1] != t * res_ob
        or rows_t.shape[1] != t * s
        or block_ptr.shape[0] != num_rows // res_ob + 1
    ):
        raise ValueError(
            f"residual stream: {t} tiles of {s} slots, mask "
            f"{tuple(mask_s.shape)}, rows {tuple(rows_t.shape)}, block_ptr "
            f"{tuple(block_ptr.shape)}, num_rows {num_rows}, res_ob {res_ob}"
        )
    if _on_cpu(rows_t, mask_s, t2b, block_ptr):
        return residual_combine_t_plain(rows_t, mask_s, t2b, num_rows, res_ob)
    if s > MAX_RES_TILE:
        raise ValueError(
            f"residual tile of {s} slots exceeds the kernel's {MAX_RES_TILE}"
        )
    return _residual_combine_t_cuda(rows_t, mask_s, block_ptr, num_rows, res_ob)


def _residual_combine_t_cuda(rows_t, mask_s, block_ptr, num_rows, res_ob):
    d = rows_t.shape[0]
    out = torch.empty((d, num_rows), dtype=torch.float32, device=rows_t.device)
    with torch.cuda.device(rows_t.device):
        rc = _build.library().gnna_residual_combine_t(
            mask_s.data_ptr(), mask_s.shape[0], res_ob,
            mask_s.shape[1] // res_ob, rows_t.data_ptr(), block_ptr.data_ptr(),
            num_rows, d, int(rows_t.dtype == torch.bfloat16), out.data_ptr(),
            _stream(rows_t.device),
        )
    _build.check("residual_combine_t", rc)
    launches["residual_combine_t"] += 1
    return out
