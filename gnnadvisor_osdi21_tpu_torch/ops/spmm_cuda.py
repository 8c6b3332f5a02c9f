"""The hybrid layout's seven kernels, their plain versions and their launch
counts.

Each kernel has:

- a plain PyTorch version (``*_plain``): an explicit unpack of the bits to
  a 0/1 matrix and an f32 product, the same arithmetic as the JAX
  package's reference branches (ops/hybrid_agg.py:180-285).  The CPU tests
  use it, and chip_smoke.py holds the kernel against it on the card;
- a wrapper that checks device, dtype, shape and contiguity, runs the
  plain version for CPU tensors only, and for CUDA tensors launches the
  hand-written kernel in ``csrc/`` or raises;
- a launch count in ``launches`` (the span store's counter
  ``launches.<kernel>``, ``utils/profiling.py``), raised by one each time
  the wrapper launches its kernel and nowhere else.

TPU kernels replaced (gnnadvisor_osdi21_tpu/ops/spmm_pallas.py), features
transposed ``[D, R]``: ``slab_matmul_t`` (:469) and ``fused_slab_matmul_t``
(:556) -> csrc/slab.cu, ``residual_combine_t`` (:649) ->
csrc/residual_t.cu; features row-major ``[R, D]``: ``slab_matmul`` (:143,
with its ``hot_slab_matmul`` and ``diag_slab_matmul`` wirings) and
``fused_slab_matmul`` (:259) -> csrc/slab.cu, ``residual_combine`` (:354)
-> csrc/residual.cu.  The slab kernels of both orientations are one walk
with two epilogues.  Both residual kernels also take over their caller's
slot gathers (they read the slot rows of x by ``res_src``) and, given an
addend, the tier sum.  The seventh, ``hot_list_t`` (csrc/hot_list.cu),
replaces no TPU kernel: it walks the hot tier as per-row lists of the
rows of x each row reads, where those lists are smaller than the slab.

Every kernel reads its features from a row-major table ``[rows, ld]``.
The transposed wrappers take ``x_t [D, X]`` as the transposed view
``table.t()[:D]`` of such a table (``row_table_t``), which the kernels
read in place, and refuse any other x_t: the transposed aggregation
builds one table per call and hands every tier a view of it.

Bit layout: a slab is uint16 ``[K/16, R]`` with column j in word
``j % (K/16)`` at bit ``j // (K/16)`` (both orientations); a transposed
residual mask is uint16 ``[S/16, T·OB]`` with slot s of tile i and out row
o in word ``s % S16``, bit ``s // S16``, lane ``i·OB + o``; a row-major
residual mask is uint32 ``[OB/32, M_pad]`` with slot m and out row o of
its block in word ``o % (OB/32)``, bit ``o // (OB/32)``.  Accumulation is
f32 throughout.
"""

from __future__ import annotations

import torch

from gnnadvisor_osdi21_tpu_torch.ops import _build
from gnnadvisor_osdi21_tpu_torch.utils import profiling

KERNELS = (
    "slab_matmul_t", "fused_slab_matmul_t", "residual_combine_t",
    "slab_matmul", "fused_slab_matmul", "residual_combine", "hot_list_t",
)
# kernel name -> launches since the last reset_launches(): the span
# store's counters ``launches.<kernel>``
launches = profiling.CounterView("launches.", KERNELS)

FEATURE_DTYPES = (torch.float32, torch.bfloat16)
MAX_RES_TILE = 256  # slots per residual tile the CUDA kernels stage


def reset_launches() -> None:
    launches.update(dict.fromkeys(launches, 0))


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


def _check_index(name: str, v: torch.Tensor) -> None:
    if v.dtype != torch.int32 or v.dim() != 1 or not v.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")


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
    x_t: torch.Tensor, res_src: torch.Tensor, mask_s: torch.Tensor,
    t2b: torch.Tensor, block_ptr: torch.Tensor, num_rows: int, res_ob: int,
    addend: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[D, num_rows] f32: the slot rows ``x_t[:, res_src]``, and for
    every tile its rows @ its unpacked [S, OB] mask, summed into the tile's
    output block; blocks no tile visits are 0.  With ``addend``, ``addend
    + out``.  ``block_ptr`` is the kernel's; the plain version finds each
    block's tiles from ``t2b``."""
    rows_t = x_t.index_select(1, res_src)
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
    out = blocks.permute(1, 0, 2).reshape(d, num_rows)
    return out if addend is None else addend + out


def hot_list_t_plain(
    x_t: torch.Tensor, hot_ptr: torch.Tensor, hot_src: torch.Tensor,
    addend: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[D, R] f32: column r is the sum of the columns ``x_t[:,
    hot_src[k]]``, k in ``hot_ptr[r] .. hot_ptr[r+1]``, added in entry
    order from zero, as the kernel adds them (so the two agree bit for
    bit); with ``addend``, ``addend + out``."""
    d, r = x_t.shape[0], hot_ptr.shape[0] - 1
    ptr = hot_ptr.to(torch.int64)
    lens = ptr[1:] - ptr[:-1]
    src = hot_src.to(torch.int64)
    x = x_t.to(torch.float32)
    out = torch.zeros((d, r), dtype=torch.float32, device=x_t.device)
    for step in range(int(lens.max()) if r else 0):
        rows = torch.nonzero(lens > step).squeeze(1)
        out[:, rows] += x[:, src[ptr[rows] + step]]
    return out if addend is None else addend + out


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------


def _table_width(d: int) -> int:
    """Row width of the row-major kernels' tables: a multiple of 8 up to
    32, else whole tiles of 32."""
    return _round_up(d, 8) if d <= 32 else _round_up(d, 32)


def _row_table(x: torch.Tensor, width: int) -> torch.Tensor:
    """x [T, D] as a contiguous row-major table of ``width`` columns: x
    itself when it already is one, else a zero-padded copy, so one set bit
    reads one 16-byte-aligned row."""
    if x.shape[1] == width and x.is_contiguous():
        return x
    table = x.new_zeros((x.shape[0], width))
    table[:, : x.shape[1]] = x
    return table


def row_table_t(
    x_t: torch.Tensor, dtype: torch.dtype | None = None,
    scale: torch.Tensor | None = None, rows: int | None = None,
) -> torch.Tensor:
    """x_t [D, X] as a row-major table [X, round_up(D, 8)] with zero pad
    columns, in ``dtype`` (default x_t's) and, given ``scale`` [X], times
    it per column; one pass that scales, casts and transposes together.
    ``table.t()[:D]`` is then x_t again, in the form the transposed
    kernels read in place.  ``rows`` (>= X) makes a taller table whose
    rows past X the caller fills (their pad columns are zero here)."""
    d, n = x_t.shape
    width = _round_up(d, 8)
    rows = n if rows is None else rows
    if rows < n:
        raise ValueError(f"a table of {rows} rows cannot hold {n} columns")
    table = torch.empty((rows, width), dtype=dtype or x_t.dtype,
                        device=x_t.device)
    if width > d:
        table[:, d:].zero_()
    if scale is None:
        table[:n, :d].copy_(x_t.t())
    else:
        torch.mul(x_t.t(), scale[:, None], out=table[:n, :d])
    return table


def _table_ld(name: str, x_t: torch.Tensor, ld: int | None = None) -> int:
    """The row width of the table whose transposed view ``table.t()[:D]``
    x_t [D, X] is (``row_table_t``; ``ld`` where given): rows a multiple
    of 8 elements and at least D apart, 16-byte aligned, every row inside
    the storage.  Any other x_t raises."""
    if x_t.dtype not in FEATURE_DTYPES or x_t.dim() != 2:
        raise ValueError(f"{name} must be a 2-D float32 or bfloat16 tensor, "
                         f"got {x_t.dtype} {tuple(x_t.shape)}")
    d, n = x_t.shape
    w = x_t.stride(1)
    if not (
        x_t.stride(0) == 1 and w % 8 == 0 and w >= d
        and (ld is None or w == ld)
        and x_t.data_ptr() % 16 == 0
        and (x_t.storage_offset() + n * w) * x_t.element_size()
        <= x_t.untyped_storage().nbytes()
    ):
        raise ValueError(
            f"{name} must be the transposed view table.t()[:D] of a whole "
            "row-major table (row_table_t)"
            + ("" if ld is None else f" of {ld} columns")
            + f", got strides {x_t.stride()}"
        )
    return w


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_stream(r: int) -> None:
    """What the slab kernels take: rows in whole 16-byte pieces of the slab
    (their bulk copies move multiples of 16 bytes)."""
    if r % 8:
        raise ValueError(
            f"slab of {r} rows: the kernel takes a multiple of 8 rows"
        )


def slab_matmul_t(
    bits_t: torch.Tensor, x_t: torch.Tensor, table_block_cols: int | None = None
) -> torch.Tensor:
    """out[D, R] f32 = x_t @ unpack(bits_t) (global or block-local table).

    ``bits_t`` uint16 [K/16, R]; ``x_t`` [D, K] (hot) or [D, R] (diagonal,
    ``table_block_cols == K``), float32 or bfloat16, the transposed view
    of a row-major table (``row_table_t``)."""
    k = _check_bits("bits_t", bits_t)
    _table_ld("x_t", x_t)
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
    _check_stream(r)
    return _slab_matmul_t_cuda(bits_t, x_t, table_block_cols or 0)


def _slab_matmul_t_cuda(bits_t, x_t, block: int) -> torch.Tensor:
    d, r = x_t.shape[0], bits_t.shape[1]
    out = torch.empty((d, r), dtype=torch.float32, device=x_t.device)
    with torch.cuda.device(x_t.device):
        rc = _build.library().gnna_slab_matmul(
            bits_t.data_ptr(), bits_t.shape[0], block, x_t.data_ptr(), r, d,
            x_t.stride(1), int(x_t.dtype == torch.bfloat16), 1, out.data_ptr(),
            _stream(x_t.device),
        )
    _build.check("slab_matmul_t", rc)
    launches["slab_matmul_t"] += 1
    return out


def fused_slab_matmul_t(
    diag_bits_t: torch.Tensor, hot_bits_t: torch.Tensor, x_t: torch.Tensor,
    x_hot_t: torch.Tensor, diag_b: int,
) -> torch.Tensor:
    """out[D, R] = x_t @ blockdiag(diag) + x_hot_t @ hot, one pass; the
    operands as ``slab_matmul_t`` takes them, both tables of one row
    width."""
    b = _check_bits("diag_bits_t", diag_bits_t)
    k = _check_bits("hot_bits_t", hot_bits_t)
    _table_ld("x_hot_t", x_hot_t, _table_ld("x_t", x_t))
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
    _check_stream(r)
    return _fused_slab_matmul_t_cuda(
        diag_bits_t, hot_bits_t, x_t, x_hot_t, diag_b
    )


def _fused_slab_matmul_t_cuda(diag_bits_t, hot_bits_t, x_t, x_hot_t, diag_b):
    d, r = x_t.shape[0], diag_bits_t.shape[1]
    out = torch.empty((d, r), dtype=torch.float32, device=x_t.device)
    with torch.cuda.device(x_t.device):
        rc = _build.library().gnna_fused_slab_matmul(
            diag_bits_t.data_ptr(), diag_bits_t.shape[0], diag_b,
            x_t.data_ptr(), hot_bits_t.data_ptr(), hot_bits_t.shape[0],
            x_hot_t.data_ptr(), r, d, x_t.stride(1), int(x_t.dtype == torch.bfloat16),
            1, out.data_ptr(), _stream(x_t.device),
        )
    _build.check("fused_slab_matmul_t", rc)
    launches["fused_slab_matmul_t"] += 1
    return out


def residual_combine_t(
    x_t: torch.Tensor, res_src: torch.Tensor, mask_s: torch.Tensor,
    t2b: torch.Tensor, block_ptr: torch.Tensor, num_rows: int, res_ob: int,
    addend: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[D, num_rows] f32: residual-tier combine, features transposed,
    with the slot gather and, given ``addend``, the tier sum in the kernel.

    ``x_t`` [D, X] the gather source, as ``slab_matmul_t`` takes it;
    ``res_src`` int32 [T·S], the column of x_t each slot reads (every id,
    pad slots included, a column of x_t: another id raises, at once on
    the CPU and on the card as a device-side assert at the next
    synchronisation, as ``index_select`` does); ``mask_s`` uint16 [S/16,
    T·OB]; ``t2b`` int32 [T] tile -> out block, sorted ascending;
    ``block_ptr`` int32 [num_rows/OB + 1], the tile range of each block
    (the offsets of ``t2b``'s runs); ``addend`` None or f32 [D, num_rows],
    added to the tier's sum (``addend + out``).  Blocks with no tile come
    out as zeros (as ``addend``)."""
    s = _check_bits("mask_s", mask_s)
    _table_ld("x_t", x_t)
    _check_index("res_src", res_src)
    _check_index("t2b", t2b)
    _check_index("block_ptr", block_ptr)
    t = t2b.shape[0]
    if (
        res_ob <= 0 or num_rows % res_ob or mask_s.shape[1] != t * res_ob
        or res_src.shape[0] != t * s
        or block_ptr.shape[0] != num_rows // res_ob + 1
    ):
        raise ValueError(
            f"residual stream: {t} tiles of {s} slots, mask "
            f"{tuple(mask_s.shape)}, res_src {tuple(res_src.shape)}, "
            f"block_ptr {tuple(block_ptr.shape)}, num_rows {num_rows}, "
            f"res_ob {res_ob}"
        )
    d = x_t.shape[0]
    if addend is not None and (
        addend.dtype != torch.float32
        or tuple(addend.shape) != (d, num_rows)
        or not addend.is_contiguous()
    ):
        raise ValueError(
            f"addend must be a contiguous float32 [{d}, {num_rows}] tensor, "
            f"got {addend.dtype} {tuple(addend.shape)}"
        )
    operands = (x_t, res_src, mask_s, t2b, block_ptr) + (
        () if addend is None else (addend,))
    if _on_cpu(*operands):
        # the ids are checked here; on the card the kernel asserts each id
        # it reads (a check here would wait for the card)
        if res_src.numel() and (int(res_src.min()) < 0
                                or int(res_src.max()) >= x_t.shape[1]):
            raise ValueError(f"res_src holds ids outside x_t's "
                             f"{x_t.shape[1]} columns")
        return residual_combine_t_plain(x_t, res_src, mask_s, t2b, block_ptr,
                                        num_rows, res_ob, addend)
    if s > MAX_RES_TILE or res_ob % 8:
        raise ValueError(
            f"residual tiles of {s} slots, blocks of {res_ob} rows: the "
            f"kernel takes up to {MAX_RES_TILE} slots, a multiple of 8 rows"
        )
    return _residual_combine_t_cuda(x_t, res_src, mask_s, block_ptr, t,
                                    num_rows, res_ob, addend)


def _residual_combine_t_cuda(x_t, res_src, mask_s, block_ptr, t, num_rows,
                             res_ob, addend):
    d, rows = x_t.shape
    out = torch.empty((d, num_rows), dtype=torch.float32, device=x_t.device)
    with torch.cuda.device(x_t.device):
        rc = _build.library().gnna_residual_combine_t(
            mask_s.data_ptr(), mask_s.shape[0], res_ob, t, x_t.data_ptr(),
            rows, x_t.stride(1), res_src.data_ptr(),
            block_ptr.data_ptr(), num_rows, d,
            None if addend is None else addend.data_ptr(),
            int(x_t.dtype == torch.bfloat16), out.data_ptr(),
            _stream(x_t.device),
        )
    _build.check("residual_combine_t", rc)
    launches["residual_combine_t"] += 1
    return out


def hot_list_t(
    x_t: torch.Tensor, hot_ptr: torch.Tensor, hot_src: torch.Tensor,
    addend: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[D, R] f32: the hot tier walked as per-row lists, features
    transposed; column r is ``addend[:, r]`` (where given) plus the sum of
    ``x_t[:, hot_src[k]]`` over k in ``hot_ptr[r] .. hot_ptr[r+1]``.

    ``x_t`` [D, X] as ``slab_matmul_t`` takes it (the transposed view of a
    row-major table, read in place); ``hot_ptr`` int32 [R + 1], the
    offsets of each row's entries; ``hot_src`` int32 [nnz], the column of
    x_t each entry reads (another id raises, at once on the CPU and on
    the card as a device-side assert at the next synchronisation, as
    ``index_select`` does); ``addend`` None or f32 [D, R]."""
    _table_ld("x_t", x_t)
    _check_index("hot_ptr", hot_ptr)
    _check_index("hot_src", hot_src)
    r = hot_ptr.shape[0] - 1
    if r <= 0:
        raise ValueError("hot_ptr must hold at least one row's offsets")
    d = x_t.shape[0]
    if addend is not None and (
        addend.dtype != torch.float32 or tuple(addend.shape) != (d, r)
        or not addend.is_contiguous()
    ):
        raise ValueError(
            f"addend must be a contiguous float32 [{d}, {r}] tensor, got "
            f"{addend.dtype} {tuple(addend.shape)}"
        )
    operands = (x_t, hot_ptr, hot_src) + (() if addend is None else (addend,))
    if _on_cpu(*operands):
        # the list is checked here; on the card the kernel asserts each id
        # it reads (a check here would wait for the card)
        if (int(hot_ptr[0]) != 0 or int(hot_ptr[-1]) != hot_src.numel()
                or bool((hot_ptr[1:] < hot_ptr[:-1]).any())):
            raise ValueError("hot_ptr must rise from 0 to the entries' "
                             f"count {hot_src.numel()}")
        if hot_src.numel() and (int(hot_src.min()) < 0
                                or int(hot_src.max()) >= x_t.shape[1]):
            raise ValueError(f"hot_src holds ids outside x_t's "
                             f"{x_t.shape[1]} columns")
        return hot_list_t_plain(x_t, hot_ptr, hot_src, addend)
    return _hot_list_t_cuda(x_t, hot_ptr, hot_src, addend)


def _hot_list_t_cuda(x_t, hot_ptr, hot_src, addend):
    d, rows = x_t.shape
    r = hot_ptr.shape[0] - 1
    out = torch.empty((d, r), dtype=torch.float32, device=x_t.device)
    with torch.cuda.device(x_t.device):
        rc = _build.library().gnna_hot_list_t(
            hot_ptr.data_ptr(), hot_src.data_ptr(), x_t.data_ptr(), rows,
            x_t.stride(1), r, d,
            None if addend is None else addend.data_ptr(),
            int(x_t.dtype == torch.bfloat16), out.data_ptr(),
            _stream(x_t.device),
        )
    _build.check("hot_list_t", rc)
    launches["hot_list_t"] += 1
    return out


# ---------------------------------------------------------------------------
# Row-major twins: features [R, D], the same slabs, an out-row-major uint32
# residual mask.
# ---------------------------------------------------------------------------


def unpack_mask32(mask: torch.Tensor) -> torch.Tensor:
    """uint32 ``[OB/32, M]`` out-row-major words -> f32 0/1 ``[OB, M]``: row
    o is word ``o % (OB/32)``, bit ``o // (OB/32)``."""
    w = mask.shape[0]
    o = torch.arange(w * 32, device=mask.device)
    # an arithmetic shift keeps bit k of the word at bit 0
    words = mask.view(torch.int32)
    shift = (o // w).to(torch.int32)[:, None]
    return ((words[o % w] >> shift) & 1).to(torch.float32)


def slab_matmul_plain(
    bits_t: torch.Tensor, x: torch.Tensor, table_block_rows: int | None = None
) -> torch.Tensor:
    """out[R, D] f32 = unpack(bits_t)^T @ x; hot wiring (global [K, D]
    table) when ``table_block_rows`` is None, else the diagonal wiring (row
    block i reads ``x[i·B:(i+1)·B]``)."""
    a = unpack_bits(bits_t)  # [K, R]
    xf = x.to(torch.float32)
    if table_block_rows is None:
        return a.t() @ xf
    k, r = a.shape
    nb, d = r // k, xf.shape[1]
    return torch.einsum(
        "cnr,ncd->nrd", a.reshape(k, nb, k), xf.reshape(nb, k, d)
    ).reshape(r, d)


def fused_slab_matmul_plain(
    diag_bits_t: torch.Tensor, hot_bits_t: torch.Tensor, x: torch.Tensor,
    x_hot: torch.Tensor, diag_b: int,
) -> torch.Tensor:
    """Diagonal plus hot tier in one call: out[R, D] f32."""
    return (
        slab_matmul_plain(diag_bits_t, x, table_block_rows=diag_b)
        + slab_matmul_plain(hot_bits_t, x_hot)
    )


def residual_combine_plain(
    x: torch.Tensor, res_src: torch.Tensor, res_mask: torch.Tensor,
    t2b: torch.Tensor, block_ptr: torch.Tensor, num_rows: int, res_ob: int,
    addend: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[num_rows, D] f32: the slot rows ``x[res_src]``, and for every
    tile its unpacked [OB, S] mask @ its rows, summed into the tile's
    output block; blocks no tile visits are 0.  With ``addend``, ``addend
    + out``.  ``block_ptr`` is the kernel's; the plain version finds each
    block's tiles from ``t2b``."""
    rows = x.index_select(0, res_src)
    m_pad, d = rows.shape
    t = t2b.shape[0]
    s = m_pad // t
    n_blocks = num_rows // res_ob
    a = unpack_mask32(res_mask).reshape(res_ob, t, s)
    chunks = torch.einsum(
        "ots,tsd->tod", a, rows.to(torch.float32).reshape(t, s, d)
    ).reshape(t, res_ob * d)
    onehot = (
        t2b.to(torch.int64)[None, :]
        == torch.arange(n_blocks, device=t2b.device)[:, None]
    ).to(torch.float32)
    out = (onehot @ chunks).reshape(num_rows, d)
    return out if addend is None else addend + out


def slab_matmul(
    bits_t: torch.Tensor, x: torch.Tensor, table_block_rows: int | None = None
) -> torch.Tensor:
    """out[R, D] f32 = unpack(bits_t)^T @ x (global or block-local table).

    ``bits_t`` uint16 [K/16, R]; ``x`` [K, D] (hot) or [R, D] (diagonal,
    ``table_block_rows == K``), float32 or bfloat16."""
    k = _check_bits("bits_t", bits_t)
    _check_features("x", x)
    r = bits_t.shape[1]
    if table_block_rows is None:
        if x.shape[0] != k:
            raise ValueError(f"hot table rows {x.shape[0]} != slab K {k}")
    elif table_block_rows != k or x.shape[0] != r or r % k:
        raise ValueError(
            f"diag block {table_block_rows}: slab K {k}, x rows "
            f"{x.shape[0]}, slab rows {r} (must be K, R, a multiple of K)"
        )
    if _on_cpu(bits_t, x):
        return slab_matmul_plain(bits_t, x, table_block_rows)
    _check_stream(r)
    return _slab_matmul_cuda(bits_t, x, table_block_rows or 0)


def _slab_matmul_cuda(bits_t, x, block: int) -> torch.Tensor:
    r, d = bits_t.shape[1], x.shape[1]
    width = _table_width(d)
    table = _row_table(x, width)
    out = torch.empty((r, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().gnna_slab_matmul(
            bits_t.data_ptr(), bits_t.shape[0], block, table.data_ptr(), r, d,
            width, int(x.dtype == torch.bfloat16), 0, out.data_ptr(),
            _stream(x.device),
        )
    _build.check("slab_matmul", rc)
    launches["slab_matmul"] += 1
    return out


def fused_slab_matmul(
    diag_bits_t: torch.Tensor, hot_bits_t: torch.Tensor, x: torch.Tensor,
    x_hot: torch.Tensor, diag_b: int,
) -> torch.Tensor:
    """out[R, D] = blockdiag(diag)^T @ x + hot^T @ x_hot, one row pass."""
    b = _check_bits("diag_bits_t", diag_bits_t)
    k = _check_bits("hot_bits_t", hot_bits_t)
    _check_features("x", x)
    _check_features("x_hot", x_hot)
    r = diag_bits_t.shape[1]
    if (
        b != diag_b or hot_bits_t.shape[1] != r or x.shape[0] != r
        or r % b or x_hot.shape[0] != k or x_hot.shape[1] != x.shape[1]
        or x_hot.dtype != x.dtype
    ):
        raise ValueError(
            f"fused slabs: diag K {b} (diag_b {diag_b}), hot K {k}, rows "
            f"{r}/{hot_bits_t.shape[1]}, x {tuple(x.shape)} {x.dtype}, "
            f"x_hot {tuple(x_hot.shape)} {x_hot.dtype}"
        )
    if _on_cpu(diag_bits_t, hot_bits_t, x, x_hot):
        return fused_slab_matmul_plain(diag_bits_t, hot_bits_t, x, x_hot, diag_b)
    _check_stream(r)
    return _fused_slab_matmul_cuda(diag_bits_t, hot_bits_t, x, x_hot, diag_b)


def _fused_slab_matmul_cuda(diag_bits_t, hot_bits_t, x, x_hot, diag_b):
    r, d = diag_bits_t.shape[1], x.shape[1]
    width = _table_width(d)
    diag_table = _row_table(x, width)
    hot_table = _row_table(x_hot, width)
    out = torch.empty((r, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().gnna_fused_slab_matmul(
            diag_bits_t.data_ptr(), diag_bits_t.shape[0], diag_b,
            diag_table.data_ptr(), hot_bits_t.data_ptr(), hot_bits_t.shape[0],
            hot_table.data_ptr(), r, d, width,
            int(x.dtype == torch.bfloat16), 0, out.data_ptr(),
            _stream(x.device),
        )
    _build.check("fused_slab_matmul", rc)
    launches["fused_slab_matmul"] += 1
    return out


def residual_combine(
    x: torch.Tensor, res_src: torch.Tensor, res_mask: torch.Tensor,
    t2b: torch.Tensor, block_ptr: torch.Tensor, num_rows: int, res_ob: int,
    addend: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[num_rows, D] f32: residual-tier combine, features row-major,
    with the slot gather and, given ``addend``, the tier sum in the kernel.

    ``x`` [rows, D] the gather source; ``res_src`` int32 [T·S], the row of
    x each slot reads (every id, pad slots included, a row of x: another
    id raises, at once on the CPU and on the card as a device-side assert
    at the next synchronisation, as ``index_select`` does);
    ``res_mask`` uint32 [OB/32, T·S]; ``t2b`` int32 [T] tile -> out block,
    sorted ascending; ``block_ptr`` int32 [num_rows/OB + 1], the tile
    range of each block; ``addend`` None or f32 [num_rows, D], added to
    the tier's sum (``addend + out``).  Blocks with no tile come out as
    zeros (as ``addend``).  ``x = rows`` with ``res_src = arange(T·S)`` is
    the combine of gathered rows."""
    _check_features("x", x)
    _check_index("res_src", res_src)
    if res_mask.dtype != torch.uint32 or res_mask.dim() != 2:
        raise ValueError(f"res_mask must be a 2-D uint32 tensor, got "
                         f"{res_mask.dtype} {tuple(res_mask.shape)}")
    if not res_mask.is_contiguous():
        raise ValueError("res_mask must be contiguous")
    _check_index("t2b", t2b)
    _check_index("block_ptr", block_ptr)
    t, m_pad = t2b.shape[0], res_src.shape[0]
    if (
        res_ob <= 0 or num_rows % res_ob or t == 0 or m_pad % t
        or tuple(res_mask.shape) != (res_ob // 32, m_pad) or res_ob % 32
        or block_ptr.shape[0] != num_rows // res_ob + 1
    ):
        raise ValueError(
            f"residual stream: {t} tiles, res_src {tuple(res_src.shape)}, "
            f"mask {tuple(res_mask.shape)}, block_ptr "
            f"{tuple(block_ptr.shape)}, num_rows {num_rows}, res_ob {res_ob}"
        )
    if addend is not None and (
        addend.dtype != torch.float32
        or tuple(addend.shape) != (num_rows, x.shape[1])
        or not addend.is_contiguous()
    ):
        raise ValueError(
            f"addend must be a contiguous float32 [{num_rows}, {x.shape[1]}] "
            f"tensor, got {addend.dtype} {tuple(addend.shape)}"
        )
    operands = (x, res_src, res_mask, t2b, block_ptr) + (
        () if addend is None else (addend,))
    if _on_cpu(*operands):
        # the ids are checked here; on the card the kernel asserts each id
        # it reads (a check here would wait for the card)
        if m_pad and (int(res_src.min()) < 0
                      or int(res_src.max()) >= x.shape[0]):
            raise ValueError(f"res_src holds ids outside x's {x.shape[0]} "
                             "rows")
        return residual_combine_plain(x, res_src, res_mask, t2b, block_ptr,
                                      num_rows, res_ob, addend)
    s = m_pad // t
    if s > MAX_RES_TILE or s % 4:
        raise ValueError(f"residual tile of {s} slots: the kernel takes a "
                         f"multiple of 4 up to {MAX_RES_TILE}")
    return _residual_combine_cuda(x, res_src, res_mask, block_ptr, t,
                                  num_rows, addend)


def _gather_table(x: torch.Tensor) -> torch.Tensor:
    """x with rows of a multiple of 16 bytes (the kernel copies 16-byte
    pieces): x itself when they already are, else a zero-padded copy."""
    return _row_table(x, _round_up(x.shape[1], 16 // x.element_size()))


def _residual_combine_cuda(x, res_src, res_mask, block_ptr, t, num_rows,
                           addend):
    d = x.shape[1]
    table = _gather_table(x)
    out = torch.empty((num_rows, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().gnna_residual_combine(
            res_mask.data_ptr(), res_mask.shape[0], t,
            res_src.shape[0] // t, table.data_ptr(), x.shape[0],
            table.shape[1],
            res_src.data_ptr(), d, block_ptr.data_ptr(), num_rows,
            None if addend is None else addend.data_ptr(),
            int(x.dtype == torch.bfloat16), out.data_ptr(),
            _stream(x.device),
        )
    _build.check("residual_combine", rc)
    launches["residual_combine"] += 1
    return out
