"""The attention kernels (``csrc/gat.cu``), their plain versions and their
launch counts.

GAT's edges carry values: alpha, one per edge and head.  Four kernels
compute with them over the attention layout (``graphs/gat.py``, here as
``Walk``s on the device):

- ``edge_softmax``: alpha = the softmax over each row-owner row's edges
  of LeakyReLU(s_src[s] + s_dst[d]), per head (``gat::``);
- ``aggregate``: out[r] = sum over row r's edges of alpha * table[idx],
  per head, in either order: the forward in row-owner order, the
  backward's adjoint in transposed order with alpha read through the
  permutation (``gnna::``, beside the hybrid layout's aggregation
  kernels);
- ``sddmm``: the backward's dalpha = dout[s] . table[d] per edge and
  head, the softmax's backward and the LeakyReLU's, and their row sums
  (``gat::``);
- ``col_reduce``: the logits' gradient summed over each transposed row
  (``gat::``).

Each has a plain PyTorch version (``*_plain``) of the same arithmetic in
float32, which the wrapper runs for CPU tensors (the CPU tests), and which
chip_smoke.py holds the kernel against on the card; for CUDA tensors the
wrapper launches the kernel or raises.  The plain versions of the chunked
kernels sum the same chunks and partial rows as the kernels, so that the
CPU tests reach the chunk arrays too.  The softmax and the aggregation
sum each row in edge order, each product rounded, as the plain versions
(``torch.segment_reduce``) do: where no row is split their bits are the
plain versions'.  Launches count in ``launches`` (the span store's
counters ``launches.<kernel>``).

The gathered operand is a table [rows, K * PH * 8] in the configured
operand dtype, each head's F features padded with zeros to PH * 8 = F
rounded up to 8 (``operand_table``).  Heads: K divides 32, and K * PH is
at most 32 (one 16-byte piece a lane).  The kernels take float32 values
and a bfloat16 or float32 table; the plain versions, on the CPU, also
float64 values and table throughout (for ``gradcheck``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnnadvisor_osdi21_tpu_torch.ops import _build
from gnnadvisor_osdi21_tpu_torch.ops.aggregate import _segment_sum
from gnnadvisor_osdi21_tpu_torch.ops.spmm_cuda import _on_cpu, _stream
from gnnadvisor_osdi21_tpu_torch.utils import profiling

KERNELS = ("gat_softmax", "gat_aggregate", "gat_sddmm", "gat_col_reduce")
# kernel name -> launches: the span store's counters ``launches.<kernel>``
launches = profiling.CounterView("launches.", KERNELS)
OPERAND_DTYPES = (torch.float32, torch.bfloat16)
# the values' dtypes: the kernels', and the plain versions' on the CPU
VALUE_DTYPES = {"cuda": (torch.float32,),
                "cpu": (torch.float32, torch.float64)}


def reset_launches() -> None:
    launches.update(dict.fromkeys(launches, 0))


@dataclasses.dataclass
class Walk:
    """One order of the attention edges on a device (``graphs/gat.EdgeWalk``,
    int32 tensors): ``ptr``, ``idx``, ``pos`` (None in row-owner order),
    the chunks and the fix-up rows."""

    ptr: torch.Tensor
    idx: torch.Tensor
    pos: torch.Tensor | None
    chunk_lo: torch.Tensor
    chunk_hi: torch.Tensor
    chunk_dst: torch.Tensor
    fix_row: torch.Tensor
    fix_ptr: torch.Tensor
    num_partials: int

    @classmethod
    def of(cls, walk, device) -> "Walk":
        def t(a):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.int32)).to(device)

        return cls(t(walk.ptr), t(walk.idx), t(walk.pos), t(walk.chunk_lo),
                   t(walk.chunk_hi), t(walk.chunk_dst), t(walk.fix_row),
                   t(walk.fix_ptr), walk.num_partials)

    @property
    def num_rows(self) -> int:
        return self.ptr.numel() - 1

    @property
    def num_edges(self) -> int:
        return self.idx.numel()

    def tensors(self) -> list[torch.Tensor]:
        return [t for t in (self.ptr, self.idx, self.pos, self.chunk_lo,
                            self.chunk_hi, self.chunk_dst, self.fix_row,
                            self.fix_ptr) if t is not None]


def pieces(f: int) -> int:
    """16-byte pieces (8 values) a head of ``f`` features takes."""
    return -(-f // 8)


def _check_heads(k: int, f: int | None = None) -> None:
    if k <= 0 or 32 % k:
        raise ValueError(f"{k} heads: the attention kernels take a divisor "
                         "of 32")
    if f is not None and (f <= 0 or k * pieces(f) > 32):
        raise ValueError(f"{k} heads of {f} features: the attention kernels "
                         "take at most 32 pieces of 8 features a row")


def operand_table(v: torch.Tensor, k: int, f: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """v [n, k*f] as the gathered operand: [n, k * pieces(f) * 8] in
    ``dtype``, each head's f features then zeros."""
    n = v.shape[0]
    fp = pieces(f) * 8
    if fp == f:
        return v.to(dtype).contiguous()
    table = torch.empty((n, k, fp), dtype=dtype, device=v.device)
    table[:, :, :f] = v.view(n, k, f)
    table[:, :, f:] = 0
    return table.view(n, k * fp)


def _check_table(table: torch.Tensor, k: int, f: int) -> None:
    dtypes = OPERAND_DTYPES + VALUE_DTYPES[table.device.type][1:]
    if (table.dtype not in dtypes or table.dim() != 2
            or not table.is_contiguous()
            or table.shape[1] != k * pieces(f) * 8):
        raise ValueError(f"the operand table must be a contiguous [rows, "
                         f"{k * pieces(f) * 8}] tensor of one of {dtypes}, "
                         f"got {table.dtype} {tuple(table.shape)}")


def _check_values(name: str, t: torch.Tensor, shape: tuple) -> None:
    dtypes = VALUE_DTYPES.get(t.device.type, ())
    if t.dtype not in dtypes or tuple(t.shape) != shape or \
            not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} tensor of one "
                         f"of {dtypes}, got {t.dtype} {tuple(t.shape)}")


def _rows_of(ptr: torch.Tensor) -> torch.Tensor:
    """Each edge's row, from row pointers."""
    counts = (ptr[1:] - ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=ptr.device), counts)


def _head_values(table: torch.Tensor, k: int, f: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """The table's rows as [rows, k, f] in ``dtype``, padding dropped."""
    return table.view(table.shape[0], k, -1)[:, :, :f].to(dtype)


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def edge_softmax_plain(ptr, col, s_src, s_dst, slope: float) -> torch.Tensor:
    """alpha [E, K]: per row-owner row s and head, the softmax over the
    row's edges (s, d) of leaky_relu(s_src[s] + s_dst[d], slope)."""
    rows = _rows_of(ptr)
    e = torch.nn.functional.leaky_relu(
        s_src[rows] + s_dst[col.long()], slope)
    m = torch.segment_reduce(e, "max", offsets=ptr.long(), axis=0,
                             unsafe=True)
    p = torch.exp(e - m[rows])
    return p / _segment_sum(p, ptr.long())[rows]


def _chunked(vals: torch.Tensor, walk: Walk) -> torch.Tensor:
    """Row sums of per-edge ``vals`` [E, ...] over ``walk``'s rows, taken as
    the kernels take them: a sum a chunk, into its row or its partial row,
    then each split row's partials in order."""
    lo = walk.chunk_lo.long()
    # chunks in edge order (an empty row's chunk before the next one)
    order = torch.argsort(lo * (walk.num_edges + 1) + walk.chunk_hi.long())
    bounds = torch.cat([lo[order], walk.ptr[-1:].long()])
    sums = torch.empty((order.numel(),) + vals.shape[1:], dtype=vals.dtype,
                       device=vals.device)
    sums[order] = _segment_sum(vals, bounds)
    out = torch.zeros((walk.num_rows,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    dst = walk.chunk_dst.long()
    whole = dst >= 0
    out[dst[whole]] = sums[whole]
    if walk.num_partials:
        partial = torch.empty((walk.num_partials,) + vals.shape[1:],
                              dtype=vals.dtype, device=vals.device)
        partial[-1 - dst[~whole]] = sums[~whole]
        out[walk.fix_row.long()] = _segment_sum(partial, walk.fix_ptr.long())
    return out


def aggregate_plain(table: torch.Tensor, k: int, f: int, walk: Walk,
                    alpha: torch.Tensor) -> torch.Tensor:
    """out [rows, k*f] f32: row r = sum over its edges e of alpha[pos[e]]
    times table[idx[e]], per head (pos: the edge itself when None)."""
    a = alpha if walk.pos is None else alpha[walk.pos.long()]
    vals = a[:, :, None] * _head_values(table, k, f, a.dtype)[
        walk.idx.long()]
    return _chunked(vals.reshape(vals.shape[0], k * f), walk)


def sddmm_plain(ptr, col, table, k: int, f: int, dy, out, alpha, s_src,
                s_dst, slope: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(de [E, K], ds [n, K]): per row-owner edge e = (s, d) and head,
    dalpha = dy[s] . table[d], de = alpha (dalpha - dy[s] . out[s]) times
    the LeakyReLU's slope where s_src[s] + s_dst[d] <= 0, and ds[s] = the
    sum of de over row s."""
    n = ptr.numel() - 1
    rows = _rows_of(ptr)
    dyh = dy.view(n, k, f)
    dalpha = (dyh[rows]
              * _head_values(table, k, f, dy.dtype)[col.long()]).sum(-1)
    c = (dyh * out.view(n, k, f)).sum(-1)
    de = alpha * (dalpha - c[rows])
    pre = s_src[rows] + s_dst[col.long()]
    de = torch.where(pre > 0, de, slope * de)
    return de, _segment_sum(de, ptr.long())


def col_reduce_plain(de: torch.Tensor, walk: Walk) -> torch.Tensor:
    """[rows, K]: each transposed row's sum of de[pos[e]]."""
    return _chunked(de[walk.pos.long()], walk)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------


def edge_softmax(ptr: torch.Tensor, col: torch.Tensor, s_src: torch.Tensor,
                 s_dst: torch.Tensor, slope: float) -> torch.Tensor:
    """alpha [E, K] f32 (``edge_softmax_plain``); ptr [n+1] and col [E]
    int32, s_src and s_dst [n, K] f32."""
    n, k = s_src.shape
    _check_heads(k)
    _check_values("s_src", s_src, (n, k))
    _check_values("s_dst", s_dst, (n, k))
    if _on_cpu(ptr, col, s_src, s_dst):
        return edge_softmax_plain(ptr, col, s_src, s_dst, slope)
    return _edge_softmax_cuda(ptr, col, s_src, s_dst, slope)


def _edge_softmax_cuda(ptr, col, s_src, s_dst, slope: float) -> torch.Tensor:
    n, k = s_src.shape
    alpha = torch.empty((col.numel(), k), dtype=torch.float32,
                        device=s_src.device)
    with torch.cuda.device(s_src.device):
        rc = _build.library().gnna_gat_softmax(
            ptr.data_ptr(), col.data_ptr(), s_src.data_ptr(),
            s_dst.data_ptr(), n, k, float(slope), alpha.data_ptr(),
            _stream(s_src.device))
    _build.check("gat_softmax", rc)
    launches["gat_softmax"] += 1
    return alpha


def aggregate(table: torch.Tensor, k: int, f: int, walk: Walk,
              alpha: torch.Tensor) -> torch.Tensor:
    """out [walk's rows, k*f] f32 (``aggregate_plain``); table from
    ``operand_table``, alpha [E, K] f32 in row-owner order."""
    _check_heads(k, f)
    _check_table(table, k, f)
    _check_values("alpha", alpha, (walk.num_edges, k))
    if _on_cpu(table, alpha, *walk.tensors()):
        return aggregate_plain(table, k, f, walk, alpha)
    return _aggregate_cuda(table, k, f, walk, alpha)


def _aggregate_cuda(table, k: int, f: int, walk: Walk, alpha) -> torch.Tensor:
    dev = table.device
    out = torch.empty((walk.num_rows, k * f), dtype=torch.float32, device=dev)
    partial = torch.empty((walk.num_partials, k * f), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().gnna_gat_aggregate(
            table.data_ptr(), table.shape[1],
            int(table.dtype == torch.bfloat16), k, f, pieces(f),
            walk.idx.data_ptr(), 0 if walk.pos is None else walk.pos.data_ptr(),
            alpha.data_ptr(), walk.chunk_lo.data_ptr(),
            walk.chunk_hi.data_ptr(), walk.chunk_dst.data_ptr(),
            walk.chunk_lo.numel(), walk.fix_row.data_ptr(),
            walk.fix_ptr.data_ptr(), walk.fix_row.numel(),
            partial.data_ptr(), out.data_ptr(), _stream(dev))
    _build.check("gat_aggregate", rc)
    launches["gat_aggregate"] += 1
    return out


def sddmm(ptr: torch.Tensor, col: torch.Tensor, table: torch.Tensor, k: int,
          f: int, dy: torch.Tensor, out: torch.Tensor, alpha: torch.Tensor,
          s_src: torch.Tensor, s_dst: torch.Tensor,
          slope: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(de [E, K], ds [n, K]) f32 (``sddmm_plain``), over the row-owner
    order; dy and out [n, k*f] f32."""
    n = ptr.numel() - 1
    _check_heads(k, f)
    _check_table(table, k, f)
    for name, t in (("dy", dy), ("out", out)):
        _check_values(name, t, (n, k * f))
    _check_values("alpha", alpha, (col.numel(), k))
    _check_values("s_src", s_src, (n, k))
    _check_values("s_dst", s_dst, (n, k))
    if _on_cpu(ptr, col, table, dy, out, alpha, s_src, s_dst):
        return sddmm_plain(ptr, col, table, k, f, dy, out, alpha, s_src,
                           s_dst, slope)
    return _sddmm_cuda(ptr, col, table, k, f, dy, out, alpha, s_src, s_dst,
                       slope)


def _sddmm_cuda(ptr, col, table, k: int, f: int, dy, out, alpha, s_src,
                s_dst, slope: float) -> tuple[torch.Tensor, torch.Tensor]:
    n = ptr.numel() - 1
    dev = table.device
    de = torch.empty_like(alpha)
    ds = torch.empty((n, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().gnna_gat_sddmm(
            ptr.data_ptr(), col.data_ptr(), n, table.data_ptr(),
            table.shape[1], int(table.dtype == torch.bfloat16), k, f,
            pieces(f), dy.data_ptr(), out.data_ptr(), alpha.data_ptr(),
            s_src.data_ptr(), s_dst.data_ptr(), float(slope), de.data_ptr(),
            ds.data_ptr(), _stream(dev))
    _build.check("gat_sddmm", rc)
    launches["gat_sddmm"] += 1
    return de, ds


def col_reduce(de: torch.Tensor, walk: Walk) -> torch.Tensor:
    """[walk's rows, K] f32 (``col_reduce_plain``); de [E, K] f32 in
    row-owner order, ``walk`` the transposed order."""
    k = de.shape[1]
    _check_heads(k)
    _check_values("de", de, (walk.num_edges, k))
    if walk.pos is None:
        raise ValueError("col_reduce walks the transposed order")
    if _on_cpu(de, *walk.tensors()):
        return col_reduce_plain(de, walk)
    return _col_reduce_cuda(de, walk)


def _col_reduce_cuda(de, walk: Walk) -> torch.Tensor:
    k = de.shape[1]
    dev = de.device
    out = torch.empty((walk.num_rows, k), dtype=torch.float32, device=dev)
    partial = torch.empty((walk.num_partials, k), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().gnna_gat_col_reduce(
            de.data_ptr(), walk.pos.data_ptr(), k, walk.chunk_lo.data_ptr(),
            walk.chunk_hi.data_ptr(), walk.chunk_dst.data_ptr(),
            walk.chunk_lo.numel(), walk.fix_row.data_ptr(),
            walk.fix_ptr.data_ptr(), walk.fix_row.numel(),
            partial.data_ptr(), out.data_ptr(), _stream(dev))
    _build.check("gat_col_reduce", rc)
    launches["gat_col_reduce"] += 1
    return out
