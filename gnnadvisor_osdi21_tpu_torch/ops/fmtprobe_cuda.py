"""The format probe's four kernels, their plain versions and their launch
counts.

TPU kernels replaced (``gnnadvisor_osdi21_tpu/bench/fmtprobe.py``):

- ``_sum_kernel`` (fmtprobe.py:53, ``pallas_call`` at :63, wrapper
  ``stream``): each ``[block, K]`` row block of an int8, f32 or uint32
  ``[R, K]`` array summed to one f32, plus ``s [8, 128]``: one ``[8, 128]``
  tile per block (``stream_sum``, ``csrc/fmt_probe.cu``).  uint32 words
  count as int32, as there (``astype(int32)`` before f32), so words of
  2^31 or more are negative;
- ``_i8_kernel`` (:118, call :124, ``slab``): ``out[R, D] = bf16(A) @
  bf16(x)``, A int8 ``[R, K]`` (``i8_slab``).  It runs on a ring of
  tensor-map boxes in ``csrc/dense_slab.cu``, beside the other probes'
  dense slabs;
- ``mk_slab.kern`` (:216, call :235): ``out[R, D] = unpack(bits) @ x`` from
  the row-major uint32 bit slab ``[R, K/32]``, column j in word
  ``j % (K/32)`` at bit ``j // (K/32)`` (``graphs.hybrid.pack_slab_bits``);
  bf16 x is ``base_bf16``, f32 x ``mul_f32dot`` (``bit_slab``).  It runs in
  ``csrc/bit_walk.cu``, a walk over the set bits: the slab streams in as
  boxes of a 2-D tensor map, and the walk adds the feature rows of the set
  bits in f32 (no TF32), so the two variants differ only in the table's
  dtype.  Its launches count as ``bit_slab`` (bf16) and ``bit_slab_f32``;
- ``_seg_kernel`` (:287, call :335, ``segred``): the one-hot segment reduce
  (``seg_reduce``, ``csrc/fmt_probe.cu``): persistent blocks of threads
  stream the slots through a ring of 64-slot stages.

As in ``probe_cuda``: each wrapper checks device, dtype, shape and
contiguity, runs the plain version for CPU tensors only, and for CUDA
tensors launches its kernel or raises; ``launches`` counts the kernel
launches.  The slab kernels and the segment reduce compute 16 features
(the probe's ``--dim``); ``block_rows`` is the TPU grid step's rows (512
or 1024), a multiple of 256: ``i8_slab`` and ``bit_slab`` check it and size
their own tiles, so every ``block_rows`` gives the same result.

Where the TPU kernel leaves output unwritten, the port defines it: the
slab kernels write every row (the TPU grid covers ``R // block`` blocks),
and ``seg_reduce`` writes zeros into blocks that no tile maps to.
"""

from __future__ import annotations

import torch

from gnnadvisor_osdi21_tpu_torch.ops import _build
from gnnadvisor_osdi21_tpu_torch.ops.probe_cuda import FEATURES, _check_2d
from gnnadvisor_osdi21_tpu_torch.ops.spmm_cuda import _on_cpu, _stream

KERNELS = ("stream_sum", "i8_slab", "bit_slab", "seg_reduce")
# kernel name -> launches since the last reset_launches(); bit_slab counts
# its bf16 variant, and its f32 variant (mul_f32dot) counts apart
BIT_SLAB_F32 = "bit_slab_f32"
launches = dict.fromkeys(KERNELS + (BIT_SLAB_F32,), 0)

LANES = 128  # the segment reduce's value lanes (one TPU vreg row)
STRIP = 256  # block_rows must be a multiple (as the TPU grid steps, 512, 1024)
SEG_OBS = (128, 256, 512)  # output-block rows the CUDA segment reduce takes
FRAG_BYTES = 512  # i8_slab's feature fragments: bytes per 16 slab columns
# the CUDA launch shapes, as the probe script's lines name them
I8_BLOCK = "the ring's own (persistent, 160 thr, 64-row tiles)"
SEG_BLOCK = "the ring's own (persistent, 288 thr, 64-slot stages)"
PLAIN_ROWS = 1 << 16  # rows per piece of the plain slab products
_SUM_SRC = {torch.int8: 0, torch.float32: 1, torch.uint32: 2}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def unpack_rows32(bits: torch.Tensor) -> torch.Tensor:
    """uint32 ``[R, W32]`` row-major words -> f32 0/1 ``[R, 32·W32]``:
    column j is word ``j % W32``, bit ``j // W32``."""
    w32 = bits.shape[1]
    j = torch.arange(w32 * 32, device=bits.device)
    # an arithmetic shift keeps bit k of the word at bit 0
    words = bits.view(torch.int32)
    return ((words[:, j % w32] >> (j // w32).to(torch.int32)) & 1).to(
        torch.float32)


def _by_rows(fn, n: int) -> torch.Tensor:
    """``fn(rows)`` over row pieces of PLAIN_ROWS, concatenated: keeps the
    plain products' [rows, K] f32 temporaries small at the full R."""
    return torch.cat([fn(slice(i, min(i + PLAIN_ROWS, n)))
                      for i in range(0, n, PLAIN_ROWS)])


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def stream_sum_plain(a: torch.Tensor, s: torch.Tensor,
                     block: int = 512) -> torch.Tensor:
    """out[8·g, 128] f32, g = R // block: block i's sum (in f64, rounded
    to f32 once) plus s."""
    g, k = a.shape[0] // block, a.shape[1]
    words = a.view(torch.int32) if a.dtype == torch.uint32 else a
    total = torch.sum(words[: g * block].reshape(g, block * k), dim=1,
                      dtype=torch.float64).to(torch.float32)
    return (total[:, None, None] + s[None]).reshape(g * 8, 128)


def i8_slab_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[R, D] f32 = A @ bf16(x), A's int8 values exact in f32."""
    xf = x.to(torch.bfloat16).to(torch.float32)
    return _by_rows(lambda rows: a[rows].to(torch.float32) @ xf, a.shape[0])


def bit_slab_plain(bits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[R, D] f32 = unpack(bits) @ x (x's own values, bf16 or f32)."""
    xf = x.to(torch.float32)
    return _by_rows(lambda rows: unpack_rows32(bits[rows]) @ xf, bits.shape[0])


def seg_fold(vals: torch.Tensor, masks: torch.Tensor,
             d: int = FEATURES) -> torch.Tensor:
    """The segment reduce's per-slot values, [m, d] f32 (bf16-valued):
    ``vals`` lane l kept where bit ``l // d`` of the slot's mask is set,
    rounded to bf16, the 128 lanes folded to d by an f32 sum of the lanes
    ``l % d``, rounded to bf16."""
    m = vals.shape[0]
    group = (torch.arange(LANES, device=vals.device) // d).to(torch.int32)
    keep = ((masks.view(torch.int32) >> group[None, :]) & 1).to(torch.float32)
    vm = (vals * keep).to(torch.bfloat16).to(torch.float32)
    return vm.view(m, LANES // d, d).sum(1).to(torch.bfloat16).to(torch.float32)


def seg_reduce_plain(vals, masks, segs, t2b, first, s, tile: int, ob: int,
                     n_blocks: int, d: int = FEATURES) -> torch.Tensor:
    """out[n_blocks·ob, d] f32: per tile t, ``part[o] = sum of seg_fold
    over the tile's slots with seg == o, + s[0, 0]``, written into block
    ``t2b[t]`` where ``first[t] == 1`` and added to it otherwise, tiles in
    order; blocks no tile maps to are zeros."""
    n_tiles = t2b.shape[0]
    v = seg_fold(vals, masks, d).view(n_tiles, tile, d)
    onehot = (segs.view(n_tiles, tile, 1)
              == torch.arange(ob, device=vals.device)).to(torch.float32)
    part = torch.bmm(onehot.transpose(1, 2), v) + s[0, 0]  # [T, ob, d]
    out = torch.zeros((n_blocks, ob, d), dtype=torch.float32,
                      device=vals.device)
    for t, (b, f) in enumerate(zip(t2b.tolist(), first.tolist())):
        out[b] = part[t] if f == 1 else out[b] + part[t]
    return out.view(n_blocks * ob, d)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------


def _aligned(*tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("operands must be 16-byte aligned")


def _check_block_rows(block_rows: int) -> None:
    if block_rows <= 0 or block_rows % STRIP:
        raise ValueError(f"block_rows {block_rows} must be a positive "
                         f"multiple of {STRIP}")


def _check_table(x: torch.Tensor, k: int) -> None:
    _check_2d("x", x, (torch.bfloat16, torch.float32))
    if x.shape[0] != k:
        raise ValueError(f"x has {x.shape[0]} rows, the slab K {k}")


def stream_sum(a: torch.Tensor, s: torch.Tensor,
               block: int = 512) -> torch.Tensor:
    """out[8·(R // block), 128] f32: each row block's sum plus ``s``;
    ``a`` int8, f32 or uint32 [R, K], ``s`` f32 [8, 128]."""
    _check_2d("a", a, tuple(_SUM_SRC))
    _check_2d("s", s, (torch.float32,))
    if tuple(s.shape) != (8, 128):
        raise ValueError(f"s must be [8, 128], got {tuple(s.shape)}")
    if block <= 0 or a.shape[0] < block:
        raise ValueError(f"block {block} must be in 1..R ({a.shape[0]})")
    if _on_cpu(a, s):
        return stream_sum_plain(a, s, block)
    if block * a.shape[1] * a.element_size() % 16:
        raise ValueError("a row block must be a multiple of 16 bytes")
    _aligned(a, s)
    return _stream_sum_cuda(a, s, block)


def _stream_sum_cuda(a, s, block: int) -> torch.Tensor:
    g = a.shape[0] // block
    out = torch.empty((g * 8, 128), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = _build.library().gnna_stream_sum(
            a.data_ptr(), _SUM_SRC[a.dtype], g,
            block * a.shape[1] * a.element_size(),
            s.data_ptr(), out.data_ptr(), _stream(a.device),
        )
    _build.check("stream_sum", rc)
    launches["stream_sum"] += 1
    return out


def i8_slab(a: torch.Tensor, x: torch.Tensor,
            block_rows: int = 512) -> torch.Tensor:
    """out[R, D] f32 = bf16(a) @ bf16(x); ``a`` int8 [R, K], ``x`` f32 or
    bf16 [K, D] (rounded to bf16, as the TPU probe casts it)."""
    _check_2d("a", a, (torch.int8,))
    r, k = a.shape
    _check_table(x, k)
    if _on_cpu(a, x):
        return i8_slab_plain(a, x)
    if x.shape[1] != FEATURES or k % 64 or k == 0:
        raise ValueError(f"i8_slab takes {FEATURES} features and K a "
                         f"multiple of 64; got D={x.shape[1]}, K={k}")
    _check_block_rows(block_rows)
    x16 = x.to(torch.bfloat16)
    _aligned(a, x16)
    return _i8_slab_cuda(a, x16, block_rows)


def _i8_slab_cuda(a, x16, block_rows: int) -> torch.Tensor:
    r, k = a.shape
    out = torch.empty((r, FEATURES), dtype=torch.float32, device=a.device)
    frags = torch.empty(k // 16 * FRAG_BYTES, dtype=torch.uint8,
                        device=a.device)
    with torch.cuda.device(a.device):
        rc = _build.library().gnna_i8_slab(
            a.data_ptr(), r, k, x16.data_ptr(), block_rows, frags.data_ptr(),
            out.data_ptr(), _stream(a.device),
        )
    _build.check("i8_slab", rc)
    launches["i8_slab"] += 1
    return out


def bit_slab(bits: torch.Tensor, x: torch.Tensor,
             block_rows: int = 512) -> torch.Tensor:
    """out[R, D] f32 = unpack(bits) @ x; ``bits`` uint32 [R, K/32] (the
    legacy row-major order), ``x`` [K, D]: bf16 (``base_bf16``) or f32
    (``mul_f32dot``).  ``block_rows`` is checked, and does not change the
    CUDA launch."""
    _check_2d("bits", bits, (torch.uint32,))
    r, w32 = bits.shape
    _check_table(x, 32 * w32)
    if _on_cpu(bits, x):
        return bit_slab_plain(bits, x)
    if x.shape[1] != FEATURES or w32 % 4 or w32 == 0:
        raise ValueError(f"bit_slab takes {FEATURES} features and K a "
                         f"multiple of 128; got D={x.shape[1]}, K={32 * w32}")
    _check_block_rows(block_rows)
    _aligned(bits, x)
    return _bit_slab_cuda(bits, x, block_rows)


def _bit_slab_cuda(bits, x, block_rows: int) -> torch.Tensor:
    r, w32 = bits.shape
    out = torch.empty((r, FEATURES), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().gnna_bit_slab(
            bits.data_ptr(), r, w32, x.data_ptr(),
            int(x.dtype == torch.float32), block_rows, out.data_ptr(),
            _stream(x.device),
        )
    _build.check("bit_slab", rc)
    launches[BIT_SLAB_F32 if x.dtype == torch.float32 else "bit_slab"] += 1
    return out


def seg_reduce(vals: torch.Tensor, masks: torch.Tensor, segs: torch.Tensor,
               t2b: torch.Tensor, first: torch.Tensor, s: torch.Tensor,
               tile: int, ob: int, n_blocks: int) -> torch.Tensor:
    """out[n_blocks·ob, 16] f32, the one-hot segment reduce (see
    ``seg_reduce_plain``).  ``vals`` f32 [T·tile, 128], ``masks`` uint32
    and ``segs`` int32 [T·tile, 1], ``t2b`` and ``first`` int32 [T], ``s``
    f32 [8, 128].  On the card ``t2b`` must be sorted (each block's tiles
    contiguous, walked in order), ``vals``, ``masks`` and ``segs`` 16-byte
    aligned (bulk copies), and ``segs`` are fastest sorted within a
    tile."""
    _check_2d("vals", vals, (torch.float32,))
    _check_2d("masks", masks, (torch.uint32,))
    _check_2d("segs", segs, (torch.int32,))
    _check_2d("s", s, (torch.float32,))
    for name, t in (("t2b", t2b), ("first", first)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
    n_tiles = t2b.shape[0]
    m = n_tiles * tile
    if (vals.shape != (m, LANES) or masks.shape != (m, 1)
            or segs.shape != (m, 1) or first.shape != (n_tiles,)):
        raise ValueError(f"{n_tiles} tiles of {tile} slots: vals [{m}, "
                         f"{LANES}], masks and segs [{m}, 1], first "
                         f"[{n_tiles}]")
    if _on_cpu(vals, masks, segs, t2b, first, s):
        return seg_reduce_plain(vals, masks, segs, t2b, first, s, tile, ob,
                                n_blocks)
    if ob not in SEG_OBS or tile % 16 or tile <= 0:
        raise ValueError(f"seg_reduce takes ob in {SEG_OBS} and a tile that "
                         f"is a positive multiple of 16; got "
                         f"ob={ob}, tile={tile}")
    if n_blocks <= 0:
        raise ValueError(f"n_blocks {n_blocks} must be positive")
    _aligned(vals, masks, segs)
    return _seg_reduce_cuda(vals, masks, segs, t2b, first, s, tile, ob,
                            n_blocks)


def _seg_reduce_cuda(vals, masks, segs, t2b, first, s, tile: int, ob: int,
                     n_blocks: int) -> torch.Tensor:
    out = torch.empty((n_blocks * ob, FEATURES), dtype=torch.float32,
                      device=vals.device)
    with torch.cuda.device(vals.device):
        rc = _build.library().gnna_seg_reduce(
            vals.data_ptr(), masks.data_ptr(), segs.data_ptr(),
            t2b.data_ptr(), first.data_ptr(), t2b.shape[0], tile, ob,
            n_blocks, s.data_ptr(), out.data_ptr(), _stream(vals.device),
        )
    _build.check("seg_reduce", rc)
    launches["seg_reduce"] += 1
    return out
