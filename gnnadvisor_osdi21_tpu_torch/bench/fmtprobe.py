"""Format probes for the hybrid layout's kernel design: the port of
``gnnadvisor_osdi21_tpu/bench/fmtprobe.py``.

Measures on the card the primitives the layout composes from:

1. ``stream``: the streaming read-reduce ceiling (``fmtprobe_cuda.
   stream_sum`` over an int8, f32 and uint32 ``[R, K]`` array);
2. ``slab``: the hot-slab product over a bit slab (``spmm_cuda.
   slab_matmul``) against a dense int8 slab (``fmtprobe_cuda.i8_slab``);
3. ``gather``: the row gather at residual scale (``index_select``);
   ``xlares``: the residual pipeline in plain torch ops (gather, mask
   fold, batched one-hot product, segment sum), the JAX script's XLA-only
   section;
   ``slabvar``: the row-major uint32 bit slab with bf16 and f32 features
   (``fmtprobe_cuda.bit_slab``, a walk over the set bits);
4. ``segred``: the one-hot segment reduce (``fmtprobe_cuda.seg_reduce``).

The same arguments, sections, order, shapes, seeds and line formats as the
JAX script: one ``np.random.default_rng(0)`` is drawn in its order, so
``--only`` selects the same data.  Each line appends the host's wall time
to issue one call (``utils.timing``) and the CUDA block shape.  The JAX
script adds a scalar of the chained input to an operand so that XLA cannot
hoist the call; eager PyTorch does not hoist, so the calls take the
operands as they are, and the feature tables are cast to bf16 once, outside
the timed call.  Below the default ``--rows`` the script's fixed slot
counts (m) shrink with R, so that a rehearsal off the card stays small; at
the default they are the JAX script's.

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.fmtprobe [--only a,b]
(on the card; ``--device cpu`` runs the plain versions).
"""

from __future__ import annotations

import argparse
import sys

DEFAULT_ROWS = 410_624
SECTIONS = ("stream", "slab", "gather", "xlares", "slabvar", "segred")
THREADS = 256  # threads per CUDA block of stream_sum


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=DEFAULT_ROWS)
    ap.add_argument("--k", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--only", default="",
                    help="comma list: " + ",".join(SECTIONS))
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None

    def want(name):
        return only is None or name in only

    import numpy as np
    import torch

    from gnnadvisor_osdi21_tpu_torch.device import resolve_device
    from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import (
        pack_slab_bits, pack_slab_bits_t,
    )
    from gnnadvisor_osdi21_tpu_torch.ops import (
        fmtprobe_cuda, probe_cuda, spmm_cuda,
    )
    from gnnadvisor_osdi21_tpu_torch.utils.timing import chained_device_time

    dev = resolve_device(args.device)
    r, k, d = args.rows, args.k, args.dim
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16

    def slots(m: int) -> int:
        """The JAX script's slot count m, shrunk with R below the default
        (a multiple of 1024, so that every TILE divides it)."""
        if r >= DEFAULT_ROWS:
            return m
        return max(1024, m * r // DEFAULT_ROWS // 1024 * 1024)

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    def timed(op, x, aux):
        st = {}
        sec = chained_device_time(op, x, aux, iters=args.iters, stats=st)
        return sec, f"host {st['host_s'] * 1e3:7.3f} ms"

    s0 = torch.zeros((8, 128), dtype=torch.float32, device=dev)

    # ---------------- 1. streaming ceiling ------------------------------
    if want("stream"):
        for dtype, name in ((torch.int8, "int8"), (torch.float32, "f32"),
                            (torch.uint32, "u32")):
            # built on the device; content is irrelevant to streaming rate
            a = torch.ones((r, k), dtype=dtype, device=dev)
            nbytes = a.numel() * a.element_size()
            sec, host = timed(
                lambda x, aux: fmtprobe_cuda.stream_sum(aux, x, 512), s0, a)
            print(f"pallas stream {name:5s} [{r}x{k}] {nbytes/1e6:7.1f}MB: "
                  f"{sec*1e3:7.3f} ms = {nbytes/sec/1e9:6.1f} GB/s  {host}  "
                  f"cuda block 512 rows x {THREADS} thr", flush=True)
            del a

    # ---------------- 2. slab matmul variants ---------------------------
    if want("slab"):
        nnz = 6 * r
        rows_i = rng.integers(0, r, nnz)
        cols_i = rng.integers(0, k, nnz)
        # the JAX script's transpose_slab(pack_slab_bits(...)): the same
        # bytes, built directly
        bits = on_dev(pack_slab_bits_t(rows_i, cols_i, r, k))
        xh = on_dev(rng.standard_normal((k, d)).astype(np.float32))
        sec, host = timed(lambda x, b: spmm_cuda.slab_matmul(b, x), xh, bits)
        print(f"bit-slab  matmul [{r}x{k}]x[{k}x{d}]: {sec*1e3:7.3f} ms "
              f"({r*k/sec/1e12:.2f} Tslot/s)  {host}  cuda block: "
              f"{probe_cuda.BIT_BLOCK}", flush=True)
        del bits

        a8 = torch.ones((r, k), dtype=torch.int8, device=dev)
        xb = xh.to(bf16)
        for blk in (512, 1024):
            sec, host = timed(
                lambda x, a: fmtprobe_cuda.i8_slab(a, x, blk), xb, a8)
            print(f"int8-slab matmul blk={blk} [{r}x{k}]x[{k}x{d}]: "
                  f"{sec*1e3:7.3f} ms ({r*k/sec/1e9:.0f} GB/s read)  {host}  "
                  f"cuda block: {fmtprobe_cuda.I8_BLOCK}", flush=True)
        del a8

    # ---------------- 3. residual-scale gather --------------------------
    if want("gather"):
        table = on_dev(rng.standard_normal((r // 8, 128)).astype(np.float32))
        for m in map(slots, (131072, 262144, 524288)):
            idx = on_dev(np.sort(rng.integers(0, r // 8, m)).astype(np.int32))
            sec, host = timed(lambda i, t: t.index_select(0, i), idx, table)
            print(f"gather {m:7d} x128-lane rows: {sec*1e3:7.3f} ms "
                  f"= {m/sec/1e6:6.1f} M rows/s  {host}  index_select",
                  flush=True)

    # ---------------- 3b. residual pipeline in torch ops ----------------
    if want("xlares"):
        # gather + mask-fold + batched one-hot product + segment sum
        ob = 512
        group = (torch.arange(128, device=dev) // d).to(torch.int32)[None, :]
        out_rows = torch.arange(ob, device=dev)
        for tile in (128, 256):
            m = slots(393216)
            t_total = m // tile
            n_blocks = r // ob
            table = on_dev(
                rng.standard_normal((r // 8, 128)).astype(np.float32))
            idx = on_dev(np.sort(rng.integers(0, r // 8, m)).astype(np.int32))
            masks = on_dev(rng.integers(1, 255, (m, 1)).astype(np.int32))
            segs = on_dev(
                np.sort(rng.integers(0, ob, (t_total, tile))).astype(np.int32))
            t2b = np.minimum(np.arange(t_total) * n_blocks // t_total,
                             n_blocks - 1)
            # the segment sum over the sorted t2b, by run lengths: a
            # deterministic sum (index_add_ adds with atomics on the card)
            lengths = on_dev(np.bincount(t2b, minlength=n_blocks))

            def resid(_x, aux, m=m, t_total=t_total, tile=tile,
                      n_blocks=n_blocks):
                table_, idx_, masks_, segs_, lengths_ = aux
                rows = table_.index_select(0, idx_)  # [m, 128]
                mm = ((masks_ >> group) & 1).to(torch.float32)
                v = (rows * mm).view(m, 128 // d, d).sum(1)  # [m, D]
                v3 = v.view(t_total, tile, d).to(bf16).to(torch.float32)
                oh = (segs_[:, :, None] == out_rows).to(torch.float32)
                chunks = torch.bmm(oh.transpose(1, 2), v3)  # [t, OB, D]
                flat = chunks.reshape(t_total, ob * d)
                out = torch.segment_reduce(flat, "sum", lengths=lengths_,
                                           axis=0)
                return out.view(n_blocks * ob, d)

            sec, host = timed(resid, s0, (table, idx, masks, segs, lengths))
            print(f"xla-resid TILE={tile} OB={ob} m={m}: {sec*1e3:7.3f} ms "
                  f"= {m/sec/1e6:6.1f} M slots/s  {host}  torch ops",
                  flush=True)

    # ---------------- 3c. slab unpack variants --------------------------
    if want("slabvar"):
        nnz = 6 * r
        bits = on_dev(pack_slab_bits(
            rng.integers(0, r, nnz), rng.integers(0, k, nnz), r, k))
        xh = on_dev(rng.standard_normal((k, d)).astype(np.float32))
        for variant, x in (("base_bf16", xh.to(bf16)), ("mul_f32dot", xh)):
            for blk in (512, 1024):
                sec, host = timed(
                    lambda x_, b: fmtprobe_cuda.bit_slab(b, x_, blk), x, bits)
                print(f"slab {variant:10s} blk={blk}: {sec*1e3:7.3f} ms  "
                      f"{host}  cuda block: {probe_cuda.BIT_BLOCK}",
                      flush=True)
        del bits

    # ---------------- 4. one-hot segment-reduce -------------------------
    if want("segred"):
        # synthetic: M slots sorted over out rows, OB-row out-blocks, TILE
        # slots per tile, a tile -> block map
        for tile, ob in ((256, 256), (512, 512), (256, 512), (512, 256),
                         (1024, 512)):
            m = slots(393216)
            n_blocks = r // ob
            # even spread: block b gets m // n_blocks slots (tile-aligned)
            per_block = max(((m // n_blocks) // tile) * tile, tile)
            tiles_per_block = per_block // tile
            t_total = n_blocks * tiles_per_block
            seg_local = np.sort(
                rng.integers(0, ob, (t_total, tile))
            ).astype(np.int32).reshape(t_total * tile, 1)
            tile2blk = np.repeat(np.arange(n_blocks, dtype=np.int32),
                                 tiles_per_block)
            first = np.ones(t_total, dtype=np.int32)
            first[1:] = tile2blk[1:] != tile2blk[:-1]
            vals = torch.ones((t_total * tile, 128), dtype=torch.float32,
                              device=dev)
            masks = rng.integers(1, 255, (t_total * tile, 1)).astype(np.uint32)
            aux = (vals, on_dev(masks), on_dev(seg_local), on_dev(tile2blk),
                   on_dev(first))
            sec, host = timed(
                lambda x, a: fmtprobe_cuda.seg_reduce(
                    *a, x, tile, ob, n_blocks), s0, aux)
            print(f"segred TILE={tile} OB={ob} m={t_total*tile}: "
                  f"{sec*1e3:7.3f} ms = {t_total*tile/sec/1e6:6.1f} M slots/s"
                  f"  {host}  cuda block: {fmtprobe_cuda.SEG_BLOCK}",
                  flush=True)
            del vals, aux
    return 0


if __name__ == "__main__":
    sys.exit(main())
