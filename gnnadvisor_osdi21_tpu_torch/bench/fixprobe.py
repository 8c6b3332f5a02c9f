"""Probe the slab pass's per-row fixed cost with transposed-output dense
slabs: the port of ``gnnadvisor_osdi21_tpu/bench/fixprobe.py``.

The same sections, shapes, seeds, sweeps and line formats as the JAX
script, on the card:

- the legacy uint32 transposed bit slab ``[K/32, R]`` contracted into a
  transposed ``[16, R]`` output (``probe_cuda.bit_slab_t``), K sweep;
- a dense int8 0/1 slab ``[K, R]`` the same way (``probe_cuda.i8_slab_t``);
- the gather of the residual tier's rows from ``[R, 16]`` (axis 0) and
  from ``[16, R]`` (axis 1), as ``index_select``.

The JAX script's ``br`` is the rows of one TPU grid step; it maps to
``br // 16`` rows per CUDA block of threads, which the wrappers check.
Both slabs' kernels size their own blocks (``probe_cuda.BIT_BLOCK`` and
``DENSE_BLOCK``), so on the card the ``br`` points of one K time the same
launch.  Each line appends
the host's wall time to issue one call (``utils.timing``: a host-bound line
shows it) and the CUDA block shape.

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.fixprobe   (on the card)
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    import numpy as np
    import torch

    from gnnadvisor_osdi21_tpu_torch.device import resolve_device
    from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import pack_slab_bits
    from gnnadvisor_osdi21_tpu_torch.ops import probe_cuda
    from gnnadvisor_osdi21_tpu_torch.utils.timing import chained_device_time

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30,
                    help="chained calls per timed run (the JAX script's 30)")
    ap.add_argument("--rows", type=int, default=409_600,
                    help="graph rows R; smaller only to rehearse off the card")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def _transpose_u32(b):
        return torch.from_numpy(np.ascontiguousarray(b.T)).to(dev)

    def dense01(rows_e, cols_e, k_, r_):
        """int8 0/1 [K, R] with a[cols, rows] = 1, scattered on the device
        (the same bytes as the JAX script's host-built array)."""
        a = torch.zeros((k_, r_), dtype=torch.int8, device=dev)
        a[torch.from_numpy(cols_e).to(dev), torch.from_numpy(rows_e).to(dev)] = 1
        return a

    r = args.rows
    k = 512
    rng = np.random.default_rng(0)
    # the JAX script's first slab pair (built there, never timed): drawn so
    # that every later draw matches its draws
    rng.integers(0, r, size=8 * r)
    rng.integers(0, k, size=8 * r)

    def report(name, sec, host_s, block, denom_rows=r):
        print(f"{name:44s} {sec*1e3:7.3f} ms  {sec/denom_rows*1e9:6.2f} ns/row"
              f"  host {host_s*1e3:7.3f} ms  {block}", flush=True)

    # 3/4: slab kernels with transposed x/out -------------------------------
    for ks in (128, 512, 1024, 2048, 4096):
        rows_s = rng.integers(0, r, size=8 * r)
        cols_s = rng.integers(0, ks, size=8 * r)
        bits_s = _transpose_u32(pack_slab_bits(rows_s, cols_s, r, ks))
        x_t = torch.ones((16, ks), dtype=torch.bfloat16, device=dev)
        for br_ in (2048, 4096, 8192):
            if ks * br_ * 2 > 12 << 20:
                continue
            bm = probe_cuda.block_rows_for(br_)
            st = {}
            sec = chained_device_time(
                lambda xt, b: probe_cuda.bit_slab_t(b, xt, bm), x_t, bits_s,
                iters=args.iters, stats=st)
            ps = (sec / r - 0.5e-9) / ks * 1e12
            report(f"bitT K={ks} bf16 br={br_} (~{ps:4.1f}ps/slot)", sec,
                   st["host_s"], f"cuda block: {probe_cuda.BIT_BLOCK}")
        a8s = dense01(rows_s, cols_s, ks, r)
        for br_ in (2048, 4096):
            if ks * br_ * (1 + 2) > 24 << 20:
                continue
            bm = probe_cuda.block_rows_for(br_)
            st = {}
            sec = chained_device_time(
                lambda xt, a: probe_cuda.i8_slab_t(a, xt, bm), x_t, a8s,
                iters=args.iters, stats=st)
            ps = (sec / r - 0.5e-9) / ks * 1e12
            report(f"i8T  K={ks} bf16 br={br_} (~{ps:4.1f}ps/slot)", sec,
                   st["host_s"], f"cuda block: {probe_cuda.DENSE_BLOCK}")
        del a8s, bits_s

    # 5: gather economics under each layout ----------------------------------
    ud = 93_000
    ids = torch.from_numpy(rng.integers(0, r, size=ud, dtype=np.int32)).to(dev)
    x_row = torch.ones((r, 16), dtype=torch.float32, device=dev)
    x_col = torch.ones((16, r), dtype=torch.float32, device=dev)
    st = {}
    sec = chained_device_time(
        lambda i_, x_: x_.index_select(0, i_), ids, x_row, iters=args.iters,
        stats=st)
    report(f"gather {ud} rows from [R,16] (axis 0)", sec, st["host_s"],
           "index_select", denom_rows=ud)
    sec = chained_device_time(
        lambda i_, x_: x_.index_select(1, i_), ids, x_col, iters=args.iters,
        stats=st)
    report(f"gather {ud} cols from [16,R] (axis 1)", sec, st["host_s"],
           "index_select", denom_rows=ud)
    return 0


if __name__ == "__main__":
    sys.exit(main())
