"""Decompose the slab pass's fixed cost: per row against per block, and a
dense 0/1 slab against the bit walk.  The port of
``gnnadvisor_osdi21_tpu/bench/stepprobe.py``.

The tier cost model prices a slab pass as ``rows * (SLAB_A + SLAB_B * C)``
(``graphs/hybrid.py``).  Section 1 times the port's hot ``slab_matmul``
(csrc/slab.cu) across K, D, dtype and the JAX script's ``block_rows``
sweep: the K sweep separates the per-row part (SLAB_A) from the
per-column part (SLAB_B).  ``block_rows`` is the TPU's grid-step size;
the CUDA kernel sizes its own blocks (256 threads), so on the card the
``br`` points of one shape time the same launch and show the noise.
Section 2 times dense 0/1 slabs (int8 or bf16) with no unpack at all
(``probe_cuda.dense_slab``, on the tensor cores for bf16 and for f32
features, which it splits exactly into three bf16 terms); that kernel also
sizes its own blocks (``probe_cuda.DENSE_BLOCK``), so its ``br`` points
of one shape time the same launch too.

The same sections, shapes, seeds, sweeps and line formats as the JAX
script; each line appends the host's wall time to issue one call and the
CUDA block shape.

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.stepprobe   (on the card)
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    import numpy as np
    import torch

    from gnnadvisor_osdi21_tpu_torch.device import resolve_device
    from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import pack_slab_bits_t
    from gnnadvisor_osdi21_tpu_torch.ops import probe_cuda, spmm_cuda
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

    def name(dt: torch.dtype) -> str:
        return str(dt).rsplit(".", 1)[-1]

    r = args.rows  # multiple of every block_rows swept
    rng = np.random.default_rng(0)

    def slab(k):
        """The JAX script's transpose_slab(pack_slab_bits(...)): the same
        bytes as pack_slab_bits_t over the same edges, built directly."""
        rows_e = rng.integers(0, r, size=8 * r)
        cols_e = rng.integers(0, k, size=8 * r)
        return torch.from_numpy(pack_slab_bits_t(rows_e, cols_e, r, k)).to(dev)

    print(f"== hot slab_matmul, R={r}: K x D x block_rows x dtype ==")
    for k in (128, 512, 1024, 2048):
        bits = slab(k)
        for d in (16, 128):
            for dt in (torch.bfloat16, torch.float32):
                x_hot = torch.ones((k, d), dtype=dt, device=dev)
                for br in (512, 1024, 2048):
                    if k * br * 4 > 14 << 20:
                        continue  # the TPU's scoped-vmem limit, kept
                    st = {}
                    sec = chained_device_time(
                        lambda xh, b: spmm_cuda.slab_matmul(b, xh),
                        x_hot, bits, iters=args.iters, stats=st,
                    )
                    steps = r // br
                    print(
                        f"K={k:5d} D={d:4d} {name(dt):9s} br={br:5d}: "
                        f"{sec*1e3:7.3f} ms  {sec/r*1e9:6.2f} ns/row  "
                        f"{sec/steps*1e6:7.2f} us/step  host "
                        f"{st['host_s']*1e3:7.3f} ms  cuda block: the "
                        "kernel's own (256 thr)",
                        flush=True,
                    )
        del bits

    # ---- dense-slab variants: skip the bit unpack entirely --------------
    print("== dense slab (no unpack), R x K, D=16 ==", flush=True)
    for k in (512, 1024, 2048):
        rows_e = rng.integers(0, r, size=8 * r)
        cols_e = rng.integers(0, k, size=8 * r)
        # a[cols, rows] = 1, scattered on the device: the JAX script's bytes
        a = torch.zeros((k, r), dtype=torch.int8, device=dev)
        a[torch.from_numpy(cols_e).to(dev), torch.from_numpy(rows_e).to(dev)] = 1
        for sdt, xdt in probe_cuda.DENSE_DTYPES:
            a_t = a.to(sdt)
            x = torch.ones((k, 16), dtype=xdt, device=dev)
            for br in (512, 1024, 2048):
                bm = probe_cuda.block_rows_for(br)
                st = {}
                sec = chained_device_time(
                    lambda x_, aa: probe_cuda.dense_slab(aa, x_, bm), x, a_t,
                    iters=args.iters, stats=st,
                )
                gbs = r * k * a_t.element_size() / sec / 1e9
                print(
                    f"K={k:5d} slab={name(sdt):9s} x={name(xdt):9s} "
                    f"br={br:5d}: {sec*1e3:7.3f} ms  {sec/r*1e9:6.2f} ns/row "
                    f"{sec/(r*k)*1e12:5.2f} ps/slot  {gbs:5.0f} GB/s  host "
                    f"{st['host_s']*1e3:7.3f} ms  cuda block: "
                    f"{probe_cuda.DENSE_BLOCK}",
                    flush=True,
                )
            del a_t
        del a
    return 0


if __name__ == "__main__":
    sys.exit(main())
