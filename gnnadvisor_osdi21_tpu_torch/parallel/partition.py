"""Multi-device ELL partitioning (host side): the port's own copy of
``gnnadvisor_osdi21_tpu/parallel/partition.py``, byte-identical in every
array and scalar (tests/test_torch_parallel.py).

Destination rows are split across ranks in contiguous blocks, and a static
halo exchange plan says which source rows each rank ships to each other
rank, so that every rank fetches the remote features its edges read with
one exchange per aggregation:

- ``x`` rows: rank ``d`` owns global rows ``[d·B, (d+1)·B)`` (N padded to
  ``ndev·B`` with isolated degree-0 nodes),
- ``int_*`` / ``bnd_*``: each rank's neighbor groups, split into interior
  parts (every neighbor local) and boundary parts (reading the exchanged
  table), owners sorted within each class,
- the ragged plan (``halo_sizes``, ``send_flat``, offsets): what
  ``dist_ops.halo_exchange`` ships, the exact rows and no padding; the
  dense ``send_idx``/``halo_repack`` plan is built for parity with the
  JAX package's plan, which its CPU mesh reads, and not used by the port.

The arrays lead with ``[ndev]``; rank r takes entry r
(``dist_ops.ell_shard``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnnadvisor_osdi21_tpu_torch.graphs.loader import GraphCSR
from gnnadvisor_osdi21_tpu_torch.graphs.partition import build_neighbor_groups


@dataclasses.dataclass
class ShardedGraph:
    """Per-device stacked graph tensors + the halo exchange plan."""

    num_devices: int
    block: int  # B: rows per device
    num_nodes: int  # original (unpadded) node count
    halo: int  # Hmax: padded rows exchanged per (src, dst) device pair
    part_size: int
    # All arrays have a leading [ndev] axis.  Parts are split at build time
    # into INTERIOR (every neighbor locally owned: reducible against
    # x_local while the halo exchange is in flight) and BOUNDARY (needs
    # the exchanged table).  Owners stay sorted within each class, so both
    # reductions use the fast sorted segment-sum and their partials add
    # exactly.
    int_cols: np.ndarray  # [ndev, PImax, S] int32 — local row ids (< B)
    int_lens: np.ndarray  # [ndev, PImax] int32
    int2local: np.ndarray  # [ndev, PImax] int32
    bnd_cols: np.ndarray  # [ndev, PBmax, S] int32 — gather-table ids
    bnd_lens: np.ndarray  # [ndev, PBmax] int32
    bnd2local: np.ndarray  # [ndev, PBmax] int32
    send_idx: np.ndarray  # [ndev, ndev, Hmax] int32 — rows to ship
    degrees: np.ndarray  # [ndev, B] f32 sqrt-degrees of owned rows
    node_mask: np.ndarray  # [ndev, B] f32 — 1 for real nodes, 0 for padding
    # --- ragged exchange plan (same contract as HybridShardedGraph) ------
    # ``bnd_cols`` index the COMPACT table [x_local ; ragged recv] — each
    # receiver's halo packs contiguously in sender order instead of
    # striding every pair to the fleet-wide Hmax; ``dist_ops.halo_exchange``
    # ships exactly these rows with one ``all_to_all_single``.  The dense
    # ``send_idx``/``halo_repack`` plan is built for parity with the JAX
    # package's plan only.
    halo_sizes: np.ndarray | None = None  # [ndev(r), ndev(s)] int32
    recv_max: int = 0  # padded max Σ_s halo_sizes[r, s]
    send_flat: np.ndarray | None = None  # [ndev, Smax] sender gather list
    halo_in_off: np.ndarray | None = None  # [ndev(s), ndev(r)] send offsets
    halo_send_sizes: np.ndarray | None = None  # [ndev(s), ndev(r)]
    halo_out_off: np.ndarray | None = None  # [ndev(s), ndev(r)] recv offsets
    halo_repack: np.ndarray | None = None  # [ndev(r), recv_max] dense->ragged

    @property
    def table_rows(self) -> int:
        """Rows in each device's gather table: local block + received halo."""
        return self.block + self.recv_max


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def shard_graph(
    graph: GraphCSR,
    num_devices: int,
    part_size: int | None = None,
    pad_parts_to: int = 8,
    pad_halo_to: int = 8,
) -> ShardedGraph:
    """Build the static halo-exchange plan for ``num_devices`` row blocks."""
    if part_size is None:
        part_size = max(2, min(int(graph.avg_degree), 64))
    n = graph.num_nodes
    block = _round_up(max(n, num_devices), num_devices) // num_devices
    n_pad = block * num_devices

    groups = build_neighbor_groups(
        graph.row_pointers, graph.column_index, part_size, pad_parts_to=1
    )
    owners = groups.part2node[: groups.num_real_parts].astype(np.int64)
    cols = groups.part_cols[: groups.num_real_parts]
    lens = groups.part_lens[: groups.num_real_parts]
    owner_dev = owners // block

    # Per-device contiguous part slices (owners sorted by construction).
    dev_part_start = np.searchsorted(owner_dev, np.arange(num_devices))
    dev_part_end = np.searchsorted(owner_dev, np.arange(num_devices), side="right")
    p_max = _round_up(max(int((dev_part_end - dev_part_start).max()), 1), pad_parts_to)

    col_dev = cols.astype(np.int64) // block  # owner device of each referenced id

    # Halo sets: unique remote ids device d needs from device e.
    need: list[list[np.ndarray]] = []
    h_max = 1
    for d in range(num_devices):
        s, e = dev_part_start[d], dev_part_end[d]
        dcols = cols[s:e]
        dlens = lens[s:e]
        valid = np.arange(part_size)[None, :] < dlens[:, None]
        row: list[np.ndarray] = []
        for src in range(num_devices):
            if src == d:
                row.append(np.empty(0, dtype=np.int64))
                continue
            sel = valid & (col_dev[s:e] == src)
            ids = np.unique(dcols[sel].astype(np.int64))
            row.append(ids)
            h_max = max(h_max, len(ids))
        need.append(row)
    h_max = _round_up(h_max, pad_halo_to)

    # --- exchange plans ---------------------------------------------------
    # halo_sizes[r, s] = unique rows receiver r needs from sender s; the
    # COMPACT table packs each receiver's halo in sender order (exclusive-
    # cumsum offsets), so the wire ships Σ_s sizes[r, s] rows per device
    # instead of the dense plan's ndev·Hmax.
    halo_sizes = np.array(
        [[len(need[d][s]) for s in range(num_devices)] for d in range(num_devices)],
        dtype=np.int32,
    )
    recv_off = np.zeros((num_devices, num_devices), dtype=np.int32)
    recv_off[:, 1:] = np.cumsum(halo_sizes, axis=1)[:, :-1]
    recv_max = _round_up(max(int(halo_sizes.sum(axis=1).max(initial=0)), 1),
                         pad_halo_to)
    send_per = halo_sizes.sum(axis=0)
    s_max = _round_up(max(int(send_per.max(initial=0)), 1), pad_halo_to)
    halo_send_sizes = np.ascontiguousarray(halo_sizes.T)  # [s, r]
    halo_in_off = np.zeros((num_devices, num_devices), dtype=np.int32)
    halo_in_off[:, 1:] = np.cumsum(halo_send_sizes, axis=1)[:, :-1]
    halo_out_off = np.ascontiguousarray(recv_off.T)  # [s, r] -> recv_off[r, s]

    send_idx = np.zeros((num_devices, num_devices, h_max), dtype=np.int32)
    send_flat = np.zeros((num_devices, s_max), dtype=np.int32)
    halo_repack = np.zeros((num_devices, recv_max), dtype=np.int32)
    for d in range(num_devices):
        for src in range(num_devices):
            ids = need[d][src]
            nh = len(ids)
            # device `src` ships rows ids - src*block to device d
            loc = (ids - src * block).astype(np.int32)
            send_idx[src, d, :nh] = loc
            send_flat[src, halo_in_off[src, d]: halo_in_off[src, d] + nh] = loc
            halo_repack[d, recv_off[d, src]: recv_off[d, src] + nh] = (
                src * h_max + np.arange(nh, dtype=np.int32)
            )

    # Remap part_cols to the receiver's COMPACT gather table
    # [x_local ; ragged recv]: the halo row of id k from sender `src` lands
    # at table row block + recv_off[d, src] + rank(k within need[d][src]).
    # Parts split interior/boundary.
    per_dev = []  # (int_(cols,lens,p2l), bnd_(cols,lens,p2l))
    pi_max = pb_max = 1
    for d in range(num_devices):
        s, e = dev_part_start[d], dev_part_end[d]
        dcols = cols[s:e].astype(np.int64)
        dlens = lens[s:e]
        downers = (owners[s:e] - d * block).astype(np.int32)
        remapped = np.empty_like(dcols, dtype=np.int64)
        local = col_dev[s:e] == d
        remapped[local] = dcols[local] - d * block
        for src in range(num_devices):
            if src == d:
                continue
            sel = col_dev[s:e] == src
            if not sel.any():
                continue
            pos = np.searchsorted(need[d][src], dcols[sel])
            remapped[sel] = block + recv_off[d, src] + pos
        valid_slots = np.arange(part_size)[None, :] < dlens[:, None]
        # padding slots (beyond each part's length) must stay in local
        # range: they are gathered (and masked out), and a NaN read there
        # would survive the mask (NaN*0 is NaN).
        remapped[~valid_slots] = 0
        interior = ~np.any(valid_slots & (col_dev[s:e] != d), axis=1)
        per_dev.append(
            (
                (remapped[interior], dlens[interior], downers[interior]),
                (remapped[~interior], dlens[~interior], downers[~interior]),
            )
        )
        pi_max = max(pi_max, int(interior.sum()))
        pb_max = max(pb_max, int((~interior).sum()))
    pi_max = _round_up(pi_max, pad_parts_to)
    pb_max = _round_up(pb_max, pad_parts_to)

    def _stack(cap, idx):
        c = np.zeros((num_devices, cap, part_size), dtype=np.int32)
        l = np.zeros((num_devices, cap), dtype=np.int32)
        o = np.zeros((num_devices, cap), dtype=np.int32)
        for d in range(num_devices):
            rc, rl, ro = per_dev[d][idx]
            k = len(rl)
            c[d, :k] = rc.astype(np.int32)
            l[d, :k] = rl
            o[d, :k] = ro
            if k:  # keep owners sorted through the padding
                o[d, k:] = ro[-1]
        return c, l, o

    int_cols, int_lens, int2local = _stack(pi_max, 0)
    bnd_cols, bnd_lens, bnd2local = _stack(pb_max, 1)

    deg_pad = np.zeros(n_pad, dtype=np.float32)
    deg_pad[:n] = graph.degrees
    deg_pad[n:] = 1.0  # sqrt(max(0,1)) for padding nodes
    mask = np.zeros(n_pad, dtype=np.float32)
    mask[:n] = 1.0

    return ShardedGraph(
        num_devices=num_devices,
        block=block,
        num_nodes=n,
        halo=h_max,
        part_size=part_size,
        int_cols=int_cols,
        int_lens=int_lens,
        int2local=int2local,
        bnd_cols=bnd_cols,
        bnd_lens=bnd_lens,
        bnd2local=bnd2local,
        send_idx=send_idx,
        degrees=deg_pad.reshape(num_devices, block),
        node_mask=mask.reshape(num_devices, block),
        halo_sizes=halo_sizes,
        recv_max=recv_max,
        send_flat=send_flat,
        halo_in_off=halo_in_off,
        halo_send_sizes=halo_send_sizes,
        halo_out_off=halo_out_off,
        halo_repack=halo_repack,
    )
