"""Multi-device hybrid layout (host side): the port's own copy of
``gnnadvisor_osdi21_tpu/parallel/hybrid_partition.py``, byte-identical in
every field (tests/test_torch_parallel.py).  It prices and builds with the
port's ``graphs/hybrid.py`` (the JAX package's cost-model fits).

One three-tier layout per rank's row block, so that several ranks train
on the same diagonal/hot/residual kernels as one card:

- destination rows are sharded in contiguous blocks of ``B`` (a multiple
  of ``diag_b``, so global diagonal blocks never straddle ranks),
- each rank's gather space is its halo table ``[x_local ; recv]``, which
  one exchange fills (``dist_ops.halo_exchange``),
- the diagonal tier reads only x_local (its columns are block-local by
  construction), so it can run while the exchange is in flight,
- the hot and residual tiers index the halo table and run once the
  exchange has landed.

Arrays are padded to the largest rank's counts and lead with ``[ndev]``;
rank r takes entry r (``dist_hybrid.local_tensors``).  Both residual mask
orientations are built, for parity; only ``res_mask_s`` goes to the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import (
    GATHER_BIG_NS,
    GATHER_SINGLE_NS,
    GATHER_SLOT_NS,
    RES_SINGLE_MAX_CELLS,
    RES_STAGE2_FIX_NS,
    EdgeCensus,
    build_residual_stream,
    choose_layout_tiers,
    pack_slab_bits_t,
)
from gnnadvisor_osdi21_tpu_torch.graphs.loader import GraphCSR


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class HybridShardedGraph:
    """Stacked per-device hybrid layouts + the halo exchange plan."""

    num_devices: int
    block: int  # B: rows per device (multiple of max(diag_b, res_ob, 512))
    num_nodes: int  # original (unpadded) node count
    halo: int  # Hmax: rows exchanged per (src, dst) device pair
    diag_b: int
    hot_k: int
    res_tile: int
    res_ob: int
    # all arrays lead with [ndev]; bit arrays transposed ([words, rows]),
    # the slab kernels' layout (ops/spmm_cuda.py)
    diag_bits: np.ndarray  # [ndev, diag_b/16, B] uint16 (cols local to block)
    hot_ids: np.ndarray  # [ndev, K] int32 — TABLE row ids
    hot_bits: np.ndarray  # [ndev, K/16, B] uint16
    res_gather: np.ndarray  # [ndev, Ug] int32 — TABLE row ids (stage 1)
    res_dst: np.ndarray  # [ndev, M] int32 into res_gather (stage 2)
    res_mask: np.ndarray  # [ndev, res_ob/32, M] uint32 multi-hot
    res_mask_s: np.ndarray  # [ndev, res_tile/16, T*res_ob] uint16 slot-major twin
    res_t2b: np.ndarray  # [ndev, T] int32 tile -> out-block (sorted)
    send_idx: np.ndarray  # [ndev, ndev, Hmax] int32 rows to ship (dense plan)
    degrees: np.ndarray  # [ndev, B] f32 sqrt-degrees
    node_mask: np.ndarray  # [ndev, B] f32, 1 on real rows
    # --- ragged exchange plan (the table layout all tier indices use) -----
    # exact per-pair halo census: halo_sizes[r, s] = unique rows receiver r
    # needs from sender s.  The table packs each receiver's halo compactly,
    # as one all_to_all_single ships it (dist_ops.halo_exchange).
    halo_sizes: np.ndarray | None = None  # [ndev(r), ndev(s)] int32
    recv_max: int = 0  # padded max Σ_s halo_sizes[r, s] (table halo span)
    send_flat: np.ndarray | None = None  # [ndev, Smax] sender gather list
    halo_in_off: np.ndarray | None = None  # [ndev(s), ndev(r)] send offsets
    halo_send_sizes: np.ndarray | None = None  # [ndev(s), ndev(r)]
    halo_out_off: np.ndarray | None = None  # [ndev(s), ndev(r)] recv offsets
    halo_repack: np.ndarray | None = None  # [ndev(r), recv_max] dense->ragged
    # single-stage residual gather (graphs/hybrid.py res_single): res_dst
    # holds precomposed TABLE ids (the JAX package's one gather op per
    # layer instead of two, by the single-chip cost rule applied to the
    # fleet-wide padded censuses).  The port's residual kernel reads one id
    # per slot either way (dist_hybrid.local_tensors composes them).
    res_single: bool = False

    @property
    def dense_exchange_rows(self) -> int:
        """Rows a uniform-Hmax exchange would ship per device."""
        return self.num_devices * self.halo

    @property
    def ragged_exchange_rows(self) -> int:
        """Max rows any device actually receives under the exact-size plan."""
        if self.halo_sizes is None:
            return self.dense_exchange_rows
        return int(self.halo_sizes.sum(axis=1).max())

    @property
    def table_rows(self) -> int:
        return self.block + self.recv_max


def shard_graph_hybrid(
    graph: GraphCSR,
    num_devices: int,
    diag_b: int | None = None,
    hot_k: int | None = None,
    res_tile: int | None = None,
    res_ob: int | None = None,
    pad_halo_to: int = 8,
    agg_feature_dim: int | None = None,
) -> HybridShardedGraph:
    """Partition + per-device hybrid layout build.

    ``diag_b``/``hot_k`` default to the whole-graph measured cost model
    (graphs/hybrid.py:choose_tiers) and ``res_ob``/``res_tile`` to the
    residual-census choice (choose_res_geometry) so single- and multi-chip
    runs make the same layout decisions; all are fleet-global (common
    static shapes).  The halo census and the column remap are one
    vectorized sort/unique pass over the remote edges — O(E log E),
    independent of device count.
    """
    n = graph.num_nodes
    rp = np.asarray(graph.row_pointers, dtype=np.int64)
    ci = np.asarray(graph.column_index, dtype=np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))

    # --- tier + residual geometry: the single-chip build's fixed point ---
    # (graphs/hybrid.choose_layout_tiers), so that single- and multi-device
    # builds make the same layout decisions.  Blocks are a multiple of
    # res_ob, so the global (src//res_ob, dst) census equals the union of
    # the per-device ones — no circular dependency on the block size.
    # Per-device hot sets (table-id space) differ slightly from the global
    # hot census used here; the geometry choice is robust to that (it
    # prices aggregate slot counts, not identities).
    census = (EdgeCensus.of_graph(graph)
              if None in (diag_b, hot_k, res_ob, res_tile) else None)
    diag_b, hot_k, res_ob, res_tile, _ = choose_layout_tiers(
        census, n, diag_b=diag_b, hot_k=hot_k, res_tile=res_tile,
        res_ob=res_ob,
    )
    if diag_b:
        in_diag = (src // diag_b) == (ci // diag_b)
    else:
        in_diag = np.zeros(len(src), dtype=bool)

    align = max(diag_b, res_ob, 512)
    block = _round_up(_round_up(max(n, num_devices), num_devices) // num_devices, align)
    n_pad = block * num_devices

    src_dev = src // block
    dst_dev = ci // block

    # --- halo census: unique remote ids device d needs from device e ------
    # (hot + residual columns; diagonal columns are local by construction).
    # One sort/unique over (d, e, id) keys replaces the per-pair mask loop.
    remote = (~in_diag) & (src_dev != dst_dev)
    rkey = (src_dev[remote] * num_devices + dst_dev[remote]) * np.int64(
        n_pad + 1
    ) + ci[remote]
    ukey = np.unique(rkey)
    upair = ukey // (n_pad + 1)
    uid = ukey % (n_pad + 1)
    pair_counts = np.bincount(upair, minlength=num_devices * num_devices)
    pair_off = np.concatenate(([0], np.cumsum(pair_counts)))
    # halo_sizes[r, s] = unique rows receiver r needs from sender s
    halo_sizes = pair_counts.reshape(num_devices, num_devices).astype(np.int32)
    h_max = max(int(pair_counts.max(initial=0)), 1)
    h_max = _round_up(h_max, pad_halo_to)

    # --- ragged exchange plan ---------------------------------------------
    # The gather table packs each receiver's halo COMPACTLY (segments in
    # sender order, exclusive-cumsum offsets) instead of striding every
    # pair to the fleet-wide h_max: after rabbit the pair sizes are heavily
    # skewed, so the compact table ships/stores Σ_s sizes[r, s] rows per
    # device instead of ndev·h_max (dist_ops.halo_exchange ships exactly
    # these rows).
    recv_off = np.zeros((num_devices, num_devices), dtype=np.int32)
    recv_off[:, 1:] = np.cumsum(halo_sizes, axis=1)[:, :-1]
    recv_total = halo_sizes.sum(axis=1)
    recv_max = _round_up(max(int(recv_total.max(initial=0)), 1), pad_halo_to)
    table = block + recv_max
    send_per = halo_sizes.sum(axis=0)  # rows sender s ships in total
    s_max = _round_up(max(int(send_per.max(initial=0)), 1), pad_halo_to)
    # sender-side plan: sizes/offsets by receiver, flat gather list
    halo_send_sizes = np.ascontiguousarray(halo_sizes.T)  # [s, r]
    halo_in_off = np.zeros((num_devices, num_devices), dtype=np.int32)
    halo_in_off[:, 1:] = np.cumsum(halo_send_sizes, axis=1)[:, :-1]
    halo_out_off = np.ascontiguousarray(recv_off.T)  # [s, r] -> recv_off[r, s]
    send_flat = np.zeros((num_devices, s_max), dtype=np.int32)
    send_idx = np.zeros((num_devices, num_devices, h_max), dtype=np.int32)
    halo_repack = np.zeros((num_devices, recv_max), dtype=np.int32)
    for p in np.nonzero(pair_counts)[0]:
        r, s = divmod(int(p), num_devices)
        ids = uid[pair_off[p] : pair_off[p + 1]]  # sorted ascending
        loc = (ids - s * block).astype(np.int32)
        send_idx[s, r, : len(ids)] = loc
        send_flat[s, halo_in_off[s, r] : halo_in_off[s, r] + len(ids)] = loc
        halo_repack[r, recv_off[r, s] : recv_off[r, s] + len(ids)] = (
            s * h_max + np.arange(len(ids), dtype=np.int32)
        )

    # --- column remap: one global searchsorted over remote edges ----------
    col_t = np.empty(len(src), dtype=np.int64)
    local = src_dev == dst_dev
    col_t[local] = ci[local] - src_dev[local] * block
    pos = np.searchsorted(ukey, rkey)  # position within the sorted census
    within = pos - pair_off[upair[pos]]
    col_t[remote] = block + recv_off[src_dev[remote], dst_dev[remote]] + within

    # --- per-device layout build ------------------------------------------
    per = []
    ug_max = m_max = t_max = 1
    for d in range(num_devices):
        mine = src_dev == d
        s_l = src[mine] - d * block  # local output rows
        dst_g = ci[mine]
        dloc = in_diag[mine]
        col_d = col_t[mine]

        # diagonal tier: block-local columns (transposed storage)
        if diag_b:
            diag_bits = pack_slab_bits_t(
                s_l[dloc], (dst_g[dloc] % diag_b), block, diag_b
            )
        else:
            diag_bits = np.zeros((0, block), dtype=np.uint16)

        # hot tier: top-K table ids among off-diagonal edges
        od_cols = col_d[~dloc]
        od_rows = s_l[~dloc]
        if hot_k:
            counts = np.bincount(od_cols, minlength=table)
            top = np.argsort(counts)[::-1][:hot_k].astype(np.int32)
            top = top[counts[top] > 0]
            # pad columns never set a bit; id 0 (a real table row) is only
            # a duplicate gather of K-len(top) rows, there is no per-device
            # row guaranteed zero in the gather table (see graphs/hybrid.py
            # for the single-chip sentinel-zero-row variant)
            hot_ids = np.zeros(hot_k, dtype=np.int32)
            hot_ids[: len(top)] = top
            hot_col = np.full(table, -1, dtype=np.int64)
            hot_col[top] = np.arange(len(top))
            is_hot = hot_col[od_cols] >= 0
            hot_bits = pack_slab_bits_t(
                od_rows[is_hot], hot_col[od_cols[is_hot]], block, hot_k
            )
        else:
            hot_ids = np.zeros(0, dtype=np.int32)
            hot_bits = np.zeros((0, block), dtype=np.uint16)
            is_hot = np.zeros(len(od_cols), dtype=bool)

        # both mask orientations, for parity with the JAX package's
        # layout: the transposed kernel reads the slot-major one
        rg, rd_, rm, rms, rt, _pairs = build_residual_stream(
            od_rows[~is_hot], od_cols[~is_hot], table, block, res_tile,
            res_ob,
        )
        per.append((diag_bits, hot_ids, hot_bits, rg, rd_, rm, rms, rt))
        ug_max = max(ug_max, len(rg))
        m_max = max(m_max, len(rd_))
        t_max = max(t_max, len(rt))

    m_max = _round_up(m_max, res_tile)
    t_max = max(t_max, m_max // res_tile)
    words = res_ob // 32
    kw = hot_k // 16
    dw = diag_b // 16
    n_blocks = block // res_ob

    # gather formulation for the residual tier, the single-chip layout's
    # rule (graphs/hybrid.py): single-stage precomposes
    # res_gather[res_dst] into TABLE ids and drops one gather op per
    # layer per device; priced on the fleet-wide padded censuses
    res_single = bool(
        GATHER_SINGLE_NS * m_max
        < GATHER_BIG_NS * ug_max + GATHER_SLOT_NS * m_max + RES_STAGE2_FIX_NS
    )
    # epoch-context width gate (graphs/hybrid.py RES_SINGLE_MAX_CELLS):
    # the sharded plan precomposes res_dst at build time, so the caller
    # passes the widest aggregate dim its layers run (None = dim-free
    # rule).  Unlike single-chip, the formulation here is fleet-global.
    if agg_feature_dim is not None and (
        m_max * agg_feature_dim > RES_SINGLE_MAX_CELLS
    ):
        res_single = False

    diag_bits = np.zeros((num_devices, dw, block), dtype=np.uint16)
    hot_ids = np.zeros((num_devices, hot_k), dtype=np.int32)
    hot_bits = np.zeros((num_devices, kw, block), dtype=np.uint16)
    res_gather = np.zeros((num_devices, ug_max), dtype=np.int32)
    res_dst = np.zeros((num_devices, m_max), dtype=np.int32)
    res_mask = np.zeros((num_devices, words, m_max), dtype=np.uint32)
    sw = res_tile // 16
    res_mask_s = np.zeros((num_devices, sw, t_max * res_ob), dtype=np.uint16)
    res_t2b = np.full((num_devices, t_max), n_blocks - 1, dtype=np.int32)
    for d, (db, hi, hb, rg, rd_, rm, rms, rt) in enumerate(per):
        diag_bits[d, :, :] = db
        hot_ids[d, : len(hi)] = hi
        hot_bits[d, :, :] = hb
        res_gather[d, : len(rg)] = rg
        if res_single and len(rg):
            res_dst[d, : len(rd_)] = rg[rd_]  # precomposed table ids
        else:
            res_dst[d, : len(rd_)] = rd_
        res_mask[d, :, : rm.shape[1]] = rm
        if rms.size:
            res_mask_s[d, :, : rms.shape[1]] = rms
        # padded tail tiles (initialized to n_blocks-1 ≥ any real t2b) keep
        # the per-device tile->block map sorted; their masks are all-zero
        res_t2b[d, : len(rt)] = rt

    deg_pad = np.ones(n_pad, dtype=np.float32)
    deg_pad[:n] = graph.degrees
    mask = np.zeros(n_pad, dtype=np.float32)
    mask[:n] = 1.0

    return HybridShardedGraph(
        num_devices=num_devices,
        block=block,
        num_nodes=n,
        halo=h_max,
        diag_b=diag_b,
        hot_k=hot_k,
        res_tile=res_tile,
        res_ob=res_ob,
        res_single=res_single,
        diag_bits=diag_bits,
        hot_ids=hot_ids,
        hot_bits=hot_bits,
        res_gather=res_gather,
        res_dst=res_dst,
        res_mask=res_mask,
        res_mask_s=res_mask_s,
        res_t2b=res_t2b,
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
