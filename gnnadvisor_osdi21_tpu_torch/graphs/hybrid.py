"""Hybrid hot/diagonal/residual graph layout (host-side NumPy).

The torch port's own copy of ``gnnadvisor_osdi21_tpu/graphs/hybrid.py``
(layout, cost model and builders) and of ``pack_slab_bits_t``
(``ops/spmm_pallas.py``): the port imports nothing of the JAX package.
Given the same graph and parameters, ``build_hybrid`` returns
bit-identical slabs, masks and streams (tests/test_torch_hybrid_layout.py),
so both packages read the same bytes:

1. **Diagonal tier**: edges whose endpoints share a ``diag_b``-row block,
   as a per-block bit slab ``diag_bits`` ([B/16, R] uint16), multiplied
   against the block's own contiguous feature slice.
2. **Hot tier**: the top-K in-degree destinations among off-block edges,
   as a global bit slab ``hot_bits`` ([K/16, R]) against the gathered
   ``x[hot_ids]`` table; where they take fewer bytes, also as per-row
   lists (``hot_ptr``, ``hot_src``) for the transposed kernels.
3. **Residual tier**: one gather slot per unique (``res_ob``-row output
   block, destination) pair and a multi-hot mask that fans the gathered
   row out to every block row that wants it.

Bit layout: column ``j`` of a slab sits in word ``j % W16`` at bit
``j // W16``; graph rows are the minor (contiguous) axis.

The cost-model constants are the JAX package's fits, kept so the auto
tier choice matches the reference decider (with its probe off).  A fit
for the H100 is ROADMAP.md item A.7c.  The measured-probe autotune
(hybrid.py:670-835 in the JAX package) is ported: where the layout is
built for the card, or ``probe=True``, the model's top candidates are
built and timed through the port's own aggregation, and the measured
winner replaces the model's pick.  Its verdicts are cached in the port's
own directory, keyed by the card's name.

GCN's multiplicative ``deg[s]·deg[d]`` weighting (dataset.py:122) folds
into a dense pre-scale of x and post-scale of out, so no tier touches
per-edge weights.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib

import numpy as np
import torch

from gnnadvisor_osdi21_tpu_torch.device import resolve_device
from gnnadvisor_osdi21_tpu_torch.graphs.loader import GraphCSR
from gnnadvisor_osdi21_tpu_torch.utils import profiling

# Cost-model constants: the JAX package's fits, kept unchanged so that the
# auto tier choice here equals the JAX decider's (the CPU parity tests
# hold the two to it).  Their provenance, the sweeps and the hardware they
# were fitted on, is documented beside the originals at
# gnnadvisor_osdi21_tpu/graphs/hybrid.py:49-125; none of them is a
# measurement of this port's kernels.
#
# The model's structure: the slab pass overlaps the residual tier's gather
# chain, so the pipeline costs ``max(compute, gathers)``, not their sum,
# and the gather chain is two dependent gathers, each with a fixed ramp.
SLAB_A_NS = 0.44  # fixed per-output-column cost of the transposed slab pass
SLAB_B_NS = 0.0008  # per (row, column) slab cell: unpack + dot
RES_CELL_NS = 0.0013  # per (slot, out-row) combine cell (separate stream
# pattern from the slab pass: mask tiles revisit output blocks)
GATHER_SLOT_NS = 2.17  # stage-2 marginal: one slot gather from the compact table
GATHER_BIG_NS = 6.8  # stage-1 marginal: one unique-dst gather from full x
# Single-stage formulation: one gather of ALL slots from full x
# (res_gather[res_dst] precomposed host-side), at its effective
# in-pipeline rate (the rate reflects overlap with the combine and slab
# compute, not index locality).
GATHER_SINGLE_NS = 2.1
# In-context fixed cost of the residual gather chain: what a training
# epoch pays per gather op beyond the chained-SpMM marginal; set so that
# small graphs keep their tier choices.
RESID_FIX_NS = 1.0e6  # residual chain in-context ramp
# Calibrated conservative: the model cannot rank within the hot-on family
# at small scale, so the hot table's ramp stays high (the reference's
# manual mode covers the cases it misses).
HOT_FIX_NS = 2.0e5  # hot-table gather op ramp (charged when hot_k > 0)
# In-context ramp attributable to the residual chain's SECOND gather op
# (stage 2), i.e. what collapsing to a single-stage gather saves; the
# remainder of RESID_FIX_NS (launch of the chain itself) is paid either
# way.
RES_STAGE2_FIX_NS = 7.5e5
# Epoch-context width limit for the single-stage formulation: inside a
# training epoch the wide-row full-table gather stream loses its overlap
# and two-stage wins once slots x agg_dim grows past this many cells.  The
# JAX package's tensor build applies it per layer; the port's residual
# kernels gather by the composed ids at any width and do not read it.
RES_SINGLE_MAX_CELLS = 12_000_000
RESID_PAD_EST = 1.15  # slots / pairs (res_tile padding) at res_ob=1024
HBM_BYTES_PER_NS = 690.0  # the reference's stream-rate constant (bytes/ns)
# Bit slabs are stored transposed ([words, rows], spmm_pallas docstring),
# so physical bytes == logical bytes at every width; the cap keeps auto
# tier choices from dedicating most of HBM to adjacency bits anyway.
SLAB_MEM_CAP_BYTES = 3 << 30  # auto tiers may not spend >3 GB on bit slabs

# The reference's auto search tops out at 4096 (wider slabs did not fit
# its kernels' blocks); explicit hot_k/diag_b values still pass through.
DIAG_CANDIDATES = (0, 512, 1024, 2048, 4096)
HOT_CANDIDATES = (0, 512, 1024, 2048, 4096)

# Above this many off-diagonal edges the tier census samples whole output
# blocks instead of counting every edge's pair (rank_tiers docstring) —
# keeps layout build O(seconds) at ogbn-products scale (~123M edges).
CENSUS_EDGE_LIMIT = 10_000_000


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class HybridGraph:
    """Three-tier layout.  Rows = original (possibly rabbit-reordered) node
    order, zero-padded at the end to ``num_rows`` — no relabeling, so the
    layout composes with any upstream permutation and across layers."""

    num_rows: int  # multiple of max(diag_b, res_ob, 512)
    real_nodes: int
    degrees: np.ndarray  # [R] f32 sqrt-degrees (1.0 on pad rows)
    row_mask: np.ndarray  # [R] f32, 1 on real rows
    # hot tier (0 = disabled).  Bit arrays are stored TRANSPOSED
    # ([words, rows]), the reference's device layout (spmm_pallas module
    # docstring).
    hot_k: int
    hot_ids: np.ndarray  # [K] int32 row ids of hot destinations
    hot_bits: np.ndarray  # [K/16, R] uint16, transposed bit-major
    # diagonal tier (0 = disabled)
    diag_b: int
    diag_bits: np.ndarray  # [B/16, R] uint16, transposed, cols block-local
    # residual tier (res_dst.size == 0 = disabled).  One slot = one unique
    # (out-block, destination) pair; the multi-hot mask says which of the
    # block's res_ob rows it feeds (dedup: one gather serves every edge
    # sharing the pair).  The layout stores the TWO-STAGE chain (stage 1
    # compacts unique destinations, stage 2 feeds slots from the table);
    # the port's device tensors precompose it into one id per slot
    # (``res_src``) for the kernels' own gather.
    res_gather: np.ndarray  # [Ud] int32 unique destination rows (stage 1)
    res_dst: np.ndarray  # [M_pad] int32 index into res_gather per slot
    res_mask: np.ndarray  # [res_ob/32, M_pad] uint32 multi-hot, transposed
    # same bits in slot-major orientation ([res_tile/16, T*res_ob] uint16,
    # slot s in word s % S16 bit s // S16, out rows on lanes) — the layout
    # the transposed residual kernel unpacks directly (residual_combine_t)
    res_mask_s: np.ndarray  # [res_tile/16, T*res_ob] uint16
    res_t2b: np.ndarray  # [T] int32 out-block of each tile
    res_tile: int
    res_ob: int
    # stats
    num_hot_edges: int = 0
    num_diag_edges: int = 0
    num_res_edges: int = 0
    num_res_pairs: int = 0  # unique (block, dst) pairs
    num_res_slots: int = 0  # including padding
    # True when every res_ob block has >=1 residual tile: the kernel then
    # writes every output row and the caller skips the visited-block
    # select (a full [D, R] read+write pass)
    res_covers_all: bool = False
    # True when the priced slot stream is short enough that ONE gather
    # from full x (res_gather[res_dst] precomposed) beats the two-stage
    # compact-then-feed chain: the full-table per-row premium costs less
    # than the dropped gather op's in-context ramp (DESIGN.md §8 win
    # condition; the small-graph regime where per-op ramps dominate)
    res_single: bool = False
    # how the tier probe chose (diag_b, hot_k): "timed N layouts", "cached"
    # (a verdict replayed from the probe cache) or "not run" (the cost
    # model's pick, or tiers the caller fixed).  Set by _maybe_probe_tiers
    # on the layout it returns; not a field, so that the fields stay the
    # JAX package's
    tier_probe = "not run"
    # the hot tier as per-row lists (``pack_hot_list``), where they take
    # fewer bytes than its slab (``hot_list_wins``); None otherwise.  Set
    # by build_hybrid; not fields, as tier_probe
    hot_ptr = None  # [R+1] int32 list offsets
    hot_src = None  # [nnz] int32 entry -> x row

    def pad_array(self, a: np.ndarray) -> np.ndarray:
        """Node-indexed array -> kernel row space (zero-pad the tail)."""
        a = np.asarray(a)
        out = np.zeros((self.num_rows,) + a.shape[1:], dtype=a.dtype)
        out[: self.real_nodes] = a
        return out

    def unpad_array(self, a: np.ndarray) -> np.ndarray:
        return np.asarray(a)[: self.real_nodes]


def choose_hot_k(
    column_index: np.ndarray,
    num_nodes: int,
    num_edges: int,
    max_k: int = 4096,
    gather_ns: float = GATHER_SLOT_NS * RESID_PAD_EST,
    slab_ns_per_col: float | None = None,
) -> int:
    """Hot-set size from the coverage curve + measured cost model: K slab
    columns cost ``R·K·SLAB_B_NS`` per SpMM and save
    ``covered · gather_ns``.  (The param.py:51 decider analog.)"""
    if num_edges == 0 or num_nodes == 0:
        return 0
    per_col = (
        slab_ns_per_col
        if slab_ns_per_col is not None
        else SLAB_B_NS * num_nodes
    )
    counts = np.bincount(column_index, minlength=num_nodes)
    csum = np.cumsum(np.sort(counts)[::-1])
    best_k, best_cost = 0, float(num_edges) * gather_ns
    for k in HOT_CANDIDATES:
        if k == 0 or k > num_nodes or k > max_k:
            continue
        cost = k * per_col + (num_edges - int(csum[k - 1])) * gather_ns
        if cost < best_cost:
            best_k, best_cost = k, cost
    return best_k


def _id_dtype(num_nodes: int):
    return np.int32 if num_nodes <= np.iinfo(np.int32).max else np.int64


class EdgeCensus:
    """A graph's edges in destination-major order, ``(dst, src)``
    ascending, from one sort: what the tier census counts.

    In that order the unique (``src // ob``, dst) pairs of any subset of
    the edges that keeps the order are the starts of its runs (a pair
    starts where dst or ``src // ob`` changes), so each candidate's pair
    census is one linear pass (``pair_census``, ``block_pairs``), not a
    sort of its keys.  Ids are int32 where they fit.  The census also
    keeps the ranked lists ``rank_tiers`` priced over it (``ranked``), so
    that a repeat of one call is served without pricing it again.  Build
    one per graph and pass it on; ``subset`` gives the census of some of
    its edges.

    Counters: ``census.sorts`` (censuses sorted), ``census.passes``
    (candidate passes counted), ``census.reused`` (ranked lists served
    again).  Spans: ``census.sort`` here, ``census.rank`` in
    ``rank_tiers``."""

    def __init__(self, src, dst, num_nodes: int, *, ordered: bool = False):
        """The census of the edges ``src[i] -> dst[i]``; ``ordered``: they
        are already in destination-major order (no sort)."""
        self.num_nodes = num_nodes
        ids = _id_dtype(num_nodes)
        if ordered:
            self.src = np.asarray(src, dtype=ids)
            self.dst = np.asarray(dst, dtype=ids)
        else:
            with profiling.span("census.sort"):
                key = np.asarray(dst, dtype=np.int64) * np.int64(num_nodes + 1)
                key += np.asarray(src, dtype=np.int64)
                key.sort()
                d, s = np.divmod(key, np.int64(num_nodes + 1))
                self.dst, self.src = d.astype(ids), s.astype(ids)
            profiling.count("census.sorts")
        self.ranked: dict = {}

    @classmethod
    def of_graph(cls, graph: GraphCSR) -> "EdgeCensus":
        n = graph.num_nodes
        rp = np.asarray(graph.row_pointers, dtype=np.int64)
        src = np.repeat(np.arange(n, dtype=_id_dtype(n)), np.diff(rp))
        return cls(src, graph.column_index, n)

    def __len__(self) -> int:
        return len(self.dst)

    def subset(self, keep: np.ndarray) -> "EdgeCensus":
        """The census of the edges ``keep`` (a mask in this order) selects."""
        return EdgeCensus(self.src[keep], self.dst[keep], self.num_nodes,
                          ordered=True)

    def off_diagonal(self, diag_b: int) -> np.ndarray:
        """Mask of the edges whose endpoints lie in different ``diag_b``
        blocks (all edges where ``diag_b`` is 0)."""
        if not diag_b:
            return np.ones(len(self), dtype=bool)
        return self.src // diag_b != self.dst // diag_b

    def pair_census(self, diag_b: int, ob: int):
        """``(off_dst, pairs_per_dst, pairs, stride)``: the destinations of
        the edges off the ``diag_b`` diagonal (all edges where 0), and the
        unique (``src // ob``, dst) pairs among them, per destination
        (``[num_nodes]``) and in all.  Above ``CENSUS_EDGE_LIMIT`` such
        edges the pairs are those of a pseudo-random (hash-selected)
        1/``stride`` of whole ``ob``-blocks (``rank_tiers``)."""
        if diag_b:
            keep = self.off_diagonal(diag_b)
            off_dst, blk = self.dst[keep], self.src[keep] // ob
        else:
            off_dst, blk = self.dst, self.src // ob
        stride, dst = 1, off_dst
        if len(off_dst) > CENSUS_EDGE_LIMIT:
            stride = -(-len(off_dst) // CENSUS_EDGE_LIMIT)
            # pseudo-random block sample via a multiplicative hash —
            # NOT blk % stride, which would always keep block 0 and bias
            # toward whatever structure lives at low node ids after
            # reordering (communities/hubs)
            ids = np.arange(self.num_nodes // ob + 1, dtype=np.int64)
            h = (ids * np.int64(2654435761)) & np.int64(0xFFFFFFFF)
            sel = ((h % stride) == 0)[blk]
            dst, blk = off_dst[sel], blk[sel]
        start = _pair_starts(dst, blk)
        pairs_per_dst = np.bincount(dst[start], minlength=self.num_nodes)
        return off_dst, pairs_per_dst, int(np.count_nonzero(start)), stride

    def block_pairs(self, ob: int) -> np.ndarray:
        """Unique (``src // ob``, dst) pairs per ``ob``-block, up to the
        last block with an edge."""
        blk = self.src // ob
        return np.bincount(blk[_pair_starts(self.dst, blk)])

    def residual(self, diag_b: int, hot_k: int) -> "EdgeCensus":
        """The census of the residual tier's edges: neither on the
        diagonal nor into one of the ``hot_k`` hot destinations."""
        keep = self.off_diagonal(diag_b)
        if hot_k:
            hot = np.zeros(self.num_nodes, dtype=bool)
            hot[hot_rows(self.dst[keep], self.num_nodes, hot_k)] = True
            keep &= ~hot[self.dst]
        return self.subset(keep)


def hot_rows(off_dst: np.ndarray, num_nodes: int, hot_k: int) -> np.ndarray:
    """The hot tier's destinations: the ``hot_k`` most frequent in
    ``off_dst`` (the off-diagonal edges' destinations), most frequent
    first, less those with no edge; int32."""
    counts = np.bincount(off_dst, minlength=num_nodes)
    top = np.argsort(counts)[::-1][:hot_k].astype(np.int32)
    return top[counts[top] > 0]


def _pair_starts(dst: np.ndarray, blk: np.ndarray) -> np.ndarray:
    """Mask of the first edge of each unique (``blk``, dst) pair, for
    edges in destination-major order (``blk`` non-decreasing within each
    destination): where dst or ``blk`` changes."""
    start = np.empty(len(dst), dtype=bool)
    start[:1] = True
    np.not_equal(dst[1:], dst[:-1], out=start[1:])
    start[1:] |= blk[1:] != blk[:-1]
    profiling.count("census.passes")
    return start


def choose_tiers(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    hot_k: int | None = None,
    diag_b: int | None = None,
    res_ob: int = 1024,
    census: EdgeCensus | None = None,
) -> tuple[int, int]:
    """Model-ranked tier choice: ``rank_tiers(...)[0]`` (see there)."""
    ranked = rank_tiers(src, dst, num_nodes, hot_k=hot_k, diag_b=diag_b,
                        res_ob=res_ob, census=census)
    return ranked[0][1], ranked[0][2]


def rank_tiers(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    hot_k: int | None = None,
    diag_b: int | None = None,
    res_ob: int = 1024,
    census: EdgeCensus | None = None,
) -> list[tuple[float, int, int]]:
    """Rank every feasible (diag_b, hot_k) candidate by the measured
    pipeline cost model — ascending ``(cost_ns, diag_b, hot_k)``.

    Jointly prices ``max(slab_compute, residual_gather_stream)`` where
    ``slab = R·(SLAB_A + SLAB_B·(B+K))`` and ``gathers = RESID_FIX +
    min(two-stage, single-stage)`` over the gather formulations.
    The max form is the reference's fit: there the slab pass overlaps
    the residual gather chain (the gathers hide the slab compute entirely
    at tuned tiers, gnnadvisor_osdi21_tpu/bench/breakdown.py).

    Every feasible candidate is priced with the *exact* unique
    (out-block, dst) pair and unique dst counts — the quantities the
    residual kernel actually pays for.  (An earlier coarse pass with a
    fixed dedup estimate systematically under-ranked small tiers, whose
    residuals dedup 3-5x.)  The census is ONE linear pass over the
    edges in destination-major order per diag candidate (``census``, the
    ``EdgeCensus`` of ``src -> dst``; built from them when None): hot
    sets are nested along the in-degree order, so every hot_k candidate
    reads its pair count off a cumulative sum, and the stage-1
    unique-dst count follows from the degree histogram alone.  Above
    ``CENSUS_EDGE_LIMIT`` edges the pair census samples a pseudo-random
    (hash-selected) 1/stride of whole output blocks — pairs partition by
    block, so ``stride x sampled-count`` is unbiased over the block
    sample; below the limit the census is exact.  Fixing either
    parameter (manual mode) restricts the search to the other; fixing
    both passes through (param.py:58-70).  A list already priced over
    ``census`` with the same arguments is served again.
    """
    e = len(src)
    if e == 0:
        return [(0.0, diag_b or 0, hot_k or 0)]
    if diag_b is not None and hot_k is not None:
        return [(0.0, diag_b, hot_k)]
    if census is None:
        census = EdgeCensus(src, dst, num_nodes)
    memo = (diag_b, hot_k, res_ob)
    if memo in census.ranked:
        profiling.count("census.reused")
    else:
        with profiling.span("census.rank"):
            census.ranked[memo] = _price_tiers(
                census, num_nodes, hot_k, diag_b, res_ob)
    return list(census.ranked[memo])


def _price_tiers(
    census: EdgeCensus,
    num_nodes: int,
    hot_k: int | None,
    diag_b: int | None,
    res_ob: int,
) -> list[tuple[float, int, int]]:
    """``rank_tiers``' pricing over its census (see there)."""
    b_cands = DIAG_CANDIDATES if diag_b is None else (diag_b,)
    cands: list[tuple[float, int, int]] = []
    for b in b_cands:
        # skip oversized *auto* candidates only: a manually fixed diag_b
        # passes through (build_hybrid rounds num_rows up to it)
        if b and b > _round_up(num_nodes, 512) and diag_b is None:
            continue
        rows = _round_up(max(num_nodes, 1), max(b, 512))
        # --- pair census, shared by every hot_k candidate ----------------
        od, pairs_per_dst, u_total, stride = census.pair_census(b, res_ob)
        # hot curve on off-diagonal edges only: hubs that are mostly local
        # do not earn a hot column
        counts = np.bincount(od, minlength=num_nodes)
        order = np.argsort(counts)[::-1]
        # making a dst hot removes ALL its pairs and its stage-1 gather row
        cum_pairs = np.cumsum(pairs_per_dst[order])
        nz_dst = int(np.count_nonzero(counts))
        cum_nzdst = np.cumsum(counts[order] > 0)
        k_cands = HOT_CANDIDATES if hot_k is None else (hot_k,)
        for k in k_cands:
            if k > num_nodes and k != (hot_k or 0):
                continue
            kk = min(k, num_nodes)
            bits_bytes_per_row = (b + k) // 8
            if rows * bits_bytes_per_row > SLAB_MEM_CAP_BYTES:
                continue  # candidate would blow the HBM budget
            # SLAB_A is charged even with both tiers off: it is the fixed
            # per-output-column pipeline cost (block accumulate + final
            # combine), which the fit attributes per column regardless.
            slab = rows * (
                SLAB_A_NS
                + SLAB_B_NS * (b + k)
                # streaming the bit rows from HBM each pass
                + bits_bytes_per_row / HBM_BYTES_PER_NS
            )
            if len(od):
                uniq = stride * (
                    u_total - (int(cum_pairs[kk - 1]) if kk else 0)
                )
                uniq_dst = nz_dst - (int(cum_nzdst[kk - 1]) if kk else 0)
            else:
                uniq = uniq_dst = 0
            slots_est = uniq * RESID_PAD_EST
            if uniq:
                # min over gather formulations: two-stage (compact table)
                # vs a single gather from full x, which drops the second
                # op's in-context ramp (two-stage only pays once the slot
                # stream far outgrows the unique-dst census)
                gathers = RESID_FIX_NS + min(
                    GATHER_BIG_NS * uniq_dst
                    + GATHER_SLOT_NS * slots_est
                    + RES_STAGE2_FIX_NS,
                    GATHER_SINGLE_NS * slots_est,
                ) - RES_STAGE2_FIX_NS
            else:
                gathers = 0.0
            if k:
                gathers += HOT_FIX_NS  # the hot table gather is its own op
            combine = (
                RES_CELL_NS * res_ob * slots_est
                + RES_TILE_STEP_NS * slots_est / 256.0
            ) if uniq else 0.0
            # the model's structure: the slab pass (compute) hides under
            # the gather chain, but the overlap degrades quadratically as
            # the two streams approach parity (wide slabs leak into the
            # critical path; the unit-leak coefficient keeps the
            # reference's ordering of wide diagonal tiers once the
            # in-context RESID_FIX dominates the gather arm); the
            # dependent combine kernel then runs after the chain.
            hi, lo = max(slab, gathers), min(slab, gathers)
            leak = (lo / hi) ** 2 if hi > 0 else 0.0
            cost = hi * (1.0 + leak) + combine
            cands.append((cost, b, k))
    # every candidate hit the memory cap: tiers off
    return sorted(cands) or [(0.0, diag_b or 0, hot_k or 0)]


# residual-geometry candidates for the adaptive choice (choose_res_geometry)
RES_OB_CANDIDATES = (512, 1024, 2048, 4096, 8192, 16384)
RES_TILE_CANDIDATES = (128, 256)
RES_TILE_STEP_NS = 179.0  # the reference's combine grid-step overhead


def model_pipeline_ns(hg: HybridGraph) -> dict:
    """The cost model's time of one SpMM over a BUILT layout, from its
    exact censuses (slots include real padding, not the RESID_PAD_EST
    estimate), term by term: the JAX package's ``model_pipeline_ns``
    (graphs/hybrid.py:408-446 there), with its TPU v5e constants, so it
    prices the layout as the JAX decider does, not as the card runs it."""
    slab_cols = hg.diag_b + hg.hot_k
    slab = hg.num_rows * (
        SLAB_A_NS + SLAB_B_NS * slab_cols
        + (slab_cols // 8) / HBM_BYTES_PER_NS
    ) if slab_cols else 0.0
    # HOT_FIX_NS is charged whenever the hot tier exists, independent of
    # the residual branch, as in choose_tiers' cost for hot-only layouts
    if hg.num_res_slots:
        if hg.res_single:
            gathers = (
                RESID_FIX_NS - RES_STAGE2_FIX_NS
                + GATHER_SINGLE_NS * hg.num_res_slots
            )
        else:
            gathers = (
                RESID_FIX_NS
                + GATHER_BIG_NS * len(hg.res_gather)
                + GATHER_SLOT_NS * hg.num_res_slots
            )
    else:
        gathers = 0.0
    if hg.hot_k:
        gathers += HOT_FIX_NS
    combine = (
        RES_CELL_NS * hg.num_res_slots * hg.res_ob
        + RES_TILE_STEP_NS * len(hg.res_t2b)
    ) if hg.num_res_slots else 0.0
    # the slab pass hides under the residual gather chain with a quadratic
    # leak as the streams approach parity (choose_tiers); the combine runs
    # after the chain
    hi, lo = max(slab, gathers), min(slab, gathers)
    total = (hi * (1.0 + (lo / hi) ** 2) if hi > 0 else 0.0) + combine
    return {
        "slab_ns": slab,
        "gather_ns": gathers,
        "combine_ns": combine,
        "total_ns": total,
    }


def choose_res_geometry(
    rs: np.ndarray, rd: np.ndarray, num_nodes: int,
    row_align: int = 512, row_cost_ns: float = 0.0,
    census: EdgeCensus | None = None,
) -> tuple[int, int]:
    """Pick (res_ob, res_tile) for the residual tier from its exact pair
    census: cost = slots·(GATHER_SLOT + SLAB_B·OB) + tiles·step_overhead,
    where ``slots`` is the per-block padded count (bigger blocks dedup
    more pairs AND pad fewer tiles, but the combine unpack grows with OB).
    Input-adaptive like the slab tiers: compound collections (Type II,
    few pairs spread over many blocks) want huge sparse blocks, web graphs
    (dense pair streams) want 1024 (the reference's grids on both).

    ``row_align``/``row_cost_ns``: the chosen ob also inflates the layout's
    padded row count (num_rows rounds up to max(diag_b, ob, align) in
    build_hybrid) — every extra padded row pays the slab pipeline's
    per-output-column cost, so a big ob must EARN its padding on small
    graphs (ADVICE r3: choose_tiers and this chooser were priced against
    inconsistent layouts).

    ``census``: the ``EdgeCensus`` of ``rs -> rd`` (built from them when
    None); each candidate's census is one linear pass over it."""
    if not len(rs):
        return 1024, 256
    if census is None:
        census = EdgeCensus(rs, rd, num_nodes)
    base_rows = _round_up(max(num_nodes, 1), row_align)
    best = None
    for ob in RES_OB_CANDIDATES:
        counts_b = census.block_pairs(ob)
        pad_rows = _round_up(max(num_nodes, 1), max(row_align, ob)) - base_rows
        for rt in RES_TILE_CANDIDATES:
            slots = int((-(-counts_b // rt) * rt).sum())
            tiles = slots // rt
            cost = (
                slots * (GATHER_SLOT_NS + RES_CELL_NS * ob)
                + tiles * RES_TILE_STEP_NS
                + pad_rows * row_cost_ns
            )
            if best is None or cost < best[0]:
                best = (cost, ob, rt)
    return best[1], best[2]


def choose_layout_tiers(
    census: EdgeCensus | None,
    num_nodes: int,
    diag_b: int | None = None,
    hot_k: int | None = None,
    res_tile: int | None = None,
    res_ob: int | None = None,
    row_align: int = 512,
) -> tuple[int, int, int, int, list[tuple[float, int, int]]]:
    """``(diag_b, hot_k, res_ob, res_tile, ranked)`` of a layout: the
    values given, and the model's choice for those left None, over the
    graph's ``census`` (None only where nothing is left to choose).

    Tier choice and residual geometry feed each other (``rank_tiers``
    prices the pair census at a given res_ob; the chosen ob in turn
    changes which tiers pay off), so iterate to a consistent fixed point
    — at most two passes, since the second pass re-prices at the geometry
    the layout will actually be built with (ADVICE r3).  The geometry
    chooser is charged the padded-row cost the chosen diag block implies.
    ``ranked`` is the last pass's ranking, for the tier probe."""
    if census is None:  # nothing is left to choose
        return diag_b, hot_k, res_ob, res_tile, [(0.0, diag_b, hot_k)]
    census_ob = res_ob or 1024
    for _ in range(2):
        ranked = rank_tiers(census.src, census.dst, num_nodes, hot_k=hot_k,
                            diag_b=diag_b, res_ob=census_ob, census=census)
        b, k = ranked[0][1], ranked[0][2]
        if res_ob is None or res_tile is None:
            rc = census.residual(b, k)
            auto_ob, auto_rt = choose_res_geometry(
                rc.src, rc.dst, num_nodes, row_align=max(b, row_align),
                row_cost_ns=SLAB_A_NS + SLAB_B_NS * (b + k), census=rc,
            )
            chosen_ob, chosen_rt = res_ob or auto_ob, res_tile or auto_rt
        else:
            chosen_ob, chosen_rt = res_ob, res_tile
        if chosen_ob == census_ob:
            break
        census_ob = chosen_ob  # re-price the tiers at the real geometry
    return b, k, chosen_ob, chosen_rt, ranked


def build_hybrid(
    graph: GraphCSR,
    hot_k: int | None = None,
    diag_b: int | None = None,
    res_tile: int | None = None,
    res_ob: int | None = None,
    row_align: int = 512,
    probe: bool | None = None,
    device=None,
    census: EdgeCensus | None = None,
) -> HybridGraph:
    """Build the three-tier layout.  ``hot_k``/``diag_b`` default to the
    measured-cost-model choice (``choose_tiers``); ``res_ob``/``res_tile``
    to the residual-census choice (``choose_res_geometry``); pass explicit
    values (including 0 to disable a tier) for manual mode / studies.

    ``probe``: the measured-probe autotune of auto tiers
    (``_maybe_probe_tiers``).  None probes where the JAX package's would
    on its TPU: when ``device`` (where the layout will run; None: not
    known, which does not probe) is a CUDA device.  True forces it, on
    ``device`` (None: the card); False trusts the model.  With the probe
    off the layout equals the JAX package's ``build_hybrid(...,
    probe=False)``.

    ``census``: the graph's ``EdgeCensus`` (``EdgeCensus.of_graph``, built
    here when None and a choice is left to the model); a ranked list
    already priced over it (the decider's) is not priced again.
    """
    n = graph.num_nodes
    if diag_b is not None and diag_b % 512:
        raise ValueError(f"diag_b {diag_b} must be a multiple of 512")
    if hot_k is not None and hot_k % 32:
        raise ValueError(f"hot_k {hot_k} must be a multiple of 32")
    in_diag_b, in_hot_k = diag_b, hot_k  # user-fixed (None = auto)
    in_res_tile, in_res_ob = res_tile, res_ob
    with profiling.span("layout.tiers"):
        if census is None and None in (diag_b, hot_k, res_ob, res_tile):
            census = EdgeCensus.of_graph(graph)
        diag_b, hot_k, res_ob, res_tile, ranked = choose_layout_tiers(
            census, n, diag_b=diag_b, hot_k=hot_k, res_tile=res_tile,
            res_ob=res_ob, row_align=row_align,
        )
        rp = np.asarray(graph.row_pointers, dtype=np.int64)
        ci = np.asarray(graph.column_index, dtype=np.int64)
        src = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))

        # --- classify edges: diag > hot > residual --------------------------
        if diag_b:
            in_diag = (src // diag_b) == (ci // diag_b)
        else:
            in_diag = np.zeros(len(src), dtype=bool)
        if hot_k:
            # columns with no edges stay padding
            top = hot_rows(ci[~in_diag], n, hot_k)
            hot_col = np.full(n, -1, dtype=np.int64)
            hot_col[top] = np.arange(len(top))
            in_hot = (~in_diag) & (hot_col[ci] >= 0)
        else:
            top = np.zeros(0, dtype=np.int32)
            in_hot = np.zeros(len(src), dtype=bool)
        in_res = ~(in_diag | in_hot)
    num_rows = _round_up(max(n, 1), max(diag_b, res_ob, row_align))

    if hot_k:
        # Padding columns never set a bit, so any id is *correct*; point
        # them at a dedicated zero row (the first pad row) so they gather
        # zeros, not K-len(top) copies of a real row — no wasted bandwidth
        # and no footgun if hot_ids is ever used without the bit mask.
        # (n == num_rows only when n is already tier-aligned; then there is
        # no pad row and row 0 is the harmless fallback.)
        pad_id = n if n < num_rows else 0
        hot_ids = np.full(hot_k, pad_id, dtype=np.int32)
        hot_ids[: len(top)] = top
    else:
        hot_ids = np.zeros(0, dtype=np.int32)

    # --- bit slabs (stored transposed: [words, rows], uint16) -------------
    num_hot_edges = int(in_hot.sum())
    hot_ptr = hot_src = None
    with profiling.span("layout.pack_slabs"):
        if hot_k:
            hrow, hcol = src[in_hot], hot_col[ci[in_hot]]
            hot_bits = pack_slab_bits_t(hrow, hcol, num_rows, hot_k)
            if hot_list_wins(hot_k, num_rows, num_hot_edges):
                hot_ptr, hot_src = pack_hot_list(
                    hrow, hcol, num_rows, hot_k, hot_ids)
                profiling.count("hot_list.builds")
                profiling.count("hot_list.entries", len(hot_src))
        else:
            hot_bits = np.zeros((0, num_rows), dtype=np.uint16)
        if diag_b:
            diag_bits = pack_slab_bits_t(
                src[in_diag], ci[in_diag] % diag_b, num_rows, diag_b
            )
        else:
            diag_bits = np.zeros((0, num_rows), dtype=np.uint16)

    # --- residual slot stream -------------------------------------------
    # One slot per unique (out-block, destination) pair; the multi-hot
    # mask fans one gathered row out to every block row that wants it
    # (the dedup is what the residual saves: gathers are its cost).
    with profiling.span("layout.residual_stream"):
        rs, rd = src[in_res], ci[in_res]
        res_gather, res_dst, res_mask, res_mask_s, res_t2b, num_res_pairs = (
            build_residual_stream(rs, rd, n, num_rows, res_tile, res_ob)
        )
    # gather formulation: one full-x gather vs compact-then-feed (the
    # RES_STAGE2_FIX_NS rationale above; priced from the exact censuses)
    res_single = bool(len(res_dst)) and (
        GATHER_SINGLE_NS * len(res_dst)
        < GATHER_BIG_NS * len(res_gather)
        + GATHER_SLOT_NS * len(res_dst)
        + RES_STAGE2_FIX_NS
    )

    degrees = np.ones(num_rows, dtype=np.float32)
    degrees[:n] = graph.degrees
    row_mask = np.zeros(num_rows, dtype=np.float32)
    row_mask[:n] = 1.0

    hg = HybridGraph(
        num_rows=num_rows,
        real_nodes=n,
        degrees=degrees,
        row_mask=row_mask,
        hot_k=hot_k,
        hot_ids=hot_ids,
        hot_bits=hot_bits,
        diag_b=diag_b,
        diag_bits=diag_bits,
        res_gather=res_gather,
        res_dst=res_dst,
        res_mask=res_mask,
        res_mask_s=res_mask_s,
        res_t2b=res_t2b,
        res_tile=res_tile,
        res_ob=res_ob,
        num_hot_edges=num_hot_edges,
        num_diag_edges=int(in_diag.sum()),
        num_res_edges=int(in_res.sum()),
        num_res_pairs=num_res_pairs,
        num_res_slots=len(res_dst),
        res_covers_all=(
            len(np.unique(res_t2b)) == num_rows // res_ob
        ),
        res_single=res_single,
    )
    hg.hot_ptr, hg.hot_src = hot_ptr, hot_src
    if probe is not False and (in_diag_b is None or in_hot_k is None):
        with profiling.span("layout.probe") as rec:
            hg = _maybe_probe_tiers(
                graph, hg, ranked, probe, device,
                res_tile=in_res_tile, res_ob=in_res_ob, row_align=row_align,
                census=census,
            )
            rec.attrs["tiers"] = hg.tier_probe
    return hg


# --- measured-probe autotune (hybrid.py:670-835 in the JAX package) ---------
# The cost model ranks reliably at the extremes but not within close
# families.  When its top candidates are within the error band, or the
# graph is small enough that building and probing costs seconds, build
# the top candidates and time one SpMM each; pick the measured winner.
# The constants are the reference's.
PROBE_TOP = 3  # layouts built and timed
PROBE_BAND = 1.35  # probe when cost2 <= cost1 * band
PROBE_ROW_LIMIT = 150_000  # always probe below this many rows
PROBE_BUILD_ROW_CAP = 3_000_000  # default-auto never probes above this
PROBE_ITERS = 100
PROBE_MARGIN = 0.05  # a challenger must beat the model pick by >5%
# bump when the probe protocol/constants change, or what it times (2: the
# transposed hot tier walked as per-row lists, pack_hot_list)
PROBE_CACHE_VERSION = 2
CACHE_DIR_ENV = "GNNADVISOR_TORCH_CACHE_DIR"  # overrides the cache directory
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_cache"
)


def _probe_spmm_time(hg: HybridGraph, device) -> float:
    """Seconds per SpMM over a built layout on ``device``: the transposed
    bf16 layout, x = ones [16, R] f32, ``sag`` timed by the two-point
    marginal (``utils.timing.chained_marginal_time``).  Module-level so
    that tests can pin the probe path with a fake timer."""
    from gnnadvisor_osdi21_tpu_torch.ops.aggregate import sag
    from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import build_hybrid_tensors
    from gnnadvisor_osdi21_tpu_torch.utils.timing import chained_marginal_time

    ht = build_hybrid_tensors(
        hg, device=device, agg_dtype="bfloat16", transposed=True
    )
    x = torch.ones((16, hg.num_rows), dtype=torch.float32, device=device)
    with torch.no_grad():
        sec, _ = chained_marginal_time(
            lambda a, h: sag(a, h), x, ht, iters=PROBE_ITERS, reps=3
        )
    return sec


def _device_name(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def graph_fingerprint(graph: GraphCSR) -> str:
    """adler32 of column_index (int32), then of row_pointers (int64)."""
    ci = np.asarray(graph.column_index, dtype=np.int32)
    h = zlib.adler32(ci.tobytes())
    h = zlib.adler32(np.asarray(graph.row_pointers, np.int64).tobytes(), h)
    return f"{h:08x}"


def _probe_cache_key(graph: GraphCSR, cands, device) -> str:
    """The reference's fingerprint of (graph, candidate set), prefixed
    with the device's name: a verdict is replayed only on the card that
    measured it."""
    cand_sig = ",".join(f"{b}:{k}" for _, b, k in cands)
    return (
        f"{_device_name(device)}|v{PROBE_CACHE_VERSION}-n{graph.num_nodes}-"
        f"e{graph.nnz}-{graph_fingerprint(graph)}-[{cand_sig}]"
    )


def cache_dir() -> str:
    """The port's cache directory: ``$GNNADVISOR_TORCH_CACHE_DIR``, else
    the git-ignored ``_cache/`` inside the package."""
    return os.environ.get(CACHE_DIR_ENV) or _DEFAULT_CACHE_DIR


def _probe_cache_path() -> str:
    return os.path.join(cache_dir(), "probe_cache.json")


def _probe_cache_get(key: str):
    path = _probe_cache_path()
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fp:
            return json.load(fp).get(key)
    except (OSError, ValueError):
        return None


def _probe_cache_put(key: str, value) -> None:
    path = _probe_cache_path()
    try:
        data = {}
        if os.path.exists(path):
            with open(path) as fp:
                data = json.load(fp)
        data[key] = value
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fp:
            json.dump(data, fp, indent=0)
    except (OSError, ValueError):
        pass  # the cache is best-effort


def _maybe_probe_tiers(
    graph: GraphCSR,
    hg: HybridGraph,
    ranked: list[tuple[float, int, int]],
    probe: bool | None,
    device,
    res_tile: int | None,
    res_ob: int | None,
    row_align: int,
    census: EdgeCensus | None = None,
) -> HybridGraph:
    """Probe the model's top tier candidates on ``device``; return the
    measured winner (``hg`` where probing is not warranted).  The model's
    pick is the first candidate, and a challenger must beat it by more
    than ``PROBE_MARGIN``.  Verdicts are cached (``_probe_cache_path``)
    under the device's name and the graph's fingerprint.  The layout
    returned records how its tiers were chosen (``tier_probe``).  The
    candidates' layouts are built over ``census``, the graph's."""
    cands = list(ranked[:PROBE_TOP])
    if len(cands) < 2:
        return hg
    if probe is None:
        if device is None or torch.device(device).type != "cuda":
            return hg
        if graph.num_nodes > PROBE_BUILD_ROW_CAP:
            return hg
        close = cands[1][0] <= cands[0][0] * PROBE_BAND
        if graph.num_nodes > PROBE_ROW_LIMIT and not close:
            return hg
    device = resolve_device(device)
    key = _probe_cache_key(graph, cands, device)
    hit = _probe_cache_get(key)
    if hit is not None:
        profiling.count("probe.cache_hits")
        b, k = int(hit[0]), int(hit[1])
        if (b, k) != (hg.diag_b, hg.hot_k):
            hg = build_hybrid(
                graph, hot_k=k, diag_b=b, res_tile=res_tile, res_ob=res_ob,
                row_align=row_align, probe=False, census=census,
            )
        hg.tier_probe = "cached"
        return hg
    base_sec, best_sec, best_hg = None, None, hg
    for _, b, k in cands:
        cand = hg if (b == hg.diag_b and k == hg.hot_k) else build_hybrid(
            graph, hot_k=k, diag_b=b, res_tile=res_tile, res_ob=res_ob,
            row_align=row_align, probe=False, census=census,
        )
        sec = _probe_spmm_time(cand, device)
        profiling.count("probe.runs")
        if base_sec is None:
            base_sec = sec
        if best_sec is None or sec < best_sec:
            best_sec, best_hg = sec, cand
    if base_sec is not None and best_sec >= base_sec * (1.0 - PROBE_MARGIN):
        best_hg = hg  # no significant measured win: trust the model
    _probe_cache_put(key, [best_hg.diag_b, best_hg.hot_k])
    best_hg.tier_probe = f"timed {len(cands)} layouts"
    return best_hg


def _round_up_arr(x: np.ndarray, m: int) -> np.ndarray:
    return -(-x // m) * m


def build_residual_stream(
    rs: np.ndarray,
    rd: np.ndarray,
    col_space: int,
    num_rows: int,
    res_tile: int,
    res_ob: int,
    cover_all: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Residual tier construction, shared with the multi-chip layout.

    ``rs``: output rows in [0, num_rows); ``rd``: gather-source ids in
    [0, col_space) — for the single-chip layout that's the same node space,
    for the sharded layout it's the per-device gather table (local block +
    received halo).  Returns ``(res_gather, res_dst, res_mask, res_mask_s,
    res_t2b, num_pairs)`` — one slot per unique (out-block, source) pair,
    multi-hot masks in BOTH bit orientations (``res_mask`` out-row-major
    [res_ob/32, M_pad] for the row-major kernel / CPU reference;
    ``res_mask_s`` slot-major uint16 [res_tile/16, T*res_ob] for the transposed
    kernel), tiles grouped per out-block (see HybridGraph fields).
    """
    n_blocks = num_rows // res_ob
    words = res_ob // 32
    sw = res_tile // 16
    if not len(rs):
        return (
            np.zeros(0, dtype=np.int32),
            np.zeros(0, dtype=np.int32),
            np.zeros((words, 0), dtype=np.uint32),
            np.zeros((sw, 0), dtype=np.uint16),
            np.zeros(0, dtype=np.int32),
            0,
        )
    blk = rs // res_ob
    key = blk * np.int64(col_space + 1) + rd
    ukey, inv = np.unique(key, return_inverse=True)
    u = len(ukey)
    ublk = ukey // (col_space + 1)
    udst = ukey % (col_space + 1)
    res_gather, udst_c = np.unique(udst, return_inverse=True)
    res_gather = res_gather.astype(np.int32)
    off = rs - blk * res_ob
    counts_b = np.bincount(ublk, minlength=n_blocks)
    padded_b = _round_up_arr(counts_b, res_tile)
    # Residual-free blocks are never visited by the combine grid, so the
    # caller selects their rows to zero.  ``cover_all=True`` instead adds
    # one all-zero dummy tile per empty block so the kernel writes the
    # zeros itself: an explicit knob (default off), as in the reference,
    # for hardware where the select is not fused away.
    if cover_all:
        padded_b = np.maximum(padded_b, res_tile)
    starts = np.concatenate(([0], np.cumsum(padded_b)))
    m_pad = int(starts[-1])
    res_dst = np.zeros(m_pad, dtype=np.int32)
    # position of each unique slot: block start + within-block index
    # (ukey is sorted, so slots arrive grouped by block)
    within = np.arange(u) - np.concatenate(([0], np.cumsum(counts_b)))[ublk]
    pos = starts[ublk] + within
    res_dst[pos] = udst_c.astype(np.int32)
    pu = pos[inv]  # per-edge global slot position
    # bit-major layout (output row o -> word o % words, bit o // words),
    # matching the slab kernels so the Pallas residual combine reuses the
    # same repeat+shift unpack (spmm_pallas._unpack_tile).  Built directly
    # in the transposed [words, M_pad] orientation with one per-edge OR:
    # building row-major and then transposing is a strided, cache-hostile
    # pass over the whole mask.
    res_mask_t = np.zeros((words, m_pad), dtype=np.uint32)
    np.bitwise_or.at(
        res_mask_t, (off % words, pu),
        np.uint32(1) << (off // words).astype(np.uint32),
    )
    res_t2b = np.repeat(np.arange(n_blocks, dtype=np.int32), padded_b // res_tile)
    # slot-major orientation (uint16 — see spmm_pallas._unpack_tile_t16):
    # per edge, slot pos -> (tile, slot-in-tile); lane = tile*res_ob +
    # out-row offset; bit-major within the slot axis.  Requires
    # res_tile % 16 == 0 (true for every production layout; tiny test
    # tiles fall back to an empty sentinel — the transposed kernel is
    # unusable there anyway).
    if sw > 0:
        n_tiles = m_pad // res_tile
        mask_s = np.zeros((sw, n_tiles * res_ob), dtype=np.uint16)
        si = pu % res_tile
        lane = (pu // res_tile) * res_ob + off
        np.bitwise_or.at(
            mask_s, (si % sw, lane), np.uint16(1) << (si // sw).astype(np.uint16)
        )
    else:
        mask_s = np.zeros((0, 0), dtype=np.uint16)
    return res_gather, res_dst, res_mask_t, mask_s, res_t2b, u


def pack_slab_bits_t(rows: np.ndarray, cols: np.ndarray, num_rows: int, k: int):
    """Device-layout slab builder: [K/16, R] uint16, bit-major — column j
    -> word j % (K/16), bit j // (K/16).  Built directly in the transposed
    orientation with one per-edge OR (spmm_pallas.py:749-761)."""
    w16 = k // 16
    bits = np.zeros((w16, num_rows), dtype=np.uint16)
    np.bitwise_or.at(
        bits, (cols % w16, rows), np.uint16(1) << (cols // w16).astype(np.uint16)
    )
    return bits


def hot_list_wins(hot_k: int, num_rows: int, num_hot_edges: int) -> bool:
    """Whether the hot tier's per-row lists take fewer bytes than its slab:
    4 an entry and 4 a row against the slab's 2·K/16 a row.  At amazon0505
    (hot 4096, 7.6 edges a row) about 35 against 512."""
    return bool(hot_k) and (
        4 * (num_hot_edges + num_rows + 1) < 2 * (hot_k // 16) * num_rows)


def pack_hot_list(rows: np.ndarray, cols: np.ndarray, num_rows: int,
                  hot_k: int, hot_ids: np.ndarray):
    """The hot tier's edges (row, slab column j) as per-row lists:
    ``hot_ptr`` int32 [R+1] and ``hot_src`` int32 [nnz], each row's entries
    in ascending j, each the row of x that column reads (``hot_ids[j]``).
    A repeated edge is kept once, as the slab's OR keeps it.  One sort of
    the keys row·K + j (``np.unique`` would take numpy's hash path)."""
    key = np.sort(np.asarray(rows, np.int64) * hot_k + cols)
    keep = np.ones(len(key), dtype=bool)
    keep[1:] = key[1:] != key[:-1]
    row, col = np.divmod(key[keep], hot_k)
    hot_ptr = np.zeros(num_rows + 1, dtype=np.int32)
    np.cumsum(np.bincount(row, minlength=num_rows), out=hot_ptr[1:])
    return hot_ptr, hot_ids[col].astype(np.int32)


def pack_slab_bits(rows: np.ndarray, cols: np.ndarray, num_rows: int, k: int):
    """Row-major slab builder, [R, K/32] uint32 (the oracle/probe view):
    column j -> word j % (K/32), bit j // (K/32) (spmm_pallas.py:715-726).
    Its transpose is the probes' legacy uint32 device layout."""
    w32 = k // 32
    bits = np.zeros((num_rows, w32), dtype=np.uint32)
    word = cols % w32
    bit = (cols // w32).astype(np.uint32)
    np.bitwise_or.at(bits, (rows, word), np.uint32(1) << bit)
    return bits


def transpose_slab(bits: np.ndarray):
    """[R, K/32] row-major uint32 view -> [K/16, R] uint16 device layout
    (column j -> word j % W16, bit j // W16), spmm_pallas.py:729-747.  It
    equals ``pack_slab_bits_t`` over the same edges."""
    r, w32 = bits.shape
    k = w32 * 32
    w16 = k // 16
    j = np.arange(k)
    dense = (
        (bits[:, j % w32] >> (j // w32).astype(np.uint32)) & np.uint32(1)
    ).astype(np.uint16)  # [R, K]
    out = np.zeros((w16, r), dtype=np.uint16)
    for b in range(16):
        out |= dense[:, b * w16 : (b + 1) * w16].T << np.uint16(b)
    return out
