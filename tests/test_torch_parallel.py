"""The port's sharding functions (``parallel/partition.py``,
``parallel/hybrid_partition.py``) against the JAX package's: every array
and scalar of ``shard_graph`` and ``shard_graph_hybrid`` byte-identical, at
1, 2, 4 and 8 devices, on the graphs the JAX package's multi-device tests
use.  Host-side NumPy only: no process group, no device."""

import dataclasses

import numpy as np
import pytest

from gnnadvisor_osdi21_tpu.graphs.loader import (
    synthesize_graph as jax_synthesize,
)
from gnnadvisor_osdi21_tpu.parallel.hybrid_partition import (
    shard_graph_hybrid as jax_shard_hybrid,
)
from gnnadvisor_osdi21_tpu.parallel.partition import (
    shard_graph as jax_shard,
)
from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu_torch.parallel.hybrid_partition import (
    shard_graph_hybrid,
)
from gnnadvisor_osdi21_tpu_torch.parallel.partition import shard_graph

DEVICES = [1, 2, 4, 8]

# (graph args, shard_graph_hybrid kwargs, expected res_single or None)
HYBRID_CASES = {
    # tests/test_dist_hybrid.py's setup: every tier forced on
    "community_diag512_hot512": (
        (3000, 40000, 16, 5, "community", 3),
        dict(diag_b=512, hot_k=512), None),
    # the cost model's tiers and geometry
    "community_auto": ((3000, 40000, 16, 5, "community", 3), {}, None),
    # the residual gather formulation both ways: the width gate turns the
    # single-stage form off at a wide aggregate
    "res_single": ((3000, 40000, 16, 5, "community", 3),
                   dict(diag_b=512, hot_k=0, agg_feature_dim=16), True),
    "res_two_stage": ((3000, 40000, 16, 5, "community", 3),
                      dict(diag_b=512, hot_k=0, agg_feature_dim=10**7),
                      False),
    # blocks of 1024 rows at 4 devices: halos between every pair of the
    # first three (tests/test_torch_dist_hybrid.py's layout)
    "community_ob512": ((3000, 40000, 16, 5, "community", 3),
                        dict(diag_b=512, hot_k=512, res_ob=512, res_tile=128),
                        None),
    "web_diag512": ((4096, 60000, 8, 4, "web", 11),
                    dict(diag_b=512, hot_k=512), None),
}
# tests/test_parallel.py's graph, at its part size and the default one
ELL_CASES = {
    "powerlaw_part4": ((600, 7000, 16, 5, "powerlaw", 11), dict(part_size=4)),
    "powerlaw_auto_part": ((600, 7000, 16, 5, "powerlaw", 11), {}),
}

_GRAPHS: dict = {}


def graphs(args):
    """(JAX graph, port graph) from the same generator arguments, whose CSR
    arrays must already be equal."""
    if args not in _GRAPHS:
        n, e, f, c, kind, seed = args
        jg = jax_synthesize(n, e, num_features=f, num_classes=c, kind=kind,
                            seed=seed)
        tg = synthesize_graph(n, e, num_features=f, num_classes=c, kind=kind,
                              seed=seed)
        for name in ("row_pointers", "column_index", "degrees"):
            assert np.array_equal(getattr(jg, name), getattr(tg, name))
        _GRAPHS[args] = (jg, tg)
    return _GRAPHS[args]


def assert_identical(want, got) -> None:
    """Every dataclass field equal: arrays in dtype, shape and bytes."""
    names = [f.name for f in dataclasses.fields(want)]
    assert names == [f.name for f in dataclasses.fields(got)]
    for name in names:
        a, b = getattr(want, name), getattr(got, name)
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray), name
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name
        else:
            assert type(a) is type(b) and a == b, (name, a, b)


@pytest.mark.parametrize("ndev", DEVICES)
@pytest.mark.parametrize("case", sorted(HYBRID_CASES))
def test_shard_graph_hybrid_is_byte_identical(case, ndev):
    args, kw, res_single = HYBRID_CASES[case]
    jg, tg = graphs(args)
    want = jax_shard_hybrid(jg, num_devices=ndev, **kw)
    got = shard_graph_hybrid(tg, num_devices=ndev, **kw)
    assert_identical(want, got)
    if res_single is not None:
        assert got.res_single is res_single


@pytest.mark.parametrize("ndev", DEVICES)
@pytest.mark.parametrize("case", sorted(ELL_CASES))
def test_shard_graph_is_byte_identical(case, ndev):
    args, kw = ELL_CASES[case]
    jg, tg = graphs(args)
    assert_identical(jax_shard(jg, num_devices=ndev, **kw),
                     shard_graph(tg, num_devices=ndev, **kw))


@pytest.mark.parametrize("ndev", [2, 4])
def test_ragged_plan_is_contiguous_per_sender(ndev):
    """What ``dist_ops.halo_plan`` relies on: a sender's rows for its
    receivers lie back to back in ``send_flat``, in receiver order, and a
    receiver's halo segments back to back in sender order."""
    args, kw, _ = HYBRID_CASES["community_ob512"]
    _, tg = graphs(args)
    for sg in (shard_graph_hybrid(tg, ndev, **kw),
               shard_graph(tg, ndev, part_size=4)):
        sizes = sg.halo_send_sizes  # [s, r]
        off = np.zeros_like(sizes)
        off[:, 1:] = np.cumsum(sizes, axis=1)[:, :-1]
        assert np.array_equal(sg.halo_in_off, off)
        assert np.array_equal(sg.halo_out_off.T[:, 0], np.zeros(ndev))
        assert int(sg.halo_sizes.sum(axis=1).max()) <= sg.recv_max
        assert sg.recv_max % 8 == 0
