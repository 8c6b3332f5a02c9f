"""The port's distributed paths (``parallel/dist_hybrid.py``,
``parallel/dist_ops.py``) on gloo process groups, against the JAX
package's on its CPU mesh and against the single-card paths.

- One rank, in this process: the distributed aggregates against the
  port's single-card aggregation and the JAX dist path on
  ``make_mesh(1)``; the loss and gradients against the single-card model.
- Four ranks: one module-scoped spawn of 4 gloo processes (``_rank_work``)
  computes the hybrid aggregates for norm × overlap × {f32, bf16}, the
  ELL aggregates, and for GCN and GIN on both paths the loss, the
  gradients and 5 Adam steps; each rank writes an ``.npz``.  The JAX
  package's ``make_dist_loss_fn``/``make_dist_train_step`` on
  ``make_mesh(4)`` of the 8 CPU devices and the single-card oracle are
  the references.  The weights are the JAX model's draws.

Tolerances: aggregates and gradients rtol 1e-5, atol 1e-5 x the largest
value (as tests/test_torch_hybrid_agg.py: both sides round the
pre-scaled features to the aggregation dtype the same way, bf16
included, and add exact products in f32, in different orders); losses
over 5 steps rtol 1e-4.
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from gnnadvisor_osdi21_tpu.graphs.loader import (
    synthesize_graph as jax_synthesize,
)
from gnnadvisor_osdi21_tpu.parallel import dist_hybrid as jdh
from gnnadvisor_osdi21_tpu.parallel import dist_ops as jdo
from gnnadvisor_osdi21_tpu.parallel.hybrid_partition import (
    shard_graph_hybrid as jax_shard_hybrid,
)
from gnnadvisor_osdi21_tpu.parallel.mesh import GRAPH_AXIS, make_mesh
from gnnadvisor_osdi21_tpu.parallel.partition import shard_graph as jax_shard
from gnnadvisor_osdi21_tpu.train import build_model as jax_build_model
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import build_hybrid
from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu_torch.ops import reference
from gnnadvisor_osdi21_tpu_torch.ops.aggregate import aggregate
from gnnadvisor_osdi21_tpu_torch.ops.graph_tensors import build_graph_tensors
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import build_hybrid_tensors
from gnnadvisor_osdi21_tpu_torch.parallel import dist_hybrid, dist_ops, mesh
from gnnadvisor_osdi21_tpu_torch.parallel.hybrid_partition import (
    shard_graph_hybrid,
)
from gnnadvisor_osdi21_tpu_torch.parallel.partition import shard_graph
from gnnadvisor_osdi21_tpu_torch.train import build_model, nll_loss

# tests/test_dist_hybrid.py's graph and tiers, at a residual block of 512
# rows: blocks of 1024 rows, so that ranks 0-2 exchange about 1,000 rows
# with each other and rank 3 holds padding only (the cost model's block of
# 4096 rows would put every node on rank 0); tests/test_parallel.py's
# ELL graph
HYBRID_GRAPH = dict(num_nodes=3000, num_edges=40000, num_features=16,
                    num_classes=5, kind="community", seed=3)
HYBRID_TIERS = dict(diag_b=512, hot_k=512, res_ob=512, res_tile=128)
ELL_GRAPH = dict(num_nodes=600, num_edges=7000, num_features=16,
                 num_classes=5, seed=11)
PART_SIZE = 4
DIM, HIDDEN, CLASSES = 16, 16, 5
MODELS = ("gcn", "gin")
STEPS = 5
RANKS = 4
JOIN_TIMEOUT_S = 120
LR = 0.01


def close(got, want, rtol=1e-5):
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def port_graphs():
    return (synthesize_graph(**HYBRID_GRAPH),
            synthesize_graph(**ELL_GRAPH))


def inputs(g, seed: int):
    """Features and random labels (so that no model fits them at once)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g.num_nodes, DIM)).astype(np.float32),
            rng.integers(0, CLASSES, g.num_nodes).astype(np.int32))


def jax_params(model: str) -> dict:
    params, _ = jax_build_model(model, jax.random.PRNGKey(0), DIM, HIDDEN,
                                CLASSES)
    return {k: np.asarray(v) for k, v in params.items()}


def oracle(g, x, norm: bool, agg_dtype: str = "float32") -> np.ndarray:
    """The single-card aggregate over every edge (f64 sums), the pre-scaled
    features rounded to ``agg_dtype`` first, as every path rounds them."""
    xs = torch.from_numpy(x).double()
    deg = torch.from_numpy(g.degrees).double()[:, None]
    if norm:
        xs = (xs * deg).float()
    xs = xs.to(getattr(torch, agg_dtype)).double()
    src = torch.from_numpy(reference.csr_to_coo(g.row_pointers,
                                                g.column_index))
    out = reference.sag(xs, src, torch.from_numpy(g.column_index),
                        g.num_nodes)
    return (out * deg if norm else out).numpy()


def padded(a, rows):
    out = np.zeros((rows,) + a.shape[1:], dtype=a.dtype)
    out[: len(a)] = a
    return out


# ---------------------------------------------------------------------------
# Four ranks
# ---------------------------------------------------------------------------

AGG_CASES = [(norm, overlap, dt) for norm in (False, True)
             for overlap in (True, False) for dt in ("float32", "bfloat16")]


def _train(make_loss, group, model, params, block, transposed, x, y):
    """Loss and summed gradients at the drawn weights, then the losses of
    STEPS Adam steps from them (the first step's loss is that loss)."""
    loss_fn = make_loss()
    step, init = dist_ops.make_train_step_on(
        loss_fn, group, LR, model, transposed, block)
    net, opt, xb, yb = init(torch.Generator(), DIM, HIDDEN, CLASSES, x, y,
                            init_params=params)
    loss = loss_fn(net, xb, yb)
    loss.backward()
    dist_ops.all_reduce_grads(net, group)
    out = {"loss": loss.detach().numpy()}
    out.update({f"grad_{n}": p.grad.numpy().copy()
                for n, p in net.named_parameters()})
    opt.step()
    losses = [float(loss.detach())] + [float(step(net, opt, xb, yb))
                              for _ in range(STEPS - 1)]
    out["losses"] = np.asarray(losses)
    return out


def _rank_work(group, out_dir, xs, ys, params):
    """What each of the RANKS ranks computes (run by ``mesh.run_ranks``)."""
    r = group.rank
    gh, ge = port_graphs()
    res = {}
    sg = shard_graph_hybrid(gh, RANKS, **HYBRID_TIERS)
    rows = slice(r * sg.block, (r + 1) * sg.block)
    xh = torch.from_numpy(padded(xs["hybrid"], RANKS * sg.block)[rows])
    shards = {dt: dist_hybrid.HybridShard(sg, group, dt)
              for dt in ("float32", "bfloat16")}
    for norm, overlap, dt in AGG_CASES:
        res[f"hybrid_{norm}_{overlap}_{dt}"] = dist_hybrid.dist_hybrid_aggregate(
            xh, shards[dt], norm, overlap).numpy()
    # the two-stage residual ids (res_gather[res_dst]), by the width gate
    sg2 = shard_graph_hybrid(gh, RANKS, agg_feature_dim=10**7, **HYBRID_TIERS)
    assert sg.res_single and not sg2.res_single
    res["hybrid_two_stage"] = dist_hybrid.dist_hybrid_aggregate(
        xh, dist_hybrid.HybridShard(sg2, group, "float32"), True).numpy()
    sge = shard_graph(ge, RANKS, part_size=PART_SIZE)
    she = dist_ops.ell_shard(sge, group)
    rows_e = slice(r * sge.block, (r + 1) * sge.block)
    xe = torch.from_numpy(padded(xs["ell"], RANKS * sge.block)[rows_e])
    for norm in (False, True):
        res[f"ell_{norm}"] = dist_ops.dist_aggregate(xe, she, norm).numpy()
    for model in MODELS:
        for k, v in _train(
                lambda: dist_hybrid.make_dist_loss_fn(
                    group, sg, model, agg_dtype="float32",
                    shard=shards["float32"]),
                group, model, params[model], sg.block, True, xs["hybrid"],
                ys["hybrid"]).items():
            res[f"train_hybrid_{model}_{k}"] = v
        for k, v in _train(
                lambda: dist_ops.make_dist_loss_fn(group, sge, model,
                                                   shard=she),
                group, model, params[model], sge.block, False, xs["ell"],
                ys["ell"]).items():
            res[f"train_ell_{model}_{k}"] = v
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **res)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The 4 ranks' results: aggregates put together by rank (unpadded),
    training results of rank 0 (and every rank's loss histories)."""
    gh, ge = port_graphs()
    (xh, yh), (xe, ye) = inputs(gh, 0), inputs(ge, 1)
    params = {m: jax_params(m) for m in MODELS}
    out = tmp_path_factory.mktemp("ranks")
    mesh.run_ranks(_rank_work, RANKS, "cpu",
                   args=(str(out), {"hybrid": xh, "ell": xe},
                         {"hybrid": yh, "ell": ye}, params),
                   timeout=JOIN_TIMEOUT_S)
    per = [dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)]
    joined = {k: np.concatenate([p[k] for p in per])
              for k in per[0] if not k.startswith("train_")}
    for k in per[0]:
        if k.startswith("train_"):
            for p in per[1:]:  # the replicated results agree on every rank
                np.testing.assert_array_equal(p[k], per[0][k])
            joined[k] = per[0][k]
    return dict(graphs=(gh, ge), x=(xh, xe), y=(yh, ye), params=params,
                res=joined)


@pytest.mark.parametrize("norm,overlap,agg_dtype", AGG_CASES)
def test_four_ranks_hybrid_aggregate(four_ranks, norm, overlap, agg_dtype):
    gh = four_ranks["graphs"][0]
    got = four_ranks["res"][f"hybrid_{norm}_{overlap}_{agg_dtype}"]
    close(got[: gh.num_nodes],
          oracle(gh, four_ranks["x"][0], norm, agg_dtype))
    assert not got[gh.num_nodes:].any()


def test_four_ranks_two_stage_residual(four_ranks):
    gh = four_ranks["graphs"][0]
    close(four_ranks["res"]["hybrid_two_stage"][: gh.num_nodes],
          oracle(gh, four_ranks["x"][0], True))


@pytest.mark.parametrize("norm", [False, True])
def test_four_ranks_ell_aggregate(four_ranks, norm):
    ge = four_ranks["graphs"][1]
    got = four_ranks["res"][f"ell_{norm}"]
    close(got[: ge.num_nodes], oracle(ge, four_ranks["x"][1], norm))


def _jax_training(path: str, model: str, g, x, y, params):
    """The JAX dist path on make_mesh(RANKS): (loss, grads) at ``params``
    and the losses of STEPS Adam steps from them."""
    mesh4 = make_mesh(RANKS)
    if path == "hybrid":
        sg = jax_shard_hybrid(g, RANKS, **HYBRID_TIERS)
        loss_fn = jdh.make_dist_loss_fn(mesh4, sg, model, agg_dtype="float32")
        step, init = jdh.make_dist_train_step(mesh4, sg, model,
                                              agg_dtype="float32")
    else:
        sg = jax_shard(g, RANKS, part_size=PART_SIZE)
        loss_fn = jdo.make_dist_loss_fn(mesh4, sg, model)
        step, init = jdo.make_dist_train_step(mesh4, sg, model)
    p, opt_state, garr, xd, yd = init(jax.random.PRNGKey(0), DIM, HIDDEN,
                                      CLASSES, x, y)
    for k in params:  # init drew the same weights
        np.testing.assert_array_equal(np.asarray(p[k]), params[k])
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(p, garr, xd, yd)
    grads = {k: np.asarray(v) for k, v in grads.items()}
    losses = []
    for _ in range(STEPS):
        p, opt_state, lv = step(p, opt_state, garr, xd, yd)
        losses.append(float(lv))
    return float(loss), grads, np.asarray(losses)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("path", ["hybrid", "ell"])
def test_four_ranks_training_matches_jax_mesh(four_ranks, path, model):
    i = 0 if path == "hybrid" else 1
    g = jax_synthesize(**(HYBRID_GRAPH if path == "hybrid" else ELL_GRAPH))
    loss, grads, losses = _jax_training(
        path, model, g, four_ranks["x"][i], four_ranks["y"][i],
        four_ranks["params"][model])
    res = {k[len(f"train_{path}_{model}_"):]: v
           for k, v in four_ranks["res"].items()
           if k.startswith(f"train_{path}_{model}_")}
    np.testing.assert_allclose(float(res["loss"]), loss, rtol=1e-5)
    for name, want in grads.items():
        close(res[f"grad_{name}"], want)
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-4)
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# One rank, in this process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    group = mesh.make_group(
        1, "cpu", init_file=str(tmp_path_factory.mktemp("g1") / "store"))
    try:
        yield group
    finally:
        mesh.destroy_group(group)


@pytest.fixture(scope="module")
def one_rank_setup():
    gh, ge = port_graphs()
    sg = shard_graph_hybrid(gh, 1, **HYBRID_TIERS)
    jsg = jax_shard_hybrid(jax_synthesize(**HYBRID_GRAPH), 1, **HYBRID_TIERS)
    # the single-card layout of the same tiers and geometry
    hg = build_hybrid(gh, diag_b=sg.diag_b, hot_k=sg.hot_k,
                      res_tile=sg.res_tile, res_ob=sg.res_ob, probe=False)
    assert hg.num_rows == sg.block
    return gh, ge, sg, jsg, hg


def _jax_mesh1_aggregate(jsg, x, norm, overlap, agg_dtype):
    mesh1 = make_mesh(1)
    garr = jdh.device_graph_arrays(jsg, mesh1)
    xd = jax.device_put(jnp.asarray(padded(x, jsg.block)),
                        NamedSharding(mesh1, P(GRAPH_AXIS, None)))

    @jax.jit
    @partial(shard_map, mesh=mesh1,
             in_specs=(jdh._graph_specs(jsg), P(GRAPH_AXIS, None)),
             out_specs=P(GRAPH_AXIS, None))
    def run(gd, x_blk):
        gd = {k: v[0] for k, v in gd.items()}
        return jdh.dist_hybrid_aggregate(x_blk, jsg, gd, norm,
                                         overlap=overlap, agg_dtype=agg_dtype)

    return np.asarray(run(garr, xd))


@pytest.mark.parametrize("norm,overlap,agg_dtype", AGG_CASES)
def test_one_rank_hybrid_aggregate(one_rank, one_rank_setup, norm, overlap,
                                   agg_dtype):
    gh, _, sg, jsg, hg = one_rank_setup
    x, _ = inputs(gh, 2)
    xp = padded(x, sg.block)
    sh = dist_hybrid.HybridShard(sg, one_rank, agg_dtype)
    got = dist_hybrid.dist_hybrid_aggregate(torch.from_numpy(xp), sh, norm,
                                            overlap).numpy()
    ht = build_hybrid_tensors(hg, device="cpu", agg_dtype=agg_dtype,
                              transposed=False)
    close(got, aggregate(torch.from_numpy(xp), ht, norm).numpy())
    close(got, _jax_mesh1_aggregate(jsg, x, norm, overlap, agg_dtype))


@pytest.mark.parametrize("norm", [False, True])
def test_one_rank_ell_aggregate(one_rank, one_rank_setup, norm):
    _, ge, _, _, _ = one_rank_setup
    x, _ = inputs(ge, 3)
    sge = shard_graph(ge, 1, part_size=PART_SIZE)
    got = dist_ops.dist_aggregate(torch.from_numpy(padded(x, sge.block)),
                                  dist_ops.ell_shard(sge, one_rank),
                                  norm).numpy()
    gt = build_graph_tensors(ge, method="ell", part_size=PART_SIZE,
                             device="cpu")
    close(got[: ge.num_nodes], aggregate(torch.from_numpy(x), gt,
                                         norm).numpy())
    jsg = jax_shard(jax_synthesize(**ELL_GRAPH), 1, part_size=PART_SIZE)
    mesh1 = make_mesh(1)

    @jax.jit
    @partial(shard_map, mesh=mesh1,
             in_specs=(jdo._graph_specs(), P(GRAPH_AXIS, None)),
             out_specs=P(GRAPH_AXIS, None))
    def run(gd, x_blk):
        gd = {k: v[0] for k, v in gd.items()}
        return jdo.dist_aggregate(x_blk, gd, jsg.block, norm, jsg.recv_max)

    want = np.asarray(run(jdo.device_graph_arrays(jsg, mesh1),
                          jax.device_put(jnp.asarray(padded(x, jsg.block)),
                                         NamedSharding(mesh1,
                                                       P(GRAPH_AXIS, None)))))
    close(got, want)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("path", ["hybrid", "ell"])
def test_one_rank_loss_and_grads_match_single_card(one_rank, one_rank_setup,
                                                   path, model):
    """The distributed loss and gradients (one rank) against the port's
    single-card model on the same weights: the hybrid layout of the same
    tiers, or the ELL tensors of the same part size."""
    gh, ge, sg, _, hg = one_rank_setup
    g = gh if path == "hybrid" else ge
    x, y = inputs(g, 4)
    params = jax_params(model)
    if path == "hybrid":
        loss_fn = dist_hybrid.make_dist_loss_fn(one_rank, sg, model,
                                                agg_dtype="float32")
        block = sg.block
        ht = build_hybrid_tensors(hg, device="cpu")
        xs = torch.from_numpy(padded(x, hg.num_rows).T.copy())
        ys = torch.from_numpy(padded(y, hg.num_rows))
        mask = torch.from_numpy(hg.row_mask)
    else:
        sge = shard_graph(ge, 1, part_size=PART_SIZE)
        loss_fn = dist_ops.make_dist_loss_fn(one_rank, sge, model)
        block = sge.block
        ht = build_graph_tensors(ge, method="ell", part_size=PART_SIZE,
                                 device="cpu")
        xs, ys, mask = torch.from_numpy(x), torch.from_numpy(y), None
    _, init = dist_ops.make_train_step_on(loss_fn, one_rank, LR, model,
                                          path == "hybrid", block)
    net, _, xb, yb = init(torch.Generator(), DIM, HIDDEN, CLASSES, x, y,
                          init_params=params)
    loss = loss_fn(net, xb, yb)
    loss.backward()
    single = build_model(model, torch.Generator(), DIM, HIDDEN, CLASSES,
                         device="cpu").params_from_jax(params)
    want = nll_loss(single(xs, (ht, ht)), ys, mask, path == "hybrid")
    want.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want.detach()),
                               rtol=1e-5)
    for (name, p), q in zip(net.named_parameters(), single.parameters()):
        close(p.grad.numpy(), q.grad.numpy())
