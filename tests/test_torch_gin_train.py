"""The port's GIN (and GCN on the row-major layout) against the JAX
package's, with the JAX weights carried across (``params_from_jax``):
forward outputs, loss and every gradient against ``jax.value_and_grad``,
and the losses of three Adam steps against optax.  GIN runs on the
row-major layout and on the transposed one, so both orientations of the
layer code are held; and the port's decider picks the JAX decider's
per-layer residual gather for GIN's aggregation widths.

Tolerance rtol 1e-4, atol 1e-5 x the largest value: the two sides sum in
different orders, and five layers of ε·Σ without normalization let the
largest logits grow to a few hundred times the smallest."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnnadvisor_osdi21_tpu.graphs import hybrid as jax_hybrid
from gnnadvisor_osdi21_tpu.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu.models.gcn import gcn_apply, init_gcn
from gnnadvisor_osdi21_tpu.models.gin import gin_apply, init_gin
from gnnadvisor_osdi21_tpu.train import make_train_step
from gnnadvisor_osdi21_tpu.train import nll_loss as jax_nll_loss
from gnnadvisor_osdi21_tpu.tuner.decider import InputProperty as JaxProperty
from gnnadvisor_osdi21_tpu_torch.graphs import hybrid as th
from gnnadvisor_osdi21_tpu_torch.models import GIN
from gnnadvisor_osdi21_tpu_torch.train import (
    MODELS, accuracy, nll_loss, train_and_time,
)
from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty

IN, HIDDEN, CLASSES = 12, 8, 5
RTOL = 1e-4
JAX_MODELS = {"gcn": (init_gcn, gcn_apply), "gin": (init_gin, gin_apply)}
CASES = [
    ("gin", False, "float32"), ("gin", False, "bfloat16"),
    ("gcn", False, "float32"), ("gcn", False, "bfloat16"),
    ("gin", True, "float32"),
]


def assert_close(got, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=RTOL, atol=1e-5 * float(np.abs(want).max())
    )


@pytest.fixture(scope="module",
                params=CASES, ids=["-".join(map(str, c)) for c in CASES])
def setup(request):
    """Auto-decided layouts on both sides (a 5000-node web graph picks the
    hybrid method), JAX weights, numpy features and labels."""
    model, transposed, agg_dtype = request.param
    g = synthesize_graph(5000, 40000, num_features=IN, num_classes=CLASSES,
                         kind="web", seed=4)
    kw = dict(hidden_dim=HIDDEN, agg_dtype=agg_dtype, model=model,
              transposed=transposed)
    jgts = JaxProperty(g, probe=False, **kw).decider().build_tensors()
    tp = InputProperty(g, **kw).decider()
    thts = tp.build_tensors(device="cpu")
    assert thts[0].transposed == transposed
    rng = np.random.default_rng(8)
    x = tp.pad_features(g.init_embedding(IN))  # [R, IN]
    y = tp.pad_features(rng.integers(0, CLASSES, g.num_nodes).astype(np.int32))
    init, apply = JAX_MODELS[model]
    params = init(jax.random.PRNGKey(3), IN, HIDDEN, CLASSES)
    return dict(
        model=model, transposed=transposed, jgts=jgts, thts=thts, x=x, y=y,
        mask=tp.hybrid_graph.row_mask, params=params, apply=apply,
        params_np={k: np.asarray(v) for k, v in params.items()},
        # the layout the model reads: [D, R] when transposed
        x_in=np.ascontiguousarray(x.T if transposed else x),
    )


def _jax_loss(params, s):
    out = s["apply"](params, jnp.asarray(s["x_in"]), s["jgts"])
    return jax_nll_loss(out, jnp.asarray(s["y"]), jnp.asarray(s["mask"]),
                        transposed=s["transposed"])


def test_forward_loss_and_gradients_match_jax(setup):
    s = setup
    want_out = np.asarray(
        s["apply"](s["params"], jnp.asarray(s["x_in"]), s["jgts"]))
    want_loss, want_grads = jax.value_and_grad(_jax_loss)(s["params"], s)

    net = MODELS[s["model"]](IN, HIDDEN, CLASSES, device="cpu")
    net.params_from_jax(s["params_np"])
    out = net(torch.from_numpy(s["x_in"]), s["thts"])
    assert out.shape == want_out.shape
    assert_close(out.detach().numpy(), want_out)
    y, mask = torch.from_numpy(s["y"]), torch.from_numpy(s["mask"])
    loss = nll_loss(out, y, mask, transposed=s["transposed"])
    loss.backward()
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    assert sorted(want_grads) == sorted(n for n, _ in net.named_parameters())
    for name, want in want_grads.items():
        assert_close(getattr(net, name).grad.numpy(), want)
    acc = accuracy(out, y, mask, transposed=s["transposed"])
    assert 0.0 <= float(acc) <= 1.0


def test_three_adam_steps_match_optax(setup):
    s = setup
    step = make_train_step(s["apply"], s["jgts"], optax.adam(0.01),
                           mask=jnp.asarray(s["mask"]))
    params = jax.tree.map(jnp.array, s["params"])
    opt_state = optax.adam(0.01).init(params)
    want = []
    for _ in range(3):
        params, opt_state, loss = step(
            params, opt_state, jnp.asarray(s["x_in"]), jnp.asarray(s["y"]))
        want.append(float(loss))
    res = train_and_time(
        s["model"], s["thts"], s["x"], s["y"], HIDDEN, CLASSES, num_epochs=0,
        dry_run=3, mask=s["mask"], device="cpu", init_params=s["params_np"],
    )
    assert res["epoch_ms"] is None  # nothing is timed off the card
    np.testing.assert_allclose(res["losses"], want, rtol=RTOL)


def test_gin_weights_follow_the_published_widths():
    net = GIN(96, 64, 22, device="cpu")
    shapes = [tuple(p.shape) for p in net.parameters()]
    assert shapes == [(96, 64)] + [(64, 64)] * 3 + [(64, 22)]
    for p in net.parameters():
        assert float(p.detach().abs().max()) <= 1.0 / np.sqrt(p.shape[1])
    with pytest.raises(ValueError, match="conv3"):
        net.params_from_jax({f"conv{i}": np.zeros(s) for i, s in zip(
            range(1, 6), [(96, 64), (64, 64), (64, 8), (64, 64), (64, 22)])})


@pytest.mark.parametrize("model", ["gin", "gcn"])
def test_decider_gathers_per_layer_like_jax(model, monkeypatch):
    """GIN aggregates at the input width, then at the hidden one; GCN at
    the hidden width, then at the class count.  With the single-stage
    limit between 8 and 12 columns, GIN's layers straddle it and GCN's do
    not: the JAX decider gives GIN's layers different residual gathers.
    The port's row-major kernel gathers each slot's row of x by
    ``res_src``, the JAX gathers' ids composed, at any width: both
    layers share one tensor set, and it reads what each JAX layer does."""
    g = synthesize_graph(6000, 60000, num_features=IN, num_classes=CLASSES,
                         kind="web", seed=2)
    kw = dict(hidden_dim=HIDDEN, diag_b=0, hot_k=0, model=model,
              transposed=False)
    hg = th.build_hybrid(g, diag_b=0, hot_k=0)
    assert hg.res_single
    limit = hg.num_res_slots * 10
    monkeypatch.setattr(jax_hybrid, "RES_SINGLE_MAX_CELLS", limit)
    tp = InputProperty(g, **kw).decider()
    ht_in, ht_hid = tp.build_tensors(device="cpu")
    jin, jhid = JaxProperty(g, probe=False, **kw).decider().build_tensors()
    for t, j in ((ht_in, jin), (ht_hid, jhid)):
        assert not hasattr(t, "res_gather") and not hasattr(t, "res_dst")
        dst = np.asarray(j.res_dst)
        rows = dst if j.res_gather is None else np.asarray(j.res_gather)[dst]
        assert np.array_equal(t.res_src.numpy(), rows)
        assert np.array_equal(t.res_mask.numpy(), np.asarray(j.res_mask))
    straddles = model == "gin"
    assert (jin.res_gather is not None) == straddles
    assert jhid.res_gather is None
    assert ht_hid is ht_in


def test_unknown_model_is_refused(skewed_graph):
    with pytest.raises(ValueError, match="unknown model"):
        InputProperty(skewed_graph, hidden_dim=8, model="sage")
    with pytest.raises(ValueError, match="unknown model"):
        train_and_time("sage", (), np.zeros((4, 2), np.float32),
                       np.zeros(4, np.int32), 2, 2, device="cpu")


PATHS = ["dense", "ell", "coo", "hybrid_reordered"]


@pytest.fixture(scope="module", params=PATHS)
def path_setup(request):
    """GIN on the ELL, dense and COO paths (no mask) of a 3000-node graph,
    the dense one by the auto decider, and on the row-major auto hybrid
    layout of a reordered 5000-node graph, at f32 aggregation (the cases
    above hold bf16 aggregation, whose rounding flips need 1e-4);
    features and labels follow ``prop.graph``."""
    path = request.param
    if path == "hybrid_reordered":
        g = synthesize_graph(5000, 40000, num_features=IN,
                             num_classes=CLASSES, kind="web", seed=4)
        kw = dict(enable_reorder=True, transposed=False,
                  agg_dtype="float32")
    else:
        g = synthesize_graph(3000, 24000, num_features=IN,
                             num_classes=CLASSES, kind="powerlaw", seed=4)
        kw = {} if path == "dense" else dict(method=path)
    kw.update(hidden_dim=HIDDEN, model="gin")
    jgts = JaxProperty(g, probe=False, **kw).decider().build_tensors()
    tp = InputProperty(g, **kw).decider()
    thts = tp.build_tensors(device="cpu")
    assert tp.layer_input.method == path.split("_")[0]
    assert tp.reorder_status == (path == "hybrid_reordered")
    rng = np.random.default_rng(8)
    x = tp.pad_features(tp.graph.init_embedding(IN))
    y = tp.pad_features(
        rng.integers(0, CLASSES, tp.graph.num_nodes).astype(np.int32))
    params = init_gin(jax.random.PRNGKey(3), IN, HIDDEN, CLASSES)
    return dict(
        jgts=jgts, thts=thts, x=x, y=y, params=params,
        mask=None if tp.hybrid_graph is None else tp.hybrid_graph.row_mask,
        params_np={k: np.asarray(v) for k, v in params.items()},
    )


def _jax_path_loss(params, s):
    out = gin_apply(params, jnp.asarray(s["x"]), s["jgts"])
    mask = None if s["mask"] is None else jnp.asarray(s["mask"])
    return jax_nll_loss(out, jnp.asarray(s["y"]), mask, transposed=False)


def test_gin_paths_first_step_matches_jax(path_setup):
    """Loss and gradients within 1e-5 relative (of the largest value)."""
    s = path_setup
    want_loss, want_grads = jax.value_and_grad(_jax_path_loss)(s["params"], s)
    net = GIN(IN, HIDDEN, CLASSES, device="cpu").params_from_jax(
        s["params_np"])
    out = net(torch.from_numpy(s["x"]), s["thts"])
    mask = None if s["mask"] is None else torch.from_numpy(s["mask"])
    loss = nll_loss(out, torch.from_numpy(s["y"]), mask, transposed=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name, want in want_grads.items():
        want = np.asarray(want)
        np.testing.assert_allclose(
            getattr(net, name).grad.numpy(), want, rtol=1e-5,
            atol=1e-5 * float(np.abs(want).max()))


def test_gin_paths_three_adam_steps_match_optax(path_setup):
    s = path_setup
    mask = None if s["mask"] is None else jnp.asarray(s["mask"])
    step = make_train_step(gin_apply, s["jgts"], optax.adam(0.01), mask=mask)
    params = jax.tree.map(jnp.array, s["params"])
    opt_state = optax.adam(0.01).init(params)
    want = []
    for _ in range(3):
        params, opt_state, loss = step(
            params, opt_state, jnp.asarray(s["x"]), jnp.asarray(s["y"]))
        want.append(float(loss))
    res = train_and_time(
        "gin", s["thts"], s["x"], s["y"], HIDDEN, CLASSES, num_epochs=0,
        dry_run=3, mask=s["mask"], device="cpu", init_params=s["params_np"],
    )
    np.testing.assert_allclose(res["losses"], want, rtol=RTOL)
