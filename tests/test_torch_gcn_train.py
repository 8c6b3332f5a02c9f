"""The port's GCN and training loop against the JAX package's, with the
JAX weights carried across (``GCN.params_from_jax``): forward outputs,
gradients against ``jax.grad``, and the losses of three Adam steps
against optax."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnnadvisor_osdi21_tpu.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu.models.gcn import gcn_apply, init_gcn
from gnnadvisor_osdi21_tpu.train import make_train_step
from gnnadvisor_osdi21_tpu.train import nll_loss as jax_nll_loss
from gnnadvisor_osdi21_tpu.tuner.decider import InputProperty as JaxProperty
from gnnadvisor_osdi21_tpu_torch.models.gcn import GCN
from gnnadvisor_osdi21_tpu_torch.train import accuracy, nll_loss, train_and_time
from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty

IN, HIDDEN, CLASSES = 12, 8, 5


def assert_close(got, want, rtol: float) -> None:
    """Summation order differs between the two sides.  The reference's
    multiplicative sqrt-degree weighting makes hub rows' logits reach the
    hundreds, so the absolute part of the tolerance scales with the
    largest value."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol, atol=1e-5 * float(np.abs(want).max())
    )


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def setup(request):
    """Auto-decided layouts on both sides (a 5000-node web graph picks the
    hybrid method), JAX weights, numpy features and labels."""
    agg_dtype = request.param
    g = synthesize_graph(5000, 40000, num_features=IN, num_classes=CLASSES,
                         kind="web", seed=4)
    jp = JaxProperty(g, hidden_dim=HIDDEN, probe=False, agg_dtype=agg_dtype)
    jgts = jp.decider().build_tensors()
    tp = InputProperty(g, hidden_dim=HIDDEN, agg_dtype=agg_dtype).decider()
    thts = tp.build_tensors(device="cpu")
    rng = np.random.default_rng(8)
    x = tp.pad_features(g.init_embedding(IN))  # [R, IN]
    y = tp.pad_features(rng.integers(0, CLASSES, g.num_nodes).astype(np.int32))
    mask = tp.hybrid_graph.row_mask
    params = init_gcn(jax.random.PRNGKey(3), IN, HIDDEN, CLASSES)
    params_np = {k: np.asarray(v) for k, v in params.items()}
    return dict(jgts=jgts, thts=thts, x=x, y=y, mask=mask, params=params,
                params_np=params_np)


def _jax_loss(params, s):
    out = gcn_apply(params, jnp.asarray(s["x"].T), s["jgts"])
    return jax_nll_loss(out, jnp.asarray(s["y"]), jnp.asarray(s["mask"]),
                        transposed=True)


def test_gcn_forward_and_gradients_match_jax(setup):
    s = setup
    want_out = np.asarray(
        gcn_apply(s["params"], jnp.asarray(s["x"].T), s["jgts"]))
    want_loss, want_grads = jax.value_and_grad(_jax_loss)(s["params"], s)

    net = GCN(IN, HIDDEN, CLASSES, device="cpu").params_from_jax(
        s["params_np"])
    x_t = torch.from_numpy(s["x"].T.copy())
    out = net(x_t, s["thts"])
    assert out.shape == (CLASSES, s["x"].shape[0])
    assert_close(out.detach().numpy(), want_out, rtol=1e-5)
    loss = nll_loss(out, torch.from_numpy(s["y"]),
                    torch.from_numpy(s["mask"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name in ("conv1", "conv2"):
        assert_close(getattr(net, name).grad.numpy(), want_grads[name],
                     rtol=1e-4)
    acc = accuracy(out, torch.from_numpy(s["y"]), torch.from_numpy(s["mask"]))
    assert 0.0 <= float(acc) <= 1.0


def test_three_adam_steps_match_optax(setup):
    s = setup
    step = make_train_step(gcn_apply, s["jgts"], optax.adam(0.01),
                           mask=jnp.asarray(s["mask"]))
    params = jax.tree.map(jnp.array, s["params"])
    opt_state = optax.adam(0.01).init(params)
    want = []
    for _ in range(3):
        params, opt_state, loss = step(
            params, opt_state, jnp.asarray(s["x"].T), jnp.asarray(s["y"]))
        want.append(float(loss))
    res = train_and_time(
        "gcn", s["thts"], s["x"], s["y"], HIDDEN, CLASSES, num_epochs=0,
        dry_run=3, mask=s["mask"], device="cpu", init_params=s["params_np"],
    )
    assert res["epoch_ms"] is None  # nothing is timed off the card
    np.testing.assert_allclose(res["losses"], want, rtol=1e-4)


PATHS = ["dense", "ell", "coo", "hybrid_reordered"]


@pytest.fixture(scope="module", params=PATHS)
def path_setup(request):
    """The ELL, dense and COO paths (row-major, no mask) on a 3000-node
    graph, the dense one by the auto decider; and the auto hybrid layout
    of a reordered 5000-node graph (transposed).  Features and labels
    follow ``prop.graph``, the reordered graph where the decider
    reordered."""
    path = request.param
    if path == "hybrid_reordered":
        g = synthesize_graph(5000, 40000, num_features=IN,
                             num_classes=CLASSES, kind="web", seed=4)
        kw = dict(enable_reorder=True)
    else:
        g = synthesize_graph(3000, 24000, num_features=IN,
                             num_classes=CLASSES, kind="powerlaw", seed=4)
        kw = {} if path == "dense" else dict(method=path)
    jp = JaxProperty(g, hidden_dim=HIDDEN, probe=False, **kw).decider()
    jgts = jp.build_tensors()
    tp = InputProperty(g, hidden_dim=HIDDEN, **kw).decider()
    thts = tp.build_tensors(device="cpu")
    assert tp.layer_input.method == path.split("_")[0]
    assert tp.reorder_status == (path == "hybrid_reordered")
    rng = np.random.default_rng(8)
    x = tp.pad_features(tp.graph.init_embedding(IN))
    y = tp.pad_features(
        rng.integers(0, CLASSES, tp.graph.num_nodes).astype(np.int32))
    mask = None if tp.hybrid_graph is None else tp.hybrid_graph.row_mask
    transposed = tp.hybrid_graph is not None
    params = init_gcn(jax.random.PRNGKey(3), IN, HIDDEN, CLASSES)
    return dict(jgts=jgts, thts=thts, x=x, y=y, mask=mask, params=params,
                transposed=transposed,
                x_in=np.ascontiguousarray(x.T if transposed else x),
                params_np={k: np.asarray(v) for k, v in params.items()})


def _jax_path_loss(params, s):
    out = gcn_apply(params, jnp.asarray(s["x_in"]), s["jgts"])
    mask = None if s["mask"] is None else jnp.asarray(s["mask"])
    return jax_nll_loss(out, jnp.asarray(s["y"]), mask,
                        transposed=s["transposed"])


def test_gcn_paths_first_step_matches_jax(path_setup):
    """Loss and gradients within 1e-5 relative (of the largest value)."""
    s = path_setup
    want_loss, want_grads = jax.value_and_grad(_jax_path_loss)(s["params"], s)
    net = GCN(IN, HIDDEN, CLASSES, device="cpu").params_from_jax(
        s["params_np"])
    out = net(torch.from_numpy(s["x_in"]), s["thts"])
    mask = None if s["mask"] is None else torch.from_numpy(s["mask"])
    loss = nll_loss(out, torch.from_numpy(s["y"]), mask, s["transposed"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name in ("conv1", "conv2"):
        assert_close(getattr(net, name).grad.numpy(), want_grads[name],
                     rtol=1e-5)


def test_gcn_paths_three_adam_steps_match_optax(path_setup):
    s = path_setup
    mask = None if s["mask"] is None else jnp.asarray(s["mask"])
    step = make_train_step(gcn_apply, s["jgts"], optax.adam(0.01), mask=mask)
    params = jax.tree.map(jnp.array, s["params"])
    opt_state = optax.adam(0.01).init(params)
    want = []
    for _ in range(3):
        params, opt_state, loss = step(
            params, opt_state, jnp.asarray(s["x_in"]), jnp.asarray(s["y"]))
        want.append(float(loss))
    res = train_and_time(
        "gcn", s["thts"], s["x"], s["y"], HIDDEN, CLASSES, num_epochs=0,
        dry_run=3, mask=s["mask"], device="cpu", init_params=s["params_np"],
    )
    np.testing.assert_allclose(res["losses"], want, rtol=1e-4)
