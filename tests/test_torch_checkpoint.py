"""Checkpoint/resume of the port (``utils/checkpoint.py``,
``train_and_time(save_ckpt=, resume=)``) against the JAX package's: the
round trip, a resumed run against a straight one (the mirror of
tests/test_utils.py:47-80), and checkpoints crossing between the two
packages in both directions."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gnnadvisor_osdi21_tpu.graphs.loader import synthesize_graph as jax_graph
from gnnadvisor_osdi21_tpu.models import init_gcn, init_gin
from gnnadvisor_osdi21_tpu.ops.graph_tensors import (
    build_graph_tensors as jax_tensors,
)
from gnnadvisor_osdi21_tpu.train import train_and_time as jax_train
from gnnadvisor_osdi21_tpu.utils.checkpoint import (
    load_checkpoint as jax_load, save_checkpoint as jax_save,
)
from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu_torch.ops.graph_tensors import build_graph_tensors
from gnnadvisor_osdi21_tpu_torch.train import train_and_time
from gnnadvisor_osdi21_tpu_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint,
)

INITS = {"gcn": init_gcn, "gin": init_gin}
HIDDEN, CLASSES, DIM = 8, 4, 8


def _params_close(got, want, rtol, atol):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(np.asarray(got[name]),
                                   np.asarray(want[name]), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def graphs():
    """The JAX test's graph (200 nodes, dense path) for both packages,
    with numpy features and labels."""
    kw = dict(num_features=DIM, num_classes=CLASSES, seed=3)
    jg, tg = jax_graph(200, 1500, **kw), synthesize_graph(200, 1500, **kw)
    gt = build_graph_tensors(tg, method="dense", device="cpu")
    return dict(jgt=jax_tensors(jg, method="dense"), tgt=gt,
                x=tg.init_embedding(DIM), y=tg.init_labels(CLASSES))


def _port(model, s, **kw):
    return train_and_time(model, (s["tgt"], s["tgt"]), s["x"], s["y"],
                          HIDDEN, CLASSES, dry_run=0, seed=11, device="cpu",
                          **kw)


def _jax(model, s, **kw):
    return jax_train(model, (s["jgt"], s["jgt"]), jnp.asarray(s["x"]),
                     jnp.asarray(s["y"]), hidden=HIDDEN,
                     num_classes=CLASSES, dry_run=0, use_scan=False,
                     seed=11, **kw)


def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    params = {"conv1": rng.standard_normal((8, 4), np.float32),
              "conv2": rng.standard_normal((4, 3), np.float32)}
    opt = {"count": np.asarray(7, np.int32),
           "mu": {k: rng.standard_normal(v.shape, np.float32)
                  for k, v in params.items()},
           "nu": {k: rng.random(v.shape, np.float32)
                  for k, v in params.items()}}
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, params, opt, step=42)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt.npz"]
    p, o, step = load_checkpoint(path, params, opt)
    assert step == 42 and int(o["count"]) == 7
    _params_close(p, params, 0, 0)
    for field in ("mu", "nu"):
        _params_close(o[field], opt[field], 0, 0)
    p, o, step = load_checkpoint(path, {"conv1": None})
    assert list(p) == ["conv1"] and o is None


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_train_resume_equivalence(tmp_path, graphs, model):
    """20 epochs straight == 10 + checkpoint + resume + 10, within the JAX
    test's tolerance (rtol 1e-5, atol 1e-6; both runs take the same CPU
    steps)."""
    straight = _port(model, graphs, num_epochs=20)
    ck = str(tmp_path / "half.ckpt.npz")
    half = _port(model, graphs, num_epochs=10, save_ckpt=ck)
    assert half["step"] == 10
    resumed = _port(model, graphs, num_epochs=10, resume=ck)
    assert resumed["step"] == 20
    assert int(resumed["opt_state"]["count"]) == 20
    _params_close(resumed["params"], straight["params"], 1e-5, 1e-6)
    assert abs(straight["final_loss"] - resumed["final_loss"]) < 1e-5


# Across packages the two frameworks sum in other orders (f32), and Adam
# divides each update by sqrt(nu): weights agree to about 1e-6 of their
# largest value after 20 steps.
CROSS_RTOL, CROSS_ATOL = 1e-4, 2e-5


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, graphs, model):
    """JAX trains 10 steps and saves; the port resumes for 10 more and
    lands on JAX's 20-step weights and Adam state."""
    straight = _jax(model, graphs, num_epochs=20)
    ck = str(tmp_path / "jax.ckpt.npz")
    _jax(model, graphs, num_epochs=10, save_ckpt=ck)
    resumed = _port(model, graphs, num_epochs=10, resume=ck)
    assert resumed["step"] == 20
    want = {k: np.asarray(v) for k, v in straight["params"].items()}
    _params_close(resumed["params"], want, CROSS_RTOL, CROSS_ATOL)
    adam = straight["opt_state"][0]
    assert int(resumed["opt_state"]["count"]) == int(adam.count) == 20
    _params_close(resumed["opt_state"]["mu"],
                  {k: np.asarray(v) for k, v in adam.mu.items()},
                  CROSS_RTOL, CROSS_ATOL)


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_port_checkpoint_loads_in_jax(tmp_path, graphs, model):
    """The port's checkpoint reads through JAX ``load_checkpoint`` with
    JAX templates, exactly; JAX resumes it for 10 more steps and lands on
    the port's 20-step weights."""
    ck = str(tmp_path / "port.ckpt.npz")
    half = _port(model, graphs, num_epochs=10, save_ckpt=ck)
    tmpl = INITS[model](jax.random.PRNGKey(1), DIM, HIDDEN, CLASSES)
    params, opt_state, step = jax_load(ck, tmpl, optax.adam(0.01).init(tmpl))
    assert step == 10
    _params_close({k: np.asarray(v) for k, v in params.items()},
                  half["params"], 0, 0)
    assert int(opt_state[0].count) == 10
    _params_close({k: np.asarray(v) for k, v in opt_state[0].nu.items()},
                  half["opt_state"]["nu"], 0, 0)
    resumed = _jax(model, graphs, num_epochs=10, resume=ck)
    assert resumed["step"] == 20
    straight = _port(model, graphs, num_epochs=20)
    _params_close({k: np.asarray(v) for k, v in resumed["params"].items()},
                  straight["params"], CROSS_RTOL, CROSS_ATOL)


def test_jax_written_file_reads_in_the_port(tmp_path):
    """A file the JAX package wrote (its own writer) reads in the port."""
    params = init_gcn(jax.random.PRNGKey(0), 8, 4, 3)
    opt_state = optax.adam(0.01).init(params)
    path = str(tmp_path / "j.npz")
    jax_save(path, params, opt_state, step=5)
    tmpl = {k: None for k in params}
    p, o, step = load_checkpoint(path, tmpl, {"mu": tmpl, "nu": tmpl})
    assert step == 5 and int(o["count"]) == 0
    _params_close(p, {k: np.asarray(v) for k, v in params.items()}, 0, 0)
