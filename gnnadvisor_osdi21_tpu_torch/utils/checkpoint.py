"""Checkpoint and resume: the port of
``gnnadvisor_osdi21_tpu/utils/checkpoint.py``.

One ``.npz`` file in the JAX package's schema, so that either package
resumes the other's runs:

- ``params:<tree path>``: a weight under the JAX model's name and layout
  (``params:['conv1']``, ``[in, hidden]``);
- ``opt:<tree path>``: optax's Adam state, ``(ScaleByAdamState(count, mu,
  nu), EmptyState())`` flattened (``opt:[0]/.count`` int32,
  ``opt:[0]/.mu/['conv1']``, ``opt:[0]/.nu/['conv1']``);
- ``__step__``: the training step the run had reached.

In the port, ``params`` is a dict of arrays by weight name and
``opt_state`` the dict ``{"count", "mu", "nu"}`` of those three fields.
``torch.optim.Adam`` keeps the same state per parameter under other names:
``step`` (optax's ``count``), ``exp_avg`` (``mu``) and ``exp_avg_sq``
(``nu``); ``opt_state_from_torch`` and ``opt_state_to_torch`` map one to
the other.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

_ADAM = "[0]"  # optax.adam's state: (ScaleByAdamState, EmptyState)


def _param_key(name: str) -> str:
    return f"['{name}']"


def _flatten(params: Mapping | None, opt_state: Mapping | None) -> dict:
    """``{"params:<path>" | "opt:<path>": array}`` with the JAX package's
    tree paths (dict keys in sorted order, as JAX flattens them)."""
    flat = {}
    for name in sorted(params or {}):
        flat[f"params:{_param_key(name)}"] = np.asarray(params[name])
    if opt_state is not None:
        flat[f"opt:{_ADAM}/.count"] = np.asarray(opt_state["count"], np.int32)
        for field in ("mu", "nu"):
            for name in sorted(opt_state[field]):
                flat[f"opt:{_ADAM}/.{field}/{_param_key(name)}"] = np.asarray(
                    opt_state[field][name])
    return flat


def save_checkpoint(path: str, params, opt_state=None, step: int = 0) -> None:
    """Write (params, opt_state, step) to ``path``, atomically: into a
    temporary file beside it, then renamed over it."""
    payload = _flatten(params, opt_state)
    payload["__step__"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as fp:
            np.savez(fp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str, params_template, opt_state_template=None):
    """Read the entries the templates name (a params dict; an opt_state
    dict ``{"count", "mu", "nu"}``, or None); returns (params, opt_state,
    step) as numpy arrays."""
    with np.load(path, allow_pickle=False) as data:
        params = {name: data[f"params:{_param_key(name)}"]
                  for name in params_template}
        opt_state = None
        if opt_state_template is not None:
            opt_state = {"count": data[f"opt:{_ADAM}/.count"]}
            for field in ("mu", "nu"):
                opt_state[field] = {
                    name: data[f"opt:{_ADAM}/.{field}/{_param_key(name)}"]
                    for name in opt_state_template[field]}
        return params, opt_state, int(data["__step__"])


def opt_state_from_torch(net: torch.nn.Module,
                         opt: torch.optim.Adam) -> dict:
    """The optax Adam state of ``opt`` over ``net``'s named parameters:
    zeros and count 0 before its first step."""
    count, mu, nu = 0, {}, {}
    for name, p in net.named_parameters():
        state = opt.state.get(p, {})
        if state:
            count = int(state["step"])
            mu[name] = state["exp_avg"].detach().cpu().numpy().copy()
            nu[name] = state["exp_avg_sq"].detach().cpu().numpy().copy()
        else:
            mu[name] = np.zeros(tuple(p.shape), np.float32)
            nu[name] = np.zeros(tuple(p.shape), np.float32)
    return {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu}


@torch.no_grad()
def opt_state_to_torch(net: torch.nn.Module, opt: torch.optim.Adam,
                       opt_state: Mapping) -> None:
    """Set ``opt``'s state over ``net``'s named parameters from an optax
    Adam state: ``step`` = ``count`` (on the parameter's device where the
    optimizer is capturable, on the CPU otherwise, as Adam keeps it)."""
    count = float(np.asarray(opt_state["count"]))
    for name, p in net.named_parameters():
        group = next(g for g in opt.param_groups
                     if any(q is p for q in g["params"]))
        on_device = group.get("capturable") or group.get("fused")
        opt.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32,
                                 device=p.device if on_device else "cpu"),
            "exp_avg": torch.tensor(np.asarray(opt_state["mu"][name],
                                               np.float32)).to(p.device),
            "exp_avg_sq": torch.tensor(np.asarray(opt_state["nu"][name],
                                                  np.float32)).to(p.device),
        }
