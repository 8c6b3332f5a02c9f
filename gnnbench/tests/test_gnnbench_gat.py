"""GAT's module (``gnnbench/models/gat.py``): its forward and its gradients
against a dense masked-softmax formulation on a tiny directed graph, its
weights against the port's model, its counts by hand, and the controls
reaching it; on the card, the controls and the fault failing the cell's
limits at its own size."""

from __future__ import annotations

import json
import math
import os
import types

import numpy as np
import pytest
import torch

from conftest import REPO
from gnnbench import (
    calibrate, check, data, reference, roofline, spec, tracing,
)

TRAFFIC = {"nodes": 9, "features": 5, "classes": 3}


def config(**changes) -> dict:
    with open(os.path.join(REPO, "gnnbench", "configs", "gat.json")) as fp:
        cfg = json.load(fp)
    cfg.update(changes)
    return cfg


def tiny_graph():
    """Directed: a hub column (node 2), a node with no out-edge (8), a
    duplicate edge and a self-loop already in the list (4, 4)."""
    src = np.array([0, 0, 1, 1, 3, 4, 4, 5, 6, 7, 5, 6, 7, 3, 0])
    dst = np.array([1, 2, 2, 3, 2, 4, 2, 2, 2, 2, 0, 7, 6, 5, 1])
    return src, dst, 9


def dense_forward(cfg, params, x, src, dst, n, rnd=lambda t: t):
    """The same model as dense matrices: per head, the logits of every pair,
    masked to the edges and self-loops, a row softmax, a matrix product
    (the gathered v rounded by ``rnd``); autograd gives the adjoint."""
    mask = torch.zeros((n, n), dtype=torch.bool)
    mask[torch.as_tensor(src), torch.as_tensor(dst)] = True
    mask |= torch.eye(n, dtype=torch.bool)
    slope = cfg["negative_slope"]

    def layer(h, w, a_src, a_dst):
        k, f = a_src.shape
        v = (h @ w).view(n, k, f)
        s_src, s_dst = (v * a_src).sum(-1), (v * a_dst).sum(-1)
        e = torch.nn.functional.leaky_relu(
            s_src.t()[:, :, None] + s_dst.t()[:, None, :], slope)
        alpha = torch.softmax(e.masked_fill(~mask, -math.inf), dim=-1)
        vb = v + (rnd(v) - v).detach()
        return torch.einsum("ksd,dkf->skf", alpha, vb).reshape(n, k * f)

    w1, as1, ad1, w2, as2, ad2 = params
    h = torch.nn.functional.elu(layer(x, w1, as1, ad1))
    out = layer(h, w2, as2, ad2).view(n, as2.shape[0], -1).mean(1)
    return torch.log_softmax(out, dim=1)


def inputs(cfg, seed=4):
    model = spec.Model(cfg)
    x, labels, params = data.make_inputs(seed, model, TRAFFIC, "cpu")
    return model, x.double(), labels, [p.double() for p in params]


@pytest.mark.parametrize("heads,out_heads", [(8, 8), (2, 1)])
def test_the_forward_and_its_adjoint_equal_a_dense_formulation(heads,
                                                              out_heads):
    cfg = config(heads=heads, out_heads=out_heads, hidden=4)
    model, x, labels, params = inputs(cfg)
    src, dst, n = tiny_graph()
    g = reference.Graph(src, dst, n, "cpu")
    ps = [p.clone().requires_grad_(True) for p in params]
    got = reference.forward(model, ps, x, g)
    qs = [p.clone().requires_grad_(True) for p in params]
    want = dense_forward(cfg, qs, x, src, dst, n)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    for a, b in zip(torch.autograd.grad(got.sum() + got[:, 0].pow(2).sum(),
                                        ps),
                    torch.autograd.grad(want.sum() + want[:, 0].pow(2).sum(),
                                        qs)):
        assert torch.allclose(a, b, rtol=1e-10, atol=1e-12)


def test_blocks_of_rows_change_only_the_order_of_sums(monkeypatch):
    cfg = config(hidden=4)
    model, x, labels, params = inputs(cfg)
    src, dst, n = tiny_graph()
    g = reference.Graph(src, dst, n, "cpu")
    whole = reference.follow(model, g, x, labels, params, 2)
    monkeypatch.setattr(model.arch, "BLOCK_ELEMS", 3 * 8 * 4)
    blocks = reference.follow(model, g, x, labels, params, 2)
    assert whole["losses"] == blocks["losses"]
    # the blocks add v's gradient block by block: another order, in
    # float64, that Adam's first steps may scale up to a step's rounding
    for a, b in zip(whole["grad1"] + whole["delta"],
                    blocks["grad1"] + blocks["delta"]):
        assert torch.allclose(a, b, rtol=0, atol=1e-10 * float(a.abs().max()))


def test_the_weights_are_the_ports():
    from gnnadvisor_osdi21_tpu_torch import train

    cfg = config()
    model = spec.Model(cfg)
    ws = model.arch.widths(cfg, TRAFFIC)
    net = train.MODELS[model.arch.PORT](
        ws[0], cfg["hidden"], ws[-1], device="cpu",
        **model.arch.port_kwargs(cfg))
    assert [(k, tuple(p.shape)) for k, p in net.named_parameters()] == [
        (name, shape) for name, shape, _ in model.arch.weights(cfg, TRAFFIC)]
    bounds = {name: bound for name, _, bound in
              model.arch.weights(cfg, TRAFFIC)}
    assert bounds["conv1"] == math.sqrt(6 / (5 + 8))
    assert bounds["att_src2"] == math.sqrt(6 / (3 + 1))
    for k, p in net.named_parameters():  # the port draws inside them too
        assert float(p.detach().abs().max()) <= bounds[k]


def test_step_ops_by_hand():
    """n = 10 nodes, e = 30 edges (E = 40 with the self-loops), widths
    [6, 8 x 2 = 16, 3 x 2 heads = 6] (hidden 2, 8 heads; 2 output heads of
    3 classes), bf16 operands."""
    cfg = config(hidden=2, heads=8, out_heads=2)
    model = spec.Model(cfg)
    n, e, E = 10, 30, 40
    ops = roofline.step_ops(model, n, e, [6, 16, 3], 2)
    kinds = [op.kind for op in ops]
    assert kinds == ["gemm", "attn", "agg", "gemm", "attn", "agg",
                     "attn", "attn", "agg", "gemm", "gemm",
                     "attn", "attn", "agg", "gemm"]
    ptrs = 4 * (n + 1)
    # layer 1 forward: 8 heads of 2
    assert ops[0] == roofline.gemm(n, 6, 16)
    assert (ops[1].flops, ops[1].bytes) == (
        5 * E * 8, 2 * n * 8 * 4 + 4 * E + ptrs + 4 * E * 8)
    assert (ops[2].flops, ops[2].bytes, ops[2].dim) == (
        2 * E * 16, n * 16 * (2 + 4) + 4 * E * 8 + 4 * E + ptrs, 16)
    # layer 2 backward first: 2 heads of 3
    w = 6
    assert (ops[6].flops, ops[6].bytes) == (
        2 * E * w + 4 * E * 2,
        n * w * (2 + 8) + 4 * E * 2 + 2 * n * 2 * 4 + 4 * E + ptrs
        + 4 * E * 2 + n * 2 * 4)
    assert (ops[7].flops, ops[7].bytes) == (
        E * 2, 4 * E * 2 + 4 * E + ptrs + n * 2 * 4)
    assert (ops[8].flops, ops[8].bytes) == (
        2 * E * w, n * w * (2 + 4) + 4 * E * 2 + 8 * E + ptrs)
    assert ops[9] == roofline.gemm(16, n, w)
    assert ops[10] == roofline.gemm(n, w, 16)
    assert ops[-1] == roofline.gemm(6, n, 16)  # no input gradient for x


@pytest.mark.parametrize("control", sorted(reference.CONTROLS))
def test_each_control_changes_the_reference(control):
    cfg = config(hidden=4)
    model = spec.Model(cfg)
    x, labels, params = data.make_inputs(9, model, TRAFFIC, "cpu")
    src, dst, n = tiny_graph()
    g = reference.Graph(src, dst, n, "cpu")
    stated = reference.follow(model, g, x, labels, params, 2)
    again = reference.follow(model, g, x, labels, params, 2)
    lower = reference.follow(model, g, x, labels, params, 2,
                             **reference.CONTROLS[control])
    assert stated["losses"] == again["losses"]
    assert lower["losses"] != stated["losses"]
    assert any(not torch.equal(a, b)
               for a, b in zip(lower["grad1"], stated["grad1"]))


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to bfloat16."""

    @staticmethod
    def forward(ctx, t):
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def test_the_adjoint_gathers_the_rounded_gradient():
    """At bfloat16 the aggregation gathers v rounded, and its adjoint the
    output's gradient rounded, while alpha's gradient takes it as it is:
    the dense formulation with v rounded and, for v's gradient alone, the
    incoming gradient rounded, gives the same gradients."""
    cfg = config(hidden=4)
    model, x, labels, params = inputs(cfg)
    src, dst, n = tiny_graph()
    g = reference.Graph(src, dst, n, "cpu")
    ps = [p.clone().requires_grad_(True) for p in params]
    got = reference.forward(model, ps, x, g, operand="bfloat16")
    plain = einsum = torch.einsum

    def split_einsum(eq, alpha, vb):
        whole = plain(eq, alpha, vb.detach())
        t = _RoundGrad.apply(plain(eq, alpha.detach(), vb))
        return whole + t - t.detach()

    torch.einsum = split_einsum
    try:
        qs = [p.clone().requires_grad_(True) for p in params]
        want = dense_forward(cfg, qs, x, src, dst, n, rnd=lambda t: t.to(
            torch.bfloat16).to(t.dtype))
    finally:
        torch.einsum = einsum
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    loss = lambda out: -out.gather(1, labels[:, None]).mean()  # noqa: E731
    for a, b in zip(torch.autograd.grad(loss(got), ps),
                    torch.autograd.grad(loss(want), qs)):
        assert torch.allclose(a, b, rtol=1e-10, atol=1e-13)
    f32 = reference.forward(model, params, x, g)
    assert not torch.equal(got, f32)


def _reader(name: str):
    return spec._load(os.path.join(REPO, "gnnbench", "metrics",
                                   f"{name}.py"), f"test_gat_reader_{name}")


def _ctx(kernel_s: dict, on_card: bool = True):
    cfg = config()
    trace = tracing.TraceSummary(steps=4, window_s=1.0, busy_s=1.0,
                                 kernels=40, kernel_s=kernel_s,
                                 device_ops=[], idle_gaps=[])
    return types.SimpleNamespace(
        on_card=on_card, trace=trace, nodes=1000, edges=9000,
        widths=[96, 64, 22],
        cell=types.SimpleNamespace(config=cfg, model=spec.Model(cfg)))


KERNEL_S = {
    "gat::softmax_kernel(gat::SoftmaxArgs)": 0.004,
    "void gat::sddmm_kernel<unsigned short>(gat::SddmmArgs)": 0.010,
    "gat::col_reduce_kernel(gat::ColArgs)": 0.002,
    "void gnna::gat_aggregate_kernel<unsigned short>(gnna::GatAggArgs)":
        0.020,
    "gnna::gat_fixup_kernel(gnna::GatFixArgs)": 0.001,
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8": 0.003,
}


def test_the_attention_readers_split_the_kernels_by_namespace():
    ctx = _ctx(KERNEL_S)
    assert _reader("attn_ms").read(ctx) == pytest.approx(1e3 * 0.016 / 4)
    assert tracing.agg_step_s(ctx.trace) == pytest.approx(0.021 / 4)
    ops = roofline.step_ops(ctx.cell.model, 1000, 9000, [96, 64, 22], 2)
    bound = sum(max(op.bytes / roofline.HBM_BYTES_PER_S,
                    op.flops / roofline.F32_FLOPS)
                for op in ops if op.kind == "attn")
    assert _reader("attn_roofline_pct").read(ctx) == pytest.approx(
        100 * bound / (0.016 / 4))


@pytest.mark.parametrize("case", ["off the card", "no trace",
                                  "no attention kernel"])
def test_the_attention_readers_give_nothing_without_their_kernels(case):
    ctx = _ctx({k: v for k, v in KERNEL_S.items() if "gat::" not in k},
               on_card=case != "off the card")
    if case == "no trace":
        ctx.trace = None
    for name in ("attn_ms", "attn_roofline_pct"):
        assert _reader(name).read(ctx) is None


@pytest.mark.card
def test_control_fails_at_the_gat_cells_size(card):
    c = spec.Cell("gat.amazon0505")
    seeds = [2300000000 + 7919 * i for i in range(3)]
    _, kinds = calibrate.readings(c, seeds, control=3, faults=3, device=card,
                                  emit=lambda line: None)
    assert all(check.verdict(r, c.limits) for r in kinds["program"])
    for kind in ("control_int8", "control_tf32", "half_batch"):
        assert len(kinds[kind]) == 3
        assert not any(check.verdict(r, c.limits) for r in kinds[kind])
