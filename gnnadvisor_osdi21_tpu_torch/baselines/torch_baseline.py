"""Torch GNN baseline in the PyG idiom, the second comparator stack: the
port of ``gnnadvisor_osdi21_tpu/baselines/torch_baseline.py``.

The reference evaluates against two independent framework stacks,
``dgl_baseline/`` and ``pyg_baseline/`` (SURVEY.md §2.1 #20-21;
dgl_baseline/dgl_main.py, pyg_baseline/pyg_main.py).  ``naive`` plays the
DGL role; this module plays the PyG role: ``index_select`` + ``index_add_``
(scatter-add) message passing and torch autograd, with the JAX package's
``_init_weights``, ``forward`` and ``forward_numpy``.  The JAX package runs
it on the host CPU; here it runs on ``--device``, the card by default, so
that its column is measured on the same silicon as the tuned stack.

Besides the table, it is a cross-framework correctness oracle:
``forward_numpy`` runs the forward on NumPy inputs on the host.

Timing: 10 warm-up steps, then the host's wall time over ``epochs``
steps, fenced by a ``torch.cuda.synchronize``.

Usage: python -m gnnadvisor_osdi21_tpu_torch.baselines.torch_baseline
           [gcn|gin] [--quick] [--dataset NAME] [--epochs N] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gnnadvisor_osdi21_tpu_torch.baselines import time_steps
from gnnadvisor_osdi21_tpu_torch.ops.reference import csr_to_coo


def _layers(model: str, dim: int, hidden: int, classes: int):
    if model == "gcn":
        return [(dim, hidden), (hidden, classes)]
    return [(dim, hidden), (hidden, hidden), (hidden, hidden),
            (hidden, hidden), (hidden, classes)]


def _init_weights(model, dim, hidden, classes, seed=0):
    """Same ±1/sqrt(out_dim) uniform init family as the reference's
    nn.Parameter reset (GNNAdvisor/gnn_conv.py param reset semantics)."""
    gen = torch.Generator().manual_seed(seed)
    ws = []
    for i, o in _layers(model, dim, hidden, classes):
        bound = 1.0 / np.sqrt(o)
        w = torch.empty(i, o).uniform_(-bound, bound, generator=gen)
        ws.append(torch.nn.Parameter(w))
    return ws


def _aggregate(h, src, dst, weight=None):
    """out[s] += w_sd · h[d] — gather + index_add_ (the torch scatter-add
    idiom PyG's MessagePassing lowers to)."""
    msg = h.index_select(0, dst)
    if weight is not None:
        msg = msg * weight[:, None]
    out = torch.zeros_like(h)
    out.index_add_(0, src, msg)
    return out


def forward(ws, x, src, dst, deg, model: str, eps: float = 0.5):
    if model == "gcn":
        w_edge = deg[src] * deg[dst]
        h = torch.relu(_aggregate(x @ ws[0], src, dst, w_edge))
        h = _aggregate(h @ ws[1], src, dst, w_edge)
        return torch.log_softmax(h, dim=1)
    h = x
    for i, w in enumerate(ws):
        h = eps * _aggregate(h, src, dst) @ w
        if i < len(ws) - 1:
            h = torch.relu(h)
    return torch.log_softmax(h, dim=1)


def _edges(graph, device):
    """(src, dst, deg) of ``graph`` on ``device``."""
    src = torch.from_numpy(
        np.asarray(csr_to_coo(graph.row_pointers, graph.column_index),
                   dtype=np.int64))
    dst = torch.from_numpy(np.asarray(graph.column_index, dtype=np.int64))
    deg = torch.from_numpy(np.asarray(graph.degrees, dtype=np.float32))
    return src.to(device), dst.to(device), deg.to(device)


def forward_numpy(graph, x: np.ndarray, ws_np, model: str) -> np.ndarray:
    """Cross-framework oracle hook: run the torch forward on NumPy inputs
    (on the host)."""
    src, dst, deg = _edges(graph, "cpu")
    ws = [torch.from_numpy(np.asarray(w, dtype=np.float32)) for w in ws_np]
    with torch.no_grad():
        out = forward(ws, torch.from_numpy(np.asarray(x, dtype=np.float32)),
                      src, dst, deg, model)
    return out.numpy()


def run(dataset: str, model: str, epochs: int, device=None, weights=None,
        stats: dict | None = None) -> float:
    """Milliseconds per training step on ``dataset`` on ``device`` (None:
    the card), from ``weights`` (numpy arrays, one per layer; default
    ``_init_weights``).  ``stats``, when given, receives ``first_loss``:
    the loss of the first step, before any update; and ``log_probs``:
    that step's forward, [N, classes]."""
    from gnnadvisor_osdi21_tpu_torch.bench.datasets import DATASETS, get_dataset
    from gnnadvisor_osdi21_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    _, _, dim, classes, _, _ = DATASETS[dataset]
    g = get_dataset(dataset)
    src, dst, deg = _edges(g, dev)
    x = torch.from_numpy(g.init_embedding(dim)).to(dev)
    y = torch.from_numpy(g.init_labels(classes).astype(np.int64)).to(dev)
    hidden = 16 if model == "gcn" else 64
    if weights is None:
        ws = [torch.nn.Parameter(w.detach().to(dev))
              for w in _init_weights(model, dim, hidden, classes)]
    else:
        # copies: the steps update the parameters in place
        ws = [torch.nn.Parameter(torch.tensor(np.asarray(w, np.float32),
                                              device=dev)) for w in weights]
    opt = torch.optim.Adam(ws, lr=0.01)
    if stats is not None:
        with torch.no_grad():
            stats["log_probs"] = forward(ws, x, src, dst, deg, model)

    def epoch():
        opt.zero_grad()
        loss = torch.nn.functional.nll_loss(
            forward(ws, x, src, dst, deg, model), y)
        loss.backward()
        opt.step()
        return loss

    return time_steps(epoch, dev, epochs, stats)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    model = argv[0] if argv and not argv[0].startswith("-") else "gcn"
    quick = "--quick" in argv
    from gnnadvisor_osdi21_tpu_torch.bench.datasets import DATASETS, QUICK
    from gnnadvisor_osdi21_tpu_torch.device import card_description

    device = argv[argv.index("--device") + 1] if "--device" in argv else None
    roster = QUICK if quick else list(DATASETS)
    if "--dataset" in argv:  # single-config mode (resumable campaigns)
        roster = [argv[argv.index("--dataset") + 1]]
    epochs = 50 if quick else 200
    if "--epochs" in argv:
        epochs = int(argv[argv.index("--epochs") + 1])
    print(f"# device: {card_description(device)}", flush=True)
    for name in roster:
        print(f"Namespace(dataset='{name}', baseline='torch')")
        ms = run(name, model, epochs, device)
        print(f"Time (ms): {ms:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
