"""Naive PyTorch GNN baseline on the card, the sibling-stack comparator:
the twin of ``gnnadvisor_osdi21_tpu/baselines/jax_naive.py`` (named for
what it holds, which is no JAX).

Plays the role of the reference's ``dgl_baseline/`` (SURVEY.md §2.1
#20-21): an independent, framework-idiomatic implementation of the same
2-layer GCN / 5-layer GIN workloads with none of the port's layout or
kernels.  The graph is a COO list sorted by source; a layer gathers
``h[dst]`` with ``index_select`` and sums each source's run with
``torch.segment_reduce`` over the source offsets (the JAX baseline's
sorted ``segment_sum``); autograd gives the backward; the loop is
``torch.optim.Adam(lr=0.01)`` on the mean NLL over all nodes.  Speedups of
the tuned stack over this baseline on the same card are the analog of
the GNNAdvisor-vs-DGL tables.

Timing, as the JAX baseline's: 10 warm-up steps, then the host's wall
time over ``epochs`` steps, fenced by a ``torch.cuda.synchronize``.

Usage: python -m gnnadvisor_osdi21_tpu_torch.baselines.naive [gcn|gin]
           [--quick] [--dataset NAME] [--epochs N] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gnnadvisor_osdi21_tpu_torch.baselines import time_steps, torch_baseline
HIDDEN = {"gcn": 16, "gin": 64}


def _segment_sum(vals: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    return torch.segment_reduce(vals, "sum", offsets=offsets, axis=0,
                                unsafe=True)


def gcn_layer(x, w, coo_src, coo_dst, degrees, offsets):
    """Σ_{d∈N(s)} deg[s]·deg[d]·(x @ w)[d], per source s."""
    h = x @ w
    vals = h.index_select(0, coo_dst) * (degrees[coo_src] * degrees[coo_dst])[:, None]
    return _segment_sum(vals, offsets)


def gin_layer(x, w, coo_dst, offsets, eps=0.5):
    """(ε · Σ_{d∈N(s)} x[d]) @ w, per source s."""
    return eps * _segment_sum(x.index_select(0, coo_dst), offsets) @ w


def graph_tensors(graph, device) -> tuple[torch.Tensor, ...]:
    """(coo_src, coo_dst, degrees, offsets) of ``graph`` on ``device``:
    the CSR's edges are already sorted by source, and its row pointers
    are the source offsets."""
    rp = np.asarray(graph.row_pointers, dtype=np.int64)
    src = np.repeat(np.arange(graph.num_nodes, dtype=np.int64), np.diff(rp))

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    return (put(src, torch.int64), put(graph.column_index, torch.int64),
            put(graph.degrees, torch.float32), put(rp, torch.int64))


def forward(ws, x, tensors, model: str) -> torch.Tensor:
    """Log-probabilities [N, classes] of the GCN or GIN with weights
    ``ws`` over ``graph_tensors``."""
    src, dst, deg, offsets = tensors
    if model == "gcn":
        h = torch.relu(gcn_layer(x, ws[0], src, dst, deg, offsets))
        return torch.log_softmax(gcn_layer(h, ws[1], src, dst, deg, offsets), 1)
    h = x
    for i, w in enumerate(ws):
        h = gin_layer(h, w, dst, offsets)
        if i < len(ws) - 1:
            h = torch.relu(h)
    return torch.log_softmax(h, 1)


def loss_fn(ws, x, y, tensors, model: str) -> torch.Tensor:
    """Mean negative log-likelihood of the labels over every node."""
    lp = forward(ws, x, tensors, model)
    return -lp.gather(1, y[:, None]).mean()


def run(dataset: str, model: str, epochs: int, device=None, weights=None,
        stats: dict | None = None) -> float:
    """Milliseconds per training step of the baseline on ``dataset`` (the
    roster's graph and widths) on ``device`` (None: the card), from
    ``weights`` (numpy arrays, one per layer; default
    ``torch_baseline._init_weights``).
    ``stats``, when given, receives ``first_loss``: the loss of the first
    step, before any update; and ``log_probs``: that step's forward,
    [N, classes]."""
    from gnnadvisor_osdi21_tpu_torch.bench.datasets import DATASETS, get_dataset
    from gnnadvisor_osdi21_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    _, _, dim, classes, _, _ = DATASETS[dataset]
    g = get_dataset(dataset)
    tensors = graph_tensors(g, dev)
    x = torch.from_numpy(g.init_embedding(dim)).to(dev)
    y = torch.from_numpy(g.init_labels(classes).astype(np.int64)).to(dev)
    if weights is None:  # the PyG-role baseline's init, seed 0
        weights = [w.detach().numpy() for w in torch_baseline._init_weights(
            model, dim, HIDDEN[model], classes)]
    # copies: the steps update the parameters in place
    ws = [torch.nn.Parameter(torch.tensor(np.asarray(w, np.float32),
                                          device=dev)) for w in weights]
    opt = torch.optim.Adam(ws, lr=0.01)
    if stats is not None:
        with torch.no_grad():
            stats["log_probs"] = forward(ws, x, tensors, model)

    def step():
        opt.zero_grad()
        loss = loss_fn(ws, x, y, tensors, model)
        loss.backward()
        opt.step()
        return loss

    return time_steps(step, dev, epochs, stats)


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
        print(f"Namespace(dataset='{name}', baseline='naive')")
        ms = run(name, model, epochs, device)
        print(f"Time (ms): {ms:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
