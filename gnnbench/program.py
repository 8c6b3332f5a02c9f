"""The system under test: the port's user path, from an edge-list file to
the captured training step that the window replays.

``Program.build`` loads the cell's graph through the port's loader, runs
the decider in auto mode and builds its tensors, puts the harness's
seeded inputs into the port's model and optimizer, warms the step up and
captures it (``train.make_captured_step``).  It then restores the seeded
weights and a fresh optimizer state in place, and replays the captured
step three times: the reference follows those first steps.  The window
replays the same object.
"""

from __future__ import annotations

import time

import torch

from gnnbench import data, graphgen

WARMUP_STEPS = 3
FIRST_STEPS = 3  # replays the reference follows
MIN_STEP_S = 2e-5  # sizes the captured step's loss history


class EagerSteps:
    """The captured step's stand-in on the host, where nothing can be
    captured: ``replay()`` runs the training step once and keeps its
    loss."""

    def __init__(self, step):
        self.step = step
        self.history: list[torch.Tensor] = []
        self.replays = 0

    def replay(self) -> None:
        self.history.append(self.step())
        self.replays += 1

    def losses(self) -> list[float]:
        return torch.stack(self.history).tolist() if self.history else []


class Program:
    """Everything the port built for one run, and what its first steps
    read."""

    def __init__(self):
        self.layout_s = 0.0
        self.readings: dict = {}

    @classmethod
    def build(cls, cell, seed: int, device: torch.device, cache_dir: str,
              seconds: float, log=print) -> "Program":
        t = time.perf_counter()
        from gnnadvisor_osdi21_tpu_torch import train
        from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import (
            graph_fingerprint,
        )
        from gnnadvisor_osdi21_tpu_torch.graphs.loader import load_graph
        from gnnadvisor_osdi21_tpu_torch.ops.aggregate import exact_f32_matmul
        from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty

        self = cls()
        cfg, traffic, arch = cell.config, cell.traffic, cell.model.arch
        if traffic["reorder"]:
            raise ValueError("a reordered graph cannot be checked yet: the "
                             "decider does not expose its permutation")
        on_card = device.type == "cuda"
        self.device, self.on_card = device, on_card
        phases = {"import": time.perf_counter() - t}
        t = time.perf_counter()
        path = graphgen.edge_file(traffic, cache_dir)
        graph = load_graph(path, num_features=int(traffic["features"]),
                           num_classes=int(traffic["classes"]))
        phases["graph"] = time.perf_counter() - t
        log(f"# graph {cell.workload['traffic']}: {graph.num_nodes} nodes, "
            f"{graph.nnz} edges after merging, fingerprint "
            f"{graph_fingerprint(graph)}, load {phases['graph']:.3f} s")

        prec = cfg["precision"]
        prop = InputProperty(
            graph, int(cfg["hidden"]), model=arch.PORT,
            manual_mode=False, enable_reorder=False,
            agg_dtype=prec["agg_operands"], gemm_dtype=prec["gemm"],
        )
        t = time.perf_counter()
        prop.decider()
        hts = prop.build_tensors(device=device)
        self.layout_s = phases["layout"] = time.perf_counter() - t
        self.hts, self.prop = hts, prop
        hg = prop.hybrid_graph
        self.transposed = bool(getattr(hts[0], "transposed", False))
        if hg is not None:
            orient = "transposed" if self.transposed else "row-major"
            log(f"# layout: method hybrid, {orient}, diag_b "
                f"{hg.diag_b}, hot_k {hg.hot_k}, res_tile {hg.res_tile}, "
                f"res_ob {hg.res_ob}; edges diag {hg.num_diag_edges}, hot "
                f"{hg.num_hot_edges}, residual {hg.num_res_edges}; tier "
                f"probe: {hg.tier_probe}; {self.layout_s:.3f} s")
        else:
            log(f"# layout: method {prop.layer_input.method}; "
                f"{self.layout_s:.3f} s")

        t = time.perf_counter()
        x, labels, params0 = data.make_inputs(seed, cell.model, traffic,
                                              device)
        n = x.shape[0]
        rows = hg.num_rows if hg is not None else n
        xr = torch.zeros((rows, x.shape[1]), dtype=torch.float32,
                         device=device)
        xr[:n] = x
        if self.transposed:
            xr = xr.t().contiguous()
        yr = torch.zeros((rows,), dtype=torch.int64, device=device)
        yr[:n] = labels
        mask = hts[0].row_mask if hg is not None else None
        del x, labels

        ws = arch.widths(cfg, traffic)
        net = train.MODELS[arch.PORT](
            ws[0], int(cfg["hidden"]), ws[-1],
            generator=torch.Generator().manual_seed(0), device=device,
            **arch.port_kwargs(cfg))
        names = [name for name, _, _ in arch.weights(cfg, traffic)]
        if [k for k, _ in net.named_parameters()] != names:
            raise ValueError(f"the port's {arch.PORT} has weights "
                             f"{[k for k, _ in net.named_parameters()]}, "
                             f"the configuration {names}")
        net.params_from_jax({k: p.cpu().numpy()
                             for k, p in zip(names, params0)})
        if on_card:
            exact_f32_matmul()
        opt_cfg = cfg["optimizer"]
        opt = train.make_optimizer(net, float(opt_cfg["lr"]))
        group = opt.param_groups[0]
        stated = (opt_cfg["b1"], opt_cfg["b2"], opt_cfg["eps"])
        if (tuple(group["betas"]) + (group["eps"],)) != stated:
            raise ValueError(f"the port's Adam has betas {group['betas']} "
                             f"and eps {group['eps']}, the configuration "
                             f"{stated}")
        self.net, self.opt, self.params0 = net, opt, params0
        self.x, self.y, self.mask = xr, yr, mask

        phases["inputs and model"] = time.perf_counter() - t
        t = time.perf_counter()
        step = train.make_train_step(net, hts, opt, mask)
        train.warm_up(lambda: step(xr, yr), WARMUP_STEPS, device)
        phases["warm-up"] = time.perf_counter() - t
        t = time.perf_counter()
        if on_card:
            capacity = FIRST_STEPS + 64 + int(seconds / MIN_STEP_S)
            self.stepper = train.make_captured_step(
                net, hts, opt, xr, yr, mask, capacity=capacity)
        else:
            self.stepper = EagerSteps(lambda: step(xr, yr))
        phases["capture"] = time.perf_counter() - t
        t = time.perf_counter()
        self._restart()
        self._first_steps(float(opt_cfg["b1"]))
        phases["first steps"] = time.perf_counter() - t
        log("# set-up phases (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in phases.items()))
        return self

    @torch.no_grad()
    def _restart(self) -> None:
        """The seeded weights and a fresh optimizer state, in place, so
        that the captured step's next replay is training's first step."""
        for p, p0 in zip(self.net.parameters(), self.params0):
            p.copy_(p0)
            for v in self.opt.state.get(p, {}).values():
                if isinstance(v, torch.Tensor):
                    v.zero_()

    def _first_steps(self, b1: float) -> None:
        """Replay the first steps and read them: the first gradient from
        Adam's first moment after one step, the change of every weight
        after the last, and each step's loss."""
        params = list(self.net.parameters())
        self.replay()
        grad1 = []
        for p in params:
            m = self.opt.state.get(p, {}).get("exp_avg")
            grad1.append(torch.zeros_like(p) if m is None
                         else m.detach() / (1.0 - b1))
        for _ in range(FIRST_STEPS - 1):
            self.replay()
        delta = [(p.detach() - p0) for p, p0 in zip(params, self.params0)]
        self.sync()
        self.readings = {
            "losses": self.stepper.losses()[-FIRST_STEPS:],
            "grad1": [g.float().clone() for g in grad1],
            "delta": [d.float().clone() for d in delta],
        }

    def reseed(self, seed: int, cell) -> None:
        """New seeded inputs in the captured step's own buffers, then the
        first steps again (for reading many seeds from one build)."""
        x, labels, params0 = data.make_inputs(seed, cell.model, cell.traffic,
                                              self.device)
        n = x.shape[0]
        with torch.no_grad():
            if self.transposed:
                self.x[:, :n] = x.t()
            else:
                self.x[:n] = x
            self.y[:n] = labels
        self.params0 = params0
        self._restart()
        self._first_steps(float(cell.config["optimizer"]["b1"]))

    def replay(self) -> None:
        self.stepper.replay()

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def losses(self) -> list[float]:
        self.sync()
        return self.stepper.losses()

    def free(self) -> None:
        """Drop everything the program holds, so the reference that runs
        next has the card to itself."""
        for k in ("stepper", "net", "opt", "hts", "prop", "x", "y", "mask",
                  "params0"):
            self.__dict__.pop(k, None)
        if self.on_card:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

