"""Multi-host training demo and check: the port of
``gnnadvisor_osdi21_tpu/tools/multihost_demo.py``.

Starts ``hosts x local_devices`` rank processes on this machine, each
given its rank, the world size, its local rank (its index among its
host's ranks) and the path of a ``file://`` store on its command line:
the launch a real multi-host job makes on each host, here on one.  The
ranks join one ``torch.distributed`` group (``parallel.mesh.make_group``,
rank r of host h on ``cuda:<local rank>``) and run 3 steps of the
ELL-sharded GCN (``dist_ops``), the same program a job across hosts
runs.  On the card each simulated host sees only its own cards
(``CUDA_VISIBLE_DEVICES``: host h gets cards h·L .. h·L + L - 1), as a
real host would; more ranks than cards exits non-zero and names both
counts.  ``--device cpu`` runs gloo ranks on the host.

Usage (2 simulated hosts x 2 ranks, on the host):
    python -m gnnadvisor_osdi21_tpu_torch.tools.multihost_demo --hosts 2 --local_devices 2 --device cpu

Each rank prints its host id and its loss; the last line is
``multihost demo: OK`` when every rank exited 0 with the same loss.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

STEPS = 3
JOIN_TIMEOUT_S = 600
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_LOSS = re.compile(r"loss after \d+ steps: (\S+)")


def worker(rank: int, hosts: int, local_devices: int, init_file: str,
           device=None) -> int:
    """Rank ``rank``: join the group, run ``STEPS`` ELL steps of GCN on the
    demo's graph, print the loss."""
    import torch

    from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
    from gnnadvisor_osdi21_tpu_torch.parallel.dist_ops import (
        make_dist_train_step,
    )
    from gnnadvisor_osdi21_tpu_torch.parallel.mesh import (
        destroy_group, make_group,
    )
    from gnnadvisor_osdi21_tpu_torch.parallel.partition import shard_graph

    world = hosts * local_devices
    host_id, local = divmod(rank, local_devices)
    if device == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    group = make_group(world, device, rank, init_file, local_rank=local)
    try:
        print(f"[host {host_id}] rank {rank} of {world} on {group.device} "
              f"({group.backend})", flush=True)
        g = synthesize_graph(64 * world, 512 * world, num_features=16,
                             num_classes=5, seed=1)
        sg = shard_graph(g, num_devices=world, part_size=4)
        step, init = make_dist_train_step(group, sg, "gcn")
        net, opt, x, y = init(torch.Generator().manual_seed(0), 16, 16,
                              g.num_classes, g.init_embedding(16),
                              g.init_labels(g.num_classes))
        for _ in range(STEPS):
            loss = step(net, opt, x, y)
        print(f"[host {host_id}] rank {rank} loss after {STEPS} steps: "
              f"{float(loss):.9g}", flush=True)
    finally:
        destroy_group(group)
    return 0


def _visible_cards() -> list[str]:
    import torch

    listed = os.environ.get("CUDA_VISIBLE_DEVICES")
    if listed:
        return [c for c in listed.split(",") if c]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [str(i) for i in range(n)]


def run(hosts: int, local_devices: int, device=None, log=print) -> dict:
    """Launch the ranks and wait for them; returns each rank's exit code
    (``rcs``), each rank's printed loss (``losses``, None where it printed
    none) and ``ok``."""
    world = hosts * local_devices
    on_host = device is not None and str(device) == "cpu"
    cards = [] if on_host else _visible_cards()
    if not on_host and len(cards) < world:
        raise ValueError(f"need {world} CUDA cards (one per rank), have "
                         f"{len(cards)} (on the host: --device cpu, gloo)")
    tmp = tempfile.mkdtemp(prefix="gnna_multihost_")
    procs, logs = [], []
    try:
        for r in range(world):
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                [_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
            h = r // local_devices
            if not on_host:
                env["CUDA_VISIBLE_DEVICES"] = ",".join(
                    cards[h * local_devices:(h + 1) * local_devices])
            cmd = [sys.executable, "-m",
                   "gnnadvisor_osdi21_tpu_torch.tools.multihost_demo",
                   "--hosts", str(hosts), "--local_devices",
                   str(local_devices), "--init_file",
                   os.path.join(tmp, "store"), "--worker", str(r)]
            if on_host:
                cmd += ["--device", "cpu"]
            out = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            logs.append(out)
            procs.append(subprocess.Popen(cmd, stdout=out,
                                          stderr=subprocess.STDOUT, env=env))
        # a rank that fails leaves the others waiting in a collective: stop
        # waiting at the first failure (the rest are ended below)
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.1)
        rcs = [p.poll() for p in procs]  # None: still running, ended below
        losses = []
        for r, out in enumerate(logs):
            out.seek(0)
            text = out.read()
            for line in text.splitlines():
                log(line)
            found = _LOSS.findall(text)
            losses.append(float(found[-1]) if found else None)
            if rcs[r] != 0:
                log(f"rank {r} exited {rcs[r]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out in logs:
            out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    ok = (all(rc == 0 for rc in rcs) and None not in losses
          and len(set(losses)) == 1)
    log("multihost demo: " + ("OK" if ok else
                              f"FAILED rcs={rcs} losses={losses}"))
    return {"rcs": rcs, "losses": losses, "ok": ok}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hosts", type=int, default=2)
    p.add_argument("--local_devices", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="cpu: gloo ranks (default: the card, NCCL)")
    p.add_argument("--init_file", default="", help=argparse.SUPPRESS)
    p.add_argument("--worker", type=int, default=-1, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker >= 0:
        return worker(args.worker, args.hosts, args.local_devices,
                      args.init_file, args.device)
    try:
        res = run(args.hosts, args.local_devices, args.device)
    except ValueError as e:
        print(f"error: --hosts {args.hosts} --local_devices "
              f"{args.local_devices}: {e}", file=sys.stderr)
        return 2
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
