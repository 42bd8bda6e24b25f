#!/usr/bin/env python3
"""Device time of the main path's captured round, and of whole_round at
its shape, on one CUDA card, for this checkout or another.

    python3 tools/round_times.py [--src DIR] [--steps 1500] [--groups 7]

The main path is ``chip_smoke.py`` phase 3's: the paper's DecAFork and
DecAFork+ ensembles (regular graph n 100, d 8; Z0 10, W 64, B 1024, 50
seeds, decisions from step 1000) through ``Experiment.ensemble`` on
cuda, captured; the captured round is then replayed in groups of 200
rounds between CUDA events (the device's time alone, host launches
excluded), and the median group's ms per round is printed beside the
graph's kernel nodes. whole_round is timed at phase 2's main-path shape
(batch 50, n 100, W 64, B 1024, D 8; ``device_ms``: calls replayed as a
CUDA graph). ``--src`` picks the ``src/`` directory whose
``repro_torch`` is timed, so two commits compare in one call (run them
in turns: parent, change, change, parent). Prints the card's name and
power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP = 200  # replays between two events (under the runner's 256-round recording chunk)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--groups", type=int, default=7)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("round_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.api import plan as plan_mod
    from repro_torch.graphs import make_graph
    from repro_torch.kernels import whole_round

    graph = make_graph("regular", cs.PAPER["n"], seed=0, degree=cs.PAPER["degree"])
    rows = []
    for alg in cs.ALGS:
        plan_mod.clear_cache()
        cs.main_experiment(graph, alg, args.steps).ensemble(cs.PAPER["seeds"])
        (runner,) = plan_mod._EXECUTABLES.values()
        times = []
        for _ in range(args.groups):
            runner.column.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            runner.graph.replay(GROUP)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / GROUP)
        rows.append(dict(what=f"captured round, {alg}", device_ms_per_round=sorted(times)[
            args.groups // 2], groups_ms=times, graph_kernel_nodes=runner.graph.kernel_nodes))
    plan_mod.clear_cache()
    rng = np.random.default_rng(0)
    x = cs.whole_round_inputs(rng, 50, cs.PAPER["n"], 64, 1024, 8, 64, 2, graph, "cuda")
    rows.append(dict(what="whole_round, batch 50, n 100", device_ms=cs.cuda_ms(
        lambda: whole_round(*x, decafork_plus=True), 50, graph=True)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(json.dumps(dict(src=args.src, device=torch.cuda.get_device_name(0), rows=rows)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
