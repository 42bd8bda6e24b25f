#!/usr/bin/env python3
"""Device memory that the PyTorch port's compiled execution takes and
keeps, on one CUDA card.

    python3 tools/memory_probe.py [--src DIR] [--steps 9000]

Two workloads, in one process:

- rounds: ``chip_smoke.py`` phase 7's DecAFork group (Fig. 5's four eps,
  50 seeds each: 200 rows; the paper's graph, protocol and bursts) through
  ``Experiment.sweep_stacked`` with full outputs, ``--steps`` rounds,
  twice (the second run replays the cached graph);
- decode: mamba2-1.3b at its published width, ``generate`` on batch 4 x
  prompt 512 at six ``max_new_tokens`` (six decode signatures), then the
  first again.

For each call: ``peak`` is the allocator's peak during the call above
what was allocated before it, ``kept`` what stays allocated after its
results are dropped, and ``kept_reserved`` what the allocator still
reserves then (after ``empty_cache``: the captured graphs' private pools
included). ``--src`` picks the ``src/`` directory whose ``repro_torch``
is measured (default: this checkout's), so two commits compare in one
call. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measured(fn):
    """(peak bytes above the start, bytes kept, bytes reserved after) of ``fn()``."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - start
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return dict(peak=peak, kept=torch.cuda.memory_allocated() - start,
                kept_reserved=torch.cuda.memory_reserved())


def rounds(steps: int) -> list:
    from repro_torch.api import Experiment
    from repro_torch.core import FailureConfig, ProtocolConfig
    from repro_torch.graphs import make_graph

    graph = make_graph("regular", 100, seed=0, degree=8)
    fail = FailureConfig(burst_times=(2000, 6000), burst_sizes=(5, 6))
    scen = [(ProtocolConfig(algorithm="decafork", eps=e, z0=10, max_walks=64, rt_bins=1024,
                            protocol_start=1000, estimator_impl="auto", round_impl="auto"),
             fail) for e in (1.8, 2.0, 2.25, 2.5)]
    plan = Experiment(graph=graph, scenarios=scen, steps=steps, outputs="full",
                      device="cuda").plan()
    return [measured(lambda: plan.sweep_stacked(seeds=50)) for _ in range(2)]


def decode() -> list:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model
    from repro_torch.utils import prng

    cfg = get_config("mamba2_1_3b", use_pallas=True)
    model = Model(cfg)
    params = model.init(prng.key(0), "cuda")
    toks = {"tokens": torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                                        (4, 512)),
                                      dtype=torch.int32, device="cuda")}
    out = []
    for new in (8, 9, 10, 11, 12, 13, 8):
        out.append(dict(max_new_tokens=new,
                        **measured(lambda: generate(model, params, toks, new)),
                        decode_loops_kept=len(model.decode_graphs)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--steps", type=int, default=9000)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("memory_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    print(json.dumps(dict(src=args.src, steps=args.steps, device=torch.cuda.get_device_name(0),
                          rounds=rounds(args.steps), decode=decode())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
