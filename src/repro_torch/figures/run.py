"""The figure drivers' command line (counterpart of the reference's
``benchmarks/run.py``):

    python -m repro_torch.figures.run                       # every driver, on cuda
    python -m repro_torch.figures.run fig1 fig9 --device cpu --out DIR
    BENCH_FULL=1 python -m repro_torch.figures.run fig1     # the paper's scale

Prints ``name,us_per_call,derived`` CSV rows (``fig8``: its loss rows)
and writes one JSON file per driver to ``--out`` (``figures_out/`` by
default).
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.figures import (
    auto_eps,
    fig1_burst,
    fig2_probabilistic,
    fig3_byzantine,
    fig4_nodes,
    fig5_epsilon,
    fig6_graphs,
    fig7_topology,
    fig8_learning,
    fig9_zoo,
    theory_bounds,
)


BENCHES = {
    "fig1": fig1_burst.run,
    "fig2": fig2_probabilistic.run,
    "fig3": fig3_byzantine.run,
    "fig4": fig4_nodes.run,
    "fig5": fig5_epsilon.run,
    "fig6": fig6_graphs.run,
    "fig7": fig7_topology.run,
    "fig8": fig8_learning.run,
    "fig9": fig9_zoo.run,
    "theory": theory_bounds.run,
    "auto_eps": auto_eps.run,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help=f"drivers to run (default: all): "
                                             f"{', '.join(BENCHES)}")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--out", default=None, help="results directory (default: figures_out)")
    args = ap.parse_args(argv)
    names = args.names or list(BENCHES)
    for name in names:
        if name not in BENCHES:
            raise SystemExit(f"unknown driver {name!r}; have {list(BENCHES)}")
    print("name,us_per_call,derived", flush=True)
    t0 = time.time()
    for name in names:
        t1 = time.time()
        BENCHES[name](device=args.device, out=args.out)
        print(f"# {name}: {time.time() - t1:.1f} s", file=sys.stderr, flush=True)
    print(f"# total wall time: {time.time() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
