"""The readings the comparison's limits are set from, for one cell on the
card: for each seed, one study of the program at the cell's sizes (the
study a run's window would run first, from the key of ``(seed, 0)``)
against the reference (the sound reading), and the control, the
reference in bfloat16 put in the program's place (``reference/simulate``'s
``precision``), against the same reference (the control's reading).
Set-up is paid once for all seeds.

    python3 simbench/readings.py --workload <cell> --seeds 1 2 3 ...

Prints one JSON line a seed, then the largest sound reading and the
smallest control reading of each compared number.
"""
import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    import torch

    from simbench import harness
    from simbench.reference import compare

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    run = harness.Run(cell, "cuda")
    tr = cell.traffic
    sound, control = [], []
    for seed in args.seeds:
        t0 = time.perf_counter()
        key = harness.study_key(seed, 0)
        result = run.study(key)
        jobs = harness.reference_jobs(run, key, seed, int(tr["compare_rows"]),
                                      int(tr.get("compare_chunk", tr["compare_rows"])))
        got = [harness.program_rows(result[g], rows) for g, rows, _ in jobs]
        del result
        want = harness.run_reference(jobs, "cuda", int(tr.get("compare_workers", 1)))
        for _, _, kw in jobs:
            kw["precision"] = "bfloat16"
        ctl = harness.run_reference(jobs, "cuda", int(tr.get("compare_workers", 1)))
        s = compare.compare(got, want)
        c = compare.compare([(o, f) for o, f in ctl], want)
        sound.append(s)
        control.append(c)
        print(json.dumps(dict(seed=seed, sound=s, control=c,
                              forks=int(sum(w[0]["forks"].sum() for w in want)),
                              terms=int(sum(w[0]["terms"].sum() for w in want)),
                              seconds=time.perf_counter() - t0)), flush=True)
    print(json.dumps(dict(
        workload=args.workload, seeds=args.seeds,
        lower={k: max(r[k] for r in sound) for k in sound[0]},
        upper={k: min(r[k] for r in control) for k in control[0]})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
