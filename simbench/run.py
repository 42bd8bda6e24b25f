"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: one run of
one cell of ``BENCHMARK.json`` on the CUDA devices of this machine.

    python3 simbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the card's name, power limit and SM clock at the window's start
and end, then, as the last line of standard output, one JSON object:
``correct``, ``attempted`` / ``failed`` (studies), ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, last, ``compared`` (each number the comparison with the
reference judged, beside its limit). The compared numbers end standard
error too. Exits non-zero, and prints no result, without a CUDA device,
without ``src/repro_torch``, or where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def read_metric(name: str, record: dict):
    spec = importlib.util.spec_from_file_location(f"simbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # every cache of the program inside the checkout, at fixed paths (the
    # kernels themselves build into build/kernels/, fixed by the program)
    build = CHECKOUT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    for var in ("REPRO_ESTIMATOR_IMPL", "REPRO_ROUND_IMPL"):  # "auto" means the defaults
        os.environ.pop(var, None)
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]

    from simbench import harness

    cell = harness.load_cell(args.workload)
    chips = cell.chips
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"simbench: {args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"simbench: the system under test is missing: {exc}", file=sys.stderr)
        return 1
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    try:
        record = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                  T_START, log=log)
    except Exception:  # the run failed: say why, print no result
        traceback.print_exc()
        return 1
    bad = sorted(set(record["forbidden"]) | set(harness.forbidden_modules()))
    if bad:
        print(f"simbench: loaded in this process: {bad}", file=sys.stderr)
        return 3
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = read_metric(m["name"], record)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    limits = cell.traffic["limits"]
    compared = {k: dict(value=v, limit=limits[k]) for k, v in record["compared"].items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips,
                  memory_peak_bytes=record["peak_bytes"])
    result = dict(correct=correct, attempted=record["studies"], failed=0, metrics=metrics,
                  device=device)
    if record["trace"]:
        device.update(busy_s=record["trace"]["busy_s"], window_s=record["trace"]["window_s"])
        result["breakdown"] = dict(device_ops=record["trace"]["device_ops"],
                                   idle_gaps=record["trace"]["idle_gaps"][:10])
    result["compared"] = compared
    log(f"[simbench] {args.workload} seed {args.seed}: {record['studies']} studies in "
        f"{record['window_s']:.3f} s (each {', '.join(f'{s:.3f}' for s in record['study_s'])}"
        f" s), set-up {record['setup_s']:.3f} s, reference {record['reference_s']:.3f} s on "
        f"{record['compared_rows']} rows, peak {record['peak_bytes']} bytes")
    for k, c in compared.items():
        log(f"compared {k} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
