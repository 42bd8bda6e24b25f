#!/usr/bin/env python3
"""Device times of the port's two float32 CUDA-core kernels at the shapes
their paths run, on one CUDA card, for this checkout or another.

    python3 tools/f32_kernel_times.py [--src DIR] [--reps 20]

- flash_attention, float32, at paper-rwsgd's prefill (B 4, S 128, H 8,
  KV 4, D 32) and at yi-6b's float32 gate (B 4, S 512, H 32, KV 4,
  D 128);
- ssd_intra_chunk, float32 B / C, at mamba2-1.3b's prefill (batch 4, 2
  chunks of 256, H 64, P 64, N 128).

Inputs are drawn from numpy seeds. Each time is the median over 7 groups
of ``--reps`` calls captured once as a CUDA graph and replayed (the
device's time alone), by CUDA events, as ``chip_smoke.py`` phase 2 times
``device_ms``. Each output is compared with the plain version: its
largest absolute difference, and for the SSD whether it is bitwise.
``--src`` picks the ``src/`` directory whose ``repro_torch`` is timed, so
two commits compare in one call (run them in turns: parent, change,
change, parent). Prints the card's name and power limit, then one JSON
line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTENTION = {"paper-rwsgd prefill": (4, 128, 8, 4, 32), "yi-6b float32 gate": (4, 512, 32, 4, 128)}
SSD = {"mamba2-1.3b prefill": (4, 2, 256, 64, 64, 128)}


def device_ms(fn, reps: int, groups: int = 7) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    times = []
    for _ in range(groups):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return sorted(times)[groups // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("f32_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import (
        flash_attention, flash_attention_plain, ssd_intra_chunk, ssd_intra_chunk_plain,
    )

    rng = np.random.default_rng(0)
    f32 = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32, device="cuda")  # noqa: E731
    rows = []
    for label, (B, S, H, KV, D) in ATTENTION.items():
        q, k, v = f32(B, S, H, D), f32(B, S, KV, D), f32(B, S, KV, D)
        err = float((flash_attention(q, k, v) - flash_attention_plain(q, k, v)).abs().max())
        rows.append(dict(kernel="flash_attention", case=label, shape=[B, S, H, KV, D],
                         device_ms=device_ms(lambda: flash_attention(q, k, v), args.reps),
                         max_abs_err=err))
    for label, (B, nc, Q, H, P, N) in SSD.items():
        x = f32(B, nc, Q, H, P)
        da = torch.cumsum(-torch.nn.functional.softplus(f32(B, nc, Q, H)) * torch.exp(f32(H)), dim=2)
        b, c = f32(B, nc, Q, N), f32(B, nc, Q, N)
        got, want = ssd_intra_chunk(x, da, b, c), ssd_intra_chunk_plain(x, da, b, c)
        rows.append(dict(kernel="ssd_intra_chunk", case=label, shape=[B, nc, Q, H, P, N],
                         device_ms=device_ms(lambda: ssd_intra_chunk(x, da, b, c), args.reps),
                         max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, want)),
                         bitwise=all(torch.equal(g, w) for g, w in zip(got, want))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    print(json.dumps(dict(src=args.src, device=torch.cuda.get_device_name(0), rows=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
