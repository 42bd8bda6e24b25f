#!/usr/bin/env python3
"""Where a float32 flash_attention launch spends its time, CTA by CTA, on
one CUDA card.

    python3 tools/flash_phases.py [--shape B,S,H,KV,D ...]

Builds an instrumented copy of ``src/repro_torch/csrc/flash_attention.cu``
with ``nvcc`` (the port's flags) into ``build/kernels/``: thread 0 of
every CTA reads the global timer at its start, once the first copies are
in (``copies``: Q and the first K/V tiles), when its key loop ends
(``loop``), and at its end (``tail``: the key groups' merge and the
stores); inside its last key tile it also stamps the end of the scores
(``scores``) and of the softmax (``softmax``; ``p_v`` runs from there to
the end of the loop). The kernel is launched three times on the same
random inputs and the last launch's stamps are read. For each shape it
prints one JSON line: the span from the first CTA's start to the last
CTA's end and, for each phase, the median and the largest over the
CTAs, in ns. The instrumented kernel computes the same outputs;
``max_abs_err`` holds it to the plain version. Default shapes: the
served ones (paper-rwsgd's prefill and yi-6b's float32 gate).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("4,128,8,4,32", "4,512,32,4,128")
# (anchor in the source, text put after it, or before it when the flag is set)
PROBES = (
    ("namespace {\n",
     "__device__ unsigned long long g_stamp[1 << 16][7];\n"
     "__device__ __forceinline__ unsigned long long now() {\n"
     "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n",
     False),
    ("  extern __shared__ float4 smem4[];\n",
     "  unsigned long long st[7] = {now(), 0, 0, 0, 0, 0, 0};\n", False),
    ("  __syncthreads();  // Q and each group's first tile are in\n", "  st[1] = now();\n", False),
    ("    const float* K = sk + buf * BK * QP;\n", "    st[4] = now();\n", False),
    ("    // online softmax, each row over its eight threads\n", "    st[5] = now();\n", True),
    ("    __syncwarp();  // a row's probabilities", "    st[6] = now();\n", True),
    ("  if (C::NS > 1) {  // group g finishes", "  st[2] = now();\n", True),
)
END = "}\n\nstruct Shape {"
DUMP = ("  if (threadIdx.x == 0) {\n    st[3] = now();\n"
        "    for (int i = 0; i < 7; ++i) g_stamp[blockIdx.y * gridDim.x + blockIdx.x][i] = st[i];\n  }\n")


def instrumented_source(text: str) -> str:
    for anchor, probe, before in PROBES:
        if text.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in flash_attention.cu: {anchor!r}")
        text = text.replace(anchor, probe + anchor if before else anchor + probe)
    if text.count(END) != 1:
        raise RuntimeError("end of flash_kernel not found")
    text = text.replace(END, DUMP + END)
    return text + ('\nextern "C" int stamps(unsigned long long* h, int n) {\n'
                   "  return (int)cudaMemcpyFromSymbol(h, g_stamp, n * 7 * 8);\n}\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", nargs="*", default=list(SHAPES), help="B,S,H,KV,D (float32, causal)")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("flash_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_plain

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "flash_phases.cu"
    lib_path = _build.BUILD_DIR / "libflash_phases.so"
    src.write_text(instrumented_source((_build.CSRC / "flash_attention.cu").read_text()))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True,
                   capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = 1 << 16
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in args.shape:
        B, S, H, KV, D = (int(v) for v in shape.split(","))
        q = torch.randn(B, S, H, D, device="cuda", generator=gen)
        k, v = (torch.randn(B, S, KV, D, device="cuda", generator=gen) for _ in range(2))
        o = torch.empty_like(q)
        for _ in range(3):
            status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, KV, D, 0, 0,
                        1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
            if status:
                raise RuntimeError(f"flash_attention_launch: CUDA error {status}")
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (7 * n))()
        if lib.stamps(buf, n):
            raise RuntimeError("could not read the stamps")
        st = np.frombuffer(buf, dtype=np.uint64).reshape(n, 7).astype(np.int64)
        st = st[st[:, 0] > 0]
        phases = {"copies": st[:, 1] - st[:, 0], "loop": st[:, 2] - st[:, 1], "tail": st[:, 3] - st[:, 2],
                  "scores": st[:, 5] - st[:, 4], "softmax": st[:, 6] - st[:, 5], "p_v": st[:, 2] - st[:, 6]}
        print(json.dumps(dict(
            shape=dict(B=B, S=S, H=H, KV=KV, D=D), ctas=len(st), span_ns=int(st[:, 3].max() - st[:, 0].min()),
            **{f"{k}_ns": dict(median=float(np.median(x)), max=int(x.max())) for k, x in phases.items()},
            max_abs_err=float((o - flash_attention_plain(q, k, v)).abs().max()),
            device=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
