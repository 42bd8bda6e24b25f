"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each ``.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. No
PyTorch header is included, so a build takes seconds. Libraries go
into ``build/kernels/`` at the repository root, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one is
reused. The first use of any kernel starts one ``nvcc`` per source, all
at once, and waits for them together.

Flags keep float arithmetic IEEE-exact: no ``--use_fast_math``,
``-prec-div=true`` and ``-fmad=false``, since theta is held bitwise to
the reference's node-sum formula. The attention and SSD kernels, which
are held to a tolerance, ask for their fused multiply-adds explicitly
(``__fmaf_rn``) or run them on the tensor cores, so the same flags serve
every source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-prec-div=true", "-prec-sqrt=true",
    "-fmad=false", "-ftz=false", "-Xptxas", "-v",
)
SOURCES = (
    "theta_sums", "round_update", "whole_round", "flash_attention", "flash_attention_sm90",
    "ssd_intra_chunk", "ssd_intra_chunk_sm90",
)

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, in parallel;
    returns each compiled source's seconds, from the common start to its
    compiler's exit (empty when every library was cached). The
    compiler's register and shared-memory report is kept beside each
    library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(out.with_suffix(".log"), "w") as log:
            procs[name] = (out, tmp, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
    errors, seconds = [], {}
    while procs:
        for name, (out, tmp, proc) in list(procs.items()):
            if proc.poll() is None:
                continue
            del procs[name]
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{out.with_suffix('.log').read_text()}")
            else:
                os.replace(tmp, out)  # atomic: concurrent builds agree
        time.sleep(0.05)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build_all()
            lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


def check(status: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
