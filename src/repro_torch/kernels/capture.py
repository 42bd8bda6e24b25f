"""Capture work that launches the port's kernels as one CUDA graph.

A replay runs the captured kernels without the wrappers' Python, so the
wrappers' ``launches`` counters (``repro_torch.kernels.KERNELS``) are
counted from the graph itself: at capture, libcuda lists the
graph's kernel nodes and names each node's device function; every
wrapper's nodes (its ``symbols``) are its launches per replay, and each
replay adds them. A call under capture launches nothing and counts
nothing (``_launch.count_launch``); the warm-up before the capture runs
real launches, and they count.

Failure is loud: a capture, a libcuda query or a replay that CUDA refuses
raises, and nothing here falls back to running the work eagerly.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import KERNELS

_KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL
# one capture at a time in a process: the blocks of a spread sweep run in
# threads of their own, and each captures its runner's round at its first
# run; their replays and eager work overlap freely
_CAPTURE_LOCK = threading.Lock()


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of ``cuda.h`` (CUDA 12)."""

    _fields_ = [
        ("func", ctypes.c_void_p),
        ("grid", ctypes.c_uint * 3),
        ("block", ctypes.c_uint * 3),
        ("shared_mem_bytes", ctypes.c_uint),
        ("kernel_params", ctypes.c_void_p),
        ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p),
        ("ctx", ctypes.c_void_p),
    ]


_libcuda = None


def _cuda():
    """libcuda (loaded by torch already) with the
    signatures used here."""
    global _libcuda
    if _libcuda is None:
        cu = ctypes.CDLL("libcuda.so.1")
        vp, ptr = ctypes.c_void_p, ctypes.POINTER
        sigs = {
            "cuGraphGetNodes": [vp, vp, ptr(ctypes.c_size_t)],
            "cuGraphNodeGetType": [vp, ptr(ctypes.c_int)],
            "cuGraphKernelNodeGetParams_v2": [vp, ptr(_KernelNodeParams)],
            "cuFuncGetName": [ptr(ctypes.c_char_p), vp],
            "cuKernelGetName": [ptr(ctypes.c_char_p), vp],
        }
        for name, args in sigs.items():
            fn = getattr(cu, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        _libcuda = cu
    return _libcuda


def _check(status: int, call: str) -> None:
    if status != 0:
        raise RuntimeError(f"{call} failed (CUresult {status})")


def kernel_node_names(raw_graph: int) -> list:
    """The device function name (as compiled, e.g. mangled) of every
    kernel node of a CUDA graph (a ``cudaGraph_t``), read from
    libcuda."""
    cu = _cuda()
    graph = ctypes.c_void_p(raw_graph)
    count = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(graph, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        _check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            continue
        params = _KernelNodeParams()
        _check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
               "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.func:
            _check(cu.cuFuncGetName(ctypes.byref(name), params.func), "cuFuncGetName")
        else:
            _check(cu.cuKernelGetName(ctypes.byref(name), params.kern), "cuKernelGetName")
        names.append(name.value.decode())
    return names


def runs_symbol(name: str, symbol: str) -> bool:
    """Whether device function ``name`` (as compiled: C++ names are
    mangled, ``_Z18whole_round_kernel5Round``) is ``symbol``."""
    return name == symbol or f"{len(symbol)}{symbol}" in name


def launches_per_replay(names) -> dict:
    """Kernel wrapper -> its kernel's nodes among ``names``, for every
    wrapper that has one."""
    out = {}
    for k in KERNELS:
        n = sum(any(runs_symbol(name, s) for s in k.symbols) for name in names)
        if n:
            out[k] = n
    return out


class Captured:
    """``fn`` captured once on the current CUDA device.

    ``warmup`` runs first, eagerly, on the stream the capture then uses
    (libraries initialise and kernels load outside the capture); it must
    leave the buffers ``fn`` reads as they were, e.g. by working on
    clones. ``kernel_nodes`` is the graph's kernel count and
    ``per_replay`` each wrapper's launches in one replay, both read from
    the captured graph.

    The capture runs in CUDA's ``thread_local`` mode: only the capturing
    thread is barred from calls that are unsafe during a capture, so
    another thread's CUDA work (a caller of ``api.service``, whose worker
    thread captures) neither breaks the capture nor fails itself. The
    default ``global`` mode would fail any such call from any thread
    ("operation not permitted when stream is capturing"). Captures in a
    process take turns (a lock): the blocks of a spread sweep capture in
    threads of their own."""

    def __init__(self, fn, warmup):
        with _CAPTURE_LOCK:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                warmup()
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                fn()
            torch.cuda.current_stream().wait_stream(stream)
        names = kernel_node_names(self.graph.raw_cuda_graph())
        self.kernel_nodes = len(names)
        self.per_replay = launches_per_replay(names)
        self.graph.instantiate()

    def replay(self, times: int = 1) -> None:
        for _ in range(times):
            self.graph.replay()
        for k, n in self.per_replay.items():
            k.launches += n * times
