"""Capture work that launches the port's kernels as one CUDA graph.

A replay runs the captured kernels without the wrappers' Python, so the
wrappers' ``launches`` counters (``repro_torch.kernels.KERNELS``) are
counted from the graph itself: at capture, libcuda lists the
graph's kernel nodes and names each node's device function; every
wrapper's nodes (its ``symbols``) are its launches per replay, and each
replay adds them. A call under capture launches nothing and counts
nothing (``_launch.count_launch``); the warm-up before the capture runs
real launches, and they count.

The same walk of the graph gives every node the stage it was captured in
(``utils/trace.py``): each stage boundary inside the captured work asks
libcuda for the capture stream's last node (``cuStreamGetCaptureInfo``),
and the graph's edges say which nodes came before it.

Failure is loud: a capture, a libcuda query or a replay that CUDA refuses
raises, and nothing here falls back to running the work eagerly.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import KERNELS
from repro_torch.utils import trace

# CUgraphNodeType values of the nodes that run device work
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}
_CAPTURE_ACTIVE = 1  # CU_STREAM_CAPTURE_STATUS_ACTIVE
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
        vp, ptr, size = ctypes.c_void_p, ctypes.POINTER, ctypes.c_size_t
        sigs = {
            "cuGraphGetNodes": [vp, vp, ptr(size)],
            "cuGraphGetEdges": [vp, vp, vp, ptr(size)],
            "cuGraphNodeGetType": [vp, ptr(ctypes.c_int)],
            "cuGraphKernelNodeGetParams_v2": [vp, ptr(_KernelNodeParams)],
            "cuFuncGetName": [ptr(ctypes.c_char_p), vp],
            "cuKernelGetName": [ptr(ctypes.c_char_p), vp],
            "cuStreamGetCaptureInfo_v2": [vp, ptr(ctypes.c_int), ptr(ctypes.c_uint64), ptr(vp),
                                          ptr(ptr(vp)), ptr(size)],
        }
        for name, args in sigs.items():
            fn = getattr(cu, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        _libcuda = cu
    return _libcuda


def _check(status: int, call: str) -> None:
    if status != 0:
        raise RuntimeError(f"{call} failed (CUresult {status})")


def capture_frontier(stream) -> tuple:
    """The nodes the next work captured on ``stream`` would depend on: the
    last captured (libcuda's ``cuStreamGetCaptureInfo``)."""
    cu = _cuda()
    status, cid, graph = ctypes.c_int(-1), ctypes.c_uint64(0), ctypes.c_void_p()
    deps, n = ctypes.POINTER(ctypes.c_void_p)(), ctypes.c_size_t(0)
    _check(cu.cuStreamGetCaptureInfo_v2(ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status),
                                        ctypes.byref(cid), ctypes.byref(graph), ctypes.byref(deps),
                                        ctypes.byref(n)), "cuStreamGetCaptureInfo")
    if status.value != _CAPTURE_ACTIVE:
        raise RuntimeError("the stream is not capturing")
    return tuple(deps[i] for i in range(n.value))


def _kernel_name(cu, node) -> str:
    params = _KernelNodeParams()
    _check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
           "cuGraphKernelNodeGetParams")
    name = ctypes.c_char_p()
    if params.func:
        _check(cu.cuFuncGetName(ctypes.byref(name), params.func), "cuFuncGetName")
    else:
        _check(cu.cuKernelGetName(ctypes.byref(name), params.kern), "cuKernelGetName")
    return name.value.decode()


def graph_nodes(raw_graph: int):
    """Every node of a CUDA graph (a ``cudaGraph_t``), read from libcuda
    in one walk: ``(order, kinds, names, preds, chain)`` with ``order``
    the nodes in the graph's order (a chain's from its root), ``kinds``
    each node's kind (``'kernel'``, ``'memcpy'``, ``'memset'`` or
    ``'other'``), ``names`` each kernel node's device function (as
    compiled, e.g. mangled), ``preds`` each node's dependencies, and
    ``chain`` whether the nodes form one chain."""
    cu = _cuda()
    graph = ctypes.c_void_p(raw_graph)
    count = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(graph, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    n_edges = ctypes.c_size_t(0)
    _check(cu.cuGraphGetEdges(graph, None, None, ctypes.byref(n_edges)), "cuGraphGetEdges")
    src, dst = (ctypes.c_void_p * n_edges.value)(), (ctypes.c_void_p * n_edges.value)()
    _check(cu.cuGraphGetEdges(graph, src, dst, ctypes.byref(n_edges)), "cuGraphGetEdges")
    listed = list(nodes)
    preds = {n: [] for n in listed}
    succs = {n: [] for n in listed}
    for a, b in zip(src, dst):
        preds[b].append(a)
        succs[a].append(b)
    kinds, names = {}, {}
    for node in listed:
        kind = ctypes.c_int(-1)
        _check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        kinds[node] = _NODE_KINDS.get(kind.value, "other")
        if kinds[node] == "kernel":
            names[node] = _kernel_name(cu, node)
    roots = [n for n in listed if not preds[n]]
    order = []
    if len(roots) == 1 and all(len(succs[n]) <= 1 for n in listed):
        node = roots[0]
        while node is not None:
            order.append(node)
            node = succs[node][0] if succs[node] else None
    chain = len(order) == len(listed)
    return (order if chain else listed), kinds, names, preds, chain


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


def port_symbol(name: str) -> str | None:
    """The port kernel symbol device function ``name`` runs, if any."""
    return next((sym for k in KERNELS for sym in k.symbols if runs_symbol(name, sym)), None)


class Captured:
    """``fn`` captured once on the current CUDA device.

    ``warmup`` runs first, eagerly, on the stream the capture then uses
    (libraries initialise and kernels load outside the capture); it must
    leave the buffers ``fn`` reads as they were, e.g. by working on
    clones. ``kernel_nodes`` is the graph's kernel count and
    ``per_replay`` each wrapper's launches in one replay, both read from
    the captured graph. ``nodes`` lists every node (``trace.Node``: its
    stage path under ``root``, kind, device function and port kernel) in
    the graph's order, ``chain`` says whether that order is a chain,
    ``stages`` holds each stage path's own nodes, kernel nodes and counts
    (``trace.stage_table``) and ``counts`` one replay's counts; work
    captured outside any ``trace.stage`` is the root's.

    The capture runs in CUDA's ``thread_local`` mode: only the capturing
    thread is barred from calls that are unsafe during a capture, so
    another thread's CUDA work (a caller of ``api.service``, whose worker
    thread captures) neither breaks the capture nor fails itself. The
    default ``global`` mode would fail any such call from any thread
    ("operation not permitted when stream is capturing"). Captures in a
    process take turns (a lock): the blocks of a spread sweep capture in
    threads of their own."""

    def __init__(self, fn, warmup, root: str = "graph"):
        self.root = root
        with _CAPTURE_LOCK:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with trace.span("warmup"), torch.cuda.stream(stream):
                warmup()
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            recorder = trace.StageRecorder(root, lambda: capture_frontier(stream))
            with trace.span("stream_capture"):
                with torch.cuda.graph(self.graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    with trace.recording(recorder):
                        fn()
                        recorder.finish()
            torch.cuda.current_stream().wait_stream(stream)
        with trace.span("node_scan"):
            order, kinds, names, preds, self.chain = graph_nodes(self.graph.raw_cuda_graph())
            paths = trace.assign_stages(preds, order, recorder.marks, root)
            self.nodes = [trace.Node(paths[n], kinds[n], names.get(n),
                                     port_symbol(names[n]) if n in names else None)
                          for n in order]
            kernels = [nd.name for nd in self.nodes if nd.kind == "kernel"]
            self.kernel_nodes = len(kernels)
            self.per_replay = launches_per_replay(kernels)
            self.stages = trace.stage_table(self.nodes, recorder.counts)
            self.counts = {}
            for c in recorder.counts.values():
                for k, v in c.items():
                    self.counts[k] = self.counts.get(k, 0) + v
        with trace.span("instantiate"):
            self.graph.instantiate()

    def replay(self, times: int = 1) -> None:
        """Launch the graph ``times`` times; while a ``trace.Tracer`` is
        active, between CUDA events that it keeps, adding its counts."""
        tracer = trace.active()
        if tracer is None:
            for _ in range(times):
                self.graph.replay()
        else:
            start = tracer.device_mark()
            for _ in range(times):
                self.graph.replay()
            tracer.replayed(self, start, times)
        for k, n in self.per_replay.items():
            k.launches += n * times
