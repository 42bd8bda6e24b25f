"""Run the node-sharded protocol step over several processes.

    python -m repro_torch.launch.sharded --world 2 --device cpu
    python -m repro_torch.launch.sharded --world 1 --device cuda --n 4096

spawns ``--world`` ranks (``torch.multiprocessing``, the spawn method),
each a member of one process group over a ``FileStore`` (gloo on the
CPU; on CUDA nccl when every rank has a card of its own, else gloo on
CUDA tensors), lays them out as a mesh, gives each rank its shard of a
regular graph's (degree 8) node tables, runs ``--rounds`` rounds of
:func:`repro_torch.core.distributed.make_sharded_step` and gathers the
final state back. It prints Z's range and the ms per round.
:func:`spawn_run` is the same run as a function.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.distributed import (
    ShardedGraph,
    ShardedProtocolState,
    gather_state,
    make_sharded_step,
    run_sharded,
    shard_state,
)
from repro_torch.launch.mesh import make_mesh

__all__ = ["spawn_run"]


def _default_backend(device: str, world: int) -> str:
    """nccl when each rank has a card of its own, else gloo (nccl
    refuses two ranks on one device)."""
    if device == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(rank, world, workdir, backend, device, mesh_shape, mesh_axes, node_axes,
               state, graph, pcfg, rounds, partitionable):
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else device
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    # nccl binds its communicator to the rank's card
    bound = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, **bound)
    try:
        mesh = make_mesh(mesh_shape, mesh_axes, device)
        n = state.last_seen.shape[0]
        step = make_sharded_step(mesh, node_axes, n, pcfg, partitionable=partitionable)
        st, gr = shard_state(state, graph, mesh, node_axes, dev)
        if device == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        st, z = run_sharded(step, st, gr, rounds)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        full = gather_state(st, mesh, node_axes)
        if rank == 0:
            out = {f: x.cpu() for f, x in full._asdict().items()}
            out.update(z=z.cpu(), seconds=torch.tensor(seconds, dtype=torch.float64))
            torch.save(out, os.path.join(workdir, "result.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_run(state: ShardedProtocolState, graph: ShardedGraph, pcfg, rounds: int, *,
              world: int, mesh_shape=None, mesh_axes=("data",), node_axes=("data",),
              device: str = "cuda", backend: str | None = None,
              partitionable: bool = True):
    """``rounds`` rounds of the sharded step over ``world`` spawned ranks
    from the whole graph's ``state`` and ``graph`` (CPU tensors); mesh
    ``mesh_shape`` (default ``(world,)``) named ``mesh_axes``, nodes
    sharded over ``node_axes``. Returns a dict: the gathered final
    ``state`` and ``z`` per round (CPU tensors), and ``seconds``, rank
    0's host time over the rounds (ending in a synchronize on CUDA).
    ``backend`` defaults to nccl when every rank has a card of its own,
    else gloo."""
    mesh_shape = (world,) if mesh_shape is None else tuple(mesh_shape)
    backend = backend or _default_backend(device, world)
    with tempfile.TemporaryDirectory() as wd:
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(world, wd, backend, device, mesh_shape, tuple(mesh_axes),
                       tuple(node_axes), state, graph, pcfg, rounds, partitionable))
        out = torch.load(os.path.join(wd, "result.pt"))
    return dict(state=ShardedProtocolState(*(out[f] for f in ShardedProtocolState._fields)),
                z=out["z"], seconds=float(out["seconds"]))


def main(argv=None) -> int:
    from repro_torch.core.distributed import init_sharded_state
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.graphs import make_graph
    from repro_torch.utils import prng

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=300)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu)")
    g = make_graph("regular", args.n, seed=0, degree=8)
    pcfg = ProtocolConfig(algorithm="decafork+", z0=16, max_walks=64, eps=4.0, eps2=11.0,
                          rt_bins=512)
    state = init_sharded_state(args.n, pcfg, prng.key(0))
    graph = ShardedGraph(torch.as_tensor(g.neighbors), torch.as_tensor(g.degrees),
                         torch.ones(args.n, dtype=torch.bool),
                         torch.ones(g.neighbors.shape, dtype=torch.bool))
    res = spawn_run(state, graph, pcfg, args.rounds, world=args.world, device=args.device)
    z = res["z"]
    print(f"world={args.world} device={args.device} n={args.n} rounds={args.rounds} "
          f"z_min={int(z.min())} z_max={int(z.max())} z_final={int(z[-1])} "
          f"ms_per_round={res['seconds'] * 1e3 / args.rounds:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
