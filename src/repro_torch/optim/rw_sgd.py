"""Random-walk SGD, the paper's learning algorithm (the port of
``repro.optim.rw_sgd``).

Each live walk carries a model replica; the node it visits takes a local
mini-batch step on its own data shard and forwards the replica. Replicas
live in a fixed-capacity stack with the port's trajectory axis ahead of
the walk-slot axis, leaves (batch, W, ...): forking a walk is a
slot-to-slot copy of (params, optimizer state, step counter), DecAFork's
"identical duplicate", and a terminated walk's slot is simply not
trained again until a fork overwrites it.

``replica_train_step`` advances every slot of every trajectory in one
batched step (the reference vmaps the per-walk step): one loss over the
whole stack, one backward, one optimizer update, and inactive slots pass
through unchanged. :class:`RwSgdPayload` packages it as a
``core.payload.Payload``, so learning runs inside the simulator's round
loop (one captured CUDA graph per round on the card) and batches under
``Experiment.ensemble`` / ``.sweep``.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.payload import Payload
from repro_torch.data.synthetic import SyntheticTask, sample_batch
from repro_torch.models.transformer import check_replica_trainable
from repro_torch.utils.tree import tree_leaves, tree_map, tree_replace


class ReplicaSet(NamedTuple):
    params: Any  # dict tree, leaves (batch, W, ...)
    opt_state: Any  # OptState: step (batch, W), moments like params
    steps: torch.Tensor  # (batch, W) int32 local step counters


def init_replicas(init_fn: Callable, opt_init: Callable, keys: torch.Tensor,
                  max_walks: int) -> ReplicaSet:
    """Every slot of row b starts from ``init_fn(keys[b])`` (footnote 4:
    one node creates the Z_0 walks, which share the initial model);
    ``opt_init(params, step_shape)`` makes the optimizer state."""
    batch = keys.shape[0]
    rows = [init_fn(keys[b]) for b in range(batch)]

    def stack(*xs):
        x = torch.stack(xs)[:, None]
        return x.expand((batch, max_walks) + x.shape[2:]).contiguous()

    params = tree_map(stack, rows[0], *rows[1:])
    del rows
    return ReplicaSet(
        params=params,
        opt_state=opt_init(params, (batch, max_walks)),
        steps=torch.zeros((batch, max_walks), dtype=torch.int32, device=keys.device),
    )


def copy_slots(rs, srcmap: torch.Tensor):
    """Every leaf of ``rs`` with slot s of row b taken from slot
    ``srcmap[b, s]`` of the same row. All reads see the state before the
    copy (a gather, then the result), so a slot that is overwritten and
    read in one call hands its old value on."""
    batch, W = srcmap.shape
    rows = torch.arange(batch, device=srcmap.device).view(-1, 1) * W
    flat = (srcmap.long() + rows).reshape(-1)

    def gather(x):
        return x.reshape((batch * W,) + x.shape[2:]).index_select(0, flat).reshape(x.shape)

    return tree_map(gather, rs)


def fork_replica(rs: ReplicaSet, src, dst, do) -> ReplicaSet:
    """Copy slot ``src`` -> ``dst`` of each row where ``do`` holds
    (events with a trailing axis E, or (E,) for every row alike). An
    event whose destination lies outside [0, W) or whose ``do`` is false
    is dropped; all copies read the pre-copy state."""
    batch, W = rs.steps.shape
    dev = rs.steps.device
    src, dst, do = torch.broadcast_tensors(
        *(torch.atleast_1d(torch.as_tensor(a, device=dev)) for a in (src, dst, do)))
    if src.dim() == 1:
        src, dst, do = (a.expand(batch, -1) for a in (src, dst, do))
    ok = do & (dst >= 0) & (dst < W)
    srcmap = torch.arange(W + 1, device=dev).expand(batch, W + 1).clone()
    srcmap.scatter_(1, torch.where(ok, dst, W).long(), torch.where(ok, src, W).long())
    return copy_slots(rs, srcmap[:, :W])


def _grads(loss_of, params):
    """``(losses, grads)``: ``loss_of(params)`` (any shape) and the
    gradient of its sum with respect to every tensor of ``params``."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
        losses = loss_of(tree_replace(params, leaves))
        grads = torch.autograd.grad(losses.sum(), leaves)
    return losses.detach(), tree_replace(params, grads)


def local_sgd_step(loss_fn: Callable, optimizer, params, opt_state, batch):
    """One node-local update of one model: ``loss_fn(params, batch) ->
    (loss, metrics)``, its gradient, and the optimizer's step."""
    box = {}

    def loss_of(p):
        loss, box["metrics"] = loss_fn(p, batch)
        return loss

    loss, grads = _grads(loss_of, params)
    new_params, new_opt = optimizer.update(grads, opt_state, params)
    return new_params, new_opt, loss, box["metrics"]


def replica_train_step(loss_fn: Callable, optimizer):
    """The per-walk local step over every slot of a replica stack.

    ``loss_fn(params, batch) -> (R,)`` is the loss of each of a stack of
    R replicas (leaves (R, ...)), as ``Model.replica_losses`` computes it;
    the reference vmaps one model's loss instead. Returns ``f(rs,
    batches, active) -> (new rs, (batch, W) losses)``: every slot steps,
    and inactive slots pass through unchanged with a loss of 0. The
    gradient is that of the sum of the slots' losses, so each slot's
    gradient is its own loss's."""

    def step(rs: ReplicaSet, batches, active):
        batch, W = rs.steps.shape
        flat = lambda x: x.reshape((batch * W,) + x.shape[2:])
        flat_batches = tree_map(flat, batches)
        losses, grads = _grads(
            lambda p: loss_fn(tree_map(flat, p), flat_batches).reshape(batch, W), rs.params)
        new_params, new_opt = optimizer.update(grads, rs.opt_state, rs.params)
        sel = lambda new, old: torch.where(active.reshape(active.shape + (1,) * (new.dim() - 2)),
                                           new, old)
        return (
            ReplicaSet(
                params=tree_map(sel, new_params, rs.params),
                opt_state=tree_map(sel, new_opt, rs.opt_state),
                steps=rs.steps + active.to(torch.int32),
            ),
            torch.where(active, losses, 0.0),
        )

    return step


class RwSgdOutputs(NamedTuple):
    """Per-round learning telemetry, stacked over the trajectory."""

    loss: torch.Tensor  # (batch, W) per-slot local loss (0 where no step ran)
    mean_loss: torch.Tensor  # (batch,) mean over the slots that trained this round
    trained: torch.Tensor  # (batch,) int32: slots that took a local step


class RwSgdPayload(Payload):
    """The paper's workload as a payload: per-walk model replicas and
    optimizer state, advanced by batched local steps.

    carry = :class:`ReplicaSet`. Per round:

      * ``on_fork`` copies the parent's (params, optimizer state, step
        counter) into each freshly allocated slot (``copy_slots``), the
        overwrite that also recycles a terminated walk's stale slot;
      * ``on_visit`` samples each slot's mini-batch from the data shard
        of the node it just hopped to (``data.synthetic.sample_batch``)
        and applies the local step to the live slots; ``train_every``
        > 1 trains only in rounds ``t % train_every == 0``, a mask
        computed on the device;
      * ``on_terminate`` is the default no-op.

    The model, optimizer, task and capacities are structure (the
    signature); the ReplicaSet is the state. Only the dense family
    trains, with ``use_pallas=False``, and on CUDA the products must run
    in float32 (no TF32), as the reference computes them.
    """

    def __init__(self, model, optimizer, task: SyntheticTask, max_walks: int,
                 local_batch: int = 2, seq_len: int = 32, train_every: int = 1):
        check_replica_trainable(model.cfg)
        self.model = model
        self.optimizer = optimizer
        self.task = task
        self.max_walks = int(max_walks)
        self.local_batch = int(local_batch)
        self.seq_len = int(seq_len)
        self.train_every = int(train_every)
        self._train = replica_train_step(model.replica_losses, optimizer)
        self._logits = {}  # device -> the task's logits there
        self._signature_cache = False  # computed lazily (a hash of the task)

    def signature(self):
        """(model config, optimizer signature, a sha256 of the task's
        logits, max_walks, local_batch, seq_len, train_every); None when
        the optimizer cannot be fingerprinted."""
        if self._signature_cache is not False:
            return self._signature_cache
        opt_sig = getattr(self.optimizer, "signature", None)
        if opt_sig is None:
            sig = None
        else:
            logits = self.task.logits.detach().to("cpu", torch.float32).numpy()
            digest = hashlib.sha256(np.ascontiguousarray(logits).tobytes()).hexdigest()
            sig = (self.model.cfg, opt_sig, ("task", digest), self.max_walks,
                   self.local_batch, self.seq_len, self.train_every)
        self._signature_cache = sig
        return sig

    def output_fields(self):
        return RwSgdOutputs._fields

    def validate(self, pcfg) -> None:
        if pcfg.max_walks != self.max_walks:
            raise ValueError(
                f"payload capacity max_walks={self.max_walks} does not match "
                f"ProtocolConfig.max_walks={pcfg.max_walks}"
            )

    def _task_logits(self, device) -> torch.Tensor:
        device = torch.device(device)
        logits = self._logits.get(device)
        if logits is None:
            logits = self._logits[device] = self.task.logits.to(device, torch.float32)
        return logits

    def init(self, keys: torch.Tensor, *, partitionable: bool = True) -> ReplicaSet:
        if keys.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "RwSgdPayload trains in float32 and TF32 matrix products are on "
                "(torch.backends.cuda.matmul.allow_tf32); turn them off"
            )
        self._task_logits(keys.device)  # on the device before any capture

        def init_fn(k):
            return self.model.params_tree(self.model.init(k, k.device,
                                                          partitionable=partitionable))

        return init_replicas(init_fn, self.optimizer.init, keys, self.max_walks)

    def on_fork(self, rs: ReplicaSet, fork_parent: torch.Tensor) -> ReplicaSet:
        slots = torch.arange(fork_parent.shape[-1], device=fork_parent.device)
        return copy_slots(rs, torch.where(fork_parent >= 0, fork_parent, slots))

    def on_visit(self, rs: ReplicaSet, walks, t, key, *, partitionable: bool = True):
        """Each trajectory row steps on its own: a row's float results
        then depend on that row alone (which lanes of a vector ``exp``
        see it on the CPU, a reduction's or a batched product's
        configuration on the GPU), so a sweep row is bitwise the ensemble
        of its scenario, as in the reference. The batches are drawn for
        every row at once (``sample_batch`` keeps its rows independent)."""
        task = SyntheticTask(self._task_logits(key.device), self.task.entropy)
        batches = sample_batch(task, key[:, None, :], self.local_batch, self.seq_len, walks.pos,
                               partitionable=partitionable)
        do = walks.active & (t % self.train_every == 0)[:, None]
        rows, losses, means = [], [], []
        for b in range(do.shape[0]):
            one = lambda x: x[b:b + 1]  # noqa: E731
            row, loss = self._train(tree_map(one, rs), tree_map(one, batches), one(do))
            rows.append(row)
            losses.append(loss)
            means.append(loss.sum(dim=1))
        rs = tree_map(lambda *xs: torch.cat(xs), *rows)
        n_trained = do.sum(dim=1, dtype=torch.int32)
        mean = torch.cat(means) / torch.clamp(n_trained, min=1)
        return rs, RwSgdOutputs(loss=torch.cat(losses), mean_loss=mean, trained=n_trained)
