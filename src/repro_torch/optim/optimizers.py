"""Functional optimizers: SGD (with momentum) and AdamW (the port of
``repro.optim.optimizers``).

Parameters, gradients and moments are dict trees of tensors that mirror
each other leaf for leaf. The step counter has the *slot shape*: ``()``
for one model, ``(batch, W)`` for a replica stack whose leaves are
``(batch, W, ...)``; every per-step quantity (the learning rate, Adam's
bias corrections) takes that shape and broadcasts over each leaf's
parameter axes, so one ``update`` advances every replica with its own
step count, as the reference's vmapped update does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_replace


class OptState(NamedTuple):
    step: torch.Tensor  # int32, the slot shape
    mu: object  # tree like params (or () for plain SGD)
    nu: object  # tree like params (or () for SGD)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable  # params -> OptState
    update: Callable  # (grads, state, params) -> (new_params, new_state)
    # stable hyperparameter tuple (name, lr token, ...), None when the
    # learning rate is a callable without a declared signature
    signature: Optional[tuple] = None


def _lr_token(lr):
    """A learning rate's stable token: the float, a schedule's declared
    ``.signature``, or None."""
    if callable(lr):
        return getattr(lr, "signature", None)
    return float(lr)


def constant_schedule(lr: float) -> Callable:
    def fn(step):
        return torch.full(step.shape, lr, dtype=torch.float32, device=step.device)

    fn.signature = ("const", float(lr))
    return fn


def cosine_schedule(lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    """Linear warm-up, then a cosine decay to ``min_ratio * lr`` (float32,
    the reference's order of operations)."""

    def fn(step):
        step = step.to(torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return lr * warm * (min_ratio + (1 - min_ratio) * cos)

    fn.signature = ("cosine", float(lr), int(warmup), int(total), float(min_ratio))
    return fn


def per_slot(x: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A slot-shaped tensor with trailing singleton axes, so that it
    broadcasts over ``leaf``'s parameter axes."""
    return x.reshape(x.shape + (1,) * (leaf.dim() - x.dim()))


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params, step_shape=()):
        mu = tree_map(torch.zeros_like, params) if momentum else ()
        dev = tree_leaves(params)[0].device
        return OptState(step=torch.zeros(step_shape, dtype=torch.int32, device=dev), mu=mu,
                        nu=())

    def update(grads, state, params):
        lr_t = sched(state.step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state.mu, grads)
            upd = mu
        else:
            mu = ()
            upd = grads
        new_params = tree_map(lambda p, u: p - (per_slot(lr_t, p) * u).to(p.dtype), params, upd)
        return new_params, OptState(step=state.step + 1, mu=mu, nu=())

    tok = _lr_token(lr)
    sig = None if tok is None else ("sgd", tok, float(momentum))
    return Optimizer(init=init, update=update, signature=sig)


def adamw(
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    moment_dtype=torch.float32,
) -> Optimizer:
    """AdamW with moments in ``moment_dtype`` (``torch.float32`` or
    ``torch.bfloat16``); the update itself runs in float32, in the
    reference's order: the bias corrections ``1 - b ** step`` in float32,
    ``m32`` and ``v32``, ``mhat / (sqrt(vhat) + eps)``, then the weight
    decay, then the cast back to each parameter's dtype."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params, step_shape=()):
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
        dev = tree_leaves(params)[0].device
        return OptState(
            step=torch.zeros(step_shape, dtype=torch.int32, device=dev),
            mu=tree_map(zeros, params),
            nu=tree_map(zeros, params),
        )

    def update(grads, state, params):
        step = state.step + 1
        lr_t = sched(state.step)
        stepf = step.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, stepf)
        c2 = 1.0 - torch.pow(b2, stepf)

        def upd_leaf(g, m, v, p):
            g = g.to(torch.float32)
            m32 = b1 * m.to(torch.float32) + (1 - b1) * g
            v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
            mhat = m32 / per_slot(c1, p)
            vhat = v32 / per_slot(c2, p)
            delta = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.to(torch.float32)
            new_p = (p.to(torch.float32) - per_slot(lr_t, p) * delta).to(p.dtype)
            return m32.to(moment_dtype), v32.to(moment_dtype), new_p

        out = [upd_leaf(*leaves) for leaves in zip(
            tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
            tree_leaves(params))]
        pick = lambda i: tree_replace(params, [o[i] for o in out])
        return pick(2), OptState(step=step, mu=pick(0), nu=pick(1))

    tok = _lr_token(lr)
    sig = None if tok is None else (
        "adamw", tok, float(b1), float(b2), float(eps), float(weight_decay),
        str(moment_dtype).replace("torch.", ""),
    )
    return Optimizer(init=init, update=update, signature=sig)
