"""Training entry point: the train step with microbatch accumulation (the
port of ``repro.launch.train``).

``make_train_step`` builds the step over a ``Model.params_tree``; the
``__main__`` entry point runs a small real training loop on the card (or on
the CPU with ``--device cpu``):

    python -m repro_torch.launch.train --arch hymba-1.5b --steps 20
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.models.model import Model
from repro_torch.optim import OptState, adamw, cosine_schedule
from repro_torch.utils.tree import tree_leaves, tree_replace

# elements of one piece of a donated update (make_train_step(donate=True)):
# its float32 temporaries stay at a few hundred MB whatever the leaf's size
DONATE_CHUNK = 1 << 26


def make_train_step(model: Model, optimizer, microbatches: int = 1, *, donate: bool = False):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is a ``Model.params_tree`` dict, ``opt_state`` the
    optimizer's state for it and ``batch`` a dict of tensors with a
    leading batch axis. With microbatches > 1 the batch is split on that
    axis and the gradients of the microbatches are summed into float32
    zeros and divided by their count, as in the reference: the optimizer
    then sees float32 gradients, where at microbatches=1 it sees the
    parameters' dtype. ``metrics`` are the last microbatch's, with
    ``loss`` the mean over the microbatches.

    ``donate=True`` is the counterpart of donating the parameters and the
    optimizer state to the jitted step (the reference's dry run passes
    ``donate_argnums=(0, 1)``): the update is written into the given
    parameter, moment and step tensors, a leaf at a time in pieces of at
    most ``DONATE_CHUNK`` elements, so the device holds one copy of them
    plus one piece's temporaries, where a functional update holds two;
    the step returns the given trees. The optimizer must update each
    element on its own (the port's ``sgd`` and ``adamw`` do), so the
    result is bitwise the functional update's. A donated step keeps its
    state at fixed addresses and issues no host synchronisation, so it
    can be captured as a CUDA graph.
    """

    def grads_of(params, batch):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
        loss, metrics = model.loss(tree_replace(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            def split(leaf):
                b = leaf.shape[0]
                if b % microbatches:
                    raise ValueError(f"a batch of {b} does not split into {microbatches} "
                                     "microbatches")
                return leaf.reshape(microbatches, b // microbatches, *leaf.shape[1:])

            mb = {k: split(v) for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
            for i in range(microbatches):
                loss_i, metrics, g = grads_of(params, {k: v[i] for k, v in mb.items()})
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                loss = loss + loss_i
                del g
            loss = loss / microbatches
            for g in grads:
                g.div_(microbatches)
        grads = tree_replace(params, grads)
        if donate:
            new_params, new_opt = _update_in_place(optimizer, grads, opt_state, params)
        else:
            new_params, new_opt = optimizer.update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return step


def _update_in_place(optimizer, grads, state: OptState, params):
    """``optimizer.update`` written into ``params`` and ``state``'s
    moments and step counter, one piece of one leaf at a time; returns
    (params, state)."""
    moments = [tree_leaves(m) for m in (state.mu, state.nu)]
    step = state.step
    for j, (p, g) in enumerate(zip(tree_leaves(params), tree_leaves(grads))):
        p_flat, g_flat = p.view(-1), g.reshape(-1)
        m_flat = [m[j].view(-1) if m else None for m in moments]
        for lo in range(0, p.numel(), DONATE_CHUNK):
            sl = slice(lo, lo + DONATE_CHUNK)
            piece = [{"x": m[sl]} if m is not None else () for m in m_flat]
            new_p, new_s = optimizer.update({"x": g_flat[sl]},
                                            OptState(state.step, piece[0], piece[1]),
                                            {"x": p_flat[sl]})
            p_flat[sl].copy_(new_p["x"])
            for m, new_m in zip(m_flat, (new_s.mu, new_s.nu)):
                if m is not None:
                    m[sl].copy_(new_m["x"])
            step = new_s.step
    state.step.copy_(step)  # after every piece has read the old count
    return params, state


def main():
    ap = argparse.ArgumentParser(description="local training loop")
    ap.add_argument("--arch", default="paper_rwsgd")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="cuda unless given (e.g. cpu)")
    args = ap.parse_args()

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import make_markov_task, sample_batch
    from repro_torch.utils import prng
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    model = Model(cfg)
    opt = adamw(cosine_schedule(args.lr, warmup=10, total=args.steps))
    key = prng.key(0, device=dev)
    params = Model.params_tree(model.init(key, dev))
    opt_state = opt.init(params)
    step = make_train_step(model, opt)

    task = make_markov_task(cfg.vocab_size, device=dev)
    print(f"arch={cfg.name} params={sum(x.numel() for x in tree_leaves(params)):,} "
          f"entropy_floor={task.entropy:.3f}")
    t0 = time.time()
    for i in range(args.steps):
        batch = sample_batch(task, prng.fold_in(key, i), args.batch, args.seq)
        params, opt_state, metrics = step(params, opt_state, batch)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(metrics['loss']):.4f} "
                  f"({time.time()-t0:.1f}s)")


if __name__ == "__main__":
    main()
