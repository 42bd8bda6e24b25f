"""Attack registry, the zoo's adversary axis (counterpart of the JAX
package's ``zoo/attacks.py``).

Every attack is a named builder returning an ordinary
:class:`~repro_torch.core.failures.FailureConfig`, so attacks compose
with sweeps exactly like the paper's failure regimes: numeric knobs are
per-row values, shape-bearing schedules pad via ``pad_bursts``, and the
one structural field (``pacman_mobile``) keys the sweep group. Attacks
and the literature motivating them:

  * ``pacman``        — the classic single static absorbing node
    (arXiv:2508.05663);
  * ``multi_pacman``  — several simultaneous absorbing nodes (Chen et
    al.'s multi-adversary regime): ids beyond the first ride the
    shape-bearing ``pacman_nodes`` array;
  * ``mobile_pacman`` — the absorbing node hops to a random available
    neighbor w.p. ``hop_prob`` each round (positions are carried
    state, see ``failures.step_mobile_pacman``);
  * ``edge_cut``      — a scheduled partition: at ``time`` every edge
    crossing the node-id ``threshold`` goes down at once, splitting the
    graph (the correlated-failure regime the jump defense targets);
  * ``burst`` / ``probabilistic`` / ``byzantine`` — the paper's walk-level
    threat models, wrapped so the cross-product helper can name them.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core.failures import FailureConfig

__all__ = ["ATTACKS", "attack", "register_attack"]

ATTACKS: Dict[str, Callable[..., FailureConfig]] = {}


def register_attack(name: str, builder: Callable | None = None):
    """Register an attack builder under ``name``; usable as a decorator.
    Last registration wins (notebook-iteration friendly)."""

    def _register(fn: Callable):
        if not callable(fn):
            raise TypeError(f"attack builder for {name!r} must be callable")
        ATTACKS[str(name)] = fn
        return fn

    return _register(builder) if builder is not None else _register


def attack(name: str, **kwargs) -> FailureConfig:
    """Build the named attack's :class:`FailureConfig`."""
    try:
        builder = ATTACKS[name]
    except KeyError:
        raise KeyError(
            f"unknown attack {name!r}; known: {sorted(ATTACKS)}"
        ) from None
    return builder(**kwargs)


@register_attack("none")
def _none(**kw) -> FailureConfig:
    """The calm regime (any FailureConfig fields pass through)."""
    return FailureConfig(**kw)


@register_attack("pacman")
def _pacman(node: int = 0, start: int = 0, **kw) -> FailureConfig:
    return FailureConfig(
        pacman_node=node, pacman_start_time=start, **kw
    )


@register_attack("multi_pacman")
def _multi_pacman(nodes=(0, 1), start: int = 0, **kw) -> FailureConfig:
    """Several static absorbing nodes at once (``nodes``: their ids)."""
    nodes = tuple(int(x) for x in nodes)
    if not nodes:
        raise ValueError("multi_pacman needs at least one node id")
    return FailureConfig(
        pacman_node=nodes[0],
        pacman_nodes=nodes[1:],
        pacman_start_time=start,
        **kw,
    )


@register_attack("mobile_pacman")
def _mobile_pacman(
    node: int = 0, hop_prob: float = 1.0, start: int = 0, nodes=(), **kw
) -> FailureConfig:
    """An absorbing node that hops each round (``nodes``: extra mobile
    Pac-Men beyond the first)."""
    return FailureConfig(
        pacman_node=node,
        pacman_nodes=tuple(int(x) for x in nodes),
        pacman_mobile=True,
        pacman_hop_prob=hop_prob,
        pacman_start_time=start,
        **kw,
    )


@register_attack("edge_cut")
def _edge_cut(time: int = 0, threshold: int = 1, **kw) -> FailureConfig:
    """One scheduled partition cut at ``time`` along id ``threshold``."""
    return FailureConfig(
        edge_cut_times=(int(time),),
        edge_cut_thresholds=(int(threshold),),
        **kw,
    )


@register_attack("burst")
def _burst(times=(), sizes=(), **kw) -> FailureConfig:
    return FailureConfig(
        burst_times=tuple(times), burst_sizes=tuple(sizes), **kw
    )


@register_attack("probabilistic")
def _probabilistic(p: float = 0.01, start: int = 0, **kw) -> FailureConfig:
    return FailureConfig(p_fail=p, p_fail_start=start, **kw)


@register_attack("byzantine")
def _byzantine(
    node: int = 0, p: float = 0.05, start: int = 0, **kw
) -> FailureConfig:
    return FailureConfig(
        byzantine_node=node, p_byz=p, byz_start_time=start, **kw
    )
