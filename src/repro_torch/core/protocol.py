"""Decision rules: DecAFork and DecAFork+ (batched).

Counterpart of the JAX package's ``core/protocol.py``. ``ProtocolConfig``
keeps the reference's fields, defaults and validation, and its split:

  - numeric fields (``_PROTOCOL_DATA``) become (batch,) tensors through
    :func:`protocol_rows`, one row per trajectory, so a sweep is a stack
    of rows;
  - shape/branch fields (``_PROTOCOL_META``) choose the program.

Rules fire only for the one walk a node chooses (footnote 6: the lowest
active slot index among its visitors).
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import NamedTuple, Sequence

import torch

from repro_torch.utils import prng

ALGORITHMS = ("none", "missingperson", "decafork", "decafork+")
PORTED_ALGORITHMS = ("decafork", "decafork+")

_PROTOCOL_DATA = (
    "z0", "eps", "eps2", "eps_mp", "fork_prob", "protocol_start",
    "eps_quantile", "eps2_quantile", "auto_min_samples",
    "p_jump", "bias_p", "bias_q",
)
_PROTOCOL_META = (
    "algorithm", "max_walks", "rt_bins", "analytic_survival",
    "estimator_impl", "auto_eps", "theta_bin_width", "round_impl",
    "walk_variant", "bloom_bits",
)

ROUND_IMPLS = ("auto", "fused", "unfused")
WALK_VARIANTS = ("uniform", "jump", "biased", "bloom")


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """Protocol parameters; see the module docstring for the split."""

    algorithm: str = "decafork"
    z0: int = 10  # target number of walks Z_0
    max_walks: int = 40  # walk slot capacity W (>= z0)
    eps: float = 2.0  # forking threshold (theta_hat < eps)
    eps2: float = 5.75  # termination threshold, DecAFork+
    eps_mp: float = 300.0  # MissingPerson timeout
    fork_prob: float | None = None  # p; defaults to 1/z0
    rt_bins: int = 1024  # return-time histogram resolution
    protocol_start: int = 0  # no decisions before this step
    analytic_survival: bool = False
    # 'gather' | 'compare' | 'pallas' (the theta_sums kernel) | 'fused'
    # (the round_update kernel) | 'auto' (best for the card: 'fused')
    estimator_impl: str = "gather"
    auto_eps: bool = False
    eps_quantile: float = 0.05
    eps2_quantile: float = 0.995
    theta_bin_width: float = 0.25
    auto_min_samples: int = 50
    # 'fused' (the whole_round kernel) | 'unfused' (the literal stage
    # sequence, the oracle) | 'auto'
    round_impl: str = "auto"
    walk_variant: str = "uniform"
    p_jump: float = 0.0
    bias_p: float = 1.0
    bias_q: float = 1.0
    bloom_bits: int = 64

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.round_impl not in ROUND_IMPLS:
            raise ValueError(
                f"unknown round_impl {self.round_impl!r}; "
                f"expected one of {ROUND_IMPLS}"
            )
        if self.walk_variant not in WALK_VARIANTS:
            raise ValueError(
                f"unknown walk_variant {self.walk_variant!r}; "
                f"expected one of {WALK_VARIANTS}"
            )
        if isinstance(self.z0, numbers.Integral) and self.max_walks < self.z0:
            raise ValueError("max_walks must be >= z0")

    @property
    def p(self) -> float:
        return self.fork_prob if self.fork_prob is not None else 1.0 / self.z0

    @property
    def static_fields(self) -> tuple:
        """The program-shape signature of this config."""
        return tuple(getattr(self, f) for f in _PROTOCOL_META)


def check_ported(pcfg: ProtocolConfig) -> None:
    """Raise for a protocol configuration this slice of the port does not
    run (ROADMAP.md, queue 1), instead of running something else."""
    if pcfg.algorithm not in PORTED_ALGORITHMS:
        raise NotImplementedError(
            f"algorithm {pcfg.algorithm!r} is not ported yet "
            "(ROADMAP.md queue 1, item 3: missingperson / none)"
        )
    if pcfg.analytic_survival:
        raise NotImplementedError(
            "analytic_survival is not ported yet (ROADMAP.md queue 1, item 3)"
        )
    if pcfg.auto_eps:
        raise NotImplementedError(
            "auto_eps is not ported yet (ROADMAP.md queue 1, item 3)"
        )
    if pcfg.walk_variant != "uniform":
        raise NotImplementedError(
            f"walk_variant {pcfg.walk_variant!r} is not ported yet "
            "(ROADMAP.md queue 1, item 7: zoo)"
        )


class ProtocolRows(NamedTuple):
    """The numeric protocol fields the ported rules read, one row per
    trajectory."""

    z0: torch.Tensor  # (batch,) int32
    eps: torch.Tensor  # (batch,) float32
    eps2: torch.Tensor  # (batch,) float32
    p: torch.Tensor  # (batch,) float32 fork / terminate probability
    protocol_start: torch.Tensor  # (batch,) int32


def protocol_rows(cfgs: Sequence[ProtocolConfig], device) -> ProtocolRows:
    """Stack the numeric fields of ``cfgs`` (one per trajectory)."""

    def col(vals, dtype):
        return torch.tensor(list(vals), dtype=dtype, device=device)

    return ProtocolRows(
        z0=col((c.z0 for c in cfgs), torch.int32),
        eps=col((c.eps for c in cfgs), torch.float32),
        eps2=col((c.eps2 for c in cfgs), torch.float32),
        p=col((c.p for c in cfgs), torch.float32),
        protocol_start=col((c.protocol_start for c in cfgs), torch.int32),
    )


def choose_walks(pos: torch.Tensor, active: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Footnote 6: per node, the single lowest-index visiting walk, via
    an (n,)-sized scatter-min per trajectory."""
    batch, W = pos.shape
    slots = torch.arange(W, dtype=torch.int32, device=pos.device)
    cand = torch.where(active, slots, W)
    best = torch.full((batch, n_nodes), W, dtype=torch.int32, device=pos.device)
    best.scatter_reduce_(1, pos.long(), cand, "amin")
    return active & (torch.gather(best, 1, pos.long()) == slots)


def choose_walks_pairwise(pos: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """``choose_walks`` through a (W, W) compare; bitwise the same."""
    W = pos.shape[-1]
    slots = torch.arange(W, dtype=torch.int32, device=pos.device)
    cand = torch.where(active, slots, W)
    same = pos[..., :, None] == pos[..., None, :]
    best = torch.where(same, cand[..., None, :], W).amin(dim=-1)
    return active & (best == slots)


def decisions_from_uniforms(
    theta, chosen, u_fork, u_term, rows: ProtocolRows, enabled, decafork_plus: bool
):
    """The DecAFork fork mask and DecAFork+ terminate mask, given the
    decision uniforms."""
    p = rows.p.view(-1, 1)
    en = enabled.view(-1, 1)
    fork = chosen & (theta < rows.eps.view(-1, 1)) & (u_fork < p) & en
    if decafork_plus:
        term = chosen & (theta > rows.eps2.view(-1, 1)) & (u_term < p) & en
        term = term & ~fork
    else:
        term = torch.zeros_like(fork)
    return fork, term


def decafork_decisions(
    theta: torch.Tensor,  # (batch, W)
    chosen: torch.Tensor,  # (batch, W) bool
    keys: torch.Tensor,  # (batch, 2)
    rows: ProtocolRows,
    enabled: torch.Tensor,  # (batch,) bool: t >= protocol_start
    decafork_plus: bool,
    *, partitionable: bool = True,
):
    """DecAFork fork mask (and the DecAFork+ termination mask); the two
    uniforms come from ``split(key)`` as in the reference."""
    W = theta.shape[-1]
    sub = prng.split(keys, 2, partitionable=partitionable)
    u = prng.uniform(sub.transpose(0, 1), (W,), partitionable=partitionable)
    return decisions_from_uniforms(
        theta, chosen, u[0], u[1], rows, enabled, decafork_plus
    )
