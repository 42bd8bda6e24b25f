"""Decision rules: DecAFork, DecAFork+ and the MissingPerson baseline
(batched).

Counterpart of the JAX package's ``core/protocol.py``. ``ProtocolConfig``
keeps the reference's fields, defaults and validation, and its split:

  - numeric fields (``_PROTOCOL_DATA``) become (batch,) tensors through
    :func:`protocol_rows`, one row per trajectory, so a sweep is a stack
    of rows;
  - shape/branch fields (``_PROTOCOL_META``) choose the program.

Rules fire only for the one walk a node chooses (footnote 6: the lowest
active slot index among its visitors). ``"none"`` runs the walks with no
rule at all.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import NamedTuple, Sequence

import torch

from repro_torch.utils import prng

ALGORITHMS = ("none", "missingperson", "decafork", "decafork+")
# the algorithms whose rounds the whole_round kernel computes
FUSED_ALGORITHMS = ("decafork", "decafork+")

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


class ProtocolRows(NamedTuple):
    """The numeric protocol fields the ported rules read, one row per
    trajectory."""

    z0: torch.Tensor  # (batch,) int32
    eps: torch.Tensor  # (batch,) float32
    eps2: torch.Tensor  # (batch,) float32
    p: torch.Tensor  # (batch,) float32 fork / terminate probability
    protocol_start: torch.Tensor  # (batch,) int32
    eps_mp: torch.Tensor  # (batch,) float32 MissingPerson timeout
    theta_bin_width: torch.Tensor  # (batch,) float32 auto_eps histogram bin
    eps_quantile: torch.Tensor  # (batch,) float32
    eps2_quantile: torch.Tensor  # (batch,) float32
    auto_min_samples: torch.Tensor  # (batch,) int32
    p_jump: torch.Tensor  # (batch,) float32 'jump' teleport probability
    bias_p: torch.Tensor  # (batch,) float32 'biased' return parameter
    bias_q: torch.Tensor  # (batch,) float32 'biased' in-out parameter


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
        eps_mp=col((c.eps_mp for c in cfgs), torch.float32),
        theta_bin_width=col((c.theta_bin_width for c in cfgs), torch.float32),
        eps_quantile=col((c.eps_quantile for c in cfgs), torch.float32),
        eps2_quantile=col((c.eps2_quantile for c in cfgs), torch.float32),
        auto_min_samples=col((c.auto_min_samples for c in cfgs), torch.int32),
        p_jump=col((c.p_jump for c in cfgs), torch.float32),
        bias_p=col((c.bias_p for c in cfgs), torch.float32),
        bias_q=col((c.bias_q for c in cfgs), torch.float32),
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


def decisions_from_uniforms(theta, chosen, u_fork, u_term, eps, eps2, p, enabled,
                            decafork_plus: bool):
    """The DecAFork fork mask and DecAFork+ terminate mask, given the
    decision uniforms; ``eps``, ``eps2``, ``p`` and ``enabled`` broadcast
    against the (batch, W) walks (per-row columns, or per-walk
    thresholds under auto_eps)."""
    fork = chosen & (theta < eps) & (u_fork < p) & enabled
    if decafork_plus:
        term = chosen & (theta > eps2) & (u_term < p) & enabled
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
    eps: torch.Tensor | None = None,  # (batch, W) per-walk override (auto_eps)
    eps2: torch.Tensor | None = None,
    *, partitionable: bool = True,
):
    """DecAFork fork mask (and the DecAFork+ termination mask); the two
    uniforms come from ``split(key)`` as in the reference."""
    W = theta.shape[-1]
    sub = prng.split(keys, 2, partitionable=partitionable)
    u = prng.uniform(sub.transpose(0, 1), (W,), partitionable=partitionable)
    return decisions_from_uniforms(
        theta, chosen, u[0], u[1],
        rows.eps.view(-1, 1) if eps is None else eps,
        rows.eps2.view(-1, 1) if eps2 is None else eps2,
        rows.p.view(-1, 1), enabled.view(-1, 1), decafork_plus,
    )


def theta_bins(pcfg: ProtocolConfig) -> int:
    """Bins of the auto_eps theta-hat histogram: theta-hat <= 0.5 +
    (slots - 1), and one extra bin absorbs the tail."""
    return int((pcfg.max_walks + 1) / pcfg.theta_bin_width) + 1


def theta_quantile_thresholds(
    theta_hist: torch.Tensor,  # (batch, n, TB) per-node warm-up theta-hat histogram
    pos: torch.Tensor,  # (batch, W)
    rows: ProtocolRows,
):
    """Per-walk (eps, eps2) from the visiting node's own theta-hat
    distribution (auto_eps): the centre of the first bin whose CDF
    reaches each quantile. Nodes with fewer than ``auto_min_samples``
    warm-up samples fall back to the rows' global thresholds."""
    idx = pos.long()[..., None].expand(pos.shape + theta_hist.shape[2:])
    hrows = torch.gather(theta_hist, 1, idx)  # (batch, W, TB)
    total = hrows.sum(dim=2, keepdim=True)  # exact: integer counts < 2**24
    cdf = torch.cumsum(hrows, dim=2) / torch.clamp(total, min=1.0)
    TB = hrows.shape[2]
    bins = torch.arange(TB, dtype=torch.float32, device=pos.device)
    centers = (bins + 0.5) * rows.theta_bin_width.view(-1, 1)  # (batch, TB)

    def quantile(q):
        ok = cdf >= q.view(-1, 1, 1)
        first = torch.argmax(ok.to(torch.int8), dim=2)  # first bin reaching q
        return torch.gather(centers, 1, first)

    have = total[..., 0] >= rows.auto_min_samples.view(-1, 1).float()
    eps = torch.where(have, quantile(rows.eps_quantile), rows.eps.view(-1, 1))
    eps2 = torch.where(have, quantile(rows.eps2_quantile), rows.eps2.view(-1, 1))
    return eps, eps2


def missingperson_decisions(
    last_seen: torch.Tensor,  # (batch, n, C) int32
    pos: torch.Tensor,  # (batch, W)
    track: torch.Tensor,  # (batch, W)
    chosen: torch.Tensor,  # (batch, W) bool
    t: torch.Tensor,  # (batch,) int32
    keys: torch.Tensor,  # (batch, 2)
    rows: ProtocolRows,
    enabled: torch.Tensor,  # (batch,) bool
    *, partitionable: bool = True,
) -> torch.Tensor:
    """MissingPerson: the (batch, W, C) mask of replacement-fork events.
    Event (k, l) means the node visited by walk k deems initial id l
    missing (unseen for more than ``eps_mp`` steps) and forks a duplicate
    of k carrying id l. Only the initial-id columns l < z0 can fire. The
    (W, C) uniform is one draw per trajectory from its decision key."""
    W = pos.shape[1]
    C = last_seen.shape[2]
    idx = pos.long()[..., None].expand(-1, -1, C)
    ls = torch.gather(last_seen, 1, idx)  # (batch, W, C)
    stale = (t.view(-1, 1, 1) - ls).float() > rows.eps_mp.view(-1, 1, 1)
    ids = torch.arange(C, dtype=torch.int32, device=pos.device).view(1, 1, C)
    is_initial = ids < rows.z0.view(-1, 1, 1)
    not_self = ids != track[..., None]
    u = prng.uniform(keys, (W, C), partitionable=partitionable)
    return (
        chosen[..., None] & stale & is_initial & not_self
        & (u < rows.p.view(-1, 1, 1)) & enabled.view(-1, 1, 1)
    )
