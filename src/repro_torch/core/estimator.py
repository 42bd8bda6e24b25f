"""Return-time estimation and the theta-hat walk-count estimator (Eq. 1).

Counterpart of the JAX package's ``core/estimator.py``, batched: every
array carries a leading trajectory axis. Per trajectory, node i keeps

  - ``last_seen[i, c]``: the last step at which walk track c visited i
    (``NEVER`` if never);
  - ``hist[i, b]``: the empirical histogram of observed return times
    (bin b holds return time b+1, the last bin clamps the tail), int16,
    and ``total[i]`` its sample count, int32.

theta_hat_i(t) = 1/2 + sum_{c != k, seen} S_i(t - last_seen[i, c]) with
S_i(r) = 1 - cum_i(r) / total_i the empirical survival function.

Two float formulas exist, as in the reference: the row-gather form
(``theta_hat_rows``) and the node-sum form (``survival_node_sums_rows``,
used by the compare/kernel paths). The node-sum form is exact integer
arithmetic up to one division while ``C * total < 2**24``, so any
summation order gives the reference's bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEVER = -1  # sentinel for "walk never seen at this node"

# cap on the (rows, C, B) compare intermediate of the literal node-sum
# formula; rows are processed in chunks below it
_COMPARE_ELEMS = 1 << 26


class ReturnTimeState(NamedTuple):
    """Per-node empirical return-time statistics, exact integer counts."""

    hist: torch.Tensor  # (batch, n, B) int16; bin b <-> return time b+1
    total: torch.Tensor  # (batch, n) int32


def init_return_time_state(batch: int, n: int, bins: int, device) -> ReturnTimeState:
    return ReturnTimeState(
        hist=torch.zeros((batch, n, bins), dtype=torch.int16, device=device),
        total=torch.zeros((batch, n), dtype=torch.int32, device=device),
    )


def _flat_rows(batch: int, n: int, nodes: torch.Tensor) -> torch.Tensor:
    """Flat (batch * n) row index of each (trajectory, node) pair."""
    b = torch.arange(batch, device=nodes.device).view(-1, *([1] * (nodes.dim() - 1)))
    return b * n + nodes.long()


def record_returns(
    state: ReturnTimeState,
    nodes: torch.Tensor,  # (batch, W) node visited by each walk
    r: torch.Tensor,  # (batch, W) observed return times
    valid: torch.Tensor,  # (batch, W) bool
) -> ReturnTimeState:
    """Scatter-add the valid samples into the histograms, in place (the
    state is W rows of an n-row table; copying it each round is waste)."""
    batch, n, bins = state.hist.shape
    rows = _flat_rows(batch, n, nodes)
    b = torch.clamp(r, 1, bins).long() - 1
    state.hist.view(-1).index_put_(
        (rows * bins + b,), valid.to(state.hist.dtype), accumulate=True
    )
    state.total.view(-1).index_put_(
        (rows,), valid.to(state.total.dtype), accumulate=True
    )
    return state


def scatter_max_last_seen(
    last_seen: torch.Tensor,  # (batch, n, C) int32
    pos: torch.Tensor,  # (batch, W)
    track: torch.Tensor,  # (batch, W)
    upd: torch.Tensor,  # (batch, W) int32
) -> torch.Tensor:
    """``last_seen.at[pos, track].max(upd)`` per trajectory, in place."""
    batch, n, C = last_seen.shape
    idx = _flat_rows(batch, n, pos) * C + track.long()
    flat = last_seen.view(-1)
    flat.scatter_reduce_(0, idx.reshape(-1), upd.reshape(-1), "amax")
    return last_seen


def survival_cumulative(hist: torch.Tensor) -> torch.Tensor:
    """(..., R, B+1) float32 table C with C[i, r] = #samples <= r
    (C[i, 0] = 0) from (..., R, B) histogram rows."""
    csum = torch.cumsum(hist.float(), dim=-1)
    return torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)


def survival_eval(
    cum: torch.Tensor,  # (R, B+1) from survival_cumulative
    total: torch.Tensor,  # (R,)
    nodes: torch.Tensor,  # (...) row of each entry
    r: torch.Tensor,  # (...) elapsed times
) -> torch.Tensor:
    """Empirical S_i(r) = 1 - F_hat(r), elementwise over broadcast args.

    Conventions: S(r <= 0) = 1; rows with no samples yet return 1 (a
    walk is presumed alive absent any evidence)."""
    nodes, r = torch.broadcast_tensors(nodes.long(), r)
    bins = cum.shape[-1] - 1
    tot = total[nodes].float()
    seen = cum[nodes, torch.clamp(r, 0, bins).long()]
    s = 1.0 - seen / torch.clamp(tot, min=1.0)
    s = torch.where(tot > 0, s, torch.ones_like(s))
    return torch.where(r <= 0, torch.ones_like(s), s)


def gather_rows(table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``table[b, pos[b, w]]`` for a (batch, n, ...) table -> (batch, W, ...)."""
    idx = pos.long().view(pos.shape + (1,) * (table.dim() - 2))
    idx = idx.expand(pos.shape + table.shape[2:])
    return torch.gather(table, 1, idx)


def survival_node_sums_rows(
    last_seen: torch.Tensor,  # (..., R, C) int32
    hist: torch.Tensor,  # (..., R, B)
    total: torch.Tensor,  # (..., R)
    t: torch.Tensor,  # scalar or (...,) broadcast over the leading axes
) -> torch.Tensor:
    """The compare-accumulate survival core, literally: per row,
    sum_c S_i(t - L_{i,c}) with cum_i(r) = sum_b hist[i,b] [r > b]. The
    single source of the node-sum formula (estimator.py:206 in the JAX
    package); the kernels' plain versions call it. Rows are chunked so
    the (rows, C, B) compare intermediate stays bounded."""
    lead = last_seen.shape[:-2]
    R, C = last_seen.shape[-2:]
    B = hist.shape[-1]
    t = torch.as_tensor(t, device=last_seen.device)
    t_rows = t.reshape(t.shape + (1,) * (len(lead) + 1 - t.dim())).expand(lead + (R,))
    ls = last_seen.reshape(-1, C)
    hf = hist.reshape(-1, B).float()  # exact: integer counts < 2**24
    tf = total.reshape(-1).float()
    tt = t_rows.reshape(-1, 1)
    bidx = torch.arange(B, device=ls.device)
    step = max(1, _COMPARE_ELEMS // max(1, C * B))
    out = []
    for s in range(0, ls.shape[0], step):
        l = ls[s : s + step]
        valid = l != NEVER
        r = torch.where(valid, tt[s : s + step] - l, torch.zeros_like(l))
        over = (r[:, :, None] > bidx) & valid[:, :, None]
        cnt = over.float().sum(dim=1)  # (rows, B)
        mass = (cnt * hf[s : s + step]).sum(dim=1)
        n_valid = valid.float().sum(dim=1)
        tot = tf[s : s + step]
        sums = n_valid - mass / torch.clamp(tot, min=1.0)
        out.append(torch.where(tot > 0, sums, n_valid))
    return torch.cat(out).reshape(lead + (R,))


def node_sums_compare(last_seen, hist, total, t) -> torch.Tensor:
    """sum_c S_i(t - L_{i,c}) per node on the full (batch, n) table."""
    return survival_node_sums_rows(last_seen, hist, total, t)


def theta_hat_from_node_sums(node_sums: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """theta for a visiting walk = node_sum - 1/2 (its own fresh column
    contributes S = 1, the deterministic self term is 1/2). Valid only
    after ``last_seen[pos, track]`` was updated to t."""
    return torch.gather(node_sums, 1, pos.long()) - 0.5


def analytic_survival_eval(
    pi: torch.Tensor,  # (n,) stationary distribution (geometric rate q_i = pi_i)
    nodes: torch.Tensor,  # (...) node of each entry
    r: torch.Tensor,  # (...) elapsed times
) -> torch.Tensor:
    """Analytic geometric survival S_i(r) = (1 - pi_i)^r (footnote 5)."""
    q = pi[nodes.long()]
    s = torch.exp(torch.log1p(-q) * r.float())
    return torch.where(r <= 0, torch.ones_like(s), s)


def theta_hat_rows(
    last_seen: torch.Tensor,  # (batch, n, C)
    hist: torch.Tensor,  # (batch, n, B)
    total: torch.Tensor,  # (batch, n)
    t: torch.Tensor,  # (batch,)
    pos: torch.Tensor,  # (batch, W)
    track: torch.Tensor,  # (batch, W)
    *,
    pi: torch.Tensor | None = None,
    max_elapsed: int | None = None,
) -> torch.Tensor:
    """Row-restricted Eq. (1) (the gather family): cumsum + survival
    lookup on the visited rows only, or the analytic survival of ``pi``
    (footnote 5) when it is given. ``max_elapsed`` trims the cumsum to
    the bins a run can reach (bitwise-neutral, as in the reference)."""
    C = last_seen.shape[2]
    ls = gather_rows(last_seen, pos)  # (batch, W, C)
    elapsed = t.view(-1, 1, 1) - ls
    if pi is not None:
        s = analytic_survival_eval(pi, pos[..., None].expand_as(ls), elapsed)
    else:
        bins = hist.shape[2]
        if max_elapsed is not None:
            bins = min(bins, max(int(max_elapsed), 1))
        rows = gather_rows(hist, pos)[..., :bins].float()
        csum = torch.cumsum(rows, dim=2)
        cum = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=2)
        r_cl = torch.clamp(elapsed, 0, bins).long()
        tot = torch.gather(total, 1, pos.long()).float()[..., None].expand_as(ls)
        seen = torch.gather(cum, 2, r_cl)
        s = 1.0 - seen / torch.clamp(tot, min=1.0)
        s = torch.where(tot > 0, s, torch.ones_like(s))
        s = torch.where(elapsed <= 0, torch.ones_like(s), s)
    cols = torch.arange(C, device=ls.device)
    mask = (ls != NEVER) & (cols != track[..., None])
    return 0.5 + torch.where(mask, s, torch.zeros_like(s)).sum(dim=2)
