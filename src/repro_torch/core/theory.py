"""Computable theoretical guarantees (Sections IV and V).

A copy of the JAX package's ``core/theory.py`` (numpy only), reading
the port's copy of ``irwin_hall``.

Implements, under Assumption 1 (exponential return rate lambda_r, arrival
rate lambda_a):

  - Lemma 1:   CDF of a forked/terminated walk's survival estimate
               S(t - L_{i,k}(t)), the building block of everything else;
  - Cor. 1:    its closed-form mean (cross-checked numerically in tests);
  - Lemma 2:   E[theta_hat(t)] for a mixture of long-active, terminated
               and forked walks;
  - Lemma 3:   Var of the forked-walk estimate — we evaluate mean/variance
               *numerically* from the Lemma-1 CDF (robust against the very
               long closed form in the paper; tests verify Cor. 1 agrees);
  - Lemma 4/5: Bennett upper bounds on forking / termination probability.
               NOTE: the paper prints h((E-eps)^2 / sigma^2); the standard
               Bennett inequality their proof invokes uses h(tau / sigma^2)
               with tau = E - eps and unit-bounded summands. We implement
               the standard form and flag the discrepancy.
  - Thm. 2:    worst-case reaction-time bound after D failures / R forks;
  - Thm. 3 /   no-failure growth bound and its inversion (time until the
    Cor. 2     population exceeds z with probability delta);
  - Cor. 3:    linear-complexity overshoot recursion after a burst.

All numpy/float64 — these are design/validation-time quantities.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.irwin_hall import irwin_hall_cdf, scaled_irwin_hall_cdf


@dataclasses.dataclass(frozen=True)
class Rates:
    """Assumption 1 rates: R_i ~ exp(lambda_r), H_{i,j} ~ exp(lambda_a)."""

    lambda_r: float
    lambda_a: float


# ---------------------------------------------------------------------------
# Lemma 1: CDF of the survival estimate of a forked(/terminated) walk
# ---------------------------------------------------------------------------


def fork_estimate_cdf(x, t: float, t_f: float, t_d: float, rates: Rates):
    """F_{theta_hat_{Tf,Td}(t)}(x) per Lemma 1.

    Walk forked at t_f < t, terminated at t_d (pass t_d = t for a walk
    that is still active).
    """
    lr, la = rates.lambda_r, rates.lambda_a
    x = np.asarray(x, dtype=np.float64)
    t_d = min(t_d, t)
    hi = math.exp(-lr * (t - t_d))  # largest observable value
    lo = math.exp(-lr * (t - t_f))  # smallest observable value
    atom = math.exp(-la * (t_d - t_f))  # P(fork never arrived before t_d)
    x_safe = np.where(x > 0, x, 1.0)  # mid is only used for x >= lo > 0
    mid = (
        x / hi * (1.0 - math.exp(-la * (t - t_f)) * np.power(x_safe, -la / lr))
        + atom
    )
    out = np.where(x >= hi, 1.0, np.where(x < lo, atom, np.clip(mid, 0.0, 1.0)))
    return out


def fork_estimate_mean_closed(t: float, t_f: float, t_d: float, rates: Rates) -> float:
    """Corollary 1 closed form."""
    lr, la = rates.lambda_r, rates.lambda_a
    t_d = min(t_d, t)
    ratio = 1.0 / (2.0 - la / lr)
    term1 = math.exp(-la * (t_d - t_f)) * math.exp(-lr * (t - t_d)) * (ratio - 1.0)
    term2 = math.exp(-lr * (t - t_d)) / 2.0
    term3 = (
        math.exp(-2.0 * lr * (t - t_f))
        * math.exp(lr * (t - t_d))
        * (0.5 - ratio)
    )
    return term1 + term2 + term3


def fork_estimate_moments(
    t: float, t_f: float, t_d: float, rates: Rates, grid: int = 20000
) -> Tuple[float, float]:
    """(mean, variance) by numerical integration of the Lemma-1 CDF.

    E[X] = int (1-F) dx and E[X^2] = int 2x (1-F) dx over the support
    [0, e^{-lr (t-Td)}] — robust substitute for the Lemma-3 closed form.
    """
    lr = rates.lambda_r
    t_d_eff = min(t_d, t)
    hi = math.exp(-lr * (t - t_d_eff))
    xs = np.linspace(0.0, hi, grid)
    sf = 1.0 - fork_estimate_cdf(xs, t, t_f, t_d, rates)
    mean = float(np.trapezoid(sf, xs))
    ex2 = float(np.trapezoid(2.0 * xs * sf, xs))
    return mean, max(ex2 - mean * mean, 0.0)


# ---------------------------------------------------------------------------
# Lemma 2: mean of theta_hat for a population history
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PopulationHistory:
    """|A_t| long-active walks, terminations at (time,count), forks ditto."""

    n_active: int
    terminations: Tuple[Tuple[float, int], ...] = ()  # (T_d, count)
    forks: Tuple[Tuple[float, int], ...] = ()  # (T_f, count)


def theta_mean(t: float, hist: PopulationHistory, rates: Rates) -> float:
    """Lemma 2 (the visiting walk is one of the long-active ones)."""
    lr, la = rates.lambda_r, rates.lambda_a
    ratio = 1.0 / (2.0 - la / lr)
    m = 0.5 + (hist.n_active - 1) / 2.0
    for t_d, cnt in hist.terminations:
        m += cnt * math.exp(-lr * (t - t_d)) / 2.0
    for t_f, cnt in hist.forks:
        m += cnt * (
            0.5
            + math.exp(-la * (t - t_f)) * (ratio - 1.0)
            + math.exp(-2.0 * lr * (t - t_f)) * (0.5 - ratio)
        )
    return m


def theta_variance(t: float, hist: PopulationHistory, rates: Rates) -> float:
    """sigma^2(t) as used by Lemmas 4/5 (numerical fork variances)."""
    lr = rates.lambda_r
    v = (hist.n_active - 1) / 12.0
    for t_d, cnt in hist.terminations:
        v += cnt * math.exp(-2.0 * lr * (t - t_d)) / 12.0
    for t_f, cnt in hist.forks:
        _, var = fork_estimate_moments(t, t_f, t, rates)
        v += cnt * var
    return v


# ---------------------------------------------------------------------------
# Lemmas 4 & 5: Bennett bounds on fork / termination probability
# ---------------------------------------------------------------------------


def _bennett_h(zeta: float) -> float:
    return (1.0 + zeta) * math.log1p(zeta) - zeta


def fork_probability_bound(
    t: float, hist: PopulationHistory, rates: Rates, eps: float, p: float
) -> float:
    """Lemma 4: for E[theta] > eps, p_fork <= p exp(-sigma^2 h(tau/sigma^2))."""
    m = theta_mean(t, hist, rates)
    tau = m - eps
    if tau <= 0:
        return p  # estimator mean already below threshold: no guarantee
    s2 = max(theta_variance(t, hist, rates), 1e-12)
    return p * math.exp(-s2 * _bennett_h(tau / s2))


def termination_probability_bound(
    t: float, hist: PopulationHistory, rates: Rates, eps2: float, p: float
) -> float:
    """Lemma 5: for E[theta] < eps2, p_term <= p exp(-sigma^2 h(tau/sigma^2))."""
    m = theta_mean(t, hist, rates)
    tau = eps2 - m
    if tau <= 0:
        return p
    s2 = max(theta_variance(t, hist, rates), 1e-12)
    return p * math.exp(-s2 * _bennett_h(tau / s2))


# ---------------------------------------------------------------------------
# Theorem 2: reaction time to the failure of D walks
# ---------------------------------------------------------------------------


def reaction_time_bound(
    d_failed: int,
    r_forked: int,
    k_remaining: int,
    t_d: float,
    eps: float,
    p: float,
    rates: Rates,
    delta: float = 0.05,
    horizon: int = 20000,
    eps_prime_grid: int = 24,
) -> float:
    """Smallest T - t_d such that >= 1 fork happened by T w.p. >= 1-delta.

    delta_{D-R}(T) <= prod_{t=Td}^T [1 - p F_{Sig_{K+R-1}}(eps')
                      F_{Sig_{D-R}}((eps - eps' - 1/2) e^{lr (t-Td)})],
    optimized over the free split eps' in (0, eps - 1/2).
    """
    lr = rates.lambda_r
    d_eff = d_failed - r_forked
    k_eff = k_remaining + r_forked
    if d_eff <= 0:
        return 0.0
    best = math.inf
    for frac in np.linspace(0.05, 0.95, eps_prime_grid):
        eps_p = frac * (eps - 0.5)
        if eps_p <= 0:
            continue
        live_cdf = float(irwin_hall_cdf(eps_p, max(k_eff - 1, 0)))
        if live_cdf <= 0:
            continue
        log_surv = 0.0
        found = None
        for step in range(1, horizon):
            support = math.exp(-lr * step)
            dead_cdf = float(
                scaled_irwin_hall_cdf(eps - eps_p - 0.5, d_eff, support)
            )
            q = 1.0 - p * live_cdf * dead_cdf
            log_surv += math.log(max(q, 1e-300))
            if math.exp(log_surv) <= delta:
                found = step
                break
        if found is not None and found < best:
            best = found
    return best


def multi_fork_reaction_bound(
    d_failed: int,
    k_remaining: int,
    r_target: int,
    t_d: float,
    eps: float,
    p: float,
    rates: Rates,
    delta_total: float = 0.05,
) -> float:
    """Time until >= R' forks, summing Thm. 2 per fork with delta split."""
    per = delta_total / max(r_target, 1)
    total = 0.0
    for r in range(r_target):
        total += reaction_time_bound(
            d_failed, r, k_remaining, t_d, eps, p, rates, delta=per
        )
    return total


# ---------------------------------------------------------------------------
# Theorem 3 / Corollary 2: growth without failures
# ---------------------------------------------------------------------------


def fork_rate_upper(nu: int, eps: float, p: float) -> float:
    """p_nu^+ = nu * p * F_{Sigma_{nu-1}}(eps - 1/2)."""
    return float(nu * p * irwin_hall_cdf(eps - 0.5, max(nu - 1, 0)))


def growth_bound_delta(
    z_max: int, z0: int, horizon: float, n_nodes: int, eps: float, p: float, rates: Rates
) -> float:
    """Thm. 3: P(Z_T > z_max) <= delta for a failure-free run of length T."""
    la = rates.lambda_a
    cum_t = 0.0
    delta = 0.0
    m = z0
    for nu in range(z0, z_max):
        p_nu = max(fork_rate_upper(nu, eps, p), 1e-300)
        t_nu1 = math.log(la * n_nodes / p_nu) / la if la * n_nodes > p_nu else 0.0
        if cum_t + t_nu1 >= horizon:
            m = nu
            break
        cum_t += t_nu1
        delta += n_nodes * math.exp(-la * t_nu1) + t_nu1 * p_nu
        m = nu + 1
    t_m2 = max(horizon - cum_t, 0.0)
    delta += fork_rate_upper(m, eps, p) * t_m2
    return min(delta, 1.0)


def time_until_growth(
    z_max: int, z0: int, n_nodes: int, eps: float, p: float, rates: Rates, delta: float
) -> float:
    """Cor. 2: largest T with P(Z_T > z_max) <= delta (bisection on Thm. 3)."""
    lo, hi = 0.0, 1.0
    while growth_bound_delta(z_max, z0, hi, n_nodes, eps, p, rates) < delta and hi < 1e12:
        hi *= 2.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if growth_bound_delta(z_max, z0, mid, n_nodes, eps, p, rates) < delta:
            lo = mid
        else:
            hi = mid
    return lo


# ---------------------------------------------------------------------------
# Theorem 4: exact (exponential) overshoot bound via the binary threshold tree
# ---------------------------------------------------------------------------


def _binom_tail_above(z: int, kappa: int, p_fork: float) -> float:
    """P(Z' > kappa | Z = z): forks ~ Binomial(z, p_fork), Z' = z + forks."""
    if kappa >= 2 * z:
        return 0.0
    if kappa < z:
        return 1.0
    tail = 0.0
    for k in range(kappa - z + 1, z + 1):
        tail += math.comb(z, k) * p_fork**k * (1 - p_fork) ** (z - k)
    return min(tail, 1.0)


def overshoot_exact_bound(
    z_after_failure: int,
    d_failed: int,
    t_d: float,
    horizon: int,
    eps: float,
    p: float,
    rates: Rates,
    kappa_factor: float = 1.5,
) -> float:
    """Theorem 4: upper bound on E[Z_{t0 + horizon}] after a burst.

    Walks the binary threshold tree: at each step the population either
    stays below the threshold kappa (assumed w.p. <= 1, Z pinned at kappa
    — the paper's bound) or exceeds it (probability upper-bounded by the
    Bennett/binomial tail, Z pinned at the worst case 2Z). Thresholds
    kappa_{1,a} = ceil(kappa_factor * Z) satisfy the paper's constraints
    kappa_{a,1} > kappa_a and kappa_{a,0} <= 2 kappa_a for factor in
    (1, 2]. Exponential in `horizon` — use for horizon <= ~12 (the
    linear-complexity Cor. 3 covers long horizons).
    """
    if not (1.0 < kappa_factor <= 2.0):
        raise ValueError("kappa_factor must be in (1, 2]")
    if horizon < 1:
        return float(z_after_failure)
    if horizon > 16:
        raise ValueError("exponential bound: use overshoot_recursion beyond 16")

    total = 0.0
    # each tree path: (weight, z_current, fork_history tuple)
    paths = [(1.0, z_after_failure, ())]
    for step in range(1, horizon):
        t = t_d + step
        new_paths = []
        for w, z, forks in paths:
            hist = PopulationHistory(
                n_active=z_after_failure,
                terminations=((t_d, d_failed),),
                forks=forks,
            )
            pf = fork_probability_bound(t, hist, rates, eps, p)
            kappa = min(int(math.ceil(kappa_factor * z)), 2 * z)
            if kappa <= z:
                kappa = z + 1
            p_over = _binom_tail_above(z, kappa, pf)
            # branch a=0: Z <= kappa (prob bounded by 1), pin at kappa
            f0 = forks + (((t, kappa - z),) if kappa > z else ())
            new_paths.append((w, kappa, f0))
            # branch a=1: Z > kappa, worst case 2Z
            if p_over > 0 and w * p_over > 1e-12:
                f1 = forks + (((t, z),) if z > 0 else ())
                new_paths.append((w * p_over, 2 * z, f1))
        paths = new_paths
    # leaf expectation: E[Z_{t0+x} | path] <= Z + Z * p_fork(H)
    for w, z, forks in paths:
        hist = PopulationHistory(
            n_active=z_after_failure,
            terminations=((t_d, d_failed),),
            forks=forks,
        )
        pf = fork_probability_bound(t_d + horizon, hist, rates, eps, p)
        total += w * (z + z * pf)
    return total


# ---------------------------------------------------------------------------
# Corollary 3: linear-complexity overshoot recursion
# ---------------------------------------------------------------------------


def overshoot_recursion(
    z_after_failure: int,
    d_failed: int,
    t_d: float,
    steps: int,
    eps: float,
    p: float,
    rates: Rates,
    use_ceiling: bool = True,
) -> np.ndarray:
    """E-bar[Z_{t'}] for t' = T_d+1 .. T_d+steps (Cor. 3).

    The history starts with Z_{T_d} long-active walks and D walks dead at
    T_d; each step appends the expected forks as fork events. With
    ``use_ceiling`` (the paper's literal statement) the bound grows by at
    least 1 per step — the paper itself notes this non-convergence; the
    ceiling-free variant (use_ceiling=False) is the informative
    short-horizon overshoot estimate.
    """
    zs = [float(z_after_failure)]
    forks: list[Tuple[float, int]] = []
    out = np.zeros(steps, dtype=np.float64)
    for i in range(steps):
        t = t_d + 1.0 + i
        hist = PopulationHistory(
            n_active=z_after_failure,
            terminations=((t_d, d_failed),),
            forks=tuple(forks),
        )
        pf = fork_probability_bound(t, hist, rates, eps, p)
        z_prev = math.ceil(zs[-1]) if use_ceiling else zs[-1]
        z_new = z_prev + z_prev * pf
        new_forks = (math.ceil(z_new) if use_ceiling else round(z_new)) - (
            math.ceil(zs[-1]) if use_ceiling else round(zs[-1])
        )
        if new_forks > 0:
            forks.append((t, new_forks))
        zs.append(z_new)
        out[i] = z_new
    return out
