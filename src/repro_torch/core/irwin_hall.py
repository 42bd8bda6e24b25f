"""Irwin-Hall distribution and threshold design (Propositions 3 & 4).

A copy of the JAX package's ``core/irwin_hall.py`` (numpy only, so it
runs unchanged beside the PyTorch simulator).

Under the probability integral transform, each long-active walk contributes
a U(0,1) term to theta-hat, so for K active walks the probabilistic part of
theta-hat is Irwin-Hall distributed with K-1 summands (Prop. 3). A burst of
D terminated walks contributes a *scaled* Irwin-Hall: uniforms supported on
[0, e^{-lambda_r (t - T_d)}] (Prop. 4).

The closed form
    F_{Sigma_K}(s) = 1/K! * sum_{tau=0}^{floor(s)} (-1)^tau C(K,tau) (s-tau)^K
is numerically delicate for large K (catastrophic cancellation), so we
evaluate it with exact integer binomials in float64 for K <= 25 and fall
back to a grid-convolution CDF beyond; tests cross-check both.

Pure numpy (float64) on purpose: this is *design-time* math used to pick
(eps, eps2), not part of the jitted simulation path.
"""
from __future__ import annotations

import math

import numpy as np


def irwin_hall_cdf(s, k: int):
    """CDF of the sum of k iid U(0,1) at point(s) s.

    The closed form suffers catastrophic cancellation for large k (the
    alternating binomial terms reach ~1e+20 by k ~ 20 and the result
    loses monotonicity — found by the hypothesis property suite), so we
    switch to the grid convolution beyond k = 15.
    """
    if k == 0:
        return (np.asarray(s, dtype=np.float64) >= 0).astype(np.float64)
    if k <= 15:
        return _irwin_hall_cdf_closed(s, k)
    return _irwin_hall_cdf_grid(s, k)


def _irwin_hall_cdf_closed(s, k: int):
    s = np.asarray(s, dtype=np.float64)
    out = np.zeros_like(s)
    flat = s.ravel()
    res = np.empty_like(flat)
    for idx, x in enumerate(flat):
        if x <= 0:
            res[idx] = 0.0
        elif x >= k:
            res[idx] = 1.0
        else:
            acc = 0.0
            for tau in range(int(math.floor(x)) + 1):
                acc += ((-1) ** tau) * math.comb(k, tau) * (x - tau) ** k
            res[idx] = acc / math.factorial(k)
    out = res.reshape(s.shape)
    return np.clip(out, 0.0, 1.0)


def _irwin_hall_cdf_grid(s, k: int, grid_points_per_unit: int = 512):
    """CDF via repeated FFT-free convolution of the uniform density."""
    s = np.asarray(s, dtype=np.float64)
    h = 1.0 / grid_points_per_unit
    # density of U(0,1) sampled on the grid
    base = np.ones(grid_points_per_unit, dtype=np.float64) * h
    dens = base.copy()
    for _ in range(k - 1):
        dens = np.convolve(dens, base) / h * h  # keep mass normalized
    # dens now has support on [0, k); build CDF. Each uniform's cell mass
    # sits at its center (i + 1/2) h, so the k-fold sum's cell j is
    # centered at (j + k/2) h — align xs accordingly (without this the
    # CDF is systematically shifted by k h / 2).
    cdf = np.concatenate([[0.0], np.cumsum(dens)])
    cdf = cdf / cdf[-1]
    xs = (np.arange(len(cdf)) + 0.5 * k - 0.5) * h
    return np.interp(s, xs, cdf, left=0.0, right=1.0)


def scaled_irwin_hall_cdf(s, k: int, support: float):
    """Prop. 4: sum of k iid U(0, support) — F(s) = F_IH(s / support)."""
    if support <= 0:
        return (np.asarray(s, dtype=np.float64) >= 0).astype(np.float64)
    return irwin_hall_cdf(np.asarray(s, dtype=np.float64) / support, k)


def _invert_monotone(f, lo: float, hi: float, target: float, iters: int = 80):
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if f(mid) < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def design_eps(z0: int, delta: float = 1e-3) -> float:
    """Pick the forking threshold eps (Section III-B).

    Choose eps such that Pr(theta_hat <= eps | Z_0 active walks)
    = F_{Sigma_{Z0-1}}(eps - 1/2) = delta, i.e. a false fork (with Z_0
    healthy walks) is a delta-probability event per node visit.
    """
    if z0 < 2:
        return 0.5 + delta
    k = z0 - 1
    x = _invert_monotone(lambda v: irwin_hall_cdf(v, k), 0.0, float(k), delta)
    return float(x + 0.5)


def design_eps2(z0: int, delta: float = 1e-3) -> float:
    """Pick the termination threshold eps_2 (Section III-C).

    Choose eps_2 such that Pr(theta_hat >= eps_2 | Z_0 active walks)
    = 1 - F_{Sigma_{Z0-1}}(eps_2 - 1/2) = delta.
    """
    if z0 < 2:
        return 0.5 + 1.0
    k = z0 - 1
    x = _invert_monotone(lambda v: irwin_hall_cdf(v, k), 0.0, float(k), 1.0 - delta)
    return float(x + 0.5)


def false_fork_probability(z0: int, eps: float, p: float | None = None) -> float:
    """p_fork = p * F_{Sigma_{Z0-1}}(eps - 1/2) with Z_0 healthy walks."""
    if p is None:
        p = 1.0 / z0
    return float(p * irwin_hall_cdf(eps - 0.5, z0 - 1))


def false_termination_probability(z0: int, eps2: float, p: float | None = None) -> float:
    if p is None:
        p = 1.0 / z0
    return float(p * (1.0 - irwin_hall_cdf(eps2 - 0.5, z0 - 1)))
