"""Spectral / Markov-chain quantities of the simple random walk (numpy;
copied from the JAX package's ``graphs/spectral.py``, the same values).

Used for (i) the analytic-survival option of the estimator (paper
footnote 5), (ii) the theory module's (lambda_r, lambda_a) rates
(Assumption 1), and (iii) sizing the initialization phase (cover time).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.generators import Graph


def transition_matrix(g: Graph) -> np.ndarray:
    """Row-stochastic simple-RW transition matrix (analysis use)."""
    a = g.adjacency().astype(np.float64)
    return a / a.sum(1, keepdims=True)


def stationary_distribution(g: Graph) -> np.ndarray:
    """pi_i = deg(i) / 2|E| for a simple RW on an undirected graph."""
    d = g.degrees.astype(np.float64)
    return d / d.sum()


def expected_return_times(g: Graph) -> np.ndarray:
    """E[R_i] = 1 / pi_i (Kac's formula)."""
    return 1.0 / stationary_distribution(g)


def return_rate_estimate(g: Graph) -> np.ndarray:
    """Per-node exponential return rate lambda_r (Assumption 1 proxy).

    The paper approximates R_i by a geometric with mean 1/pi_i; the
    continuous analog is exp(lambda_r) with lambda_r = pi_i.
    """
    return stationary_distribution(g)


def spectral_gap(g: Graph) -> float:
    """1 - lambda_2 of the lazy symmetrized walk (mixing rate)."""
    p = transition_matrix(g)
    d = g.degrees.astype(np.float64)
    # Symmetrize: S = D^{1/2} P D^{-1/2} has the same spectrum as P.
    s = np.sqrt(d)[:, None] * p / np.sqrt(d)[None, :]
    ev = np.linalg.eigvalsh((s + s.T) / 2.0)
    lam2 = ev[-2]
    return float(1.0 - lam2)


def mixing_time_bound(g: Graph, eps: float = 0.25) -> float:
    """t_mix <= log(1/(eps*pi_min)) / gap (standard bound)."""
    gap = spectral_gap(g)
    pi_min = stationary_distribution(g).min()
    return float(np.log(1.0 / (eps * pi_min)) / max(gap, 1e-12))


def arrival_rate_estimate(g: Graph) -> float:
    """Global first-hitting rate lambda_a for a freshly forked walk.

    Hitting times to a random target from a random source concentrate
    around n for regular expanders; we use lambda_a = 1 / mean_i E[H_i]
    with E[H_i] ~ E[R_i] * (1 - pi_i) / pi_i ... approximated by 1/n
    scaled by the spectral gap correction (Tishby et al. 2022 show
    exponential tails with rate ~ pi_i for random regular graphs).
    """
    pi = stationary_distribution(g)
    return float(pi.mean())


def cover_time_estimate(g: Graph) -> float:
    """~ n log n for regular expanders; used to size the init phase."""
    n = g.n
    return float(2.0 * n * np.log(max(n, 2)))
