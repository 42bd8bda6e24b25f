"""Scenario descriptions for batched sweeps (counterpart of the JAX
package's ``sweep/scenario.py``).

A *scenario* is one (ProtocolConfig, FailureConfig) pair: one curve of a
paper figure. Scenarios whose configs share static structure (algorithm,
estimator, slot capacity, histogram resolution, fork_prob presence, the
failure config's static fields) run as one batch: every trajectory of
the batch is a row of the same state tensors, and its numeric fields are
its own row of ``protocol_rows`` / ``failure_rows``. Schedules of
different lengths are padded to the widest (``pad_bursts``).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

from repro_torch.core.failures import FailureConfig, pad_bursts
from repro_torch.core.protocol import ProtocolConfig


class Scenario(NamedTuple):
    """A named (protocol, failure) regime: one curve of a figure."""

    name: str
    pcfg: ProtocolConfig
    fcfg: FailureConfig


def as_pair(scenario) -> Tuple[ProtocolConfig, FailureConfig]:
    """Accept a Scenario, a (pcfg, fcfg) tuple, or any .pcfg/.fcfg object."""
    if hasattr(scenario, "pcfg"):
        return scenario.pcfg, scenario.fcfg
    pcfg, fcfg = scenario
    return pcfg, fcfg


def static_signature(scenario) -> tuple:
    """Hashable program-shape key: the protocol's static fields, whether
    ``fork_prob`` is None, the failure config's static fields and, last,
    the schedule lengths (bursts, node crashes, extra Pac-Man ids, edge
    cuts), which :func:`group_key` strips because padding reconciles
    them."""
    pcfg, fcfg = as_pair(scenario)
    return (
        pcfg.static_fields,
        pcfg.fork_prob is None,
        fcfg.static_fields,
        (fcfg.n_bursts, fcfg.n_node_crashes, fcfg.n_pacman, fcfg.n_edge_cuts),
    )


def group_key(scenario) -> tuple:
    """The batching key: :func:`static_signature` without the schedule
    lengths. Scenarios with equal group keys run as one batch."""
    return static_signature(scenario)[:-1]


def group_scenarios(scenarios: Sequence) -> list:
    """Partition into batchable groups: ``[(group key, [indices])]``, in
    order of first appearance."""
    groups: dict = {}
    for i, s in enumerate(scenarios):
        groups.setdefault(group_key(s), []).append(i)
    return list(groups.items())


def stack_configs(scenarios: Sequence):
    """The per-row configs of one group: ``(pcfgs, fcfgs)`` lists, the
    failure schedules padded to the widest scenario. Raises ValueError
    when the scenarios cannot share one batch."""
    if not scenarios:
        raise ValueError("need at least one scenario")
    pairs = [as_pair(s) for s in scenarios]
    sigs = {group_key(p) for p in pairs}
    if len(sigs) > 1:
        raise ValueError(
            "scenarios mix static structures (algorithm / estimator_impl / "
            "max_walks / rt_bins / fork_prob presence); group them with "
            f"repro_torch.sweep.group_scenarios first: {sorted(map(str, sigs))}"
        )
    pcfgs = [p for p, _ in pairs]
    for p in pcfgs:
        if p.max_walks < p.z0:
            raise ValueError("max_walks must be >= z0 in every scenario")
    return pcfgs, pad_bursts([f for _, f in pairs])
