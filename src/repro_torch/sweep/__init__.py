"""Scenario descriptions and grouping for sweeps; the runner is
``repro_torch.api.Experiment(scenarios=...).sweep(seeds=...)``::

    scenarios = [
        Scenario(f"eps={e}", ProtocolConfig(eps=e), FailureConfig(...))
        for e in (1.8, 2.0, 2.25, 2.5)
    ]
    result = Experiment(graph=graph, scenarios=scenarios,
                        steps=4500).sweep(seeds=8)
    z = result["eps=2.0"].z  # (seeds, steps)
"""
from repro_torch.sweep.scenario import (
    Scenario,
    as_pair,
    group_key,
    group_scenarios,
    stack_configs,
    static_signature,
)

__all__ = [
    "Scenario",
    "as_pair",
    "group_key",
    "group_scenarios",
    "stack_configs",
    "static_signature",
]
