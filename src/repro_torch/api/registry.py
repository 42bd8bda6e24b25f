"""Named-experiment registry (counterpart of the JAX package's
``api/registry.py``): config-dict-driven studies, by name.

A registered experiment is a builder that turns plain keyword arguments
(the kind a JSON config holds) into an
:class:`~repro_torch.api.Experiment`::

    from repro_torch.api import Experiment, registry

    @registry.register("fig4-eps-grid")
    def _fig4(n=100, steps=4500, **kw):
        ...
        return Experiment(...)

    exp = Experiment.from_config({"experiment": "fig4-eps-grid", "n": 100})

The built-in ``"walks"`` builder covers a generated graph with
``ProtocolConfig`` / ``FailureConfig`` field dicts and optional named
scenario rows; ``repro_torch.zoo`` registers ``"zoo"`` on import.
Every builder here also takes the port's ``device`` and
``partitionable``.
"""
from __future__ import annotations

from typing import Callable, Dict

__all__ = ["register", "get", "names", "build"]

_REGISTRY: Dict[str, Callable] = {}


def register(name: str, builder: Callable | None = None):
    """Register ``builder`` under ``name``; usable as a decorator. The
    last registration of a name wins."""

    def _register(fn: Callable):
        if not callable(fn):
            raise TypeError(f"experiment builder for {name!r} must be callable")
        _REGISTRY[str(name)] = fn
        return fn

    return _register(builder) if builder is not None else _register


def get(name: str) -> Callable:
    """The builder registered under ``name``; subsystems that register on
    import (the zoo) are imported on a miss. KeyError lists what exists."""
    if name not in _REGISTRY:
        import importlib

        importlib.import_module("repro_torch.zoo")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown experiment {name!r}; registered experiments: {sorted(_REGISTRY)}"
        ) from None


def names() -> tuple:
    """Registered experiment names, sorted."""
    return tuple(sorted(_REGISTRY))


def build(name: str, /, **overrides):
    """Build the named experiment with keyword overrides applied."""
    from repro_torch.api.experiment import Experiment

    exp = get(name)(**overrides)
    if not isinstance(exp, Experiment):
        raise TypeError(
            f"experiment builder {name!r} returned {type(exp).__name__}, expected an Experiment"
        )
    return exp


def _scenario_rows(scenarios):
    from repro_torch.core.failures import FailureConfig
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.sweep.scenario import Scenario

    rows = []
    for i, row in enumerate(scenarios):
        row = dict(row)
        rows.append(Scenario(
            name=str(row.pop("name", f"scenario{i}")),
            pcfg=ProtocolConfig(**row.pop("protocol", {})),
            fcfg=FailureConfig(**row.pop("failures", {})),
        ))
        if row:
            raise TypeError(f"scenario row {i} has unknown keys {sorted(row)}; expected "
                            "name/protocol/failures")
    return rows


@register("walks")
def _walks(
    *,
    graph: str = "regular",
    n: int = 64,
    graph_seed: int = 0,
    graph_kwargs: dict | None = None,
    steps: int = 500,
    protocol: dict | None = None,
    failures: dict | None = None,
    scenarios=None,
    outputs="scalars",
    placement="auto",
    name: str | None = None,
    device=None,
    partitionable: bool = True,
):
    """The generic study: a generated graph running the protocol.
    ``protocol`` / ``failures`` are field dicts; ``scenarios`` rows are
    dicts of ``{"name", "protocol", "failures"}``."""
    from repro_torch.api.experiment import Experiment
    from repro_torch.core.failures import FailureConfig
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.graphs.generators import make_graph

    g = make_graph(graph, int(n), int(graph_seed), **(graph_kwargs or {}))
    pcfg = fcfg = None
    if protocol is not None or not scenarios:
        pcfg = ProtocolConfig(**(protocol or {}))
        fcfg = FailureConfig(**(failures or {}))
    elif failures is not None:
        raise TypeError("failures= given without protocol=")
    return Experiment(
        graph=g, protocol=pcfg, failures=fcfg, steps=int(steps),
        scenarios=_scenario_rows(scenarios) if scenarios else None,
        outputs=outputs, placement=placement, name=name, device=device,
        partitionable=partitionable,
    )
