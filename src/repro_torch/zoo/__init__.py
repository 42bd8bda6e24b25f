"""The adversary and walk-variant zoo (counterpart of the JAX package's
``zoo``).

Attacks (``repro_torch.zoo.attacks``) and walk-variant defenses
(``repro_torch.zoo.variants``) are registry-named builders over the
ordinary configs, so the defense x attack cross-product is a list of
:class:`~repro_torch.sweep.scenario.Scenario` rows; a sweep runs it as
one batch per static group (walk variant, ``pacman_mobile``), every
numeric knob a row of that batch::

    from repro_torch.zoo import zoo_scenarios
    rows = zoo_scenarios(
        defenses=["uniform", "jump", "bloom"],
        attacks=[("mobile_pacman", {"node": 0}),
                 ("edge_cut", {"time": 50, "threshold": 32})],
    )
    Experiment(graph=g, scenarios=rows, steps=500).sweep(seeds=8)

The registered ``"zoo"`` experiment packages the common study, a
community graph under a defense x attack grid, for config-driven callers
(``Experiment.from_config({"experiment": "zoo"})``, Fig. 9's driver).
"""
from __future__ import annotations

import dataclasses

from repro_torch.zoo.attacks import ATTACKS, attack, register_attack
from repro_torch.zoo.variants import DEFENSES, defense, init_variant_state, move_variant

__all__ = [
    "ATTACKS",
    "DEFENSES",
    "attack",
    "defense",
    "init_variant_state",
    "move_variant",
    "register_attack",
    "zoo_scenarios",
]


def _named(entry, kind):
    """Normalize ``"name"`` | ``("name", {kwargs})`` entries."""
    if isinstance(entry, str):
        return entry, {}
    name, kwargs = entry
    if not isinstance(kwargs, dict):
        raise TypeError(f"{kind} entry {entry!r} must be 'name' or ('name', dict)")
    return name, dict(kwargs)


def zoo_scenarios(defenses, attacks, base_protocol=None):
    """The defense x attack cross-product as named Scenario rows,
    ``"<defense>|<attack>"``, defense-major. Defense kwargs override the
    preset's ProtocolConfig fields; attack kwargs go to the builder."""
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.sweep.scenario import Scenario

    base = base_protocol if base_protocol is not None else ProtocolConfig()
    rows = []
    for d_entry in defenses:
        d_name, d_kw = _named(d_entry, "defense")
        pcfg = dataclasses.replace(base, **defense(d_name, **d_kw))
        for a_entry in attacks:
            a_name, a_kw = _named(a_entry, "attack")
            rows.append(Scenario(name=f"{d_name}|{a_name}", pcfg=pcfg,
                                 fcfg=attack(a_name, **a_kw)))
    return rows


def _register_experiment():
    from repro_torch.api import registry

    @registry.register("zoo")
    def _zoo(
        *,
        graph: str = "community",
        n: int = 64,
        graph_seed: int = 0,
        graph_kwargs: dict | None = None,
        steps: int = 500,
        protocol: dict | None = None,
        defenses=("uniform", "jump", "bloom"),
        attacks=("mobile_pacman", "multi_pacman", "edge_cut"),
        outputs="scalars",
        placement="auto",
        name: str | None = None,
        device=None,
        partitionable: bool = True,
    ):
        """The zoo study: a (default: community) graph under the defense
        x attack grid. Plain attack names get graph-aware defaults:
        ``edge_cut`` severs the id boundary ``n//2`` at ``steps//3``,
        ``multi_pacman`` posts one Pac-Man per community. ``device`` and
        ``partitionable`` are the port's Experiment fields."""
        from repro_torch.api.experiment import Experiment
        from repro_torch.core.protocol import ProtocolConfig
        from repro_torch.graphs.generators import make_graph

        g = make_graph(graph, int(n), int(graph_seed), **(graph_kwargs or {}))
        half = int(n) // 2
        auto_kw = {
            "edge_cut": {"time": int(steps) // 3, "threshold": half},
            "multi_pacman": {"nodes": (0, half)},
            "mobile_pacman": {"node": 0},
            "pacman": {"node": 0},
        }
        rows = [(a, auto_kw.get(a, {})) if isinstance(a, str) else a for a in attacks]
        return Experiment(
            graph=g,
            scenarios=zoo_scenarios(defenses, rows,
                                    base_protocol=ProtocolConfig(**(protocol or {}))),
            steps=int(steps), outputs=outputs, placement=placement, name=name,
            device=device, partitionable=partitionable,
        )


_register_experiment()
