"""The paper's figure drivers through the port (counterpart of the
reference's ``benchmarks/`` figure scripts): Figs. 1-7 and 9, the theory
bounds and the auto-eps study, each a module with ``scenarios()`` (the
curves it runs, per graph) and ``run()`` (keyword overrides of its steps,
seeds, decisions' start and burst or attack times; ``device``, ``out``).
The command line is ``python -m repro_torch.figures.run``."""
