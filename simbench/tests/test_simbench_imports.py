"""No module a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro`` (compared whole, so ``repro_torch`` passes), and
the reference loads nothing of the program."""
import json
import subprocess
import sys
import types

from simbench import harness
from simbench.tests.conftest import CHECKOUT

ENV_PATH = f"{CHECKOUT}:{CHECKOUT / 'src'}"


def _top_levels(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, timeout=600,
        env={"PYTHONPATH": ENV_PATH, "PATH": "/usr/bin:/bin"}, cwd=str(CHECKOUT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    tops = _top_levels("import simbench.reference.simulate, simbench.reference.compare")
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, tops


def test_a_run_loads_no_jax():
    tops = _top_levels(
        "import torch; torch.set_num_threads(2)\n"
        "from simbench import harness\nfrom simbench.tests import tiny\n"
        "rec = harness.run_cell(tiny.paper(40), 5, 0.0, False, 'cpu', 0.0, log=lambda m: None)\n"
        "assert not rec['forbidden'], rec['forbidden']")
    assert "repro_torch" in tops
    assert not tops & set(harness.FORBIDDEN), tops


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", types.ModuleType("repro_torch_fake"))
    assert "repro_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("repro.fake"))
    assert "repro.fake" in harness.forbidden_modules()
