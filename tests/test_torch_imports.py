"""Import hygiene of the port: ``repro_torch`` (every module, the model
and serving slice included), ``chip_smoke.py`` and the card tools under
``tools/`` import neither JAX nor
the JAX package, and the port, its configs and its serving entry point
import with JAX made unimportable."""
import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    for dirpath, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    tools = os.path.join(ROOT, "tools")
    for f in sorted(os.listdir(tools)):
        if f.endswith(".py"):
            yield os.path.join(tools, f)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.api, repro_torch.convert, repro_torch.kernels\n"
        "import repro_torch.core.simulator, repro_torch.kernels.ops, repro_torch.data\n"
        "import repro_torch.models, repro_torch.launch.serve, repro_torch.configs\n"
        "import repro_torch.models.moe, repro_torch.models.transformer\n"
        "from repro_torch.models.layers import apply_mrope\n"
        "import repro_torch.sweep, repro_torch.api.results, repro_torch.api.placement\n"
        "import repro_torch.graphs.spectral, repro_torch.kernels.capture\n"
        "import repro_torch.zoo, repro_torch.zoo.attacks, repro_torch.zoo.variants\n"
        "import repro_torch.core.theory, repro_torch.core.irwin_hall, repro_torch.api.registry\n"
        "import repro_torch.figures.run, repro_torch.figures.common\n"
        "import repro_torch.checkpoint, repro_torch.utils.faults, repro_torch.api.store\n"
        "import repro_torch.core.distributed, repro_torch.launch.mesh, repro_torch.launch.sharded\n"
        "from repro_torch.core import make_sharded_step, ShardedProtocolState\n"
        "import repro_torch.configs.shapes, repro_torch.launch.train, repro_torch.launch.sharding\n"
        "import repro_torch.launch.roofline, repro_torch.launch.dryrun\n"
        "from repro_torch.api import ExperimentService, ResultStore, SubmissionFuture\n"
        "from repro_torch.api import Experiment, registry; assert 'zoo' in registry.names()\n"
        "from repro_torch.api import cache_stats; from repro_torch.api.plan import executable\n"
        "from repro_torch.configs import ARCH_IDS, get_config\n"
        "[get_config(a) for a in ARCH_IDS + ('paper_rwsgd',)]\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
