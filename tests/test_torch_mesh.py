"""The port's device meshes (``repro_torch.launch.mesh``) against the
JAX package's ``launch/mesh.py``.

The production meshes have 256 and 512 ranks, so they are built under
torch's fake process group (one process standing for every rank) in a
subprocess: the group is process-wide state. The reference's mesh
constructors are called with its ``make_mesh`` replaced by a recorder
(no 256 devices here), and its axis helpers read what they record."""
import json
import os
import subprocess
import sys
import types

import pytest

pytest.importorskip("torch")

import repro.launch.mesh as ref_mesh  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")

PROBE = r"""
import json
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.core.distributed import make_sharded_step, shard_index
from repro_torch.core.protocol import ProtocolConfig
from repro_torch.launch import mesh as M

def describe(m):
    return dict(shape=list(m.mesh.shape), names=list(m.mesh_dim_names),
                sizes=M.axis_sizes(m), data_axes=list(M.data_axes(m)),
                data_axis_size=M.data_axis_size(m), model_axis_size=M.model_axis_size(m))

out = {}
try:
    M.make_local_mesh(device_type="cpu")
except RuntimeError as e:
    out["no_group"] = str(e)
pcfg = ProtocolConfig(algorithm="decafork+", z0=16, max_walks=64, eps=4.0, eps2=11.0, rt_bins=512)
for world, multi in ((256, False), (512, True)):
    name = "multi" if multi else "single"
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    m = M.make_production_mesh(multi_pod=multi, device_type="cpu")
    out[name] = describe(m)
    try:
        M.make_production_mesh(multi_pod=not multi, device_type="cpu")
    except ValueError as e:
        out[name + "_mismatch"] = str(e)
    out[name + "_local"] = describe(M.make_local_mesh(model_axis=16, device_type="cpu"))
    # the reference's production protocol step (launch/dryrun.py::build_protocol)
    axes = M.data_axes(m)
    make_sharded_step(m, axes, 131072, pcfg)
    out[name + "_shard"] = list(shard_index(m, axes))
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", PROBE], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _reference(multi_pod):
    """The shape and axes the reference's production mesh asks for, as a
    stand-in mesh its helpers can read."""
    seen = {}

    def record(shape, axes, axis_types=None):
        seen.update(shape=list(shape), names=list(axes))
        return types.SimpleNamespace(axis_names=tuple(axes), shape=dict(zip(axes, shape)))

    orig = ref_mesh.make_mesh
    ref_mesh.make_mesh = record
    try:
        m = ref_mesh.make_production_mesh(multi_pod=multi_pod)
    finally:
        ref_mesh.make_mesh = orig
    return seen, m


@pytest.mark.parametrize("name", ["single", "multi"])
def test_production_mesh_matches_reference(probe, name):
    seen, _ = _reference(name == "multi")
    got = probe[name]
    assert got["shape"] == seen["shape"] and got["names"] == seen["names"]
    assert got["sizes"] == dict(zip(seen["names"], seen["shape"]))


@pytest.mark.parametrize("name", ["single", "multi"])
def test_axis_helpers_match_reference(probe, name):
    _, m = _reference(name == "multi")
    got = probe[name]
    assert tuple(got["data_axes"]) == ref_mesh.data_axes(m)
    assert got["data_axis_size"] == ref_mesh.data_axis_size(m)
    assert got["model_axis_size"] == ref_mesh.model_axis_size(m)


@pytest.mark.parametrize("name,world", [("single", 256), ("multi", 512)])
def test_local_mesh_over_the_world(probe, name, world):
    got = probe[name + "_local"]
    assert got["shape"] == [world // 16, 16] and got["names"] == ["data", "model"]
    stand_in = types.SimpleNamespace(axis_names=("data", "model"),
                                     shape={"data": world // 16, "model": 16})
    assert got["data_axis_size"] == ref_mesh.data_axis_size(stand_in) == world // 16
    assert got["model_axis_size"] == ref_mesh.model_axis_size(stand_in) == 16


def test_meshes_need_a_group_of_their_size(probe):
    assert "init_process_group" in probe["no_group"]
    assert "needs 512 ranks" in probe["single_mismatch"]
    assert "needs 256 ranks" in probe["multi_mismatch"]


def test_sharded_step_on_production_meshes(probe):
    """Rank 0's shard of the reference's production protocol step: nodes
    over ``data`` (16 shards) or ``("pod", "data")`` (32)."""
    assert probe["single_shard"] == [0, 16]
    assert probe["multi_shard"] == [0, 32]
