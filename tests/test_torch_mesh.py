"""The port's meshes, its single-controller collectives and its sharding
rules (``launch/mesh.py``, ``launch/spmd.py``, ``launch/shardings.py``,
``models/sharding.py``), on the CPU.

* ``Mesh``, ``make_host_mesh`` and the helpers on meshes of ``cpu`` slots;
  ``mesh_fingerprint`` tells 4 slots from 8 and equal meshes apart from
  neither; ``make_production_mesh`` raises with the count of visible
  devices.
* ``split``/``gather`` round-trip by spec; ``psum`` adds in slot order,
  ``pmean``, ``ppermute`` (zeros where no pair reaches), ``axis_index``.
* ``replicated`` holds one copy per distinct device, not one per slot.
* The spec trees of ``param_shardings``, ``stacked_param_shardings`` and
  ``cache_shardings`` (list and stacked caches, with and without
  ``shard_kv_seq``), ``batch_shardings`` and ``activation_rules`` equal the
  JAX package's, leaf for leaf, for all ten ``configs/`` at full size on
  meshes with a model axis of 1, 4 and 16.  The JAX trees come from a
  subprocess with 32 forged host devices (its ``NamedSharding`` needs a
  real mesh); the port's parameter and cache trees are built under
  ``FakeTensorMode`` (shapes without memory).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import shardings as SH
from repro_torch.launch import spmd
from repro_torch.launch.mesh import (Mesh, P, batch_spec, current_mesh,
                                     data_axes, data_axis_size,
                                     make_host_mesh, make_production_mesh,
                                     mesh_axis_sizes, mesh_fingerprint,
                                     set_mesh)
from repro_torch.models import build_model
from repro_torch.models.sharding import (current_rules, logical_spec, shard,
                                         sharding_rules)

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL_SIZES = (1, 4, 16)
CACHE_BATCH, CACHE_SEQ = 8, 64


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_host_mesh_of_cpu_slots():
    mesh = make_host_mesh(devices=["cpu"] * 8)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 8, "model": 1}
    assert mesh.size == 8
    assert mesh_axis_sizes(mesh) == {"data": 8, "model": 1}
    assert data_axes(mesh) == ("data",)
    assert data_axis_size(mesh) == 8
    assert batch_spec(mesh) == "data"
    assert mesh.distinct_devices() == (torch.device("cpu"),)
    m24 = make_host_mesh(4, devices=["cpu"] * 8)
    assert m24.shape == {"data": 2, "model": 4}
    assert data_axis_size(m24) == 2
    with pytest.raises(ValueError, match="model axis"):
        make_host_mesh(3, devices=["cpu"] * 8)


def test_pod_axes_carry_the_batch():
    mesh = Mesh(np.array([torch.device("cpu")] * 8,
                         dtype=object).reshape(2, 2, 2),
                ("pod", "data", "model"))
    assert data_axes(mesh) == ("pod", "data")
    assert data_axis_size(mesh) == 4
    assert batch_spec(mesh) == ("pod", "data")
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array([torch.device("cpu")] * 4, dtype=object), ("a", "b"))


def test_fingerprint():
    a = make_host_mesh(devices=["cpu"] * 8)
    b = make_host_mesh(devices=["cpu"] * 8)
    c = make_host_mesh(devices=["cpu"] * 4)
    d = make_host_mesh(2, devices=["cpu"] * 8)
    assert mesh_fingerprint(None) is None
    assert mesh_fingerprint(a) == mesh_fingerprint(b)
    assert mesh_fingerprint(a) != mesh_fingerprint(c)
    assert mesh_fingerprint(a) != mesh_fingerprint(d)
    assert mesh_fingerprint(a) == (("data", "model"), (8, 1),
                                   (("cpu", None),) * 8)
    hash(mesh_fingerprint(a))


def test_production_mesh_needs_its_devices():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"needs 256 CUDA devices; {n} "):
        make_production_mesh()
    with pytest.raises(ValueError, match=f"needs 512 CUDA devices; {n} "):
        make_production_mesh(multi_pod=True)


def test_set_mesh_is_ambient():
    mesh = make_host_mesh(devices=["cpu"] * 2)
    assert current_mesh() is None
    with set_mesh(mesh):
        assert current_mesh() is mesh
    assert current_mesh() is None


# ---------------------------------------------------------------------------
# the single-controller collectives
# ---------------------------------------------------------------------------

def test_split_and_gather_round_trip():
    mesh = make_host_mesh(4, devices=["cpu"] * 8)      # (data 2, model 4)
    x = torch.arange(8 * 8 * 3, dtype=torch.float32).reshape(8, 8, 3)
    for spec, part in ((P("data", "model", None), (4, 2, 3)),
                       (P("data", None, None), (4, 8, 3)),
                       (P(None, "model"), (8, 2, 3)),
                       (P(("data", "model")), (1, 8, 3)),
                       (P(), (8, 8, 3))):
        parts = spmd.split(x, mesh, spec)
        assert parts.shape == (2, 4)
        assert all(tuple(p.shape) == part for p in parts.flat)
        assert torch.equal(spmd.gather(parts, mesh, spec), x)
    parts = spmd.split(x, mesh, P("data", "model", None))
    assert torch.equal(parts[1, 2], x[4:8, 4:6])
    assert torch.equal(spmd.split(x, mesh, P(("data", "model")))[1, 2],
                       x[6:7])
    # a part on its slot's device is a view, not a copy
    assert parts[0, 0].data_ptr() == x.data_ptr()
    with pytest.raises(ValueError, match="tile"):
        spmd.split(torch.zeros(3, 8), mesh, P("data", None))


def test_psum_adds_in_slot_order_and_pmean():
    mesh = make_host_mesh(4, devices=["cpu"] * 8)
    parts = np.empty((2, 4), dtype=object)
    for i in range(2):
        for j in range(4):
            parts[i, j] = torch.tensor([1e8 if j == 0 else 1.0, i * 10.0 + j])
    out = spmd.psum(parts, mesh, "model")
    want0 = ((parts[0, 0] + parts[0, 1]) + parts[0, 2]) + parts[0, 3]
    for j in range(4):
        assert torch.equal(out[0, j], want0)
    assert out[1, 0][1].item() == 10 + 11 + 12 + 13
    both = spmd.psum(parts, mesh, ("data", "model"))
    assert all(torch.equal(both[0, 0], b) for b in both.flat)
    mean = spmd.pmean(parts, mesh, "data")
    assert torch.equal(mean[0, 1], (parts[0, 1] + parts[1, 1]) / 2)
    trees = np.empty((2, 4), dtype=object)
    for idx in np.ndindex(2, 4):
        trees[idx] = {"a": torch.ones(2), "b": [torch.full((1,), 2.0)]}
    t = spmd.psum(trees, mesh, "model")[1, 3]
    assert torch.equal(t["a"], torch.full((2,), 4.0))
    assert torch.equal(t["b"][0], torch.full((1,), 8.0))


def test_ppermute_and_axis_index():
    mesh = make_host_mesh(4, devices=["cpu"] * 8)
    pos = spmd.axis_index(mesh, "model")
    assert [pos[0, j] for j in range(4)] == [0, 1, 2, 3]
    assert [spmd.axis_index(mesh, "data")[i, 0] for i in range(2)] == [0, 1]
    parts = np.empty((2, 4), dtype=object)
    for idx in np.ndindex(2, 4):
        parts[idx] = torch.full((2,), float(10 * idx[0] + idx[1]))
    out = spmd.ppermute(parts, mesh, "model", [(i, i + 1) for i in range(3)])
    for i in range(2):
        assert torch.equal(out[i, 0], torch.zeros(2))
        for j in range(1, 4):
            assert torch.equal(out[i, j], parts[i, j - 1])
    ring = spmd.ppermute(parts, mesh, "data", [(0, 1), (1, 0)])
    assert torch.equal(ring[0, 2], parts[1, 2])


def test_slot_map_runs_every_slot_in_order():
    mesh = make_host_mesh(2, devices=["cpu"] * 4)
    seen = []
    a, b = spmd.slot_map(lambda p: (seen.append(p) or p, -p), mesh,
                         spmd.axis_index(mesh, "model"), n_out=2)
    assert seen == [0, 1, 0, 1]
    assert b[1, 1] == -1 and a.shape == (2, 2)


def test_replicated_holds_one_copy_per_distinct_device():
    params = {"w": torch.randn(64, 64), "b": [torch.randn(64)]}
    mesh = make_host_mesh(devices=["cpu"] * 8)
    rep = SH.replicated(mesh, params)
    assert list(rep.by_device) == [torch.device("cpu")]
    assert rep.on(torch.device("cpu"))["w"] is params["w"]
    assert rep.nbytes() == 0
    mesh4 = make_host_mesh(2, devices=["cpu"] * 4)
    assert SH.replicated(mesh4, params).on(torch.device("cpu"))["b"][0] \
        is params["b"][0]


def test_logical_rules():
    mesh = make_host_mesh(devices=["cpu"] * 2)
    x = torch.zeros(2, 3)
    assert current_rules() == {}
    assert shard(x, "batch") is x            # no rules: a no-op
    with sharding_rules(batch="data", heads=None, __mesh__=mesh):
        assert current_rules()["__mesh__"] is mesh
        assert logical_spec("batch", None, "heads") == P("data", None, None)
        assert shard(x, "batch", None) is x
        with pytest.raises(ValueError, match="got 1 names"):
            shard(x, "batch")
    assert current_rules() == {}


# ---------------------------------------------------------------------------
# spec trees vs the JAX package
# ---------------------------------------------------------------------------

def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat_specs(tree, prefix=""):
    """{path: spec as JSON} over a tree of shardings (dicts, lists,
    tuples)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_specs(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "spec"):
        for i, v in enumerate(tree):
            out.update(_flat_specs(v, f"{prefix}/{i}"))
    else:
        out[prefix] = _spec_json(tuple(tree.spec))
    return out


def _jax_specs_main():
    """Subprocess entry (32 forged host devices): the JAX package's spec
    trees for every config and model size, as JSON."""
    import jax
    from repro.configs import get_config as jcfg
    from repro.launch import shardings as JSH
    from repro.launch import steps as JST
    from repro.models.model import build_model as jbuild
    out = {}
    for arch in ARCH_IDS:
        cfg = jcfg(arch)
        model = jbuild(cfg)
        st = model.supports_stacked
        shapes = {"params": JST.eval_params_shape(model, False),
                  "cache": JST.eval_cache_shape(model, CACHE_BATCH,
                                                CACHE_SEQ, False)}
        if st:
            shapes["stacked"] = JST.eval_params_shape(model, True)
            shapes["cache_stacked"] = JST.eval_cache_shape(
                model, CACHE_BATCH, CACHE_SEQ, True)
        batch = {"tokens": jax.ShapeDtypeStruct((CACHE_BATCH, 32), "int32"),
                 "odd": jax.ShapeDtypeStruct((3, 4), "float32")}
        for m in MODEL_SIZES:
            mesh = jax.make_mesh((32 // m, m), ("data", "model"))
            key = f"{arch}@{m}"
            row = {"params": JSH.param_shardings(cfg, mesh,
                                                 shapes["params"]),
                   "cache": JSH.cache_shardings(cfg, mesh, shapes["cache"]),
                   "cache_kv_seq": JSH.cache_shardings(
                       cfg, mesh, shapes["cache"], shard_kv_seq=True),
                   "batch": JSH.batch_shardings(cfg, mesh, batch)}
            if st:
                row["stacked"] = JSH.stacked_param_shardings(
                    cfg, mesh, shapes["stacked"])
                row["cache_stacked"] = JSH.cache_shardings(
                    cfg, mesh, shapes["cache_stacked"])
            out[key] = {k: {p: s for p, s in _flat_jax(v).items()}
                        for k, v in row.items()}
            rules = JSH.activation_rules(cfg, mesh)
            out[key]["rules"] = {k: (list(v) if isinstance(v, tuple) else v)
                                 for k, v in rules.items()}
    print("JSON" + json.dumps(out))


def _flat_jax(tree):
    import jax
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, leaf in flat:
        parts = [str(p.key) if hasattr(p, "key") else str(p.idx)
                 for p in path]
        out["/" + "/".join(parts)] = _spec_json(tuple(leaf.spec))
    return out


@pytest.fixture(scope="module")
def jax_specs():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=32"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src") + os.pathsep + HERE
    code = "import test_torch_mesh as t; t._jax_specs_main()"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=HERE)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("JSON")][-1]
    return json.loads(line[4:])


def _fake_trees(arch):
    """The port's parameter and cache trees of a full config, shapes only."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.device import make_generator
    model = build_model(get_config(arch))
    with FakeTensorMode():
        g = make_generator(0, torch.device("cpu"))
        params = model.init(g, "cpu")
        trees = {"params": params,
                 "cache": model.init_cache(CACHE_BATCH, CACHE_SEQ,
                                           device="cpu")}
        if model.supports_stacked:
            trees["stacked"] = model.stack_params(params)
            trees["cache_stacked"] = model.init_cache_stacked(
                CACHE_BATCH, CACHE_SEQ, device="cpu")
    return trees


class _Shape:
    def __init__(self, *shape):
        self.shape = shape


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_are_the_references(arch, jax_specs):
    cfg = get_config(arch)
    trees = _fake_trees(arch)
    batch = {"tokens": _Shape(CACHE_BATCH, 32), "odd": _Shape(3, 4)}
    for m in MODEL_SIZES:
        mesh = make_host_mesh(m, devices=["cpu"] * 32)
        want = jax_specs[f"{arch}@{m}"]
        got = {"params": SH.param_shardings(cfg, mesh, trees["params"]),
               "cache": SH.cache_shardings(cfg, mesh, trees["cache"]),
               "cache_kv_seq": SH.cache_shardings(cfg, mesh, trees["cache"],
                                                  shard_kv_seq=True),
               "batch": SH.batch_shardings(cfg, mesh, batch)}
        if "stacked" in trees:
            got["stacked"] = SH.stacked_param_shardings(cfg, mesh,
                                                        trees["stacked"])
            got["cache_stacked"] = SH.cache_shardings(cfg, mesh,
                                                      trees["cache_stacked"])
        assert sorted(got) == sorted(k for k in want if k != "rules")
        for kind, tree in got.items():
            flat = _flat_specs(tree)
            assert flat == want[kind], (arch, m, kind)
        rules = SH.activation_rules(cfg, mesh)
        assert {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in rules.items()} == want["rules"], (arch, m)
        # the spec of every parameter is the one its path asks for
        leaf = next(iter(_flat_specs(got["params"]).values()))
        assert isinstance(leaf, list)
