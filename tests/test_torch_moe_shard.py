"""The port's expert-parallel MoE (``models/moe.py``'s
``_apply_moe_shard_map``) on meshes of ``cpu`` slots, against the JAX
package's ``shard_map`` path on its own (2, 4) mesh of forged host devices
(a subprocess, as ``tests/test_distributed.py`` runs it).

* ``y`` within 2e-4 (that test's tolerance) at 4 and 8 experts: both
  divide the 4-way model axis, so expert parallelism; with
  ``moe_force_tp`` the intra-expert TP split of f; with a capacity that
  drops choices; with ``moe_psum_bf16`` (bf16 partials) at the bf16
  tolerance; with shared experts, in f32 and in bf16 (the mesh path adds
  them after the cast to bf16, the dense path before it, in both
  packages).
* ``aux`` (the mean over the data slots of each slot's Switch loss) within
  f32 rounding of the JAX package's shard_map ``aux``, not only within the
  dense path's rtol 0.2.
* Against the port's single-device path: in f32 with expert parallelism and
  no drops, the answer is bitwise (each token's partials meet in ascending
  expert order, as the dense combine adds them); ``per_row=True`` (the
  serve path) ignores the mesh.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig, reference_fields
from repro_torch.models.sharding import sharding_rules

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))


def _cfg(name):
    e = {"e4": 4, "e8": 8, "tp8": 8, "cap": 8, "psum_bf16": 8,
         "shared": 4, "shared_bf16": 4}[name]
    kw = dict(name="t", arch_type="moe", n_layers=1, d_model=32, n_heads=2,
              n_kv_heads=2, d_ff=64, vocab=64, n_experts=e, top_k=2,
              d_ff_expert=32, dtype="float32", capacity_factor=float(e))
    if name == "tp8":
        kw["moe_force_tp"] = True
    if name == "cap":
        kw["capacity_factor"] = 0.5
    if name == "psum_bf16":
        kw.update(dtype="bfloat16", moe_psum_bf16=True)
    if name in ("shared", "shared_bf16"):
        kw["n_shared_experts"] = 2
    if name == "shared_bf16":
        kw["dtype"] = "bfloat16"
    return ModelConfig(**kw)


CASES = ("e4", "e8", "tp8", "cap", "psum_bf16", "shared", "shared_bf16")


def _x(cfg):
    rng = np.random.default_rng(11)
    return rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)


def _jax_main(out_path):
    """Subprocess entry (8 forged devices): ``_apply_moe_shard_map`` and
    the dense path of every case."""
    import jax
    import jax.numpy as jnp
    from repro.launch.mesh import set_mesh
    from repro.models import ModelConfig as JCfg
    from repro.models import moe as JMOE
    from repro.models.sharding import sharding_rules as jrules
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    out = {}
    for name in CASES:
        c = _cfg(name)
        cfg = JCfg(**reference_fields(c))
        p = JMOE.moe_init(jax.random.PRNGKey(0), cfg)
        for path, v in jax.tree_util.tree_flatten_with_path(p)[0]:
            key = "/".join(str(q.key) for q in path)
            out[f"{name}:p:{key}"] = np.asarray(v.astype(jnp.float32))
        x = jnp.asarray(_x(c)).astype(cfg.dtype)
        with set_mesh(mesh):
            with jrules(batch="data", __mesh__=mesh):
                y, aux = jax.jit(lambda p, x: JMOE._apply_moe_shard_map(
                    p, cfg, x, mesh))(p, x)
        out[f"{name}:y"] = np.asarray(y.astype(jnp.float32))
        out[f"{name}:aux"] = np.asarray(aux)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("moeshard") / "ref.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src") + os.pathsep + HERE
    code = f"import test_torch_moe_shard as t; t._jax_main({path!r})"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=HERE)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path))


def _params(ref, name, cfg):
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    p = {}
    for k, v in ref.items():
        case, kind, *rest = k.split(":")
        if case != name or kind != "p":
            continue
        node = p
        parts = rest[0].split("/")
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        # the router stays f32, as moe_init makes it
        node[parts[-1]] = torch.as_tensor(v).to(
            torch.float32 if parts[-1] == "router" else dt)
    return p


def _mesh_moe(p, cfg, x, mesh):
    with sharding_rules(batch="data", __mesh__=mesh):
        return MOE.apply_moe(p, cfg, x)


@pytest.mark.parametrize("name", CASES)
def test_shard_map_moe_matches_jax(name, jax_ref):
    cfg = _cfg(name)
    p = _params(jax_ref, name, cfg)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    x = torch.as_tensor(_x(cfg)).to(dt)
    y, aux = _mesh_moe(p, cfg, x, make_host_mesh(4, devices=["cpu"] * 8))
    assert y.dtype == dt and y.shape == x.shape
    want = jax_ref[f"{name}:y"]
    tol = 2e-2 if dt == torch.bfloat16 else 2e-4
    np.testing.assert_allclose(y.float().numpy(), want, rtol=tol, atol=tol)
    # aux: the same per-slot Switch losses and the same mean, f32 rounding
    np.testing.assert_allclose(float(aux), float(jax_ref[f"{name}:aux"]),
                               rtol=2e-6, atol=0)


@pytest.mark.parametrize("name", ["e4", "e8"])
def test_expert_parallel_f32_is_bitwise_the_dense_path(name, jax_ref):
    cfg = _cfg(name)
    p = _params(jax_ref, name, cfg)
    x = torch.as_tensor(_x(cfg))
    y0, aux0 = MOE.apply_moe(p, cfg, x)
    for model in (1, 2, 4):
        mesh = make_host_mesh(model, devices=["cpu"] * model)   # data 1
        y, aux = _mesh_moe(p, cfg, x, mesh)
        assert torch.equal(y, y0), model
        assert torch.equal(aux, aux0), model


def test_intra_expert_tp_is_close_to_the_dense_path(jax_ref):
    cfg = _cfg("tp8")
    p = _params(jax_ref, "tp8", cfg)
    x = torch.as_tensor(_x(cfg))
    y0, _ = MOE.apply_moe(p, cfg, x)
    y, _ = _mesh_moe(p, cfg, x, make_host_mesh(4, devices=["cpu"] * 4))
    torch.testing.assert_close(y, y0, rtol=2e-5, atol=2e-5)
    assert MOE._moe_specs(cfg, make_host_mesh(4, devices=["cpu"] * 4),
                          4)[0] is False


def test_the_serve_path_ignores_the_mesh(jax_ref):
    cfg = _cfg("cap")
    p = _params(jax_ref, "cap", cfg)
    x = torch.as_tensor(_x(cfg))
    y0, aux0 = MOE.apply_moe(p, cfg, x, per_row=True)
    with sharding_rules(__mesh__=make_host_mesh(4, devices=["cpu"] * 8)):
        y, aux = MOE.apply_moe(p, cfg, x, per_row=True)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


def test_gradients_flow_through_the_mesh_path(jax_ref):
    cfg = _cfg("e8")
    p = _params(jax_ref, "e8", cfg)
    x = torch.as_tensor(_x(cfg))
    mesh = make_host_mesh(4, devices=["cpu"] * 8)

    def grads(fn):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y, aux = fn(leaves)
        ((y ** 2).sum() + aux).backward()
        return {k: v.grad for k, v in leaves.items()}
    g0 = grads(lambda pp: MOE.apply_moe(pp, cfg, x[:2]))
    g1 = grads(lambda pp: _mesh_moe(pp, cfg, x[:2],
                                    make_host_mesh(4, devices=["cpu"] * 4)))
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-6)
    g2 = grads(lambda pp: _mesh_moe(pp, cfg, x, mesh))
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0
               for g in g2.values())
