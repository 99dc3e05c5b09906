"""The training step on the launcher's host mesh, against the JAX
package's.

The JAX launcher (``launch/train.py``) trains on ``make_host_mesh()``, a
(1, 1) mesh with a ``model`` axis, and installs it in the sharding rules,
so its MoE takes ``_apply_moe_shard_map`` and a config with
``ssm_seq_parallel`` (mamba2-130m) takes ``ssm_train_seq_parallel``, each
with one shard.  The port's launcher does the same with
``make_host_mesh(devices=[the run's device])``.  For the mixtral,
deepseek-v2 and mamba2 smoke presets (fp32, the JAX weights through
``params_from_numpy``, stacked layout, 2 x 64 tokens), the port's
``make_train_step(model, mesh)`` is held to the JAX package's
``make_train_step(model, make_host_mesh())``: the loss and grad norm of
one step, and the loss and every gradient leaf of the step's
``value_and_grad`` under the rules the step installs, within
1e-4 |jax| + 2e-5 max|jax leaf| (``test_torch_train.py``'s tolerance).
The port's step is checked to take the mesh branches.  The JAX side runs
in a subprocess on one host device, so its mesh is (1, 1) whatever the
test process holds; it builds that mesh with Auto axis types, the default
of the JAX versions the package was written for (on this JAX's Explicit
default the JAX launcher's step raises a sharding type error for these
three presets).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.core.buffers import tree_flatten
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw_init

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
ARCHS = ("mixtral-8x22b", "deepseek-v2-236b", "mamba2-130m")
BATCH, SEQ = 2, 64


def _tokens(cfg):
    rng = np.random.default_rng(5)
    return rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)


def _jax_main(out_path):
    """Subprocess entry (one host device): the JAX launcher's step on
    ``make_host_mesh()`` for every preset."""
    import jax.numpy as jnp
    from repro.launch import shardings as JSH
    from repro.launch import steps as JST
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.models.sharding import sharding_rules
    from repro.optim import adamw_init as jadamw
    shape = jmesh().devices.shape
    # make_host_mesh()'s mesh with Auto axes: this JAX makes Explicit ones
    # by default, and the launcher's step then fails to type the sharded
    # contraction after its shard_map (the JAX package targets the older
    # default, Auto)
    auto = jax.sharding.AxisType.Auto
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(auto, auto))
    out = {"mesh": np.asarray(mesh.devices.shape)}
    for arch in ARCHS:
        cfg = jax_config(arch).smoke()
        model = jax_build(cfg)
        sp = model.stack_params(model.init(jax.random.PRNGKey(0)))
        batch = {"tokens": jnp.asarray(_tokens(cfg))}
        rules = {**JSH.activation_rules(cfg, mesh), "__mesh__": mesh}
        # as the launcher runs it: no ambient mesh, the rules inside the step
        with sharding_rules(**rules):
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p: model.loss_stacked(p, batch), has_aux=True))(sp)
        step = jax.jit(JST.make_train_step(model, mesh))
        _, _, metrics = step(sp, jadamw(sp), batch)
        out[f"{arch}:loss"] = np.asarray(loss)
        out[f"{arch}:step_loss"] = np.asarray(metrics["loss"])
        out[f"{arch}:grad_norm"] = np.asarray(metrics["grad_norm"])
        for i, g in enumerate(jax.tree_util.tree_leaves(grads)):
            out[f"{arch}:g{i}"] = np.asarray(g)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trainmesh") / "ref.npz")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src") + os.pathsep + HERE
    code = f"import test_torch_train_mesh as t; t._jax_main({path!r})"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=HERE)
    assert out.returncode == 0, out.stderr[-4000:]
    ref = dict(np.load(path))
    assert tuple(ref["mesh"]) == (1, 1)
    return ref


@pytest.mark.parametrize("arch", ARCHS)
def test_host_mesh_train_step_matches_the_jax_launchers(arch, jax_ref):
    cfg = get_config(arch).smoke()
    jm = jax_build(jax_config(arch).smoke())
    jp = jm.init(jax.random.PRNGKey(0))
    model = build_model(cfg)
    sp = model.stack_params(tt.params_from_numpy(jax.device_get(jp), cfg,
                                                 "cpu"))
    batch = {"tokens": torch.as_tensor(_tokens(cfg))}
    mesh = make_host_mesh(devices=["cpu"])
    taken = []
    orig_moe, orig_ssm = MOE._apply_moe_shard_map, SSM._ssm_prefill_seq_parallel

    def spy_moe(*a, **k):
        taken.append("moe")
        return orig_moe(*a, **k)

    def spy_ssm(*a, **k):
        taken.append("ssm")
        return orig_ssm(*a, **k)
    MOE._apply_moe_shard_map, SSM._ssm_prefill_seq_parallel = spy_moe, spy_ssm
    try:
        with ST.step_rules(cfg, mesh):
            (loss, _), grads = ST.value_and_grad(ST.train_loss_fn(model),
                                                 sp, batch)
        step = ST.make_train_step(model, mesh)
        _, _, metrics = step({k: v for k, v in sp.items()},
                             adamw_init(sp), batch)
    finally:
        MOE._apply_moe_shard_map, SSM._ssm_prefill_seq_parallel = orig_moe, orig_ssm
    assert taken and set(taken) == ({"ssm"} if cfg.ssm_state else {"moe"})
    np.testing.assert_allclose(float(loss), float(jax_ref[f"{arch}:loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jax_ref[f"{arch}:step_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jax_ref[f"{arch}:grad_norm"]),
                               rtol=1e-4)
    leaves = tree_flatten(grads)[0]
    n = sum(1 for k in jax_ref
            if k.startswith(f"{arch}:g") and k[len(arch) + 2:].isdigit())
    assert len(leaves) == n > 0
    for i, b in enumerate(leaves):
        a = jax_ref[f"{arch}:g{i}"]
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        np.testing.assert_allclose(
            b.numpy(), a, rtol=1e-4, atol=2e-5 * np.abs(a).max(),
            err_msg=f"{arch} gradient leaf {i}")
