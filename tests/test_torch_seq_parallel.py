"""The port's sequence-parallel SSD (``models/ssm.py``) on meshes of
``cpu`` slots.

* Against the JAX package's ``shard_map`` path on its own (2, 4) mesh of
  forged host devices (a subprocess, as ``tests/test_distributed.py`` runs
  it): the output ``y`` and the decode cache's ``h`` and ``conv`` within
  1e-4, that test's tolerance, at one and at two chunks a slot, the batch
  split over ``data``.  (At batch 1 the JAX package's ``shard_map`` refuses
  its own out_specs on this JAX version; the port replicates the batch
  there and is held to its single-device path.)
* Against the port's own single-device path: the same values within 1e-5,
  and the gradients of a loss through it (w.r.t. every parameter and the
  input) within 1e-4 of the largest element of each; autograd runs
  through the phases and the collectives unchanged.
* On a (1, 1) mesh, the launcher's, the path runs with one slot and is
  bitwise the single-device one, forward and backward.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig, reference_fields
from repro_torch.models.sharding import sharding_rules

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = ModelConfig(name="s", arch_type="ssm", n_layers=1, d_model=64,
                  n_heads=0, n_kv_heads=0, d_ff=0, vocab=64,
                  layer_pattern="S", ssm_state=16, ssm_head_dim=16,
                  ssm_chunk=8, dtype="float32")
#: (batch, sequence): one chunk a slot, two chunks a slot
JAX_CASES = [(2, 32), (2, 64)]
#: and batch 1, which does not tile the data axis
CASES = JAX_CASES + [(1, 32)]


def _inputs(b, s):
    rng = np.random.default_rng(100 + b * 1000 + s)
    return rng.standard_normal((b, s, CFG.d_model)).astype(np.float32)


def _jax_main(out_path):
    """Subprocess entry (8 forged devices): the JAX package's
    sequence-parallel and single-device SSD on every case."""
    import jax
    import jax.numpy as jnp
    from repro.launch.mesh import set_mesh
    from repro.models import ModelConfig as JCfg
    from repro.models import ssm as JSSM
    from repro.models.sharding import sharding_rules as jrules
    cfg = JCfg(**reference_fields(CFG))
    p = JSSM.ssm_init(jax.random.PRNGKey(0), cfg)
    out = {f"p_{k}": np.asarray(v) for k, v in p.items()}
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    cfg_sp = dataclasses.replace(cfg, ssm_seq_parallel=True)
    for b, s in JAX_CASES:
        x = jnp.asarray(_inputs(b, s))
        with set_mesh(mesh):
            with jrules(batch="data", __mesh__=mesh):
                y = jax.jit(lambda p, x: JSSM.ssm_train(p, cfg_sp, x))(p, x)
                _, cache = jax.jit(
                    lambda p, x: JSSM.ssm_prefill(p, cfg_sp, x))(p, x)
        out[f"y_{b}_{s}"] = np.asarray(y)
        out[f"h_{b}_{s}"] = np.asarray(cache["h"])
        out[f"conv_{b}_{s}"] = np.asarray(cache["conv"])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("seqpar") / "ref.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src") + os.pathsep + HERE
    code = f"import test_torch_seq_parallel as t; t._jax_main({path!r})"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=HERE)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path))


def _params(ref):
    return {k[2:]: torch.as_tensor(v) for k, v in ref.items()
            if k.startswith("p_")}


def _sp(p, x, mesh, cfg=None):
    cfg = cfg or dataclasses.replace(CFG, ssm_seq_parallel=True)
    with sharding_rules(batch="data", __mesh__=mesh):
        return SSM.ssm_prefill(p, cfg, x)


@pytest.mark.parametrize("b,s", JAX_CASES)
def test_seq_parallel_matches_jax(b, s, jax_ref):
    p = _params(jax_ref)
    x = torch.as_tensor(_inputs(b, s))
    mesh = make_host_mesh(4, devices=["cpu"] * 8)
    y, cache = _sp(p, x, mesh)
    for got, key in ((y, "y"), (cache["h"], "h"), (cache["conv"], "conv")):
        np.testing.assert_allclose(got.numpy(), jax_ref[f"{key}_{b}_{s}"],
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    # ssm_train is the prefill's output under the mesh too
    with sharding_rules(batch="data", __mesh__=mesh):
        y_train = SSM.ssm_train(p, dataclasses.replace(
            CFG, ssm_seq_parallel=True), x)
    assert torch.equal(y_train, y)


@pytest.mark.parametrize("b,s", CASES)
def test_seq_parallel_matches_the_single_device_path(b, s, jax_ref):
    p = _params(jax_ref)
    x = torch.as_tensor(_inputs(b, s))
    y0, c0 = SSM.ssm_prefill(p, CFG, x)
    y, c = _sp(p, x, make_host_mesh(4, devices=["cpu"] * 8))
    assert y.shape == y0.shape and c["h"].shape == c0["h"].shape
    assert c["conv"].shape == c0["conv"].shape and c["conv"].is_contiguous()
    torch.testing.assert_close(y, y0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c["h"], c0["h"], rtol=1e-5, atol=1e-5)
    assert torch.equal(c["conv"], c0["conv"])


def _grads(p, x, w, fn):
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xg = x.clone().requires_grad_(True)
    y, cache = fn(leaves, xg)
    loss = (y * w).sum() + (cache["h"] ** 2).sum()
    loss.backward()
    return {**{k: v.grad for k, v in leaves.items()}, "x": xg.grad}


@pytest.mark.parametrize("model", [2, 4])
def test_seq_parallel_gradients_match_the_single_device_path(model, jax_ref):
    p = _params(jax_ref)
    p["A_log"] = torch.linspace(-1.0, 0.5, p["A_log"].numel())
    p["dt_bias"] = torch.linspace(-0.5, 0.5, p["dt_bias"].numel())
    x = torch.as_tensor(_inputs(2, 64))
    w = torch.as_tensor(np.random.default_rng(7).standard_normal(
        x.shape).astype(np.float32))
    mesh = make_host_mesh(model, devices=["cpu"] * 8)
    g0 = _grads(p, x, w, lambda pp, xx: SSM.ssm_prefill(pp, CFG, xx))
    g1 = _grads(p, x, w, lambda pp, xx: _sp(pp, xx, mesh))
    assert sorted(g0) == sorted(g1)
    for k in g0:
        scale = float(g0[k].abs().max())
        assert scale > 0, k
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-4,
                                   atol=1e-4 * scale, msg=k)


def test_one_slot_mesh_is_bitwise_the_single_device_path(jax_ref):
    """The launcher's (1, 1) host mesh takes the sequence-parallel path with
    one slot: bitwise the single-device result, forward and backward."""
    p = _params(jax_ref)
    x = torch.as_tensor(_inputs(2, 64))
    w = torch.as_tensor(np.random.default_rng(8).standard_normal(
        x.shape).astype(np.float32))
    mesh = make_host_mesh(devices=["cpu"])
    assert mesh.shape == {"data": 1, "model": 1}
    calls = []
    orig = SSM._ssm_prefill_seq_parallel

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    SSM._ssm_prefill_seq_parallel = spy
    try:
        y1, c1 = _sp(p, x, mesh)
        g1 = _grads(p, x, w, lambda pp, xx: _sp(pp, xx, mesh))
    finally:
        SSM._ssm_prefill_seq_parallel = orig
    assert calls == [1, 1]
    y0, c0 = SSM.ssm_prefill(p, CFG, x)
    g0 = _grads(p, x, w, lambda pp, xx: SSM.ssm_prefill(pp, CFG, xx))
    assert torch.equal(y1, y0) and torch.equal(c1["h"], c0["h"])
    assert torch.equal(c1["conv"], c0["conv"])
    for k in g0:
        assert torch.equal(g1[k], g0[k]), k


def test_a_sequence_that_does_not_tile_the_model_axis_stays_single():
    p = SSM.ssm_init(torch.Generator().manual_seed(0), CFG, "cpu")
    x = torch.as_tensor(_inputs(2, 30))
    y, c = _sp(p, x, make_host_mesh(4, devices=["cpu"] * 8))
    y0, c0 = SSM.ssm_prefill(p, CFG, x)
    assert torch.equal(y, y0) and torch.equal(c["h"], c0["h"])


def test_remat_recomputes_on_the_mesh_path_from_another_thread(jax_ref):
    """Autograd runs a CUDA backward, and remat's recomputation with it, on
    a thread of its own: the rules it reads are process-wide, so the
    recomputation takes the mesh path the forward took (a thread-local
    rule set made it take the single-device one, and the checkpoint
    refused the mismatch)."""
    import threading
    from torch.utils.checkpoint import checkpoint
    p = {k: v.requires_grad_(True) for k, v in _params(jax_ref).items()}
    x = torch.as_tensor(_inputs(2, 64))
    cfg = dataclasses.replace(CFG, ssm_seq_parallel=True)
    mesh = make_host_mesh(4, devices=["cpu"] * 8)
    errors = []
    with sharding_rules(batch="data", __mesh__=mesh):
        y = checkpoint(lambda xx: SSM.ssm_prefill(p, cfg, xx)[0], x,
                       use_reentrant=False)

        def backward():
            try:
                y.sum().backward()
            except Exception as e:          # noqa: BLE001
                errors.append(e)
        t = threading.Thread(target=backward)
        t.start()
        t.join()
    assert not errors, errors
    assert all(v.grad is not None for v in p.values())
