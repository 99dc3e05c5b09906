"""The port's optimizer and schedules against the JAX package on the CPU:
twins of ``test_substrates.py::TestOptim``, then ``adamw_update`` on a
smoke model's tree with f32 and bf16 leaves over 3 steps and the
schedules at every step of a run, both in both packages.

Tolerances: the schedules and the 3-step update agree within f32 rounding
(atol = rtol = 1e-6 for f32 leaves and m, v; two bf16 ulps for bf16
leaves, where an f32 difference that flips one rounding in an early step
carries into the later ones;
rtol 1e-5 for the global norm, a sum of ~1.6M squares): each element
takes the same IEEE operations in the same order, but the global norm's
sums reduce in each framework's own order, and ``b ** step`` and ``cos``
are each library's own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.optim import adamw_init as jax_init
from repro.optim import adamw_update as jax_update
from repro.optim.schedule import cosine_schedule as jax_cos
from repro.optim.schedule import linear_warmup_cosine as jax_warm
from repro_torch.core.buffers import tree_flatten
from repro_torch.models import transformer as tt
from repro_torch.configs import get_config
from repro_torch.optim import (OptState, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule,
                               linear_warmup_cosine)

torch.set_num_threads(2)


class TestOptim:
    def test_clip(self):
        g = {"a": torch.full((10,), 10.0)}
        clipped, norm = clip_by_global_norm(g, 1.0)
        assert float(norm) > 1.0
        n2 = float(torch.sqrt(torch.sum(clipped["a"] ** 2)))
        assert abs(n2 - 1.0) < 1e-5

    def test_adamw_reduces_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        opt = adamw_init(params)
        for _ in range(200):
            g = {"w": 2 * params["w"]}          # d/dw sum(w ** 2)
            params, opt, _ = adamw_update(params, g, opt, lr=0.1,
                                          weight_decay=0.0)
        assert float(params["w"].abs().max()) < 0.1

    def test_schedule_warmup_then_decay(self):
        lr = linear_warmup_cosine(1e-3, warmup=10, total_steps=100)
        step = lambda i: torch.tensor(i, dtype=torch.int32)  # noqa: E731
        assert float(lr(step(0))) == 0.0
        assert abs(float(lr(step(10))) - 1e-3) < 1e-9
        assert float(lr(step(100))) < 1e-3


def test_init_state_is_f32_zeros_and_an_int32_step():
    params = {"a": torch.ones((2, 3), dtype=torch.bfloat16),
              "b": [torch.ones(4), None]}
    opt = adamw_init(params)
    assert isinstance(opt, OptState)
    assert opt.step.dtype == torch.int32 and int(opt.step) == 0
    assert opt.m["a"].dtype == torch.float32 and opt.m["b"][1] is None
    assert opt.m["a"].data_ptr() != opt.v["a"].data_ptr()


@pytest.mark.parametrize("sched", ["cosine", "warmup"])
def test_schedules_match_jax_at_every_step(sched):
    n = 120
    if sched == "cosine":
        j, t = jax_cos(3e-4, 100), cosine_schedule(3e-4, 100)
    else:
        j = jax_warm(1e-3, warmup=11, total_steps=n)
        t = linear_warmup_cosine(1e-3, warmup=11, total_steps=n)
    for i in range(n + 3):
        want = float(j(jnp.int32(i)))
        got = t(torch.tensor(i, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * abs(want) + 1e-12, (i, want)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_adamw_update_matches_jax_over_three_steps():
    """stablelm's smoke tree with its matrices in bf16 (norms f32): three
    steps on the same gradients in both packages; the norm clips (lr from
    the warm-up schedule, weight decay on)."""
    cfg = dataclasses.replace(jax_config("stablelm-1.6b").smoke(),
                              dtype="bfloat16")
    jp = jax_build(cfg).init(jax.random.PRNGKey(0))
    pcfg = dataclasses.replace(get_config("stablelm-1.6b").smoke(),
                               dtype="bfloat16")
    tp = tt.params_from_numpy(jax.device_get(jp), pcfg, "cpu")
    leaves = jax.tree_util.tree_leaves(jp)
    assert {str(x.dtype) for x in leaves} == {"float32", "bfloat16"}
    rng = np.random.default_rng(0)
    jsched = jax_warm(1e-2, warmup=2, total_steps=10)
    tsched = linear_warmup_cosine(1e-2, warmup=2, total_steps=10)
    jo, to = jax_init(jp), adamw_init(tp)
    for step in range(3):
        g_np = [(rng.standard_normal(x.shape) * 3).astype(np.float32)
                for x in leaves]
        jg = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jp),
            [jnp.asarray(g).astype(x.dtype) for g, x in zip(g_np, leaves)])
        tg = tt.params_from_numpy(jax.device_get(jg), pcfg, "cpu")
        jp, jo, jinfo = jax_update(jp, jg, jo, lr=jsched(jo.step))
        tp, to, tinfo = adamw_update(tp, tg, to, lr=tsched(to.step))
        assert float(jinfo["grad_norm"]) > 1.0          # clipping binds
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-5)
        assert int(to.step) == int(jo.step) == step + 1
    for name, jt, pt in (("params", jp, tp), ("m", jo.m, to.m),
                         ("v", jo.v, to.v)):
        for a, b in zip(jax.tree_util.tree_leaves(jt), tree_flatten(pt)[0]):
            a32, b32 = _f32(a), _f32(b)
            if b.dtype == torch.bfloat16:
                two_ulps = np.abs(a32) * 2.0 ** -6 + 1e-30
                assert (np.abs(a32 - b32) <= two_ulps).all(), name
            else:
                np.testing.assert_allclose(b32, a32, rtol=1e-6, atol=1e-6,
                                           err_msg=name)
            assert b.dtype == (torch.bfloat16 if str(a.dtype) == "bfloat16"
                               else torch.float32)


def test_adamw_update_is_in_place_and_leaves_grads_alone():
    p = {"w": torch.ones(3, dtype=torch.bfloat16), "b": torch.zeros(2)}
    g = {"w": torch.full((3,), 0.5, dtype=torch.bfloat16),
         "b": torch.ones(2)}
    keep = {k: v.clone() for k, v in g.items()}
    opt = adamw_init(p)
    ptrs = [t.data_ptr() for t in (p["w"], p["b"], opt.m["w"], opt.v["b"])]
    p2, opt2, _ = adamw_update(p, g, opt, lr=0.1)
    assert p2 is p and opt2.m is opt.m
    assert [t.data_ptr() for t in (p["w"], p["b"], opt2.m["w"],
                                   opt2.v["b"])] == ptrs
    assert all(torch.equal(g[k], keep[k]) for k in g)
    assert not torch.equal(p["w"], torch.ones(3, dtype=torch.bfloat16))
