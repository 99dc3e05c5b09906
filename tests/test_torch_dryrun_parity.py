"""The dry run's counts (``repro_torch.launch.hlo_analysis.CostCounter``,
``repro_torch.launch.dryrun``) against the JAX package's XLA analyses of
the same steps, computed in a subprocess (8 forged host devices, as
``tests/test_distributed.py`` runs its mesh programs).

* **FLOPs.**  The port's meshless, unrolled prefill at 1 and 2 pattern
  units (smoke widths, vocab 512, batch 2, 64 tokens) of a dense, an MoE,
  an MLA, an SSM, an RG-LRU, an encoder-decoder and a vision config, and a
  train and a decode step of stablelm and mamba2, against XLA's
  ``cost_analysis()["flops"]`` of the compiled program.  XLA's fusion pass
  is off in the subprocess (``--xla_disable_hlo_passes=fusion``): with it
  on, XLA duplicates cheap elementwise producers into each consumer fusion
  and counts every copy (mamba2's conv taps go into three fusions: +3.2%
  there), which an eager program does not do.  The compiled program is
  the right one otherwise: its dead-code pass drops the unembedding of all
  but the last position, which the lowered program still counts.
  Tolerance: 0.5% for the prefills, 1% for the train and decode steps
  (XLA's autodiff and the decode's dynamic slices emit other elementwise
  ops than PyTorch's; the products agree exactly).
* **Exact:** ``model_flops_total`` (the active-parameter formula against
  the JAX package's ``active_param_count``) and the dry run's
  ``argument_bytes`` on a one-slot mesh against
  ``memory_analysis().argument_size_in_bytes`` of the same unrolled step;
  the decode cache's ``pos`` is int32 [batch] in the port and a scalar in
  the JAX package (``tests/test_torch_launch_shapes.py``), the one allowed
  difference.
* **Collectives.**  The expert-parallel MoE block on a (2, 4) mesh books
  what the JAX package's HLO holds (``hlo_analysis.collective_bytes``),
  exactly; so do the sequence-parallel SSD's prefill (the conv-halo and
  scan permutes, the cache's masked ``psum``) and its training forward at
  batch 2.
* **internvl2 past max_seq.**  A prompt of patches and text longer than
  the prefill's ``max_seq``: the JAX package keeps the last ``max_seq``
  positions as a ring, the port raises (ROADMAP, by design).
* **Not held to XLA:** HBM bytes, the eager program's against the fused
  program's (``launch/hlo_analysis.py``'s docstring).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.model import build_model
from repro_torch.models.sharding import sharding_rules
from repro_torch.models.config import reference_fields

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
B, S = 2, 64
PREFILL_ARCHS = ("stablelm-1.6b", "mixtral-8x22b", "deepseek-v2-236b",
                 "mamba2-130m", "recurrentgemma-9b", "whisper-large-v3",
                 "internvl2-76b")
STEP_ARCHS = ("stablelm-1.6b", "mamba2-130m")
CASES = [(a, "prefill", k) for a in PREFILL_ARCHS for k in (1, 2)] + \
    [(a, m, k) for a in STEP_ARCHS for m in ("train", "decode")
     for k in (1, 2)]
TOL = {"prefill": 5e-3, "train": 1e-2, "decode": 1e-2}
#: (batch, sequence) of the sequence-parallel SSD on (2, 4)
SSD_CASES = [(2, 32), (2, 64)]


def _cfg(arch, k, get=get_config):
    cfg = dataclasses.replace(get(arch).smoke(), vocab=512)
    return D._reduced_cfg(cfg, k)[0]


def _max_seq(cfg):
    return S + cfg.n_patches


def _jax_steps(model, cfg, mode):
    """The JAX package's meshless step of ``mode`` and its arguments'
    shapes (what ``launch/steps.py`` builds, without the sharding rules)."""
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as JST
    from repro.optim import adamw_update, linear_warmup_cosine
    p = JST.eval_params_shape(model, False)
    if mode == "prefill":
        return (lambda p, b: model.prefill(p, b, _max_seq(cfg))), \
            (p, model.input_specs("prefill", B, S))
    if mode == "decode":
        def step(p, t, c):
            logits, c = model.decode_step(p, t, c)
            return jnp.argmax(logits, axis=-1).astype(jnp.int32), c
        return step, (p, jax.ShapeDtypeStruct((B,), jnp.int32),
                      JST.eval_cache_shape(model, B, S, False))
    loss_fn = functools.partial(model.loss, remat=not cfg.enc_dec)
    schedule = linear_warmup_cosine(3e-4, warmup=101, total_steps=1000)

    def step(params, opt, batch):
        (loss, parts), grads = jax.value_and_grad(
            lambda q: loss_fn(q, batch), has_aux=True)(params)
        new_p, new_o, info = adamw_update(params, grads, opt,
                                          lr=schedule(opt.step))
        return new_p, new_o, {"loss": loss, **parts, **info}
    return step, (p, JST.eval_opt_shape(p),
                  model.input_specs("train", B, S))


def _jax_main(out_path):
    """Subprocess entry: FLOPs and argument bytes of every case, and the
    collective bytes of the MoE block and the sequence-parallel SSD."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.launch.hlo_analysis import collective_bytes
    from repro.launch.mesh import set_mesh
    from repro.models import ModelConfig as JCfg
    from repro.models import moe as JMOE
    from repro.models import ssm as JSSM
    from repro.models.model import build_model as jbuild
    from repro.models.sharding import sharding_rules as jrules
    import test_torch_moe_shard as MS
    import test_torch_seq_parallel as SP
    out = {"cases": {}}
    for arch, mode, k in CASES:
        cfg = _cfg(arch, k, jget)
        model = jbuild(cfg)
        step, args = _jax_steps(model, cfg, mode)
        c = jax.jit(step, keep_unused=True).lower(*args).compile()
        cost = c.cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        out["cases"][f"{arch}/{mode}/{k}"] = {
            "flops": float(cost["flops"]),
            "argument_bytes": int(c.memory_analysis()
                                  .argument_size_in_bytes),
            "active_params": int(model.active_param_count())}
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    c = MS._cfg("e8")
    cfg = JCfg(**reference_fields(c))
    p = JMOE.moe_init(jax.random.PRNGKey(0), cfg)
    x = jnp.asarray(MS._x(c))
    with set_mesh(mesh):
        with jrules(batch="data", __mesh__=mesh):
            comp = jax.jit(lambda p, x: JMOE._apply_moe_shard_map(
                p, cfg, x, mesh)).lower(p, x).compile()
    out["moe"] = collective_bytes(comp.as_text())
    cfg = dataclasses.replace(
        JCfg(**reference_fields(SP.CFG)), ssm_seq_parallel=True)
    p = JSSM.ssm_init(jax.random.PRNGKey(0), cfg)
    for b, s in SSD_CASES:
        x = jnp.asarray(SP._inputs(b, s))
        with set_mesh(mesh):
            with jrules(batch="data", __mesh__=mesh):
                for name, fn in (("prefill", JSSM.ssm_prefill),
                                 ("train", JSSM.ssm_train)):
                    comp = jax.jit(lambda p, x, fn=fn: fn(p, cfg, x)) \
                        .lower(p, x).compile()
                    out[f"ssd/{name}/{b}/{s}"] = collective_bytes(
                        comp.as_text())
    # a vision prompt past max_seq: the JAX package's prefill keeps a ring
    jm = jbuild(_cfg("internvl2-76b", 1, jget))
    logits, cache = jax.eval_shape(
        lambda p, b: jm.prefill(p, b, S),
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))),
        jm.input_specs("prefill", B, S))
    out["vlm_ring_logits"] = list(logits.shape)
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dryrun") / "ref.json")
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_disable_hlo_passes=fusion")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(HERE, "..", "src") + os.pathsep + HERE
    code = f"import test_torch_dryrun_parity as t; t._jax_main({path!r})"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=HERE)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


def _meta(specs):
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in specs.items()}


def _port_count(cfg, mode) -> HA.CostCounter:
    """The port's meshless unrolled step of ``mode`` traced on meta."""
    model = build_model(cfg)
    params = ST.eval_params_shape(model, False)
    counter = HA.CostCounter()
    if mode == "prefill":
        step = ST.make_prefill_step(model, None, _max_seq(cfg),
                                    stacked=False)
        with counter:
            step(params, _meta(model.input_specs("prefill", B, S)))
    elif mode == "decode":
        step = ST.make_decode_step(model, None, stacked=False)
        cache = ST.eval_cache_shape(model, B, S, False)
        with counter:
            step(params, torch.empty((B,), dtype=torch.int32,
                                     device="meta"), cache)
    else:
        step = ST.make_train_step(model, None, stacked=False)
        with counter:
            step(params, ST.eval_opt_shape(params),
                 _meta(model.input_specs("train", B, S)))
    return counter


@pytest.mark.parametrize("arch,mode,k", CASES)
def test_flops_match_xla(arch, mode, k, jax_ref):
    want = jax_ref["cases"][f"{arch}/{mode}/{k}"]["flops"]
    got = _port_count(_cfg(arch, k), mode).flops
    assert abs(got / want - 1) <= TOL[mode], (got, want)


@pytest.mark.parametrize("arch,mode", [(a, m) for a in PREFILL_ARCHS[:4]
                                       for m in ("prefill", "decode",
                                                 "train")])
def test_argument_bytes_and_model_flops_are_exact(arch, mode, jax_ref,
                                                  monkeypatch):
    """The dry run's record on a one-slot meta mesh: argument bytes equal
    XLA's (less the decode cache's per-row ``pos``), and the model-FLOP
    formula uses the JAX package's active-parameter count."""
    name = f"smoke_{mode}"
    monkeypatch.setitem(ST.SHAPES, name, {"mode": mode, "seq": S,
                                          "global_batch": B})
    cfg = _cfg(arch, 1)
    rec = D.lower_combo(cfg, name, False, mesh=D.one_card_mesh(),
                        analysis=True)
    assert rec["status"] == "compiled"
    ref = jax_ref["cases"].get(f"{arch}/{mode}/1") or \
        jax_ref["cases"][f"{arch}/prefill/1"]
    toks = B * (S if mode != "decode" else 1)
    assert rec["model_flops_total"] == \
        (6.0 if mode == "train" else 2.0) * ref["active_params"] * toks
    if f"{arch}/{mode}/1" not in jax_ref["cases"]:
        return
    pos_extra = (B - 1) * 4 if mode == "decode" else 0
    assert rec["memory"]["argument_bytes"] == \
        ref["argument_bytes"] + pos_extra


def test_moe_block_books_the_reference_all_reduce(jax_ref):
    """y's psum over model ([2, 8, 32] f32 a device) and aux's pmean over
    data (4 B): 2052 B of all-reduce a device."""
    import test_torch_moe_shard as MS
    cfg = MS._cfg("e8")
    p = MOE.moe_init(torch.Generator().manual_seed(0), cfg, "meta")
    x = torch.empty((4, 8, cfg.d_model), device="meta")
    mesh = make_host_mesh(4, devices=["meta"] * 8)
    counter = HA.CostCounter()
    with counter, sharding_rules(batch="data", __mesh__=mesh):
        MOE.apply_moe(p, cfg, x)
    assert HA.collective_bytes(counter) == jax_ref["moe"] == \
        {"all-gather": 0, "all-reduce": 2052, "reduce-scatter": 0,
         "all-to-all": 0, "collective-permute": 0}


@pytest.mark.parametrize("b,s", SSD_CASES)
@pytest.mark.parametrize("name", ["prefill", "train"])
def test_seq_parallel_ssd_books_the_reference_collectives(name, b, s,
                                                          jax_ref):
    import test_torch_seq_parallel as SP
    cfg = dataclasses.replace(SP.CFG, ssm_seq_parallel=True)
    p = SSM.ssm_init(torch.Generator().manual_seed(0), cfg, "meta")
    x = torch.empty((b, s, cfg.d_model), device="meta")
    mesh = make_host_mesh(4, devices=["meta"] * 8)
    counter = HA.CostCounter()
    fn = SSM.ssm_prefill if name == "prefill" else SSM.ssm_train
    with counter, sharding_rules(batch="data", __mesh__=mesh):
        fn(p, cfg, x)
    assert HA.collective_bytes(counter) == jax_ref[f"ssd/{name}/{b}/{s}"]


def test_collectives_book_nothing_without_a_counter_or_on_one_slot():
    """One slot along the axis moves nothing (XLA drops such a
    collective); without an active counter nothing is booked anywhere."""
    import test_torch_moe_shard as MS
    cfg = MS._cfg("e8")
    p = MOE.moe_init(torch.Generator().manual_seed(0), cfg, "meta")
    x = torch.empty((4, 8, cfg.d_model), device="meta")
    counter = HA.CostCounter()
    with counter, sharding_rules(batch="data",
                                 __mesh__=D.one_card_mesh()):
        MOE.apply_moe(p, cfg, x)
    assert sum(HA.collective_bytes(counter).values()) == 0


def test_vision_prompt_past_max_seq_rings_in_jax_and_raises_in_the_port(
        jax_ref):
    assert jax_ref["vlm_ring_logits"][0] == B
    model = build_model(_cfg("internvl2-76b", 1))
    with pytest.raises(ValueError, match=f"exceeds max_seq={S}"):
        model.prefill(ST.eval_params_shape(model, False),
                      _meta(model.input_specs("prefill", B, S)), S)
