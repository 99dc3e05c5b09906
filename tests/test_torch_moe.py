"""The port's MoE layer against the JAX package's single-device path, on the
CPU, and MoE serving twinned with the JAX runtime.

``apply_moe`` in both packages on the same numpy-seeded inputs and the
same weights (atol = rtol = 1e-4: f32, summation orders differ), with
capacity binding (``capacity_factor`` 0.5: choices are dropped), with
deliberate router ties (two identical router columns: ``lax.top_k`` takes
the lower expert, and so must the port), with shared experts, and pooled
(one dispatch group of B·S tokens, as the reference's ``lm_decode`` at
batch B) against per-row capacity (one group per batch row: the
reference's serve element vmaps a b = 1 decode over its slots).  The
port's ``drop_log`` counts equal the dropped choices that the reference's
capacity implies.

The serve twin: a MoE smoke config registered in both packages inside the
test, the reference ``ModelServeElement`` and the port's server at 4
slots on the same weights, the same clients: the token streams are equal
bitwise (each reference chain has a top-2 logit margin above the 1e-4
logit tolerance, so agreement is not luck), and every port answer is its
own ``sequential_decode`` in its slot.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import model_serve as jax_ms
from repro.models import moe as JMOE
from repro.models.config import ModelConfig as JaxConfig
from repro.runtime import Device as JDevice
from repro.runtime import Runtime as JRuntime
from repro_torch.launch import model_serve as ms
from repro_torch.models import moe as PMOE
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import Device, Runtime

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)
LOGIT_TOL = 1e-4


def _cfgs(**kw):
    base = dict(name="t", arch_type="moe", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, d_ff=64, vocab=97, n_experts=4,
                top_k=2, d_ff_expert=48, dtype="float32")
    base.update(kw)
    return JaxConfig(**base), ModelConfig(**base)


def _layer(jcfg, pcfg, seed=0, tie=False):
    jp = JMOE.moe_init(jax.random.PRNGKey(seed), jcfg)
    if tie:      # experts 1 and 2 get the same router column: equal probs
        r = np.asarray(jp["router"]).copy()
        r[:, 2] = r[:, 1]
        jp = dict(jp, router=jnp.asarray(r))
    return jp, tt.params_from_numpy(jax.device_get(jp), pcfg, "cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _jax_moe(jp, jcfg, x, per_row):
    if not per_row:
        return JMOE.apply_moe(jp, jcfg, jnp.asarray(x))
    ys, auxes = zip(*[JMOE.apply_moe(jp, jcfg, jnp.asarray(x[i:i + 1]))
                      for i in range(x.shape[0])])
    return jnp.concatenate(ys), None


def _dropped(topi, e, cap):
    """Choices the reference's capacity turns away: per expert, those past
    the first ``cap`` in dispatch order."""
    counts = np.bincount(np.asarray(topi).reshape(-1), minlength=e)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("cf,shared,tie", [
    (2.0, 0, False), (0.5, 0, False), (0.5, 1, False), (1.25, 1, True),
    (0.5, 0, True)])
@pytest.mark.parametrize("per_row", [False, True])
def test_apply_moe_matches_jax(cf, shared, tie, per_row):
    jcfg, pcfg = _cfgs(capacity_factor=cf, n_shared_experts=shared)
    jp, pp = _layer(jcfg, pcfg, tie=tie)
    x = _x((3, 8, 32))
    jy, jaux = _jax_moe(jp, jcfg, x, per_row)
    with PMOE.drop_log() as log:
        py, paux = PMOE.apply_moe(pp, pcfg, torch.as_tensor(x),
                                  per_row=per_row)
    assert PMOE.DROP_LOG is None
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
    if jaux is not None:
        np.testing.assert_allclose(float(paux), float(jaux), **TOL)
    # the drop count the reference's capacity implies
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, 32) @ jp["router"], -1)
    topi = np.asarray(jax.lax.top_k(probs, 2)[1]).reshape(3, 8, 2)
    groups = [topi] if not per_row else [topi[i] for i in range(3)]
    t = 24 if not per_row else 8
    want = sum(_dropped(g, 4, PMOE.capacity(t, pcfg)) for g in groups)
    assert [(r, n, int(d)) for r, n, d in log] == [(per_row, t, want)]
    if cf == 0.5:
        assert want > 0                      # capacity binds here


def test_router_ties_take_the_lower_expert():
    probs = torch.tensor([[0.3, 0.3, 0.2, 0.2], [0.1, 0.4, 0.4, 0.1]])
    vals, idx = PMOE.top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_per_row_capacity_isolates_rows():
    """At one batch size, a row's output under per-row dispatch does not
    depend on the other rows; pooled, a crowded batch takes its
    neighbours' expert slots (the serve contract is at equal S)."""
    jcfg, pcfg = _cfgs(capacity_factor=0.5)
    _, pp = _layer(jcfg, pcfg)
    x = torch.as_tensor(_x((4, 1, 32), seed=3))
    crowd = x.clone()
    crowd[1:] = x[0]                     # three copies of row 0's token
    rows, _ = PMOE.apply_moe(pp, pcfg, x, per_row=True)
    crowded, _ = PMOE.apply_moe(pp, pcfg, crowd, per_row=True)
    assert torch.equal(crowded[0], rows[0])
    assert torch.equal(crowded[1:], rows[:1].expand(3, 1, 32))
    pooled, _ = PMOE.apply_moe(pp, pcfg, crowd)
    assert not torch.equal(pooled[1:], crowded[1:])


def test_decode_never_drops_per_row_at_full_width_capacities():
    """One token a slot: capacity max(1, int(k/E·cf)) = 1 for mixtral (8
    experts top-2) and deepseek (160 top-6), and k distinct experts each
    take one token: nothing is dropped at decode."""
    from repro_torch.configs import get_config
    for arch in ("mixtral-8x22b", "deepseek-v2-236b"):
        cfg = get_config(arch)
        assert PMOE.capacity(1, cfg) == 1
        assert PMOE.capacity(8, cfg) == max(1, int(8 * cfg.top_k /
                                                   cfg.n_experts *
                                                   cfg.capacity_factor))


# ---------------------------------------------------------------------------
# serving: the reference ModelServeElement and the port's server, twinned
# ---------------------------------------------------------------------------

KEY = "moe-twin-smoke"
SLOTS, MAX_SEQ = 4, 32
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7], [2, 3, 8, 4],
           [6, 2, 6, 4, 3, 3]]
GENS = [6, 5, 7, 4, 6]


def _smoke(configs, arch):
    """The arch's smoke config with flash on, from ``configs`` (either
    package's registry)."""
    return lambda: dataclasses.replace(configs.get_config(arch).smoke(),
                                       use_flash_attn=True)


def _serve(pkg_rt, pkg_dev, pkg_ms, key, params=None):
    rt = pkg_rt()
    hub = pkg_dev("hub")
    srv = hub.add_pipeline(pkg_ms.serve_pipeline(model=key, slots=SLOTS,
                                                 max_seq=MAX_SEQ))
    if params is not None:
        srv.params["lm"] = params
    rt.add_device(hub)
    runs = []
    for t in range(24):
        if len(runs) < len(PROMPTS):
            i = len(runs)
            dev = pkg_dev(f"tv{i}")
            runs.append(dev.add_pipeline(pkg_ms.client_pipeline(
                prompts=",".join(map(str, PROMPTS[i])), gens=str(GENS[i]))))
            rt.add_device(dev)
        rt.tick()
    return rt, srv, runs


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-236b"])
def test_moe_serving_streams_equal_the_jax_runtime(arch):
    """mixtral's smoke (windowed attention, 4 experts top-2) and
    deepseek's (MLA, a dense first layer, shared experts)."""
    from repro import configs as jconfigs
    from repro_torch import configs as pconfigs
    key = f"{KEY}-{arch}"
    jax_ms.register_serve_model(key, _smoke(jconfigs, arch))
    ms.register_serve_model(key, _smoke(pconfigs, arch))
    jrt, jsrv, jruns = _serve(JRuntime, JDevice, jax_ms, key)
    cfg = ms.SERVE_MODELS[key]()
    tp = tt.params_from_numpy(jax.device_get(jsrv.params["lm"]), cfg, "cpu")
    prt, psrv, pruns = _serve(lambda: Runtime(device="cpu"),
                              lambda n: Device(n, device="cpu"), ms, key, tp)
    for i, (jr, pr) in enumerate(zip(jruns, pruns)):
        ja = [np.asarray(b.tensor).tolist() for b in jr.sink_log["res"]]
        pa = [np.asarray(b.tensor).tolist() for b in pr.sink_log["res"]]
        assert len(pa) >= 1 and pa == ja[:len(pa)] and len(ja) == len(pa), i
        # the chain's argmax decisions have margin
        logits, cache = tt.lm_prefill(tp, cfg, torch.tensor([PROMPTS[i]]),
                                      MAX_SEQ)
        for step in range(GENS[i]):
            top2 = torch.topk(logits[0], 2).values
            assert float(top2[0] - top2[1]) > LOGIT_TOL, (i, step)
            if step + 1 < GENS[i]:
                logits, cache = tt.lm_decode(tp, cfg, tt.greedy(logits),
                                             cache)
        for b in pr.sink_log["res"]:
            assert np.asarray(b.tensor).tolist() == ms.sequential_decode(
                tp, cfg, PROMPTS[i], GENS[i], MAX_SEQ, slots=SLOTS,
                slot=b.meta["slot"], device="cpu")
    qb = prt.stats()["query_batching"]
    assert qb["tokens_generated"] == qb["tokens_delivered"] + \
        qb["tokens_dropped"] + qb["tokens_in_flight"]


@pytest.mark.parametrize("preset", ["mixtral-smoke", "deepseek-smoke"])
def test_staged_split_serves_a_zoo_preset_unchanged(preset):
    """A zoo preset over 2 ``model_serve_stage`` pipelines (each stage
    draws the full tree from the monolithic server's seed and keeps its
    slice; the stage decode dispatches MoE per row): every answer is
    bitwise ``sequential_decode`` on the tree the stages compose to, in
    the slot it was served in."""
    from repro_torch.device import make_generator
    cpu = torch.device("cpu")
    rt = Runtime(device="cpu")
    for k, ps in enumerate(ms.staged_serve_pipelines(
            model=preset, slots=SLOTS, max_seq=MAX_SEQ, n_stages=2)):
        dev = Device(f"stage{k}", device="cpu")
        dev.add_pipeline(ps, generator=make_generator(3, cpu))
        rt.add_device(dev)
    runs = []
    for i in range(len(PROMPTS)):
        dev = Device(f"tv{i}", device="cpu")
        runs.append(dev.add_pipeline(ms.client_pipeline(
            prompts=",".join(map(str, PROMPTS[i])), gens=str(GENS[i]))))
        rt.add_device(dev)
    rt.run(28)
    cfg = ms.SERVE_MODELS[preset]()
    full = tt.init_params(cfg, make_generator(3, cpu), cpu)
    for i, run in enumerate(runs):
        answers = run.sink_log.get("res", [])
        assert answers, i
        for b in answers:
            assert np.asarray(b.tensor).tolist() == ms.sequential_decode(
                full, cfg, PROMPTS[i], GENS[i], MAX_SEQ, slots=SLOTS,
                slot=b.meta["slot"], device="cpu"), i


# ---------------------------------------------------------------------------
# the card (``cuda`` marker; skipped here)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the MoE decode as a CUDA graph")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True])
def test_apply_moe_on_card_matches_cpu(cuda, per_row):
    """fp32 on the card within atol = rtol = 1e-5 of the CPU (TF32 off);
    the combine adds in a fixed order, so two calls give the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    jcfg, pcfg = _cfgs(capacity_factor=0.5, n_shared_experts=1)
    _, pp = _layer(jcfg, pcfg, tie=True)
    x = torch.as_tensor(_x((3, 8, 32)))
    gp = {k: (v.to(cuda) if isinstance(v, torch.Tensor) else
              {kk: vv.to(cuda) for kk, vv in v.items()})
          for k, v in pp.items()}
    y, aux = PMOE.apply_moe(gp, pcfg, x.to(cuda), per_row=per_row)
    ref, raux = PMOE.apply_moe(pp, pcfg, x, per_row=per_row)
    torch.testing.assert_close(y.cpu(), ref, atol=1e-5, rtol=1e-5)
    assert torch.equal(y, PMOE.apply_moe(gp, pcfg, x.to(cuda),
                                         per_row=per_row)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["mixtral-smoke", "deepseek-smoke"])
def test_moe_serve_graph_equals_eager_on_card(cuda, preset):
    """The MoE decode tick captures as a CUDA graph (no host read of the
    expert counts): graphed answers == the ``jit=False`` twin's ==
    ``sequential_decode`` in the slot, bitwise."""
    from repro_torch.device import make_generator
    got = {}
    for jit in (True, False):
        rt = Runtime()
        hub = Device("hub")
        srv = hub.add_pipeline(ms.serve_pipeline(model=preset, slots=SLOTS,
                                                 max_seq=MAX_SEQ),
                               generator=make_generator(0, rt.device),
                               jit=jit)
        rt.add_device(hub)
        runs = []
        for i in range(len(PROMPTS)):
            dev = Device(f"tv{i}")
            runs.append(dev.add_pipeline(ms.client_pipeline(
                prompts=",".join(map(str, PROMPTS[i])), gens=str(GENS[i])),
                jit=jit))
            rt.add_device(dev)
        rt.run(24)
        got[jit] = [[(np.asarray(b.tensor).tolist(), b.meta["slot"])
                     for b in r.sink_log["res"]] for r in runs]
    assert got[True] == got[False]
    cfg = ms.SERVE_MODELS[preset]()
    for i, answers in enumerate(got[True]):
        assert answers
        for toks, slot in answers:
            assert toks == ms.sequential_decode(
                srv.params["lm"], cfg, PROMPTS[i], GENS[i], MAX_SEQ,
                slots=SLOTS, slot=slot)
