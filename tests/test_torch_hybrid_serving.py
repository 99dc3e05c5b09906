"""The rGLRU state family served by the port, against the JAX package on
the CPU (fp32, weights through ``params_from_numpy``).

* The ``hybrid_rglru`` family of ``tests/test_models.py`` (R, R, L; window
  8): a prefill-and-decode chain across the ring's wrap, logits and every
  cache leaf (``h``, ``conv``, ``k``, ``v``) within atol 1e-4 of the JAX
  chain, at prompt lengths where the JAX package rolls its ring right (see
  ``tests/test_torch_window_attn.py``).
* ``recurrentgemma-smoke`` behind ``Runtime(device="cpu")`` with
  ``max_seq`` above the window, so decode wraps the ring and one prompt is
  longer than it: every answer equals the JAX package's
  ``sequential_decode`` token for token, and every reference chain's top-2
  logit margin exceeds the 1e-4 logit tolerance, so agreement is not luck
  (the counterpart of ``tests/test_model_serving.py::
  test_rglru_recurrent_state_family``); every answer equals the port's own
  ``sequential_decode`` bitwise, replayed in its serve slot; token
  conservation holds.
* ``lam`` stays f32 through the weight bridge and ``init_params`` in a
  bf16 model, as in the JAX package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import model_serve as jax_ms
from repro.models import ModelConfig as JConfig
from repro.models import transformer as jax_tf
from repro_torch.launch import model_serve as ms
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig, reference_fields
from repro_torch.runtime import Device, Runtime

torch.set_num_threads(2)

pytestmark = pytest.mark.modelserve

ATOL = 1e-4
LOGIT_TOL = 1e-4
HYBRID = dict(name="t", arch_type="hybrid", n_layers=3, d_model=64,
              n_heads=4, n_kv_heads=1, d_ff=128, vocab=97,
              layer_pattern="RRL", window=8, lru_width=64, dtype="float32")
MAX_SEQ = 64                          # recurrentgemma-smoke's window is 32
#: (prompt, tokens to generate): decode across position 32 (the wrap), a
#: prompt longer than the window (48 % 32 == 16: the JAX roll is right)
STREAMS = [([5, 6], 5), (list(range(7, 27)), 20), (list(range(40, 88)), 8),
           ([9, 3, 1], 34)]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


@pytest.mark.parametrize("s", [6, 12])
def test_hybrid_rglru_chain_matches_jax(s):
    jcfg, tcfg = JConfig(**HYBRID), ModelConfig(**HYBRID)
    jp = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tt.params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    prompt = np.random.default_rng(s).integers(0, 97, s).tolist()
    logits, cache = tt.lm_prefill(tp, tcfg, torch.tensor([prompt]), 32)
    jlogits, jcache = jax_tf.lm_prefill(jp, jcfg, jnp.asarray([prompt]), 32)
    for step in range(14):
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits),
                                   atol=ATOL, rtol=0)
        for i, (c, jc) in enumerate(zip(cache["layers"], jcache["layers"])):
            assert list(c) == (["k", "v"] if i == 2 else ["h", "conv"])
            for name in c:
                assert tuple(c[name].shape) == tuple(jc[name].shape)
                np.testing.assert_allclose(_np(c[name]),
                                           np.asarray(jc[name]), atol=ATOL,
                                           rtol=0, err_msg=f"{step} {name}")
        tok = tt.greedy(logits)
        logits, cache = tt.lm_decode(tp, tcfg, tok, cache)
        jlogits, jcache = jax_tf.lm_decode(jp, jcfg,
                                           jnp.asarray(_np(tok)), jcache)
    assert int(cache["pos"][0]) == s + 14 > 2 * 8      # wrapped twice


@pytest.fixture(scope="module")
def model():
    jcfg = jax_ms.SERVE_MODELS["recurrentgemma-smoke"]()
    tcfg = ms.SERVE_MODELS["recurrentgemma-smoke"]()
    assert dataclasses.asdict(jcfg) == reference_fields(tcfg)
    assert tcfg.window < MAX_SEQ
    jp = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tt.params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _jax_ref(model, prompt, gen):
    """JAX ``sequential_decode``, after checking that the chain's argmax
    decisions have margin (on the port's chain, within 1e-4 of JAX's)."""
    jcfg, jp, tcfg, tp = model
    logits, cache = tt.lm_prefill(tp, tcfg, torch.tensor([prompt]), MAX_SEQ)
    for step in range(gen):
        top2 = torch.topk(logits[0], 2).values
        assert float(top2[0] - top2[1]) > LOGIT_TOL, (len(prompt), step)
        if step + 1 < gen:
            logits, cache = tt.lm_decode(tp, tcfg, tt.greedy(logits), cache)
    return jax_ms.sequential_decode(jp, jcfg, prompt, gen, MAX_SEQ)


@pytest.fixture(scope="module")
def served(model):
    """Four clients, one stream each, joining one tick apart, over 2 slots
    (so a stream waits and joins a slot another one left)."""
    tcfg, tp = model[2], model[3]
    rt = Runtime(device="cpu")
    hub = Device("hub", device="cpu")
    srv = hub.add_pipeline(ms.serve_pipeline(model="recurrentgemma-smoke",
                                             slots=2, max_seq=MAX_SEQ))
    srv.params["lm"] = tp
    rt.add_device(hub)
    runs = []
    for t in range(60):
        if len(runs) < len(STREAMS):
            prompt, gen = STREAMS[len(runs)]
            dev = Device(f"tv{len(runs)}", device="cpu")
            runs.append(dev.add_pipeline(ms.client_pipeline(
                prompts=",".join(map(str, prompt)), gens=str(gen))))
            rt.add_device(dev)
        rt.tick()
        if all(r.sink_log.get("res") for r in runs) and \
                len(runs) == len(STREAMS):
            for r in runs:
                r.retired = True
            break
    return rt, runs


def test_rglru_recurrent_state_family(model, served):
    rt, runs = served
    for (prompt, gen), run in zip(STREAMS, runs):
        ans = np.asarray(run.sink_log["res"][0].tensor).tolist()
        assert len(ans) == gen
        assert ans == _jax_ref(model, prompt, gen), len(prompt)


def test_continuous_equals_sequential_bitwise(model, served):
    rt, runs = served
    tcfg, tp = model[2], model[3]
    slots = set()
    for (prompt, gen), run in zip(STREAMS, runs):
        b = run.sink_log["res"][0]
        slots.add(b.meta["slot"])
        assert np.asarray(b.tensor).tolist() == ms.sequential_decode(
            tp, tcfg, prompt, gen, MAX_SEQ, slots=2, slot=b.meta["slot"],
            device="cpu")
    assert slots == {0, 1}
    qb = rt.stats()["query_batching"]
    assert qb["tokens_generated"] == qb["tokens_delivered"] + \
        qb["tokens_dropped"] + qb["tokens_in_flight"]
    assert qb["batched_frames"] > qb["decode_ticks"]   # streams overlapped


def test_prompt_past_the_ring_follows_the_teacher_forced_model(model):
    """A 41-token prompt over a 32-row ring (41 % 32 == 9, where the JAX
    roll is not right): the served tokens are the greedy tokens of the
    teacher-forced model, recomputed over the whole sequence each step."""
    tcfg, tp = model[2], model[3]
    prompt = list(range(100, 141))
    got = ms.sequential_decode(tp, tcfg, prompt, 12, MAX_SEQ, slots=2,
                               slot=1, device="cpu")
    seq = list(prompt)
    for _ in range(12):
        logits, _ = tt.lm_prefill(tp, tcfg, torch.tensor([seq]))
        top2 = torch.topk(logits[0], 2).values
        assert float(top2[0] - top2[1]) > LOGIT_TOL
        seq.append(int(tt.greedy(logits)[0]))
    assert got == seq[len(prompt):]


@pytest.mark.parametrize("route", ["bridge", "init"])
def test_lam_stays_f32_in_a_bf16_model(route):
    cfg = dict(HYBRID, dtype="bfloat16")
    tcfg = ModelConfig(**cfg)
    if route == "bridge":
        jp = jax_tf.init_params(jax.random.PRNGKey(0), JConfig(**cfg))
        tp = tt.params_from_numpy(jax.device_get(jp), tcfg, "cpu")
        np.testing.assert_array_equal(
            _np(tp["layers"][0]["rec"]["lam"]),
            np.asarray(jp["layers"][0]["rec"]["lam"]))
    else:
        tp = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    rec = tp["layers"][0]["rec"]
    assert rec["lam"].dtype == torch.float32
    assert rec["w_r"].dtype == rec["conv"].dtype == torch.bfloat16
    assert tp["layers"][0]["norm1"]["scale"].dtype == torch.float32
    assert tp["layers"][2]["attn"]["wq"].dtype == torch.bfloat16
    cache = tt.cache_init(tcfg, 2, 16, "cpu")
    assert cache["layers"][0]["h"].dtype == torch.float32
    assert cache["layers"][0]["conv"].dtype == torch.bfloat16
