"""The port's model serving end to end on the CPU, against the JAX package.

A ``model_serve`` server (stablelm-smoke-flash, flash prefill + flash
decode) behind the port's ``Runtime``, with 1, 4 or 8 clients that join
one tick apart, and more streams than slots.  Pinned:

* every answer equals the JAX package's ``sequential_decode`` on the same
  weights (bridged through ``params_from_numpy``), token for token — and
  every reference chain's top-2 logit margin exceeds the 1e-4 logit
  tolerance of tests/test_torch_transformer.py, so agreement is not luck;
* every answer equals the port's own ``sequential_decode`` bitwise, run in
  the slot the stream was served in (continuous batching changes nothing);
* ``tokens_generated == tokens_delivered + tokens_dropped +
  tokens_in_flight``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.launch import model_serve as jax_ms
from repro.models import transformer as jax_tf
from repro_torch.core.plan import executable_cache_info
from repro_torch.launch import model_serve as ms
from repro_torch.models import transformer as tt
from repro_torch.runtime import Device, Runtime

torch.set_num_threads(2)

pytestmark = pytest.mark.modelserve

MAX_SEQ = 32
LOGIT_TOL = 1e-4
GEN_MIX = ["4", "3;6", "5", "6;3"]


@pytest.fixture(scope="module")
def model():
    jcfg = jax_ms.SERVE_MODELS["stablelm-smoke-flash"]()
    tcfg = ms.SERVE_MODELS["stablelm-smoke-flash"]()
    jp = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tt.params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


_JAX_REF = {}


def _jax_ref(model, prompt, gen):
    """JAX ``sequential_decode`` (memoized: it re-jits per call), after
    checking that the chain's argmax decisions have margin."""
    key = (tuple(prompt), gen)
    if key not in _JAX_REF:
        jcfg, jp, tcfg, tp = model
        logits, cache = tt.lm_prefill(tp, tcfg, torch.tensor([prompt]),
                                      MAX_SEQ)
        for step in range(gen):
            top2 = torch.topk(logits[0], 2).values
            assert float(top2[0] - top2[1]) > LOGIT_TOL, (prompt, step)
            if step + 1 < gen:
                logits, cache = tt.lm_decode(tp, tcfg, tt.greedy(logits),
                                             cache)
        _JAX_REF[key] = jax_ms.sequential_decode(jp, jcfg, prompt, gen,
                                                 MAX_SEQ)
    return _JAX_REF[key]


def _prompt(i):
    return [i + 1, i + 2, i + 3]


def _serve(model, n_clients, slots, ticks):
    """Server plus ``n_clients`` clients joining one tick apart."""
    tcfg, tp = model[2], model[3]
    rt = Runtime(device="cpu")
    hub = Device("hub", device="cpu")
    srv = hub.add_pipeline(ms.serve_pipeline(slots=slots, max_seq=MAX_SEQ))
    srv.params["lm"] = tp
    rt.add_device(hub)
    runs = []
    for t in range(ticks):
        if len(runs) < n_clients:
            i = len(runs)
            dev = Device(f"tv{i}", device="cpu")
            runs.append(dev.add_pipeline(ms.client_pipeline(
                prompts=",".join(map(str, _prompt(i))),
                gens=GEN_MIX[i % len(GEN_MIX)])))
            rt.add_device(dev)
        rt.tick()
    return rt, srv, runs


def _check(model, rt, runs, slots, min_answers):
    tcfg, tp = model[2], model[3]
    for i, run in enumerate(runs):
        gens = [int(g) for g in GEN_MIX[i % len(GEN_MIX)].split(";")]
        got = run.sink_log["res"]
        assert len(got) >= min_answers
        for j, b in enumerate(got):
            ans, gen = np.asarray(b.tensor).tolist(), gens[j % len(gens)]
            assert 0 <= b.meta["slot"] < slots
            assert ans == _jax_ref(model, _prompt(i), gen), (i, j)
            assert ans == ms.sequential_decode(
                tp, tcfg, _prompt(i), gen, MAX_SEQ, slots=slots,
                slot=b.meta["slot"], device="cpu"), (i, j)
    qb = rt.stats()["query_batching"]
    assert qb["tokens_generated"] == qb["tokens_delivered"] + \
        qb["tokens_dropped"] + qb["tokens_in_flight"]
    return qb


@pytest.mark.parametrize("n_clients", [1, 4, 8])
def test_streams_equal_jax_sequential_decode(model, n_clients):
    rt, _, runs = _serve(model, n_clients, slots=8, ticks=16)
    qb = _check(model, rt, runs, slots=8, min_answers=2)
    if n_clients == 8:
        # the batch really was continuous: >1 stream decoded per tick, and
        # the parity replays ran in more than the first slot
        assert qb["batched_frames"] > qb["decode_ticks"]
        assert len({b.meta["slot"] for r in runs
                    for b in r.sink_log["res"]}) > 4


def test_more_streams_than_slots_wait_and_join(model):
    """6 streams over 4 slots: the overflow waits, joins as slots free, and
    every answer is still bitwise the sequential decode."""
    rt, _, runs = _serve(model, 6, slots=4, ticks=20)
    qb = _check(model, rt, runs, slots=4, min_answers=2)
    assert qb["streams_finished"] >= 12
    assert qb["batched_frames"] > qb["decode_ticks"]


def test_serve_tick_reuses_one_cached_callable(model):
    """Joins and leaves never build a new serve-tick callable: one entry per
    (topology fingerprint, state structure)."""
    rt, srv, runs = _serve(model, 3, slots=8, ticks=4)
    plan = srv.pipe.plan
    fn = plan.compiled_serve_tick(srv.state)
    before = executable_cache_info()
    rt.run(6)
    assert plan.compiled_serve_tick(srv.state) is fn
    assert executable_cache_info() == before


def test_first_request_waits_parked_until_a_server_registers(model):
    """A client that starts before any server exists parks its request and
    is served once the server registers."""
    tcfg, tp = model[2], model[3]
    rt = Runtime(device="cpu")
    dev = Device("tv", device="cpu")
    run = dev.add_pipeline(ms.client_pipeline(prompts="1,2,3", gens="4"))
    rt.add_device(dev)
    rt.run(2)
    assert rt.stats()["failover"]["parked_now"] == 1
    hub = Device("hub", device="cpu")
    srv = hub.add_pipeline(ms.serve_pipeline(slots=8, max_seq=MAX_SEQ))
    srv.params["lm"] = tp
    rt.add_device(hub)
    rt.run(6)
    ans = run.sink_log["res"][0]
    assert np.asarray(ans.tensor).tolist() == ms.sequential_decode(
        tp, tcfg, [1, 2, 3], 4, MAX_SEQ, slot=ans.meta["slot"], device="cpu")
