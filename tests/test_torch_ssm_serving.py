"""Mamba-2 served by the port, against the JAX package on the CPU (fp32,
weights through ``params_from_numpy``).

* ``mamba2-smoke`` (mamba2-130m's smoke config: 2 SSD layers, d_model 256,
  state 32, chunk 16) behind ``Runtime(device="cpu")``, 4 clients over 2
  slots, prompts shorter than a chunk, longer than one and two (padded
  last chunks): every answer equals the JAX package's
  ``sequential_decode`` token for token, each reference chain's top-2
  logit margin above the 1e-4 logit tolerance (so agreement is not luck);
  every answer equals the port's own ``sequential_decode`` bitwise,
  replayed in its serve slot; token conservation holds.
* A decode tick leaves the SSD state (``h`` and ``conv``) of inactive
  slots bitwise as it was.
* The stage-local replay step (``ModelServeStageElement.host_stage_decode``)
  carries a parked stream's SSD state forward: its tokens are
  ``sequential_decode``'s in that slot, and its parked state is bitwise
  that slot's row of a serve step's cache (the SSD layers rebind their
  state, so the replay re-reads the scratch cache's leaves).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import model_serve as jax_ms
from repro.models import transformer as jax_tf
from repro_torch.core.modelserve import ModelServeStageElement
from repro_torch.launch import model_serve as ms
from repro_torch.models import transformer as tt
from repro_torch.runtime import Device, Runtime
from repro_torch.models.config import reference_fields

torch.set_num_threads(2)

pytestmark = pytest.mark.modelserve

LOGIT_TOL = 1e-4
MAX_SEQ = 64
#: (prompt, tokens to generate): shorter than a chunk of 16, two chunks
#: with a padded last one, three (the last padded), one token
STREAMS = [([5, 6], 5), (list(range(7, 27)), 12), (list(range(40, 73)), 8),
           ([9], 20)]


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config("mamba2-130m").smoke()
    tcfg = ms.SERVE_MODELS["mamba2-smoke"]()
    assert dataclasses.asdict(jcfg) == reference_fields(tcfg)
    jp = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tt.params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _jax_ref(model, prompt, gen):
    """JAX ``sequential_decode``, after checking that the chain's argmax
    decisions have margin (on the port's chain)."""
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
    tp = model[3]
    rt = Runtime(device="cpu")
    hub = Device("hub", device="cpu")
    srv = hub.add_pipeline(ms.serve_pipeline(model="mamba2-smoke", slots=2,
                                             max_seq=MAX_SEQ))
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
            break
    return rt, runs


def test_served_answers_match_jax(model, served):
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


def test_a_decode_tick_leaves_inactive_slots_state_as_it_was(model):
    tcfg, tp = model[2], model[3]
    _, c1 = tt.lm_prefill(tp, tcfg, torch.tensor([[3, 4, 5], [6, 7, 8]]),
                          MAX_SEQ)
    before = [{k: v.clone() for k, v in c.items()} for c in c1["layers"]]
    active = torch.tensor([False, True])
    token = torch.tensor([1, 2], dtype=torch.int32)
    out = tt.serve_decode_step(tp, tcfg, c1, token, active)
    assert int(out[0]) == 1 and c1["pos"].tolist() == [3, 4]
    for c, b in zip(c1["layers"], before):
        for k in ("h", "conv"):
            assert torch.equal(c[k][0], b[k][0]), k
            assert not torch.equal(c[k][1], b[k][1]), k


def test_stage_replay_carries_the_ssd_state(model):
    """Five replay steps of a parked stream in slot 1: its tokens are
    ``sequential_decode``'s there, and its parked SSD state is bitwise row
    1 of a batch-2 cache stepped by ``serve_decode_step``."""
    tcfg, tp = model[2], model[3]
    el = ModelServeStageElement(model="mamba2-smoke", slots=2,
                                max_seq=MAX_SEQ, stage=0, n_stages=1)
    el._device = torch.device("cpu")
    prompt, gen = list(range(7, 27)), 6
    tok, cache = el.host_stage_prefill(tp, prompt)
    ref = tt.cache_init(tcfg, 2, MAX_SEQ, "cpu")
    for d, c in zip(ref["layers"], cache["layers"]):
        for k in c:
            d[k][1:2].copy_(c[k])
    ref["pos"][1] = cache["pos"][0]
    token = torch.tensor([0, int(tok[0])], dtype=torch.int32)
    active = torch.tensor([False, True])
    got = [int(tok[0])]
    for _ in range(gen - 1):
        tok, cache = el.host_stage_decode(tp, tok, cache, slot=1)
        token = tt.serve_decode_step(tp, tcfg, ref, token, active)
        got.append(int(tok[0]))
        assert int(token[1]) == got[-1]
        for c, r in zip(cache["layers"], ref["layers"]):
            assert torch.equal(c["h"][0], r["h"][1])
            assert torch.equal(c["conv"][0], r["conv"][1])
    assert got == ms.sequential_decode(tp, tcfg, prompt, gen, MAX_SEQ,
                                       slots=2, slot=1, device="cpu")
