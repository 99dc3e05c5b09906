"""Pipeline-parallel serving as stage hops (DESIGN.md §8) in the port, on
the CPU, against the JAX package.

Port of ``tests/test_pp_staged_serving.py`` (its soak's twin is in
``test_torch_soak.py``; its shard_map cross-check, red in the JAX
package, is not ported).  The
``stablelm-smoke-4l`` preset splits into N ``model_serve_stage``
pipelines, one Device each; the port serves the JAX package's weights
(``params_from_numpy``, each stage given its slice).  Pinned:

* at N = 2 and 4 with 1, 4 and 8 clients and mixed generation lengths,
  every answer equals the JAX package's ``sequential_decode`` and is
  bitwise the port's own, replayed in the answer's serve slot; the
  chain's answers equal the monolithic server's, mid-generation joins and
  leaves included;
* a mid-chain stage killed with a standby: answers bitwise the fault-free
  twin's, no token dropped, ``prefills == streams_started``, the stage
  replayed from the retained activations; with no standby the chain
  stalls and resumes;
* a downstream stage swap recovers by the same replay and serves the
  composite model (old slices, the new one); a stage-0 swap replays whole
  streams;
* per-stage conservation ``dispatched == completed + failed``;
* each scenario also runs in the JAX package: sink logs and the whole
  ``failover``/``reconfig``/``query_batching``/``tenants`` stats equal;
* a replay step is bitwise the decode hop's row, and its memo keeps a
  replayed hop id from stepping a cache twice;
* the stages of a chain get distinct cached executables, and the graph
  route equals ``jit=False`` (the CPU stand-in graph here; CUDA graphs,
  with launch counts, in the ``cuda`` tests).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.element import element_factory as jfactory
from repro.launch import model_serve as jax_ms
from repro.runtime import Device as JDevice
from repro_torch.core import plan as plan_mod
from repro_torch.core.batching import StagedStreamingBatcher
from repro_torch.core.buffers import tree_flatten
from repro_torch.core.element import element_factory
from repro_torch.device import make_generator
from repro_torch.kernels import flash_attn as fa
from repro_torch.launch import model_serve as ms
from repro_torch.models import transformer as tt
from repro_torch.runtime import Device, Runtime
from test_torch_failover import Jax, Port, check_twin, same_logs
from test_torch_graphs import fake_graphs

torch.set_num_threads(2)

pytestmark = pytest.mark.ppstage

MAX_SEQ = 32
MODEL = "stablelm-smoke-4l"
LOGIT_TOL = 1e-4
GEN_MIX = ["4", "3;6", "5", "6;3"]


class W:
    """The JAX package's weights of the preset (the full tree every JAX
    stage draws and slices) and the port's copy."""

    def __init__(self):
        self.jcfg = jax_ms.SERVE_MODELS[MODEL]()
        self.tcfg = ms.SERVE_MODELS[MODEL]()
        run = JDevice("w").add_pipeline(
            jax_ms.serve_pipeline(model=MODEL, slots=8, max_seq=MAX_SEQ),
            jit=False)
        self.jp = run.params["lm"]
        self.tp = tt.params_from_numpy(jax.device_get(self.jp), self.tcfg,
                                       "cpu")


@pytest.fixture(scope="module")
def w():
    return W()


def _mod(pkg):
    return jax_ms if pkg is Jax else ms


def _stage_run(pkg, rt, w, ps, k, n_stages, name, jit):
    dev = pkg.device(name)
    run = dev.add_pipeline(ps, jit=jit)
    if pkg is not Jax:
        run.params["lm"] = tt.stage_params(w.tp, w.tcfg, k, n_stages)
    rt.add_device(dev)
    return dev, run, ps


def staged(pkg, rt, w, n_stages, slots=8, jit=False, model=MODEL):
    """One device per stage; -> [(device, run, pipeline)]."""
    return [_stage_run(pkg, rt, w, ps, k, n_stages, f"stage{k}", jit)
            for k, ps in enumerate(_mod(pkg).staged_serve_pipelines(
                model=model, slots=slots, max_seq=MAX_SEQ,
                n_stages=n_stages))]


def standby(pkg, rt, w, stage, n_stages, slots=8, jit=False, model=MODEL):
    ps = _mod(pkg).stage_pipeline(model=model, slots=slots, max_seq=MAX_SEQ,
                                  stage=stage, n_stages=n_stages)
    return _stage_run(pkg, rt, w, ps, stage, n_stages, f"standby{stage}",
                      jit)


def mono(pkg, rt, w, slots=8):
    dev = pkg.device("hub")
    run = dev.add_pipeline(_mod(pkg).serve_pipeline(
        model=MODEL, slots=slots, max_seq=MAX_SEQ), jit=False)
    if pkg is not Jax:
        run.params["lm"] = w.tp
    rt.add_device(dev)
    return run


def client(pkg, rt, i, prompts, gens, jit=False):
    dev = pkg.device(f"tv{i}")
    run = dev.add_pipeline(_mod(pkg).client_pipeline(prompts=prompts,
                                                     gens=gens), jit=jit)
    rt.add_device(dev)
    return run


def answers(run):
    return [np.asarray(b.tensor).tolist() for b in run.sink_log.get("res", [])]


def coord(rt) -> StagedStreamingBatcher:
    (b,) = [b for b in rt._batchers.values()
            if isinstance(b, StagedStreamingBatcher)]
    return b


def conserved(c):
    st = c.stats()
    assert st["tokens_generated"] == st["tokens_delivered"] + \
        st["tokens_dropped"] + st["tokens_in_flight"]
    for k in range(1, c.n_stages):
        led = c.stage_ledger(k)
        assert led["dispatched"] == led["completed"] + led["failed"], (k, led)
    return st


_JAX_REF = {}


def jax_ref(w, prompt, gen):
    """The JAX package's ``sequential_decode`` (memoized), after checking
    that each of the chain's argmax decisions has a margin above the
    1e-4 logit tolerance, so agreement is not luck."""
    key = (tuple(prompt), gen)
    if key not in _JAX_REF:
        logits, cache = tt.lm_prefill(w.tp, w.tcfg, torch.tensor([prompt]),
                                      MAX_SEQ)
        for step in range(gen):
            top2 = torch.topk(logits[0], 2).values
            assert float(top2[0] - top2[1]) > LOGIT_TOL, (prompt, step)
            if step + 1 < gen:
                logits, cache = tt.lm_decode(w.tp, w.tcfg,
                                             tt.greedy(logits), cache)
        _JAX_REF[key] = jax_ms.sequential_decode(w.jp, w.jcfg, prompt, gen,
                                                 MAX_SEQ)
    return _JAX_REF[key]


def check_sequential(w, run, prompt, gens, min_answers=2):
    got = run.sink_log.get("res", [])
    assert len(got) >= min_answers
    for j, b in enumerate(got):
        ans, gen = np.asarray(b.tensor).tolist(), gens[j % len(gens)]
        assert ans == jax_ref(w, prompt, gen), (prompt, j)
        assert ans == ms.sequential_decode(
            w.tp, w.tcfg, prompt, gen, MAX_SEQ, slots=8,
            slot=b.meta["slot"], device="cpu"), (prompt, j)


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_stages", [2, 4])
@pytest.mark.parametrize("n_clients", [1, 4, 8])
def test_bitwise_vs_sequential_decode(w, n_stages, n_clients):
    """Every answer of the N-stage chain is the full model's sequential
    decode: splitting the layers over hops changes where the compute
    happens, never what it computes."""
    rt = Port.runtime(query_batch=8)
    staged(Port, rt, w, n_stages)
    cls = [client(Port, rt, i, f"{i+1},{i+2},{i+3}",
                  GEN_MIX[i % len(GEN_MIX)]) for i in range(n_clients)]
    rt.run(16)
    for i, run in enumerate(cls):
        gens = [int(g) for g in GEN_MIX[i % len(GEN_MIX)].split(";")]
        check_sequential(w, run, [i + 1, i + 2, i + 3], gens)
    st = conserved(coord(rt))
    assert st["hops_failed"] == 0 and st["tokens_dropped"] == 0
    if n_clients == 8:
        assert st["batched_frames"] > st["decode_ticks"]


def _vs_monolithic(pkg, chaos, w, build):
    rt = pkg.runtime(query_batch=8)
    if build == "staged":
        staged(pkg, rt, w, 2)
    else:
        mono(pkg, rt, w)
    cls = [client(pkg, rt, i, f"{i+1},{i+2}", "5") for i in range(4)]
    rt.run(14)
    return rt, cls, {}


def test_staged_answers_match_monolithic_runtime(w):
    """Same clients, same ticks: the 2-stage chain's answer streams are
    bitwise the monolithic ``model_serve`` runtime's, and the JAX
    package's chain gives the same logs and stats."""
    from chaoslib import Chaos
    port = _vs_monolithic(Port, Chaos, w, "staged")
    check_twin(port, _vs_monolithic(Jax, Chaos, w, "staged"))
    mono_ = _vs_monolithic(Port, Chaos, w, "mono")
    for a, b in zip(port[1], mono_[1]):
        assert len(answers(a)) >= 2
        assert answers(a) == answers(b)
        assert [x.meta["slot"] for x in a.sink_log["res"]] == \
            [x.meta["slot"] for x in b.sink_log["res"]]


def _join_leave(pkg, chaos, w):
    rt = pkg.runtime(query_batch=8)
    staged(pkg, rt, w, 2)
    early = [client(pkg, rt, i, f"{i+1},{i+2}", "8") for i in range(4)]
    rt.run(3)                    # the early streams mid-generation
    late = [client(pkg, rt, 4 + i, f"{i+11}", "3") for i in range(4)]
    rt.run(17)
    return rt, early + late, {}


def test_mid_generation_join_and_leave_staggered(w):
    """Late joiners enter the live slot table mid-chain; downstream stages
    see them only as admit rows of the next hop."""
    from chaoslib import Chaos
    port = _join_leave(Port, Chaos, w)
    check_twin(port, _join_leave(Jax, Chaos, w))
    rt, cls, _ = port
    for i, run in enumerate(cls[:4]):
        check_sequential(w, run, [i + 1, i + 2], [8])
    for i, run in enumerate(cls[4:]):
        check_sequential(w, run, [i + 11], [3], min_answers=3)
    conserved(coord(rt))


# ---------------------------------------------------------------------------
# chaos
# ---------------------------------------------------------------------------

def _kill_with_standby(pkg, chaos, w, fault=True, n_stages=2, stage=1,
                       jit=False, model=MODEL):
    ticks, kill_at = 24, 5
    rt = pkg.runtime(query_batch=8)
    stages = staged(pkg, rt, w, n_stages, jit=jit, model=model)
    standby(pkg, rt, w, stage, n_stages, jit=jit, model=model)
    cls = [client(pkg, rt, i, f"{i+1},{i+2}", "8", jit=jit)
           for i in range(3)]
    harness = chaos(rt)
    if fault:
        dev, _, ps = stages[stage]
        harness.kill_server(kill_at, dev, ps.elements["ssrc"], crash=True)
    harness.run(ticks)
    return rt, cls, dict(harness=harness)


def test_mid_chain_stage_kill_stage_local_replay_bitwise(w):
    """Stage 1 dies at tick 5 with every stream mid-generation: the
    coordinator binds the standby, replays ONLY stage 1's slice from the
    retained activations, and every answer is bitwise the fault-free
    twin's, in the same ticks.  No generation restarts."""
    from chaoslib import Chaos
    port = _kill_with_standby(Port, Chaos, w)
    check_twin(port, _kill_with_standby(Jax, Chaos, w))
    ref = _kill_with_standby(Port, Chaos, w, fault=False)
    rt, got, _ = port
    for r0, r1 in zip(ref[1], got):
        assert len(answers(r1)) >= 2
        assert answers(r0) == answers(r1)
    st = conserved(coord(rt))
    assert st["stage_replays"] >= 1
    assert st["stage_replay_steps"] >= 1
    assert st["tokens_dropped"] == 0
    assert st["prefills"] == st["streams_started"]


def _stall_resume(pkg, chaos, w, fault=True):
    ticks, kill_at, revive_at = 26, 4, 12
    rt = pkg.runtime(query_batch=8)
    stages = staged(pkg, rt, w, 2)
    cls = [client(pkg, rt, i, f"{i+1}", "6") for i in range(2)]
    harness = chaos(rt)
    if fault:
        dev, _, ps = stages[1]
        harness.kill_server(kill_at, dev, ps.elements["ssrc"], crash=True)
        harness.revive_server(revive_at, dev, ps.elements["ssrc"])
    harness.run(ticks)
    return rt, cls, dict(harness=harness)


def test_stage_death_no_standby_stalls_then_resumes(w):
    """No standby: the chain stalls (the failed hops are on the ledger,
    the streams stay in flight) and resumes when the stage revives:
    delayed answers, never different ones."""
    from chaoslib import Chaos
    port = _stall_resume(Port, Chaos, w)
    check_twin(port, _stall_resume(Jax, Chaos, w))
    ref = _stall_resume(Port, Chaos, w, fault=False)
    rt, got, _ = port
    st = conserved(coord(rt))
    assert st["hops_failed"] >= 1
    assert st["tokens_dropped"] == 0
    for r0, r1 in zip(ref[1], got):
        a, b = answers(r0), answers(r1)
        assert len(b) >= 1
        assert a[:len(b)] == b


def _four_stage_kill_revive(pkg, chaos, w):
    rt = pkg.runtime(query_batch=8)
    stages = staged(pkg, rt, w, 4, slots=4)
    cls = [client(pkg, rt, i, f"{i+1},{i+2}", GEN_MIX[i % len(GEN_MIX)])
           for i in range(6)]
    harness = chaos(rt)
    dev, _, ps = stages[2]
    harness.kill_server(6, dev, ps.elements["ssrc"], crash=True)
    harness.revive_server(11, dev, ps.elements["ssrc"])
    harness.run(30)
    return rt, cls, dict(harness=harness)


def test_per_stage_conservation_through_kill_and_revival(w):
    """A 4-stage chain over 4 slots with 6 clients; stage 2 dies mid-run
    and revives.  Every stage's ledger balances, the token law holds, and
    every answer is still the sequential decode."""
    from chaoslib import Chaos
    port = _four_stage_kill_revive(Port, Chaos, w)
    check_twin(port, _four_stage_kill_revive(Jax, Chaos, w))
    rt, cls, _ = port
    c = coord(rt)
    st = conserved(c)
    assert c.stage_ledger(2)["failed"] >= 1
    assert c.stage_ledger(2)["replays"] >= 2     # first sight, revival
    assert st["tokens_dropped"] == 0 and st["streams_finished"] >= 6
    for i, run in enumerate(cls):
        gens = [int(g) for g in GEN_MIX[i % len(GEN_MIX)].split(";")]
        got = run.sink_log.get("res", [])
        assert got
        for j, b in enumerate(got):
            assert np.asarray(b.tensor).tolist() == ms.sequential_decode(
                w.tp, w.tcfg, [i + 1, i + 2], gens[j % len(gens)], MAX_SEQ,
                slots=4, slot=b.meta["slot"], device="cpu")


# ---------------------------------------------------------------------------
# hot swap of a stage
# ---------------------------------------------------------------------------

def composite_ref(shares, cfg, prompt, gen, slots=8, slot=0):
    """Greedy decode of a COMPOSITE staged model (per-stage trees that
    need not come from one init), chaining the port's stage functions at
    the serve batch in ``slot``, as ``sequential_decode`` does."""
    n = len(shares)
    x = torch.tensor([prompt])
    c1 = []
    for k, p in enumerate(shares):
        x, c = tt.stage_prefill(p, cfg, k, n, x, MAX_SEQ)
        c1.append(c)
    tok = tt.greedy(x)
    out = [int(tok[0])]
    caches = []
    for k, c in enumerate(c1):
        full = tt.stage_cache_init(cfg, k, n, slots, MAX_SEQ, "cpu")
        full["pos"][slot] = c["pos"][0]
        for d, s in zip(tree_flatten(full["layers"])[0],
                        tree_flatten(c["layers"])[0]):
            d[slot] = s[0]
        caches.append(full)
    active = torch.zeros(slots, dtype=torch.bool)
    active[slot] = True
    token = torch.zeros(slots, dtype=torch.int32)
    token[slot] = tok[0]
    for _ in range(max(0, gen - 1)):
        x = token
        for k, p in enumerate(shares):
            x, caches[k] = tt.stage_decode(p, cfg, k, n, x, caches[k],
                                           advance=active.to(torch.int32))
        token = tt.greedy(x)
        out.append(int(token[slot]))
    return out


def _stage_swap(pkg, chaos, w, stage, new_params=None, jit=False):
    """Swap stage ``stage``'s ``lm`` of a 2-stage chain for a fresh
    element mid-generation; ``new_params`` (port) replaces the new
    element's params before the commit tick."""
    ticks, swap_at = 24, 4
    rt = pkg.runtime(query_batch=8)
    stages = staged(pkg, rt, w, 2, jit=jit)
    cls = [client(pkg, rt, i, f"{i+3},{i+4}", "8", jit=jit)
           for i in range(3)]
    rt.run(swap_at)
    _, run, ps = stages[stage]
    elem = (jfactory if pkg is Jax else element_factory)(
        "model_serve_stage", model=MODEL, slots="8", max_seq=str(MAX_SEQ),
        stage=str(stage), n_stages="2")
    old = run.params["lm"]
    rng = jax.random.PRNGKey(7) if pkg is Jax else make_generator(7, rt.device)
    rc = rt.reconfigure(run, ps.reconfig().swap("lm", elem), warm_ticks=1,
                        rng=rng)
    if new_params is not None:
        rc.new_params["lm"] = new_params
    rt.run(2)
    pre = [len(answers(r)) for r in cls]
    rt.run(ticks - swap_at - 2)
    return rt, cls, dict(rc=rc, stages=stages, old=old, pre=pre)


def _bridged_swap(w, stage):
    """The JAX swap, then the port's on the JAX swap's new slice."""
    from chaoslib import Chaos
    jax_ = _stage_swap(Jax, Chaos, w, stage)
    jnew = jax_[2]["rc"].new_params["lm"]
    tnew = tt.params_from_numpy(jax.device_get(jnew), w.tcfg, "cpu")
    return _stage_swap(Port, Chaos, w, stage, new_params=tnew), jax_


def test_swap_downstream_stage_mid_decode(w):
    """Swapping stage 1's serve element mid-generation bumps its epoch
    fence; the coordinator replays stage 1's slice onto the NEW element.
    No stream drops or restarts, every stream runs to full length, and
    the generations started after the commit are bitwise the composite
    model's (old stage 0, new stage 1)."""
    port, jax_ = _bridged_swap(w, 1)
    check_twin(port, jax_)
    rt, cls, ex = port
    rc, stages = ex["rc"], ex["stages"]
    assert rc.status == "committed"
    ps1 = stages[1][2]
    assert ps1.elements["ssrc"].endpoint.spec["serve_epoch"] >= 1
    assert stages[1][1].params["lm"] is not ex["old"]
    st = conserved(coord(rt))
    assert st["stage_replays"] >= 2          # first sight, then the swap
    assert st["tokens_dropped"] == 0
    assert st["prefills"] == st["streams_started"]
    shares = [stages[0][1].params["lm"], stages[1][1].params["lm"]]
    for i, run in enumerate(cls):
        got = run.sink_log["res"]
        assert len(got) >= 2 and all(len(b.tensor) == 8 for b in got)
        for b in got[1:]:
            assert np.asarray(b.tensor).tolist() == composite_ref(
                shares, w.tcfg, [i + 3, i + 4], 8, slot=b.meta["slot"])


def test_swap_stage_zero_replays_whole_streams(w):
    """Swapping stage 0 (the coordinator's own pipeline) replays every
    in-flight stream from its prompt on the new epoch, as a monolithic
    hot swap does: its partial tokens are declared drops, and every
    answer delivered after the commit is the composite model's."""
    port, jax_ = _bridged_swap(w, 0)
    check_twin(port, jax_)
    rt, cls, ex = port
    assert ex["rc"].status == "committed"
    st = conserved(coord(rt))
    assert st["replays"] == 3 and st["tokens_dropped"] > 0
    assert st["prefills"] == st["streams_started"] + st["replays"]
    stages = ex["stages"]
    shares = [stages[0][1].params["lm"], stages[1][1].params["lm"]]
    for i, (run, pre) in enumerate(zip(cls, ex["pre"])):
        got = run.sink_log["res"]
        assert len(got) > pre
        for b in got[pre:]:
            assert np.asarray(b.tensor).tolist() == composite_ref(
                shares, w.tcfg, [i + 3, i + 4], 8, slot=b.meta["slot"])


def test_stage_swap_releases_the_retired_binding(w, monkeypatch):
    """Through the stand-in graph: a stage swap releases the binding keyed
    on the retired slice, so the live graphs do not grow."""
    from chaoslib import Chaos
    fake_graphs(monkeypatch)
    rt = Port.runtime(query_batch=8)
    stages = staged(Port, rt, w, 2, jit=True)
    for i in range(2):
        client(Port, rt, i, f"{i+1},{i+2}", "6", jit=True)
    rt.run(4)
    before = plan_mod.executable_cache_info()["graphs"]
    _, run, ps = stages[1]
    held = run.params        # no later tensor takes the retired addresses
    rc = rt.reconfigure(run, ps.reconfig().swap("lm", element_factory(
        "model_serve_stage", model=MODEL, slots="8", max_seq=str(MAX_SEQ),
        stage="1", n_stages="2")), warm_ticks=1,
        rng=make_generator(3, rt.device))
    Chaos(rt).run(8)
    assert rc.status == "committed" and held is not run.params
    assert before == 2       # one decode binding a stage
    assert plan_mod.executable_cache_info()["graphs"] <= before
    conserved(coord(rt))
    plan_mod.clear_executable_cache()


# ---------------------------------------------------------------------------
# the stage element: replay steps and their memo
# ---------------------------------------------------------------------------

def _stage_elem(w, stage, n_stages, slots=4):
    ps = ms.stage_pipeline(model=MODEL, slots=slots, max_seq=MAX_SEQ,
                           stage=stage, n_stages=n_stages)
    ps.realize()
    elem = ps.elements["lm"]
    return elem, tt.stage_params(w.tp, w.tcfg, stage, n_stages), \
        elem.init_state("cpu")


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_replay_step_is_bitwise_the_hop_row(w, stage):
    """A stream parked at stage k and replayed one step in slot 2 gets
    the cache and output the batch hop computes for that row, while the
    other rows hold other streams: replay rebuilds a stage bitwise."""
    elem, params, st = _stage_elem(w, stage, 4)
    g = torch.Generator().manual_seed(stage)
    d = w.tcfg.d_model
    last = stage == 3
    prompts = [torch.randn((1, 5 + i, d), generator=g) for i in range(4)]
    parked = [elem.host_stage_prefill(params, p)[1] for p in prompts]
    hop = elem.admit(st, elem.build_hop(
        None, None, [(s, c) for s, c in enumerate(parked)]))
    x = torch.randn((4, 1, d), generator=g)
    active = torch.tensor([True, True, True, False])
    y = elem._hop_out(*tt.stage_decode(
        params, w.tcfg, stage, 4, x, st["cache"],
        advance=active.to(torch.int32))[:1], active)
    out, cache = elem.host_stage_decode(params, x[2:3], parked[2], 2)
    assert torch.equal(out, y[2:3])
    assert hop.meta == {"empty": True}
    assert torch.equal(cache["pos"], st["cache"]["pos"][2:3])
    for a, b in zip(tree_flatten(cache["layers"])[0],
                    tree_flatten(st["cache"]["layers"])[0]):
        assert torch.equal(a, b[2:3])
    assert out.dtype == (torch.int32 if last else torch.float32)


def test_idempotent_replay_memo(w):
    """A replayed hop id returns the memoized (out, cache) and never
    steps the parked cache twice; no id steps every time; the memo keeps
    the last 64 ids."""
    elem, params, _ = _stage_elem(w, 1, 2)
    x = torch.randn((1, 4, w.tcfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    _, cache = elem.host_stage_prefill(params, x)
    step = x[:, -1:]
    a = elem.host_stage_decode_idempotent(params, step, cache, 1,
                                          hop_id=(9, 1))
    assert int(cache["pos"][0]) == 5
    b = elem.host_stage_decode_idempotent(params, step, cache, 1,
                                          hop_id=(9, 1))
    assert b is a and int(cache["pos"][0]) == 5
    elem.host_stage_decode_idempotent(params, step, cache, 1)
    elem.host_stage_decode_idempotent(params, step, cache, 1)
    assert int(cache["pos"][0]) == 7
    for i in range(2, 70):
        elem.host_stage_decode_idempotent(params, step, cache, 1,
                                          hop_id=(9, i))
    assert len(elem._hop_memo) == 64 and (9, 1) not in elem._hop_memo
    assert int(cache["pos"][0]) == 7 + 68


def test_stage_entry_points_have_no_cpu_fallback(w):
    """Without ``device="cpu"`` a stage pipeline, its cache and its
    weights go to the card, and raise on a machine without one; with it
    they live on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA rule cannot be seen")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Device("stage1").add_pipeline(ms.stage_pipeline(
            model=MODEL, slots=2, max_seq=8, stage=1, n_stages=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.stage_cache_init(w.tcfg, 0, 2, 2, 8)
    run = Port.device("stage1").add_pipeline(ms.stage_pipeline(
        model=MODEL, slots=2, max_seq=8, stage=1, n_stages=2))
    assert run.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in tree_flatten(
        (run.params, run.state))[0] if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# cached executables: one per stage, graph route == jit=False
# ---------------------------------------------------------------------------

def _serve_ticks(stages):
    return [run.pipe.plan.compiled_serve_tick(run.state)
            for _, run, _ in stages]


def test_four_stage_chain_gets_distinct_executables(w, monkeypatch):
    """Each stage's serve tick is its own cached entry, keyed by (stage,
    n_stages), with one decode binding each."""
    fake_graphs(monkeypatch)
    rt = Port.runtime(query_batch=8)
    stages = staged(Port, rt, w, 4, jit=True)
    client(Port, rt, 0, "1,2,3", "5", jit=True)
    rt.run(6)
    ticks = _serve_ticks(stages)
    assert len({id(t) for t in ticks}) == 4
    assert [run.pipe.plan.serve_stage for _, run, _ in stages] == \
        [(k, 4) for k in range(4)]
    assert all(run.pipe.plan.stage_serving for _, run, _ in stages)
    assert [t.graphs() for t in ticks] == [1, 1, 1, 1]
    plan_mod.clear_executable_cache()


def test_graph_route_equals_eager_through_stage_kill(w, monkeypatch):
    """Through the stand-in graph: a 4-stage chain with a standby for
    stage 2, killed mid-chain, gives the ``jit=False`` route's answers,
    logs and stats."""
    from chaoslib import Chaos
    fake_graphs(monkeypatch)
    graph = _kill_with_standby(Port, Chaos, w, n_stages=4, stage=2, jit=True)
    eager = _kill_with_standby(Port, Chaos, w, n_stages=4, stage=2)
    check_twin(graph, eager)
    assert plan_mod.executable_cache_info()["graphs"] >= 4
    assert coord(graph[0]).stats()["stage_replay_steps"] >= 1
    plan_mod.clear_executable_cache()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plan_mod.clear_executable_cache()
    yield torch.device("cuda")
    plan_mod.clear_executable_cache()


class Card(Port):
    @staticmethod
    def runtime(**kw):
        return Runtime(**kw)

    @staticmethod
    def device(name):
        return Device(name)


def _to_card(tree):
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_card(v) for v in tree)
    return tree.cuda() if isinstance(tree, torch.Tensor) else tree


FLASH = "stablelm-smoke-4l-flash"


@pytest.mark.cuda
def test_staged_graph_route_equals_eager_on_card(w, card):
    """On the card: real CUDA graphs of a 4-stage chain with a standby
    (flash attention: K5's fp32 route, K6), through a mid-chain kill, give
    the ``jit=False`` route's answers and stats with equal K5/K6 launch
    counts, and the CPU path's answers."""
    import dataclasses
    from chaoslib import Chaos
    ms.register_serve_model(FLASH, lambda: dataclasses.replace(
        ms.SERVE_MODELS[MODEL](), use_flash_attn=True))
    cw = W.__new__(W)
    cw.__dict__.update(w.__dict__, tp=_to_card(w.tp))
    counts = []
    runs = []
    for jit in (True, False):
        before = dict(fa.LAUNCHES)
        runs.append(_kill_with_standby(Card, Chaos, cw, n_stages=4, stage=2,
                                       jit=jit, model=FLASH))
        counts.append({k: fa.LAUNCHES[k] - before.get(k, 0)
                       for k in fa.LAUNCHES})
    check_twin(runs[0], runs[1])
    assert counts[0] == counts[1]
    assert counts[0]["flash_attention"] > 0 and counts[0]["flash_decode"] > 0
    assert plan_mod.executable_cache_info()["graphs"] >= 4
    assert coord(runs[0][0]).stats()["stage_replay_steps"] >= 1
    cpu = _kill_with_standby(Port, Chaos, w, n_stages=4, stage=2,
                             model=FLASH)
    same_logs(runs[0][1], cpu[1])


@pytest.mark.cuda
def test_four_stage_chain_gets_distinct_executables_on_card(w, card):
    """On the card: one CUDA graph per stage, each its own entry."""
    rt = Card.runtime(query_batch=8)
    cw = W.__new__(W)
    cw.__dict__.update(w.__dict__, tp=_to_card(w.tp))
    stages = staged(Card, rt, cw, 4, jit=True)
    client(Card, rt, 0, "1,2,3", "6", jit=True)
    rt.run(6)
    ticks = _serve_ticks(stages)
    assert len({id(t) for t in ticks}) == 4
    assert [t.graphs() for t in ticks] == [1, 1, 1, 1]
