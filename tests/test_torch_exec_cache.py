"""The port's executable registry against the JAX package's LRU semantics
(``tests/test_exec_cache.py``), on the CPU:

* the registry is capped at 128 fingerprints, and the 129th distinct
  topology evicts the least recently used one;
* touching an entry refreshes its recency;
* an evicted topology that comes back builds a fresh entry with the same
  results;
* the executable count stays consistent through eviction;
* anonymous (auto-named) pipelines never alias each other's executables,
  named identical topologies do;
* evicting an entry frees its CUDA graphs, and ``executable_cache_info``
  counts the graphs the cached executables hold (here through the
  stand-in graph of ``test_torch_graphs.py``; 0 on the CPU otherwise).

Each case also runs against the JAX registry, so the two stay alike.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import parse_launch as jparse
from repro.core import plan as jplan
from repro_torch.core import parse_launch
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import (_EXEC_CACHE, _EXEC_CACHE_MAX,
                                   clear_executable_cache,
                                   executable_cache_info)
from test_torch_graphs import fake_graphs

torch.set_num_threads(2)


def _pipe(width: int, name: str = "s"):
    return parse_launch(
        f"testsrc name={name} width={width} height=2 ! tensor_converter "
        f"name=c ! appsink name=o").realize()


@pytest.fixture(autouse=True)
def fresh_cache():
    clear_executable_cache()
    jplan.clear_executable_cache()
    yield
    clear_executable_cache()
    jplan.clear_executable_cache()


def _run(pipe, steps=1):
    params, st = pipe.init(None, "cpu"), pipe.init_state("cpu")
    for _ in range(steps):
        out, st = pipe.compiled_step()(params, st)
    return out


def test_cap_is_128_and_oldest_evicted():
    assert _EXEC_CACHE_MAX == jplan._EXEC_CACHE_MAX == 128
    plans = [_pipe(w + 1).plan for w in range(_EXEC_CACHE_MAX + 2)]
    for p in plans:
        p._cache()
    assert len(_EXEC_CACHE) == _EXEC_CACHE_MAX
    assert plans[0].fingerprint not in _EXEC_CACHE
    assert plans[1].fingerprint not in _EXEC_CACHE
    assert plans[2].fingerprint in _EXEC_CACHE
    assert plans[-1].fingerprint in _EXEC_CACHE


def test_touch_refreshes_recency():
    a, b = _pipe(3).plan, _pipe(4).plan
    a._cache(), b._cache()
    a._cache()
    assert list(_EXEC_CACHE) == [b.fingerprint, a.fingerprint]


def test_reencounter_after_eviction_rebuilds_cleanly(monkeypatch):
    monkeypatch.setattr(plan_mod, "_EXEC_CACHE_MAX", 2)
    pipe_a = _pipe(3)
    first = pipe_a.compiled_step()
    ref = _run(pipe_a)
    for w in (5, 6):
        _run(_pipe(w))
    assert pipe_a.plan.fingerprint not in _EXEC_CACHE
    out = _run(pipe_a)
    assert pipe_a.plan.fingerprint in _EXEC_CACHE
    assert pipe_a.compiled_step() is not first
    assert torch.equal(ref["o"].tensor, out["o"].tensor)
    # the JAX package's reference output is the same frame
    jpipe = jparse("testsrc name=s width=3 height=2 ! tensor_converter "
                   "name=c ! appsink name=o").realize()
    jout, _ = jpipe.compiled_step()(jpipe.init(jax.random.PRNGKey(0)),
                                    jpipe.init_state())
    np.testing.assert_array_equal(out["o"].tensor.numpy(),
                                  np.asarray(jout["o"].tensor))


def test_eviction_keeps_executable_count_consistent(monkeypatch):
    monkeypatch.setattr(plan_mod, "_EXEC_CACHE_MAX", 2)
    monkeypatch.setattr(jplan, "_EXEC_CACHE_MAX", 2)
    for w in range(3, 8):
        _pipe(w).compiled_step()
        jparse(f"testsrc name=s width={w} height=2 ! tensor_converter "
               f"name=c ! appsink name=o").realize().compiled_step()
    info = executable_cache_info()
    assert info == {"fingerprints": 2, "executables": 2, "graphs": 0}
    assert jplan.executable_cache_info() == {"fingerprints": 2,
                                             "executables": 2}


ANON = ("testsrc width=6 height=2 ! tensor_converter ! "
        "tensor_transform mode=arithmetic option=typecast:float32 ! appsink")


def test_anonymous_pipelines_get_fresh_fingerprints():
    p1, p2 = parse_launch(ANON).realize(), parse_launch(ANON).realize()
    assert p1.plan.fingerprint != p2.plan.fingerprint
    assert p1.compiled_step() is not p2.compiled_step()
    assert executable_cache_info()["fingerprints"] == 2


def test_anonymous_results_still_agree():
    p1, p2 = parse_launch(ANON).realize(), parse_launch(ANON).realize()
    (s1,), (s2,) = _run(p1).values(), _run(p2).values()
    assert torch.equal(s1.tensor, s2.tensor)


def test_named_pipelines_do_alias():
    desc = ("testsrc name=s width=6 height=2 ! tensor_converter name=c ! "
            "appsink name=o")
    p1, p2 = parse_launch(desc).realize(), parse_launch(desc).realize()
    assert p1.plan.fingerprint == p2.plan.fingerprint
    assert p1.compiled_step() is p2.compiled_step()
    # re-realizing (the failover re-wire path) keeps the fingerprint
    fp = p1.plan.fingerprint
    p1._realized = False
    p1.realize()
    assert p1.plan.fingerprint == fp and \
        p1.compiled_step() is p2.compiled_step()


def test_eviction_frees_graphs_and_the_info_counts_them(monkeypatch):
    fake_graphs(monkeypatch, donate=True)
    monkeypatch.setattr(plan_mod, "_EXEC_CACHE_MAX", 2)
    a = _pipe(3)
    fn = a.compiled_step()
    _run(a, steps=3)                        # eager, capture, replay
    assert fn.graphs() == 1 and fn.captures == 1
    assert executable_cache_info()["graphs"] == 1
    # two pipelines of one named topology share the entry, each its graph
    b = _pipe(3)
    assert b.compiled_step() is fn
    _run(b, steps=2)
    assert fn.graphs() == 2
    assert executable_cache_info() == {"fingerprints": 1, "executables": 1,
                                       "graphs": 2}
    for w in (5, 6):
        _run(_pipe(w), steps=2)
    assert a.plan.fingerprint not in _EXEC_CACHE
    assert fn.graphs() == 0                 # evicted, so released
    assert executable_cache_info()["graphs"] == 2
