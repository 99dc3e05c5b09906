"""Property tests of the port's delivery layer (``core/netfault.py``)
against the JAX package and against brute-force oracles.

Twins of ``tests/test_netfault_properties.py``: every generated
duplicate/reorder schedule goes through the port's and the JAX package's
:class:`DeliveryGuard`; the verdict sequences, the stats and the window
contents must be equal, and the port must meet the reference's oracles:

* effectively-once: the accepted subsequence is the schedule with every
  repeat deleted (first-arrival order);
* the dedup window is a bounded LRU: never above ``window``, and an id
  among the ``window`` most recently touched never re-admits;
* ``forget`` re-admits exactly once;
* the backoff schedule is monotone, capped, never zero, and reaches a
  fixed point.

Frames are stamped over CPU tensors (inside the port's CRC domain) and
numpy arrays (the JAX package's).
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings, strategies as st

from repro.core import Channel as JChannel
from repro.core.buffers import StreamBuffer as JBuffer
from repro.core import netfault as jnf
from repro_torch.core import Channel
from repro_torch.core.buffers import StreamBuffer
from repro_torch.core import netfault as nf

pytestmark = pytest.mark.netchaos

SCHEDULES = st.lists(st.integers(min_value=0, max_value=11),
                     min_size=1, max_size=40)
WINDOWS = st.integers(min_value=1, max_value=8)
TIMEOUTS = st.integers(min_value=0, max_value=6)
BACKOFFS = st.floats(min_value=1.0, max_value=4.0)
CAPS = st.integers(min_value=1, max_value=64)


def _first_capped_retry(timeout: int, backoff: float, cap: int) -> int:
    """The first retry ``n`` with ``timeout * backoff**n >= cap``: 0 when
    the schedule cannot grow (backoff 1, timeout 0) or starts at the cap;
    found from the logarithm, then corrected by single steps to the exact
    float comparison the schedule makes."""
    if backoff == 1.0 or timeout == 0 or timeout >= cap:
        return 0
    n = max(0, math.ceil(math.log(cap / timeout) / math.log(backoff)))
    while timeout * backoff ** n < cap:
        n += 1
    while n > 0 and timeout * backoff ** (n - 1) >= cap:
        n -= 1
    return n


def _frame(seq):
    return nf.stamp(StreamBuffer(
        tensors=(torch.full((3,), float(seq)),), pts=np.int64(seq),
        meta={}), (1, int(seq)))


def _jframe(seq):
    return jnf.stamp(JBuffer(
        tensors=(np.full((3,), seq, np.float32),), pts=np.int64(seq),
        meta={}), (1, int(seq)))


def _guards(**kw):
    return (nf.DeliveryGuard(nf.DeliveryPolicy(**kw)),
            jnf.DeliveryGuard(jnf.DeliveryPolicy(**kw)))


def _check_both(guards, seq):
    g, jg = guards
    v = g.check(_frame(seq))
    assert v == jg.check(_jframe(seq))
    assert list(g._seen) == list(jg._seen)
    return v


class TestEffectivelyOnce:
    @given(SCHEDULES)
    @settings(max_examples=60)
    def test_accepts_exactly_one_copy_per_id_in_arrival_order(self, sched):
        guards = _guards()
        accepted = [seq for seq in sched if _check_both(guards, seq) == "ok"]
        oracle, seen = [], set()
        for seq in sched:
            if seq not in seen:
                seen.add(seq)
                oracle.append(seq)
        assert accepted == oracle
        assert guards[0].stats()["deduped"] == len(sched) - len(oracle)
        assert guards[0].stats() == guards[1].stats()

    @given(SCHEDULES)
    @settings(max_examples=40)
    def test_verdicts_partition_the_schedule(self, sched):
        guards = _guards()
        for seq in sched:
            assert _check_both(guards, seq) in ("ok", "dup")
        s = guards[0].stats()
        assert s["accepted"] + s["deduped"] == len(sched)
        assert s["rejected_corrupt"] == 0
        assert s == guards[1].stats()


class TestBoundedWindow:
    @given(SCHEDULES, WINDOWS)
    @settings(max_examples=60)
    def test_window_never_exceeds_bound(self, sched, window):
        guards = _guards(window=window)
        for seq in sched:
            _check_both(guards, seq)
            assert len(guards[0]._seen) <= window

    @given(SCHEDULES, WINDOWS)
    @settings(max_examples=60)
    def test_live_ids_never_readmit(self, sched, window):
        guards = _guards(window=window)
        lru = []
        for seq in sched:
            verdict = _check_both(guards, seq)
            if seq in lru:
                assert verdict == "dup"
                lru.remove(seq)
            else:
                assert verdict == "ok"
            lru.append(seq)
            lru[:] = lru[-window:]

    @given(SCHEDULES)
    @settings(max_examples=40)
    def test_forget_readmits_exactly_once(self, sched):
        guards = _guards()
        for seq in sched:
            _check_both(guards, seq)
        target = sched[0]
        for g in guards:
            g.forget((1, target))
        assert _check_both(guards, target) == "ok"
        assert _check_both(guards, target) == "dup"


class TestCorruptSchedules:
    @given(SCHEDULES, st.integers(min_value=0, max_value=2 ** 31))
    @settings(max_examples=40)
    def test_corrupt_copies_never_burn_an_id(self, sched, seed):
        """Every copy goes over a link that corrupts a third of the frames:
        a rejected copy leaves its id unseen, so the accepted subsequence
        is the first INTACT copy of each id, in both packages alike."""
        pol = dict(seed=seed, corrupt=0.34)
        got = []
        for mod, frame, channel in ((nf, _frame, Channel),
                                    (jnf, _jframe, JChannel)):
            fabric = mod.FaultFabric()
            ch = channel(capacity=4)
            link = fabric.install(ch, mod.FaultPolicy(**pol))
            guard = mod.DeliveryGuard(mod.DeliveryPolicy())
            verdicts = []
            for seq in sched:
                ch.push(frame(seq))
                verdicts.append(guard.check(ch.pop(), ch))
            fabric.assert_conservation()
            got.append((verdicts, guard.stats(), link.stats()))
            fabric.uninstall(ch)
        assert got[0] == got[1]
        verdicts = got[0][0]
        seen = set()
        for seq, v in zip(sched, verdicts):
            if v != "corrupt":
                assert v == ("dup" if seq in seen else "ok")
                seen.add(seq)


class TestBackoffSchedule:
    @given(TIMEOUTS, BACKOFFS, CAPS)
    @settings(max_examples=80)
    def test_monotone_capped_and_never_zero(self, timeout, backoff, cap):
        pol = nf.DeliveryPolicy(timeout_ticks=timeout, backoff=backoff,
                                max_backoff_ticks=cap)
        sched = [pol.retry_in(k) for k in range(10)]
        assert all(t >= 1 for t in sched)
        assert all(t <= max(cap, 1) for t in sched)
        assert all(a <= b for a, b in zip(sched, sched[1:]))
        jpol = jnf.DeliveryPolicy(timeout_ticks=timeout, backoff=backoff,
                                  max_backoff_ticks=cap)
        assert sched == [jpol.retry_in(k) for k in range(10)]

    @given(TIMEOUTS, BACKOFFS, CAPS)
    @settings(max_examples=40)
    @example(1, 1.0390625, 11)          # still growing after 64 retries
    @example(3, 1.0, 7)                 # backoff 1: constant from the start
    @example(0, 2.5, 9)                 # timeout 0: 1 tick from the start
    @example(1, math.nextafter(1.0, 2.0), 64)          # 1 ulp above 1
    @example(5, 1.0 + 4 * 2.0 ** -52, 6)               # 4 ulps above 1
    def test_reaches_the_cap_and_stays(self, timeout, backoff, cap):
        """The schedule reaches its fixed point at the first retry ``n``
        where ``timeout * backoff**n >= cap`` (at once for backoff 1 or
        timeout 0) and stays there; it never decreases on the way, however
        far away ``n`` is, and equals the JAX package's everywhere."""
        pol = nf.DeliveryPolicy(timeout_ticks=timeout, backoff=backoff,
                                max_backoff_ticks=cap)
        jpol = jnf.DeliveryPolicy(timeout_ticks=timeout, backoff=backoff,
                                  max_backoff_ticks=cap)
        n = _first_capped_retry(timeout, backoff, cap)
        fixed = max(1, min(timeout, cap)) if n == 0 else max(cap, 1)
        at = [n, n + 1, n + 63]
        assert [pol.retry_in(k) for k in at] == [fixed] * 3
        assert fixed <= max(cap, 1)
        # the climb: every retry for a short one, 257 samples of a long
        # one (a backoff a few ulps above 1 climbs for ~1e16 retries),
        # always with the last retries before n
        if n <= 256:
            climb = list(range(n + 1))
        else:
            climb = sorted({n * i // 256 for i in range(257)} |
                           set(range(n - 8, n + 1)))
        sched = [pol.retry_in(k) for k in climb]
        assert all(a <= b for a, b in zip(sched, sched[1:]))
        assert all(1 <= t <= max(cap, 1) for t in sched)
        if n > 0:
            assert pol.retry_in(n - 1) < fixed or fixed == 1
        probe = climb + at + list(range(64))
        assert [pol.retry_in(k) for k in probe] == \
            [jpol.retry_in(k) for k in probe]
