"""Tenant-aware admission control — the QoS scheduling core (DESIGN.md §9).

A copy of ``src/repro/core/admission.py`` (framework-free).  The port's
serve path runs it at ``qos=None``: global-FIFO pass-through plus the ledger.

The among-device pitch only works at scale if the serving fabric can tell
tenants apart, enforce budgets, and shed load explicitly (arXiv 2210.10514
names exactly this gap: multi-tenant scheduling across heterogeneous
consumer devices).  Before this module every client was equal and the only
overload behavior was the request Channel's leaky drop — an unaccounted,
silent loss.  Now every batcher in ``core/batching.py`` runs its queueing
through ONE :class:`AdmissionQueue`:

* **ingest** — wire requests pop off the endpoint Channel into per-tenant
  session queues (``tenant_id`` rides the routing meta from
  ``tensor_query_client``).  A :class:`TenantSpec` may bound the tenant
  with a token-bucket rate budget (``rate``/``burst``, refilled on the
  scheduler tick clock) and a queue cap (``max_queue``); requests over
  budget are SHED — counted per tenant per reason, and surfaced to the
  client as an explicit error (never a silent drop).
* **take** — the dequeue replacing the implicit channel FIFO.  With no
  :class:`QoSConfig` the queue is a pure FIFO pass-through (global arrival
  order, bitwise the pre-QoS fabric — the load-bearing default).  With QoS
  enabled, scheduling is weighted-fair across PRIORITY CLASSES with
  earliest-deadline-first within a class:

  1. classes (distinct tenant priorities with queued work) are stride-
     scheduled: the class with the lowest virtual pass wins and its pass
     advances by ``1 / weight(class)`` — a non-empty class is never
     starved, its wait is bounded by the total weight in flight;
  2. within the class, the tenant whose HEAD request has the earliest
     ``(deadline, arrival)`` is served — per-tenant FIFO holds by
     construction (only queue heads compete, and a tenant's deadlines are
     monotone in arrival order since the offset is per-spec).

* **expire** — queued requests past their tenant deadline shed with reason
  ``"deadline"``; the deadline clock is the scheduler tick, so it keeps
  running wherever the request waits (including parked frames — the
  runtime applies the same spec to its park ledger).
* **conservation** — every record is exactly one of served / shed /
  queued / in-flight, so ``admitted == served + shed + queued + in_flight``
  at every instant; ``Runtime.stats()`` asserts the law over the merged
  per-tenant ledgers.

Scheduling changes ORDERING and ADMISSION, never answers: a request that
is served flows through the exact serve path it always did, so the
batched/sharded/fused/staged bitwise parity pins are out of scope by
construction (DESIGN.md §9 spells out the contract).
"""
from __future__ import annotations

import itertools
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["TenantSpec", "QoSConfig", "AdmissionRecord", "AdmissionQueue",
           "DEFAULT_TENANT", "percentile_from_hist", "merge_tenant_stats"]

#: tenant every untagged request books under — keeps single-tenant
#: deployments (and the entire pre-QoS test corpus) on one ledger without
#: clients ever naming a tenant
DEFAULT_TENANT = "default"

_INF = float("inf")


@dataclass(frozen=True)
class TenantSpec:
    """Per-tenant admission contract.

    ``priority`` 0 is the most urgent class; ``weight`` is the WFQ share
    (default ``1 / 2**priority`` — each class up weighs twice the one
    below).  ``rate``/``burst`` form a token bucket refilled on the tick
    clock (``rate`` tokens/tick up to ``burst``; None = unmetered).
    ``deadline_ticks`` bounds queue wait (EDF key + expiry);
    ``max_queue`` bounds backlog per endpoint."""

    tenant_id: str = DEFAULT_TENANT
    priority: int = 1
    weight: Optional[float] = None
    rate: Optional[float] = None
    burst: Optional[float] = None
    deadline_ticks: Optional[int] = None
    max_queue: Optional[int] = None

    @property
    def effective_weight(self) -> float:
        if self.weight is not None:
            return max(self.weight, 1e-9)
        return 1.0 / (2.0 ** max(0, self.priority))

    @property
    def effective_burst(self) -> float:
        if self.burst is not None:
            return self.burst
        # default headroom: one tick of rate, floor 1 (a rate under 1/tick
        # still admits singles as the bucket trickles full)
        return max(1.0, self.rate if self.rate is not None else 1.0)


class QoSConfig:
    """Admission policy for a runtime: tenant specs + serve capacity.

    ``serve_per_tick`` caps how many requests ALL tenants may dequeue per
    scheduler tick per endpoint (None = unbounded — the default keeps the
    edge-client serve-before-return contract intact); requests over the
    cap stay queued and are served next tick in QoS order."""

    def __init__(self, tenants: Tuple[TenantSpec, ...] = (),
                 default: Optional[TenantSpec] = None,
                 serve_per_tick: Optional[int] = None):
        self.tenants: Dict[str, TenantSpec] = {t.tenant_id: t
                                               for t in tenants}
        self.default = default or TenantSpec()
        self.serve_per_tick = serve_per_tick

    def spec(self, tenant_id: str) -> TenantSpec:
        return self.tenants.get(tenant_id, self.default)


@dataclass
class AdmissionRecord:
    """One admitted request: the raw wire buffer plus its scheduling key."""

    raw: Any
    tenant: str
    seq: int
    enqueue_tick: int
    deadline: float = _INF          # absolute tick; _INF = no deadline
    priority: int = 1
    client_id: Optional[int] = None

    def order_key(self) -> Tuple:
        """(priority, deadline, arrival) — the slot-admission sort key the
        streaming batcher reuses for its waiting list (DESIGN.md §9)."""
        return (self.priority, self.deadline, self.seq)


class _TenantState:
    __slots__ = ("spec", "queue", "tokens", "last_refill", "admitted",
                 "served", "shed", "shed_reasons", "in_flight", "latency")

    def __init__(self, spec: TenantSpec, now: int):
        self.spec = spec
        self.queue: deque = deque()
        self.tokens = spec.effective_burst
        self.last_refill = now
        self.admitted = 0
        self.served = 0
        self.shed = 0
        self.shed_reasons: Counter = Counter()
        self.in_flight = 0
        #: tick-latency histogram: wait ticks -> count (exact percentiles —
        #: latencies are small ints, a Counter beats reservoir sampling)
        self.latency: Counter = Counter()

    def refill(self, now: int):
        if self.spec.rate is None:
            return
        dt = now - self.last_refill
        if dt > 0:
            self.tokens = min(self.spec.effective_burst,
                              self.tokens + self.spec.rate * dt)
        self.last_refill = now


class AdmissionQueue:
    """The shared queueing/shedding/accounting core behind every batcher.

    ``qos=None`` (the default) is a pure FIFO pass-through: ``take``
    returns global arrival order, nothing is ever shed or reordered, and
    the only cost over the old channel ``pop_n`` is the ledger — the
    bitwise-parity contract rests on this mode being exact.

    ``clock`` is the scheduler tick source (deadline + token-bucket
    clock); standalone use defaults to a monotonic counter so every
    ``take`` round is its own tick."""

    def __init__(self, qos: Optional[QoSConfig] = None,
                 clock: Optional[Callable[[], int]] = None):
        self.qos = qos
        if clock is None:
            counter = itertools.count()
            clock = lambda: next(counter)           # noqa: E731
        self.clock = clock
        self._tenants: Dict[str, _TenantState] = {}
        self._seq = itertools.count()
        self._queued = 0
        self._queued_by_client: Counter = Counter()
        #: client_id -> FIFO of shed reasons awaiting client notification
        #: (the runtime answers each with an explicit error frame)
        self._notices: Dict[Any, deque] = {}
        #: stride-scheduler virtual pass per priority class
        self._class_pass: Dict[int, float] = {}
        #: serve budget bookkeeping (serve_per_tick)
        self._budget_tick: Optional[int] = None
        self._budget_used = 0

    # -- introspection ---------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.qos is not None

    def __len__(self) -> int:
        return self._queued

    def backlog(self) -> int:
        """Queued + in-flight — the queue-depth half of the broker's
        scaling signal."""
        return self._queued + sum(t.in_flight
                                  for t in self._tenants.values())

    def queued_for(self, client_id) -> int:
        return self._queued_by_client.get(client_id, 0)

    def pop_notice(self, client_id) -> Optional[str]:
        """One shed reason awaiting delivery to ``client_id`` (pop-once);
        None when the client has no pending shed notice."""
        q = self._notices.get(client_id)
        if not q:
            return None
        reason = q.popleft()
        if not q:
            del self._notices[client_id]
        return reason

    def _state(self, tenant_id: str) -> _TenantState:
        ts = self._tenants.get(tenant_id)
        if ts is None:
            spec = (self.qos.spec(tenant_id) if self.qos is not None
                    else TenantSpec(tenant_id))
            ts = self._tenants[tenant_id] = _TenantState(spec, self.clock())
        return ts

    # -- ingest ----------------------------------------------------------------
    def ingest(self, raw) -> Optional[AdmissionRecord]:
        """Admit one wire request into its tenant's session queue, or shed
        it (rate budget / queue cap) with explicit accounting.  Returns the
        record, or None when shed."""
        meta = getattr(raw, "meta", {}) or {}
        tenant_id = meta.get("tenant_id", DEFAULT_TENANT)
        now = self.clock()
        ts = self._state(tenant_id)
        ts.admitted += 1
        client_id = meta.get("client_id")
        if self.enabled:
            spec = ts.spec
            if spec.max_queue is not None and \
                    len(ts.queue) >= spec.max_queue:
                return self._shed_at_ingest(ts, client_id, "queue-full")
            if spec.rate is not None:
                ts.refill(now)
                if ts.tokens < 1.0:
                    return self._shed_at_ingest(ts, client_id, "rate")
                ts.tokens -= 1.0
            deadline = (now + spec.deadline_ticks
                        if spec.deadline_ticks is not None else _INF)
            priority = spec.priority
        else:
            deadline, priority = _INF, 1
        rec = AdmissionRecord(raw=raw, tenant=tenant_id,
                              seq=next(self._seq), enqueue_tick=now,
                              deadline=deadline, priority=priority,
                              client_id=client_id)
        ts.queue.append(rec)
        self._queued += 1
        if client_id is not None:
            self._queued_by_client[client_id] += 1
        return rec

    def ingest_channel(self, channel) -> int:
        """Drain every pending wire request off the endpoint Channel into
        the admission queues (the gather half of queue-gather-flush)."""
        n = 0
        while True:
            raw = channel.pop()
            if raw is None:
                return n
            if self.ingest(raw) is not None:
                n += 1

    def _shed_at_ingest(self, ts: _TenantState, client_id,
                        reason: str) -> None:
        ts.shed += 1
        ts.shed_reasons[reason] += 1
        if client_id is not None:
            self._notices.setdefault(client_id, deque()).append(reason)
        return None

    # -- deadline expiry -------------------------------------------------------
    def expire(self) -> int:
        """Shed queued requests past their tenant deadline (reason
        ``"deadline"``).  Per-tenant deadlines are monotone in arrival
        order (constant offset), so only queue heads need checking."""
        if not self.enabled or self._queued == 0:
            return 0
        now = self.clock()
        expired = 0
        for ts in self._tenants.values():
            while ts.queue and ts.queue[0].deadline <= now and \
                    ts.queue[0].deadline is not _INF and \
                    ts.queue[0].deadline != _INF:
                rec = ts.queue.popleft()
                self._dequeued(rec)
                ts.shed += 1
                ts.shed_reasons["deadline"] += 1
                if rec.client_id is not None:
                    self._notices.setdefault(rec.client_id,
                                             deque()).append("deadline")
                expired += 1
        return expired

    def _dequeued(self, rec: AdmissionRecord):
        self._queued -= 1
        if rec.client_id is not None:
            self._queued_by_client[rec.client_id] -= 1
            if self._queued_by_client[rec.client_id] <= 0:
                del self._queued_by_client[rec.client_id]

    # -- dequeue (the scheduling function) -------------------------------------
    def _budget_left(self) -> float:
        if self.qos is None or self.qos.serve_per_tick is None:
            return _INF
        now = self.clock()
        if now != self._budget_tick:
            self._budget_tick = now
            self._budget_used = 0
        return self.qos.serve_per_tick - self._budget_used

    def take(self, limit: Optional[int] = None) -> List[AdmissionRecord]:
        """Dequeue up to ``limit`` records (None = all available) in
        scheduling order; each moves to in-flight until ``mark_served`` /
        ``mark_shed`` closes it."""
        budget = self._budget_left()
        n = self._queued if limit is None else min(limit, self._queued)
        n = int(min(n, budget)) if budget != _INF else n
        if n <= 0:
            return []
        out: List[AdmissionRecord] = []
        if not self.enabled:
            # pure FIFO pass-through: global arrival order, exactly the
            # channel semantics the parity pins were built on
            while len(out) < n:
                ts = min((t for t in self._tenants.values() if t.queue),
                         key=lambda t: t.queue[0].seq)
                out.append(self._pop_head(ts))
        else:
            while len(out) < n:
                classes: Dict[int, List[_TenantState]] = {}
                for t in self._tenants.values():
                    if t.queue:
                        classes.setdefault(t.spec.priority, []).append(t)
                if not classes:
                    break
                cls = self._pick_class(classes)
                ts = min(classes[cls],
                         key=lambda t: (t.queue[0].deadline,
                                        t.queue[0].seq))
                out.append(self._pop_head(ts))
        self._budget_used += len(out)
        return out

    def _pick_class(self, classes: Dict[int, List[_TenantState]]) -> int:
        """Stride scheduling across priority classes: min virtual pass
        wins, pass advances by the inverse class weight.  A class entering
        with work starts at the current minimum pass (it earns service at
        once but cannot claim retroactive credit), so no non-empty class
        ever waits more than ``total_weight / weight`` dequeues."""
        floor = min((self._class_pass[c] for c in classes
                     if c in self._class_pass), default=0.0)
        for c in classes:
            self._class_pass[c] = max(self._class_pass.get(c, floor), floor)
        cls = min(classes, key=lambda c: (self._class_pass[c], c))
        w = sum(t.spec.effective_weight for t in classes[cls])
        self._class_pass[cls] += 1.0 / max(w, 1e-9)
        return cls

    def _pop_head(self, ts: _TenantState) -> AdmissionRecord:
        rec = ts.queue.popleft()
        self._dequeued(rec)
        ts.in_flight += 1
        return rec

    # -- closing the ledger ----------------------------------------------------
    def mark_served(self, rec: AdmissionRecord):
        ts = self._state(rec.tenant)
        ts.in_flight -= 1
        ts.served += 1
        ts.latency[max(0, self.clock() - rec.enqueue_tick)] += 1

    def mark_shed(self, rec: AdmissionRecord, reason: str,
                  notify: bool = True):
        """Close an in-flight record as shed.  ``notify=False`` for sheds
        the failover fabric already answers (a dead endpoint's requests
        re-dispatch from their PendingQuery records — the client gets a
        real answer elsewhere, not an error)."""
        ts = self._state(rec.tenant)
        ts.in_flight -= 1
        ts.shed += 1
        ts.shed_reasons[reason] += 1
        if notify and rec.client_id is not None:
            self._notices.setdefault(rec.client_id,
                                     deque()).append(reason)

    def shed_queued(self, reason: str, notify: bool = False,
                    on_shed=None) -> int:
        """Shed EVERYTHING still queued (endpoint death: requests already
        ingested are invisible to the down event's channel purge and must
        reach the ledger explicitly).  ``on_shed(rec)``, when given, fires
        per record — the delivery guard uses it to forget a shed request's
        dedup id so its failover re-dispatch is admittable (§10)."""
        total = 0
        for ts in self._tenants.values():
            while ts.queue:
                rec = ts.queue.popleft()
                self._dequeued(rec)
                ts.shed += 1
                ts.shed_reasons[reason] += 1
                if notify and rec.client_id is not None:
                    self._notices.setdefault(rec.client_id,
                                             deque()).append(reason)
                if on_shed is not None:
                    on_shed(rec)
                total += 1
        return total

    # -- stats -----------------------------------------------------------------
    def stats(self) -> Dict[str, Dict]:
        """Per-tenant ledgers: the conservation counters plus the raw
        latency histogram (merged and percentiled by ``Runtime.stats``)."""
        out: Dict[str, Dict] = {}
        for tid, ts in self._tenants.items():
            out[tid] = {
                "priority": ts.spec.priority,
                "admitted": ts.admitted,
                "served": ts.served,
                "shed": ts.shed,
                "queued": len(ts.queue),
                "in_flight": ts.in_flight,
                "shed_reasons": dict(ts.shed_reasons),
                "latency_hist": dict(ts.latency),
            }
        return out


# ---------------------------------------------------------------------------
# Stats plumbing shared by Runtime.stats, the benchmark, and the example
# ---------------------------------------------------------------------------

def percentile_from_hist(hist: Dict[int, int], q: float) -> float:
    """Exact q-quantile (0..1) of a ``value -> count`` histogram; 0.0 when
    empty (nothing measured is nothing late)."""
    total = sum(hist.values())
    if total == 0:
        return 0.0
    rank = q * (total - 1)
    seen = 0
    for value in sorted(hist):
        seen += hist[value]
        if seen > rank:
            return float(value)
    return float(max(hist))


def merge_tenant_stats(into: Dict[str, Dict], part: Dict[str, Dict]):
    """Fold one admission queue's per-tenant ledgers into an aggregate
    (counters add, histograms add, priority keeps the first seen)."""
    for tid, st in part.items():
        agg = into.setdefault(tid, {
            "priority": st.get("priority", 1), "admitted": 0, "served": 0,
            "shed": 0, "queued": 0, "in_flight": 0, "shed_reasons": {},
            "latency_hist": {}})
        for k in ("admitted", "served", "shed", "queued", "in_flight"):
            agg[k] += st.get(k, 0)
        for r, n in st.get("shed_reasons", {}).items():
            agg["shed_reasons"][r] = agg["shed_reasons"].get(r, 0) + n
        for v, n in st.get("latency_hist", {}).items():
            agg["latency_hist"][v] = agg["latency_hist"].get(v, 0) + n
    return into
