"""Control-plane broker — the MQTT analogue (paper §4.2).

A copy of ``src/repro/core/broker.py`` (framework-free; the port keeps its
own so it imports nothing of the JAX package).

The broker carries *control* traffic only in HYBRID mode (discovery,
capability negotiation, liveness, failover), exactly like the paper's
MQTT-hybrid protocol; in RELAY mode it also relays the data plane (pure MQTT),
which the paper measures to be the bandwidth bottleneck (Fig. 7).

Topics follow MQTT semantics: '/'-separated levels, subscriptions may use
'+' (one level) and '#' (all remaining levels) wildcards — the paper's
example: servers "/objdetect/mobilev3" and "/objdetect/yolov2", client
subscribes "/objdetect/#" and the broker picks one (R3), failing over to the
alternative when the connected one dies (R4).

Liveness (DESIGN.md §3): a registration may carry a **lease** — it must be
refreshed by :meth:`Broker.heartbeat` or it expires ``lease_ticks`` broker
ticks after the last beat (``Broker.tick`` is the lease clock; the runtime
scheduler drives it once per scheduler tick and heartbeats on behalf of its
live devices).  ``mark_down`` (crash notice) and lease expiry both fire a
single ``"down"`` watch event; a downed registration does NOT come back by
merely heartbeating again — the device must :meth:`Broker.revive` (or
re-register), which fires ``"register"``, exactly like an MQTT client
reconnecting with a fresh CONNECT after its keep-alive lapsed.

Selection (R3) is capability-aware: ``Binding`` ranks matching registrations
by :meth:`Broker.rank_key` — preferred codec support, declared throughput,
current load (maintained by the runtime from its stats), registration order
as the deterministic tiebreak — instead of first-match.  A newly registered
(or revived) publisher that outranks the bound one wins the binding back.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .formats import Caps

__all__ = ["Broker", "Registration", "Binding", "topic_matches",
           "BrokerError"]


class BrokerError(RuntimeError):
    pass


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT topic-filter matching with '+' and '#'."""
    pp = pattern.strip("/").split("/")
    tt = topic.strip("/").split("/")
    for i, p in enumerate(pp):
        if p == "#":
            return True
        if i >= len(tt):
            return False
        if p != "+" and p != tt[i]:
            return False
    return len(pp) == len(tt)


@dataclass
class Registration:
    """A published service/stream: topic + caps + declared specs (the paper:
    servers may declare 'workload status' and 'model and version' for clients
    to choose)."""

    topic: str
    caps: Caps
    endpoint: Any                      # publisher object (data-plane handle)
    specs: Dict[str, Any] = field(default_factory=dict)
    alive: bool = True
    reg_id: int = 0
    #: missed-heartbeat tolerance in broker ticks; None = no lease (the
    #: registration never expires on its own)
    lease_ticks: Optional[int] = None
    #: broker tick of the last heartbeat (or registration/revival)
    last_beat: int = 0
    #: current workload — refreshed by the runtime from its stats; lower
    #: ranks better (the paper's "server workload status")
    load: float = 0.0
    #: why the registration went down ("crash" | "lease-expired"), for
    #: diagnostics and the chaos harness's assertions
    down_reason: Optional[str] = None
    #: lease-expiry is SUSPICION, not declared death (DESIGN.md §10): under
    #: a lossy control plane a silent server may be alive behind a
    #: partition.  A suspected registration fails over exactly like a
    #: crashed one (clients must not wait on a maybe-corpse), but it stays
    #: eligible for :meth:`Broker.heal` when its beats resume — a crash
    #: notice clears the flag (that death is declared, not inferred).
    suspected: bool = False

    def describe(self) -> str:
        extra = ", ".join(f"{k}={v}" for k, v in self.specs.items())
        return f"{self.topic} [{self.caps.describe()}] {extra}".strip()


def _as_float(v, default: float = 0.0) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


class Broker:
    """In-process MQTT-analogue. Subscribers get *bindings* that auto-fail-over
    across compatible registrations (R4)."""

    def __init__(self, name: str = "broker",
                 lease_ticks: Optional[int] = None):
        self.name = name
        self._regs: Dict[int, Registration] = {}
        self._ids = itertools.count(1)
        self._watchers: List[Callable[[str, Registration], None]] = []
        #: lease applied to registrations that don't declare their own
        self.default_lease_ticks = lease_ticks
        #: lease clock (advanced by :meth:`tick`)
        self.now = 0
        self.expiries = 0
        # suspicion ledger (DESIGN.md §10): lease expiries that were only
        # ever suspicion, and how many of those healed when beats resumed
        self.suspicions = 0
        self.heals = 0
        # data-plane accounting for RELAY transport benchmarking
        self.relay_bytes = 0
        self.relay_msgs = 0

    # -- publish side ----------------------------------------------------------
    def register(self, topic: str, caps: Caps, endpoint: Any,
                 lease_ticks: Optional[int] = None, **specs) -> Registration:
        reg = Registration(
            topic=topic, caps=caps, endpoint=endpoint, specs=specs,
            reg_id=next(self._ids),
            lease_ticks=(lease_ticks if lease_ticks is not None
                         else self.default_lease_ticks),
            last_beat=self.now)
        self._regs[reg.reg_id] = reg
        self._notify("register", reg)
        return reg

    def unregister(self, reg: Registration):
        if reg.reg_id not in self._regs:
            return  # already gone — never double-deliver the event
        reg.alive = False
        self._regs.pop(reg.reg_id, None)
        self._notify("unregister", reg)

    def mark_down(self, reg: Registration, reason: str = "crash"):
        """Liveness loss without clean unregister (device crash / lease
        expiry).  Idempotent: a registration already down fires nothing.
        A crash is DECLARED death — it clears any standing suspicion (the
        device really is gone; there is nothing left to heal)."""
        if reason == "crash":
            reg.suspected = False
        if not reg.alive:
            return
        reg.alive = False
        reg.down_reason = reason
        self._notify("down", reg)

    # -- liveness: leases & heartbeats -----------------------------------------
    def heartbeat(self, reg: Registration) -> bool:
        """Refresh a live registration's lease.  A downed registration stays
        down (it must :meth:`revive` — the MQTT reconnect) — returns False."""
        if reg.reg_id not in self._regs or not reg.alive:
            return False
        reg.last_beat = self.now
        return True

    def revive(self, reg: Registration) -> Registration:
        """Re-register a previously downed registration under its original
        ``reg_id`` — the device came back and reclaims the rank it held
        before the outage.  Fires ``"register"``; idempotent on live regs."""
        self._regs.setdefault(reg.reg_id, reg)
        reg.suspected = False
        if reg.alive:
            return reg
        reg.alive = True
        reg.down_reason = None
        reg.last_beat = self.now
        self._notify("register", reg)
        return reg

    def heal(self, reg: Registration) -> bool:
        """Clear a FALSE suspicion: the device's heartbeats resumed, so the
        lease expiry was delay/partition, not death (DESIGN.md §10).  The
        win-back is the ordinary revive ``"register"`` event — in-flight
        work already re-dispatched to survivors is NOT recalled (it was
        at-least-once the moment it retransmitted; receiver dedup makes the
        double-serve harmless).  Returns False unless the registration is
        down under standing suspicion."""
        if reg.alive or not reg.suspected:
            return False
        self.heals += 1
        self.revive(reg)
        return True

    def tick(self, n: int = 1):
        """Advance the lease clock; expire registrations whose lease lapsed.
        Expiry is a ``mark_down`` (fires ``"down"``) — bindings fail over
        exactly as on a crash notice."""
        for _ in range(n):
            self.now += 1
            for reg in list(self._regs.values()):
                if reg.alive and reg.lease_ticks is not None and \
                        self.now - reg.last_beat > reg.lease_ticks:
                    self.expiries += 1
                    # silence is evidence, not proof: the expiry fails the
                    # registration over like a crash, but as SUSPICION —
                    # resumed beats can heal it (§10)
                    reg.suspected = True
                    self.suspicions += 1
                    self.mark_down(reg, reason="lease-expired")

    # -- discovery -------------------------------------------------------------
    def discover(self, topic_filter: str,
                 require: Optional[Dict[str, Any]] = None) -> List[Registration]:
        out = []
        for reg in self._regs.values():
            if not reg.alive:
                continue
            if not topic_matches(topic_filter, reg.topic):
                continue
            if require and any(reg.specs.get(k) != v for k, v in require.items()):
                continue
            out.append(reg)
        return sorted(out, key=lambda r: r.reg_id)

    def rank_key(self, reg: Registration,
                 prefer: Optional[Dict[str, Any]] = None) -> Tuple:
        """Sort key for capability-aware selection — LOWER ranks better.

        Order of importance: (1) pipeline-stage fit (an among-device chain
        coordinator asking for stage k ranks servers declaring a DIFFERENT
        ``stage`` behind those declaring k or nothing — a wildcard
        subscription over a chain's topics must never bind a hop to the
        wrong layer slice), (2) tenant affinity (a replica declaring
        ``tenants=(...)`` that lacks the client's tenant ranks behind one
        that pins it or declares nothing — soft isolation, DESIGN.md §9),
        (3) preferred-codec support (a server declaring ``codecs=(...)``
        that lacks the client's codec ranks behind one that has it — absent
        declaration means "anything goes"), (4) declared ``throughput``
        (higher better), (5) current ``load`` (lower better),
        (6) registration order — the deterministic tiebreak that preserves
        the pre-ranking first-match behavior when nobody declares anything.
        """
        prefer = prefer or {}
        stage = prefer.get("stage")
        declared_stage = reg.specs.get("stage")
        stage_miss = 1 if (stage is not None and declared_stage is not None
                           and int(_as_float(declared_stage, -1))
                           != int(stage)) else 0
        tenant = prefer.get("tenant")
        declared_tenants = reg.specs.get("tenants")
        tenant_miss = 1 if (tenant is not None
                            and declared_tenants is not None
                            and tenant not in declared_tenants) else 0
        codec = prefer.get("codec")
        declared = reg.specs.get("codecs")
        codec_miss = 1 if (codec not in (None, "none") and declared is not None
                           and codec not in declared) else 0
        return (stage_miss, tenant_miss, codec_miss,
                -_as_float(reg.specs.get("throughput")),
                _as_float(reg.load), reg.reg_id)

    def scaling_signal(self, topic_filter: str = "query/#"
                       ) -> Dict[str, Dict[str, float]]:
        """Per-topic capacity picture for elastic serving (DESIGN.md §9):
        live replica count plus summed / mean / max observed ``reg.load``
        (the runtime refreshes load every heartbeat from each endpoint's
        queue depth + admission backlog + active decode slots).  The
        autoscaler turns this into §6 add/remove reconfigurations — the
        broker only OBSERVES; it never owns replica lifecycle."""
        topics: Dict[str, Dict[str, float]] = {}
        for reg in self._regs.values():
            if not reg.alive or not topic_matches(topic_filter, reg.topic):
                continue
            t = topics.setdefault(reg.topic, {"replicas": 0, "load": 0.0,
                                              "max_load": 0.0})
            t["replicas"] += 1
            t["load"] += _as_float(reg.load)
            t["max_load"] = max(t["max_load"], _as_float(reg.load))
        for t in topics.values():
            t["mean_load"] = t["load"] / t["replicas"] if t["replicas"] \
                else 0.0
        return topics

    def subscribe(self, topic_filter: str,
                  prefer: Optional[Dict[str, Any]] = None,
                  **require) -> "Binding":
        return Binding(self, topic_filter, require or None, prefer=prefer)

    def _notify(self, event: str, reg: Registration):
        for w in list(self._watchers):
            w(event, reg)

    def watch(self, fn: Callable[[str, Registration], None]):
        self._watchers.append(fn)

    def unwatch(self, fn: Callable[[str, Registration], None]):
        try:
            self._watchers.remove(fn)
        except ValueError:
            pass

    # -- RELAY data plane -------------------------------------------------------
    def relay(self, payload_nbytes: int):
        """Account one broker-relayed frame (pure-MQTT data plane)."""
        self.relay_bytes += payload_nbytes
        self.relay_msgs += 1


class Binding:
    """A live subscription that resolves to the best-ranked registration and
    transparently fails over (R4).

    Candidates are ranked by :meth:`Broker.rank_key` (codec support,
    throughput, load, registration order) and filtered by data-plane
    liveness (an endpoint whose ``alive`` flag dropped is skipped even
    before the broker learns of the death — lease expiry lags a silent
    crash by up to ``lease_ticks``).  A registration that appears (or
    revives) and outranks the current one wins the binding back.
    """

    def __init__(self, broker: Broker, topic_filter: str,
                 require: Optional[Dict[str, Any]],
                 prefer: Optional[Dict[str, Any]] = None):
        self.broker = broker
        self.topic_filter = topic_filter
        self.require = require
        self.prefer = prefer
        self.current: Optional[Registration] = None
        self.failovers = 0
        self.closed = False
        broker.watch(self._on_event)
        self._rebind()

    def _candidates(self) -> List[Registration]:
        cands = [r for r in self.broker.discover(self.topic_filter, self.require)
                 if getattr(r.endpoint, "alive", True)]
        cands.sort(key=lambda r: self.broker.rank_key(r, self.prefer))
        return cands

    def _rebind(self) -> Optional[Registration]:
        cands = self._candidates()
        prev = self.current
        self.current = cands[0] if cands else None
        if prev is not None and self.current is not None and prev is not self.current:
            self.failovers += 1
        return self.current

    def _on_event(self, event: str, reg: Registration):
        if event in ("down", "unregister") and reg is self.current:
            self._rebind()
        elif event == "register" and \
                topic_matches(self.topic_filter, reg.topic):
            if self.current is None:
                self._rebind()
            elif reg is not self.current and \
                    self.broker.rank_key(reg, self.prefer) < \
                    self.broker.rank_key(self.current, self.prefer):
                # a better publisher appeared (or the preferred one came
                # back): win the binding over exactly once
                self._rebind()

    def close(self):
        """Stop receiving broker events (drop the watcher registration)."""
        if not self.closed:
            self.broker.unwatch(self._on_event)
            self.closed = True

    @property
    def endpoint(self):
        if self.current is None:
            raise BrokerError(
                f"no live publisher for {self.topic_filter!r}"
                + (f" with {self.require}" if self.require else ""))
        return self.current.endpoint
