"""Live reconfiguration — prepare/warm/commit hot swap (DESIGN.md §6).

Port of ``src/repro/core/reconfig.py``.  A topology edit is a runtime
operation with prepare → warm → commit → drain semantics:

* **prepare** — the edit script (:class:`ReconfigPlan`) is applied to a
  *shadow* copy of the live topology: unchanged elements are SHARED by
  identity (their channels, bindings and queued frames carry over), new
  elements are fresh and get params from the request's ``torch.Generator``.
  A caps error here rolls back before anything observable changed.
* **warm** — the shadow plan's entries are created in the fingerprint-keyed
  executable cache (``core/plan.py``) for every key the live plan holds:
  an unchanged fingerprint is a cache hit and creates nothing.  On the card
  an entry is a :class:`~.graphs.GraphedCallable`, and a graph cannot be
  captured against state that exists only at commit, so a new binding runs
  eagerly on its first post-commit call and captures on its second.
* **commit** — at a tick boundary: the run's pipe, params and state swap to
  the shadow's, removed elements retire (registrations unregister, clients
  re-bind, batchers drop), new broker-facing elements wire in, and the
  graph bindings keyed on the retired params and state are released, so
  graph memory stays bounded across swap cycles.
* **drain** — a run with a frame paused at a query client does not cut
  over mid-frame: the commit defers (``draining``) until it resolves.

Failover is the UNPLANNED half of the same machinery: the broker's
liveness events route through :meth:`ReconfigManager.on_broker_event`, one
copy of the endpoint lifecycle (:func:`teardown_endpoint` /
:func:`activate_endpoint`) for planned removals, additions, crashes and
revivals alike.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..device import make_generator
from .pipeline import Link, Pipeline
from .plan import release_bindings, tensor_ptrs
from .pubsub import MqttSink, MqttSrc
from . import netfault
from .query import (QueryServerEndpoint, TensorQueryClient,
                    TensorQueryServerSrc)

__all__ = ["ReconfigError", "ReconfigPlan", "Reconfiguration",
           "ReconfigManager", "teardown_endpoint", "activate_endpoint"]


class ReconfigError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Endpoint lifecycle — ONE copy, shared by planned and unplanned edits
# ---------------------------------------------------------------------------

def teardown_endpoint(ep: QueryServerEndpoint) -> int:
    """Take a query-server endpoint out of service: stop serving now and
    purge its channels.  Queued requests are orphans the scheduler
    re-dispatches from its own PendingQuery records (their count is
    returned for the orphan ledger); the per-client response channels are
    released outright, so a stale answer from before a death never
    satisfies a frame after a revival."""
    ep.alive = False
    orphans = len(ep.requests)
    _book_purges(ep)
    ep.requests.q.clear()
    ep.responses.clear()
    return orphans


def activate_endpoint(ep: QueryServerEndpoint):
    """Bring a query-server endpoint (back) into service as a fresh epoch:
    whatever a previous life left queued is invalid, and returning clients
    get new response channels on their first routed answer."""
    ep.alive = True
    _book_purges(ep)
    ep.requests.q.clear()
    ep.responses.clear()


def _book_purges(ep: QueryServerEndpoint):
    """Book the frames a teardown or activation is about to clear on their
    fault links (a no-op outside chaos runs): a purged frame left the
    network accounted, so the per-link conservation law sees it as
    ``purged``, not forever ``in_flight``."""
    netfault.note_purged(ep.requests, len(ep.requests.q))
    for ch in ep.responses.values():
        netfault.note_purged(ch, len(ch.q))


# ---------------------------------------------------------------------------
# Edit script
# ---------------------------------------------------------------------------

class ReconfigPlan:
    """A topology edit script against a live pipeline.

    Edits are recorded, not applied; :meth:`apply_to` materializes them on
    a shadow copy whose unchanged elements are the LIVE objects.
    Vocabulary: ``swap(name, new_elem)`` (the new element adopts ``name``,
    so param and state keys stay aligned), ``relink(src, dst, ...)``,
    ``add(elem)``, ``link(src, dst, ...)`` and ``remove(name)`` (removing
    every element decommissions the run at commit)."""

    def __init__(self, pipe: Pipeline):
        self.pipe = pipe
        self._edits: List[Tuple] = []

    def swap(self, name: str, new_elem) -> "ReconfigPlan":
        self._edits.append(("swap", name, new_elem))
        return self

    def relink(self, src: str, dst: str, src_pad: int = 0,
               dst_pad: int = 0) -> "ReconfigPlan":
        self._edits.append(("relink", src, dst, src_pad, dst_pad))
        return self

    def add(self, elem) -> "ReconfigPlan":
        self._edits.append(("add", elem))
        return self

    def link(self, src: str, dst: str, src_pad: int = 0,
             dst_pad: int = 0) -> "ReconfigPlan":
        self._edits.append(("link", src, dst, src_pad, dst_pad))
        return self

    def remove(self, name: str) -> "ReconfigPlan":
        self._edits.append(("remove", name))
        return self

    def apply_to(self, live: Pipeline) -> Pipeline:
        """Build the shadow: the same element objects where unchanged, fresh
        ``Link`` records throughout (swaps mutate links; the live wiring
        must stay intact for a rollback)."""
        shadow = Pipeline(name=live.name)
        shadow.elements = dict(live.elements)
        shadow.links = [Link(l.src, l.src_pad, l.dst, l.dst_pad)
                        for l in live.links]
        for edit in self._edits:
            kind = edit[0]
            if kind == "swap":
                _, name, new_elem = edit
                old = shadow.elements.get(name)
                if old is None:
                    raise ReconfigError(f"swap: no element {name!r}")
                new_elem.name = name
                shadow.elements[name] = new_elem
                for l in shadow.links:
                    if l.src is old:
                        l.src = new_elem
                    if l.dst is old:
                        l.dst = new_elem
            elif kind == "relink":
                _, src, dst, src_pad, dst_pad = edit
                s, d = self._lookup(shadow, src), self._lookup(shadow, dst)
                shadow.links = [l for l in shadow.links
                                if not (l.dst is d and l.dst_pad == dst_pad)]
                shadow.links.append(Link(s, src_pad, d, dst_pad))
            elif kind == "add":
                _, elem = edit
                if elem.name in shadow.elements:
                    raise ReconfigError(f"add: duplicate name {elem.name!r}")
                shadow.elements[elem.name] = elem
            elif kind == "link":
                _, src, dst, src_pad, dst_pad = edit
                s, d = self._lookup(shadow, src), self._lookup(shadow, dst)
                shadow.links.append(Link(s, src_pad, d, dst_pad))
            elif kind == "remove":
                _, name = edit
                gone = shadow.elements.pop(name, None)
                if gone is None:
                    raise ReconfigError(f"remove: no element {name!r}")
                shadow.links = [l for l in shadow.links
                                if l.src is not gone and l.dst is not gone]
        return shadow

    @staticmethod
    def _lookup(shadow: Pipeline, name: str):
        elem = shadow.elements.get(name)
        if elem is None:
            raise ReconfigError(f"no element {name!r} in topology")
        return elem


# ---------------------------------------------------------------------------
# One reconfiguration: the prepare/warm/commit/drain/rollback state machine
# ---------------------------------------------------------------------------

class Reconfiguration:
    """State machine for one topology edit on one live pipeline run.

    ``pending → prepared → warming → [draining →] committed`` on success;
    a failed prepare or a target death mid-warm lands in ``rolled_back``
    with ``error``/``reason`` recorded.  The manager drives :meth:`commit`
    at tick boundaries only.  ``rng`` is the ``torch.Generator`` new
    elements draw their params from (default: seed 0 on the run's
    device)."""

    def __init__(self, runtime, run, plan: ReconfigPlan,
                 warm_ticks: int = 1,
                 rng: Optional[torch.Generator] = None,
                 kind: str = "planned"):
        self.runtime = runtime
        self.run = run
        self.plan = plan
        self.warm_ticks = max(0, int(warm_ticks))
        self.rng = rng
        self.kind = kind
        self.requested_tick = runtime.ticks
        self.status = "pending"
        self.reason: Optional[str] = None
        self.error: Optional[Exception] = None
        self.shadow: Optional[Pipeline] = None
        self.new_params: Optional[dict] = None
        self.frames_carried = 0
        self.committed_tick: Optional[int] = None

    # -- prepare ---------------------------------------------------------------
    def prepare(self) -> "Reconfiguration":
        """Build and realize the shadow topology off the serving path.  New
        consumer-side elements (mqttsrc, query clients) connect to the
        broker here so caps discovery sees the real publishers; publisher
        registration (mqttsink, serversrc) waits for commit."""
        try:
            shadow = self.plan.apply_to(self.run.pipe)
            live = self.run.pipe.elements
            for e in shadow.elements.values():
                if live.get(e.name) is e:
                    continue
                if isinstance(e, (MqttSrc, TensorQueryClient)) \
                        and e.broker is None:
                    e.connect(self.runtime.broker)
            shadow.realize()
            self.new_params = self._carry_params(shadow)
            # the shadow realize re-negotiated the SHARED elements' caps;
            # restore the live topology's (both fingerprints are cached)
            self.run.pipe._realized = False
            self.run.pipe.realize()
            self.shadow = shadow
            self.status = "prepared"
        except Exception as exc:  # caps error, bad edit
            self.error = exc
            self.rollback("prepare-failed")
        return self

    def _carry_params(self, shadow: Pipeline) -> dict:
        """Kept elements keep their live param entries; new elements init
        fresh from ``rng``, in topo order (params are static across ticks,
        so prepare time is safe; STATE is taken at commit)."""
        live = self.run.pipe.elements
        dev = self.run.device
        rng = self.rng if self.rng is not None else make_generator(0, dev)
        params: dict = {}
        for elem in shadow._order:
            if live.get(elem.name) is elem:
                if elem.name in self.run.params:
                    params[elem.name] = self.run.params[elem.name]
            else:
                p = elem.init_params(rng, dev)
                if p:
                    params[elem.name] = p
        return params

    def _carry_state_from(self, old_pipe: Pipeline) -> dict:
        """Kept elements keep their live state entries; new elements get a
        fresh one on the run's device."""
        state: dict = {}
        for elem in self.shadow._order:
            if old_pipe.elements.get(elem.name) is elem:
                if elem.name in self.run.state:
                    state[elem.name] = self.run.state[elem.name]
            else:
                s = elem.init_state(self.run.device)
                if s:
                    state[elem.name] = s
        return state

    # -- warm ------------------------------------------------------------------
    def warm(self) -> "Reconfiguration":
        """Create the shadow plan's cache entries for every key the live
        plan holds, plus its deferred segments.  An unchanged fingerprint
        hits its entries and creates nothing.  No binding is made here: a
        binding is keyed on the params' and state's addresses, and the state
        of a new element exists only from the commit."""
        if self.status != "prepared":
            return self
        plan = self.shadow.plan
        plan._cache()
        # mesh-keyed entries are replicated under their own key (the
        # runtime's mesh); the meshless ones under theirs
        mesh = self.runtime.mesh
        mesh_fp = plan._mesh_key(mesh)
        for key in list(self.run.pipe.plan._cache()["fns"]):
            if key[0] == "step":
                plan.compiled_step(donate=key[1])
            elif key[0] == "step_n":
                plan.compiled_step_n(
                    hoist_io=key[1], hoist_queries=key[2], donate=key[3],
                    mesh=mesh if key[4] == mesh_fp else None)
            elif key[0] == "serve_batch":
                plan.compiled_serve_batch(
                    donate=key[1], codec=key[3],
                    mesh=mesh if key[2] == mesh_fp else None)
            elif key[0] == "serve_tick":
                # key[-1] is the state's structure: an identical serve
                # topology re-keys to the same entry
                plan._serve_tick_fn(key[1], key[-1])
        if plan.deferred_compilable:
            plan.compiled_deferred_segment(None)
            for idx in plan.client_idxs:
                plan.compiled_deferred_segment(idx)
        self.status = "warming"
        return self

    # -- commit ----------------------------------------------------------------
    def commit(self) -> "Reconfiguration":
        """Cut over at a tick boundary: a handful of pointer moves, plus the
        release of the graph bindings keyed on what left the run."""
        if self.status not in ("prepared", "warming", "draining"):
            return self
        rt, run = self.runtime, self.run
        old_pipe, old_params, old_state = run.pipe, run.params, run.state
        shadow = self.shadow
        self.frames_carried += self._count_carried(old_pipe, shadow)
        # the mesh copies of the old params (the bursts' and the
        # batchers'), whose bindings retire with them
        old_copies = [list(m.by_device.values()) for m in
                      [run.mesh_params] + [b._mesh_params for b in
                                           rt._batchers.values()
                                           if b.run is run]
                      if m is not None]
        run.pipe = shadow
        run.params = self.new_params
        run.state = self._carry_state_from(old_pipe)
        run.mesh_params = None
        release_bindings(tensor_ptrs(old_params, old_state, *old_copies) -
                         tensor_ptrs(run.params, run.state))
        # retire what left the topology (unregister events: clients re-bind,
        # orphans are accounted by the same teardown failover uses)
        for name, e in old_pipe.elements.items():
            if shadow.elements.get(name) is not e:
                rt._retire_element(e)
        if not shadow.elements:
            run.retired = True
            run.step_fn = None
            self.status = "committed"
            self.committed_tick = rt.ticks
            return self
        # wire what joined (publishers register HERE, once they serve) and
        # re-realize with the broker in place: the fingerprint matches the
        # warmed shadow, so this is a cache hit
        dev = rt._device_of(run)
        for e in shadow.elements.values():
            if isinstance(e, (MqttSink, MqttSrc)) and e.sync_clock is None \
                    and dev is not None:
                e.sync_clock = dev.pipeline_clock
        rt._wire(dev, run)
        run.step_fn = run.pipe.compiled_step() \
            if (run.jit and run.pipe.plan.pure) else run.pipe.step
        run.retired = False
        for b in rt._batchers.values():
            if b.run is run:
                b.on_reconfig()
        self.status = "committed"
        self.committed_tick = rt.ticks
        return self

    def _count_carried(self, old_pipe: Pipeline, shadow: Pipeline) -> int:
        """Frames that cross the swap: queued pubsub frames on kept host
        sources and queued requests on kept query-server endpoints.  The
        backlogs of REMOVED subscribers and publishers fold into the run's
        drop accounting."""
        carried = 0
        for name, e in shadow.elements.items():
            if old_pipe.elements.get(name) is not e:
                continue
            if isinstance(e, MqttSrc):
                carried += e.queued()
            elif isinstance(e, TensorQueryServerSrc):
                carried += len(e.endpoint.requests)
        for name, e in old_pipe.elements.items():
            if shadow.elements.get(name) is e:
                continue
            if isinstance(e, MqttSrc):
                self.run.carried_drops += e.drops + len(e._pushback)
                for _, rx in e._rx_hist.values():
                    self.run.carried_drops += len(rx)
            elif isinstance(e, MqttSink):
                self.run.carried_drops += e.channel.drops
        return carried

    # -- rollback --------------------------------------------------------------
    def rollback(self, reason: str) -> "Reconfiguration":
        """Return to the old plan: the live pipeline re-realizes (its
        fingerprint is unchanged, so its entries are hit), bindings opened
        for never-committed elements close, and graph bindings keyed on the
        never-committed params are released."""
        if self.status in ("committed", "rolled_back"):
            return self
        self.reason = reason
        if self.shadow is not None:
            live = self.run.pipe.elements
            for e in self.shadow.elements.values():
                if live.get(e.name) is e:
                    continue
                binding = getattr(e, "binding", None)
                if binding is not None:
                    binding.close()
                    e.binding = None
        if self.new_params is not None:
            release_bindings(tensor_ptrs(self.new_params) -
                             tensor_ptrs(self.run.params, self.run.state))
        # the live topology realized before, so this cannot fail on caps
        self.run.pipe._realized = False
        self.run.pipe.realize()
        self.status = "rolled_back"
        return self


# ---------------------------------------------------------------------------
# Manager: planned requests, tick stepping, and the unplanned path
# ---------------------------------------------------------------------------

class ReconfigManager:
    """Runtime-owned coordinator for every topology change, planned or not.

    Planned: :meth:`request` prepares and warms at once, then :meth:`step`
    (top of every tick) commits once the warm window has passed and the
    run has no paused frame, or rolls back if the target died mid-warm.
    Unplanned: broker liveness events route through
    :meth:`on_broker_event`."""

    def __init__(self, runtime):
        self.rt = runtime
        self.pending: List[Reconfiguration] = []
        self.planned = 0
        self.unplanned = 0
        self.rollbacks = 0
        self.frames_carried = 0
        #: (tick, kind, status, reason), one row per terminal transition
        self.log: List[Tuple[int, str, str, Optional[str]]] = []
        self._in_planned_commit = False

    # -- planned ---------------------------------------------------------------
    def request(self, run, plan: ReconfigPlan, warm_ticks: int = 1,
                rng: Optional[torch.Generator] = None) -> Reconfiguration:
        rc = Reconfiguration(self.rt, run, plan, warm_ticks=warm_ticks,
                             rng=rng)
        rc.prepare()
        if rc.status == "prepared":
            rc.warm()
            self.pending.append(rc)
        else:
            self._note_terminal(rc)
        return rc

    def step(self):
        """Advance every pending reconfiguration at the tick boundary."""
        if not self.pending:
            return
        still: List[Reconfiguration] = []
        for rc in self.pending:
            dev = self.rt._device_of(rc.run)
            if dev is None or not dev.alive:
                rc.rollback("target-dead")
            elif self.rt.ticks - rc.requested_tick > rc.warm_ticks:
                if self.rt._run_in_flight(rc.run):
                    # never cut over mid-frame: paused frames complete on
                    # the epoch they started in
                    rc.status = "draining"
                else:
                    self._in_planned_commit = True
                    try:
                        rc.commit()
                    finally:
                        self._in_planned_commit = False
            if rc.status in ("committed", "rolled_back"):
                self._note_terminal(rc)
            else:
                still.append(rc)
        self.pending = still

    def _note_terminal(self, rc: Reconfiguration):
        if rc.status == "committed":
            self.planned += 1
            self.frames_carried += rc.frames_carried
        else:
            self.rollbacks += 1
        self.log.append((self.rt.ticks, rc.kind, rc.status, rc.reason))

    # -- unplanned (failover = a reconfiguration nobody prepared) --------------
    def on_broker_event(self, event: str, reg):
        """A broker liveness transition on a query-server endpoint, applied
        as an immediate unplanned reconfiguration: teardown on death, a
        fresh-epoch activation on registration or revival.  Initial wiring
        (tick 0) and the events a planned commit fires are not counted as
        reconfigurations; the endpoint lifecycle runs either way."""
        ep = reg.endpoint
        if not isinstance(ep, QueryServerEndpoint):
            return
        counts = self.rt.ticks > 0 and not self._in_planned_commit
        if event in ("down", "unregister"):
            orphans = teardown_endpoint(ep)
            if orphans:
                self.rt.orphaned_requests += orphans
            if counts:
                self.unplanned += 1
                self.log.append((self.rt.ticks, "unplanned", event,
                                 reg.down_reason))
        elif event == "register":
            activate_endpoint(ep)
            if counts:
                self.unplanned += 1
                self.log.append((self.rt.ticks, "unplanned", event, None))

    # -- stats -----------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        return {"reconfigs": self.planned + self.unplanned,
                "planned": self.planned,
                "unplanned": self.unplanned,
                "rollbacks": self.rollbacks,
                "frames_carried": self.frames_carried,
                "pending": len(self.pending)}
