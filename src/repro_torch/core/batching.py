"""Server-side batching for the query protocol — port of
``src/repro/core/batching.py``.

:class:`QueryBatcher` is the stateless gather-stack-flush batcher, with the
codec-fused wire path (DESIGN.md §5).  :class:`StreamingQueryBatcher` runs
the continuous-batching lifecycle of a ``stream_serving`` server (DESIGN.md
§7): prefill on arrival, decode ticks in a slot of the plan-state batch,
one answer when the generation budget is spent.  A dead endpoint never
serves: its admitted requests close as ``server-died`` sheds on the orphan
ledger and re-dispatch from the scheduler's PendingQuery records, and a
streaming server's live streams become declared drops that regenerate by
prefill replay (DESIGN.md §3, §7).  :class:`StageQueryBatcher` and
:class:`StagedStreamingBatcher` serve one model split into stage
pipelines, boundary activations hopping stage to stage (DESIGN.md §8).

With the delivery layer on (DESIGN.md §10) every batcher ingests through
a :class:`~.netfault.DeliveryGuard`: corrupt requests are rejected,
duplicates dedup and re-fire the committed answer from the replay cache,
and a shed-unserved request's delivery id leaves the dedup window so its
re-dispatch is served.  The staged coordinator's hops become
at-least-once: stamped, retransmitted synchronously under one delivery
id, their answers guarded.

Requests drain through one :class:`~.admission.AdmissionQueue` (DESIGN.md
§9).  At ``qos=None`` it is global arrival order plus the per-tenant
ledger, bit for bit the pre-QoS fabric.  With a
:class:`~.admission.QoSConfig` it sheds over-budget requests with a
reason, expires queued ones past their tenant's deadline, caps dequeues at
``serve_per_tick`` and orders them by priority class, then deadline; a
streaming server also gives its free slots to waiting streams in
``(priority, deadline, arrival)`` order.  Scheduling changes order and
admission, never answers.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .admission import AdmissionQueue, QoSConfig
from .broker import BrokerError
from .buffers import StreamBuffer, structure_key, to_device, \
    unstack_buffers
from .query import QueryServerEndpoint
from .trace import TRACER
from . import compression as comp
from . import netfault

__all__ = ["BatchingPolicy", "QueryBatcher", "StreamingQueryBatcher",
           "StageQueryBatcher", "StagedStreamingBatcher",
           "DEFAULT_QUERY_BATCH"]

DEFAULT_QUERY_BATCH = 8

#: buffer meta keys that carry per-request routing, not payload semantics —
#: hoisted out before serving and re-attached to the routed answer
_ROUTING_KEYS = ("client_id", "codec", "tenant_id", "dseq")


@dataclass(frozen=True)
class BatchingPolicy:
    """How a runtime gathers and flushes query requests: ``max_batch >= 1``
    turns on queue-gather-flush (clients run deferred), ``<= 0`` keeps the
    synchronous round trip inside ``tensor_query_client.apply``."""

    max_batch: int = DEFAULT_QUERY_BATCH
    flush_on_full: bool = True

    @classmethod
    def of(cls, value) -> "BatchingPolicy":
        if isinstance(value, cls):
            return value
        return cls(max_batch=int(value))

    @property
    def enabled(self) -> bool:
        return self.max_batch >= 1


class QueryBatcher:
    """Gather-stack-flush loop for one stateless server endpoint.

    ``run`` is the scheduler's pipeline-run record of the server pipeline;
    ``inline_step`` is a zero-arg callable doing one interpreted server step
    (serversrc pull → … → serversink route), the path for a server plan
    that is not ``query_batchable``.

    Per flush, requests leave the admission queue in arrival order, at most
    ``max_batch`` at a time:

    * fused (default): no decode at gather time.  Requests group by
      consecutive (codec, wire structure); each group serves through
      ``plan.compiled_serve_batch(codec=...)`` — stacked decode, the DAG
      once per frame, stacked answer encode — and the wire answers go out
      through the serversink's ``push_wire``.  The deferred sparse
      truncation counts sync once per group.  ``codec=none`` groups have
      nothing to fuse and take the route below.
    * ``fused=False``: each request is decoded, requests group by
      decoded structure, each group serves through
      ``plan.compiled_serve_batch()`` and every answer is encoded by the
      serversink's own ``apply``.

    The cached executables are CUDA graphs on the card, one per batch size
    (capped at ``max_batch``); a server run added with ``jit=False``
    serves through the plan's eager ``serve_batch``/``serve_batch_wire``
    instead.

    Routing meta (``client_id``, ``codec``, ...) is hoisted out before
    grouping and restored on every answer.  Liveness is re-checked before
    every group: a death that lands mid-flush leaves the groups still in
    the batcher's hands to the orphan ledger (``on_orphans``), never to
    the dead server.  A request's numpy tensors (an edge client's frame)
    become tensors on the run's device on ingest.

    Mesh placement (DESIGN.md §4): with a ``mesh``, a group whose size
    tiles the mesh's data slots on a plan without cross-frame state
    (``plan.shardable_batch``) may serve through
    ``plan.compiled_serve_batch(mesh=...)``, one frame slice a data slot;
    every other group serves single-device, and the answers are bitwise
    the same either way.  Placement is a cost decision: ``shard_mode=
    "auto"`` probes both executables once per batch size on the batch at
    hand and keeps the faster (:attr:`placements`), ``"always"`` and
    ``"never"`` force it.  A codec group the mesh may take keeps the
    eager wire path (a stacked host decode, the placed serve, the
    serversink's encode per answer): codec fusion is single-device.  A
    batch size whose probe picked ``"single"`` serves codec-fused again.

    ``qos`` is the runtime's admission policy: each flush round first
    expires queued requests past their deadline, and a round whose serve
    budget is spent ends the flush, leaving the rest queued (in flight
    for the scheduler) until the next tick."""

    def __init__(self, endpoint: QueryServerEndpoint, run: Any,
                 policy: BatchingPolicy,
                 inline_step: Optional[Callable[[], Any]] = None,
                 mesh=None, shard_mode: str = "auto", fused: bool = True,
                 on_orphans: Optional[Callable[[int], None]] = None, *,
                 qos: Optional[QoSConfig] = None,
                 clock: Optional[Callable[[], int]] = None):
        if shard_mode not in ("auto", "always", "never"):
            raise ValueError(f"shard_mode {shard_mode!r} not in "
                             f"('auto', 'always', 'never')")
        self.endpoint = endpoint
        self.run = run
        self.policy = policy
        self.inline_step = inline_step
        #: codec-fused serving; False = decode, serve, encode per request
        self.fused = fused
        #: the mesh batches may be laid out on (None: single-device)
        self.mesh = mesh
        #: placement policy (class docstring)
        self.shard_mode = shard_mode
        #: batch size -> "sharded" | "single", probed in auto mode
        self.placements: Dict[int, str] = {}
        #: the server params on the mesh (one copy per distinct device),
        #: placed at the first sharded serve and kept: placing them per
        #: flush would cost more than the serve
        self._mesh_params = None
        #: called with the number of admitted requests a dying endpoint
        #: abandons (the runtime's orphan ledger; the paused frames
        #: re-dispatch from their PendingQuery records)
        self.on_orphans = on_orphans
        self.admission = AdmissionQueue(qos=qos, clock=clock)
        #: delivery guard (DESIGN.md §10), installed by the runtime when a
        #: DeliveryPolicy is on: every ingested request passes CRC + dedup
        #: triage first.  None is the guard-less wire, bit for bit.
        self.guard = None
        self.flushes = 0
        self.batches = 0
        self.batched_frames = 0
        self.sequential_frames = 0
        self.sharded_batches = 0
        self.sharded_frames = 0
        self.fused_batches = 0
        self.fused_frames = 0
        self.orphaned = 0

    def in_flight(self, client_id: int) -> bool:
        """Whether ``client_id`` has work the scheduler must keep waiting on:
        a request a serve budget holds queued is in flight, not lost."""
        return self.admission.queued_for(client_id) > 0

    def pending(self) -> int:
        return len(self.endpoint.requests) + len(self.admission)

    def full(self) -> bool:
        # backpressure floor: one more send onto a full (leaky) request
        # channel would silently drop a client's request
        if len(self.endpoint.requests) >= self.endpoint.requests.capacity:
            return True
        return self.policy.flush_on_full and \
            self.pending() >= max(1, self.policy.max_batch)

    def flush(self) -> int:
        """Serve every pending request; returns the number served.  A dead
        endpoint serves nothing: what admission holds sheds onto the orphan
        ledger (:meth:`_shed_dead`)."""
        if not self.endpoint.alive:
            self._shed_dead()
            return 0
        adm = self.admission
        served = 0
        # query_batch=0 serves each request through one interpreted step
        batchable = self.policy.enabled and \
            self.run.pipe.plan.query_batchable
        while self.endpoint.alive:
            self._ingest()
            adm.expire()
            if not len(adm):
                break
            recs = adm.take(self.policy.max_batch if batchable else 1)
            if not recs:
                break               # serve budget spent this tick
            if not batchable:
                self._serve_sequential(recs[0])
                served += 1
                continue
            raws = [r.raw for r in recs]
            groups = self._group_wire(raws) if self.fused else \
                [(g, None) for g in self._group(raws)]
            idx = 0
            for pairs, codec in groups:
                if not self.endpoint.alive:
                    # died mid-flush: the rest was popped, never served
                    self._shed_flush_remainder(recs[idx:])
                    break
                if codec is None:
                    self._serve_batched(pairs)    # the eager path
                elif codec.partition(":")[0] == "none" or \
                        self._mesh_may_take(len(pairs)):
                    # nothing to fuse, or the mesh may place the group:
                    # dense frames from one stacked decode (identity for
                    # none), answers encoded by the serversink
                    decoded = comp.decode_batch([c for c, _ in pairs], codec)
                    self._serve_batched([(dec, routing) for dec, (_, routing)
                                         in zip(decoded, pairs)])
                else:
                    self._serve_batched_wire(pairs, codec)
                for rec in recs[idx:idx + len(pairs)]:
                    adm.mark_served(rec)
                idx += len(pairs)
                served += len(pairs)
        if served:
            self.flushes += 1
        return served

    def _ingest(self):
        """Drain the endpoint channel into admission (numpy tensors placed
        on the run's device), through the delivery guard when the runtime
        installed one.  Guard triage: a corrupt frame dies here (counted by
        the guard), a duplicate re-fires the committed answer's replay (a
        retransmit means the client never saw it), and an accepted frame
        sheds its wire checksum (it authenticated this hop; the answer gets
        its own) before admission."""
        ch = self.endpoint.requests
        guard = self.guard
        device = getattr(self.run, "device", None)
        while True:
            raw = ch.pop()
            if raw is None:
                return
            if guard is not None:
                verdict = guard.check(raw, ch)
                if verdict == "dup":
                    guard.replay_answer((raw.meta or {}).get("dseq"))
                    continue
                if verdict == "corrupt":
                    continue
                # every send path builds the wire meta fresh: shed the
                # checksum in place
                raw.meta.pop("crc", None)
            if device is not None:
                raw = to_device(raw, device)
            self.admission.ingest(raw)

    # -- a dead endpoint -------------------------------------------------------
    def _forget_delivery(self, rec):
        """Evict a shed-unserved request's delivery id from the dedup
        window: its failover re-dispatch reuses the id, and a window that
        still held it would dedup the retry into a void."""
        if self.guard is None or rec is None:
            return
        raw = getattr(rec, "raw", None)
        if raw is not None:
            self.guard.forget((raw.meta or {}).get("dseq"))

    def _orphan(self, n: int):
        """Account requests a dying endpoint admitted but never served."""
        if n <= 0:
            return
        self.orphaned += n
        if self.on_orphans is not None:
            self.on_orphans(n)

    def _shed_flush_remainder(self, recs):
        """Close the popped-but-unserved tail of a dying flush: shed on the
        tenant ledger (``server-died``, no client notice: the scheduler
        re-dispatches these and the client gets a real answer elsewhere)
        and booked on the orphan ledger."""
        for rec in recs:
            self.admission.mark_shed(rec, "server-died", notify=False)
            self._forget_delivery(rec)
        self._orphan(len(recs))

    def _shed_dead(self) -> int:
        """The endpoint is dead: everything still queued in admission sheds
        (``server-died``) onto the orphan ledger."""
        n = self.admission.shed_queued("server-died",
                                       on_shed=self._forget_delivery)
        self._orphan(n)
        return n

    def on_reconfig(self):
        """The served pipeline was hot-swapped under this batcher: the
        calibrated placements and the mesh-placed params belong to the old
        plan and params, so the next flush probes and places again (the
        plan itself is always read through ``run``)."""
        self.placements.clear()
        self._mesh_params = None

    # -- gather & grouping -----------------------------------------------------
    def _decode(self, raw: StreamBuffer) -> Tuple[StreamBuffer, Dict]:
        """Host-level decode + routing-meta hoist -> (clean frame, routing
        dict to re-attach on the answer).  Routing is read off the WIRE
        buffer: decode strips the wire-form ``codec`` claim, but the
        client's codec still routes its answer's encode."""
        codec = raw.meta.get("codec", "none")
        buf = comp.decode(raw, codec)
        routing = {k: raw.meta[k] for k in _ROUTING_KEYS if k in raw.meta}
        clean = buf.with_(meta={k: v for k, v in buf.meta.items()
                                if k not in _ROUTING_KEYS})
        return clean, routing

    def _group(self, raws: List[StreamBuffer]):
        """Decoded requests in consecutive same-structure groups, arrival
        order kept (eager path)."""
        groups: List[List[Tuple[StreamBuffer, Dict]]] = []
        last_key = None
        for raw in raws:
            clean, routing = self._decode(raw)
            key = structure_key(clean)
            if groups and key == last_key:
                groups[-1].append((clean, routing))
            else:
                groups.append([(clean, routing)])
                last_key = key
        return groups

    def _group_wire(self, raws: List[StreamBuffer]):
        """Fused-path grouping: consecutive same-(codec, WIRE structure)
        runs of raw requests, arrival order kept, no decode.  Yields
        ``([(clean_wire, routing), ...], codec)``; ``codec=none`` requests
        are already dense."""
        groups: List[Tuple[List[Tuple[StreamBuffer, Dict]], str]] = []
        last_key = None
        for raw in raws:
            codec = raw.meta.get("codec", "none")
            pair = self._hoist_wire(raw)
            key = (codec, structure_key(pair[0]))
            if groups and key == last_key:
                groups[-1][0].append(pair)
            else:
                groups.append(([pair], codec))
                last_key = key
        return groups

    def _hoist_wire(self, raw: StreamBuffer) -> Tuple[StreamBuffer, Dict]:
        """Routing hoist for a WIRE request: strip routing meta and the
        wire-form meta (``codec`` becomes the group's parameter and
        ``sparse_dropped`` differs per frame; either would split
        same-shaped requests)."""
        routing = {k: raw.meta[k] for k in _ROUTING_KEYS if k in raw.meta}
        keep = {k: v for k, v in raw.meta.items()
                if k not in _ROUTING_KEYS and k not in comp._WIRE_META}
        return raw.with_(meta=keep), routing

    # -- serving ---------------------------------------------------------------
    def _serve_sequential(self, rec):
        """One interpreted server step for a plan the batcher cannot drive
        hoisted: the request re-enters the HEAD of the channel (no double
        byte accounting) so the serversrc's own pull sees it."""
        if self.inline_step is None:
            raise RuntimeError("sequential serving needs an inline_step")
        self.endpoint.requests.q.appendleft(rec.raw)
        self.inline_step()
        self.sequential_frames += 1
        self.admission.mark_served(rec)

    def _serve_batched(self, group: List[Tuple[StreamBuffer, Dict]]):
        """One ``serve_batch`` call over a group of dense requests; each
        answer replays through the serversink's real apply (encode + push)
        with its routing restored."""
        run = self.run
        plan = run.pipe.plan
        n = len(group)
        src = plan.query_sources[0].name
        frames_in = tuple({src: clean} for clean, _ in group)
        use_mesh = self._pick_placement(n, frames_in)
        serve = self._serve_fn(use_mesh)
        params = self._mesh_placed_params() if use_mesh else run.params
        frames_out, run.state = serve(params, run.state, frames_in)
        for (_, routing), frame in zip(group, frames_out):
            self._route(frame, routing)
            run.frames += 1
        if use_mesh:
            self.sharded_batches += 1
            self.sharded_frames += n
        self._count(n)

    def _serve_fn(self, use_mesh: bool) -> Callable:
        """The serve for a group: the cached executable (mesh or single),
        or the plan's eager ``serve_batch`` for a run added with
        ``jit=False``."""
        run = self.run
        plan = run.pipe.plan
        mesh = self.mesh if use_mesh else None
        if run.jit:
            return plan.compiled_serve_batch(mesh=mesh)

        def serve(params, state, frames):
            return plan.serve_batch(params, state, frames, mesh=mesh)
        return serve

    # -- placement -------------------------------------------------------------
    def _mesh_may_take(self, n: int) -> bool:
        """Whether mesh placement might claim a group of ``n``: such groups
        need dense frames (the probe and the sharded serve take them), so
        they keep the eager wire path.  A size whose probe already said
        "single" is not claimed: it serves codec-fused."""
        if self.mesh is None or self.shard_mode == "never":
            return False
        if not self.run.pipe.plan.shardable_batch(n, self.run.state,
                                                  self.mesh):
            return False
        return self.shard_mode == "always" or \
            self.placements.get(n) != "single"

    def _pick_placement(self, n: int, frames_in: Tuple) -> bool:
        """Whether this group serves through the mesh executable: groups
        the mesh cannot take serve single-device; the others follow
        ``shard_mode``, probed once per batch size in auto mode."""
        if self.mesh is None or not self.run.pipe.plan.shardable_batch(
                n, self.run.state, self.mesh):
            return False
        if self.shard_mode != "auto":
            return self.shard_mode == "always"
        dec = self.placements.get(n)
        if dec is None:
            dec = self._calibrate(n, frames_in)
        return dec == "sharded"

    def _mesh_placed_params(self):
        """The server params replicated on the mesh (one copy per distinct
        device), placed once and reused by every sharded serve."""
        if self._mesh_params is None:
            from ..launch.shardings import replicated
            self._mesh_params = replicated(self.mesh, self.run.params)
        return self._mesh_params

    def _calibrate(self, n: int, frames_in: Tuple) -> str:
        """Serve this very batch through both executables and keep the
        faster for this size.  Both are bitwise correct and the plan is
        stateless (shardable), so the probe serves are discarded warm-ups:
        one untimed call each (it also makes the CUDA graph bindings),
        then the best of three, each between device synchronizations so
        the time is the work's, not the launches'."""
        run = self.run
        sync = _synchronizer(run.params)
        best = {}
        for label, use_mesh, params in (
                ("sharded", True, self._mesh_placed_params()),
                ("single", False, run.params)):
            fn = self._serve_fn(use_mesh)
            fn(params, run.state, frames_in)
            ts = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                fn(params, run.state, frames_in)
                sync()
                ts.append(time.perf_counter() - t0)
            best[label] = min(ts)
        dec = "sharded" if best["sharded"] <= best["single"] else "single"
        self.placements[n] = dec
        return dec

    def _serve_batched_wire(self, pairs: List[Tuple[StreamBuffer, Dict]],
                            codec: str):
        """One codec-fused ``serve_batch_wire`` call over a same-(codec,
        structure) group of hoisted wire requests.  The stacked wire
        answers are split into per-frame views on the device and pushed
        through the serversink's ``push_wire`` with routing and the loss
        signal restored; the truncation counts sync once."""
        run = self.run
        plan = run.pipe.plan
        n = len(pairs)
        src = plan.query_sources[0].name
        frames_in = tuple({src: clean} for clean, _ in pairs)
        if run.jit:
            serve = plan.compiled_serve_batch(codec=codec)
        else:
            def serve(params, state, frames):
                return plan.serve_batch_wire(params, state, frames, codec)
        (wire_outs, app_outs, dropped), run.state = serve(
            run.params, run.state, frames_in)
        # the truncation counts come back on the device; one host read per
        # group, after the executable
        dropped = {name: d.cpu().numpy() for name, d in dropped.items()}
        base_codec = codec.partition(":")[0]
        wire_frames = {name: unstack_buffers(b, n)
                       for name, b in wire_outs.items()}
        app_frames = {name: unstack_buffers(b, n)
                      for name, b in app_outs.items()}
        for i, (_, routing) in enumerate(pairs):
            for name, frames in wire_frames.items():
                wb = frames[i]
                frame_dropped = (comp.account_sparse_dropped(
                    dropped[name][:, i]) if name in dropped else 0)
                # meta layering of the eager path: answer meta, routing,
                # then the wire-form claims encode stamps
                meta = {**wb.meta, **routing, "codec": base_codec}
                if frame_dropped:
                    meta["sparse_dropped"] = frame_dropped
                wb = wb.with_(meta=meta)
                run.pipe.elements[name].push_wire(
                    wb, comp.wire_nbytes(wb), routing["client_id"])
            outs_i = {name: frames[i] for name, frames in app_frames.items()}
            for name, buf in outs_i.items():
                run.sink_log.setdefault(name, []).append(buf)
            run.last_outputs = outs_i
            run.frames += 1
        self.fused_batches += 1
        self.fused_frames += n
        self._count(n)

    def _serve_tick(self) -> Callable:
        """The stateful serve tick of a stream-serving run: the cached
        executable (a CUDA graph on the card), or one eager hoisted ``run``
        for a run added with ``jit=False``."""
        run = self.run
        plan = run.pipe.plan
        if run.jit:
            return plan.compiled_serve_tick(run.state)

        def serve(params, state, inputs):
            return plan.run(params, state, inputs, hoist_io=True,
                            hoist_queries=True)
        return serve

    def _count(self, n: int):
        self.batched_frames += n
        if n > 1:
            # a batch of n frames is one burst of the server run, as the
            # JAX package books it
            self.batches += 1
            self.run.bursts += 1
            self.run.burst_frames += n

    def _route(self, frame_outs: Dict[str, StreamBuffer], routing: Dict):
        """Deliver one frame's captured outputs: serversink answers replay
        through the element's apply with routing restored; other sinks land
        in the server run's sink log."""
        run = self.run
        app_outs = {}
        for name, buf in frame_outs.items():
            elem = run.pipe.elements[name]
            if getattr(elem, "is_query_sink", False):
                answer = buf.with_(meta={**buf.meta, **routing})
                elem.apply(run.params.get(name, {}), [answer])
            else:
                app_outs[name] = buf
                run.sink_log.setdefault(name, []).append(buf)
        run.last_outputs = app_outs

    def stats(self) -> Dict[str, int]:
        """Base schema every batcher shares (subclasses extend it)."""
        adm = self.admission.stats()
        return {"flushes": self.flushes, "batches": self.batches,
                "batched_frames": self.batched_frames,
                "sequential_frames": self.sequential_frames,
                "sharded_batches": self.sharded_batches,
                "sharded_frames": self.sharded_frames,
                "fused_batches": self.fused_batches,
                "fused_frames": self.fused_frames,
                "flush_orphans": self.orphaned,
                "admitted_requests": sum(t["admitted"] for t in adm.values()),
                "served_requests": sum(t["served"] for t in adm.values()),
                "shed_requests": sum(t["shed"] for t in adm.values()),
                "queued_requests": sum(t["queued"] for t in adm.values())}

    def tenant_stats(self) -> Dict[str, Dict]:
        return self.admission.stats()


def _synchronizer(params) -> Callable[[], None]:
    """A device synchronization for the devices under ``params`` (every
    CUDA device when one is there), a no-op on the CPU."""
    from .buffers import tree_flatten
    if any(isinstance(l, torch.Tensor) and l.is_cuda
           for l in tree_flatten(params)[0]):
        def sync():
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
        return sync
    return lambda: None


class StreamingQueryBatcher(QueryBatcher):
    """Continuous-batching request lifecycle (DESIGN.md §7).

    Per flush (called every scheduler drain round):

    1. **admit** — expire what waited past its deadline, then take
       requests one at a time until none is left or the serve budget is
       spent: decode each, run the serve element's host prefill (first
       token + batch-1 cache, on the card), and queue the stream for a
       slot.  ``gen <= 1`` answers at once.
    2. **decode tick** — at most once per scheduler tick: free slots go
       lowest-slot-first to waiting streams (:meth:`_next_waiting`) and
       are admitted into the plan state eagerly, then ONE
       ``compiled_serve_tick`` call (a CUDA graph on the card) decodes the
       whole slot table.
    3. **finish** — slots whose ``finished`` lane fired deliver their
       tokens as one answer through the real serversink apply.

    Conservation: ``tokens_generated == tokens_delivered + tokens_dropped
    + tokens_in_flight``.  A dead endpoint aborts every live stream into
    ``tokens_dropped`` (:meth:`_abort_streams`); their PendingQuery records
    re-dispatch and regenerate by PREFILL REPLAY on a survivor, bitwise
    under greedy decode.  A committed hot swap replays its in-flight
    streams on the new epoch (:meth:`on_reconfig`, counted in
    ``replays``).  Slots the batcher forgot (a revived server's table)
    keep decoding with no record listening until their budget drains;
    an admit into such a slot overwrites every leaf of it.

    ``prefill_seconds`` / ``decode_seconds`` are host clock sums around
    the prefills (replays included) and decode ticks; both end in a host
    read of the result, so they include the device time.  With the tracer
    on (``core/trace.py``) each prefill is a ``prefill`` span and each
    decode tick a ``decode`` span split into ``decode.admit``,
    ``decode.serve``, ``decode.read`` and ``decode.deliver``."""

    def __init__(self, *args, tick_source: Optional[Callable[[], int]] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if tick_source is None:
            # standalone batcher: every flush is its own decode tick
            counter = itertools.count()
            tick_source = lambda: next(counter)          # noqa: E731
        self.tick_source = tick_source
        self._slots: Dict[int, Dict] = {}       # slot -> stream record
        self._waiting: List[Dict] = []          # FIFO, no free slot yet
        self._replay: List[Dict] = []           # re-prefill on the next admit
        #: client_id -> FIFO of live stream records (a client may pipeline
        #: a second request while its first stream is in flight)
        self._by_client: Dict[int, List[Dict]] = {}
        self._last_decode_tick: Optional[int] = None
        self.prefills = 0
        self.replays = 0
        self.decode_ticks = 0
        self.tokens_generated = 0
        self.tokens_delivered = 0
        self.tokens_dropped = 0
        self.streams_started = 0
        self.streams_finished = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        #: host seconds of each decode tick, in order (not in stats())
        self.decode_times: List[float] = []

    # -- introspection ---------------------------------------------------------
    def in_flight(self, client_id: int) -> bool:
        return bool(self._by_client.get(client_id)) or \
            super().in_flight(client_id)

    def inflight_tokens(self) -> int:
        return sum(len(rec["tokens"]) for recs in self._by_client.values()
                   for rec in recs)

    def active_streams(self) -> int:
        return sum(len(recs) for recs in self._by_client.values())

    def _track(self, rec: Dict):
        self._by_client.setdefault(rec["routing"]["client_id"],
                                   []).append(rec)

    def _untrack(self, rec: Dict):
        """Drop ONE record by identity (equal records may coexist)."""
        cid = rec["routing"]["client_id"]
        recs = self._by_client.get(cid)
        if not recs:
            return
        for i, r in enumerate(recs):
            if r is rec:
                del recs[i]
                break
        if not recs:
            del self._by_client[cid]

    def _serve_elem(self):
        for op in self.run.pipe.plan.ops:
            if getattr(op.elem, "is_stream_serve", False):
                return op.elem
        raise RuntimeError("StreamingQueryBatcher on a non-streaming plan")

    # -- lifecycle -------------------------------------------------------------
    def flush(self) -> int:
        if not self.endpoint.alive:
            self._abort_streams()
            return 0
        served = self._admit()
        tick = self.tick_source()
        if tick != self._last_decode_tick and self._has_decode_work():
            self._last_decode_tick = tick
            served += self._decode_tick()
        if served:
            self.flushes += 1
        return served

    def _has_decode_work(self) -> bool:
        return bool(self._slots or self._waiting)

    def _admit(self) -> int:
        finished = 0
        elem = self._serve_elem()
        params = self.run.params.get(elem.name, {})
        if self._replay:
            # streams a committed hot swap orphaned re-prefill on the NEW
            # epoch's params (greedy decode: the regeneration is bitwise
            # what a fresh build answers)
            replays, self._replay = self._replay, []
            for rec in replays:
                on = TRACER.on
                if on:
                    arec = rec.get("adm")
                    sp = TRACER.begin("prefill",
                                      None if arec is None else arec.seq)
                t0 = time.perf_counter()
                tok, cache = elem.host_prefill(params, rec["prompt"])
                self.prefill_seconds += time.perf_counter() - t0
                if on:
                    TRACER.end(sp)
                self.prefills += 1
                self.tokens_generated += 1
                rec["tokens"] = [tok]
                rec["remaining"] = max(0, rec["gen"] - 1)
                rec["cache"] = cache
                if rec["remaining"] <= 0:
                    self._finish(rec)
                    finished += 1
                else:
                    self._waiting.append(rec)
        adm = self.admission
        while self.endpoint.alive:
            self._ingest()
            adm.expire()
            recs = adm.take(1)
            if not recs:
                break
            arec = recs[0]
            clean, routing = self._decode(arec.raw)
            gen = int(clean.meta.get("gen", 1))
            on = TRACER.on
            if on:
                t = time.time_ns()
                sp = TRACER.begin("prefill", arec.seq, t)
                if arec.ingest_ns:
                    TRACER.wait("queue_wait", arec.seq, arec.ingest_ns, t)
            t0 = time.perf_counter()
            tok, cache = elem.host_prefill(params, clean.tensors[0])
            self.prefill_seconds += time.perf_counter() - t0
            if on:
                TRACER.end(sp)
            self.prefills += 1
            self.streams_started += 1
            self.tokens_generated += 1
            rec = {"routing": routing, "tokens": [tok],
                   "prompt": clean.tensors[0], "gen": gen,
                   "remaining": max(0, gen - 1), "cache": cache,
                   "adm": arec}
            self._track(rec)
            if rec["remaining"] <= 0:
                self._finish(rec)
                finished += 1
            else:
                self._waiting.append(rec)
        return finished

    def _next_waiting(self) -> Dict:
        """The waiting stream the next free slot goes to: first in first out
        when QoS is off (the pre-QoS order, bit for bit) or one stream
        waits, else the smallest ``(priority, deadline, arrival)`` key of
        its admission record.  Priority decides slot admission, never
        eviction: a slotted stream keeps its slot until it finishes."""
        if not self.admission.enabled or len(self._waiting) <= 1:
            return self._waiting.pop(0)
        best = min(range(len(self._waiting)),
                   key=lambda i: self._waiting[i]["adm"].order_key()
                   if "adm" in self._waiting[i] else (-1, 0.0, -1))
        return self._waiting.pop(best)

    def _decode_tick(self) -> int:
        """ONE decode call over the whole slot table: waiting streams join
        (admitted eagerly, in place), every active slot emits a token
        through the cached serve tick, spent slots leave."""
        on = TRACER.on
        if on:
            top = TRACER.begin("decode")
            sp = TRACER.begin("decode.admit")
        run = self.run
        plan = run.pipe.plan
        elem = self._serve_elem()
        free = [s for s in range(elem.slots) if s not in self._slots]
        admits = []
        while free and self._waiting:
            rec = self._next_waiting()
            slot = free.pop(0)
            admits.append((slot, rec["tokens"][-1], rec["remaining"],
                           rec["cache"]))
            rec["cache"] = None     # lives in plan state from here on
            rec["slot"] = slot
            self._slots[slot] = rec
        src = plan.query_sources[0].name
        sink = plan.query_sinks[0].name
        t0 = time.perf_counter()
        elem.admit(run.state[elem.name], elem.build_admit(admits))
        if on:
            sp = TRACER.then(sp, "decode.serve")
        outputs, run.state = self._serve_tick()(
            run.params, run.state, {src: elem.empty_admit()})
        toks, emitted, finished = outputs[sink].tensors
        if on:
            sp = TRACER.then(sp, "decode.read")
        lanes = torch.stack([toks, emitted.to(torch.int32),
                             finished.to(torch.int32)]).cpu().numpy()
        self.decode_times.append(time.perf_counter() - t0)
        self.decode_seconds += self.decode_times[-1]
        if on:
            elem.trace_tick_counts()
            sp = TRACER.then(sp, "decode.deliver")
        toks, emitted, finished = lanes
        self.decode_ticks += 1
        run.frames += 1
        n_active = int(emitted.sum())
        self.batched_frames += n_active
        if n_active > 1:
            self.batches += 1
        done = 0
        for slot in sorted(self._slots):
            rec = self._slots[slot]
            if emitted[slot]:
                rec["tokens"].append(int(toks[slot]))
                self.tokens_generated += 1
            if finished[slot]:
                self._finish(rec)
                del self._slots[slot]
                done += 1
        if on:
            TRACER.end(sp)
            TRACER.end(top)
        return done

    def _finish(self, rec: Dict):
        """Deliver one completed stream: all its tokens as ONE answer
        through the real serversink apply.  A stream that decoded in a slot
        names it in ``meta["slot"]``, so a parity check can replay it there
        (``sequential_decode(..., slot=)``)."""
        sink = self.run.pipe.plan.query_sinks[0]
        meta = dict(rec["routing"])
        if "slot" in rec:
            meta["slot"] = rec["slot"]
        answer = StreamBuffer(
            tensors=(np.asarray(rec["tokens"], np.int32),), meta=meta)
        sink.apply(self.run.params.get(sink.name, {}), [answer])
        self.tokens_delivered += len(rec["tokens"])
        self.streams_finished += 1
        arec = rec.pop("adm", None)
        if arec is not None:
            self.admission.mark_served(arec)
        self._untrack(rec)

    def on_reconfig(self):
        """The serve topology was hot-swapped under live streams.  The
        batcher cannot tell which epoch a slot's cache belongs to, so every
        in-flight stream REPLAYS: its partial tokens become declared drops
        and it re-prefills on the new epoch at the next flush.  Slots of
        carried plan state that are still active self-clear (their
        ``remaining`` lane drains with no record listening)."""
        super().on_reconfig()
        recs = [self._slots[s] for s in sorted(self._slots)] + self._waiting
        self._slots.clear()
        self._waiting = []
        for rec in recs:
            self.tokens_dropped += len(rec["tokens"])
            self.replays += 1
            rec["tokens"] = []
            rec["cache"] = None
            rec.pop("slot", None)
        self._replay.extend(recs)

    def _abort_streams(self):
        """The endpoint died: every live stream's partial tokens are
        DECLARED drops and its admission closes as a ``server-died`` shed
        on the orphan ledger; the PendingQuery records re-dispatch with
        prefill replay on a survivor, so the client loses no token."""
        self._shed_dead()
        if not self._by_client:
            return
        total = 0
        for recs in self._by_client.values():
            for rec in recs:
                self.tokens_dropped += len(rec["tokens"])
                arec = rec.pop("adm", None)
                if arec is not None:
                    self.admission.mark_shed(arec, "server-died",
                                             notify=False)
                    self._forget_delivery(arec)
                total += 1
        self._orphan(total)
        self._slots.clear()
        self._waiting.clear()
        self._replay.clear()
        self._by_client.clear()

    def stats(self) -> Dict[str, int]:
        base = super().stats()
        base.update({
            "prefills": self.prefills,
            "decode_ticks": self.decode_ticks,
            "tokens_generated": self.tokens_generated,
            "tokens_delivered": self.tokens_delivered,
            "tokens_dropped": self.tokens_dropped,
            "tokens_in_flight": self.inflight_tokens(),
            "streams_started": self.streams_started,
            "streams_finished": self.streams_finished,
            "replays": self.replays,
            "prefill_seconds": self.prefill_seconds,
            "decode_seconds": self.decode_seconds,
        })
        return base


class StageQueryBatcher(QueryBatcher):
    """Hop server of a DOWNSTREAM ``model_serve_stage`` pipeline (stage
    k >= 1 of a chain, DESIGN.md §8).  Its endpoint receives hop requests
    from the chain's :class:`StagedStreamingBatcher`, never prompts;
    ``meta["hop"]`` selects the verb:

    * ``"prefill"`` — stage-local prefill of one stream's boundary
      activations; the batch-1 cache PARKS here under the coordinator's
      stream id ``meta["sid"]`` (caches never cross the wire, only
      activations do), and the boundary output answers.
    * ``"replay"`` — one retained step folded into a parked cache, in the
      stream's slot row ``meta["slot"]``: a replacement stage rebuilds
      exactly its own slice of a dead stage's state.
    * ``"decode"`` — one slot-table hop: ``meta["admit"]`` maps joining
      slots to parked stream ids (copied into the slot rows eagerly, then
      the cached hop runs, a CUDA graph on the card), ``meta["live"]``
      prunes the parked caches of finished streams.

    Epoch fencing: every reconfiguration of this pipeline bumps
    ``endpoint.spec["serve_epoch"]``; the coordinator trusts a stage's
    slot caches only while (endpoint identity, epoch) are unchanged, so a
    hot-swapped stage recovers by the same stage-local replay as a dead
    one.

    Hop traffic drains the admission queue one request at a time, first
    in first out, whatever the runtime's QoS: each hop is one step of a
    stream the coordinator already admitted.  A decode hop's active rows
    are counted on the device (the mask arrives there) and read when
    :meth:`stats` asks."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._parked: Dict[int, Dict] = {}     # stream id -> batch-1 cache
        self.epoch = 0
        self.endpoint.spec.setdefault("serve_epoch", 0)
        self.prefills = 0
        self.replay_steps = 0
        self.decode_hops = 0
        #: active rows over all decode hops, and hops with more than one,
        #: as device scalars
        self._active_rows: Optional[torch.Tensor] = None
        self._wide_hops: Optional[torch.Tensor] = None

    def _serve_elem(self):
        for op in self.run.pipe.plan.ops:
            if getattr(op.elem, "is_stage_serve", False):
                return op.elem
        raise RuntimeError("StageQueryBatcher on a non-stage plan")

    def flush(self) -> int:
        if not self.endpoint.alive:
            self._parked.clear()
            self._shed_dead()
            return 0
        adm = self.admission
        served = 0
        while self.endpoint.alive:
            self._ingest()
            recs = adm.take(1)
            if not recs:
                break
            self._serve_hop(recs[0].raw)
            adm.mark_served(recs[0])
            served += 1
        if served:
            self.flushes += 1
        return served

    def _serve_hop(self, raw: StreamBuffer):
        clean, routing = self._decode(raw)
        kind = clean.meta.get("hop", "decode")
        elem = self._serve_elem()
        params = self.run.params.get(elem.name, {})
        if kind == "prefill":
            sid = int(clean.meta["sid"])
            out, cache = elem.host_stage_prefill(params, clean.tensors[0])
            self._parked[sid] = cache
            self.prefills += 1
        elif kind == "replay":
            sid = int(clean.meta["sid"])
            out, cache = elem.host_stage_decode_idempotent(
                params, clean.tensors[0], self._parked[sid],
                int(clean.meta["slot"]), hop_id=routing.get("dseq"))
            self._parked[sid] = cache
            self.replay_steps += 1
        else:
            out = self._serve_decode_hop(clean, elem)
        sink = self.run.pipe.plan.query_sinks[0]
        answer = StreamBuffer(tensors=(out,), meta=dict(routing))
        sink.apply(self.run.params.get(sink.name, {}), [answer])

    def _serve_decode_hop(self, clean: StreamBuffer, elem):
        x, active = clean.tensors
        admits = [(int(slot), self._parked.pop(int(sid)))
                  for slot, sid in clean.meta.get("admit", ())]
        live = clean.meta.get("live")
        if live is not None:
            keep = set(int(s) for s in live)
            self._parked = {s: c for s, c in self._parked.items()
                            if s in keep}
        run = self.run
        plan = run.pipe.plan
        src = plan.query_sources[0].name
        sink = plan.query_sinks[0].name
        hop = elem.admit(run.state[elem.name],
                         elem.build_hop(x, active, admits))
        outputs, run.state = self._serve_tick()(run.params, run.state,
                                                {src: hop})
        self.decode_hops += 1
        run.frames += 1
        n = active.sum()
        if self._active_rows is None:
            self._active_rows = torch.zeros_like(n)
            self._wide_hops = torch.zeros_like(n)
        self._active_rows += n
        self._wide_hops += n > 1
        return outputs[sink].tensors[0]

    def on_reconfig(self):
        """Stage hot-swapped under the chain: the parked caches and slot
        rows belong to the OLD epoch; drop the parked ones and bump the
        epoch fence, so the coordinator replays this stage before
        trusting it."""
        super().on_reconfig()
        self._parked.clear()
        self.epoch += 1
        self.endpoint.spec["serve_epoch"] = self.epoch

    def stats(self) -> Dict[str, int]:
        base = super().stats()
        rows = wide = 0
        if self._active_rows is not None:
            rows, wide = (int(v) for v in torch.stack(
                [self._active_rows, self._wide_hops]).cpu())
        base["batched_frames"] += rows
        base["batches"] += wide
        base.update({
            "stage_prefills": self.prefills,
            "stage_replay_steps": self.replay_steps,
            "decode_hops": self.decode_hops,
            "slot_steps": rows,
            "parked_caches": len(self._parked),
        })
        return base


class StagedStreamingBatcher(StreamingQueryBatcher):
    """The chain coordinator (DESIGN.md §8): the streaming request
    lifecycle of :class:`StreamingQueryBatcher`, with the model split over
    N ``model_serve_stage`` pipelines discovered through the broker.

    It is wired on STAGE 0's endpoint (the client-facing ``query/<op>``
    topic) and owns the slot table.  Stage 0 serves inline through its own
    run's serve tick; stage k >= 1 is reached as a hop: a request pushed
    onto the best-ranked endpoint of ``query/<op>/s<k>``, served by that
    stage's :class:`StageQueryBatcher` through the endpoint's inline
    runner, the answer popped off the coordinator's response channel, as
    ``tensor_query_client.apply`` does.  Broker ranking, leases and the
    reconfiguration lifecycle thus apply per stage.

    Admission runs a PREFILL CHAIN: stage 0 prefills and parks its batch-1
    cache here, each later stage prefills the boundary activations and
    parks its own slice, the last answers the first token.  Under QoS the
    requests are admitted under their tenant's budget as in
    :class:`StreamingQueryBatcher`; waiting streams take slots in arrival
    order, as in the JAX package.  Each decode
    tick runs one hop per stage over the whole slot table.  Boundary
    activations stay on the device; the last stage's int32 tokens are read
    to the host once per tick.  The coordinator RETAINS each stream's
    input to every stage (the prefill activations, then one step per
    completed hop), the feedstock of the per-stage replay rule:

    **Cache trust:** stage k's slot caches are trusted only while
    (endpoint identity, serve_epoch) are unchanged since the last
    successful hop.  On a change (death, lease expiry, failover to a
    standby, win-back, a hot swap) the coordinator rebuilds ONLY stage k:
    per live stream, the retained activations go through the stage's
    prefill and replay verbs, and the parked caches re-merge into the slot
    rows at the next hop.  No generation restarts; no token drops.

    A hop that fails MID-TICK stalls the tick: stages < k already advanced
    this step, so the pending-hop record keeps the in-flight activations
    and the next flush resumes from stage k.  Conservation holds per
    stage, ``hops_dispatched[k] == hops_completed[k] + hops_failed[k]``,
    and the token law holds here.

    With a delivery policy (``delivery``, installed by the runtime) a hop
    is at-least-once: the request carries a delivery id and a CRC, up to
    ``hop_retries`` synchronous retransmits reuse the id (counted in
    ``hop_retransmits``), and answers are guarded: a corrupt one is
    rejected (``hop_corrupt``), a late duplicate of an earlier hop's answer
    dropped (``hop_dups``).  The stage's guard dedups a replayed request
    and re-fires its committed answer, and the stage element's memo keyed
    on the id backs it up, so a hop never advances a slot twice."""

    def __init__(self, *args, broker=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.broker = broker
        from .query import TensorQueryClient
        self._hop_cid = next(TensorQueryClient._ids)
        self._hops: Dict[int, Any] = {}         # stage -> broker Binding
        self._trust: Dict[int, Optional[Tuple]] = {}
        self._readmit: Dict[int, Dict[int, int]] = {}  # stage->{slot: sid}
        self._pending_hop: Optional[Dict] = None
        self._stalled: List[Dict] = []          # prefill chains to resume
        self._sids = itertools.count(1)
        self.hops_dispatched: Dict[int, int] = {}
        self.hops_completed: Dict[int, int] = {}
        self.hops_failed: Dict[int, int] = {}
        self.stage_replays: Dict[int, int] = {}
        self.stage_replay_steps: Dict[int, int] = {}
        #: delivery policy for the hops (DESIGN.md §10); None keeps the
        #: single-shot hop, bit for bit
        self.delivery: Optional[netfault.DeliveryPolicy] = None
        self._hop_seq = 0
        self.hop_retransmits = 0
        self.hop_dups = 0
        self.hop_corrupt = 0
        self.hop_push_drops = 0

    @property
    def n_stages(self) -> int:
        return self._serve_elem().n_stages

    def _has_decode_work(self) -> bool:
        return bool(self._slots or self._waiting or self._stalled
                    or self._pending_hop)

    # -- stage discovery and trust ---------------------------------------------
    def _stage_binding(self, k: int):
        b = self._hops.get(k)
        if b is None:
            op = self.endpoint.operation
            b = self._hops[k] = self.broker.subscribe(
                f"query/{op}/s{k}", prefer={"codec": "none", "stage": k})
        return b

    def _stage_endpoint(self, k: int):
        try:
            binding = self._stage_binding(k)
            ep = binding.endpoint
            if not ep.alive:
                binding._rebind()
                ep = binding.endpoint
        except BrokerError:
            return None
        return ep if ep.alive else None

    def _ensure_stage(self, k: int):
        """Resolve stage k's endpoint and make its caches trustworthy: a
        change of (endpoint identity, serve_epoch) since the last hop
        replays the stage before it is used again."""
        ep = self._stage_endpoint(k)
        if ep is None:
            return None
        key = (ep.endpoint_id, ep.spec.get("serve_epoch", 0))
        if self._trust.get(k) != key:
            if not self._replay_stage(k, ep):
                return None
            self._trust[k] = key
        return ep

    def _replay_stage(self, k: int, ep) -> bool:
        """Rebuild ONLY stage k's slice of every live stream's state from
        the retained activations (DESIGN.md §8 replay rule)."""
        recs = [self._slots[s] for s in sorted(self._slots)] + \
            [r for r in self._waiting if r.get("sid") is not None]
        self.stage_replays[k] = self.stage_replays.get(k, 0) + 1
        for rec in recs:
            acts = rec["acts"][k]
            if self._raw_hop(ep, (acts[0],),
                             {"hop": "prefill", "sid": rec["sid"]}) is None:
                return False
            for step in acts[1:]:
                if self._raw_hop(ep, (step,),
                                 {"hop": "replay", "sid": rec["sid"],
                                  "slot": rec["slot"]}) is None:
                    return False
                self.stage_replay_steps[k] = \
                    self.stage_replay_steps.get(k, 0) + 1
        # slotted streams' rows on the new stage hold nothing of theirs
        # until their freshly parked caches merge at the next decode hop
        rd = self._readmit.setdefault(k, {})
        for slot, rec in self._slots.items():
            rd[slot] = rec["sid"]
        return True

    # -- the hop itself ----------------------------------------------------------
    def _raw_hop(self, ep, tensors, meta) -> Optional[StreamBuffer]:
        """One request -> inline serve -> answer round trip against a
        resolved stage endpoint, with the coordinator as the client.
        None when the endpoint cannot serve.  With a delivery policy the
        round trip retransmits under one delivery id (class docstring);
        a hop cannot wait a tick (the chain holds the slot), hence the
        inline loop rather than the scheduler's backoff clock."""
        buf = StreamBuffer(tensors=tuple(tensors), meta=dict(meta))
        payload, nbytes = comp.encode(buf, "none")
        hmeta = {**payload.meta, "client_id": self._hop_cid,
                 "codec": "none"}
        delivery = self.delivery
        dseq = crc = None
        if delivery is not None:
            self._hop_seq += 1
            dseq = (self._hop_cid, self._hop_seq)
            hmeta["dseq"] = dseq
            hmeta["crc"] = crc = netfault.checksum(payload)
        payload = payload.with_(meta=hmeta)
        if crc is not None:
            netfault.memoize_crc(payload, crc)
        attempts = max(1, delivery.hop_retries) if delivery is not None \
            else 1
        for attempt in range(attempts):
            if attempt:
                self.hop_retransmits += 1
            if not ep.requests.push(payload, nbytes):
                self.hop_push_drops += 1
            runner = ep.spec.get("inline_runner")
            if runner is None or not ep.alive:
                return None
            runner()
            ch = ep.client_channel(self._hop_cid)
            while True:
                raw = ch.pop()
                if raw is None:
                    break
                if delivery is not None:
                    rmeta = raw.meta or {}
                    rcrc = rmeta.get("crc")
                    if rcrc is not None and \
                            netfault.checksum(raw) != int(rcrc):
                        self.hop_corrupt += 1
                        netfault.note(ch, "rejected_corrupt")
                        continue
                    rds = rmeta.get("dseq")
                    if rds is not None and rds != dseq:
                        # a late duplicate of an EARLIER hop's answer: that
                        # hop consumed one copy already
                        self.hop_dups += 1
                        netfault.note(ch, "deduped")
                        continue
                    netfault.note(ch, "accepted")
                return comp.decode(raw, "none")
        return None

    def _hop(self, k: int, tensors, meta) -> Optional[StreamBuffer]:
        ep = self._ensure_stage(k)
        self.hops_dispatched[k] = self.hops_dispatched.get(k, 0) + 1
        ans = None if ep is None else self._raw_hop(ep, tensors, meta)
        if ans is None:
            self.hops_failed[k] = self.hops_failed.get(k, 0) + 1
            self._trust[k] = None       # whatever happened, re-secure first
        else:
            self.hops_completed[k] = self.hops_completed.get(k, 0) + 1
        return ans

    # -- admission (the prefill chain) -------------------------------------------
    def _admit(self) -> int:
        finished = 0
        elem = self._serve_elem()
        params = self.run.params.get(elem.name, {})
        if self._replay:
            # stage 0 was hot-swapped: the whole chain re-prefills these
            # streams on the new epoch
            replays, self._replay = self._replay, []
            for rec in replays:
                for key in ("cache0", "sid", "acts", "chain_next",
                            "chain_x"):
                    rec.pop(key, None)
                finished += self._start_stream(rec, elem, params)
        if self._stalled:
            stalled, self._stalled = self._stalled, []
            for rec in stalled:
                t0 = time.perf_counter()
                finished += self._resume_chain(rec)
                self.prefill_seconds += time.perf_counter() - t0
        adm = self.admission
        while self.endpoint.alive:
            self._ingest()
            adm.expire()
            recs = adm.take(1)
            if not recs:
                break
            arec = recs[0]
            clean, routing = self._decode(arec.raw)
            gen = int(clean.meta.get("gen", 1))
            rec = {"routing": routing, "tokens": [],
                   "prompt": clean.tensors[0], "gen": gen, "remaining": 0,
                   "adm": arec}
            self.streams_started += 1
            self._track(rec)
            finished += self._start_stream(rec, elem, params)
        return finished

    def _start_stream(self, rec: Dict, elem, params) -> int:
        """Stage-0 prefill (its cache parked here) and the downstream
        prefill chain.  Stage 0's own replay feedstock is the prompt."""
        t0 = time.perf_counter()
        out, cache0 = elem.host_stage_prefill(params, rec["prompt"])
        self.prefills += 1
        rec["tokens"] = []
        rec["cache0"] = cache0
        rec["sid"] = next(self._sids)
        rec["acts"] = {k: [] for k in range(1, self.n_stages)}
        rec["chain_next"] = 1
        rec["chain_x"] = out
        done = self._resume_chain(rec)
        self.prefill_seconds += time.perf_counter() - t0
        return done

    def _resume_chain(self, rec: Dict) -> int:
        k = rec["chain_next"]
        x = rec["chain_x"]
        while k < self.n_stages:
            rec["acts"][k] = [x]    # assign, not append: retries overwrite
            ans = self._hop(k, (x,), {"hop": "prefill", "sid": rec["sid"]})
            if ans is None:
                rec["chain_next"], rec["chain_x"] = k, x
                self._stalled.append(rec)
                return 0
            x = ans.tensors[0]
            k += 1
        del rec["chain_next"], rec["chain_x"]
        rec["tokens"] = [int(x.reshape(()))]    # the first token's host read
        self.tokens_generated += 1
        rec["remaining"] = max(0, rec["gen"] - 1)
        if rec["remaining"] <= 0:
            self._finish(rec)
            return 1
        self._waiting.append(rec)
        return 0

    # -- the per-tick decode chain -----------------------------------------------
    def _decode_tick(self) -> int:
        """One step of the chain over the slot table; its host seconds
        (replays of untrusted stages included) go to ``decode_times``."""
        if self._pending_hop is None and not (self._slots or self._waiting):
            return 0                # only stalled prefill chains
        t0 = time.perf_counter()
        if self._pending_hop is not None:
            # a stage died mid-tick: stages < k already advanced this step;
            # resume the SAME step from stage k, never re-run it
            done = self._run_chain()
        else:
            done = self._start_tick()
        self.decode_times.append(time.perf_counter() - t0)
        self.decode_seconds += self.decode_times[-1]
        return done

    def _start_tick(self) -> int:
        run = self.run
        elem = self._serve_elem()
        free = [s for s in range(elem.slots) if s not in self._slots]
        admits0 = []
        while free and self._waiting:
            rec = self._waiting.pop(0)
            slot = free.pop(0)
            admits0.append((slot, rec["cache0"]))
            rec["cache0"] = None    # stage 0's slice lives in plan state now
            rec["slot"] = slot
            self._slots[slot] = rec
            for k in range(1, self.n_stages):
                self._readmit.setdefault(k, {})[slot] = rec["sid"]
        active = np.zeros((elem.slots,), np.bool_)
        tok = np.zeros((elem.slots,), np.int32)
        for slot, rec in self._slots.items():
            active[slot] = True
            tok[slot] = rec["tokens"][-1]
        active_t = torch.from_numpy(active).to(run.device)
        plan = run.pipe.plan
        src = plan.query_sources[0].name
        sink = plan.query_sinks[0].name
        hop = elem.admit(run.state[elem.name], elem.build_hop(
            torch.from_numpy(tok).to(run.device), active_t, admits0))
        outputs, run.state = self._serve_tick()(run.params, run.state,
                                                {src: hop})
        self.decode_ticks += 1
        run.frames += 1
        n_active = int(active.sum())
        self.batched_frames += n_active
        if n_active > 1:
            self.batches += 1
        self._pending_hop = {"k": 1, "x": outputs[sink].tensors[0],
                             "active": active, "active_t": active_t}
        return self._run_chain()

    def _run_chain(self) -> int:
        ph = self._pending_hop
        x, active, k = ph["x"], ph["active"], ph["k"]
        live = tuple(sorted(rec["sid"] for rec in self._iter_recs()
                            if rec.get("sid") is not None))
        while k < self.n_stages:
            # secure the stage BEFORE assembling the admit list: a trust
            # break replays into _readmit[k], and those freshly parked
            # caches must merge on THIS hop
            self._ensure_stage(k)
            rd = self._readmit.get(k, {})
            admit = tuple((int(slot), int(sid))
                          for slot, sid in sorted(rd.items())
                          if active[slot])
            ans = self._hop(k, (x, ph["active_t"]),
                            {"hop": "decode", "admit": admit, "live": live})
            if ans is None:
                ph["k"], ph["x"] = k, x
                return 0
            # x is now part of stage k's committed history: retain it as
            # replay feedstock AFTER the hop (an in-flight step must not be
            # replayed into a cache it never reached).  Hop outputs are
            # fresh tensors, so a retained row is never overwritten.
            for slot, rec in self._slots.items():
                rec["acts"][k].append(x[slot:slot + 1])
            self._readmit[k] = {}
            x = ans.tensors[0]
            k += 1
        self._pending_hop = None
        toks = x.cpu().numpy()      # the tick's one host read
        done = 0
        for slot in sorted(self._slots):
            rec = self._slots[slot]
            rec["tokens"].append(int(toks[slot]))
            self.tokens_generated += 1
            rec["remaining"] -= 1
            if rec["remaining"] <= 0:
                self._finish(rec)
                del self._slots[slot]
                for rd in self._readmit.values():
                    rd.pop(slot, None)
                done += 1
        return done

    def _iter_recs(self):
        yield from self._slots.values()
        yield from self._waiting
        yield from self._stalled

    # -- lifecycle edges -----------------------------------------------------------
    def on_reconfig(self):
        """Stage 0's pipeline was hot-swapped: whole-stream replay (its
        slice of the state starts afresh at the commit), stalled
        admissions join the replay queue, and downstream stages see fresh
        stream ids (their stale parked caches prune at the next hop's live
        list)."""
        stalled, self._stalled = self._stalled, []
        super().on_reconfig()
        for rec in stalled:
            self.replays += 1
            rec["tokens"] = []
            self._replay.append(rec)
        self._pending_hop = None
        self._readmit = {}

    def _abort_streams(self):
        super()._abort_streams()
        self._stalled.clear()
        self._pending_hop = None
        self._readmit = {}
        self._trust = {}

    def stats(self) -> Dict[str, int]:
        base = super().stats()
        base.update({
            "hops_dispatched": sum(self.hops_dispatched.values()),
            "hops_completed": sum(self.hops_completed.values()),
            "hops_failed": sum(self.hops_failed.values()),
            "stage_replays": sum(self.stage_replays.values()),
            "stage_replay_steps": sum(self.stage_replay_steps.values()),
            "hop_retransmits": self.hop_retransmits,
            "hop_dups": self.hop_dups,
            "hop_corrupt": self.hop_corrupt,
            "hop_push_drops": self.hop_push_drops,
        })
        return base

    def stage_ledger(self, k: int) -> Dict[str, int]:
        """Per-stage hop conservation record: every dispatched hop is
        completed or failed."""
        return {"dispatched": self.hops_dispatched.get(k, 0),
                "completed": self.hops_completed.get(k, 0),
                "failed": self.hops_failed.get(k, 0),
                "replays": self.stage_replays.get(k, 0),
                "replay_steps": self.stage_replay_steps.get(k, 0)}
