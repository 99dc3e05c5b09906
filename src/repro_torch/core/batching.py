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
prefill replay (DESIGN.md §3, §7).  The stage batchers and the delivery
guard wait (ROADMAP M8, M10).

Requests drain through one :class:`~.admission.AdmissionQueue`; the port
runs it at ``qos=None`` — global arrival order, plus the per-tenant ledger.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .admission import AdmissionQueue
from .buffers import StreamBuffer, structure_key, unstack_buffers
from .query import QueryServerEndpoint
from . import compression as comp

__all__ = ["BatchingPolicy", "QueryBatcher", "StreamingQueryBatcher",
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
    the dead server.  The mesh placement and the delivery guard of the JAX
    package wait (ROADMAP M11, M10)."""

    def __init__(self, endpoint: QueryServerEndpoint, run: Any,
                 policy: BatchingPolicy,
                 inline_step: Optional[Callable[[], Any]] = None,
                 fused: bool = True,
                 on_orphans: Optional[Callable[[int], None]] = None, *,
                 clock: Optional[Callable[[], int]] = None):
        self.endpoint = endpoint
        self.run = run
        self.policy = policy
        self.inline_step = inline_step
        #: codec-fused serving; False = decode, serve, encode per request
        self.fused = fused
        #: called with the number of admitted requests a dying endpoint
        #: abandons (the runtime's orphan ledger; the paused frames
        #: re-dispatch from their PendingQuery records)
        self.on_orphans = on_orphans
        self.admission = AdmissionQueue(qos=None, clock=clock)
        self.flushes = 0
        self.batches = 0
        self.batched_frames = 0
        self.sequential_frames = 0
        self.fused_batches = 0
        self.fused_frames = 0
        self.orphaned = 0

    def in_flight(self, client_id: int) -> bool:
        """Whether ``client_id`` has work the scheduler must keep waiting on."""
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
            if not len(adm):
                break
            if not batchable:
                rec = adm.take(1)[0]
                self._serve_sequential(rec)
                served += 1
                continue
            recs = adm.take(self.policy.max_batch)
            raws = [r.raw for r in recs]
            groups = self._group_wire(raws) if self.fused else \
                [(g, None) for g in self._group(raws)]
            idx = 0
            for pairs, codec in groups:
                if not self.endpoint.alive:
                    # died mid-flush: the rest was popped, never served
                    self._shed_flush_remainder(recs[idx:])
                    break
                if codec is None or codec.partition(":")[0] == "none":
                    self._serve_batched(pairs)    # eager, or nothing to fuse
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
        self.admission.ingest_channel(self.endpoint.requests)

    # -- a dead endpoint -------------------------------------------------------
    def _forget_delivery(self, rec):
        """Evict a shed request's delivery id from the dedup window, so its
        re-dispatch is not deduplicated away.  A no-op until the delivery
        layer (ROADMAP M10): the port's requests carry no delivery id."""

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
        """The served pipeline was hot-swapped under this batcher.  The
        stateless batcher keeps nothing of the old epoch (its plan and
        params are always read through ``run``); the JAX package drops its
        mesh placements here (ROADMAP M11)."""

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
        src = plan.query_sources[0].name
        frames_in = tuple({src: clean} for clean, _ in group)
        serve = plan.compiled_serve_batch() if run.jit else plan.serve_batch
        frames_out, run.state = serve(run.params, run.state, frames_in)
        for (_, routing), frame in zip(group, frames_out):
            self._route(frame, routing)
            run.frames += 1
        self._count(len(group))

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
                "sharded_batches": 0, "sharded_frames": 0,   # ROADMAP M11
                "fused_batches": self.fused_batches,
                "fused_frames": self.fused_frames,
                "flush_orphans": self.orphaned,
                "admitted_requests": sum(t["admitted"] for t in adm.values()),
                "served_requests": sum(t["served"] for t in adm.values()),
                "shed_requests": sum(t["shed"] for t in adm.values()),
                "queued_requests": sum(t["queued"] for t in adm.values())}

    def tenant_stats(self) -> Dict[str, Dict]:
        return self.admission.stats()


class StreamingQueryBatcher(QueryBatcher):
    """Continuous-batching request lifecycle (DESIGN.md §7).

    Per flush (called every scheduler drain round):

    1. **admit** — pop every pending request, decode it, run the serve
       element's host prefill (first token + batch-1 cache, on the card),
       and queue the stream for a slot.  ``gen <= 1`` answers at once.
    2. **decode tick** — at most once per scheduler tick: free slots go to
       waiting streams lowest-slot-first (arrival order) and are admitted
       into the plan state eagerly, then ONE ``compiled_serve_tick`` call
       (a CUDA graph on the card) decodes the whole slot table.
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
    read of the result, so they include the device time."""

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
        if tick != self._last_decode_tick and (self._slots or self._waiting):
            self._last_decode_tick = tick
            served += self._decode_tick()
        if served:
            self.flushes += 1
        return served

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
                t0 = time.perf_counter()
                tok, cache = elem.host_prefill(params, rec["prompt"])
                self.prefill_seconds += time.perf_counter() - t0
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
            recs = adm.take(1)
            if not recs:
                break
            arec = recs[0]
            clean, routing = self._decode(arec.raw)
            gen = int(clean.meta.get("gen", 1))
            t0 = time.perf_counter()
            tok, cache = elem.host_prefill(params, clean.tensors[0])
            self.prefill_seconds += time.perf_counter() - t0
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

    def _decode_tick(self) -> int:
        """ONE decode call over the whole slot table: waiting streams join
        (admitted eagerly, in place), every active slot emits a token
        through the cached serve tick, spent slots leave."""
        run = self.run
        plan = run.pipe.plan
        elem = self._serve_elem()
        free = [s for s in range(elem.slots) if s not in self._slots]
        admits = []
        while free and self._waiting:
            rec = self._waiting.pop(0)
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
        if run.jit:
            serve = plan.compiled_serve_tick(run.state)
        else:
            def serve(params, state, inputs):
                return plan.run(params, state, inputs, hoist_io=True,
                                hoist_queries=True)
        outputs, run.state = serve(run.params, run.state,
                                   {src: elem.empty_admit()})
        toks, emitted, finished = outputs[sink].tensors
        lanes = torch.stack([toks, emitted.to(torch.int32),
                             finished.to(torch.int32)]).cpu().numpy()
        self.decode_times.append(time.perf_counter() - t0)
        self.decode_seconds += self.decode_times[-1]
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
