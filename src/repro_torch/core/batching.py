"""Server-side batching for the query protocol — port of the streaming half
of ``src/repro/core/batching.py``.

:class:`StreamingQueryBatcher` runs the continuous-batching lifecycle of a
``stream_serving`` server (DESIGN.md §7): prefill on arrival, decode ticks
in a slot of the plan-state batch, one answer when the generation budget is
spent.  :class:`QueryBatcher` holds the members it shares with the
stateless gather-stack-flush batcher; that batcher's own serve path, the
stage batchers and the delivery guard wait (ROADMAP M3, M8, M10).

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
from .buffers import StreamBuffer
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
    """Shared state of a server endpoint's batcher: the admission queue,
    the routing-meta hoist and the stats ledger.  ``run`` is the scheduler's
    pipeline-run record of the server pipeline."""

    def __init__(self, endpoint: QueryServerEndpoint, run: Any,
                 policy: BatchingPolicy, *,
                 clock: Optional[Callable[[], int]] = None):
        self.endpoint = endpoint
        self.run = run
        self.policy = policy
        self.admission = AdmissionQueue(qos=None, clock=clock)
        self.flushes = 0
        self.batches = 0
        self.batched_frames = 0

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
        raise NotImplementedError("stateless batched query serving "
                                  "(gather-stack-flush): ROADMAP M3")

    def _ingest(self):
        self.admission.ingest_channel(self.endpoint.requests)

    def _decode(self, raw: StreamBuffer) -> Tuple[StreamBuffer, Dict]:
        """Host-level decode + routing-meta hoist -> (clean frame, routing
        dict to re-attach on the answer)."""
        codec = raw.meta.get("codec", "none")
        buf = comp.decode(raw, codec)
        routing = {k: raw.meta[k] for k in _ROUTING_KEYS if k in raw.meta}
        clean = buf.with_(meta={k: v for k, v in buf.meta.items()
                                if k not in _ROUTING_KEYS})
        return clean, routing

    def stats(self) -> Dict[str, int]:
        """Base schema every batcher shares (subclasses extend it)."""
        adm = self.admission.stats()
        return {"flushes": self.flushes, "batches": self.batches,
                "batched_frames": self.batched_frames,
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
       waiting streams lowest-slot-first (arrival order), and ONE
       ``compiled_serve_tick`` call decodes the whole slot table.
    3. **finish** — slots whose ``finished`` lane fired deliver their
       tokens as one answer through the real serversink apply.

    Conservation: ``tokens_generated == tokens_delivered + tokens_dropped
    + tokens_in_flight``.  ``prefill_seconds`` / ``decode_seconds`` are host
    clock sums around the prefills and decode ticks; both end in a host
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
        #: client_id -> FIFO of live stream records (a client may pipeline
        #: a second request while its first stream is in flight)
        self._by_client: Dict[int, List[Dict]] = {}
        self._last_decode_tick: Optional[int] = None
        self.prefills = 0
        self.decode_ticks = 0
        self.tokens_generated = 0
        self.tokens_delivered = 0
        self.tokens_dropped = 0
        self.streams_started = 0
        self.streams_finished = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    # -- introspection ---------------------------------------------------------
    def in_flight(self, client_id: int) -> bool:
        return bool(self._by_client.get(client_id)) or \
            super().in_flight(client_id)

    def inflight_tokens(self) -> int:
        return sum(len(rec["tokens"]) for recs in self._by_client.values()
                   for rec in recs)

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
            raise NotImplementedError("stream recovery after an endpoint "
                                      "death (prefill replay): ROADMAP M6")
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
        adm = self.admission
        while True:
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
            rec = {"routing": routing, "tokens": [tok], "gen": gen,
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
        """ONE decode call over the whole slot table: waiting streams join,
        every active slot emits a token, spent slots leave."""
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
        serve = plan.compiled_serve_tick(run.state)
        outputs, run.state = serve(run.params, run.state,
                                   {src: elem.build_admit(admits)})
        toks, emitted, finished = outputs[sink].tensors
        lanes = torch.stack([toks, emitted.to(torch.int32),
                             finished.to(torch.int32)]).cpu().numpy()
        self.decode_seconds += time.perf_counter() - t0
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
        self.admission.mark_served(rec.pop("adm"))
        self._untrack(rec)

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
            "prefill_seconds": self.prefill_seconds,
            "decode_seconds": self.decode_seconds,
        })
        return base
