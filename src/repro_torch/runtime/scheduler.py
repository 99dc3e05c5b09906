"""Multi-pipeline runtime: an among-device deployment simulated in-process.

Port of the serving core of ``src/repro/runtime/scheduler.py``.  Each
Device owns a clock and a set of pipelines; the Runtime drives everything
with a global tick (60 Hz frame cadence, as in the paper's evaluation):

* client pipelines containing a ``tensor_query_client`` run *deferred*: the
  plan pauses at the client, the tick gathers every paused request into a
  round, encodes it per codec group and ships each request to the endpoint
  the Broker ranks first (its batcher flushes early when full);
* the drain flushes every server batcher — for a ``model_serve`` server
  that is the continuous-batching lifecycle (prefill on arrival, one decode
  tick per scheduler tick) — and resumes each paused frame with its answer,
  routed back by ``client_id``; streams still mid-generation re-enter the
  drain next tick;
* pipelines without query clients step once per tick.

Every pipeline's tensors live on one device: the GPU unless the caller
passes ``device="cpu"``.  Leases and failover, parking deadlines, live
reconfiguration, pub/sub bursts, mesh placement, tenant QoS, the lossy
network and autoscaling wait for their ROADMAP items (M6, M7, M3, M11, M9,
M10) and raise ``NotImplementedError`` where asked for.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from ..core.admission import merge_tenant_stats
from ..core.batching import (BatchingPolicy, StreamingQueryBatcher,
                             DEFAULT_QUERY_BATCH)
from ..core.broker import Broker, BrokerError
from ..core.buffers import StreamBuffer, structure_key
from ..core.pipeline import Pipeline
from ..core.plan import PendingQuery
from ..core.query import TensorQueryClient, TensorQueryServerSrc
from ..core.sync import PipelineClock, SimClock
from ..core import compression as comp
from ..device import DeviceLike, make_generator, resolve_device

TICK_NS = 16_666_667  # 60 Hz


@dataclass
class _PipeRun:
    pipe: Pipeline
    params: dict
    state: dict
    device: torch.device
    frames: int = 0
    skipped: int = 0
    last_outputs: Dict[str, StreamBuffer] = field(default_factory=dict)
    sink_log: Dict[str, list] = field(default_factory=dict)
    #: a retired run is skipped by the scheduler (it starts no new frames)
    retired: bool = False


def _is_server(run: _PipeRun) -> bool:
    return any(isinstance(e, TensorQueryServerSrc)
               for e in run.pipe.elements.values())


class Device:
    """One simulated device: a clock and the pipelines deployed on it.
    ``device`` is the torch device its pipelines' tensors live on (default:
    the GPU; see :func:`~repro_torch.device.resolve_device`)."""

    def __init__(self, name: str, clock: Optional[SimClock] = None,
                 device: DeviceLike = None):
        self.name = name
        self.clock = clock or SimClock()
        self.pipeline_clock = PipelineClock(self.clock)
        self.runs: List[_PipeRun] = []
        self.alive = True
        self.device = device

    def add_pipeline(self, pipe: Pipeline,
                     generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None) -> _PipeRun:
        """Realize ``pipe`` and initialize its params (from ``generator``,
        default seed 0 on the device) and state on ``device`` (default: this
        Device's, else the GPU)."""
        dev = resolve_device(device if device is not None else self.device)
        pipe.realize()
        g = generator if generator is not None else make_generator(0, dev)
        run = _PipeRun(pipe=pipe, params=pipe.init(g, dev),
                       state=pipe.init_state(dev), device=dev)
        self.runs.append(run)
        return run


class Runtime:
    def __init__(self, broker: Optional[Broker] = None,
                 tick_ns: int = TICK_NS, query_batch=DEFAULT_QUERY_BATCH,
                 device: DeviceLike = None, qos=None, mesh=None,
                 delivery=None):
        for value, what in ((qos, "tenant QoS (qos=): ROADMAP M9"),
                            (mesh, "mesh placement (mesh=): ROADMAP M11"),
                            (delivery, "the delivery layer (delivery=): "
                                       "ROADMAP M10")):
            if value is not None:
                raise NotImplementedError(what)
        #: the torch device every deployed pipeline must live on
        self.device = resolve_device(device)
        self.broker = broker or Broker()
        self.devices: List[Device] = []
        self.tick_ns = tick_ns
        self.batching = BatchingPolicy.of(query_batch)
        if not self.batching.enabled:
            raise NotImplementedError("query_batch=0 (synchronous round "
                                      "trips inside the client): ROADMAP M3")
        #: endpoint_id -> batcher for every runtime-wired serversrc
        self._batchers: Dict[int, StreamingQueryBatcher] = {}
        #: frames paused at a query client with no live server yet
        self._parked: List[Tuple[_PipeRun, PendingQuery]] = []
        #: frames whose stream is mid-generation on a live server
        self._inflight: List[Tuple[_PipeRun, PendingQuery]] = []
        self.parked_total = 0
        self.ticks = 0
        self._ntp_ref = SimClock()

    def add_device(self, device: Device) -> Device:
        for run in device.runs:
            if run.device != self.device:
                raise ValueError(f"{device.name}: pipeline on {run.device}, "
                                 f"runtime on {self.device}")
        self.devices.append(device)
        for run in device.runs:
            self._wire(run)
        device.pipeline_clock.calibrate(self._ntp_ref)
        device.pipeline_clock.start()
        return device

    def _wire(self, run: _PipeRun):
        for e in run.pipe.elements.values():
            if isinstance(e, TensorQueryClient) and e.broker is None:
                e.connect(self.broker)
            if isinstance(e, TensorQueryServerSrc) and e.registration is None:
                if not run.pipe.plan.stream_serving:
                    raise NotImplementedError(
                        "stateless query servers (gather-stack-flush "
                        "batching): ROADMAP M3; the port serves "
                        "model_serve pipelines")
                batcher = StreamingQueryBatcher(
                    e.endpoint, run, self.batching,
                    tick_source=lambda: self.ticks, clock=lambda: self.ticks)
                self._batchers[e.endpoint.endpoint_id] = batcher
                e.connect(self.broker, inline_runner=batcher.flush)
        # renegotiate with the broker wiring in place; the plan keeps its
        # fingerprint, so cached callables are reused
        run.pipe._realized = False
        run.pipe.realize()

    def reconfigure(self, run: _PipeRun, edit, warm_ticks: int = 1):
        raise NotImplementedError("live reconfiguration (prepare/warm/"
                                  "commit hot swap): ROADMAP M7")

    # -- liveness and load --------------------------------------------------------
    def _heartbeat(self):
        """Beat for every live device's registrations and refresh each
        server's declared load (queued requests), which the broker's
        ranking reads; then advance the broker's lease clock."""
        for dev in self.devices:
            if not dev.alive:
                continue
            for run in dev.runs:
                for e in run.pipe.elements.values():
                    reg = getattr(e, "registration", None)
                    if reg is None:
                        continue
                    self.broker.heartbeat(reg)
                    if isinstance(e, TensorQueryServerSrc):
                        b = self._batchers.get(e.endpoint.endpoint_id)
                        reg.load = float(len(e.endpoint.requests)) + \
                            float(len(b.admission) if b else 0)
        self.broker.tick()

    def _finish_frame(self, run: _PipeRun, outputs: Dict[str, StreamBuffer]):
        run.frames += 1
        run.last_outputs = outputs
        for name, buf in outputs.items():
            run.sink_log.setdefault(name, []).append(buf)
        return outputs

    def _run_once(self, run: _PipeRun):
        outputs, run.state = run.pipe.step(run.params, run.state)
        return self._finish_frame(run, outputs)

    # -- deferred query clients -------------------------------------------------
    def _begin_deferred(self, run: _PipeRun
                        ) -> Optional[Tuple[_PipeRun, PendingQuery]]:
        """Begin a frame that pauses at its first query client; None if the
        frame completed without pausing."""
        res = run.pipe.plan.run_deferred(run.params, run.state)
        if isinstance(res, PendingQuery):
            return run, res
        outputs, run.state = res
        self._finish_frame(run, outputs)
        return None

    @staticmethod
    def _codec_round(pairs, batch_fn) -> List:
        """Group ``(client, buffer)`` pairs by (codec, tensors structure),
        run ``batch_fn(buffers, codec)`` once per group, scatter the results
        back in input order."""
        res: List = [None] * len(pairs)
        groups: Dict[Tuple, List[int]] = {}
        for i, (qc, buf) in enumerate(pairs):
            key = (qc.codec, structure_key(buf.tensors))
            groups.setdefault(key, []).append(i)
        for (codec, _), idxs in groups.items():
            for i, out in zip(idxs, batch_fn([pairs[i][1] for i in idxs],
                                             codec)):
                res[i] = out
        return res

    def _after_send(self, pq: PendingQuery, ep):
        if pq.endpoint is not None and pq.endpoint is not ep:
            pq.redispatches += 1
        pq.endpoint = ep
        batcher = self._batchers.get(ep.endpoint_id)
        if batcher is None:
            runner = ep.spec.get("inline_runner")
            if runner is not None:
                runner()
        elif batcher.full():
            batcher.flush()

    def _dispatch_round(self, fresh: List[Tuple[_PipeRun, PendingQuery]]
                        ) -> List[Tuple[_PipeRun, PendingQuery]]:
        """Ship a round of freshly paused frames: resolve every endpoint
        first (unplaceable frames park), encode the requests per codec
        group, then push in arrival order."""
        ready = []
        for run, pq in fresh:
            try:
                ep = pq.client._endpoint()
            except BrokerError:
                self._park(run, pq)
                continue
            ready.append((run, pq, ep))
        encs = self._codec_round([(pq.client, pq.request)
                                  for _, pq, _ in ready], comp.encode_batch)
        out = []
        for (run, pq, ep), (enc, nbytes) in zip(ready, encs):
            pq.client.send_query_wire(enc, nbytes, ep)
            self._after_send(pq, ep)
            out.append((run, pq))
        return out

    def _dispatch_query(self, pq: PendingQuery) -> bool:
        """Ship one paused frame's request; False when no server matches."""
        try:
            ep = pq.client.send_query(pq.request)
        except BrokerError:
            return False
        self._after_send(pq, ep)
        return True

    def _park(self, run: _PipeRun, pq: PendingQuery):
        self.parked_total += 1
        self._parked.append((run, pq))

    def _retry_parked(self) -> List[Tuple[_PipeRun, PendingQuery]]:
        """Give every parked frame another shot (a server may have
        registered since)."""
        parked, self._parked = self._parked, []
        pending = []
        for run, pq in parked:
            if self._dispatch_query(pq):
                pending.append((run, pq))
            else:
                self._parked.append((run, pq))
        return pending

    def _drain_queries(self, pending: List[Tuple[_PipeRun, PendingQuery]]):
        """Flush every batcher, resume the paused frames that have their
        answers, and repeat for frames that pause again at a later client.
        A stream still decoding leaves the drain and re-enters next tick;
        a missing answer from a live endpoint with nothing in flight is a
        serving bug and raises."""
        pending = list(pending)
        while pending:
            for batcher in self._batchers.values():
                batcher.flush()
            nxt: List[Tuple[_PipeRun, PendingQuery]] = []
            answered = []
            for run, pq in pending:
                qc, ep = pq.client, pq.endpoint
                raw = qc.recv_answer_raw(ep)
                if raw is None:
                    b = self._batchers.get(ep.endpoint_id)
                    if ep.alive and b is not None and \
                            b.in_flight(qc.client_id):
                        self._inflight.append((run, pq))
                        continue
                    raise BrokerError(
                        f"{qc.name}: no answer from {qc.operation!r}"
                        + ("" if ep.alive else " (endpoint died; failover "
                           "is ROADMAP M6)"))
                answered.append((run, pq, raw))
            answers = self._codec_round(
                [(pq.client, raw) for _, pq, raw in answered],
                comp.decode_batch)
            for (run, pq, _), answer in zip(answered, answers):
                res = pq.resume(answer)
                if isinstance(res, PendingQuery):
                    if self._dispatch_query(res):
                        nxt.append((run, res))
                    else:
                        self._park(run, res)
                else:
                    outputs, run.state = res
                    self._finish_frame(run, outputs)
            pending = nxt

    def tick(self):
        self.ticks += 1
        self._ntp_ref.advance(self.tick_ns)
        for dev in self.devices:
            dev.clock.advance(self.tick_ns)
        self._heartbeat()
        pending = self._retry_parked()
        inflight, self._inflight = self._inflight, []
        pending.extend(inflight)
        busy = {id(run) for run, _ in pending} | \
            {id(run) for run, _ in self._parked}
        fresh: List[Tuple[_PipeRun, PendingQuery]] = []
        for dev in self.devices:
            if not dev.alive:
                continue
            for run in dev.runs:
                if run.retired or _is_server(run):
                    continue  # servers run batched, driven by their clients
                if id(run) in busy:
                    run.skipped += 1  # a frame is still in flight
                    continue
                if run.pipe.plan.has_query_clients:
                    paused = self._begin_deferred(run)
                    if paused is not None:
                        fresh.append(paused)
                else:
                    self._run_once(run)
        pending.extend(self._dispatch_round(fresh))
        self._drain_queries(pending)

    def run(self, n_ticks: int):
        for _ in range(n_ticks):
            self.tick()
        return self

    # -- stats ------------------------------------------------------------------
    def stats(self) -> Dict[str, Dict]:
        out = {}
        for dev in self.devices:
            for i, run in enumerate(dev.runs):
                out[f"{dev.name}/p{i}"] = {"frames": run.frames,
                                           "skipped": run.skipped}
        out["broker"] = {"relay_msgs": self.broker.relay_msgs,
                         "relay_bytes": self.broker.relay_bytes,
                         "lease_expiries": self.broker.expiries}
        out["failover"] = {"parked_total": self.parked_total,
                           "parked_now": len(self._parked),
                           "inflight_now": len(self._inflight)}
        agg = {}
        for b in self._batchers.values():
            for k, v in b.stats().items():
                agg[k] = agg.get(k, 0) + v
        out["query_batching"] = {"max_batch": self.batching.max_batch, **agg}
        tenants: Dict[str, Dict] = {}
        for b in self._batchers.values():
            merge_tenant_stats(tenants, b.tenant_stats())
        for tid, t in tenants.items():
            assert t["admitted"] == t["served"] + t["shed"] + \
                t["queued"] + t["in_flight"], \
                f"tenant {tid!r} leaks requests: {t}"
        out["tenants"] = tenants
        return out
