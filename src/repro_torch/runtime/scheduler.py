"""Multi-pipeline runtime: an among-device deployment simulated in-process.

Port of the serving core of ``src/repro/runtime/scheduler.py``.  Each
Device owns a clock and a set of pipelines; the Runtime drives everything
with a global tick (60 Hz frame cadence, as in the paper's evaluation):

* a pipeline runs only when its inputs are ready (an ``mqttsrc`` with
  nothing queued is not ready, like a GStreamer source blocking on no
  data); ``mqttsink`` publishes into its Channel, which broadcasts to every
  subscriber's bounded leaky queue;
* burst draining (``burst=8``): a subscriber pipeline whose sources all
  have frames queued (a slow consumer that fell behind, or a late joiner
  replaying retained history) drains up to ``burst`` of them in one tick.
  The host pulls them (one stacked codec decode per run of same-structure
  frames), stacks them, runs the plan's ``step_n`` in hoisted-I/O mode
  and replays the captured ``mqttsink`` frames through the real
  ``apply``, in order — bitwise the per-frame steps;
* client pipelines containing a ``tensor_query_client`` run *deferred*: the
  plan pauses at the client, the tick gathers every paused request into a
  round, encodes it per codec group and ships each request to the endpoint
  the Broker ranks first (its batcher flushes early when full);
* the drain flushes every server batcher — for a ``model_serve`` server
  that is the continuous-batching lifecycle (prefill on arrival, one decode
  tick per scheduler tick), for stage 0 of a ``model_serve_stage`` chain
  the same lifecycle driving one hop per stage (a stage k > 0 serves the
  hops inline), for any other server the stateless gather-stack-flush —
  and resumes each paused frame with its answer,
  routed back by ``client_id`` and decoded per (codec, structure) group;
  streams still mid-generation re-enter the drain next tick;
* pipelines without query clients step once per tick (or burst).

Cached executables (``Device.add_pipeline(jit=True)``, the default, as in
the JAX package): a pure pipeline steps through ``compiled_step``, bursts
through ``compiled_step_n``, a client whose only impure elements are its
query clients runs its deferred segments through
``run_deferred_compiled`` (on the fused wire path), and a server's batcher
serves through ``compiled_serve_batch`` / ``compiled_serve_tick``.  On the
card each is a CUDA graph per binding (``core/graphs.py``); on the CPU the
eager function.  ``jit=False`` runs that pipeline eagerly everywhere: the
explicit eager route on the card.

``query_batch=0`` turns batching off: client pipelines step like any other
and their ``tensor_query_client.apply`` is the synchronous round trip — it
sends, the server's batcher ``flush`` serves inline (one interpreted
server step per request), and it receives.

Fused wire path (default on, ``fused_wire=True``, DESIGN.md §5): a round's
requests encode in one stacked launch per codec group, a stateless server
decodes, serves and re-encodes each group in one fused call, and the
answers decode in one launch per group.  ``fused_wire=False`` encodes,
decodes and serves each request on its own (the eager path); both give the
same answers bitwise.

Failover (DESIGN.md §3): every tick the runtime heartbeats the broker for
each live device and advances its lease clock (``lease_ticks``), so a
silently dead server's registration expires.  A frame whose endpoint dies
before answering re-dispatches its retained request to the next-ranked
survivor, or parks until a server registers; ``park_deadline_ticks``
turns a frame parked that long into a client-visible error frame.  A
streaming server's orphaned streams regenerate by prefill replay.

Live reconfiguration (DESIGN.md §6): ``reconfigure(run, edit)`` prepares
and warms a topology edit off the serving path and commits it at a tick
boundary (``core/reconfig.py``).  Broker liveness events route through the
same manager: a server's death or revival is an unplanned reconfiguration.

Tenant QoS and elastic serving (DESIGN.md §9): ``qos=`` gives every
batcher but the hop servers the tenant-aware admission policy, turns an
admission shed into an explicit ``<client>.error`` frame, tightens a
parked frame's limit to its tenant's deadline, and spreads dispatches over
live replicas by join-shortest-queue.  Autoscalers
(``runtime/autoscale.py``) register in ``autoscalers`` and are stepped at
every tick boundary, right after pending reconfigurations.

The delivery layer (DESIGN.md §10): ``delivery=DeliveryPolicy()`` hands
the policy to every query client (delivery ids + CRCs on requests,
guarded answers) and a :class:`~..core.netfault.DeliveryGuard` to every
batcher and its serversink (request triage, answer replay cache); an
unanswered request from a live server retransmits on the policy's backoff
clock under its original delivery id.  A chaos scenario's
:class:`~..core.netfault.FaultFabric` set as ``rt.fabric`` is stepped at
the top of every tick.  ``stats()`` gains ``delivery`` and ``netfault``.

Mesh-sharded serving (DESIGN.md §4): ``Runtime(mesh=...)`` lays batched
query serves and hoisted pub/sub bursts out along the mesh's data slots,
one frame slice a slot, the params replicated once per distinct device,
whenever the batch tiles the slots and the plan threads no cross-frame
state (``ExecutionPlan.shardable_batch``).  ``mesh="auto"`` (or ``True``)
builds a host mesh: every visible CUDA device on the card, the runtime's
device on the CPU.  ``shard_mode`` picks the placement ("auto" probes
sharded against single once per batch size and keeps the faster,
"always"/"never" force it; bursts shard only under "always").  Sharding
never changes an answer: non-tiling groups, stateful plans and 1-slot
meshes serve exactly like ``mesh=None``, and failover re-dispatches the
orphans of a sharded batch like any other.  A mesh's slots must be on the
runtime's device type.

Every pipeline's tensors live on one device: the GPU unless the caller
passes ``device="cpu"``.

With the tracer on (``core/trace.py``, off by default) a tick is a
``sched.tick`` span tiled by ``sched.clients``, ``sched.dispatch`` and
``sched.drain``, the batchers' spans nested inside.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.admission import (DEFAULT_TENANT, QoSConfig,
                              merge_tenant_stats, percentile_from_hist)
from ..core.batching import (BatchingPolicy, QueryBatcher,
                             StagedStreamingBatcher, StageQueryBatcher,
                             StreamingQueryBatcher, DEFAULT_QUERY_BATCH)
from ..core.broker import Broker, BrokerError
from ..core.buffers import (StreamBuffer, stack_buffers, structure_key,
                             unstack_buffers)
from ..core.element import Element
from ..core.pipeline import Pipeline
from ..core.plan import PendingQuery
from ..core.pubsub import MqttSink, MqttSrc
from ..core.query import (QueryServerEndpoint, TensorQueryClient,
                          TensorQueryServerSrc)
from ..core.reconfig import ReconfigManager, ReconfigPlan
from ..core.sync import PipelineClock, SimClock
from ..core.trace import TRACER
from ..core import compression as comp
from ..core import netfault
from ..device import DeviceLike, make_generator, resolve_device

TICK_NS = 16_666_667  # 60 Hz
DEFAULT_BURST = 8


@dataclass
class _PipeRun:
    pipe: Pipeline
    params: dict
    state: dict
    device: torch.device
    #: one frame: ``pipe.compiled_step()`` for a pure pipeline with ``jit``,
    #: else ``pipe.step``
    step_fn: Callable
    #: the run takes the cached executables (module docstring)
    jit: bool = True
    frames: int = 0
    skipped: int = 0
    bursts: int = 0              # multi-frame drains executed
    burst_frames: int = 0        # frames delivered via bursts
    last_outputs: Dict[str, StreamBuffer] = field(default_factory=dict)
    sink_log: Dict[str, list] = field(default_factory=dict)
    #: a retired run is skipped by the scheduler (it starts no new frames)
    retired: bool = False
    #: ``params`` replicated on the runtime's mesh, placed at the first
    #: sharded burst (placing them per burst costs more than the burst)
    mesh_params: Any = None
    #: drops of elements a reconfiguration removed: their backlogs leave
    #: the topology with them, and the drop accounting keeps them
    carried_drops: int = 0

    @property
    def host_srcs(self) -> List[MqttSrc]:
        return self.pipe.plan.host_sources

    @property
    def host_sinks(self) -> List[MqttSink]:
        return self.pipe.plan.host_sinks


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
                     device: DeviceLike = None, jit: bool = True) -> _PipeRun:
        """Realize ``pipe`` and initialize its params (from ``generator``,
        default seed 0 on the device) and state on ``device`` (default: this
        Device's, else the GPU).  ``jit`` runs it through the cached
        executables (CUDA graphs on the card); ``jit=False`` eagerly."""
        dev = resolve_device(device if device is not None else self.device)
        pipe.realize()
        # the pipeline clock stamps and rebases pub/sub pts (§4.2.3)
        for e in pipe.elements.values():
            if isinstance(e, (MqttSink, MqttSrc)) and e.sync_clock is None:
                e.sync_clock = self.pipeline_clock
        g = generator if generator is not None else make_generator(0, dev)
        # pure pipelines step through the cached executable; host-impure
        # ones run the plan (their apply does channel I/O)
        fn = pipe.compiled_step() if (jit and pipe.plan.pure) else pipe.step
        run = _PipeRun(pipe=pipe, params=pipe.init(g, dev),
                       state=pipe.init_state(dev), device=dev, step_fn=fn,
                       jit=jit)
        self.runs.append(run)
        return run


class Runtime:
    def __init__(self, broker: Optional[Broker] = None,
                 tick_ns: int = TICK_NS, burst: int = DEFAULT_BURST,
                 query_batch=DEFAULT_QUERY_BATCH,
                 device: DeviceLike = None,
                 qos: Optional[QoSConfig] = None, mesh=None,
                 delivery: Optional[netfault.DeliveryPolicy] = None,
                 fused_wire: bool = True,
                 lease_ticks: Optional[int] = None,
                 park_deadline_ticks: Optional[int] = None,
                 shard_mode: str = "auto"):
        #: the torch device every deployed pipeline must live on
        self.device = resolve_device(device)
        if mesh in ("auto", True):
            from ..launch.mesh import make_host_mesh
            mesh = make_host_mesh(devices=None if self.device.type == "cuda"
                                  else [self.device])
        if mesh is not None:
            if not hasattr(mesh, "devices"):
                raise TypeError(f"mesh= takes a launch.mesh.Mesh, 'auto' or "
                                f"True, not {type(mesh).__name__}")
            kinds = {d.type for d in mesh.devices.flat}
            if kinds != {self.device.type}:
                raise ValueError(f"mesh slots on {sorted(kinds)}, runtime "
                                 f"on {self.device.type}: a mesh places "
                                 f"work on the runtime's device type only")
        #: the mesh batched serves and hoisted bursts may be laid out on
        #: (module docstring); None: single-device serving
        self.mesh = mesh
        # validated here too: a pub/sub-only deployment builds no batcher,
        # and the burst path would read a typo as "never"
        if shard_mode not in ("auto", "always", "never"):
            raise ValueError(f"shard_mode {shard_mode!r} not in "
                             f"('auto', 'always', 'never')")
        #: placement policy (module docstring)
        self.shard_mode = shard_mode
        self.broker = broker or Broker()
        if lease_ticks is not None:
            self.broker.default_lease_ticks = lease_ticks
        self.devices: List[Device] = []
        self.tick_ns = tick_ns
        #: most frames a subscriber pipeline drains in one tick
        self.burst = max(1, int(burst))
        #: query micro-batching policy (0 = synchronous round trips)
        self.batching = BatchingPolicy.of(query_batch)
        #: fused batched wire path (module docstring)
        self.fused_wire = bool(fused_wire)
        #: tenant-aware admission policy (DESIGN.md §9); None keeps every
        #: admission queue in global-FIFO pass-through, the pre-QoS fabric
        #: bit for bit
        self.qos = qos
        #: at-least-once delivery layer (module docstring); None keeps the
        #: reliable-transport wire bit for bit: no delivery ids, no
        #: checksums, no retransmits
        self.delivery = delivery
        #: the FaultFabric a chaos scenario installed, stepped at the top of
        #: every tick so held frames release on the scheduler's clock
        self.fabric = None
        #: client-side timeouts that re-shipped a request
        self.retransmits = 0
        #: elastic-serving controllers (runtime/autoscale.py), stepped at
        #: every tick boundary right after pending reconfigurations
        self.autoscalers: List = []
        #: this tick's dispatches per registration, on top of the heartbeat
        #: load the QoS join-shortest-queue reads (cleared every tick)
        self._load_bumps: Dict[int, int] = {}
        #: endpoint_id -> batcher for every runtime-wired serversrc
        self._batchers: Dict[int, QueryBatcher] = {}
        #: frames paused at a query client with no live server, as
        #: ``(run, pq, tick it first parked)``: re-parks keep the tick, so
        #: ``park_deadline_ticks`` measures the total time parked
        self._parked: List[Tuple[_PipeRun, PendingQuery, int]] = []
        #: frames whose stream is mid-generation on a live server
        self._inflight: List[Tuple[_PipeRun, PendingQuery]] = []
        #: ticks a frame may stay parked before it expires into an error
        #: frame (None: park until a server registers)
        self.park_deadline_ticks = park_deadline_ticks
        #: devices whose heartbeats are lost (a control-plane partition):
        #: they serve, but their leases lapse into suspicion
        self._control_blocked: set = set()
        #: tenant sheds the runtime owns (park expiries), in the
        #: AdmissionQueue.stats() schema so the ledgers merge
        self._tenant_shed: Dict[str, Dict] = {}
        #: tenant ledgers of batchers a reconfiguration retired
        self._tenant_archive: Dict[str, Dict] = {}
        # failover accounting (DESIGN.md §3)
        self.parked_total = 0
        #: queries shipped to another endpoint than the one they went to
        self.redispatches = 0
        self.parked_expired = 0
        self.orphaned_requests = 0
        self.ticks = 0
        self._ntp_ref = SimClock()
        # every topology change, planned hot swaps and broker liveness
        # events alike, routes through the reconfiguration manager
        self.reconfig = ReconfigManager(self)
        self.broker.watch(self.reconfig.on_broker_event)

    def add_device(self, device: Device) -> Device:
        for run in device.runs:
            if run.device != self.device:
                raise ValueError(f"{device.name}: pipeline on {run.device}, "
                                 f"runtime on {self.device}")
        self.devices.append(device)
        for run in device.runs:
            self._wire(device, run)
        device.pipeline_clock.calibrate(self._ntp_ref)
        device.pipeline_clock.start()
        return device

    def _wire(self, device: Device, run: _PipeRun):
        for e in run.pipe.elements.values():
            if isinstance(e, (MqttSink, MqttSrc, TensorQueryClient)) and \
                    e.broker is None:
                e.connect(self.broker)
            if isinstance(e, TensorQueryClient) and self.delivery is not None:
                e.delivery = self.delivery
            if isinstance(e, TensorQueryServerSrc) and e.registration is None:
                plan = run.pipe.plan
                if plan.stage_serving and plan.serve_stage[0] > 0:
                    # downstream hop of a pipeline-parallel chain (DESIGN.md
                    # §8): prefill/replay/decode-hop verbs against its layer
                    # slice, batch-1 caches parked by stream id; hop traffic
                    # is never re-scheduled (qos stays off)
                    batcher = StageQueryBatcher(
                        e.endpoint, run, self.batching,
                        mesh=self.mesh, shard_mode=self.shard_mode,
                        on_orphans=self._count_orphans,
                        qos=None, clock=lambda: self.ticks)
                elif plan.stage_serving:
                    # stage 0: the coordinator owns the request lifecycle
                    # (admitting under the tenants' budgets) and drives the
                    # hop chain to the stages it discovers through the
                    # broker
                    batcher = StagedStreamingBatcher(
                        e.endpoint, run, self.batching,
                        mesh=self.mesh, shard_mode=self.shard_mode,
                        on_orphans=self._count_orphans,
                        tick_source=lambda: self.ticks, qos=self.qos,
                        clock=lambda: self.ticks, broker=self.broker)
                elif plan.stream_serving:
                    batcher = StreamingQueryBatcher(
                        e.endpoint, run, self.batching,
                        mesh=self.mesh, shard_mode=self.shard_mode,
                        on_orphans=self._count_orphans,
                        tick_source=lambda: self.ticks, qos=self.qos,
                        clock=lambda: self.ticks)
                else:
                    batcher = QueryBatcher(
                        e.endpoint, run, self.batching,
                        inline_step=lambda r=run: self._run_once(r),
                        mesh=self.mesh, shard_mode=self.shard_mode,
                        fused=self.fused_wire,
                        on_orphans=self._count_orphans,
                        qos=self.qos, clock=lambda: self.ticks)
                if self.delivery is not None:
                    # one guard per endpoint, shared by the batcher (request
                    # triage) and its paired serversink (answer CRC and
                    # replay cache)
                    guard = netfault.DeliveryGuard(self.delivery)
                    batcher.guard = guard
                    if isinstance(batcher, StagedStreamingBatcher):
                        batcher.delivery = self.delivery
                    for el in run.pipe.elements.values():
                        if getattr(el, "is_query_sink", False) and \
                                getattr(el, "serversrc", None) is e:
                            el.guard = guard
                self._batchers[e.endpoint.endpoint_id] = batcher
                e.connect(self.broker, inline_runner=batcher.flush)
        # renegotiate with the broker wiring in place (mqttsink registers);
        # the plan keeps its fingerprint, so cached callables are reused
        run.pipe._realized = False
        run.pipe.realize()

    # -- live reconfiguration (DESIGN.md §6) --------------------------------------
    def reconfigure(self, run: _PipeRun, edit, warm_ticks: int = 1,
                    rng: Optional[torch.Generator] = None):
        """Apply a topology edit to a RUNNING pipeline.  ``edit`` is a
        :class:`~repro_torch.core.reconfig.ReconfigPlan`
        (``run.pipe.reconfig()``) or a callable that fills a fresh one; it
        prepares and warms at once and commits at the first tick boundary
        after ``warm_ticks`` ticks, or rolls back.  New elements draw their
        params from ``rng`` (default: seed 0 on the run's device).  Returns
        the :class:`~repro_torch.core.reconfig.Reconfiguration` handle."""
        plan = edit
        if not isinstance(edit, ReconfigPlan):
            plan = ReconfigPlan(run.pipe)
            edit(plan)
        return self.reconfig.request(run, plan, warm_ticks=warm_ticks,
                                     rng=rng)

    def _device_of(self, run: _PipeRun) -> Optional[Device]:
        for dev in self.devices:
            if run in dev.runs:
                return dev
        return None

    def _run_in_flight(self, run: _PipeRun) -> bool:
        """Whether the run has a frame paused across ticks (parked, or a
        stream mid-generation): a commit drains those on the old epoch
        first.  Only client runs pause; a server hot swap commits
        mid-decode."""
        return any(r is run for r, _, _ in self._parked) or \
            any(r is run for r, _ in self._inflight)

    def _count_orphans(self, n: int):
        """Orphan-ledger hook for the batchers' mid-flush deaths."""
        self.orphaned_requests += n

    def _retire_element(self, e: Element):
        """Take an element a committed reconfiguration removed out of the
        control plane: unregister its registration (clients re-bind, a
        query endpoint tears down through the manager's event path), close
        its consumer binding, drop its endpoint's batcher and keep that
        batcher's tenant ledgers."""
        reg = getattr(e, "registration", None)
        if reg is not None:
            self.broker.unregister(reg)
            e.registration = None
        binding = getattr(e, "binding", None)
        if binding is not None:
            binding.close()
            e.binding = None
        ep = getattr(e, "endpoint", None)
        if isinstance(ep, QueryServerEndpoint):
            b = self._batchers.pop(ep.endpoint_id, None)
            if b is not None:
                merge_tenant_stats(self._tenant_archive, b.tenant_stats())

    # -- liveness: heartbeats and leases --------------------------------------------
    def _heartbeat_and_lease(self):
        """Beat for every live device's registrations (a suspected one that
        beats again is healed) and refresh each server's declared load,
        which the broker's ranking reads: queued requests, plus, under QoS,
        the streams holding or waiting for decode slots (the autoscaler's
        and join-shortest-queue's signal, counted from the batcher's host
        records: no device read).  Then advance the broker's lease clock,
        expiring whoever went silent.  A device in ``_control_blocked``
        serves but does not beat."""
        for dev in self.devices:
            if not dev.alive or dev in self._control_blocked:
                continue
            for run in dev.runs:
                for e in run.pipe.elements.values():
                    reg = getattr(e, "registration", None)
                    if reg is None:
                        continue
                    if not reg.alive and reg.suspected:
                        self.broker.heal(reg)
                    self.broker.heartbeat(reg)
                    if isinstance(e, TensorQueryServerSrc):
                        # pre-QoS the load stays channel plus admission:
                        # the failover pins' binding choices depend on it
                        b = self._batchers.get(e.endpoint.endpoint_id)
                        load = float(len(e.endpoint.requests))
                        if b is not None:
                            load += float(len(b.admission))
                            if self.qos is not None and \
                                    hasattr(b, "active_streams"):
                                load += float(b.active_streams())
                        reg.load = load
        self.broker.tick()

    def _ready(self, run: _PipeRun) -> bool:
        """Every subscriber source has a frame (servers never get here:
        their batchers drive them)."""
        return all(e.queued() > 0 for e in run.pipe.elements.values()
                   if isinstance(e, MqttSrc))

    def _finish_frame(self, run: _PipeRun, outputs: Dict[str, StreamBuffer]):
        run.frames += 1
        run.last_outputs = outputs
        for name, buf in outputs.items():
            run.sink_log.setdefault(name, []).append(buf)
        return outputs

    def _run_once(self, run: _PipeRun):
        outputs, run.state = run.step_fn(run.params, run.state)
        return self._finish_frame(run, outputs)

    # -- deferred query clients -------------------------------------------------
    def _begin_deferred(self, run: _PipeRun
                        ) -> Optional[Tuple[_PipeRun, PendingQuery]]:
        """Begin a frame that pauses at its first query client; None if the
        frame completed without pausing.  On the fused wire path a client
        whose only impure elements are query clients runs its segments as
        cached executables (as the JAX package does); otherwise the walk is
        interpreted."""
        plan = run.pipe.plan
        if run.jit and self.fused_wire and plan.deferred_compilable:
            res = plan.run_deferred_compiled(run.params, run.state)
        else:
            res = plan.run_deferred(run.params, run.state)
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

    def _select_endpoint(self, qc) -> QueryServerEndpoint:
        """Endpoint for one dispatch.  Without QoS, the client's sticky
        binding (the failover pins depend on its win-back).  Under QoS with
        more than one live candidate, join-shortest-queue: the hard
        preferences of the broker's rank (stage, tenant, codec) first, then
        heartbeat load plus this tick's own dispatches (the heartbeat lags
        by a tick, and without the bump a whole round would land on one
        replica), then registration order.  The binding is untouched."""
        ep = qc._endpoint()
        if self.qos is None or qc.binding is None:
            return ep
        cands = [r for r in qc.binding._candidates()
                 if getattr(r.endpoint, "alive", True)]
        if len(cands) <= 1:
            return ep
        prefer = qc.binding.prefer

        def key(r):
            return (self.broker.rank_key(r, prefer)[:3],
                    r.load + self._load_bumps.get(r.reg_id, 0), r.reg_id)
        best = min(cands, key=key)
        self._load_bumps[best.reg_id] = \
            self._load_bumps.get(best.reg_id, 0) + 1
        return best.endpoint

    def _after_send(self, pq: PendingQuery, ep):
        if pq.endpoint is not None and pq.endpoint is not ep:
            self.redispatches += 1
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
        """Ship a round of freshly paused frames.  Fused wire path: resolve
        every endpoint first (unplaceable frames park), encode the requests
        per codec group, then push in arrival order.  Eager path: encode
        and ship each frame on its own."""
        if not self.fused_wire:
            out = []
            for run, pq in fresh:
                if self._dispatch_query(pq):
                    out.append((run, pq))
                else:
                    self._park(run, pq)
            return out
        ready = []
        for run, pq in fresh:
            try:
                ep = self._select_endpoint(pq.client)
            except BrokerError:
                # pq.endpoint keeps the dead server: a later dispatch of
                # the parked frame still counts as a re-dispatch
                self._park(run, pq)
                continue
            ready.append((run, pq, ep))
        encs = self._codec_round([(pq.client, pq.request)
                                  for _, pq, _ in ready], comp.encode_batch)
        out = []
        for (run, pq, ep), (enc, nbytes) in zip(ready, encs):
            self._stamp(pq)
            pq.client.send_query_wire(enc, nbytes, ep, dseq=pq.dseq)
            self._after_send(pq, ep)
            out.append((run, pq))
        return out

    def _stamp(self, pq: PendingQuery):
        """With delivery on, mint the frame's delivery id ONCE per logical
        request (parks, failover re-dispatches and timeout retransmits all
        reuse it, so receiver dedup makes every duplicate harmless) and arm
        its retransmit clock."""
        if self.delivery is not None:
            if pq.dseq is None:
                pq.dseq = pq.client.next_dseq()
            pq.next_retry = self.ticks + self.delivery.retry_in(pq.retries)

    def _dispatch_query(self, pq: PendingQuery) -> bool:
        """Ship one paused frame's retained request to the best-ranked live
        endpoint, recording where it went; False when no server matches
        (the caller parks the frame, whose ``endpoint`` keeps the dead
        server)."""
        try:
            ep = self._select_endpoint(pq.client)
        except BrokerError:
            return False
        self._stamp(pq)
        pq.client.send_query(pq.request, ep=ep, dseq=pq.dseq)
        self._after_send(pq, ep)
        return True

    # -- parking ------------------------------------------------------------------
    def _park(self, run: _PipeRun, pq: PendingQuery,
              t0: Optional[int] = None):
        """``t0`` is the tick the frame FIRST parked, kept across re-parks."""
        self.parked_total += 1
        self._parked.append((run, pq, self.ticks if t0 is None else t0))

    def _retry_parked(self) -> List[Tuple[_PipeRun, PendingQuery]]:
        """Give every parked frame another shot (a server may have
        registered or revived since); the rest stay parked."""
        parked, self._parked = self._parked, []
        pending = []
        for run, pq, t0 in parked:
            if self._dispatch_query(pq):
                pending.append((run, pq))
            else:
                self._park(run, pq, t0)
        return pending

    def _park_limit(self, qc) -> Optional[int]:
        """Ticks a frame of this client may stay parked: the tighter of the
        runtime's ``park_deadline_ticks`` and, under QoS, its tenant's
        ``deadline_ticks`` (parked time is queue time)."""
        limits = [self.park_deadline_ticks]
        if self.qos is not None:
            tenant = getattr(qc, "tenant", None) or DEFAULT_TENANT
            limits.append(self.qos.spec(tenant).deadline_ticks)
        limits = [m for m in limits if m is not None]
        return min(limits) if limits else None

    def _expire_parked(self):
        """A frame parked past its limit degrades explicitly: counted in
        ``parked_expired`` and on its tenant's shed ledger, answered with
        an error frame in its pipeline's sink log, and its pipeline is
        free to start fresh frames next tick."""
        if not self._parked:
            return
        keep = []
        for run, pq, t0 in self._parked:
            limit = self._park_limit(pq.client)
            if limit is not None and self.ticks - t0 >= limit:
                self.parked_expired += 1
                self._account_tenant_shed(pq.client, "deadline")
                self._expire_query(run, pq, limit)
            else:
                keep.append((run, pq, t0))
        self._parked = keep

    def _account_tenant_shed(self, qc, reason: str):
        """Book a runtime-owned shed (the request never reached a server's
        admission queue) on its tenant's ledger: one admission, one shed,
        and under QoS the tenant's priority."""
        tenant = getattr(qc, "tenant", None) or DEFAULT_TENANT
        led = self._tenant_shed.setdefault(tenant, {
            "admitted": 0, "served": 0, "shed": 0, "queued": 0,
            "in_flight": 0, "shed_reasons": {}, "latency_hist": {}})
        if self.qos is not None:
            led["priority"] = self.qos.spec(tenant).priority
        led["admitted"] += 1
        led["shed"] += 1
        led["shed_reasons"][reason] = led["shed_reasons"].get(reason, 0) + 1

    def _expire_query(self, run: _PipeRun, pq: PendingQuery,
                      parked_ticks: int):
        """Answer an expired park with an error frame, logged under
        ``<client>.error``: no tensors, meta naming the operation that
        found no server.  The frame itself is abandoned."""
        qc = pq.client
        err = StreamBuffer(tensors=(), meta={
            "error": "park-deadline",
            "operation": qc.operation,
            "parked_ticks": parked_ticks,
            "redispatches": pq.redispatches,
            "tick": self.ticks})
        run.sink_log.setdefault(f"{qc.name}.error", []).append(err)

    def _shed_query(self, run: _PipeRun, pq: PendingQuery, reason: str):
        """Answer a request the server's admission refused (rate budget,
        queue cap or deadline; already on the tenant's ledger) with an
        error frame under ``<client>.error`` naming the reason.  The frame
        is abandoned and its pipeline is free next tick."""
        qc = pq.client
        err = StreamBuffer(tensors=(), meta={
            "error": "shed", "reason": reason,
            "operation": qc.operation,
            "tenant": getattr(qc, "tenant", None) or DEFAULT_TENANT,
            "tick": self.ticks})
        run.sink_log.setdefault(f"{qc.name}.error", []).append(err)

    def _drain_queries(self, pending: List[Tuple[_PipeRun, PendingQuery]]):
        """Flush every batcher, resume the paused frames that have their
        answers, and repeat for frames that pause again at a later client.

        A frame whose endpoint died before answering re-dispatches its
        retained request to the next-ranked survivor (served in the next
        round) or parks.  A request the live endpoint's admission shed is
        answered with an error frame (never a silent drop, never a
        failover).  A stream still decoding, or a request a serve budget
        holds queued, leaves the drain and re-enters next tick.  A missing
        answer from a live endpoint with nothing in flight is lost or held
        in the network when the delivery layer is on: the request
        retransmits under its delivery id once its backoff clock is due
        (the server dedups it and replays a committed answer), else waits
        a tick; without the delivery layer it is a serving bug and raises.
        Each round every frame is answered, parked, raised on, deferred,
        retransmitted once, or moved to a live endpoint other than its dead
        one, so the drain ends."""
        pending = list(pending)
        while pending:
            for batcher in self._batchers.values():
                batcher.flush()
            nxt: List[Tuple[_PipeRun, PendingQuery]] = []
            answered = []
            for run, pq in pending:
                qc, ep = pq.client, pq.endpoint
                raw = qc.recv_answer_raw(ep, want=pq.dseq) \
                    if ep is not None else None
                if raw is None:
                    if ep is not None and ep.alive:
                        b = self._batchers.get(ep.endpoint_id)
                        if b is not None:
                            reason = b.admission.pop_notice(qc.client_id)
                            if reason is not None:
                                self._shed_query(run, pq, reason)
                                continue
                            if b.in_flight(qc.client_id):
                                self._inflight.append((run, pq))
                                continue
                        if self.delivery is not None and \
                                pq.dseq is not None:
                            if self.ticks >= pq.next_retry:
                                pq.retries += 1
                                self.retransmits += 1
                                if self._dispatch_query(pq):
                                    nxt.append((run, pq))
                                else:
                                    self._park(run, pq)
                            else:
                                self._inflight.append((run, pq))
                            continue
                        raise BrokerError(
                            f"{qc.name}: no answer from {qc.operation!r}")
                    if self._dispatch_query(pq):
                        nxt.append((run, pq))
                    else:
                        self._park(run, pq)
                    continue
                answered.append((run, pq, raw))
            answers = self._decode_answers(
                [(pq.client, raw) for _, pq, raw in answered])
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

    def _decode_answers(self, pairs) -> List[StreamBuffer]:
        """Decode a drain round's raw answers: one batched decode per
        (codec, structure) group on the fused path, per frame on the eager
        one."""
        if not self.fused_wire:
            return [comp.decode(raw, qc.codec) for qc, raw in pairs]
        return self._codec_round(pairs, comp.decode_batch)

    # -- burst draining -----------------------------------------------------------
    def _burst_size(self, run: _PipeRun) -> int:
        """Frames to drain this tick: at most ``burst`` and at most the
        shortest queue of the pipeline's subscriber sources."""
        plan = run.pipe.plan
        if self.burst <= 1 or not plan.burstable:
            return 1
        if not plan.all_sources_host_driven:
            # a self-driven source (live camera) would be fast-forwarded
            return 1
        return max(1, min([self.burst] +
                          [s.queued() for s in run.host_srcs]))

    def _deliver_frame(self, run: _PipeRun,
                       frame_outs: Dict[str, StreamBuffer]):
        """Route one frame of a burst: captured mqttsink frames replay
        through the element's real apply (encode, channel push, broker
        accounting); app-sink frames land in the log.  The bookkeeping of
        ``_run_once``: ``last_outputs`` replaced, the frame counted."""
        app_outs = {}
        for name, buf in frame_outs.items():
            elem = run.pipe.elements[name]
            if isinstance(elem, MqttSink):
                elem.apply(run.params.get(name, {}), [buf])
            else:
                app_outs[name] = buf
                run.sink_log.setdefault(name, []).append(buf)
        run.last_outputs = app_outs
        run.frames += 1

    def _run_burst(self, run: _PipeRun, n: int):
        """Drain ``n`` queued frames through one ``step_n`` call."""
        pulls = {s.name: s.pull_burst(n) for s in run.host_srcs}
        if any(len(v) != n for v in pulls.values()):
            # a channel raced below n: replay what was pulled per frame
            return self._replay_frames(run, pulls)
        try:
            stacked = {k: stack_buffers(v) for k, v in pulls.items()}
        except ValueError:
            # frames of differing structure cannot stack: per frame
            return self._replay_frames(run, pulls)
        # pub/sub bursts shard only in forced mode: they run off the serving
        # hot path (catch-up drains) and pay no calibration probes
        mesh = self.mesh if self.shard_mode == "always" else None
        params = run.params
        if mesh is not None and run.pipe.plan.shardable_batch(n, run.state,
                                                              mesh):
            if run.mesh_params is None:
                from ..launch.shardings import replicated
                run.mesh_params = replicated(mesh, run.params)
            params = run.mesh_params
        if run.jit:
            outs, run.state = run.pipe.compiled_step_n(
                hoist_io=True, mesh=mesh)(params, run.state, stacked)
        else:
            outs, run.state = run.pipe.plan.step_n(
                params, run.state, stacked, hoist_io=True, mesh=mesh)
        for frame_outs in unstack_buffers(outs, n):
            self._deliver_frame(run, frame_outs)
        run.bursts += 1
        run.burst_frames += n

    def _replay_frames(self, run: _PipeRun, pulls: Dict[str, list]):
        """Per-frame steps for frames already pulled off the channels.
        Every source needs a frame each step, so only the shortest pull
        runs; surplus frames go back to the front of their sources."""
        n = min(len(v) for v in pulls.values()) if pulls else 0
        for name, frames in pulls.items():
            if len(frames) > n:
                run.pipe.elements[name].unread(frames[n:])
        for i in range(n):
            inputs = {k: v[i] for k, v in pulls.items()}
            outputs, run.state = run.pipe.plan.run(
                run.params, run.state, inputs, hoist_io=True)
            self._deliver_frame(run, outputs)

    def tick(self):
        on = TRACER.on
        if on:
            top = TRACER.begin("sched.tick")
        self.ticks += 1
        if self.fabric is not None:
            # the fault clock first: frames the network held (delay,
            # reorder) land before anything runs, and this tick's scripted
            # partitions take effect
            self.fabric.step(self.ticks)
        self._ntp_ref.advance(self.tick_ns)
        for dev in self.devices:
            dev.clock.advance(self.tick_ns)
        self._heartbeat_and_lease()
        # tick boundary: pending reconfigurations commit (or drain or roll
        # back) before any frame of this tick starts
        self.reconfig.step()
        # autoscalers read the scaling signal once pending reconfigurations
        # settled; their scale-ups and scale-downs are reconfigurations
        # that commit on later ticks
        for scaler in list(self.autoscalers):
            scaler.step()
        self._load_bumps.clear()
        self._expire_parked()
        # parked frames go first (a server may be back); then streams
        # mid-generation re-enter the drain (a dead server's re-dispatch
        # or park like any in-flight query)
        pending = self._retry_parked()
        inflight, self._inflight = self._inflight, []
        pending.extend(inflight)
        busy = {id(run) for run, _ in pending} | \
            {id(run) for run, _, _ in self._parked}
        fresh: List[Tuple[_PipeRun, PendingQuery]] = []
        if on:
            sp = TRACER.begin("sched.clients")
        for dev in self.devices:
            if not dev.alive:
                continue
            for run in dev.runs:
                if run.retired or _is_server(run):
                    continue  # servers run batched, driven by their clients
                if id(run) in busy:
                    run.skipped += 1  # a frame is still in flight
                    continue
                if not self._ready(run):
                    run.skipped += 1
                    continue
                if run.pipe.plan.has_query_clients and \
                        self.batching.enabled:
                    paused = self._begin_deferred(run)
                    if paused is not None:
                        fresh.append(paused)
                    continue
                n = self._burst_size(run)
                if n > 1:
                    self._run_burst(run, n)
                else:
                    self._run_once(run)
        if on:
            sp = TRACER.then(sp, "sched.dispatch")
        pending.extend(self._dispatch_round(fresh))
        if on:
            sp = TRACER.then(sp, "sched.drain")
        self._drain_queries(pending)
        if on:
            TRACER.end(sp)
            TRACER.end(top)

    def run(self, n_ticks: int):
        for _ in range(n_ticks):
            self.tick()
        return self

    def batchers(self) -> List[QueryBatcher]:
        """The batchers of the runtime-wired servers, in wiring order."""
        return list(self._batchers.values())

    # -- stats ------------------------------------------------------------------
    def stats(self) -> Dict[str, Dict]:
        out = {}
        for dev in self.devices:
            for i, run in enumerate(dev.runs):
                drops = run.carried_drops
                for e in run.pipe.elements.values():
                    if isinstance(e, MqttSrc):
                        drops += e.drops   # across every publisher bound
                    elif isinstance(e, MqttSink):
                        drops += e.channel.drops
                out[f"{dev.name}/p{i}"] = {"frames": run.frames,
                                           "skipped": run.skipped,
                                           "bursts": run.bursts,
                                           "burst_frames": run.burst_frames,
                                           "drops": drops}
        out["broker"] = {"relay_msgs": self.broker.relay_msgs,
                         "relay_bytes": self.broker.relay_bytes,
                         "lease_expiries": self.broker.expiries,
                         "suspicions": self.broker.suspicions,
                         "heals": self.broker.heals}
        out["failover"] = {"redispatches": self.redispatches,
                           "parked_total": self.parked_total,
                           "parked_now": len(self._parked),
                           "inflight_now": len(self._inflight),
                           "parked_expired": self.parked_expired,
                           "orphaned_requests": self.orphaned_requests}
        out["reconfig"] = self.reconfig.stats()
        # the stateless keys are always present, 0 with no server deployed
        agg = {"flushes": 0, "batches": 0, "batched_frames": 0,
               "sequential_frames": 0, "sharded_batches": 0,
               "sharded_frames": 0, "fused_batches": 0, "fused_frames": 0,
               "flush_orphans": 0}
        for b in self._batchers.values():
            for k, v in b.stats().items():
                agg[k] = agg.get(k, 0) + v
        out["query_batching"] = {"max_batch": self.batching.max_batch, **agg}
        tenants: Dict[str, Dict] = {}
        for b in self._batchers.values():
            merge_tenant_stats(tenants, b.tenant_stats())
        merge_tenant_stats(tenants, self._tenant_archive)
        merge_tenant_stats(tenants, self._tenant_shed)
        for tid, t in tenants.items():
            t["p50_ticks"] = percentile_from_hist(t["latency_hist"], 0.50)
            t["p99_ticks"] = percentile_from_hist(t["latency_hist"], 0.99)
            assert t["admitted"] == t["served"] + t["shed"] + \
                t["queued"] + t["in_flight"], \
                f"tenant {tid!r} leaks requests: {t}"
        out["tenants"] = tenants
        if self.delivery is not None:
            d = {"retransmits": self.retransmits, "accepted": 0,
                 "deduped": 0, "rejected_corrupt": 0, "replayed": 0,
                 "answer_drops": 0, "client_answer_dups": 0,
                 "client_answer_corrupt": 0, "client_push_drops": 0}
            for b in self._batchers.values():
                if b.guard is not None:
                    for k, v in b.guard.stats().items():
                        d[k] += v
            for dev in self.devices:
                for run in dev.runs:
                    for e in run.pipe.elements.values():
                        if isinstance(e, TensorQueryClient):
                            d["client_answer_dups"] += e.answer_dups
                            d["client_answer_corrupt"] += e.answer_corrupt
                            d["client_push_drops"] += e.push_drops
                        elif getattr(e, "is_query_sink", False):
                            d["answer_drops"] += e.answer_drops
            out["delivery"] = d
        if self.fabric is not None:
            out["netfault"] = self.fabric.stats()
        if self.autoscalers:
            out["autoscale"] = [s.stats() for s in self.autoscalers]
        return out
