"""Pub/Sub stream elements — ``mqttsink`` / ``mqttsrc`` (paper §4.2.1).

Port of ``src/repro/core/pubsub.py``.  Transports:

* ``RELAY``  — the data plane goes through the broker (pure MQTT): every
  frame is accounted on the broker, an extra hop.
* ``HYBRID`` — the broker only does discovery and control; frames travel
  on a direct channel between the two pipelines (MQTT-hybrid).
* ``DIRECT`` — no broker at all (the ZeroMQ/TCP baseline: no discovery, a
  fixed endpoint wired with ``connect_direct``).

A publisher's :class:`Channel` puts ONE payload object into every
subscriber's queue.  Torch tensors are mutable, so no element of the port
may write into a frame it received: every element builds new tensors.
"""
from __future__ import annotations

import enum
from collections import deque
from typing import Deque, Dict, Optional

import torch

from .broker import Broker, BrokerError
from .buffers import StreamBuffer, structure_key, to_device
from .element import Element, PipelineContext, register_element
from .formats import Caps
from . import compression as comp

__all__ = ["Transport", "Channel", "MqttSink", "MqttSrc"]


class Transport(enum.Enum):
    RELAY = "relay"      # pure MQTT: broker carries data
    HYBRID = "hybrid"    # MQTT-hybrid: broker control, direct data
    DIRECT = "direct"    # raw TCP/ZeroMQ: no broker involvement


class Channel:
    """Bounded FIFO standing in for a network socket between two pipelines,
    with byte accounting; ``latency_ns`` models link delay.  A push onto a
    full queue drops the oldest frame (leaky) and counts it.

    Pub/sub semantics: a publisher Channel with attached consumers
    BROADCASTS every frame to each consumer queue (every subscriber gets
    every message).  With no consumers it queues locally (point to point:
    the query protocol's request and response channels)."""

    def __init__(self, capacity: int = 16, latency_ns: int = 0):
        self.q: Deque = deque()
        self.capacity = capacity
        self.latency_ns = latency_ns
        self.bytes_sent = 0
        self.msgs_sent = 0
        self.drops = 0
        self.consumers = []

    def attach_consumer(self, capacity: Optional[int] = None) -> "Channel":
        """A new subscriber queue.  A late subscriber still sees the queued
        history, but only its newest ``capacity`` frames; the skipped ones
        are booked as the new queue's leaky drops."""
        ch = Channel(capacity=capacity or self.capacity,
                     latency_ns=self.latency_ns)
        self.consumers.append(ch)
        history = list(self.q)
        survivors = history[-ch.capacity:]
        ch.drops += len(history) - len(survivors)
        ch.q.extend(survivors)
        return ch

    def _enqueue(self, buf: StreamBuffer) -> bool:
        """Returns False iff the append displaced a queued frame."""
        dropped = len(self.q) >= self.capacity
        if dropped:
            self.drops += 1
            self.q.popleft()
        self.q.append(buf)
        return not dropped

    def push(self, buf: StreamBuffer, nbytes: Optional[int] = None) -> bool:
        """Returns False iff enqueueing displaced a frame anywhere (locally
        or on any consumer queue); the displaced frame is booked on the
        displacing queue's ``drops``."""
        self.bytes_sent += buf.nbytes() if nbytes is None else nbytes
        self.msgs_sent += 1
        if self.consumers:
            ok = True
            for c in self.consumers:
                ok = c._enqueue(buf) and ok
            return ok
        return self._enqueue(buf)

    def pop(self) -> Optional[StreamBuffer]:
        return self.q.popleft() if self.q else None

    def pop_n(self, max_n: int) -> list:
        """Drain up to ``max_n`` queued buffers in FIFO order."""
        out = []
        while len(out) < max_n and self.q:
            out.append(self.q.popleft())
        return out

    def __len__(self):
        return len(self.q)


@register_element("mqttsink")
class MqttSink(Element):
    """Publish the incoming stream under ``pub-topic``.  Properties:
    pub_topic, transport (relay|hybrid|direct), codec (none|quant8|sparse,
    the compressed transmission of the wire codecs)."""

    n_src_pads = 0
    host_impure = True
    is_host_sink = True

    def __init__(self, name=None, pub_topic="", transport="hybrid",
                 codec="none", broker: Optional[Broker] = None,
                 sync_clock=None, **props):
        super().__init__(name=name, **props)
        self.topic = props.get("pub-topic", pub_topic)
        self.transport = Transport(transport)
        self.codec = codec
        self.broker = broker
        self.channel = Channel()
        self.registration = None
        self.sync_clock = sync_clock  # PipelineClock for §4.2.3 timestamps

    def connect(self, broker: Broker):
        self.broker = broker
        return self

    def negotiate(self, in_caps):
        caps = in_caps[0] if in_caps else Caps.ANY
        if self.broker is not None and self.transport != Transport.DIRECT:
            # register once: the runtime's re-wire realizes the pipeline a
            # second time, and a fresh registration would duplicate the
            # topic; a caps change updates the standing registration
            if self.registration is None:
                self.registration = self.broker.register(
                    self.topic, caps, self.channel,
                    codec=self.codec, element=self.name)
            else:
                self.registration.caps = caps
        self._caps = caps
        return []

    def apply(self, params, inputs, ctx: PipelineContext = None):
        payload, nbytes = comp.encode(inputs[0], self.codec)
        if self.sync_clock is not None:
            payload = payload.with_(meta={
                **payload.meta,
                "base_time_utc": self.sync_clock.base_time_utc()})
        if self.transport == Transport.RELAY and self.broker is not None:
            self.broker.relay(nbytes)  # extra hop through the broker
        self.channel.push(payload, nbytes)
        return []


@register_element("mqttsrc")
class MqttSrc(Element):
    """Subscribe to ``sub-topic`` (wildcards allowed) and emit frames.

    Discovery resolves through the broker to a publisher Channel; if the
    bound publisher dies, the binding fails over.  DIRECT transport
    bypasses discovery: the channel is wired with ``connect_direct``."""

    n_sink_pads = 0
    host_impure = True
    is_host_source = True

    def __init__(self, name=None, sub_topic="", transport="hybrid",
                 codec="none", broker: Optional[Broker] = None,
                 is_live="false", sync_clock=None, **props):
        super().__init__(name=name, **props)
        self.topic_filter = props.get("sub-topic", sub_topic)
        self.transport = Transport(transport)
        self.codec = codec
        self.broker = broker
        self.binding = None
        self._direct: Optional[Channel] = None
        self._rx: Optional[Channel] = None      # per-subscriber queue
        self._rx_src: Optional[Channel] = None  # publisher it's attached to
        #: one consumer queue per publisher ever bound (id(pub) -> (pub,
        #: rx)): binding back to a publisher REUSES its queue, so history
        #: is never replayed twice; the publisher is kept alongside so its
        #: id() cannot be recycled while the entry lives
        self._rx_hist: Dict[int, tuple] = {}
        self._pushback: Deque = deque()         # decoded frames handed back
        self.sync_clock = sync_clock
        #: the pipeline's device (set by ``init_state``): a numpy frame,
        #: such as an edge sensor's, becomes tensors there on receipt
        self._device: Optional[torch.device] = None

    def init_state(self, device) -> dict:
        self._device = device
        return {}

    def connect(self, broker: Broker):
        self.broker = broker
        return self

    def connect_direct(self, channel: Channel):
        self._direct = channel
        return self

    def _resolve(self) -> Channel:
        """Per-subscriber receive queue, re-attached after failover.  Frames
        still queued from the old publisher are decoded into the pushback
        line (in order, ahead of the new publisher's), so a rebind loses
        nothing."""
        if self.transport == Transport.DIRECT:
            if self._direct is None:
                raise BrokerError(
                    f"{self.name}: DIRECT transport needs connect_direct()")
            pub = self._direct
        else:
            if self.binding is None:
                self.binding = self.broker.subscribe(self.topic_filter)
            pub = self.binding.endpoint
        if self._rx_src is not pub:
            if self._rx is not None:
                while True:
                    raw = self._rx.pop()
                    if raw is None:
                        break
                    self._pushback.append(self._decode(raw))
            prev = self._rx_hist.get(id(pub))
            self._rx = prev[1] if prev is not None else pub.attach_consumer()
            self._rx_hist[id(pub)] = (pub, self._rx)
            self._rx_src = pub
        return self._rx

    @property
    def drops(self) -> int:
        """Leaky-queue drops across every publisher ever bound."""
        return sum(rx.drops for _, rx in self._rx_hist.values())

    def negotiate(self, in_caps):
        # caps come from the discovered publisher when there is one; the
        # binding is reused across re-negotiations
        if self.broker is not None and self.transport != Transport.DIRECT:
            try:
                if self.binding is None:
                    self.binding = self.broker.subscribe(self.topic_filter)
                if self.binding.current is not None:
                    return [self.binding.current.caps]
            except BrokerError:
                pass
        return [Caps.ANY]

    def unread(self, bufs) -> None:
        """Hand already-decoded frames back to the front of the line (the
        scheduler's burst surplus); a raw re-queue would decode twice."""
        self._pushback.extendleft(reversed(list(bufs)))

    def _decode(self, raw: StreamBuffer) -> StreamBuffer:
        buf = comp.decode(raw, self.codec)
        if self._device is not None:
            buf = to_device(buf, self._device)
        if self.sync_clock is not None and "base_time_utc" in buf.meta:
            # §4.2.3: rebase the publisher's running time into ours
            buf = self.sync_clock.rebase(buf)
        return buf

    def pull(self) -> Optional[StreamBuffer]:
        """Host-level receive (the runtime scheduler's path)."""
        if self._pushback:
            return self._pushback.popleft()
        chan = self._resolve()
        if self._pushback:
            # a rebind just carried the old publisher's frames over
            return self._pushback.popleft()
        raw = chan.pop()
        if raw is None:
            return None
        return self._decode(raw)

    def queued(self) -> int:
        """Frames waiting (pushback + subscriber queue; 0 queued when the
        binding cannot resolve), the burst-sizing signal.  Resolves first:
        a rebind moves stranded frames into the pushback line."""
        try:
            n = len(self._resolve())
        except BrokerError:
            return len(self._pushback)
        return len(self._pushback) + n

    def pull_burst(self, max_n: int) -> list:
        """Drain up to ``max_n`` decoded frames.  Queued raw frames decode
        in one stacked codec call per run of same-structure frames
        (``compression.decode_batch``), bitwise the per-frame decode;
        pushed-back frames keep their place at the front."""
        out = []
        while len(out) < max_n and self._pushback:
            out.append(self._pushback.popleft())
        if len(out) >= max_n:
            return out
        try:
            chan = self._resolve()
        except BrokerError:
            return out
        while len(out) < max_n and self._pushback:
            out.append(self._pushback.popleft())
        raws = []
        while len(out) + len(raws) < max_n:
            raw = chan.pop()
            if raw is None:
                break
            raws.append(raw)
        out.extend(self._decode_burst(raws))
        return out

    def _decode_burst(self, raws: list) -> list:
        """Batched :meth:`_decode`: consecutive runs with one tensors
        structure share one stacked decode (per-frame meta does not split
        a run); the clock rebase stays per frame."""
        decoded = []
        i = 0
        while i < len(raws):
            j = i + 1
            key = structure_key(raws[i].tensors)
            while j < len(raws) and structure_key(raws[j].tensors) == key:
                j += 1
            decoded.extend(comp.decode_batch(raws[i:j], self.codec))
            i = j
        if self._device is not None:
            decoded = [to_device(b, self._device) for b in decoded]
        if self.sync_clock is not None:
            decoded = [self.sync_clock.rebase(b) if "base_time_utc" in b.meta
                       else b for b in decoded]
        return decoded

    def apply(self, params, inputs, ctx=None):
        buf = self.pull()
        if buf is None:
            raise BrokerError(
                f"{self.name}: no frame available (drive via runtime "
                f"scheduler or push to the publisher channel first)")
        return [buf]
