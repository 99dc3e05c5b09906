"""Query protocol — inference offloading (paper §4.2.2, Fig. 2).

Port of ``src/repro/core/query.py``.  ``tensor_query_client`` drops into a
pipeline where a ``tensor_filter`` would go; the inference runs in a server
pipeline (``tensor_query_serversrc ! ... ! tensor_query_serversink``) on
another device.  The serversrc's endpoint holds one request channel and a
response channel per client; the client's ``client_id`` rides the request
meta and routes the answer back.

The delivery layer (DESIGN.md §10, ``core/netfault.py``) is opt-in: a
client whose ``delivery`` is a :class:`~.netfault.DeliveryPolicy` stamps
every request with a ``(client_id, seq)`` delivery id and a CRC32, and
guards the answers it receives (corrupt ones rejected, duplicates dropped,
early answers for other requests stashed); a serversink with a ``guard``
stamps its answers and records each in the guard's replay cache.
"""
from __future__ import annotations

import enum
import itertools
from collections import OrderedDict
from typing import Dict, Optional

from .broker import Broker, BrokerError
from .buffers import StreamBuffer
from .element import Element, register_element
from .formats import Caps
from .pubsub import Channel
from . import compression as comp
from . import netfault

__all__ = ["QueryTransport", "QueryServerEndpoint", "TensorQueryClient",
           "TensorQueryServerSrc", "TensorQueryServerSink"]


class QueryTransport(enum.Enum):
    TCP_RAW = "tcp"
    MQTT_HYBRID = "hybrid"


class QueryServerEndpoint:
    """Server-side connection state shared by a serversrc/serversink pair:
    one request channel and per-client response channels."""

    _ids = itertools.count(1)

    def __init__(self, operation: str, spec: Optional[Dict] = None):
        self.operation = operation
        self.spec = spec or {}
        self.requests = Channel(capacity=64)
        self.responses: Dict[int, Channel] = {}
        self.endpoint_id = next(self._ids)
        self.alive = True

    def client_channel(self, client_id: int) -> Channel:
        if client_id not in self.responses:
            self.responses[client_id] = Channel(capacity=64)
        return self.responses[client_id]


@register_element("tensor_query_client")
class TensorQueryClient(Element):
    """Behaves like tensor_filter, but remote.  Properties: operation
    (service name = topic), transport, codec, tenant, ``require-*`` spec
    filters."""

    host_impure = True
    #: the scheduler may pause a frame here (plan.run_deferred), gather the
    #: request into a server batch, and resume with the answer
    is_query_client = True

    _ids = itertools.count(1)

    def __init__(self, name=None, operation="", transport="hybrid",
                 codec="none", broker: Optional[Broker] = None,
                 tenant=None, **props):
        super().__init__(name=name, **props)
        self.operation = props.get("operation", operation)
        self.transport = (QueryTransport.MQTT_HYBRID if transport in ("hybrid", "mqtt")
                          else QueryTransport.TCP_RAW)
        self.codec = codec
        self.broker = broker
        self.client_id = next(self._ids)
        self.tenant = props.get("tenant", tenant)
        self.binding = None
        self._direct: Optional[QueryServerEndpoint] = None
        self.require = {k[8:]: v for k, v in props.items() if k.startswith("require_")}
        #: delivery layer (DESIGN.md §10): None stamps and checks nothing,
        #: the wire is bitwise the delivery-less one
        self.delivery: Optional[netfault.DeliveryPolicy] = None
        self._dseq = 0
        self._ans_seen = OrderedDict()  # bounded LRU of consumed answer ids
        self._ans_stash: Dict = {}      # early answers for other in-flight ids
        self.answer_dups = 0
        self.answer_corrupt = 0
        self.push_drops = 0

    def next_dseq(self):
        """Mint the delivery id for ONE logical request.  Retransmits reuse
        the id: that is what makes them idempotent downstream."""
        self._dseq += 1
        return (self.client_id, self._dseq)

    def _routing_meta(self) -> Dict:
        meta = {"client_id": self.client_id, "codec": self.codec}
        if self.tenant is not None:
            meta["tenant_id"] = self.tenant
        return meta

    def connect(self, broker: Broker):
        self.broker = broker
        return self

    def connect_direct(self, endpoint: QueryServerEndpoint):
        """TCP-raw: an explicit server endpoint."""
        self._direct = endpoint
        return self

    def _endpoint(self) -> QueryServerEndpoint:
        if self.transport == QueryTransport.TCP_RAW:
            if self._direct is None or not self._direct.alive:
                raise BrokerError(f"{self.name}: TCP-raw endpoint gone; no failover "
                                  f"in raw transport (R4 unmet by design)")
            return self._direct
        if self.binding is None:
            if self.broker is None:
                raise BrokerError(f"{self.name}: MQTT-hybrid requires a broker")
            prefer = {"codec": self.codec}
            if self.tenant is not None:
                prefer["tenant"] = self.tenant
            self.binding = self.broker.subscribe(
                f"query/{self.operation}", prefer=prefer, **self.require)
        ep = self.binding.endpoint
        if not ep.alive:
            self.binding._rebind()
            ep = self.binding.endpoint
        return ep

    # -- host-level request/answer (runtime scheduler & tests) ------------------
    def send_query(self, buf: StreamBuffer,
                   ep: Optional[QueryServerEndpoint] = None,
                   dseq=None) -> QueryServerEndpoint:
        """Encode + tag + push one request (``ep`` pins the destination).
        With delivery on, ``dseq`` pins the delivery id: a retransmit
        passes the original id so the server's dedup window knows it."""
        if ep is None:
            ep = self._endpoint()
        payload, nbytes = comp.encode(buf, self.codec)
        return self.send_query_wire(payload, nbytes, ep, dseq=dseq)

    def send_query_wire(self, payload: StreamBuffer, nbytes: int,
                        ep: QueryServerEndpoint,
                        dseq=None) -> QueryServerEndpoint:
        """Push an already-encoded request, tagged with routing meta (and,
        with delivery on, its delivery id and CRC)."""
        meta = {**payload.meta, **self._routing_meta()}
        crc = None
        if self.delivery is not None:
            meta["dseq"] = dseq if dseq is not None else self.next_dseq()
            meta["crc"] = crc = netfault.checksum(payload)
        payload = payload.with_(meta=meta)
        if crc is not None:
            netfault.memoize_crc(payload, crc)
        if not ep.requests.push(payload, nbytes):
            self.push_drops += 1
        return ep

    def _guard_answer(self, raw: StreamBuffer, channel,
                      want) -> Optional[StreamBuffer]:
        """Answer triage with delivery on: reject corrupt (counted), dedup
        by id (counted), stash an early answer for ANOTHER in-flight
        request of this client, and strip the delivery meta off an accepted
        answer, so downstream sees exactly the delivery-less buffer."""
        meta = raw.meta or {}
        crc = meta.get("crc")
        if crc is not None and netfault.checksum(raw) != int(crc):
            self.answer_corrupt += 1
            netfault.note(channel, "rejected_corrupt")
            return None
        dseq = meta.get("dseq")
        if dseq is None:
            netfault.note(channel, "accepted")
            return raw
        if dseq in self._ans_seen:
            self._ans_seen.move_to_end(dseq)
            self.answer_dups += 1
            netfault.note(channel, "deduped")
            return None
        if want is not None and dseq != want:
            # another request's answer arrived first (reordering): hold it
            # for that request's own recv
            self._ans_stash[dseq] = raw
            netfault.note(channel, "accepted")
            return None
        netfault.note(channel, "accepted")
        return self._accept(raw, dseq)

    def _accept(self, raw: StreamBuffer, dseq) -> StreamBuffer:
        self._ans_seen[dseq] = True
        while len(self._ans_seen) > self.delivery.window:
            self._ans_seen.popitem(last=False)
        stripped = dict(raw.meta or {})
        stripped.pop("dseq", None)
        stripped.pop("crc", None)
        return raw.with_(meta=stripped)

    def recv_answer_raw(self, ep: QueryServerEndpoint, want=None
                        ) -> Optional[StreamBuffer]:
        """Pop this client's wire-form answer without decoding.  With
        delivery on, ``want`` names the expected delivery id: corrupt and
        duplicate answers are discarded (counted), answers for other ids
        are stashed for their own recv, and the accepted answer comes back
        without delivery meta."""
        ch = ep.client_channel(self.client_id)
        if self.delivery is None:
            return ch.pop()
        if want is not None and want in self._ans_stash:
            return self._accept(self._ans_stash.pop(want), want)
        while True:
            raw = ch.pop()
            if raw is None:
                return None
            out = self._guard_answer(raw, ch, want)
            if out is not None:
                return out

    def recv_answer_from(self, ep: QueryServerEndpoint, want=None
                         ) -> Optional[StreamBuffer]:
        raw = self.recv_answer_raw(ep, want=want)
        return None if raw is None else comp.decode(raw, self.codec)

    def recv_answer(self) -> Optional[StreamBuffer]:
        """Pop and decode this client's answer from its bound endpoint."""
        return self.recv_answer_from(self._endpoint())

    def apply(self, params, inputs, ctx=None):
        """Synchronous round trip (used when the runtime's query batching
        is off): send, let the server's inline runner serve, receive.  With
        delivery on the round trip retransmits under the same delivery id
        (idempotent by the server's dedup) up to ``hop_retries`` times."""
        if self.delivery is None:
            srv = self.send_query(inputs[0])
            runner = srv.spec.get("inline_runner")
            if runner is not None:
                runner()
            out = self.recv_answer_from(srv)
            if out is None:
                raise BrokerError(
                    f"{self.name}: no answer from {self.operation!r}")
            return [out]
        dseq = self.next_dseq()
        for _ in range(max(1, self.delivery.hop_retries)):
            srv = self.send_query(inputs[0], dseq=dseq)
            runner = srv.spec.get("inline_runner")
            if runner is not None:
                runner()
            out = self.recv_answer_from(srv, want=dseq)
            if out is not None:
                return [out]
        raise BrokerError(f"{self.name}: no answer from {self.operation!r} "
                          f"after {self.delivery.hop_retries} retransmits")


@register_element("tensor_query_serversrc")
class TensorQueryServerSrc(Element):
    """Receives queries; tags client_id into meta for the paired serversink."""

    n_sink_pads = 0
    host_impure = True
    #: hoistable: the batcher pulls and injects requests itself
    is_query_source = True

    def __init__(self, name=None, operation="", broker: Optional[Broker] = None,
                 **props):
        super().__init__(name=name, **props)
        self.operation = props.get("operation", operation)
        self.endpoint = QueryServerEndpoint(self.operation)
        self.broker = broker
        self.registration = None
        self.specs = {k: v for k, v in props.items() if not k.startswith("_")}

    def connect(self, broker: Broker, **extra_specs):
        self.broker = broker
        self.endpoint.spec.update(extra_specs)
        self.registration = broker.register(
            f"query/{self.operation}", Caps.ANY, self.endpoint,
            **{**self.specs, **extra_specs})
        return self

    def pull(self) -> Optional[StreamBuffer]:
        return self.endpoint.requests.pop()

    def apply(self, params, inputs, ctx=None):
        buf = self.pull()
        if buf is None:
            raise BrokerError(f"{self.name}: no pending query")
        codec = buf.meta.get("codec", "none")
        decoded = comp.decode(buf, codec)
        # the client's codec stays as routing meta for the serversink; the
        # request's checksum authenticated the inbound frame only (the
        # sink stamps its answer afresh)
        meta = {**decoded.meta, "codec": codec}
        meta.pop("crc", None)
        return [decoded.with_(meta=meta)]


@register_element("tensor_query_serversink")
class TensorQueryServerSink(Element):
    """Routes the inference answer back to the tagged client connection."""

    n_src_pads = 0
    host_impure = True
    #: capturable: the batcher replays answers through the real apply
    is_query_sink = True

    def __init__(self, name=None, serversrc: Optional[TensorQueryServerSrc] = None,
                 **props):
        super().__init__(name=name, **props)
        self.serversrc = serversrc
        #: delivery guard shared with the owning batcher (DESIGN.md §10):
        #: when set, an answer to a request with a delivery id gets a fresh
        #: CRC and enters the guard's replay cache, so a retransmitted
        #: request whose answer was lost is answered again, bitwise,
        #: without serving it twice
        self.guard = None
        #: answers displaced off a full client channel
        self.answer_drops = 0

    def pair_with(self, serversrc: TensorQueryServerSrc):
        self.serversrc = serversrc
        return self

    def apply(self, params, inputs, ctx=None):
        buf = inputs[0]
        client_id = buf.meta.get("client_id")
        if client_id is None:
            raise BrokerError(f"{self.name}: answer buffer lost its client_id tag")
        payload, nbytes = comp.encode(buf, buf.meta.get("codec", "none"))
        self._ship(payload, nbytes, client_id)
        return []

    def push_wire(self, payload: StreamBuffer, nbytes: int, client_id: int):
        """Route an ALREADY-ENCODED answer (the fused wire path re-encodes
        a whole batch in one launch; the batcher routes the wire frames with
        meta restored).  Same channel push and byte accounting as
        :meth:`apply`."""
        self._ship(payload, nbytes, client_id)

    def _ship(self, payload: StreamBuffer, nbytes: int, client_id: int):
        """One answer push (stamped and recorded for replay when the
        delivery layer is on); a full client channel books the displaced
        answer on the sink."""
        ep = self.serversrc.endpoint
        if self.guard is not None:
            dseq = payload.meta.get("dseq")
            if dseq is not None:
                crc = netfault.checksum(payload)
                payload = payload.with_(meta={**payload.meta, "crc": crc})
                netfault.memoize_crc(payload, crc)
                self.guard.record_answer(
                    dseq, lambda ep=ep, cid=client_id, p=payload, n=nbytes:
                        ep.client_channel(cid).push(p, n))
        if not ep.client_channel(client_id).push(payload, nbytes):
            self.answer_drops += 1
