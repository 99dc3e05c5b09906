"""Query protocol — inference offloading (paper §4.2.2, Fig. 2).

Port of ``src/repro/core/query.py``.  ``tensor_query_client`` drops into a
pipeline where a ``tensor_filter`` would go; the inference runs in a server
pipeline (``tensor_query_serversrc ! ... ! tensor_query_serversink``) on
another device.  The serversrc's endpoint holds one request channel and a
response channel per client; the client's ``client_id`` rides the request
meta and routes the answer back.  The at-least-once delivery layer
(delivery ids, checksums, dedup; ROADMAP M10) waits.
"""
from __future__ import annotations

import enum
import itertools
from typing import Dict, Optional

from .broker import Broker, BrokerError
from .buffers import StreamBuffer
from .element import Element, register_element
from .formats import Caps
from .pubsub import Channel
from . import compression as comp

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
        self.push_drops = 0

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
                   ep: Optional[QueryServerEndpoint] = None
                   ) -> QueryServerEndpoint:
        """Encode + tag + push one request (``ep`` pins the destination)."""
        if ep is None:
            ep = self._endpoint()
        payload, nbytes = comp.encode(buf, self.codec)
        return self.send_query_wire(payload, nbytes, ep)

    def send_query_wire(self, payload: StreamBuffer, nbytes: int,
                        ep: QueryServerEndpoint) -> QueryServerEndpoint:
        """Push an already-encoded request, tagged with routing meta."""
        payload = payload.with_(meta={**payload.meta, **self._routing_meta()})
        if not ep.requests.push(payload, nbytes):
            self.push_drops += 1
        return ep

    def recv_answer_raw(self, ep: QueryServerEndpoint
                        ) -> Optional[StreamBuffer]:
        """Pop this client's wire-form answer without decoding."""
        return ep.client_channel(self.client_id).pop()

    def recv_answer_from(self, ep: QueryServerEndpoint
                         ) -> Optional[StreamBuffer]:
        raw = self.recv_answer_raw(ep)
        return None if raw is None else comp.decode(raw, self.codec)

    def apply(self, params, inputs, ctx=None):
        """Synchronous round trip (used when the runtime's query batching
        is off): send, let the server's inline runner serve, receive."""
        srv = self.send_query(inputs[0])
        runner = srv.spec.get("inline_runner")
        if runner is not None:
            runner()
        out = self.recv_answer_from(srv)
        if out is None:
            raise BrokerError(f"{self.name}: no answer from {self.operation!r}")
        return [out]


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
        return [decoded.with_(meta={**decoded.meta, "codec": codec})]


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
        if not self.serversrc.endpoint.client_channel(client_id).push(
                payload, nbytes):
            self.answer_drops += 1
        return []
