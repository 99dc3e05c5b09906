# Stream-pipeline infrastructure of the port (mirrors src/repro/core):
# pipe-and-filter pipelines over tensor streams, the control-plane broker,
# the query (inference offloading) protocol, timestamp synchronization and
# the wire codecs — as far as the model-serving main path needs them.
from .formats import Caps, CapsError, TensorFormat, TensorSpec
from .buffers import (StreamBuffer, stack_buffers, structure_key,
                      unstack_buffers)
from .element import Element, element_factory, register_element, FACTORY
from .pipeline import Pipeline, parse_launch, parse_caps
from .plan import (ExecutionPlan, PendingQuery, clear_executable_cache,
                   executable_cache_info)
from .admission import (AdmissionQueue, QoSConfig, TenantSpec,
                        DEFAULT_TENANT)
from .batching import BatchingPolicy, QueryBatcher, StreamingQueryBatcher
from .broker import Broker, BrokerError, topic_matches
from .pubsub import Channel
from .query import (QueryServerEndpoint, QueryTransport, TensorQueryClient,
                    TensorQueryServerSink, TensorQueryServerSrc)
from .modelserve import (ModelServeElement, TokenPromptSrc, SERVE_MODELS,
                         register_serve_model)
from .sync import PipelineClock, SimClock, ntp_offset
from . import compression

__all__ = [
    "Caps", "CapsError", "TensorFormat", "TensorSpec",
    "StreamBuffer", "stack_buffers", "structure_key", "unstack_buffers",
    "Element", "element_factory", "register_element", "FACTORY",
    "Pipeline", "parse_launch", "parse_caps",
    "ExecutionPlan", "PendingQuery", "clear_executable_cache",
    "executable_cache_info",
    "AdmissionQueue", "QoSConfig", "TenantSpec", "DEFAULT_TENANT",
    "BatchingPolicy", "QueryBatcher", "StreamingQueryBatcher",
    "Broker", "BrokerError", "topic_matches",
    "Channel",
    "QueryServerEndpoint", "QueryTransport", "TensorQueryClient",
    "TensorQueryServerSink", "TensorQueryServerSrc",
    "ModelServeElement", "TokenPromptSrc", "SERVE_MODELS",
    "register_serve_model",
    "PipelineClock", "SimClock", "ntp_offset",
    "compression",
]
