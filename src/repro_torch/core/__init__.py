# Stream-pipeline infrastructure of the port (mirrors src/repro/core):
# pipe-and-filter pipelines over tensor streams, the control-plane broker,
# the query (inference offloading) protocol, live reconfiguration,
# timestamp synchronization and the wire codecs.
from .formats import Caps, CapsError, TensorFormat, TensorSpec
from .buffers import (FlexHeader, SparsePayload, StreamBuffer, flex_unwrap,
                      flex_wrap, stack_buffers, structure_key,
                      unstack_buffers)
from .element import (Element, StatefulElement, element_factory,
                      register_element, FACTORY)
from .elements import register_model, MODEL_REGISTRY
from .pipeline import Pipeline, parse_launch, parse_caps
from .plan import (ExecutionPlan, PendingQuery, clear_executable_cache,
                   executable_cache_info)
from .admission import (AdmissionQueue, QoSConfig, TenantSpec,
                        DEFAULT_TENANT)
from .batching import (BatchingPolicy, QueryBatcher, StagedStreamingBatcher,
                       StageQueryBatcher, StreamingQueryBatcher)
from .broker import Broker, BrokerError, topic_matches
from .pubsub import Channel, MqttSink, MqttSrc, Transport
from .elements import (Compositor, Queue, Queue2, Tee, TensorDecoder,
                       TensorDemux, TensorIf, TensorMux, VideoScale)
from .query import (QueryServerEndpoint, QueryTransport, TensorQueryClient,
                    TensorQueryServerSink, TensorQueryServerSrc)
from .modelserve import (ModelServeElement, ModelServeStageElement,
                         TokenPromptSrc, SERVE_MODELS, register_serve_model)
from .reconfig import (ReconfigError, ReconfigManager, ReconfigPlan,
                       Reconfiguration)
from .sync import PipelineClock, SimClock, ntp_offset
from . import compression

__all__ = [
    "Caps", "CapsError", "TensorFormat", "TensorSpec",
    "FlexHeader", "SparsePayload", "StreamBuffer", "flex_unwrap",
    "flex_wrap", "stack_buffers", "structure_key", "unstack_buffers",
    "Element", "StatefulElement", "element_factory", "register_element",
    "FACTORY", "register_model", "MODEL_REGISTRY",
    "Pipeline", "parse_launch", "parse_caps",
    "ExecutionPlan", "PendingQuery", "clear_executable_cache",
    "executable_cache_info",
    "AdmissionQueue", "QoSConfig", "TenantSpec", "DEFAULT_TENANT",
    "BatchingPolicy", "QueryBatcher", "StreamingQueryBatcher",
    "StageQueryBatcher", "StagedStreamingBatcher",
    "Broker", "BrokerError", "topic_matches",
    "Channel", "MqttSink", "MqttSrc", "Transport",
    "Compositor", "Queue", "Queue2", "Tee", "TensorDecoder", "TensorDemux",
    "TensorIf", "TensorMux", "VideoScale",
    "QueryServerEndpoint", "QueryTransport", "TensorQueryClient",
    "TensorQueryServerSink", "TensorQueryServerSrc",
    "ModelServeElement", "ModelServeStageElement", "TokenPromptSrc",
    "SERVE_MODELS",
    "register_serve_model",
    "ReconfigError", "ReconfigManager", "ReconfigPlan", "Reconfiguration",
    "PipelineClock", "SimClock", "ntp_offset",
    "compression",
]
