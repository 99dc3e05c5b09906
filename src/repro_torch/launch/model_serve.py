"""Model-serving launch helpers of the port: the serve presets, the
gst-launch builders for server and client pipelines, and the per-request
sequential decode that continuous batching must reproduce bitwise.

Port of ``src/repro/launch/model_serve.py``: monolithic serving, the
staged pipeline-parallel helpers and the three-tier QoS contract.

How the system starts::

    from repro_torch.launch import model_serve as ms
    from repro_torch.runtime import Device, Runtime

    rt = Runtime()                                  # device="cpu" for tests
    hub = Device("hub")
    srv = hub.add_pipeline(ms.serve_pipeline(model="stablelm-smoke-flash",
                                             slots=8, max_seq=64))
    rt.add_device(hub)
    tv = Device("tv0")
    cli = tv.add_pipeline(ms.client_pipeline(prompts="1,2,3", gens="8"))
    rt.add_device(tv)
    rt.run(12)
    cli.sink_log["res"]     # one StreamBuffer of int32 tokens per answer

The decoder zoo serves the same way: ``model="granite-20b-flash"``,
``"gemma3-4b-flash"``, ``"mixtral-8x22b-8l"`` or ``"deepseek-v2-236b-4l"``
on the card, a ``"<family>-smoke"`` preset (``ZOO_PRESETS``) anywhere.

Staged serving replaces the hub with one Device per stage pipeline
(``staged_serve_pipelines(model="stablelm-smoke-4l", n_stages=2)``), each
given the monolithic server's generator; clients are unchanged.  Tenants:
``Runtime(qos=three_tier_qos(...))`` and ``client_pipeline(...,
tenant="realtime")``; an elastic fleet adds
``repro_torch.runtime.Autoscaler(rt, "query/lm", factory)``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..core import parse_launch
from ..core.admission import QoSConfig, TenantSpec
from ..core.buffers import tree_flatten
from ..core.modelserve import SERVE_MODELS, register_serve_model
from ..device import DeviceLike, resolve_device
from ..models import transformer
from ..models.config import ModelConfig

__all__ = ["serve_pipeline", "client_pipeline", "sequential_decode",
           "stage_pipeline", "staged_serve_pipelines", "SERVE_MODELS",
           "register_serve_model", "three_tier_qos", "ZOO_PRESETS"]


def _stablelm_smoke_flash() -> ModelConfig:
    """Small dense transformer with flash attention on both serve paths
    (prefill through K5, decode through K6)."""
    from ..configs import stablelm_1_6b
    return dataclasses.replace(stablelm_1_6b.config().smoke(),
                               use_flash_attn=True)


def _stablelm_smoke() -> ModelConfig:
    from ..configs import stablelm_1_6b
    return stablelm_1_6b.config().smoke()


def _recurrentgemma_smoke() -> ModelConfig:
    """rGLRU hybrid (R, R, L pattern): recurrent state and windowed
    attention ring caches as plan state."""
    from ..configs import recurrentgemma_9b
    return recurrentgemma_9b.config().smoke()


def _stablelm_smoke_4l() -> ModelConfig:
    """4-layer smoke variant: the pipeline-parallel staging testbed, whose
    layer count divides into 2 and 4 stages (DESIGN.md §8)."""
    from ..configs import stablelm_1_6b
    return dataclasses.replace(stablelm_1_6b.config().smoke(), n_layers=4)


register_serve_model("stablelm-smoke-flash", _stablelm_smoke_flash)
register_serve_model("stablelm-smoke", _stablelm_smoke)
register_serve_model("recurrentgemma-smoke", _recurrentgemma_smoke)
register_serve_model("stablelm-smoke-4l", _stablelm_smoke_4l)


# ---------------------------------------------------------------------------
# the attention and MoE decoder zoo: full-width models for the card and fp32
# smoke variants of each family for the CPU.  Weights are seeded random.
# ---------------------------------------------------------------------------

def _zoo(arch: str, **over):
    from ..configs import get_config
    return lambda: dataclasses.replace(get_config(arch), **over)


def _zoo_smoke(arch: str, **over):
    from ..configs import get_config
    return lambda: dataclasses.replace(get_config(arch).smoke(), **over)


ZOO_PRESETS = {
    # granite-20b whole (52 layers, MQA, head dim 128): K5/K6 at 128
    "granite-20b-flash": _zoo("granite-20b", use_flash_attn=True),
    # gemma3-4b whole (LLLLLG, window 1024, head dim 256): K5/K6 at 256 on
    # the global layers, the ring caches on the local ones
    "gemma3-4b-flash": _zoo("gemma3-4b", use_flash_attn=True),
    # mixtral-8x22b at full width, 8 of 56 layers (8 experts top-2,
    # window 4096: every layer windowed, so no flash kernel runs)
    "mixtral-8x22b-8l": _zoo("mixtral-8x22b", n_layers=8,
                             use_flash_attn=True),
    # deepseek-v2-236b at full width: the dense first layer and 3 MoE
    # layers (MLA, 160 experts top-6, 2 shared)
    "deepseek-v2-236b-4l": _zoo("deepseek-v2-236b", n_layers=4),
    "qwen1.5-smoke": _zoo_smoke("qwen1.5-110b", use_flash_attn=True),
    "granite-smoke": _zoo_smoke("granite-20b", use_flash_attn=True),
    "gemma3-smoke": _zoo_smoke("gemma3-4b", use_flash_attn=True),
    "mixtral-smoke": _zoo_smoke("mixtral-8x22b"),
    "deepseek-smoke": _zoo_smoke("deepseek-v2-236b"),
    # the VLM's decoder served on text prompts (patches enter through
    # Model.prefill)
    "internvl2-smoke": _zoo_smoke("internvl2-76b", use_flash_attn=True),
    # the int8 KV cache (decode attends over the dequantised cache)
    "granite-int8kv-smoke": _zoo_smoke("granite-20b", kv_cache_quant=True,
                                       use_flash_attn=True),
}
for _key, _fn in ZOO_PRESETS.items():
    register_serve_model(_key, _fn)


def serve_pipeline(operation: str = "lm", model: str = "stablelm-smoke-flash",
                   slots: int = 8, max_seq: int = 32):
    """Server pipeline: serversrc ! model_serve ! serversink, sink paired."""
    ps = parse_launch(
        f"tensor_query_serversrc operation={operation} name=ssrc ! "
        f"model_serve model={model} slots={slots} max_seq={max_seq} "
        f"name=lm ! tensor_query_serversink name=ssink")
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    return ps


def stage_pipeline(operation: str = "lm", model: str = "stablelm-smoke-4l",
                   slots: int = 8, max_seq: int = 32, stage: int = 0,
                   n_stages: int = 2):
    """ONE hop of a pipeline-parallel chain (DESIGN.md §8).  Stage 0
    serves the client-facing operation topic; stage k > 0 serves
    ``{operation}/s{k}``, the topic the coordinator's per-stage bindings
    subscribe, with ``stage`` declared as a ranking spec so a wildcard
    never binds a hop to the wrong layer slice."""
    topic = operation if stage == 0 else f"{operation}/s{stage}"
    ps = parse_launch(
        f"tensor_query_serversrc operation={topic} stage={stage} "
        f"name=ssrc ! "
        f"model_serve_stage model={model} slots={slots} max_seq={max_seq} "
        f"stage={stage} n_stages={n_stages} name=lm ! "
        f"tensor_query_serversink name=ssink")
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    return ps


def staged_serve_pipelines(operation: str = "lm",
                           model: str = "stablelm-smoke-4l",
                           slots: int = 8, max_seq: int = 32,
                           n_stages: int = 2):
    """The full N-hop chain: one :func:`stage_pipeline` per layer slice.
    Deploy each on its own Device, with the generator the monolithic
    server would get (every stage draws the full tree and keeps its
    slice); stage k's boundary activations reach stage k+1 over the same
    query fabric clients use."""
    return [stage_pipeline(operation, model, slots, max_seq, k, n_stages)
            for k in range(n_stages)]


def client_pipeline(operation: str = "lm", prompts: str = "1,2,3",
                    gens: str = "4", codec: str = "none",
                    tenant: Optional[str] = None):
    """Streaming client: one prompt request per frame, cycling prompts/gens.
    ``tenant`` tags every request for the serve side's admission layer;
    ``None`` keeps the untagged wire format."""
    tenant_prop = f" tenant={tenant}" if tenant is not None else ""
    return parse_launch(
        f"token_prompt_src prompts={prompts} gens={gens} ! "
        f"tensor_query_client operation={operation} codec={codec}"
        f"{tenant_prop} name=qc ! appsink name=res")


def three_tier_qos(rate: Optional[float] = None,
                   deadline_ticks: Optional[int] = None,
                   max_queue: Optional[int] = None,
                   serve_per_tick: Optional[int] = None):
    """The three-tenant serving contract (DESIGN.md §9):

    * ``realtime``: priority 0, ``deadline_ticks``, no rate budget;
    * ``standard``: priority 1, ``rate`` requests a tick (burst the same,
      at least 1), twice the deadline and twice the queue cap;
    * ``best-effort``: priority 2, the same rate, ``deadline_ticks`` and
      ``max_queue``: the tier that sheds first.

    Unknown tenant ids fall into ``best-effort``.  ``serve_per_tick`` caps
    each endpoint's dequeues a tick."""
    best_effort = TenantSpec("best-effort", priority=2, rate=rate,
                             deadline_ticks=deadline_ticks,
                             max_queue=max_queue)
    return QoSConfig(
        tenants=(
            TenantSpec("realtime", priority=0,
                       deadline_ticks=deadline_ticks),
            TenantSpec("standard", priority=1, rate=rate,
                       deadline_ticks=(None if deadline_ticks is None
                                       else 2 * deadline_ticks),
                       max_queue=(None if max_queue is None
                                  else 2 * max_queue)),
            best_effort,
        ),
        default=best_effort,
        serve_per_tick=serve_per_tick)


def sequential_decode(params, cfg: ModelConfig, prompt, gen: int,
                      max_seq: int, *, slots: int = 8, slot: int = 0,
                      device: DeviceLike = None) -> List[int]:
    """Per-request sequential greedy decode — the parity reference.

    One batch-1 prefill, then ``gen - 1`` steps of the SAME S-wide decode
    step the serve element runs (``transformer.serve_decode_step``) with
    only ``slot`` active and the other slots on zero caches.  Every GEMM
    thus has the serving shape, so continuous-batched serving at
    ``slots=S`` must reproduce this token for token, bitwise, whatever the
    join/leave interleaving.  Pass the slot the stream was served in (its
    answer's ``meta["slot"]``) to compare at the same row."""
    dev = resolve_device(device)
    toks = torch.as_tensor(prompt).to(device=dev, dtype=torch.long)[None]
    logits, c1 = transformer.lm_prefill(params, cfg, toks, max_seq)
    first = transformer.greedy(logits)
    cache = transformer.cache_init(cfg, slots, max_seq, dev)
    idx = torch.tensor([slot], dtype=torch.long, device=dev)
    cache["pos"].index_copy_(0, idx, c1["pos"])
    for d, s in zip(tree_flatten(cache["layers"])[0],
                    tree_flatten(c1["layers"])[0]):
        d.index_copy_(0, idx, s)
    token = torch.zeros((slots,), dtype=torch.int32, device=dev)
    token = token.index_copy(0, idx, first)
    active = torch.zeros((slots,), dtype=torch.bool, device=dev)
    active[slot] = True
    out = [first[0]]
    for _ in range(max(0, gen - 1)):
        token = transformer.serve_decode_step(params, cfg, cache, token,
                                              active)
        out.append(token[slot])
    return [int(t) for t in torch.stack(out).cpu()]
