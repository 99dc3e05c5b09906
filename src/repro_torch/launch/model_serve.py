"""Model-serving launch helpers of the port: the serve presets, the
gst-launch builders for server and client pipelines, and the per-request
sequential decode that continuous batching must reproduce bitwise.

Port of ``src/repro/launch/model_serve.py`` (monolithic serving; the staged
pipeline-parallel builders and the QoS contract wait for ROADMAP M8/M9).

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
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..core import parse_launch
from ..core.buffers import tree_flatten
from ..core.modelserve import SERVE_MODELS, register_serve_model
from ..device import DeviceLike, resolve_device
from ..models import transformer
from ..models.config import ModelConfig

__all__ = ["serve_pipeline", "client_pipeline", "sequential_decode",
           "SERVE_MODELS", "register_serve_model"]


def _stablelm_smoke_flash() -> ModelConfig:
    """Small dense transformer with flash attention on both serve paths
    (prefill through K5, decode through K6)."""
    from ..configs import stablelm_1_6b
    return dataclasses.replace(stablelm_1_6b.config().smoke(),
                               use_flash_attn=True)


def _stablelm_smoke() -> ModelConfig:
    from ..configs import stablelm_1_6b
    return stablelm_1_6b.config().smoke()


register_serve_model("stablelm-smoke-flash", _stablelm_smoke_flash)
register_serve_model("stablelm-smoke", _stablelm_smoke)


def serve_pipeline(operation: str = "lm", model: str = "stablelm-smoke-flash",
                   slots: int = 8, max_seq: int = 32):
    """Server pipeline: serversrc ! model_serve ! serversink, sink paired."""
    ps = parse_launch(
        f"tensor_query_serversrc operation={operation} name=ssrc ! "
        f"model_serve model={model} slots={slots} max_seq={max_seq} "
        f"name=lm ! tensor_query_serversink name=ssink")
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    return ps


def client_pipeline(operation: str = "lm", prompts: str = "1,2,3",
                    gens: str = "4", codec: str = "none",
                    tenant: Optional[str] = None):
    """Streaming client: one prompt request per frame, cycling prompts/gens."""
    tenant_prop = f" tenant={tenant}" if tenant is not None else ""
    return parse_launch(
        f"token_prompt_src prompts={prompts} gens={gens} ! "
        f"tensor_query_client operation={operation} codec={codec}"
        f"{tenant_prop} name=qc ! appsink name=res")


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
