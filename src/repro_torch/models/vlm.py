"""VLM of the port (InternVL2-style): projected patch embeddings prepended
to the text embeddings, one shared decoder.

Port of ``src/repro/models/vlm.py``.  The vision tower is the allowed stub:
callers supply projected patches [B, n_patches, d_model]
(``Model.input_specs``).  The LM-side adapter is the ``vis_norm`` applied
to the patches; decode is plain text continuation (``lm_decode``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from . import layers as L
from . import transformer as T
from .config import ModelConfig


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    p = T.init_params(cfg, generator, dev)
    p["vis_norm"] = L.norm_init(cfg.d_model, cfg, dev)
    return p


def _embed(params, cfg: ModelConfig, patches, tokens) -> torch.Tensor:
    """[vis_norm(patches) | embed(tokens)] -> [B, P + S, d]."""
    dt = L.torch_dtype(cfg.dtype)
    pe = L.apply_norm(params["vis_norm"], patches.to(dt), cfg)
    return torch.cat([pe, L.embed(params["embed"], cfg, tokens)], dim=1)


def train(params, cfg: ModelConfig, patches, tokens
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """patches [B, P, d]; tokens [B, S] -> (logits over the P + S
    positions, aux).  Forward only."""
    h, aux = T.backbone_train(params, cfg, _embed(params, cfg, patches,
                                                  tokens))
    return L.unembed(params["embed"], cfg, h), aux


def prefill(params, cfg: ModelConfig, patches, tokens, max_seq: int
            ) -> Tuple[torch.Tensor, Dict]:
    """Prefill over [patches | tokens]; the cache covers both."""
    return T.lm_prefill_embedded(params, cfg,
                                 _embed(params, cfg, patches, tokens),
                                 max_seq)


decode_step = T.lm_decode  # decode is plain text continuation
