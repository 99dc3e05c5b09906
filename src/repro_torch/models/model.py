"""Model facade of the port: one object per architecture config.

Port of ``src/repro/models/model.py``::

    init(generator, device) -> params
    loss(params, batch) -> (scalar, {"ce", "aux"})     # forward only
    train_logits(params, batch) -> (logits, aux)
    prefill(params, batch, max_seq) -> (logits, cache)
    decode_step(params, token, cache) -> (logits, cache)
    init_cache(batch, max_seq, device) -> cache
    input_specs(mode, batch, seq) -> {name: TensorSpec}

Batches are dicts of tensors: ``tokens`` always, ``patches`` for a VLM.
There is no backward here (ROADMAP M13).  Building an encoder-decoder
(whisper) raises naming ROADMAP M12c, a Mamba-2 ('S') pattern M12b, and
so do the stacked (scanned) layout's methods (M12c).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..device import DeviceLike
from . import transformer as T
from . import vlm as V
from .config import ModelConfig


class TensorSpec(NamedTuple):
    """Shape and dtype of one model input (``jax.ShapeDtypeStruct``'s
    role; nothing is allocated)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [B, S, V] predicting labels [B, S] (shifted by the caller),
    in f32; the mean over ``mask`` where given."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def _stacked():
    raise NotImplementedError("the stacked (scanned) layout: ROADMAP M12c")


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.enc_dec:
            raise NotImplementedError(
                f"{cfg.name}: the encoder-decoder (whisper) is ROADMAP M12c")
        if "S" in cfg.layer_pattern:
            raise NotImplementedError(
                f"{cfg.name}: Mamba-2 SSD layers ('S') are ROADMAP M12b")
        self.cfg = cfg

    # -- params -------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Dict:
        if self.cfg.frontend == "vision":
            return V.init_params(self.cfg, generator, device)
        return T.init_params(self.cfg, generator, device)

    # -- train (forward only) -----------------------------------------------
    def train_logits(self, params, batch) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        if self.cfg.frontend == "vision":
            return V.train(params, self.cfg, batch["patches"],
                           batch["tokens"])
        return T.lm_train(params, self.cfg, batch["tokens"])

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        logits, aux = self.train_logits(params, batch)
        tokens = batch["tokens"]
        if self.cfg.frontend == "vision":
            # text token i sits at P + i and is predicted by P + i - 1
            p_len = logits.shape[1] - tokens.shape[1]
            ce = cross_entropy(logits[:, p_len - 1:-1], tokens)
        else:
            ce = cross_entropy(logits[:, :-1], tokens[:, 1:])
        return ce + aux, {"ce": ce, "aux": aux}

    # -- serve --------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   device: DeviceLike = None) -> Dict:
        return T.cache_init(self.cfg, batch, max_seq, device)

    def prefill(self, params, batch, max_seq: int):
        if self.cfg.frontend == "vision":
            return V.prefill(params, self.cfg, batch["patches"],
                             batch["tokens"], max_seq)
        return T.lm_prefill(params, self.cfg, batch["tokens"], max_seq)

    def decode_step(self, params, token, cache):
        return T.lm_decode(params, self.cfg, token, cache)

    # -- the stacked layout waits for M12c ----------------------------------
    @property
    def supports_stacked(self) -> bool:
        _stacked()

    def init_stacked(self, *a, **k):
        _stacked()

    def stack_params(self, *a, **k):
        _stacked()

    def loss_stacked(self, *a, **k):
        _stacked()

    def init_cache_stacked(self, *a, **k):
        _stacked()

    def prefill_stacked(self, *a, **k):
        _stacked()

    def decode_step_stacked(self, *a, **k):
        _stacked()

    # -- shape plumbing -----------------------------------------------------
    def clamp_seq(self, seq: int) -> int:
        return min(seq, self.cfg.max_seq) if self.cfg.max_seq else seq

    def input_specs(self, mode: str, batch: int, seq: int
                    ) -> Dict[str, TensorSpec]:
        """Shapes and dtypes of every model input (no allocation).  mode:
        train | prefill | decode."""
        from .layers import torch_dtype
        seq = self.clamp_seq(seq)
        if mode == "decode":
            return {"token": TensorSpec((batch,), torch.int32)}
        specs = {"tokens": TensorSpec((batch, seq), torch.int32)}
        if self.cfg.frontend == "vision":
            specs["patches"] = TensorSpec(
                (batch, self.cfg.n_patches, self.cfg.d_model),
                torch_dtype(self.cfg.dtype))
        return specs

    def param_count(self, params) -> int:
        from ..core.buffers import tree_flatten
        return sum(x.numel() for x in tree_flatten(params)[0])

    def model_flops_per_token(self) -> float:
        """6·N_active: the training FLOPs per token (serving is 2·N)."""
        return 6.0 * self.active_param_count()

    def active_param_count(self) -> int:
        """Analytic parameter count, MoE counted at top_k + shared (the
        reference's formula)."""
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        if cfg.mla:
            q = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads *
                 (cfg.qk_nope_dim + cfg.qk_rope_dim) if cfg.q_lora_rank
                 else d * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim))
            attn = (d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                    + cfg.kv_lora_rank * cfg.n_heads *
                    (cfg.qk_nope_dim + cfg.v_head_dim)
                    + q + cfg.n_heads * cfg.v_head_dim * d)
        else:
            attn = d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
        glu = 3 if cfg.mlp_glu else 2
        total = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
        for i in range(cfg.n_layers):
            kind = cfg.kind(i)
            if kind == "R":
                w = cfg.lru_width or d
                total += d * w * 2 + w * w * 2 + w * d
            else:
                total += attn
            if cfg.is_moe_layer(i):
                f = cfg.d_ff_expert or cfg.d_ff
                total += glu * d * f * (cfg.top_k + cfg.n_shared_experts)
                total += d * cfg.n_experts  # router
            else:
                total += glu * d * cfg.d_ff
        return total


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
