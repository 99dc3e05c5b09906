"""Model facade of the port: one object per architecture config.

Port of ``src/repro/models/model.py``::

    init(generator, device) -> params
    loss(params, batch, remat) -> (scalar, {"ce", "aux"})  # differentiable
    train_logits(params, batch, remat) -> (logits, aux)
    prefill(params, batch, max_seq) -> (logits, cache)
    decode_step(params, token, cache) -> (logits, cache)
    init_cache(batch, max_seq, device) -> cache
    input_specs(mode, batch, seq) -> {name: TensorSpec}

Batches are dicts of tensors: ``tokens`` always, ``patches`` for a VLM,
``frames`` for the encoder-decoder (whisper).  ``loss`` is differentiated
by autograd (``launch/steps.py`` builds the train step on it); ``remat``
checkpoints each decoder block, as in the JAX package (whose encoder-
decoder ignores it).  The ``*_stacked`` methods run the stacked layout of
``transformer.py`` (the JAX package's scanned one); an encoder-decoder has
none and takes its list-layout methods, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..device import DeviceLike
from . import encdec as ED
from . import layers as L
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


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- params -------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Dict:
        if self.cfg.enc_dec:
            return ED.init_params(self.cfg, generator, device)
        if self.cfg.frontend == "vision":
            return V.init_params(self.cfg, generator, device)
        return T.init_params(self.cfg, generator, device)

    # -- train ----------------------------------------------------------------
    def train_logits(self, params, batch, remat: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.cfg.enc_dec:
            return ED.train(params, self.cfg, batch["frames"],
                            batch["tokens"])
        if self.cfg.frontend == "vision":
            return V.train(params, self.cfg, batch["patches"],
                           batch["tokens"], remat=remat)
        return T.lm_train(params, self.cfg, batch["tokens"], remat=remat)

    def _loss(self, logits, aux, tokens) -> Tuple[torch.Tensor, Dict]:
        if self.cfg.frontend == "vision":
            # text token i sits at P + i and is predicted by P + i - 1
            p_len = logits.shape[1] - tokens.shape[1]
            ce = cross_entropy(logits[:, p_len - 1:-1], tokens)
        else:
            ce = cross_entropy(logits[:, :-1], tokens[:, 1:])
        return ce + aux, {"ce": ce, "aux": aux}

    def loss(self, params, batch, remat: bool = False
             ) -> Tuple[torch.Tensor, Dict]:
        return self._loss(*self.train_logits(params, batch, remat),
                          batch["tokens"])

    # -- serve --------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   device: DeviceLike = None) -> Dict:
        if self.cfg.enc_dec:
            return ED.cache_init(self.cfg, batch, max_seq, device)
        return T.cache_init(self.cfg, batch, max_seq, device)

    def prefill(self, params, batch, max_seq: int):
        if self.cfg.enc_dec:
            return ED.prefill(params, self.cfg, batch["frames"],
                              batch["tokens"], max_seq)
        if self.cfg.frontend == "vision":
            return V.prefill(params, self.cfg, batch["patches"],
                             batch["tokens"], max_seq)
        return T.lm_prefill(params, self.cfg, batch["tokens"], max_seq)

    def decode_step(self, params, token, cache):
        if self.cfg.enc_dec:
            return ED.decode_step(params, self.cfg, token, cache)
        return T.lm_decode(params, self.cfg, token, cache)

    # -- the stacked layout (the JAX package's scanned one) -------------------
    @property
    def supports_stacked(self) -> bool:
        return not self.cfg.enc_dec

    def init_stacked(self, generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None) -> Dict:
        return self.stack_params(self.init(generator, device))

    def stack_params(self, params) -> Dict:
        if not self.supports_stacked:
            return params
        return T.stack_params(self.cfg, params)

    def loss_stacked(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        if cfg.enc_dec:
            return self.loss(params, batch)
        if cfg.frontend == "vision":
            h, aux = T.backbone_train_stacked(
                params, cfg, V._embed(params, cfg, batch["patches"],
                                      batch["tokens"]))
            logits = L.unembed(params["embed"], cfg, h)
        else:
            logits, aux = T.lm_train_stacked(params, cfg, batch["tokens"])
        return self._loss(logits, aux, batch["tokens"])

    def init_cache_stacked(self, batch: int, max_seq: int,
                           device: DeviceLike = None) -> Dict:
        if self.cfg.enc_dec:
            return self.init_cache(batch, max_seq, device)
        return T.cache_init_stacked(self.cfg, batch, max_seq, device)

    def prefill_stacked(self, params, batch, max_seq: int):
        cfg = self.cfg
        if cfg.enc_dec:
            return self.prefill(params, batch, max_seq)
        if cfg.frontend == "vision":
            x = V._embed(params, cfg, batch["patches"], batch["tokens"])
            return T.lm_prefill_stacked(params, cfg, None, max_seq, x=x)
        return T.lm_prefill_stacked(params, cfg, batch["tokens"], max_seq)

    def decode_step_stacked(self, params, token, cache):
        if self.cfg.enc_dec:
            return self.decode_step(params, token, cache)
        return T.lm_decode_stacked(params, self.cfg, token, cache)

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
        if self.cfg.enc_dec:
            specs["frames"] = TensorSpec(
                (batch, self.cfg.enc_seq, self.cfg.d_model),
                torch_dtype(self.cfg.dtype))
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
            elif kind == "S":
                d_inner = cfg.ssm_expand * d
                total += d * (2 * d_inner + 2 * cfg.ssm_state +
                              d_inner // cfg.ssm_head_dim) + d_inner * d
                continue                # an SSD block has no MLP
            else:
                total += attn
            if cfg.is_moe_layer(i):
                f = cfg.d_ff_expert or cfg.d_ff
                total += glu * d * f * (cfg.top_k + cfg.n_shared_experts)
                total += d * cfg.n_experts  # router
            else:
                total += glu * d * cfg.d_ff
        if cfg.enc_dec:
            total += cfg.n_enc_layers * (attn + glu * d * cfg.d_ff)
            total += cfg.n_layers * 4 * d * cfg.n_heads * hd  # cross-attn
        return total


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
