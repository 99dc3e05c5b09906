"""ModelConfig — one dataclass drives every assigned architecture.

A copy of ``src/repro/models/config.py`` (the port imports nothing of the
JAX package).  The port's model code implements layer kinds G, L and R
with MoE, MLA and the int8 KV cache; kind S raises ``NotImplementedError``
(ROADMAP M12b), and so does an encoder-decoder (M12c).

``layer_pattern`` is a cycled string of per-layer mixer kinds:
  G = global attention, L = local (sliding-window) attention,
  R = RG-LRU recurrent block, S = Mamba-2 SSD block.
MLP kind per layer is derived from the MoE fields (first ``first_dense``
layers stay dense, as in DeepSeek-V2).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None      # default d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    act: str = "silu"                   # silu | gelu
    mlp_glu: bool = True                # gated (SwiGLU/GeGLU) vs plain
    rope_theta: float = 10_000.0
    rope_frac: float = 1.0              # partial rotary (stablelm: 0.25)
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None

    layer_pattern: str = "G"
    window: Optional[int] = None        # sliding window for 'L' layers

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: Optional[int] = None
    first_dense: int = 0                # leading dense layers (deepseek: 1)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # MLA (deepseek-v2)
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_conv: int = 4

    # RG-LRU (recurrentgemma)
    lru_width: Optional[int] = None

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500                 # whisper: 30s of audio
    max_seq: Optional[int] = None       # architectural context cap (whisper dec: 448)

    # modality frontend stubs (the one allowed stub): embeddings arrive
    # precomputed via input_specs()
    frontend: Optional[str] = None      # None | vision | audio
    n_patches: int = 0                  # vision tokens prepended to text

    dtype: str = "bfloat16"
    source: str = ""                    # citation

    # ---- perf-iteration knobs (§Perf hillclimb; defaults = paper-faithful
    # baseline). Each is measurable in the compiled dry-run HLO. ----
    attn_f32_logits: bool = True        # False: bf16 attention logits/softmax
    kv_cache_quant: bool = False        # int8 KV cache + per-token scales
    moe_psum_bf16: bool = False         # bf16 MoE combine psum
    moe_force_tp: bool = False          # ablation: intra-expert TP even when
                                        # expert parallelism divides
    ssm_seq_parallel: bool = False      # sequence-parallel SSD over `model`
                                        # (log-depth cross-shard state scan)
    mla_fused_qk: bool = False          # one concat QK einsum (no 2nd S×S
                                        # dot + transpose + add pass)
    use_flash_attn: bool = False        # Pallas flash-attention for global
                                        # causal layers (TPU production path)
    attn_additive_mask: bool = False    # additive causal bias instead of
                                        # boolean select (fewer S×S passes)

    # ------------------------------------------------------------------
    def kind(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def is_moe_layer(self, layer: int) -> bool:
        return self.n_experts > 0 and layer >= self.first_dense

    @property
    def attention_free(self) -> bool:
        return all(k in ("S", "R") for k in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is bounded (no full-length KV on any layer) or
        attention layers are all windowed."""
        return all(k in ("S", "R", "L") for k in self.layer_pattern)

    def smoke(self) -> "ModelConfig":
        """Reduced variant of the same family: <=2 layers (pattern-preserving),
        d_model<=512, <=4 experts — runs a real step on CPU."""
        pat = self.layer_pattern
        n_layers = max(2, min(len(pat), 3)) if len(pat) > 1 else 2
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        hd = min(self.resolved_head_dim, 64)
        return replace(
            self,
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            d_ff_expert=min(self.d_ff_expert, 128) if self.d_ff_expert else None,
            first_dense=min(self.first_dense, 1),
            kv_lora_rank=min(self.kv_lora_rank, 64) if self.kv_lora_rank else 0,
            q_lora_rank=min(self.q_lora_rank, 64) if self.q_lora_rank else 0,
            qk_nope_dim=min(self.qk_nope_dim, 32),
            qk_rope_dim=min(self.qk_rope_dim, 16),
            v_head_dim=min(self.v_head_dim, 32),
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_chunk=16 if self.ssm_state else self.ssm_chunk,
            lru_width=min(self.lru_width, 256) if self.lru_width else None,
            n_enc_layers=2 if self.enc_dec else 0,
            enc_seq=32 if self.enc_dec else self.enc_seq,
            window=min(self.window, 32) if self.window else None,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            max_seq=None if self.max_seq is None else min(self.max_seq, 64),
            dtype="float32",
        )
