"""mixtral-8x22b [moe] — 8 experts top-2, GQA kv=8, sliding-window
attention. [arXiv:2401.04088]
(copy of src/repro/configs/mixtral_8x22b.py)"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", arch_type="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab=32768,
        norm="rmsnorm", act="silu", mlp_glu=True, rope_theta=1_000_000.0,
        layer_pattern="L", window=4096,
        n_experts=8, top_k=2, d_ff_expert=16384,
        source="arXiv:2401.04088",
    )
