"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed
experts top-6, first layer dense. [arXiv:2405.04434]
(copy of src/repro/configs/deepseek_v2_236b.py)"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", arch_type="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=12288, vocab=102400,
        norm="rmsnorm", act="silu", mlp_glu=True, rope_theta=10_000.0,
        mla=True, kv_lora_rank=512, q_lora_rank=1536,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        n_experts=160, top_k=6, n_shared_experts=2, d_ff_expert=1536,
        first_dense=1,
        source="arXiv:2405.04434",
    )
