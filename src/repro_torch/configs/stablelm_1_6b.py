"""stablelm-1.6b [dense] — MHA, partial rotary (25%), LayerNorm.
[hf:stabilityai/stablelm-2-1_6b]  (copy of src/repro/configs/stablelm_1_6b.py)"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", arch_type="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=5632, vocab=100352,
        norm="layernorm", act="silu", mlp_glu=True,
        rope_theta=10_000.0, rope_frac=0.25,
        source="hf:stabilityai/stablelm-2-1_6b",
    )
