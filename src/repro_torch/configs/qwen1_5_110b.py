"""qwen1.5-110b [dense] — QKV bias, GQA kv=8. [hf:Qwen/Qwen1.5-0.5B family]
(copy of src/repro/configs/qwen1_5_110b.py)"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", arch_type="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=49152, vocab=152064,
        qkv_bias=True, norm="rmsnorm", act="silu", mlp_glu=True,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen1.5-0.5B (scaled family spec)",
    )
