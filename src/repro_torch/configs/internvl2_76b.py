"""internvl2-76b [vlm] — InternViT (stub) + Llama3-70B-style LM, GQA kv=8.
[arXiv:2404.16821]  The vision tower is the allowed stub: input_specs
supplies projected patch embeddings [B, 256, d_model].
(copy of src/repro/configs/internvl2_76b.py)"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b", arch_type="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=28672, vocab=128256,
        norm="rmsnorm", act="silu", mlp_glu=True, rope_theta=500_000.0,
        frontend="vision", n_patches=256,
        source="arXiv:2404.16821",
    )
