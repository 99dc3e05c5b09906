"""granite-20b [dense] — code model, llama arch, MQA (kv=1). [arXiv:2405.04324]
(copy of src/repro/configs/granite_20b.py)"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", arch_type="dense",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
        d_ff=24576, vocab=49152,
        norm="rmsnorm", act="gelu", mlp_glu=False, rope_theta=10_000.0,
        source="arXiv:2405.04324",
    )
