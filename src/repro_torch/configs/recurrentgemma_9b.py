"""recurrentgemma-9b [hybrid] — RG-LRU recurrent blocks + local attention,
2:1 pattern (R,R,L), MQA kv=1, window 2048. [arXiv:2402.19427]
(copy of src/repro/configs/recurrentgemma_9b.py)"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", arch_type="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab=256000,
        norm="rmsnorm", act="gelu", mlp_glu=True,
        layer_pattern="RRL", window=2048, lru_width=4096,
        tie_embeddings=True,
        source="arXiv:2402.19427",
    )
