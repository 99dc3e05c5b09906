"""gemma3-4b [dense] — 5:1 local:global attention, sliding window 1024,
128k context, 262k vocab. [hf:google/gemma-3-1b-pt family]
(copy of src/repro/configs/gemma3_4b.py)"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", arch_type="dense",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=10240, vocab=262144,
        norm="rmsnorm", act="gelu", mlp_glu=True,
        layer_pattern="LLLLLG", window=1024,
        rope_theta=1_000_000.0, tie_embeddings=True,
        source="hf:google/gemma-3-1b-pt (4b spec)",
    )
