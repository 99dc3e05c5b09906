"""whisper-large-v3 [audio] — encoder-decoder; mel+conv frontend is the
allowed stub (input_specs supplies 1500 frame embeddings); decoder context
is architecturally capped at 448 tokens. [arXiv:2212.04356]
(copy of src/repro/configs/whisper_large_v3.py)"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", arch_type="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
        d_ff=5120, vocab=51866,
        norm="layernorm", act="gelu", mlp_glu=False,
        enc_dec=True, n_enc_layers=32, enc_seq=1500, max_seq=448,
        frontend="audio", tie_embeddings=True,
        source="arXiv:2212.04356",
    )
