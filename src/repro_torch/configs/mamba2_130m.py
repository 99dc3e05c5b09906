"""mamba2-130m [ssm] — SSD (state-space duality), attention-free,
state=128. [arXiv:2405.21060]
(copy of src/repro/configs/mamba2_130m.py)"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", arch_type="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=50280,
        norm="rmsnorm", layer_pattern="S",
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
        # production default: sequence-parallel SSD (§Perf H3 — 10.7× on the
        # dominant roofline term vs channel-sharded GSPMD); params replicate,
        # the sequence shards over `model`
        ssm_seq_parallel=True,
        tie_embeddings=True,
        source="arXiv:2405.21060",
    )
