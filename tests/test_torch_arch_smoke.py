"""Every assigned architecture's smoke config in the port against the JAX
package, on the CPU: the twin of ``tests/test_arch_smoke.py``.

For each ``ARCH_IDS`` config the reference's ``smoke()`` variant (<= 3
layers, d_model <= 256, <= 4 experts, fp32) is built in both packages on
the reference's weights (``init(PRNGKey(0))`` through
``params_from_numpy``): one forward (``train_logits`` and the loss) and
one serve step (``prefill`` then ``decode_step``) agree within atol = rtol
= 1e-4 (f32, summation orders differ), with the shapes and positions the
reference test asserts: all ten, Mamba-2 (SSD layers) and whisper (the
encoder-decoder, on numpy-seeded frames) included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.models import transformer as tt
from repro_torch.models.config import reference_fields

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)
SEQ = 16
BATCH = 2


def _batch(cfg):
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ))
             .astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal(
            (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


def test_the_registry_is_the_references():
    from repro.configs import ARCH_IDS as JAX_IDS
    assert ARCH_IDS == JAX_IDS
    for arch in ARCH_IDS:
        assert reference_fields(get_config(arch)) == \
            dataclasses.asdict(jax_config(arch)), arch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_and_serve_step_match_jax(arch):
    cfg = get_config(arch).smoke()
    jm, pm = jax_build(jax_config(arch).smoke()), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pp = tt.params_from_numpy(jax.device_get(jp), cfg, "cpu")
    assert pm.param_count(pp) == jm.param_count(jp)
    jb, pb = _batch(cfg)
    jl, _ = jm.train_logits(jp, jb)
    pl, _ = pm.train_logits(pp, pb)
    assert pl.shape[0] == BATCH and pl.shape[-1] == cfg.vocab
    assert torch.isfinite(pl).all()
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(pm.loss(pp, pb)[0]),
                               float(jm.loss(jp, jb)[0]), **TOL)

    total = SEQ + (cfg.n_patches if cfg.frontend == "vision" else 0)
    jlog, jc = jm.prefill(jp, jb, max_seq=total + 4)
    plog, pc = pm.prefill(pp, pb, max_seq=total + 4)
    assert tuple(plog.shape) == (BATCH, cfg.vocab)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL)
    nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    jd, _ = jm.decode_step(jp, jnp.asarray(nxt), jc)
    pd, pc = pm.decode_step(pp, torch.as_tensor(nxt), pc)
    assert tuple(pd.shape) == (BATCH, cfg.vocab)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), **TOL)
    assert pc["pos"].tolist() == [total + 1] * BATCH


def test_input_specs_allocate_nothing():
    m = build_model(get_config("internvl2-76b"))
    specs = m.input_specs("prefill", 2, 64)
    assert specs["tokens"].shape == (2, 64)
    assert specs["patches"].shape == (2, 256, 8192)
    assert specs["patches"].dtype == torch.bfloat16
    assert m.input_specs("decode", 3, 64)["token"].shape == (3,)
    assert build_model(get_config("granite-20b")).active_param_count() > \
        19e9


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_param_count_matches_jax(arch):
    """``active_param_count`` follows the reference's formula for every
    full config: the SSD branch (no MLP) and the encoder-decoder's encoder
    and cross-attention terms included."""
    assert build_model(get_config(arch)).active_param_count() == \
        jax_build(jax_config(arch)).active_param_count()


def test_input_specs_of_the_encoder_decoder():
    m = build_model(get_config("whisper-large-v3"))
    specs = m.input_specs("prefill", 2, 1000)
    assert specs["tokens"].shape == (2, 448)        # the decoder's cap
    assert specs["frames"] == ((2, 1500, 1280), torch.bfloat16)
    assert not m.supports_stacked
    assert build_model(get_config("mamba2-130m")).supports_stacked
