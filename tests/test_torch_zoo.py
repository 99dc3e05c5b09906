"""The decoder zoo of the port against the JAX package, on the CPU.

Every family of ``tests/test_models.py`` but Mamba-2 (ROADMAP M12b): the
reference's ``Model.init(PRNGKey(0))`` crosses to the port through
``params_from_numpy``, the same numpy-seeded tokens (and patches) go to
both, and ``train_logits``, ``loss`` (ce and the MoE aux), ``prefill`` and
``decode_step`` logits agree within atol = rtol = 1e-4 (f32, two
frameworks, summation orders differ).  The reference's own contracts are
held inside the port too: decode against the teacher-forced oracle
(relative error < 1e-2), the vision patch prefix, int8 KV decode close to
exact (< 0.05) and close to the reference's int8 decode, ``mla_fused_qk`` +
``attn_additive_mask``, and the flash path against the einsum path at
head dims 64, 128 and 256 (the reference's flash runs its Pallas kernel
in interpret mode, as its own tests run it).

The attention knobs at bf16: ``attn_f32_logits`` and
``attn_additive_mask``, each off and on, agree with the reference within
a bf16 bound, and the port before this change (f32 logits whatever the
knob) is shown to differ from the reference by more.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JaxConfig
from repro.models import build_model as jax_build
from repro_torch.models import ModelConfig, build_model
from repro_torch.models import transformer as tt

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)
SEQ = 16

FAMILIES = {
    "dense_gqa_bias": dict(
        name="t", arch_type="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=97, qkv_bias=True, layer_pattern="LG",
        window=8, dtype="float32"),
    "moe_swa": dict(
        name="t", arch_type="moe", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=97, n_experts=4, top_k=2,
        d_ff_expert=64, layer_pattern="L", window=8, capacity_factor=2.0,
        dtype="float32"),
    "mla_moe_shared": dict(
        name="t", arch_type="moe", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=97, mla=True, kv_lora_rank=32,
        q_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        n_experts=4, top_k=2, n_shared_experts=1, d_ff_expert=32,
        first_dense=1, capacity_factor=2.0, dtype="float32"),
    "hybrid_rglru": dict(
        name="t", arch_type="hybrid", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=128, vocab=97, layer_pattern="RRL", window=8,
        lru_width=64, dtype="float32"),
    "partial_rope_layernorm": dict(
        name="t", arch_type="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=97, rope_frac=0.25, norm="layernorm",
        dtype="float32"),
    "vlm_patch_prefix": dict(
        name="t", arch_type="vlm", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=97, frontend="vision", n_patches=8,
        dtype="float32"),
    "mla_no_q_lora": dict(
        name="t", arch_type="moe", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=97, mla=True, kv_lora_rank=32,
        q_lora_rank=0, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=2.0,
        dtype="float32"),
}


def _np(x):
    return np.asarray(x.detach().float().cpu().numpy()
                      if isinstance(x, torch.Tensor) else x, np.float32)


def _pair(kw, **over):
    """-> (jax model, port model, jax params, port params)."""
    kw = {**kw, **over}
    jm, pm = jax_build(JaxConfig(**kw)), build_model(ModelConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, pm, jp, tt.params_from_numpy(jax.device_get(jp), pm.cfg,
                                            "cpu")


def _batch(cfg, seed=1, b=2, s=SEQ):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-6)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_logits_and_loss_match_jax(family):
    jm, pm, jp, pp = _pair(FAMILIES[family])
    jb, pb = _batch(pm.cfg)
    jl, jaux = jm.train_logits(jp, jb)
    pl, paux = pm.train_logits(pp, pb)
    np.testing.assert_allclose(_np(pl), _np(jl), **TOL)
    np.testing.assert_allclose(float(paux), float(jaux), **TOL)
    (jloss, jparts), (ploss, pparts) = jm.loss(jp, jb), pm.loss(pp, pb)
    np.testing.assert_allclose(float(ploss), float(jloss), **TOL)
    np.testing.assert_allclose(float(pparts["ce"]), float(jparts["ce"]),
                               **TOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_and_decode_match_jax_and_the_oracle(family):
    jm, pm, jp, pp = _pair(FAMILIES[family])
    jb, pb = _batch(pm.cfg)
    total = SEQ + pm.cfg.n_patches
    jlog, jc = jm.prefill(jp, jb, max_seq=total + 8)
    plog, pc = pm.prefill(pp, pb, max_seq=total + 8)
    np.testing.assert_allclose(_np(plog), _np(jlog), **TOL)
    assert pc["pos"].tolist() == [total, total]
    nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    jd, _ = jm.decode_step(jp, jnp.asarray(nxt), jc)
    pd, pc = pm.decode_step(pp, torch.as_tensor(nxt), pc)
    np.testing.assert_allclose(_np(pd), _np(jd), **TOL)
    assert pc["pos"].tolist() == [total + 1, total + 1]
    # the reference's contract, in the port: decode == teacher forcing
    pb2 = dict(pb, tokens=torch.cat([pb["tokens"],
                                     torch.as_tensor(nxt)[:, None]], 1))
    lt, _ = pm.train_logits(pp, pb2)
    assert _rel(pd, lt[:, -1]) < 1e-2


def test_int8_kv_cache_decode_close_to_exact_and_to_jax():
    kw = FAMILIES["dense_gqa_bias"]
    jm, pm, jp, pp = _pair(kw)
    jq = jax_build(replace(jm.cfg, kv_cache_quant=True))
    pq = build_model(replace(pm.cfg, kv_cache_quant=True))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, kw["vocab"], (2, 17)).astype(np.int32)
    jc, pc = jq.init_cache(2, 24), pq.init_cache(2, 24, "cpu")
    assert pc["layers"][1]["k"].dtype == torch.int8
    assert tuple(pc["layers"][1]["k_s"].shape) == (2, 24, 2, 1)
    for i in range(17):
        jl, jc = jq.decode_step(jp, jnp.asarray(toks[:, i]), jc)
        pl, pc = pq.decode_step(pp, torch.as_tensor(toks[:, i]), pc)
    np.testing.assert_allclose(_np(pl), _np(jl), **TOL)
    # the int8 rows: the same up to one step where a key's f32 value lands
    # within an ulp of a rounding boundary (the projections are f32
    # products summed in another order)
    dq = np.abs(pc["layers"][1]["k"].numpy().astype(np.int32) -
                np.asarray(jc["layers"][1]["k"]).astype(np.int32))
    assert dq.max() <= 1 and (dq > 0).mean() < 0.01
    lt, _ = pm.train_logits(pp, {"tokens": torch.as_tensor(toks)})
    assert _rel(pl, lt[:, -1]) < 0.05


def test_int8_kv_prefill_quantises_the_prompt_rows():
    """The reference's prefill cannot fill an int8 cache (its
    ``dynamic_update_slice`` refuses float rows); the port quantises them
    as its decode does, so prefill + decode tracks the exact model."""
    kw = FAMILIES["dense_gqa_bias"]
    _, pm, _, pp = _pair(kw)
    pq = build_model(replace(pm.cfg, kv_cache_quant=True))
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, kw["vocab"], (2, 12)).astype(np.int32))
    lq, cq = pq.prefill(pp, {"tokens": toks[:, :11]}, max_seq=16)
    dq, _ = pq.decode_step(pp, toks[:, 11], cq)
    lt, _ = pm.train_logits(pp, {"tokens": toks})
    assert _rel(lq, lt[:, 10]) < 1e-4        # prefill attends unquantised
    assert _rel(dq, lt[:, -1]) < 0.05


def test_mla_fused_qk_and_additive_mask_match_jax():
    jm, pm, jp, pp = _pair(FAMILIES["mla_moe_shared"])
    jb, pb = _batch(pm.cfg)
    knobs = dict(mla_fused_qk=True, attn_additive_mask=True)
    j2 = jax_build(replace(jm.cfg, **knobs))
    p2 = build_model(replace(pm.cfg, **knobs))
    l1, _ = pm.train_logits(pp, pb)
    l2, _ = p2.train_logits(pp, pb)
    jl2, _ = j2.train_logits(jp, jb)
    np.testing.assert_allclose(_np(l2), _np(l1), **TOL)
    np.testing.assert_allclose(_np(l2), _np(jl2), **TOL)


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_path_matches_einsum_and_jax(hd):
    kw = dict(name="t", arch_type="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, head_dim=hd, d_ff=128, vocab=97,
              dtype="float32")
    jm, pm, jp, pp = _pair(kw)
    jb, pb = _batch(pm.cfg, s=32)
    l1, _ = pm.train_logits(pp, pb)
    jf = jax_build(replace(jm.cfg, use_flash_attn=True))
    pf = build_model(replace(pm.cfg, use_flash_attn=True))
    l2, _ = pf.train_logits(pp, pb)
    jl2, _ = jf.train_logits(jp, jb)
    np.testing.assert_allclose(_np(l2), _np(l1), **TOL)
    np.testing.assert_allclose(_np(l2), _np(jl2), **TOL)
    # and decode through the flash step (K6's plain version here)
    jlog, jc = jf.prefill(jp, jb, max_seq=40)
    plog, pc = pf.prefill(pp, pb, max_seq=40)
    nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    jd, _ = jf.decode_step(jp, jnp.asarray(nxt), jc)
    pd, _ = pf.decode_step(pp, torch.as_tensor(nxt), pc)
    np.testing.assert_allclose(_np(pd), _np(jd), **TOL)


KNOBS = [(True, False), (True, True), (False, False), (False, True)]


@pytest.mark.parametrize("f32_logits,additive", KNOBS)
@pytest.mark.parametrize("mla", [False, True])
def test_attention_knobs_follow_jax_at_bf16(f32_logits, additive, mla):
    """The whole model at bf16 under each knob setting, within a bf16
    bound (2e-2 of the largest logit: bf16 rounds at other places in the
    two frameworks)."""
    fam = FAMILIES["mla_moe_shared" if mla else "dense_gqa_bias"]
    kw = dict(fam, dtype="bfloat16", layer_pattern="G", window=None)
    jm, pm, jp, pp = _pair(kw, attn_f32_logits=f32_logits,
                           attn_additive_mask=additive)
    jb, pb = _batch(pm.cfg)
    jl, _ = jm.train_logits(jp, jb)
    pl, _ = pm.train_logits(pp, pb)
    assert _rel(pl, jl) < 2e-2


def _bf16_qkv(seed, b=2, s=24, h=4, kv=2, hd=32):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(sh).astype(np.float32) * 2.0
            for sh in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrs],
            [torch.as_tensor(a).to(torch.bfloat16) for a in arrs])


@pytest.mark.parametrize("f32_logits,additive", KNOBS)
def test_sdpa_knobs_follow_jax_at_bf16(f32_logits, additive):
    """``_sdpa`` alone on the same bf16 q/k/v: the port follows the
    reference's logits dtype and mask; the port before this change (f32
    logits and a boolean mask whatever the knobs) differs by more."""
    from repro.models import layers as JL
    from repro_torch.models import layers as PL
    (jq, jk, jv), (pq, pk, pv) = _bf16_qkv(3)
    s = pq.shape[1]
    pos = np.arange(s)
    ok = pos[:, None] >= pos[None, :]
    jmask = jnp.broadcast_to(jnp.asarray(ok)[None], (2, s, s))
    pmask = torch.as_tensor(ok)[None].expand(2, s, s)
    bias = np.where(ok, 0.0, -1e30).astype(np.float32)
    jo = JL._sdpa(jq, jk, jv, None if additive else jmask, None, 4, 2,
                  f32_logits=f32_logits,
                  additive_mask=jnp.asarray(bias) if additive else None)
    po = PL._sdpa(pq, pk, pv, None if additive else pmask, None, 4, 2,
                  f32_logits=f32_logits,
                  additive_mask=torch.as_tensor(bias) if additive else None)
    err = _rel(po, jo)
    old = _rel(PL._sdpa(pq, pk, pv, pmask, None, 4, 2), jo)
    assert err <= 1e-2, err
    if not f32_logits:
        assert old > 2 * err and old > 1e-3, (old, err)


@pytest.mark.parametrize("f32_logits,additive", KNOBS)
def test_mla_knobs_follow_jax_at_bf16(f32_logits, additive):
    """``mla_train`` alone (bf16 weights from the reference, the same bf16
    input) under each knob setting, against the reference's."""
    from repro.models import mla as JMLA
    from repro_torch.models import mla as PMLA
    kw = dict(FAMILIES["mla_moe_shared"], dtype="bfloat16",
              attn_f32_logits=f32_logits, attn_additive_mask=additive)
    jcfg, pcfg = JaxConfig(**kw), ModelConfig(**kw)
    jp = JMLA.mla_init(jax.random.PRNGKey(5), jcfg)
    pp = tt.params_from_numpy(jax.device_get(jp), pcfg, "cpu")
    x = np.random.default_rng(4).standard_normal((2, 16, 64)) \
        .astype(np.float32)
    jo = JMLA.mla_train(jp, jcfg, jnp.asarray(x, jnp.bfloat16))
    po = PMLA.mla_train(pp, pcfg, torch.as_tensor(x).to(torch.bfloat16))
    err = _rel(po, jo)
    assert err <= 2e-2, err
    if not f32_logits:
        old = PMLA.mla_train(pp, replace(pcfg, attn_f32_logits=True),
                             torch.as_tensor(x).to(torch.bfloat16))
        assert _rel(old, jo) > err, (_rel(old, jo), err)
