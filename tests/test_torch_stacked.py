"""The stacked (scanned) parameter layout of the port, against its own list
layout and the JAX package's stacked layout, on the CPU.

The four families of ``tests/test_models.py::test_stacked_equals_list``
(dense GQA with a local:global pattern, MLA + MoE with a dense first
layer, the RG-LRU hybrid RRL, Mamba-2) on the reference's weights
(``init(PRNGKey(0))``; the list tree and the reference's ``stack_params``
tree each cross through ``params_from_numpy``):

* the port's ``stack_params`` of the carried list tree is bitwise the
  carried stacked tree, and ``layer_plan`` is the reference's for every
  assigned architecture;
* stacked == list in the port, bitwise: ``loss_stacked`` and ``loss``,
  ``prefill_stacked`` and ``prefill``, three ``decode_step_stacked`` steps
  and ``decode_step`` (the stacked units run the same per-layer ops on
  row views of the stacked tensors);
* against the JAX package's stacked layout: the loss within rtol 1e-5 (the
  reference test's bound) and the prefill and decode logits within atol =
  rtol = 1e-4 (f32, two frameworks, summation orders differ); decode after
  prefill matches teacher forcing within 1e-3, as the reference test holds
  its own;
* ``cache_init_stacked`` has the reference's structure and shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import ModelConfig as JaxConfig
from repro.models import build_model as jax_build
from repro.models import transformer as jax_tf
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.buffers import tree_flatten
from repro_torch.models import ModelConfig, build_model
from repro_torch.models import transformer as tt

torch.set_num_threads(2)

SEQ = 16
TOL = dict(atol=1e-4, rtol=1e-4)
FAMILIES = {
    "dense_gqa_bias": dict(
        name="t", arch_type="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=97, qkv_bias=True, layer_pattern="LG",
        window=8, dtype="float32"),
    "mla_moe_shared": dict(
        name="t", arch_type="moe", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=97, mla=True, kv_lora_rank=32,
        q_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        n_experts=4, top_k=2, n_shared_experts=1, d_ff_expert=32,
        first_dense=1, capacity_factor=2.0, dtype="float32"),
    "ssm_mamba2": dict(
        name="t", arch_type="ssm", n_layers=2, d_model=64, n_heads=0,
        n_kv_heads=0, d_ff=0, vocab=97, layer_pattern="S", ssm_state=16,
        ssm_head_dim=16, ssm_chunk=8, dtype="float32"),
    "hybrid_rglru": dict(
        name="t", arch_type="hybrid", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=128, vocab=97, layer_pattern="RRL", window=8,
        lru_width=64, dtype="float32"),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def fam(request):
    kw = FAMILIES[request.param]
    jm, pm = jax_build(JaxConfig(**kw)), build_model(ModelConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    jsp = jm.stack_params(jp)
    pp = tt.params_from_numpy(jax.device_get(jp), pm.cfg, "cpu")
    psp = tt.params_from_numpy(jax.device_get(jsp), pm.cfg, "cpu")
    toks = np.random.default_rng(1).integers(0, kw["vocab"], (2, SEQ)
                                             ).astype(np.int32)
    return jm, pm, jp, jsp, pp, psp, toks


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layer_plan_is_the_references(arch):
    assert tuple(tt.layer_plan(get_config(arch))) == \
        tuple(jax_tf.layer_plan(jax_config(arch)))


def test_stack_params_is_the_references_stacked_tree(fam):
    _, pm, _, _, pp, psp, _ = fam
    mine, td = tree_flatten(pm.stack_params(pp))
    theirs, td2 = tree_flatten(psp)
    assert td == td2
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    assert pm.param_count(psp) == pm.param_count(pp)


def test_stacked_loss_equals_list_and_jax(fam):
    jm, pm, jp, jsp, pp, psp, toks = fam
    pl, pparts = pm.loss_stacked(psp, {"tokens": torch.as_tensor(toks)})
    ll, lparts = pm.loss(pp, {"tokens": torch.as_tensor(toks)})
    assert torch.equal(pl, ll) and torch.equal(torch.as_tensor(
        pparts["aux"]), torch.as_tensor(lparts["aux"]))
    jl, _ = jm.loss_stacked(jsp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)


def test_stacked_prefill_and_decode_equal_list_and_jax(fam):
    jm, pm, jp, jsp, pp, psp, toks = fam
    tb = {"tokens": torch.as_tensor(toks)}
    lp, cache = pm.prefill_stacked(psp, tb, max_seq=SEQ + 8)
    lp2, cache2 = pm.prefill(pp, tb, max_seq=SEQ + 8)
    assert torch.equal(lp, lp2)
    jlp, jc = jm.prefill_stacked(jsp, {"tokens": jnp.asarray(toks)},
                                 max_seq=SEQ + 8)
    np.testing.assert_allclose(_np(lp), _np(jlp), **TOL)
    nxt = np.asarray(jnp.argmax(jlp, -1)).astype(np.int32)
    first = nxt
    for step in range(3):
        ld, cache = pm.decode_step_stacked(psp, torch.as_tensor(nxt), cache)
        ld2, cache2 = pm.decode_step(pp, torch.as_tensor(nxt), cache2)
        assert torch.equal(ld, ld2), step
        jd, jc = jm.decode_step_stacked(jsp, jnp.asarray(nxt), jc)
        np.testing.assert_allclose(_np(ld), _np(jd), **TOL)
        if step == 0:
            toks2 = np.concatenate([toks, first[:, None]], 1)
            lt, _ = pm.train_logits(pp, {"tokens": torch.as_tensor(toks2)})
            np.testing.assert_allclose(_np(ld), _np(lt[:, -1]), rtol=1e-3,
                                       atol=1e-3)
        nxt = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    assert cache["pos"].tolist() == [SEQ + 3] * 2


def test_cache_init_stacked_matches_jax(fam):
    jm, pm = fam[0], fam[1]
    jc = jm.init_cache_stacked(2, SEQ)
    pc = pm.init_cache_stacked(2, SEQ, "cpu")
    jl, jtd = tree_flatten(jax.device_get(
        {k: v for k, v in jc.items() if k != "pos"}))
    pl, ptd = tree_flatten({k: v for k, v in pc.items() if k != "pos"})
    assert ptd == jtd
    for a, b in zip(pl, jl):
        assert tuple(a.shape) == b.shape and str(a.dtype).endswith(
            str(b.dtype))
    assert pc["pos"].tolist() == [0, 0]
