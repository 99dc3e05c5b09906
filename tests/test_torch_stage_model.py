"""The port's pipeline-stage functions against the JAX package, on the CPU.

``stage_bounds``, ``stage_params``, ``stage_cache_init``,
``stage_prefill`` and ``stage_decode`` (DESIGN.md §8) on the
``stablelm-smoke-4l`` preset, whose 4 layers split into 1, 2 and 4 stages.
Weights come from the JAX package through ``params_from_numpy``.  Pinned:

* bounds, the share of the tree each stage keeps, and the stage caches'
  shapes equal the JAX package's (the port keeps a per-row ``pos`` [B]
  where JAX keeps a scalar, so a stage cache is a layer slice of the
  port's ``cache_init``);
* a prefill chain and 4 decode steps through the stages equal the JAX
  stage functions within atol 1e-4 (the tolerance of
  tests/test_torch_transformer.py), flash attention off and on (JAX's
  Pallas kernel in interpret mode), boundary activations and caches
  included;
* chaining the stages of one tree is bitwise the port's own
  ``lm_prefill``/``lm_decode``, caches included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import model_serve as jax_ms
from repro.models import transformer as jax_tf
from repro_torch.launch import model_serve as ms
from repro_torch.models import transformer as tt

torch.set_num_threads(2)

pytestmark = pytest.mark.ppstage

ATOL = 1e-4
MAX_SEQ = 32
MODEL = "stablelm-smoke-4l"


def _cfgs(flash):
    return (dataclasses.replace(jax_ms.SERVE_MODELS[MODEL](),
                                use_flash_attn=flash),
            dataclasses.replace(ms.SERVE_MODELS[MODEL](),
                                use_flash_attn=flash))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs(False)
    jp = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, tt.params_from_numpy(jax.device_get(jp), tcfg, "cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return {k: _leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_leaves(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_bounds_shares_and_caches_match_jax(weights, n_stages):
    jp, tp = weights
    jcfg, tcfg = _cfgs(False)
    for k in range(n_stages):
        assert tt.stage_bounds(tcfg, k, n_stages) == \
            jax_tf.stage_bounds(jcfg, k, n_stages)
        js = jax_tf.stage_params(jp, jcfg, k, n_stages)
        ts = tt.stage_params(tp, tcfg, k, n_stages)
        assert _leaves(ts) == _leaves(jax.tree_util.tree_map(np.asarray, js))
        # the share holds the full tree's own layer dicts, no copies
        lo, hi = tt.stage_bounds(tcfg, k, n_stages)
        assert all(a is b for a, b in zip(ts["layers"],
                                          tp["layers"][lo:hi]))
        jc = jax_tf.stage_cache_init(jcfg, k, n_stages, 2, MAX_SEQ)
        tc = tt.stage_cache_init(tcfg, k, n_stages, 2, MAX_SEQ, "cpu")
        assert _leaves(tc["layers"]) == _leaves(
            jax.tree_util.tree_map(np.asarray, jc["layers"]))
        assert tc["pos"].shape == (2,) and jnp.shape(jc["pos"]) == ()
        full = tt.cache_init(tcfg, 2, MAX_SEQ, "cpu")
        assert _leaves(tc["layers"]) == _leaves(full["layers"][lo:hi])
    for bad in ((n_stages, n_stages), (-1, n_stages), (0, 3)):
        with pytest.raises(ValueError):
            tt.stage_bounds(tcfg, *bad)
        with pytest.raises(ValueError):
            jax_tf.stage_bounds(jcfg, *bad)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_stage_chain_matches_jax(weights, flash, n_stages):
    jp, tp = weights
    jcfg, tcfg = _cfgs(flash)
    prompt = np.random.default_rng(5).integers(0, tcfg.vocab, (1, 12))
    jx, tx = jnp.asarray(prompt, jnp.int32), torch.as_tensor(prompt)
    jcs, tcs = [], []
    for k in range(n_stages):
        jx, jc = jax_tf.stage_prefill(
            jax_tf.stage_params(jp, jcfg, k, n_stages), jcfg, k, n_stages,
            jx, MAX_SEQ)
        tx, tc = tt.stage_prefill(tt.stage_params(tp, tcfg, k, n_stages),
                                  tcfg, k, n_stages, tx, MAX_SEQ)
        _close(tx, jx)          # boundary activations, or the last logits
        assert int(tc["pos"][0]) == int(jc["pos"]) == 12
        for a, b in zip(tc["layers"], jc["layers"]):
            _close(a["k"], b["k"])
            _close(a["v"], b["v"])
        jcs.append(jc)
        tcs.append(tc)
    jtok = jnp.argmax(jx, -1).astype(jnp.int32)
    ttok = tt.greedy(tx)
    for _ in range(4):
        assert int(ttok[0]) == int(jtok[0])
        jx, tx = jtok, ttok
        for k in range(n_stages):
            jx, jcs[k] = jax_tf.stage_decode(
                jax_tf.stage_params(jp, jcfg, k, n_stages), jcfg, k,
                n_stages, jx, jcs[k])
            tx, tcs[k] = tt.stage_decode(
                tt.stage_params(tp, tcfg, k, n_stages), tcfg, k, n_stages,
                tx, tcs[k])
            _close(tx, jx)
        jtok = jnp.argmax(jx, -1).astype(jnp.int32)
        ttok = tt.greedy(tx)
    for tc, jc in zip(tcs, jcs):
        assert int(tc["pos"][0]) == int(jc["pos"]) == 16
        for a, b in zip(tc["layers"], jc["layers"]):
            _close(a["k"], b["k"])


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_chained_stages_are_bitwise_the_monolithic_model(weights, flash,
                                                         n_stages):
    _, tp = weights
    _, tcfg = _cfgs(flash)
    prompt = torch.as_tensor(
        np.random.default_rng(6).integers(0, tcfg.vocab, (2, 9)))
    logits, cache = tt.lm_prefill(tp, tcfg, prompt, MAX_SEQ)
    shares = [tt.stage_params(tp, tcfg, k, n_stages)
              for k in range(n_stages)]
    x, caches = prompt, []
    for k, p in enumerate(shares):
        x, c = tt.stage_prefill(p, tcfg, k, n_stages, x, MAX_SEQ)
        caches.append(c)
    assert torch.equal(x, logits)
    # the two rows decode at different positions from here on
    advance = torch.tensor([1, 0], dtype=torch.int32)
    tok = tt.greedy(logits)
    for _ in range(3):
        logits, cache = tt.lm_decode(tp, tcfg, tok, cache, advance=advance)
        x = tok
        for k, p in enumerate(shares):
            x, caches[k] = tt.stage_decode(p, tcfg, k, n_stages, x,
                                           caches[k], advance=advance)
        assert torch.equal(x, logits)
        tok = tt.greedy(logits)
    r = tcfg.n_layers // n_stages
    for k, c in enumerate(caches):
        assert torch.equal(c["pos"], cache["pos"])
        for a, b in zip(c["layers"], cache["layers"][k * r:(k + 1) * r]):
            assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"],
                                                               b["v"])
