"""Sliding-window attention and ring-buffer KV caches of the port, against
the JAX package on the CPU (fp32, weights through ``params_from_numpy``).

* The counterpart of ``tests/test_models.py::test_sliding_window_masks_
  history``: a token older than the window leaves the last logits as
  they were.
* ``attn_decode`` on a ring cache, with per-row positions that differ
  (before, at and after the wrap), equals the JAX ``attn_decode`` run row
  by row at each row's scalar position: output and updated ring, atol 1e-5.
* A prefill longer than the ring, then decode across the wrap: every step's
  logits equal the teacher-forced logits of the whole sequence (the JAX
  ``lm_train`` and the port's own prefill), atol 1e-4; and the whole chain,
  logits and caches, equals the JAX ``lm_prefill``/``lm_decode`` chain
  wherever the JAX package rolls the ring right.  It rolls the last
  ``size`` keys by ``-(s % size)``, which is right only when
  ``2 s % size == 0``; the last test pins where the two part.
* The flash gates (K5 prefill, K6 decode) are not taken by windowed
  layers, as in the JAX package, but are by the global layers beside them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JConfig
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro_torch.models import layers as L
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig

torch.set_num_threads(2)

ATOL = 1e-4
WINDOW = 8
CFG = dict(name="t", arch_type="dense", n_layers=2, d_model=32, n_heads=4,
           n_kv_heads=2, d_ff=64, vocab=31, layer_pattern="LG",
           window=WINDOW, dtype="float32")


def _bridged(**kw):
    jcfg, tcfg = JConfig(**{**CFG, **kw}), ModelConfig(**{**CFG, **kw})
    jp = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, tt.params_from_numpy(jax.device_get(jp), tcfg,
                                                 "cpu")


def _tokens(n, seed, vocab=31):
    return np.random.default_rng(seed).integers(0, vocab, n).tolist()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def test_sliding_window_masks_history():
    jcfg, jp, tcfg, tp = _bridged(n_layers=1, layer_pattern="L", window=4,
                                  vocab=13)
    t1 = _tokens(12, 1, 13)
    t2 = [(t1[0] + 1) % 13] + t1[1:]            # mutate far history
    l1, _ = tt.lm_prefill(tp, tcfg, torch.tensor([t1]))
    l2, _ = tt.lm_prefill(tp, tcfg, torch.tensor([t2]))
    np.testing.assert_allclose(_np(l1), _np(l2), atol=1e-5, rtol=0)
    # ... and the window really is what the model sees: a change inside it
    # moves the logits, and the logits are the JAX package's
    t3 = t1[:-2] + [(t1[-2] + 1) % 13, t1[-1]]
    l3, _ = tt.lm_prefill(tp, tcfg, torch.tensor([t3]))
    assert float((l1 - l3).abs().max()) > 1e-3
    jl, _ = jax_tf.lm_train(jp, jcfg, jnp.asarray([t1]))
    np.testing.assert_allclose(_np(l1), np.asarray(jl[:, -1]), atol=ATOL,
                               rtol=0)


def test_ring_cache_sizes_match_jax():
    for max_seq in (4, 8, 20):
        c = L.attn_cache_init(ModelConfig(**CFG), 2, max_seq, WINDOW, "cpu")
        jc = jax_layers.attn_cache_init(JConfig(**CFG), 2, max_seq, WINDOW)
        assert tuple(c["k"].shape) == tuple(jc["k"].shape) == \
            (2, min(WINDOW, max_seq), 2, 8)


def test_ring_decode_per_row_positions_match_jax():
    jcfg, jp, tcfg, tp = _bridged()
    jattn = jp["layers"][0]["attn"]
    tattn = tp["layers"][0]["attn"]
    rng = np.random.default_rng(2)
    pos = np.array([3, 7, 8, 13, 29], np.int32)   # before/at/after the wrap
    b = len(pos)
    x = rng.standard_normal((b, 1, 32)).astype(np.float32)
    k = rng.standard_normal((b, WINDOW, 2, 8)).astype(np.float32)
    v = rng.standard_normal((b, WINDOW, 2, 8)).astype(np.float32)
    cache = {"k": torch.as_tensor(k.copy()), "v": torch.as_tensor(v.copy())}
    y = L.attn_decode(tattn, tcfg, torch.as_tensor(x), cache,
                      torch.as_tensor(pos), WINDOW)
    for r in range(b):
        jy, jc = jax_layers.attn_decode(
            jattn, jcfg, jnp.asarray(x[r:r + 1]),
            {"k": jnp.asarray(k[r:r + 1]), "v": jnp.asarray(v[r:r + 1])},
            jnp.int32(pos[r]), WINDOW)
        np.testing.assert_allclose(_np(y[r:r + 1]), np.asarray(jy),
                                   atol=1e-5, rtol=0)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(cache[name][r:r + 1]),
                                       np.asarray(jc[name]), atol=1e-5,
                                       rtol=0)


def _oracle(tp, tcfg, seq):
    """Teacher-forced logits of the last position (the port's prefill of
    the whole sequence, no cache involved)."""
    return tt.lm_prefill(tp, tcfg, torch.tensor([seq]))[0]


def _chain(tp, tcfg, prompt, steps, max_seq):
    """Port prefill + greedy decode, yielding (sequence so far, logits,
    cache) after each step (the cache is updated in place: read it before
    the next step)."""
    logits, cache = tt.lm_prefill(tp, tcfg, torch.tensor([prompt]), max_seq)
    seq = list(prompt)
    for _ in range(steps):
        tok = tt.greedy(logits)
        seq.append(int(tok[0]))
        logits, cache = tt.lm_decode(tp, tcfg, tok, cache)
        yield list(seq), logits, cache


@pytest.mark.parametrize("s", [3, 9, 11, 16, 19])
def test_prefill_past_the_ring_then_decode_follows_the_oracle(s):
    jcfg, jp, tcfg, tp = _bridged()
    for seq, logits, _ in _chain(tp, tcfg, _tokens(s, s), 12, 40):
        np.testing.assert_allclose(_np(logits), _np(_oracle(tp, tcfg, seq)),
                                   atol=ATOL, rtol=0)
    # the JAX package's teacher-forced logits, at the end of the chain
    jl, _ = jax_tf.lm_train(jp, jcfg, jnp.asarray([seq]))
    np.testing.assert_allclose(_np(logits), np.asarray(jl[:, -1]),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("s", [3, 12, 20])
def test_prefill_and_decode_chain_match_jax(s):
    """Prompt lengths where the JAX ring roll is right (s <= size or
    2 s % size == 0): logits and every cache leaf, step by step."""
    jcfg, jp, tcfg, tp = _bridged()
    prompt = _tokens(s, s)
    jlogits, jcache = jax_tf.lm_prefill(jp, jcfg, jnp.asarray([prompt]), 40)
    for seq, logits, cache in _chain(tp, tcfg, prompt, 12, 40):
        jlogits, jcache = jax_tf.lm_decode(
            jp, jcfg, jnp.asarray([seq[-1]], jnp.int32), jcache)
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits),
                                   atol=ATOL, rtol=0)
        assert int(cache["pos"][0]) == int(jcache["pos"])
        for c, jc in zip(cache["layers"], jcache["layers"]):
            for name in ("k", "v"):
                assert c[name].shape == jc[name].shape
                np.testing.assert_allclose(_np(c[name]),
                                           np.asarray(jc[name]), atol=ATOL,
                                           rtol=0)


def test_where_the_jax_ring_roll_departs_from_its_oracle():
    """s = 11 over a ring of 8: the JAX package's first decode steps leave
    its own teacher-forced logits; the port's do not."""
    jcfg, jp, tcfg, tp = _bridged()
    prompt = _tokens(11, 11)
    jlogits, jcache = jax_tf.lm_prefill(jp, jcfg, jnp.asarray([prompt]), 40)
    seq, logits, _ = next(_chain(tp, tcfg, prompt, 1, 40))
    jlogits, _ = jax_tf.lm_decode(jp, jcfg, jnp.asarray([seq[-1]],
                                                        jnp.int32), jcache)
    jl, _ = jax_tf.lm_train(jp, jcfg, jnp.asarray([seq]))
    want = np.asarray(jl[:, -1])
    assert np.abs(np.asarray(jlogits) - want).max() > 1e-2
    np.testing.assert_allclose(_np(logits), want, atol=ATOL, rtol=0)


def test_flash_gates_skip_windowed_layers(monkeypatch):
    """With ``use_flash_attn``, a G layer reaches K5 and K6 and an L layer
    neither (``layers.py:161``, ``:256`` of the JAX package)."""
    tcfg = dataclasses.replace(ModelConfig(**CFG), head_dim=64,
                               use_flash_attn=True)
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    calls = {"flash_attention": 0, "flash_decode": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    for name in calls:
        monkeypatch.setattr(L, name, counting(name, getattr(L, name)))
    list(_chain(tp, tcfg, _tokens(10, 3), 3, 16))
    # one G layer: one prefill and three decode steps through the kernels
    assert calls == {"flash_attention": 1, "flash_decode": 3}
