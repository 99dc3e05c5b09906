"""The port's dense transformer against the JAX package on the CPU.

Weights come from the JAX package (``transformer.init_params(PRNGKey(0),
stablelm smoke)``) and cross through the port's weight bridge
``params_from_numpy``; both packages then run the same prompt.  Tolerance:
atol 1e-4 on logits and caches — fp32 models whose attention, norms and
RoPE are computed by two frameworks in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import stablelm_1_6b as jax_stablelm
from repro.models import transformer as jax_tf
from repro_torch.configs import stablelm_1_6b
from repro_torch.models import transformer as tt

torch.set_num_threads(2)

ATOL = 1e-4
MAX_SEQ = 32


def _cfgs(flash):
    jcfg = dataclasses.replace(jax_stablelm.config().smoke(),
                               use_flash_attn=flash)
    tcfg = dataclasses.replace(stablelm_1_6b.config().smoke(),
                               use_flash_attn=flash)
    return jcfg, tcfg


def _bridged(jcfg, tcfg):
    jp = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, tt.params_from_numpy(jax.device_get(jp), tcfg, "cpu")


def test_configs_match_the_jax_package():
    assert dataclasses.asdict(stablelm_1_6b.config()) == \
        dataclasses.asdict(jax_stablelm.config())
    assert dataclasses.asdict(stablelm_1_6b.config().smoke()) == \
        dataclasses.asdict(jax_stablelm.config().smoke())


def test_bridge_is_a_rename_free_copy():
    jcfg, tcfg = _cfgs(True)
    jp, tp = _bridged(jcfg, tcfg)
    jl, _ = jax.tree_util.tree_flatten_with_path(jp)
    for path, leaf in jl:
        node = tp
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert tuple(node.shape) == tuple(leaf.shape)
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_init_params_shapes_and_dtypes_match_jax():
    cfg = stablelm_1_6b.config().smoke()
    jp = jax.eval_shape(lambda: jax_tf.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    tp = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jl, _ = jax.tree_util.tree_flatten_with_path(jp)
    for path, leaf in jl:
        node = tp
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path


@pytest.mark.parametrize("flash", [True, False])
def test_prefill_and_decode_chain_match_jax(flash):
    jcfg, tcfg = _cfgs(flash)
    jp, tp = _bridged(jcfg, tcfg)
    prompt = np.random.default_rng(7).integers(0, tcfg.vocab, 12)
    jl, jc = jax_tf.lm_prefill(jp, jcfg, jnp.asarray(prompt[None],
                                                     jnp.int32), MAX_SEQ)
    tl, tc = tt.lm_prefill(tp, tcfg, torch.as_tensor(prompt[None]), MAX_SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert int(tc["pos"][0]) == int(jc["pos"])
    for a, b in zip(tc["layers"], jc["layers"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(a[key].numpy(), np.asarray(b[key]),
                                       atol=ATOL)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = tt.greedy(tl)
    for _ in range(4):
        assert int(ttok[0]) == int(jtok[0])
        jl, jc = jax_tf.lm_decode(jp, jcfg, jtok, jc)
        tl, tc = tt.lm_decode(tp, tcfg, ttok, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tt.greedy(tl)
    assert int(tc["pos"][0]) == int(jc["pos"]) == 12 + 4


def test_greedy_returns_the_first_maximum_like_jnp_argmax():
    logits = np.array([[0.5, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0],
                       [-1.0, -2.0, -1.0, -5.0]], np.float32)
    got = tt.greedy(torch.as_tensor(logits)).numpy()
    want = np.asarray(jnp.argmax(jnp.asarray(logits), -1))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 0, 0])


def test_serve_decode_step_rows_are_independent_of_other_slots():
    """A slot's token and cache do not depend on what the other slots hold
    (the bitwise continuous == sequential contract rests on it)."""
    _, tcfg = _cfgs(True)
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    _, c1 = tt.lm_prefill(tp, tcfg, torch.tensor([[3, 1, 4, 1, 5]]), MAX_SEQ)
    runs = []
    for filler in (0, 1):
        cache = tt.cache_init(tcfg, 4, MAX_SEQ, "cpu")
        if filler:
            for leaf in cache["layers"]:
                leaf["k"].normal_(generator=torch.Generator().manual_seed(2))
                leaf["v"].normal_(generator=torch.Generator().manual_seed(3))
            cache["pos"][:] = torch.tensor([7, 0, 9, 2], dtype=torch.int32)
        for dst, src in zip(cache["layers"], c1["layers"]):
            for key in ("k", "v"):
                dst[key][2] = src[key][0]
        cache["pos"][2] = c1["pos"][0]
        token = torch.tensor([5, 9, 2, 11], dtype=torch.int32)
        active = torch.tensor([filler == 1, filler == 1, True, False])
        toks = []
        for _ in range(3):
            token = tt.serve_decode_step(tp, tcfg, cache, token, active)
            toks.append(int(token[2]))
        runs.append((toks, cache["layers"][0]["k"][2].clone()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
