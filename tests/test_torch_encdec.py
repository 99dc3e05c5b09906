"""The port's encoder-decoder (whisper) against the JAX package on the CPU.

``tests/test_models.py::test_whisper_encdec``'s config (2 + 2 layers,
d_model 64, 4 heads, 12 frames, decoder context 40, layernorm, gelu, fp32)
is built in both packages on the reference's weights (``init(PRNGKey(0))``
through ``params_from_numpy``), with numpy-seeded frames and tokens:

* ``encode``, ``train_logits`` and the loss, ``prefill`` (logits and every
  cache leaf) and an 8-step greedy decode chain (logits and the self-
  attention rows) agree within atol = rtol = 1e-5 (f32, the same ops in
  other kernels and summation orders);
* the reference's own contract holds in the port: decode after prefill
  matches teacher forcing (relative error < 1e-2, as ``_roundtrip``);
* init: the port's tree has the reference's keys, shapes and dtypes.

Different by design, pinned in both packages: a decode step at the last
row of the self-attention cache (or past the learned positions) clamps in
the JAX package, which overwrites the last row and reuses the last
position, and raises in the port.

On the card (``cuda``): the decode step carries no host sync, so a CUDA
graph captures it, and the graphed chain is bitwise the eager one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JaxConfig
from repro.models import build_model as jax_build
from repro.models import encdec as jax_ed
from repro_torch.core.buffers import tree_flatten
from repro_torch.core.graphs import GraphedCallable
from repro_torch.models import ModelConfig, build_model
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tt

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
WHISPER = dict(name="t", arch_type="audio", n_layers=2, d_model=64,
               n_heads=4, n_kv_heads=4, d_ff=128, vocab=97, enc_dec=True,
               n_enc_layers=2, enc_seq=12, max_seq=40, mlp_glu=False,
               act="gelu", norm="layernorm", dtype="float32")
SEQ = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graph capture: needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pair():
    jm, pm = jax_build(JaxConfig(**WHISPER)), build_model(
        ModelConfig(**WHISPER))
    jp = jm.init(jax.random.PRNGKey(0))
    pp = tt.params_from_numpy(jax.device_get(jp), pm.cfg, "cpu")
    return jm, pm, jp, pp


def _batch(s=SEQ, seed=3):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, WHISPER["vocab"], (2, s)).astype(np.int32),
         "frames": rng.standard_normal((2, 12, 64)).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_init_matches_the_references_tree():
    pm = build_model(ModelConfig(**WHISPER))
    jm = jax_build(JaxConfig(**WHISPER))
    pp = pm.init(torch.Generator().manual_seed(0), "cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    pl, ptd = tree_flatten(pp)
    jl, jtd = tree_flatten(jax.device_get(jp))
    assert ptd == jtd
    for a, b in zip(pl, jl):
        assert tuple(a.shape) == b.shape and str(a.dtype).endswith(
            str(b.dtype))
    assert pm.param_count(pp) == jm.param_count(jp)


def test_encode_matches_jax(pair):
    jm, pm, jp, pp = pair
    jb, pb = _batch()
    _close(ed.encode(pp, pm.cfg, pb["frames"]),
           jax_ed.encode(jp, jm.cfg, jb["frames"]))


def test_train_logits_and_loss_match_jax(pair):
    jm, pm, jp, pp = pair
    jb, pb = _batch()
    jl, _ = jm.train_logits(jp, jb)
    pl, aux = pm.train_logits(pp, pb)
    assert tuple(pl.shape) == (2, SEQ, WHISPER["vocab"]) and float(aux) == 0
    _close(pl, jl)
    _close(pm.loss(pp, pb)[0], jm.loss(jp, jb)[0])


def test_prefill_and_decode_chain_match_jax(pair):
    jm, pm, jp, pp = pair
    jb, pb = _batch()
    jlog, jc = jm.prefill(jp, jb, max_seq=SEQ + 8)
    plog, pc = pm.prefill(pp, pb, max_seq=SEQ + 8)
    _close(plog, jlog)
    assert pc["pos"].tolist() == [SEQ, SEQ]
    for i in range(2):
        _close(pc["self"][i]["k"], jc["self"][i]["k"])
        _close(pc["self"][i]["v"], jc["self"][i]["v"])
        _close(pc["cross_k"][i], jc["cross_k"][i])
        _close(pc["cross_v"][i], jc["cross_v"][i])
    nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for step in range(8):
        jd, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        pd, pc = pm.decode_step(pp, torch.as_tensor(nxt), pc)
        _close(pd, jd)
        assert pc["pos"].tolist() == [SEQ + step + 1] * 2
        nxt = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    _close(pc["self"][1]["k"], jc["self"][1]["k"])


def test_decode_matches_teacher_forcing(pair):
    _, pm, _, pp = pair
    _, pb = _batch()
    logits, cache = pm.prefill(pp, pb, max_seq=SEQ + 8)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    ld, _ = pm.decode_step(pp, nxt, cache)
    b2 = dict(pb, tokens=torch.cat([pb["tokens"], nxt[:, None]], 1))
    lt, _ = pm.train_logits(pp, b2)
    scale = float(lt[:, -1].abs().max()) + 1e-6
    assert float((ld - lt[:, -1]).abs().max()) / scale < 1e-2


def test_cache_init_matches_jax():
    jc = jax_ed.cache_init(JaxConfig(**WHISPER), 3, 100)
    pc = ed.cache_init(ModelConfig(**WHISPER), 3, 100, "cpu")
    assert tuple(pc["self"][0]["k"].shape) == jc["self"][0]["k"].shape == \
        (3, 40, 4, 16)                   # capped at the decoder's 40
    assert tuple(pc["cross_v"][1].shape) == jc["cross_v"][1].shape
    assert pc["pos"].tolist() == [0, 0, 0]


def test_past_the_decoder_context_jax_clamps_and_the_port_raises(pair):
    """Prefill 6 tokens into an 8-row cache, decode two steps (rows 6 and
    7): the cache is full.  The JAX package's next step writes row 7 again
    and returns ``pos`` 9; the port's raises."""
    jm, pm, jp, pp = pair
    jb, pb = _batch(s=6)
    jlog, jc = jm.prefill(jp, jb, max_seq=8)
    plog, pc = pm.prefill(pp, pb, max_seq=8)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(2):
        jd, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        pd, pc = pm.decode_step(pp, torch.as_tensor(tok), pc)
        tok = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    assert int(jc["pos"]) == 8 and pc["pos"].tolist() == [8, 8]
    row7 = np.asarray(jc["self"][0]["k"][:, 7])
    other = (tok + 1) % WHISPER["vocab"]
    _, jc2 = jm.decode_step(jp, jnp.asarray(other), jc)
    assert int(jc2["pos"]) == 9
    assert not np.array_equal(np.asarray(jc2["self"][0]["k"][:, 7]), row7)
    np.testing.assert_array_equal(np.asarray(jc2["self"][0]["k"][:, :7]),
                                  np.asarray(jc["self"][0]["k"][:, :7]))
    with pytest.raises(ValueError, match="past the decoder"):
        pm.decode_step(pp, torch.as_tensor(other), pc)
    with pytest.raises(ValueError, match="exceeds"):
        pm.prefill(pp, _batch(s=9)[1], max_seq=8)


@pytest.mark.cuda
def test_cuda_graphed_decode_is_bitwise_eager(pair, cuda):
    _, pm, jp, _ = pair
    params = tt.params_from_numpy(jax.device_get(jp), pm.cfg, cuda)
    pb = {k: v.to(cuda) for k, v in _batch()[1].items()}
    step = GraphedCallable(
        lambda p, c, t: pm.decode_step(p, t, c), donate=True)
    runs = []
    for fn in (lambda p, c, t: pm.decode_step(p, t, c), step):
        logits, cache = pm.prefill(params, pb, max_seq=SEQ + 8)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out = []
        for _ in range(6):
            logits, cache = fn(params, cache, tok)
            tok = torch.argmax(logits, -1).to(torch.int32)
            out.append(logits.clone())
        runs.append((torch.stack(out), cache["pos"].clone()))
    assert step.captures == 1 and step.graphs() == 1
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[1][1].tolist() == [SEQ + 6] * 2
