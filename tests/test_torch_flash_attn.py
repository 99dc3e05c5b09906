"""K5 (flash prefill) and K6 (flash decode) of the port against the JAX
package, on the CPU.

Here the port's wrappers run their plain PyTorch versions (the tensors lie
on the CPU); the JAX side runs ``flash_attention`` in Pallas interpret mode
and ``flash_decode_step`` as its ``lax.scan``, as the JAX package's own
tests run them.  The same numpy-seeded inputs go to both.  Tolerance:
atol = rtol = 2e-5, as tests/test_kernels_flash.py (f32, two frameworks,
different summation orders).  The CUDA kernels themselves run only on the
card: those tests carry the ``cuda`` marker and skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention as jax_flash
from repro.kernels.flash_attn import flash_decode_step as jax_decode
from repro.kernels.ref import attn_decode_ref as jax_decode_ref
from repro.kernels.ref import attn_ref as jax_attn_ref
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels.ref import attn_decode_ref, attn_ref

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _port_cache(k):
    """JAX decode layout k [BKV, Sk, d] -> the port's stored cache layout
    [S=1, Sk, kv=BKV, d]."""
    return torch.as_tensor(k).transpose(0, 1)[None].contiguous()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA GPU and nvcc (a CUDA "
                    "kernel has no interpret mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# K5 prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,groups,causal", [(64, 1, True), (128, 2, True),
                                             (64, 4, False), (128, 4, True)])
def test_prefill_matches_jax_flash_attention(s, groups, causal):
    bh, d = 4, 32
    q, k, v = _rand(s + groups, (bh, s, d), (bh // groups, s, d),
                    (bh // groups, s, d))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, bq=64, bk=64, kv_groups=groups)
    got = fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), causal=causal,
                             kv_groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = attn_ref(torch.as_tensor(q), torch.as_tensor(k),
                   torch.as_tensor(v), causal=causal, kv_groups=groups)
    jref = jax_attn_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, kv_groups=groups)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), **TOL)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_prefill_ragged_length_matches_jax_ref(causal):
    """JAX's kernel needs Sq % bq == 0; the port's does not (its last tile
    is masked), so a ragged length is held to JAX's full-softmax oracle."""
    bh, s, d, groups = 4, 77, 32, 2
    q, k, v = _rand(11, (bh, s, d), (bh // groups, s, d), (bh // groups, s, d))
    got = fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), causal=causal,
                             kv_groups=groups)
    want = jax_attn_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, kv_groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_first_token_attends_only_itself():
    q, k, v = _rand(1, (1, 64, 16), (1, 64, 16), (1, 64, 16))
    o = fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                           torch.as_tensor(v), causal=True)
    np.testing.assert_allclose(o[0, 0].numpy(), v[0, 0], atol=1e-5)


# ---------------------------------------------------------------------------
# K6 decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", [0, 31, 63, 100, 127])
@pytest.mark.parametrize("groups", [1, 4])
def test_decode_matches_jax_flash_decode_step(pos, groups):
    bh, sk, dk, dv = 4, 128, 32, 48
    q, k, v = _rand(pos * 7 + groups, (bh, dk), (bh // groups, sk, dk),
                    (bh // groups, sk, dv))
    want = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.int32(pos), bk=128, kv_groups=groups)
    got = fa.flash_decode(torch.as_tensor(q), _port_cache(k), _port_cache(v),
                          torch.tensor([pos], dtype=torch.int32),
                          kv_groups=groups)
    assert tuple(got.shape) == (bh, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jref = jax_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          pos, kv_groups=groups)
    ref = attn_decode_ref(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), pos, kv_groups=groups)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), **TOL)


def test_decode_per_slot_positions_match_jax_slot_by_slot():
    """Three slots decode at their own positions in one call, each equal to
    JAX's single-slot decode step (pos is a per-slot int32 vector)."""
    S, H, kv, sk, d = 3, 4, 2, 96, 32
    q, k, v = _rand(5, (S * H, d), (S, sk, kv, d), (S, sk, kv, d))
    pos = [0, 47, sk - 1]
    got = fa.flash_decode(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v),
                          torch.tensor(pos, dtype=torch.int32),
                          kv_groups=H // kv)
    for s in range(S):
        want = jax_decode(jnp.asarray(q[s * H:(s + 1) * H]),
                          jnp.asarray(k[s].transpose(1, 0, 2)),
                          jnp.asarray(v[s].transpose(1, 0, 2)),
                          jnp.int32(pos[s]), kv_groups=H // kv)
        np.testing.assert_allclose(got[s * H:(s + 1) * H].numpy(),
                                   np.asarray(want), **TOL)


@pytest.mark.parametrize("pos", [0, 17, 40, 62])
def test_cache_beyond_pos_has_no_influence(pos):
    """Garbage in cache rows past ``pos`` must not move the output by one
    ulp (bitwise, within the port)."""
    bh, sk, dk = 2, 64, 16
    q, k, v, noise = _rand(pos, (bh, dk), (bh, sk, dk), (bh, sk, dk),
                           (bh, sk, dk))
    tail = (np.arange(sk) > pos)[None, :, None]
    k2 = np.where(tail, k + 100 * noise, k)
    v2 = np.where(tail, v + 100 * noise, v)
    p = torch.tensor([pos], dtype=torch.int32)
    o1 = fa.flash_decode(torch.as_tensor(q), _port_cache(k), _port_cache(v), p)
    o2 = fa.flash_decode(torch.as_tensor(q), _port_cache(k2),
                         _port_cache(v2), p)
    assert torch.equal(o1, o2)


def test_pos_zero_attends_only_first_row():
    q, k, v = _rand(2, (2, 16), (2, 64, 16), (2, 64, 16))
    o = fa.flash_decode(torch.as_tensor(q), _port_cache(k), _port_cache(v),
                        torch.tensor([0], dtype=torch.int32))
    np.testing.assert_allclose(o.numpy(), v[:, 0], atol=1e-5)


def test_decode_step_agrees_with_prefill_last_row():
    """Decoding the last position against the cache equals the last row of
    a causal prefill over the same sequence — the handoff at admission."""
    bh, s, d = 4, 64, 32
    q, k, v = _rand(3, (bh, s, d), (bh, s, d), (bh, s, d))
    pre = fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), causal=True)
    step = fa.flash_decode(torch.as_tensor(q[:, -1]), _port_cache(k),
                           _port_cache(v),
                           torch.tensor([s - 1], dtype=torch.int32))
    np.testing.assert_allclose(pre[:, -1].numpy(), step.numpy(), **TOL)


# ---------------------------------------------------------------------------
# dispatch rules
# ---------------------------------------------------------------------------

def test_cpu_calls_run_the_plain_version_and_count_no_launch():
    fa.reset_launches()
    q, k, v = _rand(4, (2, 8, 16), (2, 8, 16), (2, 8, 16))
    o = fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                           torch.as_tensor(v))
    plain = fa.flash_attention_plain(torch.as_tensor(q), torch.as_tensor(k),
                                     torch.as_tensor(v))
    assert torch.equal(o, plain)
    kc = _port_cache(k)
    fa.flash_decode(torch.as_tensor(q[:, 0]), kc, kc,
                    torch.tensor([3], dtype=torch.int32))
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_decode": 0}


def test_a_device_that_is_neither_cpu_nor_cuda_raises():
    q = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        fa.flash_decode(torch.empty((2, 16), device="meta"),
                        torch.empty((1, 8, 2, 16), device="meta"),
                        torch.empty((1, 8, 2, 16), device="meta"),
                        torch.empty((1,), dtype=torch.int32, device="meta"))


def test_wrappers_reject_mismatched_shapes():
    q = torch.zeros((4, 8, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros((3, 8, 16)), torch.zeros((3, 8, 16)),
                           kv_groups=2)
    with pytest.raises(ValueError):
        fa.flash_decode(torch.zeros((4, 16)), torch.zeros((2, 8, 1, 16)),
                        torch.zeros((2, 8, 1, 16)),
                        torch.zeros((3,), dtype=torch.int32), kv_groups=2)


# ---------------------------------------------------------------------------
# the CUDA kernels (on the card only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_kernel_matches_plain_on_card(cuda, dtype):
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(a).to(cuda, dt) for a in
               _rand(6, (8, 100, 64), (2, 100, 64), (2, 100, 64)))
    before = fa.LAUNCHES["flash_attention"]
    o = fa.flash_attention(q, k, v, causal=True, kv_groups=4)
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                   causal=True, kv_groups=4)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    tol = TOL if dt == torch.float32 else dict(atol=1e-5, rtol=2 ** -7)
    np.testing.assert_allclose(o.float().cpu().numpy(), ref.cpu().numpy(),
                               **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_matches_plain_on_card(cuda, dtype):
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(a).to(cuda, dt) for a in
               _rand(7, (3 * 8, 64), (3, 300, 2, 64), (3, 300, 2, 64)))
    pos = torch.tensor([0, 150, 299], dtype=torch.int32, device=cuda)
    before = fa.LAUNCHES["flash_decode"]
    o = fa.flash_decode(q, k, v, pos, kv_groups=4)
    ref = fa.flash_decode_plain(q.float(), k.float(), v.float(), pos,
                                kv_groups=4)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_decode"] == before + 1
    tol = TOL if dt == torch.float32 else dict(atol=1e-5, rtol=2 ** -7)
    np.testing.assert_allclose(o.float().cpu().numpy(), ref.cpu().numpy(),
                               **tol)
