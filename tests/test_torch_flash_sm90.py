"""What the card's K5 and K6 designs rest on, tested on the CPU.

The bf16 K5 kernel (``csrc/flash_prefill_sm90.cu``) runs O += P·V on bf16
tensor cores with P split into ``p_hi = bf16(p)`` and ``p_lo = bf16(p -
p_hi)``; K6 (``csrc/flash_decode.cu``) is split-KV: per-chunk partials
(m, l, acc) and an in-order combine.  Neither kernel runs here, so their
arithmetic is emulated in PyTorch (f32 everywhere the kernels keep f32) and
held to the port's plain version and to the JAX package.  The pure
functions that shape the launches (route, NSPLIT, scratch shape, the
16-byte alignment rule) are tested directly.

Tolerances: bf16 outputs within one bf16 ulp + 1e-5 of the f32 plain
version (chip_smoke's ``BF16_ATOL``; the f32 sums run in another order);
split-KV against JAX ``flash_decode_step`` atol = rtol = 2e-5, as
tests/test_torch_flash_attn.py (f32, two frameworks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_decode_step as jax_decode
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels.ref import NEG_INF

torch.set_num_threads(2)

BF16_ATOL = 1e-5
TOL = dict(atol=2e-5, rtol=2e-5)


def _bf16(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16) for s in shapes]


def _bf16_excess(out, ref):
    """Largest amount by which |out - ref| exceeds one bf16 ulp of ref."""
    mag = ref.abs().clamp_min(2.0 ** -100)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((out.float() - ref).abs() - ulp).max().item()


def _emulate_prefill(q, k, v, p_split):
    """The bf16 K5 kernel's arithmetic, causal, 64-key tiles: S in f32
    (bf16 products are exact), online softmax in f32, and P·V with P as
    ``p_split(p)`` -> bf16 parts whose f32 products are summed."""
    bh, sq, dk = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, sq, 1), NEG_INF)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, v.shape[2]))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, sq, 64):
        s = (qf @ kf[:, k0:k0 + 64].transpose(1, 2)) * dk ** -0.5
        valid = (qpos >= torch.arange(k0, k0 + s.shape[2])[None, :])[None]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for part in p_split(p):
            acc = acc + part.float() @ vf[:, k0:k0 + 64]
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


def _hi_lo(p):
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.float()).to(torch.bfloat16)


def _bf16_p(p):
    return (p.to(torch.bfloat16),)


@pytest.mark.parametrize("length", [128, 512])
def test_hi_lo_p_split_stays_within_one_bf16_ulp(length):
    q, k, v = _bf16(length, (32, length, 64), (32, length, 64),
                    (32, length, 64))
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                   causal=True)
    got = _emulate_prefill(q, k, v, _hi_lo)
    assert _bf16_excess(got, ref) <= BF16_ATOL


def test_a_single_bf16_p_misses_the_tolerance():
    """The reason for the split: P rounded to bf16 alone lands ~1e-3
    beyond one ulp of the f32 plain version."""
    q, k, v = _bf16(512, (32, 512, 64), (32, 512, 64), (32, 512, 64))
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                   causal=True)
    assert _bf16_excess(_emulate_prefill(q, k, v, _bf16_p), ref) > 1e-4
    assert _bf16_excess(_emulate_prefill(q, k, v, _hi_lo), ref) <= BF16_ATOL


# ---------------------------------------------------------------------------
# K6 split-KV
# ---------------------------------------------------------------------------

def _emulate_split_kv(q, kc, vc, pos, groups):
    """The K6 kernel's arithmetic: partials (m, l, acc) per DECODE_SPLIT-key
    chunk into the scratch of ``decode_scratch_shape`` (the neutral
    (-1e30, 0, 0) past ``pos``), then the combine over splits in order."""
    s_, smax, kvh, d = kc.shape
    h = kvh * groups
    part = torch.empty(fa.decode_scratch_shape(s_ * h, smax, d))
    qf = q.float().reshape(s_, h, d) * d ** -0.5
    kf = kc.float().repeat_interleave(groups, dim=2)       # [S, Smax, H, d]
    vf = vc.float().repeat_interleave(groups, dim=2)
    n = pos.long().clamp(0, smax - 1) + 1
    split = fa.DECODE_SPLIT
    for c in range(fa.decode_splits(smax)):
        c0 = c * split
        kj, vj = kf[:, c0:c0 + split], vf[:, c0:c0 + split]
        sc = torch.einsum("shd,skhd->shk", qf, kj)
        valid = (torch.arange(c0, c0 + kj.shape[1])[None, :] <
                 n[:, None])[:, None, :]
        sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
        m = sc.amax(-1)
        p = torch.where(valid, torch.exp(sc - m[..., None]),
                        torch.zeros_like(sc))
        acc = torch.einsum("shk,skhd->shd", p, vj)
        live = (c0 < n)[:, None]
        part[:, c, 0] = torch.where(live, m, NEG_INF).reshape(-1)
        part[:, c, 1] = torch.where(live, p.sum(-1), 0.0).reshape(-1)
        part[:, c, 2:] = torch.where(live[..., None], acc, 0.0) \
            .reshape(-1, d)
    m = part[:, :, 0].amax(1, keepdim=True)
    e = torch.exp(part[:, :, 0] - m)
    l = (part[:, :, 1] * e).sum(1, keepdim=True)
    out = (part[:, :, 2:] * e[..., None]).sum(1)
    return (out / l.clamp_min(1e-30)).to(q.dtype)


@pytest.mark.parametrize("smax", [256, 300])
@pytest.mark.parametrize("groups", [1, 2])
def test_split_kv_matches_jax_flash_decode_step_slot_by_slot(smax, groups):
    S, kvh, d = 4, 2, 64
    h = kvh * groups
    rng = np.random.default_rng(smax + groups)
    q, kc, vc = (rng.standard_normal(s).astype(np.float32) for s in
                 [(S * h, d), (S, smax, kvh, d), (S, smax, kvh, d)])
    pos = [0, 127, 128, smax - 1]
    got = _emulate_split_kv(torch.as_tensor(q), torch.as_tensor(kc),
                            torch.as_tensor(vc),
                            torch.tensor(pos, dtype=torch.int32), groups)
    for s in range(S):
        want = jax_decode(jnp.asarray(q[s * h:(s + 1) * h]),
                          jnp.asarray(kc[s].transpose(1, 0, 2)),
                          jnp.asarray(vc[s].transpose(1, 0, 2)),
                          jnp.int32(pos[s]), kv_groups=groups)
        np.testing.assert_allclose(got[s * h:(s + 1) * h].numpy(),
                                   np.asarray(want), **TOL)


def test_split_kv_matches_the_plain_version():
    S, h, kvh, smax = 3, 8, 2, 300
    rng = np.random.default_rng(9)
    q, kc, vc = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                 for s in [(S * h, 64), (S, smax, kvh, 64),
                           (S, smax, kvh, 64)])
    pos = torch.tensor([5, 200, smax - 1], dtype=torch.int32)
    np.testing.assert_allclose(
        _emulate_split_kv(q, kc, vc, pos, h // kvh).numpy(),
        fa.flash_decode_plain(q, kc, vc, pos, kv_groups=h // kvh).numpy(),
        **TOL)


# ---------------------------------------------------------------------------
# the pure functions that shape the launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smax,nsplit", [(1, 1), (127, 1), (128, 1),
                                         (129, 2), (300, 3), (1024, 8)])
def test_decode_splits_and_scratch_shape(smax, nsplit):
    assert fa.DECODE_SPLIT == 128
    assert fa.decode_splits(smax) == nsplit
    assert fa.decode_scratch_shape(8 * 32, smax) == (256, nsplit, 66)


def test_tma_alignment_predicate():
    # the serve path's q2: [1, L, H, 64] bf16 viewed as [H, L, 64]
    H, L = 32, 300
    q2 = torch.empty((1, L, H, 64), dtype=torch.bfloat16) \
        .permute(0, 2, 1, 3).reshape(H, L, 64)
    assert q2.stride() == (64, H * 64, 1)
    assert fa.tma_aligned(q2.data_ptr(), q2.stride(), q2.element_size())
    assert fa.tma_aligned(0x7F0000001000, (64, 4096, 1), 2)
    # the decode cache [S, max_seq, kv, 64] as stored
    cache = torch.empty((8, 1024, 32, 64), dtype=torch.bfloat16)
    assert fa.tma_aligned(cache.data_ptr(), cache.stride(), 2)
    # a stride of 65 bf16 elements is 130 bytes: not whole 16-byte words
    assert not fa.tma_aligned(0, (6500, 65, 1), 2)
    # a base 2 bytes off a 16-byte boundary
    assert not fa.tma_aligned(0x7F0000001002, (64, 4096, 1), 2)
    # a last dim that is not contiguous
    assert not fa.tma_aligned(0, (128, 4096, 2), 2)
    # f32: a stride of 4 elements is 16 bytes
    assert fa.tma_aligned(0, (256, 4, 1), 4)
    assert not fa.tma_aligned(0, (256, 2, 1), 4)


def test_prefill_route_by_dtype():
    assert fa.prefill_route(torch.bfloat16) == "sm90"
    assert fa.prefill_route(torch.float32) == "scalar"
    with pytest.raises(TypeError):
        fa.prefill_route(torch.float16)


def test_cpu_bf16_runs_the_plain_version_and_counts_no_route():
    fa.reset_launches()
    q, k, v = _bf16(3, (4, 64, 64), (4, 64, 64), (4, 64, 64))
    o = fa.flash_attention(q, k, v)
    assert torch.equal(o, fa.flash_attention_plain(q, k, v))
    assert fa.PREFILL_ROUTE_LAUNCHES == {"sm90": 0, "scalar": 0}
    fa.PREFILL_ROUTE_LAUNCHES["sm90"] = 3
    fa.reset_launches()
    assert fa.PREFILL_ROUTE_LAUNCHES == {"sm90": 0, "scalar": 0}
