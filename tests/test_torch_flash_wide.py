"""K5 and K6 at head dims 128 and 256 (granite, qwen, internvl2, mixtral:
128; gemma3's global layers: 256).

On the CPU the plain versions at these dims are held to the JAX package's
``flash_attention`` (Pallas interpret mode) and ``flash_decode_step`` at
atol = rtol = 2e-5 (f32, two frameworks, summation orders differ), and a
dim outside ``KERNEL_HEAD_DIMS`` is pinned to raise.  The CUDA kernels run
only on the card (``cuda`` marker, skipped here): K5 bf16 (wgmma + TMA,
``flash_prefill_sm90.cu``), K5 fp32 (``flash_prefill.cu``'s tiled kernel)
and K6 (``flash_decode.cu``) against their plain versions, fp32 within
atol = rtol = 2e-5, bf16 within one bf16 ulp plus 1e-5 (the plain version
in f32 on the same bf16 inputs), at MQA (granite: 48 query heads on one kv
head) and GQA 2 (gemma3), ragged lengths included.
"""
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention as jax_flash
from repro.kernels.flash_attn import flash_decode_step as jax_decode
from repro_torch.kernels import flash_attn as fa

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA GPU and nvcc (a CUDA "
                    "kernel has no interpret mode)")
    return torch.device("cuda")


def _bf16_excess(out, ref):
    """How far |out - ref| exceeds one bf16 ulp of ref (8 significant
    bits); the bf16 tolerance is an excess of at most 1e-5."""
    mag = ref.abs().clamp_min(2.0 ** -100)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((out.float() - ref).abs() - ulp).max().item()


# ---------------------------------------------------------------------------
# the plain versions against the JAX package (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,bh,groups,s", [(128, 4, 4, 64), (256, 4, 2, 64),
                                           (128, 2, 1, 96)])
def test_prefill_plain_matches_jax_at_wide_dims(d, bh, groups, s):
    q, k, v = _rand(d + s, (bh, s, d), (bh // groups, s, d),
                    (bh // groups, s, d))
    ref = np.asarray(jax_flash(q, k, v, causal=True, bq=32, bk=32,
                               kv_groups=groups, interpret=True))
    out = fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), causal=True,
                             kv_groups=groups)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("d,h,kv", [(128, 8, 1), (256, 4, 2)])
def test_decode_plain_matches_jax_at_wide_dims(d, h, kv):
    smax, pos = 96, 70
    q, k, v = _rand(d + h, (h, d), (kv, smax, d), (kv, smax, d))
    ref = np.asarray(jax_decode(q, k, v, np.int32(pos), kv_groups=h // kv))
    kc = torch.as_tensor(k).transpose(0, 1)[None].contiguous()
    vc = torch.as_tensor(v).transpose(0, 1)[None].contiguous()
    out = fa.flash_decode(torch.as_tensor(q), kc, vc,
                          torch.tensor([pos], dtype=torch.int32),
                          kv_groups=h // kv)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_head_dims_set():
    assert fa.KERNEL_HEAD_DIMS == (64, 128, 256)
    assert fa.decode_scratch_shape(8 * 48, 1024, 128) == (384, 8, 130)
    assert fa.decode_scratch_shape(8 * 8, 1024, 256) == (64, 8, 258)


# ---------------------------------------------------------------------------
# the CUDA kernels (on the card only)
# ---------------------------------------------------------------------------

def _check_prefill(cuda, dtype, d, bh, groups, sq, sk, causal, seed=0):
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(a).to(cuda, dt) for a in
               _rand(seed, (bh, sq, d), (bh // groups, sk, d),
                     (bh // groups, sk, d)))
    before = fa.LAUNCHES["flash_attention"]
    route = dict(fa.PREFILL_ROUTE_LAUNCHES)
    o = fa.flash_attention(q, k, v, causal=causal, kv_groups=groups)
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                   causal=causal, kv_groups=groups)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    want = fa.prefill_route(dt)
    assert fa.PREFILL_ROUTE_LAUNCHES[want] == route[want] + 1
    assert o.shape == (bh, sq, d) and o.dtype == dt
    if dt == torch.float32:
        torch.testing.assert_close(o, ref, **TOL)
    else:
        assert _bf16_excess(o, ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d,bh,groups,sq,sk,causal", [
    (128, 48, 48, 128, 128, True),      # granite: MQA
    (128, 48, 48, 300, 300, True),      # ragged
    (128, 8, 2, 100, 130, True),        # Sq < Sk
    (128, 8, 2, 130, 100, False),
    (256, 8, 2, 256, 256, True),        # gemma3's global layers
    (256, 8, 2, 77, 77, True),
    (256, 4, 1, 130, 100, True),        # Sq > Sk
    (256, 4, 4, 100, 100, False),
    (256, 8, 2, 2000, 2000, True),      # gemma3's longest served prompt
    (256, 8, 2, 2048, 2048, True),
])
def test_wide_prefill_kernel_matches_plain_on_card(cuda, dtype, d, bh,
                                                   groups, sq, sk, causal):
    _check_prefill(cuda, dtype, d, bh, groups, sq, sk, causal, seed=d + sq)


@pytest.mark.cuda
@pytest.mark.parametrize("d,H,kv", [(128, 48, 1), (256, 8, 4)])
def test_wide_prefill_takes_the_serve_layout_on_card(cuda, d, H, kv):
    """q/k/v as ``attn_prefill`` passes them at B = 1: strided [H, L, d]
    views of [1, L, H, d], no copy."""
    L = 300
    q, k, v = _rand(d, (1, L, H, d), (1, L, kv, d), (1, L, kv, d))
    q2 = torch.as_tensor(q).to(cuda, torch.bfloat16).permute(0, 2, 1, 3) \
        .reshape(H, L, d)
    k2, v2 = (torch.as_tensor(a).to(cuda, torch.bfloat16)
              .permute(0, 2, 1, 3).reshape(kv, L, d) for a in (k, v))
    assert q2.stride() == (d, H * d, 1)
    o = fa.flash_attention(q2, k2, v2, causal=True, kv_groups=H // kv)
    ref = fa.flash_attention_plain(q2.float(), k2.float(), v2.float(),
                                   causal=True, kv_groups=H // kv)
    torch.cuda.synchronize()
    assert _bf16_excess(o, ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d,S,H,kv,smax", [
    (128, 8, 48, 1, 1024),              # granite's serve cache
    (128, 3, 8, 2, 300),                # ragged
    (256, 8, 8, 4, 1024),               # gemma3's global layers
    (256, 8, 8, 4, 4096),               # gemma3's serve cache (32 splits)
    (256, 3, 4, 1, 129),
])
def test_wide_decode_kernel_matches_plain_on_card(cuda, dtype, d, S, H, kv,
                                                  smax):
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(a).to(cuda, dt) for a in
               _rand(d + S, (S * H, d), (S, smax, kv, d), (S, smax, kv, d)))
    pos_np = np.linspace(0, smax - 1, S).astype(np.int32)
    pos = torch.as_tensor(pos_np, device=cuda)
    before = fa.LAUNCHES["flash_decode"]
    o = fa.flash_decode(q, k, v, pos, kv_groups=H // kv)
    ref = fa.flash_decode_plain(q.float(), k.float(), v.float(), pos,
                                kv_groups=H // kv)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_decode"] == before + 1
    if dt == torch.float32:
        torch.testing.assert_close(o, ref, **TOL)
    else:
        assert _bf16_excess(o, ref) <= 1e-5
    # no atomics: the same call gives the same bits
    assert torch.equal(o, fa.flash_decode(q, k, v, pos, kv_groups=H // kv))


@pytest.mark.cuda
def test_uninstantiated_head_dim_raises_on_card(cuda):
    q = torch.zeros((4, 64, 96), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="dk == dv"):
        fa.flash_attention(q, q, q)
    cache = torch.zeros((2, 64, 1, 32), dtype=torch.bfloat16, device=cuda)
    pos = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dk == dv"):
        fa.flash_decode(torch.zeros((8, 32), dtype=torch.bfloat16,
                                    device=cuda), cache, cache, pos,
                        kv_groups=4)
