"""K5's fp32 route on the card: the register-tiled SIMT kernel
``csrc/flash_prefill.cu`` against the plain version
``flash_attention_plain`` on the CPU, within atol = rtol = 2e-5 (f32 FMAs
summed in another order, scores in the log2 domain).

Every test needs a card (``cuda`` marker) and skips without one.  Inputs
are numpy-seeded; each call must add one to
``PREFILL_ROUTE_LAUNCHES["scalar"]``.  Shapes cover single rows, ragged
query and key tiles (63/65 around the kernel's 64-row tiles), Sq != Sk in
both directions, GQA at ``kv_groups`` = 4, non-causal attention, strided
q/k/v views (16-byte aligned, and misaligned ones that take the kernel's
4-byte-load route).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attn as fa

TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA GPU and nvcc (a CUDA "
                    "kernel has no interpret mode)")
    return torch.device("cuda")


def _inputs(seed, bh, sq, sk, groups=1):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
            for s in ((bh, sq, 64), (bh // groups, sk, 64),
                      (bh // groups, sk, 64))]


def _check(q, k, v, causal=True, groups=1):
    """Run the kernel on card copies of q, k, v (views kept as views) and
    hold it against the plain version on the CPU."""
    before = fa.PREFILL_ROUTE_LAUNCHES["scalar"]
    o = fa.flash_attention(q, k, v, causal=causal, kv_groups=groups)
    torch.cuda.synchronize()
    assert fa.PREFILL_ROUTE_LAUNCHES["scalar"] == before + 1
    assert o.dtype == torch.float32 and o.shape == (q.shape[0], q.shape[1],
                                                    64)
    ref = fa.flash_attention_plain(q.cpu(), k.cpu(), v.cpu(), causal=causal,
                                   kv_groups=groups)
    torch.testing.assert_close(o.cpu(), ref, atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 63, 64, 65, 200, 512, 1024])
def test_fp32_equal_lengths(cuda, s):
    q, k, v = (t.to(cuda) for t in _inputs(s, 4, s, s))
    _check(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(100, 130), (130, 100), (1, 200),
                                   (200, 64), (64, 300)])
def test_fp32_unequal_lengths(cuda, sq, sk, causal):
    q, k, v = (t.to(cuda) for t in _inputs(sq * 1000 + sk, 4, sq, sk))
    _check(q, k, v, causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [65, 512])
def test_fp32_gqa(cuda, s, causal):
    q, k, v = (t.to(cuda) for t in _inputs(s + 7, 8, s, s, groups=4))
    _check(q, k, v, causal=causal, groups=4)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [63, 200, 1024])
def test_fp32_non_causal(cuda, s):
    q, k, v = (t.to(cuda) for t in _inputs(s + 11, 2, s, s))
    _check(q, k, v, causal=False)


@pytest.mark.cuda
def test_fp32_strided_views(cuda):
    rng = np.random.default_rng(5)
    # the serve layout: [H, L, 64] views of [1, L, H, 64] (16-byte strides)
    L, H = 300, 8
    q, k, v = (torch.as_tensor(rng.standard_normal((1, L, H, 64))
                               .astype(np.float32)).to(cuda)
               .permute(0, 2, 1, 3).reshape(H, L, 64) for _ in range(3))
    assert q.stride() == (64, H * 64, 1)
    _check(q, k, v)
    # GQA over strided kv heads
    _check(q, k[:2], v[:2], groups=4)
    # misaligned: a 4-byte offset base and a 65-float row stride
    q, k, v = (torch.as_tensor(rng.standard_normal((4, 130, 65))
                               .astype(np.float32)).to(cuda)[:, :, 1:]
               for _ in range(3))
    assert q.data_ptr() % 16 == 4 and q.stride(1) == 65
    _check(q, k, v)
    _check(q, k, v, causal=False)


@pytest.mark.cuda
def test_fp32_route_counts_each_call(cuda):
    fa.reset_launches()
    q, k, v = (t.to(cuda) for t in _inputs(0, 4, 128, 128))
    for n in range(1, 4):
        fa.flash_attention(q, k, v)
        assert fa.PREFILL_ROUTE_LAUNCHES == {"sm90": 0, "scalar": n}
        assert fa.LAUNCHES["flash_attention"] == n
    # an fp32 CUDA tensor never takes the plain version: dk 32 raises
    with pytest.raises(ValueError):
        fa.flash_attention(q[:, :, :32], k[:, :, :32], v[:, :, :32])
    assert fa.PREFILL_ROUTE_LAUNCHES["scalar"] == 3
