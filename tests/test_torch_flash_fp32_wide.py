"""K5's and K6's fp32 routes at head dims 128 and 256: the persistent tiled
prefill kernel (``flash_prefill.cu``, ``scalar_wide``) and the grouped-head
f32 decode kernel (``flash_decode_gqa.cu``, ``gqa_f32``).

On the CPU the pure functions that shape their launches are pinned:
``wide_prefill_geometry`` (heads an item packs, chunks an item's key
tiles are cut into, units, blocks), ``prefill_kernel``, ``decode_kernel``,
``decode_geometry`` and ``decode_scratch_shape`` at fp32 (granite's group
of 48 at 128 and 256 on ``gqa_f32``, gemma3's group of 2 staying on
``split``, mixtral's 6 and qwen's 8), none depending on the slot count.

On the card (``cuda`` marker, skipped here) both kernels are held to their
plain versions at atol = rtol = 2e-5 (f32 FMAs summed in another order,
scores in the log2 domain), each call counted once under its
``KERNEL_LAUNCHES`` name: K5 at 14a's shapes, Sq = Sk of 1 and 33 (fewer
items than SMs: chunked units and their merge), 4096 rows at granite's 48
heads (many items), kv_groups 1/2/4/48, non-causal, Sq != Sk and
misaligned strided views (the 4-byte route); K6 at groups of 3, 6, 8 and
48 (128) and 48 (256), with 1 to 4 m16 tiles a block and a group over 64
rows, positions 0, max_seq - 1 and past the cache, a slot
alone bitwise the same slot in a batch of 8, and a CUDA graph replay
bitwise the eager call.  This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attn as fa

TOL = dict(atol=2e-5, rtol=2e-5)
F32 = torch.float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA GPU and nvcc (a CUDA "
                    "kernel has no interpret mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the launch-shaping functions (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,want", [
    # granite-20b: 48 heads on one kv head -> 8 heads x 16 positions an item
    ((48, 128, 128, 128, 48, True), (8, 2, 96, 96)),
    ((48, 512, 512, 128, 48, True), (8, 1, 192, 132)),
    ((48, 1024, 1024, 128, 48, True), (8, 1, 384, 132)),
    ((48, 4096, 4096, 128, 48, True), (8, 1, 1536, 132)),
    # gemma3-4b's global layers: kv 4, groups 2 -> 2 heads x 32 positions
    ((8, 128, 128, 256, 2, True), (2, 2, 32, 32)),
    ((8, 512, 512, 256, 2, True), (2, 3, 192, 132)),
    ((8, 1024, 1024, 256, 2, True), (2, 2, 256, 132)),
    ((8, 2000, 2000, 256, 2, True), (2, 1, 252, 132)),
    ((8, 2048, 2048, 256, 2, True), (2, 1, 256, 132)),
    # mixtral / qwen groups of 6 pack 2 heads; a single row is one tile
    ((48, 300, 300, 128, 6, True), (2, 2, 240, 132)),
    ((4, 1, 1, 128, 1, True), (1, 1, 4, 4)),
    ((4, 33, 33, 256, 4, True), (4, 1, 3, 3)),
    # non-causal keys: every item has all of Sk's tiles
    ((4, 100, 300, 128, 4, False), (4, 5, 20, 20)),
])
def test_wide_prefill_geometry_pinned(args, want):
    assert tuple(fa.wide_prefill_geometry(*args, sms=132)) == want


def test_wide_prefill_geometry_fills_the_card_with_few_items():
    for bh, L, d, g in [(8, 512, 256, 2), (48, 128, 128, 48),
                        (8, 1024, 256, 2), (4, 33, 128, 4)]:
        geo = fa.wide_prefill_geometry(bh, L, L, d, g, True, 132)
        items = geo.units // geo.nc
        tiles = -(-L // fa.WIDE_KEYS)
        assert geo.units >= min(132, items * tiles)
        assert geo.nc <= tiles and geo.grid == min(geo.units, 132)
    assert fa.WIDE_ROWS == {128: 128, 256: 64} and fa.WIDE_KEYS == 64


def test_fp32_kernels_by_head_dim_and_group():
    assert fa.prefill_kernel(F32, 64) == "scalar"
    assert fa.prefill_kernel(F32, 128) == "scalar_wide"
    assert fa.prefill_kernel(F32, 256) == "scalar_wide"
    assert fa.prefill_route(F32) == "scalar"
    for g in (3, 6, 8, 48):
        assert fa.decode_kernel(F32, 128, g) == "gqa_f32"
        assert fa.decode_kernel(F32, 256, g) == "gqa_f32"
    for g in (1, 2):
        assert fa.decode_kernel(F32, 128, g) == "split"
        assert fa.decode_kernel(F32, 256, g) == "split"
    assert fa.decode_kernel(F32, 64, 48) == "split"
    assert "scalar_wide" in fa.KERNELS["flash_attention"]
    assert "gqa_f32" in fa.KERNELS["flash_decode"]


@pytest.mark.parametrize("args,want", [
    # granite-20b's cache: one block holds the 3 m16 tiles, 64-key splits
    ((1024, 1, 48, 128), ("gqa_f32", 64, 16, 1)),
    ((1024, 1, 48, 256), ("gqa_f32", 64, 16, 1)),
    # mixtral-8x22b (G 6), qwen1.5-110b / internvl2-76b (G 8): kv 8
    ((1024, 8, 6, 128), ("gqa_f32", 128, 8, 1)),
    ((1024, 8, 8, 128), ("gqa_f32", 128, 8, 1)),
    # gemma3-4b's group of 2 stays on flash_decode.cu's 128-key splits
    ((4096, 4, 2, 256), ("split", 128, 32, 1)),
    ((1024, 4, 2, 256), ("split", 128, 8, 1)),
    # a split is a multiple of 64 keys; over 64 rows a group takes 2 blocks
    ((1, 1, 3, 128), ("gqa_f32", 64, 1, 1)),
    ((300, 2, 3, 128), ("gqa_f32", 64, 5, 1)),
    ((1024, 1, 96, 128), ("gqa_f32", 64, 16, 2)),
])
def test_fp32_decode_geometry_pinned(args, want):
    assert tuple(fa.decode_geometry(*args, F32)) == want


def test_gqa_f32_key_groups_pinned():
    # 12 warps for granite's 3 m16 tiles at 128; registers cap 4 tiles at 2
    assert [fa.gqa_f32_key_groups(128, g) for g in (3, 6, 8, 16, 17, 48,
                                                     49, 64, 96)] == \
        [4, 4, 4, 4, 4, 4, 2, 2, 2]
    assert [fa.gqa_f32_key_groups(256, g) for g in (3, 48, 64)] == [2, 2, 2]
    assert fa.GQA_F32_STAGE == {128: 64, 256: 32} and fa.GQA_F32_TILES == 4


def test_fp32_decode_scratch_ignores_the_slot_count():
    for S in (1, 3, 8, 64):
        assert fa.decode_scratch_shape(S * 48, 1024, 128, kv=1, groups=48,
                                       dtype=F32) == (S * 48, 16, 130)
        assert fa.decode_scratch_shape(S * 48, 1024, 256, kv=1, groups=48,
                                       dtype=F32) == (S * 48, 16, 258)
        assert fa.decode_scratch_shape(S * 8, 4096, 256, kv=4, groups=2,
                                       dtype=F32) == (S * 8, 32, 258)
        assert fa.decode_scratch_shape(S * 48, 1024, 128, kv=8, groups=6,
                                       dtype=F32) == (S * 48, 8, 130)


# ---------------------------------------------------------------------------
# the CUDA kernels (on the card only)
# ---------------------------------------------------------------------------

def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
            for s in shapes]


def _check_prefill(q, k, v, causal, groups):
    d = q.shape[-1]
    key = f"flash_attention/scalar_wide/{d}"
    before = fa.KERNEL_LAUNCHES[key]
    o = fa.flash_attention(q, k, v, causal=causal, kv_groups=groups)
    ref = fa.flash_attention_plain(q, k, v, causal=causal, kv_groups=groups)
    torch.cuda.synchronize()
    assert fa.KERNEL_LAUNCHES[key] == before + 1
    assert o.shape == (q.shape[0], q.shape[1], d) and o.dtype == F32
    torch.testing.assert_close(o, ref, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d,bh,groups,sq,sk,causal", [
    (128, 48, 48, 128, 128, True),      # 14a's granite shapes
    (128, 48, 48, 512, 512, True),
    (128, 48, 48, 1024, 1024, True),
    (256, 8, 2, 128, 128, True),        # 14a's gemma3 shapes
    (256, 8, 2, 512, 512, True),
    (256, 8, 2, 1024, 1024, True),
    (256, 8, 2, 2000, 2000, True),
    (256, 8, 2, 2048, 2048, True),
    (128, 48, 48, 1, 1, True),          # fewer items than SMs
    (256, 8, 2, 1, 1, True),
    (128, 48, 48, 33, 33, True),
    (256, 8, 2, 33, 33, True),
    (128, 48, 48, 4096, 4096, True),    # many items
    (128, 4, 1, 200, 200, True),        # kv_groups 1, 2, 4
    (256, 4, 1, 130, 130, True),
    (128, 8, 2, 300, 300, True),
    (256, 8, 4, 257, 257, True),
    (128, 12, 6, 150, 150, True),       # a group of 6 packs 2 heads
    (128, 8, 2, 300, 300, False),       # non-causal
    (256, 8, 4, 100, 100, False),
    (128, 48, 48, 100, 130, True),      # Sq != Sk
    (128, 8, 2, 130, 100, True),
    (256, 8, 2, 77, 300, False),
    (256, 4, 4, 300, 77, True),
])
def test_scalar_wide_matches_plain_on_card(cuda, d, bh, groups, sq, sk,
                                           causal):
    q, k, v = (t.to(cuda) for t in _rand(
        d + bh + sq + sk, (bh, sq, d), (bh // groups, sk, d),
        (bh // groups, sk, d)))
    _check_prefill(q, k, v, causal, groups)


@pytest.mark.cuda
@pytest.mark.parametrize("d,H,kv", [(128, 48, 1), (256, 8, 4)])
def test_scalar_wide_takes_strided_and_misaligned_views_on_card(cuda, d, H,
                                                                kv):
    L = 200
    # the serve layout: [H, L, d] views of [1, L, H, d] (16-byte strides)
    q, k, v = (t.to(cuda).permute(0, 2, 1, 3).reshape(n, L, d) for t, n in
               zip(_rand(d + 1, (1, L, H, d), (1, L, kv, d), (1, L, kv, d)),
                   (H, kv, kv)))
    assert q.stride() == (d, H * d, 1)
    _check_prefill(q, k, v, True, H // kv)
    # misaligned: a 4-byte offset base and a (d + 1)-float row stride
    q, k, v = (t.to(cuda)[:, :, 1:] for t in _rand(
        d + 2, (H, 130, d + 1), (kv, 130, d + 1), (kv, 130, d + 1)))
    assert q.data_ptr() % 16 == 4 and q.stride(1) == d + 1
    _check_prefill(q, k, v, True, H // kv)
    _check_prefill(q, k, v, False, H // kv)


def _decode_inputs(cuda, seed, S, H, kv, d, smax, pos):
    q, kc, vc = (t.to(cuda) for t in _rand(seed, (S * H, d),
                                           (S, smax, kv, d),
                                           (S, smax, kv, d)))
    return q, kc, vc, torch.as_tensor(np.asarray(pos, np.int32), device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("d,S,H,kv,smax", [
    (128, 8, 48, 1, 1024),      # granite's serve cache (G 48)
    (128, 4, 48, 8, 1024),      # mixtral (G 6)
    (128, 4, 64, 8, 1024),      # qwen1.5-110b, internvl2-76b (G 8)
    (128, 3, 6, 2, 300),        # G 3, ragged
    (128, 3, 20, 1, 200),       # 2 m16 tiles a block
    (128, 2, 64, 1, 300),       # 4 tiles: 2 key groups a tile
    (128, 2, 96, 1, 300),       # over 64 rows: 2 blocks a group
    (256, 8, 48, 1, 1024),      # G 48 at 256
    (256, 3, 6, 2, 129),
    (256, 2, 64, 1, 200),
])
def test_gqa_f32_matches_plain_on_card(cuda, d, S, H, kv, smax):
    # positions 0, max_seq - 1 and past the cache among the slots
    pos = np.linspace(0, smax - 1, S).astype(np.int32)
    pos[-1] = smax + 5
    q, kc, vc, p = _decode_inputs(cuda, d + H + smax, S, H, kv, d, smax, pos)
    key = f"flash_decode/gqa_f32/{d}"
    before = fa.KERNEL_LAUNCHES[key]
    o = fa.flash_decode(q, kc, vc, p, kv_groups=H // kv)
    ref = fa.flash_decode_plain(q, kc, vc, p, kv_groups=H // kv)
    torch.cuda.synchronize()
    assert fa.KERNEL_LAUNCHES[key] == before + 1
    assert o.shape == (S * H, d) and o.dtype == F32
    torch.testing.assert_close(o, ref, **TOL)
    # no atomics: the same call gives the same bits
    assert torch.equal(o, fa.flash_decode(q, kc, vc, p, kv_groups=H // kv))


@pytest.mark.cuda
@pytest.mark.parametrize("d,H,kv,smax", [(128, 48, 1, 1024),
                                         (128, 24, 8, 300),
                                         (256, 48, 1, 1024)])
def test_gqa_f32_slot_alone_is_bitwise_the_slot_in_a_batch(cuda, d, H, kv,
                                                           smax):
    pos = [0, 63, 64, 127, 500 % smax, smax - 2, smax - 1, smax + 3]
    q, kc, vc, p = _decode_inputs(cuda, 5, 8, H, kv, d, smax, pos)
    batch = fa.flash_decode(q, kc, vc, p, kv_groups=H // kv)
    for s in range(8):
        alone = fa.flash_decode(q[s * H:(s + 1) * H], kc[s:s + 1],
                                vc[s:s + 1], p[s:s + 1], kv_groups=H // kv)
        assert torch.equal(alone, batch[s * H:(s + 1) * H]), f"slot {s}"


@pytest.mark.cuda
@pytest.mark.parametrize("d,H,kv,smax", [(128, 48, 1, 1024),
                                         (256, 48, 1, 1024)])
def test_gqa_f32_graph_replay_is_bitwise_the_eager_call(cuda, d, H, kv,
                                                        smax):
    pos = np.linspace(0, smax - 4, 8).astype(np.int32)
    q, kc, vc, p = _decode_inputs(cuda, 9, 8, H, kv, d, smax, pos)
    eager = fa.flash_decode(q, kc, vc, p, kv_groups=H // kv)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm the allocator off the capture
        fa.flash_decode(q, kc, vc, p, kv_groups=H // kv)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_decode(q, kc, vc, p, kv_groups=H // kv)
    for step in range(3):               # positions move between replays
        p.add_(1)
        want = fa.flash_decode(q, kc, vc, p, kv_groups=H // kv)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want), f"replay {step}"
    assert not torch.equal(out, eager)
