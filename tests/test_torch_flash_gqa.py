"""K6's grouped-head kernel (``csrc/flash_decode_gqa.cu``) and K5's
warp-specialised kernel (``csrc/flash_prefill_sm90.cu``) at head dims 128
and 256, bf16.

On the CPU the grouped kernel's arithmetic is emulated in PyTorch with its
geometry (``decode_geometry``: the split width, the stage width ``TK``, the
head tiles, the sub-partials of the warps or lane groups merged in order,
then the splits combined in order) and held to the JAX package's
``flash_decode_step`` slot by slot at atol = rtol = 2e-5 (f32, two
frameworks, summation orders differ); with bf16 inputs and the tensor-core
route's hi/lo P split, to the plain version within one bf16 ulp + 1e-5.
The fp32 route of the same file (``gqa_f32``: stages of ``GQA_F32_STAGE``
keys split between ``gqa_f32_key_groups`` warps, log2-domain scores) is
emulated the same way against ``flash_decode_step``.  The geometry helper
is pinned, and shown not to depend on the slot count.

On the card (``cuda`` marker, skipped here) both kernels are held to their
plain versions within one bf16 ulp + 1e-5, K6 at G = 1, 2, 6, 8 and 48 with
a slot alone bitwise the same slot in a batch of 8, a repeated call and a
CUDA graph replay bitwise the eager call; K5 at the parametrisation of
``test_torch_flash_wide.py`` plus ragged query lengths around its 128-row
tiles, each call counted once on its compiled kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_decode_step as jax_decode
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels.ref import NEG_INF

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)
BF16_ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA GPU and nvcc (a CUDA "
                    "kernel has no interpret mode)")
    return torch.device("cuda")


def _bf16_excess(out, ref):
    """How far |out - ref| exceeds one bf16 ulp of ref."""
    mag = ref.abs().clamp_min(2.0 ** -100)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((out.float() - ref).abs() - ulp).max().item()


def _hi_lo(p):
    hi = p.to(torch.bfloat16)
    return hi.float() + (p - hi.float()).to(torch.bfloat16).float()


def _subs(kernel, tk, d, groups):
    """-> (sub-partial of each key of a tile, number of sub-partials): the
    four warps' 16-key quarters (``gqa_mma``), the ``gqa_f32_key_groups``
    warps' shares of a stage (``gqa_f32``), or the lane groups of the SIMT
    route (warp w's keys 8w .. 8w + 7, ``32 / (d / 8)`` groups a warp taking
    every other key)."""
    r = np.arange(tk)
    if kernel == "gqa_mma":
        return r // 16, 4
    if kernel == "gqa_f32":
        kq = fa.gqa_f32_key_groups(d, groups)
        return r // (tk // kq), kq
    gpw = 32 // (d // 8)
    kpw = tk // 4
    return (r // kpw) * gpw + (r % kpw) % gpw, 4 * gpw


def _emulate_gqa(q, kc, vc, pos, groups, p_split=None,
                 dtype=torch.bfloat16):
    """flash_decode_gqa.cu's arithmetic in f32, on ``dtype``'s route: per
    split of ``decode_geometry``'s width, ``TK``-key tiles; each sub-partial
    keeps its own online softmax (m, l, acc) over its keys; the block merges
    them in index order; the splits combine in order (the neutral (-1e30,
    0, 0) past ``pos``).  The tensor-core route scales S after Q K^T, the
    SIMT routes scale q first (``gqa_f32`` by D^-0.5 log2(e): its scores
    and merges are in the log2 domain); ``p_split`` rounds P as the
    kernel's P V does."""
    s_, smax, kv, d = kc.shape
    h = kv * groups
    geo = fa.decode_geometry(smax, kv, groups, d, dtype)
    tk = fa.GQA_F32_STAGE[d] if geo.kernel == "gqa_f32" else \
        fa.GQA_TILE[geo.kernel]
    sub, nsub = _subs(geo.kernel, tk, d, groups)
    scale = d ** -0.5
    exp = torch.exp
    qf = q.float().reshape(s_, kv, groups, d)
    if geo.kernel == "gqa_simt":
        qf = qf * scale
    elif geo.kernel == "gqa_f32":
        qf = qf * np.float32(scale * 1.4426950408889634)
        exp = torch.exp2
    kf = kc.float().permute(0, 2, 1, 3)                    # [S, kv, Smax, d]
    vf = vc.float().permute(0, 2, 1, 3)
    n = (pos.long().clamp(0, smax - 1) + 1).reshape(s_, 1, 1, 1)
    pm = torch.full((s_, kv, groups, geo.nsplit), NEG_INF)
    pl = torch.zeros((s_, kv, groups, geo.nsplit))
    pa = torch.zeros((s_, kv, groups, geo.nsplit, d))
    for c in range(geo.nsplit):
        c0 = c * geo.split
        kend = torch.clamp(n, max=c0 + geo.split)
        m = torch.full((s_, kv, groups, nsub), NEG_INF)
        l = torch.zeros((s_, kv, groups, nsub))
        acc = torch.zeros((s_, kv, groups, nsub, d))
        for t0 in range(c0, min(c0 + geo.split, smax), tk):
            kj, vj = kf[:, :, t0:t0 + tk], vf[:, :, t0:t0 + tk]
            sc = qf @ kj.transpose(-1, -2)                 # [S, kv, G, tk']
            if geo.kernel == "gqa_mma":
                sc = sc * scale
            keys = torch.arange(t0, t0 + kj.shape[2]).reshape(1, 1, 1, -1)
            valid = keys < kend
            for j in range(nsub):
                mine = torch.as_tensor(sub[:kj.shape[2]] == j)
                ok = valid & mine
                s_j = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
                m_new = torch.maximum(m[..., j], s_j.amax(-1))
                p = torch.where(ok, exp(s_j - m_new[..., None]),
                                torch.zeros_like(sc))
                alpha = exp(m[..., j] - m_new)
                l[..., j] = l[..., j] * alpha + p.sum(-1)
                pv = p if p_split is None else p_split(p)
                acc[..., j, :] = acc[..., j, :] * alpha[..., None] + pv @ vj
                m[..., j] = m_new
        mm = m.amax(-1, keepdim=True)
        e = exp(m - mm)
        live = c0 < n[..., 0]
        pm[..., c] = torch.where(live, mm[..., 0], NEG_INF)
        pl[..., c] = torch.where(live, (l * e).sum(-1), 0.0)
        pa[..., c, :] = torch.where(live[..., None],
                                    (acc * e[..., None]).sum(-2), 0.0)
    mm = pm.amax(-1, keepdim=True)
    e = exp(pm - mm)
    ll = (pl * e).sum(-1, keepdim=True)
    out = (pa * e[..., None]).sum(-2) / ll.clamp_min(1e-30)
    return out.reshape(s_ * h, d).to(q.dtype)


def _inputs(seed, S, H, kv, d, smax, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in
            [(S * H, d), (S, smax, kv, d), (S, smax, kv, d)]]


# ---------------------------------------------------------------------------
# the emulation against the JAX package and the plain version (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,groups,kv,smax", [
    (128, 48, 1, 1500),     # granite's group: 3 head tiles, 2 tiles a split
    (256, 48, 1, 300),
    (128, 6, 2, 300),       # mixtral's group: one padded m16 tile
    (256, 6, 1, 700),
    (128, 2, 4, 600),       # gemma3's group on the SIMT route
    (256, 2, 4, 600),
])
def test_gqa_emulation_matches_jax_flash_decode_step_slot_by_slot(
        d, groups, kv, smax):
    geo = fa.decode_geometry(smax, kv, groups, d)
    h = kv * groups
    pos = [0, geo.split - 1, geo.split, smax - 1]
    q, kc, vc = _inputs(d + groups + smax, len(pos), h, kv, d, smax)
    got = _emulate_gqa(torch.as_tensor(q), torch.as_tensor(kc),
                       torch.as_tensor(vc),
                       torch.tensor(pos, dtype=torch.int32), groups)
    for s, p in enumerate(pos):
        want = jax_decode(jnp.asarray(q[s * h:(s + 1) * h]),
                          jnp.asarray(kc[s].transpose(1, 0, 2)),
                          jnp.asarray(vc[s].transpose(1, 0, 2)),
                          jnp.int32(p), kv_groups=groups)
        np.testing.assert_allclose(got[s * h:(s + 1) * h].numpy(),
                                   np.asarray(want), **TOL)


@pytest.mark.parametrize("d,groups,kv,smax", [
    (128, 48, 1, 1500),     # granite's group: 3 m16 tiles, 64-key splits
    (256, 48, 1, 300),
    (128, 6, 2, 300),       # mixtral's group: one padded m16 tile
    (128, 3, 2, 200),
    (256, 8, 1, 700),       # qwen's group at 256
    (128, 96, 1, 200),      # over 64 rows: two blocks a group
])
def test_gqa_f32_emulation_matches_jax_flash_decode_step_slot_by_slot(
        d, groups, kv, smax):
    """The fp32 route (``gqa_f32``): 64-key stages at 128 (32 at 256), cut
    between ``gqa_f32_key_groups`` warps with their own (m, l, acc), merged
    in order, log2-domain scores; positions 0, a split's last and first
    key, max_seq - 1 and past the cache."""
    geo = fa.decode_geometry(smax, kv, groups, d, torch.float32)
    assert geo.kernel == "gqa_f32"
    h = kv * groups
    pos = [0, geo.split - 1, geo.split, smax - 1, smax + 7]
    q, kc, vc = _inputs(d + groups + smax + 1, len(pos), h, kv, d, smax)
    got = _emulate_gqa(torch.as_tensor(q), torch.as_tensor(kc),
                       torch.as_tensor(vc),
                       torch.tensor(pos, dtype=torch.int32), groups,
                       dtype=torch.float32)
    for s, p in enumerate(pos):
        want = jax_decode(jnp.asarray(q[s * h:(s + 1) * h]),
                          jnp.asarray(kc[s].transpose(1, 0, 2)),
                          jnp.asarray(vc[s].transpose(1, 0, 2)),
                          jnp.int32(min(p, smax - 1)), kv_groups=groups)
        np.testing.assert_allclose(got[s * h:(s + 1) * h].numpy(),
                                   np.asarray(want), **TOL)


@pytest.mark.parametrize("d,groups,kv,smax", [(128, 48, 1, 300),
                                              (256, 8, 1, 200)])
def test_gqa_hi_lo_p_stays_within_one_bf16_ulp_of_plain(d, groups, kv,
                                                        smax):
    """The tensor-core route's P V: P as bf16 hi + lo, bf16 inputs."""
    h = kv * groups
    q, kc, vc = (torch.as_tensor(a).to(torch.bfloat16) for a in
                 _inputs(7, 3, h, kv, d, smax))
    pos = torch.tensor([0, 130, smax - 1], dtype=torch.int32)
    got = _emulate_gqa(q, kc, vc, pos, groups, p_split=_hi_lo)
    ref = fa.flash_decode_plain(q.float(), kc.float(), vc.float(), pos,
                                kv_groups=groups)
    assert _bf16_excess(got, ref) <= BF16_ATOL


def test_gqa_emulation_slot_alone_equals_slot_in_a_batch():
    """The geometry ignores the slot count, so a slot's partials and their
    combine are the same arithmetic alone and in a batch of 8."""
    d, groups, kv, smax = 128, 6, 2, 300
    h = kv * groups
    q, kc, vc = (torch.as_tensor(a) for a in _inputs(3, 8, h, kv, d, smax))
    pos = torch.tensor([5, 0, 299, 64, 63, 150, 1, 200], dtype=torch.int32)
    batch = _emulate_gqa(q, kc, vc, pos, groups)
    for s in (0, 2, 7):
        alone = _emulate_gqa(q[s * h:(s + 1) * h], kc[s:s + 1],
                             vc[s:s + 1], pos[s:s + 1], groups)
        assert torch.equal(alone, batch[s * h:(s + 1) * h])


# ---------------------------------------------------------------------------
# the pure functions that shape the launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,want", [
    # granite-20b: kv 1, G 48 -> one block of 3 m16 tiles, 64-key splits
    ((1024, 1, 48, 128), ("gqa_mma", 64, 16, 1)),
    # at 256 a block holds 2 m16 tiles: G 48 takes 2 blocks
    ((1024, 1, 48, 256), ("gqa_mma", 64, 16, 2)),
    # mixtral-8x22b / qwen1.5-110b / internvl2-76b: kv 8, G 6 or 8
    ((1024, 8, 6, 128), ("gqa_mma", 128, 8, 1)),
    ((1024, 8, 8, 128), ("gqa_mma", 128, 8, 1)),
    # gemma3-4b's global layers: kv 4, G 2 at its serve cache
    ((4096, 4, 2, 256), ("gqa_simt", 256, 16, 1)),
    ((1024, 4, 2, 256), ("gqa_simt", 64, 16, 1)),
    # a split never narrower than a stage; max_seq 1 is one split
    ((1, 1, 1, 128), ("gqa_simt", 32, 1, 1)),
    ((129, 1, 4, 256), ("gqa_mma", 64, 3, 1)),
])
def test_decode_geometry_pinned(args, want):
    assert tuple(fa.decode_geometry(*args)) == want


def test_decode_geometry_routes_and_ignores_the_slot_count():
    bf16, f32 = torch.bfloat16, torch.float32
    assert fa.decode_geometry(1024, 32, 1, 64) == \
        ("split", fa.DECODE_SPLIT, 8, 1)
    # fp32: groups over 2 take flash_decode_gqa.cu's f32 route, groups of
    # 1-2 stay on flash_decode.cu
    assert fa.decode_geometry(1024, 1, 48, 128, f32) == \
        ("gqa_f32", 64, 16, 1)
    assert fa.decode_geometry(1024, 4, 2, 256, f32) == \
        ("split", fa.DECODE_SPLIT, 8, 1)
    assert fa.decode_kernel(bf16, 128, 3) == "gqa_mma"
    assert fa.decode_kernel(bf16, 256, 2) == "gqa_simt"
    assert fa.decode_kernel(bf16, 64, 48) == "split"
    with pytest.raises(TypeError):
        fa.decode_kernel(torch.float16, 128, 8)
    # rows = S·H: the split count is the same for any S
    for S in (1, 3, 8, 64):
        assert fa.decode_scratch_shape(S * 48, 1024, 128, kv=1,
                                       groups=48) == (S * 48, 16, 130)
    assert fa.prefill_kernel(bf16, 64) == "sm90"
    assert fa.prefill_kernel(bf16, 128) == "sm90_ws"
    assert fa.prefill_kernel(bf16, 256) == "sm90_ws"
    assert fa.prefill_kernel(f32, 64) == "scalar"
    assert fa.prefill_kernel(f32, 256) == "scalar_wide"


def test_kernel_launches_counts_nothing_on_the_cpu():
    fa.reset_launches()
    q, kc, vc = (torch.as_tensor(a).to(torch.bfloat16) for a in
                 _inputs(1, 2, 8, 1, 128, 64))
    pos = torch.tensor([3, 63], dtype=torch.int32)
    fa.flash_decode(q, kc, vc, pos, kv_groups=8)
    q3 = q.reshape(2, 8, 128)
    fa.flash_attention(q3, q3, q3)
    assert set(fa.KERNEL_LAUNCHES) == {
        f"{w}/{k}/{d}" for w, ks in fa.KERNELS.items() for k in ks
        for d in fa.KERNEL_HEAD_DIMS}
    assert not any(fa.KERNEL_LAUNCHES.values())


# ---------------------------------------------------------------------------
# the CUDA kernels (on the card only)
# ---------------------------------------------------------------------------

def _card_inputs(cuda, seed, S, H, kv, d, smax, pos=None):
    q, kc, vc = (torch.as_tensor(a).to(cuda, torch.bfloat16) for a in
                 _inputs(seed, S, H, kv, d, smax))
    if pos is None:
        pos = np.linspace(0, smax - 1, S).astype(np.int32)
    return q, kc, vc, torch.as_tensor(np.asarray(pos, np.int32), device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("d,S,H,kv,smax", [
    (128, 8, 48, 1, 1024),      # granite's serve cache (G 48)
    (128, 4, 48, 8, 1024),      # mixtral (G 6)
    (128, 4, 64, 8, 1024),      # qwen1.5-110b, internvl2-76b (G 8)
    (128, 3, 8, 4, 300),        # G 2, ragged
    (128, 3, 4, 4, 129),        # G 1
    (256, 8, 8, 4, 4096),       # gemma3's serve cache (G 2)
    (256, 3, 48, 1, 300),
    (256, 3, 6, 1, 129),
    (256, 3, 8, 1, 200),
    (256, 3, 4, 4, 64),         # G 1
])
def test_gqa_decode_kernel_matches_plain_on_card(cuda, d, S, H, kv, smax):
    q, kc, vc, pos = _card_inputs(cuda, d + H + smax, S, H, kv, d, smax)
    kern = fa.decode_kernel(torch.bfloat16, d, H // kv)
    key = f"flash_decode/{kern}/{d}"
    before = fa.KERNEL_LAUNCHES[key]
    o = fa.flash_decode(q, kc, vc, pos, kv_groups=H // kv)
    ref = fa.flash_decode_plain(q.float(), kc.float(), vc.float(), pos,
                                kv_groups=H // kv)
    torch.cuda.synchronize()
    assert fa.KERNEL_LAUNCHES[key] == before + 1
    assert o.shape == (S * H, d) and o.dtype == torch.bfloat16
    assert _bf16_excess(o, ref) <= BF16_ATOL
    # no atomics: the same call gives the same bits
    assert torch.equal(o, fa.flash_decode(q, kc, vc, pos, kv_groups=H // kv))


@pytest.mark.cuda
@pytest.mark.parametrize("d,H,kv,smax", [(128, 48, 1, 1024),
                                         (128, 8, 1, 300),
                                         (256, 8, 4, 4096)])
def test_gqa_decode_slot_alone_is_bitwise_the_slot_in_a_batch(cuda, d, H,
                                                              kv, smax):
    pos = [0, 63, 64, 127, 500 % smax, smax - 2, smax - 1, 129]
    q, kc, vc, p = _card_inputs(cuda, 5, 8, H, kv, d, smax, pos)
    batch = fa.flash_decode(q, kc, vc, p, kv_groups=H // kv)
    for s in range(8):
        alone = fa.flash_decode(q[s * H:(s + 1) * H], kc[s:s + 1],
                                vc[s:s + 1], p[s:s + 1], kv_groups=H // kv)
        assert torch.equal(alone, batch[s * H:(s + 1) * H]), f"slot {s}"


@pytest.mark.cuda
@pytest.mark.parametrize("d,H,kv,smax", [(128, 48, 1, 1024),
                                         (256, 8, 4, 4096)])
def test_gqa_decode_graph_replay_is_bitwise_the_eager_call(cuda, d, H, kv,
                                                           smax):
    q, kc, vc, pos = _card_inputs(cuda, 9, 8, H, kv, d, smax)
    eager = fa.flash_decode(q, kc, vc, pos, kv_groups=H // kv)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm the allocator off the capture
        fa.flash_decode(q, kc, vc, pos, kv_groups=H // kv)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_decode(q, kc, vc, pos, kv_groups=H // kv)
    for step in range(3):               # positions move between replays
        pos.add_(1).clamp_(max=smax - 1)
        want = fa.flash_decode(q, kc, vc, pos, kv_groups=H // kv)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want), f"replay {step}"
    assert not torch.equal(out, eager)


def _check_ws_prefill(cuda, d, bh, groups, sq, sk, causal, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
               .to(cuda, torch.bfloat16) for s in
               [(bh, sq, d), (bh // groups, sk, d), (bh // groups, sk, d)])
    key = f"flash_attention/sm90_ws/{d}"
    before = fa.KERNEL_LAUNCHES[key]
    o = fa.flash_attention(q, k, v, causal=causal, kv_groups=groups)
    ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                   causal=causal, kv_groups=groups)
    torch.cuda.synchronize()
    assert fa.KERNEL_LAUNCHES[key] == before + 1
    assert o.shape == (bh, sq, d) and o.dtype == torch.bfloat16
    assert _bf16_excess(o, ref) <= BF16_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("d,bh,groups,sq,sk,causal", [
    (128, 48, 48, 128, 128, True),      # test_torch_flash_wide.py's cases
    (128, 48, 48, 300, 300, True),
    (128, 8, 2, 100, 130, True),
    (128, 8, 2, 130, 100, False),
    (256, 8, 2, 256, 256, True),
    (256, 8, 2, 77, 77, True),
    (256, 4, 1, 130, 100, True),
    (256, 4, 4, 100, 100, False),
    (256, 8, 2, 2000, 2000, True),
    (256, 8, 2, 2048, 2048, True),
    # ragged Sq around the 128-row tile: 1-64 rows leave the second
    # consumer with none
    (128, 4, 2, 1, 1, True),
    (128, 4, 2, 65, 65, True),
    (128, 4, 2, 129, 129, True),
    (128, 4, 2, 191, 191, True),
    (128, 4, 4, 193, 300, False),
    (256, 4, 2, 64, 64, True),
    (256, 4, 2, 129, 129, True),
    (256, 4, 1, 250, 200, True),
])
def test_ws_prefill_kernel_matches_plain_on_card(cuda, d, bh, groups, sq,
                                                 sk, causal):
    _check_ws_prefill(cuda, d, bh, groups, sq, sk, causal, seed=d + sq + sk)
