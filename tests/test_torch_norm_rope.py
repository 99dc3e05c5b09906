"""The model step's norm and rotary kernels, S4 (``kernels/norm.py``) and
S5 (``kernels/rotary.py``), and their routing in ``models/layers.py``.

On the CPU (no card):

* The plain routes are the expressions ``apply_norm`` and ``apply_rope``
  were before the kernels (copied below as they stood), bitwise: RMSNorm
  and LayerNorm, bf16 and f32, ``rope_frac`` 1.0 and 0.25, [B, S] and
  [B, 1] positions, strided views as MLA passes them, and q and k in one
  call.
* The meta routes return the kernels' shapes and dtypes and book their
  ``cost.py`` counts, whose FLOPs are what the dry run's counter reads off
  the expressions they replace (so its totals against XLA's stay put).
* The routing sends inputs that need a gradient to the eager expression:
  no kernel is called or booked, and the backward runs.
* The wrappers refuse, on every route but the CPU's, what the kernels do
  not take.

On the card (``cuda``): S5 is bitwise the eager expression at granite-20b's
and stablelm-1.6b's shapes; S4 within one bf16 ulp of it (LayerNorm: of
|y| + |bias|, ``_ulps``), a row's output the same bits whatever the batch; both replay bitwise in a captured CUDA
graph; a two-layer granite-20b serve prefill and graphed decode ticks
launch 2 S4 and 1 S5 a layer (and one S4 before the head) with no eager
call; a train step's backward still runs, through the eager expressions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import cost, ref
from repro_torch.kernels import norm as kn
from repro_torch.kernels import rotary as kr
from repro_torch.launch import hlo_analysis as HA
from repro_torch.models import layers as L

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the expressions as they stood before S4 and S5
# ---------------------------------------------------------------------------

def _norm_as_it_stood(p, x, cfg):
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
        y = y * p["scale"]
    return y.to(x.dtype)


def _rope_as_it_stood(x, positions, rope_frac, theta):
    hd = x.shape[-1]
    rot = int(hd * rope_frac) // 2 * 2
    if rot == 0:
        return x
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


def _cfg(norm):
    return dataclasses.replace(get_config("stablelm-1.6b").smoke(), norm=norm)


def _randn(seed, *shape, dtype=torch.float32, device="cpu"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.as_tensor(a).to(device, dtype)


def _norm_params(seed, d, device="cpu"):
    return {"scale": 1.0 + 0.1 * _randn(seed, d, device=device),
            "bias": 0.1 * _randn(seed + 1, d, device=device)}


DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


# ---------------------------------------------------------------------------
# CPU: the plain routes are the old expressions, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("view", ["whole", "last_row", "mla_slice"])
def test_plain_norm_is_the_old_expression_bitwise(dt, norm, view):
    cfg = _cfg(norm)
    base = _randn(3, 2, 5, 96, dtype=DTYPES[dt]) * 3 + 0.5
    x = {"whole": base[..., :64].contiguous(), "last_row": base[:, -1:, :64],
         "mla_slice": base[..., :64]}[view]
    p = _norm_params(7, 64)
    before = dict(L.EAGER_ON_CARD), kn.LAUNCHES["norm"]
    got = L.apply_norm(p, x, cfg)
    want = _norm_as_it_stood(p, x, cfg)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(kn.norm(x, p["scale"], p["bias"] if norm ==
                               "layernorm" else None), want)
    assert (dict(L.EAGER_ON_CARD), kn.LAUNCHES["norm"]) == before


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("frac", [1.0, 0.25])
@pytest.mark.parametrize("positions", ["prefill", "decode"])
def test_plain_rotary_is_the_old_expression_bitwise(dt, frac, positions):
    b, s = (2, 9) if positions == "prefill" else (5, 1)
    q = _randn(1, b, s, 4, 64, dtype=DTYPES[dt])
    k = _randn(2, b, s, 2, 64, dtype=DTYPES[dt])
    if positions == "prefill":
        pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    else:
        pos = torch.tensor([[0], [1], [77], [4095], [8191]], dtype=torch.int32)
    before = kr.LAUNCHES["rotary"]
    got_q, got_k = L.rope_pair(q, k, pos, frac, 10000.0)
    assert torch.equal(got_q, _rope_as_it_stood(q, pos, frac, 10000.0))
    assert torch.equal(got_k, _rope_as_it_stood(k, pos, frac, 10000.0))
    assert torch.equal(L.apply_rope(q, pos, frac, 10000.0), got_q)
    assert kr.LAUNCHES["rotary"] == before


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_plain_rotary_of_mla_style_views_is_bitwise(dt):
    """MLA rotates the tail of each query head and the tail of the latent
    row, both strided views."""
    q = _randn(4, 2, 6, 3, 48, dtype=DTYPES[dt])[..., 32:]
    dkv = _randn(5, 2, 6, 40, dtype=DTYPES[dt])
    kv = dkv[..., None, 24:]
    pos = torch.arange(6, dtype=torch.int32)[None].expand(2, 6)
    assert torch.equal(L.apply_rope(q, pos, 1.0, 500000.0),
                       _rope_as_it_stood(q, pos, 1.0, 500000.0))
    assert torch.equal(L.apply_rope(kv, pos, 1.0, 500000.0),
                       _rope_as_it_stood(kv, pos, 1.0, 500000.0))


def test_nothing_rotates_at_rope_frac_zero():
    q = _randn(0, 1, 3, 2, 16)
    pos = torch.arange(3)[None]
    counter = HA.CostCounter()
    with counter:
        got_q, got_k = kr.rotary(q, q, pos, 0.0, 10000.0)
    assert got_q is q and got_k is q and counter.kernels == {}


# ---------------------------------------------------------------------------
# CPU and meta: the counts
# ---------------------------------------------------------------------------

def _eager_flops(fn, *args):
    c = HA.CostCounter()
    with c:
        fn(*args)
    return c.flops


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_meta_norm_books_its_count_at_the_eager_flops(dt, norm):
    cfg = _cfg(norm)
    x = torch.empty((3, 7, 96), dtype=DTYPES[dt], device="meta")
    p = {k: v.to("meta") for k, v in _norm_params(0, 96).items()}
    count = cost.norm(21, 96, DTYPES[dt], norm == "layernorm")
    counter = HA.CostCounter()
    with counter:
        y = L.apply_norm(p, x, cfg)
    assert y.shape == x.shape and y.dtype == x.dtype and y.is_meta
    assert counter.kernels == {"norm": {"calls": 1, "flops": count.flops,
                                        "bytes": count.bytes}}
    assert count.flops == _eager_flops(_norm_as_it_stood, p, x, cfg)
    size = x.element_size()
    assert count.bytes == 2 * 21 * 96 * size + 96 * 4 * (
        2 if norm == "layernorm" else 1)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("b,s,frac", [(1, 33, 1.0), (16, 1, 1.0),
                                      (2, 9, 0.25)])
def test_meta_rotary_books_one_count_for_q_and_k(dt, b, s, frac):
    q = torch.empty((b, s, 6, 64), dtype=DTYPES[dt], device="meta")
    k = torch.empty((b, s, 2, 64), dtype=DTYPES[dt], device="meta")
    pos = torch.empty((b, s), dtype=torch.int32, device="meta")
    rot = kr.rotated_dims(64, frac)
    count = cost.rotary(b, s, 8, 64, rot, DTYPES[dt], 2)
    counter = HA.CostCounter()
    with counter:
        got_q, got_k = L.rope_pair(q, k, pos, frac, 10000.0)
    assert (got_q.shape, got_k.shape) == (q.shape, k.shape)
    assert got_q.dtype == got_k.dtype == q.dtype and got_q.is_meta
    assert counter.kernels == {"rotary": {"calls": 1, "flops": count.flops,
                                          "bytes": count.bytes}}
    eager = _eager_flops(_rope_as_it_stood, q, pos, frac, 10000.0) + \
        _eager_flops(_rope_as_it_stood, k, pos, frac, 10000.0)
    assert count.flops == eager
    assert count.bytes == 2 * b * s * 8 * 64 * q.element_size() + b * s * 4


def test_cpu_and_meta_count_a_block_alike():
    """A smoke granite decode step on the CPU books the kernels' counts,
    as its meta trace does."""
    from repro_torch.launch import steps as ST
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("granite-20b").smoke(), vocab=512)
    model = build_model(cfg)
    counts = []
    for dev in ("meta", "cpu"):
        params = model.init(torch.Generator().manual_seed(0), dev)
        cache = model.init_cache(2, 16, dev)
        counter = HA.CostCounter()
        with counter:
            ST.make_decode_step(model, None, stacked=False)(
                params, torch.zeros((2,), dtype=torch.int32, device=dev),
                cache)
        counts.append((counter.flops, counter.kernel_calls()))
    assert counts[0] == counts[1]
    assert counts[0][1]["norm"] == 2 * cfg.n_layers + 1
    assert counts[0][1]["rotary"] == cfg.n_layers


# ---------------------------------------------------------------------------
# CPU and meta: the routing and the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_inputs_that_need_a_gradient_take_the_eager_expression(
        device, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel route was taken")
    monkeypatch.setattr(L, "norm", refuse)
    monkeypatch.setattr(L, "rotary", refuse)
    cfg = _cfg("layernorm")
    p = {k: v.to(device).requires_grad_(True)
         for k, v in _norm_params(1, 64).items()}
    x = _randn(2, 2, 3, 64, device=device).requires_grad_(True)
    q = _randn(3, 2, 3, 4, 64, device=device).requires_grad_(True)
    pos = torch.arange(3, device=device)[None].expand(2, 3)
    counter = HA.CostCounter()
    with counter:
        y = L.apply_norm(p, x, cfg)
        r, _ = L.rope_pair(q, q.detach(), pos, 0.25, 10000.0)
        (y.sum() + r.sum()).backward()
    assert counter.kernels == {}
    assert x.grad.shape == x.shape and q.grad.shape == q.shape
    assert p["scale"].grad is not None and p["bias"].grad is not None
    if device == "cpu":
        assert torch.equal(y, _norm_as_it_stood(p, x, cfg))
        assert torch.equal(r, _rope_as_it_stood(q, pos, 0.25, 10000.0))
    with torch.no_grad():       # no gradient to pass: the kernel route
        with pytest.raises(AssertionError, match="kernel route"):
            L.apply_norm(p, x, cfg)


def test_meta_routes_refuse_what_the_kernels_do_not_take():
    m = torch.empty((4, 64), dtype=torch.float16, device="meta")
    scale = torch.empty((64,), device="meta")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kn.norm(m, scale)
    with pytest.raises(TypeError, match="scale must be float32"):
        kn.norm(m.float(), scale.half())
    with pytest.raises(ValueError, match="contiguous"):
        kn.norm(torch.empty((4, 128), device="meta")[:, ::2], scale)
    x = torch.empty((2, 3, 4, 8, 64), device="meta")[:, :, :, 0]
    with pytest.raises(ValueError, match="two levels"):
        kn.norm(x.transpose(0, 1), scale)
    q = torch.empty((2, 3, 4, 64), dtype=torch.bfloat16, device="meta")
    pos = torch.empty((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(TypeError, match="int32 or int64"):
        kr.rotary(q, None, pos.float(), 1.0, 10000.0)
    with pytest.raises(ValueError, match="contiguous"):
        kr.rotary(q.transpose(2, 3)[..., :4, :], None, pos, 1.0, 10000.0)
    with pytest.raises(ValueError, match="broadcast"):
        kr.rotary(q, None, pos[:, :2], 1.0, 10000.0)
    with pytest.raises(ValueError, match="against q"):
        kr.rotary(q, q[:, :, :, :32], pos, 1.0, 10000.0)


def test_row_levels_fold_the_leading_dims():
    t = torch.empty((2, 5, 576))
    assert kn.row_levels(t[..., :512]) == (1, 10, 0, 576)
    assert kn.row_levels(t[:, -1:, :64]) == (1, 2, 0, 2880)
    assert kn.row_levels(t[:, 1:4, :64]) == (2, 3, 2880, 576)
    assert kn.row_levels(torch.empty((3, 2, 4, 8))[:, 0]) == (3, 4, 64, 8)
    assert kn.row_levels(torch.empty((64,))) == (1, 1, 0, 0)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA GPU and nvcc (a CUDA "
                    "kernel has no interpret mode)")
    return torch.device("cuda")


GRANITE_THETA = get_config("granite-20b").rope_theta
STABLELM = get_config("stablelm-1.6b")

#: name -> (B, S, Hq, Hk, hd, rope_frac, theta, dtype)
ROTARY_CASES = {
    "granite_prefill": (1, 1500, 48, 1, 128, 1.0, GRANITE_THETA,
                        torch.bfloat16),
    "granite_decode_16": (16, 1, 48, 1, 128, 1.0, GRANITE_THETA,
                          torch.bfloat16),
    "granite_decode_64": (64, 1, 48, 1, 128, 1.0, GRANITE_THETA,
                          torch.bfloat16),
    "stablelm_prefill": (1, 1020, 32, 32, 64, STABLELM.rope_frac,
                         STABLELM.rope_theta, torch.bfloat16),
    "stablelm_decode_32": (32, 1, 32, 32, 64, STABLELM.rope_frac,
                           STABLELM.rope_theta, torch.bfloat16),
    "rot_96_f32": (2, 300, 8, 2, 128, 0.75, 1000000.0, torch.float32),
}


def _positions(cuda, b, s, seed):
    if s > 1:
        return torch.arange(s, dtype=torch.int32, device=cuda)[None] \
            .expand(b, s)
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 8192, (b, 1)).astype(np.int32),
                           device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ROTARY_CASES))
def test_rotary_is_bitwise_the_eager_expression_on_the_card(cuda, name):
    b, s, hq, hk, hd, frac, theta, dt = ROTARY_CASES[name]
    q = _randn(1, b, s, hq, hd, dtype=dt, device=cuda)
    k = _randn(2, b, s, hk, hd, dtype=dt, device=cuda)
    pos = _positions(cuda, b, s, 3)
    before = kr.LAUNCHES["rotary"]
    got_q, got_k = kr.rotary(q, k, pos, frac, theta)
    torch.cuda.synchronize()
    assert kr.LAUNCHES["rotary"] == before + 1
    assert torch.equal(got_q, ref.rotary_plain(q, pos, frac, theta))
    assert torch.equal(got_k, ref.rotary_plain(k, pos, frac, theta))
    alone = kr.rotary(q, None, pos.long(), frac, theta)[0]
    assert torch.equal(alone, got_q)


@pytest.mark.cuda
def test_rotary_of_mla_views_is_bitwise_on_the_card(cuda):
    """deepseek-v2's shapes: rope 64 of a 192-wide query head, and the 64
    after a 512-wide latent (element-wise chunks where 16 bytes miss)."""
    q = _randn(1, 2, 40, 16, 192, dtype=torch.bfloat16, device=cuda)
    dkv = _randn(2, 2, 40, 576, dtype=torch.bfloat16, device=cuda)
    pos = _positions(cuda, 2, 40, 0)
    for x in (q[..., 128:], dkv[..., None, 512:], dkv[..., None, 509:573]):
        got = kr.rotary(x, None, pos, 1.0, 10000.0)[0]
        assert torch.equal(got, ref.rotary_plain(x, pos, 1.0, 10000.0))


def _ulps(a, b, bias=None):
    """|a - b| in bf16 units of the last place of b, or with a LayerNorm's
    ``bias`` of |b| + |bias|: where the normalised term and the bias cancel,
    the f32 rounding of the statistics (summed in another order than the
    eager reduction's) is many last places of a near-zero output, though
    under one of the terms that were added."""
    m = b.float().abs() if bias is None else b.float().abs() + bias.abs()
    step = torch.ldexp(torch.ones_like(m), torch.frexp(m)[1] - 8)
    return ((a.float() - b.float()).abs() / step).max().item()


#: name -> (rows, d, layernorm, dtype)
NORM_CASES = {
    "granite_prefill": (1774, 6144, False, torch.bfloat16),
    "granite_decode": (64, 6144, False, torch.bfloat16),
    "stablelm_prefill": (1020, 2048, True, torch.bfloat16),
    "stablelm_decode": (32, 2048, True, torch.bfloat16),
    "odd_width": (37, 1001, True, torch.bfloat16),
    "past_the_register_cache": (5, 20000, False, torch.bfloat16),
    "f32_rms": (300, 6144, False, torch.float32),
    "f32_ln": (300, 2050, True, torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NORM_CASES))
def test_norm_is_within_one_ulp_and_rows_do_not_depend_on_the_batch(
        cuda, name):
    rows, d, ln, dt = NORM_CASES[name]
    x = _randn(4, rows, d, dtype=dt, device=cuda) * 2 + 0.3
    p = _norm_params(5, d, cuda)
    bias = p["bias"] if ln else None
    before = kn.LAUNCHES["norm"]
    y = kn.norm(x, p["scale"], bias)
    want = ref.norm_plain(x, p["scale"], bias)
    torch.cuda.synchronize()
    assert kn.LAUNCHES["norm"] == before + 1
    assert y.dtype == dt and y.shape == x.shape
    if dt == torch.bfloat16:
        assert _ulps(y, want, bias) <= 1.0
    else:
        torch.testing.assert_close(y, want, rtol=2e-6, atol=2e-6)
    for lo, hi in ((0, 1), (rows // 3, rows // 3 + 5), (rows - 1, rows)):
        assert torch.equal(kn.norm(x[lo:hi], p["scale"], bias), y[lo:hi])


@pytest.mark.cuda
def test_norm_of_strided_rows_on_the_card(cuda):
    """MLA's ``dkv[..., :512]`` and a two-level slice (16-byte chunks:
    bitwise the same rows made contiguous), and a misaligned slice
    (element by element, another order of the sums)."""
    dkv = _randn(6, 2, 33, 576, dtype=torch.bfloat16, device=cuda)
    p = _norm_params(2, 512, cuda)
    for x in (dkv[..., :512], dkv[:, 1:20, 64:576], dkv[..., 3:515]):
        got = kn.norm(x, p["scale"])
        assert got.is_contiguous() and got.shape == x.shape
        assert _ulps(got, ref.norm_plain(x, p["scale"])) <= 1.0
        if x.data_ptr() % 16 == 0:
            assert torch.equal(got, kn.norm(x.contiguous(), p["scale"]))


@pytest.mark.cuda
def test_both_kernels_replay_bitwise_in_a_cuda_graph(cuda):
    x = _randn(0, 16, 6144, dtype=torch.bfloat16, device=cuda)
    p = _norm_params(1, 6144, cuda)
    q = _randn(2, 16, 1, 48, 128, dtype=torch.bfloat16, device=cuda)
    k = _randn(3, 16, 1, 1, 128, dtype=torch.bfloat16, device=cuda)
    pos = _positions(cuda, 16, 1, 4)

    def step():
        return (kn.norm(x, p["scale"]),) + kr.rotary(q, k, pos, 1.0, 1e4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for i in range(3):              # inputs and positions move
        x.mul_(1.5)
        q.add_(0.25)
        pos.add_(7)
        want = step()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(outs, want)), i


@pytest.mark.cuda
def test_granite_serve_prefill_and_graphed_ticks_launch_s4_and_s5(cuda):
    from repro_torch.core.graphs import GraphedCallable
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("granite-20b"), n_layers=2,
                              use_flash_attn=True)
    params = T.init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    kn.reset_launches()
    kr.reset_launches()
    eager = dict(L.EAGER_ON_CARD)
    tokens = torch.randint(0, cfg.vocab, (1, 300), device=cuda)
    with torch.no_grad():
        T.lm_prefill(params, cfg, tokens, 512)
    per = {"norm": 2 * cfg.n_layers + 1, "rotary": cfg.n_layers}
    assert (kn.LAUNCHES["norm"], kr.LAUNCHES["rotary"]) == \
        (per["norm"], per["rotary"])

    def tick(params, cache, token, active):
        return T.serve_decode_step(params, cfg, cache, token, active), cache
    step = GraphedCallable(tick, donate=True)
    cache = T.cache_init(cfg, 16, 512, cuda)
    token = torch.zeros((16,), dtype=torch.int32, device=cuda)
    active = torch.ones((16,), dtype=torch.bool, device=cuda)
    kn.reset_launches()
    kr.reset_launches()
    with torch.no_grad():
        for _ in range(4):          # eager, capture and replay, replays
            token, cache = step(params, cache, token, active)
    torch.cuda.synchronize()
    assert step.graphs() == 1
    assert (kn.LAUNCHES["norm"], kr.LAUNCHES["rotary"]) == \
        (4 * per["norm"], 4 * per["rotary"])
    assert L.EAGER_ON_CARD == eager
    assert cache["pos"].tolist() == [4] * 16


@pytest.mark.cuda
def test_a_train_step_on_the_card_takes_the_eager_expressions(cuda):
    from repro_torch.launch import steps as ST
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("stablelm-1.6b").smoke(), vocab=512)
    model = build_model(cfg)
    params = model.init(torch.Generator(cuda).manual_seed(0), cuda)
    launches = (kn.LAUNCHES["norm"], kr.LAUNCHES["rotary"])
    eager = dict(L.EAGER_ON_CARD)
    tok = torch.randint(0, cfg.vocab, (2, 32), device=cuda)
    (loss, _), grads = ST.value_and_grad(ST.train_loss_fn(model, False),
                                         params, {"tokens": tok})
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    leaves = [g for g in torch.utils._pytree.tree_leaves(grads)]
    assert all(torch.isfinite(g).all() for g in leaves)
    assert any(g.abs().sum() > 0 for g in leaves)
    assert (kn.LAUNCHES["norm"], kr.LAUNCHES["rotary"]) == launches
    assert L.EAGER_ON_CARD["norm"] >= eager["norm"] + 2 * cfg.n_layers + 1
    assert L.EAGER_ON_CARD["rotary"] >= eager["rotary"] + cfg.n_layers
