"""The port's Mamba-2 SSD block and its two kernels against the JAX package
on the CPU.

Weights come from the JAX package (``ssm_init(PRNGKey(0), cfg)`` at
mamba2-130m's smoke config: d_model 256, 8 heads of 64, state 32, chunk
16) and cross through the port's weight bridge; inputs are numpy-seeded.
Each piece runs in both packages in fp32:

* ``_causal_conv`` with and without carried state: atol 1e-6 (four
  products summed in the same order);
* ``_ssd_scan`` (y and the final state) at S = 1, 16, 17 and 40 with chunk
  16 (shorter than a chunk, an exact multiple, one over, a padded third
  chunk), with and without h0: atol = rtol = 1e-5 (unit-scale inputs
  reach |y| ~ 10, and sums over a chunk's positions and the state run in
  other orders, so the bound scales with the value); ``ssm_prefill``
  (output and decode cache) and a 16-step ``ssm_decode`` chain: atol 1e-5
  (two frameworks, the same f32 arithmetic in other kernels and
  summation orders);
* the plain S2 loop against ``jax.lax.scan`` over the same chunk states:
  atol 1e-6 (the same steps in the same order; XLA may fuse the multiply
  and add);
* a decode step given ``active`` leaves inactive rows' state bitwise as it
  was and computes active rows bitwise as a full step does;
* on the card (``cuda`` marker): S2 bitwise its plain version (both
  multiply then add in chunk order), S3 within atol = rtol = 2e-5 of its
  plain version (its sum over the state runs in another order, and its exp
  is CUDA's), a row alone bitwise the same row in a batch of 8, strided
  bf16 views of ``xbc`` taken and a view with another element stride
  refused, and one S2 launch per SSD layer per prefill, one S3 launch per
  SSD layer per decode step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_130m as jax_mamba
from repro.models import ssm as jax_ssm
from repro_torch.configs import mamba2_130m
from repro_torch.kernels import ssd_decode as dec_mod
from repro_torch.kernels import ssd_scan as scan_mod
from repro_torch.models import ssm
from repro_torch.models import transformer as tt

torch.set_num_threads(2)

ATOL = 1e-5
FP32_TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA GPU and nvcc (a CUDA "
                    "kernel has no interpret mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def block():
    jcfg = jax_mamba.config().smoke()
    tcfg = mamba2_130m.config().smoke()
    jp = jax_ssm.ssm_init(jax.random.PRNGKey(0), jcfg)
    tp = tt.params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_smoke_config_is_the_chunk_the_edge_cases_assume(block):
    jcfg, _, tcfg, _ = block
    assert tcfg.ssm_chunk == jcfg.ssm_chunk == 16
    assert ssm._dims(tcfg) == jax_ssm._dims(jcfg) == (512, 8, 64, 32)


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_matches_jax(block, with_prev):
    _, jp, _, tp = block
    c = tp["conv"].shape[1]
    xbc = _x((2, 9, c), 1)
    prev = _x((2, 3, c), 2) if with_prev else None
    jy, jst = jax_ssm._causal_conv(jnp.asarray(xbc), jp["conv"],
                                   None if prev is None else
                                   jnp.asarray(prev))
    ty, tst = ssm._causal_conv(torch.as_tensor(xbc), tp["conv"],
                               None if prev is None else
                               torch.as_tensor(prev))
    _close(ty, jy, 1e-6)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def _scan_inputs(cfg, s, seed, b=2):
    d_inner, h, hd, n = ssm._dims(cfg)
    xh = _x((b, s, h, hd), seed)
    B = _x((b, s, n), seed + 1)
    C = _x((b, s, n), seed + 2)
    # softplus'd dt in (0, ~2): real decays, not all near 1
    dt = np.log1p(np.exp(_x((b, s, h), seed + 3)))
    return xh, B, C, dt


@pytest.mark.parametrize("s", [1, 16, 17, 40])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_matches_jax(block, s, with_h0):
    jcfg, jp, tcfg, tp = block
    xh, B, C, dt = _scan_inputs(tcfg, s, 10 + s)
    d_inner, h, hd, n = ssm._dims(tcfg)
    h0 = _x((2, h, n, hd), 7) if with_h0 else None
    jy, jh, _ = jax_ssm._ssd_scan(jcfg, jp, *map(jnp.asarray, (xh, B, C, dt)),
                                  None if h0 is None else jnp.asarray(h0))
    before = scan_mod.LAUNCHES["ssd_state_scan"]
    ty, th = ssm._ssd_scan(tcfg, tp, *map(torch.as_tensor, (xh, B, C, dt)),
                           None if h0 is None else torch.as_tensor(h0))
    assert scan_mod.LAUNCHES["ssd_state_scan"] == before   # CPU: plain
    assert tuple(ty.shape) == (2, s, h, hd) and ty.dtype == torch.float32
    _close(ty, jy, rtol=ATOL)
    _close(th, jh, rtol=ATOL)
    assert np.abs(np.asarray(jh)).max() > 0.5       # not a trivial state


def test_padding_chunk_leaves_the_prefix_exact(block):
    """S = 17 pads to two chunks of 16 with zero dt: its first 16 outputs
    are bitwise S = 16's, and its final state is one more exact step."""
    _, _, tcfg, tp = block
    xh, B, C, dt = map(torch.as_tensor, _scan_inputs(tcfg, 17, 30))
    y17, h17 = ssm._ssd_scan(tcfg, tp, xh, B, C, dt)
    y16, h16 = ssm._ssd_scan(tcfg, tp, xh[:, :16], B[:, :16], C[:, :16],
                             dt[:, :16])
    assert torch.equal(y17[:, :16], y16)
    y1, h1 = ssm._ssd_scan(tcfg, tp, xh[:, 16:], B[:, 16:], C[:, 16:],
                           dt[:, 16:], h16)
    torch.testing.assert_close(y17[:, 16:], y1, rtol=ATOL, atol=ATOL)
    torch.testing.assert_close(h17, h1, rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("s", [1, 16, 17, 40])
def test_ssm_prefill_matches_jax(block, s):
    jcfg, jp, tcfg, tp = block
    x = _x((2, s, tcfg.d_model), 40 + s)
    jy, jc = jax_ssm.ssm_prefill(jp, jcfg, jnp.asarray(x))
    ty, tc = ssm.ssm_prefill(tp, tcfg, torch.as_tensor(x))
    _close(ty, jy)
    _close(tc["h"], jc["h"])
    _close(tc["conv"], jc["conv"])
    assert tc["h"].dtype == torch.float32 and tc["h"].is_contiguous()
    _close(ssm.ssm_train(tp, tcfg, torch.as_tensor(x)),
           jax_ssm.ssm_train(jp, jcfg, jnp.asarray(x)))


def test_sixteen_step_decode_chain_matches_jax(block):
    jcfg, jp, tcfg, tp = block
    x = _x((2, 5, tcfg.d_model), 60)
    _, jc = jax_ssm.ssm_prefill(jp, jcfg, jnp.asarray(x))
    _, tc = ssm.ssm_prefill(tp, tcfg, torch.as_tensor(x))
    before = dec_mod.LAUNCHES["ssd_decode"]
    for t in range(16):
        xt = _x((2, 1, tcfg.d_model), 61 + t)
        jy, jc = jax_ssm.ssm_decode(jp, jcfg, jnp.asarray(xt), jc)
        ty = ssm.ssm_decode(tp, tcfg, torch.as_tensor(xt), tc)
        _close(ty, jy)
        _close(tc["h"], jc["h"])
        _close(tc["conv"], jc["conv"])
    assert dec_mod.LAUNCHES["ssd_decode"] == before
    assert np.abs(np.asarray(jc["h"])).max() > 0.05    # a live state


def test_cache_init_matches_jax(block):
    jcfg, _, tcfg, _ = block
    jc = jax_ssm.ssm_cache_init(jcfg, 3)
    tc = ssm.ssm_cache_init(tcfg, 3, "cpu")
    for k in ("h", "conv"):
        assert tuple(tc[k].shape) == jc[k].shape
        assert str(tc[k].dtype).endswith(str(jc[k].dtype))


def test_decode_leaves_inactive_rows_untouched(block):
    _, _, tcfg, tp = block
    x = torch.as_tensor(_x((3, 4, tcfg.d_model), 80))
    xt = torch.as_tensor(_x((3, 1, tcfg.d_model), 81))
    _, c1 = ssm.ssm_prefill(tp, tcfg, x)
    _, c2 = ssm.ssm_prefill(tp, tcfg, x)
    h0, conv0 = c2["h"].clone(), c2["conv"].clone()
    y_all = ssm.ssm_decode(tp, tcfg, xt, c1)
    active = torch.tensor([True, False, True])
    y_some = ssm.ssm_decode(tp, tcfg, xt, c2, active)
    assert torch.equal(c2["h"][1], h0[1]) and torch.equal(c2["conv"][1],
                                                          conv0[1])
    for r in (0, 2):
        assert torch.equal(c2["h"][r], c1["h"][r])
        assert torch.equal(c2["conv"][r], c1["conv"][r])
        assert torch.equal(y_some[r], y_all[r])


def _lax_scan(decay, states, h0):
    def fn(hprev, inp):
        d, s = inp
        return hprev * d[:, :, None, None] + s, hprev
    h_final, h_starts = jax.lax.scan(
        fn, jnp.asarray(h0), (jnp.moveaxis(jnp.asarray(decay), 1, 0),
                              jnp.moveaxis(jnp.asarray(states), 1, 0)))
    return np.moveaxis(np.asarray(h_starts), 0, 1), np.asarray(h_final)


def _state_inputs(rng, b, nc, h, n, hd):
    decay = rng.uniform(0.2, 1.0, (b, nc, h)).astype(np.float32)
    states = rng.standard_normal((b, nc, h, n, hd)).astype(np.float32)
    return decay, states


@pytest.mark.parametrize("nc", [1, 3, 16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_state_scan_matches_lax_scan(nc, with_h0):
    rng = np.random.default_rng(nc)
    decay, states = _state_inputs(rng, 2, nc, 3, 8, 16)
    h0 = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    want_starts, want_final = _lax_scan(decay, states,
                                        h0 if with_h0 else 0 * h0)
    starts, final = scan_mod.ssd_state_scan(
        torch.as_tensor(decay), torch.as_tensor(states),
        torch.as_tensor(h0) if with_h0 else None)
    _close(starts, want_starts, 1e-6)
    _close(final, want_final, 1e-6)
    # h_starts[0] is h0 itself, and the recurrence holds step by step
    np.testing.assert_array_equal(starts[:, 0].numpy(),
                                  h0 if with_h0 else 0 * h0)
    chain = torch.cat([starts, final[:, None]], dim=1)
    np.testing.assert_array_equal(
        chain[:, 1:].numpy(),
        (chain[:, :-1] * torch.as_tensor(decay)[..., None, None] +
         torch.as_tensor(states)).numpy())


def test_state_scan_wrapper_checks_its_inputs():
    d, s = torch.zeros((1, 2, 3)), torch.zeros((1, 2, 3, 4, 5))
    with pytest.raises(ValueError):
        scan_mod.ssd_state_scan(d[:, :1], s)
    with pytest.raises(ValueError):
        scan_mod.ssd_state_scan(d, s, torch.zeros((1, 3, 4, 4)))
    with pytest.raises(TypeError):
        scan_mod.ssd_state_scan(d.double(), s.double())
    from elsewhere import Elsewhere     # neither cpu, cuda nor meta
    with pytest.raises(ValueError):
        scan_mod.ssd_state_scan(Elsewhere(1, 2, 3), Elsewhere(1, 2, 3, 4, 5))


def _decode_inputs(rng, b, h, n, hd, dtype=torch.float32, device="cpu"):
    """The S3 arguments as the decode step passes them: B, C and x column
    slices of one xbc row [b, h*hd + 2n]."""
    xbc = torch.as_tensor(rng.standard_normal((b, h * hd + 2 * n)).astype(
        np.float32)).to(device=device, dtype=dtype)
    d_inner = h * hd
    args = dict(
        h=torch.as_tensor(rng.standard_normal((b, h, n, hd)).astype(
            np.float32), device=device),
        dt=torch.as_tensor(rng.uniform(0.01, 2.0, (b, h)).astype(np.float32),
                           device=device),
        A=torch.as_tensor(-rng.uniform(0.5, 2.0, h).astype(np.float32),
                          device=device),
        B=xbc[:, d_inner:d_inner + n], C=xbc[:, d_inner + n:],
        x=xbc[:, :d_inner],
        D=torch.as_tensor(rng.standard_normal(h).astype(np.float32),
                          device=device))
    return args


def test_decode_step_wrapper_checks_its_inputs():
    a = _decode_inputs(np.random.default_rng(0), 2, 3, 8, 16)
    with pytest.raises(ValueError):
        dec_mod.ssd_decode_step(**{**a, "dt": a["dt"][:1]})
    with pytest.raises(TypeError):
        dec_mod.ssd_decode_step(**{**a, "B": a["B"].double()})
    with pytest.raises(TypeError):
        dec_mod.ssd_decode_step(**a, active=torch.ones(2, dtype=torch.int32))
    from elsewhere import Elsewhere     # neither cpu, cuda nor meta
    with pytest.raises(ValueError):
        dec_mod.ssd_decode_step(**{k: Elsewhere(*v.shape, dtype=v.dtype)
                                   for k, v in a.items()})
    hnew, y = dec_mod.ssd_decode_step(**a)     # CPU: plain, strided views
    assert tuple(hnew.shape) == (2, 3, 8, 16) and tuple(y.shape) == (2, 3, 16)
    assert hnew.data_ptr() != a["h"].data_ptr()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

#: (B, nc, H, N, hd): nc = 1, a ragged N * hd (4-byte route), mamba2-130m's
#: 2048-token prompt
_S2_SHAPES = [(1, 1, 24, 128, 64), (2, 3, 5, 7, 5), (3, 2, 8, 32, 64),
              (1, 16, 24, 128, 64), (2, 17, 4, 16, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _S2_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_state_scan_kernel_matches_plain_on_card(cuda, shape, with_h0):
    b, nc, h, n, hd = shape
    rng = np.random.default_rng(sum(shape))
    decay, states = (torch.as_tensor(a, device=cuda)
                     for a in _state_inputs(rng, b, nc, h, n, hd))
    h0 = torch.as_tensor(rng.standard_normal((b, h, n, hd)).astype(
        np.float32), device=cuda) if with_h0 else None
    before = scan_mod.LAUNCHES["ssd_state_scan"]
    starts, final = scan_mod.ssd_state_scan(decay, states, h0)
    torch.cuda.synchronize()
    assert scan_mod.LAUNCHES["ssd_state_scan"] == before + 1
    ps, pf = scan_mod.ssd_state_scan_plain(decay, states, h0)
    assert torch.equal(starts, ps) and torch.equal(final, pf)
    with pytest.raises(ValueError):
        scan_mod.ssd_state_scan(decay, states.transpose(3, 4))


@pytest.mark.cuda
def test_state_scan_rows_are_batch_invariant_on_card(cuda):
    rng = np.random.default_rng(5)
    decay, states = (torch.as_tensor(a, device=cuda)
                     for a in _state_inputs(rng, 3, 16, 24, 128, 64))
    batch = scan_mod.ssd_state_scan(decay, states)
    alone = scan_mod.ssd_state_scan(decay[1:2].contiguous(),
                                    states[1:2].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(batch[0][1:2], alone[0])
    assert torch.equal(batch[1][1:2], alone[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,hd", [(8, 24, 128, 64), (3, 8, 32, 64),
                                      (2, 4, 16, 16), (1, 2, 5, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_on_card(cuda, b, h, n, hd, dtype):
    rng = np.random.default_rng(b * h + n)
    a = _decode_inputs(rng, b, h, n, hd, dtype, cuda)
    active = torch.as_tensor(rng.uniform(size=b) < 0.7, device=cuda)
    for act in (None, active):
        before = dec_mod.LAUNCHES["ssd_decode"]
        hnew, y = dec_mod.ssd_decode_step(**a, active=act)
        torch.cuda.synchronize()
        assert dec_mod.LAUNCHES["ssd_decode"] == before + 1
        ph, py = dec_mod.ssd_decode_step_plain(**a, active=act)
        torch.testing.assert_close(hnew, ph, rtol=FP32_TOL, atol=FP32_TOL)
        torch.testing.assert_close(y, py, rtol=FP32_TOL, atol=FP32_TOL)
        if act is not None:
            assert torch.equal(hnew[~act], a["h"][~act])


@pytest.mark.cuda
def test_decode_rows_are_batch_invariant_on_card(cuda):
    """A row alone is bitwise the same row in a batch of 8 (each block sums
    its row in a fixed order)."""
    a = _decode_inputs(np.random.default_rng(9), 8, 24, 128, 64,
                       torch.bfloat16, cuda)
    hb, yb = dec_mod.ssd_decode_step(**a)
    one = {k: (v[3:4] if k not in ("A", "D") else v) for k, v in a.items()}
    h1, y1 = dec_mod.ssd_decode_step(**one)
    torch.cuda.synchronize()
    assert torch.equal(hb[3:4], h1) and torch.equal(yb[3:4], y1)


@pytest.mark.cuda
def test_decode_kernel_refuses_a_view_with_another_element_stride(cuda):
    a = _decode_inputs(np.random.default_rng(2), 2, 4, 16, 16,
                       torch.bfloat16, cuda)
    wide = torch.zeros((2, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        dec_mod.ssd_decode_step(**{**a, "B": wide[:, ::2]})


@pytest.mark.cuda
def test_ssm_block_launches_once_per_layer_on_card(cuda, block):
    jcfg, _, tcfg, tp = block
    gp = {k: v.to(cuda) for k, v in tp.items()}
    cfg = dataclasses.replace(tcfg, n_layers=2)
    x = torch.as_tensor(_x((2, 40, cfg.d_model), 90), device=cuda)
    scan_mod.reset_launches()
    dec_mod.reset_launches()
    y, cache = ssm.ssm_prefill(gp, cfg, x)
    yc, cc = ssm.ssm_prefill(tp, cfg, x.cpu())
    assert scan_mod.LAUNCHES["ssd_state_scan"] == 1
    torch.testing.assert_close(y.cpu(), yc, rtol=0, atol=ATOL)
    xt = torch.as_tensor(_x((2, 1, cfg.d_model), 91), device=cuda)
    yd = ssm.ssm_decode(gp, cfg, xt, cache)
    ydc = ssm.ssm_decode(tp, cfg, xt.cpu(), cc)
    assert dec_mod.LAUNCHES["ssd_decode"] == 1
    torch.testing.assert_close(yd.cpu(), ydc, rtol=0, atol=ATOL)
    torch.testing.assert_close(cache["h"].cpu(), cc["h"], rtol=0, atol=ATOL)
