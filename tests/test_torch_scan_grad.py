"""The backward passes of the port's two scans, and the grad guard of the
kernels that have none, against the JAX package on the CPU.

* S1 (``rglru_scan``): the plain backward (``ref.rglru_scan_bwd_plain``,
  an explicit reverse loop) against autograd through the plain forward
  loop (atol = rtol = 1e-6: the same products, summed by autograd in an
  order of its own) and against ``jax.vjp`` of the reference's
  ``associative_scan`` (atol = rtol = 1e-5, the forward's tolerance: a
  tree's association order against a loop's); the autograd Function
  carries a ``grad_fn`` and its CPU backward is the plain one, bitwise.
* S2 (``ssd_state_scan``): the plain backward against autograd through
  the plain loop (1e-6) and ``jax.vjp`` of the reference's ``lax.scan``
  (1e-5), with h0 given and absent and a ``None`` gradient for h_final or
  h_starts; the whole ``_ssd_scan`` differentiated by autograd against
  ``jax.grad`` of the reference's at S = 40 and 64 with chunk 16 (nc = 3
  with padding, and 4): every input's gradient within 1e-4 relative to
  its largest element (f32, long einsum sums in other orders); at a
  128-token chunk the reference's gradients are NaN (0 * inf through its
  ``where(causal, exp(seg), 0)``) and the port's finite, the loss equal.
* The grad guard: ``jax.grad`` through the reference's ``flash_attention``
  fails, and the port's K5 raises under grad on the CPU as on the card;
  ``build.refuse_grad`` raises only in grad mode on an input that requires
  grad.
* On the card (``cuda`` marker): each backward kernel against its plain
  version, S1 bitwise (ragged widths, S at one ring stage - 1, one stage,
  one stage + 1), S2's d_states and d_h0 bitwise and d_decay within 1e-5
  of the sum of the absolute products; a row alone == the same row in a
  batch of 3, bitwise; the outputs carry a ``grad_fn``; every other
  kernel raises under grad.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_130m as jax_mamba
from repro.kernels.flash_attn import flash_attention as jax_flash
from repro.models import build_model as jax_build
from repro.models import ssm as jax_ssm
from repro_torch.configs import mamba2_130m
from repro_torch.core.buffers import tree_flatten
from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import rglru_scan as s1
from repro_torch.kernels import ssd_scan as s2
from repro_torch.launch import steps as ST
from repro_torch.models import build_model, ssm
from repro_torch.models import transformer as tt

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA GPU and nvcc (a CUDA "
                    "kernel has no interpret mode)")
    return torch.device("cuda")


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _rglru_inputs(b, s, w, seed):
    a = np.random.default_rng(seed).uniform(0.5, 0.999, (b, s, w)).astype(
        np.float32)
    return a, _x((b, s, w), seed + 1), _x((b, s, w), seed + 2)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# S1: the RG-LRU scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,w", [(1, 1, 3), (2, 17, 5), (2, 64, 33),
                                   (1, 130, 8)])
def test_rglru_plain_backward_is_autograd_of_the_plain_loop(b, s, w):
    a, bx, gh = map(torch.as_tensor, _rglru_inputs(b, s, w, s))
    a.requires_grad_(True)
    bx.requires_grad_(True)
    h = ref.rglru_scan_plain(a, bx)
    want_a, want_bx = torch.autograd.grad(h, (a, bx), gh)
    d_a, d_bx = ref.rglru_scan_bwd_plain(a.detach(), h.detach(), gh)
    _close(d_a, want_a, 1e-6)
    _close(d_bx, want_bx, 1e-6)


@pytest.mark.parametrize("s", [16, 200])
def test_rglru_plain_backward_matches_jax_associative_scan(s):
    a, bx, gh = _rglru_inputs(2, s, 24, 3 + s)

    def scan(a, bx):
        def combine(c1, c2):
            return c1[0] * c2[0], c2[0] * c1[1] + c2[1]
        return jax.lax.associative_scan(combine, (a, bx), axis=1)[1]

    h, vjp = jax.vjp(scan, jnp.asarray(a), jnp.asarray(bx))
    want_a, want_bx = vjp(jnp.asarray(gh))
    d_a, d_bx = ref.rglru_scan_bwd_plain(
        torch.as_tensor(a), ref.rglru_scan_plain(torch.as_tensor(a),
                                                 torch.as_tensor(bx)),
        torch.as_tensor(gh))
    _close(d_a, want_a, 1e-5)
    _close(d_bx, want_bx, 1e-5)


def test_rglru_scan_is_differentiable_on_the_cpu():
    a, bx, gh = map(torch.as_tensor, _rglru_inputs(2, 40, 16, 9))
    a.requires_grad_(True)
    bx.requires_grad_(True)
    before = dict(s1.LAUNCHES)
    h = s1.rglru_scan(a, bx)
    assert h.grad_fn is not None
    assert torch.equal(h.detach(), ref.rglru_scan_plain(a.detach(),
                                                        bx.detach()))
    h.backward(gh)
    d_a, d_bx = ref.rglru_scan_bwd_plain(a.detach(), h.detach(), gh)
    assert torch.equal(a.grad, d_a) and torch.equal(bx.grad, d_bx)
    assert s1.LAUNCHES == before                # the CPU runs no kernel


def test_rglru_scan_checks_its_inputs():
    a = torch.zeros((1, 4, 3))
    with pytest.raises(ValueError):
        s1.rglru_scan(a, a[:, :2])
    with pytest.raises(TypeError):
        s1.rglru_scan(a.double(), a.double())
    with pytest.raises(ValueError):
        s1.rglru_scan_bwd(a, a, a[:, :1])


# ---------------------------------------------------------------------------
# S2: the SSD inter-chunk state recurrence
# ---------------------------------------------------------------------------

def _ssd_inputs(b, nc, h, n, hd, seed):
    rng = np.random.default_rng(seed)
    decay = rng.uniform(0.2, 1.0, (b, nc, h)).astype(np.float32)
    return (decay, _x((b, nc, h, n, hd), seed + 1),
            _x((b, h, n, hd), seed + 2), _x((b, nc, h, n, hd), seed + 3),
            _x((b, h, n, hd), seed + 4))


@pytest.mark.parametrize("nc", [1, 4])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("grads", ["both", "starts", "final"])
def test_ssd_plain_backward_is_autograd_of_the_plain_loop(nc, with_h0, grads):
    decay, states, h0, g_s, g_f = map(torch.as_tensor,
                                      _ssd_inputs(2, nc, 3, 4, 5, nc))
    ins = [decay, states] + ([h0] if with_h0 else [])
    for t in ins:
        t.requires_grad_(True)
    hs, hf = ref.ssd_state_scan_plain(decay, states,
                                      h0 if with_h0 else None)
    g_s = None if grads == "final" else g_s
    g_f = None if grads == "starts" else g_f
    outs = [(o, g) for o, g in ((hs, g_s), (hf, g_f))
            if g is not None and o.requires_grad]  # nc = 1: hs is h0 or 0
    want = torch.autograd.grad([o for o, _ in outs], ins,
                               [g for _, g in outs], allow_unused=True,
                               materialize_grads=True)
    got = ref.ssd_state_scan_bwd_plain(decay.detach(), hs.detach(), g_s, g_f,
                                       with_h0)
    assert (got[2] is None) == (not with_h0)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_plain_backward_matches_jax_lax_scan(with_h0):
    decay, states, h0, g_s, g_f = _ssd_inputs(2, 6, 3, 8, 4, 21)

    def scan(decay, states, h0):
        def step(hprev, inp):
            dec, s_new = inp
            return hprev * dec[:, :, None, None] + s_new, hprev
        hf, hs = jax.lax.scan(step, h0, (jnp.moveaxis(decay, 1, 0),
                                         jnp.moveaxis(states, 1, 0)))
        return jnp.moveaxis(hs, 0, 1), hf

    init = h0 if with_h0 else np.zeros_like(h0)
    _, vjp = jax.vjp(scan, *map(jnp.asarray, (decay, states, init)))
    want = vjp((jnp.asarray(g_s), jnp.asarray(g_f)))
    hs, _ = ref.ssd_state_scan_plain(
        torch.as_tensor(decay), torch.as_tensor(states),
        torch.as_tensor(h0) if with_h0 else None)
    got = ref.ssd_state_scan_bwd_plain(torch.as_tensor(decay), hs,
                                       torch.as_tensor(g_s),
                                       torch.as_tensor(g_f), with_h0)
    _close(got[0], want[0], 1e-5)
    _close(got[1], want[1], 1e-5)
    if with_h0:
        _close(got[2], want[2], 1e-5)


def test_ssd_state_scan_is_differentiable_on_the_cpu():
    decay, states, h0, g_s, _ = map(torch.as_tensor,
                                    _ssd_inputs(2, 3, 2, 4, 4, 5))
    for t in (decay, states, h0):
        t.requires_grad_(True)
    before = dict(s2.LAUNCHES)
    hs, hf = s2.ssd_state_scan(decay, states, h0)
    assert hs.grad_fn is not None and hf.grad_fn is not None
    hs.backward(g_s)                            # h_final's gradient is None
    want = ref.ssd_state_scan_bwd_plain(decay.detach(), hs.detach(), g_s,
                                        None, True)
    for t, w in zip((decay, states, h0), want):
        assert torch.equal(t.grad, w)
    assert s2.LAUNCHES == before


@pytest.fixture(scope="module")
def block():
    jcfg = jax_mamba.config().smoke()
    tcfg = mamba2_130m.config().smoke()
    jp = jax_ssm.ssm_init(jax.random.PRNGKey(0), jcfg)
    tp = tt.params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("s", [40, 64])
def test_ssd_scan_gradients_match_jax(block, s):
    """Every input of ``_ssd_scan`` (xh, B, C, dt, h0 and the block's
    A_log and D) through S2's backward, against ``jax.grad``."""
    jcfg, jp, tcfg, tp = block
    assert tcfg.ssm_chunk == 16 < s             # more than one chunk
    d_inner, h, hd, n = ssm._dims(tcfg)
    xh, B, C = _x((2, s, h, hd), s), _x((2, s, n), s + 1), \
        _x((2, s, n), s + 2)
    dt = np.log1p(np.exp(_x((2, s, h), s + 3)))
    h0 = _x((2, h, n, hd), s + 4)
    wy, wh = _x((2, s, h, hd), s + 5), _x((2, h, n, hd), s + 6)
    pk = {"A_log": np.asarray(jp["A_log"]) + 0.3, "D": np.array(jp["D"])}

    def jloss(ins, pk):
        y, hf, _ = jax_ssm._ssd_scan(jcfg, pk, *ins)
        return jnp.sum(y * wy) + jnp.sum(hf * wh)

    jins = tuple(map(jnp.asarray, (xh, B, C, dt, h0)))
    jg_ins, jg_p = jax.grad(jloss, argnums=(0, 1))(
        jins, {k: jnp.asarray(v) for k, v in pk.items()})
    tins = [torch.as_tensor(v).requires_grad_(True)
            for v in (xh, B, C, dt, h0)]
    tpk = {k: torch.as_tensor(v).requires_grad_(True) for k, v in pk.items()}
    y, hf = ssm._ssd_scan(tcfg, tpk, *tins)
    (torch.sum(y * torch.as_tensor(wy)) +
     torch.sum(hf * torch.as_tensor(wh))).backward()
    got = [t.grad for t in tins] + [tpk[k].grad for k in sorted(pk)]
    want = list(jg_ins) + [jg_p[k] for k in sorted(pk)]
    for name, g, w in zip(("xh", "B", "C", "dt", "h0", "A_log", "D"),
                          got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_ssd_gradients_are_finite_where_the_references_are_nan(block):
    """At a 128-token chunk the masked entries of exp(seg) overflow: the
    JAX package's where(causal, exp(seg), 0) turns them into NaN
    gradients (12 of the smoke model's 16 leaves); the port exponentiates
    the causal entries only, with the same forward values."""
    jcfg = dataclasses.replace(block[0], ssm_chunk=128)
    tcfg = dataclasses.replace(block[2], ssm_chunk=128)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tt.params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 256))
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(tokens, jnp.int32)}),
        has_aux=True)(jp)
    assert any(bool(jnp.isnan(g).any())
               for g in jax.tree_util.tree_leaves(jg))
    (tl, _), tg = ST.value_and_grad(
        tm.loss, tp, {"tokens": torch.as_tensor(tokens, dtype=torch.int32)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for g in tree_flatten(tg)[0]:
        assert bool(torch.isfinite(g).all())


# ---------------------------------------------------------------------------
# the grad guard
# ---------------------------------------------------------------------------

def test_the_reference_cannot_differentiate_flash_attention():
    q = jnp.asarray(_x((2, 16, 64), 1))
    with pytest.raises(Exception):
        jax.grad(lambda q: jnp.sum(jax_flash(q, q, q, bq=16, bk=16)))(q)


def test_flash_attention_raises_under_grad_on_the_cpu():
    q = torch.as_tensor(_x((2, 16, 64), 1))
    out = fa.flash_attention(q, q, q)             # no grad needed: runs
    assert out.grad_fn is None
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, q, q)
    with torch.no_grad():
        fa.flash_attention(q, q, q)


def test_refuse_grad_raises_only_for_a_gradient_it_cannot_pass():
    x = torch.zeros(3, requires_grad=True)
    build.refuse_grad("k", None, torch.zeros(2))
    with torch.no_grad():
        build.refuse_grad("k", x)
    with pytest.raises(RuntimeError, match="k: the kernel has no backward"):
        build.refuse_grad("k", torch.zeros(2), x)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", [(2, 37, 33), (1, 63, 31), (1, 64, 257),
                                   (2, 65, 64), (2, 200, 128),
                                   (1, 2048, 4096)])
def test_rglru_backward_kernel_is_bitwise_its_plain_loop(cuda, b, s, w):
    assert s1.ring()["positions"] == s1.STAGE_POSITIONS
    a, bx, gh = (torch.as_tensor(v, device=cuda)
                 for v in _rglru_inputs(b, s, w, s + w))
    h = s1.rglru_scan(a, bx)
    before = s1.LAUNCHES["rglru_scan_bwd"]
    got = s1.rglru_scan_bwd(a, h, gh)
    assert s1.LAUNCHES["rglru_scan_bwd"] == before + 1
    want = ref.rglru_scan_bwd_plain(a, h, gh)
    for g, wt in zip(got, want):
        assert torch.equal(_bits(g), _bits(wt))


@pytest.mark.cuda
def test_rglru_backward_rows_are_batch_invariant(cuda):
    a, bx, gh = (torch.as_tensor(v, device=cuda)
                 for v in _rglru_inputs(3, 300, 96, 4))
    h = s1.rglru_scan(a, bx)
    batch = s1.rglru_scan_bwd(a, h, gh)
    alone = s1.rglru_scan_bwd(a[1:2].contiguous(), h[1:2].contiguous(),
                              gh[1:2].contiguous())
    for x, y in zip(alone, batch):
        assert torch.equal(_bits(x), _bits(y[1:2]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 24, 128, 64), (2, 3, 5, 7, 5),
                                   (2, 16, 24, 128, 64), (3, 5, 4, 16, 16)])
@pytest.mark.parametrize("grads", ["both", "starts"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_backward_kernel_matches_its_plain_loop(cuda, shape, grads,
                                                    with_h0):
    decay, states, _, g_s, g_f = (torch.as_tensor(v, device=cuda)
                                  for v in _ssd_inputs(*shape, 31))
    hs, _ = s2.ssd_state_scan(decay, states)
    g_f = g_f if grads == "both" else None
    got = s2.ssd_state_scan_bwd(decay, hs, g_s, g_f, with_h0)
    want = ref.ssd_state_scan_bwd_plain(decay, hs, g_s, g_f, with_h0)
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    if with_h0:
        assert torch.equal(_bits(got[2]), _bits(want[2]))
    else:
        assert got[2] is None
    scale = ref.ssd_state_scan_bwd_plain(
        decay.abs(), hs.abs(), g_s.abs(),
        None if g_f is None else g_f.abs(), False)[0]
    assert bool(((got[0] - want[0]).abs() <= 1e-5 * scale + 1e-30).all())


@pytest.mark.cuda
def test_ssd_backward_rows_are_batch_invariant(cuda):
    decay, states, _, g_s, g_f = (torch.as_tensor(v, device=cuda)
                                  for v in _ssd_inputs(3, 4, 6, 32, 64, 8))
    hs, _ = s2.ssd_state_scan(decay, states)
    batch = s2.ssd_state_scan_bwd(decay, hs, g_s, g_f, True)
    alone = s2.ssd_state_scan_bwd(*(t[1:2].contiguous()
                                    for t in (decay, hs, g_s, g_f)), True)
    for x, y in zip(alone, batch):
        assert torch.equal(_bits(x), _bits(y[1:2]))


@pytest.mark.cuda
def test_scan_outputs_carry_a_grad_fn_on_the_card(cuda):
    a, bx, gh = (torch.as_tensor(v, device=cuda).requires_grad_(True)
                 for v in _rglru_inputs(2, 70, 40, 1))
    h = s1.rglru_scan(a, bx)
    assert h.grad_fn is not None
    h.backward(gh.detach())
    want = ref.rglru_scan_bwd_plain(a.detach(), h.detach(), gh.detach())
    assert torch.equal(a.grad, want[0]) and torch.equal(bx.grad, want[1])
    decay, states, h0, g_s, _ = (torch.as_tensor(v, device=cuda)
                                 for v in _ssd_inputs(2, 4, 3, 8, 8, 2))
    for t in (decay, states, h0):
        t.requires_grad_(True)
    hs, hf = s2.ssd_state_scan(decay, states, h0)
    assert hs.grad_fn is not None and hf.grad_fn is not None
    hs.backward(g_s)
    want = ref.ssd_state_scan_bwd_plain(decay.detach(), hs.detach(), g_s,
                                        None, True)
    assert torch.equal(states.grad, want[1]) and torch.equal(h0.grad,
                                                             want[2])


@pytest.mark.cuda
def test_kernels_without_a_backward_raise_under_grad_on_the_card(cuda):
    from repro_torch.kernels import quant8, sparse_dec, sparse_enc
    from repro_torch.kernels import ssd_decode
    x = torch.randn((32, 128), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        quant8.quantize8(x)
    q, sc = quant8.quantize8(x.detach())
    with pytest.raises(RuntimeError, match="no backward"):
        quant8.dequantize8(q, sc.requires_grad_(True))
    flat = torch.randn(1024, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        sparse_enc.sparse_enc(flat, kb=8)
    v, i, _ = sparse_enc.sparse_enc(flat.detach(), kb=8)
    with pytest.raises(RuntimeError, match="no backward"):
        sparse_dec.sparse_dec(v.view(2, 8).requires_grad_(True),
                              i.view(2, 8))
    qd = torch.randn((4, 64), device=cuda, requires_grad=True)
    kc = torch.randn((1, 16, 4, 64), device=cuda)
    pos = torch.tensor([7], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_decode(qd, kc, kc, pos)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(qd[None], kc[0].permute(1, 0, 2)[:1],
                           kc[0].permute(1, 0, 2)[:1])
    hh = torch.randn((1, 2, 8, 16), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_decode.ssd_decode_step(
            hh, torch.rand((1, 2), device=cuda), -torch.rand(2, device=cuda),
            torch.randn((1, 8), device=cuda),
            torch.randn((1, 8), device=cuda),
            torch.randn((1, 32), device=cuda), torch.randn(2, device=cuda))
