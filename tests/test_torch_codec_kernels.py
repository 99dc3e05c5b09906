"""The wire-codec kernels K1–K4 of the port against the JAX package, on the
CPU.

Here the port's kernel wrappers run their plain PyTorch versions (the
tensors lie on the CPU); the JAX side runs ``repro.kernels.ops`` both in
Pallas interpret mode (``impl="pallas"``) and through its XLA statements
(``impl="xla"``), as the JAX package's own tests run them.  The same
numpy-seeded inputs go to both, and every comparison is bitwise (bf16
values compared as their 16-bit patterns).  The CUDA kernels run only on
the card: those tests carry the ``cuda`` marker and skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.quant8 import dequantize8_xla, quantize8_xla
from repro.kernels.sparse_dec import sparse_dec_xla
from repro.kernels.sparse_enc import sparse_enc_xla
from repro_torch.kernels import ops, quant8, ref, sparse_dec, sparse_enc

torch.set_num_threads(2)

IMPLS = ["pallas", "xla"]


def _bits(a):
    """numpy view for bitwise equality: bf16 as uint16, else as is."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.contiguous().view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_bitwise(got, want):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape and g.dtype == w.dtype, \
        (g.shape, g.dtype, w.shape, w.dtype)
    np.testing.assert_array_equal(g, w)


def _tie_tiles(seed, n_tiles):
    """f32 tiles whose x/scale lands exactly on k + 0.5 (rounding ties)."""
    rng = np.random.default_rng(seed)
    tiles = []
    for _ in range(n_tiles):
        amax = np.float32(rng.uniform(0.5, 4.0))
        s = np.float32(amax * np.float32(ref.INV_127))
        k = rng.integers(-126, 126, 32 * 128)
        x = ((k + 0.5).astype(np.float32) * s).astype(np.float32)
        x[0] = amax
        tiles.append(x.reshape(32, 128))
    return np.concatenate(tiles, 0)


def _frames(seed, shape, zero_tile=False):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape)
         * rng.uniform(0.1, 5.0, shape[:1] + (1,) * (len(shape) - 1))
         ).astype(np.float32)
    if zero_tile:
        x[..., :32, :128] = 0.0
    return x


def _sparse_input(seed, n, density=0.3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    x[rng.random(n) >= density] = 0.0
    return x


def _jnp(x, bf16=False):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if bf16 else a


def _torch(x, bf16=False):
    t = torch.as_tensor(x)
    return t.to(torch.bfloat16) if bf16 else t


# ---------------------------------------------------------------------------
# plain K1–K4 against the XLA statements of the kernels
# ---------------------------------------------------------------------------

def test_reciprocal_constant_is_f32_one_over_127():
    assert np.float32(ref.INV_127) == np.float32(1.0) / np.float32(127.0)
    assert float(np.float32(ref.INV_127)) == ref.INV_127


@pytest.mark.parametrize("case", ["random", "zero_tile", "ties"])
def test_plain_quantize8_matches_quantize8_xla(case):
    x = _tie_tiles(1, 4) if case == "ties" else \
        _frames(2, (64, 256), zero_tile=case == "zero_tile")
    q, s = quantize8_xla(jnp.asarray(x))
    tq, ts = ref.quantize8_plain(torch.as_tensor(x))
    assert_bitwise(tq, q)
    assert_bitwise(ts, s)
    assert_bitwise(ref.dequantize8_plain(tq, ts), dequantize8_xla(q, s))
    if case == "zero_tile":
        assert float(ts[0, 0]) == 1.0


def test_ties_really_are_ties():
    """The tie frames put ~half their elements exactly on k + 0.5, where
    rounding half to even and half away from zero part ways."""
    x = _tie_tiles(1, 2)
    tq, ts = ref.quantize8_plain(torch.as_tensor(x))
    r = torch.as_tensor(x).reshape(2, 32, 128) / ts.reshape(2, 1, 1)
    ties = (r - r.floor()) == 0.5
    assert ties.sum() > 1000
    away = (r.abs() + 0.5).floor() * r.sign()
    assert (away != tq.reshape(2, 32, 128).float())[ties].any()


@pytest.mark.parametrize("n,kb,thr,bf16", [
    (2048, 64, 0.0, False),      # under capacity
    (1024, 8, 0.0, False),       # over capacity: the first kb kept
    (1536, 128, 0.5, False),     # threshold
    (2048, 96, 0.0, True),       # bf16 values
    (512, 512, 0.0, False),      # full capacity
])
def test_plain_sparse_matches_sparse_xla(n, kb, thr, bf16):
    x = _sparse_input(n + kb, n)
    v, i, c = sparse_enc_xla(_jnp(x, bf16), kb=kb, threshold=thr)
    tv, ti, tc = ref.sparse_enc_plain(_torch(x, bf16), kb, thr)
    assert_bitwise(tv, v)
    assert_bitwise(ti, i)
    assert_bitwise(tc, c)
    nb = n // ref.SPARSE_B
    d = sparse_dec_xla(v.reshape(nb, kb), i.reshape(nb, kb))
    assert_bitwise(ref.sparse_dec_plain(tv.reshape(nb, kb),
                                        ti.reshape(nb, kb)), d)


# ---------------------------------------------------------------------------
# ops entry points against repro.kernels.ops, both JAX routes
# ---------------------------------------------------------------------------

Q8_SHAPES = [(3, 5), (70, 300), (2, 3, 4, 5), (), (129,), (33, 129)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", Q8_SHAPES, ids=str)
def test_quantize8_ops_bitwise(impl, shape):
    x = _frames(len(shape) + 7, shape) if shape else np.float32(1.75)
    q, s = jops.quantize8(jnp.asarray(x), impl=impl)
    tq, ts = ops.quantize8(torch.as_tensor(x))
    assert_bitwise(tq, q)
    assert_bitwise(ts, s)
    assert_bitwise(ops.dequantize8(tq, ts), jops.dequantize8(q, s, impl=impl))


@pytest.mark.parametrize("impl", IMPLS)
def test_quantize8_ops_zero_tiles_and_ties(impl):
    x = np.concatenate([_tie_tiles(3, 2), np.zeros((32, 128), np.float32)])
    q, s = jops.quantize8(jnp.asarray(x), impl=impl)
    tq, ts = ops.quantize8(torch.as_tensor(x))
    assert_bitwise(tq, q)
    assert_bitwise(ts, s)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", [(4, 3, 5), (3, 40, 130), (2, 7)], ids=str)
def test_quantize8_stacked_bitwise(impl, shape):
    x = _frames(11, shape, zero_tile=shape == (3, 40, 130))
    q, s = jops.quantize8_stacked(jnp.asarray(x), impl=impl)
    tq, ts = ops.quantize8_stacked(torch.as_tensor(x))
    assert_bitwise(tq, q)
    assert_bitwise(ts, s)
    assert_bitwise(ops.dequantize8_stacked(tq, ts),
                   jops.dequantize8_stacked(q, s, impl=impl))
    for i in range(shape[0]):           # frame i == the per-frame call
        fq, fs = ops.quantize8(torch.as_tensor(x[i]))
        assert torch.equal(tq[i], fq) and torch.equal(ts[i], fs)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n,cap,thr,bf16", [
    (1000, 100, 0.0, False),     # ragged: padded to 2 blocks
    (700, 350, 0.0, False),
    (1536, 24, 0.0, False),      # truncation
    (1200, 600, 0.7, False),     # threshold
    (1000, 250, 0.0, True),      # bf16 values
])
def test_sparse_ops_bitwise(impl, n, cap, thr, bf16):
    x = _sparse_input(n, n)
    v, i, nnz = jops.sparse_enc(_jnp(x, bf16), cap, thr, impl=impl)
    tv, ti, tn = ops.sparse_enc(_torch(x, bf16), cap, thr)
    assert_bitwise(tv, v)
    assert_bitwise(ti, i)
    assert_bitwise(tn, nnz)
    assert_bitwise(ops.sparse_dec(tv, ti, tn, n),
                   jops.sparse_dec(v, i, nnz, n, impl=impl))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("b,n,cap,bf16", [(3, 1000, 250, False),
                                          (2, 1024, 40, False),
                                          (4, 600, 600, True)])
def test_sparse_stacked_bitwise(impl, b, n, cap, bf16):
    x = np.stack([_sparse_input(k, n) for k in range(b)])
    v, i, nnz = jops.sparse_enc_stacked(_jnp(x, bf16), cap, 0.0, impl=impl)
    tv, ti, tn = ops.sparse_enc_stacked(_torch(x, bf16), cap, 0.0)
    assert_bitwise(tv, v)
    assert_bitwise(ti, i)
    assert_bitwise(tn, nnz)
    assert_bitwise(ops.sparse_dec_stacked(tv, ti, tn, n),
                   jops.sparse_dec_stacked(v, i, nnz, n, impl=impl))
    for k in range(b):                  # frame k == the per-frame call
        fv, fi, fn = ops.sparse_enc(_torch(x[k], bf16), cap, 0.0)
        assert torch.equal(tv[k], fv) and torch.equal(ti[k], fi)
        assert int(tn[k]) == int(fn)


def test_cpu_tensors_never_launch_a_kernel():
    for mod in (quant8, sparse_enc, sparse_dec):
        mod.reset_launches()
    x = torch.as_tensor(_frames(5, (40, 130)))
    q, s = ops.quantize8(x)
    ops.dequantize8(q, s)
    v, i, nnz = ops.sparse_enc(x.reshape(-1), 1000)
    ops.sparse_dec(v, i, nnz, x.numel())
    assert quant8.LAUNCHES == {"quantize8": 0, "dequantize8": 0}
    assert sparse_enc.LAUNCHES == {"sparse_enc": 0}
    assert sparse_dec.LAUNCHES == {"sparse_dec": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="M % 32"):
        quant8.quantize8(torch.zeros(30, 128))
    with pytest.raises(TypeError, match="float32"):
        quant8.quantize8(torch.zeros(32, 128, dtype=torch.float64))
    with pytest.raises(ValueError, match="kb"):
        sparse_enc.sparse_enc(torch.zeros(512), kb=513)
    with pytest.raises(ValueError, match="int32"):
        sparse_dec.sparse_dec(torch.zeros(1, 8), torch.zeros(1, 8))


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version, bitwise
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA GPU and nvcc (a CUDA "
                    "kernel has no interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_quant8_kernels_match_plain_on_the_card(cuda):
    for x in (_frames(1, (64, 256), zero_tile=True), _tie_tiles(2, 4)):
        xc = torch.as_tensor(x, device=cuda)
        q, s = quant8.quantize8(xc)
        pq, ps = ref.quantize8_plain(xc)
        assert torch.equal(q, pq) and torch.equal(s, ps)
        assert torch.equal(quant8.dequantize8(q, s),
                           ref.dequantize8_plain(q, s))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_sparse_kernels_match_plain_on_the_card(cuda, bf16):
    x = _torch(_sparse_input(4, 4096), bf16).to(cuda)
    for kb, thr in ((64, 0.0), (8, 0.0), (200, 0.5)):
        got = sparse_enc.sparse_enc(x, kb=kb, threshold=thr)
        want = ref.sparse_enc_plain(x, kb, thr)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu().view(torch.uint8),
                               w.cpu().view(torch.uint8))
        v2, i2 = got[0].reshape(8, kb), got[1].reshape(8, kb)
        assert torch.equal(sparse_dec.sparse_dec(v2, i2).cpu(),
                           ref.sparse_dec_plain(v2, i2).cpu())
