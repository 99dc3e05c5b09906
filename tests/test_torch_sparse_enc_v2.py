"""K3's counts and frame-local indices (the sparse encode's ``totals`` and
``frame_blocks``), and the codec accounting built on them, against the JAX
package on the CPU.

On the CPU the K3 wrapper runs its plain version (``ref.sparse_enc_plain``),
which computes exactly what the CUDA kernel does; the JAX side runs
``sparse_enc_xla`` and ``repro.kernels.ops`` in Pallas interpret mode
(``impl="pallas"``) and through its XLA statements (``impl="xla"``).  The
JAX package has no ``totals`` output: the count it is held to is the one its
codec takes, ``sum(|x| > threshold)`` per block or frame.  Inputs are
numpy-seeded frames with ragged lengths (padding), blocks over capacity and
under it, all-zero blocks and ``-0.0`` entries; every comparison is bitwise.
The tests marked ``cuda`` hold the kernel to its plain version on the card
and skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import StreamBuffer as JBuf
from repro.core import compression as jcomp
from repro.kernels import ops as jops
from repro.kernels.sparse_enc import sparse_enc_xla
from repro_torch.core import compression as comp
from repro_torch.core.buffers import StreamBuffer
from repro_torch.kernels import ops, ref, sparse_enc

torch.set_num_threads(2)

IMPLS = ["pallas", "xla"]
B = ref.SPARSE_B
N = 4 * B + 200           # a ragged frame: 5 blocks, the last one padded


def _frame(seed, n=N, over=True):
    """One frame of blocks of different kinds: block 1 all zero, block 2
    sparse, ``-0.0`` among the zeros; with ``over`` block 0 is dense (~360
    nonzeros, over any capacity below that) and the rest at density 0.25,
    else every other block is at density 0.1 (~51 a block)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    density = np.full(n, 0.25 if over else 0.1)
    density[:B] = 0.7 if over else 0.1
    density[B:2 * B] = 0.0
    density[2 * B:3 * B] = 0.05
    x[rng.random(n) >= density] = 0.0
    neg = (x == 0.0) & (rng.random(n) < 0.5)
    x[neg] = -0.0
    return x


def _frames(b, seed=0):
    """b frames, the odd ones under capacity everywhere."""
    return np.stack([_frame(seed + k, over=k % 2 == 0) for k in range(b)])


def _jnp(x, bf16):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if bf16 else a


def _torch(x, bf16):
    t = torch.as_tensor(x)
    return t.to(torch.bfloat16) if bf16 else t


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
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


def _jax_count(x, thr, axis=None):
    """The reference's count of kept elements: |x| > thr, in f32."""
    return jnp.sum(jnp.abs(x.astype(jnp.float32)) > thr,
                   axis=axis).astype(jnp.int32)


def test_frames_have_every_kind_of_block():
    x = _frames(3)
    blocks = np.pad(x, ((0, 0), (0, 5 * B - N))).reshape(3, 5, B)
    nnz = (blocks != 0).sum(-1)
    assert (nnz[0::2, 0] > 300).all() and (nnz[1, :] < 72).all()
    assert (nnz[:, 1] == 0).all()
    assert np.signbit(x[x == 0]).any() and not np.signbit(x[x == 0]).all()


# ---------------------------------------------------------------------------
# the plain version's new outputs against sparse_enc_xla and jops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("thr", [0.0, 0.5])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kb", [8, 160, 512])
def test_plain_totals_match_the_reference_count(kb, bf16, thr):
    x = np.pad(_frame(1), (0, 5 * B - N))
    v, i, c = sparse_enc_xla(_jnp(x, bf16), kb=kb, threshold=thr)
    tv, ti, tc, tt = ref.sparse_enc_plain(_torch(x, bf16), kb, thr,
                                          totals=True)
    assert_bitwise(tv, v)
    assert_bitwise(ti, i)
    assert_bitwise(tc, c)
    assert_bitwise(tt, _jax_count(_jnp(x, bf16).reshape(5, B), thr, axis=1))
    assert (tt >= tc).all() and (tc == tt.clamp_max(kb)).all()
    # the default result is the old 3-tuple, bitwise the same
    for g, w in zip(ref.sparse_enc_plain(_torch(x, bf16), kb, thr),
                    (tv, ti, tc)):
        assert_bitwise(g, w)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("thr", [0.0, 0.5])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 3])
def test_plain_frame_blocks_give_the_stacked_local_indices(b, bf16, thr,
                                                           impl):
    x = _frames(b, seed=b)
    cap = 800                                   # kb = 160
    nb, kb = ref._sparse_dims(N, cap)
    v, i, nnz = jops.sparse_enc_stacked(_jnp(x, bf16), cap, thr, impl=impl)
    flat = torch.nn.functional.pad(_torch(x, bf16), (0, nb * B - N))
    tv, ti, tc, tt = ref.sparse_enc_plain(flat.reshape(-1), kb, thr,
                                          frame_blocks=nb, totals=True)
    assert_bitwise(tv.reshape(b, nb * kb), v)
    assert_bitwise(ti.reshape(b, nb * kb), i)
    assert_bitwise(tc.reshape(b, nb).sum(1, dtype=torch.int32), nnz)
    assert_bitwise(tt.reshape(b, nb).sum(1, dtype=torch.int32),
                   _jax_count(_jnp(x, bf16), thr, axis=1))
    assert int(ti.max()) < nb * B


# ---------------------------------------------------------------------------
# kernels.ops with the total against repro.kernels.ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("thr", [0.0, 0.5])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("over", [True, False], ids=["over", "under"])
def test_ops_sparse_enc_with_total(over, bf16, thr, impl):
    x = _frame(7, over=over)
    v, i, nnz = jops.sparse_enc(_jnp(x, bf16), 800, thr, impl=impl)
    got = ops.sparse_enc(_torch(x, bf16), 800, thr, with_total=True)
    assert len(got) == 4
    for g, w in zip(got, (v, i, nnz, _jax_count(_jnp(x, bf16), thr))):
        assert_bitwise(g, w)
    assert (int(got[3]) > int(got[2])) == over
    for g, w in zip(ops.sparse_enc(_torch(x, bf16), 800, thr), got[:3]):
        assert_bitwise(g, w)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("thr", [0.0, 0.5])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 3])
def test_ops_sparse_enc_stacked_with_total(b, bf16, thr, impl):
    x = _frames(b, seed=10 + b)
    v, i, nnz = jops.sparse_enc_stacked(_jnp(x, bf16), 800, thr, impl=impl)
    got = ops.sparse_enc_stacked(_torch(x, bf16), 800, thr, with_total=True)
    want = (v, i, nnz, _jax_count(_jnp(x, bf16), thr, axis=1))
    for g, w in zip(got, want):
        assert_bitwise(g, w)
    for g, w in zip(ops.sparse_enc_stacked(_torch(x, bf16), 800, thr),
                    got[:3]):
        assert_bitwise(g, w)
    for k in range(b):                  # frame k == the per-frame call
        fk = ops.sparse_enc(_torch(x[k], bf16), 800, thr, with_total=True)
        for g, w in zip(fk, (got[0][k], got[1][k], got[2][k], got[3][k])):
            assert_bitwise(g, w)


# ---------------------------------------------------------------------------
# the codec's truncation accounting against repro.core.compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", [0.05, 0.15, 1.0])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_dropped_per_frame_and_stacked_match_the_reference(bf16, density):
    x = _frames(3, seed=20)
    for k in range(3):
        tp, td = comp._sparse_enc(_torch(x[k], bf16), density)
        jp, jd = jcomp._sparse_enc(_jnp(x[k], bf16), density)
        assert_bitwise(td, jd)
        assert_bitwise(tp.nnz, jp.nnz)
        assert_bitwise(tp.indices, jp.indices)
    tp, td = comp._sparse_enc_stacked(_torch(x, bf16), density)
    jp, jd = jcomp._sparse_enc_stacked(_jnp(x, bf16), density)
    assert_bitwise(td, jd)
    assert_bitwise(tp.values, jp.values)
    assert_bitwise(tp.indices, jp.indices)
    assert_bitwise(tp.nnz, jp.nnz)
    if density == 1.0:
        assert int(td.max()) == 0
    else:
        assert int(td[0]) > 0
    if density == 0.15:                 # kb = 72: frame 1 fits
        assert int(td[1]) == 0


@pytest.mark.parametrize("codec", ["sparse:0.05", "sparse:0.15"])
def test_encode_batch_sparse_dropped_matches_the_reference(codec):
    comp.reset_codec_stats()
    jcomp.reset_codec_stats()
    x = _frames(4, seed=30)
    tb = [StreamBuffer(tensors=(torch.as_tensor(f), torch.as_tensor(-f[:700])),
                       meta={"client_id": k}) for k, f in enumerate(x)]
    jb = [JBuf(tensors=(jnp.asarray(f), jnp.asarray(-f[:700])),
               meta={"client_id": k}) for k, f in enumerate(x)]
    tout = comp.encode_batch(tb, codec)
    jout = jcomp.encode_batch(jb, codec)
    for (te, tn), (je, jn) in zip(tout, jout):
        assert te.meta == je.meta and tn == jn
        for tp, jp in zip(te.tensors, je.tensors):
            assert_bitwise(tp.values, jp.values)
            assert_bitwise(tp.indices, jp.indices)
            assert_bitwise(tp.nnz, jp.nnz)
    assert comp.codec_stats() == jcomp.codec_stats()
    assert comp.codec_stats()["sparse_dropped_values"] > 0
    assert "sparse_dropped" in tout[0][0].meta


# ---------------------------------------------------------------------------
# the wrapper's options on the CPU
# ---------------------------------------------------------------------------

def test_wrapper_results_and_checks():
    sparse_enc.reset_launches()
    x = torch.as_tensor(np.pad(_frames(2), ((0, 0), (0, 5 * B - N))))
    flat = x.reshape(-1)
    assert len(sparse_enc.sparse_enc(flat, kb=80)) == 3
    v, i, c, t = sparse_enc.sparse_enc(flat, kb=80, frame_blocks=5,
                                       totals=True)
    g = sparse_enc.sparse_enc(flat, kb=80)
    off = (torch.arange(2, dtype=torch.int32) * 5 * B)[:, None]
    assert torch.equal(i.reshape(2, -1), g[1].reshape(2, -1) - off)
    assert torch.equal(v, g[0]) and torch.equal(c, g[2])
    assert torch.equal(t, (flat.abs() > 0).reshape(10, B).sum(
        1, dtype=torch.int32))
    with pytest.raises(ValueError, match="frame_blocks"):
        sparse_enc.sparse_enc(flat, kb=80, frame_blocks=3)
    assert sparse_enc.LAUNCHES == {"sparse_enc": 0}
    assert sparse_enc.ENC_ROUTE_LAUNCHES == {"vec16": 0, "scalar": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_enc_route_follows_alignment(dtype):
    buf = torch.zeros(4 * B + 16, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    assert sparse_enc.enc_route(buf[:4 * B]) == "vec16"
    assert sparse_enc.enc_route(buf[1:1 + 4 * B]) == "scalar"
    step = 16 // buf.element_size()
    assert sparse_enc.enc_route(buf[step:step + 4 * B]) == "vec16"


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version, bitwise
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA GPU and nvcc (a CUDA "
                    "kernel has no interpret mode)")
    return torch.device("cuda")


def _card_input(dev, bf16, frames=4):
    x = np.pad(_frames(frames, seed=40), ((0, 0), (0, 5 * B - N)))
    return _torch(x.reshape(-1), bf16).to(dev)


def _same_on_card(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu().view(torch.uint8),
                           w.cpu().view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kb", [1, 8, 80, 512])
def test_k3_matches_plain_on_the_card(cuda, kb, bf16):
    x = _card_input(cuda, bf16)
    nb = x.numel() // B
    for thr in (0.0, 0.5):
        got = sparse_enc.sparse_enc(x, kb=kb, threshold=thr, totals=True)
        _same_on_card(got, ref.sparse_enc_plain(x, kb, thr, totals=True))
        want_tot = (x.float().abs() > thr).reshape(nb, B).sum(
            1, dtype=torch.int32)
        assert torch.equal(got[3], want_tot)
        _same_on_card(sparse_enc.sparse_enc(x, kb=kb, threshold=thr),
                      got[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_k3_misaligned_view_takes_the_scalar_route(cuda, bf16):
    buf = _card_input(cuda, bf16)           # 4 frames of 5 blocks
    view = buf[1:1 + 15 * B]                # 3 frames, misaligned
    assert sparse_enc.enc_route(view) == "scalar"
    sparse_enc.reset_launches()
    for kb in (8, 80):
        got = sparse_enc.sparse_enc(view, kb=kb, threshold=0.5,
                                    frame_blocks=5, totals=True)
        _same_on_card(got, ref.sparse_enc_plain(view, kb, 0.5,
                                                frame_blocks=5, totals=True))
    assert sparse_enc.ENC_ROUTE_LAUNCHES == {"vec16": 0, "scalar": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_k3_frame_blocks_are_the_rebased_global_indices(cuda, bf16):
    x = _card_input(cuda, bf16)
    nb = x.numel() // B
    frames, fb = 4, nb // 4
    glob = sparse_enc.sparse_enc(x, kb=80)
    local = sparse_enc.sparse_enc(x, kb=80, frame_blocks=fb)
    off = (torch.arange(frames, dtype=torch.int32, device=cuda)
           * (fb * B))[:, None]
    assert torch.equal(local[1].reshape(frames, -1),
                       glob[1].reshape(frames, -1) - off)
    _same_on_card(local, ref.sparse_enc_plain(x, 80, frame_blocks=fb))
    _same_on_card((local[0], local[2]), (glob[0], glob[2]))
