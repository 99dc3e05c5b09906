"""The port's wire codecs (``repro_torch.core.compression``) against the JAX
package's (``repro.core.compression``), on the CPU.

The same numpy-seeded frames go through both.  Payloads are compared
bitwise, field by field (quant8: int8 tiles and scales; sparse: values,
indices and count), together with the static framing (dtype tag, shape,
2-d view, dense shape), the meta of the wire and decoded buffers, the wire
bytes, ``codec_stats()`` and ``sparse_dropped``.  The per-frame, stacked
and batch layers are each held to the reference, and the cases of
``tests/test_compression_roundtrip.py`` are ported with their own checks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import StreamBuffer as JBuf
from repro.core import compression as jcomp
from repro_torch.core import compression as comp
from repro_torch.core.buffers import (Quant8Payload, SparsePayload,
                                      StreamBuffer)

torch.set_num_threads(2)

ODD_SHAPES = [(1,), (7,), (129,), (3, 5), (13, 7), (3, 5, 2), (2, 3, 4, 5),
              ()]


# ---------------------------------------------------------------------------
# helpers: one numpy frame into both packages, and bitwise comparison
# ---------------------------------------------------------------------------

def _ramp(shape):
    n = int(np.prod(shape)) if shape else 1
    return ((np.arange(n, dtype=np.float32).reshape(shape) - n / 2)
            / max(n, 1)).astype(np.float32)


def _noise(seed, shape, density=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 4.0)).astype(
        np.float32)
    if density < 1.0:
        x[rng.random(shape) >= density] = 0.0
    return x


def _pair(*arrays, meta=None):
    """(port buffer, JAX buffer) holding the same frames."""
    meta = dict(meta or {})
    tb = StreamBuffer(tensors=tuple(torch.as_tensor(a) for a in arrays),
                      pts=3, meta=dict(meta))
    jb = JBuf(tensors=tuple(jnp.asarray(a) for a in arrays),
              pts=jnp.int32(3), meta=dict(meta))
    return tb, jb


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a)


def _same(got, want, what):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, \
        (what, g.shape, g.dtype, w.shape, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _same_payload(got, want, what=""):
    if isinstance(got, Quant8Payload):
        assert type(want).__name__ == "Quant8Payload", what
        _same(got.q, want.q, f"{what} q")
        _same(got.scale, want.scale, f"{what} scale")
        assert (got.dtype, tuple(got.shape), tuple(got.view2d)) == \
            (want.dtype, tuple(want.shape), tuple(want.view2d)), what
        assert got.wire_nbytes == want.wire_nbytes, what
    elif isinstance(got, SparsePayload):
        assert type(want).__name__ == "SparsePayload", what
        _same(got.values, want.values, f"{what} values")
        _same(got.indices, want.indices, f"{what} indices")
        _same(got.nnz, want.nnz, f"{what} nnz")
        assert tuple(got.dense_shape) == tuple(want.dense_shape), what
        assert got.wire_nbytes == want.wire_nbytes, what
    else:
        _same(got, want, what)


def _same_buffer(got, want, what=""):
    assert len(got.tensors) == len(want.tensors), what
    for k, (g, w) in enumerate(zip(got.tensors, want.tensors)):
        _same_payload(g, w, f"{what} tensor {k}")
    assert got.meta == want.meta, (what, got.meta, want.meta)


def _reset():
    comp.reset_codec_stats()
    jcomp.reset_codec_stats()


def _same_stats():
    assert comp.codec_stats() == jcomp.codec_stats()


# ---------------------------------------------------------------------------
# per-frame encode / decode against the reference
# ---------------------------------------------------------------------------

CASES = ([(codec, shape) for codec in ("quant8", "sparse")
          for shape in ODD_SHAPES + [(70, 300), (2, 600)]]
         + [(codec, shape) for codec in ("sparse:0.05", "sparse:0.5",
                                         "sparse:1.0")
            for shape in [(129,), (2, 600)]])


@pytest.mark.parametrize("codec,shape", CASES, ids=str)
def test_encode_decode_match_the_reference(codec, shape):
    _reset()
    x = _noise(len(shape), shape, density=0.3) if shape else np.float32(0.5)
    tb, jb = _pair(np.asarray(x, np.float32), meta={"client_id": 2})
    tenc, tn = comp.encode(tb, codec)
    jenc, jn = jcomp.encode(jb, codec)
    _same_buffer(tenc, jenc, "wire")
    assert tn == jn == comp.wire_nbytes(tenc)
    _same_stats()
    tdec, jdec = comp.decode(tenc, codec), jcomp.decode(jenc, codec)
    _same_buffer(tdec, jdec, "decoded")


def test_multi_tensor_bf16_and_zero_tiles_match_the_reference():
    _reset()
    a = _noise(1, (40, 130))
    a[:32, :128] = 0.0                                   # an all-zero tile
    b = _noise(2, (3, 700), density=0.2)
    for codec in ("quant8", "sparse:0.1"):
        tb, jb = _pair(a, b)
        tb = tb.with_(tensors=(tb.tensors[0].to(torch.bfloat16),
                               tb.tensors[1]))
        jb = jb.with_(tensors=(jb.tensors[0].astype(jnp.bfloat16),
                               jb.tensors[1]))
        tenc, tn = comp.encode(tb, codec)
        jenc, jn = jcomp.encode(jb, codec)
        assert tn == jn
        for k, (g, w) in enumerate(zip(tenc.tensors, jenc.tensors)):
            if isinstance(g, SparsePayload) and g.values.dtype == \
                    torch.bfloat16:
                _same(g.values.view(torch.int16),
                      np.asarray(w.values).view(np.int16), "bf16 values")
                _same(g.indices, w.indices, "indices")
                _same(g.nnz, w.nnz, "nnz")
            else:
                _same_payload(g, w, f"tensor {k}")
        assert tenc.meta == jenc.meta
        _same_stats()
        tdec, jdec = comp.decode(tenc, codec), jcomp.decode(jenc, codec)
        assert tdec.tensors[0].dtype == torch.bfloat16
        _same(tdec.tensors[0].view(torch.int16),
              np.asarray(jdec.tensors[0]).view(np.int16), "bf16 decoded")
        _same(tdec.tensors[1], jdec.tensors[1], "f32 decoded")


@pytest.mark.parametrize("codec", ["none", "quant8", "sparse:0.25"])
def test_none_is_a_strict_noop_and_meta_matches(codec):
    tb, jb = _pair(_ramp((3, 5)), meta={"client_id": 7, "topic": "cam/a"})
    tenc, tn = comp.encode(tb, codec)
    jenc, jn = jcomp.encode(jb, codec)
    assert tn == jn and tenc.meta == jenc.meta
    if codec == "none":
        assert tenc is tb and comp.decode(tenc, "none") is tenc
    assert comp.decode(tenc, codec).meta == {"client_id": 7,
                                             "topic": "cam/a"}


# ---------------------------------------------------------------------------
# stacked and batch layers against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["quant8", "sparse:0.25", "sparse:0.02"])
@pytest.mark.parametrize("fshape", [(13, 7), (2, 600), (129,)], ids=str)
def test_stacked_layer_matches_the_reference(codec, fshape):
    x = np.stack([_noise(k, fshape, density=0.3) for k in range(3)])
    tb, jb = _pair(x)
    twire, tdrop = comp.encode_stacked(tb, codec)
    jwire, jdrop = jcomp.encode_stacked(jb, codec)
    _same_buffer(twire, jwire, "stacked wire")
    if jdrop is None:
        assert tdrop is None
    else:
        _same(tdrop, jdrop, "dropped [tensors, frames]")
    _same_buffer(comp.decode_stacked(twire, codec),
                 jcomp.decode_stacked(jwire, codec), "stacked decoded")


@pytest.mark.parametrize("codec", ["quant8", "sparse:0.25", "sparse:0.02"])
def test_batch_layer_matches_the_reference_and_the_per_frame_calls(codec):
    _reset()
    pairs = [_pair(_noise(k, (2, 600), density=0.3), _noise(k + 9, (13, 7)),
                   meta={"client_id": k}) for k in range(4)]
    tout = comp.encode_batch([t for t, _ in pairs], codec)
    jout = jcomp.encode_batch([j for _, j in pairs], codec)
    assert len(tout) == len(jout) == 4
    for (tenc, tn), (jenc, jn) in zip(tout, jout):
        _same_buffer(tenc, jenc, "batch wire")
        assert tn == jn
    _same_stats()
    batch_stats = comp.codec_stats()
    # element i is the per-frame encode, meta and stats included
    _reset()
    for (tb, _), (tenc, tn) in zip(pairs, tout):
        enc, n = comp.encode(tb, codec)
        _same_buffer(enc, tenc, "per-frame == batch")
        assert n == tn
    assert comp.codec_stats() == batch_stats
    tdec = comp.decode_batch([e for e, _ in tout], codec)
    jdec = jcomp.decode_batch([e for e, _ in jout], codec)
    for g, w in zip(tdec, jdec):
        _same_buffer(g, w, "batch decoded")
        assert "codec" not in g.meta and "sparse_dropped" not in g.meta


def test_batch_of_nothing_and_of_none():
    assert comp.encode_batch([], "quant8") == []
    assert comp.decode_batch([], "quant8") == []
    tb, _ = _pair(_ramp((3,)))
    assert comp.encode_batch([tb], "none") == [(tb, 12)]
    assert comp.decode_batch([tb], "none") == [tb]


# ---------------------------------------------------------------------------
# the cases of test_compression_roundtrip.py, on the port
# ---------------------------------------------------------------------------

def _buf(shape):
    return _pair(_ramp(shape))[0]


class TestQuant8:
    @pytest.mark.parametrize("shape", ODD_SHAPES)
    def test_roundtrip_any_rank(self, shape):
        buf = _buf(shape)
        enc, _ = comp.encode(buf, "quant8")
        out = comp.decode(enc, "quant8").tensors[0]
        assert tuple(out.shape) == tuple(shape)
        assert out.dtype == buf.tensors[0].dtype
        scale = float(buf.tensors[0].abs().max()) / 127 + 1e-8
        np.testing.assert_allclose(out.numpy(), buf.tensors[0].numpy(),
                                   atol=scale)

    @pytest.mark.parametrize("shape", ODD_SHAPES)
    def test_wire_bytes_match_decoded_payload(self, shape):
        buf = _buf(shape)
        enc, nbytes = comp.encode(buf, "quant8")
        dec = comp.decode(enc, "quant8")
        logical = sum(t.numel() for t in dec.tensors)
        scales = sum(e.scale.numel() for e in enc.tensors)
        assert nbytes == logical + 4 * scales
        assert sum(e.q.numel() for e in enc.tensors) >= logical

    def test_multi_tensor_buffer(self):
        buf = StreamBuffer(tensors=(torch.ones(3, 5), torch.zeros(7)))
        dec = comp.decode(comp.encode(buf, "quant8")[0], "quant8")
        assert len(dec.tensors) == 2
        assert tuple(dec.tensors[0].shape) == (3, 5)
        assert tuple(dec.tensors[1].shape) == (7,)

    def test_dtype_is_the_ports_own_tag(self):
        """One tag everywhere, so equal frames never split into two wire
        groups."""
        enc, _ = comp.encode(_buf((3, 5)), "quant8")
        assert enc.tensors[0].dtype == "float32"
        stacked, _ = comp.encode_stacked(_buf((2, 3, 5)), "quant8")
        assert stacked.tensors[0].dtype == "float32"


class TestSparse:
    @pytest.mark.parametrize("shape", [(7,), (129,), (3, 5), (13, 7),
                                       (3, 5, 2)])
    def test_roundtrip_any_rank(self, shape):
        n = int(np.prod(shape))
        x = np.zeros(n, np.float32)
        nz = np.arange(0, n, 10)
        x[nz] = np.arange(1, len(nz) + 1, dtype=np.float32)
        buf = _pair(x.reshape(shape))[0]
        dec = comp.decode(comp.encode(buf, "sparse")[0], "sparse")
        assert tuple(dec.tensors[0].shape) == tuple(shape)
        np.testing.assert_array_equal(dec.tensors[0].numpy(),
                                      x.reshape(shape))

    @pytest.mark.parametrize("shape", [(7,), (13, 7), (3, 5, 2)])
    def test_wire_bytes_match_coo_framing(self, shape):
        enc, nbytes = comp.encode(_buf(shape), "sparse")
        total = sum(sp.values.numel() * sp.values.element_size()
                    + sp.indices.numel() * 4 + 4 for sp in enc.tensors)
        assert nbytes == total
        assert tuple(comp.decode(enc, "sparse").tensors[0].shape) == shape

    def test_density_parameter_bounds_capacity(self):
        _, wide = comp.encode(_buf((40,)), "sparse:0.5")
        _, narrow = comp.encode(_buf((40,)), "sparse:0.1")
        assert narrow < wide

    def test_roundtrip_via_query_meta_codec(self):
        enc, _ = comp.encode(_buf((13, 7)), "quant8")
        assert enc.meta["codec"] == "quant8"
        dec = comp.decode(enc, enc.meta["codec"])
        assert tuple(dec.tensors[0].shape) == (13, 7)


class TestDecodeStripsWireMeta:
    @pytest.mark.parametrize("codec", ["quant8", "sparse"])
    def test_decoded_frame_never_claims_a_codec(self, codec):
        enc, _ = comp.encode(_buf((13, 7)), codec)
        assert enc.meta["codec"] == codec
        dec = comp.decode(enc, codec)
        assert "codec" not in dec.meta and "sparse_dropped" not in dec.meta

    @pytest.mark.parametrize("codec", ["quant8", "sparse"])
    def test_meta_keyed_double_decode_is_identity(self, codec):
        enc, _ = comp.encode(_buf((13, 7)), codec)
        dec = comp.decode(enc, enc.meta.get("codec", "none"))
        dec2 = comp.decode(dec, dec.meta.get("codec", "none"))
        assert torch.equal(dec2.tensors[0], dec.tensors[0])

    def test_payload_meta_survives_decode(self):
        buf = _buf((3, 5)).with_(meta={"client_id": 7, "topic": "cam/a"})
        dec = comp.decode(comp.encode(buf, "quant8")[0], "quant8")
        assert dec.meta == {"client_id": 7, "topic": "cam/a"}


class TestSparseTruncationAccounting:
    def test_dense_tensor_at_density_0p05_reports_truncation(self):
        _reset()
        x = np.arange(1, 201, dtype=np.float32)
        tb, jb = _pair(x)
        enc, _ = comp.encode(tb, "sparse:0.05")
        jenc, _ = jcomp.encode(jb, "sparse:0.05")
        kept = int((comp.decode(enc, "sparse").tensors[0] != 0).sum())
        dropped = enc.meta["sparse_dropped"]
        assert dropped == jenc.meta["sparse_dropped"] > 0
        assert kept + dropped == 200
        assert comp.codec_stats() == jcomp.codec_stats() == {
            "sparse_truncated_tensors": 1, "sparse_dropped_values": dropped}

    def test_lossless_encode_stays_unmarked(self):
        _reset()
        x = np.zeros(200, np.float32)
        x[::25] = 1.0
        enc, _ = comp.encode(_pair(x)[0], "sparse")
        assert "sparse_dropped" not in enc.meta
        assert comp.codec_stats()["sparse_dropped_values"] == 0
        np.testing.assert_array_equal(
            comp.decode(enc, "sparse").tensors[0].numpy(), x)

    def test_multi_tensor_truncation_sums_across_tensors(self):
        _reset()
        dense = np.arange(1, 101, dtype=np.float32)
        enc, _ = comp.encode(_pair(dense, dense)[0], "sparse:0.05")
        jenc, _ = jcomp.encode(_pair(dense, dense)[1], "sparse:0.05")
        assert comp.codec_stats()["sparse_truncated_tensors"] == 2
        assert enc.meta["sparse_dropped"] == jenc.meta["sparse_dropped"] == \
            comp.codec_stats()["sparse_dropped_values"]
        _same_stats()

    def test_account_sparse_dropped_folds_host_counts(self):
        _reset()
        assert comp.account_sparse_dropped(np.array([0, 3, 0, 2])) == 5
        assert jcomp.account_sparse_dropped(np.array([0, 3, 0, 2])) == 5
        assert comp.account_sparse_dropped([0, 0]) == 0
        _same_stats()


class TestDensityCapAlignment:
    @pytest.mark.parametrize("n", [600, 513, 1023, 200])
    def test_full_density_is_lossless_any_size(self, n):
        _reset()
        x = np.arange(1, n + 1, dtype=np.float32)
        tb, jb = _pair(x)
        enc, _ = comp.encode(tb, "sparse:1.0")
        _same_buffer(enc, jcomp.encode(jb, "sparse:1.0")[0], "sparse:1.0")
        assert "sparse_dropped" not in enc.meta
        assert comp.codec_stats()["sparse_dropped_values"] == 0
        np.testing.assert_array_equal(
            comp.decode(enc, "sparse").tensors[0].numpy(), x)

    @pytest.mark.parametrize("size,density", [(600, 1.0), (600, 1.5),
                                              (513, 0.5), (700, 0.1),
                                              (1, 0.25), (200, 0.001)])
    def test_sparse_cap_matches_the_reference(self, size, density):
        assert comp._sparse_cap(size, density) == \
            jcomp._sparse_cap(size, density)

    def test_over_unity_density_clamps_to_lossless(self):
        x = np.arange(1, 601, dtype=np.float32)
        enc, _ = comp.encode(_pair(x)[0], "sparse:1.5")
        assert "sparse_dropped" not in enc.meta
        np.testing.assert_array_equal(
            comp.decode(enc, "sparse").tensors[0].numpy(), x)

    def test_non_multiple_size_partial_density_roundtrips(self):
        x = np.zeros(700, np.float32)
        x[::10] = np.arange(1, 71, dtype=np.float32)
        enc, _ = comp.encode(_pair(x)[0], "sparse:0.5")
        assert "sparse_dropped" not in enc.meta
        np.testing.assert_array_equal(
            comp.decode(enc, "sparse").tensors[0].numpy(), x)

    def test_partial_density_truncation_still_accounted(self):
        _reset()
        x = np.arange(1, 601, dtype=np.float32)
        enc, _ = comp.encode(_pair(x)[0], "sparse:0.05")
        kept = int((comp.decode(enc, "sparse").tensors[0] != 0).sum())
        assert enc.meta["sparse_dropped"] == 600 - kept > 0


def test_unknown_codec_rejected():
    for fn in (comp.encode, comp.decode, comp.encode_stacked,
               comp.decode_stacked):
        with pytest.raises(ValueError, match="unknown codec"):
            fn(_buf((3,)), "gzip")
