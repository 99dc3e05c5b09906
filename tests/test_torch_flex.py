"""``FlexHeader``, ``flex_wrap`` and ``flex_unwrap`` of the port against the
JAX package's (``tests/test_formats.py``'s flexible cases), on the CPU:
the padded payload and every header field bitwise, the round trip, the
capacity check, and the header as a tree node of ``StreamBuffer.headers``
(flatten, structure key, stacking)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import flex_unwrap as jflex_unwrap
from repro.core import flex_wrap as jflex_wrap
from repro_torch.core import (FlexHeader, StreamBuffer, flex_unwrap,
                              flex_wrap, stack_buffers, structure_key,
                              unstack_buffers)
from repro_torch.core.buffers import tree_flatten, tree_unflatten

torch.set_num_threads(2)


@given(st.integers(1, 6), st.integers(1, 6))
@settings(max_examples=20, deadline=None)
def test_roundtrip_matches_jax(h, w):
    x = np.arange(h * w, dtype=np.float32).reshape(h, w)
    payload, hdr = flex_wrap(torch.as_tensor(x), capacity=64)
    jpayload, jhdr = jflex_wrap(jnp.asarray(x), capacity=64)
    assert tuple(payload.shape) == (64,)
    assert int(hdr.valid) == h * w
    np.testing.assert_array_equal(payload.numpy(), np.asarray(jpayload))
    for f in ("dims", "dtype_tag", "valid"):
        a, b = getattr(hdr, f).numpy(), np.asarray(getattr(jhdr, f))
        assert a.dtype == b.dtype == np.int32, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    y = flex_unwrap(payload, hdr, static_shape=(h, w))
    np.testing.assert_array_equal(y.numpy(), x)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jflex_unwrap(jpayload, jhdr,
                                           static_shape=(h, w))))
    assert flex_unwrap(payload, hdr) is payload


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8,
                                   torch.bfloat16])
def test_header_records_shape_and_dtype(dtype):
    from repro_torch.core.formats import tag_to_dtype
    x = torch.ones((2, 3, 4), dtype=dtype)
    payload, hdr = flex_wrap(x, capacity=30)
    assert payload.dtype == dtype
    assert hdr.dims.tolist() == [2, 3, 4, 1]
    assert tag_to_dtype(int(hdr.dtype_tag)) == dtype
    assert torch.equal(payload[24:], torch.zeros(6, dtype=dtype))


def test_capacity_overflow():
    with pytest.raises(ValueError):
        flex_wrap(torch.zeros(100), capacity=10)
    with pytest.raises(ValueError):
        jflex_wrap(jnp.zeros((100,)), capacity=10)


def test_headers_are_tree_nodes_of_a_buffer():
    frames = []
    for n in (3, 5):
        payload, hdr = flex_wrap(torch.arange(float(n)), capacity=8)
        frames.append(StreamBuffer(tensors=(payload,), headers=(hdr,)))
    leaves, td = tree_flatten(frames[0])
    assert len(leaves) == 5          # payload, pts, dims, dtype_tag, valid
    back = tree_unflatten(td, leaves)
    assert isinstance(back.headers[0], FlexHeader)
    assert structure_key(frames[0]) == structure_key(frames[1])
    stacked = stack_buffers(frames)
    assert tuple(stacked.headers[0].dims.shape) == (2, 4)
    assert stacked.headers[0].valid.tolist() == [3, 5]
    for f, g in zip(unstack_buffers(stacked), frames):
        assert int(f.headers[0].valid) == int(g.headers[0].valid)
        assert torch.equal(f.tensors[0], g.tensors[0])
