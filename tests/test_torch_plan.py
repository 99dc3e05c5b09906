"""The port's execution tiers against the JAX package's compiled plan, on
the CPU, over ``tests/test_plan.py``'s eight parity pipelines.

For each pipeline, three frames through the port's ``step_interpreted``
(the seed interpreter), ``step`` (the plan) and ``compiled_step`` (the
cached executable; here also through the stand-in graph of
``test_torch_graphs.py`` with donation on, as on the card) are bitwise the
JAX package's ``compiled_step`` (a jitted plan), frame by frame and in the
final state.  One exception, pinned by name: under ``jit`` XLA rewrites
``transform``'s division by the constant 127.5 into a multiplication by
its reciprocal, so there the JAX package's compiled step differs from its
own eager ``step`` by an ulp, and the port (which divides, on the card
too) is held bitwise to that eager step instead.  The models' weights
come from numpy and are shared by both packages.  ``compiled_step_n``
with ``hoist_queries`` (a query server burst) holds the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import StreamBuffer as JBuf
from repro.core import TensorSpec as JSpec
from repro.core import parse_launch as jparse
from repro.core import stack_buffers as jstack
from repro.core import unstack_buffers as junstack
from repro.core.elements import register_model as jregister
from repro_torch.core import (StreamBuffer, TensorSpec, parse_launch,
                              stack_buffers, unstack_buffers)
from repro_torch.core.buffers import tree_flatten
from repro_torch.core.elements import register_model
from test_torch_graphs import fake_graphs

torch.set_num_threads(2)

W_CLS = (0.1 * np.random.default_rng(3).standard_normal((3, 10))).astype(
    np.float32)
BOXES = np.array([[0.1, 0.1, 0.5, 0.6], [0.2, 0.3, 0.4, 0.5]], np.float32)
SCORES = np.array([0.9, 0.1], np.float32)


@pytest.fixture(scope="module", autouse=True)
def models():
    register_model("tp_cls", lambda g, dev: {"w": torch.as_tensor(
        W_CLS, device=dev)}, lambda p, x: x.reshape(-1, 3).mean(0) @ p["w"],
        out_specs=(TensorSpec((10,), "float32"),))
    jregister("tp_cls", lambda rng: {"w": jnp.asarray(W_CLS)},
              lambda p, x: jnp.mean(x.reshape(-1, 3), 0) @ p["w"],
              out_specs=(JSpec((10,), "float32"),))
    register_model("tp_det", None, lambda p, x: (
        torch.as_tensor(BOXES, device=x.device),
        torch.as_tensor(SCORES, device=x.device)),
        out_specs=(TensorSpec((2, 4), "float32"),
                   TensorSpec((2,), "float32")))
    jregister("tp_det", lambda rng: {}, lambda p, x: (
        jnp.asarray(BOXES), jnp.asarray(SCORES)),
        out_specs=(JSpec((2, 4), "float32"), JSpec((2,), "float32")))


PARITY_PIPELINES = {
    "listing1": """
        v4l2src name=cam ! tee name=ts
        ts. queue leaky=2 ! videoconvert ! mix.sink_1
        ts. videoconvert ! videoscale !
          video/x-raw,width=16,height=16,format=RGB !
          tensor_converter !
          tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 !
          tensor_filter model=tp_det !
          tensor_decoder mode=bounding_boxes option4=64:48 ! queue ! mix.sink_0
        compositor name=mix sink_0::zorder=2 sink_1::zorder=1 ! videoconvert !
          appsink name=display""",
    "tee_compositor": """
        testsrc name=s width=12 height=12 ! tee name=t
        t. queue ! videoconvert ! cmp.sink_0
        t. videoconvert ! videoscale ! video/x-raw,width=6,height=6,format=RGB !
          videoconvert ! cmp.sink_1
        compositor name=cmp sink_0::zorder=1 sink_1::zorder=2 sink_1::xpos=3 !
          appsink name=out""",
    "mux_forward_ref": """
        testsrc ! tensor_converter ! mux.sink_0
        testsrc ! tensor_converter ! mux.sink_1
        tensor_mux name=mux ! appsink name=o""",
    "demux": """
        testsrc ! tensor_converter ! mux.sink_0
        testsrc ! tensor_converter ! mux.sink_1
        tensor_mux name=mux ! tensor_demux name=d
        d.src_0 ! appsink name=a
        d.src_1 ! appsink name=b""",
    "transform": """
        testsrc width=8 height=8 ! tensor_converter !
        tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 !
        appsink name=o""",
    "filter_cls": """
        testsrc width=8 height=8 ! tensor_converter !
        tensor_transform mode=arithmetic option=typecast:float32 !
        tensor_filter model=tp_cls ! tensor_decoder mode=classification !
        appsink name=o""",
    "sparse_roundtrip": """
        testsrc width=8 height=8 ! tensor_converter !
        tensor_transform mode=arithmetic option=typecast:float32 !
        tensor_sparse_enc max_nnz=256 ! tensor_sparse_dec ! appsink name=o""",
    "tensor_if": """
        testsrc width=4 height=4 ! tensor_converter !
        tensor_transform mode=arithmetic option=typecast:float32,div:255.0 !
        tensor_if threshold=2.0 operator=GE ! appsink name=o""",
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_like_jax(ours, theirs, label):
    """A port tree equals a JAX tree: the same leaves in the same order
    (pts by value: the port keeps int64, the JAX package int32), every
    other leaf bitwise with its dtype."""
    la, _ = tree_flatten(ours)
    lb = jax.tree_util.tree_leaves(theirs)
    assert len(la) == len(lb), label
    for x, y in zip(la, lb):
        x, y = _np(x), np.asarray(y)
        assert x.shape == y.shape, label
        if x.dtype != y.dtype:      # pts
            assert x.dtype == np.int64 and y.dtype == np.int32, label
            x = x.astype(np.int32)
        np.testing.assert_array_equal(x, y, err_msg=label)


def _port_tiers(desc):
    """-> {tier: ([outputs per frame], final state)} over 3 frames."""
    pipe = parse_launch(desc).realize()
    params = pipe.init(torch.Generator().manual_seed(0), "cpu")
    tiers = {}
    for tier, fn in (("interpreted", pipe.step_interpreted),
                     ("plan", pipe.step),
                     ("compiled", pipe.compiled_step())):
        st, outs = pipe.init_state("cpu"), []
        for _ in range(3):
            o, st = fn(params, st)
            outs.append(o)
        tiers[tier] = (outs, st)
    return tiers


#: pipelines whose JAX compiled step differs from the JAX eager step
#: (XLA folds a division by a constant into a reciprocal multiply)
XLA_FOLDS_DIVISION = {"transform"}


def _jax_run(desc, compiled):
    jpipe = jparse(desc).realize()
    jparams = jpipe.init(jax.random.PRNGKey(0))
    step = jpipe.compiled_step() if compiled else jpipe.step
    st, outs = jpipe.init_state(), []
    for _ in range(3):
        o, st = step(jparams, st)
        outs.append(o)
    return outs, st


def _jax_compiled(desc):
    return _jax_run(desc, compiled=True)


def _same_jax(a, b) -> bool:
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


@pytest.mark.parametrize("name", sorted(PARITY_PIPELINES))
def test_tiers_match_the_jax_compiled_step_bitwise(name):
    want, want_state = _jax_compiled(PARITY_PIPELINES[name])
    eager = _jax_run(PARITY_PIPELINES[name], compiled=False)
    assert (not _same_jax((want, want_state), eager)) == \
        (name in XLA_FOLDS_DIVISION)
    if name in XLA_FOLDS_DIVISION:
        want, want_state = eager
    for tier, (outs, st) in _port_tiers(PARITY_PIPELINES[name]).items():
        for k, (o, w) in enumerate(zip(outs, want)):
            assert sorted(o) == sorted(w)
            for sink in o:
                assert_like_jax(o[sink], w[sink], f"{name}/{tier}[{k}]"
                                                  f".{sink}")
        assert_like_jax(st, want_state, f"{name}/{tier}-state")


@pytest.mark.parametrize("name", ["listing1", "mux_forward_ref",
                                  "sparse_roundtrip", "tensor_if"])
def test_compiled_step_through_graphs_matches_jax(name, monkeypatch):
    """The same through the graph path (stand-in graphs, state donated):
    the first call eager, the second captured, the third replayed."""
    fake_graphs(monkeypatch, donate=True)
    want, want_state = _jax_compiled(PARITY_PIPELINES[name])
    tiers = _port_tiers(PARITY_PIPELINES[name])
    outs, st = tiers["compiled"]
    for k, (o, w) in enumerate(zip(outs, want)):
        for sink in o:
            assert_like_jax(o[sink], w[sink], f"{name}/graph[{k}].{sink}")
    assert_like_jax(st, want_state, f"{name}/graph-state")


#: add then multiply, so no step can contract into an FMA under jit
SERVER = ("tensor_query_serversrc operation=tp name=ssrc ! "
          "tensor_transform mode=arithmetic option=add:0.5,mul:3.0,"
          "clamp:-2:2 ! tensor_query_serversink name=ssink")


@pytest.mark.parametrize("graphed", [False, True])
def test_hoisted_query_burst_matches_jax(graphed, monkeypatch):
    """``compiled_step_n(hoist_io=True, hoist_queries=True)`` over 4
    stacked requests == the JAX package's, frame by frame."""
    if graphed:
        fake_graphs(monkeypatch, donate=True)
    reqs = np.random.default_rng(5).standard_normal((4, 2, 6)).astype(
        np.float32)
    pipe = parse_launch(SERVER)
    pipe.elements["ssink"].pair_with(pipe.elements["ssrc"])
    pipe.realize()
    jpipe = jparse(SERVER)
    jpipe.elements["ssink"].pair_with(jpipe.elements["ssrc"])
    jpipe.realize()
    params = pipe.init(torch.Generator().manual_seed(0), "cpu")
    jparams = jpipe.init(jax.random.PRNGKey(0))
    frames = [StreamBuffer(tensors=(torch.as_tensor(r),), pts=i)
              for i, r in enumerate(reqs)]
    jframes = [JBuf(tensors=(jnp.asarray(r),), pts=jnp.int32(i))
               for i, r in enumerate(reqs)]
    step = pipe.compiled_step_n(hoist_io=True, hoist_queries=True)
    jstep = jpipe.compiled_step_n(hoist_io=True, hoist_queries=True)
    st = pipe.init_state("cpu")
    for _ in range(3 if graphed else 1):      # eager, capture, replay
        outs, st = step(params, st, {"ssrc": stack_buffers(frames)})
    jouts, _ = jstep(jparams, jpipe.init_state(),
                     {"ssrc": jstack(jframes)})
    for k, (o, w) in enumerate(zip(unstack_buffers(outs, 4),
                                   junstack(jouts, 4))):
        assert sorted(o) == sorted(w) == ["ssink"]
        assert_like_jax(o["ssink"], w["ssink"], f"burst[{k}]")
