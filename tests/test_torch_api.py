"""The public API of M1 and M3 that no serving path calls, in the port
against the JAX package, on the CPU: the ``core`` package's re-exports,
``Pipeline.sources()`` / ``sinks()``, ``TensorQueryClient.recv_answer()``
and ``StatefulElement``; and ``Runtime._wire(device, run)``, which
``examples/augmented_worker.py`` calls to wire a pipeline added to a device
after the runtime took it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as core
from repro.core.element import StatefulElement as JStateful
from repro.core.element import register_element as jregister_element
from repro_torch.core.element import StatefulElement, register_element
from test_torch_failover import Jax, Port

torch.set_num_threads(2)

W = (np.arange(12).reshape(12, 1) % 5 / 4).astype(np.float32)

LAUNCHES = (
    "appsrc name=in ! appsink name=out",
    "testsrc width=2 height=2 ! tensor_converter ! tee name=t "
    "t. ! appsink name=a t. ! appsink name=b",
    "appsrc name=x ! tensor_mux name=m ! appsink name=y "
    "appsrc name=z ! m.",
    "testsrc width=2 height=2 ! tensor_converter ! "
    "mqttsink pub-topic=cam",
)


@register_element("api_counter")
class _Counter(StatefulElement):
    """Scales each frame by how many frames it has seen (state)."""

    def negotiate(self, in_caps):
        return list(in_caps)

    def init_state(self, device):
        return {"n": torch.zeros((), dtype=torch.float32, device=device)}

    def apply(self, params, inputs, ctx=None):
        n = ctx.get_state(self.name)["n"] + 1
        ctx.set_state(self.name, {"n": n})
        return [inputs[0].with_(tensors=(inputs[0].tensors[0] * n,))]


@jregister_element("api_counter")
class _JCounter(JStateful):
    def negotiate(self, in_caps):
        return list(in_caps)

    def init_state(self):
        return {"n": jnp.zeros((), jnp.float32)}

    def apply(self, params, inputs, ctx=None):
        n = ctx.get_state(self.name)["n"] + 1
        ctx.set_state(self.name, {"n": n})
        return [inputs[0].with_(tensors=(inputs[0].tensors[0] * n,))]


@pytest.fixture(scope="module", autouse=True)
def models():
    core.register_model(
        "api_twin", lambda g, dev: {"w": torch.as_tensor(W, device=dev)},
        lambda p, x: x.to(torch.float32).reshape(1, -1) @ p["w"],
        out_specs=(core.TensorSpec((1, 1), "float32"),))
    jcore.register_model(
        "api_twin", lambda rng: {"w": jnp.asarray(W)},
        lambda p, x: x.astype(jnp.float32).reshape(1, -1) @ p["w"],
        out_specs=(jcore.TensorSpec((1, 1), "float32"),))


@pytest.mark.parametrize("name", ["register_model", "MODEL_REGISTRY",
                                  "SparsePayload", "StatefulElement"])
def test_core_reexports(name):
    """``repro_torch.core`` re-exports what ``repro.core`` does, from the
    submodule that defines it, and lists it in ``__all__``."""
    assert name in core.__all__
    got = getattr(core, name)
    if name in ("register_model", "MODEL_REGISTRY"):
        assert got is core.elements.__dict__[name]
        assert hasattr(jcore, name)
    elif name == "SparsePayload":
        assert got is core.buffers.SparsePayload
        assert hasattr(jcore, name)
    else:
        assert got is StatefulElement and issubclass(got, core.Element)
    assert "api_twin" in core.MODEL_REGISTRY


@pytest.mark.parametrize("launch", LAUNCHES)
def test_pipeline_sources_and_sinks(launch):
    """The app sources and sinks by name, in element order, as the JAX
    package lists them."""
    got, want = core.parse_launch(launch), jcore.parse_launch(launch)
    assert got.sources() == want.sources()
    assert got.sinks() == want.sinks()


def test_pipeline_sources_and_sinks_name_the_step_io():
    pipe = core.parse_launch(LAUNCHES[0])
    assert pipe.sources() == ["in"] and pipe.sinks() == ["out"]
    x = core.StreamBuffer(tensors=(torch.arange(4),))
    outs, _ = pipe.step({}, {}, {"in": x})
    assert sorted(outs) == pipe.sinks()


def _answers(pkg):
    rt = pkg.runtime()
    dev = pkg.device("hub")
    ps = pkg.parse("tensor_query_serversrc operation=op name=ssrc ! "
                   "tensor_filter model=api_twin ! "
                   "tensor_query_serversink name=ssink")
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    dev.add_pipeline(ps, jit=False)
    rt.add_device(dev)
    cdev = pkg.device("tv")
    pc = pkg.parse("appsrc name=in ! tensor_query_client operation=op "
                   "name=qc ! appsink name=res")
    cdev.add_pipeline(pc, jit=False)
    rt.add_device(cdev)
    qc = pc.elements["qc"]
    buf_cls = core.StreamBuffer if pkg is Port else jcore.StreamBuffer
    out = [qc.recv_answer()]                # nothing sent yet
    for k in range(3):
        x = (np.arange(12, dtype=np.uint8) + k).reshape(2, 2, 3)
        qc.send_query(buf_cls(tensors=(torch.as_tensor(x) if pkg is Port
                                       else x,)))
    qc._endpoint().spec["inline_runner"]()
    for _ in range(4):
        out.append(qc.recv_answer())
    return out


def test_recv_answer_pops_decoded_answers_in_order():
    got, want = _answers(Port), _answers(Jax)
    assert got[0] is None and want[0] is None
    assert got[-1] is None and want[-1] is None
    for g, w in zip(got[1:-1], want[1:-1]):
        a = np.asarray(g.tensor)
        assert a.dtype == np.float32 and a.shape == (1, 1)
        np.testing.assert_array_equal(a, np.asarray(w.tensor))


def _counter_run(pkg):
    pipe = pkg.parse("appsrc name=in ! api_counter name=c ! appsink "
                     "name=out")
    if pkg is Port:
        state, buf = pipe.init_state("cpu"), core.StreamBuffer
        x = torch.full((2, 3), 1.5)
    else:
        state, buf = pipe.init_state(), jcore.StreamBuffer
        x = jnp.full((2, 3), 1.5)
    outs = []
    for _ in range(3):
        o, state = pipe.step({}, state, {"in": buf(tensors=(x,))})
        outs.append(np.asarray(o["out"].tensor))
    return pipe, outs


def test_stateful_element_threads_its_state():
    pipe, got = _counter_run(Port)
    _, want = _counter_run(Jax)
    assert isinstance(pipe.elements["c"], StatefulElement)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.full((2, 3), 1.5 * (k + 1),
                                                 np.float32))


def test_wire_takes_the_device_and_the_run_as_the_reference():
    """``Runtime._wire`` has the JAX package's (device, run) parameters, so
    a pipeline added to a device already in the runtime is wired as
    ``examples/augmented_worker.py`` wires it: its mqttsrc finds the
    publisher and drains what it published."""
    import inspect
    from repro.runtime import Runtime as JRuntime
    from repro_torch.runtime import Runtime
    assert list(inspect.signature(Runtime._wire).parameters) == \
        list(inspect.signature(JRuntime._wire).parameters) == \
        ["self", "device", "run"]
    got = {}
    for pkg in (Port, Jax):
        rt = pkg.runtime()
        cam = pkg.device("cam")
        cam.add_pipeline(pkg.parse(
            "testsrc width=2 height=2 ! tensor_converter ! "
            "mqttsink pub-topic=api/wire"), jit=False)
        rt.add_device(cam)
        late = pkg.parse("mqttsrc sub-topic=api/wire is-live=false ! "
                         "appsink name=out")
        cam.add_pipeline(late, jit=False)
        rt._wire(cam, cam.runs[-1])
        rt.run(3)
        got[pkg] = (cam.runs[-1].frames,
                    [np.asarray(b.tensor).tolist()
                     for b in cam.runs[-1].sink_log.get("out", ())])
    assert got[Port] == got[Jax] and got[Port][0] > 0
