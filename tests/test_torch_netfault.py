"""The lossy network and effectively-once delivery (DESIGN.md §10) in the
port against the JAX package, on the CPU.

Twins of every class of ``tests/test_netfault.py`` (the 200-tick lossy soak
is in ``test_torch_soak.py``).  Each scenario runs in both packages with
the same seeds and fault policies, through the framework-free chaos
harness (``tests/chaoslib.py``, ``lossy_endpoint`` included), the
port's :class:`FaultFabric` handed to it unchanged.  Client ids come from
one counter per package; each scenario starts both counters at the same
value, so answer-link seeds (``seed + 7919 * client_id``), link names and
delivery ids agree.  Pinned for each:

* the reference test's own assertions, on the port;
* the unit level: surviving frame sequences, link ledgers, guard verdicts
  and stats equal the JAX package's, and a flipped frame's damaged bytes
  are bitwise the JAX package's (the LCG draws tensor, byte and bit in the
  same order over the same byte counts);
* the runtime level: every client's sink log bitwise, the whole
  ``delivery`` and ``netfault`` stats blocks (every link ledger) and the
  ``failover``, ``reconfig``, ``query_batching``, ``tenants`` and
  ``broker`` blocks equal the JAX package's key for key.

Then the port alone: a flipped frame is a host copy even when the sender's
tensor was device-resident, and the guard rejects it; codec payloads flip
and are rejected; the CRC memo rides the port's ``StreamBuffer``.

The toy server computes ``float32(x) @ W`` with W of quarters, exact in
both packages; the model scenarios serve the JAX package's weights
(``params_from_numpy``).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chaoslib import Chaos, lossy_endpoint
from repro.core import Channel as JChannel
from repro.core import StreamBuffer as JBuffer
from repro.core import TensorSpec as JSpec
from repro.core import netfault as jnf
from repro.core.broker import BrokerError as JBrokerError
from repro.core.batching import StagedStreamingBatcher as JStaged
from repro.core.elements import register_model as jregister
from repro.core.query import TensorQueryClient as JClient
from repro.launch import model_serve as jax_ms
from repro.models import transformer as jax_tf
from repro_torch.core import Channel, StreamBuffer, TensorSpec
from repro_torch.core import compression as comp
from repro_torch.core import netfault as nf
from repro_torch.core.batching import StagedStreamingBatcher
from repro_torch.core.broker import BrokerError as PortBrokerError
from repro_torch.core.buffers import tree_flatten
from repro_torch.core.elements import register_model
from repro_torch.core.query import TensorQueryClient
from repro_torch.launch import model_serve as ms
from repro_torch.models import transformer as tt
from test_torch_failover import Jax, Port, _comparable, same_logs

torch.set_num_threads(2)

pytestmark = pytest.mark.netchaos

W = ((np.arange(48).reshape(12, 4) % 7 - 3) / 4).astype(np.float32)
STATS = ("failover", "reconfig", "query_batching", "tenants", "broker",
         "delivery", "netfault")


class P(Port):
    nf = nf
    Channel = Channel
    BrokerError = PortBrokerError
    Buffer = StreamBuffer

    @staticmethod
    def tensor(a):
        return torch.from_numpy(a)


class J(Jax):
    nf = jnf
    Channel = JChannel
    BrokerError = JBrokerError
    Buffer = JBuffer

    @staticmethod
    def tensor(a):
        return a


@pytest.fixture(scope="module", autouse=True)
def models():
    register_models()


def register_models():
    register_model("nf_twin", lambda g, dev: {
        "w": torch.as_tensor(W, device=dev)},
        lambda p, x: x.to(torch.float32).reshape(1, -1) @ p["w"],
        out_specs=(TensorSpec((1, 4), "float32"),))
    jregister("nf_twin", lambda rng: {"w": jnp.asarray(W)},
              lambda p, x: x.astype(jnp.float32).reshape(1, -1) @ p["w"],
              out_specs=(JSpec((1, 4), "float32"),))


def twin(scenario, **kw):
    """Run ``scenario(pkg, **kw)`` in both packages, each package's client
    ids counting from the same value (ids stay unique within a package:
    neither counter moves back)."""
    n = max(next(TensorQueryClient._ids), next(JClient._ids))
    TensorQueryClient._ids = itertools.count(n)
    port = scenario(P, **kw)
    JClient._ids = itertools.count(n)
    return port, scenario(J, **kw)


def host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def check_twin(port, jax_, keys=STATS):
    (prt, pruns, _), (jrt, jruns, _) = port, jax_
    same_logs(pruns, jruns)
    got, want = prt.stats(), jrt.stats()
    for k in keys:
        if k in want or k in got:
            assert _comparable(got[k]) == _comparable(want[k]), k


def server(pkg, rt, name="hub", operation="op"):
    dev = pkg.device(name)
    ps = pkg.parse(
        f"tensor_query_serversrc operation={operation} name=ssrc ! "
        f"tensor_filter model=nf_twin ! tensor_query_serversink name=ssink")
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    run = dev.add_pipeline(ps, jit=False)
    rt.add_device(dev)
    return dev, run, ps.elements["ssrc"]


def clients(pkg, rt, n, operation="op", prefix="tv"):
    runs = []
    for i in range(n):
        dev = pkg.device(f"{prefix}{i}")
        pc = pkg.parse(
            f"testsrc width=2 height=2 ! tensor_converter ! "
            f"tensor_query_client operation={operation} codec=none "
            f"name=qc ! appsink name=res")
        runs.append(dev.add_pipeline(pc, jit=False))
        rt.add_device(dev)
    return runs


def responses(run):
    return [host(b.tensor) for b in run.sink_log.get("res", [])]


def assert_prefix_bitwise(ref_runs, got_runs, min_answers):
    """Each lossy run's answers are a bitwise prefix of the fault-free
    twin's, long enough to prove liveness."""
    for ref, got in zip(ref_runs, got_runs):
        a, b = responses(ref), responses(got)
        assert len(b) >= min_answers, \
            f"liveness: only {len(b)} answers, wanted >= {min_answers}"
        assert len(b) <= len(a)
        for j, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(x, y, err_msg=f"answer {j}")


def buf(pkg, i, meta=None):
    return pkg.Buffer(tensors=(pkg.tensor(np.full((4,), i, np.float32)),),
                      pts=np.int64(i), meta=dict(meta or {}))


def pts_of(ch):
    return [int(b.pts) for b in ch.q]


def delivery(pkg, **kw):
    return pkg.nf.DeliveryPolicy(**kw)


def policy(pkg, pol: dict):
    return pkg.nf.FaultPolicy(**pol)


# -- the fault model, unit level ----------------------------------------------

def _same_seed(pkg):
    pol = policy(pkg, dict(seed=3, drop=0.2, dup=0.15, corrupt=0.1))
    runs = []
    for _ in range(2):
        fabric = pkg.nf.FaultFabric()
        ch = pkg.Channel(capacity=256)
        link = fabric.install(ch, pol)
        for i in range(60):
            ch.push(pkg.nf.stamp(buf(pkg, i), (1, i)))
        runs.append((pts_of(ch), link.stats(),
                     [host(b.tensors[0]).tobytes() for b in ch.q]))
        fabric.uninstall(ch)
    return runs


def _bands(pkg):
    def dropped(pol):
        fabric = pkg.nf.FaultFabric()
        ch = pkg.Channel(capacity=256)
        fabric.install(ch, policy(pkg, pol))
        for i in range(80):
            ch.push(buf(pkg, i))
        survivors = set(pts_of(ch))
        fabric.uninstall(ch)
        return set(range(80)) - survivors
    return (dropped(dict(seed=9, drop=0.25)),
            dropped(dict(seed=9, drop=0.25, dup=0.25)))


def _partition(pkg):
    fabric = pkg.nf.FaultFabric()
    ch = pkg.Channel(capacity=256)
    link = fabric.install(ch, policy(pkg, dict(partitions=((2, 5),))))
    for t in range(1, 7):
        fabric.step(t)
        ch.push(buf(pkg, t))
    fabric.assert_conservation()
    return pts_of(ch), link.stats()


def _delay(pkg):
    fabric = pkg.nf.FaultFabric()
    ch = pkg.Channel(capacity=256)
    link = fabric.install(ch, policy(pkg, dict(seed=1, delay=1.0,
                                               delay_ticks=(2, 2))))
    seen = []
    fabric.step(1)
    ch.push(buf(pkg, 0))
    seen.append((len(ch), link.in_flight()))
    fabric.assert_conservation()
    fabric.step(2)
    seen.append((len(ch), link.in_flight()))
    fabric.step(3)
    seen.append((pts_of(ch), link.in_flight()))
    fabric.assert_conservation()
    return seen, link.stats()


def _reorder(pkg):
    fabric = pkg.nf.FaultFabric()
    ch = pkg.Channel(capacity=256)
    link = fabric.install(ch, policy(pkg, dict(seed=1, reorder=1.0)))
    ch.push(buf(pkg, 0))
    ch.push(buf(pkg, 1))
    seen = [pts_of(ch), link.reordered]
    ch.push(buf(pkg, 2))
    seen.append(pts_of(ch))
    fabric.step(1)
    seen.append(pts_of(ch))
    fabric.assert_conservation()
    return seen, link.stats()


def _corrupt(pkg):
    fabric = pkg.nf.FaultFabric()
    ch = pkg.Channel(capacity=256)
    fabric.install(ch, policy(pkg, dict(seed=5, corrupt=1.0)))
    src = buf(pkg, 7)
    original = host(src.tensors[0]).copy()
    ch.push(pkg.nf.stamp(src, (1, 1)))
    wire = ch.pop()
    return (original, host(src.tensors[0]), host(wire.tensors[0]),
            pkg.nf.checksum(wire) != int(wire.meta["crc"]))


def _overflow(pkg):
    fabric = pkg.nf.FaultFabric()
    ch = pkg.Channel(capacity=2)
    link = fabric.install(ch, policy(pkg, {}))
    for i in range(3):
        ch.push(buf(pkg, i))
    fabric.assert_conservation()
    return link.stats()


def _book_back(pkg):
    fabric = pkg.nf.FaultFabric()
    ch = pkg.Channel(capacity=256)
    link = fabric.install(ch, policy(pkg, dict(seed=2, drop=0.1, dup=0.2,
                                               corrupt=0.1)))
    guard = pkg.nf.DeliveryGuard(delivery(pkg))
    for i in range(100):
        ch.push(pkg.nf.stamp(buf(pkg, i), (1, i)))
    verdicts = []
    while True:
        raw = ch.pop()
        if raw is None:
            break
        verdicts.append(guard.check(raw, ch))
    fabric.assert_conservation()
    return verdicts, guard.stats(), link.stats()


class TestFaultLink:
    def test_same_seed_same_schedule(self):
        port, jax_ = _same_seed(P), _same_seed(J)
        assert port[0] == port[1]
        assert port == jax_

    def test_fault_bands_are_disjoint(self):
        port = _bands(P)
        assert port[0] == port[1]
        assert port == _bands(J)

    def test_partition_window_is_tick_scripted(self):
        port = _partition(P)
        assert port[0] == [1, 5, 6]
        assert port[1]["dropped_by_fault"] == 3
        assert port == _partition(J)

    def test_delay_holds_until_due_tick(self):
        port = _delay(P)
        assert port[0] == [(0, 1), (0, 1), ([0], 1)]
        assert port == _delay(J)

    def test_reorder_swaps_adjacent_frames(self):
        port = _reorder(P)
        assert port[0] == [[1, 0], 1, [1, 0], [1, 0, 2]]
        assert port == _reorder(J)

    def test_corruption_never_mutates_the_senders_buffer(self):
        original, after, wire, caught = _corrupt(P)
        np.testing.assert_array_equal(after, original)
        assert caught                          # the damage is real
        assert (wire != original).sum() == 1   # one element, one bit
        jorig, _, jwire, jcaught = _corrupt(J)
        assert jcaught
        assert wire.tobytes() == jwire.tobytes()   # the same bit flipped

    def test_overflow_drops_stay_on_the_ledger(self):
        port = _overflow(P)
        assert port["overflow_drops"] == 1
        assert port == _overflow(J)

    def test_guard_verdicts_book_back_onto_the_link(self):
        verdicts, gstats, lstats = _book_back(P)
        assert lstats["dropped_by_fault"] > 0 and \
            lstats["injected_dups"] > 0 and lstats["corrupted"] > 0
        assert gstats["deduped"] > 0 and gstats["rejected_corrupt"] > 0
        assert (verdicts, gstats, lstats) == _book_back(J)


# -- the delivery guard -------------------------------------------------------

def _dedup(pkg):
    g = pkg.nf.DeliveryGuard(delivery(pkg))
    raw = pkg.nf.stamp(buf(pkg, 0), (7, 1))
    return [g.check(raw), g.check(raw)], g.stats()


def _corrupt_first(pkg):
    g = pkg.nf.DeliveryGuard(delivery(pkg))
    raw = pkg.nf.stamp(buf(pkg, 5), (7, 1))
    bad = raw.with_(tensors=(pkg.tensor(np.zeros((4,), np.float32)),))
    return [g.check(bad), g.check(raw)], g.stats()


def _passthrough(pkg):
    g = pkg.nf.DeliveryGuard(delivery(pkg))
    return [g.check(buf(pkg, 0)), g.check(buf(pkg, 0))], g.stats()


def _window(pkg):
    g = pkg.nf.DeliveryGuard(delivery(pkg, window=3))
    out = [g.check(pkg.nf.stamp(buf(pkg, i), (1, i))) for i in range(4)]
    out += [g.seen((1, 0)), g.seen((1, 3)),
            g.check(pkg.nf.stamp(buf(pkg, 3), (1, 3)))]
    return out, g.stats()


def _forget(pkg):
    g = pkg.nf.DeliveryGuard(delivery(pkg))
    raw = pkg.nf.stamp(buf(pkg, 0), (7, 1))
    out = [g.check(raw)]
    fired = []
    g.record_answer((7, 1), lambda: fired.append(1))
    g.forget((7, 1))
    out += [g.check(raw), g.replay_answer((7, 1)), fired]
    return out, g.stats()


def _replay(pkg):
    g = pkg.nf.DeliveryGuard(delivery(pkg))
    fired = []
    g.record_answer((7, 1), lambda: fired.append(1))
    return [g.replay_answer((7, 1)), fired], g.stats()


def _backoff(pkg):
    pol = delivery(pkg, timeout_ticks=2, backoff=2.0, max_backoff_ticks=16)
    return [pol.retry_in(k) for k in range(20)], \
        delivery(pkg, timeout_ticks=0).retry_in(0)


class TestDeliveryGuard:
    def test_dedup_by_delivery_id(self):
        port = _dedup(P)
        assert port[0] == ["ok", "dup"] and port[1]["deduped"] == 1
        assert port == _dedup(J)

    def test_corrupt_is_rejected_before_dedup(self):
        port = _corrupt_first(P)
        assert port[0] == ["corrupt", "ok"]
        assert port == _corrupt_first(J)

    def test_undelivered_meta_passes_through(self):
        port = _passthrough(P)
        assert port[0] == ["ok", "ok"]
        assert port == _passthrough(J)

    def test_window_is_bounded_lru(self):
        port = _window(P)
        assert port[0] == ["ok"] * 4 + [False, True, "dup"]
        assert port == _window(J)

    def test_forget_reopens_a_shed_id(self):
        port = _forget(P)
        assert port[0] == ["ok", "ok", False, []]
        assert port == _forget(J)

    def test_replay_refires_the_committed_answer(self):
        port = _replay(P)
        assert port[0] == [True, [1]] and port[1]["replayed"] == 1
        assert port == _replay(J)

    def test_backoff_schedule(self):
        port = _backoff(P)
        assert port[0][:6] == [2, 4, 8, 16, 16, 16] and port[1] == 1
        assert port == _backoff(J)


# -- the CRC domain, port only ------------------------------------------------

class TestCrcDomain:
    def test_flip_of_a_device_resident_frame_is_host_and_rejected(
            self, monkeypatch):
        """The sender's tensor is marked device-resident (outside the CRC
        domain, as a CUDA tensor is): the stamp covers none of its bytes.
        The flip copies every tensor to the host, so the damaged copy lies
        in the domain, its checksum differs from the stamp's, and the
        guard rejects it.  A flip that handed the damage back to the
        device would pass the guard as clean."""
        src = buf(P, 3)
        marked = {id(src.tensors[0])}
        real = nf._host_resident
        monkeypatch.setattr(nf, "_host_resident", lambda t: (
            id(t) not in marked and real(t)))
        stamped = nf.stamp(src, (1, 1))
        fabric = nf.FaultFabric()
        ch = Channel(capacity=8)
        link = fabric.install(ch, nf.FaultPolicy(seed=5, corrupt=1.0))
        ch.push(stamped)
        wire = ch.pop()
        t = wire.tensors[0]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert id(t) not in marked              # a fresh host copy
        assert nf._host_resident(t)
        guard = nf.DeliveryGuard(nf.DeliveryPolicy())
        assert guard.check(wire, ch) == "corrupt"
        assert guard.check(stamped, ch) == "ok"     # the intact frame
        assert link.stats()["rejected_corrupt"] == 1

    def test_device_resident_bytes_are_outside_the_domain(self, monkeypatch):
        a, b = buf(P, 1), buf(P, 2)
        marked = {id(a.tensors[0]), id(b.tensors[0])}
        real = nf._host_resident
        monkeypatch.setattr(nf, "_host_resident", lambda t: (
            id(t) not in marked and real(t)))
        b = b.with_(pts=np.int64(1))
        assert nf.checksum(a) == nf.checksum(b)   # only pts is covered

    @pytest.mark.parametrize("codec", ["quant8", "sparse:0.5"])
    def test_codec_payload_flips_and_is_rejected(self, codec):
        """A wire frame whose tensor is a codec payload flips one bit of
        one of its leaves (in leaf order) and the guard rejects it.  (The
        JAX package's flip raises on a payload: ROADMAP Queue 3.)"""
        x = torch.linspace(-1, 1, 64 * 128).reshape(1, 64, 128)
        enc, _ = comp.encode(StreamBuffer(tensors=(x,), pts=np.int64(0)),
                             codec)
        stamped = nf.stamp(enc, (1, 1))
        fabric = nf.FaultFabric()
        ch = Channel(capacity=8)
        fabric.install(ch, nf.FaultPolicy(seed=5, corrupt=1.0))
        ch.push(stamped)
        wire = ch.pop()
        assert type(wire.tensors[0]) is type(enc.tensors[0])
        guard = nf.DeliveryGuard(nf.DeliveryPolicy())
        assert guard.check(wire) == "corrupt"
        assert guard.check(stamped) == "ok"
        def flat(payload):
            return np.concatenate([host(leaf).reshape(-1).view(np.uint8)
                                   for leaf in tree_flatten(payload)[0]])
        diff = np.unpackbits(flat(wire.tensors[0]) ^ flat(enc.tensors[0]))
        assert diff.sum() == 1                  # one bit, nothing else

    def test_bf16_and_zero_dim_tensors_are_covered(self):
        t = torch.linspace(-2, 2, 10, dtype=torch.bfloat16)
        a = StreamBuffer(tensors=(t, torch.tensor(3, dtype=torch.int32)),
                         pts=np.int64(0))
        c = nf.checksum(a)
        assert getattr(a, "_crc_memo") == c     # the memo rides the buffer
        t2 = t.clone()
        t2.view(torch.int16)[4] ^= 1
        assert nf.checksum(a.with_(tensors=(t2, a.tensors[1]))) != c
        fabric = nf.FaultFabric()
        ch = Channel(capacity=8)
        fabric.install(ch, nf.FaultPolicy(seed=1, corrupt=1.0))
        ch.push(nf.stamp(a, (1, 1)))
        wire = ch.pop()
        assert [w.dtype for w in wire.tensors] == [torch.bfloat16,
                                                   torch.int32]
        assert nf.checksum(wire) != int(wire.meta["crc"])

    def test_stamp_carries_the_memo_and_a_fresh_buffer_recomputes(self):
        a = buf(P, 4)
        s = nf.stamp(a, (1, 1))
        assert s._crc_memo == a._crc_memo == s.meta["crc"]
        fresh = s.with_(meta=dict(s.meta))
        assert not hasattr(fresh, "_crc_memo")
        assert nf.checksum(fresh) == s.meta["crc"]

    def test_cpu_pts_tensor_is_covered(self):
        a = StreamBuffer(tensors=(), pts=torch.tensor(5))
        b = StreamBuffer(tensors=(), pts=np.int64(5))
        c = StreamBuffer(tensors=(), pts=np.int64(6))
        assert nf.checksum(a) == nf.checksum(b) != nf.checksum(c)


# -- chaos-pinned parity: plain queries ---------------------------------------

FAULT_CLASSES = {
    "drop": dict(seed=11, drop=0.08),
    "dup": dict(seed=12, dup=0.15),
    "reorder": dict(seed=13, reorder=0.2),
    "corrupt": dict(seed=14, corrupt=0.08),
    "delay": dict(seed=15, delay=0.15, delay_ticks=(1, 2)),
}

MIXED = dict(seed=21, drop=0.05, dup=0.05, corrupt=0.04, reorder=0.08,
             delay=0.08, delay_ticks=(1, 2))

#: the faults a synchronous round trip can retransmit through inline
SYNC = dict(seed=21, drop=0.05, dup=0.05, corrupt=0.04)

FIRED_COUNTER = {"drop": "dropped_by_fault", "dup": "injected_dups",
                 "reorder": "reordered", "corrupt": "corrupted",
                 "delay": "delayed"}


def _clean(pkg, ticks, n_clients, query_batch=8, lossless_delivery=True):
    rt = pkg.runtime(query_batch=query_batch,
                     delivery=delivery(pkg) if lossless_delivery else None)
    server(pkg, rt)
    runs = clients(pkg, rt, n_clients)
    rt.run(ticks)
    return rt, runs, {}


def _lossy(pkg, ticks, n_clients, req, ans, query_batch=8):
    rt = pkg.runtime(query_batch=query_batch, delivery=delivery(pkg))
    _, _, ssrc = server(pkg, rt)
    runs = clients(pkg, rt, n_clients)
    fabric = pkg.nf.FaultFabric()
    rt.fabric = fabric
    links = lossy_endpoint(fabric, ssrc.endpoint, policy(pkg, req),
                           None if ans is None else policy(pkg, ans),
                           name="hub")
    rt.run(ticks)
    return rt, runs, dict(fabric=fabric, links=links)


class TestPlainQueryParity:
    @pytest.mark.parametrize("fault", sorted(FAULT_CLASSES))
    def test_each_fault_class_bitwise(self, fault):
        pol = FAULT_CLASSES[fault]
        ticks, n_clients = 24, 4
        port, jax_ = twin(_lossy, ticks=ticks, n_clients=n_clients,
                          req=pol, ans=pol)
        check_twin(port, jax_)
        rt, got, ex = port
        fired = sum(link.stats()[FIRED_COUNTER[fault]]
                    for link in ex["links"])
        assert fired > 0, f"the {fault} schedule never fired"
        _, ref, _ = _clean(P, ticks, n_clients)
        assert_prefix_bitwise(ref, got, min_answers=ticks // 3)
        ex["fabric"].assert_conservation()
        d = rt.stats()["delivery"]
        if fault == "corrupt":
            assert d["rejected_corrupt"] + d["client_answer_corrupt"] > 0
        if fault == "drop":
            assert d["retransmits"] > 0
            assert d["replayed"] + d["accepted"] > 0

    @pytest.mark.parametrize("query_batch", [1, 4, 8])
    def test_mixed_faults_across_batch_sizes(self, query_batch):
        """All five fault classes at once, the fused dispatch round and the
        per-frame path alike."""
        ticks, n_clients = 40, 4
        port, jax_ = twin(_lossy, ticks=ticks, n_clients=n_clients,
                          req=MIXED, ans=MIXED, query_batch=query_batch)
        check_twin(port, jax_)
        rt, got, ex = port
        _, ref, _ = _clean(P, ticks, n_clients, query_batch=query_batch)
        assert_prefix_bitwise(ref, got, min_answers=ticks // 4)
        ex["fabric"].assert_conservation()

    def test_synchronous_round_trip_retransmits_inline(self):
        """``query_batch=0``: the client's ``apply`` retransmits under one
        delivery id inside the call, against drop, duplication and
        corruption on both links; every answer bitwise, no frame lost."""
        ticks, n_clients = 40, 4
        port, jax_ = twin(_lossy, ticks=ticks, n_clients=n_clients,
                          req=SYNC, ans=SYNC, query_batch=0)
        check_twin(port, jax_)
        rt, got, ex = port
        _, ref, _ = _clean(P, ticks, n_clients, query_batch=0)
        assert_prefix_bitwise(ref, got, min_answers=ticks)
        ex["fabric"].assert_conservation()
        d = rt.stats()["delivery"]
        assert d["deduped"] > 0 and d["rejected_corrupt"] > 0 \
            and d["replayed"] > 0

    def test_synchronous_round_trip_cannot_wait_out_a_held_frame(self):
        """``query_batch=0`` under the mixed policy: the inline retransmits
        never step the fault clock, so a delayed or reorder-held frame
        outlasts them and the round trip raises, in both packages alike
        (the runtime's backoff clock is the path that waits)."""
        def scenario(pkg):
            with pytest.raises(pkg.BrokerError) as e:
                _lossy(pkg, ticks=40, n_clients=4, req=MIXED, ans=MIXED,
                       query_batch=0)
            return str(e.value)
        port, jax_ = twin(scenario)
        assert port == jax_ == "qc: no answer from 'op' after 4 retransmits"

    def test_scripted_partition_heals_with_backoff(self):
        ticks, n_clients = 18, 3
        part = dict(partitions=((4, 8),))
        port, jax_ = twin(_lossy, ticks=ticks, n_clients=n_clients,
                          req=part, ans=None)
        check_twin(port, jax_)
        rt, got, ex = port
        assert ex["links"][0].dropped_fault >= n_clients
        assert rt.stats()["delivery"]["retransmits"] > 0
        _, ref, _ = _clean(P, ticks, n_clients)
        assert_prefix_bitwise(ref, got, min_answers=10)
        ex["fabric"].assert_conservation()

    def test_delivery_layer_is_inert_on_clean_links(self):
        ticks, n_clients = 8, 3
        off = twin(_clean, ticks=ticks, n_clients=n_clients,
                   lossless_delivery=False)
        on = twin(_clean, ticks=ticks, n_clients=n_clients)
        check_twin(*off)
        check_twin(*on)
        (_, ref, _), (rt, got, _) = off[0], on[0]
        for r, g in zip(ref, got):
            assert g.frames == ticks
            a, b = responses(r), responses(g)
            assert len(a) == len(b) == ticks
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        d = rt.stats()["delivery"]
        assert d["retransmits"] == 0 and d["deduped"] == 0 \
            and d["rejected_corrupt"] == 0
        assert "delivery" not in off[0][0].stats()


# -- suspicion vs declared death ----------------------------------------------

def _control_partition(pkg, fault=True):
    ticks, n_clients = 14, 4
    rt = pkg.runtime(query_batch=8, lease_ticks=2, delivery=delivery(pkg))
    devA, runA, ssrcA = server(pkg, rt, name="hubA")
    devB, runB, ssrcB = server(pkg, rt, name="hubB")
    runs = clients(pkg, rt, n_clients)
    harness = Chaos(rt)
    if fault:
        harness.partition_control(4, 9, devA)
    harness.run(ticks)
    return rt, runs, dict(harness=harness, reg=ssrcA.registration,
                          runB=runB)


def _crash(pkg):
    rt = pkg.runtime(query_batch=8, lease_ticks=4, delivery=delivery(pkg))
    devA, _, ssrcA = server(pkg, rt, name="hubA")
    server(pkg, rt, name="hubB")
    runs = clients(pkg, rt, 2)
    harness = Chaos(rt)
    harness.kill_server(3, devA, ssrcA, crash=True)
    harness.run(6)
    return rt, runs, dict(harness=harness, reg=ssrcA.registration)


def _silent_death(pkg):
    rt = pkg.runtime(query_batch=8, lease_ticks=2, delivery=delivery(pkg))
    devA, _, ssrcA = server(pkg, rt, name="hubA")
    server(pkg, rt, name="hubB")
    runs = clients(pkg, rt, 2)
    harness = Chaos(rt)
    harness.kill_server(3, devA, ssrcA, crash=False)
    harness.run(10)
    return rt, runs, dict(harness=harness, reg=ssrcA.registration)


class TestSuspicionAndHeal:
    def test_control_partition_suspects_then_wins_back(self):
        port, jax_ = twin(_control_partition)
        check_twin(port, jax_)
        assert port[2]["harness"].log == jax_[2]["harness"].log
        rt, got, ex = port
        assert rt.broker.suspicions >= 1
        assert rt.broker.heals >= 1
        reg = ex["reg"]
        assert reg.alive and not reg.suspected
        assert ex["runB"].frames > 0
        _, ref, _ = _control_partition(P, fault=False)
        for r, g in zip(ref, got):
            assert g.frames == 14
            a, b = responses(r), responses(g)
            assert len(a) == len(b) == 14
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)

    def test_crash_is_declared_death_not_suspicion(self):
        port, jax_ = twin(_crash)
        check_twin(port, jax_)
        rt, _, ex = port
        reg = ex["reg"]
        assert not reg.alive and not reg.suspected
        assert rt.broker.suspicions == 0
        assert rt.broker.heal(reg) is False

    def test_silent_death_is_suspicion_until_revived(self):
        port, jax_ = twin(_silent_death)
        check_twin(port, jax_)
        rt, runs, ex = port
        reg = ex["reg"]
        assert not reg.alive and reg.suspected
        assert reg.down_reason == "lease-expired"
        assert rt.broker.suspicions == 1
        assert all(r.frames == 10 for r in runs)


# -- mid-generation streams (§7) ----------------------------------------------

MAX_SEQ = 32


@pytest.fixture(scope="module")
def smoke():
    """The JAX package's PRNGKey(0) weights of the default serve preset
    and the port's copy."""
    name = "stablelm-smoke-flash"
    jp = jax_tf.init_params(jax.random.PRNGKey(0),
                            jax_ms.SERVE_MODELS[name]())
    return jp, tt.params_from_numpy(jax.device_get(jp),
                                    ms.SERVE_MODELS[name](), "cpu")


def _mod(pkg):
    return jax_ms if pkg is J else ms


def lm_client(pkg, rt, i, prompts=None, gens="4"):
    dev = pkg.device(f"tv{i}")
    run = dev.add_pipeline(_mod(pkg).client_pipeline(
        prompts=prompts or f"{i+1},{i+2},{i+3}", gens=gens), jit=False)
    rt.add_device(dev)
    return run


def token_streams(run):
    return [host(b.tensor).tolist() for b in run.sink_log.get("res", [])]


def streaming_batcher(rt):
    (b,) = [b for b in rt._batchers.values()
            if getattr(b, "tokens_generated", None) is not None]
    return b


def _streaming(pkg, weights, lossy=True):
    ticks, n_clients = 16, 3
    pol = dict(seed=31, drop=0.05, dup=0.12, corrupt=0.05)
    rt = pkg.runtime(query_batch=8, delivery=delivery(pkg))
    dev = pkg.device("hub")
    ps = _mod(pkg).serve_pipeline(slots=8, max_seq=MAX_SEQ)
    run = dev.add_pipeline(ps, jit=False)
    run.params["lm"] = weights[0 if pkg is J else 1]
    rt.add_device(dev)
    runs = [lm_client(pkg, rt, i) for i in range(n_clients)]
    fabric = None
    if lossy:
        fabric = pkg.nf.FaultFabric()
        rt.fabric = fabric
        lossy_endpoint(fabric, ps.elements["ssrc"].endpoint,
                       policy(pkg, pol), policy(pkg, pol), name="lm")
    rt.run(ticks)
    return rt, runs, dict(fabric=fabric)


class TestStreamingUnderLoss:
    def test_streaming_answers_bitwise_under_mixed_faults(self, smoke):
        port, jax_ = twin(_streaming, weights=smoke)
        check_twin(port, jax_)
        rt, got, ex = port
        rt0, ref, _ = _streaming(P, smoke, lossy=False)
        for r, g in zip(ref, got):
            a, b = token_streams(r), token_streams(g)
            assert len(b) >= 1
            assert b == a[:len(b)]
        ex["fabric"].assert_conservation()
        st = streaming_batcher(rt).stats()
        assert st["tokens_generated"] == st["tokens_delivered"] + \
            st["tokens_dropped"] + st["tokens_in_flight"]
        d = rt.stats()["delivery"]
        assert st["streams_started"] <= d["accepted"]


# -- mid-generation stage hops (§8) -------------------------------------------

@pytest.fixture(scope="module")
def stage_w():
    model = "stablelm-smoke-4l"
    run = jax_ms.serve_pipeline(model=model, slots=8, max_seq=MAX_SEQ)
    from repro.runtime import Device as JDevice
    jp = JDevice("w").add_pipeline(run, jit=False).params["lm"]
    return tt.params_from_numpy(jax.device_get(jp),
                                ms.SERVE_MODELS[model](), "cpu")


def _staged(pkg, tp, lossy=True):
    ticks, n_clients = 14, 2
    req = dict(seed=41, dup=0.12, corrupt=0.06, drop=0.03)
    ans = dict(seed=42, dup=0.10)
    model = "stablelm-smoke-4l"
    rt = pkg.runtime(query_batch=8, delivery=delivery(pkg))
    stages = []
    for k, ps in enumerate(_mod(pkg).staged_serve_pipelines(
            model=model, slots=8, max_seq=MAX_SEQ, n_stages=2)):
        dev = pkg.device(f"stage{k}")
        run = dev.add_pipeline(ps, jit=False)
        if pkg is P:
            run.params["lm"] = tt.stage_params(
                tp, ms.SERVE_MODELS[model](), k, 2)
        rt.add_device(dev)
        stages.append(ps)
    runs = [lm_client(pkg, rt, i, prompts=f"{i+1},{i+2}")
            for i in range(n_clients)]
    fabric = None
    if lossy:
        fabric = pkg.nf.FaultFabric()
        rt.fabric = fabric
        lossy_endpoint(fabric, stages[1].elements["ssrc"].endpoint,
                       policy(pkg, req), policy(pkg, ans), name="s1")
    rt.run(ticks)
    return rt, runs, dict(fabric=fabric)


def coordinator(rt):
    (c,) = [b for b in rt._batchers.values()
            if isinstance(b, (StagedStreamingBatcher, JStaged))]
    return c


class TestStagedHopsUnderLoss:
    def test_staged_decode_bitwise_with_lossy_hop_link(self, stage_w):
        port, jax_ = twin(_staged, tp=stage_w)
        check_twin(port, jax_)
        rt, got, ex = port
        _, ref, _ = _staged(P, stage_w, lossy=False)
        for r, g in zip(ref, got):
            a, b = token_streams(r), token_streams(g)
            assert len(b) >= 1
            assert b == a[:len(b)]
        ex["fabric"].assert_conservation()
        c = coordinator(rt)
        st = c.stats()
        assert st["tokens_generated"] == st["tokens_delivered"] + \
            st["tokens_dropped"] + st["tokens_in_flight"]
        for k in range(1, c.n_stages):
            led = c.stage_ledger(k)
            assert led["dispatched"] == led["completed"] + led["failed"]
        assert st["hop_retransmits"] + st["hop_dups"] + st["hop_corrupt"] \
            + rt.stats()["delivery"]["deduped"] > 0
        jst = coordinator(jax_[0]).stats()
        for k in ("hop_retransmits", "hop_dups", "hop_corrupt",
                  "stage_replays", "stage_replay_steps"):
            assert _comparable(st[k]) == _comparable(jst[k]), k


# -- examples/lossy_fleet.py --------------------------------------------------

W_FLEET = ((np.arange(48 * 16).reshape(48, 16) % 9 - 4) / 4).astype(
    np.float32)
FLEET_REQ = dict(seed=11, drop=0.06, dup=0.03, corrupt=0.02,
                 partitions=((10, 14),))
FLEET_ANS = dict(seed=23, drop=0.05, dup=0.02, corrupt=0.01)
N_TVS, BUDGET, MAX_TICKS = 4, 12, 60


def _fleet(pkg, lossy=True):
    """``examples/lossy_fleet.py``: four TVs offload to a hub over lossy
    links (a request-plane partition at ticks 10-14), each until it has
    its answer budget.  The hub's model is ``relu(float32(x) @ W)`` with W
    of quarters, exact in both packages."""
    rt = pkg.runtime(query_batch=8, delivery=delivery(pkg))
    hub = pkg.device("hub")
    srv = pkg.parse(
        "tensor_query_serversrc operation=svc name=ssrc ! "
        "tensor_filter model=nf_fleet ! tensor_query_serversink name=ssink")
    srv.elements["ssink"].pair_with(srv.elements["ssrc"])
    hub.add_pipeline(srv, jit=False)
    rt.add_device(hub)
    tvs = []
    for i in range(N_TVS):
        dev = pkg.device(f"tv{i}")
        tvs.append(dev.add_pipeline(pkg.parse(
            "testsrc width=4 height=4 ! tensor_converter ! "
            "tensor_query_client operation=svc name=qc ! appsink name=res"),
            jit=False))
        rt.add_device(dev)
    fabric = None
    if lossy:
        fabric = pkg.nf.FaultFabric()
        rt.fabric = fabric
        lossy_endpoint(fabric, srv.elements["ssrc"].endpoint,
                       policy(pkg, FLEET_REQ), policy(pkg, FLEET_ANS),
                       name="svc")
        while rt.ticks < MAX_TICKS and any(
                len(tv.sink_log.get("res", ())) < BUDGET for tv in tvs):
            rt.tick()
    else:
        rt.run(MAX_TICKS)
    return rt, tvs, dict(fabric=fabric)


def test_lossy_fleet_example_twin():
    register_model("nf_fleet", lambda g, dev: {
        "w": torch.as_tensor(W_FLEET, device=dev)},
        lambda p, x: torch.clamp_min(
            x.to(torch.float32).reshape(1, -1) @ p["w"], 0.0),
        out_specs=(TensorSpec((1, 16), "float32"),))
    jregister("nf_fleet", lambda rng: {"w": jnp.asarray(W_FLEET)},
              lambda p, x: jnp.maximum(
                  x.astype(jnp.float32).reshape(1, -1) @ p["w"], 0.0),
              out_specs=(JSpec((1, 16), "float32"),))
    port, jax_ = twin(_fleet)
    check_twin(port, jax_)
    rt, tvs, ex = port
    _, ref, _ = _fleet(P, lossy=False)
    assert rt.ticks < MAX_TICKS
    assert_prefix_bitwise(ref, tvs, min_answers=BUDGET)
    ex["fabric"].assert_conservation()
    lied = sum(s["dropped_by_fault"] + s["corrupted"]
               for s in rt.stats()["netfault"].values())
    assert lied > 0 and rt.stats()["delivery"]["retransmits"] > 0


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")


@pytest.mark.cuda
def test_flip_of_a_cuda_frame_is_host_and_rejected(card):
    """A CUDA payload is outside the CRC domain (two frames that differ
    only on the card checksum alike), the flip's damaged copy is on the
    host, and the guard rejects it."""
    a = StreamBuffer(tensors=(torch.arange(16.0, device=card),),
                     pts=np.int64(1))
    b = StreamBuffer(tensors=(torch.zeros(16, device=card),),
                     pts=np.int64(1))
    assert nf.checksum(a) == nf.checksum(b)
    stamped = nf.stamp(a, (1, 1))
    fabric = nf.FaultFabric()
    ch = Channel(capacity=8)
    fabric.install(ch, nf.FaultPolicy(seed=5, corrupt=1.0))
    ch.push(stamped)
    wire = ch.pop()
    assert wire.tensors[0].device.type == "cpu"
    assert a.tensors[0].device.type == "cuda"       # the sender's is intact
    guard = nf.DeliveryGuard(nf.DeliveryPolicy())
    assert guard.check(wire, ch) == "corrupt"
    assert guard.check(stamped, ch) == "ok"


class Card(P):
    @staticmethod
    def runtime(**kw):
        from repro_torch.runtime import Runtime
        return Runtime(**kw)

    @staticmethod
    def device(name):
        from repro_torch.runtime import Device
        return Device(name)


@pytest.mark.cuda
def test_lossy_plain_queries_on_the_card_equal_the_cpu(card):
    """The mixed fault schedule over a server on the card: the same sink
    logs, ``delivery`` and ``netfault`` stats as on the CPU (the CRC
    domain differs, the verdicts do not)."""
    # both fleets' clients take the same ids (their runtimes are apart),
    # so the answer links draw the same fault seeds
    n = next(TensorQueryClient._ids)
    TensorQueryClient._ids = itertools.count(n)
    cpu = _lossy(P, ticks=40, n_clients=4, req=MIXED, ans=MIXED)
    TensorQueryClient._ids = itertools.count(n)
    gpu = _lossy(Card, ticks=40, n_clients=4, req=MIXED, ans=MIXED)
    same_logs(gpu[1], cpu[1])
    for k in ("delivery", "query_batching", "failover"):
        assert _comparable(gpu[0].stats()[k]) == \
            _comparable(cpu[0].stats()[k]), k
    gpu[2]["fabric"].assert_conservation()
