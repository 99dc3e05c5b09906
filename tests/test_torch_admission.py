"""The port's ``AdmissionQueue`` against the JAX package's, on scripts
drawn as ``tests/test_admission_properties.py`` draws them (hypothesis,
derandomized).  Each script runs through both queues; the dequeue order,
the ingest results, the shed notices each client pops, ``len``,
``backlog``, ``queued_for`` and the whole ``stats()`` must be equal after
every round, at ``qos=None`` (global FIFO pass-through) and under a
three-class ``QoSConfig`` with deadlines, token buckets, queue caps and a
serve budget."""
from hypothesis import given, settings, strategies as st

from chaoslib import burst_schedule, tenant_arrivals, zipf_tenants
from repro.core import admission as jadm
from repro_torch.core import admission as tadm

TENANTS = ["rt", "std", "batch"]
CLIENTS = range(4)

#: one round: arrivals (tenant or untagged, client), a take size (None =
#: all), how the taken records close, and whether the round expires first
ROUND = st.tuples(
    st.lists(st.tuples(st.sampled_from(TENANTS + ["guest", None]),
                       st.sampled_from(list(CLIENTS))), max_size=6),
    st.one_of(st.none(), st.integers(min_value=0, max_value=4)),
    st.sampled_from(["served", "shed", "notify", "hold"]),
    st.booleans())
SCRIPT = st.lists(ROUND, min_size=1, max_size=16)
#: per-tenant overrides as plain tuples, so each package builds its own
#: TenantSpec: (priority, rate, burst, deadline_ticks, max_queue, weight)
SPEC = st.tuples(st.integers(min_value=0, max_value=2),
                 st.sampled_from([None, 0.5, 1, 2]),
                 st.sampled_from([None, 1, 2]),
                 st.sampled_from([None, 1, 3]),
                 st.sampled_from([None, 1, 2]),
                 st.sampled_from([None, 0.3, 2.0]))
CONFIG = st.one_of(
    st.none(),
    st.tuples(st.fixed_dictionaries({t: SPEC for t in TENANTS}),
              st.sampled_from([None, 1, 2, 3])))


class _Raw:
    """Stand-in wire buffer: the admission layer reads only ``.meta``."""

    def __init__(self, tenant=None, client=None, tag=None):
        self.meta = {}
        if tenant is not None:
            self.meta["tenant_id"] = tenant
        if client is not None:
            self.meta["client_id"] = client
        self.tag = tag


def _qos(mod, config):
    if config is None:
        return None
    specs, serve_per_tick = config
    tenants = tuple(
        mod.TenantSpec(t, priority=p, rate=r, burst=b, deadline_ticks=d,
                       max_queue=q, weight=w)
        for t, (p, r, b, d, q, w) in specs.items())
    return mod.QoSConfig(tenants=tenants,
                         default=mod.TenantSpec(priority=2, max_queue=3),
                         serve_per_tick=serve_per_tick)


def _trace(mod, config, script):
    """Run ``script`` through one package's queue; -> what it observed."""
    tick = [0]
    adm = mod.AdmissionQueue(qos=_qos(mod, config), clock=lambda: tick[0])
    out, tag = [], 0
    for arrivals, k, close, expire in script:
        tick[0] += 1
        ingested = []
        for tenant, client in arrivals:
            rec = adm.ingest(_Raw(tenant, client, tag))
            ingested.append(None if rec is None else
                            (rec.tenant, rec.priority, rec.deadline, rec.seq))
            tag += 1
        expired = adm.expire() if expire else None
        taken = adm.take(k)
        for i, rec in enumerate(taken):
            if close == "served" or (close == "hold" and i % 2):
                adm.mark_served(rec)
            elif close in ("shed", "notify"):
                adm.mark_shed(rec, "server-died", notify=close == "notify")
        notices = {c: [] for c in CLIENTS}
        for c in CLIENTS:
            while (r := adm.pop_notice(c)) is not None:
                notices[c].append(r)
        out.append(dict(
            ingested=ingested, expired=expired,
            taken=[(r.raw.tag, r.order_key()) for r in taken],
            notices=notices, len=len(adm), backlog=adm.backlog(),
            queued_for=[adm.queued_for(c) for c in CLIENTS],
            enabled=adm.enabled, stats=adm.stats()))
    out.append(dict(shed=adm.shed_queued("server-died", notify=True),
                    notices=[adm.pop_notice(c) for c in CLIENTS],
                    stats=adm.stats()))
    return out


def _same(config, script):
    got = _trace(tadm, config, script)
    assert got == _trace(jadm, config, script)
    return got


@given(SCRIPT)
@settings(max_examples=40, deadline=None, derandomize=True)
def test_passthrough_scripts_match(script):
    got = _same(None, script)
    taken = [t for r in got[:-1] for t, _ in r["taken"]]
    assert taken == sorted(taken)          # global FIFO


@given(CONFIG, SCRIPT)
@settings(max_examples=80, deadline=None, derandomize=True)
def test_qos_scripts_match(config, script):
    _same(config, script)


@given(st.integers(min_value=0, max_value=9),
       st.integers(min_value=1, max_value=4))
@settings(max_examples=20, deadline=None, derandomize=True)
def test_overload_bursts_match(seed, deadlines):
    """``test_admission_properties``' deterministic-shed scenario: a burst
    of Zipf-skewed tenants against a 1-a-tick server, deadlines on the
    priority-0 tenant, a token bucket and a queue cap on the others."""
    sched = burst_schedule(12, base=2, burst=6, burst_at=(4,), width=3)
    arrivals = tenant_arrivals(12, TENANTS, sched, seed=seed)
    script = [([(t, i % 4) for i, t in enumerate(a)], 1, "served", True)
              for a in arrivals]
    config = ({"rt": (0, None, None, deadlines, None, None),
               "std": (1, 1, 2, None, None, None),
               "batch": (2, None, None, None, 2, None)}, None)
    got = _same(config, script)
    shed = sum(t["shed"] for t in got[-2]["stats"].values())
    assert shed > 0


@given(st.integers(min_value=20, max_value=60))
@settings(max_examples=10, deadline=None, derandomize=True)
def test_backlogged_classes_match(rounds):
    """Every class kept backlogged, one dequeue a round: the stride
    scheduler's service order is the JAX package's."""
    tenants = zipf_tenants(3 * rounds, TENANTS, seed=rounds)
    script = [([(t, 0) for t in tenants[3 * i:3 * i + 3]], 1, "served",
               False) for i in range(rounds)]
    config = ({"rt": (0, None, None, None, None, None),
               "std": (1, None, None, None, None, None),
               "batch": (2, None, None, None, None, None)}, None)
    _same(config, script)
