"""Twins of ``examples/sharded_offloading.py``, ``multicam_pubsub.py``,
``multitenant_fleet.py`` and ``lossy_fleet.py`` against the reference
scripts, on the CPU (the method: ``test_torch_examples.py``).

The mesh twin runs on 8 ``cpu`` slots where the script forges 8 host
devices; its mesh line, the placement ``auto`` calibrates (a timing) and
the sharded-frame count that follows from it are masked.  The lossy twin
runs in a fresh process: its answer links' fault seeds come from client
ids, which count from process start in both packages.
"""
import re

import pytest

from test_torch_examples import (References, num, run_twin, run_twin_fresh,
                                 same_printout)


@pytest.fixture(scope="module")
def refs():
    r = References({name: [] for name in (
        "sharded_offloading", "multicam_pubsub", "multitenant_fleet",
        "lossy_fleet")})
    yield r
    r.close()


def test_sharded_offloading(refs, capsys):
    c, out = run_twin("sharded_offloading", [], capsys)
    ref = refs.out("sharded_offloading")
    same_printout(out, ref, [r"^host mesh: .*$",
                             r"calibrated placement for batch 8: \w+",
                             r"sharded frames so far: \d+"], ok=False)
    assert c["phase_a"] == (num(r"primary served (\d+) frames", ref),
                            num(r"in (\d+) batched dispatches", ref))
    assert c["redispatches"] == num(r"redispatches=(\d+)", ref) == 8
    assert c["parked_now"] == num(r"parked_now=(\d+)", ref) == 0
    assert c["orphaned"] == num(r"orphaned=(\d+)", ref) == 4
    assert c["backup_frames"] == num(r"backup served (\d+) frames", ref)
    assert [f"tick {t}: {label}" for t, label in c["chaos_log"]] == \
        re.findall(r"^  (tick \d+: .*)$", ref, flags=re.M)
    assert c["tv_frames"] == [10] * 8
    assert c["placement"] in ("single", "sharded")
    assert (c["sharded_frames"] > 0) == (c["placement"] == "sharded")


def test_multicam_pubsub(refs, capsys):
    c, out = run_twin("multicam_pubsub", [], capsys)
    ref = refs.out("multicam_pubsub")
    same_printout(out, ref)
    assert c["frames"] == num(r"display muxed (\d+) frames", ref) == 8
    assert c["pts"] == num(r"pts=(-?\d+)ns", ref)
    for dev in ("cam_left", "cam_right", "coral", "lcd"):
        assert c["stats"][f"{dev}/p0"]["frames"] == 8
        assert c["stats"][f"{dev}/p0"]["drops"] == 0


def test_multitenant_fleet(refs, capsys):
    c, out = run_twin("multitenant_fleet", [], capsys)
    ref = refs.out("multitenant_fleet")
    same_printout(out, ref, ok=False)
    for tid, t in c["tenants"].items():
        row = re.search(rf"^ *{re.escape(tid)} +(\d+) +(\d+) +(\d+) +(\d+) "
                        rf"+(\d+) +(\d+)  (.*)$", ref, flags=re.M)
        prio, adm, served, shed, p50, p99 = map(int, row.groups()[:6])
        assert (t["priority"], t["admitted"], t["served"], t["shed"],
                round(t["p50_ticks"]), round(t["p99_ticks"])) == \
            (prio, adm, served, shed, p50, p99), tid
        reasons = ", ".join(f"{r}={n}" for r, n in
                            sorted(t["shed_reasons"].items())) or "-"
        assert reasons == row.group(7), tid
        # the conservation law of every tenant ledger
        assert t["admitted"] == t["served"] + t["shed"] + t["queued"] + \
            t["in_flight"]
    assert c["error_frames"] == c["sheds"] == num(
        r"explicit degradation: (\d+) client-visible", ref)
    (scaler,) = c["autoscale"]
    assert (scaler["scale_ups"], scaler["scale_downs"],
            scaler["rollbacks"]) == (
        num(r"(\d+) scale-up", ref), num(r"(\d+) scale-down", ref),
        num(r"(\d+) rollback", ref)) == (1, 1, 0)


def test_lossy_fleet(refs):
    c, out = run_twin_fresh("lossy_fleet", [])
    ref = refs.out("lossy_fleet")
    same_printout(out, ref)
    assert c["ticks"] == num(r"done in (\d+) ticks", ref)
    for name, s in c["netfault"].items():
        row = re.search(rf"^{re.escape(name)} +(\d+) +(\d+) +(\d+) +(\d+) "
                        rf"+(\d+) +(\d+)$", ref, flags=re.M)
        assert (s["sent"], s["dropped_by_fault"], s["injected_dups"],
                s["corrupted"], s["deduped"], s["accepted"]) == \
            tuple(map(int, row.groups())), name
    d = c["delivery"]
    assert (d["retransmits"], d["deduped"], d["replayed"],
            d["rejected_corrupt"], d["client_answer_dups"],
            d["client_answer_corrupt"]) == (
        num(r"(\d+) retransmits", ref), num(r"(\d+) server dedups", ref),
        num(r"(\d+) answer replays", ref),
        num(r"(\d+) corrupt frames rejected", ref),
        num(r"(\d+) client-side dups", ref),
        num(r"(\d+) corrupt answers rejected", ref))
    assert c["lied"] == num(r"the network lied (\d+) times", ref) > 0
    assert len(c["answers"]) == 4 and min(c["answers"]) >= 12
