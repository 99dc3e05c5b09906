"""The harness on the CPU: end-to-end metrics over every request of the
window, cells, configurations and metrics found from files alone, and the
check on the modules a run loads."""
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from portbench import harness, testcell, yardstick


def _req(c, j, sent, answered, n, error=False):
    return harness.Request(c, j, np.zeros(4, np.int32), n, sent, answered,
                           None if error else np.zeros(n, np.int64), error)


def test_window_metrics_cover_every_request():
    # ticks 0..9, 1 s each; the window is ticks 3..8
    start = [float(t) for t in range(10)]
    end = [t + 1.0 for t in start]
    reqs = [[_req(0, 0, 0, 2, 5), _req(0, 1, 3, 4, 7), _req(0, 2, 5, 9, 9)],
            [_req(1, 0, 1, 3, 11), _req(1, 1, 4, 6, 2, error=True),
             _req(1, 2, 7, 8, 13), _req(1, 3, 9, None, 3)]]
    done, answers, lat, tokens = harness.window_answers(reqs, start, end,
                                                        3, 9)
    assert [(r.client, r.index) for r in done] == [(0, 1), (1, 0), (1, 1),
                                                   (1, 2)]
    assert [(r.client, r.index) for r in answers] == [(0, 1), (1, 0), (1, 2)]
    assert lat == [2000.0, 3000.0, 2000.0]     # tick start to tick end
    assert tokens == 7 + 11 + 13
    assert yardstick.percentile(lat, 95) == pytest.approx(2900.0)


def _run(root, trace=False, seconds=0.5, seed=2 ** 31 + 101, **kw):
    cell = harness.load_cell(root, "smoke.chat")
    return harness.run_cell(cell, seed, seconds, trace, "cpu",
                            log=lambda *a: None, min_answers=30, **kw)


def test_a_cell_config_and_metric_added_as_files(tmp_path):
    root = testcell.make(tmp_path, testcell.SMOKE_MQA)
    (root / "portbench/metrics/ticks_seen.py").write_text(textwrap.dedent(
        '''
        def read(r):
            return float(len(r.steady))
        '''))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "ticks_seen", "unit": "ticks", "better": "higher",
        "source": "host_clock", "layer": "scheduler", "moves":
        "tokens_per_s", "workloads": ["smoke.chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(root, "smoke.chat")
    assert cell.config["name"] == "smoke-mqa"
    assert [m["name"] for m in cell.per_layer][-1] == "ticks_seen"
    res = _run(root, trace=True)
    assert res["correct"], res["check"]
    assert res["metrics"]["ticks_seen"]["value"] > 0
    assert {"sched_self_ms", "prefill_ms", "decode_tick_ms", "mfu"} <= \
        set(res["metrics"])
    # the card's metrics read nothing on the CPU and are left out
    assert "k5_roofline" not in res["metrics"]
    assert list(res)[-1] == "check"


def test_an_untraced_run_reports_the_end_to_end_metrics(tmp_path):
    res = _run(testcell.make(tmp_path))
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"tokens_per_s", "latency_p95_ms",
                                   "setup_s"}
    assert res["attempted"] > 10 and res["failed"] == 0
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_a_split_metric_reads_as_its_quantity(tmp_path):
    # a cell of another pacing takes suffixed metrics with bounds of their
    # own; they read what their quantity reads, from the same files
    root = testcell.make(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != "smoke.chat"]
            if m["name"] in ("tokens_per_s.host_paced", "mfu.host_paced"):
                m["workloads"].append("smoke.chat")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert harness.quantity("mfu.host_paced") == "mfu"
    cell = harness.load_cell(root, "smoke.chat")
    assert harness.load_metric(cell, "mfu.host_paced").read.__module__ == \
        "portbench_metric_mfu_host_paced"
    res = _run(root)
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"tokens_per_s.host_paced", "setup_s"}
    assert res["metrics"]["tokens_per_s.host_paced"]["value"] > 0
    res = _run(root, trace=True)
    assert set(res["metrics"]) == {"mfu.host_paced"}


def test_a_preset_that_departs_from_its_file_is_refused(tmp_path):
    root = testcell.make(tmp_path, dict(testcell.SMOKE, hidden_size=512))
    with pytest.raises(ValueError, match="hidden_size"):
        _run(root)


@pytest.mark.parametrize("mods,bad", [
    ({"repro_torch", "repro_torch.core"}, []),
    ({"repro", "repro.core.plan"}, ["repro", "repro.core.plan"]),
    ({"jax_like", "jaxlib.xla", "flax"}, ["flax", "jaxlib.xla"]),
    ({"reproducible", "portbench.harness"}, []),
])
def test_forbidden_names_are_compared_whole(mods, bad):
    assert harness.forbidden_modules(dict.fromkeys(mods)) == bad


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    root = testcell.make(tmp_path)
    code = textwrap.dedent(f'''
        import sys
        sys.path[:0] = [{str(testcell.REPO)!r}, {str(testcell.REPO / "src")!r}]
        from portbench import harness
        cell = harness.load_cell({str(root)!r}, "smoke.chat")
        res = harness.run_cell(cell, 7, 0.5, True, "cpu", log=lambda *a: None,
                               min_answers=10)
        assert res["correct"], res["check"]
        print(harness.forbidden_modules())
        ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_py_refuses_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(testcell.REPO / "portbench/run.py"),
         "--workload", "granite-20b.code", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr
