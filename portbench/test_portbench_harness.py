"""The harness on the CPU: end-to-end metrics over every request of the
window, cells, configurations and metrics found from files alone, and the
check on the modules a run loads."""
import hashlib
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

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


def _without(config, *keys, **extra):
    return dict({k: v for k, v in config.items() if k not in keys}, **extra)


#: a file of mixtral's equations at the port's ``mixtral-smoke`` widths
#: (every layer windowed), but for the window
_MIXTRAL_NO_WINDOW = dict(
    testcell.SMOKE, name="smoke-moe",
    port={"arch": "mixtral-8x22b", "preset": "mixtral-smoke",
          "fields": {"use_flash_attn": False}},
    norm="rmsnorm", norm_eps=1e-6, rope_theta=1e6, rope_fraction=1.0,
    n_routed_experts=4, num_experts_per_tok=2, moe_intermediate_size=128)


@pytest.mark.parametrize("config,match", [
    (dict(testcell.SMOKE, hidden_size=512), "hidden_size"),
    (_without(testcell.SMOKE_MLA_MOE, "n_routed_experts"), "routed experts"),
    (_without(testcell.SMOKE_MLA_MOE, "kv_lora_rank", num_key_value_heads=4,
              head_dim=40, rope_fraction=1.0, attention_bias=False),
     "latent attention"),
    (_MIXTRAL_NO_WINDOW, "a layer pattern or window"),
    (dict(testcell.SMOKE, port={"arch": "stablelm-1.6b",
                                "preset": "stablelm-smoke"}),
     "flash attention off"),
    (dict(testcell.SMOKE, port=dict(testcell.SMOKE["port"],
                                    fields={"use_flash_attn": False})),
     "use_flash_attn"),
    (dict(testcell.SMOKE, port=dict(testcell.SMOKE["port"],
                                    fields={"n_experts_held": 1})),
     "ModelConfig lacks"),
    (_without(testcell.SMOKE, "head_dim"), "does not state"),
], ids=["hidden_size", "experts", "mla", "window", "flash_off",
        "port_fields", "unknown_field", "missing_key"])
def test_a_preset_that_departs_from_its_file_is_refused(tmp_path, config,
                                                        match):
    root = testcell.make(tmp_path, config)
    with pytest.raises(ValueError, match=match):
        _run(root)


def test_a_file_that_states_the_window_passes():
    cfg = dict(_MIXTRAL_NO_WINDOW, sliding_window=32)
    assert harness.serve_preset(cfg) == "mixtral-smoke"


#: a stand-in for the plain reference of a DeepSeek-V2-shaped decoder
_PORT_FORWARD = '''
"""A stand-in for a plain reference, for the CPU tests alone: teacher-forced
logits of the port's own fp32 model (``repro_torch.models.transformer.
lm_train``, latent attention and routed experts) on the drawn weights.  It
shares the program's code, so it shows that the harness carries such a
cell, not that the program is right: the plain reference comes with the
configuration."""
import torch


def served_logits(weights, cfg, seqs, starts, control=False):
    from repro_torch.launch import model_serve as ms
    from repro_torch.models.transformer import lm_train
    if control:
        raise NotImplementedError("the stand-in has no control")
    mc = ms.SERVE_MODELS[cfg["port"]["preset"]]()
    out = []
    with torch.no_grad():
        for seq, start in zip(seqs, starts):
            out.append((lm_train(weights, mc, seq[None])[0][0, start:],
                        None))
    return out
'''


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_a_latent_attention_moe_cell_added_as_files(tmp_path, trace):
    from repro_torch.models import moe
    root = testcell.make(tmp_path, testcell.SMOKE_MLA_MOE,
                         leave_out=testcell.DENSE_READERS)
    (root / "portbench/references/port_forward.py").write_text(_PORT_FORWARD)
    with moe.drop_log() as log:
        res = _run(root, trace=trace)
    assert res["correct"], res["check"]
    assert res["check"]["logit_gap_max"]["value"] < 1e-3
    # the MoE layers ran, and dropped no token at the file's capacity
    assert log and sum(int(d.sum()) for _, _, d in log) == 0
    if trace:
        assert {"sched_self_ms", "prefill_ms", "decode_tick_ms"} <= \
            set(res["metrics"])
        assert not set(testcell.DENSE_READERS) & set(res["metrics"])
    else:
        assert set(res["metrics"]) == {"tokens_per_s", "latency_p95_ms",
                                       "setup_s"}


def _served_tree(preset):
    from repro_torch.launch import model_serve as ms
    from repro_torch.runtime import Device
    srv = Device("hub", device="cpu").add_pipeline(
        ms.serve_pipeline(model=preset, slots=2, max_seq=16))
    return srv.params["lm"]


def test_rank3_leaves_draw_at_their_fan_in():
    tree = _served_tree("deepseek-smoke")
    harness.draw_weights(tree, 2 ** 31 + 7)
    leaves = dict(harness._leaves(tree))
    experts = [p for p in leaves if p.split("/")[-2] == "moe"
               and leaves[p].dim() == 3]
    heads = [p for p in leaves if p.split("/")[-1] in ("w_uk", "w_uv",
                                                       "w_uq")]
    assert len(experts) == 3 and len(heads) == 6
    for p in experts:
        for e, w in enumerate(leaves[p]):
            assert float(w.std()) == pytest.approx(w.shape[0] ** -0.5,
                                                   rel=0.1), (p, e)
    for p in heads:
        w = leaves[p]
        assert float(w.std()) == pytest.approx(w.shape[0] ** -0.5,
                                               rel=0.1), p


@pytest.mark.parametrize("path,shape", [
    ("attn/w_other", (4, 2, 3)), ("moe/w_up", (2, 4, 3, 3)),
    ("mlp/w_up", (2, 4, 3))])
def test_an_unknown_rank3_leaf_raises(path, shape):
    head, name = path.split("/")
    tree = {"layers": [{head: {name: torch.zeros(shape)}}]}
    with pytest.raises(ValueError, match=name):
        harness.draw_weights(tree, 1)


def _tree_hash(tree):
    h = hashlib.sha256()
    for path, t in harness._leaves(tree):
        h.update(f"{path} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.contiguous().view(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("preset,digest", [
    ("stablelm-smoke-flash",
     "73b9a85209dc6e0fd509b856e7a4d90b8d51959ee8554a29c6f52f539a5e8805"),
    ("granite-smoke",
     "46f6aac90de0885cb85ee83a9123e48893c111ca5c612c3b9ebf324b49436fa4")])
def test_the_dense_trees_draw_as_before(preset, digest):
    # the digests of the draw before rank-3 leaves had rules
    tree = _served_tree(preset)
    harness.draw_weights(tree, 2 ** 31 + 101)
    assert _tree_hash(tree) == digest


def _add_metric(root, name, code):
    (root / f"portbench/metrics/{name}.py").write_text(textwrap.dedent(code))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": name, "unit": "1", "better": "higher",
        "source": "program_span", "layer": "batcher", "moves":
        "tokens_per_s", "workloads": ["smoke.chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_metric_reads_the_program_trace(tmp_path):
    from repro_torch.core import trace
    root = testcell.make(tmp_path)
    _add_metric(root, "decode_span_share", '''
        PROGRAM_TRACE = True


        def read(r):
            # the batcher's decode_times end before the answers' delivery
            assert r.trace[0] is None and r.trace_dropped == 0
            sign = {"decode": 1, "decode.deliver": -1}
            spans = sum(sign.get(s.name, 0) * (s.t1_ns - s.t0_ns)
                        for t in r.steady for s in r.trace[t][0]) / 1e9
            return spans / sum(x for t in r.steady for x in r.decode_times[t])
        ''')
    res = _run(root, trace=True)
    assert res["correct"], res["check"]
    assert res["metrics"]["decode_span_share"]["value"] == \
        pytest.approx(1.0, abs=0.05)
    assert not trace.TRACER.on


def test_the_tracer_stays_off_without_such_a_metric(tmp_path, monkeypatch):
    from repro_torch.core import trace
    calls = []
    monkeypatch.setattr(trace, "enable", lambda: calls.append("enable"))
    monkeypatch.setattr(trace.TRACER, "begin",
                        lambda *a, **k: calls.append(a))
    root = testcell.make(tmp_path)
    _add_metric(root, "no_trace", '''
        def read(r):
            return float(r.trace is None)
        ''')
    res = _run(root, trace=True)
    assert res["correct"], res["check"]
    assert res["metrics"]["no_trace"]["value"] == 1.0
    assert calls == [] and not trace.TRACER.on


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
