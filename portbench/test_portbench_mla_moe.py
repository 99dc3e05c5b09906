"""The cell ``deepseek-v2-236b-ep8.chat`` on the CPU: its entries and files
as committed (the preset the configuration file names serves what the file
states, the metrics it joins), and the same kind of cell at smoke widths
through ``run_cell`` against the plain reference ``references/mla_moe.py``,
traced and untraced, with the fp8 control coming out not correct.

At the cell's own widths the check's widest logit gap does not tell the
bf16 program from its fp8 control (``PERF.md`` sections 6 and 7); at smoke
widths in float32 it does."""
import json
from pathlib import Path

import pytest

from portbench import harness, testcell

CELL = "deepseek-v2-236b-ep8.chat"

#: the entries of ``BENCHMARK.json`` that list the cell: its
#: configuration and workload, the accepted metrics it joins, and its own
#: per-layer metrics
REGISTRATION = {
    "config": {
        "name": "deepseek-v2-236b-ep8",
        "source": "https://huggingface.co/deepseek-ai/DeepSeek-V2/blob/main/"
                  "config.json",
        "file": "portbench/configs/deepseek-v2-236b-ep8.json",
        "reduced": ["num_hidden_layers", "n_routed_experts"],
        "why": "MLA at 128 heads with 160 experts top-6, group-limited; EP8 "
               "rank 0 of stage 1 of 4: layers 0-14 of 60, experts 20 of "
               "160, one eighth of the deployment's per-expert load"},
    "workload": {
        "name": CELL, "config": "deepseek-v2-236b-ep8", "traffic": "chat",
        "chips": 1,
        "why": "Splitwise conversation: prompts median 1020 (to 3072), "
               "outputs 129; 128 clients on 128 slots at 4096: MLA absorbed "
               "decode over long latent caches, dropless MoE prefills"},
    "joins": ["tokens_per_s", "latency_p95_ms", "sched_self_ms",
              "prefill_ms", "decode_tick_ms", "idle_share", "peak_gib"],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": "model step (core/modelserve.py, models/transformer.py)",
         "moves": moves, "workloads": [CELL]}
        for name, unit, better, source, moves in (
            ("mfu.mla_moe", "%", "higher", "host_clock", "tokens_per_s"),
            ("moe_prefill_ms.mla_moe", "ms", "lower", "program_span",
             "latency_p95_ms"),
            ("mla_prefill_ms.mla_moe", "ms", "lower", "program_span",
             "latency_p95_ms"))]}



#: DeepSeek-V2's equations as the committed configuration states them
#: (group-limited router, unnormalised top k times 16, YaRN, one rank's
#: share, dropless) at smoke widths: 3 layers, 16 experts in 4 groups (2
#: kept), top 4, this rank holding experts 4..7
_FIELDS = {"experts_held": 4, "expert_first": 4, "n_group": 4,
           "topk_group": 2, "norm_topk": False, "routed_scale": 16.0,
           "capacity_factor": 16 / 4, "yarn_factor": 40.0,
           "yarn_original": 4096, "yarn_mscale": 0.707}
SMOKE_EP = {
    "name": "smoke-ep", "source":
        "https://huggingface.co/deepseek-ai/DeepSeek-V2/blob/main/config.json",
    "port": {"arch": "deepseek-v2-236b", "preset": "deepseek-ep-smoke",
             "overrides": {"n_layers": 3, "d_model": 256, "n_heads": 4,
                           "n_kv_heads": 4, "d_ff": 512, "vocab": 512,
                           "n_experts": 16, "top_k": 4,
                           "n_shared_experts": 1, "d_ff_expert": 128,
                           "kv_lora_rank": 64, "q_lora_rank": 64,
                           "qk_nope_dim": 32, "qk_rope_dim": 16,
                           "v_head_dim": 32, "dtype": "float32", **_FIELDS},
             "fields": dict(_FIELDS, use_flash_attn=False)},
    "reference": "mla_moe", "dtype": "float32",
    "num_hidden_layers": 3, "hidden_size": 256, "num_attention_heads": 4,
    "intermediate_size": 512, "vocab_size": 512, "norm": "rmsnorm",
    "act": "silu", "mlp_glu": True, "rope_theta": 10000,
    "tie_word_embeddings": False, "rms_norm_eps": 1e-6,
    "n_routed_experts": 16, "num_experts_per_tok": 4, "n_shared_experts": 1,
    "moe_intermediate_size": 128, "first_k_dense_replace": 1,
    "kv_lora_rank": 64, "q_lora_rank": 64, "qk_nope_head_dim": 32,
    "qk_rope_head_dim": 16, "v_head_dim": 32, "n_group": 4, "topk_group": 2,
    "topk_method": "group_limited_greedy", "norm_topk_prob": False,
    "routed_scaling_factor": 16, "scoring_func": "softmax",
    "rope_scaling": {"type": "yarn", "factor": 40, "beta_fast": 32,
                     "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096},
    "share": {"experts_held": 4, "expert_first": 4}, "reduced": []}

#: the cell's own metrics; named ``<quantity>.mla_moe`` (their readers are
#: ``metrics/<quantity>.py`` but for ``mfu``'s), so that ``testcell.make``'s
#: smoke cells, which join every metric of an unsuffixed name, do not turn
#: the program's tracer on
NEW_METRICS = {"mfu.mla_moe", "moe_prefill_ms.mla_moe",
               "mla_prefill_ms.mla_moe"}


def test_the_benchmark_lists_the_cell_as_registration_gives():
    bench = json.loads((testcell.REPO / "BENCHMARK.json").read_text())
    assert bench["configs"][-1] == REGISTRATION["config"]
    assert bench["workloads"][-1] == REGISTRATION["workload"]
    assert bench["per_layer"][-3:] == REGISTRATION["per_layer"]
    joined = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
              if CELL in m.get("workloads", ())}
    assert joined == set(REGISTRATION["joins"]) | NEW_METRICS
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in REGISTRATION["joins"]:
            assert m["workloads"][-1] == CELL


def test_the_committed_cell_serves_what_its_file_states():
    cell = harness.load_cell(testcell.REPO, CELL)
    assert harness.serve_preset(cell.config) == "deepseek-v2-236b-ep8"
    assert cell.entry["chips"] == 1
    names = {m["name"] for m in cell.per_layer}
    assert NEW_METRICS | {"sched_self_ms", "prefill_ms", "decode_tick_ms",
                          "idle_share", "peak_gib"} == names
    assert {m["name"] for m in cell.end_to_end} == {
        "tokens_per_s", "latency_p95_ms", "setup_s"}
    for name in NEW_METRICS:
        assert getattr(harness.load_metric(cell, name), "PROGRAM_TRACE")
    c = cell.config
    assert (c["n_routed_experts"], c["share"]["experts_held"],
            c["num_hidden_layers"]) == (160, 20, 15)
    assert c["reference"] == "mla_moe"


def _cell(tmp_path) -> Path:
    """A smoke cell of the committed equations that joins the cell's own
    metrics too."""
    root = testcell.make(tmp_path, SMOKE_EP, leave_out=testcell.DENSE_READERS)
    path = root / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW_METRICS:
            m["workloads"].append("smoke.chat")
    path.write_text(json.dumps(bench))
    return root


def _run(root, trace, **kw):
    cell = harness.load_cell(root, "smoke.chat")
    return harness.run_cell(cell, 2 ** 31 + 977, 0.5, trace, "cpu",
                            log=lambda *a: None, min_answers=30, **kw)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_smoke_cell_matches_its_plain_reference(tmp_path, trace):
    from repro_torch.models import moe
    root = _cell(tmp_path)
    with moe.drop_log() as log:
        res = _run(root, trace)
    assert res["correct"], res["check"]
    # float32 program and reference: the served tokens are the reference's
    # best within rounding
    assert res["check"]["logit_gap_max"]["value"] < 1e-3
    assert log and sum(int(d) for _, _, d in log) == 0      # dropless
    if trace:
        assert NEW_METRICS | {"sched_self_ms", "prefill_ms",
                              "decode_tick_ms"} <= set(res["metrics"])
        assert 0 < res["metrics"]["mfu.mla_moe"]["value"] <= 100
    else:
        assert set(res["metrics"]) == {"tokens_per_s", "latency_p95_ms",
                                       "setup_s"}


def test_the_fp8_control_is_not_correct(tmp_path):
    res = _run(_cell(tmp_path), False, control=True)
    assert not res["correct"]
    assert res["calibration"]["program_gap_max"] < 1e-3
    assert res["check"]["logit_gap_max"]["value"] > 1e-3


def test_the_readers_read_nothing_without_the_programs_records():
    cell = harness.load_cell(testcell.REPO, CELL)
    base = dict(config=cell.config, wl=cell.wl, steady=[0, 1],
                tick_s=[1.0, 1.0], prefill_s=[0.5, 0.0], prefills=[1, 0],
                decode_s=[0.1, 0.1], decode_times=[[0.1], [0.1]],
                prefill_lengths=[[100], []], decode_positions=[[5], [6]],
                peak_bytes=0)
    spans = ([("prefill", 0, 10, 0, -1, 1)], [])    # a parent's drain
    for trace in (None, [spans, spans], [([], [], []), ([], [], [])]):
        r = harness.Reading(**base, trace=trace)
        for name in NEW_METRICS:
            assert harness.load_metric(cell, name).read(r) is None, name
    moe = [("moe", 0, 2_000_000, 1, -1, None),
           ("mla", 0, 1_000_000, 2, -1, None)]
    counts = [("moe.prefill", (100, 75, 0))]
    r = harness.Reading(**base, trace=[(moe, [], counts), ([], [], [])])
    read = {n: harness.load_metric(cell, n).read(r) for n in NEW_METRICS}
    assert read["moe_prefill_ms.mla_moe"] == pytest.approx(2.0)
    assert read["mla_prefill_ms.mla_moe"] == pytest.approx(1.0)
    assert read["mfu.mla_moe"] > 0
