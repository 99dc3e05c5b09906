"""A checkout in miniature for the CPU tests: this benchmark's files and
``BENCHMARK.json`` copied under a temporary root, with one small cell
added as files alone (a smoke configuration, its workload) the way a
later change adds a cell.  The program is the repository's own
``src/repro_torch``."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path
from typing import Optional, Sequence

REPO = Path(__file__).resolve().parents[1]
if str(REPO / "src") not in sys.path:
    sys.path.append(str(REPO / "src"))

#: the port's stablelm smoke preset (fp32, 2 layers, d 256, vocab 512);
#: ``dtype`` bfloat16 serves the same widths in the cells' precision
SMOKE = {"name": "smoke", "source": "https://huggingface.co/stabilityai/stablelm-2-1_6b",
         "port": {"arch": "stablelm-1.6b", "preset": "stablelm-smoke-flash"},
         "reference": "dense_decoder", "dtype": "float32",
         "num_hidden_layers": 2, "hidden_size": 256,
         "num_attention_heads": 4, "num_key_value_heads": 4, "head_dim": 64,
         "intermediate_size": 512, "vocab_size": 512, "norm": "layernorm",
         "norm_eps": 1e-5, "act": "silu", "mlp_glu": True,
         "rope_theta": 10000.0, "rope_fraction": 0.25,
         "attention_bias": False, "tie_word_embeddings": False,
         "reduced": []}

#: granite's equations (RMSNorm, ungated GELU, one key/value head) at the
#: port's granite smoke preset's widths
SMOKE_MQA = dict(SMOKE, name="smoke-mqa",
                 port={"arch": "granite-20b", "preset": "granite-smoke"},
                 num_key_value_heads=1, norm="rmsnorm", norm_eps=1e-6,
                 act="gelu_tanh", mlp_glu=False, rope_fraction=1.0)

#: DeepSeek-V2's equations (latent attention with a query low rank, routed
#: and shared experts after a dense first layer) at the widths of the
#: port's ``deepseek-smoke`` preset.  The harness registers it under a name
#: of its own from ``port.overrides`` (those widths, and a capacity factor
#: of n_experts / top_k, at which the MoE drops no token), and holds it to
#: ``port.fields``.  Its reference is the test's own (``reference``)
SMOKE_MLA_MOE = {
    "name": "smoke-mla-moe",
    "source": "https://huggingface.co/deepseek-ai/DeepSeek-V2",
    "port": {"arch": "deepseek-v2-236b", "preset": "deepseek-smoke-dropless",
             "overrides": {"n_layers": 2, "d_model": 256, "n_heads": 4,
                           "n_kv_heads": 4, "head_dim": 40, "d_ff": 512,
                           "vocab": 512, "n_experts": 4, "top_k": 2,
                           "n_shared_experts": 1, "d_ff_expert": 128,
                           "kv_lora_rank": 64, "q_lora_rank": 64,
                           "qk_nope_dim": 32, "qk_rope_dim": 16,
                           "v_head_dim": 32, "dtype": "float32",
                           "capacity_factor": 2.0},
             "fields": {"use_flash_attn": False, "capacity_factor": 2.0}},
    "reference": "port_forward", "dtype": "float32",
    "num_hidden_layers": 2, "hidden_size": 256, "num_attention_heads": 4,
    "intermediate_size": 512, "vocab_size": 512, "norm": "rmsnorm",
    "norm_eps": 1e-6, "act": "silu", "mlp_glu": True, "rope_theta": 10000.0,
    "tie_word_embeddings": False,
    "n_routed_experts": 4, "num_experts_per_tok": 2, "n_shared_experts": 1,
    "moe_intermediate_size": 128, "first_k_dense_replace": 1,
    "kv_lora_rank": 64, "q_lora_rank": 64, "qk_nope_head_dim": 32,
    "qk_rope_head_dim": 16, "v_head_dim": 32,
    "reduced": []}

#: per-layer metrics whose readers count a dense decoder's attention from
#: the file's ``num_key_value_heads`` and ``head_dim``: a cell of latent
#: attention does not join them
DENSE_READERS = ("mfu", "k5_roofline", "k6_roofline")

WORKLOAD = {"clients": 4, "slots": 4, "max_seq": 64,
            "prompt_tokens": {"median": 14, "sigma": 0.4, "min": 8,
                              "max": 24},
            "gen_tokens": {"median": 8, "sigma": 0.3, "min": 4, "max": 12},
            "first_gen": [1, 4], "size_seed": 1, "requests_per_client": 160,
            "check_requests": 3, "profile_seconds": 0.3,
            "limits": {"logit_gap_max": 0.001}}


def make(root: Path, config: dict = SMOKE, workload: Optional[dict] = None,
         cell: str = "smoke.chat", leave_out: Sequence[str] = ()) -> Path:
    """Copy the benchmark under ``root`` and add ``cell`` on ``config``; the
    cell joins no metric named in ``leave_out``.  -> ``root``."""
    root = Path(root)
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"),
                    dirs_exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfile = f"portbench/configs/{config['name']}.json"
    (root / cfile).write_text(json.dumps(config))
    wl = dict(WORKLOAD if workload is None else workload, name=cell)
    (root / "portbench/workloads" / f"{cell}.json").write_text(json.dumps(wl))
    bench["configs"].append({"name": config["name"], "source":
                             config["source"], "file": cfile, "reduced": [],
                             "why": "a CPU test's cell"})
    bench["workloads"].append({"name": cell, "config": config["name"],
                               "traffic": cell.split(".")[-1], "chips": 1,
                               "why": "a CPU test's cell"})
    # the cell joins the metrics of the cells the card paces, not their
    # suffixed splits (``tokens_per_s.host_paced``)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "." not in m["name"] and \
                m["name"] not in leave_out:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
