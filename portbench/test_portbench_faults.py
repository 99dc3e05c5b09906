"""The check against faults of the timed path, and the control, on a CPU
cell of the cells' shape of traffic.

Each fault breaks the program underneath a whole run (the harness's look
for a card is skipped: the run is on the CPU) and ``correct`` has to come
out false: a decode step that returns its state unchanged, half of the
slots left out of the step, a token altered where it is produced.  The
exchange between chips does not exist in these one-chip cells.

The control is the reference in fp8 put in the program's place: at the
cells' precision (bfloat16, here at smoke widths) the harness's check
refuses it, its widest gap far over the limit where the program's stays
far under it, as on the card at the cells' sizes (PERF.md lists those
readings)."""
import pytest
import torch

from portbench import harness, testcell

SEED = 2 ** 31 + 4093


def _run(root, seed=SEED, **kw):
    cell = harness.load_cell(root, "smoke.chat")
    return harness.run_cell(cell, seed, 0.5, False, "cpu",
                            log=lambda *a: None, min_answers=40, **kw)


def _unchanged(orig):
    def step(params, cfg, cache, token, active):
        return token
    return step


def _half(orig):
    def step(params, cfg, cache, token, active):
        out = orig(params, cfg, cache, token, active)
        h = out.shape[0] // 2
        return torch.cat([out[:h], token[h:]])
    return step


def _altered(orig):
    def greedy(logits):
        tok = orig(logits)
        return (tok + 1) % logits.shape[-1]
    return greedy


@pytest.mark.parametrize("fault,target", [
    (_unchanged, "serve_decode_step"),
    (_half, "serve_decode_step"),
    (_altered, "greedy"),
], ids=["state-unchanged", "half-the-slots", "token-altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault,
                                            target):
    from repro_torch.core.plan import clear_executable_cache
    from repro_torch.models import transformer
    root = testcell.make(tmp_path)
    base = _run(root)
    assert base["correct"], (base["check"], base["attempted"])
    clear_executable_cache()
    monkeypatch.setattr(transformer, target,
                        fault(getattr(transformer, target)))
    res = _run(root)
    assert not res["correct"]
    assert res["check"]["logit_gap_max"]["value"] > \
        res["check"]["logit_gap_max"]["limit"]


#: the port's stablelm smoke widths served in bfloat16
SMOKE_BF16 = dict(testcell.SMOKE, name="smoke-bf16", dtype="bfloat16", port={
    "arch": "stablelm-1.6b", "preset": "stablelm-smoke-bf16",
    "overrides": {"n_layers": 2, "d_model": 256, "n_heads": 4,
                  "n_kv_heads": 4, "head_dim": 64, "d_ff": 512, "vocab": 512,
                  "use_flash_attn": True, "dtype": "bfloat16"}})


def test_the_control_fails_where_the_program_passes(tmp_path):
    # the control stands in the program's place and the harness's own
    # check has to refuse it, on every seed, where the program passes
    wl = dict(testcell.WORKLOAD, check_requests=8,
              limits={"logit_gap_max": 0.1})
    root = testcell.make(tmp_path, SMOKE_BF16, wl)
    gaps, controls = [], []
    for seed in (SEED, SEED + 1, SEED + 2):
        res = _run(root, seed=seed, control=True)
        assert not res["correct"], res["check"]
        gaps.append(res["calibration"]["program_gap_max"])
        controls.append(res["check"]["logit_gap_max"]["value"])
        assert res["check"]["logit_gap_max"]["limit"] == 0.1
    assert max(gaps) * 3 < min(controls)
    assert max(gaps) < 0.1 < min(controls)
    assert _run(root, seed=SEED)["correct"]
