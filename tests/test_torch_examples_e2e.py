"""Twins of ``examples/train_e2e.py`` and ``examples/serve_e2e.py`` against
the reference scripts, on the CPU (the method: ``test_torch_examples.py``).

Training runs 100 steps in both (the script's default is 300): the same
launcher printout but for the losses, gradient norms and timings, the
same step count, a falling loss and one checkpoint at step 100 in a
fresh directory each.  Serving runs the full mamba2-130m at the script's
defaults (8 requests, 32-token prompts, 16 tokens each): every request
answered in both.
"""
import pytest

from test_torch_examples import References, num, run_twin, same_printout

TRAIN_STEPS = 100


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ref_ckpt")
    r = References({"train_e2e": ["--steps", str(TRAIN_STEPS),
                                  "--ckpt-dir", str(ckpt)],
                    "serve_e2e": []})
    yield r
    r.close()


def test_train_e2e(refs, capsys, tmp_path):
    c, out = run_twin("train_e2e", ["--steps", str(TRAIN_STEPS),
                                    "--ckpt-dir", str(tmp_path)], capsys)
    ref = refs.out("train_e2e")
    same_printout(out, ref, [r"loss=[0-9.]+", r"ce=[0-9.]+",
                             r"gnorm=[0-9.]+", r"\d+ ms/step \d+ tok/s",
                             r"loss [0-9.]+ -> [0-9.]+",
                             r"checkpoints in .*$"],
                  port_only=[r" device=\S+$"])
    assert c["steps"] == num(r"over (\d+) steps", ref) == TRAIN_STEPS
    assert c["last_loss"] < c["first_loss"]
    assert num(r"loss [0-9.]+ -> ([0-9.]+)", ref, float) < \
        num(r"loss ([0-9.]+) ->", ref, float)
    assert c["latest_checkpoint"] == TRAIN_STEPS


def test_serve_e2e(refs, capsys):
    c, out = run_twin("serve_e2e", [], capsys)
    ref = refs.out("serve_e2e")
    same_printout(out, ref,
                  [r"tokens in [0-9.]+s \([0-9.]+ tok/s batched\)"],
                  port_only=[r" on \S+$"])
    assert c["answered"] == num(r"(\d+)/\d+ requests answered", ref) == 8
    assert c["tokens"] == num(r"answered, (\d+) tokens", ref) == 128
