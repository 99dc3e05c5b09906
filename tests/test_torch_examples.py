"""The port's twins of the reference's examples (``examples_torch/``)
against the reference scripts (``examples/``), on the CPU.

Each reference script runs in a subprocess under ``JAX_PLATFORMS=cpu``
(all of a file's start at once, when the file's first test asks for
one); each twin's ``main([... "--device", "cpu"])`` runs in this process,
or in a fresh one where the printout shows what counts from process start
(element names, client ids), and returns its counters.  A twin must print what its script prints:
both printouts are compared line for line after masking the values that
depend on the weights (torch cannot draw ``jax.random``'s numbers) or on
the host's timing, and nothing else.  The counters the twin returns are
then held to the numbers the reference printed: frames, dispatches,
batched and sequential frames, failovers, redispatches, orphaned and
parked requests, lease expiries, sheds by reason and conservation totals.

This file holds the five offloading scripts; ``test_torch_examples_fleet.py``
the mesh, pub/sub, QoS and lossy fleets, ``test_torch_examples_e2e.py`` the
training and serving scripts.
"""
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
TWINS = os.path.join(ROOT, "examples_torch")
TWIN_NAMES = ("quickstart", "offloading_query", "batched_offloading",
              "failover_offloading", "augmented_worker",
              "sharded_offloading", "train_e2e", "serve_e2e",
              "multicam_pubsub", "multitenant_fleet", "lossy_fleet")


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop("XLA_FLAGS", None)
    return env


class References:
    """Every reference script of a file started at once; ``out(name)``
    waits for one and returns its stdout (the script must exit 0)."""

    def __init__(self, runs):
        self.procs = {name: subprocess.Popen(
            [sys.executable, os.path.join(EXAMPLES, name + ".py"), *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(), cwd=ROOT) for name, argv in runs.items()}
        self.done = {}

    def out(self, name):
        if name not in self.done:
            stdout, stderr = self.procs[name].communicate(timeout=600)
            assert self.procs[name].returncode == 0, stderr[-4000:]
            self.done[name] = stdout
        return self.done[name]

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


def load_twin(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(TWINS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_twin(name, argv, capsys):
    """-> (counters, stdout) of the twin's ``main`` on the CPU."""
    capsys.readouterr()
    counters = load_twin(name).main(list(argv) + ["--device", "cpu"])
    return counters, capsys.readouterr().out


def run_twin_fresh(name, argv):
    """The twin's ``main`` in a fresh process (ids and counters that count
    from process start, as the reference script's do) -> (counters,
    stdout without the counters line)."""
    code = (f"import json, sys; sys.path.insert(0, {TWINS!r}); "
            f"import {name} as t; c = t.main({list(argv) + ['--device', 'cpu']!r}); "
            f"print('COUNTERS=' + json.dumps(c))")
    env = _env()
    env["PYTHONPATH"] = env["PYTHONPATH"] + os.pathsep + TWINS
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    lines = p.stdout.splitlines()
    assert lines[-1].startswith("COUNTERS=")
    return json.loads(lines[-1][len("COUNTERS="):]), \
        "\n".join(lines[:-1]) + "\n"


def masked(text, masks=()):
    """The printout with every match of ``masks`` (regexes) replaced by
    ``<masked>``."""
    for m in masks:
        text = re.sub(m, "<masked>", text, flags=re.M)
    return text.splitlines()


def same_printout(twin, ref, masks=(), ok=True, port_only=()):
    """The two printouts are equal line for line once masked, and once
    ``port_only`` (what the port's launchers add: the device they run on)
    is cut from the twin's; with ``ok``, the script's last line is its
    ``OK`` line."""
    for m in port_only:
        twin = re.sub(m, "", twin, flags=re.M)
    got, want = masked(twin, masks), masked(ref, masks)
    diff = [f"twin: {a!r}\nref:  {b!r}" for a, b in zip(got, want) if a != b]
    assert got == want, "\n".join(diff) or (len(got), len(want))
    assert not ok or want[-1].startswith("OK"), want[-1]


def num(pattern, text, cast=int):
    """The first group of ``pattern`` in ``text``."""
    m = re.search(pattern, text, flags=re.M)
    assert m, pattern
    return cast(m.group(1))


@pytest.fixture(scope="module")
def refs():
    r = References({name: [] for name in (
        "quickstart", "offloading_query", "batched_offloading",
        "failover_offloading", "augmented_worker")})
    yield r
    r.close()


def test_every_reference_example_has_a_twin_of_the_same_name():
    scripts = sorted(f[:-3] for f in os.listdir(EXAMPLES)
                     if f.endswith(".py"))
    assert scripts == sorted(TWIN_NAMES)
    for name in TWIN_NAMES:
        mod = load_twin(name)
        assert callable(mod.main), name
        src = open(os.path.join(TWINS, name + ".py")).read()
        assert f"examples/{name}.py" in src and "--device" in src, name


def test_quickstart(refs):
    # a fresh process: elements without a name are numbered from process
    # start (``queue1``, ``videoconvert2`` ...) and the printout shows them
    c, out = run_twin_fresh("quickstart", [])
    ref = refs.out("quickstart")
    same_printout(out, ref, [r"class=\d+"])
    frames = re.findall(r"frame \d+: preview=(\(.*?\)) class=\d+ pts=(\d+)us",
                        ref)
    assert [(str(tuple(f["preview"])), str(f["pts"]))
            for f in c["frames"]] == frames
    assert c["links"] == len(re.findall(r"->", ref)) == 12


def test_offloading_query(refs, capsys):
    c, out = run_twin("offloading_query", [], capsys)
    ref = refs.out("offloading_query")
    same_printout(out, ref)
    assert c["frames"] == num(r"frames=(\d+) \(", ref) == 10
    assert c["frames_before"] == 5
    assert c["failovers"] == num(r"failovers=(\d+)", ref) == 1


def test_batched_offloading(refs, capsys):
    c, out = run_twin("batched_offloading", [], capsys)
    ref = refs.out("batched_offloading")
    same_printout(out, ref, [r"in \d+ms", r"tv0 last boxes: \[.*\]"])
    rows = re.findall(r"server dispatches: (\d+) \((\d+) frames batched, "
                      r"(\d+) sequential\)", ref)
    for (disp, batched, seq), batch in zip(rows, (8, 0)):
        got = c[batch]
        assert (got["dispatches"], got["batched_frames"],
                got["sequential_frames"]) == (int(disp), int(batched),
                                              int(seq))
        assert got["client_frames"] == [14] * 8
    assert c[8]["dispatches"] == 14 and c[0]["dispatches"] == 112


def test_failover_offloading(refs, capsys):
    c, out = run_twin("failover_offloading", [], capsys)
    ref = refs.out("failover_offloading")
    same_printout(out, ref)
    assert c["healthy"] == (num(r"primary served +(\d+) frames", ref),
                            num(r"backup +(\d+) —", ref))
    assert c["degraded"] == (
        num(r"— (\d+) orphaned requests", ref),
        num(r"\((\d+) redispatches\)", ref),
        num(r"backup now at +(\d+) frames", ref))
    assert c["degraded"][:2] == (3, 6)
    assert c["recovered"] == num(r"served +(\d+) of the last", ref) == 24
    assert c["lease_expiries"] == num(r"lease expiries: (\d+)", ref)
    assert c["parked_now"] == 0 and c["tv_frames"] == [12] * 6
    assert [label for _, label in c["chaos_log"]][0].startswith("kill")


def test_augmented_worker(refs, capsys):
    c, out = run_twin("augmented_worker", [], capsys)
    ref = refs.out("augmented_worker")
    same_printout(out, ref, [r"p\(correct\)=[0-9.]+", r"gate=\d+"])
    assert c["detect"] == num(r"detect=(\d+)", ref) == 8
    assert c["classify"] == num(r"classify=(\d+)", ref) == 8
    assert c["activation"] == ("activation signal received" in ref)
    assert c["verdict_shape"] == (1, 2)
