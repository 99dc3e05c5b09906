"""The traffic generator: the same seed gives the same requests, and every
seed the same sizes in the same order with other tokens."""
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic

WORKLOADS = sorted((Path(__file__).parent / "workloads").glob("*.json"))
SEED = 2 ** 31 + 977


def _load(path):
    return json.loads(path.read_text())


@pytest.mark.parametrize("path", WORKLOADS, ids=lambda p: p.stem)
def test_same_seed_same_requests(path):
    wl = _load(path)
    a, b = traffic.build(wl, 49152, SEED), traffic.build(wl, 49152, SEED)
    assert len(a) == wl["clients"]
    for ca, cb in zip(a, b):
        assert ca.gens == cb.gens
        assert all(np.array_equal(x, y) for x, y in zip(ca.prompts,
                                                         cb.prompts))
    assert traffic.prompt_string(a[0]) == traffic.prompt_string(b[0])


@pytest.mark.parametrize("path", WORKLOADS, ids=lambda p: p.stem)
def test_seeds_share_sizes_and_order(path):
    # each client's k-th request has one size for every seed, so the work
    # inside a window is the seed's no more than the timing's
    wl = _load(path)
    a, b = traffic.build(wl, 1000, SEED), traffic.build(wl, 1000, SEED + 1)
    assert [[len(p) for p in c.prompts] for c in a] == \
        [[len(p) for p in c.prompts] for c in b]
    assert [c.gens for c in a] == [c.gens for c in b]
    assert not np.array_equal(a[0].prompts[1][:8], b[0].prompts[1][:8])
    assert len({len(p) for c in a for p in c.prompts}) > wl["clients"]


@pytest.mark.parametrize("path", WORKLOADS, ids=lambda p: p.stem)
def test_sizes_stay_in_their_ranges(path):
    wl = _load(path)
    pt, gt = wl["prompt_tokens"], wl["gen_tokens"]
    for c in traffic.build(wl, 777, SEED):
        assert len(c.prompts) == len(c.gens) == wl["requests_per_client"] + 1
        lo, hi = wl["first_gen"]
        assert lo <= c.gens[0] <= hi
        assert all(gt["min"] <= g <= gt["max"] for g in c.gens[1:])
        assert all(pt["min"] <= len(p) <= pt["max"] for p in c.prompts)
        assert all(len(p) + g <= wl["max_seq"]
                   for p, g in zip(c.prompts, c.gens))
        assert all(p.min() >= 0 and p.max() < 777 for p in c.prompts)


@pytest.mark.parametrize("path", WORKLOADS, ids=lambda p: p.stem)
def test_medians_are_the_sources(path):
    wl = _load(path)
    lens, gens = traffic.sizes(wl)
    assert np.median(lens) == pytest.approx(wl["prompt_tokens"]["median"],
                                            rel=0.1)
    assert np.median(gens[:, 1:]) == pytest.approx(
        wl["gen_tokens"]["median"], rel=0.15)
    assert "arXiv" in wl["source"]


def test_lognormal_rounds_and_clips():
    rng = np.random.default_rng(0)
    spec = {"median": 100, "sigma": 1.0, "min": 10, "max": 400}
    x = traffic.lognormal(rng, spec, 20000)
    assert x.dtype == np.int64 and x.min() == 10 and x.max() == 400
    assert np.median(x) == pytest.approx(100, rel=0.05)
    assert (traffic.lognormal(rng, dict(spec, sigma=0.0), 5) == 100).all()
    with pytest.raises(ValueError):
        traffic.lognormal(rng, dict(spec, min=0), 2)
    with pytest.raises(ValueError):
        traffic.sizes({"name": "x", "clients": 1, "requests_per_client": 1,
                       "prompt_tokens": spec, "gen_tokens": spec,
                       "first_gen": [1, 2], "size_seed": 0, "max_seq": 500})
