"""The frozen arithmetic against hand counts at one shape of each
configuration, and the statistics every cell's metrics use."""
import json
import statistics
from pathlib import Path

import numpy as np
import pytest

from portbench import yardstick

CONFIGS = Path(__file__).parent / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_granite_counts_by_hand():
    c = _cfg("granite-20b")
    # q 6144x6144, k and v 6144x128 each, o 6144x6144, MLP up and down
    # 6144x24576: 52 layers' projections
    per_layer = 6144 * 6144 * 2 + 2 * 6144 * 128 + 2 * 6144 * 24576
    assert yardstick.layer_matmul_params(c) == per_layer == 379_060_224
    L = 512
    attn = 2 * 48 * (L * (L + 1) // 2) * 2 * 128
    assert yardstick.prefill_flops(c, L) == \
        52 * (2 * L * per_layer + attn) + 2 * 6144 * 49152
    assert yardstick.decode_flops(c, 700) == \
        52 * (2 * per_layer + 2 * 48 * 701 * 2 * 128) + 2 * 6144 * 49152
    # K5 at L = 512: q/k/v/o bytes and the causal pairs; bound by bytes
    fl, nb = yardstick.attention_count(48, L, L, 128, 128, 48, True,
                                       "bfloat16")
    assert nb == (48 * L * 256 + 1 * L * 256) * 2
    assert fl == 2 * 48 * (L * (L + 1) // 2) * 256
    assert yardstick.bound_s(fl, nb, "bfloat16") == pytest.approx(
        max(fl / 989e12, nb / 3.35e12))
    # K6 at 64 slots, 40,000 cache rows read, one kv head
    fl, nb = yardstick.decode_count(64, 48, 1, 128, 128, 40_000, "bfloat16")
    assert nb == 64 * 48 * 256 * 2 + 64 * 4 + 40_000 * 256 * 2
    assert fl == 2 * 40_000 * 48 * 256


def test_stablelm_counts_by_hand():
    c = _cfg("stablelm-1.6b")
    per_layer = 4 * 2048 * 2048 + 3 * 2048 * 5632
    assert yardstick.layer_matmul_params(c) == per_layer
    assert yardstick.prefill_flops(c, 300) == \
        24 * (2 * 300 * per_layer + 2 * 32 * (300 * 301 // 2) * 128) + \
        2 * 2048 * 100352
    fl, nb = yardstick.decode_count(64, 32, 32, 64, 64, 1000, "bfloat16")
    assert nb == 64 * 32 * 128 * 2 + 64 * 4 + 1000 * 32 * 128 * 2


def test_percentile_is_over_every_value():
    xs = np.random.default_rng(3).exponential(size=537).tolist()
    for q in (50, 95, 99):
        assert yardstick.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)))
    assert yardstick.percentile([], 95) is None
    assert yardstick.percentile([7.0], 95) == 7.0


def test_quartile_spread_follows_statistics():
    xs = [10.0, 10.2, 9.9, 10.4, 10.1, 9.8]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert yardstick.quartile_spread(xs) == pytest.approx((q3 - q1) / med)
