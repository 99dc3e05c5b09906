"""The one traffic generator: a cell's workload file -> every client's
requests.

A cell is a closed loop: ``clients`` devices, each with one request
outstanding, behind one hub of ``slots`` decode slots.  Client ``c`` sends
its request ``j`` the tick after its answer ``j - 1`` reached it.

The sizes come from the workload file alone, so that every seed asks for
the same work in the same order: client ``c``'s request ``j`` has the same
prompt length and the same gen in every run, drawn once from the file's
``size_seed``.  The run's seed draws the prompt tokens only, uniformly
over the vocabulary.

* ``prompt_tokens`` and ``gen_tokens`` are lognormal, ``{"median",
  "sigma", "min", "max"}``: the median of a published trace (the file's
  ``source``), rounded to whole tokens and clipped to ``[min, max]``;
* the first request's gen is uniform over ``first_gen``: the clients start
  part-way through a request, so the slot table starts desynchronised and
  the warm-up that waits for every first answer stays short.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

__all__ = ["Client", "lognormal", "sizes", "build", "prompt_string",
           "gen_string"]


@dataclass
class Client:
    prompts: List[np.ndarray]      # int32 token ids, one array a request
    gens: List[int]                # tokens to generate, one a request


def lognormal(rng: np.random.Generator, spec: dict, shape) -> np.ndarray:
    """Whole numbers ``round(median * exp(sigma * N))`` clipped to
    ``[min, max]``."""
    med, sig = float(spec["median"]), float(spec["sigma"])
    lo, hi = int(spec["min"]), int(spec["max"])
    if not (1 <= lo <= med <= hi) or sig < 0:
        raise ValueError(f"lognormal {spec}")
    x = np.rint(med * np.exp(sig * rng.standard_normal(shape)))
    return np.clip(x, lo, hi).astype(np.int64)


def sizes(wl: dict):
    """Prompt lengths and gens ``[clients, requests_per_client + 1]`` of
    workload ``wl``, the same for every seed."""
    n, k = int(wl["clients"]), int(wl["requests_per_client"])
    p, g = wl["prompt_tokens"], wl["gen_tokens"]
    flo, fhi = (int(v) for v in wl["first_gen"])
    if int(p["max"]) + max(int(g["max"]), fhi) > int(wl["max_seq"]):
        raise ValueError(f"{wl['name']}: prompt + gen exceeds max_seq")
    rng = np.random.default_rng([int(wl["size_seed"]), 0x512E])
    lens = lognormal(rng, p, (n, k + 1))
    gens = lognormal(rng, g, (n, k + 1))
    gens[:, 0] = rng.integers(flo, fhi + 1, size=n)
    return lens, gens


def build(wl: dict, vocab: int, seed: int) -> List[Client]:
    """The clients of workload ``wl`` (a parsed workload file) for a model
    of ``vocab`` tokens, their prompt tokens from ``seed``."""
    lens, gens = sizes(wl)
    rng = np.random.default_rng([int(seed), 0x7AFF1C])
    return [Client(prompts=[rng.integers(0, vocab, size=int(L),
                                         dtype=np.int64).astype(np.int32)
                            for L in row],
                   gens=[int(x) for x in grow])
            for row, grow in zip(lens, gens)]


def prompt_string(client: Client) -> str:
    """The ``prompts`` property of a ``token_prompt_src``."""
    return ";".join(",".join(map(str, p.tolist())) for p in client.prompts)


def gen_string(client: Client) -> str:
    """The ``gens`` property of a ``token_prompt_src``."""
    return ";".join(map(str, client.gens))
