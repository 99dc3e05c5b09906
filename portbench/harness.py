"""One run of one cell: the program served through ``repro_torch``'s
Runtime under a closed loop of clients, the window timed on the host's
clock, and the answers judged against the plain reference.

Set-up builds one ``Runtime`` with a hub ``Device`` serving
``launch/model_serve.serve_pipeline(model=<preset>, slots, max_seq)`` and
one ``Device`` a client, each with the chain of ``client_pipeline``
(``token_prompt_src ! tensor_query_client ! appsink``).  The benchmark
draws every weight of the served tree from the seed, in place, on the
card.  Warm-up ticks until every client has its first answer (the first
tick prefills every first prompt, the next ones run the decode tick eagerly
and capture its graph); the window then calls ``Runtime.tick()`` for
``seconds`` on the benchmark's clock.

Everything of one configuration, one cell or one per-layer metric is a
file found by name: ``configs/<config>.json`` (through ``BENCHMARK.json``),
``workloads/<cell>.json``, ``metrics/<metric>.py`` and
``references/<reference>.py``.  So a cell of another kind of model comes
as new files alone:

* **The configuration file** names the program's serve preset
  (``port.preset``; with ``port.arch`` and ``port.overrides`` the harness
  registers it where the program has no preset of that name) and states
  the widths in Hugging Face's key names.  :func:`serve_preset` holds the
  preset to every key of :data:`_PORT_FIELDS` that the file states, and
  to each ``port.fields`` entry (a ``ModelConfig`` field and its value).
  Every file states :data:`_REQUIRED`, and :data:`_UNLESS_MLA` unless it
  states ``kv_lora_rank``.  A preset may depart from a dense
  global-attention flash decoder only in what the file states: routed
  experts with ``n_routed_experts``, latent attention with
  ``kv_lora_rank``, a layer pattern other than ``"G"`` or a window with
  ``sliding_window`` or ``port.fields.layer_pattern``, a logit softcap with
  ``port.fields.logit_softcap``, flash attention off with
  ``port.fields.use_flash_attn: false``.
* **The weights**: :func:`draw_weights` draws vectors, the embedding
  table, ``[d_in, d_out]`` matrices, and two kinds of rank-3 leaf at their
  fan-in's scale: routed experts' stacks ``[E, d_in, d_out]`` and latent
  attention's head tensors ``[fan_in, heads, d]``.  Any other leaf raises.
* **A per-layer metric** that sets ``PROGRAM_TRACE = True`` in its module
  turns the program's tracer (``repro_torch.core.trace``) on for the
  window of a ``--trace 1`` run and reads what it recorded, tick by tick,
  in :attr:`Reading.trace`.  Without such a metric the tracer stays off.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from . import tracing, traffic, yardstick

__all__ = ["Cell", "load_cell", "run_cell", "Reading", "FORBIDDEN", "quantity",
           "forbidden_modules", "draw_weights", "window_answers"]

#: top-level modules the process that prints a result may not hold: JAX
#: and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole: ``repro_torch`` is not
    ``repro``."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# the cell's files
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    root: Path                  # the checkout
    bench: dict                 # BENCHMARK.json
    entry: dict                 # its workloads entry
    config: dict                # configs/<config>.json
    wl: dict                    # workloads/<cell>.json
    per_layer: List[dict]       # BENCHMARK.json per_layer metrics of the cell
    end_to_end: List[dict]

    @property
    def name(self) -> str:
        return self.entry["name"]

    @property
    def bench_dir(self) -> Path:
        return self.root / self.bench["paths"][0]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """Find cell ``name`` and its files from ``root/BENCHMARK.json``."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(entries)}")
    entry = entries[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / cfgs[entry["config"]]["file"]).read_text())
    bench_dir = root / bench["paths"][0]
    wl = json.loads((bench_dir / "workloads" / f"{name}.json").read_text())
    return Cell(root=root, bench=bench, entry=entry, config=config, wl=wl,
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)])


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quantity(name: str) -> str:
    """What metric ``name`` measures: its name before the first dot.  A
    quantity is split by a suffix where cells of another pacing take
    bounds of their own (``tokens_per_s.host_paced``)."""
    return name.split(".")[0]


def load_metric(cell: Cell, name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    its quantity's ``metrics/<quantity>.py`` where there is none."""
    path = cell.bench_dir / "metrics" / f"{name}.py"
    if not path.exists():
        path = cell.bench_dir / "metrics" / f"{quantity(name)}.py"
    return _load_file(path, f"portbench_metric_{name.replace('.', '_')}")


def load_reference(cell: Cell):
    ref = cell.config["reference"]
    return _load_file(cell.bench_dir / "references" / f"{ref}.py",
                      f"portbench_reference_{ref}")


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

#: the configuration file's keys (Hugging Face's names) and the program's
#: ModelConfig fields that must agree, so that the preset serves what the
#: file states; each is compared where the file states it
_PORT_FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
                "num_attention_heads": "n_heads",
                "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
                "intermediate_size": "d_ff", "vocab_size": "vocab",
                "norm": "norm", "mlp_glu": "mlp_glu",
                "rope_theta": "rope_theta", "rope_fraction": "rope_frac",
                "attention_bias": "qkv_bias",
                "tie_word_embeddings": "tie_embeddings", "dtype": "dtype",
                # routed experts and latent attention (DeepSeek-V2's and
                # Mixtral's config.json)
                "n_routed_experts": "n_experts",
                "num_experts_per_tok": "top_k",
                "n_shared_experts": "n_shared_experts",
                "moe_intermediate_size": "d_ff_expert",
                "first_k_dense_replace": "first_dense",
                "kv_lora_rank": "kv_lora_rank", "q_lora_rank": "q_lora_rank",
                "qk_nope_head_dim": "qk_nope_dim",
                "qk_rope_head_dim": "qk_rope_dim",
                "v_head_dim": "v_head_dim", "sliding_window": "window"}
#: keys every configuration file states
_REQUIRED = ("num_hidden_layers", "hidden_size", "num_attention_heads",
             "intermediate_size", "vocab_size", "norm", "act", "mlp_glu",
             "rope_theta", "tie_word_embeddings", "dtype")
#: keys every file states unless it states ``kv_lora_rank`` (latent
#: attention has no key/value heads of its own)
_UNLESS_MLA = ("num_key_value_heads", "head_dim", "rope_fraction",
               "attention_bias")
_ACTS = {"silu": "silu", "gelu_tanh": "gelu"}


def _unstated(mc, config: dict, fields: dict) -> List[str]:
    """How preset ``mc`` departs from a dense global-attention flash
    decoder where the file does not state it."""
    kinds = {
        "routed experts": (mc.n_experts, "n_routed_experts" in config),
        "latent attention": (mc.mla, "kv_lora_rank" in config),
        "a layer pattern or window": (
            mc.layer_pattern != "G" or mc.window is not None,
            "sliding_window" in config or "layer_pattern" in fields),
        "a logit softcap": (mc.logit_softcap, "logit_softcap" in fields),
        "flash attention off": (not mc.use_flash_attn,
                                fields.get("use_flash_attn") is False)}
    return [k for k, (serves, stated) in kinds.items()
            if serves and not stated]


def serve_preset(config: dict) -> str:
    """Register the configuration's serve preset with the program where it
    is not one of the program's own, and check that it serves the
    configuration's widths and equations (the module docstring's rules)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import model_serve as ms
    from repro_torch.models.config import ModelConfig
    port = config["port"]
    key = port["preset"]
    required = _REQUIRED + (() if "kv_lora_rank" in config else _UNLESS_MLA)
    missing = [k for k in required if k not in config]
    if missing:
        raise ValueError(f"the configuration file of preset {key!r} does "
                         f"not state {missing}")
    fields = port.get("fields", {})
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    if set(fields) - known:
        raise ValueError(f"port.fields names {sorted(set(fields) - known)}, "
                         f"which ModelConfig lacks")
    if key not in ms.SERVE_MODELS:
        base = dataclasses.replace(get_config(port["arch"]),
                                   **port.get("overrides", {}))
        ms.register_serve_model(key, lambda: base)
    mc = ms.SERVE_MODELS[key]()
    diff = {k: (config[k], getattr(mc, f)) for k, f in _PORT_FIELDS.items()
            if k in config and config[k] != getattr(mc, f)}
    diff.update({f: (v, getattr(mc, f)) for f, v in fields.items()
                 if v != getattr(mc, f)})
    if _ACTS[config["act"]] != mc.act:
        diff["act"] = (config["act"], mc.act)
    unstated = _unstated(mc, config, fields)
    if unstated:
        diff["kind"] = (f"not a dense global-attention flash decoder, and "
                        f"the file does not state {', '.join(unstated)}")
    if diff:
        raise ValueError(f"preset {key!r} departs from the configuration "
                         f"file: {diff}")
    return key


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


#: rank-3 leaves by the last two parts of their path, and the axis of
#: their fan-in: routed experts' stacks ``[E, d_in, d_out]``
#: (``models/moe.py`` ``_expert_weights``) and latent attention's head
#: tensors ``[fan_in, heads, d]`` (``models/mla.py`` ``_heads_init``)
_FAN_IN_AXIS = {"moe/w_up": 1, "moe/w_gate": 1, "moe/w_down": 1,
                "attn/w_uk": 0, "attn/w_uv": 0, "attn/w_uq": 0,
                "attn/w_q": 0}


@torch.no_grad()
def draw_weights(tree: dict, seed: int):
    """Overwrite every leaf of the served weight tree in place, from
    ``seed``, on the leaves' device and in their dtype, in the order of
    their sorted paths: norm scales ``1 + 0.1 N``, other vectors ``0.1
    N``, the embedding table ``0.02 N``, each ``[d_in, d_out]`` matrix ``N
    / sqrt(d_in)``, each rank-3 leaf of :data:`_FAN_IN_AXIS` ``N /
    sqrt(fan_in)``."""
    leaves = list(_leaves(tree))
    g = torch.Generator(device=leaves[0][1].device)
    g.manual_seed(int(np.random.SeedSequence([int(seed), 0x3E16]).
                      generate_state(1, np.uint64)[0] >> 1))
    for path, t in leaves:
        if t.dim() == 1:
            if path.endswith("/scale"):
                t.normal_(1.0, 0.1, generator=g)
            else:
                t.normal_(0.0, 0.1, generator=g)
        elif path.endswith("/tok"):
            t.normal_(0.0, 0.02, generator=g)
        elif t.dim() == 2:
            t.normal_(0.0, t.shape[0] ** -0.5, generator=g)
        else:
            axis = _FAN_IN_AXIS.get("/".join(path.split("/")[-2:]))
            if t.dim() != 3 or axis is None:
                raise ValueError(f"weight leaf {path} of shape "
                                 f"{tuple(t.shape)}")
            t.normal_(0.0, t.shape[axis] ** -0.5, generator=g)


def _client_pipeline(client: traffic.Client):
    """``launch/model_serve.client_pipeline``'s chain, with the prompt
    source made directly: ``parse_launch`` tokenises a property with
    ``shlex`` at ~13 us a character (10 s for one client of long
    prompts), the source's constructor splits the same string."""
    from repro_torch.core import parse_launch
    from repro_torch.core.modelserve import TokenPromptSrc
    from repro_torch.core.pipeline import Pipeline
    pipe = Pipeline()
    pipe.add(TokenPromptSrc(name="src", prompts=traffic.prompt_string(client),
                            gens=traffic.gen_string(client)))
    return parse_launch("src. ! tensor_query_client operation=lm codec=none "
                        "name=qc ! appsink name=res", pipeline=pipe)


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

@dataclass
class Request:
    client: int
    index: int
    prompt: np.ndarray
    gen: int
    sent: int                       # tick it left its client
    answered: Optional[int] = None  # tick its answer reached the appsink
    tokens: Optional[np.ndarray] = None
    error: bool = False


@dataclass
class Reading:
    """What a per-layer metric reads (``metrics/<name>.py``'s ``read``).

    Tick lists hold the ticks of the window outside the profiled stretch
    (``steady``) and inside it (``stretch.ticks``).  Per tick: its host
    seconds, the batcher's prefill and decode host seconds and counts, the
    prompt lengths prefilled and the cache positions of the streams that
    took a decode step.

    ``trace`` is set where a metric of the cell sets ``PROGRAM_TRACE``: per
    tick, what ``repro_torch.core.trace.drain()`` returned after that tick
    of the window (its spans and request intervals, unchanged), ``None``
    for the ticks before the window; ``trace_dropped`` counts the records
    the tracer dropped in the window (``TRACER.dropped``).  Elsewhere
    ``trace`` is ``None`` and the tracer stays off."""
    config: dict
    wl: dict
    steady: List[int]
    tick_s: List[float]
    prefill_s: List[float]
    prefills: List[int]
    decode_s: List[float]
    decode_times: List[List[float]]
    prefill_lengths: List[List[int]]
    decode_positions: List[List[int]]
    peak_bytes: int
    stretch: Optional[tracing.Stretch] = None
    trace: Optional[List[Optional[tuple]]] = None
    trace_dropped: int = 0


class _Ticks:
    """Per-tick records: host clock and the batcher's counters."""

    def __init__(self, batcher):
        self.b = batcher
        self.start: List[float] = []
        self.end: List[float] = []
        self.prefill_s: List[float] = []
        self.prefills: List[int] = []
        self.decode_s: List[float] = []
        self.decode_times: List[List[float]] = []
        self.active: List[int] = []

    def tick(self, rt, span: Callable):
        b = self.b
        p_s, p_n, d_s, d_n, a_n = (b.prefill_seconds, b.prefills,
                                   b.decode_seconds, len(b.decode_times),
                                   b.batched_frames)
        t0 = time.perf_counter()
        with span("tick"):
            rt.tick()
        t1 = time.perf_counter()
        self.start.append(t0)
        self.end.append(t1)
        self.prefill_s.append(b.prefill_seconds - p_s)
        self.prefills.append(b.prefills - p_n)
        self.decode_s.append(b.decode_seconds - d_s)
        self.decode_times.append(list(b.decode_times[d_n:]))
        self.active.append(b.batched_frames - a_n)
        return len(self.start) - 1


def _poll(runs, clients, reqs, seen, errs, tick: int) -> int:
    """Record the answers and error frames that reached each client's
    appsink in ``tick``; the client's next request leaves the next tick.
    -> how many arrived."""
    n = 0
    for c, run in enumerate(runs):
        log = run.sink_log.get("res", [])
        elog = run.sink_log.get("qc.error", [])
        new = [(a, False) for a in log[seen[c]:]] + \
            [(None, True) for _ in elog[errs[c]:]]
        seen[c], errs[c] = len(log), len(elog)
        for ans, err in new:
            r = reqs[c][-1]
            r.answered, r.error = tick, err
            if ans is not None:
                r.tokens = np.asarray(ans.tensors[0]).astype(np.int64)
            j = r.index + 1
            cl = clients[c]
            reqs[c].append(Request(c, j, cl.prompts[j % len(cl.prompts)],
                                   cl.gens[j % len(cl.gens)], tick + 1))
            n += 1
    return n


def _work(reqs, n_ticks: int):
    """Prompt lengths prefilled and cache positions decoded, per tick.  A
    request is prefilled the tick it left; its ``gen - 1`` decode steps
    are consecutive ticks ending in the tick of its answer (from its
    admission on, a stream decodes every tick), or from the tick it left
    while it is still in flight."""
    pre = [[] for _ in range(n_ticks)]
    dec = [[] for _ in range(n_ticks)]
    for rs in reqs:
        for r in rs:
            if r.sent >= n_ticks or r.error:
                continue
            L = len(r.prompt)
            pre[r.sent].append(L)
            steps = r.gen - 1
            first = r.sent if r.answered is None else r.answered - steps + 1
            for k in range(steps):
                t = first + k
                if 0 <= t < n_ticks:
                    dec[t].append(L + k)
    return pre, dec


def window_answers(reqs: List[List[Request]], start: List[float],
                   end: List[float], first: int, last: int):
    """Every request whose answer or error frame reached its client in
    ticks ``first..last - 1``, those with answers, each answer's latency
    (ms, from the start of the tick its request left to the end of the
    tick its answer arrived) and the answers' tokens.  -> (done, answers,
    latencies, tokens)."""
    done = [r for rs in reqs for r in rs
            if r.answered is not None and first <= r.answered < last]
    answers = [r for r in done if not r.error]
    lat = [(end[r.answered] - start[r.sent]) * 1e3 for r in answers]
    return done, answers, lat, sum(len(r.tokens) for r in answers)


def _gaps(weights, cell: Cell, sample: List[Request], device,
          control: bool):
    """Widest gap by which a served token's reference logit lies below the
    reference's best, over the sample; with ``control``, the same gap of
    the token the control's logits put first."""
    ref = load_reference(cell)
    seqs, starts = [], []
    for r in sample:
        full = np.concatenate([r.prompt.astype(np.int64), r.tokens[:-1]])
        seqs.append(torch.as_tensor(full, device=device))
        starts.append(len(r.prompt) - 1)
    out = ref.served_logits(weights, cell.config, seqs, starts,
                            control=control)
    vocab = cell.config["vocab_size"]
    gap, cgap = 0.0, 0.0
    for r, (lg, cl) in zip(sample, out):
        tok = torch.as_tensor(r.tokens, device=lg.device)
        if lg.shape[0] != len(tok) or bool((tok < 0).any()) or \
                bool((tok >= vocab).any()):
            return float("inf"), None
        best = lg.max(-1).values
        gap = max(gap, float((best - lg.gather(1, tok[:, None])[:, 0]).max()))
        if cl is not None:
            pick = cl.argmax(-1)
            cgap = max(cgap, float((best - lg.gather(1, pick[:, None])[:, 0])
                                   .max()))
    return gap, (cgap if control else None)


def _slowdown(ticks: _Ticks, steady: List[int], traced: List[int]):
    """How much slower the profiled stretch's ticks ran than the window's
    other ticks: the batcher's decode tick (the graph replay that CUPTI
    traces kernel by kernel) and the tick less its prefills, mean ms of
    each and the stretch's excess in %."""
    def mean_ms(ts, of):
        v = [x for t in ts for x in of(t)]
        return 1e3 * sum(v) / len(v) if v else None

    out = {}
    for key, of in (("decode_tick_ms", lambda t: ticks.decode_times[t]),
                    ("tick_less_prefills_ms",
                     lambda t: [ticks.end[t] - ticks.start[t] -
                                ticks.prefill_s[t]])):
        a, b = mean_ms(steady, of), mean_ms(traced, of)
        out[key] = {"steady": a, "traced": b,
                    "slowdown_pct": None if not a or b is None
                    else (b / a - 1.0) * 100.0}
    return out


@dataclass
class Served:
    """What a run of the program leaves for the metrics and the check:
    the requests, the per-tick records, the window's bounds, and the
    weights (the program's state is gone by then)."""
    clients: List[traffic.Client]
    reqs: List[List[Request]]
    ticks: _Ticks
    first: int
    last: int
    setup_s: float
    w0: float
    w1: float
    peak: int
    weights: dict
    stretch: Optional[tracing.Stretch]
    trace: Optional[List[Optional[tuple]]] = None
    trace_dropped: int = 0


def _serve(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
           t_start: float, log, min_answers: int,
           program_trace: bool = False) -> Served:
    """Set-up, warm-up and the window.  Every object of the program made
    here is dropped when this returns, but the weight tree.  With
    ``program_trace`` the program's tracer records the window, drained
    after every tick (:class:`Reading`)."""
    from repro_torch.launch import model_serve as ms
    from repro_torch.runtime import Device, Runtime
    wl, cfg = cell.wl, cell.config
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    log(f"portbench: imports done at {time.perf_counter() - t_start:.2f} s")
    preset = serve_preset(cfg)
    clients = traffic.build(wl, cfg["vocab_size"], seed)
    rt = Runtime(device=device)
    hub = Device("hub", device=device)
    srv = hub.add_pipeline(ms.serve_pipeline(
        model=preset, slots=int(wl["slots"]), max_seq=int(wl["max_seq"])))
    elem = srv.pipe.elements["lm"]
    weights = srv.params["lm"]
    draw_weights(weights, seed)
    rt.add_device(hub)
    runs = []
    for c, cl in enumerate(clients):
        d = Device(f"c{c}", device=device)
        runs.append(d.add_pipeline(_client_pipeline(cl)))
        rt.add_device(d)
    batcher = next(iter(rt._batchers.values()))
    reqs = [[Request(c, 0, cl.prompts[0], cl.gens[0], 0)]
            for c, cl in enumerate(clients)]
    seen, errs = [0] * len(runs), [0] * len(runs)

    spans = {"on": None}

    def span(kind):
        on = spans["on"]
        return nullcontext() if on is None else tracing.Span(on, kind)

    if trace:
        def traced(kind, fn):
            def call(*a, **k):
                with span(kind):
                    return fn(*a, **k)
            return call
        elem.host_prefill = traced("prefill", elem.host_prefill)
        batcher._decode_tick = traced("decode", batcher._decode_tick)

    if trace and cuda:
        # the profiler's first start initialises CUPTI for seconds: do it
        # here, so that the stretch in the window starts at once
        tracing.stop(tracing.start(cuda), tracing.Stretch())
    log(f"portbench: program built and weights drawn at "
        f"{time.perf_counter() - t_start:.2f} s")
    ticks = _Ticks(batcher)
    limit = 4 * (int(wl["first_gen"][1]) + 8)
    while len(ticks.start) < 3 or any(len(r) < 2 for r in reqs):
        if len(ticks.start) > limit:
            raise RuntimeError(f"warm-up: a first answer missing after "
                               f"{limit} ticks")
        t = ticks.tick(rt, span)
        _poll(runs, clients, reqs, seen, errs, t)
        if t == 0:
            log(f"portbench: first tick ({ticks.prefills[0]} prefills) "
                f"ended at {time.perf_counter() - t_start:.2f} s")
    sync()
    setup_s = time.perf_counter() - t_start
    first = len(ticks.start)
    log(f"portbench: {cell.name} seed {seed}: set-up {setup_s:.2f} s, "
        f"{first} warm-up ticks")

    # set-up's objects leave the collector's generations, so a collection
    # in the window scans what the window makes
    gc.collect()
    gc.freeze()
    stretch, prof, p0 = None, None, 0.0
    prof_s = float(wl["profile_seconds"])
    lead = max(0.0, (seconds - prof_s) / 2)
    tracer, program, dropped = None, None, 0
    if program_trace:
        from repro_torch.core import trace as tracer
        tracer.drain()
        program, dropped = [None] * first, tracer.TRACER.dropped
        tracer.enable()
    w0 = time.perf_counter()
    got = 0
    try:
        while time.perf_counter() - w0 < seconds or got < min_answers:
            if trace and stretch is None and \
                    time.perf_counter() - w0 >= lead:
                sync()
                stretch = tracing.Stretch()
                q0 = time.perf_counter()
                prof = tracing.start(cuda)
                spans["on"] = stretch
                p0 = time.perf_counter()
                log(f"portbench: profiler started in {p0 - q0:.3f} s at "
                    f"{q0 - w0:.3f} s of the window")
                stretch.t0_ns = time.time_ns()
            t = ticks.tick(rt, span)
            if tracer is not None:
                program.append(tracer.drain())
            got += _poll(runs, clients, reqs, seen, errs, t)
            if prof is not None:
                stretch.ticks.append(t)
                did = sum(ticks.prefills[i] for i in stretch.ticks)
                now = time.perf_counter()
                if (now - p0 >= prof_s and did > 0) or now - w0 >= seconds:
                    sync()
                    stretch.t1_ns = time.time_ns()
                    stretch.seconds = time.perf_counter() - p0
                    spans["on"] = None
                    tracing.stop(prof, stretch)
                    prof = None
    finally:
        if tracer is not None:
            tracer.disable()
            dropped = tracer.TRACER.dropped - dropped
    w1 = time.perf_counter()
    sync()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ticks.b = None
    gc.unfreeze()
    return Served(clients=clients, reqs=reqs, ticks=ticks, first=first,
                  last=len(ticks.start), setup_s=setup_s, w0=w0, w1=w1,
                  peak=int(peak), weights=weights, stretch=stretch,
                  trace=program, trace_dropped=dropped)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             control: bool = False, log=None, min_answers: int = 0) -> dict:
    """One run of ``cell``: set-up, warm-up, the window, and the check.
    -> the result line's object (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, ``breakdown`` with ``trace``, ``check``
    last, ``profiler`` before it with ``trace``).  With ``control`` the
    control stands in the program's place in the check (the reference in
    fp8: the tokens it puts first are judged), and the program's own
    widest gap goes under ``calibration``.
    ``min_answers`` holds the window open past ``seconds`` until that many
    answers arrived: the CPU tests' runs, whose host may be loaded, size
    their windows by work (the benchmark's runs pass 0)."""
    from repro_torch.core.plan import clear_executable_cache
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    wl = cell.wl
    cuda = device == "cuda"
    readers = {m["name"]: load_metric(cell, m["name"])
               for m in cell.per_layer} if trace else {}
    s = _serve(cell, seed, seconds, trace, device, t_start, log, min_answers,
               any(getattr(r, "PROGRAM_TRACE", False)
                   for r in readers.values()))
    clear_executable_cache()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ticks, first, last, reqs = s.ticks, s.first, s.last, s.reqs

    # -- the end-to-end metrics ------------------------------------------------
    done, answers, lat, tokens = window_answers(reqs, ticks.start, ticks.end,
                                                first, last)
    metrics = {}
    if not trace:
        values = {"tokens_per_s": (tokens / (s.w1 - s.w0), "tokens/s"),
                  "latency_p95_ms": (yardstick.percentile(lat, 95), "ms"),
                  "setup_s": (s.setup_s, "s")}
        for m in cell.end_to_end:
            v, unit = values[quantity(m["name"])]
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": unit}

    # -- the per-layer metrics -------------------------------------------------
    breakdown, dev_extra, profiler = None, {}, None
    if trace:
        pre, dec = _work(reqs, last)
        off = sum(1 for t in range(first, last)
                  if ticks.active[t] != len(dec[t]))
        log(f"portbench: {off} window ticks whose attributed decode steps "
            f"differ from the batcher's active slots")
        in_stretch = set(s.stretch.ticks) if s.stretch else set()
        reading = Reading(
            config=cell.config, wl=wl,
            steady=[t for t in range(first, last) if t not in in_stretch],
            tick_s=[e - b for b, e in zip(ticks.start, ticks.end)],
            prefill_s=ticks.prefill_s, prefills=ticks.prefills,
            decode_s=ticks.decode_s, decode_times=ticks.decode_times,
            prefill_lengths=pre, decode_positions=dec, peak_bytes=s.peak,
            stretch=s.stretch, trace=s.trace, trace_dropped=s.trace_dropped)
        for m in cell.per_layer:
            v = readers[m["name"]].read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if s.stretch is not None and s.stretch.ops:
            st = s.stretch
            log(f"portbench: stretch of {len(st.ticks)} ticks, "
                f"{st.seconds:.3f} s of host clock, "
                f"{(st.t1_ns - st.t0_ns) / 1e9:.3f} s traced; "
                f"{sum(max(0, min(e, st.t1_ns) - max(b, st.t0_ns)) for _, b, e in st.ops) / 1e9:.4f} s of "
                f"{sum(e - b for _, b, e in st.ops) / 1e9:.4f} s of device "
                f"operations inside the stretch's clock; "
                f"{sum(ticks.prefills[t] for t in st.ticks)} prefills, "
                f"{sum(len(ticks.decode_times[t]) for t in st.ticks)} decode "
                f"ticks; {len(st.ops)} device operations, "
                f"{sum('prefill' in o[0] for o in st.ops)} named *prefill*, "
                f"{sum('decode' in o[0] for o in st.ops)} named *decode*")
            profiler = _slowdown(ticks, reading.steady, st.ticks)
            log(f"portbench: profiler: {profiler}")
            breakdown = tracing.breakdown(s.stretch)
            dev_extra = {"busy_s": tracing.busy_seconds(s.stretch),
                         "window_s": (s.stretch.t1_ns -
                                      s.stretch.t0_ns) / 1e9}

    # -- the check: every window answer, and a sample against the reference
    wrong_len = sum(1 for r in answers if len(r.tokens) != r.gen)
    n_err = sum(1 for r in done if r.error)
    repeats = sum(1 for c, rs in enumerate(reqs)
                  if rs[-1].index >= len(s.clients[c].prompts))
    ok = [r for r in answers if len(r.tokens) == r.gen]
    sample = []
    if ok:
        rng = np.random.default_rng([int(seed), 0x5A3])
        longest = max(ok, key=lambda r: (len(r.tokens), -r.client, -r.index))
        rest = [r for r in ok if r is not longest]
        k = min(len(rest), int(wl["check_requests"]) - 1)
        picks = rng.choice(len(rest), size=k, replace=False) if k else []
        sample = [longest] + [rest[i] for i in sorted(picks)]
    n_served = sum(len(r.tokens) for r in sample)
    t_ref = time.perf_counter()
    gap, cgap = _gaps(s.weights, cell, sample, device, control) if sample \
        else (float("inf"), None)
    ref_s = time.perf_counter() - t_ref
    # with ``control`` the control stands in the program's place: the check
    # judges the tokens it puts first, and has to come out not correct
    judged = cgap if control and cgap is not None else gap
    limit = wl["limits"]["logit_gap_max"]
    check = {"logit_gap_max": {"value": judged, "limit": limit},
             "wrong_lengths": {"value": wrong_len, "limit": 0},
             "error_frames": {"value": n_err, "limit": 0},
             "repeated_prompts": {"value": repeats, "limit": 0},
             "answers_at_least": {"value": len(answers), "limit": 1}}
    correct = judged <= limit and wrong_len == 0 and n_err == 0 and \
        repeats == 0 and len(answers) >= 1
    log(f"portbench: window {s.w1 - s.w0:.3f} s, {last - first} ticks, "
        f"{len(answers)} answers, {tokens} tokens; reference over "
        f"{len(sample)} requests, {n_served} served tokens, {ref_s:.2f} s")
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    result = {"correct": bool(correct), "attempted": len(done),
              "failed": n_err + wrong_len, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": 1, "memory_peak_bytes": s.peak,
                         **dev_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if profiler is not None:
        result["profiler"] = profiler
    if control:
        result["calibration"] = {"program_gap_max": gap,
                                 "served_tokens": n_served}
    result["check"] = check
    return result
