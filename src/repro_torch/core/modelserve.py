"""Model serving elements — a real autoregressive LM behind the query fabric.

Port of ``ModelServeElement``, ``ModelServeStageElement``,
``TokenPromptSrc`` and the preset registry of
``src/repro/core/modelserve.py``.  ``model_serve`` sits behind
``tensor_query_serversrc ! model_serve ! tensor_query_serversink``; its
decode state is PLAN STATE — a slot-stacked KV cache plus active / token /
remaining lanes — carried across ticks in the pipeline state dict, and
requests join and leave the decode batch mid-generation as data.

Differences from the JAX package, same results:

* The decode tick computes all S slots at once as one batch-S decode
  (``transformer.serve_decode_step``) with a per-slot position vector,
  where JAX vmaps a b=1 ``lm_decode`` over slots.  ``sequential_decode``
  (launch/model_serve.py) drives the same S-wide step with one active slot,
  so every GEMM has the same shape and continuous == sequential bitwise.
* The slot state is updated IN PLACE on the device: an admitted stream's
  prefilled cache (kept on the device since its prefill) is copied into its
  slot rows with ``index_copy_``, leaf by leaf (every layer's cache has the
  same keys in the same order wherever it is made: ``{"k", "v"}`` for an
  attention layer, ``{"h", "conv"}`` for a recurrent one), as are its
  token, budget and active lanes (:meth:`ModelServeElement.admit`), and
  each decode step writes every slot's new K/V row at that slot's own
  position and advances every slot's recurrent state.  JAX assembles
  admit bundles on the host and selects ``where(mask, new, old)`` over the
  whole cache.  The batcher admits before the tick, outside the cached
  executable, so the captured tick has one shape.
  Inactive slots may be written or advanced with values nobody reads: a
  slot's rows and state are replaced wholesale, every leaf, when a stream
  is admitted into it.
* ``model_serve_stage`` (one layer slice of a pipeline-parallel chain,
  DESIGN.md §8) keeps boundary activations and its caches on the device,
  admits parked caches eagerly before its graphed hop as the decode tick
  does, and replays a parked stream's steps at the serve batch in the
  stream's own slot row (:meth:`ModelServeStageElement.host_stage_decode`)
  where JAX replays at batch 1: a batch-1 GEMM need not be bitwise a row
  of a batch-S one, and on the card it is not (chip_smoke phase 11b).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List

import torch

from .buffers import StreamBuffer, tree_flatten
from .element import Element, PipelineContext, register_element
from .formats import Caps

__all__ = ["ModelServeElement", "ModelServeStageElement", "TokenPromptSrc",
           "SERVE_MODELS", "register_serve_model"]

# Preset registry: ``model_serve model=<key>`` resolves through here.
# Values are zero-arg callables returning a ModelConfig.
SERVE_MODELS: Dict[str, Callable] = {}


def register_serve_model(key: str, cfg_fn: Callable):
    SERVE_MODELS[key] = cfg_fn
    return cfg_fn


def _stack_caches(caches) -> List[torch.Tensor]:
    """Batch-1 caches stacked along the slot axis on the device: ``pos``,
    then each layer leaf in the order every cache keeps them."""
    cols = zip(*[tree_flatten(c["layers"])[0] for c in caches])
    return [torch.cat([c["pos"] for c in caches])] + \
        [col[0] if len(col) == 1 else torch.cat(col) for col in cols]


def _copy_rows(cache: dict, slots: torch.Tensor, pos, leaves):
    """Copy stacked caches (:func:`_stack_caches`) into the ``slots`` rows
    of a batch-S cache, in place, ``pos`` included."""
    cache["pos"].index_copy_(0, slots, pos)
    for d, src in zip(tree_flatten(cache["layers"])[0], leaves):
        d.index_copy_(0, slots, src)


def _default_presets():
    if "stablelm-smoke-flash" not in SERVE_MODELS:
        def _stablelm():
            import dataclasses
            from ..configs import stablelm_1_6b
            return dataclasses.replace(stablelm_1_6b.config().smoke(),
                                       use_flash_attn=True)
        SERVE_MODELS["stablelm-smoke-flash"] = _stablelm


@register_element("model_serve")
class ModelServeElement(Element):
    """Autoregressive decode as plan state with continuous batching.

    Props: ``model`` (SERVE_MODELS key), ``slots`` (decode-batch capacity
    S), ``max_seq`` (KV-cache length; prompt + generation must fit).

    State: ``cache`` (batch-S decode cache, ``pos`` int32 [S]), ``active``
    bool [S], ``token`` int32 [S] (next decode input), ``remaining`` int32
    [S].

    Input frame (injected by the batcher): ``(slots, token, remaining,
    *cache_leaves)`` for the streams joining this tick, or ``()`` with
    ``meta={"empty": True}`` when nobody joins.  Output frame: ``(token,
    emitted, finished)``, each [S], on the device.
    """

    is_stream_serve = True

    def __init__(self, name=None, model="stablelm-smoke-flash", slots=8,
                 max_seq=64, **props):
        super().__init__(name=name, **props)
        self.model = str(props.get("model", model))
        self.slots = int(props.get("slots", slots))
        self.max_seq = int(props.get("max_seq", max_seq))
        self._cfg = None
        self._device = None

    @property
    def cfg(self):
        if self._cfg is None:
            _default_presets()
            try:
                self._cfg = SERVE_MODELS[self.model]()
            except KeyError as e:
                raise KeyError(
                    f"model_serve model={self.model!r} not registered; "
                    f"known: {sorted(SERVE_MODELS)}") from e
        return self._cfg

    def negotiate(self, in_caps):
        return [Caps(media="other/tensors")]

    # -- params / state -------------------------------------------------------
    def init_params(self, generator, device) -> dict:
        from ..models import transformer
        return transformer.init_params(self.cfg, generator, device)

    def init_state(self, device) -> dict:
        from ..models import transformer
        self._device = device
        s = self.slots
        return {"cache": transformer.cache_init(self.cfg, s, self.max_seq,
                                                device),
                "active": torch.zeros((s,), dtype=torch.bool, device=device),
                "token": torch.zeros((s,), dtype=torch.int32, device=device),
                "remaining": torch.zeros((s,), dtype=torch.int32,
                                         device=device)}

    # -- the decode tick --------------------------------------------------------
    def admit(self, st: dict, bundle: StreamBuffer):
        """Copy the streams joining this tick into their slots, in place:
        each one's prefilled cache into its slot rows (leaf by leaf), its
        first token, remaining budget and active flag into the lanes.  The
        batcher runs this eagerly before the decode tick (its size varies
        with the joiners, and ``build_admit`` makes host-to-device copies),
        so the tick that follows has one shape per serve configuration and
        is what the cached executable captures."""
        if bundle.meta.get("empty"):
            return
        slots, tok, rem, pos, *leaves = bundle.tensors
        _copy_rows(st["cache"], slots, pos, leaves)
        st["token"].index_copy_(0, slots, tok)
        st["remaining"].index_copy_(0, slots, rem)
        st["active"].index_fill_(0, slots, True)

    def apply(self, params, inputs: List[StreamBuffer],
              ctx: PipelineContext = None) -> List[StreamBuffer]:
        from ..models import transformer
        st = ctx.get_state(self.name)
        # 1. admit (a no-op on the batcher's path, which admitted already)
        self.admit(st, inputs[0])
        cache, token = st["cache"], st["token"]
        remaining, active = st["remaining"], st["active"]
        # 2. one decode step for every slot; inactive slots keep their token
        token = transformer.serve_decode_step(params, self.cfg, cache, token,
                                              active)
        # 3. retire: a slot leaves the batch the tick its budget hits zero
        rem_after = remaining - active.to(torch.int32)
        finished = active & (rem_after <= 0)
        ctx.set_state(self.name, {"cache": cache,
                                  "active": active & ~finished,
                                  "token": token,
                                  "remaining": rem_after.clamp_min(0)})
        return [StreamBuffer(tensors=(token, active, finished))]

    # -- host half (StreamingQueryBatcher calls) ------------------------------
    def active_slots(self, state) -> int:
        """Occupied decode slots, read from the plan-state active mask (a
        device read).  The autoscaler's idle check needs exactly this
        (slots a forgotten stream still holds count too); the per-tick
        load signal counts the batcher's host records instead
        (``StreamingQueryBatcher.active_streams``).  Never call it inside a
        graph's capture or replay.  A slotted stream keeps its slot until
        its ``finished`` lane fires: priority decides admission only."""
        active = state.get(self.name, {}).get("active")
        return 0 if active is None else int(active.sum())

    def host_prefill(self, params, prompt):
        """Prefill one request: prompt int[L] -> (first token int, batch-1
        decode cache on the serve device)."""
        from ..models import transformer
        toks = torch.as_tensor(prompt).to(device=self._device,
                                          dtype=torch.long)[None]
        logits, cache = transformer.lm_prefill(params, self.cfg, toks,
                                               self.max_seq)
        return int(transformer.greedy(logits)[0]), cache

    def empty_admit(self) -> StreamBuffer:
        """No-join tick: a fresh, tensor-free bundle (fresh meta dict every
        call, so no consumer's meta edit can leak into a later tick)."""
        return StreamBuffer(tensors=(), meta={"empty": True})

    def build_admit(self, admits) -> StreamBuffer:
        """The admit bundle for one tick from ``admits``, a list of
        ``(slot, first_token, remaining, batch-1 cache)``.  Cache leaves are
        stacked along the slot axis on the device (no host copy)."""
        if not admits:
            return self.empty_admit()
        dev = self._device
        slots = torch.tensor([a[0] for a in admits], dtype=torch.long,
                             device=dev)
        tok = torch.tensor([a[1] for a in admits], dtype=torch.int32,
                           device=dev)
        rem = torch.tensor([a[2] for a in admits], dtype=torch.int32,
                           device=dev)
        return StreamBuffer(tensors=(slots, tok, rem, *_stack_caches(
            [a[3] for a in admits])), meta={})


@register_element("model_serve_stage")
class ModelServeStageElement(ModelServeElement):
    """One pipeline-parallel stage of a model behind the query fabric
    (DESIGN.md §8): layers ``[stage*R/N, (stage+1)*R/N)`` of the preset
    plus that slice of the slot-stacked decode cache as plan state.  The
    first stage embeds tokens, the last norms and unembeds; per-slot
    boundary activations hop stage to stage over the query fabric, driven
    by the StagedStreamingBatcher on stage 0.

    State is the stage cache only (``pos`` int32 [S] included): the
    coordinator owns the slot table and ships ``active`` as a device
    tensor with every hop.

    Input frame (:meth:`build_hop`): ``(x_in, active)`` with
    ``meta={"empty": True}``, or ``(x_in, active, slots, pos,
    *cache_leaves)`` on a hop with joins (parked batch-1 caches for those
    slots).  ``x_in`` is ``token`` int32 [S] on stage 0, activations
    [S, 1, d] after it; ``active`` is bool [S].  Output frame: the next
    stage's activations [S, 1, d] (zero where inactive), or ``token``
    int32 [S] from the last stage (zero where inactive).  Active rows
    advance ``pos``; an inactive row keeps its ``pos``, so its valid
    history is untouched (its attention layers write one row past it,
    which an admit overwrites with every other leaf of the row)."""

    is_stage_serve = True

    def __init__(self, name=None, model="stablelm-smoke-flash", slots=8,
                 max_seq=64, stage=0, n_stages=1, **props):
        super().__init__(name=name, model=model, slots=slots,
                         max_seq=max_seq, **props)
        self.stage = int(props.get("stage", stage))
        self.n_stages = int(props.get("n_stages", n_stages))
        self._scratch = None
        self._hop_memo = None

    @property
    def is_first(self) -> bool:
        return self.stage == 0

    @property
    def is_last(self) -> bool:
        return self.stage == self.n_stages - 1

    # -- params / state -------------------------------------------------------
    def init_params(self, generator, device) -> dict:
        """Draw the FULL model from ``generator``, then keep this stage's
        share.  Every stage pipeline puts its model element first in topo
        order (``ssrc ! lm ! ssink``), so a stage given the monolithic
        server's seed draws the monolithic tree, and the slices compose
        back to it exactly (the staged == monolithic pin rests on this).
        The other stages' layers are freed when this returns."""
        from ..models import transformer
        full = transformer.init_params(self.cfg, generator, device)
        return transformer.stage_params(full, self.cfg, self.stage,
                                        self.n_stages)

    def init_state(self, device) -> dict:
        from ..models import transformer
        self._device = device
        return {"cache": transformer.stage_cache_init(
            self.cfg, self.stage, self.n_stages, self.slots, self.max_seq,
            device)}

    # -- the stage hop ----------------------------------------------------------
    def build_hop(self, x_in, active, admits) -> StreamBuffer:
        """One decode-hop bundle.  ``admits`` is a list of ``(slot,
        batch-1 stage cache)`` joining this hop; no admits give the
        steady-state ``(x_in, active)`` bundle.  Cache leaves are stacked
        along the slot axis on the device."""
        if not admits:
            return StreamBuffer(tensors=(x_in, active), meta={"empty": True})
        slots = torch.tensor([a[0] for a in admits], dtype=torch.long,
                             device=self._device)
        return StreamBuffer(tensors=(x_in, active, slots, *_stack_caches(
            [a[1] for a in admits])), meta={})

    def admit(self, st: dict, bundle: StreamBuffer) -> StreamBuffer:
        """Copy the parked caches of a hop bundle into their slot rows, in
        place, ``pos`` included, and return the steady-state ``(x_in,
        active)`` bundle the hop runs on.  The batchers run this eagerly
        before the hop, so the cached hop has one shape per stage."""
        x_in, active = bundle.tensors[:2]
        if not bundle.meta.get("empty"):
            slots, pos, *leaves = bundle.tensors[2:]
            _copy_rows(st["cache"], slots, pos, leaves)
        return StreamBuffer(tensors=(x_in, active), meta={"empty": True})

    def _hop_out(self, out, active):
        """The hop's answer: greedy tokens on the last stage, boundary
        activations elsewhere, zero where inactive."""
        from ..models import transformer
        if self.is_last:
            tok = transformer.greedy(out)
            return torch.where(active, tok, torch.zeros_like(tok))
        return torch.where(active[:, None, None], out, torch.zeros_like(out))

    def apply(self, params, inputs: List[StreamBuffer],
              ctx: PipelineContext = None) -> List[StreamBuffer]:
        from ..models import transformer
        st = ctx.get_state(self.name)
        # admit (a no-op on the batchers' path, which admitted already)
        x_in, active = self.admit(st, inputs[0]).tensors
        out, cache = transformer.stage_decode(
            params, self.cfg, self.stage, self.n_stages, x_in, st["cache"],
            advance=active.to(torch.int32), per_row=True)
        ctx.set_state(self.name, {"cache": cache})
        return [StreamBuffer(tensors=(self._hop_out(out, active),))]

    # -- host half: stage-local prefill and replay ------------------------------
    def host_stage_prefill(self, params, x):
        """Stage-local prefill of one stream: prompt tokens int [L] (stage
        0) or boundary activations [1, L, d] -> (boundary activations
        [1, L, d], or the first token int32 [1] on the last stage; the
        batch-1 stage cache), all on the serve device."""
        from ..models import transformer
        if self.is_first:
            x = torch.as_tensor(x).to(device=self._device,
                                      dtype=torch.long)[None]
        out, cache = transformer.stage_prefill(params, self.cfg, self.stage,
                                               self.n_stages, x, self.max_seq)
        if self.is_last:
            out = transformer.greedy(out)
        return out, cache

    def _replay_cache(self) -> dict:
        """Scratch batch-S stage cache the replay steps run in.  A row
        other than the replayed one holds whatever earlier replays left
        there; no row reads another."""
        if self._scratch is None:
            from ..models import transformer
            self._scratch = transformer.stage_cache_init(
                self.cfg, self.stage, self.n_stages, self.slots,
                self.max_seq, self._device)
        return self._scratch

    def host_stage_decode(self, params, x, cache, slot: int):
        """One decode step of a parked stream through this stage: the
        stage-local REPLAY primitive (DESIGN.md §8).  ``x`` is the
        stream's retained input of one hop (token int [1] on stage 0,
        activations [1, 1, d] after), ``cache`` its parked batch-1 stage
        cache, ``slot`` the slot row it decodes in.  The step runs at the
        serve batch, in that row of a scratch cache, with only that row
        active: every GEMM has the hop's shape and the row's values are the
        ones the hop computes for it (the port's ``sequential_decode``
        rule), so re-running a stage's retained activations rebuilds its
        cache bitwise.  The row is copied back into ``cache`` in place.
        -> (the step's output for the stream, ``cache``)."""
        from ..models import transformer
        scr = self._replay_cache()
        row = slice(slot, slot + 1)
        scr["pos"][row].copy_(cache["pos"])
        dst, src = tree_flatten(scr["layers"])[0], \
            tree_flatten(cache["layers"])[0]
        for d, s in zip(dst, src):
            d[row].copy_(s)
        x = torch.as_tensor(x).to(self._device)
        xs = torch.zeros((self.slots,) + tuple(x.shape[1:]), dtype=x.dtype,
                         device=self._device)
        xs[row] = x
        active = torch.zeros((self.slots,), dtype=torch.bool,
                             device=self._device)
        active[row] = True
        out, _ = transformer.stage_decode(
            params, self.cfg, self.stage, self.n_stages, xs, scr,
            advance=active.to(torch.int32), per_row=True)
        cache["pos"].copy_(scr["pos"][row])
        for d, s in zip(src, dst):
            d.copy_(s[row])
        return self._hop_out(out, active)[row], cache

    def host_stage_decode_idempotent(self, params, x, cache, slot: int,
                                     hop_id=None):
        """:meth:`host_stage_decode` with at most one effect per
        ``hop_id`` (a hop's delivery id): a replayed hop whose id was
        already served returns the memoized (out, cache) instead of
        advancing the parked cache a second time.  The memo keeps the last
        64 ids.  ``hop_id=None`` (no delivery id) is a plain
        :meth:`host_stage_decode`; the port's hops carry no delivery id
        until the delivery layer (ROADMAP M10)."""
        if hop_id is None:
            return self.host_stage_decode(params, x, cache, slot)
        if self._hop_memo is None:
            self._hop_memo = OrderedDict()
        hit = self._hop_memo.get(hop_id)
        if hit is not None:
            return hit
        out = self.host_stage_decode(params, x, cache, slot)
        self._hop_memo[hop_id] = out
        while len(self._hop_memo) > 64:
            self._hop_memo.popitem(last=False)
        return out


@register_element("token_prompt_src")
class TokenPromptSrc(Element):
    """Deterministic streaming-workload source: one prompt request per
    frame, cycling through ``prompts`` ("1,2,3;4,5") and ``gens`` ("6;4" —
    tokens to generate per request), ``gen`` tagged into meta.  The prompt
    is a host int32 tensor: the request payload that crosses the wire."""

    host_impure = True
    n_sink_pads = 0

    def __init__(self, name=None, prompts="1,2,3", gens="4", **props):
        super().__init__(name=name, **props)
        self.prompts = str(props.get("prompts", prompts))
        self.gens = str(props.get("gens", gens))
        self._prompt_list = [
            tuple(int(t) for t in p.split(",") if t)
            for p in self.prompts.split(";") if p]
        self._gen_list = [int(g) for g in self.gens.split(";") if g]

    def negotiate(self, in_caps):
        return [Caps(media="other/tensors")]

    def init_state(self, device):
        return {"frame": 0}

    def apply(self, params, inputs, ctx: PipelineContext = None):
        i = ctx.get_state(self.name)["frame"]
        prompt = self._prompt_list[i % len(self._prompt_list)]
        gen = self._gen_list[i % len(self._gen_list)]
        ctx.set_state(self.name, {"frame": i + 1})
        return [StreamBuffer(tensors=(torch.tensor(prompt, dtype=torch.int32),),
                             meta={"gen": gen})]
