"""Pipeline execution plan — port of ``src/repro/core/plan.py``.

``ExecutionPlan`` turns a realized pipeline into a static slot-indexed
schedule once, at ``realize()`` time, so stepping a frame never re-sorts
links or rebuilds dicts.  Execution tiers, bitwise equal to the seed
interpreter (``Pipeline.step_interpreted``):

* ``run(params, state, inputs, hoist_io, hoist_queries)`` — one frame
  through the schedule.  ``hoist_queries`` injects the serversrc request and
  captures the serversink answer instead of doing channel I/O, so a batcher
  can drive a server pipeline directly.
* ``run_deferred`` and :class:`PendingQuery` — a client frame paused at its
  ``tensor_query_client`` until the scheduler has the answer;
  ``run_deferred_compiled`` runs each pure segment between pause points
  (start → first client, client → client, client → end) as one cached
  executable instead of an element-by-element walk.
* ``step_n`` — an N-frame pub/sub burst over stacked frames: the JAX
  package's ``lax.scan`` becomes a loop of hoisted ``run`` calls over the
  unstacked frames, threading state (``hoist_io`` injects the mqttsrc
  frames the scheduler pulled and captures the mqttsink frames it replays).
* ``serve_batch`` / ``serve_batch_wire`` — N query requests through the
  hoisted schedule; the wire variant decodes the stacked requests, runs
  the DAG once per frame and re-encodes the stacked answers (the fused
  wire path, DESIGN.md §5).
* ``compiled_step``, ``compiled_step_n``, ``compiled_serve_tick``,
  ``compiled_serve_batch`` and ``compiled_deferred_segment`` — the cached
  executables, in a process-wide registry keyed by the plan's topology
  fingerprint (plus the reference's keys: donation, burst hoisting, the
  state's :func:`structure_key`, the codec, the segment).  Each entry is a
  :class:`~.graphs.GraphedCallable`: the eager function on the CPU, CUDA
  graphs on the card, where the JAX package jits.  Donation
  (``donate=None``) is on when the card is the default device, as the JAX
  package donates on gpu/tpu.

Mesh sharding (DESIGN.md §4): ``step_n``, ``serve_batch`` and their
compiled entries take a :class:`~..launch.mesh.Mesh`.  When the frame
count tiles the mesh's data axes and the plan threads no cross-frame state
(:meth:`ExecutionPlan.shardable_batch`), each data slot runs the
single-device ``step_n`` over its own contiguous frame slice (the cached
single-device entry: one CUDA-graph binding serves every slot of a
device, each slice copied into its inputs) and the outputs are gathered in
slot order, so frame ``i`` is bitwise the single-device result.  Anything
else falls back to the single-device path inside the same callable.  The
mesh entries are cached under the mesh's fingerprint, so reconnecting with
the same mesh builds nothing and two meshes never share an entry.

Every path serves the DAG once per frame, at the frame's own shapes, so a
model sees the same GEMM shapes whether a request was served alone, in a
batch, fused or eager: that is what makes the paths agree bitwise.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .buffers import (StreamBuffer, stack_buffers, structure_key,
                      tree_flatten, tree_unflatten, unstack_buffers)
from .element import Element, PipelineContext
from .graphs import GraphedCallable

__all__ = ["ExecutionPlan", "MeshCallable", "PendingQuery", "PlanOp",
           "clear_executable_cache", "executable_cache_info",
           "release_bindings", "tensor_ptrs"]


class PlanOp:
    """One scheduled element: static wiring resolved to value slots."""

    __slots__ = ("elem", "name", "in_slots", "out_slots", "injectable",
                 "is_sink", "is_host_sink", "is_query_src", "is_query_sink",
                 "is_query_client")

    def __init__(self, elem: Element, in_slots: Tuple[int, ...],
                 out_slots: Tuple[int, ...], injectable: bool,
                 is_sink: bool, is_host_sink: bool):
        self.elem = elem
        self.name = elem.name
        self.in_slots = in_slots
        self.out_slots = out_slots
        self.injectable = injectable
        self.is_sink = is_sink
        self.is_host_sink = is_host_sink
        self.is_query_src = getattr(elem, "is_query_source", False)
        self.is_query_sink = getattr(elem, "is_query_sink", False)
        self.is_query_client = getattr(elem, "is_query_client", False)


# Process-wide executable registry: fingerprint -> {"fns": {key:
# GraphedCallable}}.  Two plans with equal fingerprints behave identically
# (the fingerprint covers element class, static config, wiring and
# negotiated caps), so the first plan's callables serve all of them.
# LRU-capped; evicting a fingerprint frees its graphs.
_EXEC_CACHE: "OrderedDict[Any, Dict[str, Any]]" = OrderedDict()
_EXEC_CACHE_MAX = 128


def _release(ent: Dict[str, Any]):
    for fn in ent["fns"].values():
        fn.release()


def clear_executable_cache():
    for ent in _EXEC_CACHE.values():
        _release(ent)
    _EXEC_CACHE.clear()


def tensor_ptrs(*trees) -> set:
    """Addresses of the tensors in ``trees``."""
    return {l.data_ptr() for t in trees for l in tree_flatten(t)[0]
            if isinstance(l, torch.Tensor) and l.data_ptr()}


def release_bindings(ptrs: set) -> int:
    """Free every cached binding keyed on one of the tensor addresses
    ``ptrs`` (a reconfiguration's retired params and state), with its
    graph.  Returns how many were freed."""
    if not ptrs:
        return 0
    return sum(fn.release_on(ptrs) for ent in _EXEC_CACHE.values()
               for fn in ent["fns"].values())


def executable_cache_info() -> Dict[str, int]:
    """Fingerprints and cached executables, as in the JAX package, plus the
    CUDA graphs those executables hold (0 on the CPU): a retrace on the
    card shows as a new graph."""
    fns = [f for e in _EXEC_CACHE.values() for f in e["fns"].values()]
    return {"fingerprints": len(_EXEC_CACHE), "executables": len(fns),
            "graphs": sum(f.graphs() for f in fns)}


class MeshCallable:
    """A mesh entry of the executable registry: a plain function that
    splits a batch over the data slots and calls the single-device entries
    (which hold the CUDA graphs), so it holds no graph of its own."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def release(self):
        pass

    def release_on(self, ptrs) -> int:
        return 0

    def graphs(self) -> int:
        return 0


def _params_of(params):
    """The params tree itself, for a mesh-replicated copy
    (``launch.spmd.Replicated``) handed to a single-device path."""
    return params.tree if hasattr(params, "by_device") else params


def _n_frames(stacked) -> int:
    leaves = tree_flatten(stacked)[0]
    return int(leaves[0].shape[0]) if leaves else 0


def _data_slots(mesh, dp):
    """(slot's linear index over the data axes, slot index) for the slots
    at position 0 of every other axis, in data order."""
    from ..launch.spmd import slots
    sizes = mesh.shape
    out = []
    for idx, pos in slots(mesh):
        if any(pos[a] for a in mesh.axis_names if a not in dp):
            continue
        k = 0
        for a in dp:
            k = k * sizes[a] + pos[a]
        out.append((k, idx))
    return sorted(out)


def _frame_slice(leaf, start: int, n: int, device):
    if isinstance(leaf, torch.Tensor):
        return leaf.narrow(0, start, n).to(device)
    if isinstance(leaf, np.ndarray):
        return leaf[start:start + n]
    return leaf


def _concat(cols, device):
    if isinstance(cols[0], torch.Tensor):
        return torch.cat([c.to(device) if device is not None else c
                          for c in cols])
    return np.concatenate([np.asarray(c) for c in cols])


def _on(device):
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ExecutionPlan:
    """Static schedule + executable cache for one realized pipeline."""

    def __init__(self, pipeline):
        from .elements import AppSink, AppSrc

        order: List[Element] = pipeline._order
        links = pipeline.links
        slot_of: Dict[Tuple[str, int], int] = {}
        for l in links:
            key = (l.src.name, l.src_pad)
            if key not in slot_of:
                slot_of[key] = len(slot_of)
        self.n_slots = len(slot_of)

        in_links: Dict[str, list] = {e.name: [] for e in order}
        for l in links:
            in_links[l.dst.name].append(l)

        ops: List[PlanOp] = []
        for elem in order:
            lk = sorted(in_links[elem.name], key=lambda l: l.dst_pad)
            in_slots = tuple(slot_of[(l.src.name, l.src_pad)] for l in lk)
            max_pad = max((l.src_pad for l in links if l.src is elem),
                          default=-1)
            out_slots = tuple(slot_of.get((elem.name, p), -1)
                              for p in range(max_pad + 1))
            injectable = isinstance(elem, AppSrc) or \
                getattr(elem, "is_host_source", False)
            ops.append(PlanOp(elem, in_slots, out_slots,
                              injectable=injectable,
                              is_sink=isinstance(elem, AppSink),
                              is_host_sink=getattr(elem, "is_host_sink",
                                                   False)))
        self.ops = ops
        self.host_sources = [op.elem for op in ops
                             if getattr(op.elem, "is_host_source", False)]
        self.host_sinks = [op.elem for op in ops if op.is_host_sink]
        impure = [op.elem for op in ops
                  if getattr(op.elem, "host_impure", False)]
        #: no host-impure elements at all
        self.pure = not impure
        #: every impure element is a hoistable source or terminal sink, so
        #: bursts can inject the sources' frames and capture the sinks'
        self.burstable = all(
            getattr(e, "is_host_source", False) or
            getattr(e, "is_host_sink", False) for e in impure)
        #: every graph source is host-driven, so a burst replays only
        #: queued frames; a self-driven source (testsrc camera) would be
        #: fast-forwarded by a burst, so such pipelines keep the tick cadence
        self.all_sources_host_driven = bool(self.host_sources) and all(
            getattr(op.elem, "is_host_source", False)
            for op in ops if not op.in_slots)
        self.query_sources = [op.elem for op in ops if op.is_query_src]
        self.query_sinks = [op.elem for op in ops if op.is_query_sink]
        #: pipeline contains tensor_query_client elements (run deferred)
        self.has_query_clients = any(op.is_query_client for op in ops)
        #: server pipeline whose impure elements are exactly one serversrc
        #: plus serversinks, so a batcher can drive it hoisted
        self.query_batchable = (
            len(self.query_sources) == 1 and bool(self.query_sinks)
            and all(getattr(e, "is_query_source", False)
                    or getattr(e, "is_query_sink", False) for e in impure)
            and all(op.is_query_src for op in ops if not op.in_slots))
        #: query-batchable server whose serve element decodes a stream:
        #: decode state is plan state carried across ticks
        self.stream_serving = self.query_batchable and any(
            getattr(op.elem, "is_stream_serve", False) for op in ops)
        #: stream-serving pipeline that is ONE STAGE of a pipeline-parallel
        #: chain (DESIGN.md §8); (stage, n_stages) is part of the serve
        #: tick's cache key, so two stages of one chain (or the same stage
        #: of chains of different depth) never share a serve tick even
        #: where their cache structures agree
        stage_elems = [op.elem for op in ops
                       if getattr(op.elem, "is_stage_serve", False)]
        self.stage_serving = self.stream_serving and bool(stage_elems)
        self.serve_stage = ((stage_elems[0].stage, stage_elems[0].n_stages)
                            if self.stage_serving else None)
        #: op indices of the query clients, in schedule order (the deferred
        #: walk's pause points — static, because topology is static)
        self.client_idxs = tuple(i for i, op in enumerate(ops)
                                 if op.is_query_client)
        #: every impure element is a query client: the segments between
        #: pause points are pure and each runs as one cached executable
        #: (run_deferred_compiled)
        self.deferred_compilable = bool(self.client_idxs) and all(
            getattr(e, "is_query_client", False) for e in impure)
        self.fingerprint = self._fingerprint(order, links)

    @staticmethod
    def _fingerprint(order: List[Element], links) -> Tuple:
        elems = tuple(e.plan_signature() for e in order)
        wiring = tuple((l.src.name, l.src_pad, l.dst.name, l.dst_pad)
                       for l in links)
        return (elems, wiring)

    # -- single-frame execution ------------------------------------------------
    def _exec_ops(self, params: dict, ctx: PipelineContext, vals: List[Any],
                  outputs: Dict[str, StreamBuffer],
                  inputs: Dict[str, StreamBuffer], start: int,
                  hoist_io: bool, hoist_queries: bool, defer_queries: bool
                  ) -> Optional[Tuple[int, StreamBuffer]]:
        """Walk ``ops[start:]`` mutating ``vals``/``outputs``/``ctx``.
        Returns None when the schedule completes, or ``(op_idx, request)``
        when ``defer_queries`` and a query client is reached."""
        for idx in range(start, len(self.ops)):
            op = self.ops[idx]
            ins = [vals[s] for s in op.in_slots]
            injectable = op.injectable or (hoist_queries and op.is_query_src)
            if injectable and op.name in inputs:
                ins = [inputs[op.name]]
                if getattr(op.elem, "is_host_source", False) or \
                        (hoist_queries and op.is_query_src):
                    # the injected, already-decoded frame IS the pull
                    if op.out_slots and op.out_slots[0] >= 0:
                        vals[op.out_slots[0]] = ins[0]
                    continue
            elif hoist_io and getattr(op.elem, "is_host_source", False):
                raise ValueError(
                    f"{op.name}: hoisted execution requires an injected "
                    f"input frame for every host-driven source")
            elif hoist_queries and op.is_query_src:
                raise ValueError(
                    f"{op.name}: hoisted query serving requires an injected "
                    f"request frame for every serversrc")
            if (hoist_io and op.is_host_sink) or \
                    (hoist_queries and op.is_query_sink):
                # capture instead of the impure push
                outputs[op.name] = ins[0]
                continue
            if defer_queries and op.is_query_client:
                return idx, ins[0]
            outs = op.elem.apply(params.get(op.name, {}), ins, ctx)
            for i, o in enumerate(outs):
                if i < len(op.out_slots) and op.out_slots[i] >= 0:
                    vals[op.out_slots[i]] = o
            if op.is_sink and outs:
                outputs[op.name] = outs[0]
        return None

    def run(self, params: dict, state: dict,
            inputs: Optional[Dict[str, StreamBuffer]] = None,
            hoist_io: bool = False, hoist_queries: bool = False
            ) -> Tuple[Dict[str, StreamBuffer], dict]:
        """One frame through the static schedule -> (outputs, next_state)."""
        inputs = inputs or {}
        ctx = PipelineContext(state)
        vals: List[Any] = [None] * self.n_slots
        outputs: Dict[str, StreamBuffer] = {}
        self._exec_ops(params, ctx, vals, outputs, inputs, 0,
                       hoist_io, hoist_queries, defer_queries=False)
        return outputs, ctx.next_state

    def run_deferred(self, params: dict, state: dict,
                     inputs: Optional[Dict[str, StreamBuffer]] = None):
        """Start one frame, pausing at the first un-answered query client:
        ``(outputs, next_state)`` when no client is on the frame's path,
        else a :class:`PendingQuery` whose ``request`` is the buffer the
        client was about to send."""
        inputs = inputs or {}
        ctx = PipelineContext(state)
        vals: List[Any] = [None] * self.n_slots
        outputs: Dict[str, StreamBuffer] = {}
        res = self._exec_ops(params, ctx, vals, outputs, inputs, 0,
                             hoist_io=False, hoist_queries=False,
                             defer_queries=True)
        if res is None:
            return outputs, ctx.next_state
        return PendingQuery(self, params, inputs, ctx, vals, outputs, *res)

    # -- bursts ----------------------------------------------------------------
    def step_n(self, params: dict, state: dict,
               inputs: Optional[Dict[str, StreamBuffer]] = None,
               n: Optional[int] = None, hoist_io: bool = False,
               hoist_queries: bool = False, mesh=None
               ) -> Tuple[Dict[str, StreamBuffer], dict]:
        """An N-frame burst.  ``inputs`` maps source names to *stacked*
        buffers (leading frame axis, :func:`stack_buffers`); self-driven
        pipelines pass ``n`` instead.  Runs the frames in order, threading
        state, and returns (stacked outputs, final state): frame ``i`` of
        the outputs is bitwise the ``i``-th sequential :meth:`run`.

        With ``mesh``, a burst that :meth:`shardable_batch` admits runs
        one contiguous frame slice a data slot (:meth:`_step_n_sharded`);
        anything else runs here unchanged."""
        if inputs is None and n is None:
            raise ValueError("step_n needs stacked `inputs` or a length `n`")
        if mesh is not None and inputs is not None and \
                self.shardable_batch(_n_frames(inputs), state, mesh):
            return self._step_n_sharded(params, state, inputs, mesh,
                                        hoist_io, hoist_queries, None)
        params = _params_of(params)
        frames = (unstack_buffers(inputs, n) if inputs is not None
                  else [None] * n)
        outs = []
        for frame in frames:
            o, state = self.run(params, state, frame, hoist_io=hoist_io,
                                hoist_queries=hoist_queries)
            outs.append(o)
        return stack_buffers(outs), state

    @staticmethod
    def shardable_batch(n: int, state: dict, mesh) -> bool:
        """True when an ``n``-frame burst can be laid out along ``mesh``'s
        data axes without changing semantics: more than one data slot, a
        frame count that tiles them evenly, and no cross-frame state (a
        state with tensor leaves threads through the frames in FIFO order;
        splitting it would change what frame ``i`` sees)."""
        if mesh is None or n <= 0:
            return False
        if tree_flatten(state)[0]:
            return False
        from ..launch.mesh import data_axis_size
        d = data_axis_size(mesh)
        return d > 1 and n % d == 0

    def _step_n_sharded(self, params, state: dict, inputs, mesh,
                        hoist_io: bool, hoist_queries: bool,
                        donate: Optional[bool]
                        ) -> Tuple[Dict[str, StreamBuffer], dict]:
        """One contiguous frame slice a data slot, in slot order: the slice
        moves to the slot's device, runs the single-device ``step_n`` there
        (its cached entry when ``donate`` is not None, else the eager
        method) with that device's copy of the params, and the stacked
        outputs are gathered back on the inputs' device.  Slots along the
        other axes hold the same slice, so one of them computes it.  Only
        called when :meth:`shardable_batch` holds: the state has no
        leaves, so no carry crosses a slice boundary."""
        from ..launch.mesh import data_axes
        from ..launch.spmd import to_device
        data_slots = _data_slots(mesh, data_axes(mesh))
        n_local = _n_frames(inputs) // len(data_slots)
        leaves, td = tree_flatten(inputs)
        home = next((l.device for l in leaves
                     if isinstance(l, torch.Tensor)), None)
        if donate is None:
            def fn(p, s, local):
                return self.step_n(p, s, local, hoist_io=hoist_io,
                                   hoist_queries=hoist_queries)
        else:
            fn = self.compiled_step_n(hoist_io=hoist_io,
                                      hoist_queries=hoist_queries,
                                      donate=donate)
        parts = []
        for k, idx in data_slots:
            dev = mesh.devices[idx]
            local = tree_unflatten(td, [_frame_slice(l, k * n_local, n_local,
                                                     dev) for l in leaves])
            p = params.on(dev) if hasattr(params, "on") else \
                to_device(params, dev)
            with _on(dev):
                parts.append(fn(p, state, local)[0])
        flat = [tree_flatten(o) for o in parts]
        cols = zip(*[lv for lv, _ in flat])
        gathered = [_concat(c, home) for c in cols]
        # no state leaves: the carry is pure structure, returned as is
        return tree_unflatten(flat[0][1], gathered), dict(state)

    # -- batched serving -------------------------------------------------------
    def serve_batch(self, params: dict, state: dict, frames: Tuple,
                    mesh=None) -> Tuple[Tuple, dict]:
        """Serve N query requests: ``frames`` is a tuple of
        ``{serversrc_name: StreamBuffer}`` dicts; returns (per-frame
        outputs, final state), frame ``i`` being the ``i``-th sequential
        hoisted ``run``.  With ``mesh``, a batch that
        :meth:`shardable_batch` admits is stacked and served through the
        sharded ``step_n``; every other batch, every stateful plan
        included, serves here frame by frame."""
        if self.shardable_batch(len(frames), state, mesh):
            outs, final = self.step_n(params, state, stack_buffers(frames),
                                      hoist_io=True, hoist_queries=True,
                                      mesh=mesh)
            return tuple(unstack_buffers(outs, len(frames))), final
        params = _params_of(params)
        outs = []
        for frame in frames:
            o, state = self.run(params, state, frame, hoist_io=True,
                                hoist_queries=True)
            outs.append(o)
        return tuple(outs), state

    def serve_batch_wire(self, params: dict, state: dict, wire_frames: Tuple,
                         codec: str) -> Tuple[Tuple, dict]:
        """Codec-fused :meth:`serve_batch`: decode of the stacked requests
        (one launch per tensor), the DAG once per frame, one stacked
        re-encode of the query answers.

        ``wire_frames`` is a tuple of ``{serversrc_name: wire
        StreamBuffer}`` dicts of one structure and one ``codec``.  Returns
        ``((stacked_wire_answers, stacked_app_outs, dropped),
        final_state)``: wire answers per sink with a leading frame axis
        (frame ``i`` bitwise what decode → serve → ``encode`` gives), the
        other sinks' outputs stacked, and per sink the deferred sparse
        truncation counts int32 [tensors, frames] (empty unless the codec
        is sparse), still on the device."""
        from . import compression as comp
        src = self.query_sources[0].name
        stacked_wire = stack_buffers([f[src] for f in wire_frames])
        dense = comp.decode_stacked(stacked_wire, codec)
        frames = tuple({src: f} for f in unstack_buffers(dense,
                                                         len(wire_frames)))
        per_frame, final = self.serve_batch(params, state, frames)
        outs = stack_buffers(per_frame)
        sink_names = {e.name for e in self.query_sinks}
        wire_outs: Dict[str, StreamBuffer] = {}
        app_outs: Dict[str, StreamBuffer] = {}
        dropped: Dict[str, Any] = {}
        for name, buf in outs.items():
            if name in sink_names:
                w, drp = comp.encode_stacked(buf, codec)
                wire_outs[name] = w
                if drp is not None:
                    dropped[name] = drp
            else:
                app_outs[name] = buf
        return (wire_outs, app_outs, dropped), final

    # -- cached executables ----------------------------------------------------
    def _cache(self) -> Dict[str, Any]:
        ent = _EXEC_CACHE.get(self.fingerprint)
        if ent is None:
            ent = {"fns": {}}
            _EXEC_CACHE[self.fingerprint] = ent
            while len(_EXEC_CACHE) > _EXEC_CACHE_MAX:
                _release(_EXEC_CACHE.popitem(last=False)[1])
        else:
            _EXEC_CACHE.move_to_end(self.fingerprint)
        return ent

    def _entry(self, key, make_fn: Callable[[], Callable],
               donate: bool) -> GraphedCallable:
        fns = self._cache()["fns"]
        if key not in fns:
            fns[key] = GraphedCallable(make_fn(), donate)
        return fns[key]

    @staticmethod
    def _resolve_donate(donate: Optional[bool]) -> bool:
        """``None`` donates when the card is the default device (the JAX
        package donates on gpu/tpu); on the CPU an entry is the eager
        function, which donation does not change."""
        if donate is None:
            return torch.cuda.is_available()
        return bool(donate)

    def compiled_step(self, donate: Optional[bool] = None) -> Callable:
        """:meth:`run` as ``(params, state, inputs=None) -> (outputs,
        next_state)``, cached under ``("step", donate)`` and shared across
        all plans with this fingerprint."""
        donate = self._resolve_donate(donate)
        return self._entry(("step", donate), lambda: self.run, donate)

    @staticmethod
    def _mesh_key(mesh):
        from ..launch.mesh import mesh_fingerprint
        return mesh_fingerprint(mesh)

    def _mesh_entry(self, key, make_fn: Callable[[], Callable]
                    ) -> MeshCallable:
        fns = self._cache()["fns"]
        if key not in fns:
            fns[key] = MeshCallable(make_fn())
        return fns[key]

    def compiled_step_n(self, hoist_io: bool = False,
                        hoist_queries: bool = False,
                        donate: Optional[bool] = None, mesh=None
                        ) -> Callable:
        """:meth:`step_n` ``(params, state, inputs=None, n=None) ->
        (stacked outputs, final state)``, cached under ``("step_n",
        hoist_io, hoist_queries, donate, mesh fingerprint)``; ``n`` is
        static, so each burst length is its own binding.

        With ``mesh``, the entry is a :class:`MeshCallable`: a burst that
        :meth:`shardable_batch` admits runs its data slots' slices through
        the single-device entry (created here too, as the fallback), any
        other burst runs the single-device entry whole.  ``params`` may be
        the tree or its mesh copy (``launch.shardings.replicated``)."""
        donate = self._resolve_donate(donate)
        if mesh is None:
            def make():
                def step_n(params, state, inputs=None, n=None, _self=self,
                           _hoist=hoist_io, _hoistq=hoist_queries):
                    return _self.step_n(params, state, inputs, n=n,
                                        hoist_io=_hoist,
                                        hoist_queries=_hoistq)
                return step_n
            return self._entry(("step_n", hoist_io, hoist_queries, donate,
                                None), make, donate)
        self.compiled_step_n(hoist_io, hoist_queries, donate)

        def make_mesh():
            def step_n_mesh(params, state, inputs=None, n=None, _self=self):
                if inputs is not None and _self.shardable_batch(
                        _n_frames(inputs), state, mesh):
                    return _self._step_n_sharded(params, state, inputs, mesh,
                                                 hoist_io, hoist_queries,
                                                 donate)
                single = _self.compiled_step_n(hoist_io, hoist_queries,
                                               donate)
                return single(_params_of(params), state, inputs, n=n)
            return step_n_mesh
        return self._mesh_entry(("step_n", hoist_io, hoist_queries, donate,
                                 self._mesh_key(mesh)), make_mesh)

    def compiled_serve_batch(self, donate: Optional[bool] = None,
                             mesh=None, codec: Optional[str] = None
                             ) -> Callable:
        """:meth:`serve_batch` ``(params, state, frames) -> (per-frame
        outputs, final state)``, or with ``codec`` the fused
        :meth:`serve_batch_wire` ``(params, state, wire_frames) ->
        ((stacked wire answers, stacked app outs, dropped), final)``,
        cached under ``("serve_batch", donate, mesh fingerprint, codec)``
        so the kinds, two codecs and two meshes never share an entry.  The
        batch size lives in the frames' structure: each size is its own
        binding.

        ``mesh`` gives a :class:`MeshCallable`: a batch that
        :meth:`shardable_batch` admits is stacked, served through
        ``compiled_step_n(mesh=...)`` and split back per frame; any other
        batch falls through to the single-device entry, which is created
        here too.  Codec fusion is single-device: ``codec`` with ``mesh``
        raises, and the batcher keeps mesh groups on the eager wire
        path."""
        donate = self._resolve_donate(donate)
        if codec is not None and mesh is not None:
            raise ValueError("codec-fused serving is single-device; "
                             "mesh groups keep the eager wire path")
        if mesh is not None:
            self.compiled_serve_batch(donate=donate)
            self.compiled_step_n(hoist_io=True, hoist_queries=True,
                                 donate=donate, mesh=mesh)

            def make_mesh():
                def serve_sharded(params, state, frames, _self=self):
                    n = len(frames)
                    if not _self.shardable_batch(n, state, mesh):
                        single = _self.compiled_serve_batch(donate=donate)
                        return single(_params_of(params), state, frames)
                    step = _self.compiled_step_n(
                        hoist_io=True, hoist_queries=True, donate=donate,
                        mesh=mesh)
                    outs, final = step(params, state, stack_buffers(frames))
                    return tuple(unstack_buffers(outs, n)), final
                return serve_sharded
            return self._mesh_entry(("serve_batch", donate,
                                     self._mesh_key(mesh), None), make_mesh)
        if codec is None:
            def make():
                def serve_batch(params, state, frames, _self=self):
                    return _self.serve_batch(params, state, frames)
                return serve_batch
        else:
            def make():
                def serve_wire(params, state, frames, _self=self,
                               _codec=codec):
                    return _self.serve_batch_wire(params, state, frames,
                                                  _codec)
                return serve_wire
        return self._entry(("serve_batch", donate, None, codec), make, donate)

    # -- stateful streaming serve ----------------------------------------------
    def _serve_tick_fn(self, donate: bool, state_key) -> Callable:
        """Executable behind :meth:`compiled_serve_tick`, addressable by its
        full cache key (``serve_stage`` included, as in the JAX package)."""
        def make():
            def serve_tick(params, state, inputs, _self=self):
                return _self.run(params, state, inputs, hoist_io=True,
                                 hoist_queries=True)
            return serve_tick
        return self._entry(("serve_tick", donate, self.serve_stage,
                            state_key), make, donate)

    def compiled_serve_tick(self, state: dict,
                            donate: Optional[bool] = None) -> Callable:
        """Stateful decode tick ``(params, state, inputs) -> (outputs,
        next_state)`` for a ``stream_serving`` plan: one hoisted ``run``.
        The batch lives inside the plan state (slot axis of the cache plus
        the active mask), so joins and leaves never change the callable;
        the cache key carries ``structure_key(state)``, so two serve
        configurations with different slot counts or cache layouts never
        share an entry and the same structure never builds a new one."""
        return self._serve_tick_fn(self._resolve_donate(donate),
                                   structure_key(state))

    # -- compiled deferred segments --------------------------------------------
    def _next_client(self, after: int) -> Optional[int]:
        for i in self.client_idxs:
            if i > after:
                return i
        return None

    def _live_slots(self, pause_idx: int) -> Tuple[int, ...]:
        """Value slots that must survive a pause at ``pause_idx``: written
        by an op before the pause AND read by an op after it.  Static, so
        a segment carries exactly the live values."""
        written = {s for op in self.ops[:pause_idx]
                   for s in op.out_slots if s >= 0}
        read = {s for op in self.ops[pause_idx + 1:] for s in op.in_slots}
        return tuple(sorted(written & read))

    def _deferred_segment(self, start: Optional[int]) -> Callable:
        """One pure segment of the deferred walk: ``start=None`` runs op 0
        → the first query client; ``start=j`` injects the answer for the
        client at op ``j`` and runs to the next client or the end.
        ``seg(params, state, live_vals, answer, inputs)`` returns
        ``((request, live_vals, outputs), next_state)`` when it pauses
        again, ``(outputs, next_state)`` when it completes (static: the
        topology says which).

        ``state`` is the frame's state so far, the previous segment's
        ``next_state``: each element reads and writes only its own entry,
        so the threaded state stands in for the JAX package's (state,
        next_state) pair."""
        def seg(params, state, live_vals, answer, inputs):
            ctx = PipelineContext(state)
            vals: List[Any] = [None] * self.n_slots
            outputs: Dict[str, StreamBuffer] = {}
            if start is None:
                begin = 0
            else:
                for s, v in zip(self._live_slots(start), live_vals):
                    vals[s] = v
                op = self.ops[start]
                if op.out_slots and op.out_slots[0] >= 0:
                    vals[op.out_slots[0]] = answer
                if op.is_sink:
                    outputs[op.name] = answer
                begin = start + 1
            res = self._exec_ops(params, ctx, vals, outputs, inputs, begin,
                                 hoist_io=False, hoist_queries=False,
                                 defer_queries=True)
            if res is None:
                return outputs, ctx.next_state
            idx, request = res
            live = tuple(vals[s] for s in self._live_slots(idx))
            return (request, live, outputs), ctx.next_state
        return seg

    def compiled_deferred_segment(self, start: Optional[int]) -> Callable:
        """:meth:`_deferred_segment` as a cached executable (failover
        reconnects of a structurally identical client pipeline reuse its
        segments)."""
        donate = self._resolve_donate(None)
        return self._entry(("defer_seg", -1 if start is None else start),
                           lambda: self._deferred_segment(start), donate)

    def run_deferred_compiled(self, params: dict, state: dict,
                              inputs: Optional[Dict[str, StreamBuffer]] = None):
        """Compiled counterpart of :meth:`run_deferred` for plans whose only
        impure elements are query clients (:attr:`deferred_compilable`):
        the walk to the first client is ONE cached executable instead of
        an element-by-element walk, bitwise the same frame.  Returns a
        compiled-mode :class:`PendingQuery` (its ``resume`` runs cached
        segments too)."""
        inputs = inputs or {}
        fn = self.compiled_deferred_segment(None)
        (request, live, outputs), next_state = fn(params, state, (), None,
                                                  inputs)
        return PendingQuery.compiled(self, params, inputs, next_state, live,
                                     outputs, self.client_idxs[0], request)


class PendingQuery:
    """A frame paused mid-schedule at a query client, awaiting its answer.

    ``request`` is the StreamBuffer the client was about to ship;
    ``resume(answer)`` continues the walk, returning ``(outputs,
    next_state)`` on completion or ``self`` again if a later client pauses
    the frame.  ``endpoint`` records where the scheduler shipped the
    request.

    Two modes, bitwise the same: the interpreted mode carries the live walk
    (``ctx``/``vals``) and resumes element by element; the compiled mode
    (:meth:`ExecutionPlan.run_deferred_compiled`) carries only the live
    slot values and the frame's state so far, and ``resume`` runs the next
    pure segment as one cached executable."""

    __slots__ = ("plan", "params", "inputs", "ctx", "vals", "outputs",
                 "op_idx", "request", "endpoint", "redispatches", "state",
                 "live", "is_compiled", "dseq", "retries", "next_retry")

    def __init__(self, plan: ExecutionPlan, params: dict, inputs: dict,
                 ctx: PipelineContext, vals: List[Any],
                 outputs: Dict[str, StreamBuffer], op_idx: int,
                 request: StreamBuffer):
        self.plan = plan
        self.params = params
        self.inputs = inputs
        self.ctx = ctx
        self.vals = vals
        self.outputs = outputs
        self.op_idx = op_idx
        self.request = request
        self.endpoint = None
        self.redispatches = 0
        #: delivery id + retransmit clock (scheduler-owned, DESIGN.md §10):
        #: ``dseq`` is minted once per logical request and reused by every
        #: retransmit and failover re-dispatch, so receivers dedup them
        self.dseq = None
        self.retries = 0
        self.next_retry = 0
        # compiled-mode fields (PendingQuery.compiled)
        self.state = None
        self.live = ()
        self.is_compiled = False

    @classmethod
    def compiled(cls, plan: ExecutionPlan, params: dict, inputs: dict,
                 state: dict, live: Tuple, outputs: Dict[str, StreamBuffer],
                 op_idx: int, request: StreamBuffer) -> "PendingQuery":
        pq = cls(plan, params, inputs, None, [], outputs, op_idx, request)
        pq.state = state
        pq.live = live
        pq.is_compiled = True
        return pq

    @property
    def client(self):
        """The tensor_query_client element this frame is paused at."""
        return self.plan.ops[self.op_idx].elem

    def resume(self, answer: StreamBuffer):
        """Inject the answer as the paused client's output and run on."""
        if self.is_compiled:
            return self._resume_compiled(answer)
        op = self.plan.ops[self.op_idx]
        if op.out_slots and op.out_slots[0] >= 0:
            self.vals[op.out_slots[0]] = answer
        if op.is_sink:
            self.outputs[op.name] = answer
        res = self.plan._exec_ops(self.params, self.ctx, self.vals,
                                  self.outputs, self.inputs,
                                  self.op_idx + 1, hoist_io=False,
                                  hoist_queries=False, defer_queries=True)
        if res is None:
            return self.outputs, self.ctx.next_state
        self.op_idx, self.request = res
        self.endpoint = None
        return self

    def _resume_compiled(self, answer: StreamBuffer):
        """One cached executable for the segment after the paused client."""
        plan = self.plan
        fn = plan.compiled_deferred_segment(self.op_idx)
        nxt = plan._next_client(self.op_idx)
        res, state = fn(self.params, self.state, self.live, answer,
                        self.inputs)
        if nxt is None:
            return {**self.outputs, **res}, state
        request, live, outputs = res
        self.op_idx = nxt
        self.request = request
        self.live = live
        self.outputs = {**self.outputs, **outputs}
        self.state = state
        self.endpoint = None
        return self
