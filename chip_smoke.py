#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, one result line each (any failure exits non-zero):

1. environment — torch/CUDA versions and the card's name and power limit;
2. build — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and prints the seconds and each
   kernel's registers and spill bytes as ``ptxas`` reports them;
3. kernels vs plain — K5 (flash prefill: bf16 on the tensor-core kernel,
   fp32 on the SIMT one) and K6 (split-KV flash decode) against their
   plain PyTorch versions.  3a, smoke shapes (ragged, unequal Sq/Sk, GQA,
   non-causal) in fp32 within atol = rtol = 2e-5 and in bf16 within one
   bf16 ulp (plus 1e-5 absolute) of the plain version computed in f32 from
   the same bf16 inputs, plus the serve path's strided q/k/v views and a
   misaligned bf16 view that must raise; 3b, the full-width bf16 shapes
   (K5 at L = 128, 512, 1024) at the same bf16 tolerance; times each
   kernel, its plain version and ``scaled_dot_product_attention`` (a
   yardstick the port never calls) with CUDA events, warm L2;
   3c. the wire codecs K1–K4 (quant8, sparse encode/decode) against their
   plain versions, bitwise: ragged smoke shapes (all-zero tiles, exact .5
   ties, f32 and bf16 sparse values, a block over capacity, a threshold
   through ``tensor_sparse_enc``; K3 at kb = 1, 8, 80 and 512 with its
   uncapped counts and frame-local indices, and a misaligned view on its
   scalar-load route) and the full-width stacked shapes of phase 6; times
   each kernel, its plain version and, where one PyTorch call computes the
   same function, that call (K2: a broadcast ``torch.mul``; K4:
   ``index_add_``; yardsticks the port never calls); K3 also with its
   input cold in L2, as one stacked encode, and the two torch passes it
   took over (the nonzero count and the index rebase);
4. serve — stablelm-1.6b at full width (24 layers, bf16, flash attention)
   behind ``serve_pipeline(slots=8, max_seq=1024)`` with 8 staggered
   clients; checks every answer, token conservation, the kernels' launch
   counts on this run (S4 2 a layer + 1 and S5 1 a layer a prefill and a
   decode tick, no eager norm or rotary on the card), continuous ==
   sequential decode bitwise for every
   stream (replayed in the slot it was served in), and a small fp32 server
   on the card against the port's CPU path;
5. (``--profile``) where one prefill and one decode tick spend device time
   (and, in phase 6, 8 fused offload ticks of each codec; in phase 7, one
   burst tick);
6. codec offload — 8 clients offload f32 [1, 512, 2048] activation frames
   (stablelm-1.6b width) with ``codec=quant8`` (6a) and ``sparse:0.15``
   (6b) to one ``tensor_filter`` server at ``query_batch=8`` for 4 ticks;
   checks one answer per client per tick, the fused frame count, wire bytes
   per request, no sparse truncation, fused == eager == batch-1 bitwise,
   every answer == the chain of plain versions on the card bitwise, the
   kernels' launch counts, and a small fp32 run on the card against the
   port's CPU path; then times 48 more fused ticks of each codec and
   prints their min/p10/median/p90/max ms;
7. pub/sub — 7a, Fig. 3 (``examples/multicam_pubsub.py``'s topology) at
   FullHD: two cameras (one clock skewed by 40 ms) publish 1920x1080 uint8
   frames over hybrid transport, a processing device scales them to
   224x224, detects and republishes, a display muxes both cameras and the
   inference, 16 ticks; checks conservation per topic (delivered +
   dropped + queued == published), the mux's pts (the earliest rebased
   camera pts), zero broker data bytes (a relay twin's broker bytes equal
   its channels'), and the processing output on the card against the
   port's CPU path on the first 3 frames (scaled uint8 frames |d| <= 1 on
   at most 1% of values, detector outputs within the GEMM bound printed);
   7b, 4 quant8 and 4 sparse:0.15 publishers of f32 [1, 512, 2048] frames
   whose subscribers (``mqttsrc ! tensor_filter ! mqttsink``, same codec)
   join late: each drains a 6-frame backlog in one burst, then steps one
   frame a tick; checks bursts in ``rt.stats()``, republished payloads
   bitwise equal to a ``burst=1`` twin's, stacked decode == per-frame
   decode, wire bytes per frame, and the K1–K4 launch counts (encode once
   per frame, decode once per burst or single step), with the peak
   memory; 7c, phase 6a at ``query_batch=0`` == its fused batch-8
   answers, bitwise.  With ``--profile``, one burst tick is profiled;
8. the rGLRU state family — recurrentgemma-9b at full width (38 layers:
   26 RG-LRU, 12 windowed attention with 2048-row ring caches; bf16,
   seeded random weights) behind ``serve_pipeline(slots=8,
   max_seq=4096)``, 8 staggered clients, 12 streams of 128–3000-token
   prompts (three longer than the window, two decoding across position
   2048); checks every answer, token conservation, the scan kernel's
   launches (one per recurrent layer per prefill) and that no flash
   kernel runs, continuous == sequential decode bitwise on 4 streams
   (8b), and an fp32 recurrentgemma-smoke server on the card against the
   port's CPU path (8c); prints prefill ms per request, decode ms per
   tick, tokens/s and the peak memory.  With ``--profile``, one 2048-token
   prefill and one decode tick are profiled.

9. compiled executables — the runtime's default (``jit=True``, as in the
   JAX package) runs phases 4, 6, 7 and 8 through CUDA graphs: the decode
   tick, the client segments and fused serve batches, and the bursts
   (``core/graphs.py``; a binding's first call runs eagerly, its second
   captures).  Phase 9 holds each graphed route bitwise against the same
   scenario at ``jit=False``, with equal K1–K6 and scan launch counts: 9a,
   phase 4's 12 stablelm-1.6b streams; 9b, recurrentgemma-9b at full width
   with 3 streams (one decoding across position 2048, the 3000-token
   prompt), each twin on a fresh server; 9c, phase 6's quant8 and
   sparse:0.15 offload (its 4 checked ticks, then 48 timed ones); 9d,
   held subscribers of stablelm-width quant8 and sparse:0.15 frames that
   drain 8 bursts of 4 frames each through the graphed ``step_n``.  Each
   route prints its ms per tick (decode, offload or burst tick; min /
   median / max) for graph and eager, the graphs captured, the graph
   memory (pool growth plus the bindings' buffers) and each twin's peak
   over what was allocated before it.  Phases 4, 6, 7b and 8 print the
   graphs they captured and their memory too.

10. failover and live reconfiguration — 10a, two stablelm-1.6b replicas
   (bf16, 24 layers, 8 slots, ``max_seq=1024``, weights from one seed)
   and 12 clients; the first replica dies before tick 6 with every
   stream mid-generation, the survivor regenerates them by prefill replay:
   every answer full length and bitwise a fault-free twin fleet's,
   re-dispatches, declared drops, token conservation, one unplanned
   reconfiguration, K5/K6 launches; prints the ticks from the kill to the
   last answer, the host ms of the recovery tick (and of its replay
   prefills) and of the tick after it, decode ms/tick before and after,
   graph memory and peak.  10b, phase 6a's offload with two servers (3
   ``codec=none`` clients, then 5 quant8 ones), the first killed on its
   3rd answer of tick 3, so the quant8 group is popped and unserved:
   every answer bitwise the fault-free twin's, the orphans counted, K1/K2
   launches.  10c, one stablelm-1.6b server with 6 streams
   mid-generation; ``lm`` is swapped for a model_serve of the same config
   with a second seed's weights: the commit lands at its tick boundary
   unblocked, every stream replays, every answer is bitwise
   ``sequential_decode`` on the new weights; prints host ms of the commit
   tick and the two after against the steady median, and the graphs
   captured.  10d, fp32 stablelm-smoke: park-deadline error frames with
   no survivor; graph memory over 4 kill/revive and 4 swap cycles (the
   last at most the first plus one binding); through a kill, the graph
   route == ``jit=False`` (answers and stats) and the card == the port's
   CPU path (answers).

11. staged pipeline-parallel serving — 11a, phase 4's clients (the same
   joins, prompts and generation lengths) on stablelm-1.6b split over 2
   and then 4 ``model_serve_stage`` pipelines (12 and 6 layers a stage,
   one Device each, every one given phase 4's seed): every answer bitwise
   phase 4's in the same slot, and ``sequential_decode``'s on the tree the
   stages compose to; hop ledgers balance, one decode graph a stage, the
   hop channels' bytes equal what the hops imply at 2 B an activation;
   prints the prefill chain's ms per request, decode ms per tick (min /
   median / max) and each stage's hop ms, tokens/s, hop bytes a tick and
   a prefill chain, graphs, peak and K5/K6 launches.  11b, 12 streams on
   the 4-stage chain with a standby for stage 2, which dies before tick
   6 with every stream mid-generation: every answer bitwise a fault-free
   twin's, no token dropped, no stream re-prefilled, stage 2 replayed on
   the standby from the retained activations; prints the recovery tick's
   host ms and whether a batch-1 decode step is bitwise the hop's row (the
   replay steps run at the serve batch in the stream's slot row, and must
   be).  11c, stage 1 of the 2-stage chain swapped to a second seed's
   weights with 6 streams mid-generation: the commit lands, the epoch
   fence moves, no stream restarts, every stream's second answer (started
   after the commit) is bitwise the composite model's, no binding on the
   retired slice survives and the live graphs do not grow.  11d, fp32
   ``stablelm-smoke-4l`` with flash over 2 stages on the card (K5's fp32
   route) == the port's CPU path.

12. tenant QoS and autoscaling — 12a, phase 4's server (stablelm-1.6b,
   bf16, 8 slots, ``max_seq=1024``, phase 4's seed) under
   ``Runtime(qos=three_tier_qos(**QOS_KW))`` with an ``Autoscaler`` that
   may grow one replica from the same seed, and 12 clients, 4 a tier
   (realtime, standard, best-effort), 2 requests each (prompts 128–512,
   generations 16–64), each stopping between requests once answered:
   every answer full length and bitwise ``sequential_decode`` in its
   slot, the grown replica's params bitwise the hub's, every shed an
   error frame with a reason matching the tenant ledgers (conservation
   asserted by ``rt.stats()``), standard and best-effort shed, realtime
   never and its p99 ticks at most best-effort's, one scale-up and one
   scale-down, graph bytes after the scale-down at most before the
   scale-up plus one binding, K5/K6 launches; prints each tenant's
   admitted, served, sheds by reason and p50/p99 ticks, decode ms per
   tick, the host ms of the scale-up's request, commit and capture ticks
   and of the scale-down's commit tick against the run's median, and
   the peak.  12b, the same contract on fp32 stablelm-smoke-flash (4
   slots, 6 clients) and on a 2-stage stablelm-smoke-4l chain: the card
   == the port's CPU path (answers, error frames, tenant and autoscale
   stats; hop servers pass-through, ledgers balance).

13. the lossy network and effectively-once delivery — every lossy run
   has ``Runtime(delivery=DeliveryPolicy())`` and a ``FaultFabric``
   (``core/netfault.py``) installed through ``tests/chaoslib.py``'s
   ``lossy_endpoint`` on a server's request link and every answer link,
   with fixed seeds and pinned client ids (the fault schedule is the one
   the CPU rehearsal saw).  13d first: phase 4's graphed serve with
   delivery on over zero-rate links against delivery off, in turns (off,
   on, on, off): answers bitwise (and phase 4's), the memcpy calls the
   host issues in ticks 6–59 of the first pair equal under the profiler
   (the CRC reads no CUDA tensor; the device-to-host records print
   beside them), the median ticks of the unprofiled pair side by side.  13a: phase 4's clients and server, every
   link dropping, duplicating, corrupting, delaying and reordering
   (0.05/0.12/0.05/0.05/0.05): every stream bitwise its twin's where it
   was served in the twin's slot, else ``sequential_decode`` in its slot;
   every fault class fired, message and token conservation, one prefill
   a request, the twin's token count and K5 launches, K6 once a layer a
   decode tick; the replay cache holds what each client got.  13b: phase
   6's 8 clients (quant8, then sparse:0.15) over the same kind of links
   until each has 4 answers: each bitwise phase 6's, corrupt requests
   rejected, the server's served frames == its guard's accepted, the
   replay cache bitwise phase 6's; prints K1–K4 launches beside the
   retransmits.  13c: phase 11a's 2-stage chain with the stage-1 hop
   link lossy (requests dup 0.12, corrupt 0.06, drop 0.03; answers dup
   0.10): streams bitwise phase 4's in the same slots, ledgers balance,
   no hop failed, hop retransmits/dups/corrupt > 0, one decode hop a
   tick, launches == 11a's.  13e: an ``EdgeSensor``'s numpy frames reach
   a subscriber pipeline on the card, ``EdgeQueryClient.infer`` round
   trips through a server there, bitwise the model.

14. the attention and MoE decoder zoo — 14a, K5 (bf16 on the
   warp-specialised tensor-core kernel, fp32 on the persistent tiled SIMT
   kernel ``scalar_wide``) and K6 (flash_decode_gqa.cu: bf16 on its
   tensor-core and SIMT routes, fp32 at granite's group of 48 on its f32
   route ``gqa_f32``; gemma3's fp32 group of 2 on the split-KV
   flash_decode.cu) at the shapes 14b's and
   14c's serve phases give them (``_zoo_kernel_shapes``): K5 at
   granite-20b's [48, L, 128] (MQA, kv_groups 48), L = 128, 512, 1024, and
   gemma3-4b's [8, L, 256] (kv_groups 2), L = 128, 512, 1024, 2000 (the
   longest prompt) and 2048; K6 at granite's 8 slots x 48 heads over its
   [8, 1024, 1, 128] serve cache and gemma3's 8 x 8 over [8, 4096, 4,
   256], positions up to max_seq - 1; each dtype against its plain version
   (the bf16 and fp32 limits above), timed beside SDPA and the bounds,
   with the compiled kernel's name and ptxas's registers and spills
   (phase 3b's rows, same code).  14g, S4 (``norm.cu``) and S5
   (``rotary.cu``), the model step's norm and rotary, at granite-20b's
   prefill and decode shapes (RMSNorm [1774, 6144] and [64, 6144]; q [1,
   1774, 48, 128] + k [1, 1774, 1, 128] and 64 decode rows) and
   stablelm-1.6b's prefill (LayerNorm [1020, 2048]; q, k [1, 1020, 32, 64],
   rot 16): S5 bitwise its plain version, S4 within one bf16 ulp of it (of
   |y| + |bias| for LayerNorm) and rows alone bitwise the same rows in the
   batch; timed beside the plain versions (the eager expressions they
   replaced), the bounds and ptxas; S4 also beside PyTorch's
   ``rms_norm``/``layer_norm`` on the same f32 weights (time, ulps, and
   whether its rows depend on the batch) and on bf16 weights.  14b,
   granite-20b whole
   (52 layers, bf16, ``granite-20b-flash``) behind ``serve_pipeline(slots=
   8, max_seq=1024)``, phase 4's client schedule with prompts of 128–512
   tokens; 14c, gemma3-4b whole (``gemma3-4b-flash``, 34 layers LLLLLG)
   at ``max_seq=4096`` with prompts of 128–2000 tokens, so the 1024
   window binds on the local layers; 14d, mixtral-8x22b at full width and
   8 of 56 layers; 14e, deepseek-v2-236b at full width, the dense first
   layer and 3 MoE layers (MLA latent cache, 160 experts top-6, 2
   shared).  Each: every answer bitwise ``sequential_decode`` in its slot,
   token conservation, S4/S5 launches a prefill and a decode tick by the
   model's layers and no eager norm or rotary on the card, K5/K6 launches
   by head dim and by compiled kernel
   (one a global layer a prefill and a decode tick, bf16 at 128/256 all
   on the warp-specialised prefill and the grouped-head decode; phase 4's
   head dim 64 all on the one-warpgroup prefill and the split-KV decode),
   the (token, expert) choices capacity
   dropped in each prefill and none at decode (per-row capacity); prints
   prefill ms per request, graphed decode ms per tick, tokens/s, weight
   GB and peak memory.  Each model is freed before the next loads.  14f,
   fp32 on the card == the port's CPU path (logits): every zoo smoke
   preset (qwen, granite, gemma3, mixtral, deepseek, internvl2 through
   ``Model.prefill`` with patches, the int8 KV cache) and granite-20b at 2
   layers and gemma3-4b at 6 (LLLLLG) at full width, so K5/K6 fp32 run at
   128 and 256 on a model path (K5 on ``scalar_wide`` at both, K6 on
   ``gqa_f32`` at granite's group of 48: launches by kernel checked),
   within 3e-5 of the largest logit; then
   each case again with TF32 on in the card's matmuls, which must read
   more than that limit.

15. the rest of the zoo: Mamba-2, ``launch/serve.py``, whisper and the
   stacked layout — 15a, the SSD kernels against their plain versions:
   S2 (``ssd_scan.cu``, the inter-chunk state recurrence) bitwise at nc =
   1, odd chunk counts, a ragged N x hd (its 4-byte route), h0 given and
   absent, and a row alone vs in a batch of 3; S3 (``ssd_decode.cu``, one
   token's state update and readout) within atol = rtol = 2e-5 on f32 and
   bf16 column views of an ``xbc`` row, with and without an active mask
   (inactive rows keep h bitwise), a row alone bitwise the same row in a
   batch of 8, and a view with element stride 2 refused; both timed at
   mamba2-130m's shapes (S2 [1, 16, 24, 128, 64], a 2048-token prompt;
   S3 at 8 slots [8, 24, 128, 64]) beside their byte bounds, their plain
   versions and ``ptxas``.  15b, ``launch/serve.py``'s ``LMQueryServer``
   with the full mamba2-130m (24 layers, bf16) and 8 edge clients at 32-
   and 2048-token prompts (16 and 64 tokens generated): the graphed
   server's answers bitwise its ``jit=False`` twin's, S2 once per layer
   for the batch's prefill and S3 once per layer per step; prefill ms,
   graphed decode ms a step, tokens/s, weight GB, peak.  15c, mamba2-130m
   behind ``serve_pipeline(slots=8, max_seq=1024)`` with 14b's schedule,
   as 14b–14e (every answer bitwise ``sequential_decode`` in its slot,
   S2/S3 launches per prefill and tick).  15d, whisper-large-v3 at full
   width (32 + 32 layers, bf16): ``Model.prefill`` of 4 x 1500 frames
   with 16-token prompts, then 32 decode steps; finite logits, per-row
   positions; prefill ms, decode ms a step, weight GB, peak.  15e, fp32
   card == the port's CPU path within 3e-5 of the largest logit:
   mamba2-smoke, whisper's smoke config, mamba2-130m at 2 layers and
   whisper at 2 + 2 layers at full width, and the stacked layout of the
   ``dense_gqa_bias``, ``mla_moe_shared``, ``hybrid_rglru`` and
   ``ssm_mamba2`` families; each rerun with TF32 on as a control that
   must read above the limit.

16. training (``launch/train.py``, ``launch/steps.py``, AdamW, the data
   pipeline and checkpoints) — 16e first: the scans' backward kernels
   against their plain versions (S1 bitwise at ragged widths and ring-
   stage edges and at 16c's [2, 2048, 4096]; S2's d_states and d_h0
   bitwise and d_decay within 1e-5 of the absolute products' sum, at nc =
   1, a ragged N x hd and 16b's [8, 16, 24, 128, 64]; rows alone == in a
   batch), timed beside their byte bounds, plain versions and ptxas.  16a,
   stablelm-1.6b whole (bf16, stacked, per-block remat) through
   ``launch/train.py`` for 20 steps at 8 x 512: finite losses and grad
   norms, every parameter moved, the mean loss of the last 5 steps below
   the first 5's; median ms a step over steps 3-20, tokens/s, the model-
   FLOP share of the dense bf16 peak, peak GiB, one profiled step and the
   device ms of forward + backward and of AdamW; no kernel launches (S4
   and S5 have no backward, so its norms and rotary run the eager
   expression, counted in ``layers.EAGER_ON_CARD`` and printed).  16b,
   mamba2-130m whole
   at 8 x 2048 (nc = 16): 5 steps with a checkpoint at step 5 (restored
   bitwise), then a run to step 10 resumed from it whose first loss is
   bitwise the step-5 state's loss on batch 0 (a fresh iterator, as the
   reference's launcher); S2 twice forward (remat) and once backward a
   layer a step.  16c, recurrentgemma-9b at full width, cut to 6 of 38
   layers (RRLRRL), 5 steps at 2 x 2048; S1 launches likewise.  16d, fp32
   card == CPU for two train steps of every smoke preset, list and
   stacked layouts, at 64 tokens (more than the smoke chunk of 16): loss,
   grad norm, every gradient leaf, m and v within 1e-4 |cpu| + 2e-5
   max|cpu leaf|, the parameters within that + 2 lr.

17. mesh-sharded serving (M11) on slots of the one card (a mesh's slots
   may share a device; no multi-GPU number exists on a one-card machine)
   — 17a, phase 6's 8 offload clients (quant8, then sparse:0.15) on
   ``Runtime(mesh=<8 cuda:0 slots>, shard_mode="always")`` for 4 checked
   and 32 timed ticks: every answer bitwise the meshless runtime's (fused)
   and the meshless eager-route twin's (the batcher routes codec groups
   as under a mesh: one stacked host decode, the single-device serve, the
   serversink's encode), every frame sharded, K1–K4 launches equal to the
   eager-route twin's, the mesh-placed params one copy on the card; mixed
   codecs (groups of 4 that do not tile 8 slots serve fused on one
   device), ``fused_wire=False`` (one sharded batch) and a mid-batch kill
   (bitwise the fault-free mesh twin), each against its twin;
   ``shard_mode="auto"`` probes once and its pick prints; the host ms a
   tick (median of 32) sharded, single on the same wire route and single
   fused; ``replicated`` over 4 slots allocates nothing.  17b, the
   sequence-parallel SSD: mamba2-130m whole (24 layers, bf16) at 8 x 2048
   on a (data 2, model 4) mesh of cuda:0 slots through
   ``make_prefill_step(model, mesh)``: logits and every cache leaf within
   2e-2 of each tensor's largest element of the single-device prefill, the
   same greedy first token in all 8 rows, S2 once a layer a slot; one
   train step through ``make_train_step(model, mesh)`` (S2's backward once
   a layer a slot; the loss within 16d's tolerance of the single-device
   step's and every bf16 gradient leaf within 5e-2 of its leaf's largest
   element); fp32 at 2 layers of full width: the prefill within 1e-4 of
   the largest element and the loss and every gradient leaf within 16d's
   tolerance; the (1, 1) host mesh of ``launch/train.py`` takes the
   sequence-parallel path in every layer and is bitwise the single-device
   step.  17c, one mixtral-8x22b MoE block at full width (bf16, 4.8 GB)
   on 8 x 512 tokens over a (1, 4) mesh of cuda:0 slots: expert-parallel
   and ``moe_force_tp`` within 2e-2 of max|y| of ``apply_moe`` without a
   mesh, the aux loss equal, the split weights views (0 bytes); device ms
   of the dense block, EP and TP.  17d reruns 17a over distinct GPUs when
   more than one is visible, and otherwise prints that none is.

18. the pod-axis pipeline-parallel decode (``launch/pp_serve.py``, the
   paper's Fig. 2 at pod scale) and the examples' twins — 18a,
   stablelm-1.6b whole (24 layers, bf16, flash attention) on meshes of
   (P, 1, 1) ``cuda:0`` slots, P = 2 and 4: one 512-token prompt a row for
   8 rows through ``prefill_stacked`` at ``max_seq=1024``, then 16
   ``pp_serve`` steps with the cache carried, every launch count set to 0
   just before; each microbatch's tokens (every step) and cache rows
   bitwise ``decode_step_stacked`` run on that microbatch alone, K6
   exactly 24 P times a step and K5 24 times (head dim 64's kernels), the
   outputs on the card and no aten op of a step on a CPU tensor (a
   dispatch mode watches one more step); reports token agreement with
   the full-batch stacked step, median host ms a step and queued device
   ms of both, peak GiB.  18b, the fp32 smoke stablelm at 4 layers
   through ``pp_serve`` on the card against the port's CPU path, P = 2
   and 4: tokens equal over 4 steps, caches within 2e-5 of the largest
   element.  18c, the 11 twins under ``examples_torch/`` with ``--device
   cuda``, 6 subprocesses at once: exit 0, the script's last line, wall
   seconds each.

19. the analysis tools (M14: ``launch/dryrun.py``,
   ``launch/hlo_analysis.py``, ``kernels/cost.py``) — 19a, six steps
   (``DRY_STEPS``: stablelm-1.6b whole with ``use_flash_attn``, a prefill
   of 8 x 2048 (K5) and a decode step of 8 slots at max_seq 4096 (K6);
   mamba2-130m whole, a prefill of 8 x 2048 (S2), a decode step (S3) and a
   train step at 8 x 2048 (S2's backward); recurrentgemma-9b cut to one
   pattern unit and its tail, a prefill of 2 x 2048 (S1)) each traced on
   ``meta`` under ``hlo_analysis.CostCounter``, then run on the card with
   seeded weights under another: FLOPs, bytes and each kernel's calls
   equal (hard), the card's kernel calls equal the ``LAUNCHES`` delta
   (hard), the meta peak within DRY_PEAK_TOL of the card's increase of
   ``max_memory_allocated`` (hard), the step's device ms (CUDA events)
   beside the count's ``compute_s`` and ``memory_s`` on the H100
   constants and the share of the larger.  19b, ``python -m
   repro_torch.launch.dryrun --mesh card`` over every arch x shape and
   the ``use_flash_attn`` stablelm-1.6b prefill_32k and decode_32k, 8
   processes at once: each combo compiled or skipped with its reason,
   none FAILED; one line each with its dominant term and its peak against
   the card's 80 GB.

Each phase's wall seconds print on a line of their own.

Phase 3b also times K5's fp32 route (``flash_prefill.cu``, register-tiled
f32 FMAs) at f32 [32, L, 64], L = 128, 512 and 1024, and at L = 512 with
8 kv heads (GQA, 4 groups), beside its bound (float32 operations outside
the tensor cores at 67 TFLOP/s, and its byte bound) and fp32 SDPA, naming
the kernel SDPA's backend ran (from the profiler).

Phase 3d holds the RG-LRU scan kernel (a new kernel; the JAX package
scans with ``jax.lax.associative_scan``) against its plain step-by-step
loop, bitwise, on ragged smoke shapes, at the edges of its ring stages,
for a row alone and in a batch, and at f32 [1, 3000, 4096]; it times the
kernel beside its byte bound and prints its ring as the kernel reports it.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FP32_TOL = 2e-5
BF16_ATOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


#: device cycles the stream sleeps before a timed loop (~10 ms at the
#: H100's 1.98 GHz boost clock): longer than the host takes to enqueue it
SLEEP_CYCLES = 20_000_000


def cuda_ms(fn, iters=20, warmup=3):
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls,
    warm L2.  The calls are queued behind a device sleep, so they run back
    to back and the reading is the card's time, not the host's time to
    enqueue them (a wrapper's Python and ctypes overhead can exceed a fast
    kernel's device time)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def _excess(out, ref):
    """-> (excess over the tolerance's slack, the tolerance) of a kernel's
    output against its f32 plain version ``ref``: atol = rtol = FP32_TOL
    for fp32, one bf16 ulp + BF16_ATOL for bf16."""
    import torch
    if out.dtype == torch.float32:
        return ((out - ref).abs() - FP32_TOL * ref.abs()).max().item(), \
            FP32_TOL
    return bf16_excess(out, ref), BF16_ATOL


def bf16_excess(out, ref):
    """Largest amount by which |out - ref| exceeds one bf16 ulp of ref (8
    significant bits); the bf16 tolerance is an excess of at most
    BF16_ATOL, the f32 summation-order noise of results near zero."""
    import torch
    mag = ref.abs().clamp_min(2.0 ** -100)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((out.float() - ref).abs() - ulp).max().item()


def _ptxas_regs(ptxas, lib, kernel, *tags):
    """'<registers> registers, spill <stores>/<loads> B' of the kernel
    instantiation whose template tags (phase 2's names) include ``tags``."""
    for r in ptxas.get(lib, []):
        name = r["kernel"]
        if name.startswith(kernel + "<") and \
                all(t in name[len(kernel):].strip("<>").split(",")
                    for t in tags):
            return (f"{r.get('registers', '?')} registers, spill "
                    f"{r.get('spill_stores', '?')}/{r.get('spill_loads', '?')}"
                    f" B")
    return "not in this run's build report"


#: 3b's full-width shapes, stablelm-1.6b's (32 heads of 64), by row name:
#: K5 as (BH, kv_groups, head dim, L, dtype, model), K6 as (slots, heads,
#: kv heads, head dim, max_seq, dtype, model)
K5_FULL = {
    **{f"K5 L={L}": (32, 1, 64, L, "bfloat16", "stablelm-1.6b")
       for L in (128, 512, 1024)},
    **{f"K5 fp32 L={L}": (32, 1, 64, L, "float32", "stablelm-1.6b")
       for L in (128, 512, 1024)},
    "K5 fp32 L=512 gqa4": (32, 4, 64, 512, "float32", "stablelm-1.6b")}
K6_FULL = {"K6 S=8 max_seq=1024": (8, 32, 32, 64, 1024, "bfloat16",
                                   "stablelm-1.6b")}


def _k5_row(rn, bh, grp, d, L, dtype, ptxas):
    """K5 (causal) at [bh, L, d] with ``grp`` kv groups on fresh inputs,
    held to its plain version (fp32 within FP32_TOL, bf16 within one ulp +
    BF16_ATOL), timed beside it and SDPA (for fp32, with the kernel SDPA's
    backend ran), with its bounds and ptxas line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attn as fa
    dt = getattr(torch, dtype)
    q = rn(bh, L, d, dtype=dt)
    k, v = (rn(bh // grp, L, d, dtype=dt) for _ in range(2))
    o = fa.flash_attention(q, k, v, causal=True, kv_groups=grp)
    r = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                 causal=True, kv_groups=grp)
    torch.cuda.synchronize()
    err, tol = _excess(o, r)
    check(err <= tol, f"K5 {dtype} [{bh},{L},{d}] g{grp}: excess {err} "
                      f"over the tolerance's slack {tol}")

    def sdpa():
        return F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True,
            **({"enable_gqa": True} if grp > 1 else {}))
    row = dict(shape=[bh, L, d], kv_groups=grp,
               max_abs_err=(o.float() - r).abs().max().item(), excess=err,
               ms=cuda_ms(lambda: fa.flash_attention(
                   q, k, v, causal=True, kv_groups=grp)),
               plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
                   q, k, v, causal=True, kv_groups=grp), iters=5),
               library_ms=cuda_ms(sdpa),
               **cost.bound(cost.flash_attention(bh, L, L, d, d, grp, True,
                                                 dt)))
    row["kernel"] = fa.prefill_kernel(dt, d)
    if dt == torch.bfloat16:
        row["ptxas"] = _ptxas_regs(
            ptxas, "flash_prefill_sm90", "flash_prefill_sm90_kernel"
            if d == 64 else "flash_prefill_ws_kernel", f"D={d}")
    else:
        _, _, prof = _profile(sdpa)
        row["library_kernel"] = prof[0][0] if prof else "not traced"
        row["ptxas"] = _ptxas_regs(ptxas, "flash_prefill",
                                   "flash_prefill_f32_kernel", "cp.async") \
            if d == 64 else _ptxas_regs(ptxas, "flash_prefill",
                                        "flash_prefill_f32_tiled_kernel",
                                        "cp.async", f"D={d}")
    return row


def _k6_row(rn, rng, S, H, kv, d, smax, dtype, ptxas):
    """K6 for S slots of H heads over a [S, smax, kv, d] cache on fresh
    inputs, positions drawn from [128, smax) with the first slot at 0 and
    the last at smax - 1, held to its plain version and timed beside it
    and SDPA (boolean mask), with its bounds (the rows up to each position)
    and ptxas line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_attn as fa
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    q = rn(S * H, d, dtype=dt)
    kc, vc = (rn(S, smax, kv, d, dtype=dt) for _ in range(2))
    pos_np = rng.integers(128, smax, S).astype(np.int32)
    pos_np[0], pos_np[-1] = 0, smax - 1
    pos = torch.as_tensor(pos_np, device=dev)
    o = fa.flash_decode(q, kc, vc, pos, kv_groups=H // kv)
    r = fa.flash_decode_plain(q.float(), kc.float(), vc.float(), pos,
                              kv_groups=H // kv)
    torch.cuda.synchronize()
    err, tol = _excess(o, r)
    check(err <= tol, f"K6 {dtype} S{S} H{H} kv{kv} d{d} max_seq {smax}: "
                      f"excess {err} over the tolerance's slack {tol}")
    kern = fa.decode_kernel(dt, d, H // kv)
    q4 = q.reshape(S, H, 1, d)
    k4, v4 = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    mask = (torch.arange(smax, device=dev)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    n_rows = int((pos_np.astype(np.int64) + 1).sum())
    return dict(
        cache=[S, smax, kv, d], heads=H, pos=pos_np.tolist(),
        max_abs_err=(o.float() - r).abs().max().item(), excess=err,
        ms=cuda_ms(lambda: fa.flash_decode(q, kc, vc, pos,
                                           kv_groups=H // kv)),
        plain_ms=cuda_ms(lambda: fa.flash_decode_plain(
            q, kc, vc, pos, kv_groups=H // kv), iters=5),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask,
            **({"enable_gqa": True} if H > kv else {}))),
        **cost.bound(cost.flash_decode(S, H, kv, d, d, smax, dt,
                                       rows=n_rows)),
        kernel=kern, geometry=list(fa.decode_geometry(smax, kv, H // kv, d,
                                                      dt)),
        ptxas=_ptxas_regs(ptxas, "flash_decode", "flash_decode_partial_kernel",
                          f"D={d}", "bf16" if dt == torch.bfloat16 else "f32")
        if kern == "split" else
        _ptxas_regs(ptxas, "flash_decode_gqa",
                    f"gqa_decode_{kern.removeprefix('gqa_')}_kernel",
                    f"D={d}", *([f"MT={min(-(-H // kv // 16), 4)}"]
                                if kern == "gqa_f32" else [])))


def _kernel_rows(phase, k5, k6, g, rng, ptxas):
    """K5 and K6 at each shape of the tables ``k5`` and ``k6`` (see
    K5_FULL): held to their plain versions, timed, printed -> rows by
    name."""
    def rn(*shape, dtype):
        import torch
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    rows = {}
    for name, (*shape, model) in k5.items():
        rows[name] = dict(model=model, dtype=shape[-1],
                          **_k5_row(rn, *shape, ptxas))
    for name, (*shape, model) in k6.items():
        rows[name] = dict(model=model, dtype=shape[-1],
                          **_k6_row(rn, rng, *shape, ptxas))
    for name, row in rows.items():
        print(f"phase {phase} {name} ({row['model']}, {row['kernel']}): "
              f"max abs err "
              f"{row['max_abs_err']:.3e} (excess over "
              f"{'atol=rtol' if row['dtype'] == 'float32' else '1 ulp'} "
              f"{row['excess']:.1e}), kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
              f"bounds bytes {row['bytes_bound_ms']:.5f} / operations "
              f"{row['ops_bound_ms']:.5f} ms ({row['bound_by']} bound, "
              f"{row['bound_ms'] / row['ms']:.0%} of it); ptxas "
              f"{row['ptxas']}"
              + (f"; sdpa ran {row['library_kernel'][:90]}"
                 if "library_kernel" in row else ""))
    return rows


def phase_env():
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"phase 1 env: python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def _kernel_name(mangled):
    """The ``..._kernel`` identifier inside a mangled name (identifiers are
    length-prefixed), plus its dtype where it is a template."""
    tag = "bf16" if "kernelI13__nv_bfloat16" in mangled else \
        "f32" if "kernelIf" in mangled else ""
    if "sparse_enc_kernel" in mangled and "Lb1E" in mangled:
        tag += ",scalar loads"          # K3's kScalar instantiation
    if "flash_prefill_f32_kernel" in mangled or \
            "flash_prefill_f32_tiled_kernel" in mangled:  # K5 fp32's kVec
        tag = "cp.async" if "Lb1E" in mangled else "4-byte loads"
    m = re.search(r"(?:sm90|ws|tiled|combine|decode_\w+)_kernelI"
                  r"(?:13__nv_bfloat16|f)?Li(\d+)E", mangled)
    if m:                                       # K5/K6's head dim
        tag += f"{',' if tag else ''}D={m.group(1)}"
    m = re.search(r"gqa_decode_f32_kernelILi\d+ELi(\d+)E", mangled)
    if m:                                       # K6 fp32's m16 tiles
        tag += f",MT={m.group(1)}"
    m = re.search(r"rglru_scan(?:_bwd)?_kernelILb([01])E", mangled)
    if m:                                       # S1's kVec (and backward's)
        tag = f"{'16' if m.group(1) == '1' else '4'} B copies"
    m = re.search(r"ssd_state_scan(?:_bwd)?_kernelILb([01])E", mangled)
    if m:                                       # S2's kVec (and backward's)
        tag = "float4" if m.group(1) == "1" else "float"
    m = re.search(r"norm_rows_kernelI(?:13__nv_bfloat16|f)Li(\d+)ELi(\d+)E",
                  mangled)
    if m:       # S4's chunk and chunks a thread (not a head dim: "rows_")
        tag = tag.partition(",D=")[0] + ",VEC={},VPT={}".format(*m.groups())
    m = re.search(r"rotary_kernelI(?:13__nv_bfloat16|f)Li(\d+)E([ilx])E",
                  mangled)
    if m:                                       # S5's chunk and position type
        tag += f",VEC={m.group(1)},pos=" + \
            ("int32" if m.group(2) == "i" else "int64")
    names = []   # a length may follow a hex digit of a namespace's hash,
    for i in range(len(mangled)):   # so the shortest identifier wins
        m = re.match(r"\d+", mangled[i:])
        if m:
            name = mangled[i + m.end():i + m.end() + int(m.group())]
            if re.fullmatch(r"[A-Za-z]\w*_kernel", name):
                names.append(name)
    if not names:
        return mangled
    return min(names, key=len) + (f"<{tag}>" if tag else "")


def ptxas_report(log):
    """``nvcc -Xptxas -v`` output -> [{kernel, registers, spill_stores,
    spill_loads}], one per compiled kernel."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": _kernel_name(m.group(1))}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    log = build.build_all()
    secs = time.perf_counter() - t0
    report = {n: ptxas_report(e["ptxas"]) for n, e in log.items()}
    print(f"phase 2 build: {secs:.1f} s for {sorted(log)}")
    for n, rows in report.items():
        print(f"phase 2 ptxas {n}: " + ("; ".join(
            f"{r['kernel']} {r.get('registers', '?')} registers, spill "
            f"{r.get('spill_stores', '?')}/{r.get('spill_loads', '?')} B "
            f"stores/loads" for r in rows) or "loaded from an earlier "
                                               "build, no report"))
    return secs, report


def phase_kernels(seed, ptxas):
    import torch
    from repro_torch.kernels import flash_attn as fa
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # -- smoke shapes, fp32 (SIMT K5) and bf16 (tensor-core K5) ---------------
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).rpartition(".")[2]
        w = float("-inf")
        for bh, sq, sk, grp, causal in [
                (4, 64, 64, 1, True), (8, 100, 100, 4, True),
                (8, 77, 77, 4, False), (4, 96, 96, 2, True),
                (2, 130, 130, 1, False), (4, 100, 130, 2, True),
                (4, 130, 100, 1, True)]:
            q, k, v = (rn(bh, sq, 64, dtype=dt),
                       rn(bh // grp, sk, 64, dtype=dt),
                       rn(bh // grp, sk, 64, dtype=dt))
            o = fa.flash_attention(q, k, v, causal=causal, kv_groups=grp)
            r = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                         causal=causal, kv_groups=grp)
            torch.cuda.synchronize()
            err, tol = _excess(o, r)
            check(err <= tol, f"K5 {tag} {bh}x{sq}x{sk} g{grp} "
                              f"causal={causal}: error {err}")
            w = max(w, err)
        for S, H, KV, smax in [(3, 8, 2, 300), (3, 4, 4, 64), (3, 4, 1, 129)]:
            q = rn(S * H, 64, dtype=dt)
            kc, vc = (rn(S, smax, KV, 64, dtype=dt) for _ in range(2))
            pos = torch.tensor([0, smax // 2, smax - 1], dtype=torch.int32,
                               device=dev)
            o = fa.flash_decode(q, kc, vc, pos, kv_groups=H // KV)
            r = fa.flash_decode_plain(q.float(), kc.float(), vc.float(), pos,
                                      kv_groups=H // KV)
            torch.cuda.synchronize()
            err, tol = _excess(o, r)
            check(err <= tol, f"K6 {tag} S{S} H{H} KV{KV} Smax{smax}: "
                              f"error {err}")
            w = max(w, err)
        worst[tag] = w
    # the serve path's q/k/v: strided [H, L, 64] views of [1, L, H, 64]
    L, H = 300, 32
    q2, k2, v2 = (rn(1, L, H, 64, dtype=torch.bfloat16).permute(0, 2, 1, 3)
                  .reshape(H, L, 64) for _ in range(3))
    check(q2.stride() == (64, H * 64, 1), f"serve view strides {q2.stride()}")
    o = fa.flash_attention(q2, k2, v2, causal=True)
    r = fa.flash_attention_plain(q2.float(), k2.float(), v2.float(),
                                 causal=True)
    err = bf16_excess(o, r)
    check(err <= BF16_ATOL, f"K5 bf16 strided serve view: error {err}")
    worst["bfloat16"] = max(worst["bfloat16"], err)
    bad = rn(8, 100, 65, dtype=torch.bfloat16)[:, :, 1:]    # 2-byte offset
    try:
        fa.flash_attention(bad, bad, bad)
        raise SmokeFailure("K5 took a misaligned bf16 view")
    except ValueError:
        pass
    # fp32 takes any strided view: a misaligned one runs K5 fp32's 4-byte
    # loads instead of cp.async
    q2, k2, v2 = (rn(8, 100, 65)[:, :, 1:] for _ in range(3))
    for causal in (True, False):
        o = fa.flash_attention(q2, k2, v2, causal=causal)
        r = fa.flash_attention_plain(q2, k2, v2, causal=causal)
        err, _ = _excess(o, r)
        check(err <= FP32_TOL, f"K5 fp32 misaligned view causal={causal}: "
                               f"error {err}")
        worst["float32"] = max(worst["float32"], err)
    print(f"phase 3a kernels smoke shapes: fp32 pass (atol=rtol={FP32_TOL}, "
          f"worst excess {worst['float32']:.2e}); bf16 pass (1 ulp + "
          f"{BF16_ATOL}, worst excess {worst['bfloat16']:.2e}), strided "
          f"serve view included; a misaligned bf16 view raises, a misaligned "
          f"fp32 view passes")

    return _kernel_rows("3b", K5_FULL, K6_FULL, g, rng, ptxas)


def _bits(t):
    """A tensor's bytes, for bitwise comparison (+0 and -0 differ)."""
    import torch
    t = t.contiguous()
    return t.view(torch.uint8) if t.element_size() == 1 else \
        t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
            t.element_size()])


def same_bits(a, b, what):
    import torch
    check(a.dtype == b.dtype and a.shape == b.shape and
          torch.equal(_bits(a), _bits(b)),
          f"{what}: kernel and plain version differ "
          f"({a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)})")


def _tie_tiles(rng, n_tiles):
    """f32 tiles whose x/scale lands exactly on k + 0.5 (rounding ties)."""
    tiles = []
    inv127 = np.float32(1.0) / np.float32(127.0)
    for _ in range(n_tiles):
        amax = np.float32(rng.uniform(0.5, 4.0))
        s = np.float32(amax * inv127)
        k = rng.integers(-126, 126, 32 * 128)
        x = ((k + 0.5).astype(np.float32) * s).astype(np.float32)
        x[0] = amax
        tiles.append(x.reshape(32, 128))
    return np.concatenate(tiles, 0)


def phase_codec_kernels(seed):
    """3c: K1–K4 against their plain versions on the card, bitwise."""
    import torch
    from repro_torch.core.buffers import StreamBuffer
    from repro_torch.core.elements import TensorSparseEnc
    from repro_torch.kernels import cost, ops, ref
    from repro_torch.kernels import quant8 as kq
    from repro_torch.kernels import sparse_dec as kd
    from repro_torch.kernels import sparse_enc as ke
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 3)
    g = torch.Generator(device=dev).manual_seed(seed + 3)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    def cu(a):
        return torch.as_tensor(a, device=dev)

    # -- smoke shapes --------------------------------------------------------
    n_cases = 0
    q8 = [(rng.standard_normal(s) * 3).astype(np.float32)
          for s in [(3, 5), (70, 300), (2, 3, 4, 5), (), (129,)]]
    zero = (rng.standard_normal((64, 256)) * 2).astype(np.float32)
    zero[:32, :128] = 0.0                               # an all-zero tile
    q8 += [zero, _tie_tiles(rng, 8)]
    for x in q8:
        x2 = ops._pad_tiles(ops._as2d(cu(x)))
        q, s = kq.quantize8(x2)
        pq, ps = ref.quantize8_plain(x2)
        same_bits(q, pq, f"K1 {x.shape}")
        same_bits(s, ps, f"K1 scales {x.shape}")
        same_bits(kq.dequantize8(q, s), ref.dequantize8_plain(q, s),
                  f"K2 {x.shape}")
        n_cases += 1
    for n, cap, dtype in [(1000, 100, torch.float32),
                          (4096, 300, torch.bfloat16),
                          (700, 350, torch.float32),
                          (512, 8, torch.float32),     # a block over capacity
                          (3000, 3000, torch.bfloat16)]:
        x = rng.standard_normal(n).astype(np.float32)
        x[rng.random(n) < 0.7] = 0.0
        flat = cu(x).to(dtype)
        nb, kb = ref._sparse_dims(n, cap)
        flat = torch.nn.functional.pad(flat, (0, nb * ref.SPARSE_B - n))
        got = ke.sparse_enc(flat, kb=kb)
        want = ref.sparse_enc_plain(flat, kb)
        for g_, w_, part in zip(got, want, ("values", "indices", "counts")):
            same_bits(g_, w_, f"K3 {part} n={n} kb={kb} {dtype}")
        v2, i2 = got[0].reshape(nb, kb), got[1].reshape(nb, kb)
        same_bits(kd.sparse_dec(v2, i2), ref.sparse_dec_plain(v2, i2),
                  f"K4 n={n} kb={kb} {dtype}")
        n_cases += 1
    # K3's kb range, its totals, frame-local indices and the scalar-load
    # route of a misaligned view, each against the plain version
    mixed = rng.standard_normal(4 * 5 * ref.SPARSE_B).astype(np.float32)
    dens = np.repeat(rng.choice([0.0, 0.05, 0.3, 0.9], 20), ref.SPARSE_B)
    mixed[rng.random(mixed.size) >= dens] = 0.0
    mixed[(mixed == 0) & (rng.random(mixed.size) < 0.5)] = -0.0
    for dtype in (torch.float32, torch.bfloat16):
        flat = cu(mixed).to(dtype)
        nb = flat.numel() // ref.SPARSE_B
        for kb in (1, 8, 80, 512):
            got = ke.sparse_enc(flat, kb=kb, threshold=0.5, frame_blocks=5,
                                totals=True)
            want = ref.sparse_enc_plain(flat, kb, 0.5, frame_blocks=5,
                                        totals=True)
            for g_, w_, part in zip(got, want, ("values", "indices",
                                                "counts", "totals")):
                same_bits(g_, w_, f"K3 {part} kb={kb} {dtype} frame-local")
            truth = (flat.float().abs() > 0.5).reshape(nb, ref.SPARSE_B)
            check(torch.equal(got[3], truth.sum(1, dtype=torch.int32)),
                  f"K3 totals kb={kb} {dtype} != count of |x| > 0.5")
            glob = ke.sparse_enc(flat, kb=kb, threshold=0.5)
            off = (torch.arange(4, dtype=torch.int32, device=dev)
                   * (5 * ref.SPARSE_B))[:, None]
            same_bits(got[1].reshape(4, -1), glob[1].reshape(4, -1) - off,
                      f"K3 frame-local kb={kb} {dtype} vs global - offset")
            n_cases += 1
        view = torch.cat([flat[:1], flat])[1:]  # the same data, one in
        check(ke.enc_route(view) == "scalar", "K3: the misaligned view "
                                              "is 16-byte aligned")
        before = ke.ENC_ROUTE_LAUNCHES["scalar"]
        got = ke.sparse_enc(view, kb=80, threshold=0.5, frame_blocks=5,
                            totals=True)
        check(ke.ENC_ROUTE_LAUNCHES["scalar"] == before + 1,
              "K3: the misaligned view did not take the scalar route")
        want = ref.sparse_enc_plain(view, 80, 0.5, frame_blocks=5,
                                    totals=True)
        for g_, w_, part in zip(got, want, ("values", "indices", "counts",
                                            "totals")):
            same_bits(g_, w_, f"K3 {part} misaligned {dtype}")
        n_cases += 1
    x = cu(rng.standard_normal((6, 200)).astype(np.float32))
    elem = TensorSparseEnc(max_nnz=1200, threshold=0.5)
    sp = elem.apply({}, [StreamBuffer(tensors=(x,))])[0].tensors[0]
    nb, kb = ref._sparse_dims(x.numel(), 1200)
    flat = torch.nn.functional.pad(x.reshape(-1), (0, nb * ref.SPARSE_B
                                                   - x.numel()))
    pv, pi, pc = ref.sparse_enc_plain(flat, kb, 0.5)
    same_bits(sp.values, pv, "K3 threshold 0.5 values")
    same_bits(sp.indices, pi, "K3 threshold 0.5 indices")
    check(int(sp.nnz) == int(pc.sum()) == int((x.abs() > 0.5).sum()),
          "K3 threshold 0.5 count")
    n_cases += 1
    torch.cuda.synchronize()
    print(f"phase 3c codec kernels smoke shapes: {n_cases} cases bitwise "
          f"(ragged, zero tile, .5 ties, bf16, over capacity, threshold; "
          f"K3 kb 1..512 with totals and frame-local indices, and a "
          f"misaligned view on the scalar-load route)")

    # -- the full-width stacked shapes of phase 6 -------------------------------
    table = {}
    b, l, d = 8, 512, 2048
    x = torch.randn(b * l, d, generator=g, device=dev) * cu(
        rng.uniform(0.1, 4.0, (b * l, 1)).astype(np.float32))
    q, s = kq.quantize8(x)
    pq, ps = ref.quantize8_plain(x)
    same_bits(q, pq, "K1 full width")
    same_bits(s, ps, "K1 full width scales")
    dq = kq.dequantize8(q, s)
    pdq = ref.dequantize8_plain(q, s)
    same_bits(dq, pdq, "K2 full width")
    gm, gn = s.shape

    def lib_dequant():     # one broadcast multiply, int8 * f32 -> f32
        return torch.mul(q.view(gm, ref.QUANT_BM, gn, ref.QUANT_BN),
                         s.view(gm, 1, gn, 1))
    same_bits(lib_dequant().view(dq.shape), dq, "K2 vs torch.mul")
    table["quantize8"] = dict(
        shape=f"f32 [{b}*{l}, {d}]",
        max_abs_err=max(err(q, pq), err(s, ps)),
        ms=cuda_ms(lambda: kq.quantize8(x)),
        plain_ms=cuda_ms(lambda: ref.quantize8_plain(x)),
        library_ms=None, **cost.bound(cost.quantize8(b * l, d)))
    table["dequantize8"] = dict(
        shape=f"int8 [{b}*{l}, {d}]", max_abs_err=err(dq, pdq),
        ms=cuda_ms(lambda: kq.dequantize8(q, s)),
        plain_ms=cuda_ms(lambda: ref.dequantize8_plain(q, s)),
        library_ms=cuda_ms(lib_dequant), library="torch.mul",
        **cost.bound(cost.dequantize8(b * l, d)))

    n = l * d
    nb, kb = ref._sparse_dims(n, int(n * 0.15))
    check(kb == 80, f"sparse:0.15 at {n} elements gives kb={kb}, not 80")
    xs = torch.randn(b * n, generator=g, device=dev)
    xs = torch.where(torch.rand(b * n, generator=g, device=dev) < 0.10, xs,
                     torch.zeros_like(xs))
    # the main path's call: frame-local indices and the uncapped counts
    got = ke.sparse_enc(xs, kb=kb, frame_blocks=nb, totals=True)
    want = ref.sparse_enc_plain(xs, kb, frame_blocks=nb, totals=True)
    for g_, w_, part in zip(got, want, ("values", "indices", "counts",
                                        "totals")):
        same_bits(g_, w_, f"K3 full width {part}")
    glob = ke.sparse_enc(xs, kb=kb)        # global indices, K4's input
    for g_, w_, part in zip(glob, ref.sparse_enc_plain(xs, kb),
                            ("values", "indices", "counts")):
        same_bits(g_, w_, f"K3 full width global {part}")
    v2 = glob[0].reshape(b * nb, kb)
    i2 = glob[1].reshape(b * nb, kb)
    dense = kd.sparse_dec(v2, i2)
    pdense = ref.sparse_dec_plain(v2, i2)
    same_bits(dense, pdense, "K4 full width")
    kept = int(got[2].sum())
    truth = int((xs != 0).sum())
    idx64 = i2.reshape(-1).long()
    vflat = v2.reshape(-1)
    # one stacked encode as the codec runs it, and the two passes the
    # kernel took over (the true-nonzero count and the index rebase), run
    # as the earlier ops did them at the same shape
    x8 = xs.view(b, n)
    cap = int(n * 0.15)
    st = ops.sparse_enc_stacked(x8, cap, 0.0, with_total=True)
    same_bits(st[1], got[1].view(b, nb * kb), "K3 stacked indices")
    same_bits(st[3], (x8 != 0).sum(1, dtype=torch.int32), "K3 stacked "
                                                          "totals")
    old_idx = glob[1].view(b, nb * kb)

    def removed_glue():
        off = (torch.arange(b, dtype=torch.int32, device=dev)
               * (nb * ref.SPARSE_B))[:, None]
        return old_idx - off, (x8.abs() > 0).sum(dim=1).to(torch.int32)
    same_bits(removed_glue()[0], st[1], "K3 frame-local vs the old rebase")
    same_bits(removed_glue()[1], st[3], "K3 totals vs the old count")
    copies = [xs] + [xs.clone() for _ in range(3)]     # > 100 MB: past L2
    cycle = itertools.cycle(copies)
    table["sparse_enc"] = dict(
        shape=f"f32 [{b}*{n}], 10% nonzero, kb={kb}",
        max_abs_err=max(err(g_, w_) for g_, w_ in zip(got, want)),
        ms=cuda_ms(lambda: ke.sparse_enc(xs, kb=kb, frame_blocks=nb,
                                         totals=True)),
        cold_ms=cuda_ms(lambda: ke.sparse_enc(next(cycle), kb=kb,
                                              frame_blocks=nb, totals=True)),
        plain_ms=cuda_ms(lambda: ref.sparse_enc_plain(
            xs, kb, frame_blocks=nb, totals=True)),
        removed_glue_ms=cuda_ms(removed_glue),
        stacked_ms=cuda_ms(lambda: ops.sparse_enc_stacked(
            x8, cap, 0.0, with_total=True)),
        library_ms=None, kept=kept, nonzeros=truth,
        **cost.bound(cost.sparse_enc(b * n, kb, xs.dtype, totals=True)))
    del copies, cycle
    table["sparse_dec"] = dict(
        shape=f"[{b}*{nb}, {kb}] -> f32 [{b}*{n}]",
        max_abs_err=err(dense, pdense),
        ms=cuda_ms(lambda: kd.sparse_dec(v2, i2)),
        plain_ms=cuda_ms(lambda: ref.sparse_dec_plain(v2, i2)),
        library_ms=cuda_ms(lambda: torch.zeros(
            b * nb * ref.SPARSE_B, device=dev).index_add_(0, idx64, vflat)),
        library="index_add_",
        **cost.bound(cost.sparse_dec(b * nb, kb, v2.dtype)))
    for name, row in table.items():
        lib = "library —" if row["library_ms"] is None else \
            f"{row['library']} {row['library_ms']:.4f} ms"
        extra = "" if "cold_ms" not in row else (
            f" (cold L2 {row['cold_ms']:.4f} ms; one stacked encode "
            f"{row['stacked_ms']:.4f} ms; the removed count and rebase "
            f"passes {row['removed_glue_ms']:.4f} ms)")
        print(f"phase 3c {name} {row['shape']}: bitwise, kernel "
              f"{row['ms']:.4f} ms{extra}, plain {row['plain_ms']:.4f} ms, "
              f"{lib}, bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    return table


def phase_scan_kernel(seed):
    """3d: the RG-LRU scan kernel against its plain version on the card,
    bitwise: ragged smoke shapes (S of 1, 7 and 64; S at one ring stage
    - 1, one stage and one stage + 1; widths that are not a multiple of
    the block or of 4 floats; B = 1 against a batch of 3) and the
    full-width prefill shape f32 [1, 3000, 4096]; timed with CUDA events,
    warm L2, beside its byte bound and the plain step-by-step loop, with
    the ring's stages and bytes in flight as the compiled kernel reports
    them.  No single PyTorch call computes a linear recurrence, so it has
    no library time."""
    import torch
    from repro_torch.kernels import cost
    from repro_torch.kernels import rglru_scan as rs
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 5)

    def inputs(b, s, w):
        a = torch.rand((b, s, w), generator=g, device=dev) * 0.5 + 0.5
        bx = torch.randn((b, s, w), generator=g, device=dev)
        return a, bx

    ring = rs.ring()
    edges = [(1, ring["positions"] + d, w) for d in (-1, 0, 1)
             for w in (33, 257)]
    n = 0
    for b, s, w in [(1, 1, 100), (2, 7, 4096), (3, 64, 257), (1, 64, 33),
                    (4, 7, 31)] + edges:
        a, bx = inputs(b, s, w)
        h = rs.rglru_scan(a, bx)
        same_bits(h, rs.rglru_scan_plain(a, bx), f"scan [{b},{s},{w}]")
        n += 1
    a, bx = inputs(3, 700, 4096)
    same_bits(rs.rglru_scan(a[1:2].contiguous(), bx[1:2].contiguous()),
              rs.rglru_scan(a, bx)[1:2], "scan row at B = 1 vs in B = 3")
    b, s, w = 1, 3000, 4096
    a, bx = inputs(b, s, w)
    h = rs.rglru_scan(a, bx)
    r = rs.rglru_scan_plain(a, bx)
    same_bits(h, r, "scan [1,3000,4096]")
    kern = cuda_ms(lambda: rs.rglru_scan(a, bx))
    plain = cuda_ms(lambda: rs.rglru_scan_plain(a, bx), iters=3, warmup=1)
    count = cost.rglru_scan(b, s, w)    # a, bx read once; h written once
    nbytes, bounds = count.bytes, cost.bound(count)
    bound = bounds["bound_ms"]
    in_flight = (ring["stages"] - 1) * ring["stage_bytes"]
    row = dict(shape=[b, s, w], max_abs_err=0.0, bitwise=True,
               ms=kern, plain_ms=plain, library_ms=None, **bounds,
               stages=ring["stages"], bytes_in_flight_per_block=in_flight)
    print(f"phase 3d scan kernel: {n} smoke shapes and a row at B = 1 vs "
          f"in a batch of 3 bitwise the plain loop; f32 [1, 3000, 4096]: "
          f"bitwise, kernel {kern:.4f} ms ({bound / kern:.0%} of the byte "
          f"bound); {ring['channels']} channels a block, ring of "
          f"{ring['stages']} stages of {ring['stage_bytes']} B, "
          f"{in_flight} B in flight a block; plain "
          f"{plain:.4f} ms, bound {bound:.5f} ms ({bounds['bound_by']}, "
          f"{nbytes} B)")
    return row


def _serve(rt_device, model, slots, max_seq, clients, seed, max_ticks,
           jit=True, n_stages=None, rt_kw=None, on_servers=None,
           tick_ms=None, before_tick=None):
    """Drive one serve pipeline plus staggered clients until every client
    has its answers.  ``clients`` is a list of (join_tick, prompts, gens);
    ``jit=False`` is the eager twin of the graph route.  With ``n_stages``
    the server is that many stage pipelines, one Device each, every one
    given the monolithic server's generator; ``srv`` is then their runs.
    ``rt_kw`` goes to the Runtime, ``on_servers(rt, server runs)`` runs
    once the servers are deployed, ``before_tick(t)`` before tick ``t``,
    and ``tick_ms`` (a list) collects each tick's host ms, the card
    synchronized at its end."""
    import torch
    from repro_torch.device import make_generator
    from repro_torch.launch import model_serve as ms
    from repro_torch.runtime import Device, Runtime
    rt = Runtime(device=rt_device, **(rt_kw or {}))
    if n_stages is None:
        pipes = [("hub", ms.serve_pipeline(model=model, slots=slots,
                                           max_seq=max_seq))]
    else:
        pipes = [(f"stage{k}", ps) for k, ps in enumerate(
            ms.staged_serve_pipelines(model=model, slots=slots,
                                      max_seq=max_seq, n_stages=n_stages))]
    srvs = []
    for name, ps in pipes:
        hub = Device(name, device=rt_device)
        srvs.append(hub.add_pipeline(
            ps, generator=make_generator(seed, rt.device), jit=jit))
        rt.add_device(hub)
    srv = srvs[0] if n_stages is None else srvs
    if on_servers is not None:
        on_servers(rt, srvs)
    runs = [None] * len(clients)
    t0 = time.perf_counter()
    while rt.ticks < max_ticks:
        if before_tick is not None:
            before_tick(rt.ticks + 1)
        for i, (join, prompts, gens) in enumerate(clients):
            if runs[i] is None and rt.ticks >= join:
                dev = Device(f"tv{i}", device=rt_device)
                p = ";".join(",".join(str(t) for t in pr) for pr in prompts)
                g = ";".join(str(x) for x in gens)
                runs[i] = dev.add_pipeline(ms.client_pipeline(prompts=p,
                                                              gens=g),
                                           jit=jit)
                rt.add_device(dev)
        t1 = time.perf_counter()
        rt.tick()
        if tick_ms is not None:
            if rt.device.type == "cuda":
                torch.cuda.synchronize()
            tick_ms.append(1e3 * (time.perf_counter() - t1))
        done = 0
        for i, run in enumerate(runs):
            if run is not None and \
                    len(run.sink_log.get("res", [])) >= len(clients[i][1]):
                run.retired = True      # this client asks for nothing more
                done += 1
        if done == len(clients):
            break
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return rt, srv, runs, wall


def _graph_mark():
    """-> (graphs captured so far, their bytes, allocated bytes), after
    releasing what earlier runtimes' graphs and buffers still hold."""
    import torch
    from repro_torch.core import clear_executable_cache
    from repro_torch.core.graphs import graph_stats
    clear_executable_cache()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = graph_stats()
    return g["captured"], g["bytes"], torch.cuda.memory_allocated()


def _graph_since(mark):
    """What a run added since ``mark``: graphs captured, graph MiB (pool
    growth plus the bindings' buffers) and the peak GiB over what was
    allocated at the mark."""
    import torch
    from repro_torch.core.graphs import graph_stats
    torch.cuda.synchronize()
    g = graph_stats()
    return dict(graphs=g["captured"] - mark[0],
                graph_mib=(g["bytes"] - mark[1]) / 2 ** 20,
                peak_gib_over_base=(torch.cuda.max_memory_allocated() -
                                    mark[2]) / 2 ** 30)


def _serve_batcher(rt):
    from repro_torch.core.batching import StreamingQueryBatcher
    return next(b for b in rt.batchers()
                if isinstance(b, StreamingQueryBatcher))


def _check_answers(runs, clients, vocab, slots):
    """-> [(prompt, gen, tokens, slot the stream was served in)]"""
    answers = []
    for i, (run, (_, prompts, gens)) in enumerate(zip(runs, clients)):
        check(run is not None, f"client {i} never joined")
        bufs = run.sink_log.get("res", [])
        check(len(bufs) == len(prompts), f"client {i}: {len(bufs)} answers, "
                                         f"expected {len(prompts)}")
        for j, b in enumerate(bufs):
            a, slot = np.asarray(b.tensor), b.meta.get("slot")
            check(slot in range(slots), f"client {i} answer {j}: served in "
                                        f"slot {slot}")
            check(a.shape == (gens[j],) and a.dtype == np.int32,
                  f"client {i} answer {j}: shape {a.shape} {a.dtype}")
            check(((a >= 0) & (a < vocab)).all(),
                  f"client {i} answer {j}: token outside the vocabulary")
            answers.append((prompts[j], gens[j], a.tolist(), slot))
    return answers


def phase_serve(seed):
    import torch
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.launch import model_serve as ms
    from repro_torch.models import layers, transformer

    cfg = dataclasses.replace(stablelm_1_6b.config(), use_flash_attn=True)
    ms.register_serve_model("stablelm-1.6b-flash", lambda: cfg)
    rng = np.random.default_rng(seed)
    clients = []
    for i in range(8):
        n_req = 2 if i < 4 else 1           # 12 streams over 8 slots
        prompts = [rng.integers(0, cfg.vocab, int(rng.integers(128, 513)))
                   .tolist() for _ in range(n_req)]
        gens = [int(rng.integers(16, 65)) for _ in range(n_req)]
        clients.append((2 * i, prompts, gens))

    _reset_launches()
    eager = dict(layers.EAGER_ON_CARD)
    mark = _graph_mark()
    rt, srv, runs, wall = _serve(None, "stablelm-1.6b-flash", 8, 1024,
                                 clients, seed, max_ticks=400)
    graph = _graph_since(mark)
    launches = dict(fa.LAUNCHES)
    all_launches = _launch_counts()
    routes = dict(fa.PREFILL_ROUTE_LAUNCHES)
    kernels = {k: v for k, v in fa.KERNEL_LAUNCHES.items() if v}
    answers = _check_answers(runs, clients, cfg.vocab, 8)
    qb = rt.stats()["query_batching"]
    check(qb["tokens_generated"] == qb["tokens_delivered"] +
          qb["tokens_dropped"] + qb["tokens_in_flight"],
          f"token conservation broken: {qb}")
    check(kernels == {"flash_attention/sm90/64": launches["flash_attention"],
                      "flash_decode/split/64": launches["flash_decode"]},
          f"K5/K6 launches by kernel {kernels}: head dim 64 runs the "
          f"one-warpgroup prefill and the split-KV decode only")
    check(launches["flash_attention"] == cfg.n_layers * qb["prefills"],
          f"K5 launches {launches} != {cfg.n_layers} x {qb['prefills']}")
    check(routes == {"sm90": launches["flash_attention"], "scalar": 0},
          f"K5 launches by route {routes}: the bf16 serve path must run "
          f"the tensor-core kernel only")
    check(launches["flash_decode"] == cfg.n_layers * qb["decode_ticks"],
          f"K6 launches {launches} != {cfg.n_layers} x "
          f"{qb['decode_ticks']}")
    check(qb["batched_frames"] > qb["decode_ticks"],
          "the decode batch was never wider than one stream")
    norm_rope = _check_norm_rope("4a", cfg, qb, all_launches, eager)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    serve = dict(ticks=rt.ticks, wall_s=wall, prefills=qb["prefills"],
                 decode_ticks=qb["decode_ticks"],
                 tokens=qb["tokens_generated"],
                 prefill_ms_per_request=1e3 * qb["prefill_seconds"] /
                 qb["prefills"],
                 decode_ms_per_tick=1e3 * qb["decode_seconds"] /
                 qb["decode_ticks"],
                 mean_active_slots=qb["batched_frames"] / qb["decode_ticks"],
                 tokens_per_s=qb["tokens_generated"] / wall,
                 peak_gib=peak_gib, launches=launches,
                 norm_rope_launches=norm_rope,
                 prefill_route_launches=routes, kernel_launches=kernels,
                 decode_ms=[1e3 * x for x in
                            _serve_batcher(rt).decode_times], **graph)
    print(f"phase 4a serve stablelm-1.6b bf16 24 layers slots 8 max_seq "
          f"1024 (decode tick as a CUDA graph): {len(answers)} answers in "
          f"{rt.ticks} ticks, {wall:.2f} s; prefill "
          f"{serve['prefill_ms_per_request']:.2f} ms/request, decode "
          f"{serve['decode_ms_per_tick']:.2f} ms/tick (mean "
          f"{serve['mean_active_slots']:.2f} active slots), "
          f"{serve['tokens_per_s']:.1f} tokens/s, peak {peak_gib:.2f} GiB, "
          f"{graph['graphs']} graphs captured holding "
          f"{graph['graph_mib']:.1f} MiB, launches {launches}, K5 by route "
          f"{routes}, K5/K6 by kernel {kernels}, S4/S5 {norm_rope} (eager "
          f"on the card 0)")

    params, ecfg = srv.params["lm"], srv.pipe.elements["lm"].cfg
    for prompt, gen, got, slot in answers:
        ref = ms.sequential_decode(params, ecfg, prompt, gen, 1024, slots=8,
                                   slot=slot)
        check(got == ref, f"continuous != sequential for a {len(prompt)}"
                          f"-token prompt in slot {slot}: {got} vs {ref}")
    used = sorted({a[3] for a in answers})
    print(f"phase 4b continuous == sequential decode: {len(answers)} streams "
          f"bitwise, each replayed in its serve slot (slots {used})")

    # a small fp32 server on the card against the port's CPU path
    small = [(i, [[i + 1, i + 2, i + 3]], [6 + i]) for i in range(4)]
    rt2, srv2, runs2, _ = _serve(None, "stablelm-smoke-flash", 4, 32, small,
                                 seed, max_ticks=40)
    got = _check_answers(runs2, small, 512, 4)
    scfg = srv2.pipe.elements["lm"].cfg
    cpu_params = transformer.params_from_numpy(
        _to_numpy(srv2.params["lm"]), scfg, "cpu")
    for prompt, gen, toks, slot in got:
        ref = ms.sequential_decode(cpu_params, scfg, prompt, gen, 32,
                                   slots=4, slot=slot, device="cpu")
        check(toks == ref, f"fp32 card answer {toks} != CPU {ref}")
    print("phase 4c fp32 smoke server on the card == the port's CPU path: "
          f"{len(got)} streams")
    return serve, srv, dict(clients=clients, answers=answers, ticks=rt.ticks)


def _profile(fn, warm=True):
    """Run ``fn`` once under torch.profiler (after one unprofiled call,
    with ``warm``) -> (host wall ms, device busy ms, [(op, self device ms,
    calls)] by device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, host_rows = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            # kernel rows; host-side ops that launched them only if the
            # trace attributes no kernel rows of its own
            (rows if str(e.device_type).endswith("CUDA") else
             host_rows).append((e.key, dev_us / 1e3, e.count))
    rows = rows or host_rows
    rows.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), rows


def phase_profile(srv, seed):
    """Where the time of one full-width prefill (512 tokens) and of one
    decode tick with all 8 slots active goes, by device kernel."""
    import torch
    from repro_torch.core.buffers import tree_flatten
    from repro_torch.models import transformer
    elem = srv.pipe.elements["lm"]
    params, cfg = srv.params["lm"], elem.cfg
    prompt = np.random.default_rng(seed + 1).integers(0, cfg.vocab, 512)
    res = {}
    res["prefill L=512"] = _profile(lambda: elem.host_prefill(params, prompt))
    _, c1 = elem.host_prefill(params, prompt)
    cache = transformer.cache_init(cfg, 8, elem.max_seq)
    for d, s in zip(tree_flatten(cache["layers"])[0],
                    tree_flatten(c1["layers"])[0]):
        d.copy_(s.expand_as(d))
    cache["pos"].fill_(512)
    token = torch.zeros(8, dtype=torch.int32, device="cuda")
    active = torch.ones(8, dtype=torch.bool, device="cuda")

    def tick():
        cache["pos"].fill_(512)
        transformer.serve_decode_step(params, cfg, cache, token, active)
    res["decode tick S=8"] = _profile(tick)
    out = {}
    for name, (wall, busy, rows) in res.items():
        top = ", ".join(f"{k[:40]} {ms_:.2f} ms x{n}" for k, ms_, n in
                        rows[:6])
        print(f"phase 5 profile {name}: host wall {wall:.2f} ms, device "
              f"busy {busy:.2f} ms ({100 * busy / wall:.0f}%); top: {top}")
        out[name] = {"wall_ms": wall, "device_ms": busy,
                     "top": [list(r) for r in rows[:15]]}
    return out


OFFLOAD_L, OFFLOAD_D, OFFLOAD_CLIENTS, OFFLOAD_TICKS = 512, 2048, 8, 4
#: fused ticks timed after the checks, and ticks in the profiled window
OFFLOAD_TIMED_TICKS, OFFLOAD_PROFILED_TICKS = 48, 8
#: client i's tensor_transform option per codec (phase 6)
OFFLOAD_TRANSFORMS = {
    "quant8": "typecast:float32,add:-127.5,div:127.5,mul:{m}",
    # exactly 50 of every 512-element block survive the clamp: lossless at
    # kb = 80
    "sparse:0.15": "typecast:float32,add:-230,clamp:0:25,mul:{m}",
}


def _register_offload_models(seed):
    """The phase 6 server model y = x * sigmoid(x @ W), which keeps the
    request's zeros: W f32 [2048, 2048] = 0.02 N(0, 1) drawn on the card
    from the seed, and a [256, 256] one from numpy for the card-vs-CPU
    run."""
    import torch
    from repro_torch.core.elements import register_model
    from repro_torch.core.formats import TensorSpec

    def apply(p, x):
        return x * torch.sigmoid(x @ p["w"])

    def init_full(g, dev):
        return {"w": 0.02 * torch.randn(OFFLOAD_D, OFFLOAD_D, generator=g,
                                        device=dev)}
    register_model("offload-gate", init_full, apply,
                   out_specs=(TensorSpec((1, OFFLOAD_L, OFFLOAD_D),
                                         "float32"),))
    w_small = (0.02 * np.random.default_rng(seed + 6).standard_normal(
        (256, 256))).astype(np.float32)
    register_model("offload-gate-small",
                   lambda g, dev: {"w": torch.as_tensor(w_small,
                                                        device=dev)},
                   apply, out_specs=(TensorSpec((1, 64, 256), "float32"),))
    return apply


def _offload(device, model, codec, width, channels, n_clients, ticks, seed,
             jit=True, **rt_kw):
    """One offload run: a tensor_filter server and ``n_clients`` clients,
    ``ticks`` scheduler ticks (``jit=False``: the eager twin of the graph
    route).  -> (runtime, client runs, server run, [(wire bytes, request
    buffer)] as pushed to the server, tick seconds)"""
    import torch
    from repro_torch.core import parse_launch
    from repro_torch.device import make_generator
    from repro_torch.runtime import Device, Runtime
    rt = Runtime(device=device, **rt_kw)
    hub = Device("hub", device=device)
    ps = parse_launch(
        f"tensor_query_serversrc operation=act name=ssrc ! "
        f"tensor_filter model={model} ! tensor_query_serversink name=ssink")
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    srv = hub.add_pipeline(ps, generator=make_generator(seed, rt.device),
                           jit=jit)
    rt.add_device(hub)
    ep = ps.elements["ssrc"].endpoint
    seen = []
    push = ep.requests.push

    def spy(buf, nbytes=None):
        seen.append((nbytes, buf))
        return push(buf, nbytes)
    ep.requests.push = spy
    runs = []
    for i in range(n_clients):
        opt = OFFLOAD_TRANSFORMS[codec].format(m=1 + i / 8)
        pc = parse_launch(
            f"testsrc width={width} height=1 channels={channels} ! "
            f"tensor_converter ! tensor_transform mode=arithmetic "
            f"option={opt} ! tensor_query_client operation=act "
            f"codec={codec} name=qc ! appsink name=res")
        dev = Device(f"cl{i}", device=device)
        runs.append(dev.add_pipeline(pc, jit=jit))
        rt.add_device(dev)
    return rt, runs, srv, seen, _timed_ticks(rt, ticks)


def _timed_ticks(rt, ticks):
    """Run ``ticks`` scheduler ticks -> each one's host seconds, the card
    synchronized at its end."""
    import torch
    secs = []
    for _ in range(ticks):
        t0 = time.perf_counter()
        rt.tick()
        if rt.device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs


def _wire_bytes(codec, rows, cols):
    """Wire bytes of one f32 [1, rows, cols] request: 1 B per element + 4 B
    per (32, 128) tile scale (quant8), or nb*kb (value, int32 index) slots
    + a 4 B count (sparse).  At [1, 512, 2048]: 1,049,600 and 1,310,724."""
    from repro_torch.core.compression import _sparse_cap
    from repro_torch.kernels import ref
    n = rows * cols
    if codec == "quant8":
        return n + (-(-rows // ref.QUANT_BM)) * (-(-cols // ref.QUANT_BN)) * 4
    nb, kb = ref._sparse_dims(n, _sparse_cap(n, float(codec.split(":")[1])))
    return nb * kb * 8 + 4


def _answers(runs, ticks, what):
    out = []
    for i, run in enumerate(runs):
        bufs = run.sink_log.get("res", [])
        check(len(bufs) == ticks, f"{what}: client {i} has {len(bufs)} "
                                  f"answers after {ticks} ticks")
        for b in bufs:
            check("codec" not in b.meta and "sparse_dropped" not in b.meta,
                  f"{what}: a decoded answer claims a codec")
        out.append([b.tensor for b in bufs])
    return out


def _plain_roundtrip(x, codec):
    """encode -> decode of one frame by the plain versions alone."""
    import torch.nn.functional as F
    from repro_torch.core.compression import _sparse_cap
    from repro_torch.kernels import ops, ref
    if codec == "quant8":
        x2 = ops._pad_tiles(ops._as2d(x))
        q, s = ref.quantize8_plain(x2)
        m, n = ops._as2d(x).shape
        return ref.dequantize8_plain(q, s)[:m, :n].reshape(x.shape)
    n = x.numel()
    nb, kb = ref._sparse_dims(n, _sparse_cap(n, float(codec.split(":")[1])))
    flat = F.pad(x.reshape(-1), (0, nb * ref.SPARSE_B - n))
    v, i, _ = ref.sparse_enc_plain(flat, kb)
    dense = ref.sparse_dec_plain(v.reshape(nb, kb), i.reshape(nb, kb))
    return dense[:n].reshape(x.shape)


def _client_frames(codec, i, ticks, device):
    """The request frames client ``i`` sends, rebuilt by the port's own
    source and transform elements."""
    from repro_torch.core import parse_launch
    opt = OFFLOAD_TRANSFORMS[codec].format(m=1 + i / 8)
    p = parse_launch(f"testsrc width={OFFLOAD_L} height=1 "
                     f"channels={OFFLOAD_D} ! tensor_converter ! "
                     f"tensor_transform mode=arithmetic option={opt} ! "
                     f"appsink name=out")
    st = p.init_state(device)
    frames = []
    for _ in range(ticks):
        out, st = p.step({}, st)
        frames.append(out["out"].tensor)
    return frames


def _kernel_modules():
    from repro_torch.kernels import (flash_attn, norm, quant8, rglru_scan,
                                     rotary, sparse_dec, sparse_enc,
                                     ssd_decode, ssd_scan)
    return (flash_attn, quant8, sparse_enc, sparse_dec, rglru_scan,
            ssd_scan, ssd_decode, norm, rotary)


def _launch_counts():
    counts = {}
    for mod in _kernel_modules():
        counts.update(mod.LAUNCHES)
    return counts


def _reset_launches():
    for mod in _kernel_modules():
        mod.reset_launches()


def _quant_step_excess(a, b):
    """Largest |a - b| beyond one quant step of its (32, 128) tile (the
    step read off the decoded answers: a tile's amax is 127 steps)."""
    import torch
    from repro_torch.kernels import ops, ref
    a2, b2 = ops._pad_tiles(ops._as2d(a)), ops._pad_tiles(ops._as2d(b))
    step = torch.maximum(ref._tiles(a2).abs().amax(dim=(2, 3)),
                         ref._tiles(b2).abs().amax(dim=(2, 3))) / 127
    return ((ref._tiles(a2) - ref._tiles(b2)).abs()
            - step[:, :, None, None] * (1 + 1e-5)).max().item()


def phase_offload(seed, profile=False):
    """6: the codec offload path at full width, one run per codec.  After
    the checks (which see exactly ``OFFLOAD_TICKS`` ticks) each fused run
    goes on for ``OFFLOAD_TIMED_TICKS`` timed ticks; with ``profile``, then
    ``OFFLOAD_PROFILED_TICKS`` more under the profiler.  -> (rows, the
    fused answers [client][tick] per codec, which phase 7c (quant8) and
    9c hold their runs against)"""
    import torch
    from repro_torch.core import compression as comp
    from repro_torch.core.buffers import tree_flatten
    from repro_torch.kernels import sparse_enc as ke
    apply = _register_offload_models(seed)
    L, D, C, T = OFFLOAD_L, OFFLOAD_D, OFFLOAD_CLIENTS, OFFLOAD_TICKS
    expect_bytes = {codec: _wire_bytes(codec, L, D)
                    for codec in OFFLOAD_TRANSFORMS}
    expect_kernels = {"quant8": ("quantize8", "dequantize8"),
                      "sparse:0.15": ("sparse_enc", "sparse_dec")}
    out, answers = {}, {}
    for tag, codec in (("6a", "quant8"), ("6b", "sparse:0.15")):
        comp.reset_codec_stats()
        _reset_launches()
        mark = _graph_mark()
        rt, runs, srv, seen, secs = _offload(None, "offload-gate", codec, L,
                                             D, C, T, seed, query_batch=8)
        graph = _graph_since(mark)
        launches = _launch_counts()
        enc_routes = dict(ke.ENC_ROUTE_LAUNCHES)
        fused = answers[codec] = _answers(runs, T, f"{tag} fused")
        qb = rt.stats()["query_batching"]
        check(qb["fused_frames"] == C * T,
              f"{tag}: fused_frames {qb['fused_frames']} != {C * T}")
        check(len(seen) == C * T and
              all(nb == expect_bytes[codec] for nb, _ in seen),
              f"{tag}: wire bytes per request "
              f"{sorted({nb for nb, _ in seen})} != {expect_bytes[codec]}")
        stats = comp.codec_stats()
        check(codec == "quant8" or stats["sparse_dropped_values"] == 0,
              f"{tag}: sparse truncation {stats}")
        for k in expect_kernels[codec]:
            check(launches[k] == 2 * T,
                  f"{tag}: {k} launched {launches[k]} times, expected "
                  f"{2 * T} (one request and one answer batch per tick)")
        # fused == eager == batch 1, bitwise
        for label, kw in (("eager", dict(query_batch=8, fused_wire=False)),
                          ("batch 1", dict(query_batch=1))):
            _, runs2, _, _, _ = _offload(None, "offload-gate", codec, L, D,
                                         C, T, seed, **kw)
            other = _answers(runs2, T, f"{tag} {label}")
            for i in range(C):
                for t in range(T):
                    same_bits(other[i][t], fused[i][t],
                              f"{tag} {label} != fused, client {i} tick {t}")
        # every answer == the chain of plain versions on the card
        params = srv.params[next(iter(srv.params))]
        for i in range(C):
            for t, x in enumerate(_client_frames(codec, i, T, rt.device)):
                y = apply(params, _plain_roundtrip(x, codec))
                same_bits(fused[i][t], _plain_roundtrip(y, codec),
                          f"{tag} client {i} tick {t}: answer != plain chain")
        torch.cuda.synchronize()
        for r in runs:              # the timed window keeps no answers
            r.sink_log.clear()
        timed = np.array(_timed_ticks(rt, OFFLOAD_TIMED_TICKS)) * 1e3
        if profile:
            P = OFFLOAD_PROFILED_TICKS
            wall, busy, top = _profile(
                lambda: [rt.tick() for _ in range(P)])
            out[f"profile {codec}"] = {"ticks": P, "wall_ms": wall,
                                       "device_ms": busy,
                                       "top": [list(r) for r in top[:15]]}
            print(f"phase 6 profile {codec} {P} ticks: host wall {wall:.2f} "
                  f"ms, device busy {busy:.2f} ms "
                  f"({100 * busy / wall:.0f}%); top: " +
                  ", ".join(f"{k[:40]} {ms_:.3f} ms x{n}"
                            for k, ms_, n in top[:6]))
        pct = np.percentile(timed, [0, 10, 50, 90, 100])
        row = dict(codec=codec, ms_per_tick=[1e3 * x for x in secs],
                   timed_ticks=len(timed), timed_ms_per_tick=timed.tolist(),
                   timed_ms_min_p10_median_p90_max=pct.tolist(),
                   wire_kib_per_request=expect_bytes[codec] / 1024,
                   raw_kib_per_request=L * D * 4 / 1024,
                   launches={k: launches[k] for k in expect_kernels[codec]},
                   codec_stats=stats, fused_frames=qb["fused_frames"],
                   enc_routes=enc_routes, **graph)
        out[codec] = row
        print(f"phase {tag} offload {codec} f32 [1, {L}, {D}] x {C} clients "
              f"x {T} ticks: {C * T} answers; ms/tick "
              f"{', '.join(f'{x:.2f}' for x in row['ms_per_tick'])}; over "
              f"{len(timed)} more fused ticks ms/tick min/p10/median/p90/max "
              f"{'/'.join(f'{x:.3f}' for x in pct)}; "
              f"{row['wire_kib_per_request']:.2f} KiB on the wire per "
              f"request (raw {row['raw_kib_per_request']:.0f} KiB); "
              f"launches {row['launches']}"
              f"{'' if codec == 'quant8' else f', K3 by route {enc_routes}'}"
              f"; {graph['graphs']} graphs captured (client segments and "
              f"the fused serve batch) holding {graph['graph_mib']:.1f} "
              f"MiB; fused == eager == batch 1 and == plain chain, "
              f"bitwise")

    # a small fp32 run on the card against the port's CPU path
    for codec in ("quant8", "sparse:0.15"):
        res = {}
        for label, device in (("card", "cuda"), ("cpu", "cpu")):
            _, runs, _, seen, _ = _offload(device, "offload-gate-small",
                                           codec, 64, 256, 4, 2, seed)
            res[label] = (_answers(runs, 2, f"6c {codec} {label}"), seen)
        (ga, gs), (ca, cs) = res["card"], res["cpu"]
        check(len(gs) == len(cs) == 8, "6c: request counts differ")
        for (gn, gb), (cn, cb) in zip(gs, cs):
            check(gn == cn, "6c: wire bytes differ")
            for gl, cl in zip(tree_flatten(gb.tensors)[0],
                              tree_flatten(cb.tensors)[0]):
                same_bits(gl.cpu(), cl, f"6c {codec}: request payload card "
                                        f"!= CPU")
        worst = float("-inf")
        for gi, ci in zip(ga, ca):
            for a, b in zip(gi, ci):
                a = a.cpu()
                if codec == "quant8":
                    e = _quant_step_excess(a, b)
                    check(e <= 0, f"6c quant8: answers differ by {e} beyond "
                                  f"one quant step")
                else:
                    e = ((a - b).abs() - 1e-5 * b.abs()).max().item()
                    check(e <= 1e-6, f"6c sparse: answers differ by {e} "
                                     f"beyond rtol 1e-5")
                worst = max(worst, e)
        print(f"phase 6c {codec} small fp32 run, card == CPU path: request "
              f"payloads bitwise, answers within "
              f"{'one quant step' if codec == 'quant8' else 'rtol 1e-5'} "
              f"(worst excess {worst:.2e})")
    return out, answers


# ---------------------------------------------------------------------------
# phase 7: the pub/sub path (Fig. 3 at FullHD, codec bursts, query_batch=0)
# ---------------------------------------------------------------------------

#: FullHD at the paper's 60 Hz tick (Fig. 7); ticks of 7a
FHD_W, FHD_H, FHD_TICKS = 1920, 1080, 16
#: the detector's input side (the example's detector, widened)
DET_SIDE = 224
#: 7a card vs CPU: ticks compared, and the GEMM tolerance |Δz_j| <=
#: DET_GEMM_TOL * sum_i |x_i W_ij| (two f32 sums of 150,528 products in
#: different orders); the scaled uint8 frames may differ by 1 on at most
#: DET_U8_SHARE of their values (a float within ulps of an integer
#: truncates either way)
DET_CPU_TICKS, DET_GEMM_TOL, DET_U8_SHARE = 3, 1e-5, 0.01
#: 7b: frames a late subscriber finds queued, ticks after it joins
BURST_BACKLOG, BURST_TICKS = 6, 8


def _register_detector(seed):
    """``examples/multicam_pubsub.py``'s detector widened to a 224·224·3
    input: W f32 [150528, 12] = 0.02 N(0, 1) from numpy, the same on the
    card and on the CPU.  -> (W, the detector's inputs in call order)"""
    import torch
    from repro_torch.core.elements import register_model
    from repro_torch.core.formats import TensorSpec
    n = DET_SIDE * DET_SIDE * 3
    w = (0.02 * np.random.default_rng(seed + 7).standard_normal(
        (n, 12))).astype(np.float32)
    inputs = []

    def apply(p, x):
        inputs.append(x)
        z = x.to(torch.float32).reshape(1, -1) @ p["w"]
        return torch.sigmoid(z[:, :4]), torch.softmax(z[0, 4:], dim=0)
    register_model("fullhd-detector",
                   lambda g, dev: {"w": torch.as_tensor(w, device=dev)},
                   apply, out_specs=(TensorSpec((1, 4), "float32"),
                                     TensorSpec((8,), "float32")))
    return w, inputs


def _fig3(device, transport, ticks):
    """Fig. 3 at FullHD: two skewed cameras, a processing device that
    scales, detects and republishes, a display that muxes both cameras
    and receives the inference.  -> (runtime, {name: run}, {topic:
    mqttsink}, [(payload, wire bytes)] of the inference topic, tick s)"""
    from repro_torch.core import SimClock, parse_launch
    from repro_torch.runtime import Device, Runtime
    rt = Runtime(device=device)
    sinks, runs = {}, {}
    for side, skew_ms in (("left", 0), ("right", 40)):
        cam = Device(f"cam_{side}", device=device,
                     clock=SimClock(skew_ns=skew_ms * 1_000_000))
        p = parse_launch(
            f"testsrc name=v4l2src width={FHD_W} height={FHD_H} ! "
            f"tensor_converter ! queue leaky=2 ! mqttsink "
            f"pub-topic=edge/cam/{side} transport={transport} name=pub")
        runs[f"cam_{side}"] = cam.add_pipeline(p)
        sinks[f"edge/cam/{side}"] = p.elements["pub"]
        rt.add_device(cam)
    proc = Device("coral", device=device)
    pp = parse_launch(
        f"mqttsrc sub-topic=edge/cam/left transport={transport} name=src ! "
        f"videoscale width={DET_SIDE} height={DET_SIDE} ! tensor_transform "
        f"mode=arithmetic option=typecast:float32,div:255.0 ! tensor_filter "
        f"model=fullhd-detector ! mqttsink pub-topic=edge/inference "
        f"transport={transport} name=pub")
    # videoscale negotiates from the publisher's caps: discover first
    pp.elements["src"].connect(rt.broker)
    runs["coral"] = proc.add_pipeline(pp)
    sinks["edge/inference"] = pp.elements["pub"]
    rt.add_device(proc)
    seen, push = [], pp.elements["pub"].channel.push

    def spy(buf, nbytes=None):
        seen.append((buf, nbytes))
        return push(buf, nbytes)
    pp.elements["pub"].channel.push = spy
    disp = Device("lcd", device=device)
    runs["lcd"] = disp.add_pipeline(parse_launch(f"""
        mqttsrc sub-topic=edge/cam/left transport={transport} ! queue ! mux.sink_0
        mqttsrc sub-topic=edge/cam/right transport={transport} ! queue ! mux.sink_1
        tensor_mux name=mux ! appsink name=video
        mqttsrc sub-topic=edge/inference transport={transport} ! queue !
          appsink name=boxes
    """))
    rt.add_device(disp)
    return rt, runs, sinks, seen, _timed_ticks(rt, ticks)


def _conservation(runs, sinks, what):
    """Every published frame is delivered, dropped or still queued, for
    each subscriber of each topic."""
    from repro_torch.core import MqttSrc
    per_topic = {}
    for name, run in runs.items():
        for e in run.pipe.elements.values():
            if isinstance(e, MqttSrc):
                pub = sinks[e.topic_filter].channel.msgs_sent
                got = run.frames + e.drops + e.queued()
                check(got == pub, f"{what}: {name} on {e.topic_filter}: "
                                  f"{run.frames} delivered + {e.drops} "
                                  f"dropped + {e.queued()} queued != {pub} "
                                  f"published")
                per_topic.setdefault(e.topic_filter, []).append(
                    (name, run.frames, e.drops, e.queued(), pub))
    return per_topic


def _phase_fig3(seed):
    """7a: Fig. 3 at FullHD on the card."""
    import torch
    w, det_inputs = _register_detector(seed)
    rt, runs, sinks, seen, secs = _fig3(None, "hybrid", FHD_TICKS)
    torch.cuda.synchronize()
    per_topic = _conservation(runs, sinks, "7a")
    lcd = runs["lcd"]
    check(lcd.frames == FHD_TICKS and runs["coral"].frames == FHD_TICKS,
          f"7a: display {lcd.frames} / processing {runs['coral'].frames} "
          f"frames after {FHD_TICKS} ticks")
    check(rt.broker.relay_bytes == 0 and rt.broker.relay_msgs == 0,
          f"7a: the broker carried {rt.broker.relay_bytes} data bytes on "
          f"hybrid")
    # the mux's pts: the earliest of both cameras', rebased (§4.2.3)
    base = {d.name: d.pipeline_clock.base_time_utc() for d in rt.devices}
    delta = {s: base[f"cam_{s}"] - base["lcd"] for s in ("left", "right")}
    for k, buf in enumerate(lcd.sink_log["video"]):
        pts = k * (16_666_667 // 1000)
        want = min(pts + delta["left"], pts + delta["right"])
        check(int(buf.pts) == want, f"7a: muxed frame {k} pts "
                                    f"{int(buf.pts)} != {want}")
        check([tuple(t.shape) for t in buf.tensors] ==
              [(FHD_H, FHD_W, 3)] * 2, f"7a: muxed frame {k} shapes")
    for k, buf in enumerate(lcd.sink_log["boxes"]):
        b, s = buf.tensors
        check(b.shape == (1, 4) and s.shape == (8,) and
              bool(torch.isfinite(b).all()) and bool(torch.isfinite(s).all())
              and abs(float(s.sum()) - 1) < 1e-5,
              f"7a: inference {k} is not finite boxes and a distribution")
    frame_bytes = FHD_W * FHD_H * 3
    check(sinks["edge/cam/left"].channel.bytes_sent ==
          frame_bytes * FHD_TICKS, "7a: camera bytes on the wire")
    # a relay twin: every data byte through the broker
    rrt, _, rsinks, _, _ = _fig3(None, "relay", 4)
    relay = sum(s.channel.bytes_sent for s in rsinks.values())
    check(rrt.broker.relay_bytes == relay and rrt.broker.relay_msgs ==
          sum(s.channel.msgs_sent for s in rsinks.values()),
          f"7a relay: broker {rrt.broker.relay_bytes} B != channels "
          f"{relay} B")
    # the processing pipeline on the card against the port's CPU path
    card_x = det_inputs[:DET_CPU_TICKS]
    del det_inputs[:]
    _, _, _, cseen, _ = _fig3("cpu", "hybrid", DET_CPU_TICKS)
    cpu_x = det_inputs[:DET_CPU_TICKS]
    check(len(cseen) == DET_CPU_TICKS and len(card_x) == len(cpu_x) ==
          DET_CPU_TICKS, "7a card vs CPU: frame counts")
    aw = np.abs(w.astype(np.float64))
    worst_excess, worst_err, u8_share = float("-inf"), 0.0, 0.0
    for k in range(DET_CPU_TICKS):
        xa = card_x[k].reshape(-1).cpu().numpy()
        xb = cpu_x[k].reshape(-1).numpy()
        du8 = np.abs(np.rint(xa * 255) - np.rint(xb * 255))
        check(du8.max() <= 1 and (du8 > 0).mean() <= DET_U8_SHARE,
              f"7a card vs CPU: scaled frame {k} differs by {du8.max()} "
              f"on {(du8 > 0).mean():.4%} of its values")
        u8_share = max(u8_share, float((du8 > 0).mean()))
        # |Δz_j| <= sum_i |W_ij| |Δx_i| + tol * sum_i |x_i W_ij|; sigmoid
        # and softmax move by at most 2 max_j |Δz_j|
        dz = (np.abs(xa - xb).astype(np.float64) @ aw +
              DET_GEMM_TOL * (np.abs(xb).astype(np.float64) @ aw))
        bound = 2 * dz.max()
        (ga, _), (cb, _) = seen[k], cseen[k]
        check(int(ga.pts) == int(cb.pts), f"7a card vs CPU: inference {k} "
                                          f"pts differ")
        err = max((a.cpu() - b).abs().max().item()
                  for a, b in zip(ga.tensors, cb.tensors))
        check(err <= bound, f"7a card vs CPU: inference {k} differs by "
                            f"{err} > bound {bound}")
        worst_err = max(worst_err, err)
        worst_excess = max(worst_excess, err - bound)
    ms_tick = np.array(secs) * 1e3
    counts = {t: [x[1:] for x in v] for t, v in per_topic.items()}
    row = dict(ticks=FHD_TICKS, frame_bytes=frame_bytes,
               ms_per_tick=ms_tick.tolist(),
               ms_min_median_max=[float(ms_tick.min()),
                                  float(np.median(ms_tick)),
                                  float(ms_tick.max())],
               per_topic=per_topic, relay_bytes_twin=relay,
               card_vs_cpu_max_err=worst_err,
               card_vs_cpu_u8_share=u8_share,
               card_vs_cpu_worst_excess=worst_excess,
               stats={k: v for k, v in rt.stats().items() if "/" in k})
    print(f"phase 7a Fig. 3 at FullHD ({FHD_W}x{FHD_H} uint8, "
          f"{frame_bytes:,} B a frame) over hybrid, 4 devices, "
          f"{FHD_TICKS} ticks: display {lcd.frames} muxed frames, pts = "
          f"min of the rebased camera pts; conservation per topic "
          f"{counts} "
          f"(delivered, dropped, queued, published); broker data bytes 0 "
          f"(relay twin {relay:,} B == its channels); ms/tick min/median/"
          f"max {'/'.join(f'{x:.2f}' for x in row['ms_min_median_max'])}; "
          f"card vs CPU on {DET_CPU_TICKS} frames: scaled uint8 |d| <= 1 "
          f"on {u8_share:.4%} (limit {DET_U8_SHARE:.0%}), detector max "
          f"|d| {worst_err:.3e} within the GEMM bound (tol "
          f"{DET_GEMM_TOL:g} x sum |x W|, worst excess {worst_excess:.2e})")
    return row


def _codec_pubsub(codecs, burst, ticks, seed):
    """Publishers of f32 [1, 512, 2048] frames with ``codecs[i]``, and
    subscribers joining after ``BURST_BACKLOG - 1`` ticks, each ``mqttsrc
    ! tensor_filter model=offload-gate ! mqttsink`` with its publisher's
    codec.  -> (runtime, publisher runs, subscriber
    runs, [[(payload, wire bytes)] republished per subscriber], tick s)"""
    from repro_torch.core import parse_launch
    from repro_torch.device import make_generator
    from repro_torch.runtime import Device, Runtime
    rt = Runtime(burst=burst)
    pubs, subs, seen = [], [], []
    for i, codec in enumerate(codecs):
        opt = OFFLOAD_TRANSFORMS[codec].format(m=1 + i / 8)
        dev = Device(f"pub{i}")
        pubs.append(dev.add_pipeline(parse_launch(
            f"testsrc width={OFFLOAD_L} height=1 channels={OFFLOAD_D} ! "
            f"tensor_converter ! tensor_transform mode=arithmetic "
            f"option={opt} ! mqttsink pub-topic=act/{i} codec={codec} "
            f"name=pub")))
        rt.add_device(dev)
    rt.run(BURST_BACKLOG - 1)
    for i, codec in enumerate(codecs):
        dev = Device(f"sub{i}")
        p = parse_launch(
            f"mqttsrc sub-topic=act/{i} codec={codec} name=src ! "
            f"tensor_filter model=offload-gate ! mqttsink "
            f"pub-topic=act/{i}/out codec={codec} name=pub")
        subs.append(dev.add_pipeline(p, generator=make_generator(
            seed, rt.device)))
        rt.add_device(dev)
        log, push = [], p.elements["pub"].channel.push

        def spy(buf, nbytes=None, _log=log, _push=push):
            _log.append((buf, nbytes))
            return _push(buf, nbytes)
        p.elements["pub"].channel.push = spy
        seen.append(log)
    return rt, pubs, subs, seen, _timed_ticks(rt, ticks)


def _same_tree(a, b, what):
    import torch
    from repro_torch.core.buffers import tree_flatten
    la, ta = tree_flatten(a)
    lb, tb = tree_flatten(b)
    check(ta == tb and len(la) == len(lb), f"{what}: structures differ")
    for x, y in zip(la, lb):
        check(x.dtype == y.dtype and x.shape == y.shape and
              torch.equal(_bits(x), _bits(y)), f"{what}: bits differ")


def _phase_codec_bursts(seed, profile=False):
    """7b: 4 quant8 and 4 sparse:0.15 publishers of stablelm-width
    activations; each late subscriber drains its 6-frame backlog in one
    burst, then steps one frame a tick."""
    import torch
    from repro_torch.core import MqttSrc
    from repro_torch.core import compression as comp
    _register_offload_models(seed)
    codecs = ["quant8"] * 4 + ["sparse:0.15"] * 4
    expect_bytes = {c: _wire_bytes(c, OFFLOAD_L, OFFLOAD_D)
                    for c in ("quant8", "sparse:0.15")}
    comp.reset_codec_stats()
    mark = _graph_mark()    # runtimes of earlier phases hold cycles
    base_gib = mark[2] / 2 ** 30
    _reset_launches()
    rt, pubs, subs, seen, secs = _codec_pubsub(codecs, 8, BURST_TICKS, seed)
    graph = _graph_since(mark)
    launches = _launch_counts()
    torch.cuda.synchronize()
    # what the earlier phases still hold (phase 4's server) is the base
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30 - base_gib
    stats = rt.stats()
    n_sub = BURST_BACKLOG + BURST_TICKS - 1
    for i, (run, codec) in enumerate(zip(subs, codecs)):
        st = stats[f"sub{i}/p0"]
        check((run.frames, run.bursts, run.burst_frames) ==
              (n_sub, 1, BURST_BACKLOG) and st["bursts"] == 1 and
              st["burst_frames"] == BURST_BACKLOG and st["drops"] == 0,
              f"7b: subscriber {i} frames/bursts/burst_frames/drops "
              f"{st} != {n_sub}/1/{BURST_BACKLOG}/0")
        check(len(seen[i]) == n_sub and all(
            nb == expect_bytes[codec] for _, nb in seen[i]),
            f"7b: subscriber {i} republished {len(seen[i])} frames of "
            f"{sorted({nb for _, nb in seen[i]})} B, expected {n_sub} of "
            f"{expect_bytes[codec]}")
        pch = pubs[i].pipe.elements["pub"].channel
        check(pch.bytes_sent == pch.msgs_sent * expect_bytes[codec],
              f"7b: publisher {i} wire bytes")
    check(comp.codec_stats()["sparse_dropped_values"] == 0,
          f"7b: sparse truncation {comp.codec_stats()}")
    expect = {}
    for enc, dec, codec in (("quantize8", "dequantize8", "quant8"),
                            ("sparse_enc", "sparse_dec", "sparse:0.15")):
        idx = [i for i, c in enumerate(codecs) if c == codec]
        expect[enc] = sum(pubs[i].frames + subs[i].frames for i in idx)
        expect[dec] = sum(subs[i].bursts + subs[i].frames -
                          subs[i].burst_frames for i in idx)
    for k, n in expect.items():
        check(launches[k] == n, f"7b: {k} launched {launches[k]} times, "
                                f"expected {n} (encode: one per published "
                                f"and republished frame; decode: one "
                                f"stacked launch per burst, one per "
                                f"single step)")
    # the burst=1 twin steps the same frames one a tick
    _, _, subs1, seen1, _ = _codec_pubsub(codecs, 1, n_sub, seed)
    for i in range(len(codecs)):
        check(subs1[i].bursts == 0 and len(seen1[i]) == n_sub,
              f"7b twin: subscriber {i}")
        for k, ((a, na), (b, nb)) in enumerate(zip(seen[i], seen1[i])):
            check(na == nb and a.meta == b.meta and
                  int(a.pts) == int(b.pts),
                  f"7b: subscriber {i} frame {k}: meta/pts/bytes differ")
            _same_tree(a.tensors, b.tensors,
                       f"7b: subscriber {i} frame {k} burst != burst=1")
    # pull_burst's stacked decode == per-frame decode, on queued payloads
    for i in (0, 4):
        raws = list(pubs[i].pipe.elements["pub"].channel.q)[:BURST_BACKLOG]
        src = MqttSrc(sub_topic="x", codec=codecs[i])
        for k, (a, b) in enumerate(zip(src._decode_burst(raws),
                                       [comp.decode(r, codecs[i])
                                        for r in raws])):
            _same_tree(a.tensors, b.tensors,
                       f"7b: {codecs[i]} stacked decode frame {k}")
    ms_tick = np.array(secs) * 1e3
    steady = ms_tick[1:]
    row = dict(codecs=codecs, backlog=BURST_BACKLOG, ticks=BURST_TICKS,
               burst_tick_ms=float(ms_tick[0]),
               steady_ms_per_tick=steady.tolist(),
               steady_ms_min_median_max=[float(steady.min()),
                                         float(np.median(steady)),
                                         float(steady.max())],
               wire_bytes=expect_bytes, peak_gib_over_base=peak_gib,
               base_gib=base_gib,
               launches={k: launches[k] for k in expect},
               stats={k: v for k, v in stats.items() if "/" in k},
               graphs=graph["graphs"], graph_mib=graph["graph_mib"])
    print(f"phase 7b codec pub/sub f32 [1, {OFFLOAD_L}, {OFFLOAD_D}], 4 "
          f"quant8 + 4 sparse:0.15 publishers: each late subscriber drained "
          f"{BURST_BACKLOG} frames in 1 burst, then 1 a tick "
          f"({n_sub} frames); == burst=1 twin bitwise; stacked decode == "
          f"per-frame decode; wire B/frame {expect_bytes}; launches "
          f"{row['launches']}; burst tick {ms_tick[0]:.2f} ms, steady "
          f"ms/tick min/median/max "
          f"{'/'.join(f'{x:.2f}' for x in row['steady_ms_min_median_max'])}"
          f"; peak {peak_gib:.2f} GiB over the {base_gib:.2f} GiB the "
          f"earlier phases hold; {graph['graphs']} graphs captured (each "
          f"subscriber bursts once: a binding's first call runs eagerly; "
          f"9d replays bursts)")
    if profile:
        rt2, _, _, _, _ = _codec_pubsub(codecs, 8, 0, seed)
        wall, busy, top = _profile(rt2.tick, warm=False)
        row["profile burst tick"] = {"wall_ms": wall, "device_ms": busy,
                                     "top": [list(r) for r in top[:15]]}
        print(f"phase 7b profile burst tick: host wall {wall:.2f} ms, "
              f"device busy {busy:.2f} ms ({100 * busy / wall:.0f}%); top: "
              + ", ".join(f"{k[:40]} {ms_:.3f} ms x{n}"
                          for k, ms_, n in top[:6]))
    return row


def _phase_query_batch_zero(seed, fused):
    """7c: phase 6a's quant8 offload at query_batch=0 == its fused batch-8
    answers, bitwise."""
    L, D, C, T = OFFLOAD_L, OFFLOAD_D, OFFLOAD_CLIENTS, OFFLOAD_TICKS
    _reset_launches()
    rt, runs, srv, seen, secs = _offload(None, "offload-gate", "quant8", L,
                                         D, C, T, seed, query_batch=0)
    launches = _launch_counts()
    qb = rt.stats()["query_batching"]
    check(qb["sequential_frames"] == C * T and qb["batched_frames"] == 0,
          f"7c: {qb}")
    for k in ("quantize8", "dequantize8"):
        check(launches[k] == 2 * C * T,
              f"7c: {k} launched {launches[k]} times, expected {2 * C * T}"
              f" (request and answer of every frame)")
    got = _answers(runs, T, "7c")
    for i in range(C):
        for t in range(T):
            same_bits(got[i][t], fused[i][t],
                      f"7c: query_batch=0 != batch 8, client {i} tick {t}")
    ms_tick = np.array(secs) * 1e3
    print(f"phase 7c quant8 offload at query_batch=0: {C * T} answers == "
          f"fused batch 8 bitwise; {qb['sequential_frames']} sequential "
          f"serves; launches {{quantize8: {launches['quantize8']}, "
          f"dequantize8: {launches['dequantize8']}}}; ms/tick "
          f"{', '.join(f'{x:.2f}' for x in ms_tick)}")
    return dict(ms_per_tick=ms_tick.tolist(), launches={
        k: launches[k] for k in ("quantize8", "dequantize8")})


def phase_pubsub(seed, fused_6a, profile=False):
    """7: the paper's pub/sub path at full size."""
    return {"7a": _phase_fig3(seed),
            "7b": _phase_codec_bursts(seed, profile=profile),
            "7c": _phase_query_batch_zero(seed, fused_6a)}


RG_MAX_SEQ, RG_SLOTS = 4096, 8
#: phase 8's 12 streams as (client, prompt length, tokens generated):
#: clients 0-3 send two requests, 4-7 one; three prompts are longer than
#: the 2048-position window (the prefill's ring roll), two decode across
#: position 2048 (the ring's wrap), the longest prompt is 3000 tokens
RG_STREAMS = [(0, 2030, 40), (0, 512, 24), (1, 3000, 24), (1, 128, 16),
              (2, 2500, 32), (2, 1024, 20), (3, 2040, 30), (3, 300, 16),
              (4, 2200, 20), (5, 768, 48), (6, 1500, 28), (7, 256, 36)]
#: streams replayed through sequential_decode: both that cross the
#: window, the longest prompt, and one more prompt past the window
RG_REPLAYED = (0, 2, 4, 6)


def _rglru_profile(elem, params, cfg, seed):
    """--profile: one 2048-token prefill and one decode tick with every
    slot active at position 2100 (past the ring's wrap)."""
    import torch
    from repro_torch.core.buffers import tree_flatten
    from repro_torch.models import transformer
    prompt = np.random.default_rng(seed + 8).integers(0, cfg.vocab, 2048)
    res = {"prefill L=2048": _profile(lambda: elem.host_prefill(params,
                                                                prompt))}
    _, c1 = elem.host_prefill(params, prompt)
    cache = transformer.cache_init(cfg, RG_SLOTS, RG_MAX_SEQ)
    for d, s in zip(tree_flatten(cache["layers"])[0],
                    tree_flatten(c1["layers"])[0]):
        d.copy_(s.expand_as(d))
    token = torch.zeros(RG_SLOTS, dtype=torch.int32, device="cuda")
    active = torch.ones(RG_SLOTS, dtype=torch.bool, device="cuda")

    def tick():
        cache["pos"].fill_(2100)
        transformer.serve_decode_step(params, cfg, cache, token, active)
    res["decode tick S=8"] = _profile(tick)
    out = {}
    for name, (wall, busy, rows) in res.items():
        top = ", ".join(f"{k[:40]} {ms_:.2f} ms x{n}" for k, ms_, n in
                        rows[:6])
        scan = [r for r in rows if "rglru_scan_kernel" in r[0]]
        scan_ms = sum(r[1] for r in scan)
        scan_n = sum(r[2] for r in scan)
        print(f"phase 8 profile {name}: host wall {wall:.2f} ms, device "
              f"busy {busy:.2f} ms ({100 * busy / wall:.0f}%); scan kernel "
              f"{scan_ms:.3f} ms x{scan_n}; top: {top}")
        out[name] = {"wall_ms": wall, "device_ms": busy,
                     "scan_ms": scan_ms, "scan_launches": scan_n,
                     "top": [list(r) for r in rows[:15]]}
    return out


def phase_rglru_serve(seed, profile=False):
    """8: recurrentgemma-9b at full width (38 layers: 26 RG-LRU, 12
    windowed attention; bf16, seeded random weights) behind
    ``serve_pipeline(slots=8, max_seq=4096)``, 8 staggered clients, 12
    streams (RG_STREAMS).  Checks every answer, token conservation, the
    scan kernel's launches (one per recurrent layer per prefill, and no
    flash kernel: windowed layers take plain attention), continuous ==
    sequential decode bitwise on RG_REPLAYED (each in its serve slot);
    8c: an fp32 recurrentgemma-smoke server on the card == the port's CPU
    path, its ring wrapped and a prompt longer than its window."""
    import torch
    from repro_torch.configs import recurrentgemma_9b
    from repro_torch.launch import model_serve as ms
    from repro_torch.models import transformer

    cfg = recurrentgemma_9b.config()
    ms.register_serve_model("recurrentgemma-9b", lambda: cfg)
    n_rec = sum(cfg.kind(i) == "R" for i in range(cfg.n_layers))
    rng = np.random.default_rng(seed + 8)
    streams = [(c, rng.integers(0, cfg.vocab, n).tolist(), gen)
               for c, n, gen in RG_STREAMS]
    clients = [(2 * c, [p for cc, p, _ in streams if cc == c],
                [g for cc, _, g in streams if cc == c]) for c in range(8)]

    mark = _graph_mark()
    base_gib = mark[2] / 2 ** 30
    _reset_launches()
    rt, srv, runs, wall = _serve(None, "recurrentgemma-9b", RG_SLOTS,
                                 RG_MAX_SEQ, clients, seed, max_ticks=600)
    graph = _graph_since(mark)
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    answers = _check_answers(runs, clients, cfg.vocab, RG_SLOTS)
    qb = rt.stats()["query_batching"]
    check(qb["tokens_generated"] == qb["tokens_delivered"] +
          qb["tokens_dropped"] + qb["tokens_in_flight"],
          f"8: token conservation broken: {qb}")
    check(qb["tokens_delivered"] == sum(g for _, _, g in streams),
          f"8: {qb['tokens_delivered']} tokens delivered")
    check(launches["rglru_scan"] == n_rec * qb["prefills"],
          f"8: scan launches {launches['rglru_scan']} != {n_rec} x "
          f"{qb['prefills']} prefills")
    check(launches["flash_attention"] == launches["flash_decode"] == 0,
          f"8: windowed layers reached a flash kernel: {launches}")
    check(qb["batched_frames"] > qb["decode_ticks"],
          "8: the decode batch was never wider than one stream")
    serve = dict(ticks=rt.ticks, wall_s=wall, prefills=qb["prefills"],
                 decode_ticks=qb["decode_ticks"],
                 tokens=qb["tokens_generated"],
                 prefill_ms_per_request=1e3 * qb["prefill_seconds"] /
                 qb["prefills"],
                 decode_ms_per_tick=1e3 * qb["decode_seconds"] /
                 qb["decode_ticks"],
                 mean_active_slots=qb["batched_frames"] / qb["decode_ticks"],
                 tokens_per_s=qb["tokens_generated"] / wall,
                 peak_gib=peak_gib, base_gib=base_gib,
                 launches={"rglru_scan": launches["rglru_scan"]},
                 scan_launches_per_prefill=launches["rglru_scan"] /
                 qb["prefills"],
                 decode_ms=[1e3 * x for x in
                            _serve_batcher(rt).decode_times], **graph)
    print(f"phase 8a serve recurrentgemma-9b bf16 {cfg.n_layers} layers "
          f"({n_rec} R, {cfg.n_layers - n_rec} L, window {cfg.window}) "
          f"slots {RG_SLOTS} max_seq {RG_MAX_SEQ}: {len(answers)} answers "
          f"in {rt.ticks} ticks, {wall:.2f} s; prefill "
          f"{serve['prefill_ms_per_request']:.2f} ms/request, decode "
          f"{serve['decode_ms_per_tick']:.2f} ms/tick (mean "
          f"{serve['mean_active_slots']:.2f} active slots), "
          f"{serve['tokens_per_s']:.1f} tokens/s, peak {peak_gib:.2f} GiB, "
          f"{peak_gib - base_gib:.2f} GiB over the {base_gib:.2f} GiB the "
          f"earlier phases hold; {graph['graphs']} graphs captured holding "
          f"{graph['graph_mib']:.1f} MiB; scan launches "
          f"{launches['rglru_scan']} ({serve['scan_launches_per_prefill']:g}"
          f" per prefill)")

    elem = srv.pipe.elements["lm"]
    params = srv.params["lm"]
    by_stream = {}
    for prompt, gen, got, slot in answers:
        by_stream[(len(prompt), gen)] = (prompt, gen, got, slot)
    replayed = []
    for i in RG_REPLAYED:
        _, n, gen = RG_STREAMS[i]
        prompt, gen, got, slot = by_stream[(n, gen)]
        ref = ms.sequential_decode(params, elem.cfg, prompt, gen, RG_MAX_SEQ,
                                   slots=RG_SLOTS, slot=slot)
        check(got == ref, f"8b: continuous != sequential for a {n}-token "
                          f"prompt in slot {slot}: {got} vs {ref}")
        replayed.append(n)
    print(f"phase 8b continuous == sequential decode: {len(replayed)} "
          f"streams bitwise (prompts {replayed}; two decode across "
          f"position {cfg.window}), each replayed in its serve slot")
    serve["profile"] = _rglru_profile(elem, params, elem.cfg, seed) \
        if profile else None
    del rt, srv, runs, elem, params
    gc.collect()
    torch.cuda.empty_cache()

    # 8c: a small fp32 server on the card against the port's CPU path,
    # max_seq above the window of 32: the ring wraps in decode, and two
    # prompts are longer than the window
    small = [(0, [list(range(3, 51))], [10]), (1, [[5, 6]], [40]),
             (2, [list(range(60, 101))], [12]), (3, [[7, 8, 9]], [20])]
    rt2, srv2, runs2, _ = _serve(None, "recurrentgemma-smoke", 4, 64, small,
                                 seed, max_ticks=80)
    got = _check_answers(runs2, small, 512, 4)
    scfg = srv2.pipe.elements["lm"].cfg
    cpu_params = transformer.params_from_numpy(
        _to_numpy(srv2.params["lm"]), scfg, "cpu")
    for prompt, gen, toks, slot in got:
        ref = ms.sequential_decode(cpu_params, scfg, prompt, gen, 64,
                                   slots=4, slot=slot, device="cpu")
        check(toks == ref, f"8c: fp32 card answer {toks} != CPU {ref}")
    print("phase 8c fp32 recurrentgemma-smoke server on the card == the "
          f"port's CPU path: {len(got)} streams (window {scfg.window}, "
          f"max_seq 64)")
    return serve


# ---------------------------------------------------------------------------
# phase 9: the compiled executables (CUDA graphs) against their eager twins
# ---------------------------------------------------------------------------

#: 9b's recurrentgemma-9b streams (client, prompt length, tokens): the
#: first decodes across position 2048 (the ring's wrap), the second is the
#: longest prompt of phase 8
RG9_STREAMS = [(0, 2030, 40), (1, 3000, 24), (2, 512, 24)]
#: 9d: a subscriber held 3 ticks of every 4 drains 8 bursts of 4 frames
#: (the graph route: one eager, one captured, six replayed)
HELD_CYCLES, HELD_TICKS = 8, 4


def _spread(ms):
    a = np.asarray(ms, dtype=np.float64)
    return [float(a.min()), float(np.median(a)), float(a.max())]


def _fmt(v):
    return "/".join(f"{x:.2f}" for x in v)


def _route_line(tag, what, graph_ms, eager_ms, graph, eager, launches):
    print(f"phase {tag} {what}: graph == eager bitwise; ms min/median/max "
          f"graph {_fmt(_spread(graph_ms))}, eager {_fmt(_spread(eager_ms))}"
          f"; {graph['graphs']} graphs captured holding "
          f"{graph['graph_mib']:.1f} MiB; peak over base graph "
          f"{graph['peak_gib_over_base']:.2f} GiB, eager "
          f"{eager['peak_gib_over_base']:.2f} GiB; launches {launches} "
          f"(graph == eager)")


def _route_row(graph_ms, eager_ms, graph, eager, launches, **extra):
    return dict(graph_ms=list(graph_ms), eager_ms=list(eager_ms),
                graph_ms_min_median_max=_spread(graph_ms),
                eager_ms_min_median_max=_spread(eager_ms),
                graphs=graph["graphs"], graph_mib=graph["graph_mib"],
                graph_peak_gib_over_base=graph["peak_gib_over_base"],
                eager_peak_gib_over_base=eager["peak_gib_over_base"],
                launches=launches, **extra)


def _phase_graph_serve(seed, serve4):
    """9a: phase 4's scenario (stablelm-1.6b at full width, 12 streams) at
    jit=False, against phase 4's run through the graphs."""
    from repro_torch.configs import stablelm_1_6b
    vocab = stablelm_1_6b.config().vocab
    clients = serve4["clients"]
    _reset_launches()
    mark = _graph_mark()
    rt, _, runs, _ = _serve(None, "stablelm-1.6b-flash", 8, 1024, clients,
                            seed, max_ticks=400, jit=False)
    eager = _graph_since(mark)
    launches = {k: _launch_counts()[k]
                for k in ("flash_attention", "flash_decode")}
    answers = _check_answers(runs, clients, vocab, 8)
    check(answers == serve4["answers"] and rt.ticks == serve4["ticks"],
          "9a: the eager twin's answers or ticks differ from phase 4's "
          "graph route")
    check(launches == {k: serve4["launches"][k] for k in launches},
          f"9a: launches eager {launches} != graph {serve4['launches']}")
    eager_ms = [1e3 * x for x in _serve_batcher(rt).decode_times]
    check(eager["graphs"] == 0, "9a: the eager twin captured graphs")
    _route_line("9a", f"stablelm-1.6b decode tick, {len(answers)} streams",
                serve4["decode_ms"], eager_ms, serve4, eager, launches)
    return _route_row(serve4["decode_ms"], eager_ms, serve4, eager,
                      launches, streams=len(answers))


def _phase_graph_rglru(seed):
    """9b: recurrentgemma-9b at full width, 3 streams (one across the
    ring's wrap), through the graphs and at jit=False."""
    from repro_torch.configs import recurrentgemma_9b
    cfg = recurrentgemma_9b.config()
    rng = np.random.default_rng(seed + 9)
    clients = [(2 * c, [rng.integers(0, cfg.vocab, n).tolist()], [gen])
               for c, n, gen in RG9_STREAMS]
    res = {}
    for jit in (True, False):
        _reset_launches()
        mark = _graph_mark()
        rt, srv, runs, _ = _serve(None, "recurrentgemma-9b", RG_SLOTS,
                                  RG_MAX_SEQ, clients, seed, max_ticks=200,
                                  jit=jit)
        mem = _graph_since(mark)
        res[jit] = (_check_answers(runs, clients, cfg.vocab, RG_SLOTS),
                    {"rglru_scan": _launch_counts()["rglru_scan"]},
                    [1e3 * x for x in _serve_batcher(rt).decode_times], mem)
        del rt, srv, runs
    (ga, gl, gms, graph), (ea, el, ems, eager) = res[True], res[False]
    check(ga == ea, "9b: graph answers != eager answers")
    check(gl == el, f"9b: launches graph {gl} != eager {el}")
    check(graph["graphs"] >= 1 and eager["graphs"] == 0,
          f"9b: graphs captured {graph['graphs']} / {eager['graphs']}")
    _route_line("9b", f"recurrentgemma-9b decode tick, {len(ga)} streams "
                f"(prompts {[n for _, n, _ in RG9_STREAMS]})", gms, ems,
                graph, eager, gl)
    return _route_row(gms, ems, graph, eager, gl, streams=len(ga))


def _phase_graph_offload(seed, offload6, answers6):
    """9c: phase 6's offload at jit=False (interpreted client walks, the
    eager fused serve batch) against phase 6's graphed client segments and
    graphed fused serve batches: answers and launches over phase 6's 4
    checked ticks, then a graph twin and the eager twin timed tick for
    tick in turns over 48 more."""
    import torch
    L, D, C, T = OFFLOAD_L, OFFLOAD_D, OFFLOAD_CLIENTS, OFFLOAD_TICKS
    kernels = {"quant8": ("quantize8", "dequantize8"),
               "sparse:0.15": ("sparse_enc", "sparse_dec")}
    rows = {}
    for tag, codec in (("9c quant8", "quant8"),
                       ("9c sparse:0.15", "sparse:0.15")):
        _reset_launches()
        mark = _graph_mark()
        ert, eruns, _, _, _ = _offload(None, "offload-gate", codec, L, D, C,
                                       T, seed, jit=False, query_batch=8)
        eager = _graph_since(mark)
        launches = {k: _launch_counts()[k] for k in kernels[codec]}
        got = _answers(eruns, T, tag)
        for i in range(C):
            for t in range(T):
                same_bits(got[i][t], answers6[codec][i][t],
                          f"{tag}: eager != graph, client {i} tick {t}")
        check(launches == offload6[codec]["launches"],
              f"{tag}: launches eager {launches} != graph "
              f"{offload6[codec]['launches']}")
        check(eager["graphs"] == 0, f"{tag}: the eager twin captured")
        grt, gruns, _, _, _ = _offload(None, "offload-gate", codec, L, D, C,
                                       T, seed, query_batch=8)
        for r in eruns + gruns:
            r.sink_log.clear()
        torch.cuda.synchronize()
        graph_ms, eager_ms = [], []
        for _ in range(OFFLOAD_TIMED_TICKS):
            graph_ms += [1e3 * x for x in _timed_ticks(grt, 1)]
            eager_ms += [1e3 * x for x in _timed_ticks(ert, 1)]
        graph = dict(graphs=offload6[codec]["graphs"],
                     graph_mib=offload6[codec]["graph_mib"],
                     peak_gib_over_base=offload6[codec]["peak_gib_over_base"])
        _route_line(tag, f"offload tick, {C} clients f32 [1, {L}, {D}], "
                    f"{OFFLOAD_TIMED_TICKS} ticks each in turns", graph_ms,
                    eager_ms, graph, eager, launches)
        rows[codec] = _route_row(graph_ms, eager_ms, graph, eager, launches)
        del ert, eruns, grt, gruns
    return rows


def _held_bursts(codec, jit, seed):
    """A publisher of stablelm-width f32 frames and a subscriber (``mqttsrc
    ! tensor_filter model=offload-gate ! mqttsink``, same codec), to be
    held for 3 ticks of every 4 so that each of its steps drains a 4-frame
    burst.  -> (runtime, sub run, republished payloads)"""
    from repro_torch.core import parse_launch
    from repro_torch.device import make_generator
    from repro_torch.runtime import Device, Runtime
    rt = Runtime(burst=8)
    opt = OFFLOAD_TRANSFORMS[codec].format(m=1)
    pub = Device("pub")
    pub.add_pipeline(parse_launch(
        f"testsrc width={OFFLOAD_L} height=1 channels={OFFLOAD_D} ! "
        f"tensor_converter ! tensor_transform mode=arithmetic option={opt} "
        f"! mqttsink pub-topic=held codec={codec}"), jit=jit)
    rt.add_device(pub)
    sub = Device("sub")
    sp = parse_launch(f"mqttsrc sub-topic=held codec={codec} ! "
                      f"tensor_filter model=offload-gate ! mqttsink "
                      f"pub-topic=held/out codec={codec} name=pub")
    run = sub.add_pipeline(sp, generator=make_generator(seed, rt.device),
                           jit=jit)
    rt.add_device(sub)
    seen, push = [], sp.elements["pub"].channel.push
    sp.elements["pub"].channel.push = \
        lambda buf, nbytes=None: seen.append(buf) or push(buf, nbytes)
    return rt, run, seen


def _phase_graph_bursts(seed):
    """9d: 7b's codec bursts through the graphed step_n against the same at
    jit=False: a graph twin and an eager twin, their subscribers held 3
    ticks of every 4 and bursting 4 times each, ticked in turns."""
    import torch
    rows = {}
    kernels = {"quant8": ("quantize8", "dequantize8"),
               "sparse:0.15": ("sparse_enc", "sparse_dec")}
    for codec in ("quant8", "sparse:0.15"):
        mark = _graph_mark()
        twins = {jit: _held_bursts(codec, jit, seed) for jit in (True, False)}
        ms = {True: [], False: []}
        launches = {True: dict.fromkeys(kernels[codec], 0),
                    False: dict.fromkeys(kernels[codec], 0)}
        for t in range(HELD_CYCLES * HELD_TICKS):
            for jit, (rt, run, _) in twins.items():
                run.retired = t % HELD_TICKS != HELD_TICKS - 1
                _reset_launches()
                t0 = time.perf_counter()
                rt.tick()
                torch.cuda.synchronize()
                if not run.retired:
                    ms[jit].append(1e3 * (time.perf_counter() - t0))
                for k in kernels[codec]:
                    launches[jit][k] += _launch_counts()[k]
        graph = _graph_since(mark)
        eager = dict(graphs=0, graph_mib=0.0,
                     peak_gib_over_base=graph["peak_gib_over_base"])
        (_, grun, gs), (_, erun, es) = twins[True], twins[False]
        for run in (grun, erun):
            check(run.bursts == HELD_CYCLES and
                  run.burst_frames == HELD_CYCLES * HELD_TICKS,
                  f"9d {codec}: {run.bursts} bursts of {run.burst_frames} "
                  f"frames")
        check(len(gs) == len(es) == HELD_CYCLES * HELD_TICKS,
              f"9d {codec}: {len(gs)} / {len(es)} republished frames")
        for k, (a, b) in enumerate(zip(gs, es)):
            check(a.meta == b.meta and int(a.pts) == int(b.pts),
                  f"9d {codec} frame {k}: meta/pts differ")
            _same_tree(a.tensors, b.tensors,
                       f"9d {codec} frame {k}: graph != eager")
        check(launches[True] == launches[False],
              f"9d {codec}: launches graph {launches[True]} != eager "
              f"{launches[False]}")
        check(graph["graphs"] >= 1, f"9d {codec}: no graph captured")
        _route_line(f"9d {codec}", f"burst tick ({HELD_CYCLES} bursts of "
                    f"{HELD_TICKS} f32 [1, {OFFLOAD_L}, {OFFLOAD_D}] frames"
                    f", twins in turns; peak is both twins')", ms[True],
                    ms[False], graph, eager, launches[True])
        rows[codec] = _route_row(ms[True], ms[False], graph, eager,
                                 launches[True])
        del twins
    return rows


def phase_graphs(seed, serve4, offload6, answers6):
    """9: every graphed route bitwise its eager (jit=False) twin, with the
    same kernel launch counts, and each one's ms per tick, graphs captured
    and graph memory."""
    _register_offload_models(seed)
    return {"9a": _phase_graph_serve(seed, serve4),
            "9b": _phase_graph_rglru(seed),
            "9c": _phase_graph_offload(seed, offload6, answers6),
            "9d": _phase_graph_bursts(seed)}


# ---------------------------------------------------------------------------
# phase 10: failover and live reconfiguration
# ---------------------------------------------------------------------------

#: 10a: the tick before which the first replica dies (every stream is
#: mid-generation then: the shortest generates 16 tokens)
FO_KILL_TICK = 6
#: 10c: streams in flight at the swap, and the tick after which the swap
#: is requested (warm_ticks=1: it commits at the top of tick + 2)
SWAP_STREAMS, SWAP_REQUEST_TICK = 6, 5
#: 10d: the small fp32 server's slots and cache length
SMALL_SLOTS, SMALL_MAX_SEQ = 4, 32


def _kill(rt, dev, ssrc):
    """An announced server death: the device stops, its endpoint stops
    serving and the broker marks the registration down (the shape of
    ``kill_server(crash=True)`` in the tests' chaos harness)."""
    dev.alive = False
    ssrc.endpoint.alive = False
    rt.broker.mark_down(ssrc.registration)


def _revive(rt, dev, ssrc):
    dev.alive = True
    ssrc.endpoint.alive = True
    rt.broker.revive(ssrc.registration)


def _arm_mid_flush_kill(rt, dev, ssrc, ssink, after):
    """Kill the server the instant the ``after``-th answer of a flush
    leaves its serversink (eager ``apply`` or fused ``push_wire``): the
    requests the flush already popped are in the batcher's hands, and must
    reach the orphan ledger.  -> (list that receives the tick it fired,
    disarm())"""
    fired, seen = [], [0]
    orig_apply, orig_push = ssink.apply, ssink.push_wire

    def disarm():
        ssink.__dict__.pop("apply", None)
        ssink.__dict__.pop("push_wire", None)

    def fire():
        seen[0] += 1
        if seen[0] == after:
            disarm()
            _kill(rt, dev, ssrc)
            fired.append(rt.ticks)

    def apply(params, inputs, ctx=None):
        out = orig_apply(params, inputs, ctx)
        fire()
        return out

    def push_wire(payload, nbytes, client_id):
        out = orig_push(payload, nbytes, client_id)
        fire()
        return out
    ssink.apply, ssink.push_wire = apply, push_wire
    return fired, disarm


def _stream_fleet(model, slots, max_seq, clients, seed, n_hubs=2, jit=True,
                  device=None, params=None, **rt_kw):
    """``n_hubs`` replicas of one serve pipeline, each with weights from the
    same seeded generator (or ``params``), and one client per entry of
    ``clients`` ``(prompts, gens)``.  -> (runtime, [(device, run,
    serversrc)], client runs)"""
    from repro_torch.device import make_generator
    from repro_torch.launch import model_serve as ms
    from repro_torch.runtime import Device, Runtime
    rt = Runtime(device=device, **rt_kw)
    hubs = []
    for h in range(n_hubs):
        dev = Device(f"hub{'AB'[h]}", device=device)
        srv = dev.add_pipeline(ms.serve_pipeline(model=model, slots=slots,
                                                 max_seq=max_seq),
                               generator=make_generator(seed, rt.device),
                               jit=jit)
        if params is not None:
            srv.params["lm"] = params
        rt.add_device(dev)
        hubs.append((dev, srv, srv.pipe.elements["ssrc"]))
    runs = []
    for i, (prompts, gens) in enumerate(clients):
        dev = Device(f"tv{i}", device=device)
        p = ";".join(",".join(str(t) for t in pr) for pr in prompts)
        runs.append(dev.add_pipeline(ms.client_pipeline(
            prompts=p, gens=";".join(str(g) for g in gens)), jit=jit))
        rt.add_device(dev)
    return rt, hubs, runs


def _drive(rt, runs, clients, max_ticks, before_tick=None):
    """Tick until every client has its answers, retiring each client once
    it has them.  ``before_tick(t)`` runs before tick ``t``.  -> (host ms of
    each tick, the card synchronized at its end; {client: tick of its last
    answer})"""
    import torch
    tick_ms, done_at = [], {}
    while rt.ticks < max_ticks and len(done_at) < len(runs):
        if before_tick is not None:
            before_tick(rt.ticks + 1)
        t0 = time.perf_counter()
        rt.tick()
        if rt.device.type == "cuda":
            torch.cuda.synchronize()
        tick_ms.append(1e3 * (time.perf_counter() - t0))
        for i, run in enumerate(runs):
            if i not in done_at and \
                    len(run.sink_log.get("res", [])) >= len(clients[i][0]):
                done_at[i] = rt.ticks
                run.retired = True
    return tick_ms, done_at


def _tokens(runs):
    return [[np.asarray(b.tensor).tolist() for b in r.sink_log.get("res", [])]
            for r in runs]


def _batcher_of(rt, run):
    return next(b for b in rt.batchers() if b.run is run)


def _conserved(qb, what):
    check(qb["tokens_generated"] == qb["tokens_delivered"] +
          qb["tokens_dropped"] + qb["tokens_in_flight"],
          f"{what}: token conservation broken: {qb}")


def _full_width_clients(seed, n, gen_range):
    from repro_torch.configs import stablelm_1_6b
    vocab = stablelm_1_6b.config().vocab
    rng = np.random.default_rng(seed)
    return [([rng.integers(0, vocab, int(rng.integers(128, 513))).tolist()],
             [int(rng.integers(*gen_range))]) for _ in range(n)]


def _phase_failover_full(seed):
    """10a: two stablelm-1.6b replicas; the first dies before tick
    ``FO_KILL_TICK`` with every stream mid-generation, and the survivor
    regenerates them by prefill replay, bitwise the fault-free twin."""
    from repro_torch.configs import stablelm_1_6b
    n_layers = stablelm_1_6b.config().n_layers
    clients = _full_width_clients(seed + 10, 12, (16, 65))
    _graph_mark()                    # release what earlier phases hold
    rt0, _, runs0 = _stream_fleet("stablelm-1.6b-flash", 8, 1024, clients,
                                  seed)
    _drive(rt0, runs0, clients, max_ticks=400)
    twin = _tokens(runs0)
    del rt0, runs0
    _reset_launches()
    mark = _graph_mark()
    rt, hubs, runs = _stream_fleet("stablelm-1.6b-flash", 8, 1024, clients,
                                   seed)
    (devA, srvA, ssrcA), (_, srvB, _) = hubs
    held, mid = [], {}

    def before(t):
        if t == FO_KILL_TICK:
            bA = _batcher_of(rt, srvA)
            held.append(bA.active_streams())
            mid["remaining"] = [len(r.sink_log.get("res", []))
                                for r in runs]
            mid["prefill_s"] = _batcher_of(rt, srvB).prefill_seconds
            _kill(rt, devA, ssrcA)
    tick_ms, done_at = _drive(rt, runs, clients, max_ticks=400,
                              before_tick=before)
    mem = _graph_since(mark)
    launches = {k: _launch_counts()[k]
                for k in ("flash_attention", "flash_decode")}
    got = _tokens(runs)
    check(held and held[0] == len(clients) and
          mid["remaining"] == [0] * len(clients),
          f"10a: the first replica held {held} streams at the kill, "
          f"answers so far {mid.get('remaining')}")
    for i, (a, b) in enumerate(zip(twin, got)):
        check(len(b) == 1 and len(b[0]) == clients[i][1][0],
              f"10a: client {i} answer lengths {[len(x) for x in b]}")
        check(a == b, f"10a: client {i}'s answer != the fault-free twin's")
    st = rt.stats()
    fo, qb, rc = st["failover"], st["query_batching"], st["reconfig"]
    check(fo["redispatches"] >= held[0],
          f"10a: {fo['redispatches']} re-dispatches < {held[0]} streams")
    _conserved(qb, "10a")
    check(qb["tokens_dropped"] > 0, "10a: no token was declared dropped")
    check(rc["unplanned"] == 1, f"10a: reconfig stats {rc}")
    check(launches["flash_attention"] == n_layers * qb["prefills"] and
          launches["flash_decode"] == n_layers * qb["decode_ticks"],
          f"10a: launches {launches} for {qb['prefills']} prefills and "
          f"{qb['decode_ticks']} decode ticks")
    bA, bB = _batcher_of(rt, srvA), _batcher_of(rt, srvB)
    k = FO_KILL_TICK - 1
    row = dict(
        streams=len(clients), streams_held=held[0],
        recovery_ticks=max(done_at.values()) - FO_KILL_TICK,
        recovery_tick_ms=tick_ms[k], after_recovery_tick_ms=tick_ms[k + 1],
        recovery_prefill_ms=1e3 * (bB.prefill_seconds - mid["prefill_s"]),
        steady_tick_ms_median_before=float(np.median(tick_ms[1:k])),
        decode_ms_median_before=float(np.median(bA.decode_times)) * 1e3,
        decode_ms_median_after=float(np.median(bB.decode_times)) * 1e3,
        prefills=qb["prefills"], tokens_dropped=qb["tokens_dropped"],
        redispatches=fo["redispatches"], ticks=rt.ticks,
        launches=launches, **mem)
    print(f"phase 10a failover stablelm-1.6b bf16 24 layers, 2 replicas x "
          f"8 slots: hubA killed before tick {FO_KILL_TICK} holding "
          f"{held[0]} streams mid-generation; all {len(clients)} answers "
          f"full length and bitwise the fault-free twin; last replayed "
          f"answer {row['recovery_ticks']} ticks after the kill; recovery "
          f"tick {row['recovery_tick_ms']:.1f} ms host "
          f"({row['recovery_prefill_ms']:.1f} ms of replay prefills, "
          f"steady tick median "
          f"{row['steady_tick_ms_median_before']:.1f}, the tick after "
          f"{row['after_recovery_tick_ms']:.1f}); decode ms/tick "
          f"median before {row['decode_ms_median_before']:.2f}, after "
          f"{row['decode_ms_median_after']:.2f}; {qb['tokens_dropped']} "
          f"tokens declared dropped, {fo['redispatches']} re-dispatches; "
          f"launches {launches}; {mem['graphs']} graphs captured holding "
          f"{mem['graph_mib']:.1f} MiB; peak {mem['peak_gib_over_base']:.2f}"
          f" GiB over the base")
    del rt, hubs, runs
    return row


def _phase_failover_offload(seed):
    """10b: phase 6a's offload, two servers, the first killed mid-flush: 3
    ``codec=none`` clients then 5 quant8 ones, so the kill on the 3rd
    answer leaves the quant8 group popped and unserved."""
    from repro_torch.core import parse_launch
    from repro_torch.device import make_generator
    from repro_torch.runtime import Device, Runtime
    L, D, T, kill_tick = OFFLOAD_L, OFFLOAD_D, OFFLOAD_TICKS, 3
    codecs = ["none"] * 3 + ["quant8"] * 5
    opt = OFFLOAD_TRANSFORMS["quant8"]

    def fleet():
        rt = Runtime(query_batch=8)
        hubs = []
        for name in ("hubA", "hubB"):
            dev = Device(name)
            ps = parse_launch(
                "tensor_query_serversrc operation=act name=ssrc ! "
                "tensor_filter model=offload-gate ! "
                "tensor_query_serversink name=ssink")
            ps.elements["ssink"].pair_with(ps.elements["ssrc"])
            srv = dev.add_pipeline(
                ps, generator=make_generator(seed, rt.device))
            rt.add_device(dev)
            hubs.append((dev, srv, ps))
        runs = []
        for i, codec in enumerate(codecs):
            dev = Device(f"cl{i}")
            runs.append(dev.add_pipeline(parse_launch(
                f"testsrc width={L} height=1 channels={D} ! "
                f"tensor_converter ! tensor_transform mode=arithmetic "
                f"option={opt.format(m=1 + i / 8)} ! tensor_query_client "
                f"operation=act codec={codec} name=qc ! appsink name=res")))
            rt.add_device(dev)
        return rt, hubs, runs
    def answers(runs, what):
        out = []
        for i, run in enumerate(runs):
            bufs = run.sink_log.get("res", [])
            check(len(bufs) == T, f"{what}: client {i} has {len(bufs)} "
                                  f"answers after {T} ticks")
            out.append([b.tensor for b in bufs])
        return out
    _register_offload_models(seed)
    rt0, _, runs0 = fleet()
    _timed_ticks(rt0, T)
    twin = answers(runs0, "10b twin")
    del rt0, runs0
    _reset_launches()
    mark = _graph_mark()
    rt, hubs, runs = fleet()
    (devA, srvA, psA), (_, srvB, _) = hubs
    fired, disarm = [], None
    tick_ms = []
    for t in range(1, T + 1):
        if t == kill_tick:
            fired, disarm = _arm_mid_flush_kill(
                rt, devA, psA.elements["ssrc"], psA.elements["ssink"], 3)
        tick_ms += [1e3 * x for x in _timed_ticks(rt, 1)]
        if t == kill_tick:
            disarm()
    mem = _graph_since(mark)
    launches = {k: _launch_counts()[k] for k in ("quantize8", "dequantize8")}
    check(fired == [kill_tick], f"10b: the mid-flush kill fired at {fired}")
    got = answers(runs, "10b")
    for i in range(len(codecs)):
        for t in range(T):
            same_bits(got[i][t], twin[i][t],
                      f"10b: client {i} tick {t}: answer != fault-free twin")
    st = rt.stats()
    fo, qb = st["failover"], st["query_batching"]
    check(qb["flush_orphans"] >= 1 and fo["orphaned_requests"] >= 1,
          f"10b: flush_orphans {qb['flush_orphans']}, orphaned_requests "
          f"{fo['orphaned_requests']}")
    check(fo["redispatches"] >= len(codecs),
          f"10b: {fo['redispatches']} re-dispatches")
    check(launches["quantize8"] > 0 and launches["dequantize8"] > 0,
          f"10b: K1/K2 launches {launches}")
    check(srvA.frames == (kill_tick - 1) * len(codecs) + 3,
          f"10b: hubA served {srvA.frames} frames")
    row = dict(flush_orphans=qb["flush_orphans"],
               orphaned_requests=fo["orphaned_requests"],
               redispatches=fo["redispatches"], tick_ms=tick_ms,
               kill_tick_ms=tick_ms[kill_tick - 1], launches=launches,
               **mem)
    print(f"phase 10b offload f32 [1, {L}, {D}] x {len(codecs)} clients (3 "
          f"codec=none, 5 quant8), hubA killed on its 3rd answer of tick "
          f"{kill_tick}: {len(codecs) * T} answers bitwise the fault-free "
          f"twin; flush_orphans {qb['flush_orphans']}, orphaned_requests "
          f"{fo['orphaned_requests']}, re-dispatches {fo['redispatches']};"
          f" tick ms {_fmt(tick_ms)} (kill tick {row['kill_tick_ms']:.2f});"
          f" K1/K2 launches {launches}")
    del rt, hubs, runs
    return row


def _phase_hot_swap(seed):
    """10c: one stablelm-1.6b server with ``SWAP_STREAMS`` streams
    mid-generation; ``lm`` is swapped for a model_serve of the same config
    with weights from a second seed."""
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.core.element import element_factory
    from repro_torch.core.graphs import graph_stats
    from repro_torch.core.plan import executable_cache_info
    from repro_torch.device import make_generator
    from repro_torch.launch import model_serve as ms
    cfg = stablelm_1_6b.config()
    clients = _full_width_clients(seed + 11, SWAP_STREAMS, (16, 25))
    _reset_launches()
    mark = _graph_mark()
    rt, ((_, srv, _),), runs = _stream_fleet("stablelm-1.6b-flash", 8, 1024,
                                             clients, seed, n_hubs=1)
    b = _batcher_of(rt, srv)
    box, at = {}, {}

    def before(t):
        if t == SWAP_REQUEST_TICK + 1:
            box["rc"] = rt.reconfigure(srv, srv.pipe.reconfig().swap(
                "lm", element_factory("model_serve",
                                      model="stablelm-1.6b-flash",
                                      slots="8", max_seq="1024")),
                warm_ticks=1, rng=make_generator(seed + 1, rt.device))
            box["status"] = box["rc"].status
        if t == SWAP_REQUEST_TICK + 2:
            at["in_flight"] = b.active_streams()
            at["graphs_before"] = executable_cache_info()["graphs"]
        if t in (SWAP_REQUEST_TICK + 2, SWAP_REQUEST_TICK + 3,
                 SWAP_REQUEST_TICK + 5):
            at[t] = graph_stats()["captured"]
    old = srv.params["lm"]
    tick_ms, done_at = _drive(rt, runs, clients, max_ticks=200,
                              before_tick=before)
    mem = _graph_since(mark)
    launches = {k: _launch_counts()[k]
                for k in ("flash_attention", "flash_decode")}
    rc = box["rc"]
    commit = SWAP_REQUEST_TICK + 2
    check(box["status"] == "warming" and rc.status == "committed" and
          rc.committed_tick == commit,
          f"10c: status {box['status']} -> {rc.status} at tick "
          f"{rc.committed_tick}, expected a commit at tick {commit}")
    check(at["in_flight"] == SWAP_STREAMS,
          f"10c: {at['in_flight']} streams in flight at the commit")
    st = rt.stats()
    qb = st["query_batching"]
    check(qb["replays"] == at["in_flight"],
          f"10c: {qb['replays']} replays for {at['in_flight']} streams")
    check(st["reconfig"]["planned"] == 1, f"10c: {st['reconfig']}")
    _conserved(qb, "10c")
    check(launches["flash_attention"] == cfg.n_layers * qb["prefills"] and
          launches["flash_decode"] == cfg.n_layers * qb["decode_ticks"],
          f"10c: launches {launches} for {qb['prefills']} prefills and "
          f"{qb['decode_ticks']} decode ticks")
    new = srv.params["lm"]
    check(new is not old, "10c: the swap kept the old params")
    del old
    # a capture enters torch.cuda.graph, which collects garbage first: the
    # cost of one collection of this heap, for scale
    t0 = time.perf_counter()
    gc.collect()
    gc_ms = 1e3 * (time.perf_counter() - t0)
    ecfg = srv.pipe.elements["lm"].cfg
    for i, run in enumerate(runs):
        bufs = run.sink_log.get("res", [])
        check(len(bufs) == 1, f"10c: client {i} has {len(bufs)} answers")
        ref = ms.sequential_decode(new, ecfg, clients[i][0][0],
                                   clients[i][1][0], 1024, slots=8,
                                   slot=bufs[0].meta["slot"])
        check(np.asarray(bufs[0].tensor).tolist() == ref,
              f"10c: client {i}'s answer != a fresh build on the new "
              f"weights")
    steady = tick_ms[1:SWAP_REQUEST_TICK]
    row = dict(streams=SWAP_STREAMS, commit_tick=commit,
               steady_tick_ms_median=float(np.median(steady)),
               commit_tick_ms=tick_ms[commit - 1],
               after_commit_tick_ms=tick_ms[commit:commit + 2],
               captures_at_commit=at[commit + 1] - at[commit],
               captures_two_after=at[commit + 3] - at[commit + 1],
               graphs_live_before_commit=at["graphs_before"],
               graphs_live_after=executable_cache_info()["graphs"],
               replays=qb["replays"], prefills=qb["prefills"],
               gc_collect_ms=gc_ms, launches=launches, **mem)
    print(f"phase 10c hot swap of stablelm-1.6b (second seed's weights) "
          f"with {SWAP_STREAMS} streams mid-generation: committed at tick "
          f"{commit} (not blocked), {qb['replays']} replays, every answer "
          f"bitwise sequential_decode on the new weights; host ms steady "
          f"tick median {row['steady_tick_ms_median']:.1f}, commit tick "
          f"{row['commit_tick_ms']:.1f}, next two "
          f"{_fmt(row['after_commit_tick_ms'])}; graphs captured at the "
          f"commit tick {row['captures_at_commit']}, in the two after "
          f"{row['captures_two_after']}; live graphs before/after "
          f"{row['graphs_live_before_commit']}/{row['graphs_live_after']}; "
          f"one gc.collect() {gc_ms:.1f} ms; "
          f"launches {row['launches']}; peak "
          f"{mem['peak_gib_over_base']:.2f} GiB over the base")
    del rt, runs, srv, new
    return row


def _binding_bytes():
    """The largest graph binding alive in the executable cache."""
    from repro_torch.core.plan import _EXEC_CACHE
    return max([b.nbytes for e in _EXEC_CACHE.values()
                for f in e["fns"].values() for b in f._bindings.values()],
               default=0)


SMALL_CLIENTS = [([[i + 1, i + 2, i + 3]], [6]) for i in range(3)]


def _small_kill(seed, jit, device=None, params=None, ticks=16):
    """The stateful chaos scenario at the fp32 smoke size: two replicas,
    3 clients, the first replica killed before tick 4."""
    rt, hubs, runs = _stream_fleet("stablelm-smoke-flash", SMALL_SLOTS,
                                   SMALL_MAX_SEQ, SMALL_CLIENTS, seed,
                                   jit=jit, device=device, params=params)
    (devA, _, ssrcA), _ = hubs
    for t in range(1, ticks + 1):
        if t == 4:
            _kill(rt, devA, ssrcA)
        rt.tick()
    return rt, hubs, runs


def _comparable_stats(rt):
    st = rt.stats()
    drop = ("prefill_seconds", "decode_seconds")
    return {k: {kk: vv for kk, vv in st[k].items() if kk not in drop}
            for k in ("failover", "reconfig", "query_batching")}


def _phase_failover_small(seed):
    """10d: the fp32 smoke size: park-deadline expiry with no survivor;
    graph memory over four kill/revive and four swap cycles; the card
    against the port's CPU path and the graph route against jit=False,
    each through a kill."""
    from repro_torch.core.element import element_factory
    from repro_torch.core.graphs import graph_stats
    from repro_torch.device import make_generator
    from repro_torch.models import transformer
    row = {}
    # park-deadline expiry, no survivor
    rt, ((dev, _, ssrc),), runs = _stream_fleet(
        "stablelm-smoke-flash", SMALL_SLOTS, SMALL_MAX_SEQ,
        [([[1, 2]], [6]), ([[2, 3]], [6])], seed, n_hubs=1,
        park_deadline_ticks=3)
    for t in range(1, 11):
        if t == 3:
            _kill(rt, dev, ssrc)
        rt.tick()
    fo = rt.stats()["failover"]
    check(fo["parked_expired"] >= 2, f"10d: park expiries {fo}")
    keys = {"error", "operation", "parked_ticks", "redispatches", "tick"}
    for i, run in enumerate(runs):
        errs = run.sink_log.get("qc.error", [])
        check(errs and all(set(e.meta) == keys and e.tensors == () and
                           e.meta["error"] == "park-deadline" and
                           e.meta["operation"] == "lm" and
                           e.meta["parked_ticks"] == 3 for e in errs),
              f"10d: client {i}'s error frames "
              f"{[e.meta for e in errs]}")
    row["parked_expired"] = fo["parked_expired"]
    del rt, runs
    # graph memory over kill/revive cycles, then swap cycles
    mark = _graph_mark()
    clients = [([[i + 1, i + 2]], [5]) for i in range(2)]
    rt, hubs, runs = _stream_fleet("stablelm-smoke-flash", SMALL_SLOTS,
                                   SMALL_MAX_SEQ, clients, seed)
    (devA, srvA, ssrcA), _ = hubs
    for run in runs:                 # the clients keep asking
        run.sink_log.clear()
    rt.run(3)
    import torch
    mib = {"kill_revive": [], "swap": []}
    reserved = {"kill_revive": [], "swap": []}
    for c in range(4):
        t = rt.ticks
        for k in range(5):
            if rt.ticks + 1 == t + 1:
                _kill(rt, devA, ssrcA)
            if rt.ticks + 1 == t + 3:
                _revive(rt, devA, ssrcA)
            rt.tick()
        mib["kill_revive"].append((graph_stats()["bytes"] - mark[1]) / 2**20)
        reserved["kill_revive"].append(torch.cuda.memory_reserved() / 2**20)
    held = []
    for c in range(4):
        held.append(srvA.params)
        rc = rt.reconfigure(srvA, srvA.pipe.reconfig().swap(
            "lm", element_factory("model_serve",
                                  model="stablelm-smoke-flash",
                                  slots=str(SMALL_SLOTS),
                                  max_seq=str(SMALL_MAX_SEQ))),
            warm_ticks=1, rng=make_generator(seed + 20 + c, rt.device))
        rt.run(4)
        check(rc.status == "committed", f"10d: swap cycle {c}: {rc.status}")
        mib["swap"].append((graph_stats()["bytes"] - mark[1]) / 2**20)
        reserved["swap"].append(torch.cuda.memory_reserved() / 2**20)
    one = _binding_bytes() / 2**20
    for kind, v in mib.items():
        check(v[-1] <= v[0] + one, f"10d: graph MiB over {kind} cycles {v}"
              f" (one binding {one:.2f} MiB)")
    _conserved(rt.stats()["query_batching"], "10d cycles")
    row.update(graph_mib=mib, binding_mib=one, reserved_mib=reserved)
    del rt, hubs, runs, held
    # the card against the port's CPU path, and graph == jit=False
    grt, ghubs, gruns = _small_kill(seed, jit=True)
    ert, _, eruns = _small_kill(seed, jit=False)
    params = transformer.params_from_numpy(
        _to_numpy(ghubs[0][1].params["lm"]),
        ghubs[0][1].pipe.elements["lm"].cfg, "cpu")
    crt, _, cruns = _small_kill(seed, jit=True, device="cpu", params=params)
    got, eager, cpu = _tokens(gruns), _tokens(eruns), _tokens(cruns)
    check(got == eager and _comparable_stats(grt) == _comparable_stats(ert),
          "10d: graph route != jit=False through a kill")
    check(got == cpu, "10d: card != the port's CPU path through a kill")
    check(all(len(a) >= 2 for a in got) and
          grt.stats()["failover"]["redispatches"] >= 3,
          f"10d: answers {got}")
    print(f"phase 10d fp32 stablelm-smoke: {row['parked_expired']} parked "
          f"requests expired into error frames with the reference's meta; "
          f"graph MiB after each of 4 kill/revive cycles "
          f"{_fmt(mib['kill_revive'])} and 4 swap cycles "
          f"{_fmt(mib['swap'])} (one binding {one:.2f} MiB; reserved MiB "
          f"{_fmt(reserved['kill_revive'])} and {_fmt(reserved['swap'])}, "
          f"the retired params kept alive); through a "
          f"kill, graph == jit=False (answers and stats) and card == CPU "
          f"({sum(len(a) for a in got)} answers)")
    return row


def phase_failover(seed):
    """10: failover and live reconfiguration on the card."""
    import dataclasses as dc
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.launch import model_serve as ms
    cfg = dc.replace(stablelm_1_6b.config(), use_flash_attn=True)
    ms.register_serve_model("stablelm-1.6b-flash", lambda: cfg)
    counts = {}
    rows = {}
    for tag, fn in (("10a", _phase_failover_full),
                    ("10b", _phase_failover_offload),
                    ("10c", _phase_hot_swap),
                    ("10d", _phase_failover_small)):
        rows[tag] = fn(seed)
        if "launches" in rows[tag]:
            for k, v in rows[tag]["launches"].items():
                counts[k] = counts.get(k, 0) + v
    rows["launches"] = counts
    return rows


# ---------------------------------------------------------------------------
# phase 11: staged pipeline-parallel serving
# ---------------------------------------------------------------------------

#: 11b: the tick before which stage 2 of the 4-stage chain dies
STAGE_KILL_TICK = 6
#: 11c: the tick after which stage 1's swap is requested (commit at + 2)
STAGE_SWAP_REQUEST_TICK = 5


def _coord(rt):
    from repro_torch.core.batching import StagedStreamingBatcher
    return next(b for b in rt.batchers()
                if isinstance(b, StagedStreamingBatcher))


def _stage_batchers(rt, runs):
    """The hop server of each run in ``runs`` (stage k >= 1)."""
    return [_batcher_of(rt, r) for r in runs]


def _composed(shares):
    """The full tree a chain's stage shares slice."""
    return {"embed": shares[0]["embed"],
            "layers": [l for p in shares for l in p["layers"]],
            "final_norm": shares[-1]["final_norm"]}


def _staged_fleet(model, slots, max_seq, clients, seed, n_stages,
                  standby=(), device=None, shares=None, qos=None,
                  tenants=None):
    """An ``n_stages`` chain (and a standby for each stage in ``standby``),
    one Device a pipeline, every one given the monolithic server's
    generator (or ``shares``), and one client per entry of ``clients``
    ``(prompts, gens)``, tagged with ``tenants[i]`` when given.  ``qos``
    is the runtime's.  -> (runtime, [(device, run, serversrc)] stages then
    standbys, client runs)"""
    from repro_torch.device import make_generator
    from repro_torch.launch import model_serve as ms
    from repro_torch.runtime import Device, Runtime
    rt = Runtime(device=device, qos=qos)
    pipes = [(k, f"stage{k}", ps) for k, ps in enumerate(
        ms.staged_serve_pipelines(model=model, slots=slots, max_seq=max_seq,
                                  n_stages=n_stages))]
    pipes += [(k, f"standby{k}", ms.stage_pipeline(
        model=model, slots=slots, max_seq=max_seq, stage=k,
        n_stages=n_stages)) for k in standby]
    stages = []
    for k, name, ps in pipes:
        dev = Device(name, device=device)
        run = dev.add_pipeline(ps, generator=make_generator(seed, rt.device))
        if shares is not None:
            run.params["lm"] = shares[k]
        rt.add_device(dev)
        stages.append((dev, run, ps.elements["ssrc"]))
    runs = []
    for i, (prompts, gens) in enumerate(clients):
        dev = Device(f"tv{i}", device=device)
        p = ";".join(",".join(str(t) for t in pr) for pr in prompts)
        runs.append(dev.add_pipeline(ms.client_pipeline(
            prompts=p, gens=";".join(str(g) for g in gens),
            tenant=None if tenants is None else tenants[i])))
        rt.add_device(dev)
    return rt, stages, runs


def _stage_launches(coord, hop_servers, layers_per_stage):
    """K5 and K6 launches the chain's work implies: every stage prefill
    (chain or replay) runs its stage's layers through K5, every decode
    hop and replay step through K6."""
    k5 = coord.prefills + sum(b.prefills for b in hop_servers)
    k6 = coord.decode_ticks + sum(b.decode_hops + b.replay_steps
                                  for b in hop_servers)
    return {"flash_attention": layers_per_stage * k5,
            "flash_decode": layers_per_stage * k6}


def _ledgers_balance(coord, what):
    for k in range(1, coord.n_stages):
        led = coord.stage_ledger(k)
        check(led["dispatched"] == led["completed"] + led["failed"],
              f"{what}: stage {k}'s hop ledger {led} does not balance")
    _conserved(coord.stats(), what)


def _hop_bytes(coord, hop_runs, hop_servers, n_stages, d, slots,
               prompt_lens):
    """Hop bytes per decode tick (over the N - 1 hops) and over the
    prefill chains of prompts of ``prompt_lens`` tokens, at 2 B an
    activation, 1 B an active flag, 4 B a token; and the bytes the hop
    channels of the stage runs ``hop_runs`` booked, with the decode hops
    served."""
    act = 2 * d
    per_tick = sum(slots * act + slots +
                   (slots * 4 if k == n_stages - 1 else slots * act)
                   for k in range(1, n_stages))
    prefill = 0
    for n_tok in prompt_lens:
        prefill += sum(n_tok * act + (4 if k == n_stages - 1 else
                                      n_tok * act)
                       for k in range(1, n_stages))
    booked = 0
    for run in hop_runs:
        ep = run.pipe.elements["ssrc"].endpoint
        booked += ep.requests.bytes_sent
        ch = ep.responses.get(coord._hop_cid)
        booked += ch.bytes_sent if ch is not None else 0
    hops = sum(b.decode_hops for b in hop_servers)
    return per_tick, prefill, booked, hops


def _phase_staged_serve(seed, serve4, n_stages):
    """11a: phase 4's clients on an ``n_stages`` chain of stablelm-1.6b:
    every answer bitwise phase 4's and ``sequential_decode``'s."""
    import torch
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.launch import model_serve as ms
    cfg = stablelm_1_6b.config()
    clients = serve4["clients"]
    _reset_launches()
    mark = _graph_mark()
    rt, srvs, runs, wall = _serve(None, "stablelm-1.6b-flash", 8, 1024,
                                  clients, seed, max_ticks=400,
                                  n_stages=n_stages)
    graph = _graph_since(mark)
    launches = {k: fa.LAUNCHES[k] for k in ("flash_attention",
                                            "flash_decode")}
    routes = dict(fa.PREFILL_ROUTE_LAUNCHES)
    answers = _check_answers(runs, clients, cfg.vocab, 8)
    mono = serve4["answers"]
    check([a[2] for a in answers] == [a[2] for a in mono],
          f"11a N={n_stages}: the chain's answers != phase 4's monolithic "
          f"answers")
    check([a[3] for a in answers] == [a[3] for a in mono],
          f"11a N={n_stages}: serve slots {[a[3] for a in answers]} != "
          f"phase 4's {[a[3] for a in mono]}")
    coord = _coord(rt)
    hop_servers = _stage_batchers(rt, srvs[1:])
    st = coord.stats()
    _ledgers_balance(coord, f"11a N={n_stages}")
    check(st["hops_failed"] == 0 and st["tokens_dropped"] == 0 and
          st["prefills"] == st["streams_started"] == len(answers),
          f"11a N={n_stages}: coordinator stats {st}")
    want = _stage_launches(coord, hop_servers, cfg.n_layers // n_stages)
    check(launches == want and launches["flash_attention"] ==
          cfg.n_layers * st["prefills"] and launches["flash_decode"] ==
          cfg.n_layers * st["decode_ticks"],
          f"11a N={n_stages}: launches {launches}, the chain's work "
          f"implies {want}")
    check(routes == {"sm90": launches["flash_attention"], "scalar": 0},
          f"11a N={n_stages}: K5 by route {routes}")
    check(graph["graphs"] == n_stages,
          f"11a N={n_stages}: {graph['graphs']} graphs captured, one "
          f"decode binding a stage expected")
    per_tick, prefill, booked, hops = _hop_bytes(
        coord, srvs[1:], hop_servers, n_stages, cfg.d_model, 8,
        [len(p) for _, prompts, _ in clients for p in prompts])
    check(booked == prefill + hops // max(1, n_stages - 1) * per_tick,
          f"11a N={n_stages}: hop channels booked {booked} B, the hops "
          f"imply {prefill} + {hops} decode hops")
    shares = [r.params["lm"] for r in srvs]
    dec = [1e3 * x for x in coord.decode_times]
    row = dict(n_stages=n_stages, ticks=rt.ticks, wall_s=wall,
               prefills=st["prefills"], decode_ticks=st["decode_ticks"],
               tokens=st["tokens_generated"],
               prefill_chain_ms_per_request=1e3 * st["prefill_seconds"] /
               st["prefills"],
               decode_ms_min_median_max=[min(dec), float(np.median(dec)),
                                         max(dec)],
               tokens_per_s=st["tokens_generated"] / wall,
               hop_bytes_per_tick=per_tick,
               hop_bytes_per_prefill=prefill / st["prefills"],
               launches=launches,
               ledgers={k: coord.stage_ledger(k)
                        for k in range(1, n_stages)}, **graph)
    print(f"phase 11a staged serve stablelm-1.6b bf16 {cfg.n_layers} "
          f"layers over {n_stages} stages ({cfg.n_layers // n_stages} "
          f"layers a stage), "
          f"slots 8, max_seq 1024: {len(answers)} answers in {rt.ticks} "
          f"ticks, {wall:.2f} s, bitwise phase 4's monolithic answers in "
          f"the same slots; prefill chain "
          f"{row['prefill_chain_ms_per_request']:.2f} ms/request; decode "
          f"ms/tick min/median/max {_fmt(row['decode_ms_min_median_max'])}"
          f"; {row['tokens_per_s']:.1f} tokens/s; "
          f"hop bytes {per_tick} a tick, "
          f"{row['hop_bytes_per_prefill']:.0f} a prefill chain (the hop "
          f"channels booked {booked}); {graph['graphs']} graphs captured "
          f"holding {graph['graph_mib']:.1f} MiB; peak "
          f"{graph['peak_gib_over_base']:.2f} GiB over the base; launches "
          f"{launches}; stage ledgers {row['ledgers']}")
    del rt, srvs, runs, hop_servers, coord
    torch.cuda.synchronize()
    return row, shares, answers


def _cache_leaves(cache):
    """A decode cache's layer leaves, in the order every cache keeps."""
    from repro_torch.core.buffers import tree_flatten
    return tree_flatten(cache["layers"])[0]


def _replay_probe(elem, params, seed):
    """On the card: one parked stream's decode step at batch 1 against
    the replay step (the serve batch, in the stream's slot row) and the
    hop's row, all three under the stage element's own config (its flash
    gate too: the hop and the replay run the same attention).  -> (batch 1
    == hop row, replay == hop row)"""
    import torch
    from repro_torch.models import transformer
    cfg = elem.cfg
    dev = params["layers"][0]["norm1"]["scale"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = transformer.L.torch_dtype(cfg.dtype)
    x = torch.randn((1, 100, cfg.d_model), generator=g, device=dev).to(dt)
    _, parked = elem.host_stage_prefill(params, x)
    hop = transformer.stage_cache_init(cfg, elem.stage, elem.n_stages,
                                       elem.slots, elem.max_seq, dev)
    slot = 3
    for d, s_ in zip(*(_cache_leaves(c) for c in (hop, parked))):
        d[slot:slot + 1].copy_(s_)
    hop["pos"][slot:slot + 1].copy_(parked["pos"])
    step = torch.randn((elem.slots, 1, cfg.d_model), generator=g,
                       device=dev).to(dt)
    active = torch.ones((elem.slots,), dtype=torch.bool, device=dev)
    y, _ = transformer.stage_decode(params, cfg, elem.stage, elem.n_stages,
                                    step, hop, advance=active.to(torch.int32))
    b1 = {"pos": parked["pos"].clone(),
          "layers": [{k: v.clone() for k, v in l.items()}
                     for l in parked["layers"]]}
    y1, _ = transformer.stage_decode(params, cfg, elem.stage, elem.n_stages,
                                     step[slot:slot + 1], b1)
    yr, replayed = elem.host_stage_decode(params, step[slot:slot + 1],
                                          parked, slot)
    b1_same = torch.equal(y1, y[slot:slot + 1]) and all(
        torch.equal(a, b[slot:slot + 1]) for a, b in
        zip(_cache_leaves(b1), _cache_leaves(hop)))
    replay_same = torch.equal(yr, y[slot:slot + 1]) and all(
        torch.equal(a, b[slot:slot + 1]) for a, b in
        zip(_cache_leaves(replayed), _cache_leaves(hop)))
    return b1_same, replay_same


def _phase_staged_failover(seed):
    """11b: a 4-stage chain with a standby for stage 2; stage 2 dies
    before tick ``STAGE_KILL_TICK`` with every stream mid-generation and
    the coordinator replays only stage 2 onto the standby."""
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.kernels import flash_attn as fa
    cfg = stablelm_1_6b.config()
    n = 4
    clients = _full_width_clients(seed + 10, 12, (16, 65))
    _graph_mark()
    rt0, _, runs0 = _staged_fleet("stablelm-1.6b-flash", 8, 1024, clients,
                                  seed, n, standby=(2,))
    _drive(rt0, runs0, clients, max_ticks=400)
    twin = _tokens(runs0)
    del rt0, runs0
    _reset_launches()
    mark = _graph_mark()
    rt, stages, runs = _staged_fleet("stablelm-1.6b-flash", 8, 1024,
                                     clients, seed, n, standby=(2,))
    coord = _coord(rt)
    dev2, _, ssrc2 = stages[2]
    at = {}

    def before(t):
        if t == STAGE_KILL_TICK:
            at["slotted"] = len(coord._slots)
            at["waiting"] = len(coord._waiting)
            at["answers"] = [len(r.sink_log.get("res", [])) for r in runs]
            _kill(rt, dev2, ssrc2)
    tick_ms, done_at = _drive(rt, runs, clients, max_ticks=400,
                              before_tick=before)
    mem = _graph_since(mark)
    launches = {k: fa.LAUNCHES[k] for k in ("flash_attention",
                                            "flash_decode")}
    got = _tokens(runs)
    check(at["slotted"] == 8 and at["slotted"] + at["waiting"] ==
          len(clients) and at["answers"] == [0] * len(clients),
          f"11b: at the kill {at}")
    for i, (a, b) in enumerate(zip(twin, got)):
        check(len(b) == 1 and len(b[0]) == clients[i][1][0],
              f"11b: client {i} answer lengths {[len(x) for x in b]}")
        check(a == b, f"11b: client {i}'s answer != the fault-free twin's")
    st = coord.stats()
    _ledgers_balance(coord, "11b")
    check(st["tokens_dropped"] == 0 and
          st["prefills"] == st["streams_started"] and
          st["stage_replays"] >= 1 and st["stage_replay_steps"] >= 1,
          f"11b: coordinator stats {st}")
    led2 = coord.stage_ledger(2)
    check(led2["replays"] == 2 and led2["replay_steps"] ==
          st["stage_replay_steps"],
          f"11b: stage 2 ledger {led2} (first sight, then the standby)")
    hop_servers = _stage_batchers(rt, [r for _, r, _ in stages[1:]])
    standby_b = hop_servers[-1]
    want = _stage_launches(coord, hop_servers, cfg.n_layers // n)
    check(launches == want, f"11b: launches {launches}, the chain's work "
                            f"implies {want}")
    check(standby_b.replay_steps == st["stage_replay_steps"] and
          standby_b.decode_hops > 0, "11b: the standby served no replay")
    b1_same, replay_same = _replay_probe(
        stages[-1][1].pipe.elements["lm"], stages[-1][1].params["lm"], seed)
    check(replay_same, "11b: a replay step != the decode hop's row")
    k = STAGE_KILL_TICK - 1
    row = dict(streams=len(clients), slotted_at_kill=at["slotted"],
               waiting_at_kill=at["waiting"],
               recovery_tick_ms=tick_ms[k],
               after_recovery_tick_ms=tick_ms[k + 1],
               steady_tick_ms_median_before=float(np.median(tick_ms[1:k])),
               replay_prefills=standby_b.prefills,
               replay_steps=standby_b.replay_steps,
               last_answer_tick=max(done_at.values()), ticks=rt.ticks,
               batch1_step_is_hop_row=b1_same, launches=launches,
               ledgers={j: coord.stage_ledger(j) for j in range(1, n)},
               **mem)
    print(f"phase 11b staged failover stablelm-1.6b over 4 stages, stage 2 "
          f"killed before tick {STAGE_KILL_TICK} with {at['slotted']} "
          f"streams slotted and {at['waiting']} waiting: all "
          f"{len(clients)} answers full length and bitwise the fault-free "
          f"twin; no token dropped, prefills == streams started; recovery "
          f"tick {row['recovery_tick_ms']:.1f} ms host "
          f"({standby_b.prefills} replay prefills, "
          f"{standby_b.replay_steps} replay steps on the standby; steady "
          f"tick median {row['steady_tick_ms_median_before']:.1f}, the "
          f"tick after {row['after_recovery_tick_ms']:.1f}); a batch-1 "
          f"step {'is' if b1_same else 'is not'} bitwise the hop's row, "
          f"the replay step (serve batch, slot row) is; launches "
          f"{launches}; {mem['graphs']} graphs captured; stage ledgers "
          f"{row['ledgers']}")
    del rt, stages, runs, hop_servers, coord
    return row


def _composite_decode(shares, cfg, prompt, gen, max_seq, slots, slot):
    """Greedy decode of a composite chain (per-stage trees of different
    draws) through the stage functions at the serve batch, in ``slot``."""
    import torch
    from repro_torch.models import transformer as tt
    n = len(shares)
    dev = shares[0]["embed"]["tok"].device
    x = torch.tensor([prompt], device=dev)
    c1 = []
    for k, p in enumerate(shares):
        x, c = tt.stage_prefill(p, cfg, k, n, x, max_seq)
        c1.append(c)
    tok = tt.greedy(x)
    caches = []
    for k, c in enumerate(c1):
        full = tt.stage_cache_init(cfg, k, n, slots, max_seq, dev)
        full["pos"][slot:slot + 1].copy_(c["pos"])
        for d, s_ in zip(_cache_leaves(full), _cache_leaves(c)):
            d[slot:slot + 1].copy_(s_)
        caches.append(full)
    active = torch.zeros(slots, dtype=torch.bool, device=dev)
    active[slot] = True
    token = torch.zeros(slots, dtype=torch.int32, device=dev)
    token[slot:slot + 1] = tok
    out = [tok[0]]
    for _ in range(max(0, gen - 1)):
        x = token
        for k, p in enumerate(shares):
            x, caches[k] = tt.stage_decode(p, cfg, k, n, x, caches[k],
                                           advance=active.to(torch.int32))
        token = tt.greedy(x)
        out.append(token[slot])
    return [int(t) for t in torch.stack(out).cpu()]


def _phase_stage_swap(seed):
    """11c: stage 1 of a 2-stage chain swapped to a second seed's weights
    while every client's first stream is mid-generation; each client's
    second stream starts after the commit."""
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.core.element import element_factory
    from repro_torch.core.plan import (_EXEC_CACHE, executable_cache_info,
                                       tensor_ptrs)
    from repro_torch.device import make_generator
    from repro_torch.kernels import flash_attn as fa
    cfg = stablelm_1_6b.config()
    rng = np.random.default_rng(seed + 12)
    clients = [([rng.integers(0, cfg.vocab, int(rng.integers(128, 513)))
                 .tolist() for _ in range(2)],
                [int(rng.integers(12, 21)), int(rng.integers(8, 17))])
               for _ in range(SWAP_STREAMS)]
    _reset_launches()
    mark = _graph_mark()
    rt, stages, runs = _staged_fleet("stablelm-1.6b-flash", 8, 1024,
                                     clients, seed, 2)
    coord = _coord(rt)
    _, srv1, ssrc1 = stages[1]
    box, at = {}, {}
    commit = STAGE_SWAP_REQUEST_TICK + 2

    def before(t):
        if t == STAGE_SWAP_REQUEST_TICK + 1:
            box["rc"] = rt.reconfigure(srv1, srv1.pipe.reconfig().swap(
                "lm", element_factory(
                    "model_serve_stage", model="stablelm-1.6b-flash",
                    slots="8", max_seq="1024", stage="1", n_stages="2")),
                warm_ticks=1, rng=make_generator(seed + 1, rt.device))
        if t == commit:
            at["graphs_before"] = executable_cache_info()["graphs"]
            at["in_flight"] = coord.active_streams()
            at["answers"] = [len(r.sink_log.get("res", [])) for r in runs]
    old = srv1.params["lm"]
    tick_ms, _ = _drive(rt, runs, clients, max_ticks=300, before_tick=before)
    mem = _graph_since(mark)
    launches = {k: fa.LAUNCHES[k] for k in ("flash_attention",
                                            "flash_decode")}
    rc = box["rc"]
    check(rc.status == "committed" and rc.committed_tick == commit,
          f"11c: {rc.status} at tick {rc.committed_tick}, expected a commit "
          f"at tick {commit}")
    epoch = ssrc1.endpoint.spec["serve_epoch"]
    st = coord.stats()
    _ledgers_balance(coord, "11c")
    check(epoch >= 1 and at["in_flight"] == SWAP_STREAMS and
          at["answers"] == [0] * SWAP_STREAMS,
          f"11c: serve_epoch {epoch}, at the commit {at}")
    check(st["replays"] == 0 and st["tokens_dropped"] == 0 and
          st["prefills"] == st["streams_started"] == 2 * SWAP_STREAMS and
          st["stage_replays"] >= 2,
          f"11c: a stream restarted or the stage was not replayed: {st}")
    new = srv1.params["lm"]
    check(new is not old, "11c: the swap kept the old params")
    old_ptrs = tensor_ptrs(old)
    stale = sum(1 for e in _EXEC_CACHE.values()
                for f in e["fns"].values() for b in f._bindings.values()
                if b.ptrs & old_ptrs)
    graphs_after = executable_cache_info()["graphs"]
    check(stale == 0, f"11c: {stale} bindings keyed on the retired slice")
    check(graphs_after <= at["graphs_before"],
          f"11c: live graphs {at['graphs_before']} -> {graphs_after}")
    hop_servers = _stage_batchers(rt, [srv1])
    want = _stage_launches(coord, hop_servers, cfg.n_layers // 2)
    check(launches == want, f"11c: launches {launches}, the chain's work "
                            f"implies {want}")
    del old
    shares = [stages[0][1].params["lm"], new]
    ecfg = srv1.pipe.elements["lm"].cfg
    for i, run in enumerate(runs):
        bufs = run.sink_log.get("res", [])
        check(len(bufs) == 2 and [len(b.tensor) for b in bufs] ==
              clients[i][1], f"11c: client {i}'s answers "
                             f"{[len(b.tensor) for b in bufs]}")
        ref = _composite_decode(shares, ecfg, clients[i][0][1],
                                clients[i][1][1], 1024, 8,
                                bufs[1].meta["slot"])
        check(np.asarray(bufs[1].tensor).tolist() == ref,
              f"11c: client {i}'s post-commit answer != the composite "
              f"model's")
    steady = tick_ms[1:STAGE_SWAP_REQUEST_TICK]
    row = dict(streams=2 * SWAP_STREAMS, commit_tick=commit,
               serve_epoch=epoch,
               steady_tick_ms_median=float(np.median(steady)),
               commit_tick_ms=tick_ms[commit - 1],
               after_commit_tick_ms=tick_ms[commit:commit + 2],
               graphs_live_before_commit=at["graphs_before"],
               graphs_live_after=graphs_after,
               stage_replays=st["stage_replays"],
               stage_replay_steps=st["stage_replay_steps"],
               launches=launches, **mem)
    print(f"phase 11c stage swap: stage 1 of the 2-stage stablelm-1.6b "
          f"chain to a second seed's weights with {at['in_flight']} "
          f"streams mid-generation: committed at tick {commit}, serve_epoch "
          f"{epoch}, no stream restarted ({st['stage_replay_steps']} replay "
          f"steps); {SWAP_STREAMS} post-commit answers bitwise the "
          f"composite model's; host ms steady tick median "
          f"{row['steady_tick_ms_median']:.1f}, commit tick "
          f"{row['commit_tick_ms']:.1f}, next two "
          f"{_fmt(row['after_commit_tick_ms'])}; live graphs before/after "
          f"{at['graphs_before']}/{graphs_after}, no binding on the retired "
          f"slice; launches {launches}")
    del rt, stages, runs, new, shares
    return row


def _phase_staged_small(seed):
    """11d: fp32 stablelm-smoke-4l with flash, 2 stages on the card, ==
    the port's CPU path on the same weights; its prefill takes K5's fp32
    route."""
    import dataclasses as dc
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.launch import model_serve as ms
    from repro_torch.models import transformer
    scfg = dc.replace(ms.SERVE_MODELS["stablelm-smoke-4l"](),
                      use_flash_attn=True)
    ms.register_serve_model("stablelm-smoke-4l-flash", lambda: scfg)
    clients = [([[i + 1, i + 2, i + 3], [i + 4]], [6, 4]) for i in range(4)]
    _reset_launches()
    rt, stages, runs = _staged_fleet("stablelm-smoke-4l-flash", 4, 32,
                                     clients, seed, 2)
    _drive(rt, runs, clients, max_ticks=60)
    launches = {k: fa.LAUNCHES[k] for k in ("flash_attention",
                                            "flash_decode")}
    routes = dict(fa.PREFILL_ROUTE_LAUNCHES)
    shares = [transformer.params_from_numpy(_to_numpy(r.params["lm"]), scfg,
                                            "cpu") for _, r, _ in stages]
    crt, _, cruns = _staged_fleet("stablelm-smoke-4l-flash", 4, 32, clients,
                                  seed, 2, device="cpu", shares=shares)
    _drive(crt, cruns, clients, max_ticks=60)
    got, cpu = _tokens(runs), _tokens(cruns)
    check(all(len(a) == 2 for a in got) and got == cpu,
          f"11d: card {got} != the port's CPU path {cpu}")
    check(routes["scalar"] == launches["flash_attention"] > 0 and
          launches["flash_decode"] > 0,
          f"11d: launches {launches}, K5 by route {routes}")
    _ledgers_balance(_coord(rt), "11d")
    print(f"phase 11d fp32 stablelm-smoke-4l (flash) over 2 stages on the "
          f"card == the port's CPU path: {sum(len(a) for a in got)} "
          f"answers; K5 by route {routes}, launches {launches}")
    return dict(answers=sum(len(a) for a in got), launches=launches,
                prefill_route_launches=routes)


def phase_staged(seed, serve4):
    """11: staged pipeline-parallel serving on the card."""
    import dataclasses as dc
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.launch import model_serve as ms
    cfg = dc.replace(stablelm_1_6b.config(), use_flash_attn=True)
    ms.register_serve_model("stablelm-1.6b-flash", lambda: cfg)
    rows = {}
    rows["11a N=2"], shares, answers = _phase_staged_serve(seed, serve4, 2)
    # continuous == sequential, on the tree the stages compose to: one
    # replay a stream serves both N (the N = 4 answers equal the N = 2 ones)
    full = _composed(shares)
    for prompt, gen, got, slot in answers:
        ref = ms.sequential_decode(full, cfg, prompt, gen, 1024, slots=8,
                                   slot=slot)
        check(got == ref, f"11a: a {len(prompt)}-token prompt's answer in "
                          f"slot {slot} != sequential_decode")
    del shares, full
    print(f"phase 11a continuous == sequential decode: {len(answers)} "
          f"streams bitwise on the tree the stages compose to")
    rows["11a N=4"], _, answers4 = _phase_staged_serve(seed, serve4, 4)
    check([a[2] for a in answers4] == [a[2] for a in answers],
          "11a: the N = 4 chain's answers != the N = 2 chain's")
    rows["11b"] = _phase_staged_failover(seed)
    rows["11c"] = _phase_stage_swap(seed)
    rows["11d"] = _phase_staged_small(seed)
    counts = {}
    for row in rows.values():
        for k, v in row["launches"].items():
            counts[k] = counts.get(k, 0) + v
    rows["launches"] = counts
    return rows


# ---------------------------------------------------------------------------
# phase 12: tenant QoS and autoscaling
# ---------------------------------------------------------------------------

QOS_TIERS = ("realtime", "standard", "best-effort")
#: 12's admission contract, ``three_tier_qos(**QOS_KW)`` (PERF.md §4 gives
#: the reason for each value)
QOS_KW = dict(rate=0.5, deadline_ticks=8, max_queue=2, serve_per_tick=2)
#: the shed reasons admission may give
SHED_REASONS = ("rate", "queue-full", "deadline")


def _asc_kw(slots):
    """12's autoscaler: grow once the mean replica holds more streams than
    it has slots, remove the grown replica once the fleet has drained
    (below one stream on two replicas), one action at a time."""
    return dict(high_load=slots + 1, low_load=0.25, max_replicas=2,
                cooldown_ticks=8, warm_ticks=1)


def _qos_clients(seed, per_tier, n_req, vocab, prompt_range, gen_range):
    """``per_tier`` clients a tier with ``n_req`` requests each; the k-th
    client of every tier draws the same generation lengths, so the tiers'
    latencies differ by scheduling alone.  -> [(tier, prompts, gens)]"""
    rng = np.random.default_rng(seed)
    gens = [[int(rng.integers(*gen_range)) for _ in range(n_req)]
            for _ in range(per_tier)]
    return [(tier, [rng.integers(0, vocab, int(rng.integers(*prompt_range)))
                    .tolist() for _ in range(n_req)], gens[k])
            for tier in QOS_TIERS for k in range(per_tier)]


def _qos_fleet(model, slots, max_seq, clients, seed, device=None,
               qos=True):
    """Phase 12's fleet: ``Runtime(qos=three_tier_qos(**QOS_KW))``, one hub
    with weights from ``seed``, an autoscaler on its topic that grows
    replicas from the same seed, and one tagged client per entry of
    ``clients``.  ``qos=False`` is the pre-QoS twin: ``qos=None``, no
    autoscaler.  -> (runtime, hub run, autoscaler or None, client runs)"""
    from repro_torch.device import make_generator
    from repro_torch.launch import model_serve as ms
    from repro_torch.runtime import Autoscaler, Device, Runtime
    rt = Runtime(device=device,
                 qos=ms.three_tier_qos(**QOS_KW) if qos else None)
    hub = Device("hub", device=device)
    srv = hub.add_pipeline(ms.serve_pipeline(model=model, slots=slots,
                                             max_seq=max_seq),
                           generator=make_generator(seed, rt.device))
    rt.add_device(hub)
    asc = None
    if qos:
        asc = Autoscaler(rt, "query/lm", lambda i: ms.serve_pipeline(
            model=model, slots=slots, max_seq=max_seq), seed=seed,
            **_asc_kw(slots))
    runs = []
    for i, (tier, prompts, gens) in enumerate(clients):
        dev = Device(f"{tier}-{i}", device=device)
        runs.append(dev.add_pipeline(ms.client_pipeline(
            prompts=";".join(",".join(str(t) for t in pr) for pr in prompts),
            gens=";".join(str(g) for g in gens), tenant=tier)))
        rt.add_device(dev)
    return rt, srv, asc, runs


def _qos_drive(rt, srv, asc, runs, clients, max_ticks, params=None):
    """Tick until every client has all its answers and the autoscaler (if
    any) has removed what it grew.  A client retires at the end of the
    tick its last answer lands, so it stops between requests.  ``params`` replace
    a grown replica's draw before its commit (the CPU path, whose
    generator draws other weights than the card's).  -> what the run
    recorded, per tick and at the scaling events"""
    import torch
    from repro_torch.core.graphs import graph_stats
    rec = dict(tick_ms=[], captured=[], hub=[], stopped={}, up=None,
               down=None, graph_bytes_before_up=None, replica=None,
               replica_batcher=None, replica_first_decode=None,
               hub_batcher=_batcher_of(rt, srv))
    while rt.ticks < max_ticks:
        if rec["up"] is None:
            rec["graph_bytes_before_up"] = graph_stats()["bytes"]
        t0 = time.perf_counter()
        rt.tick()
        if rt.device.type == "cuda":
            torch.cuda.synchronize()
        rec["tick_ms"].append(1e3 * (time.perf_counter() - t0))
        rec["captured"].append(graph_stats()["captured"])
        b = rec["hub_batcher"]
        rec["hub"].append((len(b._slots), len(b._waiting)))
        p = asc and asc._pending
        if p and rec[p["kind"]] is None:
            rec[p["kind"]] = dict(requested=rt.ticks, handle=p["handle"],
                                  run=p["run"])
            if p["kind"] == "up" and params is not None:
                p["handle"].new_params["lm"] = params
        up = rec["up"]
        if up is not None and rec["replica"] is None and \
                up["handle"].status == "committed":
            rec["replica"] = up["run"]
            rec["replica_batcher"] = _batcher_of(rt, up["run"])
            rec["replica_params"] = up["run"].params["lm"]
        rb = rec["replica_batcher"]
        if rb is not None and rb.decode_ticks and \
                rec["replica_first_decode"] is None:
            rec["replica_first_decode"] = rt.ticks
        for i, run in enumerate(runs):
            if i not in rec["stopped"] and \
                    len(run.sink_log.get("res", [])) >= len(clients[i][1]):
                check(not rt._run_in_flight(run),
                      f"12: client {i} stops with a frame in flight")
                run.retired = True
                rec["stopped"][i] = rt.ticks
        if len(rec["stopped"]) == len(runs) and \
                (asc is None or (asc._pending is None and asc.scale_downs)):
            break
    return rec


def _qos_errors(runs):
    """Every client's error frames as (reason, tenant, tick)."""
    return [[(e.meta["reason"], e.meta["tenant"], e.meta["tick"])
             for e in r.sink_log.get("qc.error", [])] for r in runs]


def _qos_checks(rt, asc, runs, clients, rec, what):
    """What phase 12 holds on either size: every answer full length, every
    shed an error frame whose reason and tenant the ledger booked, the
    tenant laws, one scale-up and one scale-down.  -> stats()"""
    st = rt.stats()                    # asserts per-tenant conservation
    tenants = st["tenants"]
    booked = {tid: dict(t["shed_reasons"]) for tid, t in tenants.items()}
    seen = {}
    for i, (run, (tier, prompts, gens)) in enumerate(zip(runs, clients)):
        got = [len(b.tensor) for b in run.sink_log.get("res", [])]
        check(got == gens, f"{what}: client {i}'s answer lengths {got}, "
                           f"expected {gens}")
        for e in run.sink_log.get("qc.error", []):
            check(e.tensors == () and e.meta["error"] == "shed" and
                  e.meta["reason"] in SHED_REASONS and
                  e.meta["tenant"] == tier and e.meta["operation"] == "lm",
                  f"{what}: client {i}'s error frame {e.meta}")
            r = seen.setdefault(tier, {})
            r[e.meta["reason"]] = r.get(e.meta["reason"], 0) + 1
    check(seen == {t: r for t, r in booked.items() if r},
          f"{what}: error frames {seen} != the ledger's sheds {booked}")
    for tid, t in tenants.items():
        check(t["queued"] == t["in_flight"] == 0 and
              t["served"] == sum(len(c[1]) for c in clients if c[0] == tid),
              f"{what}: tenant {tid}'s ledger {t}")
    check(tenants["realtime"]["shed"] == 0,
          f"{what}: realtime shed {tenants['realtime']['shed_reasons']}")
    check(tenants["standard"]["shed"] >= 1 and
          tenants["best-effort"]["shed"] >= 1,
          f"{what}: standard and best-effort must each shed: "
          f"{ {t: v['shed_reasons'] for t, v in tenants.items()} }")
    check(tenants["realtime"]["p99_ticks"] <=
          tenants["best-effort"]["p99_ticks"],
          f"{what}: realtime p99 {tenants['realtime']['p99_ticks']} > "
          f"best-effort's {tenants['best-effort']['p99_ticks']}")
    sc = st["autoscale"][0]
    check(sc["scale_ups"] == 1 and sc["scale_downs"] == 1 and
          sc["rollbacks"] == 0 and sc["pending"] is None and
          sc["managed_replicas"] == 0, f"{what}: autoscale {sc}")
    check(rec["replica"] is not None and rec["replica"].retired,
          f"{what}: the grown replica was not removed")
    check(max(w for s, w in rec["hub"][:rec["up"]["requested"]]) > 0,
          f"{what}: no stream waited for a slot on the hub before the "
          f"scale-up {rec['hub']}")
    check(rec["replica_batcher"].streams_finished > 0,
          f"{what}: the grown replica served no stream")
    return st


def _tenant_row(t):
    return dict(admitted=t["admitted"], served=t["served"],
                shed=dict(t["shed_reasons"]), p50_ticks=t["p50_ticks"],
                p99_ticks=t["p99_ticks"])


def _phase_qos_full(seed):
    """12a: three tiers of stablelm-1.6b clients against a hub that grows
    to two replicas and drains back to one."""
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.core.graphs import graph_stats
    from repro_torch.launch import model_serve as ms
    cfg = stablelm_1_6b.config()
    clients = _qos_clients(seed + 30, 4, 2, cfg.vocab, (128, 513), (16, 65))
    _reset_launches()
    mark = _graph_mark()
    t0 = time.perf_counter()
    rt, srv, asc, runs = _qos_fleet("stablelm-1.6b-flash", 8, 1024,
                                    clients, seed)
    rec = _qos_drive(rt, srv, asc, runs, clients, max_ticks=600)
    wall = time.perf_counter() - t0
    mem = _graph_since(mark)
    launches = {k: _launch_counts()[k]
                for k in ("flash_attention", "flash_decode")}
    st = _qos_checks(rt, asc, runs, clients, rec, "12a")
    _same_tree(srv.params["lm"], rec.pop("replica_params"),
               "12a: the grown replica's params vs the hub's")
    bats = (rec["hub_batcher"], rec["replica_batcher"])
    prefills = sum(b.prefills for b in bats)
    decode_ticks = sum(b.decode_ticks for b in bats)
    check(launches["flash_attention"] == cfg.n_layers * prefills > 0 and
          launches["flash_decode"] == cfg.n_layers * decode_ticks > 0,
          f"12a: launches {launches} for {prefills} prefills and "
          f"{decode_ticks} decode ticks")
    for b in bats:
        _conserved(b.stats(), "12a")
    one = _binding_bytes()
    after = graph_stats()["bytes"]
    check(after <= rec["graph_bytes_before_up"] + one,
          f"12a: graph bytes {rec['graph_bytes_before_up']} before the "
          f"scale-up, {after} after the scale-down (one binding {one})")
    params, ecfg = srv.params["lm"], srv.pipe.elements["lm"].cfg
    for i, (run, (_, prompts, gens)) in enumerate(zip(runs, clients)):
        for j, b in enumerate(run.sink_log["res"]):
            ref = ms.sequential_decode(params, ecfg, prompts[j], gens[j],
                                       1024, slots=8, slot=b.meta["slot"])
            check(np.asarray(b.tensor).tolist() == ref,
                  f"12a: client {i} answer {j} (slot {b.meta['slot']}) != "
                  f"sequential_decode")
    ms_ = rec["tick_ms"]
    up, down = rec["up"], rec["down"]
    up_commit = up["handle"].committed_tick
    down_commit = down["handle"].committed_tick
    first = rec["replica_first_decode"]
    capture = next(t for t in range(up_commit + 1, len(ms_) + 1)
                   if rec["captured"][t - 1] > rec["captured"][t - 2])
    special = {up["requested"], up_commit, first, capture, down_commit}
    steady = float(np.median([m for t, m in enumerate(ms_, 1)
                              if t not in special]))
    decode = [1e3 * x for b in bats for x in b.decode_times]
    tenants = {tid: _tenant_row(st["tenants"][tid]) for tid in QOS_TIERS}
    row = dict(
        clients=len(clients), streams=sum(len(c[1]) for c in clients),
        ticks=rt.ticks, wall_s=wall, tenants=tenants,
        hub_streams_max=max(s + w for s, w in rec["hub"]),
        hub_waiting_max=max(w for _, w in rec["hub"]),
        scale_up_requested_tick=up["requested"],
        scale_up_commit_tick=up_commit, capture_tick=capture,
        scale_down_requested_tick=down["requested"],
        scale_down_commit_tick=down_commit,
        scale_up_request_tick_ms=ms_[up["requested"] - 1],
        scale_up_commit_tick_ms=ms_[up_commit - 1],
        replica_first_decode_tick=first,
        replica_first_decode_tick_ms=ms_[first - 1],
        capture_tick_ms=ms_[capture - 1],
        scale_down_commit_tick_ms=ms_[down_commit - 1],
        steady_tick_ms_median=steady,
        decode_ms=dict(min=min(decode), median=float(np.median(decode)),
                       max=max(decode)),
        replica_streams=rec["replica_batcher"].streams_finished,
        prefills=prefills, decode_ticks=decode_ticks,
        graph_bytes_before_up=rec["graph_bytes_before_up"],
        graph_bytes_after_down=after, binding_bytes=one,
        autoscale=st["autoscale"][0], launches=launches, **mem)
    for tid, t in tenants.items():
        print(f"phase 12a tenant {tid}: admitted {t['admitted']}, served "
              f"{t['served']}, shed {t['shed'] or 0}, p50 "
              f"{t['p50_ticks']:.0f} p99 {t['p99_ticks']:.0f} ticks")
    print(f"phase 12a QoS fleet stablelm-1.6b bf16 24 layers slots 8 "
          f"max_seq 1024, {len(clients)} clients in 3 tiers, "
          f"{row['streams']} streams, three_tier_qos({QOS_KW}): hub held "
          f"up to {row['hub_streams_max']} streams ({row['hub_waiting_max']}"
          f" waiting for a slot); scale-up requested at tick {up['requested']}"
          f" ({row['scale_up_request_tick_ms']:.1f} ms host, the weight "
          f"draw), committed at tick {up_commit} "
          f"({row['scale_up_commit_tick_ms']:.1f} ms), the grown replica's "
          f"first (eager) decode tick at tick {first} "
          f"({row['replica_first_decode_tick_ms']:.1f} ms) and its "
          f"capture at tick {capture} ({row['capture_tick_ms']:.1f} ms), "
          f"scale-down committed at tick {down_commit} "
          f"({row['scale_down_commit_tick_ms']:.1f} ms), steady tick "
          f"median {steady:.1f} ms; the grown replica served "
          f"{row['replica_streams']} streams on params bitwise the hub's; "
          f"all answers bitwise sequential_decode in their slots; decode "
          f"ms/tick min/median/max {_fmt(list(row['decode_ms'].values()))};"
          f" {rt.ticks} ticks, {wall:.2f} s; graph bytes before the "
          f"scale-up {row['graph_bytes_before_up']}, after the scale-down "
          f"{after} (one binding {one}); peak "
          f"{mem['peak_gib_over_base']:.2f} GiB over the base; launches "
          f"{launches}")
    answers = _tokens(runs)
    del rt, srv, asc, runs, rec, bats, params
    # the pre-QoS twin: scheduling changes order and admission, never
    # answers
    trt, tsrv, _, truns = _qos_fleet("stablelm-1.6b-flash", 8, 1024,
                                     clients, seed, qos=False)
    trec = _qos_drive(trt, tsrv, None, truns, clients, max_ticks=600)
    check(_tokens(truns) == answers,
          "12a: the qos=None twin's answers != the QoS fleet's, request by "
          "request")
    check(not any(r.sink_log.get("qc.error") for r in truns),
          "12a: the qos=None twin shed")
    row["twin_ticks"] = trt.ticks
    row["twin_hub_waiting_max"] = max(w for _, w in trec["hub"])
    print(f"phase 12a qos=None twin (one hub, no autoscaler): all "
          f"{row['streams']} answers equal the QoS fleet's request by "
          f"request; {trt.ticks} ticks, up to "
          f"{row['twin_hub_waiting_max']} streams waiting for a slot")
    del trt, tsrv, truns, trec
    return row


def _phase_qos_small(seed):
    """12b: 12a's scenario cut to stablelm-smoke-flash (fp32, 4 slots, 6
    clients), and a 2-stage stablelm-smoke-4l chain under the same
    contract: the card == the port's CPU path."""
    import dataclasses as dc
    from repro_torch.core.batching import StageQueryBatcher
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.launch import model_serve as ms
    from repro_torch.models import transformer
    clients = _qos_clients(seed + 31, 2, 2, 512, (8, 33), (4, 17))
    _reset_launches()
    out = []
    for device in (None, "cpu"):
        rt, srv, asc, runs = _qos_fleet("stablelm-smoke-flash", 4, 64,
                                        clients, seed, device=device)
        params = None
        if device == "cpu":
            params = transformer.params_from_numpy(
                _to_numpy(out[0][1].params["lm"]),
                srv.pipe.elements["lm"].cfg, "cpu")
            srv.params["lm"] = params
        rec = _qos_drive(rt, srv, asc, runs, clients, max_ticks=300,
                         params=params)
        st = _qos_checks(rt, asc, runs, clients, rec,
                         "12b " + (device or "card"))
        out.append((rt, srv, runs, st))
    (rt, _, runs, st), (_, _, cruns, cst) = out
    check(_tokens(runs) == _tokens(cruns) and
          _qos_errors(runs) == _qos_errors(cruns),
          "12b: the card's answers or error frames != the CPU path's")
    for key in ("tenants", "autoscale"):
        check(st[key] == cst[key],
              f"12b: stats()[{key!r}] card {st[key]} != CPU {cst[key]}")
    launches = {k: fa.LAUNCHES[k] for k in ("flash_attention",
                                            "flash_decode")}
    n_err = sum(len(e) for e in _qos_errors(runs))
    del out, rt, runs, cruns
    # a 2-stage chain whose stage 0 admits under the tenants' budgets
    scfg = dc.replace(ms.SERVE_MODELS["stablelm-smoke-4l"](),
                      use_flash_attn=True)
    ms.register_serve_model("stablelm-smoke-4l-flash", lambda: scfg)
    chain = [(c[1], c[2]) for c in clients]
    tiers = [c[0] for c in clients]
    qos = ms.three_tier_qos(**QOS_KW)
    rt, stages, runs = _staged_fleet("stablelm-smoke-4l-flash", 4, 64, chain,
                                     seed, 2, qos=qos, tenants=tiers)
    _drive(rt, runs, chain, max_ticks=200)
    shares = [transformer.params_from_numpy(_to_numpy(r.params["lm"]), scfg,
                                            "cpu") for _, r, _ in stages]
    crt, _, cruns = _staged_fleet("stablelm-smoke-4l-flash", 4, 64, chain,
                                  seed, 2, device="cpu", shares=shares,
                                  qos=ms.three_tier_qos(**QOS_KW),
                                  tenants=tiers)
    _drive(crt, cruns, chain, max_ticks=200)
    coord = _coord(rt)
    _ledgers_balance(coord, "12b chain")
    t = coord.tenant_stats()
    check(coord.admission.enabled and t["standard"]["shed"] >= 1 and
          t["best-effort"]["shed"] >= 1 and t["realtime"]["shed"] == 0,
          f"12b chain: stage 0's ledger {t}")
    for b in rt.batchers():
        if isinstance(b, StageQueryBatcher):
            hs = b.stats()
            check(not b.admission.enabled and hs["shed_requests"] == 0 and
                  hs["admitted_requests"] == hs["served_requests"],
                  f"12b chain: a hop server's ledger {hs}")
    got, cpu = _tokens(runs), _tokens(cruns)
    check([len(a) for a in got] == [len(c[1]) for c in chain] and
          got == cpu and _qos_errors(runs) == _qos_errors(cruns) and
          rt.stats()["tenants"] == crt.stats()["tenants"],
          "12b chain: the card != the port's CPU path")
    chain_launches = {k: fa.LAUNCHES[k] - launches[k] for k in launches}
    sheds = {tid: v["shed"] for tid, v in st["tenants"].items()}
    print(f"phase 12b fp32 stablelm-smoke-flash, 4 slots, {len(clients)} "
          f"clients: card == the port's CPU path (answers, {n_err} error "
          f"frames, stats()['tenants'] and ['autoscale']), sheds {sheds}, "
          f"one scale-up and one scale-down; 2-stage stablelm-smoke-4l "
          f"chain under the same contract: stage 0 shed "
          f"{ {k: v['shed'] for k, v in t.items()} }, hop servers "
          f"pass-through, ledgers balance, card == CPU; launches "
          f"{launches}, chain {chain_launches}")
    total = {k: launches[k] + chain_launches[k] for k in launches}
    return dict(sheds=sheds, error_frames=n_err, launches=total,
                chain_sheds={k: v["shed"] for k, v in t.items()})


def phase_qos(seed):
    """12: tenant QoS and autoscaling on the card."""
    import dataclasses as dc
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.launch import model_serve as ms
    cfg = dc.replace(stablelm_1_6b.config(), use_flash_attn=True)
    ms.register_serve_model("stablelm-1.6b-flash", lambda: cfg)
    rows = {"12a": _phase_qos_full(seed), "12b": _phase_qos_small(seed)}
    rows["launches"] = {k: rows["12a"]["launches"][k] +
                        rows["12b"]["launches"][k]
                        for k in ("flash_attention", "flash_decode")}
    return rows


# ---------------------------------------------------------------------------
# phase 13: the lossy network and effectively-once delivery
# ---------------------------------------------------------------------------

#: 13a, 13b: every fault class on the request link and every answer link
LOSSY_MIXED = dict(drop=0.05, dup=0.12, corrupt=0.05, delay=0.05,
                   reorder=0.05)
#: 13c: the stage-1 hop link's requests and answers
HOP_REQ, HOP_ANS = dict(dup=0.12, corrupt=0.06, drop=0.03), dict(dup=0.10)
#: the link counter each fault class books
FAULT_COUNTERS = {"drop": "dropped_by_fault", "dup": "injected_dups",
                  "corrupt": "corrupted", "delay": "delayed",
                  "reorder": "reordered"}
#: the request links' fault seeds (answer links draw from seed + 1 and the
#: client id): the schedule is host-side and the same on every run
LOSSY_SEEDS = {"13a": 133, "13b": 135, "13c": 133}
#: the first query client id of each lossy run (see _pin_client_ids)
CLIENT_ID_BASE = {"13a": 1_000_000, "13b": 1_001_000, "13c": 1_002_000}
#: 13d: the ticks whose memcpy calls the profiler counts, after
#: the decode graph's capture and through every join and most answers
CLEAN_WINDOW = (6, 60)


def _lossy_links(rt, ep, req, ans, seed, name):
    """Lossy links (``tests/chaoslib.py``'s ``lossy_endpoint``) on a query
    endpoint's request channel and, with ``ans``, on every answer channel;
    the runtime steps the fabric each tick.  -> the fabric"""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    from chaoslib import lossy_endpoint
    from repro_torch.core.netfault import FaultFabric, FaultPolicy
    if rt.fabric is None:
        rt.fabric = FaultFabric()
    lossy_endpoint(rt.fabric, ep, FaultPolicy(seed=seed, **req),
                   None if ans is None else
                   FaultPolicy(seed=seed + 1, **ans), name=name)
    return rt.fabric


def _pin_client_ids(base):
    """Draw the next query client ids from ``base`` on (above every id
    drawn so far): the answer links' fault seeds derive from client ids,
    so pinned ids give the schedule the CPU rehearsal saw, whatever ran
    before."""
    from repro_torch.core.query import TensorQueryClient
    nxt = next(TensorQueryClient._ids)
    check(nxt <= base, f"client ids already reached {nxt} > {base}")
    TensorQueryClient._ids = itertools.count(base)


def _fired(fabric):
    """Faults injected over every link of ``fabric``, by class."""
    links = list(fabric.stats().values())
    return {k: sum(l[c] for l in links) for k, c in FAULT_COUNTERS.items()}


def _replayed_payloads(guard):
    """{delivery id: the answer payload its replay would re-push}: the
    replay closure's bound payload (``TensorQueryServerSink._ship``)."""
    return {dseq: fn.__defaults__[2] for dseq, fn in guard._answers.items()}


def _client_of(runs):
    """{client id: index} of the clients' query elements."""
    return {r.pipe.elements["qc"].client_id: i for i, r in enumerate(runs)}


def _unprofiled(tick_ms):
    """The host ms of the ticks outside 13d's profiled window (tick t is
    ``tick_ms[t - 1]``)."""
    lo, hi = CLEAN_WINDOW
    return [ms for t, ms in enumerate(tick_ms, 1) if not lo <= t < hi]


def _copies(prof):
    """-> (memcpy calls the host issued: the CUDA runtime API records;
    device-to-host copies the device recorded).  A host read of a CUDA
    tensor is one more API call.  The device's own records are not a
    count: CUPTI drops some under load (PR 23: with the same 702 API
    calls, one run recorded 603 device-to-device copies and another 873,
    and 52 or 54 device-to-host ones)."""
    rows = prof.key_averages()
    return (sum(e.count for e in rows if e.key.startswith("cudaMemcpy")),
            sum(e.count for e in rows if "Memcpy DtoH" in e.key))


def _phase_clean_overhead(seed, serve4, model="stablelm-1.6b-flash",
                          device=None):
    """13d: phase 4's graphed serve with the delivery layer on over
    zero-rate links, against delivery off, in turns (off, on, on, off):
    answers bitwise; the first pair counts the memcpy calls the host
    issues in ticks 6-59 under the profiler (equal: the CRC never reads a
    CUDA tensor, which would be one more call; the device-to-host records
    print beside them), the second pair is timed without it (median tick
    side by side)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.netfault import DeliveryPolicy
    from repro_torch.kernels import flash_attn as fa
    clients = serve4["clients"]
    cuda = torch.device(device or "cuda").type == "cuda"
    rows, answers = {}, {}
    for key, profiled in (("off", True), ("on", True), ("on2", False),
                          ("off2", False)):
        on = key.startswith("on")
        prof = profile(activities=[ProfilerActivity.CUDA]) \
            if cuda and profiled else None
        live = []

        def before(t, prof=prof, live=live):
            if prof is None:
                return
            if t == CLEAN_WINDOW[0]:
                torch.cuda.synchronize()
                prof.start()
                live.append(1)
            elif t == CLEAN_WINDOW[1] and live:
                torch.cuda.synchronize()
                prof.stop()
                live.clear()

        def servers(rt, srvs, on=on):
            if on:
                # a FaultLink on every link, every rate zero
                _lossy_links(rt, srvs[0].pipe.elements["ssrc"].endpoint,
                             {}, {}, 0, "clean")
        tick_ms = []
        _reset_launches()
        rt, srv, runs, wall = _serve(
            device, model, 8, 1024, clients, seed, max_ticks=400,
            rt_kw=dict(delivery=DeliveryPolicy()) if on else {},
            on_servers=servers, tick_ms=tick_ms, before_tick=before)
        if live:
            torch.cuda.synchronize()
            prof.stop()
        launches = {k: fa.LAUNCHES[k] for k in ("flash_attention",
                                                "flash_decode")}
        qb = rt.stats()["query_batching"]
        _conserved(qb, f"13d {key}")
        answers[key] = _check_answers(runs, clients,
                                      srv.pipe.elements["lm"].cfg.vocab, 8)
        rows[key] = dict(
            ticks=rt.ticks, tick_ms=tick_ms,
            tick_ms_median=float(np.median(
                _unprofiled(tick_ms) if profiled else tick_ms)),
            prefills=qb["prefills"], decode_ticks=qb["decode_ticks"],
            tokens=qb["tokens_generated"], launches=launches,
            memcpy_calls=None if prof is None else _copies(prof)[0],
            d2h_copies=None if prof is None else _copies(prof)[1])
        if on:
            d = rt.stats()["delivery"]
            check(d["retransmits"] == d["deduped"] == d["replayed"] ==
                  d["rejected_corrupt"] == d["client_answer_dups"] == 0,
                  f"13d: the delivery layer acted on clean links: {d}")
            rt.fabric.assert_conservation()
            check(sum(_fired(rt.fabric).values()) == 0,
                  "13d: a zero-rate link injected a fault")
            rows[key]["delivery"] = d
        del rt, srv, runs
        gc.collect()
    off = rows["off"]
    for key in ("on", "on2", "off2"):
        check(answers[key] == answers["off"],
              f"13d: answers of the {key} run != the off run's")
        check(rows[key]["launches"] == off["launches"] and
              rows[key]["ticks"] == off["ticks"],
              f"13d: launches or ticks differ: {key} "
              f"{rows[key]['launches']} {rows[key]['ticks']} vs off "
              f"{off['launches']} {off['ticks']}")
    check([a[2:] for a in answers["off"]] ==
          [a[2:] for a in serve4["answers"]],
          "13d: the delivery-off twin's answers or slots != phase 4's")
    if cuda:
        check(off["memcpy_calls"] > 0 and off["d2h_copies"] > 0,
              "13d: the profiler saw no host-issued or device-to-host "
              "copy at all")
        check(rows["on"]["memcpy_calls"] == off["memcpy_calls"],
              f"13d: memcpy calls {rows['on']['memcpy_calls']} with "
              f"delivery on != {off['memcpy_calls']} off")
    med = {k: rows[k]["tick_ms_median"] for k in rows}
    print(f"phase 13d clean-link overhead, phase 4's graphed serve "
          f"({len(answers['off'])} streams, {off['ticks']} ticks), run "
          f"off, on, on, off: answers bitwise in all four and == phase 4; "
          f"memcpy calls in ticks {CLEAN_WINDOW[0]}..{CLEAN_WINDOW[1] - 1} "
          f"(profiled pair): {rows['on']['memcpy_calls']} on, "
          f"{off['memcpy_calls']} off (device-to-host records "
          f"{rows['on']['d2h_copies']} / {off['d2h_copies']}); median "
          f"tick ms, profiled pair outside the window: on "
          f"{med['on']:.3f} / off {med['off']:.3f}; unprofiled pair, every "
          f"tick: on {med['on2']:.3f} / off {med['off2']:.3f}; delivery "
          f"{rows['on']['delivery']}")
    total = {k: sum(r["launches"][k] for r in rows.values())
             for k in off["launches"]}
    return dict(rows, launches=total)


def _phase_lossy_serve(seed, serve4, twin, model="stablelm-1.6b-flash",
                       device=None):
    """13a: phase 4's clients against phase 4's server with every fault
    class on both directions of its links."""
    from repro_torch.core.netfault import DeliveryPolicy
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.launch import model_serve as ms
    clients = serve4["clients"]
    tick_ms = []
    _pin_client_ids(CLIENT_ID_BASE["13a"])
    _reset_launches()
    rt, srv, runs, wall = _serve(
        device, model, 8, 1024, clients, seed, max_ticks=800,
        rt_kw=dict(delivery=DeliveryPolicy()),
        on_servers=lambda rt, srvs: _lossy_links(
            rt, srvs[0].pipe.elements["ssrc"].endpoint, LOSSY_MIXED,
            LOSSY_MIXED, LOSSY_SEEDS["13a"], "lm"),
        tick_ms=tick_ms)
    launches = {k: fa.LAUNCHES[k] for k in ("flash_attention",
                                            "flash_decode")}
    ecfg = srv.pipe.elements["lm"].cfg
    answers = _check_answers(runs, clients, ecfg.vocab, 8)
    fabric = rt.fabric
    fabric.assert_conservation()
    fired = _fired(fabric)
    check(all(v > 0 for v in fired.values()),
          f"13a: a fault class never fired: {fired}")
    st = rt.stats()
    qb, d = st["query_batching"], st["delivery"]
    _conserved(qb, "13a")
    # effectively once: one prefill a logical request, every token once
    check(qb["prefills"] == qb["streams_started"] == len(answers) ==
          twin["prefills"], f"13a: {qb['prefills']} prefills, "
          f"{qb['streams_started']} streams for {len(answers)} requests "
          f"(twin {twin['prefills']})")
    check(qb["tokens_generated"] == twin["tokens"] and
          qb["tokens_dropped"] == 0,
          f"13a: {qb['tokens_generated']} tokens generated, the twin "
          f"{twin['tokens']}")
    check(launches["flash_attention"] == twin["launches"]["flash_attention"]
          == ecfg.n_layers * qb["prefills"],
          f"13a: K5 launches {launches} vs the twin's {twin['launches']}")
    check(launches["flash_decode"] == ecfg.n_layers * qb["decode_ticks"],
          f"13a: K6 launches {launches} != {ecfg.n_layers} x "
          f"{qb['decode_ticks']} decode ticks")
    # every stream bitwise its twin's (phase 4) where it was served in the
    # same slot, and sequential_decode's in the slot it was served in
    params = srv.params["lm"]
    same_slot = replayed = 0
    refs = {}
    for (prompt, gen, got, slot), (_, _, want, wslot) in zip(
            answers, serve4["answers"]):
        if slot == wslot:
            check(got == want, f"13a: a {len(prompt)}-token stream in slot "
                               f"{slot} != its fault-free twin's")
            same_slot += 1
            continue
        key = (tuple(prompt), gen, slot)
        if key not in refs:
            refs[key] = ms.sequential_decode(params, ecfg, prompt, gen, 1024,
                                             slots=8, slot=slot,
                                             device=rt.device)
        check(got == refs[key], f"13a: a {len(prompt)}-token stream in "
                                f"slot {slot} != sequential_decode")
        replayed += 1
    # the replay cache holds exactly what each client received
    guard = _batcher_of(rt, srv).guard
    idx = _client_of(runs)
    for (cid, n), p in _replayed_payloads(guard).items():
        got = np.asarray(runs[idx[cid]].sink_log["res"][n - 1].tensor)
        check(np.array_equal(np.asarray(p.tensors[0]), got),
              f"13a: the replay cache's answer {cid, n} != the delivered one")
    row = dict(ticks=rt.ticks, twin_ticks=twin["ticks"], wall_s=wall,
               tick_ms_median=float(np.median(tick_ms)),
               twin_tick_ms_median=twin["tick_ms_median"],
               prefills=qb["prefills"], decode_ticks=qb["decode_ticks"],
               twin_decode_ticks=twin["decode_ticks"],
               tokens=qb["tokens_generated"], launches=launches,
               twin_launches=twin["launches"], fired=fired, delivery=d,
               same_slot=same_slot, other_slot=replayed,
               replay_cache=len(guard._answers))
    print(f"phase 13a lossy streaming serve stablelm-1.6b bf16, phase 4's "
          f"8 clients, every link drop/dup/corrupt/delay/reorder "
          f"{'/'.join(str(LOSSY_MIXED[k]) for k in FAULT_COUNTERS)}: "
          f"{len(answers)} streams in {rt.ticks} ticks (twin "
          f"{twin['ticks']}), {same_slot} bitwise the twin's in the same "
          f"slot, {replayed} in another slot bitwise sequential_decode; "
          f"faults fired {fired}; delivery {d}; {qb['prefills']} prefills "
          f"and {qb['tokens_generated']} tokens (twin {twin['prefills']}, "
          f"{twin['tokens']}); launches {launches} (twin "
          f"{twin['launches']}; {qb['decode_ticks']} decode ticks, twin "
          f"{twin['decode_ticks']}); median tick "
          f"{row['tick_ms_median']:.3f} ms vs the twin's (13d's last "
          f"unprofiled off run) {twin['tick_ms_median']:.3f}; message "
          f"conservation exact on {len(fabric.links)} links")
    del rt, srv, runs
    gc.collect()
    return row


def _phase_lossy_offload(seed, answers6, model="offload-gate", device=None,
                         width=None, channels=None):
    """13b: phase 6's 8 clients and server (quant8, then sparse:0.15) with
    every fault class on both directions of the server's links."""
    from repro_torch.core import compression as comp
    from repro_torch.core.netfault import DeliveryPolicy
    L, D = width or OFFLOAD_L, channels or OFFLOAD_D
    C, T = OFFLOAD_CLIENTS, OFFLOAD_TICKS
    kernels = {"quant8": ("quantize8", "dequantize8"),
               "sparse:0.15": ("sparse_enc", "sparse_dec")}
    rows = {}
    for k, codec in enumerate(("quant8", "sparse:0.15")):
        _pin_client_ids(CLIENT_ID_BASE["13b"] + 100 * k)
        rt, runs, srv, _, _ = _offload(device, model, codec, L, D, C, 0,
                                       seed, query_batch=8,
                                       delivery=DeliveryPolicy())
        fabric = _lossy_links(rt, srv.pipe.elements["ssrc"].endpoint,
                              LOSSY_MIXED, LOSSY_MIXED,
                              LOSSY_SEEDS["13b"] + 2 * k, "act")
        _reset_launches()
        while rt.ticks < 200:
            rt.tick()
            for r in runs:
                if len(r.sink_log.get("res", [])) >= T:
                    r.retired = True
            if all(r.retired for r in runs):
                break
        launches = {n: v for n, v in _launch_counts().items()
                    if n in kernels[codec]}
        fabric.assert_conservation()
        fired = _fired(fabric)
        d = rt.stats()["delivery"]
        guard = _batcher_of(rt, srv).guard
        for i, r in enumerate(runs):
            got = [b.tensor for b in r.sink_log.get("res", [])]
            check(len(got) >= T, f"13b {codec}: client {i} has {len(got)} "
                                 f"answers after {rt.ticks} ticks")
            for t in range(T):
                same_bits(got[t], answers6[codec][i][t],
                          f"13b {codec} client {i} request {t}: answer != "
                          f"phase 6's")
        check(d["rejected_corrupt"] > 0,
              f"13b {codec}: no corrupt request was rejected: {d}")
        check(srv.frames == guard.accepted,
              f"13b {codec}: the server served {srv.frames} frames, its "
              f"guard accepted {guard.accepted}")
        idx = _client_of(runs)
        pinned = 0
        for (cid, n), p in _replayed_payloads(guard).items():
            if n <= T:
                same_bits(comp.decode(p, codec).tensor,
                          answers6[codec][idx[cid]][n - 1],
                          f"13b {codec}: the replay cache's answer "
                          f"{cid, n} != phase 6's")
                pinned += 1
        rows[codec] = dict(ticks=rt.ticks, fired=fired, delivery=d,
                           launches=launches, served=srv.frames,
                           replay_cache_pinned=pinned)
        print(f"phase 13b lossy offload {codec} f32 [1, {L}, {D}] x {C} "
              f"clients: {T} answers each bitwise phase 6's in {rt.ticks} "
              f"ticks; faults fired {fired}; delivery {d}; the server "
              f"served {srv.frames} frames == the guard's accepted; "
              f"launches {launches} beside {d['retransmits']} "
              f"retransmits; {pinned} replay-cache answers bitwise phase "
              f"6's")
        del rt, runs, srv, guard
        gc.collect()
    rows["launches"] = {n: v for row in list(rows.values())
                        for n, v in row["launches"].items()}
    return rows


def _phase_lossy_staged(seed, serve4, twin_launches,
                        model="stablelm-1.6b-flash", device=None):
    """13c: phase 11a's 2-stage chain with the stage-1 hop link lossy both
    ways."""
    from repro_torch.core.netfault import DeliveryPolicy
    from repro_torch.kernels import flash_attn as fa
    clients = serve4["clients"]
    _pin_client_ids(CLIENT_ID_BASE["13c"])
    _reset_launches()
    rt, srvs, runs, wall = _serve(
        device, model, 8, 1024, clients, seed, max_ticks=400, n_stages=2,
        rt_kw=dict(delivery=DeliveryPolicy()),
        on_servers=lambda rt, srvs: _lossy_links(
            rt, srvs[1].pipe.elements["ssrc"].endpoint, HOP_REQ, HOP_ANS,
            LOSSY_SEEDS["13c"], "s1"))
    launches = {k: fa.LAUNCHES[k] for k in ("flash_attention",
                                            "flash_decode")}
    ecfg = srvs[0].pipe.elements["lm"].cfg
    answers = _check_answers(runs, clients, ecfg.vocab, 8)
    check([a[2:] for a in answers] == [a[2:] for a in serve4["answers"]],
          "13c: the chain's streams or slots under loss != phase 4's "
          "(and 11a's)")
    coord = _coord(rt)
    (hop,) = _stage_batchers(rt, srvs[1:])
    _ledgers_balance(coord, "13c")
    st = coord.stats()
    check(st["hops_failed"] == 0 and st["tokens_dropped"] == 0,
          f"13c: {st['hops_failed']} hops failed all their retransmits")
    check(st["hop_retransmits"] + st["hop_dups"] + st["hop_corrupt"] > 0,
          f"13c: the hop delivery machinery never acted: {st}")
    # a hop is served once however often it crossed the link: one decode
    # hop a decode tick, no replay step, one stage prefill a stream
    check(hop.decode_hops == coord.decode_ticks and hop.replay_steps == 0
          and hop.prefills == coord.prefills,
          f"13c: the stage served {hop.decode_hops} decode hops, "
          f"{hop.replay_steps} replay steps and {hop.prefills} prefills "
          f"for {coord.decode_ticks} decode ticks and {coord.prefills} "
          f"streams")
    check(launches == twin_launches,
          f"13c: launches {launches} != the fault-free chain's "
          f"{twin_launches}")
    rt.fabric.assert_conservation()
    d = rt.stats()["delivery"]
    fired = _fired(rt.fabric)
    row = dict(ticks=rt.ticks, wall_s=wall, launches=launches, fired=fired,
               delivery=d, hop_retransmits=st["hop_retransmits"],
               hop_dups=st["hop_dups"], hop_corrupt=st["hop_corrupt"],
               decode_hops=hop.decode_hops, stage_prefills=hop.prefills,
               ledgers={k: coord.stage_ledger(k)
                        for k in range(1, coord.n_stages)})
    print(f"phase 13c staged stablelm-1.6b over 2 stages, stage-1 hop link "
          f"lossy (requests dup/corrupt/drop {HOP_REQ['dup']}/"
          f"{HOP_REQ['corrupt']}/{HOP_REQ['drop']}, answers dup "
          f"{HOP_ANS['dup']}): {len(answers)} streams bitwise phase 4's and "
          f"11a's in the same slots, {rt.ticks} ticks; hop retransmits "
          f"{st['hop_retransmits']}, dups {st['hop_dups']}, corrupt "
          f"{st['hop_corrupt']}; faults fired {fired}; delivery {d}; the "
          f"stage served {hop.decode_hops} decode hops for "
          f"{coord.decode_ticks} ticks; ledgers {row['ledgers']}; launches "
          f"{launches} == the fault-free chain's")
    del rt, srvs, runs, coord, hop
    gc.collect()
    return row


def _phase_edge_card(seed, device=None):
    """13e: numpy-only edge clients against port pipelines on the card."""
    import torch
    from repro_torch.core import parse_launch
    from repro_torch.core.netfault import DeliveryPolicy
    from repro_torch.device import make_generator
    from repro_torch.edge import EdgeQueryClient, EdgeSensor
    from repro_torch.runtime import Device, Runtime
    rng = np.random.default_rng(seed + 13)
    frames = [rng.standard_normal((1, OFFLOAD_L, OFFLOAD_D))
              .astype(np.float32) for _ in range(3)]
    rt = Runtime(device=device, delivery=DeliveryPolicy())
    sensor = EdgeSensor(rt.broker, "sensor/act")
    sub = Device("sub", device=device)
    run = sub.add_pipeline(parse_launch(
        "mqttsrc sub-topic=sensor/# ! appsink name=o"))
    rt.add_device(sub)
    for i, x in enumerate(frames):
        sensor.publish([x], pts=1000 * i)
        rt.tick()
    got = run.sink_log.get("o", [])
    check(len(got) == len(frames), f"13e: {len(got)} sensor frames arrived")
    for x, b in zip(frames, got):
        t = b.tensors[0]
        check(isinstance(t, torch.Tensor) and t.device.type ==
              rt.device.type,
              f"13e: a sensor frame is not on {rt.device}")
        check(np.array_equal(t.cpu().numpy(), x),
              "13e: a sensor frame changed on its way")
    hub = Device("hub", device=device)
    ps = parse_launch("tensor_query_serversrc operation=edge name=ssrc ! "
                      "tensor_filter model=offload-gate ! "
                      "tensor_query_serversink name=ssink")
    ps.elements["ssink"].pair_with(ps.elements["ssrc"])
    srv = hub.add_pipeline(ps, generator=make_generator(seed, rt.device))
    rt.add_device(hub)
    client = EdgeQueryClient(rt.broker, "edge")
    params = srv.params[next(iter(srv.params))]
    apply = _register_offload_models(seed)
    for x in frames:
        out = client.infer([x])
        check(isinstance(out[0], np.ndarray), "13e: infer returned no numpy")
        want = apply(params, torch.from_numpy(x).to(rt.device)).cpu().numpy()
        check(np.array_equal(out[0], want),
              "13e: an edge answer != the model on the card")
    d = rt.stats()["delivery"]
    check(d["accepted"] == len(frames),
          f"13e: the guard saw {d['accepted']} edge requests")
    print(f"phase 13e edge: {len(frames)} numpy sensor frames f32 [1, "
          f"{OFFLOAD_L}, {OFFLOAD_D}] reached a subscriber pipeline on "
          f"{rt.device} unchanged; {len(frames)} EdgeQueryClient round "
          f"trips through a server there (delivery on: unstamped, "
          f"{d['accepted']} accepted) == the model, bitwise")
    return dict(frames=len(frames), delivery=d)


def phase_lossy(seed, serve4, answers6, staged):
    """13: the lossy network and effectively-once delivery on the card."""
    import dataclasses as dc
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.launch import model_serve as ms
    cfg = dc.replace(stablelm_1_6b.config(), use_flash_attn=True)
    ms.register_serve_model("stablelm-1.6b-flash", lambda: cfg)
    rows = {"13d": _phase_clean_overhead(seed, serve4)}
    rows["13a"] = _phase_lossy_serve(seed, serve4, rows["13d"]["off2"])
    rows["13b"] = _phase_lossy_offload(seed, answers6)
    rows["13c"] = _phase_lossy_staged(seed, serve4,
                                      staged["11a N=2"]["launches"])
    rows["13e"] = _phase_edge_card(seed)
    counts = {}
    for key in ("13a", "13b", "13c", "13d"):
        for k, v in rows[key]["launches"].items():
            counts[k] = counts.get(k, 0) + v
    rows["launches"] = counts
    return rows


# ---------------------------------------------------------------------------
# phase 14: the attention and MoE decoder zoo
# ---------------------------------------------------------------------------

#: 14a's prompt lengths: these, each serve phase's longest prompt and
#: that rounded up to a power of two
ZOO_K5_L = (128, 512, 1024)
#: 14b–14e: serve preset, max_seq and the prompt lengths' range
ZOO_SERVE = {
    "14b": ("granite-20b-flash", 1024, (128, 513)),
    "14c": ("gemma3-4b-flash", 4096, (128, 2001)),
    "14d": ("mixtral-8x22b-8l", 1024, (128, 513)),
    "14e": ("deepseek-v2-236b-4l", 1024, (128, 513)),
}
#: 14f: the card against the port's CPU path, fp32 logits within this
#: share of the largest |logit| (f32 sums in another order on each: sound
#: runs read 8.7e-7 to 2.8e-6 on an H100); each case's TF32 control run
#: must read more than this, or the limit could not see a lower precision
ZOO_CPU_TOL = 3e-5
ZOO_SMOKE = ("qwen1.5-smoke", "granite-smoke", "gemma3-smoke",
             "mixtral-smoke", "deepseek-smoke", "internvl2-smoke",
             "granite-int8kv-smoke")


def _flash_layers(cfg):
    """-> how many of ``cfg``'s layers run K5/K6 (its global layers, when
    the flash gate is on and attention is not MLA)."""
    if not cfg.use_flash_attn or cfg.mla:
        return 0
    return sum(cfg.kind(i) == "G" for i in range(cfg.n_layers))


def _norm_rope_per_forward(cfg):
    """-> (S4, S5) launches of one prefill or one decode tick of ``cfg``'s
    decoder: a norm before each mixer and before each MLP (an SSD block
    has none), one before the head; an MLA layer adds its latent's norm
    (and its query's, under ``q_lora_rank``) and rotates its query and key
    parts apart, every other attention layer its q and k in one S5."""
    from repro_torch.kernels.rotary import rotated_dims
    norms, rotary = 1, 0
    rot = int(rotated_dims(cfg.resolved_head_dim, cfg.rope_frac) > 0)
    for i in range(cfg.n_layers):
        kind = cfg.kind(i)
        norms += 1 if kind == "S" else 2
        if kind in ("S", "R"):
            continue
        if cfg.mla:
            norms += 1 + bool(cfg.q_lora_rank)
            rotary += 2
        else:
            rotary += rot
    return norms, rotary


def _check_norm_rope(tag, cfg, qb, launches, eager):
    """S4/S5 launches of a serve run: :func:`_norm_rope_per_forward` a
    prefill and a decode tick, and no eager norm or rotary on the card
    (``eager``: ``layers.EAGER_ON_CARD`` before the run) -> the counts."""
    from repro_torch.models import layers
    per = _norm_rope_per_forward(cfg)
    forwards = qb["prefills"] + qb["decode_ticks"]
    got = {k: launches[k] for k in ("norm", "rotary")}
    want = {"norm": per[0] * forwards, "rotary": per[1] * forwards}
    check(got == want, f"{tag}: S4/S5 launches {got}, expected {want} "
                       f"({per} a prefill or decode tick)")
    check(layers.EAGER_ON_CARD == eager,
          f"{tag}: the eager norm or rotary ran on the card: "
          f"{layers.EAGER_ON_CARD} (before the run {eager})")
    return got


def _zoo_kernel_shapes():
    """14a's K5 and K6 tables (see K5_FULL), from the serve phases that run
    K5/K6: K5 at each head count, kv groups and head dim at the lengths
    ZOO_K5_L, the phase's longest prompt and that rounded up to a power of
    two; K6 over the phase's serve cache (8 slots, its max_seq)."""
    from repro_torch.launch import model_serve as ms
    k5, k6 = {}, {}
    for preset, max_seq, (_, hi) in ZOO_SERVE.values():
        cfg = ms.SERVE_MODELS[preset]()
        if not _flash_layers(cfg):
            continue
        model = preset.removesuffix("-flash")
        h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        longest = hi - 1
        lengths = sorted({*ZOO_K5_L, longest,
                          1 << (longest - 1).bit_length()})
        for dtype, tag in (("bfloat16", "bf16"), ("float32", "fp32")):
            for L in lengths:
                k5[f"K5 {tag} d={d} L={L}"] = (h, h // kv, d, L, dtype, model)
            k6[f"K6 {tag} d={d} S=8 max_seq={max_seq}"] = (
                8, h, kv, d, max_seq, dtype, model)
    return k5, k6


def _phase_zoo_kernels(seed, ptxas):
    """14a: K5 and K6 at head dims 128 and 256 on each route, at the
    shapes granite-20b's and gemma3-4b's serve phases give them, against
    their plain versions; times beside SDPA's and the bounds."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed + 14)
    return _kernel_rows("14a", *_zoo_kernel_shapes(), g,
                        np.random.default_rng(seed + 14), ptxas)


#: 14g: S4 at granite-20b's prefill and decode norms (a 1774-token mean
#: prompt, 64 slots) and stablelm-1.6b's prefill norm (LayerNorm), as
#: (rows, d, layernorm); S5 at the same steps' q and k, as (batch, seq, q
#: heads, k heads, head dim, arch or serve preset), and at the rope parts
#: of DeepSeek-V2's MLA in the ``deepseek-v2-236b-ep8`` preset (YaRN's
#: frequency table; q_rope and k_rope rotate in launches of their own, k
#: heads 0: a 1020-token prompt and the 128-slot decode tick)
NORM_SHAPES = {"granite prefill": (1774, 6144, False),
               "granite decode": (64, 6144, False),
               "stablelm prefill": (1020, 2048, True)}
_EP8 = "deepseek-v2-236b-ep8"
ROTARY_SHAPES = {"granite prefill": (1, 1774, 48, 1, 128, "granite-20b"),
                 "granite decode": (64, 1, 48, 1, 128, "granite-20b"),
                 "stablelm prefill": (1, 1020, 32, 32, 64, "stablelm-1.6b"),
                 "mla q_rope prefill": (1, 1020, 128, 0, 64, _EP8),
                 "mla k_rope prefill": (1, 1020, 1, 0, 64, _EP8),
                 "mla q_rope decode": (128, 1, 128, 0, 64, _EP8),
                 "mla k_rope decode": (128, 1, 1, 0, 64, _EP8)}


def _norm_ulps(a, b, bias=None):
    """Largest |a - b| in bf16 last places of b, or with a LayerNorm's
    ``bias`` of |b| + |bias| (where the normalised term and the bias
    cancel, the statistics' f32 rounding is many last places of a
    near-zero output, though under one of the terms that were added)."""
    import torch
    m = b.float().abs() if bias is None else b.float().abs() + bias.abs()
    step = torch.ldexp(torch.ones_like(m), torch.frexp(m)[1] - 8)
    return ((a.float() - b.float()).abs() / step).max().item()


def _norm_row(rng, n, d, ln, ptxas, device="cuda"):
    """S4 at [n, d] bf16 against its plain version (within one bf16 ulp),
    rows alone == in the batch bitwise; timed beside the plain version,
    PyTorch's ``rms_norm``/``layer_norm`` on the same f32 scale and bias
    (its last places and whether its rows depend on the batch, measured)
    and with bf16 weights, the bounds and ptxas."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import norm as kn
    x = (torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32)) * 2
         + 0.3).to(device, torch.bfloat16)
    scale = torch.as_tensor(1 + 0.1 * rng.standard_normal(d).astype(
        np.float32), device=device)
    bias = torch.as_tensor(0.5 * rng.standard_normal(d).astype(np.float32),
                           device=device) if ln else None
    y, want = kn.norm(x, scale, bias), ref.norm_plain(x, scale, bias)
    ulps = _norm_ulps(y, want, bias)
    err = (y.float() - want.float()).abs().max().item()
    what = f"S4 {'LayerNorm' if ln else 'RMSNorm'} [{n}, {d}]"
    check(ulps <= 1.0, f"{what}: {ulps:.2f} bf16 ulps off its plain version")
    cuts = ((0, 1), (n // 3, n // 3 + 5), (n - 1, n))
    for lo, hi in cuts:
        same_bits(kn.norm(x[lo:hi], scale, bias), y[lo:hi],
                  f"{what} rows {lo}:{hi} alone vs in the batch")

    def library(rows, w, b):
        return F.layer_norm(rows, (d,), w, b, 1e-5) if ln else \
            F.rms_norm(rows, (d,), w, 1e-6)
    w16, b16 = scale.to(x.dtype), None if bias is None else bias.to(x.dtype)
    vec = d % 8 == 0
    need = -(-(d // 8 if vec else d) // 256)
    vpt = next((v for v in (1, 2, 3, 4) if need <= v), 8)
    row = dict(
        x=[n, d], dtype="bfloat16", layernorm=ln, ulps=ulps,
        max_abs_err=err,
        ms=cuda_ms(lambda: kn.norm(x, scale, bias)),
        plain_ms=cuda_ms(lambda: ref.norm_plain(x, scale, bias)),
        library="torch.nn.functional." + ("layer_norm" if ln else "rms_norm")
        + ", f32 weights", library_ms=None,
        ptxas=_ptxas_regs(ptxas, "norm", "norm_rows_kernel", "bf16",
                          f"VEC={8 if vec else 1}", f"VPT={vpt}"),
        **cost.bound(cost.norm(n, d, x.dtype, ln)))
    # PyTorch's norm on the port's f32 weights: it may refuse them, or fall
    # back from its fused kernel with a warning; both are recorded
    with warnings.catch_warnings(record=True) as said:
        warnings.simplefilter("always")
        try:
            lib_y = library(x, scale, bias)
        except RuntimeError as e:
            lib_y, row["library_refused"] = None, str(e)
    if said:
        row["library_warning"] = str(said[0].message)
    if lib_y is not None:
        row.update(
            library_ms=cuda_ms(lambda: library(x, scale, bias)),
            library_ulps=_norm_ulps(lib_y, want, bias),
            library_rows_alone_bitwise=all(
                torch.equal(library(x[lo:hi], scale, bias), lib_y[lo:hi])
                for lo, hi in cuts))
    row["library_bf16_weights_ms"] = cuda_ms(lambda: library(x, w16, b16))
    return row


def _rotary_row(rng, b, s, hq, hk, hd, arch, ptxas, device="cuda"):
    """S5 on a layer's q [b, s, hq, hd] and k [b, s, hk, hd], or on q alone
    where ``hk`` is 0 (bf16, the arch's rope_frac and theta, or an MLA
    preset's rope part whole at its YaRN table, on the strided views the
    model rotates; positions 0..s-1, or drawn up to 8191 for a decode row)
    bitwise its plain version on each, in one launch; timed beside the
    plain version, the bounds and ptxas.  No single PyTorch call computes
    it, so it has no library time."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import rotary as kr
    from repro_torch.launch.model_serve import SERVE_MODELS
    from repro_torch.models.mla import yarn_freqs
    cfg = SERVE_MODELS[arch]() if arch in SERVE_MODELS else get_config(arch)
    frac = 1.0 if cfg.mla else cfg.rope_frac
    freqs = yarn_freqs(cfg, device) if cfg.mla else None

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32)).to(device, torch.bfloat16)
    q, k = randn(b, s, hq, hd), (randn(b, s, hk, hd) if hk else None)
    if cfg.mla:
        # the views MLA rotates: q's rope part after each head's nope dims,
        # the shared k_rope after the latent in the down-projection's row
        lead = cfg.qk_nope_dim if hq > 1 else cfg.kv_lora_rank
        q = randn(b, s, hq, lead + hd)[..., lead:] if hq > 1 else \
            randn(b, s, lead + hd)[..., None, lead:]
    pos = torch.arange(s, dtype=torch.int32, device=device)[None] if s > 1 \
        else torch.as_tensor(rng.integers(0, 8192, (b, 1)).astype(np.int32),
                             device=device)
    rope = (pos, frac, cfg.rope_theta, freqs)
    launched = kr.LAUNCHES["rotary"]
    got = kr.rotary(q, k, *rope)
    launches = kr.LAUNCHES["rotary"] - launched
    check(launches == (device == "cuda"),
          f"S5 {arch} {list(q.shape)}: {launches} launches on {device}")
    for t, out, name in ((q, got[0], "q"), (k, got[1], "k")):
        if t is not None:
            same_bits(out, ref.rotary_plain(t, *rope),
                      f"S5 {arch} {name} {list(t.shape)}")
    rot = kr.rotated_dims(hd, frac)
    return dict(
        q=[b, s, hq, hd], k=[b, s, hk, hd] if hk else None, rot=rot,
        dtype="bfloat16", freqs="yarn" if freqs is not None else "theta",
        strides=list(q.stride()),
        launches=launches, bitwise=True, max_abs_err=0.0,
        ms=cuda_ms(lambda: kr.rotary(q, k, *rope)),
        plain_ms=cuda_ms(lambda: [ref.rotary_plain(t, *rope)
                                  for t in (q, k) if t is not None]),
        library_ms=None,
        ptxas=_ptxas_regs(ptxas, "rotary", "rotary_kernel", "bf16", "VEC=8",
                          "pos=int32"),
        **cost.bound(cost.rotary(b, s, hq + hk, hd, rot, q.dtype,
                                 2 if hk else 1)))


def _phase_norm_rope_kernels(seed, ptxas, device="cuda"):
    """14g: S4 and S5, the model step's norm and rotary kernels, at the
    shapes granite-20b's and stablelm-1.6b's serve steps give them
    (NORM_SHAPES, ROTARY_SHAPES): S5 bitwise its plain version, S4 within
    one bf16 ulp of it with rows independent of the batch; each timed
    beside its plain version (the eager expression it replaced), S4 beside
    PyTorch's own norm, and the bounds.  ``device="cpu"`` rehearses the
    phase on the plain routes."""
    rng = np.random.default_rng(seed + 147)
    rows = {}
    for name, shape in NORM_SHAPES.items():
        rows[f"S4 {name}"] = _norm_row(rng, *shape, ptxas, device)
    for name, shape in ROTARY_SHAPES.items():
        rows[f"S5 {name}"] = _rotary_row(rng, *shape, ptxas, device)
    for name, r in rows.items():
        if name.startswith("S5"):
            what = (f"rot {r['rot']} of {r['q'][-1]} at the {r['freqs']} "
                    f"frequencies, {r['launches']} launch, bitwise")
        else:
            lib = f"refused ({r['library_refused']})" \
                if r["library_ms"] is None else \
                (f"{r['library_ms']:.4f} ms, {r['library_ulps']:.2f} ulps, "
                 f"rows alone "
                 f"{'==' if r['library_rows_alone_bitwise'] else '!='} in "
                 f"the batch" + (" (not fused: PyTorch's warning)"
                                 if "library_warning" in r else ""))
            what = (f"{r['ulps']:.2f} ulps; {r['library']} {lib}; on bf16 "
                    f"weights {r['library_bf16_weights_ms']:.4f} ms")
        print(f"phase 14g {name} {r.get('x') or [r['q'], r['k']]}: kernel "
              f"{r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.0%} of the "
              f"{r['bound_by']} bound {r['bound_ms']:.5f} ms), plain "
              f"{r['plain_ms']:.4f} ms; {what}; ptxas {r['ptxas']}")
    return rows


def _zoo_clients(seed, vocab, prompt_range):
    """Phase 4's client schedule (8 clients joining 2 ticks apart, 12
    streams) with prompts drawn from ``prompt_range``."""
    rng = np.random.default_rng(seed + 14)
    clients = []
    for i in range(8):
        n_req = 2 if i < 4 else 1
        prompts = [rng.integers(0, vocab, int(rng.integers(*prompt_range)))
                   .tolist() for _ in range(n_req)]
        gens = [int(rng.integers(16, 65)) for _ in range(n_req)]
        clients.append((2 * i, prompts, gens))
    return clients


#: 14b–14e's profiled prefill length and decode position (gemma3's past
#: its 1024 window, so the local layers read a full ring)
ZOO_PROFILE_AT = {"14b": 512, "14c": 1500, "14d": 512, "14e": 512,
                  "15c": 512}


def _zoo_profile(tag, elem, params, cfg, seed):
    """One prefill and one eager decode tick with all 8 slots active,
    under the profiler: host wall, device busy and the top kernels (the
    graphed tick replays the same kernels without the host's launches)."""
    import torch
    from repro_torch.core.buffers import tree_flatten
    from repro_torch.models import transformer
    n = ZOO_PROFILE_AT[tag]
    prompt = np.random.default_rng(seed + 16).integers(0, cfg.vocab, n)
    res = {f"prefill L={n}": _profile(lambda: elem.host_prefill(params,
                                                                prompt))}
    _, c1 = elem.host_prefill(params, prompt)
    cache = transformer.cache_init(cfg, 8, elem.max_seq)
    for d, s_ in zip(tree_flatten(cache["layers"])[0],
                     tree_flatten(c1["layers"])[0]):
        d.copy_(s_.expand_as(d))
    del c1
    token = torch.zeros(8, dtype=torch.int32, device="cuda")
    active = torch.ones(8, dtype=torch.bool, device="cuda")

    def tick():
        cache["pos"].fill_(n)
        transformer.serve_decode_step(params, cfg, cache, token, active)
    res["decode tick S=8"] = _profile(tick)
    out = {}
    for name, (wall, busy, rows) in res.items():
        top = ", ".join(f"{k[:48]} {ms_:.3f} ms x{c}" for k, ms_, c in
                        rows[:8])
        print(f"phase {tag} profile {name}: host wall {wall:.2f} ms, device "
              f"busy {busy:.2f} ms ({100 * busy / wall:.0f}%); top: {top}")
        out[name] = {"wall_ms": wall, "device_ms": busy,
                     "top": [list(r) for r in rows[:15]]}
    del cache
    return out


def _free_card():
    import torch
    from repro_torch.core import clear_executable_cache
    clear_executable_cache()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _phase_zoo_serve(tag, seed):
    """14b–14e and 15c: one zoo preset at full width behind
    ``serve_pipeline`` (slots 8), 12 streams; every answer bitwise
    ``sequential_decode`` in its slot; K5/K6 launches by head dim, S2/S3
    once per SSD layer per prefill / decode tick; MoE drops by the prefill
    and 0 at decode."""
    import torch
    from repro_torch.core.buffers import tree_flatten
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.launch import model_serve as ms
    from repro_torch.models import layers
    from repro_torch.models import moe as MOE
    preset, max_seq, prange = {**ZOO_SERVE, **SSD_SERVE}[tag]
    cfg = ms.SERVE_MODELS[preset]()
    clients = _zoo_clients(seed, cfg.vocab, prange)
    _free_card()
    _reset_launches()
    eager = dict(layers.EAGER_ON_CARD)
    mark = _graph_mark()
    t0 = time.perf_counter()
    rt, srv, runs, wall = _serve(None, preset, 8, max_seq, clients, seed,
                                 max_ticks=800)
    graph = _graph_since(mark)
    launches = _launch_counts()
    by_dim = {k: v for k, v in fa.HEAD_DIM_LAUNCHES.items() if v}
    by_kernel = {k: v for k, v in fa.KERNEL_LAUNCHES.items() if v}
    answers = _check_answers(runs, clients, cfg.vocab, 8)
    qb = rt.stats()["query_batching"]
    check(qb["tokens_generated"] == qb["tokens_delivered"] +
          qb["tokens_dropped"] + qb["tokens_in_flight"],
          f"{tag} token conservation broken: {qb}")
    n_flash = _flash_layers(cfg)
    d = cfg.resolved_head_dim
    want = {f"flash_attention/{d}": n_flash * qb["prefills"],
            f"flash_decode/{d}": n_flash * qb["decode_ticks"]} \
        if n_flash else {}
    check(by_dim == want, f"{tag} {preset}: K5/K6 launches by head dim "
                          f"{by_dim}, expected {want}")
    want = {}
    if n_flash:
        dt = getattr(torch, cfg.dtype)
        k6 = fa.decode_kernel(dt, d, cfg.n_heads // cfg.n_kv_heads)
        want = {f"flash_attention/{fa.prefill_kernel(dt, d)}/{d}":
                n_flash * qb["prefills"],
                f"flash_decode/{k6}/{d}": n_flash * qb["decode_ticks"]}
    check(by_kernel == want, f"{tag} {preset}: K5/K6 launches by kernel "
                             f"{by_kernel}, expected {want}")
    n_ssd = _ssd_layers(cfg)
    ssd = {k: launches[k] for k in ("ssd_state_scan", "ssd_decode")}
    want = {"ssd_state_scan": n_ssd * qb["prefills"],
            "ssd_decode": n_ssd * qb["decode_ticks"]}
    check(ssd == want, f"{tag} {preset}: S2/S3 launches {ssd}, expected "
                       f"{want}")
    norm_rope = _check_norm_rope(f"{tag} {preset}", cfg, qb, launches, eager)
    params, ecfg = srv.params["lm"], srv.pipe.elements["lm"].cfg
    weight_gb = sum(t.numel() * t.element_size()
                    for t in tree_flatten(params)[0]) / 1e9
    ticks_ms = sorted(1e3 * x for x in _serve_batcher(rt).decode_times)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    row = dict(preset=preset, layers=cfg.n_layers, d_model=cfg.d_model,
               head_dim=d, max_seq=max_seq, ticks=rt.ticks, wall_s=wall,
               prefills=qb["prefills"], decode_ticks=qb["decode_ticks"],
               tokens=qb["tokens_generated"],
               prefill_ms_per_request=1e3 * qb["prefill_seconds"] /
               qb["prefills"],
               decode_ms_per_tick=1e3 * qb["decode_seconds"] /
               qb["decode_ticks"],
               mean_active_slots=qb["batched_frames"] / qb["decode_ticks"],
               tokens_per_s=qb["tokens_generated"] / wall,
               decode_ms_min_median_max=[ticks_ms[0],
                                         ticks_ms[len(ticks_ms) // 2],
                                         ticks_ms[-1]],
               weight_gb=weight_gb, peak_gib=peak_gib, launches=launches,
               launches_by_head_dim=by_dim, launches_by_kernel=by_kernel,
               prompt_lengths=[len(a[0]) for a in answers], **graph)
    mixer = f"head dim {d}" if not n_ssd else \
        f"{n_ssd} SSD layers of state {cfg.ssm_state}"
    print(f"phase {tag} serve {preset} ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {mixer}, {cfg.dtype}) slots 8 max_seq "
          f"{max_seq}: "
          f"{len(answers)} answers in {rt.ticks} ticks, {wall:.2f} s; "
          f"prefill {row['prefill_ms_per_request']:.2f} ms/request, decode "
          f"{row['decode_ms_per_tick']:.2f} ms/tick (mean; graphed ticks "
          f"min/median/max {ticks_ms[0]:.2f}/{ticks_ms[len(ticks_ms) // 2]:.2f}"
          f"/{ticks_ms[-1]:.2f}; mean {row['mean_active_slots']:.2f} active "
          f"slots), "
          f"{row['tokens_per_s']:.1f} tokens/s; weights {weight_gb:.2f} GB,"
          f" peak {peak_gib:.2f} GiB; {graph['graphs']} graphs; K5/K6 "
          f"launches by head dim {by_dim}, by kernel {by_kernel}" +
          (f"; S2/S3 launches {ssd}" if n_ssd else "") +
          f"; S4/S5 launches {norm_rope}, eager on the card 0")
    row["profile"] = _zoo_profile(tag, srv.pipe.elements["lm"], params, ecfg,
                                  seed)
    drops = []
    decode_drops = 0
    for prompt, gen, got, slot in answers:
        with MOE.drop_log() as log:
            ref = ms.sequential_decode(params, ecfg, prompt, gen, max_seq,
                                       slots=8, slot=slot)
        check(got == ref, f"{tag}: continuous != sequential for a "
                          f"{len(prompt)}-token prompt in slot {slot}")
        if ecfg.n_experts:
            drops.append(sum(int(n) for r, _, n in log if not r))
            decode_drops += sum(int(n) for r, _, n in log if r)
    if ecfg.n_experts:
        check(decode_drops == 0, f"{tag}: {decode_drops} (token, expert) "
                                 f"choices dropped at decode")
        row["prefill_drops"] = drops
        row["decode_drops"] = decode_drops
    print(f"phase {tag} continuous == sequential decode: {len(answers)} "
          f"streams bitwise in their slots"
          + (f"; (token, expert) choices dropped by capacity in each "
             f"prefill {drops}, at decode {decode_drops}"
             if ecfg.n_experts else ""))
    row["phase_s"] = time.perf_counter() - t0
    del rt, srv, runs, params
    _free_card()
    return row


def _zoo_vs_cpu(name, cfg, seed, batch, steps, tol, device="cuda",
                stacked=False):
    """One fp32 model on the card and on the CPU (the card's weights
    copied over): prefill and ``steps`` teacher-forced decode steps (the
    card's greedy tokens, fed to both), logits within ``tol`` of the
    largest |logit| (``tol=None``: measured only); ``stacked``: in the
    stacked layout.  -> the worst share."""
    import torch
    from repro_torch.device import make_generator
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tt
    m = build_model(cfg)
    dev = torch.device(device)
    init = m.init_stacked if stacked else m.init
    prefill = m.prefill_stacked if stacked else m.prefill
    decode = m.decode_step_stacked if stacked else m.decode_step
    params = init(make_generator(seed, dev), dev)
    cpu_params = tt.params_from_numpy(_to_numpy(params), cfg, "cpu")
    gpu_b = {k: v.to(dev) for k, v in batch.items()}
    max_seq = batch["tokens"].shape[1] + cfg.n_patches + steps + 1
    worst = 0.0
    lg, cg = prefill(params, gpu_b, max_seq)
    lc, cc = prefill(cpu_params, batch, max_seq)
    for step in range(steps + 1):
        scale = lc.abs().max().item() + 1e-6
        err = (lg.cpu() - lc).abs().max().item() / scale
        check(tol is None or err <= tol, f"14f {name}: card vs CPU logits "
                                         f"differ by {err:.2e} of the "
                                         f"largest at step {step}")
        worst = max(worst, err)
        if step == steps:
            break
        tok = torch.argmax(lg, -1).to(torch.int32)
        lg, cg = decode(params, tok, cg)
        lc, cc = decode(cpu_params, tok.cpu(), cc)
    del params, cpu_params, cg, cc
    return worst


def _phase_zoo_cpu(seed):
    """14f: fp32 on the card == the port's CPU path: every zoo smoke
    preset (internvl2 through Model.prefill with patches, the int8 KV
    cache), granite-20b at 2 layers and gemma3-4b at 6 (LLLLLG), fp32 at
    full width, so K5/K6 fp32 at 128 and 256 run on a model path.  Then
    each case again with TF32 on in the card's matmuls, as a control that
    the limit sees a lower precision."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.launch import model_serve as ms
    _free_card()
    rng = np.random.default_rng(seed + 15)
    _reset_launches()
    cases = [(k, ms.SERVE_MODELS[k](), 12, 4) for k in ZOO_SMOKE]
    cases += [("granite-20b fp32 2 layers", dataclasses.replace(
        get_config("granite-20b"), n_layers=2, dtype="float32",
        use_flash_attn=True), 64, 3),
        ("gemma3-4b fp32 6 layers", dataclasses.replace(
            get_config("gemma3-4b"), n_layers=6, dtype="float32",
            use_flash_attn=True), 64, 3)]
    batches = []
    for name, cfg, seq, steps in cases:
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, (2, seq)).astype(np.int32))}
        if cfg.frontend == "vision":
            batch["patches"] = torch.as_tensor(rng.standard_normal(
                (2, cfg.n_patches, cfg.d_model)).astype(np.float32))
        batches.append(batch)
    out = {}
    for (name, cfg, _, steps), batch in zip(cases, batches):
        out[name] = _zoo_vs_cpu(name, cfg, seed, batch, steps, ZOO_CPU_TOL)
        _free_card()
    by_dim = {k: v for k, v in fa.HEAD_DIM_LAUNCHES.items() if v}
    routes = dict(fa.PREFILL_ROUTE_LAUNCHES)
    launches = dict(fa.LAUNCHES)
    for d in (128, 256):
        check(by_dim.get(f"flash_attention/{d}", 0) > 0 and
              by_dim.get(f"flash_decode/{d}", 0) > 0,
              f"14f: K5/K6 fp32 never ran at head dim {d}: {by_dim}")
    check(routes["sm90"] == 0, f"14f is fp32: K5 routes {routes}")
    # the fp32 kernels at 128 and 256: K5's tiled kernel at both dims, K6's
    # f32 grouped-head kernel at granite's group of 48
    by_kernel = {k: v for k, v in fa.KERNEL_LAUNCHES.items() if v}
    for key in ("flash_attention/scalar_wide/128",
                "flash_attention/scalar_wide/256", "flash_decode/gqa_f32/128"):
        check(by_kernel.get(key, 0) > 0,
              f"14f: {key} never launched: {by_kernel}")
    control = {}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for (name, cfg, _, steps), batch in zip(cases, batches):
            control[name] = _zoo_vs_cpu(name, cfg, seed, batch, steps, None)
            _free_card()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"phase 14f fp32 card == CPU (logits within {ZOO_CPU_TOL:g} of "
          f"the largest; sound / TF32 control): " +
          ", ".join(f"{k} {v:.1e} / {control[k]:.1e}"
                    for k, v in out.items()) +
          f"; K5/K6 launches by head dim {by_dim}, by kernel {by_kernel}")
    for name, v in control.items():
        check(v > ZOO_CPU_TOL, f"14f {name}: the TF32 control reads {v:.2e},"
                               f" inside the limit {ZOO_CPU_TOL:g}")
    return dict(worst=out, tf32_control=control, launches_by_head_dim=by_dim,
                launches_by_kernel=by_kernel, launches=launches)


def phase_zoo(seed, ptxas):
    """Phase 14: the attention and MoE decoder zoo (module docstring)."""
    rows = {}
    t0 = time.perf_counter()
    rows["14a"] = _phase_zoo_kernels(seed, ptxas)
    print(f"phase 14a wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows["14g"] = _phase_norm_rope_kernels(seed, ptxas)
    print(f"phase 14g wall {time.perf_counter() - t0:.1f} s")
    for tag in ZOO_SERVE:
        rows[tag] = _phase_zoo_serve(tag, seed)
        print(f"phase {tag} wall {rows[tag]['phase_s']:.1f} s")
    t0 = time.perf_counter()
    rows["14f"] = _phase_zoo_cpu(seed)
    print(f"phase 14f wall {time.perf_counter() - t0:.1f} s")
    for key in ("launches_by_head_dim", "launches_by_kernel"):
        counts = {}
        for tag in ZOO_SERVE:
            for k, v in rows[tag][key].items():
                counts[k] = counts.get(k, 0) + v
        rows[key] = counts
    # S4/S5 on 14b-14e's serve path, by preset
    rows["launches_norm_rope"] = {
        ZOO_SERVE[tag][0]: {k: rows[tag]["launches"][k]
                            for k in ("norm", "rotary")}
        for tag in ZOO_SERVE}
    return rows


# ---------------------------------------------------------------------------
# phase 15: the rest of the model zoo: Mamba-2 with the SSD kernels S2 and
# S3, launch/serve.py, whisper's encoder-decoder and the stacked layout
# ---------------------------------------------------------------------------

#: 15a's timed shapes: S2 over mamba2-130m's chunk states of a 2048-token
#: prompt [B, nc, H, N, hd], S3 over its 8 serve slots' states [B, H, N, hd]
S2_SHAPE = (1, 16, 24, 128, 64)
S3_SHAPE = (8, 24, 128, 64)
#: 15a's smoke shapes: S2 at nc = 1, ragged N * hd (its 4-byte route), odd
#: chunk counts; S3 at the smoke head dims and a head dim of 256
S2_SMOKE = [(1, 1, 24, 128, 64), (2, 3, 5, 7, 5), (3, 2, 8, 32, 64),
            (2, 17, 4, 16, 16)]
S3_SMOKE = [(3, 8, 32, 64), (2, 4, 16, 16), (1, 2, 5, 256)]
#: 15b: launch/serve.py's runs, (requests, prompt length, generated tokens):
#: examples/serve_e2e.py's shape, then 2048-token prompts (S2 at nc = 16)
MAMBA_LAUNCH = [(8, 32, 16), (8, 2048, 64)]
#: 15c: mamba2-130m behind serve_pipeline, as 14b-14e
SSD_SERVE = {"15c": ("mamba2-130m", 1024, (128, 513))}
#: 15d: whisper-large-v3 at full width, (batch, prompt tokens, decode steps)
WHISPER_RUN = (4, 16, 32)
#: 15e: the stacked layout's families (tests/test_models.py's)
STACKED_FAMILIES = {
    "dense_gqa_bias": dict(
        name="t", arch_type="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=97, qkv_bias=True, layer_pattern="LG",
        window=8, dtype="float32"),
    "mla_moe_shared": dict(
        name="t", arch_type="moe", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=97, mla=True, kv_lora_rank=32,
        q_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        n_experts=4, top_k=2, n_shared_experts=1, d_ff_expert=32,
        first_dense=1, capacity_factor=2.0, dtype="float32"),
    "hybrid_rglru": dict(
        name="t", arch_type="hybrid", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=128, vocab=97, layer_pattern="RRL", window=8,
        lru_width=64, dtype="float32"),
    "ssm_mamba2": dict(
        name="t", arch_type="ssm", n_layers=2, d_model=64, n_heads=0,
        n_kv_heads=0, d_ff=0, vocab=97, layer_pattern="S", ssm_state=16,
        ssm_head_dim=16, ssm_chunk=8, dtype="float32"),
}


def _ssd_layers(cfg):
    return sum(cfg.kind(i) == "S" for i in range(cfg.n_layers))


def _s2_inputs(g, shape, h0=False):
    import torch
    b, nc, h, n, hd = shape
    decay = torch.rand((b, nc, h), generator=g, device="cuda") * 0.8 + 0.2
    states = torch.randn(shape, generator=g, device="cuda")
    return decay, states, (torch.randn((b, h, n, hd), generator=g,
                                       device="cuda") if h0 else None)


def _s3_inputs(g, shape, dtype):
    """S3's arguments as the decode step passes them: B, C and x column
    slices of one conv-output row [B, H * hd + 2N] in the model's dtype."""
    import torch
    b, h, n, hd = shape
    d_inner = h * hd
    row = torch.randn((b, 1, d_inner + 2 * n), generator=g,
                      device="cuda").to(dtype)[:, 0]
    return dict(h=torch.randn(shape, generator=g, device="cuda"),
                dt=torch.rand((b, h), generator=g, device="cuda") * 2 + 0.01,
                A=-(torch.rand((h,), generator=g, device="cuda") * 1.5 + 0.5),
                B=row[:, d_inner:d_inner + n], C=row[:, d_inner + n:],
                x=row[:, :d_inner],
                D=torch.randn((h,), generator=g, device="cuda"))


def _phase_ssd_kernels(seed, ptxas):
    """15a: S2 bitwise and S3 within FP32_TOL of their plain versions on the
    card (smoke shapes, h0 given and absent, f32 and bf16 strided views,
    an active mask, a row alone vs in a batch, a view with another element
    stride refused), then both timed at mamba2-130m's shapes beside their
    byte bounds.  No single PyTorch call computes either, so neither has a
    library time."""
    import torch
    from repro_torch.kernels import cost
    from repro_torch.kernels import ssd_decode as sd
    from repro_torch.kernels import ssd_scan as ss
    g = torch.Generator(device="cuda").manual_seed(seed + 150)
    n = 0
    for shape in S2_SMOKE + [S2_SHAPE]:
        for h0 in (False, True):
            decay, states, init = _s2_inputs(g, shape, h0)
            got = ss.ssd_state_scan(decay, states, init)
            want = ss.ssd_state_scan_plain(decay, states, init)
            same_bits(got[0], want[0], f"S2 h_starts {shape} h0={h0}")
            same_bits(got[1], want[1], f"S2 h_final {shape} h0={h0}")
            n += 1
    decay, states, _ = _s2_inputs(g, (3,) + S2_SHAPE[1:])
    alone = ss.ssd_state_scan(decay[1:2].contiguous(),
                              states[1:2].contiguous())
    batch = ss.ssd_state_scan(decay, states)
    same_bits(alone[0], batch[0][1:2], "S2 row alone vs in a batch of 3")
    worst = 0.0
    for shape in S3_SMOKE + [S3_SHAPE]:
        for dtype in (torch.float32, torch.bfloat16):
            a = _s3_inputs(g, shape, dtype)
            active = torch.rand((shape[0],), generator=g, device="cuda") < 0.7
            for act in (None, active):
                hk, yk = sd.ssd_decode_step(**a, active=act)
                hp, yp = sd.ssd_decode_step_plain(**a, active=act)
                for got, want, what in ((hk, hp, "h'"), (yk, yp, "y")):
                    ex, tol = _excess(got, want)
                    check(ex <= tol, f"S3 {what} {shape} {dtype}: exceeds "
                                     f"atol = rtol = {FP32_TOL:g} by {ex}")
                    worst = max(worst, (got - want).abs().max().item())
                if act is not None:
                    same_bits(hk[~act], a["h"][~act], "S3 inactive rows")
                n += 1
    a = _s3_inputs(g, S3_SHAPE, torch.bfloat16)
    hb, yb = sd.ssd_decode_step(**a)
    one = {k: v if k in ("A", "D") else v[3:4] for k, v in a.items()}
    h1, y1 = sd.ssd_decode_step(**one)
    same_bits(h1, hb[3:4], "S3 h' of a row alone vs in a batch of 8")
    same_bits(y1, yb[3:4], "S3 y of a row alone vs in a batch of 8")
    wide = torch.zeros((S3_SHAPE[0], 2 * S3_SHAPE[2]), dtype=torch.bfloat16,
                       device="cuda")
    try:
        sd.ssd_decode_step(**{**a, "B": wide[:, ::2]})
        check(False, "S3 took a view with element stride 2")
    except ValueError:
        pass

    rows = {}
    decay, states, _ = _s2_inputs(g, S2_SHAPE)
    count = cost.ssd_state_scan(*S2_SHAPE)
    rows["S2"] = dict(
        shape=list(S2_SHAPE), max_abs_err=0.0, bitwise=True,
        ms=cuda_ms(lambda: ss.ssd_state_scan(decay, states)),
        plain_ms=cuda_ms(lambda: ss.ssd_state_scan_plain(decay, states),
                         iters=5, warmup=1),
        library_ms=None, nbytes=count.bytes,
        ptxas=_ptxas_regs(ptxas, "ssd_scan", "ssd_state_scan_kernel",
                          "float4"),
        **cost.bound(count))
    a = _s3_inputs(g, S3_SHAPE, torch.bfloat16)
    hk, yk = sd.ssd_decode_step(**a)
    hp, yp = sd.ssd_decode_step_plain(**a)
    count = cost.ssd_decode(*S3_SHAPE, torch.bfloat16)
    rows["S3"] = dict(
        shape=list(S3_SHAPE), dtype="bfloat16",
        max_abs_err=max((hk - hp).abs().max().item(),
                        (yk - yp).abs().max().item()),
        ms=cuda_ms(lambda: sd.ssd_decode_step(**a)),
        plain_ms=cuda_ms(lambda: sd.ssd_decode_step_plain(**a)),
        library_ms=None, nbytes=count.bytes,
        ptxas=_ptxas_regs(ptxas, "ssd_decode", "ssd_decode_kernel", "bf16"),
        **cost.bound(count))
    for name, r in rows.items():
        print(f"phase 15a {name} {r['shape']}: kernel {r['ms']:.4f} ms "
              f"({r['bound_ms'] / r['ms']:.0%} of the {r['bound_by']} "
              f"bound {r['bound_ms']:.5f} ms, {r['nbytes']} B), plain "
              f"{r['plain_ms']:.4f} ms, max |err| {r['max_abs_err']:.2e}; "
              f"{r['ptxas']}")
    print(f"phase 15a: {n} smoke cases, S2 bitwise its plain loop and S3 "
          f"within atol = rtol = {FP32_TOL:g} (max |err| {worst:.2e}), "
          f"rows alone == in a batch bitwise, inactive rows kept, a view "
          f"with element stride 2 refused")
    return rows


def _phase_mamba_launch(seed):
    """15b: ``launch/serve.py``'s ``LMQueryServer`` with the full
    mamba2-130m, edge clients as its ``main`` makes them, at
    MAMBA_LAUNCH's shapes: the graphed server's answers bitwise its
    ``jit=False`` twin's, S2 once per SSD layer for the batch's prefill and
    S3 once per SSD layer per decode step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import Broker
    from repro_torch.core.buffers import tree_flatten
    from repro_torch.device import make_generator
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    _free_card()
    cfg = get_config("mamba2-130m")
    model = build_model(cfg)
    params = model.init(make_generator(seed, torch.device("cuda")), "cuda")
    weight_gb = sum(t.numel() * t.element_size()
                    for t in tree_flatten(params)[0]) / 1e9
    n_ssd = _ssd_layers(cfg)
    rows, launches = [], {"ssd_state_scan": 0, "ssd_decode": 0}
    for requests, plen, gen in MAMBA_LAUNCH:
        answers, walls = {}, {}
        for jit in (True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            broker = Broker()
            srv = serve.LMQueryServer(model, params, broker, "lm/generate",
                                      max_seq=plen + gen + 1, gen=gen,
                                      jit=jit)
            t0 = time.perf_counter()
            prompts, got = serve.request_all(srv, broker, cfg.vocab,
                                             requests, plen)
            torch.cuda.synchronize()
            walls[jit] = time.perf_counter() - t0
            answers[jit] = torch.stack(got).cpu()
            counts = {k: v for k, v in _launch_counts().items()
                      if k in launches}
            want = {"ssd_state_scan": n_ssd, "ssd_decode": n_ssd * (gen - 1)}
            check(counts == want, f"15b {plen}x{gen} jit={jit}: S2/S3 "
                                  f"launches {counts}, expected {want}")
            if jit:
                graphed = srv
                for k in launches:
                    launches[k] += counts[k]
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(torch.equal(answers[True], answers[False]),
              f"15b {plen}x{gen}: graphed answers != jit=False twin's")
        a = answers[True]
        check(tuple(a.shape) == (requests, gen) and
              bool(((a >= 0) & (a < cfg.vocab)).all()),
              f"15b answers {tuple(a.shape)} outside [0, vocab)")
        batch = {"tokens": torch.as_tensor(np.stack(prompts)).long().cuda()}
        prefill_ms = cuda_ms(lambda: graphed._prefill(params, batch),
                             iters=3, warmup=1)
        logits, cache = graphed._prefill(params, batch)
        tok = torch.argmax(logits, -1).to(torch.int32)
        decode_ms = cuda_ms(lambda: graphed._decode(params, cache, tok),
                            iters=20, warmup=3)
        rows.append(dict(requests=requests, prompt_len=plen, gen=gen,
                         graphed_wall_s=walls[True],
                         eager_wall_s=walls[False],
                         prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
                         tokens_per_s=requests * gen / walls[True],
                         peak_gib=peak))
        print(f"phase 15b launch/serve.py mamba2-130m (24 SSD layers, bf16, "
              f"{weight_gb:.3f} GB of weights) {requests} requests x {plen} "
              f"prompt x {gen} tokens: answers bitwise the jit=False twin's; "
              f"wall {walls[True]:.3f} s graphed (first call eager, second "
              f"captured) / {walls[False]:.3f} s eager, "
              f"{rows[-1]['tokens_per_s']:.1f} tokens/s; prefill "
              f"{prefill_ms:.2f} ms, graphed decode {decode_ms:.3f} ms/step "
              f"(device, back to back); peak {peak:.2f} GiB; S2 {n_ssd} "
              f"launches a prefill, S3 {n_ssd} a step")
        del cache, logits, graphed, srv
    del params
    _free_card()
    return dict(rows=rows, launches=launches, weight_gb=weight_gb)


def _phase_whisper(seed):
    """15d: whisper-large-v3 at full width (32 + 32 layers, bf16, seeded
    random weights and frames) through ``Model.prefill`` and
    ``Model.decode_step``: finite logits of the right shape, per-row
    positions, tokens in the vocabulary; prefill ms, decode ms a step,
    weight GB and peak."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.buffers import tree_flatten
    from repro_torch.device import make_generator
    from repro_torch.models import build_model
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("whisper-large-v3")
    model = build_model(cfg)
    dev = torch.device("cuda")
    g = make_generator(seed + 151, dev)
    params = model.init(make_generator(seed, dev), dev)
    weight_gb = sum(t.numel() * t.element_size()
                    for t in tree_flatten(params)[0]) / 1e9
    b, s, steps = WHISPER_RUN
    batch = {"frames": torch.randn((b, cfg.enc_seq, cfg.d_model),
                                   generator=g, device=dev).to(torch.bfloat16),
             "tokens": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                     device=dev)}
    max_seq = s + steps + 2             # a warm-up step, then ``steps``
    model.prefill(params, batch, max_seq)           # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_seq)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    check(tuple(logits.shape) == (b, cfg.vocab) and
          bool(torch.isfinite(logits).all()), "15d prefill logits")
    tok = torch.argmax(logits, -1).to(torch.int32)
    logits, cache = model.decode_step(params, tok, cache)      # warm
    tok = torch.argmax(logits, -1).to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = model.decode_step(params, tok, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / steps
    check(bool(torch.isfinite(logits).all()), "15d decode logits")
    check(cache["pos"].tolist() == [s + steps + 1] * b,
          f"15d positions {cache['pos'].tolist()}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 15d whisper-large-v3 (32 + 32 layers, d 1280, bf16, "
          f"{weight_gb:.2f} GB of weights) {b} x {cfg.enc_seq} frames, "
          f"{s}-token prompts: prefill {prefill_ms:.1f} ms, decode "
          f"{decode_ms:.2f} ms/step (host, eager, over {steps} steps after a "
          f"warm one), peak "
          f"{peak:.2f} GiB")
    del params, cache, logits
    _free_card()
    return dict(prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
                weight_gb=weight_gb, peak_gib=peak, batch=b, prompt_len=s,
                steps=steps)


def _phase_ssd_cpu(seed):
    """15e: fp32 on the card == the port's CPU path (logits within
    ZOO_CPU_TOL of the largest): mamba2-smoke and whisper's smoke config,
    mamba2-130m at 2 layers and whisper at 2 + 2 layers at full width, and
    the stacked layout of four families.  Then each case with TF32 on in
    the card's matmuls, a control that must read above the limit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_decode as sd
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import model_serve as ms
    from repro_torch.models import ModelConfig
    _free_card()
    rng = np.random.default_rng(seed + 152)
    f32 = dict(dtype="float32")
    cases = [
        ("mamba2-smoke", ms.SERVE_MODELS["mamba2-smoke"](), 40, 4, False),
        ("whisper smoke", get_config("whisper-large-v3").smoke(), 12, 4,
         False),
        ("mamba2-130m fp32 2 layers", dataclasses.replace(
            get_config("mamba2-130m"), n_layers=2, **f32), 300, 3, False),
        ("whisper-large-v3 fp32 2 + 2 layers", dataclasses.replace(
            get_config("whisper-large-v3"), n_layers=2, n_enc_layers=2,
            **f32), 16, 3, False)]
    cases += [(f"{k} stacked", ModelConfig(**kw), 16, 3, True)
              for k, kw in STACKED_FAMILIES.items()]
    batches = []
    for name, cfg, seq, steps, _ in cases:
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, (2, seq)).astype(np.int32))}
        if cfg.enc_dec:
            batch["frames"] = torch.as_tensor(rng.standard_normal(
                (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
        batches.append(batch)
    _reset_launches()
    out = {}
    for (name, cfg, _, steps, stacked), batch in zip(cases, batches):
        out[name] = _zoo_vs_cpu(name, cfg, seed, batch, steps, ZOO_CPU_TOL,
                                stacked=stacked)
        _free_card()
    launches = {"ssd_state_scan": ss.LAUNCHES["ssd_state_scan"],
                "ssd_decode": sd.LAUNCHES["ssd_decode"]}
    check(all(launches.values()), f"15e: S2/S3 never ran: {launches}")
    control = {}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for (name, cfg, _, steps, stacked), batch in zip(cases, batches):
            control[name] = _zoo_vs_cpu(name, cfg, seed, batch, steps, None,
                                        stacked=stacked)
            _free_card()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"phase 15e fp32 card == CPU (logits within {ZOO_CPU_TOL:g} of "
          f"the largest; sound / TF32 control): " +
          ", ".join(f"{k} {v:.1e} / {control[k]:.1e}"
                    for k, v in out.items()) + f"; S2/S3 launches {launches}")
    for name, v in control.items():
        check(v > ZOO_CPU_TOL, f"15e {name}: the TF32 control reads {v:.2e},"
                               f" inside the limit {ZOO_CPU_TOL:g}")
    return dict(worst=out, tf32_control=control, launches=launches)


def phase_ssd(seed, ptxas):
    """Phase 15: Mamba-2, launch/serve.py, whisper and the stacked layout
    (module docstring)."""
    rows = {}
    t0 = time.perf_counter()
    rows["15a"] = _phase_ssd_kernels(seed, ptxas)
    print(f"phase 15a wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows["15b"] = _phase_mamba_launch(seed)
    print(f"phase 15b wall {time.perf_counter() - t0:.1f} s")
    rows["15c"] = _phase_zoo_serve("15c", seed)
    print(f"phase 15c wall {rows['15c']['phase_s']:.1f} s")
    t0 = time.perf_counter()
    rows["15d"] = _phase_whisper(seed)
    print(f"phase 15d wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows["15e"] = _phase_ssd_cpu(seed)
    print(f"phase 15e wall {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 16: training (M13): the AdamW train step through launch/train.py,
# checkpoints and the data pipeline, and the scans' backward kernels
# ---------------------------------------------------------------------------

#: 16a: stablelm-1.6b whole, bf16, stacked layout (the launcher's pick)
TRAIN_LM = dict(arch="stablelm-1.6b", steps=20, batch=8, seq=512)
#: 16b: mamba2-130m whole; a checkpoint at step CKPT_AT, then a resumed run
TRAIN_SSM = dict(arch="mamba2-130m", steps=10, batch=8, seq=2048)
CKPT_AT = 5
#: 16c: recurrentgemma-9b at full width, cut from 38 layers to the first 6
#: (RRLRRL): 38 would need ~108 GB of weights and AdamW state
TRAIN_RG = dict(arch="recurrentgemma-9b", layers=6, steps=5, batch=2,
                seq=2048)
#: 16d: card == CPU for one train step of each smoke preset: sequence
#: length (> the smoke ssm_chunk of 16, so S2 spans 4 chunks) and the
#: tolerance on loss, grad norm, every gradient leaf and m, v: |card - cpu|
#: <= TRAIN_TOL_REL * |cpu| + TRAIN_TOL_LEAF * max|cpu leaf|
TRAIN_CPU_SEQ = 64
TRAIN_TOL_REL = 1e-4
TRAIN_TOL_LEAF = 2e-5
#: 16e: the backward kernels' timed shapes (16c's S1 input, 16b's S2 chunk
#: states) and ragged ones
S1_BWD_SHAPE = (2, 2048, 4096)
S2_BWD_SHAPE = (8, 16, 24, 128, 64)
S2_BWD_SMOKE = [(1, 1, 24, 128, 64), (2, 3, 5, 7, 5), (3, 2, 8, 32, 64)]


def _train_argv(run, **extra):
    """``launch/train.py``'s argv for a run dict (TRAIN_LM, TRAIN_SSM)."""
    return [f"--{k.replace('_', '-')}={v}"
            for k, v in {**run, **extra}.items()]


def _leaves(tree):
    from repro_torch.core.buffers import tree_flatten
    return tree_flatten(tree)[0]


def _train_row(run, batch, seq, model, what):
    """Median step ms over steps 3.. (host clock; each step ends in a host
    read of its loss), tokens/s and the model-FLOP share of the card's
    dense bf16 peak (6 N_active FLOPs a token)."""
    from repro_torch.launch.mesh import H100_BF16_FLOPS
    ms = float(np.median(run.step_s[2:])) * 1e3
    tok_s = batch * seq / ms * 1e3
    mfu = model.model_flops_per_token() * tok_s / H100_BF16_FLOPS
    return dict(what=what, steps=len(run.losses), step_ms_median=ms,
                step_ms=[1e3 * x for x in run.step_s], tokens_per_s=tok_s,
                model_flop_share=mfu, losses=run.losses,
                grad_norms=run.grad_norms)


def _check_trained(run, what, falls=True):
    check(all(np.isfinite(run.losses)) and all(np.isfinite(run.grad_norms)),
          f"{what}: loss or grad norm not finite: {run.losses}")
    if falls:
        first, last = np.mean(run.losses[:5]), np.mean(run.losses[-5:])
        check(last < first, f"{what}: mean loss of the last 5 steps {last:.4f}"
                            f" not below the first 5's {first:.4f}")


def _phase_train_lm(seed):
    """16a: stablelm-1.6b whole (24 layers, bf16) through
    ``launch/train.py`` (``run``, what ``main`` calls) for 20 steps at 8 x
    512: finite losses and grad norms, every parameter leaf moved, the
    mean loss of the last 5 steps below the first 5's; then one more step
    profiled (device time by kernel)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_train_iterator
    from repro_torch.device import make_generator
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train
    from repro_torch.models import build_model, layers
    from repro_torch.optim import adamw_update
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    before = dict(layers.EAGER_ON_CARD)
    run = train.run(_train_argv(TRAIN_LM))
    launches = _launch_counts()
    eager = {k: v - before[k] for k, v in layers.EAGER_ON_CARD.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check_trained(run, "16a")
    cfg = get_config(TRAIN_LM["arch"])
    model = build_model(cfg)
    init = model.init_stacked(make_generator(0, torch.device("cuda")), "cuda")
    moved = [not torch.equal(a, b) for a, b in zip(_leaves(run.params),
                                                   _leaves(init))]
    check(all(moved), f"16a: {moved.count(False)} of {len(moved)} "
                      f"parameter leaves did not move")
    del init
    check(not any(launches.values()), f"16a: a kernel ran where none is on "
                                      f"the path (no flash, no scan, and "
                                      f"S4/S5 have no backward): {launches}")
    check(all(eager.values()), f"16a: the norms and rotary of a train step "
                               f"did not take the eager expression: {eager}")
    row = _train_row(run, TRAIN_LM["batch"], TRAIN_LM["seq"], model, "16a")
    row.update(peak_gib=peak, params=model.param_count(run.params),
               n_active=model.active_param_count(), eager_on_card=eager)
    step = ST.make_train_step(model, total_steps=TRAIN_LM["steps"])
    tokens = next(make_train_iterator(vocab=cfg.vocab,
                                      global_batch=TRAIN_LM["batch"],
                                      seq=TRAIN_LM["seq"]))["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    state = [run.params, run.opt]

    def one_step():
        state[0], state[1], _ = step(state[0], state[1], batch)
    wall, busy, prof = _profile(one_step)
    gemm = sum(v for k, v, _ in prof if re.search(
        r"gemm|xmma|cutlass|cublas|nvjet|sm90_", k))
    row["profile"] = dict(wall_ms=wall, busy_ms=busy, gemm_ms=gemm,
                          idle_share=max(0.0, 1 - busy / wall),
                          top=[(k, v, n) for k, v, n in prof[:12]])
    # the step's two layers on the device: forward + backward, and AdamW
    loss_fn = ST.train_loss_fn(model)
    _, grads = ST.value_and_grad(loss_fn, state[0], batch)
    row["fwd_bwd_ms"] = cuda_ms(lambda: ST.value_and_grad(
        loss_fn, state[0], batch), iters=3, warmup=1)
    row["adamw_ms"] = cuda_ms(lambda: adamw_update(
        state[0], grads, state[1], lr=1e-6), iters=3, warmup=1)
    del grads
    print(f"phase 16a train stablelm-1.6b (24 layers, bf16, stacked, "
          f"{row['params'] / 1e9:.3f} B params) {TRAIN_LM['steps']} steps x "
          f"{TRAIN_LM['batch']} x {TRAIN_LM['seq']} through launch/train.py:"
          f" loss {run.losses[0]:.4f} -> {run.losses[-1]:.4f} (mean of "
          f"first/last 5: {np.mean(run.losses[:5]):.4f} / "
          f"{np.mean(run.losses[-5:]):.4f}), grad norm "
          f"{run.grad_norms[0]:.3f} -> {run.grad_norms[-1]:.3f}; median "
          f"{row['step_ms_median']:.1f} ms/step (steps 3-20, host clock), "
          f"{row['tokens_per_s']:.0f} tokens/s, model-FLOP share "
          f"{row['model_flop_share']:.1%} of 989 TFLOP/s dense bf16 (6 N "
          f"with N = {row['n_active'] / 1e9:.3f} B), peak {peak:.2f} GiB; "
          f"eager norm / rotary calls on the card (S4/S5 have no backward) "
          f"{eager['norm']} / {eager['rotary']}, "
          f"{eager['norm'] / TRAIN_LM['steps']:.0f} / "
          f"{eager['rotary'] / TRAIN_LM['steps']:.0f} a step")
    print(f"phase 16a profiled step: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms (idle {row['profile']['idle_share']:.1%}, GEMMs "
          f"{gemm:.1f} ms); forward + backward {row['fwd_bwd_ms']:.1f} ms "
          f"and AdamW {row['adamw_ms']:.1f} ms (device, back to back); top: "
          + "; ".join(f"{k[:60]} {v:.2f} ms x{n}" for k, v, n in prof[:8]))
    del run, state
    _free_card()
    return row


def _phase_train_ssm(seed):
    """16b: mamba2-130m whole (24 SSD layers, bf16) through
    ``launch/train.py`` at 8 x 2048 (nc = 16): 5 steps with a checkpoint
    at step 5, every restored leaf bitwise the in-memory state; then a run
    to step 10 that resumes from it, whose first loss (batch 0 again: a
    fresh iterator, as the reference's launcher) is bitwise the loss the
    train step computes (the gradient flowing) from the in-memory step-5
    state on batch 0.  S2 launches a step: forward
    twice a layer (the step and remat's recomputation), backward once."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import latest_step, load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import make_train_iterator
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train
    from repro_torch.models import build_model
    _free_card()
    cfg = get_config(TRAIN_SSM["arch"])
    model = build_model(cfg)
    n_ssd = _ssd_layers(cfg)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        first = train.run(_train_argv(TRAIN_SSM, steps=CKPT_AT,
                                      ckpt_dir=ckdir, ckpt_every=CKPT_AT))
        got = {k: v for k, v in _launch_counts().items()
               if k.startswith("ssd_state_scan")}
        want = {"ssd_state_scan": 2 * n_ssd * CKPT_AT,
                "ssd_state_scan_bwd": n_ssd * CKPT_AT}
        check(got == want, f"16b: S2 launches {got}, expected {want} (2 "
                           f"forward and 1 backward a layer a step)")
        _check_trained(first, "16b first run", falls=False)
        check(latest_step(ckdir) == CKPT_AT, f"16b: no checkpoint at "
                                             f"{CKPT_AT}")
        t0 = time.perf_counter()
        _, restored = load_checkpoint(ckdir, like={"params": first.params,
                                                   "opt": first.opt})
        load_s = time.perf_counter() - t0
        saved = _leaves({"params": first.params, "opt": first.opt})
        for a, b in zip(_leaves(restored), saved):
            same_bits(a, b, "16b restored leaf vs the in-memory state")
        ckpt_gb = sum(f.stat().st_size for f in
                      (Path(ckdir) / f"step_{CKPT_AT:08d}").iterdir()) / 1e9
        del restored
        tokens = next(make_train_iterator(
            vocab=cfg.vocab, global_batch=TRAIN_SSM["batch"],
            seq=TRAIN_SSM["seq"]))["tokens"]
        # the loss as the train step computes it, with the gradient flowing
        # (so its norms run the eager expression: S4 has no backward)
        (want_loss, _), _ = ST.value_and_grad(
            model.loss_stacked, first.params,
            {"tokens": torch.as_tensor(tokens, device="cuda")})
        want_loss = float(want_loss)
        del first
        _free_card()
        _reset_launches()
        second = train.run(_train_argv(TRAIN_SSM, ckpt_dir=ckdir,
                                       ckpt_every=100))
        resumed = {k: v for k, v in _launch_counts().items()
                   if k.startswith("ssd_state_scan")}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    steps2 = TRAIN_SSM["steps"] - CKPT_AT
    want = {"ssd_state_scan": 2 * n_ssd * steps2,
            "ssd_state_scan_bwd": n_ssd * steps2}
    check(resumed == want, f"16b resumed: S2 launches {resumed}, expected "
                           f"{want}")
    check(second.start == CKPT_AT and len(second.losses) == steps2,
          f"16b: resumed at {second.start} with {len(second.losses)} steps")
    check(second.losses[0] == want_loss,
          f"16b: the first resumed loss {second.losses[0]!r} != the step-"
          f"{CKPT_AT} state's loss on batch 0 {want_loss!r}")
    _check_trained(second, "16b resumed run", falls=False)
    row = _train_row(second, TRAIN_SSM["batch"], TRAIN_SSM["seq"], model,
                     "16b")
    row.update(peak_gib=peak, checkpoint_gb=ckpt_gb, restore_s=load_s,
               launches=resumed, launches_per_step={
                   k: v // steps2 for k, v in resumed.items()})
    print(f"phase 16b train mamba2-130m (24 SSD layers, bf16) "
          f"{TRAIN_SSM['batch']} x {TRAIN_SSM['seq']} (nc = "
          f"{TRAIN_SSM['seq'] // cfg.ssm_chunk}): checkpoint at step "
          f"{CKPT_AT} ({ckpt_gb:.2f} GB, restored in {load_s:.1f} s, every "
          f"leaf bitwise the in-memory state); resumed run from step "
          f"{second.start}: first loss {second.losses[0]!r} == the step-"
          f"{CKPT_AT} state's loss on batch 0, bitwise; S2 {n_ssd * 2} "
          f"forward + {n_ssd} backward launches a step; median "
          f"{row['step_ms_median']:.1f} ms/step, {row['tokens_per_s']:.0f} "
          f"tokens/s, model-FLOP share {row['model_flop_share']:.1%}, peak "
          f"{peak:.2f} GiB")
    del second
    _free_card()
    return row


def _phase_train_rg(seed):
    """16c: recurrentgemma-9b at full width cut to 6 layers (RRLRRL),
    bf16, stacked, through ``make_train_step`` at 2 x 2048 for 5 steps:
    finite losses, S1 launches a step (forward twice a recurrent layer,
    backward once)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_train_iterator
    from repro_torch.device import make_generator
    from repro_torch.launch import steps as ST
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    _free_card()
    cfg = dataclasses.replace(get_config(TRAIN_RG["arch"]),
                              n_layers=TRAIN_RG["layers"])
    kinds = "".join(cfg.kind(i) for i in range(cfg.n_layers))
    check(kinds == "RRLRRL", f"16c: layer kinds {kinds}")
    n_rec = kinds.count("R")
    model = build_model(cfg)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    params = model.init_stacked(make_generator(seed, dev), dev)
    opt = adamw_init(params)
    step = ST.make_train_step(model, lr=1e-3, total_steps=TRAIN_RG["steps"])
    it = make_train_iterator(vocab=cfg.vocab, global_batch=TRAIN_RG["batch"],
                             seq=TRAIN_RG["seq"])
    _reset_launches()
    losses, gnorms, step_s = [], [], []
    for _ in range(TRAIN_RG["steps"]):
        t0 = time.perf_counter()
        batch = {"tokens": torch.as_tensor(next(it)["tokens"], device=dev)}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
    got = {k: v for k, v in _launch_counts().items()
           if k.startswith("rglru_scan")}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"rglru_scan": 2 * n_rec * TRAIN_RG["steps"],
            "rglru_scan_bwd": n_rec * TRAIN_RG["steps"]}
    check(got == want, f"16c: S1 launches {got}, expected {want}")
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"16c: loss or grad norm not finite: {losses} {gnorms}")
    from repro_torch.launch.mesh import H100_BF16_FLOPS
    ms = float(np.median(step_s[2:])) * 1e3
    tok_s = TRAIN_RG["batch"] * TRAIN_RG["seq"] / ms * 1e3
    row = dict(what="16c", layers=kinds, params=model.param_count(params),
               step_ms_median=ms, step_ms=[1e3 * x for x in step_s],
               tokens_per_s=tok_s, model_flop_share=(
                   model.model_flops_per_token() * tok_s /
                   H100_BF16_FLOPS),
               losses=losses, grad_norms=gnorms, peak_gib=peak,
               launches=got, launches_per_step={
                   k: v // TRAIN_RG["steps"] for k, v in got.items()})
    print(f"phase 16c train recurrentgemma-9b full width, 6 of 38 layers "
          f"({kinds}, bf16, {row['params'] / 1e9:.3f} B params) "
          f"{TRAIN_RG['batch']} x {TRAIN_RG['seq']}, {TRAIN_RG['steps']} "
          f"steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}, grad norm "
          f"{gnorms[0]:.3f} -> {gnorms[-1]:.3f}; S1 {2 * n_rec} forward + "
          f"{n_rec} backward launches a step; median {ms:.1f} ms/step "
          f"(steps 3-5), {tok_s:.0f} tokens/s, model-FLOP share "
          f"{row['model_flop_share']:.1%}, peak {peak:.2f} GiB")
    del params, opt
    _free_card()
    return row


def _train_excess(card, cpu, what, extra=0.0):
    """-> the worst |card - cpu| over the tolerance's allowance
    TRAIN_TOL_REL |cpu| + TRAIN_TOL_LEAF max|cpu leaf| + ``extra`` (<= 0 is
    within it) of tensors or trees of them."""
    worst = float("-inf")
    for a, b in zip(_leaves(card), _leaves(cpu)):
        a, b = a.detach().float().cpu(), b.detach().float()
        check(a.shape == b.shape, f"{what}: shapes {a.shape} {b.shape}")
        if a.numel() == 0:
            continue
        allow = TRAIN_TOL_REL * b.abs() + TRAIN_TOL_LEAF * b.abs().max()
        worst = max(worst, ((a - b).abs() - allow - extra).max().item())
    return worst


def _train_share(card, cpu):
    """The largest |card - cpu| of a tree's leaves as a share of its
    leaf's largest |cpu| element."""
    out = 0.0
    for a, b in zip(_leaves(card), _leaves(cpu)):
        b = b.detach().float()
        if b.numel():
            out = max(out, (a.detach().float().cpu() - b).abs().max().item()
                      / max(b.abs().max().item(), 1e-30))
    return out


def _phase_train_cpu(seed, device="cuda"):
    """16d: fp32 card == CPU for ``make_train_step`` on each of the ten
    smoke presets (list layout, per-block remat) and on the stacked layout
    of the nine that have one, from the same weights and batch (2 x 64
    tokens, numpy-seeded; frames and patches too): two steps each (the
    first at the warm-up's lr 0, the second moves the weights), the loss,
    grad norm, m and v after each step, and every gradient leaf of each
    step (``value_and_grad`` of the step's loss on the state it starts
    from) within TRAIN_TOL_REL * |cpu| + TRAIN_TOL_LEAF * max|cpu leaf|; the
    parameters within that plus 2 lr (AdamW's step is ~lr times the sign
    of m for an element whose gradient is rounding noise, so such an
    element may move either way; the rest agree to the tolerance).  The
    gradients on the card are the repair's proof: the R and S layers'
    parameters get theirs through the scans' backward kernels."""
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.device import make_generator
    from repro_torch.launch import steps as ST
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tt
    from repro_torch.optim import adamw_init
    rng = np.random.default_rng(seed + 160)
    dev = torch.device(device)
    _reset_launches()
    worst, cases, moved, share = {}, 0, float("-inf"), 0.0
    for arch in ARCH_IDS:
        cfg = get_config(arch).smoke()
        model = build_model(cfg)
        seq = min(TRAIN_CPU_SEQ, cfg.max_seq) if cfg.max_seq else \
            TRAIN_CPU_SEQ
        batches = []
        for _ in range(2):
            b = {"tokens": rng.integers(0, cfg.vocab, (2, seq)).astype(
                np.int32)}
            if cfg.enc_dec:
                b["frames"] = rng.standard_normal(
                    (2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
            if cfg.frontend == "vision":
                b["patches"] = rng.standard_normal(
                    (2, cfg.n_patches, cfg.d_model)).astype(np.float32)
            batches.append({k: torch.as_tensor(v) for k, v in b.items()})
        for stacked in ((False, True) if model.supports_stacked
                        else (False,)):
            init = model.init_stacked if stacked else model.init
            params = init(make_generator(seed, dev), dev)
            cpu_params = tt.params_from_numpy(_to_numpy(params), cfg, "cpu")
            loss_fn = ST.train_loss_fn(model, stacked)
            # total_steps 10: a warm-up of 2 steps, lr 0 then 5e-4
            step = ST.make_train_step(model, lr=1e-3, total_steps=10,
                                      stacked=stacked)
            states = [(params, adamw_init(params), dev),
                      (cpu_params, adamw_init(cpu_params), "cpu")]
            name = f"{arch}{' stacked' if stacked else ''}"
            w = float("-inf")
            for k, batch in enumerate(batches):
                out = []
                for p, opt, d in states:
                    b = {key: v.to(d) for key, v in batch.items()}
                    _, grads = ST.value_and_grad(loss_fn, p, b)
                    p, opt, m = step(p, opt, b)
                    out.append(((m["loss"], m["grad_norm"]), grads,
                                (opt.m, opt.v), p, (p, opt, d)))
                lr = float(m["lr"])
                states = [o[4] for o in out]
                share = max(share, _train_share(out[0][1], out[1][1]))
                for part, tag, extra in ((0, "loss/grad norm", 0.0),
                                         (1, "gradients", 0.0),
                                         (2, "m/v", 0.0),
                                         (3, "params", 2 * lr)):
                    ex = _train_excess(out[0][part], out[1][part],
                                       f"16d {name} step {k}", extra)
                    check(ex <= 0, f"16d {name} step {k}: {tag} exceed the "
                                   f"tolerance by {ex:.3e}")
                    if part < 3:
                        w = max(w, ex)
                    else:
                        moved = max(moved, _train_excess(
                            out[0][part], out[1][part], name) / max(lr,
                                                                    1e-30))
            worst[name] = w
            cases += 1
            del params, cpu_params, states, out
            if dev.type == "cuda":
                _free_card()
    launches = {k: v for k, v in _launch_counts().items() if v}
    for k in ("rglru_scan", "rglru_scan_bwd", "ssd_state_scan",
              "ssd_state_scan_bwd"):
        check(launches.get(k, 0) > 0 or dev.type == "cpu",
              f"16d: {k} never ran: {launches}")
    print(f"phase 16d fp32 card == CPU, {cases} cases (ten smoke presets, "
          f"list and stacked layouts), 2 train steps each: loss, grad norm, "
          f"every gradient leaf, m, v within {TRAIN_TOL_REL:g} |cpu| + "
          f"{TRAIN_TOL_LEAF:g} max|cpu leaf| (largest gradient difference "
          f"{share:.2e} of its leaf's largest element), params within that "
          f"+ 2 lr "
          f"(worst excess over the strict allowance {moved:.2e} lr); kernel "
          f"launches {launches}")
    return dict(worst_excess=worst, params_excess_in_lr=moved,
                grad_share=share,
                launches=launches, cases=cases)


def _phase_scan_bwd_kernels(seed, ptxas):
    """16e: the scans' backward kernels against their plain versions on
    the card: S1 bitwise on ragged shapes (w 31/33/257, S at one ring stage
    - 1, one stage, one stage + 1) and 16c's [2, 2048, 4096]; S2's d_states
    and d_h0 bitwise and d_decay within 1e-5 of the sum of the absolute
    products, at nc = 1, a ragged N x hd, and 16b's [8, 16, 24, 128, 64];
    rows alone == in a batch of 3.  Each timed at the full-width shape
    beside its byte bound, its plain version and its ptxas line.  No
    single PyTorch call computes either, so neither has a library time."""
    import torch
    from repro_torch.kernels import cost
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import ssd_scan as ss
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 161)

    def s1_inputs(b, s, w):
        return (torch.rand((b, s, w), generator=g, device=dev) * 0.5 + 0.5,
                torch.randn((b, s, w), generator=g, device=dev),
                torch.randn((b, s, w), generator=g, device=dev))

    ring = rs.ring()
    n = 0
    for b, s, w in [(1, ring["positions"] + d, w) for d in (-1, 0, 1)
                    for w in (31, 33, 257)] + [(3, 7, 4096), S1_BWD_SHAPE]:
        a, bx, gh = s1_inputs(b, s, w)
        h = rs.rglru_scan(a, bx)
        for got, want, what in zip(rs.rglru_scan_bwd(a, h, gh),
                                   rs.rglru_scan_bwd_plain(a, h, gh),
                                   ("d_a", "d_bx")):
            same_bits(got, want, f"S1 backward {what} [{b},{s},{w}]")
        n += 1
    a, bx, gh = s1_inputs(3, 300, 512)
    h = rs.rglru_scan(a, bx)
    one = rs.rglru_scan_bwd(*(t[1:2].contiguous() for t in (a, h, gh)))
    for x, y in zip(one, rs.rglru_scan_bwd(a, h, gh)):
        same_bits(x, y[1:2], "S1 backward row alone vs in a batch of 3")

    def s2_check(shape, with_h0, g_final=True):
        decay, states, _ = _s2_inputs(g, shape)
        hs, _ = ss.ssd_state_scan(decay, states)
        g_s = torch.randn(shape, generator=g, device=dev)
        g_f = torch.randn((shape[0],) + shape[2:], generator=g,
                          device=dev) if g_final else None
        got = ss.ssd_state_scan_bwd(decay, hs, g_s, g_f, with_h0)
        want = ss.ssd_state_scan_bwd_plain(decay, hs, g_s, g_f, with_h0)
        same_bits(got[1], want[1], f"S2 backward d_states {shape}")
        if with_h0:
            same_bits(got[2], want[2], f"S2 backward d_h0 {shape}")
        scale = ss.ssd_state_scan_bwd_plain(
            decay.abs(), hs.abs(), g_s.abs(),
            None if g_f is None else g_f.abs(), False)[0]
        err = ((got[0] - want[0]).abs() - 1e-5 * scale).max().item()
        check(err <= 0, f"S2 backward d_decay {shape}: exceeds 1e-5 of the "
                        f"absolute products' sum by {err:.3e}")
        return (got[0] - want[0]).abs().max().item(), \
            (decay, hs, g_s, g_f)

    s2_err = 0.0
    for shape in S2_BWD_SMOKE + [S2_BWD_SHAPE]:
        for with_h0, g_final in ((False, True), (True, False)):
            s2_err = max(s2_err, s2_check(shape, with_h0, g_final)[0])
            n += 1
    decay, states, _ = _s2_inputs(g, (3, 4, 6, 32, 64))
    hs, _ = ss.ssd_state_scan(decay, states)
    g_s = torch.randn(hs.shape, generator=g, device=dev)
    batch = ss.ssd_state_scan_bwd(decay, hs, g_s, None, True)
    one = ss.ssd_state_scan_bwd(decay[1:2].contiguous(),
                                hs[1:2].contiguous(),
                                g_s[1:2].contiguous(), None, True)
    for x, y in zip(one, batch):
        same_bits(x, y[1:2], "S2 backward row alone vs in a batch of 3")

    rows = {}
    a, bx, gh = s1_inputs(*S1_BWD_SHAPE)
    h = rs.rglru_scan(a, bx)
    count = cost.rglru_scan_bwd(*S1_BWD_SHAPE)  # a, h, gh read; d_a, d_bx
    rows["rglru_scan_bwd"] = dict(
        shape=list(S1_BWD_SHAPE), max_abs_err=0.0, bitwise=True,
        ms=cuda_ms(lambda: rs.rglru_scan_bwd(a, h, gh)),
        plain_ms=cuda_ms(lambda: rs.rglru_scan_bwd_plain(a, h, gh),
                         iters=3, warmup=1),
        library_ms=None, nbytes=count.bytes,
        ptxas=_ptxas_regs(ptxas, "rglru_scan", "rglru_scan_bwd_kernel",
                          "16 B copies"),
        **cost.bound(count))
    _, (decay, hs, g_s, g_f) = s2_check(S2_BWD_SHAPE, False)
    count = cost.ssd_state_scan_bwd(*S2_BWD_SHAPE, g_starts=True,
                                    g_final=True, with_h0=False)
    rows["ssd_state_scan_bwd"] = dict(
        shape=list(S2_BWD_SHAPE), max_abs_err=s2_err, bitwise=False,
        ms=cuda_ms(lambda: ss.ssd_state_scan_bwd(decay, hs, g_s, g_f,
                                                 False)),
        plain_ms=cuda_ms(lambda: ss.ssd_state_scan_bwd_plain(
            decay, hs, g_s, g_f, False), iters=3, warmup=1),
        library_ms=None, nbytes=count.bytes,
        ptxas=_ptxas_regs(ptxas, "ssd_scan", "ssd_state_scan_bwd_kernel",
                          "float4"),
        **cost.bound(count))
    for name, r in rows.items():
        print(f"phase 16e {name} {r['shape']}: kernel {r['ms']:.4f} ms "
              f"({r['bound_ms'] / r['ms']:.0%} of the byte bound "
              f"{r['bound_ms']:.5f} ms, {r['nbytes']} B), plain "
              f"{r['plain_ms']:.4f} ms, max |err| {r['max_abs_err']:.2e}; "
              f"{r['ptxas']}")
    print(f"phase 16e: {n} cases, S1 backward bitwise its plain loop, S2 "
          f"backward d_states/d_h0 bitwise and d_decay within 1e-5 of the "
          f"absolute products' sum (max |err| {s2_err:.2e}), rows alone == "
          f"in a batch bitwise; backward ring {ring['bwd_stage_bytes']} B a "
          f"stage x {ring['stages']}")
    return rows


def phase_train(seed, ptxas):
    """Phase 16: training (module docstring)."""
    rows = {}
    for tag, fn in (("16e", lambda: _phase_scan_bwd_kernels(seed, ptxas)),
                    ("16a", lambda: _phase_train_lm(seed)),
                    ("16b", lambda: _phase_train_ssm(seed)),
                    ("16c", lambda: _phase_train_rg(seed)),
                    ("16d", lambda: _phase_train_cpu(seed))):
        t0 = time.perf_counter()
        rows[tag] = fn()
        print(f"phase {tag} wall {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 17: mesh-sharded serving (M11) on one card's slots: Runtime(mesh=)
# with placement by cost, the sequence-parallel SSD and the expert-parallel
# MoE
# ---------------------------------------------------------------------------

MESH_SLOTS = 8
#: ticks a 17a run is checked over (launches counted), then timed ticks
MESH_TICKS, MESH_TIMED_TICKS = 4, 32
#: 17a's mid-batch kill: the first hub dies on its 3rd request of this tick
MESH_KILL_TICK = 2
CODEC_KERNELS = ("quantize8", "dequantize8", "sparse_enc", "sparse_dec")
#: 17b: mamba2-130m whole (bf16) at 8 x 2048 on a (data 2, model 4) mesh
SP_MODEL, SP_BATCH, SP_SEQ = 4, 8, 2048
#: 17b's limits, each a share of the single-device tensor's largest
#: element: bf16 whole model (logits and every cache leaf), fp32 at 2
#: layers of full width
SP_BF16_TOL, SP_FP32_TOL = 2e-2, 1e-4
#: 17b's bf16 train step: every gradient leaf's largest |mesh - single|
#: as a share of the leaf's largest |single| (16d's allowance is an fp32
#: one; the fp32 step at 2 layers is held to it)
SP_BF16_GRAD_SHARE = 5e-2
#: 17c: one mixtral-8x22b MoE block at full width on a (1, 4) mesh
MOE_MODEL, MOE_BATCH, MOE_SEQ = 4, 8, 512
MOE_TOL = 2e-2                 # bf16, a share of max|y|


def _mesh_offload(seed, mesh, codecs, ticks, timed=0, fault=False,
                  eager_route=False, **rt_kw):
    """Phase 6's offload: client i sends ``codecs[i]`` f32 [1, 512, 2048]
    frames to the offload-gate server (two servers from one seed with
    ``fault``, the first killed mid-batch on its 3rd request of tick
    ``MESH_KILL_TICK``), ``query_batch=8``, on ``Runtime(mesh=mesh,
    **rt_kw)``.  ``eager_route``: a meshless twin whose batcher routes
    codec groups as a mesh runtime does (one stacked host decode, the
    single-device serve, the serversink's encode per answer).  -> (runtime,
    client runs, server runs, K1–K4 launches over the ``ticks`` checked
    ticks, host seconds of the ``timed`` ticks after them, the harness)"""
    import torch
    from repro_torch.core import parse_launch
    from repro_torch.device import make_generator
    from repro_torch.runtime import Device, Runtime
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    from chaoslib import Chaos
    rt = Runtime(device="cuda", mesh=mesh, query_batch=OFFLOAD_CLIENTS,
                 **rt_kw)
    servers = []
    for name in (("hubA", "hubB") if fault else ("hub",)):
        hub = Device(name, device="cuda")
        ps = parse_launch(
            "tensor_query_serversrc operation=act name=ssrc ! "
            "tensor_filter model=offload-gate ! "
            "tensor_query_serversink name=ssink")
        ps.elements["ssink"].pair_with(ps.elements["ssrc"])
        run = hub.add_pipeline(ps, generator=make_generator(seed, rt.device))
        rt.add_device(hub)
        servers.append((hub, run, ps.elements["ssrc"]))
    if eager_route:
        for b in rt.batchers():
            b._mesh_may_take = lambda n: True
    runs = []
    for i, codec in enumerate(codecs):
        opt = OFFLOAD_TRANSFORMS[codec].format(m=1 + i / 8)
        pc = parse_launch(
            f"testsrc width={OFFLOAD_L} height=1 channels={OFFLOAD_D} ! "
            f"tensor_converter ! tensor_transform mode=arithmetic "
            f"option={opt} ! tensor_query_client operation=act "
            f"codec={codec} name=qc ! appsink name=res")
        dev = Device(f"cl{i}", device="cuda")
        runs.append(dev.add_pipeline(pc))
        rt.add_device(dev)
    harness = Chaos(rt)
    if fault:
        hub, _, ssrc = servers[0]
        harness.kill_server_mid_batch(MESH_KILL_TICK, hub, ssrc, after_n=3)
    _reset_launches()
    harness.run(ticks)
    torch.cuda.synchronize()
    counts = _launch_counts()
    launches = {k: counts[k] for k in CODEC_KERNELS}
    secs = _timed_ticks(rt, timed) if timed else []
    return rt, runs, servers, launches, secs, harness


def _same_answers(a, b, what):
    check(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} clients")
    for i, (x, y) in enumerate(zip(a, b)):
        check(len(x) == len(y), f"{what}: client {i} {len(x)} vs {len(y)} "
                                f"answers")
        for t, (u, v) in enumerate(zip(x, y)):
            same_bits(u, v, f"{what}: client {i} tick {t}")


def _qb(rt):
    return rt.stats()["query_batching"]


def _phase_mesh_offload(seed, devices, tag):
    """17a (and 17d on distinct GPUs): phase 6's offload on a mesh of
    ``devices`` slots under ``shard_mode="always"`` against its meshless
    twins: answers bitwise, every frame sharded, K1–K4 launches equal to
    the meshless eager-route twin's; mixed codecs (groups of 4 that do not
    tile 8 slots serve fused on one device), ``fused_wire=False``, a
    mid-batch kill and ``shard_mode="auto"``.  Prints the host ms per tick
    (median of MESH_TIMED_TICKS) of the sharded runtime and of the
    single-device ones."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import replicated
    mesh = make_host_mesh(devices=devices)
    n_slots = mesh.size
    total = MESH_TICKS + MESH_TIMED_TICKS
    out = {"slots": n_slots, "devices": [str(d) for d in
                                         mesh.distinct_devices()]}
    launches = {k: 0 for k in CODEC_KERNELS}
    for codec in ("quant8", "sparse:0.15"):
        codecs = [codec] * OFFLOAD_CLIENTS
        _free_card()
        rt_m, runs_m, srv_m, l_m, s_m, _ = _mesh_offload(
            seed, mesh, codecs, MESH_TICKS, MESH_TIMED_TICKS,
            shard_mode="always")
        ans_m = _answers(runs_m, total, f"{tag} {codec} mesh")
        qb = _qb(rt_m)
        want = OFFLOAD_CLIENTS * total if OFFLOAD_CLIENTS % n_slots == 0 \
            else 0
        check(qb["sharded_frames"] == want and qb["batched_frames"] ==
              OFFLOAD_CLIENTS * total,
              f"{tag} {codec}: sharded {qb['sharded_frames']} of "
              f"{qb['batched_frames']} frames, expected {want}")
        rep = rt_m.batchers()[0]._mesh_params
        check(rep is not None and (len(mesh.distinct_devices()) > 1 or
                                   rep.nbytes() == 0),
              f"{tag}: the mesh-placed params copy the weights on one card")
        for k, v in l_m.items():
            launches[k] += v
        del rt_m, runs_m, srv_m
        _free_card()
        rt_t, runs_t, _, l_t, s_t, _ = _mesh_offload(
            seed, None, codecs, MESH_TICKS, MESH_TIMED_TICKS)
        _same_answers(ans_m, _answers(runs_t, total, f"{tag} {codec} twin"),
                      f"{tag} {codec} mesh vs meshless twin")
        check(_qb(rt_t)["fused_frames"] == OFFLOAD_CLIENTS * total,
              f"{tag} {codec}: the twin did not serve fused")
        del rt_t, runs_t
        _free_card()
        rt_e, runs_e, _, l_e, s_e, _ = _mesh_offload(
            seed, None, codecs, MESH_TICKS, MESH_TIMED_TICKS,
            eager_route=True)
        _same_answers(ans_m, _answers(runs_e, total, f"{tag} {codec} eager"),
                      f"{tag} {codec} mesh vs the eager-route twin")
        check(l_m == l_e, f"{tag} {codec}: K1–K4 launches {l_m} on the mesh,"
                          f" {l_e} on the meshless eager route")
        del rt_e, runs_e, ans_m
        med = {k: float(np.median(v)) * 1e3 for k, v in
               (("sharded", s_m), ("single_same_route", s_e),
                ("single_fused", s_t))}
        out[codec] = dict(launches=l_m, twin_fused_launches=l_t,
                          host_ms_per_tick=med,
                          sharded_frames=qb["sharded_frames"])
        print(f"phase {tag} {codec}: {OFFLOAD_CLIENTS} clients x {total} "
              f"ticks on {n_slots} slots of {out['devices']}, every frame "
              f"sharded, answers bitwise the meshless twins'; K1–K4 "
              f"launches {l_m} == the meshless eager route's (fused twin "
              f"{l_t}); host ms/tick, median of {MESH_TIMED_TICKS} (one "
              f"card's slots, not a multi-GPU speed): sharded "
              f"{med['sharded']:.2f}, single on the same wire route "
              f"{med['single_same_route']:.2f}, single fused "
              f"{med['single_fused']:.2f}")
    _free_card()
    # mixed codecs: groups of 4 serve codec-fused on one device
    mixed = ["quant8"] * 4 + ["sparse:0.15"] * 4
    rt_x, runs_x, _, l_x, _, _ = _mesh_offload(seed, mesh, mixed,
                                                MESH_TICKS,
                                                shard_mode="always")
    qb = _qb(rt_x)
    check(qb["sharded_frames"] == 0 and qb["fused_frames"] ==
          OFFLOAD_CLIENTS * MESH_TICKS,
          f"{tag} mixed: sharded {qb['sharded_frames']}, fused "
          f"{qb['fused_frames']}")
    ans_x = _answers(runs_x, MESH_TICKS, f"{tag} mixed")
    del rt_x, runs_x
    _, runs_xt, _, l_xt, _, _ = _mesh_offload(seed, None, mixed, MESH_TICKS)
    _same_answers(ans_x, _answers(runs_xt, MESH_TICKS, f"{tag} mixed twin"),
                  f"{tag} mixed codecs vs the meshless twin")
    check(l_x == l_xt, f"{tag} mixed: launches {l_x} vs {l_xt}")
    del runs_xt, ans_x
    # fused_wire=False: mixed codecs stack into one sharded batch
    rt_f, runs_f, _, l_f, _, _ = _mesh_offload(
        seed, mesh, mixed, MESH_TICKS, shard_mode="always", fused_wire=False)
    check(_qb(rt_f)["sharded_frames"] == (OFFLOAD_CLIENTS * MESH_TICKS
                                          if OFFLOAD_CLIENTS % n_slots == 0
                                          else 0),
          f"{tag} fused_wire=False: sharded {_qb(rt_f)['sharded_frames']}")
    ans_f = _answers(runs_f, MESH_TICKS, f"{tag} eager wire")
    del rt_f, runs_f
    _, runs_ft, _, l_ft, _, _ = _mesh_offload(seed, None, mixed, MESH_TICKS,
                                              fused_wire=False)
    _same_answers(ans_f, _answers(runs_ft, MESH_TICKS, f"{tag} eager twin"),
                  f"{tag} fused_wire=False vs the meshless twin")
    check(l_f == l_ft, f"{tag} fused_wire=False: launches {l_f} vs {l_ft}")
    del runs_ft, ans_f
    _free_card()
    # the mid-batch kill, against the fault-free mesh twin
    q8 = ["quant8"] * OFFLOAD_CLIENTS
    ticks_k = MESH_KILL_TICK + 3
    rt_k, runs_k, srv_k, _, _, harness = _mesh_offload(
        seed, mesh, q8, ticks_k, fault=True, shard_mode="always")
    check(any("mid-batch" in label and "DISARMED" not in label
              for _, label in harness.log), f"{tag}: the kill never fired")
    fo, qb = rt_k.stats()["failover"], _qb(rt_k)
    check(fo["redispatches"] >= 1 and fo["parked_now"] == 0 and
          qb["sharded_frames"] > 0,
          f"{tag} kill: redispatches {fo['redispatches']}, parked "
          f"{fo['parked_now']}, sharded {qb['sharded_frames']}")
    ans_k = _answers(runs_k, ticks_k, f"{tag} kill")
    del rt_k, runs_k, srv_k
    runs_kt = _mesh_offload(seed, mesh, q8, ticks_k, shard_mode="always")[1]
    _same_answers(ans_k, _answers(runs_kt, ticks_k, f"{tag} kill twin"),
                  f"{tag} mid-batch kill vs the fault-free mesh twin")
    del runs_kt, ans_k
    _free_card()
    # auto: one probe per batch size, answers bitwise whatever it picks
    rt_a, runs_a, _, _, _, _ = _mesh_offload(seed, mesh, q8, MESH_TICKS)
    batcher = rt_a.batchers()[0]
    pick = dict(batcher.placements)
    check(set(pick) == ({OFFLOAD_CLIENTS} if OFFLOAD_CLIENTS % n_slots == 0
                        else set()),
          f"{tag} auto: placements {pick}")
    _same_answers(_answers(runs_a, MESH_TICKS, f"{tag} auto"),
                  [a[:MESH_TICKS] for a in
                   _answers(_mesh_offload(seed, None, q8, MESH_TICKS)[1],
                            MESH_TICKS, f"{tag} auto twin")],
                  f"{tag} auto vs the meshless twin")
    qa = _qb(rt_a)
    del rt_a, runs_a
    _free_card()
    out.update(launches=launches, auto_placement=pick,
               auto_sharded_frames=qa["sharded_frames"],
               auto_fused_frames=qa["fused_frames"],
               kill=dict(redispatches=fo["redispatches"]))
    print(f"phase {tag}: mixed codecs (groups of 4 on {n_slots} slots) "
          f"serve fused on one device, fused_wire=False shards them, "
          f"bitwise and K1–K4 launches equal the meshless twins'; a "
          f"mid-batch kill at tick {MESH_KILL_TICK} ({fo['redispatches']} "
          f"re-dispatches) is bitwise the fault-free mesh twin; "
          f"shard_mode=auto picked {pick} (sharded {qa['sharded_frames']}, "
          f"fused {qa['fused_frames']} frames), bitwise")
    return out


def _replica_memory():
    """17a: ``replicated`` over 4 slots on the card allocates nothing."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import replicated
    w = {"w": torch.randn(OFFLOAD_D, OFFLOAD_D, device="cuda"),
         "b": [torch.randn(OFFLOAD_D, device="cuda")]}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rep = replicated(make_host_mesh(devices=["cuda:0"] * 4), w)
    after = torch.cuda.memory_allocated()
    check(after == before and rep.nbytes() == 0 and
          rep.on(torch.device("cuda", 0))["w"] is w["w"],
          f"17a: 4 slots on one card hold {after - before} more bytes")
    return after - before


def _on_cpu(tree):
    import torch
    from repro_torch.core.buffers import tree_flatten, tree_unflatten
    leaves, td = tree_flatten(tree)
    return tree_unflatten(td, [l.detach().cpu() if isinstance(l, torch.Tensor)
                               else l for l in leaves])


def _tree_share(a, b, what):
    """The largest |a - b| of each float leaf as a share of the leaf's
    largest |b| (the worst over the leaves)."""
    import torch
    from repro_torch.core.buffers import tree_flatten
    worst = 0.0
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            continue
        check(x.shape == y.shape, f"{what}: shapes {x.shape} {y.shape}")
        y = y.float()
        worst = max(worst, (x.float() - y).abs().max().item()
                    / max(y.abs().max().item(), 1e-30))
    return worst


def _phase_mesh_ssd(seed):
    """17b: the sequence-parallel SSD of mamba2-130m whole (24 S layers,
    bf16) at 8 x 2048 on a (data 2, model 4) mesh of cuda:0 slots (4
    chunks of 128 a slot): the prefill through ``make_prefill_step(model,
    mesh)`` against ``make_prefill_step(model)`` (logits and every cache
    leaf within SP_BF16_TOL of each tensor's largest, the same greedy
    first token in all 8 rows, S2 once a layer a slot), one train step
    through ``make_train_step(model, mesh)`` (loss and every gradient leaf
    against the single-device step's, S2's backward once a layer a slot);
    fp32 at 2 layers of full width within SP_FP32_TOL (prefill) and 16d's
    tolerance (gradients); and the (1, 1) host mesh of ``launch/train.py``
    bitwise the single-device step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.device import make_generator
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models import ssm as SSM
    from repro_torch.optim import adamw_init
    _free_card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 170)
    mesh = make_host_mesh(SP_MODEL, devices=["cuda:0"] * MESH_SLOTS)
    slots = mesh.size
    out = {}
    cfg = get_config("mamba2-130m")
    n_ssd = _ssd_layers(cfg)
    model = build_model(cfg)
    params = model.init_stacked(make_generator(seed, dev), dev)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (SP_BATCH, SP_SEQ)).astype(np.int32), device=dev)}
    single_fn = ST.make_prefill_step(model)
    mesh_fn = ST.make_prefill_step(model, mesh)
    with torch.no_grad():
        logits0, cache0 = single_fn(params, batch)
        _reset_launches()
        logits1, cache1 = mesh_fn(params, batch)
        s2 = ss.LAUNCHES["ssd_state_scan"]
        ms_single = cuda_ms(lambda: single_fn(params, batch), 3, 1)
        ms_mesh = cuda_ms(lambda: mesh_fn(params, batch), 3, 1)
    check(s2 == n_ssd * slots, f"17b: S2 launches {s2} in the mesh prefill, "
                               f"expected {n_ssd} x {slots}")
    l_share = _tree_share(logits1, logits0, "17b logits")
    c_share = _tree_share(cache1, cache0, "17b cache")
    tok0, tok1 = logits0.argmax(-1), logits1.argmax(-1)
    check(l_share <= SP_BF16_TOL and c_share <= SP_BF16_TOL,
          f"17b bf16 prefill: logits {l_share:.2e}, cache {c_share:.2e} of "
          f"the largest, limit {SP_BF16_TOL:g}")
    check(torch.equal(tok0, tok1), f"17b: greedy first tokens {tok1.tolist()}"
                                   f" vs {tok0.tolist()}")
    del logits0, logits1, cache0, cache1
    # one train step, mesh vs single (the loss and value_and_grad first)
    loss_fn = ST.train_loss_fn(model)
    (l0, _), g0 = ST.value_and_grad(loss_fn, params, batch)
    with ST.step_rules(cfg, mesh):
        (l1, _), g1 = ST.value_and_grad(loss_fn, params, batch)
    g0, l0c = _on_cpu(g0), l0.cpu()
    bf16_grad = _train_excess(g1, g0, "17b bf16 gradients")
    bf16_loss = _train_excess(l1, l0c, "17b bf16 loss")
    grad_share = _train_share(g1, g0)
    leaves0, leaves1 = _leaves(g0), _leaves(g1)
    shares = [_train_share(a, b) for a, b in zip(leaves1, leaves0)]
    worst_leaf = int(np.argmax(shares))
    worst_shape = tuple(leaves0[worst_leaf].shape)
    check(bf16_loss <= 0 and grad_share <= SP_BF16_GRAD_SHARE,
          f"17b bf16 train step: loss excess {bf16_loss:.2e}, largest "
          f"gradient difference {grad_share:.2e} of its leaf's largest "
          f"(limit {SP_BF16_GRAD_SHARE:g})")
    del g0, g1, leaves0, leaves1
    step = ST.make_train_step(model, mesh)
    opt = adamw_init(params)
    _reset_launches()
    t0 = time.perf_counter()
    params, opt, metrics = step(params, opt, batch)
    loss_step = float(metrics["loss"])
    step_s = time.perf_counter() - t0
    bwd = ss.LAUNCHES["ssd_state_scan_bwd"]
    check(bwd == n_ssd * slots, f"17b: S2 backward launches {bwd} in the "
                                f"mesh step, expected {n_ssd} x {slots}")
    check(np.isfinite(loss_step) and abs(loss_step - float(l1)) <=
          1e-6 * abs(float(l1)) + 1e-6,
          f"17b: the mesh step's loss {loss_step} vs {float(l1)}")
    out["bf16"] = dict(logits_share=l_share, cache_share=c_share,
                       greedy=tok0.tolist(), s2_launches=s2,
                       s2_bwd_launches=bwd, prefill_ms_single=ms_single,
                       prefill_ms_mesh=ms_mesh, loss_excess=bf16_loss,
                       grad_excess=bf16_grad, grad_share=grad_share,
                       worst_leaf=worst_leaf, worst_leaf_shape=worst_shape,
                       step_s=step_s)
    print(f"phase 17b mamba2-130m (24 SSD layers, bf16) {SP_BATCH} x "
          f"{SP_SEQ} on a (data 2, model {SP_MODEL}) mesh of cuda:0 slots "
          f"({SP_SEQ // SP_MODEL // cfg.ssm_chunk} chunks a slot): prefill "
          f"logits {l_share:.2e}, cache {c_share:.2e} of the largest (limit "
          f"{SP_BF16_TOL:g}), greedy first tokens equal in all "
          f"{SP_BATCH} rows, S2 {s2} launches (24 x {slots}); train step: "
          f"loss within 16d's tolerance ({bf16_loss:.2e}), the largest "
          f"gradient difference {grad_share:.2e} of its leaf's largest "
          f"(limit {SP_BF16_GRAD_SHARE:g}; leaf {worst_leaf} of shape "
          f"{worst_shape}; over 16d's fp32 allowance by {bf16_grad:.2e}), "
          f"S2 backward {bwd} launches; device ms "
          f"of a prefill: single {ms_single:.2f}, mesh {ms_mesh:.2f} (one "
          f"card's slots)")
    del params, opt, metrics
    _free_card()
    # fp32, 2 layers at full width: the hard limits
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    m32 = build_model(cfg32)
    p32 = m32.init_stacked(make_generator(seed, dev), dev)
    b32 = {"tokens": batch["tokens"][:, :512]}
    with torch.no_grad():
        lg0, c0 = ST.make_prefill_step(m32)(p32, b32)
        lg1, c1 = ST.make_prefill_step(m32, mesh)(p32, b32)
    f32_share = max(_tree_share(lg1, lg0, "17b fp32 logits"),
                    _tree_share(c1, c0, "17b fp32 cache"))
    check(f32_share <= SP_FP32_TOL, f"17b fp32: {f32_share:.2e} of the "
                                    f"largest, limit {SP_FP32_TOL:g}")
    lf32 = ST.train_loss_fn(m32)
    (fl0, _), fg0 = ST.value_and_grad(lf32, p32, b32)
    with ST.step_rules(cfg32, mesh):
        (fl1, _), fg1 = ST.value_and_grad(lf32, p32, b32)
    f32_grad = max(_train_excess(fg1, _on_cpu(fg0), "17b fp32 gradients"),
                   _train_excess(fl1, fl0.cpu(), "17b fp32 loss"))
    check(f32_grad <= 0, f"17b fp32: loss/gradients exceed 16d's tolerance "
                         f"by {f32_grad:.2e}")
    del p32, fg0, fg1
    # the launcher's (1, 1) host mesh: one slot, bitwise
    host = make_host_mesh(devices=[dev])
    taken = []
    orig = SSM._ssm_prefill_seq_parallel

    def spy(*a, **k):
        taken.append(a[3].shape)
        return orig(*a, **k)
    params = model.init_stacked(make_generator(seed, dev), dev)
    (h0, _), hg0 = ST.value_and_grad(loss_fn, params, batch)
    SSM._ssm_prefill_seq_parallel = spy
    try:
        with ST.step_rules(cfg, host):
            (h1, _), hg1 = ST.value_and_grad(loss_fn, params, batch)
    finally:
        SSM._ssm_prefill_seq_parallel = orig
    check(len(taken) == 2 * n_ssd and all(s == {"data": 1, "model": 1}
                                          for s in taken),
          f"17b: the host-mesh step took the sequence-parallel path "
          f"{len(taken)} times, expected {2 * n_ssd}")
    from repro_torch.core.buffers import tree_flatten
    check(torch.equal(h0, h1) and all(
        torch.equal(a, b) for a, b in zip(tree_flatten(hg0)[0],
                                          tree_flatten(hg1)[0])),
        "17b: the (1, 1) host mesh's step is not bitwise the single-device "
        "step")
    del params, hg0, hg1
    _free_card()
    out.update(fp32_share=f32_share, fp32_grad_excess=f32_grad,
               host_mesh_bitwise=True,
               launches={"ssd_state_scan": s2, "ssd_state_scan_bwd": bwd})
    print(f"phase 17b fp32 mamba2-130m at 2 layers of full width, 8 x 512: "
          f"mesh within {f32_share:.2e} of the largest (limit "
          f"{SP_FP32_TOL:g}), loss and gradients within 16d's tolerance "
          f"(excess {f32_grad:.2e}); the (1, 1) host mesh of launch/train.py"
          f" takes the sequence-parallel path (m = 1) in all {n_ssd} layers "
          f"and its loss and gradients are bitwise the single-device step's")
    return out


def _phase_mesh_moe(seed):
    """17c: one mixtral-8x22b MoE block at full width (d 6144, 8 experts,
    f 16384, bf16) on 8 x 512 tokens over a (1, 4) mesh of cuda:0 slots:
    expert-parallel (8 % 4 == 0) and ``moe_force_tp`` (f split 4 ways),
    each within MOE_TOL of max|y| of ``apply_moe`` without a mesh, the
    aux loss equal; the slots' expert weights are views (no device bytes);
    device ms of each."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.device import make_generator
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import P, make_host_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models.sharding import sharding_rules
    _free_card()
    dev = torch.device("cuda")
    cfg = get_config("mixtral-8x22b")
    p = MOE.moe_init(make_generator(seed, dev), cfg, dev)
    weight_gb = sum(t.numel() * t.element_size() for t in
                    (p["w_up"], p["w_gate"], p["w_down"])) / 1e9
    x = torch.randn((MOE_BATCH, MOE_SEQ, cfg.d_model),
                    generator=make_generator(seed + 17, dev),
                    device=dev).to(torch.bfloat16)
    mesh = make_host_mesh(MOE_MODEL, devices=["cuda:0"] * MOE_MODEL)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    parts = [spmd.split(p[k], mesh, spec) for k, spec in
             (("w_up", P("model", None, None)),
              ("w_gate", P(None, None, "model")),
              ("w_down", P(None, "model", None)))]
    grew = torch.cuda.memory_allocated() - before
    check(grew == 0, f"17c: splitting the experts over {MOE_MODEL} slots "
                     f"allocated {grew} bytes")
    del parts
    out = {"weight_gb": weight_gb, "split_bytes": grew}
    with torch.no_grad():
        y0, a0 = MOE.apply_moe(p, cfg, x)
        out["dense_ms"] = cuda_ms(lambda: MOE.apply_moe(p, cfg, x), 3, 1)
        for tag, c in (("EP", cfg),
                       ("TP", dataclasses.replace(cfg, moe_force_tp=True))):
            def run(c=c):
                with sharding_rules(batch="data", __mesh__=mesh):
                    return MOE.apply_moe(p, c, x)
            y, a = run()
            share = _tree_share(y, y0, f"17c {tag}")
            check(share <= MOE_TOL and torch.isfinite(y.float()).all(),
                  f"17c {tag}: {share:.2e} of max|y|, limit {MOE_TOL:g}")
            check(abs(float(a) - float(a0)) <= 1e-6 * abs(float(a0)),
                  f"17c {tag}: aux {float(a)} vs {float(a0)}")
            out[tag] = dict(share=share, ms=cuda_ms(run, 3, 1))
    print(f"phase 17c mixtral-8x22b MoE block (d {cfg.d_model}, "
          f"{cfg.n_experts} experts, f {cfg.d_ff_expert}, bf16, "
          f"{weight_gb:.2f} GB) on {MOE_BATCH} x {MOE_SEQ} tokens over a "
          f"(1, {MOE_MODEL}) mesh of cuda:0 slots: expert-parallel "
          f"{out['EP']['share']:.2e}, intra-expert TP "
          f"{out['TP']['share']:.2e} of max|y| (limit {MOE_TOL:g}), aux "
          f"equal; the slots' weights are views (0 bytes); device ms: dense "
          f"{out['dense_ms']:.2f}, EP {out['EP']['ms']:.2f}, TP "
          f"{out['TP']['ms']:.2f} (one card's slots)")
    del p, x, y0
    _free_card()
    return out


def phase_mesh(seed):
    """Phase 17: mesh-sharded serving (module docstring)."""
    import torch
    rows = {}
    t0 = time.perf_counter()
    rows["17a"] = _phase_mesh_offload(seed, ["cuda:0"] * MESH_SLOTS, "17a")
    rows["17a"]["replica_bytes"] = _replica_memory()
    print(f"phase 17a wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows["17b"] = _phase_mesh_ssd(seed)
    print(f"phase 17b wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows["17c"] = _phase_mesh_moe(seed)
    print(f"phase 17c wall {time.perf_counter() - t0:.1f} s")
    n = torch.cuda.device_count()
    if n >= 2:
        t0 = time.perf_counter()
        rows["17d"] = _phase_mesh_offload(
            seed, [f"cuda:{i}" for i in range(n)], "17d")
        print(f"phase 17d wall {time.perf_counter() - t0:.1f} s")
    else:
        rows["17d"] = None
        print("phase 17d: one CUDA device is visible, so no multi-GPU "
              "number exists on this machine; every phase 17 time is one "
              "card's slots")
    rows["launches"] = {**rows["17a"]["launches"], **rows["17b"]["launches"]}
    return rows


# ---------------------------------------------------------------------------
# phase 18: the pod-axis pipeline-parallel decode and the examples' twins
# ---------------------------------------------------------------------------

#: 18a: batch, prompt, cache rows and pp steps of stablelm-1.6b
PP_BATCH, PP_PROMPT, PP_MAX_SEQ, PP_STEPS = 8, 512, 1024, 16
PP_PODS = (2, 4)
#: 18b: the fp32 smoke model's card == CPU limit, a share of each cache
#: leaf's largest element
PP_FP32_TOL = 2e-5
#: 18c: each twin's flags on the card, and the start of the last line
#: its script prints (its OK line; two scripts end on a summary line)
TWIN_RUNS = {
    "train_e2e": ([], "OK — loss decreased"),
    "serve_e2e": ([], "OK — full mamba2-130m"),
    "quickstart": ([], "OK"),
    "offloading_query": ([], "OK"),
    "batched_offloading": ([], "OK — every client"),
    "failover_offloading": ([], "OK — 6 TVs"),
    "augmented_worker": ([], "OK — gated"),
    "sharded_offloading": ([], "every TV got 10/10 answers"),
    "multicam_pubsub": ([], "OK — 4 devices"),
    "multitenant_fleet": ([], "fleet events:"),
    "lossy_fleet": ([], "OK — every TV got its 12 answers"),
}
TWIN_JOBS = 6
TWIN_TIMEOUT_S = 300


def _ms(v):
    return "not measured" if v is None else f"{v:.3f}"


def _pod_mesh(p, device):
    from repro_torch.launch.mesh import Mesh
    return Mesh(np.array([device] * p, dtype=object).reshape(p, 1, 1),
                ("pod", "data", "model"))


def _stacked_cache(cache, rows=slice(None)):
    """A stacked cache's rows, cloned (prefix and tail are empty for the
    pp archs)."""
    return {"pos": cache["pos"][rows].clone(), "prefix": [], "tail": [],
            "groups": [{k: v[:, rows].clone()
                        for k, v in cache["groups"][0].items()}]}


def _ops_off_the_card(fn):
    """Runs ``fn`` under a dispatch mode that sees every aten op -> (ops
    that took or made a CPU tensor of at least one dimension, 0-dim CPU
    tensors seen: wrapped scalars, which hold nothing the card waits on)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    bad, scalars = [], [0]

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor) and t.device.type != "cuda":
                    if t.dim() == 0:
                        scalars[0] += 1
                    else:
                        bad.append(str(func))
            return out

    with Watch():
        fn()
    return sorted(set(bad)), scalars[0]


def _event_ms(fn):
    """Stream ms of one call of ``fn``: CUDA events around it (the time
    the stream took, host gaps between its kernels included)."""
    import torch
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1)


def _phase_pp_full(seed, device="cuda", cfg=None):
    """18a: stablelm-1.6b whole (24 layers, bf16, flash attention) on
    meshes of (P, 1, 1) cuda:0 slots, P = 2 and 4.  The main path, with
    every launch count set to 0 just before it: one 512-token prompt a row
    through ``prefill_stacked`` at max_seq 1024, then 16 ``pp_serve``
    steps with the cache carried.  Hard: K6 exactly 24 P times a step and
    K5 24 times (the prefill), on the head-dim-64 kernels; each
    microbatch's tokens at every step and its cache rows bitwise
    ``decode_step_stacked`` run on that microbatch alone; the step's
    outputs on the card, and no aten op of a step on a CPU tensor.
    Reported: token agreement with the full-batch stacked step, and for
    both steps the median host ms, the stream ms of one step (CUDA
    events) and its device busy ms (the profiler's kernel time), peak
    GiB.
    Rehearse on the CPU with ``device="cpu"`` and a smoke ``cfg`` (no
    launch, device-time or dispatch checks there)."""
    import torch
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.core.buffers import tree_flatten
    from repro_torch.device import make_generator
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.launch import pp_serve as PP
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import greedy
    dev = torch.device(device)
    card = dev.type == "cuda"
    if cfg is None:
        cfg = dataclasses.replace(stablelm_1_6b.config(), use_flash_attn=True)
        check(cfg.dtype == "bfloat16" and cfg.n_layers == 24 and
              cfg.resolved_head_dim == 64, f"18a: unexpected config {cfg}")
    if card:
        _free_card()
    model = build_model(cfg)
    params = model.init_stacked(make_generator(seed, dev), dev)
    toks = torch.randint(0, cfg.vocab, (PP_BATCH, PP_PROMPT),
                         generator=make_generator(seed + 18, dev),
                         device=dev)
    sync = torch.cuda.synchronize if card else (lambda: None)
    if card:
        torch.cuda.reset_peak_memory_stats()
    out = {"launches": {}}
    for p in PP_PODS:
        mesh = _pod_mesh(p, "cuda:0" if card else device)
        check(PP.pp_applicable(model, mesh), f"18a: P={p} not applicable")
        step = PP.make_pp_serve_step(model, mesh)
        mb = PP_BATCH // p
        pp_toks, host_ms, k6_steps = [], [], []
        with torch.no_grad():
            _reset_launches()
            logits, cache = model.prefill_stacked(params, {"tokens": toks},
                                                  PP_MAX_SEQ)
            tok = greedy(logits)
            for _ in range(PP_STEPS):
                before = fa.LAUNCHES["flash_decode"]
                sync()
                t0 = time.perf_counter()
                tok, cache = step(params, tok, cache)
                sync()
                host_ms.append((time.perf_counter() - t0) * 1e3)
                k6_steps.append(fa.LAUNCHES["flash_decode"] - before)
                pp_toks.append(tok.clone())
            counts = _launch_counts()
            kernels = {k: v for k, v in fa.KERNEL_LAUNCHES.items() if v}
        row = {"flash_attention": counts["flash_attention"],
               "flash_decode": counts["flash_decode"], "by_kernel": kernels}
        out["launches"][f"P={p}"] = row
        if card:
            check(k6_steps == [cfg.n_layers * p] * PP_STEPS,
                  f"18a P={p}: K6 launches a step {k6_steps}, want "
                  f"{cfg.n_layers * p} each")
            check(kernels == {"flash_attention/sm90/64": cfg.n_layers,
                              "flash_decode/split/64":
                              cfg.n_layers * p * PP_STEPS},
                  f"18a P={p}: launches by kernel {kernels}")
        leaves = [tok] + tree_flatten(cache)[0]
        check(all(t.device == leaves[0].device == params["embed"]["tok"]
                  .device for t in leaves),
              f"18a P={p}: a step output is off the model's device")
        with torch.no_grad():
            # the references start from the prefill again (not counted)
            logits, cache0 = model.prefill_stacked(
                params, {"tokens": toks}, PP_MAX_SEQ)
            tok0 = greedy(logits)
            for m in range(p):
                rows = slice(m * mb, (m + 1) * mb)
                c, t = _stacked_cache(cache0, rows), tok0[rows].clone()
                for i in range(PP_STEPS):
                    lt, c = model.decode_step_stacked(params, t, c)
                    t = greedy(lt)
                    check(torch.equal(t, pp_toks[i][rows]),
                          f"18a P={p}: microbatch {m} step {i}: tokens "
                          f"{t.tolist()} vs pp {pp_toks[i][rows].tolist()}")
                check(torch.equal(c["pos"], cache["pos"][rows]),
                      f"18a P={p}: microbatch {m} pos")
                for k, v in c["groups"][0].items():
                    check(torch.equal(v, cache["groups"][0][k][:, rows]),
                          f"18a P={p}: microbatch {m} cache {k} not bitwise")
            # the full-batch stacked step from the same prefill
            full, t, full_ms, agree = _stacked_cache(cache0), tok0, [], 0
            for i in range(PP_STEPS):
                sync()
                t0 = time.perf_counter()
                lt, full = model.decode_step_stacked(params, t, full)
                t = greedy(lt)
                sync()
                full_ms.append((time.perf_counter() - t0) * 1e3)
                agree += int((t == pp_toks[i]).sum())
            bad, scalars, timed = [], 0, {}
            if card:
                # no aten op of a step on a CPU tensor (one more step)
                bad, scalars = _ops_off_the_card(
                    lambda: step(params, tok, cache))
                check(not bad, f"18a P={p}: ops on CPU tensors: {bad}")
                for what, fn in (
                        ("pp", lambda: step(params, tok, cache)),
                        ("full", lambda: model.decode_step_stacked(
                            params, t, full))):
                    timed[what + "_event_ms"] = _event_ms(fn)
                    timed[what + "_busy_ms"] = _profile(fn, warm=False)[1]
        out[f"P={p}"] = dict(
            host_ms=float(np.median(host_ms)),
            full_host_ms=float(np.median(full_ms)),
            cpu_scalars=scalars, agreement=agree / (PP_BATCH * PP_STEPS),
            **timed)
        r = out[f"P={p}"]
        print(f"phase 18a P={p}: {cfg.name} ({cfg.n_layers} layers, "
              f"{cfg.dtype}, flash) on ({p}, 1, 1) {mesh.devices.flat[0]} "
              f"slots, batch {PP_BATCH} ({p} "
              f"microbatches of {mb}), {PP_PROMPT}-token prompts, "
              f"{PP_STEPS} steps: every microbatch bitwise "
              f"decode_step_stacked alone (tokens every step, cache rows); "
              f"K6 {cfg.n_layers * p} a step ({counts['flash_decode']}), "
              f"K5 {counts['flash_attention']}; "
              f"{f'no op on a CPU tensor ({scalars} wrapped scalars)' if card else 'launches and ops not checked off the card'}"
              f"; token agreement with the "
              f"full-batch step {r['agreement']:.4f}; host ms a step "
              f"(median) pp {r['host_ms']:.2f} vs stacked "
              f"{r['full_host_ms']:.2f}; stream ms (events) pp "
              f"{_ms(r.get('pp_event_ms'))} vs stacked "
              f"{_ms(r.get('full_event_ms'))}; device busy ms (profiler) pp "
              f"{_ms(r.get('pp_busy_ms'))} vs stacked "
              f"{_ms(r.get('full_busy_ms'))}")
        del cache, cache0, full
    if card:
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"phase 18a peak {out['peak_gib']:.2f} GiB")
        del params
        _free_card()
    return out


def _phase_pp_cpu(seed):
    """18b: the fp32 smoke stablelm (4 layers, flash) through ``pp_serve``
    on (P, 1, 1) cuda:0 slots against the port's CPU path on (P, 1, 1)
    cpu slots, P = 2 and 4, from the same weights and prompts: 4 steps,
    tokens equal and every cache leaf within PP_FP32_TOL of its largest
    element; TF32 off."""
    import torch
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.device import make_generator
    from repro_torch.launch import pp_serve as PP
    from repro_torch.launch.spmd import to_device
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import greedy
    cfg = dataclasses.replace(stablelm_1_6b.config().smoke(), n_layers=4,
                              dtype="float32", use_flash_attn=True)
    model = build_model(cfg)
    cpu = torch.device("cpu")
    params_cpu = model.init_stacked(make_generator(seed, cpu), cpu)
    params_gpu = to_device(params_cpu, torch.device("cuda"))
    toks = torch.randint(0, cfg.vocab, (8, 24),
                         generator=make_generator(seed + 1, cpu))
    out = {}
    for p in PP_PODS:
        runs = {}
        for where, params in (("cuda:0", params_gpu), ("cpu", params_cpu)):
            step = PP.make_pp_serve_step(model, _pod_mesh(p, where))
            with torch.no_grad():
                logits, cache = model.prefill_stacked(
                    params, {"tokens": toks.to(where)}, 48)
                tok, seen = greedy(logits), []
                for _ in range(4):
                    tok, cache = step(params, tok, cache)
                    seen.append(tok.cpu())
            runs[where] = (seen, _on_cpu(cache))
        (card_t, card_c), (cpu_t, cpu_c) = runs["cuda:0"], runs["cpu"]
        check(all(torch.equal(a, b) for a, b in zip(card_t, cpu_t)),
              f"18b P={p}: tokens differ card vs CPU")
        share = _tree_share(card_c["groups"], cpu_c["groups"], "18b")
        check(share <= PP_FP32_TOL, f"18b P={p}: cache {share:.2e} of the "
                                    f"largest element, limit {PP_FP32_TOL}")
        out[f"P={p}"] = share
        print(f"phase 18b P={p}: fp32 stablelm smoke (4 layers) pp_serve "
              f"card == CPU: tokens equal over 4 steps, caches within "
              f"{share:.2e} of the largest element (limit {PP_FP32_TOL:g})")
    return out


def _phase_twins(device="cuda"):
    """18c: every twin under ``examples_torch/`` with ``--device cuda`` in
    a subprocess, TWIN_JOBS at once: exit code 0 and its last line as its
    script's, wall seconds each.  ``train_e2e`` writes its checkpoints to
    a fresh directory under ``build/``, removed afterwards.  Rehearse on
    the CPU with ``device="cpu"``."""
    import os
    import shutil
    work = ROOT / "build" / f"twins_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    queue = list(TWIN_RUNS)
    running, results = {}, {}
    t_all = time.perf_counter()
    try:
        while queue or running:
            while queue and len(running) < TWIN_JOBS:
                name = queue.pop(0)
                argv = list(TWIN_RUNS[name][0]) + ["--device", device]
                if name == "train_e2e":
                    argv += ["--ckpt-dir", str(work / "ckpt")]
                log = open(work / f"{name}.log", "w")
                proc = subprocess.Popen(
                    [sys.executable, str(ROOT / "examples_torch" /
                                         f"{name}.py"), *argv],
                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
                running[name] = (proc, log, time.perf_counter())
            for name, (proc, log, t0) in list(running.items()):
                if proc.poll() is None and \
                        time.perf_counter() - t0 < TWIN_TIMEOUT_S:
                    continue
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
                log.close()
                del running[name]
                text = (work / f"{name}.log").read_text().strip()
                lines = text.splitlines() or [""]
                results[name] = dict(rc=proc.returncode,
                                     wall_s=time.perf_counter() - t0,
                                     last=lines[-1])
                check(proc.returncode == 0,
                      f"18c {name}: exit {proc.returncode}\n{text[-3000:]}")
                check(lines[-1].startswith(TWIN_RUNS[name][1]),
                      f"18c {name}: last line {lines[-1]!r}")
                print(f"phase 18c {name}: exit 0 in "
                      f"{results[name]['wall_s']:.1f} s: {lines[-1][:100]}")
            time.sleep(0.1)
    finally:
        for proc, log, _ in running.values():
            proc.kill()
            proc.wait()
            log.close()
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 18c: all {len(results)} twins on {device} in "
          f"{time.perf_counter() - t_all:.1f} s ({TWIN_JOBS} at once)")
    return results


def phase_pp(seed):
    """Phase 18: the pod-axis pipeline-parallel decode and the examples'
    twins (module docstring)."""
    rows = {}
    t0 = time.perf_counter()
    rows["18a"] = _phase_pp_full(seed)
    print(f"phase 18a wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows["18b"] = _phase_pp_cpu(seed)
    print(f"phase 18b wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows["18c"] = _phase_twins()
    print(f"phase 18c wall {time.perf_counter() - t0:.1f} s")
    rows["launches"] = rows["18a"]["launches"]
    return rows


# ---------------------------------------------------------------------------
# phase 19: the analysis tools (M14): meta traces against the card, and the
# dry run's sweep on the one-card meta mesh
# ---------------------------------------------------------------------------

#: 19a's steps: name -> (arch, mode, batch, sequence (max_seq for a
#: decode), ModelConfig overrides, pattern units or None for every layer).
#: Cut from launch/steps.py's SHAPES (prefill_32k: 32 x 32768, decode_32k:
#: 128 slots at 32768, train_4k: 256 x 4096) to fit one card and a phase of
#: seconds: prefills of 8 x 2048 (recurrentgemma-9b 2 x 2048 and one
#: pattern unit with its 2-layer tail, 5 of 38 layers), decodes of 8 slots
#: at max_seq 4096, a train step of 8 x 2048.
DRY_STEPS = {
    "19a stablelm-1.6b flash prefill": ("stablelm-1.6b", "prefill", 8, 2048,
                                        {"use_flash_attn": True}, None),
    "19a stablelm-1.6b flash decode": ("stablelm-1.6b", "decode", 8, 4096,
                                       {"use_flash_attn": True}, None),
    "19a mamba2-130m prefill": ("mamba2-130m", "prefill", 8, 2048, {}, None),
    "19a mamba2-130m decode": ("mamba2-130m", "decode", 8, 4096, {}, None),
    "19a recurrentgemma-9b prefill": ("recurrentgemma-9b", "prefill", 2,
                                      2048, {}, 1),
    "19a mamba2-130m train": ("mamba2-130m", "train", 8, 2048, {}, None),
}
#: the kernel each 19a step must run
DRY_KERNELS = {"19a stablelm-1.6b flash prefill": "flash_attention",
               "19a stablelm-1.6b flash decode": "flash_decode",
               "19a mamba2-130m prefill": "ssd_state_scan",
               "19a mamba2-130m decode": "ssd_decode",
               "19a recurrentgemma-9b prefill": "rglru_scan",
               "19a mamba2-130m train": "ssd_state_scan_bwd"}
#: 19a: the meta trace's peak (less its arguments) against the card's
#: increase of ``max_memory_allocated`` over the step: within this share
#: of the card's plus this many bytes.  Meta calls allocate what the
#: kernels allocate (outputs and scratch); cuBLAS's workspace is allocated
#: by the warm-up run, before the peak is reset; Python's cyclic garbage
#: collector is off during both counted runs.  On the H100 the card showed:
#: inference steps within 3.9 MB (0.21%) of the meta peak, the mamba2-130m
#: train step 1.52% below it
DRY_PEAK_TOL = (0.02, 4 << 20)
#: 19b: the use_flash_attn variant's combos, beside every arch x shape
DRY_VARIANTS = (("stablelm-1.6b", "prefill_32k"),
                ("stablelm-1.6b", "decode_32k"))
DRY_JOBS = 8


def _dry_inputs(model, mode, batch, seq, device, seed):
    """A step's arguments after the parameters: meta stand-ins, or seeded
    inputs on ``device``."""
    import torch
    from repro_torch.device import make_generator
    dev = torch.device(device)
    g = None if dev.type == "meta" else make_generator(seed + 19, dev)

    def like(spec):
        if dev.type == "meta":
            return torch.empty(spec.shape, dtype=spec.dtype, device=dev)
        if spec.dtype in (torch.int32, torch.int64):
            return torch.randint(0, model.cfg.vocab, spec.shape,
                                 generator=g, device=dev, dtype=spec.dtype)
        return torch.randn(spec.shape, generator=g, device=dev) \
            .to(spec.dtype)
    specs = {k: like(v) for k, v in
             model.input_specs(mode, batch, seq).items()}
    if mode == "decode":
        return (specs["token"], model.init_cache_stacked(batch, seq, dev))
    return (specs,)


def _dry_step(model, mode, seq):
    from repro_torch.launch import steps as ST
    if mode == "train":
        return ST.make_train_step(model, None, stacked=True)
    if mode == "prefill":
        return ST.make_prefill_step(model, None, max_seq=seq, stacked=True)
    return ST.make_decode_step(model, None, stacked=True)


def _dry_run(model, mode, batch, seq, device, seed):
    """-> (the step, its arguments) on ``device``."""
    import torch
    from repro_torch.device import make_generator
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw_init
    dev = torch.device(device)
    params = ST.eval_params_shape(model, True) if dev.type == "meta" else \
        model.init_stacked(make_generator(seed, dev), dev)
    rest = _dry_inputs(model, mode, batch, seq, device, seed)
    args = (params, adamw_init(params)) + rest if mode == "train" else \
        (params,) + rest
    return _dry_step(model, mode, seq), args


def _phase_dryrun(seed, device="cuda"):
    """19a (module docstring): each step traced on meta, then run on
    ``device`` under the same counter; FLOPs, bytes and kernel calls equal
    (hard), the device's kernel calls equal its ``LAUNCHES`` delta (hard,
    0 on the CPU), the peaks within DRY_PEAK_TOL (on the card), and the
    device ms against the count's roofline terms."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import hlo_analysis as HA
    from repro_torch.models.model import build_model
    card = torch.device(device).type == "cuda"
    rows = {}
    for name, (arch, mode, batch, seq, over, units) in DRY_STEPS.items():
        cfg = dataclasses.replace(get_config(arch), **over)
        if units is not None:
            cfg = D._reduced_cfg(cfg, units)[0]
        if not card:        # the CPU rehearsal: the smoke widths
            cfg = dataclasses.replace(cfg.smoke(), **over)
            batch, seq = 2, 64
        model = build_model(cfg)
        step, args = _dry_run(model, mode, batch, seq, "meta", seed)
        meta = HA.CostCounter()
        meta.track(args)
        gc.disable()            # storages die by reference count alone,
        with meta:              # on meta and on the card alike
            step(*args)
        gc.enable()
        del step, args
        step, args = _dry_run(model, mode, batch, seq, device, seed)
        step(*args)                         # builds kernels, cuBLAS state
        if card:
            torch.cuda.synchronize()
            dev_ms = _event_ms(lambda: step(*args))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        _reset_launches()
        real = HA.CostCounter()
        real.track(args)
        gc.collect()
        gc.disable()
        with real:
            step(*args)
        gc.enable()
        if card:
            torch.cuda.synchronize()
            grown = torch.cuda.max_memory_allocated() - base
        launches = {k: v for k, v in _launch_counts().items() if v}
        for what in ("flops", "bytes"):
            check(meta.record()[what] == real.record()[what],
                  f"{name}: meta {what} {meta.record()[what]} != "
                  f"{device} {real.record()[what]}")
        check(meta.kernel_calls() == real.kernel_calls(),
              f"{name}: meta kernel calls {meta.kernel_calls()} != "
              f"{device} {real.kernel_calls()}")
        want = DRY_KERNELS[name]
        check(meta.kernel_calls().get(want, 0) > 0,
              f"{name}: {want} not booked: {meta.kernel_calls()}")
        check(launches == (real.kernel_calls() if card else {}),
              f"{name}: {device} kernel calls {real.kernel_calls()} != "
              f"LAUNCHES {launches}")
        terms = HA.roofline_terms({"flops": real.flops,
                                   "bytes accessed": real.bytes}, {}, 1,
                                  dtype=cfg.dtype)
        temp = meta.peak - meta.tracked
        row = dict(arch=arch, mode=mode, batch=batch, seq=seq,
                   layers=cfg.n_layers, flops=real.flops, bytes=real.bytes,
                   kernels=real.kernel_calls(), launches=launches,
                   meta_temp_bytes=temp,
                   counted_temp_bytes=real.peak - real.tracked,
                   compute_s=terms["compute_s"],
                   memory_s=terms["memory_s"],
                   compute_peak=terms["compute_peak"])
        line = (f"phase {name} ({cfg.n_layers} layers, {batch} x {seq}): "
                f"meta == {device}: {real.flops:.6g} FLOPs, "
                f"{real.bytes:.6g} B, kernels {real.kernel_calls()} "
                f"(== LAUNCHES {launches})")
        if card:
            share, slack = DRY_PEAK_TOL
            row.update(device_ms=dev_ms, card_temp_bytes=grown,
                       peak_share=(grown - temp) / max(grown, 1),
                       roofline_share=max(terms["compute_s"],
                                          terms["memory_s"]) * 1e3 / dev_ms)
            check(abs(grown - temp) <= share * grown + slack,
                  f"{name}: meta peak {temp} B against the card's "
                  f"{grown} B, past {share:.0%} + {slack} B")
            line += (f"; peak meta {temp} B (the {device} run's counter "
                     f"{row['counted_temp_bytes']} B) vs card {grown} B "
                     f"({grown - temp:+d} B, {row['peak_share']:+.3%} of "
                     f"the card's; tolerance {share:.0%} + {slack} B); "
                     f"device {dev_ms:.3f} ms vs compute_s "
                     f"{terms['compute_s'] * 1e3:.3f} ms ({terms['compute_peak']}) / "
                     f"memory_s {terms['memory_s'] * 1e3:.3f} ms: "
                     f"{row['roofline_share']:.1%} of the larger")
        print(line)
        rows[name] = row
        del step, args
        gc.collect()
        if card:
            torch.cuda.empty_cache()
    return rows


def _phase_dry_sweep(jobs=DRY_JOBS):
    """19b (module docstring): ``launch/dryrun.py`` over every arch x shape
    and the flash variants on the one-card meta mesh, ``jobs`` processes
    at once; none FAILED."""
    import os
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import H100_HBM_BYTES
    out = ROOT / "build" / "dryrun_card"
    out.mkdir(parents=True, exist_ok=True)
    runs = [(a, [], "") for a in ARCH_IDS] + [
        (a, ["--shape", sh, "--set", "use_flash_attn=true"], f"flash-{sh}")
        for a, sh in DRY_VARIANTS]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs, recs, t0 = [], [], time.perf_counter()
    pending = list(runs)
    while pending or procs:
        while pending and len(procs) < jobs:
            arch, extra, variant = pending.pop(0)
            path = out / f"{arch}{'-' + variant if variant else ''}.json"
            path.unlink(missing_ok=True)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--mesh", "card", "--out", str(path),
                   *extra] + (["--variant", "flash"] if variant else [])
            procs.append((subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env, cwd=ROOT), path, arch))
        proc, path, arch = procs.pop(0)
        log, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"19b {arch}: dryrun exit "
                                    f"{proc.returncode}\n{log[-3000:]}")
        recs += json.loads(path.read_text())
    wall = time.perf_counter() - t0
    want = len(ARCH_IDS) * len(ST.SHAPES) + len(DRY_VARIANTS)
    check(len(recs) == want, f"19b: {len(recs)} records, expected {want}")
    for r in recs:
        check(r["status"] in ("compiled", "skipped"),
              f"19b {r['arch']} x {r['shape']}: {r['status']} "
              f"{r.get('error', '')}")
        tag = f"{r['arch']} x {r['shape']}" + \
            (f" ({r['variant']})" if r.get("variant") else "")
        if r["status"] == "skipped":
            print(f"phase 19b {tag}: skipped ({r['reason']})")
            continue
        rf, peak = r["roofline"], r["memory"]["peak_bytes"]
        print(f"phase 19b {tag}: compiled, dominant {rf['dominant']} "
              f"(compute {rf['compute_s']:.3e} s, memory "
              f"{rf['memory_s']:.3e} s, {rf['compute_peak']}), peak "
              f"{peak / 1e9:.2f} GB of the card's "
              f"{H100_HBM_BYTES / 1e9:.0f} GB, model/count "
              f"{r['model_vs_hlo_flops']:.3f}, trace {r['analysis_s']} s")
    print(f"phase 19b: {len(recs)} combos, "
          f"{sum(r['status'] == 'compiled' for r in recs)} compiled, "
          f"{sum(r['status'] == 'skipped' for r in recs)} skipped, none "
          f"FAILED, {wall:.1f} s with {jobs} processes")
    return {"records": recs, "wall_s": wall}


def phase_dryrun(seed):
    """Phase 19: the analysis tools (module docstring)."""
    rows = {}
    t0 = time.perf_counter()
    rows["19a"] = _phase_dryrun(seed)
    print(f"phase 19a wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows["19b"] = _phase_dry_sweep()
    print(f"phase 19b wall {time.perf_counter() - t0:.1f} s")
    rows["launches"] = {}
    for r in rows["19a"].values():
        for k, v in r["launches"].items():
            rows["launches"][k] = rows["launches"].get(k, 0) + v
    return rows


def _to_numpy(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full-width prefill, one decode "
                         "tick, 8 offload ticks per codec, one pub/sub "
                         "burst tick, and one recurrentgemma-9b prefill "
                         "and decode tick")
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    import repro_torch  # noqa: F401  (fails at once outside a checkout)
    import torch
    from repro_torch.kernels import flash_attn as fa
    clock = [time.perf_counter()]

    def wall(what):
        now = time.perf_counter()
        print(f"phase {what} wall {now - clock[0]:.1f} s")
        clock[0] = now

    smi = phase_env()
    build_s, ptxas = phase_build()
    wall("1-2")
    table = phase_kernels(args.seed, ptxas)
    codec_table = phase_codec_kernels(args.seed)
    scan = phase_scan_kernel(args.seed)
    wall("3")
    serve, srv, serve4 = phase_serve(args.seed)
    profile = phase_profile(srv, args.seed) if args.profile else None
    wall("4-5")
    offload, answers6 = phase_offload(args.seed, profile=args.profile)
    wall("6")
    pubsub = phase_pubsub(args.seed, answers6["quant8"],
                          profile=args.profile)
    del srv                         # phase 8 needs the card's memory
    wall("7")
    rglru = phase_rglru_serve(args.seed, profile=args.profile)
    wall("8")
    graphs = phase_graphs(args.seed, {**serve4, **serve}, offload, answers6)
    wall("9")
    failover = phase_failover(args.seed)
    wall("10")
    staged = phase_staged(args.seed, serve4)
    wall("11")
    qos = phase_qos(args.seed)
    wall("12")
    lossy = phase_lossy(args.seed, serve4, answers6, staged)
    del answers6
    wall("13")
    zoo = phase_zoo(args.seed, ptxas)
    wall("14")
    ssd = phase_ssd(args.seed, ptxas)
    wall("15")
    trained = phase_train(args.seed, ptxas)
    wall("16")
    meshed = phase_mesh(args.seed)
    wall("17")
    pp = phase_pp(args.seed)
    wall("18")
    dry = phase_dryrun(args.seed)
    wall("19")

    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    rows = [  # name, source, TPU kernel, timing row, launches on its path
        ("quantize8", "quant8.cu", "src/repro/kernels/quant8.py:41",
         codec_table["quantize8"], offload["quant8"]["launches"]),
        ("dequantize8", "quant8.cu", "src/repro/kernels/quant8.py:62",
         codec_table["dequantize8"], offload["quant8"]["launches"]),
        ("sparse_enc", "sparse_enc.cu", "src/repro/kernels/sparse_enc.py:55",
         codec_table["sparse_enc"], offload["sparse:0.15"]["launches"]),
        ("sparse_dec", "sparse_dec.cu", "src/repro/kernels/sparse_dec.py:43",
         codec_table["sparse_dec"], offload["sparse:0.15"]["launches"]),
        ("flash_attention", "flash_prefill_sm90.cu",
         "src/repro/kernels/flash_attn.py:70", table["K5 L=512"],
         serve["launches"]),
        ("flash_decode", "flash_decode.cu",
         "src/repro/kernels/flash_attn.py:110",
         table["K6 S=8 max_seq=1024"], serve["launches"]),
    ]
    rows.append(("rglru_scan", "rglru_scan.cu",
                 "src/repro/models/rglru.py:85", scan, rglru["launches"]))
    # S2 and S3 on the main path of phase 15: launch/serve.py (15b)
    rows.append(("ssd_state_scan", "ssd_scan.cu",
                 "src/repro/models/ssm.py:123", ssd["15a"]["S2"],
                 ssd["15b"]["launches"]))
    rows.append(("ssd_decode", "ssd_decode.cu",
                 "src/repro/models/ssm.py:181", ssd["15a"]["S3"],
                 ssd["15b"]["launches"]))
    # the scans' backward kernels on the training path: S1's in 16c, S2's
    # in 16b (its resumed run)
    rows.append(("rglru_scan_bwd", "rglru_scan.cu",
                 "src/repro/models/rglru.py:85",
                 trained["16e"]["rglru_scan_bwd"], trained["16c"]["launches"]))
    rows.append(("ssd_state_scan_bwd", "ssd_scan.cu",
                 "src/repro/models/ssm.py:123",
                 trained["16e"]["ssd_state_scan_bwd"],
                 trained["16b"]["launches"]))
    # K5 bf16 and K6 bf16 at head dims 128 and 256 run kernels of their
    # own on phase 14's serve path (14b granite-20b, 14c gemma3-4b): the
    # warp-specialised prefill and the grouped-head decode
    by_kernel = zoo["launches_by_kernel"]
    wide = {"flash_attention_ws": sum(
        v for k, v in by_kernel.items() if "/sm90_ws/" in k),
        "flash_decode_gqa": sum(v for k, v in by_kernel.items()
                                if "/gqa_" in k)}
    rows.append(("flash_attention_ws", "flash_prefill_sm90.cu",
                 "src/repro/kernels/flash_attn.py:70",
                 zoo["14a"]["K5 bf16 d=128 L=1024"], wide))
    rows.append(("flash_decode_gqa", "flash_decode_gqa.cu",
                 "src/repro/kernels/flash_attn.py:110",
                 zoo["14a"]["K6 bf16 d=128 S=8 max_seq=1024"], wide))
    # K5 fp32 and K6 fp32 at head dims 128 and 256 run kernels of their own
    # on 14f's fp32 model path (granite-20b and gemma3-4b cut in depth,
    # the smoke presets): the tiled persistent prefill, the f32 grouped
    # decode
    f32_by_kernel = zoo["14f"]["launches_by_kernel"]
    f32_wide = {"flash_attention_f32_wide": sum(
        v for k, v in f32_by_kernel.items() if "/scalar_wide/" in k),
        "flash_decode_gqa_f32": sum(v for k, v in f32_by_kernel.items()
                                    if "/gqa_f32/" in k)}
    rows.append(("flash_attention_f32_wide", "flash_prefill.cu",
                 "src/repro/kernels/flash_attn.py:70",
                 zoo["14a"]["K5 fp32 d=128 L=1024"], f32_wide))
    rows.append(("flash_decode_gqa_f32", "flash_decode_gqa.cu",
                 "src/repro/kernels/flash_attn.py:110",
                 zoo["14a"]["K6 fp32 d=128 S=8 max_seq=1024"], f32_wide))
    # S4 and S5 carry every norm and rotary of the model step: phase 14's
    # serve runs count them (14b-14e), 14g times them at granite-20b's and
    # stablelm-1.6b's shapes
    norm_rope = {k: sum(v[k] for v in zoo["launches_norm_rope"].values())
                 for k in ("norm", "rotary")}
    rows.append(("norm", "norm.cu", "src/repro/models/layers.py:41",
                 zoo["14g"]["S4 granite prefill"], norm_rope))
    rows.append(("rotary", "rotary.cu", "src/repro/models/layers.py:63",
                 zoo["14g"]["S5 granite prefill"], norm_rope))
    csrc = "src/repro_torch/kernels/csrc/"
    kernels = [{"name": name, "route": "cuda", "source": csrc + src,
                "replaces": where, "launches": launches[name],
                **{k: row[k] for k in timed}}
               for name, src, where, row, launches in rows]
    kernels[6]["note"] = ("new kernel, not a TPU port: takes the place of "
                          "jax.lax.associative_scan")
    kernels[7]["note"] = ("new kernel, not a TPU port: takes the place of "
                          "the jax.lax.scan over chunks in _ssd_scan "
                          "(src/repro/models/ssm.py:115-123)")
    kernels[8]["note"] = ("new kernel, not a TPU port: fuses ssm_decode's "
                          "state update and readout "
                          "(src/repro/models/ssm.py:181-190)")
    kernels[9]["note"] = ("new kernel, not a TPU port: the backward of "
                          "rglru_scan, where the JAX package differentiates "
                          "its associative_scan")
    kernels[10]["note"] = ("new kernel, not a TPU port: the backward of "
                           "ssd_state_scan, where the JAX package "
                           "differentiates its lax.scan")
    for row in kernels[9:11]:
        row["ptxas"] = trained["16e"][row["name"]]["ptxas"]
        row["shape"] = trained["16e"][row["name"]]["shape"]
    # the forward scans run on the training path too: 16c's and 16b's counts
    kernels[6]["launches_phase16"] = trained["16c"]["launches"]["rglru_scan"]
    kernels[7]["launches_phase16"] = trained["16b"]["launches"][
        "ssd_state_scan"]
    for row, key in ((kernels[7], "S2"), (kernels[8], "S3")):
        row["ptxas"] = ssd["15a"][key]["ptxas"]
        row["shape"] = ssd["15a"][key]["shape"]
        row["launches_phase15c"] = ssd["15c"]["launches"][row["name"]]
        row["launches_phase15e"] = ssd["15e"]["launches"][row["name"]]
    # K3: the cold-L2 time, one stacked encode, and the passes it absorbed
    for k in ("cold_ms", "stacked_ms", "removed_glue_ms"):
        kernels[2][k] = codec_table["sparse_enc"][k]
    kernels[2]["route_launches"] = offload["sparse:0.15"]["enc_routes"]
    # K5's two routes: the row above is the bf16 one that the serve path runs
    kernels[4]["sources"] = {"bfloat16": csrc + "flash_prefill_sm90.cu",
                             "float32": csrc + "flash_prefill.cu"}
    kernels[4]["float32_route"] = {
        k: table["K5 fp32 L=512"][k]
        for k in timed + ("bytes_bound_ms",)}
    # K1–K4 also carry the pub/sub path (7b): its own launch counts
    for row in kernels[:4]:
        row["launches_phase7"] = pubsub["7b"]["launches"][row["name"]]
    # K1/K2 (10b) and K5/K6 (10a, 10c) carry failover and the hot swap
    for row in kernels[:2] + kernels[4:6]:
        row["launches_phase10"] = failover["launches"][row["name"]]
    # K5/K6 carry staged serving (11a–11d) and the QoS fleet (12a, 12b)
    for row in kernels[4:6]:
        row["launches_phase11"] = staged["launches"][row["name"]]
        row["launches_phase12"] = qos["launches"][row["name"]]
    # K1–K4 carry the lossy offload (13b), K5/K6 the lossy serve, the
    # lossy hops and the clean-link twins (13a, 13c, 13d)
    for row in kernels[:6]:
        row["launches_phase13"] = lossy["launches"][row["name"]]
    # K5/K6 at head dims 128 (granite-20b) and 256 (gemma3-4b's global
    # layers): phase 14's launches by dim (14b-14e) and 14a's timings
    for row in kernels[4:6]:
        row["head_dims"] = list(fa.KERNEL_HEAD_DIMS)
        row["launches_phase14"] = {
            k.partition("/")[2]: v for k, v in
            zoo["launches_by_head_dim"].items()
            if k.startswith(row["name"] + "/")}
        row["by_head_dim"] = {
            name: {k: r[k] for k in timed + ("ptxas",)}
            for name, r in zoo["14a"].items()
            if name.startswith("K5" if row["name"] == "flash_attention"
                               else "K6")}
    # the head-dim 128/256 kernels: every 14a row of theirs, launches by
    # kernel and head dim (14b-14e)
    for row, k, prefix in ((kernels[11], "sm90_ws", "K5 bf16"),
                           (kernels[12], "gqa_", "K6 bf16")):
        row["note"] = ("K5 bf16 at head dims 128 and 256: warp-specialised "
                       "(a TMA producer warp, two consumer warpgroups)"
                       if k == "sm90_ws" else
                       "K6 bf16 at head dims 128 and 256: a block reads "
                       "each K/V row once for the group's query rows")
        row["launches_phase14"] = {
            n: v for n, v in by_kernel.items() if f"/{k}" in n}
        row["by_shape"] = {
            name: {f: r[f] for f in timed + ("ptxas", "kernel")}
            for name, r in zoo["14a"].items() if name.startswith(prefix)}
    for row, k, prefix in ((kernels[13], "scalar_wide", "K5 fp32"),
                           (kernels[14], "gqa_f32", "K6 fp32")):
        row["note"] = ("K5 fp32 at head dims 128 and 256: persistent "
                       "blocks, items packing a kv group's heads, f32 "
                       "register tiles" if k == "scalar_wide" else
                       "K6 fp32 at head dims 128 and 256, groups over 2: a "
                       "block reads each K/V row once for the group's "
                       "query rows, f32 register tiles")
        row["launches_phase14f"] = {
            n: v for n, v in f32_by_kernel.items() if f"/{k}/" in n}
        row["by_shape"] = {
            name: {f: r[f] for f in timed + ("ptxas", "kernel")}
            for name, r in zoo["14a"].items() if name.startswith(prefix)}
    # K1–K4 carry the sharded offload (17a), S2 and its backward the
    # sequence-parallel prefill and train step (17b)
    for row in kernels[:4] + [kernels[7], kernels[10]]:
        row["launches_phase17"] = meshed["launches"][row["name"]]
    # K5 (the prefill) and K6 (24 P a step) carry the pod-axis
    # pipeline-parallel decode (18a), by pod count
    for row in kernels[4:6]:
        row["launches_phase18"] = {
            k: v[row["name"]] for k, v in pp["launches"].items()}
    for row, prefix, what in ((kernels[15], "S4", "apply_norm's"),
                              (kernels[16], "S5", "apply_rope's")):
        row["note"] = (f"new kernel, not a TPU port: takes the place of "
                       f"the eager chain of {what} expression "
                       f"(src/repro_torch/models/layers.py), which XLA "
                       f"fuses in the JAX package")
        row["ptxas"] = zoo["14g"][f"{prefix} granite prefill"]["ptxas"]
        row["by_shape"] = {
            name: {f: r[f] for f in timed + ("ptxas",)}
            for name, r in zoo["14g"].items() if name.startswith(prefix)}
        row["launches_phase14"] = {
            preset: v[row["name"]]
            for preset, v in zoo["launches_norm_rope"].items()}
        row["launches_phase4"] = serve["norm_rope_launches"][row["name"]]
    for name, r in zoo["14g"].items():
        if name.startswith("S5"):
            kernels[16]["by_shape"][name].update(
                {k: r[k] for k in ("q", "k", "freqs", "launches",
                                   "strides")})
        if name.startswith("S4"):
            kernels[15]["by_shape"][name].update(
                {k: r[k] for k in ("ulps", "library", "library_ulps",
                                   "library_rows_alone_bitwise",
                                   "library_refused", "library_warning",
                                   "library_bf16_weights_ms") if k in r})
    # K5, K6, S1–S5 and S2's backward under 19a's counter (meta == card)
    for row in kernels[4:11] + kernels[15:17]:
        if row["name"] in dry["launches"]:
            row["launches_phase19"] = dry["launches"][row["name"]]
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"nvidia_smi": smi, "build_s": build_s,
                                   "ptxas": ptxas,
                                   "kernels": table,
                                   "codec_kernels": codec_table,
                                   "serve": serve, "profile": profile,
                                   "offload": offload, "pubsub": pubsub,
                                   "scan_kernel": scan,
                                   "rglru_serve": rglru,
                                   "graphs": graphs,
                                   "failover": failover,
                                   "staged": staged, "qos": qos,
                                   "lossy": lossy, "zoo": zoo, "ssd": ssd,
                                   "train": trained, "mesh": meshed,
                                   "pp": pp, "dryrun": dry},
                                  indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
