#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # one NVIDIA H100; builds the kernels

Phases, each fatal on failure (nothing here catches an error):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build: every CUDA source of the port compiled with ``nvcc``, one
   process per source, all started together; then the card-only tests
   (`tests/test_torch_card.py`, marker ``cuda``) in a pytest process of
   their own, every one of which must pass;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs — a few dozen small cases with ragged M/N/K (and, for the
   single GEMM and the split-K and Stream-K kernels, every ``ta``/``tb``
   layout; split 2-8 with wholly empty slices, held to the plain partials
   and reduce and run twice for the same bits; Stream-K, one launch, with
   G from 1 to more workgroups than MAC iterations, held to
   `stream_k_matmul_ref` at the card's geometry and run twice for the
   same bits; the grouped and ragged kernels
   with their weights in each pointer form — one stacked tensor,
   per-member tensors with one weight shared, per-member transposed
   views — and with more members than the pointer table holds; every
   GEMM kernel also with float32 output from bf16 operands; `matmul` on
   both of its feeds, TMA boxes and the `cp.async` ring, each of which
   must run), then the serving path's shapes, where the kernel, its plain
   version and the one PyTorch call computing the same function are
   timed with CUDA events.  `matmul` is timed at the four Qwen3-14B
   decode shapes 8 x {34816, 17408, 5120, 1024} x 5120 on the feed the
   rule gives them (TMA) and, on the same values through an odd-offset
   view of A, on the ring feed, both held to the plain version, with the
   TMA instantiation's residency.
   `stream_k_matmul` is held to its plain version at the card's geometry
   (`card_geometry`: CTA tiles from M, W workgroups from the planner's G,
   the SM count and the kernel's occupancy) and timed on four rotating
   operand sets beside `torch.matmul`; its grid, run layout and
   workspace are printed, and a planted fault (one run's sum dropped
   from one cut tile) must fail its check; so are the ragged walk's (CTAs per SM and shared
   memory from the occupancy query, tiles, iterations per CTA) and, for
   the ring-fed grouped and split-K kernels at their timed shapes, the
   residency: CTAs, resident slots (CTAs per SM × SMs; for split-K also
   the resident clusters), waves, dynamic shared memory and bytes in
   flight per SM;
4. per-class serving: a full-width, full-depth Qwen3-14B weight set (40
   layers × the four fused bf16 decode GEMMs, ~26.4 GB, random from a
   seed) served through the port's `Runtime` to tenants at batches
   [8, 8, 8, 8] (grouped launches) and [4, 8, 8, 8, 16] (ragged
   launches), each window run twice (cold plan cache, then warm); every
   result is held against the plain version, and the launch counters,
   zeroed just before the first window, must show the single, grouped
   and ragged kernels, and no `matmul` launch on the ring feed (every
   serving shape is aligned bf16, which takes the TMA feed; the same
   holds in phases 5 and 7).  Then, with those weights still on the card,
   the dynamic logic, whose launches are counted apart (the counters are
   zeroed after it): (a) the logistic CD predictor trained on the card on
   the paper's dataset (1,072 pool GEMMs profiled against the GO library,
   a seeded 90/10 split), held to the same training on the CPU from the
   same initial weights (W within 1e-4·max(1, |W|), equal CDs), with its
   training seconds and held-out accuracy at 2/4/8/16 available GEMMs;
   (b) both windows, cold then warm, served through a runtime whose
   controller plans with that predictor, every result held against the
   plain version, each class's launches (CD, mode) printed beside the
   oracle controller's plan of the same queue; (c) the four fused decode
   GEMMs at batch 8 measured by the harness (`core/measure.py`: CUDA
   events around each launch, median of 5 after a warmup) at CD 1, 2, 4,
   8 and 16, beside the library's modeled CD and the predictor's, and
   the attention-out GEMM re-ranked by measurement (`tune_gemm(...,
   measure=)`), its entry saved to a library file and loaded back with
   its measured times and backend tag.  Every measured time must be
   finite; the times themselves are printed, not gated;
5. bundle (mixed) serving: the fused weights freed, the seven unfused
   decode GEMMs of every layer (q, k, v, o, gate, up, down; the same
   26.4 GB) submitted per tenant and layer as one bundle
   (`Runtime.submit(sequence)`), flushed per layer, in three windows —
   one tenant at batch 1 with 16 slots available, tenants [4, 8, 8, 16]
   with 4, and the same with 2 — each cold then warm, plus one planned
   mixed schedule that carries Stream-K members; every result is held
   against the plain version, and the counters, zeroed before the first
   of these windows, must show the single, split-K (one launch per
   split-K GEMM planned, no partials, no reduce launch), and Stream-K
   (one launch per Stream-K GEMM planned, no fixup launch) kernels.
   Then each warm window's launches run again, concurrently on streams, back to back on one
   stream at the same tiles, and back to back at the isolated tiles,
   each timed on the card: the concurrent-versus-sequential ratios are
   printed, not gated; and each window runs once more under the
   profiler, which counts its split-K and Stream-K launches beside the
   GEMMs planned and finds no reduce and no fixup kernel;
6. attention and scan kernels: both attention routes (the prefill
   kernel for bf16 prefills, the split-KV kernel for the rest, each case
   checked to have launched on the route `attention_route` names) and
   both scan routes (the decode kernel at T = 1, the chunked form's three
   passes otherwise, each case checked to have launched on the route
   `scan_route` names)
   against their plain versions on small cases (GQA and MHA,
   causal with ``q_offset``, a window, S not a multiple of ``bkv``,
   prefill, a windowed prefill, D 80, dv ≠ dqk, strided q/k/v, bf16 and
   f32; T not a multiple of the chunk, chunks 8-512, a nonzero initial
   state, a head-broadcast B/C view, decode steps with and without a
   state, per-head B/C, rows not 16-byte groups, N and P to 512 on the
   wide passes and the decode kernel's wide instantiation, held within
   the scan tolerance plus 2⁻¹⁶ of the terms' magnitude), then timed at the path's shapes beside their
   plain versions and, for attention, PyTorch's
   ``scaled_dot_product_attention``: Qwen3-14B's tenant-16 member and
   its batch-1 member, each with its grid (CTAs, kv splits) and shared
   memory printed.  Two planted faults must fail the attention check:
   the kernel without one 64-key sub-tile (tenant 16), and the kernel's
   split partials merged without one split (batch 1, 16 splits; the same
   merge with every split must match the kernel's own output).  The
   scan's decode rows — Zamba2's tenant-16 member without and with an
   initial state, and its batch-1 member — are timed on output (and
   state) sets rotating beyond the 50 MB L2, with the decode grid (CTAs,
   pairs per CTA, column slices, CTAs per SM, shared memory); a planted
   fault (one pair's B xdᵀ term dropped from the state) must fail the
   scan check, and a ``copy_`` of the state into the rotating buffers is
   printed as the card's write ceiling at that size.  Zamba2-1.2B's
   4,096-token prompt scan (B1 T4096 H64 P64 N64 L128, B/C
   head-broadcast) runs on the chunks route in bf16 and f32: y, the state
   and the workspace's carried states held to the plain versions, a
   planted lost carry (the middle chunk's incoming state taken as zero)
   that must fail the scan check, each pass's CTAs, occupancy, waves and
   shared memory printed, timed on input, output and workspace sets
   rotating beyond the L2.  DeepSeek-V2-Lite-16B's
   attention (16 heads of 192 over 2,048 keys, MLA in materialized
   form, on the 256-wide instantiation) is held and timed the same way
   at batches 16 and 1.  Before the kernel rows, `grouped_for_desc` is
   held to its plain version at every bm of `GROUPED_TILES` on
   DeepSeek's batch-16 pools (64 experts, 4 launches each), and
   `ragged_matmul` is timed at DeepSeek's pools (G 64 at batch 16, G 6
   at batch 1, up and down) beside `torch.bmm` on equal padded groups.
   Then Zamba2-1.2B's prompt scan through the runtime, its launches
   counted per layer (zeroed just before, read just after): per layer
   (38) its own xd and da and group-shared B/C views,
   `ScanDesc(1, 4096, 64, 64, 64)` as a one-member bundle, drained; each
   must launch the chunks route once, its y must be within the scan
   tolerance, the same inputs launched again must give the same y bits
   and a final state within it, and the runtime must show no fault or
   fallback.  The layers' device time is printed as the runtime's CUDA
   events bracket each attempt and for the same launches queued behind a
   sleep of the card (`probes/scan_chunks/ab.py TREE LABEL`, run in the
   same call on a checkout of the parent commit, gives the parent's
   per-launch time beside it).  The kernels line counts `mamba_scan`'s
   calls on both of its paths, the op bundles (phase 7) and these prompt
   scans: one per call, which on the chunks route is three kernel
   launches (state, carry, output), on the decode route one;
7. op-bundle serving: for Qwen3-14B (20 of 40 layers, context 4,096),
   Zamba2-1.2B (19 of 38 layers, context 2,048) and DeepSeek-V2-Lite-16B
   (14 of 27 layers; `OP_LAYERS`, context 2,048), at full width, every layer's whole
   decode-step bundle (`decode_step_op_descs`: the GEMMs, the attention
   read over the KV cache, for Zamba2 the SSD state update, for
   DeepSeek the two expert pools) submitted per tenant as one bundle and
   flushed per layer, with random bf16 weights, queries and KV caches
   from a seed; one tenant at batch 1 with 16 slots, then tenants
   [4, 8, 8, 16] with 4, each cold then warm.  DeepSeek's layers hold
   one (64, 2048, 1408) up and one (64, 1408, 2048) down expert tensor
   (19.9 GB in all); each tenant's pools read a seeded choice of G
   distinct experts by pointer, and the bundle's dense per-expert GEMMs
   (ROADMAP C11) are views into the same tensors.  Every result is held
   against its plain version, and the counters, zeroed before the
   phase, must show exactly one attention launch per attention member
   and one scan launch per scan member, every scan launch on the decode
   kernel, and in every window exactly the `ragged_matmul` launches
   `ragged_chunks` gives each grouped member at its planned tile.  Each warm
   window is then timed concurrently and back to back (as in phase 5)
   and profiled once.  Then graph serving on the same weights and KV
   caches, its launches counted apart (`graph_part`): per tenant one
   `decode_step_graph` over every layer, each node's static operands
   attached by name (each layer's roots the layer input, every GEMM its
   weight, the attention its KV cache, the scan its inputs; every other
   slot arrives by a data edge), in the same two windows: all tenants'
   graphs submitted and drained, cold, then warm after `prewarm(graph)`;
   then the same graphs' waves as barriered bundles, tenant after tenant
   (the reference's baseline).  Fatal: every node within its family's
   tolerance of its plain version on the operands it was given; every
   data edge's consumer operand a view of its producer's output (the
   same storage); every node launched in a later flush than each of its
   producers; every graph completed; each run's launches equal to the
   planner's in shadow mode; one attention launch per attention node
   and one decode-kernel scan launch per scan node; each run's
   `ragged_matmul` launches as `ragged_chunks` gives its grouped nodes;
   no fault, no fallback, no `matmul` on the ring feed.  Printed, not gated, for
   graph and waves side by side: launches by mode, mean CD, flushes,
   launches mixing graphs, ready-set depths, plan-cache hits, device
   time (the attempts' CUDA events) and wall time;
8. self-correction, run after phase 5 on phase 5's unfused weights and
   phase 4's fused weights made again from phase 4's seed (phase 4's
   own are freed before phase 5, as they were before this phase
   existed), its launches counted apart:
   (a) the calibrator — both per-class windows served twice through a
   `ConcurrencyController(calibrator=CostCalibrator())` (its own
   library), each flush's queued re-tunes run by `process_retunes`
   after it (host seconds, entries re-tuned, GO tiles or preferred CDs
   changed), each (family, class)'s n, factor and drift; the op-bundle
   and GEMM-bundle windows planned with the calibrated controller beside
   an uncalibrated one (launches whose chunk, CD or mode differ), the
   §6.11 QKV choice at batches 1, 8 and 16 with and without it, and one
   calibrated GEMM-bundle window served and held to the plain version;
   (b) the fallback ladder — rules whose every p is 0 against no
   injector on the same requests (same tiles, bitwise-equal results,
   same launch counts); seeded raise and nan faults over the per-class
   window [8, 8, 8, 8] and the op-bundle window [1] at 16 slots, every
   result held to its plain version and the telemetry's faults equal to
   the injector's log by kind; every attempt raising, so every launch
   completes on the reference rung, whose kernel launches are printed;
   and `process_retunes` past the cooldown, whose probes must equal the
   quarantines.  Every runtime of phases 4, 5, 7, 8 and 9 with no
   injector must show no fault and no fallback (`check_healthy`);
9. SLO serving, run after phase 8 on phase 5's unfused weights (before
   phase 7, whose weights would not fit beside them), its launches
   counted apart: a 4,096-token prompt of Qwen3-14B at full width on 10
   of its 40 layers (`SLO_LAYERS`; tenant ``prefill``, batch class,
   weight 1, p99 target 1 s)
   beside decode traffic (tenant ``decode``, latency class, weight 4,
   p99 target 20 ms).  Per layer ℓ, at ℓ ms on the runtime's clock: the
   prompt's seven GEMMs at M = 4096, each submitted alone, and its causal
   attention (1 × 40 heads over 4,096 keys) as a one-member bundle; the
   decode tenant's whole decode-step bundle at batch 8 over 4,096 cached
   tokens (KV caches from a seed, 5.4 GB); one forced flush; a drain at
   the end.  Two windows: (A) round-robin, no slicing, no budget; (B)
   EDF, admission slicing, a 1 ms flush budget (half of it the slicing
   threshold), at most 8 pieces.  Every result is held to its plain
   version (GEMMs, merged parents of the parent's shape, attention,
   decode members); the pieces a layer must be the planner's (34 queue
   entries a layer in B: q and o in 3, gate, up and down in 8, the
   attention in 2 query-row pieces, k and v whole), and B must defer
   launches past its budget where A defers none.  Printed, not gated: per
   window the launches by mode, kernel launches by kernel, `matmul`
   launches by feed, pieces per op, deferred launches, each decode
   bundle's device-time completion (the CUDA-event times of the
   launches up to the one that completes it, summed in launch order; p50
   and max over the layers), the prompt's device time and the window's
   wall time, each sliced parent's merge (`torch.cat`, run again on its
   pieces and timed by CUDA events), the device time by what each launch
   carried, and the host stalls (`HostStalls`); then each window runs
   once more under the profiler (kernel time by kind, the idle share).
   Then one prompt layer with integer-valued weights and activations
   through both windows' runtimes, where every sliced GEMM's merged
   result must equal the unsliced run bitwise, and a batch-sliced
   Zamba2-width scan (`ScanDesc(4, 1024, 64, 64, 64)`, one-member
   bundle) whose pieces must launch the chunks route and whose merged y
   must be within the scan tolerance;
10. the models, after phase 7 with its weights freed, through the entry
   points a user calls (`build_model`, `greedy_decode`,
   `repro_torch.launch.serve.main`): (a) Qwen3-14B at 2 layers,
   Zamba2-1.2B at 6 (its shared attention block runs once) and
   DeepSeek-V2-Lite-16B at 2 (its dense layer and one MoE layer), full
   width, float32, weights from a seed on the card copied to the CPU; a
   batch-2, 64-token prompt and 4 greedy steps on the card, the card's
   tokens teacher-forced on the CPU (the plain versions): every call's
   logits within MODEL_TOL, the kernels' launches exact; (b) each model
   at full width and depth in bf16 (weights and caches), batch 4,
   1,000-token prompts, 32 greedy steps, with the plain versions of
   attention, the scan and the grouped GEMM made to raise for the whole
   run: tokens in range, logits finite at every call, the launches exact
   (flash attention once per attention layer per prefill, on the
   prefill route (``flash_prefill``) in bf16 and on the decode route in
   f32, and never in decode; `mamba_scan` once per Mamba layer on the
   chunks route per
   prefill and on the decode kernel per layer and step; per forward
   three grouped GEMMs per MoE layer, one `grouped_matmul` launch per
   16 experts), the prefill's and the decode steps' times (CUDA events:
   the device's timeline, host gaps included; the median step) and
   tokens/s printed beside their bounds (`serve_bounds`); one warm-up
   run first.  (c) `repro_torch.launch.serve.main` on Zamba2-1.2B at
   full width in f32, `--runtime --graph`, its launches exact.  (b)'s
   launches are the kernels line's ``model_serve`` path.  Then the
   kernel rows at the models' prefill shapes, on the prefill route, each
   with its grid, shared memory and CTAs per SM; at Qwen3-14B's, two
   planted faults (a walk that skipped one kv tile, a q block's diagonal
   tiles unmasked) must fail the attention check.
   10d. the model zoo, the seven other architectures through the same
   entry points (MusicGen, whose step takes a frame, by `Model.prefill`
   and `Model.decode_step` on seeded frames: `greedy_decode` refuses it):
   (a) full width, f32, card against CPU as in (a) above: StableLM-3B,
   Qwen2-72B, DeepSeek-V2-236B, MusicGen-medium and Pixtral-12B at 2
   layers, xLSTM-350M at 8 (2 groups of 3 mLSTM layers and an sLSTM
   layer), Gemma3-27B at 6 (5 local, 1 global) with its window cut from
   1,024 to 64 so that the 96-position prompt crosses it; Pixtral's
   prompt is its 256 patches and 64 tokens; (b) each at full width in
   bf16, batch 4, 1,000-position prompts (Gemma3's 2,048: its local
   layers mask; Pixtral's 256 patches and 744 tokens), 8 greedy steps,
   the plain versions raising: full depth for xLSTM-350M, MusicGen-medium,
   StableLM-3B, Pixtral-12B and Gemma3-27B, 8 of Qwen2-72B's 80 layers, 4
   of DeepSeek-V2-236B's 60 (its dense layer and 3 MoE layers), each
   freed before the next: launches exact (`mamba_scan` 36 a prefill on
   the chunks route and 36 a step on the decode kernel for xLSTM, two
   per mLSTM layer), times beside `serve_bounds` (xLSTM's state bytes and
   f32 scans, windowed attention's keys), xLSTM's and Gemma3's prefill
   and 2 steps profiled (with the host time in xLSTM's sLSTM loops).
   Then the new kernel shapes: the five new prefill attention shapes
   (Gemma3's windowed beside SDPA with the window as a mask),
   DeepSeek-V2-236B's grouped up-projection, and xLSTM's scans at N =
   512 (its memory P = 512 and normaliser P = 1, a prompt on the wide
   chunked passes, a step on the decode kernel's wide instantiation; a
   planted dropped N block must fail the check).  (b)'s launches are the
   kernels line's ``model_zoo`` path;
11. training, after phase 10 with its weights freed, with the plain
   versions of attention, the scan and the grouped GEMM raising on the
   card everywhere but inside the backward of their autograd Functions
   (where each call is a VJP's recompute, counted): the GEMM backward
   (`gemm`'s `Gemm` Function) at 8 x 5120 x 5120, bf16 and f32, all four
   layouts, one tile of each decomposition, against its plain version;
   (a) one f32 `make_train_step` step at full width on the card and on
   the CPU from the same masters, Qwen3-14B at 2 layers and Zamba2-1.2B
   at 6 (on the rescaled tree, and on its init as drawn reported beside
   the CPU's own one-ulp sensitivity): loss, gradient norm and every
   leaf's gradient within GRAD_TOL, masters within MASTER_TOL where |g|
   is above its tolerance, launches and recomputes exact; (b) bf16
   compute with f32 masters: Zamba2-1.2B at full depth through
   `repro_torch.launch.train.main` (batch 4, 512 tokens, 8 steps; its
   checkpoints and a resumed run are phase 12b's), and Qwen3-14B at 2
   of 40 layers through `build_model`,
   `train_init` and `make_train_step` for 8 steps: losses and gradient
   norms finite, launches exact (per step `flash_attention` once per
   attention layer, `mamba_scan` once per Mamba layer on the chunks
   route, no grouped launch; one VJP recompute each), the median step
   time of steps 3-8 (CUDA events), tokens/s, peak memory and the bound
   (`train_bound`), one step each under the profiler.  (b)'s launches
   are the kernels line's ``train`` path;
12. distribution, after phase 11, the plain versions raising outside
   their VJPs in (a) and (b): (a) remat: Zamba2-1.2B at full width and
   depth (``remat="full"``) and Qwen3-14B at 2 of 40 layers (``"dots"``),
   bf16 compute, batch 4 × 512, one step without and one with from the
   same fresh state, twice in turns: loss bitwise, every gradient leaf
   within REMAT_TOL (the bitwise leaves counted), peak memory
   (`max_memory_allocated` from the same base) lower with remat, step
   ms (CUDA events, the second turn), launches exact (the forward's
   kernels again in the recompute, one VJP recompute each); (b)
   `repro_torch.launch.train.main` with ``--mesh Nx1 --compress-grads``
   on NCCL, one rank (this process; N = 1), Zamba2-1.2B at 12 of 38 layers,
   4 steps, checkpoints at 2 and 4, then the step-4 checkpoint removed
   and the run resumed at 2: losses, masters and error-feedback buffers
   bitwise the uninterrupted run's, optimizer bytes per rank printed,
   launches exact; (c) a runtime derated by `Runtime.set_mesh` to a
   (1, 4) mesh serving Qwen3-14B's decode GEMM bundles at full width on
   4 layers: every launch's CD within the slot budget of 4, results
   held to the plain versions, no fault or fallback.  Its launches are
   the kernels line's ``dist`` path;
13. the model axis, after phase 12 (`model_axis_phase`): the one-rank
   models' greedy runs (Qwen3-14B at 8 of 40 layers, DeepSeek-V2-Lite-16B
   at 6 of 27, full width, f32, batch 4, 1,000-token prompts, 8 steps,
   from a seed; DeepSeek's prefill on the EP path) kept on the host and
   freed; then M = 2 and M = 4 rank processes (spawned, sharing the card
   over gloo, `init_ranks(backend="gloo")`) serve each model sharded on a
   (1, M) mesh through `greedy_decode` with the plain versions raising:
   every rank's tokens equal rank 0's and the one-rank model's, the
   gathered prefill logits within MODEL_TOL of the one-rank logits,
   DeepSeek's prefill on EP and its steps on the capacity path with the
   experts cut (both counted), each rank's `flash_attention` and
   `grouped_matmul` launches those of its shard's shapes; the backend,
   world, mesh, heads and experts a rank, and each rank's peak memory are
   printed.  Two processes asking NCCL for the one card must both be
   refused by `init_ranks`, naming the cause.  Then
   ``python -m repro_torch.launch.serve --arch qwen3-14b``
   at world 1 on NCCL (full width and depth, f32), and the kernels at a
   rank's shapes (M = 4: Qwen3's prefill attention on 10 and 2 heads,
   DeepSeek's MLA on 4 heads, its EP up-projection on 16 experts at
   C2 = 704) held to their plain versions and timed beside SDPA and
   `bmm`.  The ranks' launches are the kernels line's ``model_axis``
   path;
14. one JSON line ``{"kernels": [...]}`` and, last, the device line.

Tolerance of every comparison of a GEMM or of partials (float32, kernel
vs plain version on the same inputs): |kernel − plain| ≤ 2⁻⁷·|plain| +
2⁻¹⁶·(|A|·|B|), with |A|·|B| over the same K range.  The first term is
the bf16 output rounding: both sides round an f32 sum to 8 significant
bits once, and two sums a hair apart may land one bf16 ulp (≤ 2⁻⁸
relative, 2⁻⁷ just below a power of two) apart; it is 0 for f32 outputs.
The second is the f32 summation-order difference, which grows with K:
the kernel sums 16-wide tensor-core products in K order, the plain
version in cuBLAS's order, each add rounding at 2⁻²⁴ of its partial sum;
at random signs these errors add like a random walk, ~√K·2⁻²⁴·Σ|a·b| ≤
2⁻¹⁶·Σ|a·b| for K ≤ 2¹⁶.  A dropped or doubled k tile or a wrong group
moves the result by far more.  The split-K kernel is held to its plain
partials and reduce, which sum the slices' f32 tiles in slice order as
its cluster epilogue does, with |A|·|B| over all of K.  `stream_k_matmul`
is held to `stream_k_matmul_ref`, the plain walk's partials summed in the
kernel's order (runs of `fixup_runs`), with |A|·|B| over all of K, and
must give the same bits on a second run: its order is fixed by the
geometry, whichever CTA arrives last.

Attention and scan kernels are held to their plain versions computed
and kept in f32 on the same (exactly converted) inputs, within
|kernel − plain| ≤ tol + (tol + h)·|plain|: tol is the reference tests'
f32 tolerance (`tests/test_kernel_attention.py`: 2e-4;
`tests/test_kernel_mamba.py`: 3e-4), which covers the f32 summation
order, and h is, for a bf16 output, half a bf16 unit in the last place
(2⁻⁸) for the kernel's one rounding of its f32 result, else 0
(`flash_attention.ref.attention_tol`).  The reference tests' bf16
attention tolerance, 3e-2 + 3e-2·|plain|, is as large as a decode
output itself (~0.026 at 4,096 keys) and would pass a kernel that
skipped a 64-key sub-tile; the kernel phase shows that this one fails
such a kernel.

A model's logits on the card (phase 10a, f32) are held to the same
weights on the CPU within MODEL_TOL·max(1, max |CPU|), MODEL_TOL = 2e-3:
each kernel on the path is held to its plain version within 2e-4
(attention) or 3e-4 (scan) relative per call, cuBLAS and the CPU sum the
f32 GEMMs in other orders, and a layer's error reaches the next; a wrong
head, expert, chunk or cache slot moves logits by O(1).

A sliced parent (phase 9) is held to the plain version of the whole op
within the same tolerance as an op run whole: its merge concatenates the
pieces' outputs, so each output element comes from one piece, whose
kernel sums over the same K (a GEMM's rows) or the same keys (a query-row
piece of causal attention keeps every key its rows see) as the whole op.
Only on integer-valued operands, where every f32 sum is exact in any
order, is a merged GEMM also held bitwise to the unsliced run.
"""
from __future__ import annotations

import gc
import json
import math
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from collections import Counter
from dataclasses import replace
from datetime import timedelta
from itertools import cycle
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CDS,
    CLASSES,
    AttentionDesc,
    ConcurrencyController,
    CostCalibrator,
    GemmDesc,
    GemmRequest,
    GOLibrary,
    Measurer,
    ScanDesc,
    Schedule,
    accuracy_by_available,
    bind_operands,
    execute_schedule,
    family_of,
    generate_gemm_pool,
    op_features,
    profile_dataset,
    slice_plan,
    train_predictor,
    tune_gemm,
)
from repro_torch.core.library import default_library  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.dist import checkpoint as ckpt  # noqa: E402
from repro_torch.core.measure import schedule_for, synth_request  # noqa: E402
from repro_torch.core.scheduler import _run_op  # noqa: E402
from repro_torch.core.tuner import GROUPED_TILES  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_buffers,
    attention_tol,
    flash_attention_fwd,
    flash_combine_ref,
    flash_ref,
)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    PREFILL_KV_TILE,
    PREFILL_ROWS,
    attention_route,
    kernel_resources,
    prefill_grid,
    prefill_resources,
    prefill_width,
    split_geometry,
    tma_loads,
    width_for,
)
from repro_torch.kernels.flash_attention.ops import attention_tiles  # noqa: E402
from repro_torch.kernels.gemm import (  # noqa: E402
    TileConfig,
    gemm,
    gemm_ref,
    fixup_runs,
    splitk_partials_ref,
    splitk_reduce_ref,
    stream_k_matmul_ref,
    stream_k_partials_ref,
    stream_k_workspace,
)
from repro_torch.kernels.gemm import kernel as gemm_kernel  # noqa: E402
from repro_torch.kernels.grouped_gemm import (  # noqa: E402
    grouped_for_desc,
    grouped_gemm_ref,
    pool_launches,
    ragged_gemm_ref,
)
from repro_torch.kernels.grouped_gemm import kernel as grouped_kernel  # noqa: E402
from repro_torch.kernels.grouped_gemm import ops as grouped_ops  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    chunk_grid,
    chunk_workspace,
    decode_grid,
    mamba_scan_fwd,
    scan_route,
    ssd_chunk_ref,
)
from repro_torch.kernels.mamba_scan.kernel import (  # noqa: E402
    NARROW_DIM,
    chunk_residency,
    decode_residency,
)
from repro_torch.kernels.mamba_scan.ref import (  # noqa: E402
    ssd_carry_ref,
    ssd_chunk_states_ref,
    ssd_lost_carry,
)
from repro_torch.kernels.mamba_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.mamba_scan.ops import (  # noqa: E402
    scan_buffers,
    scan_chunk,
    ssd_scan,
)
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.mesh import MeshShape, init_ranks, make_debug_mesh  # noqa: E402
from repro_torch.models import Model, build_model  # noqa: E402
from repro_torch.models import blocks as model_blocks  # noqa: E402
from repro_torch.models import moe as model_moe  # noqa: E402
from repro_torch.models.blocks import zamba_shared_specs  # noqa: E402
from repro_torch.models.spec import iter_specs  # noqa: E402
from repro_torch.models.spec import param_count as spec_param_count  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    MIXED_CLASS,
    FaultInjector,
    FaultRule,
    GraphState,
    Runtime,
    RuntimeConfig,
    TenantSLO,
    decode_step_descs,
    decode_step_graph,
    decode_step_op_descs,
    decode_step_requests,
)
from repro_torch.train import train_loop  # noqa: E402
from repro_torch.train.serve_loop import greedy_decode  # noqa: E402
from repro_torch.train.train_loop import TrainState, make_train_step, train_init  # noqa: E402

SEED = 0
# H100 SXM data-sheet peaks (dense): HBM bytes/s and operations/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# The nine Pallas bodies and the launcher of the kernel that replaces each
# on the card.  Split-K's partials and reduce (rows 2 and 3) are one
# kernel, `splitk_matmul`: the reduce is its cluster epilogue.  Stream-K's
# walk and fixup (rows 4 and 5) are one kernel, `stream_k_matmul`: the
# fixup is its arrival epilogue.
REPLACES = (
    ("matmul", "src/repro/kernels/gemm/kernel.py:45 _matmul_kernel"),
    ("splitk_matmul", "src/repro/kernels/gemm/kernel.py:65 _matmul_splitk_kernel"),
    ("splitk_matmul", "src/repro/kernels/gemm/kernel.py:86 _reduce_kernel"),
    ("stream_k_matmul", "src/repro/kernels/gemm/kernel.py:215 _stream_k_kernel"),
    ("stream_k_matmul", "src/repro/kernels/gemm/kernel.py:247 _stream_k_fixup_kernel"),
    ("grouped_matmul", "src/repro/kernels/grouped_gemm/kernel.py:41 _grouped_kernel"),
    ("ragged_matmul", "src/repro/kernels/grouped_gemm/kernel.py:93 _ragged_kernel"),
    ("flash_attention", "src/repro/kernels/flash_attention/kernel.py:23 _flash_kernel"),
    ("flash_prefill", "src/repro/kernels/flash_attention/kernel.py:23 _flash_kernel"),
    ("mamba_scan", "src/repro/kernels/mamba_scan/kernel.py:24 _mamba_kernel"),
)
SOURCES = {
    "matmul": "src/repro_torch/csrc/gemm.cu",
    "splitk_matmul": "src/repro_torch/csrc/gemm_split_k.cu",
    "stream_k_matmul": "src/repro_torch/csrc/gemm_stream_k.cu",
    "grouped_matmul": "src/repro_torch/csrc/grouped_gemm.cu",
    "ragged_matmul": "src/repro_torch/csrc/grouped_gemm.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "flash_prefill": "src/repro_torch/csrc/flash_prefill.cu",
    "mamba_scan": "src/repro_torch/csrc/mamba_scan.cu",
}
LAUNCHERS = {
    "matmul": gemm_kernel.matmul,
    "splitk_matmul": gemm_kernel.splitk_matmul,
    "stream_k_matmul": gemm_kernel.stream_k_matmul,
    "grouped_matmul": grouped_kernel.grouped_matmul,
    "ragged_matmul": grouped_kernel.ragged_matmul,
    "flash_attention": flash_attention_fwd,
    "mamba_scan": mamba_scan_fwd,
}
# Attention has two kernels, one per route of `flash_attention_fwd`
# (`attention_route`): the launches are counted per route, and the
# counts below name them "flash_attention" (the decode route,
# csrc/flash_attention.cu) and "flash_prefill" (csrc/flash_prefill.cu).
ATTENTION_ROUTES = {"decode": "flash_attention", "prefill": "flash_prefill"}
# Kernels each serving path must launch at least once.  Decode members
# take the decode route; bf16 prefills the prefill route; the model axis
# serves in f32 (MODEL_TOL is f32's), the decode route's home.
PER_CLASS_KERNELS = ("matmul", "grouped_matmul", "ragged_matmul")
MIXED_KERNELS = ("matmul", "splitk_matmul", "stream_k_matmul")
OP_BUNDLE_KERNELS = ("flash_attention", "mamba_scan")
DIST_KERNELS = ("flash_prefill", "mamba_scan", "matmul")
TP_KERNELS = ("flash_attention", "grouped_matmul")
LAYOUTS = ((False, False), (False, True), (True, False), (True, True))
SLEEP_CYCLES = 500_000_000   # ~0.25 s of the card's clock: time to queue work


# ---------------------------------------------------------------- helpers
def check_close(out, ref, a_abs_b_abs, what: str) -> float:
    """Hold ``out`` to ``ref`` (same shape, finite) within the module's
    stated tolerance; returns the max absolute error."""
    if out.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{what}: non-finite output")
    err, tol = gemm_excess(out, ref, a_abs_b_abs)
    if bool((err > tol).any()):
        i = int((err - tol).argmax())
        raise AssertionError(
            f"{what}: max |err| {err.max().item():.4g}, worst element "
            f"{i} err {err.flatten()[i].item():.4g} > tol {tol.flatten()[i].item():.4g}")
    return float(err.max())


def gemm_excess(out, ref, a_abs_b_abs):
    """|out − ref| and the tolerance, element by element, of `check_close`."""
    rel = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 0.0
    r = ref.float()
    return (out.float() - r).abs(), rel * r.abs() + 2.0 ** -16 * a_abs_b_abs


def abs_product(a, b):
    """|A|·|B| in f32, batched when the operands are."""
    return torch.matmul(a.float().abs(), b.float().abs())


def time_ms(fn, reps: int = 20, warmup: int = 3, queued: bool = True) -> float:
    """Mean device time of one call, by CUDA events around ``reps`` calls
    (`rotating` makes each call take the next operand set).  ``queued``:
    the calls are queued behind a sleep of the card (`device_s`), so a
    kernel shorter than its launch's host cost is timed on the card, not
    at the host's launch rate; a function that waits for the card itself
    (a device-to-host read) passes False and is timed as it runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if queued:
        t = device_s(lambda: [fn() for _ in range(reps)])
        if t is not None:
            return t * 1e3 / reps
        print("# note: a timed call waits for the card; timed as it runs")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_s(enqueue):
    """Device time (s) of everything ``enqueue`` queues, with no host gaps:
    the card first sleeps while the host queues the work, and CUDA events
    time the work from the sleep's end.  When queueing outlasts the sleep,
    the sleep grows fourfold and the run repeats, at most twice; then None
    (the work waits for the card itself)."""
    cycles = SLEEP_CYCLES
    for _ in range(3):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        h0 = time.perf_counter()
        enqueue()
        host = time.perf_counter() - h0
        ev[2].record()
        ev[2].synchronize()
        slept = ev[0].elapsed_time(ev[1]) / 1e3
        if host < slept:
            return ev[1].elapsed_time(ev[2]) / 1e3
        cycles *= 4
    return None


def rotating(fn, sets):
    """``fn`` as a no-argument call that takes the next of ``sets`` (tuples
    of arguments) each time: operand sets together beyond the 50 MB L2
    make every call read its operands from HBM."""
    it = cycle(sets)
    return lambda: fn(*next(it))


def randn(shape, gen, dtype=torch.bfloat16, scale: float = 1.0):
    x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    return x.mul_(scale) if scale != 1.0 else x


def bound(bytes_: int, flops: int, dtype) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over HBM rate vs operations
    over the dtype's peak, whichever is larger."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_healthy(rt: Runtime, label: str) -> None:
    """A runtime with no fault injector must show no fault and no fallback:
    the ladder never serves a healthy path, so it cannot hide a kernel."""
    tele = rt.telemetry
    if tele.fault_events or tele.fallback_events:
        raise AssertionError(f"{label}: faults {dict(tele.faults)}, fallbacks "
                             f"{dict(tele.fallbacks)} with no fault injected")


def reset_counts() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0
    gemm_kernel.matmul.feeds.update(dict.fromkeys(gemm_kernel.matmul.feeds, 0))
    mamba_scan_fwd.routes.update(dict.fromkeys(mamba_scan_fwd.routes, 0))
    flash_attention_fwd.routes.update(dict.fromkeys(flash_attention_fwd.routes, 0))


def launch_counts() -> dict:
    """The launches since `reset_counts` by kernel: each launcher's count,
    attention's per route (`ATTENTION_ROUTES`)."""
    counts = {name: fn.launches for name, fn in LAUNCHERS.items()}
    counts.update({ATTENTION_ROUTES[r]: n for r, n in flash_attention_fwd.routes.items()})
    return counts


def take_counts() -> Counter:
    """The launch counts since `reset_counts`, then `reset_counts`."""
    counts = +Counter(launch_counts())
    reset_counts()
    return counts


def attention_kernel(dtype, T: int) -> str:
    """The count key of a model's attention over T query positions in
    ``dtype``: the kernel `attention_route` gives such operands.  Every
    model's head dims (64, 80, 128, 192/128) are instantiated on both
    routes, so dtype and T decide."""
    q = torch.empty((1, 1, T, 64), dtype=dtype, device="meta")
    return ATTENTION_ROUTES[attention_route(q, q, q)]


def check_feeds(label: str, device) -> dict:
    """Print `matmul`'s launches per feed since `reset_counts`; on the card,
    fail if any took the ring feed: every serving shape is aligned bf16,
    which `matmul_feed` gives the TMA feed."""
    feeds = dict(gemm_kernel.matmul.feeds)
    print(f"# {label}: matmul launches per feed {feeds}")
    if device == "cuda" and feeds["ring"]:
        raise AssertionError(f"{label}: {feeds['ring']} matmul launches took the ring "
                             "feed; every serving shape is aligned bf16 (TMA feed)")
    return feeds


# ------------------------------------------------------------------ build
def build_phase() -> None:
    t0 = time.perf_counter()
    paths = _build.build()
    secs = time.perf_counter() - t0
    print(f"# build: {sorted(p.name for p in paths.values())} in {secs:.1f} s")
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log")
        text = log.read_text() if log.exists() else ""
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        smem = [int(x) for x in re.findall(r"(\d+) bytes smem", text)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", text))
        if regs:
            print(f"#   {name}.cu: {len(regs)} kernels, registers ≤ {max(regs)}, "
                  f"static smem ≤ {max(smem, default=0)} B, spill stores {spills} B")


def card_tests_phase() -> str:
    """The card-only tests in a pytest process of their own (no JAX there:
    ``--noconftest``), on the libraries just built; fails unless every
    test passes and none skips.  Returns pytest's summary line."""
    args = ["--noconftest", "-p", "no:cacheprovider", "-m", "cuda", "-q",
            str(ROOT / "tests" / "test_torch_card.py")]
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); import pytest; "
            f"sys.exit(pytest.main({args!r}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True)
    summary = (r.stdout.strip().splitlines() or ["(no output)"])[-1]
    if r.returncode != 0 or "skipped" in summary or "passed" not in summary:
        print(r.stdout[-6000:], r.stderr[-2000:], sep="\n")
        raise AssertionError(f"card-only tests: {summary}")
    return summary


# ---------------------------------------------------------------- kernels
def weight_forms(G: int, K: int, N: int, gen, dtype) -> dict:
    """The members' weights in both pointer forms: one stacked (G, K, N)
    tensor; per-member (K, N) tensors, the second member sharing the
    first's weight; and per-member transposed views of (N, K) storage
    (the kernels' TB layout), again with one weight shared."""
    rows = [randn((K, N), gen, dtype) for _ in range(G)]
    cols = [randn((N, K), gen, dtype).T for _ in range(G)]
    if G > 1:
        rows[1], cols[1] = rows[0], cols[0]
    return {"stacked": randn((G, K, N), gen, dtype), "per-member": rows,
            "transposed": cols}


def small_cases(gen) -> int:
    """Ragged shapes in every layout and type, against the plain versions;
    the grouped and ragged kernels with their weights in each pointer
    form, and every GEMM kernel also with float32 output from bf16
    operands (`out_dtype`)."""
    n = 0
    feeds = dict(gemm_kernel.matmul.feeds)
    for dtype in (torch.bfloat16, torch.float32):
        for (M, N, K) in ((1, 1, 1), (5, 70, 33), (16, 64, 128), (17, 129, 300),
                          (70, 200, 257), (130, 65, 64), (8, 136, 200),
                          (72, 328, 1000), (8, 17408, 320)):
            for ta in (False, True):
                for tb in (False, True):
                    bm = 8 if (M + K) % 2 else 64
                    a = randn((K, M) if ta else (M, K), gen, dtype)
                    b = randn((N, K) if tb else (K, N), gen, dtype)
                    out = gemm_kernel.matmul(a, b, ta=ta, tb=tb, bm=bm)
                    a_, b_ = (a.T if ta else a), (b.T if tb else b)
                    check_close(out, gemm_ref(a, b, ta=ta, tb=tb),
                                abs_product(a_, b_),
                                f"matmul {M}x{N}x{K} ta{ta:d} tb{tb:d} {dtype}")
                    n += 1
        for (G, M, N, K, bm) in ((1, 3, 10, 7, 8), (3, 16, 64, 128, 16),
                                 (4, 9, 130, 200, 8), (2, 70, 100, 96, 64),
                                 (20, 5, 64, 96, 8)):   # G above the table's 16
            a = randn((G, M, K), gen, dtype)
            for form, b in weight_forms(G, K, N, gen, dtype).items():
                out = grouped_kernel.grouped_matmul(a, b, bm=bm)
                check_close(out, grouped_gemm_ref(a, b), grouped_abs(a, b),
                            f"grouped G{G} {M}x{N}x{K} bm{bm} {form} {dtype}")
                n += 1
        for (sizes, N, K, bm) in (([8, 8], 64, 64, 8), ([16, 0, 32], 100, 130, 16),
                                  ([8, 24, 8, 8], 65, 257, 8),
                                  ([32, 64], 70, 96, 32), ([128, 256], 64, 80, 128),
                                  ([16, 8, 8, 8, 8], 5120, 300, 8),   # 480 tiles > CTAs
                                  ([16] * 18 + [0, 32], 96, 200, 16)):  # 20 members
            G, Mtotal = len(sizes), sum(sizes)
            a = randn((Mtotal, K), gen, dtype)
            for form, b in weight_forms(G, K, N, gen, dtype).items():
                out = grouped_kernel.ragged_matmul(a, b, sizes, bm=bm)
                check_close(out, ragged_gemm_ref(a, b, sizes), ragged_abs(a, b, sizes),
                            f"ragged {sizes} N{N} K{K} bm{bm} {form} {dtype}")
                n += 1
    used = {k: v - feeds[k] for k, v in gemm_kernel.matmul.feeds.items()}
    print(f"# small matmul cases per feed: {used}")
    if not all(used.values()):
        raise AssertionError(f"the small cases did not run both matmul feeds: {used}")
    return n + f32_output_cases(gen)


def f32_output_cases(gen) -> int:
    """bf16 operands, float32 output (`out_dtype`): each GEMM kernel
    against its plain version at the same output dtype (the tolerance's
    bf16 rounding term is then 0).  Split-K and Stream-K run through
    `gemm`, whose epilogues (split-K's cluster reduce, Stream-K's
    arrival sums) store the f32 sums."""
    bf16, f32 = torch.bfloat16, torch.float32
    n = 0
    for (M, N, K), (ta, tb) in zip(((5, 70, 600), (16, 129, 300), (33, 64, 1000)),
                                   LAYOUTS):
        a = randn((K, M) if ta else (M, K), gen)
        b = randn((N, K) if tb else (K, N), gen)
        a_, b_ = (a.T if ta else a), (b.T if tb else b)
        want = gemm_ref(a, b, ta=ta, tb=tb, out_dtype=f32)
        for tile in (TileConfig(8, 128, 128), TileConfig(8, 128, 128, split_k=3),
                     TileConfig(16, 128, 128, stream_k=5)):
            out = gemm(a, b, ta=ta, tb=tb, tile=tile, out_dtype=f32)
            if out.dtype != f32:
                raise AssertionError(f"gemm at {tile.key()} stored {out.dtype}")
            check_close(out, want, abs_product(a_, b_),
                        f"gemm {M}x{N}x{K} at {tile.key()} ta{ta:d} tb{tb:d} -> f32")
            n += 1
    a = randn((3, 9, 200), gen)
    for form, b in weight_forms(3, 200, 70, gen, bf16).items():
        check_close(grouped_kernel.grouped_matmul(a, b, bm=8, out_dtype=f32),
                    grouped_gemm_ref(a, b, out_dtype=f32), grouped_abs(a, b),
                    f"grouped G3 9x70x200 {form} -> f32")
        n += 1
    sizes = [16, 8, 0, 24]
    a = randn((sum(sizes), 300), gen)
    for form, b in weight_forms(4, 300, 130, gen, bf16).items():
        check_close(grouped_kernel.ragged_matmul(a, b, sizes, bm=8, out_dtype=f32),
                    ragged_gemm_ref(a, b, sizes, out_dtype=f32), ragged_abs(a, b, sizes),
                    f"ragged {sizes} N130 K300 {form} -> f32")
        n += 1
    return n


def grouped_abs(a, b):
    """|A[g]|·|B[g]| in f32 (the grouped tolerance's scale)."""
    return grouped_gemm_ref(a.float().abs(), [w.float().abs() for w in
                                              grouped_kernel.member_weights(b)])


def ragged_abs(a, b, group_sizes):
    """|A|·|B[g]| row by row, in f32 (the ragged tolerance's scale)."""
    return ragged_gemm_ref(a.float().abs(), [w.float().abs() for w in
                                             grouped_kernel.member_weights(b)],
                           group_sizes)


def residency(name: str, shape: str, ctas: int, res, split: int = 0) -> dict:
    """Print and return how a ring-fed kernel's grid of ``ctas`` CTAs sits
    on the card (``res``: `RingResidency`): resident slots (CTAs per SM ×
    SMs; for split-K the resident clusters × their CTAs too, whichever is
    fewer), waves = CTAs / slots, dynamic shared memory, and the operand
    bytes in flight per SM, (stages − 1) slabs × the CTAs an SM holds of
    this grid (its occupancy, or ⌈CTAs / SMs⌉ when the grid is smaller)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = res.ctas_per_sm * sms
    if split:
        slots = min(slots, res.clusters * split)
    per_sm = min(res.ctas_per_sm, -(-ctas // sms))
    out = dict(ctas=ctas, ctas_per_sm=res.ctas_per_sm, sms=sms, slots=slots,
               clusters=res.clusters, waves=ctas / slots, smem_bytes=res.smem_bytes,
               stages=res.stages, slab_bytes=res.slab_bytes,
               in_flight_per_sm=per_sm * (res.stages - 1) * res.slab_bytes)
    clusters = (f", {res.clusters} resident clusters of {split} "
                f"({res.clusters * split} CTAs)" if split else "")
    print(f"# {name} residency at {shape}: {ctas} CTAs; {res.ctas_per_sm} CTAs per "
          f"SM x {sms} SMs{clusters}: {slots} resident slots, {out['waves']:.3f} "
          f"waves; {res.smem_bytes} B dynamic shared memory per CTA, a "
          f"{res.stages}-stage ring of {res.slab_bytes} B slabs; "
          f"{out['in_flight_per_sm']} B in flight per SM")
    return out


def main_path_kernels(gen) -> dict:
    """The serving path's shapes: compare, then time kernel, plain version
    and the PyTorch call computing the same function.  Every operand set
    holds ≥ 178 MB of weights, beyond the 50 MB L2, so each timed call
    streams its weights from HBM."""
    rows = {"matmul": [matmul_shape(N, gen) for N in MATMUL_NS]}
    rows["matmul"][0]["host_us"] = launcher_host_us(gen)
    bf16 = torch.bfloat16

    # grouped: four tenants' ffn-down at batch 8, each weight by pointer
    G, M, N, K = 4, 8, 5120, 17408
    a, b = randn((G, M, K), gen), randn((G, K, N), gen, scale=K ** -0.5)
    ws = list(b.unbind(0))
    out = grouped_kernel.grouped_matmul(a, ws, bm=8)
    err = check_close(out, grouped_gemm_ref(a, ws), grouped_abs(a, ws),
                      "grouped main")
    res = grouped_kernel.grouped_residency(a.device, bf16, bf16, False, 16)
    rows["grouped_matmul"] = [dict(
        shape=f"G{G} {M}x{N}x{K}",
        instantiation=(f"{gemm_kernel.instantiation(bf16, 8)}, {res.stages}-stage "
                       f"cp.async ring, {res.smem_bytes} B shared"),
        grid=residency("grouped_matmul", f"G{G} {M}x{N}x{K}",
                       G * -(-M // 16) * -(-N // 64), res),
        max_abs_err=err,
        ms=time_ms(lambda: grouped_kernel.grouped_matmul(a, ws, bm=8)),
        plain_ms=time_ms(lambda: grouped_gemm_ref(a, ws), reps=5),
        library_ms=time_ms(lambda: torch.bmm(a, b)),
        bound=bound(G * (M * K + K * N + M * N) * 2, 2 * G * M * N * K, bf16))]
    # The copy the scheduler made before weights went by pointer: a
    # torch.stack of the members' B for such a launch.
    stack_ms = time_ms(lambda: torch.stack(ws), reps=5)
    print(f"# torch.stack of B for a grouped ffn-down launch (G={G}, "
          f"{G * K * N * 2 / 1e9:.3f} GB), no longer made: {stack_ms:.4f} ms")

    # ragged: five tenants' ffn-down at batches [16, 8, 8, 8, 4], bm = 16,
    # five distinct weights by pointer
    sizes, bm, N, K = [16, 8, 8, 8, 4], 16, 5120, 17408
    padded = [-(-s // bm) * bm for s in sizes]
    G, Mtotal = len(sizes), sum(padded)
    a = torch.zeros((Mtotal, K), dtype=bf16, device="cuda")
    off = 0
    for s, p in zip(sizes, padded):
        a[off:off + s] = randn((s, K), gen)
        off += p
    b = randn((G, K, N), gen, scale=K ** -0.5)
    ws = list(b.unbind(0))
    out = grouped_kernel.ragged_matmul(a, ws, padded, bm=bm)
    err = check_close(out, ragged_gemm_ref(a, ws, padded), ragged_abs(a, ws, padded),
                      "ragged main")
    per_sm, smem = grouped_kernel.ragged_resources(a.device, bf16, bf16, False, 16)
    geo = grouped_kernel.ragged_walk(
        Mtotal, N, K, bf16, bm,
        grouped_kernel.ragged_workgroups(a.device, bf16, bf16, False, 16))
    tiles = geo.tm * geo.tn
    print(f"# ragged_matmul grid at sizes {sizes} N{N} K{K}: {geo.live} CTAs "
          f"({per_sm} CTAs of {smem} B shared memory per SM) walk {tiles} tiles of "
          f"{geo.rows}x64, k step {geo.bk}, {geo.tk} steps each: {geo.total} "
          f"iterations, {geo.ipw} per CTA")
    # The padded members are all bm rows, so one bmm computes the same
    # function on these inputs.
    rows["ragged_matmul"] = [dict(
        shape=f"sizes {sizes} (padded to {bm}) N{N} K{K}",
        instantiation=(f"bf16 {geo.rows}x64x{geo.bk} walk, {geo.live} CTAs, "
                       f"{smem} B shared"),
        grid=dict(ctas=geo.live, ctas_per_sm=per_sm, smem_bytes=smem, tiles=tiles,
                  iterations=geo.total, ipw=geo.ipw),
        max_abs_err=err,
        ms=time_ms(lambda: grouped_kernel.ragged_matmul(a, ws, padded, bm=bm)),
        plain_ms=time_ms(lambda: ragged_gemm_ref(a, ws, padded), reps=5, queued=False),
        library_ms=time_ms(lambda: torch.bmm(a.view(G, bm, K), b)),
        bound=bound((Mtotal * K + G * K * N + Mtotal * N) * 2,
                    2 * Mtotal * N * K, bf16))]
    for name, rs in rows.items():
        for r in rs:
            print(f"# {name:<15} {r['shape']:<40} [{r['instantiation']}] kernel "
                  f"{r['ms']:.4f} ms | plain {r['plain_ms']:.4f} | torch "
                  f"{r['library_ms']:.4f} | bound {r['bound'][0]:.4f} "
                  f"({r['bound'][1]}) | max err {r['max_abs_err']:.4g}")
    return rows


MOE = "deepseek-v2-lite-16b"


def moe_pools(cfg, batch: int) -> list:
    """The two expert pools (up, down) of a DeepSeek decode bundle."""
    return [d for d in decode_step_op_descs(cfg, batch) if d.family == "grouped_gemm"]


def pool_bm_cases(gen) -> int:
    """`grouped_for_desc` at every bm of `GROUPED_TILES` on DeepSeek's
    batch-16 pools (64 experts of 2 or 1 rows, up 2048 → 1408 and down
    1408 → 2048, weights as views into one (64, K, N) tensor), each held
    to `ragged_gemm_ref` on the raw rows with exactly `pool_launches`
    `ragged_matmul` launches (four chunks of 16 experts)."""
    n = 0
    for d in moe_pools(get_arch(MOE), 16):
        a = randn((d.M, d.K), gen)
        w = randn((d.G, d.K, d.N), gen, scale=d.K ** -0.5)
        ws, sizes = list(w.unbind(0)), list(d.row_vector())
        want, scale = ragged_gemm_ref(a, ws, sizes), ragged_abs(a, ws, sizes)
        for bm in sorted({t.bm for t in GROUPED_TILES}):
            before = grouped_kernel.ragged_matmul.launches
            out = grouped_for_desc(d, a, ws, tile=TileConfig(bm, 128, 128))
            got = grouped_kernel.ragged_matmul.launches - before
            if got != pool_launches(d, bm):
                raise AssertionError(f"{d.key()} bm {bm}: {got} ragged launches, "
                                     f"ragged_chunks gives {pool_launches(d, bm)}")
            check_close(out, want, scale, f"{d.key()} at bm {bm}")
            n += 1
    return n


def moe_ragged_rows(gen, lib) -> list:
    """`ragged_matmul` at DeepSeek-V2-Lite's expert pools: the up and down
    launches of the batch-16 pool (G 64, 32 experts of 2 rows and 32 of
    1) and of the batch-1 pool (G 6, 1 row each), each expert's rows
    packed to its isolated GO tile's bm, the weights by pointer as views
    into (64, K, N) tensors (369 MB a projection; at G 6, ten rotating
    sets of six experts, 346 MB).  Timed beside its plain version and
    `torch.bmm` on equal padded groups (the stacked weights of the same
    experts), which computes the same function on these inputs."""
    bf16, rows = torch.bfloat16, []
    for batch in (16, 1):
        for d in moe_pools(get_arch(MOE), batch):
            bm = lib.get(d).isolated.bm
            w = randn((64, d.K, d.N), gen, scale=d.K ** -0.5)
            padded = [r + (-r) % bm for r in d.row_vector()]
            Mp = sum(padded)
            groups = [(e, e + d.G) for e in range(0, 64 - d.G + 1, d.G)]
            sets = []
            for lo, hi in groups:
                a = torch.zeros((Mp, d.K), dtype=bf16, device="cuda")
                off = 0
                for r, p in zip(d.row_vector(), padded):
                    a[off:off + r] = randn((r, d.K), gen)
                    off += p
                sets.append((a, list(w[lo:hi].unbind(0)), w[lo:hi]))
            a, ws, b = sets[0]
            out = grouped_kernel.ragged_matmul(a, ws, padded, bm=bm)
            err = check_close(out, ragged_gemm_ref(a, ws, padded),
                              ragged_abs(a, ws, padded), f"ragged {d.key()}")
            launches = pool_launches(d, bm)
            rows.append(dict(
                shape=(f"DeepSeek-V2-Lite pool, batch {batch}: G{d.G} rows "
                       f"{sorted(set(d.row_vector()))} packed to bm {bm} "
                       f"({Mp} rows) N{d.N} K{d.K}, {launches} launches of <= "
                       f"{grouped_kernel.MAX_MEMBERS} experts, {len(sets)} rotating set(s)"),
                max_abs_err=err,
                ms=time_ms(rotating(lambda x, y, _: grouped_kernel.ragged_matmul(
                    x, y, padded, bm=bm), sets)),
                plain_ms=time_ms(lambda: ragged_gemm_ref(a, ws, padded), reps=3,
                                 queued=False),
                library_ms=(time_ms(rotating(lambda x, _, z: torch.bmm(
                    x.view(d.G, Mp // d.G, d.K), z), sets))
                    if len(set(padded)) == 1 else None),
                bound=bound((Mp * d.K + d.G * d.K * d.N + Mp * d.N) * 2,
                            2 * Mp * d.N * d.K, bf16)))
            del sets, w, a, ws, b
    for r in rows:
        lib_ms = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"# ragged_matmul   {r['shape']:<60} kernel {r['ms']:.4f} ms | plain "
              f"{r['plain_ms']:.4f} | torch.bmm {lib_ms} | bound {r['bound'][0]:.4f} "
              f"({r['bound'][1]}) | max err {r['max_abs_err']:.4g}")
    return rows


# The serving path's `matmul` shapes, 8 x N x 5120 bf16 (Qwen3-14B at batch
# 8): fused gate+up, gate or up, q or o, k or v.
MATMUL_NS = (34816, 17408, 5120, 1024)


def odd_copy(x):
    """``x``'s values in a view one element past an aligned base: the
    same operand, which `matmul_feed` gives the ring feed."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


def launcher_host_us(gen, calls: int = 2000) -> float:
    """Host time of one `matmul` call (checks, feed rule, tensor-map
    encoding, launch), µs: ``calls`` launches at 8 x 1024 x 5120 queued
    without a synchronize, the best of three runs."""
    a, b = randn((8, 5120), gen), randn((5120, 1024), gen)
    c = torch.empty((8, 1024), device="cuda", dtype=torch.bfloat16)
    for _ in range(50):
        gemm_kernel.matmul(a, b, bm=8, out=c)
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            gemm_kernel.matmul(a, b, bm=8, out=c)
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    print(f"# matmul launcher host time: {min(runs):.2f} µs per call ({calls} calls "
          f"queued, runs {[round(r, 2) for r in runs]})")
    return min(runs)


def matmul_shape(N: int, gen, M: int = 8, K: int = 5120) -> dict:
    """`matmul` at 8 x N x 5120: both feeds held to `gemm_ref` (the ring
    feed on the same values through an odd-offset view of A), then the
    rule's feed, the ring feed, the plain version and `torch.matmul`
    timed with operand sets rotating beyond the 50 MB L2, and the
    residency of the TMA instantiation the rule picked."""
    bf16 = torch.bfloat16
    nsets = max(2, -(-200_000_000 // (N * K * 2)))
    sets = [(randn((M, K), gen), randn((K, N), gen, scale=K ** -0.5),
             torch.empty((M, N), device="cuda", dtype=bf16)) for _ in range(nsets)]
    odd = [(odd_copy(x), y, z) for x, y, z in sets]
    a, b, _ = sets[0]
    shape = f"{M}x{N}x{K}"
    feed = gemm_kernel.matmul_feed(a, b, False, False)
    if feed != "tma" or gemm_kernel.matmul_feed(odd[0][0], b, False, False) != "ring":
        raise AssertionError(f"matmul {shape}: the feeds are not TMA and ring")
    want, scale = gemm_ref(a, b), abs_product(a, b)
    err = check_close(gemm_kernel.matmul(a, b, bm=8), want, scale, f"matmul {shape} tma")
    check_close(gemm_kernel.matmul(odd[0][0], b, bm=8), want, scale,
                f"matmul {shape} ring feed")
    ctas = -(-N // gemm_kernel.CTA_COLS) * -(-M // 16)
    ring = gemm_kernel.matmul_ring(ctas, gemm_kernel.sm_count(a.device))
    res = gemm_kernel.matmul_residency(a.device, bf16, bf16, False, False, 16, feed,
                                       ring)

    def run(x, y, z):
        return gemm_kernel.matmul(x, y, bm=8, out=z)

    row = dict(
        shape=shape, feed=feed,
        instantiation=(f"bf16 16x64 CTA tile, TMA feed: {res.stages}-stage ring of "
                       f"64-deep k-slabs, {ring[1]} consumer group(s), "
                       f"{res.smem_bytes} B shared"),
        grid=residency("matmul", shape, ctas, res), max_abs_err=err,
        ms=time_ms(rotating(run, sets)),
        ring_ms=time_ms(rotating(run, odd)),
        plain_ms=time_ms(lambda: gemm_ref(a, b), reps=5),
        library_ms=time_ms(rotating(lambda x, y, z: torch.matmul(x, y, out=z), sets)),
        bound=bound((M * K + K * N + M * N) * 2, 2 * M * N * K, bf16))
    print(f"# matmul {shape}: {feed} feed {row['ms']:.4f} ms, ring feed "
          f"{row['ring_ms']:.4f} ms on the same values, torch.matmul "
          f"{row['library_ms']:.4f} ms")
    return row


# ------------------------------------------------- split-K and Stream-K
SPLIT_CASES = (  # M, N, K, bm, bk, split_k
    (5, 70, 600, 8, 128, 4),       # ⌈K/bk⌉ = 5 at split 4: slot 3 is empty
    (1, 130, 1100, 8, 128, 8),     # 9 k blocks at split 8: slots 5-7 empty
    (16, 64, 257, 16, 128, 2),
    (17, 200, 4096, 32, 128, 4),
    (70, 129, 300, 64, 64, 3),
    (8, 300, 1000, 8, 256, 8),     # 4 k blocks: the split drops to 4
)
STREAM_CASES = (  # M, N, K, bm, bn, bk, G
    (5, 70, 600, 8, 128, 128, 1),
    (13, 70, 300, 8, 128, 128, 3),
    (33, 200, 520, 16, 128, 128, 5),
    (16, 256, 1024, 8, 128, 256, 7),
    (70, 129, 1000, 64, 256, 128, 8),
    (100, 300, 700, 128, 128, 256, 40),   # G above the 9 MAC iterations
    (3, 40, 50, 16, 32, 16, 1000),        # tile narrower than a CTA, bk 16
)


def walk_kw(geo) -> dict:
    """The plain Stream-K walk's arguments for the card's geometry: CTA
    tiles, the CTA's k step and W workgroups."""
    return dict(bm=geo.rows, bn=geo.cols, bk=geo.bk, grid_g=geo.workgroups)


def op_abs(a, b, ta, tb):
    """|op(a)|, |op(b)| in f32: the tolerance's scale, fed to a plain
    version to get |A|·|B| over exactly that version's K ranges."""
    return ((a.T if ta else a).float().abs(), (b.T if tb else b).float().abs())


def check_equal(out, ref, what: str) -> float:
    if out.shape != ref.shape or out.dtype != ref.dtype or not torch.equal(out, ref):
        err = (out.float() - ref.float()).abs().max().item() if \
            out.shape == ref.shape else float("nan")
        raise AssertionError(f"{what}: not equal to the plain version (max |err| {err})")
    return 0.0


def split_stream_cases(gen) -> int:
    """The split-K and Stream-K kernels against their own plain versions,
    each twice for the same bits: `splitk_matmul` against the plain
    partials and reduce, `stream_k_matmul` against `stream_k_matmul_ref`
    at the card's geometry; then `gemm` end to end."""
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for (M, N, K, bm, bk, split_k), (ta, tb) in zip(SPLIT_CASES, cycle(LAYOUTS)):
            what = f"split-K {M}x{N}x{K} bm{bm} bk{bk} s{split_k} ta{ta:d} tb{tb:d} {dtype}"
            a = randn((K, M) if ta else (M, K), gen, dtype)
            b = randn((N, K) if tb else (K, N), gen, dtype)
            split, slice_k = gemm_kernel.split_k_slices(K, bk, split_k)
            kw = dict(ta=ta, tb=tb, split=split, slice_k=slice_k)
            aa, ab = op_abs(a, b, ta, tb)
            out = gemm_kernel.splitk_matmul(a, b, bm=bm, **kw)
            check_close(out, splitk_reduce_ref(splitk_partials_ref(a, b, bk=bk, **kw),
                                               dtype), aa @ ab, what)
            check_equal(gemm_kernel.splitk_matmul(a, b, bm=bm, **kw), out,
                        what + " second run")
            check_close(gemm(a, b, ta=ta, tb=tb,
                             tile=TileConfig(bm, 128, bk, split_k=split_k)),
                        gemm_ref(a, b, ta=ta, tb=tb), aa @ ab, what + " gemm")
            n += 1
        for (M, N, K, bm, bn, bk, G), (ta, tb) in zip(STREAM_CASES, cycle(LAYOUTS)):
            what = f"Stream-K {M}x{N}x{K} {bm}x{bn}x{bk}g{G} ta{ta:d} tb{tb:d} {dtype}"
            a = randn((K, M) if ta else (M, K), gen, dtype)
            b = randn((N, K) if tb else (K, N), gen, dtype)
            geo = gemm_kernel.card_geometry(M, N, K, dtype, ta, tb, G, a.device)
            kw = walk_kw(geo)    # the plain walk at the card's geometry
            aa, ab = op_abs(a, b, ta, tb)
            out = gemm_kernel.stream_k_matmul(a, b, ta=ta, tb=tb, grid_g=G)
            check_close(out, stream_k_matmul_ref(a, b, ta=ta, tb=tb, **kw), aa @ ab,
                        what + " stream_k_matmul")
            check_equal(gemm_kernel.stream_k_matmul(a, b, ta=ta, tb=tb, grid_g=G), out,
                        what + " second run")
            check_close(gemm(a, b, ta=ta, tb=tb, tile=TileConfig(bm, bn, bk, stream_k=G)),
                        gemm_ref(a, b, ta=ta, tb=tb), aa @ ab, what + " gemm")
            n += 1
    return n


def planted_stream_k_fault(a, b, out, ref, geo) -> None:
    """The Stream-K check's power at the timed shape: the kernel's output
    with one run's sum (run 1 of the tile of most contributors) taken out,
    which a kernel whose last run skipped that run would give, must fail
    `check_close`.  Prints how far off it is."""
    counts = geo.counts.reshape(-1)
    q = int(counts.argmax())
    n = int(counts[q])
    R = fixup_runs(n)
    if n <= R:
        raise AssertionError(f"no tile of two levels at {tuple(out.shape)}: {n} "
                             "contributors")
    i, j = divmod(q, geo.tn)
    rows = slice(i * geo.rows, (i + 1) * geo.rows)
    cols = slice(j * geo.cols, (j + 1) * geo.cols)
    p = stream_k_partials_ref(a, b, **walk_kw(geo))   # slot = contributor index
    fault = out.float()
    fault[rows, cols] -= p[R:2 * R, rows, cols].sum(0)
    err, tol = gemm_excess(fault.to(out.dtype), ref, abs_product(a, b))
    n_bad = int((err > tol).sum())
    print(f"# planted Stream-K fault (tile {q}: run 1 of {-(-n // R)}, contributors "
          f"{R}-{2 * R - 1} of {n}, dropped): max |err| {err.max().item():.4g}; "
          f"{n_bad} of {out.numel()} outputs beyond the tolerance, so check_close "
          "fails it")
    if not n_bad:
        raise AssertionError("check_close lets a dropped Stream-K run through")


def split_stream_kernels(gen) -> dict:
    """The mixed path's split-K shapes (Qwen3-14B ffn-down, 5120×17408
    bf16: 178 MB of weights, beyond the 50 MB L2) and the Stream-K shape
    the planner gives a 32×512×17408 member at CD 6-8 (17.8 MB of
    weights: four operand sets rotate, 71 MB together).  Each kernel,
    its plain version and the PyTorch call beside it are timed on the
    same inputs: for split-K and Stream-K the whole GEMM, one launch
    each, against `torch.matmul`.  Stream-K's timed launches include the
    zeroing of its counters; its bound is the function's, the bytes
    `torch.matmul` moves too: the f32 shares (3 MB at 46 contributors a
    tile) are written and read back within the launch, in L2."""
    rows = {}
    bf16, f32 = torch.bfloat16, torch.float32
    for (M, N, K, split_k) in ((8, 5120, 17408, 4), (1, 5120, 17408, 8)):
        a, b = randn((M, K), gen), randn((K, N), gen, scale=K ** -0.5)
        tile = TileConfig(8, 128, 128, split_k=split_k)
        split, slice_k = gemm_kernel.split_k_slices(K, tile.bk, split_k)
        kw = dict(split=split, slice_k=slice_k)
        out = gemm_kernel.splitk_matmul(a, b, bm=8, **kw)

        def plain():
            return splitk_reduce_ref(splitk_partials_ref(a, b, bk=tile.bk, **kw), bf16)

        shape = f"{M}x{N}x{K} at {tile.key()}"
        err = check_close(out, plain(), abs_product(a, b), f"splitk_matmul {shape}")
        res = gemm_kernel.splitk_residency(a.device, bf16, bf16, False, False, 16, split)
        rows.setdefault("splitk_matmul", []).append(dict(
            shape=shape,
            instantiation=(f"{gemm_kernel.instantiation(bf16, 8)}, {res.stages}-stage "
                           f"cp.async ring, clusters of {split}, {res.smem_bytes} B "
                           "shared"),
            grid=residency("splitk_matmul", shape, -(-N // 64) * -(-M // 16) * split,
                           res, split),
            max_abs_err=err,
            ms=time_ms(lambda: gemm_kernel.splitk_matmul(a, b, bm=8, out=out, **kw)),
            plain_ms=time_ms(plain, reps=3, warmup=1),
            library_ms=time_ms(lambda: torch.matmul(a, b)),
            bound=bound((M * K + K * N + M * N) * 2, 2 * M * N * K, bf16)))
        del a, b, out

    M, N, K, G = 32, 512, 17408, 8
    tile = TileConfig(32, 128, 128, stream_k=G)
    sets = [(randn((M, K), gen), randn((K, N), gen, scale=K ** -0.5)) for _ in range(4)]
    a, b = sets[0]
    geo = gemm_kernel.card_geometry(M, N, K, bf16, False, False, G, a.device)
    kw = walk_kw(geo)
    per_sm, smem = gemm_kernel.walk_resources(a.device, bf16, False, False, geo.rows)
    counts = geo.counts.reshape(-1)
    cut = counts[counts > 1]
    runs_of = fixup_runs(int(counts.max()))
    floats, n_counters = stream_k_workspace(geo.live, geo.rows, geo.cols)
    grid = dict(workgroups=geo.workgroups, live=geo.live, ctas_per_sm=per_sm,
                smem_bytes=smem, ipw=geo.ipw, cut_tiles=int(cut.size),
                contributors=sorted({int(n) for n in cut}), runs_of=runs_of,
                runs=-(-int(counts.max()) // runs_of),
                workspace_bytes=(floats + n_counters) * 4,
                shares_bytes=int(cut.sum()) * geo.rows * geo.cols * 4)
    print(f"# stream_k_matmul grid at {M}x{N}x{K} g{G}: W = {geo.workgroups} "
          f"workgroups ({per_sm} CTAs of {smem} B shared memory per SM), "
          f"{geo.live} live CTAs of {geo.rows}x{geo.cols}, k step {geo.bk}, "
          f"{geo.ipw} iterations each; {grid['cut_tiles']} cut tiles of "
          f"{grid['contributors']} contributors, summed in runs of {runs_of} "
          f"({grid['runs']} runs); workspace {grid['workspace_bytes']} B, "
          f"{grid['shares_bytes']} B of shares written")
    ref = stream_k_matmul_ref(a, b, **kw)
    out = gemm_kernel.stream_k_matmul(a, b, grid_g=G)
    err = check_close(out, ref, abs_product(a, b), "stream_k_matmul main")
    check_equal(gemm_kernel.stream_k_matmul(a, b, grid_g=G), out,
                "stream_k_matmul main second run")
    planted_stream_k_fault(a, b, out, ref, geo)
    c = torch.empty_like(out)
    ws = torch.empty(floats, device=a.device)
    shape = f"{M}x{N}x{K} at {tile.key()}"
    rows["stream_k_matmul"] = [dict(
        shape=shape, instantiation=(f"bf16 {geo.rows}x{geo.cols}x{geo.bk}, W "
                                    f"{geo.workgroups} ({geo.live} live), {smem} B "
                                    f"shared, runs of {runs_of}"),
        grid=grid, max_abs_err=err,
        ms=time_ms(rotating(lambda x, y: gemm_kernel.stream_k_matmul(
            x, y, grid_g=G, out=c, workspace=ws), sets)),
        plain_ms=time_ms(lambda: stream_k_matmul_ref(a, b, **kw), reps=3, warmup=1,
                         queued=False),   # thousands of launches a call
        library_ms=time_ms(rotating(torch.matmul, sets)),
        bound=bound((M * K + K * N + M * N) * 2, 2 * M * N * K, bf16))]
    if gemm_kernel.stream_counters(a.device, n_counters).any():
        raise AssertionError("stream_k_matmul left its stream's counters nonzero: "
                             "the next launch would miscount")
    for name, rs in rows.items():
        for r in rs:
            print(f"# {name:<17} {r['shape']:<52} kernel {r['ms']:.4f} ms | plain "
                  f"{r['plain_ms']:.4f} | torch {r['library_ms']:.4f} | bound "
                  f"{r['bound'][0]:.6f} ({r['bound'][1]}) | max err {r['max_abs_err']:.4g}")
    return rows


# ---------------------------------------------------------------- serving
SERVING_WINDOWS = ([8, 8, 8, 8], [4, 8, 8, 8, 16])


def fused_shapes(cfg) -> list:
    """(K, N) of the four fused decode GEMMs: fused QKV, attention-out,
    fused FFN gate+up and FFN down."""
    D, hd = cfg.d_model, cfg.resolved_head_dim
    return [(D, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd),
            (cfg.n_heads * hd, D), (D, 2 * cfg.d_ff), (cfg.d_ff, D)]


def make_weights(cfg, layers: int, gen, device) -> list:
    """Per layer, the four decode GEMMs' weights keyed by (K, N) of
    `fused_shapes`, stored (K, N)."""
    out = []
    for _ in range(layers):
        out.append({
            (k, n): torch.randn((k, n), generator=gen, device=device,
                                dtype=torch.bfloat16).mul_(k ** -0.5)
            for k, n in fused_shapes(cfg)})
    return out


def window_requests(ctrl, cfg, weights: list, batches, gen, device) -> list:
    """Every tenant's decode step of every layer as (tenant, request), each
    with its own activations, fused as ``ctrl``'s §6.11 policy decides
    (the weights on the card are the fused ones the oracle picks)."""
    out = []
    for wl in weights:
        for ti, batch in enumerate(batches):
            for r in decode_step_requests(ctrl, cfg, batch):
                d = r.desc
                a = torch.randn((d.M, d.K), generator=gen, device=device,
                                dtype=torch.bfloat16)
                out.append((f"tenant{ti}",
                            GemmRequest(desc=d, a=a, b=wl[(d.K, d.N)], tag=r.tag)))
    return out


def drive_window(rt: Runtime, cfg, weights: list, batches, gen, reqs=None):
    """Every tenant submits one decode step of every layer with its own
    activations (or the (tenant, request) pairs ``reqs``), and the
    runtime drains.  Returns the tickets, the wall time up to the last
    result being ready, the window's launch records and its launches."""
    t0 = time.perf_counter()
    n0 = len(rt.telemetry.groups)
    if reqs is None:
        reqs = window_requests(rt.ctrl, cfg, weights, batches, gen, rt.device)
    tickets = [rt.submit(r, tenant=t) for t, r in reqs]
    launches = rt.drain()
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    return tickets, time.perf_counter() - t0, rt.telemetry.groups[n0:], launches


def serve_window(rt: Runtime, cfg, weights: list, batches, gen, reqs=None) -> dict:
    """`drive_window`, then every result held against the plain version."""
    tickets, wall, recs, launches = drive_window(rt, cfg, weights, batches, gen, reqs)
    for tk in tickets:
        r = tk.request
        check_close(tk.result, gemm_ref(r.a, r.b), abs_product(r.a, r.b),
                    f"ticket {tk.seq} {r.desc.key()} ({tk.plan.mode})")
    req_bytes = sum(tk.request.b.numel() * 2 for tk in tickets)
    modes = Counter(g.mode for g in recs)
    tiles = Counter(f"{KERNEL_OF_MODE[ln.plan.mode]} "
                    f"{gemm_kernel.instantiation(torch.bfloat16, ln.plan.tile.bm)}"
                    for ln in launches)
    return dict(requests=len(tickets), launches=dict(modes), tiles=tiles,
                wall_s=wall,
                device_s=sum(g.achieved_time_s or 0.0 for g in recs),
                request_weight_gb=req_bytes / 1e9, tickets=tickets,
                launch_list=launches)


KERNEL_OF_MODE = {"single": "matmul", "grouped": "grouped_matmul",
                  "ragged": "ragged_matmul"}
KERNEL_KINDS = (("stream_k_matmul_kernel", "stream_k_matmul"),
                ("matmul_kernel", "matmul"), ("grouped_kernel", "grouped_matmul"),
                ("splitk_kernel", "splitk_matmul"),
                ("fixup_kernel", "stream-K fixup"),
                ("ragged_kernel", "ragged_matmul"), ("flash_bf16_kernel", "flash_attention"),
                ("flash_prefill_kernel", "flash_prefill"),
                ("mamba_decode_kernel", "mamba_scan"), ("ssd_state_kernel", "mamba_scan"),
                ("ssd_carry_kernel", "mamba_scan"), ("ssd_output_kernel", "mamba_scan"),
                ("Cat", "stack/cat copy"), ("indexSelect", "pool packing"),
                ("reduce", "isfinite checks"))


def planned(launches, kind: str) -> int:
    """The GEMMs of a decomposition among a window's launches: the members
    of mixed launches, and single launches, whose `decomposition` starts
    with ``kind`` ("split-K", "Stream-K"); a grouped or ragged launch of
    several members runs its own kernel."""
    n = 0
    for ln in launches:
        if ln.plan.mode == "mixed":
            pairs = zip(ln.tickets, ln.plan.tiles or [ln.plan.tile] * len(ln.tickets))
        elif ln.plan.mode == "single" or len(ln.tickets) == 1:
            pairs = [(ln.tickets[0], ln.plan.tile)]
        else:
            continue
        n += sum(tk.desc.family == "gemm" and
                 decomposition(tk.desc, t).startswith(kind) for tk, t in pairs)
    return n


def profile_window(label: str, drive) -> None:
    """One more warm window under `torch.profiler` (``drive`` runs it and
    returns its wall time and launches): device time by kernel kind, and
    the device's busy and idle shares of the window's wall time.  Busy
    time is the union of the kernels' intervals, so kernels that overlap
    on streams count once; the profiler's own overhead lengthens the wall
    time.  It also prints the split-K and Stream-K kernels' launches beside
    the split-K and Stream-K GEMMs the window planned, and the port's
    reduce and fixup kernels seen (none: split-K sums its slices in its
    cluster epilogue, Stream-K its cut tiles in its arrival epilogue)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, launches = drive()
    by_kind, launched, total, reduces = {}, Counter(), 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        total += us
        kind = next((k for pat, k in KERNEL_KINDS if pat in evt.key), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
        launched[kind] += evt.count
        reduces += evt.count if "repro::reduce" in evt.key else 0
    if total == 0.0:
        print(f"# profiled {label}: the profiler recorded no device time "
              "(per-launch CUDA-event times are above)")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms ({v / total:.1%})"
                      for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1]))
    print(f"# profiled {label}: wall {wall:.6f} s, kernel time {total / 1e6:.6f} s, "
          f"device busy {busy / 1e6:.6f} s (idle {1 - busy / 1e6 / wall:.1%}); {parts}; "
          f"split-K kernel launches {launched['splitk_matmul']} for "
          f"{planned(launches, 'split-K')} split-K GEMMs planned; split-K reduce "
          f"kernels {reduces}; Stream-K kernel launches {launched['stream_k_matmul']} "
          f"for {planned(launches, 'Stream-K')} Stream-K GEMMs planned; fixup kernels "
          f"{launched['stream-K fixup']}")


def serving_phase(device="cuda", cfg=None, layers=None) -> dict:
    cfg = cfg or get_arch("qwen3-14b")
    layers = layers or cfg.n_layers
    gen = torch.Generator(device=device).manual_seed(SEED)
    weights = make_weights(cfg, layers, gen, device)
    model_gb = sum(w.numel() * 2 for wl in weights for w in wl.values()) / 1e9
    print(f"# serving {cfg.name}: {layers} layers, weights {model_gb:.2f} GB "
          f"on {device}")
    rt = Runtime(ConcurrencyController(),
                 RuntimeConfig(window_s=0.0, execute=True), device=device)
    reset_counts()
    windows = []
    for batches in SERVING_WINDOWS:
        for run in ("cold", "warm"):
            w = serve_window(rt, cfg, weights, batches, gen)
            del w["tickets"], w["launch_list"]
            windows.append(w)
            print(f"# window batches {batches} ({run} plans): {w['requests']} "
                  f"requests, launches {w['launches']}, wall {w['wall_s']:.6f} s, "
                  f"device {w['device_s']:.6f} s, "
                  f"{w['request_weight_gb'] / w['wall_s']:.1f} request-weight GB/s, "
                  f"{model_gb / w['wall_s']:.1f} model-weight GB/s")
    counts = launch_counts()
    modes = rt.telemetry.mode_counts()
    print(f"# serving modes {modes}; kernel launches {counts}")
    check_healthy(rt, "per-class serving")
    check_feeds("per-class serving", device)
    missing = [k for k in PER_CLASS_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"the per-class serving path never launched {missing}")
    tiles = sum((w["tiles"] for w in windows), Counter())
    print(f"# serving CTA tiles (kernel, instantiation): {dict(tiles)}")
    if not {"grouped", "ragged"} <= set(modes) or not (
            modes.get("single", 0) + modes.get("fused", 0)):
        raise AssertionError(f"serving did not run every launch mode: {modes}")
    if device == "cuda":
        for batches in SERVING_WINDOWS:
            profile_window(f"window batches {batches}", lambda: drive_window(
                rt, cfg, weights, batches, gen)[1::2])
    check_healthy(rt, "per-class serving, profiled windows")
    dynamic_logic_phase(cfg, weights, gen, device)
    return dict(counts=counts, windows=windows, model_gb=model_gb)


# ---------------------------------------------------------- dynamic logic
# The paper's training set: 1,072 GEMMs (§5.2), 90/10 split.
TRAIN_POOL, TRAIN_SEED = 1072, 17
# Card-trained W against CPU-trained W from the same w0, elementwise:
# |ΔW| ≤ W_TOL·max(1, |W|).  Both run the same float32 Adam steps and sum
# float32 products in their own orders (a CPU run of the port against
# the JAX reference reads ~3e-6 at |W| ≤ 11.5).
W_TOL = 1e-4
MEASURED_CDS = (2, 4, 8, 16)


def train_phase(lib, device):
    """(a) The predictor trained on the paper's dataset on ``device``,
    held to one trained on the CPU from the same initial weights."""
    pool = generate_gemm_pool(TRAIN_POOL, seed=TRAIN_SEED)
    t0 = time.perf_counter()
    lib.prewarm(pool)
    X, y = profile_dataset(pool, lib)
    profile_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    idx = rng.permutation(len(X))
    tr, te = idx[:int(0.9 * len(X))], idx[int(0.9 * len(X)):]
    w0 = (0.01 * rng.standard_normal((X.shape[1] + 1, len(CLASSES)))).astype(np.float32)
    t0 = time.perf_counter()
    pred = train_predictor(X[tr], y[tr], w0=w0, device=device)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = train_predictor(X[tr], y[tr], w0=w0, device="cpu")
    cpu_s = time.perf_counter() - t0
    dw = np.abs(pred.W - cpu.W)
    if (dw > W_TOL * np.maximum(1.0, np.abs(cpu.W))).any():
        raise AssertionError(f"card-trained W off the CPU-trained W by {dw.max():.3g}")
    for avail in (1, 2, 4, 8, 16):
        if not np.array_equal(pred.predict_cd(X, avail), cpu.predict_cd(X, avail)):
            raise AssertionError(f"card- and CPU-trained CDs differ at available {avail}")
    acc = accuracy_by_available(pred, X[te], y[te])
    labels = np.asarray(CLASSES)[y[te]]
    majority = {a: float(np.bincount(np.minimum(labels, a)).max() / len(te))
                for a in acc}
    seeded = train_predictor(X[tr], y[tr], seed=SEED, device=device)
    print(f"# predictor: {len(pool)} GEMMs profiled in {profile_s:.3f} s (host), "
          f"{len(tr)} trained / {len(te)} held out; 600 epochs on {device} in "
          f"{train_s:.3f} s (CPU {cpu_s:.3f} s), max |ΔW| vs CPU {dw.max():.3g} at "
          f"|W| ≤ {np.abs(cpu.W).max():.3g}, CDs equal at available 1-16")
    print(f"# predictor held-out accuracy by available {acc} (majority class "
          f"{majority}); from the seeded draw on {device} "
          f"{accuracy_by_available(seeded, X[te], y[te])}")
    return pred


def run_lengths(rows) -> str:
    """[(cd, mode), ...] as "3×(16 grouped), (8 ragged)"."""
    out = []
    for r in rows:
        if out and out[-1][1] == r:
            out[-1][0] += 1
        else:
            out.append([1, r])
    return ", ".join(f"{n}×({r[0]} {r[1]})" if n > 1 else f"({r[0]} {r[1]})"
                     for n, r in out)


def class_rows(launches) -> dict:
    rows = {}
    for ln in launches:
        rows.setdefault(ln.class_key, []).append((ln.plan.cd, ln.plan.mode))
    return rows


def predicted_serving(cfg, weights, pred, gen, device) -> int:
    """(b) Phase 4's windows planned by the predictor, every result held
    to the plain version; per class, the launches' CD and mode beside the
    oracle controller's plan of the same queue.  Returns the launches
    that differ."""
    rt = Runtime(ConcurrencyController(default_library(), predictor=pred),
                 RuntimeConfig(window_s=0.0, execute=True), device=device)
    oracle = Runtime(ConcurrencyController(default_library()),
                     RuntimeConfig(window_s=0.0), device=device)
    differ = 0
    for batches in SERVING_WINDOWS:
        for run in ("cold", "warm"):
            w = serve_window(rt, cfg, weights, batches, gen)
            for tk in w["tickets"]:
                oracle.submit(tk.request, tenant=tk.tenant)
            mine, theirs = class_rows(w["launch_list"]), class_rows(oracle.drain())
            n = sum(sum(a != b for a, b in zip(mine.get(k, []), theirs.get(k, [])))
                    + abs(len(mine.get(k, [])) - len(theirs.get(k, [])))
                    for k in set(mine) | set(theirs))
            differ += n
            print(f"# predictor window batches {batches} ({run} plans): "
                  f"{w['requests']} requests, launches {w['launches']}, wall "
                  f"{w['wall_s']:.6f} s, device {w['device_s']:.6f} s; {n} of "
                  f"{len(w['launch_list'])} launches differ from the oracle's plan")
            for k in sorted(set(mine) | set(theirs)):
                print(f"#   class {k}: predictor {run_lengths(mine.get(k, []))} | "
                      f"oracle {run_lengths(theirs.get(k, []))}")
    check_healthy(rt, "serving through the predictor")
    return differ


def queued_per_gemm(desc, entry) -> dict:
    """Device ms per GEMM of the launch `Measurer` times at each CD, the
    launches queued behind a sleep of the card (`time_ms`), so the host's
    enqueue, which the Measurer's event pair includes, is left out."""
    out = {}
    for cd in (1, *MEASURED_CDS):
        reqs = [synth_request(desc, seed=i) for i in range(cd)]
        sched = schedule_for(desc, entry.tile_for_cd(cd), cd)
        out[cd] = time_ms(lambda: execute_schedule(reqs, sched)) / cd
    return out


def measure_phase(cfg, pred, lib, device) -> None:
    """(c) The four fused decode GEMMs at batch 8 measured on ``device`` at
    CD 1 and `MEASURED_CDS`, beside the library's modeled CD and the
    predictor's; then one re-ranked by measurement (`tune_gemm(...,
    measure=)`), its entry saved to a library file and loaded back.
    The only gate on timings: every one is finite."""
    mzr = Measurer(device=device)
    descs = [GemmDesc(8, n, k) for k, n in fused_shapes(cfg)]
    for d in descs:
        entry = lib.get(d)
        ms = mzr.measure_entry(d, entry, cds=MEASURED_CDS)
        bad = [cd for cd, m in ms.items() if not m.finite]
        if bad:
            raise AssertionError(f"{d.key()}: non-finite measurement at CDs {bad}")
        per_gemm = {cd: m.time_s / cd for cd, m in ms.items()}
        fastest = min(per_gemm, key=per_gemm.get)
        cd_pred = int(pred.predict_cd(op_features(d, lib), available=16)[0])
        print(f"# measured {d.key()} on {mzr.backend}: seconds per launch "
              f"{ {cd: m.time_s for cd, m in ms.items()} }, per GEMM "
              f"{per_gemm}; measured-fastest CD {fastest}, modeled "
              f"{entry.preferred_cd()}, predictor {cd_pred}; tiles "
              f"{ {cd: entry.tile_for_cd(cd).key() for cd in ms} }")
        if device == "cuda":
            print(f"#   device only (the same launches queued behind a sleep of "
                  f"the card, no host time): ms per GEMM {queued_per_gemm(d, entry)}")
    d = GemmDesc(8, cfg.n_heads * cfg.resolved_head_dim, cfg.d_model)
    entry = tune_gemm(d, measure=Measurer(device=device))
    bad = {cd: t for cd, t in entry.measured.items() if not math.isfinite(t)}
    if bad or set(entry.measured) != {1, *CDS}:
        raise AssertionError(f"{d.key()}: re-rank measured {entry.measured}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = Path(tmp) / "golib.json"
        saved = GOLibrary()
        saved._entries[d.key()] = entry
        saved.save(path)
        back = GOLibrary(path).entries()[d.key()]
    if (back.measured, back.measure_backend, back.measure_run_id) != (
            entry.measured, mzr.backend, entry.measure_run_id):
        raise AssertionError(f"{d.key()}: measured entry did not survive save/load")
    modeled = lib.get(d)
    moved = {cd: f"{modeled.go[cd].key()} -> {t.key()}" for cd, t in entry.go.items()
             if t != modeled.go[cd]}
    print(f"# re-ranked {d.key()} on {entry.measure_backend} (run {entry.measure_run_id}): "
          f"measured seconds {entry.measured}, sources {entry.rc_source}, GO tiles "
          f"moved {moved or 'none'}; saved and loaded back with its measured map")


def dynamic_logic_phase(cfg, weights, gen, device) -> None:
    """Training, serving through the predictor and measuring, with phase
    4's weights on the card.  Its launches are counted apart and the
    counters zeroed after it, so the `kernels` line counts only the
    serving paths."""
    lib = default_library()
    reset_counts()
    pred = train_phase(lib, device)
    differ = predicted_serving(cfg, weights, pred, gen, device)
    measure_phase(cfg, pred, lib, device)
    counts = launch_counts()
    print(f"# dynamic logic: {differ} launches differ from the oracle's plans; "
          f"kernel launches of this phase (not in the kernels line) {counts}")
    reset_counts()


# --------------------------------------------------------- bundle serving
MIXED_WINDOWS = (([1], 16), ([4, 8, 8, 16], 4), ([4, 8, 8, 16], 2))
# Members of mixed launches queued at once behind one sleep of the card:
# a whole batch-1 window (280 members: 320 kernels and ~900 stream
# events) fits in the launch queue; a 1,120-member window does not.
QUEUED_MEMBERS = 200


def unfused_descs(cfg, batch: int) -> list:
    """One layer's seven unfused decode GEMMs (q, k, v, o, gate, up,
    down): `decode_step_descs` flattened."""
    return [d for _, bundle in decode_step_descs(cfg, batch) for d in bundle]


def make_unfused_weights(cfg, layers: int, gen, device) -> list:
    """Per layer, the weights of `unfused_descs` in order, stored (K, N)."""
    shapes = [(d.K, d.N) for d in unfused_descs(cfg, 1)]
    return [[torch.randn((k, n), generator=gen, device=device,
                         dtype=torch.bfloat16).mul_(k ** -0.5) for k, n in shapes]
            for _ in range(layers)]


def decomposition(desc, tile) -> str:
    """Which kernels a member at ``tile`` runs."""
    if tile.stream_k:
        return f"Stream-K g{tile.stream_k}"
    split, _ = gemm_kernel.split_k_slices(desc.K, tile.bk, tile.split_k)
    return f"split-K s{split}" if split > 1 else "matmul"


def check_tickets(tickets) -> None:
    for tk in tickets:
        r = tk.request
        check_close(tk.result, gemm_ref(r.a, r.b), abs_product(r.a, r.b),
                    f"ticket {tk.seq} {r.desc.key()} ({tk.plan.mode})")


def drive_bundles(rt: Runtime, cfg, weights: list, batches, gen):
    """Per layer, every tenant submits its seven decode GEMMs as one bundle
    with its own activations, and the runtime drains: one flush per
    layer.  Returns the bundle tickets, the wall time up to the last
    result being ready, the window's launch records and its launches."""
    t0 = time.perf_counter()
    n0 = len(rt.telemetry.groups)
    handles, launches = [], []
    for wl in weights:
        for ti, batch in enumerate(batches):
            reqs = [GemmRequest(desc=d, b=w, a=torch.randn(
                (d.M, d.K), generator=gen, device=rt.device, dtype=torch.bfloat16))
                for d, w in zip(unfused_descs(cfg, batch), wl)]
            handles.append(rt.submit(reqs, tenant=f"tenant{ti}"))
        launches += rt.drain()
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    return handles, time.perf_counter() - t0, rt.telemetry.groups[n0:], launches


def mixed_window(rt: Runtime, cfg, weights: list, batches, gen) -> dict:
    """`drive_bundles`, then every result held against the plain version."""
    handles, wall, recs, launches = drive_bundles(rt, cfg, weights, batches, gen)
    if not all(h.done for h in handles):
        raise AssertionError("a bundle was left unfinished")
    tickets = [m for h in handles for m in h.members]
    check_tickets(tickets)
    members = Counter(decomposition(tk.desc, t) for ln in launches
                      for tk, t in zip(ln.tickets, ln.plan.tiles or [ln.plan.tile]))
    return dict(requests=len(tickets), launches=dict(Counter(g.mode for g in recs)),
                members=dict(members), split_k=planned(launches, "split-K"),
                stream_k=planned(launches, "Stream-K"), wall_s=wall,
                device_s=sum(g.achieved_time_s or 0.0 for g in recs),
                request_weight_gb=sum(tk.request.b.numel() * 2 for tk in tickets) / 1e9,
                launch_list=launches)


def stream_k_schedule(rt: Runtime, gen) -> Counter:
    """One mixed schedule the planner makes for a bundle of four
    32×512×17408 GEMMs and three 1×5120×17408 ones: a CD-7 group whose
    members run Stream-K (32x128x128g8) and split-K tiles at once.
    Returns the GEMMs it ran by decomposition ("split-K s8", ...)."""
    descs = [GemmDesc(32, 512, 17408)] * 4 + [GemmDesc(1, 5120, 17408)] * 3
    sched = rt.ctrl.plan_mixed(descs, available=16)
    tiles = [t for g in sched.groups for t in (g.tiles or [g.tile])]
    if not any(t.stream_k for t in tiles) or sched.groups[0].mode != "mixed":
        raise AssertionError(f"the planner gave no mixed Stream-K member: {tiles}")
    reqs = [GemmRequest(desc=d, a=randn((d.M, d.K), gen),
                        b=randn((d.K, d.N), gen, scale=d.K ** -0.5)) for d in descs]
    for r, out in zip(reqs, execute_schedule(reqs, sched)):
        check_close(out, gemm_ref(r.a, r.b), abs_product(r.a, r.b),
                    f"mixed member {r.desc.key()}")
    print(f"# mixed Stream-K schedule: {[(g.mode, g.cd) for g in sched.groups]}, "
          f"member tiles {[t.key() for t in tiles]}")
    return Counter(decomposition(descs[i], t) for g in sched.groups
                   for i, t in zip(g.indices, g.tiles or [g.tile] * len(g.indices)))


def concurrency_ratio(launches, lib):
    """The window's launches again, (a) as planned — each mixed group's
    members at once on their streams, at their GO tiles — (b) the same
    members at the same tiles back to back on one stream, and (c) back to
    back at each member's isolated tile (the paper's sequential
    baseline), in turns a, b, c, c, b, a.  Each is timed in chunks of
    launches of at most `QUEUED_MEMBERS` members, every chunk queued
    behind a sleep of the card (`device_s`), and the chunks' times add.
    None when the host could not queue a chunk ahead of the card."""
    chunks, size = [[]], 0
    for ln in launches:
        reqs = [t.request for t in ln.tickets]
        if size + len(reqs) > QUEUED_MEMBERS and chunks[-1]:
            chunks.append([])
            size = 0
        size += len(reqs)
        chunks[-1].append((reqs, Schedule(groups=[replace(
            ln.plan, indices=list(range(len(reqs))))]),
            ln.plan.tiles or [ln.plan.tile] * len(reqs),
            [lib.get(r.desc).isolated for r in reqs]))

    def concurrent(units):
        for reqs, sched, _, _ in units:
            execute_schedule(reqs, sched)

    def back_to_back(units, isolated: bool):
        for reqs, _, go, iso in units:
            for r, t in zip(reqs, iso if isolated else go):
                _run_op(r, t)

    fns = dict(concurrent=concurrent,
               back_to_back=lambda units: back_to_back(units, False),
               isolated=lambda units: back_to_back(units, True))
    for fn in fns.values():     # warm: buffers and streams exist before timing
        fn(chunks[0])
    runs = {k: [] for k in fns}
    for k in ("concurrent", "back_to_back", "isolated", "isolated", "back_to_back",
              "concurrent"):
        total = 0.0
        for units in chunks:
            t = device_s(lambda: fns[k](units))
            if t is None:
                return None
            total += t
        runs[k].append(total)
    mean = {k: sum(v) / len(v) for k, v in runs.items()}
    return dict(concurrent_s=mean["concurrent"], back_to_back_s=mean["back_to_back"],
                isolated_s=mean["isolated"],
                ratio=mean["back_to_back"] / mean["concurrent"],
                isolated_ratio=mean["isolated"] / mean["concurrent"], runs=runs,
                chunks=len(chunks))


def mixed_phase(device="cuda", cfg=None, layers=None) -> dict:
    cfg = cfg or get_arch("qwen3-14b")
    layers = layers or cfg.n_layers
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    weights = make_unfused_weights(cfg, layers, gen, device)
    model_gb = sum(w.numel() * 2 for wl in weights for w in wl) / 1e9
    print(f"# bundle serving {cfg.name}: {layers} layers × 7 unfused GEMMs, weights "
          f"{model_gb:.2f} GB on {device}")
    rt = Runtime(ConcurrencyController(),
                 RuntimeConfig(window_s=0.0, execute=True), device=device)
    reset_counts()
    windows = []
    for batches, available in MIXED_WINDOWS:
        rt.set_available(available)
        for run in ("cold", "warm"):
            w = mixed_window(rt, cfg, weights, batches, gen)
            w.update(batches=batches, available=available, plans=run)
            windows.append(w)
            print(f"# bundle window batches {batches} available {available} ({run} "
                  f"plans): {w['requests']} requests, launches {w['launches']}, "
                  f"members {w['members']}, wall {w['wall_s']:.6f} s, device "
                  f"{w['device_s']:.6f} s, {w['request_weight_gb'] / w['wall_s']:.1f} "
                  f"request-weight GB/s, {model_gb / w['wall_s']:.1f} model-weight GB/s")
    sched = stream_k_schedule(rt, torch.Generator(device=device).manual_seed(SEED + 2))
    plan = {kind: sum(w[key] for w in windows) +
            sum(n for d, n in sched.items() if d.startswith(kind))
            for kind, key in (("split-K", "split_k"), ("Stream-K", "stream_k"))}
    counts = launch_counts()
    print(f"# bundle serving modes {rt.telemetry.mode_counts()}; kernel launches {counts}; "
          f"GEMMs planned by decomposition {plan}")
    check_feeds("bundle serving", device)
    check_healthy(rt, "bundle serving")
    missing = [k for k in MIXED_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"the bundle path never launched {missing}")
    for kind, name in (("split-K", "splitk_matmul"), ("Stream-K", "stream_k_matmul")):
        if device == "cuda" and counts[name] != plan[kind]:
            raise AssertionError(f"{counts[name]} {kind} launches for {plan[kind]} "
                                 f"{kind} GEMMs planned: a {kind} GEMM is one launch")
    if device == "cuda":
        for w in windows[1::2]:     # the warm windows
            r = w["ratio"] = concurrency_ratio(w["launch_list"], rt.ctrl.lib)
            what = (f"# warm window batches {w['batches']} available {w['available']}, "
                    f"{len(w['launch_list'])} launches")
            if r is None:
                print(f"{what}: concurrent vs back to back not measured (the host "
                      "could not queue a chunk ahead of the card)")
                continue
            print(f"{what}: concurrent on streams {r['concurrent_s']:.6f} s, back to "
                  f"back on one stream {r['back_to_back_s']:.6f} s (ratio "
                  f"{r['ratio']:.4f}), back to back at isolated tiles "
                  f"{r['isolated_s']:.6f} s (ratio {r['isolated_ratio']:.4f}), in "
                  f"{r['chunks']} queued chunks; runs {r['runs']}; the runtime's own "
                  f"fork-to-join times {w['device_s']:.6f} s")
        for batches, available in MIXED_WINDOWS:
            rt.set_available(available)
            profile_window(f"bundle window batches {batches} available {available}",
                           lambda: drive_bundles(rt, cfg, weights, batches, gen)[1::2])
    check_healthy(rt, "bundle serving, profiled windows")
    for w in windows:
        del w["launch_list"]
    return dict(counts=counts, windows=windows, model_gb=model_gb, weights=weights)


# -------------------------------------------- attention and scan kernels
SCAN_TOL = 3e-4
# Above N, P = 128 the reference tests have no shape: at N = P = 512 a y
# sums 4x the terms of their widest, and the f32 route's split products
# (about 2^-17 of each term: the kernel's and its bf16x2 emulation's error
# both measured under 1.8e-6 of the terms' magnitude on an H100, PERF.md
# section 6)
# reach past SCAN_TOL near zero crossings.  The wide checks add this share
# of the terms' magnitudes, as the GEMM checks add 2^-16·|A|·|B|.
WIDE_SUM_TOL = 2.0 ** -16
# The reference tests' bf16 attention tolerance (atol = rtol): only for
# SDPA, a library call with roundings of its own, timed beside the kernel.
SDPA_TOL = 3e-2
# (B, Hq, Hkv, T, S, D, Dv, causal, window, bq, bkv)
ATTN_CASES = (
    (2, 40, 8, 1, 4096, 128, 128, True, 0, 8, 128),   # GQA decode (Qwen3-14B)
    (2, 32, 32, 1, 2048, 64, 64, True, 0, 8, 128),    # MHA decode (Zamba2)
    (1, 4, 2, 37, 250, 32, 32, True, 0, 8, 128),      # q_offset 213, S % bkv != 0
    (2, 4, 4, 64, 300, 64, 64, True, 16, 64, 128),    # window
    (1, 8, 2, 130, 130, 128, 128, True, 0, 128, 512),  # prefill, q block > rows
    (1, 2, 2, 20, 100, 32, 16, False, 0, 8, 256),     # dv != dqk, not causal
    (1, 4, 4, 9, 140, 192, 128, True, 0, 8, 128),     # dv != dqk, 256-wide
    (2, 4, 2, 300, 300, 128, 128, True, 100, 128, 128),  # a windowed prefill
    (2, 4, 4, 100, 100, 80, 80, True, 0, 128, 128),   # D 80 on the 128-wide kernel
    (1, 4, 4, 140, 200, 192, 128, True, 0, 128, 128),  # MLA's 192/128 over a longer cache
    (1, 10, 2, 333, 400, 128, 64, True, 50, 64, 128),  # ragged T, dv < dqk, a window
)
# (B, T, H, P, N, chunk, initial state, head-broadcast B/C)
SCAN_CASES = (
    (2, 70, 3, 16, 8, 32, False, False),
    (16, 1, 64, 64, 64, 32, False, True),     # the decode member (Zamba2)
    (16, 1, 64, 64, 64, 32, True, False),     # decode: a state, per-head B/C
    (1, 1, 64, 64, 64, 32, True, True),       # decode at batch 1: column slices
    (3, 1, 5, 30, 10, 16, True, False),       # decode: rows of 30 floats
    (2, 2, 64, 64, 64, 32, True, True),       # T = 2: the chunked form
    (1, 600, 2, 64, 64, 512, True, False),
    (1, 300, 2, 32, 16, 8, True, True),
    (1, 200, 4, 64, 128, 64, False, False),
    (2, 97, 2, 128, 32, 128, True, True),
    # the wide passes (N or P > 128): xLSTM's memory and normaliser at a
    # prompt and a step, odd wide widths
    (2, 300, 2, 512, 512, 128, True, False),
    (2, 300, 2, 1, 512, 128, True, False),
    (4, 1, 4, 512, 512, 32, True, False),
    (4, 1, 4, 1, 512, 32, False, True),
    (2, 97, 2, 200, 300, 64, True, True),
)


def tol_excess(out, ref, atol: float, rtol: float, what: str) -> tuple[float, int]:
    """The max |out − ref| and the number of elements beyond atol +
    rtol·|ref|; ``out`` must be finite and of ``ref``'s shape."""
    if out.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    o, r = out.float(), ref.float()
    if not bool(torch.isfinite(o).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = (o - r).abs()
    return float(err.max()), int((err > atol + rtol * r.abs()).sum())


def check_tol(out, ref, atol: float, rtol: float, what: str) -> float:
    """|out − ref| ≤ atol + rtol·|ref| elementwise, both finite and of one
    shape; returns the max absolute error."""
    err, n_bad = tol_excess(out, ref, atol, rtol, what)
    if n_bad:
        raise AssertionError(f"{what}: {n_bad} elements beyond {atol} + {rtol}·|ref|, "
                             f"max |err| {err:.4g}")
    return err


def attention_f32_ref(q, k, v, q_offset: int, **kw):
    """`flash_ref` on f32 copies of the inputs, kept in f32."""
    return flash_ref(q.float(), k.float(), v.float(), q_offset=q_offset, **kw)


def check_attention(out, q, k, v, q_offset: int, what: str, **kw) -> float:
    return check_tol(out, attention_f32_ref(q, k, v, q_offset, **kw),
                     *attention_tol(out.dtype), what)


def planted_fault(q, k, v, kw: dict, lo: int = 2048) -> None:
    """The bf16 tolerance's power at the path's shape: the kernel run
    without keys [lo, lo + 64) gives what a kernel that skipped that 64-key
    sub-tile would; it must fail `check_attention`.  Prints how far off it
    is, and how many of its outputs the reference tests' bf16 tolerance
    (3e-2 + 3e-2·|ref|) would have let through."""
    keep = torch.ones(k.shape[2], dtype=torch.bool, device=k.device)
    keep[lo:lo + 64] = False
    fault = flash_attention_fwd(q, k[:, :, keep], v[:, :, keep],
                                **{**kw, "q_offset": kw["q_offset"] - 64})
    ref = attention_f32_ref(q, k, v, kw["q_offset"])
    err, n_bad = tol_excess(fault, ref, *attention_tol(fault.dtype), "planted fault")
    _, n_loose = tol_excess(fault, ref, SDPA_TOL, SDPA_TOL, "planted fault")
    atol, rtol = attention_tol(fault.dtype)
    print(f"# planted fault (keys [{lo}, {lo + 64}) skipped) at the main shape: max |err| "
          f"{err:.4g}; {n_bad} of {fault.numel()} outputs beyond {atol} + {rtol:.6g}·|ref| "
          f"(3e-2 + 3e-2·|ref|: {n_loose})")
    if not n_bad:
        raise AssertionError("the attention tolerance lets a skipped kv sub-tile through")


def scan_excess(y, state, xd, da, bm, cm, s0, what: str) -> dict:
    """y and the state against the plain version in f32 on the same inputs
    (bf16 converts exactly): for each, the max |err| and the elements
    beyond atol + rtol·|plain| (atol: SCAN_TOL; rtol: SCAN_TOL, plus half
    a bf16 unit for a bf16 y).  Where N or P exceeds 128 (the wide
    passes), atol adds WIDE_SUM_TOL·Σ|terms|, as the GEMM checks add
    2⁻¹⁶·|A|·|B|: Σ|terms| is the plain version on |xd|, |B|, |C| and
    |s0| (its decays are positive)."""
    f32 = [t.float() for t in (xd, da, bm, cm)]
    y_ref, s_ref = ssd_chunk_ref(*f32, chunk=64, initial_state=s0)
    atol_y = atol_s = SCAN_TOL
    if max(bm.shape[-1], xd.shape[-1]) > NARROW_DIM:
        y_abs, s_abs = ssd_chunk_ref(f32[0].abs(), f32[1], f32[2].abs(), f32[3].abs(),
                                     chunk=64,
                                     initial_state=None if s0 is None else s0.abs())
        atol_y, atol_s = SCAN_TOL + WIDE_SUM_TOL * y_abs, SCAN_TOL + WIDE_SUM_TOL * s_abs
    rtol = SCAN_TOL + (2.0 ** -8 if y.dtype == torch.bfloat16 else 0.0)
    return {"y": tol_excess(y, y_ref, atol_y, rtol, what + " y"),
            "state": tol_excess(state, s_ref, atol_s, SCAN_TOL, what + " state")}


def check_scan(y, state, xd, da, bm, cm, s0, what: str) -> float:
    """`scan_excess` must find no element beyond the tolerance; returns y's
    max |err|."""
    ex = scan_excess(y, state, xd, da, bm, cm, s0, what)
    bad = {k: v for k, v in ex.items() if v[1]}
    if bad:
        raise AssertionError(f"{what}: " + "; ".join(
            f"{k}: {n} elements beyond {SCAN_TOL} + rtol·|ref|, max |err| {e:.4g}"
            for k, (e, n) in bad.items()))
    return ex["y"][0]


def scan_inputs(B, T, H, P, N, gen, dtype, broadcast: bool):
    """xd, da (≤ 0), and B/C (B,T,H,N) — as head-broadcast views of
    (B,T,N) (head stride 0, Mamba2's group-shared layout) when asked."""
    xd = randn((B, T, H, P), gen, dtype)
    da = (torch.rand((B, T, H), generator=gen, device="cuda") * -0.5).to(dtype)
    if broadcast:
        bm, cm = (randn((B, T, N), gen, dtype, 0.5)[:, :, None].expand(B, T, H, N)
                  for _ in range(2))
    else:
        bm, cm = randn((B, T, H, N), gen, dtype, 0.5), randn((B, T, H, N), gen, dtype, 0.5)
    return xd, da, bm, cm


def attention_scan_cases(gen) -> int:
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for i, (B, Hq, Hkv, T, S, D, Dv, causal, window, bq, bkv) in enumerate(ATTN_CASES):
            what = (f"flash B{B} Hq{Hq} Hkv{Hkv} T{T} S{S} D{D}/{Dv} causal{causal:d} "
                    f"window{window} bq{bq} bkv{bkv} {dtype}")
            if i % 2:   # strided: (B, T, H, D) storage read as (B, H, T, D)
                q = randn((B, T, Hq, D), gen, dtype).transpose(1, 2)
                k = randn((B, S, Hkv, D), gen, dtype).transpose(1, 2)
                v = randn((B, S, Hkv, Dv), gen, dtype).transpose(1, 2)
            else:
                q, k, v = (randn((B, Hq, T, D), gen, dtype), randn((B, Hkv, S, D), gen, dtype),
                           randn((B, Hkv, S, Dv), gen, dtype))
            off = S - T if causal else 0
            route, before = attention_route(q, k, v), dict(flash_attention_fwd.routes)
            out = flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=off,
                                      bq=bq, bkv=bkv)
            if flash_attention_fwd.routes[route] != before[route] + 1:
                raise AssertionError(f"{what}: not launched on the {route} route")
            check_attention(out, q, k, v, off, what, causal=causal, window=window)
            n += 1
        for (B, T, H, P, N, L, with_s0, bcast) in SCAN_CASES:
            what = f"scan B{B} T{T} H{H} P{P} N{N} L{L} s0{with_s0:d} bcast{bcast:d} {dtype}"
            xd, da, bm, cm = scan_inputs(B, T, H, P, N, gen, dtype, bcast)
            s0 = randn((B, H, N, P), gen, torch.float32) if with_s0 else None
            route, before = scan_route(T, P, N, L), dict(mamba_scan_fwd.routes)
            y, state = mamba_scan_fwd(xd, da, bm, cm, chunk=L, initial_state=s0)
            if mamba_scan_fwd.routes[route] != before[route] + 1:
                raise AssertionError(f"{what}: not launched on the {route} route")
            check_scan(y, state, xd, da, bm, cm, s0, what)
            n += 1
    return n


def scan_flops(B, T, H, P, N, L, groups: int | None = None) -> int:
    """The chunked scan's multiply-adds ×2 for these shapes: per (batch,
    head) and chunk of Lr rows, the weighted xd over the lower triangle,
    C·S_prev and the state update; C·Bᵀ over the lower triangle once per
    (batch, chunk, B/C group).  ``groups``: the distinct B/C heads (1 for
    head-broadcast views; H, one per head, when None)."""
    groups = H if groups is None else groups
    per_head = per_group = 0
    for c0 in range(0, T, L):
        lr = min(L, T - c0)
        per_head += lr * (lr + 1) * P + 4 * lr * N * P + N * P
        per_group += lr * (lr + 1) * N
    return B * (H * per_head + groups * per_group)


def dropped_split_fault(q, k, v, bufs, q_offset: int) -> None:
    """The combine's check at a split shape of the path: the kernel's own split
    partials merged in split order, as the kernel merges them, agree with
    its output within a bf16 unit; merged without one split they must fail
    `check_attention`.  Prints how far off that is."""
    splits = bufs.part_acc.shape[0] if bufs.part_acc is not None else 1
    if splits < 2:
        raise AssertionError("this attention shape runs one kv split: no combine")
    merged = flash_combine_ref(bufs.part_acc, bufs.part_ml, q.dtype)
    check_tol(bufs.out, merged, 1e-6, 2.0 ** -7, "kernel merge vs plain combine")
    drop = splits // 2
    keep = [i for i in range(splits) if i != drop]
    fault = flash_combine_ref(bufs.part_acc[keep], bufs.part_ml[keep], q.dtype)
    ref = attention_f32_ref(q, k, v, q_offset)
    err, n_bad = tol_excess(fault, ref, *attention_tol(fault.dtype), "dropped split")
    print(f"# planted fault (the combine without split {drop} of {splits}) at "
          f"{tuple(q.shape)}: max |err| {err:.4g}; {n_bad} of {fault.numel()} outputs "
          "beyond the attention tolerance")
    if not n_bad:
        raise AssertionError("the attention tolerance lets a dropped kv split through")


def attention_member(B: int, gen, lib, desc=None) -> dict:
    """A decode attention member at batch B — Qwen3-14B's (Hq 40, Hkv 8,
    Skv 4,096, D 128, bf16) unless ``desc`` is given: compared, then timed
    beside its plain version and SDPA, on operand sets rotating beyond the
    50 MB L2 (K+V is 16.8 MB per Qwen3-14B sequence).  A planted fault
    runs at each Qwen3-14B shape: skipped keys at batch 16, a dropped kv
    split at batch 1 (16 splits)."""
    bf16 = torch.bfloat16
    qwen = desc is None
    desc = desc or AttentionDesc(B, 40, 8, 1, 4096, 128)
    tile = lib.get(desc).isolated
    kw = dict(q_offset=desc.Skv - desc.Sq, **attention_tiles(tile))
    sets = [(randn((desc.B, desc.Hq, desc.Sq, desc.D), gen),
             randn((desc.B, desc.Hkv, desc.Skv, desc.D), gen),
             randn((desc.B, desc.Hkv, desc.Skv, desc.D), gen))
            for _ in range(-(-8 // B))]
    q, k, v = sets[0]
    bufs = attention_buffers(q, k, v)
    out = flash_attention_fwd(q, k, v, out=bufs, **kw)
    err = check_attention(out, q, k, v, kw["q_offset"], f"flash B{B}")
    splits, split_len = split_geometry(q, k, v)
    per_sm, smem = kernel_resources(q.device, bf16, width_for(desc.D, desc.D))
    ctas = desc.B * desc.Hkv * -(-(desc.Hq // desc.Hkv * desc.Sq) // 16) * splits
    print(f"# flash_attention grid at B{B}: {ctas} CTAs = {desc.B * desc.Hkv} (batch, kv "
          f"head) x {splits} kv splits of {split_len} keys; {smem} B shared memory per "
          f"CTA, {per_sm} CTAs per SM; K/V by {'TMA' if tma_loads(k, v) else 'registers'}")
    if qwen and B == 16:
        planted_fault(q, k, v, kw)
    elif qwen:
        dropped_split_fault(q, k, v, bufs, kw["q_offset"])
    # Every key is visible to the decode row (q_offset = Skv − 1), so the
    # non-causal SDPA call computes the same function.
    sdpa = torch.nn.functional.scaled_dot_product_attention(q, k, v, enable_gqa=True)
    check_tol(sdpa, attention_f32_ref(q, k, v, kw["q_offset"]), SDPA_TOL, SDPA_TOL,
              f"SDPA B{B}")
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2
    return dict(
        shape=f"B{desc.B} Hq{desc.Hq} Hkv{desc.Hkv} Sq{desc.Sq} Skv{desc.Skv} D{desc.D} "
              f"at {tile.key()} (bq {kw['bq']}, bkv {kw['bkv']})",
        instantiation=(f"bf16 head dim ≤ {width_for(desc.D, desc.D)}, {ctas} CTAs "
                       f"({splits} splits of {split_len} keys), {smem} B shared"),
        grid=dict(ctas=ctas, splits=splits, split_len=split_len, ctas_per_sm=per_sm,
                  smem_bytes=smem),
        max_abs_err=err,
        ms=time_ms(rotating(lambda x, y, z: flash_attention_fwd(x, y, z, out=bufs, **kw),
                            sets)),
        plain_ms=time_ms(lambda: flash_ref(q, k, v, q_offset=kw["q_offset"]), reps=3,
                         warmup=1),
        library_ms=time_ms(rotating(
            lambda x, y, z: torch.nn.functional.scaled_dot_product_attention(
                x, y, z, enable_gqa=True), sets)),
        bound=bound(nbytes, desc.flops, bf16))


def attention_scan_kernels(gen, lib) -> dict:
    """The op-bundle path's attention and scan members: Qwen3-14B's
    tenant-16 attention (K+V 268 MB, beyond the 50 MB L2) and its batch-1
    member (eight operand sets, 134 MB), DeepSeek-V2-Lite's at batches 16
    (403 MB) and 1 (eight sets, 201 MB), then `scan_rows`.  Each is
    compared, then timed beside its plain version and, for attention, the
    PyTorch call computing the same function."""
    rows = {"flash_attention": [attention_member(16, gen, lib),
                                attention_member(1, gen, lib)]}
    # DeepSeek-V2-Lite's MLA in materialized form (ROADMAP C11): head dim
    # 192 on the 256-wide instantiation, K+V 25.2 MB per sequence
    for B in (16, 1):
        rows["flash_attention"].append(attention_member(
            B, gen, lib, AttentionDesc(B, 16, 16, 1, 2048, 192)))
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    rows["mamba_scan"] = scan_rows(gen, lib)
    torch.cuda.empty_cache()
    print_rows(rows)
    return rows


L2_BYTES = 50 * 2 ** 20


def decode_flops(B, H, P, N, with_s0: bool) -> int:
    """The decode kernel's multiply-adds ×2: per (batch, head) C·B, y's
    products and B xdᵀ, and with a state exp(da)·S0 and C·S0 as well."""
    return 2 * B * H * (N + P * (2 if with_s0 else 1) + N * P * (3 if with_s0 else 1))


def planted_scan_fault(y, state, xd, da, bm, cm, b: int = 8, h: int = 32) -> None:
    """The scan check's power at the decode shape: the kernel's state
    without the B xdᵀ term of (batch b, head h), which a kernel that
    skipped that pair's update would give, must fail `check_scan`.
    Prints how far off it is."""
    fault = state.clone()
    fault[b, h] -= bm[b, 0, h].float()[:, None] * xd[b, 0, h].float()[None, :]
    ex = scan_excess(y, fault, xd, da, bm, cm, None, "planted scan fault")
    err, n_bad = ex["state"]
    print(f"# planted scan fault (the B·xd term of (batch {b}, head {h}) dropped) at "
          f"{tuple(xd.shape)}: max |err| {err:.4g}; {n_bad} of {fault.numel()} state "
          f"elements beyond {SCAN_TOL} + {SCAN_TOL}·|ref|, so check_scan fails it")
    if not n_bad:
        raise AssertionError("check_scan lets a dropped B·xd term through")


def decode_row(B: int, with_s0: bool, gen, L: int) -> dict:
    """Zamba2's decode member at batch B (64 heads, P = N = 64, bf16, B/C
    head-broadcast), on the decode kernel: compared on the first set, then
    timed on output (and initial-state) sets that rotate beyond the 50 MB
    L2 — at least 4 — so each call writes (and reads) its state in HBM."""
    H, P, N = 64, 64, 64
    xd, da, bm, cm = scan_inputs(B, 1, H, P, N, gen, torch.bfloat16, broadcast=True)
    state_b = B * H * N * P * 4
    set_b = state_b * (2 if with_s0 else 1) + B * H * P * 2
    n_sets = max(4, -(-L2_BYTES * 5 // 4 // set_b))
    sets = [(randn((B, H, N, P), gen, torch.float32) if with_s0 else None,
             *scan_buffers(xd, da, bm, cm)[:2]) for _ in range(n_sets)]
    s0, y, state = sets[0]
    before = dict(mamba_scan_fwd.routes)
    mamba_scan_fwd(xd, da, bm, cm, chunk=L, initial_state=s0, out=(y, state))
    if mamba_scan_fwd.routes["decode"] != before["decode"] + 1:
        raise AssertionError(f"the decode member at B{B} missed the decode route")
    what = f"scan decode B{B} s0{with_s0:d}"
    err = check_scan(y, state, xd, da, bm, cm, s0, what)
    g = decode_grid(B * H, P, N, torch.cuda.get_device_properties(0).multi_processor_count)
    per_sm, smem = decode_residency(xd.device, torch.bfloat16, s0=with_s0)
    print(f"# mamba_scan decode grid at B{B} H{H} P{P} N{N}: {g.ctas} CTAs of 256 threads, "
          f"{g.pairs_per_cta} pair(s) per CTA, {g.slices} column slice(s) of "
          f"{4 * g.groups} columns per pair, {g.row_lanes} row lanes; {per_sm} CTAs per "
          f"SM, {smem} B static shared memory; {n_sets} rotating sets of "
          f"{set_b / 1e6:.2f} MB ({n_sets * set_b / 1e6:.1f} MB)")
    if B == 16 and not with_s0:
        planted_scan_fault(y, state, xd, da, bm, cm)
        src = state.clone()
        states = [(st,) for _, _, st in sets]
        copy_ms = time_ms(rotating(lambda st: st.copy_(src), states), reps=50)
        zero_ms = time_ms(rotating(lambda st: st.zero_(), states), reps=50)
        print(f"# write ceiling at B{B}: copy_ of the {state_b / 1e6:.1f} MB state into "
              f"the {n_sets} rotating state buffers {copy_ms:.4f} ms ({state_b / copy_ms / 1e9:.3f} "
              f"TB/s written, as much read); zero_ of them {zero_ms:.4f} ms "
              f"({state_b / zero_ms / 1e9:.3f} TB/s written)")
    nbytes = ((xd.numel() + da.numel() + 2 * B * N) * 2 + y.numel() * 2
              + state_b * (2 if with_s0 else 1))
    return dict(
        shape=(f"B{B} T1 H{H} P{P} N{N}, B/C head-broadcast"
               f"{', initial state' if with_s0 else ''} (decode)"),
        instantiation=f"bf16 decode, {g.ctas} CTAs, {smem} B shared",
        route="decode",
        grid=dict(ctas=g.ctas, slices=g.slices, pairs_per_cta=g.pairs_per_cta,
                  ctas_per_sm=per_sm, smem_bytes=smem, rotating_sets=n_sets),
        max_abs_err=err,
        ms=time_ms(rotating(lambda s, yy, st: mamba_scan_fwd(
            xd, da, bm, cm, chunk=L, initial_state=s, out=(yy, st)), sets), reps=50),
        plain_ms=time_ms(lambda: ssd_chunk_ref(xd, da, bm, cm, chunk=L,
                                               initial_state=s0), reps=3, warmup=1),
        library_ms=None,
        bound=bound(nbytes, decode_flops(B, H, P, N, with_s0), torch.bfloat16))


def chunk_passes(dtype, B: int, T: int, H: int, P: int, N: int, L: int) -> dict:
    """The chunks route's three passes at these shapes (B/C head-broadcast):
    CTAs, CTAs per SM (occupancy query), waves on this card and dynamic
    shared memory per CTA, each pass printed on a line of its own."""
    g = chunk_grid(B, T, H, P, N, L, True, dtype)
    blocks, smem = chunk_residency(torch.device("cuda"), dtype, g.heads_per_cta, N, P, L)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name, ctas, per_sm, shared in (("state", g.state_ctas, blocks[0], smem[0]),
                                       ("carry", g.carry_ctas, blocks[1], 0),
                                       ("output", g.output_ctas, blocks[2], smem[1])):
        out[name] = dict(ctas=ctas, ctas_per_sm=per_sm, waves=ctas / (per_sm * sms),
                         smem_bytes=shared)
        print(f"# mamba_scan chunks {dtype} B{B} T{T} H{H} P{P} N{N} L{L}, {name} pass: "
              f"{ctas} CTAs, {per_sm} per SM, {ctas / (per_sm * sms):.2f} waves, "
              f"{shared} B dynamic shared memory; {g.heads_per_cta} heads a CTA")
    return out


def carried_close(incoming, decay, xd, da, bm, cm, s0, L: int, what: str) -> None:
    """The chunks route's workspace after a launch (each chunk's incoming
    state and decay) against the plain passes', within the scan tolerance."""
    f32 = [t.float() for t in (xd, da, bm, cm)]
    states, want_decay = ssd_chunk_states_ref(*f32, chunk=L)
    want_in, _ = ssd_carry_ref(states, want_decay, s0)
    check_tol(incoming, want_in, SCAN_TOL, SCAN_TOL, what + " carried states")
    check_tol(decay, want_decay, SCAN_TOL, SCAN_TOL, what + " chunk decays")


def planted_carry_fault(y, state, ws, xd, da, bm, cm, L: int) -> None:
    """The scan check's power at the prompt shape: the kernel's y and state
    with the middle chunk's incoming state taken as zero (`ssd_lost_carry`)
    must fail `check_scan`."""
    lost = ws[0].shape[2] // 2
    fy, fs = ssd_lost_carry(y, state, *ws, xd, da, bm, cm, chunk=L, lost=lost)
    ex = scan_excess(fy, fs, xd, da, bm, cm, None, "planted carry fault")
    print(f"# planted carry fault (chunk {lost}'s incoming state taken as zero) at "
          f"{tuple(xd.shape)}: y {ex['y'][1]} elements beyond the scan tolerance (max |err| "
          f"{ex['y'][0]:.4g}), state {ex['state'][1]} (max |err| {ex['state'][0]:.4g})")
    if not (ex["y"][1] or ex["state"][1]):
        raise AssertionError("check_scan lets a lost carry through")


def chunk_row(gen, dtype) -> dict:
    """Zamba2-1.2B's 4,096-token prompt scan (B1 H64 P64 N64, L 128, B/C
    head-broadcast) on the chunks route: checked on the first set (y, the
    state and the workspace's carried states; in bf16 a planted lost carry
    must fail the check), then timed on sets rotating beyond the 50 MB L2,
    each of its inputs, y, the state and the workspace (two sets or more)."""
    B, T, H, P, N, L = 1, ZAMBA_PROMPT, 64, 64, 64, 128
    e = torch.finfo(dtype).bits // 8
    nc = -(-T // L)
    set_b = (e * (2 * B * T * H * P + B * T * H + 2 * B * T * N) + 4 * B * H * N * P
             + 4 * B * H * nc * (N * P + 1))
    n_sets = max(2, -(-L2_BYTES * 5 // 4 // set_b))
    sets = [(*scan_inputs(B, T, H, P, N, gen, dtype, broadcast=True),
             torch.empty((B, T, H, P), device="cuda", dtype=dtype),
             torch.empty((B, H, N, P), device="cuda"),
             chunk_workspace(B, T, H, P, N, L, "cuda")) for _ in range(n_sets)]
    xd, da, bm, cm, y, state, ws = sets[0]
    before = dict(mamba_scan_fwd.routes)
    mamba_scan_fwd(xd, da, bm, cm, chunk=L, out=(y, state), workspace=ws)
    if mamba_scan_fwd.routes["chunks"] != before["chunks"] + 1:
        raise AssertionError("the prompt scan missed the chunks route")
    what = f"scan chunks T{T} {dtype}"
    err = check_scan(y, state, xd, da, bm, cm, None, what)
    carried_close(*ws, xd, da, bm, cm, None, L, what)
    if dtype == torch.bfloat16:
        planted_carry_fault(y, state, ws, xd, da, bm, cm, L)
    grid = chunk_passes(dtype, B, T, H, P, N, L)
    # the function's bytes: inputs read once (B/C: their (B,T,N) storage),
    # y and the state written
    nbytes = e * (2 * xd.numel() + da.numel() + 2 * B * T * N) + state.numel() * 4
    return dict(
        shape=f"B{B} T{T} H{H} P{P} N{N} L{L} {str(dtype)[6:]}, B/C head-broadcast (chunks)",
        instantiation=(f"{str(dtype)[6:]}, chunks in parallel, 3 passes, "
                       f"{chunk_grid(B, T, H, P, N, L, True, dtype).heads_per_cta} heads a CTA; "
                       f"{n_sets} rotating sets of {set_b / 1e6:.1f} MB"),
        route="chunks", grid=grid, max_abs_err=err,
        ms=time_ms(rotating(lambda *a: mamba_scan_fwd(*a[:4], chunk=L, out=a[4:6],
                                                      workspace=a[6]), sets)),
        plain_ms=time_ms(lambda: ssd_chunk_ref(xd, da, bm, cm, chunk=L), reps=3, warmup=1),
        library_ms=None,
        bound=bound(nbytes, scan_flops(B, T, H, P, N, L, groups=1), dtype))


def scan_rows(gen, lib) -> list:
    """The scan's rows: Zamba2's tenant-16 decode member (the serving
    path's shape) without and with an initial state and its batch-1
    member, on the decode kernel and rotating outputs; then Zamba2's
    4,096-token prompt scan (B1 T4096 L128) on the chunks route, in bf16
    and f32, on rotating input, output and workspace sets (y alone is
    33.5 MB in bf16)."""
    sdesc = ScanDesc(16, 1, 64, 64, 64)
    L = scan_chunk(lib.get(sdesc).isolated)
    rows = [decode_row(16, False, gen, L), decode_row(16, True, gen, L),
            decode_row(1, False, gen, L)]
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(chunk_row(gen, dtype))
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------- prompt scans
ZAMBA = "zamba2-1.2b"
ZAMBA_PROMPT = 4096   # tokens of Zamba2's prompt scan


def prompt_scan_phase(device="cuda", prompt: int = ZAMBA_PROMPT, layers=None) -> dict:
    """Zamba2-1.2B's prompt scan at full width through the runtime: per
    layer its own xd and da and group-shared B/C views, `ScanDesc(1,
    prompt, 64, 64, 64)` submitted as a one-member bundle and drained; the
    counts zeroed just before each layer and read just after, which must
    show one launch on the chunks route.  Each result within the scan
    tolerance of `ssd_chunk_ref`; the same inputs launched again directly
    give the same y bits, and that launch's final state is checked too.
    Prints the layers' device time as the runtime's CUDA events bracket
    each attempt (the host's enqueue inside) and the same launches queued
    behind a sleep of the card (kernels alone)."""
    cfg = get_arch(ZAMBA)
    layers = layers or cfg.n_layers
    sdesc = next(d for d in decode_step_op_descs(cfg, 1, 2048) if d.family == "mamba_scan")
    desc = replace(sdesc, T=prompt)
    rt = Runtime(ConcurrencyController(), RuntimeConfig(window_s=0.0, execute=True),
                 device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    counts, routes, bracket_s, modes = Counter(), Counter(), 0.0, Counter()
    t0 = time.perf_counter()
    direct = []
    for li in range(layers):
        req = op_request(desc, None, None, gen, device)
        n0 = len(rt.telemetry.groups)
        take_counts()
        h = rt.submit([req], tenant="prefill", now=float(li))
        launches = rt.drain(now=float(li))
        layer_routes = dict(mamba_scan_fwd.routes)
        counts += take_counts()
        routes.update(layer_routes)
        recs = rt.telemetry.groups[n0:]
        bracket_s += sum(g.achieved_time_s or 0.0 for g in recs)
        modes.update(g.mode for g in recs)
        if device == "cuda" and layer_routes != {"decode": 0, "chunks": 1}:
            raise AssertionError(f"prompt scan layer {li}: routes {layer_routes}")
        tk = h.members[0]
        check_op_tickets([tk])
        L = scan_chunk(launches[0].plan.tile)
        y, state = ssd_scan(*req.inputs, chunk=L)
        if device == "cuda" and not torch.equal(y, tk.result):
            raise AssertionError(f"prompt scan layer {li}: a second launch gave other bits")
        check_scan(y, state, *req.inputs, None, f"prompt scan layer {li}")
        direct.append((req.inputs, L, y, state))
    check_healthy(rt, "prompt scans")
    per = bracket_s * 1e3 / layers
    kernels_ms = None
    if device == "cuda":
        ws = chunk_workspace(desc.B, desc.T, desc.H, desc.P, desc.N, direct[0][1], device)
        queued = device_s(lambda: [ssd_scan(*ins, chunk=L, out=(y, st, ws))
                                      for ins, L, y, st in direct])
        kernels_ms = None if queued is None else queued * 1e3
    take_counts()
    print(f"# {cfg.name} prompt scans: {layers} layers of {desc.key()} through the runtime, "
          f"launches by mode {dict(modes)}, scan launches by route {dict(routes)}, each y "
          f"and state within the scan tolerance; device time in the runtime's attempt "
          f"brackets {bracket_s * 1e3:.4f} ms ({per:.4f} ms a launch), the same launches "
          f"queued behind a sleep {kernels_ms if kernels_ms is None else round(kernels_ms, 4)} "
          f"ms; {time.perf_counter() - t0:.1f} s (host clock, checks included)")
    out = dict(counts=counts, routes=dict(routes), device_ms=bracket_s * 1e3,
               kernels_ms=kernels_ms)
    return out


# --------------------------------------------------- op-bundle serving
OP_CONFIGS = (("qwen3-14b", 4096), ("zamba2-1.2b", 2048), ("deepseek-v2-lite-16b", 2048))
# Layers served where not the config's: DeepSeek-V2-Lite-16B's 27 cut to 14
# to make room for phase 12 in the script's time, Qwen3-14B's 40 to 20 and
# Zamba2-1.2B's 38 to 19 for phase 13.
OP_LAYERS = {"qwen3-14b": 20, "zamba2-1.2b": 19, "deepseek-v2-lite-16b": 14}
OP_WINDOWS = (([1], 16), ([4, 8, 8, 16], 4))


def make_kv_caches(cfg, layers: int, batches, context: int, gen, device) -> list:
    """Per layer and tenant, a random bf16 K and V cache (B, Hkv, S, D) of
    the decode bundle's attention (MLA's materialized form for
    DeepSeek-V2: 16 heads of 192, ROADMAP C11)."""
    (attn,) = [d for d in decode_step_op_descs(cfg, 1, context)
               if d.family == "flash_attention"]
    shape = (attn.Hkv, attn.Skv, attn.D)
    return [[tuple(torch.randn((b,) + shape, generator=gen, device=device,
                               dtype=torch.bfloat16) for _ in range(2))
             for b in batches] for _ in range(layers)]


def make_op_weights(cfg, layers: int, gen, device) -> tuple:
    """Per layer, the weights of `unfused_descs` in order, stored (K, N),
    and the layer's routed experts (None without them): one (E, D, F) up
    and one (E, F, D) down tensor, each expert's weight a view.  The dense
    per-expert triples of the bundle (ROADMAP C11) are views into them:
    expert e's gate and up are the up weights of experts 2e and 2e + 1,
    its down the down weight of expert e, so they take no memory."""
    if not cfg.n_routed_experts:
        weights = make_unfused_weights(cfg, layers, gen, device)
        return weights, [None] * layers
    E, D, F = cfg.n_routed_experts, cfg.d_model, cfg.moe_d_ff

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16).mul_(shape[-2] ** -0.5)

    weights, experts = [], []
    for _ in range(layers):
        up, down = rnd(E, D, F), rnd(E, F, D)
        wl = []
        for tag, bundle in decode_step_descs(cfg, 1):
            m = re.fullmatch(r"expert(\d+)-(up|down)", tag)
            if m is None:
                wl += [rnd(d.K, d.N) for d in bundle]
            elif m[2] == "up":
                wl += [up[2 * int(m[1])], up[2 * int(m[1]) + 1]]
            else:
                wl.append(down[int(m[1])])
        for d, w in zip(unfused_descs(cfg, 1), wl, strict=True):
            if tuple(w.shape) != (d.K, d.N):
                raise AssertionError(f"weight {tuple(w.shape)} for {d.key()}")
        weights.append(wl)
        experts.append((up, down))
    return weights, experts


def storage_gb(tensors) -> float:
    """GB of the distinct storages under ``tensors`` (views count once)."""
    seen = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in tensors}
    return sum(seen.values()) / 1e9


def pool_weights(experts, d, li: int, ti: int) -> list:
    """The G expert weights a grouped member reads, by pointer: views into
    the layer's up or down tensor (whichever has the member's (K, N)) of a
    seeded choice of G distinct experts, the same for a tenant's up and
    down pools of one layer."""
    up, down = experts
    w = up if tuple(up.shape[1:]) == (d.K, d.N) else down
    if tuple(w.shape[1:]) != (d.K, d.N):
        raise AssertionError(f"{d.key()}: no expert tensor of (K, N) = ({d.K}, {d.N})")
    idx = np.random.default_rng((SEED, li, ti)).choice(w.shape[0], d.G, replace=False)
    return [w[int(e)] for e in idx]


def op_request(d, weight, kv, gen, device):
    """One bundle member with its operands: a GEMM's activations and
    weight, a grouped member's rows and its experts' weights (``weight``,
    a list of views), the attention's query and KV cache, or the scan's
    inputs (head-broadcast B/C, as Mamba2's group-shared layout)."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)

    if d.family == "gemm":
        return GemmRequest(desc=d, a=rnd(d.M, d.K), b=weight)
    if d.family == "grouped_gemm":
        return bind_operands(d, (rnd(d.M, d.K), weight))
    if d.family == "flash_attention":
        k, v = kv
        return bind_operands(d, (rnd(d.B, d.Hq, d.Sq, d.D), k[:d.B], v[:d.B]))
    da = (torch.rand((d.B, d.T, d.H), generator=gen, device=device) * -0.5).to(torch.bfloat16)
    bm, cm = (rnd(d.B, d.T, d.N)[:, :, None].expand(d.B, d.T, d.H, d.N) for _ in range(2))
    return bind_operands(d, (rnd(d.B, d.T, d.H, d.P), da, bm, cm))


def member_weight(d, ws, experts, li: int, ti: int):
    """A bundle member's weight: a GEMM's next of ``ws``, a grouped
    member's expert views (`pool_weights`), else None."""
    if d.family == "gemm":
        return next(ws)
    if d.family == "grouped_gemm":
        return pool_weights(experts[li], d, li, ti)
    return None


def drive_op_bundles(rt: Runtime, cfg, weights, kv, batches, context: int, gen,
                     experts=None):
    """Per layer, every tenant submits its whole decode-step bundle, and
    the runtime drains.  Returns the bundle tickets, the wall time up to
    the last result being ready, the window's records and launches."""
    t0 = time.perf_counter()
    n0 = len(rt.telemetry.groups)
    handles, launches = [], []
    for li, wl in enumerate(weights):
        for ti, batch in enumerate(batches):
            descs = decode_step_op_descs(cfg, batch, context)
            ws = iter(wl)
            reqs = [op_request(d, member_weight(d, ws, experts, li, ti), kv[li][ti],
                               gen, rt.device) for d in descs]
            handles.append(rt.submit(reqs, tenant=f"tenant{ti}"))
        launches += rt.drain()
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    return handles, time.perf_counter() - t0, rt.telemetry.groups[n0:], launches


def check_op_tickets(tickets) -> None:
    for tk in tickets:
        r, fam = tk.request, tk.desc.family
        what = f"ticket {tk.seq} {tk.desc.key()} ({tk.plan.mode})"
        if fam == "gemm":
            check_close(tk.result, gemm_ref(r.a, r.b), abs_product(r.a, r.b), what)
        elif fam == "grouped_gemm":
            a, ws = r.inputs
            sizes = list(tk.desc.row_vector())
            check_close(tk.result, ragged_gemm_ref(a, ws, sizes), ragged_abs(a, ws, sizes),
                        what)
        elif fam == "flash_attention":
            check_attention(tk.result, *r.inputs, tk.desc.Skv - tk.desc.Sq, what)
        else:
            check_tol(tk.result, ssd_chunk_ref(*(x.float() for x in r.inputs))[0],
                      SCAN_TOL, SCAN_TOL + 2.0 ** -8, what)


def expected_ragged(launches) -> int:
    """The `ragged_matmul` launches a list of runtime launches makes: per
    grouped member, `pool_launches` at the tile it was planned at."""
    n = 0
    for ln in launches:
        for tk, tile in zip(ln.tickets, ln.plan.tiles or [ln.plan.tile] * len(ln.tickets)):
            if tk.desc.family == "grouped_gemm":
                n += pool_launches(tk.desc, tile.bm)
    return n


def check_ragged(label: str, before: int, launches, device) -> int:
    """Fail unless ``launches`` made exactly `expected_ragged`'s
    `ragged_matmul` launches since the count read ``before``."""
    got, want = grouped_kernel.ragged_matmul.launches - before, expected_ragged(launches)
    if device == "cuda" and got != want:
        raise AssertionError(f"{label}: {got} ragged_matmul launches, the grouped "
                             f"members' ragged_chunks give {want}")
    return got


def op_bundle_window(rt, cfg, weights, kv, batches, context, gen, experts) -> dict:
    before = grouped_kernel.ragged_matmul.launches
    handles, wall, recs, launches = drive_op_bundles(rt, cfg, weights, kv, batches,
                                                     context, gen, experts)
    ragged = check_ragged(f"{cfg.name} op-bundle window {batches}", before, launches,
                          rt.device.type)
    if not all(h.done for h in handles):
        raise AssertionError("a bundle was left unfinished")
    tickets = [m for h in handles for m in h.members]
    check_op_tickets(tickets)
    fams = Counter(tk.desc.family for tk in tickets)
    weight_b = sum(tk.request.b.numel() * 2 for tk in tickets if tk.desc.family == "gemm")
    weight_b += sum(w.numel() * 2 for tk in tickets if tk.desc.family == "grouped_gemm"
                    for w in tk.request.inputs[1])
    kv_b = sum((tk.request.inputs[1].numel() + tk.request.inputs[2].numel()) * 2
               for tk in tickets if tk.desc.family == "flash_attention")
    return dict(requests=len(tickets), families=dict(fams),
                launches=dict(Counter(g.mode for g in recs)), ragged_launches=ragged,
                wall_s=wall,
                device_s=sum(g.achieved_time_s or 0.0 for g in recs),
                weight_gb=weight_b / 1e9, kv_gb=kv_b / 1e9, launch_list=launches)


def op_bundle_phase(name: str, context: int, device="cuda", layers=None,
                    reduced: bool = False) -> dict:
    cfg = get_arch(name)
    cfg = cfg.reduced() if reduced else cfg
    layers = layers or cfg.n_layers
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    t0 = time.perf_counter()
    weights, experts = make_op_weights(cfg, layers, gen, device)
    tenants = max((b for b, _ in OP_WINDOWS), key=len)
    kv = make_kv_caches(cfg, layers, tenants, context, gen, device)
    model_gb = storage_gb([w for wl in weights for w in wl]
                          + [t for ex in experts if ex for t in ex])
    kv_gb = sum(t.numel() * 2 for lkv in kv for pair in lkv for t in pair) / 1e9
    routed = (f" (routed experts {storage_gb([t for ex in experts for t in ex]):.2f} GB; "
              "the dense per-expert GEMMs are views into them)" if experts[0] else "")
    print(f"# op-bundle serving {cfg.name}: {layers} layers, context {context}, bundle "
          f"{[d.key() for d in decode_step_op_descs(cfg, 1, context)]}; weights "
          f"{model_gb:.2f} GB{routed}, KV caches {kv_gb:.2f} GB ({sum(tenants)} "
          f"sequences) on {device}")
    rt = Runtime(ConcurrencyController(),
                 RuntimeConfig(window_s=0.0, execute=True), device=device)
    reset_counts()
    windows = []
    for batches, available in OP_WINDOWS:
        rt.set_available(available)
        for run in ("cold", "warm"):
            w = op_bundle_window(rt, cfg, weights, kv, batches, context, gen, experts)
            w.update(batches=batches, available=available, plans=run)
            windows.append(w)
            pools = (f", ragged_matmul launches {w['ragged_launches']} (as ragged_chunks "
                     "gives for each grouped member)" if w["families"].get("grouped_gemm")
                     else "")
            print(f"# {cfg.name} op-bundle window batches {batches} available {available} "
                  f"({run} plans): {w['requests']} requests {w['families']}, launches "
                  f"{w['launches']}{pools}, wall {w['wall_s']:.6f} s, device "
                  f"{w['device_s']:.6f} s; "
                  f"weights {w['weight_gb']:.3f} GB + KV {w['kv_gb']:.3f} GB read, "
                  f"{(w['weight_gb'] + w['kv_gb']) / w['wall_s']:.1f} GB/s of wall")
    counts = launch_counts()
    members = sum((Counter(w["families"]) for w in windows), Counter())
    print(f"# {cfg.name} op-bundle modes {rt.telemetry.mode_counts()}; kernel launches "
          f"{counts}; members {dict(members)}")
    check_feeds(f"{cfg.name} op-bundle serving", device)
    check_healthy(rt, f"{cfg.name} op-bundle serving")
    if device == "cuda" and (counts["flash_attention"] != members["flash_attention"]
                             or counts["flash_prefill"]
                             or counts["mamba_scan"] != members["mamba_scan"]):
        raise AssertionError(f"{cfg.name}: attention/scan launches {counts} differ from "
                             f"the members submitted {dict(members)}, every attention "
                             "member on the decode route")
    routes = dict(mamba_scan_fwd.routes)
    if members["mamba_scan"]:
        print(f"# {cfg.name} op-bundle scan launches by route {routes}: "
              f"{routes['decode']} of {members['mamba_scan']} scan members on the decode "
              "kernel, each ticket's y within the scan tolerance of ssd_chunk_ref")
        if device == "cuda" and (routes["decode"] != members["mamba_scan"]
                                 or routes["chunks"]):
            raise AssertionError(f"{cfg.name}: scan launches by route {routes}; every "
                                 f"one of the {members['mamba_scan']} decode members "
                                 "must take the decode kernel")
    if device == "cuda":
        for w in windows[1::2]:     # the warm windows
            r = concurrency_ratio(w["launch_list"], rt.ctrl.lib)
            what = (f"# {cfg.name} warm op-bundle window batches {w['batches']} available "
                    f"{w['available']}, {len(w['launch_list'])} launches")
            if r is None:
                print(f"{what}: concurrent vs back to back not measured (the host "
                      "could not queue a chunk ahead of the card)")
                continue
            gb = w["weight_gb"] + w["kv_gb"]
            print(f"{what}: concurrent on streams {r['concurrent_s']:.6f} s, back to "
                  f"back on one stream {r['back_to_back_s']:.6f} s (ratio "
                  f"{r['ratio']:.4f}), back to back at isolated tiles "
                  f"{r['isolated_s']:.6f} s (ratio {r['isolated_ratio']:.4f}), in "
                  f"{r['chunks']} queued chunks; runs {r['runs']}; concurrent reads "
                  f"{gb / r['concurrent_s']:.1f} GB/s of weights + KV")
        for batches, available in OP_WINDOWS:
            rt.set_available(available)
            profile_window(f"{cfg.name} op-bundle window batches {batches} available "
                           f"{available}", lambda: drive_op_bundles(
                               rt, cfg, weights, kv, batches, context, gen, experts)[1::2])
    check_healthy(rt, f"{cfg.name} op-bundle serving, profiled windows")
    for w in windows:
        del w["launch_list"]
    graph_part(cfg, weights, kv, context, gen, device, experts)
    print(f"# {cfg.name} op-bundle phase: {time.perf_counter() - t0:.1f} s (host clock, "
          "weights made and checks included)")
    return dict(counts=counts, scan_routes=routes, windows=windows, model_gb=model_gb,
                kv_gb=kv_gb)


# --------------------------------------------------------- graph serving
def bind_graph(cfg, weights, kv, ti: int, batch: int, context: int, gen, device,
               experts=None):
    """Tenant ``ti``'s `decode_step_graph` over every layer of ``weights``,
    each node's static operands attached by name (``L{ℓ}.q``, ...): each
    layer's roots take the layer input ``a``, every GEMM its layer's
    weight of its tag (the bundle's GEMMs of that tag in order), the
    expert pools their experts' weights (`pool_weights`) and, moe-up, its
    routed rows, the attention the tenant's KV cache (and, where no data
    edge feeds it, a query), the scan xd, da and head-broadcast B/C views
    as `op_request` makes them; every other slot arrives by a data edge.
    Every tag the graph's GEMMs carry takes all of its weights; the
    dense per-expert GEMMs have no node (ROADMAP C11)."""
    g = decode_step_graph(cfg, batch, context, layers=len(weights))
    wired = {(e.dst, e.slot) for e in g.edges if e.slot is not None}
    tags = [tag for tag, bundle in decode_step_descs(cfg, batch) for _ in bundle]
    for li, wl in enumerate(weights):
        prefix = f"L{li}." if len(weights) > 1 else ""
        x = torch.randn((batch, cfg.d_model), generator=gen, device=device,
                        dtype=torch.bfloat16)
        by_tag = {}
        for tag, w in zip(tags, wl, strict=True):
            by_tag.setdefault(tag, []).append(w)
        taken = Counter()
        for name, node in g.nodes.items():
            d = node.desc
            if not name.startswith(prefix):
                continue
            if family_of(d) == "gemm":
                w = by_tag[node.tag][taken[node.tag]]
                taken[node.tag] += 1
                if tuple(w.shape) != (d.K, d.N):
                    raise AssertionError(f"{name}: weight {tuple(w.shape)} for {d.key()}")
                node.operands["b"] = w
                if (name, "a") not in wired:
                    node.operands["a"] = x
            else:
                w = pool_weights(experts[li], d, li, ti) if d.family == "grouped_gemm" else None
                ops = op_request(d, w, kv[li][ti], gen, device).inputs
                node.operands.update((s, t) for s, t in enumerate(ops)
                                     if (name, s) not in wired)
        left = {t: len(ws) - taken[t] for t, ws in by_tag.items()
                if taken[t] and taken[t] != len(ws)}
        if left:
            raise AssertionError(f"layer {li}: weights no GEMM node took {left}")
    return g


def tele_mark(rt: Runtime) -> tuple:
    t = rt.telemetry
    return (len(t.groups), t.flushes, t.cache_hits, t.cache_misses,
            Counter(t.ready_depth_hist))


def tele_since(rt: Runtime, mark: tuple) -> dict:
    """The runtime's telemetry since ``mark``: launches by mode, mean CD,
    flushes, launches mixing two or more graphs, the ready-set depths,
    plan-cache hits and misses, and the attempts' device time."""
    n0, f0, h0, m0, d0 = mark
    t = rt.telemetry
    recs = t.groups[n0:]
    depths = Counter(t.ready_depth_hist) - d0
    return dict(launches=dict(Counter(g.mode for g in recs)),
                mean_cd=sum(g.cd for g in recs) / max(len(recs), 1),
                flushes=t.flushes - f0,
                cross_graph_groups=sum(1 for g in recs if len(g.graph_ids) >= 2),
                ready_depths={k: depths[k] for k in sorted(
                    depths, key=lambda k: int(k.split("-")[0]))},
                plan_hits=t.cache_hits - h0, plan_misses=t.cache_misses - m0,
                device_s=sum(g.achieved_time_s or 0.0 for g in recs))


def run_graphs(rt: Runtime, graphs: list):
    """Every tenant's graph submitted, then one drain.  Returns the graph
    handles, the launches, their records and the telemetry since."""
    mark = tele_mark(rt)
    t0 = time.perf_counter()
    handles = [rt.submit(g, tenant=f"tenant{ti}") for ti, g in enumerate(graphs)]
    launches = rt.drain()
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    stats = tele_since(rt, mark)
    stats["wall_s"] = time.perf_counter() - t0
    return handles, launches, rt.telemetry.groups[mark[0]:], stats


def run_waves(rt: Runtime, graphs: list):
    """The same graphs as a caller limited to bundles runs them, the
    reference's baseline (`benchmarks/serving.py:300-310`): tenant after
    tenant, each graph's `waves()` submitted as one bundle each with a
    drain after it, the members bound from a `GraphState`'s slots and
    their results wired into it.  Returns the member tickets, the
    launches and the telemetry since."""
    mark = tele_mark(rt)
    t0 = time.perf_counter()
    tickets, launches = [], []
    for ti, g in enumerate(graphs):
        state = GraphState(g)
        for wave in g.waves():
            nodes = [g.nodes[n] for n in wave]
            handle = rt.submit([bind_operands(n.desc, state.operands_for(n.name),
                                              tag=n.tag or n.name) for n in nodes],
                               tenant=f"tenant{ti}")
            launches += rt.drain()
            for n, m in zip(nodes, handle.members):
                state.complete(n.name, m.result)
            tickets += handle.members
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    stats = tele_since(rt, mark)
    stats["wall_s"] = time.perf_counter() - t0
    return tickets, launches, stats


def signature(launches) -> list:
    """What a run launched: each launch's mode, CD and members."""
    return [(ln.plan.mode, ln.plan.cd, [(tk.tenant, tk.desc.key()) for tk in ln.tickets])
            for ln in launches]


def check_graph_run(label: str, handles, launches, recs) -> None:
    """The fatal checks of one executed graph run: every graph done; every
    node's result within its family's tolerance of its plain version on
    the operands it was given; every data edge's consumer operand its
    producer's result, the same storage; every node launched in a later
    flush than each of its producers."""
    if not all(h.done for h in handles):
        raise AssertionError(f"{label}: a graph was left unfinished")
    check_op_tickets([tk for h in handles for tk in h.nodes.values()])
    flush_of = {tk.seq: rec.flush_id for rec, ln in zip(recs, launches, strict=True)
                for tk in ln.tickets}
    for h in handles:
        for e in h.state.graph.edges:
            src, dst = h[e.src], h[e.dst]
            if flush_of[dst.seq] <= flush_of[src.seq]:
                raise AssertionError(f"{label}: {e.dst} launched in flush "
                                     f"{flush_of[dst.seq]}, its producer {e.src} in "
                                     f"{flush_of[src.seq]}")
            if e.slot is None:
                continue
            r = dst.request
            got = r.a if e.slot == "a" else r.b if e.slot == "b" else r.inputs[e.slot]
            if got.data_ptr() != src.result.data_ptr() or not got.is_contiguous():
                raise AssertionError(f"{label}: {e.dst} slot {e.slot!r} is not a view "
                                     f"of {e.src}'s output")


def graph_windows(cfg, context: int, device, bind, shadow: bool = False):
    """The graph windows of `OP_WINDOWS` on a runtime of their own: per
    window, every tenant's graph (``bind(ti, batch)``) submitted at once
    and drained, cold, then warm after `prewarm(graph)` of each; then the
    same graphs' waves as barriered bundles (`run_waves`) on a second
    runtime, prewarmed alike.  ``shadow``: operand-free, modeled only.
    Yields (batches, available, run, result of `run_graphs` / `run_waves`)."""
    cfg_rt = RuntimeConfig(window_s=0.0, execute=not shadow)
    rt = Runtime(ConcurrencyController(), cfg_rt, device=device)
    rtw = Runtime(ConcurrencyController(), cfg_rt, device=device)
    for batches, available in OP_WINDOWS:
        graphs = [bind(ti, b) for ti, b in enumerate(batches)]
        rt.set_available(available)
        rtw.set_available(available)
        yield batches, available, "graph cold", run_graphs(rt, graphs)
        for g in graphs:
            rt.prewarm(g)
        yield batches, available, "graph warm", run_graphs(rt, graphs)
        for g in graphs:
            rtw.prewarm(g)
        yield batches, available, "waves", run_waves(rtw, graphs)
    for r, label in ((rt, "graph"), (rtw, "waves")):
        check_healthy(r, f"{cfg.name} {label} serving")
    if rt.telemetry.graphs_completed != rt.telemetry.graphs_submitted:
        raise AssertionError(f"{cfg.name}: {rt.telemetry.graphs_completed} graphs "
                             f"completed of {rt.telemetry.graphs_submitted}")


def graph_stats_line(name: str, batches, available, run: str, stats: dict) -> str:
    return (f"# {name} {run} batches {batches} available {available}: launches "
            f"{stats['launches']}, mean CD {stats['mean_cd']:.4f}, flushes "
            f"{stats['flushes']}, cross-graph groups {stats['cross_graph_groups']}, "
            f"ready depths {stats['ready_depths']}, plan-cache hits "
            f"{stats['plan_hits']} misses {stats['plan_misses']}, device "
            f"{stats['device_s']:.6f} s, wall {stats['wall_s']:.6f} s")


def graph_shadow(cfg, context: int, layers: int, device) -> list:
    """`graph_windows` in shadow mode on operand-free graphs: per run the
    planner's launches (`signature`), which the executed run must
    reproduce, and its telemetry (`tele_since`)."""
    def bind(ti: int, batch: int):
        return decode_step_graph(cfg, batch, context, layers=layers)

    return [(batches, available, run, signature(res[1]), res[-1])
            for batches, available, run, res in graph_windows(
                cfg, context, device, bind, shadow=True)]


def graph_part(cfg, weights, kv, context: int, gen, device, experts=None) -> None:
    """Graph serving on phase 7's weights and KV caches, its launches
    counted apart: `graph_windows` executed, every graph run held by
    `check_graph_run` and every wave ticket to its plain version; each
    run's launches must equal the shadow planner's; one attention launch
    per attention node and one decode-kernel scan launch per scan node;
    for each run exactly the `ragged_matmul` launches `ragged_chunks`
    gives its grouped nodes; no fault, no fallback, every `matmul` launch
    counted on the TMA feed.  The graph and waves figures are printed
    side by side, not gated."""
    t0 = time.perf_counter()
    shadow = graph_shadow(cfg, context, len(weights), device)
    take_counts()
    nodes = Counter()

    def bind(ti: int, batch: int):
        return bind_graph(cfg, weights, kv, ti, batch, context, gen, device, experts)

    ragged0 = grouped_kernel.ragged_matmul.launches
    for i, (batches, available, run, res) in enumerate(
            graph_windows(cfg, context, device, bind)):
        label = f"{cfg.name} {run} batches {batches} available {available}"
        if run == "waves":
            tickets, launches, stats = res
            if not all(tk.done for tk in tickets):
                raise AssertionError(f"{label}: a wave was left unfinished")
            check_op_tickets(tickets)
        else:
            handles, launches, recs, stats = res
            check_graph_run(label, handles, launches, recs)
            tickets = [tk for h in handles for tk in h.nodes.values()]
            del handles, recs
        nodes += Counter(family_of(tk.desc) for tk in tickets)
        if signature(launches) != shadow[i][3]:
            raise AssertionError(f"{label}: the launches differ from the shadow "
                                 "planner's")
        ragged = check_ragged(label, ragged0, launches, device)
        ragged0 = grouped_kernel.ragged_matmul.launches
        pools = (f"; ragged_matmul launches {ragged}, as ragged_chunks gives"
                 if nodes["grouped_gemm"] else "")
        print(graph_stats_line(cfg.name, batches, available, run, stats)
              + "; launches as the shadow planner's" + pools)
        del res, launches, tickets      # this run's outputs, before the next run
    routes = dict(mamba_scan_fwd.routes)
    feeds = check_feeds(f"{cfg.name} graph serving", device)
    counts = take_counts()      # resets the routes and feeds too
    if device == "cuda" and feeds["tma"] != counts["matmul"]:
        raise AssertionError(f"{cfg.name} graph serving: {counts['matmul']} matmul "
                             f"launches, {feeds} counted per feed; all must be TMA")
    print(f"# {cfg.name} graph serving: kernel launches {dict(counts)}, scan routes "
          f"{routes}, nodes by family {dict(nodes)}, {time.perf_counter() - t0:.1f} s "
          "(host clock, checks included)")
    if device == "cuda" and (counts["flash_attention"] != nodes["flash_attention"]
                             or counts["flash_prefill"]
                             or counts["mamba_scan"] != nodes["mamba_scan"]
                             or routes["decode"] != nodes["mamba_scan"]
                             or routes["chunks"]):
        raise AssertionError(f"{cfg.name} graph serving: attention/scan launches "
                             f"{dict(counts)}, scan routes {routes}, for nodes {dict(nodes)}")


# -------------------------------------------------------- self-correction
# The injected windows' rules (seeded by SEED): per-class launches draw
# raise and nan faults alike; in the op-bundle window only the attention
# member does, so a mixed attempt draws at most one injection and the
# telemetry's faults equal the injector's log by kind (a mixed attempt
# with two poisoned members fails once).
CLASS_RULES = (FaultRule("raise", 0.05), FaultRule("nan", 0.05))
BUNDLE_RULES = (FaultRule("raise", 0.1, family="flash_attention"),
                FaultRule("nan", 0.1, family="flash_attention"))
CALIBRATED_BUNDLES = (("op bundle", ([1], 16)), ("op bundle", ([4, 8, 8, 16], 4)),
                      ("GEMM bundle", ([1], 16)), ("GEMM bundle", ([4, 8, 8, 16], 4)))


def entry_picks(lib) -> dict:
    """Per library entry, what a re-tune could change: its isolated tile,
    its GO tile per CD and its preferred CD."""
    return {k: (e.isolated, dict(e.go), e.preferred_cd())
            for k, e in lib.entries().items()}


def shadow_plans(ctrl, cfg, batches, available, device, kind: str) -> list:
    """(chunk, CD, mode) of every launch a runtime with ``ctrl`` plans for
    one window of bundles over every layer, executing nothing."""
    rt = Runtime(ctrl, RuntimeConfig(window_s=0.0), device=device)
    rt.set_available(available)
    rows = []
    for _ in range(cfg.n_layers):
        for ti, batch in enumerate(batches):
            descs = (decode_step_op_descs(cfg, batch, OP_CONFIGS[0][1])
                     if kind == "op bundle" else unfused_descs(cfg, batch))
            rt.submit([bind_operands(d) for d in descs], tenant=f"tenant{ti}")
        rows += [(tuple(ln.plan.indices), ln.plan.cd, ln.plan.mode)
                 for ln in rt.drain()]
    return rows


def calibration_part(cfg, weights, unfused, gen, device) -> Counter:
    """The per-class windows served twice through a calibrated controller
    (its own library; the requests fused as the oracle fuses them, since
    those are the weights on the card), with each flush's queued re-tunes
    run after it; then the bundle windows planned with the calibrated
    controller beside the uncalibrated one, the §6.11 QKV choice, and one
    calibrated bundle window served."""
    cal = CostCalibrator()
    ctrl = ConcurrencyController(GOLibrary(), calibrator=cal)
    oracle = ConcurrencyController(default_library())
    rt = Runtime(ctrl, RuntimeConfig(window_s=0.0, execute=True), device=device)
    for batches in SERVING_WINDOWS:
        for run in (1, 2):
            reqs = window_requests(oracle, cfg, weights, batches, gen, device)
            flushes = rt.telemetry.flushes
            with HostStalls(device) as stalls:
                w = serve_window(rt, cfg, weights, batches, gen, reqs)
            queued = rt.pending_retunes()
            before = entry_picks(ctrl.lib)
            t0 = time.perf_counter()
            fresh = rt.process_retunes()
            secs = time.perf_counter() - t0
            after = entry_picks(ctrl.lib)
            changed = sum(before[k] != after[k] for k in before if k in after)
            print(f"# calibrated window batches {batches} (run {run}): {w['requests']} "
                  f"requests, launches {w['launches']}, wall {w['wall_s']:.6f} s, device "
                  f"{w['device_s']:.6f} s; {rt.telemetry.flushes - flushes} flush, "
                  f"re-tunes queued {queued}; process_retunes {secs * 1e3:.3f} ms "
                  f"(host), {fresh} entries re-tuned, {changed} GO tiles or preferred "
                  f"CDs changed")
            slow = max(rt.telemetry.groups[-len(w["launch_list"]):],
                       key=lambda g: g.achieved_time_s)
            print(f"#   host stalls in the window: {stalls}; slowest launch {slow.mode} "
                  f"{slow.class_key} CD {slow.cd} {slow.achieved_time_s * 1e3:.3f} ms")
            if slow.achieved_time_s - stalls.gc_s > UNEXPLAINED_S and not stalls.retries:
                raise AssertionError(f"calibrated window {batches}: a launch took "
                                     f"{slow.achieved_time_s:.3f} s and no host stall "
                                     "explains it")
    check_healthy(rt, "calibrated per-class serving")
    t0 = time.perf_counter()
    tracked = len(gc.get_objects())
    gc.collect()
    print(f"# a full collection after the calibrated windows: {tracked} objects "
          f"tracked, {time.perf_counter() - t0:.3f} s (host)")
    for key, st in cal.to_json()["classes"].items():
        print(f"#   calibrator {key}: n {st['n']}, factor "
              f"{math.exp(st['log_factor']):.6g}, drift {st['drift']:.6g}")
    plain = ConcurrencyController(GOLibrary())
    for kind, (batches, available) in CALIBRATED_BUNDLES:
        mine = shadow_plans(ctrl, cfg, batches, available, device, kind)
        theirs = shadow_plans(plain, cfg, batches, available, device, kind)
        differ = sum(a != b for a, b in zip(mine, theirs)) + abs(len(mine) - len(theirs))
        print(f"# calibrated {kind} window batches {batches} available {available}: "
              f"{differ} of {len(theirs)} launches differ in chunk, CD or mode "
              f"(calibrated {Counter((c, m) for _, c, m in mine)}, uncalibrated "
              f"{Counter((c, m) for _, c, m in theirs)})")
    for batch in (1, 8, 16):
        (qkv,) = [b for tag, b in decode_step_descs(cfg, batch) if len(b) == 3]
        got, base = ctrl.plan_shared_input(qkv), plain.plan_shared_input(qkv)
        print(f"# plan_shared_input QKV at batch {batch}: calibrated {got[0]}, "
              f"uncalibrated {base[0]} (modeled fused {base[1]:.6g} s, grouped "
              f"{base[2]:.6g} s; factors fused "
              f"{ctrl._group_factor([replace(qkv[0], N=sum(d.N for d in qkv))]):.4g}, "
              f"grouped {ctrl._group_factor(qkv):.4g})")
    brt = Runtime(ctrl, RuntimeConfig(window_s=0.0, execute=True), device=device)
    brt.set_available(16)
    w = mixed_window(brt, cfg, unfused, [1], gen)
    check_healthy(brt, "calibrated bundle serving")
    print(f"# calibrated GEMM bundle window batches [1] available 16: {w['requests']} "
          f"requests, launches {w['launches']}, members {w['members']}, wall "
          f"{w['wall_s']:.6f} s, device {w['device_s']:.6f} s; every result held to "
          "the plain version")
    return take_counts()


# A launch of the calibrated windows takes under 4 ms on the card (the
# slowest seen, a 34816x5120 gate+up); one that takes this much longer
# than the full collections in its window is not a stall this harness can
# name, and the calibrator would learn from it.
UNEXPLAINED_S = 0.1


class HostStalls:
    """What may stall the host inside a `with` block: full (generation 2)
    garbage collections and their host seconds, and the caching
    allocator's cudaMalloc calls and retries (a retry is a cudaMalloc that
    failed, the cached blocks freed and the call made again).  The
    runtime synchronises after every attempt, so the device is idle when
    the next attempt's start event is recorded: a host stall before that
    attempt's last kernel is queued counts as device time."""

    def __init__(self, device):
        self.device = device
        self.collections, self.collected, self.gc_s, self._t = 0, 0, 0.0, None

    def _alloc(self) -> tuple:
        if self.device != "cuda":
            return (0, 0)
        st = torch.cuda.memory_stats()
        return (st.get("num_device_alloc", 0), st.get("num_alloc_retries", 0))

    def _gc(self, phase, info) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.collections += 1
            self.collected += info["collected"]
            self.gc_s += time.perf_counter() - self._t

    def __enter__(self):
        self._start = self._alloc()
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._gc)
        self.mallocs, self.retries = (b - a for a, b in zip(self._start, self._alloc()))

    def __str__(self) -> str:
        return (f"{self.collections} full collections ({self.gc_s:.3f} s, "
                f"{self.collected} objects freed), {self.mallocs} cudaMalloc calls, "
                f"{self.retries} allocator retries")


def ladder_runtime(device, injector=None, available: int = 16) -> Runtime:
    rt = Runtime(ConcurrencyController(GOLibrary()),
                 RuntimeConfig(window_s=0.0, execute=True), device=device,
                 fault_injector=injector)
    rt.set_available(available)
    return rt


def reconcile(rt: Runtime, label: str) -> None:
    """The runtime's faults by kind against its injector's log, and what
    the ladder did."""
    tele, log = rt.telemetry, rt.fault_injector.log
    if dict(tele.faults) != dict(Counter(i.kind for i in log)):
        raise AssertionError(f"{label}: faults {dict(tele.faults)} != injected "
                             f"{dict(Counter(i.kind for i in log))}")
    print(f"# {label}: {len(log)} faults injected, faults {dict(tele.faults)}, "
          f"fallbacks by rung {dict(tele.fallbacks)}, quarantines {tele.quarantines} "
          f"(evicting {tele.quarantine_evictions} cached plans), library "
          f"quarantine {sum(len(v) for v in rt.ctrl.lib.quarantined().values())} "
          "(entry, tile) pairs")


def ladder_part(cfg, weights, unfused, gen, device) -> Counter:
    """(1) Rules whose every p is 0 against no injector on the same
    requests; (2) seeded raise and nan faults over the per-class window
    [8, 8, 8, 8] and the op-bundle window [1]; (3) every attempt raising,
    so every launch completes on the reference rung; (4) the half-open
    probes past the cooldown.  Returns the kernel launches it made."""
    total = take_counts()
    batches = SERVING_WINDOWS[0]
    oracle = ConcurrencyController(default_library())
    reqs = window_requests(oracle, cfg, weights, batches, gen, device)
    runs = []
    for inj in (None, FaultInjector(tuple(replace(r, p=0.0) for r in CLASS_RULES),
                                    seed=SEED)):
        rt = ladder_runtime(device, inj)
        w = serve_window(rt, cfg, weights, batches, gen, reqs)
        check_healthy(rt, "per-class window, rules at p = 0")
        runs.append((w, take_counts()))
        total += runs[-1][1]
    (w0, c0), (w1, c1) = runs
    tiles = [[(ln.plan.mode, ln.plan.tile, ln.plan.tiles) for ln in w["launch_list"]]
             for w in (w0, w1)]
    same = all(torch.equal(a.result, b.result)
               for a, b in zip(w0["tickets"], w1["tickets"], strict=True))
    if tiles[0] != tiles[1] or c0 != c1 or not same:
        raise AssertionError("rules at p = 0 changed the window: tiles "
                             f"{tiles[0] == tiles[1]}, launches {c0} vs {c1}, "
                             f"bitwise {same}")
    print(f"# rules at p = 0: the same {len(tiles[0])} launches at the same tiles, "
          f"bitwise-equal results, kernel launches {dict(c1)} as with no injector")

    kv = make_kv_caches(cfg, len(unfused), [1], OP_CONFIGS[0][1], gen, device)
    injected = []
    for label, rules, drive in (
            ("per-class window [8, 8, 8, 8]", CLASS_RULES,
             lambda rt: serve_window(rt, cfg, weights, batches, gen, reqs)),
            ("op-bundle window [1] available 16", BUNDLE_RULES,
             lambda rt: op_tickets(drive_op_bundles(
                 rt, cfg, unfused, kv, [1], OP_CONFIGS[0][1], gen)[0]))):
        rt = ladder_runtime(device, FaultInjector(rules, seed=SEED))
        drive(rt)
        reconcile(rt, f"injected {label}")
        injected.append((label, rt))
        total += take_counts()

        rt = ladder_runtime(device, FaultInjector((FaultRule("raise", 1.0),),
                                                  seed=SEED))
        drive(rt)
        counts = take_counts()
        total += counts
        rungs = Counter(g.fallback for g in rt.telemetry.groups)
        if set(rungs) != {"reference"}:
            raise AssertionError(f"{label} at p = 1: launches completed on {rungs}")
        print(f"# {label}, every attempt raising: {sum(rungs.values())} launches all "
              f"on the reference rung, which launched (counted from zero) "
              f"{dict(counts)}; "
              "every result held to the plain version")
    for label, rt in injected:
        q = rt.telemetry.quarantines
        rt.process_retunes(now=rt.device_free_t + rt.config.quarantine_cooldown_s)
        if rt.telemetry.probes != q or rt.ctrl.lib.quarantined():
            raise AssertionError(f"{label}: {rt.telemetry.probes} probes for {q} "
                                 "quarantines")
        print(f"# {label}: process_retunes past the cooldown released "
              f"{rt.telemetry.probes} quarantines as half-open probes")
    return total


def op_tickets(handles) -> None:
    """Every member of the bundles ``handles`` finished and held to its
    plain version."""
    if not all(h.done for h in handles):
        raise AssertionError("a bundle was left unfinished")
    check_op_tickets([m for h in handles for m in h.members])


def self_correction_phase(cfg, unfused, device="cuda", layers=None) -> None:
    """The calibrator and the fallback ladder at Qwen3-14B's full width,
    on phase 5's unfused weights and phase 4's fused weights made again
    from its seed.  Its launches are counted apart and the counters
    zeroed after it, so the `kernels` line counts only the serving
    paths."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    weights = make_weights(cfg, layers or cfg.n_layers, gen, device)
    reset_counts()
    counts = calibration_part(cfg, weights, unfused, gen, device)
    counts += ladder_part(cfg, weights, unfused, gen, device)
    print(f"# self-correction: {time.perf_counter() - t0:.1f} s (host clock, the "
          f"phase's checks included); kernel launches of this phase (not in the "
          f"kernels line) {dict(counts)}")


# ------------------------------------------------------------- SLO serving
PROMPT = 4096            # the prefill tenant's prompt, tokens
SLO_CONTEXT = 4096       # the decode tenant's cached tokens
SLO_BATCH = 8            # the decode tenant's sequences
SLO_STEP_S = 1e-3        # the virtual clock's step between layers
SLO_TENANTS = {"prefill": TenantSLO("batch", weight=1.0, p99_target_s=1.0),
               "decode": TenantSLO("latency", weight=4.0, p99_target_s=20e-3)}
# (A) today's runtime: round-robin, no slicing, no budget; (B) EDF with
# admission slicing and a 1 ms commit horizon per flush.
SLO_WINDOWS = (("A", {}),
               ("B", dict(policy="edf", slicing=True, flush_budget_s=1e-3,
                          slice_budget_frac=0.5, max_slices=8)))
SLO_SCAN = ScanDesc(4, 1024, 64, 64, 64)
# Layers the SLO windows serve: 10 of phase 5's 40 (window B's host
# planning grows with them; the script's time limit holds phase 10d too)
SLO_LAYERS = 10
GEMM_NAMES = ("q", "k", "v", "o", "gate", "up", "down")


def slo_runtime(device, cfg: dict) -> Runtime:
    rt = Runtime(ConcurrencyController(),
                 RuntimeConfig(window_s=0.0, execute=True, **cfg), device=device)
    for tenant, slo in SLO_TENANTS.items():
        rt.set_tenant_slo(tenant, slo)
    return rt


def prompt_attention(cfg, prompt: int) -> AttentionDesc:
    return AttentionDesc(1, cfg.n_heads, cfg.n_kv_heads, prompt, prompt,
                         cfg.resolved_head_dim)


def prompt_operands(cfg, prompt: int, gen, device, integer: bool = False) -> tuple:
    """The prompt's activations, shared by every layer: (prompt, d_model)
    for the GEMMs with K = d_model, (prompt, d_ff) for down — integers in
    [-3, 3] when ``integer`` — and the attention's q, k, v."""
    def act(*shape):
        if integer:
            return torch.randint(-3, 4, shape, generator=gen, device=device).to(
                torch.bfloat16)
        return torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)

    d = prompt_attention(cfg, prompt)
    qkv = tuple(torch.randn(s, generator=gen, device=device, dtype=torch.bfloat16)
                for s in ((1, d.Hq, prompt, d.D), (1, d.Hkv, prompt, d.D),
                          (1, d.Hkv, prompt, d.D)))
    return act(prompt, cfg.d_model), act(prompt, cfg.d_ff), qkv


def prompt_requests(cfg, wl: list, acts: tuple, prompt: int) -> list:
    """One layer's prompt: the seven GEMMs on the layer's weights, each a
    request of its own, then the causal attention as a one-member bundle."""
    x, xf, qkv = acts
    reqs = [GemmRequest(desc=d, a=x if d.K == x.shape[1] else xf, b=w)
            for d, w in zip(unfused_descs(cfg, prompt), wl)]
    return reqs + [[bind_operands(prompt_attention(cfg, prompt), qkv)]]


def drive_slo(rt: Runtime, cfg, weights: list, kv, acts: tuple, gen, prompt: int,
              context: int):
    """Per layer ℓ, at ℓ·SLO_STEP_S on the runtime's clock: the prefill
    tenant's prompt ops and (with ``kv``) the decode tenant's whole
    decode-step bundle, then one forced flush; a drain at the end.
    Returns the prompt tickets, the decode bundle handles, the executed
    launches each with its record (launch order), and the wall time up
    to the last result being ready."""
    t0 = time.perf_counter()
    n0 = len(rt.telemetry.groups)
    prompt_tickets, bundles, launches = [], [], []
    for li, wl in enumerate(weights):
        now = li * SLO_STEP_S
        for r in prompt_requests(cfg, wl, acts, prompt):
            prompt_tickets.append(rt.submit(r, tenant="prefill", now=now))
        if kv is not None:
            ws = iter(wl)
            reqs = [op_request(d, next(ws) if d.family == "gemm" else None,
                               kv[li][0], gen, rt.device)
                    for d in decode_step_op_descs(cfg, SLO_BATCH, context)]
            bundles.append(rt.submit(reqs, tenant="decode", now=now))
        launches += rt.flush(now=now, force=True)
    launches += rt.drain(now=len(weights) * SLO_STEP_S)
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    recs = rt.telemetry.groups[n0:]
    if len(recs) != len(launches):
        raise AssertionError(f"{len(launches)} launches but {len(recs)} records")
    return prompt_tickets, bundles, list(zip(launches, recs)), time.perf_counter() - t0


def op_of(tk):
    """The op a prompt ticket stands for: itself, or its bundle's member."""
    return tk.members[0] if tk.members else tk


def leaves(tk) -> list:
    """The tickets that ran for ``tk``: its members', its pieces, or it."""
    if tk.members is not None:
        return [x for m in tk.members for x in leaves(m)]
    return list(tk.pieces) if tk.pieces is not None else [tk]


def device_completions(timed, tickets) -> list:
    """For each ticket, the device seconds from the window's first launch to
    the end of the launch that completes it: the CUDA-event times of the
    launches up to that one summed in launch order (host gaps left out)."""
    ends, t = [], 0.0
    for _, rec in timed:
        t += rec.achieved_time_s
        ends.append(t)
    where = {tk.seq: i for i, (ln, _) in enumerate(timed) for tk in ln.tickets}
    return [ends[max(where[x.seq] for x in leaves(tk))] for tk in tickets]


def carried(ln) -> str:
    """What a launch carried: a class queue's launch by mode and class, a
    mixed launch by its members' tenants and families."""
    if ln.class_key != MIXED_CLASS:
        return f"{ln.plan.mode} {ln.class_key}"
    c = Counter(f"{t.tenant} {t.desc.family}" for t in ln.tickets)
    return "mixed " + " + ".join(f"{n} {k}" for k, n in sorted(c.items()))


def launch_breakdown(timed) -> dict:
    """Launches and device seconds by what they carried (`carried`)."""
    out = {}
    for ln, rec in timed:
        n, sec = out.get(carried(ln), (0, 0.0))
        out[carried(ln)] = (n + 1, sec + rec.achieved_time_s)
    return out


def planned_entries(rt: Runtime, cfg, prompt: int) -> list:
    """The planner's queue entries for one prompt layer: each op's pieces
    under ``rt``'s admission (1 when it stays whole)."""
    descs = unfused_descs(cfg, prompt) + [prompt_attention(cfg, prompt)]
    return [slice_plan(d, rt._admission_parts(d)).parts for d in descs]


def merge_ms(parent, reps: int = 3) -> float:
    """A sliced parent's merge (`SlicePlan.merge`, one `torch.cat`) run
    again on its pieces' results: mean device ms of ``reps`` calls after
    one, by CUDA events."""
    outs = [p.result for p in parent.pieces]
    parent.merge_plan.merge(outs)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        parent.merge_plan.merge(outs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_prompt(prompt_tickets, attn_ref, what: str) -> None:
    for tk in prompt_tickets:
        t, r = op_of(tk), op_of(tk).request
        label = f"{what} prompt {t.desc.key()} " + (
            f"({len(t.pieces)} pieces merged)" if t.sliced else "(whole)")
        if not tk.done:
            raise AssertionError(f"{label}: unfinished")
        if t.desc.family == "gemm":
            check_close(t.result, gemm_ref(r.a, r.b), abs_product(r.a, r.b), label)
        else:
            check_tol(t.result, attn_ref, *attention_tol(t.result.dtype), label)


def slo_window(name: str, cfg, weights, kv, acts, attn_ref, gen, device, prompt: int,
               context: int) -> list:
    """One window (`SLO_WINDOWS`): driven, every result held to its plain
    version, its counts and times printed; returns the decode bundles'
    device-time completions."""
    rt = slo_runtime(device, dict(SLO_WINDOWS)[name])
    with HostStalls(device) as stalls:
        prompt_tickets, bundles, timed, wall = drive_slo(rt, cfg, weights, kv, acts, gen,
                                                         prompt, context)
    feeds, routes = dict(gemm_kernel.matmul.feeds), dict(mamba_scan_fwd.routes)
    counts = take_counts()
    attn_prompt = sum(len(leaves(op_of(tk))) for tk in prompt_tickets
                      if op_of(tk).desc.family == "flash_attention")
    attn_decode = sum(len(leaves(m)) for h in bundles for m in h.members
                      if m.desc.family == "flash_attention")
    if device == "cuda" and (counts["flash_prefill"] != attn_prompt
                             or counts["flash_attention"] != attn_decode):
        raise AssertionError(f"window {name}: attention launches {dict(counts)}; the "
                             f"prompt's {attn_prompt} must take the prefill route, the "
                             f"decode bundles' {attn_decode} the decode route")
    check_prompt(prompt_tickets, attn_ref, f"window {name}")
    if not all(h.done for h in bundles):
        raise AssertionError(f"window {name}: a decode bundle was left unfinished")
    check_op_tickets([m for h in bundles for m in h.members])
    check_healthy(rt, f"SLO window {name}")
    tele = rt.telemetry
    entries = planned_entries(rt, cfg, prompt)
    per_layer = [len(leaves(op_of(tk))) for tk in prompt_tickets[:len(entries)]]
    want = len(weights) * sum(p for p in entries if p > 1)
    if per_layer != entries or tele.slice_counts["prefill"] != want:
        raise AssertionError(f"window {name}: pieces {per_layer} a layer, telemetry "
                             f"{dict(tele.slice_counts)}; the planner's {entries}")
    if (tele.deferred_launches > 0) != (name == "B"):
        raise AssertionError(f"window {name}: {tele.deferred_launches} deferred launches")
    done = device_completions(timed, bundles)
    lat = sorted(done)
    prompt_ends = device_completions(timed, prompt_tickets)
    prompt_s = sum(rec.achieved_time_s for ln, rec in timed
                   if any(t.tenant == "prefill" for t in ln.tickets))
    merges = {}
    if device == "cuda":
        for i, tk in enumerate(prompt_tickets):
            t = op_of(tk)
            if t.sliced:
                op = (GEMM_NAMES + ("attention",))[i % len(entries)]
                merges.setdefault(op, []).append(merge_ms(t))
    names = GEMM_NAMES + ("attention",)
    config = dict(SLO_WINDOWS)[name] or "round-robin, no slicing, no budget"
    print(f"# SLO window {name} ({config}): {len(weights)} layers; launches by mode "
          f"{dict(Counter(rec.mode for _, rec in timed))}; kernel launches {dict(counts)}; "
          f"matmul launches by feed {feeds}; scan launches by route {routes}")
    print(f"#   pieces per op {dict(zip(names, per_layer))} ({sum(per_layer)} queue entries "
          f"a layer, as planned), {tele.sliced_ops} ops sliced into "
          f"{dict(tele.slice_counts)} pieces; deferred launches {tele.deferred_launches}")
    print(f"#   decode bundles' device-time completion (ms, launch order): "
          f"{[round(x * 1e3, 4) for x in done]}; p50 {lat[len(lat) // 2] * 1e3:.4f} "
          f"ms, max {lat[-1] * 1e3:.4f} ms")
    print(f"#   prefill: device {prompt_s:.6f} s in its launches, completed at "
          f"{max(prompt_ends):.6f} s of device time; window device "
          f"{sum(rec.achieved_time_s for _, rec in timed):.6f} s, wall {wall:.6f} s")
    if merges:
        print(f"#   merges (torch.cat, run again on the pieces; ms mean / max over layers): "
              + ", ".join(f"{op} {sum(v) / len(v):.4f} / {max(v):.4f}"
                          for op, v in merges.items())
              + f"; total {sum(map(sum, merges.values())):.4f} ms")
    slow_ln, slow = max(timed, key=lambda x: x[1].achieved_time_s)
    print("#   launches and device s by what they carried: " + "; ".join(
        f"{k}: {n}, {sec:.6f}" for k, (n, sec) in launch_breakdown(timed).items())
        + f"; slowest launch {carried(slow_ln)} {slow.achieved_time_s * 1e3:.3f} ms")
    print(f"#   host stalls in the window: {stalls}")
    print(f"#   the planner's modeled latencies (TPU spec, ranking only): "
          f"{tele.tenant_percentiles()}")
    return done


def profile_slo(name: str, cfg, weights, kv, acts, gen, device, prompt: int,
                context: int) -> None:
    """Window ``name`` again, on a fresh runtime, under the profiler
    (`profile_window`): kernel time by kind and the device's idle share,
    free of the host stalls (collections, cudaMalloc) that land inside
    the runtime's event brackets.  Its launches are not counted."""
    rt = slo_runtime(device, dict(SLO_WINDOWS)[name])

    def drive():
        _, _, timed, wall = drive_slo(rt, cfg, weights, kv, acts, gen, prompt, context)
        return wall, [ln for ln, _ in timed]

    profile_window(f"SLO window {name}", drive)
    take_counts()


def exact_layer(cfg, prompt: int, gen, device) -> None:
    """One prompt layer with integer-valued weights and activations (every
    f32 sum exact) through both windows' runtimes: every GEMM's merged
    pieces must equal the unsliced run bitwise; attention, whose pieces'
    kv splits differ, within its tolerance of the plain version."""
    wl = [torch.randint(-3, 4, (d.K, d.N), generator=gen, device=device).to(
        torch.bfloat16) for d in unfused_descs(cfg, prompt)]
    acts = prompt_operands(cfg, prompt, gen, device, integer=True)
    runs = {}
    for name, _ in SLO_WINDOWS:
        rt = slo_runtime(device, dict(SLO_WINDOWS)[name])
        runs[name] = [op_of(t) for t in drive_slo(rt, cfg, [wl], None, acts, gen,
                                                  prompt, 0)[0]]
        check_healthy(rt, f"integer layer, window {name}")
    sliced = 0
    for whole, piece in zip(runs["A"], runs["B"], strict=True):
        if whole.desc.family == "gemm":
            if whole.sliced or not torch.equal(piece.result, whole.result):
                raise AssertionError(f"integer layer {whole.desc.key()}: merged "
                                     f"{len(piece.pieces or [])} pieces != unsliced")
            sliced += piece.sliced
        else:
            for t in (whole, piece):
                check_attention(t.result, *acts[2], 0, f"integer layer {t.desc.key()}")
    if not sliced:
        raise AssertionError("integer layer: window B sliced no GEMM")
    print(f"# integer-valued layer: {sliced} sliced GEMMs merged bitwise equal to the "
          f"unsliced run, the attention within its tolerance in both; launches "
          f"{dict(take_counts())}")


def sliced_scan(gen, device) -> None:
    """`SLO_SCAN` as a one-member bundle through window B's runtime: sliced
    by batch, each piece on the chunks route, the merged y within the scan
    tolerance of the plain version."""
    rt = slo_runtime(device, dict(SLO_WINDOWS)["B"])
    h = rt.submit([op_request(SLO_SCAN, None, None, gen, rt.device)], tenant="prefill",
                  now=0.0)
    rt.drain(now=0.0)
    tk = h.members[0]
    routes = dict(mamba_scan_fwd.routes)
    counts = take_counts()
    if not tk.sliced:
        raise AssertionError(f"{SLO_SCAN.key()} was not sliced")
    check_op_tickets([tk])
    check_healthy(rt, "sliced scan")
    if device == "cuda" and routes["chunks"] != len(tk.pieces):
        raise AssertionError(f"sliced scan: routes {routes} for {len(tk.pieces)} pieces")
    print(f"# sliced scan {SLO_SCAN.key()}: pieces {[p.desc.key() for p in tk.pieces]}, "
          f"launches by route {routes} ({dict(counts)}), merged y within the scan "
          "tolerance of ssd_chunk_ref")


def slo_phase(cfg, unfused, device="cuda", prompt: int = PROMPT,
              context: int = SLO_CONTEXT) -> None:
    """SLO serving at full width on phase 5's unfused weights: a prompt of
    ``prompt`` tokens beside decode traffic, every layer of ``unfused``,
    in windows A and B (`SLO_WINDOWS`); then one integer-valued layer, and
    a batch-sliced scan.  Launches counted apart, not in the kernels line."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    take_counts()
    kv = make_kv_caches(cfg, len(unfused), [SLO_BATCH], context, gen, device)
    kv_gb = sum(t.numel() * 2 for lkv in kv for pair in lkv for t in pair) / 1e9
    acts = prompt_operands(cfg, prompt, gen, device)
    attn_ref = attention_f32_ref(*acts[2], 0)
    print(f"# SLO serving {cfg.name}: {len(unfused)} of {cfg.n_layers} layers, a "
          f"{prompt}-token prompt (tenant prefill: {SLO_TENANTS['prefill']}) beside decode bundles at "
          f"batch {SLO_BATCH} over {context} cached tokens (tenant decode: "
          f"{SLO_TENANTS['decode']}); KV caches {kv_gb:.2f} GB on {device}")
    done = {}
    for name, _ in SLO_WINDOWS:
        done[name] = slo_window(name, cfg, unfused, kv, acts, attn_ref, gen, device,
                                prompt, context)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
            # The window again under the profiler: kernel time by kind and
            # the idle share, free of the host stalls (collections,
            # cudaMalloc) that land inside the runtime's event brackets.
            profile_slo(name, cfg, unfused, kv, acts, gen, device, prompt, context)
            gc.collect()
            torch.cuda.empty_cache()
    print(f"# decode completion, window A over B, per layer: "
          f"{[round(a / b, 3) for a, b in zip(done['A'], done['B'])]}")
    del kv, acts, attn_ref
    exact_layer(cfg, prompt, gen, device)
    sliced_scan(gen, device)
    print(f"# SLO serving: {time.perf_counter() - t0:.1f} s (host clock, the phase's "
          "checks included)")

# ------------------------------------------------------------ model serving
# (a) each model at full width and a small depth, float32, on the card and
# on the CPU with the same weights: Zamba2-1.2B at 6 layers runs its
# shared attention block once (layer 5), DeepSeek-V2-Lite-16B at 2 has its
# dense layer and one MoE layer.
MODEL_CHECKS = (("qwen3-14b", 2), ("zamba2-1.2b", 6), ("deepseek-v2-lite-16b", 2))
CHECK_BATCH, CHECK_PROMPT, CHECK_STEPS = 2, 64, 4
# Card against CPU logits, per call: max |Δ| ≤ MODEL_TOL·max(1, max |CPU|).
# Each kernel on the path is held to its plain version within 2e-4
# (attention) and 3e-4 (scan) of |plain| per call in f32, cuBLAS and the
# CPU sum f32 GEMMs in other orders, and a layer's error passes to the
# next; a wrong head, expert, chunk or cache slot moves logits by O(1).
MODEL_TOL = 2e-3
# (b) each model at full width and depth in bf16, the serving traffic
SERVE_MODELS = ("qwen3-14b", "zamba2-1.2b", "deepseek-v2-lite-16b")
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 1000, 32
MODEL_KERNELS = ("flash_prefill", "mamba_scan", "grouped_matmul")
# The plain versions the model path could reach on the card; made to raise
# while (b) and (c) run.
PLAIN_VERSIONS = ((flash_ops, "flash_ref"), (scan_ops, "ssd_chunk_ref"),
                  (grouped_ops, "grouped_gemm_ref"), (grouped_ops, "ragged_gemm_ref"))


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def mark() -> torch.cuda.Event:
    """A point on the device's timeline: a recorded CUDA event."""
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def plain_versions_raise():
    """Make every plain version of `PLAIN_VERSIONS` raise; returns the call
    that puts them back."""
    saved = [(m, n, getattr(m, n)) for m, n in PLAIN_VERSIONS]

    def plain(*args, **kw):
        raise AssertionError("a plain version ran on the card's model path")

    for m, n, _ in saved:
        setattr(m, n, plain)
    return lambda: [setattr(m, n, f) for m, n, f in saved]


def scan_layers(cfg) -> int:
    """Scan calls per forward: one per Mamba layer (Zamba2), two per
    mLSTM layer (xLSTM: its memory and its normaliser)."""
    if cfg.family == "hybrid":
        return cfg.n_layers
    if cfg.family == "ssm":
        return 2 * (cfg.n_layers // cfg.slstm_every) * (cfg.slstm_every - 1)
    return 0


def model_launches(cfg, steps: int, dtype, T: int) -> tuple[Counter, dict]:
    """The kernel launches (and scan routes) of one greedy run of ``steps``
    decode steps after a prompt of T positions in ``dtype``: flash
    attention once per attention layer in the prefill, on the kernel of
    `attention_kernel` (a decode step reads the cache by einsums), the
    scan once per call of `scan_layers` on the chunks route in the prefill
    and on the decode kernel per step, and per forward three grouped GEMMs
    per MoE layer, each one launch per `MAX_MEMBERS` experts."""
    attn = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else
            0 if cfg.family == "ssm" else cfg.n_layers)
    mamba = scan_layers(cfg)
    moe = cfg.n_layers - cfg.first_dense_layers if cfg.family == "moe" else 0
    grouped = moe * 3 * -(-cfg.n_routed_experts // grouped_kernel.MAX_MEMBERS)
    want = +Counter({attention_kernel(dtype, T): attn, "mamba_scan": mamba * (1 + steps),
                     "grouped_matmul": grouped * (1 + steps)})
    return want, {"decode": mamba * steps, "chunks": mamba}


def check_model_launches(label: str, cfg, steps: int, counts: Counter,
                         routes: dict, dtype, T: int) -> None:
    want, want_routes = model_launches(cfg, steps, dtype, T)
    if counts != want or routes != want_routes:
        raise AssertionError(f"{label}: launches {dict(counts)}, scan routes {routes}; "
                             f"the model path makes {dict(want)}, {want_routes}")


def model_prompt(cfg, B: int, T: int, dtype=torch.bfloat16) -> dict:
    """A prompt of T positions from `make_batch` (labels dropped): tokens;
    MusicGen's frames; Pixtral's 256 patches in front of T − 256 tokens.
    Embeddings in ``dtype``."""
    batch = make_batch(cfg, InputShape("serve", T, B, "prefill"), 0, embed_dtype=dtype)
    batch.pop("labels")
    return batch


def generate(model, batch: dict, *, steps: int, s_max: int, cache_dtype,
             on_step=None) -> torch.Tensor:
    """``steps`` greedy steps after the prompt ``batch`` on the card:
    `greedy_decode`, or for MusicGen's audio stub (whose step takes a
    frame, which the greedy loop cannot feed: it raises) the prefill on
    the prompt's frames, then one step per seeded frame (`make_batch`'s
    frames of steps 1, 2, ...); returns the (B, steps) argmax codes."""
    if model.cfg.frontend != "audio_frames":
        return greedy_decode(model, batch, s_max=s_max, steps=steps, device="cuda",
                             cache_dtype=cache_dtype, on_step=on_step)
    B = batch["frames"].shape[0]
    frames = step_frames(model.cfg, B, steps, batch["frames"].dtype)
    out = []
    with torch.inference_mode():
        cache = model.init_cache(B, s_max, cache_dtype)
        logits, cache, n = model.prefill({"frames": batch["frames"].cuda()}, cache)
        for f in frames:
            if on_step is not None:
                on_step(logits)
            out.append(logits[:, -1].argmax(-1, keepdim=True))
            logits, cache, n = model.decode_step(f, cache, n)
        if on_step is not None:
            on_step(logits)
    return torch.cat(out, 1)


def step_frames(cfg, B: int, steps: int, dtype) -> list:
    """MusicGen's decode inputs: the (B, 1, D) frames of `make_batch`'s
    steps 1 .. ``steps``, on the card."""
    return [make_batch(cfg, InputShape("step", 1, B, "prefill"), 1 + i,
                       embed_dtype=dtype)["frames"].cuda() for i in range(steps)]


def model_check(name: str, layers: int, prompt_len: int = CHECK_PROMPT,
                rescaled: bool = False, **fields) -> Counter:
    """(a): ``name`` at full width and ``layers`` deep (``fields`` replaced
    besides) in f32, weights from a seed on the card (``rescaled``: moved
    to the better-conditioned tree, `rescale`) and copied to the CPU; a
    batch-2 prompt of ``prompt_len`` positions and 4 greedy steps
    on the card (MusicGen: seeded frames), the same inputs teacher-forced
    on the CPU (the plain versions); every call's logits within
    MODEL_TOL, and each greedy token the CPU's argmax unless the CPU's top
    two lie within the tolerance of each other.  Returns the launches."""
    t0 = time.perf_counter()
    cfg = replace(get_arch(name), n_layers=layers, **fields)
    card = build_model(cfg, device="cuda", dtype=torch.float32, seed=SEED + 6)
    if rescaled:
        with torch.no_grad():
            rescale(card, dict(card.named_parameters()))
    cpu = build_model(cfg, device="cpu", seed=None)
    cpu.load_state_dict(card.state_dict())
    prompt = model_prompt(cfg, CHECK_BATCH, prompt_len, torch.float32)
    s_max = prompt_len + CHECK_STEPS + 1
    seen = []
    reset_counts()
    toks = generate(card, prompt, steps=CHECK_STEPS, s_max=s_max,
                    cache_dtype=torch.float32, on_step=seen.append).cpu()
    routes = dict(mamba_scan_fwd.routes)
    counts = take_counts()
    check_model_launches(f"{name} at {layers} layers", cfg, CHECK_STEPS, counts, routes,
                         torch.float32, prompt_len)
    audio = cfg.frontend == "audio_frames"
    fed = ([f.cpu() for f in step_frames(cfg, CHECK_BATCH, CHECK_STEPS, torch.float32)]
           if audio else [toks[:, i:i + 1] for i in range(CHECK_STEPS)])
    with torch.inference_mode():
        cache = cpu.init_cache(CHECK_BATCH, s_max, torch.float32)
        logits, cache, n = cpu.prefill(prompt, cache)
        ref = [logits]
        for x in fed:
            logits, cache, n = cpu.decode_step(x, cache, n)
            ref.append(logits)
    errs, flips = [], 0
    for i, (got, want) in enumerate(zip(seen, ref)):
        got = got.cpu()
        what = f"{name} at {layers} layers, {'prefill' if i == 0 else f'decode {i}'}"
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: non-finite logits on the card")
        err = float((got - want).abs().max())
        tol = MODEL_TOL * max(1.0, float(want.abs().max()))
        if err > tol:
            raise AssertionError(f"{what}: card logits off the CPU's by {err:.4g} > {tol:.4g}")
        errs.append(err)
        if i < CHECK_STEPS:
            top2 = want[:, -1].topk(2, dim=-1).values
            for b in range(CHECK_BATCH):
                tok = int(toks[b, i])
                if tok != int(want[b, -1].argmax()):
                    flips += 1
                    if float(top2[b, 0] - want[b, -1, tok]) > 2 * tol:
                        raise AssertionError(f"{what}: card token {tok} is not the CPU's "
                                             "argmax beyond the tolerance")
    extra = "".join(f", {k} {v}" for k, v in fields.items()) + (
        ", on the rescaled tree" if rescaled else "")
    print(f"# model check {name} at full width, {layers} of {get_arch(name).n_layers} "
          f"layers{extra}, f32 ({card.param_count() / 1e9:.3f} B parameters): batch "
          f"{CHECK_BATCH}, {prompt_len}-position prompt, {CHECK_STEPS} greedy steps; "
          f"card vs CPU logits max |Δ| per call {[float(f'{e:.4g}') for e in errs]} "
          f"(tolerance {MODEL_TOL}·max(1, |CPU|)); greedy tokens other than the CPU's "
          f"argmax: {flips}; kernel launches {dict(counts)}, scan routes {routes}; "
          f"{time.perf_counter() - t0:.1f} s (host clock)")
    return counts


def shared_reapplied(cfg) -> int:
    """Parameters that Zamba2's weight-tied shared block adds past its
    first application: it runs on ``n_layers // attn_every`` layers, and
    each application multiplies by all its weights and reads them again
    (67M parameters, 134 MB in bf16, do not stay in the 50 MB L2).  The
    parameter counts hold the block once."""
    if cfg.family != "hybrid":
        return 0
    return (cfg.n_layers // cfg.attn_every - 1) * spec_param_count(zamba_shared_specs(cfg))


def tables(cfg) -> int:
    """Parameters of the token table and the LM head (one table when tied)."""
    return cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)


def weights_read(cfg, routed_experts: int | None) -> int:
    """Weight bytes (bf16) one decode step must read: every weight but the
    token table (B rows gathered; a tied table is the LM head, read
    whole), Zamba2's shared block once per application; of an MoE model's
    routed experts only ``routed_experts`` (summed over its MoE layers)
    FFNs."""
    n = (Model(cfg, device="meta").param_count() + shared_reapplied(cfg)
         - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model))
    if cfg.family == "moe":
        per_expert = 3 * cfg.d_model * cfg.moe_d_ff
        n -= (cfg.n_layers - cfg.first_dense_layers) * cfg.n_routed_experts * per_expert
        n += routed_experts * per_expert
    return 2 * n


def layer_windows(cfg) -> list:
    """Each attention layer's window (0: all keys), as `Model.window`
    gives it; one entry per layer that runs attention."""
    if cfg.family == "ssm":
        return []
    if cfg.family == "hybrid":
        return [0] * (cfg.n_layers // cfg.attn_every)
    r = cfg.local_global_ratio
    return [0 if cfg.sliding_window and r and i % (r + 1) == r else cfg.sliding_window
            for i in range(cfg.n_layers)]


def keys_seen(T: int, past: int, window: int) -> int:
    """Keys summed over T new queries after ``past`` cached ones, causal,
    each seeing at most ``window`` keys (all when 0)."""
    if not window:
        return T * past + T * (T + 1) // 2
    return sum(min(past + i + 1, window) for i in range(T))


def xlstm_state_bytes(cfg, B: int) -> int:
    """Bytes of xLSTM's decode state (mLSTM's f32 C and n and bf16 conv
    tail, sLSTM's four f32 vectors), read and written each call."""
    groups, k = cfg.n_layers // cfg.slstm_every, cfg.slstm_every
    di, H = 2 * cfg.d_model, cfg.n_heads
    N = di // H
    mlstm = H * N * (N + 1) * 4 + 3 * di * 2
    return 2 * B * groups * ((k - 1) * mlstm + 4 * cfg.d_model * 4)


def cache_bytes(cfg, B: int, length: int) -> int:
    """Cache bytes a decode step must read at ``length`` cached tokens
    (bf16 K/V or latents, a windowed layer's last ``window`` only;
    Zamba2's f32 SSM state read and written, conv tail read and written;
    xLSTM's state) and write (one token's entries)."""
    if cfg.family == "hybrid":
        kv = 2 * cfg.n_kv_heads * cfg.resolved_head_dim * (cfg.n_layers // cfg.attn_every)
        conv = (cfg.ssm_d_inner + 2 * cfg.ssm_state) * (cfg.ssm_conv - 1) * 2
        state = cfg.ssm_n_heads * cfg.ssm_state * cfg.ssm_head_dim * 4
        return B * (2 * kv * (length + 1) + cfg.n_layers * 2 * (conv + state))
    if cfg.family == "ssm":
        return xlstm_state_bytes(cfg, B)
    if cfg.attn_type == "mla":
        per = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    else:
        per = 2 * cfg.n_kv_heads * cfg.resolved_head_dim
    return 2 * B * per * sum(min(length + 1, w) if w else length + 1
                             for w in layer_windows(cfg))


def attention_flops(cfg, B: int, T: int, past: int) -> int:
    """Multiply-adds ×2 of the attention scores and values of T new tokens
    after ``past`` cached ones, causal (the tokens each query sees, within
    a layer's window)."""
    if cfg.attn_type == "mla":
        width = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim
                 if T > 1 else 2 * cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    else:
        width = 2 * cfg.resolved_head_dim
    seen = sum(keys_seen(T, past, w) for w in layer_windows(cfg))
    return 2 * B * cfg.n_heads * seen * width


def mlstm_scan_flops(cfg, B: int, T: int) -> int:
    """xLSTM's scans over T positions (f32 operations): per mLSTM layer its
    memory (P = N) and normaliser (P = 1) at chunk 128, or per decode step
    (T = 1) their closed forms with a state."""
    if cfg.family != "ssm":
        return 0
    layers = scan_layers(cfg) // 2
    H = cfg.n_heads
    N = 2 * cfg.d_model // H
    if T == 1:
        return layers * (decode_flops(B, H, N, N, True) + decode_flops(B, H, 1, N, True))
    return layers * (scan_flops(B, T, H, N, N, 128) + scan_flops(B, T, H, 1, N, 128))


def body_params(cfg) -> int:
    """Parameters each token multiplies outside the token table and LM
    head: the active ones (the reference's closed form; for xLSTM, whose
    closed form is an approximation, the model's own count), Zamba2's
    shared block once per application."""
    n = (Model(cfg, device="meta").param_count() if cfg.family == "ssm"
         else cfg.active_param_count())
    return n - tables(cfg) + shared_reapplied(cfg)


def serve_bounds(cfg, routed: list, B: int = SERVE_BATCH, T: int = SERVE_PROMPT,
                 steps: int = SERVE_STEPS) -> dict:
    """Least times (ms) at the H100's peaks for (b)'s prefill and its mean
    decode step: bytes over the HBM rate vs operations over the peak,
    whichever is larger (bf16 operations at 989 TFLOP/s, xLSTM's f32 scans
    at 67).  Operations: 2 per active weight and token (Zamba2's shared
    block once per application; the LM head on the last position only in
    the prefill) plus attention within each layer's window and xLSTM's
    scans; bytes: the weights as `weights_read`, the caches as
    `cache_bytes`.  ``routed``: per decode step, the distinct experts its
    routing chose (summed over the MoE layers)."""
    V, d = cfg.vocab_size, cfg.d_model
    active = body_params(cfg)
    every_expert = cfg.n_routed_experts * (cfg.n_layers - cfg.first_dense_layers)

    def least(nbytes: int, ops: int, f32_ops: int) -> tuple[float, str]:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (ops / PEAK_OPS[torch.bfloat16] + f32_ops / PEAK_OPS[torch.float32]) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    prefill = least(weights_read(cfg, every_expert) + cache_bytes(cfg, B, T - 1),
                    2 * B * T * active + 2 * B * V * d + attention_flops(cfg, B, T, 0),
                    mlstm_scan_flops(cfg, B, T))
    per_step = []
    for i, r in enumerate(routed or [None] * steps):
        n = T + i
        per_step.append(least(weights_read(cfg, r) + cache_bytes(cfg, B, n),
                              2 * B * (active + V * d) + attention_flops(cfg, B, 1, n),
                              mlstm_scan_flops(cfg, B, 1)))
    mean = sum(t for t, _ in per_step) / len(per_step)
    return dict(prefill=prefill, decode_ms=mean, decode_by=per_step[0][1],
                decode_gb=(weights_read(cfg, routed[0] if routed else None)
                           + cache_bytes(cfg, B, T)) / 1e9)


def model_serve(name: str, layers: int | None = None, prompt_len: int = SERVE_PROMPT,
                steps: int = SERVE_STEPS, profile_steps: int = 2,
                profile_len: int | None = None) -> dict:
    """(b): ``name`` at full width (``layers`` deep, all when None) in bf16
    (weights and caches), batch 4, prompts of ``prompt_len`` positions,
    ``steps`` greedy steps, with every plain version made to raise; one
    run to warm up, then the counted and timed run: exact launch counts,
    tokens in range, logits finite at every step, prefill and decode times
    by CUDA events at each call's end (the decode step's from one to the
    next: the device's timeline, host launch gaps included) beside their
    bounds; then the prefill (of the prompt's first ``profile_len``
    positions, all when None) and ``profile_steps`` decode steps under the
    profiler."""
    t0 = time.perf_counter()
    full = get_arch(name)
    cfg = full if layers is None else replace(full, n_layers=layers)
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED + 7)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    prompt = model_prompt(cfg, SERVE_BATCH, prompt_len)
    s_max = prompt_len + steps + 1
    run = dict(s_max=s_max, steps=steps, cache_dtype=torch.bfloat16)
    restore = plain_versions_raise()
    generate(model, prompt, **run)        # warm-up
    torch.cuda.synchronize()
    routing, real_route = [], model_moe._route

    def route(p, xt, c):
        w, ids, aux = real_route(p, xt, c)
        routing.append(ids)
        return w, ids, aux

    model_moe._route = route
    marks, logits = [], []

    def on_step(lg):
        marks.append(mark())
        logits.append(lg)

    reset_counts()
    h0 = time.perf_counter()
    start = mark()
    toks = generate(model, prompt, on_step=on_step, **run).cpu()
    wall = time.perf_counter() - h0
    routes = dict(mamba_scan_fwd.routes)
    counts = take_counts()
    model_moe._route = real_route
    check_model_launches(f"{name} serving", cfg, steps, counts, routes, torch.bfloat16,
                         prompt_len)
    if toks.shape != (SERVE_BATCH, steps) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{name} serving: tokens {tuple(toks.shape)} out of range")
    finite = [bool(torch.isfinite(lg).all()) for lg in logits]
    if len(finite) != steps + 1 or not all(finite):
        raise AssertionError(f"{name} serving: non-finite logits at calls "
                             f"{[i for i, f in enumerate(finite) if not f]}")
    prefill_ms = start.elapsed_time(marks[0])
    steps_ms = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
    decode_ms = steps_ms[len(steps_ms) // 2]
    moe_layers = cfg.n_layers - cfg.first_dense_layers if cfg.family == "moe" else 0
    routed = None
    if moe_layers:
        per_forward = [routing[i:i + moe_layers] for i in range(0, len(routing), moe_layers)]
        routed = [sum(int(torch.unique(ids).numel()) for ids in f) for f in per_forward[1:]]
    bd = serve_bounds(cfg, routed, SERVE_BATCH, prompt_len, steps)
    decode_s = sum(steps_ms) / 1e3
    depth = "depth" if layers is None else f"{layers} of {full.n_layers} layers"
    print(f"# model serving {name} at full width and {depth}, bf16 "
          f"({model.param_count() / 1e9:.3f} B parameters, made from a seed on the card "
          f"in {made_s:.1f} s): batch {SERVE_BATCH}, {prompt_len}-position prompts, "
          f"{steps} greedy steps, every plain version raising; kernel launches "
          f"{dict(counts)}, scan routes {routes} (as the model path makes them)")
    print(f"#   prefill {prefill_ms:.3f} ms (bound {bd['prefill'][0]:.3f} ms, "
          f"{bd['prefill'][1]}); decode step median {decode_ms:.3f} ms, min "
          f"{steps_ms[0]:.3f}, max {steps_ms[-1]:.3f} (mean bound {bd['decode_ms']:.3f} ms, "
          f"{bd['decode_by']}: {bd['decode_gb']:.2f} GB at the first step"
          + (f", distinct routed experts per step {routed[0]}..{routed[-1]} of "
             f"{moe_layers * cfg.n_routed_experts}" if routed else "")
          + f"); {SERVE_BATCH * steps / decode_s:.1f} tokens/s over the decode "
          f"steps, {SERVE_BATCH * steps / wall:.1f} tokens/s of wall for the run "
          f"({wall:.3f} s, prefill included); {time.perf_counter() - t0:.1f} s (host clock)")
    if profile_steps:
        profile_model(model, {k: v[:, :profile_len] for k, v in prompt.items()},
                      profile_steps)
    restore()
    del model
    return dict(counts=counts, routes=routes, prefill_ms=prefill_ms, decode_ms=decode_ms,
                bounds=bd)


LAUNCHER_PROMPT = 32   # `launch.serve`'s default prompt, positions


def launcher_on_card() -> None:
    """(c): `repro_torch.launch.serve.main` as a user runs it, on Zamba2-1.2B
    at full width and depth in its default f32, the decode steps shadowed
    through the runtime as graphs; its defaults (batch 4, a 32-token
    prompt, 16 steps) give the launches `model_launches` names."""
    restore = plain_versions_raise()
    reset_counts()
    toks = serve_launcher.main(["--arch", ZAMBA, "--runtime", "--graph"])
    routes = dict(mamba_scan_fwd.routes)
    counts = take_counts()
    restore()
    if toks.shape != (4, 16) or toks.device.type != "cuda":
        raise AssertionError(f"launcher: tokens {tuple(toks.shape)} on {toks.device}")
    check_model_launches("launcher", get_arch(ZAMBA), 16, counts, routes, torch.float32,
                         LAUNCHER_PROMPT)
    print(f"# launcher on the card (zamba2-1.2b, f32, --runtime --graph): kernel "
          f"launches {dict(counts)}, scan routes {routes}")


# (B, Hq, Hkv, T, S, D, Dv, window): the prefill attention of each model
# as it calls the kernel: q, and k/v of the GQA models read from the
# (B, S_max, Hkv, D) cache through a transposed view (S_max: the prompt,
# the greedy steps and one), of the MLA models the expanded latents
# (B, T, H, 192/128); Gemma3's local layers (52 of 62) attend through a
# 1,024-token window over its 2,048-token prompt.
MODEL_ATTENTION = (("qwen3-14b", (4, 40, 8, 1000, 1033, 128, 128, 0)),
                   ("zamba2-1.2b", (4, 32, 32, 1000, 1033, 64, 64, 0)),
                   ("deepseek-v2-lite-16b", (4, 16, 16, 1000, 1000, 192, 128, 0)))
ZOO_ATTENTION = (("gemma3-27b local", (4, 32, 16, 2048, 2057, 128, 128, 1024)),
                 ("stablelm-3b", (4, 32, 32, 1000, 1009, 80, 80, 0)),
                 ("qwen2-72b", (4, 64, 8, 1000, 1009, 128, 128, 0)),
                 ("pixtral-12b", (4, 32, 8, 1000, 1009, 128, 128, 0)),
                 ("deepseek-v2-236b", (4, 128, 128, 1000, 1000, 192, 128, 0)))


def window_mask(T: int, S: int, window: int, device) -> torch.Tensor:
    """(T, S) bool: key j visible to query i (q_offset 0): j ≤ i and i − j
    < ``window``; SDPA's mask for the windowed function."""
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    return (j <= i) & (i - j < window)


def model_attention_row(name: str, shape: tuple, gen) -> dict:
    """A model's prefill attention (causal, q_offset 0, its window) in
    bf16, in the model's layouts: compared with the plain version in f32,
    timed beside it and beside `scaled_dot_product_attention` (causal,
    top-left aligned, or with the window as a boolean mask: the same
    function, keys past the prompt masked)."""
    B, Hq, Hkv, T, S, D, Dv, window = shape
    q = randn((B, T, Hq, D), gen).transpose(1, 2)
    k = torch.zeros((B, S, Hkv, D), dtype=torch.bfloat16, device="cuda")
    v = torch.zeros((B, S, Hkv, Dv), dtype=torch.bfloat16, device="cuda")
    k[:, :T], v[:, :T] = randn((B, T, Hkv, D), gen), randn((B, T, Hkv, Dv), gen)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    kw = dict(causal=True, window=window, q_offset=0)
    before = flash_attention_fwd.routes["prefill"]
    out = flash_attention_fwd(q, k, v, **kw)
    if flash_attention_fwd.routes["prefill"] != before + 1:
        raise AssertionError(f"{name} prefill attention missed the prefill route")
    err = check_attention(out, q, k, v, 0, f"{name} prefill attention", causal=True,
                          window=window)
    dq, dv = prefill_width(D, Dv)
    per_sm, smem = prefill_resources(q.device, dq, dv)
    grid = prefill_grid(B, Hq, T)
    print(f"# flash_prefill grid at {name}: {grid[0] * grid[1]} CTAs = {grid[0]} (batch, "
          f"q head) x {grid[1]} blocks of {PREFILL_ROWS} positions, {PREFILL_KV_TILE}-key "
          f"tiles; {dq}/{dv} instantiation, {smem} B shared memory per CTA, {per_sm} CTAs "
          "per SM")
    if name == MODEL_ATTENTION[0][0]:
        planted_prefill_faults(q, k, v, name)
    if window:
        mask = window_mask(T, S, window, q.device)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)
    else:
        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
    check_tol(sdpa(), attention_f32_ref(q, k, v, 0, window=window), SDPA_TOL, SDPA_TOL,
              f"SDPA {name} prefill")
    seen = B * Hq * keys_seen(T, 0, window)
    nbytes = 2 * (q.numel() + B * Hkv * T * (D + Dv) + out.numel())
    return dict(
        shape=f"{name} prefill B{B} Hq{Hq} Hkv{Hkv} T{T} S{S} D{D}/{Dv} bf16, causal"
              + (f", window {window}" if window else "") + ", the model's strided views",
        instantiation=(f"bf16 {dq}/{dv}, {grid[0] * grid[1]} CTAs of {PREFILL_ROWS} "
                       f"positions, {smem} B shared"),
        grid=dict(ctas=grid[0] * grid[1], q_blocks=grid[1], kv_tile=PREFILL_KV_TILE,
                  ctas_per_sm=per_sm, smem_bytes=smem),
        max_abs_err=err,
        ms=time_ms(lambda: flash_attention_fwd(q, k, v, **kw)),
        plain_ms=time_ms(lambda: flash_ref(q, k, v, **kw), reps=3, warmup=1),
        library_ms=time_ms(sdpa),
        bound=bound(nbytes, 2 * seen * (D + Dv), torch.bfloat16))


def planted_prefill_faults(q, k, v, name: str) -> None:
    """The prefill route's check at the main shape (causal, q_offset 0):
    the kernel run as a walk that skipped one kv tile would run (keys
    [lo, lo + PREFILL_KV_TILE) left out, the rows past them at their
    positions), and one q block's diagonal tiles without their mask (the
    block non-causal over the keys up to its end); each must fail
    `check_attention`.  Prints how far off each is."""
    T, kt = q.shape[2], PREFILL_KV_TILE
    ref = attention_f32_ref(q, k, v, 0)
    atol, rtol = attention_tol(q.dtype)
    lo, q0 = 2 * kt, 2 * PREFILL_ROWS
    keep = torch.ones(k.shape[2], dtype=torch.bool, device=k.device)
    keep[lo:lo + kt] = False
    rows = slice(lo + kt, T)
    faults = {
        f"keys [{lo}, {lo + kt}) skipped": (
            flash_attention_fwd(q[:, :, rows], k[:, :, keep], v[:, :, keep], causal=True,
                                q_offset=lo), ref[:, :, rows]),
        f"block [{q0}, {q0 + PREFILL_ROWS}) unmasked": (
            flash_attention_fwd(q[:, :, q0:q0 + PREFILL_ROWS], k[:, :, :q0 + PREFILL_ROWS],
                                v[:, :, :q0 + PREFILL_ROWS], causal=False),
            ref[:, :, q0:q0 + PREFILL_ROWS]),
    }
    for what, (fault, want) in faults.items():
        err, n_bad = tol_excess(fault, want, atol, rtol, f"planted fault ({what})")
        print(f"# planted prefill fault ({what}) at {name}: max |err| {err:.4g}; {n_bad} of "
              f"{fault.numel()} outputs beyond {atol} + {rtol:.6g}·|ref|")
        if not n_bad:
            raise AssertionError(f"the attention tolerance lets a prefill fault through "
                                 f"({what})")


def grouped_row(name: str, what: str, C: int, w, gen) -> dict:
    """An MoE model's grouped expert up-projection at capacity C (G experts,
    K = d, N = d_ff of an expert) at the GO tile for CD 16: compared with
    its plain version, timed beside it and `bmm`."""
    E, D, F = w.shape
    tile = default_library().tile(GemmDesc(C, F, D), min(16, E))
    a = randn((E, C, D), gen)
    out = grouped_kernel.grouped_matmul(a, w, bm=tile.bm)
    err = check_close(out, grouped_gemm_ref(a, w), grouped_abs(a, w), f"{name} grouped up, {what}")
    return dict(
        shape=f"{name} {what} expert up-projection G{E} {C}x{F}x{D} bf16 at {tile.key()}",
        max_abs_err=err,
        ms=time_ms(lambda: grouped_kernel.grouped_matmul(a, w, bm=tile.bm)),
        plain_ms=time_ms(lambda: grouped_gemm_ref(a, w), reps=3, warmup=1),
        library_ms=time_ms(lambda: torch.bmm(a, w)),
        bound=bound(2 * E * (C * D + D * F + C * F), 2 * E * C * F * D, torch.bfloat16))


def print_rows(rows: dict) -> None:
    for name, rs in rows.items():
        for r in rs:
            lib_ms = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"# {name:<15} {r['shape']:<60} kernel {r['ms']:.4f} ms | plain "
                  f"{r['plain_ms']:.4f} | torch {lib_ms} | bound {r['bound'][0]:.6f} "
                  f"({r['bound'][1]}) | max err {r['max_abs_err']:.4g}")


def model_kernel_rows(gen) -> dict:
    """The kernels at the model path's own shapes (phase 10b), each
    compared with its plain version, then timed beside it and the
    PyTorch call computing the same function: the three models' prefill
    attention; Zamba2-1.2B's prefill scan as the model hands it over
    (float32 xd and da, B/C head-broadcast views of (B, T, N), chunk
    128); DeepSeek-V2-Lite-16B's grouped up-projection at the prefill's
    capacity (C 469) and a decode step's (C 1), at the GO tile for CD 16."""
    rows = {"flash_prefill": [model_attention_row(n, sh, gen)
                              for n, sh in MODEL_ATTENTION]}
    torch.cuda.empty_cache()
    B, T, H, P, N, L = 4, SERVE_PROMPT, 64, 64, 64, 128
    f32 = torch.float32
    xd, da, bm, cm = scan_inputs(B, T, H, P, N, gen, f32, broadcast=True)
    before = dict(mamba_scan_fwd.routes)
    y, state = mamba_scan_fwd(xd, da, bm, cm, chunk=L)
    if mamba_scan_fwd.routes["chunks"] != before["chunks"] + 1:
        raise AssertionError("the model's prefill scan missed the chunks route")
    err = check_scan(y, state, xd, da, bm, cm, None, "zamba2-1.2b prefill scan")
    nbytes = 4 * (2 * xd.numel() + da.numel() + 2 * B * T * N) + state.numel() * 4
    rows["mamba_scan"] = [dict(
        shape=f"zamba2-1.2b prefill B{B} T{T} H{H} P{P} N{N} L{L} f32, B/C "
              "head-broadcast (chunks)", route="chunks", max_abs_err=err,
        ms=time_ms(lambda: mamba_scan_fwd(xd, da, bm, cm, chunk=L)),
        plain_ms=time_ms(lambda: ssd_chunk_ref(xd, da, bm, cm, chunk=L), reps=3, warmup=1),
        library_ms=None,
        bound=bound(nbytes, scan_flops(B, T, H, P, N, L, groups=1), f32))]
    del xd, da, bm, cm, y, state
    cfg = get_arch("deepseek-v2-lite-16b")
    w = randn((cfg.n_routed_experts, cfg.d_model, cfg.moe_d_ff), gen,
              scale=cfg.d_model ** -0.5)
    rows["grouped_matmul"] = [grouped_row(cfg.name, what, C, w, gen)
                              for what, C in (("prefill", 469), ("decode step", 1))]
    del w
    torch.cuda.empty_cache()
    print_rows(rows)
    return rows


# xLSTM-350M's scans as its mLSTM layers hand them over (4 heads of N = P =
# 2·1024/4 = 512, every operand f32, chunk 128, the cache's state as s0):
# its memory (P = 512) and normaliser (P = 1), a batch-4 1,000-token
# prompt on the wide chunked passes and a decode step on the decode
# kernel's wide instantiation.
XLSTM_SCANS = (("chunks", 4, 1000, 4, 512, 512), ("chunks", 4, 1000, 4, 1, 512),
               ("decode", 4, 1, 4, 512, 512), ("decode", 4, 1, 4, 1, 512))


def planted_block_fault(xd, da, bm, cm, s0, L: int) -> None:
    """The scan check's power at xLSTM's prompt shape: the kernel run with
    C's third 64-row N block zeroed, what a wide output pass that dropped
    that block of C·S_prev and of G = C·Bᵀ gives, must fail `check_scan`
    against the true inputs."""
    dropped = cm.clone()
    dropped[..., 128:192] = 0
    fy, fs = mamba_scan_fwd(xd, da, bm, dropped, chunk=L, initial_state=s0)
    ex = scan_excess(fy, fs, xd, da, bm, cm, s0, "planted N-block fault")
    print(f"# planted wide-scan fault (C's N rows 128-191 dropped) at {tuple(xd.shape)} "
          f"N{bm.shape[-1]}: y {ex['y'][1]} of {fy.numel()} elements beyond the scan "
          f"tolerance (max |err| {ex['y'][0]:.4g}), so check_scan fails it")
    if not ex["y"][1]:
        raise AssertionError("check_scan lets a dropped N block through")


def wide_scan_rows(gen) -> list:
    """`XLSTM_SCANS`, each checked against the plain version (the first
    with a planted dropped N block that must fail the check), its grid and
    residency printed, then timed beside the plain version and its bound:
    the chunks route on one input set (its 134 MB workspace is beyond the
    50 MB L2), the decode route on state sets rotating beyond the L2."""
    f32, rows = torch.float32, []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for route, B, T, H, P, N in XLSTM_SCANS:
        L = 128
        xd, da, bm, cm = scan_inputs(B, T, H, P, N, gen, f32, broadcast=False)
        state_b = B * H * N * P * 4
        n_sets = 1 if route == "chunks" else max(4, -(-L2_BYTES * 5 // 4 // (2 * state_b)))
        sets = [(randn((B, H, N, P), gen, f32), *scan_buffers(xd, da, bm, cm, chunk=L)[:2])
                for _ in range(n_sets)]
        s0 = sets[0][0]
        before = dict(mamba_scan_fwd.routes)
        y, state = mamba_scan_fwd(xd, da, bm, cm, chunk=L, initial_state=s0)
        if mamba_scan_fwd.routes[route] != before[route] + 1:
            raise AssertionError(f"xLSTM scan {route} P{P}: missed the {route} route")
        what = f"xlstm-350m {route} B{B} T{T} H{H} P{P} N{N}"
        err = check_scan(y, state, xd, da, bm, cm, s0, what)
        if route == "chunks":
            if P == N:
                planted_block_fault(xd, da, bm, cm, s0, L)
            g = chunk_grid(B, T, H, P, N, L, False, f32)
            blocks, smem = chunk_residency(xd.device, f32, 1, N, P, L)
            grid = {}
            for name, ctas, per_sm, shared in (("state", g.state_ctas, blocks[0], smem[0]),
                                               ("carry", g.carry_ctas, blocks[1], 0),
                                               ("output", g.output_ctas, blocks[2], smem[1])):
                grid[name] = dict(ctas=ctas, ctas_per_sm=per_sm,
                                  waves=ctas / (per_sm * sms), smem_bytes=shared)
                print(f"# mamba_scan wide chunks f32 B{B} T{T} H{H} P{P} N{N} L{L}, {name} "
                      f"pass: {ctas} CTAs, {per_sm} per SM, {ctas / (per_sm * sms):.2f} "
                      f"waves, {shared} B dynamic shared memory; {g.col_blocks} column "
                      f"block(s)")
            flops = scan_flops(B, T, H, P, N, L)
        else:
            g = decode_grid(B * H, P, N, sms)
            per_sm, smem = decode_residency(xd.device, f32, P % 4 == 0, True, wide=True)
            grid = dict(ctas=g.ctas, slices=g.slices, pairs_per_cta=g.pairs_per_cta,
                        ctas_per_sm=per_sm, smem_bytes=smem, rotating_sets=n_sets)
            print(f"# mamba_scan wide decode f32 B{B} H{H} P{P} N{N}: {g.ctas} CTAs, "
                  f"{g.slices} column slice(s), {g.row_lanes} row lanes, {per_sm} per SM, "
                  f"{smem} B shared; {n_sets} rotating state sets")
            flops = decode_flops(B, H, P, N, True)
        nbytes = 4 * (xd.numel() + da.numel() + bm.numel() + cm.numel() + y.numel()) + 2 * state_b
        rows.append(dict(
            shape=f"{what} L{L} f32, per-head B/C, initial state ({route})",
            instantiation=f"f32, wide ({'N' if N > 128 else ''}{'P' if P > 128 else ''} > 128)",
            route=route, grid=grid, max_abs_err=err,
            ms=time_ms(rotating(lambda s, yy, st: mamba_scan_fwd(
                xd, da, bm, cm, chunk=L, initial_state=s, out=(yy, st)), sets),
                reps=50 if route == "decode" else 20),
            plain_ms=time_ms(lambda: ssd_chunk_ref(xd, da, bm, cm, chunk=L, initial_state=s0),
                             reps=3, warmup=1),
            library_ms=None,
            bound=bound(nbytes, flops, f32)))
        del xd, da, bm, cm, y, state, sets
        torch.cuda.empty_cache()
    return rows


def zoo_kernel_rows(gen) -> dict:
    """Phase 10d's new kernel shapes, each compared with its plain version
    and timed beside it and the PyTorch call computing the same function:
    the five new prefill attention shapes (Gemma3's windowed local layers
    beside SDPA with the window as a mask, StableLM's head dim 80, Qwen2's
    and Pixtral's 128, DeepSeek-V2-236B's MLA 192/128); DeepSeek-V2-236B's
    grouped up-projection (160 experts, d 5120, expert d_ff 1536) at the
    prefill's capacity (C 188) and a decode step's (C 1); xLSTM's wide
    scans (`wide_scan_rows`)."""
    rows = {"flash_prefill": []}
    for n, sh in ZOO_ATTENTION:
        rows["flash_prefill"].append(model_attention_row(n, sh, gen))
        torch.cuda.empty_cache()
    cfg = get_arch("deepseek-v2-236b")
    w = randn((cfg.n_routed_experts, cfg.d_model, cfg.moe_d_ff), gen,
              scale=cfg.d_model ** -0.5)
    rows["grouped_matmul"] = [grouped_row(cfg.name, what, C, w, gen)
                              for what, C in (("prefill", 188), ("decode step", 1))]
    del w
    torch.cuda.empty_cache()
    rows["mamba_scan"] = wide_scan_rows(gen)
    print_rows(rows)
    return rows


def positions(batch: dict) -> tuple[int, int]:
    """(B, positions) of a prompt: its tokens, frames, or patches and tokens."""
    B = next(iter(batch.values())).shape[0]
    return B, sum(v.shape[1] for k, v in batch.items() if k in ("tokens", "frames", "patches"))


def profile_model(model, batch: dict, steps: int = 2) -> None:
    """The model's prefill and ``steps`` decode steps (bf16 caches), each
    under `torch.profiler`: wall (host clock to a synchronize), kernel
    launches and time, the device's busy share (the union of kernel
    intervals) and the kernels taking the most time; for xLSTM also the
    host seconds inside its sLSTM layers (the loop over tokens)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = model.cfg
    B, T = positions(batch)
    cache = model.init_cache(B, T + steps + 1, torch.bfloat16)
    inputs, state = {k: v.to(model.device) for k, v in batch.items()}, {}
    frames = (step_frames(cfg, B, steps, torch.bfloat16)
              if cfg.frontend == "audio_frames" else None)
    slstm_s, real_slstm = [0.0], model_blocks.slstm_apply

    def timed_slstm(*a, **kw):
        h0 = time.perf_counter()
        out = real_slstm(*a, **kw)
        slstm_s[0] += time.perf_counter() - h0
        return out

    def window(label: str, fn) -> None:
        torch.cuda.synchronize()
        slstm_s[0] = 0.0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            h0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - h0
        by_key, n, total = Counter(), 0, 0.0
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA:
                by_key[evt.key[:48]] += evt.self_device_time_total
                n += evt.count
                total += evt.self_device_time_total
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy, end = 0.0, float("-inf")
        for lo, hi in spans:
            busy += max(0.0, hi - max(lo, end))
            end = max(end, hi)
        top = ", ".join(f"{k} {v / total:.1%}" for k, v in by_key.most_common(6))
        host = (f"; host in the sLSTM layers {slstm_s[0] * 1e3:.3f} ms "
                f"({slstm_s[0] / wall:.1%} of wall)" if cfg.family == "ssm" else "")
        print(f"#   profiled {label}: wall {wall * 1e3:.3f} ms, {n} kernel launches, "
              f"kernel time {total / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms (idle "
              f"{1 - busy / 1e6 / wall:.1%}){host}; most time: {top}")

    def prefill():
        state["out"] = model.prefill(inputs, cache)

    def decode():
        logits, _, n = state["out"]
        for i in range(steps):
            x = frames[i] if frames else logits[:, -1].argmax(-1, keepdim=True)
            logits, _, _ = model.decode_step(x, cache, n + i)

    model_blocks.slstm_apply = timed_slstm
    with torch.inference_mode():
        window("prefill", prefill)
        window(f"{steps} decode steps", decode)
    model_blocks.slstm_apply = real_slstm
    take_counts()


def model_phase() -> dict:
    """(a), (b) and (c), with the launches of each counted apart; (b)'s
    are the kernels line's ``model_serve`` path."""
    t0 = time.perf_counter()
    for name, layers in MODEL_CHECKS:
        model_check(name, layers)
        free()
    served, counts = {}, Counter()
    for name in SERVE_MODELS:
        served[name] = model_serve(name)
        counts += served[name]["counts"]
        free()
    launcher_on_card()
    free()
    print(f"# model phase: {time.perf_counter() - t0:.1f} s (host clock)")
    return dict(counts=counts, served=served)


# ------------------------------------------------------ the model zoo (10d)
# The seven architectures phase 10 does not serve, through the same entry
# points.  (a) card against CPU at full width in f32, the launches exact:
# xLSTM at 8 layers (2 groups), Gemma3 at 6 (5 local layers and its global
# one) with its window cut to 64 so that the 96-position prompt crosses
# it, the others at 2 (DeepSeek-V2-236B: its dense layer and one MoE
# layer); Pixtral's prompt is its 256 patches and 64 tokens.  xLSTM on the
# rescaled tree (`rescale`), as the CPU tests hold it: at the reference's
# σ (scale/√2 for its twice-stacked leaves at 2 groups) its residual grows
# to ~10², where f32 logits move with any order of summation.
ZOO_CHECKS = (("stablelm-3b", 2, {}), ("qwen2-72b", 2, {}), ("deepseek-v2-236b", 2, {}),
              ("gemma3-27b", 6, {"sliding_window": 64}),
              ("xlstm-350m", 8, {"rescaled": True}),
              ("musicgen-medium", 2, {}), ("pixtral-12b", 2, {}))
ZOO_CHECK_PROMPT = {"pixtral-12b": 320}
ZOO_CHECK_DEFAULT = 96
# (b) each at full width in bf16, batch 4, 1,000-position prompts
# (Gemma3's 2,048, so that its local layers mask; Pixtral's are 256
# patches and 744 tokens), 8 greedy steps (MusicGen: seeded frames); full
# depth but Qwen2-72B (8 of 80 layers) and DeepSeek-V2-236B (4 of 60: its
# dense layer and 3 MoE layers); each model freed before the next; xLSTM's
# and Gemma3's prefill and 2 decode steps profiled, xLSTM's prefill on the
# prompt's first 128 positions (its sLSTM loop launches ~130 kernels a
# position, and the profiler's processing of a 1,000-position prefill's
# 133,478 launches took about as long as the rest of the phase).
ZOO_SERVE = (("xlstm-350m", None, 1000), ("musicgen-medium", None, 1000),
             ("stablelm-3b", None, 1000), ("pixtral-12b", None, 1000),
             ("gemma3-27b", None, 2048), ("qwen2-72b", 8, 1000),
             ("deepseek-v2-236b", 4, 1000))
ZOO_STEPS = 8
ZOO_PROFILED = {"xlstm-350m": 128, "gemma3-27b": None}   # name: prefill positions


def zoo_phase() -> dict:
    """Phase 10d: (a) and (b) of `ZOO_CHECKS` and `ZOO_SERVE`, the
    launches of (a) counted apart; (b)'s are the kernels line's
    ``model_zoo`` path."""
    t0 = time.perf_counter()
    for name, layers, fields in ZOO_CHECKS:
        model_check(name, layers, ZOO_CHECK_PROMPT.get(name, ZOO_CHECK_DEFAULT), **fields)
        free()
    served, counts = {}, Counter()
    for name, layers, prompt_len in ZOO_SERVE:
        served[name] = model_serve(name, layers, prompt_len, ZOO_STEPS,
                                   profile_steps=2 if name in ZOO_PROFILED else 0,
                                   profile_len=ZOO_PROFILED.get(name))
        counts += served[name]["counts"]
        free()
    print(f"# model zoo phase: {time.perf_counter() - t0:.1f} s (host clock)")
    return dict(counts=counts, served=served)


# ----------------------------------------------------------------- training
# (a) one training step in f32 at full width and a small depth, on the card
# and on the CPU from the same f32 masters: Qwen3-14B at 2 layers,
# Zamba2-1.2B at 6 (its shared block runs once).  batch 2, 64 markov
# tokens.  Qwen3 on its init as drawn (the reference's rule); Zamba2 held
# on the tree the CPU tests hold it on (`rescale`), and on its init as
# drawn only reported: there a one-ulp move of the masters moves the CPU's
# own embedding gradient by ~3× GRAD_TOL (the "sensitivity" tree prints
# that move beside the card's deviation), as the reference's init leaves
# the reduced Zamba2 in f32
# (`tests/test_torch_models_hybrid.py::test_zamba2_reference_scale_is_ill_conditioned`).
TRAIN_CHECKS = (("qwen3-14b", 2, "reference"), ("zamba2-1.2b", 6, "rescaled"),
                ("zamba2-1.2b", 6, "sensitivity"))
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 64
TRAIN_LR = 1e-3
# Card against CPU gradients, per leaf: max |Δ| ≤ GRAD_TOL·max(1, max |CPU
# leaf|), and the global norm within GRAD_TOL·max(1, |CPU norm|).  A
# gradient is the forward's saved activations (each held to the CPU within
# MODEL_TOL, the kernels to their plain versions within 2e-4 and 3e-4 per
# call) multiplied into the backward's f32 GEMMs, which cuBLAS and the CPU
# sum in other orders over the 128 tokens and the layers' widths; the
# attention's and the scan's backward are the VJPs of their plain versions
# on both sides.  So a gradient carries the forward's relative error and
# adds the backward's own, as the loss does: GRAD_TOL = MODEL_TOL.  A
# wrong head, chunk, layer or dropped VJP term moves a leaf by O(max).
GRAD_TOL = MODEL_TOL
# Where |g| > 2·GRAD_TOL·max(1, max |leaf|) both sides step by
# lr·(sign(g)·|ĝ|/(|ĝ| + ε) + wd·p) (AdamW's first step), which differ by
# about ε/|ĝ| and a rounding of p: masters within 2⁻²⁰·max(1, |p|) there.
MASTER_TOL = 2.0 ** -20
# The GEMM backward at the serving path's 8 x 5120 x 5120, one tile of each
# decomposition (the bf16 un-split tile takes the TMA feed; f32 the ring).
GEMM_BWD_SHAPE = (8, 5120, 5120)
GEMM_BWD_TILES = (("matmul", TileConfig(8, 128, 128)),
                  ("split-K s4", TileConfig(8, 128, 128, split_k=4)),
                  ("Stream-K g8", TileConfig(8, 128, 128, stream_k=8)))
# (b) bf16 compute, f32 masters: Zamba2-1.2B at full depth through the
# launcher, Qwen3-14B at 2 of 40 layers through build_model, train_init
# and make_train_step.  The launcher's checkpoints and a resumed run are
# phase 12's (b), on the mesh.
TRAIN_ARGS = ("--batch", "4", "--seq", "512", "--steps", "8", "--ckpt-every", "0",
              "--log-every", "1")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 8
QWEN_TRAIN_LAYERS = 2
TRAIN_KERNELS = ("flash_prefill", "mamba_scan", "grouped_matmul")
# The optimizer's bytes a parameter: f32 master, first and second moments
# read and written (24), the bf16 gradient read (2).
OPT_BYTES = 26


class PlainCalls:
    """The plain versions of attention, the scan and the grouped GEMM,
    made to raise on CUDA tensors everywhere but inside the backward of
    their autograd Function (`FlashAttention`, `SSDScan`), where each call
    is the VJP's recompute and is counted; CPU tensors (the (a) step's CPU
    side) take them as they are.  `restore` puts them back."""

    def __init__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in PLAIN_VERSIONS]
        self.backward = {flash_ops.FlashAttention.backward.__code__: "flash_attention",
                         scan_ops.SSDScan.backward.__code__: "mamba_scan"}
        self.recomputes = Counter()
        for m, n, real in self.saved:
            setattr(m, n, self._guard(n, real))

    def _guard(self, name, real):
        def plain(*args, **kw):
            tensors = [a for a in args if torch.is_tensor(a)]
            if all(t.device.type == "cpu" for t in tensors):
                return real(*args, **kw)
            kernel = self.backward.get(sys._getframe(1).f_code)
            if kernel is None:
                raise AssertionError(f"{name} ran on the card outside its VJP")
            self.recomputes[kernel] += 1
            return real(*args, **kw)
        return plain

    def take(self) -> Counter:
        out, self.recomputes = self.recomputes, Counter()
        return out

    def restore(self) -> None:
        for m, n, real in self.saved:
            setattr(m, n, real)


def train_launches(cfg, steps: int, attention: str = "flash_prefill") -> Counter:
    """Kernel launches of ``steps`` training steps: per forward one
    attention launch per attention layer run (on ``attention``: the
    prefill kernel for bf16 compute, the decode route's for f32), one
    chunks-route scan per Mamba layer, no grouped launch (MoE training
    raises on the card); the backward launches none (its VJPs are plain
    recomputes, one per launch, counted by family: `recomputes`)."""
    attn = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers
    mamba = cfg.n_layers if cfg.family == "hybrid" else 0
    return +Counter({attention: attn * steps, "mamba_scan": mamba * steps})


def recomputes(cfg, steps: int) -> Counter:
    """`PlainCalls`' VJP recomputes of ``steps`` steps: one per launch,
    under the family's name whichever attention route the forward took."""
    return train_launches(cfg, steps, "flash_attention")


def check_train_launches(label: str, cfg, steps: int, counts: Counter, routes: dict,
                         recomputed: Counter, attention: str = "flash_prefill") -> None:
    want = train_launches(cfg, steps, attention)
    want_routes = {"decode": 0, "chunks": want["mamba_scan"]}
    if counts != want or routes != want_routes or recomputed != recomputes(cfg, steps):
        raise AssertionError(f"{label}: launches {dict(counts)}, scan routes {routes}, "
                             f"VJP recomputes {dict(recomputed)}; the training path "
                             f"makes {dict(want)}, {want_routes}, one recompute each")


def gemm_backward_cases(gen) -> int:
    """`gemm`'s gradients on the card at GEMM_BWD_SHAPE, bf16 and f32, all
    four layouts, one tile of each decomposition: dA and dB (each one more
    `gemm` at the forward's tile) held to their plain versions, the f32
    products g·op(B)ᵀ and op(A)ᵀ·g cast once, within the GEMM tolerance
    with the backward product's own K (N for dA, M for dB)."""
    M, N, K = GEMM_BWD_SHAPE
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for label, tile in GEMM_BWD_TILES:
            for ta, tb in LAYOUTS:
                a = randn((K, M) if ta else (M, K), gen, dtype).requires_grad_(True)
                b = randn((N, K) if tb else (K, N), gen, dtype,
                          K ** -0.5).requires_grad_(True)
                c = gemm(a, b, ta=ta, tb=tb, tile=tile)
                g = randn(c.shape, gen, dtype)
                da, db = torch.autograd.grad(c, (a, b), g)
                opa = (a.T if ta else a).detach().float()     # (M, K)
                opb = (b.T if tb else b).detach().float()     # (K, N)
                gf = g.float()
                want_a, abs_a = gf @ opb.T, abs_product(g, opb.T)    # dgrad, K = N
                want_b, abs_b = opa.T @ gf, abs_product(opa.T, g)    # wgrad, K = M
                if ta:
                    want_a, abs_a = want_a.T, abs_a.T
                if tb:
                    want_b, abs_b = want_b.T, abs_b.T
                what = f"gemm backward {label} {dtype} ta={ta} tb={tb}"
                check_close(da, want_a.to(dtype), abs_a, f"{what} dA")
                check_close(db, want_b.to(dtype), abs_b, f"{what} dB")
                n += 1
    return n


def leaf_excess(got, want) -> tuple[float, float]:
    """max |got − want| and GRAD_TOL·max(1, max |want|), on ``got``'s
    device."""
    want = want.detach().float().to(got.device)
    return (float((got.detach().float() - want).abs().max()),
            GRAD_TOL * max(1.0, float(want.abs().max())))


def rescale(model, params: dict) -> None:
    """Move each normal matrix leaf of ``params`` from the reference's σ
    (scale/√fan_in, `Spec.fan_in`) to scale/√(input width): the
    better-conditioned tree the CPU tests hold the reduced Zamba2 on
    (`tests/test_torch_models.py:fan_in_rescaled`)."""
    specs = {".".join(map(str, p)): s for p, s in iter_specs(model.specs())}
    for k, p in params.items():
        s = specs[k]
        if s.init == "normal" and len(s.shape) >= 2:
            p.mul_(math.sqrt(max(s.fan_in, 1) / s.shape[-2]))


def one_ulp(params: dict, seed: int) -> dict:
    """``params`` each moved one ulp, up or down at random (seeded)."""
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.nextafter(p, torch.where(torch.rand(p.shape, generator=gen) < 0.5,
                                              -math.inf, math.inf))
            for k, p in params.items()}


def grad_deviation(got: dict, want: dict) -> tuple[float, str]:
    """The worst leaf's max |got − want| / max(1, max |want|), and its name."""
    return max((leaf_excess(got[k], w)[0] / max(1.0, float(w.abs().max())), k)
               for k, w in want.items())


def train_check(name: str, layers: int, plain: PlainCalls, tree: str) -> None:
    """(a): one `make_train_step` step in f32 on the card and on the CPU from
    the same f32 masters (made on the card from a seed and copied),
    ``tree`` "reference" (the init as drawn) or "rescaled" (`rescale`):
    loss, global norm and every leaf's gradient within GRAD_TOL, the
    masters within MASTER_TOL where |g| is above twice its tolerance; the
    kernels' launches and the VJPs' recomputes exact.  ``tree``
    "sensitivity": the init as drawn, where the CPU's own gradient moves
    by more than GRAD_TOL when the masters move one ulp (Zamba2): the
    card's deviation from the CPU is printed beside that move, and the
    loss alone is held to MODEL_TOL."""
    t0 = time.perf_counter()
    cfg = replace(get_arch(name), n_layers=layers)
    card = build_model(cfg, device="cuda", dtype=torch.float32, seed=SEED + 8)
    cpu = build_model(cfg, device="cpu", seed=None)
    opt = AdamW(AdamWConfig(lr=TRAIN_LR, total_steps=8, warmup_steps=1))
    state = train_init(card, opt)
    if tree == "rescaled":
        rescale(card, state.params)
    card.to("meta")   # the step reads the masters alone
    free()
    host_params = {k: p.cpu() for k, p in state.params.items()}
    host = TrainState(host_params, opt.init(host_params), state.step.cpu())
    batch = make_batch(cfg, InputShape("check", TRAIN_CHECK_SEQ, TRAIN_CHECK_BATCH,
                                       "train"), 0, mode="markov")
    grads = {}

    def keep(where):
        def transform(g):
            grads[where] = g
            return g
        return transform

    reset_counts()
    plain.take()
    t1 = time.perf_counter()
    new_card, m_card = make_train_step(card, opt, compute_dtype=torch.float32,
                                       grad_transform=keep("card"))(state, batch)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    routes = dict(mamba_scan_fwd.routes)
    check_train_launches(f"train check {name}", cfg, 1, take_counts(), routes, plain.take(),
                         attention="flash_attention")   # f32: the decode route
    masters = {k: p.clone() for k, p in host.params.items()} if tree == "sensitivity" else None
    new_cpu, m_cpu = make_train_step(cpu, opt, compute_dtype=torch.float32,
                                     grad_transform=keep("cpu"))(host, batch)
    t3 = time.perf_counter()
    loss_err = abs(float(m_card["loss"]) - float(m_cpu["loss"]))
    label = f"train check {name} ({tree} tree)"
    if loss_err > MODEL_TOL * max(1.0, abs(float(m_cpu["loss"]))):
        raise AssertionError(f"{label}: loss {float(m_card['loss'])} on the card, "
                             f"{float(m_cpu['loss'])} on the CPU")
    n = sum(p.numel() for p in state.params.values())
    head = (f"# train check {name} at full width, {layers} of {get_arch(name).n_layers} "
            f"layers, f32, the {tree} tree ({n / 1e9:.3f} B parameters): batch "
            f"{TRAIN_CHECK_BATCH}, {TRAIN_CHECK_SEQ} markov tokens, one step from the same "
            f"masters; loss card {float(m_card['loss']):.6f} CPU {float(m_cpu['loss']):.6f} "
            f"(|Δ| {loss_err:.3g})")
    if tree == "sensitivity":
        dev, at = grad_deviation(grads["card"], grads["cpu"])
        make_train_step(cpu, opt, compute_dtype=torch.float32, grad_transform=keep("ulp"))(
            TrainState(one_ulp(masters, SEED), opt.init(masters), host.step), batch)
        sens, at_s = grad_deviation(grads["ulp"], grads["cpu"])
        print(f"{head}; worst leaf gradient card vs CPU {dev:.3g}·max(1, |CPU|) ({at}); the "
              f"CPU's own gradient with the masters moved one ulp: {sens:.3g}·max(1, |CPU|) "
              f"({at_s}); GRAD_TOL {GRAD_TOL}; {time.perf_counter() - t0:.1f} s (host "
              f"clock)")
        return
    gn_err = abs(float(m_card["gnorm"]) - float(m_cpu["gnorm"]))
    if gn_err > GRAD_TOL * max(1.0, float(m_cpu["gnorm"])):
        raise AssertionError(f"{label}: gradient norm {float(m_card['gnorm'])} on the "
                             f"card, {float(m_cpu['gnorm'])} on the CPU")
    worst, master_err, moved = 0.0, 0.0, 0
    for k, want in grads["cpu"].items():
        err, tol = leaf_excess(grads["card"][k], want)
        if err > tol:
            raise AssertionError(f"{label}: gradient of {k} off the CPU's by {err:.4g} > "
                                 f"{tol:.4g}")
        worst = max(worst, err / tol)
        sure = want.to("cuda").abs() > 2 * tol
        p_card = new_card.params[k][sure]
        p_cpu = new_cpu.params[k].to("cuda")[sure]
        if p_cpu.numel():
            d = (p_card - p_cpu).abs() / torch.clamp(p_cpu.abs(), min=1.0)
            master_err = max(master_err, float(d.max()))
            moved += p_cpu.numel()
        del sure, p_card, p_cpu
    if master_err > MASTER_TOL:
        raise AssertionError(f"{label}: masters off the CPU's by {master_err:.3g}·max(1,|p|) "
                             f"> {MASTER_TOL:.3g}")
    print(f"{head}; gradient norm |Δ| {gn_err:.3g} of {float(m_cpu['gnorm']):.4g}; worst "
          f"leaf gradient at {worst:.3f} of its tolerance (GRAD_TOL {GRAD_TOL}·max(1, "
          f"|CPU|)); masters where |g| > 2·tol ({moved} of {n}) within {master_err:.3g}·"
          f"max(1, |p|) (MASTER_TOL {MASTER_TOL:.3g}); card step {t2 - t1:.1f} s, CPU step "
          f"{t3 - t2:.1f} s, {time.perf_counter() - t0:.1f} s in all (host clock)")


def dense_params(cfg) -> int:
    """Parameters multiplied in a forward: all but the token table (a
    gather), Zamba2's shared block once per application."""
    return Model(cfg, device="meta").param_count() - cfg.vocab_size * cfg.d_model \
        + shared_reapplied(cfg)


def train_bound(cfg, n_params: int) -> dict:
    """Least time (ms) of one training step of TRAIN_BATCH x TRAIN_SEQ tokens:
    the larger of its operations at the bf16 peak (6 per multiplied
    parameter and token, and three times the forward's causal attention)
    and the optimizer's bytes (OPT_BYTES a parameter) at the HBM rate."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * dense_params(cfg) * tokens + 3 * attention_flops(cfg, TRAIN_BATCH,
                                                                 TRAIN_SEQ, 0)
    t, by = bound(OPT_BYTES * n_params, flops, torch.bfloat16)
    return dict(ms=t, by=by, flops=flops, opt_bytes=OPT_BYTES * n_params)


TRAIN_KINDS = (("flash_attention", ("flash_bf16", "flash_f32")),
               ("flash_prefill", ("flash_prefill",)),
               ("ssd state", ("ssd_state_kernel",)), ("ssd carry", ("ssd_carry_kernel",)),
               ("ssd output", ("ssd_output_kernel",)),
               ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "splitKreduce")))
TRAIN_RANGES = ("train: attention VJP", "train: scan VJP", "train: optimizer")


def train_ranges():
    """Wrap the attention and scan backward and the optimizer's update in
    profiler ranges; returns the call that unwraps them."""
    from torch.profiler import record_function

    wrapped = [(flash_ops.FlashAttention, "backward", TRAIN_RANGES[0]),
               (scan_ops.SSDScan, "backward", TRAIN_RANGES[1])]
    saved = [(cls, n, cls.__dict__[n]) for cls, n, _ in wrapped]
    for cls, n, label in wrapped:
        real = cls.__dict__[n].__func__

        def ranged(*a, _real=real, _label=label):
            with record_function(_label):
                return _real(*a)
        setattr(cls, n, staticmethod(ranged))
    real_update = AdamW.update

    def update(self, *a, **kw):
        with record_function(TRAIN_RANGES[2]):
            return real_update(self, *a, **kw)
    AdamW.update = update

    def undo():
        for cls, n, f in saved:
            setattr(cls, n, f)
        AdamW.update = real_update
    return undo


def profile_train_step(label: str, step) -> None:
    """One training step under `torch.profiler`: its wall (host clock to a
    synchronize), kernel launches and time, the device's idle share, and
    kernel time by kind (names) and by range (the VJPs' plain recomputes
    with their backward, the optimizer)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    undo = train_ranges()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - h0
    undo()
    kinds, ranges, n, total = Counter(), Counter(), 0, 0.0
    for evt in prof.key_averages():
        if evt.key in TRAIN_RANGES:   # its kernels are counted by kind below
            if evt.device_type == DeviceType.CPU:
                ranges[evt.key] += evt.device_time_total
            continue
        if evt.device_type != DeviceType.CUDA:
            continue
        kind = next((k for k, pats in TRAIN_KINDS if any(p in evt.key for p in pats)),
                    "elementwise and other")
        kinds[kind] += evt.self_device_time_total
        n += evt.count
        total += evt.self_device_time_total
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name not in TRAIN_RANGES)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    by_kind = ", ".join(f"{k} {v / total:.1%}" for k, v in kinds.most_common())
    by_range = ", ".join(f"{k[7:]} {ranges[k] / 1e3:.3f} ms ({ranges[k] / total:.1%})"
                         for k in TRAIN_RANGES)
    print(f"#   profiled {label} step: wall {wall * 1e3:.3f} ms, {n} kernel launches, "
          f"kernel time {total / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms (idle "
          f"{1 - busy / 1e6 / wall:.1%}); by kind: {by_kind}; by range: {by_range}")


def step_line(label: str, cfg, n_params: int, steps_ms: list, peak: int) -> dict:
    """Print and return (b)'s numbers for one model: the median of steps
    3..8, tokens/s, peak memory and the bound."""
    late = sorted(steps_ms[2:])
    med = late[len(late) // 2]
    bd = train_bound(cfg, n_params)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"#   {label}: step ms {[round(t, 3) for t in steps_ms]}; median of steps 3-"
          f"{len(steps_ms)} {med:.3f} ms, {tokens / med * 1e3:.1f} tokens/s; peak memory "
          f"{peak / 1e9:.2f} GB (max_memory_allocated); bound {bd['ms']:.3f} ms "
          f"({bd['by']}: {bd['flops'] / 1e12:.2f} TFLOP at 989 TFLOP/s, optimizer "
          f"{bd['opt_bytes'] / 1e9:.2f} GB at 3.35 TB/s)")
    return dict(median_ms=med, tokens_per_s=tokens / med * 1e3, peak_gb=peak / 1e9,
                bound_ms=bd["ms"], bound_by=bd["by"])


def timed_steps(marks: list):
    """A `make_train_step` that records CUDA events around every step into
    ``marks``."""
    def make(*a, **kw):
        inner = make_train_step(*a, **kw)

        def step(state, batch):
            start = mark()
            out = inner(state, batch)
            marks.append((start, mark()))
            return out
        return step
    return make


def zamba_train(plain: PlainCalls) -> dict:
    """(b), Zamba2-1.2B at full width and depth through
    `repro_torch.launch.train.main`: 8 steps, launches and recomputes
    exact; step times, peak memory and one profiled step."""
    t0 = time.perf_counter()
    cfg = get_arch(ZAMBA)
    marks: list = []
    train_launcher.make_train_step = timed_steps(marks)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    plain.take()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:   # nothing to resume
        first = train_launcher.main(["--arch", ZAMBA, "--ckpt-dir", tmp, *TRAIN_ARGS])
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    routes = dict(mamba_scan_fwd.routes)
    counts = take_counts()
    check_train_launches("zamba2 training", cfg, TRAIN_STEPS, counts, routes, plain.take())
    steps_ms = [a.elapsed_time(b) for a, b in marks]
    losses = first["losses"]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"zamba2 training: losses {losses}")
    state = first.pop("state")
    n_params = sum(p.numel() for p in state.params.values())
    print(f"# training {ZAMBA} at full width and depth through launch.train, bf16 "
          f"compute, f32 masters ({n_params / 1e9:.3f} B parameters), batch "
          f"{TRAIN_BATCH}, {TRAIN_SEQ} tokens, {TRAIN_STEPS} steps; losses "
          f"{[round(x, 5) for x in losses]}; kernel launches {dict(counts)}, scan routes "
          f"{routes}, every plain version raising outside its VJP")
    res = step_line(ZAMBA, cfg, n_params, steps_ms, peak)
    train_launcher.make_train_step = make_train_step
    model = build_model(cfg, device="meta", seed=None)   # the step reads the masters
    step_fn = make_train_step(model, AdamW(AdamWConfig(total_steps=TRAIN_STEPS)))
    batch = make_batch(cfg, InputShape("t", TRAIN_SEQ, TRAIN_BATCH, "train"), TRAIN_STEPS)
    t2 = time.perf_counter()
    profile_train_step(ZAMBA, lambda: step_fn(state, batch))
    plain.take()
    take_counts()
    del state, step_fn
    free()
    print(f"#   {ZAMBA} training: {time.perf_counter() - t0:.1f} s (host clock): the "
          f"launcher run {t_first:.1f} s (model, masters, host snapshot and steps), the "
          f"profiled step {time.perf_counter() - t2:.1f} s")
    return dict(counts=counts, **res)


def qwen_train(plain: PlainCalls) -> dict:
    """(b), Qwen3-14B at full width, 2 of 40 layers, through `build_model`
    (bf16 weights: the masters are their f32 copies), `train_init` and
    `make_train_step`: 8 steps on markov batches, bf16 compute."""
    t0 = time.perf_counter()
    cfg = replace(get_arch("qwen3-14b"), n_layers=QWEN_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=SEED + 9)
    opt = AdamW(AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS, warmup_steps=2))
    state = train_init(model, opt)
    model.to("meta")   # the step reads the masters alone
    free()
    marks: list = []
    step_fn = timed_steps(marks)(model, opt)
    shape = InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    reset_counts()
    plain.take()
    losses, gnorms = [], []
    for i in range(TRAIN_STEPS):
        state, metrics = step_fn(state, make_batch(cfg, shape, i, mode="markov"))
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["gnorm"]))
    peak = torch.cuda.max_memory_allocated()
    routes = dict(mamba_scan_fwd.routes)
    counts = take_counts()
    check_train_launches("qwen3 training", cfg, TRAIN_STEPS, counts, routes, plain.take())
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"qwen3 training: losses {losses}, gradient norms {gnorms}")
    n_params = sum(p.numel() for p in state.params.values())
    print(f"# training qwen3-14b at full width, {QWEN_TRAIN_LAYERS} of 40 layers, bf16 "
          f"compute, f32 masters ({n_params / 1e9:.3f} B parameters), batch {TRAIN_BATCH}, "
          f"{TRAIN_SEQ} markov tokens, {TRAIN_STEPS} steps: losses "
          f"{[round(x, 5) for x in losses]}, gradient norms {[round(x, 4) for x in gnorms]}; "
          f"kernel launches {dict(counts)}, every plain version raising outside its VJP")
    res = step_line("qwen3-14b", cfg, n_params, [a.elapsed_time(b) for a, b in marks], peak)
    batch = make_batch(cfg, shape, TRAIN_STEPS, mode="markov")
    profile_train_step("qwen3-14b", lambda: step_fn(state, batch))
    plain.take()
    take_counts()
    del state, step_fn
    free()
    print(f"#   qwen3-14b training: {time.perf_counter() - t0:.1f} s (host clock)")
    return dict(counts=counts, **res)


def training_phase() -> dict:
    """(a) and (b), with the plain versions raising outside their VJPs for
    the whole phase; (b)'s launches are the kernels line's ``train`` path."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    reset_counts()
    print(f"# gemm backward: {gemm_backward_cases(gen)} cases at "
          f"{'x'.join(map(str, GEMM_BWD_SHAPE))} (bf16 and f32, four layouts, "
          f"{', '.join(lbl for lbl, _ in GEMM_BWD_TILES)}) agree with their plain "
          f"versions; kernel launches (not in the kernels line) {dict(take_counts())}")
    free()
    plain = PlainCalls()
    for name, layers, tree in TRAIN_CHECKS:
        train_check(name, layers, plain, tree)
        free()
    zamba = zamba_train(plain)
    qwen = qwen_train(plain)
    plain.restore()
    print(f"# training phase: {time.perf_counter() - t0:.1f} s (host clock)")
    return dict(counts=zamba["counts"] + qwen["counts"], zamba=zamba, qwen=qwen)


# ---------------------------------------------------------- distribution
# (a) remat: one step without and one with, from the same state, on the
# training phase's shapes; ZAMBA at full depth under "full", Qwen3-14B at
# QWEN_TRAIN_LAYERS under "dots" (the hybrid family honours "full" only).
REMAT_RUNS = ((ZAMBA, None, "full"), ("qwen3-14b", QWEN_TRAIN_LAYERS, "dots"))
# Remat against no remat, per leaf: the recompute repeats the forward's
# kernels on the same values, so the forward's saved activations are the
# same bits; only a reduction whose order is not fixed (an atomic add)
# could round otherwise, by ulps of the leaf: within 2⁻²⁰·max(1, max |g|).
REMAT_TOL = 2.0 ** -20
# (b) the launcher on the mesh: ZAMBA at DIST_LAYERS, 4 steps, checkpoints
# at 2 and 4, then the step-4 checkpoint removed and the run resumed at 2
# (with no checkpoint of its own), repeating steps 3 and 4.
DIST_ARGS = ("--batch", "4", "--seq", "512", "--steps", "4", "--log-every", "1",
             "--compress-grads")
# ZAMBA's depth in (b): 12 of 38 layers (its shared block twice), cut for the
# script's time (the full depth's two 19.2 GB checkpoints and their read
# were most of (b)), through the launcher's own `get_arch`.
DIST_LAYERS = 12
DIST_STEPS, DIST_RESUME = 4, 2
# (c) a runtime derated to a (1, 4) mesh's per-shard budget serving
# Qwen3-14B's decode GEMM bundles (batches per tenant) on DERATED_LAYERS.
DERATED_MESH = MeshShape(data=1, model=4)
DERATED_BATCHES, DERATED_LAYERS = [4, 8, 8, 16], 4


def fresh(state: TrainState, masters: dict) -> TrainState:
    """``state`` put back to step 0 on ``masters`` (zero moments), in place."""
    for k, p in state.params.items():
        p.copy_(masters[k])
        state.opt.mu[k].zero_()
        state.opt.nu[k].zero_()
    state.opt.step.zero_()
    state.step.zero_()
    return state


def remat_run(name: str, layers, remat: str, plain: PlainCalls) -> Counter:
    """(a) for one model: bf16-compute steps without and with ``remat``, each
    from the same fresh state, twice in turns (the second pair timed):
    losses bitwise, gradients within REMAT_TOL, peak memory, step ms and
    launches (the forward's kernels again in the recompute; one VJP
    recompute each)."""
    t0 = time.perf_counter()
    cfg = get_arch(name) if layers is None else replace(get_arch(name), n_layers=layers)
    model = build_model(cfg, device="cuda", dtype=torch.float32, seed=SEED + 11)
    opt = AdamW(AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS, warmup_steps=2))
    state = train_init(model, opt)
    model.to("meta")
    masters = {k: p.clone() for k, p in state.params.items()}
    free()
    batch = make_batch(cfg, InputShape("t", TRAIN_SEQ, TRAIN_BATCH, "train"), 0)
    runs, total = {}, Counter()
    held = []     # memory allocated when the forward returns: what the backward holds
    real_forward = train_loop._Loss.forward

    def forward(self, b):
        out = real_forward(self, b)
        held.append(torch.cuda.memory_allocated())
        return out
    train_loop._Loss.forward = forward
    for turn in range(2):
        for r in ("none", remat):
            grads = {}

            def keep(g):
                grads.update(g)
                return g
            step = make_train_step(Model(cfg, device="meta", remat=r), opt,
                                   grad_transform=keep)
            fresh(state, masters)
            grads.clear()
            held.clear()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            plain.take()
            a = mark()
            _, metrics = step(state, batch)
            b = mark()
            torch.cuda.synchronize()
            routes = dict(mamba_scan_fwd.routes)
            counts, recomputed = take_counts(), plain.take()
            total += counts
            again = 2 if r != "none" else 1
            want = train_launches(cfg, 1)
            want_counts = Counter({k: n * again for k, n in want.items()})
            if (counts != want_counts or recomputed != recomputes(cfg, 1)
                    or routes != {"decode": 0, "chunks": want_counts["mamba_scan"]}):
                raise AssertionError(f"{name} remat={r}: launches {dict(counts)}, routes "
                                     f"{routes}, VJP recomputes {dict(recomputed)}; want "
                                     f"{dict(want_counts)} and one recompute each")
            runs[r] = dict(loss=float(metrics["loss"]), ms=a.elapsed_time(b),
                           peak=torch.cuda.max_memory_allocated(), base=base,
                           held=held[0] - base, counts=dict(counts))
            if turn:   # kept on the host: every step starts from the same bytes
                runs[r]["grads"] = {k: g.cpu() for k, g in grads.items()}
            grads.clear()
        none, rem = runs["none"], runs[remat]
        if not math.isfinite(none["loss"]) or rem["loss"] != none["loss"]:
            raise AssertionError(f"{name}: loss {none['loss']} without remat, "
                                 f"{rem['loss']} with remat={remat}")
        if turn == 0:
            first = dict(runs)
    train_loop._Loss.forward = real_forward
    worst, exact = 0.0, 0
    for k, g in none["grads"].items():
        if torch.equal(rem["grads"][k], g):
            exact += 1
            continue
        d = float((rem["grads"][k].float() - g.float()).abs().max())
        if d > REMAT_TOL * max(1.0, float(g.float().abs().max())):
            raise AssertionError(f"{name} remat={remat}: gradient {k} moved by {d:.3g}")
        worst = max(worst, d)
    print(f"# remat={remat} on {name} at full width, {cfg.n_layers} layers, bf16 compute, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}: loss {none['loss']:.6f} with and without "
          f"(bitwise); gradients {exact} of {len(none['grads'])} leaves bitwise, largest "
          f"|Δ| {worst:.3g}; held for the backward when the forward returns "
          f"{none['held'] / 1e9:.3f} GB without, {rem['held'] / 1e9:.3f} GB with; "
          f"peak memory {none['peak'] / 1e9:.3f} GB without, "
          f"{rem['peak'] / 1e9:.3f} GB with (the step's own above the state's "
          f"{none['base'] / 1e9:.3f} GB: {(none['peak'] - none['base']) / 1e9:.3f} and "
          f"{(rem['peak'] - rem['base']) / 1e9:.3f}); step ms {none['ms']:.3f} without, "
          f"{rem['ms']:.3f} with ({rem['ms'] / none['ms']:.3f}x; first turn "
          f"{first['none']['ms']:.3f} and {first[remat]['ms']:.3f}); launches "
          f"{none['counts']} without, {rem['counts']} with")
    # "full" drops every layer's activations; "dots" keeps the matmul
    # outputs, so it holds less at the forward's end but may leave the peak
    # where it was when the peak is the head's (Qwen3 at 2 layers).
    lower = rem["held"] < none["held"] and (
        rem["peak"] < none["peak"] if remat == "full" else rem["peak"] <= none["peak"])
    if not lower or rem["base"] != none["base"]:
        raise AssertionError(f"{name}: remat={remat} held {rem['held']}, peak "
                             f"{rem['peak']} from {rem['base']}; without {none['held']}, "
                             f"{none['peak']} from {none['base']}")
    del state, masters, runs, none, rem
    free()
    print(f"#   {name} remat: {time.perf_counter() - t0:.1f} s (host clock)")
    return total


def dist_launcher(plain: PlainCalls, ckpt_dir: str) -> Counter:
    """(b): `repro_torch.launch.train.main` with ``--mesh Nx1
    --compress-grads`` on NCCL, one rank per card (N = 1 here: this
    process), then resumed at DIST_RESUME: losses, masters and
    error-feedback buffers bitwise; optimizer bytes per rank."""
    t0 = time.perf_counter()
    cfg = replace(get_arch(ZAMBA), n_layers=DIST_LAYERS)
    train_launcher.get_arch = lambda name: replace(get_arch(name), n_layers=DIST_LAYERS)
    n = 1
    args = ["--arch", ZAMBA, "--ckpt-dir", ckpt_dir, "--mesh", f"{n}x1", *DIST_ARGS]
    reset_counts()
    plain.take()
    marks: list = []
    train_launcher.make_train_step = timed_steps(marks)
    first = train_launcher.main(args + ["--ckpt-every", str(DIST_RESUME)])
    train_launcher.make_train_step = make_train_step
    steps_ms = [a.elapsed_time(b) for a, b in marks]
    routes = dict(mamba_scan_fwd.routes)
    counts = take_counts()
    check_train_launches("launcher on the mesh", cfg, DIST_STEPS, counts, routes,
                         plain.take())
    params = {k: p.cpu() for k, p in first["state"].params.items()}
    ef = {k: e.cpu() for k, e in first.pop("ef").items()}
    del first["state"]
    free()
    saved = ckpt.all_steps(ckpt_dir)
    shutil.rmtree(Path(ckpt_dir) / f"{ckpt.STEP_PREFIX}{DIST_STEPS:08d}")
    t1 = time.perf_counter()
    second = train_launcher.main(args + ["--ckpt-every", "0"])
    t_second = time.perf_counter() - t1
    train_launcher.get_arch = get_arch
    routes = dict(mamba_scan_fwd.routes)
    counts2 = take_counts()
    check_train_launches("launcher on the mesh, resumed", cfg, DIST_STEPS - DIST_RESUME,
                         counts2, routes, plain.take())
    same = (second["losses"] == first["losses"][DIST_RESUME:]
            and all(torch.equal(p.cpu(), params[k])
                    for k, p in second["state"].params.items())
            and all(torch.equal(e.cpu(), ef[k]) for k, e in second["ef"].items()))
    if (not same or first["ranks"] != n or second["final_step"] != DIST_STEPS
            or not all(math.isfinite(x) for x in first["losses"])):
        raise AssertionError(f"launcher on the mesh: losses {first['losses']}, resumed "
                             f"{second['losses']}, ranks {first['ranks']}, bitwise {same}")
    print(f"# launch.train --mesh {n}x1 --compress-grads on NCCL: {first['ranks']} rank(s) "
          f"({torch.cuda.device_count()} card(s) here), {ZAMBA} at {DIST_LAYERS} of "
          f"{get_arch(ZAMBA).n_layers} layers, "
          f"{DIST_STEPS} steps, checkpoints {saved}; losses "
          f"{[round(x, 5) for x in first['losses']]}; resumed at step {DIST_RESUME}: "
          f"losses {second['losses']}, masters and error-feedback buffers bitwise the "
          f"uninterrupted run's; optimizer bytes per rank {first['opt_bytes']:,} of "
          f"{first['opt_bytes_total']:,}; step ms {[round(t, 3) for t in steps_ms]} "
          f"(CUDA events; compression and the data-parallel step included); kernel "
          f"launches {dict(counts)} + {dict(counts2)} resumed")
    del second, params, ef
    free()
    print(f"#   launcher on the mesh: {time.perf_counter() - t0:.1f} s (host clock; the "
          f"resumed run {t_second:.1f} s)")
    return counts + counts2


def derated_serving() -> Counter:
    """(c): a runtime derated by `set_mesh` to DERATED_MESH serves Qwen3-14B's
    decode GEMM bundles at full width: every launch's CD within the slot
    budget, every result held to the plain version, no fault."""
    cfg = get_arch("qwen3-14b")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    weights = make_unfused_weights(cfg, DERATED_LAYERS, gen, "cuda")
    rt = Runtime(ConcurrencyController(), RuntimeConfig(window_s=0.0, execute=True),
                 device="cuda")
    res = rt.set_mesh(DERATED_MESH)
    reset_counts()
    w = mixed_window(rt, cfg, weights, DERATED_BATCHES, gen)
    counts = take_counts()
    cds = Counter(ln.plan.cd for ln in w["launch_list"])
    check_healthy(rt, "derated serving")
    if max(cds) > res.slot_budget or rt.available != res.slot_budget:
        raise AssertionError(f"derated serving: CDs {dict(cds)} past the slot budget "
                             f"{res.slot_budget}")
    for kind, name in (("split-K", "splitk_matmul"), ("Stream-K", "stream_k_matmul")):
        planned_n = w["split_k" if kind == "split-K" else "stream_k"]
        if counts[name] != planned_n:
            raise AssertionError(f"derated serving: {counts[name]} {kind} launches for "
                                 f"{planned_n} planned")
    print(f"# derated runtime, set_mesh({DERATED_MESH}): frac {res.frac}, slot budget "
          f"{res.slot_budget}, spec {res.spec.name} (VMEM {res.spec.vmem_bytes:,} B); "
          f"qwen3-14b decode bundles, batches {DERATED_BATCHES}, {DERATED_LAYERS} layers: "
          f"{w['requests']} requests in launches {w['launches']} at CDs {dict(cds)}, "
          f"members {w['members']}, every result within the GEMM tolerance of its plain "
          f"version; kernel launches {dict(counts)}")
    del weights, w
    free()
    return counts


def dist_phase() -> dict:
    """Phase 12: (a) remat, (b) the launcher on the mesh, (c) derating;
    the plain versions raise outside their VJPs for (a) and (b).  The
    three parts' launches are the kernels line's ``dist`` path."""
    t0 = time.perf_counter()
    plain = PlainCalls()
    counts = Counter()
    for name, layers, remat in REMAT_RUNS:
        counts += remat_run(name, layers, remat, plain)
    disk = shutil.disk_usage(_build.BUILD_DIR)
    print(f"# checkpoints under the build directory: {disk.free / 1e9:.1f} GB free")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        counts += dist_launcher(plain, tmp)
    plain.restore()
    counts += derated_serving()
    print(f"# distribution phase: {time.perf_counter() - t0:.1f} s (host clock)")
    return dict(counts=counts)


# ------------------------------------------------------- model axis (13)
# Serving over M ranks of one card (NCCL refuses two ranks on one device:
# the ranks join over gloo, `init_ranks(backend="gloo")`, every tensor on
# the card; gloo moves CUDA tensors itself).  Full width, the depth cut
# to TP_SERVE's layers (Qwen3-14B 8 of 40; DeepSeek-V2-Lite-16B 6 of 27:
# its dense layer and 5 MoE layers), batch 4, 1,000-token prompts (which
# M = 2 and 4 divide, so DeepSeek's prefill takes expert parallelism), 8
# greedy steps, in TP_DTYPE.  The one-rank model, from the same seed, is
# the reference; for DeepSeek its prefill runs the EP path on one rank
# and its steps the capacity path, the choice "auto" makes on the mesh.
TP_WORLDS = (2, 4)
TP_SERVE = (("qwen3-14b", 8), ("deepseek-v2-lite-16b", 6))
TP_BATCH, TP_PROMPT, TP_STEPS = 4, 1000, 8
TP_DTYPE = torch.float32
TP_COLLECTIVE_S = 120    # a hung collective fails instead of stalling
TP_JOIN_S = 600          # the ranks of one world, every model included
# The per-rank kernel rows (bf16, M = 4): Qwen3-14B's prefill attention on
# its 10 query and 2 KV heads of a rank, DeepSeek's MLA prefill on 4 heads,
# and DeepSeek's EP expert up-projection on a rank's 16 experts at the C2
# its prefill gives (cap = ⌈1000·6/4·1.25⌉ = 1875 copies a destination,
# C2 = ⌈4·1875/16·1.5⌉ = 704 rows an expert).
TP_ATTENTION = (("qwen3-14b M4 rank", (4, 10, 2, 1000, 1009, 128, 128, 0)),
                ("deepseek-v2-lite-16b M4 rank", (4, 4, 4, 1000, 1000, 192, 128, 0)))
TP_EP_EXPERTS, TP_EP_C2 = 16, 704


def tp_cfg(name: str, layers: int):
    return replace(get_arch(name), n_layers=layers)


def tp_prompt(cfg, dtype) -> dict:
    return model_prompt(cfg, TP_BATCH, TP_PROMPT, dtype)


@torch.inference_mode()
def tp_one_rank(cfg, dtype) -> dict:
    """The one-rank model's greedy run: the tokens and the prefill's logits
    (on the host).  A MoE model's prefill on the EP path (one rank), its
    steps on the capacity path."""
    model = build_model(cfg, device="cuda", dtype=dtype, seed=SEED)
    batch = {k: v.cuda() for k, v in tp_prompt(cfg, dtype).items()}
    cache = model.init_cache(TP_BATCH, TP_PROMPT + TP_STEPS + 1, dtype)
    model.moe_mode = "ep" if cfg.family == "moe" else "auto"
    logits, cache, n = model.prefill(batch, cache)
    model.moe_mode = "capacity"
    first, out = logits.float().cpu(), []
    for _ in range(TP_STEPS):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
        logits, cache, n = model.decode_step(tok, cache, n)
    res = {"tokens": torch.cat(out, 1).cpu(), "logits": first}
    del model, cache
    free()
    return res


def tp_rank(rank: int, world: int, port: int, out: str, dtype) -> None:
    """One rank of phase 13 (a spawned process): join the group over gloo,
    serve each model of TP_SERVE sharded on the (1, world) mesh through
    `greedy_decode` with the plain versions raising, the launch counts
    zeroed just before and read just after; its results saved to
    ``out``.  A failure raises and exits non-zero."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = init_ranks("cuda", timedelta(seconds=TP_COLLECTIVE_S), backend="gloo",
                        init_method=f"tcp://localhost:{port}", world_size=world,
                        rank=rank)
    mesh = make_debug_mesh(1, world, device=device)
    restore = plain_versions_raise()
    res = {"backend": str(dist.get_backend()), "device": str(device)}
    for name, layers in TP_SERVE:
        cfg = tp_cfg(name, layers)
        free()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, device=device, dtype=dtype, seed=SEED, mesh=mesh)
        attn = model.layers[0].attn
        heads = (attn.wuk.shape[-1] // cfg.qk_nope_head_dim if cfg.attn_type == "mla"
                 else (attn.wq.shape[-1] // cfg.resolved_head_dim,
                       attn.wk.shape[-1] // cfg.resolved_head_dim))
        batch, logits = tp_prompt(cfg, dtype), []
        reset_counts()
        model_moe.paths.clear()
        t0 = time.perf_counter()
        toks = greedy_decode(model, batch, s_max=TP_PROMPT + TP_STEPS + 1, steps=TP_STEPS,
                             cache_dtype=dtype, device=device,
                             on_step=logits.append).cpu()
        wall = time.perf_counter() - t0
        res[name] = {"tokens": toks, "logits": logits[0].float().cpu(),
                     "counts": take_counts(), "paths": dict(model_moe.paths),
                     "heads": heads, "wall_s": wall,
                     "experts": model.layers[-1].moe.wg.shape[0] if cfg.family == "moe"
                     else 0, "peak": torch.cuda.max_memory_allocated()}
        del model
    restore()
    dist.destroy_process_group()
    torch.save(res, out)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tp_spawn(world: int, tmp: str, dtype) -> list:
    """Run `tp_rank` on ``world`` spawned processes; each rank's results.
    Fails if a rank fails or outlives TP_JOIN_S (every rank is stopped)."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    outs = [f"{tmp}/tp{world}-rank{r}.pt" for r in range(world)]
    procs = [ctx.Process(target=tp_rank, args=(r, world, port, outs[r], dtype))
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.perf_counter() + TP_JOIN_S
    for proc in procs:
        proc.join(max(1.0, deadline - time.perf_counter()))
    hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    codes = [proc.exitcode for proc in procs]
    if hung or codes != [0] * world:
        raise AssertionError(f"model axis, M = {world}: exit codes {codes}, ranks {hung} "
                             f"still running after {TP_JOIN_S} s")
    return [torch.load(o, weights_only=False) for o in outs]


def tp_check(name: str, world: int, ranks: list, ref: dict, dtype) -> Counter:
    """Phase 13's checks of one model at one M: every rank's tokens equal
    rank 0's and the one-rank model's; each rank's gathered prefill logits
    within MODEL_TOL of the one-rank logits; the routed paths (a MoE
    prefill on EP, its steps on the capacity path with the experts cut);
    each rank's launches those of its own shard's shapes.  Prints what it
    saw, then raises on any failure.  Returns the launches summed over
    the ranks."""
    cfg = tp_cfg(name, dict(TP_SERVE)[name])
    moe_layers = cfg.n_layers - cfg.first_dense_layers if cfg.family == "moe" else 0
    want_paths = ({"ep": moe_layers, "sharded_capacity": moe_layers * TP_STEPS}
                  if moe_layers else {})
    tol = MODEL_TOL * max(1.0, float(ref["logits"].abs().max()))
    total, errs, faults = Counter(), [], []
    for r, res in enumerate(ranks):
        got = res[name]
        if not torch.equal(got["tokens"], ranks[0][name]["tokens"]):
            faults.append(f"rank {r}'s tokens differ from rank 0's")
        if not torch.equal(got["tokens"], ref["tokens"]):
            diff = (got["tokens"] != ref["tokens"]).nonzero().tolist()
            faults.append(f"rank {r}'s tokens differ from the one-rank model's at "
                          f"(sequence, step) {diff[:8]}")
        errs.append(float((got["logits"] - ref["logits"]).abs().max()))
        if not errs[-1] <= tol:
            faults.append(f"rank {r}'s prefill logits max |Δ| {errs[-1]:.4g} > {tol:.4g}")
        if got["paths"] != want_paths:
            faults.append(f"rank {r}'s routed paths {got['paths']}, want {want_paths}")
        shard = replace(cfg, n_routed_experts=got["experts"]) if moe_layers else cfg
        want, _ = model_launches(shard, TP_STEPS, dtype, TP_PROMPT)
        if got["counts"] != want:
            faults.append(f"rank {r}'s launches {dict(got['counts'])}, its shard makes "
                          f"{dict(want)}")
        total += got["counts"]
    peaks = [round(res[name]["peak"] / 1e9, 2) for res in ranks]
    print(f"# model axis {name} ({cfg.n_layers} of {get_arch(name).n_layers} layers, "
          f"{str(dtype).removeprefix('torch.')}), backend {ranks[0]['backend']}, world "
          f"{world}, mesh (data 1, model {world}), every rank on {ranks[0]['device']}: "
          f"heads a rank {ranks[0][name]['heads']}"
          + (f", experts a rank {ranks[0][name]['experts']}" if moe_layers else "")
          + f"; tokens {'equal' if not faults else 'CHECKED'} on every rank and the "
          f"one-rank model's; prefill logits max |Δ| per rank "
          f"{[f'{e:.3g}' for e in errs]} (bound {tol:.3g}); routed paths "
          f"{ranks[0][name]['paths']}; launches per rank "
          f"{[dict(res[name]['counts']) for res in ranks]}; peak memory per rank "
          f"{peaks} GB; greedy wall per rank "
          f"{[round(res[name]['wall_s'], 2) for res in ranks]} s")
    if faults:
        raise AssertionError(f"model axis {name} M{world}: " + "; ".join(faults))
    return total


def tp_nccl_refused() -> None:
    """Two ranks asking NCCL for the one card: `init_ranks` must refuse
    them, naming the cause, in each process (no collective runs)."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); "
         "from repro_torch.launch.mesh import init_ranks; "
         f"init_ranks('cuda', backend='nccl', init_method='tcp://localhost:{port}', "
         f"world_size=2, rank={r})"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    deadline = time.perf_counter() + TP_COLLECTIVE_S
    while any(proc.poll() is None for proc in procs) and time.perf_counter() < deadline:
        time.sleep(0.5)
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
    outs = [proc.communicate() for proc in procs]
    said = [next((ln for ln in err.splitlines() if "refuses two ranks on one card" in ln),
                 err.strip()[-300:]) for _, err in outs]
    if any(proc.returncode == 0 or "refuses two ranks on one card" not in line
           for proc, line in zip(procs, said)):
        raise AssertionError(f"two NCCL ranks on one card: exit codes "
                             f"{[proc.returncode for proc in procs]}, {said}")
    print(f"# two ranks on one card under NCCL refused by init_ranks: {said[0]}")


def tp_launcher() -> None:
    """``python -m repro_torch.launch.serve --arch qwen3-14b`` as a user runs
    it on one card: a world of one rank on NCCL, the mesh from the ranks,
    the model (full width and depth, f32) built on it."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); import runpy; "
            "runpy.run_module('repro_torch.launch.serve', run_name='__main__', "
            "alter_sys=True)")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code, "--arch", "qwen3-14b"], cwd=ROOT,
                       capture_output=True, text=True)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[serve]")]
    if r.returncode or not lines or "'model': 1" not in lines[0]:
        print(r.stdout[-4000:], r.stderr[-4000:], sep="\n")
        raise AssertionError(f"launch.serve --arch qwen3-14b: exit {r.returncode}")
    print(f"# python -m repro_torch.launch.serve --arch qwen3-14b (world 1, NCCL): "
          f"{lines[0]} ({time.perf_counter() - t0:.1f} s with start-up)")


def tp_kernel_rows(gen) -> dict:
    """The kernels at a rank's shapes (M = 4), each held to its plain
    version and timed beside it and the PyTorch call."""
    rows = {"flash_prefill": [model_attention_row(n, shape, gen)
                              for n, shape in TP_ATTENTION]}
    cfg = get_arch("deepseek-v2-lite-16b")
    w = randn((TP_EP_EXPERTS, cfg.d_model, cfg.moe_d_ff), gen,
              scale=cfg.d_model ** -0.5)
    rows["grouped_matmul"] = [grouped_row("deepseek-v2-lite-16b", "EP rank of 4, prefill",
                                          TP_EP_C2, w, gen)]
    print_rows(rows)
    return rows


def tp_serving(dtype=TP_DTYPE) -> Counter:
    """Phase 13's serving: the one-rank references computed and freed, then
    each M of TP_WORLDS as rank processes sharing the card, checked;
    the ranks' launches, summed."""
    free()
    refs = {name: tp_one_rank(tp_cfg(name, layers), dtype) for name, layers in TP_SERVE}
    counts = Counter()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for world in TP_WORLDS:
            ranks = tp_spawn(world, tmp, dtype)
            for name, _ in TP_SERVE:
                counts += tp_check(name, world, ranks, refs[name], dtype)
    return counts


def model_axis_phase(gen) -> dict:
    """Phase 13: `tp_serving`, the launcher at world 1, the per-rank kernel
    rows.  The ranks' launches are the kernels line's ``model_axis``
    path."""
    t0 = time.perf_counter()
    counts = tp_serving()
    tp_nccl_refused()
    tp_launcher()
    rows = tp_kernel_rows(gen)
    print(f"# model axis phase: {time.perf_counter() - t0:.1f} s (host clock)")
    return dict(counts=counts, rows=rows)


# ------------------------------------------------------------------- main
def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    build_phase()
    print(f"# card-only tests: {card_tests_phase()}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    print(f"# kernels: {small_cases(gen)} small cases agree with their plain versions")
    print(f"# split-K and Stream-K kernels: {split_stream_cases(gen)} small cases "
          "agree with their plain versions")
    print(f"# attention and scan kernels: {attention_scan_cases(gen)} small cases agree "
          "with their plain versions")
    print(f"# expert pools: grouped_for_desc at {pool_bm_cases(gen)} (pool, bm) cases of "
          "DeepSeek-V2-Lite's batch-16 pools agrees with its plain version, with the "
          "ragged_matmul launches ragged_chunks gives")
    rows = main_path_kernels(gen)
    rows["ragged_matmul"] += moe_ragged_rows(gen, default_library())
    rows.update(split_stream_kernels(gen))
    rows.update(attention_scan_kernels(gen, default_library()))
    rows["flash_prefill"] = []      # the models' prefill shapes, from phase 10 on
    torch.cuda.empty_cache()
    prompt = prompt_scan_phase()
    gc.collect()
    torch.cuda.empty_cache()
    serving = serving_phase()
    gc.collect()
    torch.cuda.empty_cache()
    mixed = mixed_phase()
    unfused = mixed.pop("weights")
    self_correction_phase(get_arch("qwen3-14b"), unfused)
    gc.collect()
    torch.cuda.empty_cache()
    slo_phase(get_arch("qwen3-14b"), unfused[:SLO_LAYERS])
    del unfused
    ops = {}
    for name, context in OP_CONFIGS:
        gc.collect()
        torch.cuda.empty_cache()
        ops[name] = op_bundle_phase(name, context, layers=OP_LAYERS.get(name))
    op_counts = {k: sum(o["counts"][k] for o in ops.values())
                 for k in OP_BUNDLE_KERNELS + ("ragged_matmul",)}
    scan_routes = {k: sum(o["scan_routes"][k] for o in ops.values()) + prompt["routes"][k]
                   for k in mamba_scan_fwd.routes}
    missing = [k for k in OP_BUNDLE_KERNELS + ("ragged_matmul",) if op_counts[k] <= 0]
    if missing:
        raise AssertionError(f"the op-bundle path never launched {missing}")
    gc.collect()
    torch.cuda.empty_cache()
    models = model_phase()
    model_counts = models["counts"]
    for name, more in model_kernel_rows(gen).items():
        rows[name] += more
    for served in models["served"].values():
        for k, n in served["routes"].items():
            scan_routes[k] += n
    gc.collect()
    torch.cuda.empty_cache()
    zoo = zoo_phase()
    missing = [k for k in MODEL_KERNELS if zoo["counts"][k] <= 0]
    if missing:
        raise AssertionError(f"the model zoo path never launched {missing}")
    for name, more in zoo_kernel_rows(gen).items():
        rows[name] += more
    for served in zoo["served"].values():
        for k, n in served["routes"].items():
            scan_routes[k] += n
    gc.collect()
    torch.cuda.empty_cache()
    trained = training_phase()
    scan_routes["chunks"] += trained["counts"]["mamba_scan"]
    gc.collect()
    torch.cuda.empty_cache()
    distributed = dist_phase()
    scan_routes["chunks"] += distributed["counts"]["mamba_scan"]
    missing = [k for k in DIST_KERNELS if distributed["counts"][k] <= 0]
    if missing:
        raise AssertionError(f"the distribution path never launched {missing}")
    gc.collect()
    torch.cuda.empty_cache()
    axis = model_axis_phase(gen)
    missing = [k for k in TP_KERNELS if axis["counts"][k] <= 0]
    if missing:
        raise AssertionError(f"the model-axis path never launched {missing}")
    for name, more in axis["rows"].items():
        rows[name] += more
    kernels = []
    for name, replaces in REPLACES:
        r, *more = rows[name]
        by_path = ({"per_class": serving["counts"][name]} if name in PER_CLASS_KERNELS else
                   {"op_bundles": op_counts[name]} if name in OP_BUNDLE_KERNELS else
                   {"mixed": mixed["counts"][name]} if name in MIXED_KERNELS else {})
        if name == "ragged_matmul":
            by_path["op_bundles"] = op_counts[name]
        if name == "mamba_scan":
            by_path["prompt_scans"] = prompt["counts"][name]
        if name in MODEL_KERNELS:
            by_path["model_serve"] = model_counts[name]
            by_path["model_zoo"] = zoo["counts"][name]
        if name in TRAIN_KERNELS:
            by_path["train"] = trained["counts"][name]
        by_path["dist"] = distributed["counts"][name]
        if name in TP_KERNELS:
            by_path["model_axis"] = axis["counts"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": replaces, "shape": r["shape"],
            **({"folded": "the reduce is splitk_matmul's cluster epilogue; the row "
                          "times the whole one-launch GEMM"}
               if replaces.endswith("_reduce_kernel") else {}),
            **({"folded": "the fixup is stream_k_matmul's arrival epilogue; the row "
                          "times the whole one-launch GEMM"}
               if replaces.endswith("_stream_k_fixup_kernel") else {}),
            "instantiation": r.get("instantiation", ""),
            "launches": sum(by_path.values()),
            **({"launches_by_path": by_path} if len(by_path) > 1 else {}),
            **({"launches_by_route": scan_routes,
                "kernel_launches_per_count": {"decode": 1, "chunks": 3}}
               if name == "mamba_scan" else {}),
            **({"scan_route": r["route"]} if "route" in r else {}),
            **({"grid": r["grid"]} if "grid" in r else {}),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            **({"feed": r["feed"], "ring_ms": r["ring_ms"]} if "feed" in r else {}),
            **({"host_us": r["host_us"]} if "host_us" in r else {}),
            **({"more_shapes": [{
                "shape": m["shape"], **({"scan_route": m["route"]} if "route" in m else {}),
                **({"grid": m["grid"]} if "grid" in m else {}),
                **({"feed": m["feed"], "ring_ms": m["ring_ms"]} if "feed" in m else {}),
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound"][0],
                "bound_by": m["bound"][1], "library_ms": m["library_ms"]}
                for m in more]} if more else {}),
        })
    print(f"# chip_smoke: {time.perf_counter() - t_start:.1f} s (host clock, the build "
          "included)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
