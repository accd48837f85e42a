#!/usr/bin/env python3
"""Quickest proof that the PyTorch/H100 port starts and is right on the card.

    python3 chip_smoke.py          # from the root of a checkout, one card

Drives the port (``src/repro_torch``) only; imports nothing of JAX or of the
JAX package.  Phases, in order; any failure exits nonzero and prints no
result:

1. Build every kernel from ``src/repro_torch/csrc`` with nvcc for sm_90a,
   one nvcc per source (six), all started together.
2. ``imc_mac`` against its plain version on the card, bit for bit: the
   demonstrator's shapes M in {4, 16, 64} x (K, N) in {(768, 768),
   (768, 3072), (3072, 768)}, a ragged shape, and the deep-K int32 case;
   then the split-K kernel's cases (M <= 16; M > 16 takes the tensor-core
   kernel, and which counter rose is asserted): M in {1, 3, 4, 5, 9, 16,
   17}, K in {0, 4, 100, 1030, 3072}, N in {1, 31, 129, 768, 3072}, N not a
   multiple of 8 or 4, weights as a view at byte offsets 1 and 4 (the
   narrower loads), operands at -128 and +-127; one launch of each kernel
   captured in a CUDA graph and replayed twice (the memset of the split
   kernel's output is a node of the graph), also at (32, 768, 3072) and
   (64, 3072, 768); then the tensor-core kernel's cases (M > 16: M in {17,
   31, 32, 33, 48, 64, 65, 130, 512}, K in {0, 4, 140, 1030}, N in {12, 31,
   129, 150}, byte offsets 1 and 4, the same fills, and the prefill
   shapes); the C ``imc_mac_plan`` equal to ``ops.imc_mac_plan`` at every
   shape; and the SASS of ``imc_mac_mma_kernel`` holds ``IMMA`` and no
   ``IDP`` (dp4a), read with ``cuobjdump``.
   b. ``imc_mac_dequant`` (the same GEMM with the float32 dequant in its
      flush) against its plain version, bit for bit: the same demonstrator
      shapes, ragged 130x140x150, deep K 8x2048x8 at +-127, and the same
      split-K and tensor-core cases, graph replays and plans.
3. ``paged_attn`` against its plain version on the card: f32, bf16 and int8
   pools, window 0 and 16, rep 1 (the demonstrator) and rep 8 (qwen2.5-3b)
   on the split kernel, hd 24 on the staged kernel, rep 16 at hd 256
   (recurrentgemma-9b) on the context-split kernel and its merge over bf16
   and int8 pools (f32: the staged one), at positions 0/63/64/127/3
   (chunk edges) and 2100/700/64/0 under windows 0 and 2048 (which kernels
   ran is asserted by counter; int8 there within one bf16 ulp of the
   largest |out|, or of a float64 witness where the plain version's bf16
   roundings part it farther, as phase 9's cases), positions 5/47/100 and
   0/15/16/127 (at pos 0, and at 127 under the window, whole warps of the
   split kernel see no key), sentinel blocks and an inactive slot that
   must flush zeros; bounds f32 5e-6, bf16 1.6e-2 (one output ulp), int8
   1e-2.  int8 at hd 24 is not in the
   case list: the 1e-2 bound is below one bf16 output ulp at |out| >= 2,
   where a kernel that keeps K, V and P in f32 can land one ulp from the
   plain version, which rounds them to bf16 (``--int8-witness`` below);
   ``tests/test_torch_cuda.py`` holds that geometry.
4. ``bitplane_mac`` against its plain version on the card, bit for bit,
   one launch per call, which of its three kernels ran asserted each time
   by counter (the wrapper counts the kernel the C launcher reports it
   launched, held against the Python twin of the rule): the demonstrator's shapes at M in {4, 64}; the served case
   (rows 8, 8x8 bits: the r8 kernel at M <= 8, the tensor-core kernel
   above) at every M in {1, 3, 4, 5, 9, 64}, K in {8, 100, 1030, 3072} and
   N in {1, 31, 129, 768} and on all-255 operands; a ragged shape; the
   generic kernel at bits 4x8, 6x6, 3x5 and rows 16; detuned (2x2 and 8x8
   bits) and random (8x8) ``thr``, equal to the plain version and
   different from the calibrated result; then the tensor-core kernel at M
   in {16, 17, 32, 33, 64, 65, 512} (``MMA_SHAPES``) under the calibrated,
   the detuned and a random table, on random and all-255 operands, and its
   C ``bitplane_mma_plan`` equal to ``ops.bitplane_mma_plan``.
   b. ``bitplane_mac_noisy`` against its plain version on the card, bit for
      bit (both draw one Philox stream with the same float32 arithmetic):
      the demonstrator's shapes at M in {4, 64}, ragged 33x1030x129, bits
      4x8, rows 16, mismatch only, comparator only and both at the stress
      sigmas (0.3, 0.03), the calibrated sigma, a detuned ``thr``;
      ``NoiseSpec(0, 0)`` equal to ``bitplane_mac``; the same seed twice
      identical, the second time as a seed-table row in device memory (a
      seed is always read by the kernel from device memory: an integer is
      copied there first); two seeds different.  Then cases chosen against the
      kernel's skip (it draws only where a draw can change the decode):
      dense operands (every count is ``rows``: nothing is free) and zero
      ones (everything is), thresholds a hair inside and outside a count's
      band (linear and triode regime, mismatch and comparator offset),
      mismatch 1.0, rows 16 and 3, each also at M 9-64.  Then the
      tensor-core kernel (rows 8, 8x8 bits, M >= 9, ``NOISY_MMA_CASES``): M
      in {9, 17, 33, 41, 47, 64, 65, 100, 512}, K with a partial group and
      a partial k-step, calibrated, stress, mismatch-only and
      comparator-only sigmas, a detuned ``thr``, dense operands.  On every call of 4b the launcher's
      report (``bitplane_mac_noisy.mma_launches``) must name the kernel
      that ``ops.bitplane_noisy_kernel`` names.
   c. ``rbl_decode_mac`` (one {0,1} plane pair, decode against live
      thresholds) against its plain version, bit for bit, under calibrated
      and detuned thresholds: one plane pair of each demonstrator projection
      at M in {4, 64}, ragged 50x70x30, rows 16 at 24x160x8 and 64x768x768;
      then its edge cases, each call one launch, under calibrated, detuned
      and random thresholds: rows in {2, 3, 7, 8, 9, 16, 31, 32}, M in {1,
      4, 5, 16, 17, 64, 200}, N in {1, 31, 129, 3072}, K in {3, 8, 100,
      1030, 3072}, operands as views at byte offsets 1 and 4 holding bytes
      0-255 (the plain version gets ``x & 1``).  Calibrated, it equals the
      integer product; detuned, it differs.  The C ``rbl_decode_mac_plan``
      equals ``ops.rbl_decode_mac_plan`` at every edge case; one launch
      captured in a CUDA graph and replayed twice stays bit-exact; its SASS
      holds ``PRMT`` and no ``POPC`` (``cuobjdump``).
5. ``flash_attn`` against its plain version on the card: f32 and bf16,
   window 0 and 16, rep 1 and 8 at hd 64 and 128, rep 2 at hd 32 and 24,
   rep 16 at hd 256, S in {1, 15, 16, 17, 40, 64, 100}; bf16 at hd 32-128
   and 256 must take the tensor-core kernel (two warps a 16-row group at
   hd 256), f32 and hd 24 the CUDA-core kernel; bounds f32 3e-6, bf16 2e-2.
6. The served paths, each on full-width ``imc-paper-110m`` (random weights
   from a fixed seed), 4 slots, paged KV, block 16, buckets (16, 32, 64),
   six requests of 7/16/33/12/5/40 prompt tokens and 16 new tokens each,
   through the ``Engine``.  Each path is served four times, in turns:
   through ``Engine(graphs=False)`` (eager steps, the oracle), through an
   ``Engine`` whose steps are CUDA graphs, through that one again and
   through the eager one again; every kernel's launch counter is zeroed
   just before each serve and read just after, and TTFT and TPOT p50/p95
   and decode tokens/s are logged for each.  The four token streams must
   be equal (noisy ones under one ``noise_seed`` too); the graph engine
   captures one prefill and one admission graph per bucket used and one
   decode graph (5), and none on its second serve, whose launches (counted
   from replays: the engine adds each graph's captured launches to the
   wrappers' counters on every replay) must equal the eager serve's.  A
   ``fail_at=(1,)`` drill through the graph engine recovers once with no
   capture and serves the streams of the run without a fault (noisy: of
   the same drill through the eager engine).  One decode step and one
   bucket-16 prefill are then replayed from the graph engine's graphs
   under ``torch.profiler``, and their launches counted (the per-step gates
   below): the port's kernels the device ran, counted by their names in
   the trace, must equal what the captures recorded, so a kernel missing
   from a graph or in it twice fails; the replayed prefill's logits must
   equal the eager prefill's bit for bit:
   a. ``exact`` fabric: ``imc_mac`` and ``paged_attn`` must launch;
      ``imc_mac``'s split-K kernel 72 times per decode step and its M > 16
      tensor-core kernel never there; a bucket-32 and a bucket-64 prefill
      each launch the tensor-core kernel 72 times and the split-K one never.
      The first request's prefill logits on the card are held against the
      same weights run through the plain path on the CPU (bound: 2e-2 of
      the largest |logit|).
   b. the paper's ``sim`` fabric with flash prefill: ``bitplane_mac``,
      ``flash_attn`` and ``paged_attn`` must launch, ``imc_mac`` never;
      ``bitplane_mac``'s tensor-core kernel 72 times per prefill (the
      replayed bucket-16 and bucket-64 graphs, counted on the device, and
      eager bucket-32 and bucket-64 prefills) and never in a decode step,
      whose 72 launches are the r8 kernel's;
      the tensor-core ``flash_attn`` kernel 12 times per bucketed prefill
      and the split ``paged_attn`` kernel 12 times per decode step, the
      CUDA-core flash and staged paged kernels never (on any served path:
      recurrentgemma's rep 16 takes the context-split one in phase 10).
      On the card, ``sim`` prefill logits (flash off) must equal ``exact``'s
      bit for bit.  ``sim`` + flash must lie within 2e-2 of the largest
      |logit| of the plain path on the CPU with flash attention, and give
      ``exact``'s top-1; its distance from ``exact`` (dense attention) is
      printed beside the plain path's own flash-vs-dense distance.
   c. ``sim`` with the paper-calibrated noise (``NoiseSpec.calibrated()``,
      device mismatch 0.05) and flash prefill: ``bitplane_mac_noisy``
      (72 launches per decode step, all of its 8-row-tile kernel, and 72 per
      prefill, all of its tensor-core kernel: the replayed bucket-16 and
      bucket-64 graphs, counted on the device, and eager bucket-32 and -64
      prefills, as the launcher reports them against the twin),
      ``flash_attn`` and ``paged_attn`` must launch, ``bitplane_mac`` and
      ``imc_mac`` never.  The graphs read
      each step's noise seeds from a seed table in device memory, written
      before each replay, so the four serves' streams are equal.  The first
      request's prefill logits at the stress sigmas under two seeds must
      differ from each other and from noise-free ``sim``; their relative L2
      distance from it is printed beside the calibrated one.
   d. The paper's macro path, on the card: Table I voltages and codes,
      ``write_row``/``mac``/``read_bit``/``logic2`` on one 8x8 array (equal
      to the CPU's); ``Fabric.logic_word`` (six ops) and ``add_nbit`` on
      2^22 random uint8 pairs in ``exact`` and ``sim`` (equal to the
      bitwise operators and to (a+b) mod 256 with its carry); under
      mismatch sigma 0.5 one seed replays and two differ (flip rate
      printed); ``Fabric.matmul`` at 64x768x3072 launches ``imc_mac``
      (``exact``, its tensor-core kernel) or ``bitplane_mac`` (``sim``) once
      and nothing else; ``imc_mac_dequant`` on its quantized operands equals
      ``Fabric(exact).matmul`` bit for bit, there (tensor-core kernel) and on
      four of its rows (split-K kernel); the threshold re-tuning study
      of §IV-C through ``rbl_decode_mac`` on the sign planes of that
      projection (share of wrong outputs per threshold shift); the STE
      gradients of ``Fabric.linear`` equal the CPU's within 1e-5 relative;
      ``Fabric.cost`` equals the CPU's; ``python -m repro_torch.quickstart``
      exits 0.  ``imc_mac_dequant`` and ``rbl_decode_mac`` must launch here
      and on no served path.
   e. ``qwen2.5-3b`` at full width (d_model 2048, GQA 16 heads over 2 KV
      heads at hd 128, SwiGLU, QKV bias, tied embeddings), its depth cut to
      2 of 36 (``FAMILY_LAYERS``), random weights from seed 0, served by
      ``serve_family`` as 9a serves its configs, in ``exact`` and in
      ``sim`` with flash prefill: the same turns, captures and drill; 14
      split-K ``imc_mac`` (or ``bitplane_mac``) and 2 split ``paged_attn``
      launches per decode step, 14 tensor-core ``imc_mac`` per bucket-32/64
      prefill, 2 tensor-core ``flash_attn`` launches per prefill; ``sim``
      prefill logits equal to ``exact``'s; card logits within 2e-2 of the
      largest |logit| of the CPU's plain path (with flash attention for
      ``sim`` + flash), end to end and layer by layer.
7. Each kernel timed at the main path's shapes (CUDA events), beside its
   bound on an H100 SXM (3.35 TB/s, 1979 TOP/s int8, 989 TFLOP/s bf16; for
   ``bitplane_mac_noisy`` one Philox4x32-10 for every element a draw can
   change, at 64 integer operations per SM per clock, and apart from it a
   hardware Box-Muller's floor on the special-function units, 16 results
   per SM per clock at 1.98 GHz, which the bit-exact stream cannot reach),
   its plain version and one library call computing the same function
   (none computes the noisy pyramid: the noise-free ``bitplane_mac`` time
   stands beside it for context).  ``bitplane_mac_noisy`` is timed at the
   calibrated and the stress sigmas, on uniform and on dense (all-255)
   operands, each row with the share of elements per tier of its skip.  The two macro
   kernels are timed on one decode step's 72 projections at M = 4
   (``rbl_decode_mac`` as one plane pair of each); their library calls are
   ``torch._int_mm`` (plus the two scale multiplies for the dequant).
   ``rbl_decode_mac`` adds its users' row: phase 6d's threshold sweep, five
   calls on the sign planes of one quantized 64x768x3072 projection, beside
   ``torch._int_mm`` at M = 64.
   ``imc_mac`` adds rows for one bucket-64 and one bucket-32 prefill's 72
   projections (M = 64 and 32, on the tensor-core kernel) beside
   ``torch._int_mm``, and ``imc_mac_dequant`` one for a bucket-64 prefill;
   ``bitplane_mac`` rows for one bucket-16, -32 and -64 prefill's 72
   projections and one training forward's (M = 512), its tensor-core
   kernel, each also from a graph under the detuned table and with the
   decode bound of its group counts (one integer instruction a count at 64
   an SM a clock) beside the int8 bound, one (768, 3072) projection of the
   bucket-64 prefill and of the training forward beside its plain version
   (the first is the ``bitplane_mac_mma`` entry of the ``kernels`` line),
   and ``bitplane_mac_noisy`` rows for a bucket-16, -32 and -64 prefill
   and the training forward (its tensor-core kernel), from graphs, beside
   their bounds and the noise-free ``bitplane_mac``'s graph time, and one
   (768, 3072) projection of the bucket-64 prefill beside its plain
   version (the ``bitplane_mac_noisy_mma`` entry of the ``kernels`` line);
   the bucket-64 ``imc_mac`` row is also timed over one layer's weights
   alone (7.1 MB, resident in L2), the kernels without device-memory
   traffic.
   ``ms`` times the wrappers' launches as a caller makes them (a host-bound
   loop measures the host); ``graph_ms`` times the same launches replayed
   from one CUDA graph, the device's own time, and ``library_graph_ms`` does
   the same for every library yardstick (``torch._int_mm``, the dequant's
   three calls, SDPA).  The attention rows add ``floor_graph_ms``, 12
   one-element launches from a graph.

8. The training path (``repro_torch.launch.train.train``, one ``Engine``;
   the launch counters zeroed just before each run and read just after,
   every kernel's plain version counted too):
   a. ``exact``: full imc-paper-110m, batch 4 x seq 512, lr 1e-3, remat on,
      8 steps, ``ckpt_every=2``; then a ``fail_at={5}`` drill, resumed by a
      second call on its checkpoints, whose final params and optimizer
      state must equal the uninterrupted run's bit for bit; 144
      tensor-core ``imc_mac`` launches a step (72 projections, each layer's
      forward run again by remat in the backward) and nothing else; step
      time p50, train tokens/s and peak device memory printed.  Descent: a
      held batch's loss must fall over 16 steps at warmup 4 (read beside
      it along train()'s own 8-step schedule); one step profiled; the
      kernels that the deterministic-algorithms mode swaps are named.
   b. ``sim`` and noisy ``sim`` (``NoiseSpec.calibrated()``), full width, 2
      layers, batch 4 x seq 128, 3 steps each: 24 ``bitplane_mac`` (all
      on its tensor-core kernel, M = 512) / ``bitplane_mac_noisy`` (all on
      its tensor-core kernel) launches a step; noisy, one step seed twice
      gives the same loss and gradients bit for bit, another step's seed
      another loss.
   c. The card against the CPU's plain path, same params and batch, 2
      layers at full width: ``exact`` at seq 128 and noise-free ``sim`` at
      seq 16, step 0's loss within 1e-3 and each gradient leaf within 5e-2
      relative L2; with the model's bf16 params each leaf's distance from a
      float64 witness on the CPU at most 1.5x the CPU's own (the two
      devices round bf16 apart, neither less precisely); ``exact`` with the
      same params in float32 within 1e-3; on the card ``sim`` equals
      ``exact`` bit for bit at seq 128.
   d. The three kernels at the training shapes against their plain
      versions, bit for bit: ``imc_mac`` at M = 2048 and 2047,
      ``bitplane_mac`` (its tensor-core kernel, by counter) and
      ``bitplane_mac_noisy`` (a seed-table row; its tensor-core kernel, by
      counter) at M = 512.
   Phase 7 adds the training shapes: ``imc_mac`` over one training
   forward's 72 projections at M = 2048 (beside ``torch._int_mm``), and
   ``bitplane_mac`` at M = 512 (with its prefill rows, below).

9. The seven attention-only families (``FAMILY_LAYERS``), each at full
   width, its depth cut to its pattern period and at least 2 layers
   (gemma3-12b 6, the others 2), random weights from seed 0, ``exact``
   fabric unless noted.  Before it, phases 3 and 5 at their geometries:
   ``paged_attn`` at rep 2, 4, 6 and 7, hd 128 and 256, over bf16, f32
   and int8 pools, windows 0, 1024 and 4096, positions 5/1100/4200 and an
   empty table; ``flash_attn`` at hd 256 (the tensor-core kernel asserted
   for bf16) and rep 6 and 7, S up to 100 (and 1100 under window 1024).
   a. gemma3-12b, deepseek-coder-33b, qwen2-72b, qwen3-moe-30b-a3b and
      dbrx-132b served through ``Server`` + ``Engine`` as phase 6 serves
      (``serve_path``: eager, graphs, graphs, eager; equal streams, 5
      captures then none, the drill, the profiled step): per decode step
      the split-K ``imc_mac`` once per fabric projection (4 a MoE layer, 7
      a dense one: the router and the experts stay off the fabric) and the
      split ``paged_attn`` once per layer; per bucket-32/64 prefill the
      tensor-core ``imc_mac`` once per projection; the first request's
      prefill logits within 2e-2 of the largest |logit| of the plain path
      on the CPU.  gemma3 and qwen3-moe also in ``sim`` + flash (the
      tensor-core flash kernel at gemma3's hd 256 and at 128, once per
      layer per prefill; ``sim`` prefill logits equal
      ``exact``'s; card vs the CPU's plain flash path), qwen3-moe in noisy
      ``sim`` under ``NOISE_SEED``.
   b. gemma3: a 1000-token prompt in a 1024 bucket and 48 new tokens,
      positions past its window of 1024, served paged from graphs; every
      step's logits within 2e-2 of the largest |logit| of a decode through
      ring caches without paging (the same bucketed prefill, its rings
      grown), greedy tokens equal where the margin exceeds the bound.
   c. llava-next-mistral-7b and musicgen-large (modality stubs) prefilled
      from embeddings with flash, merged into paged pools with the
      Server's helpers, 8 greedy decode steps through block tables: the
      tensor-core flash kernel and ``imc_mac`` per prefill, ``paged_attn``
      per step, every step's logits against the CPU's plain path.
   d. qwen3-moe-30b-a3b and llava-next-mistral-7b, 2 layers, 2 steps of
      ``launch.train.train`` through the Engine at batch 1 x seq 256:
      ``imc_mac`` alone launches, twice per projection a step (remat), no
      plain version runs, the MoE metrics present; step times and peak
      memory beside the leaves' sizes.  At 2 layers of ``reduce_config``
      width the card against the CPU: loss within 1e-3 relative (8c's) and
      no farther from a float64 witness's than 1.5x the CPU's loss (or
      within 1e-5 of it), each gradient leaf within 5e-2 relative L2 and
      within 1.5x the CPU's distance from the witness.
   Phase 9 runs in a process of its own (``--families`` with its seven
   configs), as phases 10-12 do: late in the main process the profiler
   has missed one kernel of a replayed graph (in phases 9 and 10).
   Phases 3 and 5 here also take phase 10's geometry: rep 16 (and 12) at
   hd 256 (recurrentgemma's 16 heads over one KV head: the context-split
   ``paged_attn`` kernel over bf16 and int8 pools, the staged one over f32;
   the tensor-core ``flash_attn`` kernel for bf16), windows 2048 and S 2100
   under it; which kernels ran is asserted by counter.
   Phase 7 adds three rows: ``flash_attn`` over gemma3's six layers at
   S = 64 (hd 256, the tensor-core kernel) beside SDPA, ``paged_attn`` over
   its decode step, and
   ``imc_mac`` over one qwen2-72b decode layer (878 MB of int8 weights).

10. The recurrent families at full width, random weights from seed 0,
   ``exact`` fabric unless noted: ``mamba2-370m`` (SSD layers, no MLP, no
   attention) whole, 48 layers, in 10b and 10d and cut to 24 for 10a's
   serves (which hold phase 10 near 200 s), and ``recurrentgemma-9b`` cut
   to one (rglru, rglru, local) period and its two-block tail (5 of 38
   layers; 16 heads over one KV head at hd 256, window 2048).
   a. Served as 9a serves (``serve_family``): per decode step the split-K
      ``imc_mac`` once per fabric projection (``dense_calls``: 2 an SSD
      layer, 3 + 3 an RG-LRU one, whose gates ``w_a``/``w_i`` stay off
      the fabric, 7 a local one) and, per local layer, the context-split
      ``paged_attn`` kernel and its merge (rep 16), the staged kernel
      never; mamba2 launches no attention kernel.
      Per bucket-32/64 prefill the tensor-core ``imc_mac`` once per
      projection.  Prefill logits layer by layer against the CPU's plain
      path.  mamba2 also in ``sim`` (96 ``bitplane_mac`` a step) and noisy
      ``sim``; recurrentgemma in ``sim`` + flash (the tensor-core flash
      kernel once per local layer per prefill, the CUDA-core one never);
      ``sim`` prefill logits equal ``exact``'s.
   b. The state at the prompt's length, fabric off: a 37-token prompt
      prefilled in a 64 bucket and at its own length (mamba2 also 200
      tokens in a 256 bucket: two SSD chunks of 128 and the recurrence
      between them, against one chunk of 200), layer by layer from the
      same input, each recurrent and conv state within ``STATE_RTOL``
      relative L2 and one decode step from each within ``LOGIT_RTOL``; end
      to end measured (two chunkings' roundings compound over 48 layers).
      mamba2 serves that 200-token prompt in a 256 bucket and 16 new
      tokens from graphs, held step by step against the unpaged decode
      from the same bucketed prefill.
   c. recurrentgemma: a 2000-token prompt in a 2048 bucket and 64 new
      tokens, past its window of 2048 (the RG-LRU scan over 2048
      positions), served paged from graphs against the unpaged ring decode
      grown from the same prefill: gated with the fabric off, measured
      under ``exact``.
   d. 2 steps each of mamba2 (48 layers) and recurrentgemma (5 layers) at
      batch 1 x seq 256 through ``launch.train.train`` and the Engine, as
      9d: ``imc_mac`` alone, twice per projection a step; step times and
      peak memory beside the leaves.  At ``reduce_config`` width (mamba2 2
      layers, recurrentgemma its period and tail) the card against the CPU
      with 9d's gates.
   Phase 10 runs in a process of its own (``--families mamba2-370m
   recurrentgemma-9b``), with a fresh CUDA context, allocator and profiler.
   Phase 7 adds two rows: ``paged_attn`` over one recurrentgemma decode
   step at full depth (12 local layers, positions to 2047 under its
   window; the context-split kernel and its merge, 24 launches) beside
   SDPA, and ``imc_mac`` over one mamba2 decode step (96
   launches at N = 4384 and 1024) beside ``torch._int_mm``.

11. The fleet (``repro_torch.fleet``): two virtual hosts on the one card
    (``LocalCoordinator(2, devices=["cuda:0", "cuda:0"])``), one Engine
    each, full-width ``imc-paper-110m``.
   a. Phase 6's six prompts, three waves, through a ``FleetServer`` (4
      slots, paged, buckets 16/32/64), with the fabric off, ``exact`` and
      ``sim`` + flash, no plain version called: each host's streams equal
      those of a single-host ``Server`` on the card fed that host's
      requests, wave by wave (a decode step quantizes its activations per
      tensor over its batch, so under a fabric a stream depends on its
      batch mates and the oracle serves each host's batches); with the
      fabric off every wave's streams also equal those of one ``Server``
      on the card fed all six requests; round-robin uses both hosts; no
      host builds or captures after the two warm-up waves; the merged
      registry counts 18 admissions and 18 TTFT samples.  Each host's
      launches, counted by name over its own polls, are exactly its decode
      steps times one replayed decode step's launches plus its prefills
      times one replayed prefill's of their bucket (one more of each for
      the warm-up run before a capture): ``paged_attn`` (off),
      ``imc_mac`` and ``paged_attn`` (``exact``) or ``bitplane_mac``,
      ``flash_attn`` and ``paged_attn`` (``sim``), and nothing else.
      Merged TTFT / TPOT p50, each host's decode seconds and the fleet's
      decode rate are printed beside one Server fed all six requests.
   b. The straggler drill at 8a's shape (batch 4 x seq 512, ``exact``):
      ``train_fleet`` for 8 steps with ``ckpt_every=2``, host 1's observed
      times 5 s slower from step 3: host 1 removed, one shrink equal to
      ``shrink_after_failure(plan_for_fleet(...))``, ``fault.resumes`` up by
      one, one train step built per host (none on resume), 144
      ``imc_mac`` launches a host step and nothing else, and the final
      params and optimizer state equal a single-host ``train`` of the same
      8 steps on the card bit for bit.  Each host's step p50 and the card's
      peak memory are printed.
   c. ``DistributedCoordinator`` over a one-process NCCL group
      (``file://`` rendezvous in a temporary directory): one tagged
      snapshot gathered and merged equal to the local merge, a barrier.
   d. ``python -m repro_torch.serve_batched`` as a subprocess, single-host
      and with ``--fleet-hosts 2 --fleet-devices cuda:0,cuda:0 --telemetry
      --trace-out``: exit 0 and its ``serve_batched OK`` line.
   Phase 11 runs in a process of its own (``--fleet``).

12. The autotuner (``repro_torch.kernels.autotune``), in a process of its
    own (``--autotune``), aimed at under 60 s:
   a. Every candidate of ``SPACES`` for each tuned kernel (``imc_mac``,
      ``imc_mac_dequant``, ``bitplane_mac``, ``bitplane_mac_noisy``,
      ``rbl_decode_mac``): its C plan equal to the Python twin's at phase
      2's, 4's and 4c's shapes and the standard cells (``imc_mac_plan``,
      ``rbl_decode_mac_plan``, ``bitplane_plan``); at every standard cell
      (``STANDARD_CELLS``) its output bit for bit the default geometry's
      and the plain version's (the noisy kernel under calibrated mismatch
      and one seed).
   b. ``tune_standard(smoke=True)`` into a fresh cache
      (``REPRO_TORCH_AUTOTUNE_CACHE`` in a temporary directory): each
      cell's winner, its µs and the default geometry's µs printed; the cold
      run counts one ``autotune.trials`` per candidate of every cell, a
      warm second run none.
   c. The committed ``tuned.json``: every entry of this card's backend
      (``cuda-sm90``) a geometry of ``SPACES``; a lookup at every standard
      cell resolves from it without a trial.
   d. An ``Engine`` serving imc-paper-110m ``exact`` (phase 6's requests)
      from a copy of the committed cache, two waves, one ``store()`` of a
      non-default plan for the decode step's 768 x 768 projections, two
      more waves: after the store the decode step is a new step captured
      once (the prefill and admission steps are rebuilt too: the geometry
      token is global, so the wave captures what the first one did), the
      streams and launches are the earlier waves', and the further wave
      builds and captures nothing.
   Every served phase before it serves from the committed cache.

The main process prints ``[time] phase <n>: <s> s`` after each phase and
their sum at the end.  It prints the ``kernels`` JSON line (each kernel also
with its launches over phase 9, ``launches_families``, over phase 10,
``launches_recurrent``, over phase 11's serves and drill,
``launches_fleet``, and its phase 12 results, ``autotune``: candidates
checked, each smoke cell's winner and default µs, the committed geometry at
each standard cell; None for the attention kernels, which have nothing to
tune at run time), the card's name and power limit as nvidia-smi gives
them, and last ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --autotune

runs phase 12 alone and prints one JSON line and the nvidia-smi line.

    python3 chip_smoke.py --tune OUT.json

runs ``tune_standard(smoke=False)`` into a fresh cache at OUT.json stamped
with the nvidia-smi line (``measured_on``): how the committed ``tuned.json``
is made (copy OUT.json over it).

    python3 chip_smoke.py --tuned-turns

serves phase 6's three paths from the committed cache and from an empty
one (the defaults) in turns (committed, empty, empty, committed), each turn
through fresh graph Engines, and prints one JSON line of graph TPOT p50 per
path and cache, and the nvidia-smi line.

    python3 chip_smoke.py --fleet

runs phase 11 alone (its four kernels built first) and prints one JSON line
of its results and the nvidia-smi line.

    python3 chip_smoke.py --families [CONFIG ...]

runs phases 9 and 10 alone, with phases 3 and 5 at their geometries and
their phase-7 rows (or only the named configs' parts of phases 9 and 10),
and prints one JSON line and the nvidia-smi line.

    python3 chip_smoke.py --drift CONFIG LAYERS

holds a bucket-16 prefill of CONFIG cut to LAYERS layers on the card
against the CPU's plain path, and the CPU at 3 threads against 8, under
``exact`` and with the fabric off: the hidden state's relative L2 gap by
layer and the last logits' (how far two devices' roundings compound).

    python3 chip_smoke.py --train

runs phase 8 alone (its three kernels built first) and prints one JSON line
of its results and the nvidia-smi line.

    python3 chip_smoke.py --time bitplane_mac [imc_mac ...]

runs phase 7 alone for the named kernels (built first) and prints one JSON
line of their timings and the nvidia-smi line: the way to compare two trees
in turns on one card (copy this script into the other tree's root).

    python3 chip_smoke.py --serve-noisy

serves phase 6c's requests (calibrated noise, ``noise_seed`` 7; in turns,
eager and from graphs) and prints their token streams, SLOs and launches
per decode step: copied into another tree, it holds the two trees' noisy
streams against each other.

    python3 chip_smoke.py --eager-turns PARENT

serves full-width imc-paper-110m (``exact``, ``sim``, noisy ``sim``)
with ``repro_torch.launch.serve`` and profiles its decode step with
``repro_torch.launch.profile`` in the checkout PARENT (its eager serving)
and in this tree (``--eager`` and with graphs), in turns (parent, eager,
graph, graph, eager, parent), and prints one JSON line of TTFT, TPOT,
decode tokens/s, device busy ms and idle share per step, and the nvidia-smi
line.

    python3 chip_smoke.py --rbl-phases

times ``rbl_decode_mac`` beside variants of its source that return early
(after the staging, after the counting, before the cluster's meeting), at
the decode step, the threshold sweep and the decode step over L2-resident
weights, in turns, and prints one JSON line and the nvidia-smi line: where
the kernel's time goes, phase by phase (the variants' results are wrong on
purpose).

    python3 chip_smoke.py --attn-variants

times variants of the two tensor-core attention kernels, each a text patch
of its source built into its own library, in turns from graphs, their
outputs bit for bit equal (``flash_attn`` at hd 256 with 4, 2 or 1
sixteen-row groups a block, at gemma3's and recurrentgemma's prefills and
at S 1024 and 2048; the context-split ``paged_attn`` merge's sum unrolled
16 or 4 times, at phase 7's recurrentgemma step), then profiles phase 7's
two rows and their SDPA calls, kernel by kernel, and prints one JSON line
and the nvidia-smi line (``ATTN_VARIANTS``, ``attn_variants``).

    python3 chip_smoke.py --bitplane-variants

times ``bitplane_mac`` built from text patches of its source, in turns from
graphs, on one step's 72 projections at M in {4, 8, 9, 16, 17, 32, 64,
512}: the source, the r8 kernel at every M (the rule before the
tensor-core kernel), the tensor-core kernel at every M, its plan's target
at 264 and 792 blocks, and, results wrong on purpose, the tensor-core
kernel without its mma, without its prmt decode and with an add in place
of its dp4a (``BITPLANE_VARIANTS``); prints one JSON line and the
nvidia-smi line: where the kernel rule's threshold and the plan's target
come from, and where the kernel's time goes.

    python3 chip_smoke.py --noisy-variants

times ``bitplane_mac_noisy`` built from text patches of its source, in
turns from graphs, on one step's 72 projections at M in {4, 8, 9, 16, 17,
24, 32, 33, 40, 41, 48, 64, 512} under calibrated mismatch: the source, the
8-row-tile kernel at every M (the rule before the tensor-core kernel), the
tensor-core kernel from M = 1, the designs it was measured against (drain
inlined, offsets by a warp scan, appends by a bit loop, Philox by
``__umulhi``, plan targets 528 and 792, two blocks an SM) and, results
wrong on purpose, without Philox, tier 3, the queue, the appends and the
offsets (``NOISY_VARIANTS``); the exact variants' outputs
equal bit for bit; prints one JSON line (with ptxas's registers and spills
of the tensor-core kernel per variant) and the nvidia-smi line: where
``NOISY_MMA_MIN_M`` comes from, and where that kernel's time goes.

    python3 chip_smoke.py --int8-witness

runs ``paged_attn`` (whichever kernel the tree's wrapper picks) on two int8
inputs that have read one bf16 ulp over the 1e-2 bound: rep 8, hd 128,
window 0 at seed 13, and rep 2, hd 24, window 16 at seed 105, positions
5/47/100 and an inactive slot.  It prints, for each, the kernel's and the
plain version's distance from the same function in float64 (int8 K/V
dequantized and P kept exact), rounded to bf16 and unrounded.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9  # 16 per SM per clock, 132 SMs, boost
INT_OPS_PER_S = 64 * 132 * 1.98e9  # 64 INT32 lanes per SM per clock
# Philox4x32-10: per round two 32x32->64-bit multiplies, two 3-input XORs
PHILOX_INT_OPS = 40
STRESS = dict(mismatch_sigma=0.3, comparator_offset_sigma=0.03)
NOISE_SEED = 7
ATTN_ATOL = {"f32": 5e-6, "bf16": 1.6e-2, "int8": 1e-2}
FLASH_ATOL = {"f32": 3e-6, "bf16": 2e-2}
PAGED_VARIANTS = ("paged_attn_split", "paged_attn_ctx", "paged_attn_merge",
                  "paged_attn_staged")


def paged_variant(dtype, rep, hd):
    """The ``paged_attn`` kernel a call takes by the rules of
    ``kernels/paged_attn/ops.py`` (aligned operands): the split kernel at
    rep 1-8 where a row is 1-32 lanes, a power of two, of 4 (f32) or 8
    elements; the context-split kernel at rep 9-16 over bf16 and int8 pools
    (bf16 queries), hd % 16 == 0 and hd <= 256; the staged kernel
    otherwise."""
    lanes, e = divmod(hd, 4 if dtype == "f32" else 8)
    if rep <= 8 and not e and lanes <= 32 and lanes & (lanes - 1) == 0:
        return "paged_attn_split"
    if 9 <= rep <= 16 and dtype != "f32" and hd % 16 == 0 and hd <= 256:
        return "paged_attn_ctx"
    return "paged_attn_staged"


def paged_counts(variant, n=1):
    """The ``paged_attn`` counters (``read_counts`` keys) that ``n`` calls
    taking ``variant`` tick: a context-split call launches its kernel and
    its merge."""
    out = dict.fromkeys(("paged_attn",) + PAGED_VARIANTS, 0)
    out.update({"paged_attn": n, variant: n})
    if variant == "paged_attn_ctx":
        out.update(paged_attn=2 * n, paged_attn_merge=n)
    return out


def flash_variant(dtype, hd):
    """The ``flash_attn`` kernel a call takes (``takes_tensor_cores``,
    aligned operands): the tensor-core kernel for bf16 at hd % 16 == 0 and
    hd <= 128, or hd 256; the CUDA-core kernel otherwise."""
    tc = dtype == "bf16" and hd % 16 == 0 and (hd <= 128 or hd == 256)
    return "flash_attn_tc" if tc else "flash_attn_simt"


def int8_gate(out, ref, exact, tol, where):
    """The int8 gate of the context-split kernel's cases: within ``tol``
    (1e-2, or one bf16 ulp at the largest |out|) of the plain version or,
    where the plain version's bf16 roundings of the dequantized K, V and P
    put it farther, within ``tol`` of the float64 witness ``exact`` and no
    farther from it than the plain version (the kernel keeps them in f32;
    ``--int8-witness``).  Returns (kernel vs plain, kernel vs witness,
    plain vs witness) over the live slots; the last two None when the
    first holds."""
    err = (out.float() - ref.float()).abs().max().item()
    if err <= tol:
        return err, None, None
    e_k = (out.cpu().double() - exact).abs().max().item()
    e_p = (ref.cpu().double() - exact).abs().max().item()
    if not e_k <= min(tol, e_p):
        raise AssertionError(f"{where}: max err {err} > {tol} from the plain "
                             f"version, {e_k} from the float64 witness "
                             f"(plain {e_p})")
    return err, e_k, e_p


def check_attn_dispatch(before, want, where):
    """Raise unless the attention counters rose from ``before`` (a
    ``read_counts()``) by exactly ``want`` (the others by 0)."""
    now = read_counts()
    keys = ("paged_attn", "flash_attn", "flash_attn_tc",
            "flash_attn_simt") + PAGED_VARIANTS
    got = {k: now[k] - before[k] for k in keys}
    full = dict.fromkeys(keys, 0)
    full.update(want)
    if got != full:
        raise AssertionError(f"{where}: launches {got}, the dispatch rules "
                             f"want {full}")
LOGIT_RTOL = 2e-2
PROMPTS = (7, 16, 33, 12, 5, 40)
MACRO_KERNELS = ("imc_mac_dequant", "rbl_decode_mac")  # no served path
MACRO_PAIRS = 1 << 22  # uint8 operand pairs of the word-logic checks
SWEEP_SHIFTS = (0.0, 0.01, 0.05, 0.1, 0.2)  # volts: 6d's threshold study
MAX_NEW = 16
# bitplane_mac's served case (rows 8, 8x8 bits; the r8 kernel at M <= 8,
# the tensor-core kernel above): every M in {1, 3, 4, 5, 9, 64}, K in
# {8, 100, 1030, 3072} and N in {1, 31, 129, 768} appears
R8_SHAPES = ((1, 8, 1), (3, 100, 31), (4, 1030, 129), (5, 3072, 768),
             (9, 8, 768), (64, 100, 129), (1, 3072, 31), (3, 1030, 1),
             (4, 8, 31), (5, 100, 1), (9, 1030, 768), (64, 3072, 129))
R8_ODD_SHAPES = ((3, 100, 31), (4, 1030, 129), (4, 768, 768), (9, 8, 1))
# the tensor-core kernel's cases, each under the calibrated, the detuned
# and a random table: M in {16, 17, 32, 33, 64, 65, 512}, K in {8, 100,
# 768, 1030, 3072}, N in {1, 31, 129, 200, 768, 3072}, the prefill buckets'
# projections and the training forward's M
MMA_SHAPES = ((16, 768, 768), (17, 1030, 129), (32, 768, 3072),
              (33, 100, 31), (64, 3072, 768), (65, 8, 1), (512, 768, 200),
              (512, 1030, 129), (17, 3072, 31))
# bitplane_mac_noisy's tensor-core kernel (rows 8, 8x8 bits, M >= 9), phase
# 4b: (m, k, n, noise, thresholds, fill); M in {9, 17, 33, 41, 47, 64, 65,
# 100, 512}, K with
# a partial group (1030) and a partial k-step (300), calibrated, stress,
# mismatch-only and comparator-only sigmas, a detuned thr, dense operands
NOISY_MMA_CASES = ((9, 768, 768, "calibrated", "calibrated", None),
                   (17, 300, 200, "comparator", "detuned", None),
                   (33, 1030, 129, "both", "detuned", None),
                   (41, 768, 768, "calibrated", "calibrated", None),
                   (41, 1030, 129, "both", "calibrated", None),
                   (47, 768, 768, "calibrated", "calibrated", None),
                   (47, 300, 200, "comparator", "detuned", None),
                   (65, 1030, 129, "both", "detuned", None),
                   (100, 768, 768, "mismatch", "calibrated", None),
                   (64, 768, 3072, "calibrated", "calibrated", None),
                   (64, 1030, 129, "both", "calibrated", None),
                   (64, 3072, 768, "calibrated", "detuned", None),
                   (64, 768, 256, "calibrated", "calibrated", 255),
                   (64, 768, 256, "both", "detuned", 255),
                   (65, 300, 72, "comparator", "calibrated", 255),
                   (512, 768, 64, "calibrated", "calibrated", None),
                   (512, 300, 72, "both", "calibrated", None))


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn``'s launches replayed from one CUDA graph,
    in ms: the kernels back to back, without the host's launch gaps
    (``cuda_ms`` of a host-bound loop measures the host), after ``warmup``
    replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(torch, graph.replay, iters, warmup)


def floor_graph_ms(torch, dev, launches: int = 12) -> float:
    """``launches`` trivial one-element kernels (``x.add_(1)``) replayed
    from one CUDA graph: the per-launch floor of a graph at these shapes."""
    x = torch.zeros(1, device=dev)
    return graph_ms(torch, lambda: [x.add_(1) for _ in range(launches)])


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phases
def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    text = build.build_all()  # every kernel of build.KERNELS, in parallel
    for name in build.KERNELS:
        build.load(name)
    dt = time.perf_counter() - t0
    log(text)
    log(f"[1] kernels built and loaded in {dt:.2f} s")
    return dt


def phase_imc_mac(torch, dev):
    from repro_torch.kernels.imc_mac.ops import imc_mac, imc_mac_torch

    g = torch.Generator(device=dev).manual_seed(1)
    cases = [(m, k, n) for m in (4, 16, 64)
             for k, n in ((768, 768), (768, 3072), (3072, 768))]
    cases.append((33, 1030, 129))  # ragged in M, K and N
    for m, k, n in cases:
        qa = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        qw = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        out = imc_mac(qa, qw)
        torch.cuda.synchronize()
        if not torch.equal(out, imc_mac_torch(qa, qw)):
            raise AssertionError(f"imc_mac differs from its plain version "
                                 f"at {(m, k, n)}")
    qa = torch.full((8, 2048), 127, dtype=torch.int8, device=dev)
    qw = torch.full((2048, 8), -127, dtype=torch.int8, device=dev)
    if not bool((imc_mac(qa, qw) == -127 * 127 * 2048).all()):
        raise AssertionError("imc_mac int32 accumulation case failed")
    n_split = split_cases(torch, dev, "imc_mac", imc_mac, imc_mac_torch,
                          lambda qa, qw, sw: (qa, qw))
    sass = mma_sass()
    log(f"[2] imc_mac bit-exact on {len(cases) + 1} shapes, then on "
        f"{n_split} split-K and tensor-core cases, plans and graph replays; "
        f"SASS of the M > 16 kernel: {sass}")
    return 0.0


# the split-K kernel's cases: (m, k, n, byte offset of the weights, fill of
# a and b or None); every M in {1, 3, 4, 5, 9, 16, 17}, K in {0, 4, 100,
# 1030, 3072} and N in {1, 31, 129, 768, 3072} appears
SPLIT_CASES = ((1, 4, 1, 0, None), (3, 100, 31, 0, None),
               (4, 1030, 129, 0, None), (5, 3072, 768, 0, None),
               (9, 0, 3072, 0, None), (16, 1030, 3072, 0, None),
               (17, 100, 129, 0, None), (16, 3072, 768, 0, None),
               (4, 768, 12, 0, None), (9, 4, 31, 0, None),
               (1, 3072, 1, 0, None), (4, 0, 768, 0, None),
               (4, 768, 768, 1, None), (4, 768, 768, 4, None),
               (9, 1030, 768, 4, None), (16, 768, 3072, 1, None),
               (4, 768, 768, 0, (-128, -128)), (16, 1030, 129, 0, (-128, 127)),
               (5, 3072, 31, 0, (127, -127)), (17, 768, 768, 0, (-128, -128)))
# the tensor-core kernel's cases (M > 16), drawn from their own generator:
# every M in {17, 31, 32, 33, 48, 64, 65, 130, 512}, K in {0, 4, 140, 1030}
# and N in {12, 31, 129, 150} appears, and the prefill shapes
MMA_CASES = ((17, 140, 12, 0, None), (31, 1030, 31, 0, None),
             (32, 4, 129, 0, None), (33, 0, 150, 0, None),
             (48, 1030, 129, 1, None), (64, 140, 150, 4, None),
             (65, 4, 31, 1, None), (130, 140, 129, 0, None),
             (512, 1030, 150, 0, None), (64, 768, 768, 1, None),
             (32, 768, 3072, 4, None), (17, 3072, 768, 0, None),
             (32, 768, 768, 0, None), (32, 3072, 768, 0, None),
             (65, 768, 3072, 0, None), (33, 1030, 12, 4, (-128, -128)),
             (64, 3072, 31, 0, (127, -127)), (130, 1030, 150, 1, (-128, 127)))


def split_cases(torch, dev, name, wrapper, plain, args):
    """Phase 2/2b's split-K and tensor-core checks for ``wrapper`` against
    ``plain`` (``args`` makes their arguments from the operands and
    scale_w): bit-exact on SPLIT_CASES and MMA_CASES with the counter of the
    kernel the plan names, C plan == Python plan, and one launch of each
    kernel captured in a CUDA graph, replayed twice, still bit-exact."""
    from repro_torch.kernels.imc_mac.ops import compiled_plan, imc_mac_plan

    g = torch.Generator(device=dev).manual_seed(31)
    def draw(m, k, n, off, fill):
        qa = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        flat = torch.randint(-128, 128, (k * n + off,), generator=g,
                             device=dev, dtype=torch.int8)
        qw = flat[off:].view(k, n)  # data_ptr() offset by ``off`` bytes
        if fill is not None:
            qa.fill_(fill[0])
            qw.fill_(fill[1])
        sw = torch.rand((n,), generator=g, device=dev) * 0.099 + 0.001
        return qa, qw, sw

    def check(m, k, n, off, fill):
        plan = imc_mac_plan(m, n, k)
        if compiled_plan(m, n, k) != plan:
            raise AssertionError(f"imc_mac_plan{(m, n, k)}: C "
                                 f"{compiled_plan(m, n, k)} != Python {plan}")
        qa, qw, sw = draw(m, k, n, off, fill)
        before = (wrapper.split_launches, wrapper.tiled_launches)
        out = wrapper(*args(qa, qw, sw))
        torch.cuda.synchronize()
        rose = (wrapper.split_launches - before[0],
                wrapper.tiled_launches - before[1])
        if rose != ((1, 0) if m <= 16 else (0, 1)) or bool(plan.rows) != \
                (m <= 16):
            raise AssertionError(f"{name} at {(m, k, n)}: split/tiled "
                                 f"launches rose by {rose}, plan {plan}")
        if not torch.equal(out, plain(*args(qa, qw, sw))):
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"{(m, k, n)}, offset {off}, fill {fill}")

    for case in SPLIT_CASES:
        check(*case)
    for m, k, n in ((4, 768, 768), (16, 3072, 768), (64, 768, 768),
                    (32, 768, 3072), (64, 3072, 768)):
        ins = args(*draw(m, k, n, 0, None))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            wrapper(*ins)  # warm up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = wrapper(*ins)
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, plain(*ins)):
            raise AssertionError(f"{name} at {(m, k, n)} differs from its "
                                 "plain version after two graph replays")
    g = torch.Generator(device=dev).manual_seed(41)
    for case in MMA_CASES:
        check(*case)
    return len(SPLIT_CASES) + 5 + len(MMA_CASES)


def sass_counts(name, kernel, ops):
    """Instructions of every instance of ``kernel`` in ``csrc/<name>.cu``'s
    library, and how many of them are each of ``ops``, read with
    ``cuobjdump --dump-sass``."""
    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "--dump-sass",
                           str(build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    found, func = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            func = head.group(1) if kernel in line else None
            if func:
                found[func] = dict.fromkeys(("instructions",) + ops, 0)
        elif func and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            found[func]["instructions"] += 1
            for op in ops:
                found[func][op] += bool(re.search(rf"\b{op}\b", line))
    return found


def mma_sass():
    """The SASS of ``imc_mac_mma_kernel`` (both instances): its instructions
    and its ``IMMA`` and ``IDP`` (dp4a) among them.  It must run on the
    tensor cores and hold no dp4a."""
    found = sass_counts("imc_mac", "imc_mac_mma_kernel", ("IMMA", "IDP"))
    if len(found) != 2 or not all(c["IMMA"] > 0 and c["IDP"] == 0
                                  for c in found.values()):
        raise AssertionError(f"imc_mac_mma_kernel's SASS: {found}; expected "
                             "two instances with IMMA and no IDP")
    return {("dequant" if "ILb1E" in f else "int32"): c
            for f, c in found.items()}


def rbl_sass():
    """The SASS of ``rbl_decode_mac_kernel``'s twelve instances (4 or 8 rows
    a thread; rows 8 or given at run time; W copied 8, 4 or 1 bytes at a
    time): their instructions and the ``PRMT``, ``IMAD``, ``IDP`` and
    ``POPC`` among them.  The decode is from registers (``PRMT``) and the
    counts are masked sums (``IMAD``): no ``POPC``.  Returns the counts of
    the instances with 8-byte copies, the users' shapes."""
    found = sass_counts("rbl_decode_mac", "rbl_decode_mac_kernel",
                        ("PRMT", "IMAD", "IDP", "POPC"))
    if len(found) != 12 or not all(c["PRMT"] > 0 and c["POPC"] == 0
                                  for c in found.values()):
        raise AssertionError(f"rbl_decode_mac_kernel's SASS: {found}; "
                             "expected twelve instances with PRMT and no "
                             "POPC")
    out = {}
    for f, c in found.items():
        rm, rows, width = re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)E", f).groups()
        if width == "8":
            out[f"rm{rm}_rows{'any' if rows == '0' else rows}"] = c
    return out


def phase_imc_mac_dequant(torch, dev):
    from repro_torch.kernels.imc_mac.ops import (imc_mac_dequant,
                                                 imc_mac_dequant_torch)

    g = torch.Generator(device=dev).manual_seed(21)
    cases = [(m, k, n) for m in (4, 16, 64)
             for k, n in ((768, 768), (768, 3072), (3072, 768))]
    cases += [(130, 140, 150), (8, 2048, 8)]  # ragged; deep K at +-127
    worst = 0.0
    for m, k, n in cases:
        qa = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                           dtype=torch.int8)
        qw = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        if k == 2048:  # |acc| = 3.3e7 > 2^24: the int-to-float rounding
            qa.fill_(127)
            qw.fill_(-127)
        # scales as tests/test_kernels.py draws them
        sa = torch.tensor(0.0123, device=dev)
        sw = torch.rand((n,), generator=g, device=dev) * 0.099 + 0.001
        out = imc_mac_dequant(qa, qw, sa, sw)
        torch.cuda.synchronize()
        plain = imc_mac_dequant_torch(qa, qw, sa, sw)
        worst = max(worst, (out - plain).abs().max().item())
        if not torch.equal(out, plain):
            raise AssertionError(f"imc_mac_dequant differs from its plain "
                                 f"version at {(m, k, n)}")
    sa = torch.tensor(0.0123, device=dev)
    n_split = split_cases(torch, dev, "imc_mac_dequant", imc_mac_dequant,
                          imc_mac_dequant_torch,
                          lambda qa, qw, sw: (qa, qw, sa, sw))
    log(f"[2b] imc_mac_dequant bit-exact on {len(cases)} shapes, then on "
        f"{n_split} split-K and tensor-core cases, plans and graph replays")
    return worst


def _ragged_table(rng, pos, mb, nb, bs):
    import numpy as np

    tbl = np.full((len(pos), mb), -1, np.int32)
    perm = iter(rng.permutation(nb))
    for i, p in enumerate(pos):
        for j in range(p // bs + 1):
            tbl[i, j] = next(perm)
    return tbl


def attn_inputs(torch, dev, dtype, B, H, KV, hd, pos, bs=16, mb=8, seed=0,
                inactive_last=False):
    import numpy as np

    from repro_torch.models.attention import _kv_quant

    rng = np.random.default_rng(seed)
    nb = B * mb
    qdt = torch.float32 if dtype == "f32" else torch.bfloat16
    pdt = torch.float32 if dtype in ("f32", "int8") else torch.bfloat16
    q = torch.tensor(rng.standard_normal((B, 1, H, hd)), dtype=qdt, device=dev)
    k = torch.tensor(rng.standard_normal((nb, bs, KV, hd)), dtype=pdt,
                     device=dev)
    v = torch.tensor(rng.standard_normal((nb, bs, KV, hd)), dtype=pdt,
                     device=dev)
    kw = {}
    if dtype == "int8":
        k, ks = _kv_quant(k)
        v, vs = _kv_quant(v)
        kw = dict(k_scale=ks, v_scale=vs)
    tbl = _ragged_table(rng, pos, mb, nb, bs)
    if inactive_last:
        tbl[-1] = -1
    return (q, k, v, torch.tensor(tbl, device=dev),
            torch.tensor(pos, dtype=torch.int32, device=dev), kw)


def _paged_cases():
    """Phase 3's cases as (seed, pos, dtype, window, geom).  The last slot
    gets an empty table; at pos 0, and at pos 127 under a window of 16,
    whole warps of the split kernel see no key.  The twelve cases at
    positions 5/47/100, hd 64 and 128, take seeds 0-11, the others 100 up
    in the order of the full grid; int8 at hd 24 is left out (module
    docstring, phase 3)."""
    grid = [(pos, dtype, window, geom)
            for pos in ([5, 47, 100, 0], [0, 15, 16, 127, 3])
            for dtype in ("f32", "bf16", "int8") for window in (0, 16)
            for geom in ((4, 12, 12, 64), (3, 16, 2, 128), (3, 4, 2, 24))]
    old = [c for c in grid if len(c[0]) == 4 and c[3][3] != 24]
    new = [c for c in grid if c not in old]
    # recurrentgemma-9b's rep 16 at hd 256: the context-split kernel (f32:
    # the staged one), chunk edges and positions past a window of 2048
    ctx = [(pos, dtype, window, (len(pos), 16, 1, 256), mb)
           for pos, windows, mb in (([0, 63, 64, 127, 3], (0, 16), 9),
                                    ([2100, 700, 64, 0], (0, 2048), 136))
           for dtype in ("f32", "bf16", "int8") for window in windows]
    return [(n,) + c + (8,) for n, c in list(enumerate(old)) +
            list(enumerate(new, 100)) if not (c[1] == "int8" and
                                              c[3][3] == 24)] + \
        [(n,) + c for n, c in enumerate(ctx, 300)]


PAGED_CASES = _paged_cases()


def phase_paged_attn(torch, dev):
    from repro_torch.kernels.paged_attn.ops import (paged_attention,
                                                    paged_decode_torch)

    worst = {}
    for n, pos, dtype, window, (B, H, KV, hd), mb in PAGED_CASES:
        B = B if len(pos) == 4 else len(pos)
        q, k, v, tbl, p, kw = attn_inputs(torch, dev, dtype, B, H, KV, hd,
                                          pos[:B], mb=mb, seed=n,
                                          inactive_last=True)
        variant = paged_variant(dtype, H // KV, hd)
        before = read_counts()
        out = paged_attention(q, k, v, tbl, p, window=window, **kw)
        torch.cuda.synchronize()
        check_attn_dispatch(before, paged_counts(variant),
                            f"[3] paged_attn {dtype} rep={H // KV} hd={hd}")
        ref = paged_decode_torch(q, k, v, tbl, p, window=window, **kw)
        if not bool(torch.isfinite(out).all()) or \
                bool((out[B - 1] != 0).any()):
            raise AssertionError("paged_attn output is not finite, or an "
                                 "empty table did not flush zeros")
        err = (out[:B - 1].float() - ref[:B - 1].float()).abs().max().item()
        worst[dtype] = max(worst.get(dtype, 0.0), err)
        tol = ATTN_ATOL[dtype]
        if dtype == "int8" and variant == "paged_attn_ctx":
            # phase 9's int8 rule (one bf16 ulp) and ``int8_gate``
            tol = max(tol, bf16_ulp(ref[:B - 1].float().abs().max().item()))
            exact = paged_decode_f64(q, k, v, tbl, p, kw["k_scale"],
                                     kw["v_scale"], window)[:B - 1]
            _, e_k, e_p = int8_gate(out[:B - 1], ref[:B - 1], exact, tol,
                                    f"[3] paged_attn int8 window={window} "
                                    f"rep={H // KV} hd={hd}")
            if e_k is not None:
                log(f"[3] paged_attn int8 window={window} rep={H // KV} "
                    f"hd={hd}: {err} from the plain version; from the "
                    f"float64 witness {e_k} (plain {e_p})")
            continue
        if err > tol:
            raise AssertionError(
                f"paged_attn {dtype} window={window} rep={H // KV} hd={hd} "
                f"pos={pos[:B]}: max err {err} > {tol}")
    log(f"[3] paged_attn within bounds on {len(PAGED_CASES)} cases; worst "
        f"{worst}")
    return max(worst.values()), worst


def paged_decode_f64(q, k, v, tbl, pos, k_scale, v_scale, window=0):
    """Paged decode in float64 on the CPU, int8 pools dequantized against
    their scales and P kept exact: (B, 1, H, hd) float64."""
    q, k, v, tbl, pos = (t.cpu() for t in (q, k, v, tbl, pos))
    kd, vd = k.double(), v.double()
    if k_scale is not None:
        kd = kd * k_scale.cpu().double()[..., None]
        vd = vd * v_scale.cpu().double()[..., None]
    b_, _, h, hd = q.shape
    bs, kvh = k.shape[1], k.shape[2]
    out = q.new_zeros(q.shape, dtype=kd.dtype)
    for b in range(b_):
        p = int(pos[b])
        keys = [t for t in range(p + 1) if int(tbl[b, t // bs]) >= 0
                and (not window or t > p - window)]
        if not keys:
            continue
        blk = [int(tbl[b, t // bs]) for t in keys]
        off = [t % bs for t in keys]
        qg = q[b, 0].double().reshape(kvh, h // kvh, hd)
        sc = (qg @ kd[blk, off].permute(1, 2, 0)) * hd ** -0.5
        out[b, 0] = (sc.softmax(-1) @ vd[blk, off].transpose(0, 1)
                     ).reshape(h, hd)
    return out


def int8_witness(torch, dev):
    from repro_torch.kernels.paged_attn.ops import (paged_attention,
                                                    paged_decode_torch)

    rows = []
    for seed, window, (H, KV, hd) in ((13, 0, (16, 2, 128)),
                                      (105, 16, (4, 2, 24))):
        pos = [5, 47, 100]
        q, k, v, tbl, p, kw = attn_inputs(torch, dev, "int8", 3, H, KV, hd,
                                          pos, seed=seed, inactive_last=True)
        split = getattr(paged_attention, "split_launches", 0)
        out = paged_attention(q, k, v, tbl, p, window=window, **kw)
        torch.cuda.synchronize()
        kernel = "split" if getattr(paged_attention, "split_launches",
                                    0) != split else "staged"
        ref = paged_decode_torch(q, k, v, tbl, p, window=window, **kw)
        exact = paged_decode_f64(q, k, v, tbl, p, kw["k_scale"],
                                 kw["v_scale"], window)[:2]
        exact_bf16 = exact.to(torch.bfloat16).double()

        def dist(x, y):
            return (x[:2].cpu().double() - y).abs().max().item()

        rows.append(dict(
            seed=seed, window=window, rep=H // KV, hd=hd, kernel=kernel,
            kernel_vs_plain=dist(out, ref[:2].cpu().double()),
            kernel_vs_f64=dist(out, exact), plain_vs_f64=dist(ref, exact),
            kernel_vs_bf16_f64=dist(out, exact_bf16),
            plain_vs_bf16_f64=dist(ref, exact_bf16),
            max_abs_out=exact.abs().max().item()))
    return rows


def phase_bitplane_mac(torch, dev):
    from repro_torch.core.rbl import rbl_voltage_physics
    from repro_torch.kernels.bitplane_mac.ops import (bitplane_mac,
                                                      bitplane_mac_torch,
                                                      physics_thresholds)

    from repro_torch.kernels.bitplane_mac.ops import (bitplane_kernel,
                                                      bitplane_mma_plan,
                                                      compiled_mma_plan)

    g = torch.Generator(device=dev).manual_seed(3)
    worst = 0
    mma = 0

    def check(ua, uw, thr, ba, bw, rows):
        nonlocal worst, mma
        before = bitplane_mac.launches
        before_mma = bitplane_mac.mma_launches
        out = bitplane_mac(ua, uw, thr, bits_a=ba, bits_w=bw, rows=rows)
        torch.cuda.synchronize()
        where = (tuple(ua.shape), tuple(uw.shape), ba, bw, rows)
        if bitplane_mac.launches != before + 1:
            raise AssertionError(f"bitplane_mac launched "
                                 f"{bitplane_mac.launches - before} times")
        tc = bitplane_kernel(ua.shape[0], ba, bw, rows) == \
            "bitplane_mac_mma_kernel"
        ran = bitplane_mac.mma_launches - before_mma
        if ran != int(tc):
            raise AssertionError(f"bitplane_mac at {where}: the tensor-core "
                                 f"kernel ran {ran} times, expected "
                                 f"{int(tc)}")
        mma += int(tc)
        plain = bitplane_mac_torch(ua, uw, thr, bits_a=ba, bits_w=bw,
                                   rows=rows)
        worst = max(worst, (out - plain).abs().max().item())
        if not torch.equal(out, plain):
            raise AssertionError(f"bitplane_mac differs from its plain "
                                 f"version at {where}")
        return out

    def draw(m, k, n, ba, bw, fill=None):
        if fill is not None:
            return (torch.full((m, k), fill, device=dev, dtype=torch.int32),
                    torch.full((k, n), fill, device=dev, dtype=torch.int32))
        return (torch.randint(0, 1 << ba, (m, k), generator=g, device=dev,
                              dtype=torch.int32),
                torch.randint(0, 1 << bw, (k, n), generator=g, device=dev,
                              dtype=torch.int32))

    # (m, k, n, bits_a, bits_w, rows, fill)
    cases = [(m, k, n, 8, 8, 8, None) for m in (4, 64)
             for k, n in ((768, 768), (768, 3072), (3072, 768))]
    # the served-case kernel (rows 8, 8x8 bits) at every M, K and N below
    cases += [(m, k, n, 8, 8, 8, None) for m, k, n in R8_SHAPES]
    cases += [(4, 1030, 129, 8, 8, 8, 255),  # every count 8
              (9, 3072, 31, 8, 8, 8, 255),
              (33, 1030, 129, 8, 8, 8, None),  # ragged M, K (partial group), N
              # the generic kernel
              (16, 768, 768, 4, 8, 8, None),   # asymmetric precision
              (5, 40, 12, 6, 6, 8, None),
              (7, 100, 37, 3, 5, 16, None),
              (4, 768, 768, 8, 8, 16, None),   # 16-row groups (physics decode)
              (4, 100, 40, 8, 8, 16, None)]    # 16-row groups, ragged
    for m, k, n, ba, bw, rows, fill in cases:
        ua, uw = draw(m, k, n, ba, bw, fill)
        out = check(ua, uw, None, ba, bw, rows)
        if not torch.equal(out, (ua.double() @ uw.double()).to(torch.int32)):
            raise AssertionError(f"bitplane_mac noise-free is not u_a @ u_w at"
                                 f" {(m, k, n, ba, bw, rows)}")
    # detuned and random comparator references: the decode must follow the
    # thr data, in both kernels
    good = physics_thresholds(8, dev)
    detuned = torch.cat([torch.tensor([1.9], device=dev), good[:-1]])
    v0, v8 = rbl_voltage_physics(torch.tensor([0.0, 8.0]), rows=8).tolist()
    rand = torch.sort(torch.rand(8, generator=g, device=dev) * (v0 - v8) + v8,
                      descending=True).values
    odd = [(8, 16, 8, 2, 2, detuned), (4, 768, 768, 2, 2, detuned),
           (5, 20, 7, 2, 2, detuned)]
    odd += [(m, k, n, 8, 8, thr) for m, k, n in R8_ODD_SHAPES
            for thr in (detuned, rand)]
    for m, k, n, ba, bw, thr in odd:
        ua, uw = draw(m, k, n, ba, bw)
        bad = check(ua, uw, thr, ba, bw, 8)
        if torch.equal(bad, bitplane_mac(ua, uw, good, bits_a=ba, bits_w=bw)):
            raise AssertionError("changed thresholds did not change the "
                                 "decode: the kernel ignores thr")
    ua, uw = draw(4, 1030, 129, 8, 8, 255)
    check(ua, uw, detuned, 8, 8, 8)
    # the tensor-core kernel under the three tables, on random and all-255
    # operands; its C plan equal to the Python twin
    for m, k, n in MMA_SHAPES:
        if tuple(compiled_mma_plan(m, n, k)) != bitplane_mma_plan(m, n, k):
            raise AssertionError(
                f"bitplane_mma_plan{(m, n, k)}: C {compiled_mma_plan(m, n, k)}"
                f" != Python {bitplane_mma_plan(m, n, k)}")
        for thr in (good, detuned, rand):
            for fill in (None, 255):
                ua, uw = draw(m, k, n, 8, 8, fill)
                out = check(ua, uw, thr, 8, 8, 8)
                if thr is good and not torch.equal(
                        out, (ua.double() @ uw.double()).to(torch.int32)):
                    raise AssertionError(f"bitplane_mac noise-free is not "
                                         f"u_a @ u_w at {(m, k, n)}")
    n_mma = 6 * len(MMA_SHAPES)
    log(f"[4] bitplane_mac bit-exact on "
        f"{len(cases) + len(odd) + 1 + n_mma} cases ({len(odd) + 1} with "
        f"detuned or random thresholds, and {n_mma} of the tensor-core "
        f"kernel under the calibrated, detuned and random tables); "
        f"{mma} launches of the tensor-core kernel")
    if mma < n_mma:
        raise AssertionError(f"[4] the tensor-core kernel ran {mma} times")
    return float(worst)


def noisy_call(torch, fn, ua, uw, seed, thr, tag, **kw):
    """One ``bitplane_mac_noisy`` call: one launch, of the kernel that the
    twin ``ops.bitplane_noisy_kernel`` names for its shape (the launcher's
    report, ``mma_launches``); returns its output."""
    from repro_torch.kernels.bitplane_mac.ops import (bitplane_mac_noisy,
                                                      bitplane_noisy_kernel)

    before = bitplane_mac_noisy.launches
    before_mma = bitplane_mac_noisy.mma_launches
    out = fn(ua, uw, seed, thr, **kw)
    torch.cuda.synchronize()
    m = ua.reshape(-1, ua.shape[-1]).shape[0]
    want = bitplane_noisy_kernel(m, kw.get("bits_a", 8), kw.get("bits_w", 8),
                                 kw.get("rows", 8))
    ran = bitplane_mac_noisy.mma_launches - before_mma
    if bitplane_mac_noisy.launches != before + 1 or \
            ran != int(want == "bitplane_mac_noisy_mma_kernel"):
        raise AssertionError(
            f"bitplane_mac_noisy at {tag}: {bitplane_mac_noisy.launches - before}"
            f" launches, {ran} of the tensor-core kernel; the twin names "
            f"{want}")
    return out


def noisy_gate(tag, counts, m, calls):
    """``calls`` launches of ``bitplane_mac_noisy`` at M = ``m`` in
    ``counts``, each of the kernel that ``ops.bitplane_noisy_kernel`` names
    (the launcher's report: ``bitplane_mac_noisy_mma``)."""
    from repro_torch.kernels.bitplane_mac.ops import bitplane_noisy_kernel

    mma = calls if bitplane_noisy_kernel(m, 8, 8, 8) == \
        "bitplane_mac_noisy_mma_kernel" else 0
    check_counts(tag, counts, {"bitplane_mac_noisy": calls,
                               "bitplane_mac_noisy_mma": mma})


def phase_bitplane_mac_noisy(torch, dev):
    from repro_torch.core.constants import MC_SIGMA_VK
    from repro_torch.kernels.bitplane_mac.ops import (bitplane_mac,
                                                      bitplane_mac_noisy,
                                                      bitplane_mac_noisy_torch,
                                                      physics_thresholds)
    from repro_torch.kernels.common import seed_row

    noise = {"mismatch": dict(mismatch_sigma=0.3),
             "comparator": dict(comparator_offset_sigma=0.03),
             "both": STRESS, "calibrated": dict(mismatch_sigma=MC_SIGMA_VK)}
    g = torch.Generator(device=dev).manual_seed(8)
    # (m, k, n, bits_a, bits_w, rows, noise)
    cases = [(4, 768, 768, 8, 8, 8, "both"), (4, 768, 3072, 8, 8, 8, "both"),
             (4, 3072, 768, 8, 8, 8, "comparator"),
             (4, 768, 768, 8, 8, 8, "calibrated"),
             (64, 768, 768, 8, 8, 8, "mismatch"),
             (64, 768, 3072, 8, 8, 8, "calibrated"),
             (64, 3072, 768, 8, 8, 8, "mismatch"),
             (33, 1030, 129, 8, 8, 8, "both"),     # ragged M, K, N
             (16, 768, 768, 4, 8, 8, "comparator"),  # asymmetric precision
             (4, 768, 768, 8, 8, 16, "both"),      # 16-row groups
             (4, 100, 40, 8, 8, 16, "mismatch")]   # 16-row groups, ragged
    worst = 0
    for m, k, n, ba, bw, rows, nz in cases:
        ua = torch.randint(0, 1 << ba, (m, k), generator=g, device=dev,
                           dtype=torch.int32)
        uw = torch.randint(0, 1 << bw, (k, n), generator=g, device=dev,
                           dtype=torch.int32)
        kw = dict(bits_a=ba, bits_w=bw, rows=rows, **noise[nz])
        tag = (m, k, n, ba, bw, rows, nz)
        out = noisy_call(torch, bitplane_mac_noisy, ua, uw, 11, None, tag,
                         **kw)
        again = noisy_call(torch, bitplane_mac_noisy, ua, uw,
                           seed_row(11, dev), None, tag, **kw)
        plain = bitplane_mac_noisy_torch(ua, uw, 11, **kw)
        worst = max(worst, (out - plain).abs().max().item())
        if not torch.equal(out, plain):
            raise AssertionError(
                f"bitplane_mac_noisy differs from its plain version at "
                f"{(m, k, n, ba, bw, rows, nz)} in "
                f"{int((out != plain).sum())} of {out.numel()} elements")
        if not torch.equal(out, again):
            raise AssertionError("bitplane_mac_noisy: the same seed gave "
                                 f"two results at {(m, k, n, nz)}")
        if m == 4 and (k, n) == (768, 768) and rows == 8:
            clean = bitplane_mac(ua, uw, bits_a=ba, bits_w=bw, rows=rows)
            zero = bitplane_mac_noisy(ua, uw, 11, bits_a=ba, bits_w=bw,
                                      rows=rows, mismatch_sigma=0.0,
                                      comparator_offset_sigma=0.0)
            if not torch.equal(zero, clean):
                raise AssertionError("bitplane_mac_noisy with NoiseSpec(0, 0)"
                                     " differs from bitplane_mac")
            other = bitplane_mac_noisy(ua, uw, 12, **kw)
            if nz == "both" and torch.equal(other, out):
                raise AssertionError("bitplane_mac_noisy: two seeds gave the "
                                     "same result at the stress sigmas")
    good = physics_thresholds(8, dev)
    detuned = torch.cat([torch.tensor([1.9], device=dev), good[:-1]])
    ua = torch.randint(0, 4, (4, 768), generator=g, device=dev,
                       dtype=torch.int32)
    uw = torch.randint(0, 4, (768, 768), generator=g, device=dev,
                       dtype=torch.int32)
    kw = dict(bits_a=2, bits_w=2, **STRESS)
    bad = bitplane_mac_noisy(ua, uw, 3, detuned, **kw)
    torch.cuda.synchronize()
    if not torch.equal(bad, bitplane_mac_noisy_torch(ua, uw, 3, detuned,
                                                     **kw)):
        raise AssertionError("bitplane_mac_noisy with detuned thresholds "
                             "differs from its plain version")
    if torch.equal(bad, bitplane_mac_noisy(ua, uw, 3, good, **kw)):
        raise AssertionError("detuned thresholds did not change the noisy "
                             "decode: the kernel ignores thr")
    adverse = noisy_adversarial_cases(torch, dev)
    for tag, m, k, n, rows, kw, fill, thr in adverse:
        if fill is None:
            ua = torch.randint(0, 256, (m, k), generator=g, device=dev,
                               dtype=torch.int32)
            uw = torch.randint(0, 256, (k, n), generator=g, device=dev,
                               dtype=torch.int32)
        else:
            ua = torch.full((m, k), fill, device=dev, dtype=torch.int32)
            uw = torch.full((k, n), fill, device=dev, dtype=torch.int32)
        out = noisy_call(torch, bitplane_mac_noisy, ua, uw, 11, thr,
                         (tag, m, k, n), rows=rows, **kw)
        plain = bitplane_mac_noisy_torch(ua, uw, 11, thr, rows=rows, **kw)
        worst = max(worst, (out - plain).abs().max().item())
        if not torch.equal(out, plain):
            raise AssertionError(
                f"bitplane_mac_noisy differs from its plain version at {tag} "
                f"{(m, k, n, rows, kw)} in {int((out != plain).sum())} of "
                f"{out.numel()} elements")
    # the tensor-core kernel (rows 8, 8x8 bits, M >= NOISY_MMA_MIN_M = 9)
    mma_worst = 0
    for m, k, n, nz, kind, fill in NOISY_MMA_CASES:
        if fill is None:
            ua = torch.randint(0, 256, (m, k), generator=g, device=dev,
                               dtype=torch.int32)
            uw = torch.randint(0, 256, (k, n), generator=g, device=dev,
                               dtype=torch.int32)
        else:
            ua = torch.full((m, k), fill, device=dev, dtype=torch.int32)
            uw = torch.full((k, n), fill, device=dev, dtype=torch.int32)
        thr = good if kind == "calibrated" else detuned
        tag = (m, k, n, nz, kind, fill)
        out = noisy_call(torch, bitplane_mac_noisy, ua, uw, 13, thr, tag,
                         **noise[nz])
        plain = bitplane_mac_noisy_torch(ua, uw, 13, thr, **noise[nz])
        mma_worst = max(mma_worst, (out - plain).abs().max().item())
        if not torch.equal(out, plain):
            raise AssertionError(
                f"bitplane_mac_noisy (tensor-core kernel) differs from its "
                f"plain version at {tag} in {int((out != plain).sum())} of "
                f"{out.numel()} elements")
    worst = max(worst, mma_worst)
    log(f"[4b] bitplane_mac_noisy bit-exact on {len(cases) + 1} cases "
        f"(1 detuned) and {len(adverse)} adversarial ones (dense and zero "
        "operands, thresholds a hair inside and outside a band edge, "
        "mismatch 1.0, rows 16 and 3, M 9-64 on the tensor-core kernel); "
        f"and on the tensor-core kernel's {len(NOISY_MMA_CASES)} cases (M 9-"
        "512, calibrated / stress / mismatch / comparator sigmas, detuned "
        "thr, dense operands); the launcher's kernel equal to the twin's on "
        "every call; NoiseSpec(0, 0) equals bitplane_mac; same seed "
        "identical, two seeds differ")
    # the plain version's Philox temporaries filled the caching allocator
    # with GBs of int64 blocks; hand them back before the served paths
    torch.cuda.empty_cache()
    return float(worst)


def hair_thresholds(torch, dev, rows, k, reach, f):
    """The physics thresholds for ``rows`` with the two nearest count k's
    noise-free voltage moved to f x ``reach`` (in counts) either side of k:
    ``thr[k-1] = V(k - f reach)``, ``thr[k] = V(k + f reach)``.  With f just
    under 1 they lie a hair inside count k's band, just over 1 outside."""
    from repro_torch.core.rbl import rbl_voltage_physics
    from repro_torch.kernels.bitplane_mac.ops import physics_thresholds

    thr = physics_thresholds(rows, "cpu").clone()
    thr[k - 1], thr[k] = rbl_voltage_physics(
        torch.tensor([k - f * reach, k + f * reach]), rows=rows)
    return thr.to(dev)


def hair_offsets(torch, dev, rows, k, reach, f):
    """As :func:`hair_thresholds`, for a comparator offset reaching
    ``reach`` volts around V(k)."""
    from repro_torch.core.rbl import rbl_voltage_physics
    from repro_torch.kernels.bitplane_mac.ops import physics_thresholds

    thr = physics_thresholds(rows, "cpu").clone()
    v = rbl_voltage_physics(torch.tensor(float(k)), rows=rows)
    thr[k - 1], thr[k] = v + f * reach, v - f * reach
    return thr.to(dev)


def noisy_adversarial_cases(torch, dev):
    """Phase 4b's cases for the kernel's skip: (tag, m, k, n, rows, noise,
    fill, thr).  Dense operands (every count is `rows`: no element is free),
    zero operands (every element free), thresholds a hair inside and
    outside a count's band edge (linear and triode regime, mismatch and
    comparator offset), mismatch 1.0, rows 16 and 3."""
    from repro_torch.core.constants import MC_SIGMA_VK
    from repro_torch.kernels.bitplane_mac.ops import physics_thresholds
    from repro_torch.kernels.common import U1_GRID, radius

    zmax = float(radius(U1_GRID - 1))
    cal = dict(mismatch_sigma=MC_SIGMA_VK)
    big = dict(mismatch_sigma=1.0)
    off = dict(comparator_offset_sigma=0.03)
    good = physics_thresholds(8, dev)
    detuned = torch.cat([torch.tensor([1.9], device=dev), good[:-1]])
    cases = [("dense", 4, 768, 768, 8, cal, 255, None),
             ("dense", 4, 768, 768, 8, STRESS, 255, None),
             # the tensor-core kernel (M >= 9)
             ("dense", 64, 768, 768, 8, cal, 255, None),
             ("dense", 41, 768, 256, 8, STRESS, 255, None),
             ("dense", 9, 300, 200, 8, dict(mismatch_sigma=0.3), 255, None),
             ("dense", 47, 300, 200, 8, dict(mismatch_sigma=0.3), 255, None),
             ("dense, detuned", 64, 768, 256, 8, cal, 255, detuned),
             ("detuned", 64, 768, 768, 8, cal, None, detuned),
             ("detuned", 64, 768, 256, 8, STRESS, None, detuned),
             ("zero", 64, 300, 200, 8, STRESS, 0, None),
             ("mismatch 1.0", 17, 768, 768, 8, big, None, None),
             ("mismatch 1.0", 64, 768, 768, 8, big, None, None),
             ("mismatch 1.0 + offset", 41, 768, 256, 8,
              dict(big, comparator_offset_sigma=0.03), None, None),
             ("dense", 4, 768, 768, 8, dict(mismatch_sigma=0.3), 255, None),
             ("dense", 4, 768, 256, 16, cal, 255, None),
             ("dense", 4, 300, 200, 3, STRESS, 255, None),
             ("zero", 4, 768, 768, 8, cal, 0, None),
             ("zero", 4, 768, 768, 8, STRESS, 0, None),
             ("mismatch 1.0", 4, 768, 768, 8, big, None, None),
             ("mismatch 1.0 + offset", 4, 768, 256, 8,
              dict(big, comparator_offset_sigma=0.03), None, None),
             ("rows 16", 16, 768, 256, 16, cal, None, None),
             ("rows 16", 4, 768, 256, 16, STRESS, None, None),
             ("rows 3", 4, 300, 200, 3, cal, None, None),
             ("rows 3", 4, 300, 200, 3, STRESS, None, None)]
    for k in (3, 6):  # linear and triode regime
        reach = MC_SIGMA_VK * k ** 0.5 * zmax
        for f, where in ((0.999, "inside"), (1.001, "outside")):
            for m in (4, 48):  # the 8-row-tile kernel and the tensor-core one
                cases.append((f"hair {where} count {k}", m, 768, 768, 8, cal,
                              None, hair_thresholds(torch, dev, 8, k, reach,
                                                    f)))
    for f, where in ((0.999, "inside"), (1.001, "outside")):
        for m in (4, 64):
            cases.append((f"offset hair {where} count 3", m, 768, 768, 8, off,
                          None, hair_offsets(torch, dev, 8, 3, 0.03 * zmax,
                                             f)))
    return cases


# rbl_decode_mac's edge cases: (m, k, n, rows, byte offsets of a and w);
# every rows in {2, 3, 7, 8, 9, 16, 31, 32}, M in {1, 4, 5, 16, 17, 64,
# 200}, N in {1, 31, 129, 3072} and K in {3, 8, 100, 1030, 3072} appears,
# and operand views at byte offsets 1 and 4
RBL_EDGE_CASES = ((1, 3, 1, 2, (0, 0)), (4, 8, 31, 3, (1, 4)),
                  (5, 100, 129, 7, (4, 1)), (16, 1030, 3072, 8, (0, 0)),
                  (17, 3072, 1, 9, (1, 1)), (64, 3, 31, 16, (4, 4)),
                  (200, 8, 129, 31, (0, 1)), (1, 100, 3072, 32, (1, 0)),
                  (4, 1030, 1, 2, (0, 4)), (5, 3072, 31, 3, (4, 0)),
                  (16, 3, 129, 7, (0, 0)), (17, 8, 3072, 8, (1, 4)),
                  (64, 100, 1, 9, (0, 0)), (200, 1030, 31, 16, (1, 1)),
                  (1, 3072, 129, 31, (4, 1)), (4, 3, 3072, 32, (0, 0)),
                  (64, 768, 3072, 8, (1, 4)), (4, 3072, 768, 32, (4, 1)))


def rbl_thresholds(torch, dev, rows, g):
    """Calibrated, detuned (``[1.9, thr[:-1]]``: every count reads one level
    high, a zero count decodes to 1) and random (descending between V(rows)
    and V(0)) comparator references."""
    from repro_torch.core.rbl import rbl_voltage_physics
    from repro_torch.kernels.bitplane_mac.ops import physics_thresholds

    good = physics_thresholds(rows, dev)
    detuned = torch.cat([torch.tensor([1.9], device=dev), good[:-1]])
    v = rbl_voltage_physics(torch.tensor([0.0, float(rows)]), rows=rows)
    lo, hi = float(v[1]), float(v[0])
    rand = torch.rand((rows,), generator=g, device=dev) * (hi - lo) + lo
    return {"calibrated": good, "detuned": detuned,
            "random": torch.sort(rand, descending=True).values}


def phase_rbl_decode_mac(torch, dev):
    from repro_torch.kernels.bitplane_mac.ops import physics_thresholds
    from repro_torch.kernels.rbl_decode.ops import (compiled_plan,
                                                    rbl_decode_mac,
                                                    rbl_decode_mac_plan,
                                                    rbl_decode_mac_torch)

    g = torch.Generator(device=dev).manual_seed(22)
    # (m, k, n, rows): one plane pair of each demonstrator projection
    cases = [(m, k, n, 8) for m in (4, 64)
             for k, n in ((768, 768), (768, 3072), (3072, 768))]
    cases += [(50, 70, 30, 8), (24, 160, 8, 16), (64, 768, 768, 16)]
    worst = 0
    for i, (m, k, n, rows) in enumerate(cases):
        ua = torch.randint(0, 256, (m, k), generator=g, device=dev,
                           dtype=torch.int32)
        uw = torch.randint(0, 256, (k, n), generator=g, device=dev,
                           dtype=torch.int32)
        a = ((ua >> (i % 8)) & 1).to(torch.int8)  # plane p of the codes
        w = ((uw >> (7 - i % 8)) & 1).to(torch.int8)  # plane q
        good = physics_thresholds(rows, dev)
        detuned = torch.cat([torch.tensor([1.9], device=dev), good[:-1]])
        out = rbl_decode_mac(a, w, rows=rows)
        bad = rbl_decode_mac(a, w, detuned, rows=rows)
        torch.cuda.synchronize()
        for got, thr in ((out, good), (bad, detuned)):
            plain = rbl_decode_mac_torch(a, w, thr, rows=rows)
            worst = max(worst, (got - plain).abs().max().item())
            if not torch.equal(got, plain):
                raise AssertionError(f"rbl_decode_mac differs from its plain "
                                     f"version at {(m, k, n, rows)}")
        if not torch.equal(out, (a.double() @ w.double()).to(torch.int32)):
            raise AssertionError(f"rbl_decode_mac under calibrated thresholds"
                                 f" is not the integer product at "
                                 f"{(m, k, n, rows)}")
        if torch.equal(bad, out):
            raise AssertionError("detuned thresholds did not change the "
                                 "decode: the kernel ignores thr")
    # the edge cases: operands as views at byte offsets of larger buffers,
    # every byte drawn from 0-255 (the kernel counts bit 0; the plain version
    # gets x & 1); one launch per call; the C plan equal to the Python one
    for m, k, n, rows, (oa, ow) in RBL_EDGE_CASES:
        plan = rbl_decode_mac_plan(m, n, k, rows)
        if compiled_plan(m, n, k, rows) != plan:
            raise AssertionError(f"rbl_decode_mac_plan{(m, n, k, rows)}: C "
                                 f"{compiled_plan(m, n, k, rows)} != Python "
                                 f"{plan}")
        fa, fw = (torch.randint(0, 256, (size + off,), generator=g,
                                device=dev, dtype=torch.int32).to(torch.uint8)
                  for size, off in ((m * k, oa), (k * n, ow)))
        a, w = fa[oa:].view(m, k), fw[ow:].view(k, n)
        bits = (a & 1, w & 1)
        outs = {}
        for name, thr in rbl_thresholds(torch, dev, rows, g).items():
            before = rbl_decode_mac.launches
            outs[name] = rbl_decode_mac(a, w, thr, rows=rows)
            torch.cuda.synchronize()
            if rbl_decode_mac.launches != before + 1:
                raise AssertionError("rbl_decode_mac: one call, one launch")
            plain = rbl_decode_mac_torch(*bits, thr, rows=rows)
            worst = max(worst, (outs[name] - plain).abs().max().item())
            if not torch.equal(outs[name], plain):
                raise AssertionError(
                    f"rbl_decode_mac differs from its plain version at "
                    f"{(m, k, n, rows)}, offsets {(oa, ow)}, {name} thr")
        exact = (bits[0].double() @ bits[1].double()).to(torch.int32)
        if not torch.equal(outs["calibrated"], exact):
            raise AssertionError(f"rbl_decode_mac calibrated is not the "
                                 f"integer product at {(m, k, n, rows)}")
        if torch.equal(outs["detuned"], exact):
            raise AssertionError("detuned thresholds did not change the "
                                 f"decode at {(m, k, n, rows)}")
    # one launch captured in a CUDA graph and replayed twice: the cluster's
    # meeting leaves nothing to reset
    a = torch.randint(0, 2, (4, 3072), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(0, 2, (3072, 768), generator=g, device=dev,
                      dtype=torch.int8)
    thr = rbl_thresholds(torch, dev, 8, g)["random"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rbl_decode_mac(a, w, thr)  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rbl_decode_mac(a, w, thr)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, rbl_decode_mac_torch(a, w, thr)):
        raise AssertionError("rbl_decode_mac differs from its plain version "
                             "after two graph replays")
    log(f"[4c] rbl_decode_mac bit-exact on {len(cases)} cases, calibrated "
        f"and detuned, and on {len(RBL_EDGE_CASES)} edge cases (rows 2-32, "
        "views at byte offsets 1 and 4, bytes 0-255), calibrated, detuned "
        "and random; calibrated equals the integer product; C plan == "
        f"Python plan; a graph replayed twice; SASS {rbl_sass()}")
    return float(worst)


def phase_flash_attn(torch, dev):
    from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                    flash_attention_torch)

    g = torch.Generator(device=dev).manual_seed(4)
    worst = {}
    n = 0
    for dtype in ("f32", "bf16"):
        dt = torch.float32 if dtype == "f32" else torch.bfloat16
        for window in (0, 16):
            for H, KV, hd in ((12, 12, 64), (16, 2, 128), (4, 2, 32),
                              (4, 2, 24), (16, 1, 256)):
                for S in (16, 40, 64, 1, 15, 17, 100):
                    q, k, v = (torch.randn((1, S, h, hd), generator=g,
                                           device=dev).to(dt)
                               for h in (H, KV, KV))
                    before = read_counts()
                    out = flash_attention(q, k, v, window=window)
                    torch.cuda.synchronize()
                    check_attn_dispatch(before, {
                        "flash_attn": 1, flash_variant(dtype, hd): 1},
                        f"[5] flash_attn {dtype} hd={hd}")
                    ref = flash_attention_torch(q, k, v, window=window)
                    if not bool(torch.isfinite(out).all()):
                        raise AssertionError("flash_attn output is not finite")
                    err = (out.float() - ref.float()).abs().max().item()
                    worst[dtype] = max(worst.get(dtype, 0.0), err)
                    if err > FLASH_ATOL[dtype]:
                        raise AssertionError(
                            f"flash_attn {dtype} window={window} rep={H // KV}"
                            f" S={S}: max err {err} > {FLASH_ATOL[dtype]}")
                    n += 1
    log(f"[5] flash_attn within bounds on {n} cases; worst {worst}")
    return max(worst.values()), worst


def zero_counts():
    from repro_torch.kernels import launches

    launches.zero()


def read_counts():
    """Every launch counter (``repro_torch.kernels.launches.KERNELS``, the
    table the Engine counts replays by): each kernel's under its name, and
    each of the imc_mac and attention wrappers' two kernels apart."""
    from repro_torch.kernels import launches

    return launches.read()


def device_launches(torch, fn):
    """``fn()`` under ``torch.profiler``, and the port's kernels it ran on
    the device, counted by ``read_counts``'s keys from the names of the
    kernels the profiler traced (a graph replay's kernels among them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import launches

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, launches.device_counts(
        (e.key, e.count) for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA)


def first_prefill(torch, dev, params, cfg, prompt, noise_seed=None,
                  bucket=16):
    """The first request's bucketed prefill logits (f32, on the CPU)."""
    import numpy as np

    from repro_torch.models.model import prefill

    padded = np.zeros((1, bucket), np.int32)
    padded[0, :len(prompt)] = prompt
    with torch.inference_mode():
        logits, _ = prefill(params, {"tokens": torch.from_numpy(padded).to(
            dev), "length": len(prompt)}, cfg, noise_seed=noise_seed)
    return logits.float().cpu()


def rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def serve_once(torch, dev, engine, cfg, params, prompts, tag, must,
               never=(), fail_at=None):
    """Serve the requests once through a ``Server`` on ``engine``; every
    launch counter is zeroed just before and read just after.  Each kernel
    in ``must`` has to launch, each in ``never`` and in ``MACRO_KERNELS``
    must not."""
    from repro_torch.launch.serve import slo_summary
    from repro_torch.launch.server import Request, Server
    from repro_torch.telemetry import Registry

    never = tuple(never) + MACRO_KERNELS
    server = Server(cfg, params, engine=engine, slots=4, kv="paged",
                    block_size=16, buckets=(16, 32, 64), registry=Registry(),
                    fail_at=fail_at)
    captures, replays = engine.stats.captures, engine.stats.replays
    zero_counts()
    t0 = time.perf_counter()
    handles = [server.submit(Request(p, max_new_tokens=MAX_NEW))
               for p in prompts]
    server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    if not all(h.done and len(h.tokens) == MAX_NEW for h in handles):
        raise AssertionError(f"{tag}: not every request finished with its "
                             "tokens")
    for name in must:
        if launches[name] <= 0:
            raise AssertionError(f"{tag}: the path launched {name} no time")
    for name in never:
        if launches[name] != 0:
            raise AssertionError(f"{tag}: the path launched {name} "
                                 f"{launches[name]} times, it must not")
    server.alloc.check()
    slos = slo_summary(server)
    run = {"launches": launches, "slos": slos, "wall_s": wall,
           "decode_ticks": server.decode_ticks,
           "recoveries": server.recoveries,
           "captures": engine.stats.captures - captures,
           "replays": engine.stats.replays - replays,
           "streams": [h.tokens for h in handles]}
    t, p = slos["ttft_ms"], slos["tpot_ms"]
    log(f"[6] {tag}: served {len(handles)} requests in {wall:.2f} s, "
        f"{server.decode_ticks} decode ticks, {run['captures']} "
        f"{'captures' if engine.graphs else 'bindings'}, {run['replays']} "
        f"{'replays' if engine.graphs else 'eager steps'}; TTFT p50/p95 {t['p50']:.2f}/"
        f"{t['p95']:.2f} ms, TPOT p50/p95 {p['p50']:.2f}/{p['p95']:.2f} ms,"
        f" decode {slos['decode_tokens_per_s']:.1f} tok/s; launches "
        f"{launches}")
    return server, run


def serve_path(torch, dev, cfg, params, prompts, tag, must, never=(),
               noise_seed=0, prefill64=False):
    """Serve the six requests four times, in turns: through an
    ``Engine(graphs=False)`` (eager steps, the oracle), an ``Engine``
    (CUDA graphs), the graph engine again and the eager one again.  The
    four token streams must be equal; the graph engine captures one prefill
    and one admission graph per bucket used and one decode graph, and none
    on its second serve; its second serve (replays only) launches what the
    eager serve launches.  Then a ``fail_at`` drill through the graph
    engine: no capture, and the streams of the run without a fault (noisy:
    of the same drill through the eager engine).  Last, one decode step and
    one bucket-16 prefill replayed from the graph engine's graphs under
    ``torch.profiler``: the port's kernels the device ran, counted by name,
    must equal the launches the graphs' captures recorded (which every
    replay adds to the counters), so a kernel missing from a graph or in it
    twice fails here.  ``prefill64``: a bucket-64 prefill (the third
    prompt's) is replayed and counted the same way."""
    import numpy as np

    from repro_torch.kernels.common import mix_seed
    from repro_torch.launch.engine import Engine
    from repro_torch.telemetry import Registry

    engines = {"eager": Engine(dev, noise_seed=noise_seed,
                               registry=Registry(), graphs=False),
               "graph": Engine(dev, noise_seed=noise_seed,
                               registry=Registry())}
    if engines["eager"].graphs or not engines["graph"].graphs:
        raise AssertionError(f"{tag}: the engines' graphs are not as asked")
    runs = {}
    for name in ("eager", "graph", "graph2", "eager2"):
        _, runs[name] = serve_once(torch, dev, engines[name.rstrip("2")],
                                   cfg, params, prompts, f"{tag} {name}",
                                   must, never)
    streams = runs["eager"]["streams"]
    for name, run in runs.items():
        if run["streams"] != streams:
            raise AssertionError(f"{tag}: the {name} serve's token streams "
                                 "differ from the eager serve's")
    buckets = {next(b for b in (16, 32, 64) if len(p) <= b) for p in prompts}
    want = 2 * len(buckets) + 1
    if runs["graph"]["captures"] != want or runs["graph2"]["captures"]:
        raise AssertionError(
            f"{tag}: {runs['graph']['captures']} and "
            f"{runs['graph2']['captures']} captures in the two graph serves;"
            f" expected {want} (prefill + admission per bucket of "
            f"{sorted(buckets)}, one decode) and 0")
    if runs["graph2"]["launches"] != runs["eager"]["launches"]:
        raise AssertionError(f"{tag}: the replayed serve launched "
                             f"{runs['graph2']['launches']}, the eager one "
                             f"{runs['eager']['launches']}")
    graph = engines["graph"]
    server, drill = serve_once(torch, dev, graph, cfg, params, prompts,
                               f"{tag} graph, fail_at=(1,)", must, never,
                               fail_at=(1,))
    if drill["recoveries"] != 1 or drill["captures"]:
        raise AssertionError(f"{tag}: the drill recovered "
                             f"{drill['recoveries']} times with "
                             f"{drill['captures']} captures; expected 1, 0")
    if cfg.imc_fabric is not None and cfg.imc_fabric.noisy:
        _, edrill = serve_once(torch, dev, engines["eager"], cfg, params,
                               prompts, f"{tag} eager, fail_at=(1,)", must,
                               never, fail_at=(1,))
        want_drill = edrill["streams"]
    else:
        want_drill = streams
    if drill["streams"] != want_drill:
        raise AssertionError(f"{tag}: the drill's streams differ")

    captures = graph.stats.captures
    padded = np.zeros((1, 16), np.int32)
    padded[0, :len(prompts[0])] = prompts[0]
    replays = {
        "decode step": lambda: graph.decode_step(cfg)(
            (params, server.cache), {"token": np.zeros((4, 1), np.int32),
                                     "block_table": server.alloc.table()},
            graph.noise_seed(1 << 20)),
        "prefill": lambda: graph.prefill_step(cfg, 0, 16)((params,), {
            "tokens": padded, "length": np.int32(len(prompts[0]))},
            graph.noise_seed(0, 0))[0].float().cpu()}
    if prefill64:
        padded64 = np.zeros((1, 64), np.int32)
        padded64[0, :len(prompts[2])] = prompts[2]
        replays["bucket-64 prefill"] = lambda: graph.prefill_step(
            cfg, 0, 64)((params,), {"tokens": padded64, "length": np.int32(
                len(prompts[2]))}, graph.noise_seed(0, 2))[0].float().cpu()
    counted = {}
    for what, fn in replays.items():
        # a graph launches the same kernels on every replay: up to three
        # profiled replays, any short count logged (the profiler has
        # missed kernels of a replayed graph: 6 of 8 once, in a run whose
        # earlier call on the same graph saw all 8)
        for attempt in range(3):
            zero_counts()
            out, seen = device_launches(torch, fn)
            counted[what] = read_counts()
            if seen == counted[what]:
                break
            log(f"[6] {tag}: profiled replay {attempt} of the {what} saw "
                f"{seen}, its capture recorded {counted[what]}")
        else:
            raise AssertionError(
                f"{tag}: the replayed {what} launched {seen} on the device "
                f"(the profiler's kernels), its capture recorded "
                f"{counted[what]}")
        if what == "prefill":
            replayed = out
    per_step, per_prefill = counted["decode step"], counted["prefill"]
    if graph.stats.captures != captures:
        raise AssertionError(f"{tag}: counting a step captured a graph")
    first = first_prefill(torch, dev, params, cfg, prompts[0],
                          noise_seed=mix_seed(noise_seed, 0, 0))
    if not torch.equal(replayed, first):
        raise AssertionError(f"{tag}: the replayed prefill's logits differ "
                             "from the eager prefill's")
    if streams[0][0] != int(first[0].argmax()):
        raise AssertionError(f"{tag}: the server's first token is not the "
                             "argmax of its prefill logits")
    log(f"[6] {tag}: eager, graph, graph, eager and the drill serve equal "
        f"streams; {want} captures, then none; one decode step replayed "
        f"launches {per_step}")
    return {"launches": runs["graph2"]["launches"],
            "launches_eager": runs["eager"]["launches"],
            "per_decode_step": per_step, "per_prefill": per_prefill,
            "per_prefill_64": counted.get("bucket-64 prefill"),
            "slos": {k: r["slos"] for k, r in runs.items()},
            "wall_s": {k: r["wall_s"] for k, r in runs.items()},
            "captures": runs["graph"]["captures"],
            "replays": runs["graph2"]["replays"],
            "decode_ticks": runs["graph"]["decode_ticks"],
            "drill_slos": drill["slos"], "streams": streams}, first


def served_model(torch, dev):
    """Phase 6's model (full-width imc-paper-110m, random weights from seed
    0) and its six prompts."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    cfg = get_config("imc-paper-110m")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    log(f"[6] imc-paper-110m params ({cfg.n_params() / 1e6:.1f} M) on "
        f"{dev} in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    return cfg, params, prompts


def noisy_config(cfg):
    """Phase 6c's configuration: sim with the calibrated noise, flash
    prefill."""
    import dataclasses

    from repro_torch.core.fabric import FabricSpec, NoiseSpec

    return dataclasses.replace(cfg, use_flash_kernel=True, fabric=FabricSpec(
        mode="sim", noise=NoiseSpec.calibrated()))


def serve_noisy(torch, dev):
    """Phase 6c's first serve alone: its token streams, SLOs and launches
    (``--serve-noisy``, to hold two trees' streams against each other)."""
    cfg, params, prompts = served_model(torch, dev)
    noisy, _ = serve_path(torch, dev, noisy_config(cfg), params, prompts,
                          "sim+noise+flash", ("bitplane_mac_noisy",),
                          noise_seed=NOISE_SEED)
    return {k: noisy[k] for k in ("streams", "slos", "per_decode_step",
                                  "wall_s")}


def log_turns(tag, res):
    """The four serves' SLOs side by side: eager, graph, graph, eager."""
    def fmt(v):
        return "none" if v is None else f"{v:.2f}"

    parts = []
    for name, slo in res["slos"].items():
        parts.append(f"{name} TTFT p50/p95 {fmt(slo['ttft_ms'].get('p50'))}/"
                     f"{fmt(slo['ttft_ms'].get('p95'))} ms, TPOT p50/p95 "
                     f"{fmt(slo['tpot_ms'].get('p50'))}/"
                     f"{fmt(slo['tpot_ms'].get('p95'))} ms, "
                     f"{fmt(slo['decode_tokens_per_s'])} tok/s")
    log(f"[6] {tag} in turns: " + "; ".join(parts))


def phase_server(torch, dev):
    import dataclasses

    from repro_torch.core.fabric import FabricSpec, NoiseSpec
    from repro_torch.models.model import prefill

    cfg, params, prompts = served_model(torch, dev)

    # a. exact fabric
    exact, card = serve_path(torch, dev, cfg, params, prompts, "exact",
                             must=("imc_mac", "paged_attn"),
                             never=("bitplane_mac", "flash_attn",
                                    "bitplane_mac_noisy", "paged_attn_staged"))
    log_turns("exact", exact)
    # decode's 72 projections (4 slots) take the split-K kernel only
    step = exact["per_decode_step"]
    if step["imc_mac_split"] != 6 * cfg.n_layers or step["imc_mac_tiled"]:
        raise AssertionError(f"exact: {step['imc_mac_split']} split-K and "
                             f"{step['imc_mac_tiled']} tensor-core imc_mac "
                             f"launches per decode step; expected "
                             f"{6 * cfg.n_layers} and 0")
    # a bucket-32 and a bucket-64 prefill take the tensor-core kernel only
    for bucket, prompt in ((32, prompts[5][:20]), (64, prompts[2])):
        zero_counts()
        first_prefill(torch, dev, params, cfg, prompt, bucket=bucket)
        counts = read_counts()
        if counts["imc_mac_tiled"] != 6 * cfg.n_layers or \
                counts["imc_mac_split"]:
            raise AssertionError(
                f"exact: a bucket-{bucket} prefill launched "
                f"{counts['imc_mac_tiled']} tensor-core and "
                f"{counts['imc_mac_split']} split-K imc_mac kernels; "
                f"expected {6 * cfg.n_layers} and 0")
        exact[f"per_prefill_{bucket}"] = counts
    # its first prefill: card vs the plain path on the CPU
    with torch.inference_mode():
        padded = torch.zeros((1, 16), dtype=torch.int32)
        padded[0, :PROMPTS[0]] = torch.from_numpy(prompts[0])
        cpu_params = _to_cpu(params)
        plain, _ = prefill(cpu_params, {"tokens": padded,
                                             "length": PROMPTS[0]}, cfg)
    err = (card - plain).abs().max().item()
    scale = plain.abs().max().item()
    if not err <= LOGIT_RTOL * scale:
        raise AssertionError(f"prefill logits card vs CPU: max err {err} > "
                             f"{LOGIT_RTOL} x {scale}")
    log(f"[6] exact: prefill logits card vs CPU plain path: max err "
        f"{err:.3g} (largest |logit| {scale:.3g}); top-1 "
        f"{'equal' if int(card.argmax()) == int(plain.argmax()) else 'DIFFERS'}")
    exact.update(logit_err=err, logit_scale=scale)

    # b. the paper's sim fabric with flash prefill
    sim_cfg = dataclasses.replace(cfg, fabric=FabricSpec(mode="sim"),
                                  use_flash_kernel=True)
    sim, sim_flash = serve_path(
        torch, dev, sim_cfg, params, prompts, "sim+flash",
        must=("bitplane_mac", "bitplane_mac_mma", "flash_attn", "paged_attn"),
        never=("imc_mac", "bitplane_mac_noisy", "flash_attn_simt",
               "paged_attn_staged"), prefill64=True)
    log_turns("sim+flash", sim)
    # bitplane_mac: the prefills (M = bucket > 8) take the tensor-core
    # kernel, 72 launches each, counted from the replayed bucket-16 and
    # bucket-64 graphs on the device and from eager bucket-32 and -64
    # prefills; the decode step (M = 4) the r8 kernel alone
    n_proj = 6 * cfg.n_layers
    step = sim["per_decode_step"]
    if step["bitplane_mac"] != n_proj or step["bitplane_mac_mma"]:
        raise AssertionError(f"sim+flash: {step['bitplane_mac']} bitplane_mac"
                             f" launches per decode step, "
                             f"{step['bitplane_mac_mma']} of the tensor-core "
                             f"kernel; expected {n_proj} and 0")
    for bucket, prompt in ((32, prompts[5][:20]), (64, prompts[2])):
        zero_counts()
        first_prefill(torch, dev, params, sim_cfg, prompt, bucket=bucket)
        sim[f"per_prefill_{bucket}_eager"] = read_counts()
    for what in ("per_prefill", "per_prefill_64", "per_prefill_32_eager",
                 "per_prefill_64_eager"):
        c = sim[what]
        if c["bitplane_mac_mma"] != n_proj or c["bitplane_mac"] != n_proj:
            raise AssertionError(
                f"sim+flash: {what} launched {c['bitplane_mac']} bitplane_mac,"
                f" {c['bitplane_mac_mma']} of the tensor-core kernel; "
                f"expected {n_proj} of it and nothing else")
    # the redesigned kernels carry the served path: 12 layers, 12 launches
    # of each per bucketed prefill and per decode step
    for per, new, old in (("per_prefill", "flash_attn_tc", "flash_attn_simt"),
                          ("per_decode_step", "paged_attn_split",
                           "paged_attn_staged")):
        if sim[per][new] != cfg.n_layers or sim[per][old] != 0:
            raise AssertionError(f"sim+flash: {sim[per]} {per}; expected "
                                 f"{cfg.n_layers} launches of {new} and "
                                 f"none of {old}")
    sim_dense = first_prefill(torch, dev, params, dataclasses.replace(
        sim_cfg, use_flash_kernel=False), prompts[0])
    if not torch.equal(sim_dense, card):
        diff = (sim_dense - card).abs().max().item()
        raise AssertionError(f"sim prefill logits differ from exact's on the "
                             f"card (max diff {diff}); the noise-free decode "
                             "must be exact")
    # sim == exact bit for bit, so the plain CPU path with exact fabric and
    # flash attention computes what the card's sim + flash path computes
    with torch.inference_mode():
        plain_flash, _ = prefill(
            cpu_params, {"tokens": padded, "length": PROMPTS[0]},
            dataclasses.replace(cfg, use_flash_kernel=True))
    flash_err = (sim_flash - plain_flash).abs().max().item()
    if not flash_err <= LOGIT_RTOL * scale:
        raise AssertionError(f"sim+flash prefill logits card vs CPU: max err "
                             f"{flash_err} > {LOGIT_RTOL} x {scale}")
    if int(sim_flash.argmax()) != int(card.argmax()):
        raise AssertionError("sim+flash prefill top-1 differs from exact's")
    # flash vs dense attention, on the card and in the plain path on the
    # CPU: the same gap in both is the attention's, not a kernel's
    # (flash keeps the probabilities in f32, dense attention rounds them to
    # bf16 before p @ v, and every later projection requantizes)
    rel = ((sim_flash - card).norm() / card.norm()).item()
    rel_plain = ((plain_flash - plain).norm() / plain.norm()).item()
    dense_err = (sim_flash - card).abs().max().item()
    log(f"[6] sim+flash: sim prefill logits (flash off) bit-identical to "
        f"exact; with flash, card vs CPU max err {flash_err:.3g}, top-1 equal "
        f"to exact; flash vs dense attention: relative {rel:.4g} on the card,"
        f" {rel_plain:.4g} in the plain path (max err {dense_err:.3g})")
    sim.update(logit_err=flash_err, logit_scale=scale,
               rel_vs_dense=rel, rel_vs_dense_plain=rel_plain,
               max_err_vs_dense=dense_err)

    # c. the paper's sim fabric with its calibrated noise, flash prefill
    noisy_cfg = noisy_config(cfg)
    must = ("bitplane_mac_noisy", "flash_attn", "paged_attn")
    never = ("imc_mac", "bitplane_mac", "flash_attn_simt",
             "paged_attn_staged")
    noisy, noisy_first = serve_path(torch, dev, noisy_cfg, params, prompts,
                                    "sim+noise+flash", must, never,
                                    noise_seed=NOISE_SEED, prefill64=True)
    log_turns("sim+noise+flash", noisy)
    # 72 launches (4 attention + 2 MLP projections a layer) a decode step
    # (M = 4: the 8-row-tile kernel) and a prefill (M = the bucket: the
    # tensor-core kernel), as the launcher reports them: the replayed
    # bucket-16 and bucket-64 graphs and eager bucket-32 and -64 prefills
    noisy_gate("sim+noise: a decode step", noisy["per_decode_step"], 4,
               n_proj)
    for bucket, prompt in ((32, prompts[5][:20]), (64, prompts[2])):
        zero_counts()
        first_prefill(torch, dev, params, noisy_cfg, prompt, bucket=bucket,
                      noise_seed=NOISE_SEED)
        noisy[f"per_prefill_{bucket}_eager"] = read_counts()
    for what, bucket in (("per_prefill", 16), ("per_prefill_64", 64),
                         ("per_prefill_32_eager", 32),
                         ("per_prefill_64_eager", 64)):
        noisy_gate(f"sim+noise: {what}", noisy[what], bucket, n_proj)
    # serve_path served it four times under one noise_seed, eagerly and
    # from graphs that read their seeds from device memory: equal streams
    stress_cfg = dataclasses.replace(sim_cfg, fabric=FabricSpec(
        mode="sim", noise=NoiseSpec(**STRESS)))
    s1, s2 = (first_prefill(torch, dev, params, stress_cfg, prompts[0],
                            noise_seed=s) for s in (1, 2))
    if torch.equal(s1, s2) or torch.equal(s1, sim_flash) or \
            torch.equal(s2, sim_flash):
        raise AssertionError("sim+noise: stress-sigma prefill logits under "
                             "two seeds must differ from each other and "
                             "from noise-free sim")
    for t in (s1, s2, noisy_first):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("sim+noise: prefill logits not finite")
    rel_cal = rel_l2(noisy_first, sim_flash)
    rel_stress = [rel_l2(s1, sim_flash), rel_l2(s2, sim_flash)]
    log(f"[6] sim+noise+flash: one noise_seed gives one stream, eager and "
        f"from graphs;"
        f" prefill logits vs noise-free sim+flash: relative L2 {rel_cal:.4g} "
        f"at the calibrated sigma, {rel_stress[0]:.4g} / {rel_stress[1]:.4g} "
        f"at the stress sigmas (seeds 1 / 2, which differ: relative L2 "
        f"{rel_l2(s1, s2):.4g} between them); top-1 "
        f"{'equal' if int(noisy_first.argmax()) == int(sim_flash.argmax()) else 'differs'}"
        " to noise-free at the calibrated sigma")
    noisy.update(rel_vs_clean_calibrated=rel_cal,
                 rel_vs_clean_stress=rel_stress)
    return {"exact": exact, "sim_flash": sim, "sim_noise": noisy}


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def phase_macro(torch, dev):
    """The paper's macro API on the card, through the ``Fabric`` facade and
    the array model, against the CPU and the digital truth; every launch
    counter is zeroed before and read after (6d)."""
    import numpy as np

    from repro_torch.core import (ArraySpec, Fabric, FabricSpec, NoiseSpec,
                                  empty_state, level_voltages, logic2, mac,
                                  read_bit, thermometer_code, write_row)
    from repro_torch.core.logic import WORD_OPS
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import launches
    from repro_torch.kernels.bitplane_mac.ops import physics_thresholds
    from repro_torch.kernels.imc_mac.ops import imc_mac_dequant
    from repro_torch.kernels.rbl_decode.ops import rbl_decode_mac

    cpu = torch.device("cpu")
    zero_counts()
    t0 = time.perf_counter()
    # Table I: voltages and thermometer codes for counts 0-8
    for mode in ("lut", "physics"):
        v, vc = (level_voltages(mode=mode, device=d) for d in (dev, cpu))
        if not (torch.equal(v.cpu(), vc) and torch.equal(
                thermometer_code(v, mode=mode).cpu(),
                thermometer_code(vc, mode=mode))):
            raise AssertionError(f"Table I {mode} voltages or codes on the "
                                 "card differ from the CPU's")
    # the array model on one 8x8 array
    rng = np.random.default_rng(0)
    b_bits = rng.integers(0, 2, size=(8, 8)).astype(np.uint8)
    a_bits = rng.integers(0, 2, size=8).astype(np.uint8)
    arrays = []
    for d in (dev, cpu):
        state = empty_state(ArraySpec(), d)
        for r in range(8):
            state = write_row(state, r, b_bits[r])
        logic, res2 = logic2(state, 0, 1)
        arrays.append([state, *mac(state, a_bits), *res2,
                       *[read_bit(state, r) for r in range(8)],
                       *[logic[op] for op in sorted(logic)]])
    if not all(torch.equal(x.cpu(), y) for x, y in zip(*arrays)):
        raise AssertionError("write_row/mac/read_bit/logic2 on the card "
                             "differ from the CPU's")
    if not np.array_equal(arrays[0][1].cpu().numpy(), a_bits @ b_bits):
        raise AssertionError("mac counts are not the true MAC counts")

    # word logic and the ripple-carry adder on 2^22 random uint8 pairs
    g = torch.Generator(device=dev).manual_seed(23)
    n_pairs = MACRO_PAIRS
    a, b = (torch.randint(0, 256, (n_pairs,), generator=g, device=dev,
                          dtype=torch.uint8) for _ in range(2))
    ai, bi = a.to(torch.int64), b.to(torch.int64)
    truth = {"AND": ai & bi, "NAND": ~(ai & bi) & 255, "OR": ai | bi,
             "NOR": ~(ai | bi) & 255, "XOR": ai ^ bi,
             "XNOR": ~(ai ^ bi) & 255}
    for mode in ("exact", "sim"):
        fab = Fabric(FabricSpec(mode=mode), dev)
        for op in WORD_OPS:
            if not torch.equal(fab.logic_word(a, b, op).to(torch.int64),
                               truth[op]):
                raise AssertionError(f"{mode} logic_word {op} is not the "
                                     "bitwise operator")
        s_, c_ = fab.add_nbit(a, b)
        if not (torch.equal(s_.to(torch.int64), (ai + bi) & 255) and
                torch.equal(c_.to(torch.int64), (ai + bi) >> 8)):
            raise AssertionError(f"{mode} add_nbit is not (a+b) mod 256 and "
                                 "its carry")
    # device mismatch at sigma 0.5: seeded, replayable, flips bits
    noisy = Fabric(FabricSpec(mode="sim", noise=NoiseSpec(
        mismatch_sigma=0.5)), dev)
    x1, x2, x3 = (noisy.logic_word(a, b, "AND", seed=s) for s in (1, 1, 2))
    n1, n2 = noisy.add_nbit(a, b, seed=1), noisy.add_nbit(a, b, seed=1)
    if not (torch.equal(x1, x2) and torch.equal(n1[0], n2[0]) and
            torch.equal(n1[1], n2[1])):
        raise AssertionError("noisy facade: one seed gave two results")
    if torch.equal(x1, x3):
        raise AssertionError("noisy facade: two seeds gave one result")
    flips = int(torch.sum(torch.stack(
        [((x1.to(torch.int64) ^ truth["AND"]) >> i) & 1 for i in range(8)])))
    flip_rate = flips / (8 * n_pairs)
    add_wrong = float(((n1[0].to(torch.int64) != (ai + bi) & 255)
                       ).float().mean())
    log(f"[6d] word logic and add_nbit on {n_pairs} uint8 pairs equal the "
        f"bitwise operators and (a+b) mod 256 in exact and sim; at mismatch "
        f"sigma 0.5 the AND bit flip rate is {flip_rate:.4f}, "
        f"{add_wrong:.4f} of the sums are wrong; seeds replay and differ")

    # Fabric.matmul at one MLP projection: which kernel each mode launches
    x = torch.randn((64, 768), generator=g, device=dev)
    w = torch.randn((768, 3072), generator=g, device=dev) * 0.05
    ys = {}
    for mode, kernel in (("exact", "imc_mac"), ("sim", "bitplane_mac")):
        before = read_counts()
        ys[mode] = Fabric(FabricSpec(mode=mode), dev).matmul(x, w)
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in read_counts().items()
                 if k in launches.KERNELS}
        if delta[kernel] != 1 or sum(delta.values()) != 1:
            raise AssertionError(f"Fabric({mode}).matmul launched {delta}; "
                                 f"expected {kernel} once and nothing else")
        if mode == "exact" and \
                read_counts()["imc_mac_tiled"] != before["imc_mac_tiled"] + 1:
            raise AssertionError("Fabric(exact).matmul at 64x768x3072 did "
                                 "not take the tensor-core imc_mac kernel")
    if not torch.equal(ys["exact"], ys["sim"]):
        raise AssertionError("noise-free sim matmul differs from exact")
    if not torch.equal(ys["exact"].cpu(), Fabric(FabricSpec(), cpu).matmul(
            x.cpu(), w.cpu())):
        raise AssertionError("exact matmul on the card differs from the CPU")
    # the fused-dequant GEMM computes the exact fabric's whole flush
    qx, qw = quantize(x, 8, axis=None), quantize(w, 8, axis=0)
    before = read_counts()["imc_mac_dequant_tiled"]
    y_dq = imc_mac_dequant(qx.q, qw.q, qx.scale, qw.scale)
    if read_counts()["imc_mac_dequant_tiled"] != before + 1:
        raise AssertionError("imc_mac_dequant at 64x768x3072 did not take "
                             "the tensor-core kernel")
    if not torch.equal(y_dq, ys["exact"]):
        raise AssertionError("imc_mac_dequant differs from Fabric(exact)."
                             "matmul at 64x768x3072")
    # and on four rows (decode's shape, the split-K kernel), with the scale
    # of those rows
    q4 = quantize(x[:4], 8, axis=None)
    if not torch.equal(imc_mac_dequant(q4.q, qw.q, q4.scale, qw.scale),
                       Fabric(FabricSpec(mode="exact"), dev).matmul(x[:4],
                                                                    w)):
        raise AssertionError("imc_mac_dequant differs from Fabric(exact)."
                             "matmul at 4x768x3072")
    # the threshold re-tuning study (paper §IV-C) on the sign planes of
    # that projection: every reference moved up by delta volts
    ua = (qx.q.to(torch.int32) + 128) >> 7
    uw = (qw.q.to(torch.int32) + 128) >> 7
    a7, w7 = ua.to(torch.int8), uw.to(torch.int8)
    exact_bits = (a7.double() @ w7.double()).to(torch.int32)
    good = physics_thresholds(8, dev)
    margins = {}
    for delta_v in SWEEP_SHIFTS:
        out = rbl_decode_mac(a7, w7, good + delta_v)
        margins[delta_v] = float((out != exact_bits).float().mean())
    if margins[0.0] != 0.0 or margins[0.01] != 0.0:
        raise AssertionError(f"calibrated or 10 mV thresholds misdecoded: "
                             f"{margins}")
    log(f"[6d] Fabric.matmul 64x768x3072 launches imc_mac (exact) or "
        f"bitplane_mac (sim) once and nothing else; imc_mac_dequant equals "
        f"Fabric(exact).matmul bit for bit; threshold shift -> share of "
        f"wrong outputs of rbl_decode_mac: {margins}")

    # Fabric.linear: STE gradients on the card and on the CPU
    gx = torch.randn((4, 768), generator=g, device=dev)
    gw = torch.randn((768, 256), generator=g, device=dev) * 0.05
    gb = torch.randn((256,), generator=g, device=dev)
    gy = torch.randn((4, 256), generator=g, device=dev)
    grads = []
    for d in (dev, cpu):
        leaves = [t.detach().to(d).clone().requires_grad_(True)
                  for t in (gx, gw, gb)]
        y = Fabric(FabricSpec(mode="sim"), d).linear(
            {"w": leaves[1], "b": leaves[2]}, leaves[0])
        (y * gy.to(d)).sum().backward()
        grads.append([y.detach()] + [t.grad for t in leaves])
    if not torch.equal(grads[0][0].cpu(), grads[1][0]):
        raise AssertionError("Fabric.linear forward differs card vs CPU")
    grad_err = max(((c.cpu() - r).abs().max() / r.abs().max()).item()
                   for c, r in zip(grads[0][1:], grads[1][1:]))
    if not grad_err <= 1e-5:
        raise AssertionError(f"STE gradients card vs CPU: relative {grad_err}")
    for xs, ws in (((4, 768), (768, 3072)), ((2, 64, 3072), (3072, 768))):
        for spec in (FabricSpec(), FabricSpec(bits_a=4, mode="sim")):
            if Fabric(spec, dev).cost(xs, ws) != Fabric(spec, cpu).cost(
                    xs, ws):
                raise AssertionError("Fabric.cost differs card vs CPU")
    launches = read_counts()
    for name in ("imc_mac_dequant", "rbl_decode_mac", "imc_mac_dequant_split",
                 "imc_mac_dequant_tiled"):
        if launches[name] <= 0:
            raise AssertionError(f"the macro path launched {name} no time")
    wall = time.perf_counter() - t0

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]]
                                       if env.get("PYTHONPATH") else []))
    t1 = time.perf_counter()
    qs = subprocess.run([sys.executable, "-m", "repro_torch.quickstart"],
                        cwd=ROOT, env=env, capture_output=True, text=True,
                        timeout=300)
    if qs.returncode != 0 or "quickstart OK" not in qs.stdout:
        raise AssertionError(f"python -m repro_torch.quickstart failed "
                             f"(rc={qs.returncode}):\n{qs.stdout[-2000:]}\n"
                             f"{qs.stderr[-2000:]}")
    log(f"[6d] STE gradients card vs CPU: relative {grad_err:.3g}; cost "
        f"equal; macro path {wall:.2f} s, launches {launches}; "
        f"python -m repro_torch.quickstart exited 0 in "
        f"{time.perf_counter() - t1:.2f} s")
    return {"launches": launches, "flip_rate_sigma_0.5": flip_rate,
            "add_wrong_sigma_0.5": add_wrong, "threshold_margins": margins,
            "ste_grad_rel_err": grad_err, "wall_s": wall}


TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 512  # 8a: train_tiny_lm's
# full-size batch and sequence
TRAIN_FAIL_AT = 5  # 8a's fault drill; ckpt_every 2 resumes from step 3
TRAIN_SIM_LAYERS, TRAIN_SIM_SEQ, TRAIN_SIM_STEPS = 2, 128, 3  # 8b, 8c
# 8c: sim's plain path takes ~1 min a (768, 3072) projection at M = 128 on
# 8 CPU cores, so the CPU holds sim at seq 16, and the card holds it equal
# to exact at seq 128
TRAIN_CPU_SIM_SEQ = 16
TRAIN_LOSS_RTOL = 1e-3  # 8c: card against the CPU's plain path
# relative L2 of a gradient leaf, card against CPU, by the params' dtype.
# With the model's bf16 params, each device's gradients carry bf16 rounding
# noise, laid down differently by the two devices' libraries: 2.33e-2
# measured at 8c's shapes (the same with cuBLAS's reduced-precision bf16
# reductions off), while each device sits ~9.5e-2 from a float64 witness
# (the card 1.007x the CPU's distance at worst).  The same params in
# float32 leave the two devices' summation orders only.
TRAIN_GRAD_RTOL = {"bfloat16": 5e-2, "float32": 1e-3}
# 8c, bf16 params: each leaf's distance from a float64 witness on the CPU
# (the same params in float64) on the card, at most this many times the
# CPU's own: the card's bf16 products are no less precise than the CPU's
TRAIN_WITNESS_RATIO = 1.5
# 8a's descent: a held batch (the stream's step TRAIN_HELD_STEP, never
# trained on) before and after TRAIN_DESCENT_STEPS steps at lr 1e-3 with
# TRAIN_DESCENT_WARMUP warmup steps.  train()'s schedule over 8 steps warms
# up for 1: its first full-lr Adam step (each element moved by ~lr) lifts
# the loss of every batch but its own, and 8 steps do not win it back.  The
# stream's next token is uniform given its past, so what can be learnt is
# the uniform prediction (loss ln V = 10.37 against ~10.82 at random init)
TRAIN_HELD_STEP = 10**6
TRAIN_DESCENT_STEPS, TRAIN_DESCENT_WARMUP = 16, 4


class plain_calls:
    """Count calls of every kernel's plain version (``launches.plains()``:
    each module's attribute, which the wrappers and the fabric engines look
    up at call time) inside the block."""

    def __enter__(self):
        from repro_torch.kernels import launches

        self.n, self.saved = 0, []
        for m, name in launches.plains().values():
            fn = getattr(m, name)
            self.saved.append((m, name, fn))

            def counted(*a, _fn=fn, **kw):
                self.n += 1
                return _fn(*a, **kw)

            setattr(m, name, counted)
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)


def train_run(torch, cfg, tag, must, per_step, steps, batch, seq, engine,
              **kw):
    """One ``repro_torch.launch.train.train`` call: every launch counter
    zeroed just before and read just after; each kernel in ``must`` must
    launch ``per_step`` times a step, every other kernel (and every plain
    version) never."""
    from repro_torch.launch.train import train

    zero_counts()
    with plain_calls() as plain:
        state, hist = train(cfg, steps=steps, global_batch=batch,
                            seq_len=seq, lr=1e-3, seed=0, engine=engine,
                            **kw)
        torch.cuda.synchronize()
    launches = read_counts()
    for name, n in launches.items():
        want = per_step * len(hist) if name in must else 0
        if n != want:
            raise AssertionError(f"{tag}: {name} launched {n} times in "
                                 f"{len(hist)} steps, want {want}")
    if plain.n:
        raise AssertionError(f"{tag}: {plain.n} calls of plain versions")
    return state, hist, launches


def profile_train_step(torch, step, params, batch, seed):
    """One train step under ``torch.profiler``: its wall time, the device's
    busy time (the kernels' summed time), the kernel launches, and the
    eight kernels that took most device time (ms and count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import deterministic
    from repro_torch.optim.adamw import init_adamw

    state = init_adamw(params)
    with deterministic():  # as train() runs its steps
        step(params, state, batch, seed)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, state, batch, seed)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    ev = prof.key_averages()
    dev_ev = [e for e in ev if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_ev) / 1e3
    launches = sum(e.count for e in ev if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))
    syncs = sum(e.count for e in ev if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize"))
    top = sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:8]
    res = dict(wall_ms=1e3 * wall, device_busy_ms=busy,
               idle_share=1 - busy / (1e3 * wall), launches=launches,
               syncs=syncs,
               top=[(e.key[:80], e.self_device_time_total / 1e3, e.count)
                    for e in top])
    log(f"[8a] one train step under the profiler: {res['wall_ms']:.1f} ms, "
        f"device busy {busy:.1f} ms (idle {res['idle_share']:.3f}), "
        f"{launches} kernel launches, {syncs} syncs; top kernels "
        + "; ".join(f"{k} {t:.2f} ms x{n}" for k, t, n in res["top"]))
    return res


def stream_batch(torch, dev, cfg, seq, batch, step):
    """The synthetic stream's (seed 0) batch of ``step`` on ``dev``."""
    from repro_torch.data.pipeline import DataConfig, SyntheticStream

    return {k: torch.from_numpy(v).to(dev) for k, v in SyntheticStream(
        DataConfig(cfg.vocab_size, seq, batch)).batch(step).items()}


def descent(torch, dev, cfg, losses):
    """8a's descent gate: the loss of a held batch (the stream's step
    ``TRAIN_HELD_STEP``, never trained on) after each of
    ``TRAIN_DESCENT_STEPS`` steps of ``Engine.train_step`` at lr 1e-3,
    warmup ``TRAIN_DESCENT_WARMUP``, batch 4 x seq 512 from random weights
    (seed 0), must end below its loss at the start.  The same held batch
    is read along train()'s own 8-step schedule (warmup 1) beside it.  An
    Engine of its own, so 8a's runs keep sharing one step."""
    from repro_torch.device import deterministic
    from repro_torch.launch.engine import Engine
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.optim.adamw import AdamWConfig, init_adamw
    from repro_torch.telemetry import Registry

    eng = Engine(dev, noise_seed=0, registry=Registry())
    held = stream_batch(torch, dev, cfg, TRAIN_SEQ, TRAIN_BATCH,
                        TRAIN_HELD_STEP)
    res = {}
    for tag, steps, warmup in (
            ("train_schedule", TRAIN_STEPS, min(20, TRAIN_STEPS // 10 + 1)),
            ("warmup", TRAIN_DESCENT_STEPS, TRAIN_DESCENT_WARMUP)):
        step = eng.train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=warmup,
                                               total_steps=steps))
        params = init_params(cfg, device=dev, seed=0)
        state = init_adamw(params)
        held_loss, fresh = [], []
        for s in range(steps + 1):
            with torch.no_grad():
                held_loss.append(float(loss_fn(params, held, cfg)[0]))
            if s == steps:
                break
            with deterministic():
                params, state, m = step(params, state, stream_batch(
                    torch, dev, cfg, TRAIN_SEQ, TRAIN_BATCH, s),
                    eng.noise_seed(s))
            fresh.append(float(m["loss"]))
        res[tag] = dict(steps=steps, warmup=warmup, held=held_loss,
                        fresh=fresh)
        log(f"[8a] descent, {steps} steps, warmup {warmup}: held batch's "
            f"loss {' '.join(f'{x:.4f}' for x in held_loss)}; each step's "
            f"own batch {' '.join(f'{x:.4f}' for x in fresh)}")
        del params, state
    if res["train_schedule"]["fresh"] != losses:
        raise AssertionError("[8a] the descent run's steps differ from "
                             "train()'s")
    held = res["warmup"]["held"]
    if not held[-1] < held[0]:
        raise AssertionError(f"[8a] the held batch's loss did not fall in "
                             f"{TRAIN_DESCENT_STEPS} steps: {held}")
    return res


def nondeterminism(torch, params, batch, cfg):
    """Which op of the train step needs the deterministic-algorithms mode:
    step 0's gradients twice without the mode (leaves that differ) and the
    device kernels a profiled gradient runs with the mode and without it
    (names only one side runs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import deterministic
    from repro_torch.models.model import loss_and_grads
    from repro_torch.tree import tree_leaves

    def kernels(det):
        with contextlib.ExitStack() as stack:
            if det:
                stack.enter_context(deterministic())
            loss_and_grads(params, batch, cfg)  # warm
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                loss_and_grads(params, batch, cfg)
                torch.cuda.synchronize()
        return {e.key[:120]: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}

    g1 = tree_leaves(loss_and_grads(params, batch, cfg)[2])
    g2 = tree_leaves(loss_and_grads(params, batch, cfg)[2])
    differ = sum(not torch.equal(x, y) for x, y in zip(g1, g2))
    on, off = kernels(True), kernels(False)
    only_on = sorted(set(on) - set(off))
    only_off = sorted(set(off) - set(on))
    log(f"[8a] without deterministic algorithms, step 0's gradients twice: "
        f"{differ} of {len(g1)} leaves differ; kernels run only without "
        f"the mode: {only_off}; only with it: {only_on}")
    return dict(leaves_differ=differ, leaves=len(g1), only_without=only_off,
                only_with=only_on)


def phase_train(torch, dev):
    """Phase 8: the training path on the card through
    ``repro_torch.launch.train.train`` (one Engine, its train step cached).

    a. ``exact``: full imc-paper-110m (12 layers, random weights from seed
       0), global batch 4 x seq 512, lr 1e-3, remat on, 8 steps with
       ``ckpt_every=2``; then the same run with a fault drill at step 5
       (raises), resumed by a second call on its checkpoints.  Final params
       and optimizer state of the resumed run equal the uninterrupted run's
       bit for bit; ``imc_mac``'s tensor-core kernel launches
       ``dense_calls`` x 2 = 144 times a step (remat runs each layer's
       forward twice), no other kernel and no plain version runs.  Step
       time p50 (steps 1-7), train tokens/s and peak device memory are
       printed.  :func:`descent` gates a held batch's loss;
       :func:`nondeterminism` names the kernels the deterministic mode
       swaps; one step is profiled (device busy, launches, top kernels).
    b. ``sim`` (noise-free) and ``sim`` with ``NoiseSpec.calibrated()``:
       full width, depth cut to 2 layers, batch 4 x seq 128, 3 steps each;
       ``bitplane_mac`` / ``bitplane_mac_noisy`` 24 launches a step.  Noisy:
       one step seed twice gives bit-identical loss and gradients, another
       step's seed another loss.
    c. Card against the CPU: the 2-layer full-width model, step 0's loss
       within ``TRAIN_LOSS_RTOL`` and each gradient leaf within
       ``TRAIN_GRAD_RTOL`` (relative L2, by the params' dtype) of the
       port's plain path on the CPU, same params and batch (remat off on
       both: it changes no bit, ``tests/test_torch_train.py``): ``exact`` at
       batch 1 x seq 128 with the model's bf16 params and with the same
       params in float32, noise-free ``sim`` at batch 1 x seq 16 (the CPU's
       plain ``sim`` takes ~1 min a projection at M = 128); on the card,
       ``sim`` at seq 128 equals ``exact`` bit for bit.  With bf16 params,
       a float64 witness (the same params in float64, on the CPU): each
       leaf's distance from it on the card at most
       ``TRAIN_WITNESS_RATIO`` x the CPU's; the card's gradients are also
       read with cuBLAS's reduced-precision bf16 reductions flipped.
    d. :func:`train_kernel_checks`: the path's kernels at its shapes.
    """
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core.fabric import FabricSpec, NoiseSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.device import deterministic
    from repro_torch.kernels.common import seed_table
    from repro_torch.launch.engine import Engine
    from repro_torch.models.model import init_params, loss_and_grads
    from repro_torch.models.transformer import dense_calls
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.fault_tolerance import InjectedFailure
    from repro_torch.telemetry import Registry
    from repro_torch.tree import tree_leaves, tree_map

    out = {}
    cfg = get_config("imc-paper-110m")
    eng = Engine(dev, noise_seed=0, registry=Registry())
    per_step = 2 * dense_calls(cfg)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        whole, hist, launches = train_run(
            torch, cfg, "[8a] exact", ("imc_mac", "imc_mac_tiled"), per_step,
            TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, eng,
            ckpt_root=os.path.join(root, "whole"), ckpt_every=2)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = [m["loss"] for m in hist]
        step_ms = [1e3 * m["step_s"] for m in hist[1:]]
        p50 = statistics.median(step_ms)
        tok_s = TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3)
        log(f"[8a] exact: imc-paper-110m trained {TRAIN_STEPS} steps "
            f"(batch {TRAIN_BATCH} x seq {TRAIN_SEQ}) in {wall:.2f} s with "
            f"checkpoints every 2; loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"({' '.join(f'{x:.4f}' for x in losses)}); step p50 "
            f"{p50:.2f} ms (steps 1-{TRAIN_STEPS - 1}: "
            f"{' '.join(f'{x:.1f}' for x in step_ms)}), "
            f"{tok_s:.0f} train tokens/s, peak device memory "
            f"{peak / 2**30:.2f} GiB; {launches['imc_mac_tiled']} "
            f"tensor-core imc_mac launches ({per_step} a step)")
        step = eng.train_step(cfg, AdamWConfig(
            lr=1e-3, warmup_steps=min(20, TRAIN_STEPS // 10 + 1),
            total_steps=TRAIN_STEPS))
        p0 = init_params(cfg, device=dev, seed=0)
        b0 = stream_batch(torch, dev, cfg, TRAIN_SEQ, TRAIN_BATCH, 0)
        out["descent"] = descent(torch, dev, cfg, losses)
        out["nondeterminism"] = nondeterminism(torch, p0, b0, cfg)
        out["profile"] = profile_train_step(torch, step, p0, b0,
                                            eng.noise_seed(0))
        del p0
        drill = os.path.join(root, "drill")
        t0 = time.perf_counter()
        try:
            train_run(torch, cfg, "[8a] drill", ("imc_mac", "imc_mac_tiled"),
                      per_step, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, eng,
                      ckpt_root=drill, ckpt_every=2,
                      fail_at={TRAIN_FAIL_AT})
            raise AssertionError("[8a] the drill did not fail")
        except InjectedFailure:
            pass
        resumed, hist2, _ = train_run(
            torch, cfg, "[8a] resumed", ("imc_mac", "imc_mac_tiled"),
            per_step, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, eng,
            ckpt_root=drill, ckpt_every=2)
        drill_s = time.perf_counter() - t0
        a, b = tree_leaves(whole), tree_leaves(resumed)
        same = sum(x.dtype == y.dtype and torch.equal(x, y)
                   for x, y in zip(a, b))
        if same != len(a) or len(hist2) != TRAIN_STEPS - 4:
            raise AssertionError(f"[8a] the resumed run differs: {same} of "
                                 f"{len(a)} leaves equal, {len(hist2)} "
                                 "steps after the resume")
        if eng.stats.compiles != 1:
            raise AssertionError("[8a] the three runs must share one step")
        log(f"[8a] fault drill at step {TRAIN_FAIL_AT}: resumed from step 3, "
            f"{len(hist2)} steps, final params and optimizer state equal to "
            f"the uninterrupted run's bit for bit ({same} leaves), "
            f"{drill_s:.2f} s")
        out["exact"] = dict(losses=losses, step_ms=step_ms, step_p50_ms=p50,
                            tokens_per_s=tok_s, peak_bytes=peak, wall_s=wall,
                            launches_per_step=per_step,
                            launches=launches["imc_mac"],
                            resumed_bit_exact=True, drill_s=drill_s)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # b. sim and noisy sim at full width, 2 layers
    small = dataclasses.replace(cfg, n_layers=TRAIN_SIM_LAYERS)
    per_step = 2 * dense_calls(small)
    noisy_spec = FabricSpec(mode="sim", noise=NoiseSpec.calibrated())
    # (M = batch x seq = 512: sim's projections take bitplane_mac's
    # tensor-core kernel, noisy sim's bitplane_mac_noisy's; train_run holds
    # every counter to its must list, the launchers' reports among them)
    for tag, spec, must in (
            ("sim", FabricSpec(mode="sim"),
             ("bitplane_mac", "bitplane_mac_mma")),
            ("noisy", noisy_spec,
             ("bitplane_mac_noisy", "bitplane_mac_noisy_mma"))):
        kernel = must[0]
        c = dataclasses.replace(small, fabric=spec)
        t0 = time.perf_counter()
        _, hist, launches = train_run(
            torch, c, f"[8b] {tag}", must, per_step, TRAIN_SIM_STEPS,
            TRAIN_BATCH, TRAIN_SIM_SEQ, eng, log_every=TRAIN_SIM_STEPS)
        wall = time.perf_counter() - t0
        losses = [m["loss"] for m in hist]
        step_ms = [1e3 * m["step_s"] for m in hist]
        log(f"[8b] {tag}: {TRAIN_SIM_LAYERS} layers, batch {TRAIN_BATCH} x "
            f"seq {TRAIN_SIM_SEQ}, {TRAIN_SIM_STEPS} steps in {wall:.2f} s; "
            f"losses {' '.join(f'{x:.4f}' for x in losses)}; step ms "
            f"{' '.join(f'{x:.1f}' for x in step_ms)}; {launches[kernel]} "
            f"{kernel} launches ({per_step} a step)")
        if tag == "noisy":
            noisy_gate("[8b] noisy", launches, TRAIN_BATCH * TRAIN_SIM_SEQ,
                       per_step * len(hist))
        out[tag] = dict(losses=losses, step_ms=step_ms,
                        launches=launches[kernel], launches_per_step=per_step,
                        launches_by_counter={k: launches[k] for k in must})
    c = dataclasses.replace(small, fabric=noisy_spec)
    params = init_params(c, device=dev, seed=0)
    batch = stream_batch(torch, dev, c, TRAIN_SIM_SEQ, TRAIN_BATCH, 0)
    runs = []
    for step in (0, 0, 1):
        table = torch.from_numpy(seed_table(eng.noise_seed(step),
                                            dense_calls(c))).to(dev)
        with deterministic():
            runs.append(loss_and_grads(params, batch, c, noise_seed=table))
    (l0, _, g0), (l1, _, g1), (l2, _, _) = runs
    if not (torch.equal(l0, l1) and all(
            torch.equal(x, y) for x, y in zip(tree_leaves(g0),
                                               tree_leaves(g1)))):
        raise AssertionError("[8b] noisy: one seed, two losses or gradients")
    if torch.equal(l0, l2):
        raise AssertionError("[8b] noisy: two step seeds, one loss")
    log(f"[8b] noisy: step 0's seed twice, loss {float(l0):.6f} and every "
        f"gradient bit for bit; step 1's seed: loss {float(l2):.6f}")

    # c. the card against the CPU's plain path
    out["card_vs_cpu"] = {}
    cpu_params = init_params(small, device="cpu", seed=0)
    params = tree_map(lambda t: t.to(dev), cpu_params)
    card = {}
    for tag, spec in (("exact", FabricSpec()), ("sim", FabricSpec(
            mode="sim"))):
        c = dataclasses.replace(small, fabric=spec, remat=False)
        nb = SyntheticStream(DataConfig(c.vocab_size, TRAIN_SIM_SEQ,
                                        1)).batch(0)
        b = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
        card[tag] = loss_and_grads(params, b, c)
    (le, _, ge), (ls, _, gs) = card["exact"], card["sim"]
    if not (torch.equal(le, ls) and all(torch.equal(x, y) for x, y in zip(
            tree_leaves(ge), tree_leaves(gs)))):
        raise AssertionError("[8c] noise-free sim differs from exact")
    log(f"[8c] card, batch 1 x seq {TRAIN_SIM_SEQ}: noise-free sim's loss "
        f"and gradients equal exact's bit for bit")
    f32 = tree_map(lambda t: t.to(torch.float32), cpu_params)
    f64 = tree_map(lambda t: t.to(torch.float64), cpu_params)
    flag = torch.backends.cuda.matmul
    for tag, spec, seq, model in (
            ("exact", FabricSpec(), TRAIN_SIM_SEQ, "bfloat16"),
            ("exact", FabricSpec(), TRAIN_SIM_SEQ, "float32"),
            ("sim", FabricSpec(mode="sim"), TRAIN_CPU_SIM_SEQ, "bfloat16")):
        c = dataclasses.replace(small, fabric=spec, remat=False)
        nb = SyntheticStream(DataConfig(c.vocab_size, seq, 1)).batch(0)
        on_cpu = cpu_params if model == "bfloat16" else f32
        runs = [("card", tree_map(lambda t: t.to(dev), on_cpu)),
                ("cpu", on_cpu)]
        if tag == "exact" and model == "bfloat16":
            # the float64 witness, and the card once more with cuBLAS's
            # bf16 reductions in reduced precision the other way round
            runs += [("witness", f64), ("card_flipped", runs[0][1])]
        res = {}
        for where, p in runs:
            b = {k: torch.from_numpy(v).to(p["embed"].device)
                 for k, v in nb.items()}
            reduced = flag.allow_bf16_reduced_precision_reduction
            if where == "card_flipped":
                flag.allow_bf16_reduced_precision_reduction = not reduced
            t0 = time.perf_counter()
            try:
                loss, _, grads = loss_and_grads(p, b, c)
                res[where] = (float(loss), [g.cpu() for g in
                                            tree_leaves(grads)],
                              time.perf_counter() - t0)
            finally:
                flag.allow_bf16_reduced_precision_reduction = reduced
        (lc, gc, tc), (lp, gp, tp) = res["card"], res["cpu"]
        loss_err = abs(lc - lp) / abs(lp)
        worst = worst_rel_l2(gc, gp)
        log(f"[8c] {tag}, {model} params, batch 1 x seq {seq}: card loss "
            f"{lc:.6f}, CPU {lp:.6f} (rel {loss_err:.2e}); worst gradient "
            f"rel L2 by leaf dtype {worst} (bound "
            f"{TRAIN_GRAD_RTOL[model]}); card {tc:.2f} s, CPU {tp:.2f} s")
        if loss_err > TRAIN_LOSS_RTOL or \
                max(worst.values()) > TRAIN_GRAD_RTOL[model]:
            raise AssertionError(f"[8c] {tag} {model}: card against CPU "
                                 f"loss {loss_err} grads {worst}")
        row = dict(loss_rel_err=loss_err, grad_rel_l2=worst, cpu_s=tp)
        if "witness" in res:
            gw = res["witness"][1]
            card_w = [rel_l2(x.double(), w) for x, w in zip(gc, gw)]
            cpu_w = [rel_l2(x.double(), w) for x, w in zip(gp, gw)]
            # per leaf, the card's distance from the witness over the CPU's
            ratio = max(((x.double() - w).norm() / max(
                (y.double() - w).norm(), 1e-30)).item()
                for x, y, w in zip(gc, gp, gw))
            flipped = worst_rel_l2(res["card_flipped"][1], gp)
            log(f"[8c] exact, bf16 params against the float64 witness "
                f"(loss {res['witness'][0]:.6f}): worst leaf rel L2 card "
                f"{max(card_w):.3e}, CPU {max(cpu_w):.3e}; worst per-leaf "
                f"ratio card/CPU {ratio:.3f} (bound {TRAIN_WITNESS_RATIO}); "
                f"card with allow_bf16_reduced_precision_reduction="
                f"{not flag.allow_bf16_reduced_precision_reduction} against "
                f"the CPU {flipped} (with "
                f"{flag.allow_bf16_reduced_precision_reduction}: {worst})")
            if ratio > TRAIN_WITNESS_RATIO:
                raise AssertionError(f"[8c] the card's bf16 gradients sit "
                                     f"{ratio:.3f}x the CPU's distance from "
                                     f"the float64 witness")
            row.update(witness_loss=res["witness"][0],
                       card_to_witness=max(card_w),
                       cpu_to_witness=max(cpu_w), witness_ratio=ratio,
                       flipped_reduction_grad_rel_l2=flipped,
                       reduced_precision_reduction=(
                           flag.allow_bf16_reduced_precision_reduction))
        out["card_vs_cpu"][f"{tag}_{model}"] = row
    out["kernels"] = train_kernel_checks(torch, dev)
    return out


def worst_rel_l2(got, want):
    """The worst relative L2 distance of ``got``'s leaves from ``want``'s,
    by ``want``'s dtype."""
    worst = {}
    for x, y in zip(got, want):
        k = str(y.dtype).removeprefix("torch.")
        worst[k] = max(worst.get(k, 0.0), rel_l2(x.double(), y.double()))
    return worst


def train_kernel_checks(torch, dev):
    """8d: the training path's three kernels at its shapes against their
    plain versions on the same inputs, bit for bit: ``imc_mac`` at M = 2048
    (8a's batch 4 x seq 512) and a ragged 2047 over the three (K, N) of a
    layer, ``bitplane_mac`` at M = 512 (8b's 4 x 128) on (768, 3072), its
    tensor-core kernel by counter, and
    ``bitplane_mac_noisy`` at M = 512 on (768, 768) under calibrated
    mismatch, seeded by a row of a step's seed table in device memory, its
    tensor-core kernel by the launcher's report."""
    from repro_torch.core.constants import MC_SIGMA_VK
    from repro_torch.kernels.bitplane_mac.ops import (bitplane_mac,
                                                      bitplane_mac_noisy,
                                                      bitplane_mac_noisy_torch,
                                                      bitplane_mac_torch)
    from repro_torch.kernels.common import seed_table
    from repro_torch.kernels.imc_mac.ops import imc_mac, imc_mac_torch

    g = torch.Generator(device=dev).manual_seed(23)
    checked = []

    def same(tag, out, plain):
        torch.cuda.synchronize()
        if not torch.equal(out, plain):
            raise AssertionError(
                f"[8d] {tag} differs from its plain version in "
                f"{int((out != plain).sum())} of {out.numel()} elements")
        checked.append(tag)

    for m in (TRAIN_BATCH * TRAIN_SEQ, TRAIN_BATCH * TRAIN_SEQ - 1):
        for k, n in ((768, 768), (768, 3072), (3072, 768)):
            a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                              dtype=torch.int8)
            w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                              dtype=torch.int8)
            same(f"imc_mac {(m, k, n)}", imc_mac(a, w), imc_mac_torch(a, w))
    m = TRAIN_BATCH * TRAIN_SIM_SEQ
    for k, n, noisy in ((768, 3072, False), (768, 768, True)):
        ua = torch.randint(0, 256, (m, k), generator=g, device=dev,
                           dtype=torch.int32)
        uw = torch.randint(0, 256, (k, n), generator=g, device=dev,
                           dtype=torch.int32)
        if noisy:
            seed = torch.from_numpy(seed_table(7, 24)).to(dev)[5]
            kw = dict(mismatch_sigma=MC_SIGMA_VK)
            same(f"bitplane_mac_noisy {(m, k, n)}",
                 noisy_call(torch, bitplane_mac_noisy, ua, uw, seed, None,
                            f"[8d] {(m, k, n)}", **kw),
                 bitplane_mac_noisy_torch(ua, uw, seed, **kw))
        else:
            before = bitplane_mac.mma_launches
            same(f"bitplane_mac {(m, k, n)}", bitplane_mac(ua, uw),
                 bitplane_mac_torch(ua, uw))
            if bitplane_mac.mma_launches != before + 1:
                raise AssertionError(f"[8d] bitplane_mac at M = {m} ran the "
                                     "tensor-core kernel "
                                     f"{bitplane_mac.mma_launches - before} "
                                     "times, expected 1")
    log(f"[8d] the training shapes, each kernel equal to its plain version "
        f"bit for bit: {'; '.join(checked)}")
    return checked


def time_imc_mac(torch, dev):
    """One decode step's imc_mac work: 12 layers x 6 projections at M = 4
    (4 slots), cycling 12 distinct weight sets (85 MB, more than L2)."""
    from repro_torch.kernels.imc_mac.ops import imc_mac, imc_mac_torch

    g = torch.Generator(device=dev).manual_seed(2)
    shapes = [(768, 768)] * 4 + [(768, 3072), (3072, 768)]
    m, layers = 4, 12
    a = {k: torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8) for k in (768, 3072)}
    a_pad = {k: torch.cat([v, v.new_zeros((32 - m, k))]) for k, v in a.items()}
    ws = [[torch.randint(-127, 128, s, generator=g, device=dev,
                         dtype=torch.int8) for s in shapes]
          for _ in range(layers)]

    def step(fn, act):
        for lw in ws:
            for w in lw:
                fn(act[w.shape[0]], w)

    ms = cuda_ms(torch, lambda: step(imc_mac, a), iters=20)
    g_ms = graph_ms(torch, lambda: step(imc_mac, a))
    plain = cuda_ms(torch, lambda: step(imc_mac_torch, a), iters=5)
    lib = cuda_ms(torch, lambda: step(torch._int_mm, a_pad), iters=20)
    lib_g = graph_ms(torch, lambda: step(torch._int_mm, a_pad))
    nbytes = layers * sum(m * k + k * n + 4 * m * n for k, n in shapes)
    ops = layers * sum(2 * m * k * n for k, n in shapes)
    b_ms, by = bound(nbytes, ops, INT8_OPS_PER_S)

    # one bucket-64 and one bucket-32 prefill's projections: M = 64 and 32,
    # the tensor-core kernel
    rows, acts = {}, {}
    for key, mp in (("prefill", 64), ("prefill32", 32)):
        ap = acts[key] = {k: torch.randint(-127, 128, (mp, k), generator=g,
                                           device=dev, dtype=torch.int8)
                          for k in (768, 3072)}
        rows[key] = prefill_row(
            torch, lambda fn, act=ap: step(fn, act), imc_mac, imc_mac_torch,
            torch._int_mm,
            layers * sum(mp * k + k * n + 4 * mp * n for k, n in shapes),
            layers * sum(2 * mp * k * n for k, n in shapes),
            f"one bucket-{mp} prefill: 12 layers x {{4x (768,768), "
            f"(768,3072), (3072,768)}} at M={mp} (the tensor-core kernel); "
            "library: torch._int_mm")
    # one training forward's projections (phase 8a: batch 4 x seq 512, M =
    # 2048, the tensor-core kernel at 32 x 24 or 96 x 24 tiles); the
    # library call needs no padding there
    mt = TRAIN_BATCH * TRAIN_SEQ
    at = {k: torch.randint(-127, 128, (mt, k), generator=g, device=dev,
                           dtype=torch.int8) for k in (768, 3072)}
    rows["train"] = prefill_row(
        torch, lambda fn: step(fn, at), imc_mac, imc_mac_torch,
        torch._int_mm,
        layers * sum(mt * k + k * n + 4 * mt * n for k, n in shapes),
        layers * sum(2 * mt * k * n for k, n in shapes),
        f"one training forward (phase 8a): 12 layers x {{4x (768,768), "
        f"(768,3072), (3072,768)}} at M={mt} (the tensor-core kernel); "
        "library: torch._int_mm")
    # the bucket-64 launches over layer 0's weights alone (7.1 MB, resident
    # in L2): the kernel's time without device-memory traffic
    ap = acts["prefill"]
    rows["prefill"]["l2_graph_ms"] = graph_ms(
        torch, lambda: [imc_mac(ap[w.shape[0]], w) for _ in ws for w in ws[0]])
    return dict(ms=ms, graph_ms=g_ms, plain_ms=plain, library_ms=lib,
                library_graph_ms=lib_g, bound_ms=b_ms, bound_by=by,
                shape="one decode step: 12 layers x {4x (768,768), "
                      "(768,3072), (3072,768)} at M=4; library: "
                      "torch._int_mm with M padded to 32", **rows)


def prefill_row(torch, run, fn, plain, library, nbytes, ops, shape):
    """A prefill row of phase 7: ``run(f)`` makes the prefill's launches of
    ``f``; eager and graph times of the kernel and the library, the plain
    version's time, the bound from ``nbytes`` and ``ops`` (int8)."""
    row = dict(ms=cuda_ms(torch, lambda: run(fn), iters=20),
               graph_ms=graph_ms(torch, lambda: run(fn)),
               plain_ms=cuda_ms(torch, lambda: run(plain), iters=5),
               library_ms=cuda_ms(torch, lambda: run(library), iters=20),
               library_graph_ms=graph_ms(torch, lambda: run(library)),
               shape=shape)
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, INT8_OPS_PER_S)
    return row


def time_imc_mac_dequant(torch, dev):
    """One decode step's projections through the fused-dequant GEMM: 12
    layers x 6 projections at M = 4, cycling 12 distinct weight sets (85 MB,
    more than L2), each with its float32 per-channel scales."""
    from repro_torch.kernels.imc_mac.ops import (imc_mac_dequant,
                                                 imc_mac_dequant_torch)

    g = torch.Generator(device=dev).manual_seed(24)
    shapes = [(768, 768)] * 4 + [(768, 3072), (3072, 768)]
    m, layers = 4, 12
    a = {k: torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8) for k in (768, 3072)}
    a_pad = {k: torch.cat([v, v.new_zeros((32 - m, k))]) for k, v in a.items()}
    sa = torch.tensor(0.0123, device=dev)
    ws = [[(torch.randint(-127, 128, s, generator=g, device=dev,
                          dtype=torch.int8),
            torch.rand((s[1],), generator=g, device=dev) * 0.099 + 0.001)
           for s in shapes] for _ in range(layers)]

    def step(fn, act):
        for lw in ws:
            for w, sw in lw:
                fn(act[w.shape[0]], w, sa, sw)

    def library(qa, w, sa_, sw):  # three calls: _int_mm, then two multiplies
        return torch._int_mm(qa, w) * sa_ * sw

    ms = cuda_ms(torch, lambda: step(imc_mac_dequant, a), iters=20)
    g_ms = graph_ms(torch, lambda: step(imc_mac_dequant, a))
    plain = cuda_ms(torch, lambda: step(imc_mac_dequant_torch, a), iters=5)
    lib = cuda_ms(torch, lambda: step(library, a_pad), iters=20)
    lib_g = graph_ms(torch, lambda: step(library, a_pad))
    nbytes = layers * sum(m * k + k * n + 4 + 4 * n + 4 * m * n
                          for k, n in shapes)
    ops = layers * sum(2 * m * k * n for k, n in shapes)
    b_ms, by = bound(nbytes, ops, INT8_OPS_PER_S)
    # one bucket-64 prefill's projections: M = 64, the tensor-core kernel
    mp = 64
    ap = {k: torch.randint(-127, 128, (mp, k), generator=g, device=dev,
                           dtype=torch.int8) for k in (768, 3072)}
    pre = prefill_row(
        torch, lambda fn: step(fn, ap), imc_mac_dequant,
        imc_mac_dequant_torch, library,
        layers * sum(mp * k + k * n + 4 + 4 * n + 4 * mp * n
                     for k, n in shapes),
        layers * sum(2 * mp * k * n for k, n in shapes),
        "one bucket-64 prefill: 12 layers x {4x (768,768), (768,3072), "
        "(3072,768)} at M=64, f32 out (the tensor-core kernel); library: "
        "three calls, torch._int_mm then * scale_a * scale_w")
    return dict(ms=ms, graph_ms=g_ms, plain_ms=plain, library_ms=lib,
                library_graph_ms=lib_g, bound_ms=b_ms, bound_by=by,
                shape="one decode step: 12 layers x {4x (768,768), "
                      "(768,3072), (3072,768)} at M=4, f32 out; library: "
                      "three calls, torch._int_mm (M padded to 32) then "
                      "* scale_a * scale_w", prefill=pre)


def time_rbl_decode_mac(torch, dev):
    """One decode step's projections as one {0,1} plane pair each: 12 layers
    x 6 projections at M = 4, rows 8, cycling 12 distinct weight sets (85
    MB of one-byte operands, more than L2)."""
    from repro_torch.kernels.bitplane_mac.ops import physics_thresholds
    from repro_torch.kernels.rbl_decode.ops import (rbl_decode_mac,
                                                    rbl_decode_mac_torch)

    g = torch.Generator(device=dev).manual_seed(25)
    shapes = [(768, 768)] * 4 + [(768, 3072), (3072, 768)]
    m, layers, rows = 4, 12, 8
    a = {k: torch.randint(0, 2, (m, k), generator=g, device=dev,
                          dtype=torch.int8) for k in (768, 3072)}
    a_pad = {k: torch.cat([v, v.new_zeros((32 - m, k))]) for k, v in a.items()}
    ws = [[torch.randint(0, 2, s, generator=g, device=dev, dtype=torch.int8)
           for s in shapes] for _ in range(layers)]
    thr = physics_thresholds(rows, dev)

    def step(fn, act, *args):
        for lw in ws:
            for w in lw:
                fn(act[w.shape[0]], w, *args)

    ms = cuda_ms(torch, lambda: step(rbl_decode_mac, a, thr), iters=20)
    g_ms = graph_ms(torch, lambda: step(rbl_decode_mac, a, thr))
    plain = cuda_ms(torch, lambda: step(rbl_decode_mac_torch, a, thr),
                    iters=3, warmup=1)
    lib = cuda_ms(torch, lambda: step(torch._int_mm, a_pad), iters=20)
    lib_g = graph_ms(torch, lambda: step(torch._int_mm, a_pad))
    nbytes = layers * sum(m * k + k * n + 4 * rows + 4 * m * n
                          for k, n in shapes)
    ops = layers * sum(2 * m * k * n for k, n in shapes)
    b_ms, by = bound(nbytes, ops, INT8_OPS_PER_S)
    return dict(ms=ms, graph_ms=g_ms, plain_ms=plain, library_ms=lib,
                library_graph_ms=lib_g, bound_ms=b_ms, bound_by=by,
                shape="one decode step as one plane pair per projection: 12 "
                      "layers x {4x (768,768), (768,3072), (3072,768)} at "
                      "M=4, {0,1} int8 operands, rows 8, calibrated thr; "
                      "ops = 2*M*K*N binary MACs at the int8 rate; library: "
                      "torch._int_mm on the {0,1} operands (M padded to "
                      "32), the same values only under calibrated "
                      "thresholds", sweep=rbl_sweep_row(torch, dev))


def rbl_sweep_row(torch, dev):
    """The threshold sweep of phase 6d as its users run it: the sign planes
    of one quantized 64x768x3072 projection, rows 8, five calls with every
    reference shifted by 0, 10, 50, 100 and 200 mV."""
    from repro_torch.core.quant import quantize
    from repro_torch.kernels.bitplane_mac.ops import physics_thresholds
    from repro_torch.kernels.rbl_decode.ops import (rbl_decode_mac,
                                                    rbl_decode_mac_torch)

    g = torch.Generator(device=dev).manual_seed(26)
    x = torch.randn((64, 768), generator=g, device=dev)
    w = torch.randn((768, 3072), generator=g, device=dev) * 0.05
    qx, qw = quantize(x, 8, axis=None), quantize(w, 8, axis=0)
    a7 = ((qx.q.to(torch.int32) + 128) >> 7).to(torch.int8)
    w7 = ((qw.q.to(torch.int32) + 128) >> 7).to(torch.int8)
    good = physics_thresholds(8, dev)
    thrs = [good + dv for dv in SWEEP_SHIFTS]

    def sweep(fn):
        for thr in thrs:
            fn(a7, w7, thr)

    m, k = a7.shape
    n = w7.shape[1]
    calls = len(SWEEP_SHIFTS)
    row = dict(ms=cuda_ms(torch, lambda: sweep(rbl_decode_mac), iters=20),
               graph_ms=graph_ms(torch, lambda: sweep(rbl_decode_mac)),
               plain_ms=cuda_ms(torch, lambda: sweep(rbl_decode_mac_torch),
                                iters=3, warmup=1),
               library_ms=cuda_ms(torch, lambda: sweep(
                   lambda a, b, _: torch._int_mm(a, b)), iters=20),
               library_graph_ms=graph_ms(torch, lambda: sweep(
                   lambda a, b, _: torch._int_mm(a, b))),
               shape="the threshold sweep of phase 6d: sign planes of one "
                     "quantized 64x768x3072 projection, rows 8, five calls "
                     "(thr + 0, 0.01, 0.05, 0.1, 0.2 V); library: "
                     "torch._int_mm at M=64, the same values only under "
                     "calibrated thresholds")
    row["bound_ms"], row["bound_by"] = bound(
        calls * (m * k + k * n + 4 * m * n + 4 * 8),
        calls * 2 * m * k * n, INT8_OPS_PER_S)
    return row


def build_variants(label, source, variants, entry, argtypes):
    """Build each of ``variants`` ({name: [(anchor, text[, header]), ...]})
    of ``csrc/<source>.cu``: every anchor is a piece of one line of the
    source, or of the named header of ``csrc/`` (a whole line, stripped,
    where the piece is in several), and is replaced by its text.  Each
    variant is written to a folder of its own under the build directory's
    ``label`` folder, its patched headers beside it (found there before
    ``csrc/``'s); one nvcc each, all started together.  Returns ({name: the
    library's ``entry`` through ctypes}, {name: nvcc's output})."""
    import ctypes

    from repro_torch.kernels import build

    procs, dirs = {}, {}
    for name, patches in variants.items():
        files = {f"{source}.cu": (build.CSRC / f"{source}.cu").read_text()
                 .split("\n")}
        for anchor, text, *header in patches:
            fname = header[0] if header else f"{source}.cu"
            lines = files.setdefault(
                fname, (build.CSRC / fname).read_text().split("\n"))
            at = [i for i, line in enumerate(lines) if anchor in line]
            if len(at) > 1:
                at = [i for i in at if lines[i].strip() == anchor]
            if "\n" in anchor or len(at) != 1:
                raise AssertionError(f"{label} {name}: {anchor!r} is not in "
                                     f"one line of {fname}")
            lines[at[0]] = lines[at[0]].replace(anchor, text)
        vdir = dirs[name] = build.build_dir() / label / name
        vdir.mkdir(parents=True, exist_ok=True)
        for stale in vdir.glob("*.cu*"):  # an earlier build's patches
            stale.unlink()
        for fname, lines in files.items():
            (vdir / fname).write_text("\n".join(lines))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
             str(vdir / f"{source}.so"), str(vdir / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, logs = {}, {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"{label} {name}: nvcc failed\n"
                                 f"{logs[name]}")
        fn = getattr(ctypes.CDLL(str(dirs[name] / f"{source}.so")), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns, logs


def ptxas_lines(logs, kernel):
    """{variant: ptxas's registers, stack and spill lines for ``kernel``}
    from ``build_variants``' nvcc outputs."""
    out = {}
    for name, text in logs.items():
        lines = text.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry function" in line and kernel in line)
        out[name] = " ".join(x.strip() for x in lines[at + 1:at + 4]
                             if "Used" in x or "spill" in x)
    return out


# rbl_decode_mac's timing-only variants, each returning early, its results
# wrong on purpose (build_variants' patches)
_RBL_KEEP = ("if (M > 0) {  // every sum kept alive\n    int s = 0;\n"
             "    for (int m = 0; m < RM; ++m)\n"
             "      for (int j = 0; j < COLS; ++j) s ^= ctr.acc[m][j];\n"
             "    if (s == 0x7fffffff) out[0] = 1;\n    return;\n  }\n  ")
RBL_EXITS = {
    "full": [],
    "after_staging": [("if (c0 == g_begin) {",
                       "if (M > 0) return;\n    if (c0 == g_begin) {")],
    "after_counting": [("// 5. the block's partial tile",
                        _RBL_KEEP + "// 5. the block's partial tile")],
    "before_meeting": [("cluster.sync();",
                        "if (M > 0) return;\n  cluster.sync();")],
}


def rbl_phases(torch, dev):
    """Where ``rbl_decode_mac``'s time goes: the full source and variants
    that return after the staging, after the counting and before the
    cluster's meeting, one nvcc each into the build directory, called
    through ctypes and timed from a graph in turns (in order, then
    reversed) at one decode step (72 launches, M = 4, 12 weight sets), the
    threshold sweep (five 64x768x3072 calls) and the decode step over one
    layer's weights (resident in L2); ``imc_mac`` at the same decode step
    from device memory and from L2, and 72 one-element launches, beside
    them.  Returns ms from a graph, [decode step, sweep, L2 decode step]
    per variant and turn."""
    from repro_torch.kernels import build
    from repro_torch.kernels.bitplane_mac.ops import physics_thresholds
    from repro_torch.kernels.imc_mac.ops import imc_mac
    from repro_torch.kernels.rbl_decode.ops import (_ARGTYPES,
                                                    physics_voltages)

    fns, _ = build_variants("rbl_phases", "rbl_decode_mac", RBL_EXITS,
                            "rbl_decode_mac_launch", _ARGTYPES)

    g = torch.Generator(device=dev).manual_seed(25)
    shapes = [(768, 768)] * 4 + [(768, 3072), (3072, 768)]

    def bits(*shape):
        return torch.randint(0, 2, shape, generator=g, device=dev,
                             dtype=torch.int8)

    a4 = {k: bits(4, k) for k in (768, 3072)}
    ws = [[bits(*s) for s in shapes] for _ in range(12)]
    a64, w64 = bits(64, 768), bits(768, 3072)
    thr = physics_thresholds(8, dev)
    volt = physics_voltages(8, dev)
    sweep_thr = [thr + dv for dv in SWEEP_SHIFTS]
    outs = {}
    geom = (8, 264)  # the default plan's (cluster, target)

    def call(fn, a, w, t):
        (m, k), n = a.shape, w.shape[1]
        out = outs.setdefault((m, n), torch.empty(
            (m, n), dtype=torch.int32, device=dev))
        stream, idx = build.stream_and_device(a)
        build.check_launch("rbl_phases", fn(
            a.data_ptr(), w.data_ptr(), t.data_ptr(), volt.data_ptr(),
            out.data_ptr(), m, n, k, 8, *geom, stream, idx))

    def step(fn, sets):
        for lw in sets:
            for w in lw:
                call(fn, a4[w.shape[0]], w, thr)

    res = {}
    for name in list(fns) + list(reversed(list(fns))):
        fn = fns[name]
        res.setdefault(name, []).append([
            graph_ms(torch, lambda: step(fn, ws)),
            graph_ms(torch, lambda: [call(fn, a64, w64, t)
                                     for t in sweep_thr]),
            graph_ms(torch, lambda: step(fn, [ws[0]] * 12))])
    q4 = {k: torch.randint(-127, 128, (4, k), generator=g, device=dev,
                           dtype=torch.int8) for k in (768, 3072)}
    qws = [[torch.randint(-127, 128, s, generator=g, device=dev,
                          dtype=torch.int8) for s in shapes]
           for _ in range(12)]
    res["imc_mac"] = [graph_ms(torch, lambda sets=sets: [
        imc_mac(q4[w.shape[0]], w) for lw in sets for w in lw])
        for sets in (qws, [qws[0]] * 12)]
    res["72_one_element_launches"] = floor_graph_ms(torch, dev, 72)
    return res


def time_paged_attn(torch, dev):
    """One decode step's attention: 12 layers, 4 slots, 12 heads (rep 1),
    hd 64, bf16 pools, block 16, 8 table blocks, positions 22/31/48/27."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attn.ops import (paged_attention,
                                                    paged_decode_torch)

    B, H, KV, hd, bs, mb, layers = 4, 12, 12, 64, 16, 8, 12
    pos = [22, 31, 48, 27]
    ins = [attn_inputs(torch, dev, "bf16", B, H, KV, hd, pos, bs=bs, mb=mb,
                       seed=100 + i) for i in range(layers)]
    # the library yardstick attends over the gathered span, dense
    dense = []
    for q, k, v, tbl, p, _ in ins:
        nb = k.shape[0]
        ctx = torch.arange(mb * bs, device=dev)
        t = torch.where(tbl < 0, 0, tbl).long()
        gidx = t[:, ctx // bs] * bs + ctx % bs
        valid = (ctx[None] <= p.long()[:, None]) & (tbl[:, ctx // bs] >= 0)
        kd = k.reshape(nb * bs, KV, hd)[gidx].permute(0, 2, 1, 3)
        vd = v.reshape(nb * bs, KV, hd)[gidx].permute(0, 2, 1, 3)
        dense.append((q.permute(0, 2, 1, 3).contiguous(), kd.contiguous(),
                      vd.contiguous(), valid[:, None, None, :]))

    def run():
        return [paged_attention(q, k, v, t, p) for q, k, v, t, p, _ in ins]

    def library():
        return [F.scaled_dot_product_attention(q, k, v, attn_mask=msk)
                for q, k, v, msk in dense]

    ms = cuda_ms(torch, run, iters=50)
    g_ms = graph_ms(torch, run)
    plain = cuda_ms(torch, lambda: [paged_decode_torch(q, k, v, t, p)
                                    for q, k, v, t, p, _ in ins], iters=20)
    lib = cuda_ms(torch, library, iters=50)
    lib_g = graph_ms(torch, library)
    live = sum(p_ + 1 for p_ in pos)
    nbytes = layers * (live * KV * hd * 2 * 2 + 2 * B * H * hd * 2
                       + 4 * (B * mb + B))
    ops = layers * live * H * hd * 2 * 2
    b_ms, by = bound(nbytes, ops, BF16_FLOPS_PER_S)
    return dict(ms=ms, graph_ms=g_ms, plain_ms=plain, library_ms=lib,
                library_graph_ms=lib_g, floor_graph_ms=floor_graph_ms(
                    torch, dev, layers), bound_ms=b_ms, bound_by=by,
                shape="one decode step: 12 layers x (B=4, H=KV=12, hd=64, "
                      "bf16, block 16, 8 blocks/slot, pos 22/31/48/27); "
                      "library: F.scaled_dot_product_attention over the "
                      "pre-gathered span; floor: 12 one-element launches "
                      "from a graph")


def time_bitplane_mac(torch, dev):
    """One decode step's bitplane_mac work: 12 layers x 6 projections at
    M = 4 (4 slots), 8x8 bits, 8-row groups, cycling 12 distinct weight sets
    (85 MB of one-byte operands, more than L2); then the same projections
    at each prefill bucket and at phase 8b's M = 512 (the tensor-core
    kernel), each with the decode bound of its group counts (one integer
    instruction a count at 64 an SM a clock) beside the int8 bound, and
    one projection of the bucket-64 prefill and of M = 512 with its plain
    version."""
    from repro_torch.kernels.bitplane_mac.ops import (bitplane_mac,
                                                      bitplane_mac_torch,
                                                      physics_thresholds)

    g = torch.Generator(device=dev).manual_seed(5)
    shapes = [(768, 768)] * 4 + [(768, 3072), (3072, 768)]
    m, layers, bits, rows = 4, 12, 8, 8
    a = {k: torch.randint(0, 256, (m, k), generator=g, device=dev,
                          dtype=torch.int32) for k in (768, 3072)}
    ws = [[torch.randint(0, 256, s, generator=g, device=dev,
                         dtype=torch.int32) for s in shapes]
          for _ in range(layers)]
    a8 = {k: v.to(torch.uint8) for k, v in a.items()}
    ws8 = [[w.to(torch.uint8) for w in lw] for lw in ws]
    # the library yardstick: torch._int_mm on the signed codes u - 128 (the
    # same product up to the rank-1 correction), M padded to 32
    a_lib = {k: torch.cat([v - 128, (v - 128).new_zeros((32 - m, k))]).to(
        torch.int8) for k, v in a.items()}
    ws_lib = [[(w - 128).to(torch.int8) for w in lw] for lw in ws]

    def step(fn, act, weights, **kw):
        for lw in weights:
            for w in lw:
                fn(act[w.shape[0]], w, **kw)

    ms = cuda_ms(torch, lambda: step(bitplane_mac, a8, ws8, bits_a=bits,
                                     bits_w=bits, rows=rows), iters=10)
    g_ms = graph_ms(torch, lambda: step(bitplane_mac, a8, ws8, bits_a=bits,
                                        bits_w=bits, rows=rows))
    plain = cuda_ms(torch, lambda: step(bitplane_mac_torch, a, ws,
                                        bits_a=bits, bits_w=bits, rows=rows),
                    iters=1, warmup=1)
    lib = cuda_ms(torch, lambda: step(torch._int_mm, a_lib, ws_lib), iters=20)
    lib_g = graph_ms(torch, lambda: step(torch._int_mm, a_lib, ws_lib))
    nbytes = layers * sum(m * k + k * n + 4 * m * n for k, n in shapes)
    ops = layers * sum(2 * bits * bits * m * k * n for k, n in shapes)
    b_ms, by = bound(nbytes, ops, INT8_OPS_PER_S)

    # the tensor-core kernel's rows: one bucket-16, -32 and -64 prefill's
    # projections and one training forward's at M = 512 (phase 8b's batch 4
    # x seq 128), from graphs under the calibrated and the detuned table,
    # beside the library call torch._int_mm on the signed codes (M padded
    # to 32 at bucket 16), the int8 bound and the decode bound (the group
    # counts at one integer instruction each); the plain version would take
    # 4-30 s on 72 projections, so it is timed only on one (768, 3072)
    # projection, in a row of its own beside the kernel, its library call
    # and their bounds on the same inputs (the bucket-64 prefill's and the
    # training forward's)
    good = physics_thresholds(rows, dev)
    detuned = torch.cat([torch.tensor([1.9], device=dev), good[:-1]])
    kw = dict(bits_a=bits, bits_w=bits, rows=rows)

    def bounds(mt, proj, calls):
        """(bound_ms, bound_by, decode bound ms, group counts) of ``calls``
        times the projections ``proj`` at M = mt."""
        b = bound(calls * sum(mt * k + k * n + 4 * mt * n for k, n in proj),
                  calls * sum(2 * bits * bits * mt * k * n for k, n in proj),
                  INT8_OPS_PER_S)
        counts = calls * sum(mt * n * -(-k // rows) * bits * bits
                             for k, n in proj)
        return (*b, counts / INT_OPS_PER_S * 1e3, counts)

    tc = {}
    for key, mt in (("prefill16", 16), ("prefill32", 32),
                    ("prefill64", 64), ("train", TRAIN_BATCH * TRAIN_SIM_SEQ)):
        at = {k: torch.randint(0, 256, (mt, k), generator=g, device=dev,
                               dtype=torch.uint8) for k in (768, 3072)}
        pad = max(32 - mt, 0)
        at_lib = {k: torch.cat([v.to(torch.int32) - 128, v.new_zeros(
            (pad, k), dtype=torch.int32)]).to(torch.int8)
            for k, v in at.items()}
        before = bitplane_mac.mma_launches
        row = dict(
            graph_ms=graph_ms(torch, lambda: step(bitplane_mac, at, ws8,
                                                  **kw), iters=5),
            graph_ms_detuned=graph_ms(torch, lambda: step(
                bitplane_mac, at, ws8, thr=detuned, **kw), iters=5),
            library_graph_ms=graph_ms(torch, lambda: step(
                torch._int_mm, at_lib, ws_lib)))
        # the wrapper's count: a warm-up and the capture of each graph, 72
        # launches each
        row["tensor_core_launches"] = bitplane_mac.mma_launches - before
        (row["bound_ms"], row["bound_by"], row["bound_ms_decode"],
         row["bound_decode_counts"]) = bounds(mt, shapes, layers)
        what = ("one training forward (phase 8b)" if key == "train"
                else f"one bucket-{mt} prefill")
        row["shape"] = (f"{what}: 12 layers x {{4x (768,768), (768,3072), "
                        f"(3072,768)}} at M={mt}, 8x8 bits, rows 8 (the "
                        "tensor-core kernel); library: torch._int_mm on the "
                        "signed codes" + (" (M padded to 32)" if pad else "")
                        + "; bound_ms_decode: the group counts at one "
                        "integer instruction each, 64 an SM a clock")
        if key in ("prefill64", "train"):
            a, w, w32 = at[768], ws8[0][4], ws[0][4]
            one = dict(
                ms=cuda_ms(torch, lambda: bitplane_mac(a, w, **kw), iters=20),
                graph_ms=graph_ms(torch, lambda: bitplane_mac(a, w, **kw)),
                plain_ms=cuda_ms(torch, lambda: bitplane_mac_torch(
                    a.to(torch.int32), w32, **kw), iters=1, warmup=1),
                library_ms=cuda_ms(torch, lambda: torch._int_mm(
                    at_lib[768], ws_lib[0][4]), iters=20))
            (one["bound_ms"], one["bound_by"], one["bound_ms_decode"],
             one["bound_decode_counts"]) = bounds(mt, [(768, 3072)], 1)
            one["shape"] = (f"{what}'s (768,3072) projection of layer 0 at "
                            f"M={mt}, 8x8 bits, rows 8 (the tensor-core "
                            "kernel); ms, plain, library (torch._int_mm on "
                            "the signed codes) and both bounds on the same "
                            "inputs")
            row["one_projection"] = one
        tc[key] = row
    return dict(ms=ms, graph_ms=g_ms, plain_ms=plain, library_ms=lib,
                library_graph_ms=lib_g, bound_ms=b_ms, bound_by=by, **tc,
                shape="one decode step: 12 layers x {4x (768,768), "
                      "(768,3072), (3072,768)} at M=4, 8x8 bits, rows 8, "
                      "uint8 operands (the r8 kernel); ops = "
                      "2*PA*PW*M*K*N binary MACs at the int8 rate; library: "
                      "torch._int_mm on the signed int8 codes (M padded to "
                      "32), the same values only under calibrated "
                      "thresholds")


def noisy_tiers(torch, dev, act, weights, rows, kw):
    """Share of the elements per tier of ``bitplane_mac_noisy`` for one
    step's operands: the plain path's group counts (torch ops on the card,
    core/bitserial.py::decoded_pyramid) against the twin of the kernel's
    tables (``noisy_skip_tables``).  tier2: counts no draw can change (no
    Philox); tier3: the rest (one Philox each); full: the share expected to
    run the whole decode (with mismatch alone, a u1 index at or above
    cut[k]; with comparator offset, every tier-3 element).  None on a tree
    without the twin (a parent tree timed in turns)."""
    try:
        from repro_torch.kernels.bitplane_mac.ops import noisy_skip_tables
    except ImportError:
        return None
    from repro_torch.core.bitserial import decoded_pyramid
    from repro_torch.kernels.bitplane_mac.ops import physics_thresholds
    from repro_torch.kernels.common import U1_GRID

    hist = torch.zeros(rows + 1, dtype=torch.int64, device=dev)

    def count(c, n0):
        hist.add_(torch.bincount(c.reshape(-1).to(torch.int64),
                                 minlength=rows + 1))
        return torch.zeros(c.shape, dtype=torch.int32, device=c.device)

    for lw in weights:
        for w in lw:
            decoded_pyramid(act[w.shape[0]], w, bits_a=8, bits_w=8, rows=rows,
                            decode=count)
    _, need, cut = noisy_skip_tables(physics_thresholds(rows, "cpu"), rows,
                                     **kw)
    h = hist.cpu().double()
    total = float(h.sum())
    tier3 = float(h[need].sum())
    full = tier3 if cut is None else float(
        (h * (U1_GRID - cut).double() / U1_GRID)[need].sum())
    return dict(tier2=1 - tier3 / total, tier3=tier3 / total,
                full=full / total, tier3_elements=tier3, elements=total)


def time_bitplane_mac_noisy(torch, dev):
    """One decode step's bitplane_mac_noisy work (the shapes of
    time_bitplane_mac), mismatch only at the calibrated sigma (the served
    path) and mismatch + comparator offset at the stress sigmas, each on
    uniform operands (the rows of earlier PRs, unchanged) and on dense
    ones (``_dense``: every value 255, every count 8: no count is free).
    The plain version is timed once on the 72 projections of the uniform
    operands under calibrated mismatch, and under the stress sigmas on one
    layer's six (``plain_ms_both_one_layer``).  Each row carries its tier shares
    (``noisy_tiers``) and two floors: ``bound_ms``, the stream's own (the
    bytes against one Philox4x32-10 for every element a draw can change, at
    the integer issue rate) and ``sfu_bound_ms``, a hardware Box-Muller's
    (log, sqrt and cos per normal and sqrt(k) on the special-function
    units), which the bit-exact stream cannot reach.  The seed is a
    seed-table row in device memory, as the served steps pass it."""
    from repro_torch.core.constants import MC_SIGMA_VK
    from repro_torch.kernels.bitplane_mac.ops import (bitplane_mac_noisy,
                                                      bitplane_mac_noisy_torch)
    from repro_torch.kernels.common import seed_row

    g = torch.Generator(device=dev).manual_seed(5)
    shapes = [(768, 768)] * 4 + [(768, 3072), (3072, 768)]
    m, layers, bits, rows = 4, 12, 8, 8
    a = {k: torch.randint(0, 256, (m, k), generator=g, device=dev,
                          dtype=torch.uint8) for k in (768, 3072)}
    ws = [[torch.randint(0, 256, s, generator=g, device=dev,
                         dtype=torch.uint8) for s in shapes]
          for _ in range(layers)]
    a32 = {k: v.to(torch.int32) for k, v in a.items()}
    ws32 = [[w.to(torch.int32) for w in lw] for lw in ws]
    dense_a = {k: torch.full_like(v, 255) for k, v in a.items()}
    dense_ws = [[torch.full_like(w, 255) for w in lw] for lw in ws]

    seed = seed_row(5, dev)  # in device memory, as the served steps read it

    def step(fn, act, weights, **kw):
        for lw in weights:
            for w in lw:
                fn(act[w.shape[0]], w, seed, bits_a=bits, bits_w=bits,
                   rows=rows, **kw)

    out = {}
    elems = layers * sum(bits * bits * m * (k // rows) * n for k, n in shapes)
    nbytes = layers * sum(m * k + k * n + 4 * m * n for k, n in shapes)
    calibrated = dict(mismatch_sigma=MC_SIGMA_VK)
    for tag, kw, normals, iters, act, weights in (
            ("", calibrated, 1, 3, a, ws),
            ("_both", STRESS, 1 + rows, 2, a, ws),
            ("_dense", calibrated, 1, 3, dense_a, dense_ws),
            ("_dense_both", STRESS, 1 + rows, 2, dense_a, dense_ws)):
        ms = cuda_ms(torch, lambda: step(bitplane_mac_noisy, act, weights,
                                         **kw), iters=iters, warmup=1)
        g_ms = graph_ms(torch, lambda: step(bitplane_mac_noisy, act, weights,
                                            **kw), iters=iters)
        if act is a:  # warmed up on one projection, then timed once
            bitplane_mac_noisy_torch(a32[768], ws32[0][0], seed, bits_a=bits,
                                     bits_w=bits, rows=rows, **kw)
            out["plain_ms" if tag == "" else f"plain_ms{tag}_one_layer"] = \
                cuda_ms(torch, lambda: step(
                    bitplane_mac_noisy_torch, a32,
                    ws32 if tag == "" else [ws32[0]], **kw), iters=1,
                    warmup=0)
        tiers = noisy_tiers(torch, dev, act, weights, rows, kw)
        # one Philox4x32-10 per element a draw can change
        philox_ops = PHILOX_INT_OPS * (elems if tiers is None
                                       else tiers["tier3_elements"])
        b_ms, by = bound(nbytes, philox_ops, INT_OPS_PER_S)
        # log, sqrt, cos per normal, and sqrt(k) for the mismatch
        sfu_ops = elems * (3 * normals + 1)
        sfu_ms, _ = bound(nbytes, sfu_ops, SFU_OPS_PER_S)
        out.update({f"ms{tag}": ms, f"graph_ms{tag}": g_ms,
                    f"bound_ms{tag}": b_ms, f"bound_by{tag}": by,
                    f"philox_ops{tag}": philox_ops,
                    f"sfu_bound_ms{tag}": sfu_ms, f"sfu_ops{tag}": sfu_ops,
                    f"tiers{tag}": tiers})
    # the prefill buckets' and a training forward's projections (phase 8b's
    # M = 512), calibrated mismatch, uniform operands, from graphs: the
    # tensor-core kernel (M >= NOISY_MMA_MIN_M); their Philox bound takes
    # the tier-3 share of the decode step's uniform operands (the same
    # distribution of counts).  The bucket-64 prefill's (768, 3072)
    # projection of layer 0 is timed alone beside its plain version (the
    # kernels line's bitplane_mac_noisy_mma entry).
    share = 1.0 if out["tiers"] is None else out["tiers"]["tier3"]
    for key, mt, iters in (("prefill16", 16, 5), ("prefill32", 32, 5),
                           ("prefill64", 64, 5),
                           ("train", TRAIN_BATCH * TRAIN_SIM_SEQ, 3)):
        what = ("one training forward (phase 8b)" if key == "train"
                else f"one bucket-{mt} prefill")
        at = {k: torch.randint(0, 256, (mt, k), generator=g, device=dev,
                               dtype=torch.uint8) for k in (768, 3072)}
        el = layers * sum(bits * bits * mt * (k // rows) * n
                          for k, n in shapes)
        b_ms, by = bound(
            layers * sum(mt * k + k * n + 4 * mt * n for k, n in shapes),
            PHILOX_INT_OPS * share * el, INT_OPS_PER_S)
        before = getattr(bitplane_mac_noisy, "mma_launches", 0)
        out[key] = dict(
            graph_ms=graph_ms(torch, lambda: step(bitplane_mac_noisy, at, ws,
                                                  **calibrated), iters=iters,
                              warmup=1),
            bound_ms=b_ms, bound_by=by, elements=el, tier3_share=share,
            # the wrapper's count: a warm-up and the capture, 72 each
            tensor_core_launches=getattr(bitplane_mac_noisy, "mma_launches",
                                         0) - before,
            shape=f"{what}: 12 layers x {{4x (768,768), (768,3072), (3072,768)}} at "
                  f"M={mt}, mismatch at the calibrated sigma, uniform "
                  "operands; bound: the bytes against one Philox4x32-10 "
                  "per element at the decode step's tier-3 share")
        if key == "prefill64":
            a1, w1 = at[768], ws[0][4]
            el1 = bits * bits * mt * (768 // rows) * 3072
            b1, by1 = bound(mt * 768 + 768 * 3072 + 4 * mt * 3072,
                            PHILOX_INT_OPS * share * el1, INT_OPS_PER_S)
            one = dict(
                ms=cuda_ms(torch, lambda: bitplane_mac_noisy(
                    a1, w1, seed, bits_a=bits, bits_w=bits, rows=rows,
                    **calibrated), iters=20),
                graph_ms=graph_ms(torch, lambda: bitplane_mac_noisy(
                    a1, w1, seed, bits_a=bits, bits_w=bits, rows=rows,
                    **calibrated)),
                plain_ms=cuda_ms(torch, lambda: bitplane_mac_noisy_torch(
                    a1.to(torch.int32), w1.to(torch.int32), seed,
                    bits_a=bits, bits_w=bits, rows=rows, **calibrated),
                    iters=1, warmup=1),
                bound_ms=b1, bound_by=by1, library_ms=None, elements=el1,
                shape=f"{what}'s (768,3072) projection of layer 0 at M={mt},"
                      " 8x8 bits, rows 8, calibrated mismatch, uniform "
                      "operands (the tensor-core kernel); ms, plain and "
                      "bound on the same inputs; library: none computes "
                      "the noisy pyramid")
            out[key]["one_projection"] = one
    out.update(library_ms=None, elements=elems, bytes=nbytes,
               shape="one decode step: 12 layers x {4x (768,768), "
                     "(768,3072), (3072,768)} at M=4, 8x8 bits, rows 8, "
                     "uint8 operands; ms / plain_ms / bound_ms: mismatch "
                     "only at the calibrated sigma 0.05, uniform operands; "
                     "*_both: mismatch 0.3 + comparator offset 0.03; "
                     "*_dense*: every operand 255; plain version timed "
                     "once on the 72 projections (*_both: on one layer's "
                     "six); bound: the larger "
                     "of the bytes at 3.35 TB/s and one Philox4x32-10 (40 "
                     "integer ops) per tier-3 element at 64 integer ops per "
                     "SM per clock; sfu_bound: a hardware Box-Muller (log, "
                     "sqrt, cos per normal + sqrt(k)) at 16 per SM per "
                     "clock, a floor the bit-exact stream cannot reach; "
                     "library: none computes the noisy pyramid")
    return out


def time_flash_attn(torch, dev):
    """One bucket-64 prefill's attention: 12 layers, B=1, S=64, H=KV=12,
    hd=64, bf16, causal."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                    flash_attention_torch)

    g = torch.Generator(device=dev).manual_seed(6)
    B, S, H, hd, layers = 1, 64, 12, 64, 12
    ins = [tuple(torch.randn((B, S, H, hd), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3)) for _ in range(layers)]
    # the library call takes (B, H, S, hd)
    lib_ins = [tuple(t.transpose(1, 2).contiguous() for t in x) for x in ins]
    def run():
        return [flash_attention(q, k, v) for q, k, v in ins]

    def library():
        return [F.scaled_dot_product_attention(q, k, v, is_causal=True)
                for q, k, v in lib_ins]

    ms = cuda_ms(torch, run, iters=50)
    g_ms = graph_ms(torch, run)
    plain = cuda_ms(torch, lambda: [flash_attention_torch(q, k, v)
                                    for q, k, v in ins], iters=20)
    lib = cuda_ms(torch, library, iters=50)
    lib_g = graph_ms(torch, library)
    nbytes = layers * 4 * B * S * H * hd * 2  # q, k, v read; out written
    visible = S * (S + 1) // 2  # causal (query, key) pairs
    ops = layers * B * H * visible * hd * 2 * 2  # q.k and p.v
    b_ms, by = bound(nbytes, ops, BF16_FLOPS_PER_S)
    return dict(ms=ms, graph_ms=g_ms, plain_ms=plain, library_ms=lib,
                library_graph_ms=lib_g, floor_graph_ms=floor_graph_ms(
                    torch, dev, layers), bound_ms=b_ms, bound_by=by,
                shape="one bucket-64 prefill: 12 layers x (B=1, S=64, "
                      "H=KV=12, hd=64, bf16, causal); library: "
                      "F.scaled_dot_product_attention(is_causal=True); "
                      "floor: 12 one-element launches from a graph")


TURN_PATHS = {"exact": (), "sim": ("--imc", "sim"),
              "noisy": ("--imc", "sim", "--imc-noise-sigma", "0.05")}


def eager_turns(parent: str) -> dict:
    """``--eager-turns PARENT``: the parent tree's serving (eager; PARENT
    is its checkout) against this tree's eager (``--eager``) and graph
    serving, on one card in turns (parent, eager, graph, graph, eager,
    parent) for each of ``TURN_PATHS``.  A turn runs
    ``repro_torch.launch.serve`` (full-width imc-paper-110m, six requests of
    32 tokens, 12 new; TTFT, TPOT and decode tokens/s; a graph serve's
    captures fall in it) and then ``repro_torch.launch.profile`` (8 decode
    ticks under the profiler after 3 warm-up ticks: device busy ms, idle
    share, device ops and ``cudaLaunchKernel`` calls per step) in the
    tree, each in a process of its own, after every kernel of the tree is
    built."""
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": (os.path.abspath(parent), ()),
             "eager": (here, ("--eager",)), "graph": (here, ())}

    def run(root, args, timeout=600):
        r = subprocess.run([sys.executable, *args], cwd=root, env={
            **os.environ, "PYTHONPATH": os.path.join(root, "src")},
            capture_output=True, text=True, timeout=timeout)
        if r.returncode:
            raise RuntimeError(f"{args} in {root} exited {r.returncode}: "
                               f"{r.stderr[-2000:]}")
        return r.stdout

    for root in {t[0] for t in trees.values()}:
        run(root, ["-c", "from repro_torch.kernels import build; "
                         "build.build_all()"], timeout=900)
    out = {}
    for path, fab in TURN_PATHS.items():
        for who in ("parent", "eager", "graph", "graph", "eager", "parent"):
            root, extra = trees[who]
            serve = json.loads(run(root, ["-m", "repro_torch.launch.serve",
                                          *fab, *extra]).splitlines()[-1])
            prof = json.loads(run(root, ["-m", "repro_torch.launch.profile",
                                         *fab, *extra]).splitlines()[-1])
            launch = [c["per_step"] for c in prof["top_runtime_calls"]
                      if c["name"] == "cudaLaunchKernel"]
            turn = {"ttft_p50_ms": serve["ttft_ms"]["p50"],
                    "tpot_p50_ms": serve["tpot_ms"]["p50"],
                    "tpot_p95_ms": serve["tpot_ms"]["p95"],
                    "decode_tok_s": serve["decode_tokens_per_s"],
                    "captures": serve.get("captures"),
                    "profiled_step_ms": prof["step_ms"],
                    "device_busy_ms_per_step":
                        prof["device_busy_ms_per_step"],
                    "device_idle_share": prof["device_idle_share"],
                    "device_ops_per_step": prof["device_ops_per_step"],
                    "cudaLaunchKernel_per_step": launch[0] if launch else 0}
            log(f"[turns] {path} {who}: {json.dumps(turn)}")
            out.setdefault(path, {}).setdefault(who, []).append(turn)
    return out


TIMERS = {"imc_mac": time_imc_mac, "paged_attn": time_paged_attn,
          "bitplane_mac": time_bitplane_mac, "flash_attn": time_flash_attn,
          "bitplane_mac_noisy": time_bitplane_mac_noisy,
          "imc_mac_dequant": time_imc_mac_dequant,
          "rbl_decode_mac": time_rbl_decode_mac}


# ----------------------------------------------------------- phase 9
# the attention-only families at full width: depth (layers) of each, its
# whole pattern period and at least two layers
# (phase 10's serves too: mamba2-370m at half its 48 layers, which holds
# phase 10 near 200 s; recurrentgemma-9b one (rglru, rglru, local) period
# and its two-block tail)
FAMILY_LAYERS = {"gemma3-12b": 6, "deepseek-coder-33b": 2, "qwen2-72b": 2,
                 "qwen3-moe-30b-a3b": 2, "dbrx-132b": 2,
                 "llava-next-mistral-7b": 2, "musicgen-large": 2,
                 "mamba2-370m": 24, "recurrentgemma-9b": 5,
                 "qwen2.5-3b": 2}  # 6e: 2 of 36 layers
SERVED_FAMILIES = ("gemma3-12b", "deepseek-coder-33b", "qwen2-72b",
                   "qwen3-moe-30b-a3b", "dbrx-132b")  # 9a: token configs
RECURRENT_FAMILIES = ("mamba2-370m", "recurrentgemma-9b")  # 10a-10c
# 9a/10a: sim (with flash prefill where a layer attends) too, and noisy sim
SIM_FAMILIES = ("gemma3-12b", "qwen3-moe-30b-a3b", "qwen2.5-3b") + \
    RECURRENT_FAMILIES
NOISY_FAMILIES = ("qwen3-moe-30b-a3b", "mamba2-370m")
FRONTEND_FAMILIES = ("llava-next-mistral-7b", "musicgen-large")  # 9c
# 9b/10c: (prompt, new tokens, bucket) of one request past the window
WINDOW_REQUESTS = {"gemma3-12b": (1000, 48, 1024),
                   "recurrentgemma-9b": (2000, 64, 2048)}
# 10b: (prompt, bucket) prefilled in the bucket and at its own length
# (fabric off); at 200 in 256 the bucket runs two SSD chunks of 128 and the
# recurrence between them, the exact length one chunk of 200 (mamba2 only)
STATE_PROMPTS = ((37, 64), (200, 256))
CHUNKED_REQUEST = (200, 16, 256)  # mamba2: prompt, new tokens, bucket
# 10b: relative L2 of each recurrent and conv state, bucketed prefill
# against exact length, on the card with the fabric off
STATE_RTOL = 1e-2
# 10b and 10d: the depth of each (mamba2-370m whole); 10d trains 2 steps
# at full width, batch 1 x seq 256
RECURRENT_DEPTH = {"mamba2-370m": 48, "recurrentgemma-9b": 5}
FRONTEND_LENGTHS, FRONTEND_BUCKET, FRONTEND_STEPS = (20, 45), 64, 8  # 9c
# 9d: (config, batch, seq) trained 2 steps at full width, 2 layers
TRAIN_FAMILIES = (("qwen3-moe-30b-a3b", 1, 256),
                  ("llava-next-mistral-7b", 1, 256))
TRAIN_FAMILY_STEPS = 2
# 9d, card against CPU at reduced width: 8c's loss bound (qwen3-moe's
# losses part 1.0009e-5: the experts' bf16 matmuls of two libraries round
# apart), and each device's loss against a float64 witness: the card's
# distance from it at most TRAIN_WITNESS_RATIO x the CPU's, or within 1e-5
FAMILY_LOSS_RTOL = TRAIN_LOSS_RTOL
FAMILY_WITNESS_LOSS_RTOL = 1e-5
GiB = float(1 << 30)


def free_device(torch):
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_of(name) -> str:
    """The phase that serves ``name``: 10 for the recurrent families, 6 for
    qwen2.5-3b (6e), else 9."""
    if name == "qwen2.5-3b":
        return "6"
    return "10" if name in RECURRENT_FAMILIES else "9"


def family_model(torch, dev, name, layers=None, **kw):
    """Full-width ``name`` at ``layers`` layers (default: its phase-9 or
    phase-10 serving depth), ``exact`` fabric, random weights from seed 0
    on the card; and its parameter count."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.fabric import FabricSpec
    from repro_torch.models.common import count_params
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(get_config(name),
                              n_layers=layers or FAMILY_LAYERS[name],
                              fabric=FabricSpec(mode="exact"), **kw)
    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n = count_params(params)
    log(f"[{phase_of(name)}] {name}: {cfg.n_layers} of "
        f"{get_config(name).n_layers} layers at full width (d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, hd "
        f"{cfg.hd}, d_ff {cfg.d_ff}"
        + (f", {cfg.n_experts} experts top-{cfg.top_k}" if cfg.n_experts
           else "")
        + (f", SSD state {cfg.ssm_state} x headdim {cfg.ssm_headdim}"
           if cfg.ssm_state else "")
        + (f", LRU width {cfg.lru_w}" if "rglru" in cfg.pattern else "")
        + f"): {n / 1e9:.3f} B params on {dev} in "
        f"{time.perf_counter() - t0:.2f} s")
    return cfg, params, n


def cpu_prefill(torch, params_cpu, cfg, batch):
    """The plain path's prefill logits on the CPU (f32)."""
    from repro_torch.models.model import prefill

    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, _ = prefill(params_cpu, batch, cfg)
    return logits.float(), time.perf_counter() - t0


def layerwise_gate(torch, tag, cfg, params, params_cpu, batch):
    """The bucketed prefill layer by layer: each layer run on the card and,
    from the card's input to it, on the CPU's plain path, and the head from
    the card's last hidden state; each output within ``LOGIT_RTOL`` of its
    largest magnitude.  Unlike the end-to-end logits, this does not let
    the two devices' rounding compound over the depth.  Returns the worst
    error per layer (relative to the output's largest magnitude) and the
    head's."""
    from repro_torch.models.common import rmsnorm
    from repro_torch.models.model import _embed_inputs, _head_weight
    from repro_torch.models.transformer import apply_block, layer_kinds

    n = int(batch["length"])
    dev = next(iter(params["blocks"]["layers"][0]["norm1"].values())).device
    errs = []
    with torch.inference_mode():
        x = _embed_inputs(params, {k: v.to(dev) if hasattr(v, "to") else v
                                   for k, v in batch.items()}, cfg)
        for i, kind in enumerate(layer_kinds(cfg)):
            y, _, _ = apply_block(params["blocks"]["layers"][i], x, kind, cfg,
                                  "prefill", true_len=n)
            yc, _, _ = apply_block(params_cpu["blocks"]["layers"][i],
                                   x.cpu(), kind, cfg, "prefill", true_len=n)
            a, b = y[0, :n].float().cpu(), yc[0, :n].float()
            errs.append(((a - b).abs().max() / b.abs().max()).item())
            x = y
        last = x[:, n - 1:n]
        lg = (rmsnorm(params["final_norm"], last) @ _head_weight(
            params, cfg).to(last.dtype)).float().cpu()
        lc = rmsnorm(params_cpu["final_norm"], last.cpu())
        lc = (lc @ _head_weight(params_cpu, cfg).to(lc.dtype)).float()
    head = ((lg - lc).abs().max() / lc.abs().max()).item()
    if max(errs + [head]) > LOGIT_RTOL:
        raise AssertionError(f"{tag}: layer by layer, card vs the CPU's plain "
                             f"path: worst {errs} (layers), {head} (head) > "
                             f"{LOGIT_RTOL}")
    return errs, head


def logit_gate(tag, card, plain):
    err = (card - plain).abs().max().item()
    scale = plain.abs().max().item()
    if not err <= LOGIT_RTOL * scale:
        raise AssertionError(f"{tag}: card vs the plain path max err {err} "
                             f"> {LOGIT_RTOL} x {scale}")
    return err, scale


# 9a: the end-to-end prefill logits, card against the CPU, are gated at
# LOGIT_RTOL for configs cut to at most this many layers.  Deeper, the two
# devices' roundings compound (``--drift``): gemma3's six layers part 3.1e-2
# (rel L2 of the hidden state) by the last, its logits 4.2e-2 of their
# largest; the CPU alone, fabric off, parts 0.0625 of 5.47 in its logits
# between 3 and 8 threads.  Every layer is gated on its own
# (``layerwise_gate``).
E2E_GATED_LAYERS = 2


def fmt_errs(errs) -> str:
    return "[" + ", ".join(f"{e:.2e}" for e in errs) + "]"


def end_to_end(tag, cfg, card, plain):
    """The end-to-end logits' max error and scale, gated at ``LOGIT_RTOL``
    up to ``E2E_GATED_LAYERS`` layers."""
    err = (card - plain).abs().max().item()
    scale = plain.abs().max().item()
    if cfg.n_layers <= E2E_GATED_LAYERS:
        logit_gate(tag, card, plain)
    return err, scale


def attn_layers(cfg):
    """(attention layers of ``cfg``, the ``paged_attn`` kernel they take by
    ``paged_variant``: bf16 queries over its ``kv_dtype`` pools)."""
    from repro_torch.models.transformer import ATTN_KINDS, layer_kinds

    n = sum(k in ATTN_KINDS for k in layer_kinds(cfg))
    rep = cfg.n_heads // cfg.n_kv_heads
    return n, paged_variant(cfg.kv_dtype, rep, cfg.hd)


def check_counts(tag, counts, want):
    bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if bad:
        raise AssertionError(f"{tag}: launches (got, want) {bad}; all "
                             f"{counts}")


def serve_family(torch, dev, name):
    """6e / 9a / 10a: ``name`` served through ``Server`` + ``Engine`` as
    phase 6 serves (``serve_path``): ``exact``; ``sim`` (with flash prefill where
    a layer attends) and noisy ``sim`` where asked.  Launches per decode
    step and per bucketed prefill asserted by kernel name: ``imc_mac`` (or
    ``bitplane_mac``) once per fabric projection (``dense_calls``), the
    paged kernel of its rep and the flash kernel of its hd once per
    attention layer, none of either without one; first-prefill logits held
    against the plain path on the CPU.  A family with a window adds 9b or
    10c, the request past it."""
    import dataclasses

    import numpy as np

    from repro_torch.core.fabric import FabricSpec
    from repro_torch.models.transformer import dense_calls

    ph = phase_of(name)
    sa = "6e" if ph == "6" else f"{ph}a"  # the serve's tag
    t0 = time.perf_counter()
    cfg, params, n_params = family_model(torch, dev, name)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    layers, calls = cfg.n_layers, dense_calls(cfg)
    attn, paged = attn_layers(cfg)
    step_paged = paged_counts(paged, attn)
    other_paged = tuple(k for k in PAGED_VARIANTS if not step_paged[k])
    # kernels an attention layer must launch, and what no layer may
    attn_must = ("paged_attn",) if attn else ()
    attn_never = other_paged if attn else ("paged_attn",)
    out = {"layers": layers, "params": n_params, "dense_calls": calls,
           "attn_layers": attn}
    exact, card = serve_path(torch, dev, cfg, params, prompts,
                             f"{name} exact", must=("imc_mac",) + attn_must,
                             never=("bitplane_mac", "flash_attn",
                                    "bitplane_mac_noisy") + attn_never)
    log_turns(f"{name} exact", exact)
    check_counts(f"{name} exact, a decode step", exact["per_decode_step"],
                 {"imc_mac_split": calls, "imc_mac_tiled": 0, **step_paged})
    for bucket, prompt in ((32, prompts[5][:20]), (64, prompts[2])):
        zero_counts()
        first_prefill(torch, dev, params, cfg, prompt, bucket=bucket)
        counts = read_counts()
        check_counts(f"{name} exact, a bucket-{bucket} prefill", counts,
                     {"imc_mac_tiled": calls, "imc_mac_split": 0,
                      "paged_attn": 0, "flash_attn": 0})
        exact[f"per_prefill_{bucket}"] = counts
    params_cpu = _to_cpu(params)
    padded = torch.zeros((1, 16), dtype=torch.int32)
    padded[0, :PROMPTS[0]] = torch.from_numpy(prompts[0])
    batch = {"tokens": padded, "length": PROMPTS[0]}
    plain, cpu_s = cpu_prefill(torch, params_cpu, cfg, batch)
    err, scale = end_to_end(f"{name} exact", cfg, card, plain)
    layer_errs, head_err = layerwise_gate(torch, f"{name} exact", cfg, params,
                                          params_cpu, batch)
    exact.update(logit_err=err, logit_scale=scale, cpu_prefill_s=cpu_s,
                 layer_errs=layer_errs, head_err=head_err)
    log(f"[{sa}] {name} exact: prefill logits card vs CPU plain path max "
        f"err {err:.3g} (largest |logit| {scale:.3g}, CPU {cpu_s:.1f} s); "
        f"layer by layer from the card's inputs {fmt_errs(layer_errs)}, "
        f"head {head_err:.2e} (of each output's largest magnitude); "
        f"{calls} split-K imc_mac and {attn} {paged} launches a decode "
        f"step (and as many merges at rep 9-16), {calls} tensor-core "
        "imc_mac a bucket-32/64 prefill")
    out["exact"] = exact
    kernel = flash_variant("bf16", cfg.hd)
    other = ({"flash_attn_tc", "flash_attn_simt"} - {kernel}).pop()
    # a path with flash prefill: what its attention layers must and must
    # not launch
    flash_must = ("flash_attn", "paged_attn") if attn else ()
    flash_never = ((other,) + other_paged if attn
                   else ("flash_attn", "paged_attn"))
    if name in SIM_FAMILIES:
        sim_cfg = dataclasses.replace(cfg, fabric=FabricSpec(mode="sim"),
                                      use_flash_kernel=True)
        stag = f"{name} sim" + ("+flash" if attn else "")
        sim, sim_flash = serve_path(
            torch, dev, sim_cfg, params, prompts, stag,
            must=("bitplane_mac",) + flash_must,
            never=("imc_mac", "bitplane_mac_noisy") + flash_never)
        log_turns(stag, sim)
        check_counts(f"{stag}, a decode step", sim["per_decode_step"],
                     {"bitplane_mac": calls, **step_paged})
        check_counts(f"{stag}, a prefill", sim["per_prefill"],
                     {"flash_attn": attn, kernel: attn})
        sim_dense = first_prefill(torch, dev, params, dataclasses.replace(
            sim_cfg, use_flash_kernel=False), prompts[0])
        if not torch.equal(sim_dense, card):
            raise AssertionError(f"{name}: sim prefill logits differ from "
                                 "exact's on the card")
        ferr = fscale = flayers = fhead = None
        if attn:
            flash_cfg = dataclasses.replace(cfg, use_flash_kernel=True)
            if cfg.n_layers <= E2E_GATED_LAYERS:
                plain_flash, _ = cpu_prefill(torch, params_cpu, flash_cfg,
                                             batch)
                ferr, fscale = end_to_end(f"{name} sim+flash", cfg,
                                          sim_flash, plain_flash)
            # sim == exact bit for bit on the card, so the card's flash path
            # is checked layer by layer in exact with flash
            flayers, fhead = layerwise_gate(torch, f"{name} flash",
                                            flash_cfg, params, params_cpu,
                                            batch)
        sim.update(logit_err=ferr, logit_scale=fscale, layer_errs=flayers,
                   head_err=fhead)
        log(f"[{sa}] {stag}: sim prefill logits equal exact's bit for bit"
            + ("" if ferr is None else
               f"; card vs CPU plain path (flash) max err {ferr:.3g} "
               f"(largest |logit| {fscale:.3g})")
            + ("" if flayers is None else
               f"; layer by layer (exact with flash) {fmt_errs(flayers)}, "
               f"head {fhead:.2e}; {kernel} {attn} a prefill")
            + f"; {calls} bitplane_mac a decode step")
        out["sim_flash"] = sim
    if name in NOISY_FAMILIES:
        ntag = f"{name} sim+noise" + ("+flash" if attn else "")
        noisy, _ = serve_path(
            torch, dev, noisy_config(cfg), params, prompts, ntag,
            must=("bitplane_mac_noisy",) + flash_must,
            never=("imc_mac", "bitplane_mac") + flash_never,
            noise_seed=NOISE_SEED)
        log_turns(ntag, noisy)
        noisy_gate(f"{ntag}, a decode step", noisy["per_decode_step"], 4,
                   calls)
        noisy_gate(f"{ntag}, a bucket-16 prefill", noisy["per_prefill"], 16,
                   noisy["per_prefill"]["bitplane_mac_noisy"])
        out["sim_noise"] = noisy
    if name in WINDOW_REQUESTS:
        # gated with the fabric off: the exact fabric requantizes each
        # decode row per tensor, so the paged kernel's f32 softmax and the
        # ring's bf16 one, an ulp apart, compound over the layers (gemma3:
        # 3.7e-2 of the largest |logit| at the first decode step); the
        # window's masking itself is held bit-level in phase 3's cases
        out["window"] = window_request(torch, dev, dataclasses.replace(
            cfg, fabric=None), params, *WINDOW_REQUESTS[name])
        out["window_exact"] = window_request(
            torch, dev, cfg, params, *WINDOW_REQUESTS[name], gate=False)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / GiB
    out["wall_s"] = time.perf_counter() - t0
    log(f"[{sa} {name}] {out['wall_s']:.1f} s, peak device memory "
        f"{out['peak_gib']:.2f} GiB")
    del params, params_cpu
    free_device(torch)
    return out


def recurrent_state(torch, dev, name):
    """10b at ``RECURRENT_DEPTH``: ``bucket_state`` at each of
    ``STATE_PROMPTS`` (the second, two SSD chunks, for an SSD config only),
    and an SSD config's ``CHUNKED_REQUEST`` served from graphs against the
    unpaged decode (``window_request``)."""
    import dataclasses

    t0 = time.perf_counter()
    cfg, params, _ = family_model(torch, dev, name,
                                  layers=RECURRENT_DEPTH[name])
    ssd = "ssd" in cfg.pattern
    out = {"layers": cfg.n_layers,
           "state": [bucket_state(torch, dev, cfg, params, n, bucket)
                     for n, bucket in STATE_PROMPTS[:1 + ssd]]}
    if ssd:
        out["chunked"] = window_request(
            torch, dev, dataclasses.replace(cfg, fabric=None), params,
            *CHUNKED_REQUEST)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[10b {name}] {out['wall_s']:.1f} s")
    del params
    free_device(torch)
    return out


def bucket_state(torch, dev, cfg, params, n, bucket):
    """10b: one prompt of ``n`` tokens prefilled on the card in a bucket of
    ``bucket`` (its length a device tensor, as the Server's graphs take it)
    and at its own length, with the fabric off (the
    ``exact`` fabric quantizes each projection's input per tensor, padding
    rows included, so a bucket is no exact-length prefill there).  Layer by
    layer, from the same input (the exact-length run's, the bucket's padding
    after it): every recurrent and conv state within ``STATE_RTOL``
    relative L2, and one decode step from each layer's two states, on the
    same input, within ``LOGIT_RTOL`` of its largest magnitude.  End to end
    (both prefills through the whole stack, then the next decode step),
    the states and logits part as the two chunkings' roundings compound
    over the depth (one bf16 ulp flipped in a layer's output grows through
    the next): measured, not gated."""
    import dataclasses

    import numpy as np

    from repro_torch.models.model import _embed, decode_step, prefill
    from repro_torch.models.transformer import (RECURRENT_CACHES,
                                                apply_block, layer_kinds)

    cfg = dataclasses.replace(cfg, fabric=None)
    prompt = np.random.default_rng(10).integers(
        0, cfg.vocab_size, n).astype(np.int32)
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = prompt
    tokens = torch.from_numpy(padded).to(dev)
    length = torch.tensor(n, device=dev)
    pos = torch.tensor(n, dtype=torch.int32, device=dev)

    def states(c):
        return list(c) if isinstance(c, RECURRENT_CACHES) else []

    layer_states, step_errs = [], []
    with torch.inference_mode():
        xe = _embed(params, tokens[:, :n])
        pad = _embed(params, tokens[:, n:])
        le, ce = prefill(params, {"tokens": tokens[:, :n]}, cfg,
                         max_new_tokens=1)
        tok = le.argmax(-1).reshape(1, 1).to(torch.int32)
        xd = _embed(params, tok)
        for i, kind in enumerate(layer_kinds(cfg)):
            p = params["blocks"]["layers"][i]
            ye, c_e, _ = apply_block(p, xe, kind, cfg, "prefill",
                                     prefill_extra=1)
            _, c_b, _ = apply_block(p, torch.cat([xe, pad], dim=1), kind,
                                    cfg, "prefill", true_len=length)
            layer_states += [rel_l2(b.float(), e.float())
                             for b, e in zip(states(c_b), states(c_e))]
            de, _, _ = apply_block(p, xd, kind, cfg, "decode", cache=c_e,
                                   pos=pos)
            db, _, _ = apply_block(p, xd, kind, cfg, "decode", cache=c_b,
                                   pos=pos)
            step_errs.append(((db - de).float().abs().max()
                              / de.float().abs().max()).item())
            xe, xd = ye, de
        # end to end
        lb, cb = prefill(params, {"tokens": tokens, "length": length}, cfg)
        nb, _ = decode_step(params, cb, tok, cfg)
        ne, _ = decode_step(params, ce, tok, cfg)
    e2e_states = [rel_l2(b.float(), e.float())
                  for cb_i, ce_i in zip(cb.layers, ce.layers)
                  for b, e in zip(states(cb_i), states(ce_i))]
    e2e_logits = [((x - y).abs().max() / y.abs().max()).item()
                  for x, y in ((lb, le), (nb, ne))]
    log(f"[10b] {cfg.name}: a {n}-token prompt prefilled in a "
        f"{bucket} bucket against its own length, fabric off; layer "
        f"by layer from the same input: states (each recurrent layer's "
        f"state, then its conv state) rel L2 worst {max(layer_states):.3g} "
        f"{fmt_errs(layer_states[:8])} ... (bound {STATE_RTOL}), the next "
        f"decode step's layer outputs worst {max(step_errs):.3g} (bound "
        f"{LOGIT_RTOL}); end to end (not gated) states rel L2 by layer "
        f"{fmt_errs(e2e_states)}, last logits {e2e_logits[0]:.3g} and the "
        f"next step's {e2e_logits[1]:.3g} of the largest |logit|")
    if max(layer_states) > STATE_RTOL or max(step_errs) > LOGIT_RTOL:
        raise AssertionError(f"[10b] {cfg.name}: states {layer_states}, "
                             f"decode steps {step_errs}")
    return {"prompt": n, "bucket": bucket,
            "layer_state_rel_l2": layer_states, "layer_step_errs": step_errs,
            "e2e_state_rel_l2": e2e_states, "e2e_logit_errs": e2e_logits}


def window_request(torch, dev, cfg, params, prompt_len, new, bucket,
                   gate: bool = True):
    """9b / 10c / 10b's chunked request: one request of ``prompt_len``
    tokens in a bucket of ``bucket`` and ``new`` new tokens, served through
    ``Server`` + ``Engine`` (graphs); its logits at every step held
    against a decode without paging from the same bucketed prefill, its
    rings grown by the new tokens' rows (a prefill at the prompt's own
    length is no oracle: under a fabric, which quantizes each projection's
    input per tensor, padding rows included, and over many layers, where
    another chunking's roundings compound; 10b holds that layer by layer),
    the served tokens fed back; greedy tokens equal where the margin
    allows.  ``gate=False`` measures without gating the logits."""
    import numpy as np

    from repro_torch.launch.engine import Engine
    from repro_torch.launch.server import Request, Server
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.models.transformer import StackCache, dense_calls
    from repro_torch.telemetry import Registry

    ph = "9b" if cfg.name == "gemma3-12b" else \
        "10" + ("c" if cfg.window else "b")
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
    engine = Engine(dev, registry=Registry())
    server = Server(cfg, params, engine=engine,
                    slots=1, kv="paged", block_size=16,
                    buckets=(bucket,),
                    max_seq_len=bucket + 64, registry=Registry())
    served = []
    prefill_fn, decode_fn = server._prefill, server._decode_logits
    server._prefill = lambda h, slot: served.append(
        np.array(prefill_fn(h, slot))) or served[-1]
    server._decode_logits = lambda toks: served.append(
        np.array(decode_fn(toks)[0])) or served[-1][None]
    zero_counts()
    h = server.submit(Request(prompt, max_new_tokens=new))
    server.drain()
    torch.cuda.synchronize()
    launches = read_counts()
    # a new graph engine: the prefill, admission and decode steps each run
    # once more as their capture's warm-up
    warm = int(engine.graphs)
    steps = new - 1 + warm
    calls = dense_calls(cfg) if cfg.imc_fabric is not None else 0
    attn, paged = attn_layers(cfg)
    want = {**paged_counts(paged, steps * attn),
            "imc_mac_split": steps * calls,
            "imc_mac_tiled": (1 + warm) * calls}
    if not h.done or len(served) != new or any(
            launches[k] != v for k, v in want.items()):
        raise AssertionError(f"[{ph}] the request served {len(served)} "
                             f"steps with launches {launches}; expected "
                             f"{want}")
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :prompt_len] = prompt
    ring = []
    with torch.inference_mode():
        logits, cache = prefill(params, {"tokens": torch.from_numpy(
            padded).to(dev), "length": prompt_len}, cfg)
        cache = StackCache([grow_ring(torch, c, new)
                            for c in cache.layers], cache.pos)
        ring.append(logits[0].float().cpu().numpy())
        for t in h.tokens[:-1]:
            logits, cache = decode_step(params, cache, torch.tensor(
                [[t]], dtype=torch.int32, device=dev), cfg)
            ring.append(logits[0].float().cpu().numpy())
    errs, scales, checked = [], [], 0
    for i, (s, r) in enumerate(zip(served, ring)):
        err, scale = float(np.max(np.abs(s - r))), float(np.max(np.abs(r)))
        errs.append(err)
        scales.append(scale)
        if gate and err > LOGIT_RTOL * scale:
            raise AssertionError(f"[{ph}] step {i} (position "
                                 f"{prompt_len + i}): served vs unpaged max "
                                 f"err {err} > {LOGIT_RTOL} x {scale}")
        top2 = np.sort(r)[-2:]
        if gate and top2[1] - top2[0] > LOGIT_RTOL * scale:
            checked += 1
            if int(np.argmax(r)) != h.tokens[i]:
                raise AssertionError(f"[{ph}] step {i}: served token "
                                     f"{h.tokens[i]}, unpaged argmax "
                                     f"{int(np.argmax(r))}")
    rel = [e / sc for e, sc in zip(errs, scales)]
    fabric = cfg.imc_fabric.mode if cfg.imc_fabric is not None else "off"
    log(f"[{ph}] {cfg.name}, fabric {fabric}: a {prompt_len}-token prompt "
        f"in a {bucket} bucket and {new} new tokens (positions to "
        f"{prompt_len + new - 1}, window {cfg.window}) served paged from "
        f"graphs against the unpaged decode from the same bucketed prefill: "
        f"worst step {max(rel):.3g} of its largest |logit| (by "
        f"step {fmt_errs(rel[:8])} ...)"
        + (f", within {LOGIT_RTOL}; {checked} of {new} greedy tokens "
           "checked, all equal" if gate else " (not gated)")
        + f"; launches {launches}")
    return {"max_rel_err": max(rel), "rel_errs": rel,
            "tokens_checked": checked, "launches": launches}


def grow_ring(torch, c, extra: int):
    """A ring cache (``AttnCache``) with ``extra`` empty rows appended, so
    that decode positions up to ``extra`` past its length wrap onto none; a
    recurrent layer's state as it is."""
    from repro_torch.models.attention import AttnCache

    if not isinstance(c, AttnCache):
        return c

    def grow(t, fill=0):
        if t is None:
            return None
        pad = t.new_full((t.shape[0], extra) + tuple(t.shape[2:]), fill)
        return torch.cat([t, pad], dim=1)

    return type(c)(grow(c.k), grow(c.v), grow(c.key_pos, -1),
                   grow(c.k_scale), grow(c.v_scale))


def frontend_family(torch, dev, name):
    """9c: ``name`` prefilled from its stream's embeddings with flash
    attention, merged into paged pools with the Server's helpers, then
    decoded greedily through block tables, in ``exact`` and with the fabric
    off, on the same weights.  Held against the CPU's plain path: in
    ``exact``, each prefill layer by layer (``layerwise_gate``); with the
    fabric off, every step's logits, each decode step from the card's own
    state (its pools copied to the CPU).  In ``exact`` a decode step is not
    held whole: the fabric quantizes its two rows per tensor, so one ulp at
    the largest element (the two devices' attention) moves every code of a
    projection; whole steps are measured, and the whole run on the CPU
    (from the card's tokens) is run with the fabric off."""
    import dataclasses

    import numpy as np

    from repro_torch.data.pipeline import round_to_bf16
    from repro_torch.models.kv_cache import (BlockAllocator,
                                             init_paged_cache,
                                             merge_prefill_cache)
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.models.transformer import StackCache, dense_calls

    t0 = time.perf_counter()
    exact_cfg, params, n_params = family_model(torch, dev, name,
                                               use_flash_kernel=True)
    rng = np.random.default_rng(0)
    slots, bs = len(FRONTEND_LENGTHS), 16
    mb = -(-(FRONTEND_BUCKET + FRONTEND_STEPS) // bs)
    embs = []
    for n in FRONTEND_LENGTHS:
        e = np.zeros((1, FRONTEND_BUCKET, exact_cfg.frontend_dim), np.float32)
        e[0, :n] = round_to_bf16(rng.standard_normal(
            (n, exact_cfg.frontend_dim), dtype=np.float32))
        embs.append(torch.from_numpy(e))
    params_cpu = _to_cpu(params)
    layers = exact_cfg.n_layers

    def to_cpu(cache):
        return StackCache([type(c)(*[None if t is None else t.cpu()
                                     for t in c]) for c in cache.layers],
                          cache.pos.cpu())

    def run(cfg, p, device, tokens=None, step_errs=None):
        """Prefill both prompts, merge, decode; returns every step's logits
        (prefill first) and launches.  ``step_errs`` collects each decode
        step's error against the CPU from the state before it."""
        alloc = BlockAllocator(slots * mb, bs, slots, max_blocks_per_slot=mb)
        logits, cache, counts = [], None, []
        with torch.inference_mode():
            rows = []
            for slot, (n, e) in enumerate(zip(FRONTEND_LENGTHS, embs)):
                alloc.alloc(slot, alloc.blocks_for(n + FRONTEND_STEPS))
                zero_counts()
                lg, one = prefill(p, {"embeddings": e.to(device),
                                      "length": n}, cfg)
                counts.append(read_counts())
                rows.append(lg[0])
                if cache is None:
                    cache = init_paged_cache(one, slots, slots * mb, bs)
                merge_prefill_cache(cache, one, torch.from_numpy(
                    alloc.table_row(slot)).to(device), slot)
            logits.append(torch.stack(rows).float().cpu())
            tbl = torch.from_numpy(alloc.table())
            for i in range(FRONTEND_STEPS):
                tok = (logits[-1].argmax(-1) if tokens is None
                       else tokens[i]).reshape(slots, 1).to(torch.int32)
                before = to_cpu(cache) if step_errs is not None else None
                zero_counts()
                lg, cache = decode_step(p, cache, tok.to(device), cfg,
                                        block_table=tbl.to(device))
                counts.append(read_counts())
                logits.append(lg.float().cpu())
                if step_errs is not None:
                    plain, _ = decode_step(params_cpu, before, tok, cfg,
                                           block_table=tbl)
                    step_errs.append(((logits[-1] - plain.float()).abs()
                                      .max() / plain.abs().max()).item())
        return logits, counts

    out = {"layers": layers, "params": n_params}
    for tag, cfg in (("exact", exact_cfg),
                     ("off", dataclasses.replace(exact_cfg, fabric=None))):
        calls = dense_calls(cfg) if cfg.imc_fabric is not None else 0
        step_errs = []
        card, counts = run(cfg, params, dev, step_errs=step_errs)
        for c in counts[:slots]:
            if c["flash_attn_tc"] != layers or c["flash_attn"] != layers or \
                    c["imc_mac_tiled"] != calls or c["imc_mac"] != calls or \
                    c["paged_attn"]:
                raise AssertionError(f"[9c] {name} {tag}: a prefill launched "
                                     f"{c}; expected {layers} tensor-core "
                                     f"flash_attn and {calls} tensor-core "
                                     "imc_mac")
        for c in counts[slots:]:
            if c["paged_attn_split"] != layers or c["paged_attn"] != layers \
                    or c["imc_mac_split"] != calls or c["imc_mac"] != calls \
                    or c["flash_attn"]:
                raise AssertionError(f"[9c] {name} {tag}: a decode step "
                                     f"launched {c}")
        row = {"step_errs": step_errs, "launches_per_prefill": counts[0],
               "launches_per_decode_step": counts[-1]}
        if tag == "exact":
            row["prefill_layer_errs"] = [
                layerwise_gate(torch, f"[9c] {name} prefill {n}", cfg,
                               params, params_cpu,
                               {"embeddings": e, "length": n})
                for n, e in zip(FRONTEND_LENGTHS, embs)]
            gated = ("prefill layer by layer " + ", ".join(
                fmt_errs(e) + f" head {h:.2e}"
                for e, h in row["prefill_layer_errs"]))
        else:  # the whole run on the CPU, from the card's tokens
            tokens = [card[i].argmax(-1) for i in range(FRONTEND_STEPS)]
            plain, _ = run(cfg, params_cpu, torch.device("cpu"), tokens)
            e2e = row["end_to_end_errs"] = [
                ((c - p_).abs().max() / p_.abs().max()).item()
                for c, p_ in zip(card, plain)]
            if max(step_errs + e2e[:1]) > LOGIT_RTOL:
                raise AssertionError(f"[9c] {name} fabric off: card vs the "
                                     f"CPU, prefill {e2e[0]}, decode steps "
                                     f"{step_errs} > {LOGIT_RTOL}")
            gated = (f"prefill {e2e[0]:.2e}, decode steps from the card's "
                     f"state {fmt_errs(step_errs)}")
        out[tag] = row
        log(f"[9c] {name} fabric {tag}: prefill from embeddings (flash) into "
            f"paged pools and {FRONTEND_STEPS} decode steps; card vs CPU "
            f"plain path, gated: {gated}; measured: decode steps from the "
            f"card's state {fmt_errs(step_errs)}"
            + (f", the whole run {fmt_errs(row['end_to_end_errs'])}"
               if "end_to_end_errs" in row else "")
            + f" (of the largest |logit|); launches per prefill "
            f"{counts[0]}, per decode step {counts[-1]}")
    out.update(launches_per_prefill=out["exact"]["launches_per_prefill"],
               launches_per_decode_step=out["exact"][
                   "launches_per_decode_step"],
               launches_per_prefill_off=out["off"]["launches_per_prefill"],
               launches_per_decode_step_off=out["off"][
                   "launches_per_decode_step"],
               peak_gib=torch.cuda.max_memory_allocated() / GiB,
               wall_s=time.perf_counter() - t0)
    log(f"[9c {name}] {out['wall_s']:.1f} s, peak {out['peak_gib']:.2f} GiB")
    del params, params_cpu
    free_device(torch)
    return out


def leaf_bytes(tree):
    from repro_torch.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if hasattr(t, "numel"))


def train_family(torch, dev, name, batch, seq, layers=2):
    """9d / 10d: ``TRAIN_FAMILY_STEPS`` steps of full-width ``name``
    (``layers`` layers, ``exact``) through ``launch.train.train`` and the
    Engine: imc_mac alone launches, twice per fabric projection a step
    (remat), no plain version runs; the MoE metrics present; step time and
    peak memory, the peak reckoned from the leaves."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.fabric import FabricSpec
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import dense_calls
    from repro_torch.telemetry import Registry

    cfg = dataclasses.replace(get_config(name), n_layers=layers,
                              fabric=FabricSpec(mode="exact"))
    ph = phase_of(name)
    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    per_step = 2 * dense_calls(cfg)
    t0 = time.perf_counter()
    (params, opt), hist, launches = train_run(
        torch, cfg, f"[{ph}d] {name}", ("imc_mac", "imc_mac_tiled"), per_step,
        TRAIN_FAMILY_STEPS, batch, seq,
        Engine(dev, noise_seed=0, registry=Registry()))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for m in hist:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"[{ph}d] {name}: metrics {m}")
        if cfg.n_experts and not {"load_balance_loss",
                                  "router_z_loss"} <= set(m):
            raise AssertionError(f"[{ph}d] {name}: no MoE metrics in {m}")
    sizes = {"params": leaf_bytes(params), "grads": leaf_bytes(params),
             "adamw_state": leaf_bytes(opt)}
    out = {"layers": layers, "batch": batch, "seq": seq, "steps": len(hist),
           "metrics": hist, "launches": launches,
           "step_s": [m["step_s"] for m in hist], "peak_gib": peak / GiB,
           "leaves_gib": {k: v / GiB for k, v in sizes.items()},
           "wall_s": wall}
    log(f"[{ph}d] {name} ({layers} layers, batch {batch} x seq {seq}): "
        f"losses "
        f"{[round(m['loss'], 4) for m in hist]}, metrics {hist[-1]}; step "
        f"times {[round(m['step_s'], 3) for m in hist]} s; imc_mac "
        f"{launches['imc_mac']} launches ({per_step} a step); peak device "
        f"memory {peak / GiB:.2f} GiB against leaves {out['leaves_gib']} "
        f"(a step holds the old and the new params and AdamW state)")
    del params, opt
    free_device(torch)
    return out


def train_family_card_vs_cpu(torch, dev, name, layers=2):
    """9d / 10d: ``layers`` layers of ``name`` at ``reduce_config`` width,
    the card against the CPU's plain path: loss within
    ``FAMILY_LOSS_RTOL``, each gradient leaf within ``TRAIN_GRAD_RTOL``
    (bf16 params) and within ``TRAIN_WITNESS_RATIO`` x the CPU's distance
    from a float64 witness."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.fabric import FabricSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.models.model import init_params, loss_and_grads
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(reduce_config(get_config(name)), n_layers=layers,
                              fabric=FabricSpec(mode="exact"), remat=False)
    ph = phase_of(name)
    cpu_params = init_params(cfg, device="cpu", seed=0)
    fd = cfg.frontend_dim if cfg.frontend != "none" else 0
    nb = SyntheticStream(DataConfig(cfg.vocab_size, 64, 2,
                                    frontend_dim=fd)).batch(0)
    res = {}
    for where, p in (("card", tree_map(lambda t: t.to(dev), cpu_params)),
                     ("cpu", cpu_params),
                     ("witness", tree_map(lambda t: t.to(torch.float64),
                                          cpu_params))):
        d = tree_leaves(p)[0].device
        b = {k: torch.from_numpy(v).to(d) for k, v in nb.items()}
        loss, metrics, grads = loss_and_grads(p, b, cfg)
        res[where] = (float(loss), [g.cpu() for g in tree_leaves(grads)])
    (lc, gc), (lp, gp), (lw, gw) = res["card"], res["cpu"], res["witness"]
    loss_err = abs(lc - lp) / abs(lp)
    card_w, cpu_w = abs(lc - lw) / abs(lw), abs(lp - lw) / abs(lw)
    loss_ok = card_w <= max(TRAIN_WITNESS_RATIO * cpu_w,
                            FAMILY_WITNESS_LOSS_RTOL)
    worst = worst_rel_l2(gc, gp)
    ratio = max(((x.double() - w).norm() / max(
        (y.double() - w).norm(), 1e-30)).item()
        for x, y, w in zip(gc, gp, gw) if w.norm() > 0)
    log(f"[{ph}d] {name} reduced ({layers} layers), card vs CPU: loss "
        f"{lc:.6f} / "
        f"{lp:.6f} (rel {loss_err:.2e}); float64 witness {lw:.6f}, the card "
        f"{card_w:.2e} and the CPU {cpu_w:.2e} from it; worst gradient rel "
        f"L2 by leaf dtype {worst}; worst per-leaf distance from the "
        f"witness, card over CPU, {ratio:.3f}")
    if loss_err > FAMILY_LOSS_RTOL or not loss_ok or \
            max(worst.values()) > TRAIN_GRAD_RTOL["bfloat16"] or \
            ratio > TRAIN_WITNESS_RATIO:
        raise AssertionError(f"[{ph}d] {name} reduced: loss {loss_err}, grads "
                             f"{worst}, witness ratio {ratio}")
    return {"loss_rel_err": loss_err, "loss_card_to_witness": card_w,
            "loss_cpu_to_witness": cpu_w, "grad_rel_l2": worst,
            "witness_ratio": ratio}


def phase_families(torch, dev, only=None):
    """Phase 9: the seven attention-only families (module docstring);
    ``only`` names the configs to run (default: all)."""
    t0 = time.perf_counter()
    out = {"train": {}, "train_card_vs_cpu": {}}
    for name, batch, seq in TRAIN_FAMILIES:
        if only is None or name in only:
            out["train"][name] = train_family(torch, dev, name, batch, seq)
            out["train_card_vs_cpu"][name] = train_family_card_vs_cpu(
                torch, dev, name)
    for name in SERVED_FAMILIES:
        if only is None or name in only:
            out[name] = serve_family(torch, dev, name)
    for name in FRONTEND_FAMILIES:
        if only is None or name in only:
            out[name] = frontend_family(torch, dev, name)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[9] families: {out['wall_s']:.1f} s in all")
    return out


def phase_recurrent(torch, dev, only=None):
    """Phase 10: the recurrent families (module docstring); ``only`` names
    the configs to run (default: both)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    out = {"train": {}, "train_card_vs_cpu": {}, "state": {}}
    for name in RECURRENT_FAMILIES:
        if only is not None and name not in only:
            continue
        out["train"][name] = train_family(torch, dev, name, 1, 256,
                                          layers=RECURRENT_DEPTH[name])
        cfg = get_config(name)  # one pattern period and the tail
        out["train_card_vs_cpu"][name] = train_family_card_vs_cpu(
            torch, dev, name, layers=max(2, len(cfg.pattern) + len(cfg.tail)))
        out[name] = serve_family(torch, dev, name)
        out["state"][name] = recurrent_state(torch, dev, name)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[10] recurrent families: {out['wall_s']:.1f} s in all")
    return out


def own_process(torch, args, timeout=900):
    """This script with ``args`` in a process of its own (a fresh CUDA
    context, allocator and profiler), after this one's cached device memory
    is freed; its log is echoed, its JSON line (the one before the last)
    returned."""
    free_device(torch)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), *args],
                       cwd=ROOT, stdout=subprocess.PIPE, text=True,
                       timeout=timeout)
    lines = r.stdout.splitlines()
    for line in lines[:-2]:
        log(line)
    if r.returncode:
        raise AssertionError(f"chip_smoke.py {' '.join(args)} exited "
                             f"{r.returncode}")
    return json.loads(lines[-2])


def recurrent_launches(rec, kernel):
    """A kernel's launches over phase 10's served, state, window and
    training runs."""
    n = 0
    for name in RECURRENT_FAMILIES:
        for path in ("exact", "sim_flash", "sim_noise", "window",
                     "window_exact"):
            if path in rec.get(name, {}):
                n += rec[name][path]["launches"][kernel]
        if "chunked" in rec["state"].get(name, {}):
            n += rec["state"][name]["chunked"]["launches"][kernel]
    for r in rec["train"].values():
        n += r["launches"][kernel]
    return n


def drift(torch, dev, name, layers):
    """``--drift``: how far the card and the CPU's plain path part over a
    bucketed prefill of ``name`` cut to ``layers`` layers, layer by layer
    (relative L2 of the hidden state over the prompt's rows) and in the
    last logits, under ``exact`` and with the fabric off; beside it the
    CPU against itself at 3 and 8 threads (summation order alone)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.fabric import FabricSpec
    from repro_torch.models.common import rmsnorm
    from repro_torch.models.model import (_embed_inputs, _head_weight,
                                          init_params)
    from repro_torch.models.transformer import apply_block, layer_kinds

    out = {}
    n = PROMPTS[0]
    toks = np.zeros((1, 16), np.int32)
    for fab in ("exact", None):
        cfg = dataclasses.replace(get_config(name), n_layers=layers,
                                  fabric=FabricSpec(mode=fab) if fab else None)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
        toks[0, :n] = np.random.default_rng(0).integers(0, cfg.vocab_size, n)
        runs = {}
        for where, p, d, threads in (("card", params, dev, None),
                                     ("cpu8", _to_cpu(params), "cpu", 8),
                                     ("cpu3", None, "cpu", 3)):
            p = p if p is not None else runs["cpu8"][2]
            if threads:
                torch.set_num_threads(threads)
            with torch.inference_mode():
                x = _embed_inputs(p, {"tokens": torch.from_numpy(toks).to(d)},
                                  cfg)
                xs = []
                for i, kind in enumerate(layer_kinds(cfg)):
                    x, _, _ = apply_block(p["blocks"]["layers"][i], x, kind,
                                          cfg, "prefill", true_len=n)
                    xs.append(x[0, :n].float().cpu())
                last = rmsnorm(p["final_norm"], x[:, n - 1:n])
                lg = (last @ _head_weight(p, cfg).to(last.dtype)).float()
            runs[where] = (xs, lg.cpu()[0, 0], p)
        for a, b in (("card", "cpu8"), ("cpu3", "cpu8")):
            (xa, la, _), (xb, lb, _) = runs[a], runs[b]
            row = {"hidden_rel_l2": [rel_l2(u, v) for u, v in zip(xa, xb)],
                   "logits_max_err": (la - lb).abs().max().item(),
                   "logits_scale": lb.abs().max().item()}
            out[f"{fab or 'off'} {a} vs {b}"] = row
            log(f"[drift] {name}, {layers} layers, fabric {fab or 'off'}, "
                f"{a} vs {b}: hidden state rel L2 by layer "
                f"{fmt_errs(row['hidden_rel_l2'])}; logits max err "
                f"{row['logits_max_err']:.4f} of {row['logits_scale']:.4f}")
        del params, runs
        free_device(torch)
    torch.set_num_threads(os.cpu_count() or 1)
    return out


def family_launches(fam, kernel):
    """A kernel's launches over phase 9's served and frontend runs."""
    n = 0
    for name in SERVED_FAMILIES:
        for path in ("exact", "sim_flash", "sim_noise"):
            if path in fam[name]:
                n += fam[name][path]["launches"][kernel]
        if "window" in fam[name]:
            n += fam[name]["window"]["launches"][kernel]
    for name in FRONTEND_FAMILIES:
        r = fam[name]
        for sfx in ("", "_off"):
            n += len(FRONTEND_LENGTHS) * r["launches_per_prefill" + sfx][
                kernel] + FRONTEND_STEPS * r["launches_per_decode_step"
                                             + sfx][kernel]
    for r in fam["train"].values():
        n += r["launches"][kernel]
    return n


# phase 3 at the families' geometries: (H, KV, hd) of gemma3 (rep 2, hd
# 256), llava (rep 4), dbrx (rep 6), deepseek (rep 7) and recurrentgemma
# (rep 16, hd 256: the context-split kernel; and rep 12); positions past
# windows of 1024, 2048 and 4096; the last slot's table is empty
FAMILY_PAGED_GEOMS = ((16, 8, 256), (32, 8, 128), (48, 8, 128), (56, 8, 128),
                      (16, 1, 256), (12, 1, 256))
FAMILY_PAGED_WINDOWS = (0, 1024, 2048, 4096)
FAMILY_PAGED_POS = [5, 1100, 4200, 0]
FAMILY_PAGED_MB = 264  # table blocks of 16: position 4200 needs 263
# phase 5 at the families' geometries: gemma3's hd 256 (the tensor-core
# kernel's two-warp instance), dbrx's rep 6, deepseek's rep 7 and
# recurrentgemma's rep 16 at hd 256; S 1100 under window 1024 (gemma3) and
# 2100 under 2048 (recurrentgemma)
FAMILY_FLASH_GEOMS = ((16, 8, 256), (48, 8, 128), (56, 8, 128), (16, 1, 256))
FAMILY_FLASH_LONG = ((1024, (16, 8, 256), 1100), (2048, (16, 1, 256), 2100))


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def phase_family_attn(torch, dev):
    """Phases 3 and 5 at phase 9's and phase 10's geometries: ``paged_attn``
    and ``flash_attn`` against their plain versions, the kernel each call
    must take asserted."""
    from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                    flash_attention_torch)
    from repro_torch.kernels.paged_attn.ops import (paged_attention,
                                                    paged_decode_torch,
                                                    takes_ctx_split,
                                                    takes_split)

    worst, n = {}, 0
    B = len(FAMILY_PAGED_POS)
    for H, KV, hd in FAMILY_PAGED_GEOMS:
        for dtype in ("f32", "bf16", "int8"):
            for window in FAMILY_PAGED_WINDOWS:
                q, k, v, tbl, p, kw = attn_inputs(
                    torch, dev, dtype, B, H, KV, hd, FAMILY_PAGED_POS,
                    mb=FAMILY_PAGED_MB, seed=200 + n, inactive_last=True)
                variant = paged_variant(dtype, H // KV, hd)
                rules = ("paged_attn_split" if takes_split(H // KV, k, v)
                         else "paged_attn_ctx" if takes_ctx_split(
                             H // KV, q, k, v, tbl.shape[1])
                         else "paged_attn_staged")
                if rules != variant:
                    raise AssertionError(f"paged_attn {dtype} rep={H // KV} "
                                         f"hd={hd}: the dispatch rules give "
                                         f"{rules}, expected {variant}")
                before = read_counts()
                out = paged_attention(q, k, v, tbl, p, window=window, **kw)
                torch.cuda.synchronize()
                check_attn_dispatch(before, paged_counts(variant),
                                    f"[3] paged_attn {dtype} rep={H // KV} "
                                    f"hd={hd}")
                ref = paged_decode_torch(q, k, v, tbl, p, window=window, **kw)
                if not bool(torch.isfinite(out).all()) or \
                        bool((out[B - 1] != 0).any()):
                    raise AssertionError("paged_attn output is not finite, "
                                         "or an empty table did not flush "
                                         "zeros")
                err = (out[:B - 1].float() - ref[:B - 1].float()).abs() \
                    .max().item()
                worst[f"paged {dtype}"] = max(worst.get(f"paged {dtype}", 0),
                                              err)
                # int8: one bf16 ulp at the output's largest magnitude
                # (the kernel keeps K, V and P in f32 where the plain
                # version rounds them to bf16; ``--int8-witness``)
                tol = ATTN_ATOL[dtype] if dtype != "int8" else max(
                    ATTN_ATOL[dtype], bf16_ulp(ref[:B - 1].float().abs()
                                               .max().item()))
                if dtype == "int8" and variant == "paged_attn_ctx":
                    exact = paged_decode_f64(q, k, v, tbl, p, kw["k_scale"],
                                             kw["v_scale"], window)[:B - 1]
                    _, e_k, e_p = int8_gate(
                        out[:B - 1], ref[:B - 1], exact, tol,
                        f"[3] paged_attn int8 window={window} "
                        f"rep={H // KV} hd={hd}")
                    if e_k is not None:
                        log(f"[3] paged_attn int8 window={window} rep="
                            f"{H // KV} hd={hd}: {err} from the plain "
                            f"version; from the float64 witness {e_k} "
                            f"(plain {e_p})")
                elif err > tol:
                    raise AssertionError(
                        f"paged_attn {dtype} window={window} rep={H // KV} "
                        f"hd={hd}: max err {err} > {tol}")
                n += 1
    g = torch.Generator(device=dev).manual_seed(14)
    cases = [(dtype, window, geom, S) for dtype in ("f32", "bf16")
             for window in (0, 16) for geom in FAMILY_FLASH_GEOMS
             for S in (1, 17, 64, 100)]
    cases += [(dtype, window, geom, S) for window, geom, S in FAMILY_FLASH_LONG
              for dtype in ("f32", "bf16")]
    for dtype, window, (H, KV, hd), S in cases:
        dt = torch.float32 if dtype == "f32" else torch.bfloat16
        q, k, v = (torch.randn((1, S, h, hd), generator=g, device=dev).to(dt)
                   for h in (H, KV, KV))
        before = read_counts()
        out = flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        check_attn_dispatch(before, {"flash_attn": 1,
                                     flash_variant(dtype, hd): 1},
                            f"[5] flash_attn {dtype} hd={hd}")
        ref = flash_attention_torch(q, k, v, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        worst[f"flash {dtype}"] = max(worst.get(f"flash {dtype}", 0), err)
        if not bool(torch.isfinite(out).all()) or err > FLASH_ATOL[dtype]:
            raise AssertionError(f"flash_attn {dtype} window={window} "
                                 f"rep={H // KV} hd={hd} S={S}: max err "
                                 f"{err} > {FLASH_ATOL[dtype]}")
        n += 1
    log(f"[3, 5] paged_attn and flash_attn at the families' geometries "
        f"(rep 2/4/6/7/12/16, hd 128/256, windows 1024/2048/4096) within "
        f"bounds "
        f"on {n} cases; worst {worst}")
    return worst


def time_family_rows(torch, dev):
    """Phase 7's rows at phase 9's geometries: ``flash_attn`` over one
    bucket-64 prefill of gemma3's six layers (hd 256, the tensor-core
    kernel), ``paged_attn`` over one of its decode steps, and ``imc_mac``
    over one qwen2-72b decode layer; each beside its bound, plain version
    and library call."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                    flash_attention_torch)
    from repro_torch.kernels.imc_mac.ops import imc_mac, imc_mac_torch
    from repro_torch.kernels.paged_attn.ops import (paged_attention,
                                                    paged_decode_torch)

    rows = {}
    g = torch.Generator(device=dev).manual_seed(16)
    S, H, KV, hd, layers = 64, 16, 8, 256, 6
    ins = [tuple(torch.randn((1, S, h, hd), generator=g, device=dev).to(
        torch.bfloat16) for h in (H, KV, KV)) for _ in range(layers)]
    lib_ins = [tuple(t.transpose(1, 2).contiguous() for t in x) for x in ins]

    def flash():
        return [flash_attention(q, k, v) for q, k, v in ins]

    def sdpa():
        return [F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True)
                for q, k, v in lib_ins]

    visible = S * (S + 1) // 2
    b_ms, by = bound(layers * 2 * S * (H + KV) * hd * 2,
                     layers * H * visible * hd * 4, BF16_FLOPS_PER_S)
    rows["flash_attn"] = dict(
        ms=cuda_ms(torch, flash, iters=30), graph_ms=graph_ms(torch, flash),
        plain_ms=cuda_ms(torch, lambda: [flash_attention_torch(q, k, v)
                                         for q, k, v in ins], iters=10),
        library_ms=cuda_ms(torch, sdpa, iters=30),
        library_graph_ms=graph_ms(torch, sdpa), bound_ms=b_ms, bound_by=by,
        shape="gemma3-12b, one bucket-64 prefill: 6 layers x (B=1, S=64, "
              "H=16, KV=8, hd=256, bf16, causal; the tensor-core kernel, two "
              "warps a 16-row group); "
              "library: F.scaled_dot_product_attention(is_causal=True, "
              "enable_gqa=True)")

    B, bs, mb = 4, 16, 8
    pos = [22, 31, 48, 27]
    pins = [attn_inputs(torch, dev, "bf16", B, H, KV, hd, pos, bs=bs, mb=mb,
                        seed=300 + i) for i in range(layers)]
    dense = []
    for q, k, v, tbl, p, _ in pins:
        nb = k.shape[0]
        ctx = torch.arange(mb * bs, device=dev)
        t = torch.where(tbl < 0, 0, tbl).long()
        gidx = t[:, ctx // bs] * bs + ctx % bs
        valid = (ctx[None] <= p.long()[:, None]) & (tbl[:, ctx // bs] >= 0)
        kd = k.reshape(nb * bs, KV, hd)[gidx].permute(0, 2, 1, 3)
        vd = v.reshape(nb * bs, KV, hd)[gidx].permute(0, 2, 1, 3)
        dense.append((q.permute(0, 2, 1, 3).contiguous(), kd.contiguous(),
                      vd.contiguous(), valid[:, None, None, :]))

    def paged():
        return [paged_attention(q, k, v, t, p) for q, k, v, t, p, _ in pins]

    def sdpa_dense():
        return [F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                               enable_gqa=True)
                for q, k, v, m in dense]

    live = sum(p_ + 1 for p_ in pos)
    b_ms, by = bound(layers * (live * KV * hd * 2 * 2 + 2 * B * H * hd * 2
                               + 4 * (B * mb + B)),
                     layers * live * H * hd * 4, BF16_FLOPS_PER_S)
    rows["paged_attn"] = dict(
        ms=cuda_ms(torch, paged, iters=30), graph_ms=graph_ms(torch, paged),
        plain_ms=cuda_ms(torch, lambda: [paged_decode_torch(q, k, v, t, p)
                                         for q, k, v, t, p, _ in pins],
                         iters=10),
        library_ms=cuda_ms(torch, sdpa_dense, iters=30),
        library_graph_ms=graph_ms(torch, sdpa_dense), bound_ms=b_ms,
        bound_by=by,
        shape="gemma3-12b, one decode step: 6 layers x (B=4, H=16, KV=8, "
              "hd=256, bf16 pools, block 16, positions 22/31/48/27; the "
              "split kernel); library: F.scaled_dot_product_attention over "
              "the gathered span (enable_gqa)")

    m, d, f = 4, 8192, 29568
    shapes = [(d, d), (d, 1024), (d, 1024), (d, d), (d, f), (d, f), (f, d)]
    a = {k: torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8) for k in (d, f)}
    a_pad = {k: torch.cat([v, v.new_zeros((32 - m, k))]) for k, v in a.items()}
    ws = [torch.randint(-127, 128, s, generator=g, device=dev,
                        dtype=torch.int8) for s in shapes]

    def layer(fn, act):
        return [fn(act[w.shape[0]], w) for w in ws]

    b_ms, by = bound(sum(m * k + k * n + 4 * m * n for k, n in shapes),
                     sum(2 * m * k * n for k, n in shapes), INT8_OPS_PER_S)
    rows["imc_mac"] = dict(
        ms=cuda_ms(torch, lambda: layer(imc_mac, a), iters=20),
        graph_ms=graph_ms(torch, lambda: layer(imc_mac, a)),
        plain_ms=cuda_ms(torch, lambda: layer(imc_mac_torch, a), iters=3),
        library_ms=cuda_ms(torch, lambda: layer(torch._int_mm, a_pad),
                           iters=20),
        library_graph_ms=graph_ms(torch, lambda: layer(torch._int_mm, a_pad)),
        bound_ms=b_ms, bound_by=by,
        shape="qwen2-72b, one decode layer: {2x (8192,8192), 2x (8192,1024),"
              " 2x (8192,29568), (29568,8192)} at M=4 (the split-K kernel, "
              "878 MB of weights); library: torch._int_mm with M padded to "
              "32")
    del ins, lib_ins, pins, dense, ws
    free_device(torch)
    for name, r in rows.items():
        log(f"[7] {name}, {r['shape']}: {r['ms']:.4f} ms, {r['graph_ms']:.4f}"
            f" ms from a graph (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; plain {r['plain_ms']:.4f} ms; library "
            f"{r['library_ms']:.4f} ms, {r['library_graph_ms']:.4f} ms from "
            "a graph)")
    return rows


def time_recurrent_rows(torch, dev):
    """Phase 7's rows at phase 10's geometries: ``paged_attn`` over one
    recurrentgemma decode step at its full depth (12 local layers, rep 16,
    hd 256: the context-split kernel and its merge), long contexts under
    its window of 2048, and
    ``imc_mac`` over one mamba2 decode step (96 projections at M = 4);
    each beside its bound, plain version and library call."""
    import torch.nn.functional as F

    from repro_torch.kernels.imc_mac.ops import imc_mac, imc_mac_torch
    from repro_torch.kernels.paged_attn.ops import (paged_attention,
                                                    paged_decode_torch)

    rows = {}
    g = torch.Generator(device=dev).manual_seed(17)
    H, KV, hd, layers, window = 16, 1, 256, 12, 2048
    B, bs, mb = 4, 16, 132
    pos = [2047, 1500, 700, 100]
    pins = [attn_inputs(torch, dev, "bf16", B, H, KV, hd, pos, bs=bs, mb=mb,
                        seed=400 + i) for i in range(layers)]
    dense = []
    for q, k, v, tbl, p, _ in pins:
        nb = k.shape[0]
        ctx = torch.arange(mb * bs, device=dev)
        t = torch.where(tbl < 0, 0, tbl).long()
        gidx = t[:, ctx // bs] * bs + ctx % bs
        valid = ((ctx[None] <= p.long()[:, None])
                 & (ctx[None] > p.long()[:, None] - window)
                 & (tbl[:, ctx // bs] >= 0))
        kd = k.reshape(nb * bs, KV, hd)[gidx].permute(0, 2, 1, 3)
        vd = v.reshape(nb * bs, KV, hd)[gidx].permute(0, 2, 1, 3)
        dense.append((q.permute(0, 2, 1, 3).contiguous(), kd.contiguous(),
                      vd.contiguous(), valid[:, None, None, :]))

    def paged():
        return [paged_attention(q, k, v, t, p, window=window)
                for q, k, v, t, p, _ in pins]

    def sdpa_dense():
        return [F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                               enable_gqa=True)
                for q, k, v, m in dense]

    live = sum(min(p_ + 1, window) for p_ in pos)
    b_ms, by = bound(layers * (live * KV * hd * 2 * 2 + 2 * B * H * hd * 2
                               + 4 * (B * mb + B)),
                     layers * live * H * hd * 4, BF16_FLOPS_PER_S)
    rows["paged_attn"] = dict(
        ms=cuda_ms(torch, paged, iters=20), graph_ms=graph_ms(torch, paged),
        plain_ms=cuda_ms(torch, lambda: [
            paged_decode_torch(q, k, v, t, p, window=window)
            for q, k, v, t, p, _ in pins], iters=5),
        library_ms=cuda_ms(torch, sdpa_dense, iters=20),
        library_graph_ms=graph_ms(torch, sdpa_dense), bound_ms=b_ms,
        bound_by=by,
        shape="recurrentgemma-9b, one decode step at full depth: 12 local "
              "layers x (B=4, H=16, KV=1, hd=256, bf16 pools, block 16, "
              "window 2048, positions 2047/1500/700/100; the context-split "
              "kernel and its merge, 24 launches); library: "
              "F.scaled_dot_product_attention over the gathered span "
              "(enable_gqa)")

    m, d, d_in, n_in, depth = 4, 1024, 2048, 4384, 48
    shapes = [(d, n_in), (d_in, d)] * depth
    a = {k: torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8) for k in (d, d_in)}
    a_pad = {k: torch.cat([v, v.new_zeros((32 - m, k))]) for k, v in a.items()}
    ws = [torch.randint(-127, 128, s, generator=g, device=dev,
                        dtype=torch.int8) for s in shapes]

    def step(fn, act):
        return [fn(act[w.shape[0]], w) for w in ws]

    b_ms, by = bound(sum(m * k + k * n + 4 * m * n for k, n in shapes),
                     sum(2 * m * k * n for k, n in shapes), INT8_OPS_PER_S)
    rows["imc_mac"] = dict(
        ms=cuda_ms(torch, lambda: step(imc_mac, a), iters=20),
        graph_ms=graph_ms(torch, lambda: step(imc_mac, a)),
        plain_ms=cuda_ms(torch, lambda: step(imc_mac_torch, a), iters=3),
        library_ms=cuda_ms(torch, lambda: step(torch._int_mm, a_pad),
                           iters=20),
        library_graph_ms=graph_ms(torch, lambda: step(torch._int_mm, a_pad)),
        bound_ms=b_ms, bound_by=by,
        shape="mamba2-370m, one decode step: 48 x {in_proj (1024,4384), "
              "out_proj (2048,1024)} at M=4 (the split-K kernel, 96 "
              "launches, 316 MB of weights); library: torch._int_mm with M "
              "padded to 32")
    del pins, dense, ws
    free_device(torch)
    for name, r in rows.items():
        log(f"[7] {name}, {r['shape']}: {r['ms']:.4f} ms, {r['graph_ms']:.4f}"
            f" ms from a graph (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; plain {r['plain_ms']:.4f} ms; library "
            f"{r['library_ms']:.4f} ms, {r['library_graph_ms']:.4f} ms from "
            "a graph)")
    return rows


# --attn-variants: text patches of the two tensor-core attention sources,
# each its own library: flash_attn's hd-256 instance at 4, 2 (the source's)
# and 1 sixteen-row groups a block; the paged merge's sum unrolled 16 (the
# source's) and 4 times
ATTN_VARIANTS = {
    "flash_attn": {f"rg{rg}": [("case 256: return launch<256, 2, 2>(",
                                f"case 256: return launch<256, 2, {rg}>(")]
                   for rg in (4, 2, 1)},
    "paged_attn": {f"unroll{u}": [("#pragma unroll 16",
                                   f"#pragma unroll {u}")] for u in (16, 4)},
}


def attn_variants(torch, dev):
    """``--attn-variants``: where the two new attention kernels' time goes.
    (a) Each variant of ``ATTN_VARIANTS`` built by nvcc into the build
    directory, called through ctypes, its output bit for bit the first
    variant's, and timed from a graph in turns (in order, reversed, in
    order): flash at gemma3's bucket-64 prefill (6 layers, S 64, H 16, KV
    8), recurrentgemma's (1 layer, KV 1) and S 1024 / 2048 under windows of
    1024 / 2048; paged at phase 7's recurrentgemma full-depth step.  (b)
    The device time of each kernel of phase 7's two rows and of their SDPA
    calls, from ``torch.profiler`` over 20 replays of each one's graph.
    Returns {"turns": {case: {variant: [ms, ...]}}, "kernels": {row:
    {"graph_ms", "kernels": {name: [launches a replay, µs each]}}}}."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn.ops import (_ARGTYPES as F_ARGS,
                                                    flash_attention)
    from repro_torch.kernels.paged_attn.ops import (_ARGTYPES as P_ARGS,
                                                    CTX_ROWS, ctx_chunks,
                                                    paged_attention)

    fns = {}
    for kernel, variants in ATTN_VARIANTS.items():
        entry = ("flash_attn_tc_launch" if kernel == "flash_attn"
                 else "paged_attn_ctx_launch")
        fns[kernel], _ = build_variants(
            "attn_variants", kernel, variants, entry,
            (F_ARGS if kernel == "flash_attn" else P_ARGS)[entry])

    g = torch.Generator(device=dev).manual_seed(18)
    hd = 256

    def flash_case(layers, S, H, KV, window):
        ins = [tuple(torch.randn((1, S, h, hd), generator=g, device=dev).to(
            torch.bfloat16) for h in (H, KV, KV)) for _ in range(layers)]
        outs = [torch.empty_like(q) for q, _, _ in ins]

        def run(fn):
            for (q, k, v), o in zip(ins, outs):
                stream, idx = build.stream_and_device(q)
                build.check_launch("attn_variants", fn(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    1, S, H, KV, hd, hd ** -0.5, window, stream, idx))
            return outs
        return run

    H, KV, B, bs, mb, window = 16, 1, 4, 16, 132, 2048
    pos = [2047, 1500, 700, 100]
    pins = [attn_inputs(torch, dev, "bf16", B, H, KV, hd, pos, bs=bs, mb=mb,
                        seed=400 + i) for i in range(12)]
    c = ctx_chunks(mb, bs)
    part_acc = torch.empty((B * KV, c, CTX_ROWS, hd), device=dev)
    part_ml = torch.empty((B * KV, c, 2, CTX_ROWS), device=dev)
    pouts = [torch.empty((B, KV, H // KV, hd), dtype=torch.bfloat16,
                         device=dev) for _ in pins]

    def paged_run(fn):
        for (q, k, v, t, p, _), o in zip(pins, pouts):
            stream, idx = build.stream_and_device(q)
            build.check_launch("attn_variants", fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
                t.data_ptr(), p.data_ptr(), o.data_ptr(), part_acc.data_ptr(),
                part_ml.data_ptr(), B, KV, H // KV, hd, bs, mb, c,
                hd ** -0.5, window, 1, 1, stream, idx))
        return pouts

    cases = {
        "flash gemma3 bucket-64 prefill, 6 layers": (
            "flash_attn", flash_case(6, 64, 16, 8, 0)),
        "flash recurrentgemma bucket-64 prefill, 1 layer": (
            "flash_attn", flash_case(1, 64, 16, 1, 0)),
        "flash gemma3 S 1024, window 1024": (
            "flash_attn", flash_case(1, 1024, 16, 8, 1024)),
        "flash recurrentgemma S 2048, window 2048": (
            "flash_attn", flash_case(1, 2048, 16, 1, 2048)),
        "paged recurrentgemma full-depth step, 12 layers": (
            "paged_attn", paged_run),
    }
    turns = {}
    for case, (kernel, run) in cases.items():
        names = list(fns[kernel])
        first = None
        for name in names:
            got = [o.clone() for o in run(fns[kernel][name])]
            torch.cuda.synchronize()
            first = first or got
            if not all(torch.equal(a, b) for a, b in zip(got, first)):
                raise AssertionError(f"attn_variants {case}: {name}'s "
                                     "output differs from the first's")
        turns[case] = {name: [] for name in names}
        for name in names + names[::-1] + names:
            turns[case][name].append(graph_ms(
                torch, lambda: run(fns[kernel][name]), iters=50))
        log(f"[attn variants] {case}: " + "; ".join(
            f"{n} " + "/".join(f"{t:.4f}" for t in ts)
            for n, ts in turns[case].items()) + " ms from a graph")

    dense = []
    for q, k, v, tbl, p, _ in pins:
        ctx = torch.arange(mb * bs, device=dev)
        gidx = torch.where(tbl < 0, 0, tbl).long()[:, ctx // bs] * bs + \
            ctx % bs
        valid = ((ctx[None] <= p.long()[:, None])
                 & (ctx[None] > p.long()[:, None] - window)
                 & (tbl[:, ctx // bs] >= 0))
        kd = k.reshape(-1, KV, hd)[gidx].permute(0, 2, 1, 3).contiguous()
        vd = v.reshape(-1, KV, hd)[gidx].permute(0, 2, 1, 3).contiguous()
        dense.append((q.permute(0, 2, 1, 3).contiguous(), kd, vd,
                      valid[:, None, None, :]))
    fins = [tuple(torch.randn((1, 64, h, hd), generator=g, device=dev).to(
        torch.bfloat16) for h in (16, 8, 8)) for _ in range(6)]
    lins = [tuple(t.transpose(1, 2).contiguous() for t in x) for x in fins]
    rows = {
        "paged_attn, recurrentgemma full-depth step": lambda: [
            paged_attention(q, k, v, t, p, window=window)
            for q, k, v, t, p, _ in pins],
        "SDPA over the gathered span, 12 layers": lambda: [
            F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                           enable_gqa=True)
            for q, k, v, m in dense],
        "flash_attn, gemma3 bucket-64 prefill": lambda: [
            flash_attention(q, k, v) for q, k, v in fins],
        "SDPA is_causal, 6 layers": lambda: [
            F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           enable_gqa=True)
            for q, k, v in lins],
    }
    kernels = {}
    for row, fn in rows.items():
        fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        replays = 20
        ms = cuda_ms(torch, graph.replay, 50)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(replays):
                graph.replay()
            torch.cuda.synchronize()
        times = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.count:
                times[e.key[:100]] = [e.count / replays,
                                      e.device_time_total / e.count]
        kernels[row] = dict(graph_ms=ms, kernels=times)
        log(f"[attn variants] {row}: {ms:.4f} ms from a graph; " + "; ".join(
            f"{n[:60]} x{k:g} {us:.2f} us" for n, (k, us) in times.items()))
    del pins, dense, fins, lins
    free_device(torch)
    return dict(turns=turns, kernels=kernels)


# --bitplane-variants: text patches of csrc/bitplane_mac.cu, each its own
# library: the served case's kernel rule (the r8 kernel at every M, the
# rule before the tensor-core kernel; the tensor-core kernel at every M),
# the tensor-core plan's target, and three variants whose results are
# wrong on purpose (the mma, the prmt decode, dp4a in place of an add),
# each taking one step out of the tensor-core kernel's loop
_ADD3 = ("__device__ __forceinline__ uint32_t add3(uint32_t x, uint32_t, "
         "uint32_t s) { return x + s; }\n")
BITPLANE_VARIANTS = {
    "source": [],
    "r8_all": [("R8_MAX_M = 8;", "R8_MAX_M = 1 << 30;")],
    "mma_all": [("R8_MAX_M = 8;", "R8_MAX_M = 0;")],
    "target264": [("MM_TARGET = 528;", "MM_TARGET = 264;",
                   "bitplane_mma.cuh")],
    "target792": [("MM_TARGET = 528;", "MM_TARGET = 792;",
                   "bitplane_mma.cuh")],
    "no_mma": [("mma_u8_k32(d, ap[mi], bq[q][ni][0], bq[q][ni][1], pad);",
                "d[0] = ap[mi][0] ^ bq[q][ni][0]; d[1] = ap[mi][1] ^ "
                "bq[q][ni][1]; d[2] = ap[mi][2] ^ pad; d[3] = ap[mi][3] ^ "
                "d[0];")],
    "no_prmt": [("prmt(dec_lo, dec_hi, d[x]), 0x01010101u << q",
                 "d[x], 0x01010101u << q")],
    "add_for_dp4a": [
        ("__global__ void __launch_bounds__(MM_THREADS, 3)",
         _ADD3 + "__global__ void __launch_bounds__(MM_THREADS, 3)"),
        ("part[mi][ni][x] = static_cast<int>(__dp4a(",
         "part[mi][ni][x] = static_cast<int>(add3(")],
}
BITPLANE_WRONG = ("no_mma", "no_prmt", "add_for_dp4a")


def bitplane_variants(torch, dev):
    """``--bitplane-variants``: which ``bitplane_mac`` kernel each M should
    take, and where the tensor-core kernel's time goes.  Each variant of
    ``BITPLANE_VARIANTS`` is built by nvcc into the build directory and
    called through ctypes on one step's 72 projections (12 layers x {4x
    (768,768), (768,3072), (3072,768)}, 8x8 bits, rows 8, calibrated
    table) at each M, from a graph, in turns (in order, reversed, in
    order).  The exact variants' outputs equal the source's bit for bit on
    one projection under the detuned table.  Returns {M: {variant: [ms,
    ...]}} and each variant's ptxas register line."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.bitplane_mac.ops import (_ARGTYPES,
                                                      physics_thresholds)

    fns, logs = build_variants("bitplane_variants", "bitplane_mac",
                               BITPLANE_VARIANTS, "bitplane_mac_launch",
                               _ARGTYPES)
    regs = ptxas_lines(logs, "bitplane_mac_mma_kernel")

    g = torch.Generator(device=dev).manual_seed(30)
    good = physics_thresholds(8, dev)
    detuned = torch.cat([torch.tensor([1.9], device=dev), good[:-1]])
    shapes = [(768, 768)] * 4 + [(768, 3072), (3072, 768)]
    ws = [[torch.randint(0, 256, sh, generator=g, device=dev,
                         dtype=torch.uint8) for sh in shapes]
          for _ in range(12)]
    def call(fn, a, w, thr):  # on the current stream: a capture's
        out = torch.empty((a.shape[0], w.shape[1]), dtype=torch.int32,
                          device=dev)
        stream, device = build.stream_and_device(out)
        build.check_launch("bitplane_variants", fn(
            a.data_ptr(), w.data_ptr(), thr.data_ptr(), out.data_ptr(),
            a.shape[0], w.shape[1], a.shape[1], 8, 8, 8, 264, stream, device,
            ctypes.byref(ctypes.c_int())))
        return out

    exact = [n for n in BITPLANE_VARIANTS if n not in BITPLANE_WRONG]
    turns = {}
    for m in (4, 8, 9, 16, 17, 32, 64, 512):
        act = {k: torch.randint(0, 256, (m, k), generator=g, device=dev,
                                dtype=torch.uint8) for k in (768, 3072)}
        want = call(fns["source"], act[768], ws[0][4], detuned)
        for name in exact:
            if not torch.equal(call(fns[name], act[768], ws[0][4], detuned),
                               want):
                raise AssertionError(f"bitplane_variants {name} at M = {m}"
                                     " differs from the source")
        names = (["source", "r8_all", "mma_all"] +
                 (["target264", "target792"] if m >= 17 else []) +
                 (list(BITPLANE_WRONG) if m in (64, 512) else []))
        row = turns[m] = {}
        for order in (names, names[::-1], names):
            for name in order:
                row.setdefault(name, []).append(graph_ms(
                    torch, lambda fn=fns[name]: [
                        call(fn, act[w.shape[0]], w, good)
                        for lw in ws for w in lw],
                    iters=3 if m == 512 else 10))
        log(f"[bitplane variants] M = {m}: " + "; ".join(
            f"{n} {' '.join(f'{x:.4f}' for x in v)}" for n, v in row.items()))
    return {"turns": turns, "registers": regs}


# --noisy-variants: text patches of csrc/bitplane_mac_noisy.cu, each its own
# library: the kernel rule (the 8-row-tile kernel at every M, the rule
# before the tensor-core kernel; the tensor-core kernel from M = 1), the
# designs the source was measured against (the drain inlined at its eight call sites,
# the queue offsets by a warp scan, the appends by a loop over the need
# word's set bits, Philox's products by __umulhi and a multiply, the plan
# aiming at 528 or 792 blocks, two blocks an SM), and, results wrong on
# purpose, each one more piece taken out: Philox (the counter for its
# words), tier 3 (the drain returns), the queue (appends not counted, so
# nothing is drained), the appends, the offsets
_SCAN = (
    "__device__ __forceinline__ int append_scan(int n, int lane, int count, "
    "int* added) { int scan = n; for (int d = 1; d < 32; d <<= 1) { const "
    "int y = __shfl_up_sync(FULL, scan, d); if (lane >= d) scan += y; } "
    "*added = __shfl_sync(FULL, scan, 31); return count + scan - n; }\n")
_BIT_LOOP = (
    "__device__ __forceinline__ void append_loop(uint32_t* queue, int at, "
    "uint32_t need, const uint32_t (&d)[4], uint32_t base) { const uint32_t "
    "w01 = prmt(d[0], d[1], 0x5410u); const uint32_t w23 = prmt(d[2], d[3], "
    "0x5410u); while (need) { const uint32_t i = 31u - static_cast<uint32_t>"
    "(__clz(need)); need ^= 1u << i; const uint32_t k = ((i & 2u ? w23 : w01)"
    " >> (((i & 1u) << 4) | ((i >> 1) & 0x1Cu))) & 15u; queue[at++] = base | "
    "(i & 2u) << (ER + 2) | (i & 1u) << EC | (i >> 3) << EG | k; } }\n")
_NO_QUEUE = ("count += added;", "(void)added;")  # nothing is drained
_KEEP = "if ((at ^ need) == 0x5A5A5A5Au) queue[0] = need;"  # no appends, kept
NOISY_VARIANTS = {
    "source": [],
    "tile_all": [("NOISY_MMA_MIN_M = 9;", "NOISY_MMA_MIN_M = 1 << 30;")],
    "mma_all": [("NOISY_MMA_MIN_M = 9;", "NOISY_MMA_MIN_M = 1;")],
    "inline_drain": [("__device__ __noinline__ void mma_drain(",
                      "__device__ __forceinline__ void mma_drain(")],
    "scan_offsets": [
        ("__global__ void __launch_bounds__(MM_THREADS, 3)",
         _SCAN + "__global__ void __launch_bounds__(MM_THREADS, 3)"),
        ("int at = append_offset(__popc(need), lane, count, &added);",
         "int at = append_scan(__popc(need), lane, count, &added);")],
    "bit_loop": [("__global__ void __launch_bounds__(MM_THREADS, 3)",
                  _BIT_LOOP + "__global__ void __launch_bounds__(MM_THREADS, 3)"),
                 ("append_slots(queue, at, need, d, base);",
                  "append_loop(queue, at, need, d, base);")],
    "philox_hi": [
        ("const uint64_t p0 = static_cast<uint64_t>(PHILOX_M0) * c.x;", ""),
        ("const uint64_t p1 = static_cast<uint64_t>(PHILOX_M1) * c.z;", ""),
        ("const uint32_t hi0 = static_cast<uint32_t>(p0 >> 32);",
         "const uint32_t hi0 = __umulhi(PHILOX_M0, c.x);"),
        ("const uint32_t lo0 = static_cast<uint32_t>(p0);",
         "const uint32_t lo0 = PHILOX_M0 * c.x;"),
        ("const uint32_t hi1 = static_cast<uint32_t>(p1 >> 32);",
         "const uint32_t hi1 = __umulhi(PHILOX_M1, c.z);"),
        ("const uint32_t lo1 = static_cast<uint32_t>(p1);",
         "const uint32_t lo1 = PHILOX_M1 * c.z;")],
    "target528": [("NOISY_MMA_TARGET = 1188;", "NOISY_MMA_TARGET = 528;")],
    "target792": [("NOISY_MMA_TARGET = 1188;", "NOISY_MMA_TARGET = 792;")],
    "bounds2": [("__global__ void __launch_bounds__(MM_THREADS, 3)",
                 "__global__ void __launch_bounds__(MM_THREADS, 2)")],
    # results wrong on purpose, each one more piece taken out
    "no_philox": [
        ("const uint4 y0 = philox4x32_10(mma_counter(e0, m0, n0, gc), rk);",
         "const uint4 y0 = mma_counter(e0, m0, n0, gc); (void)rk;"),
        ("const uint4 y1 = philox4x32_10(mma_counter(e1, m0, n0, gc), rk);",
         "const uint4 y1 = mma_counter(e1, m0, n0, gc);")],
    "no_tier3": [("const RoundKeys rk = keys_of(key0, key1);",
                  "return; const RoundKeys rk = keys_of(key0, key1);")],
    "no_queue": [_NO_QUEUE],
    "no_append": [_NO_QUEUE, ("append_slots(queue, at, need, d, base);",
                              _KEEP)],
    "no_offsets": [_NO_QUEUE,
                   ("append_slots(queue, at, need, d, base);", _KEEP),
                   ("int at = append_offset(__popc(need), lane, count, &added);",
                    "int at = count; added = 0;")],
}
NOISY_WRONG = ("no_philox", "no_tier3", "no_queue", "no_append",
               "no_offsets")
NOISY_VARIANT_M = (4, 8, 9, 16, 17, 24, 32, 33, 40, 41, 48, 64, 512)


def noisy_variants(torch, dev):
    """``--noisy-variants``: which ``bitplane_mac_noisy`` kernel each M
    should take (``NOISY_MMA_MIN_M``), and where the tensor-core kernel's
    time goes.  Each variant of ``NOISY_VARIANTS`` is built by nvcc and
    called through ctypes on one step's 72 projections (12 layers x {4x
    (768,768), (768,3072), (3072,768)}, 8x8 bits, rows 8, calibrated
    mismatch, uniform operands, a seed row) at each M, from a graph, in
    turns (in order, reversed, in order).  The exact variants' outputs
    equal the source's bit for bit on one projection under calibrated
    mismatch and under the stress sigmas with a detuned table.  Returns
    {"turns": {M: {variant: [ms, ...]}}, "registers": {variant: ptxas's
    line for the tensor-core kernel}}."""
    import ctypes

    from repro_torch.core.constants import MC_SIGMA_VK
    from repro_torch.kernels import build
    from repro_torch.kernels.bitplane_mac.ops import (_NOISY_ARGTYPES,
                                                      physics_thresholds)
    from repro_torch.kernels.common import seed_row

    fns, logs = build_variants("noisy_variants", "bitplane_mac_noisy",
                               NOISY_VARIANTS, "bitplane_mac_noisy_launch",
                               _NOISY_ARGTYPES)
    regs = ptxas_lines(logs, "bitplane_mac_noisy_mma_kernel")
    log(f"[noisy variants] ptxas: {json.dumps(regs)}")
    g = torch.Generator(device=dev).manual_seed(31)
    good = physics_thresholds(8, dev)
    detuned = torch.cat([torch.tensor([1.9], device=dev), good[:-1]])
    seed = seed_row(5, dev)
    shapes = [(768, 768)] * 4 + [(768, 3072), (3072, 768)]
    ws = [[torch.randint(0, 256, sh, generator=g, device=dev,
                         dtype=torch.uint8) for sh in shapes]
          for _ in range(12)]

    def call(fn, a, w, thr, ms, cs):  # on the current stream: a capture's
        out = torch.empty((a.shape[0], w.shape[1]), dtype=torch.int32,
                          device=dev)
        stream, device = build.stream_and_device(out)
        build.check_launch("noisy_variants", fn(
            a.data_ptr(), w.data_ptr(), thr.data_ptr(), out.data_ptr(),
            a.shape[0], w.shape[1], a.shape[1], 8, 8, 8, seed.data_ptr(), ms,
            cs, 480, stream, device, ctypes.byref(ctypes.c_int())))
        return out

    exact = [n for n in NOISY_VARIANTS if n not in NOISY_WRONG]
    turns = {}
    for m in NOISY_VARIANT_M:
        act = {k: torch.randint(0, 256, (m, k), generator=g, device=dev,
                                dtype=torch.uint8) for k in (768, 3072)}
        for thr, ms, cs in ((good, MC_SIGMA_VK, 0.0), (detuned, 0.3, 0.03)):
            want = call(fns["source"], act[768], ws[0][4], thr, ms, cs)
            for name in exact:
                if not torch.equal(call(fns[name], act[768], ws[0][4], thr,
                                        ms, cs), want):
                    raise AssertionError(f"noisy_variants {name} at M = {m}"
                                         " differs from the source")
        names = ["source", "tile_all", "mma_all"] + (
            [n for n in NOISY_VARIANTS if n not in
             ("source", "tile_all", "mma_all")] if m in (64, 512) else [])
        row = turns[m] = {}
        for order in (names, names[::-1], names):
            for name in order:
                row.setdefault(name, []).append(graph_ms(
                    torch, lambda fn=fns[name]: [
                        call(fn, act[w.shape[0]], w, good, MC_SIGMA_VK, 0.0)
                        for lw in ws for w in lw],
                    iters=2 if m == 512 else 5, warmup=1))
        log(f"[noisy variants] M = {m}: " + "; ".join(
            f"{n} {' '.join(f'{x:.4f}' for x in v)}" for n, v in row.items()))
    return {"turns": turns, "registers": regs}


# ---------------------------------------------------------- phase 11
FLEET_DEVICES = ("cuda:0", "cuda:0")  # two virtual hosts on the one card
FLEET_WAVES = 3  # 11a: warm-up takes n_hosts waves, the third must not build
FLEET_DELAY_S = 5.0  # 11b: host 1's observed skew from FLEET_SLOW_FROM on
FLEET_SLOW_FROM = 3


def fleet_serve(torch, dev, cfg, params, prompts, tag, must, never):
    """11a: phase 6's six prompts, ``FLEET_WAVES`` waves, through a
    ``FleetServer`` of two hosts on the card, under ``plain_calls``.  Every
    launch counter is zeroed just before and read just after; each host's
    polls (its prefills, admissions and decode steps) are also counted
    apart, and must equal its decode steps and bucketed prefills times the
    launches of one replayed step of each (``fleet_step_launches``).  Each
    host's streams must equal those of a single-host ``Server`` on the card
    fed that host's requests, wave by wave (a decode step quantizes its
    activations per tensor over its batch: under a fabric a stream depends
    on its batch mates, so the oracle serves each host's batches); with the
    fabric off, every wave's streams must also equal those of one Server
    fed all six requests.  Both hosts must serve; no host may build or
    capture after the warm-up waves; the merged registry counts every
    admission and TTFT."""
    from collections import Counter

    from repro_torch.fleet import FleetEngine, FleetServer, LocalCoordinator
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.serve import slo_summary
    from repro_torch.launch.server import Request, Server
    from repro_torch.telemetry import Registry

    never = tuple(never) + MACRO_KERNELS
    kw = dict(slots=4, kv="paged", block_size=16, buckets=(16, 32, 64))
    fleet = FleetEngine(LocalCoordinator(2, devices=FLEET_DEVICES),
                        noise_seed=0)
    fsrv = FleetServer(cfg, params, fleet, **kw)
    by_host = {h: dict.fromkeys(read_counts(), 0) for h in fsrv.servers}
    for h, srv in fsrv.servers.items():
        def counted(_h=h, _poll=srv.poll):
            before = read_counts()
            out = _poll()
            for k, v in read_counts().items():
                by_host[_h][k] += v - before[k]
            return out

        srv.poll = counted
    zero_counts()
    waves, walls = [], []
    with plain_calls() as plain:
        for wave in range(FLEET_WAVES):
            t0 = time.perf_counter()
            waves.append([fsrv.submit(Request(p, max_new_tokens=MAX_NEW))
                          for p in prompts])
            fsrv.drain()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if wave == fsrv.n_hosts - 1:
                warm = fleet.traces_by_host()
    launches = read_counts()
    if plain.n:
        raise AssertionError(f"{tag}: the fleet serve called plain "
                             f"versions {plain.n} times")
    if fleet.traces_by_host() != warm:
        raise AssertionError(f"{tag}: builds + captures by host went {warm} "
                             f"after the warm-up to "
                             f"{fleet.traces_by_host()}")
    if not all(h.done and len(h.tokens) == MAX_NEW for w in waves for h in w):
        raise AssertionError(f"{tag}: not every request finished")
    if {h.host for h in waves[0]} != set(fsrv.servers):
        raise AssertionError(f"{tag}: round-robin left a host idle")
    for h, counts in by_host.items():
        for name in must:
            if counts[name] <= 0:
                raise AssertionError(f"{tag}: host {h} launched {name} no "
                                     "time")
        for name in never:
            if counts[name]:
                raise AssertionError(f"{tag}: host {h} launched {name} "
                                     f"{counts[name]} times, it must not")
    if {k: sum(c[k] for c in by_host.values()) for k in launches} != \
            launches:
        raise AssertionError(f"{tag}: the hosts' launches {by_host} do not "
                             f"add up to the run's {launches}")
    # each host's launches, exactly: per decode step and per bucketed
    # prefill, one more of each for the warm-up run before its capture
    per_step, per_prefill = fleet_step_launches(fleet, fsrv, cfg, prompts)
    for h, srv in fsrv.servers.items():
        n_b = Counter(srv._bucket_for(len(x.request.prompt))
                      for w in waves for x in w if x.host == h)
        want = {k: (srv.decode_ticks + 1) * per_step[h][k]
                + sum((n + 1) * per_prefill[h][b][k] for b, n in n_b.items())
                for k in launches}
        if by_host[h] != want:
            raise AssertionError(
                f"{tag}: host {h} launched {by_host[h]} over "
                f"{srv.decode_ticks} decode steps and prefills {dict(n_b)}; "
                f"one replayed decode step launches {per_step[h]}, one "
                f"prefill by bucket {per_prefill[h]}: expected {want}")
    merged = fleet.merged_registry().snapshot()
    n = FLEET_WAVES * len(prompts)
    if merged["counters"]["server.admitted"] != n or \
            merged["histograms"]["server.ttft_s"]["count"] != n:
        raise AssertionError(f"{tag}: the merged registry counts "
                             f"{merged['counters']['server.admitted']} "
                             f"admissions, {merged['histograms']['server.ttft_s']['count']}"
                             f" TTFT samples; expected {n}")
    slos = fsrv.slos()

    # the oracle: per host, one Server on the card fed that host's requests
    oracle_s = {}
    for host in fsrv.servers:
        srv = Server(cfg, params, engine=Engine(dev, noise_seed=0,
                                                registry=Registry()), **kw)
        for w in waves:
            mine = [h for h in w if h.host == host]
            got = [srv.submit(Request(h.request.prompt,
                                      max_new_tokens=MAX_NEW)) for h in mine]
            srv.drain()
            if [g.tokens for g in got] != [h.tokens for h in mine]:
                raise AssertionError(f"{tag}: host {host}'s streams differ "
                                     "from a single-host Server's fed its "
                                     "requests")
        oracle_s[host] = slo_summary(srv)
    # beside it, one Server fed all six requests each wave: the single
    # host's decode rate in this run (its last wave, from its graphs) and,
    # with the fabric off, the whole fleet's oracle
    whole = cfg.imc_fabric is None
    single = Server(cfg, params, engine=Engine(dev, noise_seed=0,
                                               registry=Registry()), **kw)
    for w in waves:
        single.registry.reset()
        single.decode_s = 0.0
        got = [single.submit(Request(p, max_new_tokens=MAX_NEW))
               for p in prompts]
        single.drain()
        if whole and [g.tokens for g in got] != [h.tokens for h in w]:
            raise AssertionError(f"{tag}: a wave's streams differ from one "
                                 "Server's fed all six requests")
    single_s = slo_summary(single)
    decode_s = {h: srv.decode_s for h, srv in fsrv.servers.items()}
    toks = merged["counters"]["server.decode_tokens"]
    fleet_tok_s = toks / fsrv.total_decode_s()
    wave_tok_s = len(prompts) * MAX_NEW / walls[-1]
    log(f"[11a] {tag}: {n} requests over {fsrv.n_hosts} hosts on "
        f"{', '.join(FLEET_DEVICES)} in {FLEET_WAVES} waves ({' '.join(f'{w:.2f}' for w in walls)} s); "
        f"merged TTFT p50 {slos['ttft_ms']} ms, TPOT p50 {slos['tpot_ms']} "
        f"ms (n_hosts {slos['n_hosts']}); decode s by host "
        f"{ {h: round(s, 4) for h, s in decode_s.items()} }; fleet decode "
        f"{fleet_tok_s:.1f} tok/s (decode tokens over the hosts' summed "
        f"decode time), wave {FLEET_WAVES} {wave_tok_s:.1f} tok/s wall; one "
        f"Server fed all six: TPOT p50 {single_s['tpot_ms']['p50']:.2f} ms, "
        f"decode {single_s['decode_tokens_per_s']:.1f} tok/s; builds + "
        f"captures by host {fleet.traces_by_host()}; launches by host "
        f"{ {h: {k: v for k, v in c.items() if v} for h, c in by_host.items()} }"
        f", exactly the decode steps' and prefills' (a decode step "
        f"{ {k: v for k, v in per_step[0].items() if v} }); no plain version"
        "; each host's streams equal its single-host oracle's"
        + ("; every wave's equal one Server's fed all six" if whole else ""))
    return {"launches": launches, "by_host": by_host, "slos": slos,
            "decode_s": decode_s, "fleet_decode_tok_s": fleet_tok_s,
            "wave_tok_s": wave_tok_s, "wave_wall_s": walls,
            "single": single_s, "oracle": oracle_s,
            "per_decode_step": per_step[0],
            "traces_by_host": fleet.traces_by_host()}


def fleet_step_launches(fleet, fsrv, cfg, prompts):
    """Each host's launches of one decode step and of one prefill of each
    bucket its requests took, replayed from the host's own graphs after
    the serve (a replay adds its capture's launches to the counters);
    neither may build or capture."""
    import numpy as np

    traces = fleet.traces_by_host()
    per_step, per_prefill = {}, {}
    for h, srv in fsrv.servers.items():
        eng = fleet.engine(h)
        zero_counts()
        eng.decode_step(cfg)(
            (srv.params, srv.cache),
            {"token": np.zeros((srv.slots, 1), np.int32),
             "block_table": srv.alloc.table()}, eng.noise_seed(1 << 20))
        per_step[h] = read_counts()
        per_prefill[h] = {}
        for p in prompts:
            b = srv._bucket_for(len(p))
            if b in per_prefill[h] or b not in srv._prefills:
                continue
            padded = np.zeros((1, b), np.int32)
            padded[0, :len(p)] = p
            zero_counts()
            eng.prefill_step(cfg, 0, b)(
                (srv.params,), {"tokens": padded, "length": np.int32(len(p))},
                eng.noise_seed(0, 0))
            per_prefill[h][b] = read_counts()
    if fleet.traces_by_host() != traces:
        raise AssertionError(f"replaying a step built or captured: "
                             f"{traces} -> {fleet.traces_by_host()}")
    return per_step, per_prefill


def fleet_train(torch, dev):
    """11b: the straggler drill at phase 8a's shape (full imc-paper-110m,
    ``exact``, batch 4 x seq 512), 8 steps with ``ckpt_every=2`` through
    ``train_fleet`` over two hosts on the card; host 1's observed times
    carry ``FLEET_DELAY_S`` from step ``FLEET_SLOW_FROM`` on.  A single-host
    ``train`` of the same steps runs first (it also takes the process's
    one-time costs off the fleet's first steps).  Gates: host 1 removed, one
    shrink equal to ``shrink_after_failure(plan_for_fleet(...))``,
    ``fault.resumes`` up by one, one train step built on each host (none on
    resume), ``imc_mac`` launched 144 times a step run and nothing else, no
    plain version, and the final params and optimizer state equal the
    single host's bit for bit."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train, train_fleet
    from repro_torch.models.transformer import dense_calls
    from repro_torch.runtime.elastic import (plan_for_fleet,
                                             shrink_after_failure)
    from repro_torch.telemetry import get_registry
    from repro_torch.tree import tree_leaves

    cfg = get_config("imc-paper-110m")
    kw = dict(steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
              seq_len=TRAIN_SEQ, lr=1e-3, seed=0)
    t0 = time.perf_counter()
    whole, whole_hist = train(cfg, device=dev, **kw)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single_leaves = [x.cpu() for x in tree_leaves(whole)]  # off the card:
    del whole  # the fleet's peak memory is its own
    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    resumes0 = get_registry().snapshot()["counters"].get("fault.resumes", 0)
    try:
        free_device(torch)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        with plain_calls() as plain:
            state, hist, fleet, loop = train_fleet(
                cfg, n_hosts=2, ckpt_root=root, ckpt_every=2,
                devices=FLEET_DEVICES,
                delay=lambda h, s: FLEET_DELAY_S
                if (h == 1 and s >= FLEET_SLOW_FROM) else 0.0, **kw)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = read_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    resumes = get_registry().snapshot()["counters"]["fault.resumes"]
    steps = {h: fleet.engine(h).registry.snapshot()["histograms"][
        "fleet.step_s"] for h in fleet.engines}
    ran = sum(s["count"] for s in steps.values())
    per_step = 2 * dense_calls(cfg)  # remat: each forward twice
    want_plan = shrink_after_failure(
        plan_for_fleet(2, 1, model_parallel=1, base_batch=TRAIN_BATCH), 1,
        model_parallel=1)
    if fleet.removed != [1] or fleet.active_hosts() != [0]:
        raise AssertionError(f"[11b] removed {fleet.removed}, active "
                             f"{fleet.active_hosts()}; expected [1], [0]")
    if loop.shrinks != [want_plan]:
        raise AssertionError(f"[11b] shrinks {loop.shrinks}; expected "
                             f"[{want_plan}]")
    if resumes != resumes0 + 1:
        raise AssertionError(f"[11b] fault.resumes {resumes0} -> {resumes}")
    if fleet.traces_by_host() != {0: 1, 1: 1}:
        raise AssertionError(f"[11b] train steps built by host "
                             f"{fleet.traces_by_host()}; expected one each")
    for name, n in launches.items():
        want = per_step * ran if name in ("imc_mac", "imc_mac_tiled") else 0
        if n != want:
            raise AssertionError(f"[11b] {name} launched {n} times in {ran} "
                                 f"host steps, want {want}")
    if plain.n:
        raise AssertionError(f"[11b] {plain.n} calls of plain versions")
    if len(hist) <= TRAIN_STEPS or steps[0]["count"] != len(hist):
        raise AssertionError(f"[11b] the controller ran {len(hist)} steps "
                             f"({steps[0]['count']} timed); a resume "
                             f"replays past {TRAIN_STEPS}")
    if [m["loss"] for m in hist[-2:]] != \
            [m["loss"] for m in whole_hist[-2:]]:
        raise AssertionError("[11b] the fleet's last losses differ from the "
                             "single host's")
    leaves = tree_leaves(state)
    if len(leaves) != len(single_leaves) or not all(
            a.dtype == b.dtype and torch.equal(a.cpu(), b)
            for a, b in zip(leaves, single_leaves)):
        raise AssertionError("[11b] the fleet's final params and optimizer "
                             "state differ from the single host's")
    p50 = {h: 1e3 * s["p50"] for h, s in steps.items()}
    log(f"[11b] straggler drill: {TRAIN_STEPS} steps (batch {TRAIN_BATCH} "
        f"x seq {TRAIN_SEQ}) over 2 hosts on {', '.join(FLEET_DEVICES)} in "
        f"{wall:.2f} s (one host's train {single_s:.2f} s); host 1 removed "
        f"after {steps[1]['count']} steps, shrink {loop.shrinks[0]}, "
        f"fault.resumes +1, the controller ran {len(hist)} steps; step p50 "
        f"by host {', '.join(f'{h}: {v:.2f} ms' for h, v in p50.items())}"
        f"; peak device memory of the card (both hosts) "
        f"{peak / 2**30:.2f} GiB; {launches['imc_mac_tiled']} tensor-core "
        f"imc_mac launches ({per_step} a host step); final state equal to "
        "the single host's bit for bit")
    return {"launches": launches, "removed": fleet.removed,
            "host_steps": {h: s["count"] for h, s in steps.items()},
            "controller_steps": len(hist), "step_p50_ms": p50,
            "peak_gib": peak / 2**30, "wall_s": wall,
            "single_wall_s": single_s}


def fleet_distributed(torch):
    """11c: a one-process NCCL group (``file://`` rendezvous in a temporary
    directory) through ``DistributedCoordinator``: one tagged snapshot
    gathered and merged equal to the local merge, and a barrier."""
    import shutil
    import tempfile

    from repro_torch.fleet import DistributedCoordinator, merge_registries
    from repro_torch.telemetry import Registry

    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    t0 = time.perf_counter()
    try:
        coord = DistributedCoordinator(
            initialize=True, coordinator_address=f"file://{tmp}/rendezvous",
            num_processes=1, process_id=0)
        try:
            reg = Registry()
            for i in range(1, 101):
                reg.histogram("server.tpot_s").observe(i * 1e-4)
                reg.counter("server.admitted").inc()
            merged = merge_registries({0: reg}, coord).snapshot()
            coord.barrier("chip_smoke")
            host, count = coord.hosts()[0], coord.process_count
        finally:
            coord.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if merged != merge_registries({0: reg}).snapshot() or count != 1 or \
            host.device.type != "cuda":
        raise AssertionError(f"[11c] the NCCL gather merged {merged}, "
                             f"{count} processes, host on {host.device}")
    wall = time.perf_counter() - t0
    log(f"[11c] DistributedCoordinator: a one-process NCCL group on "
        f"{host.device} gathered and merged one tagged snapshot (equal to "
        f"the local merge) and passed a barrier in {wall:.2f} s")
    return {"wall_s": wall, "device": str(host.device)}


def fleet_cli():
    """11d: ``python -m repro_torch.serve_batched`` as a subprocess with a
    time limit, single-host and over two hosts on the card."""
    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]]
                                       if env.get("PYTHONPATH") else []))
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        trace = os.path.join(tmp, "trace.json")
        runs = {"single": ([], "serve_batched OK"),
                "fleet": (["--fleet-hosts", "2", "--fleet-devices",
                           ",".join(FLEET_DEVICES), "--telemetry", "--trace-out", trace],
                          "serve_batched OK (fleet)")}
        for name, (args, ok) in runs.items():
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m",
                                "repro_torch.serve_batched", *args],
                               cwd=ROOT, env=env, capture_output=True,
                               text=True, timeout=300)
            lines = r.stdout.splitlines()
            if r.returncode or not lines or lines[-1] != ok:
                raise AssertionError(
                    f"[11d] serve_batched {' '.join(args)} exited "
                    f"{r.returncode}:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
            out[name] = {"wall_s": time.perf_counter() - t0,
                         "summary": [ln for ln in lines
                                     if "tok/s" in ln or "SLOs" in ln]}
            log(f"[11d] python -m repro_torch.serve_batched {' '.join(args)}"
                f": exit 0 in {out[name]['wall_s']:.2f} s; "
                + " | ".join(out[name]["summary"]))
        with open(trace) as f:
            if not json.load(f)["traceEvents"]:
                raise AssertionError("[11d] the fleet's trace holds no span")
    return out


def phase_fleet(torch, dev):
    """Phase 11: the fleet (module docstring)."""
    import dataclasses

    from repro_torch.core.fabric import FabricSpec

    t0 = time.perf_counter()
    cfg, params, prompts = served_model(torch, dev)
    out = {"off": fleet_serve(
        torch, dev, dataclasses.replace(cfg, fabric=None, imc_mode="off"),
        params, prompts, "off", must=("paged_attn",),
        never=("imc_mac", "bitplane_mac", "flash_attn", "bitplane_mac_noisy",
               "paged_attn_staged"))}
    out["exact"] = fleet_serve(
        torch, dev, cfg, params, prompts, "exact",
        must=("imc_mac", "paged_attn"),
        never=("bitplane_mac", "flash_attn", "bitplane_mac_noisy",
               "paged_attn_staged"))
    sim_cfg = dataclasses.replace(cfg, fabric=FabricSpec(mode="sim"),
                                  use_flash_kernel=True)
    out["sim_flash"] = fleet_serve(
        torch, dev, sim_cfg, params, prompts, "sim+flash",
        must=("bitplane_mac", "flash_attn", "paged_attn"),
        never=("imc_mac", "bitplane_mac_noisy", "flash_attn_simt",
               "paged_attn_staged"))
    del params
    out["train"] = fleet_train(torch, dev)
    out["distributed"] = fleet_distributed(torch)
    out["cli"] = fleet_cli()
    out["wall_s"] = time.perf_counter() - t0
    log(f"[11] fleet: {out['wall_s']:.1f} s in all")
    return out


def fleet_launches(fl, kernel):
    """A kernel's launches over phase 11's fleet serves and drill."""
    return (fl["off"]["launches"][kernel]
            + fl["exact"]["launches"][kernel]
            + fl["sim_flash"]["launches"][kernel]
            + fl["train"]["launches"][kernel])


# ------------------------------------------------------------- phase 12
# 12d's store: a split-K plan for the decode step's 768 x 768 projections
# other than the default's (24 splits of 32 K-rows where the default makes
# 48 of 16)
AUTOTUNE_STORE = ("imc_mac", {"m": 4, "k": 768, "n": 768},
                  {"sk_gmax": 2, "sk_target": 132})
# 12a: bitplane_mac's phase-4 shapes, for the C plan against its twin
BITPLANE_PLAN_SHAPES = [(m, k, n, rows) for m in (1, 3, 4, 5, 9, 64)
                        for k in (8, 100, 1030, 3072)
                        for n in (1, 31, 129, 768) for rows in (8, 16)]


def autotune_operands(torch, dev, kernel, shapes):
    """(call(geometry), plain()) of ``kernel`` on operands of ``shapes``
    drawn from seed 12 (``bitplane_mac_noisy`` under calibrated mismatch
    and one seed-table row)."""
    from repro_torch.core.fabric import NoiseSpec
    from repro_torch.kernels.bitplane_mac import ops as bp
    from repro_torch.kernels.common import seed_row
    from repro_torch.kernels.imc_mac import ops as imc
    from repro_torch.kernels.rbl_decode import ops as rbl

    g = torch.Generator(device=dev).manual_seed(12)
    m, k, n = shapes["m"], shapes["k"], shapes["n"]

    def codes(lo, hi, *shape, dtype=torch.uint8):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    if kernel in ("imc_mac", "imc_mac_dequant"):
        qa = codes(-128, 128, m, k, dtype=torch.int8)
        qw = codes(-128, 128, k, n, dtype=torch.int8)
        if kernel == "imc_mac":
            return (lambda geom: imc.imc_mac(qa, qw, geometry=geom),
                    lambda: imc.imc_mac_torch(qa, qw))
        sa = torch.rand((1,), generator=g, device=dev) * 0.01
        sw = torch.rand((n,), generator=g, device=dev) * 0.099 + 0.001
        return (lambda geom: imc.imc_mac_dequant(qa, qw, sa, sw,
                                                 geometry=geom),
                lambda: imc.imc_mac_dequant_torch(qa, qw, sa, sw))
    if kernel == "rbl_decode_mac":
        a, w = codes(0, 2, m, k), codes(0, 2, k, n)
        rows = shapes["rows"]
        return (lambda geom: rbl.rbl_decode_mac(a, w, rows=rows,
                                                geometry=geom),
                lambda: rbl.rbl_decode_mac_torch(a, w, rows=rows))
    kw = dict(bits_a=shapes["ba"], bits_w=shapes["bw"], rows=shapes["rows"])
    ua, uw = codes(0, 1 << kw["bits_a"], m, k), codes(0, 1 << kw["bits_w"],
                                                     k, n)
    if kernel == "bitplane_mac":
        return (lambda geom: bp.bitplane_mac(ua, uw, geometry=geom, **kw),
                lambda: bp.bitplane_mac_torch(ua, uw, **kw))
    seed = seed_row(NOISE_SEED, dev)
    sigma = NoiseSpec.calibrated().mismatch_sigma
    return (lambda geom: bp.bitplane_mac_noisy(
        ua, uw, seed, mismatch_sigma=sigma, geometry=geom, **kw),
        lambda: bp.bitplane_mac_noisy_torch(ua, uw, seed, mismatch_sigma=sigma,
                                            **kw))


def autotune_candidates(torch, dev):
    """12a: every candidate of every tuned kernel: its C plan equal to the
    Python twin's at phase 2's, 4's and 4c's shapes and the standard cells;
    at each standard cell its output bit for bit the default geometry's and
    the plain version's.  Returns (plans checked, outputs checked per
    kernel)."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.bitplane_mac import ops as bp
    from repro_torch.kernels.imc_mac import ops as imc
    from repro_torch.kernels.rbl_decode import ops as rbl

    cells = autotune.STANDARD_CELLS
    plans = 0
    imc_shapes = {(m, k, n) for m, k, n, _, _ in SPLIT_CASES + MMA_CASES}
    imc_shapes |= {(s["m"], s["k"], s["n"]) for kn, s in cells
                   if kn.startswith("imc_mac")}
    for m, k, n in sorted(imc_shapes):
        for cand in autotune.candidates("imc_mac", {"m": m, "k": k, "n": n}):
            if imc.compiled_plan(m, n, k, cand) != \
                    imc.imc_mac_plan(m, n, k, cand):
                raise AssertionError(
                    f"imc_mac_plan{(m, n, k)} under {cand}: C "
                    f"{imc.compiled_plan(m, n, k, cand)} != Python "
                    f"{imc.imc_mac_plan(m, n, k, cand)}")
            plans += 1
    rbl_shapes = {(m, k, n, rows) for m, k, n, rows, _ in RBL_EDGE_CASES}
    rbl_shapes |= {(s["m"], s["k"], s["n"], s["rows"]) for kn, s in cells
                   if kn == "rbl_decode_mac"}
    for m, k, n, rows in sorted(rbl_shapes):
        for cand in autotune.SPACES["rbl_decode_mac"]:
            if rbl.compiled_plan(m, n, k, rows, cand) != \
                    rbl.rbl_decode_mac_plan(m, n, k, rows, cand):
                raise AssertionError(
                    f"rbl_decode_mac_plan{(m, n, k, rows)} under {cand}: C "
                    f"{rbl.compiled_plan(m, n, k, rows, cand)} != Python "
                    f"{rbl.rbl_decode_mac_plan(m, n, k, rows, cand)}")
            plans += 1
    bp_shapes = set(BITPLANE_PLAN_SHAPES) | {
        (s["m"], s["k"], s["n"], s["rows"]) for kn, s in cells
        if kn.startswith("bitplane")}
    for m, k, n, rows in sorted(bp_shapes):
        for kernel, granule in (("bitplane_mac", 8), ("bitplane_mac_noisy", 1)):
            for cand in autotune.SPACES[kernel]:
                args = (m, n, k, rows, cand["target"], granule)
                if bp.compiled_plan(*args) != bp.bitplane_plan(*args):
                    raise AssertionError(
                        f"bitplane_plan{args}: C {bp.compiled_plan(*args)} "
                        f"!= Python {bp.bitplane_plan(*args)}")
                plans += 1
    outputs = {}
    for kernel, shapes in cells:
        call, plain = autotune_operands(torch, dev, kernel, shapes)
        want = plain()
        default = call(None)
        if not torch.equal(default, want):
            raise AssertionError(f"[12a] {kernel} at {shapes}: the default "
                                 "geometry differs from the plain version")
        for cand in autotune.candidates(kernel, shapes):
            got = call(cand)
            if not (torch.equal(got, default) and torch.equal(got, want)):
                raise AssertionError(
                    f"[12a] {kernel} at {shapes} under {cand}: not bit for "
                    "bit the default geometry's and the plain version's")
            outputs[kernel] = outputs.get(kernel, 0) + 1
        torch.cuda.synchronize()
    log(f"[12a] {plans} C plans equal their Python twins under every "
        f"candidate; outputs bit for bit the default's and the plain "
        f"version's at {len(cells)} standard cells: {outputs}")
    return plans, outputs


def autotune_tuning(torch, dev, tmp):
    """12b: ``tune_standard(smoke=True)`` into a fresh cache: the cold run
    counts one trial per candidate of every cell, a warm second run none."""
    from repro_torch.kernels import autotune
    from repro_torch.telemetry import Registry

    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(tmp, "smoke.json")
    autotune.set_cache(None)
    reg = Registry()
    t0 = time.perf_counter()
    rows = autotune.tune_standard(smoke=True, registry=reg, device=dev)
    cold_s = time.perf_counter() - t0
    cold = reg.counter("autotune.trials").value
    want = sum(len(autotune.candidates(k, s))
               for k, s in autotune.STANDARD_CELLS)
    if cold != want or reg.histogram("autotune.trial_us").count != want:
        raise AssertionError(f"[12b] the cold run counted {cold} trials, "
                             f"expected {want} (the candidates of every cell)")
    for r in rows:
        log(f"[12b] {r['kernel']} {r['bucket']}: winner {r['geometry']} "
            f"{r['us']:.3f} us, default {r['default_us']:.3f} us "
            f"({r['trials']} trials)")
    warm = autotune.tune_standard(smoke=True, registry=reg, device=dev)
    if reg.counter("autotune.trials").value != cold or \
            any(r["trials"] for r in warm) or \
            [r["geometry"] for r in warm] != [r["geometry"] for r in rows]:
        raise AssertionError("[12b] the warm run ran trials or resolved "
                             "other winners")
    del os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]
    autotune.set_cache(None)
    log(f"[12b] tune_standard(smoke=True): {cold} trials cold in "
        f"{cold_s:.2f} s, 0 warm")
    return {"rows": rows, "trials_cold": cold, "trials_warm": 0,
            "cold_s": cold_s}


def autotune_committed(torch, dev):
    """12c: the committed ``tuned.json``: every entry of this card's
    backend names a geometry of ``SPACES``, and a lookup at every standard
    cell resolves from it without a trial."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.autotune import tuner
    from repro_torch.telemetry import get_registry

    cache = autotune.get_cache()
    if cache.path != tuner._COMMITTED:
        raise AssertionError(f"[12c] the process cache is {cache.path}")
    backend = autotune.backend_key(dev)
    ours = {k: e for k, e in cache.entries.items()
            if k.endswith("|" + backend)}
    for key, e in ours.items():
        kernel = key.split("|")[0]
        if e["geometry"] not in [{**autotune.DEFAULTS[kernel], **c}
                                 for c in autotune.SPACES[kernel]]:
            raise AssertionError(f"[12c] {key}: {e['geometry']} is no "
                                 "candidate of SPACES")
    trials = get_registry().counter("autotune.trials").value
    resolved = {}
    for kernel, shapes in autotune.STANDARD_CELLS:
        dtype = autotune.KERNEL_DTYPES[kernel]
        bucket = autotune.shape_bucket(shapes)
        hit = cache.lookup(kernel, bucket, dtype, backend)
        if hit is None:
            raise AssertionError(f"[12c] tuned.json has no {backend} entry "
                                 f"for {kernel} at {bucket}")
        got = autotune.lookup(kernel, shapes, dtype=dtype, device=dev)
        if got != hit:
            raise AssertionError(f"[12c] {kernel} at {bucket} resolves "
                                 f"{got}, its entry is {hit}")
        resolved[f"{kernel}|{bucket}"] = got
    if get_registry().counter("autotune.trials").value != trials:
        raise AssertionError("[12c] a lookup ran a trial")
    log(f"[12c] tuned.json ({cache.measured_on}): {len(ours)} {backend} "
        f"entries, each a candidate of SPACES; every standard cell resolves "
        "from it without a trial")
    return {"measured_on": cache.measured_on, "entries": len(ours),
            "resolved": resolved}


def autotune_engine(torch, dev, tmp):
    """12d: an Engine serving imc-paper-110m ``exact`` from a copy of the
    committed cache; one ``store()`` between two waves: the next wave's
    decode step is a new step captured once (its prefill and admission
    steps too: the geometry token is global), the streams are the first
    wave's, and a further wave captures nothing."""
    import dataclasses
    import shutil

    from repro_torch.kernels import autotune
    from repro_torch.kernels.autotune import tuner
    from repro_torch.launch.engine import Engine
    from repro_torch.telemetry import Registry

    path = os.path.join(tmp, "engine.json")
    shutil.copy(tuner._COMMITTED, path)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = path
    autotune.set_cache(None)
    cfg, params, prompts = served_model(torch, dev)
    eng = Engine(dev, registry=Registry())
    must = ("imc_mac", "paged_attn")
    never = ("bitplane_mac", "flash_attn", "bitplane_mac_noisy",
             "paged_attn_staged")

    def wave(tag):
        steps = dataclasses.replace(eng.stats)
        _, run = serve_once(torch, dev, eng, cfg, params, prompts,
                            f"[12d] exact, {tag}", must, never)
        return run, eng.stats.compiles - steps.compiles

    def decode_steps():
        return sum(key[1] == "decode" for key in eng._steps)

    first, built = wave("first wave")
    warm, _ = wave("second wave")
    d1 = eng.decode_step(cfg)
    kernel, shapes, geom = AUTOTUNE_STORE
    bucket = autotune.shape_bucket(shapes)
    autotune.get_cache().store(kernel, bucket, "int8",
                               autotune.backend_key(dev),
                               {**autotune.DEFAULTS[kernel], **geom}, 0.0, 0)
    resolved = autotune.lookup(kernel, shapes, device=dev)
    stored, rebuilt = wave("after one store()")
    d2 = eng.decode_step(cfg)
    further, again = wave("a further wave")
    if d2 is d1 or decode_steps() != 2 or len(d2._bindings) != 1 or \
            eng.decode_step(cfg) is not d2:
        raise AssertionError("[12d] after the store the decode step was not "
                             "a new step captured once")
    if stored["captures"] != first["captures"] or rebuilt != built:
        raise AssertionError(
            f"[12d] the store rebuilt {rebuilt} steps with "
            f"{stored['captures']} captures; a cold Engine built {built} "
            f"with {first['captures']}")
    if warm["captures"] or further["captures"] or again:
        raise AssertionError(f"[12d] a warm wave captured {warm['captures']}"
                             f" graphs; a further wave built {again} steps "
                             f"and captured {further['captures']}")
    # a capturing wave also counts its captures' warm-up launches
    for tag, run, like in (("second", warm, warm), ("stored", stored, first),
                           ("further", further, warm)):
        if run["streams"] != first["streams"] or \
                run["launches"] != like["launches"]:
            raise AssertionError(f"[12d] the {tag} wave's streams or launches "
                                 "differ from the first waves'")
    del os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]
    autotune.set_cache(None)
    log(f"[12d] one store() of {kernel} at {bucket} ({resolved}): the next "
        f"wave's decode step a new step captured once ({rebuilt} steps and "
        f"{stored['captures']} graphs in all, as the first wave's {built} "
        f"and {first['captures']}), equal streams and launches; a further "
        "wave 0 steps, 0 captures")
    return {"captures": [first["captures"], warm["captures"],
                         stored["captures"], further["captures"]],
            "steps_built": [built, rebuilt, again], "stored": resolved}


def phase_autotune(torch, dev):
    """Phase 12 (``--autotune``): the autotuner on the card (module
    docstring)."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        plans, outputs = autotune_candidates(torch, dev)
        tuning = autotune_tuning(torch, dev, tmp)
        committed = autotune_committed(torch, dev)
        engine = autotune_engine(torch, dev, tmp)
    wall = time.perf_counter() - t0
    log(f"[12] autotune: {wall:.1f} s in all")
    return {"plans": plans, "outputs": outputs, "tuning": tuning,
            "committed": committed, "engine": engine, "wall_s": wall}


def autotune_row(auto, kernel):
    """A kernel's part of phase 12 for the ``kernels`` line (None for a
    kernel with nothing to tune)."""
    if kernel not in auto["outputs"]:
        return None
    return {"candidates_checked": auto["outputs"][kernel],
            "cells": [{k: r[k] for k in ("bucket", "geometry", "us",
                                         "default_us")}
                      for r in auto["tuning"]["rows"]
                      if r["kernel"] == kernel],
            "committed": {k.split("|")[1]: g for k, g in
                          auto["committed"]["resolved"].items()
                          if k.split("|")[0] == kernel}}


def tune_card(out_path, smi):
    """``--tune OUT``: ``tune_standard(smoke=False)`` into a fresh cache at
    OUT, stamped with the card's nvidia-smi line (how the committed
    ``tuned.json`` was made)."""
    from repro_torch.kernels import autotune

    if os.path.exists(out_path):
        os.unlink(out_path)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = out_path
    autotune.set_cache(None)
    cache = autotune.get_cache()
    cache.measured_on = smi
    rows = autotune.tune_standard(smoke=False)
    cache.save()
    for r in rows:
        log(f"[tune] {r['kernel']} {r['bucket']}: winner {r['geometry']} "
            f"{r['us']:.3f} us, default {r['default_us']:.3f} us")
    return rows


def tuned_turns(torch, dev):
    """``--tuned-turns``: phase 6's three served paths on full-width
    imc-paper-110m from the committed cache and from an empty one (the
    defaults), in turns (committed, empty, empty, committed); each turn a
    fresh graph Engine per path serves the six requests twice and the
    second serve, replays only, gives graph TPOT p50.  Streams equal across
    every turn."""
    import dataclasses
    import tempfile

    from repro_torch.core.fabric import FabricSpec
    from repro_torch.kernels import autotune
    from repro_torch.launch.engine import Engine
    from repro_torch.telemetry import Registry

    cfg, params, prompts = served_model(torch, dev)
    sim_cfg = dataclasses.replace(cfg, fabric=FabricSpec(mode="sim"),
                                  use_flash_kernel=True)
    paths = {
        "exact": (cfg, ("imc_mac", "paged_attn"),
                  ("bitplane_mac", "flash_attn", "bitplane_mac_noisy"), 0),
        "sim_flash": (sim_cfg, ("bitplane_mac", "flash_attn", "paged_attn"),
                      ("imc_mac", "bitplane_mac_noisy"), 0),
        "sim_noise": (noisy_config(cfg), ("bitplane_mac_noisy", "flash_attn",
                                          "paged_attn"),
                      ("imc_mac", "bitplane_mac"), NOISE_SEED)}
    res, streams = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        empty = os.path.join(tmp, "empty.json")
        open(empty, "w").close()
        for turn, which in enumerate(("committed", "empty", "empty",
                                      "committed")):
            if which == "empty":
                os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = empty
            else:
                os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
            autotune.set_cache(None)
            for name, (c, must, never, seed) in paths.items():
                eng = Engine(dev, noise_seed=seed, registry=Registry())
                tag = f"[turns] {name}, {which} cache, turn {turn}"
                serve_once(torch, dev, eng, c, params, prompts,
                           f"{tag}, capturing", must, never)
                _, run = serve_once(torch, dev, eng, c, params, prompts,
                                    f"{tag}, replaying", must, never)
                if run["captures"]:
                    raise AssertionError(f"{tag}: the second serve captured")
                if streams.setdefault(name, run["streams"]) != \
                        run["streams"]:
                    raise AssertionError(f"{tag}: the streams differ")
                res.setdefault(name, {}).setdefault(which, []).append(
                    run["slos"]["tpot_ms"]["p50"])
                del eng
                free_device(torch)
        os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
        autotune.set_cache(None)
    for name, r in res.items():
        log(f"[turns] {name}: graph TPOT p50 committed {r['committed']}, "
            f"empty (defaults) {r['empty']} ms")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from the root "
              "of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()

    if len(sys.argv) > 2 and sys.argv[1] == "--time":
        from repro_torch.kernels import build

        log(build.build_all([n for n in sys.argv[2:] if n in build.KERNELS]))
        out = {n: TIMERS[n](torch, dev) for n in sys.argv[2:]}
        print(json.dumps({"timed": out, "kind": kind}))
        print(smi)
        return 0
    if sys.argv[1:] == ["--serve-noisy"]:
        from repro_torch.kernels import build

        log(build.build_all(["bitplane_mac_noisy", "flash_attn",
                             "paged_attn"]))
        print(json.dumps({"serve_noisy": serve_noisy(torch, dev),
                          "kind": kind}))
        print(smi)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--eager-turns":
        print(json.dumps({"eager_turns": eager_turns(sys.argv[2]),
                          "kind": kind}))
        print(smi)
        return 0
    if sys.argv[1:] == ["--train"]:
        from repro_torch.kernels import build

        log(build.build_all(["imc_mac", "bitplane_mac",
                             "bitplane_mac_noisy"]))
        print(json.dumps({"trained": phase_train(torch, dev), "kind": kind}))
        print(smi)
        return 0
    if len(sys.argv) == 4 and sys.argv[1] == "--drift":
        from repro_torch.kernels import build

        log(build.build_all(["imc_mac"]))
        print(json.dumps({"drift": drift(torch, dev, sys.argv[2],
                                         int(sys.argv[3])), "kind": kind}))
        print(smi)
        return 0
    if sys.argv[1:2] == ["--families"]:
        from repro_torch.kernels import build

        log(build.build_all(["imc_mac", "paged_attn", "bitplane_mac",
                             "flash_attn", "bitplane_mac_noisy"]))
        only = sys.argv[2:] or None
        out = {}
        if only is None or set(only) - set(RECURRENT_FAMILIES):
            out["families"] = phase_families(torch, dev, only)
        if only is None or set(only) & set(RECURRENT_FAMILIES):
            out["recurrent"] = phase_recurrent(torch, dev, only)
        if only is None:
            out.update(attn=phase_family_attn(torch, dev),
                       rows=time_family_rows(torch, dev),
                       recurrent_rows=time_recurrent_rows(torch, dev))
        print(json.dumps({"families": out, "kind": kind}))
        print(smi)
        return 0
    if sys.argv[1:] == ["--fleet"]:
        from repro_torch.kernels import build

        log(build.build_all(["imc_mac", "paged_attn", "bitplane_mac",
                             "flash_attn"]))
        print(json.dumps({"fleet": phase_fleet(torch, dev), "kind": kind}))
        print(smi)
        return 0
    if sys.argv[1:] == ["--attn-variants"]:
        from repro_torch.kernels import build

        log(build.build_all(["paged_attn", "flash_attn"]))
        print(json.dumps({"attn_variants": attn_variants(torch, dev),
                          "kind": kind}))
        print(smi)
        return 0
    if sys.argv[1:] == ["--bitplane-variants"]:
        from repro_torch.kernels import build

        log(build.build_all(["bitplane_mac"]))
        print(json.dumps({"bitplane_variants": bitplane_variants(torch, dev),
                          "kind": kind}))
        print(smi)
        return 0
    if sys.argv[1:] == ["--noisy-variants"]:
        print(json.dumps({"noisy_variants": noisy_variants(torch, dev),
                          "kind": kind}))
        print(smi)
        return 0
    if sys.argv[1:] == ["--rbl-phases"]:
        from repro_torch.kernels import build

        log(build.build_all(["imc_mac"]))
        print(json.dumps({"rbl_phases": rbl_phases(torch, dev),
                          "kind": kind}))
        print(smi)
        return 0
    if sys.argv[1:] == ["--autotune"]:
        from repro_torch.kernels import build

        log(build.build_all(["imc_mac", "paged_attn", "bitplane_mac",
                             "bitplane_mac_noisy", "rbl_decode_mac"]))
        print(json.dumps({"autotune": phase_autotune(torch, dev),
                          "kind": kind}))
        print(smi)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--tune":
        from repro_torch.kernels import build

        log(build.build_all(["imc_mac", "bitplane_mac", "bitplane_mac_noisy",
                             "rbl_decode_mac"]))
        print(json.dumps({"tuned": tune_card(sys.argv[2], smi),
                          "kind": kind}))
        print(smi)
        return 0
    if sys.argv[1:] == ["--tuned-turns"]:
        from repro_torch.kernels import build

        log(build.build_all())
        print(json.dumps({"tuned_turns": tuned_turns(torch, dev),
                          "kind": kind}))
        print(smi)
        return 0
    if sys.argv[1:] == ["--int8-witness"]:
        from repro_torch.kernels import build

        log(build.build_all(["paged_attn"]))
        print(json.dumps({"int8_witness": int8_witness(torch, dev),
                          "kind": kind}))
        print(smi)
        return 0
    seconds = {}

    def phase(label, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[label] = time.perf_counter() - t0
        log(f"[time] phase {label}: {seconds[label]:.1f} s")
        return out

    build_s = phase("1", phase_build)
    mac_err = phase("2", phase_imc_mac, torch, dev)
    dq_err = phase("2b", phase_imc_mac_dequant, torch, dev)
    attn_err, attn_worst = phase("3", phase_paged_attn, torch, dev)
    bp_err = phase("4", phase_bitplane_mac, torch, dev)
    bpn_err = phase("4b", phase_bitplane_mac_noisy, torch, dev)
    rbl_err = phase("4c", phase_rbl_decode_mac, torch, dev)
    flash_err, flash_worst = phase("5", phase_flash_attn, torch, dev)
    family_attn = phase("3, 5 (9, 10)", phase_family_attn, torch, dev)
    served = phase("6a-c", phase_server, torch, dev)
    exact, sim = served["exact"], served["sim_flash"]
    noisy = served["sim_noise"]
    macro = phase("6d", phase_macro, torch, dev)
    served["qwen"] = phase("6e", serve_family, torch, dev, "qwen2.5-3b")
    trained = phase("8", phase_train, torch, dev)
    # phases 9 to 12 each in a process of its own, from a fresh CUDA
    # context, allocator and profiler: late in this process, after phases
    # 6-8, the profiler has missed one kernel of a replayed graph that a
    # fresh process counts (in phases 9 and 10); phase 11's two virtual
    # hosts and its process group, and phase 12's caches, start clean
    families = phase("9", own_process, torch, [
        "--families", *SERVED_FAMILIES, *FRONTEND_FAMILIES])[
        "families"]["families"]
    recurrent = phase("10", own_process, torch, [
        "--families", *RECURRENT_FAMILIES])["families"]["recurrent"]
    fleet = phase("11", own_process, torch, ["--fleet"], timeout=600)[
        "fleet"]
    autotuned = phase("12", own_process, torch, ["--autotune"],
                      timeout=300)["autotune"]
    timed = phase("7", lambda: {name: fn(torch, dev)
                                for name, fn in TIMERS.items()})
    for name, row in phase("7 (9)", time_family_rows, torch, dev).items():
        timed[name]["families"] = row
    for name, row in phase("7 (10)", time_recurrent_rows, torch,
                           dev).items():
        timed[name]["recurrent"] = row
    timed["bitplane_mac_noisy"]["noise_free_bitplane_mac_ms"] = \
        timed["bitplane_mac"]["ms"]
    # the tensor-core kernels' own entries: one projection of the bucket-64
    # prefill, the kernel, its plain version and its library call (none for
    # the noisy pyramid) on the same inputs
    timed["bitplane_mac_mma"] = dict(
        timed["bitplane_mac"]["prefill64"]["one_projection"])
    timed["bitplane_mac_noisy_mma"] = dict(
        timed["bitplane_mac_noisy"]["prefill64"]["one_projection"])
    for key in ("prefill16", "prefill32", "prefill64", "train"):
        timed["bitplane_mac_noisy"][key]["noise_free_graph_ms"] = \
            timed["bitplane_mac"][key]["graph_ms"]

    tpu = "src/repro/kernels"
    kernels = [
        dict(name="imc_mac", replaces=f"{tpu}/imc_mac/imc_mac.py:65",
             path="exact", launches=exact["launches"]["imc_mac"],
             launches_per_decode_step=exact["per_decode_step"]["imc_mac"],
             launches_per_prefill=exact["per_prefill"]["imc_mac"],
             launches_split=exact["launches"]["imc_mac_split"],
             launches_tiled=exact["launches"]["imc_mac_tiled"],
             launches_train=trained["exact"]["launches"],
             launches_per_train_step=trained["exact"]["launches_per_step"],
             max_abs_err=mac_err),
        dict(name="paged_attn", replaces=f"{tpu}/paged_attn/paged_attn.py:131",
             path="exact", launches=exact["launches"]["paged_attn"],
             launches_sim_flash=sim["launches"]["paged_attn"],
             launches_per_decode_step=exact["per_decode_step"]["paged_attn"],
             launches_per_prefill=exact["per_prefill"]["paged_attn"],
             launches_split=exact["launches"]["paged_attn_split"],
             launches_ctx=exact["launches"]["paged_attn_ctx"],
             launches_merge=exact["launches"]["paged_attn_merge"],
             launches_staged=exact["launches"]["paged_attn_staged"],
             max_abs_err=attn_err, max_abs_err_by_dtype=attn_worst),
        dict(name="bitplane_mac",
             replaces=f"{tpu}/bitplane_mac/bitplane_mac.py:98",
             path="sim_flash", launches=sim["launches"]["bitplane_mac"],
             launches_per_decode_step=sim["per_decode_step"]["bitplane_mac"],
             launches_per_prefill=sim["per_prefill"]["bitplane_mac"],
             launches_train=trained["sim"]["launches"],
             launches_per_train_step=trained["sim"]["launches_per_step"],
             max_abs_err=bp_err),
        dict(name="bitplane_mac_mma",
             replaces=f"{tpu}/bitplane_mac/bitplane_mac.py:98",
             source="src/repro_torch/csrc/bitplane_mac.cu",
             path="sim_flash", launches=sim["launches"]["bitplane_mac_mma"],
             launches_per_decode_step=sim["per_decode_step"][
                 "bitplane_mac_mma"],
             launches_per_prefill=sim["per_prefill"]["bitplane_mac_mma"],
             launches_per_prefill_64=sim["per_prefill_64"][
                 "bitplane_mac_mma"],
             launches_train=trained["sim"]["launches_by_counter"][
                 "bitplane_mac_mma"],
             launches_per_train_step=trained["sim"]["launches_per_step"],
             max_abs_err=bp_err),
        dict(name="flash_attn", replaces=f"{tpu}/flash_attn/flash_attn.py:81",
             path="sim_flash", launches=sim["launches"]["flash_attn"],
             launches_per_decode_step=sim["per_decode_step"]["flash_attn"],
             launches_per_prefill=sim["per_prefill"]["flash_attn"],
             launches_tc=sim["launches"]["flash_attn_tc"],
             launches_cuda_core=sim["launches"]["flash_attn_simt"],
             max_abs_err=flash_err, max_abs_err_by_dtype=flash_worst),
        dict(name="bitplane_mac_noisy",
             replaces=f"{tpu}/bitplane_mac/bitplane_mac.py:187",
             path="sim_noise", launches=noisy["launches"]["bitplane_mac_noisy"],
             launches_per_decode_step=noisy["per_decode_step"][
                 "bitplane_mac_noisy"],
             launches_per_prefill=noisy["per_prefill"]["bitplane_mac_noisy"],
             launches_train=trained["noisy"]["launches"],
             launches_per_train_step=trained["noisy"]["launches_per_step"],
             max_abs_err=bpn_err),
        dict(name="bitplane_mac_noisy_mma",
             replaces=f"{tpu}/bitplane_mac/bitplane_mac.py:187",
             source="src/repro_torch/csrc/bitplane_mac_noisy.cu",
             path="sim_noise",
             launches=noisy["launches"]["bitplane_mac_noisy_mma"],
             launches_per_decode_step=noisy["per_decode_step"][
                 "bitplane_mac_noisy_mma"],
             launches_per_prefill=noisy["per_prefill"][
                 "bitplane_mac_noisy_mma"],
             launches_per_prefill_64=noisy["per_prefill_64"][
                 "bitplane_mac_noisy_mma"],
             launches_train=trained["noisy"]["launches_by_counter"][
                 "bitplane_mac_noisy_mma"],
             launches_per_train_step=trained["noisy"]["launches_per_step"],
             max_abs_err=bpn_err),
        dict(name="imc_mac_dequant",
             replaces=f"{tpu}/imc_mac/imc_mac.py:91",
             source="src/repro_torch/csrc/imc_mac.cu", path="macro (6d)",
             launches=macro["launches"]["imc_mac_dequant"],
             launches_per_decode_step=exact["per_decode_step"][
                 "imc_mac_dequant"],
             launches_per_prefill=exact["per_prefill"]["imc_mac_dequant"],
             launches_split=macro["launches"]["imc_mac_dequant_split"],
             launches_tiled=macro["launches"]["imc_mac_dequant_tiled"],
             max_abs_err=dq_err),
        dict(name="rbl_decode_mac",
             replaces=f"{tpu}/rbl_decode/rbl_decode.py:67",
             path="macro (6d)", launches=macro["launches"]["rbl_decode_mac"],
             launches_per_decode_step=exact["per_decode_step"][
                 "rbl_decode_mac"],
             launches_per_prefill=exact["per_prefill"]["rbl_decode_mac"],
             max_abs_err=rbl_err),
    ]
    fam_rows = {"imc_mac": ("qwen2-72b", "exact", "imc_mac"),
                "paged_attn": ("gemma3-12b", "exact", "paged_attn"),
                "flash_attn": ("gemma3-12b", "sim_flash", "flash_attn")}
    rec_rows = {"imc_mac": ("mamba2-370m", "exact", "imc_mac"),
                "paged_attn": ("recurrentgemma-9b", "exact", "paged_attn")}
    from repro_torch.kernels.launches import KERNELS, variants

    for k in kernels:
        k["launches_families"] = family_launches(families, k["name"])
        k["launches_recurrent"] = recurrent_launches(recurrent, k["name"])
        # each __global__ function of the kernel (the context-split
        # paged_attn and its merge among them), with its launches in
        # phases 9 and 10
        k["global_functions"] = {
            v: dict(functions=list(KERNELS[name][2][attr]),
                    launches_families=family_launches(families, v),
                    launches_recurrent=recurrent_launches(recurrent, v))
            for v, (name, attr) in variants().items() if name == k["name"]}
        k["launches_fleet"] = fleet_launches(fleet, k["name"])
        k["autotune"] = autotune_row(autotuned, k["name"])
        if k["name"] in fam_rows:  # the phase-9 row's own path
            name, path, key = fam_rows[k["name"]]
            timed[k["name"]]["families"]["launches"] = \
                families[name][path]["launches"][key]
        if k["name"] in rec_rows:  # the phase-10 row's own path
            name, path, key = rec_rows[k["name"]]
            timed[k["name"]]["recurrent"]["launches"] = \
                recurrent[name][path]["launches"][key]
        k["max_abs_err_families"] = {
            key: v for key, v in family_attn.items()
            if key.split()[0] == k["name"].split("_")[0]} or None
        k.setdefault("source", f"src/repro_torch/csrc/{k['name']}.cu")
        k.update(route="cuda", **timed[k["name"]])
        lib = "none" if k["library_ms"] is None else \
            f"{k['library_ms']:.4f} ms"
        graph = "" if "graph_ms" not in k else \
            f"; {k['graph_ms']:.4f} ms replayed from a CUDA graph"
        if "library_graph_ms" in k:
            lib += f", {k['library_graph_ms']:.4f} ms from a graph"
        if "floor_graph_ms" in k:
            graph += (f"; 12 trivial launches from a graph "
                      f"{k['floor_graph_ms']:.4f} ms")
        log(f"[7] {k['name']}: {k['ms']:.4f} ms{graph} (bound "
            f"{k['bound_ms']:.4f} ms by {k['bound_by']}; plain "
            f"{k['plain_ms']:.4f} ms; library "
            f"{lib}); {k['launches_per_decode_step']} "
            f"launches per decode step, {k['launches_per_prefill']} per "
            f"prefill, {k['launches']} in the {k['path']} run")
    for key in ("prefill16", "prefill32", "prefill64", "train"):
        t = timed["bitplane_mac"][key]
        log(f"[7] bitplane_mac, {t['shape']}: {t['graph_ms']:.4f} ms from a "
            f"graph, {t['graph_ms_detuned']:.4f} ms under the detuned table "
            f"({t['tensor_core_launches']} tensor-core launches); library "
            f"{t['library_graph_ms']:.4f} ms from a graph; bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']}, decode bound "
            f"{t['bound_ms_decode']:.4f} ms ({t['bound_decode_counts']:.4g} "
            "group counts)")
        one = t.get("one_projection")
        if one is not None:
            log(f"[7] bitplane_mac, {one['shape']}: {one['ms']:.4f} ms, "
                f"{one['graph_ms']:.4f} ms from a graph; plain "
                f"{one['plain_ms']:.4f} ms; library {one['library_ms']:.4f} "
                f"ms; bound {one['bound_ms']:.4f} ms by {one['bound_by']}, "
                f"decode bound {one['bound_ms_decode']:.4f} ms")
        t = timed["bitplane_mac_noisy"][key]
        log(f"[7] bitplane_mac_noisy, {t['shape']}: "
            f"{t['graph_ms']:.4f} ms from a graph ("
            f"{t['tensor_core_launches']} tensor-core launches; bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']}; noise-free "
            f"bitplane_mac {t['noise_free_graph_ms']:.4f} ms)")
        one = t.get("one_projection")
        if one is not None:
            log(f"[7] bitplane_mac_noisy, {one['shape']}: {one['ms']:.4f} "
                f"ms, {one['graph_ms']:.4f} ms from a graph; plain "
                f"{one['plain_ms']:.4f} ms; bound {one['bound_ms']:.4f} ms "
                f"by {one['bound_by']}")
    for name, key in (("imc_mac", "prefill"), ("imc_mac", "prefill32"),
                      ("imc_mac", "train"), ("imc_mac", "families"), ("paged_attn", "families"),
                      ("flash_attn", "families"), ("imc_mac", "recurrent"),
                      ("paged_attn", "recurrent"),
                      ("imc_mac_dequant", "prefill"),
                      ("rbl_decode_mac", "sweep")):
        t = timed[name][key]
        log(f"[7] {name}, {t['shape']}: {t['ms']:.4f} ms, "
            f"{t['graph_ms']:.4f} ms from a graph (bound {t['bound_ms']:.4f} "
            f"ms by {t['bound_by']}; plain {t['plain_ms']:.4f} ms; library "
            f"{t['library_ms']:.4f} ms, {t['library_graph_ms']:.4f} ms from "
            "a graph)" + ("" if "l2_graph_ms" not in t else
                          f"; over one layer's weights, resident in L2, "
                          f"{t['l2_graph_ms']:.4f} ms from a graph"))
    t = timed["bitplane_mac_noisy"]
    for tag, what in (("", "calibrated mismatch"),
                      ("_both", "mismatch + comparator offset"),
                      ("_dense", "calibrated mismatch, dense operands"),
                      ("_dense_both", "mismatch + offset, dense operands")):
        tiers = t[f"tiers{tag}"]
        plain = t.get("plain_ms" if tag == "" else f"plain_ms{tag}_one_layer")
        log(f"[7] bitplane_mac_noisy, {what}: {t[f'ms{tag}']:.4f} ms, "
            f"{t[f'graph_ms{tag}']:.4f} ms from a graph (stream floor "
            f"{t[f'bound_ms{tag}']:.4f} ms by {t[f'bound_by{tag}']}; "
            f"hardware Box-Muller floor {t[f'sfu_bound_ms{tag}']:.4f} ms"
            + ("" if plain is None else f"; plain {plain:.4f} ms"
               + ("" if tag == "" else " on one layer")) +
            f"); tiers 2 / 3 / full {tiers['tier2']:.4f} / "
            f"{tiers['tier3']:.4f} / {tiers['full']:.6f}")
    log(f"[7] noise-free bitplane_mac {t['noise_free_bitplane_mac_ms']:.4f} "
        "ms")
    log(f"[summary] build {build_s:.2f} s; served {json.dumps(served)}; "
        f"macro {json.dumps(macro)}; trained {json.dumps(trained)}; "
        f"families {json.dumps(families)}; recurrent {json.dumps(recurrent)}"
        f"; fleet {json.dumps(fleet)}; autotune {json.dumps(autotuned)}")
    log(f"[time] phases {json.dumps(seconds)}; "
        f"{sum(seconds.values()):.1f} s in all (phase 12's own "
        f"{autotuned['wall_s']:.1f} s)")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
