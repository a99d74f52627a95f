#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

In order:

1. print the card (``nvidia-smi`` name and power limit) and build every
   CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
   at once); print the registers, spills, shared memory and blocks per SM
   of every instance of the flash (hd 32, 64, 80, 128 with two query heads
   a block, or one over 128 or 64 positions; hd 256 with one), matmul (int8 and nib4, both routes) and
   wkv kernels (wkv must not spill);
2. kernel phases: hold each kernel against its plain PyTorch version on the
   card at the main paths' Qwen3-0.6B shapes -- both matmuls (int8 and
   nib4 weights, at M = 4 and M = 128, also at the RWKV6-7B,
   StarCoder2-7B and RecurrentGemma-2B projection shapes, bit for bit, each
   nib4 time printed beside the int8 one),
   fake-quant forward and its dv bit for bit (atol 0), the fake-quant ds
   to rtol 1e-4 of |ds| plus 1e-6 of sum |g * dsd| (float32 sums in
   another order, over up to 155M terms), int8 decode attention on the ring
   and on pooled pages (permuted page ids, pages shared between slots,
   unmapped table entries, evicted rows, a slot at query position -1) to
   rtol 2e-5 / atol 2e-6 (and, on the ring, bit for bit a launch on q
   pre-scaled on the card: the kernel's own q scale; on pages, bit for bit
   the ring kernel on the gathered view), the S-query verify
   attention on both layouts to rtol 2e-5 / atol 2e-6 and bit for bit
   against S one-token launches, each attention row with its split over
   cache rows (rows per block, splits, query groups, blocks); all four
   attention launches also past 8 query heads per kv head, at
   StarCoder2-7B's shape (KV 4, G 9, its 4096-row window, and a 48-row
   window that masks rows of the 320-row ring) and Granite-20B's (KV 1,
   G 48), timed beside the G = 2 rows, and the one-token launch at
   RecurrentGemma-2B's (KV 1, G 10, hd 256, a 2048-row ring under its
   2048-row window and under a 48-row one that masks); flash forward to
   2e-5 (out) / 1e-5 (lse), also at hd 256 (RecurrentGemma-2B's 2560-token
   prefill: KV 1, G 10, causal, window 2048) and at hd 80 (HuBERT-XLarge's
   2048 frames: KV 16, G 1, bidirectional), the fake-quant kernels also at
   HuBERT-XLarge's (1280, 1280) and (1280, 5120) weights and its (2048,
   5120) MLP activation, the fake-quant forward with a scale per expert
   (64 scales) at deepseek-moe-16b's decode expert input (64, 4, 2048) and
   an expert stack (64, 2048, 1408), the backward with 64 scales at that
   stack and its training expert input (64, 256, 2048) (dv bit for bit,
   each expert's ds to rtol 1e-4 of |ds| plus 1e-6 of its sum |g * dsd|),
   flash at its training attention (KV 16, G 1, hd 128, causal, S 2048),
   the matmuls at its five projection shapes and decode attention at its
   KV 16, G 1 -- and time
   kernel, plain version and, where one PyTorch call computes the same
   function, that call (CUDA-event medians, L2 flushed before each launch);
3. train phase: the paper pipeline on Qwen3-0.6B at full width and depth
   (28 layers, seeded random weights), B=1, S=2048, float32: 2 joint
   importance steps (5 uniform + 1 random pass, SGD on the banks only),
   indicator extraction, the ILP search under the uniform-3-bit BitOps
   budget, 3 QAT steps under the searched policy (AdamW 3e-3, clip 1.0), an
   evaluation batch. Gates: (a) fake-quant forward / backward and flash
   launches exactly as the schedule implies (per pass 394 / 394 / 28);
   (b) every loss and gradient norm finite; (c) the backbone bit for bit
   unchanged by the importance steps, every bank moved; (d) the searched
   policy valid and within its budget; (f) one QAT step's loss and
   gradients with ``remat=False`` and ``remat=True`` bit for bit, each with
   the launches its schedule implies (with remat each body unit's
   fake-quant and flash forwards run twice: 786 / 394 / 56), their peak
   device memory and ms printed; (g) the HAWQ baseline
   (``core.hessian``, 4 probes) on the trained params at 28 layers and the
   first batch cut to ``HAWQ_S`` = 1024 tokens: every trace finite, the
   table non-increasing in bits, the ILP on it a valid policy within the
   same budget, its time beside the importance steps'; (h) its
   Hessian-vector product at 2 layers and S = 2048 (the plain flash
   baseline's second derivative) within 1e-3 (relative L2) of a float64
   central difference of gradients;
4. serve phase: Qwen3-0.6B at full width (28 layers, seeded random
   weights) under ``demo_mixed_policy`` (w-bits cycle 2..6, so both matmul
   kernels serve), 8 requests with staggered 128-256-token prompts and 32
   new tokens over 4 slots, int8 ring KV cache of 320 rows, continuous
   batching, greedy. Gates: (a) every serving kernel launched and no
   kernel-eligible projection fell through to dequant-fp; (b) greedy tokens
   equal the fake-quant reference engine's on every decisive step -- the
   reference's top-2 margin > 1e-2 and its float64 evaluation agreeing
   (``serve.check_greedy``); a request's comparison stops at its first
   non-decisive step; (c) packed weight bytes within 5% of
   ``MPQPolicy.size_bytes``; (d) one profiled decode step launches 4707
   kernels (one per matmul and attention call, with the rest of the step's
   kernels). The reference engine runs the plain versions
   (``ops.plain_on_cuda()``), so its fake-quant is plain PyTorch;
5. paged serve phase: the same 8 requests, their first 128 tokens (16 pages
   of 8) made the same, served over pooled int8 pages with shared-prefix
   remapping and chunked append prefill. Gates: ``decode_attn_quant_paged``
   launched 28 times per decode step and ``decode_attn_quant`` never, and
   one profiled decode step launches 5239 kernels; greedy
   tokens as in (b); prefix hits, and fewer tokens prefilled than the ring
   phase; the page pool consistent and every slot empty after the drain;
6. speculative serve phases, ring and paged: the first wave of phases 4
   and 5 (4 requests, one a slot into fresh caches, to ``WAVE_GEN`` new
   tokens; 8 of 32 before the mixtral phase, cut for the time limit) with
   ``speculate=4``, ``draft_bits=2`` (a uniform int2 repack of the same
   weights drafts, the searched policy verifies). Gates: (a) tokens equal
   the first ``WAVE_GEN`` of the token-at-a-time phase's on every
   decisive step of it (top-2 margin above 1e-2,
   ``engine.decisive_prefix``); (b) exactly 28
   ``verify_attn_quant[_paged]`` launches per round and no one-token launch
   inside the verify pass; (c) no host synchronisation inside a round
   (``set_sync_debug_mode("error")`` around each); (d) paged: a consistent
   pool and the paged phase's prefix hits of the same wave. Then the
   midflight check (one request, one slot: after four rounds the
   speculative engine's KV -- pos exactly, codes and scales on valid rows
   -- is the token-at-a-time engine's at the same length, bit for bit)
   and the self-draft check (a target policy at the draft's own width:
   every draft on a decisive step accepted);
7. train gate (e): one ``loss_fn`` + backward at full width, 2 layers, S =
   2048, through the kernels and through their plain versions
   (``ops.plain_on_cuda``), loss and every gradient within ``TRAIN_TOL``:
   once with activations unquantized, every kernel against its plain
   version; once with them quantized, the fake-quant kernels against their
   plain versions and the flash kernel on both sides, so that every
   quantizer code is the same on both sides (the full-depth differences,
   which part on code flips, are cut for the time limit);
8. RWKV serve phase: rwkv6-7b at its published widths and depth (32
   layers, d_model 4096, 64 heads of 64, d_ff 14336, vocab 65536, untied
   head; seeded random weights, 7.58 B parameters, 30.3 GB in float32)
   under ``demo_mixed_policy`` (w-bits cycle 2..6 over 256 projections),
   8 requests of 128-256 prompt tokens (seven multiples of 32, whose
   prefill runs the ``wkv`` kernel, and one of 200, which runs the
   step-by-step scan) and 32 new tokens over 4 slots, ring of 320,
   continuous batching, greedy. Gates: (a) ``wkv`` launched 32 times per
   prefill of a multiple of 32 and never in a decode step, both matmul
   kernels launched, no kernel-eligible projection on dequant-fp, no
   attention kernel; (b) greedy tokens as in phase 4 (the reference
   engines run plain, the float64 control in float64 throughout), gated
   at the same widths with 2 layers (as gate (e): at 32 layers the float32
   and float64 evaluations part on confident steps, so none is decisive;
   the 32-layer comparison and its printed prefill logits are cut for the
   time limit); (c)
   packed bytes within 5%; (d) no host synchronisation inside a decode step
   (``set_sync_debug_mode("error")``); (e) a profiled 256-token prefill
   runs the ``wkv`` kernel once per layer (its device time printed, and the
   matmul kernels' time in a profiled decode step). The ``wkv`` kernel
   itself is held to 2e-4 (atol and rtol, y and the final state) against
   its plain version in the kernel phases, from zero and from a random
   state, and with the strongest decay (log w = -8).

9. serve CLI phase: ``repro_torch.launch.serve.main`` at Qwen3-0.6B full
   width (its own ``--stagger`` requests: 256-token prompts less 0-9, 32
   new tokens less 0-4, 4 slots, a 320-row cache), the prefill chunk from
   the roofline model on the H100 envelope. First the ring with
   ``--compare`` over 8 requests and ``--trace-out``, ``--metrics-out``
   and ``--metrics-stream``. Gates: the kernels launched; the chunk in
   [16, 512]; the written Chrome trace valid and reconciled with the
   stats; the calibration rows finite and positive; tokens identical to
   the fixed schedule's; the decode steps of both schedules those the
   reference engine takes (the staggered lengths put the longest requests
   last, so continuous batching takes 2 more than fixed); at least 2
   metrics snapshots; the Prometheus dump parses back to the registry's
   values; the host time spent in the trace, the KV-scale sampler, the
   monitor and the route counters printed per decode step. Then the same
   run with ``--no-trace`` (on, off: the decode-step p50s printed, the
   tokens unchanged; the off / on repeats are cut for the time limit);
   then budgeted on
   the device table the first run measured (``--chip-table``): the tokens
   unchanged, both chunks printed (these two runs serve the continuous
   schedule only: their fixed-schedule reruns are cut for the time
   limit). Last, the 8 requests over pooled pages
   sharing 128 prompt tokens, speculating (``--speculate 4 --draft-bits
   2`` on a policy file the CLI wrote): the trace reconciles (prefix
   hits, one ``spec_verify`` per round), ``spec.accept_len`` holds one
   observation per live slot and round, 28 verify launches per round and
   no sync inside a round.

10. bundle phase: the train phase's final params and searched policy saved
    as a serving bundle (``checkpoint.save_serving_bundle``) in a temporary
    directory under the git-ignored ``build/``. Gates: ``peek_serving_policy``
    returns the policy; ``QuantizedSession.from_checkpoint`` on the card
    packs code bytes bit for bit the in-memory session's; both serve the
    serve phase's first wave (4 requests of ``WAVE_GEN`` new tokens; 32
    before the per-channel and vision-train phases, cut for the time limit)
    with the same greedy tokens, bit for bit, through the matmul and ring
    attention kernels. The save and load seconds
    and the bundle's size are printed, and the directory is removed;
11. elastic phases, ring and paged: ``repro_torch.launch.serve.main`` at
    Qwen3-0.6B full width (28 layers, 4 slots) with ``--elastic
    --policy-variants 3,4,6 --requests 12 --stagger --arrive-every 1`` on a
    full-width demo policy file (the CLI's 32-token prompts less 0-9 and 16
    new tokens less 0-4; paged: half the prompt shared). Gates: at least
    one downshift, one admission round held for a drain and two variants
    serving requests; every completion bit for bit its variant's
    single-policy packed engine (``serve.check_elastic``); the trace
    reconciled; no ``pack_linear`` call after the bank is built; the matmul
    kernels and the layout's attention kernel launched (the other not), no
    kernel-eligible matmul of any variant on dequant-fp; over the ring, the
    run replayed from the largest variant on the dequant-fp routes takes
    the same swap decisions and each completion equals its variant's
    fake-quant reference engine bit for bit (the reference package's own
    gate; over pages the append chunks' float GEMM shapes differ from the
    ring reference's prefill, so not even that op chain is bitwise). The
    served tokens against that reference on decisive steps are printed:
    the kernels' exact integer sums are a third float evaluation, which
    parts from the float32 and float64 references on near-ties (margins of
    a few hundredths). Printed with the card's name and power limit: each
    variant's packed bytes, the swaps and
    ``engine.swap_ms``, the admission re-solves' ``ilp.solve_ms`` (196
    layers, 2048 bins, on the host), the decode-step p50 of each variant
    (from the trace's swap epochs) and each variant's kernel launches in one
    decode step.
12. starcoder phase: starcoder2-7b at its published widths and depth (32
    layers, d_model 4608, 36 / 4 heads of 128 -- 9 query heads per kv head,
    two query groups of the attention kernel --, d_ff 18432, its 4096-row
    sliding window, vocab 49152; seeded random weights, 7.40 B parameters,
    29.6 GB in float32) under ``demo_mixed_policy``, the serve phase's
    first wave (4 requests of ``WAVE_GEN`` new tokens; 8 of 32 before the
    per-channel and vision-train phases, cut for the time limit; the
    2-layer gates (b) keep 8 of 32) over 4 slots and a 320-row ring.
    Gates: (a) every ring kernel
    launched, no kernel-eligible projection on dequant-fp, the attention
    route fused; one decode step launches ``decode_attn_quant`` once per
    layer (32); (c) packed bytes within 5%; (b) at the same widths with 2
    layers: the run through every kernel token for token the same packed
    session with both matmuls on their plain versions (exact integer sums),
    and greedy tokens equal to the fake-quant reference's on every decisive
    step in the run whose attention is the kernel and whose matmuls take
    the dequant-fp route. The exact-sum runs (every kernel, the plain
    matmuls) against that reference are printed, not gated: at these
    widths the reference's float32 sums part from exact ones on near-ties
    (ROADMAP 3; a third, the dequant-fp route with float64 sums, is cut
    for the time limit).
13. hybrid phase: recurrentgemma-2b at its published widths and depth (26
    layers: 8 x (rec, rec, attn) and a (rec, rec) suffix; d_model 2560,
    RG-LRU width 2560, conv1d width 4, 10 query heads on one kv head of
    256, a 2048-row local window, gated-gelu d_ff 7680, tied vocab 256000;
    seeded random weights, 2.68 B parameters, 10.7 GB in float32) under
    ``demo_mixed_policy`` (164 projections), the serve phase's 8 requests
    and a 9th of 2560 prompt tokens (its prefill takes the flash kernel at
    hd 256 with a window that masks; its decode wraps the ring) with 32 new
    tokens each, 4 slots of 2048 rows, a prefill budget of 2560 tokens.
    Gates: (a) every ring kernel launched and no other layout's,
    ``flash_fwd`` once per attention layer (8, the long prefill alone), no
    kernel-eligible projection on dequant-fp; one decode step launches the
    attention kernel 8 times and 164 matmuls; (c) packed bytes within 5%;
    (d) no host synchronisation inside a decode step
    (``set_sync_debug_mode("error")``), and a profiled decode step launches
    3548 kernels (its attention and split-K matmul kernels' device time
    printed, its slots of 2048 rows at positions past the window; step
    p50, tok/s, prefill p50 and peak memory printed, and one profiled
    2560-token prefill with its 8 flash launches); (b) at 3 layers, one
    (rec, rec, attn) repeat at full width: the run through every kernel
    token for token the same session on the matmuls' plain versions; the
    run on the dequant-fp matmul route equal to the fake-quant reference on
    every decisive step (``serve.compare_greedy`` with the float64
    control); and the logits of the session through every kernel, at the
    prefill and 6 decode steps of two short prompts and the long one (each
    side carrying its own state; the long one decodes past the window),
    within max(2 x the float32 reference's distance from its float64
    evaluation, 0.05 x the logits' std) of the float32 reference. (The
    26-layer comparison with the reference is cut for the time limit.)
14. audio phase: the paper pipeline of phase 3 on hubert-xlarge, the
    encoder-only family, at its published widths and depth (48 layers,
    d_model 1280, 16 heads of 80 on 16 kv heads, bidirectional, plain gelu
    d_ff 5120, LayerNorm, the stub frontend's 512-dim frames through an
    8-bit pinned projection and a sinusoid position table, an untied
    pinned head onto 504 units; seeded random weights, 945 M parameters,
    3.8 GB in float32; 288 searchable projections), B=1, 2048 frames of
    ``SyntheticLM``'s audio branch and their unit labels, float32: 2
    importance steps, the indicators, the ILP (uniform-3-bit budget), 3
    QAT steps, an evaluation batch. Gates: (a) per pass 580 fake-quant
    forwards and backwards (two per projection, the frontend's and the
    head's weight and activation) and 48 ``flash_fwd`` launches at hd 80,
    no serving kernel; (b)-(d) as phase 3; (e) one QAT pass through the
    kernels against the plain versions, as gate (e) of phase 7, at 2
    layers; (f) remat bit for bit (1156 / 580 / 96
    launches with it). Printed: ms per importance and QAT step and
    frames/s, the ILP's ms, peak device memory, one profiled QAT step
    with ``flash_fwd_kernel`` watched. The weights are freed before the
    script ends.
15. moe phase: deepseek-moe-16b at its published widths and depth (28
    layers: a dense layer of d_ff 10944, then 27 MoE layers of 64 routed
    experts of d_ff 1408, top-6, capacity factor 1.25, and 2 shared
    experts; d_model 2048, 16 heads of 128 on 16 kv heads (G = 1), vocab
    102400, untied head; seeded random weights, 15.95 B searched weights,
    65.5 GB of float32 parameters) under ``demo_mixed_policy`` (277
    projections, 81 of them expert stacks), the serve phase's first wave
    (4 requests of ``WAVE_GEN`` new tokens; 8 of 32 before the mixtral
    phase, cut for the time limit) over 4 slots and a 320-row ring. The
    float32 tree does not fit the
    card beside its packing, so each MoE site's seeded params are made on
    the card when ``SpecSession(site_source=...)`` packs it, under the
    target policy and the 2-bit draft policy of phase 17, and dropped
    before the next (``lm.site_source``): one pack serves phases 15-17;
    the host's MemTotal and MemAvailable are printed. First the combine at deepseek's shapes (4
    tokens, and 256 whose capacity of 128 drops picks): two equal calls
    bit for bit equal, and equal to the CPU's evaluation. Gates: (a) the
    ring kernels and ``fake_quant_fwd`` launched, no other layout's, no
    kernel-eligible projection on dequant-fp, the attention route fused;
    (b) one decode step runs 81 dequant-fp matmuls, the 3 x 27 expert
    stacks; (c) packed bytes within 5% of ``MPQPolicy.size_bytes``; (d)
    one decode step launches what the schedule implies: 196 matmul
    kernels (every projection but the expert stacks: 7 in the dense
    layer, 4 attention and 3 shared-expert projections in each MoE
    layer), 28 ``decode_attn_quant`` (one a layer) and 83
    ``fake_quant_fwd`` (one per expert stack's input, the per-expert
    scale, and two for the untied pinned head's weight and input), and
    under the profiler it launches ``DECODE_STEP_LAUNCHES["moe"]`` kernels
    in all; (e) no host synchronisation inside a decode step; (f) finite
    prefill and decode logits, and two equal decode steps bit for bit
    equal. Printed: tok/s, step and prefill p50, peak device memory, the
    profiled step's device-busy share and the phase's seconds. At 28
    layers the float32 tree and a reference engine do not fit beside the
    packed session: no reference comparison there. Then at 2 layers (the
    dense layer and one MoE layer; 3 before the vision phase, cut for the
    time limit) at full width: the run through every
    kernel token for token the same session on the matmuls' plain
    versions, and the run on the dequant-fp matmul route equal to the
    fake-quant reference on every decisive step (``serve.compare_greedy``
    with the float64 control);
16. moe-paged phase: phase 15's session at 28 layers over pooled int8
    pages, the paged phase's 8 requests (128 shared prompt tokens) of
    ``WAVE_GEN`` new tokens (32 before the mixtral phase), 4 slots,
    append chunks of 256. Gates: ``decode_attn_quant_paged``
    launched 28 times a decode step and ``decode_attn_quant`` never, the
    matmul and fake-quant kernels launched, no kernel-eligible projection
    on dequant-fp; prefix hits and fewer tokens prefilled than the ring
    phase; a clean pool; packed bytes exactly the policy's; no host sync
    in a paged decode step. Then phase 15's 2-layer gates over pages: the
    all-kernel run token for token the plain-matmul run, the dequant-fp
    run equal on decisive steps to the fake-quant reference served over
    pages under the same schedule (an append chunk's pad rows attend the
    slot's pages and compete for an expert's capacity, so which tokens it
    drops depends on the pool's history: ROADMAP §3). Printed: decode and
    prefill p50, tok/s, peak memory, a profiled paged decode step;
17. moe-spec phases, ring and paged: phase 15's session at 28 layers with
    ``speculate=4`` and its 2-bit draft, the first wave of phases 15 and
    16 (4 requests, one a slot into fresh caches: the time limit; over
    pages a later admission's chunk has pad rows that attend the rows
    another history left in its pages, ROADMAP §3), each to 16 new tokens
    held to the first 16 of the token-at-a-time run's (32 before the
    vision phase, cut for the time limit). Gates as phase 6:
    tokens equal that layout's token-at-a-time run on every decisive
    step, 28 verify launches a round and no one-token
    launch in the verify pass, no sync inside a round, a clean pool and
    phase 16's prefix hits; draft bytes within 1% of the 2-bit draft
    policy's. Then the midflight check of phase 6 on this session, both
    layouts. Printed: accept rate, round p50 and tok/s beside
    token-at-a-time's;
18. moe-train phase: the paper pipeline of phase 3 on deepseek-moe-16b at
    full width cut to 4 layers (the dense layer and three MoE layers, 2.27
    B parameters: 28 layers' weights, gradients and AdamW moments take
    ~262 GB), B=1, S=2048: 2 importance steps, the indicators (an expert
    stack's the mean over its experts' banks), the ILP, 3 QAT steps, an
    evaluation batch. Gates (a)-(d) of phase 3, with 77 fake-quant launches
    each way a pass, 18 of them (each expert stack's weight and input)
    with 64 scales, and 4 ``flash_fwd`` at G 1, hd 128; then gate (e) at 3
    layers. Printed: step ms, the ILP's ms, peak memory, a
    profiled QAT step.
19. vision phase: llama-3.2-vision-11b at its published widths and depth
    (48 sites: 8 x (5 self-attention layers, then a gated cross-attention
    layer over 1600 image tokens); d_model 4096, 32 query heads on 8 kv
    heads of 128, gated-silu d_ff 14336, vocab 128256, untied head;
    seeded random weights, 11.53 B parameters, 46.1 GB in float32) under
    ``demo_mixed_policy`` (336 projections), every cross layer's
    ``gate_attn`` and ``gate_mlp`` set to ``VISION_GATE`` (the reference
    inits them to 0, and tanh(0) = 0 would make the tokens independent
    of the image); each site made on the card and packed before the next
    (``lm.site_source``). First the kernel rows at its shapes: both matmuls
    at M = 4 on its decode projections, the int8 one at M = 1600 on the
    image K/V projection, decode attention at KV 8, G 4 over the 320-row
    ring. Then the serve phase's first wave (4 requests of ``WAVE_GEN``
    new tokens; 8 of 32 before the per-channel and vision-train phases,
    cut for the time limit; gate (f) keeps 8 of 32) over 4 slots and a
    320-row ring, each carrying one of two seeded (1600, 1280)
    patch-embedding images (slots serve both in turn). Gates: (a) the ring kernels and
    the pinned fake-quant launched, no other layout's, no kernel-eligible
    projection on dequant-fp; one prefill launches a matmul kernel per
    projection (336: the cross layers' wk / wv on the image, at M = 1600)
    and 4 fake-quant (the image projection's and the head's weight and
    input); one decode step launches 320 matmul kernels (every projection
    but the cross layers' wk / wv, whose K/V the slot's state holds), 40
    ``decode_attn_quant`` (one per self-attention layer) and 2 fake-quant
    (the head), and under the profiler ``DECODE_STEP_LAUNCHES["vision"]``
    kernels in all; (b) no host synchronisation inside a decode step; (c)
    finite prefill and decode logits, two equal decode steps bit for bit
    equal; (d) the image is read: request 0's prefill logits under the two
    images differ (printed), and with the gates at 0 they are bit for bit
    equal; (e) packed bytes exactly the policy's; (f) at one unit of the
    pattern (5 self-attention layers and a cross layer) at full width, as
    phase 15's 2-layer gates: the all-kernel run token for token the
    plain-matmul run, the dequant-fp run equal on decisive steps to the
    fake-quant reference with its float64 control (at 48 sites the two
    reference engines would take the phase past its time budget).
    Printed: tok/s, step and prefill p50, peak device memory, a profiled
    decode step's launches and busy share.
20. mixtral phase: mixtral-8x7b at its published widths and depth (32
    MoE layers of 8 routed experts of d_ff 14336, top-2, capacity factor
    1.25, no shared experts and no dense layer; d_model 4096, 32 query
    heads on 8 kv heads of 128 (G = 4), a 4096-row sliding window, vocab
    32000, untied head; seeded random weights, 46.70 B parameters, 186.8
    GB in float32, which fit neither the card nor the host) under
    ``demo_mixed_policy`` (224 projections, 96 of them expert stacks),
    each site made on the card and packed before the next
    (``lm.site_source``, no prefix). First the kernel rows at its new shapes:
    decode attention at KV 8, G 4 over a 4096-row ring wrapped past its
    window, flash at B 1, S 4608, KV 8, G 4, hd 128, causal, window 4096,
    and the fake-quant forward with 8 scales at the expert inputs of a
    decode step and of the long prefill ((8, 4, 4096), (8, 4, 14336),
    (8, 1536, 4096), (8, 1536, 14336)); then the combine at T = 4 and T =
    4608 (capacity 1536, which drops picks): two calls bit for bit equal,
    and equal to the CPU's. Then the serve phase's first three prompts
    (256, 128, 224 tokens) and one of 4608 (9 x the 512-row q block, 512
    tokens past the window) with ``MIXTRAL_GEN`` (8) new tokens each (cut
    from ``WAVE_GEN`` for the time limit), over 4 slots of the window's
    4096 rows and a prefill budget of 4608 tokens.
    Gates: (a) the ring kernels, ``fake_quant_fwd`` and ``flash_fwd``
    launched, no paged or verify kernel, flash once a layer (32, the long
    prefill alone), no kernel-eligible projection on dequant-fp, the
    decode attention route fused; (b) one decode step (slots of 4096 rows
    at positions past the window) launches 128 matmul kernels (the
    attention projections), 32 ``decode_attn_quant`` and one fake-quant
    per expert input group plus two for the untied pinned head, and runs
    the 96 expert stacks on dequant-fp; a short prompt's prefill launches
    no flash, the long one's 32; (c) packed bytes exactly the policy's
    23,155,703,808 B; (d) a profiled decode step and a profiled 4608-token
    prefill (their launches, busy share and leading kernels printed); (e)
    no host synchronisation inside a decode step; (f) finite logits, two
    equal decode steps bit for bit equal. At 32 layers neither the float32
    tree nor a reference engine fits: at 2 MoE layers, full width (12.6
    GB of float32), the token gates of phase 15 over the same prompts to
    ``WAVE_GEN`` new tokens and slots, and a logit gate on the 256-token
    prompt and the long one over the prefill and 6 decode steps (the long
    one's past the window): the session through every kernel bit for bit
    the same session on the matmuls' plain versions, and the session on
    the dequant-fp matmul route (decode attention, flash and fake-quant
    the kernels) within max(2 x the float32 reference's distance from its
    float64 evaluation, 0.05 x the logits' std) of the float32 reference;
    the all-kernel session's distance is printed beside that of the
    fake-quant graph with float64 sums, which the expert routing takes as
    far from the float32 reference (ROADMAP 3a). Printed: pack seconds,
    the host's MemTotal and MemAvailable, peak device memory, step p50,
    tok/s, prefill p50 of the short prompts and the long one's.
21. cli-large phase: the serve CLI (``launch.serve.main``, as phase 9
    drives it) at full width and depth on the large decoders, each over
    the int8 ring under ``demo_mixed_policy`` with ``--compare``, 4
    slots and a 320-row ring (``--cache-len``), requests of 128 prompt
    tokens (``CLI_LARGE``: 4 requests of 8 new tokens for the dense
    archs; 2 of 4 for deepseek-moe-16b and 2 of 2 for mixtral-8x7b, whose
    steps take ~0.5 and ~1.3 s, cut from 4 of 8 and 4 of 4 for the
    script's time limit):
    deepseek-moe-16b, mixtral-8x7b and granite-20b (52 layers, d_model
    6144, 48 query heads on one kv head, plain-gelu d_ff 24576; 20.32 B
    parameters, 81.3 GB in float32) with ``--site-by-site`` (each site's
    seeded params made on the card by ``lm.site_source`` when the
    session packs it), yi-9b (48 layers, d_model 4096, 32 / 4 heads, d_ff
    11008; 8.83 B parameters, 35.3 GB) whole, through the CLI's fit check
    on ``meta``. Gates for each run: the CLI's own (token-identical with
    the fixed batch, the trace against the stats, a finite calibration);
    every ring kernel launched and no other layout's; no kernel-eligible
    projection on dequant-fp; the decode attention route fused; one
    decode step launches ``decode_attn_quant`` once per layer (28, 32, 52,
    48); packed bytes exactly the policy's (``CLI_LARGE_BYTES``: 7.97,
    23.16, 9.80, 4.15 GB); peak device memory below the card's; for
    deepseek-moe-16b and mixtral-8x7b a checksum of the packed codes,
    scales and activation scales (``packed_checksum``) equal to phase 15's
    and phase 20's sessions' (the same ``lm.site_source`` at seed 0: the
    CLI serves the model those phases hold against their references).
    For yi-9b and granite-20b, which no other phase serves, phase 12's (b)
    at 2 layers and full width over the serve phase's 8 requests
    (``exact_sum_gates``): the all-kernel run token for token the
    plain-matmul run, the dequant-fp run equal on every decisive step to
    the fake-quant reference, the exact-sum runs printed beside it.
    Printed for each arch beside the card: init + pack seconds (from the
    call to ``build_session``'s return), prefill and decode step p50,
    tok/s, peak device memory.
22. per-channel phase (run right after phase 4, on its params and policy):
    Qwen3-0.6B at full width (28 layers) packed with
    ``QuantizedSession(per_channel=True)`` -- statistics scales, ``max|w| /
    qmax`` per output channel, instead of the trained per-tensor bank
    scales -- and served over the 320-row int8 ring: phase 4's first wave,
    4 requests of ``WAVE_GEN`` new tokens, continuous batching, greedy.
    Gates: (a) every packed projection resolves to dequant-fp (the matmul
    kernels' epilogue takes one weight scale; each projection's per-tensor
    twin in phase 4's session is kernel-eligible), ``quant_matmul`` and
    ``quant_matmul_w4`` launched 0 times, ``decode_attn_quant`` 28 times a
    decode step; (b) at every packed site a saturation rate of exactly 0
    and a scale utilization of at most 1 + 1e-6 (the reference's oracle,
    ``tests/test_health.py``); (c) packed code bytes exactly phase 4's
    session's: only the scales differ; (d) greedy tokens equal those of
    the same session run on the kernels' plain versions
    (``ops.plain_on_cuda()``) on every decisive step of it (top-2 margin
    above 1e-2, ``engine.decisive_prefix``). Printed: the scale bytes of
    both sessions, the summed squared dequantization error of both trees
    against the float32 weights, step p50 and tok/s beside phase 4's, and
    one profiled decode step's launches.
23. vision-train phase (run after phase 18): the paper pipeline of phase 3
    on llama-3.2-vision-11b at its published widths (d_model 4096, 32 / 8
    heads of 128, gated-silu d_ff 14336, vocab 128256 untied, 1600 image
    tokens of 1280 from the data module through the 8-bit pinned image
    projection) cut to one unit of its pattern (``VISION_CUT``: 5
    self-attention layers and a gated cross layer, 42 searchable
    projections, 2.36 B parameters), B=1, S=2048, float32, every cross
    gate set to ``VISION_GATE`` before the first step (at the reference's
    init, 0, the cross site's 14 bank leaves get a gradient of exactly 0,
    so no importance step could move them): 2 importance steps, the
    indicators, the ILP, 3 QAT steps, an evaluation batch. Gates (a)-(d)
    of phase 3, with 89 fake-quant launches each way a pass (two per
    projection, the untied head's weight and input, the token table, and
    the image projection's weight and input) and 5 ``flash_fwd`` (the self
    layers; the cross layer attends directly, as in the reference); then
    gate (e) at the same depth, the least that holds a cross layer.
    Printed: importance- and QAT-step ms, tokens/s, launches, the ILP's
    ms, peak device memory, a profiled QAT step.

For the vision phase's time, earlier phases were cut (each named where it
applies): the kernel rows' timed launches (``KERNEL_REPS``, 40 to 20),
the MoE token gates' depth (``MOE_CUT``, 3 to 2 layers), the serve CLI's
fixed-schedule reruns under ``--no-trace`` and ``--chip-table``, and the
MoE speculative phases' new tokens (``WAVE_GEN``, 32 to 16). For the
mixtral phase's: the Qwen3-0.6B speculative phases (6) serve the first
wave to ``WAVE_GEN`` new tokens, as phase 17 does; phase 15's full-depth
run serves the first wave (4 requests of ``WAVE_GEN`` new tokens, which
phase 17 compares), and phase 16's 8 requests take ``WAVE_GEN`` new
tokens; the 2-layer token gates of both keep the 8 requests of ``GEN``
tokens. For phase 21's: its MoE runs serve 2 requests, deepseek-moe-16b's
4 new tokens and mixtral-8x7b's 2 (``CLI_LARGE``). For phases 22 and
23's: the printed comparisons of gate (e) at full depth (phases 7, 14
and 18), of the dequant-fp graph with float64 sums (phases 12 and 21),
and of the prefill logits against the references (phases 4 and 8); the
kernel rows' timed launches (``KERNEL_REPS``, 20 to 10); and the
full-depth runs of phases 12 and 19 and the bundle phase's runs serve
the first wave (4 requests of ``WAVE_GEN`` new tokens).

Every phase's seconds and the script's are printed as ``[time]`` lines.
Any failure exits non-zero. The line before the last is a JSON object with
one entry per kernel; the last is ``{"ok": true, "device": {...}}``. The
per-case numbers also go to ``chiprun_out/chip_smoke.json``.
"""
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and int8 / f32 rates
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12

# (K, N) of the Qwen3-0.6B projections: wq, wk/wv, wo, mlp_wi/wg, mlp_wo
QWEN3_KN = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
            (3072, 1024)]
# (K, N) of the RWKV6-7B projections: the time mix and channel-mix
# receptance, channel-mix key, channel-mix value
RWKV6_KN = [(4096, 4096), (4096, 14336), (14336, 4096)]
# (K, N) of the StarCoder2-7B projections: wq and wo, wk/wv (4 kv heads),
# the MLP's up and down projections
STARCODER2_KN = [(4608, 4608), (4608, 512), (4608, 18432), (18432, 4608)]
# (K, N) of the RecurrentGemma-2B projections: wq, wo and the RG-LRU's wx,
# wgate and wo; wk/wv (one kv head of 256); mlp_wi/wg; mlp_wo
RGEMMA_KN = [(2560, 2560), (2560, 256), (2560, 7680), (7680, 2560)]
# (K, N) of the deepseek-moe-16b projections that take the kernels: wq, wk,
# wv and wo (16 x 128 heads, MHA), the two shared experts' up (2 x 1408)
# and down projections, the dense first layer's MLP up and down
DEEPSEEK_KN = [(2048, 2048), (2048, 2816), (2816, 2048), (2048, 10944),
               (10944, 2048)]
MATMUL_KN = QWEN3_KN + RWKV6_KN + STARCODER2_KN + RGEMMA_KN + DEEPSEEK_KN
MAIN_KN = (1024, 3072)      # the summary row of each matmul: a decode GEMV
PREFILL_M = 128             # the matmuls' prefill rows (M > 16: tensor cores)
MAIN_SC = 320               # the summary row of decode attention: the serve ring
PROMPTS = [256, 128, 224, 160, 192, 144, 240, 176]
GEN, SLOTS, CACHE_LEN, PREFILL_CHUNK = 32, 4, 320, 256
# elastic phases: the bank's average weight-bit budgets, the requests
ELASTIC_BUDGETS, ELASTIC_REQUESTS = "3,4,6", 12
# decode steps (continuous, fixed) of the reference engine over the serve
# CLI's staggered requests at its auto prefill chunk: the port's must equal
# them (tests/test_torch_serve_cli.py holds the two engines together)
REF_CLI_STEPS = {194: (64, 62)}

SOURCES = {
    "quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:117"),
    "quant_matmul_w4": ("src/repro_torch/csrc/quant_matmul.cu",
                        "src/repro/kernels/quant_matmul.py:72"),
    "decode_attn_quant": ("src/repro_torch/csrc/decode_attn_quant.cu",
                          "src/repro/kernels/quant_attention.py:97"),
    "decode_attn_quant_paged": ("src/repro_torch/csrc/decode_attn_quant.cu",
                                "src/repro/kernels/quant_attention.py:217"),
    "fake_quant_fwd": ("src/repro_torch/csrc/fake_quant.cu",
                       "src/repro/kernels/fake_quant.py:51"),
    "fake_quant_bwd": ("src/repro_torch/csrc/fake_quant.cu",
                       "src/repro/kernels/fake_quant.py:73"),
    "flash_fwd": ("src/repro_torch/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:76"),
    "verify_attn_quant": ("src/repro_torch/csrc/decode_attn_quant.cu",
                          "src/repro/kernels/quant_attention.py:299"),
    "verify_attn_quant_paged": ("src/repro_torch/csrc/decode_attn_quant.cu",
                                "src/repro/kernels/quant_attention.py:327"),
    "wkv": ("src/repro_torch/csrc/wkv.cu", "src/repro/kernels/rwkv_scan.py:70"),
}
SERVE_KERNELS = ("quant_matmul", "quant_matmul_w4", "decode_attn_quant",
                 "decode_attn_quant_paged", "verify_attn_quant",
                 "verify_attn_quant_paged")
# the kernels each serving path runs
RING_KERNELS = ("quant_matmul", "quant_matmul_w4", "decode_attn_quant")
PAGED_KERNELS = ("quant_matmul", "quant_matmul_w4", "decode_attn_quant_paged")
# paged serve phase: the first SHARED_PREFIX prompt tokens are the same in
# every request; paged attention cases (page size, rows per slot), summary
# row: the serve phase's pages at its 320 rows
PAGE_SIZE, SHARED_PREFIX = 8, 128
PAGED_CASES = [(8, 320), (16, 320), (8, 4096), (16, 4096)]
PAGED_MAIN = (PAGE_SIZE, MAIN_SC)
TRAIN_KERNELS = ("fake_quant_fwd", "fake_quant_bwd", "flash_fwd")
# speculative phases: draft length, draft width; verify cases (S, G,
# window) on the ring and (page size, rows, S) on pages at G=2, summary
# rows S = K + 1 at the serve shapes
SPEC_K, DRAFT_BITS = 4, 2
VERIFY_CASES = [(S, G, None) for S in (1, 2, 5, 8) for G in (1, 2, 4)] + \
    [(5, 2, 48)]
VERIFY_PAGED_CASES = [(ps, rows, S) for ps, rows in ((3, 96), (8, 320),
                                                     (16, 320), (64, 128))
                      for S in (1, 2, 5, 8)]

# fake-quant: Qwen3-0.6B's (1024, 3072)/(3072, 1024) weights, the (2048,
# 3072) MLP activation at B*S = 2048, the tied (151936, 1024) table, a
# ragged shape, and HuBERT-XLarge's attention and MLP weights and its
# (2048, 5120) MLP activation; summary row: Qwen's activation at 4 bits
FQ_SHAPES = [(1024, 3072), (3072, 1024), (2048, 3072), (151936, 1024),
             (37, 1000), (1280, 1280), (1280, 5120), (2048, 5120)]
FQ_BITS = (2, 4, 6, 8)
FQ_MAIN = ((2048, 3072), 4)
# flash: (S, causal, window, KV, G, hd) at B = 1: Qwen3-0.6B's heads (summary
# row S=2048 causal), then RecurrentGemma-2B's long-prompt prefill (one kv
# head, G = 10, hd 256, its 2048-row local window over 2560 tokens), then
# HuBERT-XLarge's training attention (16 heads of 80, bidirectional), then
# deepseek-moe-16b's (16 heads of 128 on 16 kv heads: odd G at hd 128)
FLASH_CASES = [(2048, True, None, 8, 2, 128), (4096, True, None, 8, 2, 128),
               (2048, True, 512, 8, 2, 128), (2048, False, None, 8, 2, 128),
               (2560, True, 2048, 1, 10, 256), (2048, False, None, 16, 1, 80),
               (2048, True, None, 16, 1, 128)]
FLASH_MAIN = FLASH_CASES[0]
# wkv: (B, S, H, hd, chunk); summary row one 256-token rwkv6-7b prefill;
# tolerance (y and state, atol and rtol): the reference's wkv_pallas
# contract (tests/test_kernels.py)
WKV_CASES = [(1, 256, 64, 64, 32), (1, 2048, 64, 64, 32), (4, 32, 64, 64, 32),
             (2, 96, 4, 16, 16)]
WKV_MAIN, WKV_TOL = WKV_CASES[0], 2e-4
# RWKV serve phase prompts: seven multiples of the wkv chunk, one not
RWKV_PROMPTS = [256, 128, 224, 160, 200, 192, 256, 128]
RWKV_CHUNK = 32
# attention past 8 query heads per kv head: (arch, KV, G, window) of
# StarCoder2-7B (36 / 4 heads; its 4096-row window, which masks no row of
# these caches, and a 48-row window that does) and Granite-20B (48 / 1),
# each beside the Qwen3-0.6B rows (KV 8, G 2) at B = 4, hd 128
WIDE_GQA = [("starcoder2-7b", 4, 9, 4096), ("starcoder2-7b", 4, 9, 48),
            ("granite-20b", 1, 48, None)]
# RecurrentGemma-2B's local attention in decode: (arch, KV, G, window, Sc,
# hd), one kv head, G = 10 (two query groups of 5), hd 256, a ring of its
# 2048-row window, and a 48-row window that masks rows of it
RGEMMA_ATTN = [("recurrentgemma-2b", 1, 10, 2048, 2048, 256),
               ("recurrentgemma-2b", 1, 10, 48, 2048, 256)]
# deepseek-moe-16b's decode attention: MHA, 16 kv heads of 128 with one
# query head each (G = 1), the serve phase's 320-row ring
DEEPSEEK_ATTN = [("deepseek-moe-16b", 16, 1, None, MAIN_SC, 128)]
# the MoE phase: its arch, the depth of its token gates (the dense layer
# and one MoE layer, cut for the script's time limit), and the per-expert fake-quant cases: deepseek's
# (64 experts, 4 tokens a decode step of 4 slots, d_model) expert input,
# and one (64, 2048, 1408) expert weight stack
MOE_ARCH, MOE_CUT = "deepseek-moe-16b", 2
FQ_EXPERT_SHAPES = [(64, 4, 2048), (64, 2048, 1408)]
# the backward with a scale per expert in MoE training: one expert weight
# stack, and the expert input of B*S = 2048 tokens (capacity 256 each)
FQ_EXPERT_BWD_SHAPES = [(64, 2048, 1408), (64, 256, 2048)]
# MoE training at full width: its depth (the dense layer and three MoE
# layers; 28 layers' weights, gradients and AdamW moments take ~262 GB),
# and the depth of its gate (e)
MOE_TRAIN_LAYERS, MOE_TRAIN_CUT = 4, 3
# the new tokens a request of the runs that serve one wave of the 4 slots:
# the speculative phases, the MoE full-depth runs and the mixtral phase
# (cut for the script's time limit)
WAVE_GEN = GEN // 2
# hybrid serve phase: the serve phase's 8 requests and one long one whose
# prefill takes the flash kernel at hd 256 (2560 tokens: a multiple of the
# 512-row q block past the 2048-token threshold, past the window), over
# 4 slots of the 2048-row window; the prefill budget admits it; the token
# gates at one (rec, rec, attn) repeat
HYBRID_LONG, HYBRID_CUT = 2560, 3
# the hybrid's logit gate at its 3-layer cut, as a share of the logits' std:
# one activation code step moves them by ~1e-2 there, the float32 and
# float64 references' own distance when they part (the rest is a last bit)
HYBRID_LOGIT_FLOOR = 0.05
ATTN_KERNELS = ("decode_attn_quant", "decode_attn_quant_paged",
                "verify_attn_quant", "verify_attn_quant_paged", "flash_fwd")
TRAIN_S, IMP_STEPS, QAT_STEPS = 2048, 2, 3
# the audio phase's arch and the depth of its gate (e)
AUDIO_ARCH, AUDIO_CUT = "hubert-xlarge", 2
# kernel launches of one profiled Qwen3-0.6B decode step over the ring and
# over pages, and of one RecurrentGemma-2B, DeepSeek-MoE-16B,
# Llama-3.2-Vision-11B and Mixtral-8x7B step over the ring (as measured on
# the card): one launch per matmul and
# attention call (and, for the MoE step, per expert input's fake-quant), no
# more
DECODE_STEP_LAUNCHES = {"serve": 4707, "paged": 5239, "hybrid": 3548,
                        "moe": 7858, "vision": 7038, "mixtral": 7857}
# the vision phase: its arch, the depth of its token gates (one unit of the
# pattern: 5 self-attention layers and a cross layer), the value every cross
# layer's gate_attn and gate_mlp is set to (the reference inits them to 0,
# and tanh(0) = 0 would hide the image), and its kernel rows: the (K, N) of
# its decode projections on the kernels (wq and wo, wk / wv of the self
# layers at 8 kv heads, mlp_wi / wg, mlp_wo), the image K/V projection
# (n_image_tokens rows, once per admission) and its decode attention (KV 8,
# G 4 over the 320-row ring)
VISION_ARCH, VISION_CUT, VISION_GATE = "llama-3.2-vision-11b", 5, 0.5
VISION_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
VISION_IMG_M, VISION_IMG_KN = 1600, (4096, 1024)
VISION_ATTN = [("llama-3.2-vision-11b", 8, 4, None, MAIN_SC, 128)]
# the mixtral phase: its arch; the depth of its token and logit gates (two
# MoE layers at full width: 12.6 GB of float32, which fits beside two
# reference engines); its long prompt (9 x the 512-row q block, 512 tokens
# past its 4096-row window: its prefill takes the flash kernel with the
# window, its decode wraps the ring) served beside the serve phase's first
# three prompts (one wave of the 4 slots);
# and its kernel rows: decode attention at KV 8, G 4 over a 4096-row ring
# wrapped past its window, flash at the long prompt's prefill, and the
# fake-quant forward with 8 scales at the expert inputs (width 4096, and
# 14336 into the down projection) of a decode step (C = 4) and of the long
# prefill (C = 1536)
MIXTRAL_ARCH, MIXTRAL_CUT, MIXTRAL_LONG = "mixtral-8x7b", 2, 4608
MIXTRAL_SHORT = 3
# the full-depth run's new tokens a request: WAVE_GEN's ~1.5 s decode steps
# took the phase past its budget, so it is cut to 8 (the 2-layer gates
# keep WAVE_GEN)
MIXTRAL_GEN = WAVE_GEN // 2
MIXTRAL_ATTN = [("mixtral-8x7b", 8, 4, 4096, 4096, 128)]
MIXTRAL_FLASH = (MIXTRAL_LONG, True, 4096, 8, 4, 128)
FQ_MIXTRAL_SHAPES = [(8, 4, 4096), (8, 4, 14336), (8, 1536, 4096),
                     (8, 1536, 14336)]
# the cli-large phase: each large decoder through ``serve.main`` at full
# width and depth (arch, --site-by-site, requests of CLI_LARGE_PROMPT
# tokens, new tokens; the MoE runs cut from 4 requests of 8 and 4 for the
# script's time limit: their steps take ~0.5 and ~1.3 s), and
# demo_mixed_policy's packed bytes there (no width needs padding: the
# card packs exactly these)
CLI_LARGE = [("deepseek-moe-16b", True, 2, 4), ("mixtral-8x7b", True, 2, 2),
             ("granite-20b", True, 4, 8), ("yi-9b", False, 4, 8)]
CLI_LARGE_PROMPT = 128
CLI_LARGE_BYTES = {"deepseek-moe-16b": 7_967_162_368,
                   "mixtral-8x7b": 23_155_703_808,
                   "granite-20b": 9_798_942_720, "yi-9b": 4_150_001_664}
SPIN_CYCLES = 2_000_000         # ~1 ms of torch.cuda._sleep at H100 clocks
# event-timed launches of a kernel row (cut for the script's time limit:
# 40, then 20, then 10)
KERNEL_REPS = 10
# gate (e), kernels vs plain versions through one loss_fn + backward at 2
# layers: loss rtol, and per-gradient-leaf relative L2, the reference's ds
# rtol 1e-3 (tests/test_kernels.py:55). It holds only while every quantizer
# code is the same on both sides: a last-bit difference in the flash output
# that lands an activation on the other side of a half-integer of a 2-6-bit
# grid moves the gradients by a few percent. So the flash kernel runs on
# both sides of the pass with activations quantized
TRAIN_TOL = dict(loss_rtol=1e-5, grad_rel=1e-3)
# the HAWQ baseline: Rademacher probes per trace (benchmarks/
# hessian_baseline.py's n_samples), its sequence length at 28 layers (cut
# below the flash threshold: at S = 2048 the double backward through the
# plain flash baseline keeps every block's probabilities and their
# gradients' graph, over the card's 80 GB), and its Hessian-vector product
# against a float64 finite difference at 2 layers and S = 2048: relative L2
HAWQ_SAMPLES, HAWQ_S, HVP_RTOL = 4, 1024, 1e-3


class GateError(RuntimeError):
    pass


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise GateError(what)


def cuda_ms(torch, fn, flush, reps: Optional[int] = None, warmup: int = 5,
            clean: bool = False) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each after an L2
    flush (the serving path reads every weight cold). A spin kernel of
    ~1 ms ahead of each launch lets the host queue the flush, the events and
    ``fn``'s kernels before the device reaches them, so the events time the
    device's work and not the host's launch latency. The flush writes 64 MB,
    which leaves the L2 full of dirty lines that ``fn``'s misses must write
    back first; ``clean`` flushes by reading the 64 MB instead."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps or KERNEL_REPS):
        torch.cuda._sleep(SPIN_CYCLES)
        if clean:
            flush.max()
        else:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sync_ms(torch, t0: float) -> float:
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def attn_work(pos, q_pos, window, table=None):
    """This run's attention work: (rows whose K and V must be read, the
    (query, row) pairs attended). A row counts where its position is
    written, not past the query's and, with a window, inside it; rows
    shared by slots through the page table count once. pos (B, Sc) or,
    paged, (n_pages, ps) through table (B, P); q_pos (B,) or (B, S)."""
    q_pos = np.asarray(q_pos).reshape(len(q_pos), -1)
    if table is None:
        p, rid = pos, np.arange(pos.size).reshape(pos.shape)
    else:
        ps = pos.shape[1]
        t = np.maximum(table, 0)
        p = np.where(table[..., None] >= 0, pos[t], -1).reshape(len(t), -1)
        rid = (t[..., None] * ps + np.arange(ps)).reshape(len(t), -1)
    valid = (p[:, None, :] >= 0) & (p[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        valid &= q_pos[:, :, None] - p[:, None, :] < window
    return len(np.unique(rid[valid.any(1)])), int(valid.sum())


def attn_split(ops, B: int, KV: int, Sc: int, S: int = 1, G: int = 2
               ) -> dict:
    """The attention kernels' split of an Sc-row cache: rows per block (L),
    splits per (slot, kv head, query), query groups (blocks per split,
    each holding at most 8 of the G query rows) and the launch's blocks."""
    L = ops.attn_split_rows(B, KV, Sc)
    n = max(1, -(-Sc // L))
    n_grp = ops.attn_query_groups(G)[0]
    return dict(rows_per_split=L, n_split=n, query_groups=n_grp,
                blocks=B * KV * n * S * n_grp)


def split_str(sp: dict) -> str:
    return (f"L={sp['rows_per_split']} splits={sp['n_split']} "
            f"groups={sp['query_groups']} blocks={sp['blocks']}")


def print_kernel_resources(_build, ops) -> None:
    """Registers and local (spill) bytes per thread as ptxas allocated them,
    shared memory (static and dynamic) and resident blocks per SM, from the
    runtime's function attributes and occupancy calculator, for every
    instance of the kernels redesigned in the last two slices (flash, both
    matmul formats on both routes, wkv). wkv must not spill."""
    import ctypes
    info = (ctypes.c_int * 4)()
    flash = _build.load("flash_attention")
    qmm = _build.load("quant_matmul")
    wkv = _build.load("wkv")
    occ = [(f"flash_fwd_kernel<hd={hd}, heads={gb}, positions={qt}>",
            flash.flash_fwd_occupancy, (hd, gb, qt))
           for hd in (128, 80, 64, 32) for gb, qt in ((2, 64), (1, 128),
                                                      (1, 64))]
    occ.append(("flash_fwd_kernel<hd=256, heads=1, positions=64>",
                flash.flash_fwd_occupancy, (256, 1, 64)))
    for route, fmt in ((0, ""), (2, "w4_")):
        occ += [(f"qmm_{fmt}splitk_kernel<rows={mr}>", qmm.qmm_occupancy,
                 (route, mr)) for mr in ops.QMM_ROWS]
    occ += [("qmm_mma_kernel", qmm.qmm_occupancy, (1, 0)),
            ("qmm_w4_mma_kernel", qmm.qmm_occupancy, (3, 0))]
    occ += [(f"wkv_chunk_kernel<chunk={t}, hd={hd}>", wkv.wkv_occupancy,
             (t, hd)) for t in ops.WKV_CHUNKS for hd in ops.WKV_HEAD_DIMS]
    for name, fn, args in occ:
        gate(fn(*args, ctypes.addressof(info)) == 0,
             f"occupancy query of {name} failed")
        regs, smem, blocks, local = info
        print(f"[resources] {name}: {regs} registers, {local} B local "
              f"(spills), {smem} B shared, {blocks} blocks per SM", flush=True)
        gate(blocks >= 1, f"{name} cannot run a block on an SM")
        gate(local == 0 or not name.startswith("wkv"), f"{name} spills")


def matmul_row(torch, ops, ref, flush, dev, w4: bool, M: int, K: int,
               N: int) -> dict:
    """One matmul kernel (``w4``: the nib4 one) at (M, K, N) on seeded codes:
    bit for bit its plain version, then timed beside it and, for int8,
    ``torch._int_mm``; the plain version runs fewer timed reps at the
    shapes of 2**24 weights or more."""
    name = "quant_matmul_w4" if w4 else "quant_matmul"
    g = torch.Generator(device=dev).manual_seed(K * 31 + N + M)
    x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    if w4:
        w = torch.randint(0, 256, (K // 2, N), generator=g, device=dev,
                          dtype=torch.uint8)
    else:
        w = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                          dtype=torch.int8)
    s_x = torch.tensor(0.0173, device=dev)
    s_w = torch.tensor([0.0391], device=dev)
    kern = ops.quant_matmul_w4 if w4 else ops.quant_matmul
    plain = ref.quant_matmul_w4_ref if w4 else ref.quant_matmul_ref
    out = kern(x, w, s_x, s_w)
    want = plain(x, w, s_x, s_w)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    gate(torch.equal(out, want),
         f"{name} M={M} K={K} N={N} differs from its plain version (max "
         f"|err| {err})")
    lib_ms = None
    if not w4:
        # torch._int_mm takes M > 16 only: the decode shape is timed with x
        # zero-padded to 32 rows
        xm = x if M > 16 else torch.cat([x, x.new_zeros((32 - M, K))])
        lib_ms = cuda_ms(torch, lambda: torch._int_mm(xm, w), flush)
    n_bytes = M * K + w.numel() + 8 + M * N * 4
    b_ms, b_by = bound_ms(n_bytes, 2.0 * M * K * N, INT8_OPS_PER_S)
    # the decode rows of the two serve shapes also after a flush that
    # leaves the L2 clean
    clean_ms = cuda_ms(torch, lambda: kern(x, w, s_x, s_w), flush,
                       clean=True) \
        if M == 4 and (K, N) in (MAIN_KN, RWKV6_KN[1]) else None
    row = dict(
        name=name, shape=f"M={M} K={K} N={N}", max_abs_err=err,
        clean_l2_ms=clean_ms,
        ms=cuda_ms(torch, lambda: kern(x, w, s_x, s_w), flush),
        plain_ms=cuda_ms(torch, lambda: plain(x, w, s_x, s_w), flush),
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        main=(M == 4 and (K, N) == MAIN_KN))
    print(f"[kernel] {name:16s} M={M:<3d} K={K:<4d} N={N:<4d} "
          f"err={err:.1e} ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
          f"lib={lib_ms if lib_ms is None else round(lib_ms, 4)} "
          f"bound={b_ms:.4f}({b_by})"
          + ("" if clean_ms is None else f" clean-L2={clean_ms:.4f}"),
          flush=True)
    return row


def matmul_phase(torch, ops, ref, flush, dev):
    """Both matmul kernels at M = 4 (decode: ``qmm_int8``'s split-K route)
    and M = 128 (prefill: its tensor-core route) over the Qwen3-0.6B,
    RWKV6-7B, StarCoder2-7B and RecurrentGemma-2B projection shapes, bit
    for bit their plain versions; the plain versions run fewer timed reps
    at the shapes of 2**24 weights or more."""
    rows = [matmul_row(torch, ops, ref, flush, dev, w4, M, K, N)
            for w4 in (False, True) for M in (4, PREFILL_M)
            for K, N in MATMUL_KN]
    # the nib4 kernel beside the int8 one at each (M, K, N) of this run
    by_shape = {(r["name"], r["shape"]): r for r in rows}
    not_slower = 0
    for M in (4, PREFILL_M):
        for K, N in MATMUL_KN:
            sh = f"M={M} K={K} N={N}"
            w4_ms = by_shape[("quant_matmul_w4", sh)]["ms"]
            i8_ms = by_shape[("quant_matmul", sh)]["ms"]
            not_slower += w4_ms <= i8_ms
            print(f"[kernel] qmm_w4 vs qmm_int8 {sh}: {w4_ms:.4f} / "
                  f"{i8_ms:.4f} ms (x{w4_ms / i8_ms:.2f})", flush=True)
    print(f"[kernel] qmm_w4 no slower than qmm_int8 at {not_slower} of "
          f"{2 * len(MATMUL_KN)} shapes", flush=True)
    tiny = torch.empty(1024, device=dev)
    floor = cuda_ms(torch, tiny.zero_, flush)
    print(f"[kernel] timing floor: one 4 KB fill kernel {floor:.4f} ms under "
          f"the same events and flush", flush=True)
    for r in rows:
        if r["name"] == "quant_matmul" and r["shape"] == (
                f"M={PREFILL_M} K={MAIN_KN[0]} N={MAIN_KN[1]}"):
            print(f"[kernel] quant_matmul prefill row {r['shape']}: "
                  f"ms={r['ms']:.4f} beside torch._int_mm "
                  f"{r['library_ms']:.4f}", flush=True)
    return rows


def attn_phase(torch, ops, ref, flush, dev):
    cases = [("qwen3-0.6b", 8, 2, None, Sc, 128) for Sc in (320, 4096)] + \
        [(arch, KV, G, w, Sc, 128) for arch, KV, G, w in WIDE_GQA
         for Sc in (320, 4096)] + RGEMMA_ATTN + DEEPSEEK_ATTN
    return [decode_attn_row(torch, ops, ref, flush, dev, *c) for c in cases]


def decode_attn_row(torch, ops, ref, flush, dev, arch, KV, G, window, Sc,
                    hd) -> dict:
    """``decode_attn_quant`` at B = 4 over a wrapped Sc-row int8 ring with
    evicted rows: within rtol 2e-5 / atol 2e-6 of its plain version, bit
    for bit a launch on q pre-scaled on the card, timed beside the plain
    version and SDPA on the dequantized cache."""
    import torch.nn.functional as F
    B = 4
    H = KV * G
    r = np.random.default_rng(Sc + (G if G > 2 else 0))
    q_pos = np.array([Sc + 37, Sc - 1, Sc // 2, 3 * Sc], np.int32)
    pos = np.full((B, Sc), -1, np.int32)
    for b in range(B):                     # wrapped ring: slot t % Sc
        for t in range(max(0, q_pos[b] + 1 - Sc), q_pos[b] + 1):
            pos[b, t % Sc] = t
    pos[1, r.integers(0, Sc, Sc // 5)] = -1          # evicted slots
    g = torch.Generator(device=dev).manual_seed(
        Sc + (G if G > 2 else 0))
    kc = torch.randint(-127, 128, (B, Sc, KV, hd), generator=g,
                       device=dev, dtype=torch.int8)
    vc = torch.randint(-127, 128, (B, Sc, KV, hd), generator=g,
                       device=dev, dtype=torch.int8)
    ks = torch.rand((B, Sc, KV), generator=g, device=dev) * 0.02 + 1e-3
    vs = torch.rand((B, Sc, KV), generator=g, device=dev) * 0.02 + 1e-3
    q = torch.randn((B, 1, H, hd), generator=g, device=dev)
    pos_t = torch.from_numpy(pos).to(dev)
    qp = torch.from_numpy(q_pos).to(dev)
    args = (q, kc, ks, vc, vs, pos_t, qp)
    out = ops.decode_attn_quant(*args, window=window)
    tag = f"{arch} Sc={Sc} KV={KV} G={G} window={window} hd={hd}"

    def plain():
        qf = q.reshape(B, KV, G, hd) * (hd ** -0.5)
        return ref.decode_attn_quant_ref(qf, kc, ks, vc, vs, pos_t, qp,
                                         window)

    want = plain().reshape(out.shape)
    # the kernel's own q * hd**-0.5 gives the bits of the pre-scale the
    # wrapper launched before: a launch on the pre-scaled q with scale 1
    prescaled = ops._quant_attn("decode_attn_quant", q * (hd ** -0.5),
                                kc, ks, vc, vs, pos_t, qp, None, window,
                                q_scale=1.0)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    gate(bool(torch.allclose(out, want, rtol=2e-5, atol=2e-6)),
         f"decode_attn_quant {tag} differs from its plain version "
         f"(max |err| {err})")
    gate(bool(torch.equal(out, prescaled)),
         f"decode_attn_quant {tag}: the in-kernel q scale differs from "
         "the pre-scaled launch")
    # yardstick: SDPA on the dequantized cache under the same mask
    kd = (kc.float() * ks[..., None]).permute(0, 2, 1, 3).contiguous()
    vd = (vc.float() * vs[..., None]).permute(0, 2, 1, 3).contiguous()
    valid = (pos_t >= 0) & (pos_t <= qp[:, None])
    if window is not None:
        valid &= qp[:, None] - pos_t < window
    mask = valid[:, None, None, :]
    qh = q.permute(0, 2, 1, 3).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qh, kd, vd, attn_mask=mask,
                                              enable_gqa=True)

    lib = sdpa().permute(0, 2, 1, 3)
    gate(bool(torch.allclose(lib, out, rtol=1e-3, atol=1e-4)),
         "SDPA yardstick disagrees with the kernel")
    # this run's work: positions read in full, then only the rows that
    # each slot's query position and window admit
    n_rows, att = attn_work(pos, q_pos, window)
    n_bytes = (B * Sc * 4 + n_rows * (2 * KV * hd + 2 * KV * 4)
               + B * H * hd * 4 + B * 4 + B * H * hd * 4)
    b_ms, b_by = bound_ms(n_bytes, 4.0 * H * hd * att, F32_OPS_PER_S)
    row = dict(
        name="decode_attn_quant", shape=f"B={B} {tag}",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.decode_attn_quant(
            *args, window=window), flush),
        plain_ms=cuda_ms(torch, plain, flush),
        library_ms=cuda_ms(torch, sdpa, flush), bound_ms=b_ms,
        bound_by=b_by, main=Sc == MAIN_SC and G == 2,
        q_scale_bitwise=True, split=attn_split(ops, B, KV, Sc, G=G))
    print(f"[kernel] decode_attn_quant {tag} err={err:.1e} "
          f"{split_str(row['split'])} "
          f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
          f"sdpa={row['library_ms']:.4f} bound={b_ms:.4f}({b_by})",
          flush=True)
    return row


def _paged_pool(r, B, P, ps):
    """(page table (B, P), pos (n_pages, ps), query positions) of a pool
    with page ids permuted at random: slot 1 maps slot 0's first P // 4
    pages too, slot 2 has an unmapped (-1) entry inside its row, slot 3
    its last P // 8 entries unmapped and query position -1; each slot's
    rows are written up to a position of its own and a fifth of slot 1's
    rows are evicted (pos -1)."""
    rows = P * ps
    n_pages = B * P + 7
    perm = list(r.permutation(n_pages))
    table = np.full((B, P), -1, np.int32)
    for b in range(B):
        for j in range(P):
            table[b, j] = table[0, j] if (b == 1 and j < P // 4) else perm.pop()
    table[2, P // 2] = -1
    table[3, P - max(1, P // 8):] = -1
    written = [rows, rows - 37, rows // 2 + 5, rows // 3]
    q_pos = np.array([rows - 1, rows - 40, rows // 2, -1], np.int32)
    pos = np.full((n_pages, ps), -1, np.int32)
    for b in range(B):
        t = np.arange(written[b])
        pid = table[b, t // ps]
        pos[pid[pid >= 0], (t % ps)[pid >= 0]] = t[pid >= 0]
    t = r.integers(0, written[1], rows // 5)
    pid = table[1, t // ps]
    pos[pid[pid >= 0], (t % ps)[pid >= 0]] = -1
    return table, pos, q_pos


def paged_attn_phase(torch, ops, ref, flush, dev):
    import torch.nn.functional as F
    from repro_torch.runtime.kv_cache import PagedKVCache
    rows_out = []
    B, hd = 4, 128
    cases = [("qwen3-0.6b", 8, 2, None, ps, rows) for ps, rows in PAGED_CASES] \
        + [(arch, KV, G, w) + PAGED_MAIN for arch, KV, G, w in WIDE_GQA]
    for arch, KV, G, window, ps, rows in cases:
        H = KV * G
        P = rows // ps
        seed = rows + ps + (G if G > 2 else 0)
        r = np.random.default_rng(seed)
        table, pos, q_pos = _paged_pool(r, B, P, ps)
        n_pages = pos.shape[0]
        g = torch.Generator(device=dev).manual_seed(seed)
        kp = torch.randint(-127, 128, (n_pages, ps, KV, hd), generator=g,
                           device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, (n_pages, ps, KV, hd), generator=g,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((n_pages, ps, KV), generator=g, device=dev) * 0.02 + 1e-3
        vs = torch.rand((n_pages, ps, KV), generator=g, device=dev) * 0.02 + 1e-3
        q = torch.randn((B, 1, H, hd), generator=g, device=dev)
        pos_t = torch.from_numpy(pos).to(dev)
        tbl = torch.from_numpy(table).to(dev)
        qp = torch.from_numpy(q_pos).to(dev)
        args = (q, kp, ks, vp, vs, pos_t, tbl, qp)
        out = ops.decode_attn_quant_paged(*args, window=window)

        def plain():
            qf = q.reshape(B, KV, G, hd) * (hd ** -0.5)
            return ref.decode_attn_quant_paged_ref(qf, kp, ks, vp, vs, pos_t,
                                                   tbl, qp, window)

        want = plain().reshape(out.shape)
        # the ring kernel on the dense view PagedKVCache.gather() builds
        dense = PagedKVCache(kp, vp, ks, vs, pos_t, tbl).gather()
        ring = ops.decode_attn_quant(q, dense.k.contiguous(),
                                     dense.k_scale.contiguous(),
                                     dense.v.contiguous(),
                                     dense.v_scale.contiguous(),
                                     dense.pos.contiguous(), qp,
                                     window=window)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        tag = (f"ps={ps} rows={rows}" if G == 2 else
               f"{arch} ps={ps} rows={rows} KV={KV} G={G} window={window}")
        gate(bool(torch.allclose(out, want, rtol=2e-5, atol=2e-6)),
             f"decode_attn_quant_paged {tag} differs from its plain version "
             f"(max |err| {err})")
        bitwise = bool(torch.equal(out, ring))
        gate(bitwise,
             f"decode_attn_quant_paged {tag} differs from the ring kernel on "
             "the gathered view")
        # yardstick: SDPA on the dequantized gathered cache under the same
        # mask; the gather and dequantization stay outside the timed call
        kd = (dense.k.float() * dense.k_scale[..., None]).permute(0, 2, 1, 3) \
            .contiguous()
        vd = (dense.v.float() * dense.v_scale[..., None]).permute(0, 2, 1, 3) \
            .contiguous()
        valid = (dense.pos >= 0) & (dense.pos <= qp[:, None])
        if window is not None:
            valid &= qp[:, None] - dense.pos < window
        mask = valid[:, None, None, :]
        qh = q.permute(0, 2, 1, 3).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(qh, kd, vd, attn_mask=mask,
                                                  enable_gqa=True)

        live = q_pos >= 0
        lib = sdpa().permute(0, 2, 1, 3)
        gate(bool(torch.allclose(lib[live], out[live], rtol=1e-3, atol=1e-4)),
             f"SDPA yardstick disagrees with decode_attn_quant_paged {tag}")
        # this run's work: the table and the mapped pages' positions read
        # in full, then each row admitted by some slot's query position and
        # window once
        n_unique = len(np.unique(table[table >= 0]))
        n_rows, att = attn_work(pos, q_pos, window, table)
        n_bytes = (table.size * 4 + n_unique * ps * 4
                   + n_rows * (2 * KV * hd + 2 * KV * 4)
                   + 2 * B * H * hd * 4 + B * 4)
        b_ms, b_by = bound_ms(n_bytes, 4.0 * H * hd * att, F32_OPS_PER_S)
        rows_out.append(dict(
            name="decode_attn_quant_paged", shape=f"B={B} P={P} {tag} "
            f"KV={KV} G={G} hd={hd}", max_abs_err=err,
            equals_ring_kernel_on_gathered_view=bitwise,
            ms=cuda_ms(torch, lambda: ops.decode_attn_quant_paged(
                *args, window=window), flush),
            plain_ms=cuda_ms(torch, plain, flush),
            library_ms=cuda_ms(torch, sdpa, flush), bound_ms=b_ms,
            bound_by=b_by, main=(ps, rows) == PAGED_MAIN and G == 2,
            split=attn_split(ops, B, KV, rows, G=G)))
        print(f"[kernel] decode_attn_quant_paged {tag:16s} err={err:.1e} "
              f"ring-kernel-on-gathered-view bitwise={bitwise} "
              f"{split_str(rows_out[-1]['split'])} "
              f"ms={rows_out[-1]['ms']:.4f} "
              f"plain={rows_out[-1]['plain_ms']:.4f} "
              f"sdpa={rows_out[-1]['library_ms']:.4f} "
              f"bound={b_ms:.4f}({b_by})", flush=True)
    return rows_out


def _verify_pos(q_pos, S):
    """(B, S) verify positions ending at each slot's one-token query
    position (a -1 slot stays -1)."""
    return np.where(q_pos[:, None] < 0, -1,
                    np.maximum(q_pos[:, None] - (S - 1) + np.arange(S), 0)
                    ).astype(np.int32)


def verify_attn_phase(torch, ops, ref, flush, dev):
    """The S-query verify kernels: against their plain versions and, bit for
    bit, against S launches of the one-token kernels; timed at S = K + 1 on
    the serve shapes."""
    import torch.nn.functional as F
    from repro_torch.runtime.kv_cache import PagedKVCache
    rows_out = []
    B, hd, Sc = 4, 128, MAIN_SC
    cases = [("ring", S, G, w, None, 8, None) for S, G, w in VERIFY_CASES] + \
        [("paged", S, 2, None, (ps, rows), 8, None) for ps, rows, S in
         VERIFY_PAGED_CASES] + \
        [(kind, SPEC_K + 1, G, w, PAGED_MAIN if kind == "paged" else None,
          KV, arch) for arch, KV, G, w in WIDE_GQA
         for kind in ("ring", "paged")]
    for kind, S, G, window, pr, KV, arch in cases:
        H = KV * G
        r = np.random.default_rng(S * 100 + G * 10 + (window or 0)
                                  + (pr[0] * 7 + pr[1] if pr else 0))
        g = torch.Generator(device=dev).manual_seed(int(r.integers(1 << 30)))
        paged = kind == "paged"
        if paged:
            ps, rows = pr
            table, pos, q_pos = _paged_pool(r, B, rows // ps, ps)
            shape = (pos.shape[0], ps, KV)
        else:
            q_pos = np.array([Sc + 37, Sc - 1, Sc // 2, -1], np.int32)
            pos = np.full((B, Sc), -1, np.int32)
            for b in range(B):
                for t in range(max(0, q_pos[b] + 1 - Sc), q_pos[b] + 1):
                    pos[b, t % Sc] = t
            pos[1, r.integers(0, Sc, Sc // 5)] = -1
            shape = (B, Sc, KV)
        kc = torch.randint(-127, 128, shape + (hd,), generator=g, device=dev,
                           dtype=torch.int8)
        vc = torch.randint(-127, 128, shape + (hd,), generator=g, device=dev,
                           dtype=torch.int8)
        ks = torch.rand(shape, generator=g, device=dev) * 0.02 + 1e-3
        vs = torch.rand(shape, generator=g, device=dev) * 0.02 + 1e-3
        q = torch.randn((B, S, H, hd), generator=g, device=dev)
        pos_t = torch.from_numpy(pos).to(dev)
        qp = torch.from_numpy(_verify_pos(q_pos, S)).to(dev)
        tbl = (torch.from_numpy(table).to(dev),) if paged else ()
        cache = (kc, ks, vc, vs, pos_t) + tbl
        kern = ops.verify_attn_quant_paged if paged else ops.verify_attn_quant
        one = ops.decode_attn_quant_paged if paged else ops.decode_attn_quant
        plain_fn = ref.verify_attn_quant_paged_ref if paged \
            else ref.verify_attn_quant_ref
        out = kern(q, *cache, qp, window=window)
        qs = [q[:, j:j + 1].contiguous() for j in range(S)]
        qps = [qp[:, j].contiguous() for j in range(S)]

        def unrolled():
            return [one(qs[j], *cache, qps[j], window=window)
                    for j in range(S)]

        def plain():
            qf = q.reshape(B, S, KV, G, hd) * (hd ** -0.5)
            return plain_fn(qf, *cache, qp, window)

        want = plain().reshape(out.shape)
        ones = unrolled()
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        tag = ((f"{arch} " if arch else "")
               + f"{kind} S={S} G={G} window={window}"
               + (f" ps={pr[0]} rows={pr[1]}" if paged else f" Sc={Sc}"))
        gate(bool(torch.allclose(out, want, rtol=2e-5, atol=2e-6)),
             f"verify {tag} differs from its plain version (max |err| {err})")
        gate(all(torch.equal(out[:, j:j + 1], ones[j]) for j in range(S)),
             f"verify {tag} differs from {S} one-token launches")
        main = (S == SPEC_K + 1 and G == 2 and window is None
                and (pr == PAGED_MAIN if paged else True))
        row = dict(name=kern.__name__, shape=f"B={B} {tag} KV={KV} hd={hd}",
                   max_abs_err=err, equals_one_token_launches=True,
                   main=main, split=attn_split(ops, B, KV,
                                               pr[1] if paged else Sc, S,
                                               G=G))
        if main or arch:
            # this run's work: positions (and the table) read in full, the
            # rows some query admits once, q and out; each query attends the
            # rows its position and the window admit
            vpos = _verify_pos(q_pos, S)
            if paged:
                n_rows, att = attn_work(pos, vpos, window, table)
                n_pos = len(np.unique(table[table >= 0])) * pr[0]
                dense = PagedKVCache(kc, vc, ks, vs, pos_t, tbl[0]).gather()
                kd_, vd_, ks_, vs_, p_ = (dense.k, dense.v, dense.k_scale,
                                          dense.v_scale, dense.pos)
            else:
                n_rows, att = attn_work(pos, vpos, window)
                n_pos = B * Sc
                kd_, vd_, ks_, vs_, p_ = kc, vc, ks, vs, pos_t
            n_bytes = (n_pos * 4 + n_rows * (2 * KV * hd + 2 * KV * 4)
                       + (table.size * 4 if paged else 0)
                       + 2 * B * S * H * hd * 4 + B * S * 4)
            b_ms, b_by = bound_ms(n_bytes, 4.0 * H * hd * att,
                                  F32_OPS_PER_S)
            # yardstick: SDPA on the dequantized (gathered) cache with a
            # per-query mask; dequantization stays outside the timed call
            kd = (kd_.float() * ks_[..., None]).permute(0, 2, 1, 3).contiguous()
            vd = (vd_.float() * vs_[..., None]).permute(0, 2, 1, 3).contiguous()
            valid = (p_[:, None, :] >= 0) & (p_[:, None, :] <= qp[:, :, None])
            if window is not None:
                valid &= qp[:, :, None] - p_[:, None, :] < window
            mask = valid[:, None]
            qh = q.permute(0, 2, 1, 3).contiguous()

            def sdpa():
                return F.scaled_dot_product_attention(
                    qh, kd, vd, attn_mask=mask, enable_gqa=True)

            live = q_pos >= 0
            lib = sdpa().permute(0, 2, 1, 3)
            gate(bool(torch.allclose(lib[live], out[live], rtol=1e-3,
                                     atol=1e-4)),
                 f"SDPA yardstick disagrees with verify {tag}")
            row.update(
                ms=cuda_ms(torch, lambda: kern(q, *cache, qp, window=window),
                           flush),
                one_token_launches_ms=cuda_ms(torch, unrolled, flush),
                plain_ms=cuda_ms(torch, plain, flush),
                library_ms=cuda_ms(torch, sdpa, flush), bound_ms=b_ms,
                bound_by=b_by)
            print(f"[kernel] {kern.__name__} {tag} err={err:.1e} "
                  f"= {S} one-token launches bit for bit; "
                  f"{split_str(row['split'])} "
                  f"ms={row['ms']:.4f} ({S} one-token launches "
                  f"{row['one_token_launches_ms']:.4f}) "
                  f"plain={row['plain_ms']:.4f} "
                  f"sdpa={row['library_ms']:.4f} bound={b_ms:.5f}({b_by})",
                  flush=True)
        rows_out.append(row)
    print(f"[kernel] verify: {len(cases)} cases, each within rtol 2e-5 / "
          "atol 2e-6 of its plain version and bit for bit S one-token "
          "launches", flush=True)
    return rows_out


def _ds_terms_abs(torch, v, s, g, qmin, qmax):
    """sum |g * dsd| of the LSQ ds sum: the scale of its float32 rounding."""
    vs = v / torch.clamp(s, min=1e-9)
    inside = (vs > qmin) & (vs < qmax)
    c = torch.clamp(vs, qmin, qmax)
    return float((g * torch.where(inside, torch.round(c) - vs, c)).abs()
                 .double().sum())


def fake_quant_phase(torch, ops, ref, flush, dev):
    rows = []
    for shape in FQ_SHAPES:
        g_ = torch.Generator(device=dev).manual_seed(shape[0] * 7 + shape[1])
        v = torch.randn(shape, generator=g_, device=dev) * 0.05
        g = torch.randn(shape, generator=g_, device=dev)
        for bits in FQ_BITS:
            qmin, qmax = float(-2 ** (bits - 1)), float(2 ** (bits - 1) - 1)
            s = (2 * v.abs().mean() / qmax ** 0.5).reshape(1)  # LSQ init
            out = ops.fake_quant_fwd(v, s, qmin, qmax)
            want = ref.fake_quant_ref(v, s.reshape(()), qmin, qmax)
            dv, ds = ops.fake_quant_bwd(v, s, g, qmin, qmax)
            dv_p, ds_p = ref.fake_quant_grads_ref(v, s.reshape(()), g, qmin,
                                                  qmax)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            gate(torch.equal(out, want), f"fake_quant_fwd {shape} {bits}b "
                 f"differs from its plain version (max |err| {err})")
            gate(torch.equal(dv, dv_p), f"fake_quant_bwd {shape} {bits}b: dv "
                 f"differs (max |err| {float((dv - dv_p).abs().max())})")
            ds_err = abs(float(ds) - float(ds_p))
            ds_tol = (1e-4 * abs(float(ds_p))
                      + 1e-6 * _ds_terms_abs(torch, v, s, g, qmin, qmax))
            gate(ds_err <= ds_tol, f"fake_quant_bwd {shape} {bits}b: ds "
                 f"{float(ds)} vs plain {float(ds_p)} (tol {ds_tol})")
            main = (shape, bits) == FQ_MAIN
            if bits != 4:
                rows.append(dict(name="fake_quant_fwd", shape=f"{shape} {bits}b",
                                 max_abs_err=err, main=False))
                rows.append(dict(name="fake_quant_bwd", shape=f"{shape} {bits}b",
                                 max_abs_err=ds_err, main=False))
                continue
            n = v.numel()
            # library yardstick: PyTorch's learnable per-tensor fake-quant
            # (same integer grid; it multiplies by a reciprocal, so times
            # only)
            lib_f = lib_b = None
            if hasattr(torch, "_fake_quantize_learnable_per_tensor_affine"):
                zp = torch.zeros(1, device=dev)
                vl = v.clone().requires_grad_(True)
                sl = s.clone().requires_grad_(True)

                def lib_fwd():
                    return torch._fake_quantize_learnable_per_tensor_affine(
                        v, s, zp, int(qmin), int(qmax), 1.0)

                def lib_fwd_bwd():
                    o = torch._fake_quantize_learnable_per_tensor_affine(
                        vl, sl, zp, int(qmin), int(qmax), 1.0)
                    return torch.autograd.grad(o, (vl, sl), g)

                lib_f, lib_b = (cuda_ms(torch, lib_fwd, flush),
                                cuda_ms(torch, lib_fwd_bwd, flush))
            b_f = bound_ms(8.0 * n + 4, 5.0 * n, F32_OPS_PER_S)
            b_b = bound_ms(12.0 * n + 8, 10.0 * n, F32_OPS_PER_S)
            for name, kern, plain, lib, (b_ms, b_by), e in (
                    ("fake_quant_fwd",
                     lambda: ops.fake_quant_fwd(v, s, qmin, qmax),
                     lambda: ref.fake_quant_ref(v, s.reshape(()), qmin, qmax),
                     lib_f, b_f, err),
                    ("fake_quant_bwd",
                     lambda: ops.fake_quant_bwd(v, s, g, qmin, qmax),
                     lambda: ref.fake_quant_grads_ref(v, s.reshape(()), g,
                                                      qmin, qmax),
                     lib_b, b_b, ds_err)):
                rows.append(dict(
                    name=name, shape=f"{shape} {bits}b", max_abs_err=e,
                    ms=cuda_ms(torch, kern, flush),
                    plain_ms=cuda_ms(torch, plain, flush), library_ms=lib,
                    bound_ms=b_ms, bound_by=b_by, main=main))
                print(f"[kernel] {name:15s} {str(shape):14s} {bits}b "
                      f"err={e:.1e} ms={rows[-1]['ms']:.4f} "
                      f"plain={rows[-1]['plain_ms']:.4f} "
                      f"lib={lib if lib is None else round(lib, 4)} "
                      f"bound={b_ms:.4f}({b_by})", flush=True)
    print(f"[kernel] fake_quant: {len(FQ_SHAPES) * len(FQ_BITS)} cases, "
          "forward and dv bit for bit, ds within tolerance", flush=True)
    return rows + fake_quant_expert_rows(torch, ops, ref, flush, dev)


def fake_quant_expert_rows(torch, ops, ref, flush, dev):
    """``fake_quant_fwd`` with a scale per expert (64 scales in the (64, 1,
    1) form, each over its expert's slice) at deepseek-moe-16b's decode
    expert input and one expert weight stack, bit for bit its plain
    version at every width, and with one scale at the same shapes (the
    kernel as before); timed at 4 bits beside PyTorch's learnable
    per-channel fake-quant over the expert axis (times only: it multiplies
    by a reciprocal)."""
    return [r for shape in FQ_EXPERT_SHAPES
            for r in fake_quant_expert_row(torch, ops, ref, flush, dev,
                                           shape)] \
        + fake_quant_expert_bwd_rows(torch, ops, ref, flush, dev)


def fake_quant_expert_row(torch, ops, ref, flush, dev, shape):
    """``fake_quant_fwd`` at ``shape`` with a scale per leading slice and
    with one scale, every width bit for bit its plain version; the 4-bit
    row timed (``fake_quant_expert_rows``)."""
    rows = []
    E = shape[0]
    g_ = torch.Generator(device=dev).manual_seed(shape[1] * 7 + E)
    v = torch.randn(shape, generator=g_, device=dev) * 0.05
    spread = torch.rand((E, 1, 1), generator=g_, device=dev) + 0.5
    for bits in FQ_BITS:
        qmin, qmax = float(-2 ** (bits - 1)), float(2 ** (bits - 1) - 1)
        one = (2 * v.abs().mean() / qmax ** 0.5).reshape(1)
        s = (one * spread).contiguous()             # (E, 1, 1)
        for label, sc in ((f"{E} scales", s), ("one scale", one)):
            out = ops.fake_quant_fwd(v, sc, qmin, qmax)
            want = ref.fake_quant_ref(v, sc, qmin, qmax)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            gate(torch.equal(out, want),
                 f"fake_quant_fwd {shape} {bits}b {label} differs from "
                 f"its plain version (max |err| {err})")
        if bits != 4:
            rows.append(dict(name="fake_quant_fwd",
                             shape=f"{shape} {bits}b, {E} scales",
                             max_abs_err=err, main=False))
            continue
        n = v.numel()
        zp = torch.zeros(E, device=dev)
        v2, s1 = v.reshape(E, -1), s.reshape(E)

        def lib():
            return torch._fake_quantize_learnable_per_channel_affine(
                v2, s1, zp, 0, int(qmin), int(qmax), 1.0)

        b_ms, b_by = bound_ms(8.0 * n + 4.0 * E, 5.0 * n, F32_OPS_PER_S)
        rows.append(dict(
            name="fake_quant_fwd", shape=f"{shape} {bits}b, {E} scales",
            max_abs_err=err,
            ms=cuda_ms(torch, lambda: ops.fake_quant_fwd(v, s, qmin,
                                                          qmax), flush),
            one_scale_ms=cuda_ms(torch, lambda: ops.fake_quant_fwd(
                v, one, qmin, qmax), flush),
            plain_ms=cuda_ms(torch, lambda: ref.fake_quant_ref(
                v, s, qmin, qmax), flush),
            library_ms=cuda_ms(torch, lib, flush), bound_ms=b_ms,
            bound_by=b_by, main=False))
        r = rows[-1]
        print(f"[kernel] fake_quant_fwd  {str(shape):16s} {bits}b, {E} "
              f"scales: err={err:.1e} ms={r['ms']:.4f} (one scale "
              f"{r['one_scale_ms']:.4f}) plain={r['plain_ms']:.4f} "
              f"lib={r['library_ms']:.4f} bound={b_ms:.4f}({b_by})",
              flush=True)
    return rows


def fake_quant_expert_bwd_rows(torch, ops, ref, flush, dev):
    """``fake_quant_bwd`` with a scale per expert at MoE training's shapes
    (``FQ_EXPERT_BWD_SHAPES``): at every width dv bit for bit its plain
    version and each expert's ds within 1e-4 of |ds| plus 1e-6 of that
    expert's sum |g * dsd|; at one scale the kernel as before; timed at 4
    bits beside PyTorch's learnable per-channel fake-quant, forward and
    backward, over the expert axis (its forward is the only way to its
    backward)."""
    rows = []
    for shape in FQ_EXPERT_BWD_SHAPES:
        E = shape[0]
        g_ = torch.Generator(device=dev).manual_seed(shape[1] * 11 + E)
        v = torch.randn(shape, generator=g_, device=dev) * 0.05
        g = 1 + 0.5 * torch.randn(shape, generator=g_, device=dev)
        spread = torch.rand((E, 1, 1), generator=g_, device=dev) + 0.5
        for bits in FQ_BITS:
            qmin, qmax = float(-2 ** (bits - 1)), float(2 ** (bits - 1) - 1)
            one = (2 * v.abs().mean() / qmax ** 0.5).reshape(1)
            s = (one * spread).contiguous()             # (E, 1, 1)
            dv, ds = ops.fake_quant_bwd(v, s, g, qmin, qmax)
            dv_p, ds_p = ref.fake_quant_grads_ref(v, s, g, qmin, qmax)
            dv1, ds1 = ops.fake_quant_bwd(v, one, g, qmin, qmax)
            dv1_p, ds1_p = ref.fake_quant_grads_ref(v, one, g, qmin, qmax)
            torch.cuda.synchronize()
            tol = torch.tensor([
                1e-4 * abs(float(ds_p[e])) + 1e-6 * _ds_terms_abs(
                    torch, v[e], s[e], g[e], qmin, qmax) for e in range(E)],
                device=dev)
            err = float((ds - ds_p).abs().max())
            gate(torch.equal(dv, dv_p) and torch.equal(dv1, dv1_p),
                 f"fake_quant_bwd {shape} {bits}b: dv differs from its plain "
                 "version")
            gate(bool(((ds - ds_p).abs() <= tol).all()),
                 f"fake_quant_bwd {shape} {bits}b, {E} scales: ds off its "
                 f"plain version by up to {err}")
            tol1 = (1e-4 * abs(float(ds1_p))
                    + 1e-6 * _ds_terms_abs(torch, v, one, g, qmin, qmax))
            gate(abs(float(ds1) - float(ds1_p)) <= tol1,
                 f"fake_quant_bwd {shape} {bits}b, one scale: ds {float(ds1)}"
                 f" vs plain {float(ds1_p)}")
            if bits != 4:
                rows.append(dict(name="fake_quant_bwd",
                                 shape=f"{shape} {bits}b, {E} scales",
                                 max_abs_err=err, main=False))
                continue
            n = v.numel()
            zp = torch.zeros(E, device=dev)
            vl = v.reshape(E, -1).clone().requires_grad_(True)
            sl = s.reshape(E).clone().requires_grad_(True)
            g2 = g.reshape(E, -1)

            def lib():
                o = torch._fake_quantize_learnable_per_channel_affine(
                    vl, sl, zp, 0, int(qmin), int(qmax), 1.0)
                return torch.autograd.grad(o, (vl, sl), g2)

            b_ms, b_by = bound_ms(12.0 * n + 8.0 * E, 10.0 * n,
                                  F32_OPS_PER_S)
            rows.append(dict(
                name="fake_quant_bwd", shape=f"{shape} {bits}b, {E} scales",
                max_abs_err=err,
                ms=cuda_ms(torch, lambda: ops.fake_quant_bwd(
                    v, s, g, qmin, qmax), flush),
                one_scale_ms=cuda_ms(torch, lambda: ops.fake_quant_bwd(
                    v, one, g, qmin, qmax), flush),
                plain_ms=cuda_ms(torch, lambda: ref.fake_quant_grads_ref(
                    v, s, g, qmin, qmax), flush),
                library_ms=cuda_ms(torch, lib, flush), bound_ms=b_ms,
                bound_by=b_by, main=False))
            r = rows[-1]
            print(f"[kernel] fake_quant_bwd  {str(shape):16s} {bits}b, {E} "
                  f"scales: err={err:.1e} ms={r['ms']:.4f} (one scale "
                  f"{r['one_scale_ms']:.4f}) plain={r['plain_ms']:.4f} "
                  f"lib fwd+bwd={r['library_ms']:.4f} "
                  f"bound={b_ms:.4f}({b_by})", flush=True)
    print(f"[kernel] fake_quant_bwd with a scale per expert: "
          f"{len(FQ_EXPERT_BWD_SHAPES) * len(FQ_BITS)} cases, dv bit for "
          "bit, each expert's ds within tolerance", flush=True)
    return rows


def _attended_pairs(S: int, causal: bool, window) -> int:
    """(q, k) pairs a row group attends under the mask (this run's work)."""
    if not causal:
        return S * S if window is None else sum(
            S - max(0, q - window + 1) for q in range(S))
    return sum(q + 1 if window is None else min(q + 1, window)
               for q in range(S))


def flash_phase(torch, ops, ref, flush, dev):
    return [flash_row(torch, ops, ref, flush, dev, *c) for c in FLASH_CASES]


def flash_row(torch, ops, ref, flush, dev, S, causal, window, KV, G, hd):
    """``flash_fwd`` at B = 1 on seeded q / k / v: out within 2e-5 and lse
    within 1e-5 of its plain version, timed beside it and SDPA under the
    same mask."""
    import torch.nn.functional as F
    B = 1
    H = KV * G
    g_ = torch.Generator(device=dev).manual_seed(S + (window or 0)
                                                 + causal)
    q = torch.randn((B, S, KV, G, hd), generator=g_,
                    device=dev) * hd ** -0.5
    k = torch.randn((B, S, KV, hd), generator=g_, device=dev)
    v = torch.randn((B, S, KV, hd), generator=g_, device=dev)
    kw = dict(causal=causal, window=window)
    out, lse = ops.flash_fwd(q, k, v, **kw)
    out_p, lse_p = ref.flash_fwd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((out - out_p).abs().max())
    err_lse = float((lse - lse_p).abs().max())
    tag = f"S={S} causal={causal} window={window}"
    gate(bool(torch.allclose(out, out_p, rtol=2e-5, atol=2e-5)),
         f"flash_fwd {tag}: out differs (max |err| {err})")
    gate(bool(torch.allclose(lse, lse_p, rtol=1e-5, atol=1e-5)),
         f"flash_fwd {tag}: lse differs (max |err| {err_lse})")
    # yardstick: SDPA in float32 on (B, H, S, hd), the same mask
    qh = q.reshape(B, S, H, hd).permute(0, 2, 1, 3).contiguous()
    kh = k.permute(0, 2, 1, 3).contiguous()
    vh = v.permute(0, 2, 1, 3).contiguous()
    mask = None
    if window is not None:
        pos = torch.arange(S, device=dev)
        d = pos[:, None] - pos[None, :]
        mask = (d < window) & ((d >= 0) if causal else True)

    def sdpa():
        return F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask,
            is_causal=causal and mask is None, scale=1.0,
            enable_gqa=True)

    lib_out = sdpa().permute(0, 2, 1, 3).reshape(out.shape)
    gate(bool(torch.allclose(lib_out, out, rtol=1e-3, atol=1e-4)),
         f"SDPA yardstick disagrees with flash_fwd {tag}")
    n_bytes = 4.0 * (2 * B * S * H * hd + 2 * B * S * KV * hd + B * H * S)
    n_ops = 4.0 * hd * _attended_pairs(S, causal, window) * B * H
    b_ms, b_by = bound_ms(n_bytes, n_ops, F32_OPS_PER_S)
    row = dict(
        name="flash_fwd", shape=f"B={B} {tag} KV={KV} G={G} hd={hd}",
        max_abs_err=max(err, err_lse),
        ms=cuda_ms(torch, lambda: ops.flash_fwd(q, k, v, **kw), flush,
                   reps=20),
        plain_ms=cuda_ms(torch, lambda: ref.flash_fwd_ref(q, k, v, **kw),
                         flush, reps=10),
        library_ms=cuda_ms(torch, sdpa, flush, reps=20), bound_ms=b_ms,
        bound_by=b_by, main=(S, causal, window, KV, G, hd) == FLASH_MAIN)
    print(f"[kernel] flash_fwd {tag:32s} KV={KV} G={G} hd={hd} "
          f"err={err:.1e}/{err_lse:.1e} "
          f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
          f"sdpa={row['library_ms']:.4f} bound={b_ms:.4f}({b_by})",
          flush=True)
    return row


def wkv_ops(B: int, S: int, H: int, hd: int, T: int) -> int:
    """Float operations of the chunked wkv (an exp counted as one): per
    (batch, head) and chunk, (r e^Lx) S, the strictly causal pair weights,
    the bonus diagonal, A v, the cumulative sums and decays, the state
    update."""
    pairs = T * (T - 1) // 2
    per_chunk = (2 * T * hd * hd + 5 * pairs * hd + 3 * T * hd
                 + T * (T + 1) * hd + 5 * T * hd + 2 * T * hd * hd + hd * hd)
    return B * H * (S // T) * per_chunk


def wkv_phase(torch, ops, ref, flush, dev):
    """``wkv`` against its plain version (``ref.wkv_chunked_ref``) from zero
    state and from a random one, y and the final state to ``WKV_TOL``; the
    strongest decay (log w = -8) finite and within it too; kernel and plain
    version timed from zero state (the prefill's call)."""
    rows = []
    for B, S, H, hd, T in WKV_CASES:
        g = torch.Generator(device=dev).manual_seed(S * 7 + H + hd + T)
        r, k, v = (torch.randn((B, S, H, hd), generator=g, device=dev)
                   for _ in range(3))
        lw = -(torch.rand((B, S, H, hd), generator=g, device=dev) * 1.99
               + 0.01)
        u = torch.randn((H, hd), generator=g, device=dev) * 0.5
        s0 = torch.randn((B, H, hd, hd), generator=g, device=dev) * 0.3
        err = 0.0
        for lw_, st in ((lw, None), (lw, s0), (torch.full_like(lw, -8.0), None)):
            y, state = ops.wkv(r, k, v, lw_, u, st, chunk=T)
            yp, sp = ref.wkv_chunked_ref(r, k, v, lw_, u, st, chunk=T)
            torch.cuda.synchronize()
            e = max(float((y - yp).abs().max()),
                    float((state - sp).abs().max()))
            gate(bool(torch.isfinite(y).all() and torch.isfinite(state).all()
                      and torch.allclose(y, yp, rtol=WKV_TOL, atol=WKV_TOL)
                      and torch.allclose(state, sp, rtol=WKV_TOL,
                                         atol=WKV_TOL)),
                 f"wkv B={B} S={S} H={H} hd={hd} chunk={T} "
                 f"{'from a state' if st is not None else 'zero state'} "
                 f"log_w min {float(lw_.min()):.2f} differs from its plain "
                 f"version (max |err| {e})")
            err = max(err, e)
        n = B * S * H * hd
        n_bytes = 4 * (5 * n + H * hd + B * H * hd * hd)
        b_ms, b_by = bound_ms(n_bytes, wkv_ops(B, S, H, hd, T), F32_OPS_PER_S)
        rows.append(dict(
            name="wkv", shape=f"B={B} S={S} H={H} hd={hd} chunk={T}",
            max_abs_err=err,
            ms=cuda_ms(torch, lambda: ops.wkv(r, k, v, lw, u, chunk=T), flush),
            plain_ms=cuda_ms(torch, lambda: ref.wkv_chunked_ref(
                r, k, v, lw, u, chunk=T), flush),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            main=(B, S, H, hd, T) == WKV_MAIN))
        print(f"[kernel] wkv B={B} S={S:<4d} H={H:<2d} hd={hd:<2d} chunk={T} "
              f"err={err:.1e} ms={rows[-1]['ms']:.4f} "
              f"plain={rows[-1]['plain_ms']:.4f} bound={b_ms:.4f}({b_by})",
              flush=True)
    return rows


def _tree_leaves(tree, pre=""):
    """[(path, tensor)] of a nested param/grad dict in sorted key order."""
    out = []
    for k in sorted(tree):
        key = f"{pre}/{k}" if pre else k
        v = tree[k]
        out += _tree_leaves(v, key) if isinstance(v, dict) else [(key, v)]
    return out


def _is_bank(path: str) -> bool:
    return path.endswith(("s_w", "s_a"))


def pinned_fq(cfg) -> int:
    """Fake-quant launches of the pinned layers in one pass: a tied token
    table is read twice (the lookup and the head), an untied one once; an
    untied head quantizes its weight and its activation; the audio
    frontend quantizes its weight and the frames, the vision frontend's
    image projection its weight and the patch embeddings."""
    if cfg.frontend == "audio_stub":
        return 2 + 2 * (not cfg.tie_embeddings)
    return (2 if cfg.tie_embeddings else 3) + 2 * (cfg.frontend ==
                                                   "vision_stub")


@contextlib.contextmanager
def fq_slice_probe(ops):
    """Count the fake-quant launches that take a scale per leading slice
    (n_s > 1) while the block runs: {"fake_quant_fwd": n, "fake_quant_bwd":
    n}. The wrappers are called as module functions (``_FakeQuant`` looks
    them up in ``ops``), so a wrapped name sees every call."""
    seen = {"fake_quant_fwd": 0, "fake_quant_bwd": 0}
    real = {k: getattr(ops, k) for k in seen}

    def wrap(name):
        def counted(v, s, *a):
            before = ops.launches[name]
            out = real[name](v, s, *a)
            if ops.launches[name] > before and ops.fq_scale_slices(v, s) > 1:
                seen[name] += 1
            return out
        return counted

    for k in seen:
        setattr(ops, k, wrap(k))
    try:
        yield seen
    finally:
        for k, f in real.items():
            setattr(ops, k, f)


def train_batches(torch, cfg, dev):
    """``batch(step)``: the data module's B=1, ``TRAIN_S`` batch of every
    key (tokens; frames and labels for the audio family) on ``dev``."""
    from repro_torch.data import SyntheticLM
    data = SyntheticLM(cfg)

    def batch(step):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in data.batch(step, 1, TRAIN_S).items()}
    return batch


def train_phase(torch, ops, dev, arch="qwen3-0.6b", label="train",
                hawq=True, remat=True, n_layers=None, prep=None):
    """The paper pipeline on ``arch`` at full width and depth (``n_layers``
    cuts the depth; ``label`` prefixes its lines; ``remat`` adds the remat
    check, ``hawq`` the HAWQ baseline; ``prep(params)`` edits the seeded
    params in place before the first step). Returns (launch counts of the
    run, results, the final params, the searched policy)."""
    from repro_torch import optim, training
    from repro_torch.configs import get_config
    from repro_torch.core import importance as imp
    from repro_torch.core import search
    from repro_torch.models import lm
    from repro_torch.models.quant_layers import QuantContext

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.scaled(n_layers=n_layers)
    ql = lm.enumerate_qlayers(cfg)
    n_proj = len(ql)
    n_fq = 2 * n_proj + pinned_fq(cfg)
    per_pass = dict(fake_quant_fwd=n_fq, fake_quant_bwd=n_fq,
                    flash_fwd=cfg.n_layers)
    # an expert stack's weight and input take a scale per expert, each way
    n_sliced = 2 * sum(q.n_mats > 1 for q in ql)
    n_pass = cfg.n_bits + 1
    ctx = QuantContext.make(cfg.bits, cfg.quant_act_signed,
                            compute_dtype=torch.float32)
    batch = train_batches(torch, cfg, dev)
    unit = "frames" if cfg.frontend == "audio_stub" else "tok"

    params = lm.init_params(cfg, seed=0, device=dev)
    if prep is not None:
        prep(params)
    # the initial values, kept on the host: at full width a tree is
    # gigabytes of device memory
    p0 = {k: t.detach().to("cpu", copy=True) for k, t in _tree_leaves(params)}
    print(f"[{label}] {cfg.name}: {cfg.n_layers} layers, "
          f"{lm.param_count(params) / 1e6:.1f}M params, {n_proj} searchable "
          f"projections, B=1 S={TRAIN_S} float32, hd {cfg.hd}, "
          f"{'causal' if cfg.causal else 'bidirectional'}", flush=True)
    res = dict(per_pass=per_pass)
    total = {k: 0 for k in TRAIN_KERNELS}

    def run(label, expect, fn):
        ops.reset_launches()                     # counts: this run only
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with fq_slice_probe(ops) as sliced:
            out = fn()
            ms = sync_ms(torch, t0)
        got = {k: ops.launches[k] for k in TRAIN_KERNELS}
        for k in TRAIN_KERNELS:
            total[k] += got[k]
        # (a) launches exactly as the schedule implies, those with a scale
        # per expert among them
        gate(got == expect, f"[{label}] launches {got}, expected {expect}")
        passes = expect["fake_quant_fwd"] // n_fq
        want = {k: n_sliced * passes * bool(expect[k]) for k in sliced}
        gate(sliced == want, f"[{label}] launches with a scale per slice "
             f"{sliced}, expected {want}")
        gate(all(ops.launches[k] == 0 for k in SERVE_KERNELS),
             f"[{label}] a serving kernel launched while training")
        return out, ms

    # 1. joint importance training
    opt = imp.importance_optimizer(0.01, momentum=0.9, freeze_backbone=True)
    step = imp.make_importance_step(cfg, ctx, opt, remat=False)
    state = opt.init(params)
    gen = torch.Generator().manual_seed(1234)
    imp_ms, imp_loss = [], []
    for i in range(IMP_STEPS):
        b = batch(i)
        (params, state, m), ms = run(
            f"importance step {i}", {k: n_pass * v for k, v in per_pass.items()},
            lambda: step(params, state, b, gen))
        losses = m["loss_uniform"].tolist() + [float(m["loss_random"])]
        gnorm = float(m["grad_norm"])
        gate(all(math.isfinite(x) for x in losses + [gnorm]),   # (b)
             f"importance step {i}: loss {losses} grad norm {gnorm}")
        imp_ms.append(ms)
        imp_loss.append(losses)
        print(f"[{label}] importance step {i}: {ms:.0f} ms ({n_pass} passes, "
              f"{n_pass * TRAIN_S / ms * 1e3:.0f} {unit}/s over all passes), "
              f"losses uniform {[round(x, 4) for x in losses[:-1]]} random "
              f"{losses[-1]:.4f}, grad norm {gnorm:.4g}", flush=True)
    del state
    # (c) backbone bit for bit, every bank moved
    now = dict(_tree_leaves(params))
    frozen = [k for k in p0 if not _is_bank(k)]
    gate(all(torch.equal(now[k].cpu(), p0[k]) for k in frozen),
         "importance steps moved a backbone weight")
    banks = [k for k in p0 if _is_bank(k)]
    still = [k for k in banks if torch.equal(now[k].cpu(), p0[k])]
    gate(not still, f"banks not moved by the importance steps: {still[:4]}")
    print(f"[{label}] backbone ({len(frozen)} tensors) bit for bit unchanged; "
          f"all {len(banks)} banks moved", flush=True)
    del p0, now

    # 2-3. indicators and the one-time ILP search
    ind = imp.extract_indicators(params, cfg, ql)
    budget = search.bitops_budget_for_uniform(ql, 3)
    sr = search.search_policy(ql, ind, cfg.bits, alpha=1.0,
                              bitops_budget=budget)
    sr.policy.validate(ql, bits=cfg.bits)                       # (d)
    gate(sr.bitops <= budget * (1 + 1e-6),
         f"searched policy BitOps {sr.bitops} over budget {budget}")
    w_avg, a_avg = sr.policy.avg_bits()
    print(f"[{label}] ILP search {sr.elapsed_s * 1e3:.1f} ms, solver "
          f"{sr.solver}, avg bits w={w_avg:.3f} a={a_avg:.3f}, BitOps "
          f"{sr.bitops:.4g} <= budget {budget:.4g}", flush=True)

    # 4. QAT finetune under the searched policy
    bits = lm.bits_from_policy(cfg, sr.policy, ql)
    opt = optim.adamw(3e-3, clip_norm=1.0)
    qstep = training.make_train_step(cfg, ctx, opt, bits, remat=False)
    state = opt.init(params)
    qat_ms, qat_loss = [], []
    for i in range(QAT_STEPS):
        b = batch(IMP_STEPS + i)
        (params, state, m), ms = run(f"qat step {i}", per_pass,
                                     lambda: qstep(params, state, b))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        gate(math.isfinite(loss) and math.isfinite(gnorm),       # (b)
             f"qat step {i}: loss {loss} grad norm {gnorm}")
        qat_ms.append(ms)
        qat_loss.append(loss)
        print(f"[{label}] qat step {i}: {ms:.0f} ms "
              f"({TRAIN_S / ms * 1e3:.0f} {unit}/s), loss {loss:.4f}, grad norm "
              f"{gnorm:.4g}", flush=True)
    del state

    # 5. evaluation on a held-out batch
    b = batch(1000)
    ev, ev_ms = run("eval", dict(per_pass, fake_quant_bwd=0),
                    lambda: training.evaluate(params, cfg, ctx, bits, [b]))
    gate(all(math.isfinite(v) for v in ev.values()), f"eval {ev}")   # (b)
    print(f"[{label}] eval: ce {ev['ce']:.4f} in {ev_ms:.0f} ms", flush=True)
    print(f"[{label}] launches over the run {total} (per pass {per_pass})",
          flush=True)
    # where the time goes: one more QAT step under the profiler (outside
    # the counted run; its result is dropped)
    state = opt.init(params)
    res["qat_step_profile"] = profile_device(
        torch, lambda: qstep(params, state, b), watch=("flash_fwd_kernel",))
    print_profile(label, "one QAT step", res["qat_step_profile"])
    del state
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[{label}] peak device memory {peak:.2f} GiB", flush=True)
    res.update(importance_ms=imp_ms, importance_losses=imp_loss,
               qat_ms=qat_ms, qat_losses=qat_loss, eval=ev, eval_ms=ev_ms,
               qat_tokens_per_s=TRAIN_S / statistics.median(qat_ms) * 1e3,
               importance_tokens_per_s=n_pass * TRAIN_S
               / statistics.median(imp_ms) * 1e3,
               ilp_ms=sr.elapsed_s * 1e3, ilp_solver=sr.solver,
               avg_bits=[w_avg, a_avg], bitops=sr.bitops,
               bitops_budget=budget, peak_mem_gb=peak)
    res["sliced_per_pass"] = n_sliced
    # 6. remat: the QAT step's loss and gradients with and without it
    if remat:
        res["remat"] = remat_check(torch, ops, cfg, ctx, bits, params,
                                   batch(IMP_STEPS), n_proj, label)
    # 7. the HAWQ baseline on the trained params and the first batch, its
    # table through the same ILP; the indicators' cost beside it
    if hawq:
        res["hawq"] = hawq_check(torch, ops, dev, cfg, ql, params, batch(0),
                                 budget, sum(imp_ms))
    return total, res, params, sr.policy


def remat_check(torch, ops, cfg, ctx, bits, params, batch, n_proj,
                label="train"):
    """(f) one QAT step's loss and gradients (forward + backward) with
    ``remat=False`` and with ``remat=True`` on the same params and batch:
    equal bit for bit (the recompute runs the same deterministic kernels on
    the same inputs); the launches the schedule implies (each body unit's
    forward runs again in the backward: its fake-quant forwards -- two per
    projection -- and its flash forward; the pinned layers' stay outside
    the units); the peak device memory and ms of both."""
    from repro_torch.models import lm
    from repro_torch.training import value_and_grad
    pin = pinned_fq(cfg)
    expect = {False: dict(fake_quant_fwd=2 * n_proj + pin,
                          fake_quant_bwd=2 * n_proj + pin,
                          flash_fwd=cfg.n_layers),
              True: dict(fake_quant_fwd=4 * n_proj + pin,
                         fake_quant_bwd=2 * n_proj + pin,
                         flash_fwd=2 * cfg.n_layers)}
    runs, res = {}, {}
    # twice each, in turns; the second of each is kept (the first call
    # through torch.utils.checkpoint pays a one-time set-up of seconds)
    for remat in (False, True, False, True):
        runs.pop(remat, None)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        loss, _, g = value_and_grad(lambda p: lm.loss_fn(
            p, cfg, batch, bits, ctx, remat=remat), params)
        ms = sync_ms(torch, t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = {k: ops.launches[k] for k in TRAIN_KERNELS}
        gate(got == expect[remat], f"[remat={remat}] launches {got}, "
             f"expected {expect[remat]}")
        runs[remat] = (loss, dict(_tree_leaves(g)))
        res[f"remat_{remat}"] = dict(ms=ms, peak_mem_gb=peak,
                                     above_start_gb=peak - base,
                                     launches=got, loss=float(loss))
        print(f"[{label}] remat={remat}: QAT loss and gradients in {ms:.0f} ms, "
              f"peak device memory {peak:.2f} GiB ({peak - base:.2f} GiB "
              f"above the {base:.2f} GiB held before it), launches {got}",
              flush=True)
    (l0, g0), (l1, g1) = runs[False], runs[True]
    differ = [k for k in g0 if not torch.equal(g0[k], g1[k])]
    gate(torch.equal(l0, l1) and not differ,
         f"remat changed the loss ({float(l0)!r} vs {float(l1)!r}) or "
         f"{len(differ)} gradients: {differ[:4]}")
    print(f"[{label}] remat on and off: loss and all {len(g0)} gradients bit "
          f"for bit", flush=True)
    return res


def hawq_check(torch, ops, dev, cfg, ql, params, batch, budget, ind_ms):
    """(g) ``hessian.hawq_sensitivities``' two halves on the trained params
    at full width and depth (``HAWQ_SAMPLES`` Rademacher probes, the
    batch's first ``HAWQ_S`` tokens): every trace finite,
    every layer's sensitivity non-increasing in bits, the ILP on the table
    under the uniform-3-bit BitOps budget a valid policy within it; the
    time beside the indicators' (the importance steps), as
    ``benchmarks/hessian_baseline.py`` prints ``ours`` against ``hawq``.
    Then (h) the Hessian-vector product against a float64 central finite
    difference of gradients at 2 layers."""
    from repro_torch.core import hessian, search
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(7)
    cut = {"tokens": batch["tokens"][:, :HAWQ_S].contiguous()}
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traces = hessian.hutchinson_traces(params, cfg, cut, ql, gen,
                                       n_samples=HAWQ_SAMPLES)
    trace_ms = sync_ms(torch, t0)
    t0 = time.perf_counter()
    perturb = hessian.quantization_perturbations(params, cfg, ql)
    perturb_ms = sync_ms(torch, t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gate(ops.launches["flash_fwd"] == 0,
         "the Hessian's loss reached the flash kernel")
    bad = [n for n, t in traces.items() if not math.isfinite(t)]
    gate(not bad, f"non-finite traces: {bad[:4]}")
    table = hessian.sensitivity_table(ql, traces, perturb)
    rising = [n for n, t in table.items()
              if not (np.all(np.isfinite(t["w"]))
                      and np.all(np.diff(t["w"]) <= 0))]
    gate(not rising, f"HAWQ sensitivities not non-increasing in bits: "
         f"{rising[:4]}")
    sr = search.search_policy(ql, table, cfg.bits, alpha=1.0,
                              bitops_budget=budget)
    sr.policy.validate(ql, bits=cfg.bits)
    gate(sr.bitops <= budget * (1 + 1e-6),
         f"HAWQ policy BitOps {sr.bitops} over budget {budget}")
    t = np.array(list(traces.values()))
    print(f"[train] HAWQ ({HAWQ_SAMPLES} probes, {cfg.n_layers} layers, "
          f"S={HAWQ_S}): traces {trace_ms:.0f} ms + "
          f"perturbations {perturb_ms:.0f} ms, peak device memory "
          f"{peak:.2f} GiB; traces min {t.min():.4g} median "
          f"{np.median(t):.4g} max {t.max():.4g}; ILP on its table: avg "
          f"bits w={sr.policy.avg_bits()[0]:.3f}, BitOps {sr.bitops:.4g} <= "
          f"{budget:.4g}; criterion cost ours (the importance steps, "
          f"S={batch['tokens'].shape[1]}) {ind_ms:.0f} ms vs hawq "
          f"{trace_ms + perturb_ms:.0f} ms",
          flush=True)
    res = dict(trace_ms=trace_ms, perturb_ms=perturb_ms, S=HAWQ_S,
               peak_mem_gb=peak, samples=HAWQ_SAMPLES,
               trace_min=float(t.min()), trace_max=float(t.max()),
               avg_bits=list(sr.policy.avg_bits()), bitops=sr.bitops,
               indicators_ms=ind_ms)
    res["hvp_vs_fd"] = hvp_fd_check(torch, dev, cfg.scaled(n_layers=2),
                                    batch)
    return res


def hvp_fd_check(torch, dev, cfg, batch, eps: float = 1e-4):
    """(h) the float32 reverse-over-reverse Hessian-vector product of
    ``hessian.full_precision_loss`` against a float64 central difference
    of its gradients, (g(w + eps v) - g(w - eps v)) / (2 eps), on one
    Rademacher probe over every QLayer weight: relative L2 within
    ``HVP_RTOL``. At S = 2048 the attention is the plain flash baseline,
    so this holds its second derivative."""
    from repro_torch.core import hessian
    from repro_torch.models import lm
    params = lm.init_params(cfg, seed=0, device=dev)
    ql = lm.enumerate_qlayers(cfg)
    loss, w = hessian.full_precision_loss(params, cfg, batch, ql)
    keys = list(w)
    gen = torch.Generator(device=dev).manual_seed(3)
    v = [hessian.rademacher(w[k].shape, gen, dev) for k in keys]
    (_, hv), = hessian.hessian_vector_products(loss, [w[k] for k in keys],
                                               [v])
    del loss

    def grad64(sign):
        moved = hessian.with_weights(params, ql, {
            k: w[k].detach().double() + sign * eps * p.double()
            for k, p in zip(keys, v)})
        loss64, w64 = hessian.full_precision_loss(moved, cfg, batch, ql,
                                                  torch.float64)
        return torch.autograd.grad(loss64, [w64[k] for k in keys])

    gp = grad64(1.0)
    gm = grad64(-1.0)
    fd = [(a - b) / (2 * eps) for a, b in zip(gp, gm)]
    num = sum(float(((h.double() - f) ** 2).sum()) for h, f in zip(hv, fd))
    den = sum(float((f ** 2).sum()) for f in fd)
    rel = (num / den) ** 0.5
    vhv = [(float((p.double() * h.double()).sum()),
            float((p.double() * f).sum())) for p, h, f in zip(v, hv, fd)]
    print(f"[train] HVP at {cfg.n_layers} layers, S={batch['tokens'].shape[1]}:"
          f" float32 reverse-over-reverse vs float64 central difference "
          f"(eps {eps}) relative L2 {rel:.2e} over {len(keys)} weight leaves; "
          f"<v, Hv> first leaf {vhv[0][0]:.6g} vs {vhv[0][1]:.6g}", flush=True)
    gate(rel <= HVP_RTOL, f"the HVP differs from the float64 finite "
         f"difference by {rel:.3e} relative L2")
    return dict(rel_l2=rel, eps=eps, layers=cfg.n_layers, vhv=vhv)


def profile_device(torch, fn, top: int = 8, watch=()):
    """``fn`` under torch.profiler: wall ms, kernel launches, device busy ms
    (the sum over device-side kernel events only: a host op's device time
    repeats its kernels'), the ``top`` kernels by device time and, for each
    name in ``watch``, the device ms and launches of the kernels whose name
    holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = sync_ms(torch, t0)
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kernels = sorted((e for e in ev if e.device_type == DeviceType.CUDA
                      and dev_us(e) > 0), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kernels) / 1e3
    return dict(wall_ms=wall, device_ms=busy or None,
                kernel_launches=sum(e.count for e in ev
                                    if e.key == "cudaLaunchKernel"),
                top=[(e.key[:64], dev_us(e) / 1e3, e.count)
                     for e in kernels[:top]],
                watched=[(w, sum(dev_us(e) for e in kernels
                                 if w in e.key) / 1e3,
                          sum(e.count for e in kernels if w in e.key))
                         for w in watch])


def count_syncs(torch, fn) -> int:
    """Host-device synchronisations in one call of ``fn``: the warnings
    ``torch.cuda.set_sync_debug_mode("warn")`` raises for them."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the mode is a prototype: PyTorch says it does not see every sync, and
    # warns so when it is switched on)
    return sum("synchronizing" in str(w.message)
               and "debug mode" not in str(w.message) for w in caught)


def print_profile(label: str, what: str, res: dict) -> None:
    wall, busy = res["wall_ms"], res["device_ms"]
    print(f"[{label}] {what} under the profiler: {wall:.1f} ms wall, "
          f"{res['kernel_launches']} kernel launches, device busy "
          + (f"{busy:.1f} ms ({busy / wall:.0%})" if busy else "not measured"),
          flush=True)
    for name, ms, n in res["top"]:
        print(f"[{label}]   {ms:9.2f} ms {n:6d}x  {name}", flush=True)
    for watch, w_ms, w_n in res["watched"]:
        print(f"[{label}] {watch} in it: {w_ms:.3f} ms over {w_n} launches",
              flush=True)


def kernel_vs_plain(torch, ops, dev, n_layers=None, quantize_acts=True,
                    plain=TRAIN_KERNELS, arch="qwen3-0.6b", label="train",
                    prep=None, quantize=True):
    """One loss_fn + backward of ``arch`` at full width, S=2048, 4-bit
    uniform (``quantize=False``: no quantizer at all, so only the flash
    kernel launches), through the kernels and through the plain versions
    of the kernels ``plain`` (the others launch on both sides), on the
    seeded params (``prep(params)`` edits them first). Returns the
    differences: loss rtol and per-leaf relative L2 of the gradients (max
    over banks, max over the rest)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.quant_layers import QuantContext
    from repro_torch.training import value_and_grad

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.scaled(n_layers=n_layers)
    params = lm.init_params(cfg, seed=0, device=dev)
    if prep is not None:
        prep(params)
    ctx = dataclasses.replace(
        QuantContext.make(cfg.bits, cfg.quant_act_signed,
                          compute_dtype=torch.float32),
        quantize_acts=quantize_acts, enabled=quantize)
    batch = train_batches(torch, cfg, dev)(7)
    bits = lm.bits_uniform(cfg, 2)

    def once():
        ops.reset_launches()
        loss, _, g = value_and_grad(
            lambda p: lm.loss_fn(p, cfg, batch, bits, ctx, remat=False),
            params)
        torch.cuda.synchronize()
        return float(loss), dict(_tree_leaves(g)), dict(ops.launches)

    lk, gk, nk = once()
    with ops.plain_on_cuda(*plain):
        lp, gp, np_ = once()
    gate(all(nk[k] > 0 for k in (TRAIN_KERNELS if quantize
                                 else ("flash_fwd",)))
         and all(np_[k] == (0 if k in plain else nk[k])
                 for k in TRAIN_KERNELS),
         f"kernel pass launched {nk}, plain pass {np_} (plain: {plain})")
    rel = {k: float((gk[k] - gp[k]).norm() / gp[k].norm().clamp_min(1e-30))
           for k in gp}
    d = dict(layers=cfg.n_layers, quantize_acts=quantize_acts,
             quantize=quantize, plain=list(plain), launches={k: nk[k] for k in TRAIN_KERNELS},
             loss_kernel=lk, loss_plain=lp,
             loss_rtol=abs(lk - lp) / abs(lp),
             bank_rel_max=max(v for k, v in rel.items() if _is_bank(k)),
             weight_rel_max=max(v for k, v in rel.items() if not _is_bank(k)),
             worst=sorted(rel.items(), key=lambda kv: -kv[1])[:4])
    what = ("quantization off" if not quantize else "activations "
            + ("quantized" if quantize_acts else "unquantized"))
    print(f"[{label}] kernels vs plain {list(plain)}, {cfg.n_layers} layers, "
          f"{what}: loss "
          f"{lk:.6f} vs {lp:.6f} (rtol {d['loss_rtol']:.2e}), gradient "
          f"relative L2 max {d['bank_rel_max']:.2e} (banks) / "
          f"{d['weight_rel_max']:.2e} (weights, norms); worst "
          f"{[(k, f'{v:.2e}') for k, v in d['worst']]}", flush=True)
    return d


def vs_plain_gates(torch, ops, dev, arch, cut, label, prep=None,
                   flash_alone=False):
    """Gate (e) of ``arch``: one train pass through the kernels against
    their plain versions, gated at ``cut`` layers (activations unquantized,
    every kernel against its plain version; then quantized, the flash
    kernel on both sides). ``prep(params)`` edits the seeded params of
    each pass. (The full-depth comparison that was printed beside it is
    cut for the script's time limit: it parts on code flips, ROADMAP 3.)

    The first run holds only while every quantizer code is the same on
    both sides (``TRAIN_TOL``). An untied head quantizes its input at 8
    bits whatever ``quantize_acts`` says, behind the attention: where a
    last bit of the flash output flips some of those codes at the cut
    depth (``flash_alone``), the first run holds the flash kernel alone
    with quantization off, and the second, whose codes are equal by
    construction, holds the fake-quant kernels."""
    out = {}
    first = (dict(n_layers=cut, quantize=False, plain=("flash_fwd",))
             if flash_alone else dict(n_layers=cut, quantize_acts=False))
    for key, kw in (("quant_off" if flash_alone else "acts_unquantized",
                     first),
                    ("acts_quantized",
                     dict(n_layers=cut, plain=("fake_quant_fwd",
                                               "fake_quant_bwd")))):
        d = out[key] = kernel_vs_plain(torch, ops, dev, arch=arch,
                                       label=label, prep=prep, **kw)
        gate(d["loss_rtol"] <= TRAIN_TOL["loss_rtol"]
             and d["bank_rel_max"] <= TRAIN_TOL["grad_rel"]
             and d["weight_rel_max"] <= TRAIN_TOL["grad_rel"],
             f"[{label}] train pass through the kernels differs from the "
             f"plain versions beyond {TRAIN_TOL}: {d}")
        torch.cuda.empty_cache()
    return out


def audio_phase(torch, ops, dev):
    """The paper pipeline on hubert-xlarge, the encoder-only audio family,
    at full width and depth (module docstring, phase 14), then gate (e) on
    it; the weights are freed before it returns. Returns (launch counts of
    the pipeline's run, results)."""
    torch.cuda.reset_peak_memory_stats()
    launches, res, params, _ = train_phase(torch, ops, dev, arch=AUDIO_ARCH,
                                           label="audio", hawq=False)
    del params
    torch.cuda.empty_cache()
    res["vs_plain"] = vs_plain_gates(torch, ops, dev, AUDIO_ARCH, AUDIO_CUT,
                                     "audio")
    return launches, res


def prefill_noise(torch, cfg, params, policy, sess, reqs, dev,
                  cap=CACHE_LEN, n_dec=0, label="serve", variants=None):
    """Max |logit difference| over the vocabulary, per prompt, at prefill
    and at each of ``n_dec`` decode steps after it (every side fed the
    float32 reference's greedy tokens, the state each side's own): served
    path vs the float32 fake-quant reference, and that reference vs its
    float64 evaluation. ``variants`` (name: a context manager factory)
    serve the same prompts and tokens again inside each scope: their
    distances from the float32 reference (``{name}_vs_ref32``) and from
    the served path (``{name}_vs_served``). The references run the
    kernels' plain versions."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.engine import LMAdapter
    from repro_torch.models import lm
    bits = lm.bits_from_policy(cfg, policy)
    ctx = dataclasses.replace(serve.make_context(cfg), kv_quant="fake")
    r32 = LMAdapter(cfg, bits, ctx)
    r64 = LMAdapter(cfg, bits, dataclasses.replace(
        ctx, compute_dtype=torch.float64))

    def dist(got, want):
        return [float((a - b).abs().max()) for a, b in zip(got, want)]

    rows = []
    for r in reqs:
        t = torch.as_tensor(r.tokens, device=dev)[None]
        with ops.plain_on_cuda(*ops.PLAIN_KERNELS):
            l32, s32 = r32.prefill(params, t, prefill_cap=cap)
            l64, s64 = r64.prefill(params, t, prefill_cap=cap)
            ref, feed = [l32], []
            ctrl = [float((l32 - l64.float()).abs().max())]
            for i in range(n_dec):
                tok = l32.reshape(1, -1).argmax(-1).to(torch.int32)[:, None]
                p = torch.full((1,), t.shape[1] + i, dtype=torch.int32,
                               device=dev)
                feed.append((tok, p))
                l32, s32 = r32.decode(params, tok, p, s32)
                l64, s64 = r64.decode(params, tok, p, s64)
                ref.append(l32)
                ctrl.append(float((l32 - l64.float()).abs().max()))

        def served_logits():
            lk, sk = sess.prefill(sess.params, t, prefill_cap=cap)
            out = [lk]
            for tok, p in feed:
                lk, sk = sess.decode(sess.params, tok, p, sk)
                out.append(lk)
            return out

        served = served_logits()
        row = dict(rid=r.rid, prompt=t.shape[1],
                   served_vs_ref32=max(dist(served, ref)),
                   ref32_vs_ref64=max(ctrl), served_steps=dist(served, ref),
                   ref_steps=ctrl, logit_std=float(l32.std()))
        for name, scope in (variants or {}).items():
            with scope():
                got = served_logits()
            row[f"{name}_vs_ref32"] = max(dist(got, ref))
            row[f"{name}_vs_served"] = max(dist(got, served))
        rows.append(row)
    print(f"[{label}] " + ("prefill" if not n_dec else
                            f"prefill + {n_dec} decode steps")
          + " max|logit diff| served-vs-ref32 / ref32-vs-ref64: "
          + " ".join(f"{x['served_vs_ref32']:.3f}/{x['ref32_vs_ref64']:.3f}"
                     for x in rows)
          + f" (logit std {rows[0]['logit_std']:.3f})", flush=True)
    for name in variants or {}:
        print(f"[{label}]   {name}: vs ref32 / vs served "
              + " ".join(f"{x[name + '_vs_ref32']:.4f}/"
                         f"{x[name + '_vs_served']:.4f}" for x in rows),
              flush=True)
    return rows


def profile_decode_step(torch, sess, dev, label="serve", layout=None,
                        watch=("decode_attn_quant_kernel",),
                        cache_len=CACHE_LEN, pos0=200):
    """One decode step of the served model (4 slots of ``cache_len`` rows,
    at positions ``pos0`` on) under torch.profiler: kernel launches, host
    time, device time and that of the kernels named in ``watch``. With a
    paged ``layout`` each slot maps pages of its own. The
    steps labelled in ``DECODE_STEP_LAUNCHES`` (Qwen3-0.6B's, ring and
    pages; RecurrentGemma-2B's; DeepSeek-MoE-16B's; Llama-3.2-Vision-11B's;
    Mixtral-8x7B's) launch exactly that
    many kernels: one launch per matmul and attention call."""
    st = sess.init_state(SLOTS, cache_len, torch.float32, device=dev,
                         layout=layout)
    if layout is not None:
        P = layout.pages_per_slot(cache_len)
        tbl = torch.arange(SLOTS * P, dtype=torch.int32, device=dev)
        st = {"sites": {k: c._replace(page_table=tbl.reshape(SLOTS, P))
                        for k, c in st["sites"].items()}}
    tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.arange(SLOTS, dtype=torch.int32, device=dev) + pos0
    for _ in range(2):
        sess.decode(sess.params, tok, pos, st)
    res = profile_device(torch, lambda: sess.decode(sess.params, tok, pos,
                                                    st), top=4, watch=watch)
    res["host_syncs"] = count_syncs(
        torch, lambda: sess.decode(sess.params, tok, pos, st))
    probe = count_syncs(torch, lambda: torch.ones(1, device=dev).item())
    gate(probe >= 1, f"the sync counter saw {probe} syncs in one .item()")
    print_profile(label, "one decode step", res)
    want = DECODE_STEP_LAUNCHES.get(label)
    gate(want is None or res["kernel_launches"] == want,
         f"[{label}] one decode step launched {res['kernel_launches']} "
         f"kernels, expected {want}")
    print(f"[{label}] one decode step synchronises the host "
          f"{res['host_syncs']} times (the engine reads the tokens after it)",
          flush=True)
    return res


def serve_requests(cfg, n=len(PROMPTS)):
    """The serve phase's first ``n`` requests (PROMPTS, GEN new tokens)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.scheduler import Request
    data = SyntheticLM(cfg)
    return [Request(rid=i, tokens=data.batch(i, 1, p)["tokens"][0],
                    max_new=GEN) for i, p in enumerate(PROMPTS[:n])]


def _packed_by_path(tree, pre=""):
    from repro_torch.runtime import packing
    out = {}
    for k, v in tree.items():
        if isinstance(v, packing.PackedLinear):
            out[pre + k] = v
        elif isinstance(v, dict):
            out.update(_packed_by_path(v, f"{pre}{k}/"))
    return out


def bundle_phase(torch, ops, dev, params, policy):
    """The train phase's final params and searched policy as a serving
    bundle (module docstring, phase 10)."""
    import shutil
    import tempfile
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.engine import DecodeEngine, EngineConfig
    from repro_torch.runtime.session import QuantizedSession

    cfg = get_config("qwen3-0.6b")
    # the first wave, 4 requests of WAVE_GEN new tokens (cut from GEN for
    # the script's time limit)
    reqs = [r._replace(max_new=WAVE_GEN) for r in serve_requests(cfg, 4)]
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix="bundle.", dir=build)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_serving_bundle(d, 0, params, policy,
                                 extra_meta={"arch": cfg.name})
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(d).rglob("*")
                   if f.is_file())
        peek = ckpt.peek_serving_policy(d)
        gate(peek.w_bits == policy.w_bits and peek.a_bits == policy.a_bits,
             "[bundle] peek_serving_policy returned another policy")
        mem = QuantizedSession(cfg, params, policy, serve.make_context(cfg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        disk = QuantizedSession.from_checkpoint(d, cfg, device=dev)
        load_s = sync_ms(torch, t0) / 1e3
    finally:
        shutil.rmtree(d, ignore_errors=True)
    mp, dp = _packed_by_path(mem.params), _packed_by_path(disk.params)
    gate(set(mp) == set(dp) and all(
        torch.equal(mp[k].codes, dp[k].codes)
        and torch.equal(mp[k].scale, dp[k].scale) for k in mp),
        "[bundle] packed codes of the bundle's session differ from the "
        "in-memory session's")
    outs, launches = [], {}
    for label, sess in (("in-memory", mem), ("bundle", disk)):
        eng = DecodeEngine(sess.params, cfg, None, sess.ctx, adapter=sess,
                           device=dev, ecfg=EngineConfig(
                               slots=SLOTS, cache_len=CACHE_LEN,
                               prefill_chunk=PREFILL_CHUNK, kv_quant="int8"))
        eng.submit_all(reqs)
        ops.reset_launches()                     # counts: this run only
        outs.append(eng.run())
        launches[label] = {k: ops.launches[k] for k in SERVE_KERNELS}
        gate(launches[label]["decode_attn_quant"] > 0
             and launches[label]["quant_matmul"]
             + launches[label]["quant_matmul_w4"] > 0
             and sess.route_counts.eligible_fp == 0,
             f"[bundle] the {label} session launched {launches[label]}, "
             f"{sess.route_counts.eligible_fp} eligible matmuls on dequant-fp")
    same = all(outs[0][r.rid].tokens == outs[1][r.rid].tokens for r in reqs)
    gate(same, "[bundle] the bundle's session served other tokens than the "
         "in-memory session")
    print(f"[bundle] serving bundle of the trained params and searched "
          f"policy: {size / 1e9:.3f} GB, saved in {save_s:.2f} s, restored "
          f"onto the card and packed in {load_s:.2f} s; packed codes "
          f"({disk.packed_bytes()} B) bit for bit the in-memory session's; "
          f"{len(reqs)} requests with identical greedy tokens; launches "
          f"{launches['bundle']}", flush=True)
    return dict(bytes=size, save_s=save_s, load_pack_s=load_s,
                packed_bytes=disk.packed_bytes(), launches=launches,
                requests=len(reqs))


@contextlib.contextmanager
def elastic_probe(ops):
    """Watch the elastic engines run inside: for each, the ``pack_linear``
    calls and the kernel launches of its run alone (counts set to 0 just
    before it, read just after)."""
    from repro_torch.launch import engine
    from repro_torch.runtime import packing
    real_pack, real_run = packing.pack_linear, engine.DecodeEngine.run
    packs, runs = [0], []

    def counting(*a, **kw):
        packs[0] += 1
        return real_pack(*a, **kw)

    def run(self):
        if self.elastic is None:
            return real_run(self)
        before = packs[0]
        ops.reset_launches()
        out = real_run(self)
        runs.append(dict(packs=packs[0] - before,
                         launches={k: ops.launches[k] for k in SERVE_KERNELS}))
        return out

    packing.pack_linear, engine.DecodeEngine.run = counting, run
    try:
        yield runs
    finally:
        packing.pack_linear, engine.DecodeEngine.run = real_pack, real_run


def variant_step_ms(trace) -> dict:
    """Decode-step p50 (ms) of each variant: the ``decode_step`` spans of
    each swap epoch of an elastic trace."""
    swaps = sorted((e for e in trace.events if e.name == "policy_swap"),
                   key=lambda e: e.ts)
    steps = {}
    for e in trace.events:
        if e.name == "decode_step":
            pid = [w.args["to"] for w in swaps if w.ts <= e.ts][-1]
            steps.setdefault(pid, []).append(e.dur * 1e3)
    return {pid: statistics.median(v) for pid, v in steps.items()}


def step_launches(torch, ops, sess, dev, layout=None) -> dict:
    """Kernel launches of one decode step (4 slots) of ``sess``'s active
    variant."""
    st = sess.init_state(SLOTS, CACHE_LEN, torch.float32, device=dev,
                         layout=layout)
    if layout is not None:
        P = layout.pages_per_slot(CACHE_LEN)
        tbl = torch.arange(SLOTS * P, dtype=torch.int32, device=dev)
        st = {"sites": {k: c._replace(page_table=tbl.reshape(SLOTS, P))
                        for k, c in st["sites"].items()}}
    tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.arange(SLOTS, dtype=torch.int32, device=dev) + 20
    ops.reset_launches()
    sess.decode(sess.params, tok, pos, st)
    torch.cuda.synchronize()
    return {k: ops.launches[k] for k in SERVE_KERNELS if ops.launches[k]}


def elastic_phase(torch, ops, dev, card, layout):
    """The serve CLI's elastic path at Qwen3-0.6B full width (module
    docstring, phase 11) over ``layout``."""
    from repro_torch.launch import serve

    out = ROOT / "chiprun_out" / "elastic"
    out.mkdir(parents=True, exist_ok=True)
    policy = out / "demo_policy.json"
    gate(_serve_cli(serve, ["--arch", "qwen3-0.6b", "--write-demo-policy",
                            str(policy)]) is None,
         "[elastic] --write-demo-policy")
    label = f"elastic-{layout}"
    argv = ["--arch", "qwen3-0.6b", "--slots", str(SLOTS), "--policy",
            str(policy), "--elastic", "--policy-variants", ELASTIC_BUDGETS,
            "--requests", str(ELASTIC_REQUESTS), "--stagger",
            "--arrive-every", "1", "--kv-layout", layout]
    t0 = time.perf_counter()
    with elastic_probe(ops) as runs:
        res = _serve_cli(serve, argv)
    wall = time.perf_counter() - t0
    eng, sess, st = res["eng"], res["sess"], res["eng"].stats
    gate(len(runs) == 1, f"[{label}] {len(runs)} elastic engine runs")
    launches, packs = runs[0]["launches"], runs[0]["packs"]
    attn = "decode_attn_quant_paged" if layout == "paged" \
        else "decode_attn_quant"
    other = "decode_attn_quant" if layout == "paged" \
        else "decode_attn_quant_paged"
    per_variant = {pid: sorted(r) for pid, r in res["per_variant"].items()}
    gate(st.policy_swaps_down >= 1 and st.admissions_deferred_swap >= 1
         and len(per_variant) >= 2,
         f"[{label}] {st.policy_swaps_down} downshifts, "
         f"{st.admissions_deferred_swap} rounds held, variants serving "
         f"{per_variant}")
    gate(packs == 0, f"[{label}] {packs} pack_linear calls after the bank "
         "was built")
    gate(launches["quant_matmul"] > 0 and launches["quant_matmul_w4"] > 0
         and launches[attn] > 0 and launches[other] == 0,
         f"[{label}] the elastic run launched {launches}")
    for pid, counts in sess.variant_route_counts.items():
        gate(counts.eligible_fp == 0
             and set(counts.routes["decode_attn"]) <= {"fused"},
             f"[{label}] variant {pid}: {counts.eligible_fp} eligible "
             f"matmuls on dequant-fp, attention {counts.routes}")
    # each completion bit for bit its variant's single-policy packed engine,
    # and the run replayed on the dequant-fp routes bit for bit its fake-
    # quant reference; the served tokens against that reference on decisive
    # steps are printed (the kernels' exact sums part from it on near-ties)
    try:
        serve.check_trace(eng, f"[{label}]")
        with elastic_probe(ops) as replays:
            # over pages the reference engines feed only the printed
            # comparison: cut for the script's time limit
            checks = serve.check_elastic(res, dev,
                                         reference=layout == "ring")
    except SystemExit as e:
        raise GateError(f"[{label}] {e}") from e
    gate(len(replays) == (layout == "ring") and all(
        r["packs"] == 0 and not any(r["launches"].values()) for r in replays),
         f"[{label}] the replay on the dequant-fp routes: {replays}")
    lat = st.latency
    swap = eng.metrics.get("engine.swap_ms")
    step_p50 = variant_step_ms(eng.trace)
    vbytes = sess.variant_bytes()
    layout_obj = eng.layout if layout == "paged" else None
    variant_launches = {}
    for pid in sess.variants:
        sess.set_active(pid)
        variant_launches[pid] = step_launches(torch, ops, sess, dev,
                                              layout_obj)
    n_layers = len(res["bank"].layers)
    print(f"[{label}] {card}: {len(res['completions'])} requests in "
          f"{wall:.1f} s wall (bank build, the gates' engines included); "
          f"bank bytes {vbytes}; {st.policy_swaps} swaps "
          f"({st.policy_swaps_down} down), engine.swap_ms p50 "
          f"{swap.percentile(0.5):.3f} max {swap.percentile(1.0):.3f}; "
          f"{st.ilp_solves} admission re-solves ({n_layers} layers, "
          f"{res['controller'].bins} bins, on the host): ilp.solve_ms p50 "
          f"{lat['ilp_solve_p50_ms']:.2f} max {lat['ilp_solve_max_ms']:.2f}; "
          f"{st.admissions_deferred_swap} rounds held for drains; variants "
          f"serving {per_variant}; decode step p50 per variant "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(step_p50.items()))
          + f"; launches {launches}", flush=True)
    print(f"[{label}] served tokens vs the fake-quant reference on decisive "
          "steps (printed, not gated): " + ("; ".join(
              f"{pid} {c['decisive']} compared, parted on rids {c['parted']}"
              for pid, c in checks.items()) if layout == "ring" else
              "cut over pages for the script's time limit"), flush=True)
    print(f"[{label}] kernel launches in one decode step per variant: "
          f"{variant_launches}", flush=True)
    result = dict(
        wall_s=wall, variant_bytes=vbytes, policy_swaps=st.policy_swaps,
        policy_swaps_down=st.policy_swaps_down,
        swap_ms_p50=swap.percentile(0.5), swap_ms_max=swap.percentile(1.0),
        ilp_solves=st.ilp_solves, ilp_solve_p50_ms=lat["ilp_solve_p50_ms"],
        ilp_solve_max_ms=lat["ilp_solve_max_ms"], ilp_layers=n_layers,
        ilp_bins=res["controller"].bins,
        admissions_deferred_swap=st.admissions_deferred_swap,
        per_variant=per_variant, decode_step_p50_ms=step_p50,
        decode_step_p50_all_ms=lat["decode_step_p50_ms"],
        reference_decisive=checks, launches=launches,
        step_launches=variant_launches,
        avg_bits={pid: p.avg_bits()[0]
                  for pid, p in res["bank"].policies.items()})
    del res, eng, sess
    torch.cuda.empty_cache()
    return result


def serve_phase(torch, ops, dev):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.runtime.session import summarize

    cfg = get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    policy = serve.demo_mixed_policy(cfg)
    reqs = serve_requests(cfg)
    kw = dict(slots=SLOTS, cache_len=CACHE_LEN, prefill_chunk=PREFILL_CHUNK,
              device=dev)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"vocab={cfg.vocab}, init {time.perf_counter() - t0:.1f}s",
          flush=True)
    # warm-up (library loads, allocator, cuBLAS handles): one short request
    serve.serve_quantized(cfg, params, policy, reqs[:1], **dict(
        kw, slots=1))

    ops.reset_launches()                         # counts: the main path only
    t0 = time.perf_counter()
    sess, eng, out = serve.serve_quantized(cfg, params, policy, reqs, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.launches[k] for k in SERVE_KERNELS}
    st = eng.stats
    d = st.as_dict()
    print(f"[serve] ring KV: {len(out)} requests in {wall:.2f}s wall (packing "
          f"included): prefill p50 {d['prefill_p50_ms']:.2f} ms, decode step "
          f"p50 {d['decode_step_p50_ms']:.2f} ms, decode "
          f"{st.decode_tokens_per_s:.1f} tok/s ({st.decode_steps} steps, "
          f"{st.tokens_generated} tokens)", flush=True)
    print(f"[serve] launches {launches}; routes {sess.route_counts.routes}",
          flush=True)

    # (a) the path went through its kernels, none fell back to dequant-fp
    gate(all(launches[k] > 0 for k in RING_KERNELS)
         and launches["decode_attn_quant_paged"] == 0,
         f"ring serving launched {launches}")
    gate(sess.route_counts.eligible_fp == 0,
         f"{sess.route_counts.eligible_fp} kernel-eligible matmuls ran "
         "dequant-fp")
    gate(set(sess.route_counts.routes["decode_attn"]) == {"fused"},
         f"decode attention routes {sess.route_counts.routes['decode_attn']}")
    # output shape/range sanity
    for r in reqs:
        toks = out[r.rid].tokens
        gate(len(toks) == GEN and all(0 <= t < cfg.vocab for t in toks),
             f"request {r.rid}: bad tokens {toks[:8]}...")
    # (b) greedy tokens vs the fake-quant reference engine on decisive steps
    # (serve.check_greedy: the float32 reference confident and agreeing with
    # its own float64 evaluation)
    with ops.plain_on_cuda():           # the reference stays plain PyTorch
        compared, bad, unstable = serve.check_greedy(cfg, params, policy,
                                                     reqs, out, **kw)
    n_tok = sum(len(c.tokens) for c in out.values())
    print(f"[serve] greedy tokens vs fake-quant reference: {compared} of "
          f"{n_tok} steps decisive and compared, diverged rids {bad}; the "
          f"reference's float32 and float64 evaluations part on a confident "
          f"step in rids {unstable}", flush=True)
    gate(not bad, f"greedy tokens diverged on decisive steps: rids {bad}")
    gate(compared > 0, "no decisive step to compare")
    # (c) packed bytes vs the policy's accounting
    s = summarize(sess)
    print(f"[serve] packed weights {s['packed_bytes']} B vs policy "
          f"{s['policy_bytes']:.0f} B (x{s['packed_vs_policy']:.4f})",
          flush=True)
    gate(abs(s["packed_vs_policy"] - 1.0) <= 0.05,
         f"packed bytes off the policy accounting by x{s['packed_vs_policy']}")
    step = profile_decode_step(torch, sess, dev)
    return (reqs, out, eng), launches, dict(
        decode_step_profile=step, wall_s=wall,
        prefill_p50_ms=d["prefill_p50_ms"],
        decode_step_p50_ms=d["decode_step_p50_ms"],
        decode_tokens_per_s=st.decode_tokens_per_s,
        decode_steps=st.decode_steps, tokens=st.tokens_generated,
        prefill_tokens=st.prefill_tokens,
        decisive_compared=compared, reference_unstable_rids=unstable,
        packed_bytes=s["packed_bytes"], scale_bytes=s["scale_bytes"],
        policy_bytes=s["policy_bytes"]), (params, policy, sess)


def per_channel_phase(torch, ops, dev, params, policy, base_sess, base_res):
    """The serve phase's Qwen3-0.6B params and policy packed per channel
    (``QuantizedSession(per_channel=True)``) and served over the ring: its
    first wave, 4 requests of ``WAVE_GEN`` new tokens (module docstring,
    phase 22). ``base_sess`` is the serve phase's per-tensor session,
    ``base_res`` its results. Returns (launches, results)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.runtime import dispatch
    from repro_torch.runtime.session import QuantizedSession

    cfg = get_config("qwen3-0.6b")
    reqs = [r._replace(max_new=WAVE_GEN) for r in serve_requests(cfg)[:SLOTS]]
    t0 = time.perf_counter()
    sess = QuantizedSession(cfg, params, policy, base_sess.ctx,
                            per_channel=True)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    leaves = _packed_by_path(sess.params)
    base_leaves = _packed_by_path(base_sess.params)
    gate(len(leaves) == len(sess.qlayers) and leaves.keys() ==
         base_leaves.keys() and all(pl.per_channel for pl in leaves.values()),
         f"[per-channel] {len(leaves)} packed leaves, not all per channel")

    ops.reset_launches()                         # counts: the main path only
    eng, out, wall = packed_engine(torch, sess, dev, reqs)
    launches = {k: ops.launches[k] for k in SERVE_KERNELS}
    st = eng.stats
    d = st.as_dict()
    routes = sess.route_counts.routes
    print(f"[per-channel] {cfg.name}: {cfg.n_layers} layers, "
          f"{len(leaves)} projections packed per channel in {pack_s:.2f}s; "
          f"{len(out)} requests of {WAVE_GEN} new tokens in {wall:.2f}s "
          f"wall: prefill p50 {d['prefill_p50_ms']:.2f} ms, decode step p50 "
          f"{d['decode_step_p50_ms']:.2f} ms, {st.decode_tokens_per_s:.1f} "
          f"tok/s ({st.decode_steps} steps) beside the per-tensor serve "
          f"phase's {base_res['decode_step_p50_ms']:.2f} ms, "
          f"{base_res['decode_tokens_per_s']:.1f} tok/s (8 requests of "
          f"{GEN}); launches {launches}; routes {routes}", flush=True)
    # (a) every packed projection on dequant-fp, no matmul kernel launched,
    # decode attention fused: one launch a layer and decode step
    eqn = "btk,kn->btn"
    gate(all(dispatch.resolve(eqn, pl, dev) == "dequant-fp"
             for pl in leaves.values())
         and all(dispatch.kernel_eligible(eqn, base_leaves[k]) is not None
                 for k in leaves),
         "[per-channel] a per-channel projection resolves to a kernel, or "
         "its per-tensor twin does not")
    gate(set(routes["matmul"]) == {"dequant-fp"}
         and sess.route_counts.eligible_fp == 0
         and set(routes["decode_attn"]) == {"fused"},
         f"[per-channel] routes {routes}, {sess.route_counts.eligible_fp} "
         "eligible on dequant-fp")
    gate(launches["quant_matmul"] == 0 and launches["quant_matmul_w4"] == 0
         and launches["decode_attn_quant"] == cfg.n_layers * st.decode_steps
         and launches["decode_attn_quant_paged"] == 0,
         f"[per-channel] launches {launches}, expected no matmul kernel and "
         f"{cfg.n_layers} x {st.decode_steps} decode attention")
    for r in reqs:
        toks = out[r.rid].tokens
        gate(len(toks) == WAVE_GEN and all(0 <= t < cfg.vocab for t in toks),
             f"[per-channel] request {r.rid}: bad tokens {toks[:8]}...")
    # (b) the statistics scales saturate nothing (tests/test_health.py's
    # oracle)
    sat = max(h["saturation_rate"] for h in sess.pack_health.values())
    util = max(h["scale_utilization"] for h in sess.pack_health.values())
    base_sat = max(h["saturation_rate"]
                   for h in base_sess.pack_health.values())
    gate(len(sess.pack_health) == len(leaves) and sat == 0.0
         and util <= 1.0 + 1e-6,
         f"[per-channel] pack health: saturation max {sat}, scale "
         f"utilization max {util}")
    # (c) the same code bytes as the per-tensor pack: only the scales differ
    pb, sb = sess.packed_bytes(), sess.scale_bytes()
    gate(pb == base_res["packed_bytes"],
         f"[per-channel] packed code bytes {pb} != the per-tensor "
         f"session's {base_res['packed_bytes']}")
    # the squared dequantization error of both trees against the float32
    # weights (printed)
    err = {"per_channel": 0.0, "per_tensor": 0.0}
    for site in sess.sites:
        src = lm.site_params(params, site)
        key = lm.site_key(site.gidx)
        for q in sess.qlayers:
            if (q.segment, q.unit) != (site.segment, site.unit):
                continue
            w = src
            for k in q.path:
                w = w[k]
            w = w["w"].to(torch.float64)
            path = "/".join(("sites", key) + q.path)
            for name, pl in (("per_channel", leaves[path]),
                             ("per_tensor", base_leaves[path])):
                err[name] += float(((pl.dequant().to(torch.float64) - w)
                                    ** 2).sum())
    print(f"[per-channel] pack health: saturation max {sat} (per-tensor "
          f"{base_sat:.3e}), scale utilization max {util:.6f}; code bytes "
          f"{pb} (the per-tensor session's); scale bytes {sb} (per-tensor "
          f"{base_res['scale_bytes']}); summed squared dequantization error "
          f"{err['per_channel']:.6e} per channel, {err['per_tensor']:.6e} "
          f"per tensor", flush=True)
    # (d) the same session on the kernels' plain versions: the same greedy
    # tokens on every decisive step of it (top-2 margin above 1e-2)
    with ops.plain_on_cuda(), fresh_route_counts(sess):
        p_eng, p_out, _ = packed_engine(torch, sess, dev, reqs)
    same, total, compared, bad = serve.compare_spec(out, p_eng, p_out)
    print(f"[per-channel] greedy tokens vs the same session on the plain "
          f"versions: {same} of {total} equal, {compared} "
          f"decisive steps compared, parted on rids {bad}", flush=True)
    gate(not bad and compared > 0,
         f"[per-channel] greedy tokens part from the plain run on a decisive "
         f"step: rids {bad} ({compared} compared)")
    step = profile_decode_step(torch, sess, dev, label="per-channel")
    res = dict(pack_s=pack_s, wall_s=wall,
               prefill_p50_ms=d["prefill_p50_ms"],
               decode_step_p50_ms=d["decode_step_p50_ms"],
               decode_tokens_per_s=st.decode_tokens_per_s,
               decode_steps=st.decode_steps, routes=routes,
               saturation_max=sat, scale_utilization_max=util,
               per_tensor_saturation_max=base_sat, packed_bytes=pb,
               scale_bytes=sb, per_tensor_scale_bytes=base_res["scale_bytes"],
               dequant_sq_err=err, tokens_equal=same,
               decisive_compared=compared, decode_step_profile=step)
    del sess, eng, p_eng
    torch.cuda.empty_cache()
    return launches, res


def paged_serve_phase(torch, ops, dev, ring_prefill_tokens):
    """The serve phase's requests with their first SHARED_PREFIX tokens made
    the same, over pooled int8 pages (``kv_layout="paged"``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_config("qwen3-0.6b")
    params = lm.init_params(cfg, seed=0, device=dev)
    policy = serve.demo_mixed_policy(cfg)
    reqs = paged_requests(cfg)
    kw = dict(slots=SLOTS, cache_len=CACHE_LEN, prefill_chunk=PREFILL_CHUNK,
              device=dev)
    paged = dict(kv_layout="paged", page_size=PAGE_SIZE)
    serve.serve_quantized(cfg, params, policy, reqs[:1],       # warm-up
                          **dict(kw, slots=1), **paged)

    ops.reset_launches()                         # counts: the main path only
    t0 = time.perf_counter()
    sess, eng, out = serve.serve_quantized(cfg, params, policy, reqs, **kw,
                                           **paged)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.launches[k] for k in SERVE_KERNELS}
    st = eng.stats
    d = st.as_dict()
    print(f"[paged] {len(out)} requests sharing {SHARED_PREFIX} prompt tokens "
          f"in {wall:.2f}s wall (packing included): prefill p50 "
          f"{d['prefill_p50_ms']:.2f} ms, decode step p50 "
          f"{d['decode_step_p50_ms']:.2f} ms, decode "
          f"{st.decode_tokens_per_s:.1f} tok/s ({st.decode_steps} steps, "
          f"{st.tokens_generated} tokens); prefill {st.prefill_tokens} tokens "
          f"(ring phase {ring_prefill_tokens}), prefix hits "
          f"{st.prefix_hit_tokens} tokens, {st.kv_unique_pages} of "
          f"{eng.pool.n_pages} pages in use, {st.prefill_compiles} chunk "
          f"shape(s)", flush=True)
    print(f"[paged] launches {launches}; routes {sess.route_counts.routes}",
          flush=True)
    per_step = cfg.n_layers * st.decode_steps
    gate(launches["decode_attn_quant_paged"] == per_step
         and launches["decode_attn_quant"] == 0
         and all(launches[k] > 0 for k in PAGED_KERNELS),
         f"paged serving launched {launches}, expected "
         f"decode_attn_quant_paged {cfg.n_layers} x {st.decode_steps} steps "
         "and no decode_attn_quant")
    gate(sess.route_counts.eligible_fp == 0,
         f"{sess.route_counts.eligible_fp} kernel-eligible matmuls ran "
         "dequant-fp")
    gate(set(sess.route_counts.routes["decode_attn"]) == {"fused"},
         f"decode attention routes {sess.route_counts.routes['decode_attn']}")
    for r in reqs:
        toks = out[r.rid].tokens
        gate(len(toks) == GEN and all(0 <= t < cfg.vocab for t in toks),
             f"request {r.rid}: bad tokens {toks[:8]}...")
    gate(st.prefix_hit_tokens > 0 and st.prefill_tokens < ring_prefill_tokens,
         f"prefix hits {st.prefix_hit_tokens} tokens, prefilled "
         f"{st.prefill_tokens} (ring phase {ring_prefill_tokens})")
    eng.pool.check()
    gate(all(s is None for s in eng.slots), "occupied slots after the drain")
    with ops.plain_on_cuda():           # the reference stays plain PyTorch
        compared, bad, unstable = serve.check_greedy(cfg, params, policy,
                                                     reqs, out, **kw)
    n_tok = sum(len(c.tokens) for c in out.values())
    print(f"[paged] greedy tokens vs fake-quant reference (ring): {compared} "
          f"of {n_tok} steps decisive and compared, diverged rids {bad}; the "
          f"reference's float32 and float64 evaluations part on a confident "
          f"step in rids {unstable}", flush=True)
    gate(not bad, f"paged greedy tokens diverged on decisive steps: rids {bad}")
    gate(compared > 0, "no decisive step to compare")
    step = profile_decode_step(torch, sess, dev, "paged", eng.layout)
    return (reqs, out, eng), launches, dict(
        decode_step_profile=step, wall_s=wall,
        prefill_p50_ms=d["prefill_p50_ms"],
        decode_step_p50_ms=d["decode_step_p50_ms"],
        decode_tokens_per_s=st.decode_tokens_per_s,
        decode_steps=st.decode_steps, tokens=st.tokens_generated,
        prefill_tokens=st.prefill_tokens,
        ring_prefill_tokens=ring_prefill_tokens,
        prefix_hit_tokens=st.prefix_hit_tokens,
        prefill_flops_saved=st.prefill_flops_saved,
        kv_unique_pages=st.kv_unique_pages, n_pages=eng.pool.n_pages,
        prefill_compiles=st.prefill_compiles,
        admissions_deferred_pool=st.admissions_deferred_pool,
        decisive_compared=compared, reference_unstable_rids=unstable)


@contextlib.contextmanager
def spec_probe(torch, ops, guard_syncs=True):
    """Watch every speculative round of the engines run inside: each round
    under ``set_sync_debug_mode("error")`` (gate (c)); per verify pass the
    kernel launches it made (gate (b)); the draft steps of each round; and
    each verify pass's drafts, positions, targets, margins and accepted
    counts, as device tensors read after the run."""
    from repro_torch.launch.engine import DecodeEngine as E
    fused, verify, draft = E._spec_fused, E._spec_verify_fn, \
        E._spec_draft_body
    rec = dict(verify=[], draft_steps=[], rounds=[])

    def fused_(self, *a):
        if not guard_syncs:
            return fused(self, *a)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fused(self, *a)
        except RuntimeError as e:
            raise GateError(f"a speculative round synchronised the host: "
                            f"{e}") from e
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def verify_(self, tok, drafts, pos, remaining, state):
        n0 = dict(ops.launches)
        out = verify(self, tok, drafts, pos, remaining, state)
        rec["verify"].append({k: ops.launches[k] - n0[k] for k in n0})
        rec["rounds"].append((drafts, pos, out[0], out[1], out[2]))
        return out

    def draft_(self, steps, *a):
        rec["draft_steps"].append(steps)
        return draft(self, steps, *a)

    E._spec_fused, E._spec_verify_fn, E._spec_draft_body = \
        fused_, verify_, draft_
    try:
        yield rec
    finally:
        E._spec_fused, E._spec_verify_fn, E._spec_draft_body = \
            fused, verify, draft


def spec_serve_phase(torch, ops, dev, layout, base):
    """The first wave of the serve phase's requests (``layout`` "ring") or
    the paged phase's (``layout`` "paged") decoded self-speculatively.
    ``base`` is that phase's (requests, completions, engine)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    label = f"spec-{layout}"
    reqs, base_out, base_eng = base
    # the token-at-a-time phase's first wave, one request a slot into fresh
    # caches, each to WAVE_GEN new tokens held to the first WAVE_GEN of its
    # run's (8 requests of GEN before the mixtral phase: the script's time
    # limit)
    reqs = [r._replace(max_new=WAVE_GEN) for r in reqs[:SLOTS]]
    base_out = {rid: dataclasses.replace(c, tokens=c.tokens[:WAVE_GEN])
                for rid, c in base_out.items()}
    rids = {r.rid for r in reqs}
    paged_hits = sum(ev.args["tokens"] for ev in base_eng.trace.events
                     if ev.name == "prefix_hit" and ev.args["rid"] in rids)
    print(f"[{label}] cut: the first wave, {len(reqs)} requests of "
          f"{WAVE_GEN} new tokens (8 of {GEN} before the mixtral phase; the "
          "script's time limit)", flush=True)
    cfg = get_config("qwen3-0.6b")
    params = lm.init_params(cfg, seed=0, device=dev)
    policy = serve.demo_mixed_policy(cfg)
    kw = dict(slots=SLOTS, cache_len=CACHE_LEN, prefill_chunk=PREFILL_CHUNK,
              device=dev, kv_layout=layout, page_size=PAGE_SIZE,
              speculate=SPEC_K, draft_bits=DRAFT_BITS)
    # no warm-up of its own (cut for the time limit): the serve phases
    # before it loaded the kernels and warmed the allocator and cuBLAS
    ops.reset_launches()                         # counts: the main path only
    with spec_probe(torch, ops) as rec:
        t0 = time.perf_counter()
        sess, eng, out = serve.serve_quantized(cfg, params, policy, reqs,
                                               **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: ops.launches[k] for k in SERVE_KERNELS}
    st, bst = eng.stats, base_eng.stats
    d, bd = st.as_dict(), bst.as_dict()
    paged = layout == "paged"
    one = "decode_attn_quant_paged" if paged else "decode_attn_quant"
    name = "verify_attn_quant_paged" if paged else "verify_attn_quant"
    others = [k for k in ("decode_attn_quant", "decode_attn_quant_paged",
                          "verify_attn_quant", "verify_attn_quant_paged")
              if k not in (one, name)]
    emitted = st.tokens_generated - st.completed     # first tokens: prefill
    print(f"[{label}] {len(out)} requests in {wall:.2f}s wall (two packs "
          f"included): {st.spec_rounds} rounds of k={SPEC_K}, accept rate "
          f"{st.spec_accept_rate:.4f} ({st.spec_accepted_tokens} of "
          f"{st.spec_draft_tokens} drafts), {emitted / st.slot_steps:.3f} "
          f"tokens per slot and round; decode {st.decode_tokens_per_s:.1f} "
          f"tok/s, round p50 {d['decode_step_p50_ms']:.2f} ms against the "
          f"token-at-a-time phase's {bst.decode_tokens_per_s:.1f} tok/s, "
          f"step p50 {bd['decode_step_p50_ms']:.2f} ms ({bst.decode_steps} "
          f"steps); draft pack {sess.draft_bytes()} B beside "
          f"{sess.packed_bytes()} B", flush=True)
    print(f"[{label}] launches {launches}; draft steps "
          f"{sum(rec['draft_steps'])}", flush=True)
    # (b) one verify launch per layer and round, no one-token launch inside
    # the verify pass; the draft steps launch the one-token kernel
    gate(st.spec_rounds == len(rec["verify"]) > 0,
         f"{st.spec_rounds} rounds, {len(rec['verify'])} verify passes")
    gate(all(v[name] == cfg.n_layers and v[one] == 0 for v in rec["verify"]),
         f"verify passes launched {rec['verify'][:3]}..., expected "
         f"{cfg.n_layers} x {name} and no {one}")
    gate(launches[name] == cfg.n_layers * st.spec_rounds
         and launches[one] == cfg.n_layers * sum(rec["draft_steps"])
         and all(launches[k] == 0 for k in others)
         and launches["quant_matmul"] > 0
         and launches["quant_matmul_w4"] > 0,
         f"{label} launched {launches}")
    gate(sess.route_counts.eligible_fp == 0,
         f"{sess.route_counts.eligible_fp} kernel-eligible matmuls ran "
         "dequant-fp")
    gate(set(sess.route_counts.routes["decode_attn"]) == {"fused"},
         f"decode attention routes {sess.route_counts.routes['decode_attn']}")
    gate(set(out) == rids, f"served rids {sorted(out)}, expected "
         f"{sorted(rids)}")
    for r in reqs:
        toks = out[r.rid].tokens
        gate(len(toks) == WAVE_GEN and all(0 <= t < cfg.vocab for t in toks),
             f"request {r.rid}: bad tokens {toks[:8]}...")
    # (a) the token-at-a-time phase's tokens on its decisive steps
    same, total, compared, bad = serve.compare_spec(out, base_eng, base_out)
    print(f"[{label}] tokens vs the token-at-a-time phase: {same} of {total} "
          f"identical, {compared} decisive steps compared, differing rids "
          f"{bad}", flush=True)
    gate(not bad and compared > 0,
         f"speculative tokens differ on a decisive step: rids {bad}")
    gate(all(s is None for s in eng.slots), "occupied slots after the drain")
    if paged:                                                      # (d)
        eng.pool.check()
        gate(st.prefix_hit_tokens == paged_hits,
             f"prefix hits {st.prefix_hit_tokens} tokens, the paged "
             f"phase's first wave {paged_hits}")
    return launches, dict(
        wall_s=wall, rounds=st.spec_rounds, accept_rate=st.spec_accept_rate,
        drafted=st.spec_draft_tokens, accepted=st.spec_accepted_tokens,
        tokens_per_slot_round=emitted / st.slot_steps,
        decode_tokens_per_s=st.decode_tokens_per_s,
        round_p50_ms=d["decode_step_p50_ms"],
        base_decode_tokens_per_s=bst.decode_tokens_per_s,
        base_step_p50_ms=bd["decode_step_p50_ms"],
        identical_tokens=same, tokens=total, decisive_compared=compared,
        draft_bytes=sess.draft_bytes(), packed_bytes=sess.packed_bytes(),
        prefix_hit_tokens=st.prefix_hit_tokens,
        draft_steps=sum(rec["draft_steps"]))


def _engine_pair(sess, cfg, dev, layout):
    from repro_torch.launch.engine import DecodeEngine, EngineConfig

    def make(k):
        return DecodeEngine(sess.params, cfg, None, sess.ctx, adapter=sess,
                            device=dev, ecfg=EngineConfig(
                                slots=1, cache_len=CACHE_LEN,
                                prefill_chunk=PREFILL_CHUNK, kv_quant="int8",
                                kv_layout=layout, page_size=PAGE_SIZE,
                                speculate=k))
    return make(SPEC_K), make(0)


def _spec_until_rejection(spec, req):
    """Admit ``req`` into the one-slot speculative engine ``spec`` and run
    at least four rounds, then on until a draft was rejected (so a rollback
    cut rows) or one more round could finish the request. Returns the live
    slot."""
    spec.submit(req)
    now = 0
    while True:
        spec.step(now)       # the first step admits, then each is a round
        now += 1
        slot = spec.slots[0]
        gate(slot is not None and not slot.done, "request done too early")
        if now >= 4 and (slot.spec_accepted < slot.spec_drafted
                         or len(slot.gen) + SPEC_K + 1 >= req.max_new):
            return slot


def midflight_check(torch, dev, reqs, sess=None, label="midflight"):
    """One request, one slot, at full width: after at least four
    speculative rounds, one of which rejected a draft, the KV state is the
    token-at-a-time engine's at the same generated length, bit for bit (pos
    exactly, so every rolled-back row is unwritten there too; codes and
    scales on valid rows), on both layouts. The prompt is the first of
    ``reqs`` (the serve phase's) whose drafts get rejected before the slot
    could finish: a draft that is never rejected rolls nothing back. Rows
    are compared up to the first generated token where the two engines part
    (if they part at all: only on a near-tie of the head, whose float32
    GEMM over S rows may round otherwise). ``sess`` is the speculative
    session to check (Qwen3-0.6B's under ``demo_mixed_policy`` when
    None)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.runtime.kv_cache import PagedKVCache
    from repro_torch.runtime.session import SpecSession

    if sess is None:
        cfg = get_config("qwen3-0.6b")
        params = lm.init_params(cfg, seed=0, device=dev)
        sess = SpecSession(cfg, params, serve.demo_mixed_policy(cfg),
                           serve.make_context(cfg), draft_w_bits=DRAFT_BITS)
    cfg = sess.cfg
    res = {}
    for layout in ("ring", "paged"):
        for req in reqs:
            spec, base = _engine_pair(sess, cfg, dev, layout)
            slot = _spec_until_rejection(spec, req)
            if slot.spec_accepted < slot.spec_drafted:
                break
        gate(slot.spec_accepted < slot.spec_drafted,
             f"{label} ({layout}): no request of {len(reqs)} had a draft "
             "rejected, so no rollback was exercised")
        plen = len(req.tokens)
        g = len(slot.gen)
        base.submit(req)
        now = 0
        while base.slots[0] is None or len(base.slots[0].gen) < g:
            base.step(now)
            now += 1
        bgen = base.slots[0].gen[:g]
        n_same = next((i for i, (a, b) in enumerate(zip(slot.gen, bgen))
                       if a != b), g)
        # row t holds the KV of the token fed at t: the prompt's, then
        # gen[t - plen]; rows below plen + n_same saw the same inputs
        limit = plen + n_same
        diffs = []
        for key in spec.state["sites"]:
            a, b = spec.state["sites"][key], base.state["sites"][key]
            if isinstance(a, PagedKVCache):
                a, b = a.gather(), b.gather()
            rows = (a.pos < limit) | (b.pos < limit)
            if not torch.equal(a.pos[rows], b.pos[rows]):
                diffs.append((key, "pos"))
                continue
            m = rows & (a.pos >= 0)
            for f in ("k", "v", "k_scale", "v_scale"):
                x, y = getattr(a, f)[m], getattr(b, f)[m]
                if not torch.equal(x, y):
                    bad_rows = (x != y).reshape(x.shape[0], -1).any(dim=1)
                    first = int(a.pos[m][bad_rows].min())
                    diffs.append((key, f, int(bad_rows.sum()), first))
        res[layout] = dict(rid=req.rid, generated=g, identical_tokens=n_same,
                           rows_compared=limit, differing=diffs[:8],
                           rounds=spec.stats.spec_rounds,
                           drafted=slot.spec_drafted,
                           accepted=slot.spec_accepted)
        print(f"[{label}] {layout}: request {req.rid}, "
              f"{spec.stats.spec_rounds} rounds, {g} tokens "
              f"({slot.spec_accepted} of {slot.spec_drafted} drafts "
              f"accepted), {n_same} identical with the token-at-a-time "
              f"engine; KV rows below position {limit} of {cfg.n_layers} "
              "layers "
              + ("bit for bit equal" if not diffs else
                 f"DIFFER: {diffs[:8]}"), flush=True)
        gate(not diffs, f"{label} KV ({layout}) differs from the "
             f"token-at-a-time engine's: (layer, field, rows, first "
             f"position) {diffs[:8]}")
    return res


def self_draft_check(torch, ops, dev, reqs):
    """A target policy at the draft's own width packs the draft's tree, so
    every draft on a decisive step (the target's top-2 margin above 1e-2 at
    the rejected position) must be accepted."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MPQPolicy
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_config("qwen3-0.6b")
    params = lm.init_params(cfg, seed=0, device=dev)
    demo = serve.demo_mixed_policy(cfg)
    policy = MPQPolicy({n: DRAFT_BITS for n in demo.w_bits},
                       dict(demo.a_bits), meta={"kind": "uniform-draft"})
    with spec_probe(torch, ops, guard_syncs=False) as rec:
        _, eng, _ = serve.serve_quantized(
            cfg, params, policy, reqs[:2], slots=2, cache_len=CACHE_LEN,
            prefill_chunk=PREFILL_CHUNK, device=dev, speculate=SPEC_K,
            draft_bits=DRAFT_BITS)
    rejected = decisive = 0
    for drafts, pos, _, margins, acc in rec["rounds"]:
        k = drafts.shape[1]
        p, m, a = pos.cpu().numpy(), margins.cpu().numpy(), \
            acc.cpu().numpy()
        for b in np.flatnonzero(p >= 0):
            if a[b] < k:
                rejected += 1
                decisive += int(m[b, a[b]] > 1e-2)
    st = eng.stats
    print(f"[self-draft] target at the draft's {DRAFT_BITS} bits: accept "
          f"rate {st.spec_accept_rate:.4f} ({st.spec_accepted_tokens} of "
          f"{st.spec_draft_tokens}) over {st.spec_rounds} rounds; "
          f"{rejected} rejections, {decisive} on a decisive step",
          flush=True)
    gate(st.spec_draft_tokens > 0 and decisive == 0,
         f"self-draft: {decisive} drafts rejected on a decisive step")
    return dict(accept_rate=st.spec_accept_rate, rounds=st.spec_rounds,
                drafted=st.spec_draft_tokens,
                accepted=st.spec_accepted_tokens, rejected=rejected,
                rejected_decisive=decisive)


@contextlib.contextmanager
def obs_cost_probe():
    """Host seconds spent in the trace recorder, the KV-scale sampler, the
    monitor and the publishing of the dispatch route counters while the
    block runs (each function wrapped in a clock)."""
    from repro_torch.obs import health, monitor, trace
    from repro_torch.runtime import dispatch
    spent = {"trace": 0.0, "kv_drift": 0.0, "monitor": 0.0, "routes": 0.0}
    saved = []
    for cls, name, key in ((trace.TraceRecorder, "instant", "trace"),
                           (trace.TraceRecorder, "span", "trace"),
                           (health.KVScaleDrift, "update", "kv_drift"),
                           (health.KVScaleDrift, "publish", "kv_drift"),
                           (monitor.Monitor, "check", "monitor"),
                           (dispatch, "publish_routes", "routes")):
        fn = getattr(cls, name)
        saved.append((cls, name, fn))

        def timed(*a, _fn=fn, _key=key, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                spent[_key] += time.perf_counter() - t0
        setattr(cls, name, timed)
    try:
        yield spent
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def _serve_cli(serve, argv):
    """``repro_torch.launch.serve.main(argv)``; its refusals are gates."""
    try:
        return serve.main(argv)
    except SystemExit as e:
        raise GateError(f"serve {' '.join(argv)}: {e}") from e


def _prom_mismatches(export, text, registry):
    """Parse a Prometheus dump back; returns (samples, [registry series
    whose value, or histogram count and sum, it does not carry])."""
    samples = export.samples_as_dict(export.parse_prometheus_text(text))
    bad = []
    for name, v in registry.snapshot().items():
        key = export.prom_name(name)
        if isinstance(v, dict):                     # histogram
            pairs = [(samples.get(key + "_count"), v["count"]),
                     (samples.get(key + "_sum"), v["sum"])]
        else:                                       # gauge, or counter
            pairs = [(samples.get(key, samples.get(key + "_total")), v)]
        if any(got is None or not math.isclose(got, want, rel_tol=1e-12)
               for got, want in pairs):
            bad.append(name)
    return samples, bad


def serve_cli_phase(torch, ops, dev, card):
    """The serve CLI (``launch.serve.main``) at Qwen3-0.6B full width over
    its own staggered requests (module docstring, phase 9): the ring with
    ``--compare`` and every artifact, again under the device table that run
    measured, again with the trace off, then paged and speculative."""
    from repro_torch.launch import serve
    from repro_torch.obs import export, trace

    out = ROOT / "chiprun_out" / "serve_cli"
    out.mkdir(parents=True, exist_ok=True)
    shape = ["--arch", "qwen3-0.6b", "--slots", str(SLOTS), "--prompt-len",
             str(max(PROMPTS)), "--gen", str(GEN), "--cache-len",
             str(CACHE_LEN), "--stagger"]
    base = shape + ["--requests", str(len(PROMPTS))]
    res = {}

    # 1. ring, --compare, every artifact, the auto prefill chunk
    ops.reset_launches()                         # counts: this run only
    with obs_cost_probe() as spent:
        ring = _serve_cli(serve, base + [
            "--compare", "--trace-out", str(out / "trace.json"),
            "--metrics-out", str(out / "metrics.json"),
            "--metrics-stream", str(out / "stream.jsonl")])
    launches = {k: ops.launches[k] for k in SERVE_KERNELS}
    eng, st = ring["eng"], ring["eng"].stats
    # the observability's own host time, over both runs of --compare
    steps = st.decode_steps + ring["fixed"].stats.decode_steps
    obs_us = {k: v / steps * 1e6 for k, v in spent.items()}
    gate(all(launches[k] > 0 for k in RING_KERNELS)
         and launches["decode_attn_quant_paged"] == 0,
         f"[cli] the ring run launched {launches}")
    gate(16 <= eng.prefill_chunk <= 512 and eng.ecfg.prefill_chunk == 0,
         f"[cli] auto prefill chunk {eng.prefill_chunk}")
    rec = trace.TraceRecorder.from_chrome(str(out / "trace.json"))
    problems = trace.validate_chrome(json.loads(
        (out / "trace.json").read_text())) + trace.reconcile(rec,
                                                             st.as_dict())
    gate(not problems, f"[cli] the written trace: {problems}")
    cal = ring["calibration"]
    gate(cal["finite"] and all(r["measured_s"] > 0 and r["modeled_s"] > 0
                               for r in cal["rows"]),
         f"[cli] calibration rows {cal['rows']}")
    # with these 8 requests the staggered lengths put the longest last and
    # continuous batching takes more decode steps than fixed, in the
    # reference engine too: the gate holds the counts to the reference's
    gate((st.decode_steps, ring["fixed"].stats.decode_steps)
         == REF_CLI_STEPS.get(eng.prefill_chunk),
         f"[cli] {st.decode_steps} continuous and "
         f"{ring['fixed'].stats.decode_steps} fixed decode steps at chunk "
         f"{eng.prefill_chunk}; the reference engine takes {REF_CLI_STEPS}")
    snaps = export.read_jsonl_snapshots(str(out / "stream.jsonl"))
    gate(len(snaps) >= 2, f"[cli] {len(snaps)} metrics snapshots")
    samples, bad = _prom_mismatches(
        export, (out / "stream.jsonl.prom").read_text(), eng.metrics)
    gate(not bad, f"[cli] the Prometheus dump differs from the registry "
         f"on {bad[:4]}")
    d = st.as_dict()
    print(f"[cli] ring: auto prefill chunk {eng.prefill_chunk}; decode step "
          f"p50 {d['decode_step_p50_ms']:.2f} ms (trace on), "
          f"{st.decode_steps} steps vs {ring['fixed'].stats.decode_steps} "
          f"fixed ({ring['saved']} saved); {len(rec.events)} trace events; "
          f"{len(snaps)} snapshots; {len(samples)} Prometheus series; "
          f"launches {launches}", flush=True)
    table = dict(cal["device_table"], card=card)
    (out / "device_table.json").write_text(json.dumps(
        {"device_table": table}, indent=1))
    print(f"[cli] measured device table ({card}): hbm_bytes_s="
          f"{table['hbm_bytes_s']:.4e} peak_flops={table['peak_flops']:.4e}",
          flush=True)
    tokens = {r: c.tokens for r, c in ring["completions"].items()}
    res["ring"] = dict(
        prefill_chunk=eng.prefill_chunk, launches=launches,
        decode_step_p50_ms=d["decode_step_p50_ms"],
        prefill_p50_ms=d["prefill_p50_ms"],
        decode_tokens_per_s=st.decode_tokens_per_s,
        decode_steps=st.decode_steps,
        fixed_decode_steps=ring["fixed"].stats.decode_steps,
        saved=ring["saved"], trace_events=len(rec.events),
        snapshots=len(snaps), alerts=eng.monitor.as_dicts(),
        calibration=cal["rows"], device_table=table,
        obs_host_us_per_step=obs_us)
    print(f"[cli] host time of the observability per decode step: "
          + ", ".join(f"{k} {v:.1f} us" for k, v in obs_us.items()),
          flush=True)
    del ring, eng
    torch.cuda.empty_cache()

    # 2. the trace's cost: the same run untraced (on, off; the repeats on,
    # off, off, on against the host's drift within a call, and the fixed
    # schedule's rerun are cut for the script's time limit)
    p50 = {"on": [res["ring"]["decode_step_p50_ms"]], "off": []}
    for mode in ("off",):
        run = _serve_cli(serve, base + (
            ["--no-trace"] if mode == "off" else []))
        gate((run["eng"].trace is None) == (mode == "off") and {
            r: c.tokens for r, c in run["completions"].items()} == tokens,
            f"[cli] the run with the trace {mode} gave other tokens")
        p50[mode].append(run["eng"].stats.as_dict()["decode_step_p50_ms"])
        del run
        torch.cuda.empty_cache()
    print(f"[cli] decode step p50, trace on / off: {p50['on'][0]:.2f} / "
          f"{p50['off'][0]:.2f} ms ({card}; cut: the off / on repeats, for "
          "the script's time limit)", flush=True)
    res["trace_on_off"] = dict(order=["on", "off"], decode_step_p50_ms=p50)

    # 3. the same, budgeted on the measured table: only the chunk moves
    # (the fixed schedule's rerun cut for the script's time limit)
    cal_run = _serve_cli(serve, base + [
        "--chip-table", str(out / "device_table.json")])
    ceng = cal_run["eng"]
    ctoks = {r: c.tokens for r, c in cal_run["completions"].items()}
    gate(ctoks == tokens, "[cli] tokens under the measured table differ from "
         "the default chip's")
    cd = ceng.stats.as_dict()
    print(f"[cli] calibrated: prefill chunk {ceng.prefill_chunk} (default "
          f"{res['ring']['prefill_chunk']}); tokens equal the default "
          f"chip's; decode step p50 {cd['decode_step_p50_ms']:.2f} ms "
          f"(trace on)", flush=True)
    res["calibrated"] = dict(
        prefill_chunk=ceng.prefill_chunk,
        default_prefill_chunk=res["ring"]["prefill_chunk"],
        decode_step_p50_ms=cd["decode_step_p50_ms"],
        decode_steps=ceng.stats.decode_steps)
    del cal_run, ceng
    torch.cuda.empty_cache()

    # 4. paged pages with a shared prefix, speculating over the demo
    # policy written by the CLI (speculation takes a policy file)
    policy = str(out / "demo_policy.json")
    gate(_serve_cli(serve, ["--arch", "qwen3-0.6b", "--write-demo-policy",
                            policy]) is None, "[cli] --write-demo-policy")
    ops.reset_launches()
    with spec_probe(torch, ops) as probe:
        spec = _serve_cli(serve, base + [
            "--policy", policy,
            "--kv-layout", "paged", "--speculate", str(SPEC_K),
            "--draft-bits", str(DRAFT_BITS),
            "--trace-out", str(out / "spec_trace.jsonl")])
    launches = {k: ops.launches[k] for k in SERVE_KERNELS}
    seng, sst = spec["eng"], spec["eng"].stats
    n_layers = seng.cfg.n_layers
    serve.check_trace(seng, "[cli] paged speculative")
    events = trace.TraceRecorder.from_jsonl(
        str(out / "spec_trace.jsonl")).events
    n_verify = sum(e.name == "spec_verify" for e in events)
    hits = [e for e in events if e.name == "prefix_hit"]
    accept = seng.metrics.get("spec.accept_len")
    gate(n_verify == sst.spec_rounds == len(probe["verify"]) > 0,
         f"[cli] {n_verify} spec_verify instants, {sst.spec_rounds} rounds")
    gate(hits and sum(e.args["tokens"] for e in hits)
         == sst.prefix_hit_tokens > 0,
         f"[cli] prefix_hit events {len(hits)}, {sst.prefix_hit_tokens} "
         "tokens")
    gate(accept.count == sst.slot_steps and accept.sum ==
         sst.spec_accepted_tokens,
         f"[cli] spec.accept_len: {accept.count} observations over "
         f"{sst.slot_steps} live slot-rounds")
    gate(launches["verify_attn_quant_paged"] == n_layers * sst.spec_rounds
         and launches["decode_attn_quant_paged"] > 0
         and launches["decode_attn_quant"] == 0
         and launches["verify_attn_quant"] == 0,
         f"[cli] the paged speculative run launched {launches}")
    spans = [e for e in events if e.name == "spec_draft"]
    sd = sst.as_dict()
    print(f"[cli] paged speculative: {sst.spec_rounds} rounds, accept rate "
          f"{sst.spec_accept_rate:.4f}, round p50 "
          f"{sd['decode_step_p50_ms']:.2f} ms (draft part p50 "
          f"{statistics.median(e.dur for e in spans) * 1e3:.2f} ms, device "
          f"events), prefill chunk {seng.prefill_chunk}, "
          f"{len(hits)} prefix hits; launches {launches}", flush=True)
    res["paged_spec"] = dict(
        prefill_chunk=seng.prefill_chunk, rounds=sst.spec_rounds,
        accept_rate=sst.spec_accept_rate,
        round_p50_ms=sd["decode_step_p50_ms"],
        draft_p50_ms=statistics.median(e.dur for e in spans) * 1e3,
        prefix_hit_tokens=sst.prefix_hit_tokens, launches=launches,
        trace_events=len(events))
    del spec, seng
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def plain_matmuls(ops):
    """Both matmul wrappers replaced by their plain versions for the scope
    (the packed dispatch looks them up on ``ops`` at each call); nothing
    is launched or counted."""
    from repro_torch.kernels import ref
    saved = ops.quant_matmul, ops.quant_matmul_w4
    ops.quant_matmul, ops.quant_matmul_w4 = (ref.quant_matmul_ref,
                                             ref.quant_matmul_w4_ref)
    try:
        yield
    finally:
        ops.quant_matmul, ops.quant_matmul_w4 = saved


@contextlib.contextmanager
def float64_sums(torch, dispatch):
    """The dequant-fp route's einsum over float64 operands for the scope,
    cast back to the compute dtype: the fake-quant graph's op chain with
    the sums exact to float64."""
    saved = dispatch.REGISTRY["dequant-fp"]

    def f64(eqn, x, pl, ctx):
        xq = dispatch.act_fake_quant(x, pl, ctx).to(torch.float64)
        return torch.einsum(eqn, xq, pl.dequant(torch.float64)).to(
            ctx.compute_dtype)

    dispatch.REGISTRY["dequant-fp"] = f64
    try:
        yield
    finally:
        dispatch.REGISTRY["dequant-fp"] = saved


def exact_sum_gates(torch, ops, dev, cfg, reqs, tag):
    """A dense arch's token gates at 2 layers and full width,
    over ``reqs`` through the serve phase's slots, ring and prefill chunk
    (phase 12's (b)): the all-kernel run token for token the run with both
    matmuls on their plain versions, and the run with the matmuls on
    dequant-fp (the attention kernel kept) equal to the fake-quant
    reference on every decisive step (``serve.check_greedy``'s rule); the
    exact-sum runs (the kernels, their plain versions) against the
    reference printed (a third, the dequant-fp graph with float64 sums, is
    cut for the script's time limit). Lines start with ``tag``. Returns (the cut config, each run's greedy comparison, the
    rids where the reference's float32 and float64 evaluations part)."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.runtime import dispatch

    kw = dict(slots=SLOTS, cache_len=CACHE_LEN, prefill_chunk=PREFILL_CHUNK,
              device=dev)
    n_tok = sum(r.max_new for r in reqs)
    cut = cfg.scaled(n_layers=2)
    params = lm.init_params(cut, seed=0, device=dev)
    policy_cut = serve.demo_mixed_policy(cut)
    mm = ("quant_matmul", "quant_matmul_w4")

    def served(label):
        n0 = {k: ops.launches[k] for k in mm + ("decode_attn_quant",)}
        s_, _, o = serve.serve_quantized(cut, params, policy_cut, reqs, **kw)
        n = {k: ops.launches[k] - n0[k] for k in n0}
        print(f"{tag} {cut.n_layers} layers, {label}: launches {n}, "
              f"routes {s_.route_counts.routes}", flush=True)
        gate(n["decode_attn_quant"] > 0
             and set(s_.route_counts.routes["decode_attn"]) == {"fused"},
             f"{label}: attention launched {n}, routes "
             f"{s_.route_counts.routes}")
        return o, n

    out_kern, n_kern = served("every kernel")
    with plain_matmuls(ops):
        out_plain, n_plain = served("matmuls on their plain versions")
    with dispatch.force_route("matmul", "dequant-fp"):
        out_attn, n_attn = served("matmuls dequant-fp")
    gate(all(n_kern[k] > 0 for k in mm)
         and not any(n[k] for n in (n_plain, n_attn) for k in mm),
         f"matmul launches: every kernel {n_kern}, controls {n_plain} / "
         f"{n_attn}")
    same_plain = [r.rid for r in reqs
                  if out_kern[r.rid].tokens == out_plain[r.rid].tokens]
    print(f"{tag} {cut.n_layers} layers: every kernel vs the matmuls' "
          f"plain versions: {len(same_plain)} of {len(reqs)} requests token "
          f"for token", flush=True)
    gate(len(same_plain) == len(reqs),
         f"{cut.n_layers} layers: the matmul kernels' served tokens differ "
         f"from their plain versions' in rids "
         f"{sorted(set(r.rid for r in reqs) - set(same_plain))}")
    ref, ref_out = serve.reference_engine(cut, params, policy_cut, reqs, **kw)
    ctrl, ctrl_out = serve.reference_engine(cut, params, policy_cut, reqs,
                                            compute_dtype=torch.float64, **kw)
    greedy = {}
    for label, o in (("attention kernel, matmuls dequant-fp", out_attn),
                     ("every kernel", out_kern),
                     ("matmuls plain", out_plain)):
        compared, bad = serve.compare_greedy(o, ref, ref_out, ctrl, ctrl_out)
        same = sum(o[r.rid].tokens == ref_out[r.rid].tokens for r in reqs)
        greedy[label] = dict(compared=compared, diverged=bad, identical=same)
        print(f"{tag} {cut.n_layers} layers, full width, {label}: "
              f"greedy tokens vs fake-quant reference: {compared} of {n_tok} "
              f"steps decisive and compared, diverged rids {bad}; {same} of "
              f"{len(reqs)} requests token for token the reference's",
              flush=True)
    _, unstable = serve.compare_greedy(ctrl_out, ref, ref_out)
    print(f"{tag} the reference's float32 and float64 evaluations part "
          f"on a confident step in rids {unstable}", flush=True)
    g = greedy["attention kernel, matmuls dequant-fp"]
    gate(not g["diverged"] and g["compared"] > 0,
         f"{cut.n_layers} layers, attention kernel: greedy tokens diverged "
         f"on decisive steps (rids {g['diverged']}) or none compared")
    return cut, greedy, unstable


def starcoder_serve_phase(torch, ops, dev):
    """starcoder2-7b at full width and depth over the ring: 9 query heads
    per kv head, past one query group of the attention kernel (module
    docstring, phase 12); the weights are freed before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.runtime.session import summarize

    cfg = get_config("starcoder2-7b")
    G = cfg.n_heads // cfg.n_kv_heads
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    n_params = lm.param_count(params)
    policy = serve.demo_mixed_policy(cfg)
    # the full-depth run serves the first wave (4 requests of WAVE_GEN new
    # tokens), cut for the script's time limit; the 2-layer token gates
    # keep all of the serve phase's requests
    reqs = serve_requests(cfg)
    wave = [r._replace(max_new=WAVE_GEN) for r in reqs[:SLOTS]]
    kw = dict(slots=SLOTS, cache_len=CACHE_LEN, prefill_chunk=PREFILL_CHUNK,
              device=dev)
    torch.cuda.synchronize()
    print(f"[starcoder] {cfg.name}: {cfg.n_layers} layers "
          f"d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"(G={G}, {ops.attn_query_groups(G)[0]} query groups) "
          f"head_dim={cfg.hd} d_ff={cfg.d_ff} window={cfg.sliding_window} "
          f"vocab={cfg.vocab}, {n_params} parameters "
          f"({4 * n_params / 1e9:.1f} GB f32), init "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                         # counts: the main path only
    t0 = time.perf_counter()
    sess, eng, out = serve.serve_quantized(cfg, params, policy, wave, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.launches[k] for k in SERVE_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats
    d = st.as_dict()
    print(f"[starcoder] ring KV: {len(out)} requests in {wall:.2f}s wall "
          f"(packing included): prefill p50 {d['prefill_p50_ms']:.2f} ms, "
          f"decode step p50 {d['decode_step_p50_ms']:.2f} ms, decode "
          f"{st.decode_tokens_per_s:.1f} tok/s ({st.decode_steps} steps, "
          f"{st.tokens_generated} tokens); peak device memory "
          f"{peak_gb:.2f} GB", flush=True)
    print(f"[starcoder] launches {launches}; routes "
          f"{sess.route_counts.routes}", flush=True)
    # (a) every serving kernel of the ring launched, none fell back
    gate(all(launches[k] > 0 for k in RING_KERNELS)
         and launches["decode_attn_quant_paged"] == 0,
         f"starcoder2 serving launched {launches}")
    gate(sess.route_counts.eligible_fp == 0,
         f"{sess.route_counts.eligible_fp} kernel-eligible matmuls ran "
         "dequant-fp")
    gate(set(sess.route_counts.routes["decode_attn"]) == {"fused"},
         f"decode attention routes {sess.route_counts.routes['decode_attn']}")
    for r in wave:
        toks = out[r.rid].tokens
        gate(len(toks) == WAVE_GEN and all(0 <= t < cfg.vocab for t in toks),
             f"request {r.rid}: bad tokens {toks[:8]}...")
    # one decode step: the attention kernel once per layer
    step = step_launches(torch, ops, sess, dev)
    gate(step.get("decode_attn_quant") == cfg.n_layers,
         f"one starcoder2 decode step launched {step}, expected "
         f"{cfg.n_layers} decode_attn_quant")
    print(f"[starcoder] one decode step launches {step}", flush=True)
    # (c) packed bytes vs the policy's accounting
    s = summarize(sess)
    print(f"[starcoder] packed weights {s['packed_bytes']} B vs policy "
          f"{s['policy_bytes']:.0f} B (x{s['packed_vs_policy']:.4f})",
          flush=True)
    gate(abs(s["packed_vs_policy"] - 1.0) <= 0.05,
         f"packed bytes off the policy accounting by x{s['packed_vs_policy']}")
    # (b) greedy tokens at the same widths with 2 layers (as the rwkv
    # phase; the full-depth reference engines would add about a minute).
    # The run through every kernel is held token for token to the same
    # packed session with both matmuls on their plain versions (exact
    # integer sums in float64, ``ref.quant_matmul_ref``): a kernel fault at
    # any shape or row count of this path parts the two. The fake-quant
    # reference's decisive steps (serve.check_greedy's rule) gate the run
    # whose attention is the kernel under repair (G = 9, two query groups)
    # and whose matmuls take the dequant-fp route, the fake-quant graph's
    # own op chain. Against that reference the exact-sum runs are printed:
    # at StarCoder2's widths (K up to 18432) the float32 sums of the
    # reference part from exact ones by enough to flip activation codes,
    # so every exact-sum evaluation -- the kernels, their plain versions
    # -- parts from it on near-ties (ROADMAP 3)
    del sess, eng, params
    torch.cuda.empty_cache()
    cut, greedy, unstable = exact_sum_gates(torch, ops, dev, cfg, reqs,
                                            "[starcoder]")
    return launches, dict(
        params=n_params, wall_s=wall, G=G, peak_mem_gb=peak_gb,
        prefill_p50_ms=d["prefill_p50_ms"],
        decode_step_p50_ms=d["decode_step_p50_ms"],
        decode_tokens_per_s=st.decode_tokens_per_s,
        decode_steps=st.decode_steps, tokens=st.tokens_generated,
        prefill_tokens=st.prefill_tokens, decode_step_launches=step,
        cut_layers=cut.n_layers, cut_greedy=greedy,
        cut_reference_unstable_rids=unstable,
        packed_bytes=s["packed_bytes"], policy_bytes=s["policy_bytes"])


def rwkv_serve_phase(torch, ops, dev):
    """rwkv6-7b at full width and depth over the ring (module docstring,
    phase 8); the weights are freed before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.launch.scheduler import Request
    from repro_torch.models import lm
    from repro_torch.runtime.session import summarize

    cfg = get_config("rwkv6-7b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    n_params = lm.param_count(params)
    policy = serve.demo_mixed_policy(cfg)
    data = SyntheticLM(cfg)
    reqs = [Request(rid=i, tokens=data.batch(i, 1, p)["tokens"][0],
                    max_new=GEN) for i, p in enumerate(RWKV_PROMPTS)]
    kw = dict(slots=SLOTS, cache_len=CACHE_LEN, prefill_chunk=PREFILL_CHUNK,
              device=dev)
    torch.cuda.synchronize()
    print(f"[rwkv] {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"heads={cfg.n_heads}x{cfg.rwkv_head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab}, {n_params} parameters "
          f"({4 * n_params / 1e9:.1f} GB f32), init "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                         # counts: the main path only
    t0 = time.perf_counter()
    sess, eng, out = serve.serve_quantized(cfg, params, policy, reqs, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats
    d = st.as_dict()
    print(f"[rwkv] ring: {len(out)} requests in {wall:.2f}s wall (packing "
          f"included): prefill p50 {d['prefill_p50_ms']:.2f} ms, decode step "
          f"p50 {d['decode_step_p50_ms']:.2f} ms, decode "
          f"{st.decode_tokens_per_s:.1f} tok/s ({st.decode_steps} steps, "
          f"{st.tokens_generated} tokens, {st.prefill_tokens} prompt tokens); "
          f"peak device memory {peak_gb:.2f} GB", flush=True)
    print(f"[rwkv] launches {launches}; routes {sess.route_counts.routes}",
          flush=True)

    # (a) wkv once per layer in each prefill of a multiple of the chunk and
    # never in a decode step (any decode launch would exceed the count),
    # both matmul kernels, no attention kernel, no fallback
    chunked = sum(p % RWKV_CHUNK == 0 for p in RWKV_PROMPTS)
    gate(launches["wkv"] == cfg.n_layers * chunked,
         f"wkv launched {launches['wkv']} times, expected {cfg.n_layers} x "
         f"{chunked} prefills of a multiple of {RWKV_CHUNK}")
    gate(launches["quant_matmul"] > 0 and launches["quant_matmul_w4"] > 0
         and all(launches[k] == 0 for k in ATTN_KERNELS),
         f"rwkv serving launched {launches}")
    gate(sess.route_counts.eligible_fp == 0,
         f"{sess.route_counts.eligible_fp} kernel-eligible matmuls ran "
         "dequant-fp")
    gate(not sess.route_counts.routes["decode_attn"],
         f"decode attention routes {sess.route_counts.routes['decode_attn']}")
    for r in reqs:
        toks = out[r.rid].tokens
        gate(len(toks) == GEN and all(0 <= t < cfg.vocab for t in toks),
             f"request {r.rid}: bad tokens {toks[:8]}...")
    # (b) greedy tokens vs the fake-quant reference engine on decisive steps
    # (serve.check_greedy), gated at 2 layers (as gate (e)): through 32
    # recurrent layers the 2-6-bit quantizers turn the last-bit differences
    # of two float evaluations into code steps that the wkv state carries
    # to every later token, and the float32 reference and its float64
    # control part on confident steps of every request, so no step was
    # decisive there. The 32-layer comparison (~86 s of reference
    # engines) is cut to the gate's depth for the script's time limit, and
    # so is its printed prefill-logit comparison at 32 layers
    print(f"[rwkv] cut: the {cfg.n_layers}-layer greedy-token comparison "
          "with the fake-quant reference runs at 2 layers (below; the "
          "script's time limit)", flush=True)
    compared = bad = unstable = None
    n_tok = sum(len(c.tokens) for c in out.values())
    del params
    torch.cuda.empty_cache()
    cut = cfg.scaled(n_layers=2)
    params = lm.init_params(cut, seed=0, device=dev)
    policy_cut = serve.demo_mixed_policy(cut)
    n0 = ops.launches["wkv"]
    _, _, out_cut = serve.serve_quantized(cut, params, policy_cut, reqs, **kw)
    wkv_cut = ops.launches["wkv"] - n0
    with ops.plain_on_cuda(*ops.PLAIN_KERNELS):
        compared_cut, bad_cut, unstable_cut = serve.check_greedy(
            cut, params, policy_cut, reqs, out_cut, **kw)
    print(f"[rwkv] {cut.n_layers} layers, full width: greedy tokens vs "
          f"fake-quant reference: {compared_cut} of {n_tok} steps decisive "
          f"and compared, diverged rids {bad_cut}; float32 and float64 part "
          f"on a confident step in rids {unstable_cut}; wkv launches "
          f"{wkv_cut}", flush=True)
    gate(wkv_cut == cut.n_layers * chunked,
         f"{cut.n_layers} layers: wkv launched {wkv_cut} times")
    gate(not bad_cut, f"{cut.n_layers} layers: greedy tokens diverged on "
         f"decisive steps: rids {bad_cut}")
    gate(compared_cut > 0, f"{cut.n_layers} layers: no decisive step to "
         "compare")
    del params
    torch.cuda.empty_cache()
    # (c) packed bytes vs the policy's accounting
    s = summarize(sess)
    print(f"[rwkv] packed weights {s['packed_bytes']} B vs policy "
          f"{s['policy_bytes']:.0f} B (x{s['packed_vs_policy']:.4f})",
          flush=True)
    gate(abs(s["packed_vs_policy"] - 1.0) <= 0.05,
         f"packed bytes off the policy accounting by x{s['packed_vs_policy']}")
    # (d) one decode step of 4 slots under sync-debug "error": no host sync,
    # and no wkv launch
    state = sess.init_state(SLOTS, CACHE_LEN, torch.float32, device=dev)
    tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.arange(SLOTS, dtype=torch.int32, device=dev) + 200
    sess.decode(sess.params, tok, pos, state)
    torch.cuda.synchronize()
    n0 = dict(ops.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        sess.decode(sess.params, tok, pos, state)
    except RuntimeError as e:
        raise GateError(f"an rwkv decode step synchronised the host: {e}") \
            from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    step_launches = {k: ops.launches[k] - n0[k] for k in n0}
    gate(step_launches["wkv"] == 0
         and step_launches["quant_matmul"] + step_launches["quant_matmul_w4"]
         == 8 * cfg.n_layers,
         f"one rwkv decode step launched {step_launches}")
    print(f"[rwkv] one decode step under sync-debug 'error': no host sync; "
          f"kernel launches {step_launches}", flush=True)
    step = profile_decode_step(
        torch, sess, dev, "rwkv",
        watch=("qmm_splitk_kernel", "qmm_w4_splitk_kernel"))
    # one 256-token prefill under the profiler: wkv once per layer
    t_pre = torch.as_tensor(reqs[0].tokens, device=dev)[None]
    gate(t_pre.shape[1] == 256, f"the profiled prefill has {t_pre.shape[1]} "
         "tokens")
    sess.prefill(sess.params, t_pre, prefill_cap=CACHE_LEN)
    pre = profile_device(torch, lambda: sess.prefill(
        sess.params, t_pre, prefill_cap=CACHE_LEN), top=4,
        watch=("wkv_chunk_kernel",))
    print_profile("rwkv", "one 256-token prefill", pre)
    gate(pre["watched"][0][2] == cfg.n_layers,
         f"a 256-token prefill ran {pre['watched'][0][2]} wkv kernels, "
         f"expected {cfg.n_layers}")
    return launches, dict(
        params=n_params, decode_step_profile=step, prefill_profile=pre,
        wall_s=wall,
        prefill_p50_ms=d["prefill_p50_ms"],
        decode_step_p50_ms=d["decode_step_p50_ms"],
        decode_tokens_per_s=st.decode_tokens_per_s,
        decode_steps=st.decode_steps, tokens=st.tokens_generated,
        prefill_tokens=st.prefill_tokens, peak_mem_gb=peak_gb,
        chunked_prefills=chunked, decode_step_launches=step_launches,
        decisive_compared=compared, reference_unstable_rids=unstable,
        cut_layers=cut.n_layers,
        cut_decisive_compared=compared_cut,
        cut_reference_unstable_rids=unstable_cut,
        packed_bytes=s["packed_bytes"], policy_bytes=s["policy_bytes"])


def hybrid_serve_phase(torch, ops, dev, card):
    """recurrentgemma-2b at full width and depth over the ring: RG-LRU
    blocks beside local multi-query attention at hd 256, and one long
    prompt through the flash kernel (module docstring, phase 13); the
    weights are freed before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.launch.scheduler import Request
    from repro_torch.models import lm
    from repro_torch.runtime import dispatch
    from repro_torch.runtime.session import summarize

    cfg = get_config("recurrentgemma-2b")
    G = cfg.n_heads // cfg.n_kv_heads
    window = lm.attn_window(cfg)
    sched = lm.build_schedule(cfg)
    n_attn = sum(s.kind == "attn" for s in lm.iter_sites(cfg))
    n_proj = len(lm.enumerate_qlayers(cfg))
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    n_params = lm.param_count(params)
    policy = serve.demo_mixed_policy(cfg)

    def requests(c):
        long_ = SyntheticLM(c).batch(len(PROMPTS), 1, HYBRID_LONG)
        return serve_requests(c) + [Request(
            rid=len(PROMPTS), tokens=long_["tokens"][0], max_new=GEN)]

    reqs = requests(cfg)
    kw = dict(slots=SLOTS, cache_len=window, prefill_chunk=HYBRID_LONG,
              device=dev)
    torch.cuda.synchronize()
    print(f"[hybrid] {cfg.name}: {cfg.n_layers} layers {sched.pattern} x "
          f"{sched.repeats} + {sched.suffix}, d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} (G={G}, "
          f"{ops.attn_query_groups(G)[0]} query groups) head_dim={cfg.hd} "
          f"d_ff={cfg.d_ff} lru_width={cfg.lru_width} "
          f"conv1d={cfg.conv1d_width} local window={window} "
          f"vocab={cfg.vocab}, {n_proj} projections, {n_params} parameters "
          f"({4 * n_params / 1e9:.1f} GB f32), init "
          f"{time.perf_counter() - t0:.1f}s; {card}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                         # counts: the main path only
    t0 = time.perf_counter()
    sess, eng, out = serve.serve_quantized(cfg, params, policy, reqs, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.launches[k] for k in SERVE_KERNELS + ("flash_fwd",)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats
    d = st.as_dict()
    print(f"[hybrid] ring KV of {window} rows a slot: {len(out)} requests in "
          f"{wall:.2f}s wall (packing included): prefill p50 "
          f"{d['prefill_p50_ms']:.2f} ms, decode step p50 "
          f"{d['decode_step_p50_ms']:.2f} ms, decode "
          f"{st.decode_tokens_per_s:.1f} tok/s ({st.decode_steps} steps, "
          f"{st.tokens_generated} tokens, {st.prefill_tokens} prompt "
          f"tokens); peak device memory {peak_gb:.2f} GB; {card}", flush=True)
    print(f"[hybrid] launches {launches}; routes {sess.route_counts.routes}",
          flush=True)
    # (a) every ring kernel launched and none of the other layouts'; flash
    # once per attention layer, in the long prompt's prefill alone; no
    # kernel-eligible projection on dequant-fp
    gate(all(launches[k] > 0 for k in RING_KERNELS)
         and not any(launches[k] for k in SERVE_KERNELS
                     if k not in RING_KERNELS),
         f"hybrid serving launched {launches}")
    gate(launches["flash_fwd"] == n_attn,
         f"flash_fwd launched {launches['flash_fwd']} times, expected "
         f"{n_attn} (one per attention layer in the {HYBRID_LONG}-token "
         "prefill)")
    gate(sess.route_counts.eligible_fp == 0,
         f"{sess.route_counts.eligible_fp} kernel-eligible matmuls ran "
         "dequant-fp")
    gate(set(sess.route_counts.routes["decode_attn"]) == {"fused"},
         f"decode attention routes {sess.route_counts.routes['decode_attn']}")
    for r in reqs:
        toks = out[r.rid].tokens
        gate(len(toks) == GEN and all(0 <= t < cfg.vocab for t in toks),
             f"request {r.rid}: bad tokens {toks[:8]}...")
    step = step_launches(torch, ops, sess, dev)
    gate(step.get("decode_attn_quant") == n_attn
         and step.get("quant_matmul", 0) + step.get("quant_matmul_w4", 0)
         == n_proj,
         f"one hybrid decode step launched {step}, expected {n_attn} "
         f"decode_attn_quant and {n_proj} matmuls")
    print(f"[hybrid] one decode step launches {step}", flush=True)
    # (c) packed bytes vs the policy's accounting
    s = summarize(sess)
    print(f"[hybrid] packed weights {s['packed_bytes']} B vs policy "
          f"{s['policy_bytes']:.0f} B (x{s['packed_vs_policy']:.4f})",
          flush=True)
    gate(abs(s["packed_vs_policy"] - 1.0) <= 0.05,
         f"packed bytes off the policy accounting by x{s['packed_vs_policy']}")
    # (d) one decode step: no host sync inside it (sync-debug "error"), and
    # under the profiler the attention and matmul kernels it runs are the
    # launches the wrappers counted
    state = sess.init_state(SLOTS, window, torch.float32, device=dev)
    tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.arange(SLOTS, dtype=torch.int32, device=dev) + 2100
    sess.decode(sess.params, tok, pos, state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sess.decode(sess.params, tok, pos, state)
    except RuntimeError as e:
        raise GateError(f"a hybrid decode step synchronised the host: {e}") \
            from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("[hybrid] one decode step under sync-debug 'error': no host sync",
          flush=True)
    # the profiled step's launches are gated on the host's launch calls; the
    # kernels' device records are printed (the profiler may drop a few of
    # a step's ~3500 device records). Its slots hold the window's rows and
    # sit past it, as the sync-debug step's do
    prof = profile_decode_step(
        torch, sess, dev, "hybrid",
        watch=("decode_attn_quant_kernel", "qmm_splitk_kernel",
               "qmm_w4_splitk_kernel"), cache_len=window, pos0=2100)
    # the long prompt's prefill under the profiler: flash once per
    # attention layer
    t_long = torch.as_tensor(reqs[-1].tokens, device=dev)[None]
    n0 = ops.launches["flash_fwd"]
    pre = profile_device(torch, lambda: sess.prefill(
        sess.params, t_long, prefill_cap=window), top=4,
        watch=("flash_fwd_kernel", "qmm_mma_kernel", "qmm_w4_mma_kernel"))
    print_profile("hybrid", f"one {HYBRID_LONG}-token prefill", pre)
    gate(ops.launches["flash_fwd"] - n0 == n_attn,
         f"a {HYBRID_LONG}-token prefill launched "
         f"{ops.launches['flash_fwd'] - n0} flash kernels, expected {n_attn}")
    # the 26-layer comparison with the fake-quant reference engine (printed,
    # ~48 s of reference engines) is cut to the gates' 3 layers below, for
    # the script's time limit
    print(f"[hybrid] cut: the {cfg.n_layers}-layer greedy-token comparison "
          f"with the fake-quant reference runs at {HYBRID_CUT} layers "
          "(below; the script's time limit)", flush=True)
    compared = bad = unstable = None
    n_tok = sum(len(c.tokens) for c in out.values())
    del sess, eng, params
    torch.cuda.empty_cache()

    # (b) at one (rec, rec, attn) repeat, full width: the run through every
    # kernel token for token the same session with both matmuls on their
    # plain versions; the run whose matmuls take the dequant-fp route (the
    # fake-quant graph's op chain; attention and flash the kernels) equal
    # to the fake-quant reference on every decisive step
    cut = cfg.scaled(n_layers=HYBRID_CUT)
    params = lm.init_params(cut, seed=0, device=dev)
    policy_cut = serve.demo_mixed_policy(cut)
    reqs_cut = requests(cut)
    mm = ("quant_matmul", "quant_matmul_w4")
    n_attn_cut = sum(s.kind == "attn" for s in lm.iter_sites(cut))

    def served(label):
        n0 = {k: ops.launches[k] for k in mm + ("decode_attn_quant",
                                                 "flash_fwd")}
        s_, _, o = serve.serve_quantized(cut, params, policy_cut, reqs_cut,
                                         **kw)
        n = {k: ops.launches[k] - n0[k] for k in n0}
        print(f"[hybrid] {cut.n_layers} layers, {label}: launches {n}, "
              f"routes {s_.route_counts.routes}", flush=True)
        gate(n["decode_attn_quant"] > 0 and n["flash_fwd"] == n_attn_cut
             and set(s_.route_counts.routes["decode_attn"]) == {"fused"},
             f"{label}: attention launched {n}, routes "
             f"{s_.route_counts.routes}")
        return o, n

    out_kern, n_kern = served("every kernel")
    with plain_matmuls(ops):
        out_plain, n_plain = served("matmuls on their plain versions")
    with dispatch.force_route("matmul", "dequant-fp"):
        out_fp, n_fp = served("matmuls dequant-fp")
    gate(all(n_kern[k] > 0 for k in mm)
         and not any(n[k] for n in (n_plain, n_fp) for k in mm),
         f"matmul launches: every kernel {n_kern}, controls {n_plain} / "
         f"{n_fp}")
    same_plain = [r.rid for r in reqs_cut
                  if out_kern[r.rid].tokens == out_plain[r.rid].tokens]
    print(f"[hybrid] {cut.n_layers} layers: every kernel vs the matmuls' "
          f"plain versions: {len(same_plain)} of {len(reqs_cut)} requests "
          f"token for token", flush=True)
    gate(len(same_plain) == len(reqs_cut),
         f"{cut.n_layers} layers: the matmul kernels' served tokens differ "
         f"from their plain versions' in rids "
         f"{sorted(set(r.rid for r in reqs_cut) - set(same_plain))}")
    ref, ref_out = serve.reference_engine(cut, params, policy_cut, reqs_cut,
                                          **kw)
    ctrl, ctrl_out = serve.reference_engine(cut, params, policy_cut,
                                            reqs_cut,
                                            compute_dtype=torch.float64, **kw)
    greedy = {}
    for label, o in (("matmuls dequant-fp", out_fp),
                     ("every kernel", out_kern)):
        c_, bad_ = serve.compare_greedy(o, ref, ref_out, ctrl, ctrl_out)
        same = sum(o[r.rid].tokens == ref_out[r.rid].tokens
                   for r in reqs_cut)
        greedy[label] = dict(compared=c_, diverged=bad_, identical=same)
        print(f"[hybrid] {cut.n_layers} layers, full width, {label}: greedy "
              f"tokens vs fake-quant reference: {c_} of {n_tok} steps "
              f"decisive and compared, diverged rids {bad_}; {same} of "
              f"{len(reqs_cut)} requests token for token the reference's",
              flush=True)
    _, unstable_cut = serve.compare_greedy(ctrl_out, ref, ref_out)
    print(f"[hybrid] {cut.n_layers} layers: the reference's float32 and "
          f"float64 evaluations part on a confident step in rids "
          f"{unstable_cut}", flush=True)
    g = greedy["matmuls dequant-fp"]
    gate(not g["diverged"] and g["compared"] > 0,
         f"{cut.n_layers} layers, dequant-fp matmuls: greedy tokens diverged "
         f"on decisive steps (rids {g['diverged']}) or none compared")
    # (b) logits, which a degenerate token stream does not test: the
    # session through every kernel against the float32 reference at the
    # prefill and 6 decode steps of two short prompts and the long one (its
    # decode past the window over the wrapped ring), each side carrying its
    # own RG-LRU, conv and ring state; held to the reference's own distance
    # from float64, or to a few activation code steps where neither parted
    # by more than a last bit
    sess_cut = serve.build_session(cut, params, policy_cut)
    noise = prefill_noise(torch, cut, params, policy_cut, sess_cut,
                          [reqs_cut[0], reqs_cut[1], reqs_cut[-1]], dev,
                          cap=window, n_dec=6, label="hybrid")
    worst = max(x["served_vs_ref32"] for x in noise)
    limit = max(2 * max(x["ref32_vs_ref64"] for x in noise),
                HYBRID_LOGIT_FLOOR * noise[0]["logit_std"])
    gate(worst <= limit,
         f"{cut.n_layers} layers: served logits {worst:.4f} from the float32 "
         f"reference, beyond {limit:.4f}")
    del params, ref, ctrl, sess_cut
    torch.cuda.empty_cache()
    return launches, dict(
        params=n_params, projections=n_proj, wall_s=wall, G=G, window=window,
        peak_mem_gb=peak_gb, prefill_p50_ms=d["prefill_p50_ms"],
        decode_step_p50_ms=d["decode_step_p50_ms"],
        decode_tokens_per_s=st.decode_tokens_per_s,
        decode_steps=st.decode_steps, tokens=st.tokens_generated,
        prefill_tokens=st.prefill_tokens, decode_step_launches=step,
        decode_step_profile=prof, long_prefill_profile=pre,
        decisive_compared=compared, diverged_rids=bad,
        reference_unstable_rids=unstable, cut_layers=cut.n_layers,
        cut_greedy=greedy, cut_reference_unstable_rids=unstable_cut,
        cut_logits=noise, cut_logit_limit=limit,
        packed_bytes=s["packed_bytes"], policy_bytes=s["policy_bytes"])


def moe_combine_check(torch, dev, cfg, calls=(4, 256), label="moe"):
    """The MoE combine at ``cfg``'s shapes over calls of ``calls`` tokens
    (deepseek-moe-16b: 64 experts, top-6, d_model 2048; a decode step of 4
    tokens and a 256-token prefill, whose capacity of 128 drops picks;
    mixtral-8x7b: 8 experts, top-2, d_model 4096, 4 and 4608 tokens, a
    capacity of 1536), expert 5 every token's pick: two equal calls on the
    card bit for bit equal, and equal to the same ops on the CPU (each
    token's rows added in ascending expert order from zero; IEEE adds in
    one order)."""
    from repro_torch.models import moe as moe_mod
    res = {}
    for T in calls:
        g = torch.Generator(device=dev).manual_seed(T)
        xf = torch.randn((T, cfg.d_model), generator=g, device=dev)
        w = torch.randn((cfg.d_model, cfg.moe.n_experts), generator=g,
                        device=dev) * cfg.d_model ** -0.5
        xf[:, 0], w[0, 5] = 2.0, 4.0         # expert 5: every token's pick
        r = moe_mod.route(xf, w, cfg.moe)
        E, C = r.gi.shape
        y = torch.randn((E, C, cfg.d_model), generator=g, device=dev) \
            * (r.gv * r.keep)[..., None]
        a = moe_mod.combine(y, r.gi, r.keep, r.top_i, T)
        b = moe_mod.combine(y, r.gi, r.keep, r.top_i, T)
        c = moe_mod.combine(y.cpu(), r.gi.cpu(), r.keep.cpu(),
                            r.top_i.cpu(), T)
        torch.cuda.synchronize()
        dropped = int(T * cfg.moe.top_k - r.keep.sum().item())
        gate(torch.equal(a, b), f"two equal MoE combines at T={T} differ")
        gate(torch.equal(a.cpu(), c),
             f"the MoE combine at T={T} differs from its CPU evaluation")
        res[T] = dict(capacity=C, dropped_picks=dropped)
        print(f"[{label}] combine T={T} C={C} ({dropped} of "
              f"{T * cfg.moe.top_k} picks dropped): two calls bit for bit "
              f"equal, and equal to the CPU's", flush=True)
    return res


def packed_engine(torch, sess, dev, reqs, layout="ring", speculate=0,
                  cache_len=CACHE_LEN, prefill_chunk=PREFILL_CHUNK):
    """Drain ``reqs`` through an engine over ``sess`` (a site-by-site pack
    of the MoE, vision or mixtral phases) on ``layout``, the serve phase's
    slots, and its ring rows and prefill chunk unless given: (engine,
    completions, wall seconds)."""
    from repro_torch.launch.engine import DecodeEngine, EngineConfig
    eng = DecodeEngine(sess.params, sess.cfg, None, sess.ctx, adapter=sess,
                       device=dev, ecfg=EngineConfig(
                           slots=SLOTS, cache_len=cache_len,
                           prefill_chunk=prefill_chunk, kv_quant="int8",
                           kv_layout=layout, page_size=PAGE_SIZE,
                           speculate=speculate))
    eng.submit_all(reqs)
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    return eng, out, time.perf_counter() - t0


@contextlib.contextmanager
def fresh_route_counts(sess):
    """The session's dispatch route tallies of the scope only."""
    from repro_torch.runtime import dispatch
    keep, sess.route_counts = sess.route_counts, dispatch.Counts()
    try:
        yield sess.route_counts
    finally:
        sess.route_counts = keep


def moe_serve_phase(torch, ops, dev, card):
    """deepseek-moe-16b at full width and depth over the ring: routed
    experts through the per-expert fake-quant kernel and the dequant-fp
    route, shared experts, attention and the dense layer through the ring
    kernels (module docstring, phase 15). Packs the target and the 2-bit
    draft site by site once, for this phase and the paged and speculative
    ones. Returns (launches, results, (session, requests, completions,
    engine))."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.runtime import dispatch, packing
    from repro_torch.runtime.session import summarize

    t_phase = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    moe = cfg.moe
    sites = lm.iter_sites(cfg)
    n_moe = sum(s.kind == "moe" for s in sites)
    ql = lm.enumerate_qlayers(cfg)
    n_proj, n_stacks = len(ql), sum(q.n_mats > 1 for q in ql)
    n_params = sum(q.w_params for q in ql)
    res = {"combine": moe_combine_check(torch, dev, cfg)}
    policy = serve.demo_mixed_policy(cfg)
    # the full-depth run serves the first wave, one request a slot, to
    # WAVE_GEN new tokens (the speculative phases' comparison), cut for
    # the script's time limit; the token gates at MOE_CUT layers keep all
    # of the serve phase's requests
    gate_reqs = serve_requests(cfg)
    reqs = [r._replace(max_new=WAVE_GEN) for r in gate_reqs[:SLOTS]]
    with open("/proc/meminfo") as f:
        mem = {ln.split(":")[0]: ln.split(":")[1].strip() for ln in f}
    sched = lm.build_schedule(cfg)
    print(f"[moe] {cfg.name}: {cfg.n_layers} layers {sched.prefix} + "
          f"{sched.pattern} x {sched.repeats}, d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads} (G=1) head_dim={cfg.hd}; {moe.n_experts} "
          f"routed experts of d_ff {moe.d_ff}, top-{moe.top_k}, "
          f"{moe.n_shared} shared, dense d_ff {moe.dense_d_ff}; vocab "
          f"{cfg.vocab}; {n_proj} projections ({n_stacks} expert stacks), "
          f"{n_params} searched weights ({4 * n_params / 1e9:.1f} GB f32); "
          f"host MemTotal {mem.get('MemTotal')}, MemAvailable "
          f"{mem.get('MemAvailable')}; {card}", flush=True)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                         # counts: the main path only
    t0 = time.perf_counter()
    outer, source = lm.site_source(cfg, device=dev)
    # the target and the speculative phases' 2-bit draft, each site made
    # once and packed under both policies before the next
    sess = serve.build_session(cfg, outer, policy, speculate=SPEC_K,
                               draft_bits=DRAFT_BITS, site_source=source)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    del outer
    res["checksum"] = packed_checksum(torch, sess)   # phase 21's gate
    with fresh_route_counts(sess) as routes:
        eng, out, wall = packed_engine(torch, sess, dev, reqs)
    launches = {k: ops.launches[k] for k in SERVE_KERNELS
                + ("fake_quant_fwd",)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats
    d = st.as_dict()
    print(f"[moe] packed site by site (seeded init, target and "
          f"{DRAFT_BITS}-bit draft) in {pack_s:.2f}s; ring KV: {len(out)} "
          f"requests in {wall:.2f}s wall: prefill p50 "
          f"{d['prefill_p50_ms']:.2f} ms, decode step p50 "
          f"{d['decode_step_p50_ms']:.2f} ms, decode "
          f"{st.decode_tokens_per_s:.1f} tok/s ({st.decode_steps} steps, "
          f"{st.tokens_generated} tokens, {st.prefill_tokens} prompt "
          f"tokens); peak device memory {peak_gb:.2f} GB (the draft tree "
          f"resident); {card}", flush=True)
    print(f"[moe] launches {launches}; routes {routes.routes}", flush=True)
    print(f"[moe] cut: the full-depth run serves the first wave ({SLOTS} "
          f"requests of {WAVE_GEN} new tokens, {len(gate_reqs)} of "
          f"{GEN} before the mixtral phase; the script's time limit); the "
          f"{MOE_CUT}-layer token gates serve all {len(gate_reqs)}",
          flush=True)
    # (a) the ring kernels and the per-expert fake-quant launched, no other
    # layout's; no kernel-eligible projection on dequant-fp
    gate(all(launches[k] > 0 for k in RING_KERNELS + ("fake_quant_fwd",))
         and not any(launches[k] for k in SERVE_KERNELS
                     if k not in RING_KERNELS),
         f"moe serving launched {launches}")
    gate(routes.eligible_fp == 0,
         f"{routes.eligible_fp} kernel-eligible matmuls ran dequant-fp")
    gate(set(routes.routes["decode_attn"]) == {"fused"},
         f"decode attention routes {routes.routes['decode_attn']}")
    for r in reqs:
        toks = out[r.rid].tokens
        gate(len(toks) == WAVE_GEN
             and all(0 <= t < cfg.vocab for t in toks),
             f"request {r.rid}: bad tokens {toks[:8]}...")
    # (c) packed bytes vs the policy's accounting
    s = summarize(sess)
    print(f"[moe] packed weights {s['packed_bytes']} B vs policy "
          f"{s['policy_bytes']:.0f} B (x{s['packed_vs_policy']:.4f})",
          flush=True)
    gate(abs(s["packed_vs_policy"] - 1.0) <= 0.05,
         f"packed bytes off the policy accounting by x{s['packed_vs_policy']}")

    # (b), (d): one decode step's routes and launches, as the schedule
    # implies them: every projection but the expert stacks on a matmul
    # kernel, the expert stacks on dequant-fp, one attention launch a
    # layer, one fake-quant launch per expert stack's activation (one per
    # reuse group where two share one) and two for the untied pinned head
    expert_pls = [pl for pl in packing.packed_leaves(sess.params)
                  if len(pl.shape) == 3]
    n_fq = len({pl.a_group or id(pl) for pl in expert_pls})
    pinned = 0 if cfg.tie_embeddings else 2       # the head's weight, input
    want_step = {"quant_matmul+w4": n_proj - n_stacks,
                 "decode_attn_quant": cfg.n_layers,
                 "fake_quant_fwd": n_fq + pinned}
    state = sess.init_state(SLOTS, CACHE_LEN, torch.float32, device=dev)
    tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.arange(SLOTS, dtype=torch.int32, device=dev) + 200
    ops.reset_launches()
    with fresh_route_counts(sess) as counts:
        logits, _ = sess.decode(sess.params, tok, pos, state)
        again, _ = sess.decode(sess.params, tok, pos, state)
        torch.cuda.synchronize()
    step = {k: ops.launches[k] // 2 for k in ("quant_matmul",
                                               "quant_matmul_w4",
                                               "decode_attn_quant",
                                               "fake_quant_fwd")}
    got_step = {"quant_matmul+w4": step["quant_matmul"]
                + step["quant_matmul_w4"],
                "decode_attn_quant": step["decode_attn_quant"],
                "fake_quant_fwd": step["fake_quant_fwd"]}
    fp_step = counts.routes["matmul"].get("dequant-fp", 0) // 2
    print(f"[moe] one decode step: launches {step}, routes "
          f"{ {k: v // 2 for k, v in counts.routes['matmul'].items()} }",
          flush=True)
    gate(fp_step == n_stacks == 3 * n_moe,
         f"one decode step ran {fp_step} dequant-fp matmuls, expected the "
         f"{3 * n_moe} expert stacks")
    gate(got_step == want_step,
         f"one decode step launched {got_step}, expected {want_step}")
    # (f) finite logits; the step is deterministic on the card
    gate(bool(torch.isfinite(logits).all()), "non-finite decode logits")
    gate(torch.equal(logits, again),
         "two equal MoE decode steps gave different logits")
    pre_logits, _ = sess.prefill(
        sess.params, torch.as_tensor(reqs[0].tokens, device=dev)[None],
        prefill_cap=CACHE_LEN)
    gate(bool(torch.isfinite(pre_logits).all()), "non-finite prefill logits")
    # (e) no host sync inside a decode step
    no_sync(torch, lambda: sess.decode(sess.params, tok, pos, state),
            "a moe decode step")
    print("[moe] one decode step under sync-debug 'error': no host sync; "
          "logits finite, two equal steps bit for bit equal", flush=True)
    # (d) the profiled step's launches
    prof = profile_decode_step(
        torch, sess, dev, "moe",
        watch=("decode_attn_quant_kernel", "qmm_splitk_kernel",
               "qmm_w4_splitk_kernel", "fq_fwd_kernel"))
    print(f"[moe] at {cfg.n_layers} layers the float32 tree "
          f"({4 * n_params / 1e9:.1f} GB of searched weights) and a "
          "fake-quant reference engine do not fit beside the packed "
          "session: no reference comparison at full depth", flush=True)
    del state, logits, again, pre_logits
    torch.cuda.empty_cache()
    t_full = time.perf_counter() - t_phase

    # (b) the token gates at the dense layer and one MoE layer, full width
    greedy, unstable_cut, _ = cut_gates(torch, ops, dev, cfg, gate_reqs,
                                        "ring", "moe")
    t_all = time.perf_counter() - t_phase
    print(f"[moe] phase {t_all:.1f}s ({t_full:.1f}s at full depth); {card}",
          flush=True)
    res.update(
        searched_weights=n_params, projections=n_proj,
        expert_stacks=n_stacks, pack_s=pack_s, wall_s=wall,
        peak_mem_gb=peak_gb, host_mem_total=mem.get("MemTotal"),
        host_mem_available=mem.get("MemAvailable"),
        prefill_p50_ms=d["prefill_p50_ms"],
        decode_step_p50_ms=d["decode_step_p50_ms"],
        decode_tokens_per_s=st.decode_tokens_per_s,
        decode_steps=st.decode_steps, tokens=st.tokens_generated,
        prefill_tokens=st.prefill_tokens, decode_step_launches=step,
        decode_step_dequant_fp=fp_step, decode_step_profile=prof,
        cut_layers=MOE_CUT, cut_greedy=greedy,
        cut_reference_unstable_rids=unstable_cut,
        packed_bytes=s["packed_bytes"], policy_bytes=s["policy_bytes"],
        phase_s=t_all, full_depth_s=t_full)
    return launches, res, (sess, reqs, out, eng)


def no_sync(torch, fn, what):
    """Gate: ``fn`` runs under ``set_sync_debug_mode("error")``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        raise GateError(f"{what} synchronised the host: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")


def cut_gates(torch, ops, dev, cfg, reqs, layout, label, n_layers=MOE_CUT,
              prep=None, cache_len=CACHE_LEN, prefill_chunk=PREFILL_CHUNK,
              noise=()):
    """``cfg`` at full width cut to ``n_layers`` layers (deepseek-moe-16b:
    the dense layer and one MoE layer; llama-3.2-vision-11b: one unit of
    its pattern; mixtral-8x7b: two MoE layers) over ``layout`` (slots of
    ``cache_len`` rows, a prefill budget of ``prefill_chunk``), the seeded
    params handed to ``prep(params)`` first: the run through every kernel
    token for token the same session on the matmuls' plain versions, and
    the run on the dequant-fp matmul route equal to the fake-quant
    reference served over the same layout under the same schedule on every
    decisive step, with its float64 control; the all-kernel run against
    the reference printed. With ``noise`` (indices into ``reqs``), the
    hybrid phase's logit gate on those prompts: the session through every
    kernel within max(2 x the float32 reference's distance from its
    float64 evaluation, ``HYBRID_LOGIT_FLOOR`` x the logits' std) of the
    float32 reference over each prefill and 6 decode steps. Returns
    (per-run comparisons, the rids where the reference's float32 and
    float64 evaluations part, the logit gate's rows and limit or None)."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.runtime import dispatch

    cut = cfg.scaled(n_layers=n_layers)
    params = lm.init_params(cut, seed=0, device=dev)
    if prep is not None:
        prep(params)
    policy_cut = serve.demo_mixed_policy(cut)
    kw = dict(slots=SLOTS, cache_len=cache_len, prefill_chunk=prefill_chunk,
              device=dev, kv_layout=layout, page_size=PAGE_SIZE)
    mm = ("quant_matmul", "quant_matmul_w4")
    attn = "decode_attn_quant_paged" if layout == "paged" \
        else "decode_attn_quant"

    sess = serve.build_session(cut, params, policy_cut)   # one pack

    def served(what):
        n0 = {k: ops.launches[k] for k in mm + (attn, "fake_quant_fwd")}
        with fresh_route_counts(sess) as routes:
            _, o, _ = packed_engine(torch, sess, dev, reqs, layout,
                                    cache_len=cache_len,
                                    prefill_chunk=prefill_chunk)
        n = {k: ops.launches[k] - n0[k] for k in n0}
        print(f"[{label}] {cut.n_layers} layers, {what}: launches {n}, "
              f"routes {routes.routes}", flush=True)
        gate(n[attn] > 0 and n["fake_quant_fwd"] > 0
             and set(routes.routes["decode_attn"]) == {"fused"},
             f"{what}: attention / fake-quant launched {n}, routes "
             f"{routes.routes}")
        return o, n

    out_kern, n_kern = served("every kernel")
    with plain_matmuls(ops):
        out_plain, n_plain = served("matmuls on their plain versions")
    with dispatch.force_route("matmul", "dequant-fp"):
        out_fp, n_fp = served("matmuls dequant-fp")
    gate(all(n_kern[k] > 0 for k in mm)
         and not any(n[k] for n in (n_plain, n_fp) for k in mm),
         f"matmul launches: every kernel {n_kern}, controls {n_plain} / "
         f"{n_fp}")
    same_plain = [r.rid for r in reqs
                  if out_kern[r.rid].tokens == out_plain[r.rid].tokens]
    print(f"[{label}] {cut.n_layers} layers: every kernel vs the matmuls' "
          f"plain versions: {len(same_plain)} of {len(reqs)} requests token "
          f"for token", flush=True)
    gate(len(same_plain) == len(reqs),
         f"{cut.n_layers} layers: the matmul kernels' served tokens differ "
         f"from their plain versions' in rids "
         f"{sorted(set(r.rid for r in reqs) - set(same_plain))}")
    ref, ref_out = serve.reference_engine(cut, params, policy_cut, reqs, **kw)
    ctrl, ctrl_out = serve.reference_engine(cut, params, policy_cut, reqs,
                                            compute_dtype=torch.float64, **kw)
    n_tok = sum(len(c.tokens) for c in out_kern.values())
    greedy = {}
    for what, o in (("matmuls dequant-fp", out_fp),
                    ("every kernel", out_kern)):
        c_, bad_ = serve.compare_greedy(o, ref, ref_out, ctrl, ctrl_out)
        same = sum(o[r.rid].tokens == ref_out[r.rid].tokens for r in reqs)
        greedy[what] = dict(compared=c_, diverged=bad_, identical=same)
        print(f"[{label}] {cut.n_layers} layers, full width, {what}: greedy "
              f"tokens vs fake-quant reference ({layout}): {c_} of {n_tok} "
              f"steps decisive and compared, diverged rids {bad_}; {same} "
              f"of {len(reqs)} requests token for token the reference's",
              flush=True)
    _, unstable = serve.compare_greedy(ctrl_out, ref, ref_out)
    print(f"[{label}] {cut.n_layers} layers: the reference's float32 and "
          f"float64 evaluations part on a confident step in rids {unstable}",
          flush=True)
    g = greedy["matmuls dequant-fp"]
    gate(not g["diverged"] and g["compared"] > 0,
         f"{cut.n_layers} layers, dequant-fp matmuls: greedy tokens diverged "
         f"on decisive steps (rids {g['diverged']}) or none compared")
    del ref, ctrl
    logits = None
    if noise:
        # the logit gate as the token gates hold the kernel path (ROADMAP
        # 3a): every kernel bit for bit the plain-matmul session (exact
        # sums both), and the session on the dequant-fp matmul route (the
        # reference's op chain; decode attention, flash and fake-quant the
        # kernels) within max(2 x float32-vs-float64, HYBRID_LOGIT_FLOOR x
        # std) of the float32 reference; the exact-sum session's distance
        # printed beside the fake-quant graph's with float64 sums: on the
        # card expert routing takes both as far from the float32 reference
        # (1.5644 and 1.5702 on the 256-token prompt, against 0.3850 for
        # the float64 evaluation)
        def exact_sums():
            stack = contextlib.ExitStack()
            stack.enter_context(dispatch.force_route("matmul", "dequant-fp"))
            stack.enter_context(float64_sums(torch, dispatch))
            return stack

        rows = prefill_noise(
            torch, cut, params, policy_cut, sess, [reqs[i] for i in noise],
            dev, cap=cache_len, n_dec=6, label=label, variants={
                "matmuls on their plain versions": lambda: plain_matmuls(ops),
                "matmuls dequant-fp": lambda: dispatch.force_route(
                    "matmul", "dequant-fp"),
                "dequant-fp with float64 sums": exact_sums})
        limit = max(2 * max(x["ref32_vs_ref64"] for x in rows),
                    HYBRID_LOGIT_FLOOR * rows[0]["logit_std"])
        plain = max(x["matmuls on their plain versions_vs_served"]
                    for x in rows)
        worst = max(x["matmuls dequant-fp_vs_ref32"] for x in rows)
        kern = max(x["served_vs_ref32"] for x in rows)
        f64 = max(x["dequant-fp with float64 sums_vs_ref32"] for x in rows)
        print(f"[{label}] {cut.n_layers} layers, logits over prefill + 6 "
              f"decode steps: every kernel vs the plain-matmul session "
              f"{plain}; dequant-fp matmuls {worst:.4f} from the float32 "
              f"reference (limit {limit:.4f}); every kernel {kern:.4f} from "
              f"it, the graph with float64 sums {f64:.4f} (printed: ROADMAP "
              "3a)", flush=True)
        gate(plain == 0.0,
             f"{cut.n_layers} layers: the matmul kernels' logits differ from "
             f"their plain versions' by {plain}")
        gate(worst <= limit,
             f"{cut.n_layers} layers: dequant-fp logits {worst:.4f} from the "
             f"float32 reference, beyond {limit:.4f}")
        logits = dict(rows=rows, limit=limit)
    del params, sess
    torch.cuda.empty_cache()
    return greedy, unstable, logits


def paged_requests(cfg):
    """The serve phase's requests with their first ``SHARED_PREFIX`` prompt
    tokens made the same (request 0's)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.scheduler import Request
    data = SyntheticLM(cfg)
    base = data.batch(0, 1, PROMPTS[0])["tokens"][0][:SHARED_PREFIX]
    reqs = []
    for i, p in enumerate(PROMPTS):
        toks = np.asarray(data.batch(i, 1, p)["tokens"][0]).copy()
        toks[:SHARED_PREFIX] = base
        reqs.append(Request(rid=i, tokens=toks, max_new=GEN))
    return reqs


def moe_paged_phase(torch, ops, dev, card, sess, ring_prefill_tokens):
    """deepseek-moe-16b at full width and depth over pooled int8 pages
    (module docstring, phase 16), on the ``[moe]`` phase's session.
    Returns (launches, results, (requests, completions, engine))."""
    from repro_torch.runtime.session import summarize

    t_phase = time.perf_counter()
    cfg = sess.cfg
    # WAVE_GEN new tokens a request (GEN before the mixtral phase: the
    # script's time limit); the MOE_CUT-layer gates serve GEN
    gate_reqs = paged_requests(cfg)
    reqs = [r._replace(max_new=WAVE_GEN) for r in gate_reqs]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                         # counts: the main path only
    with fresh_route_counts(sess) as routes:
        eng, out, wall = packed_engine(torch, sess, dev, reqs, "paged")
    launches = {k: ops.launches[k] for k in SERVE_KERNELS
                + ("fake_quant_fwd",)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats
    d = st.as_dict()
    print(f"[moe-paged] {len(out)} requests sharing {SHARED_PREFIX} prompt "
          f"tokens in {wall:.2f}s wall: prefill p50 {d['prefill_p50_ms']:.2f}"
          f" ms, decode step p50 {d['decode_step_p50_ms']:.2f} ms, decode "
          f"{st.decode_tokens_per_s:.1f} tok/s ({st.decode_steps} steps, "
          f"{st.tokens_generated} tokens); prefill {st.prefill_tokens} tokens "
          f"(ring phase {ring_prefill_tokens}), prefix hits "
          f"{st.prefix_hit_tokens} tokens, {st.kv_unique_pages} of "
          f"{eng.pool.n_pages} pages in use, {st.prefill_compiles} chunk "
          f"shape(s); peak device memory {peak_gb:.2f} GB; {card}",
          flush=True)
    print(f"[moe-paged] launches {launches}; routes {routes.routes}",
          flush=True)
    print(f"[moe-paged] cut: {len(reqs)} requests of {WAVE_GEN} new "
          f"tokens ({GEN} before the mixtral phase; the script's time "
          f"limit); the {MOE_CUT}-layer token gates serve {GEN}", flush=True)
    per_step = cfg.n_layers * st.decode_steps
    gate(launches["decode_attn_quant_paged"] == per_step
         and launches["decode_attn_quant"] == 0
         and all(launches[k] > 0 for k in PAGED_KERNELS + ("fake_quant_fwd",))
         and not any(launches[k] for k in ("verify_attn_quant",
                                           "verify_attn_quant_paged")),
         f"moe paged serving launched {launches}, expected "
         f"decode_attn_quant_paged {cfg.n_layers} x {st.decode_steps} steps "
         "and no decode_attn_quant")
    gate(routes.eligible_fp == 0,
         f"{routes.eligible_fp} kernel-eligible matmuls ran dequant-fp")
    gate(set(routes.routes["decode_attn"]) == {"fused"},
         f"decode attention routes {routes.routes['decode_attn']}")
    for r in reqs:
        toks = out[r.rid].tokens
        gate(len(toks) == WAVE_GEN
             and all(0 <= t < cfg.vocab for t in toks),
             f"request {r.rid}: bad tokens {toks[:8]}...")
    gate(st.prefix_hit_tokens > 0 and st.prefill_tokens < ring_prefill_tokens,
         f"prefix hits {st.prefix_hit_tokens} tokens, prefilled "
         f"{st.prefill_tokens} (ring phase {ring_prefill_tokens})")
    eng.pool.check()
    gate(all(s is None for s in eng.slots), "occupied slots after the drain")
    s = summarize(sess)
    gate(s["packed_bytes"] == s["policy_bytes"],
         f"packed bytes {s['packed_bytes']} B, the policy's "
         f"{s['policy_bytes']:.0f} B")
    # no host sync inside a paged decode step; its launches under the
    # profiler
    prof = profile_decode_step(torch, sess, dev, "moe-paged", eng.layout,
                               watch=("decode_attn_quant_kernel",
                                      "fq_fwd_kernel"))
    st0 = sess.init_state(SLOTS, CACHE_LEN, torch.float32, device=dev,
                          layout=eng.layout)
    P = eng.layout.pages_per_slot(CACHE_LEN)
    tbl = torch.arange(SLOTS * P, dtype=torch.int32,
                       device=dev).reshape(SLOTS, P)
    st0 = {"sites": {k: c._replace(page_table=tbl)
                     for k, c in st0["sites"].items()}}
    tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.arange(SLOTS, dtype=torch.int32, device=dev) + 200
    no_sync(torch, lambda: sess.decode(sess.params, tok, pos, st0),
            "a moe paged decode step")
    print(f"[moe-paged] packed weights {s['packed_bytes']} B, the policy's "
          "exactly; one paged decode step under sync-debug 'error': no host "
          "sync", flush=True)
    del st0
    t_full = time.perf_counter() - t_phase
    greedy, unstable, _ = cut_gates(torch, ops, dev, cfg, gate_reqs,
                                    "paged", "moe-paged")
    t_all = time.perf_counter() - t_phase
    print(f"[moe-paged] phase {t_all:.1f}s ({t_full:.1f}s at full depth); "
          f"{card}", flush=True)
    return launches, dict(
        wall_s=wall, peak_mem_gb=peak_gb,
        prefill_p50_ms=d["prefill_p50_ms"],
        decode_step_p50_ms=d["decode_step_p50_ms"],
        decode_tokens_per_s=st.decode_tokens_per_s,
        decode_steps=st.decode_steps, tokens=st.tokens_generated,
        prefill_tokens=st.prefill_tokens,
        ring_prefill_tokens=ring_prefill_tokens,
        prefix_hit_tokens=st.prefix_hit_tokens,
        kv_unique_pages=st.kv_unique_pages, n_pages=eng.pool.n_pages,
        decode_step_profile=prof, packed_bytes=s["packed_bytes"],
        cut_layers=MOE_CUT, cut_greedy=greedy,
        cut_reference_unstable_rids=unstable, phase_s=t_all,
        full_depth_s=t_full), (reqs, out, eng)


def moe_spec_phase(torch, ops, dev, card, sess, layout, base):
    """deepseek-moe-16b at full width and depth decoded self-speculatively
    (``speculate=SPEC_K``, the session's ``DRAFT_BITS`` draft) over
    ``layout`` (module docstring, phase 17); ``base`` is that layout's
    token-at-a-time phase's (requests, completions, engine). Returns
    (launches, results)."""
    from repro_torch.models import lm
    from repro_torch.launch import serve

    label = f"moe-spec-{layout}"
    cfg = sess.cfg
    reqs, base_out, base_eng = base
    paged = layout == "paged"
    # the token-at-a-time phase's first wave, one request a slot into fresh
    # caches (the script's time limit; and over pages a later admission's
    # chunk has pad rows that attend the rows another history left in its
    # pages and compete for an expert's capacity: ROADMAP §3)
    # and each to WAVE_GEN new tokens, held to the first WAVE_GEN
    # of the token-at-a-time run's (the script's time limit)
    reqs = [r._replace(max_new=WAVE_GEN) for r in reqs[:SLOTS]]
    base_out = {rid: dataclasses.replace(c, tokens=c.tokens[:WAVE_GEN])
                for rid, c in base_out.items()}
    rids = {r.rid for r in reqs}
    paged_hits = sum(ev.args["tokens"] for ev in base_eng.trace.events
                     if ev.name == "prefix_hit" and ev.args["rid"] in rids)
    ops.reset_launches()                         # counts: the main path only
    with spec_probe(torch, ops) as rec, fresh_route_counts(sess) as routes:
        eng, out, wall = packed_engine(torch, sess, dev, reqs, layout,
                                    speculate=SPEC_K)
    launches = {k: ops.launches[k] for k in SERVE_KERNELS
                + ("fake_quant_fwd",)}
    st, bst = eng.stats, base_eng.stats
    d, bd = st.as_dict(), bst.as_dict()
    one = "decode_attn_quant_paged" if paged else "decode_attn_quant"
    name = "verify_attn_quant_paged" if paged else "verify_attn_quant"
    others = [k for k in ATTN_KERNELS[:4] if k not in (one, name)]
    emitted = st.tokens_generated - st.completed     # first tokens: prefill
    draft_policy_bytes = sess.policy_draft.size_bytes(
        lm.enumerate_qlayers(cfg))
    print(f"[{label}] {len(out)} requests in {wall:.2f}s wall: "
          f"{st.spec_rounds} rounds of k={SPEC_K}, accept rate "
          f"{st.spec_accept_rate:.4f} ({st.spec_accepted_tokens} of "
          f"{st.spec_draft_tokens} drafts), {emitted / st.slot_steps:.3f} "
          f"tokens per slot and round; decode {st.decode_tokens_per_s:.1f} "
          f"tok/s, round p50 {d['decode_step_p50_ms']:.2f} ms against "
          f"token-at-a-time's {bst.decode_tokens_per_s:.1f} tok/s, step p50 "
          f"{bd['decode_step_p50_ms']:.2f} ms ({bst.decode_steps} steps); "
          f"draft pack {sess.draft_bytes()} B (the {DRAFT_BITS}-bit "
          f"policy's {draft_policy_bytes:.0f} B) beside "
          f"{sess.packed_bytes()} B; {card}", flush=True)
    print(f"[{label}] launches {launches}; draft steps "
          f"{sum(rec['draft_steps'])}; routes {routes.routes}", flush=True)
    # one verify launch per layer and round, no one-token launch inside the
    # verify pass; the draft steps launch the one-token kernel
    gate(st.spec_rounds == len(rec["verify"]) > 0,
         f"{st.spec_rounds} rounds, {len(rec['verify'])} verify passes")
    gate(all(v[name] == cfg.n_layers and v[one] == 0 for v in rec["verify"]),
         f"verify passes launched {rec['verify'][:3]}..., expected "
         f"{cfg.n_layers} x {name} and no {one}")
    gate(launches[name] == cfg.n_layers * st.spec_rounds
         and launches[one] == cfg.n_layers * sum(rec["draft_steps"])
         and all(launches[k] == 0 for k in others)
         and all(launches[k] > 0 for k in ("quant_matmul", "quant_matmul_w4",
                                           "fake_quant_fwd")),
         f"{label} launched {launches}")
    gate(routes.eligible_fp == 0,
         f"{routes.eligible_fp} kernel-eligible matmuls ran dequant-fp")
    gate(abs(sess.draft_bytes() / draft_policy_bytes - 1) <= 0.01,
         f"draft bytes {sess.draft_bytes()} vs the {DRAFT_BITS}-bit policy's "
         f"{draft_policy_bytes:.0f}")
    gate(set(out) == rids, f"served rids {sorted(out)}, expected "
         f"{sorted(rids)}")
    for r in reqs:
        toks = out[r.rid].tokens
        gate(len(toks) == WAVE_GEN
             and all(0 <= t < cfg.vocab for t in toks),
             f"request {r.rid}: bad tokens {toks[:8]}...")
    same, total, compared, bad = serve.compare_spec(out, base_eng, base_out)
    print(f"[{label}] tokens vs token-at-a-time over the {layout}: {same} of "
          f"{total} identical over rids {sorted(out)}, {compared} decisive "
          f"steps compared, differing rids {bad}", flush=True)
    gate(not bad and compared > 0,
         f"speculative tokens differ on a decisive step: rids {bad}")
    gate(all(s is None for s in eng.slots), "occupied slots after the drain")
    if paged:
        eng.pool.check()
        gate(st.prefix_hit_tokens == paged_hits,
             f"prefix hits {st.prefix_hit_tokens} tokens, the paged phase's "
             f"first wave {paged_hits}")
    return launches, dict(
        wall_s=wall, rounds=st.spec_rounds, accept_rate=st.spec_accept_rate,
        drafted=st.spec_draft_tokens, accepted=st.spec_accepted_tokens,
        tokens_per_slot_round=emitted / st.slot_steps,
        decode_tokens_per_s=st.decode_tokens_per_s,
        round_p50_ms=d["decode_step_p50_ms"],
        base_decode_tokens_per_s=bst.decode_tokens_per_s,
        base_step_p50_ms=bd["decode_step_p50_ms"],
        identical_tokens=same, tokens=total, decisive_compared=compared,
        rids=sorted(out), draft_bytes=sess.draft_bytes(),
        draft_policy_bytes=draft_policy_bytes,
        packed_bytes=sess.packed_bytes(),
        prefix_hit_tokens=st.prefix_hit_tokens,
        draft_steps=sum(rec["draft_steps"]))


def moe_train_phase(torch, ops, dev):
    """The paper pipeline on deepseek-moe-16b at full width, cut to
    ``MOE_TRAIN_LAYERS`` layers (module docstring, phase 18), then gate (e)
    at ``MOE_TRAIN_CUT``. Returns (launch counts of the pipeline's run,
    results)."""
    torch.cuda.reset_peak_memory_stats()
    launches, res, params, _ = train_phase(
        torch, ops, dev, arch=MOE_ARCH, label="moe-train", hawq=False,
        remat=False, n_layers=MOE_TRAIN_LAYERS)
    del params
    torch.cuda.empty_cache()
    res["vs_plain"] = vs_plain_gates(torch, ops, dev, MOE_ARCH, MOE_TRAIN_CUT,
                                     "moe-train")
    return launches, res


def vision_train_phase(torch, ops, dev):
    """The paper pipeline on llama-3.2-vision-11b at full width, cut to one
    unit of its pattern (``VISION_CUT``: 5 self-attention layers and a gated
    cross layer; module docstring, phase 23), then gate (e) at that depth,
    the least that holds a cross layer. Every cross gate is set to
    ``VISION_GATE`` first: at the reference's init (0) the cross site's 14
    bank leaves get a gradient of exactly 0, so the importance steps could
    not move them (gate (c)). Returns (launch counts of the pipeline's run,
    results)."""
    def gates(params):
        with torch.no_grad():
            set_cross_gates(params)

    torch.cuda.reset_peak_memory_stats()
    launches, res, params, _ = train_phase(
        torch, ops, dev, arch=VISION_ARCH, label="vision-train", hawq=False,
        remat=False, n_layers=VISION_CUT, prep=gates)
    del params
    torch.cuda.empty_cache()
    res["vs_plain"] = vs_plain_gates(torch, ops, dev, VISION_ARCH, VISION_CUT,
                                     "vision-train", prep=gates,
                                     flash_alone=True)
    return launches, res


def vision_requests(cfg):
    """The serve phase's 8 requests, each carrying one of two seeded
    (n_image_tokens, 1280) float32 patch-embedding images (alternating, so
    every slot serves both in turn), and the two images."""
    rng = np.random.default_rng(1280)
    imgs = [rng.standard_normal((cfg.n_image_tokens, 1280)).astype(np.float32)
            for _ in range(2)]
    reqs = [r._replace(extra_inputs={"img": imgs[r.rid % 2]})
            for r in serve_requests(cfg)]
    return reqs, imgs


def set_cross_gates(tree, value: float = VISION_GATE) -> None:
    """Every cross layer's ``gate_attn`` and ``gate_mlp`` in ``tree`` (one
    site's params or a whole param tree) set to ``value`` in place: the
    reference inits them to 0, which hides the image."""
    for k, v in tree.items():
        if k in ("gate_attn", "gate_mlp"):
            v.fill_(value)
        elif isinstance(v, dict):
            set_cross_gates(v, value)


@contextlib.contextmanager
def cross_gates(torch, sess, value: float):
    """The packed session's cross-layer gates set to ``value`` for the
    scope (the packed tree's gate tensors swapped, then restored)."""
    keys = [k for k, sp in sess.params["sites"].items() if "gate_attn" in sp]
    keep = {k: {g: sess.params["sites"][k][g] for g in ("gate_attn",
                                                          "gate_mlp")}
            for k in keys}
    for k in keys:
        for g, t in keep[k].items():
            sess.params["sites"][k][g] = torch.full_like(t, value)
    try:
        yield
    finally:
        for k in keys:
            sess.params["sites"][k].update(keep[k])


def vision_kernel_rows(torch, ops, ref, dev):
    """The ring kernels at llama-3.2-vision-11b's shapes: both matmuls at
    M = 4 on its decode projections, the int8 one at M = 1600 on the
    image K/V projection, decode attention at KV 8, G 4 over the 320-row
    ring; each held to its plain version and timed beside it."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = [matmul_row(torch, ops, ref, flush, dev, w4, 4, K, N)
            for w4 in (False, True) for K, N in VISION_KN]
    rows.append(matmul_row(torch, ops, ref, flush, dev, False, VISION_IMG_M,
                           *VISION_IMG_KN))
    rows += [decode_attn_row(torch, ops, ref, flush, dev, *c)
             for c in VISION_ATTN]
    del flush
    return rows


def vision_serve_phase(torch, ops, ref, dev, card):
    """llama-3.2-vision-11b at full width and depth over the ring (module
    docstring, phase 19). Returns (kernel rows, launches, results)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.runtime.session import summarize

    t_phase = time.perf_counter()
    rows = vision_kernel_rows(torch, ops, ref, dev)
    t_rows = time.perf_counter() - t_phase
    cfg = get_config(VISION_ARCH)
    sites = lm.iter_sites(cfg)
    n_cross = sum(s.kind == "cross" for s in sites)
    n_self = len(sites) - n_cross
    ql = lm.enumerate_qlayers(cfg)
    n_params = lm.param_count(lm.init_params(cfg, device="meta"))
    policy = serve.demo_mixed_policy(cfg)
    reqs, imgs = vision_requests(cfg)
    sched = lm.build_schedule(cfg)
    print(f"[vision] {cfg.name}: {len(sites)} sites, {sched.pattern} x "
          f"{sched.repeats} ({n_self} self-attention, {n_cross} gated "
          f"cross-attention over {cfg.n_image_tokens} image tokens), "
          f"d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"(G={cfg.n_heads // cfg.n_kv_heads}) head_dim={cfg.hd} d_ff="
          f"{cfg.d_ff} vocab={cfg.vocab}; {len(ql)} projections, "
          f"{n_params} parameters ({4 * n_params / 1e9:.1f} GB f32); every "
          f"cross layer's gate_attn and gate_mlp set to {VISION_GATE} (the "
          f"reference's init of 0 hides the image); {card}", flush=True)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                         # counts: the main path only
    t0 = time.perf_counter()
    outer, source = lm.site_source(cfg, device=dev, prep=set_cross_gates)
    sess = serve.build_session(cfg, outer, policy, site_source=source)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    del outer
    # the full-depth run serves the first wave (4 requests of WAVE_GEN new
    # tokens, both images), cut for the script's time limit; the token
    # gates at one unit keep all 8 requests
    wave = [r._replace(max_new=WAVE_GEN) for r in reqs[:SLOTS]]
    with fresh_route_counts(sess) as routes:
        eng, out, wall = packed_engine(torch, sess, dev, wave)
    launches = {k: ops.launches[k] for k in SERVE_KERNELS
                + ("fake_quant_fwd",)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats
    d = st.as_dict()
    print(f"[vision] packed site by site (seeded init) in {pack_s:.2f}s; "
          f"ring KV: {len(out)} requests (2 images) in {wall:.2f}s wall: "
          f"prefill p50 {d['prefill_p50_ms']:.2f} ms, decode step p50 "
          f"{d['decode_step_p50_ms']:.2f} ms, decode "
          f"{st.decode_tokens_per_s:.1f} tok/s ({st.decode_steps} steps, "
          f"{st.tokens_generated} tokens, {st.prefill_tokens} prompt "
          f"tokens); peak device memory {peak_gb:.2f} GB; {card}",
          flush=True)
    print(f"[vision] launches {launches}; routes {routes.routes}", flush=True)
    # (a) the ring kernels and the pinned fake-quant launched, no other
    # layout's; no kernel-eligible projection on dequant-fp
    gate(all(launches[k] > 0 for k in RING_KERNELS + ("fake_quant_fwd",))
         and not any(launches[k] for k in SERVE_KERNELS
                     if k not in RING_KERNELS),
         f"vision serving launched {launches}")
    gate(routes.eligible_fp == 0,
         f"{routes.eligible_fp} kernel-eligible matmuls ran dequant-fp")
    gate(set(routes.routes["decode_attn"]) == {"fused"},
         f"decode attention routes {routes.routes['decode_attn']}")
    for r in wave:
        toks = out[r.rid].tokens
        gate(len(toks) == WAVE_GEN and all(0 <= t < cfg.vocab for t in toks),
             f"request {r.rid}: bad tokens {toks[:8]}...")
    # (e) packed bytes exactly the policy's
    s = summarize(sess)
    print(f"[vision] packed weights {s['packed_bytes']} B vs policy "
          f"{s['policy_bytes']:.0f} B (x{s['packed_vs_policy']:.4f})",
          flush=True)
    gate(s["packed_bytes"] == s["policy_bytes"],
         f"packed bytes {s['packed_bytes']} B, the policy's "
         f"{s['policy_bytes']:.0f} B")

    # one prefill: every projection on a matmul kernel (the cross layers'
    # wk / wv once, at M = n_image_tokens), the pinned image projection's
    # and head's weight and input on fake-quant
    def prefill(img, tokens=reqs[0].tokens):
        return sess.prefill(sess.params, {
            "tokens": torch.as_tensor(tokens, device=dev)[None],
            "img": torch.as_tensor(img, device=dev)[None]},
            prefill_cap=CACHE_LEN)

    prefill(imgs[0])
    torch.cuda.synchronize()
    ops.reset_launches()
    pre_logits, row = prefill(imgs[0])
    torch.cuda.synchronize()
    pre = {k: ops.launches[k] for k in ("quant_matmul", "quant_matmul_w4",
                                         "decode_attn_quant",
                                         "fake_quant_fwd")}
    want_pre = {"quant_matmul+w4": len(ql), "fake_quant_fwd": 4}
    got_pre = {"quant_matmul+w4": pre["quant_matmul"]
               + pre["quant_matmul_w4"],
               "fake_quant_fwd": pre["fake_quant_fwd"]}
    print(f"[vision] one prefill ({len(reqs[0].tokens)} tokens, one image): "
          f"launches {pre}", flush=True)
    gate(got_pre == want_pre,
         f"one prefill launched {got_pre}, expected {want_pre}")
    gate(bool(torch.isfinite(pre_logits).all()), "non-finite prefill logits")
    # (d) the image is read: the same prompt under the two images, with
    # the gates at VISION_GATE and at 0
    other, _ = prefill(imgs[1])
    diff = float((pre_logits - other).abs().max())
    with cross_gates(torch, sess, 0.0):
        z0, _ = prefill(imgs[0])
        z1, _ = prefill(imgs[1])
    torch.cuda.synchronize()
    print(f"[vision] the image is read: request 0's prefill logits under "
          f"the two images differ by max |diff| {diff:.4f} with the gates "
          f"at {VISION_GATE}; with them at 0 they are bit for bit "
          f"{'equal' if torch.equal(z0, z1) else 'DIFFERENT'}", flush=True)
    gate(diff > 1e-3, f"the image moved the prefill logits by {diff} only")
    gate(torch.equal(z0, z1),
         "with the gates at 0 the prefill logits depend on the image")
    del other, z0, z1

    # (a) one decode step launches what the schedule implies: every
    # projection but the cross layers' wk / wv on a matmul kernel, one
    # attention launch a self-attention layer, two fake-quant launches for
    # the untied pinned head; the slots read request 0's image K/V
    state = sess.init_state(SLOTS, CACHE_LEN, torch.float32, device=dev)
    for site in sites:
        if site.kind == "cross":
            key = lm.site_key(site.gidx)
            for t, r in zip(state["sites"][key], row["sites"][key]):
                t.copy_(r.expand_as(t))
    want_step = {"quant_matmul+w4": len(ql) - 2 * n_cross,
                 "decode_attn_quant": n_self, "fake_quant_fwd": 2}
    tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.arange(SLOTS, dtype=torch.int32, device=dev) + 200
    ops.reset_launches()
    with fresh_route_counts(sess) as counts:
        logits, _ = sess.decode(sess.params, tok, pos, state)
        again, _ = sess.decode(sess.params, tok, pos, state)
        torch.cuda.synchronize()
    step = {k: ops.launches[k] // 2 for k in ("quant_matmul",
                                               "quant_matmul_w4",
                                               "decode_attn_quant",
                                               "fake_quant_fwd")}
    got_step = {"quant_matmul+w4": step["quant_matmul"]
                + step["quant_matmul_w4"],
                "decode_attn_quant": step["decode_attn_quant"],
                "fake_quant_fwd": step["fake_quant_fwd"]}
    print(f"[vision] one decode step: launches {step}, routes "
          f"{ {k: v // 2 for k, v in counts.routes['matmul'].items()} }",
          flush=True)
    gate(counts.eligible_fp == 0 and "dequant-fp" not in
         counts.routes["matmul"],
         f"one decode step ran matmuls dequant-fp: {counts.routes}")
    gate(got_step == want_step,
         f"one decode step launched {got_step}, expected {want_step}")
    # (c) finite logits; the step is deterministic on the card
    gate(bool(torch.isfinite(logits).all()), "non-finite decode logits")
    gate(torch.equal(logits, again),
         "two equal vision decode steps gave different logits")
    # (b) no host sync inside a decode step
    no_sync(torch, lambda: sess.decode(sess.params, tok, pos, state),
            "a vision decode step")
    print("[vision] one decode step under sync-debug 'error': no host sync; "
          "prefill and decode logits finite, two equal steps bit for bit "
          "equal", flush=True)
    prof = profile_decode_step(
        torch, sess, dev, "vision",
        watch=("decode_attn_quant_kernel", "qmm_splitk_kernel",
               "qmm_w4_splitk_kernel", "fq_fwd_kernel"))
    del state, logits, again, pre_logits, row, sess, eng
    torch.cuda.empty_cache()
    t_full = time.perf_counter() - t_phase
    # (f) the token gates at one unit of the pattern, full width: the
    # reference engines (float32 and float64) at 48 sites would take the
    # phase past its time budget
    print(f"[vision] cut: the token gates run at {VISION_CUT} layers (one "
          f"unit: {VISION_CUT} self-attention layers and a cross layer, "
          "full width), not at 48 sites: two reference engines (float32 "
          "and float64) over the 46.1 GB float32 tree would take the "
          "phase past its time budget", flush=True)
    greedy, unstable, _ = cut_gates(torch, ops, dev, cfg, reqs, "ring",
                                    "vision", n_layers=VISION_CUT,
                                    prep=set_cross_gates)
    t_all = time.perf_counter() - t_phase
    print(f"[vision] phase {t_all:.1f}s (kernel rows {t_rows:.1f}s, full "
          f"depth {t_full - t_rows:.1f}s); {card}", flush=True)
    res = dict(
        parameters=n_params, projections=len(ql), pack_s=pack_s,
        wall_s=wall, peak_mem_gb=peak_gb,
        prefill_p50_ms=d["prefill_p50_ms"],
        decode_step_p50_ms=d["decode_step_p50_ms"],
        decode_tokens_per_s=st.decode_tokens_per_s,
        decode_steps=st.decode_steps, tokens=st.tokens_generated,
        prefill_tokens=st.prefill_tokens, prefill_launches=pre,
        decode_step_launches=step, decode_step_profile=prof,
        image_logit_diff=diff, gate_value=VISION_GATE,
        cut_layers=VISION_CUT, cut_greedy=greedy,
        cut_reference_unstable_rids=unstable,
        packed_bytes=s["packed_bytes"], policy_bytes=s["policy_bytes"],
        phase_s=t_all, kernel_rows_s=t_rows)
    return rows, launches, res


def mixtral_requests(cfg, gen=WAVE_GEN):
    """The serve phase's first ``MIXTRAL_SHORT`` prompts and one of
    ``MIXTRAL_LONG`` tokens (``SyntheticLM``), ``gen`` new tokens each."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.scheduler import Request
    long_ = SyntheticLM(cfg).batch(len(PROMPTS), 1, MIXTRAL_LONG)
    reqs = serve_requests(cfg, MIXTRAL_SHORT) + [Request(
        rid=MIXTRAL_SHORT, tokens=long_["tokens"][0], max_new=GEN)]
    return [r._replace(max_new=gen) for r in reqs]


def mixtral_kernel_rows(torch, ops, ref, dev):
    """The kernels at mixtral-8x7b's new shapes (``MIXTRAL_ATTN``,
    ``MIXTRAL_FLASH``, ``FQ_MIXTRAL_SHAPES``), each held to its plain
    version and timed beside it and its library call."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = [decode_attn_row(torch, ops, ref, flush, dev, *c)
            for c in MIXTRAL_ATTN]
    rows.append(flash_row(torch, ops, ref, flush, dev, *MIXTRAL_FLASH))
    rows += [r for shape in FQ_MIXTRAL_SHAPES
             for r in fake_quant_expert_row(torch, ops, ref, flush, dev,
                                            shape)]
    del flush
    return rows


def mixtral_serve_phase(torch, ops, ref, dev, card):
    """mixtral-8x7b at full width and depth over the int8 ring, one prompt
    past its window (module docstring, phase 20). Returns (kernel rows,
    launches, results)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.runtime import packing
    from repro_torch.runtime.session import summarize

    t_phase = time.perf_counter()
    rows = mixtral_kernel_rows(torch, ops, ref, dev)
    t_rows = time.perf_counter() - t_phase
    cfg = get_config(MIXTRAL_ARCH)
    moe = cfg.moe
    window = lm.attn_window(cfg)
    G = cfg.n_heads // cfg.n_kv_heads
    ql = lm.enumerate_qlayers(cfg)
    n_proj, n_stacks = len(ql), sum(q.n_mats > 1 for q in ql)
    n_params = lm.param_count(lm.init_params(cfg, device="meta"))
    res = {"combine": moe_combine_check(torch, dev, cfg,
                                        calls=(SLOTS, MIXTRAL_LONG),
                                        label="mixtral")}
    policy = serve.demo_mixed_policy(cfg)
    reqs = mixtral_requests(cfg, MIXTRAL_GEN)
    with open("/proc/meminfo") as f:
        mem = {ln.split(":")[0]: ln.split(":")[1].strip() for ln in f}
    sched = lm.build_schedule(cfg)
    print(f"[mixtral] {cfg.name}: {cfg.n_layers} layers {sched.prefix} + "
          f"{sched.pattern} x {sched.repeats}, d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} (G={G}) head_dim={cfg.hd}, "
          f"sliding window {window}; {moe.n_experts} routed experts of d_ff "
          f"{moe.d_ff}, top-{moe.top_k}, {moe.n_shared} shared; vocab "
          f"{cfg.vocab}; {n_proj} projections ({n_stacks} expert stacks), "
          f"{n_params} parameters ({4 * n_params / 1e9:.1f} GB f32); "
          f"prompts {[len(r.tokens) for r in reqs]}, {MIXTRAL_GEN} new "
          f"tokens each ({WAVE_GEN} in the {MIXTRAL_CUT}-layer gates; cut "
          f"for the script's time limit); host MemTotal {mem.get('MemTotal')}, MemAvailable "
          f"{mem.get('MemAvailable')}; {card}", flush=True)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                         # counts: the main path only
    t0 = time.perf_counter()
    outer, source = lm.site_source(cfg, device=dev)
    sess = serve.build_session(cfg, outer, policy, site_source=source)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    del outer
    res["checksum"] = packed_checksum(torch, sess)   # phase 21's gate
    with fresh_route_counts(sess) as routes:
        eng, out, wall = packed_engine(torch, sess, dev, reqs,
                                       cache_len=window,
                                       prefill_chunk=MIXTRAL_LONG)
    launches = {k: ops.launches[k] for k in SERVE_KERNELS
                + ("fake_quant_fwd", "flash_fwd")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats
    d = st.as_dict()
    pre_ms = {ev.args["rid"]: ev.dur * 1e3 for ev in eng.trace.events
              if ev.name == "prefill"}
    short_ms = statistics.median(pre_ms[r.rid] for r in reqs[:-1])
    long_ms = pre_ms[reqs[-1].rid]
    print(f"[mixtral] packed site by site (seeded init) in {pack_s:.2f}s; "
          f"ring KV of {window} rows a slot: {len(out)} requests in "
          f"{wall:.2f}s wall: prefill p50 {d['prefill_p50_ms']:.2f} ms "
          f"(the short prompts' p50 {short_ms:.2f} ms, the "
          f"{MIXTRAL_LONG}-token one {long_ms:.2f} ms), decode step p50 "
          f"{d['decode_step_p50_ms']:.2f} ms, decode "
          f"{st.decode_tokens_per_s:.2f} tok/s ({st.decode_steps} steps, "
          f"{st.tokens_generated} tokens, {st.prefill_tokens} prompt "
          f"tokens); peak device memory {peak_gb:.2f} GB; {card}",
          flush=True)
    print(f"[mixtral] launches {launches}; routes {routes.routes}",
          flush=True)
    # (a) the ring kernels, the per-expert fake-quant and flash launched, no
    # other layout's; flash once per layer, in the long prompt's prefill
    # alone; no kernel-eligible projection on dequant-fp
    gate(all(launches[k] > 0 for k in RING_KERNELS + ("fake_quant_fwd",))
         and not any(launches[k] for k in SERVE_KERNELS
                     if k not in RING_KERNELS),
         f"mixtral serving launched {launches}")
    gate(launches["flash_fwd"] == cfg.n_layers,
         f"flash_fwd launched {launches['flash_fwd']} times, expected "
         f"{cfg.n_layers} (one a layer in the {MIXTRAL_LONG}-token prefill)")
    gate(routes.eligible_fp == 0,
         f"{routes.eligible_fp} kernel-eligible matmuls ran dequant-fp")
    gate(set(routes.routes["decode_attn"]) == {"fused"},
         f"decode attention routes {routes.routes['decode_attn']}")
    for r in reqs:
        toks = out[r.rid].tokens
        gate(len(toks) == MIXTRAL_GEN
             and all(0 <= t < cfg.vocab for t in toks),
             f"request {r.rid}: bad tokens {toks[:8]}...")
    # (c) packed bytes exactly the policy's
    s = summarize(sess)
    print(f"[mixtral] packed weights {s['packed_bytes']} B vs policy "
          f"{s['policy_bytes']:.0f} B (x{s['packed_vs_policy']:.4f})",
          flush=True)
    gate(s["packed_bytes"] == s["policy_bytes"],
         f"packed bytes {s['packed_bytes']} B, the policy's "
         f"{s['policy_bytes']:.0f} B")

    # (b) one decode step's routes and launches, as the schedule implies
    # them: every attention projection on a matmul kernel, the expert
    # stacks on dequant-fp, one attention launch a layer over slots of the
    # window's rows past it, one fake-quant launch per expert input group
    # and two for the untied pinned head
    expert_pls = [pl for pl in packing.packed_leaves(sess.params)
                  if len(pl.shape) == 3]
    n_fq = len({pl.a_group or id(pl) for pl in expert_pls})
    pinned = 0 if cfg.tie_embeddings else 2
    want_step = {"quant_matmul+w4": n_proj - n_stacks,
                 "decode_attn_quant": cfg.n_layers,
                 "fake_quant_fwd": n_fq + pinned}
    state = sess.init_state(SLOTS, window, torch.float32, device=dev)
    tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    pos = torch.arange(SLOTS, dtype=torch.int32, device=dev) + MIXTRAL_LONG
    ops.reset_launches()
    with fresh_route_counts(sess) as counts:
        logits, _ = sess.decode(sess.params, tok, pos, state)
        again, _ = sess.decode(sess.params, tok, pos, state)
        torch.cuda.synchronize()
    step = {k: ops.launches[k] // 2 for k in ("quant_matmul",
                                               "quant_matmul_w4",
                                               "decode_attn_quant",
                                               "fake_quant_fwd")}
    got_step = {"quant_matmul+w4": step["quant_matmul"]
                + step["quant_matmul_w4"],
                "decode_attn_quant": step["decode_attn_quant"],
                "fake_quant_fwd": step["fake_quant_fwd"]}
    fp_step = counts.routes["matmul"].get("dequant-fp", 0) // 2
    print(f"[mixtral] one decode step: launches {step}, routes "
          f"{ {k: v // 2 for k, v in counts.routes['matmul'].items()} }",
          flush=True)
    gate(fp_step == n_stacks == 3 * cfg.n_layers,
         f"one decode step ran {fp_step} dequant-fp matmuls, expected the "
         f"{3 * cfg.n_layers} expert stacks")
    gate(got_step == want_step,
         f"one decode step launched {got_step}, expected {want_step}")
    # (f) finite logits; the step is deterministic on the card
    gate(bool(torch.isfinite(logits).all()), "non-finite decode logits")
    gate(torch.equal(logits, again),
         "two equal mixtral decode steps gave different logits")
    # (e) no host sync inside a decode step
    no_sync(torch, lambda: sess.decode(sess.params, tok, pos, state),
            "a mixtral decode step")
    print("[mixtral] one decode step under sync-debug 'error': no host "
          "sync; logits finite, two equal steps bit for bit equal",
          flush=True)
    del state, logits, again
    # (d) the profiled step (slots of the window's rows past it); then one
    # short and the long prompt's prefill: flash once a layer in the long
    # one alone
    prof = profile_decode_step(
        torch, sess, dev, "mixtral",
        watch=("decode_attn_quant_kernel", "qmm_splitk_kernel",
               "qmm_w4_splitk_kernel", "fq_fwd_kernel"),
        cache_len=window, pos0=MIXTRAL_LONG)
    short = torch.as_tensor(reqs[0].tokens, device=dev)[None]
    n0 = ops.launches["flash_fwd"]
    pre_logits, _ = sess.prefill(sess.params, short, prefill_cap=window)
    torch.cuda.synchronize()
    gate(ops.launches["flash_fwd"] == n0,
         f"a {short.shape[1]}-token prefill launched flash_fwd")
    gate(bool(torch.isfinite(pre_logits).all()), "non-finite prefill logits")
    t_long = torch.as_tensor(reqs[-1].tokens, device=dev)[None]
    pre = profile_device(torch, lambda: sess.prefill(
        sess.params, t_long, prefill_cap=window), top=4,
        watch=("flash_fwd_kernel", "qmm_mma_kernel", "qmm_w4_mma_kernel",
               "fq_fwd_kernel"))
    print_profile("mixtral", f"one {MIXTRAL_LONG}-token prefill", pre)
    gate(ops.launches["flash_fwd"] - n0 == cfg.n_layers,
         f"a {MIXTRAL_LONG}-token prefill launched "
         f"{ops.launches['flash_fwd'] - n0} flash kernels, expected "
         f"{cfg.n_layers}")
    print(f"[mixtral] at {cfg.n_layers} layers the float32 tree "
          f"({4 * n_params / 1e9:.1f} GB) and a fake-quant reference engine "
          "fit neither the card nor the host: no reference comparison at "
          "full depth", flush=True)
    del pre_logits, sess, eng
    torch.cuda.empty_cache()
    t_full = time.perf_counter() - t_phase
    # (b) the token gates and the logit gate over a short prompt and the
    # long one, at two MoE layers, full width
    greedy, unstable, noise = cut_gates(
        torch, ops, dev, cfg, mixtral_requests(cfg), "ring", "mixtral",
        n_layers=MIXTRAL_CUT,
        cache_len=window, prefill_chunk=MIXTRAL_LONG,
        noise=(0, len(reqs) - 1))
    t_all = time.perf_counter() - t_phase
    print(f"[mixtral] phase {t_all:.1f}s (kernel rows {t_rows:.1f}s, full "
          f"depth {t_full - t_rows:.1f}s); {card}", flush=True)
    res.update(
        parameters=n_params, projections=n_proj, expert_stacks=n_stacks,
        window=window, pack_s=pack_s, wall_s=wall, peak_mem_gb=peak_gb,
        host_mem_total=mem.get("MemTotal"),
        host_mem_available=mem.get("MemAvailable"),
        prefill_p50_ms=d["prefill_p50_ms"], prefill_short_p50_ms=short_ms,
        prefill_long_ms=long_ms,
        decode_step_p50_ms=d["decode_step_p50_ms"],
        decode_tokens_per_s=st.decode_tokens_per_s,
        decode_steps=st.decode_steps, tokens=st.tokens_generated,
        prefill_tokens=st.prefill_tokens, decode_step_launches=step,
        decode_step_dequant_fp=fp_step, decode_step_profile=prof,
        long_prefill_profile=pre, cut_layers=MIXTRAL_CUT, cut_greedy=greedy,
        cut_reference_unstable_rids=unstable, cut_logits=noise,
        packed_bytes=s["packed_bytes"], policy_bytes=s["policy_bytes"],
        phase_s=t_all, kernel_rows_s=t_rows)
    return rows, launches, res


@contextlib.contextmanager
def build_clock(torch, serve):
    """``serve.build_session`` timed for the scope: the ``perf_counter``
    reading when it returns, its pack fenced, under ``"t"``."""
    saved, done = serve.build_session, {}

    def timed(*args, **kw):
        sess = saved(*args, **kw)
        torch.cuda.synchronize()
        done["t"] = time.perf_counter()
        return sess

    serve.build_session = timed
    try:
        yield done
    finally:
        serve.build_session = saved


def packed_checksum(torch, sess, chunk: int = 1 << 24) -> str:
    """A digest of a session's packed codes, weight scales and activation
    scales, every ``PackedLinear`` of its served tree in order: per tensor
    the sum of its bytes and the sum of each byte times its index mod
    65521 plus one, exact in int64 on the card (chunks of ``chunk``
    bytes), then sha256 of those sums on the host."""
    import hashlib
    from repro_torch.runtime import packing
    sums = []
    for pl in packing.packed_leaves(sess.params):
        for t in (pl.codes, pl.scale, pl.s_a):
            b = t.contiguous().reshape(-1).view(torch.uint8)
            s1 = torch.zeros((), dtype=torch.int64, device=b.device)
            s2 = torch.zeros((), dtype=torch.int64, device=b.device)
            for i in range(0, b.numel(), chunk):
                v = b[i:i + chunk].to(torch.int64)
                w = torch.arange(i, i + v.numel(), device=b.device) % 65521
                s1 += v.sum()
                s2 += (v * (w + 1)).sum()
            sums += [s1, s2]
    return hashlib.sha256(
        torch.stack(sums).cpu().numpy().tobytes()).hexdigest()[:16]


def cli_large_phase(torch, ops, dev, card, checksums):
    """The serve CLI (``serve.main``) at full width and depth on the large
    decoders (module docstring, phase 21): deepseek-moe-16b, mixtral-8x7b
    and granite-20b built and packed site by site, yi-9b whole; then the
    token gates at 2 layers for the two dense ones. ``checksums``: the
    ``[moe]`` and ``[mixtral]`` sessions' ``packed_checksum`` by arch.
    Returns (each kernel's launches over the four runs, results by
    arch)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.runtime.session import summarize

    total = torch.cuda.get_device_properties(dev).total_memory
    launches_all = dict.fromkeys(SERVE_KERNELS, 0)
    res = {}
    for arch, by_site, n_req, gen in CLI_LARGE:
        cfg = get_config(arch)
        label = f"[cli-large] {arch}"
        argv = ["--arch", arch, "--requests", str(n_req),
                "--slots", str(SLOTS), "--prompt-len", str(CLI_LARGE_PROMPT),
                "--gen", str(gen), "--cache-len", str(CACHE_LEN),
                "--compare"] + (["--site-by-site"] if by_site else [])
        n_params = lm.param_count(lm.init_params(cfg, device="meta"))
        print(f"{label}: {cfg.n_layers} layers d_model={cfg.d_model} "
              f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff}, "
              f"{n_params} parameters ({4 * n_params / 1e9:.1f} GB f32), "
              f"{'site by site' if by_site else 'whole tree'}; serve "
              f"{' '.join(argv)}", flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()                     # counts: this run only
        t0 = time.perf_counter()
        with build_clock(torch, serve) as built:
            run = _serve_cli(serve, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        build_s = built["t"] - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {k: ops.launches[k] for k in SERVE_KERNELS}
        for k in SERVE_KERNELS:
            launches_all[k] += launches[k]
        sess, eng = run["sess"], run["eng"]
        st, routes = eng.stats, sess.route_counts
        d = st.as_dict()
        # the CLI's own gates (token-identical with the fixed batch, the
        # trace against the stats, a finite calibration) exit on failure:
        # that they ran is the gate here
        gate("fixed" in run and run["calibration"]["finite"]
             and eng.trace is not None,
             f"{label}: --compare's gates did not run")
        gate(all(launches[k] > 0 for k in RING_KERNELS)
             and not any(launches[k] for k in SERVE_KERNELS
                         if k not in RING_KERNELS),
             f"{label}: the CLI's runs launched {launches}")
        gate(routes.eligible_fp == 0,
             f"{label}: {routes.eligible_fp} kernel-eligible matmuls ran "
             "dequant-fp")
        gate(set(routes.routes["decode_attn"]) == {"fused"}
             and eng.decode_attn_route == "fused",
             f"{label}: decode attention routes {routes.routes['decode_attn']}")
        for rid, c in run["completions"].items():
            gate(len(c.tokens) == gen
                 and all(0 <= t < cfg.vocab for t in c.tokens),
                 f"{label} request {rid}: bad tokens {c.tokens[:8]}...")
        s = summarize(sess)
        gate(s["packed_bytes"] == CLI_LARGE_BYTES[arch] == s["policy_bytes"],
             f"{label}: packed bytes {s['packed_bytes']} B, the policy's "
             f"{s['policy_bytes']:.0f} B, expected {CLI_LARGE_BYTES[arch]}")
        gate(peak < total, f"{label}: peak device memory {peak} B of {total}")
        step = step_launches(torch, ops, sess, dev)
        gate(step.get("decode_attn_quant") == cfg.n_layers,
             f"{label}: one decode step launched {step}, expected "
             f"{cfg.n_layers} decode_attn_quant")
        checksum = packed_checksum(torch, sess)
        if arch in checksums:
            gate(checksum == checksums[arch],
                 f"{label}: packed checksum {checksum}, the site-by-site "
                 f"phase's {checksums[arch]}")
        res[arch] = dict(
            site_by_site=by_site, argv=argv, params=n_params,
            init_pack_s=build_s, wall_s=wall,
            prefill_p50_ms=d["prefill_p50_ms"],
            decode_step_p50_ms=d["decode_step_p50_ms"],
            decode_tokens_per_s=st.decode_tokens_per_s,
            decode_steps=st.decode_steps,
            fixed_decode_steps=run["fixed"].stats.decode_steps,
            prefill_chunk=eng.prefill_chunk, peak_mem_gb=peak / 1e9,
            launches=launches, decode_step_launches=step,
            packed_bytes=s["packed_bytes"], checksum=checksum)
        print(f"{label}: init + pack {build_s:.2f}s ({wall:.2f}s for the "
              f"CLI with --compare's fixed rerun); prefill p50 "
              f"{d['prefill_p50_ms']:.2f} ms, decode step p50 "
              f"{d['decode_step_p50_ms']:.2f} ms, decode "
              f"{st.decode_tokens_per_s:.2f} tok/s ({st.decode_steps} steps "
              f"vs {run['fixed'].stats.decode_steps} fixed, "
              f"{st.tokens_generated} tokens, prefill chunk "
              f"{eng.prefill_chunk}); peak device memory {peak / 1e9:.2f} "
              f"GB; {card}", flush=True)
        print(f"{label}: launches {launches}; one decode step {step}; "
              f"packed weights {s['packed_bytes']} B = policy; checksum "
              f"{checksum}" + (f" = the site-by-site phase's"
                               if arch in checksums else ""), flush=True)
        del run, sess, eng
        torch.cuda.empty_cache()
        if not cfg.moe:
            # no full-width phase gates the dense ones' tokens: phase 12's
            # (b) at 2 layers
            cut, greedy, unstable = exact_sum_gates(
                torch, ops, dev, cfg, serve_requests(cfg), label)
            res[arch].update(cut_layers=cut.n_layers, cut_greedy=greedy,
                             cut_reference_unstable_rids=unstable)
            torch.cuda.empty_cache()
    return launches_all, res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops, ref

    t_script = time.perf_counter()
    t_lap = [t_script]

    def lap(name):
        """Print the seconds since the last lap and since the start."""
        now = time.perf_counter()
        print(f"[time] {name}: {now - t_lap[0]:.1f}s (script "
              f"{now - t_script:.1f}s)", flush=True)
        t_lap[0] = now

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {len(_build.SYMBOLS)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    print_kernel_resources(_build, ops)

    lap("build")
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = matmul_phase(torch, ops, ref, flush, dev)
    rows += attn_phase(torch, ops, ref, flush, dev)
    rows += paged_attn_phase(torch, ops, ref, flush, dev)
    rows += verify_attn_phase(torch, ops, ref, flush, dev)
    rows += fake_quant_phase(torch, ops, ref, flush, dev)
    rows += flash_phase(torch, ops, ref, flush, dev)
    rows += wkv_phase(torch, ops, ref, flush, dev)
    lap("kernels")
    del flush
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_launches, train_res, trained, searched = train_phase(torch, ops,
                                                                dev)
    torch.cuda.empty_cache()
    lap("train")
    bundle_res = bundle_phase(torch, ops, dev, trained, searched)
    del trained
    torch.cuda.empty_cache()
    lap("bundle")
    ring_run, serve_launches, serve_res, (qwen, policy, base_sess) = \
        serve_phase(torch, ops, dev)
    torch.cuda.empty_cache()
    lap("serve")
    pc_launches, pc_res = per_channel_phase(torch, ops, dev, qwen, policy,
                                            base_sess, serve_res)
    pc_res["launches"] = pc_launches
    del qwen, policy, base_sess
    torch.cuda.empty_cache()
    lap("per-channel")
    paged_run, paged_launches, paged_res = paged_serve_phase(
        torch, ops, dev, serve_res["prefill_tokens"])
    torch.cuda.empty_cache()
    spec_launches, spec_res = spec_serve_phase(torch, ops, dev, "ring",
                                               ring_run)
    torch.cuda.empty_cache()
    spec_paged_launches, spec_paged_res = spec_serve_phase(
        torch, ops, dev, "paged", paged_run)
    torch.cuda.empty_cache()
    lap("paged, spec")
    cli_res = serve_cli_phase(torch, ops, dev, card)
    torch.cuda.empty_cache()
    lap("cli")
    elastic_res = {layout: elastic_phase(torch, ops, dev, card, layout)
                   for layout in ("ring", "paged")}
    lap("elastic")
    reqs = ring_run[0]
    del ring_run, paged_run
    torch.cuda.empty_cache()
    spec_res["midflight"] = midflight_check(torch, dev, reqs)
    torch.cuda.empty_cache()
    spec_res["self_draft"] = self_draft_check(torch, ops, dev, reqs)
    torch.cuda.empty_cache()
    # (e) kernels vs plain versions through one train pass, at 2 layers
    train_res["vs_plain"] = vs_plain_gates(torch, ops, dev, "qwen3-0.6b", 2,
                                           "train")
    torch.cuda.empty_cache()
    lap("midflight, self-draft, train (e)")
    rwkv_launches, rwkv_res = rwkv_serve_phase(torch, ops, dev)
    torch.cuda.empty_cache()
    lap("rwkv")
    starcoder_launches, starcoder_res = starcoder_serve_phase(torch, ops, dev)
    starcoder_res["launches"] = starcoder_launches
    torch.cuda.empty_cache()
    lap("starcoder")
    hybrid_launches, hybrid_res = hybrid_serve_phase(torch, ops, dev, card)
    hybrid_res["launches"] = hybrid_launches
    torch.cuda.empty_cache()
    lap("hybrid")
    audio_launches, audio_res = audio_phase(torch, ops, dev)
    audio_res["launches"] = audio_launches
    torch.cuda.empty_cache()
    lap("audio")
    moe_launches, moe_res, (sess, moe_reqs, moe_out, moe_eng) = \
        moe_serve_phase(torch, ops, dev, card)
    moe_res["launches"] = moe_launches
    lap("moe")
    # the ring prefills each of the paged phase's 8 prompts whole
    mp_launches, mp_res, mp_base = moe_paged_phase(
        torch, ops, dev, card, sess, sum(PROMPTS))
    mp_res["launches"] = mp_launches
    lap("moe-paged")
    ms_res = {}
    for layout, base in (("ring", (moe_reqs, moe_out, moe_eng)),
                         ("paged", mp_base)):
        ms_launches, ms_res[layout] = moe_spec_phase(
            torch, ops, dev, card, sess, layout, base)
        ms_res[layout]["launches"] = ms_launches
        lap(f"moe-spec-{layout}")
    ms_res["midflight"] = midflight_check(torch, dev, moe_reqs, sess=sess,
                                          label="moe-midflight")
    lap("moe-midflight")
    del sess, moe_out, moe_eng, mp_base, base
    torch.cuda.empty_cache()
    mt_launches, mt_res = moe_train_phase(torch, ops, dev)
    mt_res["launches"] = mt_launches
    torch.cuda.empty_cache()
    lap("moe-train")
    vt_launches, vt_res = vision_train_phase(torch, ops, dev)
    vt_res["launches"] = vt_launches
    torch.cuda.empty_cache()
    lap("vision-train")
    vision_rows, vision_launches, vision_res = vision_serve_phase(
        torch, ops, ref, dev, card)
    rows += vision_rows
    vision_res["launches"] = vision_launches
    torch.cuda.empty_cache()
    lap("vision")
    mixtral_rows, mixtral_launches, mixtral_res = mixtral_serve_phase(
        torch, ops, ref, dev, card)
    rows += mixtral_rows
    mixtral_res["launches"] = mixtral_launches
    torch.cuda.empty_cache()
    lap("mixtral")
    cli_large_launches, cli_large_res = cli_large_phase(
        torch, ops, dev, card, {MOE_ARCH: moe_res["checksum"],
                                MIXTRAL_ARCH: mixtral_res["checksum"]})
    torch.cuda.empty_cache()
    lap("cli-large")
    # each kernel's launches on the path that runs it: the matmuls and ring
    # attention from the ring serve phase, paged attention from the paged
    # one, the verify kernels from the speculative phases, wkv from the
    # RWKV phase (every phase's counts are in chip_smoke.json)
    launches = dict(serve_launches, **train_launches)
    launches["decode_attn_quant_paged"] = \
        paged_launches["decode_attn_quant_paged"]
    launches["verify_attn_quant"] = spec_launches["verify_attn_quant"]
    launches["verify_attn_quant_paged"] = \
        spec_paged_launches["verify_attn_quant_paged"]
    launches["wkv"] = rwkv_launches["wkv"]
    rwkv_res["launches"] = rwkv_launches
    serve_res["launches"], paged_res["launches"] = serve_launches, \
        paged_launches
    spec_res["launches"], spec_paged_res["launches"] = spec_launches, \
        spec_paged_launches

    # the training kernels' launches on each training path (and flash's in
    # the hybrid prefill) beside the train phase's count
    by_path = {k: {"train": train_launches[k], "audio": audio_launches[k]}
               for k in TRAIN_KERNELS}
    by_path["flash_fwd"]["hybrid"] = hybrid_launches["flash_fwd"]
    # and the MoE serving path's: the ring kernels beside the serve phase's
    # count, the per-expert fake-quant forward beside the training paths'
    for k in RING_KERNELS:
        by_path[k] = {"serve": serve_launches[k], "moe": moe_launches[k]}
    by_path["fake_quant_fwd"]["moe"] = moe_launches["fake_quant_fwd"]
    # the MoE slice's other paths: pages, speculation on both layouts, and
    # the paper pipeline at full width (per-expert scales both ways)
    for k in PAGED_KERNELS:
        by_path.setdefault(k, {"paged": paged_launches[k]})
        by_path[k]["moe-paged"] = mp_launches[k]
    by_path["fake_quant_fwd"]["moe-paged"] = mp_launches["fake_quant_fwd"]
    for k, layout, base in (("verify_attn_quant", "ring", spec_launches),
                            ("verify_attn_quant_paged", "paged",
                             spec_paged_launches)):
        by_path[k] = {"spec": base[k],
                      f"moe-spec-{layout}": ms_res[layout]["launches"][k]}
    for k in TRAIN_KERNELS:
        by_path[k]["moe-train"] = mt_launches[k]
        by_path[k]["vision-train"] = vt_launches[k]
    # the Qwen ring run packed per channel: no matmul kernel, every
    # projection on dequant-fp
    for k in RING_KERNELS:
        by_path[k]["per-channel"] = pc_launches[k]
    # the vision family's serving path: the ring kernels, and the pinned
    # image projection's and head's fake-quant
    for k in RING_KERNELS + ("fake_quant_fwd",):
        by_path[k]["vision"] = vision_launches[k]
    # mixtral's serving path: the ring kernels, the per-expert fake-quant
    # and flash in the long prompt's prefill
    for k in RING_KERNELS + ("fake_quant_fwd", "flash_fwd"):
        by_path[k]["mixtral"] = mixtral_launches[k]
    # the serve CLI's four runs of the large decoders
    for k in RING_KERNELS:
        by_path[k]["cli-large"] = cli_large_launches[k]
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        mine = [r for r in rows if r["name"] == name]
        main_row = next(r for r in mine if r["main"])
        extra = {"launches_by_path": by_path[name]} if name in by_path else {}
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], shape=main_row["shape"],
            **extra))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "cases": rows, "train": train_res,
         "serve": serve_res, "paged_serve": paged_res,
         "spec_serve": spec_res, "spec_paged_serve": spec_paged_res,
         "serve_cli": cli_res, "rwkv_serve": rwkv_res,
         "starcoder_serve": starcoder_res, "hybrid_serve": hybrid_res,
         "audio_train": audio_res, "moe_serve": moe_res,
         "moe_paged_serve": mp_res, "moe_spec_serve": ms_res,
         "moe_train": mt_res, "vision_train": vt_res,
         "vision_serve": vision_res, "per_channel": pc_res,
         "mixtral_serve": mixtral_res,
         "cli_large": cli_large_res,
         "bundle": bundle_res,
         "elastic": elastic_res, "kernels": kernels},
        indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except GateError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
