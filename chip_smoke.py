"""Smoke run of the PyTorch port on one NVIDIA GPU: kernels, engine, models,
the single-array query path, the distributed plane, decode and training.

    python3 chip_smoke.py [--seed N]

Phases (any failure ends the run with a non-zero exit; nothing is caught):

1. Device: prints ``nvidia-smi --query-gpu=name,power.limit``; then
   builds every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   each, all at once) and prints each source's build time and, for each
   kernel in it, its registers, spills and ptxas advisories (C75xx, such
   as "wgmma serialized"). The script prints its whole run's wall time at
   the end.
2. Kernels: holds the engine's two CUDA kernels against their plain
   PyTorch versions on the card, at the main path's shapes: 2^22-record
   chunks, 4096 and 64 bins.
   * score_hist with the chunk masses, in one launch, on four inputs: the
     corpus's Beta chunk with 1% -1 sentinels, uniform scores, scores in
     four bins and scores in one bin. Counts exact; sums within
     1e-6 |e| + n 2^-32 of a float64 sum (the kernel's fixed point
     truncates each run below 2^-32) and, on the Beta and uniform chunks,
     within |k - p| <= 4e-3 |p| + 1e-3 of the plain version, whose float32
     scatter-add drifts by up to ~1e-3 relative in a bin holding millions
     of records (where all records fall in a few bins it drifts past that
     bar itself, so float64 decides: `HIST_INPUTS`); masses within
     rel 1e-12 of torch.float64 sums; all bitwise identical across two
     launches.
   * threshold_select: indices exactly equal at tau 0, 0.5, 0.999, 1.01,
     on an empty input and on lengths that are not a multiple of its
     tile; threshold_count (its counting mode) equal to their lengths.
3. Engine at real size: 2^27 scores (about 1,240 hours of 30 fps video,
   one score per frame; 512 MiB of float32), drawn on the card from
   --seed as Beta(0.01, 1) — the paper's synthetic setting — with
   Bernoulli(score) labels kept on the host, in 16 shards with the default
   2^22-record chunks. One RT, one PT (two-stage IS) and one JT query at
   budget 3000, on engines with 1 and with 8 workers: results must be
   identical across worker counts, per-shard counts must equal a plain
   count on the card, and both kernels must have launched on this path
   (score_hist once per chunk, threshold_select at least once per chunk
   per query). Prints achieved recall and precision.
   A small corpus also runs through the card's engine and a CPU engine
   from one corpus state: tau, counts and indices must agree.
4. Times: kernel, plain and library times at a 2^22-record chunk beside
   the card's bound; for score_hist on the Beta, uniform and clustered
   inputs, its call and its launch alone as device time beside three
   `torch.bincount` calls; for threshold_select also its device time
   alone (no read-back) and threshold_count's; engine build and query
   wall times. Then one build at workers 1 and one at 8 under
   torch.profiler, split by step and kernel: exactly one score_hist
   launch a chunk and three device-to-host copies (the masses' one
   read-back and two normalizers); and three builds at each worker count.
5. flash_attention against its plain version on the card, in bf16
   within BF16_ATOL + 2^-7 |plain| each and BF16_FRO_TOL ||plain|| in all
   (sized from a measurement: see the note at the constants), and in
   float32 at atol = rtol = 2e-5 (the JAX package's own tolerance,
   tests/test_kernels.py): smollm-360m's prefill shape (B=4,
   S=4096, H=15, KV=5, dh=64) causal, a ragged S=1000 causal and
   non-causal, a dh=128 MQA case both ways, the scoring shape (B=256,
   S=128), and zamba2-1.2b's shared block at both (H = KV = 32);
   bitwise identical across two launches.
6. The full smollm-360m model (32 layers, d 960, bf16, weights drawn from
   --seed by `model.init`): one prefill at (4, 4096) through
   `make_serve_prefill`, with exactly 32 flash_attention launches; then
   the same tokens through a float32 copy of the weights, once with the
   kernel and once with attention by the plain version: the last
   position's logits must agree within `F32_LOGIT_TOL` of their largest
   magnitude. The bf16 model's own last-position logits, with the kernel
   and with the plain attention, must agree within `BF16_LOGIT_TOL` of
   theirs (sized from a measurement: see the note at the constants).
7. Score, then select: a 2^15-record `make_token_corpus` (128 tokens a
   record, vocab 49152, 2% planted positives) scored by the full model in
   batches of 256 records (32,768 tokens a call, prefill_32k's sequence),
   the scores kept on the card as shards of a `SelectionEngine`, and one
   RT query (gamma 0.9, delta 0.05, budget 3000) labeled by
   `contains_marker`. Its counts must equal a plain count on the card, and
   flash_attention, score_hist and threshold_select must all have launched
   on this path. Prints records/s, tokens/s, the query's wall time, recall
   and the prefill's mfu (model FLOPs over time over 989 TFLOP/s bf16).
   Then one scoring call under torch.profiler: device time by kernel and
   group (flash_attention, matmul, the rest) and the device's busy share.
8. Times of flash_attention at the prefill shape (its row in the kernels
   line) and at the scoring shape and zamba2's prefill and scoring shapes
   (a line each), beside its bound, its plain version and
   `scaled_dot_product_attention` (the yardstick; the port never calls
   it) by its fastest fused backend, each backend's time printed; at the
   same four shapes, the forward with and without its lse store (the
   logsumexp the backward takes), timed in turns.
9. linear_scan against its plain version on the card, each case labelled
   with the kernel its route launched (`ls_ops.route`: the chunked
   tensor-core kernel for Mamba2's views, the channel kernel otherwise,
   both launches counted on that route): zamba2-1.2b's prefill shape
   (B=4, H=64, S=4096, dk=dv=64) and scoring shape (B=256, S=128) in
   Mamba2 mode with Zamba2's decay law and layout (B and C shared by the
   heads, the scalar decay per head, as stride-0 views); RWKV6 mode
   (bonus u) at (2, 64, 1024, 64, 64); rwkv6-7b's prefill (4, 64, 4096,
   64, 64), a ragged S = 1000 and S = 1 in RWKV6's layout with bf16 r, k
   and v (o in bf16); the reference's (2, 2, 128, 16, 24) in both modes
   and with bf16 v, and dk x dv = 33 x 40 with bf16 v; a ragged S = 1000,
   S = 1, decays w = 0.05 (below the Pallas kernel's log-decay floor) and
   w = 1 at S = 4096 in both modes; for the chunked kernel, S at a
   chunk's edges (63, 64, 65), decays of 1e-6 in the first 8 steps of
   every 16 and near 1 after (where an L taken from a cumulative log
   loses accuracy), and float32 q and k. o and the final state within
   SCAN_REF_ATOL (the reference's) at the reference's shape and SCAN_REL
   of the largest |output| elsewhere, of the plain version, or of the
   plain recurrence in float64 where S >= 1024 (see the note at the
   constants); with bf16 v, o within one bf16 ulp of the plain recurrence
   in float64 plus SCAN_REL of its largest |o|; bitwise identical across
   two launches; the largest reading of each kernel at dk = dv = 64 as a
   share of the largest |output|.
10. The full zamba2-1.2b model (38 Mamba2 blocks in 6 super-blocks of 6
    and a tail of 2, one shared attention block run 6 times, d 2048, bf16,
    weights drawn from --seed by `model.init`): one prefill at (4, 4096)
    through `make_serve_prefill` with exactly 38 linear_scan (all on the
    chunked route) and 6 flash_attention launches, its mfu
    (`model_flops`); the bf16 model's
    and its float32 copy's last-position logits with both kernels against
    both plain versions (`LOGIT_TOL`); where the bf16 gap comes from:
    each kernel alone by its plain version, and, with no kernel, the plain
    scan computed in float64 and in bf16.
11. Score, then select with zamba2-1.2b: a 2^13-record token corpus
    (vocab 32000) in calls of 256 records, one RT query as in phase 7;
    records/s, mfu, the scores' range and quantiles, and the path's
    launches (38 linear_scan, all on the chunked route, and 6
    flash_attention a call); a profile of
    one scoring call by group (linear_scan, flash_attention, matmul, the
    rest).
12. Times of linear_scan at the prefill shape (its row in the kernels
    line: the chunked kernel) and at the scoring shape (a line), beside
    its bound and its plain version, and the channel kernel's on the same
    inputs with w materialized (its route), timed in turns (chunked,
    channel, channel, chunked). The bound is the larger of the bytes and
    the least operation time over the two forms (`chunked_ms`,
    `channel_ms`: their split-TF32 and bf16 products on the tensor cores
    and float32 operations on the CUDA cores); each term is printed. No
    single PyTorch call computes the scan, so its library time is null.
13. Sessions and the live plane at real size, on phase 3's corpus drawn
    again (2^27 Beta(0.01, 1) scores on the card, 16 shards of 2^23,
    2^22-record chunks, 4096 bins, labels on the host). Sessions: an
    engine over the first 12 shards runs 3 RT (gamma 0.9, delta 0.05,
    budget 3000), 2 two-stage PT (gamma `PT_SESSION_GAMMA`) and 1 JT
    (gamma_recall 0.8, stage budget 3000) on keys split from one key, in
    sequence through `run`/`run_joint` at workers 1, then through
    `run_many` at concurrency 1 and None at workers 8 and at concurrency
    2 at workers 1: tau, per-shard counts and indices identical across
    the four; each run's `SessionStats`, threshold_select launches and
    wall. The live plane (launches counted from here): a standing RT
    certified at epoch 0; an RT pinned at epoch 0 and stepped once,
    then shards 12-13 and 14-15 appended through `IngestPlane`, the
    pinned RT equal to its sequential result and score_hist launched
    exactly once per appended chunk; the standing RT's one catch-up
    (`pump`/`settle`) equal to a plain {A >= tau} per shard on the card,
    launching threshold_select once per appended chunk; the appended
    engine's sketch, z, chunk masses, CDFs and RT/PT/JT bit for bit a
    cold build over the 16 shards; `gc_epochs` after each unpin, with
    `torch.cuda.memory_allocated()` falling by at least the freed
    epoch's flat and sketch; a `DriftSentinel` watch (probe 4096, sigma
    4) over 4 shards that triggers on 12 appended Beta(0.01, 2) shards
    (`make_drift_pair_on_device`'s shift) and stays quiet on the 12
    same-law shards of the corpus. Walls (appends, sessions, the phase)
    are printed beside the card's name and power limit.
14. The serving and durability planes at real size, on phase 13's
    corpus, keys and sequential results (a durable root in a temporary
    directory, removed at the end). Served: a `SelectionServer` over the
    first 12 shards (workers 1, tenants 'metered' with a quota and
    'open') answers phase 13's six queries from a pool of 8 client
    threads: tau, per-shard counts and indices equal the sequential
    results, each query's `oracle_calls` at most its sequential one and
    their sum the channel's labels (the channel's shared cache makes
    attribution depend on the schedule), threshold_select launched as
    often as in sequence; `ServerStats.format()` and p50/p99. Durable: a
    server journaling to the root subscribes a standing RT and an
    audited standing RT (sentinel probe 4096, sigma 4) on `BitmaskStore`
    sinks, snapshots, appends shards 12-13 and 14-15 (each journaled
    append's wall and its split: device-to-host copy, `np.save`, CRC32,
    spool write + fsync, journal record + fsync, install) and records
    taus, sink bytes, the tenant's charge and the watch. The same run
    again under `CrashInjector({"post_journal_pre_install": 1})`: the
    second append dies journaled but not installed (the only exception
    caught in the phase), `close(abandon=True)` frees at least the
    engine's flats (`memory_allocated`), and `SelectionServer.restore`
    over the 12 base shards on the card recovers 2 epochs and 2 standing
    queries, launching score_hist once per replayed chunk (8) and
    threshold_select once per appended chunk per standing query in the
    catch-ups (16); taus, sink bytes, charge and the watch's base key and
    last audited epoch equal the uncrashed run's. The restore's wall
    (build, replay, adopt) and the phase's walls are printed beside the
    card's name and power limit.
15. The single-array query path and the distributed plane, on phase 3's
    corpus drawn again (2^27 Beta(0.01, 1) scores on the card, labels on
    the host), budget 3000, delta 0.05. `queries.run_query` RT 0.9 (is,
    uniform, noci), PT 0.8 (two-stage and one-stage) and
    `run_joint_query` RT 0.9 / P 1.0 over keys 0-3: per query the wall,
    tau, oracle calls, achieved recall or precision and the
    threshold_select/threshold_count launches (1, or 2 for two-stage
    PT); selected must equal union(labeled positives, {A >= tau} on the
    card) exactly, the same query with the kernels' plain versions must
    give the same tau and selection, and RT/PT spend at most the budget;
    on a 2^20-record corpus each query on the card must equal the same
    query on the CPU.
    The sqrt draw's float32 CDF (XLA's blocked order on every device)
    against a float64 one: the largest deviation and the records of
    positive weight whose step is 0. Then `core.distributed` on ``nccl``
    at world size 1
    over the whole corpus (one score_hist launch for the sketch, one a
    shard for 16 shard totals, one threshold_count a global count):
    `global_sketch` bitwise `binned.build_sketch`, its counts the exact
    int64 histogram rounded once to float32 (a float32 fold of the chunk
    sketches is printed beside it: bin 0 holds more than 2^24 records),
    `global_selection_count` at each RT's tau equal to |R2|, and a 2^20
    -draw `two_level_sample` over the 16 shard totals, resolved with
    `within_shard_probs`, estimating the positive rate within 20%; then
    two ``gloo`` ranks sharing the card on CUDA tensors (spawned after
    the build, half the corpus each): counts within two float32
    roundings of exact, sums within 2e-6 |e| + n 2^-32 of float64, shard
    totals within 1e-6, global counts exact.
16. The full rwkv6-7b model (32 RWKV6 blocks, d 4096, bf16, 7.6e9
    weights drawn from --seed by `model.init`): one prefill at (4, 4096)
    through `make_serve_prefill` with exactly 32 linear_scan launches,
    all on the channel route (RWKV6's bonus u and a decay per channel,
    bf16 v), its mfu; the bf16 last-position logits against the plain
    scan within `RWKV_BF16_LOGIT_TOL`; a 2^12-record corpus (vocab 65536)
    scored in calls of 256 records and selected as in phase 7 (32
    channel-route launches a call); the channel kernel timed at the
    prefill shape (4, 64, 4096, 64, 64) with RWKV6's inputs beside its
    bound and plain version (its row in the kernels line), and a block's
    scan with v cast to float32 and o back beside it; then the model cast
    to float32 in place (the bf16 weights freed), and at (2, 1024)
    (`RWKV_F32_SHAPE`) each of its 32 blocks, on the input
    the kernel's run gave it, against the same block with the plain scan
    within 2e-5 of the block's largest |output|; the model's logits with
    the kernel, the plain scan and the plain scan in float64 are printed
    (the random-init model carries float32 rounding far past 2e-5: see
    the note at `RWKV_BF16_LOGIT_TOL`).
17. Decode at full width for smollm-360m, zamba2-1.2b and rwkv6-7b
    (`make_serve_decode`, plain PyTorch: no kernel of the TPU's runs in a
    step). Consistency: four rows from `init_caches`, starting at
    positions 0, 5, 11 and 17 (each decodes its prefix alone, then the
    rows step together at their own positions), 32 steps, every step's
    logits against the same model's prefill (through the kernels) at that
    position: bf16 within `DECODE_BF16_TOL`, the float32 copy within
    2e-5 of the largest |logit|; rwkv6-7b's logits are printed, and each
    of its blocks decodes the input its prefill block saw, held to that
    block's output (bf16 `DECODE_BF16_TOL`, float32
    `RWKV_DECODE_F32_TOL`). Times: ms a step at pos = cache length -
    1 on caches of random contents, tokens/s and the bytes bound (weights,
    the KV caches `decode_attention` reads, the states read and written,
    at 3.35 TB/s) for each cell of `DECODE_CELLS` (smollm and zamba2 at
    32 rows x 32768, rwkv6 at 128 rows, zamba2 and rwkv6 at 1 row x
    524288), the peak device memory (under 70 GB), and one step under
    torch.profiler: kernels, the device's busy share and 0 device-to-host
    copies. Then the float64 arbiter of rwkv6-7b's decode
    (`rwkv_decode_vs_float64`): the model cut to RWKV_F64_BLOCKS blocks,
    its float32 decode and float32 prefill (through the kernel) against
    its prefill in float64 at every position, printed; the float32
    decode held within RWKV_F32_DECODE_TOL and the float64 decode within
    RWKV_F64_DECODE_TOL of the largest |logit|.
18. The dense configs yi-6b, deepseek-7b, qwen1.5-4b and chameleon-34b
    and the MoE config llama4-maverick at their published widths (bf16,
    weights drawn from --seed; every attention layer on flash_attention's
    dh-128 path). Depth is cut only where the weights do not fit
    (`NEW_DEPTH`: chameleon-34b to 24 of its 48 layers, llama4 to one
    pair). (a) Each dense config: one (4, 4096) prefill through
    `make_serve_prefill` with one flash_attention launch a layer, its
    mfu, its bf16 last-position logits against plain attention
    (`LOGIT_TOL`), yi-6b's float32 copy too; its decode against its
    prefill (`decode_consistency`, `DECODE_BF16_TOL`); and ms a decode
    step at 32768 positions with `NEW_DECODE_ROWS` rows. (b) llama4 cut
    to one pair (a dense block, then an MoE block of 128 experts of 8192,
    sigmoid top-1, one shared): the prefill (2 flash_attention launches,
    capacity 160; the share of assignments dropped; mfu over the active
    parameters beside the dispatch's expert work, E · cap against n · k);
    its bf16 logits against plain attention, the plain run replaying the
    kernel run's routing (`replayed_routing`: a routing decision at a
    near tie flips under bf16 rounding; each choice that would have
    differed must be a near tie within `ROUTE_FLIP_MARGIN`); the MoE layer
    on its prefill input against a plain float32 evaluation of the same
    routing, one expert at a time (`MOE_F32_TOL`), its drops against a
    plain walk; the decode against the prefill at capacity factor E (no
    assignment dropped on either side, so the caches are tested, not the
    capacity), the decode replaying the prefill's routing; a decode step
    at 32 x 32768 (the dispatch multiplies every expert, and the bound reads
    every expert's weights); a 2^12-record corpus scored and one RT
    query selected as in phase 7. (c) `moe_apply` alone at deepseek-v2's
    MoE widths (d 5120, 160 experts of 1536, softmax top-6, 2 shared;
    tokens (4, 4096)): the card's routing, order, slots and drops equal
    the CPU port's from the same router logits; the output against its
    plain float32 evaluation; whether two runs repeat bit for bit
    (`index_add_` adds k = 6 terms a token by atomics); its time. (d)
    flash_attention at dh 128 against its plain version (phase 5's bars)
    and its times at yi-6b's (4, 4096, 32/4) and llama4's (4, 4096, 40/8)
    beside its bound and `scaled_dot_product_attention`.
19. deepseek-v2-236b at its published widths (bf16, weights drawn from
    --seed), cut to the dense block and 7 MLA + MoE blocks of 60
    (`NEW_DEPTH`); every layer's attention is MLA, whose prefill runs
    flash_attention at q·k head dim 192 and v dim 128. (a) The kernel at
    (192, 128) against its plain version (over groups of
    `DSV2_PLAIN_HEADS` KV heads: the plain scores of all 128 heads are
    34 GB a copy): deepseek-v2's prefill shape (4, 4096, 128/128) in bf16,
    a ragged S causal and not and a GQA layout in bf16 and float32
    (phase 5's bars, repeat bitwise); its time beside its operations
    bound (B·H·S²·(192 + 128)), the plain version and
    `scaled_dot_product_attention` by each fused backend (its time or its
    refusal printed; library_ms is the fastest). (b) One (4, 4096)
    prefill through `make_serve_prefill` with 8 flash_attention launches,
    its mfu over the active parameters (`model_flops`: MLA's attention
    term B·H·S²·(dn + dr + dv) a layer); the bf16 last-position logits
    against plain attention (`LOGIT_TOL`), the routing replayed as in
    phase 18 (two runs of random-init softmax top-6 of 160 part at
    thousands of near ties). (c) The absorbed-latent decode against the
    prefill at capacity factor E, the prefill's routing replayed
    (`decode_consistency`, `DECODE_BF16_TOL`), and a step at 32768 positions
    with `NEW_DECODE_ROWS` rows beside its bytes bound (the latent caches
    read once); then the model in float32 cut to `DSV2_F32_LAYERS` layers,
    its decode against its prefill (`DECODE_F32_TOL`). (d) A 2^12-
    record corpus scored in calls of 128 (8 flash_attention launches a
    call) and one RT query selected as in phase 7 (score_hist and
    threshold_select on the path).
20. flash_attention's backward kernel (``csrc/flash_attention_bwd.cu``:
    bf16 on wgmma with TMA in two launches, three at the wider pairs;
    float32 on the CUDA cores) against its plain backward (float32 from
    the same inputs): dq, dk and dv at smollm-360m's (4, 4096, 15/5, 64)
    and musicgen-medium's (4, 4096, 24/24, 64), causal, at a ragged (2,
    1000, 15/5, 64) causal and not and a ragged (2, 1000, 12/2, 64); at
    (128, 128) yi-6b's (4, 4096, 32/4) and llama4's (4, 4096, 40/8), at
    (192, 128) deepseek-v2's (4, 4096, 128/128), causal, and a ragged (2,
    1000, 12/2) causal and not at each (past `PLAIN_WHOLE_HEADS` heads
    the plain versions run by groups of KV heads); in bf16
    (`BWD_BF16_ATOL`, `BWD_BF16_ATOL_WIDE` at the wider pairs, + 2^-7
    |plain| each, `BWD_BF16_FRO_TOL` of each tensor's norm) and float32
    (F32_TOL abs + rel), each from the lse the forward kernel kept, which
    is held against the plain lse (`LSE_TOL`); two calls bitwise equal,
    each counted once. Its time at the five training shapes beside its
    operations bound (the five products of the gradient, B·H·S²·(3 dh +
    2 dv)) and the products its design runs (seven, eight at the wider
    pairs), the plain backward and the backward of
    `scaled_dot_product_attention` by each fused backend (library_ms is
    the fastest; PyTorch's flash backend refuses dv != dh).
21. musicgen-medium at full width (48 layers, d 1536, four codebooks,
    bf16): a (4, 4096, 4) prefill (48 flash_attention launches) with its
    four heads' logits against plain attention and its float32 copy
    (`MUSICGEN_LOGIT_TOL`); a 2^12-record corpus (the marker corpus in
    the first codebook) scored and one RT query; decode against the
    prefill (`DECODE_BF16_TOL`) and a step at `MUSICGEN_DECODE_ROWS` x
    32768; then `TRAIN_STEPS` + 1 steps of `make_train_step` at (4, 4096)
    x 4 codebooks from `lm_batches`, grad_accum 2, remat="block": loss,
    grad_norm, wall, tokens/s, train mfu (`train_flops_analytic`), peak
    memory, and 192 forward (the forward and its recompute) and 96
    backward flash_attention launches a step, exactly; a profiled step
    by kernel group (`TRAIN_GROUPS`: the backward's two kernels); and a
    `CheckpointManager` save and restore of the weights and AdamW state
    on the card, every tensor equal.
22. smollm-360m at full width trained into a proxy on phase 7's corpus
    through `TrainLoop` (class-balanced batches from the corpus's first
    half, the class label at every position, a checkpoint every
    PROXY_STEPS / 2 steps and one injected restart that restores one),
    then the corpus scored and one RT 0.9 query selected (score_hist and
    threshold_select on the path); the AUC over the records no batch drew
    must reach PROXY_AUC, printed beside phase 7's random-init proxy's,
    with both queries' recall and oracle calls.
23. Launch and sharding on a torch DeviceMesh. (a) nccl at world size 1,
    a (1, 1) ("data", "model") mesh: smollm-360m at full width, its
    `launch.sharding.param_specs`, a `CheckpointManager` checkpoint
    restored onto the mesh (every parameter a DTensor whose full tensor
    equals the plain restore's bit for bit), and a (4, 4096) prefill
    with shard_activations under the mesh whose last-position logits
    equal the prefill without a mesh bit for bit (32 flash_attention
    launches each; with one rank a group no parallel path engages). (b)
    Four gloo ranks on CUDA tensors sharing the card as a (2, 2) mesh,
    spawned after the kernels are built, each join time-limited, each
    data shard a (4, 4096) batch: `attention.context_parallel_attention`
    at smollm-360m's (15/5, 64) and deepseek-v2's (128/128, (192, 128))
    widths, one flash_attention launch a rank and shape (Sq 2048; Sk 2048
    or 4096), the gathered rows equal to one launch over all rows bit for
    bit, each rank's piece held against the plain version (plain
    attention at Sk > Sq, by groups of heads at (192, 128); phase 5's
    bf16 bars) and its launch timed alone beside that launch; `moe_apply`
    expert-parallel at deepseek-v2's MoE widths (80 experts a model rank,
    EP_TOKENS a data shard): its kept assignments those of the dense
    `moe_apply` on the same shard, exactly, the output within
    `EP_ROUNDINGS` bf16 roundings of |shared| + Σ g|y|, the aux loss the
    dense shards' mean; `layers.matmul_rowparallel` at yi-6b's wo (4096 x
    4096) within `ROW_ROUNDINGS` bf16 roundings of |x|·|w| of x·w in
    float32. Then, in this process, the longest piece's launch at
    smollm's shape beside its bound, the plain version and SDPA with a
    lower-right causal mask (the kernels line's row).
24. Training at the backward kernel's wider pairs: yi-6b at full width
    cut to 8 of 32 layers (attention at (128, 128)) and deepseek-v2-236b
    at full width cut to its first, dense block (MLA at (192, 128)),
    bf16, `TRAIN_WIDE_STEPS` steps after a warm-up step each through phase
    21's `train_cell` (`make_train_step` at (4, 4096), grad_accum 2,
    remat="block"): flash_attention exactly twice and its backward once a
    layer a microbatch, loss and grad_norm finite, each step's wall,
    tokens/s, train mfu and peak memory.

Each phase prints its wall time as it ends, and the line before the
kernels line sums them.

The line before the last is ``{"kernels": [...]}`` (a row for each kernel:
linear_scan's chunked kernel and its channel kernel each have one,
flash_attention's dh-128 path one of its own at llama4's shape and its
(192, 128) path one at deepseek-v2's, its backward kernel one at
smollm's shape, its launches phase 22's, its context-parallel launches
at Sk > Sq one, its launches phase 23's ranks', and its backward at
yi-6b's (128, 128) and deepseek-v2's (192, 128) shapes one each,
`flash_attention_bwd_dh128` and `flash_attention_bwd_mla`, their launches
phase 24's); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from typing import Optional
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import live  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import binned, bounds, queries, sampling  # noqa: E402
from repro_torch.core import distributed as dplane  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core.engine import SelectionEngine  # noqa: E402
from repro_torch.core.oracle import array_oracle  # noqa: E402
from repro_torch.core.queries import JointSUPGQuery, SUPGQuery  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.synthetic import (contains_marker,  # noqa: E402
                                        make_beta_on_device,
                                        make_drift_pair_on_device,
                                        make_token_corpus)
from repro_torch.durable import recovery  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.linear_scan import ops as ls_ops  # noqa: E402
from repro_torch.kernels.linear_scan import ref as ls_ref  # noqa: E402
from repro_torch.kernels.score_hist import ops as sh_ops  # noqa: E402
from repro_torch.kernels.score_hist import ref as sh_ref  # noqa: E402
from repro_torch.kernels.threshold_select import ops as ts_ops  # noqa: E402
from repro_torch.kernels.threshold_select import ref as ts_ref  # noqa: E402
from repro_torch.launch.serve import (make_serve_decode,  # noqa: E402
                                      make_serve_prefill)
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data.synthetic import lm_batches  # noqa: E402
from repro_torch.launch.fault import (LoopConfig,  # noqa: E402
                                      RestartRequired, TrainLoop)
from repro_torch.launch.train import TrainOptions  # noqa: E402
from repro_torch.launch.train import attention_head_dims  # noqa: E402
from repro_torch.launch.train import make_train_step  # noqa: E402
from repro_torch.launch import sharding as shardlib  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.models import (attention, layers, mamba,  # noqa: E402
                                meshctx, moe, rwkv, transformer)
from repro_torch.models import model as modellib  # noqa: E402
from repro_torch.serve import SelectionServer  # noqa: E402

DEVICE = "cuda"
CHUNK = 1 << 22
N_RECORDS = 1 << 27
N_SHARDS = 16
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
FP32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM, TF32 dense on the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM, bf16 dense on the tensor cores
ARCH = "smollm-360m"
ZAMBA = "zamba2-1.2b"
RWKV = "rwkv6-7b"
NEW_DENSE = ("yi-6b", "deepseek-7b", "qwen1.5-4b", "chameleon-34b")
LLAMA4 = "llama4-maverick-400b-a17b"
DSV2 = "deepseek-v2-236b"
MUSICGEN = "musicgen-medium"
FA_PREFILL = (4, 4096, 15, 5, 64)     # B, S, H, KV, dh: smollm-360m prefill
FA_SCORING = (256, 128, 15, 5, 64)    # the scoring batch
N_CORPUS = 1 << 15                    # token records scored and selected
SEQ_LEN = 128
SCORE_BATCH = 256                     # records a prefill call: 32,768 tokens
N_SCORE_SHARDS = 8
# flash_attention in bf16 against its plain version (phase 5): each output
# within BF16_ATOL + BF16_RTOL |plain|, and the whole within
# BF16_FRO_TOL ||plain|| (Frobenius). The plain version computes in float32
# and rounds once to bf16; the kernel rounds p to bf16 before p·v and
# rounds its output. BF16_RTOL is one bf16 ulp at most (2^-7 of |x|), for
# the two outputs' rounding. p's rounding (2^-9 relative each) is not
# relative to |o| where the products of p and v cancel, so it needs an
# absolute part: over the cases below at --seed 0, 1 and 2, the largest
# |err| - 2^-7 |plain| measured 3.65e-3 (the scoring shape) on an H100
# 80GB HBM3 at 700 W; BF16_ATOL leaves 37% over it. The Frobenius error
# measured 1.9e-3 to 2.4e-3 of ||plain||; about twice that catches a
# systematic error too small for any one output to show. A q·kᵀ scale 1%
# off exceeds the elementwise bar by 0.026; a dropped key tile by up to 3.6.
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 5e-3
BF16_FRO_TOL = 5e-3
F32_TOL = 2e-5                 # atol = rtol, the JAX package's own
# Largest |kernel - plain| of the float32 model's last-position logits, as
# a share of their largest magnitude (phase 6). Both runs are float32
# throughout (no TF32), so they differ only in the order of the attention
# sums (the kernel's online softmax against the plain softmax) and in exp2
# against exp: about 1e-6 of the output a layer. Through 32 layers the
# logits measured 9.65e-7 of their largest magnitude on the H100; the
# tolerance is ten times that.
F32_LOGIT_TOL = 1e-5
# The same for the bf16 model (phase 6). bf16 rounds every layer's output,
# so the kernel's and the plain version's roundings differ at a few
# outputs a layer and the difference grows through 32 layers: at --seed 0,
# 1 and 2 it measured 8.2e-3 to 1.04e-2 of the largest |logit| on an H100
# 80GB HBM3 at 700 W, the size of the distance of the bf16 model with
# plain attention from its float32 copy (8.3e-3 to 9.5e-3). The tolerance
# is three times the largest.
BF16_LOGIT_TOL = 3e-2
# The same two bars for zamba2-1.2b (phase 10), kernels (linear_scan and
# flash_attention) against the plain versions, measured at --seed 0, 1 and
# 2 on an H100 80GB HBM3 at 700 W. bf16: 2.38e-2 to 2.86e-2 of the largest
# |logit|. The kernels do not set that gap: with only linear_scan by its
# plain version it is 2.39e-2 to 2.77e-2, with only flash_attention
# 2.18e-2 to 2.60e-2, and the plain model with its scan computed in
# float64 (no kernel; a change of float32 rounding alone) moves 2.40e-2 to
# 3.26e-2 from the plain model. bf16 rounds the hidden state at every
# block, and 44 blocks carry any change at float32 rounding up to such
# roundings, a large share of logits near 4 (the untied head at
# 1/sqrt(d)). No bar below that floor passes a correct path; the bar is
# 1.4 times its largest reading. It cannot tell a scan computed in bf16
# (3.52e-2 to 4.27e-2 from the plain model): phase 9 holds the main path's
# own scan (bf16 B and C, float32 v) at SCAN_REL, and the float32 copy
# holds the model at ZAMBA_F32_LOGIT_TOL. float32: 5.53e-6 to 6.16e-6,
# through 38 Mamba2 blocks and 6 attention runs; the bar is three times
# the largest.
ZAMBA_BF16_LOGIT_TOL = 4.5e-2
ZAMBA_F32_LOGIT_TOL = 2e-5
# The same for rwkv6-7b (phase 16). bf16, the last-position logits at
# (4, 4096), kernel against the plain scan: 4.78e-2 to 4.95e-2 of the
# largest |logit| at --seed 0, 1 and 2 on an H100 80GB HBM3 at 700 W; the
# bar is twice the largest. float32: the random-init rwkv6-7b carries a
# change at float32 rounding through 32 blocks far past 2e-5 of the
# largest |logit| (its plain scan in float32 against the same in float64
# moves the logits at (2, 1024) by 4.4e-4, and a decode against the
# prefill by up to 0.30 at early positions, where a head's group norm
# divides a small rank-one output), so its float32 model is held one
# block at a time, each block on the input the kernel's run gave it,
# against zamba2's bar: 1.48e-6 to 1.61e-6 of a block's largest |output|
# over those seeds, same card.
RWKV_BF16_LOGIT_TOL = 1e-1
# The same for phase 18's configs, as phase 6 set smollm's: bf16, the
# last-position logits at (4, 4096), kernel against plain attention, at
# --seed 0, 1 and 2 on an H100 80GB HBM3 at 700 W: yi-6b 2.06e-2 to
# 2.37e-2 of the largest |logit| (its bf16 model with plain attention lies
# 1.62e-2 to 2.00e-2 from its float32 copy: bf16's own rounding),
# deepseek-7b 1.76e-2 to 1.86e-2, qwen1.5-4b 2.09e-2 to 2.45e-2,
# chameleon-34b (24 layers) 1.64e-2 to 2.02e-2, llama4 (one pair) 3.81e-3
# to 4.06e-3; each bar is three times its largest. float32, yi-6b's copy:
# 3.39e-6 to 3.65e-6, held to smollm's 1e-5.
NEW_LOGIT_TOL = {"yi-6b": (7e-2, F32_LOGIT_TOL),
                 "deepseek-7b": (5.6e-2, None), "qwen1.5-4b": (7.4e-2, None),
                 "chameleon-34b": (6.1e-2, None), LLAMA4: (1.25e-2, None)}
# Phase 19's bf16 bar, deepseek-v2-236b cut to 8 layers: the last-position
# logits at (4, 4096), kernel against plain attention, the plain run
# replaying the kernel run's routing (`replayed_routing`): 1.04e-2 to
# 1.16e-2 of the largest |logit| at --seed 0, 1 and 2 on an H100 80GB HBM3
# at 700 W; three times the largest. Without the replay the two runs'
# softmax top-6 of 160 random-init experts part at about 5,560 of 114,688
# token choices (all near ties, margins up to 8.7e-4), and of the last 64
# positions of each row only 70 to 79 of 256 route alike through all 7
# MoE layers.
DSV2_LOGIT_TOL = 3.5e-2
# Phase 21's bars for musicgen-medium (48 layers, four codebooks), as phase
# 6 set smollm's: the four heads' bf16 logits at the last position, kernel
# against plain attention, 2.27e-2 to 2.70e-2 of the largest |logit| at
# --seed 0, 1 and 2 on an H100 80GB HBM3 at 700 W (its bf16 model with
# plain attention lies 2.36e-2 to 2.42e-2 from its float32 copy); three
# times the largest. Its float32 copy: 2.46e-6 to 3.31e-6, held to
# smollm's 1e-5.
MUSICGEN_LOGIT_TOL = (8.1e-2, F32_LOGIT_TOL)
LOGIT_TOL = {ARCH: (BF16_LOGIT_TOL, F32_LOGIT_TOL),
             ZAMBA: (ZAMBA_BF16_LOGIT_TOL, ZAMBA_F32_LOGIT_TOL),
             RWKV: (RWKV_BF16_LOGIT_TOL, ZAMBA_F32_LOGIT_TOL),
             **NEW_LOGIT_TOL, DSV2: (DSV2_LOGIT_TOL, None),
             MUSICGEN: MUSICGEN_LOGIT_TOL}
# Operations each kernel does per record, counted from its source:
# score_hist compares, clips, scales, converts and takes a square root
# (8) and adds both float64 mass terms (2, counted at the float32 rate:
# the bytes bound it either way); threshold_select compares once.
OPS_PER_RECORD = {"score_hist": 10, "threshold_select": 1}
# score_hist's inputs (phases 2 and 4), each a 2^22-record chunk, and
# whether the plain version's float32 sums are a bar for it. Where every
# record falls in a few bins, the plain float32 scatter-add drifts far
# from the exact sums (a bin of a million records near 0.3 adds each below
# half an ulp of its total), beyond its own bar of 4e-3 |e| + 1e-3; there
# float64 sums alone decide.
HIST_INPUTS = {"beta": True, "uniform": True, "clustered": False,
               "one bin": False}
# The build's wall at workers 1 and 8 on the same corpus when each chunk
# ran its own masses pass and read-back (PERF.md §5, phase 3 then).
SEPARATE_MASSES_BUILD_S = {1: 0.040, 8: 0.089}
LS_PREFILL = (4, 64, 4096, 64, 64)    # B, H, S, dk, dv: zamba2-1.2b prefill
LS_SCORING = (256, 64, 128, 64, 64)   # the scoring batch
FA_ZAMBA = (4, 4096, 32, 32, 64)      # zamba2's shared attention block
FA_ZAMBA_SCORING = (256, 128, 32, 32, 64)
N_ZAMBA_CORPUS = 1 << 13              # token records zamba2 scores
N_RWKV_CORPUS = 1 << 12               # token records rwkv6 scores
LS_RWKV = (4, 64, 4096, 64, 64)       # rwkv6-7b's prefill scan
# The float32 rwkv6-7b (30.4 GB of weights) is held to the plain scan at
# (B, S) = (2, 1024), not at the prefill's (4, 4096): the plain scan runs
# step by step from the host, 32 blocks of 4096 steps.
RWKV_F32_SHAPE = (2, 1024)
# Decode (phase 17): rows start at these positions (each decodes its
# prefix alone first), then DECODE_STEPS steps together, in caches of
# DECODE_CACHE positions. Every step's logits against the prefill's at
# that position: float32 within DECODE_F32_TOL of the largest |logit|
# (the target the port's CPU tests hold it to; smollm measured 1.81e-6,
# zamba2 6.23e-6 at --seed 0 on an H100 80GB HBM3 at 700 W); bf16 within
# DECODE_BF16_TOL, at about 2.5 times the largest reading at --seed 0,
# 1 and 2, same card: smollm 1.73e-2 to 1.91e-2, zamba2 4.04e-2 to
# 4.28e-2. rwkv6-7b's logits are printed, not held (see the rwkv6 note
# above: 0.30 float32, 0.72 bf16 at seed 0); each of its blocks decodes
# the input its prefill block saw and is held to that block's output:
# float32 within RWKV_DECODE_F32_TOL of the block's largest |output|,
# 4.71e-6 to 1.25e-5 over the seeds (position 0's small heads), four
# times the largest; bf16 9.85e-3 to 1.14e-2, DECODE_BF16_TOL[RWKV]
# about 2.6 times the largest.
DECODE_OFFSETS = (0, 5, 11, 17)
DECODE_STEPS = 32
DECODE_CACHE = 64
DECODE_F32_TOL = 2e-5
RWKV_DECODE_F32_TOL = 5e-5
# Phase 18's bf16 decode against the prefill, at about 2.5 times the
# largest reading at --seed 0, 1 and 2, same card: yi-6b 2.22e-2 to
# 2.28e-2, deepseek-7b 2.28e-2 to 2.42e-2, qwen1.5-4b 2.56e-2 to 2.74e-2,
# chameleon-34b (24 layers) 2.21e-2 to 2.28e-2, llama4 (one pair) 6.99e-3
# to 7.41e-3 (7.54e-3 before the decode replayed the prefill's routing,
# over the entries both routed alike); phase 19's deepseek-v2 (8 layers)
# 1.45e-2 to 1.70e-2 over two runs of the three seeds (the combine's
# atomics move its bf16 roundings from run to run; its float32 decode,
# cut to 2 layers, 2.16e-6 to 2.53e-6, is held at DECODE_F32_TOL); phase
# 21's musicgen-medium 3.00e-2 to 3.29e-2.
DECODE_BF16_TOL = {ARCH: 5e-2, ZAMBA: 1e-1, RWKV: 3e-2,
                   "yi-6b": 5.7e-2, "deepseek-7b": 6.1e-2, "qwen1.5-4b": 7e-2,
                   "chameleon-34b": 5.7e-2, LLAMA4: 1.9e-2, DSV2: 4.2e-2,
                   MUSICGEN: 8.2e-2}
# The arbiter of rwkv6-7b's decode (phase 17): the model at full width cut
# to RWKV_F64_BLOCKS blocks (about 18 GB in float64), its float32 decode
# and prefill against its prefill computed in float64. The float64 decode
# must lie within RWKV_F64_DECODE_TOL of the float64 prefill: in exact
# arithmetic the two are one function, so only float64 rounding may part
# them (measured 1.2e-13 to 2.8e-12 of the largest |logit| at --seed 0, 1
# and 2 on an H100 80GB HBM3 at 700 W; a fault in the decode's algebra
# moves the logits by far more than the bar). The float32 decode lies as
# far from the float64 prefill as the float32 prefill does: over the same
# seeds and card the decode 1.76e-5 to 1.09e-3, the prefill through the
# step-by-step kernel the channel kernel replaced 4.14e-5 to 1.60e-3, and
# through the channel kernel 1.58e-3 at --seed 0 (the random-init model
# carries float32 rounding far: see the rwkv6 note above).
# RWKV_F32_DECODE_TOL is about three times the prefill's largest.
RWKV_F64_BLOCKS = 8
RWKV_F64_DECODE_TOL = 1e-9
RWKV_F32_DECODE_TOL = 5e-3
# (rows, cache length) of each model's timed decode cells: decode_32k's
# length at 32 rows, not its 128 (128 rows of smollm's cache are 172 GB),
# rwkv6's O(1) state at 128, and long_500k (1 row, 524288 positions) for
# the sub-quadratic two.
DECODE_CELLS = {ARCH: ((32, 32768),),
                ZAMBA: ((32, 32768), (1, 524288)),
                RWKV: ((128, 32768), (1, 524288))}
DECODE_PEAK_BYTES = 70e9
# Phase 18: the configs at head dim 128, each cut in depth only where its
# bf16 weights do not fit on the card (chameleon-34b is 68.6 GB of
# weights; llama4's 48 layers hold 397.7e9 parameters, one pair of them
# 18.55e9, 37.1 GB, and two pairs 69.7 GB before activations), and each
# one's decode rows at 32768 positions: as many as its KV cache lets fit
# beside the weights under DECODE_PEAK_BYTES. Phase 19's deepseek-v2-236b
# runs one dense block and 7 MLA + MoE blocks of its 60 (29.19e9
# parameters, 58.4 GB of bf16; each MoE block more is 3.97e9): its latent
# cache is 576 numbers a token and a layer, 0.30 GB a row at 32768
# positions and 8 layers (a step at 16 rows peaked at 65.37 GB on an H100
# 80GB HBM3; each row more adds about 0.36 GB).
NEW_DEPTH = {"chameleon-34b": 24, LLAMA4: 2, DSV2: 8}
NEW_DECODE_ROWS = {"yi-6b": 16, "deepseek-7b": 2, "qwen1.5-4b": 4,
                   "chameleon-34b": 8, LLAMA4: 32, DSV2: 24}
NEW_DECODE_LENGTH = 32768
N_LLAMA4_CORPUS = 1 << 12             # token records llama4 scores
FA_YI = (4, 4096, 32, 4, 128)         # yi-6b's prefill attention
FA_LLAMA4 = (4, 4096, 40, 8, 128)     # llama4-maverick's
# deepseek-v2's MLA prefill: B, S, H, KV, q·k head dim, v head dim
FA_DSV2 = (4, 4096, 128, 128, 192, 128)
# Phase 19's plain attention runs over groups of this many KV heads: one
# call at (4, 4096) with all 128 would hold 34 GB of float32 scores a copy
# (the score, mask and softmax copies of 8 heads are 6.4 GB, beside 58.4 GB
# of weights).
DSV2_PLAIN_HEADS = 8
# Phase 19's float32 decode runs deepseek-v2 cut to the dense block and one
# MLA + MoE block at full width (5.36e9 parameters, 21.4 GB in float32;
# the 8-block model is 117 GB in float32).
DSV2_F32_LAYERS = 2
N_DSV2_CORPUS = 1 << 12               # token records deepseek-v2 scores
# ... in calls of 128 records: a call of SCORE_BATCH (32768 tokens through
# 7 MoE layers beside 58.4 GB of weights) peaked at 78.97 GB of the card's
# 85.0 GB (H100 80GB HBM3), and one run failed to allocate there.
DSV2_SCORE_BATCH = 128
# deepseek-v2-236b's MoE layer (src/repro/configs/deepseek_v2_236b.py:
# d_model 5120, 160 routed experts of 1536, top-6 softmax, 2 shared;
# arXiv:2405.04434), run alone: its MLA is not ported yet.
DSV2_MOE = ModelConfig(
    name="deepseek-v2-236b-moe", family="moe", num_layers=1, d_model=5120,
    num_heads=128, num_kv_heads=128, d_ff=1536, vocab_size=102400,
    moe=True, num_experts=160, num_experts_per_tok=6, num_shared_experts=2,
    moe_d_ff=1536, dense_d_ff=12288, first_k_dense=1)
MOE_TOKENS = (4, 4096)
# The MoE layer in bf16 against the same routing evaluated in float32, one
# expert at a time with each expert's weights cast alone: max |port -
# plain| within MOE_F32_TOL of the largest |plain output|. The port rounds
# g and u (bf16 bmm), h, y and its output to bf16. At --seed 0, 1 and 2 on
# an H100 80GB HBM3 at 700 W: llama4's layer on its prefill input 5.61e-3
# to 6.23e-3, deepseek-v2's widths 4.90e-3 to 5.66e-3 (||difference|| /
# ||plain|| 4.09e-3 to 4.20e-3); the bar is three times the largest. A
# token dropped or sent to another expert moves its output by about the
# largest |output|.
MOE_F32_TOL = 2e-2
# Two runs of one model whose hidden states differ by bf16 rounding (the
# kernel against plain attention, or decode against prefill) are compared
# with the first run's routing replayed in the second (`replayed_routing`);
# a token whose own routing in the second run would differ must be a near
# tie: its gates' smallest gap around the k-th choice within
# ROUTE_FLIP_MARGIN. llama4's decode against its prefill flipped one token
# at --seed 0 and 1 (of 161), at margins 4.28e-4 and 3.32e-4 (same card;
# the sigmoid gates of a random-init router's top two lie about 0.03 to
# 0.07 apart); deepseek-v2's softmax top-6 of 160 about 5,560 of 114,688
# choices in a prefill, at margins up to 8.7e-4.
ROUTE_FLIP_MARGIN = 5e-3
# linear_scan against its plain version (phase 9). At the reference's
# shapes (dk 16 or 8), the reference's own atol = 1e-4
# (tests/test_kernels.py). At dk = dv = 64 both kernels compute chunked
# forms with split-TF32 products. The bar is SCAN_REL of the largest
# |output| (o or the state), against the plain version, or, where
# S >= 1024, against the plain recurrence in float64 on the card (the
# float32 plain version drifts there as much as the kernels do: 2.1e-7 of
# the largest |o| at the prefill shape). The chunked kernel's largest
# error over seeds 0 to 7 (`check_scan`) measured 4.61e-7 (the state at
# decays of exactly 1 and S = 4096, against the float64 arbiter, from
# which the float32 plain version's state lies 2.2e-6 to 3.4e-6 at seeds 0
# to 2) and 4.37e-7 elsewhere (o at the scoring shape); the channel
# kernel's 6.22e-7 with float32 v (decays of exactly 1, S = 4096) and
# 4.90e-7 beyond one bf16 ulp with bf16 v (--seed 0), on an H100 80GB HBM3
# at 700 W. The step-by-step kernel this one replaced measured at most 2.73e-7
# (seeds 0 to 2), so SCAN_REL is 3.7 times that. A step dropped or read
# twice moves o by far more.
SCAN_REF_ATOL = 1e-4
SCAN_REL = 1e-6
# Every kernel's launch counter, by name.
COUNTERS = {"flash_attention": fa_ops.launches,
            "flash_attention_bwd": fa_ops.bwd_launches,
            "linear_scan": ls_ops.launches,
            "score_hist": sh_ops.launches,
            "threshold_select": ts_ops.launches}


def reset_counts(names) -> None:
    """Set the launch counters of `names` to 0, by route too."""
    for name in names:
        COUNTERS[name].reset()


def scan_routes() -> dict:
    """linear_scan's launches by route since the last reset."""
    return dict(ls_ops.launches.routes)


def check_scan_routes(expected: int, where: str,
                      route: str = "chunked") -> None:
    """Every linear_scan launch since the reset went through `route`'s
    kernel, `expected` of them."""
    routes = scan_routes()
    want = {"chunked": 0, "channel": 0, route: expected}
    check(routes == want,
          f"{where}: linear_scan launches by route {routes}, expected "
          f"{expected} {route}")
    print(f"{where}: linear_scan launches by route {routes}")


def kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled one: the last name before its
    arguments, with its integer and bool template arguments
    (`flash_bf16<64, 64, 1>`)."""
    if not mangled.startswith("_ZN"):
        return mangled
    rest, names = mangled[3:], []
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group()
        names.append(rest[len(n):len(n) + int(n)])
        rest = rest[len(n) + int(n):]
    args = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    targs = re.findall(r"L[ib](\d+)E", args.group(1)) if args else []
    return names[-1] + (f"<{', '.join(targs)}>" if targs else "")


def ptxas_report(log: str) -> list:
    """One line a kernel from `nvcc -Xptxas -v`'s report: its registers,
    spill stores and loads, and the ptxas advisories (C75xx) naming it."""
    lines, current, notes = [], None, {}
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        advisory = re.search(r"\((C75\d\d)\).*function '(\w+)'", ln)
        if advisory:
            notes.setdefault(advisory.group(2), []).append(advisory.group(1))
        elif entry:
            current = entry.group(1)
            lines.append([current, "", ""])
        elif current and "spill stores" in ln:
            lines[-1][2] = ln.strip()
        elif current and "Used" in ln:
            lines[-1][1] = re.search(r"Used \d+ registers", ln).group()
    return [f"{kernel_name(m)}: {regs}; {spills}"
            + (f"; advisories {', '.join(notes[m])}" if m in notes else "")
            for m, regs, spills in lines]


def check(ok: bool, what: str) -> None:
    """Fail the run (non-zero exit, no result line) unless `ok`."""
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def device_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of `fn` on the card (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of `fn`, which must not sync: the
    card sleeps while the calls are queued behind it, so CUDA events see
    the device's time alone, not the host's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound(name: str, n: int, bytes_moved: int):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the float32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_RECORD[name] * n / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2 -------------------------------------------------------------------

def hist_input(kind: str, chunk: torch.Tensor, g) -> torch.Tensor:
    """A 2^22-record score_hist input: "beta" is `chunk` (the corpus's
    Beta(0.01, 1) scores); "uniform" is uniform on [0, 1); "clustered" puts
    every record in one of four bins of 4096 (and of 64), "one bin" all of
    them in one."""
    u = torch.rand(chunk.numel(), device=chunk.device, generator=g)
    if kind == "beta":
        return chunk
    if kind == "uniform":
        return u
    if kind == "clustered":
        k = torch.tensor([517.0, 1024.0, 2900.0, 4000.0], device=u.device)[
            torch.randint(0, 4, u.shape, device=u.device, generator=g)]
        return (k + 0.25 + 0.5 * u) / 4096
    return (1234.25 + 0.5 * u) / 4096


def check_hist(s: torch.Tensor, bins: int, plain_bar: bool, label: str):
    """score_hist with its masses on `s` against its plain versions and
    float64 sums: counts exact; sums within 1e-6 |e| + n 2^-32 of float64
    (the fixed point truncates each run below 2^-32) and, if `plain_bar`,
    within 4e-3 |p| + 1e-3 of the plain float32 sums; masses within
    rel 1e-12 of torch.float64 sums; all bitwise on a second launch.
    Returns the largest |kernel - plain|."""
    m1 = torch.empty(2, dtype=torch.float64, device=s.device)
    m2 = torch.empty_like(m1)
    got = sh_ops.score_hist(s, bins, masses=m1)
    again = sh_ops.score_hist(s, bins, masses=m2)
    plain = sh_ref.score_hist_ref(s, bins)
    plain_m = sh_ref.chunk_masses_ref(s)
    valid = s >= 0
    a = s.clamp(0.0, 1.0)[valid]
    ids = sh_ref.bin_index(s, bins)[valid]
    exact = [torch.bincount(ids, weights=w, minlength=bins)
             for w in (a.double().sqrt(), a.double())]
    torch.cuda.synchronize()
    what = f"score_hist {label}, {bins} bins"
    check(torch.equal(got[0], plain[0]), f"{what}: counts")
    check(all(torch.equal(x, y) for x, y in zip(got, again))
          and torch.equal(m1, m2), f"{what}: repeat launches differ")
    for k, p, e in zip(got[1:], plain[1:], exact):
        if plain_bar:
            check(bool(((k - p).abs() <= 4e-3 * p.abs() + 1e-3).all()),
                  f"{what}: sums vs plain")
        tol = 1e-6 * e.abs() + s.numel() * 2.0 ** -32
        check(bool(((k.double() - e).abs() <= tol).all()),
              f"{what}: sums vs float64")
    rel = float(((m1 - plain_m).abs() / plain_m.abs()).max())
    check(rel <= 1e-12, f"{what}: masses {rel:.3g} from float64")
    err = max(float((k - p).abs().max()) for k, p in zip(got, plain))
    drift = max(float(((p.double() - e).abs() / (4e-3 * e.abs() + 1e-3))
                      .max()) for p, e in zip(plain[1:], exact))
    print(f"{what}: counts exact, repeat bitwise, max |kernel - plain| "
          f"{err:.6g}, max |kernel - float64| "
          f"{max(float((k.double() - e).abs().max()) for k, e in zip(got[1:], exact)):.6g}, "
          f"masses {rel:.3g} from float64; the plain sums' distance from "
          f"float64 over their bar {drift:.3g}"
          + ("" if plain_bar else " (float64 decides)"))
    return err


def check_kernels(chunk: torch.Tensor, g) -> dict:
    """Phase 2: each kernel against its plain version; returns each
    kernel's largest |kernel - plain| (score_hist's where the plain sums
    are a bar)."""
    errs = {"score_hist": 0.0}
    for kind, plain_bar in HIST_INPUTS.items():
        s = hist_input(kind, chunk, g)
        for bins in (4096, 64):
            err = check_hist(s, bins, plain_bar, kind)
            if plain_bar:
                errs["score_hist"] = max(errs["score_hist"], err)
    for n, tau in [(CHUNK, tau) for tau in (0.0, 0.5, 0.999, 1.01)] + [
            (n, 0.3) for n in (0, 1000, 5000, CHUNK - 1)]:
        part = chunk[:n]
        got = ts_ops.threshold_select(part, tau)
        want = ts_ref.threshold_select_ref(part, tau)
        count = ts_ops.threshold_count(part, tau)
        check(torch.equal(got, want), f"threshold_select n={n} tau={tau}")
        check(int(count) == want.numel(), f"threshold_count n={n} tau={tau}")
    errs["threshold_select"] = 0.0
    print("threshold_select: indices exact at tau 0/0.5/0.999/1.01 and "
          "lengths 0/1000/5000/2^22-1; threshold_count equal to their "
          "lengths")
    return errs


# -- phase 3 -------------------------------------------------------------------

QUERIES = [
    ("RT", SUPGQuery(target="recall", gamma=0.9, delta=0.05, budget=3000,
                     method="is")),
    ("PT", SUPGQuery(target="precision", gamma=0.9, delta=0.05,
                     budget=3000, method="is")),
    ("JT", JointSUPGQuery(gamma_recall=0.8, stage_budget=3000)),
]


def run_query(eng, key, oracle, name, q):
    """One query through the user entry point; (selection, wall s)."""
    fn = eng.run_joint if name == "JT" else eng.run
    t0 = time.perf_counter()
    sel = fn(key, oracle, q)
    torch.cuda.synchronize()
    return sel, time.perf_counter() - t0


def same(a, b) -> bool:
    """Equal tau, per-shard counts and indices."""
    return (a.tau == b.tau
            and np.array_equal(a.shard_counts, b.shard_counts)
            and all(np.array_equal(a.indices(i), b.indices(i))
                    for i in range(a.num_shards)))


def plain_counts(eng, sel, name, labels) -> np.ndarray:
    """Per-shard counts by a plain comparison on the card: {A >= tau}
    plus the labeled positives below tau; for JT, the true positives
    among that candidate set."""
    thr = ts_ref.threshold32(sel.tau)
    tau_rt = sel.tau
    pos = sel.sampled_positive_global
    out = []
    for sh, shard in enumerate(eng.shards):
        lo, hi = int(eng.offsets[sh]), int(eng.offsets[sh + 1])
        mine = pos[(pos >= lo) & (pos < hi)] - lo
        below = np.unique(mine[shard[torch.from_numpy(mine).to(shard.device)]
                               .cpu().numpy() < tau_rt])
        if name == "JT":
            cand = torch.nonzero(shard >= thr).flatten().cpu().numpy()
            cand = np.union1d(cand, below)
            out.append(int((labels[lo + cand] > 0.5).sum()))
        else:
            out.append(int((shard >= thr).sum()) + below.size)
    return np.asarray(out, np.int64)


def small_agreement(seed: int) -> None:
    """The card's engine against a CPU engine on one corpus state."""
    scores, labels = make_beta_on_device(600_000, 0.01, 1.0, seed=seed + 1,
                                         device="cpu")
    shards = list(torch.tensor_split(scores, 3))
    oracle = array_oracle(labels)
    with SelectionEngine(shards, num_bins=4096, chunk_records=1 << 16,
                         device="cpu") as cpu, \
            SelectionEngine.from_state(cpu._state, device=DEVICE) as card:
        for name, q in QUERIES:
            a, _ = run_query(cpu, R.PRNGKey(seed), oracle, name, q)
            b, _ = run_query(card, R.PRNGKey(seed), oracle, name, q)
            check(same(a, b), f"card vs cpu engine on a small corpus, {name}")
    print("small corpus (3 x 200,000): card engine == CPU engine for "
          "RT/PT/JT from one corpus state")


def engine_phase(scores, labels, seed):
    """Phase 3: build at workers 1 and 8 and run RT/PT/JT on each."""
    shards = list(torch.tensor_split(scores, N_SHARDS))
    oracle = array_oracle(labels)
    truth = labels > 0.5
    results, walls = {}, {}
    for workers in (1, 8):
        t0 = time.perf_counter()
        eng = SelectionEngine(shards, num_bins=4096, workers=workers,
                              clamp_workers=False, device=DEVICE)
        torch.cuda.synchronize()
        walls[f"build_w{workers}"] = time.perf_counter() - t0
        results[workers] = {"engine": eng}
        for name, q in QUERIES:
            sel, wall = run_query(eng, R.PRNGKey(seed), oracle, name, q)
            results[workers][name] = sel
            walls[f"{name}_w{workers}"] = wall
    e1, e8 = results[1]["engine"], results[8]["engine"]
    check(all(torch.equal(x, y) for x, y in zip(e1.sketch, e8.sketch)),
          "sketch differs between workers 1 and 8")
    check(e1._state.z == e8._state.z, "z differs between workers 1 and 8")
    for name, _ in QUERIES:
        a, b = results[1][name], results[8][name]
        check(same(a, b), f"{name} differs between workers 1 and 8")
        check(np.array_equal(a.shard_counts,
                             plain_counts(e1, a, name, labels)),
              f"{name} counts differ from the plain count on the card")
        sel_idx = np.concatenate([e1.offsets[i] + a.indices(i)
                                  for i in range(a.num_shards)])
        print(f"{name}: tau {a.tau:.6g}, selected {a.total_selected}, "
              f"oracle calls {a.oracle_calls}, recall "
              f"{queries.recall_of(sel_idx, truth):.4f}, precision "
              f"{queries.precision_of(sel_idx, truth):.4f}")
    for r in results.values():
        r["engine"].close()
    return results, walls


# -- phase 5 -------------------------------------------------------------------

def plain_attention(q, k, v, causal=True):
    """flash_attention's plain version in the kernel's (B,S,H,dh) layout."""
    return fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal).transpose(1, 2)


def plain_attention_by_heads(q, k, v, causal=True):
    """`plain_attention` over groups of DSV2_PLAIN_HEADS KV heads (each
    head attends alone), so that its float32 S x S scores stay a few GB."""
    g, n = q.shape[2] // k.shape[2], DSV2_PLAIN_HEADS
    return torch.cat([plain_attention(q[:, :, j * g:(j + n) * g],
                                      k[:, :, j:j + n], v[:, :, j:j + n],
                                      causal)
                      for j in range(0, k.shape[2], n)], dim=2)


def attention_inputs(shape, dtype, g):
    """Standard normal q (B,S,H,dh), k (B,S,KV,dh) and v (B,S,KV,dv) on
    the card, `shape` (B, S, H, KV, dh) with dv = dh or (B, S, H, KV, dh,
    dv)."""
    b, s, h, kv, dh = shape[:5]
    dv = shape[5] if len(shape) > 5 else dh
    return tuple(torch.randn(b, s, n, d, generator=g, device=DEVICE)
                 .to(dtype) for n, d in ((h, dh), (kv, dh), (kv, dv)))


def hold_flash(q, k, v, causal: bool, what: str,
               plain_fn=plain_attention) -> float:
    """The kernel on (q, k, v) against `plain_fn`: in bf16 each output
    within BF16_ATOL + BF16_RTOL |plain| and the whole within
    BF16_FRO_TOL ||plain||, in float32 within F32_TOL abs + rel; two
    launches bitwise equal. Prints the reading; returns max |kernel -
    plain|."""
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    again = fa_ops.flash_attention(q, k, v, causal=causal)
    plain = plain_fn(q, k, v, causal).float()
    torch.cuda.synchronize()
    err = (got.float() - plain).abs()
    if q.dtype == torch.bfloat16:
        excess = float((err - BF16_RTOL * plain.abs()).max())
        fro = float(err.norm() / plain.norm())
        check(excess <= BF16_ATOL and fro <= BF16_FRO_TOL,
              f"{what}: |err| - 2^-7 |plain| up to {excess:.4g} "
              f"(tol {BF16_ATOL}), ||err|| / ||plain|| {fro:.4g} "
              f"(tol {BF16_FRO_TOL})")
        bar = (f"max |err| - 2^-7 |plain| {excess:.6g} (tol "
               f"{BF16_ATOL}), ||err|| / ||plain|| {fro:.6g} (tol "
               f"{BF16_FRO_TOL})")
    else:
        check(bool((err <= F32_TOL + F32_TOL * plain.abs()).all()), what)
        bar = f"tol {F32_TOL} abs + rel"
    check(torch.equal(got, again), f"{what}: repeat launches differ")
    print(f"{what}: max |kernel - plain| {float(err.max()):.6g}, "
          f"{bar}, repeat bitwise")
    return float(err.max())


def check_flash(seed: int) -> float:
    """Phase 5: the kernel against its plain version; returns the largest
    |kernel - plain| at the prefill shape in bf16."""
    g = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    cases = [(FA_PREFILL, True), ((2, 1000, 15, 5, 64), True),
             ((2, 1000, 15, 5, 64), False), ((2, 512, 8, 1, 128), True),
             ((2, 512, 8, 1, 128), False), (FA_SCORING, True),
             (FA_ZAMBA, True), (FA_ZAMBA_SCORING, True)]
    err_prefill = 0.0
    for shape, causal in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = attention_inputs(shape, dtype, g)
            err = hold_flash(q, k, v, causal,
                             f"flash_attention {shape} {dtype} "
                             f"causal={causal}")
            if shape == FA_PREFILL and dtype == torch.bfloat16:
                err_prefill = err
            del q, k, v
    return err_prefill


# -- phase 6 -------------------------------------------------------------------

def model_flops(cfg, batch: int, seq: int) -> float:
    """Prefill model FLOPs, for the mfu of a prefill.

    Dense: 2 · non-embedding params · tokens, plus causal attention,
    2 · B · H · S² · dh a layer (MLA: B · H · S² · (dn + dr + dv), q·k
    over dn + dr dims and p·v over dv).
    Hybrid (Zamba2): the shared block's weights work at each of its n_super
    runs, so 2 · (L · P_mamba + n_super · P_shared) · tokens; attention
    runs n_super times, 2 · B · H · S² · dh each; and each Mamba2 block's
    scan counts the operations of the step form the port runs, per token
    and head 5 · N · hd (k·v, the decay's multiply-add, q·S's
    multiply-add; the count of linear_scan's bound), float32 operations
    on the CUDA cores counted at the bf16 peak like the rest.
    RWKV6: 2 · non-embedding params · tokens and each block's wkv scan,
    5 · hd² per token and head, counted the same way; no attention.
    MoE: the active parameters (each token's experts per token of the
    routed experts, `count_params_analytic(active_only=True)`), not the
    dispatch's E · cap rows a layer.
    """
    non_embedding = modellib.count_params_analytic(cfg, active_only=True) \
        - cfg.vocab_size * cfg.d_model * cfg.num_codebooks \
        * (1 if cfg.tie_embeddings else 2)
    tokens = batch * seq
    attention_runs = cfg.num_layers
    scan = 0.0
    if cfg.block == "mamba":
        attention_runs = cfg.num_layers // cfg.shared_attn_every \
            if cfg.shared_attn_every else 0
        shared = cfg.d_model * cfg.head_dim * (
            2 * cfg.num_heads + 2 * cfg.num_kv_heads) \
            + 3 * cfg.d_model * cfg.d_ff if attention_runs else 0
        non_embedding += (attention_runs - 1) * shared
        n, hd = cfg.ssm_state_dim, cfg.ssm_head_dim
        heads = cfg.d_inner // hd
        scan = 5.0 * n * hd * heads * tokens * cfg.num_layers
    if cfg.block == "rwkv":
        attention_runs = 0
        hd = cfg.ssm_head_dim
        scan = 5.0 * hd * cfg.d_model * tokens * cfg.num_layers
    attn_dims = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim \
        + cfg.v_head_dim if cfg.use_mla else 2 * cfg.head_dim
    return (2.0 * non_embedding * tokens
            + 1.0 * batch * cfg.num_heads * seq * seq * attn_dims
            * attention_runs + scan)


def init_model(cfg, seed: int):
    """The full-width model, its weights drawn on the card from `seed`."""
    t0 = time.perf_counter()
    model = modellib.init(cfg, generator=torch.Generator(device=DEVICE)
                          .manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {n_params} parameters "
          f"({cfg.dtype}) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    return model


# The model's kernels: the modules that look each up, and its plain
# version.
PLAIN = {"flash_attention": ((attention,), plain_attention),
         "linear_scan": ((mamba, rwkv), ls_ref.linear_scan_ref)}
# The linear_scan kernel each family's blocks launch on the card.
SCAN_ROUTE = {"mamba": "chunked", "rwkv": "channel"}


@contextlib.contextmanager
def plain_paths(names=tuple(PLAIN), scan=ls_ref.linear_scan_ref):
    """The model's kernels of `names` swapped for their plain versions
    (linear_scan for `scan`); fails if one of them launches meanwhile."""
    before = {name: COUNTERS[name].count for name in names}
    with contextlib.ExitStack() as stack:
        for name in names:
            modules, plain = PLAIN[name]
            for module in modules:
                stack.enter_context(mock.patch.object(
                    module, name, scan if name == "linear_scan" else plain))
        yield
    torch.cuda.synchronize()
    check(all(COUNTERS[name].count == n for name, n in before.items()),
          f"a plain run of {names} launched its kernel")


def bf16_gap_sources(model, tokens, names, kernels, plain, scale) -> None:
    """Where the bf16 model's kernels-vs-plain gap comes from, as shares
    of the largest |logit|: each kernel alone swapped for its plain
    version, against the kernels; then, with no kernel at all, the plain
    model with its scan computed in float64 (a change of float32 rounding
    alone, the size of the scan kernel's: how far bf16 carries any such
    change) and in bf16 (a scan computed in bf16), against the plain
    model."""
    for name in names:
        with plain_paths((name,)):
            got = modellib.last_logits(model, tokens)
        print(f"bf16 model, only {name} by its plain version: max "
              f"|difference from the kernels| "
              f"{float((got - kernels).abs().max()) / scale:.3g} of the "
              f"largest |logit|")
    for label, dtype in (("float64", torch.float64),
                         ("bf16", torch.bfloat16)):
        with plain_paths(scan=functools.partial(ls_ref.linear_scan_ref,
                                                compute_dtype=dtype)):
            got = modellib.last_logits(model, tokens)
        check(bool(torch.isfinite(got).all()), f"{label} scan logits")
        print(f"bf16 model, plain versions with the scan computed in "
              f"{label}: max |difference from the plain model| "
              f"{float((got - plain).abs().max()) / scale:.3g} of the "
              f"largest |logit|")


@contextlib.contextmanager
def recorded_routing():
    """Every MoE layer's routing meanwhile, in call order: a dict a
    `moe.moe_apply` of its tokens' expert ids and gates (n, k), every
    expert's gate (n, E), whether each assignment was kept (n, k) and the
    capacity."""
    calls = []
    top_k, dispatch = moe.top_k_routing, moe.dispatch

    def routing(logits, k, gate_fn="softmax"):
        ids, gates, gates_all = top_k(logits, k, gate_fn)
        calls.append({"ids": ids, "gates": gates, "gates_all": gates_all})
        return ids, gates, gates_all

    def dispatching(expert_ids, num_experts, cap):
        out = dispatch(expert_ids, num_experts, cap)
        order, keep = out[0], out[3]
        kept = torch.empty_like(keep)
        kept[order] = keep
        calls[-1].update(kept=kept.reshape(expert_ids.shape), cap=cap)
        return out
    with mock.patch.object(moe, "top_k_routing", routing), \
            mock.patch.object(moe, "dispatch", dispatching):
        yield calls


@contextlib.contextmanager
def replayed_routing(recorded):
    """Every MoE layer meanwhile sends its tokens to the experts that
    `recorded(i)` names for its i-th call ((n, k) ids, from another run)
    instead of its own top-k choice, with the gates its own router gives
    those experts (renormalized as `moe.top_k_routing` renormalizes); the
    dispatch follows those ids. Yields a list, a dict a call of its own
    choice (`ids`), every expert's gate and the replayed ids, for
    `replay_flips`."""
    calls = []
    top_k = moe.top_k_routing

    def routing(logits, k, gate_fn="softmax"):
        own, _, gates_all = top_k(logits, k, gate_fn)
        ids = recorded(len(calls))
        calls.append({"ids": own, "gates_all": gates_all, "replayed": ids})
        gates = gates_all.gather(-1, ids)
        if gate_fn == "softmax" and k > 1:
            gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True),
                                            1e-9)
        return ids, gates, gates_all
    with mock.patch.object(moe, "top_k_routing", routing):
        yield calls


def replay_flips(calls, label: str) -> None:
    """Every token whose own top-k choice differs from the replayed one
    (`replayed_routing`) must be a near tie: its gates' smallest gap around
    the k-th choice within ROUTE_FLIP_MARGIN. Prints the flips (nothing
    without MoE layers)."""
    if not calls:
        return
    flips, tokens, worst = 0, 0, 0.0
    for c in calls:
        differ = (torch.sort(c["ids"], dim=-1)[0]
                  != torch.sort(c["replayed"], dim=-1)[0]).any(dim=-1)
        flips += int(differ.sum())
        tokens += differ.numel()
        if bool(differ.any()):
            worst = max(worst, float(tie_margin(
                c["gates_all"][differ], c["ids"].shape[-1]).max()))
    check(worst <= ROUTE_FLIP_MARGIN,
          f"{label}: a routing choice flipped at a tie margin of {worst:.4g}"
          f" (tol {ROUTE_FLIP_MARGIN})")
    print(f"{label}: the routing replayed in all {len(calls)} MoE calls; "
          f"{flips} of {tokens} token choices would have differed, each a "
          f"near tie (largest margin {worst:.4g}, tol {ROUTE_FLIP_MARGIN})")


def tie_margin(gates_all: torch.Tensor, k: int) -> torch.Tensor:
    """Each row's smallest gap between consecutive gates among its k + 1
    largest: how near its top-k choice is to a tie."""
    top = torch.sort(gates_all, dim=-1, descending=True)[0][..., :k + 1]
    return (top[..., :-1] - top[..., 1:]).min(dim=-1)[0]


def model_phase(model, cfg, seed: int, per_prefill: dict,
                f32_copy: bool = True) -> None:
    """Phases 6, 10, 16, 18 and 19: one full-width prefill through
    `make_serve_prefill`, launching each kernel of `per_prefill` exactly
    that often; then the bf16 model, and with `f32_copy` its float32 copy,
    each with the kernels against the plain versions. An MoE model's plain
    run replays the kernel run's routing (`replayed_routing`)."""
    bf16_tol, f32_tol = LOGIT_TOL[cfg.name]
    b, s = FA_PREFILL[:2]
    tokens = rand_tokens(cfg, (b, s), torch.Generator(device=DEVICE)
                         .manual_seed(seed + 1))
    serve_prefill = make_serve_prefill(cfg)
    serve_prefill(model, {"tokens": tokens[:, :128]})      # warm-up
    torch.cuda.synchronize()

    reset_counts(per_prefill)
    t0 = time.perf_counter()
    scores = serve_prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: COUNTERS[name].count for name in per_prefill}
    check(launches == per_prefill,
          f"one prefill of {cfg.name} launched {launches}, expected "
          f"{per_prefill}")
    check(scores.shape == (b,) and bool(torch.isfinite(scores).all())
          and bool(((scores >= 0) & (scores <= 1)).all()),
          f"prefill scores {scores}")
    mfu = model_flops(cfg, b, s) / wall / BF16_OPS_PER_S
    print(f"{cfg.name} prefill ({b}, {s}) through make_serve_prefill: "
          f"{wall:.4f} s, {b * s / wall:.1f} tokens/s, mfu {mfu:.4f}, "
          f"launches {launches}, scores {scores.tolist()}")
    if "linear_scan" in per_prefill:
        check_scan_routes(per_prefill["linear_scan"], "the prefill",
                          SCAN_ROUTE[cfg.block])

    # The bf16 model itself: its last-position logits with the kernels
    # against the same model with the plain versions.
    with recorded_routing() as kernel_routes:
        bf16_kernel = modellib.last_logits(model, tokens)
    with plain_paths(), replayed_routing(
            lambda i: kernel_routes[i]["ids"]) as plain_routes:
        bf16_plain = modellib.last_logits(model, tokens)
    replay_flips(plain_routes, f"{cfg.name} bf16 prefill, plain attention "
                 f"against the kernel's")
    bf16_diff = float((bf16_kernel - bf16_plain).abs().max())
    bf16_scale = float(bf16_plain.abs().max())
    check(bool(torch.isfinite(bf16_kernel).all())
          and bf16_diff <= bf16_tol * bf16_scale,
          f"{cfg.name} bf16 logits: kernels vs plain differ by {bf16_diff} "
          f"(largest |logit| {bf16_scale})")
    print(f"bf16 model, last-position logits {tuple(bf16_plain.shape)}: max "
          f"|kernels - plain| {bf16_diff:.6g}, "
          f"largest |logit| "
          f"{bf16_scale:.6g}, ratio {bf16_diff / bf16_scale:.3g} "
          f"(tol {bf16_tol})")
    if len(per_prefill) > 1:
        bf16_gap_sources(model, tokens, per_prefill, bf16_kernel,
                         bf16_plain, bf16_scale)

    if not f32_copy:
        return
    f32 = copy.deepcopy(model).float()
    f32.cfg = dataclasses.replace(cfg, dtype="float32")
    with_kernel = modellib.last_logits(f32, tokens)
    with plain_paths():
        with_plain = modellib.last_logits(f32, tokens)
    diff = float((with_kernel - with_plain).abs().max())
    scale = float(with_plain.abs().max())
    check(bool(torch.isfinite(with_kernel).all()) and diff <= f32_tol
          * scale, f"{cfg.name} float32 logits: kernels vs plain differ by "
          f"{diff} (largest |logit| {scale})")
    print(f"float32 copy, last-position logits {tuple(with_plain.shape)}: "
          f"max |kernels - plain| {diff:.6g}, largest |logit| "
          f"{scale:.6g}, ratio {diff / scale:.3g} (tol {f32_tol})")
    rounding = float((bf16_plain - with_plain).abs().max()) / scale
    print(f"bf16 model with the plain versions against its float32 copy: "
          f"max |difference| {rounding:.3g} of the largest |logit|")
    del f32, with_kernel, with_plain, bf16_kernel, bf16_plain


# -- phase 7 -------------------------------------------------------------------

def token_corpus(cfg, n_corpus: int, seed: int):
    """(tokens, labels) of `make_token_corpus` (2% planted positives):
    (n, SEQ_LEN) tokens, or with K codebooks (n, SEQ_LEN, K) whose first
    codebook is that corpus (the marker oracle's) and the others are
    uniform tokens from `seed`."""
    tokens, labels = make_token_corpus(n_corpus, SEQ_LEN, cfg.vocab_size,
                                       0.02, seed)
    check(np.array_equal(labels > 0.5, contains_marker(tokens)),
          "corpus labels are not the marker oracle")
    if cfg.num_codebooks > 1:
        rest = np.random.default_rng(seed + 1).integers(
            0, cfg.vocab_size, (n_corpus, SEQ_LEN, cfg.num_codebooks - 1),
            dtype=tokens.dtype)
        tokens = np.concatenate([tokens[..., None], rest], axis=-1)
    return tokens, labels


def rand_tokens(cfg, shape, g) -> torch.Tensor:
    """Uniform tokens of `shape` on the card, with a trailing codebook
    axis for a model of K > 1 codebooks."""
    if cfg.num_codebooks > 1:
        shape = (*shape, cfg.num_codebooks)
    return torch.randint(0, cfg.vocab_size, shape, device=DEVICE,
                         generator=g)


def logit_shape(cfg) -> tuple:
    """The trailing shape of a model's logits: (V,), or (K, V)."""
    return ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()) \
        + (cfg.vocab_size,)


def roc_auc(scores: np.ndarray, truth: np.ndarray) -> float:
    """The area under the ROC curve of `scores` for the positives `truth`
    (Mann-Whitney: tied scores share their mean rank)."""
    _, inverse, counts = np.unique(scores, return_inverse=True,
                                   return_counts=True)
    ends = np.cumsum(counts)
    ranks = (ends - (counts - 1) / 2.0)[inverse]
    n_pos = int(truth.sum())
    n_neg = truth.size - n_pos
    return float((ranks[truth].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def score_select_phase(model, cfg, seed: int, n_corpus: int,
                       per_call: dict, batch: int = SCORE_BATCH,
                       result: Optional[dict] = None) -> dict:
    """Phases 7, 11, 16, 18, 19, 21 and 22: score a token corpus of
    `n_corpus` records with the full model in calls of `batch` records,
    launching each kernel of `per_call` that often a call, and select on
    the card; returns the path's launch counts, and puts the scores (on
    the host), labels and the RT query's recall and oracle calls in
    `result`."""
    tokens_np, labels = token_corpus(cfg, n_corpus, seed)
    tokens = torch.from_numpy(tokens_np).to(DEVICE)
    serve_prefill = make_serve_prefill(cfg)
    serve_prefill(model, {"tokens": tokens[:batch]})   # warm-up
    torch.cuda.synchronize()

    path = (*per_call, "score_hist", "threshold_select")
    reset_counts(path)
    t0 = time.perf_counter()
    scores = torch.cat([serve_prefill(model,
                                      {"tokens": tokens[i:i + batch]})
                        for i in range(0, n_corpus, batch)])
    torch.cuda.synchronize()
    t_score = time.perf_counter() - t0
    check(scores.shape == (n_corpus,) and bool(torch.isfinite(scores).all())
          and bool(((scores >= 0) & (scores <= 1)).all()),
          "corpus scores are not finite probabilities")
    t0 = time.perf_counter()
    name, q = QUERIES[0]
    with SelectionEngine(list(scores.tensor_split(N_SCORE_SHARDS)),
                         num_bins=4096, device=DEVICE) as eng:
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        sel, t_query = run_query(eng, R.PRNGKey(seed), array_oracle(labels),
                                 name, q)
        launches = {k: COUNTERS[k].count for k in path}
        check(np.array_equal(sel.shard_counts,
                             plain_counts(eng, sel, name, labels)),
              "scored corpus: RT counts differ from the plain count")
        sel_idx = np.concatenate([eng.offsets[i] + sel.indices(i)
                                  for i in range(sel.num_shards)])
    n_calls = n_corpus // batch
    for k, n in per_call.items():
        check(launches[k] == n_calls * n,
              f"{k} launched {launches[k]} times for {n_calls} prefills of "
              f"{cfg.name}, expected {n} each")
    check(launches["score_hist"] >= N_SCORE_SHARDS
          and launches["threshold_select"] >= N_SCORE_SHARDS,
          f"engine kernels did not launch on the scored corpus: {launches}")
    truth = labels > 0.5
    mfu = model_flops(cfg, n_corpus, SEQ_LEN) / t_score / BF16_OPS_PER_S
    quantiles = torch.quantile(scores.double(), torch.tensor(
        [0.01, 0.5, 0.99], dtype=torch.float64, device=DEVICE)).tolist()
    print(f"{cfg.name} scored {n_corpus} records x {SEQ_LEN} tokens in "
          f"{t_score:.3f} s: {n_corpus / t_score:.1f} records/s, "
          f"{n_corpus * SEQ_LEN / t_score:.1f} tokens/s, mfu {mfu:.4f}; "
          f"scores in [{float(scores.min()):.4g}, {float(scores.max()):.4g}]"
          f", quantiles 1/50/99% "
          f"{', '.join(f'{x:.4g}' for x in quantiles)}")
    recall = queries.recall_of(sel_idx, truth)
    print(f"RT over the scores: build {t_build:.4f} s, query {t_query:.4f} s,"
          f" tau {sel.tau:.6g}, selected {sel.total_selected} of {n_corpus}"
          f" ({int(truth.sum())} positive), oracle calls {sel.oracle_calls},"
          f" recall {recall:.4f}, precision "
          f"{queries.precision_of(sel_idx, truth):.4f}")
    if result is not None:
        result.update(scores=scores.cpu().numpy(), labels=labels,
                      recall=recall, oracle_calls=sel.oracle_calls)
    print(f"score-then-select path launches: {launches}")
    if "linear_scan" in per_call:
        check_scan_routes(launches["linear_scan"], "scoring",
                          SCAN_ROUTE[cfg.block])
    return launches


def profile_scoring_call(model, cfg, seed: int, groups: dict) -> None:
    """Device time by kernel over one scoring call (torch.profiler), in
    `groups` (a name for each substring of a kernel's name) and matmuls
    and the rest, and the device's busy share of the call's wall time."""
    tokens = rand_tokens(cfg, (SCORE_BATCH, SEQ_LEN), torch.Generator(
        device=DEVICE).manual_seed(seed + 2))
    serve_prefill = make_serve_prefill(cfg)
    serve_prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    profile_call(lambda: serve_prefill(model, {"tokens": tokens}), groups,
                 f"one {cfg.name} scoring call ({SCORE_BATCH} x {SEQ_LEN} "
                 "tokens)")


def profile_call(fn, groups: dict, label: str) -> None:
    """One call of `fn` under torch.profiler: its wall, the device's busy
    share of it, device time in `groups` (a name for each substring of a
    kernel's name), matmuls and the rest, the top kernels and every kernel
    of a group."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in kernels)
    if not kernels:
        print(f"profile of {label}: the profiler recorded no device time")
        return
    by_group = {}
    for name, t, _ in kernels:
        low = name.lower()
        group = next((g for key, g in groups.items() if key in low), None)
        if group is None:
            group = ("matmul" if any(w in low for w in
                                     ("gemm", "cutlass", "xmma", "nvjet"))
                     else "other (elementwise, norms, softmax, copies)")
        by_group[group] = by_group.get(group, 0.0) + t
    print(f"profile of {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.3f} of the wall), "
          f"{sum(n for _, _, n in kernels)} kernels, by group: " + ", ".join(
              f"{g} {t / 1e3:.3f} ms ({t / busy_us:.3f})"
              for g, t in sorted(by_group.items(), key=lambda kv: -kv[1])))
    ranked = sorted(kernels, key=lambda k: -k[1])
    for name, t, n in ranked[:10] + [k for k in ranked[10:] if any(
            key in k[0].lower() for key in groups)]:
        print(f"  {t / 1e3:9.3f} ms  x{n:<4d} {name[:100]}")


# -- phase 8 -------------------------------------------------------------------

SDPA_FUSED = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION")


def fused_sdpa_ms(qt, kt, vt, lower_right: bool = False) -> float:
    """ms of `scaled_dot_product_attention` (causal) on (B,H,S,d) tensors
    by its fastest fused backend: each backend alone (`sdpa_kernel`), its
    time or its refusal printed. With `lower_right` the causal mask is
    aligned bottom-right for Sk > Sq (`causal_lower_right`), as the
    kernel aligns it. The math backend, which materializes the S x S
    scores, is not among them; fails if none runs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.attention.bias import causal_lower_right
    kw = ({"attn_mask": causal_lower_right(qt.shape[2], kt.shape[2])}
          if lower_right else {"is_causal": True})
    times = {}
    for name in SDPA_FUSED:
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                times[name] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, **kw), 20)
        except RuntimeError as e:          # this backend takes no such input
            print(f"  scaled_dot_product_attention {name}: refused "
                  f"({str(e).strip().splitlines()[0][:120]})")
    check(bool(times), "no fused scaled_dot_product_attention backend ran")
    best = min(times, key=times.get)
    print("  scaled_dot_product_attention by backend: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
          + f"; library_ms is {best}'s")
    return times[best]


def flash_row(shape, seed: int, plain_fn=plain_attention) -> dict:
    """flash_attention's times at `shape` ((B, S, H, KV, dh) or with dv
    after dh), bf16 causal, with its bound, `plain_fn`'s time and SDPA's
    by its fastest fused backend."""
    b, s, h, kv, dh = shape[:5]
    q, k, v = attention_inputs(shape, torch.bfloat16,
                               torch.Generator(device=DEVICE)
                               .manual_seed(seed + 13))
    dv = v.shape[3]
    group = h // kv
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in
                  (q, k.repeat_interleave(group, dim=2),
                   v.repeat_interleave(group, dim=2)))
    ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v), 20)
    plain_ms = cuda_ms(lambda: plain_fn(q, k, v), 3)
    lib_ms = fused_sdpa_ms(qt, kt, vt)
    ops = b * h * s * s * (dh + dv)    # q·kᵀ and p·v over S²/2 causal pairs
    moved = 2 * (q.numel() + k.numel() + v.numel() + b * s * h * dv)
    t_ops = ops / BF16_OPS_PER_S * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes \
        else (t_bytes, "bytes")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def lse_store_ms(shape, seed: int) -> None:
    """The forward's device time at `shape`, bf16 causal, storing o alone
    (what scoring and prefill run) and o with its lse (what a training
    forward runs), timed in turns: o, o + lse, o + lse, o."""
    q, k, v = attention_inputs(shape, torch.bfloat16,
                               torch.Generator(device=DEVICE)
                               .manual_seed(seed + 13))
    o_only, with_lse = [], []
    for run in (o_only, with_lse, with_lse, o_only):
        fn = (fa_ops.flash_attention if run is o_only
              else fa_ops.flash_attention_fwd)
        run.append(device_ms(lambda: fn(q, k, v), 20))
    print(f"flash_attention at {shape}, device time: o alone {o_only[0]:.4f}, "
          f"{o_only[1]:.4f} ms; o and lse {with_lse[0]:.4f}, "
          f"{with_lse[1]:.4f} ms (the lse store "
          f"{(sum(with_lse) - sum(o_only)) / 2:+.4f} ms)")


# -- phase 9 -------------------------------------------------------------------

def scan_inputs(shape, g, *, layout="mamba", bonus=False, w_const=None,
                tiny_early=False, qk_dtype=torch.bfloat16):
    """linear_scan's inputs on the card. ``mamba``: Zamba2's layout and
    law, as `mamba_block` hands them over: B and C (B,S,N) normal in
    `qk_dtype`, shared by the heads as stride-0 views; dt =
    softplus(normal · 0.88) per (b, s, head) (x · W at W's 1/sqrt(d) init
    after an RMSNorm), the decay w = exp(-dt) (A = -1) as a stride-0 view
    over N, or `w_const`, or with `tiny_early` 1e-6 in the first 8 steps
    of every 16 and 1 - 1e-3 · uniform after; v = x · dt, a (B,S,H,hd)
    float32 tensor seen as (B,H,S,hd). ``plain``: the reference test's
    law, contiguous float32: q, k, v normal at scale 0.5, w =
    sigmoid(normal + 2.5) or `w_const`, and with `bonus` u normal at scale
    0.3."""
    b, h, s, dk, dv = shape

    def normal(*size):
        return torch.randn(*size, generator=g, device=DEVICE)
    if layout == "mamba":
        bc = normal(b, s, 2 * dk).to(qk_dtype)
        dt = F.softplus(normal(b, s, h) * 0.88)
        a = torch.exp(-dt) if w_const is None else torch.full_like(dt,
                                                                   w_const)
        if tiny_early:
            near_one = 1 - 1e-3 * torch.rand(b, s, h, generator=g,
                                             device=DEVICE)
            early = (torch.arange(s, device=DEVICE) % 16 < 8)[None, :, None]
            a = torch.where(early, torch.full_like(a, 1e-6), near_one)
        v = (normal(b, s, h, dv) * dt[..., None]).transpose(1, 2)
        return (bc[..., dk:][:, None].expand(b, h, s, dk),
                bc[..., :dk][:, None].expand(b, h, s, dk), v,
                a.transpose(1, 2)[..., None].expand(b, h, s, dk), None)
    q, k = normal(b, h, s, dk) * 0.5, normal(b, h, s, dk) * 0.5
    w = (torch.sigmoid(normal(b, h, s, dk) + 2.5) if w_const is None
         else torch.full((b, h, s, dk), w_const, device=DEVICE))
    u = normal(h, dk) * 0.3 if bonus else None
    return q, k, normal(b, h, s, dv) * 0.5, w, u


def check_scan(seed: int) -> float:
    """Phase 9: linear_scan against its plain version; returns the largest
    |kernel - plain| of o at the prefill shape. A case with ``bf16_v``
    hands the kernel bf16 v (o comes back in bf16) and is held to the
    plain recurrence in float64 within one bf16 ulp of its o plus
    SCAN_REL of its largest |o|; the others as the note at SCAN_REL
    says."""
    g = torch.Generator(device=DEVICE).manual_seed(seed + 17)
    rwkv = dict(layout="rwkv", bonus=True, bf16_v=True)
    cases = [("zamba2 prefill", LS_PREFILL, {}),
             ("zamba2 scoring", LS_SCORING, {}),
             ("rwkv6 mode", (2, 64, 1024, 64, 64),
              dict(layout="plain", bonus=True)),
             ("rwkv6 prefill, bf16 v", LS_RWKV, rwkv),
             ("rwkv6 layout, bf16 v, ragged S", (2, 16, 1000, 64, 64), rwkv),
             ("rwkv6 layout, bf16 v, S = 1", (3, 16, 1, 64, 64), rwkv),
             ("reference shape", (2, 2, 128, 16, 24), dict(layout="plain")),
             ("reference shape", (2, 2, 128, 16, 24),
              dict(layout="plain", bonus=True)),
             ("reference shape, bf16 v", (2, 2, 128, 16, 24),
              dict(layout="plain", bonus=True, bf16_v=True)),
             ("33 x 40, bf16 v", (3, 2, 77, 33, 40),
              dict(layout="plain", bonus=True, bf16_v=True)),
             ("ragged S", (2, 16, 1000, 64, 64), {}),
             ("ragged S", (2, 16, 1000, 64, 64),
              dict(layout="plain", bonus=True)),
             ("S = 1", (3, 16, 1, 64, 64), {}),
             ("S = 1", (3, 16, 1, 64, 64), dict(layout="plain", bonus=True)),
             ("w = 0.05", (2, 16, 512, 64, 64), dict(w_const=0.05)),
             ("w = 0.05", (2, 16, 512, 64, 64),
              dict(layout="plain", bonus=True, w_const=0.05)),
             ("S = c - 1", (2, 16, 63, 64, 64), {}),
             ("S = c", (2, 16, 64, 64, 64), {}),
             ("S = c + 1", (2, 16, 65, 64, 64), {}),
             ("w = 1e-6 early in each chunk, near 1 after",
              (2, 16, 512, 64, 64), dict(tiny_early=True)),
             ("w = 1", (2, 16, 4096, 64, 64), dict(w_const=1.0)),
             ("w = 1", (2, 16, 4096, 64, 64),
              dict(layout="plain", bonus=True, w_const=1.0)),
             ("float32 q and k", (2, 16, 1000, 64, 64),
              dict(qk_dtype=torch.float32))]
    err_prefill = 0.0
    worst = {"chunked": 0.0, "channel": 0.0, "channel bf16 v": 0.0}
    for label, shape, kw in cases:
        kw = dict(kw)
        bf16_v = kw.pop("bf16_v", False)
        if kw.get("layout") == "rwkv":
            q, k, v, w, u = rwkv_scan_inputs(shape, g)
        else:
            q, k, v, w, u = scan_inputs(shape, g, **kw)
            v = v.to(torch.bfloat16) if bf16_v else v
        route = ls_ops.route(q, k, v, w, u)
        reset_counts(("linear_scan",))
        got = ls_ops.linear_scan(q, k, v, w, u)
        again = ls_ops.linear_scan(q, k, v, w, u)
        check(scan_routes()[route] == 2 == ls_ops.launches.count,
              f"linear_scan {label}: launches by route {scan_routes()}, "
              f"expected 2 {route}")
        plain = ls_ref.linear_scan_ref(q, k, v, w, u)
        long = shape[2] >= 1024 or bf16_v
        # bf16 v: the arbiter's o in float64, not rounded to v's dtype
        arbiter = ls_ref.linear_scan_ref(
            q, k, v.double() if bf16_v else v, w, u,
            compute_dtype=torch.float64) if long else plain
        torch.cuda.synchronize()
        what = (f"linear_scan {label} {shape} "
                f"{'rwkv6 (u)' if u is not None else 'mamba2'} "
                f"{kw.get('layout', 'mamba')} layout, {route} kernel")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{what}: repeat launches differ")
        parts = []
        for part, kern, pl, arb in zip(("o", "state"), got, plain, arbiter):
            diff = (kern.double() - arb.double()).abs()
            err = float(diff.max())
            scale = float(arb.abs().max())
            if bf16_v and part == "o":
                # one bf16 ulp of each output besides SCAN_REL of the largest
                ulp = torch.pow(2.0, torch.floor(torch.log2(
                    arb.abs().clamp_min(1e-30))) - 7)
                excess = float((diff - ulp).max())
                bar = SCAN_REL * scale
                ok, reading = excess <= bar, excess
            else:
                bar = SCAN_REF_ATOL if shape[3] < 64 else SCAN_REL * scale
                ok, reading = err <= bar, err
            check(bool(torch.isfinite(kern).all()) and ok,
                  f"{what}: {part} differs from the "
                  f"{'float64 ' if long else ''}plain version by {reading:.4g}"
                  f" (bar {bar:.4g})")
            if shape[3] == 64:
                key = route + (" bf16 v" if bf16_v else "")
                worst[key] = max(worst[key], reading / scale)
            line = (f"{part}: max |kernel - plain| "
                    f"{float((kern.double() - pl.double()).abs().max()):.4g}")
            if long:
                line += (f", |kernel - float64| {err:.4g}, |plain - float64|"
                         f" {float((pl.double() - arb).abs().max()):.4g}")
            if bf16_v and part == "o":
                line += f", |kernel - float64| less one bf16 ulp {reading:.4g}"
            parts.append(f"{line}, largest |{part}| {scale:.4g}, bar "
                         f"{bar:.4g}")
        print(f"{what}: {'; '.join(parts)}; repeat bitwise")
        if shape == LS_PREFILL:
            err_prefill = float((got[0] - plain[0]).abs().max())
        del q, k, v, w, got, again, plain, arbiter
    print("linear_scan's largest readings at dk = dv = 64, as shares of the "
          "largest |output| (bar SCAN_REL " + f"{SCAN_REL}): "
          + ", ".join(f"{k} {v:.4g}" for k, v in worst.items()))
    return err_prefill


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a (possibly broadcast) view reads."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st) \
        * t.element_size()


SCAN_CHUNK = 64       # steps a chunk of the chunked kernel
CHANNEL_CHUNK = 16    # steps a chunk of the channel kernel


def chunked_ms(b, h, s, dk, dv, qk_bf16: bool) -> float:
    """Least tensor-core time of the chunked form: per chunk of n steps,
    (G ∘ L) X over its n(n+1)/2 causal pairs, C S_prev and Bᵀ (dout X)
    over its n steps, each 2 operations a multiply-add, in TF32 times the
    split's products (3 for (G ∘ L) X; 2 for the other two with bf16 q
    and k, 3 with float32); G = C Bᵀ over the causal pairs in bf16 (or
    TF32 with 3 products for float32 q and k)."""
    full, last = divmod(s, SCAN_CHUNK)
    pairs = full * SCAN_CHUNK * (SCAN_CHUNK + 1) // 2 + last * (last + 1) // 2
    qk_split = 2 if qk_bf16 else 3
    tf32 = 3 * 2 * pairs * dv + 2 * qk_split * 2 * s * dk * dv
    g = 2 * pairs * dk
    if qk_bf16:
        return b * h * (tf32 / TF32_OPS_PER_S + g / BF16_OPS_PER_S) * 1e3
    return b * h * (tf32 + 3 * g) / TF32_OPS_PER_S * 1e3


def channel_ms(b, h, s, dk, dv, v_bf16: bool) -> float:
    """Least time of the channel kernel's operations: per chunk of n
    steps, (q ⊙ pre) S over its n steps (after the first chunk) and
    (k ⊙ suf)ᵀ v, 2 operations a multiply-add, in TF32 times the split's
    products (3 for the first; 2 for the second with bf16 v, 3 with
    float32), M v over its n(n+1)/2 causal pairs likewise; on the CUDA
    cores in float32, M over its n(n-1)/2 pairs below the diagonal (a
    multiply-add and a running product a channel) and its diagonal, and
    the running products pre, suf and the products q ⊙ pre, k ⊙ suf
    (4 a step and channel)."""
    full, last = divmod(s, CHANNEL_CHUNK)
    pairs = full * CHANNEL_CHUNK * (CHANNEL_CHUNK + 1) // 2 \
        + last * (last + 1) // 2
    below = pairs - s
    v_split = 2 if v_bf16 else 3
    inter = max(s - CHANNEL_CHUNK, 0)
    tf32 = 2 * dk * dv * (3 * inter + v_split * s) + 2 * v_split * pairs * dv
    fp32 = 3 * below * dk + 2 * s * dk + 4 * s * dk
    return b * h * (tf32 / TF32_OPS_PER_S + fp32 / FP32_OPS_PER_S) * 1e3


def scan_row(shape, seed: int) -> dict:
    """linear_scan's times at `shape` in Zamba2's layout: the chunked
    kernel (Mamba2's route) and the channel kernel on the same inputs with
    w materialized (its route), in turns; with the bound: the larger of
    the bytes (each distinct input element read once, o and the float32
    state written once) over the HBM rate and the least operation time
    over the two forms (`chunked_ms`, `channel_ms`). Prints each term and
    the channel kernel's time, which includes reading the materialized w
    that Mamba2's route never reads (its bytes at the HBM rate are printed
    beside it)."""
    b, h, s, dk, dv = shape
    q, k, v, w, _ = scan_inputs(shape, torch.Generator(device=DEVICE)
                                .manual_seed(seed + 19))
    w_dense = w.contiguous()
    check(ls_ops.route(q, k, v, w) == "chunked"
          and ls_ops.route(q, k, v, w_dense) == "channel",
          f"linear_scan routes at {shape}")
    chunked = [cuda_ms(lambda: ls_ops.linear_scan(q, k, v, w), 20)]
    channel = [cuda_ms(lambda: ls_ops.linear_scan(q, k, v, w_dense), 20)
               for _ in range(2)]
    chunked.append(cuda_ms(lambda: ls_ops.linear_scan(q, k, v, w), 20))
    ms, channel_kernel_ms = sum(chunked) / 2, sum(channel) / 2
    plain_ms = cuda_ms(lambda: ls_ref.linear_scan_ref(q, k, v, w), 1)
    moved = sum(distinct_bytes(t) for t in (q, k, v, w)) \
        + distinct_bytes(v) + 4 * b * h * dk * dv
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_chunked = chunked_ms(b, h, s, dk, dv, q.dtype == torch.bfloat16)
    t_channel = channel_ms(b, h, s, dk, dv, v.dtype == torch.bfloat16)
    t_ops = min(t_chunked, t_channel)
    b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes \
        else (t_bytes, "bytes")
    print(f"linear_scan at (B, H, S, dk, dv) = {shape}, zamba2 layout: "
          f"chunked kernel {ms:.6g} ms ({chunked[0]:.6g}, {chunked[1]:.6g}),"
          f" channel kernel {channel_kernel_ms:.6g} ms ({channel[0]:.6g}, "
          f"{channel[1]:.6g}), chunked / channel "
          f"{ms / channel_kernel_ms:.3f}; bound {b_ms:.6g} ms ({b_by}): bytes "
          f"{t_bytes:.6g} ms, the chunked form's operations {t_chunked:.6g}"
          f" ms, the channel form's {t_channel:.6g} ms; share of the bound "
          f"reached {b_ms / ms:.3f} (channel kernel "
          f"{b_ms / channel_kernel_ms:.3f}); the channel kernel's time "
          f"includes reading the dense w, {w_dense.numel() * 4 / 1e6:.6g} "
          f"MB, {w_dense.numel() * 4 / HBM_BYTES_PER_S * 1e3:.6g} ms at the "
          f"HBM rate; plain version {plain_ms:.6g} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


# -- phase 4 -------------------------------------------------------------------

def hist_times(chunks, g) -> dict:
    """score_hist per 2^22-record chunk on the Beta corpus (`chunks`),
    uniform and clustered inputs (8 chunks each, cycled): the call (one
    launch with its masses, no read-back), the launch alone as device
    time, the plain versions (the sketch and the masses) and three
    `torch.bincount` calls; prints a line for each input."""
    m = torch.empty(2, dtype=torch.float64, device=chunks[0].device)
    out = {}
    for kind in ("beta", "uniform", "clustered"):
        inputs = [hist_input(kind, c, g) for c in chunks]
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % len(inputs)
            return inputs[it["i"]]

        def plain():
            c = nxt()
            return sh_ref.score_hist_ref(c, 4096), sh_ref.chunk_masses_ref(c)

        def library():
            c = nxt()
            valid = c >= 0
            a = c.clamp(0.0, 1.0)
            ids = torch.clamp_max((a * 4096).long(), 4095)
            v = valid.float()
            return (torch.bincount(ids, weights=v, minlength=4096),
                    torch.bincount(ids, weights=a.sqrt() * v, minlength=4096),
                    torch.bincount(ids, weights=a * v, minlength=4096))

        r = out[kind] = {
            "call_ms": cuda_ms(lambda: sh_ops.score_hist(nxt(), 4096,
                                                         masses=m), 50),
            "device_ms": device_ms(lambda: sh_ops.score_hist(nxt(), 4096,
                                                             masses=m), 50),
            "plain_ms": cuda_ms(plain, 5),
            "bincount_ms": cuda_ms(library, 20)}
        print(f"score_hist at a 2^22 chunk, {kind}: call {r['call_ms']:.6g} "
              f"ms (one launch with its masses, no read-back), the launch "
              f"alone {r['device_ms']:.6g} ms of device time; plain "
              f"{r['plain_ms']:.6g} ms; 3 x torch.bincount "
              f"{r['bincount_ms']:.6g} ms; bound "
              f"{(4 * CHUNK + 3 * 4096 * 4 + 16) / HBM_BYTES_PER_S * 1e3:.6g}"
              " ms")
    return out


def build_times(scores, n_chunks: int) -> None:
    """Engine builds over the phase-3 corpus: one at workers 1 and one at
    8 under the profiler (`profile_build`), each with exactly one
    score_hist launch a chunk and three device-to-host copies (the chunk
    masses' one read-back and the two normalizers); then three unprofiled
    builds at each worker count, host clock ending in a synchronize."""
    shards = list(torch.tensor_split(scores, N_SHARDS))
    for workers in (1, 8):
        prof = profile_build(shards, workers)
        hist = sum(n for name, n in prof["launches"].items()
                   if "hist_chunk" in name)
        check(hist == n_chunks, f"build at workers {workers}: {hist} "
              f"score_hist launches for {n_chunks} chunks")
        check(prof["d2h"] == 3, f"build at workers {workers}: "
              f"{prof['d2h']} device-to-host copies, expected 3")
    for workers in (1, 8):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            SelectionEngine(shards, num_bins=4096, workers=workers,
                            clamp_workers=False, device=DEVICE).close()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"build wall s at workers {workers}: "
              + ", ".join(f"{w:.5f}" for w in walls)
              + " (with a masses pass a chunk: "
              f"{SEPARATE_MASSES_BUILD_S[workers]})")


def kernel_times(flat, tau_rt, g):
    """Per-call times at 2^22-record chunks of the corpus, cycling over 8
    chunks (128 MiB, past the 50 MB L2) so reads come from HBM."""
    chunks = [flat[i * CHUNK:(i + 1) * CHUNK] for i in range(8)]
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(chunks)
        return chunks[it["i"]]

    hist = hist_times(chunks, g)["beta"]
    thr = torch.tensor(ts_ref.threshold32(tau_rt), device=flat.device)
    k = int((chunks[0] >= thr).sum())
    t = {
        "score_hist": (hist["call_ms"], hist["plain_ms"],
                       hist["bincount_ms"]),
        "threshold_select": (
            cuda_ms(lambda: ts_ops.threshold_select(nxt(), tau_rt), 50),
            cuda_ms(lambda: ts_ref.threshold_select_ref(nxt(), tau_rt), 50),
            cuda_ms(lambda: torch.nonzero(nxt() >= thr), 50)),
    }
    byts = {"score_hist": 4 * CHUNK + 3 * 4096 * 4 + 16,
            "threshold_select": 4 * CHUNK + 8 * k}
    # threshold_select's one launch alone, with no read-back, and
    # threshold_count's memset and launch, both as device time.
    alone = {"kernel_ms": device_ms(
                 lambda: ts_ops._launch(nxt(), tau_rt, count_only=False), 50),
             "count_ms": device_ms(
                 lambda: ts_ops.threshold_count(nxt(), tau_rt), 50),
             "count_call_ms": cuda_ms(
                 lambda: int(ts_ops.threshold_count(nxt(), tau_rt)), 50)}
    print(f"threshold_select at a 2^22 chunk (k = {k} selected): call "
          f"{t['threshold_select'][0]:.6g} ms (one launch, one read-back), "
          f"its launch alone {alone['kernel_ms']:.6g} ms of device time; "
          f"threshold_count {alone['count_ms']:.6g} ms of device time, "
          f"{alone['count_call_ms']:.6g} ms with its read-back; "
          f"torch.nonzero(s >= tau) {t['threshold_select'][2]:.6g} ms; "
          f"bound {byts['threshold_select'] / HBM_BYTES_PER_S * 1e3:.6g} ms")
    return t, byts


def _build_steps():
    """(label, owner, attribute) of each step of an engine build that
    `profile_build` times on the host, where the owner has it."""
    return [("_residency", engine_mod, "_residency"),
            ("chunk pass (_sketch_shards)", SelectionEngine,
             "_sketch_shards"),
            ("per-chunk unit", binned, "chunk_sketch_into"),
            ("score_hist call", sh_ops, "score_hist"),
            ("merge_sketches", binned, "merge_sketches"),
            ("weight_normalizers", binned, "weight_normalizers"),
            ("_sampling_state", SelectionEngine, "_sampling_state")]


def profile_build(shards, workers: int) -> dict:
    """One engine build over `shards` at `workers` under torch.profiler,
    with host timers on its steps (`_build_steps`: summed over threads, so
    at workers > 1 the per-chunk steps overlap). Prints the build's wall,
    each step's host time and calls, the device time by kernel, the
    device-to-host copies and the device's busy share; returns the wall
    (s) and the kernel launches by name."""
    spent, lock = {}, threading.Lock()

    def timed(label, fn):
        @functools.wraps(fn)
        def inner(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    s, n = spent.get(label, (0.0, 0))
                    spent[label] = (s + time.perf_counter() - t0, n + 1)
        return inner

    patches = [mock.patch.object(owner, attr, timed(label,
                                                    getattr(owner, attr)))
               for label, owner, attr in _build_steps()
               if hasattr(owner, attr)]
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        prof = stack.enter_context(torch.profiler.profile(
            activities=activities))
        t0 = time.perf_counter()
        eng = SelectionEngine(shards, num_bins=4096, workers=workers,
                              clamp_workers=False, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.close()
    events = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total, e.count) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in kernels)
    d2h = sum(e.count for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "DtoH" in e.key)
    print(f"build at workers {workers} under the profiler: wall "
          f"{wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / 1e6 / wall:.3f} of the wall), {d2h} device-to-host "
          "copies; host time by step (summed over threads, calls):")
    for label, (s, n) in sorted(spent.items(), key=lambda kv: -kv[1][0]):
        print(f"  {s * 1e3:9.3f} ms  x{n:<4d} {label}")
    print("  device time by kernel:")
    for name, t, n in sorted(kernels, key=lambda k: -k[1])[:12]:
        print(f"  {t / 1e3:9.3f} ms  x{n:<4d} {name[:100]}")
    return {"wall_s": wall, "d2h": d2h,
            "launches": {name: n for name, _, n in kernels}}


# -- phase 13 ------------------------------------------------------------------

# A gamma two-stage PT certifies over Beta(0.01, 1) at budget 3000 (at 0.9
# it usually certifies none: PERF.md §7; 0.8 certified in each of six keys
# over 2^23 such records on the CPU).
PT_SESSION_GAMMA = 0.8
SESSION_BATCH = (
    [("RT", SUPGQuery(target="recall", gamma=0.9, delta=0.05,
                      budget=3000))] * 3
    + [("PT", SUPGQuery(target="precision", gamma=PT_SESSION_GAMMA,
                        delta=0.05, budget=3000, two_stage=True))] * 2
    + [("JT", JointSUPGQuery(gamma_recall=0.8, stage_budget=3000))])
SESSION_SHARDS = 12      # the engine's corpus before the appends
SENTINEL_SHARDS = 4      # the sentinel's corpus before its append
DRIFT_SHARDS = 12        # Beta(0.01, 2) shards the sentinel sees appended


def many_with_stats(eng, key, oracle, concurrency):
    """`run_many` over `SESSION_BATCH`; (results, its session's stats,
    threshold_select launches, wall s)."""
    sessions = []
    opened = eng.session

    def spy(*a, **kw):
        sess = opened(*a, **kw)
        sessions.append(sess)
        return sess

    eng.session = spy     # the instance's, to read run_many's session
    ts_ops.launches.reset()
    t0 = time.perf_counter()
    try:
        out = eng.run_many(key, oracle, [q for _, q in SESSION_BATCH],
                           concurrency=concurrency)
        torch.cuda.synchronize()
    finally:
        del eng.session
    return out, sessions[0].stats, ts_ops.launches.count, \
        time.perf_counter() - t0


def check_state_bitwise(a, b, what: str) -> None:
    """Two corpus states hold the same sketches, z, chunk masses and
    chunk-mass CDFs, bit for bit."""
    check(a.z == b.z, f"{what}: z {a.z} != {b.z}")
    for x, y in zip(a.shard_sketches + [a.sketch],
                    b.shard_sketches + [b.sketch]):
        check(all(torch.equal(u, v) for u, v in zip(x, y)),
              f"{what}: a sketch differs")
    for x, y in zip(a.chunk_masses, b.chunk_masses):
        check(all(np.array_equal(u, v) for u, v in zip(x, y)),
              f"{what}: chunk masses differ")
    for k in b.sampling_cache:
        for x, y in zip(a.sampling_cache[k], b.sampling_cache[k]):
            check(x.mass == y.mass and np.array_equal(x.cdf, y.cdf),
                  f"{what}: a chunk-mass CDF differs")


def drift_audit(shards, appended, labels, seed) -> "live.DriftReport":
    """A fresh engine over `shards`, a `DriftSentinel` watch (probe 4096,
    sigma 4) on an RT query, `appended` appended, then one audit."""
    q = SESSION_BATCH[0][1]
    with SelectionEngine(shards, num_bins=4096, device=DEVICE) as eng:
        sent = live.DriftSentinel(eng, array_oracle(labels),
                                  probe_budget=4096, sigma=4.0)
        watch = sent.watch(q, key=R.PRNGKey(seed + 21))
        live.IngestPlane(eng).append(appended)
        return sent.audit(watch, key=R.PRNGKey(seed + 22))


def live_phase(scores, labels, seed, card: str) -> dict:
    """Phase 13: sessions and the live plane at real size. Returns the
    launches of the phase's main path and its walls."""
    shards = list(torch.tensor_split(scores, N_SHARDS))
    oracle = array_oracle(labels)
    key = R.PRNGKey(seed + 13)
    keys = R.split(key, len(SESSION_BATCH))
    walls = {}
    print(f"sessions over {SESSION_SHARDS} shards of {shards[0].numel()}: "
          f"3 RT, 2 two-stage PT at gamma {PT_SESSION_GAMMA}, 1 JT "
          "(budget 3000 each)")

    # 1. sessions: sequential at w1, run_many at c1/None on w8, c2 on w1
    eng = SelectionEngine(shards[:SESSION_SHARDS], num_bins=4096,
                          workers=1, device=DEVICE)
    ts_ops.launches.reset()
    t0 = time.perf_counter()
    seq = [run_query(eng, k, oracle, name, q)[0]
           for k, (name, q) in zip(keys, SESSION_BATCH)]
    walls["sequential_w1"] = time.perf_counter() - t0
    seq_launches = ts_ops.launches.count
    print(f"sequential run/run_joint at workers 1: wall "
          f"{walls['sequential_w1']:.4f} s, threshold_select launches "
          f"{seq_launches} ({card})")
    with SelectionEngine(shards[:SESSION_SHARDS], num_bins=4096, workers=8,
                         clamp_workers=False, device=DEVICE) as w8:
        check_state_bitwise(w8._state, eng._state,
                            "build at workers 8 vs 1")
        runs = [("w8 concurrency 1", w8, 1), ("w8 concurrency None", w8,
                                              None),
                ("w1 concurrency 2", eng, 2)]
        for label, e, c in runs:
            got, stats, n_ts, wall = many_with_stats(e, key, oracle, c)
            walls[label] = wall
            for (name, _), a, b in zip(SESSION_BATCH, seq, got):
                check(same(a, b), f"run_many {label}: {name} differs from "
                      "the sequential run")
            print(f"run_many {label}: wall {wall:.4f} s, SessionStats "
                  f"rounds {stats.rounds}, drains {stats.drains}, "
                  f"fused_walks {stats.fused_walks}, walk_spans "
                  f"{stats.walk_spans}, fused_spans {stats.fused_spans}; "
                  f"threshold_select launches {n_ts} ({card})")
    for (name, _), sel in zip(SESSION_BATCH, seq):
        print(f"  {name}: tau {sel.tau:.6g}, selected {sel.total_selected}, "
              f"oracle calls {sel.oracle_calls}")
    check(np.isfinite(seq[3].tau), f"PT at gamma {PT_SESSION_GAMMA} "
          "certified no threshold")

    # 2. the live plane, counted from here to the end of the phase
    reset_counts(("score_hist", "threshold_select"))
    plane = live.IngestPlane(eng)
    emitted = []
    sink = pipeline.CallbackSink(lambda sid, idx, folded: emitted.append(
        (sid, np.asarray(idx).copy())))
    rt = SESSION_BATCH[0][1]
    with eng.session(oracle) as sess:
        reg = live.StandingRegistry(plane, sess)
        sq = reg.register(rt, key=R.PRNGKey(seed + 14), sink=sink)
        reg.settle()
        tau_sq = sq.wait_certified(timeout=0)
        emitted.clear()                          # keep the catch-ups only
        pinned = eng.pin()
        h = sess.submit(rt, key=keys[0], state=pinned)
        sess.step()                              # the plan pins epoch 0
        hist0 = sh_ops.launches.count
        appends = []
        for part in (shards[12:14], shards[14:16]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plane.append(part)
            torch.cuda.synchronize()
            appends.append(time.perf_counter() - t0)
        hist_appended = sh_ops.launches.count - hist0
        check(same(h.result(), seq[0]), "the RT pinned at epoch 0 differs "
              "from its sequential result after two appends")
        chunks_appended = sum(-(-s.numel() // CHUNK) for s in shards[12:])
        check(hist_appended == chunks_appended,
              f"two appends launched score_hist {hist_appended} times for "
              f"{chunks_appended} appended chunks")
        ts0 = ts_ops.launches.count
        started = reg.pump()
        reg.settle()
        catchup = ts_ops.launches.count - ts0
        check(started == 1 and (sq.emissions, sq.epoch) == (1, 2),
              f"standing RT: {started} catch-ups started, "
              f"{sq.emissions} emissions, epoch {sq.epoch}")
        check(catchup == chunks_appended,
              f"the catch-up launched threshold_select {catchup} times for "
              f"{chunks_appended} appended chunks")
    walls["appends"] = appends
    thr = torch.tensor(ts_ref.threshold32(tau_sq), device=scores.device)
    for sh in range(N_SHARDS):
        mine = [idx for sid, idx in emitted if sid == sh]
        got = np.sort(np.concatenate(mine)) if mine else np.empty(0)
        want = (eng.offsets[sh] + torch.nonzero(eng.shards[sh] >= thr)
                .flatten().cpu().numpy()      # the sink gets global ids
                if sh >= SESSION_SHARDS else np.empty(0))
        check(np.array_equal(got, want), f"standing RT's catch-up on shard "
              f"{sh} differs from a plain count on the card")
    print(f"appends of 2 shards ({2 * shards[0].numel()} records) each: "
          f"wall {', '.join(f'{w:.4f}' for w in appends)} s, score_hist "
          f"launches {hist_appended} for {chunks_appended} appended chunks "
          f"({card})")
    print(f"standing RT (tau {tau_sq:.6g}, certified at epoch 0): one "
          f"catch-up over shards 12-15, {sq.records_reemitted} records, "
          f"threshold_select launches {catchup} for {chunks_appended} "
          "appended chunks; its sink equals a plain count per shard")

    # an engine after the appends == a cold build over the 16 shards
    with SelectionEngine(shards, num_bins=4096, workers=1,
                         device=DEVICE) as cold:
        check_state_bitwise(eng._state, cold._state,
                            "after two appends vs a cold build")
        for k, (name, q) in zip(keys, (SESSION_BATCH[0], SESSION_BATCH[3],
                                       SESSION_BATCH[5])):
            check(same(run_query(eng, k, oracle, name, q)[0],
                       run_query(cold, k, oracle, name, q)[0]),
                  f"{name} after two appends differs from a cold build")
    print("after two appends: sketch, z, chunk masses, CDFs and RT/PT/JT "
          "bit for bit a cold build over the 16 shards")

    # superseded epochs: 1 unpinned, 0 pinned above; each gc frees its own
    for st in (None, pinned):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        if st is not None:
            eng.unpin(st)
            own = st.flat.numel() * 4 + 3 * 4 * eng.num_bins
        else:
            dead = [s for s in eng._superseded if s.pins == 0]
            own = sum(s.flat.numel() * 4 + 3 * 4 * eng.num_bins
                      for s in dead)
            del dead
        freed = eng.gc_epochs()
        torch.cuda.synchronize()
        drop = before - torch.cuda.memory_allocated()
        check(freed == 1 and drop >= own,
              f"gc_epochs freed {freed} epochs, memory_allocated fell "
              f"{drop} bytes, their own {own}")
        print(f"gc_epochs: freed {freed} epoch, memory_allocated fell "
              f"{drop} bytes (its own flat and sketch: {own})")
    del pinned, st
    check(eng.epochs_live == 1 and eng.epochs_freed == 2,
          f"epochs live {eng.epochs_live}, freed {eng.epochs_freed}")
    eng.close()

    # drift sentinel: Beta(0.01, 2) appended trips it, same law does not
    n_drift = DRIFT_SHARDS * shards[0].numel()
    (_, _), (shift, shift_labels) = make_drift_pair_on_device(
        n_drift, seed=seed, device=DEVICE)
    base = SENTINEL_SHARDS * shards[0].numel()
    drift = drift_audit(shards[:SENTINEL_SHARDS],
                        list(shift.tensor_split(DRIFT_SHARDS)),
                        np.concatenate([labels[:base], shift_labels]), seed)
    control = drift_audit(shards[:SENTINEL_SHARDS],
                          shards[SENTINEL_SHARDS:], labels, seed)
    for name, rep, want in (("drift", drift, True),
                            ("control", control, False)):
        print(f"sentinel, {name}: ref rate {rep.ref_rate:.6g}, rate "
              f"{rep.rate:.6g}, z {rep.z:.4f} (sigma 4), drifted "
              f"{rep.drifted}, re-validated {rep.revalidated}")
        check(rep.drifted is want and rep.revalidated is want
              and rep.epoch == 1, f"sentinel on the {name} append: "
              f"drifted {rep.drifted}, z {rep.z}")
    launches = {"score_hist": sh_ops.launches.count,
                "threshold_select": ts_ops.launches.count}
    check(all(n > 0 for n in launches.values()),
          f"phase 13's path launched {launches}")
    print(f"phase 13 live-plane launches: {launches}")
    return {"launches": launches, "walls": walls, "seq": seq,
            "seq_select_launches": seq_launches}


# -- phase 14 ------------------------------------------------------------------

SERVE_CLIENTS = 8        # client threads submitting to the server
SERVE_QUOTA = 10_000     # the metered tenant's label quota (its 3 queries)
PROBE = 4096             # the audited standing RT's sentinel probe
APPEND_SPLIT = (("copy", "device-to-host copy"),
                ("serialize", "np.save into memory"),
                ("crc", "CRC32"),
                ("spool", "spool write + fsync"),
                ("journal", "journal record + fsync"))


@contextlib.contextmanager
def timing_spies(targets):
    """Wrap each (owner, attribute, label) so that every call adds its
    seconds to ``spent[label]``; yields `spent`."""
    spent = dict.fromkeys((label for _, _, label in targets), 0.0)
    with contextlib.ExitStack() as stack:
        for owner, attr, label in targets:
            def wrapped(*a, _fn=getattr(owner, attr), _label=label, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    spent[_label] += time.perf_counter() - t0
            stack.enter_context(mock.patch.object(owner, attr, wrapped))
        yield spent


def served_batch(shards, labels, seq, seq_launches, keys, card) -> None:
    """Step 1: the session batch through a `SelectionServer` from a pool of
    client threads, against phase 13's sequential results."""
    eng = SelectionEngine(shards[:SESSION_SHARDS], num_bins=4096,
                          workers=1, device=DEVICE)
    tenants = ["metered" if i % 2 == 0 else "open"
               for i in range(len(SESSION_BATCH))]
    ts_ops.launches.reset()
    t0 = time.perf_counter()
    with SelectionServer(eng, array_oracle(labels), max_inflight=8,
                         quotas={"metered": SERVE_QUOTA}) as server:
        with concurrent.futures.ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            out = list(pool.map(
                lambda job: server.submit(job[0][1], tenant=job[1],
                                          key=job[2]).result(timeout=600),
                zip(SESSION_BATCH, tenants, keys)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = server.stats()
    launches = ts_ops.launches.count
    for (name, _), a, b in zip(SESSION_BATCH, seq, out):
        check(same(a, b), f"served {name} differs from its sequential run")
        check(b.oracle_calls <= a.oracle_calls,
              f"served {name} charged {b.oracle_calls} labels, alone "
              f"{a.oracle_calls}")
    charged = sum(b.oracle_calls for b in out)
    check(charged == stats.records_labeled,
          f"served queries charged {charged} labels, the channel labeled "
          f"{stats.records_labeled}")
    check(stats.completed == len(SESSION_BATCH) and stats.failed == 0,
          f"server completed {stats.completed}, failed {stats.failed}")
    check(launches == seq_launches, f"served batch launched "
          f"threshold_select {launches} times, in sequence {seq_launches}")
    print(f"served batch ({SERVE_CLIENTS} client threads, tenants "
          f"'metered' (quota {SERVE_QUOTA}) and 'open'): tau, counts and "
          f"indices equal phase 13's sequential results; wall {wall:.4f} s, "
          f"p50 {stats.p50_s:.4f} s, p99 {stats.p99_s:.4f} s, "
          f"threshold_select launches {launches} (in sequence "
          f"{seq_launches}) ({card})")
    print("  oracle_calls served / alone: " + ", ".join(
        f"{name} {b.oracle_calls}/{a.oracle_calls}"
        for (name, _), a, b in zip(SESSION_BATCH, seq, out))
        + f"; served sum {charged} == records labeled "
        f"{stats.records_labeled}")
    print("  " + stats.format().replace("\n", "\n  "))


def quiescent(srv, epoch: int, timeout: float = 300.0) -> None:
    """Wait until every standing query has caught up to `epoch`, every
    sentinel watch has audited it, and nothing is pending."""
    deadline = time.monotonic() + timeout
    while True:
        check(srv._fatal is None, f"server scheduler died: {srv._fatal!r}")
        sqs = srv._registry.standing
        if all(sq.epoch >= epoch and not sq._busy for sq in sqs) \
                and all(w[3] >= epoch for w in srv._watches) \
                and not srv._registry.has_pending():
            return
        check(time.monotonic() < deadline,
              f"standing catch-up to epoch {epoch} stalled")
        time.sleep(0.005)


def served_state(srv, root: pathlib.Path, tag: str) -> dict:
    """What a restore must reproduce: taus, sink bytes, the tenant's
    charge, and each watch's base key and last audited epoch."""
    sqs = srv._registry.standing
    for sq in sqs:
        check(sq.last_error is None and sq.reemit_failures == 0,
              f"{tag}: a standing query failed: {sq.last_error!r}")
    return {"taus": [sq.tau for sq in sqs],
            "sinks": [np.fromfile(sq.sink.path, np.uint8) for sq in sqs],
            "charged": srv.stats().tenants["t"].oracle_charged,
            "watches": [(w[2].tolist(), w[3]) for w in srv._watches]}


def durable_run(shards, labels, root: pathlib.Path, seed: int, tag: str,
                crash_at: Optional[dict], card: str):
    """Steps 2 and 3's server: a standing RT and an audited standing RT
    over the first 12 shards, certified and snapshotted, then shards
    12-13 and 14-15 appended through the journal. With `crash_at` a
    `CrashInjector` kills an append; returns (server, its state or None,
    the injector)."""
    eng = SelectionEngine(shards[:SESSION_SHARDS], num_bins=4096,
                          workers=1, device=DEVICE)
    srv = SelectionServer(eng, array_oracle(labels),
                          durable=root / f"{tag}_durable",
                          quotas={"t": 10**7}, sentinel_probe_budget=PROBE,
                          sentinel_sigma=4.0)
    rt = SESSION_BATCH[0][1]
    for j, audit in enumerate((False, True)):
        # one after the other: the audited RT's reference probe labels
        # nothing a certification still needs, so the tenant's charge
        # does not depend on the schedule
        sq = srv.subscribe(rt, tenant="t", key=R.PRNGKey(seed + 31 + j),
                           sink=pipeline.BitmaskStore(
                               root / f"{tag}_{j}.bits"), audit=audit)
        sq.wait_certified(timeout=300)
    deadline = time.monotonic() + 300
    while not srv._watches:        # the scheduler attaches the watch
        check(time.monotonic() < deadline, f"{tag}: no sentinel watch")
        time.sleep(0.005)
    quiescent(srv, 0)
    srv.snapshot()
    inj = testing.CrashInjector(crash_at or {})
    with inj:
        for part in (shards[12:14], shards[14:16]):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            spies = [(recovery, "_to_host", "copy"), (np, "save",
                                                      "serialize"),
                     (zlib, "crc32", "crc"),
                     (recovery.atomic, "atomic_write_bytes", "spool"),
                     (srv.durable.journal, "append", "journal"),
                     (srv.durable, "record_append", "recorded")]
            with timing_spies(spies) as spent:
                try:
                    epoch = srv.append(part)
                except testing.SimulatedCrash:
                    print(f"{tag}: SimulatedCrash at {inj.fired_at} in the "
                          f"append of epoch {srv.plane.epoch + 1} (journaled, "
                          f"not installed); memory_allocated before it "
                          f"{before} bytes")
                    break
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            split = ", ".join(f"{what} {spent[k]:.4f}"
                              for k, what in APPEND_SPLIT)
            print(f"{tag}: journaled append of epoch {epoch} "
                  f"({sum(p.numel() for p in part)} records): wall "
                  f"{wall:.4f} s = record {spent['recorded']:.4f} s ({split}) "
                  f"+ install {wall - spent['recorded']:.4f} s ({card})")
            quiescent(srv, epoch)
    if crash_at:
        check(inj.fired, f"{tag}: the crash at {crash_at} never fired")
        return srv, None, inj
    spool = sum(f.stat().st_size for f in (root / f"{tag}_durable" /
                                           "shards").iterdir())
    print(f"{tag}: {spool} bytes spooled, {srv.durable.journal_bytes} "
          f"journal bytes in {srv.durable.journal_records} records")
    return srv, served_state(srv, root, tag), inj


def restore_run(shards, labels, root: pathlib.Path, want: dict,
                card: str) -> dict:
    """Step 3's restore over the 12 base shards on the card: replay,
    re-adoption and the standing catch-ups, checked against run 2."""
    reset_counts(("score_hist", "threshold_select"))
    marks = {}
    replay = recovery.DurabilityPlane.replay_into

    def timed_replay(self, plane):
        marks["replay"] = (time.perf_counter(), sh_ops.launches.count)
        out = replay(self, plane)
        torch.cuda.synchronize()
        marks["adopt"] = (time.perf_counter(), sh_ops.launches.count)
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(recovery.DurabilityPlane, "replay_into",
                           timed_replay):
        srv = SelectionServer.restore(
            root / "crashed_durable", array_oracle(labels),
            base_shards=shards[:SESSION_SHARDS],
            engine_kw={"num_bins": 4096, "workers": 1},
            quotas={"t": 10**7}, sentinel_probe_budget=PROBE,
            sentinel_sigma=4.0)
    t_done = time.perf_counter()
    # resume: re-issue the appends the restored epoch shows missing (the
    # crash came after the journal record, so replay applied both)
    parts = (shards[12:14], shards[14:16])
    reissued = len(parts) - srv.plane.epoch
    for part in parts[srv.plane.epoch:]:
        srv.append(part)
    quiescent(srv, 2)
    torch.cuda.synchronize()
    t_caught = time.perf_counter()
    replayed = marks["adopt"][1] - marks["replay"][1]
    chunks = sum(-(-s.numel() // CHUNK) for s in shards[SESSION_SHARDS:])
    catchups = ts_ops.launches.count
    n_sq = len(srv._registry.standing)
    got = served_state(srv, root, "restored")
    check(srv.engine.device.type == "cuda",
          f"restore built its engine on {srv.engine.device}")
    check(reissued == 0, f"the restored corpus lacks {reissued} appends")
    check((srv.recovered_epochs, srv.recovered_queries) == (2, 2),
          f"recovered {srv.recovered_epochs} epochs, "
          f"{srv.recovered_queries} queries")
    check(replayed == chunks, f"the replay launched score_hist {replayed} "
          f"times for {chunks} replayed chunks")
    check(catchups == chunks * n_sq, f"the catch-ups launched "
          f"threshold_select {catchups} times for {chunks} chunks x "
          f"{n_sq} standing queries")
    check(srv.stats().sentinel_triggers == 0, "the sentinel re-validated")
    check(got["taus"] == want["taus"], f"restored taus {got['taus']} != "
          f"{want['taus']}")
    check(all(np.array_equal(a, b) for a, b in zip(got["sinks"],
                                                   want["sinks"])),
          "restored sink bits differ from the uncrashed run's")
    check(got["charged"] == want["charged"], f"restored tenant charge "
          f"{got['charged']} != {want['charged']}")
    check(got["watches"] == want["watches"], f"restored watch (base key, "
          f"last audited) {got['watches']} != {want['watches']}")
    nxt = [(R.fold_in(np.asarray(k, np.uint32), last + 1).tolist(), last + 1)
           for k, last in got["watches"]]
    print(f"restore: recovered {srv.recovered_epochs} epochs and "
          f"{srv.recovered_queries} standing queries; wall "
          f"{t_done - t0:.4f} s = build {marks['replay'][0] - t0:.4f} + "
          f"replay {marks['adopt'][0] - marks['replay'][0]:.4f} + adopt "
          f"{t_done - marks['adopt'][0]:.4f}; catch-ups done "
          f"{t_caught - t_done:.4f} s later ({card})")
    print(f"restore: score_hist launches in the replay {replayed} for "
          f"{chunks} replayed chunks; threshold_select launches in the "
          f"catch-ups {catchups} ({chunks} chunks x {n_sq} standing "
          f"queries); taus, sink bytes, tenant charge {got['charged']} and "
          f"the watch (base key, last audited epoch) equal the uncrashed "
          f"run's; next audit (key, epoch) {nxt}")
    return {"server": srv, "launches": {"score_hist": sh_ops.launches.count,
                                        "threshold_select": catchups}}


def serve_phase(scores, labels, live: dict, seed: int, card: str) -> dict:
    """Phase 14: the serving and durability planes at real size, on phase
    13's corpus, keys and sequential results."""
    shards = list(torch.tensor_split(scores, N_SHARDS))
    keys = R.split(R.PRNGKey(seed + 13), len(SESSION_BATCH))
    walls = {}
    t0 = time.perf_counter()
    served_batch(shards, labels, live["seq"], live["seq_select_launches"],
                 keys, card)
    walls["served batch"] = time.perf_counter() - t0
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_durable_"))
    try:
        t0 = time.perf_counter()
        srv, want, _ = durable_run(shards, labels, root, seed, "uncrashed",
                                   None, card)
        srv.close()
        walls["uncrashed run"] = time.perf_counter() - t0
        print(f"uncrashed: taus {want['taus']}, tenant charge "
              f"{want['charged']}, watches (base key, last audited) "
              f"{want['watches']}")

        t0 = time.perf_counter()
        srv, _, _ = durable_run(shards, labels, root, seed, "crashed",
                                {"post_journal_pre_install": 1}, card)
        held = sum(st.flat.numel() * 4 for st in
                   [srv.engine._state] + srv.engine._superseded)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        srv.close(abandon=True)
        del srv
        torch.cuda.synchronize()
        after_close = torch.cuda.memory_allocated()
        check(before - after_close >= held, f"close(abandon=True) freed "
              f"{before - after_close} bytes of its engine's {held}")
        restored = restore_run(shards, labels, root, want, card)
        torch.cuda.synchronize()
        after_restore = torch.cuda.memory_allocated()
        restored["server"].close()
        walls["crash, restore, resume"] = time.perf_counter() - t0
        print(f"memory_allocated: {before} bytes before the crashed "
              f"server's close, {after_close} after it (fell "
              f"{before - after_close}, its epochs' flats {held}), "
              f"{after_restore} after the restore")
    finally:
        shutil.rmtree(root)
    launches = restored["launches"]
    check(all(n > 0 for n in launches.values()),
          f"phase 14's path launched {launches}")
    print(f"phase 14 restore-path launches: {launches}")
    print("phase 14 wall s: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in walls.items())
          + f" ({card})")
    return {"launches": launches, "walls": walls}


# -- phase 15 ------------------------------------------------------------------

# The single-array path (`queries.run_query` / `run_joint_query`) over the
# whole corpus. Two-stage PT at 0.8, as in phase 13: at 0.9 it usually
# certifies nothing at this size (PERF.md §7).
ARRAY_QUERIES = [
    ("RT is", SUPGQuery(target="recall", gamma=0.9, delta=0.05, budget=3000,
                        method="is")),
    ("RT uniform", SUPGQuery(target="recall", gamma=0.9, delta=0.05,
                             budget=3000, method="uniform")),
    ("RT noci", SUPGQuery(target="recall", gamma=0.9, delta=0.05,
                          budget=3000, method="noci")),
    ("PT is two-stage", SUPGQuery(target="precision", gamma=0.8, delta=0.05,
                                  budget=3000, two_stage=True)),
    ("PT is one-stage", SUPGQuery(target="precision", gamma=0.8, delta=0.05,
                                  budget=3000, two_stage=False)),
    ("JT", None),      # run_joint_query: RT 0.9 then P 1.0, stage budget 3000
]
ARRAY_KEYS = range(4)
# threshold_select / threshold_count launches a query makes: R2, and PT's
# two-stage |D'|.
ARRAY_LAUNCHES = {"RT is": 1, "RT uniform": 1, "RT noci": 1,
                  "PT is two-stage": 2, "PT is one-stage": 1, "JT": 1}
TWO_LEVEL_DRAWS = 1 << 20
GLOO_RANKS = 2
# The two gloo ranks' sketch against float64 per-bin sums: each rank's
# launch lies within 1e-6 |e| + n 2^-32 (phase 2's bar), and the float32
# sum of the two ranks adds one rounding (2^-24 relative): 2e-6 |e| +
# n 2^-32. Counts: each rank's exact count rounded once to float32, their
# float32 sum rounded once more, so within 2^-22 of the exact count.
GLOO_SUM_REL = 2e-6
GLOO_COUNT_REL = 2.0 ** -22


def recording_oracle(labels: np.ndarray):
    """An oracle over host labels that also records the positives it
    labeled (a query's R1 and, for JT, its verified candidates)."""
    seen = []

    def fn(idx):
        idx = np.asarray(idx, np.int64)
        lab = labels[idx]
        seen.append(idx[lab > 0.5])
        return lab

    return fn, seen


def array_query(name, q, key, scores, labels, device=None):
    """One single-array query through the user entry point (on the card
    unless `device` says otherwise): (result, wall s, the positives its
    oracle labeled)."""
    fn, seen = recording_oracle(labels)
    t0 = time.perf_counter()
    if name == "JT":
        res = queries.run_joint_query(key, scores, fn, 0.9, 1.0,
                                      stage_budget=3000, device=device)
    else:
        res = queries.run_query(key, scores, fn, q, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, np.unique(np.concatenate(seen + [np.empty(0,
                                                                np.int64)]))


def card_union(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sorted union of two index sets, by ``torch.unique`` on the card
    (numpy 2.3's hash-based ``np.unique`` takes seconds at millions)."""
    both = torch.cat([torch.from_numpy(np.asarray(x, np.int64))
                      for x in (a, b)]).to(DEVICE)
    return torch.unique(both).cpu().numpy()


@contextlib.contextmanager
def plain_selection():
    """The threshold kernels' plain versions, patched in where the query
    path calls the kernels (`threshold_select`, `threshold_count`)."""
    with mock.patch.object(ts_ops, "threshold_select",
                           ts_ref.threshold_select_ref), \
            mock.patch.object(ts_ops, "threshold_count",
                              ts_ref.threshold_count_ref):
        yield


def cdf_deviation(scores: torch.Tensor) -> None:
    """The draw's float32 CDF (XLA's blocked order, `bounds.blocked_cumsum`)
    against a float64 prefix sum of the same weights, and the records of
    positive weight that it gives a step of 0."""
    probs = sampling.sqrt_proxy_weights(scores)
    cdf64 = torch.cumsum(probs.double(), 0)
    cdf64 = cdf64 / cdf64[-1]
    cdf32 = bounds.blocked_cumsum(probs)
    cdf32 = cdf32 / cdf32[-1]
    dev = float((cdf32.double() - cdf64).abs().max())
    flat = int(((cdf32[1:] == cdf32[:-1]) & (probs[1:] > 0)).sum())
    print(f"float32 CDF (blocked, the draw's): largest deviation from "
          f"float64 {dev:.4g} (mean increment {1.0 / scores.numel():.4g}, "
          f"half an ulp of 0.5 {2.0 ** -25:.4g}); {flat} records of positive "
          "weight get a step of 0 (never drawn)")
    del probs, cdf64, cdf32


def single_array_phase(scores, labels, seed) -> dict:
    """Part 1 of phase 15: RT/PT/JT over the whole corpus, each query
    held against union(R1, {A >= tau}) on the card and against the same
    query with the threshold kernels' plain versions; returns the R2 size
    at each RT's tau."""
    truth = labels > 0.5
    r2_sizes = {}
    for k in ARRAY_KEYS:
        key = R.PRNGKey(seed + k)
        for name, q in ARRAY_QUERIES:
            reset_counts(["threshold_select"])
            res, wall, pos = array_query(name, q, key, scores, labels)
            launches = ts_ops.launches.count
            check(launches == ARRAY_LAUNCHES[name],
                  f"{name} key {k}: {launches} threshold_select/"
                  f"threshold_count launches, expected "
                  f"{ARRAY_LAUNCHES[name]}")
            tau = res.stage2_tau if name == "JT" else res.tau
            r2 = torch.nonzero(scores >= tau).reshape(-1).cpu().numpy()
            if name == "JT":
                want = card_union(pos, r2[truth[r2]])
                achieved = (f"precision "
                            f"{queries.precision_of(res.selected, truth):.4f}"
                            f", recall "
                            f"{queries.recall_of(res.selected, truth):.4f}")
            else:
                check(res.oracle_calls <= q.budget,
                      f"{name} key {k} spent {res.oracle_calls}")
                want = card_union(pos, r2)
                check(res.n_sampled_positives == pos.size,
                      f"{name} key {k}: sampled positives")
                metric = (queries.recall_of if q.target == "recall"
                          else queries.precision_of)
                achieved = f"{q.target} {metric(res.selected, truth):.4f}"
            check(np.array_equal(res.selected, want),
                  f"{name} key {k}: selected != union(R1, A >= tau)")
            if name.startswith("RT"):
                r2_sizes[(name, k)] = (tau, r2.size)
            with plain_selection():
                plain, _, _ = array_query(name, q, key, scores, labels)
            check(ts_ops.launches.count == launches,
                  f"{name} key {k}: the plain run launched a kernel")
            plain_tau = plain.stage2_tau if name == "JT" else plain.tau
            check(plain_tau == tau and np.array_equal(plain.selected,
                                                      res.selected),
                  f"{name} key {k}: kernels vs plain versions differ")
            print(f"{name} key {k}: wall {wall:.4f} s, tau {tau:.6g}, "
                  f"oracle calls {res.oracle_calls}, {achieved}, "
                  f"{res.selected.size} selected; threshold_select/"
                  f"threshold_count launches {launches}; == plain")
    return r2_sizes


def array_agreement(seed: int) -> None:
    """The card's single-array queries against the CPU's on one small
    corpus: the card draws with the CPU's bits, so tau, selection and
    oracle calls must agree exactly."""
    scores, labels = make_beta_on_device(1 << 20, 0.01, 1.0, seed=seed + 1,
                                         device="cpu")
    on_card = scores.to(DEVICE)
    for name, q in ARRAY_QUERIES:
        a, _, _ = array_query(name, q, R.PRNGKey(seed), on_card, labels)
        b, _, _ = array_query(name, q, R.PRNGKey(seed), scores, labels,
                              device="cpu")
        check(np.array_equal(a.selected, b.selected)
              and a.oracle_calls == b.oracle_calls
              and (a.stage2_tau == b.stage2_tau if name == "JT"
                   else a.tau == b.tau),
              f"card vs cpu single-array {name}")
    print(f"small corpus ({1 << 20} records): card == CPU for each "
          "single-array query (tau, selected, oracle calls)")


def _exact_hist(scores: torch.Tensor, bins: int):
    """Exact int64 per-bin counts and float64 Σ sqrt(A), Σ A of the
    records with A >= 0, on the card."""
    s = scores[scores >= 0]
    ids = sh_ref.bin_index(s, bins)
    a = torch.clamp(s, 0.0, 1.0).double()
    counts = torch.bincount(ids, minlength=bins)
    sums = [torch.zeros(bins, dtype=torch.float64, device=s.device)
            .index_add_(0, ids, v) for v in (torch.sqrt(a), a)]
    return counts, sums


def nccl_phase(scores, labels, r2_sizes, seed, root: pathlib.Path) -> None:
    """Part 2a of phase 15: the distributed plane on nccl at world size 1
    over the whole corpus."""
    dist.init_process_group("nccl", store=dist.FileStore(
        str(root / "nccl_store"), 1), rank=0, world_size=1,
        device_id=torch.device(DEVICE, 0))
    try:
        check(dist.get_backend() == "nccl", "the group is not nccl")
        reset_counts(["score_hist", "threshold_select"])
        t0 = time.perf_counter()
        sketch = dplane.global_sketch(scores)
        shards = list(torch.tensor_split(scores, N_SHARDS))
        totals = torch.cat([dplane.shard_weight_totals(sh) for sh in shards])
        counts_at = {nk: int(dplane.global_selection_count(scores, tau))
                     for nk, (tau, _) in r2_sizes.items()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"score_hist": sh_ops.launches.count,
                    "threshold_select": ts_ops.launches.count}
        check(launches == {"score_hist": 1 + N_SHARDS,
                           "threshold_select": len(r2_sizes)},
              f"nccl path launched {launches}")
        print(f"nccl, world size 1: global_sketch, 16 shard totals and "
              f"{len(r2_sizes)} global counts in {wall:.4f} s; launches "
              f"{launches}")

        want = binned.build_sketch(scores)
        check(all(torch.equal(a, b) for a, b in zip(sketch, want)),
              "global_sketch != binned.build_sketch")
        exact, _ = _exact_hist(scores, binned.DEFAULT_BINS)
        check(torch.equal(sketch.counts, exact.float()),
              "global sketch counts != exact counts rounded to float32")
        folded = binned.merge_sketches(*[
            binned.build_sketch(c) for c in torch.split(scores, CHUNK)])
        diff = (folded.counts.double() - exact.double()).abs()
        print(f"global_sketch bitwise binned.build_sketch; counts == the "
              f"exact int64 histogram rounded once (bin 0: "
              f"{int(exact[0])} records); a float32 fold of "
              f"{N_RECORDS // CHUNK} chunk sketches differs from it by "
              f"{float(diff[0]):.0f} in bin 0, {float(diff.max()):.0f} at "
              "most")
        for nk, (tau, size) in r2_sizes.items():
            check(counts_at[nk] == size,
                  f"global_selection_count at {nk} tau {tau}: "
                  f"{counts_at[nk]} != {size}")
        print(f"global_selection_count == |R2| at each RT's tau "
              f"({len(r2_sizes)} taus)")

        t0 = time.perf_counter()
        ids, keys = dplane.two_level_sample(R.PRNGKey(seed), totals,
                                            TWO_LEVEL_DRAWS)
        t_alloc = time.perf_counter() - t0
        z, n = float(totals[:, 0].sum()), float(totals[:, 1].sum())
        est, offset = [], 0
        for i, sh in enumerate(shards):
            k = int((ids == i).sum())
            if k:
                p, m = dplane.within_shard_probs(sh, z, n)
                d = sampling.sample_weighted(keys[int(np.argmax(ids == i))],
                                             p, k).indices
                est.append(labels[offset + d.cpu().numpy()]
                           * m[d].cpu().numpy())
            offset += sh.numel()
        got, rate = float(np.mean(np.concatenate(est))), float(labels.mean())
        check(abs(got - rate) <= 0.2 * rate,
              f"two-level estimate {got} vs positive rate {rate}")
        print(f"two_level_sample: {TWO_LEVEL_DRAWS} draws over "
              f"{N_SHARDS} shard totals in {t_alloc:.2f} s on the host; "
              f"mean(label * m) {got:.6f} vs positive rate {rate:.6f}")
    finally:
        dist.destroy_process_group()


def _gloo_rank(rank: int, world: int, root: str, seed: int,
               taus: list) -> None:
    """One of the gloo ranks that share the card: half the corpus each,
    every collective of the plane, checked against exact sums over the
    whole corpus; writes what it measured to ``rank<r>.json``."""
    root = pathlib.Path(root)
    scores, _ = make_beta_on_device(N_RECORDS, 0.01, 1.0, seed=seed,
                                    device=DEVICE)
    half = torch.tensor_split(scores, world)[rank].clone()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(root / "gloo_store"), world), rank=rank, world_size=world)
    try:
        check(dist.get_backend() == "gloo", "the group is not gloo")
        reset_counts(["score_hist", "threshold_select"])
        sketch = dplane.global_sketch(half)
        totals = dplane.shard_weight_totals(half, "sqrt")
        counts_at = [int(dplane.global_selection_count(half, t))
                     for t in taus]
        sel = dplane.local_selection(half, taus[0])
        torch.cuda.synchronize()
        launches = {"score_hist": sh_ops.launches.count,
                    "threshold_select": ts_ops.launches.count}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    check(launches == {"score_hist": 2, "threshold_select": len(taus)},
          f"gloo rank {rank} launched {launches}")
    counts, (sum_w, sum_a) = _exact_hist(scores, binned.DEFAULT_BINS)
    c = counts.double()
    count_err = float(((sketch.counts.double() - c).abs()
                       / c.clamp_min(1)).max())
    check(bool(((sketch.counts.double() - c).abs()
                <= GLOO_COUNT_REL * c).all()), "gloo counts")
    sum_err = 0.0
    for got, e in ((sketch.sum_w, sum_w), (sketch.sum_a, sum_a)):
        err = (got.double() - e).abs()
        bar = GLOO_SUM_REL * e.abs() + c * 2.0 ** -32
        check(bool((err <= bar).all()), "gloo sums")
        sum_err = max(sum_err, float((err / bar.clamp_min(1e-30)).max()))
    halves = torch.tensor_split(scores, world)
    want_rows = [float(torch.sqrt(torch.clamp(h, 0, 1).double()).sum())
                 for h in halves]
    rows_rel = max(abs(float(totals[i, 0]) - w) / w
                   for i, w in enumerate(want_rows))
    check(rows_rel <= 1e-6 and [float(totals[i, 1]) for i in range(world)]
          == [float(np.float32(h.numel())) for h in halves],
          f"gloo shard totals off by {rows_rel}")
    exact_at = [int((scores >= t).sum()) for t in taus]
    check(counts_at == exact_at, f"gloo counts {counts_at} != {exact_at}")
    check(torch.equal(sel, half >= taus[0]), "local_selection")
    (root / f"rank{rank}.json").write_text(json.dumps({
        "launches": launches, "count_rel": count_err,
        "sum_err_over_bar": sum_err, "totals_rel": rows_rel,
        "bin0_count": float(sketch.counts[0]), "bin0_exact": int(counts[0]),
        "counts_at": counts_at}))


def gloo_phase(seed: int, taus: list, root: pathlib.Path) -> None:
    """Part 2b of phase 15: two gloo ranks on CUDA tensors, each holding
    half the corpus, spawned after the kernels were built (the ranks load
    the built libraries)."""
    t0 = time.perf_counter()
    ctx = tmp.start_processes(_gloo_rank, args=(GLOO_RANKS, str(root), seed,
                                                taus),
                              nprocs=GLOO_RANKS, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            check(False, "gloo ranks did not end in 300 s")
    for r in range(GLOO_RANKS):
        got = json.loads((root / f"rank{r}.json").read_text())
        print(f"gloo rank {r} of {GLOO_RANKS} on CUDA tensors (half the "
              f"corpus): launches {got['launches']}; counts within "
              f"{got['count_rel']:.3g} of exact (bin 0 {got['bin0_count']:.0f}"
              f" vs {got['bin0_exact']}), sums at most "
              f"{got['sum_err_over_bar']:.3g} of their bar, shard totals "
              f"within {got['totals_rel']:.3g} of float64, global counts "
              f"exact {got['counts_at']}")
    print(f"gloo ranks: wall {time.perf_counter() - t0:.2f} s, processes "
          "started and joined")


def array_phase(seed: int, card: str) -> None:
    """Phase 15: the single-array path and the distributed plane on phase
    3's corpus."""
    t0 = time.perf_counter()
    scores, labels = make_beta_on_device(N_RECORDS, 0.01, 1.0, seed=seed,
                                         device=DEVICE)
    torch.cuda.synchronize()
    print(f"corpus: phase 3's {N_RECORDS} scores drawn again on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    r2_sizes = single_array_phase(scores, labels, seed)
    print(f"single-array queries ({len(ARRAY_KEYS)} keys, with their plain "
          f"reruns): {time.perf_counter() - t0:.2f} s ({card})")
    array_agreement(seed)
    cdf_deviation(scores)
    with tempfile.TemporaryDirectory() as tmpdir:
        root = pathlib.Path(tmpdir)
        nccl_phase(scores, labels, r2_sizes, seed, root)
        del scores, labels
        torch.cuda.empty_cache()
        gloo_phase(seed, sorted({t for t, _ in r2_sizes.values()}), root)


# -- phase 16 ------------------------------------------------------------------

def rwkv_scan_inputs(shape, g):
    """linear_scan's inputs as an RWKV6 block hands them over
    (`rwkv.time_mix`): r, k and v bf16, (B,S,H,hd) seen as (B,H,S,hd); the
    decay per channel w = exp(-exp(w0 + 0.5 · normal)) around the init's
    w0 = -6, float32, the same layout; the bonus u (H,hd) normal at scale
    0.1, the init's law."""
    b, h, s, dk, dv = shape

    def heads(t):
        return t.transpose(1, 2)

    def normal(*size):
        return torch.randn(*size, generator=g, device=DEVICE)
    r = heads(normal(b, s, h, dk).to(torch.bfloat16))
    k = heads((normal(b, s, h, dk) / 8).to(torch.bfloat16))
    v = heads(normal(b, s, h, dv).to(torch.bfloat16))
    w = heads(torch.exp(-torch.exp(-6.0 + 0.5 * normal(b, s, h, dk))))
    return r, k, v, w, normal(h, dk) * 0.1


# The step-by-step kernel that the channel kernel replaced, at rwkv6-7b's
# prefill shape with v cast to float32 before it (PERF.md §6): its time
# and the cast's, ms a block, on an H100 80GB HBM3 at 700 W.
STEP_KERNEL_MS, V_CAST_MS = 1.389, 0.207


def rwkv_scan_row(shape, seed: int) -> dict:
    """The channel kernel at `shape` with RWKV6's inputs
    (`rwkv_scan_inputs`, bf16 v and o): its time, its largest |kernel -
    float64| of o beyond one bf16 ulp (phase 9's bar), the plain
    version's time and the bound: the larger of the bytes (each input
    element read once, o in v's dtype and the float32 state written once)
    over the HBM rate and `channel_ms`. Beside it, a block's path as it
    ran before the kernel took bf16 v: v cast to float32, the kernel, o
    cast back to bf16."""
    b, h, s, dk, dv = shape
    q, k, v, w, u = rwkv_scan_inputs(shape, torch.Generator(
        device=DEVICE).manual_seed(seed + 23))
    check(ls_ops.route(q, k, v, w, u) == "channel",
          f"linear_scan routes RWKV6's inputs at {shape} to "
          f"{ls_ops.route(q, k, v, w, u)}")
    got = ls_ops.linear_scan(q, k, v, w, u)
    arbiter = ls_ref.linear_scan_ref(q, k, v.double(), w, u,
                                     compute_dtype=torch.float64)[0]
    diff = (got[0].double() - arbiter).abs()
    ulp = torch.pow(2.0, torch.floor(torch.log2(arbiter.abs().clamp_min(
        1e-30))) - 7)
    err = float((diff - ulp).max())
    scale = float(arbiter.abs().max())
    check(got[0].dtype == torch.bfloat16
          and bool(torch.isfinite(got[0]).all())
          and err <= SCAN_REL * scale,
          f"linear_scan RWKV6 at {shape}: o differs from the float64 plain "
          f"recurrence by {err:.4g} beyond one bf16 ulp (largest |o| "
          f"{scale:.4g})")
    del arbiter, diff, ulp

    def cast_path():
        o, _ = ls_ops.linear_scan(q, k, v.float(), w, u)
        return o.to(torch.bfloat16)
    runs = [cuda_ms(lambda: ls_ops.linear_scan(q, k, v, w, u), 20),
            cuda_ms(cast_path, 20),
            cuda_ms(lambda: ls_ops.linear_scan(q, k, v, w, u), 20)]
    ms, cast_ms = (runs[0] + runs[2]) / 2, runs[1]
    plain_ms = cuda_ms(lambda: ls_ref.linear_scan_ref(q, k, v, w, u), 1)
    moved = sum(distinct_bytes(t) for t in (q, k, v, w, u)) \
        + distinct_bytes(v) + 4 * b * h * dk * dv
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = channel_ms(b, h, s, dk, dv, v_bf16=True)
    b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes \
        else (t_bytes, "bytes")
    print(f"linear_scan at (B, H, S, dk, dv) = {shape}, rwkv6 layout (bf16 "
          f"r, k and v, float32 w as transposed views, bonus u, bf16 o): "
          f"channel kernel {ms:.6g} ms ({runs[0]:.6g}, {runs[2]:.6g}), "
          f"bound {b_ms:.6g} ms ({b_by}): bytes {t_bytes:.6g} ms "
          f"({moved / 1e6:.6g} MB), operations {t_ops:.6g} ms; share of the "
          f"bound reached {b_ms / ms:.3f}; plain version {plain_ms:.6g} ms; "
          f"max |kernel - float64| of o beyond one bf16 ulp {err:.4g} "
          f"(largest |o| {scale:.4g}, bar {SCAN_REL * scale:.4g})")
    print(f"rwkv6 block's scan, ms a block: bf16 v straight through the "
          f"channel kernel {ms:.6g}; v cast to float32, the channel kernel, "
          f"o cast back {cast_ms:.6g}; the step-by-step kernel and v's cast "
          f"before it {STEP_KERNEL_MS} + {V_CAST_MS} (PERF.md §6)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def rwkv_phase(seed: int, card: str) -> dict:
    """Phase 16: rwkv6-7b at full width. A prefill through
    `make_serve_prefill` (32 linear_scan launches, all on the channel
    route) and its bf16 logits against the plain scan; score, then
    select; the channel kernel's row at the prefill shape; then the model
    cast to float32 in place (the bf16 weights freed), each block of a
    prefill at the cut shape RWKV_F32_SHAPE against the same block with
    the plain scan, and the model's logits (`rwkv_f32_sensitivity`).
    Returns the kernels line's row for the channel kernel."""
    cfg = get_config(RWKV)
    per_prefill = {"linear_scan": cfg.num_layers}
    model = init_model(cfg, seed)
    model_phase(model, cfg, seed, per_prefill, f32_copy=False)
    launches = score_select_phase(model, cfg, seed, N_RWKV_CORPUS,
                                  per_prefill)["linear_scan"]
    row = rwkv_scan_row(LS_RWKV, seed)
    f32 = model.float()            # in place: the bf16 weights go
    f32.cfg = dataclasses.replace(cfg, dtype="float32")
    b, s = RWKV_F32_SHAPE
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=DEVICE,
                           generator=torch.Generator(device=DEVICE)
                           .manual_seed(seed + 1))
    rwkv_blocks_vs_plain(f32, f32.cfg, tokens, LOGIT_TOL[RWKV][1])
    rwkv_f32_sensitivity(f32, tokens)
    del model, f32
    print(f"phase 16 linear_scan channel-route launches on the score-then-"
          f"select path: {launches} ({card})")
    return {"launches": launches, **row}


def record_rwkv_blocks(model, tokens) -> list:
    """(input, output) of every RWKV6 block in a prefill of `tokens`
    through the kernels, in order."""
    seen = []
    real = rwkv.rwkv_block

    def recording(p, cfg, x, state=None):
        y, new_state = real(p, cfg, x, state)
        seen.append((x, y))
        return y, new_state
    with mock.patch.object(rwkv, "rwkv_block", recording):
        modellib.last_logits(model, tokens)
    return seen


def ratio_to_largest(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return float((got - want).abs().max()) / float(want.abs().max())


def rwkv_blocks_vs_plain(model, cfg, tokens, tol: float) -> float:
    """Each block of a prefill through the kernels against the same block
    with the plain scan, on the input the kernels' run gave it: within
    `tol` of the block output's largest magnitude. (The float32 model's
    logits cannot be held so: see `rwkv_f32_sensitivity`.)"""
    worst = 0.0
    seen = record_rwkv_blocks(model, tokens)
    with torch.inference_mode(), plain_paths(("linear_scan",)):
        for i, (blk, (x, y)) in enumerate(zip(model.body.blocks, seen)):
            plain, _ = rwkv.rwkv_block(blk, cfg, x)
            r = ratio_to_largest(y, plain)
            check(bool(torch.isfinite(y).all()) and r <= tol,
                  f"{cfg.name} block {i}: kernel vs plain scan {r:.4g} of "
                  f"the largest |output| (tol {tol})")
            worst = max(worst, r)
    print(f"{cfg.name} float32, each of {len(seen)} blocks of a prefill of "
          f"tokens {tuple(tokens.shape)} on its own input, kernel vs plain "
          f"scan: max |difference| {worst:.4g} of the block's largest "
          f"|output| (tol {tol})")
    return worst


def rwkv_f32_sensitivity(model, tokens) -> None:
    """The float32 model's last-position logits with the kernel, with the
    plain scan, and with the plain scan in float64: how far two float32
    computations of the same model lie apart. Printed, not held: through
    32 blocks the random-init RWKV6 carries a change at float32 rounding
    to differences far above 2e-5 of the largest |logit| (most at early
    positions; per-head group norms of small outputs), so the blocks are
    held one at a time (`rwkv_blocks_vs_plain`)."""
    kernel = modellib.last_logits(model, tokens)
    with plain_paths(("linear_scan",)):
        plain = modellib.last_logits(model, tokens)
    with plain_paths(("linear_scan",), scan=functools.partial(
            ls_ref.linear_scan_ref, compute_dtype=torch.float64)):
        exact = modellib.last_logits(model, tokens)
    print(f"{model.cfg.name} last-position logits of tokens "
          f"{tuple(tokens.shape)}, as shares of the largest |logit|: kernel "
          f"vs plain scan {ratio_to_largest(kernel, plain):.4g}, plain scan "
          f"vs plain scan in float64 {ratio_to_largest(plain, exact):.4g}, "
          f"kernel vs float64 {ratio_to_largest(kernel, exact):.4g}")


# -- phase 17 ------------------------------------------------------------------

def rwkv_blocks_decode(model, cfg, seed: int, tol: float,
                       label: str) -> float:
    """Each RWKV6 block decoding, from `init_rwkv_state`, the input the
    block saw in a prefill through the kernels, one token at a time:
    every step's output against the prefill block's output at that
    position, within `tol` of its largest magnitude."""
    rows, length = len(DECODE_OFFSETS), max(DECODE_OFFSETS) + DECODE_STEPS
    tokens = torch.randint(0, cfg.vocab_size, (rows, length), device=DEVICE,
                           generator=torch.Generator(device=DEVICE)
                           .manual_seed(seed + 31))
    worst = 0.0
    seen = record_rwkv_blocks(model, tokens)
    with torch.inference_mode():
        for i, (blk, (x, y)) in enumerate(zip(model.body.blocks, seen)):
            state = rwkv.init_rwkv_state(cfg, rows, layers.dtype_of(cfg),
                                         device=DEVICE)
            for t in range(length):
                out, state = rwkv.rwkv_block(blk, cfg, x[:, t:t + 1], state)
                r = ratio_to_largest(out[:, 0], y[:, t])
                check(bool(torch.isfinite(out).all()) and r <= tol,
                      f"{cfg.name} {label} block {i} decode at position "
                      f"{t}: {r:.4g} of the prefill block's largest |output|"
                      f" (tol {tol})")
                worst = max(worst, r)
    print(f"{cfg.name} {label} model, each of {len(seen)} blocks decoding "
          f"its prefill input ({rows} rows, {length} positions) from a zero "
          f"state against the prefill block (through the kernel): max "
          f"|difference| {worst:.4g} of the block's largest |output| (tol "
          f"{tol})")
    return worst


def merge_row(dst, src, row: int) -> None:
    """Row `row` of every tensor of caches `dst` := row 0 of `src`'s."""
    with torch.inference_mode():
        for (_, d), (_, s_) in zip(named_tensors(dst), named_tensors(src)):
            d[row] = s_[0]


def decode_tokens(cfg, seed: int) -> torch.Tensor:
    """The tokens of the decode checks: one row for each of
    DECODE_OFFSETS, long enough for its DECODE_STEPS steps."""
    rows, length = len(DECODE_OFFSETS), max(DECODE_OFFSETS) + DECODE_STEPS
    return rand_tokens(cfg, (rows, length), torch.Generator(device=DEVICE)
                       .manual_seed(seed + 31))


def decode_schedule():
    """(label, rows, positions) of every decode call of `decode_logits`,
    in order: row r alone at each of its first DECODE_OFFSETS[r]
    positions, then DECODE_STEPS steps of all rows at their own
    positions."""
    every = list(range(len(DECODE_OFFSETS)))
    alone = [(f"row {r} alone, position {i}", [r], [i])
             for r, off in enumerate(DECODE_OFFSETS) for i in range(off)]
    return alone + [(f"step {i}", every, [off + i for off in DECODE_OFFSETS])
                    for i in range(DECODE_STEPS)]


def decode_logits(model, cfg, tokens, init, dtype=torch.float32):
    """Logits (rows, length, V) of `tokens` decoded by `make_serve_decode`
    on `decode_schedule`: row r first decodes its first DECODE_OFFSETS[r]
    tokens alone, from caches `init(1)`; its caches go into row r of
    `init(rows)`, which then takes DECODE_STEPS steps with every row at
    its own position. Positions a row never reaches hold NaN."""
    rows, length = tokens.shape[:2]
    serve_decode = make_serve_decode(cfg)
    dec = torch.full((rows, length, *logit_shape(cfg)), float("nan"),
                     dtype=dtype, device=DEVICE)
    caches = init(rows)
    for r, off in enumerate(DECODE_OFFSETS):
        alone = init(1)
        for i in range(off):
            lo, alone = serve_decode(model, {
                "tokens": tokens[r:r + 1, i:i + 1],
                "pos": torch.full((1,), i, device=DEVICE)}, alone)
            dec[r, i] = lo[0, 0]
        merge_row(caches, alone, r)
    offsets = torch.tensor(DECODE_OFFSETS, device=DEVICE)
    every = torch.arange(rows, device=DEVICE)
    for i in range(DECODE_STEPS):
        pos = offsets + i
        batch = {"tokens": tokens[every, pos][:, None], "pos": pos}
        lo, caches = serve_decode(model, batch, caches)
        dec[every, pos] = lo[:, 0]
    return dec


def gap(got, want, rows, pos) -> float:
    """max |got - want| over the largest |want| at (rows, pos)."""
    w = want[rows, pos]
    return float((got[rows, pos] - w).abs().max()) / float(w.abs().max())


def decode_consistency(model, cfg, seed: int, tol: float, label: str):
    """Each row's decode from `init_caches` (`decode_logits`) against the
    same model's prefill (through the kernels) at every position. Every
    decode call's logits must lie within `tol` of the largest |prefill
    logit| at that call (with `tol` None they are printed, not held);
    returns the largest ratio, the decode's logits and the prefill's. An
    MoE model runs at capacity factor E, where neither side drops an
    assignment (the caches are tested, not the capacity), and each decode
    call replays the prefill's routing of its tokens (`replayed_routing`;
    a choice of the decode's own that would differ must be a near tie)."""
    dt = layers.dtype_of(cfg)
    if cfg.moe:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=float(cfg.num_experts))
    own_cfg, model.cfg = model.cfg, cfg
    tokens = decode_tokens(cfg, seed)
    length = tokens.shape[1]
    schedule = decode_schedule()
    with recorded_routing() as pre_calls:
        prefill = modellib.apply_train(model, tokens)    # (B,S,V) float32
    check(all(bool(c["kept"].all()) for c in pre_calls),
          f"{cfg.name} prefill dropped an assignment at capacity factor E")

    def prefill_ids(i):
        # the prefill's expert ids of the tokens of MoE call i of the decode
        (_, rows, pos), j = schedule[i // len(pre_calls)], i % len(pre_calls)
        at = torch.tensor(rows, device=DEVICE) * length \
            + torch.tensor(pos, device=DEVICE)
        return pre_calls[j]["ids"][at]
    with replayed_routing(prefill_ids) as dec_calls:
        dec = decode_logits(model, cfg, tokens, lambda n: (
            modellib.init_caches(cfg, n, DECODE_CACHE, dt)))
    model.cfg = own_cfg
    check(len(dec_calls) == len(pre_calls) * len(schedule),
          f"{cfg.name} decode: {len(dec_calls)} MoE calls")
    replay_flips(dec_calls, f"{cfg.name} {label} decode against the "
                 f"prefill at capacity factor {cfg.capacity_factor:g}")
    worst = 0.0
    for where, rows, pos in schedule:
        ratio = gap(dec, prefill, rows, pos)
        check(bool(torch.isfinite(dec[rows, pos]).all())
              and (tol is None or ratio <= tol),
              f"{cfg.name} {label} decode {where}: max |decode - prefill| "
              f"{ratio:.4g} of the largest |logit| (tol {tol})")
        worst = max(worst, ratio)
    rows, steps = len(DECODE_OFFSETS), DECODE_STEPS
    print(f"{cfg.name} {label} model: {rows} rows from positions "
          f"{list(DECODE_OFFSETS)}, {steps} steps through make_serve_decode "
          f"against the prefill through the kernels: max |decode - prefill| "
          f"{worst:.4g} of the largest |logit| "
          + (f"(tol {tol})" if tol is not None else
             "(not held: see the block check and the float64 arbiter)"))
    return worst, dec, prefill


@contextlib.contextmanager
def float64_glue():
    """A float64 model computed in float64 throughout: every `.float()`
    of the model's glue (its norms, activations, decay and head) made
    `.double()`, and the scan by its plain version in float64."""
    with mock.patch.object(torch.Tensor, "float",
                           lambda self, *args, **kwargs: self.double()), \
            plain_paths(("linear_scan",), scan=functools.partial(
                ls_ref.linear_scan_ref, compute_dtype=torch.float64)):
        yield


def doubled(tree):
    """A copy of a nested dict/list cache structure in float64."""
    if isinstance(tree, dict):
        return {k: doubled(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [doubled(v) for v in tree]
    return tree.double()


def rwkv_decode_vs_float64(cfg, seed: int, card: str) -> float:
    """The arbiter of rwkv6-7b's decode: the model at full width cut to
    RWKV_F64_BLOCKS blocks (weights drawn from `seed`), its float32 copy's
    decode and prefill (through the kernel) against its float64 copy's
    prefill (`float64_glue`), at every position of `decode_schedule`, and
    the float64 decode against the float64 prefill. The float64 decode
    must lie within RWKV_F64_DECODE_TOL of it (the decode's algebra is the
    prefill's), and the float32 decode within RWKV_F32_DECODE_TOL (as far
    as float32 rounding carries the prefill itself). Returns the float32
    decode's largest gap."""
    cut = dataclasses.replace(cfg, num_layers=RWKV_F64_BLOCKS)
    model = init_model(cut, seed)
    f64 = copy.deepcopy(model).double()
    f32 = model.float()          # in place: the bf16 weights go
    del model
    f32.cfg = f64.cfg = dataclasses.replace(cut, dtype="float32")
    _, dec32, pre32 = decode_consistency(
        f32, f32.cfg, seed, None, f"float32 {RWKV_F64_BLOCKS}-block")
    tokens = decode_tokens(cut, seed)
    with float64_glue():
        pre64 = modellib.apply_train(f64, tokens)
        dec64 = decode_logits(f64, f64.cfg, tokens, lambda n: doubled(
            modellib.init_caches(cut, n, DECODE_CACHE, torch.float64)),
            torch.float64)
    check(pre64.dtype == dec64.dtype == torch.float64,
          f"float64 arbiter logits in {pre64.dtype}, {dec64.dtype}")
    print(f"{cut.name} cut to {RWKV_F64_BLOCKS} blocks, against its float64 "
          f"prefill (largest |logit| {float(pre64.abs().max()):.4g}), as "
          f"shares of the largest |logit| of the rows at each position "
          f"(float32 decode / float32 prefill through the kernel / float64 "
          f"decode):")
    worst = {"decode32": 0.0, "prefill32": 0.0, "decode64": 0.0}
    for p in range(tokens.shape[1]):
        rows = [r for r, off in enumerate(DECODE_OFFSETS)
                if p < off + DECODE_STEPS]
        pos = [p] * len(rows)
        got = {"decode32": gap(dec32, pre64, rows, pos),
               "prefill32": gap(pre32, pre64, rows, pos),
               "decode64": gap(dec64, pre64, rows, pos)}
        for key, value in got.items():
            worst[key] = max(worst[key], value)
        print(f"  position {p:2d} ({len(rows)} rows): "
              + " / ".join(f"{got[k]:.4g}" for k in worst))
    print(f"{cut.name} {RWKV_F64_BLOCKS}-block float64 arbiter: largest gaps "
          + ", ".join(f"{k} {v:.4g}" for k, v in worst.items())
          + f" (tol: decode64 {RWKV_F64_DECODE_TOL}, decode32 "
          f"{RWKV_F32_DECODE_TOL}) ({card})")
    check(worst["decode64"] <= RWKV_F64_DECODE_TOL,
          f"{cut.name} float64 decode lies {worst['decode64']:.4g} of the "
          f"largest |logit| from its float64 prefill")
    check(RWKV_F32_DECODE_TOL is None
          or worst["decode32"] <= RWKV_F32_DECODE_TOL,
          f"{cut.name} float32 decode lies {worst['decode32']:.4g} of the "
          f"largest |logit| from the float64 prefill")
    del f32, f64
    torch.cuda.empty_cache()
    return worst["decode32"]


def named_tensors(tree, name=None):
    """(key, tensor) for every tensor of a nested dict/list cache
    structure, the key its innermost dict key."""
    if isinstance(tree, dict):
        return [kt for k, v in tree.items() for kt in named_tensors(v, k)]
    if isinstance(tree, list):
        return [kt for v in tree for kt in named_tensors(v, name)]
    return [(name, tree)]


def decode_bound(model, cfg, caches, rows: int) -> tuple:
    """(bound_ms, bound_by, (weight, KV, state bytes), ops) of one decode
    step: every weight read once (of an untied embedding only the rows'
    entries), every KV cache (an MLA block's latent c and k_rope) read
    whole, every recurrent state (conv tail, token shifts, SSM or wkv
    state) read and written once, the logits written; over the HBM rate.
    Against it the operations: `model_flops` of one token a row, the
    head's 2 · rows · d · V and the attention's 2 · rows · H · S · dh for
    each of K and V a run (MLA's absorbed form: 2 · rows · H · S · r_kv
    each for the scores and p·c, 2 · rows · H · S · dr for the rotary
    scores), at the bf16 rate."""
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    if not cfg.tie_embeddings:
        table = model.embed.table
        weights -= table.numel() * table.element_size()
        weights += rows * cfg.num_codebooks * cfg.d_model \
            * table.element_size()
    kv, states, attn_ops = 0, 0, 0.0
    per_position = {"k": cfg.head_dim, "v": cfg.head_dim,
                    "c": 2 * cfg.kv_lora_rank,
                    "k_rope": cfg.qk_rope_head_dim}
    for key, t in named_tensors(caches):
        if key in per_position:
            kv += t.numel() * t.element_size()
            attn_ops += 2.0 * rows * cfg.num_heads * t.shape[1] \
                * per_position[key]
        else:
            states += 2 * t.numel() * t.element_size()
    moved = weights + kv + states + 4 * rows * cfg.vocab_size \
        * cfg.num_codebooks
    ops = model_flops(cfg, rows, 1) + 2.0 * rows * cfg.d_model \
        * cfg.vocab_size * cfg.num_codebooks + attn_ops
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, (weights, kv, states), ops


def decode_times(model, cfg, rows: int, length: int, seed: int,
                 card: str) -> dict:
    """ms a `make_serve_decode` step at pos = length - 1, on caches of
    random contents, tokens/s and the bytes bound; the step's peak device
    memory; then one step under torch.profiler: kernels launched, the
    device's busy share, and device-to-host copies (must be 0)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=DEVICE).manual_seed(seed + 37)
    caches = modellib.init_caches(cfg, rows, length, layers.dtype_of(cfg))
    with torch.inference_mode():
        for _, t in named_tensors(caches):
            t.normal_(0.0, 0.5, generator=g)
    batch = {"tokens": rand_tokens(cfg, (rows, 1), g),
             "pos": torch.full((rows,), length - 1, device=DEVICE)}
    serve_decode = make_serve_decode(cfg)
    reps = 10 if rows * length <= 1 << 22 else 4
    ms = cuda_ms(lambda: serve_decode(model, batch, caches), reps)
    peak = torch.cuda.max_memory_allocated()
    b_ms, b_by, (weights, kv, states), ops = decode_bound(model, cfg, caches,
                                                        rows)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        logits, _ = serve_decode(model, batch, caches)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total, e.count) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in kernels)
    copies = {way: sum(e.count for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and way in e.key) for way in ("DtoH", "HtoD")}
    check(bool(torch.isfinite(logits).all())
          and logits.shape == (rows, 1, *logit_shape(cfg)),
          f"{cfg.name} decode logits at ({rows}, {length})")
    check(peak < DECODE_PEAK_BYTES,
          f"{cfg.name} decode at ({rows}, {length}): peak device memory "
          f"{peak / 1e9:.2f} GB")
    check(copies["DtoH"] == 0,
          f"{cfg.name} decode step made {copies['DtoH']} device-to-host "
          "copies")
    print(f"{cfg.name} decode, {rows} rows, cache length {length}, pos "
          f"{length - 1}: {ms:.4f} ms a step, {rows / ms * 1e3:.1f} tokens/s; "
          f"bound {b_ms:.4f} ms ({b_by}: weights {weights / 1e9:.3f} GB, KV "
          f"caches {kv / 1e9:.3f} GB, states read and written "
          f"{states / 1e9:.3f} GB at 3.35 TB/s; {ops / 1e12:.3f} TFLOP at "
          f"the bf16 peak), share of the bound reached {b_ms / ms:.3f}; peak "
          f"device memory {peak / 1e9:.2f} GB ({card})")
    if kernels:
        print(f"  one step under the profiler: wall {wall_us / 1e3:.3f} ms, "
              f"{sum(n for _, _, n in kernels)} kernels, device busy "
              f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.3f} of the "
              f"wall), {copies['DtoH']} device-to-host and {copies['HtoD']} "
              f"host-to-device copies; top kernels:")
        for name, t, n in sorted(kernels, key=lambda k: -k[1])[:6]:
            print(f"  {t / 1e3:9.3f} ms  x{n:<5d} {name[:90]}")
    else:
        print("  one step under the profiler: no device time recorded")
    del caches, logits
    return {"ms": ms, "bound_ms": b_ms, "peak_gb": peak / 1e9}


def decode_phase(seed: int, card: str) -> None:
    """Phase 17: decode at full width for smollm-360m, zamba2-1.2b and
    rwkv6-7b: consistency with the prefill in float32 and bf16, then the
    step times of each (model, rows, cache length) cell of DECODE_CELLS."""
    for arch in (ARCH, ZAMBA, RWKV):
        cfg = get_config(arch)
        model = init_model(cfg, seed)
        by_block = arch == RWKV
        decode_consistency(model, cfg, seed, None if by_block
                           else DECODE_BF16_TOL[arch], "bf16")
        if by_block:
            rwkv_blocks_decode(model, cfg, seed, DECODE_BF16_TOL[arch],
                               "bf16")
        for rows, length in DECODE_CELLS[arch]:
            decode_times(model, cfg, rows, length, seed, card)
        if by_block:
            f32 = model.float()    # in place: the bf16 weights go
        else:
            f32 = copy.deepcopy(model).float()
        del model
        f32.cfg = dataclasses.replace(cfg, dtype="float32")
        decode_consistency(f32, f32.cfg, seed, None if by_block
                           else DECODE_F32_TOL, "float32")
        if by_block:
            rwkv_blocks_decode(f32, f32.cfg, seed, RWKV_DECODE_F32_TOL,
                               "float32")
        del f32
        torch.cuda.empty_cache()
    rwkv_decode_vs_float64(get_config(RWKV), seed, card)


# -- phase 18 ------------------------------------------------------------------

def new_config(arch: str):
    """`arch`'s published config, cut in depth where `NEW_DEPTH` says."""
    cfg = get_config(arch)
    if arch in NEW_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=NEW_DEPTH[arch])
    return cfg


def dense_config_phase(arch: str, seed: int, card: str) -> int:
    """Phase 18 (a): one dense config at full width: the prefill, its
    logits against plain attention, its decode against the prefill and a
    decode step's time; returns the prefill's flash_attention launches."""
    cfg = new_config(arch)
    print(f"{arch}: {cfg.num_layers} of {get_config(arch).num_layers} "
          f"layers, {modellib.count_params_analytic(cfg)} parameters")
    model = init_model(cfg, seed)
    per_prefill = {"flash_attention": cfg.num_layers}
    model_phase(model, cfg, seed, per_prefill,
                f32_copy=NEW_LOGIT_TOL[arch][1] is not None)
    decode_consistency(model, cfg, seed, DECODE_BF16_TOL[arch], "bf16")
    decode_times(model, cfg, NEW_DECODE_ROWS[arch], NEW_DECODE_LENGTH, seed,
                 card)
    del model
    torch.cuda.empty_cache()
    return per_prefill["flash_attention"]


def plain_kept(ids: np.ndarray, num_experts: int, cap: int) -> np.ndarray:
    """Whether each assignment (n, k) is kept, by a plain walk: in token
    order, an expert keeps its first `cap` assignments."""
    flat = ids.reshape(-1)
    kept = np.zeros(flat.shape, dtype=bool)
    for e in range(num_experts):
        mine = flat == e
        kept[mine] = np.arange(int(mine.sum())) < cap
    return kept.reshape(ids.shape)


def moe_plain_f32(p, cfg, x, ids, gates, kept,
                  absolute: bool = False) -> torch.Tensor:
    """The MoE layer's output (n, d) in float32 for the routing (ids,
    gates, kept; each (n, k)), one expert at a time, each expert's weights
    cast to float32 alone, plus the shared experts in float32; with
    `absolute`, the sum of the terms' magnitudes instead (|shared| + Σ
    g·|y|)."""
    mag = torch.abs if absolute else (lambda t: t)
    xt = x.reshape(-1, cfg.d_model).float()
    out = torch.zeros_like(xt)
    for e in range(cfg.num_experts):
        tok, j = torch.nonzero((ids == e) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xt[tok]
        h = F.silu(xe @ p.w_gate[e].float()) * (xe @ p.w_up[e].float())
        out.index_add_(0, tok, gates[tok, j, None]
                       * mag(h @ p.w_down[e].float()))
    if cfg.num_shared_experts:
        sh = p.shared
        out += mag((F.silu(xt @ sh.w_gate.float()) * (xt @ sh.w_up.float()))
                   @ sh.w_down.float())
    return out


def moe_layer_check(p, cfg, x, label: str) -> dict:
    """`moe.moe_apply` on x (B, S, d) against its plain float32 evaluation
    (`moe_plain_f32`) of the same routing, within MOE_F32_TOL of the
    largest |plain|; its drops against `plain_kept`; prints the capacity,
    the drop share, the dispatch's expert work against the active's and
    whether a second run repeats bit for bit. Returns the routing."""
    gate_fn = transformer.gate_fn_of(cfg)
    with recorded_routing() as calls:
        out, aux = moe.moe_apply(p, cfg, x, gate_fn)
        again, _ = moe.moe_apply(p, cfg, x, gate_fn)
    rec = calls[0]
    n, k = rec["ids"].shape
    e, cap = cfg.num_experts, rec["cap"]
    check(cap == moe.capacity(cfg, n), f"{label}: capacity {cap}")
    check(np.array_equal(rec["kept"].cpu().numpy(), plain_kept(
        rec["ids"].cpu().numpy(), e, cap)),
        f"{label}: the dispatch's drops differ from a plain walk")
    plain = moe_plain_f32(p, cfg, x, rec["ids"], rec["gates"], rec["kept"])
    got = out.reshape(n, -1).float()
    err = float((got - plain).abs().max()) / float(plain.abs().max())
    fro = float((got - plain).norm() / plain.norm())
    check(bool(torch.isfinite(out).all()) and err <= MOE_F32_TOL,
          f"{label}: max |moe_apply - plain float32| {err:.4g} of the largest"
          f" |output| (tol {MOE_F32_TOL})")
    dropped = 1.0 - float(rec["kept"].float().mean())
    print(f"{label}: n {n} tokens, top-{k} of {e} experts, capacity {cap}, "
          f"{dropped:.4f} of the {n * k} assignments dropped; the dispatch "
          f"multiplies E · cap = {e * cap} rows an expert matrix against the "
          f"active n · k = {n * k} ({e * cap / (n * k):.3f}x); aux "
          f"{float(aux):.6g}; against the plain float32 evaluation of the "
          f"same routing: max |difference| {err:.4g} of the largest |output|"
          f" (tol {MOE_F32_TOL}), ||difference|| / ||plain|| {fro:.4g}; a "
          f"second run {'repeats' if torch.equal(out, again) else 'differs'}"
          f" bit for bit")
    del out, again, plain, got
    return rec


def llama4_phase(seed: int, card: str) -> int:
    """Phase 18 (b): llama4-maverick cut to one pair at full width;
    returns the flash_attention launches of its prefill and its scored
    corpus."""
    cfg = new_config(LLAMA4)
    full = get_config(LLAMA4)
    print(f"{LLAMA4}: {cfg.num_layers} of {full.num_layers} layers (one "
          f"pair), {modellib.count_params_analytic(cfg)} parameters, "
          f"{modellib.count_params_analytic(cfg, active_only=True)} active "
          f"(the published config: {full.param_count()}, "
          f"{full.active_param_count()} active)")
    model = init_model(cfg, seed)
    per_prefill = {"flash_attention": cfg.num_layers}
    model_phase(model, cfg, seed, per_prefill, f32_copy=False)

    # the MoE layer on its own prefill input
    b, s = FA_PREFILL[:2]
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=DEVICE,
                           generator=torch.Generator(device=DEVICE)
                           .manual_seed(seed + 1))
    seen = {}
    real = moe.moe_apply

    def capture(p, c, x, gate_fn="softmax"):
        seen.update(p=p, x=x)
        return real(p, c, x, gate_fn)
    with mock.patch.object(moe, "moe_apply", capture):
        modellib.last_logits(model, tokens)
    moe_layer_check(seen["p"], cfg, seen["x"],
                    f"{cfg.name} MoE layer on its ({b}, {s}) prefill input")
    del seen

    decode_consistency(model, cfg, seed, DECODE_BF16_TOL[LLAMA4], "bf16")
    decode_times(model, cfg, NEW_DECODE_ROWS[LLAMA4], NEW_DECODE_LENGTH,
                 seed, card)
    launches = score_select_phase(model, cfg, seed, N_LLAMA4_CORPUS,
                                  per_prefill)["flash_attention"]
    del model
    torch.cuda.empty_cache()
    return per_prefill["flash_attention"] + launches


def dsv2_moe_phase(seed: int, card: str) -> None:
    """Phase 18 (c): `moe_apply` alone at deepseek-v2's MoE widths: the
    card's routing and dispatch against the CPU port's from the same
    router logits, the output against its plain float32 evaluation, and
    its time."""
    cfg = DSV2_MOE
    g = torch.Generator(device=DEVICE).manual_seed(seed + 41)
    p = moe.init_moe(cfg, generator=g, device=DEVICE)
    x = torch.randn(*MOE_TOKENS, cfg.d_model, generator=g,
                    device=DEVICE).to(torch.bfloat16)
    rec = moe_layer_check(p, cfg, x, f"{cfg.name} moe_apply alone at "
                          f"{MOE_TOKENS}")
    n = rec["ids"].shape[0]
    logits = x.reshape(n, -1).float() @ p.router
    routed = {}
    for where, lo in (("card", logits), ("cpu", logits.cpu())):
        ids, gates, gates_all = moe.top_k_routing(
            lo, cfg.num_experts_per_tok, "softmax")
        routed[where] = (ids, *moe.dispatch(ids, cfg.num_experts,
                                            rec["cap"]))
    for name, got, want in zip(("ids", "order", "tokens", "slots", "kept"),
                               routed["card"], routed["cpu"]):
        check(torch.equal(got.cpu(), want),
              f"{cfg.name}: the card's routing {name} differ from the CPU's")
    check(torch.equal(routed["card"][0], rec["ids"]),
          f"{cfg.name}: the router's logits route differently than "
          "moe_apply")
    ms = cuda_ms(lambda: moe.moe_apply(p, cfg, x, "softmax"), 5)
    weights = sum(t.numel() * t.element_size() for t in p.parameters())
    n_k = n * cfg.num_experts_per_tok
    ops = 2.0 * 3 * cfg.d_model * cfg.moe_d_ff * (
        n_k + n * cfg.num_shared_experts) + 2.0 * n * cfg.d_model \
        * cfg.num_experts
    t_bytes = (weights + 2 * 2 * x.numel()) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    print(f"{cfg.name}: the card's expert ids, sort order, tokens, slots and"
          f" drops equal the CPU port's from the same router logits "
          f"({n} x {cfg.num_experts}); moe_apply {ms:.4f} ms; bound "
          f"{max(t_bytes, t_ops):.4f} ms ("
          f"{'bytes' if t_bytes >= t_ops else 'operations'}: weights "
          f"{weights / 1e9:.3f} GB, {ops / 1e12:.3f} TFLOP of the active "
          f"experts, the shared ones and the router) ({card})")
    del p, x


def flash_dh128_phase(seed: int) -> tuple:
    """Phase 18 (d): flash_attention at dh 128 against its plain version
    at yi-6b's and llama4's prefill shapes (phase 5's bf16 bars, repeat
    bitwise), then its times there; returns the largest |kernel - plain|
    at llama4's shape and the rows of times by shape."""
    g = torch.Generator(device=DEVICE).manual_seed(seed + 17)
    err_llama4 = 0.0
    for shape in (FA_YI, FA_LLAMA4):
        q, k, v = attention_inputs(shape, torch.bfloat16, g)
        err = hold_flash(q, k, v, True,
                         f"flash_attention {shape} bf16 causal")
        if shape == FA_LLAMA4:
            err_llama4 = err
        del q, k, v
    rows = {shape: flash_row(shape, seed) for shape in (FA_YI, FA_LLAMA4)}
    for shape, row in rows.items():
        print(f"flash_attention at (B, S, H, KV, dh) = {shape}, bf16 causal:"
              f" {json.dumps(row)}")
    return err_llama4, rows


def new_configs_phase(seed: int, card: str) -> dict:
    """Phase 18: the configs at head dim 128 and the MoE layer; returns
    flash_attention's dh-128 row of the kernels line."""
    dh128 = 0
    for arch in NEW_DENSE:
        dh128 += dense_config_phase(arch, seed, card)
    dh128 += llama4_phase(seed, card)
    dsv2_moe_phase(seed, card)
    err, rows = flash_dh128_phase(seed)
    print(f"phase 18 flash_attention dh-128 launches on the prefills and "
          f"llama4's scored corpus: {dh128}")
    return {"launches": dh128, "max_abs_err": err, **rows[FA_LLAMA4]}


# -- phase 19 ------------------------------------------------------------------

def flash_mla_phase(seed: int) -> tuple:
    """Phase 19 (a): flash_attention at (dh, dv) = (192, 128), MLA's
    prefill pair, against its plain version (by groups of KV heads):
    deepseek-v2's prefill shape in bf16, then a ragged S causal and not,
    and a GQA layout, in bf16 and float32 (phase 5's bars, repeat
    bitwise); then its times beside its bound, the plain version and SDPA
    by its fastest fused backend. Returns the largest |kernel - plain| at
    deepseek-v2's shape and the row of times."""
    g = torch.Generator(device=DEVICE).manual_seed(seed + 19)
    q, k, v = attention_inputs(FA_DSV2, torch.bfloat16, g)
    err = hold_flash(q, k, v, True, f"flash_attention {FA_DSV2} bf16 "
                     f"causal", plain_attention_by_heads)
    del q, k, v
    for shape, causal in (((2, 1000, 16, 16, 192, 128), True),
                          ((2, 1000, 16, 16, 192, 128), False),
                          ((2, 300, 8, 2, 192, 128), True)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = attention_inputs(shape, dtype, g)
            hold_flash(q, k, v, causal, f"flash_attention {shape} {dtype} "
                       f"causal={causal}")
            del q, k, v
    row = flash_row(FA_DSV2, seed, plain_attention_by_heads)
    print(f"flash_attention at (B, S, H, KV, dh, dv) = {FA_DSV2}, bf16 "
          f"causal: {json.dumps(row)}; {row['ms'] / row['bound_ms']:.3f}x "
          f"its bound, {row['ms'] / row['library_ms']:.3f}x SDPA")
    return err, row


def dsv2_phase(seed: int, card: str) -> dict:
    """Phase 19: deepseek-v2-236b at full width cut in depth (`NEW_DEPTH`),
    every attention layer MLA on flash_attention's (192, 128) path;
    returns that path's row of the kernels line. Its 58.4 GB of weights
    leave about 20 GB: the allocator's cached blocks are given back before
    the model is drawn and before its corpus is scored (a scoring call's
    MoE layers hold about 10 GB)."""
    torch.cuda.empty_cache()
    print(f"device memory allocated before phase 19: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    err, row = flash_mla_phase(seed)
    cfg = new_config(DSV2)
    full = get_config(DSV2)
    print(f"{DSV2}: {cfg.num_layers} of {full.num_layers} layers (the dense "
          f"block and {cfg.num_layers - cfg.first_k_dense} MLA + MoE blocks)"
          f", {modellib.count_params_analytic(cfg)} parameters, "
          f"{modellib.count_params_analytic(cfg, active_only=True)} active "
          f"(the published config: {full.param_count()}, "
          f"{full.active_param_count()} active)")
    model = init_model(cfg, seed)
    per_prefill = {"flash_attention": cfg.num_layers}
    with mock.patch.dict(PLAIN, {"flash_attention": (
            (attention,), plain_attention_by_heads)}):
        model_phase(model, cfg, seed, per_prefill, f32_copy=False)
    decode_consistency(model, cfg, seed, DECODE_BF16_TOL[DSV2], "bf16")
    decode_times(model, cfg, NEW_DECODE_ROWS[DSV2], NEW_DECODE_LENGTH, seed,
                 card)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches = score_select_phase(model, cfg, seed, N_DSV2_CORPUS,
                                  per_prefill,
                                  DSV2_SCORE_BATCH)["flash_attention"]
    print(f"{DSV2} scoring: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({card})")
    del model
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg, num_layers=DSV2_F32_LAYERS,
                              dtype="float32")
    print(f"{DSV2} in float32, cut to {cut.num_layers} layers at full width "
          f"({modellib.count_params_analytic(cut)} parameters):")
    f32 = init_model(cut, seed)
    decode_consistency(f32, cut, seed, DECODE_F32_TOL, "float32")
    del f32
    torch.cuda.empty_cache()
    return {"launches": per_prefill["flash_attention"] + launches,
            "max_abs_err": err, **row}


# -- phase 20 ------------------------------------------------------------------

FA_MUSICGEN = (4, 4096, 24, 24, 64)    # musicgen-medium's prefill attention
# flash_attention's backward against its plain backward (phase 20), at
# smollm's and musicgen's training shapes and a ragged S, causal and not.
FA_BWD_CASES = ((FA_PREFILL, True), (FA_MUSICGEN, True),
                ((2, 1000, 15, 5, 64), True), ((2, 1000, 15, 5, 64), False),
                ((2, 1000, 12, 2, 64), True),
                # the wider pairs: yi-6b's and llama4's training attention
                # at (128, 128), deepseek-v2's MLA at (192, 128) (held by
                # groups of KV heads, as phase 19 holds the forward), and a
                # ragged S at each, causal and not
                (FA_YI, True), (FA_LLAMA4, True), (FA_DSV2, True),
                ((2, 1000, 12, 2, 128), True), ((2, 1000, 12, 2, 128), False),
                ((2, 1000, 12, 2, 192, 128), True),
                ((2, 1000, 12, 2, 192, 128), False))
# The kernel sums in float32 and rounds dq, dk and dv once; in bf16 it
# rounds P and dS to bf16 before the products that take them, as the
# forward rounds p before p·v. The plain backward computes in float32 from
# the same inputs and is compared before it rounds. So in bf16 each output
# lies within one rounding, BF16_RTOL |plain|, plus what P's and dS's
# roundings move, which BWD_BF16_ATOL bounds; in float32 (the CUDA-core
# kernels, no rounding between the products) within the forward's F32_TOL
# abs + rel. The wgmma kernels, P from the forward's lse, over
# FA_BWD_CASES at --seed 0 on an H100 80GB HBM3 at 700 W: |err| - 2^-7
# |plain| at most 9.50e-3 (dv at (2, 1000, 12/2); BWD_BF16_ATOL is 2.1
# times that), ||err|| / ||plain|| 2.314e-3 to 2.377e-3 (the bar is about
# twice), float32 at most 3.81e-6 abs. The mma.sync kernels they replaced,
# which recomputed the statistics, read at most 9.04e-3 and 2.283e-3 to
# 2.378e-3 at --seed 0, 1 and 2; the CUDA-core kernels before those 7.13e-7
# over one rounding: their excess was the float32 sums' alone.
BWD_BF16_ATOL = 2e-2
BWD_BF16_FRO_TOL = 5e-3
# The wider pairs' bar on |err| - 2^-7 |plain| (the norm's bar stays
# BWD_BF16_FRO_TOL). Their readings over FA_BWD_CASES' wider cases at
# --seed 0, 1 and 2 on an H100 80GB HBM3 at 700 W: at most 1.444e-2 (dv at
# yi-6b's shape, seed 2; 1.314e-2 and 1.278e-2 at seeds 0 and 1), so
# 2.08 times the largest; ||err|| / ||plain|| 2.287e-3 to 2.366e-3. The
# excess grows with the GQA group (8 query heads a KV head at yi-6b's
# shape, 3 at smollm's): dv sums P·dO over all of them.
BWD_BF16_ATOL_WIDE = 3e-2
# The forward kernel's lse against the plain lse of the same inputs (abs +
# rel): both sum the same products in float32 in other orders, and the
# kernel's exp2 is the hardware's approximation. Over FA_BWD_CASES at
# --seed 0 on an H100 80GB HBM3 at 700 W the largest reading was 1.91e-6
# at |lse| <= 9.3, in bf16 and float32 alike.
LSE_TOL = 2e-5


def plain_attention_bwd(q, k, v, o, do, causal=True):
    """The backward's plain version in the kernel's (B,S,H,d) layout, in
    float32 from the same inputs (not rounded to their dtype)."""
    return [t.transpose(1, 2) for t in fa_ref.attention_bwd_ref(
        *(x.float().transpose(1, 2) for x in (q, k, v, o, do)), causal)]


# Attention with more query heads than this is held against its plain
# versions by groups of whole KV heads of at most DSV2_PLAIN_HEADS query
# heads (phase 20): yi-6b's 32 heads would hold 8.6 GB of float32 scores
# a copy, deepseek-v2's 128 heads 34 GB.
PLAIN_WHOLE_HEADS = 24


def by_kv_groups(fn, q, k, v, *rest, causal=True):
    """`fn(q, k, v, *rest, causal)` over groups of whole KV heads (the
    rest laid out as q), its outputs joined on the heads axis: one call
    where q has at most PLAIN_WHOLE_HEADS heads. `fn` returns a list of
    tensors, each (B,S,heads,d) (query heads, or KV heads where it is
    k's or v's size)."""
    h, kv = q.shape[2], k.shape[2]
    if h <= PLAIN_WHOLE_HEADS:
        return fn(q, k, v, *rest, causal)
    g = h // kv
    n = max(1, DSV2_PLAIN_HEADS // g)
    parts = [fn(q[:, :, j * g:(j + n) * g], k[:, :, j:j + n],
                v[:, :, j:j + n],
                *(x[:, :, j * g:(j + n) * g] for x in rest), causal)
             for j in range(0, kv, n)]
    return [torch.cat(ts, dim=2) for ts in zip(*parts)]


def plain_lse(q, k, v, causal=True):
    """The plain lse (B,S,H,1) of (q, k, v) from the same inputs in
    float32."""
    _, lse = fa_ref.attention_ref(
        *(x.float().transpose(1, 2) for x in (q, k, v)), causal,
        return_lse=True)
    return [lse.transpose(1, 2)[..., None]]


def hold_flash_bwd(shape, dtype, causal: bool, g) -> float:
    """The forward kernel's lse and dq, dk and dv of the backward kernel
    (given that lse) on standard normal q, k, v and dO at `shape` against
    the plain lse and backward (by groups of KV heads past
    PLAIN_WHOLE_HEADS heads): the lse within LSE_TOL abs + rel; in bf16
    each output within BWD_BF16_ATOL (BWD_BF16_ATOL_WIDE at the wider
    pairs) + BF16_RTOL |plain| and each tensor within BWD_BF16_FRO_TOL of
    its norm, in float32 within F32_TOL abs + rel; two calls equal bit for
    bit, each counted once. Returns the largest |kernel - plain| of dq,
    dk and dv."""
    q, k, v = attention_inputs(shape, dtype, g)
    o, lse = fa_ops.flash_attention_fwd(q, k, v, causal=causal)
    do = torch.randn(o.shape, generator=g, device=DEVICE).to(dtype)
    before = fa_ops.bwd_launches.count
    got = fa_ops.flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    again = fa_ops.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                       lse=lse)
    what = f"flash_attention_bwd {shape} {dtype} causal={causal}"
    check(fa_ops.bwd_launches.count == before + 2,
          f"{what}: two calls counted {fa_ops.bwd_launches.count - before}")
    want_lse = by_kv_groups(plain_lse, q, k, v, causal=causal)[0]
    want_lse = want_lse[..., 0].transpose(1, 2)
    torch.cuda.synchronize()
    lse_err = float((lse - want_lse).abs().max())
    check(bool(((lse - want_lse).abs()
                <= LSE_TOL + LSE_TOL * want_lse.abs()).all()),
          f"{what}: the forward's lse {lse_err:.4g} from the plain lse")
    del want_lse
    plain = by_kv_groups(plain_attention_bwd, q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{what}: two calls differ")
    atol = BWD_BF16_ATOL if q.shape[3] == 64 else BWD_BF16_ATOL_WIDE
    worst, readings = 0.0, []
    for name, a, w in zip(("dq", "dk", "dv"), got, plain):
        err = (a.float() - w).abs()
        worst = max(worst, float(err.max()))
        if dtype == torch.bfloat16:
            excess = float((err - BF16_RTOL * w.abs()).max())
            fro = float(err.norm() / w.norm())
            check(excess <= atol and fro <= BWD_BF16_FRO_TOL,
                  f"{what} {name}: |err| - 2^-7 |plain| up to {excess:.4g} "
                  f"(tol {atol}), ||err|| / ||plain|| {fro:.4g} "
                  f"(tol {BWD_BF16_FRO_TOL})")
            readings.append(f"{name} excess {excess:.4g} fro {fro:.4g}")
        else:
            check(bool((err <= F32_TOL + F32_TOL * w.abs()).all()),
                  f"{what} {name}: max |err| {float(err.max()):.4g}")
            readings.append(f"{name} max {float(err.max()):.4g}")
    print(f"{what}: the forward's lse within {lse_err:.4g} of the plain "
          f"lse (tol {LSE_TOL} abs + rel); max |kernel - plain| "
          f"{worst:.6g}; " + ", ".join(readings)
          + "; two calls bitwise equal")
    del q, k, v, o, lse, do, got, again, plain
    return worst


def fused_sdpa_bwd_ms(qt, kt, vt, dot) -> float:
    """ms of the backward of `scaled_dot_product_attention` (causal) on
    (B,H,S,d) tensors by its fastest fused backend, each backend alone,
    its time or refusal printed; fails if none runs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    times = {}
    for name in SDPA_FUSED:
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                out = F.scaled_dot_product_attention(*leaves, is_causal=True)
                times[name] = cuda_ms(lambda: torch.autograd.grad(
                    out, leaves, dot, retain_graph=True), 10)
        except RuntimeError as e:          # this backend takes no such input
            print(f"  scaled_dot_product_attention backward {name}: refused "
                  f"({str(e).strip().splitlines()[0][:120]})")
    check(bool(times), "no fused scaled_dot_product_attention backward ran")
    best = min(times, key=times.get)
    print("  scaled_dot_product_attention backward by backend: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
          + f"; library_ms is {best}'s")
    return times[best]


def flash_bwd_row(shape, seed: int) -> dict:
    """The backward kernel's time at `shape` ((B, S, H, KV, dh) or (B, S,
    H, KV, dh, dv)), bf16 causal, from the forward's lse, beside its bound
    (the gradient's five products, q·kᵀ again, dO·vᵀ, Pᵀ·dO, dSᵀ·q and
    dS·k over the causal half: B·H·S²·(3 dh + 2 dv), 2.5 times the
    forward's where dv = dh; q, k, v, o, dO and the lse read, dq, dk and dv
    written once) and the time of the products its design runs at the
    card's peak (seven at (64, 64), eight at the wider pairs), the plain
    backward's time (by groups of KV heads past PLAIN_WHOLE_HEADS heads)
    and the backward of `scaled_dot_product_attention` by its fastest
    fused backend."""
    b, s, h, kv, dh = shape[:5]
    dv = shape[5] if len(shape) > 5 else dh
    g = torch.Generator(device=DEVICE).manual_seed(seed + 17)
    q, k, v = attention_inputs(shape, torch.bfloat16, g)
    o, lse = fa_ops.flash_attention_fwd(q, k, v)
    do = torch.randn(o.shape, generator=g, device=DEVICE).to(q.dtype)
    ms = cuda_ms(lambda: fa_ops.flash_attention_bwd(q, k, v, o, do,
                                                    lse=lse), 10)
    plain_ms = cuda_ms(lambda: by_kv_groups(plain_attention_bwd, q, k, v, o,
                                            do), 2)
    group = h // kv
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in
                       (q, k.repeat_interleave(group, dim=2),
                        v.repeat_interleave(group, dim=2), do))
    lib_ms = fused_sdpa_bwd_ms(qt, kt, vt, dot)
    del qt, kt, vt, dot
    ops = b * h * s * s * (3 * dh + 2 * dv)
    extra = dh if fa_ops.BWD_DKDV_LAUNCHES[dh] > 1 else 0
    design = b * h * s * s * (4 * dh + 3 * dv + extra)
    n_products = 7 + (extra > 0)
    moved = 2 * 2 * (q.numel() + k.numel() + v.numel() + o.numel()) \
        + 4 * lse.numel()
    t_ops = ops / BF16_OPS_PER_S * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes \
        else (t_bytes, "bytes")
    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_ms}
    t_design = design / BF16_OPS_PER_S * 1e3
    print(f"flash_attention_bwd at (B, S, H, KV, dh, dv) = "
          f"{(b, s, h, kv, dh, dv)}, bf16 causal: {json.dumps(row)}; its "
          f"{n_products} products at "
          f"the card's peak {t_design:.4f} ms ({t_design / ms:.3f} of its "
          f"time), the five of the bound {t_ops / ms:.3f}; "
          f"{ms / lib_ms:.3f}x the library's")
    del q, k, v, o, lse, do
    return row


def flash_bwd_phase(seed: int) -> tuple:
    """Phase 20: the backward kernel against its plain backward over
    FA_BWD_CASES, and its times at the training shapes; returns ({shape:
    the largest |kernel - plain| in bf16}, {shape: the row of times}) at
    smollm's, musicgen's, yi-6b's, llama4's and deepseek-v2's shapes."""
    g = torch.Generator(device=DEVICE).manual_seed(seed + 19)
    errs = {}
    for shape, causal in FA_BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            e = hold_flash_bwd(shape, dtype, causal, g)
            if dtype == torch.bfloat16 and causal:
                errs[shape] = e
            torch.cuda.empty_cache()
    rows = {}
    for shape in (FA_PREFILL, FA_MUSICGEN, FA_YI, FA_LLAMA4, FA_DSV2):
        rows[shape] = flash_bwd_row(shape, seed)
        torch.cuda.empty_cache()
    return errs, rows


# -- phase 21 ------------------------------------------------------------------

N_MUSICGEN_CORPUS = 1 << 12            # token records musicgen scores
# musicgen-medium's KV cache is 9.66 GB a row at 32768 positions (48 layers,
# 24 heads of 64, bf16): six rows and its 3.67 GB of weights fit under
# DECODE_PEAK_BYTES.
MUSICGEN_DECODE_ROWS = 6
# Its training cell: (4, 4096) x 4 codebooks a step, two microbatches,
# remat="block"; one untimed step, then TRAIN_STEPS timed.
TRAIN_SHAPE = (4, 4096)
TRAIN_ACCUM = 2
TRAIN_STEPS = 3
# A training step's device time by kernel group (`profile_call`).
TRAIN_GROUPS = {"dq_wgmma": "flash_attention_bwd",
                "dkdv_wgmma": "flash_attention_bwd",
                "flash_bf16": "flash_attention"}


def codebook_batches(cfg, seed: int, steps: int, shape):
    """`lm_batches` (B·K rows a step) as (B, S, K) tokens and labels: row
    b·K + k is codebook k of row b."""
    b, s = shape
    k = cfg.num_codebooks
    for batch in lm_batches(seed, steps, b * k, s, cfg.vocab_size):
        yield {key: np.ascontiguousarray(
            v.reshape(b, k, s).transpose(0, 2, 1)) for key, v in batch.items()}


def same_tensors(a: dict, b: dict) -> bool:
    """The same names, each with the same dtype and bits."""
    return a.keys() == b.keys() and all(
        a[n].dtype == b[n].dtype and torch.equal(a[n], b[n]) for n in a)


def train_cell(model, cfg, seed: int, card: str, steps: int = TRAIN_STEPS,
               profile: bool = True) -> dict:
    """Phases 21 and 24's training: `make_train_step` with remat and
    accumulation on `lm_batches` (by codebook where cfg has several); one
    untimed step, then `steps`; per step its wall, tokens/s, mfu by
    `train_flops_analytic`, peak device memory and flash_attention's
    forward and backward launches, exactly (a microbatch runs each
    layer's forward, its recompute and its backward once); then, with
    `profile`, one more step under the profiler. Returns the optimizer
    state and the last timed step's numbers, with the backward's launches
    over every step it ran before the profiled one (`bwd_launches`)."""
    opts = TrainOptions(grad_accum=TRAIN_ACCUM, adamw=adamw.AdamWConfig(
        lr=1e-4, warmup_steps=2, total_steps=100))
    step = make_train_step(cfg, opts)
    opt = adamw.init(model)
    b, s = TRAIN_SHAPE
    want = {"flash_attention": 2 * TRAIN_ACCUM * cfg.num_layers,
            "flash_attention_bwd": TRAIN_ACCUM * cfg.num_layers}
    flops = modellib.train_flops_analytic(cfg, b, s)
    batches = (codebook_batches(cfg, seed, steps + 1, TRAIN_SHAPE)
               if cfg.num_codebooks > 1
               else lm_batches(seed, steps + 1, b, s, cfg.vocab_size))
    out, bwd = {}, 0
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(want)
        t0 = time.perf_counter()
        model, opt, met = step(model, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: COUNTERS[name].count for name in want}
        check(launches == want, f"{cfg.name} train step {i} launched "
              f"{launches}, expected {want}")
        bwd += launches["flash_attention_bwd"]
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        check(math.isfinite(loss) and math.isfinite(gnorm),
              f"{cfg.name} train step {i}: loss {loss}, grad_norm {gnorm}")
        out = {"wall_s": wall, "tokens_s": b * s / wall,
               "mfu": flops / wall / BF16_OPS_PER_S,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "loss": loss, "grad_norm": gnorm}
        books = (f" x {cfg.num_codebooks} codebooks"
                 if cfg.num_codebooks > 1 else "")
        print(f"{cfg.name} train step {i}{' (warm-up)' if i == 0 else ''}: "
              f"({b}, {s}){books}, grad_accum "
              f"{TRAIN_ACCUM}, remat {cfg.remat}: loss {loss:.5f}, ce "
              f"{float(met['ce']):.5f}, grad_norm {gnorm:.5f}, lr "
              f"{float(met['lr']):.3g}; wall {wall:.4f} s, "
              f"{out['tokens_s']:.1f} tokens/s, mfu {out['mfu']:.4f} "
              f"(train_flops_analytic {flops:.4g}), peak "
              f"{out['peak_gb']:.2f} GB, launches {launches} ({card})")
    out["bwd_launches"] = bwd
    if not profile:
        return opt, out
    state = [opt]

    def profiled():
        state[0] = step(model, state[0], batch)[1]
    profile_call(profiled, TRAIN_GROUPS, f"one {cfg.name} train step")
    return state[0], out


def checkpoint_round_trip(model, opt, step: int, root: pathlib.Path,
                          card: str) -> None:
    """A `CheckpointManager` save and restore of `model` and its AdamW
    state on the card: the same tensors back."""
    mgr = CheckpointManager(root)
    t0 = time.perf_counter()
    mgr.save(step, model, opt)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    model2, opt2, step2, _ = mgr.restore()
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    params = dict(model.named_parameters())
    params2 = dict(model2.named_parameters())
    check(all(t.device.type == "cuda" for t in params2.values()),
          f"{model.cfg.name} checkpoint restored off the card")
    check(step2 == step and same_tensors(params, params2)
          and same_tensors(opt.mu, opt2.mu) and same_tensors(opt.nu, opt2.nu)
          and torch.equal(opt.step, opt2.step),
          f"{model.cfg.name} checkpoint round trip changed a tensor")
    size = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
    print(f"{model.cfg.name} checkpoint at step {step}: {size / 1e9:.2f} GB "
          f"(weights and AdamW moments) saved in {t_save:.2f} s, restored "
          f"onto the card in {t_restore:.2f} s, every tensor equal ({card})")
    del model2, opt2


def musicgen_phase(seed: int, card: str, root: pathlib.Path) -> int:
    """Phase 21: musicgen-medium at full width (48 layers, bf16): a (4,
    4096, K=4) prefill with its logits against plain attention, a scored
    2^12-record corpus and one RT query, decode against the prefill and a
    step at 32768 positions, TRAIN_STEPS train steps, and a checkpoint
    round trip. Returns flash_attention's launches on its prefill and
    scoring path."""
    cfg = get_config(MUSICGEN)
    print(f"{MUSICGEN}: {modellib.count_params_analytic(cfg)} parameters "
          f"(count_params_analytic)")
    model = init_model(cfg, seed)
    per_prefill = {"flash_attention": cfg.num_layers}
    model_phase(model, cfg, seed, per_prefill)
    launches = score_select_phase(model, cfg, seed, N_MUSICGEN_CORPUS,
                                  per_prefill)["flash_attention"]
    decode_consistency(model, cfg, seed, DECODE_BF16_TOL[cfg.name], "bf16")
    decode_times(model, cfg, MUSICGEN_DECODE_ROWS, NEW_DECODE_LENGTH, seed,
                 card)
    torch.cuda.empty_cache()
    opt, _ = train_cell(model, cfg, seed, card)
    checkpoint_round_trip(model, opt, int(opt.step), root, card)
    del model, opt
    torch.cuda.empty_cache()
    return per_prefill["flash_attention"] + launches


# -- phase 22 ------------------------------------------------------------------

# smollm-360m trained into a proxy on phase 7's corpus, as the JAX
# package's examples/selection_service.py trains its small one: class-
# balanced batches of PROXY_HALF positives and PROXY_HALF negatives drawn
# from the first half of the corpus, the class label at every position,
# AdamW without weight decay. The bar: the trained proxy's AUC on the
# records no batch drew.
PROXY_HALF = 32
PROXY_STEPS = 120
PROXY_LR = 3e-4
PROXY_WARMUP = 20
PROXY_FAIL_AT = 70          # one injected restart, after the first checkpoint
PROXY_AUC = 0.9


def proxy_phase(seed: int, card: str, random_init: dict,
                root: pathlib.Path) -> int:
    """Phase 22: smollm-360m at full width trained through `TrainLoop`
    (a `CheckpointManager` save every PROXY_STEPS / 2 steps, one injected
    restart that restores the last one), then phase 7's corpus scored and
    one RT query selected; the AUC over the records no batch drew, and the
    query's recall and oracle calls, beside phase 7's random-init proxy's.
    Returns the backward kernel's launches in training."""
    cfg = get_config(ARCH)
    model = init_model(cfg, seed)
    tokens, labels = token_corpus(cfg, N_CORPUS, seed)
    truth = labels > 0.5
    half = N_CORPUS // 2
    pools = (np.nonzero(truth[:half])[0], np.nonzero(~truth[:half])[0])
    drawn = np.zeros(N_CORPUS, bool)

    def make_batch(rng, step):
        idx = np.concatenate([rng.choice(pool, PROXY_HALF) for pool in pools])
        y = labels[idx].astype(np.int32)
        return {"tokens": tokens[idx], "idx": idx,
                "labels": np.repeat(y[:, None], SEQ_LEN, axis=1)}

    step = make_train_step(cfg, TrainOptions(adamw=adamw.AdamWConfig(
        lr=PROXY_LR, warmup_steps=PROXY_WARMUP, total_steps=PROXY_STEPS,
        weight_decay=0.0)))
    calls, step_s = [0], [0.0]

    def step_fn(m, o, batch):
        calls[0] += 1
        if calls[0] == PROXY_FAIL_AT + 1:
            raise RestartRequired("injected failure")
        drawn[batch["idx"]] = True
        t0 = time.perf_counter()
        out = step(m, o, batch)
        torch.cuda.synchronize()
        step_s[0] += time.perf_counter() - t0
        return out

    def on_step(i, met):
        if i % 20 == 0 or i == PROXY_STEPS:
            print(f"  proxy train step {i}: loss {float(met['loss']):.5f}, "
                  f"grad_norm {float(met['grad_norm']):.4f}")

    train_path = ("flash_attention", "flash_attention_bwd")
    reset_counts(train_path)
    mgr = CheckpointManager(root)
    loop = TrainLoop(step_fn, pipeline.DeterministicSource(make_batch, seed),
                     mgr, LoopConfig(total_steps=PROXY_STEPS,
                                     ckpt_every=PROXY_STEPS // 2),
                     on_step=on_step)
    t0 = time.perf_counter()
    model, opt, n = loop.run(model, adamw.init(model))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(mgr.latest_step() == PROXY_STEPS, "the last checkpoint is missing")
    launches = {k: COUNTERS[k].count for k in train_path}
    steps_run = PROXY_STEPS + PROXY_FAIL_AT - PROXY_STEPS // 2
    check(n == PROXY_STEPS and loop.restarts == 1
          and launches["flash_attention_bwd"] == steps_run * cfg.num_layers,
          f"proxy training: {n} steps, {loop.restarts} restarts, launches "
          f"{launches}")
    tokens_s = steps_run * 2 * PROXY_HALF * SEQ_LEN / step_s[0]
    mfu = steps_run * modellib.train_flops_analytic(
        cfg, 2 * PROXY_HALF, SEQ_LEN) / step_s[0] / BF16_OPS_PER_S
    print(f"{cfg.name} trained through TrainLoop: {PROXY_STEPS} steps of "
          f"{2 * PROXY_HALF} x {SEQ_LEN} tokens ({steps_run} run, one "
          f"restart from step {PROXY_STEPS // 2}'s checkpoint), lr "
          f"{PROXY_LR}, warmup {PROXY_WARMUP}, in {wall:.2f} s: the steps "
          f"{step_s[0]:.2f} s ({step_s[0] / steps_run:.4f} s a step, "
          f"{tokens_s:.1f} tokens/s, train mfu {mfu:.4f}), checkpoints and "
          f"the restore {wall - step_s[0]:.2f} s; launches {launches} "
          f"({card})")
    trained = {}
    score_select_phase(model, cfg, seed, N_CORPUS,
                       {"flash_attention": cfg.num_layers}, result=trained)
    held = ~drawn
    auc = roc_auc(trained["scores"][held], truth[held])
    auc0 = roc_auc(random_init["scores"][held], truth[held])
    print(f"proxy AUC over the {int(held.sum())} records no batch drew "
          f"({int(truth[held].sum())} positive): trained {auc:.4f}, phase "
          f"7's random-init {auc0:.4f} (bar {PROXY_AUC}); RT 0.9: trained "
          f"recall {trained['recall']:.4f} with {trained['oracle_calls']} "
          f"oracle calls, random-init recall {random_init['recall']:.4f} "
          f"with {random_init['oracle_calls']}")
    check(auc >= PROXY_AUC, f"the trained proxy's AUC {auc:.4f} < "
          f"{PROXY_AUC}")
    batch = make_batch(np.random.default_rng(seed), 0)
    profile_call(lambda: step(model, opt, batch), TRAIN_GROUPS,
                 f"one more {cfg.name} train step ({2 * PROXY_HALF} x "
                 f"{SEQ_LEN} tokens)")
    del model, opt
    torch.cuda.empty_cache()
    return launches["flash_attention_bwd"]

# -- phase 23 ------------------------------------------------------------------

# Four gloo ranks share the card as a (2, 2) ("data", "model") mesh, each
# data shard a (4, 4096) batch: context-parallel attention at smollm-360m's
# (15/5 heads, 64) and deepseek-v2's MLA (128/128 heads, (192, 128)) widths,
# the expert-parallel MoE at deepseek-v2's MoE widths (`DSV2_MOE`, 80
# experts a model rank) on EP_TOKENS a data shard, and the row-parallel
# matmul at yi-6b's wo on ROW_X a data shard.
MESH_SHAPE = (2, 2)
MESH_RANKS = 4
MESH_JOIN_S = 300
CP_SHAPES = (FA_PREFILL, FA_DSV2)
EP_TOKENS = (2, 4096)
ROW_X = (1, 4096, 4096)
ROW_W = (4096, 4096)
# The expert-parallel output against the dense `moe_apply` on the same data
# shard, which keeps the same assignments in the same slots: the two differ
# by bf16 roundings only. Each rank's partial adds its kept terms g·y in
# bf16 (g rounded, each product and each add rounded: k + 2 roundings of
# at most the token's T = |shared| + Σ g·|y|), the all-reduce of the m
# partials rounds once more and the shared experts' add once, where the
# dense path sums in float32 and rounds once: k + 5 bf16 unit roundoffs
# (2^-8) of T. Beyond those, the two bmms (80 experts a batch against 160)
# may accumulate g and u in another order, so that g, u and h round the
# other way, which moves y by more than its own rounding where the down
# projection's 1536 terms cancel. Measured against 13 roundings of T (T in
# float32, `moe_plain_f32` with absolute terms): 0.8746 to 0.9197 on the
# four ranks (--seed 0, H100 80GB HBM3 at 700 W). EP_ROUNDINGS is three
# times that; a token sent to another expert's weights, or dropped, moves
# its output by about T.
EP_ROUNDINGS = 40
# The row-parallel product against x·w in float32: each of the m = 2 local
# products rounds to bf16 once and their sum once more, so each output
# lies within ROW_ROUNDINGS bf16 unit roundoffs of (|x|·|w|) at that
# output.
ROW_ROUNDINGS = 2
BF16_U = 2.0 ** -8


def mesh_world_one(seed: int, card: str, root: pathlib.Path) -> None:
    """Phase 23 (a): smollm-360m on a (1, 1) mesh on nccl at world size 1:
    its specs, a checkpoint restored onto the mesh (each DTensor's full
    tensor the plain restore's, bit for bit), and a (4, 4096) prefill with
    shard_activations under the mesh, whose logits equal the prefill
    without one bit for bit (with one rank a group no parallel path
    engages)."""
    from torch.distributed.tensor import DTensor
    dist.init_process_group("nccl", store=dist.FileStore(
        str(root / "mesh_nccl"), 1), rank=0, world_size=1,
        device_id=torch.device(DEVICE, 0))
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"))
        cfg = get_config(ARCH)
        model = init_model(cfg, seed)
        specs = shardlib.param_specs(cfg, model, mesh)
        t0 = time.perf_counter()
        mgr = CheckpointManager(root / "mesh_ckpt", cfg=cfg)
        mgr.save(1, model)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain, _, _, _ = mgr.restore()
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_mesh, _, _, _ = mgr.restore(mesh=mesh, specs=specs)
        mesh_s = time.perf_counter() - t0
        want = dict(plain.named_parameters())
        orig = dict(model.named_parameters())
        n = 0
        for name, p in on_mesh.named_parameters():
            full = p.full_tensor()
            check(isinstance(p.data, DTensor) and torch.equal(full, want[name])
                  and torch.equal(full, orig[name]),
                  f"{name}: the restore onto the mesh differs")
            n += 1
        print(f"{cfg.name} on a (1, 1) nccl mesh: specs of {len(specs)} "
              f"parameters ({sum(any(e is not None for e in sp) for sp in specs.values())} "
              f"name a mesh axis), a checkpoint saved in {save_s:.2f} s, "
              f"restored plain in {plain_s:.2f} s and onto the mesh in "
              f"{mesh_s:.2f} s: {n} DTensors whose full tensors equal the "
              f"plain restore's and the saved model's bit for bit")
        del plain, on_mesh, want
        tokens = rand_tokens(cfg, FA_PREFILL[:2], torch.Generator(
            device=DEVICE).manual_seed(seed + 91))
        reset_counts(["flash_attention"])
        logits = modellib.last_logits(model, tokens)
        torch.cuda.synchronize()
        plain_launches = fa_ops.launches.count
        model.cfg = dataclasses.replace(cfg, shard_activations=True)
        reset_counts(["flash_attention"])
        with meshctx.mesh_context(mesh):
            on_mesh_logits = modellib.last_logits(model, tokens)
        torch.cuda.synchronize()
        launches = fa_ops.launches.count
        model.cfg = cfg
        check(plain_launches == launches == cfg.num_layers,
              f"flash_attention launches {plain_launches}, {launches}")
        check(torch.equal(logits, on_mesh_logits),
              "the prefill under the (1, 1) mesh differs from the one "
              "without a mesh")
        print(f"{cfg.name} (4, 4096) prefill with shard_activations under "
              f"the (1, 1) mesh: last-position logits equal the prefill "
              f"without a mesh bit for bit; launches "
              f"{{'flash_attention': {launches}}} ({card})")
        del model
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()


def cp_piece(q, k, v, lo: int, hi: int) -> tuple:
    """One model rank's context-parallel inputs: query rows [lo, hi) and
    keys [0, hi)."""
    return (q[:, lo:hi].contiguous(), k[:, :hi].contiguous(),
            v[:, :hi].contiguous())


def cp_piece_row(q, k, v, lo: int, hi: int, library: bool) -> dict:
    """One model rank's context-parallel launch (`cp_piece`) timed alone
    beside one launch over all rows and its bound; with `library` the
    plain version's time and SDPA's (lower-right causal)."""
    b, _, h, dh = q.shape
    dv = v.shape[3]
    piece = cp_piece(q, k, v, lo, hi)
    rows = hi - lo
    ms = device_ms(lambda: fa_ops.flash_attention(*piece), 20)
    full_ms = device_ms(lambda: fa_ops.flash_attention(q, k, v), 20)
    pairs = rows * lo + rows * (rows + 1) / 2
    ops = 2.0 * b * h * pairs * (dh + dv)
    moved = 2 * (sum(t.numel() for t in piece) + b * rows * h * dv)
    t_ops = ops / BF16_OPS_PER_S * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    row = {"ms": ms, "full_ms": full_ms, "sq": rows, "sk": hi,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if dh == dv and library:
        row["plain_ms"] = cuda_ms(lambda: plain_attention(*piece), 3)
        group = h // k.shape[2]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (
            piece[0], piece[1].repeat_interleave(group, dim=2),
            piece[2].repeat_interleave(group, dim=2)))
        row["library_ms"] = fused_sdpa_ms(qt, kt, vt, lower_right=True)
    return row


def _mesh_rank(rank: int, world: int, root: str, seed: int) -> None:
    """One of the gloo ranks of phase 23's (2, 2) mesh on the card; writes
    what it measured to ``mesh<r>.json``. Nothing is caught: a failed
    check or launch ends the rank with an error."""
    t_spawned = float((pathlib.Path(root) / "spawned").read_text())
    root = pathlib.Path(root)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(
        str(root / "mesh_gloo"), world), rank=rank, world_size=world)
    torch.zeros(1, device=DEVICE)
    t_init = time.time()
    try:
        mesh = make_test_mesh(MESH_SHAPE, ("data", "model"))
        d = mesh.get_local_rank("data")
        m = mesh.get_local_rank("model")
        m_size = MESH_SHAPE[1]
        out = {"data": d, "model": m,
               "steps_s": {"start": t_init - t_spawned}}

        # context-parallel attention: the main path's launches
        inputs = {shape: attention_inputs(shape, torch.bfloat16,
                                          torch.Generator(device=DEVICE)
                                          .manual_seed(seed + 61 + d))
                  for shape in CP_SHAPES}
        reset_counts(["flash_attention"])
        t0 = time.perf_counter()
        with meshctx.mesh_context(mesh):
            cp = {shape: attention.context_parallel_attention(
                *inputs[shape], m_size=m_size) for shape in CP_SHAPES}
        torch.cuda.synchronize()
        out["cp_s"] = time.perf_counter() - t0
        out["launches"] = fa_ops.launches.count
        out["cp"] = {}
        for shape in CP_SHAPES:
            q, k, v = inputs[shape]
            full = fa_ops.flash_attention(q, k, v)
            rows = q.shape[1] // m_size
            entry = {"bitwise": torch.equal(cp[shape], full)}
            del full
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for turn in range(world):    # held and timed alone, in turns
                dist.barrier()
                if turn == rank:
                    lo, hi = m * rows, (m + 1) * rows
                    entry["max_abs_err"] = hold_flash(
                        *cp_piece(q, k, v, lo, hi), True,
                        f"mesh rank {rank} context-parallel flash_attention "
                        f"{shape} rows [{lo}, {hi}) keys [0, {hi})",
                        plain_attention if q.shape[3] == v.shape[3]
                        else plain_attention_by_heads)
                    entry.update(cp_piece_row(q, k, v, lo, hi, False))
                    torch.cuda.synchronize()
            dist.barrier()
            out["cp"][str(shape)] = entry
            out["steps_s"][f"times at {shape}"] = time.perf_counter() - t1
        out["steps_s"]["cp and its checks"] = time.perf_counter() - t0
        del inputs, cp
        torch.cuda.empty_cache()

        # expert-parallel MoE
        t0 = time.perf_counter()
        cfg = dataclasses.replace(DSV2_MOE, shard_activations=True)
        p = moe.init_moe(DSV2_MOE, generator=torch.Generator(device=DEVICE)
                         .manual_seed(seed + 41), device=DEVICE)
        xs = [torch.randn(*EP_TOKENS, cfg.d_model, device=DEVICE,
                          generator=torch.Generator(device=DEVICE)
                          .manual_seed(seed + 71 + i)).to(torch.bfloat16)
              for i in range(MESH_SHAPE[0])]
        x = xs[d]
        dist.barrier()
        out["steps_s"]["ep's weights"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with meshctx.mesh_context(mesh):
            out_ep, aux_ep = moe.moe_apply(p, cfg, x, "softmax")
        torch.cuda.synchronize()
        out["ep_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense = [moe.moe_apply(p, DSV2_MOE, xi, "softmax") for xi in xs]
        out_d = dense[d][0]
        aux_mean = sum(a for _, a in dense) / len(dense)
        n, k = x.shape[0] * x.shape[1], cfg.num_experts_per_tok
        ids, gates, _ = moe.top_k_routing(
            layers.matmul(x.reshape(n, -1).float(), p.router), k, "softmax")
        cap = moe.capacity(cfg, n)
        e_loc = cfg.num_experts // m_size
        kept = {}
        for name, (order, _, _, keep) in (
                ("dense", moe.dispatch(ids, cfg.num_experts, cap)),
                ("ep", moe.local_dispatch(ids, m * e_loc, e_loc, cap))):
            flat = torch.zeros(n * k, dtype=torch.bool, device=DEVICE)
            flat[order] = keep
            kept[name] = flat.reshape(n, k)
        mine = (ids >= m * e_loc) & (ids < (m + 1) * e_loc)
        check(torch.equal(kept["ep"], kept["dense"] & mine),
              f"rank {rank}: the expert-parallel kept set differs")
        terms = moe_plain_f32(p, DSV2_MOE, x, ids, gates, kept["dense"],
                              absolute=True)
        diff = (out_ep.reshape(n, -1).float()
                - out_d.reshape(n, -1).float()).abs()
        out["ep_ratio"] = float((diff / (EP_ROUNDINGS * BF16_U * terms
                                         + 1e-30)).max())
        out["ep_max_abs"] = float(diff.max())
        out["ep_kept"] = int(kept["ep"].sum())
        out["ep_cap"] = cap
        out["aux"] = (float(aux_ep), float(aux_mean))
        check(out["ep_ratio"] <= 1.0 and bool(torch.isfinite(out_ep).all()),
              f"rank {rank}: expert-parallel output {out['ep_ratio']:.4g} of "
              "its bar")
        check(abs(float(aux_ep) - float(aux_mean))
              <= 1e-6 * abs(float(aux_mean)),
              f"rank {rank}: aux {float(aux_ep)} vs {float(aux_mean)}")
        del p, xs, x, dense, out_ep, out_d, terms, diff
        torch.cuda.empty_cache()
        out["steps_s"]["ep's check"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # the row-parallel matmul at yi-6b's wo
        row_cfg = dataclasses.replace(get_config("yi-6b"),
                                      shard_activations=True)
        w = (torch.randn(*ROW_W, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(seed + 81)) / 64).to(torch.bfloat16)
        x = torch.randn(*ROW_X, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(seed + 83 + d)).to(torch.bfloat16)
        with meshctx.mesh_context(mesh):
            rp = layers.matmul_rowparallel(x, w, row_cfg)
        whole = layers.matmul(x, w)
        ref32 = x.float() @ w.float()
        abs32 = x.float().abs() @ w.float().abs()
        out["row_ratio"] = float(((rp.float() - ref32).abs()
                                  / (ROW_ROUNDINGS * BF16_U * abs32
                                     + 1e-30)).max())
        out["row_vs_whole"] = float((rp.float() - whole.float()).abs().max())
        check(out["row_ratio"] <= 1.0,
              f"rank {rank}: row-parallel {out['row_ratio']:.4g} of its bar")
        dist.barrier()
        out["steps_s"]["row-parallel"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    (root / f"mesh{rank}.json").write_text(json.dumps(out))


def mesh_phase(seed: int, card: str) -> dict:
    """Phase 23: launch and sharding on torch DeviceMesh (see the module's
    docstring). Returns the context-parallel row of the kernels line (its
    launches, all ranks', from the main path's run; its times the longest
    piece's at smollm-360m's shape, the last model rank's, timed in this
    process; its max_abs_err the largest |kernel - plain| of every
    rank's pieces at both shapes, each held to phase 5's bf16 bars)."""
    with tempfile.TemporaryDirectory() as tmpdir:
        root = pathlib.Path(tmpdir)
        mesh_world_one(seed, card, root)
        t0 = time.perf_counter()
        (root / "spawned").write_text(repr(time.time()))
        ctx = tmp.start_processes(_mesh_rank, args=(MESH_RANKS, str(root),
                                                    seed),
                                  nprocs=MESH_RANKS, join=False,
                                  start_method="spawn")
        deadline = time.monotonic() + MESH_JOIN_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                check(False, f"the mesh ranks did not end in {MESH_JOIN_S} s")
        ranks = [json.loads((root / f"mesh{r}.json").read_text())
                 for r in range(MESH_RANKS)]
    wall = time.perf_counter() - t0
    for r, got in enumerate(ranks):
        check(got["launches"] == len(CP_SHAPES),
              f"mesh rank {r} launched flash_attention {got['launches']} "
              f"times, not {len(CP_SHAPES)}")
        for shape, e in got["cp"].items():
            check(e["bitwise"], f"mesh rank {r}: context-parallel attention "
                  f"at {shape} differs from one launch over all rows")
            extra = (f", plain {e['plain_ms']:.4f} ms, SDPA (lower-right "
                     f"causal) {e['library_ms']:.4f} ms"
                     if "plain_ms" in e else "")
            print(f"mesh rank {r} (data {got['data']}, model {got['model']})"
                  f" context-parallel attention at {shape}: one launch of "
                  f"Sq {e['sq']}, Sk {e['sk']} in {e['ms']:.4f} ms (one "
                  f"launch over the shard's rows {e['full_ms']:.4f} ms; "
                  f"bound {e['bound_ms']:.4f} "
                  f"ms, {e['bound_by']}{extra}); held against the plain "
                  f"version, max |kernel - plain| {e['max_abs_err']:.4g}; "
                  f"gathered rows == the full launch bit for bit")
        print(f"mesh rank {r}: expert-parallel MoE in {got['ep_s']:.3f} s, "
              f"capacity {got['ep_cap']}, {got['ep_kept']} kept assignments "
              f"== the dense path's on its experts; output within "
              f"{got['ep_ratio']:.4g} of its bar ({EP_ROUNDINGS} bf16 "
              f"roundings of |shared| + Σ g|y|), max |ep - dense| "
              f"{got['ep_max_abs']:.4g}; aux {got['aux'][0]:.8g} vs the "
              f"dense shards' mean {got['aux'][1]:.8g}; row-parallel wo "
              f"within {got['row_ratio']:.4g} of its bar ({ROW_ROUNDINGS} "
              f"bf16 roundings of |x|·|w|), max |row-parallel - whole| "
              f"{got['row_vs_whole']:.4g}; launches {{'flash_attention': "
              f"{got['launches']}}} in the main path; steps (s) "
              + ", ".join(f"{k} {v:.2f}" for k, v in got["steps_s"].items())
              + f" ({card})")
    print(f"mesh ranks: {MESH_RANKS} gloo ranks on CUDA tensors as a "
          f"{MESH_SHAPE} mesh, started, run and joined in {wall:.2f} s")
    # the kernels line's times: the longest piece at smollm-360m's shape
    # (the last model rank's), here in the main process
    q, k, v = attention_inputs(FA_PREFILL, torch.bfloat16, torch.Generator(
        device=DEVICE).manual_seed(seed + 61))
    s, m_size = FA_PREFILL[1], MESH_SHAPE[1]
    e = cp_piece_row(q, k, v, s - s // m_size, s, True)
    print(f"context-parallel attention at {FA_PREFILL}, the last model "
          f"rank's launch (Sq {e['sq']}, Sk {e['sk']}) in the main process: "
          f"{e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, SDPA "
          f"(lower-right causal) {e['library_ms']:.4f} ms, bound "
          f"{e['bound_ms']:.4f} ms ({e['bound_by']}) ({card})")
    del q, k, v
    return {"launches": sum(got["launches"] for got in ranks),
            "max_abs_err": max(e["max_abs_err"] for got in ranks
                               for e in got["cp"].values()),
            **{key: e[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}}

def cp_kernel_row(cp_row: dict) -> dict:
    """The kernels line's row of context-parallel attention (phase 23)."""
    return {"name": "flash_attention_cp", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:94 (a rank's query rows against "
                        "the keys up to its last row, Sk > Sq)", **cp_row}


# -- phase 24 ------------------------------------------------------------------

# Training at the backward kernel's wider pairs, at full width, cut in
# depth to what one card holds beside AdamW's float32 moments and the
# float32 gradient sums of two microbatches: yi-6b (attention at (128,
# 128)) cut to 8 of its 32 layers, 1.91e9 parameters; deepseek-v2-236b
# (MLA at (192, 128)) cut to its first block, the dense one (MLA and a
# dense MLP), 1.39e9 parameters with the embeddings and the head (one MoE
# block would add about 4.0e9, 48 GB with its moments). TRAIN_WIDE_STEPS
# timed steps each after one warm-up step, no profile.
TRAIN_WIDE = {"yi-6b": 8, DSV2: 1}
TRAIN_WIDE_STEPS = 1


def wide_train_phase(seed: int, card: str) -> dict:
    """Phase 24: `make_train_step` with remat="block" and grad_accum
    TRAIN_ACCUM at TRAIN_SHAPE for each config of TRAIN_WIDE, through
    phase 21's `train_cell`: flash_attention exactly twice and its
    backward once a layer a microbatch, loss and grad_norm finite, each
    step's wall, tokens/s, train mfu and peak memory printed. Returns
    {arch: flash_attention_bwd launches over its steps}."""
    launches = {}
    for arch, depth in TRAIN_WIDE.items():
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config(arch), num_layers=depth,
                                  remat="block")
        dims = attention_head_dims(cfg)
        print(f"{arch} cut to {depth} of {get_config(arch).num_layers} "
              f"layers at full width: {modellib.count_params_analytic(cfg)} "
              f"parameters, attention at (dh, dv) = {dims}")
        model = init_model(cfg, seed)
        _, out = train_cell(model, cfg, seed, card, steps=TRAIN_WIDE_STEPS,
                            profile=False)
        launches[arch] = out["bwd_launches"]
        print(f"phase 24 {arch}: {json.dumps(out)} ({card})")
        del model
        torch.cuda.empty_cache()
    return launches


def bwd_kernel_row(name: str, shape, launches: int, errs: dict,
                   rows: dict) -> dict:
    """A row of the kernels line for the backward kernel at `shape`."""
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:94 (its gradient, which "
                        "the JAX package takes by autodiff of jnp "
                        "attention)",
            "launches": launches, "max_abs_err": errs[shape], **rows[shape]}


class Phases:
    """Wall time of each phase, printed as it ends and summed at the end."""

    def __init__(self):
        self.walls = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        self.walls[name] = time.perf_counter() - t0
        print(f"-- phase {name}: {self.walls[name]:.1f} s")

    def total(self) -> str:
        """Every phase's wall time and their sum, on one line."""
        return ("phase wall s: " + ", ".join(
            f"{k} {v:.1f}" for k, v in self.walls.items())
            + f"; total {sum(self.walls.values()):.1f}")


def main() -> None:
    """Run every phase; exits non-zero on the first failure."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    t_start = time.perf_counter()
    check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    card = device_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    phase = Phases()

    with phase("build"):
        names = _build.sources()

        def timed_load(name):
            t0 = time.perf_counter()
            _build.load(name)
            return time.perf_counter() - t0
        with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
            # one nvcc each, all at once
            build_s = dict(zip(names, pool.map(timed_load, names)))
        print(f"built {names}")
        for name in names:
            print(f"  {name}: built in {build_s[name]:.1f} s")
            for line in ptxas_report(_build.build_log(name)):
                print(f"    {line}")

    with phase("2-4 engine kernels, engine, times"):
        t0 = time.perf_counter()
        scores, labels = make_beta_on_device(N_RECORDS, 0.01, 1.0,
                                             seed=args.seed, device=DEVICE)
        torch.cuda.synchronize()
        print(f"corpus: {N_RECORDS} Beta(0.01, 1) scores drawn on the card "
              f"in {time.perf_counter() - t0:.2f} s, positive rate "
              f"{labels.mean():.5f}")

        g = torch.Generator(device=DEVICE).manual_seed(args.seed + 7)
        chunk = scores[:CHUNK].clone()
        chunk[torch.rand(CHUNK, device=DEVICE, generator=g) < 0.01] = -1.0
        errs = check_kernels(chunk, g)
        small_agreement(args.seed)

        sh_ops.launches.reset()
        ts_ops.launches.reset()
        results, walls = engine_phase(scores, labels, args.seed)
        launches = {"score_hist": sh_ops.launches.count,
                    "threshold_select": ts_ops.launches.count}
        n_chunks = results[1]["engine"].plan.total_chunks
        check(launches["score_hist"] >= 2 * n_chunks,
              f"score_hist launched {launches['score_hist']} times for two "
              f"builds of {n_chunks} chunks")
        check(launches["threshold_select"] >= 2 * len(QUERIES) * n_chunks,
              f"threshold_select launched {launches['threshold_select']} "
              "times")
        print(f"main path launches: {launches}")
        print("wall s: " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in walls.items()))

        tau_rt = results[1]["RT"].tau
        times, byts = kernel_times(results[1]["engine"]._state.flat, tau_rt,
                                   g)
        build_times(scores, n_chunks)
        del results, scores, chunk

    with phase("5 flash_attention"):
        fa_err = check_flash(args.seed)
    with phase("6-7 smollm-360m prefill, score and select"):
        cfg = get_config(ARCH)
        model = init_model(cfg, args.seed)
        model_phase(model, cfg, args.seed,
                    {"flash_attention": cfg.num_layers})
        random_init = {}
        fa_launches = score_select_phase(
            model, cfg, args.seed, N_CORPUS,
            {"flash_attention": cfg.num_layers},
            result=random_init)["flash_attention"]
        profile_scoring_call(model, cfg, args.seed,
                             {"flash_bf16": "flash_attention"})
        del model
    with phase("8 flash_attention times"):
        fa_rows = {shape: flash_row(shape, args.seed)
                   for shape in (FA_PREFILL, FA_SCORING, FA_ZAMBA,
                                 FA_ZAMBA_SCORING)}
        for shape in (FA_SCORING, FA_ZAMBA, FA_ZAMBA_SCORING):
            print(f"flash_attention at (B, S, H, KV, dh) = {shape}, bf16 "
                  f"causal: {json.dumps(fa_rows[shape])}")
        for shape in fa_rows:
            lse_store_ms(shape, args.seed)

    with phase("9 linear_scan"):
        ls_err = check_scan(args.seed)
    with phase("10-11 zamba2-1.2b prefill, score and select"):
        cfg = get_config(ZAMBA)
        n_super = transformer.zamba_layout(cfg)[0]
        per_prefill = {"linear_scan": cfg.num_layers,
                       "flash_attention": n_super}
        model = init_model(cfg, args.seed)
        model_phase(model, cfg, args.seed, per_prefill)
        ls_launches = score_select_phase(model, cfg, args.seed,
                                         N_ZAMBA_CORPUS, per_prefill)[
            "linear_scan"]
        profile_scoring_call(model, cfg, args.seed,
                             {"scan_kernel": "linear_scan",
                              "chunked_kernel": "linear_scan",
                              "flash_bf16": "flash_attention"})
        del model
    with phase("12 linear_scan times"):
        ls_rows = {shape: scan_row(shape, args.seed)
                   for shape in (LS_PREFILL, LS_SCORING)}
        print(f"linear_scan at the scoring shape (B, H, S, dk, dv) = "
              f"{LS_SCORING}, zamba2 layout: "
              f"{json.dumps(ls_rows[LS_SCORING])}")
    live_name = "13 sessions and the live plane"
    with phase(live_name):
        t0 = time.perf_counter()
        scores, labels = make_beta_on_device(N_RECORDS, 0.01, 1.0,
                                             seed=args.seed, device=DEVICE)
        torch.cuda.synchronize()
        print(f"corpus: phase 3's {N_RECORDS} scores drawn again on the "
              f"card in {time.perf_counter() - t0:.2f} s")
        live = live_phase(scores, labels, args.seed, card)
    print(f"phase 13 wall: {phase.walls[live_name]:.3f} s ({card})")
    serve_name = "14 the server, its journal and restore"
    with phase(serve_name):
        serve_phase(scores, labels, live, args.seed, card)
        del scores, labels, live
    print(f"phase 14 wall: {phase.walls[serve_name]:.3f} s ({card})")
    array_name = "15 single-array queries and the distributed plane"
    with phase(array_name):
        array_phase(args.seed, card)
    print(f"phase 15 wall: {phase.walls[array_name]:.3f} s ({card})")
    rwkv_name = "16 rwkv6-7b prefill, score and select"
    with phase(rwkv_name):
        channel_row = rwkv_phase(args.seed, card)
    print(f"phase 16 wall: {phase.walls[rwkv_name]:.3f} s ({card})")
    decode_name = "17 decode"
    with phase(decode_name):
        decode_phase(args.seed, card)
    print(f"phase 17 wall: {phase.walls[decode_name]:.3f} s ({card})")
    new_name = "18 dense configs and the MoE layer at head dim 128"
    with phase(new_name):
        dh128_row = new_configs_phase(args.seed, card)
    print(f"phase 18 wall: {phase.walls[new_name]:.3f} s ({card})")
    dsv2_name = "19 deepseek-v2-236b: MLA on flash_attention at (192, 128)"
    with phase(dsv2_name):
        mla_row = dsv2_phase(args.seed, card)
    print(f"phase 19 wall: {phase.walls[dsv2_name]:.3f} s ({card})")
    with tempfile.TemporaryDirectory() as tmpdir:
        root = pathlib.Path(tmpdir)
        bwd_name = "20 flash_attention backward"
        with phase(bwd_name):
            bwd_errs, bwd_rows = flash_bwd_phase(args.seed)
        music_name = "21 musicgen-medium: prefill, decode, train, checkpoint"
        with phase(music_name):
            musicgen_phase(args.seed, card, root / "musicgen")
        proxy_name = "22 smollm-360m trained into a proxy"
        with phase(proxy_name):
            bwd_launches = proxy_phase(args.seed, card, random_init,
                                       root / "proxy")
    mesh_name = "23 launch and sharding on a DeviceMesh"
    with phase(mesh_name):
        cp_row = mesh_phase(args.seed, card)
    wide_name = "24 train at head dim 128 and MLA"
    with phase(wide_name):
        wide_launches = wide_train_phase(args.seed, card)
    for name in (bwd_name, music_name, proxy_name, mesh_name, wide_name):
        print(f"phase {name.split()[0]} wall: {phase.walls[name]:.3f} s "
              f"({card})")
    print(phase.total())
    print(f"whole run wall: {time.perf_counter() - t_start:.1f} s ({card})")

    rows = []
    for name, source, replaces in (
            ("score_hist", "score_hist.cu", "score_hist/score_hist.py:74"),
            ("threshold_select", "threshold_select.cu",
             "threshold_select/threshold_select.py:78")):
        ms, plain_ms, lib_ms = times[name]
        b_ms, b_by = bound(name, CHUNK, byts[name])
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{source}",
                     "replaces": f"src/repro/kernels/{replaces}",
                     "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms})
    rows.append({"name": "flash_attention", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention/"
                             "flash_attention.py:94",
                 "launches": fa_launches, "max_abs_err": fa_err,
                 **fa_rows[FA_PREFILL]})
    rows.append({"name": "linear_scan", "route": "cuda",
                 "source": "src/repro_torch/csrc/linear_scan_chunked.cu",
                 "replaces": "src/repro/kernels/linear_scan/"
                             "linear_scan.py:108",
                 "launches": ls_launches, "max_abs_err": ls_err,
                 **ls_rows[LS_PREFILL]})
    rows.append({"name": "flash_attention_dh128", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention/"
                             "flash_attention.py:94", **dh128_row})
    rows.append({"name": "linear_scan_channel", "route": "cuda",
                 "source": "src/repro_torch/csrc/linear_scan.cu",
                 "replaces": "src/repro/kernels/linear_scan/"
                             "linear_scan.py:108", **channel_row})
    rows.append({"name": "flash_attention_mla", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention/"
                             "flash_attention.py:94", **mla_row})
    rows.append(bwd_kernel_row("flash_attention_bwd", FA_PREFILL,
                               bwd_launches, bwd_errs, bwd_rows))
    rows.append(cp_kernel_row(cp_row))
    rows.append(bwd_kernel_row("flash_attention_bwd_dh128", FA_YI,
                               wide_launches["yi-6b"], bwd_errs, bwd_rows))
    rows.append(bwd_kernel_row("flash_attention_bwd_mla", FA_DSV2,
                               wide_launches[DSV2], bwd_errs, bwd_rows))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
