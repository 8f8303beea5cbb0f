#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/csrc`` and runs:

(a) each kernel against its plain PyTorch version on the card, at the main
    path's shapes and at edge cases (l1_subgrad at n x m=d in {10 x 1000,
    100 x 1000, 3 x 257, 1 x 1024} within rtol 1e-5 / atol 1e-4 on inputs
    whose A x stays 1e-4 * ||A x||_inf away from 0, so that no sign may
    legitimately flip, logged where bit-equal (the plain version sums in the
    kernel's chunk order); block_topk bit-exact, incl. bf16, inf/NaN/-0.0/
    denormal payloads and the radix select's edge blocks: ties at the
    threshold, every |x| equal, fewer non-zeros than k, k = 1, k = b,
    b = 12288 (48 KB of keys), b = MAX_BLOCK, NaN with inf, two infs,
    denormals straddling the threshold, keys equal in their top 8/16/24
    bits), and two identical l1_subgrad launches bit-equal;
(b) the main path: ``repro_torch.fig1.run_suite(d=1000, n=10, T=400)`` (EF21-P/
    TopK and MARINA-P same/ind/perm, constant and Polyak stepsizes) and the
    port's quickstart at a 2e6-bit budget, with the launch counters zeroed
    just before and read just after; both kernels must have launched;
(c) the same 8 runs at T=10 on the CPU port against the card, same seeds:
    equal s2w_bits; MARINA-P's per-round f_x within rtol 1e-4; EF21-P's
    within rtol 1e-4 per step from the card's state of each round (its
    free-running TopK trajectory follows the last bits of gamma*g, see the
    note in the code, and is only reported); and the card's T=10 Polyak runs
    bit-equal to the first 10 rounds of (b) (their stepsize does not depend
    on T);
(d) each kernel's median time (CUDA events, L2 flushed between launches by a
    read), its plain version's and the library call's, beside its lower
    bound; the launch floor: one empty kernel (``torch.cuda._sleep(0)``) timed
    alike; and, for scale, l1_subgrad and A.sum() (a library read of the same
    A) with the L2 flushed by a write, as the earlier timer did;
(e) the wire kernels (pack_bits/unpack_bits, sparse_streams, dense_bits)
    against their plain versions on the card, all exact: pack/unpack at
    widths {1, 4, 7, 8, 10, 13, 16, 32} and N in {1, 31, 32, 33, 1000, 4097}
    (also against wire.bitstream.pack_u32, and unpack(pack) = identity), the
    stream kernels on random, random-bit-pattern and IEEE-corner inputs in
    fp32/fp16/bf16, and the device buffers of sparse_encode / dense_encode /
    encode_rows equal to the host codec's byte for byte, NaN payloads
    included;
(f) the wire path: ``marina_p.run(measure_wire=True)`` same/ind/perm with
    Polyak, T=400, and ``ef21p.run(measure_wire=True)`` with TopK and
    BlockTopK(16, 128), with the counters zeroed just before and read just
    after: pack_bits, sparse_streams and dense_bits must have launched
    (unpack_bits is on no run's path: nothing decodes there). Each run's
    hist["wire_bits"] must equal the same run with the host codec; then the
    first 20 rounds of each MARINA-P mode, stepped by hand, with device and
    host buffers compared byte for byte;
(g) the CPU port against the card at T=20: MARINA-P's wire_bits per round
    and wire-matched ledger equal (EF21-P's reported);
(h) ``repro_torch.wire_bench`` on the card (d=1024 n=4 and d=1000 n=10,
    T=200): every MARINA-P measured-vs-analytic gap below 5% (DESIGN §3.5);
(i) the wire kernels' times at the path's shapes and at d = 2**20, with
    bounds, launches per round, plain and library times, the host codec's
    time per message, and µs per round of MARINA-P ind with measure_wire,
    device encode against host encode;
(j) the four kernels of the encode and kernel benchmarks (bernk, rotk_apply,
    mask_streams, topk_streams) against their plain versions on the card, bit
    for bit: bernk in f32 and bf16 over keep probabilities {0.03, 0.1, 0.25,
    1/3, 0.9}, a seed and a worker above 2**31 and d in {1, 777, 1000, 2**16,
    2**20}; rotk_apply over d in {1000, 2**16, 2**20} (2**20: the 16-byte
    vector path), n in {3, 4, 10, 16} and r in {-3, 0, n+1}, w full of -0.0;
    mask_streams over 10 worker rows; topk_streams over block in
    {128, 1000, 1024} and k in {1, 64, >= block}, on random, tie-heavy,
    every-|x|-equal and top-24-bits-equal inputs; IEEE corners (denormals,
    +-0, +-inf, quiet and signalling NaNs) in the first input; rotk_apply_rows
    over n rows (n in {3, 4, 10, 16}, the same r, one -0.0 row broadcast) into
    a new tensor and into a view one column into a wider output; both rotk
    entries at column offsets 0, 1 and 3 of wider buffers and sizes
    ROTK_SIZES (n in {1, 3}); then each kernel at
    the settings and on the very inputs of (k)'s path (d = 2**16 and 2**14:
    topk_streams k=64 block=1024, one-row mask_streams and bernk at keep 1/16
    seed 7; kernel_bench's bernk and rotk_apply at 2**16), and on copies of
    them with IEEE corners;
(k) their path: ``repro_torch.wire_bench``'s codec, encode-roofline and
    encode-suite sections and ``repro_torch.kernel_bench.bench`` on the card,
    with the counters zeroed just before and read just after: all four must
    have launched, ``encode/byte_identical`` must read 1.0; then
    topk_encode, mask_encode and encode_per_worker (ind and same) buffers
    equal to the host codec over ops.block_topk / ops.bernk byte for byte,
    and a NaturalCompression output on the card exact powers of two (the
    NATURAL codec round-trips it);
(l) each of the four kernels' median time (CUDA events, L2 flushed) at the
    path's shapes (bernk and rotk_apply from kernel_bench's rows in (k)) and
    at 2**20, beside its bound and its plain version, and
    the host-clock time per message of the fused encoders against the host
    codec over the op.

(m) tracing: ``marina_p.run`` (perm, Polyak) and ``ef21p.run`` (TopK,
    constant gamma) at d=1000, n=10, T=50 with measure_wire, with a tracker
    (MemoryTracker + BenchJsonSink) and without: f_x and wire bits equal,
    ``analyze.validate_spans`` / ``validate_perfetto`` clean, one ``round``
    span a round, the BENCH document valid;
(n) the lossy transport: MARINA-P (perm, Polyak) and EF21-P (TopK, Polyak)
    through ``Fleet.make(10,
    transport_bench.CHAOS_SPEC)`` (10% drop, 2% corrupt, 10% reorder in a
    window of 4, seed 7), T=60, on the card and the CPU port at one seed:
    every event counter of hist["transport"] equal, goodput and the s2w
    ledger within rtol 1e-4 (a message's length follows the exact zeros of
    x_{t+1} - x_t, which may differ in a late round), MARINA-P's f_x within
    rtol 1e-4 a round, EF21-P's finite and falling; then
    ``repro_torch.transport_bench`` on the card;
(o) the fleet: ``fleet_run`` of MARINA-P (perm, Polyak) and EF21-P (TopK) at
    d=1000, population 50,000, cohort 16, T=2, measure_wire, on the
    flaky_mobile and two_tier_diurnal mixes (the evaluation cohort: 64
    clients, 256 MB of f32 on the card), card against CPU at one seed:
    participation stats, s2w, wire and join bits equal a round, MARINA-P's
    f_x within rtol 1e-4, EF21-P's finite and falling; and
    ``marina_p.run(participation=BernoulliStragglerPlan(0.2, 2.0))`` at n=10,
    d=1000 against the CPU. The counters are zeroed before (m) and read
    after (o): l1_subgrad, block_topk, sparse_streams, dense_bits and
    pack_bits must have launched there; µs a round of each path is printed
    with the card's name and power limit.

(p) the repairs on the card: ``rotk_apply`` and ``rotk_apply_rows`` in fp16
    and bf16 bit-exact against their plain versions at d = 2**16, n in {7,
    10, 16}, and d = 2**20, n = 7, r in {-3, 0, n+1}, IEEE corners (+-0,
    denormals, +-inf, NaNs, products that overflow the dtype) in w and in
    kept and dropped coordinates, both at misaligned offsets and odd sizes,
    and ``rotk_apply``'s times;
(q) the SPMD runner (``core/distributed.py``) as one NCCL rank at d = 1000,
    n = 100 (400 MB of A): MARINA-P same/ind/perm (Polyak), 50 rounds,
    against the single-process ``marina_p.make_step`` on the card fed the
    same ``MarinaPDraws``, x and W within 1e-4 every round; EF21-P/TopK
    teacher-forced per step (x and the k kept magnitudes every step, w
    where the k-th magnitude gap exceeds 1e-5); µs a round of both;
(r) the benchmark harness: ``repro_torch.run.main`` on the card for fig1,
    stepsize_grid, comm_complexity, kernels, wire, encode, transport and
    scenario; Table 2's n = 10 rows plus n = 100, s = 1 from (q)'s problem;
    ``trace_smoke`` through ``obs.analyze`` (spans, Perfetto, degraded
    rounds attributed); every BENCH document valid; then ``bench_diff``
    twice: against the reference's ``benchmarks/baselines`` for table2, wire,
    encode, transport and scenario, where a missing metric or a failing
    ``value`` gate fails and the ``us_per_call`` gates are printed, not
    enforced (those baselines were timed on a CPU in Pallas interpret mode);
    then those five and kernels against the port's own baselines from an
    H100 (``src/repro_torch/baselines``), every gate enforced, ``us_per_call``
    included. The counters
    are zeroed before (q) and read after (r): every kernel but unpack_bits
    (which only the serving path's decode reaches, (s)) must have launched
    there.

(s) the LM serving path (``repro_torch.models`` / ``serve``): (s1) for each
    of the ten smoke configs, 32 decode steps on the card against the CPU
    port from the same weights (within SERVE_DEV_RTOL / ATOL), decode
    against forward on the card for the eight families of
    test_decode_consistency (rtol = atol = 0.12, top-1 agreeing > 90%), and
    greedy decoding through the engine's CUDA graph deterministic; (s2)
    gemma3-1b at full width and depth (999,812,736 parameters, seeded
    ``lm_init``): 3 requests of batch 4, 576-token prompts (the 512-slot
    ring buffers wrap), 64 new tokens, with prefill / decode ms and tokens/s,
    and the decoded logits of the last 64 prompt positions against
    ``forward`` on the card; (s3) a 10**6-entry SPARSE delta over all its
    coordinates from ``kernels.encode.sparse_encode``, framed as DATA and
    applied by ``DecodeEngine.delta_sync``: ``decode_device`` bit-equal to
    the host ``wire.decode``, the masters = masters + delta bit for bit, the
    served logits moved, unpack_bits launched; at smoke width NATURAL,
    DENSE / SYNC, StaleDelta, SequenceGap, SEED and a non-finite payload
    refused before any change; (s4) the harness's serve suite
    (``repro_torch.run``) and ``bench_diff`` as in (r): the reference's
    ``value`` gates from ``benchmarks/baselines/BENCH_serve.json``, then every
    gate of ``src/repro_torch/baselines/BENCH_serve.json``. (s3)'s
    messages are built by the sender's encoders and held against the host
    codec before the counters are zeroed; the counters are zeroed before
    (s1) and read after (s4), and unpack_bits must have launched there (the
    replica's delta_sync is its only caller in that window). unpack_bits is
    timed at (s3)'s three streams after the read.

(t) the LM training path (``repro_torch.optim`` / ``data`` / ``train``):
    (t0) block_topk, rotk_apply and rotk_apply_rows (4 rows; f32, fp16,
    bf16) at every leaf size of demo-100m against their plain versions, both
    rotk entries at misaligned offsets and odd sizes, AdamW and SGD on the
    card against the CPU, all bit for bit; then, with the counters zeroed:
    (t1) each of the
    ten smoke configs, 2 workers, 3 marina:perm steps on the card against the
    CPU port from the same weights, batches and draws (losses within
    TRAIN_DEV_LOSS_ATOL); (t2) demo-100m at full width (``train_lm.model_100m``,
    119,550,720 parameters), 4 workers x batch 2 x seq 512, AdamW, 6 steps
    under each of marina:perm / ind / same, ef21p:128:1024 and none, and
    marina:perm with bf16 replicas: finite losses, RotK's exact mean after
    every no-sync round, one rotk_apply_rows launch a leaf in each compressed
    perm round, bits_per_worker equal to the formula, EF21-P's drift
    contracting at the final server; ms a step, tokens/s, peak memory, one
    step under the profiler; (t3)
    ``measure_wire`` at full width for a sync round and a compressed round of
    each mode and of EF21-P (device encode), with the measured-vs-analytic
    gap; (t4) ``train_loop`` through ``transport_bench.CHAOS_SPEC`` at
    tests/test_transport.py's tiny-LM width on the card and the CPU: every
    transport counter equal. The
    counters are read after (t4): block_topk, rotk_apply_rows (f32 and
    bf16), pack_bits, sparse_streams and dense_bits must have launched, the
    one-row rotk_apply never. Then (t3)'s device buffers against the host
    codec, byte for byte; block_topk, rotk_apply (f32, fp16, bf16),
    rotk_apply_rows (4 rows; f32, bf16) and the per-worker path it replaced
    timed at the largest leaf; and a whole perm round at full width on the
    rows path and on the per-worker path, in turns, the card's time (CUDA
    events behind a 10 ms spin) and the host clock's, outputs bit-equal.

(u) the dry-run (``repro_torch.launch``): (u0) ``python -m
    repro_torch.launch.dryrun --arch A`` for the ten architectures (one
    process each, all started together at (m) at the lowest CPU priority,
    collected here), every shape (train_4k, prefill_32k,
    decode_32k, long_500k) on the 16x16 mesh description, counted on
    ``meta``: 40 records, each valid (finite counts, a dominant H100
    roofline term, the useful-FLOPs ratio in range); (u1) gemma3-1b's four
    steps on the card at ``dryrun.REDUCED``'s sizes (``dryrun.measure_step``:
    the marina:perm train step with bf16 replicas, W = 2 x 1 x 4096;
    forward at 1 x 32768; the DecodeEngine's graph step at 16 x 32768 and
    1 x 524288): a finite output, ms (median of 5 CUDA-event times after 2),
    peak memory, the same reduced step counted on ``meta``, its bound on one
    H100, roofline_share and (train, prefill) mfu, merged into the records;
    the counters are zeroed before (u1) and read after it: rotk_apply_rows
    must have launched once a leaf a train step; (u2) ``repro_torch.run
    roofline`` over the records: BENCH_roofline.json valid, and the table.

(v) the port's last one-card entry points: (v1) ``python -m
    repro_torch.federated_l1`` (``main(["--out", tmp, "--device", "cuda"])``),
    the paper's reduced grid (d = 200, n = 10, noise s in {0.1, 1, 10}, 4e6
    downlink bits a worker; 8 runs a cell): 24 CSV rows under the reference's
    header, every run stopped at the first round at or past its budget; the
    s = 1 cell against the CPU port's ``fig1.run_suite`` (a process of its
    own, meanwhile): constant-stepsize MARINA-P f_x within TRAJ_RTOL every
    round with equal rounds and bits, EF21-P equal rounds and bits, Polyak
    MARINA-P bits within TRAJ_RTOL and rounds within one (their f_x gap is
    printed: a Polyak trajectory follows the last bits of gamma); (v2)
    ``python -m repro_torch.wire_bench --smoke`` exits 0; (v3)
    ``problems.sigma_A`` of (q)'s n = 100 problem, recomputed from its host
    matrices in a process of its own (started at (m), lowest CPU priority),
    equal to ``prob.sigma_A`` bit for bit. The counters are zeroed
    before (v1) and read after it (l1_subgrad and block_topk must have
    launched), then zeroed before (v2) and read after it (every kernel but
    the two rotk entries must have launched).

(w) the LM train step across a process group (``repro_torch.train.sharded``),
    (w1) beside (x2)'s processes, the rest after them:
    (w0) after (w1)'s counters are read and (x2) has ended, ``rotk_apply_rows``' block
    map (the perm downlink on a rank's blocks under tensor parallelism over
    "model") against its plain version bit for bit in f32, fp16 and bf16, at
    every block of demo-100m's leaves on a (1, 4) mesh, its two-level map at
    every block of them on (wk, data, model) = HIER_BLOCK_MESH, and at edge
    leaves of both, each also equal to the same columns of the whole leaf's
    launch, then both timed at demo-100m's largest many-run block beside
    the contiguous launch; (w1) as one NCCL rank (mesh (1, 1)), demo-100m at full width (TRAIN_W x
    TRAIN_B x TRAIN_S), AdamW, SHARDED_STEPS steps under marina:perm (bf16
    replicas), marina:ind and ef21p:128:1024, beside ``make_train_step``
    from the same state, batches and draws: state and metrics bit for bit
    every step, the collective bytes handed to NCCL equal to the dry-run's
    count of the same step on ``meta``, ms a step of both paths in turns; the
    counters are zeroed before (w1) and read around its sharded steps alone:
    rotk_apply_rows must launch once a leaf in each compressed perm round and
    block_topk once a leaf in each EF21-P step; (w2) 4 gloo processes on the
    one card on a (4, 1) mesh (demo-100m's marina:perm with bf16 replicas at
    full width, one compressed step, the smoke gemma-2b's marina:ind and
    ef21p) and a (2, 2) mesh
    with act_spec (the smoke gemma-2b, W = 4 x 2 x 64, all three), and, in
    the first group's processes after its (4, 1) cases, with tensor
    parallelism over "model" (demo-100m at full width, W = 2 x TP_B x TP_S,
    one compressed step: (1, 4) marina:perm with bf16 replicas, (2, 2)
    marina:ind;
    gemma3-1b at full width cut to 2 layers, one EF21-P step on (1, 4), rank
    0 alone holding the single process; rwkv6-1.6b and zamba2-1.2b at full
    width cut to 2 and 6 layers, RECURRENT_TP, one compressed marina:perm
    step with bf16 replicas each on (1, 4), W = 2, rank 0 alone holding the
    single process) and, in the second group's processes after its act_spec
    cases, the moe family's smoke configs (MOE_TP: deepseek-v2 and llama4,
    3 steps, marina:perm with bf16 replicas and ef21p on (1, 4) and (2, 2)),
    the act_spec step with experts (ACT_MOE, deepseek-v2 on (2, 2)), the
    multi-pod mesh (MULTIPOD, gemma-2b on (pod, data, model) = (2, 1, 2))
    and a product weight "model" does not split (WHOLE_TP: the smoke zamba2
    with a Mamba2 state of 17, its in_proj and conv_w whole on (1, 4));
    and a third group of 8 processes, the hierarchical mesh (HIER, gemma-2b
    on (wk, data, model) = (2, 2, 2), W = 2, marina:perm with bf16
    replicas: every rank its two-level blocks, rotk_apply_rows at least once
    a leaf in each compressed round), then deepseek-v2's smoke config on
    (1, 8) (WHOLE_TP8: its router and 4 experts whole, 3 steps); all within ``train/sharded_check``'s bounds of the single-process step (the
    CPU tests' own; under tensor parallelism ACT_BOUNDS or 1.5x the single
    process's own floor from the same run), rows at an offset or a rank's
    blocks launching rotk_apply_rows in a compressed perm round (every
    tensor-parallel perm case has one), block_topk in every EF21-P case on
    every rank, each case's peak memory a rank; only gloo's own refusal of
    the collectives on CUDA tensors, met by a probe before the steps, is
    logged in place of the run, and any other error in either group fails
    it; (w3) ``python -m repro_torch.launch.dryrun --arch gemma3-1b --shape
    train_4k`` (the default record: the tensor-parallel step) and the same
    with ``--train-act-model-sharded``, ``--multi-pod`` and
    ``--hierarchical-workers 4``, on ``meta``: per_rank records with their
    collective bytes by kind and a collective term, the last two the CPU's
    count exactly (MESH_COUNTS); and (u0)'s
    train_4k records of deepseek-v2-236b, llama4-maverick-400b-a17b,
    rwkv6-1.6b and zamba2-1.2b: per_rank, tensor parallel, their counts the
    CPU's exactly (TRAIN_COUNTS).

(x) the serving step across a process group (``repro_torch.serve.sharded``),
    run after (u): (x1) alone on the card, then (x2)'s processes beside (v)
    and (w1), all of it before the rest of (w):
    (x1) as one NCCL rank (mesh (1, 1), ``serve``), gemma3-1b at full width
    and depth: a prefill of SERVE_B x SERVE_S tokens and SERVE_STEPS
    teacher-forced decode steps from a seeded random cache of SERVE_CACHE
    positions (its local rings wrap), beside ``lm.forward`` /
    ``lm.decode_step`` on the same parameters: logits and caches bit for bit,
    greedy sampling equal, the bytes handed to NCCL equal to the count on
    ``meta`` (none: an axis of one rank runs no collective), ms a step of both
    paths in turns; then the moe family, MOE_ARCH (deepseek-v2-236b at full
    width, its first 2 blocks: MLA, the dense FFN, 160 experts top-6 and 2
    shared), MOE_B x MOE_S and MOE_STEPS decode steps: the single process on
    ``lm_init`` first (its dropped copies printed; (x2)'s single-process
    sides written to files), the whole model freed, then the rank's blocks
    from the seed (``init_params``) bit for bit, peak memory printed; then
    the ssm and hybrid families, rwkv6-1.6b and zamba2-1.2b at full width and
    depth as gemma3-1b (RECURRENT_ARCHS, peak memory printed); the counters
    are zeroed before (x1) and read after it;
    (x2) 4 gloo processes on the one card, gemma3-1b at full width on the
    (2, 2) ``serve``, (1, 4) ``tp`` and (4, 1) ``serve`` meshes (the last at
    B = 1, the caches' sequence split over "data"), then MOE_ARCH on (1, 4)
    ``tp`` at B = 4 and (2, 2) ``serve`` at B = 2 (every rank its blocks
    alone; the routed experts bit for bit the single process's rows), then
    rwkv6-1.6b and zamba2-1.2b at full width, their first RECURRENT_DEPTH
    layers, on the same two meshes (the floor includes the sharded
    arithmetic in one process, ``sharded_check.OneRank``) and at B = 1 on
    (4, 1) and (2, 2) ``serve`` (long_500k's split: the states, token shifts
    and conv windows over "data", gathered before each decode step reads
    them; rwkv6 on (4, 1) bit for bit), then gemma3-1b's first 4 layers (a
    scan segment of 4) at B = 4 on (2, 2) ``serve`` (the repetitions over
    "data", the rows too), each rank
    ``serve/sharded_check.run_case`` + ``hold`` (the CPU tests' own code,
    with ``card_bounds``, a bound for each case and number: logits and
    caches against the single process on the card, (2, 2) within 1.5 x the
    single process's own spread on the rank's rows, the (4, 1) prefill bit
    for bit; the first ``w_out`` product at full width rounded once, where
    bf16 partials would not be; bytes handed to gloo = counted; greedy over
    the vocabulary blocks equal to the gathered argmax and to the single
    process's tokens), each rank's peak memory and cache bytes at rest by
    their split printed; only gloo's own refusal of a
    CUDA collective, met by a probe, is logged in place of the run; (x3) gemma3-1b's prefill_32k,
    decode_32k and long_500k, the decode_32k of deepseek-v2-236b, rwkv6-1.6b and zamba2-1.2b and the
    long_500k of the last two on 16x16 under ``serve`` and ``tp``, one rank
    counted on ``meta`` (``python -m repro_torch.launch.dryrun``): per_rank
    records whose counts equal the CPU's (SERVE_COUNTS) exactly, with a
    collective term.

Prints a ``{"kernels": [...]}`` JSON line (launches: the path of each row
plus (m)-(o), (q)-(r), (s), (t), (u), (v), (w1) and (x1) (``sharded_path``: (w1)'s
own; ``serve_sharded_path``: (x1)'s own; ``dryrun_path``: (u)'s own;
``grid_path`` and ``wire_smoke_path``: (v1)'s and (v2)'s); the rotk_apply row names its dtypes, its numbers are float32's and
``by_dtype`` gives each dtype's; the rotk_apply_rows row's are 4 f32 rows of the largest leaf, with
``by_dtype`` for bf16, the per-worker path's time and a whole round's, and ``block_map`` (w0)'s checks and
times with (w2)'s perm launches by rank on a rank's blocks (``one_level`` / ``two_level``: each map's times,
the second's launches (w2)'s hierarchical case's); the block_topk row's ``sharded_tp_path`` (w2)'s
tensor-parallel EF21-P launches by rank; the unpack_bits row's ``serve_path`` gives
its (s) launches and its times at (s3)'s streams; every row's ``train_path``
its (t) launches, and block_topk's and rotk_apply's their times at the
largest leaf), then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Exits non-zero,
printing no result, where CUDA is unavailable or the port is missing.
"""
from __future__ import annotations

import atexit
import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet; valid at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

L1_RTOL, L1_ATOL = 1e-5, 1e-4
TRAJ_RTOL = 1e-4
WIDTHS = (1, 4, 7, 8, 10, 13, 16, 32)
MAGS = ("fp32", "fp16", "bf16")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def mark(phase: str) -> None:
    """One line at the start of a phase: the script's seconds so far."""
    log(f"-- {phase} starts at {time.perf_counter() - T_START:.1f} s")


_CHILDREN: list = []


def spawn(args, **kw) -> subprocess.Popen:
    """``subprocess.Popen(args, **kw)``, killed at exit with every process it
    started (a rank group's spawned ranks too) if it still runs: a failed
    phase exits before the phase that waits for it."""
    proc = subprocess.Popen(args, **kw)
    _CHILDREN.append(proc)
    return proc


def kill_tree(proc) -> None:
    """Kills ``proc`` and every process it started (read from /proc), then
    waits for it."""
    import os
    import signal

    children = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                continue
            children.setdefault(ppid, []).append(int(entry))
    tree, todo = [], [proc.pid]
    while todo:
        for pid in children.get(todo.pop(), []):
            tree.append(pid)
            todo.append(pid)
    if proc.poll() is None:
        proc.kill()
    for pid in tree:
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    proc.wait()


@atexit.register
def _stop_children() -> None:
    for proc in _CHILDREN:
        if proc.poll() is None:
            kill_tree(proc)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def l1_inputs(np, n: int, d: int, seed: int, shared: bool = False):
    """A [n, d, d], X [n, d] (fp32) with every |(A x)_r| >= 1e-4 ||A x||_inf:
    rows too close to 0 are pushed away along x, exactly in float64.
    ``shared``: one point x for all workers (every row of X equal)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, d, d))
    X = np.repeat(rng.standard_normal((1, d)), n, axis=0) if shared else rng.standard_normal((n, d))
    y = np.einsum("nij,nj->ni", A, X)
    scale = np.abs(y).max(axis=1, keepdims=True)
    bad = np.abs(y) < 2e-4 * scale
    push = np.where(y >= 0, 1.0, -1.0) * 4e-4 * scale - y
    A += np.where(bad, push, 0.0)[..., None] * (X / np.sum(X**2, axis=1, keepdims=True))[:, None, :]
    A, X = A.astype(np.float32), X.astype(np.float32)
    y32 = np.einsum("nij,nj->ni", A.astype(np.float64), X.astype(np.float64))
    if not (np.abs(y32) >= 1e-4 * np.abs(y32).max(axis=1, keepdims=True)).all():
        fail("l1_subgrad inputs: could not keep A x away from 0")
    return A, X


def edge_vector(np, torch, d: int = 128):
    """The Pallas-quirk vector: inf, NaN-free tail; plus -0.0 and denormals."""
    x = np.zeros(d, np.float32)
    x[:6] = [1.0, np.inf, 3.0, -2.0, 0.5, 7.0]
    x[10:16] = [-0.0, 1e-42, -1e-42, 6.1e-39, 2e-45, -3.0]
    return torch.from_numpy(x)


def radix_cases(np, torch, max_block: int):
    """(name, x, block, k) blocks that stress block_topk's radix select
    (csrc/topk_select.cuh), each in f32 and bf16: ties at the threshold, every
    |x| equal, fewer non-zeros than k, k = 1, k = b, b = 12288 and
    b = MAX_BLOCK (the 48 KB default and the 227 KB opt-in limit), NaN with
    inf, two infs, denormals straddling the threshold, and keys equal in their
    top 8, 16 and 24 bits (one per digit boundary: the threshold is fixed in
    pass 2, 3 and 4)."""
    rng = np.random.default_rng(23)
    cases = []
    ties = np.round(rng.standard_normal(2048) * 2) / 2
    cases.append(("ties at the threshold", ties, 1024, 150))
    cases.append(("every |x| equal", np.where(rng.random(1000) < 0.5, -0.75, 0.75), 1000, 100))
    few = np.zeros(1000)
    few[[3, 500, 999]] = [2.0, -1.0, 0.5]
    few[[0, 7, 998]] = -0.0
    cases.append(("fewer non-zeros than k", few, 1000, 100))
    cases.append(("k = 1", rng.standard_normal(3000), 1000, 1))
    cases.append(("k = b", rng.standard_normal(3000), 1000, 1000))
    cases.append(("b = 12288 (48 KB of keys)", rng.standard_normal(2 * 12288), 12288, 1000))
    big = rng.standard_normal(2 * max_block)
    big[max_block:] = np.round(big[max_block:] * 4) / 4
    cases.append(("b = MAX_BLOCK", big, max_block, 300))
    both = rng.standard_normal(256)
    both[[9, 200]] = [np.inf, np.nan]
    both[128 + 5], both[128 + 70] = -np.inf, np.nan
    cases.append(("NaN with inf", both, 128, 5))
    two = rng.standard_normal(256)
    two[[30, 60, 128 + 1, 128 + 127]] = [np.inf, -np.inf, -np.inf, np.inf]
    cases.append(("two infs", two, 128, 4))
    den = np.zeros(256)
    den[:12] = [1e-42, -1e-42, 6.1e-39, -6.1e-39, 2e-45, 1e-40, -1e-40, 1e-41, 3e-39, 0.0, -0.0, 1e-42]
    den[[20, 21]] = [1.0, -2.0]
    den[128:] = den[:128] * np.float32(0.5)
    cases.append(("denormals straddling the threshold", den, 128, 7))
    for bits in (8, 16, 24):
        low = rng.integers(0, 1 << (32 - bits - 1), 2000, dtype=np.int64)
        keys = ((0x3FC00000 >> (31 - bits)) << (31 - bits)) | low
        sign = rng.integers(0, 2, 2000, dtype=np.uint32) << 31
        cases.append((f"keys equal in their top {bits} bits",
                      (keys.astype(np.uint32) | sign).view(np.float32), 1000, 97))
    out = []
    for name, x, block, k in cases:
        xt = torch.from_numpy(np.asarray(x, np.float32))
        out += [(f"{name} f32", xt, block, k), (f"{name} bf16", xt.bfloat16(), block, k)]
    return out


def wire_edge(np):
    """tests/test_encode_diff.py's WEIRD plus quiet and signalling NaNs of
    both signs (0x7FC00000, 0xFFC00000, 0x7F812345, 0xFF800001)."""
    weird = np.array([np.nan, np.inf, -np.inf, -0.0, 1e-42, -1e-42, 0.0, 6.1e-39,
                      1.0000001, -3.5, 65504.0, 2.0], dtype=np.float32)
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F812345, 0xFF800001], dtype=np.uint32)
    return np.concatenate([weird, nans.view(np.float32)])


def bits_equal(torch, a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}[a.dtype]
    return torch.equal(a.view(view), b.view(view))


# ---------------------------------------------------------------------------
# the wire path (phases e-i)
# ---------------------------------------------------------------------------


def int_err(ref, got, want) -> int:
    """max |got - want| over uint32 bit patterns (0 when bit-equal)."""
    if got.shape != want.shape:
        return 2**32
    return int((ref.u32(got) - ref.u32(want)).abs().max()) if got.numel() else 0


def wire_kernels_vs_plain(np, torch, dev):
    """(e): every wire kernel against its plain version on the card, and the
    device buffers against the host codec. Returns {kernel: max int error}."""
    from repro_torch import wire
    from repro_torch.kernels import encode as kenc
    from repro_torch.kernels import ops, ref

    err = dict.fromkeys(("pack_bits", "unpack_bits", "sparse_streams", "dense_bits"), 0)
    rng = np.random.default_rng(2)
    for width in WIDTHS:
        for n in (1, 31, 32, 33, 1000, 4097):
            v = rng.integers(0, 2**width, n, dtype=np.uint64).astype(np.uint32)
            v[0] = 2**width - 1  # every bit of w set once
            vals = torch.from_numpy(v.view(np.int32)).to(dev)
            words = ops.pack_bits(vals, width)
            back = ops.unpack_bits(words, width, n)
            want_w = ref.pack_bits_ref(vals, width)
            want_b = ref.unpack_bits_ref(want_w, width, n)
            torch.cuda.synchronize()
            err["pack_bits"] = max(err["pack_bits"], int_err(ref, words, want_w))
            err["unpack_bits"] = max(err["unpack_bits"], int_err(ref, back, want_b))
            if not (torch.equal(words, want_w) and torch.equal(back, want_b) and torch.equal(back, vals)):
                fail(f"(e) pack/unpack width={width} n={n}: kernel != plain or unpack(pack) != identity")
            if words.cpu().numpy().tobytes() != wire.to_bytes(wire.pack_u32(v, width)):
                fail(f"(e) pack_bits width={width} n={n}: kernel != wire.bitstream.pack_u32")
        # rows with row strides, as encode_rows packs the streams into one buffer
        rows = torch.from_numpy(rng.integers(0, 2**width, (10, 1001), dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(dev)[:, :1000]
        out = torch.zeros((10, 3 + wire.n_words(1000, width)), dtype=torch.int32, device=dev)
        ops.pack_bits(rows, width, out=out[:, 1:-2])
        if not (torch.equal(out[:, 1:-2], ref.pack_bits_ref(rows, width))
                and not out[:, 0].any() and not out[:, -2:].any()):
            fail(f"(e) pack_bits width={width}: batched rows with strides != plain")

    edge = wire_edge(np)
    X = np.where(rng.random((10, 1000)) < 0.1, rng.standard_normal((10, 1000)), 0.0).astype(np.float32)
    X[0, :edge.size] = edge
    X[1] = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    X[2, 100:900] = 0.0
    X[2, :edge.size] = -edge
    Xd = torch.from_numpy(X).to(dev)
    for mag in MAGS:
        m = int(wire.mag_dtype(mag))
        got = kenc.sparse_streams(Xd, mag)
        want = ref.sparse_streams_ref(Xd, m)
        dbits = [kenc.dense_bits(Xd[r], mag) for r in range(3)]
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err["sparse_streams"] = max(err["sparse_streams"], int_err(ref, g, w))
            if not torch.equal(g, w):
                fail(f"(e) sparse_streams {mag}: kernel != plain")
        for r in range(3):
            w = ref.dense_bits_ref(Xd[r], m)
            err["dense_bits"] = max(err["dense_bits"], int_err(ref, dbits[r], w))
            if not torch.equal(dbits[r], w):
                fail(f"(e) dense_bits {mag} row {r}: kernel != plain")
        bufs = kenc.encode_rows(Xd, mag=mag)
        if bufs != [wire.encode_sparse(X[r], mag=mag) for r in range(10)]:
            fail(f"(e) encode_rows {mag}: device buffers != host codec")
        for r in range(3):
            for dev_buf, host_buf in ((kenc.sparse_encode(Xd[r], mag=mag), wire.encode_sparse(X[r], mag=mag)),
                                      (kenc.dense_encode(Xd[r], mag=mag), wire.encode_dense(X[r], mag=mag))):
                if dev_buf != host_buf:
                    fail(f"(e) {mag} row {r}: device buffer != host codec")
    return err


def marina_wire_rounds(np, torch, dev, prob, mode, k, p, omega, rounds):
    """(f): the first ``rounds`` rounds of a MARINA-P run stepped by hand as
    ``run`` steps them (same seed, same draws): the server's device buffers
    equal the host codec's byte for byte. Returns the number of buffers
    checked."""
    from repro_torch import wire
    from repro_torch.core import marina_p, stepsizes
    from repro_torch.kernels import encode as kenc

    step = marina_p.make_step(prob, mode, k, p, stepsizes.MarinaPPolyak(omega=omega, p=p, f_star=0.0),
                              return_q=True)
    bcast = marina_p.make_broadcast(mode, prob.n, k)
    state, gen = marina_p.init(prob.x0, prob.n), torch.Generator().manual_seed(0)
    checked = 0
    for t in range(rounds):
        draws = marina_p.draw_round(bcast, p, prob.d, gen, dev)
        state, m = step(state, draws)
        if draws.coin:
            dev_bufs, host_bufs = [kenc.dense_encode(m["x_new"])], [wire.encode_dense(m["x_new"])]
        elif mode == "same":
            dev_bufs, host_bufs = [kenc.sparse_encode(m["Q"][0])], [wire.encode_sparse(m["Q"][0])]
        else:
            Qh = m["Q"].cpu().numpy()
            dev_bufs, host_bufs = kenc.encode_rows(m["Q"]), [wire.encode_sparse(q) for q in Qh]
        if dev_bufs != host_bufs:
            fail(f"(f) marina_p {mode} round {t}: device buffers != host codec")
        checked += len(dev_bufs)
    return checked


def wire_runs(torch, prob, k, p, T, device_encode, runtime=None):
    """The five measure_wire runs of (f); with ``runtime``, also the
    launches each run made (a diff of the counters around it)."""
    from repro_torch.core import compressors as C
    from repro_torch.core import ef21p, marina_p, stepsizes

    D, N = prob.d, prob.n
    out, launches = {}, {}

    def record(name, fn):
        before = dict(runtime.LAUNCHES) if runtime else {}
        out[name] = fn()
        if runtime:
            torch.cuda.synchronize()
            launches[name] = {kk: v - before.get(kk, 0) for kk, v in runtime.LAUNCHES.items()}

    for mode, omega in (("same", D / k - 1.0), ("ind", D / k - 1.0), ("perm", float(N - 1))):
        record(f"marina_{mode}_polyak", lambda mode=mode, omega=omega: marina_p.run(
            prob, mode=mode, k=k, p=p, stepsize=stepsizes.MarinaPPolyak(omega=omega, p=p, f_star=0.0),
            T=T, seed=0, measure_wire=True, device_encode=device_encode))
    for name, comp in (("ef21p_topk_polyak", C.TopK(k=k)),
                       ("ef21p_block_topk_polyak", C.BlockTopK(k_per_block=16, block=128))):
        record(name, lambda comp=comp: ef21p.run(
            prob, comp, stepsizes.EF21PPolyak(alpha=comp.alpha(D), f_star=0.0), T=T, seed=0,
            measure_wire=True, device_encode=device_encode))
    return out, launches


# ---------------------------------------------------------------------------
# the encode- and kernel-benchmark path (phases j-l)
# ---------------------------------------------------------------------------

BENCH_KERNELS = ("bernk", "rotk_apply", "mask_streams", "topk_streams")
# rotk sizes at misaligned offsets: shorter than a head, one value a thread, and 16-byte vectors
# with a head and an odd tail (600,000 values: more than a block of vectors an SM in every dtype)
ROTK_SIZES = (1, 7, 1003, 4096, 600_000, 600_003)
BIG_SEED, BIG_WORKER = 2**31 + 12345, 2**31 + 7


def with_corners(np, rng, d: int, at: int = 0):
    """A standard normal fp32 vector of d values with :func:`wire_edge`'s
    IEEE corners (NaNs quiet and signalling, +-inf, +-0, denormals) at ``at``."""
    x = rng.standard_normal(d).astype(np.float32)
    c = wire_edge(np)[:max(0, d - at)]
    x[at:at + c.size] = c
    return x


def float_err(torch, got, want) -> float:
    """max |got - want| over the entries finite in both (0 when bit-equal)."""
    g, w = got.float(), want.float()
    finite = torch.isfinite(g) & torch.isfinite(w)
    return float((g - w).abs()[finite].max()) if bool(finite.any()) else 0.0


def rotk_rows_cases(np, torch, dev, what, w_rows, delta, n, rs=None):
    """``rotk_apply_rows`` against its plain version, bit for bit, for each r
    of ``rs`` (default -3, 0, n + 1): into a new tensor (16-byte vectors where
    w_rows and delta allow), and into a view one column into a wider output
    (no common alignment: one value at a time), whose other columns stay
    untouched. Returns (max abs error, cases)."""
    from repro_torch.kernels import ops, ref

    err, cases = 0.0, 0
    R, s = w_rows.shape
    for r in (-3, 0, n + 1) if rs is None else rs:
        rot = torch.tensor([r], dtype=torch.int32, device=dev)
        want = ref.rotk_apply_rows_ref(w_rows, delta, rot, n=n)
        wide = torch.full((R, s + 2), 7.0, dtype=w_rows.dtype, device=dev)
        for got in (ops.rotk_apply_rows(w_rows, delta, rot, n=n),
                    ops.rotk_apply_rows(w_rows, delta, rot, n=n, out=wide[:, 1:1 + s])):
            torch.cuda.synchronize()
            err = max(err, float_err(torch, got, want))
            if not bits_equal(torch, got, want):
                iv = torch.int16 if got.element_size() == 2 else torch.int32
                bad = (got.view(iv) != want.view(iv)).nonzero()[:4].tolist()
                fail(f"{what} rotk_apply_rows {w_rows.dtype} R={R} s={s} n={n} r={r}: kernel != plain at {bad}")
            cases += 1
        if not bool((wide[:, 0] == 7).all() and (wide[:, -1] == 7).all()):
            fail(f"{what} rotk_apply_rows R={R} s={s} n={n} r={r}: wrote outside out")
    return err, cases


def rotk_offsets_vs_plain(np, torch, dev, what, sizes, n, dtypes):
    """Both rotk entries at column offsets 0, 1 and 3 of wider buffers (1 and
    3: off the 16-byte grid) and at ``sizes`` (odd ones leave a tail, tiny
    ones are shorter than the head), bit for bit against their plain
    versions: the rows entry with delta at w's offset (16-byte vectors after a
    head of single values where the row stride holds whole vectors) and at
    offset 0 (no common alignment), writing into a view of a wider output
    whose other columns stay untouched, and for one row; the single-row
    entry on each row. Returns ({kernel: max abs error}, cases)."""
    from repro_torch.kernels import ops, ref

    err, cases = {"rotk_apply": 0.0, "rotk_apply_rows": 0.0}, 0
    gen = torch.Generator(dev).manual_seed(17)
    rot = torch.tensor([n + 1], dtype=torch.int32, device=dev)

    def check(kname, tag, got, want):
        nonlocal cases
        torch.cuda.synchronize()
        err[kname] = max(err[kname], float_err(torch, got, want))
        if not bits_equal(torch, got, want):
            fail(f"{what} {kname} {tag}: kernel != plain")
        cases += 1

    for dtype in dtypes:
        for s in sizes:
            W = torch.randn(n, s + 8, generator=gen, device=dev).to(dtype)
            D = torch.randn(s + 8, generator=gen, device=dev).to(dtype)
            for c in (0, 1, 3):
                tag = f"{dtype} n={n} s={s} offset {c}"
                w, delta = W[:, c:c + s], D[c:c + s]
                for dl, how in ((delta, "delta at w's offset"), (delta.clone(), "delta at offset 0")):
                    want = ref.rotk_apply_rows_ref(w, dl, rot, n=n)
                    wide = torch.full_like(W, 7.0)
                    check("rotk_apply_rows", f"{tag}, {how}",
                          ops.rotk_apply_rows(w, dl, rot, n=n, out=wide[:, c:c + s]), want)
                    if not (bool((wide[:, :c] == 7).all()) and bool((wide[:, c + s:] == 7).all())):
                        fail(f"{what} rotk_apply_rows {tag}: wrote outside out")
                    check("rotk_apply_rows", f"{tag}, {how}, one row",
                          ops.rotk_apply_rows(w[:1], dl, rot, n=n), want[:1])
                for i in range(n):
                    check("rotk_apply", f"{tag} worker {i}", ops.rotk_apply(W[i, c:c + s], delta, rot, n=n, worker=i),
                          ref.rotk_apply_ref(W[i, c:c + s], delta, rot, n=n, worker=i))
    return err, cases


def bench_kernels_vs_plain(np, torch, dev):
    """(j): each kernel against its plain version on the card, bit for bit.
    Returns ({kernel: max abs error}, number of cases)."""
    from repro_torch import wire
    from repro_torch.kernels import encode as kenc
    from repro_torch.kernels import ops, ref

    err = dict.fromkeys(BENCH_KERNELS + ("rotk_apply_rows",), 0.0)
    cases = 0
    rng = np.random.default_rng(13)
    for dtype in (torch.float32, torch.bfloat16):
        for d in (1, 777, 1000, 2**16, 2**20):
            x = torch.from_numpy(with_corners(np, rng, d)).to(dev).to(dtype)
            for kp in (0.03, 0.1, 0.25, 1 / 3, 0.9):
                got = ops.bernk(x, keep_prob=kp, seed=BIG_SEED, worker=BIG_WORKER)
                want = ref.bernk_ref(x, keep_prob=kp, seed=BIG_SEED, worker=BIG_WORKER)
                torch.cuda.synchronize()
                err["bernk"] = max(err["bernk"], float_err(torch, got, want))
                if not bits_equal(torch, got, want):
                    fail(f"(j) bernk {dtype} d={d} keep_prob={kp}: kernel != plain")
                cases += 1
    for d in (1000, 2**16, 2**20):  # 2**20: the 16-byte vector path (at least a block of vectors an SM)
        delta = torch.from_numpy(with_corners(np, rng, d)).to(dev)
        for w in (torch.full((d,), -0.0, device=dev), torch.from_numpy(with_corners(np, rng, d, at=7)).to(dev)):
            for n in (3, 4, 10, 16):
                for r in (-3, 0, n + 1):
                    rot = torch.tensor([r], dtype=torch.int32, device=dev)
                    got = ops.rotk_apply(w, delta, rot, n=n, worker=2)
                    want = ref.rotk_apply_ref(w, delta, rot, n=n, worker=2)
                    torch.cuda.synchronize()
                    err["rotk_apply"] = max(err["rotk_apply"], float_err(torch, got, want))
                    if not bits_equal(torch, got, want):
                        fail(f"(j) rotk_apply d={d} n={n} r={r}: kernel != plain")
                    cases += 1
        for n in (3, 4, 10, 16):  # rotk_apply_rows: n rows, IEEE corners in each; one -0.0 row broadcast
            rows = torch.from_numpy(np.stack([with_corners(np, rng, d, at=7 + 3 * i) for i in range(n)])).to(dev)
            for w_rows in (rows, torch.full((d,), -0.0, device=dev).expand(n, d)):
                e, c = rotk_rows_cases(np, torch, dev, f"(j) d={d}", w_rows, delta, n)
                err["rotk_apply_rows"] = max(err["rotk_apply_rows"], e)
                cases += c
    for n in (1, 3):  # every lane kept; two kept lanes a 16-byte f32 vector
        e, c = rotk_offsets_vs_plain(np, torch, dev, "(j)", ROTK_SIZES, n, (torch.float32,))
        for kname in e:
            err[kname] = max(err[kname], e[kname])
        cases += c
    workers = torch.tensor(list(range(8)) + [2**31 - 1, -5], dtype=torch.int32, device=dev)
    for d in (1000, 2**16):
        x = torch.from_numpy(with_corners(np, rng, d)).to(dev)
        for kp in (0.1, 1 / 16, 0.9):
            for mag in MAGS:
                m = int(wire.mag_dtype(mag))
                got = kenc.mask_streams(x, workers, kp, BIG_SEED, mag)
                want = ref.mask_streams_ref(x, workers, kp, BIG_SEED, m)
                torch.cuda.synchronize()
                for g, w_ in zip(got, want):
                    err["mask_streams"] = max(err["mask_streams"], int_err(ref, g, w_))
                    if not torch.equal(g, w_):
                        fail(f"(j) mask_streams d={d} keep_prob={kp} {mag}: kernel != plain")
                cases += 1
    inputs = [with_corners(np, rng, 4096, at=130)]
    ties = np.round(rng.standard_normal(4096) * 2).astype(np.float32) / 2  # many exact ties
    inputs.append(ties)
    inputs.append(np.where(rng.random(4096) < 0.5, -1.25, 1.25).astype(np.float32))  # every |x| tied
    low = rng.integers(0, 128, 4096, dtype=np.uint32)  # keys equal in their top 24 bits
    inputs.append((np.uint32(0x3FC00000) | low | (rng.integers(0, 2, 4096, dtype=np.uint32) << 31))
                  .view(np.float32))
    nan_free = rng.standard_normal(3000).astype(np.float32)  # 3000: a ragged last block
    nan_free[:8] = [np.inf, -np.inf, 1e-42, -0.0, 0.0, 6.1e-39, -1e-42, 2.0]  # inf stops selection
    inputs.append(nan_free)
    for xi in inputs:
        for block in (128, 1000, 1024):
            xp = torch.nn.functional.pad(torch.from_numpy(xi).to(dev), (0, (-xi.size) % block))
            for k in (1, 64, block, block + 3):
                for mag in MAGS:
                    m = int(wire.mag_dtype(mag))
                    got = kenc.topk_streams(xp, k, block, mag)
                    want = ref.topk_streams_ref(xp, k, block, m)
                    torch.cuda.synchronize()
                    for g, w_ in zip(got, want):
                        err["topk_streams"] = max(err["topk_streams"], int_err(ref, g, w_))
                        if not torch.equal(g, w_):
                            fail(f"(j) topk_streams block={block} k={k} {mag}: kernel != plain")
                    cases += 1
    return err, cases + path_inputs_vs_plain(np, torch, dev, err)


def path_inputs_vs_plain(np, torch, dev, err) -> int:
    """(j), continued: each kernel against its plain version at the settings
    and on the very inputs the path of (k) gives it (``wire_bench``'s at
    d = 2**16 and 2**14, ``kernel_bench``'s at 2**16), and on copies of those
    inputs with IEEE corners in the first and the last block. Raises the
    entries of ``err``; returns the number of cases."""
    from repro_torch import kernel_bench, wire, wire_bench
    from repro_torch.kernels import encode as kenc
    from repro_torch.kernels import ops, ref

    corners = wire_edge(np)

    def variants(x):
        xc = x.clone()
        xc[:corners.size] = torch.from_numpy(corners).to(dev)
        xc[-corners.size:] = torch.from_numpy(-corners).to(dev)
        return (("path input", x), ("with IEEE corners", xc))

    def check(kname, what, got, want):
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        for g, w in pairs:
            e = int_err(ref, g, w) if g.dtype == torch.int32 else float_err(torch, g, w)
            err[kname] = max(err[kname], e)
            if not (torch.equal(g, w) if g.dtype == torch.int32 else bits_equal(torch, g, w)):
                fail(f"(j) {kname} at the path's shape, {what}: kernel != plain")

    cases = 0
    k, block = wire_bench.TOPK_K, wire_bench.TOPK_BLOCK
    kp, seed = wire_bench.MASK_KEEP, wire_bench.MASK_SEED
    worker0 = torch.zeros(1, dtype=torch.int32, device=dev)  # mask_encode's one row, worker 0
    for d in (1 << 16, 1 << 14):  # encode_roofline_rows, bench_encode
        _, _, dense_t, _ = wire_bench._inputs(d, dev)
        for what, x in variants(dense_t):
            what = f"d={d} {what}"
            for mag in MAGS:
                m = int(wire.mag_dtype(mag))
                check("topk_streams", f"{what} k={k} block={block} {mag}",
                      kenc.topk_streams(x, k, block, mag), ref.topk_streams_ref(x, k, block, m))
                check("mask_streams", f"{what} 1 row keep_prob={kp} seed={seed} {mag}",
                      kenc.mask_streams(x, worker0, kp, seed, mag), ref.mask_streams_ref(x, worker0, kp, seed, m))
                cases += 2
            check("bernk", f"{what} keep_prob={kp} seed={seed}",
                  ops.bernk(x, keep_prob=kp, seed=seed), ref.bernk_ref(x, keep_prob=kp, seed=seed))
            cases += 1
    v = kernel_bench.inputs(dev)
    kb_kp, kb_seed = kernel_bench.BERNK_KEEP, kernel_bench.BERNK_SEED
    rn, rw = kernel_bench.ROTK_N, kernel_bench.ROTK_WORKER
    for (what, x), (_, w) in zip(variants(v["x"]), variants(v["w"])):
        what = f"d={x.numel()} {what}"
        check("bernk", f"{what} keep_prob={kb_kp} seed={kb_seed}",
              ops.bernk(x, keep_prob=kb_kp, seed=kb_seed), ref.bernk_ref(x, keep_prob=kb_kp, seed=kb_seed))
        check("rotk_apply", f"{what} n={rn} worker={rw} r={kernel_bench.ROTK_R}",
              ops.rotk_apply(w, x, v["rotation"], n=rn, worker=rw),
              ref.rotk_apply_ref(w, x, v["rotation"], n=rn, worker=rw))
        cases += 2
    return cases


def fused_encode_buffers(np, torch, dev) -> int:
    """(k): the fused encoders' buffers equal the host codec's over the
    matching op on the card, byte for byte. Returns the buffers checked."""
    from repro_torch import wire
    from repro_torch.kernels import encode as kenc
    from repro_torch.kernels import ops

    rng = np.random.default_rng(17)
    checked = 0
    for d in (1, 1000, 2**14, 2**16):
        x = torch.from_numpy(with_corners(np, rng, d)).to(dev)
        for mag in MAGS:
            for k, block in ((64, 1024), (8, 128), (1, 1000), (1030, 1024)):
                if kenc.topk_encode(x, k_per_block=k, block=block, mag=mag) != wire.encode_sparse(
                        ops.block_topk(x, k_per_block=k, block=block), mag=mag):
                    fail(f"(k) topk_encode d={d} k={k} block={block} {mag}: != host codec over ops.block_topk")
                checked += 1
            for kp, worker in ((1 / 16, 0), (0.1, 3), (0.9, BIG_WORKER)):
                if kenc.mask_encode(x, keep_prob=kp, seed=BIG_SEED, worker=worker, mag=mag) != \
                        wire.encode_sparse(ops.bernk(x, keep_prob=kp, seed=BIG_SEED, worker=worker), mag=mag):
                    fail(f"(k) mask_encode d={d} keep_prob={kp} {mag}: != host codec over ops.bernk")
                checked += 1
            want = [wire.encode_sparse(ops.bernk(x, keep_prob=0.1, seed=7, worker=i), mag=mag) for i in range(10)]
            if kenc.encode_per_worker(x, n_workers=10, keep_prob=0.1, seed=7, mode="ind", mag=mag) != want:
                fail(f"(k) encode_per_worker ind d={d} {mag}: != host codec over ops.bernk")
            if kenc.encode_per_worker(x, n_workers=4, keep_prob=0.1, seed=7, mode="same", mag=mag) != [want[0]] * 4:
                fail(f"(k) encode_per_worker same d={d} {mag}: != host codec over ops.bernk")
            checked += 14
    return checked


# ---------------------------------------------------------------------------
# tracing, the lossy transport and the client fleet (phases m-o)
# ---------------------------------------------------------------------------

SLICE_KERNELS = ("l1_subgrad", "block_topk", "sparse_streams", "dense_bits", "pack_bits")


def timed_run(torch, dev, fn):
    """(fn(), seconds) on the host clock, ended by a sync of ``dev`` where
    it is a card."""
    t0 = time.perf_counter()
    out = fn()
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def max_rel(np, got, want) -> float:
    return float(np.max(np.abs(np.subtract(got, want)) / np.abs(want)))


def tracing_phase(np, torch, dev, prob, T):
    """(m): MARINA-P (perm, Polyak) and EF21-P (TopK, constant gamma) with
    measure_wire, run with a tracker (a MemoryTracker and a BenchJsonSink)
    and without: equal f_x and wire bits, a valid span stream and Perfetto
    export with one ``round`` span a round, a BENCH document that passes
    ``bench_json.validate``. Returns {run: (us/round traced, untraced)}."""
    import tempfile

    from repro_torch import obs
    from repro_torch.core import compressors as C
    from repro_torch.core import ef21p, marina_p, stepsizes
    from repro_torch.obs import analyze

    D, N = prob.d, prob.n
    k, p = D // N, (D // N) / D
    gamma = stepsizes.ef21p_optimal_constant(prob.R0_sq, prob.L0, k / D, T)
    runs = {
        "marina_p_perm_polyak": lambda tracker: marina_p.run(
            prob, mode="perm", k=k, p=p, stepsize=stepsizes.MarinaPPolyak(omega=N - 1.0, p=p),
            T=T, seed=0, measure_wire=True, tracker=tracker),
        "ef21p_topk_const": lambda tracker: ef21p.run(
            prob, C.TopK(k=k), stepsizes.Constant(gamma), T=T, seed=0, measure_wire=True,
            tracker=tracker),
    }
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, run in runs.items():
            mem = obs.MemoryTracker()
            sink = obs.BenchJsonSink(f"chip_smoke_{name}", tmp, seed=0)
            plain, s_plain = timed_run(torch, dev, lambda: run(None))
            traced, s_traced = timed_run(torch, dev, lambda: run(obs.CompositeTracker(mem, sink)))
            if traced["f_x"] != plain["f_x"] or traced["wire_bits"] != plain["wire_bits"]:
                fail(f"(m) {name}: f_x or wire bits differ with the tracker")
            errors = analyze.validate_spans(mem.events)
            errors += analyze.validate_perfetto(analyze.to_perfetto(mem.events))
            if errors:
                fail(f"(m) {name}: {errors[:3]}")
            roots = analyze.build_tree(mem.events)
            names = {s.name for r in roots for s in r.walk()}
            if len(roots) != T or {r.name for r in roots} != {"round"} or not {
                    "subgrad", "stepsize"} <= names:
                fail(f"(m) {name}: {len(roots)} root spans {sorted({r.name for r in roots})} for "
                     f"{T} rounds, names {sorted(names)}")
            sink.finish()
            doc = obs.load(sink.path)
            if obs.validate(doc) or doc["env"]["platform"] != ("gpu" if dev.type == "cuda" else "cpu"):
                fail(f"(m) {name}: BENCH document invalid: {obs.validate(doc)} env {doc['env']}")
            out[name] = (s_traced / T * 1e6, s_plain / T * 1e6)
            log(f"(m) {name}: {T} round spans, {len(analyze.span_events(mem.events))} spans, "
                f"Perfetto export valid, BENCH artifact valid (env {doc['env']['device_kind']}, "
                f"torch {doc['env']['torch_version']}); f_x and wire bits equal with and without "
                f"the tracker; us/round traced {out[name][0]:.1f}, untraced {out[name][1]:.1f}")
    return out


def transport_phase(np, torch, dev, prob, prob_cpu, T):
    """(n): both algorithms through ``Fleet.make(n, CHAOS_SPEC)`` on the card
    and on the CPU port, same seed: equal transport event counters, goodput
    and s2w bits within TRAJ_RTOL; MARINA-P's f_x within TRAJ_RTOL a round,
    EF21-P's finite and falling.
    Then ``repro_torch.transport_bench`` on the card. Returns {run: us/round}."""
    from repro_torch import transport_bench
    from repro_torch.core import compressors as C
    from repro_torch.core import ef21p, marina_p, stepsizes

    spec = transport_bench.CHAOS_SPEC
    D, N = prob.d, prob.n
    k, p = D // N, (D // N) / D
    runs = {
        "marina_p_perm_polyak": lambda pr: marina_p.run(
            pr, mode="perm", k=k, p=p, stepsize=stepsizes.MarinaPPolyak(omega=N - 1.0, p=p),
            T=T, seed=0, transport=spec),
        "ef21p_topk_polyak": lambda pr: ef21p.run(
            pr, C.TopK(k=k), stepsizes.EF21PPolyak(alpha=k / D), T=T, seed=0, transport=spec),
    }
    out = {}
    for name, run in runs.items():
        card, secs = timed_run(torch, dev, lambda: run(prob))
        cpu = run(prob_cpu)
        # Every counter the fault schedules decide must be equal. The byte
        # counts (so goodput) and the ledger follow the messages' lengths: a
        # coordinate of x_{t+1} - x_t that rounds to exactly 0 on one device
        # and not on the other (late in a run, where steps are tiny) drops
        # one SPARSE entry there (ROADMAP Queue 3), so those two are held
        # within TRAJ_RTOL and the rounds where they differ are reported.
        events = {kk: v for kk, v in card["transport"].items() if kk != "transport/goodput"}
        if events != {kk: cpu["transport"][kk] for kk in events}:
            fail(f"(n) {name}: card and CPU transport counters differ: "
                 f"{card['transport']} vs {cpu['transport']}")
        g_card, g_cpu = card["transport"]["transport/goodput"], cpu["transport"]["transport/goodput"]
        s2w_rel = max_rel(np, cpu["s2w_bits"], card["s2w_bits"])
        if abs(g_card - g_cpu) > TRAJ_RTOL * g_cpu or s2w_rel > TRAJ_RTOL:
            fail(f"(n) {name}: goodput {g_card} vs {g_cpu}, s2w rel diff {s2w_rel:.3e}")
        differ = np.nonzero(np.diff(card["s2w_bits"], prepend=0.0)
                            != np.diff(cpu["s2w_bits"], prepend=0.0))[0].tolist()
        rel = max_rel(np, cpu["f_x"], card["f_x"])
        if name.startswith("marina") and rel > TRAJ_RTOL:
            fail(f"(n) {name}: CPU vs card f_x rel err {rel:.3e} > {TRAJ_RTOL}")
        for h in (card, cpu):
            if not (np.isfinite(h["f_x"]).all() and h["f_x"][-1] < h["f_x"][0]):
                fail(f"(n) {name}: f_x not finite and falling")
        tr = card["transport"]
        out[name] = secs / T * 1e6
        log(f"(n) {name} T={T} through CHAOS_SPEC: transport event counters equal on card and CPU "
            f"(retries {tr['transport/retries']}, resyncs {tr['transport/resyncs']}, forced syncs "
            f"{tr['transport/forced_syncs']}); goodput card {g_card!r} CPU {g_cpu!r}; rounds whose s2w "
            f"bits differ {differ}; CPU vs card max rel f_x diff {rel:.3e}; us/round {out[name]:.1f}")
    for row in transport_bench.framing_rows():
        log(f"(n) transport_bench {row[0]:24s} {row[1]:10.1f} us/call {row[2]:8.4f} GB/s (host)")
    metrics = transport_bench.chaos_metrics(device=dev)
    log(f"(n) transport_bench chaos on the card: {metrics}")
    if not 0 < metrics["transport/goodput"] <= 1:
        fail(f"(n) transport_bench goodput {metrics['transport/goodput']}")
    return out


def fleet_phase(np, torch, dev, D, T, population, cohort):
    """(o): ``fleet_run`` of MARINA-P (perm, Polyak) and EF21-P (TopK,
    Polyak) with measure_wire on the flaky_mobile and two_tier_diurnal
    mixes, on the card and the CPU port, same seed: equal participation
    stats, per-round s2w, wire, fresh and delivered counts and join bits;
    MARINA-P's f_x within TRAJ_RTOL, EF21-P's finite and falling. Returns
    {run: (us/round, ms/round of the cohort's host-built matrices)}."""
    import dataclasses

    from repro_torch import fleet, scenario_matrix
    from repro_torch.core import stepsizes
    from repro_torch.fleet import cohort as fleet_cohort

    k = max(1, D // cohort)
    p = k / D
    out = {}
    for alg in ("marina_p", "ef21p"):
        for mix in ("flaky_mobile", "two_tier_diurnal"):
            spec = fleet.make_fleet(mix, population, seed=0)
            prob = fleet.FleetL1Problem(spec, d=D)
            sampler = fleet.make_sampler(scenario_matrix.MIX_SAMPLER[mix], spec, cohort, seed=0)
            ss = (stepsizes.MarinaPPolyak(omega=cohort - 1.0, p=p) if alg == "marina_p"
                  else stepsizes.EF21PPolyak(alpha=k / D))
            kw = dict(algorithm=alg, mode="perm", k=k, p=p, T=T, seed=0, measure_wire=True)
            card, secs = timed_run(torch, dev, lambda: fleet.fleet_run(prob, sampler, ss, device=dev, **kw))
            cpu = fleet.fleet_run(prob, sampler, ss, device="cpu", **kw)
            name = f"{alg}/{mix}"
            if dataclasses.asdict(card["participation"]) != dataclasses.asdict(cpu["participation"]):
                fail(f"(o) {name}: participation stats differ: {card['participation']} vs {cpu['participation']}")
            for key in ("s2w_bits", "wire_bits", "participants", "fresh", "delivered", "join_bits_total"):
                if card[key] != cpu[key]:
                    fail(f"(o) {name}: card and CPU {key} differ")
            rel = max_rel(np, cpu["f_x"], card["f_x"])
            if alg == "marina_p" and rel > TRAJ_RTOL:
                fail(f"(o) {name}: CPU vs card f_x rel err {rel:.3e} > {TRAJ_RTOL}")
            for h in (card, cpu):
                if not (np.isfinite(h["f_x"]).all() and h["f_x"][-1] < h["f_x"][0]):
                    fail(f"(o) {name}: f_x not finite and falling")
            host = []
            for t in range(3):
                _, s = timed_run(torch, dev, lambda: fleet_cohort.cohort_matrices(
                    prob, sampler.cohort(t).ids, dev))
                host.append(s * 1e3)
            out[name] = (secs / T * 1e6, sorted(host)[1])
            st = card["participation"]
            log(f"(o) {name} population {population} cohort {cohort} d={D} T={T}: stats, s2w, wire, "
                f"join bits equal on card and CPU (participant rounds {st.participant_rounds}, goodput "
                f"{st.goodput:.4f}, fresh {st.fresh_frac:.3f}, join bits {card['join_bits_total']:.4g}, "
                f"wire bits {card['wire_bits_total']:.4g}); CPU vs card max rel f_x diff {rel:.3e}; "
                f"us/round {out[name][0]:.1f}, of which the cohort's matrices (materialize float64 on "
                f"the host, copy, cast) {out[name][1]:.2f} ms")
    return out


def participation_phase(np, torch, dev, prob, prob_cpu, T):
    """(o): ``marina_p.run(participation=BernoulliStragglerPlan(0.2, 2.0))``
    on the card and the CPU port: equal cohort sizes, f_x within TRAJ_RTOL.
    Returns us/round on the card."""
    from repro_torch.core import marina_p, stepsizes
    from repro_torch.fleet import BernoulliStragglerPlan

    D, N = prob.d, prob.n
    k, p = D // N, (D // N) / D

    def run(pr):
        return marina_p.run(pr, mode="perm", k=k, p=p, stepsize=stepsizes.MarinaPPolyak(omega=N - 1.0, p=p),
                            T=T, seed=0, participation=BernoulliStragglerPlan(0.2, 2.0))

    card, secs = timed_run(torch, dev, lambda: run(prob))
    cpu = run(prob_cpu)
    rel = max_rel(np, cpu["f_x"], card["f_x"])
    if card["participants"] != cpu["participants"] or rel > TRAJ_RTOL:
        fail(f"(o) participation: cohorts differ or CPU vs card f_x rel err {rel:.3e}")
    if min(card["participants"]) >= N or not card["f_x"][-1] < card["f_x"][0]:
        fail(f"(o) participation: no partial round, or f_x did not fall")
    log(f"(o) marina_p perm Polyak with BernoulliStragglerPlan(0.2, 2.0), n={N} d={D} T={T}: cohorts "
        f"{min(card['participants']):.0f}..{max(card['participants']):.0f} of {N}, equal on card and CPU; "
        f"max rel f_x diff {rel:.3e}; us/round {secs / T * 1e6:.1f}")
    return secs / T * 1e6


# ---------------------------------------------------------------------------
# the repairs, the SPMD runner and the benchmark harness (phases p-r)
# ---------------------------------------------------------------------------

# kernels that must launch between (q) and (r): all but unpack_bits, which
# only a decoder reaches: the serving path's delta_sync, phase (s)
HARNESS_KERNELS = ("l1_subgrad", "block_topk", "pack_bits", "sparse_streams", "dense_bits", "bernk",
                   "rotk_apply", "mask_streams", "topk_streams")
HARNESS_SUITES = ("fig1", "stepsize_grid", "comm_complexity", "kernels", "wire", "encode", "transport",
                  "scenario")
# the suites whose rows match the reference's baselines (benchmarks/baselines), and those held to
# the port's own baselines from an H100 (src/repro_torch/baselines): kernels' rows are the port's
DIFF_SUITES = ("table2", "wire", "encode", "transport", "scenario")
PORT_DIFF_SUITES = DIFF_SUITES + ("kernels",)
REF_BASELINES = ROOT / "benchmarks" / "baselines"
PORT_BASELINES = SRC / "repro_torch" / "baselines"
SPMD_ATOL = 1e-4


def hold_to_baselines(what, suite, fresh, *, keep=None, reference=True):
    """``bench_diff`` of a fresh BENCH document twice. First against the
    reference's baseline (``benchmarks/baselines``): a missing metric or a
    failing ``value`` gate fails; its ``us_per_call`` gates, timed on a CPU in
    Pallas interpret mode, are printed and not enforced. Then against the
    port's own baseline from an H100 (``src/repro_torch/baselines``): every
    gate, ``us_per_call`` included, must hold. ``keep`` selects the
    baselines' metrics that this run computed."""
    from repro_torch import bench_diff, obs

    def load(directory):
        doc = obs.load(str(directory / f"BENCH_{suite}.json"))
        if keep is not None:
            doc["metrics"] = {name: v for name, v in doc["metrics"].items() if keep(name)}
        return doc

    if reference:
        base = load(REF_BASELINES)
        value = dict(base, gates=[g for g in base["gates"] if g["field"] != "us_per_call"])
        timing = dict(base, gates=[g for g in base["gates"] if g["field"] == "us_per_call"])
        v_fail, v_checked = bench_diff.diff_docs(value, fresh)
        t_fail, t_checked = bench_diff.diff_docs(timing, fresh)
        missing = [f for f in t_fail if "missing" in f]
        log(f"{what} bench_diff {suite} against benchmarks/baselines: {len(v_checked)} value gates checked, "
            f"{len(v_fail)} failing; {len(t_checked)} us_per_call gates (CPU-interpret baseline, printed only), "
            f"{len(t_fail) - len(missing)} over")
        for f in t_fail:
            if f not in missing:
                log(f"{what}   us_per_call, not enforced: {f}")
        if v_fail or missing:
            fail(f"{what} bench_diff {suite} against benchmarks/baselines: {(v_fail + missing)[:6]}")
    base = load(PORT_BASELINES)
    if base["env"]["platform"] != "gpu":
        fail(f"{what} src/repro_torch/baselines/BENCH_{suite}.json was not made on a card: {base['env']}")
    failures, checked = bench_diff.diff_docs(base, fresh)
    ratios = [fresh["metrics"][name]["us_per_call"] / max(base["metrics"][name]["us_per_call"], 1e-12)
              for name, field in (c.rsplit(":", 1) for c in checked) if field == "us_per_call"]
    spread = f" (fresh / baseline {min(ratios):.3f}-{max(ratios):.3f})" if ratios else ""
    log(f"{what} bench_diff {suite} against src/repro_torch/baselines ({base['env']['device_kind']}): "
        f"{len(checked)} gates checked, {len(ratios)} of them us_per_call{spread}, {len(failures)} failing")
    if failures:
        fail(f"{what} bench_diff {suite} against src/repro_torch/baselines: {failures[:6]}")


def rotk16_phase(np, torch, dev, timed):
    """(p): rotk_apply in fp16 and bf16 bit-exact against its plain version
    at d = 2**16, n in {7, 10, 16}, and d = 2**20, n = 7, r in {-3, 0,
    n + 1}, on inputs with IEEE
    corners (+-0, fp32 / fp16 / bf16 denormals, +-inf, NaNs, values whose
    product overflows the dtype) in w and in kept and dropped coordinates of
    delta; ``rotk_apply_rows`` alike over n rows (w rolled by 3 i in row i),
    and both entries at misaligned offsets and odd sizes. Returns ({kernel:
    max abs error}, cases, {dtype: (ms, plain ms, bound ms)})."""
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(29)
    extra = np.array([5.96e-8, -3.0e-5, 6.0e-5, 1.0e-6, 1e-39, -2e-40, 6.0e4, -65504.0, 3.0e38,
                      -1.5e38], dtype=np.float32)
    err, cases, times = {"rotk_apply": 0.0, "rotk_apply_rows": 0.0}, 0, {}
    for dtype in (torch.float16, torch.bfloat16):
        for d, n in [(2**16, n) for n in (7, 10, 16)] + [(2**20, 7)]:  # 2**20: the 16-byte vector path
            w_np, d_np = with_corners(np, rng, d), with_corners(np, rng, d, at=40)
            for at in range(0, 3 * n, 3):  # the corners on kept and on dropped coordinates
                w_np[100 + at:100 + at + extra.size] = extra
                d_np[300 + at:300 + at + extra.size] = extra[::-1]
            w = torch.from_numpy(w_np).to(dev).to(dtype)
            delta = torch.from_numpy(d_np).to(dev).to(dtype)
            for r in (-3, 0, n + 1):
                rot = torch.tensor([r], dtype=torch.int32, device=dev)
                got = ops.rotk_apply(w, delta, rot, n=n, worker=2)
                want = ref.rotk_apply_ref(w, delta, rot, n=n, worker=2)
                torch.cuda.synchronize()
                err["rotk_apply"] = max(err["rotk_apply"], float_err(torch, got, want))
                if not bits_equal(torch, got, want):
                    bad = (got.view(torch.int16) != want.view(torch.int16)).nonzero().flatten()[:8].tolist()
                    fail(f"(p) rotk_apply {dtype} n={n} r={r}: kernel != plain at {bad}")
                cases += 1
            e, c = rotk_rows_cases(np, torch, dev, "(p)", torch.stack([w.roll(3 * i) for i in range(n)]), delta, n)
            err["rotk_apply_rows"] = max(err["rotk_apply_rows"], e)
            cases += c
        e, c = rotk_offsets_vs_plain(np, torch, dev, "(p)", ROTK_SIZES, 7, (dtype,))
        for kname in e:
            err[kname] = max(err[kname], e[kname])
        cases += c
        # kernel_bench's setting: n = 16, worker 3, r = 2
        d = 2**16
        x = torch.randn(d, generator=torch.Generator().manual_seed(5)).to(dev).to(dtype)
        wt = torch.randn(d, generator=torch.Generator().manual_seed(6)).to(dev).to(dtype)
        rot = torch.tensor([2], dtype=torch.int32, device=dev)
        times[str(dtype).split(".")[-1]] = (
            timed(lambda: ops.rotk_apply(wt, x, rot, n=16, worker=3)),
            timed(lambda: ref.rotk_apply_ref(wt, x, rot, n=16, worker=3)),
            (6 * d + 4) / HBM_BYTES_PER_S * 1e3)
    return err, cases, times


DATAGEN_CELL = """
import sys, time
import torch
from repro_torch.core import problems
t0 = time.perf_counter()
prob = problems.generate_problem(n=100, d=1000, noise_scale=1.0, seed=0, device="cpu")
secs = time.perf_counter() - t0
torch.save(dict(A=prob.A, x0=prob.x0, L0i=prob.L0i, sigma_A=prob.sigma_A, secs=secs), sys.argv[1])
"""


def datagen_start():
    """(q)'s problem, started: ``problems.generate_problem`` of the n = 100,
    d = 1000 problem on the host, in a process of its own at the lowest CPU
    priority (its LAPACK threads take the idle cores, not the phases' own)
    from the build on. Returns (the process, its output file)."""
    import os

    out = os.path.join(tempfile.mkdtemp(prefix="datagen_"), "problem.pt")
    env = dict(os.environ, PYTHONPATH=str(SRC))  # the BLAS threads of this process, as (v3)'s
    return spawn([sys.executable, "-c", DATAGEN_CELL, out], env=env, stdout=subprocess.PIPE,
                 stderr=subprocess.STDOUT, text=True, preexec_fn=lambda: os.nice(19)), out


def spmd_phase(np, torch, dev, T, datagen):
    """(q): the SPMD runner (``core/distributed.py``) as one NCCL rank at the
    paper's largest width, d = 1000, n = 100 (A: 400 MB of f32): MARINA-P
    same/ind/perm with Polyak for T rounds against the single-process
    ``marina_p.make_step`` on the card fed the same ``MarinaPDraws``, x and W
    within SPMD_ATOL every round; EF21-P/TopK (Polyak) teacher-forced per
    step, x and the k kept magnitudes within SPMD_ATOL, w where the k-th
    magnitude gap exceeds 1e-5 (at n = 100 exact ties there are common).
    ``datagen``: :func:`datagen_start`'s process and file. Returns
    (problem, datagen s, max abs error, {run: (SPMD µs/round,
    single-process µs/round)})."""
    import os
    import socket

    import torch.distributed as dist

    from repro_torch.core import compressors as C
    from repro_torch.core import distributed, ef21p, marina_p, problems, stepsizes

    N, D = 100, 1000
    k, p = D // N, (D // N) / D
    proc, out = datagen
    text, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        fail(f"(q) the datagen process exited {proc.returncode}:\n{text[-3000:]}")
    made = torch.load(out)
    shutil.rmtree(os.path.dirname(out), ignore_errors=True)
    datagen_s = made.pop("secs")
    prob = problems.L1Problem(**made).to(dev)
    del made
    if (prob.n, prob.d) != (N, D):
        fail(f"(q) the problem made beside the earlier phases is n={prob.n}, d={prob.d}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    distributed.init_process_group(f"tcp://127.0.0.1:{port}", rank=0, world_size=1, device=dev)
    worst, us = 0.0, {}

    def per_round(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / T * 1e6

    try:
        group = dist.group.WORLD
        if dist.get_backend(group) != "nccl":
            fail(f"(q) the card's process group runs {dist.get_backend(group)}, not nccl")
        A = distributed.shard_problem(group, prob.A, device=dev)
        for mode, omega in (("same", D / k - 1.0), ("ind", D / k - 1.0), ("perm", N - 1.0)):
            ss = stepsizes.MarinaPPolyak(omega=omega, p=p)
            single = marina_p.make_step(prob, mode, k, p, ss)
            spmd = distributed.make_marina_p_spmd_step(group, n=N, d=D, mode=mode, k=k, p=p,
                                                       stepsize=ss, device=dev)
            bcast = marina_p.make_broadcast(mode, N, k)
            gen = torch.Generator().manual_seed(0)
            draws = [marina_p.draw_round(bcast, p, D, gen, dev) for _ in range(T)]
            state, sp = marina_p.init(prob.x0, N), distributed.init_marina_p(prob.x0, N)
            for t in range(T):
                state, m1 = single(state, draws[t])
                sp, m2 = spmd(sp, A, draws[t])
                e = max(float((state.x - sp.x).abs().max()), float((state.W - sp.W).abs().max()))
                worst = max(worst, e)
                if not e <= SPMD_ATOL or m1["q_nnz_mean"] != m2["q_nnz_mean"]:
                    fail(f"(q) MARINA-P {mode} round {t}: SPMD vs single process max |diff| {e:.3e}, "
                         f"q_nnz_mean {m2['q_nnz_mean']} / {m1['q_nnz_mean']}")

            def run_single():
                st = marina_p.init(prob.x0, N)
                for dr in draws:
                    st, _ = single(st, dr)

            def run_spmd():
                st = distributed.init_marina_p(prob.x0, N)
                for dr in draws:
                    st, _ = spmd(st, A, dr)

            a, b, c, e_ = per_round(run_spmd), per_round(run_single), per_round(run_single), per_round(run_spmd)
            us[f"marina_p_{mode}_polyak"] = ((a + e_) / 2, (b + c) / 2)
        ss = stepsizes.EF21PPolyak(alpha=k / D)
        single = ef21p.make_step(prob, C.TopK(k=k), ss)
        spmd = distributed.make_ef21p_spmd_step(group, n=N, d=D, k=k, stepsize=ss, device=dev)
        state, checked = ef21p.init(prob.x0), 0
        for t in range(T):
            new, _ = single(state)
            sp, _ = spmd(distributed.SpmdEF21PState(x=state.x, w=state.w, t=state.t), A)
            e = float((new.x - sp.x).abs().max())
            mags = torch.sort((new.x - state.w).abs(), descending=True).values
            if float(mags[k - 1] - mags[k]) > 1e-5:  # selection unambiguous
                e = max(e, float((new.w - sp.w).abs().max()))
                checked += 1
            # whichever of tied coordinates each picks, the kept magnitudes agree
            kept = [torch.sort((s_.w - state.w).abs(), descending=True).values[:k] for s_ in (new, sp)]
            e = max(e, float((kept[0] - kept[1]).abs().max()))
            worst = max(worst, e)
            if not e <= SPMD_ATOL:
                fail(f"(q) EF21-P round {t}: SPMD vs single process max |diff| {e:.3e}")
            state = new  # teacher-force the single-process trajectory

        def run_single_e():
            st = ef21p.init(prob.x0)
            for _ in range(T):
                st, _ = single(st)

        def run_spmd_e():
            st = distributed.init_ef21p(prob.x0)
            for _ in range(T):
                st, _ = spmd(st, A)

        a, b, c, e_ = per_round(run_spmd_e), per_round(run_single_e), per_round(run_single_e), per_round(run_spmd_e)
        us["ef21p_topk_polyak"] = ((a + e_) / 2, (b + c) / 2)
        # what one world-1 all_reduce of the uplink's d + 2 floats costs alone
        buf = torch.zeros(D + 2, device=dev)

        def reduce_rounds():
            for _ in range(T):
                dist.all_reduce(buf, group=group)
                torch.cuda.synchronize()

        us["all_reduce_uplink"] = (per_round(reduce_rounds), 0.0)
        log(f"(q) EF21-P teacher-forced {T} rounds: x and the k kept magnitudes compared every round, w in "
            f"the {checked} rounds whose k-th magnitude gap exceeds 1e-5 (the tridiagonal A_i tie |x - w| at "
            "the k-th place)")
    finally:
        dist.destroy_process_group()
    return prob, datagen_s, worst, us


def harness_phase(np, torch, dev, prob100, datagen_s):
    """(r): ``repro_torch.run.main`` on the card for HARNESS_SUITES, Table 2
    (n = 10 rows, plus n = 100, s = 1 from (q)'s problem), ``trace_smoke``
    through ``obs.analyze``; every BENCH document valid; then each suite of
    PORT_DIFF_SUITES through :func:`hold_to_baselines`: the reference's
    ``value`` gates (DIFF_SUITES), then every gate of the port's own H100
    baseline, ``us_per_call`` included. Returns {suite: wall s}."""
    import glob
    import os
    import tempfile

    from repro_torch import obs, run, table2_sigma, trace_smoke
    from repro_torch.obs import analyze

    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        rc = run.main([*HARNESS_SUITES, "--device", "cuda", "--out", tmp,
                       "--jsonl", os.path.join(tmp, "events.jsonl")])
        if rc != 0:
            fail(f"(r) repro_torch.run exited {rc}")
        cells = [(10, s) for s in (0.1, 1.0, 10.0)]
        sink = obs.BenchJsonSink("table2", tmp, seed=0, gates=run.GATES["table2"])
        t0 = time.perf_counter()
        rows = table2_sigma.bench(cells=cells, tracker=sink, device=dev)
        walls["table2 (n=10 rows)"] = time.perf_counter() - t0
        rows.append(table2_sigma.row(100, 1.0, prob100.sigma_A, datagen_s * 1e6, sink))
        for row in rows:
            sink.log_row(*row)
            log(f"(r) {row[0]:28s} sigma_A {row[2]!r} (datagen {row[1] / 1e6:.1f} s)")
        sink.finish()
        cells.append((100, 1.0))
        t0 = time.perf_counter()
        trace = trace_smoke.run(os.path.join(tmp, "trace.jsonl"), device=dev)
        events = list(obs.read_jsonl(trace))
        errors = analyze.validate_spans(events) + analyze.validate_perfetto(analyze.to_perfetto(events))
        _, n_degraded = analyze.report(events)
        rounds = sum(1 for r in analyze.build_tree(events) if r.name == "round")
        walls["trace_smoke"] = time.perf_counter() - t0
        if errors or rounds != trace_smoke.ROUNDS or n_degraded < 1:
            fail(f"(r) trace_smoke: {errors[:3]}, {rounds} round spans, {n_degraded} degraded rounds")
        log(f"(r) trace_smoke: {rounds} round spans valid, Perfetto export valid, {n_degraded} degraded "
            "rounds attributed to worker links")
        paths = sorted(glob.glob(os.path.join(tmp, "BENCH_*.json")))
        for path in paths:
            doc = obs.load(path)
            if obs.validate(doc) or doc["env"]["platform"] != "gpu":
                fail(f"(r) {os.path.basename(path)} invalid: {obs.validate(doc)[:3]} env {doc['env']}")
        for suite in [*HARNESS_SUITES]:
            walls[suite] = obs.load(os.path.join(tmp, f"BENCH_{suite}.json"))["timers"][f"{suite}/suite"]["total_s"]
        log(f"(r) {len(paths)} BENCH documents valid (schema v1, platform gpu)")
        for suite in PORT_DIFF_SUITES:
            keep = None
            if suite == "table2":  # only the cells this phase computed
                keep = lambda name: any({f"n{n}", f"s{s}"} <= set(name.split("/")) for n, s in cells)  # noqa: E731
            hold_to_baselines("(r)", suite, obs.load(os.path.join(tmp, f"BENCH_{suite}.json")), keep=keep,
                              reference=suite in DIFF_SUITES)
    return walls


# ---------------------------------------------------------------------------
# the LM serving path (phase s)
# ---------------------------------------------------------------------------

# (s1) decode on the card against the CPU port from the same weights: the
# card's bf16 GEMMs (cuBLAS, fp32 accumulation) and the CPU's (an fp32
# product rounded, as XLA's CPU backend) round ~1e-4 of their outputs one bf16
# ulp apart, which two layers carry to the logits (|logit| <= ~5 at smoke
# width, one ulp there 0.03); a tolerance three times tighter than the
# reference's own decode-vs-forward bound (rtol = atol = 0.12,
# tests/test_decode_consistency.py), which (s1) and (s2) apply to decode
# against forward
SERVE_DEV_RTOL, SERVE_DEV_ATOL = 0.04, 0.04
DECODE_FWD_TOL, DECODE_FWD_AGREE = 0.12, 0.9
CONSISTENCY_ARCHS = ("gemma-2b", "starcoder2-7b", "deepseek-v2-236b", "zamba2-1.2b", "rwkv6-1.6b",
                     "gemma3-1b", "musicgen-large", "llama4-maverick-400b-a17b")
FULL_ARCH, FULL_BATCH, FULL_PROMPT, FULL_NEW, FULL_REQUESTS, FULL_HELD = "gemma3-1b", 4, 576, 64, 3, 64
DELTA_NNZ = 10**6
# kernels that must launch between the counters' reset before (s1) and the read after
# (s4): the replica's decode. The sender's encoders (sparse_streams, dense_bits) build
# (s3)'s messages before the reset, and unpack_bits is timed after the read.
SERVE_KERNELS = ("unpack_bits",)


def _tokens(np, cfg, B, S, seed):
    shape = (B, cfg.num_codebooks, S) if cfg.num_codebooks else (B, S)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def serve_smoke_phase(np, torch, dev):
    """(s1): for each of the ten smoke configs, the port's weights from a seed
    on the CPU and the same values on the card: 32 decode steps on the card
    against the CPU port (logits each step within SERVE_DEV_RTOL / ATOL);
    for the eight families of test_decode_consistency, decode against
    forward on the card, teacher-forced (rtol = atol = 0.12, top-1 agreeing
    > 90%); greedy decoding through the engine's CUDA graph twice with equal
    tokens, and the graph's first-step logits equal to the eager step's.
    Returns {arch: (card-vs-CPU err, decode-vs-forward err or None)}."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve import DecodeEngine

    out = {}
    for i, arch in enumerate(configs.ARCHS):
        cfg = configs.get_smoke(arch)
        p_cpu = lm.lm_init(cfg, device="cpu", seed=i)
        p_dev = p_cpu.clone_to(dev)
        B, S = 2, 32
        toks = torch.from_numpy(_tokens(np, cfg, B, S, seed=100 + i))
        t_dev = toks.to(dev)
        c_cpu = lm.cache_init(cfg, B, S, device="cpu")
        c_dev = lm.cache_init(cfg, B, S, device=dev)
        err, used, dec = 0.0, 0.0, []
        for t in range(S):
            l_cpu, c_cpu = lm.decode_step(cfg, p_cpu, c_cpu, toks[..., t:t + 1], t)
            l_dev, c_dev = lm.decode_step(cfg, p_dev, c_dev, t_dev[..., t:t + 1],
                                          torch.tensor(t, device=dev))
            dec.append(l_dev)
            err = max(err, float_err(torch, l_dev.cpu(), l_cpu))
            # the share of the tolerance the worst entry uses (allclose passes at <= 1)
            gap = (l_dev.float().cpu() - l_cpu.float()).abs()
            used = max(used, float((gap / (SERVE_DEV_ATOL + SERVE_DEV_RTOL * l_cpu.float().abs())).max()))
            if not torch.allclose(l_dev.float().cpu(), l_cpu.float(), rtol=SERVE_DEV_RTOL,
                                  atol=SERVE_DEV_ATOL):
                fail(f"(s1) {arch} decode step {t}: card vs CPU max |diff| "
                     f"{float_err(torch, l_dev.cpu(), l_cpu):.4g} over rtol/atol "
                     f"{SERVE_DEV_RTOL}/{SERVE_DEV_ATOL}")
        fwd_err = None
        if arch in {configs.ALIASES[a] for a in CONSISTENCY_ARCHS}:
            full = lm.forward(cfg, p_dev, {"tokens": t_dev}, chunk=8).float()
            stepped = torch.stack(dec, dim=-2).float()
            fwd_err = float((full - stepped).abs().max())
            if not torch.allclose(stepped, full, rtol=DECODE_FWD_TOL, atol=DECODE_FWD_TOL):
                fail(f"(s1) {arch}: decode vs forward on the card max |diff| {fwd_err:.4g}")
            agree = float((full.argmax(-1) == stepped.argmax(-1)).float().mean())
            if agree <= DECODE_FWD_AGREE:
                fail(f"(s1) {arch}: decode and forward agree on the top-1 token at {agree:.3f}")
        eng = DecodeEngine(cfg, p_dev, cache_len=16, batch_size=B, device=dev)
        prompt = t_dev[..., :8]
        a, b = eng.run(prompt, 8), eng.run(prompt, 8)
        if not torch.equal(a, b):
            fail(f"(s1) {arch}: greedy decoding through the CUDA graph is not deterministic")
        graph_logits = eng._stepper()(prompt[..., :1], 0).clone()
        eager_logits, _ = lm.decode_step(cfg, p_dev, lm.cache_init(cfg, B, 16, device=dev),
                                         prompt[..., :1], 0)
        same = bits_equal(torch, graph_logits, eager_logits)
        if not torch.allclose(graph_logits.float(), eager_logits.float(), rtol=SERVE_DEV_RTOL,
                              atol=SERVE_DEV_ATOL):
            fail(f"(s1) {arch}: the graph's decode step differs from the eager step by "
                 f"{float_err(torch, graph_logits, eager_logits):.4g}")
        out[arch] = (err, fwd_err)
        log(f"(s1) {arch}: 32 decode steps card vs CPU max |diff| {err:.4g} ({used:.2f} of the tolerance)"
            + ("" if fwd_err is None else f"; decode vs forward on the card {fwd_err:.4g}")
            + f"; greedy deterministic; graph step {'bit-equal to' if same else 'within tolerance of'}"
            " the eager step")
    return out


def step_profile(torch, step, dev, reps=5):
    """One eager decode step under ``torch.profiler`` (after warm-up): the
    device kernels a step, device ms a step, and the GEMMs' ms of it (cuBLAS
    kernels by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.trace_round import _device_us

    for _ in range(3):
        step()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize(dev)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    gemm = [e for e in events if any(k in e.key.lower() for k in ("gemm", "nvjet", "xmma", "cutlass"))]
    return {"kernels": sum(e.count for e in events) / reps,
            "device_ms": sum(_device_us(e) for e in events) / reps / 1e3,
            "gemm_kernels": sum(e.count for e in gemm) / reps,
            "gemm_ms": sum(_device_us(e) for e in gemm) / reps / 1e3}


def serve_full_phase(np, torch, dev, card, timed):
    """(s2): gemma3-1b at full width and depth (26 layers, d_model 1152, vocab
    262144, 999,812,736 parameters from the port's seeded lm_init):
    FULL_REQUESTS requests of batch 4, 576-token prompts (past the 512-slot
    window: the local layers' ring buffers wrap) and 64 new tokens through
    the engine; then the decoded logits of the last 64 prompt positions
    against ``lm.forward`` on the card (rtol = atol = 0.12, top-1 agreeing
    > 90%). Returns (engine, params, timings)."""
    from repro_torch import configs, obs
    from repro_torch.models import lm
    from repro_torch.serve import DecodeEngine

    cfg = configs.get(FULL_ARCH)
    t0 = time.perf_counter()
    params = lm.lm_init(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if params.size != cfg.param_count():
        fail(f"(s2) {FULL_ARCH}: {params.size} parameters, the config counts {cfg.param_count()}")
    tr = obs.MemoryTracker()
    eng = DecodeEngine(cfg, params, cache_len=FULL_PROMPT + FULL_NEW, batch_size=FULL_BATCH,
                       tracker=tr, device=dev)
    prompts = [torch.from_numpy(_tokens(np, cfg, FULL_BATCH, FULL_PROMPT, seed=200 + r)).to(dev)
               for r in range(FULL_REQUESTS)]
    t0 = time.perf_counter()
    eng.run(prompts[0], 1)  # the graph's capture (and a first request)
    capture_s = time.perf_counter() - t0
    toks = [eng.run(p, FULL_NEW, seed=r) for r, p in enumerate(prompts)]
    for t in toks:
        if t.shape != (FULL_BATCH, FULL_NEW) or int(t.min()) < 0 or int(t.max()) >= cfg.vocab_size:
            fail(f"(s2) generated tokens of shape {tuple(t.shape)} outside [0, {cfg.vocab_size})")
    timers = [e for e in tr.events if e["kind"] == "timer"][2:]
    pre = sorted(e["seconds"] for e in timers if e["name"] == "serve/prefill")
    dec = sorted(e["seconds"] for e in timers if e["name"] == "serve/decode")
    tps = [e["metrics"]["serve/tokens_per_s"] for e in tr.events if e["kind"] == "metrics"][1:]
    held = eng.prefill(eng._stepper(), prompts[0], keep_last=FULL_HELD).float()
    full = lm.forward(cfg, params, {"tokens": prompts[0]})[:, -FULL_HELD:].float()
    err = float((held - full).abs().max())
    scale = float(full.abs().max())
    if not torch.allclose(held, full, rtol=DECODE_FWD_TOL, atol=DECODE_FWD_TOL):
        fail(f"(s2) decode vs forward over the last {FULL_HELD} prompt positions: max |diff| {err:.4g}")
    agree = float((held.argmax(-1) == full.argmax(-1)).float().mean())
    if agree <= DECODE_FWD_AGREE:
        fail(f"(s2) decode and forward agree on the top-1 token at {agree:.3f}")
    del held, full
    # where a step's time goes: the graph's replay (CUDA events) and the
    # eager step's kernels under the profiler
    step = eng._stepper()
    tok, pos = prompts[0][:, :1], FULL_PROMPT
    graph_ms = timed(lambda: step(tok, pos))
    caches = lm.cache_init(cfg, FULL_BATCH, FULL_PROMPT + FULL_NEW, device=dev)
    pos_t = torch.tensor(pos, device=dev)
    prof = step_profile(torch, lambda: lm.decode_step(cfg, params, caches, tok, pos_t), dev)
    weight_bytes = 2 * params.size  # the bf16 copy, read once a step
    log(f"(s2) one decode step at batch {FULL_BATCH}: graph replay {graph_ms:.4f} ms (CUDA events); eager "
        f"step {prof['kernels']:.0f} kernels, {prof['device_ms']:.4f} ms of device time, "
        f"{prof['gemm_kernels']:.0f} GEMMs {prof['gemm_ms']:.4f} ms of it; bound "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms (the {weight_bytes / 1e9:.2f} GB of bf16 weights "
        f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s) ({card})")
    del caches
    timing = {"init_s": init_s, "capture_s": capture_s, "graph_step_ms": graph_ms, "profile": prof,
              "prefill_ms_per_token": [s / FULL_PROMPT * 1e3 for s in pre],
              "decode_ms_per_step": [s / FULL_NEW * 1e3 for s in dec], "tokens_per_s": tps,
              "decode_vs_forward_err": err, "logit_scale": scale, "top1_agree": agree}
    log(f"(s2) {FULL_ARCH} full width and depth ({params.size:,} parameters, init {init_s:.2f} s, "
        f"graph capture + first request {capture_s:.2f} s): {FULL_REQUESTS} requests of batch "
        f"{FULL_BATCH}, prompt {FULL_PROMPT}, {FULL_NEW} new tokens: prefill ms/position "
        f"{[round(v, 4) for v in timing['prefill_ms_per_token']]}, decode ms/step "
        f"{[round(v, 4) for v in timing['decode_ms_per_step']]}, tokens/s "
        f"{[round(v, 1) for v in tps]} ({card})")
    log(f"(s2) decoded logits of the last {FULL_HELD} prompt positions vs forward on the card: max "
        f"|diff| {err:.4g} (|logit| <= {scale:.3g}), top-1 agreement {agree:.4f}")
    return eng, params, timing


def _sparse_delta(torch, d, nnz, dev, seed):
    """A dense fp32 [d] with ``nnz`` distinct random coordinates set."""
    g = torch.Generator(dev).manual_seed(seed)
    idx = torch.unique(torch.randint(0, d, (nnz + nnz // 8,), device=dev, generator=g))
    idx = idx[torch.randperm(idx.numel(), device=dev, generator=g)[:nnz]]
    delta = torch.zeros(d, dtype=torch.float32, device=dev)
    delta[idx] = torch.randn(idx.numel(), device=dev, generator=g) * 1e-2
    return delta


def delta_messages(np, torch, dev, card):
    """(s3)'s messages, built by the sender's encoders and held against the
    host codec before the counters are zeroed (these launches are the
    smoke's own, not the replica's): at full width a SPARSE delta of
    DELTA_NNZ entries over all of gemma3-1b's coordinates
    (``kernels.encode.sparse_encode``), its ``decode_device`` bit-equal to
    the host ``wire.decode``; at smoke width (gemma-2b) NATURAL and DENSE
    deltas, a DENSE SYNC, a SEED message and a non-finite SYNC, with
    ``decode_device`` of DENSE fp32 / fp16 / bf16 equal to the host codec."""
    from repro_torch import configs, wire
    from repro_torch.kernels import encode as kenc
    from repro_torch.models import lm

    d = configs.get(FULL_ARCH).param_count()
    t0 = time.perf_counter()
    delta = _sparse_delta(torch, d, DELTA_NNZ, dev, seed=5)
    buf = kenc.sparse_encode(delta)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    del delta
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = wire.decode(buf)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = kenc.decode_device(buf, dev)
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    if not bits_equal(torch, got, torch.from_numpy(host).to(dev)):
        fail("(s3) decode_device differs from the host wire.decode at full width")
    del got
    torch.cuda.empty_cache()
    log(f"(s3) d={d:,}: SPARSE delta of {int(np.count_nonzero(host)):,} entries, {len(buf):,} bytes "
        f"(device encode {encode_s:.2f} s); decode_device {device_s * 1e3:.2f} ms bit-equal to the host "
        f"wire.decode {host_s * 1e3:.1f} ms ({card})")

    cfg = configs.get_smoke("gemma-2b")
    p = lm.lm_init(cfg, device=dev, seed=7)
    n = p.size
    flat0 = p.flat.detach().clone()
    g = torch.Generator(dev).manual_seed(11)
    nat = torch.ldexp(torch.ones(n, device=dev), torch.randint(-12, -4, (n,), device=dev, generator=g))
    nat = torch.where(torch.rand(n, device=dev, generator=g) < 0.5, -nat, nat)
    dense = torch.randn(n, device=dev, generator=g) * 1e-3
    for mag in ("fp32", "fp16", "bf16"):
        dbuf = kenc.dense_encode(dense, mag=mag)
        if not bits_equal(torch, kenc.decode_device(dbuf, dev), torch.from_numpy(wire.decode(dbuf)).to(dev)):
            fail(f"(s3) decode_device DENSE {mag} differs from the host codec")
    bad = dense.clone()
    bad[n // 2] = float("inf")
    return {"d": d, "buf": buf, "host": host, "nnz": int(np.count_nonzero(host)), "encode_s": encode_s,
            "host_decode_ms": host_s * 1e3, "decode_device_ms": device_s * 1e3,
            "smoke": {"cfg": cfg, "params": p, "flat0": flat0, "nat": nat,
                      "nat_buf": wire.encode_natural(nat.cpu().numpy()), "dense": dense,
                      "bare": kenc.dense_encode(dense), "sync": kenc.dense_encode(flat0),
                      "bad_sync": kenc.dense_encode(bad),
                      "seed": wire.encode_seed(wire.SeedMessage(wire.SeedFamily.BERN, 0, 0, 1.0, 1, 0, 0.5),
                                               n)}}


def delta_phase(np, torch, dev, eng, params, msgs, card):
    """(s3): the replica applies ``delta_messages``' messages. At full width
    the SPARSE delta, framed as DATA seq 1, through
    ``DecodeEngine.delta_sync``: the masters equal masters + delta bit for
    bit, the bf16 copy refreshed, the served logits changed, unpack_bits
    launched. Then at smoke width on the card: NATURAL and DENSE deltas, a
    DENSE SYNC, StaleDelta, SequenceGap, SEED refused, and a non-finite
    payload refused with the parameters untouched. Returns the timings and
    the full-width delta_sync's launches."""
    from repro_torch import transport, wire
    from repro_torch.kernels import runtime
    from repro_torch.serve import DecodeEngine

    if params.size != msgs["d"]:
        fail(f"(s3) the served model has {params.size} parameters, the delta {msgs['d']}")
    frame = transport.encode_frame(transport.FrameType.DATA, 1, msgs["buf"])
    probe = torch.from_numpy(_tokens(np, eng.cfg, FULL_BATCH, 16, seed=300)).to(dev)
    before_logits = eng.prefill(eng._stepper(), probe)
    before = params.flat.detach().clone()
    counted = dict(runtime.LAUNCHES)
    t0 = time.perf_counter()
    eng.delta_sync(frame)
    torch.cuda.synchronize()
    sync_s = time.perf_counter() - t0
    sync_launches = {k: v - counted.get(k, 0) for k, v in runtime.LAUNCHES.items()
                     if v != counted.get(k, 0)}
    if sync_launches.get("unpack_bits", 0) <= 0:
        fail("(s3) delta_sync never launched unpack_bits")
    if eng.params is not params or not bits_equal(
            torch, params.flat.detach(), before + torch.from_numpy(msgs["host"]).to(dev)):
        fail("(s3) the masters after delta_sync are not masters + delta bit for bit")
    if not bits_equal(torch, params.flat_low, params.flat.detach().to(torch.bfloat16)):
        fail("(s3) the bf16 copy was not refreshed")
    after_logits = eng.prefill(eng._stepper(), probe)
    moved = float((after_logits.float() - before_logits.float()).abs().max())
    if moved == 0.0:
        fail("(s3) the served logits did not change after the delta")
    del before
    log(f"(s3) delta_sync of the DATA frame {sync_s * 1e3:.1f} ms (incl. the frame's CRC32C in Python) "
        f"with launches {sync_launches}; masters = masters + delta bit for bit, bf16 copy refreshed, "
        f"served logits moved by up to {moved:.4g} ({card})")

    # smoke width: the other codecs, the sequence gate, the refusals
    m = msgs["smoke"]
    p, flat0, bare = m["params"], m["flat0"], m["bare"]
    e = DecodeEngine(m["cfg"], p, cache_len=16, batch_size=1, device=dev)
    e.delta_sync(transport.encode_frame(transport.FrameType.DATA, 1, m["nat_buf"]))
    if not bits_equal(torch, p.flat.detach(), flat0 + m["nat"]):
        fail("(s3) NATURAL delta: masters != masters + delta")
    before = p.flat.detach().clone()
    e.delta_sync(transport.encode_frame(transport.FrameType.DATA, 2, bare))
    if not bits_equal(torch, p.flat.detach(), before + m["dense"]):
        fail("(s3) DENSE delta: masters != masters + delta")
    for bad_seq, exc in ((2, transport.StaleDelta), (4, transport.SequenceGap)):
        try:
            e.delta_sync(transport.encode_frame(transport.FrameType.DATA, bad_seq, bare))
        except exc:
            pass
        else:
            fail(f"(s3) DATA seq {bad_seq} after 2 did not raise {exc.__name__}")
    e.delta_sync(transport.encode_frame(transport.FrameType.SYNC, 9, m["sync"]))
    if not bits_equal(torch, p.flat.detach(), flat0):
        fail("(s3) SYNC did not restore the full model")
    e.delta_sync(transport.encode_frame(transport.FrameType.DATA, 10, bare))  # the gate reset to 9
    kept = p.flat.detach().clone()
    for buf_, exc in ((m["seed"], ValueError),
                      (transport.encode_frame(transport.FrameType.SYNC, 20, m["bad_sync"]), wire.CorruptFrame)):
        try:
            e.delta_sync(buf_)
        except exc:
            pass
        else:
            fail(f"(s3) a {'SEED' if buf_ is m['seed'] else 'non-finite'} message was applied")
        if not bits_equal(torch, p.flat.detach(), kept):
            fail("(s3) a refused message changed the parameters")
    log("(s3) smoke width on the card: NATURAL and DENSE deltas exact, DENSE decode_device = host "
        "codec in fp32/fp16/bf16, StaleDelta and SequenceGap raised, SYNC restores and resets the "
        "gate, SEED and a non-finite SYNC refused with the parameters untouched")
    return {"encode_s": msgs["encode_s"], "host_decode_ms": msgs["host_decode_ms"],
            "decode_device_ms": msgs["decode_device_ms"], "delta_sync_ms": sync_s * 1e3,
            "bytes": len(msgs["buf"]), "nnz": msgs["nnz"], "launches": sync_launches}


def unpack_timing(np, torch, dev, buf, d, timed, card):
    """unpack_bits at (s3)'s message's three streams (index, sign, fp32
    magnitude; DELTA_NNZ values each), timed after the serving path's
    counters were read: {width: (ms, bound_ms)}."""
    from repro_torch import wire
    from repro_torch.kernels import ops

    count = DELTA_NNZ
    words = torch.from_numpy(np.frombuffer(buf, dtype="<i4", offset=wire.HEADER_BYTES + 8).copy()).to(dev)
    unpack = {}
    o = 0
    for w in (wire.index_width(d), 1, 32):
        nw = wire.n_words(count, w)
        stream = words[o:o + nw]
        o += nw
        ms = timed(lambda: ops.unpack_bits(stream, w, count))
        bound = (nw * 4 + count * 4) / HBM_BYTES_PER_S * 1e3
        unpack[w] = (ms, bound)
        log(f"(s3) unpack_bits width {w}, {count:,} values: {ms:.5f} ms (bound {bound:.5f} by bytes) ({card})")
    return unpack


def eager_decode_ms(torch, dev):
    """The serve suite's decode schedule (``serve_bench``: gemma-2b smoke,
    batch 2, 16 greedy steps after an 8-token prompt) with ``lm.decode_step``
    called eagerly, as the engine ran it before it captured the step in a
    CUDA graph: the median wall ms of N_REQUESTS runs after one warm-up."""
    import statistics

    from repro_torch import configs, serve_bench
    from repro_torch.models import lm

    cfg = configs.get_smoke("gemma-2b")
    p = lm.lm_init(cfg, device=dev, seed=0)
    walls = []
    for _ in range(serve_bench.N_REQUESTS + 1):
        caches = lm.cache_init(cfg, serve_bench.BATCH, serve_bench.PROMPT_LEN + serve_bench.NEW_TOKENS,
                               device=dev)
        tok = torch.zeros((serve_bench.BATCH, 1), dtype=torch.int64, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(serve_bench.NEW_TOKENS):
            logits, caches = lm.decode_step(cfg, p, caches, tok, serve_bench.PROMPT_LEN + i)
            tok = torch.argmax(logits, dim=-1).reshape(serve_bench.BATCH, 1)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls[1:])


def serve_suite_phase(np, torch, dev, card):
    """(s4): the serve suite of the harness on the card (``repro_torch.run``'s
    ``main(["serve"])``, what ``python -m repro_torch.run serve`` runs), then
    :func:`hold_to_baselines`: the reference's ``value`` gates (latency and
    tokens/s) and every gate of the port's H100 baseline. Returns the fresh
    rows."""
    import os
    import tempfile

    from repro_torch import obs, run, serve_bench

    out = tempfile.mkdtemp(prefix="serve_bench_")
    t0 = time.perf_counter()
    rc = run.main(["serve", "--out", out])
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"(s4) repro_torch.run serve exited {rc}")
    fresh = obs.load(os.path.join(out, "BENCH_serve.json"))
    if obs.validate(fresh):
        fail(f"(s4) BENCH_serve.json invalid: {obs.validate(fresh)}")
    rows = {k: v.get("value") for k, v in fresh["metrics"].items() if k.endswith(("_ms", "_per_s"))}
    log(f"(s4) python -m repro_torch.run serve: {wall:.1f} s; rows {rows} ({card})")
    eager_ms = eager_decode_ms(torch, dev)
    log(f"(s4) the suite's decode (16 greedy steps at batch 2) with the step eager, no CUDA graph, "
        f"for the record: p50 {eager_ms:.4f} ms over {serve_bench.N_REQUESTS} runs, wall clock ({card})")
    hold_to_baselines("(s4)", "serve", fresh)
    return rows, wall


# ---------------------------------------------------------------------------
# the LM training path (phase t)
# ---------------------------------------------------------------------------

TRAIN_SPECS = ("marina:perm", "marina:ind", "marina:same", "ef21p:128:1024", "none")
TRAIN_W, TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2, 512, 3
TRAIN_PARAMS = 119_550_720  # examples/train_lm.py::model_100m, by the reference's count_params
# (t1) the card's train steps against the CPU port's from the same weights,
# batches and draws: the first step's loss differs only by the forward's
# bf16 products (cuBLAS against an fp32 product rounded once), a few 1e-4 at
# a loss of ~6; the next two add AdamW's per-coordinate sign flips of tiny
# gradients (<= 2.2 lr a coordinate, lr 1e-3)
TRAIN_DEV_LOSS_ATOL = 0.02
MEAN_ATOL = 1e-5  # RotK's exact mean in fp32 (tests/test_trainer.py's bound)
# kernels that must launch between the counters' reset before (t1) and the read after (t4)
TRAIN_KERNELS = ("block_topk", "rotk_apply_rows", "pack_bits", "sparse_streams", "dense_bits")


def _to(torch, x, dev):
    """``x`` (a tensor, or dicts and lists of them beside host values) on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(torch, v, dev) for k, v in x.items()}
    if isinstance(x, list):
        return [_to(torch, v, dev) for v in x]
    return x


def _draws_to(torch, draws, dev):
    return draws._replace(rot=_to(torch, draws.rot, dev), masks=_to(torch, draws.masks, dev))


def train_kernels_vs_plain(np, torch, dev, sizes):
    """(t0), before the counters' reset: block_topk (k 128, block 1024),
    rotk_apply (n 4, every worker) and rotk_apply_rows (4 rows, as the perm
    downlink calls it; f32, fp16 and bf16) at every leaf size of demo-100m
    against their plain versions, bit for bit, and both rotk entries at
    misaligned offsets and odd sizes; AdamW and SGD on the card against the
    CPU, bit for bit (the FMA forms of optim/optimizers.py). Returns {kernel:
    max abs error}."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.optim import optimizers as O

    gen = torch.Generator(dev).manual_seed(41)
    err = {"block_topk": 0.0, "rotk_apply": 0.0, "rotk_apply_rows": 0.0}
    for s in sorted(set(sizes)):
        x = torch.randn(s, generator=gen, device=dev) * 1e-3
        got = ops.block_topk(x, k_per_block=128, block=1024)
        want = ref.block_topk_ref(F.pad(x, (0, (-s) % 1024)), k_per_block=128, block=1024)[:s]
        torch.cuda.synchronize()
        if not bits_equal(torch, got, want):
            fail(f"(t0) block_topk at {s} values: kernel != plain")
        err["block_topk"] = max(err["block_topk"], float_err(torch, got, want))
        for dtype in (torch.float32, torch.float16, torch.bfloat16):
            w = torch.randn(s, generator=gen, device=dev).to(dtype)
            delta = (torch.randn(s, generator=gen, device=dev) * 1e-3).to(dtype)
            rot = torch.randint(0, TRAIN_W, (1,), generator=gen, device=dev, dtype=torch.int32)
            for i in range(TRAIN_W):
                got = ops.rotk_apply(w, delta, rot, n=TRAIN_W, worker=i)
                want = ref.rotk_apply_ref(w, delta, rot, n=TRAIN_W, worker=i)
                torch.cuda.synchronize()
                if not bits_equal(torch, got, want):
                    fail(f"(t0) rotk_apply {dtype} at {s} values, worker {i}: kernel != plain")
                err["rotk_apply"] = max(err["rotk_apply"], float_err(torch, got, want))
            rows = torch.stack([w] + [w + (torch.randn(s, generator=gen, device=dev) * 1e-3).to(dtype)
                                      for _ in range(TRAIN_W - 1)])
            e, _ = rotk_rows_cases(np, torch, dev, f"(t0) at {s} values", rows, delta, TRAIN_W,
                                   rs=(int(rot), -3))
            err["rotk_apply_rows"] = max(err["rotk_apply_rows"], e)
            del rows
    e, _ = rotk_offsets_vs_plain(np, torch, dev, "(t0)", (7, 1_000_000, 1_000_003), TRAIN_W,
                                 (torch.float32, torch.float16, torch.bfloat16))
    for kname in e:
        err[kname] = max(err[kname], e[kname])
    rng = np.random.default_rng(43)
    n = 1_000_003
    p, g, m = (torch.from_numpy((rng.standard_normal(n) * sc).astype(np.float32)) for sc in (1.0, 1e-2, 1e-3))
    v = torch.from_numpy((np.abs(rng.standard_normal(n)) * 1e-5).astype(np.float32))
    for count in (0, 3, 99):
        for lr in (np.float32(3e-4), torch.tensor(np.float32(3e-4))):
            cpu = O.adamw_update(g, {"m": m, "v": v, "count": count}, p, lr, weight_decay=0.01)
            card = O.adamw_update(g.to(dev), {"m": m.to(dev), "v": v.to(dev), "count": count}, p.to(dev),
                                  _to(torch, lr, dev), weight_decay=0.01)
            for a, b in ((cpu[0], card[0]), (cpu[1]["m"], card[1]["m"]), (cpu[1]["v"], card[1]["v"])):
                if not bits_equal(torch, a, b.cpu()):
                    fail(f"(t0) adamw_update count={count} lr={type(lr).__name__}: card != CPU")
    cpu = O.sgd_update(g, {"mu": m}, p, np.float32(2e-3), momentum=0.9, weight_decay=0.01)
    card = O.sgd_update(g.to(dev), {"mu": m.to(dev)}, p.to(dev), np.float32(2e-3), momentum=0.9,
                        weight_decay=0.01)
    if not (bits_equal(torch, cpu[0], card[0].cpu()) and bits_equal(torch, cpu[1]["mu"], card[1]["mu"].cpu())):
        fail("(t0) sgd_update: card != CPU")
    log(f"(t0) block_topk, rotk_apply and rotk_apply_rows (f32, fp16, bf16) bit-equal to their plain "
        f"versions at all {len(set(sizes))} leaf sizes of demo-100m, the rotk entries also at misaligned "
        "offsets and odd sizes; AdamW and SGD on the card bit-equal to the CPU")
    return err


def train_smoke_phase(np, torch, dev):
    """(t1): every smoke config, 2 workers, 3 MARINA-P (perm) steps on the
    card and on the CPU port from the same weights, batches and draws: losses
    within TRAIN_DEV_LOSS_ATOL, finite. Returns the worst |loss diff|."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import lm
    from repro_torch.models import params as P
    from repro_torch.optim import constant_lr, make_optimizer
    from repro_torch.train import TrainerConfig, init_state, make_downlink, make_train_step
    from repro_torch.train import downlink as D

    worst = 0.0
    for arch in configs.ALIASES:
        cfg = configs.get_smoke(arch)
        tcfg = TrainerConfig(n_workers=2, attn_chunk=32)
        dl, opt = make_downlink("marina:perm", 2), make_optimizer("adamw")
        step = make_train_step(cfg, tcfg, dl, opt, constant_lr(1e-3))
        st_cpu = init_state(cfg, tcfg, dl, opt, seed=0, device="cpu")
        st_dev = _to(torch, st_cpu, dev)
        data = SyntheticLMData(cfg, 2, 2, 64, device="cpu")
        sizes = P.leaf_sizes(lm.lm_spec(cfg))
        gen = torch.Generator().manual_seed(1)
        diffs = []
        for i in range(3):
            batch, draws = data.batch(i), D.draw_round(dl, sizes, gen, gen)
            st_cpu, m_cpu = step(st_cpu, batch, draws)
            st_dev, m_dev = step(st_dev, _to(torch, batch, dev), _draws_to(torch, draws, dev))
            lc, lg = float(m_cpu["loss"]), float(m_dev["loss"])
            if not np.isfinite(lg) or abs(lg - lc) > TRAIN_DEV_LOSS_ATOL:
                fail(f"(t1) {arch} step {i}: card loss {lg} vs CPU {lc}")
            diffs.append(abs(lg - lc))
        worst = max(worst, max(diffs))
        log(f"(t1) {arch:26s} losses on the card {float(m_dev['loss']):.5f} (CPU {float(m_cpu['loss']):.5f}), "
            f"max |card - CPU| over 3 steps {max(diffs):.2e}")
    return worst


def train_step_profile(torch, dev, step):
    """One train step (``step()``) under ``torch.profiler``: host ms, the
    device kernels, device ms and the GEMMs' ms of it, and the five kernels
    of most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.trace_round import _device_us

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    gemm = [e for e in events if any(k in e.key.lower() for k in ("gemm", "nvjet", "xmma", "cutlass"))]
    top = sorted(events, key=_device_us, reverse=True)[:5]
    return {"wall_ms": wall_ms, "kernels": sum(e.count for e in events),
            "device_ms": sum(_device_us(e) for e in events) / 1e3,
            "gemm_ms": sum(_device_us(e) for e in gemm) / 1e3,
            "top": [(e.key[:48], e.count, _device_us(e) / 1e3) for e in top]}


def train_full_phase(np, torch, dev, card):
    """(t2): demo-100m at full width (train_lm.model_100m: 119,550,720
    parameters, 12 leaves), 4 workers x batch 2 x seq 512, AdamW (wd 0.01),
    cosine_warmup(3e-4), TRAIN_STEPS steps under each downlink spec and
    marina:perm with bf16 replicas: finite losses; RotK's exact mean after
    every no-sync fp32 round; bits_per_worker equal to the formula over the
    drawn coins; EF21-P's drift contracting over 6 rounds at the final server.
    marina:perm launches rotk_apply_rows once a leaf in every compressed
    round and nothing else launches it. Returns ({run: (ms a step, tokens/s,
    peak GiB, last loss)}, bf16 rotk_apply_rows launches, (x_old, x_new) of
    the last fp32 perm step, the sizes)."""
    from repro_torch.core.comm_model import CommModel
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import runtime
    from repro_torch.models import lm
    from repro_torch.models import params as P
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.train import TrainerConfig, init_state, make_downlink, make_train_step
    from repro_torch.train import downlink as D
    from repro_torch.train_lm import model_100m

    cfg = model_100m()
    sizes = P.leaf_sizes(lm.lm_spec(cfg))
    d = sum(sizes)
    if d != TRAIN_PARAMS or lm.count_params(cfg) != d or len(sizes) != 12:
        fail(f"(t2) demo-100m has {d} parameters in {len(sizes)} leaves, expected {TRAIN_PARAMS} in 12")
    cm = CommModel(d=d)
    out, pair, bf16_launches = {}, None, 0
    for spec, wdt in [(s, torch.float32) for s in TRAIN_SPECS] + [("marina:perm", torch.bfloat16)]:
        name = spec + ("/bf16" if wdt == torch.bfloat16 else "")
        tcfg = TrainerConfig(n_workers=TRAIN_W, attn_chunk=128, weight_dtype=wdt)
        dl = make_downlink(spec, TRAIN_W)
        opt = make_optimizer("adamw", weight_decay=0.01)
        step = make_train_step(cfg, tcfg, dl, opt,
                               cosine_warmup(3e-4, warmup=min(50, TRAIN_STEPS // 4), total=TRAIN_STEPS))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = runtime.LAUNCHES["rotk_apply_rows"]
        state = init_state(cfg, tcfg, dl, opt, seed=0, device=dev)
        data = SyntheticLMData(cfg, TRAIN_W, TRAIN_B, TRAIN_S, device=str(dev))
        gen, dgen = torch.Generator().manual_seed(7), torch.Generator(dev).manual_seed(7)
        bits, times, losses, mean_err, syncs = np.float32(0), [], [], 0.0, 0
        for i in range(TRAIN_STEPS):
            batch, draws = data.batch(i), D.draw_round(dl, sizes, gen, dgen)
            x_old = state["server"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, draws)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            if dl is None:
                continue
            sync = isinstance(dl, D.MarinaPDownlink) and draws.coin
            syncs += sync
            frac = dl.frac if isinstance(dl, D.MarinaPDownlink) else dl.k_per_block / dl.block
            bits = np.float32(bits + np.float32(cm.dense_bits() if sync else cm.sparse_bits(frac * d)))
            if spec == "marina:perm" and wdt == torch.float32 and not sync:
                err = (state["workers"].mean(0) - state["server"]).abs().max().item()
                mean_err = max(mean_err, err)
                if err > MEAN_ATOL:
                    fail(f"(t2) {name} step {i}: max |mean_i w_i - x| = {err} > {MEAN_ATOL}")
                pair = (x_old, state["server"])
        rows_launches = runtime.LAUNCHES["rotk_apply_rows"] - before
        want_rows = len(sizes) * (TRAIN_STEPS - syncs) if spec == "marina:perm" else 0
        if rows_launches != want_rows:
            fail(f"(t2) {name}: {rows_launches} rotk_apply_rows launches, expected {want_rows} "
                 f"(one a leaf in each of {TRAIN_STEPS - syncs} compressed rounds)")
        if not np.all(np.isfinite(losses)):
            fail(f"(t2) {name}: losses {losses}")
        if spec == "marina:perm" and wdt == torch.float32 and pair is None:
            fail(f"(t2) {name}: every round was a sync; no compressed round to measure in (t3)")
        if state["bits_per_worker"] != bits:
            fail(f"(t2) {name}: bits_per_worker {state['bits_per_worker']} != formula {bits}")
        extra = ""
        if isinstance(dl, D.EF21PDownlink):
            target, shift = state["server"], state["workers"]
            drifts = [float(dl.worker_drift(target, shift))]
            for _ in range(6):
                shift, _ = dl.round(D.DownlinkDraws(), sizes, target, shift)
                drifts.append(float(dl.worker_drift(target, shift)))
            if not drifts[-1] < 0.3 * drifts[0]:
                fail(f"(t2) {name}: EF21-P drift at a fixed server {drifts} does not contract")
            extra = f", drift at the final server over 6 rounds {drifts[0]:.3e} -> {drifts[-1]:.3e}"
        if spec == "marina:perm":
            extra = (f", {syncs} sync rounds, max |mean_i w_i - x| {mean_err:.2e}" if wdt == torch.float32
                     else f", {syncs} sync rounds, drift {float(m['drift']):.3e}")
            extra += f", {rows_launches} rotk_apply_rows launches ({len(sizes)} a compressed round)"
        if spec == "marina:perm" and wdt == torch.float32:
            # where a step's time goes: the last step again, under the profiler
            prof = train_step_profile(torch, dev, lambda: step(state, batch, draws))
            log(f"(t2) {name} one step under the profiler: {prof['wall_ms']:.1f} ms on the host clock, "
                f"{prof['kernels']} kernels, {prof['device_ms']:.2f} ms of device time (busy share "
                f"{prof['device_ms'] / prof['wall_ms']:.3f}), GEMMs {prof['gemm_ms']:.2f} ms; top "
                + "; ".join(f"{k} x{c} {ms_:.2f} ms" for k, c, ms_ in prof["top"]) + f" ({card})")
        if wdt == torch.bfloat16:
            bf16_launches = rows_launches
        ms = float(np.median(times[2:])) * 1e3
        tokens_s = TRAIN_W * TRAIN_B * TRAIN_S / (ms / 1e3)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        out[name] = (ms, tokens_s, peak, losses[-1])
        log(f"(t2) {name:18s} {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
            f"{ms:.2f} ms a step (median of steps 2-{TRAIN_STEPS - 1}; first {times[0] * 1e3:.1f}), "
            f"{tokens_s:,.0f} tokens/s, peak {peak:.2f} GiB, bits/worker {float(bits):.6e} = formula{extra} "
            f"({card})")
        del state, m, data, step
    torch.cuda.empty_cache()
    return out, bf16_launches, pair, sizes


def train_wire_phase(np, torch, dev, sizes, pair, card):
    """(t3a), inside the launch window: measure_wire at full width (device
    encode) of one sync round and one compressed round of each MARINA-P mode
    (perm, ind, same) and of EF21-P, from the last fp32 perm step's x_t and
    x_{t+1}: the measured-vs-analytic gap, seconds and peak memory of each.
    Returns {name: (downlink, draws)} for (t3b)."""
    from repro_torch.train import downlink as D

    x_old, x_new = pair
    gen, dgen = torch.Generator().manual_seed(3), torch.Generator(dev).manual_seed(3)
    cases = {f"marina:{mode}": (D.MarinaPDownlink(TRAIN_W, mode, p=1e-12), None)
             for mode in ("perm", "ind", "same")}
    cases = {k: (dl, D.draw_round(dl, sizes, gen, dgen)) for k, (dl, _) in cases.items()}
    cases["sync"] = (D.MarinaPDownlink(TRAIN_W, "perm"), D.DownlinkDraws(coin=True))
    cases["ef21p:128:1024"] = (D.EF21PDownlink(TRAIN_W, 128, 1024), D.DownlinkDraws())
    for name, (dl, draws) in cases.items():
        if draws.coin != (name == "sync"):
            fail(f"(t3) {name}: drew coin={draws.coin}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = dl.measure_wire(draws, sizes, x_new, x_old, device_encode=True)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        gap = (res["bits_mean"] - res["bits_analytic"]) / res["bits_analytic"]
        log(f"(t3) measure_wire {name:15s} d={sum(sizes):,}: measured {res['bits_mean']:.6e} bits/worker, "
            f"analytic {res['bits_analytic']:.6e}, gap {gap * 100:+.3f}%, {secs:.2f} s, peak "
            f"{peak:.2f} GiB ({card})")
    return cases


def train_wire_buffers(np, torch, dev, sizes, pair, cases):
    """(t3b), after the counters' read: the device buffers of (t3a)'s rounds
    against the host codec, byte for byte: the DENSE sync buffer, EF21-P's
    message, rows 0 and W-1 of perm and row 0 of ind and same (the host
    codec takes ~6 s a 30M-entry row: the six encodes run in threads)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import wire
    from repro_torch.kernels import encode as kenc

    x_old, x_new = pair
    todo = []
    for name, (dl, draws) in cases.items():
        if name == "sync":
            pairs = [(kenc.dense_encode(x_new), x_new, wire.encode_dense)]
        elif name.startswith("ef21p"):
            delta = dl.compressed(sizes, x_new, x_old)
            pairs = [(kenc.sparse_encode(delta), delta, wire.encode_sparse)]
        else:  # perm: the first and last workers' partitions; ind: worker 0; same: its one row
            Q = dl.messages(draws, sizes, x_new, x_old)
            bufs = kenc.encode_rows(Q)
            rows = (0, Q.shape[0] - 1) if name == "marina:perm" else (0,)
            pairs = [(bufs[i], Q[i], wire.encode_sparse) for i in rows]
        todo += [(name, buf, x.cpu().numpy(), host) for buf, x, host in pairs]
    with ThreadPoolExecutor(len(todo)) as pool:
        same = list(pool.map(lambda job: job[1] == job[3](job[2]), todo))
    for (name, *_), ok in zip(todo, same):
        if not ok:
            fail(f"(t3) {name}: device buffer != host codec")
    compared = len(todo)
    log(f"(t3) {compared} full-width device buffers byte-identical to the host codec "
        "(DENSE sync, EF21-P, rows 0 and W-1 of perm, row 0 of ind and of same)")


def train_transport_phase(np, torch, dev, card):
    """(t4): ``train_loop`` of tests/test_transport.py's tiny LM (1 layer,
    d_model 32, 4 workers; the frames' CRC32C is pure Python, ~0.25 s a MB,
    so a smoke config's messages would take seconds a round) through
    ``transport_bench.CHAOS_SPEC`` under marina:perm and ef21p:16:64, 12
    rounds, on the card and on the CPU port from the same weights and draws
    (init_state and draw_round patched to draw on the CPU): every transport
    counter equal, losses within TRAIN_DEV_LOSS_ATOL. Returns ms a round on
    the card."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import constant_lr, make_optimizer
    from repro_torch.train import TrainerConfig, make_downlink, train_loop
    from repro_torch.train import downlink as D
    from repro_torch.train import trainer as TR
    from repro_torch.transport_bench import CHAOS_SPEC

    cfg = ModelConfig(arch_id="t", family="gqa", num_layers=1, d_model=32, num_heads=2, num_kv_heads=2,
                      head_dim=16, d_ff=64, vocab_size=64)
    real_init, real_draw = TR.init_state, D.draw_round
    ms = {}
    for spec in ("marina:perm", "ef21p:16:64"):
        runs = {}
        for device in ("cpu", dev):
            cpu_gen = torch.Generator().manual_seed(11)

            def init_on_cpu(*a, device, **kw):
                return _to(torch, real_init(*a, device="cpu", **kw), device)

            def draw_on_cpu(dl, sizes, gen, dev_gen, device=device, cpu_gen=cpu_gen):
                return _draws_to(torch, real_draw(dl, sizes, gen, cpu_gen), device)

            TR.init_state, D.draw_round = init_on_cpu, draw_on_cpu
            try:
                t0 = time.perf_counter()
                _, m = train_loop(cfg, TrainerConfig(n_workers=4, attn_chunk=32), make_downlink(spec, 4),
                                  make_optimizer("adamw"), constant_lr(1e-3),
                                  SyntheticLMData(cfg, 4, 2, 64, device=str(device)), steps=12, seed=2,
                                  device=device, transport=CHAOS_SPEC)
                runs[str(device)] = (m, (time.perf_counter() - t0) / 12 * 1e3)
            finally:
                TR.init_state, D.draw_round = real_init, real_draw
        (mc, _), (mg, ms[spec]) = runs["cpu"], runs[str(dev)]
        if mc["transport"] != mg["transport"]:
            diff = {k: (mc["transport"][k], mg["transport"].get(k)) for k in mc["transport"]
                    if mc["transport"][k] != mg["transport"].get(k)}
            fail(f"(t4) {spec} through CHAOS_SPEC: transport counters differ (CPU, card): {diff}")
        if abs(float(mc["loss"]) - float(mg["loss"])) > TRAIN_DEV_LOSS_ATOL:
            fail(f"(t4) {spec}: loss on the card {float(mg['loss'])} vs CPU {float(mc['loss'])}")
        t = mg["transport"]
        log(f"(t4) {spec} through CHAOS_SPEC, 12 rounds: transport counters equal on card and CPU "
            f"(frames {t['transport/frames_sent']:.0f}, retries {t['transport/retries']:.0f}, "
            f"forced syncs {t['transport/forced_syncs']:.0f}, goodput {t['transport/goodput']:.6f}); "
            f"{ms[spec]:.1f} ms a round on the card ({card})")
    return ms


def train_kernel_timing(np, torch, dev, timed, big, card):
    """block_topk (k 128, block 1024), rotk_apply (n 4; f32, fp16, bf16),
    rotk_apply_rows (4 rows, n 4; f32, bf16) and the per-worker path the rows
    entry replaced (4 x rotk_apply + a copy into the row) at the largest leaf
    of demo-100m (the embedding, ``big`` values), timed after the training
    path's counters were read; plain versions at the leaf median of 5:
    {name: (ms, plain ms or None, bound ms, library ms or None)}."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(dev).manual_seed(47)
    x = torch.randn(big, generator=gen, device=dev)
    xp = F.pad(x, (0, (-big) % 1024))

    def library():
        idx = torch.topk(xp.view(-1, 1024).abs(), 128, dim=1).indices
        return torch.zeros_like(xp).view(-1, 1024).scatter_(1, idx, xp.view(-1, 1024).gather(1, idx))

    out = {"block_topk": (timed(lambda: ops.block_topk(x, k_per_block=128, block=1024)),
                          timed(lambda: ref.block_topk_ref(xp, k_per_block=128, block=1024)),
                          8 * big / HBM_BYTES_PER_S * 1e3, timed(library))}
    rot = torch.tensor([1], dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        dt = str(dtype).split('.')[-1]
        w, delta = x.to(dtype), (x * 1e-3).to(dtype)
        size = w.element_size()
        out[f"rotk_apply/{dt}"] = (
            timed(lambda: ops.rotk_apply(w, delta, rot, n=TRAIN_W, worker=2)),
            timed(lambda: ref.rotk_apply_ref(w, delta, rot, n=TRAIN_W, worker=2), reps=5),
            (3 * size * big + 4) / HBM_BYTES_PER_S * 1e3, None)
        if dtype == torch.float16:  # the replicas are f32 or bf16
            continue
        W4 = torch.randn(TRAIN_W, big, generator=gen, device=dev).to(dtype)
        O4 = torch.empty_like(W4)

        def per_worker():
            for i in range(TRAIN_W):
                O4[i] = ops.rotk_apply(W4[i], delta, rot, n=TRAIN_W, worker=i)

        rows_bound = ((2 * TRAIN_W + 1) * size * big + 4) / HBM_BYTES_PER_S * 1e3
        out[f"rotk_apply_rows/{dt}"] = (
            timed(lambda: ops.rotk_apply_rows(W4, delta, rot, n=TRAIN_W, out=O4)),
            timed(lambda: ref.rotk_apply_rows_ref(W4, delta, rot, n=TRAIN_W), reps=5), rows_bound, None)
        out[f"per-worker rotk_apply + copy/{dt}"] = (timed(per_worker), None, rows_bound, None)
        del W4, O4
    for name, (ms_, plain_, bound_, lib_) in out.items():
        log(f"(t) {name} at {big:,} values: {ms_:.5f} ms"
            + (f", plain {plain_:.5f}" if plain_ is not None else "")
            + f", bound {bound_:.5f} by bytes (share {bound_ / ms_:.3f})"
            + (f", torch.topk + scatter {lib_:.5f}" if lib_ is not None else "") + f" ({card})")
    return out


def per_worker_round(dl, draws, sizes, server_new, server_old, workers):
    """The perm round as the downlink made it before the rows entry: one
    rotk_apply a worker and leaf, copied into the worker's row (timed beside
    ``MarinaPDownlink.round``; its outputs must equal the rows path's)."""
    from repro_torch.kernels import ops

    n = dl.n_workers
    new = workers.new_empty(workers.shape)
    o = 0
    for li, s in enumerate(sizes):
        delta = (server_new[o:o + s] - server_old[o:o + s]).to(workers.dtype)
        for i in range(n):
            new[i, o:o + s] = ops.rotk_apply(workers[i, o:o + s], delta, draws.rot[li:li + 1], n=n, worker=i)
        o += s
    return new


def downlink_round_timing(np, torch, dev, flush, sizes, card):
    """The perm downlink's time a compressed round at full width (demo-100m's
    leaves, TRAIN_W replicas; f32 and bf16 replicas): ``MarinaPDownlink.round``
    (one rotk_apply_rows a leaf) against :func:`per_worker_round`, in turns
    (per-worker, rows, rows, per-worker), each the median of 5 rounds between
    CUDA events queued behind a ~10 ms spin (so the host has queued the whole
    round: the card's time) and of 5 on the host clock ending in a sync; the
    outputs bit-equal, and the launches of each. Returns {dtype: {path: (device
    ms, host ms, launches)}}."""
    from repro_torch.kernels import runtime
    from repro_torch.train import downlink as D

    d = sum(sizes)
    gen = torch.Generator(dev).manual_seed(53)
    old = torch.randn(d, generator=gen, device=dev)
    new_s = old + torch.randn(d, generator=gen, device=dev) * 1e-3
    dl = D.MarinaPDownlink(n_workers=TRAIN_W, mode="perm")
    draws = D.DownlinkDraws(rot=torch.randint(0, TRAIN_W, (len(sizes),), generator=gen, device=dev,
                                              dtype=torch.int32))

    def device_ms(fn, reps=5):
        fn()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            flush.sum()
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[reps // 2]

    def host_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[reps // 2]

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        workers = (old + torch.randn(TRAIN_W, d, generator=gen, device=dev) * 1e-3).to(dtype)
        paths = {"per-worker": lambda: per_worker_round(dl, draws, sizes, new_s, old, workers),
                 "rows": lambda: dl.round(draws, sizes, new_s, old, workers)[0]}
        launches, outs = {}, {}
        for name, fn in paths.items():
            before = dict(runtime.LAUNCHES)
            outs[name] = fn()
            torch.cuda.synchronize()
            launches[name] = {k: v - before.get(k, 0) for k, v in runtime.LAUNCHES.items()
                              if v != before.get(k, 0)}
        if not bits_equal(torch, outs["rows"], outs["per-worker"]):
            fail(f"(t) the perm round's rows path != the per-worker path ({dtype})")
        del outs
        times = {name: [] for name in paths}
        for name in ("per-worker", "rows", "rows", "per-worker"):
            times[name].append((device_ms(paths[name]), host_ms(paths[name])))
        dt = str(dtype).split(".")[-1]
        out[dt] = {name: (float(np.mean([t[0] for t in ts])), float(np.mean([t[1] for t in ts])), launches[name])
                   for name, ts in times.items()}
        for name, (dev_ms, wall_ms, ln) in out[dt].items():
            log(f"(t) perm downlink round {dt} replicas, {name:10s} path: {dev_ms:.4f} ms of card time "
                f"({[round(t[0], 4) for t in times[name]]}), {wall_ms:.2f} ms on the host clock, launches {ln} "
                f"({card})")
        del workers
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the dry-run and the measured roofline share (phase u)
# ---------------------------------------------------------------------------

DRYRUN_DIR = ROOT / "runs" / "dryrun_chip"
MEASURED_ARCH = "gemma3-1b"
# kernels that must launch between the counters' reset before (u1) and the read after it:
# the compressed perm round of train_4k, one launch a leaf a step
DRYRUN_KERNELS = ("rotk_apply_rows",)


def dryrun_start():
    """(u0)'s counts, started: ``python -m repro_torch.launch.dryrun --arch A
    --out DRYRUN_DIR`` for each of the ten architectures, one process an
    architecture, all at the lowest CPU priority, so that they run on the
    host's idle cores beside the phases before (u). Returns (the processes,
    the start time)."""
    import os

    from repro_torch import configs

    if DRYRUN_DIR.exists():
        for f in DRYRUN_DIR.glob("*.json"):
            f.unlink()
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = {}
    for arch in configs.ALIASES:
        with open(DRYRUN_DIR / f"{arch}.log", "w") as out:  # a file: nothing reads a pipe until (u)
            procs[arch] = spawn([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--out",
                                 str(DRYRUN_DIR)], env=env, stdout=out, stderr=subprocess.STDOUT,
                                preexec_fn=lambda: os.nice(19))
    return procs, time.perf_counter()


def dryrun_phase(started, card):
    """(u0): the counts started by :func:`dryrun_start`, all four shapes of
    each architecture on the 16x16 mesh description, counted on ``meta``
    (no card); every record valid (``dryrun.record_problems``). Returns
    ({(arch, shape): record}, the seconds (u) waited for them)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun, specs

    procs, t0 = started
    t_wait = time.perf_counter()
    try:
        for proc in procs.values():
            proc.wait(timeout=600)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                kill_tree(proc)
    waited = time.perf_counter() - t_wait
    for arch, proc in procs.items():
        if proc.returncode != 0:
            fail(f"(u0) the dry-run of {arch} exited {proc.returncode}:\n"
                 f"{(DRYRUN_DIR / f'{arch}.log').read_text()[-3000:]}")
    recs = {}
    for arch in configs.ALIASES:
        for shape in specs.SHAPES:
            path = DRYRUN_DIR / f"{arch}__{shape}__16x16.json"
            rec = json.loads(path.read_text())
            problems = dryrun.record_problems(rec)
            if problems:
                fail(f"(u0) {path.name}: {problems}")
            recs[arch, shape] = rec
            t = rec["roofline"]
            log(f"(u0) {arch:26s} {shape:12s} flops {rec['flops_global']:.4e} bytes {rec['bytes_global']:.4e} "
                f"count {rec['t_count_s']:6.2f} s; per device (256, {rec['split']}): compute "
                f"{t['compute_s']:.4e} s, memory {t['memory_s']:.4e} s, collective "
                f"{'None' if t['collective_s'] is None else format(t['collective_s'], '.4e')} s, "
                f"{t['dominant']}; useful {rec['useful_flops_ratio']:.4f}")
    log(f"(u0) {len(recs)} dry-run records valid (H100 constants; no card used); started {t_wait - t0:.1f} s "
        f"before (u), which waited {waited:.1f} s more for them")
    return recs, waited


def measured_phase(np, torch, dev, recs, card):
    """(u1): gemma3-1b's four steps on the card at ``dryrun.REDUCED``'s sizes
    (``dryrun.measure_step``: train_4k's marina:perm train step, W = 2 x 1 x
    4096; prefill_32k's forward, batch 1 x 32768; decode_32k's and
    long_500k's DecodeEngine step through its CUDA graph, batch 16 x 32768
    and 1 x 524288), each merged into its (u0) record: finite output, ms,
    peak memory, the reduced step's count and bound, roofline_share, mfu."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models import lm

    out, params = {}, None
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        t0 = time.perf_counter()
        if shape != "train_4k" and params is None:  # the serving shapes share one set of weights
            params = lm.lm_init(configs.get(MEASURED_ARCH), device=dev, seed=0)
        m = dryrun.measure_step(MEASURED_ARCH, shape, device=dev, params=params)
        rec = dict(recs[MEASURED_ARCH, shape], measured=m)
        problems = dryrun.record_problems(rec)
        if problems:
            fail(f"(u1) {MEASURED_ARCH} {shape}: {problems}")
        (DRYRUN_DIR / f"{MEASURED_ARCH}__{shape}__16x16.json").write_text(json.dumps(rec, indent=1))
        out[shape] = m
        t = m["roofline"]
        log(f"(u1) {MEASURED_ARCH} {shape:12s} ({m['reduced']}): {m['ms']:.3f} ms a step (median of "
            f"{len(m['ms_runs'])} after {m['warmup']}: {[round(x, 3) for x in m['ms_runs']]}), peak "
            f"{m['peak_bytes'] / 2**30:.2f} GiB, output {m['output_shape']} finite; counted {m['flops']:.4e} "
            f"FLOPs, {m['bytes']:.4e} bytes: bound {t['bound_s'] * 1e3:.4f} ms ({t['dominant']}), "
            f"roofline_share {m['roofline_share']:.5f}, mfu {m['mfu']}; launches {m['launches']}; "
            f"{time.perf_counter() - t0:.1f} s ({m['card']})")
        log(f"(u1) top ops by bytes: {m['top_ops'][:5]}")
    del params
    torch.cuda.empty_cache()
    return out


def roofline_suite_phase(card):
    """(u2): ``repro_torch.run roofline`` over the records: a valid
    BENCH_roofline.json; then the report's table."""
    import os
    import tempfile

    from repro_torch import obs, roofline_report, run

    roofline_report.DEFAULT_DIR = str(DRYRUN_DIR)
    out = tempfile.mkdtemp()
    if run.main(["roofline", "--out", out]) != 0:
        fail("(u2) repro_torch.run roofline failed")
    doc = obs.load(os.path.join(out, "BENCH_roofline.json"))
    problems = obs.validate(doc)
    if problems or len(doc["metrics"]) != 44:
        fail(f"(u2) BENCH_roofline.json: {problems}, {len(doc['metrics'])} metrics (want 40 + 4)")
    log("(u2) BENCH_roofline.json valid, 44 metrics; the roofline table (16x16, H100 constants):")
    log(roofline_report.markdown_table(roofline_report.load(str(DRYRUN_DIR))))


# ---------------------------------------------------------------------------
# the paper's grid, the wire smoke and sigma_A (phase v)
# ---------------------------------------------------------------------------

# kernels that must launch in (v1) (the grid's runs) and in (v2) (wire_bench --smoke)
GRID_KERNELS = ("l1_subgrad", "block_topk")
WIRE_SMOKE_KERNELS = ("l1_subgrad", "block_topk", "bernk", "pack_bits", "unpack_bits", "sparse_streams",
                      "dense_bits", "mask_streams", "topk_streams")
# the reference's CSV columns (examples/federated_l1.py)
GRID_HEADER = ["d", "n", "noise", "method", "final_subopt", "rounds", "bits_per_worker"]
# (v1)'s CPU run of the s = 1 cell, in a process of its own beside the card's grid
GRID_CPU_CELL = """
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch import fig1
d, n, s, budget = json.loads(sys.argv[2])
res = fig1.run_suite(d=d, n=n, noise=s, budget_bits=budget, device="cpu")
with open(sys.argv[1], "w") as f:
    json.dump({name: {"f_x": r["hist"]["f_x"], "rounds": r["rounds"], "bits_per_worker": r["bits_per_worker"]}
               for name, r in res.items()}, f)
"""


def grid_phase(np, torch, dev, card):
    """(v1): ``federated_l1.main(["--out", tmp, "--device", "cuda"])``, the
    reduced grid (d = 200, n = 10, noise s in {0.1, 1, 10}, 4e6 bits a
    worker) of ``examples/federated_l1.py``: 24 rows under the reference's
    header; every run stopped at the first round at or past its budget. The
    s = 1 cell against the CPU port's ``fig1.run_suite`` (run in a process
    of its own meanwhile): the three constant-stepsize MARINA-P runs' f_x
    within TRAJ_RTOL every round, with equal rounds and bits; EF21-P's two
    runs equal rounds and bits (their f is the TopK tie lottery); the three
    Polyak MARINA-P runs' bits within TRAJ_RTOL and rounds within one, their
    f_x gap reported: a Polyak trajectory follows the last bits of gamma
    (tests/test_torch_federated_l1.py), and a late message can be one SPARSE
    entry shorter on one device, as in (n). Returns wall s."""
    import csv
    import os
    import tempfile

    from repro_torch import federated_l1, fig1

    d, n, s1, budget = federated_l1.REDUCED_CELLS[1]
    tmp = tempfile.mkdtemp(prefix="federated_l1_")
    out, cpu_json = os.path.join(tmp, "federated_l1.csv"), os.path.join(tmp, "cpu.json")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    cpu = spawn([sys.executable, "-c", GRID_CPU_CELL, cpu_json, json.dumps([d, n, s1, budget])],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    results = {}

    def recording(**kw):
        results[kw["noise"]] = fig1.run_suite(**kw)
        return results[kw["noise"]]

    try:
        federated_l1.run_suite = recording
        t0 = time.perf_counter()
        rc = federated_l1.main(["--out", out, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        cpu_log = cpu.communicate(timeout=900)[0]
        waited = time.perf_counter() - t1
    finally:
        federated_l1.run_suite = fig1.run_suite
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()
    if rc != 0 or cpu.returncode != 0:
        fail(f"(v1) federated_l1.main exited {rc}; the CPU run exited {cpu.returncode}:\n{cpu_log[-3000:]}")
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    if rows[0] != GRID_HEADER or len(rows) != 1 + 24:
        fail(f"(v1) {out}: header {rows[0]}, {len(rows) - 1} rows (want the reference's header and 24)")
    for row in rows[1:]:
        s, name, rounds, bits = float(row[2]), row[3], int(row[5]), float(row[6])
        hist = results[s][name]["hist"]
        last = hist["s2w_bits"][-1] - hist["s2w_bits"][-2]
        if not (bits == hist["s2w_bits"][-1] and rounds == len(hist["f_x"]) and bits >= budget > bits - last
                and np.isfinite(hist["f_x"]).all()):
            fail(f"(v1) {row}: not stopped at the first round past {budget:g} bits (last round {last} bits, "
                 f"{len(hist['f_x'])} rounds recorded)")
        log(f"(v1) d={row[0]} n={row[1]} s={s:5.1f} {name:20s} f-f*={float(row[4]):.6g} rounds={rounds} "
            f"bits/worker={bits:.6g} (last round {last:g} bits)")
    with open(cpu_json) as f:
        cpu_res = json.load(f)
    for name, want in cpu_res.items():
        got = results[s1][name]
        f_card, f_cpu = got["hist"]["f_x"], want["f_x"]
        m = min(len(f_card), len(f_cpu))
        rel = np.abs(np.subtract(f_card[:m], f_cpu[:m])) / np.abs(f_cpu[:m])
        over = np.flatnonzero(rel > TRAJ_RTOL)
        bits_rel = abs(got["bits_per_worker"] - want["bits_per_worker"]) / want["bits_per_worker"]
        log(f"(v1) s={s1} {name:20s} card vs CPU: rounds {got['rounds']} / {want['rounds']}, bits/worker "
            f"{got['bits_per_worker']!r} / {want['bits_per_worker']!r}, largest f_x gap {rel.max():.3e}"
            + (f" (first over {TRAJ_RTOL} at round {over[0]})" if over.size else ""))
        exact = name.startswith("ef21p") or name.endswith("const")
        if exact and (got["rounds"], got["bits_per_worker"]) != (want["rounds"], want["bits_per_worker"]):
            fail(f"(v1) {name}: rounds or bits differ between card and CPU")
        if not exact and (bits_rel > TRAJ_RTOL or abs(got["rounds"] - want["rounds"]) > 1):
            fail(f"(v1) {name}: bits rel diff {bits_rel:.3e}, rounds {got['rounds']} / {want['rounds']}")
        if name.startswith("marina") and name.endswith("const") and (m != len(f_cpu) or over.size):
            fail(f"(v1) {name}: card vs CPU f_x rel gap {rel.max():.3e} > {TRAJ_RTOL}")
    log(f"(v1) python -m repro_torch.federated_l1 (3 cells, 24 runs): {wall:.1f} s on the card, the CPU's s={s1} "
        f"cell done {waited:.1f} s after it ({card})")
    return wall


def wire_smoke_phase():
    """(v2): ``wire_bench.main(["--smoke", "--device", "cuda"])`` returns 0
    (byte identity, every MARINA-P gap below 5% at d=256, n=4, T=30).
    Returns wall s."""
    from repro_torch import wire_bench

    t0 = time.perf_counter()
    rc = wire_bench.main(["--smoke", "--device", "cuda"])
    if rc != 0:
        fail(f"(v2) python -m repro_torch.wire_bench --smoke exited {rc}")
    return time.perf_counter() - t0


SIGMA_CELL = """
from repro_torch.core import problems
A, _ = problems.algorithm3(n=100, d=1000, noise_scale=1.0, seed=0)
print(repr(float(problems.sigma_A(A))))
"""


def sigma_start():
    """(v3)'s host work, started at the lowest CPU priority: ``problems.sigma_A``
    of Algorithm 3's n = 100 matrices in a process of its own. Returns (the
    process, the start time)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))  # the BLAS threads of this process: sigma_A's last bits follow them
    return spawn([sys.executable, "-c", SIGMA_CELL], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                 text=True, preexec_fn=lambda: os.nice(19)), time.perf_counter()


def sigma_phase(started, sigma100):
    """(v3): ``problems.sigma_A`` of (q)'s n = 100 problem, recomputed from
    its A on the host (Algorithm 3's float64 matrices, before
    ``generate_problem`` placed them on the card as float32) by
    :func:`sigma_start`'s process, equal to ``prob.sigma_A`` bit for bit.
    Returns the seconds (v) waited for it."""
    proc, t0 = started
    t_wait = time.perf_counter()
    out, err = proc.communicate(timeout=600)
    waited = time.perf_counter() - t_wait
    if proc.returncode != 0:
        fail(f"(v3) the sigma_A process exited {proc.returncode}:\n{err[-3000:]}")
    got = float(out.split()[-1])
    if got != float(sigma100):
        fail(f"(v3) sigma_A of the n=100 problem's A {got!r} != generate_problem's {sigma100!r}")
    log(f"(v3) problems.sigma_A(A) of (q)'s n=100, d=1000, s=1 problem: {got!r}, bit-equal to "
        f"generate_problem's (on the host, started {t_wait - t0:.1f} s before (v3), which waited {waited:.1f} s "
        "more)")
    return waited


# ---------------------------------------------------------------------------
# the LM train step across a process group (phase w)
# ---------------------------------------------------------------------------

# (w1): the downlinks of the sharded step at demo-100m's full width, one NCCL rank
SHARDED_SPECS = (("marina:perm", "bfloat16"), ("marina:ind", "float32"), ("ef21p:128:1024", "float32"))
SHARDED_STEPS = 3
# kernels that must launch in the sharded steps of (w1)
SHARDED_KERNELS = ("rotk_apply_rows", "block_topk")
SHARDED_DRYRUN_DIR = ROOT / "runs" / "dryrun_chip_act"
# (w3): the CPU's count of rank 0 of the tensor-parallel train_4k step on 16x16 (`python -m
# repro_torch.launch.dryrun --arch A --shape train_4k`) of the moe, ssm and hybrid architectures, which
# (u0) counts on the card's host: per-device FLOPs, bytes and collective bytes by kind
TRAIN_COUNTS = {
    "deepseek-v2-236b": {
        "flops": 1345656203509760.0, "bytes": 78063251213430.0,
        "coll": {"all-gather": 121183150080.0, "reduce-scatter": 3815133440.0, "all-reduce": 958986575752.0}},
    "llama4-maverick-400b-a17b": {
        "flops": 2375629626408960.0, "bytes": 157080598060922.0,
        "coll": {"all-gather": 205959045120.0, "reduce-scatter": 6658387200.0, "all-reduce": 420773363592.0}},
    "rwkv6-1.6b": {
        "flops": 46695488421888.0, "bytes": 6255543924890.0,
        "coll": {"all-gather": 14486237184.0, "reduce-scatter": 50041728.0, "all-reduce": 142540412808.0}},
    "zamba2-1.2b": {
        "flops": 46823733460992.0, "bytes": 4834911128778.0,
        "coll": {"all-gather": 70843310080.0, "reduce-scatter": 4411736320.0, "all-reduce": 67404341128.0}},
}
# (w3): the CPU's count of rank 0 of MEASURED_ARCH's train_4k step on the multi-pod mesh 2x16x16 and the
# hierarchical mesh wk4x4x16 (`python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
# --multi-pod` / `--hierarchical-workers 4`): per-device FLOPs, bytes and collective bytes by kind
MESH_COUNTS = {
    "2x16x16": {"flops": 47340203278336.0, "bytes": 2543379270234.0,
                "coll": {"all-gather": 684389376.0, "reduce-scatter": 19319760.0, "all-reduce": 22876127272.0}},
    "wk4x4x16": {"flops": 94680406556672.0, "bytes": 5035227980514.0,
                 "coll": {"all-gather": 809480448.0, "reduce-scatter": 27137952.0, "all-reduce": 45752254296.0}},
}
# (w2): gloo ranks on the one card, in process groups of their own (run at once):
# (group, cases (name, arch, downlink, replica dtype, B, S, attn_chunk, mesh, mode, steps, W)),
# mode "data" (the workers over "data"), "act" (act_spec over "model") or "tp" (tensor
# parallelism over "model", the reference's worker layout). The first group's (4, 1) case runs
# demo-100m at full width, one compressed step (ONE_STEP_DRAWS), so ranks 1-3 apply rotations (r + off) mod
# W through rotk_apply_rows' vector kernel at the real leaves; its tensor-parallel cases run demo-100m at
# full width, one compressed step each, on (1, 4) and (2, 2) (rotk_apply_rows through its block map on every
# rank) and
# gemma3-1b at full width, 2 of its 26 layers, one EF21-P step on (1, 4) (its one kv head cut
# over "model": wk and wv gathered, their gradients reduce-scattered), after the rest, one at a
# time, with W = 2 workers: a rank holds the single process's state and two of its steps (the
# step and the floor) beside its own, which at W = 4 passed 19 GiB a rank at demo-100m.
GLOO_SMOKE = (("marina:ind", "gemma-2b", "marina:ind", "float32", 2, 64, 32),
              ("ef21p:16:64", "gemma-2b", "ef21p:16:64", "float32", 2, 64, 32))
TP_B, TP_S = 2, 128  # the tensor-parallel cases' rows a worker and sequence (demo-100m's width and depth)
# the moe family's tensor-parallel cases at smoke width: its train step does not fit one card at full width
# (deepseek-v2's one MoE block is 160 x 3 x 5120 x 1536 = 3.77e9 parameters, over 60 GB of training state,
# beside 4 ranks that each hold the single process too); (w3) holds its full-width count
MOE_TP = (("marina:perm/bf16", "deepseek-v2-236b", "marina:perm", "bfloat16", 2, 64, 32, (1, 4), "tp", 3, 4),
          ("ef21p:16:64", "deepseek-v2-236b", "ef21p:16:64", "float32", 2, 64, 32, (2, 2), "tp", 3, 4),
          ("marina:perm/bf16", "llama4-maverick-400b-a17b", "marina:perm", "bfloat16", 2, 64, 32, (2, 2), "tp", 3,
           4),
          ("ef21p:16:64", "llama4-maverick-400b-a17b", "ef21p:16:64", "float32", 2, 64, 32, (1, 4), "tp", 3, 4))
# the ssm and hybrid families' at full width, cut to their first layers as gemma3-1b's (rwkv6: 2 of 24 layers,
# 378,058,880 parameters; zamba2: 6 of 38, its 5 Mamba2 blocks then its shared attention block, 326,119,488
# parameters, 256 tokens: its Mamba2 chunk), one compressed perm step with bf16 replicas on (1, 4), W = 2:
# the block map on the recurrent leaves' column blocks (w_lora_b's, in_proj's)
RECURRENT_TP = (("marina:perm/bf16", "rwkv6-1.6b/2", "marina:perm", "bfloat16", 1, 128, 128, (1, 4), "tp", 1, 2),
                ("marina:perm/bf16", "zamba2-1.2b/6", "marina:perm", "bfloat16", 1, 256, 128, (1, 4), "tp", 1, 2))
# the act_spec step with experts (each worker's rows over "model" at the worker's capacity), the multi-pod
# mesh ("pod", "data", "model") with tensor parallelism over "model", and the hierarchical mesh ("wk",
# "data", "model") at (2, 2, 2) in a group of 8 processes of its own: W = 2 workers on "wk", each replica and
# its rows over "data" and "model", so the perm downlink runs rotk_apply_rows' two-level block map
ACT_MOE = (("marina:perm/bf16", "deepseek-v2-236b", "marina:perm", "bfloat16", 2, 64, 32, (2, 2), "act", 3, 4),)
# product weights that "model" does not split, read whole (train/sharded_check.VARIANTS): zamba2's smoke config
# with a Mamba2 state of 17 ("zamba2-1.2b@n17": in_proj (128, 554) and conv_w (4, 290) whole at M = 4, read in
# part by the rank's heads) in the "act+moe" group, and deepseek-v2's smoke config on (1, 8) (its router (128, 4)
# and 4 experts whole, the routed part alike on every rank) in the 8 processes of the "hier" group
WHOLE_TP = (("marina:perm/bf16", "zamba2-1.2b@n17", "marina:perm", "bfloat16", 2, 64, 32, (1, 4), "tp", 3, 4),)
WHOLE_TP8 = (("marina:perm/bf16", "deepseek-v2-236b", "marina:perm", "bfloat16", 2, 64, 32, (1, 8), "tp", 3, 2),)
MULTIPOD = (("marina:perm/bf16", "gemma-2b", "marina:perm", "bfloat16", 2, 64, 32, (2, 1, 2), "pod", 3, 4),)
HIER = (("marina:perm/bf16", "gemma-2b", "marina:perm", "bfloat16", 2, 64, 32, (2, 2, 2), "hier", 3, 2),)
GLOO_RUNS = (
    ("data+tp", (("marina:perm/bf16", "demo-100m", "marina:perm", "bfloat16", TRAIN_B, TRAIN_S, 128, (4, 1), "data",
                  1, 4),)
     + tuple(c + ((4, 1), "data", 3, 4) for c in GLOO_SMOKE)
     + (("marina:perm/bf16", "demo-100m", "marina:perm", "bfloat16", TP_B, TP_S, 128, (1, 4), "tp", 1, 2),
        ("marina:ind", "demo-100m", "marina:ind", "float32", TP_B, TP_S, 128, (2, 2), "tp", 1, 2),
        ("ef21p:128:1024", "gemma3-1b/2", "ef21p:128:1024", "float32", 1, 128, 128, (1, 4), "tp", 1, 2))
     + RECURRENT_TP),
    ("act+moe", tuple(c + ((2, 2), "act", 3, 4) for c in (
        ("marina:perm/bf16", "gemma-2b", "marina:perm", "bfloat16", 2, 64, 32),) + GLOO_SMOKE) + MOE_TP
     + ACT_MOE + MULTIPOD + WHOLE_TP),
    ("hier", HIER + WHOLE_TP8))


# (w0): rotk_apply_rows' block map (the perm downlink on a rank's blocks under tensor
# parallelism over "model"): demo-100m's leaves cut on BLOCK_MESH's model axis, and edge
# leaves (shape, split dim, M): runs of 3 and 13 values and of 33 (off the 16-byte grid,
# long enough for the vector path in every dtype), a row split, a single run
BLOCK_MESH = (1, 4)
BLOCK_EDGES = (((3, 10, 12), -1, 4), ((2, 40, 52), -1, 4), ((192, 96, 132), -1, 4), ((6, 16, 35), -2, 4),
               ((1, 2048, 300), -2, 2))
# the two-level block map (a leaf cut over "data" and "model" at once): demo-100m's leaves on the
# hierarchical mesh (wk, data, model) = HIER_BLOCK_MESH, every rank, and edge leaves (shape, cuts (dim, n,
# index)): runs of 3 and 13 values off the 16-byte grid, runs of 33 in a block long enough for the vector
# path in every dtype (vectors across the runs' ends), long runs in two groups, a cut on dims 0 and 1
HIER_BLOCK_MESH = (1, 2, 2)
TWO_LEVEL_EDGES = (((4, 6, 12), ((1, 2, 1), (2, 4, 3))), ((3, 20, 52), ((1, 2, 0), (2, 4, 1))),
                   ((384, 96, 132), ((1, 2, 1), (2, 4, 1))), ((2, 256, 5280), ((1, 2, 1), (2, 2, 1))),
                   ((6, 16, 35), ((0, 2, 1), (1, 4, 2))))


def rotk_block_phase(np, torch, dev, timed, card):
    """(w0): ``rotk_apply_rows`` with a block map (``block = (chunk, stride,
    offset)``: one model index's block of a leaf) against its plain version,
    bit for bit, in f32, fp16 and bf16: each model index's block of every
    leaf of demo-100m on BLOCK_MESH and of BLOCK_EDGES, 4 rows, rotations -3
    and 5; the result also equal to the same columns of the whole leaf's
    contiguous launch; and, on the edge leaves, one row, a broadcast row
    (stride 0) and the block at offsets 1 and 3 of wider buffers (no common
    16-byte alignment). Then its time at demo-100m's largest block (4 rows,
    n 4) beside the plain version and the contiguous launch of as many
    values. Returns (max abs error, cases, {dtype: (ms, plain ms, bound ms,
    contiguous ms)})."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm
    from repro_torch.models import params as P
    from repro_torch.train import sharded as SH
    from repro_torch.train_lm import model_100m

    t0 = time.perf_counter()
    cfg = model_100m()
    mesh = Mesh(("data", "model"), BLOCK_MESH)
    M = BLOCK_MESH[1]
    shapes = [leaf.shape for leaf in P.leaves(lm.lm_spec(cfg))]
    leaves = []  # (what, leaf shape, LeafBlock) of every model index
    for m in range(M):
        for shape, b in zip(shapes, SH.model_blocks(cfg, mesh, m)):
            if b.chunk != b.stride:
                leaves.append((f"demo-100m {shape} m={m}", shape, b._replace(lo=0)))
    for shape, dim, Me in BLOCK_EDGES:
        for m in range(Me):
            leaves.append((f"edge {shape} dim {dim} M={Me} m={m}", shape, SH.leaf_block(shape, dim, Me, m)))
    hmesh = Mesh(("wk", "data", "model"), HIER_BLOCK_MESH)
    for r in range(hmesh.size):
        for shape, b in zip(shapes, SH.fsdp_blocks(cfg, hmesh, r)[1]):
            if b.inner:
                leaves.append((f"demo-100m two-level {shape} rank {r}", shape, b._replace(lo=0)))
    for shape, cuts in TWO_LEVEL_EDGES:
        leaves.append((f"edge two-level {shape} cuts {cuts}", shape, SH.two_cut_block(shape, cuts)))
    gen = torch.Generator(dev).manual_seed(53)
    err, cases, n = 0.0, 0, 4

    def check(tag, got, want):
        nonlocal err, cases
        torch.cuda.synchronize()
        err = max(err, float_err(torch, got, want))
        if not bits_equal(torch, got, want):
            iv = torch.int16 if got.element_size() == 2 else torch.int32
            bad = (got.reshape(-1).view(iv) != want.reshape(-1).view(iv)).nonzero()[:4].tolist()
            fail(f"(w0) rotk_apply_rows block map {tag}: kernel != plain at flat {bad}")
        cases += 1

    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        for what, shape, b in leaves:
            s = b.leaf_size
            Wf = torch.randn(4, s, generator=gen, device=dev).to(dtype)
            Df = (torch.randn(s, generator=gen, device=dev) * 1e-2).to(dtype)
            w, delta = b.cut(Wf).contiguous(), b.cut(Df).contiguous()
            for r in (-3, 5):
                rot = torch.tensor([r], dtype=torch.int32, device=dev)
                tag = f"{what} {dtype} map {b.map} r={r}"
                got = ops.rotk_apply_rows(w, delta, rot, n=n, block=b.map)
                check(tag, got, ref.rotk_apply_rows_ref(w, delta, rot, n=n, block=b.map))
                check(tag + " vs the whole leaf", got, b.cut(ops.rotk_apply_rows(Wf, Df, rot, n=n)))
                if not what.startswith("edge"):
                    continue
                check(tag + " one row", ops.rotk_apply_rows(w[:1], delta, rot, n=n, block=b.map),
                      ref.rotk_apply_rows_ref(w[:1], delta, rot, n=n, block=b.map))
                wb = w[0].expand(4, -1)  # one row broadcast, as the downlink's messages pass it
                check(tag + " broadcast row", ops.rotk_apply_rows(wb, delta, rot, n=n, block=b.map),
                      ref.rotk_apply_rows_ref(wb, delta, rot, n=n, block=b.map))
                for c in (1, 3):  # the block off the 16-byte grid, delta at another offset
                    Wc = torch.full((4, b.size + 4), 7.0, dtype=dtype, device=dev)
                    Wc[:, c:c + b.size] = w
                    out = torch.full_like(Wc, 5.0)
                    got_c = ops.rotk_apply_rows(Wc[:, c:c + b.size], delta, rot, n=n, block=b.map,
                                                out=out[:, c:c + b.size])
                    check(f"{tag} at offset {c}", got_c, ref.rotk_apply_rows_ref(w, delta, rot, n=n, block=b.map))
                    if not (bool((out[:, :c] == 5).all()) and bool((out[:, c + b.size:] == 5).all())):
                        fail(f"(w0) rotk_apply_rows block map {tag} at offset {c}: wrote outside out")
            del Wf, Df, w, delta
    # the times at demo-100m's largest block of many runs, one-level (the unembedding's columns of a (1, 4)
    # rank) and two-level (the embedding's block of a (1, 2, 2) rank, as many values): 4 rows, n 4
    rot = torch.tensor([5], dtype=torch.int32, device=dev)
    times, timed_blocks = {}, {}
    for level in ("one", "two"):
        what, shape, b = max((x for x in leaves if x[0].startswith("demo") and (x[2].inner > 0) == (level == "two")),
                             key=lambda x: (x[2].size > x[2].chunk, x[2].size))
        timed_blocks[level] = (shape, b)
        for dtype in (torch.float32, torch.bfloat16):
            w = torch.randn(4, b.size, generator=gen, device=dev).to(dtype)
            delta = (torch.randn(b.size, generator=gen, device=dev) * 1e-2).to(dtype)
            out = torch.empty_like(w)
            bound = ((2 * 4 + 1) * b.size * w.element_size() + 4) / HBM_BYTES_PER_S * 1e3
            times[(level, str(dtype).split(".")[-1])] = (
                timed(lambda: ops.rotk_apply_rows(w, delta, rot, n=n, out=out, block=b.map)),
                timed(lambda: ref.rotk_apply_rows_ref(w, delta, rot, n=n, block=b.map), reps=5), bound,
                timed(lambda: ops.rotk_apply_rows(w, delta, rot, n=n, out=out)))
            del w, delta, out
    n_two = sum(1 for x in leaves if x[2].inner)
    log(f"(w0) rotk_apply_rows block map: {cases} cases bit-equal to the plain version and to the whole leaf's "
        f"launch (f32, fp16, bf16; demo-100m's {sum(1 for x in leaves if x[0].startswith('demo'))} blocks on "
        f"mesh {BLOCK_MESH} and on (wk, data, model) = {HIER_BLOCK_MESH}, {len(BLOCK_EDGES) + len(TWO_LEVEL_EDGES)} "
        f"edge leaves; {n_two} blocks with a two-level map), max |err| {err:.3e}; {time.perf_counter() - t0:.1f} s")
    for (level, dt), (ms_, plain_, bound_, contig_) in times.items():
        shape, b = timed_blocks[level]
        log(f"(w0) rotk_apply_rows {level}-level block map {dt} at demo-100m {shape} block {b.map} ({b.size:,} "
            f"values, 4 rows, n 4): {ms_:.5f} ms, plain {plain_:.5f}, bound {bound_:.5f} by bytes (share "
            f"{bound_ / ms_:.3f}), contiguous launch {contig_:.5f} ({card})")
    return err, cases, times, {k: (list(shape), list(b.map), b.size) for k, (shape, b) in timed_blocks.items()}


def _states_equal(torch, a, b) -> list:
    """Keys of two train states (or metrics) that differ in a bit, with the
    largest |difference| of each."""
    out = []
    for k in sorted(set(a) | set(b)):
        x, y = a.get(k), b.get(k)
        if isinstance(x, dict):
            out += [f"{k}/{e}" for e in _states_equal(torch, x, y or {})]
        elif isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            x, y = torch.as_tensor(x), torch.as_tensor(y)
            if x.dtype != y.dtype or x.shape != y.shape:
                out.append(f"{k} {x.dtype}{tuple(x.shape)} vs {y.dtype}{tuple(y.shape)}")
            elif not torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)):
                out.append(f"{k} (max |diff| {float((x.float() - y.float()).abs().max()):.3e})")
        elif x != y:
            out.append(f"{k} ({x!r} vs {y!r})")
    return out


def sharded_phase(np, torch, dev, card):
    """(w1): ``train/sharded.make_sharded_train_step`` as one NCCL rank (mesh
    (1, 1)) at demo-100m's full width (TRAIN_W workers x TRAIN_B x TRAIN_S),
    AdamW (wd 0.01), SHARDED_STEPS steps under each of SHARDED_SPECS, beside
    ``make_train_step`` from the same state, batches and draws: the gathered
    state and the metrics bit for bit after every step; the bytes the
    communicator handed to NCCL in each step equal to the dry-run's count of
    the same step on ``meta`` (``CountingComm``); ms a step of both paths
    (host clock after a sync, the two in turns). Returns the sharded steps'
    launches."""
    import socket

    import torch.distributed as dist

    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import runtime
    from repro_torch.launch import op_cost
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import compressed_draws
    from repro_torch.models import lm
    from repro_torch.models import params as P
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.train import TrainerConfig, init_state, make_downlink, make_train_step
    from repro_torch.train import downlink as D
    from repro_torch.train import sharded as SH
    from repro_torch.train_lm import model_100m

    cfg = model_100m()
    sizes = P.leaf_sizes(lm.lm_spec(cfg))
    d = sum(sizes)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(torch.cuda.current_device())  # before the DeviceMesh, which otherwise guesses
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    launches = {}
    try:
        if dist.get_backend() != "nccl":
            fail(f"(w1) the card's process group runs {dist.get_backend()}, not nccl")
        layout, comm = SH.connect(Mesh(("data", "model"), (1, 1)), TRAIN_W, d)
        aux = SH.Comm()  # the checks' gathers, apart from the step's tally
        for spec, dtype in SHARDED_SPECS:
            name = spec + ("/bf16" if dtype == "bfloat16" else "")
            tcfg = TrainerConfig(n_workers=TRAIN_W, attn_chunk=128, weight_dtype=getattr(torch, dtype))
            dl = make_downlink(spec, TRAIN_W)
            opt = make_optimizer("adamw", weight_decay=0.01)
            lr = cosine_warmup(3e-4, warmup=min(50, SHARDED_STEPS // 4), total=SHARDED_STEPS)
            single = make_train_step(cfg, tcfg, dl, opt, lr)
            step = SH.make_sharded_train_step(cfg, tcfg, dl, opt, lr, layout, comm)
            counter = SH.CountingComm()
            metastep = SH.make_sharded_train_step(cfg, tcfg, dl, opt, lr, layout, counter)
            meta_state = SH.init_state(cfg, tcfg, dl, opt, layout, device="meta")
            torch.cuda.empty_cache()
            state = init_state(cfg, tcfg, dl, opt, seed=0, device=dev)
            sp = SH.shard_state(state, layout)
            data = SyntheticLMData(cfg, TRAIN_W, TRAIN_B, TRAIN_S, device=str(dev))
            gen, dgen = torch.Generator().manual_seed(7), torch.Generator(dev).manual_seed(7)
            t_single, t_sharded, counted_by_coin, syncs, mine = [], [], {}, 0, {}
            for i in range(SHARDED_STEPS):
                batch, draws = data.batch(i), D.draw_round(dl, sizes, gen, dgen)
                syncs += draws.coin
                before = dict(comm.bytes)
                for path in ((single, step) if i % 2 == 0 else (step, single)):
                    torch.cuda.synchronize()
                    before_l = runtime.LAUNCHES.copy()
                    t0 = time.perf_counter()
                    if path is single:
                        new, m1 = single(state, batch, draws)
                    else:
                        sp, m2 = step(sp, batch, draws)
                        for k, v in runtime.LAUNCHES.items():  # the sharded step's own launches
                            if v - before_l.get(k, 0):
                                mine[k] = mine.get(k, 0) + v - before_l.get(k, 0)
                    torch.cuda.synchronize()
                    (t_single if path is single else t_sharded).append(time.perf_counter() - t0)
                moved = {k: v - before.get(k, 0) for k, v in comm.bytes.items()}
                if draws.coin not in counted_by_coin:  # the dry-run's count of this branch
                    mdraws = D.DownlinkDraws(coin=True) if draws.coin else compressed_draws(dl, sizes)
                    mbatch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in batch.items()}
                    with op_cost.counting() as c:
                        metastep(meta_state, mbatch, mdraws)
                    counted_by_coin[draws.coin] = {k: float(v) for k, v in c.coll.items()}
                if {k: float(v) for k, v in moved.items()} != counted_by_coin[draws.coin]:
                    fail(f"(w1) {name} step {i}: bytes handed to NCCL {moved} != counted "
                         f"{counted_by_coin[draws.coin]}")
                full = SH.gather_state(sp, layout, aux)
                bad = _states_equal(torch, full, new) + [f"metrics: {e}" for e in _states_equal(torch, m2, m1)]
                if bad:
                    again, _ = single(state, batch, draws)
                    fail(f"(w1) {name} step {i}: the sharded step differs from make_train_step in {bad[:6]} "
                         f"(make_train_step run twice from the same state differs in "
                         f"{_states_equal(torch, again, new)[:6]})")
                state = new
                del full
            if not np.isfinite(float(m1["loss"])):
                fail(f"(w1) {name}: loss {float(m1['loss'])}")
            # one launch a leaf: rotk_apply_rows in each compressed perm round, block_topk each EF21-P step
            want = ({"rotk_apply_rows": len(sizes) * (SHARDED_STEPS - syncs)} if spec == "marina:perm"
                    else {"block_topk": len(sizes) * SHARDED_STEPS} if spec.startswith("ef21p") else {})
            if {k: mine.get(k, 0) for k in ("rotk_apply_rows", "block_topk", "rotk_apply")} != {
                    "rotk_apply_rows": 0, "block_topk": 0, "rotk_apply": 0, **want}:
                fail(f"(w1) {name}: the sharded steps launched {mine}, expected {want}")
            for k, v in mine.items():
                launches[k] = launches.get(k, 0) + v
            ms_sh, ms_si = (float(np.median(t[2:])) * 1e3 for t in (t_sharded, t_single))
            log(f"(w1) {name:18s} demo-100m d={d:,}, {SHARDED_STEPS} steps ({syncs} syncs) on one NCCL rank: "
                f"state and metrics bit-equal to make_train_step every step; {ms_sh:.2f} ms a step sharded, "
                f"{ms_si:.2f} ms single-process (medians of steps 2-{SHARDED_STEPS - 1}, in turns); "
                f"collective bytes a step handed to NCCL = counted: "
                + ", ".join(f"{'sync' if c else 'compressed'} {b}" for c, b in sorted(counted_by_coin.items()))
                + f"; loss {float(m1['loss']):.4f} ({card})")
            del state, sp, new, m1, m2, data, step, single
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


# (w2)'s rank: 3 teacher-forced steps a case (train/sharded_check.run_case) on
# the one card over gloo, held to train/sharded_check's bounds
GLOO_RANK = """
import datetime, json, os, re, sys, time
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = int(os.environ.get("GLOO_WORLD", "4"))
# mesh axes by mode: "data", "act" and "tp" on ("data", "model"), "pod" the multi-pod mesh, "hier" the hierarchical
AXES = {"pod": ("pod", "data", "model"), "hier": ("wk", "data", "model")}
# gloo's own refusal of a device: ProcessGroupGloo's "unsupported device type",
# or no gloo backend registered for cuda
REFUSAL = re.compile(r"unsupported device type|No backend type associated with device type")


def probe(dev):
    # the step's three collectives on CUDA tensors: gloo's refusal, or None
    try:
        dist.reduce_scatter_tensor(torch.empty(2, device=dev), torch.ones(2 * WORLD, device=dev))
        dist.all_gather_into_tensor(torch.empty(2 * WORLD, device=dev), torch.ones(2, device=dev))
        dist.all_reduce(torch.ones(1, device=dev))
    except (RuntimeError, ValueError) as e:
        if REFUSAL.search(str(e)):
            return f"{type(e).__name__}: {e}"[:600]
        raise
    return None


def config(arch):
    import dataclasses
    from repro_torch import configs
    from repro_torch.train import sharded_check as SC
    from repro_torch.train_lm import model_100m

    if arch == "demo-100m":
        return model_100m()
    if arch == "gemma3-1b/2":  # full width, 2 of its 26 layers
        return dataclasses.replace(configs.get("gemma3-1b"), num_layers=2, block_pattern=("attn_local", "attn"))
    name, _, depth = arch.partition("/")
    if depth:  # full width, its first layers
        cfg = configs.get(name)
        return dataclasses.replace(cfg, num_layers=int(depth), block_pattern=cfg.block_pattern[:int(depth)])
    return SC.variant(arch)  # a smoke config, or "arch@variant" (sharded_check.VARIANTS)


# the draws of a one-step case: seed 11's first two rounds are syncs at W = 2 and 4, seed 14's first round is
# compressed, so a one-step perm case runs the downlink's rotations
ONE_STEP_DRAWS = 14


def progress(out_dir, rank, what):
    # one line a case boundary, read by the parent when the group outlives its time
    with open(os.path.join(out_dir, f"rank{rank}.progress"), "a") as f:
        f.write(f"{time.time():.1f} {what}\\n")


def rank_main(rank, init, cases, out_dir):
    sys.path.insert(0, os.environ["PORT_SRC"])
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm, params as P
    from repro_torch.train import TrainerConfig
    from repro_torch.train import sharded as SH, sharded_check as SC

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    res = {"rank": rank}
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD,
                                timeout=datetime.timedelta(seconds=240))
        res["refusal"] = probe(dev)
        if res["refusal"] is None:
            res["cases"] = {}
            for name, arch, spec, dtype, rows, seq, chunk, shape, mode, steps, W in cases:
                progress(out_dir, rank, f"start {name} {arch} {tuple(shape)}")
                cfg = config(arch)
                torch.cuda.reset_peak_memory_stats()
                layout, comm = SH.connect(Mesh(AXES.get(mode, ("data", "model")), tuple(shape)), W,
                                          sum(P.leaf_sizes(lm.lm_spec(cfg))),
                                          cfg=None if mode in ("data", "act") else cfg)
                tcfg = TrainerConfig(n_workers=W, attn_chunk=chunk, weight_dtype=getattr(torch, dtype),
                                     act_spec=SH.ACT_SPEC if mode == "act" else None)
                # a one-step case at gemma3-1b's width: rank 0 alone holds the single process's state (a
                # state broadcast between steps through gloo costs more on the card than each rank's step)
                r = SC.run_case(cfg, tcfg, spec, layout, comm, SH.Comm(), batch_rows=rows, seq=seq,
                                device=dev, steps=steps, check_rank=0 if steps == 1 else None,
                                draw_seed=ONE_STEP_DRAWS if steps == 1 else 11)
                SC.hold(name, r, SC.bounds(mode != "data"), W)
                res["cases"][f"{name} {arch} {tuple(shape)}"] = dict(
                    r, d=layout.d, d_local=layout.d_local, d_rank=layout.d_rank, off=layout.off, mode=mode,
                    leaves=len(layout.blocks or ()), blocks=layout.d_rank < layout.d,
                    two_level=sum(bool(b.inner) for b in layout.rank_blocks or ()),
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30)
                del comm, layout
                torch.cuda.empty_cache()
                progress(out_dir, rank, "done")
            res["peak_gib"] = max(c["peak_gib"] for c in res["cases"].values())
        dist.destroy_process_group()
    except Exception as e:  # every error fails (w2): the parent reports it
        import traceback
        res["error"] = f"{type(e).__name__}: {e}"[:600]
        res["trace"] = traceback.format_exc()[-3000:]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    init, cases, out_dir = sys.argv[1:4]
    mp.spawn(rank_main, args=(init, json.loads(cases), out_dir), nprocs=WORLD, join=True)
"""


def gloo_card_start(groups, nice=0):
    """(w2)'s process groups of GLOO_RUNS named in ``groups``, started, each
    at CPU priority ``nice``: {group: (its cases, its directory, its
    process, its start on the wall clock and on the script's clock)}."""
    import os
    import tempfile

    runs = {}
    # 8 processes share the card: the allocator's expandable segments keep each one's reserve near its use
    env = dict(os.environ, PORT_SRC=str(SRC), PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    for group, cases in GLOO_RUNS:
        if group not in groups:
            continue
        tmp = tempfile.mkdtemp(prefix="gloo_card_")
        script = os.path.join(tmp, "ranks.py")
        with open(script, "w") as f:
            f.write(GLOO_RANK)
        world = math.prod(cases[0][7])  # a group's cases share its size
        wall, t0 = time.time(), time.perf_counter()
        with open(os.path.join(tmp, "out.log"), "w") as out:  # a file: readable after a kill
            runs[group] = (cases, tmp, spawn(
                [sys.executable, script, f"file://{tmp}/rdv", json.dumps(cases), tmp],
                env=dict(env, GLOO_WORLD=str(world)), stdout=out, stderr=subprocess.STDOUT,
                preexec_fn=(lambda: os.nice(nice)) if nice else None), wall, t0)
    return runs


# the last second of the script's clock at which (w2) still waits for a group: a group past it is reported
# (its ranks' last case boundaries and output) before the script's 1200 s limit
W2_DEADLINE = 1100


def _group_deadline(t_start: float) -> float:
    """The clock time until which (w2) waits for a group started at
    ``t_start``: 900 s after its start, at most W2_DEADLINE s of the script."""
    return min(t_start + 900, T_START + W2_DEADLINE)


def gloo_card_wait(started):
    """Waits until the processes of :func:`gloo_card_start`'s groups end,
    each at most until its deadline (:func:`_group_deadline`;
    :func:`gloo_card_phase` reports a group still running then). Returns the
    seconds waited."""
    t0 = time.perf_counter()
    for *_, proc, _, t_start in started.values():
        try:
            proc.wait(timeout=max(1.0, _group_deadline(t_start) - time.perf_counter()))
        except subprocess.TimeoutExpired:
            break
    return time.perf_counter() - t0


def gloo_card_phase(started, card):
    """(w2): the process groups of GLOO_RUNS on the one card, started by
    :func:`gloo_card_start` (the smoke-width groups beside the phases from
    (t) on, at the lowest CPU priority; the full-width group at (w)), each
    case on its own mesh:
    ``steps`` teacher-forced steps against the single-process step on the
    card, within ``train/sharded_check``'s bounds (the CPU tests' own; under
    tensor parallelism the loss within FLOOR_FACTOR x the run's own floor),
    the bytes handed to gloo equal to the dry-run's count each step, every
    rank holding rows at an offset, or blocks, launching rotk_apply_rows in
    a perm case, and each case's peak memory a rank. A refusal counts only
    where gloo itself refuses the step's collectives on CUDA tensors (each
    rank probes them first): it is logged, and nothing runs in its place.
    Any other error, in any group, fails the phase. Returns (the refusal
    or None, the seconds from the last group's start, {case: the ranks'
    rotk_apply_rows launches} of the tensor-parallel perm cases, {case: the
    ranks' block_topk launches} of the tensor-parallel EF21-P cases)."""
    import os

    from repro_torch.train.sharded_check import WORST_KEYS

    if set(started) != {group for group, _ in GLOO_RUNS}:
        fail(f"(w2) started the groups {sorted(started)}, not all of GLOO_RUNS")
    t0 = max(t for *_, t in started.values())
    runs = {group: run[:3] for group, run in started.items()}
    late = []
    try:
        for group, (_, tmp, proc) in runs.items():
            try:
                proc.wait(timeout=max(1.0, _group_deadline(started[group][4]) - time.perf_counter()))
            except subprocess.TimeoutExpired:
                late.append(group)
    finally:
        for *_, proc in runs.values():
            if proc.poll() is None:
                kill_tree(proc)
    outs = {}
    for group, (_, tmp, _) in runs.items():
        with open(os.path.join(tmp, "out.log")) as f:
            outs[group] = (None, f.read())
    if late:
        where = []
        for group in late:
            cases, tmp = runs[group][:2]
            for r in range(math.prod(cases[0][7])):
                path = os.path.join(tmp, f"rank{r}.progress")
                last = open(path).read().splitlines()[-2:] if os.path.exists(path) else ["no progress"]
                where.append(f"group {group} rank {r}: {last}")
        fail(f"(w2) group(s) {late} still running at their deadline (900 s, at most {W2_DEADLINE} s of the "
             f"script; now {time.time():.1f}); the ranks' last case "
             f"boundaries: {where}\n" + "\n".join(outs[g][1][-3000:] for g in late))
    problems, refusals, results = [], [], {}
    worlds = 0
    for group, (cases, tmp, proc) in runs.items():
        ranks, world = [], math.prod(cases[0][7])
        worlds += world
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    ranks.append(json.load(f))
        if proc.returncode != 0 or len(ranks) != world:
            problems.append(f"group {group}: the {world} gloo processes exited {proc.returncode} with "
                            f"{len(ranks)} reports:\n{outs[group][1][-3000:]}")
        for r in ranks:
            if "error" in r:
                problems.append(f"group {group} rank {r['rank']}: {r['error']}\n{r['trace'][-1500:]}")
            elif r["refusal"] is not None:
                refusals.append(f"group {group} rank {r['rank']}: {r['refusal']}")
        results[group] = ranks
    if problems:
        fail("(w2) " + "\n".join(problems))
    for group, (cases, tmp, _) in runs.items():  # rank 0's case boundaries: where a group's time goes
        path = os.path.join(tmp, "rank0.progress")
        if os.path.exists(path):
            wall = started[group][3]
            marks = [ln.split(" ", 1) for ln in open(path).read().splitlines()]
            spans = [f"{what[len('start '):]} {float(marks[i + 1][0]) - float(at):.1f} s"
                     for i, (at, what) in enumerate(marks[:-1]) if what.startswith("start ")]
            ended = max(os.path.getmtime(os.path.join(tmp, f"rank{r}.json"))
                        for r in range(math.prod(cases[0][7])))
            log(f"(w2) group {group}: started at {started[group][4] - T_START:.1f} s of the script, ended "
                f"{ended - wall:.1f} s later; rank 0's first case began {float(marks[0][0]) - wall:.1f} s "
                f"after the start; cases: {'; '.join(spans)}")
    if refusals:
        if len(refusals) != worlds:
            fail(f"(w2) gloo refused CUDA tensors on some ranks only: {refusals}")
        log(f"(w2) gloo refused the step's collectives on CUDA tensors ({refusals[0]}); the 4-rank step on the "
            "card did not run (no CPU run stands in for it)")
        return refusals[0], time.perf_counter() - t0, {}, {}
    tp_launches, tp_topk = {}, {}
    for group, cases in GLOO_RUNS:
        ranks = results[group]
        for name, arch, spec, dtype, rows, seq, chunk, shape, mode, steps, W in cases:
            key = f"{name} {arch} {tuple(shape)}"
            for r in ranks:
                c = r["cases"][key]
                moved_rows = c["off"] > 0 or c["blocks"]  # rows at an offset, or a rank's blocks
                if (spec == "marina:perm" and moved_rows and c["compressed"]
                        and c["launches"].get("rotk_apply_rows", 0) <= 0):
                    fail(f"(w2) {key} rank {r['rank']} (rows from worker {c['off']}, mode {mode}): "
                         f"rotk_apply_rows never launched in {c['compressed']} compressed rounds")
                if c["blocks"] and spec == "marina:perm" and not c["compressed"]:
                    fail(f"(w2) {key} rank {r['rank']}: no compressed round, so the block map did not run")
                if mode == "hier" and spec == "marina:perm" and not (
                        c["two_level"] and c["launches"].get("rotk_apply_rows", 0) >= c["compressed"] * c["leaves"]):
                    fail(f"(w2) {key} rank {r['rank']}: {c['two_level']} leaves with a two-level block, "
                         f"{c['launches'].get('rotk_apply_rows', 0)} rotk_apply_rows launches in {c['compressed']} "
                         f"compressed rounds of {c['leaves']} leaves")
                if spec.startswith("ef21p") and c["launches"].get("block_topk", 0) <= 0:
                    fail(f"(w2) {key} rank {r['rank']}: block_topk never launched in its EF21-P steps")
            if ranks[0]["cases"][key]["blocks"] and spec == "marina:perm":
                tp_launches[key] = [r["cases"][key]["launches"].get("rotk_apply_rows", 0) for r in ranks]
            if mode == "tp" and spec.startswith("ef21p"):
                tp_topk[key] = [r["cases"][key]["launches"].get("block_topk", 0) for r in ranks]
            worst = [max(r["cases"][key]["worst"][j] for r in ranks) for j in range(6)]
            c0 = ranks[0]["cases"][key]
            floor = ("; the single process's own floor " + ", ".join(
                f"{k} {max(r['cases'][key]['floor'][j] for r in ranks):.3g}" for j, k in enumerate(WORST_KEYS))
                if c0["floor"] is not None else "")
            bounds = "data-axis" if mode == "data" else "act_spec" if mode == "act" else "act_spec (or 1.5x the floor)"
            log(f"(w2) {len(ranks)} gloo ranks on the one card, mesh {tuple(shape)} {mode}, {name} {arch} "
                f"d={c0['d']:,} (d_local {c0['d_local']:,}, a replica row {c0['d_rank']:,}, "
                f"{c0['two_level']} two-level leaves), W = {W}, {steps} step(s) of {rows} x {seq} a worker: within the "
                f"{bounds} bounds of the single-process step: "
                + ", ".join(f"{k} {v:.3g}" for k, v in zip(WORST_KEYS, worst)) + floor
                + f"; {c0['compressed']} compressed round(s); bytes a rank a step {c0['moved']} = counted; "
                f"launches by rank {[r['cases'][key]['launches'] for r in ranks]}; peak GiB a rank "
                f"{[round(r['cases'][key]['peak_gib'], 2) for r in ranks]} ({card})")
    return None, time.perf_counter() - t0, tp_launches, tp_topk


def sharded_dryrun_start():
    """(w3)'s counts, started in a process of their own: ``python -m
    repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k`` (the
    default record: tensor parallelism over "model"), then the same with
    ``--train-act-model-sharded``, ``--multi-pod`` and
    ``--hierarchical-workers 4``, into SHARDED_DRYRUN_DIR."""
    import os

    if SHARDED_DRYRUN_DIR.exists():
        for f in SHARDED_DRYRUN_DIR.glob("*.json"):
            f.unlink()
    SHARDED_DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    count = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", MEASURED_ARCH, "--shape", "train_4k",
             "--out", str(SHARDED_DRYRUN_DIR)]
    return spawn(["bash", "-c", 'set -e; "$@"; "$@" --train-act-model-sharded; "$@" --multi-pod; '
                  '"$@" --hierarchical-workers 4', "counts"] + count, env=env,
                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def sharded_dryrun_phase(proc, card, u0_recs):
    """(w3): the counts started by :func:`sharded_dryrun_start`: valid
    per_rank records with a collective term, the default one tensor
    parallel, those of the multi-pod and hierarchical meshes equal to the
    CPU's count (MESH_COUNTS); and (u0)'s train_4k records of TRAIN_COUNTS'
    architectures
    (``u0_recs``, counted on the card's host): per_rank, tensor parallel,
    their counts equal to the CPU's exactly. Returns the records."""
    from repro_torch.launch import dryrun

    try:
        outp = proc.communicate(timeout=600)[0]
    finally:
        if proc.poll() is None:
            kill_tree(proc)
    if proc.returncode != 0:
        fail(f"(w3) the train_4k dry-runs exited {proc.returncode}:\n{outp[-3000:]}")
    recs = {}
    for mesh, tag, what in (("16x16", "", "tensor parallelism over 'model' (the default)"),
                            ("16x16", "__act", "act_spec"),
                            ("2x16x16", "", "the multi-pod mesh, tensor parallelism over 'model'"),
                            ("wk4x4x16", "", "the hierarchical mesh, replicas over 'data' and 'model'")):
        rec = json.loads((SHARDED_DRYRUN_DIR / f"{MEASURED_ARCH}__train_4k__{mesh}{tag}.json").read_text())
        problems = dryrun.record_problems(rec)
        t = rec["roofline"]
        if problems or rec["split"] != "per_rank" or t["collective_s"] is None or rec["tensor_parallel"] != (not tag):
            fail(f"(w3) {MEASURED_ARCH} train_4k {what} record: {problems}, split {rec['split']}, "
                 f"tensor_parallel {rec.get('tensor_parallel')}, {t}")
        if mesh in MESH_COUNTS:
            got = {"flops": rec["flops_per_device"], "bytes": rec["bytes_per_device"],
                   "coll": rec["collective_bytes_per_device"]}
            if got != MESH_COUNTS[mesh]:
                fail(f"(w3) {MEASURED_ARCH} train_4k on {mesh}: the card host's count {got} != the CPU's "
                     f"{MESH_COUNTS[mesh]}")
        exact = " (the CPU's count exactly)" if mesh in MESH_COUNTS else ""
        log(f"(w3) {MEASURED_ARCH} train_4k on {mesh} with {what}{exact}, one rank counted on meta "
            f"({rec['t_count_s']} s): {rec['flops_per_device']:.4e} FLOPs, {rec['bytes_per_device']:.4e} bytes, "
            f"collective bytes {rec['collective_bytes_per_device']} ({rec['collective_total_per_device']:.4e}); "
            f"compute {t['compute_s']:.4e} s, memory {t['memory_s']:.4e} s, collective {t['collective_s']:.4e} s "
            f"(NVLink 450e9 B/s): {t['dominant']}; state bytes a device {rec['state_bytes_per_device']} "
            f"(H100 constants; no card used)")
        recs[mesh + (tag or "")] = rec
    for arch, want in TRAIN_COUNTS.items():
        rec = u0_recs[arch, "train_4k"]
        got = {"flops": rec["flops_per_device"], "bytes": rec["bytes_per_device"],
               "coll": rec["collective_bytes_per_device"]}
        t = rec["roofline"]
        if rec["split"] != "per_rank" or not rec["tensor_parallel"] or t["collective_s"] is None:
            fail(f"(w3) {arch} train_4k: split {rec['split']}, tensor_parallel {rec.get('tensor_parallel')}, {t}")
        if got != want:
            fail(f"(w3) {arch} train_4k: the card host's count {got} != the CPU's {want}")
        log(f"(w3) {arch} train_4k on 16x16, tensor parallelism over 'model', rank 0 counted on meta by (u0) "
            f"({rec['t_count_s']} s): the CPU's count exactly: {got['flops']:.6e} FLOPs, {got['bytes']:.6e} bytes, "
            f"collective {got['coll']}; compute {t['compute_s']:.5g} s, memory {t['memory_s']:.5g} s, collective "
            f"{t['collective_s']:.5g} s: {t['dominant']}, bound {t['bound_s']:.6g} s; state bytes a device "
            f"{rec['state_bytes_per_device']} (H100 constants; no card used)")
    return recs


# (x): the serving step across a process group, gemma3-1b at full width
SERVE_ARCH = "gemma3-1b"
SERVE_B, SERVE_S, SERVE_STEPS = 4, 512, 2
# the decode runs at positions SERVE_S ...: the 512-slot rings wrap; 516 slots split over (x2)'s 4 data ranks
# at B = 1 (a length they do not divide makes cache_specs split the head dim)
SERVE_CACHE = SERVE_S + 4
SERVE_DRYRUN_DIR = ROOT / "runs" / "dryrun_chip_serve"
# (x1) and (x2) for the moe family: deepseek-v2-236b at full width cut to its first 2 blocks (layer
# 0: MLA and the dense 12,288 FFN; layer 1: MLA, 160 experts top-6 and 2 shared experts)
MOE_ARCH = "deepseek-v2-236b/2"
MOE_PARAMS = 5_519_108_096
MOE_B, MOE_S, MOE_STEPS = 4, 512, 2
MOE_CACHE = MOE_S + MOE_STEPS
# (x1) and (x2) for the ssm and hybrid families: rwkv6-1.6b and zamba2-1.2b at full width, (x1) at full depth
# (the prompt of SERVE_S is a multiple of rwkv's chunk of 32 and of zamba2's Mamba2 chunk of 256), (x2) cut
# to their first 6 layers (rwkv6: a scan segment of 6; zamba2: 5 Mamba2 blocks, then its shared attention)
RECURRENT_ARCHS = {"rwkv6-1.6b": 1_583_894_016, "zamba2-1.2b": 1_016_954_880}
RECURRENT_DEPTH = 6
# (x2)'s cases: (mesh, serve layout, batch, arch); gemma3-1b at full width (prompt SERVE_S, SERVE_STEPS
# decode steps), then the moe cut (prompt MOE_S, MOE_STEPS decode steps; every rank builds its
# blocks from the seed and reads the single process's outputs from (x1)'s files). gemma3-1b's (2, 2)
# full-depth case has B = 2; at B = 4 the reference's cache_specs takes the 4 repetitions of gemma3-1b's
# scan segment for the batch and splits them over "data" (serve/sharded.cache_split's "other"): its first 4
# layers (a scan segment of 4 local layers, "gemma3-1b/4") run that at B = 4. The recurrent archs also run
# long_500k's split at B = 1 on (4, 1) and (2, 2): their states, token shifts and conv windows over "data"
# (zamba2's shared-attention ring on its slots), gathered before each decode step reads them
GLOO_SERVE = (("2x2", "serve", 2, SERVE_ARCH), ("1x4", "tp", SERVE_B, SERVE_ARCH), ("4x1", "serve", 1, SERVE_ARCH),
              ("1x4", "tp", MOE_B, MOE_ARCH), ("2x2", "serve", 2, MOE_ARCH)) + tuple(
    (shape, name, batch, f"{arch}/{RECURRENT_DEPTH}") for arch in RECURRENT_ARCHS
    for shape, name, batch in (("1x4", "tp", SERVE_B), ("2x2", "serve", 2), ("4x1", "serve", 1),
                               ("2x2", "serve", 1))) + (("2x2", "serve", SERVE_B, f"{SERVE_ARCH}/4"),)
# (x3): the CPU's per-rank counts of gemma3-1b's serving shapes and deepseek-v2-236b's decode_32k on
# 16x16 (python -m repro_torch.launch.dryrun --arch A --shape S --serve-layout L;
# tests/test_torch_collective_count.py), by "layout/arch/shape"
SERVE_COUNTS = {
    "serve/gemma3-1b/prefill_32k": {
        "flops": 55074902507520.0, "bytes": 3264500820492.0,
        "coll": {"all-gather": 254974464.0, "reduce-scatter": 0.0, "all-reduce": 15854469120.0}},
    "serve/gemma3-1b/decode_32k": {
        "flops": 6353911808.0, "bytes": 11361931772.0,
        "coll": {"all-gather": 254974464.0, "reduce-scatter": 0.0, "all-reduce": 1935360.0}},
    "serve/gemma3-1b/long_500k": {
        "flops": 750985216.0, "bytes": 2284774453.0,
        "coll": {"all-gather": 254974464.0, "reduce-scatter": 0.0, "all-reduce": 349248.0}},
    "tp/gemma3-1b/prefill_32k": {
        "flops": 55074902507520.0, "bytes": 3264277249548.0,
        "coll": {"all-gather": 92012544.0, "reduce-scatter": 0.0, "all-reduce": 15854469120.0}},
    "tp/gemma3-1b/decode_32k": {
        "flops": 6353911808.0, "bytes": 11138360828.0,
        "coll": {"all-gather": 92012544.0, "reduce-scatter": 0.0, "all-reduce": 1935360.0}},
    "tp/gemma3-1b/long_500k": {
        "flops": 750985216.0, "bytes": 2061203509.0,
        "coll": {"all-gather": 92012544.0, "reduce-scatter": 0.0, "all-reduce": 349248.0}},
    "serve/deepseek-v2-236b/decode_32k": {
        "flops": 461533347840.0, "bytes": 342772284544.0,
        "coll": {"all-gather": 30522972160.0, "reduce-scatter": 0.0, "all-reduce": 48742400.0}},
    "tp/deepseek-v2-236b/decode_32k": {
        "flops": 461533347840.0, "bytes": 281873529984.0,
        "coll": {"all-gather": 451164160.0, "reduce-scatter": 0.0, "all-reduce": 48742400.0}},
    "serve/rwkv6-1.6b/decode_32k": {
        "flops": 1452326912.0, "bytes": 528156132.0,
        "coll": {"all-gather": 200636416.0, "reduce-scatter": 0.0, "all-reduce": 3178496.0}},
    "tp/rwkv6-1.6b/decode_32k": {
        "flops": 1452326912.0, "bytes": 370718180.0,
        "coll": {"all-gather": 835584.0, "reduce-scatter": 0.0, "all-reduce": 3178496.0}},
    "serve/zamba2-1.2b/decode_32k": {
        "flops": 2100559872.0, "bytes": 11172262652.0,
        "coll": {"all-gather": 175509504.0, "reduce-scatter": 0.0, "all-reduce": 2917376.0}},
    "tp/zamba2-1.2b/decode_32k": {
        "flops": 2100559872.0, "bytes": 11050128124.0,
        "coll": {"all-gather": 5373952.0, "reduce-scatter": 0.0, "all-reduce": 2917376.0}},
    # long_500k at B = 1: the recurrent states, token shifts and conv windows gathered over "data" each step
    "serve/rwkv6-1.6b/long_500k": {
        "flops": 181540864.0, "bytes": 380270791.0,
        "coll": {"all-gather": 200888320.0, "reduce-scatter": 0.0, "all-reduce": 397312.0}},
    "tp/rwkv6-1.6b/long_500k": {
        "flops": 181540864.0, "bytes": 222832839.0,
        "coll": {"all-gather": 1087488.0, "reduce-scatter": 0.0, "all-reduce": 397312.0}},
    "serve/zamba2-1.2b/long_500k": {
        "flops": 162693120.0, "bytes": 347170881.0,
        "coll": {"all-gather": 174661632.0, "reduce-scatter": 0.0, "all-reduce": 367840.0}},
    "tp/zamba2-1.2b/long_500k": {
        "flops": 162693120.0, "bytes": 225036353.0,
        "coll": {"all-gather": 4526080.0, "reduce-scatter": 0.0, "all-reduce": 367840.0}},
}


def moe_config(configs):
    """deepseek-v2-236b at full width, its first 2 blocks (MOE_ARCH)."""
    import dataclasses

    return dataclasses.replace(configs.get("deepseek-v2-236b"), num_layers=2, block_pattern=("attn", "moe"))


def serve_sharded_phase(np, torch, dev, card, arch=SERVE_ARCH):
    """(x1): ``serve/sharded.py``'s prefill and decode as one NCCL rank
    (mesh (1, 1), ``serve``) at ``arch``'s full width and depth (gemma3-1b,
    rwkv6-1.6b, zamba2-1.2b), beside ``lm.forward`` / ``lm.decode_step``:
    logits and caches bit for bit, greedy sampling equal, the bytes handed
    to NCCL equal to the count of the same steps on ``meta``; ms a step of
    both paths, in turns (host clock after a sync), and the peak memory.
    Returns the seconds it took."""
    import socket

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import op_cost
    from repro_torch.launch.comm import CountingComm
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm
    from repro_torch.models.params import leaves
    from repro_torch.serve import sharded as SS
    from repro_torch.serve import sharded_check as SC

    t0 = time.perf_counter()
    cfg = configs.get(arch)
    if arch in RECURRENT_ARCHS and cfg.param_count() != RECURRENT_ARCHS[arch]:
        fail(f"(x1) {arch} has {cfg.param_count():,} parameters, not {RECURRENT_ARCHS[arch]:,}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        if dist.get_backend() != "nccl":
            fail(f"(x1) the card's process group runs {dist.get_backend()}, not nccl")
        layout, comm = SS.connect(Mesh(("data", "model"), (1, 1)), "serve")
        params = lm.lm_init(cfg, device=dev, seed=0)
        x = SC.inputs(cfg, batch=SERVE_B, prompt=SERVE_S, cache_len=SERVE_CACHE, steps=SERVE_STEPS, seed=1,
                      device=dev)
        sp = SS.shard_params(params, layout)
        prefill = SS.make_prefill_step(cfg, layout, comm)
        decode = SS.make_decode_step(cfg, layout, comm, SERVE_B, SERVE_CACHE)
        counter = CountingComm()
        meta_p = SS.shard_params(lm.lm_init(cfg, device="meta"), layout)
        with op_cost.counting() as c:
            SS.make_prefill_step(cfg, layout, counter)(meta_p, {k: v.to("meta") for k, v in x["batch"].items()})
            SS.make_decode_step(cfg, layout, counter, SERVE_B, SERVE_CACHE)(
                meta_p, SS.shard_caches(lm.cache_init(cfg, SERVE_B, SERVE_CACHE, device="meta"), cfg, layout),
                x["tokens"][0].to("meta"), torch.empty((), dtype=torch.int64, device="meta"))
        counted = {k: float(v) for k, v in c.coll.items() if v}

        def single_prefill():
            with torch.no_grad():
                return lm.forward(cfg, params, x["batch"], remat=False)

        times = {"single": [], "sharded": []}

        def timed(name, fn, *args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
            return out

        before = dict(comm.bytes)
        for order in (("single", "sharded"), ("sharded", "single")):
            for name in order:
                out = timed(name, prefill, sp, x["batch"]) if name == "sharded" else timed(name, single_prefill)
                if name == "sharded":
                    got = out
                else:
                    want = out
                del out
            if not bits_equal(torch, got, want):
                fail(f"(x1) prefill logits differ from lm.forward: max |diff| "
                     f"{float((got.float() - want.float()).abs().max()):.3e}")
        pf_ms = {k: v[-1] * 1e3 for k, v in times.items()}
        del got, want
        times = {"single": [], "sharded": []}
        caches, mine = x["caches"], SS.shard_caches(x["caches"], cfg, layout)
        for i, tok in enumerate(x["tokens"]):
            pos = torch.tensor(SERVE_S + i, device=dev)
            for name in (("single", "sharded") if i % 2 == 0 else ("sharded", "single")):
                if name == "single":
                    with torch.no_grad():
                        want, caches = timed(name, lm.decode_step, cfg, params, caches, tok, pos)
                else:
                    got, mine = timed(name, decode, sp, mine, tok, pos)
            if not bits_equal(torch, got, want):
                fail(f"(x1) decode step {i}: logits differ from lm.decode_step by "
                     f"{float((got.float() - want.float()).abs().max()):.3e}")
            if not all(bits_equal(torch, a, b) for a, b in zip(leaves(mine), leaves(caches))):
                fail(f"(x1) decode step {i}: caches differ from lm.decode_step's")
        tokens = SS.greedy(got, layout, comm, cfg.vocab_size)
        if not torch.equal(tokens, want.argmax(-1)):
            fail("(x1) greedy sampling differs from the argmax of lm.decode_step's logits")
        moved = {k: float(v - before.get(k, 0)) for k, v in comm.bytes.items() if v - before.get(k, 0)}
        if moved != counted:
            fail(f"(x1) bytes handed to NCCL {moved} != counted {counted}")
        if not torch.isfinite(got.float()).all():
            fail("(x1) non-finite logits")
        dec_ms = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
        log(f"(x1) {arch} at full width and depth ({cfg.param_count():,} parameters) on one NCCL rank, mesh "
            f"(1, 1) serve: prefill {SERVE_B} x {SERVE_S} and {SERVE_STEPS} teacher-forced decode steps from a "
            f"{SERVE_CACHE}-position cache: logits and caches bit-equal to lm.forward / lm.decode_step, greedy "
            f"equal; ms prefill sharded {pf_ms['sharded']:.3f} / single {pf_ms['single']:.3f}, ms a decode step "
            f"sharded {dec_ms['sharded']:.3f} / single {dec_ms['single']:.3f} (median of {SERVE_STEPS}, in turns, "
            f"eager); bytes handed to NCCL {moved} = counted {counted} (an axis of one rank runs no collective); "
            f"peak GiB {torch.cuda.max_memory_allocated() / 2**30:.2f} (the model whole and the rank's copy of it) "
            f"({card})")
        del params, sp, caches, mine, got, want, x
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def moe_serve_phase(np, torch, dev, card, out_dir):
    """(x1) for the moe family: MOE_ARCH (5,519,108,096 parameters) as one
    NCCL rank (mesh (1, 1), ``serve``). The single process first on
    ``lm_init(seed=0)``: prefill MOE_B x MOE_S and MOE_STEPS decode steps,
    the routed copies dropped at each MoE call, and (x2)'s single-process
    sides (``sharded_check.single_case``) written to ``out_dir``; then the
    whole model is freed and the rank's blocks drawn from the seed
    (``init_params``), and the sharded steps run in turns with the single
    process on those blocks (the whole model at (1, 1)): logits and caches
    of both bit for bit the first run's, greedy equal, the bytes handed to
    NCCL equal to the count on ``meta``. Returns ({case: file}, the seconds
    it took)."""
    import os
    import socket

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import op_cost
    from repro_torch.launch.comm import CountingComm
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import leaves
    from repro_torch.serve import sharded as SS
    from repro_torch.serve import sharded_check as SC

    t0 = time.perf_counter()
    cfg = moe_config(configs)
    if cfg.param_count() != MOE_PARAMS:
        fail(f"(x1) {MOE_ARCH} has {cfg.param_count():,} parameters, not {MOE_PARAMS:,}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    group = MOE._group_by_expert
    try:
        layout, comm = SS.connect(Mesh(("data", "model"), (1, 1)), "serve")
        x = SC.inputs(cfg, batch=MOE_B, prompt=MOE_S, cache_len=MOE_CACHE, steps=MOE_STEPS, seed=1, device=dev)
        params = lm.lm_init(cfg, device=dev, seed=0)
        drops = []

        def recording(expert_ids, num_experts, capacity, before=None):
            slot, keep = group(expert_ids, num_experts, capacity, before)
            drops.append((capacity, int((~keep).sum()), keep.numel()))
            return slot, keep

        def timed(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.no_grad():
                out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t) * 1e3

        MOE._group_by_expert = recording
        want_pf, first_ms = timed(lambda: lm.forward(cfg, params, x["batch"], remat=False))
        caches, want_dec = x["caches"], []
        for i, tok in enumerate(x["tokens"]):
            pos = torch.tensor(MOE_S + i, device=dev)
            (logits, caches), _ = timed(lambda: lm.decode_step(cfg, params, caches, tok, pos))
            want_dec.append(logits)
        MOE._group_by_expert = group
        pf_drops, dec_drops = drops[0], drops[1:]
        files = {}
        for shape, name, batch, arch in GLOO_SERVE:
            if arch != MOE_ARCH:
                continue
            mesh = Mesh(("data", "model"), tuple(int(v) for v in shape.split("x")))
            want = SC.single_case(cfg, params, batch=batch, prompt=MOE_S, cache_len=MOE_CACHE, steps=MOE_STEPS,
                                  start=MOE_S, split=SS.ServeLayout(mesh, 0, name).rows_split(batch), device=dev)
            files[f"{shape}/{name}"] = os.path.join(out_dir, f"{shape}_{name}.pt")
            torch.save(SC._map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, want), files[f"{shape}/{name}"])
            del want
        single_peak = torch.cuda.max_memory_allocated() / 2**30
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sp = SS.init_params(cfg, layout, seed=0, device=dev)
        prefill = SS.make_prefill_step(cfg, layout, comm)
        decode = SS.make_decode_step(cfg, layout, comm, MOE_B, MOE_CACHE)
        counter = CountingComm()
        meta_p = SS.shard_params(lm.lm_init(cfg, device="meta"), layout)
        with op_cost.counting() as c:
            SS.make_prefill_step(cfg, layout, counter)(meta_p, {k: v.to("meta") for k, v in x["batch"].items()})
            SS.make_decode_step(cfg, layout, counter, MOE_B, MOE_CACHE)(
                meta_p, SS.shard_caches(lm.cache_init(cfg, MOE_B, MOE_CACHE, device="meta"), cfg, layout),
                x["tokens"][0].to("meta"), torch.empty((), dtype=torch.int64, device="meta"))
        counted = {k: float(v) for k, v in c.coll.items() if v}
        before = dict(comm.bytes)
        ms = {"sharded": [], "single": []}
        for order in (("sharded", "single"), ("single", "sharded")):
            for name in order:
                if name == "sharded":
                    got, t = timed(lambda: prefill(sp, x["batch"]))
                else:
                    got, t = timed(lambda: lm.forward(cfg, sp, x["batch"], remat=False))
                ms[name].append(t)
                if not bits_equal(torch, got, want_pf):
                    fail(f"(x1) {MOE_ARCH} prefill ({name}, the rank's blocks) differs from lm.forward on lm_init: "
                         f"max |diff| {float((got.float() - want_pf.float()).abs().max()):.3e}")
                del got
        pf_ms = {k: v[-1] for k, v in ms.items()}
        ms = {"sharded": [], "single": []}
        lc = {"sharded": SS.shard_caches(x["caches"], cfg, layout), "single": x["caches"]}
        for i, tok in enumerate(x["tokens"]):
            pos = torch.tensor(MOE_S + i, device=dev)
            for name in (("sharded", "single") if i % 2 == 0 else ("single", "sharded")):
                if name == "sharded":
                    (got, lc[name]), t = timed(lambda: decode(sp, lc[name], tok, pos))
                else:
                    (got, lc[name]), t = timed(lambda: lm.decode_step(cfg, sp, lc[name], tok, pos))
                ms[name].append(t)
                if not bits_equal(torch, got, want_dec[i]):
                    fail(f"(x1) {MOE_ARCH} decode step {i} ({name}): logits differ from lm.decode_step's by "
                         f"{float((got.float() - want_dec[i].float()).abs().max()):.3e}")
        for name, mine in lc.items():
            if not all(bits_equal(torch, a, b) for a, b in zip(leaves(mine), leaves(caches))):
                fail(f"(x1) {MOE_ARCH} ({name}): caches differ from lm.decode_step's")
        tokens = SS.greedy(got, layout, comm, cfg.vocab_size)
        if not torch.equal(tokens, want_dec[-1].argmax(-1)) or not torch.isfinite(got.float()).all():
            fail(f"(x1) {MOE_ARCH}: greedy sampling differs from lm.decode_step's argmax, or logits not finite")
        moved = {k: float(v - before.get(k, 0)) for k, v in comm.bytes.items() if v - before.get(k, 0)}
        if moved != counted:
            fail(f"(x1) {MOE_ARCH}: bytes handed to NCCL {moved} != counted {counted}")
        caps = (MOE.capacity(cfg.moe, MOE_B * MOE_S), MOE.capacity(cfg.moe, MOE_B))  # 96 and 1 at full width
        if pf_drops[0] != caps[0] or any(cap != caps[1] for cap, _, _ in dec_drops):
            fail(f"(x1) {MOE_ARCH}: capacities {pf_drops}, {dec_drops}: want {caps[0]} for the prefill's "
                 f"{MOE_B * MOE_S} tokens, {caps[1]} for a decode step's {MOE_B}")
        sharded_peak = torch.cuda.max_memory_allocated() / 2**30
        dec_ms = {k: float(np.median(v)) for k, v in ms.items()}
        log(f"(x1) {MOE_ARCH} at full width ({cfg.param_count():,} parameters: MLA on both layers, the dense "
            f"{cfg.d_ff} FFN, then {cfg.moe.num_experts} experts top-{cfg.moe.top_k} + {cfg.moe.num_shared} shared) "
            f"on one NCCL rank, mesh (1, 1) serve: prefill {MOE_B} x {MOE_S} and {MOE_STEPS} teacher-forced decode "
            f"steps from a {MOE_CACHE}-position cache, the single process on lm_init first, then the rank's blocks "
            f"from the seed (init_params) after the whole model was freed: logits and caches of the sharded steps "
            f"and of lm.forward / lm.decode_step on those blocks bit-equal to the first run's, greedy equal; routed "
            f"copies (capacity, dropped, of copies): prefill {pf_drops}, decode {dec_drops}; ms prefill sharded "
            f"{pf_ms['sharded']:.3f} / single {pf_ms['single']:.3f} (the first single run {first_ms:.3f}), ms a "
            f"decode step sharded {dec_ms['sharded']:.3f} / single {dec_ms['single']:.3f} (median of {MOE_STEPS}, "
            f"in turns, eager); bytes handed to NCCL {moved} = counted {counted}; peak GiB single process "
            f"{single_peak:.2f}, rank {sharded_peak:.2f} ({card})")
        del sp, lc, got, want_pf, want_dec, caches, x
        torch.cuda.synchronize()
    finally:
        MOE._group_by_expert = group
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return files, time.perf_counter() - t0


# (x2)'s rank: every case of GLOO_SERVE on the one card over gloo, held to
# serve/sharded_check's bounds
GLOO_SERVE_RANK = """
import datetime, json, os, re, sys, time
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
REFUSAL = re.compile(r"unsupported device type|No backend type associated with device type")


def probe(dev):
    # the serving step's collectives on CUDA tensors: gloo's refusal, or None
    try:
        dist.all_gather_into_tensor(torch.empty(2 * WORLD, dtype=torch.bfloat16, device=dev),
                                    torch.ones(2, dtype=torch.bfloat16, device=dev))
        for dtype, op in ((torch.float32, dist.ReduceOp.SUM), (torch.bfloat16, dist.ReduceOp.SUM),
                          (torch.float32, dist.ReduceOp.MAX), (torch.int64, dist.ReduceOp.MIN)):
            dist.all_reduce(torch.ones(2, dtype=dtype, device=dev), op=op)
    except (RuntimeError, ValueError) as e:
        if REFUSAL.search(str(e)):
            return f"{type(e).__name__}: {e}"[:600]
        raise
    return None


def config(arch):
    import dataclasses
    from repro_torch import configs

    if arch == "deepseek-v2-236b/2":  # full width, its first 2 blocks (chip_smoke.moe_config)
        return dataclasses.replace(configs.get("deepseek-v2-236b"), num_layers=2, block_pattern=("attn", "moe"))
    name, _, depth = arch.partition("/")
    cfg = configs.get(name)
    if depth:  # full width, its first layers (chip_smoke.RECURRENT_DEPTH)
        cfg = dataclasses.replace(cfg, num_layers=int(depth), block_pattern=cfg.block_pattern[:int(depth)])
    return cfg


def rank_main(rank, init, cases, out_dir):
    sys.path.insert(0, os.environ["PORT_SRC"])
    from repro_torch.launch.comm import Comm
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.layers import set_reference_precision
    from repro_torch.serve import sharded as SS, sharded_check as SC

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    set_reference_precision()
    res = {"rank": rank}
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD,
                                timeout=datetime.timedelta(seconds=300))
        res["refusal"] = probe(dev)
        if res["refusal"] is None:
            res["cases"] = {}
            for case in cases:
                shape, name, batch = case["shape"], case["name"], case["batch"]
                t0 = time.perf_counter()
                torch.cuda.reset_peak_memory_stats()
                layout, comm = SS.connect(Mesh(("data", "model"), tuple(int(x) for x in shape.split("x"))), name)
                # the single process's side: this rank's own run, or (a model no rank holds whole) a file
                want = torch.load(case["want"], map_location=dev) if case["want"] else None
                r = SC.run_case(config(case["arch"]), layout, comm, Comm(comm.groups), batch=batch,
                                prompt=case["prompt"], cache_len=case["cache_len"], steps=case["steps"],
                                start=case["prompt"], device=dev, want=want)
                del want
                try:
                    SC.hold(f"{shape} {name} {case['arch']}", r, SC.card_bounds(f"{shape}/{name}", r))
                except AssertionError as e:  # every case runs; the parent fails the phase
                    r["hold"] = str(e)[:600]
                r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                r["s"] = time.perf_counter() - t0
                res["cases"][f"{shape}/{name}/{case['arch']}/B{batch}"] = r
                del comm, layout
                torch.cuda.empty_cache()
        dist.destroy_process_group()
    except Exception as e:  # every error fails (x2): the parent reports it
        import traceback
        res["error"] = f"{type(e).__name__}: {e}"[:600]
        res["trace"] = traceback.format_exc()[-3000:]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    init, cases, out_dir = sys.argv[1:4]
    mp.spawn(rank_main, args=(init, json.loads(cases), out_dir), nprocs=WORLD, join=True)
"""


def gloo_serve_start(moe_files):
    """(x2)'s 4 gloo processes, started (``moe_files``: the moe cases'
    single-process sides from :func:`moe_serve_phase`): (the process, its
    directory, the start time)."""
    import os
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="gloo_serve_")
    script = os.path.join(tmp, "ranks.py")
    with open(script, "w") as f:
        f.write(GLOO_SERVE_RANK)
    env = dict(os.environ, PORT_SRC=str(SRC), PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    moe = dict(prompt=MOE_S, cache_len=MOE_CACHE, steps=MOE_STEPS)
    dense = dict(prompt=SERVE_S, cache_len=SERVE_CACHE, steps=SERVE_STEPS, want=None)
    cases = [dict(shape=shape, name=name, batch=batch, arch=arch,
                  **(dict(moe, want=moe_files[f"{shape}/{name}"]) if arch == MOE_ARCH else dense))
             for shape, name, batch, arch in GLOO_SERVE]
    proc = spawn([sys.executable, script, f"file://{tmp}/rdv", json.dumps(cases), tmp], env=env,
                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, t0


def gloo_serve_phase(started, card):
    """(x2): 4 gloo processes on the one card (:func:`gloo_serve_start`),
    gemma3-1b at full width on each mesh of GLOO_SERVE:
    ``serve/sharded_check.run_case`` + ``hold`` on every rank (the CPU
    tests' own code; the full-width bounds). A refusal counts only where
    gloo itself refuses a CUDA collective (each rank probes them first): it
    is logged, and nothing runs in its place; any other error fails the
    phase. Returns (the refusal or None, s)."""
    import os

    from repro_torch.serve import sharded_check as SC

    proc, tmp, t0 = started
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            kill_tree(proc)
    ranks = []
    for r in range(4):
        path = os.path.join(tmp, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                ranks.append(json.load(f))
    problems = [] if proc.returncode == 0 and len(ranks) == 4 else [
        f"the 4 gloo processes exited {proc.returncode} with {len(ranks)} reports:\n{err[-3000:]}"]
    problems += [f"rank {r['rank']}: {r['error']}\n{r['trace'][-1500:]}" for r in ranks if "error" in r]
    if problems:
        fail("(x2) " + "\n".join(problems))
    refusals = [f"rank {r['rank']}: {r['refusal']}" for r in ranks if r["refusal"] is not None]
    if refusals:
        if len(refusals) != 4:
            fail(f"(x2) gloo refused CUDA tensors on some ranks only: {refusals}")
        log(f"(x2) gloo refused the serving step's collectives on CUDA tensors ({refusals[0]}); the 4-rank step "
            "on the card did not run (no CPU run stands in for it)")
        return refusals[0], time.perf_counter() - t0
    held = []
    for shape, name, batch, arch in GLOO_SERVE:
        cases = [r["cases"][f"{shape}/{name}/{arch}/B{batch}"] for r in ranks]
        held += [f"rank {i}: {c['hold']}" for i, c in enumerate(cases) if "hold" in c]
        c0 = cases[0]
        numbers = [{k: max(c[k]) if isinstance(c[k], list) else c[k] for k in ("prefill", "decode", "caches")}
                   for c in cases]
        bounds = [SC.card_bounds(f"{shape}/{name}", c) for c in cases]
        prompt, steps = (MOE_S, MOE_STEPS) if arch == MOE_ARCH else (SERVE_S, SERVE_STEPS)
        routed = "" if not c0["moe"] else (
            f"; the routed experts (first MoE layer, its own activations) bit-equal to the single process's rows by "
            f"rank {[c['routed']['equal'] for c in cases]} (distance {[c['routed']['dist'] for c in cases]}; the "
            f"rank's router picks the single process's experts {[c['routed']['routes_equal'] for c in cases]}, its "
            f"gates bit for bit {[c['routed']['gates_equal'] for c in cases]}), experts by rank "
            f"{[c['routed']['experts'] for c in cases]}, "
            f"capacity {c0['routed']['capacity']}, {c0['routed']['dropped']} of {c0['routed']['copies']} copies "
            f"dropped, a capacity from a data rank's own tokens ({c0['routed'].get('local_capacity')}) would drop "
            f"other copies: {c0['routed']['local_drops_differ']}")
        log(f"(x2) 4 gloo ranks on the one card, mesh {shape} {name}, {arch} at full width, batch {batch} x "
            f"{prompt} + {steps} decode steps against the single process on the card (max |diff| / max "
            f"|value|; by rank, each with serve/sharded_check.card_bounds): "
            + "; ".join(f"rank {i} " + ", ".join(f"{k} {n[k]:.4g} <= {b[k]:.4g}" for k in n)
                        for i, (n, b) in enumerate(zip(numbers, bounds)))
            + f" (the floor, the single process on a part of the batch alone against the batch: "
            f"{[c['floor'] for c in cases]}){routed}; "
            f"prefill bit for bit required {c0['prefill_exact']}; the first w_out product's outputs not correctly "
            f"rounded (rank 0: port / single process / bf16 partials) {c0['rounded_once']}; heads of rank 1 "
            f"{cases[1]['heads']}, recurrent heads {cases[1].get('ssm_heads')}; bytes a rank (rank 0) "
            f"{c0['moved']} = counted; cache bytes a rank "
            f"{c0['cache_bytes']:,} (cache_specs: {c0['cache_bytes_specs']:,}; at rest by their split over "
            f"'data': {c0['cache_bytes_by_kind']}; each 'other' leaf's: {c0['other_leaf_bytes']}); parameters a rank "
            f"{c0['param_numel']:,} = local_numel; greedy tokens equal to the single process's by rank "
            f"{[c['greedy_single'] for c in cases]} (the picked tokens' single-process logits below its largest by "
            f"{[round(c['greedy_margin'], 5) for c in cases]} of the largest |logit|); peak GiB by rank {[round(c['peak_gib'], 2) for c in cases]}; "
            f"s {[round(c['s'], 1) for c in cases]} ({card})")
    if held:
        fail("(x2) outside serve/sharded_check's bounds:\n" + "\n".join(held))
    return None, time.perf_counter() - t0


def serve_dryrun_start():
    """(x3)'s counts, started in a process of their own: ``python -m
    repro_torch.launch.dryrun --arch A --shape S --serve-layout L`` for
    SERVE_COUNTS' architectures and shapes under serve and tp, one
    directory a layout."""
    import os

    code = ("import sys\nfrom repro_torch.launch import dryrun\n"
            "for lay in ('serve', 'tp'):\n"
            "    for arch, shape in " + repr([tuple(k.split("/")[1:]) for k in SERVE_COUNTS if k.startswith("serve/")])
            + ":\n"
            f"        dryrun.main(['--arch', arch, '--shape', shape, '--serve-layout', lay, '--out', "
            f"'{SERVE_DRYRUN_DIR}/' + lay])\n")
    for lay in ("serve", "tp"):
        for f in (SERVE_DRYRUN_DIR / lay).glob("*.json") if (SERVE_DRYRUN_DIR / lay).exists() else ():
            f.unlink()
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return spawn([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def serve_dryrun_phase(proc, card):
    """(x3): the counts started by :func:`serve_dryrun_start`: valid per_rank
    records with a collective term, equal to the CPU's (SERVE_COUNTS)."""
    from repro_torch.launch import dryrun

    try:
        outp = proc.communicate(timeout=600)[0]
    finally:
        if proc.poll() is None:
            kill_tree(proc)
    if proc.returncode != 0:
        fail(f"(x3) the serving dry-runs exited {proc.returncode}:\n{outp[-3000:]}")
    for key, want in SERVE_COUNTS.items():
        lay, arch, shape = key.split("/")
        rec = json.loads((SERVE_DRYRUN_DIR / lay / f"{arch}__{shape}__16x16.json").read_text())
        got = {"flops": rec["flops_per_device"], "bytes": rec["bytes_per_device"],
               "coll": rec["collective_bytes_per_device"]}
        t = rec["roofline"]
        if dryrun.record_problems(rec) or rec["split"] != "per_rank" or t["collective_s"] is None:
            fail(f"(x3) {key}: {dryrun.record_problems(rec)}, split {rec['split']}, {t}")
        if got != want:
            fail(f"(x3) {key}: the card's count {got} != the CPU's {want}")
        log(f"(x3) {arch} {shape} on 16x16 under {lay}, one rank on meta ({rec['t_count_s']} s): the CPU's "
            f"count exactly: {got['flops']:.6e} FLOPs, {got['bytes']:.6e} bytes, collective {got['coll']}; compute "
            f"{t['compute_s']:.5g} s, memory {t['memory_s']:.5g} s, collective {t['collective_s']:.5g} s: "
            f"{t['dominant']}; state bytes a device {rec['state_bytes_per_device']} (H100 constants; no card used)")


def main() -> int:
    import signal

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))  # a stop runs atexit: the children are killed
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card to run on", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import fig1, kernel_bench, quickstart
    from repro_torch.core import compressors as C
    from repro_torch.core import ef21p, problems, stepsizes
    from repro_torch.kernels import l1_subgrad as k_l1
    from repro_torch.kernels import ops, ref, runtime
    from repro_torch.kernels import topk as k_topk

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # --- build ------------------------------------------------------------------
    t0 = time.perf_counter()
    libs = runtime.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    datagen = datagen_start()  # (q)'s problem, on the host from here on
    for stem in sorted(libs):
        logf = runtime.BUILD / f"{stem}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {stem}: {line.strip()}")

    # --- (a) kernels against their plain versions on the card -------------------
    mark("(a)")
    l1_err = 0.0
    # the last six: the shapes the harness's runs (q)-(r) give it (comm_complexity,
    # fig1, stepsize_grid, scenario / transport / trace_smoke)
    for n, d in ((10, 1000), (100, 1000), (3, 257), (1, 1024),  # d = 1024: 48 KB of tiles
                 (8, 128), (10, 200), (50, 200), (10, 120), (16, 64), (8, 64)):
        A_np, X_np = l1_inputs(np, n, d, seed=n * 7919 + d)
        A, X = torch.from_numpy(A_np).to(dev), torch.from_numpy(X_np).to(dev)
        got = k_l1.l1_subgrad(A, X)
        again = k_l1.l1_subgrad(A, X)
        want = ref.l1_subgrad_ref(A, X)
        torch.cuda.synchronize()
        if not bits_equal(torch, got, again):
            fail(f"l1_subgrad n={n} d={d}: two identical launches differ")
        if not torch.allclose(got, want, rtol=L1_RTOL, atol=L1_ATOL):
            fail(f"l1_subgrad n={n} d={d}: max |kernel - plain| = {(got - want).abs().max().item()}")
        l1_err = max(l1_err, (got - want).abs().max().item())
        # one point shared by all workers (row stride 0), as EF21-P and SM pass it
        A_np, X_np = l1_inputs(np, n, d, seed=n * 7919 + d + 1, shared=True)
        A, xs = torch.from_numpy(A_np).to(dev), torch.from_numpy(X_np[0]).to(dev).expand(n, d)
        got_b, want_b = k_l1.l1_subgrad(A, xs), ref.l1_subgrad_ref(A, xs)
        torch.cuda.synchronize()
        if not torch.allclose(got_b, want_b, rtol=L1_RTOL, atol=L1_ATOL):
            fail(f"l1_subgrad n={n} d={d} broadcast x: max err {(got_b - want_b).abs().max().item()}")
        l1_err = max(l1_err, (got_b - want_b).abs().max().item())
        same = bits_equal(torch, got, want) and bits_equal(torch, got_b, want_b)
        del A, X, xs
        log(f"(a) l1_subgrad n={n} m=d={d}: max |kernel - plain| = {l1_err:.3e} "
            f"({'bit-equal' if same else 'not bit-equal'}: the plain version sums in the kernel's "
            "order); two launches bit-equal")

    rng = np.random.default_rng(1)
    topk_cases = []
    # block = d: EF21-P's TopK on the harness's runs (q)-(r)
    for d, block, k in ((1000, 1000, 100), (2048, 512, 16), (1000, 128, 4),
                        (128, 128, 4), (128, 128, 16), (128, 128, 64), (200, 200, 20),
                        (120, 120, 12), (64, 64, 8), (1000, 1000, 10)):
        topk_cases.append((f"d={d} block={block} k={k} f32",
                           torch.from_numpy(rng.standard_normal(d).astype(np.float32)), block, k))
        ties = np.round(rng.standard_normal(d) * 2) / 2  # many exact ties
        topk_cases.append((f"d={d} block={block} k={k} f32 ties",
                           torch.from_numpy(ties.astype(np.float32)), block, k))
        topk_cases.append((f"d={d} block={block} k={k} bf16",
                           torch.from_numpy(rng.standard_normal(d).astype(np.float32)).bfloat16(),
                           block, k))
    edge = edge_vector(np, torch)
    topk_cases.append(("edge inf/-0.0/denormal k=3", edge, 128, 3))
    topk_cases.append(("edge inf/-0.0/denormal k=8", edge, 128, 8))
    nan_edge = edge.clone()
    nan_edge[1] = float("nan")
    topk_cases.append(("edge NaN k=3", nan_edge, 128, 3))
    after_inf = edge.clone()
    after_inf[1] = 0.25  # no inf: selection runs past the denormals
    topk_cases.append(("edge -0.0/denormal k=12", after_inf, 128, 12))
    topk_cases += radix_cases(np, torch, k_topk.MAX_BLOCK)
    topk_err = 0.0
    for name, x, block, k in topk_cases:
        x = x.to(dev)
        pad = (-x.shape[0]) % block
        xp = torch.nn.functional.pad(x, (0, pad))
        got = k_topk.block_topk_compress(xp, k_per_block=k, block=block)
        want = ref.block_topk_ref(xp, k_per_block=k, block=block)
        torch.cuda.synchronize()
        finite = torch.isfinite(got) & torch.isfinite(want)
        topk_err = max(topk_err, float((got.float() - want.float()).abs()[finite].max()))
        if not bits_equal(torch, got, want):
            diff = (got != want).nonzero().flatten()[:8].tolist()
            fail(f"block_topk {name}: kernel != plain at {diff}")
    kept = torch.nonzero(k_topk.block_topk_compress(edge.to(dev), k_per_block=3, block=128)).flatten()
    if kept.tolist() != [1]:
        fail(f"block_topk: the Pallas inf quirk should keep only index 1, kept {kept.tolist()}")
    log(f"(a) block_topk: {len(topk_cases)} cases bit-equal to the plain version, the radix select's "
        "ties / all-equal / few non-zeros / k=1 / k=b / MAX_BLOCK / NaN+inf / two infs / denormals / "
        "digit-boundary blocks in f32 and bf16 included (inf case keeps only index 1, as the Pallas kernel)")

    # --- (b) the main path on the card --------------------------------------------
    mark("(b)")
    D, N, T = 1000, 10, 400
    runtime.reset_launches()
    suite = fig1.run_suite(d=D, n=N, T=T, device=dev)
    qs = quickstart.main(n=N, d=D, budget=2e6, device=dev)
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    log(f"(b) launches on the main path: {launches}")
    for kname in ("l1_subgrad", "block_topk"):
        if launches.get(kname, 0) <= 0:
            fail(f"(b) the main path never launched {kname}")
    for name, r in suite.items():
        if not np.isfinite(r["final_subopt"]) or r["rounds"] != T:
            fail(f"(b) {name}: rounds={r['rounds']} final f={r['final_subopt']}")
        log(f"(b) {name:20s} rounds={r['rounds']} final f(x)={r['final_subopt']:.6g} "
            f"us/round={r['us_per_round']:.1f} bits/worker={r['bits_per_worker']:.4g}")
    f0 = suite["ef21p_topk_const"]["hist"]["f_x"][0]
    for name, h in qs.items():
        if not np.isfinite(h["f_x"][-1]) or h["ledger"].s2w_bits < 2e6:
            fail(f"(b) quickstart {name}: did not reach the bit budget with a finite f")
    if not qs["MARINA-P/PermK/Polyak"]["f_x"][-1] < f0:
        fail("(b) quickstart: MARINA-P did not decrease f")

    # --- (c) CPU port against the card, T=10, same seeds ------------------------------
    mark("(c)")
    T_C = 10
    gpu_c = fig1.run_suite(d=D, n=N, T=T_C, device=dev)
    cpu_c = fig1.run_suite(d=D, n=N, T=T_C, device="cpu")
    worst, problems_c = 0.0, []
    for name in suite:
        hc, hg = cpu_c[name]["hist"], gpu_c[name]["hist"]
        rel = float(np.max(np.abs(np.subtract(hc["f_x"], hg["f_x"])) / np.abs(hg["f_x"])))
        log(f"(c) {name}: CPU vs card max rel f_x diff {rel:.3e}")
        if hc["s2w_bits"] != hg["s2w_bits"]:
            problems_c.append(f"{name}: CPU and card s2w_bits differ")
        if name.endswith("_polyak") and hg["f_x"] != suite[name]["hist"]["f_x"][:T_C]:
            problems_c.append(f"{name}: card T={T_C} run differs from (b)'s first {T_C} rounds")
        # EF21-P is not held free-running: TopK breaks exact ties of |x - w|
        # (the tridiagonal problem makes many) by the last bit of x - gamma*g,
        # so its trajectory follows the summation order of the worker mean
        # and of f_w. It is held per step from identical states below.
        if name.startswith("marina"):
            worst = max(worst, rel)
            if rel > TRAJ_RTOL:
                problems_c.append(f"{name}: CPU vs card f_x rel err {rel:.3e} > {TRAJ_RTOL}")
    if problems_c:
        fail("(c) " + "; ".join(problems_c))
    log(f"(c) MARINA-P, 6 runs, CPU vs card over {T_C} rounds: max rel f_x err {worst:.3e}; "
        "s2w_bits equal for all 8; card Polyak runs bit-equal to (b)")

    prob = problems.generate_problem(n=N, d=D, noise_scale=1.0, seed=0, device=dev)
    prob_cpu = prob.to("cpu")
    k, alpha = D // N, (D // N) / D
    worst = 0.0
    for name, stepsize in (
        ("ef21p_topk_const", stepsizes.Constant(stepsizes.ef21p_optimal_constant(prob.R0_sq, prob.L0, alpha, T))),
        ("ef21p_topk_polyak", stepsizes.EF21PPolyak(alpha=alpha, f_star=0.0)),
    ):
        step_g = ef21p.make_step(prob, C.TopK(k=k), stepsize)
        step_c = ef21p.make_step(prob_cpu, C.TopK(k=k), stepsize)
        state = ef21p.init(prob.x0)
        for t in range(T_C):
            here = ef21p.EF21PState(x=state.x.cpu(), w=state.w.cpu(), t=state.t)
            state, mg = step_g(state)
            _, mc = step_c(here)
            rel = abs(float(mc["f_x"]) - float(mg["f_x"])) / abs(float(mg["f_x"]))
            worst = max(worst, rel)
            if rel > TRAJ_RTOL or float(mc["delta_nnz"]) != float(mg["delta_nnz"]):
                fail(f"(c) {name} round {t}: CPU step from the card's state: rel f_x err {rel:.3e}")
    log(f"(c) EF21-P, 2 runs, CPU step from the card's state each round over {T_C} rounds: "
        f"max rel f_x err {worst:.3e}")

    # --- (d) timing at the main path's shapes -------------------------------------------
    mark("(d)")
    flush_buf = torch.empty(kernel_bench.FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def timed(fn, reps=30):
        """Median ms of one call (CUDA events, L2 flushed before each call)."""
        return kernel_bench.median_ms(fn, reps, flush_buf)

    W = prob.x0.expand(N, D).contiguous() + 0.01 * torch.randn(N, D, device=dev,
                                                                 generator=torch.Generator(dev).manual_seed(0))
    l1_ms = timed(lambda: ops.l1_subgrad(prob.A, W))
    l1_plain_ms = timed(lambda: ref.l1_subgrad_ref(prob.A, W))
    l1_bytes = prob.A.numel() * 4 + 2 * W.numel() * 4
    l1_flops = 4 * prob.A.numel()
    l1_bound = max(l1_bytes / HBM_BYTES_PER_S, l1_flops / FP32_FLOPS_PER_S) * 1e3
    A100 = torch.randn(100, D, D, device=dev, generator=torch.Generator(dev).manual_seed(1))
    W100 = torch.randn(100, D, device=dev, generator=torch.Generator(dev).manual_seed(2))
    l1_ms_100 = timed(lambda: ops.l1_subgrad(A100, W100))
    l1_bound_100 = (A100.numel() * 4 + 2 * W100.numel() * 4) / HBM_BYTES_PER_S * 1e3
    del A100

    def timed_write_flush(fn, reps=30):
        """As ``timed``, with the L2 evicted by a write (the earlier timer): the
        call then also pays the write-back of the dirty L2."""
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(kernel_bench.HOLD_CYCLES)
            flush_buf.zero_()
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[reps // 2]

    l1_ms_write_flush = timed_write_flush(lambda: ops.l1_subgrad(prob.A, W))
    a_sum_ms = timed(lambda: prob.A.sum())  # a library read of the same 40 MB, for scale
    a_sum_ms_write_flush = timed_write_flush(lambda: prob.A.sum())

    xt = (W[0] - prob.x0).contiguous()
    tk_ms = timed(lambda: ops.block_topk(xt, k_per_block=k, block=D))
    tk_plain_ms = timed(lambda: ref.block_topk_ref(xt, k_per_block=k, block=D))

    def topk_library():
        idx = torch.topk(xt.abs(), k).indices
        return torch.zeros_like(xt).scatter_(0, idx, xt.gather(0, idx))

    tk_lib_ms = timed(topk_library)
    if not torch.equal(topk_library(), ops.block_topk(xt, k_per_block=k, block=D)):
        log("(d) note: torch.topk yardstick selects other indices than the kernel on this input")
    tk_bytes = 2 * D * 4
    tk_ops = D  # a selection looks at each value at least once (the radix select: 1 to 4 passes)
    tk_bound = max(tk_bytes / HBM_BYTES_PER_S, tk_ops / FP32_FLOPS_PER_S) * 1e3
    log(f"(d) l1_subgrad n={N} m=d={D}: {l1_ms:.4f} ms (plain {l1_plain_ms:.4f}, bound {l1_bound:.4f}); "
        f"n=100: {l1_ms_100:.4f} ms (bound {l1_bound_100:.4f})")
    log(f"(d) for scale, n={N}: A.sum() (a library read of the same A) {a_sum_ms:.4f} ms; with the L2 "
        f"flushed by a write (the earlier timer): l1_subgrad {l1_ms_write_flush:.4f} ms, A.sum() "
        f"{a_sum_ms_write_flush:.4f} ms")
    log(f"(d) block_topk d=block={D} k={k}: {tk_ms:.4f} ms (plain {tk_plain_ms:.4f}, "
        f"torch.topk+scatter {tk_lib_ms:.4f}, bound {tk_bound:.6f})")
    floor_ms = timed(lambda: torch.cuda._sleep(0))  # one launch of a kernel that does nothing
    log(f"(d) launch floor, one empty kernel (torch.cuda._sleep(0)) timed as the kernels are: {floor_ms:.5f} ms")

    # --- (e) the wire kernels against their plain versions on the card ------------------
    mark("(e)")
    from repro_torch import wire, wire_bench
    from repro_torch.core import marina_p
    from repro_torch.kernels import encode as kenc

    wire_err = wire_kernels_vs_plain(np, torch, dev)
    log(f"(e) pack_bits/unpack_bits ({len(WIDTHS)} widths x 6 sizes, batched rows), sparse_streams and "
        "dense_bits (3 dtypes, random / random-bit / IEEE-corner rows) bit-equal to their "
        "plain versions; device buffers == host codec")

    # --- (f) the wire path on the card ---------------------------------------------------
    mark("(f)")
    p = k / D
    omegas = {"same": D / k - 1.0, "ind": D / k - 1.0, "perm": float(N - 1)}
    runtime.reset_launches()
    dev_runs, run_launches = wire_runs(torch, prob, k, p, T, None, runtime)
    torch.cuda.synchronize()
    wire_launches = {kname: runtime.LAUNCHES.get(kname, 0)
                     for kname in ("pack_bits", "unpack_bits", "sparse_streams", "dense_bits")}
    log(f"(f) launches on the wire path (5 runs x {T} rounds): {wire_launches}; unpack_bits decodes, "
        "which no run of the path does")
    for kname in ("pack_bits", "sparse_streams", "dense_bits"):
        if wire_launches[kname] <= 0:
            fail(f"(f) the wire path never launched {kname}")
    n_checked = sum(marina_wire_rounds(np, torch, dev, prob, mode, k, p, omega, 20)
                    for mode, omega in omegas.items())
    host_runs, _ = wire_runs(torch, prob, k, p, T, False)
    for name, h in dev_runs.items():
        if not np.isfinite(h["f_x"][-1]) or h["ledger"].rounds != T:
            fail(f"(f) {name}: rounds={h['ledger'].rounds} final f={h['f_x'][-1]}")
        if h["wire_bits"] != host_runs[name]["wire_bits"]:
            fail(f"(f) {name}: wire_bits with device encode != with the host codec")
        a = h["wire_model_ledger"].s2w_bits
        log(f"(f) {name:24s} final f(x)={h['f_x'][-1]:.6g} wire bits/round={h['wire_bits_total'] / T:.1f} "
            f"analytic (32-bit values) {a / T:.1f} gap {100 * (h['wire_bits_total'] - a) / a:+.3f}%; "
            f"launches/round {{{', '.join(f'{kk}: {v / T:g}' for kk, v in sorted(run_launches[name].items()) if v)}}}")
    log(f"(f) 5 runs x {T} rounds: wire_bits per round equal with device and host encode; first 20 rounds "
        f"of each MARINA-P mode: {n_checked} device buffers == host buffers")

    # --- (g) CPU port against the card, T=20 ---------------------------------------------
    mark("(g)")
    T_G = 20
    gpu20, _ = wire_runs(torch, prob, k, p, T_G, None)
    cpu20, _ = wire_runs(torch, prob_cpu, k, p, T_G, None)
    for name in gpu20:
        hg, hc = gpu20[name], cpu20[name]
        same = (hc["wire_bits"] == hg["wire_bits"] and hc["s2w_bits"] == hg["s2w_bits"]
                and hc["wire_model_ledger"].s2w_bits == hg["wire_model_ledger"].s2w_bits)
        log(f"(g) {name:24s} CPU vs card over {T_G} rounds: wire_bits and wire ledger "
            f"{'equal' if same else 'DIFFER'} (wire bits {hc['wire_bits_total']:.0f} / {hg['wire_bits_total']:.0f})")
        if name.startswith("marina") and not same:
            fail(f"(g) {name}: CPU and card wire bits differ")

    # --- (h) DESIGN §3.5 on the card: measured vs analytic ------------------------------------
    mark("(h)")
    for d_b, n_b in wire_bench.SETTINGS:
        rows = wire_bench.parity_rows(d=d_b, n=n_b, T=200, device=dev)
        for name, analytic, measured, pct in rows:
            log(f"(h) d={d_b} n={n_b} T=200 {name:18s} analytic={analytic:.1f} wire={measured:.1f} gap={pct:+.3f}%")
        if wire_bench.failures(rows):
            fail(f"(h) d={d_b} n={n_b}: MARINA-P gap >= {wire_bench.GAP_LIMIT_PCT}%: {wire_bench.failures(rows)}")

    # --- (i) timing of the wire kernels -------------------------------------------------------
    mark("(i)")
    step = marina_p.make_step(prob, "ind", k, p, stepsizes.MarinaPPolyak(omega=omegas["ind"], p=p),
                              return_q=True)
    bcast = marina_p.make_broadcast("ind", N, k)
    _, mq = step(marina_p.init(prob.x0, N),
                 marina_p.draw_round(bcast, p, D, torch.Generator().manual_seed(0), dev))
    Q, x_new = mq["Q"].contiguous(), mq["x_new"].contiguous()  # a round's messages: [10, 1000], [1000]
    iw = wire.index_width(D)
    (idx_stream, _, _), _ = kenc._compact_streams(kenc._arange_rows(N, D, dev), *kenc.sparse_streams(Q, "fp32"))
    idx_words = ops.pack_bits(idx_stream, iw)
    big = 2**20
    gbig = torch.Generator(dev).manual_seed(3)
    xbig = torch.randn(big, device=dev, generator=gbig)
    Xbig = torch.where(torch.rand(big, device=dev, generator=gbig) < 1 / 16, xbig, 0.0).unsqueeze(0)
    vbig = torch.randint(0, 2**20, (big,), dtype=torch.int32, device=dev, generator=gbig)
    wbig = ops.pack_bits(vbig, 20)

    def hbm_ms(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    wt = {}  # name -> (ms, plain_ms, bound_ms, library_ms) at the path's shape; and at 2**20
    wt["sparse_streams"] = (timed(lambda: kenc.sparse_streams(Q, "fp32")),
                            timed(lambda: ref.sparse_streams_ref(Q, 0)),
                            hbm_ms(Q.numel() * 16), None)
    wt["dense_bits"] = (timed(lambda: kenc.dense_bits(x_new, "fp32")),
                        timed(lambda: ref.dense_bits_ref(x_new, 0)),
                        hbm_ms(D * 8),
                        timed(lambda: x_new.to(torch.float16).view(torch.int16)))
    wt["pack_bits"] = (timed(lambda: ops.pack_bits(idx_stream, iw)),
                       timed(lambda: ref.pack_bits_ref(idx_stream, iw)),
                       hbm_ms(idx_stream.numel() * 4 + idx_words.numel() * 4), None)
    wt["unpack_bits"] = (timed(lambda: ops.unpack_bits(idx_words, iw, D)),
                         timed(lambda: ref.unpack_bits_ref(idx_words, iw, D)),
                         hbm_ms(idx_words.numel() * 4 + idx_stream.numel() * 4), None)
    wt_big = {
        "sparse_streams": (timed(lambda: kenc.sparse_streams(Xbig, "fp32")),
                           hbm_ms(big * 16)),
        "dense_bits": (timed(lambda: kenc.dense_bits(xbig, "fp32")), hbm_ms(big * 8)),
        "pack_bits": (timed(lambda: ops.pack_bits(vbig, 20)),
                      hbm_ms(big * 4 + wbig.numel() * 4)),
        "unpack_bits": (timed(lambda: ops.unpack_bits(wbig, 20, big)),
                        hbm_ms(big * 4 + wbig.numel() * 4)),
    }
    fp16_ms = timed(lambda: kenc.dense_bits(x_new, "fp16"))
    rounds_ind = T
    for name, (ms_, plain_, bound_, lib_) in wt.items():
        per_round = run_launches["marina_ind_polyak"].get(name, 0) / rounds_ind
        log(f"(i) {name:14s} path shape: {ms_:.5f} ms (plain {plain_:.5f}, bound {bound_:.2e}"
            f"{'' if lib_ is None else f', x.to(float16).view(int16) {lib_:.5f}'}); "
            f"2**20: {wt_big[name][0]:.5f} ms (bound {wt_big[name][1]:.5f}); "
            f"launches/round in MARINA-P ind {per_round:g}")
    log(f"(i) dense_bits fp16 at the path shape: {fp16_ms:.5f} ms")

    def host_ms(fn, reps=30):
        """Median ms of one call on the host clock, ended by a sync of the card."""
        return kernel_bench.median_ms(fn, reps, device=dev)

    Qh, xh, Xbig_h = Q.cpu().numpy(), x_new.cpu().numpy(), Xbig[0].cpu().numpy()
    codec = {
        "sparse 1 row": (host_ms(lambda: kenc.sparse_encode(Q[0])), host_ms(lambda: wire.encode_sparse(Qh[0]))),
        "sparse 10 rows": (host_ms(lambda: kenc.encode_rows(Q)),
                           host_ms(lambda: [wire.encode_sparse(q) for q in Qh])),
        "dense 1000": (host_ms(lambda: kenc.dense_encode(x_new)), host_ms(lambda: wire.encode_dense(xh))),
        "sparse 2**20": (host_ms(lambda: kenc.sparse_encode(Xbig[0]), reps=10),
                         host_ms(lambda: wire.encode_sparse(Xbig_h), reps=10)),
    }
    for name, (dev_ms, host_ms_) in codec.items():
        log(f"(i) encode {name:14s}: device path {dev_ms:.4f} ms (host clock, incl. the copy to the host), "
            f"host codec {host_ms_:.4f} ms")

    us_round = {"device": [], "host": []}
    for enc in ("device", "host", "host", "device", "device", "host"):
        t0 = time.perf_counter()
        h = marina_p.run(prob, mode="ind", k=k, p=p, stepsize=stepsizes.MarinaPPolyak(omega=omegas["ind"], p=p),
                         T=200, seed=0, measure_wire=True, device_encode=enc == "device")
        torch.cuda.synchronize()
        us_round[enc].append((time.perf_counter() - t0) / h["ledger"].rounds * 1e6)
    t0 = time.perf_counter()
    marina_p.run(prob, mode="ind", k=k, p=p, stepsize=stepsizes.MarinaPPolyak(omega=omegas["ind"], p=p),
                 T=200, seed=0)
    torch.cuda.synchronize()
    us_plain = (time.perf_counter() - t0) / 200 * 1e6
    log(f"(i) MARINA-P ind Polyak d={D} n={N}, T=200, us/round with measure_wire (3 runs each, in turns): "
        f"device encode {us_round['device']}, host encode {us_round['host']}; "
        f"without measure_wire {us_plain:.1f}")

    # --- (j) the encode- and kernel-benchmark kernels against their plain versions ------------
    mark("(j)")
    t_j = time.perf_counter()
    bench_err, n_cases = bench_kernels_vs_plain(np, torch, dev)
    log(f"(j) bernk, rotk_apply, rotk_apply_rows, mask_streams, topk_streams: {n_cases} cases bit-equal "
        f"to their plain versions, IEEE corners, misaligned offsets and odd sizes included "
        f"({time.perf_counter() - t_j:.1f} s)")

    # --- (k) their path: wire_bench's codec and encode sections, kernel_bench --------------------
    mark("(k)")
    t_k = time.perf_counter()
    runtime.reset_launches()
    thr_rows = wire_bench.throughput_rows(device=dev)
    roof_rows = wire_bench.encode_roofline_rows(device=dev)
    enc_rows = wire_bench.bench_encode(device=dev)
    kb_rows = kernel_bench.bench(dev)
    torch.cuda.synchronize()
    bench_launches = {kname: runtime.LAUNCHES.get(kname, 0) for kname in BENCH_KERNELS}
    log(f"(k) launches on the encode/kernel benchmark path: {bench_launches} "
        f"(all: {dict(runtime.LAUNCHES)}; {time.perf_counter() - t_k:.1f} s)")
    for kname in BENCH_KERNELS:
        if bench_launches[kname] <= 0:
            fail(f"(k) the encode/kernel benchmark path never launched {kname}")
    for name, gbs, nbytes in thr_rows + roof_rows:
        log(f"(k) {name:32s} {gbs:9.3f} GB/s ({nbytes} wire bytes)")
    for name, us, derived in enc_rows:
        log(f"(k) {name:32s} {us:10.1f} us {derived:.4f}")
    for name, ms_, size in kb_rows:
        log(f"(k) {name:32s} {ms_:10.5f} ms (size {size}; CUDA events, L2 flushed)")
    if enc_rows[-1][0] != "encode/byte_identical" or enc_rows[-1][2] != 1.0:
        fail(f"(k) encode/byte_identical = {enc_rows[-1][2]}: a fused buffer differs from the host codec's")
    n_bufs = fused_encode_buffers(np, torch, dev)
    # magnitudes 1e-30..1e30: outputs span most exponents and stay normal (the NATURAL codec
    # carries sign and exponent only, so a subnormal output would decode to 0 in any port)
    rng_n = np.random.default_rng(19)
    nat_np = (rng_n.standard_normal(2**16) * 10.0 ** rng_n.integers(-30, 30, 2**16)).astype(np.float32)
    nat_np[:5] = [0.0, -0.0, np.inf, -np.inf, np.nan]
    nat_x = torch.from_numpy(nat_np).to(dev)
    nat = C.NaturalCompression()(nat_x, C.NaturalCompression().draw(2**16, torch.Generator().manual_seed(0), dev))
    nat_h = nat.cpu().numpy()
    if not np.array_equal(wire.decode(wire.encode_natural(nat_h)).view(np.uint32), nat_h.view(np.uint32)):
        fail("(k) NaturalCompression on the card: an output is not an exact power of two")
    log(f"(k) byte_identical 1.0; {n_bufs} topk_encode / mask_encode / encode_per_worker buffers == host codec "
        "over ops.block_topk / ops.bernk; NaturalCompression on the card round-trips NATURAL exactly")

    # --- (l) timing of the four kernels -------------------------------------------------------
    mark("(l)")
    def bench_kernel_timings(d, names=BENCH_KERNELS):
        """{kernel: (ms, plain_ms, bound_ms, bound_by)} of ``names`` at the path's settings and size d."""
        g = torch.Generator().manual_seed(d)
        x = torch.randn(d, generator=g).to(dev)
        w = torch.randn(d, generator=g).to(dev)
        rot = torch.tensor([kernel_bench.ROTK_R], dtype=torch.int32, device=dev)
        w1 = torch.zeros(1, dtype=torch.int32, device=dev)
        kb, bk = kernel_bench.TOPK_K, kernel_bench.TOPK_BLOCK
        xp = torch.nn.functional.pad(x, (0, (-d) % bk))
        kp, seed = kernel_bench.BERNK_KEEP, kernel_bench.BERNK_SEED
        rn, rw = kernel_bench.ROTK_N, kernel_bench.ROTK_WORKER
        mkp, mseed = wire_bench.MASK_KEEP, wire_bench.MASK_SEED
        calls = {
            "bernk": (lambda: ops.bernk(x, keep_prob=kp, seed=seed),
                      lambda: ref.bernk_ref(x, keep_prob=kp, seed=seed)),
            "rotk_apply": (lambda: ops.rotk_apply(w, x, rot, n=rn, worker=rw),
                           lambda: ref.rotk_apply_ref(w, x, rot, n=rn, worker=rw)),
            "mask_streams": (lambda: kenc.mask_streams(x, w1, mkp, mseed, "fp32"),
                             lambda: ref.mask_streams_ref(x, w1, mkp, mseed, 0)),
            "topk_streams": (lambda: kenc.topk_streams(xp, kb, bk, "fp32"),
                             lambda: ref.topk_streams_ref(xp, kb, bk, 0)),
        }
        return {name: (timed(calls[name][0]), timed(calls[name][1])) + bench_bound(name, d) for name in names}

    def bench_bound(name, d):
        """(bound_ms, bound_by) of one call at size d: bytes read and written once over HBM,
        or topk_streams's one look at each value at the fp32 peak."""
        if name != "topk_streams":
            return hbm_ms({"bernk": 8 * d, "rotk_apply": 12 * d + 4, "mask_streams": 16 * d + 4}[name]), "bytes"
        dp = d + (-d) % kernel_bench.TOPK_BLOCK
        nb, ks = dp // kernel_bench.TOPK_BLOCK, min(kernel_bench.TOPK_K, kernel_bench.TOPK_BLOCK)
        by_bytes, by_ops = hbm_ms(dp * 4 + 16 * nb * ks), dp / FP32_FLOPS_PER_S * 1e3
        return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"

    # the path's shapes, d = 2**16: bernk and rotk_apply as kernel_bench timed them in (k)
    kb_ms = {name: ms_ for name, ms_, _ in kb_rows}
    st = {name: (kb_ms[f"kernels/{name}/ops"], kb_ms[f"kernels/{name}/plain"]) + bench_bound(name, kernel_bench.D)
          for name in ("bernk", "rotk_apply")}
    st.update(bench_kernel_timings(kernel_bench.D, ("mask_streams", "topk_streams")))
    st_big = bench_kernel_timings(2**20)
    for name in BENCH_KERNELS:
        ms_, plain_, bound_, by_ = st[name]
        log(f"(l) {name:13s} d=2**16: {ms_:.5f} ms (plain {plain_:.5f}, bound {bound_:.2e} by {by_}); "
            f"d=2**20: {st_big[name][0]:.5f} ms (plain {st_big[name][1]:.5f}, bound {st_big[name][2]:.5f})")
    xm = torch.randn(2**16, generator=torch.Generator().manual_seed(5)).to(dev)
    per_msg = {
        "topk d=2**16 (k=64/1024)": (
            host_ms(lambda: kenc.topk_encode(xm, k_per_block=64, block=1024)),
            host_ms(lambda: wire.encode_sparse(ops.block_topk(xm, k_per_block=64, block=1024)))),
        "mask d=2**16 (1/16)": (
            host_ms(lambda: kenc.mask_encode(xm, keep_prob=1 / 16, seed=7)),
            host_ms(lambda: wire.encode_sparse(ops.bernk(xm, keep_prob=1 / 16, seed=7)))),
        "per-worker ind 10 x 2**16 (0.1)": (
            host_ms(lambda: kenc.encode_per_worker(xm, n_workers=10, keep_prob=0.1, seed=7), reps=10),
            host_ms(lambda: [wire.encode_sparse(ops.bernk(xm, keep_prob=0.1, seed=7, worker=i))
                             for i in range(10)], reps=10)),
    }
    for name, (dev_ms, host_ms_) in per_msg.items():
        log(f"(l) encode {name:32s}: fused device path {dev_ms:.4f} ms, host codec over the op "
            f"{host_ms_:.4f} ms (host clock, each incl. its copy to the host)")

    # --- (m)-(o): tracing, the lossy transport and the client fleet -----------------------
    mark("(m)-(o)")
    runtime.reset_launches()
    u0 = dryrun_start()  # host work only: on the idle cores from here to (u)
    sigma = sigma_start()  # and (v3)'s
    t_m = time.perf_counter()
    trace_us = tracing_phase(np, torch, dev, prob, T=50)
    t_n = time.perf_counter()
    transport_us = transport_phase(np, torch, dev, prob, prob_cpu, T=60)
    t_o = time.perf_counter()
    fleet_us = fleet_phase(np, torch, dev, D, T=2, population=50_000, cohort=16)
    part_us = participation_phase(np, torch, dev, prob, prob_cpu, T=40)
    torch.cuda.synchronize()
    slice_launches = dict(runtime.LAUNCHES)
    t_end = time.perf_counter()
    log(f"(m)-(o) launches on the tracing / transport / fleet paths: {slice_launches}; phases took "
        f"{t_n - t_m:.1f} / {t_o - t_n:.1f} / {t_end - t_o:.1f} s")
    for kname in SLICE_KERNELS:
        if slice_launches.get(kname, 0) <= 0:
            fail(f"(m)-(o) the tracing / transport / fleet paths never launched {kname}")
    for name, (traced, plain) in trace_us.items():
        log(f"(m) us/round {name} d={D} n={N}: traced {traced:.1f}, untraced {plain:.1f} ({card})")
    for name, us in transport_us.items():
        log(f"(n) us/round {name} d={D} n={N} through CHAOS_SPEC: {us:.1f} ({card})")
    for name, (us, host_ms) in fleet_us.items():
        log(f"(o) us/round fleet_run {name} d={D} cohort 16: {us:.1f}, cohort matrices {host_ms:.2f} ms "
            f"of it ({card})")
    log(f"(o) us/round marina_p with BernoulliStragglerPlan d={D} n={N}: {part_us:.1f} ({card})")

    # --- (p) the repairs on the card: rotk_apply in fp16 and bf16 --------------------------
    mark("(p)")
    t_p = time.perf_counter()
    rotk16_err, n16, rotk16_ms = rotk16_phase(np, torch, dev, timed)
    for kname, e in rotk16_err.items():
        bench_err[kname] = max(bench_err[kname], e)
    log(f"(p) rotk_apply and rotk_apply_rows fp16/bf16: {n16} cases bit-equal to the plain versions, IEEE "
        f"corners, a negative rotation, misaligned offsets and odd sizes included "
        f"({time.perf_counter() - t_p:.1f} s)")
    for name, (ms_, plain_, bound_) in rotk16_ms.items():
        log(f"(p) rotk_apply {name} d=2**16 n=16: {ms_:.5f} ms (plain {plain_:.5f}, bound {bound_:.2e} "
            f"by bytes; f32 {st['rotk_apply'][0]:.5f}) ({card})")

    # --- (q)-(r) the SPMD runner and the benchmark harness ------------------------------------
    mark("(q)-(r)")
    runtime.reset_launches()
    t_q = time.perf_counter()
    prob100, datagen_s, spmd_err, spmd_us = spmd_phase(np, torch, dev, T=50, datagen=datagen)
    sigma100 = prob100.sigma_A
    t_r = time.perf_counter()
    walls = harness_phase(np, torch, dev, prob100, datagen_s)
    torch.cuda.synchronize()
    harness_launches = dict(runtime.LAUNCHES)
    t_end = time.perf_counter()
    log(f"(q)-(r) launches on the SPMD and harness paths: {harness_launches}; (q) {t_r - t_q:.1f} s "
        f"(datagen n=100 {datagen_s:.1f} s), (r) {t_end - t_r:.1f} s")
    for kname in HARNESS_KERNELS:
        if harness_launches.get(kname, 0) <= 0:
            fail(f"(q)-(r) the SPMD / harness paths never launched {kname}")
    log(f"(q) d=1000 n=100, one NCCL rank: SPMD vs single process max |diff| {spmd_err:.3e} over 50 rounds "
        "of MARINA-P same/ind/perm and 50 teacher-forced EF21-P steps")
    reduce_us = spmd_us.pop("all_reduce_uplink")[0]
    for name, (spmd_, single_) in spmd_us.items():
        log(f"(q) us/round {name} d=1000 n=100: SPMD {spmd_:.1f}, single process {single_:.1f} ({card})")
    log(f"(q) one NCCL all_reduce of the uplink's 1002 floats, world size 1, each followed by a sync: "
        f"{reduce_us:.1f} us ({card})")
    for suite, wall in walls.items():
        log(f"(r) wall {suite}: {wall:.2f} s ({card})")

    # --- (s) the LM serving path ------------------------------------------------------------
    mark("(s)")
    from repro_torch.models.layers import set_reference_precision

    set_reference_precision()
    t_msg = time.perf_counter()
    msgs = delta_messages(np, torch, dev, card)  # the sender's side, not counted
    runtime.reset_launches()
    t_s1 = time.perf_counter()
    serve_smoke_phase(np, torch, dev)
    t_s2 = time.perf_counter()
    eng, params, _ = serve_full_phase(np, torch, dev, card, timed)
    torch.cuda.empty_cache()
    t_s3 = time.perf_counter()
    delta = delta_phase(np, torch, dev, eng, params, msgs, card)
    del eng, params
    torch.cuda.empty_cache()
    t_s4 = time.perf_counter()
    serve_suite_phase(np, torch, dev, card)
    torch.cuda.synchronize()
    serve_launches = dict(runtime.LAUNCHES)
    t_end = time.perf_counter()
    log(f"(s) launches on the serving path: {serve_launches}; (s3)'s messages {t_s1 - t_msg:.1f} s, "
        f"(s1) {t_s2 - t_s1:.1f} s, (s2) {t_s3 - t_s2:.1f} s, (s3) {t_s4 - t_s3:.1f} s, (s4) "
        f"{t_end - t_s4:.1f} s")
    for kname in SERVE_KERNELS:
        if serve_launches.get(kname, 0) <= 0:
            fail(f"(s) the serving path never launched {kname}")
    unpack = unpack_timing(np, torch, dev, msgs["buf"], msgs["d"], timed, card)
    del msgs
    torch.cuda.empty_cache()

    # --- (t) the LM training path ----------------------------------------------------------
    mark("(t)")
    from repro_torch.models import lm as lm_
    from repro_torch.models import params as params_
    from repro_torch.train_lm import model_100m

    # (w2)'s smoke-width groups (12 processes, ~0.1 GiB of the card a rank) on the host's idle cores from here
    w2_early = gloo_card_start(("act+moe", "hier"), nice=19)
    t_t0 = time.perf_counter()
    train_err = train_kernels_vs_plain(np, torch, dev, params_.leaf_sizes(lm_.lm_spec(model_100m())))
    runtime.reset_launches()
    t_t1 = time.perf_counter()
    smoke_diff = train_smoke_phase(np, torch, dev)
    t_t2 = time.perf_counter()
    full, bf16_launches, pair, sizes = train_full_phase(np, torch, dev, card)
    t_t3 = time.perf_counter()
    wire_cases = train_wire_phase(np, torch, dev, sizes, pair, card)
    t_t4 = time.perf_counter()
    train_loop_ms = train_transport_phase(np, torch, dev, card)
    torch.cuda.synchronize()
    train_launches = dict(runtime.LAUNCHES)
    t_end = time.perf_counter()
    log(f"(t) launches on the training path: {train_launches} (rotk_apply_rows bf16: {bf16_launches}); "
        f"(t0) {t_t1 - t_t0:.1f} s, (t1) {t_t2 - t_t1:.1f} s, (t2) {t_t3 - t_t2:.1f} s, "
        f"(t3) {t_t4 - t_t3:.1f} s, (t4) {t_end - t_t4:.1f} s")
    for kname in TRAIN_KERNELS:
        if train_launches.get(kname, 0) <= 0:
            fail(f"(t) the training path never launched {kname}")
    if bf16_launches <= 0:
        fail("(t) the bf16 replicas never launched the bf16 rotk_apply_rows")
    if train_launches.get("rotk_apply", 0):
        fail(f"(t) the training path launched the one-row rotk_apply {train_launches['rotk_apply']} times: "
             "the perm downlink updates a leaf's replicas with one rotk_apply_rows")
    log(f"(t1) all ten smoke configs: card vs CPU loss within {smoke_diff:.2e} "
        f"(tolerance {TRAIN_DEV_LOSS_ATOL})")
    train_wire_buffers(np, torch, dev, sizes, pair, wire_cases)
    del pair, wire_cases
    torch.cuda.empty_cache()
    t_tk = time.perf_counter()
    w2_wait = gloo_card_wait(w2_early)  # the card free of (w2)'s smoke-width groups for the kernels' times
    train_times = train_kernel_timing(np, torch, dev, timed, max(sizes), card)
    rounds = downlink_round_timing(np, torch, dev, flush_buf, sizes, card)
    log(f"(t) waited {w2_wait:.1f} s for (w2)'s smoke-width groups; kernel and downlink timings "
        f"{time.perf_counter() - t_tk - w2_wait:.1f} s; (t) took "
        f"{time.perf_counter() - t_t0:.1f} s")

    # --- (u) the dry-run and the measured roofline share -------------------------------
    mark("(u)")
    t_u0 = time.perf_counter()
    recs, u0_s = dryrun_phase(u0, card)
    runtime.reset_launches()
    t_u1 = time.perf_counter()
    measured = measured_phase(np, torch, dev, recs, card)
    torch.cuda.synchronize()
    u_launches = dict(runtime.LAUNCHES)
    t_u2 = time.perf_counter()
    for kname in DRYRUN_KERNELS:
        if u_launches.get(kname, 0) <= 0:
            fail(f"(u1) the measured train step never launched {kname}")
    from repro_torch import configs
    from repro_torch.launch.dryrun import REPS, WARMUP

    want_rows = len(params_.leaf_sizes(lm_.lm_spec(configs.get(MEASURED_ARCH)))) * (WARMUP + REPS)
    if u_launches.get("rotk_apply_rows", 0) != want_rows:
        fail(f"(u1) {u_launches.get('rotk_apply_rows', 0)} rotk_apply_rows launches, expected {want_rows} "
             f"(one a leaf in each of {WARMUP + REPS} compressed train steps)")
    roofline_suite_phase(card)
    log(f"(u) launches on the measured path: {u_launches}; (u0) {u0_s:.1f} s, (u1) {t_u2 - t_u1:.1f} s, "
        f"(u2) {time.perf_counter() - t_u2:.1f} s; (u) took {time.perf_counter() - t_u0:.1f} s ({card})")

    # --- (x) the serving step across a process group (its 4 gloo processes run beside (v)) ------
    mark("(x)")
    t_x0 = time.perf_counter()
    x3 = serve_dryrun_start()  # on the host's cores beside (x1) and (x2)
    runtime.reset_launches()
    x1_s = serve_sharded_phase(np, torch, dev, card)  # alone on the card: its ms are timed
    x1_rec_s = {arch: serve_sharded_phase(np, torch, dev, card, arch) for arch in RECURRENT_ARCHS}
    moe_dir = tempfile.mkdtemp(prefix="moe_serve_")
    moe_files, x1_moe_s = moe_serve_phase(np, torch, dev, card, moe_dir)
    torch.cuda.synchronize()
    x_launches = dict(runtime.LAUNCHES)
    x2 = gloo_serve_start(moe_files)  # (v) holds little of the card; its launches are its own process's

    # --- (v) the paper's grid, the wire smoke and sigma_A ----------------------------------
    mark("(v)")
    runtime.reset_launches()
    grid_s = grid_phase(np, torch, dev, card)
    torch.cuda.synchronize()
    grid_launches = dict(runtime.LAUNCHES)
    runtime.reset_launches()
    smoke_s = wire_smoke_phase()
    torch.cuda.synchronize()
    smoke_launches = dict(runtime.LAUNCHES)
    for what, got_launches, want in (("(v1) the grid", grid_launches, GRID_KERNELS),
                                     ("(v2) wire_bench --smoke", smoke_launches, WIRE_SMOKE_KERNELS)):
        for kname in want:
            if got_launches.get(kname, 0) <= 0:
                fail(f"{what} never launched {kname}")
    sigma_s = sigma_phase(sigma, sigma100)
    log(f"(v) launches: (v1) {grid_launches}, (v2) {smoke_launches}; (v1) {grid_s:.1f} s, (v2) {smoke_s:.1f} s, "
        f"(v3) {sigma_s:.1f} s, beside (x2)'s 4 processes ({card})")

    # --- (w1) the LM train step across a process group as one NCCL rank, also beside (x2)'s processes
    mark("(w1)")
    # (their launches are their own processes'; its ms a step are taken in turns with the single process)
    t_w0 = time.perf_counter()
    runtime.reset_launches()
    w_launches = sharded_phase(np, torch, dev, card)
    torch.cuda.synchronize()
    for kname in SHARDED_KERNELS:
        if w_launches.get(kname, 0) <= 0:
            fail(f"(w1) the sharded train steps never launched {kname}")
    w1_s = time.perf_counter() - t_w0

    serve_refusal, x2_s = gloo_serve_phase(x2, card)
    shutil.rmtree(moe_dir, ignore_errors=True)
    serve_dryrun_phase(x3, card)
    log(f"(x) launches of the sharded serving steps (x1): {x_launches} (no hand kernel is on this path); (x1) "
        f"{x1_s:.1f} s, (x1) {MOE_ARCH} {x1_moe_s:.1f} s, (x1) "
        + ", ".join(f"{a} {t:.1f} s" for a, t in x1_rec_s.items()) + f", (x2) {x2_s:.1f} s"
        f"{' (gloo refused CUDA tensors)' if serve_refusal else ''}; (x) took "
        f"{time.perf_counter() - t_x0:.1f} s, (v) and (w1) beside (x2) included; the script so far "
        f"{time.perf_counter() - T_START:.1f} s ({card})")

    # --- (w) the rest: (w0) once the card is free of (x2)'s processes (its kernel times), then (w2), (w3) ------
    mark("(w)")
    t_w1 = time.perf_counter()
    # (w0) the block map against its plain version, after (w1)'s counts were read: not the path's launches
    block_err, block_cases, block_ms, block_at = rotk_block_phase(np, torch, dev, timed, card)
    w3 = sharded_dryrun_start()  # on the host's cores beside (w2)
    gloo_refusal, w2_s, tp_launches, tp_topk = gloo_card_phase({**w2_early, **gloo_card_start(("data+tp",))}, card)
    sharded_dryrun_phase(w3, card, recs)
    log(f"(w) launches of the sharded steps: {w_launches}; (w1) {w1_s:.1f} s (beside (x2)), (w2) {w2_s:.1f} s"
        f"{' (gloo refused CUDA tensors)' if gloo_refusal else ''}; (w0), (w2) and (w3) took "
        f"{time.perf_counter() - t_w1:.1f} s ({card})")

    mark("the summary")
    summary = {"kernels": [
        {"name": "l1_subgrad", "route": "cuda", "source": "src/repro_torch/csrc/l1_subgrad.cu",
         "replaces": "src/repro/kernels/l1_subgrad.py:46", "launches": launches["l1_subgrad"],
         "max_abs_err": l1_err, "ms": l1_ms, "plain_ms": l1_plain_ms, "bound_ms": l1_bound,
         "bound_by": "bytes" if l1_bytes / HBM_BYTES_PER_S >= l1_flops / FP32_FLOPS_PER_S else "operations",
         "library_ms": None},
        {"name": "block_topk", "route": "cuda", "source": "src/repro_torch/csrc/topk.cu",
         "replaces": "src/repro/kernels/topk.py:55", "launches": launches["block_topk"],
         "max_abs_err": topk_err, "ms": tk_ms, "plain_ms": tk_plain_ms, "bound_ms": tk_bound,
         "bound_by": "bytes" if tk_bytes / HBM_BYTES_PER_S >= tk_ops / FP32_FLOPS_PER_S else "operations",
         "library_ms": tk_lib_ms},
    ]}
    for name, src, replaces in (
        ("pack_bits", "pack.cu", "pack.py:88"), ("unpack_bits", "pack.cu", "pack.py:107"),
        ("sparse_streams", "encode.cu", "encode.py:265"), ("dense_bits", "encode.cu", "encode.py:328"),
    ):
        ms_, plain_, bound_, lib_ = wt[name]
        summary["kernels"].append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": wire_launches[name],
            "max_abs_err": wire_err[name], "ms": ms_, "plain_ms": plain_, "bound_ms": bound_,
            "bound_by": "bytes", "library_ms": lib_})
    for name, src, replaces in (
        ("bernk", "randk.cu", "randk.py:54"), ("rotk_apply", "permk.cu", "permk.py:39"),
        ("mask_streams", "encode.cu", "encode.py:287"), ("topk_streams", "encode.cu", "encode.py:311"),
    ):
        ms_, plain_, bound_, by_ = st[name]
        summary["kernels"].append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": bench_launches[name],
            "max_abs_err": bench_err[name], "ms": ms_, "plain_ms": plain_, "bound_ms": bound_,
            "bound_by": by_, "library_ms": None})
    ms_, plain_, bound_, _ = train_times["rotk_apply_rows/float32"]
    summary["kernels"].append({  # the perm downlink's path, (t): launches from the loop below
        "name": "rotk_apply_rows", "route": "cuda", "source": "src/repro_torch/csrc/permk.cu",
        "replaces": "src/repro/kernels/permk.py:39", "launches": 0, "max_abs_err": bench_err["rotk_apply_rows"],
        "ms": ms_, "plain_ms": plain_, "bound_ms": bound_, "bound_by": "bytes", "library_ms": None})
    for row in summary["kernels"]:  # the later slices' paths launched these kernels too
        row["launches"] += (slice_launches.get(row["name"], 0) + harness_launches.get(row["name"], 0)
                            + serve_launches.get(row["name"], 0) + train_launches.get(row["name"], 0)
                            + u_launches.get(row["name"], 0) + grid_launches.get(row["name"], 0)
                            + smoke_launches.get(row["name"], 0) + w_launches.get(row["name"], 0)
                            + x_launches.get(row["name"], 0))
        # (w1) the sharded train steps (one NCCL rank): their launches
        row["sharded_path"] = {"launches": w_launches.get(row["name"], 0)}
        # (x1) the sharded serving steps (one NCCL rank): their launches
        row["serve_sharded_path"] = {"launches": x_launches.get(row["name"], 0)}
        # the dry-run's measured steps (u1): their launches
        row["dryrun_path"] = {"launches": u_launches.get(row["name"], 0)}
        # (v1) the paper's reduced grid, (v2) wire_bench --smoke: their launches
        row["grid_path"] = {"launches": grid_launches.get(row["name"], 0)}
        row["wire_smoke_path"] = {"launches": smoke_launches.get(row["name"], 0)}
        # the training path (t): its launches, and the time at its largest leaf
        row["train_path"] = {"launches": train_launches.get(row["name"], 0)}
        if row["name"] in train_err:
            row["max_abs_err"] = max(row["max_abs_err"], train_err[row["name"]])
        if row["name"] == "block_topk":
            ms_, plain_, bound_, lib_ = train_times["block_topk"]
            row["train_path"].update(values=max(sizes), k_per_block=128, block=1024, ms=ms_,
                                     plain_ms=plain_, bound_ms=bound_, library_ms=lib_)
            # (w2)'s tensor-parallel EF21-P cases: each of its 4 gloo processes counts its own launches
            row["sharded_tp_path"] = {"w2_launches_by_rank": tp_topk}
        if row["name"] == "unpack_bits":
            # the serving path's decode: (s)'s launches (all from the replica's
            # delta_sync), and the kernel at (s3)'s three streams of a 10**6-entry
            # SPARSE delta over d = 999,812,736
            row["serve_path"] = {
                "launches": serve_launches["unpack_bits"],
                "delta_sync_launches": delta["launches"].get("unpack_bits", 0),
                "by_width": {str(w): {"count": DELTA_NNZ, "ms": ms_, "bound_ms": bound_}
                             for w, (ms_, bound_) in unpack.items()}}
        if row["name"] == "rotk_apply":
            # max_abs_err covers all three dtypes; the row's ms, plain_ms and bound_ms are
            # float32's at kernel_bench's d = 2**16, the 16-bit ones timed in (p); every
            # launch is float32's (kernel_bench); the training path runs rotk_apply_rows
            row["dtypes"] = ["float32", "float16", "bfloat16"]
            row["by_dtype"] = {"float32": {k: row[k] for k in ("ms", "plain_ms", "bound_ms")}}
            row["by_dtype"]["float32"]["launches"] = row["launches"]
            for name, (ms_, plain_, bound_) in rotk16_ms.items():
                row["by_dtype"][name] = {"ms": ms_, "plain_ms": plain_, "bound_ms": bound_, "launches": 0}
            for dt in ("float32", "float16", "bfloat16"):  # at the training path's largest leaf
                ms_, plain_, bound_, _ = train_times[f"rotk_apply/{dt}"]
                row["train_path"][dt] = {"values": max(sizes), "n": TRAIN_W, "ms": ms_,
                                         "plain_ms": plain_, "bound_ms": bound_}
        if row["name"] == "rotk_apply_rows":
            # the row's numbers: 4 f32 rows of the largest leaf (the perm downlink's call);
            # bf16 replicas beside them, the per-worker path it replaced, and a whole round
            row["max_abs_err"] = max(row["max_abs_err"], block_err)
            # (w0) the block map (the perm downlink on a rank's blocks under tensor parallelism over
            # "model"): its checks and times; its launches are the tensor-parallel perm cases' of (w2),
            # each of its 4 gloo processes counting its own
            # and the two-level map (a block cut over "data" and "model", the hierarchical mesh's): its
            # times at a block of as many values, its launches those of (w2)'s hierarchical perm case
            row["block_map"] = {"cases": block_cases, "max_abs_err": block_err, "w2_launches_by_rank": tp_launches}
            for level in ("one", "two"):
                shape, bmap, size = block_at[level]
                row["block_map"][f"{level}_level"] = {
                    "leaf": shape, "map": bmap, "values": size,
                    "by_dtype": {dt: {"rows": 4, "n": 4, "ms": ms_, "plain_ms": plain_, "bound_ms": bound_,
                                      "contiguous_ms": contig_}
                                 for (lv, dt), (ms_, plain_, bound_, contig_) in block_ms.items() if lv == level}}
            hier_key = f"{HIER[0][0]} {HIER[0][1]} {tuple(HIER[0][7])}"
            row["block_map"]["two_level"]["w2_launches_by_rank"] = {hier_key: tp_launches.get(hier_key)}
            row["dtypes"] = ["float32", "float16", "bfloat16"]
            row["by_dtype"] = {}
            w_rows = w_launches.get("rotk_apply_rows", 0)  # (w1)'s perm runs bf16 replicas
            for dt in ("float32", "bfloat16"):
                ms_, plain_, bound_, _ = train_times[f"rotk_apply_rows/{dt}"]
                row["by_dtype"][dt] = {
                    "rows": TRAIN_W, "values": max(sizes), "n": TRAIN_W, "ms": ms_, "plain_ms": plain_,
                    "bound_ms": bound_, "per_worker_ms": train_times[f"per-worker rotk_apply + copy/{dt}"][0],
                    "launches": (bf16_launches + u_launches.get("rotk_apply_rows", 0) + w_rows if dt == "bfloat16"
                                 else row["launches"] - bf16_launches - u_launches.get("rotk_apply_rows", 0)
                                 - w_rows),
                    "downlink_round": {path: {"device_ms": dev_ms, "host_ms": wall_ms, "launches": ln}
                                       for path, (dev_ms, wall_ms, ln) in rounds[dt].items()}}
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
