#!/usr/bin/env python3
"""Drive photon_tpu_torch's serving, training and federated paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

0. preflight: photon-lint (``python -m photon_tpu_torch.analysis``) over
   ``photon_tpu_torch/`` against its baseline, beside the builds of phase
   1 and read before anything runs on the card; a finding or a stale
   baseline entry fails the smoke;
1. environment: the card's name and power limit, torch/CUDA versions, and
   the build of every kernel from ``photon_tpu_torch/ops/csrc/`` (one
   nvcc per source, all started together, ``sm_90a``) and of the native
   host helpers (``photon_tpu_torch/native``, g++, beside the nvcc runs:
   the smoke fails without them, and checks them against numpy and zlib
   and times a 1 GiB ``parallel_memcpy`` against ``np.copyto`` and the shm
   plane's thread pool); ptxas's registers,
   shared memory and spills per kernel, and the count of ``HGMMA``
   (wgmma), ``UTMALDG`` (TMA loads), ``LDGSTS`` (cp.async) and ``HMMA``
   (mma.sync) in each kernel's SASS (``cuobjdump``): the bf16 K1, K2 and
   K3 must each hold ``HGMMA`` and ``UTMALDG``, K4's verify and chunk
   kernels ``HMMA`` and ``LDGSTS``; ptxas's notes of wgmma it had to
   serialize;
2. kernels: each kernel against its plain PyTorch version on the card,
   fp32 and bf16, at the shapes the serving step (K4: decode, chunk and
   speculative verify) and the training step (K1 forward, K2 dQ, K3
   dK/dV) give it; times of the kernel, the
   plain version and one PyTorch library call, and the least time the
   card could take (bytes over 3.35 TB/s, flops over the peak for the
   dtype); K2, K3 and K4 give the same bits twice; K4's decode must run
   as a split-K kernel and its merge, its bf16 verify as the verify
   kernel and the same merge (kernel names from ``torch.profiler``); K2 +
   K3 together against SDPA's backward;
3. training: full-width mpt-125m (random weights from seed 0, bf16
   compute, fp32 masters, ADOPT, chunked CE) in a ``Trainer`` on
   ``cuda``, global batch 32 in 2 microbatches of 16 at seq 2048: 4 steps
   on one repeated batch (step 0 applies no update, then the loss falls),
   K1/K2/K3 launched exactly ``n_layers x n_micro`` times per step,
   tokens/s, MFU, step time, peak memory and a ``torch.profiler`` step;
   one step's loss, grad norm and per-parameter gradients agree with the
   plain dense attention (``attn_impl: xla``), and a planted fault (the
   kernels' causal offset shifted by one tile, patched in from outside
   the package) must break that gate; the same gate again in bf16
   parameters at ``BF16_GATE_LAYERS`` layers (the seed's weights rounded,
   the same batch), its fault over it too;
4. entry point: ``photon_tpu_torch.centralized.main`` in process, 3 steps
   on synthetic data at full width (``ENTRY_LAYERS`` layers), then again
   to step 5, resuming from its checkpoint;
5. federated round: ``python -m photon_tpu_torch.federated`` (its
   ``main`` in this process; 2 nodes in it share the card) on the same
   config, 2 rounds of 2 clients × 4 local steps with the preset's
   nesterov strategy, the shm plane (in a directory of this run's own,
   removed after) and checkpoints, eval at rounds 0 and 2; then a resume
   to round 3. The first run must evaluate to a finite loss, each round
   must read a positive pseudo-gradient norm, the resume must train round
   3 alone, and K1–K3 must launch exactly the counts the rounds imply;
   the rounds' shm puts and loaders must have gone through the native
   library (its call counts). Per round, from the run's History: the broadcast, per client
   set_parameters / train loop / get_parameters / put, the fold, the
   server update, eval, the checkpoint, and the share of the round in
   which the card trains. In process, at ``FED_GATE_LAYERS`` layers: one
   client fit under
   ``torch.profiler`` (K1, K2, K3 each ``n_layers x n_micro`` per step),
   and one client under FedAvg (η = 1) for 2 rounds × 3 steps against a
   ``Trainer`` that ran 6 steps on the same stream; a planted fault (the
   cumulative step never injected, 2 rounds × 1 step against the
   Trainer's step 2) must read at least 10× the sound gap;
5b. federated rounds across processes, on phase 5's config: (a)
   ``--multiprocess --nodes 2`` beside phase 5's in-process rounds (2
   rounds; each node a spawned process with its own CUDA context on the
   one card, the objstore plane): round-2 parameters and the eval losses
   at rounds 0 and 2 within ``FED_GATE`` of phase 5's first run, no CUDA
   context in the server process (``nvidia-smi --query-compute-apps``
   counts the card's contexts); the round breakdown, each node's own peak
   memory and the card's; beside (b)'s checks, a planted fault (a spawned
   node that seeds its synthetic data with Python's per-process ``hash``)
   must part the round-0 eval loss over the gate. (b) at ``TCP_LAYERS``
   layers, ``--tcp-listen`` (a child
   that opens no CUDA context) with ``delta_topk_q8`` and error feedback,
   ``reset_optimizer`` on each fit, 3 rounds: node0 is ``run_node`` on a
   thread of this process, node1 a ``python -m
   photon_tpu_torch.federation.tcp --connect`` child, SIGKILLed in round
   2's fit and started again under its id. The run must finish within its
   failure budget with cid 1 retried on node0, at least one readmission,
   the uplink compressed at least 4x every round and node0's K1–K3 launches
   exact; its round-3 update (parameters minus round 0's) within
   ``UPDATE_REL_BOUND`` (relative L2) and ``UPDATE_COS_BOUND`` (cosine) of
   an uncompressed in-process run's, which a run whose server decode
   scatters the top-k values one index off must break; and in each round
   the server's decode of node0's first result (written by the server
   child) holds the per-client error-feedback identity, decoded − b =
   (t − b) + residual in − residual out in fp64 per element within fp32
   rounding, against node0's broadcast b, trained parameters t and
   residuals, which an in-process run whose server pins the previous
   round's broadcast as its delta base must break in round 2;
6. engine: full-width mpt-125m (random weights from seed 0, bf16) in a
   ``PagedEngine`` with ``attention_impl="ragged"`` and one with
   ``"gather"``, stepped through the same mixed chunked-prefill schedule:
   per-step logits and greedy tokens agree, and the kernel's launch count
   grows by ``n_layers`` per decode-only step and ``2 * n_layers`` per
   step with a prompt chunk. A third engine, whose every kernel call reads
   the trash block in place of each row's last live block, must fail the
   same logit gate (so the gate is shown to catch a dropped key block);
6b. spec_prefix: the verify grid (8 slots mid-decode at 16–1500 tokens,
   one ``mixed_chunk_step`` with ``n_spec = 4`` fed each row's own greedy
   continuation) against 4 sequential steps, per (row, column) logits
   within the engine gate and greedy tokens equal on clear margins, at
   mpt-125m's shape and at llama-1b's attention shape (GQA 16/4, D=128, 2
   layers), both through K4's verify regime; a wrapper that gives every query
   of a row the row's last position must break the gate. Then 16
   templated prompts (a 64-token block × 5 and a suffix each, 64 greedy
   tokens) through a speculative batcher (k = 4) and a plain one:
   streams equal up to a tie (a top-2 margin within twice the engine
   phase's largest logit difference), the acceptance rate and tokens/s
   of both, greedy and sampled at temperature 0.2 (tokens/s recorded, not
   gated); and through one with the prefix cache, twice: the second
   pass hits, maps blocks at refcount > 1, equals the first up to a tie,
   and nothing leaks after a flush; TTFT cold vs cached. K4 launches
   ``n_layers`` × (steps + chunk steps) in every batcher run;
7. server: ``python -m photon_tpu_torch.serve`` on an ephemeral port with
   hot-swap, the prefix cache and speculative decoding on, started with
   ``--round -1`` on a copy of the federated run's store that holds its
   rounds up to 2; 8 concurrent ``/generate`` requests (one streaming, one
   split into chunks by the prefill budget), during which round 3 is
   copied in (manifest last) and must be swapped in (``/healthz`` round
   3, one swap, every request answered); then a round 4 whose params
   object has one byte flipped must be skipped as corrupt while round 3
   serves; a repeated greedy prompt, ``/healthz``, then SIGTERM and a
   clean exit. The server's own launch count (read on ``/healthz``) must
   equal ``n_layers`` × (steps + chunk steps). The swap's latency
   (manifest landed → applied) and the device memory across it are
   recorded.

Between 6b and 7, a ``torch.profiler`` window over steady decode steps
reports the step's wall time, the device's busy time by kernel and its
idle share (1 - busy / the unprofiled step's wall time). Then:

8. decode: contiguous KV-cache decode (``models/decode.py``: ``prefill``
   with K1, ``decode_step``, ``generate``) against the ragged engine on
   the same weights, 8 prompts of 1–1500 tokens × 32 greedy steps on one
   token stream: per-row logits within the engine gate every step,
   greedy tokens equal wherever the margin is clear, ``generate`` equal
   to the engine up to each row's first unclear step; a planted fault
   (the cache written one past the cursor) must break the gate; the
   contiguous decode's tokens/s;
9. eval (after 7, before the federated phase's directory goes):
   ``python -m photon_tpu_torch.data.convert`` over the repo's markdown
   (byte-fallback, 2 clients, seq 2048), then ``python -m
   photon_tpu_torch.eval`` (each CLI's ``main`` in process) on the
   federated round with ``--dataset`` on
   that set and the v0.3 gauntlet at ``EVAL_MAX_ROWS`` rows a task: a
   finite val loss, every score in [0, 1], and K1 launched ``n_layers``
   times a forward pass. Phase 2 also holds K1 alone at the eval forward's shape
   (B=16, S=512) to its plain version.

Right after phase 2 (on a card nothing else holds yet):

10. presets: ``photon_tpu_torch.centralized.main`` in process for mpt-350m,
    mpt-760m, mpt-1b, llama-1b, mpt-3b, mpt-125m-moe8 and mpt-7b at full
    width and depth (random weights, synthetic data, 3 steps, no
    checkpoint; global batch 2 × the preset's microbatch, mpt-3b
    ``device_microbatch_size: auto`` over 8, mpt-7b in bf16 parameters
    over one microbatch of 8): step wall, tokens/s, MFU, peak memory,
    ``auto``'s choice; K1–K3 launch counts exact (K1 twice per layer per
    microbatch under remat); the step-0 loss near ln(vocab); mpt-7b's
    dtype map exact (every leaf bf16 but the norm scales, every AdamW
    moment its parameter's dtype; a bf16 norm scale must fail it) and its
    idle share from one more step under the profiler. Then the training gate of
    phase 3 at mpt-1b's width (D=128), whose planted fault must read at
    least 10× the sound value;
11. MoE: at one moe8 layer's full shapes (N = 16,384, bf16) the
    index-dispatch ``moe_mlp`` against the dense plain version: the kept
    (token, expert, position) sets equal exactly, outputs and aux within
    their gates, and capacity claimed token-major (a planted fault) must
    break the set gate; then the moe8 weights of phase 10 in a ragged and
    a gather ``PagedEngine`` on one schedule (8 prompts, 512-token chunks,
    32 greedy steps), gated on the logits in fp32 compute and recorded in
    bf16, K4 launched ``n_layers`` times a step (twice with a chunk).

After 9, on the federated run's last round:

12. adapters: per-cohort LoRA at full width (rank 8, alpha 16, ``wqkv``
    and ``out_proj``, cohorts a, b and c on a pool of 2 pages). (a) One
    adapter round in process (``AdapterTrainPlane.run_round`` over a
    ``ClientRuntime`` on the card): cohorts a and b have 2 clients each,
    4 local steps at 32 × 2048 on their own shards with the base frozen,
    K1–K3 launched exactly ``n_layers x n_micro`` per step; the base bit
    for bit unchanged, each trained cohort's B non-zero and c's zero; the
    cohorts folded (``grouped_host_fold``) and stepped, the round saved
    in the JAX layout; one fit step's A/B gradients, kernels vs the plain
    attention, within ``ADAPTER_GRAD_GATE`` and the shifted-offset fault
    over it; the fit step's time and tokens/s beside phase 3's full
    training step, the peak memory, the adapter payload beside the base's.
    (b) A ragged engine with the round's bank on one mixed batch (a, b
    and two slots without a cohort; c admitted mid-batch on a's recycled
    page): every emission within ``ENGINE_LOGIT_GATE`` of contiguous
    decode with per-row adapters, a planted fault (two slots read each
    other's adapter row) over it, the no-cohort rows equal to an
    adapter-free engine's, a replay after every cohort was evicted and
    reloaded equal to the first run; tokens/s with and without cohorts,
    kernel launches per decode step with adapters and without. (c)
    ``python -m photon_tpu_torch.serve`` on the round with the prefix
    cache and hot-swap on, while a second round trains in this process:
    every cohort and none answers (their streams equal the round's
    oracle up to a tie), an unknown cohort gets 400, ``/healthz`` shows
    the pool; one templated prompt under a, then b, then b again: b maps
    none of a's blocks and its own the second time; round 2 copied in
    under 8 requests is swapped in (base and bank) with none dropped, and
    each cohort's stream after it equals round 2's oracle up to a tie.

After 12, on the adapter run's store (kept until this phase ends):

13. fleet: three ``python -m photon_tpu_torch.serve --fleet-connect``
    replicas (``FleetSupervisor``; each its own context on the card, 8
    slots, block 16, the prefix cache on, hot-swap on) behind a
    ``FleetRouter`` in this process, on the adapter run's round 1
    (cohorts a, b, c); beside them one engine of 24 slots (``python -m
    photon_tpu_torch.serve``), and in this process a ``PagedEngine`` on
    the same round and bank. 48 greedy requests of 32 tokens from 4
    client threads, a third each templated (4 templates of 4 full
    blocks, then a suffix), under cohorts a, b, c, and shorter than a
    block. (a) Every routed stream equals the in-process engine's up to
    a tie; the router counts every templated request as ``prefix`` and
    every cohort one as ``cohort``; each template and each cohort lands
    on one replica. (b) Each replica's K4 launches (its ``/healthz``)
    equal ``n_layers`` × (steps + chunk steps). (c) Under traffic from 4
    threads the replica holding cohort a's pin is SIGKILLed: the router
    marks it dead within its liveness ladder's bound (dead after 2
    missed reports, each poll ``report_poll_s`` + ``report_timeout_s``),
    a re-pins to a survivor whose stream for a's request equals the one
    before the kill up to a tie, and every request not in flight on the
    victim at the kill answers 200. (d) Round 2 is copied in (manifest
    last) and ``rolling_hotswap`` runs under traffic from 2 threads: each
    survivor answers ``swapped`` when asked (the replicas keep the adapter
    server's 0.25 s poll, so one that swapped on its own timer fails) and
    ends on round 2, their swap windows (staged → applied, from
    ``/healthz`` sampled every 50 ms) do not overlap, and no request is
    dropped. (e) The same templated traffic under
    ``AffinityRouter(mode="random")`` must spread a template over more
    than one replica (so (a)'s affinity check can fail). Recorded: the
    fleet's tokens/s and TTFT against the 24-slot engine on the same
    requests at 4 and at 24 clients, the fleet-wide prefix hit rate under
    affinity and under random placement, the card's memory and contexts
    (``nvidia-smi`` rows) with the replicas and the single engine up,
    with the replicas alone and after the kill, each replica's device
    bytes from its own ``/healthz``, and the phase's time.

After 13, side by side (14 on a thread of this process, 15 and then 16
in their children; they share no launch counter, file or port):

14. interop: llama-1b (d2048, 22 layers, GQA 16/4 of 128, vocab 32000;
    random weights from seed 0) through ``python -m
    photon_tpu_torch.checkpoint.hf_export --format llama`` and ``python -m
    photon_tpu_torch.checkpoint.hf_import`` (children that open no CUDA
    context): the imported npz equals the original bit for bit (names,
    order, dtypes, bytes); a bf16 copy of the export, written here as two
    safetensors shards and their index, imports equal to the bf16-rounded
    original; the imported tree in a ragged engine (bf16) gives the
    original tree's 8 greedy streams of 32 tokens token for token, with K4
    launched ``n_layers`` × (steps + chunk steps), and an import with one
    layer's q_proj left untransposed parts the last-position logits over
    ``INTEROP_FAULT_BOUND``. Seconds and file sizes recorded; the files
    are deleted;
15. chaos: 3 federated rounds of full-width mpt-125m (``FED_SETS``) over
    TCP with ``photon.chaos`` on (``CHAOS_SEED``: the server drops round 1's
    ping to node1 and corrupts its FitIns; node1 crashes mid-fit in round
    2 through ``os._exit(137)`` and is started again): a ``--tcp-listen``
    server child and two ``federation.tcp`` node children. The rounds
    finish within the failure budget, node1 exits 137 exactly once, at
    least one readmission, at least one ``tcp_drop`` and one
    ``tcp_corrupt`` fired, every corrupted frame was refused by its CRC and
    never decoded, the final parameters are finite and node0's K1–K3
    launches are exact.

After 15, beside the rest of 14 (its decode passes wait for 14's end):

16. telemetry: (a) 2 federated rounds of full-width mpt-125m (2 clients ×
    2 local steps, eval at rounds 0 and 2) over TCP with
    ``photon.telemetry`` on, a ``prom_port`` and ``profile_rounds: 1``: a
    ``--tcp-listen`` server child and two ``federation.tcp`` node children.
    The merged ``trace-{run}.json`` loads and holds spans of the three
    processes; every node ``client/fit`` and ``client/evaluate`` span
    parents to the server's fit-round or eval-round span of its round in
    the same trace; the event log holds each node's membership
    transition; every ``/metrics`` scrape while the run trains passes the
    exposition check (``telemetry.prom.validate_exposition``), one counts
    ``tcp/send_bytes`` frames, and ``/statusz`` reads ok to the end; the
    round-1 ``torch.profiler`` artifact parses; node0's K1–K3 launches
    are exact; the server opens no CUDA context. (b) ``python -m
    photon_tpu_torch.serve`` with telemetry on, on (a)'s round 2 (8
    slots, block 16, budget 512): 16 greedy requests of 16–1500 tokens ×
    32 answer 200; K4 = ``n_layers`` × (steps + chunk steps) on
    ``/healthz``; the ``serve/ttft_s`` histogram counts 16 and its
    OpenMetrics exemplars carry trace ids; ``/statusz`` ok and
    ``serve/hbm_bytes_in_use`` > 0; ``serve/backend_compiles_total`` flat
    between two scrapes after warm-up; ``POST /debug/profile`` for 8 ticks
    writes a capture that parses and holds a K4 kernel record. Recorded:
    the trace's size and span count.

After 13, before 14 (in this process, on the federated run's served round
in one ragged engine with the prefix cache: 8 slots, block 16, budget 512),
and (d) in a child beside 14–16:

17. autopilot: the SLO autopilot and the runtime guards. (a) After an
    autopilot-off pass of the same requests (the warm-up and the streams
    held to), 24 greedy requests of 600–1500 tokens × 16 queue through the
    frontend at once behind the 8 slots (max_queue 32; ``queue_high_frac``
    0.5, ``queue_clear_frac`` 0.1, ``cooldown_s`` 0.2, ``prefill_budget_min``
    64, ``relax_after`` 3, ``period_s`` 0.01), then short requests trickle
    until the budget is back: a ``queue_budget`` actuation from 512, the
    lowest budget in [64, 512), relaxes back to 512, 0 rejected and every
    answer 200, streams equal up to a tie, K4 = ``n_layers`` × (steps +
    chunk steps), the frontend's ``/statusz`` holding the decisions; all
    of it under ``retrace_guard(steady=True)`` and ``lock_order_guard()``
    (0 retraces, no cycle, no tick warning); then a kernel library loaded
    afresh inside a guarded window must raise ``RetraceViolation`` billed
    to ``serve/tick``. (b) 64 templated prompts × 32 with speculation (k 4)
    and ``tpot_p50_slo_s`` at half an untimed first pass's TPOT p50:
    ``serve/spec_k_max`` steps 4 → 3 → 2 → 1 through ``tpot_spec_k``
    actuations with exactly one ``saturated``, the streams equal the plain
    ones up to a tie. (c) The prefix cache holds a templated pass; the
    device-memory ramp (``serve_hbm_ramp_frac``, every tick sampled)
    latches ``alert/hbm_growth`` and ``hbm_reclaim`` fires once, its old
    and new the free blocks, new above old; with the ramp off no alert or
    reclaim follows, and a second episode gives one more of each; no
    request fails. (d) A ``FleetRouter`` with the autopilot on (cooldown
    600 s) and two ``--fleet-connect`` replicas of phase 13's round, one
    under the ramp, traffic throughout: that replica reports its serve
    plane degraded by ``alert/hbm_growth``, the router approves one restart
    for it and none for the other, the agent recycles it and it reports
    live again, no request fails (a draining replica's 503 is placed
    again), each replica's K4 keeps to the launch rule and the router's
    ``/statusz`` holds the decision. (e) An allocation over the card's free
    memory raises ``torch.cuda.OutOfMemoryError``; ``dump_memory_profile``
    writes a snapshot that loads to a dict with segments, and
    ``ClientRuntime._error`` names it. Recorded: the decision rings, the
    budget and ``k_max`` traces, the reclaims' blocks, approval → live
    seconds and the legs' walls.

(a) and (e) in a child beside phase 5b, (c) and (d) in process in a child
beside 14-16, (b) and (c) across processes (one pair) after 14-16 on a
quiet card:

18. federated rounds over collectives (``federation/collective_round.py``
    on ``parallel/collective_agg.py``). (a) Full-width mpt-125m (12
    layers), 2 clients × 2 local steps × 2 rounds, FedAdam on the device
    plane, replica 2 on a mesh that names ``cuda:0`` four times: K1–K3
    launched ``clients × steps × n_layers × microbatches`` each round;
    round 2's parameters within rtol 1e-3 / atol 5e-5 of the driver
    topology's in-process run of the same config (``federated``'s
    ``build_app``, shm), round 1's too, and a plane that loses client 1's
    row from round 1's sum (its samples still counted) must read over that
    tolerance; the
    replicated layout (``collective_zero1: false``), a plane fed the same
    stacked deltas beside the run round for round, gives the same bits
    with twice the per-rank server state; on round 1's contributions every
    element of the q8 average (block 256) lies within Σ_c scale_c/2 of the
    ``off`` average, which a codec applying block b+1's scale to block b
    must break; an exchange escalated to q8 (``set_quantization``) reports
    ``server/collective_wire_bytes`` equal to ``modeled_cross_slice_bytes``,
    ``off`` / q8 = 4 / (1 + 4/256) within 1 %. (e) The runner registers
    both collective knobs with the autopilot. (b) At 2 layers, ``python -m
    photon_tpu_torch.federation.collective_round --num-processes 2`` as two
    children on the one card (one client each, gloo: NCCL takes no two
    ranks on one GPU) for 3 rounds: both processes' parameters after round
    2 bitwise equal and within (a)'s tolerance of an in-process run, K1–K3
    exact; backend, staged legs, contexts and each process's peak
    recorded. (c) In process at 2 layers, 3
    clients, 4 rounds of one runner: a chaos mid-fit crash in round 2
    reconfigures the cohort (one straggler, the parameters the
    survivors-only fold's bit for bit) and round 3 runs all three; under
    the autopilot the straggler rule makes ``COLL_AP_DECISION`` and no
    other; at quorum 0.9 the same crash in round 4 degrades to the host
    fold, bit for bit ``aggregate_inplace`` over the landed deltas; across
    processes, in (b)'s pair, ``crash_phase: pre-exchange`` on process 1 in
    round 3 and a 10 s stage timeout: process 1 exits 137, process 0
    degrades to the host fold and finishes the round within timeout + 5 s
    of the crash (the crash marker's mtime). (d) Async at 2 layers: the buffer the cohort at zero staleness
    equals the sync runner bit for bit; 4 clients, one slowed 4× by
    chaos's ``fit_delay``, buffer 2, max staleness 1: ``COLL_ASYNC_VERSIONS``
    versions, at least one reject, ``server/async_max_staleness``
    registered and the ``async`` plane ticked.

In a child of its own beside phase 5b (and 18 (a)):

19. model parallelism inside a client (``parallel/spmd.py``): a
    ``Trainer`` on a mesh that names ``cuda:0`` at every position against
    a single-device ``Trainer`` from the same weights (seed 0) and
    batches, 3 steps, bf16: (a) full-width, full-depth mpt-125m at seq
    4096, ``sequence=4`` (``pallas`` → ring), batch 4; (b) mpt-125m's width
    at 2 layers, seq 2048, ``fsdp=2 × tensor=2``, batch 8; (c) llama-1b's
    width at 2 layers (GQA 16/4, D=128, RoPE, remat), seq 4096, ``tensor=2
    × sequence=2``, batch 2. Each meshed step launches K1–K3 exactly as
    :func:`_mesh_launch_rule` counts (a ring of ``n`` runs ``n(n+1)/2``
    chunk kernels a layer and group: (a) 120, (b) 8, (c) 24 / 12 / 12);
    each step's loss and grad norm, and every parameter's gradient after
    step 1, within ``TRAIN_GRAD_GATE`` of the single-device run; a planted
    fault over it: (a) ring position 0's diagonal chunk at causal offset 1,
    (b) the tensor all-reduce keeping its first position's part, (c) RoPE
    positions restarting at 0 in each sequence chunk; (b) also the
    parameters after the steps within the gate and ``set_parameters`` →
    ``get_parameters`` bit for bit. K1–K3 at (a)'s ring chunks (B=4,
    S=1024, H=12, D=64) at offsets 0 and 1024 against their plain
    versions, K1 timed beside its bound and SDPA (causal, unmasked).
    Recorded: step walls, tokens/s, peak memory, and for (a) the idle
    share of a profiled step of each run. (g) an adapter fit at mpt-125m's
    full width and depth (LoRA rank 8, alpha 16 on ``wqkv``, ``out_proj``,
    ``up_proj``, ``down_proj``, the base frozen, AdamW with decay, ``auto``
    microbatches), seq 2048, batch 8, ``fsdp=2 × tensor=2``: the steps and
    the A/B gradients within the gate, tensor position 1 reading position
    0's B columns over it, the base bit-frozen on both runs (AdamW's decay
    reaching it must break that), each ``auto`` pick one JAX's rule allows,
    launches exact; the probes' candidates and seconds and (g)'s idle share
    recorded.

To keep the whole smoke within 800 s with phases 14 and 15, three earlier
paths run mpt-125m's width at 2 of its 12 layers: phase 4
(``ENTRY_LAYERS``), phase 5's in-process comparison (``FED_GATE_LAYERS``)
and phase 5b (b) (``TCP_LAYERS``: its TCP run, comparator and both
planted faults); phase 5's CLI runs keep the full depth. With phase 16
joining, phase 5's two CLI runs moved into this process (a child spends
~10 s starting) and 16 runs beside 14's end. With phase 19 joining, 5b
(a)'s two-round run moved beside phase 5's in-process rounds, and 18 (a)
and 19 run in children beside 5b.

The second-last line of stdout is the ``kernels`` JSON; the last is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this file, it exits non-zero and prints no result. Measurements
also go to ``chiprun_out/chip_smoke.json``.

``python3 chip_smoke.py --fed-1b`` runs, instead of the smoke, one round
of ``python -m photon_tpu_torch.federated --preset mpt-1b --nodes 2
--rounds 1`` (2 clients × 1 local step, no eval, no checkpoint) in a
child, and writes its peak memory and round breakdown to
``chiprun_out/fed_1b.json``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import http.client
import io
import json
import math
import os
import pathlib
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; fp32 CUDA cores
#: kernel vs plain version: fp32 differs only by summation order; bf16 is
#: the reference harness's forward gate (bench.py)
KERNEL_GATE = {"float32": 1e-5, "bfloat16": 2e-2}
#: ``torch.profiler`` can lose device records, so a profiler count short of
#: the launch counters (or a kernel name missing) is read on up to this
#: many runs; a reading above the counters fails at once. The counters
#: themselves are exact gates on every run.
PROFILER_READINGS = 3
#: ``torch.profiler`` keeps a device record only if its time, converted to
#: the host's clock, falls inside the profiled window, and that conversion
#: can place a kernel milliseconds before its own launch (the phases'
#: ``profiler_min_launch_to_kernel_us``); a kernel launched just after the
#: window opens is then dropped. So every profiled region starts and ends
#: with the card idle for this long.
PROFILER_MARGIN_S = 0.1
#: ``torch.profiler`` (torch 2.11 with CUPTI, on an H100) also drops the
#: device records of a window's first launches, and more of them the more
#: windows the process has opened; the first K1 launches of a short
#: profiled fit were among them (1–3 of 12 at 2 layers). So every window
#: opens with this many launches of ``torch.cuda._sleep``'s kernel
#: (``PROFILER_PAD_KERNEL``) before its margin; the readers never see the
#: pad's records, and each window's count of lost pad records is kept in
#: ``profiler_pad_lost``.
PROFILER_PAD = 256
PROFILER_PAD_KERNEL = "spin_kernel"
profiler_pad_lost: list[int] = []
#: engine phase: per-step relative L2 between the ragged and gather
#: engines' logits (bf16 activations through 12 layers). On an H100 the
#: sound engines read at most 1.2e-2 and an engine that drops each row's
#: last key block reads up to 1.9e-1; the gate sits ~3x from each.
ENGINE_LOGIT_GATE = 4e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def lint_preflight() -> dict:
    """photon-lint over the port before any phase (``python -m
    photon_tpu_torch.analysis``: ``photon_tpu_torch/`` against its
    baseline, as a user runs it): a finding or a stale baseline entry fails
    the smoke. Prints and returns the CLI's summary (files, findings,
    baselined, suppressed, stale) and its seconds."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "photon_tpu_torch.analysis"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    rec = {"rc": out.returncode, "summary": out.stdout.strip().splitlines()[-1:],
           "seconds": time.perf_counter() - t0}
    log(f"lint preflight: {' '.join(rec['summary'])} ({rec['seconds']:.2f} s)")
    if out.returncode != 0:
        fail(f"photon-lint preflight exited {out.returncode}:\n{out.stdout[-3000:]}"
             f"{out.stderr[-2000:]}")
    return rec


# ---------------------------------------------------------------------------
# phase 1: what the build made
# ---------------------------------------------------------------------------

SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS", "HMMA")  # wgmma, TMA loads, cp.async, mma.sync
#: the bf16 flash kernels (K1, K2, K3), each of which must be built from
#: wgmma and TMA loads
WGMMA_KERNELS = ("fwd_wgmma_kernel", "bwd_dq_wgmma_kernel", "bwd_dkv_wgmma_kernel")
#: K4's tensor-core kernels, each of which must be built from mma.sync and
#: cp.async
MMA_SYNC_KERNELS = ("rpa_verify_kernel", "rpa_chunk_kernel")


def _demangle(names: list[str]) -> dict[str, str]:
    filt = shutil.which("c++filt")
    if filt is None or not names:
        return {n: n for n in names}
    out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True)
    plain = out.stdout.splitlines()
    return dict(zip(names, plain)) if len(plain) == len(names) else {n: n for n in names}


def build_report(_build, sources) -> dict:
    """Per kernel: ptxas's registers, spills and static shared memory (from
    ``-Xptxas -v``) and the count of each of ``SASS_OPS`` in its SASS
    (``cuobjdump -sass`` of the built library). Fails unless each of
    ``WGMMA_KERNELS`` is built from wgmma and TMA loads at both head dims."""
    import re

    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        import triton  # noqa: F401  (its package carries the toolkit's binaries)

        tool = pathlib.Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
    kernels = {}
    for src in sources:
        for block in _build.build_log.get(src, "").split("Compiling entry function")[1:]:
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            smem = re.search(r"(\d+) bytes smem", block)
            kernels[block.split("'")[1]] = {
                "source": src, "registers": int(regs.group(1)) if regs else None,
                "spill_store_bytes": int(spill.group(1)) if spill else None,
                "static_smem_bytes": int(smem.group(1)) if smem else 0}
        sass = subprocess.run([str(tool), "-sass", str(_build.library_path(src))],
                              capture_output=True, text=True, check=True).stdout
        for chunk in sass.split("Function : ")[1:]:
            name = chunk.split()[0]
            counts = {op: len(re.findall(rf"\b{op}\b", chunk)) for op in SASS_OPS}
            kernels.setdefault(name, {"source": src}).update(counts)
    plain = _demangle(list(kernels))
    report = {plain[k][:120]: v for k, v in kernels.items()}
    for kernel in WGMMA_KERNELS:
        built = {k: v for k, v in report.items() if kernel in k}
        if len(built) != 2 or any(not v.get("HGMMA") or not v.get("UTMALDG")
                                  for v in built.values()):
            fail(f"{kernel} is not built from HGMMA and UTMALDG at D=64 and 128: {built}")
    for kernel in MMA_SYNC_KERNELS:
        built = {k: v for k, v in report.items() if kernel in k}
        if len(built) != 2 or any(not v.get("HMMA") or not v.get("LDGSTS")
                                  for v in built.values()):
            fail(f"{kernel} is not built from HMMA and LDGSTS at D=64 and 128: {built}")
    return report


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------

def _time_ms(torch, fn, flush, reps=15, warm=3, host=False) -> float:
    """Median over ``reps`` single launches, each after a write that
    evicts the 50 MB L2 (a serving step finds the pool cold). A ~0.5 ms
    device sleep follows the write, so the card is still busy while the
    host enqueues ``fn`` and the events time the device's work alone;
    ``host=True`` drops the sleep, and a wrapper whose host time exceeds
    the write's then adds that time too."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if not host:
            torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class _Window:
    """A profiled window's records, the pad's device records left out of
    ``key_averages()``."""

    def __init__(self, prof):
        self._prof = prof
        self._averages = None

    @property
    def profiler(self):
        return self._prof.profiler

    def _all(self):
        if self._averages is None:
            self._averages = self._prof.key_averages()
        return self._averages

    def key_averages(self) -> list:
        return [e for e in self._all() if PROFILER_PAD_KERNEL not in e.key]

    @property
    def pad_lost(self) -> int:
        return PROFILER_PAD - sum(e.count for e in self._all() if PROFILER_PAD_KERNEL in e.key
                                  and str(getattr(e, "device_type", "")).endswith("CUDA"))


@contextlib.contextmanager
def _profiled(torch):
    """``torch.profiler`` over the block, CPU + CUDA (with CUDA alone it can
    lose whole buffers of device records): the window opens with
    ``PROFILER_PAD`` pad launches, and the card is idle for
    ``PROFILER_MARGIN_S`` at both ends of the block. Yields a
    :class:`_Window`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILER_PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(PROFILER_MARGIN_S)
        window = _Window(prof)
        yield window
        torch.cuda.synchronize()
        time.sleep(PROFILER_MARGIN_S)
    profiler_pad_lost.append(window.pad_lost)


def _launch_to_kernel_us(prof) -> float | None:
    """The least time from a launch call's start to its kernel's start over
    the window, in µs; below 0 where the profiler's clocks disagree."""
    events = list(prof.profiler.kineto_results.events())
    launch = {e.correlation_id(): e.start_ns() for e in events
              if not str(e.device_type()).endswith("CUDA") and "Launch" in e.name()}
    gaps = [e.start_ns() - launch[e.correlation_id()] for e in events
            if str(e.device_type()).endswith("CUDA") and e.correlation_id() in launch]
    return min(gaps) / 1e3 if gaps else None


def _kernel_names(torch, fn) -> list[str]:
    """The device kernels one call of ``fn`` launches (``torch.profiler``;
    empty if the profiler sees no device activity)."""
    with _profiled(torch) as prof:
        fn()
    return sorted({e.key[:90] for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and (getattr(e, "self_device_time_total", 0.0) or 0.0) > 0})


def _bound(pos, n_ctx, bs, h, n_kv, d, elem):
    """Least time for this call's work: each needed byte read once, each
    output byte written once; flops only over keys the mask lets through."""
    b, t = pos.shape
    max_pos = pos.max(axis=1)
    blocks = [min(n_ctx, int(p) // bs + 1) for p in max_pos]
    kv_bytes = sum(blocks) * bs * n_kv * d * elem * 2
    io_bytes = 2 * b * t * h * d * elem + b * n_ctx * 4 + b * t * 4
    keys = (pos.clip(max=n_ctx * bs - 1) + 1).sum()
    flops = 4.0 * float(keys) * h * d
    return kv_bytes + io_bytes, flops


#: K4's cases whose bf16 calls take the verify regime (speculative verify,
#: recycled blocks under a 4-token grid)
K4_VERIFY_CASES = ("mpt125m_verify", "llama1b_verify", "recycled_shared_blocks")


def kernel_phase(torch, rpa, alibi_slopes, np):
    """Kernel vs plain version at the serving step's shapes; returns the
    per-case records and the main-path (mpt-125m, bf16) entry."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    nb, bs = 1024, 16  # the engine's auto pool for 8 slots at 2048 tokens (+ trash)
    trash = nb
    cases = [
        # name, model shape (L, H, H_kv, D), B, T, positions, alibi, main path
        ("mpt125m_decode", (12, 12, 12, 64), 8, 1,
         np.array([[2047], [1800], [1536], [1200], [1024], [700], [400], [130]]), False, True),
        ("mpt125m_chunk", (12, 12, 12, 64), 1, 512,
         np.arange(1024, 1536)[None, :], False, True),
        ("mpt125m_alibi_chunk", (12, 12, 12, 64), 1, 256,
         np.arange(600, 856)[None, :], True, False),
        # speculative verify (k = 4 drafts bucket to n_spec 8): each row's
        # [last, drafts] at consecutive positions, rows at different depths.
        # Reported in its own record, outside the main entry, which stays
        # the decode + chunk sum that earlier slices reported
        ("mpt125m_verify", (12, 12, 12, 64), 8, 8,
         np.array([2039, 1800, 1536, 1200, 1024, 700, 400, 130])[:, None] + np.arange(8),
         False, False),
        ("llama1b_decode", (22, 16, 4, 128), 8, 1,
         np.array([[2047], [1900], [1500], [1100], [900], [512], [256], [31]]), False, False),
        ("llama1b_chunk", (22, 16, 4, 128), 1, 512,
         np.arange(512, 1024)[None, :], False, False),
        # GQA 16/4 at n_spec 4: 16 rows a (slot, kv head), the bf16 verify regime
        ("llama1b_verify", (22, 16, 4, 128), 8, 4,
         np.array([2043, 1900, 1500, 1100, 900, 512, 256, 31])[:, None] + np.arange(4),
         False, False),
        ("recycled_shared_blocks", (12, 12, 12, 64), 4, 4,
         np.array([[5, 6, 7, 8], [100, 101, 102, 103], [0, 1, 2, 3], [700, 701, 702, 703]]),
         False, False),
    ]
    n_ctx = 128
    pools = {}
    records = []
    main = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "max_abs_err": 0.0, "bytes": 0, "flops": 0.0, "shapes": []}
    for name, (L, h, n_kv, d), b, t, pos_np, alibi, on_path in cases:
        if (L, n_kv, d) not in pools:
            pools.clear()
            shape = (nb + 1, L, bs, n_kv, d)
            pools[(L, n_kv, d)] = (torch.randn(shape, device=dev), torch.randn(shape, device=dev))
        kp32, vp32 = pools[(L, n_kv, d)]
        # block tables as the allocator leaves them: distinct blocks per slot
        # (or shared ones, for the recycled case), trash past each slot's end
        rows_np = np.full((b, n_ctx), trash, np.int32)
        perm = rng.permutation(nb)
        for i in range(b):
            need = min(n_ctx, int(pos_np[i].max()) // bs + 1)
            if name.startswith("recycled"):
                rows_np[i, :need] = rng.integers(0, 8, need)  # shared, reused ids
            else:
                rows_np[i, :need] = perm[i * n_ctx: i * n_ctx + need]
        rows = torch.from_numpy(rows_np).to(dev)
        pos = torch.from_numpy(pos_np.astype(np.int32)).to(dev)
        slopes = alibi_slopes(h, dev) if alibi else None
        layer = L // 2
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            kp, vp = kp32.to(dtype), vp32.to(dtype)
            q = torch.randn((b, t, h, d), device=dev, dtype=dtype)
            out = rpa.ragged_paged_attention(q, kp, vp, layer, rows, pos, slopes=slopes)
            torch.cuda.synchronize()
            kb, vb = rpa.live_view(kp, vp, layer, rows)
            ref = rpa.ragged_reference_attention(q, kb, vb, pos, slopes=slopes)
            diff = (out.float() - ref.float())
            rel = float(diff.norm() / ref.float().norm().clamp_min(1e-12))
            max_abs = float(diff.abs().max())
            if not torch.isfinite(out).all() or rel > KERNEL_GATE[dname]:
                fail(f"kernel {name} {dname}: rel L2 {rel:.3e} > {KERNEL_GATE[dname]}")
            regime = rpa.regime(t, h // n_kv, dtype)
            if dtype == torch.bfloat16 and name in K4_VERIFY_CASES and regime != "verify":
                fail(f"kernel {name} bf16 takes the {regime} regime, not verify")
            rec = {"case": name, "dtype": dname, "B": b, "T": t, "H": h, "H_kv": n_kv,
                   "Dh": d, "n_ctx": n_ctx, "block_size": bs, "rel_l2": rel,
                   "max_abs_err": max_abs, "gate": KERNEL_GATE[dname], "regime": regime,
                   "n_split": rpa.split_plan(n_ctx * bs)[0] if regime == "split" else None}
            again = rpa.ragged_paged_attention(q, kp, vp, layer, rows, pos, slopes=slopes)
            if not torch.equal(out, again):
                fail(f"kernel {name} {dname}: two launches gave different bits")
            rec["same_bits_twice"] = True
            want = {"split": ("rpa_split_kernel", "rpa_combine_kernel"),
                    "verify": ("rpa_verify_kernel", "rpa_combine_kernel"),
                    "chunk": ("rpa_chunk_kernel",)}[regime]
            for _ in range(PROFILER_READINGS):  # a missing name is read again
                names = _kernel_names(torch, lambda: rpa.ragged_paged_attention(
                    q, kp, vp, layer, rows, pos, slopes=slopes))
                if not names or all(any(w in n for n in names) for w in want):
                    break
            if names and not all(any(w in n for n in names) for w in want):
                fail(f"kernel {name} {dname}: the {regime} regime launched {names}")
            rec["device_kernels"] = names or "not measured"
            if dtype == torch.bfloat16 or name.startswith(("mpt125m_decode", "mpt125m_chunk")):
                call = lambda: rpa.ragged_paged_attention(q, kp, vp, layer, rows, pos,  # noqa: E731
                                                           slopes=slopes)
                rec["kernel_ms"] = _time_ms(torch, call, flush)
                rec["kernel_ms_with_host"] = _time_ms(torch, call, flush, host=True)
                rec["plain_ms"] = _time_ms(torch, lambda: rpa.ragged_reference_attention(
                    q, *rpa.live_view(kp, vp, layer, rows), pos, slopes=slopes), flush)
                # yardstick only: SDPA over the pre-gathered live view
                s = kb.shape[1]
                kpos = torch.arange(s, device=dev)
                visible = kpos[None, None, :] <= pos[:, :, None]  # [B, T, S]
                group = h // n_kv
                qs = q.transpose(1, 2)
                ks = kb.transpose(1, 2).repeat_interleave(group, dim=1)
                vs = vb.transpose(1, 2).repeat_interleave(group, dim=1)
                if alibi:
                    dist = (pos[:, :, None] - kpos).to(torch.float32)
                    bias = -slopes[None, :, None, None] * dist[:, None]
                    mask = bias.masked_fill(~visible[:, None], float("-inf")).to(dtype)
                else:
                    mask = visible[:, None]
                rec["library_ms"] = _time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask), flush)
                nbytes, flops = _bound(pos_np, n_ctx, bs, h, n_kv, d, q.element_size())
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_FLOPS[dname] * 1e3
                rec.update(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops else "operations")
                if on_path and dtype == torch.bfloat16:
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                        main[k] += rec["kernel_ms" if k == "ms" else k]
                    main["bytes"] += nbytes
                    main["flops"] += flops
                    main["max_abs_err"] = max(main["max_abs_err"], max_abs)
                    main["shapes"].append(f"{name}: B={b} T={t} H={h}/{n_kv} Dh={d} "
                                          f"n_ctx={n_ctx} bs={bs} bf16")
            records.append(rec)
            log("kernel_case " + json.dumps(rec))
            del kp, vp, q, out, ref, kb, vb
    pools.clear()
    del flush
    torch.cuda.empty_cache()
    t_b = main["bytes"] / HBM_BYTES_PER_S * 1e3
    t_o = main["flops"] / PEAK_FLOPS["bfloat16"] * 1e3
    main["bound_by"] = "bytes" if t_b >= t_o else "operations"
    return records, main


# ---------------------------------------------------------------------------
# phase 2b: the flash-attention kernels (K1, K2, K3)
# ---------------------------------------------------------------------------

#: kernel vs plain version, relative L2. fp32: summation order only
#: (forward 1e-5; backward 1e-4, its dS and dK/dV sums run over up to 2048
#: terms); bf16: the reference harness's gates (bench.py)
FLASH_FWD_GATE = {"float32": 1e-5, "bfloat16": 2e-2}
FLASH_BWD_GATE = {"float32": 1e-4, "bfloat16": 4e-2}
#: wrapper -> (the TPU kernel it replaces, its CUDA kernels' name prefix:
#: ``<prefix>_kernel`` on CUDA cores for fp32, ``<prefix>_wgmma_kernel`` on
#: wgmma + TMA for bf16: ``fwd_wgmma_kernel``, ``bwd_dq_wgmma_kernel`` and
#: ``bwd_dkv_wgmma_kernel``)
FLASH_KERNELS = {
    "flash_fwd": ("photon_tpu/ops/flash_attention.py:93", "::fwd_"),
    "flash_bwd_dq": ("photon_tpu/ops/flash_attention.py:231", "::bwd_dq_"),
    "flash_bwd_dkv": ("photon_tpu/ops/flash_attention.py:280", "::bwd_dkv_"),
}


def _flash_work(b, s_q, s_k, h, n_kv, d, causal, elem):
    """Bytes each kernel must move (inputs read once, outputs written once)
    and the flops of the visible (query, key) pairs: 2 products of 2·D
    flops per pair in K1, 3 in K2, 4 in K3."""
    if causal:
        pairs = sum(min(s_k, max(0, q + (s_k - s_q) + 1)) for q in range(s_q))
    else:
        pairs = s_q * s_k
    pairs *= b * h
    qb, kb = b * s_q * h * d * elem, b * s_k * n_kv * d * elem
    rows = b * h * s_q * 4  # one fp32 LSE or Delta per query row
    return {
        "flash_fwd": (qb + 2 * kb + qb + rows, 4.0 * pairs * d),
        "flash_bwd_dq": (qb + 2 * kb + qb + 2 * rows + qb, 6.0 * pairs * d),
        "flash_bwd_dkv": (qb + 2 * kb + qb + 2 * rows + 2 * kb, 8.0 * pairs * d),
    }


def flash_kernel_phase(torch, fa, alibi_slopes, np):
    """K1–K3 against their plain versions at the training step's shapes,
    and K1 alone at the eval forward's; returns the per-case records, the
    training path's entry of each kernel and the eval path's K1 entry."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    cases = [
        # name, B, S, H, H_kv, D, alibi, the path whose shape it is
        ("mpt125m_train", 16, 2048, 12, 12, 64, False, "train"),
        ("mpt125m_eval", 16, 512, 12, 12, 64, False, "eval"),  # forward only
        ("llama1b_train", 4, 2048, 16, 4, 128, False, None),
        ("mpt1b_train", 4, 2048, 16, 16, 128, False, None),
        ("mpt3b_train", 8, 2048, 20, 20, 128, False, None),
        ("mpt7b_train", 8, 2048, 32, 32, 128, False, None),
        ("mpt125m_alibi", 4, 1024, 12, 12, 64, True, None),
        ("ragged_s1000", 2, 1000, 12, 12, 64, False, None),
    ]
    records, main, main_eval = [], {}, {}
    for name, b, s, h, n_kv, d, alibi, on_path in cases:
        fwd_only = on_path == "eval"
        slopes = alibi_slopes(h, dev) if alibi else None
        kw = dict(causal=True, slopes=slopes)
        gen = torch.Generator(device=dev).manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            if n_kv == h:  # the views of one fused QKV projection, as in training
                qkv = torch.randn((b, s, 3 * h * d), device=dev, generator=gen).to(dtype)
                q, k, v = (x.reshape(b, s, h, d) for x in qkv.chunk(3, dim=-1))
            else:
                q = torch.randn((b, s, h, d), device=dev, generator=gen).to(dtype)
                k, v = (torch.randn((b, s, n_kv, d), device=dev, generator=gen).to(dtype)
                        for _ in range(2))
            do = torch.randn((b, s, h, d), device=dev, generator=gen).to(dtype)
            o, lse = fa.flash_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, **kw)
            errs = {"flash_fwd": [(o, o_ref), (lse, lse_ref)]}
            delta = dq = dk = dv = dq_ref = dk_ref = dv_ref = None
            if not fwd_only:
                delta = fa.attention_delta(o_ref, do)
                dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, **kw)
                dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **kw)
                torch.cuda.synchronize()
                dq_ref = fa.flash_bwd_dq_reference(q, k, v, do, lse_ref, delta, **kw)
                dk_ref, dv_ref = fa.flash_bwd_dkv_reference(q, k, v, do, lse_ref, delta, **kw)
                errs.update(flash_bwd_dq=[(dq, dq_ref)], flash_bwd_dkv=[(dk, dk_ref), (dv, dv_ref)])
            rec = {"case": name, "dtype": dname, "B": b, "S": s, "H": h, "H_kv": n_kv, "D": d,
                   "alibi": alibi, "causal": True, "forward_only": fwd_only}
            for kname, pairs in errs.items():
                gate = (FLASH_FWD_GATE if kname == "flash_fwd" else FLASH_BWD_GATE)[dname]
                rel = max(_rel_l2(x.float(), r.float()) for x, r in pairs)
                max_abs = max(float((x.float() - r.float()).abs().max()) for x, r in pairs)
                finite = all(bool(torch.isfinite(x).all()) for x, _ in pairs)
                if not finite or rel > gate:
                    fail(f"{kname} {name} {dname}: rel L2 {rel:.3e} > {gate}")
                rec[kname] = {"rel_l2": rel, "max_abs_err": max_abs, "gate": gate}
            del errs, o_ref, lse_ref, dq_ref, dk_ref, dv_ref
            if dtype == torch.bfloat16 and fwd_only:
                qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
                work = _flash_work(b, s, s, h, n_kv, d, True, q.element_size())
                nbytes, flops = work["flash_fwd"]
                t_b = nbytes / HBM_BYTES_PER_S * 1e3
                t_o = flops / PEAK_FLOPS[dname] * 1e3
                rec["flash_fwd"].update(
                    kernel_ms=_time_ms(torch, lambda: fa.flash_fwd(q, k, v, **kw), flush),
                    plain_ms=_time_ms(torch, lambda: fa.flash_fwd_reference(q, k, v, **kw), flush),
                    library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, is_causal=True), flush),
                    bytes=nbytes, flops=flops, bound_ms=max(t_b, t_o),
                    bound_by="bytes" if t_b >= t_o else "operations")
                r = rec["flash_fwd"]
                main_eval.update(ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                                 library_ms=r["library_ms"], bound_ms=r["bound_ms"],
                                 bound_by=r["bound_by"], max_abs_err=r["max_abs_err"],
                                 shape=f"{name}: B={b} S={s} H={h}/{n_kv} D={d} causal bf16, "
                                       "forward only")
                del qs, ks, vs
            elif dtype == torch.bfloat16:
                delta = fa.attention_delta(o, do)
                for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
                    first, again = (getattr(fa, kname)(q, k, v, do, lse, delta, **kw)
                                    for _ in range(2))
                    if kname == "flash_bwd_dq":
                        first, again = (first,), (again,)
                    if not all(torch.equal(x, y) for x, y in zip(first, again)):
                        fail(f"{kname} {name}: two launches gave different bits")
                    rec[kname]["same_bits_twice"] = True
                    del first, again
                timed = {
                    "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                                  lambda: fa.flash_fwd_reference(q, k, v, **kw)),
                    "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                                     lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                                                       **kw)),
                    "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
                                      lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                                         **kw)),
                }
                # yardstick only: SDPA forward, and its backward (fwd+bwd - fwd)
                qs, ks, vs = (x.transpose(1, 2).detach() for x in (q, k, v))
                mask = None
                if alibi:
                    pos = torch.arange(s, device=dev)
                    dist = (pos[:, None] - pos[None, :]).float()
                    mask = (-slopes[:, None, None] * dist).masked_fill(dist < 0, float("-inf"))
                    mask = mask.to(dtype)[None]
                sdpa_kw = dict(attn_mask=mask, is_causal=mask is None, enable_gqa=n_kv != h)
                lib_fwd = _time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, **sdpa_kw), flush)
                qg, kg, vg = (x.clone().requires_grad_(True) for x in (qs, ks, vs))
                dos = do.transpose(1, 2)

                def fwd_bwd():
                    out = F.scaled_dot_product_attention(qg, kg, vg, **sdpa_kw)
                    torch.autograd.grad(out, (qg, kg, vg), dos)

                lib_bwd = max(_time_ms(torch, fwd_bwd, flush) - lib_fwd, 0.0)
                work = _flash_work(b, s, s, h, n_kv, d, True, q.element_size())
                for kname, (kern, plain) in timed.items():
                    nbytes, flops = work[kname]
                    t_b = nbytes / HBM_BYTES_PER_S * 1e3
                    t_o = flops / PEAK_FLOPS[dname] * 1e3
                    rec[kname].update(
                        kernel_ms=_time_ms(torch, kern, flush),
                        plain_ms=_time_ms(torch, plain, flush),
                        library_ms={"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd}.get(kname),
                        bytes=nbytes, flops=flops, bound_ms=max(t_b, t_o),
                        bound_by="bytes" if t_b >= t_o else "operations")
                    if on_path == "train":
                        r = rec[kname]
                        main[kname] = {
                            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                            "library_ms": r["library_ms"], "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"], "max_abs_err": r["max_abs_err"],
                            "shape": f"{name}: B={b} S={s} H={h}/{n_kv} D={d} causal bf16",
                        }
                # K2 + K3 do what SDPA's backward does (dq, dk and dv)
                both = rec["flash_bwd_dq"]["kernel_ms"] + rec["flash_bwd_dkv"]["kernel_ms"]
                rec["bwd_vs_library"] = {"k2_plus_k3_ms": both, "sdpa_bwd_ms": lib_bwd,
                                         "ratio": both / lib_bwd if lib_bwd > 0 else None}
                log(f"flash_bwd_vs_sdpa {name}: " + json.dumps(rec["bwd_vs_library"]))
                del qg, kg, vg, qs, ks, vs, timed
            records.append(rec)
            log("flash_case " + json.dumps(rec))
            del q, k, v, do, o, lse, dq, dk, dv, delta
            torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return records, main, main_eval


# ---------------------------------------------------------------------------
# phase 3: training
# ---------------------------------------------------------------------------

#: kernel path vs the plain dense path (attn_impl xla) over one step from
#: the same params and batch: loss and grad_norm relative difference, and
#: the largest per-parameter gradient relative L2 (bf16 compute, 12 layers)
TRAIN_GRAD_GATE = 5e-2
#: the depth of the gate's bf16-parameter leg (mpt-125m's width)
BF16_GATE_LAYERS = 2


def train_config():
    from photon_tpu_torch.config import load_preset

    cfg = load_preset("mpt-125m")  # full width: d768, 12 layers, 12 heads, seq 2048
    cfg.run_uuid = "chip-smoke-train"
    cfg.train.global_batch_size = 32  # the recipe's 256, cut for time: 2 microbatches of 16
    cfg.train.device_microbatch_size = 16
    return cfg.validate()


def _grads_of(torch, cfg, params, tokens):
    """One step's loss, grad norm and gradients (the train step without the
    optimizer), averaged over the config's microbatches."""
    from photon_tpu_torch.codec.params import flatten
    from photon_tpu_torch.models.mpt import MPTModel
    from photon_tpu_torch.optim.build import global_norm
    from photon_tpu_torch.train.train_step import make_loss_fn

    loss_fn = make_loss_fn(MPTModel(cfg.model), cfg.train.loss_chunk_tokens)
    flat = flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
    n = cfg.train.global_batch_size // cfg.train.device_microbatch_size
    loss_sum, grads = 0.0, None
    for mb in tokens.reshape(n, -1, tokens.shape[1]):
        loss = loss_fn(params, mb)
        g = torch.autograd.grad(loss, list(flat.values()))
        loss_sum += float(loss.detach())
        grads = [x.float() for x in g] if grads is None else [a + x for a, x in zip(grads, g)]
    grads = [g / n for g in grads]
    return loss_sum / n, float(global_norm(grads)), dict(zip(flat, grads))


def _shifted_offset_fault(fa):
    """A planted fault, patched in from outside the package: the kernels'
    causal diagonal moved back by one 64-row tile (each query loses its
    64 most recent keys; the first 64 rows see none)."""
    def faulty(q, k, v, *, causal=True, alibi=False):
        return fa.FlashAttention.apply(q, k, v, None, causal, k.shape[1] - q.shape[1] - 64,
                                       None)[0]

    return faulty


def grad_gate(torch, fa, cfg, params, tokens) -> dict:
    """One step from ``params`` and ``tokens`` three ways: the kernels, the
    plain dense attention (``attn_impl: xla``, remat so its scores live one
    block at a time) and the kernels under :func:`_shifted_offset_fault`.
    Returns the kernel run's and the fault's distance from the plain run
    (``worst``: the largest of the loss's and the grad norm's relative
    difference and of the per-parameter gradient relative L2). The launch
    counts are left as they were found: these runs are not the main path."""
    import copy

    saved = dict(fa.launches)
    ref_cfg = copy.deepcopy(cfg)
    ref_cfg.model.attn_impl, ref_cfg.model.remat = "xla", True
    ref = _grads_of(torch, ref_cfg, params, tokens)
    sound = _grads_of(torch, cfg, params, tokens)
    sound_attn = fa.flash_attention
    fa.flash_attention = _shifted_offset_fault(fa)
    try:
        faulty = _grads_of(torch, cfg, params, tokens)
    finally:
        fa.flash_attention = sound_attn
    for key in fa.launches:
        fa.launches[key] = saved[key]

    def compare(run):
        loss_d = abs(run[0] - ref[0]) / abs(ref[0])
        norm_d = abs(run[1] - ref[1]) / abs(ref[1])
        per = {n: _rel_l2(run[2][n], ref[2][n]) for n in ref[2]}
        return {"loss_rel_diff": loss_d, "grad_norm_rel_diff": norm_d,
                "max_param_grad_rel_l2": max(per.values()), "param_grad_rel_l2": per,
                "worst": max(loss_d, norm_d, max(per.values()))}

    return {"gate": TRAIN_GRAD_GATE, "sound": compare(sound), "planted_fault": compare(faulty),
            "loss_kernel": sound[0], "loss_plain": ref[0], "loss_fault": faulty[0]}


def training_phase(torch, fa, np):
    import copy

    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.train.trainer import Trainer
    from photon_tpu_torch.utils.profiling import model_flops_per_token

    cfg = train_config()
    L = cfg.model.n_layers
    params = init_params(cfg.model, seed=0, device="cuda")
    trainer = Trainer(copy.deepcopy(cfg), params=params, device="cuda")
    n_micro = trainer._n_micro
    rng = np.random.default_rng(0)
    batch = rng.integers(0, cfg.model.vocab_size,
                         (cfg.train.global_batch_size, cfg.model.max_seq_len)).astype(np.int32)
    tokens_per_step = batch.size
    torch.cuda.reset_peak_memory_stats()
    for key in fa.launches:  # the counted run starts here
        fa.launches[key] = 0
    steps, walls = [], []
    for i in range(4):
        before = dict(fa.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_batch(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in m.items()}
        grew = {k: fa.launches[k] - before[k] for k in before}
        if any(v != L * n_micro for v in grew.values()):
            fail(f"train step {i}: kernel launches {grew}, want {L * n_micro} each")
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"train step {i}: metrics not finite: {m}")
        steps.append(m)
        log(f"train_step {i}: " + json.dumps(dict(m, wall_s=walls[-1])))
    launches = dict(fa.launches)  # the counted run ends here
    loss = [s_["loss"] for s_ in steps]
    if abs(loss[1] - loss[0]) > 1e-6 * abs(loss[0]):
        fail(f"ADOPT step 0 applied an update: losses {loss[:2]}")
    if not (loss[2] < loss[1] and loss[3] < loss[2]):
        fail(f"the loss does not fall after step 0: {loss}")
    peak_mem = torch.cuda.max_memory_allocated()
    step_s = statistics.median(walls[1:])
    tps = tokens_per_step / step_s
    fpt = model_flops_per_token(cfg.model)

    # where a step's time goes: one more step under the profiler
    profiled = _profiled_step(torch, lambda: trainer.train_batch(batch), step_s)
    rec = {
        "config": "mpt-125m full width (d768, 12 L, 12 H, seq 2048, vocab 50368), bf16 compute, "
                  "fp32 masters, ADOPT lr 6e-4 cosine warmup, clip 1.0, chunked CE 2048",
        "global_batch": cfg.train.global_batch_size, "microbatch": cfg.train.device_microbatch_size,
        "n_micro": n_micro, "tokens_per_step": tokens_per_step,
        "losses": loss, "metrics_by_step": steps, "step_wall_s": walls,
        "step_s_median_after_first": step_s, "tokens_per_s": tps,
        "flops_per_token": fpt, "mfu": tps * fpt / PEAK_FLOPS["bfloat16"],
        "max_memory_allocated_gb": peak_mem / 1e9,
        "launches": launches, "launches_per_step": {k: L * n_micro for k in launches},
        "profiled_step": profiled,
    }
    log("train_phase " + json.dumps({k: v for k, v in rec.items() if k != "metrics_by_step"}))

    # one step from the same params and batch: kernels vs the plain dense path
    del trainer
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(batch).long().cuda()
    rec["vs_plain"] = grad_gate(torch, fa, cfg, params, tokens)
    log("train_vs_plain " + json.dumps(rec["vs_plain"]))
    sound, fault = rec["vs_plain"]["sound"]["worst"], rec["vs_plain"]["planted_fault"]["worst"]
    if sound > TRAIN_GRAD_GATE:
        fail(f"kernel vs plain training step: {sound:.3e} > {TRAIN_GRAD_GATE}")
    if fault <= TRAIN_GRAD_GATE:
        fail(f"the training gate {TRAIN_GRAD_GATE} misses a causal offset shifted by one tile "
             f"(reading {fault:.3e})")
    del params
    torch.cuda.empty_cache()
    # the same gate in bf16 parameters, at 2 layers: the same seed's weights
    # rounded to bf16 (the norms fp32), the same batch
    bf16_cfg = copy.deepcopy(cfg)
    bf16_cfg.model.n_layers, bf16_cfg.model.param_dtype = BF16_GATE_LAYERS, "bfloat16"
    bf16_params = init_params(bf16_cfg.validate().model, seed=0, device="cuda")
    rec["vs_plain_bf16_params"] = grad_gate(torch, fa, bf16_cfg, bf16_params, tokens)
    rec["vs_plain_bf16_params"]["n_layers"] = BF16_GATE_LAYERS
    log("train_vs_plain_bf16_params " + json.dumps(rec["vs_plain_bf16_params"]))
    sound = rec["vs_plain_bf16_params"]["sound"]["worst"]
    fault = rec["vs_plain_bf16_params"]["planted_fault"]["worst"]
    if sound > TRAIN_GRAD_GATE:
        fail(f"kernel vs plain training step, bf16 parameters: {sound:.3e} > {TRAIN_GRAD_GATE}")
    if fault <= TRAIN_GRAD_GATE:
        fail(f"the bf16-parameter training gate {TRAIN_GRAD_GATE} misses the shifted causal "
             f"offset (reading {fault:.3e})")
    del bf16_params, tokens
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 4: the training entry point
# ---------------------------------------------------------------------------

#: the entry point's depth: mpt-125m's width at 2 of its 12 layers (cut
#: in PR 12 to keep the smoke within 800 s; the resume and the launch
#: counts read the same at any depth, and phase 3 times full-depth steps)
ENTRY_LAYERS = 2


def entry_phase(torch, fa):
    """``python -m photon_tpu_torch.centralized`` in process at full width
    and ``ENTRY_LAYERS`` layers: 3 steps with a checkpoint per step, then a
    second run to step 5 that must resume from step 3 (params, optimizer
    state, loader position)."""
    import contextlib
    import io

    from photon_tpu_torch import centralized
    from photon_tpu_torch.checkpoint import ClientCheckpointManager, FileStore

    work = ROOT / ".chip_smoke" / "central"
    shutil.rmtree(work, ignore_errors=True)
    cfg = train_config()
    cfg.model.n_layers = ENTRY_LAYERS
    cfg.photon.save_path = str(work)
    cfg.dataset.synthetic = True
    cfg.train.eval_batches = 2
    cfg.to_yaml(work / "in.yaml")
    args = ["--config", str(work / "in.yaml"), "--device", "cuda"]
    runs = []
    for steps in (3, 5):
        for key in fa.launches:
            fa.launches[key] = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            centralized.main(args + ["--steps", str(steps)])
        lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
        runs.append({"steps": steps, "wall_s": time.perf_counter() - t0, "lines": lines,
                     "launches": dict(fa.launches)})
    L = cfg.model.n_layers
    first, second = runs
    steps_logged = [x["step"] for x in first["lines"]], [x["step"] for x in second["lines"]]
    if steps_logged != ([1, 2, 3], [4, 5]):
        fail(f"entry point: steps logged {steps_logged}, want [1, 2, 3] then [4, 5] (resumed)")
    for run, n in zip(runs, (3, 2)):
        want = {"flash_fwd": L * (2 * n + cfg.train.eval_batches),
                "flash_bwd_dq": L * 2 * n, "flash_bwd_dkv": L * 2 * n}
        if run["launches"] != want:
            fail(f"entry point launched {run['launches']}, want {want}")
        if not all(math.isfinite(x["loss"]) for x in run["lines"]):
            fail(f"entry point: loss not finite: {run['lines']}")
    ckpt = ClientCheckpointManager(FileStore(work / "store"), cfg.run_uuid)
    state = ckpt.load(-1, 5)[3]
    if state["step"] != 5 or state["loader"]["sample_in_epoch"] != 5 * cfg.train.global_batch_size:
        fail(f"entry point: checkpoint at step 5 holds {state}")
    rec = {"runs": runs, "checkpoint_steps": ckpt.steps(-1), "resumed_state": state}
    log("entry_phase " + json.dumps(rec))
    shutil.rmtree(work, ignore_errors=True)
    return rec


# ---------------------------------------------------------------------------
# phase 5: the federated round
# ---------------------------------------------------------------------------

FED_RUN = "chip-smoke-fed"
#: ``python -m photon_tpu_torch.federated`` on top of the training config
FED_SETS = ["fl.n_total_clients=2", "fl.n_clients_per_round=2", "fl.local_steps=4",
            "fl.eval_interval_rounds=2", "train.eval_batches=2"]
#: one client under FedAvg (η = 1, μ = 0), 2 rounds × 3 local steps,
#: against a centralized Trainer that ran 6 steps on the same stream:
#: |global params − centralized| / |centralized − init| over all
#: parameters. On an H100 the sound run reads 1.6e-9 (the fp32 rounding
#: of x − 1·(x − y) at the round boundary; the kernels give the same bits
#: every run). The planted fault (a runtime that never injects the
#: cumulative step, so the lr schedule and ADOPT's count restart each
#: round) runs 2 rounds × 1 step against the Trainer's step 2 and must read
#: at least FED_FAULT_RATIO times the sound gap and over the gate.
FED_GATE = 1e-6
FED_FAULT_RATIO = 10.0
#: the depth of that comparison (c, d): mpt-125m's width at 2 of its 12
#: layers, cut in PR 12 to keep the smoke within 800 s; the gap is a
#: property of the round loop and the optimizer, not of the depth, and
#: both its readings are taken at this one
FED_GATE_LAYERS = 2


def _fed_child(out_path: str, cli_args: list[str], opts: list[str] = ()) -> int:
    """``python -m photon_tpu_torch.federated`` (its ``main``) in a child
    process of :func:`federated_phase` or :func:`distributed_phase`, the
    kernels' launch counts set to 0 just before it; writes the run's
    History, the counts, whether this process initialized CUDA, and its
    peak device memory to ``out_path``. With ``--measured-nodes`` in
    ``opts`` the nodes it spawns run :func:`_measured_node_main`; with
    ``--record-decodes`` the server writes node0's first decoded result of
    each round to ``$PHOTON_SMOKE_DECODES/<tag>.npy`` (:func:`_record_decodes`);
    with ``--frame-audit`` its frames are audited (:func:`_frame_audit`) and
    its chaos injector's counters written too. With telemetry on it also
    writes the health rollup (``/statusz``) and the profile controller's
    status as the run ended."""
    import torch

    sys.path.insert(0, str(ROOT))
    from photon_tpu_torch import chaos, federated, telemetry
    from photon_tpu_torch.ops import flash_attention as fa

    if "--frame-audit" in opts:
        _frame_audit(pathlib.Path(out_path).with_suffix(".audit.jsonl"))

    if "--measured-nodes" in opts:
        from photon_tpu_torch.federation import driver

        driver.node_process_main = _measured_node_main
    if "--record-decodes" in opts:
        import os

        import numpy as np

        from photon_tpu_torch.federation import server

        out = pathlib.Path(os.environ["PHOTON_SMOKE_DECODES"])
        out.mkdir(parents=True, exist_ok=True)
        real_init = server.ServerApp.__init__

        def init(self, *args, **kwargs):
            real_init(self, *args, **kwargs)
            _record_decodes(self, lambda tag, arrays: np.save(
                out / f"{tag}.npy", np.concatenate([a.ravel() for a in arrays])))

        server.ServerApp.__init__ = init
    for key in fa.launches:
        fa.launches[key] = 0
    t0 = time.perf_counter()
    history = federated.main(cli_args)
    # a server that never touched the card must not open a context to ask
    cuda = torch.cuda.is_initialized()
    inj = chaos.active()
    health, prof = telemetry.health_active(), telemetry.profiler_active()
    pathlib.Path(out_path).write_text(json.dumps({
        "history": history.to_dict(), "launches": dict(fa.launches),
        "chaos_counts": inj.counts if inj is not None else None,
        "statusz": health.statusz() if health is not None else None,
        "profile": prof.status() if prof is not None else None,
        "wall_s": time.perf_counter() - t0, "cuda_initialized": cuda,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0}))
    return 0


def _round_breakdown(history: dict, rounds: list[int]) -> list[dict]:
    """Per round, from the run's own History: where its wall time went
    (seconds) and the share of it in which the card trains. The client
    times are the mean over the round's clients, as the History keeps
    them; ``rest`` is the client's pseudo-gradient and param norms."""
    def at(key, rnd):
        return next((v for r, v in history.get(key, []) if r == rnd), 0.0)

    out = []
    for rnd in rounds:
        client = {name: at(key, rnd) for name, key in (
            ("set_parameters", "client/fit_set_parameters_time"), ("train", "client/fit_time"),
            ("get_parameters", "client/get_parameters_time"), ("put", "client/put_time"),
            ("before_train", "client/fit_init_time"), ("fit", "node_training_time_s"))}
        client["rest"] = client["fit"] - sum(client[k] for k in (
            "before_train", "train", "get_parameters", "put"))
        rec = {"round": rnd, "n_clients": at("server/n_clients", rnd), "client_mean": client}
        for name, key in (("broadcast_s", "server/broadcast_pre_time"),
                          ("fit_round_s", "server/round_time"),
                          ("fold_s", "server/agg_fold_time"),
                          ("server_update_s", "server/server_update_time"),
                          ("eval_broadcast_s", "server/broadcast_post_time"),
                          ("eval_s", "server/eval_round_time"),
                          ("checkpoint_blocking_s", "server/checkpoint_time"),
                          ("checkpoint_barrier_s", "server/ckpt_barrier_wait_s"),
                          ("checkpoint_last_write_s", "server/ckpt_async_write_s")):
            rec[name] = at(key, rnd)
        # the server's fetch of each result and its scheduling
        rec["fit_round_rest_s"] = rec["fit_round_s"] - rec["n_clients"] * client["fit"] \
            - rec["fold_s"] - rec["server_update_s"]
        rec["wall_s"] = sum(rec[k] for k in ("broadcast_s", "fit_round_s", "eval_broadcast_s",
                                             "eval_s", "checkpoint_blocking_s"))
        rec["train_share_of_round"] = (rec["n_clients"] * client["train"] / rec["wall_s"]
                                       if rec["wall_s"] > 0 else None)
        out.append(rec)
    return out


def _fed_cli_start(work: pathlib.Path, tag: str, args: list[str], shm_dir: str | None = None,
                   opts: tuple[str, ...] = (), env: dict | None = None
                   ) -> tuple[subprocess.Popen, pathlib.Path, float]:
    """Start :func:`_fed_child` on ``args`` with ``env`` added to this
    process's environment; its stdout and stderr go to files in ``work``."""
    import os

    out_json = work / f"child-{tag}.json"
    env = dict(os.environ, **(env or {}), **({"PHOTON_SHM_DIR": shm_dir} if shm_dir else {}))
    with open(work / f"child-{tag}.out", "w") as out, open(work / f"child-{tag}.err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--fed-child", str(out_json), *opts,
             "--", *args], cwd=ROOT, stdout=out, stderr=err, text=True, env=env)
    return proc, out_json, time.perf_counter()


def _fed_cli_finish(work: pathlib.Path, tag: str, started, timeout: float = 900) -> dict:
    proc, out_json, t0 = started
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    if rc != 0:
        fail(f"federated CLI ({tag}) exited {rc}: "
             f"{(work / f'child-{tag}.err').read_text()[-3000:]}")
    child = json.loads(out_json.read_text())
    return {"tag": tag, "pid": proc.pid, "wall_s": time.perf_counter() - t0,
            "final_line": json.loads((work / f"child-{tag}.out").read_text()
                                     .strip().splitlines()[-1]),
            "history": child["history"], "launches": child["launches"],
            "chaos_counts": child["chaos_counts"], "statusz": child["statusz"],
            "profile": child["profile"],
            "child_wall_s": child["wall_s"], "cuda_initialized": child["cuda_initialized"],
            "max_memory_allocated_gb": child["max_memory_allocated_gb"]}


def _fed_cli_run(work: pathlib.Path, tag: str, args: list[str], shm_dir: str) -> dict:
    return _fed_cli_finish(work, tag, _fed_cli_start(work, tag, args, shm_dir))


def _fed_cli_inprocess(torch, tag: str, args: list[str], shm_dir: str) -> dict:
    """``federated.main`` on ``args`` in this process, the launch counts set
    to 0 just before it, ``PHOTON_SHM_DIR`` set to ``shm_dir`` for it: the
    record :func:`_fed_cli_finish` returns for a child, without a child's
    ~10 s start (the cut that kept the smoke within its time once phase 16
    joined it)."""
    import gc
    import os

    from photon_tpu_torch import federated
    from photon_tpu_torch.ops import flash_attention as fa

    for key in fa.launches:
        fa.launches[key] = 0
    torch.cuda.reset_peak_memory_stats()
    before, os.environ["PHOTON_SHM_DIR"] = os.environ.get("PHOTON_SHM_DIR"), shm_dir
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            history = federated.main(args)
    finally:
        if before is None:
            os.environ.pop("PHOTON_SHM_DIR", None)
        else:
            os.environ["PHOTON_SHM_DIR"] = before
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()  # the run's trainers, before the next phase needs the card
    torch.cuda.empty_cache()
    return {"tag": tag, "pid": os.getpid(), "wall_s": wall,
            "final_line": json.loads(out.getvalue().strip().splitlines()[-1]),
            "history": history.to_dict(), "launches": launches, "chaos_counts": None,
            "child_wall_s": wall, "cuda_initialized": True, "statusz": None, "profile": None,
            "max_memory_allocated_gb": peak}


def _fed_gate(torch, np, cfg, work, initial) -> dict:
    """(c) and (d) in process, on one node (one Trainer): one client under
    FedAvg (η = 1, μ = 0) for 2 rounds × 3 local steps, its first fit under
    ``torch.profiler``; then the planted fault on the same node under a
    fresh server, 2 rounds × 1 step, with the node's ``set_step`` pinned to
    0 (patched in from outside the package; the fit knobs rewind its loader
    and optimizer in round 1); and a centralized Trainer on the same
    client stream, read at steps 2 and 6."""
    import copy

    from photon_tpu_torch.codec.params import params_from_numpy
    from photon_tpu_torch.data import ShardedDataset, StreamingLoader
    from photon_tpu_torch.federation import InProcessDriver, NodeAgent, ParamTransport, ServerApp
    from photon_tpu_torch.ops import flash_attention as fa
    from photon_tpu_torch.train.trainer import Trainer

    c = copy.deepcopy(cfg)
    c.photon.save_path, c.photon.checkpoint = str(work), False
    c.fl.strategy_name, c.fl.server_learning_rate, c.fl.server_momentum = "fedavg", 1.0, 0.0
    c.fl.n_total_clients = c.fl.n_clients_per_round = 1
    c.fl.local_steps, c.fl.eval_interval_rounds = 3, 0
    driver = InProcessDriver(c, lambda nid: NodeAgent(c, nid, lambda: ParamTransport("inline"),
                                                      device="cuda"), n_nodes=1)
    trainer = driver._agents["node0"].runtime.trainer
    sound_fit, sound_set_step = trainer.fit, trainer.set_step
    counted, times = {}, {}

    def profiled_fit(batches, steps, **kw):
        before = dict(fa.launches)
        with _profiled(torch) as prof:
            out = sound_fit(batches, steps, **kw)
        counter = {k: (fa.launches[k] - before[k]) / steps for k in before}
        per = {k: sum(e.count for e in prof.key_averages()
                      if str(getattr(e, "device_type", "")).endswith("CUDA")
                      and tag in e.key) / steps for k, (_, tag) in FLASH_KERNELS.items()}
        counted.setdefault("counter_launches_per_step", []).append(counter)
        readings = counted.setdefault("profiler_launches_per_step", [])
        readings.append(per if any(per.values()) else "not measured")
        counted.setdefault("profiler_min_launch_to_kernel_us", []).append(
            _launch_to_kernel_us(prof))
        counted.setdefault("profiler_pad_lost", []).append(prof.pad_lost)
        # the profiler can lose device records on the card: a reading
        # short of the counter is taken again on the next fit
        if readings[-1] in ("not measured", counter) or len(readings) == PROFILER_READINGS:
            trainer.fit = sound_fit
        return out

    fit_config = dict(c.fl.fit_config)

    def two_rounds(fit_config_round_1=None):
        app = ServerApp(c, driver, ParamTransport("inline"), initial_params=initial)
        for r in (1, 2):  # the server reads the knobs as it sends each round
            c.fl.fit_config = {**fit_config, **(fit_config_round_1 or {})} if r == 1 \
                else dict(fit_config)
            app.broadcast_parameters(r)
            app.fit_round(r)
        app.free_transport()
        return app.strategy.current_parameters

    t0 = time.perf_counter()
    trainer.fit = profiled_fit
    sound = two_rounds()
    times["sound_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c.fl.local_steps = 1
    trainer.set_step = lambda step: sound_set_step(0)
    fault = two_rounds({"reset_optimizer": True, "reset_dataset_state": True})
    trainer.fit = sound_fit
    driver.shutdown()
    del trainer, driver
    times["fault_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    central = Trainer(cfg, params=params_from_numpy(initial[0].names, initial[1], cfg.model,
                                                    "cuda"), device="cuda")
    ds = ShardedDataset(work / "synthetic" / "client_0" / cfg.dataset.split_train)
    loader = StreamingLoader(ds, cfg.train.global_batch_size, seed=cfg.dataset.shuffle_seed,
                             shuffle=cfg.dataset.shuffle)
    central.fit(loader, 2)
    at_2 = central.get_parameters()[1]
    central.fit(loader, 4)
    at_6 = central.get_parameters()[1]
    del central
    torch.cuda.empty_cache()
    times["central_s"] = time.perf_counter() - t0

    def gap(got, want):
        num = sum(float(np.sum((g.astype(np.float64) - w) ** 2)) for g, w in zip(got, want))
        den = sum(float(np.sum((w.astype(np.float64) - a) ** 2))
                  for w, a in zip(want, initial[1]))
        per = max(float(np.linalg.norm(g.astype(np.float64) - w) / max(np.linalg.norm(w), 1e-30))
                  for g, w in zip(got, want))
        return math.sqrt(num / den), per

    (sound_gap, sound_rel), (fault_gap, fault_rel) = gap(sound, at_6), gap(fault, at_2)
    return {"gate": FED_GATE, "sound": sound_gap, "planted_fault": fault_gap,
            "fault_over_sound": fault_gap / sound_gap if sound_gap > 0 else None,
            "sound_max_param_rel_l2": sound_rel, "fault_max_param_rel_l2": fault_rel,
            **times, **counted}


def federated_phase(torch, np):
    """The federated round at full width on the card:

    (a) ``python -m photon_tpu_torch.federated`` (its ``main`` in this
        process, 2 in-process nodes sharing the card, the preset's nesterov strategy,
        the shm plane in a directory of this run's own, checkpoints on)
        for 2 rounds of 2 clients × 4 local steps with eval at rounds 0
        and 2, then again with ``photon.resume_round=-1`` to round 3, which
        must train round 3 alone; the first run's final line must carry a
        finite eval loss (the resumed run does not evaluate: its final
        eval loss is the restored round 0's) and both a positive
        pseudo-gradient norm; K1–K3 launch exactly the counts the rounds
        imply;
    (b) per round, from the run's History: the broadcast, per client
        set_parameters / train loop / get_parameters / put, the fold, the
        server update, eval, the checkpoint, and the card's training share
        of the round;
    (c) + (d): :func:`_fed_gate`, at ``FED_GATE_LAYERS`` layers."""
    import copy
    import tempfile

    from photon_tpu_torch.codec.params import params_to_ndarrays
    from photon_tpu_torch.models.mpt import init_params, param_shapes

    work = ROOT / ".chip_smoke" / "fed"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = train_config()
    cfg.run_uuid = FED_RUN
    cfg.photon.save_path = str(work)
    cfg.dataset.synthetic = True
    cfg.to_yaml(work / "in.yaml")
    L = cfg.model.n_layers
    n_micro = cfg.train.global_batch_size // cfg.train.device_microbatch_size
    payload = 4 * sum(int(np.prod(s)) for s in param_shapes(cfg.model).values())
    # a round holds the broadcast and the clients' results at once
    need = 4 * payload
    free = shutil.disk_usage("/dev/shm").free if pathlib.Path("/dev/shm").is_dir() else 0
    # a directory of this run's own: another run's segments and sweeps
    # never meet this one's
    shm_dir = tempfile.mkdtemp(prefix="photon-smoke-", dir="/dev/shm" if free >= need else work)
    log(f"federated: shm plane in {shm_dir} (/dev/shm free {free / 1e9:.2f} GB, "
        f"a round needs {need / 1e9:.2f} GB)")
    base = ["--config", str(work / "in.yaml"), "--device", "cuda", "--nodes", "2"]
    for s in FED_SETS:
        base += ["--set", s]
    mp = None
    try:
        # phase 5b (a) in a child beside (a)'s in-process runs, which open
        # no CUDA context of their own: the card's contexts count its nodes
        with _GpuMemory() as mem:
            mp = _multiprocess_start(work, base)
            first = _fed_cli_inprocess(torch, "rounds-1-2", base + ["--rounds", "2"], shm_dir)
            second = _fed_cli_inprocess(torch, "resume-to-3", base + [
                "--rounds", "3", "--set", "photon.resume_round=-1"], shm_dir)
            mp_run = _fed_cli_finish(work, "multiprocess", mp)
        left = sorted(p.name for p in pathlib.Path(shm_dir).iterdir())
    finally:
        if mp is not None and mp[0].poll() is None:
            mp[0].kill()
        shutil.rmtree(shm_dir, ignore_errors=True)
    if left:
        fail(f"federated CLI left shm segments behind: {left}")
    per_fit = L * n_micro * 4  # 4 local steps
    evals = L * 2  # eval_batches 2, one K1 launch per layer per batch
    want = [{"flash_fwd": 2 * 2 * per_fit + 2 * 2 * evals,  # evals at rounds 0 and 2
             "flash_bwd_dq": 2 * 2 * per_fit, "flash_bwd_dkv": 2 * 2 * per_fit},
            {k: 2 * per_fit for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}]
    for run, w, rounds in zip((first, second), want, ([1, 2], [3])):
        if run["launches"] != w:
            fail(f"federated CLI ({run['tag']}) launched {run['launches']}, want {w}")
        hist = run["history"]
        grad = dict(map(tuple, hist.get("server/pseudo_grad_norm", [])))
        steps = dict(map(tuple, hist.get("server/steps_cumulative", [])))
        if not all(grad.get(r, 0.0) > 0 and steps.get(r) == 4 * r for r in rounds) \
                or not run["final_line"].get("server/pseudo_grad_norm", 0.0) > 0:
            fail(f"federated CLI ({run['tag']}): rounds {rounds} read pseudo-gradient norms "
                 f"{grad} and steps {steps}; final line {run['final_line']}")
        run["rounds"] = _round_breakdown(hist, rounds)
        for r in run["rounds"]:
            log("fed_round " + json.dumps(dict(r, run=run["tag"])))
    evals_1 = first["history"].get("server/eval_loss", [])
    if [r for r, _ in evals_1] != [0, 2] or not all(math.isfinite(v) for _, v in evals_1) \
            or first["final_line"].get("server/eval_loss") != evals_1[-1][1]:
        fail(f"federated CLI: eval losses {evals_1}, final line {first['final_line']}")
    multiprocess = _multiprocess_checks(np, work, mp_run, mem, first)

    # (c) + (d): one client in process against centralized training
    gcfg = copy.deepcopy(cfg)
    gcfg.model.n_layers = FED_GATE_LAYERS
    init = init_params(gcfg.model, seed=0, device="cuda")
    initial = params_to_ndarrays(init)
    del init
    t0 = time.perf_counter()
    gate = _fed_gate(torch, np, gcfg.validate(), work / "gate", initial)
    gate["wall_s"] = time.perf_counter() - t0
    gate["n_layers"] = FED_GATE_LAYERS
    log("fed_gate " + json.dumps(gate))
    per_step = FED_GATE_LAYERS * n_micro
    want = {k: per_step for k in FLASH_KERNELS}
    if any(c != want for c in gate["counter_launches_per_step"]):
        fail(f"a client fit launched {gate['counter_launches_per_step']} per step, "
             f"want {per_step} each")
    prof = gate["profiler_launches_per_step"]
    if any(p != "not measured" and any(p[k] > per_step for k in p) for p in prof) \
            or prof[-1] not in ("not measured", want):
        fail(f"the profiler saw {prof} kernel launches per step, want {per_step} each (least "
             f"launch-to-kernel µs {gate['profiler_min_launch_to_kernel_us']}, pad records "
             f"lost {gate['profiler_pad_lost']} of {PROFILER_PAD})")
    if not gate["sound"] <= FED_GATE:
        fail(f"single-client FedAvg vs centralized: {gate['sound']:.3e} > {FED_GATE}")
    if not gate["planted_fault"] >= max(FED_FAULT_RATIO * gate["sound"], FED_GATE):
        fail(f"the planted set_step fault reads {gate['planted_fault']:.3e}, not "
             f"{FED_FAULT_RATIO}x the sound {gate['sound']:.3e} and over the gate {FED_GATE}")
    rec = {"shm_dir": shm_dir, "dev_shm_free_gb": free / 1e9, "payload_gb": payload / 1e9,
           "runs": [first, second], "gate": gate, "multiprocess": multiprocess,
           "store": str(work / "store"), "run_uuid": FED_RUN, "served_round": 3}
    log("federated_phase " + json.dumps({k: v for k, v in rec.items()
                                         if k not in ("runs", "multiprocess")}))
    return rec


# ---------------------------------------------------------------------------
# phase 5b: federated rounds across processes
# ---------------------------------------------------------------------------

TCP_RUN = "chip-smoke-tcp"
#: (b)'s depth: its TCP run, the uncompressed comparator and both planted
#: faults run mpt-125m's width at 2 of its 12 layers. Cut to keep the
#: whole smoke within 800 s once phases 14 and 15 joined it; (b)'s gates
#: (readmission, the wire ratio, launches, the update gap against its
#: shifted-scatter fault, the EF identity against its stale-reference
#: fault) read the same things at any depth, and every sound and fault
#: reading is taken anew at this one
TCP_LAYERS = 2
#: (b): the round-3 update (parameters minus round 0's) of the compressed
#: TCP run against the uncompressed comparator, over all parameters:
#: relative L2 at most UPDATE_REL_BOUND and cosine at least
#: UPDATE_COS_BOUND. After three rounds of top-1/8 with error feedback the
#: codec has delivered under half of the update (the rest waits in the
#: clients' residuals), so the sound run reads far from 0: the bounds sit
#: between the prediction for it (rel 0.6–0.85, cos 0.6–0.8; PERF.md §6)
#: and the planted fault (top-k values scattered one index off in the
#: server's decode: rel > 1, cos near 0)
UPDATE_REL_BOUND = 0.95
UPDATE_COS_BOUND = 0.5
#: (b): the per-client error-feedback identity, element by element in
#: fp64: (decoded − b) = (t − b) + r_in − r_out, with b the broadcast the
#: node trained from, t its trained parameters and r_in, r_out its
#: residuals for the cid before and after the encode. Only rounding parts
#: the two sides: the fp32 cast of the decoded parameter and of the stored
#: residual (2^-24 of each, doubled here) and the fp64 sums (2^-53,
#: widened to 2^-48)
EF_FP32_TOL = 2.0 ** -23
EF_FP64_TOL = 2.0 ** -48
EF_SLICE = 1 << 20
#: (b): seconds into the in-process node's round-2 fit at which the
#: subprocess node, which received its FitIns at the same moment, is killed
KILL_AFTER_S = 0.5
#: how often the GPU memory sampler asks ``nvidia-smi``
SMI_POLL_S = 0.5
#: (b): seconds the restarted node1 has to exit after the server's shutdown
#: (its wait overlaps the comparator runs)
NODE_EXIT_S = 180.0


class _GpuMemory:
    """Samples ``nvidia-smi`` on a thread: the number of processes with a
    CUDA context on the card (``--query-compute-apps``: one row each) and
    the card's memory in use (``--query-gpu=memory.used``), their largest
    readings and those when sampling began. On the machines this runs on
    every row reports pid 1 and the card's whole memory, so processes are
    counted, not named, and per-process memory comes from the processes
    themselves."""

    def __init__(self) -> None:
        self.rows = self.rows_before = 0
        self.used_mib = self.used_mib_before = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="smi-sampler", daemon=True)

    @staticmethod
    def _sample() -> tuple[int, float]:
        def smi(*query):
            return subprocess.run(["nvidia-smi", *query, "--format=csv,noheader,nounits"],
                                  capture_output=True, text=True).stdout.strip().splitlines()
        rows = [ln for ln in smi("--query-compute-apps=pid,used_memory") if ln.strip()]
        return len(rows), float(smi("--query-gpu=memory.used")[0])

    def _run(self) -> None:
        while not self._stop.is_set():
            rows, used = self._sample()
            self.rows, self.used_mib = max(self.rows, rows), max(self.used_mib, used)
            self._stop.wait(SMI_POLL_S)

    def record(self) -> dict:
        return {"contexts_before": self.rows_before, "contexts_peak": self.rows,
                "card_used_mib_before": self.used_mib_before, "card_used_mib_peak": self.used_mib}

    def __enter__(self) -> "_GpuMemory":
        self.rows_before, self.used_mib_before = self._sample()
        self.rows, self.used_mib = self.rows_before, self.used_mib_before
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=10)


def _connected(pid: int, port: int) -> bool:
    """Whether process ``pid`` holds an established TCP connection to
    ``port`` (``/proc``)."""
    import os

    inodes = set()
    try:
        for fd in pathlib.Path(f"/proc/{pid}/fd").iterdir():
            link = os.readlink(fd)
            if link.startswith("socket:["):
                inodes.add(link[8:-1])
    except OSError:
        return False
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        for line in pathlib.Path(table).read_text().splitlines()[1:]:
            f = line.split()
            if f[3] == "01" and f[9] in inodes and int(f[2].rsplit(":", 1)[1], 16) == port:
                return True
    return False


def _keep_logs(work: pathlib.Path) -> None:
    """Copy the tails of a failed run's logs to ``chiprun_out/dist-logs``."""
    out = ROOT / "chiprun_out" / "dist-logs"
    out.mkdir(parents=True, exist_ok=True)
    for f in sorted(work.glob("*.log")) + sorted(work.glob("child-*.err")) \
            + sorted(work.glob("child-*.out")):
        (out / f.name).write_bytes(f.read_bytes()[-200_000:])


def _measured_node_main(cfg_json, node_id, conn, device):
    """A spawned node of :func:`distributed_phase`, patched in from outside
    the package: it writes its peak device memory to
    ``$PHOTON_SMOKE_NODE_REPORT/<node_id>.json`` when it shuts down. With
    ``$PHOTON_SMOKE_SALTED_SEED`` set it plants (a)'s fault: it seeds its
    synthetic client data with Python's per-process ``hash`` in place of
    the stable CRC32 seed."""
    import os

    import torch

    from photon_tpu_torch.federation import client_runtime, node

    if os.environ.get("PHOTON_SMOKE_SALTED_SEED"):
        client_runtime._stable_seed = lambda *parts: hash("/".join(map(str, parts))) & 0x7FFFFFFF
    node.node_process_main(cfg_json, node_id, conn, device)
    out = os.environ.get("PHOTON_SMOKE_NODE_REPORT")
    if out and torch.cuda.is_initialized():
        pathlib.Path(out, f"{node_id}-{os.getpid()}.json").write_text(json.dumps({
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "max_memory_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}))


def _shifted_scatter(block):
    """Planted fault of (b): the server's decode of a top-k layer scatters
    each kept value one index past its place."""
    from photon_tpu_torch.compression.quantize import dequantize_q8
    from photon_tpu_torch.compression.topk import topk_densify

    import numpy as np

    vals = dequantize_q8(block.segments["q"], block.segments["scales"],
                         block.q8_block).astype(np.float64)
    idx = (block.segments["idx"].astype(np.int64) + 1) % block.size
    return topk_densify(block.size, idx, vals)


def _stale_reference(app) -> None:
    """Planted fault of (b)'s EF identity: the server pins the previous
    round's broadcast as the delta base it decodes against."""
    real, pinned = app.transport.set_reference, []

    def stale(arrays):
        pinned.append([a.copy() for a in arrays])
        real(pinned[-2] if len(pinned) > 1 else pinned[-1])

    app.transport.set_reference = stale


def _fit_tag(tag: str) -> tuple[int, int, str] | None:
    """``fit-r{round}-c{cid}-{node}`` (a fit result's transport tag) →
    (round, cid, node)."""
    import re

    m = re.fullmatch(r"fit-r(\d+)-c(\d+)-(.+)", tag)
    return (int(m[1]), int(m[2]), m[3]) if m else None


class _EfTaps:
    """The node side of (b)'s EF identity: for the first fit result a node
    uploads in each round, the delta base its codec pinned, the arrays it
    encodes, and its residual for the cid before and after the encode, by
    the result's tag. Wraps the node transport's ``put`` from outside the
    package."""

    def __init__(self) -> None:
        self.taps: dict[str, tuple] = {}

    def wrap(self, transport) -> None:
        put, codec = transport.put, transport.codec

        def tapped(tag, metadata, arrays, compress=False, key=None):
            fit = _fit_tag(tag)
            first = compress and fit is not None and fit[0] not in {
                _fit_tag(t)[0] for t in self.taps}
            r_in = codec.ef.residual(key) if first else None
            ptr = put(tag, metadata, arrays, compress=compress, key=key)
            if first:
                self.taps[tag] = (codec._reference, list(arrays), r_in, codec.ef.residual(key))
            return ptr

        transport.put = tapped


def _record_decodes(app, sink, node: str = "node0") -> None:
    """The server side of (b)'s EF identity: the server's decoded
    parameters of the first fit result ``node`` sends in each round go to
    ``sink(tag, arrays)`` (the objstore plane names each result's tag in
    its key). Wraps the server transport's ``get`` and its codec's
    ``decode`` from outside the package."""
    import re

    get, codec = app.transport.get, app.transport.codec
    decode, marked, rounds = codec.decode, {}, set()

    def tagged_get(ptr, decode=True):
        meta, out = get(ptr, decode=decode)
        m = re.fullmatch(r"transport/(.+)\.npz", ptr.locator)
        fit = _fit_tag(m[1]) if m else None
        if not decode and fit is not None and fit[2] == node and fit[0] not in rounds:
            rounds.add(fit[0])
            marked[id(out)] = m[1]
        return meta, out

    def recorded_decode(payload, pool=None):
        arrays = decode(payload, pool=pool)
        tag = marked.pop(id(payload), None)
        if tag is not None:
            sink(tag, arrays)
        return arrays

    app.transport.get, codec.decode = tagged_get, recorded_decode


def _ef_identity(np, decoded, tap) -> dict:
    """(b)'s per-client error-feedback identity for one fit result, in
    fp64 against the broadcast the node pinned: ``decoded`` (the server's
    decoded parameters, per layer or flat) minus that broadcast must equal
    the node's raw delta plus its residual in, minus its residual out,
    within ``EF_FP32_TOL``/``EF_FP64_TOL`` of each element's magnitudes.
    Read in slices of ``EF_SLICE`` elements, whose fp64 temporaries stay
    in the host's cache."""
    base, trained, r_in, r_out = tap
    if len(r_out) != len(trained):
        fail(f"EF identity: {len(r_out)} residual layers for {len(trained)} arrays")
    worst, over, err_sq, got_sq, off = 0.0, 0, 0.0, 0.0, 0
    for j, (b_all, t_all) in enumerate(zip(base, trained)):
        n = t_all.size
        s_all = decoded[j] if isinstance(decoded, list) else decoded[off:off + n]
        off += n
        for lo in range(0, n, EF_SLICE):
            hi = min(n, lo + EF_SLICE)
            s = np.asarray(s_all, dtype=np.float32).ravel()[lo:hi].astype(np.float64)
            b = b_all.ravel()[lo:hi].astype(np.float64)
            t = t_all.ravel()[lo:hi].astype(np.float64)
            ri = 0.0 if r_in is None else r_in[j][lo:hi].astype(np.float64)
            ro = r_out[j][lo:hi].astype(np.float64)
            got = s - b
            err = np.abs(got - ((t - b) + ri - ro))
            tol = EF_FP32_TOL * (np.abs(s) + np.abs(ro)) \
                + EF_FP64_TOL * (np.abs(t) + np.abs(b) + np.abs(ri) + np.abs(ro)) + 1e-40
            ratio = err / tol
            worst = max(worst, float(ratio.max()))
            over += int(np.count_nonzero(ratio > 1.0))
            err_sq += float(err @ err)
            got_sq += float(got @ got)
    return {"max_err_over_tol": worst, "elements_over": over,
            "rel_l2": math.sqrt(err_sq / got_sq) if got_sq else math.inf, "ok": over == 0}


def _param_rel(np, got, want) -> float:
    """The largest per-tensor relative L2 of ``got`` against ``want``."""
    return max(float(np.linalg.norm(g.astype(np.float64) - w) / max(np.linalg.norm(w), 1e-30))
               for g, w in zip(got, want))


def _update_gap(np, params, comparator, initial) -> dict:
    """Relative L2 and cosine of (params − initial) against (comparator −
    initial), over all parameters."""
    dot = nu = nc = nd = 0.0
    for p, c, i in zip(params, comparator, initial):
        u = p.astype(np.float64) - i
        v = c.astype(np.float64) - i
        dot += float(np.dot(u.ravel(), v.ravel()))
        nu += float(np.dot(u.ravel(), u.ravel()))
        nc += float(np.dot(v.ravel(), v.ravel()))
        nd += float(np.sum((u - v) ** 2))
    return {"rel_l2": math.sqrt(nd / nc), "cosine": dot / math.sqrt(nu * nc),
            "norm_ratio": math.sqrt(nu / nc)}


def _inprocess_rounds(cfg, work: pathlib.Path, tag: str, compressed: bool,
                      fault: str | None = None, n_rounds: int = 3, device: str = "cuda",
                      ef_identity: bool = False):
    """(b)'s in-process runs: one node, no eval, ``n_rounds`` rounds. The
    comparator (uncompressed), the shifted-scatter fault run (``fault=
    "scatter"``) and the stale-reference fault run (``"stale"``). With
    ``ef_identity`` the planes are objstore (each result's key names its
    node) and each round's EF identity is read. Returns the last round's
    parameters, the seconds and the EF identity readings."""
    import copy

    import numpy as np

    from photon_tpu_torch.checkpoint import FileStore
    from photon_tpu_torch.federation import InProcessDriver, NodeAgent, ParamTransport, ServerApp

    c = copy.deepcopy(cfg)
    c.photon.save_path, c.photon.checkpoint = str(work / tag), False
    c.photon.comm_stack.objstore = c.photon.comm_stack.shm = False
    c.fl.eval_interval_rounds = 0
    if not compressed:
        c.photon.compression.policy = "off"
    comp = c.photon.compression
    store = FileStore(work / tag / "plane") if ef_identity else None
    mode = "inline" if store is None else "objstore"
    taps, readings = _EfTaps(), []

    def make_agent(nid):
        agent = NodeAgent(c, nid, lambda: ParamTransport(
            mode, store=store, compression=comp, host_threads=c.photon.host_threads),
            device=device)
        if ef_identity:
            taps.wrap(agent.runtime.transport)
        return agent

    driver = InProcessDriver(c, make_agent, n_nodes=1)
    app = ServerApp(c, driver, ParamTransport(mode, store=store, compression=comp))
    if fault == "scatter":
        app.transport.codec._decode_float_layer = _shifted_scatter
    elif fault == "stale":
        _stale_reference(app)
    if ef_identity:
        _record_decodes(app, lambda t, arrays: readings.append(
            dict(_ef_identity(np, arrays, taps.taps.pop(t)), round=_fit_tag(t)[0], tag=t)))
    t0 = time.perf_counter()
    try:
        for r in range(1, n_rounds + 1):
            app.broadcast_parameters(r)
            app.fit_round(r)
        return ([a.copy() for a in app.strategy.current_parameters],
                time.perf_counter() - t0, readings)
    finally:
        app.free_transport()
        driver.shutdown()


def _stale_reference_run(cfg, work: pathlib.Path, device: str = "cuda"):
    """(b)'s planted fault for the EF identity: :func:`_inprocess_rounds`
    with the server pinning the previous round's broadcast, 2 rounds (round
    1 has nothing earlier to pin) of one client. The client keeps its
    local steps: ADOPT's first step moves nothing, and a round-1 update of
    zero would leave the stale base equal to the true one."""
    import copy

    one = copy.deepcopy(cfg)
    one.fl.n_total_clients = one.fl.n_clients_per_round = 1
    return _inprocess_rounds(one, work, "stale", True, "stale", 2, device, ef_identity=True)


def _multiprocess_start(work: pathlib.Path, base: list[str]):
    """5b (a): ``--multiprocess --nodes 2`` on phase 5's config for 2
    rounds, a child whose nodes are spawned processes with their own CUDA
    contexts on the one card; each node reports its own peak memory."""
    reports = work / "mp-nodes"
    reports.mkdir()
    return _fed_cli_start(
        work, "multiprocess", base + ["--multiprocess", "--rounds", "2",
                                      "--set", f"photon.save_path={work / 'mp'}"],
        opts=("--measured-nodes",), env={"PHOTON_SMOKE_NODE_REPORT": str(reports)})


def _multiprocess_checks(np, work: pathlib.Path, run: dict, mem: "_GpuMemory",
                         first: dict) -> dict:
    """5b (a)'s gates on its finished run: round-2 parameters and the eval
    losses at rounds 0 and 2 within ``FED_GATE`` of phase 5's first run
    (the same bits expected), the card's contexts exactly two more than
    before the run (the nodes; none in the server) and each node's own peak
    reported; the round breakdown recorded."""
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager

    run["rounds"] = _round_breakdown(run["history"], [1, 2])
    # contexts: this process, then the two nodes; the server would be one more
    run["card"] = mem.record()
    run["nodes_memory"] = [json.loads(f.read_text())
                           for f in sorted((work / "mp-nodes").iterdir())]
    ref = first["history"]["server/eval_loss"]
    got = run["history"].get("server/eval_loss", [])
    want = ServerCheckpointManager(FileStore(work / "store"), FED_RUN).load_round_params(2)[1]
    have = ServerCheckpointManager(FileStore(work / "mp" / "store"), FED_RUN).load_round_params(2)[1]
    run["params_bit_equal"] = all(np.array_equal(a, b) for a, b in zip(have, want))
    run["params_max_rel_l2"] = _param_rel(np, have, want)
    run["eval_loss"] = got
    run["eval_loss_in_process"] = ref
    if [r for r, _ in got] != [0, 2]:
        fail(f"multiprocess run evaluated rounds {[r for r, _ in got]}, want [0, 2]")
    run["eval_loss_max_rel"] = max(abs(g - w) / abs(w) for (_, g), (_, w) in zip(got, ref))
    if not (run["params_max_rel_l2"] <= FED_GATE and run["eval_loss_max_rel"] <= FED_GATE):
        fail(f"--multiprocess parts from the in-process run: round-2 params "
             f"{run['params_max_rel_l2']:.3e}, eval loss {run['eval_loss_max_rel']:.3e} "
             f"(gate {FED_GATE})")
    if run["cuda_initialized"] or mem.rows != mem.rows_before + 2 or len(run["nodes_memory"]) != 2:
        fail(f"--multiprocess: the server initialized CUDA ({run['cuda_initialized']}), or the "
             f"card held {mem.record()} (want 2 contexts more: the nodes), or the nodes "
             f"reported {run['nodes_memory']}")
    log("dist_multiprocess " + json.dumps({k: v for k, v in run.items() if k != "history"}))
    return run


def _tcp(torch, np, fa, work, cfg) -> dict:
    """(b): ``--tcp-listen`` with the codec, node1 a ``federation.tcp
    --connect`` subprocess killed in round 2 and started again, node0
    ``run_node`` on a thread of this process (its launches counted)."""
    import signal as signal_mod
    import socket

    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.federation import node as node_mod
    from photon_tpu_torch.federation import tcp

    cfg.to_yaml(work / "tcp.yaml")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    addr = f"127.0.0.1:{port}"
    # faulthandler: a node that will not exit dumps its threads on SIGABRT
    node_cmd = [sys.executable, "-X", "faulthandler", "-m", "photon_tpu_torch.federation.tcp",
                "--connect", addr, "--node-id", "node1", "--config", str(work / "tcp.yaml")]
    fits, evals = [], []
    round2, back = threading.Event(), threading.Event()
    real_make = node_mod.make_node_agent
    taps = _EfTaps()

    def make_agent(c, node_id, device):
        agent = real_make(c, node_id, device)
        rt = agent.runtime
        taps.wrap(rt.transport)
        real_fit, real_eval = rt.fit, rt.evaluate

        def fit(ins, cid):
            fits.append([ins.server_round, cid])
            if ins.server_round == 2 and not round2.is_set():
                # hold until the killed node is back: it then rejoins
                # while round 2's window still runs
                round2.set()
                back.wait(timeout=300)
            return real_fit(ins, cid)

        def evaluate(ins, cid):
            evals.append([ins.server_round, cid])
            return real_eval(ins, cid)

        rt.fit, rt.evaluate = fit, evaluate
        return agent

    rec: dict = {"port": port}
    t0 = time.perf_counter()
    stamps = rec["stamps_s"] = {}  # seconds into this function, for the breakdown

    def stamp(what):
        stamps[what] = time.perf_counter() - t0

    procs: list[subprocess.Popen] = []
    torch.cuda.reset_peak_memory_stats()
    for key in fa.launches:
        fa.launches[key] = 0
    node_mod.make_node_agent = make_agent
    try:
        with _GpuMemory() as mem, open(work / "node1.log", "w") as log1:
            stamp("sampler_up")
            started = _fed_cli_start(work, "tcp", ["--config", str(work / "tcp.yaml"),
                                                   "--tcp-listen", addr, "--nodes", "2"],
                                     opts=("--record-decodes",),
                                     env={"PHOTON_SMOKE_DECODES": str(work / "decoded")})
            t_start = time.perf_counter()
            # the nodes dial once the server listens: a node that dials
            # early backs off exponentially and joins late
            while "listening on" not in (work / "child-tcp.out").read_text():
                if time.perf_counter() - t_start > 120 or started[0].poll() is not None:
                    fail("tcp: the server never listened")
                time.sleep(0.1)
            stamp("server_listening")
            node0 = threading.Thread(target=tcp.run_node, args=(addr, "node0", cfg.to_json()),
                                     kwargs={"device": "cuda"}, name="tcp-node0", daemon=True)
            node0.start()
            procs.append(subprocess.Popen(node_cmd, cwd=ROOT, stdout=log1, stderr=log1))
            if not round2.wait(timeout=600):
                fail(f"tcp: round 2 never reached node0 (fits {fits})")
            stamp("round_2")
            time.sleep(KILL_AFTER_S)
            procs[0].send_signal(signal_mod.SIGKILL)
            procs[0].wait()
            t_kill = time.perf_counter()
            procs.append(subprocess.Popen(node_cmd, cwd=ROOT, stdout=log1, stderr=log1))
            while not _connected(procs[1].pid, port):
                if time.perf_counter() - t_kill > 300 or procs[1].poll() is not None:
                    fail("tcp: the restarted node1 never connected")
                time.sleep(0.05)
            rec["restart_to_connect_s"] = time.perf_counter() - t_kill
            time.sleep(0.5)  # its HELLO lands
            back.set()
            stamp("node1_back")
            run = _fed_cli_finish(work, "tcp", started)
            stamp("server_done")
            node0.join(timeout=60)
            if node0.is_alive():
                fail("tcp: node0 did not return after the server's shutdown")
            rec["wall_s"] = time.perf_counter() - t_start
            # node1 exits on the server's shutdown too; the caller waits for
            # it later, so a slow teardown overlaps the next runs
            rec["node1"], rec["server_done_at"] = procs[1], time.perf_counter()
    except BaseException:
        _keep_logs(work)
        for p in procs:
            if p.poll() is None:
                p.kill()
        raise
    finally:
        node_mod.make_node_agent = real_make
        back.set()
    stamp("sampler_down")
    rec.update(run)
    rec["launches"] = dict(fa.launches)
    rec["fits_on_node0"], rec["evals_on_node0"] = fits, evals
    # contexts: this process (node0) before; then node1, and after its kill
    # its restart, one at a time; the server would be one more
    rec["card"] = mem.record()
    rec["node0_max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    hist = run["history"]
    rec["rounds"] = _round_breakdown(hist, [1, 2, 3])
    ratios = dict(map(tuple, hist.get("server/wire_compression_ratio", [])))
    rec["wire_compression_ratio"] = ratios
    rec["nodes_readmitted_total"] = run["final_line"].get("server/nodes_readmitted_total", 0.0)
    if sorted(ratios) != [1, 2, 3] or min(ratios.values()) < 4.0:
        fail(f"tcp: wire compression ratios {ratios}, want >= 4 in rounds 1-3")
    if not rec["nodes_readmitted_total"] >= 1 or hist.get("server/round_failed"):
        fail(f"tcp: readmitted {rec['nodes_readmitted_total']}, "
             f"failed rounds {hist.get('server/round_failed')}")
    if [2, 1] not in fits:
        fail(f"tcp: the killed node's cid 1 was not retried on node0 (fits {fits})")
    if run["cuda_initialized"] or mem.rows != mem.rows_before + 1:
        fail(f"tcp: the server initialized CUDA ({run['cuda_initialized']}) or the card held "
             f"{mem.record()} (want 1 context more: node1)")
    L = cfg.model.n_layers
    per_fit = L * (cfg.train.global_batch_size // cfg.train.device_microbatch_size) \
        * cfg.fl.local_steps
    want = {"flash_fwd": per_fit * len(fits) + L * cfg.train.eval_batches * len(evals),
            "flash_bwd_dq": per_fit * len(fits), "flash_bwd_dkv": per_fit * len(fits)}
    if rec["launches"] != want:
        fail(f"tcp: node0 launched {rec['launches']}, want {want} "
             f"({len(fits)} fits, {len(evals)} evals)")
    rec["round_3_params"] = ServerCheckpointManager(
        FileStore(work / "tcp" / "store"), TCP_RUN).load_round_params(3)[1]
    rec["ef_taps"] = taps.taps
    stamp("params_read")
    return rec


def _tcp_ef_identity(np, work, taps: dict) -> list[dict]:
    """(b)'s EF identity on the TCP run: node0's taps against the server
    child's decoded results, one per round."""
    out = []
    for tag, tap in sorted(taps.items()):
        path = work / "decoded" / f"{tag}.npy"
        if not path.exists():
            fail(f"tcp: the server recorded no decode of {tag}")
        out.append(dict(_ef_identity(np, np.load(path, mmap_mode="r"), tap),
                        round=_fit_tag(tag)[0], tag=tag))
    taps.clear()
    return out


def distributed_phase(torch, np, fa, fed) -> dict:
    """Phase 5b, on phase 5's config:

    (a) ``python -m photon_tpu_torch.federated --multiprocess --nodes 2``
        (a child; each node a spawned process with its own CUDA context on
        the one card) for 2 rounds runs beside phase 5's in-process rounds
        (:func:`_multiprocess_start`, :func:`_multiprocess_checks`):
        round-2 parameters and the eval losses at rounds 0 and 2 within
        ``FED_GATE`` of phase 5's first run (the same bits expected), no
        CUDA context in the server (the card's contexts counted); the round
        breakdown, each node's own peak memory and the card's. Here, beside
        (b)'s checks: a planted fault (a spawned node that seeds its
        synthetic data with Python's per-process ``hash``, patched in from
        outside; one node, round 0 only) must part the round-0 eval loss
        over the gate;
    (b) at ``TCP_LAYERS`` layers, ``--tcp-listen`` (a child that opens no
        CUDA context) with
        ``delta_topk_q8`` and error feedback, ``reset_optimizer`` on every
        fit (a fit's result then does not depend on the node that ran it),
        3 rounds: node0 is ``run_node`` on a thread here, node1 a
        ``python -m photon_tpu_torch.federation.tcp --connect`` child,
        SIGKILLed ``KILL_AFTER_S`` into round 2's fits and started again
        under its id (node0's round-2 fit waits for it to connect). The run
        must finish with cid 1 retried on node0, at least one readmission,
        the uplink compressed >= 4x every round, node0's K1–K3 launches
        exact; its round-3 update against an uncompressed in-process run
        within ``UPDATE_REL_BOUND``/``UPDATE_COS_BOUND``, and a run whose
        server decode scatters top-k values one index off over them; in
        every round, the server's decode of node0's first result holds the
        per-client error-feedback identity against node0's broadcast,
        raw delta and residuals (:func:`_ef_identity`), and an in-process
        run whose server pins the previous round's broadcast as its delta
        base breaks it in round 2."""
    from photon_tpu_torch.centralized import _apply_override

    work = ROOT / ".chip_smoke" / "dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    fed_work = pathlib.Path(fed["store"]).parent
    base = ["--config", str(fed_work / "in.yaml"), "--device", "cuda", "--nodes", "2"]
    for s in FED_SETS:
        base += ["--set", s]
    rec: dict = {}

    cfg = train_config()
    for s in FED_SETS:
        _apply_override(cfg, *s.split("=", 1))
    cfg.run_uuid, cfg.photon.save_path = TCP_RUN, str(work / "tcp")
    cfg.model.n_layers = TCP_LAYERS
    cfg.dataset.synthetic = True
    cfg.fl.n_rounds = 3
    cfg.fl.fit_config = {"reset_optimizer": True}
    cfg.photon.compression.policy = "delta_topk_q8"
    cfg.photon.compression.error_feedback = True
    cfg.photon.comm_stack.objstore, cfg.photon.comm_stack.shm = True, False
    cfg.validate()
    t0 = time.perf_counter()
    tcp_rec = _tcp(torch, np, fa, work, cfg)
    rec["tcp_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    sound, taps = tcp_rec.pop("round_3_params"), tcp_rec.pop("ef_taps")
    node1, server_done_at = tcp_rec.pop("node1"), tcp_rec.pop("server_done_at")
    log("dist_tcp " + json.dumps({k: v for k, v in tcp_rec.items() if k != "history"}))
    exited: dict = {}

    def watch():
        node1.wait()
        exited["at"] = time.perf_counter()

    watcher = threading.Thread(target=watch, name="node1-exit", daemon=True)
    watcher.start()
    try:
        _dist_checks(torch, np, work, fed, base, cfg, rec, tcp_rec, sound, taps)
    finally:
        watcher.join(timeout=max(0.0, server_done_at + NODE_EXIT_S - time.perf_counter()))
        if "at" not in exited:
            node1.send_signal(signal.SIGABRT)  # faulthandler: its threads go to node1.log
            node1.wait(timeout=30)
            _keep_logs(work)
            fail(f"tcp: the restarted node1 did not exit in {NODE_EXIT_S} s of the "
                 "server's shutdown")
    tcp_rec["node1_exit_after_server_s"] = exited["at"] - server_done_at
    rec["tcp"] = tcp_rec
    log("dist_checks " + json.dumps({"update": tcp_rec["update"],
                                     "ef_identity": tcp_rec["ef_identity"],
                                     "ef_identity_stale_reference":
                                         tcp_rec["ef_identity_stale_reference"],
                                     "multiprocess_fault": rec["multiprocess_fault"],
                                     "checks_s": rec["checks_s"],
                                     "node1_exit_after_server_s":
                                         tcp_rec["node1_exit_after_server_s"]}))
    shutil.rmtree(work, ignore_errors=True)
    return rec


def _dist_checks(torch, np, work, fed, base, cfg, rec, tcp_rec, sound, taps) -> None:
    """(b)'s comparator, shifted-scatter and stale-reference runs (threads
    here) and the EF identity of the TCP run beside (a)'s planted fault (a
    child); the gates on both."""
    import concurrent.futures as cf

    from photon_tpu_torch.codec.params import params_to_ndarrays
    from photon_tpu_torch.models.mpt import init_params

    # the in-process runs share the card (threads here), beside (a)'s
    # planted fault (a child)
    t0 = time.perf_counter()
    # one node evaluates both clients: the same round-0 loss when sound
    mp_fault = _fed_cli_start(work, "multiprocess-fault", base + [
        "--multiprocess", "--nodes", "1", "--rounds", "0",
        "--set", f"photon.save_path={work / 'mp-fault'}"],
        opts=("--measured-nodes",), env={"PHOTON_SMOKE_SALTED_SEED": "1"})
    with cf.ThreadPoolExecutor(4) as pool:
        comp = pool.submit(_inprocess_rounds, cfg, work, "comparator", False)
        bad = pool.submit(_inprocess_rounds, cfg, work, "fault", True, "scatter")
        stale = pool.submit(_stale_reference_run, cfg, work)
        ident = pool.submit(_tcp_ef_identity, np, work, taps)
        (comparator, comp_s, _), (faulty, fault_s, _) = comp.result(), bad.result()
        _, stale_s, stale_ef = stale.result()
        tcp_rec["ef_identity"] = ident.result()
    fault_run = _fed_cli_finish(work, "multiprocess-fault", mp_fault)
    rec["checks_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    initial = params_to_ndarrays(init_params(cfg.model, seed=cfg.seed))[1]
    update = {"sound": _update_gap(np, sound, comparator, initial),
              "planted_fault": _update_gap(np, faulty, comparator, initial),
              "rel_bound": UPDATE_REL_BOUND, "cos_bound": UPDATE_COS_BOUND,
              "comparator_s": comp_s, "fault_s": fault_s}
    tcp_rec["update"] = update
    ok = lambda g: g["rel_l2"] <= UPDATE_REL_BOUND and g["cosine"] >= UPDATE_COS_BOUND  # noqa: E731
    if not ok(update["sound"]):
        fail(f"tcp: round-3 update vs the uncompressed comparator {update['sound']}, "
             f"bounds rel <= {UPDATE_REL_BOUND}, cos >= {UPDATE_COS_BOUND}")
    if ok(update["planted_fault"]):
        fail(f"tcp: the shifted-scatter fault reads {update['planted_fault']}, within the bounds")
    ef = tcp_rec["ef_identity"]
    tcp_rec["ef_identity_stale_reference"] = {"rounds": stale_ef, "seconds": stale_s}
    if [r["round"] for r in ef] != [1, 2, 3] or not all(r["ok"] for r in ef):
        fail(f"tcp: the EF identity of node0's results reads {ef}, want it held in rounds 1-3")
    if [r["round"] for r in stale_ef] != [1, 2] or not stale_ef[0]["ok"] or stale_ef[1]["ok"]:
        fail(f"tcp: the stale-reference fault reads {stale_ef}, want the EF identity held in "
             "round 1 (no earlier broadcast to pin) and broken in round 2")
    fault_loss = fault_run["history"].get("server/eval_loss", [])
    want0 = fed["runs"][0]["history"]["server/eval_loss"][0][1]
    mp_fault_rec = {"eval_loss": fault_loss, "wall_s": fault_run["wall_s"],
                    "eval_loss_rel": abs(fault_loss[0][1] - want0) / abs(want0)
                    if fault_loss else None}
    rec["multiprocess_fault"] = mp_fault_rec
    if not (mp_fault_rec["eval_loss_rel"] or 0.0) > FED_GATE:
        fail(f"--multiprocess: the salted-seed fault reads {mp_fault_rec}, within {FED_GATE}")


# ---------------------------------------------------------------------------
# phase 6: engine
# ---------------------------------------------------------------------------

def serve_config(preset: str = "mpt-125m"):
    from photon_tpu_torch.config import load_preset

    cfg = load_preset(preset)
    cfg.run_uuid = "chip-smoke"
    s = cfg.photon.serve
    s.n_slots, s.block_size, s.n_blocks = 8, 16, 0  # auto pool: 8 × 128 blocks
    s.prefill_token_budget = 512
    s.max_new_tokens = 32
    s.max_queue = 64
    return cfg


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


def _drop_last_block(torch, rpa_fn):
    """A planted fault: ``rpa_fn`` with each row's last live block table
    entry pointed at the trash block, so the walk reads the wrong keys
    and values for the most recent (up to ``block_size``) positions."""
    def faulty(q, k_pool, v_pool, layer, rows, positions, **kw):
        last = (positions.max(dim=1).values // k_pool.shape[2]).clamp(0, rows.shape[1] - 1)
        rows = rows.clone()
        rows[torch.arange(rows.shape[0], device=rows.device), last.long()] = k_pool.shape[0] - 1
        return rpa_fn(q, k_pool, v_pool, layer, rows, positions, **kw)

    return faulty


def _compare_logits(torch, np, eng_r, eng_g, emitted, vocab, step):
    """The emitting rows' logits of the two engines: finite, of the right
    shape, within the gate; greedy tokens equal wherever the gather
    engine's top-2 margin exceeds twice the largest logit difference.
    Returns (relative L2, rows whose tokens were held equal, the largest
    logit difference)."""
    rows = torch.from_numpy(np.flatnonzero(emitted)).to("cuda")
    lr = eng_r.last_logits[rows].float()
    lg = eng_g.last_logits[rows].float()
    if not (torch.isfinite(lr).all() and lr.shape == (len(rows), vocab)):
        fail(f"step {step}: logits not finite or of shape {tuple(lr.shape)}")
    rel = _rel_l2(lr, lg)
    if rel > ENGINE_LOGIT_GATE:
        fail(f"step {step}: ragged vs gather logits rel L2 {rel:.3e}")
    max_diff = float((lr - lg).abs().max())
    top2 = lg.topk(2, dim=-1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 2 * max_diff).cpu().numpy()
    same = (lr.argmax(-1) == lg.argmax(-1)).cpu().numpy()
    if (clear & ~same).any():
        fail(f"step {step}: greedy tokens differ where the top-2 margin is clear")
    return rel, int(clear.sum()), max_diff


def engine_phase(torch, rpa, np, params, cfg):
    import copy

    from photon_tpu_torch.serve import cache
    from photon_tpu_torch.serve.engine import PagedEngine

    L = cfg.model.n_layers
    cfg_r, cfg_g = copy.deepcopy(cfg), copy.deepcopy(cfg)
    cfg_r.photon.serve.attention_impl = "ragged"
    cfg_g.photon.serve.attention_impl = "gather"
    eng_r = PagedEngine(cfg_r, params, device="cuda")
    eng_g = PagedEngine(cfg_g, params, device="cuda")
    eng_f = PagedEngine(cfg_r, params, device="cuda")  # runs with the planted fault
    if eng_r.attn_impl != "ragged":
        fail(f"ragged engine reports attn_impl={eng_r.attn_impl}")
    sound_rpa = cache.ragged_paged_attention
    faulty_rpa = _drop_last_block(torch, sound_rpa)
    rng = np.random.default_rng(1)
    vocab = cfg.model.vocab_size
    prompts = [list(map(int, rng.integers(0, vocab, n))) for n in (700, 40, 300, 1200)]
    max_new, budget = 8, cfg.photon.serve.prefill_token_budget
    queue, running, emitted_n = list(enumerate(prompts)), {}, {}
    steps = chunk_steps = checked = 0
    sound_rels, fault_rels, max_diffs = [], [], []
    rpa.launches = 0  # the counted run starts here
    t0 = time.perf_counter()
    while queue or running:
        while queue and eng_r.free_slot() is not None \
                and eng_r.can_admit(len(queue[0][1]), max_new):
            i, prompt = queue.pop(0)
            slot = eng_r.free_slot()
            for eng in (eng_r, eng_g, eng_f):
                eng.begin(slot, prompt, max_new)
            running[slot], emitted_n[slot] = i, 0
        pre = [s for s in running if eng_r.pending_tokens(s) > 0]
        chunk = None
        if pre:
            s = min(pre, key=lambda s: running[s])
            chunk = (s, min(eng_r.pending_tokens(s), budget))
        before = rpa.launches
        nxt, emitted = eng_r.mixed_step(chunk)
        launched = rpa.launches - before
        want = L * (2 if chunk else 1)
        if launched != want:
            fail(f"step {steps}: kernel launched {launched} times, want {want}")
        eng_g.mixed_step(chunk)
        if rpa.launches != before + launched:
            fail("the gather engine launched the kernel")
        cache.ragged_paged_attention = faulty_rpa
        try:
            eng_f.mixed_step(chunk)
        finally:
            cache.ragged_paged_attention = sound_rpa
            rpa.launches = before + launched  # the planted-fault check is not the main path
        if emitted.any():
            rel, n_checked, max_diff = _compare_logits(torch, np, eng_r, eng_g, emitted,
                                                       vocab, steps)
            sound_rels.append(rel)
            max_diffs.append(max_diff)
            checked += n_checked
            rows = torch.from_numpy(np.flatnonzero(emitted)).to("cuda")
            fault_rels.append(_rel_l2(eng_f.last_logits[rows].float(),
                                      eng_g.last_logits[rows].float()))
        # keep the engines on one token stream (a near-tie may round apart)
        eng_g._last[:] = eng_r._last
        eng_f._last[:] = eng_r._last
        steps += 1
        chunk_steps += chunk is not None
        for s in sorted(running):
            if emitted[s]:
                emitted_n[s] += 1
                if emitted_n[s] >= max_new:
                    for eng in (eng_r, eng_g, eng_f):
                        eng.evict(s)
                    del running[s]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rpa.launches
    if launches != L * (steps + chunk_steps) or launches == 0:
        fail(f"engine phase launched {launches}, want {L * (steps + chunk_steps)}")
    if eng_r.allocator.free_blocks != eng_r.n_blocks:
        fail("engine phase leaked blocks")
    if max(fault_rels) <= ENGINE_LOGIT_GATE:
        fail(f"the logit gate {ENGINE_LOGIT_GATE} misses a dropped key block "
             f"(largest reading {max(fault_rels):.3e})")
    rec = {"steps": steps, "chunk_steps": chunk_steps, "launches": launches,
           "worst_logit_rel_l2": max(sound_rels), "logit_gate": ENGINE_LOGIT_GATE,
           "planted_fault_rel_l2_max": max(fault_rels),
           "planted_fault_steps_over_gate": sum(r > ENGINE_LOGIT_GATE for r in fault_rels),
           "emitting_steps": len(fault_rels),
           "sound_rel_l2_by_step": sound_rels, "planted_fault_rel_l2_by_step": fault_rels,
           "greedy_rows_held_equal": checked,
           # the largest logit difference of two sound engines: what
           # spec_prefix calls a tie
           "max_abs_logit_diff": max(max_diffs),
           "wall_s_three_engines": wall}
    log("engine_phase " + json.dumps(rec))
    del eng_r, eng_g, eng_f
    torch.cuda.empty_cache()
    return rec


def profile_phase(torch, np, params, cfg):
    """Where a steady decode step's time goes: 8 slots decoding at ~512
    tokens of context, 10 steps timed on the host clock (each ends in a
    synchronize), then 10 more under ``torch.profiler`` for the device's
    busy time by kernel. Device busy and idle shares are per step."""
    import copy

    from photon_tpu_torch.serve.engine import PagedEngine

    c = copy.deepcopy(cfg)
    c.photon.serve.attention_impl = "auto"
    eng = PagedEngine(c, params, device="cuda")
    rng = np.random.default_rng(3)
    for slot in range(eng.n_slots):
        eng.admit(slot, list(map(int, rng.integers(0, c.model.vocab_size, 512))), 64)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()  # each step ends in the one device-to-host token copy
    step_ms = (time.perf_counter() - t0) / n * 1e3
    with _profiled(torch) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) / n * 1e3
    kernels = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", 0.0) or 0.0
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3 / n
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    rec = {"slots": eng.n_slots, "context_tokens": 512, "steps": n,
           "step_ms": step_ms, "profiled_step_ms": prof_wall_ms,
           "device_busy_ms_per_step": busy if busy > 0 else "not measured",
           # busy is kernel time (the profiler does not stretch it); the wall
           # under the profiler is, so the share is of the unprofiled step
           "device_idle_share": (1 - busy / step_ms) if busy > 0 else "not measured",
           "rpa_kernel_ms_per_step": sum(v for k, v in kernels.items() if "::rpa_" in k),
           "kernel_launches_per_step": sum(
               e.count for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")) / n,
           "top_kernels_ms_per_step": [[k[:80], v] for k, v in top]}
    log("profile_phase " + json.dumps(rec))
    del eng
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 6b: speculative verify and the prefix cache
# ---------------------------------------------------------------------------

#: the verify grid's slots: 8 rows mid-decode at these context lengths
SPEC_LENGTHS = (16, 100, 250, 400, 600, 800, 1100, 1500)
#: the spec and prefix passes: 16 prompts of a 64-token block repeated 5
#: times plus a 16-token suffix of their own, 64 greedy tokens each
SPEC_PROMPTS, SPEC_NEW = 16, 64
SPEC_TEMP = 0.2  # the sampled passes' temperature: low enough that drafts still land


def _last_position_per_row(rpa_fn):
    """A planted fault: ``rpa_fn`` with every query of a row given the
    row's last position, so a verify column sees the later drafts' keys
    (a per-row mask in place of a per-query one)."""
    def faulty(q, k_pool, v_pool, layer, rows, positions, **kw):
        last = positions.max(dim=1, keepdim=True).values
        return rpa_fn(q, k_pool, v_pool, layer, rows, last.expand_as(positions).contiguous(), **kw)

    return faulty


def _verify_grid(torch, np, rpa, cfg, params, tag) -> dict:
    """8 slots mid-decode at ``SPEC_LENGTHS``: 4 sequential single-token
    steps on one clone of the state against one ``mixed_chunk_step`` with
    ``n_spec = 4`` on another, each row fed its own greedy continuation
    as drafts. Per (row, column) logits within ``ENGINE_LOGIT_GATE``,
    greedy tokens equal where the top-2 margin exceeds twice the largest
    difference; K4 launched ``n_layers`` times for the verify, all in its
    bf16 verify regime, and 4 × ``n_layers`` for the steps. Then the verify
    again with
    :func:`_last_position_per_row` patched in, which must read over the
    gate."""
    import copy

    from photon_tpu_torch.serve import cache
    from photon_tpu_torch.serve.engine import PagedEngine

    c = copy.deepcopy(cfg)
    c.photon.serve.attention_impl = "ragged"
    eng = PagedEngine(c, params, device="cuda")
    L, vocab, budget = c.model.n_layers, c.model.vocab_size, c.photon.serve.prefill_token_budget
    rng = np.random.default_rng(4)
    for slot, n in enumerate(SPEC_LENGTHS):
        eng.begin(slot, list(map(int, rng.integers(0, vocab, n))), 64)
        while eng.pending_tokens(slot):
            eng.mixed_step((slot, min(eng.pending_tokens(slot), budget)), include_decode=False)
    B, n_spec = eng.n_slots, 4
    lengths, n_ctx = eng._lengths.copy(), eng._ctx_width()

    def run(state, toks, first, width):
        t = toks.shape[1]
        pos = torch.from_numpy((lengths + first)[:, None] + np.arange(t)).int().cuda()
        return cache.mixed_chunk_step(
            eng.params, eng._layers, state, torch.from_numpy(toks).long().cuda(),
            pos.contiguous(), torch.ones((B, t), dtype=torch.bool, device="cuda"),
            torch.zeros(B, dtype=torch.int32, device="cuda"),
            torch.from_numpy(lengths + first + t).int().cuda(), 0, eng.mc,
            n_ctx=n_ctx, impl="ragged", n_spec=width)[0]

    seq_state = eng.state.clone()
    cur = eng._last.copy()[:, None]
    seq, feed = [], [cur[:, 0]]
    rpa.launches = 0
    for i in range(n_spec):
        lg = run(seq_state, cur, i, 1).float()
        seq.append(lg)
        cur = lg.argmax(-1).int().cpu().numpy()[:, None]
        feed.append(cur[:, 0])
    seq_launches = rpa.launches
    toks = np.stack(feed[:n_spec], axis=1).astype(np.int32)  # [last, t1, t2, t3]
    regime = rpa.regime(n_spec, c.model.n_heads // c.model.kv_heads, eng.state.cache_k.dtype)
    if regime != "verify":
        fail(f"{tag} verify grid: a {eng.state.cache_k.dtype} pool takes the {regime} regime")
    rpa.launches = 0
    rpa.regime_launches[regime] = 0
    grid = run(eng.state.clone(), toks, 0, n_spec).float()
    torch.cuda.synchronize()
    grid_launches, regime_launches = rpa.launches, rpa.regime_launches[regime]
    if seq_launches != n_spec * L or grid_launches != L or regime_launches != L:
        fail(f"{tag} verify grid: K4 launched {grid_launches} ({regime_launches} in the "
             f"{regime} regime; want {L}) and the steps {seq_launches} (want {n_spec * L})")
    if not (torch.isfinite(grid).all() and grid.shape == (B, n_spec, vocab)):
        fail(f"{tag} verify grid: logits not finite or of shape {tuple(grid.shape)}")
    rels, clear, max_abs = [], 0, 0.0
    for i in range(n_spec):
        for r in range(B):
            a, b = grid[r, i], seq[i][r]
            rel = _rel_l2(a, b)
            diff = float((a - b).abs().max())
            rels.append(rel)
            max_abs = max(max_abs, diff)
            top2 = b.topk(2).values
            if float(top2[0] - top2[1]) > 2 * diff:
                clear += 1
                if int(a.argmax()) != int(b.argmax()):
                    fail(f"{tag} verify grid: row {r} column {i} greedy token differs "
                         f"where the margin is clear")
    if max(rels) > ENGINE_LOGIT_GATE:
        fail(f"{tag} verify grid vs sequential steps: rel L2 {max(rels):.3e} > "
             f"{ENGINE_LOGIT_GATE}")
    sound = cache.ragged_paged_attention
    cache.ragged_paged_attention = _last_position_per_row(sound)
    try:
        bad = run(eng.state.clone(), toks, 0, n_spec).float()
    finally:
        cache.ragged_paged_attention = sound
    fault = [_rel_l2(bad[r, i], seq[i][r]) for i in range(n_spec) for r in range(B)]
    if max(fault) <= ENGINE_LOGIT_GATE:
        fail(f"{tag}: the gate {ENGINE_LOGIT_GATE} misses a per-row position mask "
             f"(largest reading {max(fault):.3e})")
    rec = {"shape": f"B={B} n_spec={n_spec} H={c.model.n_heads}/{c.model.kv_heads} "
                    f"Dh={c.model.d_head} L={L} n_ctx={n_ctx} {c.model.compute_dtype}",
           "regime": regime, "launches_verify_regime": regime_launches,
           "worst_rel_l2": max(rels), "max_abs_logit_diff": max_abs,
           "rows_columns_clear": clear, "launches_verify": grid_launches,
           "launches_sequential": seq_launches, "planted_fault_rel_l2_max": max(fault),
           "planted_fault_over_gate": sum(f > ENGINE_LOGIT_GATE for f in fault)}
    del eng, seq, grid, bad
    torch.cuda.empty_cache()
    return rec


def _batcher_pass(torch, rpa, eng, prompts, speculative=None, temperature=0.0) -> dict:
    """The prompts through a ``ContinuousBatcher`` (submitted before it
    starts, so admission is FIFO from one queue), ``SPEC_NEW`` tokens each
    (greedy, or sampled at ``temperature`` with request ``i`` seeded
    ``i``); K4 must launch ``n_layers`` × (steps + chunk steps)."""
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    b = ContinuousBatcher(eng, max_queue=64,
                          prefill_token_budget=eng.cfg.photon.serve.prefill_token_budget,
                          speculative=speculative)
    reqs = [b.submit(p, SPEC_NEW, temperature=temperature, seed=i)
            for i, p in enumerate(prompts)]
    rpa.launches = 0
    by_regime = dict(rpa.regime_launches)
    t0 = time.perf_counter()
    b.start()
    outs = [r.result(timeout=600) for r in reqs]
    wall = time.perf_counter() - t0
    launches = rpa.launches
    by_regime = {k: rpa.regime_launches[k] - v for k, v in by_regime.items()}
    b.close()
    st = b.stats()
    want = eng.mc.n_layers * int(st["steps"] + st["chunk_steps"])
    if launches != want or launches == 0:
        fail(f"batcher pass launched K4 {launches} times, want {want}")
    if any(len(o) != SPEC_NEW for o in outs) or eng.n_active:
        fail(f"batcher pass: lengths {[len(o) for o in outs]}, {eng.n_active} slots left")
    ttft = [r.ttft_s for r in reqs]
    return {"outs": outs, "wall_s": wall, "tokens_per_s": len(prompts) * SPEC_NEW / wall,
            "launches": launches, "launches_by_regime": by_regime, "steps": st["steps"],
            "chunk_steps": st["chunk_steps"], "mean_ttft_s": sum(ttft) / len(ttft),
            "first_wave_mean_ttft_s": sum(ttft[: eng.n_slots]) / eng.n_slots,
            "spec": b.spec_stats()}


def _streams_agree(torch, eng, prompts, got, want, tie, what) -> list:
    """Greedy streams ``got`` equal ``want`` up to each request's first
    divergence, where the top-2 margin of the logits (recomputed by ``eng``
    over the prompt and the common prefix) must be a tie: at most ``tie``.
    Returns ``[request, token index, margin]`` of each divergence."""
    diverged = []
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        eng.admit(0, p + b[:j], 1)
        top2 = eng.last_logits[0].float().topk(2).values
        eng.evict(0)
        margin = float(top2[0] - top2[1])
        if margin > tie:
            fail(f"{what}: a stream differs at token {j} where the top-2 margin "
                 f"{margin:.4f} is clear (tie {tie:.4f})")
        diverged.append([i, j, margin])
    return diverged


def spec_prefix_phase(torch, rpa, np, params, cfg, tie: float) -> dict:
    """Speculative decoding and the prefix cache at full width (mpt-125m,
    bf16, ``attention_impl="ragged"``): the verify grid against sequential
    steps at mpt-125m's shape and at llama-1b's attention shape (GQA 16/4,
    D=128, 2 layers), both through K4's verify regime, each with its planted fault;
    a speculative batcher (k = 4) against a plain one on 16 templated
    prompts; and the prefix cache over the same prompts served twice.
    ``tie``: twice the largest logit difference of two sound engines
    (the engine phase), the margin under which greedy streams may part."""
    import copy

    from photon_tpu_torch.config import load_preset
    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.serve.engine import PagedEngine

    rec = {"verify_125m": _verify_grid(torch, np, rpa, cfg, params, "mpt-125m")}
    lcfg = load_preset("llama-1b")
    lcfg.photon.serve = copy.deepcopy(cfg.photon.serve)
    lcfg.model.n_layers = 2  # the attention shape is what is held; depth is cut
    lparams = init_params(lcfg.model, seed=0, device="cuda")
    rec["verify_llama1b"] = _verify_grid(torch, np, rpa, lcfg, lparams, "llama-1b")
    del lparams
    torch.cuda.empty_cache()
    for k, v in rec.items():
        log(f"spec_prefix {k} " + json.dumps(v))

    base = copy.deepcopy(cfg)
    base.photon.serve.attention_impl = "ragged"
    rng = np.random.default_rng(6)
    template = list(map(int, rng.integers(0, cfg.model.vocab_size, 64))) * 5
    prompts = [template + list(map(int, rng.integers(0, cfg.model.vocab_size, 16)))
               for _ in range(SPEC_PROMPTS)]
    plain_eng = PagedEngine(base, params, device="cuda")
    plain = _batcher_pass(torch, rpa, plain_eng, prompts)
    scfg = copy.deepcopy(base)
    scfg.photon.serve.speculative.enabled = True
    scfg.photon.serve.speculative.k = 4
    spec_eng = PagedEngine(scfg, params, device="cuda")
    spec = _batcher_pass(torch, rpa, spec_eng, prompts, scfg.photon.serve.speculative)
    # sampled traffic: every emitting row draws on the device, and a step
    # reads its tokens back in one copy, as a greedy one does
    plain_t = _batcher_pass(torch, rpa, plain_eng, prompts, temperature=SPEC_TEMP)
    spec_t = _batcher_pass(torch, rpa, spec_eng, prompts, scfg.photon.serve.speculative,
                           temperature=SPEC_TEMP)
    del spec_eng
    st = spec["spec"]
    if not st["spec_steps"] or not st["drafted"]:
        fail(f"speculative pass drafted nothing: {st}")
    diverged = _streams_agree(torch, plain_eng, prompts, spec["outs"], plain["outs"], tie,
                              "speculative vs plain")
    rec["speculative"] = {
        "k_max": 4, "prompts": SPEC_PROMPTS, "new_tokens": SPEC_NEW,
        "prompt_tokens": len(prompts[0]), "drafted": st["drafted"],
        "accepted": st["accepted"], "spec_steps": st["spec_steps"],
        "accept_ewma_end": st["accept_ewma"], "k_end": st["k"],
        "acceptance_rate": st["accepted"] / st["drafted"],
        "tokens_per_s_spec": spec["tokens_per_s"], "tokens_per_s_plain": plain["tokens_per_s"],
        "temperature": SPEC_TEMP, "tokens_per_s_plain_temp": plain_t["tokens_per_s"],
        "tokens_per_s_spec_temp": spec_t["tokens_per_s"],
        "drafted_temp": spec_t["spec"]["drafted"], "accepted_temp": spec_t["spec"]["accepted"],
        "steps_plain_temp": plain_t["steps"], "steps_spec_temp": spec_t["steps"],
        "steps_spec": spec["steps"], "steps_plain": plain["steps"],
        "launches_spec": spec["launches"], "launches_plain": plain["launches"],
        "tie": tie, "streams_diverged_at_a_tie": diverged}
    log("spec_prefix speculative " + json.dumps(rec["speculative"]))

    pcfg = copy.deepcopy(base)
    pcfg.photon.serve.prefix_cache = True
    eng = PagedEngine(pcfg, params, device="cuda")
    shared_refs = []
    real_begin = eng.begin

    def begin(slot, prompt, *a, **kw):  # reads the refcounts on the scheduler thread
        real_begin(slot, prompt, *a, **kw)
        hit = eng._slot_blocks[slot][: eng._lengths[slot] // eng.block_size]
        shared_refs.append(max((eng.allocator.refcount(b) for b in hit), default=0))

    eng.begin = begin
    cold = _batcher_pass(torch, rpa, eng, prompts)
    after_cold = dict(eng.prefix_stats())
    refs_cold, shared_refs[:] = list(shared_refs), []
    warm = _batcher_pass(torch, rpa, eng, prompts)
    stats = eng.prefix_stats()
    cached_warm = stats["tokens_cached"] - after_cold["tokens_cached"]
    if cached_warm <= 0 or max(shared_refs) < 2:
        fail(f"prefix cache: the second pass cached {cached_warm} tokens, shared blocks "
             f"at refcount {max(shared_refs)}")
    diverged_p = _streams_agree(torch, plain_eng, prompts, warm["outs"], cold["outs"], tie,
                                "cached vs cold")
    held = eng.n_blocks - eng.free_blocks
    if held != len(eng.prefix_cache):
        fail(f"prefix cache: {held} blocks held with {len(eng.prefix_cache)} entries")
    eng.prefix_cache.flush()
    if eng.free_blocks != eng.n_blocks:
        fail(f"prefix cache leaked {eng.n_blocks - eng.free_blocks} blocks")
    rec["prefix"] = {
        "prompts": SPEC_PROMPTS, "prompt_tokens": len(prompts[0]),
        "hit_rate_cold_pass": after_cold["tokens_cached"] / (SPEC_PROMPTS * len(prompts[0])),
        "hit_rate_cached_pass": cached_warm / (SPEC_PROMPTS * len(prompts[0])),
        "hit_rate_cumulative": stats["hit_rate"], "entries": held,
        "max_shared_refcount_cold": max(refs_cold), "max_shared_refcount_cached": max(shared_refs),
        "mean_ttft_s_cold": cold["mean_ttft_s"], "mean_ttft_s_cached": warm["mean_ttft_s"],
        "first_wave_ttft_s_cold": cold["first_wave_mean_ttft_s"],
        "first_wave_ttft_s_cached": warm["first_wave_mean_ttft_s"],
        "tokens_per_s_cold": cold["tokens_per_s"], "tokens_per_s_cached": warm["tokens_per_s"],
        "chunk_steps_cold": cold["chunk_steps"], "chunk_steps_cached": warm["chunk_steps"],
        "launches": [cold["launches"], warm["launches"]],
        "tie": tie, "streams_diverged_at_a_tie": diverged_p, "leaked_blocks": 0}
    log("spec_prefix prefix " + json.dumps(rec["prefix"]))
    rec["launches"] = {"verify_125m": rec["verify_125m"]["launches_verify"],
                       "speculative": spec["launches"], "plain": plain["launches"],
                       "sampled": plain_t["launches"] + spec_t["launches"],
                       "prefix": cold["launches"] + warm["launches"],
                       "speculative_by_regime": spec["launches_by_regime"]}
    del eng, plain_eng
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 7: server
# ---------------------------------------------------------------------------

def _request(port, path, body=None, timeout=600):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    if body is None:
        conn.request("GET", path)
    else:
        conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    return resp.status, data


def _generate(port, prompt, max_new, stream=False):
    status, data = _request(port, "/generate", {"tokens": prompt, "max_new_tokens": max_new,
                                                "stream": stream})
    if status != 200:
        return status, None
    if not stream:
        return status, json.loads(data)
    lines = [json.loads(x) for x in data.strip().splitlines()]
    final = lines[-1]
    if not final.get("done") or [x["token"] for x in lines[:-1]] != final.get("tokens"):
        return -1, None
    return status, final


def _copy_round(src, dst, run: str, rnd: int, to: int | None = None,
                flip: bool = False) -> float:
    """Copy round ``rnd`` of ``run`` from store ``src`` into ``dst`` (as
    round ``to``, default the same), each object by an atomic put (no
    fsync: nothing here outlives the machine), the manifest last; ``flip``
    flips one byte of the params object after its checksum was taken (a
    corrupt round). Returns the wall time at which the manifest landed."""
    from photon_tpu_torch.checkpoint.server import MANIFEST_FILE, PARAMS_FILE

    prefix, out = f"{run}/server/{rnd}/", f"{run}/server/{rnd if to is None else to}/"
    for key in src.list(prefix.rstrip("/")):
        if key.endswith(MANIFEST_FILE):
            continue
        data = src.get(key)
        if flip and key.endswith(PARAMS_FILE):
            data = bytearray(data)
            data[len(data) // 2] ^= 0x01
            data = bytes(data)
        dst.put(out + key[len(prefix):], data, durable=False)
    dst.put(out + MANIFEST_FILE, src.get(prefix + MANIFEST_FILE), durable=False)
    return time.time()


def _wait_health(port, pred, timeout_s: float, what: str) -> dict:
    deadline = time.monotonic() + timeout_s
    while True:
        health = json.loads(_request(port, "/healthz")[1])
        if pred(health):
            return health
        if time.monotonic() > deadline:
            fail(f"server: {what} not reached in {timeout_s} s: {health}")
        time.sleep(0.05)


def server_phase(torch, np, cfg, n_layers, fed):
    """Serve the federated run as it trains: the server starts on a store
    copy that holds the run's rounds up to 2 (``--round -1``), with
    hot-swap, the prefix cache and speculative decoding on. While its 8
    requests run, round 3 is copied in (manifest last) and must be
    swapped in with no request dropped; then a round 4 whose params
    object has one byte flipped must be skipped as corrupt while round 3
    keeps serving. The nesterov momentum beside the params is not read."""
    from photon_tpu_torch.checkpoint import FileStore

    work = ROOT / ".chip_smoke" / "serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    run, last = fed["run_uuid"], fed["served_round"]
    src, store = FileStore(fed["store"]), FileStore(work / "store")
    rounds = sorted({int(k.split("/")[2]) for k in src.list(f"{run}/server")})
    for r in (r for r in rounds if r < last):
        _copy_round(src, store, run, r)
    cfg.run_uuid = run
    sc = cfg.photon.serve
    sc.attention_impl = "auto"
    sc.prefix_cache = sc.hotswap = sc.speculative.enabled = True
    sc.speculative.k = 4
    sc.hotswap_poll_s = 0.25
    cfg.to_yaml(work / "resolved.yaml")
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch.serve", "--config", str(work / "resolved.yaml"),
         "--store", str(work / "store"), "--round", "-1", "--enable", "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    stderr_tail: list[str] = []
    threading.Thread(target=lambda: stderr_tail.extend(proc.stderr), daemon=True).start()
    watchdog = threading.Timer(900, proc.kill)  # a server that never comes up
    watchdog.start()
    try:
        t_start = time.perf_counter()
        first = proc.stdout.readline()
        watchdog.cancel()
        if not first:
            proc.wait(timeout=30)
            fail(f"server exited {proc.returncode}: {''.join(stderr_tail)[-3000:]}")
        info = json.loads(first)
        port = info["port"]
        log("server_up " + json.dumps(dict(info, startup_s=time.perf_counter() - t_start)))
        if info["round"] != last - 1 or not (info["prefix_cache"] and info["hotswap"]):
            fail(f"server started on round {info['round']} (want {last - 1}) with prefix "
                 f"cache {info['prefix_cache']}, hot-swap {info['hotswap']}")
        h0 = json.loads(_request(port, "/healthz")[1])
        if h0["kernel_launches"]["ragged_paged_attention"] != 0:
            fail("server launched the kernel before any request")
        rng = np.random.default_rng(2)
        vocab = cfg.model.vocab_size
        lengths = [16, 100, 250, 400, 600, 800, 1100, 1500]
        prompts = [list(map(int, rng.integers(0, vocab, n))) for n in lengths]
        max_new = 32
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            futs = [pool.submit(_generate, port, p, max_new, i == 2) for i, p in enumerate(prompts)]
            time.sleep(0.2)  # the requests are in flight: round 3 lands now
            t_manifest = _copy_round(src, store, run, last)
            replies = [f.result() for f in futs]
        t_replies = time.time()
        wall = time.perf_counter() - t0
        for n, (status, rep) in zip(lengths, replies):
            if status != 200 or rep is None or rep["n_generated"] != max_new \
                    or len(rep["tokens"]) != max_new or rep["n_prompt"] != n:
                fail(f"prompt of {n}: status {status}, reply {rep}")
        swapped = _wait_health(port, lambda h: h["round"] == last and h["swaps"] == 1, 120,
                               f"the swap to round {last}")
        hs = swapped["hotswap"]
        # round 4: round 3's objects with one byte of the params flipped
        _copy_round(store, store, run, last, to=last + 1, flip=True)
        t_corrupt = time.perf_counter()
        rejected = _wait_health(port, lambda h: h["hotswap"]["rejected_corrupt"] == 1, 60,
                                f"the corrupt round {last + 1} rejected")
        if rejected["round"] != last or rejected["swaps"] != 1:
            fail(f"server left round {last} for a corrupt round: {rejected}")
        # the repeated greedy prompt: a first request fills the prefix
        # cache, the next two take the same cached path and must agree
        again = [_generate(port, prompts[3], max_new)[1] for _ in range(3)]
        if any(a is None for a in again) or again[1]["tokens"] != again[2]["tokens"]:
            fail("a repeated greedy prompt returned different tokens")
        health = json.loads(_request(port, "/healthz")[1])
        if health["attn_impl"] != "ragged" or health["status"] != "ok" \
                or health["round"] != last or health["hotswap"]["rejected_corrupt"] != 1:
            fail(f"/healthz: {health}")
        st = health["stats"]
        launches = health["kernel_launches"]["ragged_paged_attention"]
        want = n_layers * int(st["steps"] + st["chunk_steps"])
        if launches != want or launches == 0:
            fail(f"server launched the kernel {launches} times, want {want}")
        if st["chunk_split_prompts"] < 1:
            fail("no prompt was split into chunks")
        ttfts = [rep["ttft_s"] for _, rep in replies]
        rec = {"requests": len(prompts), "prompt_lengths": lengths, "max_new_tokens": max_new,
               "all_200": True, "wall_s": wall,
               "tokens_per_s": len(prompts) * max_new / wall,
               "mean_ttft_s": sum(ttfts) / len(ttfts), "max_ttft_s": max(ttfts),
               "repeat_equal": True,
               "repeat_cold_equals_cached": again[0]["tokens"] == again[1]["tokens"],
               "repeat_equals_concurrent": again[0]["tokens"] == replies[3][1]["tokens"],
               "server_steps": st["steps"], "server_chunk_steps": st["chunk_steps"],
               "chunk_split_prompts": st["chunk_split_prompts"], "launches": launches,
               "swap": {"from_round": info["round"], "to_round": last,
                        "manifest_to_applied_s": hs["last_swap_at"] - t_manifest,
                        "manifest_before_last_reply_s": t_replies - t_manifest,
                        "staged_to_applied_s": hs["last_swap_s"],
                        "device_bytes_before": hs["swap_bytes_before"],
                        "device_peak_bytes": hs["swap_peak_bytes"],
                        "polls": hs["polls"]},
               "corrupt_round": {"round": last + 1, "rejected_corrupt": 1,
                                 "detected_s": time.perf_counter() - t_corrupt,
                                 "still_serving_round": rejected["round"]},
               "prefix_cache": health.get("prefix_cache"),
               "speculative": health.get("speculative"),
               "served": {"run_uuid": run, "rounds": [info["round"], last]}}
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            fail("server did not exit after SIGTERM")
        if rc != 0:
            fail(f"server exited {rc} after SIGTERM: {''.join(stderr_tail)[-3000:]}")
        rec["sigterm_exit"] = rc
        log("server_phase " + json.dumps(rec))
        return rec
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 8: contiguous decode against the paged engine
# ---------------------------------------------------------------------------

#: greedy steps and prompt lengths of the decode phase (8 rows, one a slot)
DECODE_STEPS = 32
DECODE_PROMPTS = (1, 4, 16, 100, 400, 800, 1100, 1500)


def _cache_write_one_past(decode):
    """A planted fault, patched in from outside the package: the decode
    step writes each token's k/v one position past its cursor (so the
    token never sees its own key and the next one reads it as its own)."""
    sound = decode._write_cache

    def faulty(cache, rows, pos, new):
        sound(cache, rows, (pos + 1).clamp(max=cache.shape[1] - 1), new)

    return sound, faulty


def _row_rel_l2(a, b) -> float:
    """The largest relative L2 over the rows of ``[B, V]`` logits."""
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-12)).max())


def _contiguous_stream(torch, decode, cp, mc, tokens, lengths, stream):
    """Prefill, then decode the engine's token ``stream`` (one column a
    step) through the contiguous cache; the logits of every step."""
    with torch.inference_mode():
        logits, st = decode.prefill(cp, tokens, lengths, mc)
        out = [logits.float()]
        for nxt in stream[:-1]:
            logits, st = decode.decode_step(cp, st, nxt, mc)
            out.append(logits.float())
    return out


def decode_phase(torch, np, fa, params, cfg):
    """Contiguous KV-cache decode (``models/decode.py``) against a
    ``PagedEngine`` with ``attention_impl="ragged"`` (K4) on full-width
    mpt-125m: 8 prompts of 16–1500 tokens, ``DECODE_STEPS`` greedy steps.
    Both run on one token stream, the engine's; per step the logits agree
    within ``ENGINE_LOGIT_GATE`` and the greedy tokens wherever the
    engine's top-2 margin is clear. ``generate`` then decodes the same
    prompts on its own: its tokens equal the engine's in every row up to
    the row's first step without a clear margin. A planted fault (the
    cache written one position past the cursor) must break the logit
    gate. Contiguous decode tokens/s: 8 rows × 31 steps over ``many(32)``
    less ``many(1)``."""
    import copy

    from photon_tpu_torch.models import decode
    from photon_tpu_torch.serve.engine import PagedEngine

    mc = cfg.model
    cfg_r = copy.deepcopy(cfg)
    cfg_r.photon.serve.attention_impl = "ragged"
    eng = PagedEngine(cfg_r, params, device="cuda")
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(0, mc.vocab_size, n))) for n in DECODE_PROMPTS]
    b, s = len(prompts), eng.s_cap
    tokens_np = np.zeros((b, s), np.int32)
    for i, p in enumerate(prompts):
        tokens_np[i, :len(p)] = p
    tokens = torch.from_numpy(tokens_np).cuda()
    lengths = torch.tensor(DECODE_PROMPTS, dtype=torch.int32, device="cuda")

    first, rows0 = [], []
    for i, p in enumerate(prompts):  # each admission emits its slot's first token
        first.append(eng.admit(i, p, DECODE_STEPS + 1))
        rows0.append(eng.last_logits[i].float())
    eng_logits = [torch.stack(rows0)]
    stream = [torch.tensor(first, dtype=torch.int32, device="cuda")]
    for _ in range(1, DECODE_STEPS):
        nxt = eng.step()
        eng_logits.append(eng.last_logits.float().clone())
        stream.append(torch.from_numpy(nxt.astype(np.int32)).cuda())
    for i in range(b):
        eng.evict(i)
    eng_tokens = torch.stack(stream, dim=1)  # [B, steps]

    cp = decode.compute_params(params, mc, torch.device("cuda"))
    k1_before = fa.launches["flash_fwd"]
    sound_logits = _contiguous_stream(torch, decode, cp, mc, tokens, lengths, stream)
    k1_prefill = fa.launches["flash_fwd"] - k1_before
    rels, clear = [], torch.ones(b, DECODE_STEPS, dtype=torch.bool, device="cuda")
    for step, (lc, le) in enumerate(zip(sound_logits, eng_logits)):
        if not (torch.isfinite(lc).all() and lc.shape == (b, mc.vocab_size)):
            fail(f"decode step {step}: contiguous logits not finite or of shape {tuple(lc.shape)}")
        rel = _row_rel_l2(lc, le)
        rels.append(rel)
        if rel > ENGINE_LOGIT_GATE:
            fail(f"decode step {step}: contiguous vs paged logits rel L2 {rel:.3e}")
        top2 = le.topk(2, dim=-1).values
        clear[:, step] = (top2[:, 0] - top2[:, 1]) > 2 * float((lc - le).abs().max())
        if (clear[:, step] & (lc.argmax(-1) != le.argmax(-1))).any():
            fail(f"decode step {step}: greedy tokens differ where the top-2 margin is clear")

    gen_tokens, gen_len = decode.generate(params, tokens, lengths, mc, DECODE_STEPS)
    generated = torch.stack([gen_tokens[i, DECODE_PROMPTS[i]:DECODE_PROMPTS[i] + DECODE_STEPS]
                             for i in range(b)]).to(eng_tokens.dtype)
    unclear = (~clear).float()
    held = torch.where(unclear.any(1), unclear.argmax(1),
                       torch.full_like(unclear[:, 0], DECODE_STEPS).long())
    for i in range(b):
        n = int(held[i])
        if not torch.equal(generated[i, :n], eng_tokens[i, :n]):
            fail(f"decode row {i}: generate's tokens differ from the engine's in the first "
                 f"{n} steps, where every margin is clear")
    if gen_len.tolist() != [n + DECODE_STEPS for n in DECODE_PROMPTS]:
        fail(f"generate returned lengths {gen_len.tolist()}")

    sound_write, faulty_write = _cache_write_one_past(decode)
    decode._write_cache = faulty_write
    try:
        fault_logits = _contiguous_stream(torch, decode, cp, mc, tokens, lengths, stream)
    finally:
        decode._write_cache = sound_write
    fault_rels = [_row_rel_l2(lf, le) for lf, le in zip(fault_logits, eng_logits)]
    if max(fault_rels) <= ENGINE_LOGIT_GATE:
        fail(f"the logit gate {ENGINE_LOGIT_GATE} misses a cache written one past the "
             f"cursor (largest reading {max(fault_rels):.3e})")

    fn = decode.make_cached_generate_fn(mc, params)
    times = {}
    for n in (1, DECODE_STEPS):
        fn.many(tokens, lengths, n)  # warm
        reps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn.many(tokens, lengths, n)
            torch.cuda.synchronize()
            reps.append(time.perf_counter() - t0)
        times[n] = statistics.median(reps)
    step_s = (times[DECODE_STEPS] - times[1]) / (DECODE_STEPS - 1)
    rec = {"rows": b, "prompt_lengths": list(DECODE_PROMPTS), "steps": DECODE_STEPS,
           "cache_width": s, "worst_logit_rel_l2": max(rels), "logit_gate": ENGINE_LOGIT_GATE,
           "logit_rel_l2_by_step": rels,
           "tokens_held_equal_clear_margin": int(clear.sum()),
           "rows_generate_equal_engine_all_steps": int(sum(
               torch.equal(generated[i], eng_tokens[i]) for i in range(b))),
           "planted_fault_rel_l2_max": max(fault_rels),
           "planted_fault_steps_over_gate": sum(r > ENGINE_LOGIT_GATE for r in fault_rels),
           "planted_fault_rel_l2_by_step": fault_rels,
           "k1_launches_one_prefill": k1_prefill,
           "many_1_s": times[1], f"many_{DECODE_STEPS}_s": times[DECODE_STEPS],
           "decode_step_s": step_s, "decode_tokens_per_s": b / step_s if step_s > 0 else None}
    log("decode_phase " + json.dumps(rec))
    log(f"contiguous decode: {rec['decode_tokens_per_s']:.1f} tokens/s "
        f"({b} rows, {step_s * 1e3:.2f} ms a step)")
    del eng, fn, cp, sound_logits, fault_logits, eng_logits
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 9: converting a corpus and evaluating a checkpoint
# ---------------------------------------------------------------------------

#: the eval phase's cut of the v0.3 gauntlet: rows a task, and val batches
EVAL_MAX_ROWS = 16
EVAL_BATCHES = 2


def _timed(times: dict, name: str, torch, fn):
    """``fn``, adding the seconds of each call (the device synchronized
    after it) to ``times[name]``; patched in from outside the package."""
    def wrapped(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.synchronize()
            times[name] = times.get(name, 0.0) + time.perf_counter() - t

    return wrapped


def _run_cli(main_fn, args: list[str]):
    """A CLI's ``main`` in process: (what it returns, the last line it
    printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main_fn(args)
    return ret, buf.getvalue().strip().splitlines()[-1]


def _eval_forwards(args: list[str]) -> dict:
    """The eval's forward passes, counted from the suite itself: one a
    val batch; one per 16 (row, option) items of a multiple-choice or
    schema task and per 16 rows of a language-modeling task; one prefill
    per 16 rows of a generation task (the decode steps run no K1)."""
    from photon_tpu_torch.eval.gauntlet import GauntletConfig, TaskSuite

    opt = dict(zip(args[::2], args[1::2]))
    suite = TaskSuite.from_yaml(opt["--tasks-yaml"], root_dir=opt["--tasks-root"])
    tasks, _ = suite.load_tasks(GauntletConfig.from_yaml(opt["--gauntlet-yaml"]).labels_fewshot())
    rows_cap = int(opt["--icl-max-rows"])
    scored = generated = 0
    for t in tasks:
        rows = t.rows[:rows_cap]
        if t.kind == "multiple_choice":
            n = sum(len(r["choices"]) for r in rows)
        elif t.kind == "schema":
            n = sum(len(r["context_options"]) for r in rows)
        else:
            n = len(rows)
        if t.kind == "generation_task_with_answers":
            generated += -(-n // 16)
        else:
            scored += -(-n // 16)
    return {"val": int(opt["--eval-batches"]), "scored": scored, "generation_prefills": generated,
            "tasks": len(tasks)}


def eval_phase(torch, cfg, fed):
    """The offline data pipeline and the eval CLI at full width, each
    through its CLI's ``main`` in process (as a user's ``python -m``
    would run it, less the process start):

    (a) ``photon_tpu_torch.data.convert`` over the repo's own markdown
        files (byte-fallback, ``--split val``, 2 clients, seq 2048, the
        freq dicts counted on the card): each client must hold at least
        one global batch;
    (b) ``photon_tpu_torch.eval`` on the federated phase's latest round,
        with ``--dataset`` on that set (``EVAL_BATCHES`` global batches)
        and the v0.3 gauntlet from the port's YAMLs over the committed
        task data, ``EVAL_MAX_ROWS`` rows a task, the launch counts set to
        0 just before it: a finite val loss, every accuracy and gauntlet
        score in [0, 1], and K1 launched ``n_layers`` times per forward pass
        of the eval by the counters. The checkpoint load, the ``Trainer``,
        the val loss and the gauntlet are timed (wrappers patched in from
        outside the package). No ``torch.profiler`` window: reading its
        trace took ~35 s of the phase, cut to keep the smoke within its
        time once phase 18 joined (K1 at this shape is timed in phase 2)."""
    from photon_tpu_torch.data import ShardedDataset, convert
    from photon_tpu_torch.eval import __main__ as eval_cli
    from photon_tpu_torch.eval import gauntlet
    from photon_tpu_torch.ops import flash_attention as fa
    from photon_tpu_torch.train.trainer import Trainer

    work = ROOT / ".chip_smoke" / "eval"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    L = cfg.model.n_layers
    t0 = time.perf_counter()
    texts = sorted(str(p) for p in ROOT.glob("*.md"))
    summary, line = _run_cli(convert.main, [
        "--text-files", *texts, "--tokenizer", "byte-fallback", "--out", str(work / "data"),
        "--n-clients", "2", "--seq-len", str(cfg.model.max_seq_len), "--split", "val"])
    convert_s = time.perf_counter() - t0
    if json.loads(line) != summary:
        fail(f"convert printed {line}, returned {summary}")
    sizes = [len(ShardedDataset(work / "data" / f"client_{i}" / "val")) for i in range(2)]
    if min(sizes) < cfg.train.global_batch_size:
        fail(f"converted clients hold {sizes} samples, under one global batch "
             f"({cfg.train.global_batch_size})")

    cfg_path = work / "eval.yaml"
    cfg.to_yaml(cfg_path)
    configs = ROOT / "photon_tpu_torch" / "eval" / "configs"
    args = ["--store", fed["store"], "--run", fed["run_uuid"], "--round", "-1",
            "--config", str(cfg_path), "--dataset", str(work / "data"), "--split", "val",
            "--eval-batches", str(EVAL_BATCHES),
            "--tasks-yaml", str(configs / "tasks_v0.3.yaml"),
            "--gauntlet-yaml", str(configs / "eval_gauntlet_v0.3.yaml"),
            "--tasks-root", str(ROOT / "photon_tpu" / "eval" / "local_data"),
            "--icl-max-rows", str(EVAL_MAX_ROWS), "--device", "cuda"]
    forwards = _eval_forwards(args)
    n_fwd = forwards["val"] + forwards["scored"] + forwards["generation_prefills"]
    want = {"flash_fwd": L * n_fwd, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    times: dict[str, float] = {}
    timed = [(eval_cli, "load_params", "load_checkpoint"), (Trainer, "__init__", "trainer"),
             (Trainer, "evaluate", "val_loss"), (gauntlet, "run_gauntlet_suite", "gauntlet")]
    sound = [(obj, name, getattr(obj, name)) for obj, name, _ in timed]
    for obj, name, label in timed:
        setattr(obj, name, _timed(times, label, torch, getattr(obj, name)))

    times.clear()
    for key in fa.launches:  # the counted run starts here
        fa.launches[key] = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        out, line = _run_cli(eval_cli.main, args)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    finally:
        for obj, name, fn in sound:
            setattr(obj, name, fn)
    launches = dict(fa.launches)
    if launches != want:
        fail(f"the eval launched {launches}, want {want} ({n_fwd} forwards)")
    line = json.loads(line)
    if set(line) != set(out) or not all(abs(line[k] - round(out[k], 6)) < 1e-9 for k in line):
        fail("the eval CLI's printed line differs from its result")
    if not math.isfinite(out.get("eval/loss", float("nan"))):
        fail(f"eval loss {out.get('eval/loss')}")
    scores = {k: v for k, v in out.items()
              if k.endswith("/accuracy") or (k.startswith("gauntlet/") and "skipped" not in k
                                             and "missing" not in k)}
    accs = [k for k in scores if k.endswith("/accuracy")]
    if len(accs) != forwards["tasks"] or not all(0.0 <= v <= 1.0 for v in scores.values()):
        fail(f"eval scores out of [0, 1] or tasks missing: {scores}")
    rec = {"convert": dict(summary, client_samples=sizes, wall_s=convert_s),
           "forwards": forwards, "launches": launches, "cli_wall_s": cli_s, "timed_s": times,
           "device_busy_ms": "not measured",
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "eval_loss": out["eval/loss"], "eval_tokens": out["eval/tokens"],
           "gauntlet_average": out.get("gauntlet/average"),
           "icl_max_rows": EVAL_MAX_ROWS, "eval_batches": EVAL_BATCHES, "result": out}
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 10: every preset that one card trains
# ---------------------------------------------------------------------------

#: the JAX package's presets, each at full width and depth on one H100;
#: mpt-7b in bf16 parameters (its fp32 weights, gradients and AdamW moments
#: need ~107 GB; in bf16 ~53 GB)
PRESETS = ("mpt-350m", "mpt-760m", "mpt-1b", "llama-1b", "mpt-3b", "mpt-125m-moe8", "mpt-7b")
MOE_PRESET = "mpt-125m-moe8"
BF16_PRESET = "mpt-7b"
PRESET_STEPS = 3
#: random weights (std 0.02) give near-uniform logits: the step-0 loss
#: sits near ln(vocab), plus the MoE aux (~0.01 a layer)
LOSS_LN_VOCAB_TOL = 1.5


def preset_config(name: str):
    """The preset at full width and depth: synthetic data, no checkpoint
    (a 3B one writes ~32 GB; resume is gated at 125M), one eval batch, and
    the global batch cut for time to 2 microbatches of the preset's own;
    mpt-3b runs ``device_microbatch_size: auto`` over a global batch of 8;
    mpt-7b runs ``model.param_dtype: bfloat16`` over one microbatch of 8 (a
    second would add a 26.6 GB fp32 gradient sum and promote the AdamW
    moments to fp32, as the JAX package does: 80 GB would not hold it)."""
    from photon_tpu_torch.config import load_preset

    cfg = load_preset(name)
    cfg.run_uuid = f"chip-smoke-{name}"
    if name == "mpt-3b":
        cfg.train.global_batch_size, cfg.train.device_microbatch_size = 8, "auto"
    elif name == BF16_PRESET:
        cfg.model.param_dtype = "bfloat16"
        cfg.train.global_batch_size = cfg.train.device_microbatch_size = 8
    else:
        cfg.train.global_batch_size = 2 * cfg.train.device_microbatch_size
    cfg.dataset.synthetic = True
    cfg.photon.checkpoint = False
    cfg.train.eval_batches = 1
    return cfg.validate()


def presets_phase(torch, fa):
    """``photon_tpu_torch.centralized.main`` in process for each of
    ``PRESETS``: ``PRESET_STEPS`` steps then the final eval, the launch
    counts set to 0 and the peak memory reset just before each. Per preset:
    the step wall (median of steps 1–2, the History's ``client/fit_time``),
    tokens/s, MFU (``model_flops_per_token``, which counts an MoE MLP as one
    dense MLP), peak memory, the microbatch ``auto`` chose (its probe timed
    and counted by a wrapper patched in from outside the package), and
    K1–K3 launches, which must be exact: K1 twice per layer per microbatch
    under remat (the forward and the recompute), K2 = K3 once, plus one K1
    per layer for the eval batch and the probe's own step. The step-0 loss
    must be finite and within ``LOSS_LN_VOCAB_TOL`` of ln(vocab). Each
    preset's trainer is freed before the next. mpt-7b (bf16 parameters)
    also gates its dtype map (:func:`bf16_dtype_map_gate`) and records one
    more step under the profiler (the idle share). Returns the records and
    the moe8 run's final parameters (``--dump-params``)."""
    import gc

    from photon_tpu_torch import centralized
    from photon_tpu_torch.train.trainer import Trainer
    from photon_tpu_torch.utils.profiling import model_flops_per_token

    work = ROOT / ".chip_smoke" / "presets"
    shutil.rmtree(work, ignore_errors=True)
    sound_probe = Trainer._probe_microbatch
    probes: list[dict] = []

    def counted_probe(self, *args):
        before = dict(fa.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        micro = sound_probe(self, *args)
        probes.append({"microbatch": micro, "probe_s": time.perf_counter() - t0,
                       "launches": {k: fa.launches[k] - before[k] for k in before}})
        return micro

    sound_init = Trainer.__init__
    trainers: list = []

    def recorded_init(self, *args, **kwargs):
        sound_init(self, *args, **kwargs)
        trainers.append(self)

    records, moe_params = {}, None
    Trainer._probe_microbatch = counted_probe
    Trainer.__init__ = recorded_init
    try:
        for name in PRESETS:
            cfg = preset_config(name)
            mc, L = cfg.model, cfg.model.n_layers
            d = work / name
            cfg.photon.save_path = str(d)
            cfg.to_yaml(d / "in.yaml")
            args = ["--config", str(d / "in.yaml"), "--device", "cuda",
                    "--steps", str(PRESET_STEPS)]
            if name == MOE_PRESET:
                args.append("--dump-params")
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            probes.clear()
            trainers.clear()
            for key in fa.launches:  # the counted run starts here
                fa.launches[key] = 0
            t0 = time.perf_counter()
            history, _ = _run_cli(centralized.main, args)
            wall = time.perf_counter() - t0
            launches = dict(fa.launches)  # the counted run ends here
            peak = torch.cuda.max_memory_allocated()
            auto = cfg.train.device_microbatch_size == "auto"
            probe = probes[0] if auto else None
            micro = probe["microbatch"] if auto else cfg.train.device_microbatch_size
            n_micro = cfg.train.global_batch_size // micro
            fwd = 2 if mc.remat else 1
            per_step = {"flash_fwd": fwd * L * n_micro, "flash_bwd_dq": L * n_micro,
                        "flash_bwd_dkv": L * n_micro}
            want = {k: PRESET_STEPS * v for k, v in per_step.items()}
            want["flash_fwd"] += L * cfg.train.eval_batches
            if auto:
                first = 1 << (cfg.train.global_batch_size.bit_length() - 1)
                if micro == first and probe["launches"] != per_step:
                    fail(f"preset {name}: the auto probe launched {probe['launches']}, "
                         f"want one step's {per_step}")
                want = {k: v + probe["launches"][k] for k, v in want.items()}
            if launches != want:
                fail(f"preset {name}: launched {launches}, want {want} "
                     f"(remat {mc.remat}, {n_micro} microbatches of {micro})")
            losses = [v for _, v in history.series("loss")]
            walls = [v for _, v in history.series("client/fit_time")]
            ln_v = math.log(mc.vocab_size)
            if len(losses) != PRESET_STEPS or not all(math.isfinite(x) for x in losses) \
                    or abs(losses[0] - ln_v) > LOSS_LN_VOCAB_TOL:
                fail(f"preset {name}: losses {losses}, want finite and the first within "
                     f"{LOSS_LN_VOCAB_TOL} of ln(vocab) {ln_v:.3f}")
            eval_loss = history.latest("eval/loss")
            if eval_loss is None or not math.isfinite(eval_loss):
                fail(f"preset {name}: eval loss {eval_loss}")
            step_s = statistics.median(walls[1:])
            tokens = cfg.train.global_batch_size * mc.max_seq_len
            fpt = model_flops_per_token(mc)
            rec = {
                "preset": name, "d_model": mc.d_model, "n_layers": L, "n_heads": mc.n_heads,
                "n_kv_heads": mc.kv_heads, "d_head": mc.d_head, "mlp": mc.mlp, "remat": mc.remat,
                "optimizer": cfg.optimizer.name, "global_batch": cfg.train.global_batch_size,
                "microbatch": micro, "auto_microbatch": probe, "n_micro": n_micro,
                "tokens_per_step": tokens, "losses": losses, "eval_loss": eval_loss,
                "ln_vocab": ln_v, "step_wall_s": walls, "step_s_median_steps_1_2": step_s,
                "tokens_per_s": tokens / step_s, "flops_per_token": fpt,
                "mfu": tokens / step_s * fpt / PEAK_FLOPS["bfloat16"],
                "max_memory_allocated_gb": peak / 1e9, "launches": launches,
                "cli_wall_s": wall,
            }
            if name == BF16_PRESET:
                import numpy as np

                trainer = trainers[-1]
                rec["param_dtype"] = mc.param_dtype
                rec["dtype_map"] = bf16_dtype_map_gate(torch, trainer)
                batch = np.random.default_rng(0).integers(
                    0, mc.vocab_size, (cfg.train.global_batch_size, mc.max_seq_len))
                rec["profiled_step"] = _profiled_step(
                    torch, lambda: trainer.train_batch(batch), step_s)
                rec["max_memory_allocated_gb_with_profiled_step"] = \
                    torch.cuda.max_memory_allocated() / 1e9
                del trainer, batch
            trainers.clear()
            if mc.mlp == "moe":
                rec["mfu_note"] = ("model_flops_per_token counts the MoE MLP as one dense MLP: "
                                   f"top-{mc.moe_top_k} runs {mc.moe_top_k}x those FLOPs")
                from photon_tpu_torch.checkpoint.serialization import npz_to_arrays
                from photon_tpu_torch.codec.params import params_from_numpy

                meta, arrays = npz_to_arrays((d / "params_final.npz").read_bytes())
                moe_params = params_from_numpy(meta.names, arrays, mc, "cuda")
                del arrays
            log("preset " + json.dumps(rec))
            records[name] = rec
            del history
            shutil.rmtree(d, ignore_errors=True)
    finally:
        Trainer._probe_microbatch = sound_probe
        Trainer.__init__ = sound_init
        trainers.clear()
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return records, moe_params


# ---------------------------------------------------------------------------
# the native host helpers
# ---------------------------------------------------------------------------

#: bytes of the memcpy comparison (one full-width 7B bf16 stacked kernel is
#: 4.3 GB; a 125M fp32 payload 0.5 GB)
MEMCPY_BYTES = 1 << 30
MEMCPY_REPS = 3


def native_phase(np) -> dict:
    """The native library: built from the port's source (it must be: a
    silent fallback fails the smoke), each helper checked against numpy or
    zlib, and one ``MEMCPY_BYTES`` copy timed three ways, the median of
    ``MEMCPY_REPS``: ``native.parallel_memcpy``, ``np.copyto`` and the shm
    plane's thread-pool copy (its path without the library). Host
    memory and cores only: the card takes no part."""
    import zlib

    from photon_tpu_torch import native
    from photon_tpu_torch.shm import plane

    t0 = time.perf_counter()
    if not native.available():
        fail(f"the native library did not build: {native.build_error}")
    rec = {"library": str(native.library_path().relative_to(ROOT)),
           "load_s": time.perf_counter() - t0}
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, 1 << 16, 2048, dtype=np.uint16) for _ in range(16)]
    out = np.empty((16, 2048), np.int32)
    native.gather_rows(rows, out)
    data = rng.integers(0, 255, 1 << 20, dtype=np.uint8)
    if not (np.array_equal(out, np.stack(rows).astype(np.int32))
            and native.crc32(data) == zlib.crc32(data.tobytes())):
        fail("native gather_rows or crc32 parts from numpy/zlib")
    src = np.resize(np.arange(251, dtype=np.uint8), MEMCPY_BYTES)
    dst = np.zeros_like(src)  # touched: page faults stay out of the timings
    ways = {
        "native_parallel_memcpy": lambda: native.parallel_memcpy(dst, src),
        "np_copyto": lambda: np.copyto(dst, src),
        "shm_thread_pool": lambda: plane._pool_copy(memoryview(dst), memoryview(src)),
    }
    for way, fn in ways.items():
        times = []
        for _ in range(MEMCPY_REPS):
            dst[:: 1 << 20] = 0
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
            if not np.array_equal(dst[:: 4099], src[:: 4099]):
                fail(f"{way} copied wrong bytes")
        med = statistics.median(times)
        rec[way] = {"s": times, "median_s": med, "gb_per_s": MEMCPY_BYTES / med / 1e9}
    rec.update(bytes=MEMCPY_BYTES, host_cores=os.cpu_count(), threads=native._N_THREADS)
    del src, dst
    log("native " + json.dumps(rec))
    return rec


def _bf16_dtype_rule(name: str) -> str:
    """The JAX tree's dtype for ``name`` under ``param_dtype: bfloat16``: a
    norm's scale or bias fp32 (``FP32LayerNorm``/``FP32RMSNorm`` take no
    ``param_dtype``), every other leaf bf16. An AdamW moment follows its
    parameter (optax's ``mu_dtype=None``, one microbatch)."""
    return "float32" if "/ln_" in "/" + name else "bfloat16"


def _dtype_map_faults(params: dict, moments: dict) -> list[str]:
    """Every parameter or moment whose dtype parts from
    :func:`_bf16_dtype_rule` (``moments``: parameter name → its moments'
    dtypes)."""
    bad = [f"{n}: {d}" for n, d in params.items() if d != _bf16_dtype_rule(n)]
    bad += [f"moment of {n}: {d}" for n, ds in moments.items() for d in ds
            if d != _bf16_dtype_rule(n)]
    return bad


def bf16_dtype_map_gate(torch, trainer) -> dict:
    """The dtype map of a bf16-parameter trainer after its steps, exact:
    every parameter bf16 but the norm scales, every AdamW moment its
    parameter's dtype. Checked first on the same map with one norm scale
    made bf16, which must fail it (the planted fault)."""
    from photon_tpu_torch.codec.params import flatten

    name = lambda t: str(t.dtype).removeprefix("torch.")  # noqa: E731
    params = {n: name(p) for n, p in flatten(trainer.state.params).items()}
    moments = {n: [name(trainer.state.opt_state[k]) for k in trainer.tx.moment_names(n)]
               for n in params}
    norm = next(n for n in params if n.endswith("ln_f/scale"))
    if not _dtype_map_faults(dict(params, **{norm: "bfloat16"}), moments):
        fail("bf16 dtype map gate: a bf16 norm scale passes it")
    bad = _dtype_map_faults(params, moments)
    if bad:
        fail(f"bf16 dtype map: {bad[:8]}")
    counts = {}
    for n, d in params.items():
        counts[d] = counts.get(d, 0) + 1
    return {"params_by_dtype": counts,
            "fp32_params": sorted(n for n, d in params.items() if d == "float32"),
            "moment_dtypes": sorted({d for ds in moments.values() for d in ds}),
            "planted_bf16_norm_scale_fails": True}


def d128_grad_gate(torch, fa, np):
    """:func:`grad_gate` at mpt-1b's full width (d2048, 24 layers, 16 heads
    of D=128, remat) on one microbatch of the preset's 4 × 2048 tokens: the
    first time K2/K3 gradients at D=128 reach a real model's parameters.
    The sound run must hold ``TRAIN_GRAD_GATE`` and the planted fault read
    at least ``FED_FAULT_RATIO`` times it and over the gate."""
    from photon_tpu_torch.models.mpt import init_params

    cfg = preset_config("mpt-1b")
    cfg.train.global_batch_size = cfg.train.device_microbatch_size  # one microbatch
    params = init_params(cfg.model, seed=0, device="cuda")
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.model.vocab_size, (
        cfg.train.global_batch_size, cfg.model.max_seq_len))).long().cuda()
    rec = grad_gate(torch, fa, cfg, params, tokens)
    sound, fault = rec["sound"]["worst"], rec["planted_fault"]["worst"]
    rec["fault_over_sound"] = fault / sound if sound > 0 else None
    log("d128_grad_gate " + json.dumps(rec))
    if sound > TRAIN_GRAD_GATE:
        fail(f"mpt-1b kernel vs plain step: {sound:.3e} > {TRAIN_GRAD_GATE}")
    if fault <= TRAIN_GRAD_GATE or fault < FED_FAULT_RATIO * sound:
        fail(f"mpt-1b: the shifted-offset fault reads {fault:.3e}, not over the gate and "
             f"{FED_FAULT_RATIO}x the sound {sound:.3e}")
    del params, tokens
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 11: MoE dispatch and the MoE engine
# ---------------------------------------------------------------------------

#: index-based vs dense MoE MLP at one moe8 layer's shapes: bf16 outputs
#: (relative L2) and the aux loss (absolute)
MOE_OUT_GATE = 1e-2
MOE_AUX_GATE = 1e-6


def _token_major_claims(torch):
    """A planted fault, patched in from outside the package: capacity
    claimed token by token (both of a token's choices before the next
    token's) instead of slot-major."""
    def faulty(oh):
        k, n, e = oh.shape
        flat = oh.transpose(0, 1).reshape(n * k, e)
        return (torch.cumsum(flat, dim=0) - flat).reshape(n, k, e).transpose(0, 1)

    return faulty


def moe_dispatch_gate(torch, np, params, mc):
    """``ops/moe.py::moe_mlp`` (index-based) against ``moe_mlp_plain`` (the
    dense one-hot formulation) at one moe8 layer's full shapes: N = 8 × 2048
    tokens (the preset's microbatch), D = 768, H = 3072, E = 8, top-2,
    cf 1.25, bf16 activations drawn from a seed, layer 0 of the presets
    phase's moe8 weights (fp32 router). The (token, expert, position) kept
    sets must be equal exactly, the outputs within ``MOE_OUT_GATE`` and the
    aux within ``MOE_AUX_GATE``; capacity claimed token-major must break
    the set gate. Times both (CUDA events) and lists the index path's
    device time by kernel (``torch.profiler``, one call)."""
    from photon_tpu_torch.models.decode import compute_params, layer_params
    from photon_tpu_torch.ops import moe

    lp = layer_params(compute_params(params, mc, torch.device("cuda")), 0)
    n, d = 8 * mc.max_seq_len, mc.d_model
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((n, d), device="cuda", generator=gen).to(torch.bfloat16)
    w = dict(w_up=lp["moe_up"], w_down=lp["moe_down"], w_gate=lp.get("moe_gate"))
    kw = dict(top_k=mc.moe_top_k, capacity_factor=mc.moe_capacity_factor)
    e = lp["router"].shape[-1]
    cap = moe.expert_capacity(n, e, mc.moe_top_k, mc.moe_capacity_factor)
    probs = torch.softmax(x.float() @ lp["router"].float(), dim=-1)

    def index_keys():
        r = moe.route(probs, mc.moe_top_k, cap)
        tok = torch.arange(n, device="cuda").expand_as(r.expert)
        keys = (tok * e + r.expert) * cap + r.position
        return torch.sort(keys[r.kept]).values, r

    with torch.no_grad():
        got, r = index_keys()
        dispatch, _, _ = moe.route_plain(probs, mc.moe_top_k, cap)
        want = torch.sort(torch.nonzero(dispatch.reshape(-1))[:, 0]).values
        del dispatch
        sets_equal = torch.equal(got, want)
        overflowed = int((~r.kept).sum())
        sound_claims = moe.claim_positions
        moe.claim_positions = _token_major_claims(torch)
        try:
            fault_keys, _ = index_keys()
        finally:
            moe.claim_positions = sound_claims
        fault_equal = torch.equal(fault_keys, want)
        out, aux = moe.moe_mlp(x, lp["router"], **w, **kw)
        ref, aux_ref = moe.moe_mlp_plain(x, lp["router"], **w, **kw)
        rel = _rel_l2(out.float(), ref.float())
        aux_d = abs(float(aux) - float(aux_ref))
        flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
        t_index = _time_ms(torch, lambda: moe.moe_mlp(x, lp["router"], **w, **kw), flush, reps=5)
        t_plain = _time_ms(torch, lambda: moe.moe_mlp_plain(x, lp["router"], **w, **kw), flush,
                           reps=3, warm=1)
        del flush
        with _profiled(torch) as prof:
            moe.moe_mlp(x, lp["router"], **w, **kw)
        by_kernel = sorted(((e.key[:80], e.self_device_time_total / 1e3) for e in prof.key_averages()
                            if str(getattr(e, "device_type", "")).endswith("CUDA")
                            and (getattr(e, "self_device_time_total", 0.0) or 0.0) > 0),
                           key=lambda kv: -kv[1])
    rec = {"N": n, "D": d, "H": mc.hidden, "E": e, "top_k": mc.moe_top_k,
           "capacity_factor": mc.moe_capacity_factor, "capacity": cap,
           "kept": int(got.numel()), "overflowed_assignments": overflowed,
           "sets_equal": sets_equal, "out_rel_l2": rel, "out_gate": MOE_OUT_GATE,
           "aux_abs_diff": aux_d, "aux_gate": MOE_AUX_GATE, "aux": float(aux),
           "token_major_fault_sets_equal": fault_equal,
           "token_major_fault_kept": int(fault_keys.numel()),
           "index_ms": t_index, "dense_plain_ms": t_plain,
           "index_device_ms_by_kernel": by_kernel[:8] or "not measured",
           "finite": bool(torch.isfinite(out).all())}
    log("moe_dispatch_gate " + json.dumps(rec))
    if not (sets_equal and rec["finite"] and rel <= MOE_OUT_GATE and aux_d <= MOE_AUX_GATE):
        fail(f"MoE index dispatch vs dense: sets equal {sets_equal}, out rel L2 {rel:.3e}, "
             f"aux diff {aux_d:.3e}")
    if fault_equal:
        fail("the MoE set gate misses capacity claimed token-major")
    del x, out, ref, probs, lp
    torch.cuda.empty_cache()
    return rec


#: the MoE engine phase's prompts (8 slots; the two longest are split into
#: chunks by the 512-token prefill budget) and its greedy steps
MOE_ENGINE_PROMPTS = (16, 100, 250, 400, 512, 600, 900, 1300)
MOE_ENGINE_STEPS = 32


def _moe_engine_pair(torch, rpa, np, params, compute_dtype: str, gated: bool) -> dict:
    """Two ``PagedEngine``s on the moe8 weights, ``attention_impl`` ragged
    (K4) and gather, stepped through one mixed chunked-prefill schedule on
    one token stream (the ragged engine's): ``MOE_ENGINE_PROMPTS``, the
    512-token prefill budget, ``MOE_ENGINE_STEPS`` greedy tokens each. K4
    must launch ``n_layers`` times a step and twice that with a chunk.
    With ``gated``, each emitting step's logits must hold ``ENGINE_LOGIT_GATE``
    and greedy tokens agree on clear margins (:func:`_compare_logits`);
    otherwise the readings are only recorded. Either way it counts the
    (layer, token, slot) assignments whose kept expert differs between the
    two engines (``ops.moe.route`` wrapped from outside the package)."""
    import copy

    from photon_tpu_torch.ops import moe
    from photon_tpu_torch.serve.engine import PagedEngine

    cfg = serve_config(MOE_PRESET)
    cfg.model.compute_dtype = compute_dtype
    L, vocab = cfg.model.n_layers, cfg.model.vocab_size
    cfg_r, cfg_g = copy.deepcopy(cfg), copy.deepcopy(cfg)
    cfg_r.photon.serve.attention_impl = "ragged"
    cfg_g.photon.serve.attention_impl = "gather"
    eng_r = PagedEngine(cfg_r, params, device="cuda")
    eng_g = PagedEngine(cfg_g, params, device="cuda")
    rng = np.random.default_rng(6)
    budget = cfg.photon.serve.prefill_token_budget
    for slot, n in enumerate(MOE_ENGINE_PROMPTS):
        prompt = list(map(int, rng.integers(0, vocab, n)))
        for eng in (eng_r, eng_g):
            eng.begin(slot, prompt, MOE_ENGINE_STEPS)
    running = dict.fromkeys(range(len(MOE_ENGINE_PROMPTS)), 0)  # slot -> tokens emitted
    rec = dict.fromkeys(("steps", "chunk_steps", "clear", "same", "compared", "flips",
                         "routed"), 0)
    rels = []
    sound_route, seen = moe.route, []

    def recorded_route(*a, **kw):
        r = sound_route(*a, **kw)
        seen.append(r.expert.masked_fill(~r.kept, -1))
        return r

    moe.route = recorded_route
    rpa.launches = 0  # the counted run starts here
    t0 = time.perf_counter()
    try:
        while running:
            pre = [s for s in running if eng_r.pending_tokens(s) > 0]
            chunk = (pre[0], min(eng_r.pending_tokens(pre[0]), budget)) if pre else None
            _, emitted = eng_r.mixed_step(chunk)
            eng_g.mixed_step(chunk)
            if seen:  # the ragged engine's L routings, then the gather engine's
                rec["flips"] += sum(int((x != y).sum()) for x, y in zip(seen[:L], seen[L:]))
                rec["routed"] += sum(int((x >= 0).sum()) for x in seen[:L])
                seen.clear()
            if emitted.any():
                rows = torch.from_numpy(np.flatnonzero(emitted)).to("cuda")
                lr, lg = eng_r.last_logits[rows].float(), eng_g.last_logits[rows].float()
                if not (torch.isfinite(lr).all() and lr.shape == (len(rows), vocab)):
                    fail(f"MoE engine step {rec['steps']}: logits not finite or of shape "
                         f"{tuple(lr.shape)}")
                rels.append(_rel_l2(lr, lg))
                rec["same"] += int((lr.argmax(-1) == lg.argmax(-1)).sum())
                rec["compared"] += len(rows)
                if gated:
                    rec["clear"] += _compare_logits(torch, np, eng_r, eng_g, emitted, vocab,
                                                    rec["steps"])[1]
            eng_g._last[:] = eng_r._last  # one token stream
            rec["steps"] += 1
            rec["chunk_steps"] += chunk is not None
            for s in [s for s in running if emitted[s]]:
                running[s] += 1
                if running[s] == MOE_ENGINE_STEPS:
                    for eng in (eng_r, eng_g):
                        eng.evict(s)
                    del running[s]
    finally:
        moe.route = sound_route
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rpa.launches
    want = L * (rec["steps"] + rec["chunk_steps"])
    if launches != want or launches == 0:
        fail(f"MoE engine ({compute_dtype}) launched K4 {launches} times, want {want}")
    del eng_r, eng_g
    torch.cuda.empty_cache()
    return {"compute_dtype": compute_dtype, "gated": gated, "steps": rec["steps"],
            "chunk_steps": rec["chunk_steps"], "launches": launches,
            "worst_logit_rel_l2": max(rels), "logit_gate": ENGINE_LOGIT_GATE,
            "steps_over_gate": sum(r > ENGINE_LOGIT_GATE for r in rels),
            "emitting_steps": len(rels), "rel_l2_by_step": rels,
            "greedy_equal": rec["same"], "greedy_compared": rec["compared"],
            "greedy_rows_held_equal_clear_margin": rec["clear"] if gated else None,
            "routing_assignments_kept": rec["routed"],
            "routing_assignments_differing": rec["flips"],
            "wall_s_two_engines": wall}


def moe_engine_phase(torch, rpa, np, params):
    """The moe8 weights the presets phase trained through
    :func:`_moe_engine_pair`, gated in fp32 compute and recorded in the
    preset's bf16. Both engines route each step's ``n_slots · Tq`` tokens in
    one pool, so their routing differs only where K4's and the gather's
    attention outputs differ. In bf16 that difference flips near-tie top-k
    choices, and a flipped expert moves a token's whole MLP output, which
    the next layers and steps carry on: the bf16 pair is recorded, not held
    to the logit gate (nor is contiguous decode, whose batches differ).
    In fp32 the attention outputs differ by rounding alone."""
    rec = {"prompts": list(MOE_ENGINE_PROMPTS), "greedy_steps": MOE_ENGINE_STEPS,
           "float32": _moe_engine_pair(torch, rpa, np, params, "float32", gated=True),
           "bfloat16": _moe_engine_pair(torch, rpa, np, params, "bfloat16", gated=False)}
    rec["launches"] = rec["float32"]["launches"] + rec["bfloat16"]["launches"]
    log("moe_engine_phase " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# the 1B federated round (python3 chip_smoke.py --fed-1b; not in the smoke)
# ---------------------------------------------------------------------------

FED_1B_ARGS = ["--preset", "mpt-1b", "--nodes", "2", "--rounds", "1", "--device", "cuda",
               "--set", "fl.n_total_clients=2", "--set", "fl.n_clients_per_round=2",
               "--set", "fl.local_steps=1", "--set", "fl.eval_interval_rounds=0",
               "--set", "train.global_batch_size=8", "--set", "dataset.synthetic=true",
               "--set", "photon.checkpoint=false", "--set", "run_uuid=fed-1b"]


# ---------------------------------------------------------------------------
# phase 12: per-cohort LoRA adapters
# ---------------------------------------------------------------------------

ADAPTER_RUN = "chip-smoke-adapters"
#: cohort → client ids; c has none, so it keeps its fresh identity adapter
ADAPTER_COHORTS = {"a": [0, 1], "b": [2, 3], "c": []}
#: the fits' lr, without warmup: four steps must move B visibly (the
#: preset's 6e-4 after a 100-step warmup would leave it at ~1e-5)
ADAPTER_LR = 1e-2
#: one fit step's A/B gradients, kernels vs the plain dense attention:
#: the largest per-factor relative L2 (and the loss's relative difference)
ADAPTER_GRAD_GATE = 4e-2
#: the engine pair's traffic: (cohort, prompt tokens, tokens to emit). The
#: pool holds 2 pages, so c is admitted when a's slot frees and recycles
#: a's page in the middle of the batch
ADAPTER_REQUESTS = (("a", 300, 8), ("b", 700, 24), (None, 150, 24), (None, 1100, 24),
                    ("c", 400, 16))
#: the adapter server's traffic: one prompt of this length under every
#: cohort and none; a templated prompt (a block of tokens repeated, then a
#: suffix) under a, b and b again; 8 requests of these lengths, cohorts
#: a, b, c and none twice over, across the live swap
ADAPTER_SERVE_PROMPT = 200
ADAPTER_TEMPLATE = (64, 4, 16)
ADAPTER_SWAP_PROMPTS = (16, 100, 250, 400, 600, 800, 1100, 1500)


def adapter_config():
    """mpt-125m at full width with the adapters on: rank 8, alpha 16, the
    default targets (``wqkv`` and ``out_proj`` for MPT), cohorts a, b, c
    on a pool of 2 pages; 4 clients × 4 local steps at the training
    phase's batch (32 × 2048 in 2 microbatches)."""
    cfg = train_config()
    cfg.run_uuid = ADAPTER_RUN
    ad = cfg.photon.adapters
    ad.enabled, ad.rank, ad.alpha, ad.pool_size = True, 8, 16.0, 2
    ad.cohorts = {k: list(v) for k, v in ADAPTER_COHORTS.items()}
    cfg.fl.n_total_clients = cfg.fl.n_clients_per_round = 4
    cfg.fl.local_steps = 4
    cfg.optimizer.lr, cfg.scheduler.t_warmup = ADAPTER_LR, 0
    cfg.dataset.synthetic = True
    return cfg.validate()


def _lora_grads_of(torch, cfg, params, tokens):
    """One step's loss and A/B gradients (the base requires none),
    averaged over the config's microbatches."""
    from photon_tpu_torch.codec.params import flatten
    from photon_tpu_torch.models.mpt import MPTModel
    from photon_tpu_torch.train.train_step import make_loss_fn

    loss_fn = make_loss_fn(MPTModel(cfg.model), cfg.train.loss_chunk_tokens)
    flat = flatten(params)
    names = [n for n in flat if "_lora_" in n]
    for n, p in flat.items():
        p.requires_grad_(n in names)
    n_mb = cfg.train.global_batch_size // cfg.train.device_microbatch_size
    loss_sum, grads = 0.0, None
    for mb in tokens.reshape(n_mb, -1, tokens.shape[1]):
        loss = loss_fn(params, mb)
        g = torch.autograd.grad(loss, [flat[n] for n in names])
        loss_sum += float(loss.detach())
        grads = [x.float() for x in g] if grads is None else [a + x for a, x in zip(grads, g)]
    return loss_sum / n_mb, {n: g / n_mb for n, g in zip(names, grads)}


def _adapter_grad_gate(torch, fa, cfg, params, tokens) -> dict:
    """One adapter fit step from ``params`` (the base and a trained
    cohort's factors) three ways: the kernels, the plain dense attention
    (remat) and the kernels under :func:`_shifted_offset_fault`; the
    launch counts are left as found (not the main path)."""
    import copy

    saved = dict(fa.launches)
    ref_cfg = copy.deepcopy(cfg)
    ref_cfg.model.attn_impl, ref_cfg.model.remat = "xla", True
    ref = _lora_grads_of(torch, ref_cfg, params, tokens)
    sound = _lora_grads_of(torch, cfg, params, tokens)
    sound_attn = fa.flash_attention
    fa.flash_attention = _shifted_offset_fault(fa)
    try:
        faulty = _lora_grads_of(torch, cfg, params, tokens)
    finally:
        fa.flash_attention = sound_attn
    for key in fa.launches:
        fa.launches[key] = saved[key]

    def compare(run):
        per = {n: _rel_l2(run[1][n], ref[1][n]) for n in ref[1]}
        loss_d = abs(run[0] - ref[0]) / abs(ref[0])
        return {"loss_rel_diff": loss_d, "factor_grad_rel_l2": per,
                "worst": max(loss_d, max(per.values()))}

    return {"gate": ADAPTER_GRAD_GATE, "sound": compare(sound), "planted_fault": compare(faulty),
            "loss_kernel": sound[0], "loss_plain": ref[0]}


def _adapter_drive(eng, requests, budget):
    """The scheduler's loop over ``requests`` (cohort, prompt, tokens to
    emit) on ``eng``: FIFO admission while a slot, the blocks and the
    cohort's page are there, one chunk of at most ``budget`` tokens a step
    (oldest first), eviction at the request's count. Returns each
    request's emission logits (on the card) and tokens, and the schedule
    (who ran and which chunk, per step)."""
    queue, running, schedule = list(enumerate(requests)), {}, []
    out = {i: ([], []) for i in range(len(requests))}
    while queue or running:
        while queue and eng.free_slot() is not None:
            i, (cohort, prompt, n) = queue[0]
            if not eng.can_admit(len(prompt), n, prompt=prompt, cohort=cohort):
                break
            queue.pop(0)
            slot = eng.free_slot()
            eng.begin(slot, prompt, n, cohort=cohort)
            running[slot] = i
        pre = [s for s in running if eng.pending_tokens(s) > 0]
        chunk = None
        if pre:
            s = min(pre, key=lambda s: running[s])
            chunk = (s, min(eng.pending_tokens(s), budget))
        schedule.append((sorted(running.items()), chunk))
        nxt, emitted = eng.mixed_step(chunk)
        for s in sorted(running):
            if emitted[s]:
                i = running[s]
                out[i][0].append(eng.last_logits[s].float().clone())
                out[i][1].append(int(nxt[s]))
                if len(out[i][1]) >= requests[i][2]:
                    eng.evict(s)
                    del running[s]
    return out, schedule


def _adapter_rows(spec, bank, cohort):
    """One row's adapter tree for the contiguous oracle (zeros: no cohort)."""
    import numpy as np

    from photon_tpu_torch.adapters.lora import adapter_metadata, adapter_tree, \
        stack_adapter_trees

    arrays = bank[cohort] if cohort is not None else [
        np.zeros(s, np.float32) for s in adapter_metadata(spec).shapes]
    return stack_adapter_trees([adapter_tree(spec, arrays)])


def _adapter_oracle(torch, cp, mc, spec, bank, cohort, prompt, stream):
    """Contiguous decode of one request with its cohort's adapter, fed the
    engine's (or server's) token ``stream``: the logits of every emission."""
    from photon_tpu_torch.models import decode

    adapters = _adapter_rows(spec, bank, cohort)
    toks = torch.zeros((1, len(prompt) + len(stream) + 1), dtype=torch.long, device="cuda")
    toks[0, : len(prompt)] = torch.tensor(prompt, device="cuda")
    with torch.inference_mode():
        lg, st = decode.prefill(cp, toks, torch.tensor([len(prompt)], device="cuda"), mc,
                                adapters=adapters, lora_scale=spec.scale)
        out = [lg[0].float()]
        for t in stream[:-1]:
            lg, st = decode.decode_step(cp, st, torch.tensor([t], device="cuda"), mc,
                                        adapters=adapters, lora_scale=spec.scale)
            out.append(lg[0].float())
    return out


def _first_untied_mismatch(oracle, tokens, tie):
    """The first emission whose token differs from the oracle's argmax with
    a top-2 margin over ``tie`` (None: the stream equals the oracle's up to
    a tie; after a tie the streams part legitimately and are not read)."""
    for i, (lg, t) in enumerate(zip(oracle, tokens)):
        if int(lg.argmax()) != t:
            top2 = lg.topk(2).values
            return None if float(top2[0] - top2[1]) <= tie else i
    return None


def _profiled_step(torch, step, step_s):
    """One ``step()`` under ``torch.profiler``: the device's busy time by
    kernel, its idle share of an unprofiled step of ``step_s`` seconds,
    K1-K3's share of the busy time, and the kernel launches."""
    with _profiled(torch) as prof:
        step()
    kern_ms, n_launch = {}, 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            kern_ms[e.key] = kern_ms.get(e.key, 0.0) + (getattr(e, "self_device_time_total", 0.0)
                                                        or 0.0) / 1e3
            n_launch += e.count
    busy = sum(kern_ms.values())
    flash_ms = {k: sum(v for n, v in kern_ms.items() if tag in n)
                for k, (_, tag) in FLASH_KERNELS.items()}
    top = sorted(kern_ms.items(), key=lambda kv: -kv[1])[:10]
    return {"device_busy_ms": busy if busy > 0 else "not measured",
            "device_idle_share": (1 - busy / (step_s * 1e3)) if busy > 0 else "not measured",
            "flash_kernel_ms": flash_ms,
            "flash_share_of_busy": (sum(flash_ms.values()) / busy) if busy > 0 else None,
            "kernel_launches": n_launch, "top_kernels_ms": [[k[:80], v] for k, v in top]}


def _launches_per_step(torch, eng, n=4):
    """CUDA kernel launches per decode step (``torch.profiler``; it may
    lose records, so this reads at most the true count)."""
    with _profiled(torch) as prof:
        for _ in range(n):
            eng.step()
    return sum(e.count for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")) / n


def _adapter_engine_pair(torch, rpa, np, base, bank, cfg) -> dict:
    """(b): a ragged adapter engine against the contiguous oracle on one
    mixed batch (a, b, none, none; c admitted mid-batch on a's recycled
    page), a planted fault (slots 0 and 1 read each other's adapter row),
    the no-cohort slots against an adapter-free engine, and a replay after
    the pool evicted and reloaded every cohort."""
    import copy

    from photon_tpu_torch.models import decode
    from photon_tpu_torch.serve.engine import PagedEngine

    mc = cfg.model
    rng = np.random.default_rng(5)
    requests = [(c, list(map(int, rng.integers(0, mc.vocab_size, n))), m)
                for c, n, m in ADAPTER_REQUESTS]
    budget = cfg.photon.serve.prefill_token_budget
    free_cfg = copy.deepcopy(cfg)
    free_cfg.photon.adapters.enabled = False
    eng = PagedEngine(cfg, base, device="cuda", adapter_bank=bank)
    eng_f = PagedEngine(cfg, base, device="cuda", adapter_bank=bank)
    eng_0 = PagedEngine(free_cfg, base, device="cuda")
    spec = eng.adapter_pool.spec
    rpa.launches = 0  # the counted run starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, sched = _adapter_drive(eng, requests, budget)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rpa.launches  # and ends here
    steps = len(sched)
    chunk_steps = sum(c is not None for _, c in sched)
    if launches != mc.n_layers * (steps + chunk_steps):
        fail(f"adapter engine launched K4 {launches} times, want "
             f"{mc.n_layers} x ({steps} + {chunk_steps})")
    pool = eng.adapter_pool
    if pool.evictions < 1:
        fail(f"c's admission recycled no page: {pool.stats()}")
    # the planted fault: slots 0 and 1 gather each other's page
    sound_gather = eng_f.adapter_pool.gather

    def swapped(rows):
        return sound_gather(rows[torch.tensor([1, 0] + list(range(2, len(rows))),
                                              device=rows.device)])

    eng_f.adapter_pool.gather = swapped
    before = rpa.launches
    fault, _ = _adapter_drive(eng_f, requests, budget)
    free, sched_0 = _adapter_drive(eng_0, [(None, p, m) for _, p, m in requests], budget)
    rpa.launches = before  # the comparisons are not the main path
    if sched_0 != sched:
        fail("the adapter-free engine ran another schedule")
    cp = decode.compute_params(base, mc, torch.device("cuda"))
    worst, worst_fault = 0.0, 0.0
    for i, (cohort, prompt, _) in enumerate(requests):
        want = _adapter_oracle(torch, cp, mc, spec, bank, cohort, prompt, got[i][1])
        for lg, fl, w in zip(got[i][0], fault[i][0], want):
            if not (torch.isfinite(lg).all() and lg.shape == (mc.vocab_size,)):
                fail(f"request {i}: logits not finite or of shape {tuple(lg.shape)}")
            worst = max(worst, _rel_l2(lg, w))
            worst_fault = max(worst_fault, _rel_l2(fl, w))
    if worst > ENGINE_LOGIT_GATE:
        fail(f"mixed-cohort engine vs contiguous oracle: {worst:.3e} > {ENGINE_LOGIT_GATE}")
    if worst_fault <= ENGINE_LOGIT_GATE:
        fail(f"the logit gate {ENGINE_LOGIT_GATE} misses two slots' swapped adapter rows "
             f"(reading {worst_fault:.3e})")
    for i, (cohort, _, _) in enumerate(requests):
        if cohort is None and not all(torch.equal(x, y) for x, y in zip(got[i][0],
                                                                         free[i][0])):
            fail(f"request {i} (no cohort) differs from the adapter-free engine's logits")
    # the replay: every cohort is evicted and reloaded into another page
    loads, evictions = pool.loads, pool.evictions
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again, _ = _adapter_drive(eng, requests, budget)
    torch.cuda.synchronize()
    wall_again = time.perf_counter() - t0
    if pool.loads - loads < 3 or pool.evictions - evictions < 2:
        fail(f"the replay reloaded {pool.loads - loads} pages with "
             f"{pool.evictions - evictions} evictions")
    for i in range(len(requests)):
        if not all(torch.equal(x, y) for x, y in zip(got[i][0], again[i][0])):
            fail(f"request {i}: logits after its cohort's reload differ from the first load's")
    # steady decode, 4 slots at their first 300 prompt tokens: step time in
    # turns (adapters, adapter-free, no cohort on the adapter engine, and
    # back) and launches per step
    before = rpa.launches
    eng_f.adapter_pool.gather = sound_gather
    engines = {"mixed_cohorts": (eng, ("a", "b", None, None)),
               "no_cohort_adapter_free": (eng_0, (None,) * 4),
               "no_cohort_adapter_engine": (eng_f, (None,) * 4)}
    for e, cohorts in engines.values():
        for slot, c in enumerate(cohorts):
            e.admit(slot, requests[slot][1][:300], 64, cohort=c)
        for _ in range(3):
            e.step()
    step_ms = {k: [] for k in engines}
    for tag in ("mixed_cohorts", "no_cohort_adapter_free", "no_cohort_adapter_engine",
                "no_cohort_adapter_engine", "no_cohort_adapter_free", "mixed_cohorts"):
        e = engines[tag][0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            e.step()
        torch.cuda.synchronize()
        step_ms[tag].append((time.perf_counter() - t0) / 10 * 1e3)
    per_step = {tag: _launches_per_step(torch, e) for tag, (e, _) in engines.items()}
    rpa.launches = before
    n_tokens = sum(m for _, _, m in requests)
    rec = {"requests": [[c, len(p), m] for c, p, m in requests], "steps": steps,
           "chunk_steps": chunk_steps, "launches": launches,
           "worst_logit_rel_l2": worst, "logit_gate": ENGINE_LOGIT_GATE,
           "planted_fault_rel_l2": worst_fault,
           "no_cohort_equals_adapter_free": True, "reload_equals_first_load": True,
           "pool": pool.stats(), "pool_device_bytes": pool.nbytes,
           "schedule_tokens_per_s": {"first": n_tokens / wall, "replay": n_tokens / wall_again},
           "decode_step_ms": step_ms,
           "decode_tokens_per_s": {k: 4 / (statistics.median(v) / 1e3)
                                   for k, v in step_ms.items()},
           "launches_per_decode_step": per_step}
    del eng, eng_f, eng_0, cp
    torch.cuda.empty_cache()
    return rec


def _adapter_server(torch, np, cfg, work, mgr, plane, runtime, banks, base, tie) -> dict:
    """(c): ``python -m photon_tpu_torch.serve`` on adapter round 1 with the
    prefix cache and hot-swap on; round 2 is trained in this process while
    the server starts, and copied in under load."""
    from photon_tpu_torch.checkpoint import FileStore
    from photon_tpu_torch.models import decode
    from photon_tpu_torch.serve.engine import base_model_config

    serve_store = FileStore(work / "serve_store")
    _copy_round(mgr.store, serve_store, ADAPTER_RUN, 1)
    scfg = serve_config()
    scfg.model = cfg.model  # the training run's resolved config: LoRA knobs and all
    scfg.photon.adapters = cfg.photon.adapters
    scfg.run_uuid = ADAPTER_RUN
    sc = scfg.photon.serve
    sc.attention_impl, sc.prefix_cache, sc.hotswap, sc.hotswap_poll_s = "auto", True, True, 0.25
    scfg.to_yaml(work / "resolved.yaml")
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch.serve", "--config", str(work / "resolved.yaml"),
         "--store", str(work / "serve_store"), "--round", "-1", "--enable", "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    stderr_tail: list[str] = []
    threading.Thread(target=lambda: stderr_tail.extend(proc.stderr), daemon=True).start()
    watchdog = threading.Timer(900, proc.kill)
    watchdog.start()
    try:
        t_start = time.perf_counter()
        # round 2 trains while the server starts
        m2 = plane.run_round(runtime, 2, sorted(plane.cohort_of))
        plane.save_round(mgr, 2)
        banks[2] = {c: [a.copy() for a in plane.strategies.params(c)] for c in plane.cohort_names}
        round2_s = time.perf_counter() - t_start
        first = proc.stdout.readline()
        watchdog.cancel()
        if not first:
            proc.wait(timeout=30)
            fail(f"adapter server exited {proc.returncode}: {''.join(stderr_tail)[-3000:]}")
        info = json.loads(first)
        port = info["port"]
        if info["round"] != 1 or info["adapters"] != ["a", "b", "c"] or not info["prefix_cache"]:
            fail(f"adapter server started as {info}")
        mc = base_model_config(scfg.model)
        spec = plane.spec
        cp = decode.compute_params(base, mc, torch.device("cuda"))
        rng = np.random.default_rng(7)

        def gen(prompt, cohort, n=16):
            body = {"tokens": prompt, "max_new_tokens": n}
            if cohort is not None:
                body["cohort"] = cohort
            status, data = _request(port, "/generate", body)
            return status, json.loads(data)

        def cached():
            return json.loads(_request(port, "/healthz")[1])["prefix_cache"]["tokens_cached"]

        def check_stream(rnd, cohort, prompt, tokens, what):
            want = _adapter_oracle(torch, cp, mc, spec, banks[rnd], cohort, prompt, tokens)
            bad = _first_untied_mismatch(want, tokens, tie)
            if bad is not None:
                fail(f"{what}: the stream parts from round {rnd}'s oracle at token {bad} "
                     "with a clear margin")

        # every cohort and none answers; an unknown one gets 400
        q = list(map(int, rng.integers(0, mc.vocab_size, ADAPTER_SERVE_PROMPT)))
        for cohort in ("a", "b", "c", None):
            status, rep = gen(q, cohort)
            if status != 200 or rep.get("cohort") != cohort or len(rep["tokens"]) != 16:
                fail(f"cohort {cohort}: status {status}, reply {rep}")
            check_stream(1, cohort, q, rep["tokens"], f"round 1, cohort {cohort}")
        status, rep = gen(q, "zzz")
        if status != 400 or "unknown adapter cohort" not in rep.get("error", ""):
            fail(f"an unknown cohort got {status}: {rep}")
        health = json.loads(_request(port, "/healthz")[1])
        pool_h = health.get("adapters") or {}
        if pool_h.get("serving") != ["a", "b", "c"] or pool_h.get("evictions", 0) < 1:
            fail(f"/healthz adapters: {pool_h}")
        # one templated prompt under a, then b, then b again
        n_block, reps, n_tail = ADAPTER_TEMPLATE
        block = list(map(int, rng.integers(0, mc.vocab_size, n_block)))
        p = block * reps + list(map(int, rng.integers(0, mc.vocab_size, n_tail)))
        hits = {}
        streams = {}
        for tag, cohort in (("a", "a"), ("b_after_a", "b"), ("b_again", "b")):
            c0 = cached()
            status, rep = gen(p, cohort)
            if status != 200:
                fail(f"templated prompt under {cohort}: {status} {rep}")
            hits[tag] = (cached() - c0) / len(p)
            streams[tag] = rep["tokens"]
        if hits["b_after_a"] != 0.0 or hits["b_again"] <= 0.0:
            fail(f"prefix blocks crossed cohorts: hit rates {hits}")
        check_stream(1, "b", p, streams["b_after_a"], "b after a")
        # round 2 lands under load: base and bank swap together
        cohorts = ["a", "b", "c", None] * 2
        prompts = [list(map(int, rng.integers(0, mc.vocab_size, n)))
                   for n in ADAPTER_SWAP_PROMPTS]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as tp:
            futs = [tp.submit(gen, pr, c, 32) for pr, c in zip(prompts, cohorts)]
            time.sleep(0.2)
            t_manifest = _copy_round(mgr.store, serve_store, ADAPTER_RUN, 2)
            replies = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        dropped = sum(s != 200 or len(r.get("tokens", [])) != 32 for s, r in replies)
        if dropped:
            fail(f"{dropped} requests dropped across the swap: {[s for s, _ in replies]}")
        swapped = _wait_health(port, lambda h: h["round"] == 2 and h["swaps"] == 1, 120,
                               "the swap to adapter round 2")
        for cohort in ("a", "b", "c", None):
            status, rep = gen(q, cohort)
            if status != 200:
                fail(f"after the swap, cohort {cohort}: {status} {rep}")
            check_stream(2, cohort, q, rep["tokens"], f"round 2, cohort {cohort}")
        health = json.loads(_request(port, "/healthz")[1])
        st = health["stats"]
        launches = health["kernel_launches"]["ragged_paged_attention"]
        if launches != mc.n_layers * int(st["steps"] + st["chunk_steps"]) or launches == 0:
            fail(f"adapter server launched K4 {launches} times for {st}")
        rec = {"startup_and_round2_overlap_s": time.perf_counter() - t_start,
               "round2_train_s": round2_s, "round2": {k: v for k, v in m2.items()
                                                      if k.startswith("server/")},
               "cohorts_answered": ["a", "b", "c", None], "unknown_cohort_status": 400,
               "prefix_hit_rate": hits, "b_again_equals_b_after_a":
                   streams["b_again"] == streams["b_after_a"],
               "swap": {"requests": len(prompts), "dropped": 0, "wall_s": wall,
                        "tokens_per_s": len(prompts) * 32 / wall,
                        "manifest_to_applied_s": swapped["hotswap"]["last_swap_at"] - t_manifest,
                        "staged_to_applied_s": swapped["hotswap"]["last_swap_s"]},
               "healthz_adapters": health.get("adapters"), "launches": launches,
               "server_steps": st["steps"], "server_chunk_steps": st["chunk_steps"]}
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            fail("adapter server did not exit after SIGTERM")
        if rc != 0:
            fail(f"adapter server exited {rc} after SIGTERM: {''.join(stderr_tail)[-3000:]}")
        return rec
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def adapter_phase(torch, rpa, fa, np, fed, train, tie) -> dict:
    """(a) the adapter round on the federated run's last round as the
    frozen base, (b) the engine pair, (c) the server; see the module's
    phase 12."""
    import copy

    from photon_tpu_torch.adapters import AdapterTrainPlane, configure_adapter_training
    from photon_tpu_torch.adapters.lora import merge_payload
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.codec.params import params_from_numpy, strip_momenta
    from photon_tpu_torch.federation.client_runtime import ClientRuntime
    from photon_tpu_torch.federation.transport import ParamTransport

    work = ROOT / ".chip_smoke" / "adapters"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        cfg = adapter_config()
        cfg.photon.save_path = str(work)
        fed_mgr = ServerCheckpointManager(FileStore(fed["store"]), fed["run_uuid"])
        base_meta, base_arrays = strip_momenta(*fed_mgr.load_round_params(fed["served_round"]))
        frozen = [a.copy() for a in base_arrays]
        plane = AdapterTrainPlane(cfg, base_meta, base_arrays)
        tcfg = configure_adapter_training(copy.deepcopy(cfg)).validate()
        L = cfg.model.n_layers
        n_micro = cfg.train.global_batch_size // cfg.train.device_microbatch_size
        mgr = ServerCheckpointManager(FileStore(work / "store"), ADAPTER_RUN)

        # (a) the adapter round
        torch.cuda.reset_peak_memory_stats()
        runtime = ClientRuntime(tcfg, ParamTransport("inline"), device="cuda")
        cids = sorted(plane.cohort_of)
        for key in fa.launches:  # the counted run starts here
            fa.launches[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m1 = plane.run_round(runtime, 1, cids)
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
        launches = dict(fa.launches)  # and ends here
        want = len(cids) * cfg.fl.local_steps * L * n_micro
        if launches != {k: want for k in FLASH_KERNELS}:
            fail(f"the adapter round launched {launches}, want {want} each")
        peak = torch.cuda.max_memory_allocated()
        tmeta, tarrays = runtime.trainer.get_parameters()
        held = dict(zip(tmeta.names, tarrays))
        if not all(np.array_equal(a, b) and np.array_equal(held[n], b)
                   for n, a, b in zip(base_meta.names, plane.base_arrays, frozen)):
            fail("the frozen base moved in the adapter round")
        banks = {1: {c: [a.copy() for a in plane.strategies.params(c)]
                     for c in plane.cohort_names}}
        b_max = {c: max(float(np.abs(a).max()) for n, a in zip(plane.ameta.names, banks[1][c])
                        if n.endswith("_lora_b")) for c in plane.cohort_names}
        if not (b_max["a"] > 0 and b_max["b"] > 0 and b_max["c"] == 0):
            fail(f"the cohorts' largest |B| after the round: {b_max}")
        plane.save_round(mgr, 1)
        # the fit step against the full-training step of phase 3 (same shape)
        batch = np.random.default_rng(4).integers(0, cfg.model.vocab_size, (
            cfg.train.global_batch_size, cfg.model.max_seq_len)).astype(np.int32)
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runtime.trainer.train_batch(batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        fit_step_s = statistics.median(walls[1:])
        profiled = _profiled_step(torch, lambda: runtime.trainer.train_batch(batch), fit_step_s)
        # the A/B gradient gate on cohort a's trained factors
        merged_meta, merged = merge_payload(base_meta, plane.base_arrays, plane.ameta,
                                            banks[1]["a"])
        params = params_from_numpy(merged_meta.names, merged, tcfg.model, "cuda")
        tokens = torch.from_numpy(batch).long().to("cuda")
        gate = _adapter_grad_gate(torch, fa, tcfg, params, tokens)
        del params, tokens
        torch.cuda.empty_cache()
        if gate["sound"]["worst"] > ADAPTER_GRAD_GATE:
            fail(f"adapter fit step, kernels vs plain: {gate['sound']['worst']:.3e} > "
                 f"{ADAPTER_GRAD_GATE}")
        if gate["planted_fault"]["worst"] <= ADAPTER_GRAD_GATE:
            fail(f"the adapter gate misses a causal offset shifted by one tile "
                 f"({gate['planted_fault']['worst']:.3e})")
        payload = sum(a.nbytes for a in banks[1]["a"])
        base_bytes = sum(a.nbytes for a in plane.base_arrays)
        fit = {"round_s": round_s, "round": {k: v for k, v in m1.items()
                                             if k.startswith("server/")},
               "launches": launches, "launches_per_step": {k: L * n_micro for k in launches},
               "fit_step_s": fit_step_s,
               "fit_tokens_per_s": batch.size / fit_step_s,
               "full_training_step_s": train["step_s_median_after_first"],
               "full_training_tokens_per_s": train["tokens_per_s"],
               "max_memory_allocated_gb": peak / 1e9, "profiled_step": profiled,
               "full_training_profiled_step": train.get("profiled_step"),
               "adapter_payload_bytes": payload, "base_payload_bytes": base_bytes,
               "payload_ratio": payload / base_bytes, "largest_abs_b": b_max,
               "grad_gate": gate}
        log("adapter_round " + json.dumps(fit))

        # (b) the engine pair on round 1's base and bank
        scfg = serve_config()
        scfg.photon.adapters = copy.deepcopy(cfg.photon.adapters)
        scfg.photon.serve.attention_impl, scfg.photon.serve.n_slots = "ragged", 4
        base = params_from_numpy(base_meta.names, plane.base_arrays, scfg.model, "cuda")
        pair = _adapter_engine_pair(torch, rpa, np, base, banks[1], scfg)
        log("adapter_engine_pair " + json.dumps(pair))

        # (c) the server, and round 2 trained while it starts
        server = _adapter_server(torch, np, tcfg, work, mgr, plane, runtime, banks, base, tie)
        log("adapter_server " + json.dumps(server))
        del runtime, base
        torch.cuda.empty_cache()
        # the store stays for the fleet phase, which removes it
        return {"fit": fit, "engine_pair": pair, "server": server,
                "fleet_source": {"store": str(work / "store"), "run": ADAPTER_RUN,
                                 "config": str(work / "resolved.yaml")}}
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise


# ---------------------------------------------------------------------------
# phase 13: a fleet of replicas behind one router
# ---------------------------------------------------------------------------

FLEET_REPLICAS = 3
#: requests of each kind in the traffic: templated, cohort and short
FLEET_PER_KIND = 16
#: templates, and full blocks of shared prefix in each (the router's
#: ``prefix_affinity_blocks``, so the routing key is the template)
FLEET_TEMPLATES = (4, 4)
FLEET_NEW = 32
FLEET_CLIENTS = 4
#: the cohort requests' prompt lengths are drawn from [lo, hi)
FLEET_COHORT_PROMPT = (100, 600)
#: one engine with the fleet's total slots, for the comparison
FLEET_SINGLE_SLOTS = 24
#: traffic this long before the SIGKILL, and again after the router saw it
FLEET_KILL_AFTER_S = 1.0
#: the SIGKILL waits for a stream placed on the victim this long ago (so
#: its tokens flow: a request killed before its first response byte is
#: placed again, a stream killed after it is lost)
FLEET_KILL_STREAM_AGE_S = 0.1
FLEET_SWAP_SAMPLE_S = 0.05
FLEET_START_S = 600.0


def fleet_config(config_path, n_slots: int = 8):
    """The adapter server's resolved config as a fleet replica's: ``n_slots``
    slots, the prefix cache on, hot-swap on at the adapter server's poll
    (a replica polls only when a rolling pass asks it to), the fleet on
    with ``FLEET_REPLICAS`` replicas."""
    from photon_tpu_torch.config.schema import Config

    cfg = Config.from_yaml(config_path)
    sc = cfg.photon.serve
    sc.enabled, sc.n_slots, sc.n_blocks, sc.prefix_cache = True, n_slots, 0, True
    sc.hotswap = True
    sc.fleet.enabled, sc.fleet.replicas = True, FLEET_REPLICAS
    return cfg


def _fleet_traffic(np, rng, vocab: int, block: int) -> list[dict]:
    """``FLEET_PER_KIND`` requests of each kind, interleaved: a templated
    prompt (a template's full blocks, then a suffix of less than a block),
    a prompt under cohort a, b or c in turn, and a prompt shorter than a
    block (no routing key: power-of-two choices)."""
    n_t, n_b = FLEET_TEMPLATES
    templates = [list(map(int, rng.integers(0, vocab, n_b * block))) for _ in range(n_t)]

    def toks(n):
        return list(map(int, rng.integers(0, vocab, n)))

    reqs = []
    for i in range(FLEET_PER_KIND):
        reqs.append({"kind": "template", "key": i % n_t, "cohort": None,
                     "tokens": templates[i % n_t] + toks(int(rng.integers(1, block)))})
        reqs.append({"kind": "cohort", "key": "abc"[i % 3], "cohort": "abc"[i % 3],
                     "tokens": toks(int(rng.integers(*FLEET_COHORT_PROMPT)))})
        reqs.append({"kind": "p2c", "key": None, "cohort": None,
                     "tokens": toks(int(rng.integers(1, block)))})
    return reqs


def _fleet_post(port, req: dict, max_new: int) -> dict:
    """One ``/generate``: its status, tokens, the replica's TTFT, the
    client's latency and its start and end (``time.monotonic``)."""
    body = {"tokens": req["tokens"], "max_new_tokens": max_new,
            "stream": bool(req.get("stream"))}
    if req["cohort"] is not None:
        body["cohort"] = req["cohort"]
    t0 = time.monotonic()
    try:
        status, data = _request(port, "/generate", body, timeout=300)
        rep = json.loads(data.strip().splitlines()[-1]) if data.strip() else {}
        if req.get("stream") and status == 200 and not rep.get("done"):
            status, rep = -1, {"error": f"a stream without its end: {rep}"}
    except (OSError, ValueError, http.client.HTTPException) as e:
        status, rep = -1, {"error": f"{type(e).__name__}: {e}"}
    t1 = time.monotonic()
    return {"status": status, "tokens": rep.get("tokens"), "ttft_s": rep.get("ttft_s"),
            "latency_s": t1 - t0, "t0": t0, "t1": t1, "error": rep.get("error")}


def _fleet_clients(port, reqs: list[dict], n_clients: int) -> tuple[list[dict], float]:
    """``reqs`` from ``n_clients`` threads, each taking the next request
    in order; the replies and the wall time."""
    import queue

    todo: queue.Queue = queue.Queue()
    for i in range(len(reqs)):
        todo.put(i)
    out: list = [None] * len(reqs)

    def client():
        while True:
            try:
                i = todo.get_nowait()
            except queue.Empty:
                return
            out[i] = _fleet_post(port, reqs[i], FLEET_NEW)

    threads = [threading.Thread(target=client, daemon=True) for _ in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    bad = [i for i, r in enumerate(out)
           if r is None or r["status"] != 200 or len(r["tokens"] or []) != FLEET_NEW]
    if bad:
        fail(f"fleet: {len(bad)} of {len(reqs)} requests failed: "
             f"{[out[i] and (out[i]['status'], out[i]['error']) for i in bad[:4]]}")
    return out, wall


def _serving_summary(res: list[dict], wall: float) -> dict:
    ttft = sorted(r["ttft_s"] for r in res)
    lat = sorted(r["latency_s"] for r in res)
    return {"requests": len(res), "wall_s": wall, "tokens_per_s": len(res) * FLEET_NEW / wall,
            "ttft_mean_s": statistics.fmean(ttft), "ttft_p50_s": ttft[len(ttft) // 2],
            "ttft_p90_s": ttft[int(0.9 * (len(ttft) - 1))],
            "latency_mean_s": statistics.fmean(lat), "latency_p90_s": lat[int(0.9 * (len(lat) - 1))]}


def _tap_placements(router) -> list[dict]:
    """Record every placement ``router`` makes (its retries included)."""
    log: list[dict] = []
    place = router.place

    def tapped(prompt, cohort, exclude=()):
        rid, reason = place(prompt, cohort, exclude)
        log.append({"key": (tuple(prompt) if prompt is not None else None, cohort),
                    "rid": rid, "reason": reason, "t": time.monotonic()})
        return rid, reason

    router.place = tapped
    return log


def _placed(log: list[dict], req: dict, t0: float, t1: float) -> list[str]:
    """The replicas a request sent between ``t0`` and ``t1`` was placed on."""
    key = (tuple(req["tokens"]), req["cohort"])
    return [p["rid"] for p in list(log) if p["key"] == key and t0 <= p["t"] <= t1]


def _scattered(log, reqs, res, kind) -> dict:
    """Each key of ``kind`` (a template, a cohort) → the replicas its
    requests went to, for the keys that went to more than one."""
    where: dict = {}
    for req, r in zip(reqs, res):
        if req["kind"] == kind:
            where.setdefault(req["key"], set()).update(_placed(log, req, r["t0"], r["t1"]))
    return {k: sorted(v) for k, v in where.items() if len(v) != 1}


def _replica_health(router, rid) -> dict:
    st = router.replicas[rid]
    return json.loads(_request(st.port, "/healthz", timeout=30)[1])


def _fleet_tokens_cached(router) -> float:
    """The prompt tokens whose prefill a prefix-cache hit skipped, summed
    over the live replicas."""
    return float(sum(_replica_health(router, rid)["prefix_cache"]["tokens_cached"]
                     for rid in router.live_replicas()))


def _fleet_streams_agree(eng, reqs, got, want, tie, what) -> list:
    """As :func:`_streams_agree`, under each request's cohort: a stream may
    part from ``want`` only where ``eng``'s top-2 margin over the prompt
    and the common prefix is a tie."""
    diverged = []
    for i, (req, a, b) in enumerate(zip(reqs, got, want)):
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        eng.admit(0, req["tokens"] + b[:j], 1, cohort=req["cohort"])
        top2 = eng.last_logits[0].float().topk(2).values
        eng.evict(0)
        margin = float(top2[0] - top2[1])
        if margin > tie:
            fail(f"{what}: request {i} parts from one engine's stream at token {j} where the "
                 f"top-2 margin {margin:.4f} is clear (tie {tie:.4f})")
        diverged.append([i, j, margin])
    return diverged


def _launch_rule(health: dict, n_layers: int, what: str) -> int:
    """K4 launched ``n_layers`` × (steps + chunk steps) in a server (card
    only: on the CPU the plain version runs)."""
    st, n = health["stats"], health["kernel_launches"]["ragged_paged_attention"]
    if n != n_layers * int(st["steps"] + st["chunk_steps"]):
        fail(f"{what} launched K4 {n} times for {st['steps']} steps and {st['chunk_steps']} "
             "chunk steps")
    return n


def _traffic_thread(port, np, seed: int, vocab: int, block: int, log: list,
                    stop: threading.Event, current: dict | None = None) -> threading.Thread:
    """Requests one after another until ``stop``: templated, cohort
    (streamed) and short prompts in turn, each prompt of its own (its
    first two tokens name the thread and the count). ``current[seed]``
    holds the request in flight and its start."""
    def run():
        rng = np.random.default_rng(seed)
        n = 0
        while not stop.is_set():
            kind = ("template", "cohort", "p2c")[n % 3]
            head = [1 + seed % (vocab - 1), 1 + n % (vocab - 1)]
            if kind == "template":
                req = {"kind": kind, "cohort": None, "tokens": [7] * (FLEET_TEMPLATES[1] * block)
                       + head}
            elif kind == "cohort":
                req = {"kind": kind, "cohort": "abc"[n // 3 % 3], "stream": True,
                       "tokens": head + list(map(int, rng.integers(
                           0, vocab, int(rng.integers(*FLEET_COHORT_PROMPT)))))}
            else:
                req = {"kind": kind, "cohort": None, "tokens": head[: block - 1]}
            if current is not None:
                current[seed] = (req, time.monotonic())
            r = _fleet_post(port, req, FLEET_NEW)
            if current is not None:
                current[seed] = None
            r["req"] = req
            log.append(r)
            n += 1

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _smi_sample(cuda: bool) -> dict | None:
    if not cuda:
        return None
    rows, used = _GpuMemory._sample()
    return {"contexts": rows, "card_used_mib": used}


def fleet_phase(torch, rpa, np, src: dict, tie: float, device: str = "cuda") -> dict:
    """Phase 13: three ``python -m photon_tpu_torch.serve --fleet-connect``
    replicas behind a ``FleetRouter`` in this process, on the adapter
    run's round 1 (``src``: its ``store``, ``run`` and resolved
    ``config``); see the module's docstring."""
    import os

    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.federation.membership import DEAD
    from photon_tpu_torch.serve.engine import PagedEngine, load_serving_bank, load_serving_params
    from photon_tpu_torch.serve.fleet import FleetSupervisor
    from photon_tpu_torch.serve.router import AffinityRouter, FleetRouter
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    work = pathlib.Path(src["store"]).parent / "fleet"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    run, src_store = src["run"], FileStore(src["store"])
    store = FileStore(work / "store")
    _copy_round(src_store, store, run, 1)
    cfg = fleet_config(src["config"])
    cfg.to_yaml(work / "fleet.yaml")
    single_cfg = fleet_config(src["config"], n_slots=FLEET_SINGLE_SLOTS)
    single_cfg.photon.serve.hotswap = single_cfg.photon.serve.fleet.enabled = False
    single_cfg.to_yaml(work / "single.yaml")
    sc, fc = cfg.photon.serve, cfg.photon.serve.fleet
    n_layers, vocab, block = cfg.model.n_layers, cfg.model.vocab_size, sc.block_size
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT)] + [p for p in [os.environ.get(
        "PYTHONPATH")] if p])}
    rec: dict = {"replicas": fc.replicas, "slots_per_replica": sc.n_slots,
                 "single_slots": FLEET_SINGLE_SLOTS, "block_size": block,
                 "report_poll_s": fc.report_poll_s, "report_timeout_s": fc.report_timeout_s}
    if cuda:
        torch.cuda.empty_cache()
    memory = {"before": _smi_sample(cuda)}
    router = FleetRouter(fc, block_size=block)
    placements = _tap_placements(router)
    port = router.start()
    t_start = time.perf_counter()
    sup = FleetSupervisor(str(work / "fleet.yaml"), f"{fc.host}:{router.control_port}",
                          fc.replicas, extra_args=("--device", device, "--store",
                                                   str(work / "store")), env=env)
    single = subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch.serve", "--config", str(work / "single.yaml"),
         "--store", str(work / "store"), "--enable", "--port", "0", "--device", device],
        cwd=ROOT, env=dict(os.environ, **env), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    single_err: list[str] = []
    threading.Thread(target=lambda: single_err.extend(single.stderr), daemon=True).start()
    watchdog = threading.Timer(FLEET_START_S, single.kill)
    watchdog.start()
    eng = None
    try:
        # one engine in this process on the same round and bank, while
        # the replicas start: the streams the routed ones are held to
        rng = np.random.default_rng(11)
        reqs = _fleet_traffic(np, rng, vocab, block)
        mgr = ServerCheckpointManager(src_store, run)
        eng = PagedEngine(cfg, load_serving_params(cfg, mgr, 1), loaded_round=1, device=device,
                          adapter_bank=load_serving_bank(cfg, mgr, 1))
        b = ContinuousBatcher(eng, max_queue=len(reqs),
                              prefill_token_budget=sc.prefill_token_budget)
        subs = [b.submit(r["tokens"], FLEET_NEW, cohort=r["cohort"]) for r in reqs]
        rpa.launches = 0
        b.start()
        want = [s.result(timeout=600) for s in subs]
        b.close()
        st = b.stats()
        if cuda and rpa.launches != n_layers * int(st["steps"] + st["chunk_steps"]):
            fail(f"the fleet's reference engine launched K4 {rpa.launches} times for {st}")

        try:
            router.wait_for_replicas(timeout=FLEET_START_S)
        except TimeoutError as e:
            fail(f"fleet: {e}; replica output: "
                 + json.dumps({r: list(lines)[-20:] for r, lines in sup.logs.items()}))
        first = single.stdout.readline()
        watchdog.cancel()
        if not first:
            single.wait(timeout=30)
            fail(f"the single engine exited {single.returncode}: {''.join(single_err)[-3000:]}")
        single_port = json.loads(first)["port"]
        rec["startup_s"] = time.perf_counter() - t_start
        cohorts = sorted(cfg.photon.adapters.cohorts)
        for rid, lines in sup.logs.items():
            info = json.loads(lines[0]) if lines else {}
            if (info.get("replica_id"), info.get("round"), info.get("adapters")) != \
                    (rid, 1, cohorts):
                fail(f"replica {rid} started as {info}")
        memory["replicas_and_single"] = _smi_sample(cuda)

        # (a) the traffic: streams, reasons, affinity
        before = router.fleet_status()["fleet"]["routed"]
        res, wall = _fleet_clients(port, reqs, FLEET_CLIENTS)
        after = router.fleet_status()["fleet"]["routed"]
        diverged = _fleet_streams_agree(eng, reqs, [r["tokens"] for r in res], want, tie,
                                        "routed")
        n_kind = {k: sum(r["kind"] == k for r in reqs) for k in ("template", "cohort", "p2c")}
        routed = {k: after[k] - before[k] for k in ("requests", "prefix", "cohort", "p2c",
                                                    "reroutes")}
        if routed["prefix"] < n_kind["template"] or routed["cohort"] != n_kind["cohort"]:
            fail(f"fleet: routed {routed} for {n_kind}")
        for kind in ("template", "cohort"):
            if (bad := _scattered(placements, reqs, res, kind)):
                fail(f"fleet: {kind} keys spread over replicas: {bad}")
        per_replica = {}
        for rid in router.live_replicas():
            per_replica[rid] = sum(rid in _placed(placements, q, r["t0"], r["t1"])
                                   for q, r in zip(reqs, res))
        rec["traffic"] = dict(_serving_summary(res, wall), routed=routed, kinds=n_kind,
                              requests_per_replica=per_replica, diverged_at_ties=diverged)
        # (b) each replica's K4 launches
        if cuda:
            rec["replica_launches"] = {rid: _launch_rule(_replica_health(router, rid),
                                                         n_layers, rid)
                                       for rid in router.live_replicas()}
            if not sum(rec["replica_launches"].values()):
                fail("no replica launched K4")
        log("fleet_traffic " + json.dumps(rec["traffic"]))

        # prefix hit rates under affinity, then (e) under random placement
        def locality(seed, policy):
            t_reqs = [q for q in _fleet_traffic(np, np.random.default_rng(seed), vocab, block)
                      if q["kind"] == "template"]
            kept = router.policy
            router.policy = policy or kept
            try:
                c0 = _fleet_tokens_cached(router)
                t_res, _ = _fleet_clients(port, t_reqs, FLEET_CLIENTS)
                c1 = _fleet_tokens_cached(router)
            finally:
                router.policy = kept
            return {"hit_rate": (c1 - c0) / sum(len(q["tokens"]) for q in t_reqs),
                    "scattered_templates": _scattered(placements, t_reqs, t_res, "template")}

        rec["affinity_pass"] = locality(12, None)
        rec["random_pass"] = locality(13, AffinityRouter(block_size=block, mode="random"))
        if rec["affinity_pass"]["scattered_templates"]:
            fail(f"fleet: templates spread under affinity: {rec['affinity_pass']}")
        if not rec["random_pass"]["scattered_templates"]:
            fail("fleet: random placement kept every template on one replica, so the "
                 "affinity gate cannot tell placements apart")

        # the single engine with the fleet's total slots, on the same
        # traffic: cold (its first requests), then both warm at 4 clients
        # and at as many clients as slots
        sres, swall = _fleet_clients(single_port, reqs, FLEET_CLIENTS)
        rec["single"] = dict(_serving_summary(sres, swall), equal_streams=sum(
            r["tokens"] == w for r, w in zip(sres, want)))
        rec["warm"] = {}
        for clients in (FLEET_CLIENTS, FLEET_SINGLE_SLOTS):
            rec["warm"][clients] = {
                "fleet": _serving_summary(*_fleet_clients(port, reqs, clients)),
                "single": _serving_summary(*_fleet_clients(single_port, reqs, clients))}
        single.send_signal(signal.SIGTERM)
        if single.wait(timeout=120) != 0:
            fail(f"the single engine exited {single.returncode}: {''.join(single_err)[-3000:]}")
        memory["replicas"] = _smi_sample(cuda)
        log("fleet_vs_single " + json.dumps({k: rec[k] for k in ("single", "warm")}))

        # (c) SIGKILL the replica that holds cohort a's pin, under traffic
        victim = router.policy.pins["a"]
        i_a = next(i for i, q in enumerate(reqs) if q["cohort"] == "a")
        kill_log: list[dict] = []
        current: dict = {}
        stop = threading.Event()
        threads = [_traffic_thread(port, np, 100 + k, vocab, block, kill_log, stop, current)
                   for k in range(FLEET_CLIENTS)]
        time.sleep(FLEET_KILL_AFTER_S)
        # kill while a stream is in flight on the victim (if one comes
        # within the wait): its loss is the one the gate allows
        deadline = time.monotonic() + 10 * FLEET_KILL_AFTER_S
        while time.monotonic() < deadline and not any(
                c is not None and c[0].get("stream") and victim in _placed(
                    placements, c[0], c[1], time.monotonic() - FLEET_KILL_STREAM_AGE_S)
                for c in list(current.values())):
            time.sleep(0.002)
        t_kill = time.monotonic()
        sup.kill_replica(victim)
        bound = router.tracker.dead_after * (fc.report_poll_s + fc.report_timeout_s)
        while router.tracker.nodes[victim].state != DEAD:
            if time.monotonic() - t_kill > 3 * bound:
                break
            time.sleep(0.01)
        dead_s = time.monotonic() - t_kill
        time.sleep(FLEET_KILL_AFTER_S)
        stop.set()
        for t in threads:
            t.join(timeout=600)
        if dead_s > bound:
            fail(f"fleet: {victim} was marked dead {dead_s:.2f} s after the SIGKILL "
                 f"(the ladder's bound {bound:.2f} s)")
        inflight = [r for r in kill_log if r["t0"] < t_kill < r["t1"]
                    and victim in _placed(placements, r["req"], r["t0"], t_kill)]
        lost = [r for r in kill_log if r["status"] != 200 or len(r["tokens"] or []) != FLEET_NEW]
        if any(not any(r is x for x in inflight) for r in lost):
            fail(f"fleet: a request not in flight on {victim} failed: "
                 f"{[(r['status'], r['error']) for r in lost][:4]}")
        new_pin = router.policy.pins.get("a")
        if new_pin == victim or new_pin not in router.live_replicas():
            fail(f"fleet: cohort a pinned to {new_pin} after {victim} died")
        again = _fleet_post(port, reqs[i_a], FLEET_NEW)
        if again["status"] != 200:
            fail(f"fleet: cohort a after the kill: {again}")
        repin_diverged = _fleet_streams_agree(eng, [reqs[i_a]], [again["tokens"]],
                                              [res[i_a]["tokens"]], tie, "cohort a re-pinned")
        rec["kill"] = {"victim": victim, "dead_after_s": dead_s, "ladder_bound_s": bound,
                       "requests": len(kill_log), "inflight_on_victim": len(inflight),
                       "streams_inflight_on_victim": sum(bool(r["req"].get("stream"))
                                                         for r in inflight),
                       "lost": len(lost), "new_pin": new_pin,
                       "rerouted": router.fleet_status()["fleet"]["routed"]["reroutes"]
                       - after["reroutes"], "repinned_stream_diverged": repin_diverged,
                       "live": router.live_replicas()}
        memory["survivors"] = _smi_sample(cuda)
        log("fleet_kill " + json.dumps(rec["kill"]))

        # (d) round 2 lands; a rolling hot-swap under traffic
        survivors = router.live_replicas()
        t_manifest = _copy_round(src_store, store, run, 2)
        samples: list = []
        stop_s = threading.Event()

        def sampler():
            while not stop_s.is_set():
                for rid in survivors:
                    h = _replica_health(router, rid)
                    samples.append((time.time(), rid, h["round"],
                                    h["hotswap"]["last_swap_at"], h["hotswap"]["last_swap_s"]))
                stop_s.wait(FLEET_SWAP_SAMPLE_S)

        swap_log: list[dict] = []
        stop = threading.Event()
        threads = [threading.Thread(target=sampler, daemon=True)] + [
            _traffic_thread(port, np, 200 + k, vocab, block, swap_log, stop) for k in range(2)]
        threads[0].start()
        time.sleep(0.2)
        t0 = time.perf_counter()
        results = router.rolling_hotswap(timeout_s=600)
        swap_s = time.perf_counter() - t0
        time.sleep(0.2)
        stop.set()
        stop_s.set()
        for t in threads:
            t.join(timeout=600)
        if [(r["replica"], r["ok"], r.get("swapped"), r.get("round")) for r in results] != \
                [(rid, True, True, 2) for rid in survivors]:
            fail(f"fleet: the rolling hot-swap gave {results}")
        dropped = [r for r in swap_log if r["status"] != 200
                   or len(r["tokens"] or []) != FLEET_NEW]
        if dropped or not swap_log:
            fail(f"fleet: {len(dropped)} of {len(swap_log)} requests dropped across the "
                 f"rolling swap: {[(r['status'], r['error']) for r in dropped][:4]}")
        last = {}
        for t, rid, rnd, at, dur in samples:
            last[rid] = (rnd, at, dur)
        if any(last.get(rid, (0,))[0] != 2 for rid in survivors):
            fail(f"fleet: the survivors' rounds after the swap: {last}")
        windows = sorted((at - dur, at, rid) for rid, (_, at, dur) in last.items())
        for (_, end_a, a), (start_b, _, b2) in zip(windows, windows[1:]):
            if end_a > start_b:
                fail(f"fleet: {a} and {b2} were mid-swap at once: {windows}")
        flips = {rid: min((t for t, r, rnd, *_ in samples if r == rid and rnd == 2), default=None)
                 for rid in survivors}
        final = {rid: _replica_health(router, rid) for rid in survivors}
        if cuda:
            for rid, h in final.items():
                rec["replica_launches"][rid] = _launch_rule(h, n_layers, rid)
        rec["rolling_swap"] = {
            "results": results, "swap_s": swap_s, "requests": len(swap_log), "dropped": 0,
            "windows": [[s, e, r] for s, e, r in windows],
            "manifest_to_first_flip_s": {r: (f - t_manifest if f else None)
                                         for r, f in flips.items()},
            "samples": len(samples),
            "replica_bytes_before_swap": {r: h["hotswap"]["swap_bytes_before"]
                                          for r, h in final.items()},
            "replica_peak_bytes_across_swap": {r: h["hotswap"]["swap_peak_bytes"]
                                               for r, h in final.items()}}
        log("fleet_rolling_swap " + json.dumps(rec["rolling_swap"]))

        sup.close(timeout=120)
        codes = {rid: p.returncode for rid, p in sup.procs.items()}
        if codes != {rid: (-signal.SIGKILL if rid == victim else 0) for rid in sup.procs}:
            fail(f"fleet: replica exit codes {codes}: "
                 + json.dumps({r: list(lines)[-20:] for r, lines in sup.logs.items()}))
        rec["router"] = router.fleet_status()["fleet"]["routed"]
        memory["after"] = _smi_sample(cuda)
        rec["memory"] = memory
        rec["phase_s"] = time.perf_counter() - t_phase
        return rec
    finally:
        watchdog.cancel()
        sup.close(timeout=30)
        if single.poll() is None:
            single.kill()
            single.wait(timeout=30)
        router.close()
        del eng
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 14: checkpoint interop (hf_export / hf_import) at llama-1b
# ---------------------------------------------------------------------------

INTEROP_PRESET = "llama-1b"
#: the imported tree's greedy streams: prompt lengths and new tokens
INTEROP_PROMPTS = (16, 100, 250, 400, 600, 800, 1100, 1500)
INTEROP_NEW = 32
#: the planted fault: this layer's q_proj (square, 2048 × 2048) left
#: untransposed by the import; its last-position logits must part from the
#: original tree's by a relative L2 over INTEROP_FAULT_BOUND. The sound
#: import reads exactly 0 (the same bits through the same schedule), so the
#: bound only has to sit above 0
INTEROP_FAULT_LAYER = 11
INTEROP_FAULT_BOUND = 1e-3
#: host disk the phase's files take at their peak (two fp32 copies and the
#: export, ~4.4 GB each at llama-1b), with room to spare
INTEROP_DISK_BYTES = 16e9


def _interop_dir(need: float, home: pathlib.Path) -> pathlib.Path:
    """A directory with ``need`` bytes free: under ``home`` on the
    checkout's disk, else in ``/dev/shm``."""
    import tempfile

    home.mkdir(parents=True, exist_ok=True)
    for base in (home, pathlib.Path("/dev/shm")):
        if base.is_dir() and shutil.disk_usage(base).free >= need:
            return pathlib.Path(tempfile.mkdtemp(prefix="interop-", dir=base))
    fail(f"interop: no directory with {need / 1e9:.0f} GB free (checkout "
         f"{shutil.disk_usage(home).free / 1e9:.1f} GB)")


def _write_bf16_shards(torch, bin_path: pathlib.Path, out: pathlib.Path, n_shards: int = 2) -> dict:
    """A bf16 copy of an HF state dict as ``n_shards`` safetensors files and
    ``model.safetensors.index.json`` (the layout public llamas ship),
    written here: an 8-byte little-endian header length, the JSON header
    (dtype, shape, data offsets), the raw bytes. Tensor by tensor, from a
    memory-mapped load."""
    import struct

    sd = torch.load(bin_path, map_location="cpu", mmap=True, weights_only=True)
    names = list(sd)
    per = -(-len(names) // n_shards)
    weight_map, total = {}, 0
    for s in range(n_shards):
        part = names[s * per:(s + 1) * per]
        fname = f"model-{s + 1:05d}-of-{n_shards:05d}.safetensors"
        header, off = {}, 0
        for n in part:
            nbytes = sd[n].numel() * 2
            header[n] = {"dtype": "BF16", "shape": list(sd[n].shape),
                         "data_offsets": [off, off + nbytes]}
            off += nbytes
            weight_map[n] = fname
        blob = json.dumps(header).encode()
        blob += b" " * (-len(blob) % 8)
        with open(out / fname, "wb") as f:
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
            for n in part:
                sd[n].to(torch.bfloat16).contiguous().view(torch.int16).numpy().tofile(f)
        total += off
    (out / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return {"shards": n_shards, "tensors": len(names), "bytes": total}


def _host_cli_child(out_path: str, argv: list[str]) -> int:
    """``python -m MODULE ARGS`` (``argv``) run as ``__main__`` in a child
    of :func:`interop_phase`; writes to ``out_path`` whether the CLI
    initialized CUDA in its process."""
    import runpy

    import torch

    sys.path.insert(0, str(ROOT))
    sys.argv = list(argv)
    runpy.run_module(argv[0], run_name="__main__", alter_sys=True)
    pathlib.Path(out_path).write_text(json.dumps({"cuda_initialized":
                                                  torch.cuda.is_initialized()}))
    return 0


def _cli_child(work: pathlib.Path, tag: str, module: str, args: list[str]) -> float:
    """``python -m module args`` in a child (:func:`_host_cli_child`), which
    must open no CUDA context; returns its wall seconds."""
    t0 = time.perf_counter()
    with open(work / f"{tag}.log", "w") as out:
        rc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--host-cli",
                             str(work / f"{tag}.json"), "--", module, *args], cwd=ROOT,
                            stdout=out, stderr=subprocess.STDOUT, timeout=900).returncode
    if rc != 0:
        fail(f"interop: {module} exited {rc}: {(work / f'{tag}.log').read_text()[-3000:]}")
    if json.loads((work / f"{tag}.json").read_text())["cuda_initialized"]:
        fail(f"interop: {module} opened a CUDA context")
    return time.perf_counter() - t0


def _same_arrays(np, got: tuple, want: tuple, what: str) -> None:
    """(metadata, arrays) pairs: names, order, dtypes and bytes equal."""
    (gm, ga), (wm, wa) = got, want
    if gm.names != wm.names or gm.dtypes != wm.dtypes or gm.shapes != wm.shapes:
        fail(f"interop: {what} names, dtypes or shapes differ")
    bad = [n for n, a, b in zip(wm.names, ga, wa) if not np.array_equal(a.view(np.uint8),
                                                                        b.view(np.uint8))]
    if bad:
        fail(f"interop: {what} differs in {len(bad)} arrays, first {bad[:3]}")


def _interop_streams(torch, rpa, eng, prompts, new: int) -> dict:
    """Greedy streams of ``prompts`` through a ``ContinuousBatcher``
    (submitted before it starts: one FIFO schedule for every engine),
    K4 counted; then each prompt's last-position logits, in a second pass
    that stops at each row's first emission."""
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    b = ContinuousBatcher(eng, max_queue=len(prompts),
                          prefill_token_budget=eng.cfg.photon.serve.prefill_token_budget)
    reqs = [b.submit(p, new) for p in prompts]
    rpa.launches = 0
    t0 = time.perf_counter()
    b.start()
    outs = [r.result(timeout=600) for r in reqs]
    wall = time.perf_counter() - t0
    launches = rpa.launches
    b.close()
    st = b.stats()
    return {"outs": outs, "wall_s": wall, "launches": launches, "steps": int(st["steps"]),
            "chunk_steps": int(st["chunk_steps"]), "last_logits": _last_logits(torch, eng, prompts)}


def _last_logits(torch, eng, prompts):
    """Each prompt's logits at its last position (its first emission), the
    prompts admitted and prefilled in order on the engine's chunk budget."""
    budget = eng.cfg.photon.serve.prefill_token_budget
    queue, running, out = list(enumerate(prompts)), {}, {}
    while queue or running:
        while queue and eng.free_slot() is not None and eng.can_admit(len(queue[0][1]), 1):
            i, p = queue.pop(0)
            slot = eng.free_slot()
            eng.begin(slot, p, 1)
            running[slot] = i
        pre = [s for s in running if eng.pending_tokens(s) > 0]
        chunk = None
        if pre:
            s = min(pre, key=lambda s: running[s])
            chunk = (s, min(eng.pending_tokens(s), budget))
        _, emitted = eng.mixed_step(chunk)
        for s in sorted(running):
            if emitted[s]:
                out[running[s]] = eng.last_logits[s].float().clone()
                eng.evict(s)
                del running[s]
    return torch.stack([out[i] for i in range(len(prompts))])


def interop_phase(torch, rpa, np, cfg=None, device: str = "cuda",
                  prompts=INTEROP_PROMPTS, new: int = INTEROP_NEW,
                  fault_layer: int = INTEROP_FAULT_LAYER,
                  home: pathlib.Path = ROOT / ".chip_smoke") -> dict:
    """Phase 14, llama-1b at full width and depth (random weights, seed 0):
    (a) the tree's npz → ``python -m photon_tpu_torch.checkpoint.hf_export
    --format llama`` → ``python -m photon_tpu_torch.checkpoint.hf_import``
    (each a child that opens no CUDA context) → an npz equal to the
    original bit for bit; (b) a bf16 copy of the export as two safetensors
    shards and their index, written here, imported (``load_hf_llama`` in
    this process) equal to the bf16-rounded original; (c) the imported tree in a ragged engine on the
    card (bf16): 8 greedy prompts × 32 tokens equal the original tree's
    token for token, K4 launched ``n_layers`` × (steps + chunk steps), and
    the planted fault (layer ``fault_layer``'s q_proj left untransposed)
    parts the last-position logits over ``INTEROP_FAULT_BOUND``. Host
    copies are freed as the phase goes; its files are deleted."""
    from photon_tpu_torch.checkpoint.hf_import import load_hf_llama
    from photon_tpu_torch.checkpoint.serialization import arrays_to_npz, npz_to_arrays
    from photon_tpu_torch.codec.params import (
        ParamsMetadata,
        flatten,
        params_from_numpy,
        params_to_ndarrays,
    )
    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.serve.engine import PagedEngine

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    cfg = cfg or serve_config(INTEROP_PRESET)
    L = cfg.model.n_layers
    work = _interop_dir(INTEROP_DISK_BYTES if cuda else 0, home)
    rec: dict = {"preset": cfg.model.name, "dir": str(work), "prompts": list(prompts),
                 "new_tokens": new, "fault_layer": fault_layer}
    try:
        cfg.to_yaml(work / "model.yaml")
        meta, arrays = params_to_ndarrays(init_params(cfg.model, seed=0, device=device))
        if cuda:
            torch.cuda.empty_cache()
        rec["n_params"] = int(sum(a.size for a in arrays))
        orig = work / "orig.npz"
        orig.write_bytes(arrays_to_npz(meta, arrays))
        rec["export_s"] = _cli_child(work, "export", "photon_tpu_torch.checkpoint.hf_export", [
            "--params-npz", str(orig), "--config", str(work / "model.yaml"),
            "--out", str(work / "hf"), "--format", "llama"])
        rec["import_s"] = _cli_child(work, "import", "photon_tpu_torch.checkpoint.hf_import", [
            "--hf-dir", str(work / "hf"), "--out", str(work / "imported.npz"),
            "--config", str(work / "model.yaml")])
        rec["bytes"] = {"orig_npz": orig.stat().st_size,
                        "pytorch_model_bin": (work / "hf" / "pytorch_model.bin").stat().st_size,
                        "imported_npz": (work / "imported.npz").stat().st_size}
        imported = npz_to_arrays((work / "imported.npz").read_bytes())
        _same_arrays(np, imported, (meta, arrays), "the imported npz")
        rec["roundtrip_bit_equal"] = True
        for p in (orig, work / "imported.npz"):
            p.unlink()

        # (b) bf16 shards under an index
        (work / "bf16").mkdir()
        shutil.copy(work / "hf" / "config.json", work / "bf16" / "config.json")
        t0 = time.perf_counter()
        rec["bf16_shards"] = _write_bf16_shards(torch, work / "hf" / "pytorch_model.bin",
                                                work / "bf16")
        rec["bf16_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, tree = load_hf_llama(str(work / "bf16"), cfg.model)
        flat = flatten(tree)
        del tree
        got = [t.numpy() for t in flat.values()]
        rec["bf16_import_s"] = time.perf_counter() - t0
        rounded = [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrays]
        _same_arrays(np, (ParamsMetadata.from_ndarrays(flat, got), got), (meta, rounded),
                     "the bf16 import")
        rec["bf16_import_equals_rounded"] = True
        del flat, got, rounded
        shutil.rmtree(work / "bf16")

        # (c) the imported tree served through K4 against the original's
        rng = np.random.default_rng(14)
        ps = [list(map(int, rng.integers(0, cfg.model.vocab_size, n))) for n in prompts]
        runs = {}
        fault_arrays = list(imported[1])
        q = meta.names.index("blocks/block/q_proj/kernel")
        fault_arrays[q] = fault_arrays[q].copy()
        fault_arrays[q][fault_layer] = fault_arrays[q][fault_layer].T
        for tag, arrs in (("original", arrays), ("imported", imported[1]),
                          ("fault", fault_arrays)):
            eng = PagedEngine(cfg, params_from_numpy(meta.names, arrs, cfg.model, device),
                              device=device)
            if cuda and eng.attn_impl != "ragged":
                fail(f"interop: the engine runs {eng.attn_impl}, not K4")
            runs[tag] = _interop_streams(torch, rpa, eng, ps, new) if tag != "fault" \
                else {"last_logits": _last_logits(torch, eng, ps)}
            del eng
            if cuda:
                torch.cuda.empty_cache()
        del arrays, imported, fault_arrays
        o, i, f = runs["original"], runs["imported"], runs["fault"]
        parted = [k for k, (a, b) in enumerate(zip(i["outs"], o["outs"])) if a != b]
        if parted or any(len(x) != new for x in i["outs"]):
            fail(f"interop: the imported tree's streams part from the original's in rows {parted}")
        want = L * (i["steps"] + i["chunk_steps"])
        if cuda and (i["launches"] != want or want == 0):
            fail(f"interop: K4 launched {i['launches']} times, want {want}")
        sound = _rel_l2(i["last_logits"], o["last_logits"])
        fault = _rel_l2(f["last_logits"], o["last_logits"])
        if not (torch.isfinite(i["last_logits"]).all() and sound <= INTEROP_FAULT_BOUND < fault):
            fail(f"interop: last-position logits sound {sound:.3e}, untransposed q_proj "
                 f"{fault:.3e}, bound {INTEROP_FAULT_BOUND}")
        rec["serve"] = {"streams_equal": True, "launches": i["launches"], "steps": i["steps"],
                        "chunk_steps": i["chunk_steps"], "wall_s": i["wall_s"],
                        "original_wall_s": o["wall_s"],
                        "tokens_per_s": len(prompts) * new / i["wall_s"],
                        "logits_rel_l2_sound": sound, "logits_rel_l2_fault": fault,
                        "fault_bound": INTEROP_FAULT_BOUND}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log("interop_phase " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phase 15: seeded faults under federated rounds over TCP
# ---------------------------------------------------------------------------

CHAOS_RUN = "chip-smoke-chaos"
#: small per-frame fault probabilities (``photon.chaos``)
CHAOS_KNOBS = {"tcp_drop_p": 0.02, "tcp_corrupt_p": 0.02, "tcp_duplicate_p": 0.05,
               "tcp_delay_p": 0.1}
#: a seed found by :func:`chaos_seed_plan` over seeds 0–2,000,000 on the
#: CPU (the first of two): the server's stream drops its 6th envelope (round
#: 1's liveness ping to node1) and corrupts its 10th (round 1's FitIns to
#: node1); no other drop or corrupt in the server's first CHAOS_CLEAN
#: frames, whatever the corrupted frame's length does to the stream after
#: it, nor in the nodes'. A drop is survivable only on a ping (a lost
#: broadcast or its ack would time the run out), so the seed is chosen, not
#: searched for on the card.
CHAOS_SEED = 528453
CHAOS_PLAN = {"drop": 6, "corrupt": 10}
#: the server's envelope sends, in order, without faults: round 0's
#: broadcast (1, 2) and EvaluateIns (3, 4); round 1's pings (5, 6),
#: broadcast (7, 8) and FitIns (9, 10). Frames checked clean per scope
#: (the run sends ~40, ~20 and ~8 + ~8)
CHAOS_DROP_FRAMES, CHAOS_CORRUPT_FRAMES = (5, 6), (9, 10)
CHAOS_CLEAN = {"server": 48, "node0": 24, "node1": 16}
#: bound on a lost frame's wait (a fit or eval reply), and on a ping's
CHAOS_TIMEOUT_S, CHAOS_PING_S = 60.0, 2.0
CHAOS_WAIT_S = 600.0


def _tcp_fault(plan) -> str:
    return "drop" if plan.drop else "corrupt" if plan.corrupt else ""


def chaos_seed_plan(seed: int, knobs: dict = CHAOS_KNOBS) -> dict | None:
    """Replays the port's ``FaultInjector`` for the scopes ``server``,
    ``node0`` and ``node1``: ``{"drop": i, "corrupt": j}`` when the server's
    stream drops exactly its i-th envelope (in CHAOS_DROP_FRAMES), then
    corrupts its j-th (in CHAOS_CORRUPT_FRAMES), and no other envelope of
    the server's first CHAOS_CLEAN frames is dropped or corrupted (checked
    for 2–12 draws taken by the corruption's two ``randrange`` calls, whose
    count depends on the frame's length), nor any of the nodes'; else None."""
    from photon_tpu_torch.chaos.injector import FaultInjector
    from photon_tpu_torch.config.schema import ChaosConfig

    cfg = ChaosConfig(enabled=True, seed=seed, **knobs)
    for scope in ("node0", "node1"):
        inj = FaultInjector(cfg, scope=scope)
        if any(_tcp_fault(inj.tcp_plan()) for _ in range(CHAOS_CLEAN[scope])):
            return None
    inj = FaultInjector(cfg, scope="server")
    drop = None
    for frame in range(1, CHAOS_CLEAN["server"] + 1):
        kind = _tcp_fault(inj.tcp_plan())
        if kind == "drop":
            if drop is not None or frame not in CHAOS_DROP_FRAMES:
                return None
            drop = frame
        elif kind == "corrupt":
            if drop is None or frame not in CHAOS_CORRUPT_FRAMES:
                return None
            state = inj.rng.getstate()
            for taken in range(2, 13):
                inj.rng.setstate(state)
                for _ in range(taken):
                    inj.rng.getrandbits(32)
                if any(_tcp_fault(inj.tcp_plan())
                       for _ in range(frame + 1, CHAOS_CLEAN["server"] + 1)):
                    return None
            return {"drop": drop, "corrupt": frame}
    return None


def _frame_audit(path: pathlib.Path) -> None:
    """Patched in from outside the package in a chaos child: every frame a
    ``SocketConn`` unpickles, every frame its CRC refuses, every payload the
    injector corrupts and every TCP plan that fired, each a JSON line in
    ``path`` written at once (so a crashed process keeps its record); the
    CRC32 of each payload identifies it across processes."""
    import pickle
    import zlib

    from photon_tpu_torch.chaos import injector
    from photon_tpu_torch.federation import tcp

    sink = open(path, "a", buffering=1)

    def note(**ev):
        sink.write(json.dumps(ev) + "\n")

    real_corrupt, real_plan, real_recv = (injector.FaultInjector.corrupt_bytes,
                                          injector.FaultInjector.tcp_plan, tcp.SocketConn.recv)

    def corrupt_bytes(self, data):
        out = real_corrupt(self, data)
        note(event="corrupted", crc=zlib.crc32(out), scope=self.scope)
        return out

    def tcp_plan(self):
        plan = real_plan(self)
        if _tcp_fault(plan):
            note(event=_tcp_fault(plan), scope=self.scope)
        return plan

    def recv(self):
        try:
            return real_recv(self)
        except tcp.CorruptFrameError as e:
            if "CRC" in str(e):
                note(event="refused")
            raise

    class _Pickle:
        HIGHEST_PROTOCOL = pickle.HIGHEST_PROTOCOL
        dumps = staticmethod(pickle.dumps)

        @staticmethod
        def loads(data):
            note(event="decoded", crc=zlib.crc32(data))
            return pickle.loads(data)

    injector.FaultInjector.corrupt_bytes = corrupt_bytes
    injector.FaultInjector.tcp_plan = tcp_plan
    tcp.SocketConn.recv = recv
    tcp.pickle = _Pickle


def _tcp_node_child(out_path: str, cli_args: list[str]) -> int:
    """``python -m photon_tpu_torch.federation.tcp`` (its ``main``) in a
    child of :func:`chaos_phase`, the launch counts set to 0 just before
    it and :func:`_frame_audit` on; writes the counts, the fits and evals
    this node ran and its injector's counters to ``out_path`` when it
    exits (a chaos crash exits before that)."""
    import torch

    sys.path.insert(0, str(ROOT))
    from photon_tpu_torch import chaos
    from photon_tpu_torch.federation import node as node_mod
    from photon_tpu_torch.federation import tcp
    from photon_tpu_torch.ops import flash_attention as fa

    _frame_audit(pathlib.Path(out_path).with_suffix(".audit.jsonl"))
    fits, evals = [], []
    real_make = node_mod.make_node_agent

    def make_agent(c, node_id, device):
        agent = real_make(c, node_id, device)
        rt = agent.runtime
        real_fit, real_eval = rt.fit, rt.evaluate

        def fit(ins, cid):
            res = real_fit(ins, cid)
            fits.append([ins.server_round, cid, res.error is None])
            return res

        def evaluate(ins, cid):
            res = real_eval(ins, cid)
            evals.append([ins.server_round, cid, res.error is None])
            return res

        rt.fit, rt.evaluate = fit, evaluate
        return agent

    node_mod.make_node_agent = make_agent
    for key in fa.launches:
        fa.launches[key] = 0
    tcp.main(cli_args)
    inj = chaos.active()
    pathlib.Path(out_path).write_text(json.dumps({
        "launches": dict(fa.launches), "fits": fits, "evals": evals,
        "chaos_counts": inj.counts if inj is not None else None,
        "cuda_initialized": torch.cuda.is_initialized()}))
    return 0


def _read_audit(work: pathlib.Path) -> dict:
    events = [json.loads(ln) for p in sorted(work.glob("*.audit.jsonl"))
              for ln in p.read_text().splitlines() if ln.strip()]
    corrupted = {e["crc"] for e in events if e["event"] == "corrupted"}
    decoded = {e["crc"] for e in events if e["event"] == "decoded"}
    return {"fired": {k: sum(e["event"] == k for e in events) for k in ("drop", "corrupt")},
            "corrupted": len(corrupted), "refused": sum(e["event"] == "refused" for e in events),
            "decoded": len(decoded), "corrupted_and_decoded": sorted(corrupted & decoded)}


def chaos_phase(torch, np, fa, cfg=None, device: str = "cuda",
                work: pathlib.Path = ROOT / ".chip_smoke" / "chaos") -> dict:
    """Phase 15, full-width mpt-125m under phase 5's ``FED_SETS``: 3
    federated rounds over TCP with ``photon.chaos`` on (``CHAOS_SEED``,
    ``CHAOS_KNOBS``; a mid-fit crash of node1 in round 2 with a marker
    file): a ``--tcp-listen`` server child (no CUDA context) and two
    ``federation.tcp`` node children (:func:`_tcp_node_child`); node1 is
    started again after its ``os._exit(137)``. Gates: the 3 rounds finish
    with no round failed; node1 exits 137 exactly once and the marker
    exists; at least one readmission; across the processes' counters at
    least one ``tcp_drop`` and one ``tcp_corrupt``; every corrupted frame
    refused by the CRC and none decoded (:func:`_frame_audit`); the final
    parameters finite; node0's K1–K3 launches exact for the fits and evals
    it ran. Store faults stay in the CPU tests."""
    import socket

    from photon_tpu_torch.centralized import _apply_override
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    plan = chaos_seed_plan(CHAOS_SEED)
    if plan != CHAOS_PLAN:
        fail(f"chaos: seed {CHAOS_SEED} replays as {plan}, want {CHAOS_PLAN}")
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    if cfg is None:
        cfg = train_config()
        for s in FED_SETS:
            _apply_override(cfg, *s.split("=", 1))
    cfg.run_uuid, cfg.photon.save_path = CHAOS_RUN, str(work / "run")
    cfg.dataset.synthetic = True
    cfg.fl.n_rounds, cfg.fl.accept_failures_cnt = 3, 1
    cfg.fl.fit_timeout_s = cfg.fl.eval_timeout_s = CHAOS_TIMEOUT_S
    cfg.photon.membership.ping_timeout_s = CHAOS_PING_S
    cfg.photon.comm_stack.objstore, cfg.photon.comm_stack.shm = True, False
    ch = cfg.photon.chaos
    ch.enabled, ch.seed = True, CHAOS_SEED
    for k, v in CHAOS_KNOBS.items():
        setattr(ch, k, v)
    ch.crash_phase, ch.crash_round, ch.crash_node_id = "mid-fit", 2, "node1"
    ch.crash_marker = str(work / "crash_marker")
    cfg.validate()
    cfg.to_yaml(work / "chaos.yaml")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    addr = f"127.0.0.1:{port}"
    rec: dict = {"seed": CHAOS_SEED, "plan": plan, "knobs": CHAOS_KNOBS, "port": port}

    def node(nid: str, tag: str) -> subprocess.Popen:
        with open(work / f"{tag}.log", "w") as out:
            return subprocess.Popen(
                [sys.executable, "-X", "faulthandler", str(ROOT / "chip_smoke.py"),
                 "--tcp-node-child", str(work / f"{tag}.json"), "--", "--connect", addr,
                 "--node-id", nid, "--config", str(work / "chaos.yaml"), "--device", device],
                cwd=ROOT, stdout=out, stderr=out)

    procs: dict[str, subprocess.Popen] = {}
    try:
        started = _fed_cli_start(work, "server", ["--config", str(work / "chaos.yaml"),
                                                  "--tcp-listen", addr, "--nodes", "2"],
                                 opts=("--frame-audit",))
        t0 = time.perf_counter()
        while "listening on" not in (work / "child-server.out").read_text():
            if time.perf_counter() - t0 > 120 or started[0].poll() is not None:
                fail("chaos: the server never listened")
            time.sleep(0.1)
        procs["node0"], procs["node1"] = node("node0", "node0"), node("node1", "node1-a")
        while procs["node1"].poll() is None:
            if time.perf_counter() - t0 > CHAOS_WAIT_S or started[0].poll() is not None:
                fail(f"chaos: node1 never crashed (server {started[0].poll()})")
            time.sleep(0.05)
        rec["node1_first_exit"] = procs["node1"].returncode
        rec["crash_at_s"] = time.perf_counter() - t0
        if procs["node1"].returncode != 137:
            fail(f"chaos: node1 exited {procs['node1'].returncode}, want 137: "
                 f"{(work / 'node1-a.log').read_text()[-3000:]}")
        procs["node1b"] = node("node1", "node1-b")
        run = _fed_cli_finish(work, "server", started, timeout=CHAOS_WAIT_S)
        rec["wall_s"] = time.perf_counter() - t0
        for name in ("node0", "node1b"):
            rc = procs[name].wait(timeout=120)
            if rc != 0:
                fail(f"chaos: {name} exited {rc} after the server's shutdown")
    except BaseException:
        _keep_logs(work)
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        raise
    hist = run["history"]
    node0 = json.loads((work / "node0.json").read_text())
    node1b = json.loads((work / "node1-b.json").read_text())
    counts = {k: sum((c or {}).get(k, 0) for c in (run["chaos_counts"], node0["chaos_counts"],
                                                   node1b["chaos_counts"]))
              for k in ("tcp_drop", "tcp_delay", "tcp_duplicate", "tcp_corrupt", "crash")}
    audit = _read_audit(work)
    rounds = [r for r, _ in hist.get("server/n_clients", [])]

    def fired(child: dict) -> dict:
        return {k: v for k, v in (child["chaos_counts"] or {}).items() if v}

    final = ServerCheckpointManager(FileStore(work / "run" / "store"), CHAOS_RUN)
    params = final.load_round_params(3)[1]
    rec.update({
        "rounds": _round_breakdown(hist, [1, 2, 3]), "n_clients": hist.get("server/n_clients"),
        "eval_loss": hist.get("server/eval_loss"),
        "nodes_readmitted_total": run["final_line"].get("server/nodes_readmitted_total", 0.0),
        "chaos_counts": {"server": fired(run), "node0": fired(node0),
                         "node1_restarted": fired(node1b), "total": counts},
        "audit": audit, "node0_fits": node0["fits"], "node0_evals": node0["evals"],
        "launches": node0["launches"], "server_cuda_initialized": run["cuda_initialized"],
        "params_finite": bool(all(np.isfinite(a).all() for a in params))})
    if rounds != [1, 2, 3] or hist.get("server/round_failed"):
        fail(f"chaos: rounds {rounds}, failed {hist.get('server/round_failed')}")
    if not (work / "crash_marker").exists() or not rec["nodes_readmitted_total"] >= 1:
        fail(f"chaos: crash marker {(work / 'crash_marker').exists()}, readmitted "
             f"{rec['nodes_readmitted_total']}")
    if counts["tcp_drop"] < 1 or counts["tcp_corrupt"] < 1:
        fail(f"chaos: the processes' counters {counts}: want a tcp_drop and a tcp_corrupt")
    if audit["refused"] != audit["corrupted"] or audit["corrupted"] < 1 \
            or audit["corrupted_and_decoded"]:
        fail(f"chaos: frames {audit}: every corrupted frame must be refused by its CRC, none "
             "decoded")
    if not rec["params_finite"] or run["cuda_initialized"]:
        fail(f"chaos: params finite {rec['params_finite']}, server CUDA {run['cuda_initialized']}")
    L = cfg.model.n_layers
    per_fit = L * (cfg.train.global_batch_size // cfg.train.device_microbatch_size) \
        * cfg.fl.local_steps
    n_fit = sum(ok for *_, ok in node0["fits"])
    n_eval = sum(ok for *_, ok in node0["evals"])
    want = {"flash_fwd": per_fit * n_fit + L * cfg.train.eval_batches * n_eval,
            "flash_bwd_dq": per_fit * n_fit, "flash_bwd_dkv": per_fit * n_fit}
    if cuda and (node0["launches"] != want or n_fit == 0):
        fail(f"chaos: node0 launched {node0['launches']}, want {want} ({n_fit} fits, "
             f"{n_eval} evals)")
    shutil.rmtree(work, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log("chaos_phase " + json.dumps({k: v for k, v in rec.items() if k != "rounds"}))
    return rec


# ---------------------------------------------------------------------------
# phase 16: the telemetry plane
# ---------------------------------------------------------------------------

TEL_RUN = "chip-smoke-telemetry"
#: (a): 2 rounds × 2 clients × 2 local steps over TCP, eval at rounds 0 and
#: 2 (FED_SETS' interval), a torch.profiler capture over round 1
TEL_ROUNDS, TEL_LOCAL_STEPS = 2, 2
#: (b): 16 greedy requests of 16–1500 prompt tokens × 32 new tokens
TEL_PROMPTS = (16, 100, 250, 400, 600, 800, 1100, 1500) * 2
TEL_NEW = 32
#: (b): scheduler ticks the on-demand capture covers, and the requests
#: that drive them (8 slots decoding at once)
TEL_PROFILE_TICKS = 8
TEL_PROFILE_PROMPTS = (100,) * 8
#: K4's kernels, as a demangled profiler record names them
TEL_K4_KERNELS = ("rpa_split_kernel", "rpa_combine_kernel", "rpa_verify_kernel",
                  "rpa_chunk_kernel")
TEL_WAIT_S = 600.0
#: how often (a) scrapes the server's /metrics and /statusz
TEL_SCRAPE_S = 0.25


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scrape(port: int, path: str, accept: str | None = None) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path, headers={"Accept": accept} if accept else {})
        resp = conn.getresponse()
        body = resp.read().decode()
        if resp.status != 200:
            raise OSError(f"GET {path}: {resp.status}")
        return body
    finally:
        conn.close()


def _validated(text: str, what: str) -> dict:
    from photon_tpu_torch.telemetry.prom import validate_exposition

    try:
        return validate_exposition(text)
    except ValueError as e:
        fail(f"telemetry: {what} fails the exposition check: {e}")


def _telemetry_fed(cfg, device: str, work: pathlib.Path) -> dict:
    """(a): a ``--tcp-listen`` server child (no CUDA context) and two
    ``federation.tcp`` node children (:func:`_tcp_node_child`) with
    ``photon.telemetry`` on, a ``prom_port`` and ``profile_rounds: 1``;
    ``/metrics`` and ``/statusz`` scraped while the run trains."""
    from photon_tpu_torch.telemetry.events import read_events_jsonl
    from photon_tpu_torch.telemetry.export import load_chrome_trace, span_index

    tel = cfg.photon.telemetry
    tel.enabled, tel.prom_port, tel.profile_rounds = True, _free_port(), 1
    tel.dir = str(work / "telemetry")
    cfg.validate()
    cfg.to_yaml(work / "fed.yaml")
    addr = f"127.0.0.1:{_free_port()}"

    def node(nid: str) -> subprocess.Popen:
        with open(work / f"{nid}.log", "w") as out:
            return subprocess.Popen(
                [sys.executable, "-X", "faulthandler", str(ROOT / "chip_smoke.py"),
                 "--tcp-node-child", str(work / f"{nid}.json"), "--", "--connect", addr,
                 "--node-id", nid, "--config", str(work / "fed.yaml"), "--device", device],
                cwd=ROOT, stdout=out, stderr=out)

    procs: dict[str, subprocess.Popen] = {}
    scrapes: list[dict] = []
    try:
        # the nodes start with the server and redial until it listens
        t0 = time.perf_counter()
        started = _fed_cli_start(work, "server", ["--config", str(work / "fed.yaml"),
                                                  "--tcp-listen", addr, "--nodes", "2"])
        procs = {nid: node(nid) for nid in ("node0", "node1")}
        while started[0].poll() is None:
            if time.perf_counter() - t0 > TEL_WAIT_S:
                fail("telemetry: the traced run did not finish")
            try:
                metrics = _scrape(tel.prom_port, "/metrics")
                statusz = json.loads(_scrape(tel.prom_port, "/statusz"))
            except (OSError, http.client.HTTPException, json.JSONDecodeError):
                time.sleep(TEL_SCRAPE_S)  # not up yet, or closing
                continue
            fams = _validated(metrics, "a mid-run scrape of the server")
            scrapes.append({
                "at_s": time.perf_counter() - t0,
                "last_round": fams["photon_last_round"]["value"],
                "tcp_send_count": fams.get("photon_tcp_send_bytes", {}).get("count", 0.0),
                "families": len(fams), "statusz": statusz["status"]})
            time.sleep(TEL_SCRAPE_S)
        run = _fed_cli_finish(work, "server", started, timeout=TEL_WAIT_S)
        rec = {"wall_s": time.perf_counter() - t0}
        for nid, p in procs.items():
            rc = p.wait(timeout=120)
            if rc != 0:
                fail(f"telemetry: {nid} exited {rc}: {(work / f'{nid}.log').read_text()[-3000:]}")
    except BaseException:
        _keep_logs(work)
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        raise
    tdir = pathlib.Path(tel.dir)
    trace_path = tdir / f"trace-{TEL_RUN}.json"
    trace = load_chrome_trace(trace_path)
    pid_names = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"] if e.get("ph") == "M"}
    complete = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    procs_seen = sorted({pid_names[e["pid"]] for e in complete})
    idx = span_index(trace)
    orphans = []
    counted = {}
    for name, parent in (("client/fit", "server/fit_round_time"),
                         ("client/evaluate", "server/eval_round")):
        spans = [e for e in complete if e["name"] == name]
        counted[name] = len(spans)
        for sp in spans:
            up = idx.get(sp["args"].get("parent_id"))
            if up is None or up["name"] != parent or pid_names[up["pid"]] != "server" \
                    or up["args"].get("round") != sp["args"].get("round") \
                    or up["args"]["trace_id"] != sp["args"]["trace_id"]:
                orphans.append([name, pid_names[sp["pid"]], sp["args"].get("round"),
                                None if up is None else up["name"]])
    events = read_events_jsonl(str(tdir / f"events-{TEL_RUN}.jsonl"))
    members = sorted({e["attrs"].get("node") for e in events
                      if e["kind"] == "membership/transition"})
    done = (run["profile"] or {}).get("completed") or []
    artifact = pathlib.Path(done[0]["dir"]) / "trace.json" if done else None
    profile = json.loads(artifact.read_text()) if artifact and artifact.exists() else None
    node0 = json.loads((work / "node0.json").read_text())
    hist = run["history"]
    rec.update({
        "trace_bytes": trace_path.stat().st_size, "trace_spans": len(complete),
        "trace_events": sum(e.get("ph") == "i" for e in trace["traceEvents"]),
        "processes": procs_seen, "spans_by_name": counted, "orphans": orphans,
        "event_log_lines": len(events), "membership_nodes": members,
        "scrapes": len(scrapes), "scrape_first": scrapes[0] if scrapes else None,
        "scrape_last": scrapes[-1] if scrapes else None,
        "statusz_end": run["statusz"]["status"] if run["statusz"] else None,
        "profile": {"artifact": str(artifact) if artifact else None,
                    "bytes": artifact.stat().st_size if profile else 0,
                    "records": len(profile["traceEvents"]) if profile else 0,
                    "last_error": (run["profile"] or {}).get("last_error")},
        "server_cuda_initialized": run["cuda_initialized"], "launches": node0["launches"],
        "node0_fits": node0["fits"], "node0_evals": node0["evals"],
        "rounds": [r for r, _ in hist.get("server/n_clients", [])],
        "round_wall_s": [v for _, v in hist.get("server/round_time", [])]})
    if rec["rounds"] != list(range(1, TEL_ROUNDS + 1)):
        fail(f"telemetry: rounds {rec['rounds']}")
    if procs_seen != ["node0", "node1", "server"]:
        fail(f"telemetry: the merged trace holds spans from {procs_seen}")
    n_clients = cfg.fl.n_clients_per_round
    if counted["client/fit"] != TEL_ROUNDS * n_clients or counted["client/evaluate"] != \
            2 * cfg.fl.n_total_clients or orphans:
        fail(f"telemetry: node spans {counted}, not under their round's server span: {orphans}")
    if members != ["node0", "node1"]:
        fail(f"telemetry: membership transitions for {members}")
    if not scrapes or not any(s["tcp_send_count"] > 0 for s in scrapes) \
            or any(s["statusz"] != "ok" for s in scrapes) or rec["statusz_end"] != "ok":
        fail(f"telemetry: scrapes {scrapes}, /statusz at the end {rec['statusz_end']}")
    if profile is None or rec["profile"]["last_error"] or done[0]["tag"] != "startup":
        fail(f"telemetry: the round-1 profile {run['profile']}")
    if run["cuda_initialized"]:
        fail("telemetry: the --tcp-listen server opened a CUDA context")
    L = cfg.model.n_layers
    per_fit = L * (cfg.train.global_batch_size // cfg.train.device_microbatch_size) \
        * cfg.fl.local_steps
    n_fit = sum(ok for *_, ok in node0["fits"])
    n_eval = sum(ok for *_, ok in node0["evals"])
    want = {"flash_fwd": per_fit * n_fit + L * cfg.train.eval_batches * n_eval,
            "flash_bwd_dq": per_fit * n_fit, "flash_bwd_dkv": per_fit * n_fit}
    if device == "cuda" and (node0["launches"] != want or n_fit == 0):
        fail(f"telemetry: node0 launched {node0['launches']}, want {want} ({n_fit} fits, "
             f"{n_eval} evals)")
    return rec


def _telemetry_serve(np, scfg, device: str, work: pathlib.Path, store: pathlib.Path) -> dict:
    """(b): ``python -m photon_tpu_torch.serve`` on (a)'s round 2 with
    ``photon.telemetry`` on. (Its off/on decode passes in this process, ~10
    s and recorded only, were cut to keep the smoke within its time once
    phase 18 joined.)"""
    import re


    tel = scfg.photon.telemetry
    tel.enabled, tel.dir = True, str(work / "serve_telemetry")
    scfg.run_uuid = TEL_RUN
    scfg.photon.serve.attention_impl = "auto"
    scfg.to_yaml(work / "serve.yaml")
    cmd = [sys.executable, "-m", "photon_tpu_torch.serve", "--config", str(work / "serve.yaml"),
           "--store", str(store), "--round", "-1", "--enable", "--port", "0",
           "--device", device]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    stderr_tail: list[str] = []
    threading.Thread(target=lambda: stderr_tail.extend(proc.stderr), daemon=True).start()
    watchdog = threading.Timer(TEL_WAIT_S, proc.kill)
    watchdog.start()
    cuda = device == "cuda"
    try:
        t0 = time.perf_counter()
        first = proc.stdout.readline()
        if not first:
            proc.wait(timeout=30)
            fail(f"telemetry: the serve CLI exited {proc.returncode}: "
                 f"{''.join(stderr_tail)[-3000:]}")
        info = json.loads(first)
        port = info["port"]
        rec: dict = {"startup_s": time.perf_counter() - t0, "round": info["round"]}
        if info["round"] != TEL_ROUNDS:
            fail(f"telemetry: the serve CLI loaded round {info['round']}, want {TEL_ROUNDS}")
        rng = np.random.default_rng(16)
        vocab = scfg.model.vocab_size
        prompts = [list(map(int, rng.integers(0, vocab, n))) for n in TEL_PROMPTS]
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            replies = list(pool.map(lambda p: _generate(port, p, TEL_NEW), prompts))
        rec["requests_wall_s"] = time.perf_counter() - t1
        bad = [[n, s] for n, (s, r) in zip(TEL_PROMPTS, replies)
               if s != 200 or r is None or len(r["tokens"]) != TEL_NEW]
        if bad:
            fail(f"telemetry: serve requests answered {bad}")
        health = json.loads(_request(port, "/healthz")[1])
        st = health["stats"]
        launches = health["kernel_launches"]["ragged_paged_attention"]
        want = scfg.model.n_layers * int(st["steps"] + st["chunk_steps"])
        if cuda and (launches != want or launches == 0):
            fail(f"telemetry: the serve CLI launched K4 {launches} times, want {want}")
        plain = _scrape(port, "/metrics")
        fams = _validated(plain, "the serve CLI's scrape")
        om = _scrape(port, "/metrics", accept="application/openmetrics-text")
        _validated(om, "the serve CLI's OpenMetrics scrape")
        ttft = fams.get("photon_serve_ttft_s", {})
        exemplars = re.findall(r'photon_serve_ttft_s_bucket\{[^}]*\} \d+ # \{trace_id="'
                               r'([0-9a-f]{16})"', om)
        hbm = fams.get("photon_serve_hbm_bytes_in_use", {}).get("value", 0.0)
        compiles = fams.get("photon_serve_backend_compiles_total", {}).get("value")
        statusz = json.loads(_scrape(port, "/statusz"))
        rec.update({"steps": st["steps"], "chunk_steps": st["chunk_steps"], "launches": launches,
                    "ttft_count": ttft.get("count"), "exemplar_trace_ids": len(exemplars),
                    "families": len(fams), "hbm_bytes_in_use": hbm, "compiles": compiles,
                    "statusz": statusz["status"], "scrape_bytes": len(plain),
                    "openmetrics_bytes": len(om)})
        if ttft.get("count") != len(prompts) or not exemplars or '# EOF' not in om:
            fail(f"telemetry: serve/ttft_s count {ttft.get('count')} (want {len(prompts)}), "
                 f"{len(exemplars)} exemplars with a trace id")
        if statusz["status"] != "ok" or (cuda and not hbm > 0):
            fail(f"telemetry: /statusz {statusz['status']}, serve/hbm_bytes_in_use {hbm}")
        # an on-demand capture over TEL_PROFILE_TICKS scheduler ticks
        status, body = _request(port, "/debug/profile", {"units": TEL_PROFILE_TICKS,
                                                         "tag": "serve"})
        if status != 202:
            fail(f"telemetry: POST /debug/profile answered {status}: {body}")
        t2 = time.perf_counter()
        more = [list(map(int, rng.integers(0, vocab, n))) for n in TEL_PROFILE_PROMPTS]
        with concurrent.futures.ThreadPoolExecutor(len(more)) as pool:
            replies = list(pool.map(lambda p: _generate(port, p, TEL_NEW), more))
        if any(s != 200 for s, _ in replies):
            fail(f"telemetry: the profiled requests answered {[s for s, _ in replies]}")
        while not (prof := json.loads(_scrape(port, "/statusz"))["profile"])["completed"]:
            if time.perf_counter() - t2 > 120 or prof["last_error"]:
                fail(f"telemetry: the serve capture never completed: {prof}")
            time.sleep(0.1)
        rec["profile_wall_s"] = time.perf_counter() - t2
        artifact = pathlib.Path(prof["completed"][0]["dir"]) / "trace.json"
        trace = json.loads(artifact.read_text())
        names = sorted({e.get("name", "") for e in trace["traceEvents"]
                        if e.get("cat") == "kernel"})
        plain_names = _demangle(names)
        k4 = sorted({k for n in names for k in TEL_K4_KERNELS if k in plain_names[n]})
        rec["profile"] = {"bytes": artifact.stat().st_size, "records": len(trace["traceEvents"]),
                          "kernel_names": len(names), "k4_kernels": k4,
                          "last_error": prof["last_error"]}
        if prof["last_error"] or (cuda and not k4):
            fail(f"telemetry: the serve capture holds no K4 kernel: {rec['profile']}, "
                 f"kernels {names[:20]}")
        again = _validated(_scrape(port, "/metrics"), "the serve CLI's second scrape")
        rec["compiles_after"] = again.get("photon_serve_backend_compiles_total", {}).get("value")
        if rec["compiles_after"] != compiles or compiles is None or (cuda and compiles < 1):
            fail(f"telemetry: serve/backend_compiles_total moved after warm-up: {compiles} → "
                 f"{rec['compiles_after']}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        if rc != 0:
            fail(f"telemetry: the serve CLI exited {rc} after SIGTERM: "
                 f"{''.join(stderr_tail)[-3000:]}")
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return rec


def telemetry_phase(np, cfg=None, scfg=None, device: str = "cuda",
                    work: pathlib.Path = ROOT / ".chip_smoke" / "telemetry") -> dict:
    """Phase 16: (a) a traced federated run over TCP at full-width mpt-125m
    (:func:`_telemetry_fed`), then (b) the serve CLI with telemetry on its
    round 2 (:func:`_telemetry_serve`)."""
    from photon_tpu_torch.centralized import _apply_override

    t_phase = time.perf_counter()
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    if cfg is None:
        cfg = train_config()
        for s in FED_SETS:
            _apply_override(cfg, *s.split("=", 1))
    cfg.run_uuid, cfg.photon.save_path = TEL_RUN, str(work / "run")
    cfg.dataset.synthetic = True
    cfg.fl.n_rounds, cfg.fl.local_steps = TEL_ROUNDS, TEL_LOCAL_STEPS
    cfg.photon.comm_stack.objstore, cfg.photon.comm_stack.shm = True, False
    try:
        t0 = time.perf_counter()
        fed = _telemetry_fed(cfg, device, work)
        fed["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve = _telemetry_serve(np, scfg if scfg is not None else serve_config(), device,
                                 work, work / "run" / "store")
        serve["phase_s"] = time.perf_counter() - t0
    except BaseException:
        _keep_logs(work)
        raise
    shutil.rmtree(work, ignore_errors=True)
    rec = {"fed": fed, "serve": serve, "phase_s": time.perf_counter() - t_phase}
    log("telemetry_phase " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phase 17: the SLO autopilot and the runtime guards
# ---------------------------------------------------------------------------

#: (a): the storm. 24 greedy requests of 600–1500 tokens × 16 queue at once
#: behind 8 slots (16 wait: frac 0.5 of max_queue 32), then a trickle of
#: short ones keeps ticks going until the budget is back at its declared
#: value. period_s is 0.01: a relax probe moves an integer knob one unit
#: (JAX's ``_relax_step``), so 64 → 512 takes 448 probes of relax_after
#: evaluations each, 67 s at a period of 0.05 s
AP_MAX_QUEUE = 32
AP_STORM = 24
AP_STORM_PROMPT = (600, 1501)
AP_STORM_NEW = 16
AP_STORM_AUTOPILOT = {"period_s": 0.01, "cooldown_s": 0.2, "queue_high_frac": 0.5,
                      "queue_clear_frac": 0.1, "prefill_budget_min": 64, "relax_after": 3,
                      "decisions": 2048}
AP_TRICKLE = 4  # short requests in flight at once while the budget relaxes
AP_TRICKLE_PROMPT = 24
AP_TRICKLE_NEW = 16
#: (b): 64 templated prompts (a 64-token block × 5 and a 16-token suffix) ×
#: 32 greedy tokens with speculation at k 4, 8 waves of 8 slots (TPOT is
#: observed as requests finish: the later waves carry the k steps); the
#: TPOT SLO is this share of an untimed first pass's p50
AP_TPOT_PROMPTS = 64
AP_TPOT_TEMPLATE = (64, 5, 16)  # block tokens, repeats, suffix tokens
AP_TPOT_NEW = 32
AP_TPOT_K = 4
AP_TPOT_SLO_SHARE = 0.5
AP_TPOT_AUTOPILOT = {"period_s": 0.01, "cooldown_s": 0.1, "spec_k_min": 1}
#: (c): the device-memory ramp per sample, every tick sampled
AP_HBM_RAMP = 0.05
AP_HBM_SAMPLE_TICKS = 1
AP_HBM_TEMPLATE = (64, 4, 8)
AP_HBM_AUTOPILOT = {"period_s": 0.01, "cooldown_s": 0.0}
#: (d): 2 replicas, one ramped; a cooldown longer than the leg, so a
#: replica that stays latched is restarted once
AP_FLEET_COOLDOWN_S = 600.0
AP_FLEET_NEW = 16
AP_WAIT_S = 300.0


def _ap_telemetry(**ap_kw):
    """The telemetry plane installed in this process with the autopilot
    on (``ap_kw`` over ``AutopilotConfig``'s defaults); returns it."""
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.config.schema import AutopilotConfig, TelemetryConfig

    tel = TelemetryConfig(enabled=True)
    tel.autopilot = AutopilotConfig(enabled=True, **ap_kw)
    telemetry.install(tel, scope="serve")
    return telemetry.autopilot_active()


def _ap_decisions(ap, t0: float, rule: str | None = None) -> list[dict]:
    """The decision ring (``ts`` made relative to ``t0``), one rule's."""
    return [dict(d, ts=d["ts"] - t0) for d in list(ap.decisions)
            if rule is None or d["rule"] == rule]


def _ap_launch_gate(b, n_layers: int, launches: int, cuda: bool, what: str) -> None:
    """K4 launched ``n_layers`` × (steps + chunk steps) of batcher ``b``
    (card only: on the CPU the plain version runs)."""
    st = b.stats()
    want = n_layers * int(st["steps"] + st["chunk_steps"])
    if cuda and (launches != want or launches == 0):
        fail(f"autopilot {what}: K4 launched {launches} times, want {want} for {st}")


def _ap_pass(rpa, eng, prompts, new: int, cuda: bool, what: str, speculative=None) -> dict:
    """The prompts through one batcher (submitted before it starts),
    greedy; K4 exact; each request's TPOT."""
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    b = ContinuousBatcher(eng, max_queue=len(prompts),
                          prefill_token_budget=eng.cfg.photon.serve.prefill_token_budget,
                          speculative=speculative)
    reqs = [b.submit(p, new) for p in prompts]
    rpa.launches = 0
    b.start()
    outs = [r.result(timeout=AP_WAIT_S) for r in reqs]
    b.close()
    _ap_launch_gate(b, eng.mc.n_layers, rpa.launches, cuda, what)
    tpot = sorted((r.t_done - r.t_first) / (len(r.generated) - 1) for r in reqs)
    return {"outs": outs, "tpot_p50_s": tpot[len(tpot) // 2]}


def _ap_storm(torch, rpa, np, eng, tie: float, cuda: bool) -> dict:
    """(a): the queue storm through the frontend with the autopilot on,
    under ``retrace_guard(steady=True)`` and ``lock_order_guard()``; then a
    planted kernel load in a guarded window."""
    import warnings

    from photon_tpu_torch import telemetry
    from photon_tpu_torch.analysis import runtime as rt
    from photon_tpu_torch.ops import _build
    from photon_tpu_torch.serve.frontend import ServeFrontend
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher
    from photon_tpu_torch.utils.profiling import (
        AUTOPILOT_KNOB_PREFILL_BUDGET,
        EVENT_AUTOPILOT_ACTUATION,
        EVENT_AUTOPILOT_RELAX,
    )

    declared = eng.cfg.photon.serve.prefill_token_budget
    vocab = eng.mc.vocab_size
    rng = np.random.default_rng(170)
    prompts = [list(map(int, rng.integers(0, vocab, int(rng.integers(*AP_STORM_PROMPT)))))
               for _ in range(AP_STORM)]
    # the warm-up, and the streams the storm's are held to: autopilot off
    ref = _ap_pass(rpa, eng, prompts, AP_STORM_NEW, cuda, "storm reference")
    rec: dict = {"declared_budget": declared, "max_queue": AP_MAX_QUEUE,
                 "requests": AP_STORM, "autopilot": AP_STORM_AUTOPILOT}
    t_leg = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with rt.lock_order_guard() as locks, rt.retrace_guard(steady=True) as sentinel:
            ap = _ap_telemetry(**AP_STORM_AUTOPILOT)
            b = ContinuousBatcher(eng, max_queue=AP_MAX_QUEUE, prefill_token_budget=declared)
            fe = ServeFrontend(b, max_new_tokens_cap=eng.cfg.photon.serve.max_new_tokens)
            port = fe.start()
            try:
                # every request queued before the scheduler's first tick:
                # its first sample is the whole backlog behind the slots
                with concurrent.futures.ThreadPoolExecutor(AP_STORM) as pool:
                    storm = [pool.submit(_generate, port, p, AP_STORM_NEW) for p in prompts]
                    deadline = time.monotonic() + 60
                    while b.queue_depth < AP_STORM:
                        if time.monotonic() > deadline:
                            fail(f"autopilot storm: {b.queue_depth} of {AP_STORM} queued")
                        time.sleep(0.005)
                    rpa.launches = 0
                    t0 = time.time()
                    b.start()
                    replies = [f.result(timeout=AP_WAIT_S) for f in storm]
                    t_backlog = time.time() - t0
                    # the trickle: ticks go on with the backlog gone
                    trickle = []
                    while b.prefill_token_budget < declared:
                        if time.time() - t0 > AP_WAIT_S:
                            fail(f"autopilot storm: the budget stayed at "
                                 f"{b.prefill_token_budget} after the backlog")
                        short = [list(map(int, rng.integers(0, vocab, AP_TRICKLE_PROMPT)))
                                 for _ in range(AP_TRICKLE)]
                        trickle += list(pool.map(
                            lambda p: _generate(port, p, AP_TRICKLE_NEW), short))
                    t_relaxed = time.time() - t0
                statusz = json.loads(_request(port, "/statusz")[1])
            finally:
                fe.close()
                b.close()
                telemetry.uninstall()
            launches = rpa.launches
            rec["lock_order"] = {"tracked_locks": locks.n_locks,
                                 "nested_acquires": locks.n_acquires,
                                 "edges": sum(len(v) for v in locks.edges().values())}
        rec["retrace"] = {"violations": sentinel.violations, "compiles": sentinel.compiles}
    tick_warnings = [str(w.message) for w in caught if "autopilot tick failed" in str(w.message)]
    rec["wall_s"] = time.perf_counter() - t_leg
    _ap_launch_gate(b, eng.mc.n_layers, launches, cuda, "storm")
    bad = [s for s, _ in replies + trickle if s != 200]
    decisions = _ap_decisions(ap, t0, "queue_budget")
    acts = [d for d in decisions if d["event"] == EVENT_AUTOPILOT_ACTUATION
            and d["knob"] == AUTOPILOT_KNOB_PREFILL_BUDGET]
    relaxes = [d for d in decisions if d["event"] == EVENT_AUTOPILOT_RELAX]
    lowest = min((d["new"] for d in acts), default=None)
    got = [r["tokens"] if r else None for _, r in replies]
    diverged = _streams_agree(torch, eng, prompts, got, ref["outs"], tie,
                              "autopilot storm vs the autopilot off")
    rec.update({
        "rejected": b.rejected, "non_200": bad, "trickle_requests": len(trickle),
        "backlog_s": t_backlog, "relaxed_after_s": t_relaxed, "launches": launches,
        "steps": b.steps, "chunk_steps": b.chunk_steps,
        "actuations": len(acts), "relaxes": len(relaxes), "lowest_budget": lowest,
        "final_budget": b.prefill_token_budget,
        "budget_trace": [[round(d["ts"], 4), d["new"]] for d in acts + relaxes],
        "first_actuation": acts[0] if acts else None,
        "statusz_decisions": len(statusz.get("autopilot", {}).get("decisions", [])),
        "tick_warnings": tick_warnings, "streams_diverged_at_a_tie": diverged,
        "decisions_kept": len(decisions)})
    if not acts or acts[0]["old"] != declared or acts[0]["rule"] != "queue_budget":
        fail(f"autopilot storm: no queue_budget actuation from {declared}: {decisions[:4]}")
    if not 64 <= lowest < declared:
        fail(f"autopilot storm: the lowest budget {lowest} is outside [64, {declared})")
    if not relaxes or b.prefill_token_budget != declared:
        fail(f"autopilot storm: {len(relaxes)} relaxes, the budget ends at "
             f"{b.prefill_token_budget}")
    if b.rejected or bad:
        fail(f"autopilot storm: {b.rejected} rejected, answers {bad}")
    if not rec["statusz_decisions"]:
        fail("autopilot storm: the frontend's /statusz carries no decision")
    if tick_warnings or sentinel.violations:
        fail(f"autopilot storm: tick warnings {tick_warnings}, retraces {sentinel.violations}")

    # the planted fault: a kernel library loaded afresh in a guarded window
    # is billed to the serving tick after it
    source = "ragged_paged_attention.cu" if cuda else None
    b = ContinuousBatcher(eng, max_queue=4, prefill_token_budget=declared).start()
    try:
        with rt.retrace_guard(steady=True) as planted:
            if source is not None:
                with _build._lock:
                    _build._loaded.pop(source)
                _build.load(source)
            else:  # no kernel library on the CPU: the loader's listener alone
                _build.on_load("planted.cu")
            b.submit(prompts[0][:AP_TRICKLE_PROMPT], 2).result(timeout=AP_WAIT_S)
        fail("autopilot storm: the planted kernel load was not caught")
    except rt.RetraceViolation as e:
        rec["planted"] = {"violations": planted.violations, "text": str(e)}
        if planted.violations[:1] != [("serve/tick", 1)]:
            fail(f"autopilot storm: the planted load was billed as {planted.violations}")
    finally:
        b.close()
    log("autopilot storm " + json.dumps({k: v for k, v in rec.items() if k != "budget_trace"}))
    return rec


def _ap_tpot(torch, rpa, np, eng, tie: float, cuda: bool) -> dict:
    """(b): speculation on (k 4), the TPOT SLO at ``AP_TPOT_SLO_SHARE`` of
    an untimed first pass's p50: ``serve/spec_k_max`` steps 4 → 1."""
    import copy

    from photon_tpu_torch import telemetry
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher
    from photon_tpu_torch.utils.profiling import (
        AUTOPILOT_KNOB_SPEC_K_MAX,
        EVENT_AUTOPILOT_ACTUATION,
        EVENT_AUTOPILOT_SATURATED,
    )

    vocab = eng.mc.vocab_size
    rng = np.random.default_rng(171)
    n_block, repeats, n_suffix = AP_TPOT_TEMPLATE
    template = list(map(int, rng.integers(0, vocab, n_block))) * repeats
    prompts = [template + list(map(int, rng.integers(0, vocab, n_suffix)))
               for _ in range(AP_TPOT_PROMPTS)]
    spec = copy.deepcopy(eng.cfg.photon.serve.speculative)
    spec.enabled, spec.k = True, AP_TPOT_K
    plain = _ap_pass(rpa, eng, prompts, AP_TPOT_NEW, cuda, "tpot plain")
    first = _ap_pass(rpa, eng, prompts, AP_TPOT_NEW, cuda, "tpot first pass", spec)
    slo = AP_TPOT_SLO_SHARE * first["tpot_p50_s"]
    ap = _ap_telemetry(tpot_p50_slo_s=slo, **AP_TPOT_AUTOPILOT)
    t_leg = time.perf_counter()
    try:
        # a queue far from the queue rule's bound: this leg is the TPOT rule's
        b = ContinuousBatcher(eng, max_queue=4 * len(prompts),
                              prefill_token_budget=eng.cfg.photon.serve.prefill_token_budget,
                              speculative=spec)
        reqs = [b.submit(p, AP_TPOT_NEW) for p in prompts]
        rpa.launches = 0
        t0 = time.time()
        b.start()
        outs = [r.result(timeout=AP_WAIT_S) for r in reqs]
        b.close()
        launches = rpa.launches
    finally:
        telemetry.uninstall()
    _ap_launch_gate(b, eng.mc.n_layers, launches, cuda, "tpot")
    decisions = _ap_decisions(ap, t0, "tpot_spec_k")
    acts = [(d["old"], d["new"]) for d in decisions if d["event"] == EVENT_AUTOPILOT_ACTUATION]
    sat = [d for d in decisions if d["event"] == EVENT_AUTOPILOT_SATURATED]
    diverged = _streams_agree(torch, eng, prompts, outs, plain["outs"], tie,
                              "autopilot speculation vs plain")
    rec = {"slo_s": slo, "first_pass_tpot_p50_s": first["tpot_p50_s"],
           "plain_tpot_p50_s": plain["tpot_p50_s"], "k_trace": [
               [round(d["ts"], 4), d["new"]] for d in decisions],
           "actuations": acts, "saturated": len(sat), "final_k_max": b._spec.k_max,
           "launches": launches, "spec": b.spec_stats(), "wall_s": time.perf_counter() - t_leg,
           "streams_diverged_at_a_tie": diverged}
    log("autopilot tpot " + json.dumps(rec))
    if acts != [(AP_TPOT_K - i, AP_TPOT_K - i - 1) for i in range(AP_TPOT_K - 1)] \
            or b._spec.k_max != 1 or len(sat) != 1 \
            or any(d["knob"] != AUTOPILOT_KNOB_SPEC_K_MAX for d in decisions):
        fail(f"autopilot tpot: spec_k_max went {acts}, {len(sat)} saturated, "
             f"ends at {b._spec.k_max}")
    return rec


def _ap_hbm(rpa, np, eng, cuda: bool) -> dict:
    """(c): the prefix cache holds a templated pass's blocks; the
    device-memory ramp latches ``alert/hbm_growth`` and the reclaim frees
    them, once per alert: a second alert comes only once the ramp, off for
    a while, is turned on again."""
    from photon_tpu_torch import chaos, telemetry
    from photon_tpu_torch.config.schema import ChaosConfig
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher
    from photon_tpu_torch.utils.profiling import ALERT_HBM_GROWTH

    vocab = eng.mc.vocab_size
    rng = np.random.default_rng(172)
    ap = _ap_telemetry(reclaim_free_blocks=eng.n_blocks, **AP_HBM_AUTOPILOT)
    health = telemetry.health_active()
    b = ContinuousBatcher(eng, max_queue=64,
                          prefill_token_budget=eng.cfg.photon.serve.prefill_token_budget)
    b.device_sample_ticks = AP_HBM_SAMPLE_TICKS
    rpa.launches = 0
    b.start()
    t0 = time.time()
    failed: list[str] = []
    rec: dict = {"ramp_frac": AP_HBM_RAMP, "sample_ticks": AP_HBM_SAMPLE_TICKS, "episodes": []}

    def run(prompts, new):
        for r in [b.submit(p, new) for p in prompts]:
            r.result(timeout=AP_WAIT_S)
            if r.error:
                failed.append(r.error)

    def alerts():
        return [a for a in list(health.alerts) if a.kind == ALERT_HBM_GROWTH]

    def reclaims():
        return _ap_decisions(ap, t0, "hbm_reclaim")

    try:
        n_block, repeats, n_suffix = AP_HBM_TEMPLATE
        for episode in range(2):
            template = list(map(int, rng.integers(0, vocab, n_block))) * repeats
            run([template + list(map(int, rng.integers(0, vocab, n_suffix))) for _ in range(8)],
                4)
            cached = len(eng.prefix_cache)
            n_alerts, n_reclaims = len(alerts()), len(reclaims())
            chaos.install(ChaosConfig(enabled=True, seed=episode,
                                      serve_hbm_ramp_frac=AP_HBM_RAMP), scope="serve")
            deadline = time.monotonic() + 120
            while len(reclaims()) == n_reclaims:
                if time.monotonic() > deadline:
                    fail(f"autopilot hbm: episode {episode}: {len(alerts())} alerts, no reclaim")
                run([list(map(int, rng.integers(0, vocab, 8))) for _ in range(4)], 4)
            chaos.uninstall()
            # the ramp off: ticks go on and no alert or reclaim follows
            run([list(map(int, rng.integers(0, vocab, 8))) for _ in range(4)], 16)
            new_alerts, new_reclaims = alerts()[n_alerts:], reclaims()[n_reclaims:]
            rec["episodes"].append({
                "cached_blocks_before": cached,
                "alerts": [{"ts": a.ts - t0, "growth_frac": a.attrs.get("growth_frac")}
                           for a in new_alerts],
                "reclaims": [{k: d[k] for k in ("ts", "observed", "old", "new")}
                             for d in new_reclaims]})
            if len(new_alerts) != 1 or len(new_reclaims) != 1:
                fail(f"autopilot hbm: episode {episode}: {len(new_alerts)} alerts, "
                     f"{len(new_reclaims)} reclaims")
            d, a = new_reclaims[0], new_alerts[0]
            if d["observed"] != a.attrs.get("growth_frac") or d["ts"] < a.ts - t0 \
                    or not d["new"] > d["old"]:
                fail(f"autopilot hbm: episode {episode}: reclaim {d} for alert {a}")
    finally:
        chaos.uninstall()
        b.close()
        telemetry.uninstall()
    _ap_launch_gate(b, eng.mc.n_layers, rpa.launches, cuda, "hbm")
    if failed:
        fail(f"autopilot hbm: {len(failed)} requests failed: {failed[:2]}")
    rec["launches"] = rpa.launches
    rec["wall_s"] = time.time() - t0
    log("autopilot hbm " + json.dumps(rec))
    return rec


def _ap_oom(torch, cfg, work: pathlib.Path) -> dict:
    """(e): an allocation over the card's free memory raises
    ``torch.cuda.OutOfMemoryError``; ``dump_memory_profile`` leaves a
    snapshot that loads, and ``ClientRuntime._error`` names it."""
    import copy
    import pickle

    from photon_tpu_torch.federation.client_runtime import ClientRuntime
    from photon_tpu_torch.utils.profiling import dump_memory_profile

    free, total = torch.cuda.mem_get_info()
    try:
        torch.empty(free + (1 << 30), dtype=torch.uint8, device="cuda")
        fail(f"autopilot oom: {free + (1 << 30)} bytes allocated with {free} free")
    except torch.cuda.OutOfMemoryError as e:
        err = e
    t0 = time.perf_counter()
    path = dump_memory_profile(str(work), "oom")
    dump_s = time.perf_counter() - t0
    if path is None:
        fail("autopilot oom: dump_memory_profile wrote nothing")
    with open(path, "rb") as f:
        snap = pickle.load(f)
    if not isinstance(snap, dict) or not snap.get("segments"):
        fail(f"autopilot oom: the snapshot holds {type(snap).__name__} "
             f"{list(snap)[:5] if isinstance(snap, dict) else ''}")
    rcfg = copy.deepcopy(cfg)
    rcfg.photon.save_path = str(work)
    text = ClientRuntime(rcfg, transport=None, device="cuda")._error(err, "smoke")
    named = text.rsplit("[memory profile: ", 1)[-1].rstrip("]") if "[memory profile: " in text \
        else None
    if named is None or not pathlib.Path(named).is_file():
        fail(f"autopilot oom: ClientRuntime._error names no snapshot: {text[-300:]}")
    rec = {"free_bytes": free, "total_bytes": total, "asked_bytes": free + (1 << 30),
           "snapshot_bytes": pathlib.Path(path).stat().st_size,
           "segments": len(snap["segments"]), "dump_s": dump_s,
           "error_names": pathlib.Path(named).name}
    log("autopilot oom " + json.dumps(rec))
    return rec


def autopilot_phase(torch, rpa, np, fed: dict, tie: float, cfg=None, device: str = "cuda",
                    work: pathlib.Path = ROOT / ".chip_smoke" / "autopilot") -> dict:
    """Phase 17 (a), (b), (c) and (e), in this process: the fed run's
    served round at full width in one ragged engine with the prefix cache
    (8 slots, block 16, budget 512); see the module's docstring. (d) runs
    in a child beside phases 14–16 (:func:`autopilot_fleet_leg`)."""
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.serve.engine import PagedEngine, load_serving_params

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = cfg if cfg is not None else serve_config()
    cfg.photon.serve.prefix_cache = True
    cfg.photon.serve.attention_impl = "ragged" if cuda else "auto"
    mgr = ServerCheckpointManager(FileStore(fed["store"]), fed["run_uuid"])
    eng = PagedEngine(cfg, load_serving_params(cfg, mgr, fed["served_round"]),
                      loaded_round=fed["served_round"], device=device)
    rec: dict = {"round": fed["served_round"], "slots": eng.n_slots,
                 "block_size": eng.block_size, "n_blocks": eng.n_blocks}
    try:
        rec["storm"] = _ap_storm(torch, rpa, np, eng, tie, cuda)
        rec["tpot"] = _ap_tpot(torch, rpa, np, eng, tie, cuda)
        rec["hbm"] = _ap_hbm(rpa, np, eng, cuda)
        del eng
        if cuda:
            torch.cuda.empty_cache()
            rec["oom"] = _ap_oom(torch, cfg, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec["launches"] = rec["storm"]["launches"] + rec["tpot"]["launches"] + rec["hbm"]["launches"]
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def autopilot_fleet_leg(np, src: dict, device: str = "cuda",
                        work: pathlib.Path = ROOT / ".chip_smoke" / "autopilot_fleet") -> dict:
    """Phase 17 (d): a ``FleetRouter`` with the autopilot on (cooldown
    ``AP_FLEET_COOLDOWN_S``) and two ``--fleet-connect`` replicas of phase
    13's round (``src``), one of them (``ramp``) under the device-memory
    ramp, both with telemetry on; traffic from two threads throughout. The
    ramped replica reports its serve plane degraded by ``alert/hbm_growth``,
    the router approves one restart for it and none for ``steady``, the
    agent recycles it, it reports live again, no request fails and each
    replica's K4 keeps to the launch rule."""
    import os

    from photon_tpu_torch import telemetry
    from photon_tpu_torch.checkpoint import FileStore
    from photon_tpu_torch.config.schema import AutopilotConfig, TelemetryConfig
    from photon_tpu_torch.serve.router import FleetRouter
    from photon_tpu_torch.utils.profiling import ALERT_HBM_GROWTH

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    _copy_round(FileStore(src["store"]), FileStore(work / "store"), src["run"], 1)
    cfg = fleet_config(src["config"])
    sc, fc = cfg.photon.serve, cfg.photon.serve.fleet
    fc.replicas, sc.hotswap = 2, False
    cfg.photon.telemetry.enabled = True
    for tag, ramp in (("ramp", AP_HBM_RAMP), ("steady", 0.0)):
        cfg.photon.telemetry.dir = str(work / f"telemetry_{tag}")
        cfg.photon.chaos.enabled, cfg.photon.chaos.serve_hbm_ramp_frac = ramp > 0, ramp
        cfg.to_yaml(work / f"{tag}.yaml")
    n_layers, vocab, block = cfg.model.n_layers, cfg.model.vocab_size, sc.block_size
    tel = TelemetryConfig(enabled=True, dir=str(work / "telemetry_router"))
    tel.autopilot = AutopilotConfig(enabled=True, cooldown_s=AP_FLEET_COOLDOWN_S)
    telemetry.install(tel, scope="router")
    ap = telemetry.autopilot_active()
    asked: list[tuple] = []
    real_request = ap.request_replica_restart

    def request(nid, reason, observed=1.0):
        ok = real_request(nid, reason, observed=observed)
        asked.append((time.time(), nid, reason, ok))
        return ok

    ap.request_replica_restart = request
    router = FleetRouter(fc, block_size=block)
    reports: list[tuple] = []
    real_ingest = router._ingest_report

    def ingest(nid, reply):
        real_ingest(nid, reply)
        reports.append((time.time(), nid, json.loads(reply.detail or "{}")))

    router._ingest_report = ingest
    port = router.start()
    control = f"{fc.host}:{router.control_port}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = {tag: subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch.serve", "--config", str(work / f"{tag}.yaml"),
         "--store", str(work / "store"), "--enable", "--port", "0", "--fleet-connect", control,
         "--replica-id", tag, "--device", device],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for tag in ("ramp", "steady")}
    errs: dict = {tag: [] for tag in procs}
    for tag, p in procs.items():
        threading.Thread(target=lambda p=p, e=errs[tag]: e.extend(p.stderr), daemon=True).start()
    stop = threading.Event()
    traffic: list = []
    threads: list = []
    rec: dict = {"cooldown_s": AP_FLEET_COOLDOWN_S, "ramp_frac": AP_HBM_RAMP,
                 "report_poll_s": fc.report_poll_s}
    try:
        t0 = time.perf_counter()
        try:
            router.wait_for_replicas(timeout=AP_WAIT_S)
        except TimeoutError as e:
            fail(f"autopilot fleet: {e}: " + json.dumps({t: "".join(v)[-2000:]
                                                         for t, v in errs.items()}))
        rec["startup_s"] = time.perf_counter() - t0
        threads = [_traffic_thread(port, np, seed, vocab, block, traffic, stop)
                   for seed in (0, 1)]
        deadline = time.monotonic() + AP_WAIT_S
        while not router.restarts.get("ramp"):
            if time.monotonic() > deadline:
                fail(f"autopilot fleet: no restart acknowledged; asked {asked}")
            time.sleep(0.05)
        t_ack = router.restarts["ramp"][0]
        while not any(t > t_ack and nid == "ramp" and not r.get("draining")
                      for t, nid, r in list(reports)):
            if time.monotonic() > deadline:
                fail("autopilot fleet: the restarted replica never reported live")
            time.sleep(0.05)
        t_live = next(t for t, nid, r in list(reports)
                      if t > t_ack and nid == "ramp" and not r.get("draining"))
        time.sleep(2 * fc.report_poll_s + 0.5)  # more polls: the cooldown holds
        stop.set()
        for t in threads:
            t.join(timeout=AP_WAIT_S)
        health = {tag: _replica_health(router, tag) for tag in procs}
        statusz = json.loads(_request(port, "/statusz")[1])
        fleet = router.fleet_status()["fleet"]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for tag, p in procs.items():
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        router.close()
        telemetry.uninstall()
        shutil.rmtree(work, ignore_errors=True)
    approvals = {tag: [a for a in asked if a[1] == tag and a[3]] for tag in procs}
    t_approve = approvals["ramp"][0][0] if approvals["ramp"] else None
    degraded = [r.get("health") for _, nid, r in reports if nid == "ramp" and r.get("health")
                and r["health"].get("status") != "ok"]
    bad = [(r["status"], r.get("error")) for r in traffic if r["status"] != 200]
    rec.update({
        "requests": len(traffic), "failed": bad, "reports": len(reports),
        "ramp_health": degraded[:1], "steady_health": [r.get("health") for _, nid, r in reports
                                                      if nid == "steady"][-1:],
        "asked": len(asked), "denied": sum(1 for a in asked if not a[3]),
        "approvals": {tag: len(v) for tag, v in approvals.items()},
        "restarts_acknowledged": {tag: len(v) for tag, v in router.restarts.items()},
        "recycles": {tag: h["stats"].get("recycles") for tag, h in health.items()},
        "approval_to_live_s": t_live - t_approve if t_approve else None,
        "ack_to_live_s": t_live - t_ack, "rerouted": fleet["routed"]["reroutes"],
        "states": {tag: fleet["replicas"].get(tag, {}).get("state") for tag in procs},
        "statusz_decisions": [{k: d.get(k) for k in ("rule", "knob", "replica", "reason")}
                              for d in statusz.get("autopilot", {}).get("decisions", [])],
        "launches": {tag: health[tag]["kernel_launches"]["ragged_paged_attention"]
                     for tag in procs}})
    if not degraded or degraded[0].get("reason") != ALERT_HBM_GROWTH:
        fail(f"autopilot fleet: the ramped replica reported {degraded[:1]}")
    if rec["approvals"] != {"ramp": 1, "steady": 0} or rec["restarts_acknowledged"] != \
            {"ramp": 1}:
        fail(f"autopilot fleet: approvals {rec['approvals']}, acknowledged "
             f"{rec['restarts_acknowledged']}")
    if rec["recycles"] != {"ramp": 1.0, "steady": 0.0} or rec["states"] != \
            {"ramp": "live", "steady": "live"}:
        fail(f"autopilot fleet: recycles {rec['recycles']}, states {rec['states']}")
    if bad:
        fail(f"autopilot fleet: {len(bad)} of {len(traffic)} requests failed: {bad[:3]}")
    if not any(d["rule"] == "replica_restart" and d["replica"] == "ramp"
               for d in rec["statusz_decisions"]):
        fail(f"autopilot fleet: the router's /statusz holds {rec['statusz_decisions']}")
    if cuda:
        for tag in procs:
            _launch_rule(health[tag], n_layers, f"autopilot fleet replica {tag}")
    rec["phase_s"] = time.perf_counter() - t_phase
    log("autopilot fleet " + json.dumps(rec))
    return rec


def _autopilot_fleet_child(out_path: str, src_path: str) -> int:
    """(d) in a child of the smoke (:func:`autopilot_fleet_leg`), so the
    router's process-global autopilot shares a process with no other
    phase; writes its record to ``out_path``."""
    import numpy as np

    sys.path.insert(0, str(ROOT))
    src = json.loads(pathlib.Path(src_path).read_text())
    rec = autopilot_fleet_leg(np, src, device=src.get("device", "cuda"))
    pathlib.Path(out_path).write_text(json.dumps(rec))
    return 0


def _autopilot_fleet_start(src: dict, work: pathlib.Path) -> subprocess.Popen:
    """Start (d)'s child (:func:`_autopilot_fleet_child`) on ``src``."""
    work.mkdir(parents=True, exist_ok=True)
    (work / "ap_fleet_src.json").write_text(json.dumps(src))
    with open(work / "ap_fleet.log", "w") as out:
        return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--autopilot-fleet",
                                 str(work / "ap_fleet.json"), str(work / "ap_fleet_src.json")],
                                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)


def _autopilot_fleet_finish(proc: subprocess.Popen, work: pathlib.Path) -> dict:
    """Wait for (d)'s child; its record, or the smoke fails with its log."""
    try:
        rc = proc.wait(timeout=AP_WAIT_S + 300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        rc = "timeout"
    log_text = (work / "ap_fleet.log").read_text()
    if rc != 0:
        fail(f"autopilot fleet child exited {rc}: {log_text[-3000:]}")
    return json.loads((work / "ap_fleet.json").read_text())


# ---------------------------------------------------------------------------
# phase 18: federated rounds over collectives
# ---------------------------------------------------------------------------

COLL_RUN = "chip-smoke-collective"
#: (a): 2 clients × COLL_STEPS local steps × COLL_ROUNDS rounds at full
#: width and depth, FedAdam on the device plane, replica 2 on a mesh that
#: names cuda:0 four times
COLL_STEPS = 2
COLL_ROUNDS = 2
COLL_REPLICA = 2
COLL_Q8_BLOCK = 256
#: the collective run against the driver topology's (JAX's own tolerance,
#: tests/test_collective_round.py:152-158)
COLL_RTOL, COLL_ATOL = 1e-3, 5e-5
#: (b)-(d) at mpt-125m's width and 2 layers
COLL_LAYERS = 2
#: (c) across processes: process 1 crashes before the exchange of round 2;
#: process 0 must finish the round within this + COLL_SLACK_S of the crash
COLL_TIMEOUT_S = 10.0
COLL_SLACK_S = 5.0
#: (d): versions of the 4-client async run (one client 4x slow): the 3
#: fast clients reach them past t = 4, when the slow client's first delta
#: lands stale
COLL_ASYNC_VERSIONS = 5
COLL_WAIT_S = 300.0
#: the in-process run's parameters that (b)'s pair is held to, written by
#: (c) and (d)'s child beside 14-16 and read by the pair after them
COLL_PAIR_REF = ROOT / ".chip_smoke" / "collective_pair_ref.npz"
#: (c) in process: the autopilot's straggler rule over the rounds'
#: straggler fractions (0, 1/3, 0); its one decision, the same as JAX's
#: rule gives on that series (tests/test_torch_collective_round.py pins it)
COLL_AP = {"period_s": 0.0, "cooldown_s": 600.0, "window_s": 600.0, "straggler_p90": 0.3,
           "stage_timeout_min_s": 5.0, "stage_timeout_shrink": 0.75}
COLL_AP_TIMEOUT_S = 30.0
COLL_AP_SERIES = (0.0, 1.0 / 3.0, 0.0)
COLL_AP_DECISION = ("autopilot/actuation", "straggler_deadline",
                    "server/collective_stage_timeout_s", 1.0 / 3.0, 30.0, 22.5)


def collective_config(n_layers: int | None = None, n_clients: int = 2,
                      replica: int = COLL_REPLICA, device_opt: bool = True, base=None,
                      save_path: str | pathlib.Path = ROOT / ".chip_smoke" / "collective" / "run"):
    """FedAdam over the collective plane on the training config (full width;
    ``n_layers`` cuts the depth), 2 local steps, no eval, no checkpoint; the
    clients' synthetic data under ``save_path``."""
    cfg = base() if base is not None else train_config()
    cfg.run_uuid = COLL_RUN
    cfg.photon.save_path = str(save_path)
    if n_layers:
        cfg.model.n_layers = n_layers
    cfg.fl.n_total_clients = cfg.fl.n_clients_per_round = n_clients
    cfg.fl.local_steps = COLL_STEPS
    cfg.fl.n_rounds = COLL_ROUNDS
    cfg.fl.eval_interval_rounds = 0
    cfg.fl.strategy_name = "fedadam"
    cfg.fl.server_learning_rate = 1e-2
    # a tau over fp32 noise: with tau ~ 0 a pseudo-gradient element at
    # rounding level takes a full lr step on its sign (as in JAX's test)
    cfg.fl.server_tau = 1e-3
    cfg.photon.checkpoint = False
    cs = cfg.photon.comm_stack
    cs.collective, cs.shm = True, False
    cs.collective_replica = replica
    cs.collective_device_optimizer = device_opt
    return cfg.validate()


def _coll_mesh(n_clients: int, replica: int, device: str):
    from photon_tpu_torch.parallel.collective_agg import make_hierarchical_mesh

    return make_hierarchical_mesh(n_clients, replica, [device] * (n_clients * replica))


def _coll_capture(runner, rounds=(1,)) -> dict:
    """Wrap the runner's ladder: keeps a host copy of each listed round's
    landed deltas and the strategy as the round began."""
    seen: dict = {}
    real = runner._aggregate_elastic

    def spy(server_round, landed):
        if server_round in rounds:
            seen[server_round] = {
                "landed": {cid: ([a.copy() for a in arrs], n) for cid, (arrs, n) in landed.items()},
                "before": runner.strategy.snapshot()}
        return real(server_round, landed)

    runner._aggregate_elastic = spy
    return seen


def _coll_rounds(torch, runner, rounds: int, cuda: bool) -> dict:
    """``rounds`` rounds of ``runner``: the rounds' walls and stage seconds,
    K1–K3's launches per round, the card's peak."""
    from photon_tpu_torch.ops import flash_attention as fa

    rec: dict = {"rounds": []}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for rnd in range(1, rounds + 1):
        for key in fa.launches:
            fa.launches[key] = 0
        m = runner.run_round(rnd)
        rec["rounds"].append({k: m.get(k) for k in (
            "server/round_time", "server/fit_round_time", "server/collective_stack_time",
            "server/collective_exchange_time", "server/collective_update_time",
            "server/collective_agg_time", "server/collective_wire_bytes",
            "server/opt_allgather_time", "server/opt_shard_frac", "server/n_samples")}
            | {"launches": dict(fa.launches), "path": runner.aggregation_paths[rnd]})
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    return rec


def _coll_gap(np, got, want) -> float:
    """How far ``got`` is past the run tolerance (<= 0: within)."""
    return max(float(np.max(np.abs(g - w) - (COLL_ATOL + COLL_RTOL * np.abs(w))))
               for g, w in zip(got, want))


def _q8_bound_gate(torch, np, landed: dict, mesh, device: str) -> dict:
    """On round 1's contributions: every element of the q8 average within
    Σ_c scale_c/2 of the `off` average (the scales of each client's weighted
    contribution over the exchange's chunk layout, from the torch codec,
    whose bytes are the host codec's), in fp64 on the device; a codec that
    applies block b+1's scale to block b must break the bound."""
    from photon_tpu_torch.compression.quantize_torch import quantize_q8_torch
    from photon_tpu_torch.parallel.collective_agg import hierarchical_weighted_average

    cids = sorted(landed)
    ns = [landed[c][1] for c in cids]
    rows = [[torch.from_numpy(landed[c][0][i]).to(device) for c in cids]
            for i in range(len(landed[cids[0]][0]))]
    off = hierarchical_weighted_average(rows, ns, mesh)
    q8 = hierarchical_weighted_average(rows, ns, mesh, quantization="q8", block=COLL_Q8_BLOCK)
    total = torch.tensor(float(sum(ns)), dtype=torch.float32, device=device)
    worst = fault_over = -math.inf
    for i, (a_off, a_q8) in enumerate(zip(off, q8)):
        n = a_off.numel()
        padded = COLL_REPLICA * (-(-n // (COLL_REPLICA * COLL_Q8_BLOCK)) * COLL_Q8_BLOCK)
        bound = torch.zeros(padded, dtype=torch.float64, device=device)
        fault = torch.zeros(padded, dtype=torch.float32, device=device)
        for c, row in zip(ns, rows[i]):
            contrib = torch.zeros(padded, dtype=torch.float32, device=device)
            contrib[:n] = row.reshape(-1) * (torch.tensor(float(c), device=device) / total)
            codes, sc = quantize_q8_torch(contrib, COLL_Q8_BLOCK)
            bound += torch.repeat_interleave(sc.double(), COLL_Q8_BLOCK) / 2.0
            fault += (codes.float().reshape(-1, COLL_Q8_BLOCK)
                      * torch.roll(sc, -1)[:, None]).reshape(-1)
        ref = a_off.reshape(-1).double()
        worst = max(worst, float(((a_q8.reshape(-1).double() - ref).abs() - bound[:n]).max()))
        fault_over = max(fault_over, float(((fault[:n].double() - ref).abs() - bound[:n]).max()))
    if not worst <= 1e-7:
        fail(f"collective (a): the q8 average leaves Σ scale/2 by {worst}")
    if not fault_over > 1e-7:
        fail(f"collective (a): a q8 codec with its scales one block off stayed inside the "
             f"bound ({fault_over})")
    return {"bound_excess_max": worst, "shifted_scale_fault_excess": fault_over}


def collective_phase(torch, np, cfg_fn=collective_config, device: str = "cuda",
                     work: pathlib.Path = ROOT / ".chip_smoke" / "collective") -> dict:
    """Phase 18 (a) and (e) in this process (see the module's docstring);
    (c) and (d) in process run in a child beside phases 14-16
    (:func:`collective_leg`), (b) and (c) across processes after them
    (:func:`collective_pair`)."""
    import gc
    import os
    import tempfile

    from photon_tpu_torch import telemetry
    from photon_tpu_torch.config.schema import TelemetryConfig
    from photon_tpu_torch.federated import build_app
    from photon_tpu_torch.federation.collective_round import CollectiveFedRunner
    from photon_tpu_torch.parallel.collective_agg import (
        DeviceAggregationPlane,
        modeled_cross_slice_bytes,
    )

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = cfg_fn()
    n_clients, n_layers = cfg.fl.n_total_clients, cfg.model.n_layers
    micro = cfg.train.global_batch_size // cfg.train.device_microbatch_size
    per_round = n_clients * cfg.fl.local_steps * n_layers * micro
    rec: dict = {"config": {"n_layers": n_layers, "d_model": cfg.model.d_model,
                            "clients": n_clients, "local_steps": cfg.fl.local_steps,
                            "rounds": COLL_ROUNDS, "replica": COLL_REPLICA,
                            "mesh": [device] * (n_clients * COLL_REPLICA),
                            "microbatches": micro, "strategy": cfg.fl.strategy_name}}

    def release():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    # the ZeRO-1 run, under the autopilot (e): both collective knobs register
    tel = TelemetryConfig(enabled=True)
    tel.autopilot.enabled = True
    telemetry.install(tel, scope="collective", events_path=str(work / "events.jsonl"))
    try:
        t0 = time.perf_counter()
        zero1 = CollectiveFedRunner(cfg, list(range(n_clients)),
                                    mesh=_coll_mesh(n_clients, COLL_REPLICA, device), device=device)
        rec["zero1_init_s"] = time.perf_counter() - t0
        knobs = sorted(telemetry.autopilot_active()._knobs)
    finally:
        telemetry.uninstall()
    want_knobs = ["server/collective_quantization_level", "server/collective_stage_timeout_s"]
    if knobs != want_knobs:
        fail(f"collective (e): the runner registered {knobs}, not {want_knobs}")
    rec["knobs"] = knobs
    seen = _coll_capture(zero1)
    round1: dict = {}
    real_finish = zero1._finish_round

    def finish(server_round, *args):
        if server_round == 1:
            round1["params"] = [p.copy() for p in zero1.strategy.current_parameters]
        return real_finish(server_round, *args)

    zero1._finish_round = finish
    # the replicated layout (``collective_zero1: false``) beside it, round
    # for round on the same stacked deltas: the same bits, twice the
    # per-rank state (a plane of its own, not a second run of the fits,
    # which would read the same deltas and cost the smoke ~20 s)
    shadow = _coll_strategy(cfg)
    shadow.initialize([p.copy() for p in zero1.strategy.current_parameters])
    repl = DeviceAggregationPlane(zero1.mesh, shadow, sharded=False)
    sharded_plane = zero1.device_plane
    real_run_round = sharded_plane.run_round
    shadow_rounds: list = []

    def run_round(stacked, n_samples, lr, epoch=None):
        out = real_run_round(stacked, n_samples, lr=lr, epoch=epoch)
        t0 = time.perf_counter()
        repl.run_round(stacked, n_samples, lr=lr)
        shadow_rounds.append({"round_s": time.perf_counter() - t0, "equal": all(
            np.array_equal(a, b) for a, b in zip(sharded_plane.params_host(),
                                                  repl.params_host()))
            and all(np.array_equal(a, b) for k, v in sharded_plane.state_host().items()
                    for a, b in zip(v, repl.state_host()[k]))})
        return out

    sharded_plane.run_round = run_round
    rec["zero1"] = _coll_rounds(torch, zero1, COLL_ROUNDS, cuda)
    sharded_plane.run_round = real_run_round
    zero1_params = [p.copy() for p in zero1.strategy.current_parameters]
    zero1_bytes = sharded_plane.server_state_bytes_per_rank()
    repl_bytes = repl.server_state_bytes_per_rank()
    landed1, before1 = seen[1]["landed"], seen[1]["before"]
    mesh = zero1.mesh
    del repl, shadow
    for r in rec["zero1"]["rounds"]:
        if cuda and r["launches"] != {k: per_round for k in r["launches"]}:
            fail(f"collective (a): K1-K3 launched {r['launches']} in a round, not "
                 f"{per_round} each ({n_clients} clients x {cfg.fl.local_steps} steps x "
                 f"{n_layers} layers x {micro} microbatches)")
        if r["path"] != "collective":
            fail(f"collective (a): a round took the {r['path']} path")
    rec["replicated"] = shadow_rounds
    if len(shadow_rounds) != COLL_ROUNDS or not all(r["equal"] for r in shadow_rounds):
        fail(f"collective (a): the ZeRO-1 and replicated layouts part: {shadow_rounds}")
    if not repl_bytes / 2 <= zero1_bytes <= repl_bytes / 2 * 1.001:
        fail(f"collective (a): ZeRO-1 holds {zero1_bytes} B a rank against {repl_bytes} replicated")
    rec["server_state_bytes_per_rank"] = {"zero1": zero1_bytes, "replicated": repl_bytes}

    # q8 at block 256: the bound on round 1's contributions, and the wire
    # bytes of an exchange escalated to q8 against the model
    rec["q8"] = _q8_bound_gate(torch, np, landed1, mesh, device)
    zero1.q8_block = COLL_Q8_BLOCK
    zero1.set_quantization("q8")
    m_q8, path, _, _ = zero1._aggregate_elastic(COLL_ROUNDS + 1, landed1)
    sizes = [int(a.size) for a in landed1[0][0]]
    model_q8 = modeled_cross_slice_bytes(sizes, n_clients, replica=COLL_REPLICA,
                                         quantization="q8", block=zero1.q8_block)
    off_bytes = rec["zero1"]["rounds"][0]["server/collective_wire_bytes"]
    model_off = modeled_cross_slice_bytes(sizes, n_clients, replica=COLL_REPLICA)
    if path != "collective" or m_q8["server/collective_wire_bytes"] != model_q8 \
            or off_bytes != model_off:
        fail(f"collective (a): wire bytes {off_bytes} / {m_q8['server/collective_wire_bytes']} "
             f"({path}) against the model's {model_off} / {model_q8}")
    ratio = off_bytes / m_q8["server/collective_wire_bytes"]
    want_ratio = 4 / (1 + 4 / COLL_Q8_BLOCK)
    if abs(ratio / want_ratio - 1) > 0.01:
        fail(f"collective (a): off/q8 bytes {ratio}, not {want_ratio}")
    rec["q8"].update(wire_bytes_off=off_bytes, wire_bytes_q8=m_q8["server/collective_wire_bytes"],
                     ratio=ratio, ratio_model=want_ratio)
    del zero1, sharded_plane
    release()

    # the driver topology on the same config (the port's in-process
    # federated run over shm), and the planted fault below
    dcfg = cfg_fn()
    dcfg.photon.comm_stack.collective, dcfg.photon.comm_stack.shm = False, True
    dcfg.photon.comm_stack.collective_replica = 1
    dcfg.photon.comm_stack.collective_device_optimizer = False
    dcfg.photon.save_path = str(work / "driver")
    shm_root = "/dev/shm" if pathlib.Path("/dev/shm").is_dir() else str(work)
    shm_dir = tempfile.mkdtemp(prefix="photon-coll-", dir=shm_root)
    before, os.environ["PHOTON_SHM_DIR"] = os.environ.get("PHOTON_SHM_DIR"), shm_dir
    try:
        t0 = time.perf_counter()
        app = build_app(dcfg.validate(), n_nodes=1, device=device)
        round_params: dict = {}
        real_round = app.fit_round

        def fit_round(server_round, *a, **kw):
            out = real_round(server_round, *a, **kw)
            round_params[server_round] = [p.copy() for p in app.strategy.current_parameters]
            return out

        app.fit_round = fit_round
        app.run()
        driver_params = [p.copy() for p in app.strategy.current_parameters]
        app.driver.shutdown()
        rec["driver_s"] = time.perf_counter() - t0
    finally:
        if before is None:
            os.environ.pop("PHOTON_SHM_DIR", None)
        else:
            os.environ["PHOTON_SHM_DIR"] = before
        shutil.rmtree(shm_dir, ignore_errors=True)
    del app
    release()
    sound = _coll_gap(np, zero1_params, driver_params)
    sound1 = _coll_gap(np, round1["params"], round_params[1])
    # the fault: client 1's row lost on its way into the sum while its
    # samples still count (the failure JAX's one-row-per-shard check names)
    strat = _coll_strategy(cfg)
    strat.restore(before1)
    plane = DeviceAggregationPlane(_coll_mesh(n_clients, COLL_REPLICA, device), strat)
    plane.run_round([[torch.from_numpy(a).to(device)]
                     + [torch.zeros(a.shape, device=device)] * (n_clients - 1)
                     for a in landed1[0][0]],
                    [landed1[c][1] for c in sorted(landed1)], lr=strat.effective_lr(n_clients))
    fault = _coll_gap(np, plane.params_host(), round_params[1])
    del plane, strat
    release()
    rec["vs_driver"] = {"round2_excess": sound, "round1_excess": sound1,
                        "dropped_row_round1_excess": fault,
                        "max_abs_round2": max(float(np.max(np.abs(a - b)))
                                              for a, b in zip(zero1_params, driver_params))}
    if sound > 0 or sound1 > 0:
        fail(f"collective (a): the collective run parts from the driver topology's past "
             f"rtol {COLL_RTOL} / atol {COLL_ATOL} (excess {sound1} / {sound})")
    if not fault > 0:
        fail("collective (a): a plane that loses a client's row stayed within the tolerance")
    rec["launches_per_round"] = per_round
    rec["launches"] = {k: sum(r["launches"][k] for r in rec["zero1"]["rounds"])
                       for k in rec["zero1"]["rounds"][0]["launches"]}
    shutil.rmtree(work, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log("collective_phase " + json.dumps(rec))
    return rec


def _coll_strategy(cfg):
    from photon_tpu_torch.strategy import dispatch_strategy

    return dispatch_strategy(cfg.fl)


# -- (b) and (c) across processes; (c) and (d) in process, in a child -----------------


def _coll_cli_child(out_path: str, cli_args: list[str]) -> int:
    """``python -m photon_tpu_torch.federation.collective_round`` (its
    ``main``) in a child of :func:`collective_pair`, the launch counts set
    to 0 first; writes the run's parameters (``.npz``), History, paths,
    backend, staged legs, launches, peak device memory and the wall clock
    as its rounds ended, and the same as round ``COLL_ROUNDS`` ends
    (``<out_path>.r<COLL_ROUNDS>`` and its ``.npz``), which a process that dies in a later
    round leaves behind. Exits hard so a peer's abandoned group cannot hold
    the process open."""
    import os

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from photon_tpu_torch.federation import collective_round as cr
    from photon_tpu_torch.ops import flash_attention as fa

    seen: dict = {}
    real_run = cr.CollectiveFedRunner.run

    def run(self, n_rounds=None):
        seen["runner"] = self
        out = real_run(self, n_rounds)
        seen["rounds_end"] = time.time()
        return out

    real_round = cr.CollectiveFedRunner.run_round
    t0 = time.perf_counter()

    def write(r, path):
        np.savez(path + ".npz", *r.strategy.current_parameters)
        pathlib.Path(path).write_text(json.dumps({
            "history": r.history.to_dict(),
            "paths": {str(k): v for k, v in r.aggregation_paths.items()},
            "backend": r.backend, "staged_legs": sorted(r.mesh.staged_legs),
            "launches": dict(fa.launches), "wall_s": time.perf_counter() - t0,
            "rounds_end": seen.get("rounds_end"),
            "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() / 1e9
                                        if torch.cuda.is_initialized() else 0.0)}))

    def run_round(self, server_round):
        out = real_round(self, server_round)
        if server_round == COLL_ROUNDS:
            write(self, f"{out_path}.r{COLL_ROUNDS}")
        return out

    cr.CollectiveFedRunner.run = run
    cr.CollectiveFedRunner.run_round = run_round
    for key in fa.launches:
        fa.launches[key] = 0
    cr.main(cli_args)
    write(seen["runner"], out_path)
    sys.stdout.flush()
    os._exit(0)


def _coll_pair(work: pathlib.Path, tag: str, cfg, device: str) -> tuple[list, list]:
    """Start the collective CLI twice (processes 0 and 1 of one job on a
    free port, ``cfg`` as their YAML); returns the processes and their
    output paths."""
    work.mkdir(parents=True, exist_ok=True)
    cfg.to_yaml(work / f"{tag}.yaml")
    port = _free_port()
    procs, outs = [], []
    for pid in range(2):
        out = work / f"{tag}-{pid}.json"
        args = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                "--process-id", str(pid), "--config", str(work / f"{tag}.yaml")]
        if device == "cpu":
            args += ["--device", "cpu"]
        with open(work / f"{tag}-{pid}.log", "w") as log_f:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--collective-cli", str(out), "--",
                 *args], cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT))
        outs.append(out)
    return procs, outs


def _coll_wait(procs, work: pathlib.Path, tag: str) -> list:
    rcs = []
    for pid, p in enumerate(procs):
        try:
            rcs.append(p.wait(timeout=COLL_WAIT_S))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail(f"collective {tag}: process {pid} timed out: "
                 f"{(work / f'{tag}-{pid}.log').read_text()[-3000:]}")
    return rcs


def _coll_elastic(torch, np, cfg_fn, device: str, work: pathlib.Path) -> dict:
    """(c) in process: 3 clients, 4 rounds of one runner under the
    autopilot. A chaos mid-fit crash in round 2 reconfigures the cohort
    (the survivors-only fold, bit for bit) and round 3 runs all three; the
    straggler rule decides once. At quorum 0.9 the same crash in round 4
    degrades to the host fold (bit for bit ``aggregate_inplace``)."""
    import warnings

    from photon_tpu_torch import chaos, telemetry
    from photon_tpu_torch.config.schema import TelemetryConfig
    from photon_tpu_torch.federation.collective_round import CollectiveFedRunner
    from photon_tpu_torch.parallel.collective_agg import hierarchical_weighted_average
    from photon_tpu_torch.strategy.aggregation import aggregate_inplace

    def _crash(code):
        raise RuntimeError(f"chaos mid-fit crash ({code})")

    cfg = cfg_fn(n_clients=3, replica=1)
    cfg.photon.comm_stack.collective_stage_timeout_s = COLL_AP_TIMEOUT_S
    ch = cfg.photon.chaos
    ch.enabled, ch.crash_phase = True, "mid-fit"
    cfg.validate()
    tel = TelemetryConfig(enabled=True)
    tel.autopilot.enabled = True
    for k, v in COLL_AP.items():
        setattr(tel.autopilot, k, v)
    telemetry.install(tel, scope="collective", events_path=str(work / "events.jsonl"))
    rounds, folds = [], {}
    try:
        runner = CollectiveFedRunner(cfg, [0, 1, 2], mesh=_coll_mesh(3, 1, device), device=device)
        seen = _coll_capture(runner, rounds=(2, 4))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for rnd in range(1, 5):
                if rnd in (2, 4):  # one crash each, its marker fresh
                    ch.crash_round, ch.crash_marker = rnd, str(work / f"crash{rnd}.marker")
                    chaos.install(ch, scope="collective0", crash_fn=_crash)
                if rnd == 4:
                    runner.quorum = 0.9
                m = runner.run_round(rnd)
                chaos.uninstall()
                rounds.append({"path": runner.aggregation_paths[rnd],
                               "stragglers": m["server/collective_stragglers"],
                               "n_clients": m["server/n_clients"],
                               "round_s": m["server/round_time"]})
                if rnd in (2, 4):
                    folds[rnd] = [p.copy() for p in runner.strategy.current_parameters]
        decisions = [(d["event"], d["rule"], d["knob"], d["observed"], d["old"], d["new"])
                     for d in telemetry.autopilot_active().decisions
                     if d["rule"] == "straggler_deadline"]
    finally:
        chaos.uninstall()
        telemetry.uninstall()
    out: dict = {"rounds": rounds, "decisions": decisions}
    for rnd, path in ((2, "collective_reconfigured"), (4, "host_fallback")):
        landed, snap = seen[rnd]["landed"], seen[rnd]["before"]
        survivors = sorted(landed)
        oracle = _coll_strategy(cfg)
        oracle.restore(snap)
        if path == "collective_reconfigured":
            avg = hierarchical_weighted_average(
                [[torch.from_numpy(landed[c][0][i]).to(device) for c in survivors]
                 for i in range(len(landed[survivors[0]][0]))],
                [landed[c][1] for c in survivors], _coll_mesh(len(survivors), 1, device))
            avg = [a.cpu().numpy() for a in avg]
            n_total = sum(landed[c][1] for c in survivors)
        else:
            avg, n_total = aggregate_inplace(landed[c] for c in survivors)
        oracle.apply_average(rnd, avg, n_total, len(survivors))
        out[path] = {"survivors": survivors, "equal_to_fold": all(
            np.array_equal(a, b) for a, b in zip(folds[rnd], oracle.current_parameters))}
    paths = [r["path"] for r in rounds]
    if paths != ["collective", "collective_reconfigured", "collective", "host_fallback"] \
            or [r["stragglers"] for r in rounds] != [0.0, 1.0, 0.0, 1.0] \
            or rounds[2]["n_clients"] != 3.0 \
            or not all(out[p]["equal_to_fold"] and out[p]["survivors"] == [1, 2]
                       for p in ("collective_reconfigured", "host_fallback")):
        fail(f"collective (c): {out}")
    if len(decisions) != 1 or any(abs(a - b) > 1e-9 if isinstance(a, float) else a != b
                                  for a, b in zip(decisions[0], COLL_AP_DECISION)):
        fail(f"collective (e): the straggler rule decided {decisions}, not [{COLL_AP_DECISION}]")
    return out


def _coll_async(torch, np, cfg, ref_params, device: str, work: pathlib.Path) -> dict:
    """(d): the async runner with the buffer the cohort at zero staleness
    against the sync runner's parameters on the same config (bit for bit);
    then 4 clients, one slowed 4x, buffer 2, max staleness 1, under the
    autopilot."""
    from photon_tpu_torch import chaos, telemetry
    from photon_tpu_torch.config.schema import TelemetryConfig
    from photon_tpu_torch.federation.async_round import AsyncFedRunner

    rec: dict = {}
    cfg.photon.async_rounds.enabled = True
    cfg.photon.async_rounds.buffer_size = 2
    arun = AsyncFedRunner(cfg.validate(), [0, 1], mesh=_coll_mesh(2, 1, device), device=device)
    arun.run_versions(COLL_ROUNDS, eval_every=0)
    equal = all(np.array_equal(a, b) for a, b in zip(arun.strategy.current_parameters, ref_params))
    if not equal or arun.version != COLL_ROUNDS:
        fail(f"collective (d): async at zero staleness parts from the sync runner "
             f"(version {arun.version})")
    rec["zero_staleness_equal"] = equal
    del arun
    scfg = cfg.__class__.from_dict(cfg.to_dict())
    scfg.fl.n_total_clients = scfg.fl.n_clients_per_round = 4
    ar = scfg.photon.async_rounds
    ar.buffer_size, ar.max_staleness, ar.n_versions = 2, 1, COLL_ASYNC_VERSIONS
    ch = scfg.photon.chaos
    ch.enabled, ch.fit_delay_factor, ch.fit_delay_cid = True, 4.0, 3
    scfg.validate()
    tel = TelemetryConfig(enabled=True)
    tel.autopilot.enabled = True
    telemetry.install(tel, scope="async", events_path=str(work / "async_events.jsonl"))
    chaos.install(ch, scope="collective0")
    try:
        runner = AsyncFedRunner(scfg, [0, 1, 2, 3], mesh=_coll_mesh(4, 1, device), device=device)
        ap = telemetry.autopilot_active()
        runner.run()
        registered = "server/async_max_staleness" in ap._knobs
        ticked = ap._last_eval.get("async") is not None
    finally:
        chaos.uninstall()
        telemetry.uninstall()
    rec["stale"] = {"version": runner.version, "rejected": runner.rejected_total,
                    "sim_time": runner.sim_time, "knob_registered": registered,
                    "async_ticked": ticked}
    if runner.version != COLL_ASYNC_VERSIONS or runner.rejected_total < 1 or not registered \
            or not ticked:
        fail(f"collective (d): {rec['stale']}")
    return rec


def _coll_pair_cfg(cfg_fn, save_path):
    """(b)'s pair config at ``COLL_LAYERS``: each fit starts from a fresh
    optimizer, so a process with one client and one with two run the same
    computation (a runtime's optimizer state otherwise carries from one
    client to the next)."""
    cfg = cfg_fn(n_layers=COLL_LAYERS, replica=1, save_path=save_path)
    cfg.fl.fit_config = {"reset_optimizer": True}
    return cfg


def collective_leg(np, device: str = "cuda", cfg_fn=collective_config,
                   work: pathlib.Path = ROOT / ".chip_smoke" / "collective_leg",
                   ref_out: pathlib.Path = COLL_PAIR_REF) -> dict:
    """Phase 18 (c) in process and (d) (see the module's docstring): the
    in-process run that (b)'s pair is held to (its parameters saved to
    ``ref_out`` for :func:`collective_pair`), the elastic ladder in one
    process, and the async runner."""
    import torch

    t_leg = time.perf_counter()
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    def small(**kw):
        return cfg_fn(n_layers=COLL_LAYERS, save_path=work / "inproc", **kw)

    from photon_tpu_torch.federation.collective_round import CollectiveFedRunner

    rec: dict = {"seconds": {}}
    t1 = time.perf_counter()
    ref = CollectiveFedRunner(_coll_pair_cfg(cfg_fn, work / "inproc"), [0, 1],
                              mesh=_coll_mesh(2, 1, device), device=device)
    ref.run(COLL_ROUNDS)
    ref_params = [p.copy() for p in ref.strategy.current_parameters]
    del ref
    ref_out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(ref_out, *ref_params)
    rec["seconds"]["inprocess_ref"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rec["elastic"] = _coll_elastic(torch, np, small, device, work)
    rec["seconds"]["elastic"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rec["async"] = _coll_async(torch, np, _coll_pair_cfg(cfg_fn, work / "inproc"), ref_params,
                               device, work)
    rec["seconds"]["async"] = time.perf_counter() - t1
    shutil.rmtree(work, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_leg
    log("collective_leg " + json.dumps(rec))
    return rec


def collective_pair(np, device: str = "cuda", cfg_fn=collective_config,
                    work: pathlib.Path = ROOT / ".chip_smoke" / "collective_pair",
                    ref: pathlib.Path = COLL_PAIR_REF) -> dict:
    """Phase 18 (b) and (c) across processes, one pair of collective CLI
    processes on the one card for ``COLL_ROUNDS + 1`` rounds, with
    ``crash_phase: pre-exchange`` on process 1 in the last round and a
    ``COLL_TIMEOUT_S`` stage timeout. (b), on what each process wrote as
    round ``COLL_ROUNDS`` ended: both parameter sets bitwise equal and
    within (a)'s tolerance of the in-process run :func:`collective_leg`
    saved at ``ref``, K1–K3 launched exactly, the gloo backend; staged
    legs, contexts and each process's peak recorded. (c): process 1 exits
    137, process 0 degrades to the host fold in the last round and must
    end it within the timeout + ``COLL_SLACK_S`` of the crash (the crash
    marker's mtime against the wall clock as its rounds ended). The smoke
    runs it when nothing else is running: the fold after the dead peer is
    host work that a loaded host stretches."""
    t0 = time.perf_counter()
    cuda = device == "cuda"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    last = COLL_ROUNDS + 1
    cfg = _coll_pair_cfg(cfg_fn, work / "run")
    cfg.fl.n_rounds = last
    cfg.photon.comm_stack.collective_stage_timeout_s = COLL_TIMEOUT_S
    ch = cfg.photon.chaos
    ch.enabled, ch.crash_phase, ch.crash_round, ch.crash_node_id = \
        True, "pre-exchange", last, "collective1"
    ch.crash_marker = str(work / "crash.marker")
    cfg.validate()
    with (_GpuMemory() if cuda else contextlib.nullcontext()) as smi:
        procs, outs = _coll_pair(work, "x", cfg, device)
        rcs = _coll_wait(procs, work, "x")
    snaps = [pathlib.Path(f"{o}.r{COLL_ROUNDS}") for o in outs]
    if not all(p.exists() for p in snaps):
        fail(f"collective (b): a process wrote no round-{COLL_ROUNDS} record (exits {rcs}): "
             f"{(work / 'x-1.log').read_text()[-2000:]}")
    b = [json.loads(p.read_text()) for p in snaps]
    bp = [np.load(str(p) + ".npz") for p in snaps]
    bp = [[z[k] for k in z.files] for z in bp]
    z = np.load(ref)
    ref_params = [z[k] for k in z.files]
    bitwise = all(np.array_equal(x, y) for x, y in zip(bp[0], bp[1]))
    excess = _coll_gap(np, bp[0], ref_params)
    if not bitwise or excess > 0:
        fail(f"collective (b): processes bitwise {bitwise}, against the in-process run "
             f"{excess} past the tolerance")
    micro = cfg.train.global_batch_size // cfg.train.device_microbatch_size
    per_proc = COLL_ROUNDS * COLL_STEPS * COLL_LAYERS * micro
    for r in b:
        if cuda and r["launches"] != {k: per_proc for k in r["launches"]}:
            fail(f"collective (b): a process launched {r['launches']}, not {per_proc} each")
    rec = {"cli": {"backend": [r["backend"] for r in b],
                   "staged_legs": [r["staged_legs"] for r in b],
                   "paths": [r["paths"] for r in b], "bitwise": bitwise, "vs_inprocess": excess,
                   "peak_gb": [r["max_memory_allocated_gb"] for r in b],
                   "wall_s": [r["wall_s"] for r in b], "smi": smi.record() if cuda else None}}
    if any(r["backend"] != "gloo" for r in b):
        fail(f"collective (b): the backend was {rec['cli']['backend']} with one card")
    x0 = json.loads(outs[0].read_text()) if rcs[0] == 0 else None
    marker = pathlib.Path(ch.crash_marker)
    after = x0["rounds_end"] - marker.stat().st_mtime if x0 and marker.exists() else None
    want_paths = {**{str(r): "collective" for r in range(1, last)}, str(last): "host_fallback"}
    rec.update({"rcs": rcs, "paths": x0 and x0["paths"], "crash_to_round_end_s": after,
                "crash_round": last,
                "crash_round_agg_s": x0 and [
                    v for r, v in x0["history"]["server/collective_agg_time"] if r == last],
                "crash_round_reconfig_s": x0 and [
                    v for r, v in x0["history"]["server/collective_reconfig_time"] if r == last]})
    if rcs != [0, 137] or x0["paths"] != want_paths \
            or after is None or after > COLL_TIMEOUT_S + COLL_SLACK_S:
        fail(f"collective (c) across processes: {rec}: "
             f"{(work / 'x-0.log').read_text()[-2000:]}")
    shutil.rmtree(work, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t0
    log("collective_pair " + json.dumps(rec))
    return rec


def _collective_leg_child(out_path: str) -> int:
    """(c) and (d) in process (:func:`collective_leg`) in a child of the
    smoke beside phases 14-16; writes the
    record to ``out_path``."""
    import numpy as np

    sys.path.insert(0, str(ROOT))
    pathlib.Path(out_path).write_text(json.dumps(collective_leg(np)))
    return 0


def _collective_leg_start(work: pathlib.Path) -> subprocess.Popen:
    """Start the child of :func:`_collective_leg_child`."""
    work.mkdir(parents=True, exist_ok=True)
    with open(work / "collective_leg.log", "w") as out:
        return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--collective-leg",
                                 str(work / "collective_leg.json")],
                                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)


def _collective_leg_finish(proc: subprocess.Popen, work: pathlib.Path) -> dict:
    """Wait for :func:`_collective_leg_child`; its record, or the smoke fails
    with its log."""
    try:
        rc = proc.wait(timeout=COLL_WAIT_S + 300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        rc = "timeout"
    if rc != 0:
        fail(f"collective leg child exited {rc}: "
             f"{(work / 'collective_leg.log').read_text()[-3000:]}")
    return json.loads((work / "collective_leg.json").read_text())


# ---------------------------------------------------------------------------
# phase 19: model parallelism inside a client (a mesh on one card)
# ---------------------------------------------------------------------------

MESH_STEPS = 3
MESH_WAIT_S = 600.0
#: the legs: (preset, layers (None: the preset's), seq, mesh axes, global
#: batch, the meshed run's per-position microbatch; the single-device run
#: takes the whole batch in one microbatch, as the mesh does, except in
#: (f), whose two Trainers take the same microbatches). (d) is the GPipe
#: pipeline (remat on; the single-device run takes the stages' ``xla``
#: attention), (e) the expert mesh, (f) the autotuned Trainer (no mesh,
#: ``photon.mesh_autotune``), (g) an adapter fit (``photon.adapters``: LoRA
#: on ``MESH_LORA_TARGETS``, the base frozen) with ``auto`` microbatches on
#: both runs.
MESH_LEGS = {
    "a": ("mpt-125m", None, 4096, {"sequence": 4}, 4, 4),
    "b": ("mpt-125m", 2, 2048, {"fsdp": 2, "tensor": 2}, 8, 4),
    "c": ("llama-1b", 2, 4096, {"tensor": 2, "sequence": 2}, 2, 2),
    "d": ("mpt-125m", None, 2048, {"pipe": 4}, 8, 2),
    "e": ("mpt-125m-moe8", 2, 2048, {"expert": 4}, 8, 2),
    "f": ("mpt-125m", 2, 2048, {}, 8, 4),
    "g": ("mpt-125m", None, 2048, {"fsdp": 2, "tensor": 2}, 8, "auto"),
}
#: (g)'s adapter: rank, alpha and targets (column- and row-parallel both)
MESH_LORA = (8, 16.0)
MESH_LORA_TARGETS = ("wqkv", "out_proj", "up_proj", "down_proj")
#: (g)'s optimizer: AdamW with decoupled decay at a full learning rate from
#: step 1 (an adapter fit's), so decay reaching a frozen leaf would move it
MESH_LORA_OPT = {"name": "adamw", "lr": 1e-3, "weight_decay": 0.1}
#: K1 at (a)'s ring chunks: [B, S_q = S_k, H, D] at offset 0 (the diagonal,
#: causal) and at the chunk length (a chunk below it: every key visible)
MESH_CHUNK = (4, 1024, 12, 64)


def mesh_config(leg: str, meshed: bool):
    """Leg ``leg``'s config: the preset at full width, its depth cut for
    (b), (c), (e) and (f), seq and batch set, the mesh's axes when
    ``meshed`` ((f): ``photon.mesh_autotune`` instead); (g) an adapter fit
    (:func:`photon_tpu_torch.adapters.configure_adapter_training`) under
    ``MESH_LORA_OPT`` without warmup."""
    from photon_tpu_torch.adapters import configure_adapter_training
    from photon_tpu_torch.config import load_preset
    from photon_tpu_torch.config.schema import MeshConfig

    preset, layers, seq, axes, gbs, micro = MESH_LEGS[leg]
    cfg = load_preset(preset)
    cfg.run_uuid = f"chip-smoke-mesh-{leg}"
    if layers:
        cfg.model.n_layers = layers
    cfg.model.max_seq_len = seq
    cfg.train.global_batch_size = gbs
    cfg.train.device_microbatch_size = micro if meshed or leg in ("f", "g") else gbs
    cfg.mesh = MeshConfig(**axes) if meshed else MeshConfig()
    if leg == "g":
        ad = cfg.photon.adapters
        ad.enabled, (ad.rank, ad.alpha), ad.targets = True, MESH_LORA, list(MESH_LORA_TARGETS)
        ad.cohorts = {"a": [0]}
        configure_adapter_training(cfg)
        for key, value in MESH_LORA_OPT.items():
            setattr(cfg.optimizer, key, value)
        cfg.scheduler.t_warmup = 0
    if leg == "d":
        cfg.model.remat = True
        if not meshed:
            cfg.model.attn_impl = "xla"  # the attention the pipeline's stages fall back to
    cfg.photon.mesh_autotune = leg == "f" and meshed
    return cfg.validate()


def _mesh_launch_rule(mcfg, mesh_shape: dict, n_micro: int) -> dict:
    """K1–K3 launches a meshed step makes (``parallel/spmd.py``; ``mcfg``
    the trainer's effective model config): each ``(rows, tensor)`` group
    runs ``n(n+1)/2`` chunk kernels a layer over a ring of ``n`` sequence
    positions (the causal ring skips the chunks above the diagonal; ``n =
    1``: one flash call), in the forward and the backward; remat runs the
    forward again. The ``xla`` attention (a pipeline's stages) runs none."""
    if mcfg.attn_impl == "xla":
        return {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    n = mesh_shape["sequence"]
    groups = (mesh_shape["data"] * mesh_shape["fsdp"] * mesh_shape["expert"]
              * mesh_shape["tensor"])
    per = mcfg.n_layers * groups * n * (n + 1) // 2 * n_micro
    return {"flash_fwd": per * (2 if mcfg.remat else 1), "flash_bwd_dq": per,
            "flash_bwd_dkv": per}


def _mesh_grads(torch, trainer, tokens):
    """One batch's loss, grad norm and whole gradients on the meshed
    trainer's state (no optimizer step; a pipeline runs its microbatches)."""
    from photon_tpu_torch.optim.build import global_norm
    from photon_tpu_torch.parallel.spmd import mesh_gradients

    loss, grads = mesh_gradients(trainer.mesh_model, trainer.state.params,
                                 {d: tokens for d in trainer.mesh.distinct_devices()},
                                 trainer.cfg.train.loss_chunk_tokens)
    return float(loss), float(global_norm(list(grads.values()))), grads


def _vs(run, ref) -> dict:
    """``run`` (loss, grad norm, gradients) against ``ref``: relative
    differences, the largest per-parameter gradient relative L2, ``worst``."""
    loss_d = abs(run[0] - ref[0]) / abs(ref[0])
    norm_d = abs(run[1] - ref[1]) / abs(ref[1])
    per = {n: _rel_l2(run[2][n], ref[2][n]) for n in ref[2]}
    top = max(per, key=per.get)
    return {"loss_rel_diff": loss_d, "grad_norm_rel_diff": norm_d,
            "max_param_grad_rel_l2": per[top], "max_param": top,
            "worst": max(loss_d, norm_d, per[top])}


def _diagonal_offset_fault(ra):
    """A planted fault (patched in from outside the package): ring
    position 0's diagonal chunk runs at causal offset 1, not 0, so each of
    its queries also sees the key one position ahead."""
    real = ra.flash_attention_with_lse

    def faulty(q, k, v, *, causal=True, q_start=0, k_start=0, slopes=None):
        if q_start == k_start == 0:
            q_start += 1
        return real(q, k, v, causal=causal, q_start=q_start, k_start=k_start, slopes=slopes)

    return faulty


def _planted(torch, leg: str, trainer, tokens) -> dict:
    """The leg's planted fault, measured on the meshed trainer's gradients:
    (a) :func:`_diagonal_offset_fault`, (b) the tensor all-reduce keeping
    its first position's part alone, (c) RoPE positions restarting at 0 in
    every sequence chunk, (d) the last stage's tied head reading a detached
    ``wte`` (the head's share of its gradient lost), (g) tensor position 1
    of a column-parallel LoRA target reading position 0's columns of B."""
    from photon_tpu_torch.ops import ring_attention as ra
    from photon_tpu_torch.parallel import spmd

    if leg == "a":
        mod, name = ra, "flash_attention_with_lse"
        bad = _diagonal_offset_fault(ra)
    elif leg == "b":
        mod, name, bad = spmd, "_tensor_sum", lambda parts: parts[0]
    elif leg == "g":
        mod, name, bad = spmd, "_lora_b_cols", _lora_b_cols_fault(spmd._lora_b_cols)
    elif leg == "c":
        mod, name = spmd, "_global_positions"
        bad = lambda s, s_local, device: torch.arange(s_local, device=device)[None]  # noqa: E731
    else:
        mod, name = spmd.MeshModel, "_output_embedding"
        real = spmd.MeshModel._output_embedding
        bad = lambda self, params, dev: real(self, params, dev).detach()  # noqa: E731
    sound = getattr(mod, name)
    setattr(mod, name, bad)
    try:
        return _mesh_grads(torch, trainer, tokens)
    finally:
        setattr(mod, name, sound)


def _lora_b_cols_fault(real):
    """A planted fault for (g) on ``tensor 2``: the B columns of tensor
    position 1 (an odd block of the slice's width: ``wqkv``'s ``[q | k |
    v]`` slices and the MLP's hidden columns alike) taken from position 0's
    block before it."""
    def faulty(b, cols):
        if cols.start is None or (cols.start // (cols.stop - cols.start)) % 2 == 0:
            return real(b, cols)
        w = cols.stop - cols.start
        return real(b, slice(cols.start - w, cols.stop - w))

    return faulty


def _decay_on_frozen(real):
    """A planted fault for (g): after the real meshed optimizer step,
    AdamW's decoupled decay ``-lr · wd · p`` reaches the leaves the
    optimizer freezes."""
    def faulty(tx, state, grads):
        real(tx, state, grads)
        lr = tx.schedule(state.step)
        for name, st in state.params.items():
            if not tx.trainable(name):
                for t in st.shards.values():
                    t.data.add_(t.data * -(lr * tx.cfg.weight_decay))

    return faulty


def _lora_grads(torch, trainer, tokens):
    """One batch's loss, grad norm and the gradients of the leaves that
    take one (a LoRA fit's A/B) on a one-device trainer, in one
    microbatch, the state untouched."""
    from photon_tpu_torch.codec.params import flatten
    from photon_tpu_torch.optim.build import global_norm
    from photon_tpu_torch.train.train_step import make_loss_fn

    flat = {n: p for n, p in flatten(trainer.state.params).items() if p.requires_grad}
    loss = make_loss_fn(trainer.model, trainer.cfg.train.loss_chunk_tokens)(
        trainer.state.params, tokens)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return float(loss.detach()), float(global_norm(grads)), \
        {n: g.float() for n, g in zip(flat, grads)}


def _base_frozen(trainer, start: dict) -> bool:
    """Every leaf the optimizer freezes bit-equal to ``start`` (its
    host copy before the steps)."""
    meta, now = trainer.get_parameters()
    return all(a.tobytes() == start[n].tobytes() for n, a in zip(meta.names, now)
               if n in start)


def _probe_allowed(trainer, gbs: int, dp: int) -> bool:
    """The ``auto`` pick is one JAX's rule allows: a power of 2 of at most
    ``gbs // dp`` rows a position whose rows divide the batch."""
    m = trainer.device_microbatch_size
    return m >= 1 and m & (m - 1) == 0 and m <= gbs // dp and gbs % (m * dp) == 0


def _kept_set(r) -> set:
    """A routing's kept ``(token, expert, position)`` assignments."""
    slot, tok = r.kept.nonzero(as_tuple=True)
    return set(zip(tok.tolist(), r.expert[slot, tok].tolist(), r.position[slot, tok].tolist()))


@contextlib.contextmanager
def _recording(obj, name: str, calls: list):
    """``obj.name`` wrapped so each call's ``(args, result)`` is appended
    to ``calls`` (detached where a tensor)."""
    real = getattr(obj, name)

    def rec(*a, **kw):
        out = real(*a, **kw)
        calls.append((a, out))
        return out

    setattr(obj, name, rec)
    try:
        yield calls
    finally:
        setattr(obj, name, real)


def _per_position_route():
    """A planted fault for (e): each row group routes its own tokens into
    a capacity pool of its own (``expert_capacity`` of the group's
    tokens), the per-position dispatch that GSPMD's one pool rules out;
    the pools sit side by side in the expert buffers."""
    from photon_tpu_torch.ops.moe import Routing, expert_capacity, route
    from photon_tpu_torch.parallel import spmd

    def faulty(probs, n_r, n_s, top_k, capacity_factor, device):
        b, s, e = probs[0, 0].shape
        cap = expert_capacity(b * s, e, top_k, capacity_factor)  # each group's own pool
        parts = {g: (route(p.to(device).reshape(-1, e), top_k, cap), i)
                 for i, (g, p) in enumerate(probs.items())}

        def field(fn):
            return spmd._global_order({g: fn(r, i).reshape(top_k, *probs[g].shape[:2])
                                       .permute(1, 2, 0) for g, (r, i) in parts.items()},
                                      n_r, n_s).T

        aux = sum(r.aux for r, _ in parts.values()) / len(parts)
        return Routing(field(lambda r, i: r.expert), field(lambda r, i: r.position + i * cap),
                       field(lambda r, i: r.kept), field(lambda r, i: r.gates), aux), \
            cap * len(parts)

    return faulty


def _expert_gates(torch, trainer, one, tokens) -> dict:
    """(e)'s exact gate: the meshed step's kept ``(token, expert,
    position)`` sets of each layer (forward and remat recompute) against
    ``ops/moe.py``'s ``route`` over the concatenated global microbatch of
    the same router probabilities; the per-position pool fault must break
    them; and how many of one device's assignments the meshed step's
    routing parts from (bf16 near-ties), layer by layer."""
    from photon_tpu_torch.ops import moe
    from photon_tpu_torch.parallel import spmd
    from photon_tpu_torch.train.train_step import make_loss_fn

    e = trainer.model.cfg.moe_num_experts
    tok = {d: tokens for d in trainer.mesh.distinct_devices()}

    def global_sets(calls):
        same = []
        for (probs, n_r, n_s, k, cf, dev), (routing, _) in calls:
            p = torch.cat([torch.cat([probs[r, s] for s in range(n_s)], 1)
                           for r in range(n_r)]).reshape(-1, e).to(dev)
            want = moe.route(p, k, moe.expert_capacity(p.shape[0], e, k, cf))
            same.append(_kept_set(routing) == _kept_set(want))
        return same

    mesh_calls, one_calls = [], []
    with _recording(spmd, "_global_route", mesh_calls), _recording(moe, "route", one_calls):
        _mesh_grads(torch, trainer, tokens)
        with torch.no_grad():
            make_loss_fn(one.model, one.cfg.train.loss_chunk_tokens)(one.state.params, tokens)
    parted = [len(_kept_set(o) - _kept_set(m)) / max(len(_kept_set(o)), 1)
              for (_, (m, _)), (_, o) in zip(mesh_calls, one_calls)]
    fault_calls = []
    real = spmd._global_route
    spmd._global_route = _per_position_route()
    try:
        with _recording(spmd, "_global_route", fault_calls), torch.no_grad():
            trainer.mesh_model.loss(trainer.state.params, tok, trainer.cfg.train.loss_chunk_tokens)
    finally:
        spmd._global_route = real
    return {"layers_routed": len(mesh_calls), "kept_sets_equal": global_sets(mesh_calls),
            "kept_assignments": [len(_kept_set(r)) for _, (r, _) in mesh_calls],
            "capacity": mesh_calls[0][1][1],
            "one_device_assignments_parted": parted,
            "planted_per_position_pool_sets_equal": global_sets(fault_calls)}


def _mesh_leg(torch, fa, np, leg: str, device: str = "cuda", cfg_fn=mesh_config) -> dict:
    """One leg: a single-device Trainer and a Trainer on a mesh naming
    ``device`` (``cuda:0`` on the card) at every position, from the same
    weights (seed 0) and batches. Gates: exact K1–K3 launches on every
    meshed step; each step's loss and grad norm, and every parameter's
    gradient after step 1, within ``TRAIN_GRAD_GATE`` of the single-device
    run; the leg's planted fault over it; (b), (d): the parameters after
    the steps within the gate; (b): ``set_parameters`` →
    ``get_parameters`` bit for bit. (e): the gradients are recorded, and
    gated in an fp32 ``xla`` run of the same leg (bf16 routing near-ties
    part the two runs' assignments); the kept sets are gated exactly
    (:func:`_expert_gates`), the per-position pool fault breaking them.
    (g): the A/B gradients (:func:`_lora_grads` one device's), the base
    bit-frozen on both runs (AdamW's decay reaching it must break that),
    the ``auto`` picks JAX's rule allows, the probes' candidates and
    seconds. ``device="cpu"`` and a small ``cfg_fn`` rehearse it (no peaks,
    no profiler)."""
    import copy

    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.parallel.mesh import make_mesh
    from photon_tpu_torch.train.trainer import Trainer

    t_leg = time.perf_counter()
    cuda = device == "cuda"
    one_cfg, mesh_cfg = cfg_fn(leg, False), cfg_fn(leg, True)
    mesh = make_mesh(mesh_cfg.mesh, devices=["cuda:0" if cuda else device] * mesh_cfg.mesh.size)
    params = init_params(one_cfg.model, seed=0, device=device)
    one = Trainer(copy.deepcopy(one_cfg), params=params, device=device)
    meshed = Trainer(copy.deepcopy(mesh_cfg), params=params, device=device, mesh=mesh)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rule = _mesh_launch_rule(meshed.model.cfg, mesh.shape, meshed._n_micro)
    one_rule = _mesh_launch_rule(one.model.cfg, {a: 1 for a in mesh.shape}, one._n_micro)
    rng = np.random.default_rng(19)
    gbs, seq = mesh_cfg.train.global_batch_size, mesh_cfg.model.max_seq_len
    batches = [rng.integers(0, mesh_cfg.model.vocab_size, (gbs, seq)).astype(np.int64)
               for _ in range(MESH_STEPS)]
    rec: dict = {"mesh": mesh.shape, "attn_impl": meshed.model.cfg.attn_impl,
                 "n_layers": mesh_cfg.model.n_layers, "seq": seq, "global_batch": gbs,
                 "n_micro": meshed._n_micro, "launch_rule_per_step": rule,
                 "single_device_launch_rule_per_step": one_rule, "steps": []}
    if leg == "g":
        dp = mesh.shape["data"] * mesh.shape["fsdp"] * mesh.shape["expert"]
        rec["auto_probe"] = {tag: {"picked": t.device_microbatch_size,
                                   "allowed": _probe_allowed(t, gbs, d), **t.auto_probe}
                             for tag, t, d in (("mesh", meshed, dp), ("single", one, 1))}
        if not all(r["allowed"] for r in rec["auto_probe"].values()):
            fail(f"mesh leg g: an auto pick JAX's rule does not allow: {rec['auto_probe']}")
        meta, start = one.get_parameters()
        base0 = {n: a for n, a in zip(meta.names, start) if not one.tx.trainable(n)}
        del start
    walls = {"single": [], "mesh": []}
    peaks = {}
    counted = {"single": dict.fromkeys(fa.launches, 0), "mesh": dict.fromkeys(fa.launches, 0)}

    def step(trainer, tag, batch):
        before = dict(fa.launches)
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = trainer.train_batch(batch)
        sync()
        walls[tag].append(time.perf_counter() - t0)
        peaks[tag] = max(peaks.get(tag, 0), torch.cuda.max_memory_allocated() if cuda else 0)
        grew = {k: fa.launches[k] - before[k] for k in before}
        for k, n in grew.items():
            counted[tag][k] += n
        want = rule if tag == "mesh" else one_rule
        if grew != want:
            fail(f"mesh leg {leg} ({tag}) step: kernel launches {grew}, want {want}")
        return {k: float(v) for k, v in m.items()}

    for key in fa.launches:  # the counted runs start here (each step's growth is read)
        fa.launches[key] = 0
    for i, batch in enumerate(batches):
        if i == 1:  # every parameter's gradient after step 1, and the fault
            tokens = torch.from_numpy(batch).to(device)
            ref = (_lora_grads(torch, one, tokens) if leg == "g"
                   else _grads_of(torch, one_cfg, one.state.params, tokens))
            got = _mesh_grads(torch, meshed, tokens)
            rec["grads_after_step_1"] = _vs(got, ref)
            if leg == "e":
                rec["routing"] = _expert_gates(torch, meshed, one, tokens)
            else:
                rec["planted_fault"] = _vs(_planted(torch, leg, meshed, tokens), ref)
            del ref, got, tokens
        m1, mm = step(one, "single", batch), step(meshed, "mesh", batch)
        rec["steps"].append({"single": m1, "mesh": mm,
                             "loss_rel_diff": abs(mm["loss"] - m1["loss"]) / abs(m1["loss"]),
                             "grad_norm_rel_diff": abs(mm["grad_norm"] - m1["grad_norm"])
                             / abs(m1["grad_norm"])})
    rec["launches"], rec["single_device_launches"] = counted["mesh"], counted["single"]
    tokens_per_step = gbs * seq
    for tag in walls:
        s = statistics.median(walls[tag][1:])
        rec[tag] = {"step_wall_s": walls[tag], "step_s_median_after_first": s,
                    "tokens_per_s": tokens_per_step / s,
                    "max_memory_allocated_gb": peaks[tag] / 1e9}
    steps_worst = max([s["loss_rel_diff"] for s in rec["steps"]]
                      + [s["grad_norm_rel_diff"] for s in rec["steps"]])
    # (e)'s and (g)'s gradients are gated in fp32 (_fp32_xla_grads, _fp32_lora_gates)
    worst = steps_worst if leg in ("e", "g") else max(steps_worst,
                                                      rec["grads_after_step_1"]["worst"])
    rec["worst"] = worst
    if not all(np.isfinite(v) for s in rec["steps"] for v in s["mesh"].values()):
        fail(f"mesh leg {leg}: metrics not finite: {rec['steps']}")
    if worst > TRAIN_GRAD_GATE:
        fail(f"mesh leg {leg}: the meshed run parts from the single-device run by {worst:.3e} "
             f"> {TRAIN_GRAD_GATE}")
    if leg == "e":
        routing = rec["routing"]
        if not routing["layers_routed"] or not all(routing["kept_sets_equal"]):
            fail(f"mesh leg e: the meshed step's kept sets part from one global route: "
                 f"{routing['kept_sets_equal']}")
        if all(routing["planted_per_position_pool_sets_equal"]):
            fail("mesh leg e: the exact gate misses the per-position capacity pools")
    elif rec["planted_fault"]["worst"] <= TRAIN_GRAD_GATE:
        fail(f"mesh leg {leg}: the gate {TRAIN_GRAD_GATE} misses the planted fault (reading "
             f"{rec['planted_fault']['worst']:.3e})")
    if leg in ("a", "d", "g") and cuda:  # where the time goes, one more step of each under the profiler
        for tag, trainer in (("single", one), ("mesh", meshed)):
            rec[tag]["profiled_step"] = _profiled_step(
                torch, lambda t=trainer: t.train_batch(batches[0]),
                rec[tag]["step_s_median_after_first"])
    if leg == "g":  # after every step each trainer took, the profiled one included
        rec["base_bit_frozen"] = {"mesh": _base_frozen(meshed, base0),
                                  "single": _base_frozen(one, base0)}
        if not all(rec["base_bit_frozen"].values()):
            fail(f"mesh leg g: a frozen base leaf moved: {rec['base_bit_frozen']}")
    if leg in ("b", "d", "g"):
        meta, got = meshed.get_parameters()
        _, want = one.get_parameters()
        rel = {n: _rel_l2(torch.from_numpy(g), torch.from_numpy(w))
               for n, g, w in zip(meta.names, got, want)}
        rec["params_after_steps_max_rel_l2"] = max(rel.values())
        if leg == "g":  # bf16, recorded: A/B are gated in fp32
            rec["params_after_steps_rel_l2"] = {n: v for n, v in rel.items() if v}
        elif rec["params_after_steps_max_rel_l2"] > TRAIN_GRAD_GATE:
            fail(f"mesh leg {leg}: parameters after the steps part by "
                 f"{rec['params_after_steps_max_rel_l2']:.3e}")
    if leg == "b":
        mutated = [a * 0.5 + 0.25 for a in want]
        meshed.set_parameters(meta, mutated)
        back = meshed.get_parameters()[1]
        rec["set_get_round_trip_bit_equal"] = all(a.tobytes() == b.tobytes()
                                                  for a, b in zip(mutated, back))
        if not rec["set_get_round_trip_bit_equal"]:
            fail("mesh leg b: set_parameters -> get_parameters is not bit for bit")
    if leg == "g":  # the planted decay on the frozen base, one more meshed step
        from photon_tpu_torch.parallel import spmd

        sound = spmd.apply_optimizer
        spmd.apply_optimizer = _decay_on_frozen(sound)
        try:
            meshed.train_batch(batches[0])
        finally:
            spmd.apply_optimizer = sound
        rec["planted_decay_base_bit_frozen"] = _base_frozen(meshed, base0)
        if rec["planted_decay_base_bit_frozen"]:
            fail("mesh leg g: the bit-frozen base gate misses AdamW's decay on a frozen leaf")
    del one, meshed
    if leg == "e":  # the per-parameter gradients, gated in fp32 through xla
        rec["fp32_xla"] = _fp32_xla_grads(torch, np, one_cfg, mesh_cfg, mesh, params, device,
                                          batches[1])
    if leg == "g":  # the A/B gradients and factors, gated in fp32
        rec["fp32"] = _fp32_lora_gates(torch, one_cfg, mesh_cfg, mesh, params, device, batches,
                                       (rec["auto_probe"]["single"]["picked"],
                                        rec["auto_probe"]["mesh"]["picked"]))
    del params
    if cuda:
        torch.cuda.empty_cache()
    rec["leg_s"] = time.perf_counter() - t_leg
    log(f"mesh_leg {leg} " + json.dumps({k: v for k, v in rec.items() if k != "steps"}))
    return rec


def _fp32_xla_grads(torch, np, one_cfg, mesh_cfg, mesh, params, device, batch) -> dict:
    """(e) in fp32 through the ``xla`` attention, where routing flips are
    rare: every parameter's gradient of one batch against one device's,
    gated at ``TRAIN_GRAD_GATE``."""
    import copy

    from photon_tpu_torch.train.trainer import Trainer

    cfgs = []
    for c in (one_cfg, mesh_cfg):
        c = copy.deepcopy(c)
        c.model.compute_dtype, c.model.attn_impl = "float32", "xla"
        cfgs.append(c.validate())
    meshed = Trainer(cfgs[1], params=params, device=device, mesh=mesh)
    tokens = torch.from_numpy(batch).to(device)
    got = _mesh_grads(torch, meshed, tokens)
    del meshed
    out = _vs(got, _grads_of(torch, cfgs[0], params, tokens))
    if out["worst"] > TRAIN_GRAD_GATE:
        fail(f"mesh leg e (fp32, xla): the meshed gradients part from one device's by "
             f"{out['worst']:.3e} > {TRAIN_GRAD_GATE}")
    return out


def _fp32_lora_gates(torch, one_cfg, mesh_cfg, mesh, params, device, batches,
                     micro: tuple[int, int]) -> dict:
    """(g) in fp32 (the kernels' fp32 versions), where bf16's rounding does
    not swamp the A gradients (with B one step from zero they read ~1e-2 of
    B's gradient norm): the one-device and meshed Trainers at (g)'s
    ``auto`` picks ``micro``, the same weights and batches. Gated at
    ``TRAIN_GRAD_GATE``: each step's loss and grad norm, every A/B gradient
    after step 1 and the factors after the steps; (g)'s planted fault over
    it. Recorded at the same state after step 1: the A/B gradients of the
    bf16 models (one device and the mesh) against one device's fp32 ones,
    bf16's own floor beside the mesh's reading."""
    import copy

    from photon_tpu_torch.models.mpt import MPTModel
    from photon_tpu_torch.parallel import spmd
    from photon_tpu_torch.train.trainer import Trainer

    cfgs = []
    for c, m in zip((one_cfg, mesh_cfg), micro):
        c = copy.deepcopy(c)
        c.model.compute_dtype, c.train.device_microbatch_size = "float32", m
        cfgs.append(c.validate())
    one = Trainer(cfgs[0], params=params, device=device)
    meshed = Trainer(cfgs[1], params=params, device=device, mesh=mesh)
    rec: dict = {"steps": []}
    for i, batch in enumerate(batches):
        if i == 1:
            tokens = torch.from_numpy(batch).to(device)
            ref = _lora_grads(torch, one, tokens)
            rec["grads_after_step_1"] = _vs(_mesh_grads(torch, meshed, tokens), ref)
            rec["planted_fault"] = _vs(_planted(torch, "g", meshed, tokens), ref)
            bf16 = [one.model, meshed.mesh_model]
            one.model = MPTModel(one_cfg.model)  # the bf16 models over the same state
            meshed.mesh_model = spmd.MeshModel(one_cfg.model, mesh)
            rec["bf16_one_device_vs_fp32"] = _vs(_lora_grads(torch, one, tokens), ref)
            rec["bf16_mesh_vs_fp32"] = _vs(_mesh_grads(torch, meshed, tokens), ref)
            one.model, meshed.mesh_model = bf16
            del tokens, ref
        m1 = {k: float(v) for k, v in one.train_batch(batch).items()}
        mm = {k: float(v) for k, v in meshed.train_batch(batch).items()}
        rec["steps"].append({"loss_rel_diff": abs(mm["loss"] - m1["loss"]) / abs(m1["loss"]),
                             "grad_norm_rel_diff": abs(mm["grad_norm"] - m1["grad_norm"])
                             / abs(m1["grad_norm"])})
    meta, got = meshed.get_parameters()
    _, want = one.get_parameters()
    rec["factors_after_steps_max_rel_l2"] = max(
        _rel_l2(torch.from_numpy(g), torch.from_numpy(w))
        for n, g, w in zip(meta.names, got, want) if "_lora_" in n)
    del one, meshed
    rec["worst"] = max([v for s in rec["steps"] for v in s.values()]
                       + [rec["grads_after_step_1"]["worst"],
                          rec["factors_after_steps_max_rel_l2"]])
    if rec["worst"] > TRAIN_GRAD_GATE:
        fail(f"mesh leg g (fp32): the meshed run parts from one device's by "
             f"{rec['worst']:.3e} > {TRAIN_GRAD_GATE}")
    if rec["planted_fault"]["worst"] <= TRAIN_GRAD_GATE:
        fail(f"mesh leg g (fp32): the gate misses the planted fault (reading "
             f"{rec['planted_fault']['worst']:.3e})")
    return rec


def _autotune_leg(torch, fa, np, device: str = "cuda", cfg_fn=mesh_config) -> dict:
    """(f): a Trainer built without a mesh under ``photon.mesh_autotune``
    against a plain single-device Trainer, same weights and batches. Gates:
    the tuner picks ``1×1×1×1`` on one card (no mesh), the two
    trajectories and the parameters after the steps are bit for bit equal,
    K1–K3 launches exact on every step. Records the tuner's ``est_step_s``
    and search seconds beside the measured step."""
    import copy

    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.train.trainer import Trainer

    t_leg = time.perf_counter()
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    one_cfg, auto_cfg = cfg_fn("f", False), cfg_fn("f", True)
    params = init_params(one_cfg.model, seed=0, device=device)
    one = Trainer(copy.deepcopy(one_cfg), params=params, device=device)
    auto = Trainer(copy.deepcopy(auto_cfg), params=params, device=device)
    del params
    tuned = auto.layout_autotune
    axes = {a: getattr(tuned["mesh"], a) for a in ("data", "fsdp", "tensor", "sequence",
                                                    "pipe", "expert")}
    if auto.mesh is not None or set(axes.values()) != {1}:
        fail(f"mesh leg f: the autotuner picked {axes} on one device")
    rule = _mesh_launch_rule(auto.model.cfg, axes, auto._n_micro)
    rng = np.random.default_rng(19)
    gbs, seq = auto_cfg.train.global_batch_size, auto_cfg.model.max_seq_len
    launches = dict.fromkeys(fa.launches, 0)
    walls, steps = [], []
    for key in fa.launches:
        fa.launches[key] = 0
    for _ in range(MESH_STEPS):
        batch = rng.integers(0, auto_cfg.model.vocab_size, (gbs, seq)).astype(np.int64)
        m1 = {k: float(v) for k, v in one.train_batch(batch).items()}
        before = dict(fa.launches)
        sync()
        t0 = time.perf_counter()
        ma = {k: float(v) for k, v in auto.train_batch(batch).items()}
        sync()
        walls.append(time.perf_counter() - t0)
        grew = {k: fa.launches[k] - before[k] for k in before}
        for k, n in grew.items():
            launches[k] += n
        if grew != rule:
            fail(f"mesh leg f step: kernel launches {grew}, want {rule}")
        steps.append({"single": m1, "autotuned": ma})
    equal = all(s["single"] == s["autotuned"] for s in steps)
    meta, got = auto.get_parameters()
    params_equal = all(a.tobytes() == b.tobytes() for a, b in zip(got, one.get_parameters()[1]))
    if not (equal and params_equal):
        fail(f"mesh leg f: the autotuned Trainer parts from one device (metrics equal {equal}, "
             f"parameters equal {params_equal}): {steps}")
    step_s = statistics.median(walls[1:])
    rec = {"picked": axes, "search_s": tuned["search_s"], "est_step_s": tuned["est_step_s"],
           "step_wall_s": walls, "step_s_median_after_first": step_s,
           "measured_over_estimated": step_s / tuned["est_step_s"],
           "tokens_per_s": gbs * seq / step_s, "steps": steps, "bit_equal": True,
           "launch_rule_per_step": rule, "launches": launches,
           "leg_s": time.perf_counter() - t_leg}
    del one, auto
    if cuda:
        torch.cuda.empty_cache()
    log("mesh_leg f " + json.dumps({k: v for k, v in rec.items() if k != "steps"}))
    return rec


def mesh_chunk_kernels(torch, fa) -> list[dict]:
    """K1–K3 at leg (a)'s ring chunk shape, bf16, at causal offset 0 (the
    diagonal chunk) and at the chunk length (a chunk below it), each
    against its plain version; K1's time with its bound and SDPA's (causal
    on the diagonal, unmasked below). The launches here are not counted."""
    import torch.nn.functional as F

    saved = dict(fa.launches)
    b, s, h, d = MESH_CHUNK
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    q, k, v, do = (torch.randn(b, s, h, d, device=dev, generator=g, dtype=torch.bfloat16)
                   for _ in range(4))
    out = []
    for name, offset in (("diagonal", 0), ("below", s)):
        kw = dict(causal=True, offset=offset)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, **kw)
        delta = fa.attention_delta(o, do)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        dq_r = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
        dk_r, dv_r = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
        errs = {"flash_fwd": _rel_l2(o.float(), o_ref.float()),
                "flash_bwd_dq": _rel_l2(dq.float(), dq_r.float()),
                "flash_bwd_dkv": max(_rel_l2(dk.float(), dk_r.float()),
                                     _rel_l2(dv.float(), dv_r.float()))}
        gates = {"flash_fwd": FLASH_FWD_GATE["bfloat16"],
                 "flash_bwd_dq": FLASH_BWD_GATE["bfloat16"],
                 "flash_bwd_dkv": FLASH_BWD_GATE["bfloat16"]}
        for kname, err in errs.items():
            if not err <= gates[kname]:
                fail(f"{kname} at the ring chunk ({name}, offset {offset}): rel L2 {err:.3e} "
                     f"> {gates[kname]}")
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        nbytes, flops = _flash_work(b, s, s, h, h, d, offset == 0, q.element_size())["flash_fwd"]
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
        rec = {"chunk": name, "offset": offset, "shape": f"B={b} S_q=S_k={s} H={h} D={d} bf16",
               "rel_l2": errs, "max_abs_err": float((o.float() - o_ref.float()).abs().max()),
               "ms": _time_ms(torch, lambda: fa.flash_fwd(q, k, v, **kw), flush),
               "plain_ms": _time_ms(torch, lambda: fa.flash_fwd_reference(q, k, v, **kw), flush),
               "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
                   qs, ks, vs, is_causal=offset == 0), flush),
               "bytes": nbytes, "flops": flops, "bound_ms": max(t_b, t_o),
               "bound_by": "bytes" if t_b >= t_o else "operations"}
        out.append(rec)
        log("mesh_chunk_k1 " + json.dumps(rec))
        del o, lse, o_ref, lse_ref, delta, dq, dk, dv, dq_r, dk_r, dv_r
    for key in fa.launches:
        fa.launches[key] = saved[key]
    del q, k, v, do, flush
    torch.cuda.empty_cache()
    return out


def mesh_phase(torch, fa, np) -> dict:
    """Phase 19: legs (a)-(e) and (g) (:func:`_mesh_leg`), (f)
    (:func:`_autotune_leg`) and K1–K3 at (a)'s ring chunks
    (:func:`mesh_chunk_kernels`)."""
    t0 = time.perf_counter()
    rec = {"chunks": mesh_chunk_kernels(torch, fa)}
    for leg in MESH_LEGS:
        rec[leg] = _autotune_leg(torch, fa, np) if leg == "f" else _mesh_leg(torch, fa, np, leg)
    rec["launches"] = {leg: rec[leg]["launches"] for leg in MESH_LEGS}
    rec["phase_s"] = time.perf_counter() - t0
    log(f"mesh phase: {rec['phase_s']:.1f} s (" + ", ".join(
        f"({leg}) {rec[leg]['leg_s']:.1f} s" for leg in MESH_LEGS) + ")")
    return rec


def _phase_child(flag: str, out_path: str) -> int:
    """Phase 18 (a), (e) (``--collective-a``) or phase 19 (``--mesh-phase``)
    in a child of the smoke beside phase 5b, with launch counters and peak
    memory of its own; writes the record to ``out_path``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from photon_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.zeros(1, device="cuda")  # the context exists before the parent goes on
    pathlib.Path(out_path + ".ready").touch()
    rec = collective_phase(torch, np) if flag == "--collective-a" else mesh_phase(torch, fa, np)
    pathlib.Path(out_path).write_text(json.dumps(rec))
    return 0


def _child_start(work: pathlib.Path, flag: str) -> subprocess.Popen:
    """Start :func:`_phase_child` for ``flag``."""
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    with open(work / "child.log", "w") as out:
        return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), flag,
                                 str(work / "child.json")],
                                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)


def _children_ready(children: list, timeout: float = 120.0) -> None:
    """Wait until each ``(proc, work)`` child holds its CUDA context (phase
    5b's TCP gate counts the card's contexts from before its run)."""
    t0 = time.perf_counter()
    while not all((work / "child.json.ready").exists() for _, work in children):
        for proc, work in children:
            if proc.poll() is not None:
                fail(f"{proc.args[2]} child exited {proc.returncode} before it was ready: "
                     f"{(work / 'child.log').read_text()[-3000:]}")
        if time.perf_counter() - t0 > timeout:
            fail(f"the phase children took over {timeout} s to open their CUDA contexts")
        time.sleep(0.2)


def _child_finish(proc: subprocess.Popen, work: pathlib.Path, timeout: float) -> dict:
    """Wait for a :func:`_child_start` child; its record, or the smoke fails
    with its log."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        rc = "timeout"
    log((work / "child.log").read_text()[-20000:].rstrip())
    if rc != 0:
        fail(f"{proc.args[2]} child exited {rc}")
    return json.loads((work / "child.json").read_text())


def fed_1b() -> int:
    """``python -m photon_tpu_torch.federated`` at mpt-1b: 2 in-process
    nodes on one card, 2 clients a round, 1 local step each (global batch
    8: 2 microbatches of the preset's 4), no eval, no checkpoint, the shm
    plane in a directory of its own; its ``main`` in a child
    (:func:`_fed_child`). Prints and writes (``chiprun_out/fed_1b.json``)
    the child's peak device memory, the round's breakdown from its History
    and the card's training share."""
    import tempfile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    work = ROOT / ".chip_smoke" / "fed1b"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    need = 4 * 4 * 1.42e9  # a round holds the broadcast and both results (fp32)
    free = shutil.disk_usage("/dev/shm").free if pathlib.Path("/dev/shm").is_dir() else 0
    shm_dir = tempfile.mkdtemp(prefix="photon-fed1b-", dir="/dev/shm" if free >= need else work)
    args = FED_1B_ARGS + ["--set", f"photon.save_path={work}"]
    try:
        run = _fed_cli_run(work, "mpt-1b", args, shm_dir)
    finally:
        shutil.rmtree(shm_dir, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
    run["rounds"] = _round_breakdown(run["history"], [1])
    rec = {"nvidia_smi": smi, "command": "python -m photon_tpu_torch.federated " + " ".join(args),
           "shm_dir": shm_dir, "dev_shm_free_gb": free / 1e9, **run}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "fed_1b.json").write_text(json.dumps(rec, indent=1))
    log("fed_1b " + json.dumps({k: v for k, v in rec.items() if k != "history"}))
    return 0


# ---------------------------------------------------------------------------

def main() -> int:
    if sys.argv[1:2] == ["--fed-child"]:  # a child of the federated phases
        cut = sys.argv.index("--")
        return _fed_child(sys.argv[2], sys.argv[cut + 1:], sys.argv[3:cut])
    if sys.argv[1:2] == ["--host-cli"]:  # an interop CLI
        return _host_cli_child(sys.argv[2], sys.argv[sys.argv.index("--") + 1:])
    if sys.argv[1:2] == ["--tcp-node-child"]:  # a node of the chaos phase
        return _tcp_node_child(sys.argv[2], sys.argv[sys.argv.index("--") + 1:])
    if sys.argv[1:2] == ["--autopilot-fleet"]:  # phase 17 (d)
        return _autopilot_fleet_child(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--collective-leg"]:  # phase 18 (c), (d) in process
        return _collective_leg_child(sys.argv[2])
    if sys.argv[1:2] in (["--mesh-phase"], ["--collective-a"]):  # phase 19, 18 (a)
        return _phase_child(sys.argv[1], sys.argv[2])
    if sys.argv[1:2] == ["--collective-cli"]:  # a process of 18 (b) and (c)'s pair
        return _coll_cli_child(sys.argv[2], sys.argv[sys.argv.index("--") + 1:])
    if sys.argv[1:2] == ["--fed-1b"]:
        return fed_1b()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from photon_tpu_torch.ops import _build
        from photon_tpu_torch.ops import flash_attention as fa
        from photon_tpu_torch.ops import ragged_paged_attention as rpa
    except ImportError as e:
        print(f"chip_smoke: photon_tpu_torch is not beside this script ({e})", file=sys.stderr)
        return 2
    import numpy as np

    from photon_tpu_torch.models.mpt import init_params
    from photon_tpu_torch.ops.attention import alibi_slopes

    # fp32 matmuls stay full fp32 (the fp32 kernel gates compare against them)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    env = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0),
           "capability": list(torch.cuda.get_device_capability(0)), "nvidia_smi": smi}
    from photon_tpu_torch import native

    t0 = time.perf_counter()
    sources = ("ragged_paged_attention.cu", "flash_attention.cu")
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 2) as pool:  # one nvcc per source
        lint = pool.submit(lint_preflight)  # photon-lint beside the builds, read first
        built_native = pool.submit(native.available)  # and g++ for the host helpers
        builds = pool.map(_build.build, sources)
        env["lint"] = lint.result()
        list(builds)
        if not built_native.result():
            fail(f"the native library did not build: {native.build_error}")
    for src in sources:
        _build.load(src)
    env["build_s"] = time.perf_counter() - t0
    env["nvcc_s"] = _build.build_seconds
    env["ptxas_performance_notes"] = {  # wgmma that ptxas had to serialize
        src: [x.strip() for x in _build.build_log.get(src, "").splitlines()
              if "Performance Loss" in x or "serialized" in x] for src in sources}
    log("env " + json.dumps(env))
    built = build_report(_build, sources)
    for name, rec in built.items():
        log("kernel_build " + json.dumps(dict(rec, kernel=name)))

    native_rec = native_phase(np)
    kernel_records, main = kernel_phase(torch, rpa, alibi_slopes, np)
    flash_records, flash_main, flash_eval = flash_kernel_phase(torch, fa, alibi_slopes, np)
    t0 = time.perf_counter()
    presets, moe_params = presets_phase(torch, fa)
    presets_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    d128 = d128_grad_gate(torch, fa, np)
    d128["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe_dispatch = moe_dispatch_gate(torch, np, moe_params, preset_config(MOE_PRESET).model)
    moe_dispatch["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe_engine = moe_engine_phase(torch, rpa, np, moe_params)
    moe_engine["phase_s"] = time.perf_counter() - t0
    del moe_params
    torch.cuda.empty_cache()
    log(f"presets phase: {presets_s:.1f} s; D=128 gate {d128['phase_s']:.1f} s; MoE dispatch "
        f"{moe_dispatch['phase_s']:.1f} s; MoE engine {moe_engine['phase_s']:.1f} s")
    t0 = time.perf_counter()
    train = training_phase(torch, fa, np)
    train["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    entry = entry_phase(torch, fa)
    entry["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    native_before = dict(native.calls)
    fed = federated_phase(torch, np)
    fed["phase_s"] = time.perf_counter() - t0
    # the in-process rounds' shm puts and loaders went through the library
    fed["native_calls"] = {k: native.calls[k] - native_before[k] for k in native.calls}
    log("federated native calls " + json.dumps(fed["native_calls"]))
    if not (fed["native_calls"]["parallel_memcpy"] and fed["native_calls"]["gather_rows"]):
        fail(f"phase 5's shm puts or loaders skipped the native library: {fed['native_calls']}")
    # phase 18 (a), (e) and phase 19 in children of their own (their launch
    # counters and peaks) while phase 5b runs here
    coll_a_work = ROOT / ".chip_smoke" / "collective_a_child"
    mesh_work = ROOT / ".chip_smoke" / "mesh_child"
    coll_a = _child_start(coll_a_work, "--collective-a")
    mesh_child = _child_start(mesh_work, "--mesh-phase")
    t0 = time.perf_counter()
    try:
        _children_ready([(coll_a, coll_a_work), (mesh_child, mesh_work)])
        dist = distributed_phase(torch, np, fa, fed)
        dist["phase_s"] = time.perf_counter() - t0
        collective = _child_finish(coll_a, coll_a_work, COLL_WAIT_S + 300)
        mesh = _child_finish(mesh_child, mesh_work, MESH_WAIT_S)
    finally:
        shutil.rmtree(coll_a_work, ignore_errors=True)
        shutil.rmtree(mesh_work, ignore_errors=True)
    log(f"distributed phase: {dist['phase_s']:.1f} s (tcp {dist['tcp_s']:.1f} s, "
        f"comparator + faults + --multiprocess {dist['checks_s']:.1f} s); beside it in "
        f"children: collective phase (a), (e) {collective['phase_s']:.1f} s, mesh phase "
        f"{mesh['phase_s']:.1f} s; together {time.perf_counter() - t0:.1f} s")

    cfg = serve_config()
    params = init_params(cfg.model, seed=0, device="cuda")
    engine = engine_phase(torch, rpa, np, params, cfg)
    t0 = time.perf_counter()
    spec_prefix = spec_prefix_phase(torch, rpa, np, params, cfg,
                                    tie=2 * engine["max_abs_logit_diff"])
    spec_prefix["phase_s"] = time.perf_counter() - t0
    log(f"spec_prefix phase: {spec_prefix['phase_s']:.1f} s")
    profile = profile_phase(torch, np, params, cfg)
    t0 = time.perf_counter()
    decode_rec = decode_phase(torch, np, fa, params, cfg)
    decode_rec["phase_s"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    server = server_phase(torch, np, cfg, cfg.model.n_layers, fed)
    t0 = time.perf_counter()
    evaluation = eval_phase(torch, train_config(), fed)
    evaluation["phase_s"] = time.perf_counter() - t0
    log("eval_phase " + json.dumps({k: v for k, v in evaluation.items() if k != "result"}))
    log(f"eval phase: {evaluation['phase_s']:.1f} s (convert {evaluation['convert']['wall_s']:.1f}"
        f" s, eval CLI {evaluation['cli_wall_s']:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in evaluation["timed_s"].items()) + ")")
    t0 = time.perf_counter()
    adapters = adapter_phase(torch, rpa, fa, np, fed, train, tie=2 * engine["max_abs_logit_diff"])
    adapters["phase_s"] = time.perf_counter() - t0
    log(f"adapter phase: {adapters['phase_s']:.1f} s")
    fleet_source = adapters.pop("fleet_source")
    ap_work = ROOT / ".chip_smoke" / "autopilot_child"
    coll_work = ROOT / ".chip_smoke" / "collective_child"
    try:
        fleet = fleet_phase(torch, rpa, np, fleet_source, tie=2 * engine["max_abs_logit_diff"])
        log(f"fleet phase: {fleet['phase_s']:.1f} s")
        # phase 17 (a)-(c), (e) in this process on the fed run's round
        autopilot = autopilot_phase(torch, rpa, np, fed, tie=2 * engine["max_abs_logit_diff"])
        log(f"autopilot phase (a)-(c), (e): {autopilot['phase_s']:.1f} s")
        shutil.rmtree(ROOT / ".chip_smoke" / "fed", ignore_errors=True)
        # phase 18 (c), (d) in a child beside 14-16 (its own launch counters;
        # its gates count bits and launches, and time a crash from its marker)
        coll_leg = _collective_leg_start(coll_work)
        t0 = time.perf_counter()
        # 17 (d), the router's restart leg, in a child of its own (the
        # router's autopilot is process-global) beside 14-16, on phase 13's
        # round: its gates count launches and restarts, not seconds
        ap_fleet = _autopilot_fleet_start(dict(fleet_source, device="cuda"), ap_work)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            # phase 14 beside phases 15 and 16, whose work is in their
            # children: they share no launch counter (15's and 16's are the
            # children's; 16's in-process decode passes wait for 14), no
            # file and no port, and 14's gates do not depend on time. 16
            # starts once 15 ended: 15's seeded faults land on a ping only
            # while its frames keep their order, which a ping answered late
            # could change
            interop_run = pool.submit(interop_phase, torch, rpa, np)
            chaos_rec = chaos_phase(torch, np, fa)
            tel = telemetry_phase(np)
            interop = interop_run.result()
        autopilot["fleet"] = _autopilot_fleet_finish(ap_fleet, ap_work)
        collective["leg"] = _collective_leg_finish(coll_leg, coll_work)
    finally:
        shutil.rmtree(ROOT / ".chip_smoke" / "adapters", ignore_errors=True)
        shutil.rmtree(ap_work, ignore_errors=True)
        shutil.rmtree(coll_work, ignore_errors=True)
    # phase 18 (b) and (c) across processes, one pair on a quiet card
    collective["pair"] = collective_pair(np)
    collective["phase_s_with_leg"] = (collective["phase_s"] + collective["leg"]["phase_s"]
                                      + collective["pair"]["phase_s"])
    autopilot["phase_s_with_fleet"] = autopilot["phase_s"] + autopilot["fleet"]["phase_s"]
    log(f"interop phase: {interop['phase_s']:.1f} s, chaos phase: {chaos_rec['phase_s']:.1f} s, "
        f"telemetry phase: {tel['phase_s']:.1f} s (traced run {tel['fed']['phase_s']:.1f} s, "
        f"serve {tel['serve']['phase_s']:.1f} s), autopilot (d) "
        f"{autopilot['fleet']['phase_s']:.1f} s, side by side {time.perf_counter() - t0:.1f} s")
    log(f"autopilot phase: {autopilot['phase_s_with_fleet']:.1f} s")
    log(f"collective phase: (a), (e) {collective['phase_s']:.1f} s in a child beside 5b, "
        f"(c), (d) in process {collective['leg']['phase_s']:.1f} s in a child beside 14-16, "
        f"(b) and (c) across processes {collective['pair']['phase_s']:.1f} s after them")

    kernels = {"kernels": [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "photon_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "replaces": "photon_tpu/ops/ragged_paged_attention.py:126",
        "launches": server["launches"],
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shapes": main["shapes"],
        "engine_phase_launches": engine["launches"],
        "spec_prefix_launches": spec_prefix["launches"],
        "moe_engine_launches": moe_engine["launches"],
        "adapter_engine_launches": adapters["engine_pair"]["launches"],
        "adapter_server_launches": adapters["server"]["launches"],
        "fleet_replica_launches": fleet["replica_launches"],
        "interop_engine_launches": interop["serve"]["launches"],
        "telemetry_serve_launches": tel["serve"]["launches"],
        "autopilot_launches": autopilot["launches"],
        "autopilot_fleet_replica_launches": autopilot["fleet"]["launches"],
        # the verify regime (rpa_verify_kernel + rpa_combine_kernel) at the
        # speculative verify shapes, and its launches on the spec_prefix paths
        "verify_regime": [{
            "case": r["case"], "shape": f"B={r['B']} T={r['T']} H={r['H']}/{r['H_kv']} "
                                        f"Dh={r['Dh']} n_ctx={r['n_ctx']} bs={r['block_size']} bf16",
            "device_kernels": r["device_kernels"], "max_abs_err": r["max_abs_err"],
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        } for r in kernel_records if r["dtype"] == "bfloat16" and r["case"] in K4_VERIFY_CASES],
        "verify_regime_launches": {
            "verify_grid_125m": spec_prefix["verify_125m"]["launches_verify_regime"],
            "verify_grid_llama1b": spec_prefix["verify_llama1b"]["launches_verify_regime"],
            "speculative_batcher": spec_prefix["launches"]["speculative_by_regime"]["verify"]},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "photon_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": FLASH_KERNELS[name][0],
        "launches": fed["runs"][0]["launches"][name],
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
        "shapes": [rec["shape"]],
        "train_phase_launches": train["launches"][name],
        "entry_phase_launches": entry["runs"][0]["launches"][name],
        "federated_resume_launches": fed["runs"][1]["launches"][name],
        "tcp_node_launches": dist["tcp"]["launches"][name],
        "eval_phase_launches": evaluation["launches"][name],
        "presets_phase_launches": {p: r["launches"][name] for p, r in presets.items()},
        "adapter_round_launches": adapters["fit"]["launches"][name],
        "chaos_node0_launches": chaos_rec["launches"][name],
        "telemetry_node0_launches": tel["fed"]["launches"][name],
        "collective_round_launches": collective["launches"][name],
        "mesh_phase_launches": {leg: mesh["launches"][leg][name] for leg in MESH_LEGS},
    } for name, rec in flash_main.items()]}
    k1 = next(k for k in kernels["kernels"] if k["name"] == "flash_fwd")
    k1["eval_shape"] = flash_eval
    k1["shapes"].append(flash_eval["shape"])
    k1["ring_chunks"] = mesh["chunks"]
    k1["shapes"] += [f"ring chunk {c['chunk']} (offset {c['offset']}): {c['shape']}"
                     for c in mesh["chunks"]]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "env": env, "kernel_build": built, "kernel_cases": kernel_records, "flash_cases": flash_records,
        "train": train, "entry": entry, "federated": fed, "distributed": dist, "engine": engine,
        "spec_prefix": spec_prefix, "profile": profile,
        "server": server, "decode": decode_rec, "eval": evaluation, "presets": presets,
        "presets_phase_s": presets_s, "d128_grad_gate": d128, "moe_dispatch": moe_dispatch,
        "moe_engine": moe_engine, "adapters": adapters, "fleet": fleet, "interop": interop,
        "chaos": chaos_rec, "telemetry": tel, "autopilot": autopilot, "collective": collective,
        "mesh": mesh, "native": native_rec,
        "kernels": kernels["kernels"],
        "profiler_pad_lost": profiler_pad_lost,
        "total_s": time.perf_counter() - t_all,
    }, indent=1))
    log(f"profiler windows {len(profiler_pad_lost)}, pad records lost in each (of "
        f"{PROFILER_PAD}): {profiler_pad_lost}")
    log(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
