#!/usr/bin/env python3
"""Drive photon_tpu_torch's serving, training and federated paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. environment: the card's name and power limit, torch/CUDA versions, and
   the build of every kernel from ``photon_tpu_torch/ops/csrc/`` (one
   nvcc per source, all started together, ``sm_90a``); ptxas's registers,
   shared memory and spills per kernel, and the count of ``HGMMA``
   (wgmma), ``UTMALDG`` (TMA loads) and ``LDGSTS`` (cp.async) in each
   kernel's SASS (``cuobjdump``): the bf16 K1, K2 and K3 must each hold
   ``HGMMA`` and ``UTMALDG``; ptxas's notes of wgmma it had to serialize;
2. kernels: each kernel against its plain PyTorch version on the card,
   fp32 and bf16, at the shapes the serving step (K4: decode, chunk and
   speculative verify) and the training step (K1 forward, K2 dQ, K3
   dK/dV) give it; times of the kernel, the
   plain version and one PyTorch library call, and the least time the
   card could take (bytes over 3.35 TB/s, flops over the peak for the
   dtype); K2, K3 and K4 give the same bits twice; K4's decode must run
   as a split-K kernel and its merge (kernel names from
   ``torch.profiler``); K2 + K3 together against SDPA's backward;
3. training: full-width mpt-125m (random weights from seed 0, bf16
   compute, fp32 masters, ADOPT, chunked CE) in a ``Trainer`` on
   ``cuda``, global batch 32 in 2 microbatches of 16 at seq 2048: 4 steps
   on one repeated batch (step 0 applies no update, then the loss falls),
   K1/K2/K3 launched exactly ``n_layers x n_micro`` times per step,
   tokens/s, MFU, step time, peak memory and a ``torch.profiler`` step;
   one step's loss, grad norm and per-parameter gradients agree with the
   plain dense attention (``attn_impl: xla``), and a planted fault (the
   kernels' causal offset shifted by one tile, patched in from outside
   the package) must break that gate;
4. entry point: ``photon_tpu_torch.centralized.main`` in process, 3 steps
   on synthetic data at full width, then again to step 5, resuming from
   its checkpoint;
5. federated round: ``python -m photon_tpu_torch.federated`` (its
   ``main`` in a child process; 2 nodes in it share the card) on the same
   config, 2 rounds of 2 clients × 4 local steps with the preset's
   nesterov strategy, the shm plane (in a directory of this run's own,
   removed after) and checkpoints, eval at rounds 0 and 2; then a resume
   to round 3. The first run must evaluate to a finite loss, each round
   must read a positive pseudo-gradient norm, the resume must train round
   3 alone, and K1–K3 must launch exactly the counts the rounds imply.
   Per round, from the run's History: the broadcast, per client
   set_parameters / train loop / get_parameters / put, the fold, the
   server update, eval, the checkpoint, and the share of the round in
   which the card trains. In process: one client fit under
   ``torch.profiler`` (K1, K2, K3 each ``n_layers x n_micro`` per step),
   and one client under FedAvg (η = 1) for 2 rounds × 3 steps against a
   ``Trainer`` that ran 6 steps on the same stream; a planted fault (the
   cumulative step never injected, 2 rounds × 1 step against the
   Trainer's step 2) must read at least 10× the sound gap;
5b. federated rounds across processes, beside phase 5's run: (a)
   ``--multiprocess --nodes 2`` on phase 5's config (2 rounds; each node a
   spawned process with its own CUDA context on the one card, the objstore
   plane): round-2 parameters and the eval losses at rounds 0 and 2 within
   ``FED_GATE`` of phase 5's first run, no CUDA context in the server
   process (``nvidia-smi --query-compute-apps`` counts the card's
   contexts); the round breakdown, each node's own peak memory and the
   card's; a planted fault (a spawned node that seeds its synthetic data
   with Python's per-process ``hash``) must part the round-0 eval loss
   over the gate. (b) ``--tcp-listen`` (a child
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
   layers: K4's chunk regime at B = 8); a wrapper that gives every query
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
   photon_tpu_torch.eval`` (each CLI's ``main`` in process, the eval
   under ``torch.profiler``) on the federated round with ``--dataset`` on
   that set and the v0.3 gauntlet at ``EVAL_MAX_ROWS`` rows a task: a
   finite val loss, every score in [0, 1], and K1 launched ``n_layers``
   times a forward pass. Phase 2 also holds K1 alone at the eval forward's shape
   (B=16, S=512) to its plain version.

Right after phase 2 (on a card nothing else holds yet):

10. presets: ``photon_tpu_torch.centralized.main`` in process for mpt-350m,
    mpt-760m, mpt-1b, llama-1b, mpt-3b and mpt-125m-moe8 at full width and
    depth (random weights, synthetic data, 3 steps, no checkpoint; global
    batch 2 × the preset's microbatch, mpt-3b ``device_microbatch_size:
    auto`` over 8): step wall, tokens/s, MFU, peak memory, ``auto``'s
    choice; K1–K3 launch counts exact (K1 twice per layer per microbatch
    under remat); the step-0 loss near ln(vocab). Then the training gate of
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
#: engine phase: per-step relative L2 between the ragged and gather
#: engines' logits (bf16 activations through 12 layers). On an H100 the
#: sound engines read at most 1.2e-2 and an engine that drops each row's
#: last key block reads up to 1.9e-1; the gate sits ~3x from each.
ENGINE_LOGIT_GATE = 4e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ---------------------------------------------------------------------------
# phase 1: what the build made
# ---------------------------------------------------------------------------

SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS")  # wgmma, TMA loads, cp.async
#: the bf16 flash kernels (K1, K2, K3), each of which must be built from
#: wgmma and TMA loads
WGMMA_KERNELS = ("fwd_wgmma_kernel", "bwd_dq_wgmma_kernel", "bwd_dkv_wgmma_kernel")


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


@contextlib.contextmanager
def _profiled(torch):
    """``torch.profiler`` over the block, CPU + CUDA (with CUDA alone it can
    lose whole buffers of device records), the card idle for
    ``PROFILER_MARGIN_S`` at both ends of the window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_MARGIN_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILER_MARGIN_S)


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
        # GQA 16/4 at n_spec 4: 16 rows a (slot, kv head), the bf16 chunk regime at B = 8
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
            rec = {"case": name, "dtype": dname, "B": b, "T": t, "H": h, "H_kv": n_kv,
                   "Dh": d, "n_ctx": n_ctx, "block_size": bs, "rel_l2": rel,
                   "max_abs_err": max_abs, "gate": KERNEL_GATE[dname], "regime": regime,
                   "n_split": rpa.split_plan(n_ctx * bs)[0] if regime == "split" else None}
            again = rpa.ragged_paged_attention(q, kp, vp, layer, rows, pos, slopes=slopes)
            if not torch.equal(out, again):
                fail(f"kernel {name} {dname}: two launches gave different bits")
            rec["same_bits_twice"] = True
            want = {"split": ("rpa_split_kernel", "rpa_combine_kernel"),
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
        return fa.FlashAttention.apply(q, k, v, None, causal, k.shape[1] - q.shape[1] - 64, None)

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
    del params, tokens
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 4: the training entry point
# ---------------------------------------------------------------------------

def entry_phase(torch, fa):
    """``python -m photon_tpu_torch.centralized`` in process at full width:
    3 steps with a checkpoint per step, then a second run to step 5 that
    must resume from step 3 (params, optimizer state, loader position)."""
    import contextlib
    import io

    from photon_tpu_torch import centralized
    from photon_tpu_torch.checkpoint import ClientCheckpointManager, FileStore

    work = ROOT / ".chip_smoke" / "central"
    shutil.rmtree(work, ignore_errors=True)
    cfg = train_config()
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


def _fed_child(out_path: str, cli_args: list[str], opts: list[str] = ()) -> int:
    """``python -m photon_tpu_torch.federated`` (its ``main``) in a child
    process of :func:`federated_phase` or :func:`distributed_phase`, the
    kernels' launch counts set to 0 just before it; writes the run's
    History, the counts, whether this process initialized CUDA, and its
    peak device memory to ``out_path``. With ``--measured-nodes`` in
    ``opts`` the nodes it spawns run :func:`_measured_node_main`; with
    ``--record-decodes`` the server writes node0's first decoded result of
    each round to ``$PHOTON_SMOKE_DECODES/<tag>.npy`` (:func:`_record_decodes`)."""
    import torch

    sys.path.insert(0, str(ROOT))
    from photon_tpu_torch import federated
    from photon_tpu_torch.ops import flash_attention as fa

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
    pathlib.Path(out_path).write_text(json.dumps({
        "history": history.to_dict(), "launches": dict(fa.launches),
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
            "child_wall_s": child["wall_s"], "cuda_initialized": child["cuda_initialized"],
            "max_memory_allocated_gb": child["max_memory_allocated_gb"]}


def _fed_cli_run(work: pathlib.Path, tag: str, args: list[str], shm_dir: str) -> dict:
    return _fed_cli_finish(work, tag, _fed_cli_start(work, tag, args, shm_dir))


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
        # the profiler can lose device records (see eval_phase): a reading
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

    (a) ``python -m photon_tpu_torch.federated`` (a child process, 2
        in-process nodes sharing the card, the preset's nesterov strategy,
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
    (c) + (d): :func:`_fed_gate`."""
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
    try:
        base = ["--config", str(work / "in.yaml"), "--device", "cuda", "--nodes", "2"]
        for s in FED_SETS:
            base += ["--set", s]
        first = _fed_cli_run(work, "rounds-1-2", base + ["--rounds", "2"], shm_dir)
        second = _fed_cli_run(work, "resume-to-3", base + ["--rounds", "3", "--set",
                                                            "photon.resume_round=-1"], shm_dir)
        left = sorted(p.name for p in pathlib.Path(shm_dir).iterdir())
    finally:
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

    # (c) + (d): one client in process against centralized training
    init = init_params(cfg.model, seed=0, device="cuda")
    initial = params_to_ndarrays(init)
    del init
    t0 = time.perf_counter()
    gate = _fed_gate(torch, np, cfg, work / "gate", initial)
    gate["wall_s"] = time.perf_counter() - t0
    log("fed_gate " + json.dumps(gate))
    per_step = L * n_micro
    want = {k: per_step for k in FLASH_KERNELS}
    if any(c != want for c in gate["counter_launches_per_step"]):
        fail(f"a client fit launched {gate['counter_launches_per_step']} per step, "
             f"want {per_step} each")
    prof = gate["profiler_launches_per_step"]
    if any(p != "not measured" and any(p[k] > per_step for k in p) for p in prof) \
            or prof[-1] not in ("not measured", want):
        fail(f"the profiler saw {prof} kernel launches per step, want {per_step} each (least "
             f"launch-to-kernel µs {gate['profiler_min_launch_to_kernel_us']})")
    if not gate["sound"] <= FED_GATE:
        fail(f"single-client FedAvg vs centralized: {gate['sound']:.3e} > {FED_GATE}")
    if not gate["planted_fault"] >= max(FED_FAULT_RATIO * gate["sound"], FED_GATE):
        fail(f"the planted set_step fault reads {gate['planted_fault']:.3e}, not "
             f"{FED_FAULT_RATIO}x the sound {gate['sound']:.3e} and over the gate {FED_GATE}")
    rec = {"shm_dir": shm_dir, "dev_shm_free_gb": free / 1e9, "payload_gb": payload / 1e9,
           "runs": [first, second], "gate": gate,
           "store": str(work / "store"), "run_uuid": FED_RUN, "served_round": 3}
    log("federated_phase " + json.dumps({k: v for k, v in rec.items() if k != "runs"}))
    return rec


# ---------------------------------------------------------------------------
# phase 5b: federated rounds across processes
# ---------------------------------------------------------------------------

TCP_RUN = "chip-smoke-tcp"
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
KILL_AFTER_S = 1.0
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


def _multiprocess(np, work, fed, base) -> dict:
    """(a): ``--multiprocess --nodes 2`` on phase 5's config for 2 rounds;
    the card's contexts and memory sampled, each node's own peak reported."""
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager

    reports = work / "mp-nodes"
    reports.mkdir()
    with _GpuMemory() as mem:
        run = _fed_cli_finish(work, "multiprocess", _fed_cli_start(
            work, "multiprocess", base + ["--multiprocess", "--rounds", "2",
                                          "--set", f"photon.save_path={work / 'mp'}"],
            opts=("--measured-nodes",), env={"PHOTON_SMOKE_NODE_REPORT": str(reports)}))
    run["rounds"] = _round_breakdown(run["history"], [1, 2])
    # contexts: this process, then the two nodes; the server would be one more
    run["card"] = mem.record()
    run["nodes_memory"] = [json.loads(f.read_text()) for f in sorted(reports.iterdir())]
    ref = fed["runs"][0]["history"]["server/eval_loss"]
    got = run["history"].get("server/eval_loss", [])
    want = ServerCheckpointManager(FileStore(fed["store"]), FED_RUN).load_round_params(2)[1]
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
    """Phase 5b, on phase 5's config and beside its in-process run:

    (a) ``python -m photon_tpu_torch.federated --multiprocess --nodes 2``
        (a child; each node a spawned process with its own CUDA context on
        the one card) for 2 rounds: round-2 parameters and the eval losses
        at rounds 0 and 2 within ``FED_GATE`` of phase 5's first run (the
        same bits expected), no CUDA context in the server (the card's
        contexts counted); the round breakdown, each node's own peak
        memory and the card's; a planted fault (a spawned node that seeds
        its synthetic data with Python's per-process ``hash``, patched in
        from outside; one node, round 0 only) must part the round-0 eval
        loss over the gate;
    (b) ``--tcp-listen`` (a child that opens no CUDA context) with
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
    t0 = time.perf_counter()
    rec["multiprocess"] = _multiprocess(np, work, fed, base)
    rec["multiprocess_s"] = time.perf_counter() - t0
    log("dist_multiprocess " + json.dumps({k: v for k, v in rec["multiprocess"].items()
                                           if k != "history"}))

    cfg = train_config()
    for s in FED_SETS:
        _apply_override(cfg, *s.split("=", 1))
    cfg.run_uuid, cfg.photon.save_path = TCP_RUN, str(work / "tcp")
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
                                     "multiprocess_fault": rec["multiprocess"]["planted_fault"],
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
    rec["multiprocess"]["planted_fault"] = mp_fault_rec
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
    difference; K4 launched ``n_layers`` times for the verify and 4 ×
    ``n_layers`` for the steps. Then the verify again with
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
    rpa.launches = 0
    grid = run(eng.state.clone(), toks, 0, n_spec).float()
    torch.cuda.synchronize()
    grid_launches = rpa.launches
    if seq_launches != n_spec * L or grid_launches != L:
        fail(f"{tag} verify grid: K4 launched {grid_launches} (want {L}) and the steps "
             f"{seq_launches} (want {n_spec * L})")
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
           "regime": rpa.regime(n_spec, c.model.n_heads // c.model.kv_heads,
                                eng.state.cache_k.dtype),
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
    t0 = time.perf_counter()
    b.start()
    outs = [r.result(timeout=600) for r in reqs]
    wall = time.perf_counter() - t0
    launches = rpa.launches
    b.close()
    st = b.stats()
    want = eng.mc.n_layers * int(st["steps"] + st["chunk_steps"])
    if launches != want or launches == 0:
        fail(f"batcher pass launched K4 {launches} times, want {want}")
    if any(len(o) != SPEC_NEW for o in outs) or eng.n_active:
        fail(f"batcher pass: lengths {[len(o) for o in outs]}, {eng.n_active} slots left")
    ttft = [r.ttft_s for r in reqs]
    return {"outs": outs, "wall_s": wall, "tokens_per_s": len(prompts) * SPEC_NEW / wall,
            "launches": launches, "steps": st["steps"], "chunk_steps": st["chunk_steps"],
            "mean_ttft_s": sum(ttft) / len(ttft),
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
    D=128, 2 layers: the B = 8 chunk regime), each with its planted fault;
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
                       "prefix": cold["launches"] + warm["launches"]}
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
        0 just before it and under ``torch.profiler``: a finite val loss,
        every accuracy and gauntlet score in [0, 1], and K1 launched
        ``n_layers`` times per forward pass of the eval, by the counters
        and by the profiler (a profiler count short of the counters is
        read again on a second counted run). The checkpoint load, the
        ``Trainer``, the val loss and the gauntlet are timed (wrappers
        patched in from outside the package)."""
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

    def counted_run():
        times.clear()
        for key in fa.launches:  # the counted run starts here
            fa.launches[key] = 0
        torch.cuda.reset_peak_memory_stats()
        with _profiled(torch) as prof:
            t0 = time.perf_counter()
            out, line = _run_cli(eval_cli.main, args)
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
        launches = dict(fa.launches)
        if launches != want:
            fail(f"the eval launched {launches}, want {want} ({n_fwd} forwards)")
        events = [e for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                  and (getattr(e, "self_device_time_total", 0.0) or 0.0) > 0]
        k1 = sum(e.count for e in events if "::fwd_" in e.key) if events else "not measured"
        skews.append(_launch_to_kernel_us(prof))
        if k1 != "not measured" and k1 > L * n_fwd:
            fail(f"the profiler saw {k1} K1 launches, more than the {L * n_fwd} counted")
        return out, line, cli_s, launches, events, k1

    skews: list[float | None] = []
    try:
        out, line, cli_s, launches, events, profiler_k1 = counted_run()
        # Should device records still be lost, a count that falls short is
        # read again on another counted run: a launch the counter makes up
        # repeats, a lost record does not.
        profiler_k1_runs = [profiler_k1]
        while profiler_k1 not in ("not measured", L * n_fwd) \
                and len(profiler_k1_runs) < PROFILER_READINGS:
            out, line, cli_s, launches, events, profiler_k1 = counted_run()
            profiler_k1_runs.append(profiler_k1)
    finally:
        for obj, name, fn in sound:
            setattr(obj, name, fn)
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
    if profiler_k1 not in ("not measured", L * n_fwd):
        fail(f"the profiler saw {profiler_k1_runs} K1 launches, want {L * n_fwd} (least "
             f"launch-to-kernel µs {skews})")
    rec = {"convert": dict(summary, client_samples=sizes, wall_s=convert_s),
           "forwards": forwards, "launches": launches, "profiler_k1": profiler_k1,
           "profiler_k1_runs": profiler_k1_runs, "profiler_min_launch_to_kernel_us": skews,
           "profiler_k1_ms": sum(e.self_device_time_total for e in events
                                 if "::fwd_" in e.key) / 1e3,
           "cli_wall_s": cli_s, "timed_s": times,
           "device_busy_ms": (sum(e.self_device_time_total for e in events) / 1e3
                              if events else "not measured"),
           "top_kernels_ms": sorted(([e.key[:80], e.self_device_time_total / 1e3, e.count]
                                     for e in events), key=lambda r: -r[1])[:8],
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "eval_loss": out["eval/loss"], "eval_tokens": out["eval/tokens"],
           "gauntlet_average": out.get("gauntlet/average"),
           "icl_max_rows": EVAL_MAX_ROWS, "eval_batches": EVAL_BATCHES, "result": out}
    del events
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 10: every preset that one card trains
# ---------------------------------------------------------------------------

#: the JAX package's presets that one H100 trains at full width and depth
#: (mpt-7b's fp32 weights, gradients and AdamW moments need ~107 GB)
PRESETS = ("mpt-350m", "mpt-760m", "mpt-1b", "llama-1b", "mpt-3b", "mpt-125m-moe8")
MOE_PRESET = "mpt-125m-moe8"
PRESET_STEPS = 3
#: random weights (std 0.02) give near-uniform logits: the step-0 loss
#: sits near ln(vocab), plus the MoE aux (~0.01 a layer)
LOSS_LN_VOCAB_TOL = 1.5


def preset_config(name: str):
    """The preset at full width and depth: synthetic data, no checkpoint
    (a 3B one writes ~32 GB; resume is gated at 125M), one eval batch, and
    the global batch cut for time to 2 microbatches of the preset's own;
    mpt-3b runs ``device_microbatch_size: auto`` over a global batch of 8."""
    from photon_tpu_torch.config import load_preset

    cfg = load_preset(name)
    cfg.run_uuid = f"chip-smoke-{name}"
    if name == "mpt-3b":
        cfg.train.global_batch_size, cfg.train.device_microbatch_size = 8, "auto"
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
    preset's trainer is freed before the next. Returns the records and the
    moe8 run's final parameters (``--dump-params``)."""
    import gc

    from photon_tpu_torch import centralized
    from photon_tpu_torch.train.trainer import Trainer
    from photon_tpu_torch.utils.profiling import model_flops_per_token

    work = ROOT / ".chip_smoke" / "presets"
    shutil.rmtree(work, ignore_errors=True)
    sound_probe = Trainer._probe_microbatch
    probes: list[dict] = []

    def counted_probe(self, params):
        before = dict(fa.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        micro = sound_probe(self, params)
        probes.append({"microbatch": micro, "probe_s": time.perf_counter() - t0,
                       "launches": {k: fa.launches[k] - before[k] for k in before}})
        return micro

    records, moe_params = {}, None
    Trainer._probe_microbatch = counted_probe
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
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return records, moe_params


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
    t0 = time.perf_counter()
    sources = ("ragged_paged_attention.cu", "flash_attention.cu")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        list(pool.map(_build.build, sources))
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
    fed = federated_phase(torch, np)
    fed["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dist = distributed_phase(torch, np, fa, fed)
    dist["phase_s"] = time.perf_counter() - t0
    log(f"distributed phase: {dist['phase_s']:.1f} s (multiprocess {dist['multiprocess_s']:.1f}"
        f" s, tcp {dist['tcp_s']:.1f} s, comparator + faults {dist['checks_s']:.1f} s)")

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
    try:
        fleet = fleet_phase(torch, rpa, np, adapters.pop("fleet_source"),
                            tie=2 * engine["max_abs_logit_diff"])
    finally:
        shutil.rmtree(ROOT / ".chip_smoke" / "adapters", ignore_errors=True)
    log(f"fleet phase: {fleet['phase_s']:.1f} s")
    shutil.rmtree(ROOT / ".chip_smoke" / "fed", ignore_errors=True)

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
    } for name, rec in flash_main.items()]}
    k1 = next(k for k in kernels["kernels"] if k["name"] == "flash_fwd")
    k1["eval_shape"] = flash_eval
    k1["shapes"].append(flash_eval["shape"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "env": env, "kernel_build": built, "kernel_cases": kernel_records, "flash_cases": flash_records,
        "train": train, "entry": entry, "federated": fed, "distributed": dist, "engine": engine,
        "spec_prefix": spec_prefix, "profile": profile,
        "server": server, "decode": decode_rec, "eval": evaluation, "presets": presets,
        "presets_phase_s": presets_s, "d128_grad_gate": d128, "moe_dispatch": moe_dispatch,
        "moe_engine": moe_engine, "adapters": adapters, "fleet": fleet,
        "kernels": kernels["kernels"], "total_s": time.perf_counter() - t_all,
    }, indent=1))
    log(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
