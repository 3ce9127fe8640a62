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


def _kernel_names(torch, fn) -> list[str]:
    """The device kernels one call of ``fn`` launches (``torch.profiler``;
    empty if the profiler sees no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # CPU + CUDA: with CUDA alone the profiler can lose device records
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
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

    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_batch(batch)
        torch.cuda.synchronize()
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
        "profiled_step": {
            "device_busy_ms": busy if busy > 0 else "not measured",
            "device_idle_share": (1 - busy / (step_s * 1e3)) if busy > 0 else "not measured",
            "flash_kernel_ms": flash_ms,
            "flash_share_of_busy": (sum(flash_ms.values()) / busy) if busy > 0 else None,
            "kernel_launches": n_launch,
            "top_kernels_ms": [[k[:80], v] for k, v in top],
        },
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


def _fed_child(out_path: str, cli_args: list[str]) -> int:
    """``python -m photon_tpu_torch.federated`` (its ``main``) in a child
    process of :func:`federated_phase`, the kernels' launch counts set to 0
    just before it; writes the run's History, the counts and the peak
    device memory to ``out_path``."""
    import torch

    sys.path.insert(0, str(ROOT))
    from photon_tpu_torch import federated
    from photon_tpu_torch.ops import flash_attention as fa

    for key in fa.launches:
        fa.launches[key] = 0
    t0 = time.perf_counter()
    history = federated.main(cli_args)
    pathlib.Path(out_path).write_text(json.dumps({
        "history": history.to_dict(), "launches": dict(fa.launches),
        "wall_s": time.perf_counter() - t0,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}))
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


def _fed_cli_run(work: pathlib.Path, tag: str, args: list[str], shm_dir: str) -> dict:
    import os

    out_json = work / f"child-{tag}.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--fed-child", str(out_json), "--", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PHOTON_SHM_DIR=shm_dir))
    if proc.returncode != 0:
        fail(f"federated CLI ({tag}) exited {proc.returncode}: {proc.stderr[-3000:]}")
    child = json.loads(out_json.read_text())
    return {"tag": tag, "wall_s": time.perf_counter() - t0,
            "final_line": json.loads(proc.stdout.strip().splitlines()[-1]),
            "history": child["history"], "launches": child["launches"],
            "child_wall_s": child["wall_s"],
            "max_memory_allocated_gb": child["max_memory_allocated_gb"]}


def _fed_gate(torch, np, cfg, work, initial) -> dict:
    """(c) and (d) in process, on one node (one Trainer): one client under
    FedAvg (η = 1, μ = 0) for 2 rounds × 3 local steps, its first fit under
    ``torch.profiler``; then the planted fault on the same node under a
    fresh server, 2 rounds × 1 step, with the node's ``set_step`` pinned to
    0 (patched in from outside the package; the fit knobs rewind its loader
    and optimizer in round 1); and a centralized Trainer on the same
    client stream, read at steps 2 and 6."""
    import copy

    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = sound_fit(batches, steps, **kw)
        counter = {k: (fa.launches[k] - before[k]) / steps for k in before}
        per = {k: sum(e.count for e in prof.key_averages()
                      if str(getattr(e, "device_type", "")).endswith("CUDA")
                      and tag in e.key) / steps for k, (_, tag) in FLASH_KERNELS.items()}
        counted.setdefault("counter_launches_per_step", []).append(counter)
        readings = counted.setdefault("profiler_launches_per_step", [])
        readings.append(per if any(per.values()) else "not measured")
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
        fail(f"the profiler saw {prof} kernel launches per step, want {per_step} each")
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

    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    from torch.profiler import ProfilerActivity, profile

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
        t0 = time.perf_counter()
        # with the CPU activity on too: with CUDA alone the profiler lost
        # whole buffers of device records here (K1 and every other kernel)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
        if k1 != "not measured" and k1 > L * n_fwd:
            fail(f"the profiler saw {k1} K1 launches, more than the {L * n_fwd} counted")
        return out, line, cli_s, launches, events, k1

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
        fail(f"the profiler saw {profiler_k1_runs} K1 launches, want {L * n_fwd}")
    rec = {"convert": dict(summary, client_samples=sizes, wall_s=convert_s),
           "forwards": forwards, "launches": launches, "profiler_k1": profiler_k1,
           "profiler_k1_runs": profiler_k1_runs,
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
    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            moe.moe_mlp(x, lp["router"], **w, **kw)
            torch.cuda.synchronize()
        by_kernel = sorted(((e.key[:80], e.self_device_time_total / 1e3) for e in prof.key_averages()
                            if (getattr(e, "self_device_time_total", 0.0) or 0.0) > 0),
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
    if sys.argv[1:2] == ["--fed-child"]:  # a child of the federated phase
        return _fed_child(sys.argv[2], sys.argv[4:])
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
        "eval_phase_launches": evaluation["launches"][name],
        "presets_phase_launches": {p: r["launches"][name] for p, r in presets.items()},
    } for name, rec in flash_main.items()]}
    k1 = next(k for k in kernels["kernels"] if k["name"] == "flash_fwd")
    k1["eval_shape"] = flash_eval
    k1["shapes"].append(flash_eval["shape"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "env": env, "kernel_build": built, "kernel_cases": kernel_records, "flash_cases": flash_records,
        "train": train, "entry": entry, "federated": fed, "engine": engine,
        "spec_prefix": spec_prefix, "profile": profile,
        "server": server, "decode": decode_rec, "eval": evaluation, "presets": presets,
        "presets_phase_s": presets_s, "d128_grad_gate": d128, "moe_dispatch": moe_dispatch,
        "moe_engine": moe_engine,
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
