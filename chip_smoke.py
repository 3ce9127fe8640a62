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
   fp32 and bf16, at the shapes the serving step (K4) and the training
   step (K1 forward, K2 dQ, K3 dK/dV) give it; times of the kernel, the
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
7. server: the round checkpoint the federated phase wrote (round 3),
   served by ``python -m photon_tpu_torch.serve`` on an ephemeral port; 8
   concurrent ``/generate`` requests (one streaming, one split into chunks
   by the prefill budget), a repeated greedy prompt, ``/healthz``, then
   SIGTERM and a clean exit. The server's own launch count (read on
   ``/healthz``) must equal ``n_layers`` × (steps + chunk steps).

Between 6 and 7, a ``torch.profiler`` window over steady decode steps
reports the step's wall time, the device's busy time by kernel and its
idle share (1 - busy / the unprofiled step's wall time).

The second-last line of stdout is the ``kernels`` JSON; the last is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this file, it exits non-zero and prints no result. Measurements
also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
import http.client
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:90] for e in prof.key_averages()
                   if (getattr(e, "self_device_time_total", 0.0) or 0.0) > 0})


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
        ("llama1b_decode", (22, 16, 4, 128), 8, 1,
         np.array([[2047], [1900], [1500], [1100], [900], [512], [256], [31]]), False, False),
        ("llama1b_chunk", (22, 16, 4, 128), 1, 512,
         np.arange(512, 1024)[None, :], False, False),
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
            names = _kernel_names(torch, lambda: rpa.ragged_paged_attention(
                q, kp, vp, layer, rows, pos, slopes=slopes))
            want = {"split": ("rpa_split_kernel", "rpa_combine_kernel"),
                    "chunk": ("rpa_chunk_kernel",)}[regime]
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
    """K1–K3 against their plain versions at the training step's shapes;
    returns the per-case records and the main-path entry of each kernel."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    cases = [
        # name, B, S, H, H_kv, D, alibi, main path
        ("mpt125m_train", 16, 2048, 12, 12, 64, False, True),
        ("llama1b_train", 4, 2048, 16, 4, 128, False, False),
        ("mpt125m_alibi", 4, 1024, 12, 12, 64, True, False),
        ("ragged_s1000", 2, 1000, 12, 12, 64, False, False),
    ]
    records, main = [], {}
    for name, b, s, h, n_kv, d, alibi, on_path in cases:
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
            delta = fa.attention_delta(o_ref, do)
            dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, **kw)
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **kw)
            torch.cuda.synchronize()
            dq_ref = fa.flash_bwd_dq_reference(q, k, v, do, lse_ref, delta, **kw)
            dk_ref, dv_ref = fa.flash_bwd_dkv_reference(q, k, v, do, lse_ref, delta, **kw)
            errs = {
                "flash_fwd": [(o, o_ref), (lse, lse_ref)],
                "flash_bwd_dq": [(dq, dq_ref)],
                "flash_bwd_dkv": [(dk, dk_ref), (dv, dv_ref)],
            }
            rec = {"case": name, "dtype": dname, "B": b, "S": s, "H": h, "H_kv": n_kv, "D": d,
                   "alibi": alibi, "causal": True}
            for kname, pairs in errs.items():
                gate = (FLASH_FWD_GATE if kname == "flash_fwd" else FLASH_BWD_GATE)[dname]
                rel = max(_rel_l2(x.float(), r.float()) for x, r in pairs)
                max_abs = max(float((x.float() - r.float()).abs().max()) for x, r in pairs)
                finite = all(bool(torch.isfinite(x).all()) for x, _ in pairs)
                if not finite or rel > gate:
                    fail(f"{kname} {name} {dname}: rel L2 {rel:.3e} > {gate}")
                rec[kname] = {"rel_l2": rel, "max_abs_err": max_abs, "gate": gate}
            del errs, o_ref, lse_ref, dq_ref, dk_ref, dv_ref
            if dtype == torch.bfloat16:
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
                    if on_path:
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
    return records, main


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
    saved = dict(fa.launches)
    ref_cfg = copy.deepcopy(cfg)
    ref_cfg.model.attn_impl, ref_cfg.model.remat = "xla", True  # dense scores: recompute per block
    ref = _grads_of(torch, ref_cfg, params, tokens)
    sound = _grads_of(torch, cfg, params, tokens)
    sound_attn = fa.flash_attention
    fa.flash_attention = _shifted_offset_fault(fa)
    try:
        faulty = _grads_of(torch, cfg, params, tokens)
    finally:
        fa.flash_attention = sound_attn
    for key in fa.launches:  # the comparisons are not the main path
        fa.launches[key] = saved[key]

    def compare(run):
        loss_d = abs(run[0] - ref[0]) / abs(ref[0])
        norm_d = abs(run[1] - ref[1]) / abs(ref[1])
        per = {n: _rel_l2(run[2][n], ref[2][n]) for n in ref[2]}
        return {"loss_rel_diff": loss_d, "grad_norm_rel_diff": norm_d,
                "max_param_grad_rel_l2": max(per.values()), "param_grad_rel_l2": per}

    cmp_sound, cmp_fault = compare(sound), compare(faulty)
    worst = lambda c: max(c["loss_rel_diff"], c["grad_norm_rel_diff"],  # noqa: E731
                          c["max_param_grad_rel_l2"])
    rec["vs_plain"] = {"gate": TRAIN_GRAD_GATE, "sound": cmp_sound, "planted_fault": cmp_fault,
                       "loss_kernel": sound[0], "loss_plain": ref[0], "loss_fault": faulty[0]}
    log("train_vs_plain " + json.dumps(rec["vs_plain"]))
    if worst(cmp_sound) > TRAIN_GRAD_GATE:
        fail(f"kernel vs plain training step: {worst(cmp_sound):.3e} > {TRAIN_GRAD_GATE}")
    if worst(cmp_fault) <= TRAIN_GRAD_GATE:
        fail(f"the training gate {TRAIN_GRAD_GATE} misses a causal offset shifted by one tile "
             f"(reading {worst(cmp_fault):.3e})")
    del params, ref, sound, faulty, tokens
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
        trainer.fit = sound_fit
        before = dict(fa.launches)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = sound_fit(batches, steps, **kw)
        counted["counter_launches_per_step"] = {
            k: (fa.launches[k] - before[k]) / steps for k in before}
        per = {k: sum(e.count for e in prof.key_averages()
                      if str(getattr(e, "device_type", "")).endswith("CUDA")
                      and tag in e.key) / steps for k, (_, tag) in FLASH_KERNELS.items()}
        counted["profiler_launches_per_step"] = per if any(per.values()) else "not measured"
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
    if gate["counter_launches_per_step"] != {k: per_step for k in FLASH_KERNELS}:
        fail(f"a client fit launched {gate['counter_launches_per_step']} per step, "
             f"want {per_step} each")
    prof = gate["profiler_launches_per_step"]
    if prof != "not measured" and prof != {k: per_step for k in FLASH_KERNELS}:
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
    Returns (relative L2, rows whose tokens were held equal)."""
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
    return rel, int(clear.sum())


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
    sound_rels, fault_rels = [], []
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
            rel, n_checked = _compare_logits(torch, np, eng_r, eng_g, emitted, vocab, steps)
            sound_rels.append(rel)
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


def server_phase(torch, np, cfg, n_layers, fed):
    """Serve the round checkpoint the federated phase wrote (its latest
    round, with the nesterov momentum beside the params, which serving
    does not read)."""
    work = ROOT / ".chip_smoke" / "serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg.run_uuid = fed["run_uuid"]
    cfg.photon.serve.attention_impl = "auto"
    cfg.to_yaml(work / "resolved.yaml")
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch.serve", "--config", str(work / "resolved.yaml"),
         "--store", fed["store"], "--enable", "--port", "0"],
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
        if info["round"] != fed["served_round"]:
            fail(f"server loaded round {info['round']}, want the federated phase's "
                 f"{fed['served_round']}")
        _, h0 = _request(port, "/healthz")
        if json.loads(h0)["kernel_launches"]["ragged_paged_attention"] != 0:
            fail("server launched the kernel before any request")
        rng = np.random.default_rng(2)
        vocab = cfg.model.vocab_size
        lengths = [16, 100, 250, 400, 600, 800, 1100, 1500]
        prompts = [list(map(int, rng.integers(0, vocab, n))) for n in lengths]
        max_new = 32
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            futs = [pool.submit(_generate, port, p, max_new, i == 2) for i, p in enumerate(prompts)]
            replies = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        for n, (status, rep) in zip(lengths, replies):
            if status != 200 or rep is None or rep["n_generated"] != max_new \
                    or len(rep["tokens"]) != max_new or rep["n_prompt"] != n:
                fail(f"prompt of {n}: status {status}, reply {rep}")
        again = [_generate(port, prompts[3], max_new)[1] for _ in range(2)]
        if again[0] is None or again[1] is None or again[0]["tokens"] != again[1]["tokens"]:
            fail("a repeated greedy prompt returned different tokens")
        _, hz = _request(port, "/healthz")
        health = json.loads(hz)
        if health["attn_impl"] != "ragged" or health["status"] != "ok":
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
               "repeat_equals_concurrent": again[0]["tokens"] == replies[3][1]["tokens"],
               "server_steps": st["steps"], "server_chunk_steps": st["chunk_steps"],
               "chunk_split_prompts": st["chunk_split_prompts"], "launches": launches,
               "served": {"run_uuid": fed["run_uuid"], "round": info["round"]}}
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

def main() -> int:
    if sys.argv[1:2] == ["--fed-child"]:  # a child of the federated phase
        return _fed_child(sys.argv[2], sys.argv[4:])
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
    flash_records, flash_main = flash_kernel_phase(torch, fa, alibi_slopes, np)
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
    profile = profile_phase(torch, np, params, cfg)
    del params
    torch.cuda.empty_cache()
    server = server_phase(torch, np, cfg, cfg.model.n_layers, fed)
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
    } for name, rec in flash_main.items()]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "env": env, "kernel_build": built, "kernel_cases": kernel_records, "flash_cases": flash_records,
        "train": train, "entry": entry, "federated": fed, "engine": engine, "profile": profile,
        "server": server,
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
