"""Runner ``train``: a client's training steps through the port's Trainer.

Set-up builds one ``photon_tpu_torch.train.trainer.Trainer`` over weights
made from the seed, the port's synthetic dataset (``make_synthetic_dataset``,
seeded) and its ``StreamingLoader``, and drives the first ``check_steps``
steps through ``Trainer.train_batch``, the call ``Trainer.fit`` makes, on
batches whose rows all differ. They warm every shape the window uses. The
window runs the same call on the same loader for ``--seconds`` and ends on
``torch.cuda.synchronize()``; tokens a second are all its steps' tokens
over its wall time.

``correct`` compares those first steps with ``reference/mpt.py`` from the
same weights and batches: each step's loss (``loss_gap``) and each leaf's
norm of the parameters' change over the steps (``change_gap``, read before
the window's first step moves them), judged by the gap of the norms over
the larger of the reference leaf's norm and the median leaf's; leaves
whose reference gradient is under a thousandth of the median leaf's are
left out. The numbers compared are those the cell's limits file lists.
Each leaf's norm of the first clipped gradient (from ADOPT's ``v`` after
one step, ``v = g²``) is read beside them as ``grad_gap``: the token
embedding's gradient is summed in bf16, the compute dtype the
configuration states, and reads up to a sixth from the float32 sum on
sound runs, as far as lower precisions do, so it separates nothing.
"""

from __future__ import annotations

import shutil
import statistics
import tempfile
import time

import torch

from perfbench import runtime, trace, weights
from perfbench.counting import train_flops_per_token
from perfbench.reference import mpt as ref


def _port_config(conf: dict):
    from photon_tpu_torch.config.schema import Config

    return Config.from_dict(conf["port"])


def _flash_shapes(name, q, k, v, *, causal, offset, **_):
    b, s_q, h, d = q.shape
    return {"kind": name, "b": b, "s_q": s_q, "s_k": k.shape[1], "h": h, "n_kv": k.shape[2],
            "d": d, "causal": bool(causal), "offset": int(offset), "elem": q.element_size()}


def _plant(fault: str | None, trainer) -> None:
    """The faults ``correct`` has to catch, planted in the timed path."""
    if fault is None:
        return
    if fault == "state_unchanged":  # the optimizer step returns its state untouched
        trainer.tx.apply = lambda grads, state, params: state
    elif fault == "half_batch":  # half of the batch left out, the mean over the rest
        step = trainer._train_step
        trainer._train_step = lambda state, tokens: step(state, tokens[: tokens.shape[0] // 2])
    else:
        raise ValueError(f"unknown fault {fault!r}")


def _leaf_norms(tree_flat: dict, base: dict) -> dict:
    return {n: float((tree_flat[n].detach().float() - base[n]).norm()) for n in base}


def run(ctx: runtime.Context) -> runtime.Result:
    from photon_tpu_torch.codec.params import flatten
    from photon_tpu_torch.data.loader import StreamingLoader, make_synthetic_dataset
    from photon_tpu_torch.ops import flash_attention
    from photon_tpu_torch.train.trainer import Trainer

    conf, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    m = conf["port"]["model"]
    cfg = _port_config(conf)
    gbs, seq = cfg.train.global_batch_size, cfg.model.max_seq_len
    trainer = Trainer(cfg, params=weights.nest(weights.make(m, ctx.seed, dev, torch.float32)),
                      device=dev)
    _plant(ctx.fault, trainer)
    data_dir = tempfile.mkdtemp(prefix="perfbench-data-")
    try:
        ds = make_synthetic_dataset(data_dir, n_samples=gbs * mix["dataset_batches"],
                                    seq_len=seq, vocab_size=cfg.model.vocab_size, seed=ctx.seed)
        loader = StreamingLoader(ds, batch_size=gbs, seed=ctx.seed, shuffle=True)

        # the checked steps: the window's call and feed, from the seed
        batches, losses, first = [], [], {}
        for i in range(mix["check_steps"]):
            batch = next(loader)
            batches.append(batch.copy())
            losses.append(trainer.train_batch(batch)["loss"])
            if i == 0:
                st = trainer.state.opt_state
                first = {n: float(st[trainer.tx.moment_names(n)[1]].sum().sqrt())
                         for n in weights.shapes(m)}
        p0 = weights.make(m, ctx.seed, dev, torch.float32)
        change = _leaf_norms(flatten(trainer.state.params), p0)
        del p0
        losses = [float(x) for x in losses]
        runtime.sync(dev)
        setup_s = time.perf_counter() - ctx.t_start
        setup_peak = runtime.peak_bytes(dev)

        spans, record, recorders = ctx.spans, None, []
        if ctx.trace:
            spans.on = True
            spans.wrap(trainer.tx, "apply", "optimizer")
            recorders.append(trace.CallRecorder(flash_attention, "_launch", "flash",
                                                _flash_shapes, kernel="_kernel"))
            record = trace.Record(conf, mix)
        runtime.reset_peak(dev)
        steps = traced_steps = 0
        t0 = time.perf_counter()
        traced_s = 0.0
        if ctx.trace:
            with trace.profiled() as prof:
                with torch.profiler.record_function(trace.WINDOW_SPAN):
                    for r in recorders:
                        r.on = True
                    ts = time.perf_counter()
                    while time.perf_counter() - ts < min(mix["trace_s"], ctx.seconds):
                        with spans("data"):
                            batch = next(loader)
                        with spans("step"):
                            trainer.train_batch(batch)
                        traced_steps += 1
                    runtime.sync(dev)
                    traced_s = time.perf_counter() - ts
                    for r in recorders:
                        r.on = False
            steps = traced_steps
        while time.perf_counter() - t0 < ctx.seconds:
            with spans("data"):
                batch = next(loader)
            with spans("step"):
                trainer.train_batch(batch)
            steps += 1
        runtime.sync(dev)
        wall = time.perf_counter() - t0
        window_peak = runtime.peak_bytes(dev)
        peak = max(setup_peak, window_peak)
        for r in recorders:
            r.restore()
        if ctx.trace:
            trace.reduce(prof, record, recorders)
            del prof
            record.host.update(tokens=traced_steps * gbs * seq, seconds=traced_s,
                               flops_per_token=train_flops_per_token(m, seq),
                               window_peak_bytes=window_peak)
        del trainer, loader, ds
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    runtime.free(dev)

    checks, extra = _compare(ctx, m, conf, mix, batches, losses, first, change)
    return runtime.Result(
        attempted=steps, failed=0, setup_s=setup_s,
        e2e={"train_tokens_per_s": steps * gbs * seq / wall},
        memory_peak_bytes=peak, checks=checks, record=record, extra=extra)


def _reference(ctx, m, conf, mix, batches, precision):
    p = weights.make(m, ctx.seed, ctx.device, torch.float32)
    toks = [torch.as_tensor(b, dtype=torch.long, device=ctx.device) for b in batches]
    port = conf["port"]
    with ref.strict_fp32():
        out = ref.train_steps(p, toks, m, port["optimizer"], port["scheduler"],
                              mix["ref_rows_per_pass"], precision)
    p0 = weights.make(m, ctx.seed, ctx.device, torch.float32)
    out["change"] = _leaf_norms(out.pop("params"), p0)
    del p, p0, toks
    runtime.free(ctx.device)
    return out


def _gaps(losses, first, change, r, keep) -> dict:
    return {"loss_gap": max(abs(a - b) for a, b in zip(losses, r["losses"])),
            "grad_gap": runtime.worst_leaf_gap(first, r["first_grad_norms"], keep),
            "change_gap": runtime.worst_leaf_gap(change, r["change"], keep)}


def _compare(ctx, m, conf, mix, batches, losses, first, change):
    r = _reference(ctx, m, conf, mix, batches, "fp32")
    g = r["first_grad_norms"]
    med = statistics.median(g.values())
    keep = [n for n in g if g[n] >= 1e-3 * med]
    got = _gaps(losses, first, change, r, keep)
    lim = ctx.cell.limits
    checks = [(name, got[name], lim[name]) for name in lim]
    extra = {"program": got, "left_out": sorted(set(g) - set(keep)),
             "leaf_norms": {n: {"grad": [first[n], g[n]], "change": [change[n], r["change"][n]]}
                            for n in g},
             "losses": losses, "ref_losses": r["losses"]}
    if ctx.control:
        c = _reference(ctx, m, conf, mix, batches, "fp8")
        extra["control"] = _gaps(c["losses"], c["first_grad_norms"], c["change"], r, keep)
    return checks, extra

