"""Trainer: the persistent per-client training runtime.

The port of ``photon_tpu/train/trainer.py``: one object owning the train
step, the :class:`TrainState` (the parameters, each leaf in the JAX tree's
dtype, and the optimizer state under optax's names) and the host loop,
with the parameter plane the federation layer calls at round boundaries
(``get/set_parameters``, ``get/set_opt_state_arrays``,
``get/set_momenta``, ``reset_optimizer``, ``set_step``). It runs on ``cuda`` unless the caller asks for the CPU,
where the attention kernels' plain versions run. ``device_microbatch_size:
auto`` probes for the largest microbatch that trains (:meth:`Trainer.
_probe_microbatch`).

On a mesh (``mesh=``, or ``cfg.mesh`` larger than one device, built over
the local cards, or the CPU repeated when ``device`` is the CPU) the step
is ``parallel/spmd.py``'s and the state a :class:`~photon_tpu_torch.
parallel.spmd.MeshTrainState`; the microbatch is per data-parallel
position, as in JAX (rows a step: ``micro × data × fsdp × expert``), and
the parameter plane gathers and scatters in the codec's order, so its
lists are a single-device Trainer's. With ``pipe > 1`` the step is
``parallel/pipeline.py``'s GPipe schedule over the same state. Built
without a mesh under ``photon.mesh_autotune``, the Trainer takes the
layout ``parallel/autotune.py`` ranks first for its local devices. The
MFU peak the trainer resolved is a ``speed_monitor/peak`` telemetry event
(its ``n_chips`` counts distinct devices), so a run's MFU carries its
basis.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import warnings
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.codec.params import (
    ParamsMetadata,
    flatten,
    params_from_ndarrays,
    params_to_ndarrays,
    refuse_npz_bf16,
    tensors_to_ndarrays,
    to_numpy,
    to_tensor,
)
from photon_tpu_torch.config.schema import Config, MeshConfig, effective_model_config
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.models.mpt import MPTModel, init_params
from photon_tpu_torch.optim import build_optimizer
from photon_tpu_torch.parallel import pipeline, spmd
from photon_tpu_torch.parallel.collective_agg import local_devices
from photon_tpu_torch.parallel.mesh import AXES, Mesh, make_mesh
from photon_tpu_torch.parallel.sharding import ShardedTensor
from photon_tpu_torch.train.train_step import (
    init_train_state,
    make_eval_step,
    make_train_step,
)
from photon_tpu_torch.utils.profiling import (
    CLIENT_FINAL_LOSS,
    CLIENT_FIT_SET_PARAMETERS_TIME,
    CLIENT_FIT_TIME,
    CLIENT_LR,
    CLIENT_STEPS,
    CLIENT_TOKENS_PER_SEC,
    EVENT_SPEED_MONITOR_PEAK,
    SpeedMonitor,
    dump_memory_profile,
    is_oom,
)


class Trainer:
    def __init__(self, cfg: Config, params: dict | None = None, init_seed: int | None = None,
                 device: str | torch.device | None = None, mesh: Mesh | None = None,
                 n_devices: int | None = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.layout_autotune: dict | None = None
        if mesh is None and cfg.photon.mesh_autotune:
            mesh = self._autotuned_mesh(n_devices)
        elif mesh is None and cfg.mesh.size > 1:
            # the local cards (refused when too few, as JAX does); the CPU repeats
            mesh = make_mesh(cfg.mesh, devices=local_devices("cpu", cfg.mesh.size)
                             if self.device.type == "cpu" else None)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None:
            self.device = self.mesh.distinct_devices()[0]
        # the mesh-driven attention fallback (pipe > 1: pallas → xla; sequence
        # > 1: pallas → ring) is taken here; cfg.model stays the config of
        # record. JAX's rule reads the config's mesh (the tuned one under
        # the autotuner), even where the trainer runs on one device (the
        # collective runner's client); the mesh the trainer runs on then
        # applies the same rule
        mesh_shape = self.mesh.shape if self.mesh is not None else dict.fromkeys(AXES, 1)
        mesh_cfg = self.layout_autotune["mesh"] if self.layout_autotune else cfg.mesh
        mcfg = effective_model_config(cfg.model, mesh_cfg)
        mcfg = effective_model_config(mcfg, MeshConfig(**mesh_shape))
        self.model = MPTModel(mcfg)
        lora = cfg.model.lora_rank > 0  # a LoRA fit computes no gradient for the frozen base
        self.tx, self.lr_schedule = build_optimizer(cfg.optimizer, cfg.scheduler)
        self._last_set_time = 0.0
        if params is None:
            params = init_params(cfg.model, seed=cfg.seed if init_seed is None else init_seed,
                                 device=self.device)
        else:
            params = _tree_map(lambda t: t.detach().to(self.device).clone(), params)

        # batch rounding, as the JAX trainer does: the microbatch is per
        # data-parallel position, a step takes micro x dp_degree rows at a
        # time; the batch is rounded down to a multiple of dp_degree, a
        # microbatch larger than the per-position batch is clamped to it,
        # and the batch is rounded down again to a multiple of the rows a
        # step takes
        dp = mesh_shape["data"] * mesh_shape["fsdp"] * mesh_shape["expert"]
        gbs = cfg.train.global_batch_size
        if gbs % dp:
            adapted = max((gbs // dp) * dp, dp)
            warnings.warn(f"global_batch_size {gbs} not divisible by data-parallel degree "
                          f"{dp}; adapted to {adapted}", stacklevel=2)
            cfg.train.global_batch_size = adapted
        micro = cfg.train.device_microbatch_size
        #: the ``auto`` probe's record: the candidates tried, each ``(micro,
        #: "ok" | "oom")``, and its seconds (None without the probe)
        self.auto_probe: dict | None = None
        if micro == "auto":
            micro = self._probe_microbatch(params, dp)
        elif not isinstance(micro, int):
            raise ValueError(f"device_microbatch_size must be an int or 'auto', got {micro!r}")
        else:
            clamped = min(micro, cfg.train.global_batch_size // dp)
            if clamped != micro:
                warnings.warn(f"device_microbatch_size {micro} exceeds the per-device batch "
                              f"{cfg.train.global_batch_size // dp}; clamped to {clamped}",
                              stacklevel=2)
            micro = clamped
        self.device_microbatch_size = micro
        rows = micro * dp
        if cfg.train.global_batch_size % rows:
            adapted = max((cfg.train.global_batch_size // rows) * rows, rows)
            warnings.warn(f"global_batch_size {cfg.train.global_batch_size} not divisible by "
                          f"microbatch rows-per-scan {rows} (micro {micro} x dp {dp}); "
                          f"adapted to {adapted}", stacklevel=2)
            cfg.train.global_batch_size = adapted
        self.effective_global_batch_size = cfg.train.global_batch_size
        self._n_micro = cfg.train.global_batch_size // rows

        chunk = cfg.train.loss_chunk_tokens
        if self.mesh is not None and mesh_shape["pipe"] > 1:
            # the GPipe schedule over pipe; the state is the meshed one
            self.mesh_model = pipeline.Pipeline(mcfg, self.mesh, self._n_micro)
            self.state = spmd.init_mesh_state(self.tx, params, self.mesh, lora)
            del params
            self._train_step = pipeline.make_pipeline_train_step(self.mesh_model, self.tx,
                                                                 loss_chunk_tokens=chunk)
            self._eval_step = pipeline.make_pipeline_eval_step(self.mesh_model,
                                                               loss_chunk_tokens=chunk)
        elif self.mesh is not None:
            self.mesh_model = spmd.MeshModel(mcfg, self.mesh)
            self.state = spmd.init_mesh_state(self.tx, params, self.mesh, lora)
            del params
            self._train_step = spmd.make_mesh_train_step(
                self.mesh_model, self.tx, n_microbatches=self._n_micro, loss_chunk_tokens=chunk)
            self._eval_step = spmd.make_mesh_eval_step(self.mesh_model, loss_chunk_tokens=chunk)
        else:
            self.state = init_train_state(self.tx, params, lora)
            self._train_step = make_train_step(self.model, self.tx, n_microbatches=self._n_micro,
                                               loss_chunk_tokens=chunk)
            self._eval_step = make_eval_step(self.model, loss_chunk_tokens=chunk)
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        n_devices = len(self.mesh.distinct_devices()) if self.mesh is not None else 1
        self.speed_monitor = SpeedMonitor(cfg.model, device_name=name, n_devices=n_devices)
        telemetry.emit_event(EVENT_SPEED_MONITOR_PEAK, device_kind=name,
                             peak_flops_per_chip=self.speed_monitor.peak_flops_per_device,
                             n_chips=self.speed_monitor.n_devices)

    def _autotuned_mesh(self, n_devices: int | None) -> Mesh:
        """``photon.mesh_autotune`` without an explicit mesh: the layout the
        cost model ranks first over the local devices (the cards, or
        ``n_devices`` slots of the CPU: one by default), recorded in
        ``layout_autotune`` (``mesh``, ``search_s``, ``est_step_s``), as
        the JAX trainer does. An ``auto`` microbatch caps ``pipe`` at 1."""
        from photon_tpu_torch.parallel.autotune import autotune_layout

        cfg = self.cfg
        if n_devices is None:
            n_devices = torch.cuda.device_count() if self.device.type == "cuda" else 1
        devices = local_devices(self.device.type, n_devices)
        t0 = time.monotonic()
        micro = cfg.train.device_microbatch_size
        best = autotune_layout(cfg.model, devices=devices,
                               global_batch_size=cfg.train.global_batch_size,
                               microbatch=micro if isinstance(micro, int) else 0,
                               max_pipe=None if isinstance(micro, int) else 1)
        mesh_cfg = dataclasses.replace(best.mesh, surplus_devices=cfg.mesh.surplus_devices)
        self.layout_autotune = {"mesh": mesh_cfg, "search_s": time.monotonic() - t0,
                                "est_step_s": best.est_step_s}
        cfg.refuse_param_dtype_on_pipe(mesh_cfg.pipe)
        return make_mesh(mesh_cfg, devices=devices)

    # ------------------------------------------------------------------
    # auto microbatch probe
    # ------------------------------------------------------------------

    def _probe_microbatch(self, params: dict, dp_degree: int = 1) -> int:
        """The largest power-of-2 per-position microbatch that runs one real
        train step without exhausting device memory: the JAX trainer's
        probe (``device_train_microbatch_size: auto`` halving on a CUDA OOM
        in the original photon, ``photon/clients/trainer_utils.py:972-978``).

        Candidates start at the largest power of 2 <= ``global_batch_size //
        dp_degree`` (capped by ``train.auto_microbatch_cap``); one is taken
        only where ``candidate × dp_degree`` divides the batch, and JAX's
        ``ValueError`` is raised when none does. Each runs a step of zero
        tokens from ``params`` with a state of its own (on a mesh a fresh
        :class:`~photon_tpu_torch.parallel.spmd.MeshTrainState` through
        ``make_mesh_train_step``, the non-pipelined step, as JAX's probe),
        so its memory is the real step's. On one device ``params`` are
        restored from a host copy after each (on a mesh the state's shards
        are copies). The candidate's state, gradients and activations are
        freed, and the allocator's cache emptied, before the next; an OOM on
        any position's device halves the candidate, another error
        propagates. :attr:`auto_probe` records the candidates tried."""
        cfg = self.cfg
        gbs = cfg.train.global_batch_size
        rows = max(1, gbs // dp_degree)
        if cfg.train.auto_microbatch_cap:
            rows = min(rows, cfg.train.auto_microbatch_cap)
        cand = 1 << (rows.bit_length() - 1)  # largest pow2 <= rows
        lora = cfg.model.lora_rank > 0
        flat = flatten(params)
        saved = None if self.mesh is not None else {
            name: p.detach().to("cpu", copy=True) for name, p in flat.items()}
        tokens = torch.zeros((gbs, cfg.model.max_seq_len), dtype=torch.long,
                             device=self.device)
        if self.mesh is not None:
            tokens = {d: tokens.to(d) for d in self.mesh.distinct_devices()}
        devices = self.mesh.distinct_devices() if self.mesh is not None else [self.device]
        model = spmd.MeshModel(self.model.cfg, self.mesh) if self.mesh is not None else self.model
        tried: list[tuple[int, str]] = []
        t0 = time.monotonic()
        last_err = ""
        while cand >= 1:
            if gbs % (cand * dp_degree):
                cand //= 2  # the microbatches must be equal
                continue
            n_micro = gbs // (cand * dp_degree)
            try:
                if self.mesh is not None:
                    step = spmd.make_mesh_train_step(
                        model, self.tx, n_microbatches=n_micro,
                        loss_chunk_tokens=cfg.train.loss_chunk_tokens)
                    step(spmd.init_mesh_state(self.tx, params, self.mesh, lora), tokens)
                else:
                    step = make_train_step(model, self.tx, n_microbatches=n_micro,
                                           loss_chunk_tokens=cfg.train.loss_chunk_tokens)
                    step(init_train_state(self.tx, params, lora), tokens)
                self._sync()
                tried.append((cand, "ok"))
                self.auto_probe = {"tried": tried, "seconds": time.monotonic() - t0}
                return cand
            except Exception as e:  # noqa: BLE001 -- only an OOM is retried
                if not is_oom(e):
                    raise
                tried.append((cand, "oom"))
                last_err = str(e)  # not the exception: its frames hold the activations
                cand //= 2
            finally:
                if saved is not None:
                    with torch.no_grad():
                        for name, p in flat.items():
                            p.copy_(saved[name])
                for d in devices:
                    if d.type == "cuda":
                        with torch.cuda.device(d):
                            torch.cuda.empty_cache()
        self.auto_probe = {"tried": tried, "seconds": time.monotonic() - t0}
        if not tried:
            raise ValueError(
                "auto microbatch: no power-of-2 per-device microbatch divides "
                f"global_batch_size={gbs} over "
                f"dp_degree={dp_degree}; set device_microbatch_size explicitly"
            )
        # the allocation picture at the last OOM, left on disk (None on the
        # CPU); the text names it as the JAX trainer's does
        dump = dump_memory_profile(getattr(cfg.photon, "save_path", ".") or ".",
                                   "auto_microbatch", device=self.device)
        raise RuntimeError("auto microbatch: even microbatch 1 exhausts device memory"
                           + (f" (memory profile: {dump})" if dump else "")
                           + f": {last_err}")

    # ------------------------------------------------------------------
    # training / eval loops
    # ------------------------------------------------------------------

    def _to_device(self, batch: np.ndarray):
        """The batch on the device; on a mesh ``{device: batch}`` for each
        of its devices."""
        t = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.int64))
        if self.mesh is not None:
            if self.device.type == "cuda":
                t = t.pin_memory()
            return {d: t.to(d, non_blocking=True) for d in self.mesh.distinct_devices()}
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _sync(self) -> None:
        devices = self.mesh.distinct_devices() if self.mesh is not None else [self.device]
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def train_batch(self, batch: np.ndarray) -> dict[str, torch.Tensor]:
        """One train step on a ``[global_batch, seq]`` token batch; the
        metrics stay on the device."""
        self.state, metrics = self._train_step(self.state, self._to_device(batch))
        return metrics

    def fit(self, batches: Iterable[np.ndarray], duration_steps: int, log_every: int = 0,
            callback: Callable[[int, dict[str, float]], None] | None = None) -> dict[str, float]:
        """Run ``duration_steps`` steps; returns the JAX trainer's metric
        names (the last logged step's loss/grad_norm/param_norm, throughput,
        ``client/*``)."""
        from photon_tpu_torch.data.prefetch import PrefetchIterator

        # prefetch exactly duration_steps batches, so a resumable loader's
        # state never runs ahead of the steps taken
        it: Iterator[np.ndarray] = PrefetchIterator(
            itertools.islice(iter(batches), duration_steps), depth=2)
        self._sync()
        t0 = time.monotonic()
        losses: list[float] = []
        last_metrics: dict[str, float] = {}
        tokens_seen = 0
        try:
            for i in range(duration_steps):
                try:
                    batch = next(it)
                except StopIteration:
                    raise ValueError(f"batch stream exhausted at step {i}/{duration_steps}") from None
                tokens_seen += int(np.prod(batch.shape))
                metrics = self.train_batch(batch)
                if (log_every and (i + 1) % log_every == 0) or i == duration_steps - 1:
                    last_metrics = {k: float(v) for k, v in metrics.items()}
                    losses.append(last_metrics["loss"])
                    if callback:
                        callback(i, last_metrics)
        finally:
            it.close()
        self._sync()  # the device has finished every step before the clock is read
        dt = time.monotonic() - t0
        return {
            **last_metrics,
            **self.speed_monitor.update(tokens_seen, dt),
            CLIENT_FIT_TIME: dt,
            CLIENT_FIT_SET_PARAMETERS_TIME: self._last_set_time,
            CLIENT_STEPS: float(duration_steps),
            CLIENT_TOKENS_PER_SEC: tokens_seen / dt if dt > 0 else 0.0,
            CLIENT_FINAL_LOSS: losses[-1] if losses else float("nan"),
            CLIENT_LR: float(self.lr_schedule(self.step - 1)),
        }

    def evaluate(self, batches: Iterable[np.ndarray], max_batches: int = 0) -> dict[str, float]:
        """Mean CE over the eval stream."""
        t0 = time.monotonic()
        total_ce, total_tok = 0.0, 0
        for i, batch in enumerate(batches):
            if max_batches and i >= max_batches:
                break
            ce_sum, n = self._eval_step(self.state.params, self._to_device(batch))
            total_ce += float(ce_sum)
            total_tok += int(n)
        if total_tok == 0:
            raise ValueError("evaluate: empty eval stream")
        loss = total_ce / total_tok
        return {"eval/loss": loss, "eval/perplexity": float(np.exp(min(loss, 30.0))),
                "eval/tokens": float(total_tok), "eval/time": time.monotonic() - t0}

    # ------------------------------------------------------------------
    # parameter plane (round boundaries)
    # ------------------------------------------------------------------

    @property
    def step(self) -> int:
        return self.state.step

    def _flat_params(self) -> dict:
        """``{name: tensor or ShardedTensor}`` in codec order."""
        if self.mesh is not None:
            return dict(sorted(self.state.params.items()))
        return flatten(self.state.params)

    def get_parameters(self) -> tuple[ParamsMetadata, list[np.ndarray]]:
        """The parameters as the canonical flat list (sorted names), as
        fresh host arrays that later steps do not overwrite (on a mesh,
        each gathered from its shards)."""
        if self.mesh is not None:
            flat = self._flat_params()
            return tensors_to_ndarrays(flat, (st.to_full() for st in flat.values()))
        return params_to_ndarrays(_tree_map(torch.Tensor.detach, self.state.params))

    def set_parameters(self, metadata: ParamsMetadata, arrays: list[np.ndarray]) -> None:
        """Copy a flat list into the parameters, in place (on a mesh, each
        scattered to its shards). A bf16 parameter takes only a bf16 leaf:
        an npz's ``|V2`` one raises ``codec.params.Bf16NpzError``, as the
        JAX package cannot load it either."""
        t0 = time.monotonic()
        if self.mesh is not None:
            flat = self._flat_params()
            if tuple(flat) != tuple(metadata.names):
                raise ValueError("parameter name mismatch between the trainer and metadata")
            refuse_npz_bf16({n: next(iter(st.shards.values())).dtype
                             for n, st in flat.items()}, arrays)
            metadata.validate_arrays(arrays)
            for st, a, d in zip(flat.values(), arrays, metadata.dtypes):
                st.copy_from_full(to_tensor(a, d))
        else:
            new = flatten(params_from_ndarrays(self.state.params, metadata, arrays))
            with torch.no_grad():
                for name, p in flatten(self.state.params).items():
                    p.copy_(new[name])
        self._last_set_time = time.monotonic() - t0

    @staticmethod
    def _whole(t) -> torch.Tensor:
        return t.to_full() if isinstance(t, ShardedTensor) else t

    def get_opt_state_arrays(self) -> tuple[ParamsMetadata, list[np.ndarray]]:
        """The optimizer state as (metadata, arrays) under optax's names,
        each in its own dtype; fresh host arrays, as :meth:`get_parameters`
        returns."""
        names = sorted(self.state.opt_state)
        return tensors_to_ndarrays(names, (self._whole(self.state.opt_state[n]) for n in names))

    def set_opt_state_arrays(self, metadata: ParamsMetadata, arrays: list[np.ndarray]) -> None:
        """Load an optimizer state; each entry takes the stored dtype (an
        AdamW moment written after its fp32 promotion is fp32 again)."""
        state = self.state.opt_state
        if tuple(sorted(state)) != tuple(metadata.names):
            raise ValueError("optimizer state names do not match this optimizer's")
        metadata.validate_arrays(arrays)
        with torch.no_grad():
            for name, a, d in zip(metadata.names, arrays, metadata.dtypes):
                old, new = state[name], to_tensor(a, d, name)
                if isinstance(old, ShardedTensor):
                    if any(t.dtype != new.dtype for t in old.shards.values()):
                        old.shards = {k: t.to(new.dtype) for k, t in old.shards.items()}
                    old.copy_from_full(new.reshape(old.shape))
                    continue
                state[name] = new.reshape(old.shape).to(old.device)

    def get_momenta(self) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """First and second moments in codec (sorted-name) order, as fresh
        host arrays, each in its own dtype; frozen parameters report fp32
        zeros."""
        m1, m2 = [], []
        for name, p in self._flat_params().items():
            for out, key in zip((m1, m2), self.tx.moment_names(name)):
                t = self.state.opt_state.get(key)
                out.append(np.zeros(tuple(p.shape), np.float32) if t is None
                           else to_numpy(self._whole(t)))
        return m1, m2

    def set_momenta(self, m1: list[np.ndarray], m2: list[np.ndarray]) -> None:
        """Copy aggregated moments into the optimizer state (each cast to
        its moment's dtype); values for frozen parameters are ignored."""
        names = list(self._flat_params())
        if len(m1) != len(names) or len(m2) != len(names):
            raise ValueError(f"expected {len(names)} moments each, got {len(m1)}/{len(m2)}")
        with torch.no_grad():
            for i, name in enumerate(names):
                for arrays, key in zip((m1, m2), self.tx.moment_names(name)):
                    t = self.state.opt_state.get(key)
                    new = torch.from_numpy(np.array(arrays[i], np.float32))
                    if isinstance(t, ShardedTensor):
                        t.copy_from_full(new.reshape(t.shape))
                    elif t is not None:
                        t.copy_(new.reshape(t.shape))

    def reset_optimizer(self) -> None:
        """Fresh optimizer state; parameters and step kept."""
        if self.mesh is not None:
            self.state.opt_state = spmd.fresh_opt_state(self.tx, self.state.params, self.mesh)
        else:
            self.state.opt_state = self.tx.init(flatten(self.state.params))

    def set_step(self, step: int) -> None:
        """Set the step counter and every optimizer ``count`` (which drives
        the lr schedule and ADOPT/Adam), so training continues mid-schedule."""
        self.state.step = int(step)
        for name in self.tx.counts:
            self.state.opt_state[name] = torch.tensor(int(step), dtype=torch.int32)


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}
