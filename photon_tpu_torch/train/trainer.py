"""Trainer: the persistent per-client training runtime, on one device.

The port of ``photon_tpu/train/trainer.py``: one object owning the train
step, the :class:`TrainState` (fp32 master parameters and the optimizer
state under optax's names) and the host loop, with the parameter plane the
federation layer calls at round boundaries (``get/set_parameters``,
``get/set_opt_state_arrays``, ``get/set_momenta``, ``reset_optimizer``,
``set_step``). It runs on ``cuda`` unless the caller asks for the CPU,
where the attention kernels' plain versions run. ``device_microbatch_size:
auto`` probes for the largest microbatch that trains (:meth:`Trainer.
_probe_microbatch`). There is no mesh, no pipeline and no autotuner: the
config's ``validate()`` refuses them.
"""

from __future__ import annotations

import itertools
import time
import warnings
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from photon_tpu_torch.codec.params import (
    ParamsMetadata,
    flatten,
    params_from_ndarrays,
    params_to_ndarrays,
    to_numpy,
)
from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.models.mpt import MPTModel, init_params
from photon_tpu_torch.optim import build_optimizer
from photon_tpu_torch.train.train_step import (
    TrainState,
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
    SpeedMonitor,
    is_oom,
)


class Trainer:
    def __init__(self, cfg: Config, params: dict | None = None, init_seed: int | None = None,
                 device: str | torch.device | None = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = MPTModel(cfg.model)
        self.tx, self.lr_schedule = build_optimizer(cfg.optimizer, cfg.scheduler)
        self._last_set_time = 0.0
        if params is None:
            params = init_params(cfg.model, seed=cfg.seed if init_seed is None else init_seed,
                                 device=self.device)
        else:
            params = _tree_map(lambda t: t.detach().to(self.device, torch.float32).clone(), params)

        # batch rounding, as the JAX trainer does on a one-device mesh: a
        # microbatch larger than the batch is clamped to it, and the batch
        # is rounded down to a multiple of the microbatch
        micro = cfg.train.device_microbatch_size
        if micro == "auto":
            micro = self._probe_microbatch(params)
        elif not isinstance(micro, int):
            raise ValueError(f"device_microbatch_size must be an int or 'auto', got {micro!r}")
        clamped = min(micro, cfg.train.global_batch_size)
        if clamped != micro:
            warnings.warn(f"device_microbatch_size {micro} exceeds the per-device batch "
                          f"{cfg.train.global_batch_size}; clamped to {clamped}", stacklevel=2)
        micro = clamped
        self.device_microbatch_size = micro
        if cfg.train.global_batch_size % micro:
            adapted = max((cfg.train.global_batch_size // micro) * micro, micro)
            warnings.warn(f"global_batch_size {cfg.train.global_batch_size} not divisible by "
                          f"microbatch rows-per-scan {micro} (micro {micro} x dp 1); "
                          f"adapted to {adapted}", stacklevel=2)
            cfg.train.global_batch_size = adapted
        self.effective_global_batch_size = cfg.train.global_batch_size
        self._n_micro = cfg.train.global_batch_size // micro

        self.state: TrainState = init_train_state(self.tx, params)
        self._train_step = make_train_step(self.model, self.tx, n_microbatches=self._n_micro,
                                           loss_chunk_tokens=cfg.train.loss_chunk_tokens)
        self._eval_step = make_eval_step(self.model, loss_chunk_tokens=cfg.train.loss_chunk_tokens)
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        self.speed_monitor = SpeedMonitor(cfg.model, device_name=name)

    # ------------------------------------------------------------------
    # auto microbatch probe
    # ------------------------------------------------------------------

    def _probe_microbatch(self, params: dict) -> int:
        """The largest power-of-2 microbatch that runs one real train step
        without exhausting device memory: the JAX trainer's probe
        (``device_train_microbatch_size: auto`` halving on a CUDA OOM in the
        original photon, ``photon/clients/trainer_utils.py:972-978``).

        Candidates start at the largest power of 2 <= ``global_batch_size``
        (capped by ``train.auto_microbatch_cap``) and skip those that do not
        divide the batch (on one device 1 always does: JAX's ``ValueError``
        for none is a multi-device case). Each runs a step of zero tokens on
        ``params`` with an optimizer state of its own, so its memory is the
        real step's; ``params`` are restored from a host copy after each,
        and the candidate's state, gradients and activations are freed (and
        the allocator's cache emptied) before the next. A non-OOM error
        propagates."""
        cfg = self.cfg
        gbs = cfg.train.global_batch_size
        rows = gbs
        if cfg.train.auto_microbatch_cap:
            rows = min(rows, cfg.train.auto_microbatch_cap)
        cand = 1 << (max(rows, 1).bit_length() - 1)  # largest pow2 <= rows
        flat = flatten(params)
        saved = {name: p.detach().to("cpu", copy=True) for name, p in flat.items()}
        tokens = torch.zeros((gbs, cfg.model.max_seq_len), dtype=torch.long,
                             device=self.device)
        last_err = ""
        while cand >= 1:
            if gbs % cand:
                cand //= 2  # the microbatches must be equal
                continue
            try:
                step = make_train_step(self.model, self.tx, n_microbatches=gbs // cand,
                                       loss_chunk_tokens=cfg.train.loss_chunk_tokens)
                step(init_train_state(self.tx, params), tokens)
                self._sync()
                return cand
            except Exception as e:  # noqa: BLE001 -- only an OOM is retried
                if not is_oom(e):
                    raise
                last_err = str(e)  # not the exception: its frames hold the activations
                cand //= 2
            finally:
                with torch.no_grad():
                    for name, p in flat.items():
                        p.copy_(saved[name])
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
        raise RuntimeError(f"auto microbatch: even microbatch 1 exhausts device memory: "
                           f"{last_err}")

    # ------------------------------------------------------------------
    # training / eval loops
    # ------------------------------------------------------------------

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.int64))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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

    def get_parameters(self) -> tuple[ParamsMetadata, list[np.ndarray]]:
        """The parameters as the canonical flat list (sorted names), as
        fresh host arrays that later steps do not overwrite."""
        return params_to_ndarrays(_tree_map(torch.Tensor.detach, self.state.params))

    def set_parameters(self, metadata: ParamsMetadata, arrays: list[np.ndarray]) -> None:
        """Copy a flat list into the parameters, in place."""
        t0 = time.monotonic()
        new = flatten(params_from_ndarrays(self.state.params, metadata, arrays))
        with torch.no_grad():
            for name, p in flatten(self.state.params).items():
                p.copy_(new[name])
        self._last_set_time = time.monotonic() - t0

    def get_opt_state_arrays(self) -> tuple[ParamsMetadata, list[np.ndarray]]:
        """The optimizer state as (metadata, arrays) under optax's names;
        fresh host arrays, as :meth:`get_parameters` returns."""
        names = sorted(self.state.opt_state)
        arrays = [to_numpy(self.state.opt_state[n]) for n in names]
        return ParamsMetadata.from_ndarrays(names, arrays), arrays

    def set_opt_state_arrays(self, metadata: ParamsMetadata, arrays: list[np.ndarray]) -> None:
        state = self.state.opt_state
        if tuple(sorted(state)) != tuple(metadata.names):
            raise ValueError("optimizer state names do not match this optimizer's")
        metadata.validate_arrays(arrays)
        with torch.no_grad():
            for name, a in zip(metadata.names, arrays):
                old = state[name]
                state[name] = torch.from_numpy(np.array(a, dtype=_np_dtype(old))).reshape(
                    old.shape).to(old.device)

    def get_momenta(self) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """First and second moments in codec (sorted-name) order, as fresh
        host arrays; frozen parameters report zeros."""
        m1, m2 = [], []
        for name, p in flatten(self.state.params).items():
            for out, key in zip((m1, m2), self.tx.moment_names(name)):
                t = self.state.opt_state.get(key)
                out.append(np.zeros(tuple(p.shape), np.float32) if t is None
                           else to_numpy(t))
        return m1, m2

    def set_momenta(self, m1: list[np.ndarray], m2: list[np.ndarray]) -> None:
        """Copy aggregated moments into the optimizer state; values for
        frozen parameters are ignored."""
        names = list(flatten(self.state.params))
        if len(m1) != len(names) or len(m2) != len(names):
            raise ValueError(f"expected {len(names)} moments each, got {len(m1)}/{len(m2)}")
        with torch.no_grad():
            for i, name in enumerate(names):
                for arrays, key in zip((m1, m2), self.tx.moment_names(name)):
                    t = self.state.opt_state.get(key)
                    if t is not None:
                        t.copy_(torch.from_numpy(np.array(arrays[i], np.float32)).reshape(t.shape))

    def reset_optimizer(self) -> None:
        """Fresh optimizer state; parameters and step kept."""
        self.state.opt_state = self.tx.init(flatten(self.state.params))

    def set_step(self, step: int) -> None:
        """Set the step counter and every optimizer ``count`` (which drives
        the lr schedule and ADOPT/Adam), so training continues mid-schedule."""
        self.state.step = int(step)
        for name in self.tx.counts:
            self.state.opt_state[name] = torch.tensor(int(step), dtype=torch.int32)


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return np.dtype(str(t.dtype).removeprefix("torch."))
