"""ClientRuntime: runs the fit and eval tasks of client ids on this node's
device (the port of ``photon_tpu/federation/client_runtime.py``).

- ONE persistent :class:`Trainer` per node, reused across rounds and cids:
  its optimizer state carries over as in the JAX package (unless the
  ``reset_optimizer`` knob or aggregated momenta replace it).
- Per-cid data loaders with the JAX package's seeds (``_stable_seed`` for
  synthetic data, ``shuffle_seed + cid`` for the order) and its
  fast-forward to a client's cumulative sample position on a fresh loader.
- ``server_steps_cumulative`` is injected as the optimizer's step
  (``Trainer.set_step``), so the lr schedule and ADOPT's count continue
  across rounds.
- Momenta piggybacking (``[params | m1 | m2]`` payloads), the reset,
  personalize and randomize knobs, skip-if-done client checkpoints,
  pseudo-gradient norms, and eval with the unigram-normalized metrics
  where a client's frequency dictionary exists.

Fit results upload through the transport's wire codec when the run has
one (its residuals are node-resident, keyed by cid). It trains on
``cuda`` unless the caller passes ``device="cpu"``. The JAX
package's telemetry spans and chaos hooks are left out: both features are
refused at ``validate()``.
"""

from __future__ import annotations

import pathlib
import time
import zlib

import numpy as np

from photon_tpu_torch.checkpoint.client import ClientCheckpointManager
from photon_tpu_torch.codec.params import ParamsMetadata
from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.data import ShardedDataset, StreamingLoader, make_synthetic_dataset
from photon_tpu_torch.federation.configs import EvaluateRoundConfig, FitRoundConfig
from photon_tpu_torch.federation.messages import (
    ClientState,
    EvaluateIns,
    EvaluateRes,
    FitIns,
    FitRes,
)
from photon_tpu_torch.federation.transport import ParamTransport
from photon_tpu_torch.train.param_ops import (
    extend_with_momenta,
    has_momenta,
    personalize_layers,
    randomize_layers,
    split_momenta,
)
from photon_tpu_torch.train.trainer import Trainer
from photon_tpu_torch.utils.profiling import (
    CLIENT_FIT_INIT_TIME,
    CLIENT_GET_PARAMETERS_TIME,
    CLIENT_PARAM_NORM,
    CLIENT_PSEUDO_GRAD_NORM,
    CLIENT_PUT_TIME,
    CLIENT_SKIPPED_ROUND,
    is_oom,
)


def _stable_seed(*parts) -> int:
    """The same across processes and packages (Python's ``hash`` is salted
    per process)."""
    return zlib.crc32("/".join(str(p) for p in parts).encode()) & 0x7FFFFFFF


def _l2(arrays: list[np.ndarray]) -> float:
    return float(np.sqrt(sum(float(np.sum(np.square(a, dtype=np.float64))) for a in arrays)))


class ClientRuntime:
    def __init__(self, cfg: Config, transport: ParamTransport, node_id: str = "node0",
                 ckpt_mgr: ClientCheckpointManager | None = None,
                 device: str | None = None) -> None:
        self.cfg = cfg
        self.transport = transport
        self.node_id = node_id
        self.ckpt_mgr = ckpt_mgr
        self._device = device
        self._trainer: Trainer | None = None
        self._loaders: dict[tuple[int, str], StreamingLoader] = {}
        self._current_params: tuple[ParamsMetadata, list[np.ndarray]] | None = None
        self._personal: dict[int, list[np.ndarray]] = {}  # per-cid personalized layers

    @property
    def trainer(self) -> Trainer:
        """The node's one Trainer, built on first use: a node that cannot
        get its device fails its first fit or eval (an error result the
        server retries and charges to its budget), not its start."""
        if self._trainer is None:
            self._trainer = Trainer(self.cfg, device=self._device)
        return self._trainer

    # -- data ------------------------------------------------------------
    def _loader(self, cid: int, split: str, batch_size: int) -> StreamingLoader:
        key = (cid, split)
        if key not in self._loaders:
            ds_cfg = self.cfg.dataset
            if ds_cfg.synthetic or not ds_cfg.local_path:
                root = pathlib.Path(self.cfg.photon.save_path) / "synthetic" / f"client_{cid}" / split
                if not (root / "index.json").exists():
                    make_synthetic_dataset(
                        str(root),
                        n_samples=max(4 * batch_size, 64),
                        seq_len=self.cfg.model.max_seq_len,
                        vocab_size=self.cfg.model.vocab_size,
                        seed=_stable_seed(cid, split),
                    )
                ds = ShardedDataset(root)
            else:
                # stream assignment streams[cid % n]; n_streams=0 keeps the
                # 1:1 client_{cid} layout
                stream = cid % ds_cfg.n_streams if ds_cfg.n_streams > 0 else cid
                ds = ShardedDataset(pathlib.Path(ds_cfg.local_path) / f"client_{stream}" / split)
            self._loaders[key] = StreamingLoader(
                ds,
                batch_size=batch_size,
                seed=ds_cfg.shuffle_seed + cid,
                shuffle=ds_cfg.shuffle and split == ds_cfg.split_train,
            )
        return self._loaders[key]

    # -- params ----------------------------------------------------------
    def set_broadcast_params(self, ptr) -> None:
        """Cache the round's global params. They are also the wire codec's
        delta base: this round's fit results upload as ``w_new − w_global``
        against exactly these arrays."""
        self._current_params = self.transport.get(ptr)
        self.transport.set_reference(self._current_params[1])

    def _resolve_params(self, ptr) -> tuple[ParamsMetadata, list[np.ndarray]]:
        if ptr is not None:
            self._current_params = self.transport.get(ptr)
            self.transport.set_reference(self._current_params[1])
        if self._current_params is None:
            raise RuntimeError("no parameters: neither FitIns pointer nor prior broadcast")
        return self._current_params

    def _error(self, e: Exception) -> str:
        msg = f"{type(e).__name__}: {e}"
        if is_oom(e) and self._trainer is not None and self._trainer.device.type == "cuda":
            import torch

            peak = torch.cuda.max_memory_allocated(self.trainer.device) / 1e9
            msg += f" [cuda max_memory_allocated {peak:.2f} GB]"
        return msg

    # -- fit -------------------------------------------------------------
    def fit(self, ins: FitIns, cid: int) -> FitRes:
        t_start = time.monotonic()
        try:
            return self._fit_inner(ins, cid, t_start)
        except Exception as e:  # noqa: BLE001 — a failed cid is retried on another node
            return FitRes(server_round=ins.server_round, cid=cid, params=None, error=self._error(e))

    def _fit_inner(self, ins: FitIns, cid: int, t_start: float) -> FitRes:
        cfg = self.cfg
        # a misspelled per-round knob raises here (an error FitRes)
        knobs = FitRoundConfig.from_dict(ins.config)
        state_in = (ClientState.from_dict(ins.client_states[cid]) if cid in ins.client_states
                    else ClientState(cid))
        target_step = ins.server_steps_cumulative + ins.local_steps

        # skip-if-done: the post-round client checkpoint already exists
        if (self.ckpt_mgr is not None and knobs.client_checkpoints
                and self.ckpt_mgr.should_skip_round(cid, target_step)):
            pm, pa, _, _ = self.ckpt_mgr.load(cid, target_step)
            return self._package_result(
                ins, cid, state_in, pm, pa, n_samples=ins.local_steps * cfg.train.global_batch_size,
                metrics={CLIENT_SKIPPED_ROUND: 1.0}, t_start=t_start)

        meta, arrays = self._resolve_params(ins.params)
        carry_momenta = has_momenta(meta)
        if carry_momenta:
            base_meta, params_in, m1_in, m2_in = split_momenta(meta, arrays)
        else:
            base_meta, params_in, m1_in, m2_in = meta, list(arrays), None, None

        params_touched = bool(knobs.personalize_patterns or knobs.randomize_patterns)
        if knobs.personalize_patterns:
            params_in = personalize_layers(base_meta, params_in, self._personal.get(cid),
                                           knobs.personalize_patterns)
        if knobs.randomize_patterns:
            params_in = randomize_layers(base_meta, params_in, knobs.randomize_patterns,
                                         seed=_stable_seed(cid, ins.server_round))

        self.trainer.set_parameters(base_meta, params_in)
        # ``initial`` only differences the pseudo-gradient norm; untouched,
        # params_in still aliases the cached broadcast, which nothing
        # writes into (set_parameters copies; get_parameters returns fresh
        # arrays), so the full-model copy is skipped
        initial = [a.copy() for a in params_in] if params_touched else params_in

        if knobs.reset_optimizer:
            self.trainer.reset_optimizer()
        elif carry_momenta:
            self.trainer.set_momenta(m1_in, m2_in)
        self.trainer.set_step(ins.server_steps_cumulative)

        fresh = (cid, cfg.dataset.split_train) not in self._loaders
        loader = self._loader(cid, cfg.dataset.split_train, cfg.train.global_batch_size)
        if knobs.reset_dataset_state:
            loader.reset()
        elif knobs.loader_state is not None:
            loader.load_state_dict(knobs.loader_state[cid])
        elif fresh and state_in.samples_cumulative > 0:
            # a node restart or server resume: fast-forward to the client's
            # position so the data order matches an uninterrupted run
            loader.skip_samples(state_in.samples_cumulative)

        t_fit0 = time.monotonic()
        fit_metrics = self.trainer.fit(loader, ins.local_steps, log_every=cfg.train.log_interval)
        # init = everything before the train loop; the loop reports
        # client/fit_time, and client/fit_set_parameters_time the hand-off
        fit_metrics[CLIENT_FIT_INIT_TIME] = t_fit0 - t_start

        t_get = time.monotonic()
        out_meta, out_arrays = self.trainer.get_parameters()
        fit_metrics[CLIENT_GET_PARAMETERS_TIME] = time.monotonic() - t_get
        n_samples = ins.local_steps * cfg.train.global_batch_size
        fit_metrics[CLIENT_PSEUDO_GRAD_NORM] = _l2([o - i for o, i in zip(out_arrays, initial)])
        fit_metrics[CLIENT_PARAM_NORM] = _l2(out_arrays)

        if knobs.personalize_patterns:
            self._personal[cid] = [a.copy() for a in out_arrays]
        if carry_momenta:
            m1_out, m2_out = self.trainer.get_momenta()
            out_meta, out_arrays = extend_with_momenta(out_meta, out_arrays, m1_out, m2_out)

        if self.ckpt_mgr is not None and knobs.client_checkpoints:
            om, oa = self.trainer.get_opt_state_arrays()
            self.ckpt_mgr.save(cid, target_step, out_meta, out_arrays, om, oa,
                               extra_state={"loader": loader.state_dict()})

        return self._package_result(ins, cid, state_in, out_meta, out_arrays, n_samples,
                                    fit_metrics, t_start)

    def _package_result(self, ins: FitIns, cid: int, state_in: ClientState,
                        meta: ParamsMetadata, arrays: list[np.ndarray], n_samples: int,
                        metrics: dict[str, float], t_start: float) -> FitRes:
        t_put = time.monotonic()
        # the uplink goes through the wire codec when there is one (a delta
        # against this round's broadcast, error-feedback residuals by cid)
        ptr = self.transport.put(f"fit-r{ins.server_round}-c{cid}-{self.node_id}", meta, arrays,
                                 compress=True, key=cid)
        wall = time.monotonic()
        put_s, wall = wall - t_put, wall - t_start
        new_state = ClientState(
            cid=cid,
            steps_cumulative=state_in.steps_cumulative + ins.local_steps,
            samples_cumulative=state_in.samples_cumulative + n_samples,
            last_round=ins.server_round,
            wall_time_s=state_in.wall_time_s + wall,
        )
        metrics = dict(metrics)
        metrics[CLIENT_PUT_TIME] = put_s
        metrics["node_training_time_s"] = wall
        return FitRes(server_round=ins.server_round, cid=cid, params=ptr, n_samples=n_samples,
                      metrics=metrics, client_state=new_state.to_dict())

    # -- eval ------------------------------------------------------------
    def evaluate(self, ins: EvaluateIns, cid: int) -> EvaluateRes:
        try:
            eval_knobs = EvaluateRoundConfig.from_dict(ins.config)  # before the compute
            meta, arrays = self._resolve_params(ins.params)
            if has_momenta(meta):
                meta, arrays, _, _ = split_momenta(meta, arrays)
            self.trainer.set_parameters(meta, arrays)
            cfg = self.cfg
            loader = self._loader(cid, cfg.dataset.split_eval, cfg.train.global_batch_size)
            loader.reset()  # every eval round scores the same fixed window
            n_batches = ins.max_batches or cfg.train.eval_batches
            batches = [next(loader) for _ in range(n_batches)]
            out = self.trainer.evaluate(batches)
            if eval_knobs.use_unigram_metrics:
                uni = self._unigram_metrics(cid, batches, out["eval/loss"])
                if not uni and not eval_knobs.allow_unigram_failures:
                    raise FileNotFoundError(
                        f"unigram freq dict missing for client {cid} and "
                        "allow_unigram_failures is False")
                out.update(uni)
            return EvaluateRes(server_round=ins.server_round, cid=cid, loss=out["eval/loss"],
                               n_samples=int(out["eval/tokens"]), metrics=out)
        except Exception as e:  # noqa: BLE001 — a failed cid is retried on another node
            return EvaluateRes(server_round=ins.server_round, cid=cid, error=self._error(e))

    def _unigram_metrics(self, cid: int, batches: list[np.ndarray],
                         model_ce: float) -> dict[str, float]:
        """Unigram-normalized eval metrics when the client's freq dict exists."""
        from photon_tpu_torch.data.unigram import FREQ_FILENAME, load_freq_dict
        from photon_tpu_torch.metrics.unigram import unigram_log_probs_from_counts

        if not self.cfg.dataset.local_path:
            return {}
        freq_path = (pathlib.Path(self.cfg.dataset.local_path) / f"client_{cid}"
                     / self.cfg.dataset.split_train / FREQ_FILENAME)
        if not freq_path.exists():
            return {}
        logp = unigram_log_probs_from_counts(load_freq_dict(freq_path), self.cfg.model.vocab_size)
        tot, n = 0.0, 0
        for b in batches:
            targets = np.asarray(b)[:, 1:]
            tot += float(-logp[targets].sum())
            n += targets.size
        uni_ce = tot / max(n, 1)
        norm = model_ce - uni_ce
        return {
            "eval/PureUnigramCrossEntropy": uni_ce,
            "eval/UnigramNormalizedLanguageCrossEntropy": norm,
            "eval/UnigramNormalizedPerplexity": float(np.exp(np.clip(norm, -30.0, 30.0))),
        }

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        self.transport.cleanup()
