"""Centralized (non-federated) training.

The port of ``photon_tpu/centralized.py``: one Trainer over the whole
dataset (all client streams concatenated), optional eval-first/eval-only
modes, periodic eval and checkpoints (resumed from the latest one, in the
JAX package's client-checkpoint layout, so either package resumes the
other's run), init/final parameter dumps::

    python -m photon_tpu_torch.centralized --config resolved.yaml --steps 100
    python -m photon_tpu_torch.centralized --steps 3 --device cpu --set model.n_layers=2

It runs on ``cuda`` unless ``--device cpu`` is given. A config whose
``mesh`` is larger than one device trains over the local cards (the
Trainer's mesh; the CPU repeated under ``--device cpu``), and is refused
by ``make_mesh`` on a machine with fewer cards, as JAX refuses it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

from photon_tpu_torch.checkpoint import ClientCheckpointManager, FileStore
from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.data import (
    ConcatDataset,
    ShardedDataset,
    StreamingLoader,
    make_synthetic_dataset,
)
from photon_tpu_torch.metrics.history import History, make_wandb_run
from photon_tpu_torch.train.trainer import Trainer

CENTRAL_CID = -1  # checkpoint namespace for the centralized run


def build_dataset(cfg: Config, split: str):
    """All client streams concatenated; synthetic fallback for smoke runs."""
    root = pathlib.Path(cfg.dataset.local_path) if cfg.dataset.local_path else None
    if cfg.dataset.synthetic or root is None:
        path = pathlib.Path(cfg.photon.save_path) / "synthetic" / "central" / split
        if not (path / "index.json").exists():
            make_synthetic_dataset(
                str(path),
                n_samples=max(8 * cfg.train.global_batch_size, 256),
                seq_len=cfg.model.max_seq_len,
                vocab_size=cfg.model.vocab_size,
                seed=cfg.seed,
            )
        return ShardedDataset(path)
    client_dirs = sorted(root.glob("client_*"))
    parts = [ShardedDataset(d / split) for d in client_dirs if (d / split / "index.json").exists()]
    if not parts:
        raise FileNotFoundError(f"no client_*/{split} PTS datasets under {root}")
    return parts[0] if len(parts) == 1 else ConcatDataset(parts)


def run_centralized(
    cfg: Config,
    total_steps: int | None = None,
    eval_only: bool = False,
    eval_first: bool = False,
    eval_interval_steps: int = 0,
    checkpoint_interval_steps: int = 0,
    dump_params: bool = False,
    device: str | None = None,
) -> History:
    total_steps = total_steps if total_steps is not None else cfg.scheduler.t_max
    # config knob is the default; the CLI flag overrides
    eval_interval_steps = eval_interval_steps or cfg.train.eval_interval
    trainer = Trainer(cfg, device=device)
    history = History(make_wandb_run(cfg.wandb_project, cfg.run_uuid))
    store = FileStore(pathlib.Path(cfg.photon.save_path) / "store")
    ckpt = ClientCheckpointManager(store, cfg.run_uuid)

    train_loader = StreamingLoader(
        build_dataset(cfg, cfg.dataset.split_train),
        batch_size=cfg.train.global_batch_size,
        seed=cfg.dataset.shuffle_seed,
        shuffle=cfg.dataset.shuffle,
    )
    eval_loader = StreamingLoader(
        build_dataset(cfg, cfg.dataset.split_eval),
        batch_size=cfg.train.global_batch_size,
        seed=cfg.dataset.shuffle_seed,
        shuffle=False,
    )

    def run_eval(step: int) -> dict[str, float]:
        eval_loader.reset()  # every eval scores the same fixed window
        batches = [next(eval_loader) for _ in range(cfg.train.eval_batches)]
        m = trainer.evaluate(batches)
        history.record(step, m)
        return m

    # resume from the latest centralized checkpoint, if any
    latest = ckpt.latest_at_most(CENTRAL_CID, total_steps)
    if latest:
        pm, pa, opt, extra = ckpt.load(CENTRAL_CID, latest)
        trainer.set_parameters(pm, pa)
        if opt:
            trainer.set_opt_state_arrays(*opt)
        trainer.set_step(latest)
        if "loader" in extra:
            train_loader.load_state_dict(extra["loader"])

    if dump_params:
        _dump_params(cfg, trainer, "init")
    if eval_first or eval_only:
        m = run_eval(trainer.step)
        print(json.dumps({"eval_at": trainer.step, **{k: round(v, 5) for k, v in m.items()}}))
        if eval_only:
            return history

    save_every = checkpoint_interval_steps or max(total_steps // 10, 1)
    log_every = cfg.train.log_interval

    def _to_boundary(every: int) -> int:
        return every - trainer.step % every  # steps until the next multiple

    while trainer.step < total_steps:
        # stop each fit chunk at whichever boundary comes first — checkpoint
        # OR eval — so mid-run eval fires at its configured interval even when
        # it isn't aligned with save_every
        chunk = min(_to_boundary(save_every), total_steps - trainer.step)
        if eval_interval_steps:
            chunk = min(chunk, _to_boundary(eval_interval_steps))
        t0 = time.monotonic()
        metrics = trainer.fit(train_loader, chunk, log_every=log_every)
        metrics["train/steps_per_sec"] = chunk / (time.monotonic() - t0)
        history.record(trainer.step, metrics)
        print(json.dumps({"step": trainer.step, "loss": round(metrics.get("loss", float("nan")), 4),
                          "tokens_per_sec": round(metrics.get("client/tokens_per_sec", 0.0), 1)}))
        at_save = trainer.step % save_every == 0 or trainer.step >= total_steps
        if cfg.photon.checkpoint and at_save:
            pm, pa = trainer.get_parameters()
            om, oa = trainer.get_opt_state_arrays()
            ckpt.save(CENTRAL_CID, trainer.step, pm, pa, om, oa,
                      extra_state={"loader": train_loader.state_dict()})
            ckpt.cleanup(CENTRAL_CID, keep=cfg.photon.keep_checkpoints)
        if eval_interval_steps and trainer.step % eval_interval_steps == 0 and trainer.step < total_steps:
            run_eval(trainer.step)

    run_eval(trainer.step)
    if dump_params:
        _dump_params(cfg, trainer, "final")
    return history


def _dump_params(cfg: Config, trainer: Trainer, tag: str) -> None:
    """Init/final parameter dump, ``{save_path}/params_{tag}.npz``."""
    from photon_tpu_torch.checkpoint.serialization import arrays_to_npz

    meta, arrays = trainer.get_parameters()
    out = pathlib.Path(cfg.photon.save_path) / f"params_{tag}.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(arrays_to_npz(meta, arrays))


def main(argv: list[str] | None = None) -> History:
    """Run the CLI; returns the run's History (``client/fit_time`` and the
    loss of every checkpoint interval, the evals)."""
    ap = argparse.ArgumentParser(description="photon-tpu centralized training (PyTorch)")
    ap.add_argument("--config", help="resolved config YAML (either package writes one)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--eval-first", action="store_true")
    ap.add_argument("--eval-interval", type=int, default=0)
    ap.add_argument("--dump-params", action="store_true")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="dotted config override, repeatable, e.g. --set model.n_layers=2")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = Config.from_yaml(args.config) if args.config else Config()
    for kv in args.set:
        key, _, value = kv.partition("=")
        _apply_override(cfg, key, value)
    cfg.validate()
    pathlib.Path(cfg.photon.save_path).mkdir(parents=True, exist_ok=True)
    cfg.to_yaml(pathlib.Path(cfg.photon.save_path) / "config.yaml")
    return run_centralized(
        cfg, total_steps=args.steps, eval_only=args.eval_only, eval_first=args.eval_first,
        eval_interval_steps=args.eval_interval, dump_params=args.dump_params,
        device=args.device,
    )


def _apply_override(cfg, dotted: str, value: str) -> None:
    import yaml

    obj = cfg
    parts = dotted.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    setattr(obj, parts[-1], yaml.safe_load(value))


if __name__ == "__main__":
    main()
