"""Evaluate a checkpoint: validation loss and the ICL gauntlet.

The port of ``photon_tpu/eval/__main__.py``, with the same flags and the
same one-line JSON on stdout, plus ``--device`` (default ``cuda``; the
CPU runs only when asked for). Parameters come from a server round
checkpoint (``--store/--run/--round``), a centralized run's latest
checkpoint (``--store/--run``) or an ``.npz`` (``--params-npz``); the
aggregated momenta of a momenta-shipping run are split off. Then:

- ``--dataset``: the mean cross-entropy over ``--eval-batches`` global
  batches of a PTS root's ``client_*/{split}`` sets, through
  ``Trainer.evaluate`` (the config's ``dataset.synthetic`` is set off:
  the named set is what gets read);
- ``--tasks-yaml`` (and ``--gauntlet-yaml``): a suite of ICL tasks and
  its category-weighted gauntlet; ``--icl-tasks``: jsonl task files.

Every forward runs under ``torch.inference_mode`` at ``seq_len =
min(max_seq_len, 512)``; on the card each runs the flash forward kernel
(K1), and generation tasks decode through the contiguous KV cache::

    python -m photon_tpu_torch.eval --store /runs/store --run my-run --round -1 \\
        --config /runs/my-run/resolved.yaml --dataset /data/corpus --split val \\
        --tasks-yaml photon_tpu_torch/eval/configs/tasks_v0.3.yaml \\
        --gauntlet-yaml photon_tpu_torch/eval/configs/eval_gauntlet_v0.3.yaml \\
        --tasks-root photon_tpu/eval/local_data

``--tokenizer`` is ``byte-fallback`` (the default) or a local Hugging
Face tokenizer directory (``transformers`` needed); a hub name is refused,
since it would need a download.
"""

from __future__ import annotations

import argparse
import glob
import json
import pathlib


def load_params(args):
    """``(metadata, arrays)`` of the checkpoint the flags name, momenta
    split off."""
    from photon_tpu_torch.checkpoint import FileStore, ServerCheckpointManager
    from photon_tpu_torch.checkpoint.serialization import npz_to_arrays
    from photon_tpu_torch.train.param_ops import has_momenta, split_momenta

    if args.params_npz:
        meta, arrays = npz_to_arrays(pathlib.Path(args.params_npz).read_bytes())
    elif args.store and args.run is not None:
        store = FileStore(args.store)
        if args.round is not None:
            mgr = ServerCheckpointManager(store, args.run)
            rnd = mgr.resolve_resume_round(args.round)
            meta, arrays, _, _ = mgr.load_round(rnd)
        else:
            from photon_tpu_torch.federation.server import centralized_warm_start

            meta, arrays = centralized_warm_start(store, args.run)
    else:
        raise SystemExit("need --params-npz or --store/--run")
    if has_momenta(meta):
        meta, arrays, _, _ = split_momenta(meta, arrays)
    return meta, arrays


def main(argv: list[str] | None = None) -> dict[str, float]:
    ap = argparse.ArgumentParser(prog="photon_tpu_torch.eval", description="evaluate a checkpoint")
    src = ap.add_argument_group("checkpoint source")
    src.add_argument("--params-npz")
    src.add_argument("--store", help="object-store root")
    src.add_argument("--run", help="run_uuid inside the store")
    src.add_argument("--round", type=int, default=None, help="server round (negative = latest)")
    ap.add_argument("--preset", default="mpt-125m")
    ap.add_argument("--config", default=None, help="config YAML (overrides --preset)")
    ap.add_argument("--dataset", default=None, help="PTS root (client_*/split) for val loss")
    ap.add_argument("--split", default="val")
    ap.add_argument("--eval-batches", type=int, default=16)
    ap.add_argument("--icl-tasks", nargs="*", default=[], help="jsonl task files/globs")
    ap.add_argument("--tasks-yaml", default=None, help="icl_tasks suite YAML")
    ap.add_argument("--gauntlet-yaml", default=None,
                    help="eval_gauntlet YAML (categories/weights/baselines)")
    ap.add_argument("--tasks-root", default=None,
                    help="root_dir for dataset_uri resolution (default: the suite YAML's)")
    ap.add_argument("--icl-max-rows", type=int, default=None)
    ap.add_argument("--tokenizer", default="byte-fallback")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from photon_tpu_torch.codec.params import params_from_numpy
    from photon_tpu_torch.config import load_preset
    from photon_tpu_torch.config.schema import Config
    from photon_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    cfg = Config.from_yaml(args.config) if args.config else load_preset(args.preset)
    icl = bool(args.tasks_yaml or args.icl_tasks)
    if icl:
        from photon_tpu_torch.data.tokenizer import load_tokenizer

        tok = load_tokenizer(args.tokenizer)
        if tok.vocab_size > cfg.model.vocab_size:
            raise SystemExit(f"tokenizer vocab {tok.vocab_size} exceeds the model's "
                             f"vocab_size {cfg.model.vocab_size}")
    meta, arrays = load_params(args)
    params = params_from_numpy(meta.names, arrays, cfg.model, device)
    del arrays
    out: dict[str, float] = {}

    if args.dataset:
        from photon_tpu_torch.centralized import build_dataset
        from photon_tpu_torch.data import StreamingLoader
        from photon_tpu_torch.train.trainer import Trainer

        cfg.dataset.local_path = args.dataset
        cfg.dataset.split_eval = args.split
        cfg.dataset.synthetic = False
        trainer = Trainer(cfg, params=params, device=device)
        loader = StreamingLoader(build_dataset(cfg, args.split),
                                 batch_size=cfg.train.global_batch_size, seed=0, shuffle=False)
        out.update(trainer.evaluate([next(loader) for _ in range(args.eval_batches)]))
        del trainer

    if icl:
        from photon_tpu_torch.models.decode import compute_params
        from photon_tpu_torch.models.mpt import MPTModel

        model = MPTModel(cfg.model)
        params = compute_params(params, cfg.model, device)  # cast once, not per forward
        seq_len = min(cfg.model.max_seq_len, 512)

        def apply(p, tokens):
            return model(p, tokens)

    if args.tasks_yaml:
        from photon_tpu_torch.eval.gauntlet import run_gauntlet_suite

        out.update(run_gauntlet_suite(
            args.tasks_yaml, args.gauntlet_yaml, tok, apply, params,
            root_dir=args.tasks_root, seq_len=seq_len, max_rows=args.icl_max_rows,
            model_cfg=cfg.model,
        ))

    if args.icl_tasks:
        from photon_tpu_torch.eval.icl import ICLTask, run_gauntlet

        files: list[str] = []
        for pattern in args.icl_tasks:
            files.extend(sorted(glob.glob(pattern)))
        if not files:
            raise SystemExit(f"no task files match {args.icl_tasks}")
        out.update(run_gauntlet(
            [ICLTask.from_jsonl(f) for f in files], tok, apply, params,
            seq_len=seq_len, max_rows=args.icl_max_rows, model_cfg=cfg.model,
        ))

    print(json.dumps({k: round(float(v), 6) for k, v in out.items()}), flush=True)
    return out


if __name__ == "__main__":
    main()
