"""Serving CLI — load a round checkpoint, serve it on the GPU.

Serving is opt-in (``photon.serve.enabled`` defaults to false): enable it
in the config, or pass ``--enable``. The engine runs on ``--device``
(default ``cuda``); ``--device cpu`` runs the plain PyTorch path.

Examples::

    # serve the latest round of a federated run
    python -m photon_tpu_torch.serve --config /runs/my-run/resolved.yaml \
        --enable --port 8000

    # explicit store/run/round
    python -m photon_tpu_torch.serve --preset mpt-125m --store /runs/store \
        --run my-run --round -1 --enable --port 8000

    curl -s localhost:8000/generate -d '{"tokens": [5, 9, 2], "max_new_tokens": 8}'

    # text prompts, tokenized by the server (--tokenizer byte-fallback)
    curl -s localhost:8000/generate -d '{"text": "Hello", "max_new_tokens": 8}'

With ``photon.serve.hotswap`` on, a watcher polls the store every
``hotswap_poll_s`` seconds and swaps each new checksum-valid round in
between requests (``serve/hotswap.py``); ``serve.prefix_cache`` and
``serve.speculative.enabled`` turn on prefix sharing and self-drafted
speculative decoding.

The first line on stdout is one JSON object with the serving URL, the
bound port, the round, the model, the pool's shape and which of the
prefix cache and hot-swap are on. SIGTERM closes the watcher, then
drains (in-flight requests finish, new ones get 503); SIGINT stops at
once.
"""

from __future__ import annotations

import argparse
import json
import signal
import threading


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="photon_tpu_torch.serve",
                                 description="serve a checkpoint over HTTP")
    ap.add_argument("--config", default=None, help="resolved config YAML")
    ap.add_argument("--preset", default="mpt-125m")
    ap.add_argument("--store", default=None,
                    help="object-store root (default: {photon.save_path}/store)")
    ap.add_argument("--run", default=None, help="run_uuid (default: config's)")
    ap.add_argument("--round", type=int, default=-1,
                    help="server round (negative = latest valid)")
    ap.add_argument("--enable", action="store_true",
                    help="opt in to serving when the config leaves "
                         "photon.serve.enabled=false")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tokenizer", default=None,
                    help="enable 'text' prompts (byte-fallback, the only one taken)")
    args = ap.parse_args(argv)

    from photon_tpu_torch.checkpoint import FileStore
    from photon_tpu_torch.config import load_preset
    from photon_tpu_torch.config.schema import Config
    from photon_tpu_torch.serve.engine import PagedEngine
    from photon_tpu_torch.serve.frontend import ServeFrontend
    from photon_tpu_torch.serve.scheduler import ContinuousBatcher

    cfg = Config.from_yaml(args.config) if args.config else load_preset(args.preset)
    if args.run:
        cfg.run_uuid = args.run
    sc = cfg.photon.serve
    if args.enable:
        sc.enabled = True
    if not sc.enabled:
        raise SystemExit(
            "serving is off in this config (photon.serve.enabled=false) — "
            "enable it there or pass --enable"
        )
    if args.host:
        sc.host = args.host
    if args.port is not None:
        sc.port = args.port
    cfg.validate(args.device, serving=True)
    tokenizer = None
    if args.tokenizer:
        from photon_tpu_torch.data.tokenizer import load_tokenizer

        tokenizer = load_tokenizer(args.tokenizer)

    store = FileStore(args.store) if args.store else FileStore(cfg.photon.save_path + "/store")
    engine = PagedEngine.from_checkpoint(cfg, store=store, resume_round=args.round,
                                         device=args.device)
    batcher = ContinuousBatcher(
        engine, max_queue=sc.max_queue, prefill_token_budget=sc.prefill_token_budget,
        default_eos_id=sc.eos_id if sc.eos_id >= 0 else None, speculative=sc.speculative,
    ).start()
    frontend = ServeFrontend(batcher, host=sc.host, port=sc.port,
                             max_new_tokens_cap=sc.max_new_tokens, tokenizer=tokenizer)
    watcher = None
    if sc.hotswap:
        from photon_tpu_torch.checkpoint import ServerCheckpointManager
        from photon_tpu_torch.serve.hotswap import CheckpointWatcher

        watcher = CheckpointWatcher(
            batcher, ServerCheckpointManager(store, cfg.run_uuid), cfg,
            poll_s=sc.hotswap_poll_s, statusz_url=sc.hotswap_statusz_url,
        ).start()
        frontend.watcher = watcher
    port = frontend.start()
    print(json.dumps({
        "serving": f"http://{sc.host}:{port}",
        "port": port,
        "round": engine.loaded_round,
        "model": cfg.model.name,
        "n_slots": engine.n_slots,
        "n_blocks": engine.n_blocks,
        "block_size": engine.block_size,
        "device": str(engine.device),
        "attn_impl": engine.attn_impl,
        "prefix_cache": engine.prefix_cache is not None,
        "hotswap": watcher is not None,
    }), flush=True)

    # SIGTERM = graceful drain; SIGINT (operator ^C) stops at once
    stop = threading.Event()
    graceful = threading.Event()

    def _sigterm(*_):
        graceful.set()
        stop.set()

    signal.signal(signal.SIGTERM, _sigterm)
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        if watcher is not None:  # first: no swap is staged under the drain
            watcher.close()
        if graceful.is_set():
            frontend.mark_draining()
            batcher.drain(sc.drain_timeout_s)
            frontend.close(handler_join_s=5.0)
        else:
            frontend.close()
            batcher.close()


if __name__ == "__main__":
    main()
