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

    # a cohort's LoRA adapter (photon.adapters.enabled, the round's
    # adapter__{cohort} objects)
    curl -s localhost:8000/generate -d '{"tokens": [5, 9, 2], "cohort": "a"}'

With ``photon.serve.hotswap`` on, a watcher polls the store every
``hotswap_poll_s`` seconds and swaps each new checksum-valid round in
between requests (``serve/hotswap.py``); ``serve.prefix_cache`` and
``serve.speculative.enabled`` turn on prefix sharing and self-drafted
speculative decoding. With ``photon.adapters.enabled`` (an adapter run's
resolved YAML) every cohort's adapter is loaded beside the base, and
``cohort`` on ``/generate`` decodes through it; a hot-swap moves base and
adapters together.

A fleet replica (``serve/fleet.py``) adds ``--fleet-connect HOST:PORT
--replica-id ID`` (the two go together): it dials that router's control
port and reports its bound data port there, so N replicas started with
``--port 0`` need no port bookkeeping. A replica's hot-swap watcher runs
no loop: it polls its store only when the router's ``rolling_hotswap``
asks, so the fleet moves to a new round one replica at a time. The router (``serve/router.py``'s
``FleetRouter``) is built in code, as in the JAX package::

    router = FleetRouter(cfg.photon.serve.fleet, block_size=cfg.photon.serve.block_size)
    port = router.start()  # then start the replicas with
    # --fleet-connect 127.0.0.1:{router.control_port}, and
    router.wait_for_replicas()

The first line on stdout is one JSON object with the serving URL, the
bound port, the replica id (or null), the round, the model, the pool's
shape, which of the prefix cache and hot-swap are on, and the adapter
cohorts served (or null). SIGTERM closes the watcher, leaves the fleet,
then drains (in-flight requests finish, new ones get 503); SIGINT stops
at once.
"""

from __future__ import annotations

import argparse
import json
import signal
import threading

#: how often the main thread wakes to run a signal handler that is due
_SIGNAL_POLL_S = 0.5


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
    ap.add_argument("--fleet-connect", default=None, metavar="HOST:PORT",
                    help="dial this fleet router's control port and serve as one "
                         "replica of its fleet")
    ap.add_argument("--replica-id", default=None,
                    help="the replica's stable id for --fleet-connect (the router's "
                         "cohort pins and liveness key on it)")
    args = ap.parse_args(argv)
    if bool(args.fleet_connect) != bool(args.replica_id):
        ap.error("--fleet-connect and --replica-id go together")

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
        )
        if not args.fleet_connect:  # a replica swaps when its router asks
            watcher.start()
        frontend.watcher = watcher
    port = frontend.start()
    agent = None
    if args.fleet_connect:
        from photon_tpu_torch.serve.fleet import ReplicaAgent

        agent = ReplicaAgent(args.fleet_connect, args.replica_id, batcher=batcher,
                             frontend=frontend, watcher=watcher,
                             drain_timeout_s=sc.drain_timeout_s).start()
    print(json.dumps({
        "serving": f"http://{sc.host}:{port}",
        "port": port,
        "replica_id": args.replica_id,
        "round": engine.loaded_round,
        "model": cfg.model.name,
        "n_slots": engine.n_slots,
        "n_blocks": engine.n_blocks,
        "block_size": engine.block_size,
        "device": str(engine.device),
        "attn_impl": engine.attn_impl,
        "prefix_cache": engine.prefix_cache is not None,
        "hotswap": watcher is not None,
        "adapters": (engine.adapter_pool.cohorts()
                     if engine.adapter_pool is not None else None),
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
        # a timed wait: a signal the kernel hands to another thread (the
        # scheduler's, say) only trips a flag, and its handler runs when
        # this thread next executes; an untimed wait never would
        while not stop.wait(_SIGNAL_POLL_S):
            pass
    finally:
        if watcher is not None:  # first: no swap is staged under the drain
            watcher.close()
        if agent is not None:  # leave the fleet, so the router routes elsewhere
            agent.stop()
        if graceful.is_set():
            frontend.mark_draining()
            batcher.drain(sc.drain_timeout_s)
            frontend.close(handler_join_s=5.0)
        else:
            frontend.close()
            batcher.close()


if __name__ == "__main__":
    main()
