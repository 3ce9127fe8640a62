"""Federated training entry point (the port of ``photon_tpu/federated.py``):
one command assembles the server, the node agents, the parameter
transport and the checkpoints, and runs the round loop::

    python -m photon_tpu_torch.federated --preset mpt-125m --nodes 2 --rounds 3
    python -m photon_tpu_torch.federated --device cpu --rounds 2 --set model.n_layers=2
    # one spawned process per node, on the objstore plane
    python -m photon_tpu_torch.federated --config run.yaml --nodes 2 --multiprocess
    # nodes on other hosts dial in (python -m photon_tpu_torch.federation.tcp --connect)
    python -m photon_tpu_torch.federated --config run.yaml --nodes 2 --tcp-listen 0.0.0.0:9777

It takes the JAX CLI's flags and prints the same final JSON line. The
nodes train on ``cuda`` unless ``--device cpu`` is given: in this process
by default, in spawned processes under ``--multiprocess``; under
``--tcp-listen`` each node's own ``--device`` decides and this process,
whose work is host work, opens no CUDA context.
"""

from __future__ import annotations

import argparse
import json
import pathlib

from photon_tpu_torch.centralized import _apply_override
from photon_tpu_torch.checkpoint import ClientCheckpointManager, FileStore, ServerCheckpointManager
from photon_tpu_torch.config import load_preset
from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.device import require_device, resolve_device
from photon_tpu_torch.federation import (
    InProcessDriver,
    MultiprocessDriver,
    NodeAgent,
    ParamTransport,
    ServerApp,
)
from photon_tpu_torch.metrics.history import History


def build_app(cfg: Config, n_nodes: int = 1, multiprocess: bool = False,
              tcp_listen: str | None = None, device: str | None = None) -> ServerApp:
    if cfg.photon.comm_stack.collective:
        raise ValueError(
            "photon.comm_stack.collective uses the multi-controller topology of "
            "photon_tpu.federation.collective_round, which is not ported"
        )
    save = pathlib.Path(cfg.photon.save_path)
    save.mkdir(parents=True, exist_ok=True)
    store = FileStore(save / "store")
    mode = "objstore" if (multiprocess or tcp_listen or cfg.photon.comm_stack.objstore) else (
        "shm" if cfg.photon.comm_stack.shm else "inline")
    if mode == "objstore":
        # normalized before the config of record is written: the node
        # processes load it and must agree on the bulk plane
        cfg.photon.comm_stack.objstore = True
        cfg.photon.comm_stack.shm = False
    cfg.to_yaml(save / "config.yaml")

    def make_transport() -> ParamTransport:
        return ParamTransport(mode, store=store, compression=cfg.photon.compression,
                              host_threads=cfg.photon.host_threads)

    if tcp_listen:
        from photon_tpu_torch.federation.tcp import TcpServerDriver

        host, _, port = tcp_listen.rpartition(":")
        driver = TcpServerDriver(host or "0.0.0.0", int(port), expected_nodes=n_nodes)
        print(f"[federated] listening on {host or '0.0.0.0'}:{driver.port}, "
              f"waiting for {n_nodes} node(s)", flush=True)
        # node hosts may take a while to come up: the fit timeout bounds it
        driver.wait_for_nodes(timeout=cfg.fl.fit_timeout_s)
    elif multiprocess:
        # checked here without a CUDA context: each node opens its own
        driver = MultiprocessDriver(cfg, n_nodes=n_nodes, device=require_device(device))
    else:
        device = str(resolve_device(device))  # fail here, not in the first node

        def make_agent(node_id: str) -> NodeAgent:
            return NodeAgent(cfg, node_id, make_transport=make_transport,
                             make_ckpt_mgr=lambda: ClientCheckpointManager(store, cfg.run_uuid),
                             device=device)

        driver = InProcessDriver(cfg, make_agent, n_nodes=n_nodes)
    ckpt = ServerCheckpointManager(store, cfg.run_uuid) if cfg.photon.checkpoint else None
    initial = None
    # a warm start applies to fresh runs only: a resume overwrites it
    if cfg.photon.init_from_run and cfg.photon.resume_round is None:
        from photon_tpu_torch.federation.server import centralized_warm_start

        initial = centralized_warm_start(store, cfg.photon.init_from_run)
    try:
        return ServerApp(cfg, driver, make_transport(), ckpt_mgr=ckpt, history=History(),
                         initial_params=initial)
    except BaseException:
        driver.shutdown()
        raise


def main(argv: list[str] | None = None) -> History:
    """Run the CLI; returns the run's History (every metric of every round:
    the final line prints four of them)."""
    ap = argparse.ArgumentParser(description="photon-tpu federated training (PyTorch)")
    ap.add_argument("--config", help="resolved config YAML (either package writes one)")
    ap.add_argument("--preset", default=None,
                    help="model preset (mpt-125m, mpt-125m-moe8, mpt-350m, mpt-760m, mpt-1b, "
                         "mpt-3b, mpt-7b, llama-1b)")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--multiprocess", action="store_true",
                    help="one spawned process per node, on the objstore plane")
    ap.add_argument("--tcp-listen", default=None, metavar="HOST:PORT",
                    help="serve the round loop over TCP; node agents join with "
                         "`python -m photon_tpu_torch.federation.tcp --connect`")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="dotted config override, repeatable, e.g. --set fl.local_steps=8")
    ap.add_argument("--device", default="cuda",
                    help="where the nodes train: cuda (default) or cpu (unused under "
                         "--tcp-listen, where each node's own --device decides)")
    args = ap.parse_args(argv)

    if args.config:
        cfg = Config.from_yaml(args.config)
    elif args.preset:
        cfg = load_preset(args.preset)
    else:
        cfg = Config()
    for kv in args.set:
        key, _, value = kv.partition("=")
        _apply_override(cfg, key, value)
    cfg.validate()

    app = build_app(cfg, n_nodes=args.nodes, multiprocess=args.multiprocess,
                    tcp_listen=args.tcp_listen, device=args.device)
    try:
        history = app.run(args.rounds)
    finally:
        app.driver.shutdown()
    final = {k: history.latest(k) for k in ("server/round_time", "server/eval_loss",
                                            "server/pseudo_grad_norm", "server/nodes_live")}
    if history.series("server/nodes_readmitted"):
        final["server/nodes_readmitted_total"] = history.cumulative("server/nodes_readmitted")
    print(json.dumps({"rounds": args.rounds or cfg.fl.n_rounds,
                      **{k: v for k, v in final.items() if v is not None}}))
    return history


if __name__ == "__main__":
    main()
