"""The port's multiprocess driver (``photon_tpu_torch.federation.driver.
MultiprocessDriver``): node agents in spawned processes over pipes, bulk
tensors on the objstore plane, every node on the CPU here.

One case for each case of ``tests/test_multiprocess_driver.py`` (a round
through one spawned node; a node killed with a request in flight comes back
as a synthesized failure at once and is started again), plus 2 rounds of
2 clients on 2 spawned nodes from the JAX init that equal the port's
in-process rounds bit for bit (the eval loss up to the order its four
results were summed in) and the JAX package's in-process rounds within
``PARAM_REL``; and the CLI's ``--multiprocess``, which writes the
normalized config of record. The JAX originals are marked ``slow``; these
run in tier-1 with every wait bounded.
"""

import contextlib
import io
import json
import time

import numpy as np
import pytest

from photon_tpu_torch.checkpoint import FileStore
from photon_tpu_torch.federation import MultiprocessDriver, ParamTransport, ServerApp
from photon_tpu_torch.federation.messages import Query
from tests.test_torch_federation import (
    EVAL_REL,
    PARAM_REL,
    _app,
    _drive,
    _jax_cfg,
    _port_cfg,
    _port_meta,
    _rel,
    _same_states,
    init_arrays,  # noqa: F401 — a module fixture
)
from tests.test_torch_tcp import make_cfg


def test_multiprocess_fed_round(tmp_path):
    cfg = make_cfg(tmp_path, n_rounds=1, n_total_clients=2, n_clients_per_round=2, local_steps=1)
    cfg.photon.comm_stack.shm, cfg.photon.comm_stack.objstore = False, True
    driver = MultiprocessDriver(cfg, n_nodes=1, device="cpu")
    app = ServerApp(cfg, driver, ParamTransport(
        "objstore", store=FileStore(cfg.photon.save_path + "/store")))
    try:
        history = app.run()
        assert history.latest("server/round_time") is not None
        assert history.latest("server/n_clients") == 2.0
    finally:
        driver.shutdown()
    assert not driver.node_ids()


def test_multiprocess_node_death_synthesizes_failure(tmp_path):
    """Kill the node with a request in flight: the reply comes back at once
    (the ping's ack if it raced through, else a synthesized failure) and
    the node is started again under its id."""
    driver = MultiprocessDriver(make_cfg(tmp_path, n_rounds=1), n_nodes=1, device="cpu")
    try:
        nid = driver.node_ids()[0]
        proc, _ = driver._nodes[nid]
        mid = driver.send(nid, Query("ping"))
        proc.terminate()
        proc.join(timeout=10)
        t0 = time.monotonic()
        got_nid, got_mid, reply = driver.recv_any(timeout=30)
        assert time.monotonic() - t0 < 20
        assert (got_nid, got_mid) == (nid, mid)
        assert driver.node_ids() == [nid]
        new_proc, _ = driver._nodes[nid]
        assert new_proc is not proc and new_proc.is_alive()
        assert driver.hello_stats() == {nid: {"reconnects": 1, "backoff_s": 0.0}}
    finally:
        driver.shutdown()


def test_multiprocess_rounds_match_in_process_and_jax(tmp_path, monkeypatch,
                                                     init_arrays):  # noqa: F811
    """2 rounds of 2 of 4 clients (FedAvg, 2 local steps, eval every round)
    from the JAX init: 2 spawned nodes give the in-process port run's
    cids, client states and bits, and the JAX package's params within
    PARAM_REL and eval loss within EVAL_REL."""
    import photon_tpu.telemetry.introspect as jax_introspect

    # the JAX server re-installs its (disabled) telemetry: a compile counter
    # an earlier test in this process left behind is not this test's to
    # unregister, and some jax versions cannot
    monkeypatch.setattr(jax_introspect, "_COMPILE_COUNTER", None)
    jax_run = _drive(_app("jax", _jax_cfg(tmp_path / "jax"), init_arrays), (1, 2))
    in_process = _drive(_app("port", _port_cfg(_jax_cfg(tmp_path / "inproc")), init_arrays),
                        (1, 2))
    cfg = _port_cfg(_jax_cfg(tmp_path / "mp"))
    cfg.photon.comm_stack.shm, cfg.photon.comm_stack.objstore = False, True
    driver = MultiprocessDriver(cfg, n_nodes=2, device="cpu")
    meta, arrays = init_arrays
    app = ServerApp(cfg, driver, ParamTransport("objstore",
                                                store=FileStore(cfg.photon.save_path + "/store")),
                    initial_params=(_port_meta(meta), arrays))
    multi = _drive(app, (1, 2))
    for rnd, (m, p, j) in enumerate(zip(multi, in_process, jax_run), start=1):
        assert m["cids"] == p["cids"] == j["cids"] and m["steps"] == 2 * rnd
        _same_states(m["client_states"], p["client_states"])
        assert all(a.tobytes() == b.tobytes() for a, b in zip(m["params"], p["params"])), rnd
        assert m["eval_loss"] == pytest.approx(p["eval_loss"], rel=1e-12, abs=0)
        assert max(_rel(a, b) for a, b in zip(m["params"], j["params"])) <= PARAM_REL
        assert abs(m["eval_loss"] - j["eval_loss"]) <= EVAL_REL * abs(j["eval_loss"])


def test_cli_multiprocess_writes_the_normalized_config(tmp_path):
    """``--multiprocess`` runs the nodes in spawned processes on the objstore
    plane, and the config of record says so (the nodes load it)."""
    from photon_tpu_torch.config.schema import Config
    from photon_tpu_torch.federated import main

    argv = ["--device", "cpu", "--rounds", "1", "--nodes", "2", "--multiprocess"]
    for s in ("model.d_model=32", "model.n_layers=2", "model.n_heads=2", "model.max_seq_len=16",
              "model.vocab_size=64", "model.compute_dtype=float32", "fl.local_steps=1",
              "fl.n_total_clients=2", "fl.n_clients_per_round=2", "train.global_batch_size=4",
              "train.device_microbatch_size=4", "dataset.synthetic=true",
              "photon.host_threads=1", "photon.compression.policy=delta_q8",
              f"photon.save_path={tmp_path / 'run'}"):
        argv += ["--set", s]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        history = main(argv)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["rounds"] == 1 and line["server/nodes_live"] == 2.0
    ratio = history.latest("server/wire_compression_ratio")
    assert ratio is not None and 3.5 < ratio < 4.0  # delta_q8: int8 + a scale a block
    written = Config.from_yaml(tmp_path / "run" / "config.yaml")
    assert written.photon.comm_stack.objstore and not written.photon.comm_stack.shm
    assert not list((tmp_path / "run" / "store" / "transport").rglob("*.npz"))
    assert np.isfinite(history.latest("server/pseudo_grad_norm"))
