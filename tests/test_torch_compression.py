"""The port's wire codec (``photon_tpu_torch.compression``) against the JAX
package's (``photon_tpu.compression``).

One case for each case of ``tests/test_compression.py`` but its three
``quantize_jnp`` functions (their quantizer serves the collective plane,
not ported): the stages, the policies, error feedback, the container, the
config, the transport and the streaming fold, and a 3-round compressed
federated run on the CPU against an uncompressed one. Beside them:

- payloads byte-identical to ``photon_tpu.compression``'s for every
  policy, with error feedback over 3 rounds (and the residuals equal);
- a compressed pointer written by either package decodes in the other;
- ``chip_smoke.py``'s two codec gates of phase 5b, run here by the
  smoke's own functions: the round-3 update of a compressed run against an
  uncompressed one (relative L2 and cosine), which a server decode that
  scatters top-k values one index off breaks; and the per-client
  error-feedback identity (decoded = raw + residual in − residual out),
  which a server that decodes against the previous round's broadcast
  breaks.
"""

import numpy as np
import pytest

from photon_tpu.codec import ParamsMetadata as JaxMetadata
from photon_tpu.compression import Codec as JaxCodec
from photon_tpu.compression import CompressedPayload as JaxPayload
from photon_tpu.federation.transport import ParamTransport as JaxTransport
from photon_tpu_torch.codec.params import ParamsMetadata
from photon_tpu_torch.compression import (
    Codec,
    CompressedPayload,
    decode_payload,
    dequantize_q8,
    make_codec,
    quantize_q8,
    topk_sparsify,
)
from photon_tpu_torch.config.schema import CompressionConfig
from photon_tpu_torch.federation.transport import ParamTransport

def _payload_fixture(seed=0, scale=0.02, delta_scale=1e-3):
    rng = np.random.default_rng(seed)
    arrays = [
        rng.normal(0, scale, (64, 32)).astype(np.float32),
        rng.normal(0, scale, (33,)).astype(np.float32),  # not a multiple of the q8 block
        rng.normal(0, scale, (7,)).astype(np.float32),  # smaller than any block
    ]
    ref = [a + rng.normal(0, delta_scale, a.shape).astype(np.float32) for a in arrays]
    meta = ParamsMetadata.from_ndarrays(["w", "v", "b"], arrays)
    return meta, arrays, ref


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def test_quantize_q8_bounded_error():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1.0, 10_000).astype(np.float32)
    codes, scales = quantize_q8(x, block=256)
    assert codes.dtype == np.int8 and scales.dtype == np.float32
    back = dequantize_q8(codes, scales, block=256)
    grid = np.zeros(-(-x.size // 256) * 256, np.float32)
    grid[: x.size] = x
    bounds = np.repeat(np.abs(grid.reshape(-1, 256)).max(axis=1) / 254, 256)[: x.size]
    assert np.all(np.abs(x - back) <= bounds + 1e-7)


def test_quantize_q8_zero_block_exact():
    x = np.zeros(300, np.float32)
    codes, scales = quantize_q8(x, block=256)
    assert np.array_equal(dequantize_q8(codes, scales, block=256), x)


def test_topk_keeps_largest_magnitudes():
    x = np.array([0.1, -5.0, 0.01, 3.0, -0.2, 0.0, 2.0, -1.0], np.float64)
    idx, vals = topk_sparsify(x, ratio=0.5)
    assert list(idx) == [1, 3, 6, 7]
    assert np.array_equal(vals, x[[1, 3, 6, 7]])


# ---------------------------------------------------------------------------
# codec policies
# ---------------------------------------------------------------------------


def test_delta_only_roundtrip_exact():
    meta, arrays, ref = _payload_fixture()
    codec = Codec("delta")
    codec.set_reference(ref)
    payload = codec.encode(meta, arrays, key=0)
    assert payload.has_delta
    out = codec.decode(payload)
    for a, o in zip(arrays, out):
        assert o.dtype == a.dtype
        assert np.array_equal(a, o)
    assert codec.ef.residual_norm(0) == 0.0


def test_q8_policy_bounded_error():
    meta, arrays, ref = _payload_fixture()
    codec = Codec("delta_q8")
    codec.set_reference(ref)
    out = codec.decode(codec.encode(meta, arrays, key=None))
    for a, r, o in zip(arrays, ref, out):
        bound = np.abs(np.asarray(a, np.float64) - np.asarray(r, np.float64)).max() / 254
        assert np.abs(np.asarray(a, np.float64) - o).max() <= bound + 1e-9


def test_topk_q8_hits_4x_wire_reduction():
    meta, arrays, ref = _payload_fixture()
    codec = Codec("delta_topk_q8", topk_ratio=0.125)
    codec.set_reference(ref)
    payload = codec.encode(meta, arrays, key=None)
    assert payload.raw_nbytes == meta.total_bytes
    assert payload.compression_ratio >= 4.0


def test_encode_without_reference_falls_back_to_values():
    meta, arrays, _ = _payload_fixture()
    payload = Codec("delta").encode(meta, arrays, key=None)
    assert not payload.has_delta
    out = decode_payload(payload, reference=None)
    assert all(np.array_equal(a, o) for a, o in zip(arrays, out))
    with pytest.raises(RuntimeError, match="delta reference"):
        Codec("delta_topk_q8").encode(meta, arrays, key=None)


def test_error_feedback_lru_cap():
    meta, arrays, ref = _payload_fixture()
    codec = Codec("delta_q8", ef_max_clients=2)
    codec.set_reference(ref)
    for cid in (0, 1, 2):
        codec.encode(meta, arrays, key=cid)
    assert codec.ef.residual(0) is None
    assert codec.ef.residual(1) is not None and codec.ef.residual(2) is not None
    lossless = Codec("delta")
    lossless.set_reference(ref)
    lossless.encode(meta, arrays, key=0)
    assert lossless.ef.residual(0) is None


def test_error_feedback_residual_accounting():
    """residual_t = (delta_t + residual_{t-1}) − decode(encode(...)) per
    layer over two rounds, and EF delivers more of the mass than two
    independent lossy encodes."""
    meta, arrays, ref = _payload_fixture(delta_scale=5e-3)
    codec = Codec("delta_topk_q8", topk_ratio=0.25)
    codec.set_reference(ref)
    deltas = [(np.asarray(a, np.float64) - np.asarray(r, np.float64)).reshape(-1)
              for a, r in zip(arrays, ref)]

    def decoded_deltas(c, payload):
        return [(np.asarray(o, np.float64) - np.asarray(r, np.float64)).reshape(-1)
                for o, r in zip(c.decode(payload), ref)]

    decoded1 = decoded_deltas(codec, codec.encode(meta, arrays, key=7))
    res1 = codec.ef.residual(7)
    for d, dec, r in zip(deltas, decoded1, res1):
        np.testing.assert_allclose(r, d - dec, atol=1e-6)
    decoded2 = decoded_deltas(codec, codec.encode(meta, arrays, key=7))
    res2 = codec.ef.residual(7)
    for d, r1, dec2, r2 in zip(deltas, res1, decoded2, res2):
        np.testing.assert_allclose(r2, (d + r1) - dec2, atol=1e-6)
    err_with_ef = sum(float(np.abs(2 * d - (a + b)).sum())
                      for d, a, b in zip(deltas, decoded1, decoded2))
    no_ef = Codec("delta_topk_q8", topk_ratio=0.25, error_feedback=False)
    no_ef.set_reference(ref)
    dec_no_ef = decoded_deltas(no_ef, no_ef.encode(meta, arrays))
    err_no_ef = sum(float(np.abs(2 * d - 2 * a).sum()) for d, a in zip(deltas, dec_no_ef))
    assert err_with_ef < err_no_ef


def test_stale_residual_dropped_on_shape_change():
    meta, arrays, ref = _payload_fixture()
    codec = Codec("delta_q8")
    codec.set_reference(ref)
    codec.encode(meta, arrays, key=1)
    assert codec.ef.residual(1) is not None
    codec.set_reference([ref[0]])
    codec.encode(ParamsMetadata.from_ndarrays(["w"], [arrays[0]]), [arrays[0]], key=1)
    assert len(codec.ef.residual(1)) == 1


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------


def test_payload_container_roundtrip_and_versioning():
    meta, arrays, ref = _payload_fixture()
    codec = Codec("delta_topk_q8", topk_ratio=0.25)
    codec.set_reference(ref)
    payload = codec.encode(meta, arrays, key=None)
    data = payload.to_bytes()
    back = CompressedPayload.from_bytes(data)
    assert back.policy == payload.policy and back.has_delta == payload.has_delta
    assert [b.name for b in back.layers] == [b.name for b in payload.layers]
    assert all(np.array_equal(a, o) for a, o in zip(codec.decode(payload), codec.decode(back)))
    with pytest.raises(ValueError, match="magic"):
        CompressedPayload.from_bytes(b"XXXX" + data[4:])
    with pytest.raises(ValueError, match="version"):
        CompressedPayload.from_bytes(data[:4] + b"\x63\x00" + data[6:])
    with pytest.raises(ValueError, match="trailing"):
        CompressedPayload.from_bytes(data + b"\x00")


def test_make_codec_from_config():
    assert make_codec(None) is None
    assert make_codec("off") is None
    assert make_codec(CompressionConfig()) is None
    codec = make_codec(CompressionConfig(policy="delta_topk_q8", topk_ratio=0.5,
                                         q8_block_size=128, error_feedback=False))
    assert codec.policy == "delta_topk_q8"
    assert codec.topk_ratio == 0.5 and codec.q8_block == 128 and codec.ef is None


def test_compression_config_validated():
    from photon_tpu_torch.config.schema import Config

    cfg = Config()
    cfg.photon.compression.policy = "gzip"
    with pytest.raises(ValueError, match="policy"):
        cfg.validate()
    cfg.photon.compression.policy = "delta_q8"
    cfg.photon.compression.topk_ratio = 0.0
    with pytest.raises(ValueError, match="topk_ratio"):
        cfg.validate()
    cfg.photon.compression.topk_ratio = 0.125
    cfg.photon.compression.q8_block_size = 0
    with pytest.raises(ValueError, match="q8_block_size"):
        cfg.validate()


# ---------------------------------------------------------------------------
# transport integration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["inline", "shm"])
def test_transport_compressed_roundtrip(mode, tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_SHM_DIR", str(tmp_path))
    meta, arrays, ref = _payload_fixture()
    tr = ParamTransport(mode, compression=CompressionConfig(policy="delta_topk_q8",
                                                            topk_ratio=0.125))
    try:
        tr.set_reference(ref)
        ptr = tr.put("cmp-test", meta, arrays, compress=True, key=3)
        info = ptr.codec_info()
        assert info is not None and info["policy"] == "delta_topk_q8"
        assert ParamsMetadata.from_json(ptr.metadata_json).names == meta.names
        got_meta, out = tr.get(ptr)
        got_meta.validate_arrays(out)
        for a, r, o in zip(arrays, ref, out):
            assert np.abs(a - o).max() <= np.abs(a - r).max() + 1e-7
        _, payload = tr.get(ptr, decode=False)
        assert isinstance(payload, CompressedPayload)
        assert payload.compression_ratio >= 4.0
        assert tr.stats.recv_wire_bytes < tr.stats.recv_raw_bytes / 4
        raw_ptr = tr.put("raw-test", meta, arrays)
        assert raw_ptr.codec_info() is None
        _, raw_out = tr.get(raw_ptr)
        assert all(np.array_equal(a, o) for a, o in zip(arrays, raw_out))
    finally:
        tr.cleanup()


def test_transport_without_codec_rejects_compressed_pointer():
    meta, arrays, ref = _payload_fixture()
    sender = ParamTransport("inline", compression="delta_q8")
    sender.set_reference(ref)
    ptr = sender.put("x", meta, arrays, compress=True)
    with pytest.raises(RuntimeError, match="no codec"):
        ParamTransport("inline").get(ptr)


def test_aggregate_inplace_compressed_stream():
    from photon_tpu_torch.strategy.aggregation import aggregate_inplace

    meta, arrays, ref = _payload_fixture()
    codec = Codec("delta", error_feedback=False)  # lossless: exact equality
    codec.set_reference(ref)
    clients = [([a + 0.01 * i for a in arrays], 10 * (i + 1)) for i in range(3)]
    plain = aggregate_inplace(iter(clients))
    compressed = aggregate_inplace(
        iter([(codec.encode(meta, [np.float32(a) for a in arrs]), n) for arrs, n in clients]),
        decode=codec.decode)
    assert plain[1] == compressed[1]
    for a, b in zip(plain[0], compressed[0]):
        np.testing.assert_allclose(a, b, atol=1e-6)
    with pytest.raises(TypeError, match="decode"):
        aggregate_inplace(iter([(codec.encode(meta, arrays), 1)]))
    with pytest.raises(ValueError, match="accumulator"):
        aggregate_inplace(iter([(arrays, 1), (arrays[:1], 1)]))


# ---------------------------------------------------------------------------
# end-to-end federated runs (inline transport, in process, CPU)
# ---------------------------------------------------------------------------


def _fed_cfg(tmp_path, policy, **fl):
    from photon_tpu_torch.config.schema import Config

    cfg = Config()
    cfg.run_uuid = "cmp-e2e"
    m = cfg.model
    m.d_model, m.n_layers, m.n_heads, m.max_seq_len, m.vocab_size = 32, 2, 2, 16, 64
    m.compute_dtype = "float32"
    cfg.optimizer.lr = 1e-3
    cfg.scheduler.t_warmup, cfg.scheduler.t_max = 2, 1000
    cfg.train.global_batch_size, cfg.train.device_microbatch_size = 4, 4
    cfg.train.eval_batches = 2
    cfg.fl.n_total_clients, cfg.fl.n_clients_per_round, cfg.fl.n_rounds = 4, 2, 3
    cfg.fl.local_steps, cfg.fl.strategy_name, cfg.fl.sample_seed = 2, "fedavg", 99
    for k, v in fl.items():
        setattr(cfg.fl, k, v)
    cfg.photon.save_path, cfg.photon.checkpoint = str(tmp_path / "save"), False
    cfg.photon.host_threads = 1
    cfg.dataset.synthetic = True
    cfg.photon.compression.policy = policy
    cfg.photon.compression.topk_ratio = 0.125
    return cfg.validate()


def _run_fed(cfg, server_fault=None, n_nodes=2):
    """The run's final params, History and round-0 params; ``server_fault``
    patches the server's codec or transport (from outside the package)."""
    from photon_tpu_torch.federation import InProcessDriver, NodeAgent, ServerApp

    comp = cfg.photon.compression
    driver = InProcessDriver(cfg, lambda nid: NodeAgent(
        cfg, nid, lambda: ParamTransport("inline", compression=comp), device="cpu"),
        n_nodes=n_nodes)
    app = ServerApp(cfg, driver, ParamTransport("inline", compression=comp))
    initial = [a.copy() for a in app.strategy.current_parameters]
    if server_fault is not None:
        server_fault(app)
    try:
        history = app.run()
        return [a.copy() for a in app.strategy.current_parameters], history, initial
    finally:
        driver.shutdown()


def test_e2e_compressed_fedavg_matches_uncompressed(tmp_path):
    """delta+topk+q8 with error feedback stays within 1e-2 of the
    uncompressed FedAvg parameters after 3 rounds, at >= 4x less uplink."""
    p_raw, _, _ = _run_fed(_fed_cfg(tmp_path / "raw", "off"))
    p_cmp, hist, _ = _run_fed(_fed_cfg(tmp_path / "cmp", "delta_topk_q8"))
    diff = max(float(np.abs(a - b).max()) for a, b in zip(p_raw, p_cmp))
    assert diff < 1e-2, f"compressed run diverged: max param diff {diff}"
    ratio = hist.latest("server/wire_compression_ratio")
    assert ratio is not None and ratio >= 4.0, f"uplink ratio {ratio}"
    assert len(hist.series("server/wire_uplink_bytes")) == 3
    assert hist.cumulative("server/wire_uplink_bytes") * 4 <= hist.cumulative(
        "server/wire_uplink_raw_bytes")


def _chip_smoke():
    """``chip_smoke.py``, whose phase 5b gates run here on the CPU."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _gate_cfg(tmp_path):
    """The card's (b) config at a small size: 2 of 2 clients a round,
    nesterov, ``reset_optimizer``, ``delta_topk_q8`` with error feedback."""
    c = _fed_cfg(tmp_path, "delta_topk_q8", n_total_clients=2, eval_interval_rounds=0,
                 strategy_name="nesterov", fit_config={"reset_optimizer": True})
    m = c.model
    m.d_model, m.max_seq_len, m.vocab_size = 64, 64, 512
    c.train.global_batch_size = c.train.device_microbatch_size = 8
    c.fl.local_steps = 4
    return c.validate()


def test_update_gap_sees_a_shifted_scatter(tmp_path):
    """The card's update gate (``chip_smoke._update_gap`` on
    ``chip_smoke._inprocess_rounds``' runs): the round-3 update of a
    compressed run against an uncompressed one, relative L2 and cosine.
    The sound run sits inside the bounds, far from 0 (after three rounds
    of top-1/8 the residuals still hold over half of the update); a server
    decode that scatters each kept value one index off falls outside."""
    from photon_tpu_torch.codec.params import params_to_ndarrays
    from photon_tpu_torch.models.mpt import init_params

    smoke = _chip_smoke()
    cfg = _gate_cfg(tmp_path)
    initial = params_to_ndarrays(init_params(cfg.model, seed=cfg.seed))[1]
    comparator = smoke._inprocess_rounds(cfg, tmp_path, "raw", False, device="cpu")[0]
    gaps = {name: smoke._update_gap(np, smoke._inprocess_rounds(
                cfg, tmp_path, name, True, fault, device="cpu")[0], comparator, initial)
            for name, fault in (("sound", None), ("shifted", "scatter"))}
    within = {name: g["rel_l2"] <= smoke.UPDATE_REL_BOUND and g["cosine"] >= smoke.UPDATE_COS_BOUND
              for name, g in gaps.items()}
    assert within == {"sound": True, "shifted": False}, gaps
    assert gaps["sound"]["rel_l2"] > 0.5, gaps  # the codec's error shows


def test_ef_identity_gate_catches_a_stale_reference(tmp_path):
    """The card's per-client error-feedback identity gate
    (``chip_smoke._ef_identity`` through its node and server recorders):
    a sound compressed run holds it on node0's first result of every
    round, element by element within fp32 rounding; a server that pins
    the previous round's broadcast as its delta base breaks it in round 2
    (round 1 has no earlier broadcast to pin)."""
    smoke = _chip_smoke()
    cfg = _gate_cfg(tmp_path)
    runs = {"sound": smoke._inprocess_rounds(cfg, tmp_path, "sound", True, None, 2,
                                             device="cpu", ef_identity=True)[2],
            "stale": smoke._stale_reference_run(cfg, tmp_path, device="cpu")[2]}
    assert [[r["round"] for r in v] for v in runs.values()] == [[1, 2], [1, 2]], runs
    assert [[r["ok"] for r in v] for v in runs.values()] == [[True, True], [True, False]], runs
    assert runs["sound"][1]["max_err_over_tol"] <= 1.0 < runs["stale"][1]["max_err_over_tol"]


def test_error_feedback_identity_exposes_a_stale_reference():
    """What the update gap cannot see, the per-client error-feedback
    identity does: the server's decoded delta equals the client's raw
    delta plus its residual in, minus its residual out, against the same
    broadcast; decoding against the previous round's broadcast misses by
    the round's whole step."""
    meta, w1, _ = _payload_fixture(seed=1)
    rng = np.random.default_rng(2)
    client = Codec("delta_topk_q8")
    server = Codec("delta_topk_q8", error_feedback=False)
    broadcasts = [w1]
    for _ in range(2):  # the server steps the global params each round
        broadcasts.append([b + rng.normal(0, 1e-3, b.shape).astype(np.float32)
                           for b in broadcasts[-1]])
    res_in = None
    worst = {"sound": 0.0, "stale": 0.0}
    for r, bcast in enumerate(broadcasts):
        trained = [b + rng.normal(0, 1e-3, b.shape).astype(np.float32) for b in bcast]
        client.set_reference(bcast)
        payload = client.encode(meta, trained, key=0)
        res_out = client.ef.residual(0)
        raw = [(t.astype(np.float64) - b).ravel() for t, b in zip(trained, bcast)]
        want = [d + (0 if res_in is None else ri) - ro
                for d, ri, ro in zip(raw, res_in or [None] * 3, res_out)]
        for name, ref in (("sound", bcast), ("stale", broadcasts[max(r - 1, 0)])):
            server.set_reference(ref)
            got = [(o.astype(np.float64) - b).ravel() for o, b in zip(server.decode(payload), bcast)]
            err = max(float(np.linalg.norm(g - w) / np.linalg.norm(w)) for g, w in zip(got, want))
            worst[name] = max(worst[name], err)
        res_in = res_out
    assert worst["sound"] < 1e-3 and worst["stale"] > 0.1, worst


# ---------------------------------------------------------------------------
# aligned-path quantizer: identical to the padded reference, fresh arrays
# ---------------------------------------------------------------------------


def _quantize_q8_reference(values, block):
    flat = np.asarray(values, dtype=np.float32).reshape(-1)
    n = flat.size
    n_blocks = max(1, -(-n // block))
    padded = np.zeros(n_blocks * block, dtype=np.float32)
    padded[:n] = flat
    grid = padded.reshape(n_blocks, block)
    scales = (np.abs(grid).max(axis=1) / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)[:, None]
    codes = np.clip(np.rint(grid / safe), -127.0, 127.0).astype(np.int8)
    return codes.reshape(-1)[:n].copy(), scales


@pytest.mark.parametrize("n,block", [(512, 256), (256, 256), (64, 16), (1000, 256), (0, 256)],
                         ids=["aligned-2", "aligned-1", "aligned-small", "ragged", "empty"])
def test_quantize_q8_aligned_fast_path_identical(n, block):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1.0, n).astype(np.float32)
    codes, scales = quantize_q8(x, block=block)
    ref_codes, ref_scales = _quantize_q8_reference(x, block=block)
    np.testing.assert_array_equal(codes, ref_codes)
    np.testing.assert_array_equal(scales, ref_scales)
    back = dequantize_q8(codes, scales, block=block)
    padded = np.zeros(max(1, -(-n // block)) * block, np.float32)
    padded[:n] = ref_codes.astype(np.float32)
    ref_back = (padded.reshape(-1, block) * ref_scales[:, None]).reshape(-1)[:n]
    np.testing.assert_array_equal(back, ref_back)


def test_quantize_q8_aligned_returns_fresh_arrays():
    x = np.linspace(-1, 1, 512, dtype=np.float32)
    codes, _ = quantize_q8(x, block=256)
    assert not np.shares_memory(codes, x)
    codes[0] += 1
    back = dequantize_q8(codes, np.ones(2, np.float32), block=256)
    assert not np.shares_memory(back, codes)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["delta", "delta_q8", "delta_topk_q8"])
@pytest.mark.parametrize("threads", [1, 4])
def test_payload_bytes_match_jax(policy, threads):
    """The same arrays and reference, 3 rounds with error feedback for 2
    clients: every payload byte-identical to the JAX codec's, and so every
    residual; with a 4-thread host pool as serially."""
    from photon_tpu.utils.hostpool import HostPool as JaxPool
    from photon_tpu_torch.utils.hostpool import HostPool

    rng = np.random.default_rng(11)
    shapes = [(64, 48), (300,), (7,), (2, 3, 40)]
    names = ["a/w", "a/b", "c", "d/e"]
    port, jax = Codec(policy, topk_ratio=0.2, q8_block=64), JaxCodec(policy, topk_ratio=0.2,
                                                                     q8_block=64)
    pool, jpool = HostPool(threads), JaxPool(threads)
    ref = [rng.normal(0, 0.02, s).astype(np.float32) for s in shapes]
    try:
        for _ in range(3):
            port.set_reference(ref)
            jax.set_reference(ref)
            for cid in (0, 1):
                arrays = [r + rng.normal(0, 1e-3, r.shape).astype(np.float32) for r in ref]
                got = port.encode(ParamsMetadata.from_ndarrays(names, arrays), arrays,
                                  key=cid, pool=pool).to_bytes()
                want = jax.encode(JaxMetadata.from_ndarrays(names, arrays), arrays,
                                  key=cid, pool=jpool).to_bytes()
                assert got == want
                back = port.decode(CompressedPayload.from_bytes(want), pool=pool)
                for a, b in zip(back, jax.decode(JaxPayload.from_bytes(got))):
                    assert a.tobytes() == b.tobytes()
                if port.ef is not None and policy != "delta":
                    for a, b in zip(port.ef.residual(cid), jax.ef.residual(cid)):
                        assert a.tobytes() == b.tobytes()
            ref = [r + rng.normal(0, 1e-3, r.shape).astype(np.float32) for r in ref]
    finally:
        pool.close()
        jpool.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mode", ["shm", "objstore"])
def test_compressed_pointer_crosses_packages(tmp_path, monkeypatch, writer, mode):
    """A compressed fit result written by either package's transport
    decodes in the other's, to the writer's own decode, with the codec
    header and the wire accounting of the JAX package."""
    import photon_tpu.shm.plane as jax_shm
    from photon_tpu.checkpoint import FileStore as JaxStore
    from photon_tpu_torch.checkpoint import FileStore

    monkeypatch.setattr(jax_shm, "SHM_DIR", tmp_path)
    monkeypatch.setenv("PHOTON_SHM_DIR", str(tmp_path))
    meta, arrays, ref = _payload_fixture(seed=4)
    jt = JaxTransport(mode, store=JaxStore(tmp_path / "store"), compression="delta_topk_q8")
    pt = ParamTransport(mode, store=FileStore(tmp_path / "store"), compression="delta_topk_q8")
    w, r = (jt, pt) if writer == "jax" else (pt, jt)
    meta_w = JaxMetadata.from_ndarrays(meta.names, arrays) if writer == "jax" else meta
    try:
        for t in (jt, pt):
            t.set_reference(ref)
        ptr = w.put("xpkg-cmp", meta_w, arrays, compress=True, key=5)
        assert ptr.codec_info()["policy"] == "delta_topk_q8"
        own = w.get(ptr)[1]
        got_meta, got = r.get(ptr)
        assert tuple(got_meta.names) == tuple(meta.names)
        for a, b in zip(own, got):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert r.stats.recv_wire_bytes == w.stats.recv_wire_bytes < r.stats.recv_raw_bytes / 4
        w.free(ptr)
    finally:
        jt.cleanup()
        pt.cleanup()
    assert not list(tmp_path.glob("photon-xpkg*"))
    assert not list((tmp_path / "store").rglob("*.npz"))
