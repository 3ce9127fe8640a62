"""The port's device aggregation plane (``photon_tpu_torch/parallel/collective_agg.py``)
and its torch q8 codec (``compression/quantize_torch.py``) held to the JAX
package's (``photon_tpu/parallel/collective_agg.py`` on the 8 fake CPU
devices of ``tests/conftest.py``, ``compression/quantize_jnp.py``) on the
same numpy inputs from a seed. One case for each of
``tests/test_collective_agg.py``'s, plus the codec's parity cases.

Tolerances: averages against JAX's and against the host
``aggregate_inplace`` fold rtol 1e-5 / atol 1e-6 (fp32 sums in another
order); inside the port, replica 1 against the flat sum, the sharded plane
against the replicated one, a resharded resume and the device rules given
the same average are bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from photon_tpu.compression.quantize import quantize_q8 as jax_host_quantize
from photon_tpu.parallel import collective_agg as jca
from photon_tpu_torch.compression.quantize import dequantize_q8, quantize_q8
from photon_tpu_torch.compression.quantize_torch import dequantize_q8_torch, quantize_q8_torch
from photon_tpu_torch.parallel.collective_agg import (
    CLIENT_AXIS,
    DeviceAggregationPlane,
    collective_fedavg_round,
    collective_weighted_average,
    device_server_update,
    grouped_weighted_average,
    hierarchical_weighted_average,
    make_client_mesh,
    make_hierarchical_mesh,
    mesh_replica,
    modeled_cross_slice_bytes,
    stack_for_clients,
)
from photon_tpu_torch.strategy.aggregation import aggregate_inplace
from photon_tpu_torch.strategy.base import Strategy
from photon_tpu_torch.strategy.optimizers import FedAdam, FedAvgEff, FedMom, FedNesterov, FedYogi
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

N_CLIENTS = 4
STRATEGIES = {"fedavg": FedAvgEff, "nesterov": FedNesterov, "fedmom": FedMom,
              "fedadam": FedAdam, "fedyogi": FedYogi}
SHAPES = [(6, 20), (5,), (3, 3, 3)]
AVG_TOL = dict(rtol=1e-5, atol=1e-6)


def _client_params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}


def _strategy(name, cls=None, **kw):
    kw.setdefault("server_learning_rate", 0.5)
    kw.setdefault("server_momentum", 0.9)
    kw.setdefault("server_tau", 1e-3)
    return (cls or STRATEGIES[name])(**kw)


def _mesh(n, replica=1):
    return make_hierarchical_mesh(n, replica, device="cpu")


def _jax_avg(clients, counts, replica=1, **kw):
    mesh = jca.make_hierarchical_mesh(len(clients), replica)
    return jca.hierarchical_weighted_average(
        jca.stack_for_clients(clients, mesh), jnp.asarray(counts, jnp.int32), mesh, **kw)


def _stacked_flat(clients, mesh):
    return [torch.stack([torch.from_numpy(c[i]) for c in clients]) for i in range(len(clients[0]))]


def _round_clients(rnd, n_clients=N_CLIENTS, shapes=SHAPES):
    r = np.random.default_rng(1000 + rnd)
    clients = [[r.normal(size=s).astype(np.float32) for s in shapes] for _ in range(n_clients)]
    return clients, r.integers(1, 30, n_clients).astype(np.int32)


# -- the q8 codec ------------------------------------------------------------


@pytest.mark.parametrize("n,block", [(1024, 256), (1000, 256), (33, 16), (5, 256), (256, 256)],
                         ids=["aligned", "ragged", "ragged-small", "partial", "one-block"])
def test_quantize_torch_byte_identical_to_host_and_jnp(n, block):
    """Same int8 codes and fp32 scales as ``quantize.py`` and JAX's
    ``quantize_q8_jnp``, a ragged last block and an all-zero block (scale
    0) included; the dequantized vectors equal too."""
    from photon_tpu.compression.quantize_jnp import quantize_q8_jnp

    rng = np.random.default_rng(n * 31 + block)
    x = rng.normal(0, 0.7, n).astype(np.float32)
    if n >= 2 * block:
        x[block:2 * block] = 0.0
    x[0] = 0.5 * np.float32(np.abs(x).max()) / 127.0 * 2  # a half-way code
    codes, scales = quantize_q8(x, block=block)
    ct, st = quantize_q8_torch(torch.from_numpy(x), block)
    cj, sj = quantize_q8_jnp(x, block=block)
    assert ct.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(ct.numpy(), codes)
    np.testing.assert_array_equal(st.numpy(), scales)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(dequantize_q8_torch(ct, st, block).numpy(),
                                  dequantize_q8(codes, scales, block=block))


def test_quantize_torch_all_zero_and_half_even():
    x = np.zeros(100, np.float32)
    ct, st = quantize_q8_torch(torch.from_numpy(x), 32)
    assert not st.any() and not ct.any()
    # rint's half-to-even: 0.5 and 2.5 steps round down, 1.5 up, as numpy
    y = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5], np.float32)
    np.testing.assert_array_equal(quantize_q8_torch(torch.from_numpy(y), 8)[0].numpy(),
                                  quantize_q8(y, block=8)[0])
    with pytest.raises(ValueError, match="block"):
        quantize_q8_torch(torch.zeros(4), 0)


# -- flat path -----------------------------------------------------------------


def test_collective_average_matches_streaming_host_average():
    mesh = make_client_mesh(N_CLIENTS, device="cpu")
    clients = [_client_params(i) for i in range(N_CLIENTS)]
    n = np.asarray([10, 20, 5, 65], np.int32)
    avg = collective_weighted_average(stack_for_clients(clients, mesh), n, mesh)
    host_avg, total = aggregate_inplace(([c["b"], c["w"]], int(k)) for c, k in zip(clients, n))
    assert total == 100
    np.testing.assert_allclose(avg["w"].numpy(), host_avg[1], **AVG_TOL)
    np.testing.assert_allclose(avg["b"].numpy(), host_avg[0], **AVG_TOL)
    jmesh = jca.make_client_mesh(N_CLIENTS)
    javg = jca.collective_weighted_average(jca.stack_for_clients(clients, jmesh),
                                           jnp.asarray(n), jmesh)
    for k in ("w", "b"):
        np.testing.assert_allclose(avg[k].numpy(), np.asarray(javg[k]), **AVG_TOL)


def test_collective_fedavg_round_lr1_returns_average():
    mesh = make_client_mesh(N_CLIENTS, device="cpu")
    clients = [_client_params(10 + i) for i in range(N_CLIENTS)]
    n = [1, 1, 1, 1]
    stacked = stack_for_clients(clients, mesh)
    new = collective_fedavg_round(stacked, _client_params(99), n, mesh, server_lr=1.0)
    uniform = collective_weighted_average(stacked, n, mesh)
    np.testing.assert_allclose(new["w"].numpy(), uniform["w"].numpy(), rtol=1e-6)
    jmesh = jca.make_client_mesh(N_CLIENTS)
    jnew = jca.collective_fedavg_round(jca.stack_for_clients(clients, jmesh), _client_params(99),
                                       jnp.asarray(n, jnp.int32), jmesh, server_lr=1.0)
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(jnew["w"]), **AVG_TOL)


def test_collective_fedavg_round_lr_scales_step():
    mesh = make_client_mesh(2, device="cpu")
    clients = [{"w": np.zeros((2, 2), np.float32)}, {"w": np.full((2, 2), 2.0, np.float32)}]
    globals_ = {"w": np.full((2, 2), 4.0, np.float32)}
    # avg = 1; pseudo-grad = 3; lr 0.5 → 4 - 1.5 = 2.5
    new = collective_fedavg_round(stack_for_clients(clients, mesh), globals_, [1, 1], mesh,
                                  server_lr=0.5)
    np.testing.assert_array_equal(new["w"].numpy(), np.full((2, 2), 2.5, np.float32))


# -- hierarchical mesh ---------------------------------------------------------


def test_hierarchical_mesh_shape_and_degenerate_replica():
    mesh = make_hierarchical_mesh(2, 2, device="cpu")
    assert mesh.axis_names == (CLIENT_AXIS, "replica")
    assert mesh.shape[CLIENT_AXIS] == 2 and mesh_replica(mesh) == 2
    assert mesh_replica(make_client_mesh(2, device="cpu")) == 1
    assert all(d == torch.device("cpu") for d in mesh.devices.reshape(-1))  # repeats allowed
    with pytest.raises(ValueError, match="replica must be >= 1"):
        make_hierarchical_mesh(2, 0, device="cpu")
    with pytest.raises(ValueError, match="need 16 devices"):
        make_hierarchical_mesh(8, 2, devices=["cpu"] * 8)
    if torch.cuda.device_count() < 4:  # JAX's refusal: fewer cards than slots
        with pytest.raises(ValueError, match="need 4 devices"):
            make_hierarchical_mesh(2, 2, device="cuda")
    jmesh = jca.make_hierarchical_mesh(2, 2)
    assert dict(jmesh.shape) == mesh.shape


def test_hierarchical_off_replica1_bit_exact_vs_flat_psum():
    clients = [_client_params(40 + i) for i in range(N_CLIENTS)]
    n = [3, 9, 27, 81]
    flat = make_client_mesh(N_CLIENTS, device="cpu")
    flat_avg = collective_weighted_average(stack_for_clients(clients, flat), n, flat)
    for replica in (1, 2):  # the port's chunked sum is elementwise: any replica
        h = _mesh(N_CLIENTS, replica)
        h_avg = hierarchical_weighted_average(stack_for_clients(clients, h), n, h)
        for k in ("w", "b"):
            assert torch.equal(flat_avg[k], h_avg[k]), (replica, k)
    javg = _jax_avg(clients, n)
    for k in ("w", "b"):
        np.testing.assert_allclose(flat_avg[k].numpy(), np.asarray(javg[k]), **AVG_TOL)


@pytest.mark.parametrize("replica", [2, 4])
def test_hierarchical_off_matches_host_oracle(replica):
    n_clients = N_CLIENTS // (replica // 2)
    mesh = _mesh(n_clients, replica)
    clients = [_client_params(60 + i) for i in range(n_clients)]
    counts = np.arange(1, n_clients + 1, dtype=np.int32) * 7
    avg, total = hierarchical_weighted_average(stack_for_clients(clients, mesh), counts, mesh,
                                               return_total=True)
    host_avg, host_total = aggregate_inplace(([c["b"], c["w"]], int(k))
                                             for c, k in zip(clients, counts))
    assert int(total) == host_total
    np.testing.assert_allclose(avg["w"].numpy(), host_avg[1], **AVG_TOL)
    np.testing.assert_allclose(avg["b"].numpy(), host_avg[0], **AVG_TOL)
    javg = _jax_avg(clients, counts, replica)
    for k in ("w", "b"):
        np.testing.assert_allclose(avg[k].numpy(), np.asarray(javg[k]), **AVG_TOL)


def _expected_q8_bound(clients, counts, key, replica, block):
    """Σ_c scale_c/2 per element, the scales from the host codec over the
    chunk layout the exchange uses."""
    total = float(sum(counts))
    n = clients[0][key].size
    chunk = -(-n // (replica * block)) * block
    bound = np.zeros(replica * chunk, np.float64)
    for c, cnt in zip(clients, counts):
        contrib = np.zeros(replica * chunk, np.float32)
        contrib[:n] = (c[key].astype(np.float32) * np.float32(cnt / total)).reshape(-1)
        _, scales = quantize_q8(contrib, block=block)
        bound += np.repeat(scales.astype(np.float64), block) / 2.0
    return bound[:n].reshape(clients[0][key].shape)


@pytest.mark.parametrize("replica", [1, 2])
def test_q8_error_within_documented_blockwise_bound(replica):
    block = 16
    mesh = _mesh(N_CLIENTS, replica)
    clients = [_client_params(80 + i) for i in range(N_CLIENTS)]
    counts = np.asarray([5, 11, 2, 31], np.int32)
    stacked = stack_for_clients(clients, mesh)
    off = hierarchical_weighted_average(stacked, counts, mesh)
    q8 = hierarchical_weighted_average(stacked, counts, mesh, quantization="q8", block=block)
    jq8 = _jax_avg(clients, counts, replica, quantization="q8", block=block)
    for k in ("w", "b"):
        err = np.abs(q8[k].numpy() - off[k].numpy())
        bound = _expected_q8_bound(clients, counts, k, replica, block)
        assert (err <= bound + 1e-6).all(), (k, err.max(), bound.max())
        assert err.max() > 0
        # the same codes and scales as JAX's: only the sum order differs
        np.testing.assert_allclose(q8[k].numpy(), np.asarray(jq8[k]), **AVG_TOL)


def test_q8_all_zero_blocks_exact():
    mesh = _mesh(2, 2)
    zero = {"w": np.zeros((8, 8), np.float32)}
    q8 = hierarchical_weighted_average(stack_for_clients([zero, zero], mesh), [1, 1], mesh,
                                       quantization="q8", block=16)
    np.testing.assert_array_equal(q8["w"].numpy(), zero["w"])


def test_bad_quantization_rejected():
    mesh = make_client_mesh(2, device="cpu")
    stacked = stack_for_clients([_client_params(0), _client_params(1)], mesh)
    for kw, text in ((dict(quantization="int4"), "quantization"),
                     (dict(quantization="q8", block=0), "block")):
        with pytest.raises(ValueError, match=text):
            hierarchical_weighted_average(stacked, [1, 1], mesh, **kw)
        jmesh = jca.make_client_mesh(2)
        with pytest.raises(ValueError, match=text):
            jca.hierarchical_weighted_average(
                jca.stack_for_clients([_client_params(0), _client_params(1)], jmesh),
                jnp.asarray([1, 1], jnp.int32), jmesh, **kw)
    strat = _strategy("fedavg")
    strat.initialize([np.zeros(4, np.float32)])
    with pytest.raises(ValueError, match="block"):
        DeviceAggregationPlane(mesh, strat, quantization="q8", block=0)


def test_modeled_cross_slice_bytes_q8_ratio():
    n = 1 << 20
    fp32 = modeled_cross_slice_bytes([n], 4, quantization="off")
    q8 = modeled_cross_slice_bytes([n], 4, quantization="q8", block=256)
    assert fp32 == 4 * n * 4
    assert fp32 / q8 == pytest.approx(4 / (1 + 4 / 256))
    assert modeled_cross_slice_bytes([n], 4, replica=4, quantization="q8", block=256) == q8
    for args in (([n, 5, 777], 3, 2, "q8", 64), ([n, 5, 777], 3, 4, "off", 256)):
        assert modeled_cross_slice_bytes(*args) == jca.modeled_cross_slice_bytes(*args)


def test_modeled_cross_slice_bytes_padding_accounted():
    assert modeled_cross_slice_bytes([5], 1, quantization="q8", block=256) == 256 + 4
    assert modeled_cross_slice_bytes([5], 1, quantization="off") == 20


# -- the device server optimizers --------------------------------------------------


def _rounds_parity(name, quantization, replica, n_rounds=3, seed=5):
    """The host oracle and the device plane side by side: returns max
    |param delta| over the rounds (and the JAX plane's gap to the port's)."""
    rng = np.random.default_rng(seed)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    host = _strategy(name)
    host.initialize([p.copy() for p in init])
    dev = _strategy(name)
    dev.initialize([p.copy() for p in init])
    mesh = _mesh(N_CLIENTS, replica)
    plane = DeviceAggregationPlane(mesh, dev, quantization=quantization)
    jmesh = jca.make_hierarchical_mesh(N_CLIENTS, replica)
    jstrat = _strategy(name, cls=getattr(__import__("photon_tpu.strategy.optimizers",
                                                    fromlist=["x"]),
                                         STRATEGIES[name].__name__))
    jstrat.initialize([p.copy() for p in init])
    jplane = jca.DeviceAggregationPlane(jmesh, jstrat, quantization=quantization)
    max_d = 0.0
    for rnd in range(1, n_rounds + 1):
        clients = [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
                   for _ in range(N_CLIENTS)]
        counts = rng.integers(1, 50, N_CLIENTS).astype(np.int32)
        avg, total = aggregate_inplace((c, int(k)) for c, k in zip(clients, counts))
        host_metrics = host.apply_average(rnd, avg, int(total), N_CLIENTS)
        metrics = plane.run_round(_stacked_flat(clients, mesh), counts,
                                  lr=host.effective_lr(N_CLIENTS))
        jstacked = jca.stack_for_clients([{f"x{i}": a for i, a in enumerate(c)} for c in clients],
                                         jmesh)
        jplane.run_round([jstacked[f"x{i}"] for i in range(len(SHAPES))],
                         jax.device_put(counts, NamedSharding(jmesh, P("clients"))),
                         lr=host.effective_lr(N_CLIENTS))
        assert metrics["server/n_samples"] == float(total)
        if quantization == "off":
            for key in ("server/param_norm", "server/pseudo_grad_norm"):
                np.testing.assert_allclose(metrics[key], host_metrics[key], rtol=1e-4)
        for a, b in zip(host.current_parameters, plane.params_host()):
            max_d = max(max_d, float(np.abs(a - b).max()))
    jgap = max(float(np.abs(a - b).max())
               for a, b in zip(plane.params_host(), jplane.params_host()))
    return max_d, host, plane, jgap


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_device_plane_matches_host_oracle_all_strategies(name):
    max_d, host, plane, jgap = _rounds_parity(name, "off", replica=2)
    assert max_d < 1e-5, f"{name}: device path diverged by {max_d}"
    assert jgap < 1e-5, f"{name}: the port's plane parts from JAX's by {jgap}"
    for key in host.state_keys:
        for a, b in zip(host.state[key], plane.state_host()[key]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_device_update_rule_bit_exact_given_same_average(name):
    """Given the host rule's pseudo-gradients the device rule's parameters
    equal the host's bit for bit over 3 stateful steps (and JAX's rule)."""
    rng = np.random.default_rng(11)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    host = _strategy(name)
    host.initialize([p.copy() for p in init])
    params = [torch.from_numpy(p.copy()) for p in init]
    jparams = [jnp.asarray(p) for p in init]
    state = {k: [torch.zeros_like(p) for p in params] for k in host.state_keys}
    jstate = {k: [jnp.zeros_like(p) for p in jparams] for k in host.state_keys}
    for t in range(1, 4):
        grads = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
        host_params = host.server_update([g.copy() for g in grads], 0.5)
        host.current_parameters = host_params
        b1t = 1.0 - host.beta_1 ** t if hasattr(host, "beta_1") else 1.0
        b2t = 1.0 - host.beta_2 ** t if hasattr(host, "beta_2") else 1.0
        params, state = device_server_update(
            name, params, [torch.from_numpy(g) for g in grads], state, 0.5, b1t, b2t,
            momentum=0.9, beta_1=0.9, beta_2=0.99, tau=1e-3)
        jparams, jstate = jca.device_server_update(
            name, jparams, [jnp.asarray(g) for g in grads], jstate, jnp.float32(0.5),
            jnp.float32(b1t), jnp.float32(b2t), momentum=0.9, beta_1=0.9, beta_2=0.99, tau=1e-3)
        for a, b, c in zip(host_params, params, jparams):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=f"{name} t={t}")
            np.testing.assert_allclose(b.numpy(), np.asarray(c), rtol=1e-6, atol=1e-7)


def test_device_plane_q8_stays_near_off():
    _, _, plane_off, _ = _rounds_parity("fedavg", "off", replica=2, seed=9)
    _, _, plane_q8, jgap = _rounds_parity("fedavg", "q8", replica=2, seed=9)
    assert jgap < 1e-5
    for a, b in zip(plane_off.params_host(), plane_q8.params_host()):
        assert float(np.abs(a - b).max()) < 5e-2


def test_device_plane_rejects_unknown_strategy_and_bad_payload():
    mesh = _mesh(2, 1)
    base = Strategy()
    base.initialize([np.zeros(4, np.float32)])
    with pytest.raises(ValueError, match="no device update rule"):
        DeviceAggregationPlane(mesh, base)
    strat = _strategy("fedavg")
    strat.initialize([np.zeros(4, np.float32)])
    plane = DeviceAggregationPlane(mesh, strat)
    with pytest.raises(ValueError, match="momenta mismatch"):
        plane.run_round([torch.zeros(2, 4), torch.zeros(2, 4)], [1, 1], lr=1.0)
    with pytest.raises(ValueError, match="repack the client mesh"):
        plane.run_round([torch.zeros(3, 4)], [1, 1, 1], lr=1.0)


def test_device_plane_nonneg_rows_clamped_on_q8_only():
    mesh = _mesh(2, 1)
    rng = np.random.default_rng(33)
    w = rng.normal(size=(6, 20)).astype(np.float32)
    m2 = np.full((5,), 1e-4, np.float32)
    clients = [[rng.normal(size=w.shape).astype(np.float32), np.zeros_like(m2)]
               for _ in range(2)]

    def one_round(quantization, nonneg_rows):
        strat = _strategy("fedadam")
        strat.initialize([w.copy(), m2.copy()])
        plane = DeviceAggregationPlane(mesh, strat, quantization=quantization,
                                       nonneg_rows=nonneg_rows)
        plane.run_round(_stacked_flat(clients, mesh), [1, 1], lr=0.5)
        return plane.params_host()[1]

    assert float(one_round("q8", ()).min()) < 0.0
    assert float(one_round("q8", (1,)).min()) >= 0.0
    assert float(one_round("off", (1,)).min()) < 0.0
    strat = _strategy("fedadam")
    strat.initialize([w.copy(), m2.copy()])
    with pytest.raises(ValueError, match="nonneg_rows out of range"):
        DeviceAggregationPlane(mesh, strat, nonneg_rows=(2,))


def test_fedadam_checkpoint_resume_bias_correction_continuity():
    rng = np.random.default_rng(21)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    mesh = _mesh(N_CLIENTS, 2)

    def make_plane(params, state=None):
        strat = _strategy("fedadam")
        strat.initialize(params, state)
        return strat, DeviceAggregationPlane(mesh, strat)

    strat_c, plane_c = make_plane([p.copy() for p in init])
    for rnd in range(1, 4):
        clients, counts = _round_clients(rnd)
        plane_c.run_round(_stacked_flat(clients, mesh), counts, lr=0.5)
    strat_a, plane_a = make_plane([p.copy() for p in init])
    for rnd in range(1, 3):
        clients, counts = _round_clients(rnd)
        plane_a.run_round(_stacked_flat(clients, mesh), counts, lr=0.5)
    plane_a.sync_strategy(strat_a)
    assert strat_a._t == 2
    ckpt = strat_a.state_for_checkpoint()
    assert "_t" in ckpt
    strat_b, plane_b = make_plane([p.copy() for p in strat_a.current_parameters], ckpt)
    assert plane_b.t == 2
    clients, counts = _round_clients(3)
    plane_b.run_round(_stacked_flat(clients, mesh), counts, lr=0.5)
    for a, b in zip(plane_c.params_host(), plane_b.params_host()):
        np.testing.assert_array_equal(a, b)
    for key in ("momentum_1", "momentum_2"):
        for a, b in zip(plane_c.state_host()[key], plane_b.state_host()[key]):
            np.testing.assert_array_equal(a, b)


# -- ZeRO-1 ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(STRATEGIES))
@pytest.mark.parametrize("quantization", ["off", "q8"])
def test_sharded_plane_bit_exact_vs_replicated(name, quantization):
    rng = np.random.default_rng(7)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    mesh = _mesh(N_CLIENTS, 2)

    def make_plane(sharded):
        strat = _strategy(name)
        strat.initialize([p.copy() for p in init])
        return DeviceAggregationPlane(mesh, strat, quantization=quantization, block=16,
                                      sharded=sharded)

    ps, pr = make_plane(True), make_plane(False)
    assert ps.shard_fraction() < 1.0 <= pr.shard_fraction()
    assert ps.server_state_bytes_per_rank() < pr.server_state_bytes_per_rank()
    for rnd in range(1, 4):
        clients, counts = _round_clients(rnd)
        ms = ps.run_round(_stacked_flat(clients, mesh), counts, lr=0.5)
        mr = pr.run_round(_stacked_flat(clients, mesh), counts, lr=0.5)
        assert ms["server/n_samples"] == mr["server/n_samples"]
        np.testing.assert_allclose(ms["server/pseudo_grad_norm"],
                                   mr["server/pseudo_grad_norm"], rtol=1e-4)
    for a, b in zip(ps.params_host(), pr.params_host()):
        np.testing.assert_array_equal(a, b)
    for key in ps.state_keys:
        for a, b in zip(ps.state_host()[key], pr.state_host()[key]):
            np.testing.assert_array_equal(a, b)
    # the same per-rank bytes as JAX's plane
    jstrat = _strategy("fedavg", cls=__import__("photon_tpu.strategy.optimizers",
                                                fromlist=["x"]).FedAvgEff)
    jstrat.initialize([p.copy() for p in init])
    mine = _strategy("fedavg")
    mine.initialize([p.copy() for p in init])
    jp = jca.DeviceAggregationPlane(jca.make_hierarchical_mesh(N_CLIENTS, 2), jstrat,
                                    quantization=quantization, block=16)
    assert (DeviceAggregationPlane(mesh, mine, quantization=quantization, block=16)
            .server_state_bytes_per_rank() == jp.server_state_bytes_per_rank())


@pytest.mark.parametrize("quantization", ["off", "q8"])
@pytest.mark.parametrize("save_replica,resume_replica", [(4, 1), (1, 4)])
def test_sharded_checkpoint_bit_exact_across_resharding(quantization, save_replica,
                                                        resume_replica):
    rng = np.random.default_rng(3)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]

    def make_plane(replica, params, state=None):
        strat = _strategy("fedadam")
        strat.initialize(params, state)
        mesh = _mesh(2, replica)
        return strat, DeviceAggregationPlane(mesh, strat, quantization=quantization, block=16), mesh

    def run(plane, mesh, rnd):
        clients, counts = _round_clients(rnd, 2)
        plane.run_round(_stacked_flat(clients, mesh), counts, lr=0.5)

    _, plane_c, mesh_c = make_plane(save_replica, [p.copy() for p in init])
    for rnd in range(1, 4):
        run(plane_c, mesh_c, rnd)
    strat_a, plane_a, mesh_a = make_plane(save_replica, [p.copy() for p in init])
    for rnd in range(1, 3):
        run(plane_a, mesh_a, rnd)
    plane_a.sync_strategy(strat_a)
    assert strat_a._t == 2
    _, plane_b, mesh_b = make_plane(resume_replica, [p.copy() for p in strat_a.current_parameters],
                                    strat_a.state_for_checkpoint())
    assert plane_b.t == 2
    run(plane_b, mesh_b, 3)
    for a, b in zip(plane_c.params_host(), plane_b.params_host()):
        np.testing.assert_array_equal(a, b)
    for key in ("momentum_1", "momentum_2"):
        for a, b in zip(plane_c.state_host()[key], plane_b.state_host()[key]):
            np.testing.assert_array_equal(a, b)


def test_sharded_seeding_peak_host_rss_bounded():
    """Seeding copies each rank's chunk from a view of the host leaf and
    zero-fills missing state on the device: no padded host copy of a leaf
    (numpy's allocations, which tracemalloc sees, stay under one chunk)."""
    import tracemalloc

    replica = 4
    leaf = np.zeros((512, 2048), np.float32)
    chunk_bytes = leaf.nbytes // replica
    strat = _strategy("fedadam")
    strat.initialize([leaf.copy()])
    strat.state.clear()
    mesh = _mesh(2, replica)
    tracemalloc.start()
    plane = DeviceAggregationPlane(mesh, strat, sharded=True)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert float(np.abs(plane.state_host()["momentum_1"][0]).max()) == 0.0
    assert peak < chunk_bytes, peak
    assert [c.numel() for c in plane.params[0]] == [leaf.size // replica] * replica


def test_sharded_update_leg_no_steady_state_compiles():
    """Torch does not retrace: from round 2 the sharded round, its gather
    and the state mirror build or load no kernel library (the port's
    sentinel counts those)."""
    from photon_tpu_torch.analysis.runtime import retrace_guard

    rng = np.random.default_rng(41)
    mesh = _mesh(N_CLIENTS, 2)
    strat = _strategy("fedadam")
    strat.initialize([rng.normal(size=s).astype(np.float32) for s in SHAPES])
    plane = DeviceAggregationPlane(mesh, strat, sharded=True)

    def one_round(rnd):
        clients, counts = _round_clients(rnd)
        plane.run_round(_stacked_flat(clients, mesh), counts, lr=0.5)
        plane.params_host()
        plane.state_host()

    one_round(1)
    with retrace_guard(steady=True):
        one_round(2)
        one_round(3)
    assert plane.last_allgather_s > 0.0


def test_sharded_snapshot_restore_and_abandon_epoch():
    rng = np.random.default_rng(55)
    mesh = _mesh(N_CLIENTS, 2)
    strat = _strategy("fedadam")
    strat.initialize([rng.normal(size=s).astype(np.float32) for s in SHAPES])
    plane = DeviceAggregationPlane(mesh, strat, sharded=True)
    clients, counts = _round_clients(1)
    plane.run_round(_stacked_flat(clients, mesh), counts, lr=0.5)
    before = plane.params_host()
    snap = plane.snapshot()
    clients2, counts2 = _round_clients(2)
    plane.run_round(_stacked_flat(clients2, mesh), counts2, lr=0.5)
    assert plane.t == 2
    plane.abandon()
    plane.restore(snap)
    assert plane.t == 1
    for a, b in zip(before, plane.params_host()):
        np.testing.assert_array_equal(a, b)
    plane.run_round(_stacked_flat(clients2, mesh), counts2, lr=0.5, epoch=0)
    assert plane.t == 1
    for a, b in zip(before, plane.params_host()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quantization", ["off", "q8"])
def test_average_program_cached_no_steady_state_compiles(quantization):
    from photon_tpu_torch.analysis.runtime import retrace_guard

    mesh = _mesh(N_CLIENTS, 2)
    stacked = stack_for_clients([_client_params(70 + i) for i in range(N_CLIENTS)], mesh)
    kw = dict(quantization=quantization, block=16)
    first = hierarchical_weighted_average(stacked, [1, 2, 3, 4], mesh, **kw)
    with retrace_guard(steady=True):
        for _ in range(3):
            again = hierarchical_weighted_average(stacked, [1, 2, 3, 4], mesh, **kw)
    assert all(torch.equal(first[k], again[k]) for k in first)


@pytest.mark.parametrize("quantization", ["off", "q8"])
def test_device_plane_round_no_steady_state_compiles(quantization):
    from photon_tpu_torch.analysis.runtime import retrace_guard

    rng = np.random.default_rng(31)
    mesh = _mesh(N_CLIENTS, 2)
    strat = _strategy("fedadam")
    strat.initialize([rng.normal(size=s).astype(np.float32) for s in SHAPES])
    plane = DeviceAggregationPlane(mesh, strat, quantization=quantization, block=16)
    for rnd in (1, 2, 3):
        clients, counts = _round_clients(rnd)
        if rnd == 2:
            guard = retrace_guard(steady=True)
            guard.__enter__()
        plane.run_round(_stacked_flat(clients, mesh), counts, lr=0.5)
    guard.__exit__(None, None, None)
    assert plane.t == 3


# -- grouped and discounted ---------------------------------------------------------------


@pytest.mark.parametrize("quantization,replica", [("off", 1), ("off", 2), ("q8", 2)])
def test_grouped_average_matches_jax_and_per_cohort_average(quantization, replica):
    """Per-cohort averages in one exchange: each cohort's slot equals the
    plain average over its members (bit for bit at ``off``) and JAX's
    grouped program; a cohort with no member totals 0."""
    rng = np.random.default_rng(17)
    clients = [[rng.normal(size=s).astype(np.float32) for s in SHAPES] for _ in range(N_CLIENTS)]
    counts = np.asarray([3, 8, 5, 2], np.int32)
    onehot = np.zeros((N_CLIENTS, 3), np.float32)
    onehot[[0, 2], 0] = 1.0
    onehot[[1], 1] = 1.0  # cohort 2 empty, client 3 in none
    mesh = _mesh(N_CLIENTS, replica)
    avgs, totals = grouped_weighted_average(_stacked_flat(clients, mesh), counts, onehot, mesh,
                                            quantization=quantization, block=16)
    np.testing.assert_array_equal(totals.numpy(), [8.0, 8.0, 0.0])
    jmesh = jca.make_hierarchical_mesh(N_CLIENTS, replica)
    js = jca.stack_for_clients([{f"x{i}": a for i, a in enumerate(c)} for c in clients], jmesh)
    sh = NamedSharding(jmesh, P("clients"))
    javgs, jtot = jca.grouped_weighted_average(
        [js[f"x{i}"] for i in range(len(SHAPES))], jax.device_put(counts, sh),
        jax.device_put(onehot, sh), jmesh, quantization=quantization, block=16)
    np.testing.assert_array_equal(totals.numpy(), np.asarray(jtot))
    for a, j in zip(avgs, javgs):
        np.testing.assert_allclose(a.numpy(), np.asarray(j), **AVG_TOL)
    if quantization == "off":
        for k, members in ((0, [0, 2]), (1, [1])):
            sub = _mesh(len(members), replica)
            plain = hierarchical_weighted_average(
                _stacked_flat([clients[c] for c in members], sub), counts[members], sub)
            for a, p in zip(avgs, plain):
                np.testing.assert_allclose(a[k].numpy(), p.numpy(), **AVG_TOL)
        assert all(not a[2].any() for a in avgs)


def test_discounted_average_and_weights_match_jax():
    from photon_tpu_torch.parallel.collective_agg import (
        discounted_fold_weights,
        discounted_weighted_average,
        staleness_discount,
    )

    for s, pol, pw in (([0, 1, 3], "poly", 1.0), ([0, 2, 5], "poly", 0.5), ([4, 0, 1], "const", 1.0)):
        np.testing.assert_array_equal(staleness_discount(s, pol, pw),
                                      jca.staleness_discount(s, pol, pw))
        w = discounted_fold_weights([4, 6, 8], s, pol, pw)
        jw = jca.discounted_fold_weights([4, 6, 8], s, pol, pw)
        assert w.dtype == jw.dtype
        np.testing.assert_array_equal(w, jw)
    clients = [_client_params(i) for i in range(3)]
    mesh = _mesh(3, 2)
    avg, total = discounted_weighted_average(stack_for_clients(clients, mesh), [4, 6, 8],
                                             [0, 1, 3], mesh, return_total=True)
    jmesh = jca.make_hierarchical_mesh(3, 2)
    javg, jtotal = jca.discounted_weighted_average(jca.stack_for_clients(clients, jmesh),
                                                   [4, 6, 8], [0, 1, 3], jmesh, return_total=True)
    np.testing.assert_allclose(float(total), float(np.asarray(jtotal)), rtol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(avg[k].numpy(), np.asarray(javg[k]), **AVG_TOL)
    # zero staleness: the plain average, bit for bit
    plain = hierarchical_weighted_average(stack_for_clients(clients, mesh), [4, 6, 8], mesh)
    zero = discounted_weighted_average(stack_for_clients(clients, mesh), [4, 6, 8], [0, 0, 0],
                                       mesh)
    assert all(torch.equal(plain[k], zero[k]) for k in plain)
