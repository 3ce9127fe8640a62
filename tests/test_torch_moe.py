"""The port's Mixture-of-Experts (``photon_tpu_torch/ops/moe.py`` and the
MoE branches of the model, loss and decode) against the JAX package's.

CPU, fp32, router probabilities from random fp32 weights (``torch.topk``
and ``jax.lax.top_k`` may break exact ties differently; random fp32 has
none). One counterpart per single-device case of ``tests/test_moe.py``
(its expert-mesh cases wait for the port's multi-device slice; their two
activations become the JAX-vs-port loss and gradient cases here), and:

- ``route``: the same (token, expert, position) kept set as JAX's
  dispatch tensor, exactly, and the same gates and aux (2e-5), at ample
  and at tight capacity (overflow), with and without a token mask; the
  plain dense version gives the same set;
- ``moe_mlp``: the output and aux of JAX's within 2e-5, both activations,
  and equal to the dense plain version;
- a tiny moe8-shaped model (E=4, k=2, 2 layers, remat): logits, and 3
  train steps whose loss includes the aux, against JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.codec.params import flatten_params
from photon_tpu.codec.params import params_to_ndarrays as jax_to_ndarrays
from photon_tpu.config.schema import Config as JaxConfig
from photon_tpu.models.mpt import MPTModel as JaxModel
from photon_tpu.models.mpt import init_params as jax_init
from photon_tpu.ops import moe as jax_moe

torch.backends.cuda.matmul.allow_tf32 = False
#: fp32 on both sides: the frameworks sum matmuls in different orders
VALUE_ATOL = 2e-5
LOGIT_ATOL = 2e-5
#: parameters after 3 optimizer steps, relative L2 per tensor (as
#: tests/test_torch_train.py's PARAM_REL)
PARAM_REL = 2e-5
ACTS = ["gelu", "swiglu"]


def _jax_cfg(act: str = "gelu", **model) -> JaxConfig:
    """``tests/test_moe.py``'s config: d32, 2 layers, 2 heads, seq 16,
    vocab 64, 4 experts, top-2."""
    cfg = JaxConfig()
    m = cfg.model
    m.d_model, m.n_layers, m.n_heads, m.max_seq_len, m.vocab_size = 32, 2, 2, 16, 64
    m.attn_impl, m.compute_dtype = "xla", "float32"
    m.mlp, m.moe_num_experts, m.moe_top_k, m.moe_mlp_act = "moe", 4, 2, act
    for k, v in model.items():
        setattr(m, k, v)
    cfg.train.global_batch_size, cfg.train.device_microbatch_size = 8, 4
    return cfg.validate()


def _port_cfg(jcfg: JaxConfig):
    from photon_tpu_torch.config.schema import Config

    return Config.from_dict(jcfg.to_dict()).validate("cpu")


def _weights(jcfg: JaxConfig, seed=0):
    from photon_tpu_torch.codec.params import params_from_numpy

    jp = jax_init(jcfg.model, seed=seed)
    meta, arrays = jax_to_ndarrays(jp)
    return jp, params_from_numpy(meta.names, arrays, _port_cfg(jcfg).model, "cpu")


def _tokens(n, seq=16, vocab=64, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (n, seq)).astype(np.int32)


def _probs(n, e, seed=0):
    logits = np.random.default_rng(seed).standard_normal((n, e)).astype(np.float32)
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


def _kept_set(r) -> list:
    """(token, expert, position) of every kept assignment of a Routing."""
    tok = torch.arange(r.expert.shape[1]).expand_as(r.expert)
    return sorted(zip(*(t[r.kept].tolist() for t in (tok, r.expert, r.position))))


def _dense_set(dispatch) -> list:
    return sorted(map(tuple, np.argwhere(np.asarray(dispatch) > 0).tolist()))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_route_invariants():
    from photon_tpu_torch.ops.moe import route

    n, e, k, cap = 24, 4, 2, 8
    r = route(torch.from_numpy(_probs(n, e)), k, cap)
    slots = r.expert * cap + r.position
    assert len(set(slots[r.kept].tolist())) == int(r.kept.sum())  # one token per slot
    assert int(r.kept.sum(0).max()) <= k  # each token holds at most k slots
    load = torch.bincount(r.expert[r.kept], minlength=e)
    assert int(load.max()) <= cap  # per-expert load never exceeds capacity
    tok_w = r.gates.sum(0)
    kept = r.kept.any(0)
    np.testing.assert_allclose(tok_w[kept].numpy(), 1.0, atol=1e-5)
    assert float(r.aux) > 0.0  # E * sum(f * p) >= 1 at any routing


def test_route_capacity_overflow_drops_lowest_priority():
    from photon_tpu_torch.ops.moe import route

    n = 6  # all tokens prefer expert 0, capacity 2: only 2 slots filled
    probs = torch.tensor([[0.9, 0.1]]).repeat(n, 1)
    r = route(probs, 1, 2)
    assert int(r.kept.sum()) == 2 and r.kept[0, :2].all()  # the first tokens win
    assert int((r.expert[r.kept] == 1).sum()) == 0  # nobody chose expert 1
    assert float(r.gates.sum()) == pytest.approx(2.0, abs=1e-5)  # dropped: zero weight


@pytest.mark.parametrize("n,cap,k,masked", [(24, 12, 2, False), (24, 5, 2, False),
                                            (40, 6, 2, True), (40, 4, 1, True)])
def test_route_matches_jax(n, cap, k, masked):
    """The same kept set and positions as JAX's dispatch tensor, exactly;
    gates and aux within 2e-5; the dense plain version gives the same."""
    from photon_tpu_torch.ops.moe import route, route_plain

    e = 4
    probs = _probs(n, e, seed=n + cap)
    mask = (np.random.default_rng(3).random(n) > 0.3).astype(np.float32) if masked else None
    jd, jc, ja = jax_moe.route(jnp.asarray(probs), k, cap,
                               token_mask=None if mask is None else jnp.asarray(mask))
    tm = None if mask is None else torch.from_numpy(mask)
    r = route(torch.from_numpy(probs), k, cap, token_mask=tm)
    assert _kept_set(r) == _dense_set(jd)
    if cap * e < k * n:  # tight: some valid assignments overflow
        valid = torch.ones_like(r.kept) if tm is None else (tm != 0).expand_as(r.kept)
        assert bool((valid & ~r.kept).any())
    combine = np.zeros((n, e, cap), np.float32)
    for s, t in zip(*np.nonzero(r.kept.numpy())):
        combine[t, r.expert[s, t], r.position[s, t]] = float(r.gates[s, t])
    np.testing.assert_allclose(combine, np.asarray(jc), atol=VALUE_ATOL)
    assert float(r.aux) == pytest.approx(float(ja), abs=VALUE_ATOL)
    pd, pc, pa = route_plain(torch.from_numpy(probs), k, cap, token_mask=tm)
    assert _dense_set(pd.numpy()) == _kept_set(r)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=VALUE_ATOL)
    assert float(pa) == pytest.approx(float(ja), abs=VALUE_ATOL)


# ---------------------------------------------------------------------------
# the expert MLP
# ---------------------------------------------------------------------------

def test_moe_mlp_single_expert_equals_dense():
    """E=1, top-1, ample capacity: routing is the identity and the MoE MLP
    equals the plain dense FFN with the same weights."""
    from photon_tpu_torch.ops.moe import moe_mlp

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, 16), generator=g)
    w_up = torch.randn((1, 16, 32), generator=g) * 0.1
    w_down = torch.randn((1, 32, 16), generator=g) * 0.1
    out, aux = moe_mlp(x, torch.zeros((16, 1)), w_up, w_down, top_k=1, capacity_factor=1.0)
    dense = torch.nn.functional.gelu(x @ w_up[0], approximate="tanh") @ w_down[0]
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=1e-5)
    assert float(aux) == pytest.approx(1.0, abs=1e-5)  # E·f·p = 1·1·1


@pytest.mark.parametrize("cf,masked", [(1.25, False), (0.5, True)])
@pytest.mark.parametrize("act", ACTS)
def test_moe_mlp_matches_jax(act, cf, masked):
    """Output and aux against ``photon_tpu.ops.moe.moe_mlp`` within 2e-5;
    at cf 0.5 assignments overflow; the dense plain version agrees."""
    from photon_tpu_torch.ops.moe import moe_mlp, moe_mlp_plain

    rng = np.random.default_rng(7)
    d, h, e = 16, 24, 4
    x = rng.standard_normal((2, 20, d)).astype(np.float32)
    w = {"router_w": rng.standard_normal((d, e)), "w_up": rng.standard_normal((e, d, h)) * 0.2,
         "w_down": rng.standard_normal((e, h, d)) * 0.2}
    if act == "swiglu":
        w["w_gate"] = rng.standard_normal((e, d, h)) * 0.2
    w = {k: v.astype(np.float32) for k, v in w.items()}
    mask = (rng.random((2, 20)) > 0.3).astype(np.float32) if masked else None
    kw = dict(top_k=2, capacity_factor=cf)
    jo, ja = jax_moe.moe_mlp(jnp.asarray(x), **{k: jnp.asarray(v) for k, v in w.items()},
                             token_mask=None if mask is None else jnp.asarray(mask), **kw)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    tm = None if mask is None else torch.from_numpy(mask)
    po, pa = moe_mlp(torch.from_numpy(x), **tw, token_mask=tm, **kw)
    qo, qa = moe_mlp_plain(torch.from_numpy(x), **tw, token_mask=tm, **kw)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=VALUE_ATOL)
    np.testing.assert_allclose(qo.numpy(), po.numpy(), atol=VALUE_ATOL)
    assert float(pa) == pytest.approx(float(ja), abs=VALUE_ATOL) == float(qa)


# ---------------------------------------------------------------------------
# the model: config, parameters, logits, loss and gradients, training
# ---------------------------------------------------------------------------

def test_moe_validation():
    from photon_tpu_torch.config.schema import Config

    def cfg(**kw):
        d = _jax_cfg().to_dict()
        for section, vals in kw.items():
            d[section].update(vals)
        return Config.from_dict(d)

    with pytest.raises(ValueError, match="moe_num_experts >= 2"):
        cfg(model={"moe_num_experts": 1}).validate()
    with pytest.raises(ValueError, match="moe_capacity_factor must be > 0"):
        cfg(model={"moe_capacity_factor": 0.0}).validate()
    with pytest.raises(ValueError, match="moe_mlp_act"):
        cfg(model={"moe_mlp_act": "relu"}).validate()
    with pytest.raises(ValueError, match="moe_top_k"):
        cfg(model={"moe_top_k": 5}).validate()
    # JAX's expert-mesh checks: any mesh of more than one device is refused
    with pytest.raises(NotImplementedError, match="mesh"):
        cfg(mesh={"expert": 3}).validate()
    with pytest.raises(NotImplementedError, match="mesh"):
        cfg(model={"mlp": "gelu"}, mesh={"expert": 2}).validate()


@pytest.mark.parametrize("act", ACTS)
def test_moe_param_tree_matches_jax(act):
    from photon_tpu_torch.models.mpt import _init_std, init_params, param_shapes

    jcfg = _jax_cfg(act)
    jnames, jleaves = flatten_params(jax_init(jcfg.model, seed=0))
    shapes = param_shapes(_port_cfg(jcfg).model)
    assert list(shapes) == jnames
    assert [tuple(np.shape(a)) for a in jleaves] == list(shapes.values())
    # init stds: the residual std for moe_down, emb_init_std for the others
    mc = _port_cfg(jcfg).model
    resid = mc.emb_init_std / (2 * mc.n_layers) ** 0.5
    assert _init_std(mc, "blocks/block/moe_down") == pytest.approx(resid)
    for name in ("router", "moe_up") + (("moe_gate",) if act == "swiglu" else ()):
        assert _init_std(mc, f"blocks/block/{name}") == mc.emb_init_std
    from photon_tpu_torch.codec.params import flatten

    flat = flatten(init_params(mc, seed=0))
    assert abs(float(flat["blocks/block/moe_down"].std()) - resid) < 0.2 * resid


@pytest.mark.parametrize("act", ACTS)
def test_moe_logits_and_grads_match_jax(act):
    """The single-device counterpart of ``test_expert_parallel_matches_
    single_device``'s activations: logits, and the loss (CE + aux) and
    its gradients, against JAX."""
    from photon_tpu_torch.codec.params import flatten
    from photon_tpu_torch.models.mpt import MPTModel
    from photon_tpu.train.train_step import make_loss_fn as jax_loss_fn
    from photon_tpu_torch.train.train_step import make_loss_fn

    jcfg = _jax_cfg(act)
    jp, tp = _weights(jcfg)
    toks = _tokens(8)
    jm, pm = JaxModel(jcfg.model), MPTModel(_port_cfg(jcfg).model)
    with torch.no_grad():
        logits = pm(tp, torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits.numpy(), jm.apply({"params": jp}, toks), atol=LOGIT_ATOL)
    jl, jg = jax.value_and_grad(jax_loss_fn(jm, 2048))(jp, jnp.asarray(toks))
    flat = flatten(tp)
    for p in flat.values():
        p.requires_grad_(True)
    loss = make_loss_fn(pm, 2048)(tp, torch.from_numpy(toks).long())
    grads = torch.autograd.grad(loss, list(flat.values()))
    assert float(loss.detach()) == pytest.approx(float(jl), abs=1e-5)
    for (name, want), got in zip(zip(*flatten_params(jg)), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, err_msg=name)


def test_moe_aux_loss_reaches_training_loss():
    """The Switch aux term is part of the training objective: zeroing its
    weight lowers the loss."""
    from photon_tpu_torch.models.mpt import MPTModel
    from photon_tpu_torch.train.train_step import make_loss_fn

    jcfg = _jax_cfg()
    _, tp = _weights(jcfg)
    pcfg = _port_cfg(jcfg)
    toks = torch.from_numpy(_tokens(4)).long()
    with torch.no_grad():
        with_aux = float(make_loss_fn(MPTModel(pcfg.model), 2048)(tp, toks))
        pcfg.model.moe_aux_weight = 0.0
        without = float(make_loss_fn(MPTModel(pcfg.model), 2048)(tp, toks))
    assert with_aux > without


@pytest.mark.parametrize("act", ACTS)
def test_moe_train_steps_match_jax(act):
    """3 ADOPT steps with remat and 2 microbatches: the loss (with the
    aux), grad and param norms, and every parameter against JAX."""
    from photon_tpu.optim import build_optimizer as jax_build
    from photon_tpu.train.train_step import init_train_state as jax_state
    from photon_tpu.train.train_step import make_train_step as jax_step
    from photon_tpu_torch.codec.params import flatten
    from photon_tpu_torch.models.mpt import MPTModel
    from photon_tpu_torch.optim import build_optimizer
    from photon_tpu_torch.train.train_step import init_train_state, make_train_step

    jcfg = _jax_cfg(act, remat=True)
    jcfg.optimizer.lr = 1e-2
    jcfg.scheduler.t_warmup, jcfg.scheduler.t_max = 2, 20
    pcfg = _port_cfg(jcfg)
    jp, tp = _weights(jcfg)
    batches = [_tokens(8, seed=s) for s in (1, 1, 2)]
    jmodel = JaxModel(jcfg.model)
    jtx, _ = jax_build(jcfg.optimizer, jcfg.scheduler)
    jst = jax_state(jmodel, jtx, jp)
    jstep = jax.jit(jax_step(jmodel, jtx, n_microbatches=2))
    tx, _ = build_optimizer(pcfg.optimizer, pcfg.scheduler)
    st = init_train_state(tx, tp)
    step = make_train_step(MPTModel(pcfg.model), tx, n_microbatches=2)
    for b in batches:
        jst, jm = jstep(jst, jnp.asarray(b))
        st, m = step(st, torch.from_numpy(b).long())
        for key in ("loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-5, err_msg=key)
    jflat = dict(zip(*flatten_params(jst.params)))
    for name, p in flatten(st.params).items():
        want = np.asarray(jflat[name], np.float64)
        rel = np.linalg.norm(p.detach().numpy() - want) / np.linalg.norm(want)
        assert rel <= PARAM_REL, (name, rel)


def test_moe_prefill_padding_claims_no_capacity():
    """Right-padding must not displace real tokens from expert buffers: at
    tight capacity a row's prefill logits are the same whether the batch
    carries 3 or 11 padding columns."""
    from photon_tpu_torch.models.decode import prefill

    jcfg = _jax_cfg(moe_capacity_factor=1.0)  # tight: pad tokens would displace
    _, tp = _weights(jcfg)
    mc = _port_cfg(jcfg).model
    rows = np.random.default_rng(0).integers(1, 64, (2, 5))
    lengths = torch.tensor([5, 3])

    def run(pad_to):
        toks = np.zeros((2, pad_to), np.int64)
        toks[:, :5] = rows
        toks[1, 3:] = 0
        with torch.no_grad():
            return prefill(tp, torch.from_numpy(toks), lengths, mc)[0].numpy()

    np.testing.assert_allclose(run(8), run(16), atol=1e-5)


def test_moe_trains_and_capacity_is_static():
    from photon_tpu_torch.codec.params import flatten
    from photon_tpu_torch.models.mpt import MPTModel, init_params
    from photon_tpu_torch.ops.moe import expert_capacity
    from photon_tpu_torch.train.train_step import make_loss_fn

    mc = _port_cfg(_jax_cfg()).model
    params = init_params(mc, seed=0)
    leaves = list(flatten(params).values())
    opt = torch.optim.Adam([p.requires_grad_(True) for p in leaves], lr=1e-2)
    loss_fn = make_loss_fn(MPTModel(mc), 2048)
    tokens = torch.from_numpy(_tokens(8)).long()
    losses = []
    for _ in range(11):
        opt.zero_grad()
        loss = sum(loss_fn(params, mb) for mb in tokens.split(4)) / 2
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert expert_capacity(64, 4, 2, 1.25) == jax_moe.expert_capacity(64, 4, 2, 1.25) == 40
    for n, e, k, cf in ((16384, 8, 2, 1.25), (7, 3, 1, 0.3), (100, 8, 2, 1.0)):
        assert expert_capacity(n, e, k, cf) == jax_moe.expert_capacity(n, e, k, cf)

