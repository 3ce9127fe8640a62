"""The plain reference against the port at a tiny size on the CPU (fp32):
the forward's logits, a training step's loss, gradients and ADOPT update,
and the serving path's next-token logits. The reference itself imports
nothing of the port; this test holds the two together."""

import torch

from perfbench import weights
from perfbench.reference import mpt as ref
from perfbench.tests import tiny

M = dict(tiny.TINY, expansion_ratio=4, emb_init_std=0.02)


def _port_cfg():
    from photon_tpu_torch.config.schema import Config

    c = tiny.cell("train.mpt-125m")
    return Config.from_dict(c.config["port"]), c


def test_forward_logits_match_the_port():
    from photon_tpu_torch.models.mpt import MPTModel

    cfg, _ = _port_cfg()
    flat = weights.make(M, 3, "cpu", torch.float32)
    tokens = torch.randint(0, 128, (2, 64), generator=torch.Generator().manual_seed(1))
    got = MPTModel(cfg.model)(weights.nest(flat), tokens)
    want = ref.logits(flat, ref.hidden_states(flat, tokens, M))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_train_steps_match_the_trainer():
    from photon_tpu_torch.codec.params import flatten
    from photon_tpu_torch.train.trainer import Trainer

    cfg, c = _port_cfg()
    flat = weights.make(M, 4, "cpu", torch.float32)
    trainer = Trainer(cfg, params=weights.nest(flat), device="cpu")
    gen = torch.Generator().manual_seed(2)
    batches = [torch.randint(0, 128, (4, 64), generator=gen) for _ in range(3)]
    losses = [float(trainer.train_batch(b.numpy())["loss"]) for b in batches]
    port = c.config["port"]
    out = ref.train_steps(flat, batches, M, port["optimizer"], port["scheduler"], 2)
    assert max(abs(a - b) for a, b in zip(losses, out["losses"])) < 1e-5
    got = flatten(trainer.state.params)
    for name, want in out["params"].items():
        torch.testing.assert_close(got[name].detach(), want, rtol=1e-5, atol=1e-6)


def test_serving_logits_match_the_port_prefill():
    from photon_tpu_torch.models.decode import prefill

    cfg, _ = _port_cfg()
    flat = weights.make(M, 5, "cpu", torch.float32)
    ids = torch.randint(0, 128, (40,), generator=torch.Generator().manual_seed(3))
    got, _ = prefill(weights.nest(flat), ids[None], torch.tensor([40]), cfg.model)
    want = ref.token_logits(flat, ids, torch.tensor([39]), M)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fp8_control_parts_from_fp32():
    flat = weights.make(M, 6, "cpu", torch.float32)
    ids = torch.randint(0, 128, (40,), generator=torch.Generator().manual_seed(4))
    at = torch.arange(39, 40)
    a = ref.token_logits(flat, ids, at, M)
    b = ref.token_logits(flat, ids, at, M, "fp8")
    assert 0 < float((a - b).abs().max()) < 0.5
