"""The rest of a run, the card's look left out, at a tiny size on the CPU
with the cell's own limits: a sound run is correct, and each fault the
cell can have, planted in the timed path, makes ``correct`` false. (One
card: the exchange between chips is no fault either cell can have.)"""

import pytest

from perfbench.tests import tiny


def test_train_sound():
    res = tiny.run(tiny.cell("train.mpt-125m"))
    assert res.correct, res.checks
    assert res.attempted >= 1 and res.e2e["train_tokens_per_s"] > 0
    # the first gradient is read beside the compared numbers, not compared
    assert [n for n, _, _ in res.checks] == ["loss_gap", "change_gap"]
    assert "grad_gap" in res.extra["program"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_train_fault(fault):
    res = tiny.run(tiny.cell("train.mpt-125m"), fault=fault)
    assert not res.correct, res.checks


def test_serve_sound():
    res = tiny.run(tiny.cell("serve.mpt-1b.chat"))
    assert res.correct, res.checks
    assert res.failed == 0 and res.extra["checked_tokens"] >= 20
    # the served logits themselves are compared, beside the served tokens
    assert [n for n, _, _ in res.checks] == ["logit_rel_err", "logit_gap"]
    assert 0.0 < res.extra["program"]["logit_rel_err"] < 1e-4


@pytest.mark.parametrize("fault", ["state_unchanged", "token_altered"])
def test_serve_fault(fault):
    res = tiny.run(tiny.cell("serve.mpt-1b.chat"), fault=fault)
    assert not res.correct, res.checks
