"""The port's presets (``photon_tpu_torch/config/presets/``) against the JAX
package's: one counterpart per case of ``tests/test_presets.py``, and
every preset loading equal to JAX's, section by section."""

import json
import math

import pytest

from photon_tpu.config import list_presets as jax_list_presets
from photon_tpu.config import load_preset as jax_load_preset
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

SECTIONS = ("model", "optimizer", "scheduler", "train")


def test_all_presets_validate():
    from photon_tpu_torch.config import list_presets, load_preset

    names = list_presets()
    assert {"mpt-125m", "mpt-350m", "mpt-760m", "mpt-1b", "mpt-3b", "mpt-7b"} <= set(names)
    for name in names:
        cfg = load_preset(name)
        assert cfg.model.d_model % cfg.model.n_heads == 0, name
        assert cfg.scheduler.t_max > 100


def test_list_presets_equals_jax():
    from photon_tpu_torch.config import list_presets

    assert list_presets() == jax_list_presets()
    assert len(list_presets()) == 8


@pytest.mark.parametrize("name", jax_list_presets())
def test_preset_sections_equal_jax(name):
    """The YAMLs are byte-for-byte copies, and each loads to the same
    model, optimizer, scheduler and train sections."""
    import pathlib

    import photon_tpu.config
    import photon_tpu_torch.config
    from photon_tpu_torch.config import load_preset

    ours = pathlib.Path(photon_tpu_torch.config.__file__).parent / "presets" / f"{name}.yaml"
    theirs = pathlib.Path(photon_tpu.config.__file__).parent / "presets" / f"{name}.yaml"
    assert ours.read_bytes() == theirs.read_bytes()
    # tuples and lists alike, as YAML writes both
    got, want = (json.loads(json.dumps(c.to_dict())) for c in (load_preset(name),
                                                              jax_load_preset(name)))
    for section in SECTIONS:
        assert got[section] == want[section], section


def test_125m_matches_reference_recipe():
    from photon_tpu_torch.config import load_preset

    cfg = load_preset("mpt-125m")
    m = cfg.model
    assert (m.d_model, m.n_layers, m.n_heads, m.max_seq_len, m.vocab_size) == \
        (768, 12, 12, 2048, 50368)
    assert cfg.optimizer.name == "adopt" and cfg.optimizer.lr == 6.0e-4
    assert cfg.train.global_batch_size == 256 and cfg.scheduler.t_max == 4800


def test_1b_matches_reference_recipe():
    from photon_tpu_torch.config import load_preset

    cfg = load_preset("mpt-1b")
    m = cfg.model
    assert (m.d_model, m.n_layers, m.n_heads) == (2048, 24, 16)
    assert m.d_head == 128  # the flash kernels' D=128 tiles
    assert m.remat  # activation checkpointing on at 1B
    assert cfg.optimizer.name == "adamw"


def test_preset_overrides_merge():
    from photon_tpu_torch.config import load_preset

    cfg = load_preset("mpt-125m", fl={"n_rounds": 10}, seed=3)
    assert cfg.fl.n_rounds == 10 and cfg.seed == 3
    assert cfg.model.d_model == 768
    want = jax_load_preset("mpt-125m", fl={"n_rounds": 10}, seed=3).to_dict()
    assert cfg.to_dict()["fl"] == want["fl"]


def test_unknown_preset_raises():
    from photon_tpu_torch.config import load_preset

    with pytest.raises(ValueError):
        load_preset("mpt-999t")


def test_moe_preset_param_count():
    """mpt-125m-moe8 holds ~530M parameters (~125M active a token), as its
    YAML says; its tree has the router and the experts in every layer."""
    from photon_tpu_torch.config import load_preset
    from photon_tpu_torch.models.mpt import param_shapes

    shapes = param_shapes(load_preset("mpt-125m-moe8").model)
    total = sum(math.prod(s) for s in shapes.values())
    assert 5.0e8 < total < 5.6e8
    assert shapes["blocks/block/moe_up"] == (12, 8, 768, 3072)
    assert shapes["blocks/block/router"] == (12, 768, 8)
