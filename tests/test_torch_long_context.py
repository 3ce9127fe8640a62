"""Long-context training in the port: seq 4096 through the whole train step
with ring attention over a ``sequence=4`` mesh (the counterpart of
``tests/test_long_context.py``, marked ``slow`` as that case is).

The kernel-level ring tests stop at seq 64; this one trains at twice the
reference's longest sequence and must give the single-device loss
trajectory (rtol 2e-4, atol 2e-5), so the k/v rotation composes with the
chunked cross entropy, the global label shift and the optimizer at real
length. It holds the port to the JAX package's own trajectory on the same
weights too. On the card, phase 19 (a) of ``chip_smoke.py`` trains
full-width mpt-125m at seq 4096 the same way.
"""

import numpy as np
import pytest

from photon_tpu_torch.config.schema import (
    Config,
    MeshConfig,
    ModelConfig,
    OptimizerConfig,
    SchedulerConfig,
    TrainConfig,
)
from photon_tpu_torch.train.trainer import Trainer
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

SEQ = 4096
LONG = dict(d_model=32, n_layers=1, n_heads=2, max_seq_len=SEQ, vocab_size=128,
            attn_impl="xla", compute_dtype="float32")


def _cfg(mesh: MeshConfig, attn: str) -> Config:
    return Config(
        model=ModelConfig(**dict(LONG, attn_impl=attn)),
        mesh=mesh,
        optimizer=OptimizerConfig(name="adamw", lr=1e-3),
        scheduler=SchedulerConfig(t_warmup=2, t_max=100),
        train=TrainConfig(global_batch_size=2, device_microbatch_size=2),
    ).validate()


@pytest.mark.slow
def test_seq4096_ring_training_matches_single_device():
    from photon_tpu.codec.params import params_to_ndarrays as jax_to_ndarrays
    from photon_tpu.config.schema import Config as JaxConfig
    from photon_tpu.models.mpt import init_params as jax_init
    from photon_tpu.train.trainer import Trainer as JaxTrainer
    from photon_tpu_torch.codec.params import params_from_numpy

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, LONG["vocab_size"], (2, SEQ), dtype=np.int64)
    one_cfg = _cfg(MeshConfig(), "xla")
    jp = jax_init(JaxConfig.from_dict(one_cfg.to_dict()).model, seed=0)
    meta, arrays = jax_to_ndarrays(jp)

    def run(cfg: Config) -> list[float]:
        t = Trainer(cfg, params=params_from_numpy(meta.names, arrays, cfg.model), device="cpu")
        return [t.fit([tokens], duration_steps=1)["loss"] for _ in range(3)]

    ref = run(one_cfg)  # one device, full attention
    ring = run(_cfg(MeshConfig(sequence=4), "ring"))  # 4-way context parallel
    np.testing.assert_allclose(ring, ref, rtol=2e-4, atol=2e-5)
    jt = JaxTrainer(JaxConfig.from_dict(_cfg(MeshConfig(sequence=4), "ring").to_dict()), params=jp)
    jax_ring = [jt.fit([tokens], duration_steps=1)["loss"] for _ in range(3)]
    np.testing.assert_allclose(ring, jax_ring, rtol=2e-4, atol=2e-5)
    # warmup lr is 0 at the first step; by the third the batch is learned a little
    assert ref[2] < ref[0]
