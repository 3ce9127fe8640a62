"""The port's batch prefetcher (``photon_tpu_torch/data/prefetch.py``) against
``tests/test_prefetch.py``'s cases: order, errors raised at the consumer,
bounded consumption (a resumable loader's state stays exact), ``close()``
joining the producer in the drain race and with an infinite source, and a
Trainer's ``fit`` leaving its loader exactly ``duration_steps`` batches
ahead. The prefetcher runs in every fit (``train/trainer.py``).
"""

import itertools
import time

import numpy as np
import pytest

from photon_tpu_torch.data.loader import StreamingLoader
from photon_tpu_torch.data.prefetch import PrefetchIterator
from photon_tpu_torch.data.shard_format import ShardedDataset, ShardWriter
from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread


def _range_dataset(path, n=100, seq=16, vocab=1000, per_shard=32) -> ShardedDataset:
    """Samples ``[i, i, ...]``, so a batch shows which samples it holds."""
    with ShardWriter(path, seq, vocab, per_shard) as w:
        for i in range(n):
            w.write(np.full(seq, i, np.int64))
    return ShardedDataset(path)


def test_prefetch_preserves_order():
    assert list(PrefetchIterator(iter(range(50)), depth=4)) == list(range(50))


def test_prefetch_propagates_errors():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = PrefetchIterator(gen())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        for _ in it:
            pass


def test_bounded_prefetch_leaves_loader_state_exact(tmp_path):
    ds = _range_dataset(tmp_path / "ds", n=60, seq=8)
    loader = StreamingLoader(ds, batch_size=5, seed=1)
    it = PrefetchIterator(itertools.islice(iter(loader), 4), depth=2)
    got = [next(it) for _ in range(4)]
    time.sleep(0.05)  # room for the thread to over-pull (it must not)
    assert loader.state.sample_in_epoch == 20  # exactly 4 × 5 consumed
    ref = StreamingLoader(ds, batch_size=5, seed=1)
    for _ in range(4):
        next(ref)
    np.testing.assert_array_equal(next(loader), next(ref))
    assert len(got) == 4


def test_close_joins_producer_despite_drain_race():
    """A finite source at depth 1: the producer ends its loop with the
    queue full and goes on to put its end marker; ``close()`` must still
    join it."""
    it = PrefetchIterator(iter(range(3)), depth=1)
    assert next(it) == 0
    it.close()
    assert not it._thread.is_alive(), "producer thread leaked past close()"


def test_close_with_infinite_source_and_consumer_gone():
    it = PrefetchIterator(itertools.count(), depth=2)
    assert next(it) == 0
    it.close()
    assert not it._thread.is_alive()
    it.close()  # idempotent


def test_trainer_fit_with_loader_resume_exact(tmp_path):
    """``fit`` pulls exactly ``duration_steps`` batches from a loader."""
    from photon_tpu_torch.config.schema import (
        Config,
        ModelConfig,
        OptimizerConfig,
        SchedulerConfig,
        TrainConfig,
    )
    from photon_tpu_torch.train.trainer import Trainer

    cfg = Config(model=ModelConfig(d_model=32, n_layers=2, n_heads=2, max_seq_len=16,
                                   vocab_size=64, attn_impl="xla", compute_dtype="float32"),
                 optimizer=OptimizerConfig(name="adopt", lr=1e-3),
                 scheduler=SchedulerConfig(t_warmup=2, t_max=50),
                 train=TrainConfig(global_batch_size=4, device_microbatch_size=4)).validate()
    trainer = Trainer(cfg, init_seed=0, device="cpu")
    loader = StreamingLoader(_range_dataset(tmp_path / "ds", n=64, seq=16, vocab=64),
                             batch_size=4, seed=2)
    trainer.fit(loader, duration_steps=3)
    assert loader.state.sample_in_epoch == 12
