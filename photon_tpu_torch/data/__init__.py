"""Dataset pipeline: the PTS shard format, the resumable streaming loader,
background prefetch."""

from photon_tpu_torch.data.loader import (  # noqa: F401
    ConcatDataset,
    LoaderState,
    StreamingLoader,
    make_synthetic_dataset,
)
from photon_tpu_torch.data.shard_format import ShardedDataset, ShardWriter, token_dtype  # noqa: F401
