"""Dataset constants: the mC4 multilingual catalog, as a table.

The port of ``photon_tpu/data/constants.py``: per language, the Hugging
Face coordinates of each convertible split and the truncation sizes of
the English convenience splits. Using an entry means reading the dataset
over the network, which this package does not do, so
``photon_tpu_torch.data.convert --dataset-key`` refuses; the table is
here for what reads it offline (and its tests).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

TRAIN = "train"
TRAIN_SMALL = "train_small"
VALIDATION = "validation"
VAL = "val"
VAL_SMALL = "val_small"
VAL_XSMALL = "val_xsmall"
VAL_XXSMALL = "val_xxsmall"

C4_PATH = "allenai/c4"


@dataclass(frozen=True)
class DataSplitConstants:
    """One convertible split."""

    path: str  # HF dataset path
    name: str  # HF config name (the language code for mC4)
    split: str  # HF split to read
    folder_split: str  # output folder name (and the --hf-split key)
    truncated_samples: int | None = None  # cap on raw docs read (None = all)


@dataclass(frozen=True)
class DatasetConstants:
    """Per-dataset split table."""

    splits: dict[str, DataSplitConstants] = field(default_factory=dict)

    def __iter__(self) -> Iterator[DataSplitConstants]:
        yield from self.splits.values()


def _c4_language(lang: str, truncated: bool = False) -> DatasetConstants:
    splits = {
        TRAIN: DataSplitConstants(C4_PATH, lang, TRAIN, TRAIN),
        VALIDATION: DataSplitConstants(C4_PATH, lang, VALIDATION, VAL),
    }
    if truncated:
        splits[TRAIN_SMALL] = DataSplitConstants(
            C4_PATH, lang, TRAIN, TRAIN_SMALL, truncated_samples=100_000)
        splits[VAL_SMALL] = DataSplitConstants(
            C4_PATH, lang, VALIDATION, VAL_SMALL, truncated_samples=10_000)
        splits[VAL_XSMALL] = DataSplitConstants(
            C4_PATH, lang, VALIDATION, VAL_XSMALL, truncated_samples=3_000)
        splits[VAL_XXSMALL] = DataSplitConstants(
            C4_PATH, lang, VALIDATION, VAL_XXSMALL, truncated_samples=100)
    return DatasetConstants(splits=splits)


# the 13 mC4 languages the reference pins (mc4.py): en carries the truncated
# convenience splits, the rest are full train/validation
MC4_LANGUAGES = ("en", "sr", "la", "sw", "ur", "ms", "zh", "it", "es", "de",
                 "el", "ru", "hi")

DATASETS_CONSTANTS: dict[str, DatasetConstants] = {
    f"c4_{lang}": _c4_language(lang, truncated=(lang == "en"))
    for lang in MC4_LANGUAGES
}


def resolve_split(dataset_key: str, split_key: str) -> DataSplitConstants:
    """Look up ``(dataset_key, split_key)`` with actionable errors."""
    try:
        consts = DATASETS_CONSTANTS[dataset_key]
    except KeyError:
        raise KeyError(
            f"unknown dataset key {dataset_key!r}; known: "
            f"{sorted(DATASETS_CONSTANTS)}"
        ) from None
    try:
        return consts.splits[split_key]
    except KeyError:
        raise KeyError(
            f"dataset {dataset_key!r} has no split {split_key!r}; known: "
            f"{sorted(consts.splits)}"
        ) from None
