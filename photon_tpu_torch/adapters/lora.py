"""LoRA adapter math on the codec's canonical (metadata, arrays) form.

The port's copy of ``photon_tpu/adapters/lora.py`` (host numpy; the same
names, order, shapes and initial bits). A cohort's adapter is a flat list
of rank-``r`` A/B factors for the targeted per-layer dense modules, named
after the base parameters they adapt::

    base   blocks/block/wqkv/kernel      [L, d_in, d_out]
    lora   blocks/block/wqkv_lora_a      [L, d_in, r]
           blocks/block/wqkv_lora_b      [L, r, d_out]

— the names ``models/mpt.py`` grows when ``model.lora_rank > 0`` and the
names ``models/decode.py`` reads per row at serving time. The adapted
projection is ``y = h @ W + (h @ A) @ B · alpha/r``, with A drawn from
N(0, σ) and B zero, so a fresh adapter is exactly the identity.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from photon_tpu_torch.codec.params import ParamsMetadata, flatten

LORA_A_SUFFIX = "_lora_a"
LORA_B_SUFFIX = "_lora_b"
LORA_MARK = "_lora_"

#: the optimizer's freeze pattern for an adapter fit: every parameter whose
#: name does not hold the LoRA mark is frozen
BASE_FREEZE_PATTERN = r"^(?!.*_lora_)"


def is_adapter_name(name: str) -> bool:
    return LORA_MARK in name


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    """Which modules one model adapts and the A/B shapes, derived from the
    base parameters (so MHA's fused ``wqkv`` and GQA's ``q/k/v_proj``
    resolve from the model family, not from the target list)."""

    rank: int
    alpha: float
    #: (name stem ``blocks/block/{module}``, A shape, B shape), sorted by stem
    entries: tuple[tuple[str, tuple[int, ...], tuple[int, ...]], ...]

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    @property
    def n_params(self) -> int:
        return sum(int(np.prod(a, dtype=np.int64)) + int(np.prod(b, dtype=np.int64))
                   for _, a, b in self.entries)

    def modules(self) -> list[str]:
        """Module names (``wqkv``, ``out_proj``, ...) in entry order."""
        return [stem.rsplit("/", 1)[-1] for stem, _, _ in self.entries]


def spec_from_base(meta: ParamsMetadata, rank: int, alpha: float,
                   targets: tuple[str, ...] | list[str]) -> AdapterSpec:
    """Every stacked block kernel ``blocks/.../{module}/kernel`` whose
    module is targeted grows an ``[L, d_in, r]`` A and ``[L, r, d_out]`` B.
    Raises when no target matches (an empty adapter would train nothing)."""
    if rank < 1:
        raise ValueError(f"need rank >= 1, got {rank}")
    targets = set(targets)
    entries = []
    for name, shape in zip(meta.names, meta.shapes):
        if not name.endswith("/kernel") or len(shape) != 3:
            continue
        stem = name[: -len("/kernel")]
        if stem.rsplit("/", 1)[-1] not in targets:
            continue
        n_layers, d_in, d_out = shape
        entries.append((stem, (n_layers, d_in, rank), (n_layers, rank, d_out)))
    if not entries:
        raise ValueError(
            f"no base parameter matches adapter targets {sorted(targets)} — "
            "is the model family missing these modules?"
        )
    return AdapterSpec(rank=rank, alpha=float(alpha), entries=tuple(sorted(entries)))


def spec_from_params(params: dict, rank: int, alpha: float,
                     targets: tuple[str, ...] | list[str]) -> AdapterSpec:
    """:func:`spec_from_base` from a live (base) parameter tree: shapes
    only, no copy."""
    flat = flatten(params)
    meta = ParamsMetadata(
        names=tuple(flat),
        shapes=tuple(tuple(int(d) for d in t.shape) for t in flat.values()),
        dtypes=tuple("float32" for _ in flat),
    )
    return spec_from_base(meta, rank, alpha, targets)


def adapter_metadata(spec: AdapterSpec) -> ParamsMetadata:
    """The adapter payload's metadata in canonical (sorted-name) order: the
    order ``flatten`` gives the training model's LoRA leaves."""
    named = []
    for stem, a_shape, b_shape in spec.entries:
        named.append((stem + LORA_A_SUFFIX, a_shape))
        named.append((stem + LORA_B_SUFFIX, b_shape))
    named.sort()
    return ParamsMetadata(names=tuple(n for n, _ in named),
                          shapes=tuple(tuple(s) for _, s in named),
                          dtypes=tuple("float32" for _ in named))


def cohort_seed(base_seed: int, cohort: str) -> int:
    """A per-cohort init seed, the same in every process and package."""
    return (int(base_seed) * 1000003 + zlib.crc32(cohort.encode())) & 0x7FFFFFFF


def init_adapter_arrays(spec: AdapterSpec, seed: int,
                        std: float = 0.02) -> tuple[ParamsMetadata, list[np.ndarray]]:
    """A fresh adapter: A ~ N(0, std) from numpy's ``default_rng(seed)``,
    B = 0 (the delta is exactly zero)."""
    meta = adapter_metadata(spec)
    rng = np.random.default_rng(seed)
    arrays = []
    for name, shape in zip(meta.names, meta.shapes):
        if name.endswith(LORA_B_SUFFIX):
            arrays.append(np.zeros(shape, np.float32))
        else:
            arrays.append(rng.normal(0.0, std, shape).astype(np.float32))
    return meta, arrays


def split_adapter(meta: ParamsMetadata, arrays: list[np.ndarray]
                  ) -> tuple[ParamsMetadata, list[np.ndarray], ParamsMetadata, list[np.ndarray]]:
    """A full payload → its (base, adapter) halves, each in canonical order."""
    base_n, base_a, ad_n, ad_a = [], [], [], []
    for name, arr in zip(meta.names, arrays):
        if is_adapter_name(name):
            ad_n.append(name)
            ad_a.append(arr)
        else:
            base_n.append(name)
            base_a.append(arr)
    return (ParamsMetadata.from_ndarrays(base_n, base_a), base_a,
            ParamsMetadata.from_ndarrays(ad_n, ad_a), ad_a)


def merge_payload(base_meta: ParamsMetadata, base_arrays: list[np.ndarray],
                  ameta: ParamsMetadata, aarrays: list[np.ndarray]
                  ) -> tuple[ParamsMetadata, list[np.ndarray]]:
    """(base, adapter) halves → one canonical payload: the LoRA model's
    flat order, which its ``set_parameters`` takes."""
    named = sorted(list(zip(base_meta.names, base_arrays)) + list(zip(ameta.names, aarrays)),
                   key=lambda kv: kv[0])
    arrays = [a for _, a in named]
    return ParamsMetadata.from_ndarrays([n for n, _ in named], arrays), arrays


def merge_adapter_into_base(base_meta: ParamsMetadata, base_arrays: list[np.ndarray],
                            spec: AdapterSpec, aarrays: list[np.ndarray]) -> list[np.ndarray]:
    """``W + (alpha/r)·A@B`` into fresh base arrays (fp32 host math)."""
    ameta = adapter_metadata(spec)
    if len(aarrays) != len(ameta.names):
        raise ValueError(f"adapter payload has {len(aarrays)} arrays, spec expects "
                         f"{len(ameta.names)}")
    a_by_name = dict(zip(ameta.names, aarrays))
    base_idx = {n: i for i, n in enumerate(base_meta.names)}
    out = [np.array(a, np.float32, copy=True) for a in base_arrays]
    for stem, _, _ in spec.entries:
        ki = base_idx[stem + "/kernel"]
        a = np.asarray(a_by_name[stem + LORA_A_SUFFIX], np.float32)
        b = np.asarray(a_by_name[stem + LORA_B_SUFFIX], np.float32)
        out[ki] = out[ki] + spec.scale * np.einsum("lir,lro->lio", a, b)
    return out


def adapter_tree(spec: AdapterSpec, aarrays: list) -> dict:
    """Flat adapter arrays → ``{module: {"a": [L, d_in, r], "b": [L, r,
    d_out]}}`` (or with a leading ``[B]`` axis when the leaves carry one),
    the form ``models/decode.py`` and ``serve/cache.py`` read. Leaves are
    whatever the caller passes: numpy arrays or device tensors."""
    by_name = dict(zip(adapter_metadata(spec).names, aarrays))
    return {stem.rsplit("/", 1)[-1]: {"a": by_name[stem + LORA_A_SUFFIX],
                                      "b": by_name[stem + LORA_B_SUFFIX]}
            for stem, _, _ in spec.entries}


def stack_adapter_trees(trees: list[dict]) -> dict:
    """Per-row adapter trees → one tree with a leading ``[B]`` axis (the
    contiguous oracle's form of the serving pool's gather)."""
    return {m: {k: np.stack([np.asarray(t[m][k]) for t in trees]) for k in ("a", "b")}
            for m in trees[0]}
