"""Seed-made MPT weights, on the device, in the dtype they are used in.

The tree has the port's names and shapes (layers stacked on a leading
axis, dense kernels ``[in, out]``; a tied head; no biases), and both the
program and the reference are handed it. Every normal leaf is a view of
one buffer drawn in a single call from a ``torch.Generator`` on the card,
scaled in place: the embeddings and the input projections by
``emb_init_std``, the residual projections (``out_proj``, ``down_proj``)
by ``emb_init_std / sqrt(2 L)``. Norm scales are ones and stay fp32. The
same seed gives the same bits, so the reference makes its copy again.
"""

from __future__ import annotations

import math

import torch


def shapes(m: dict) -> dict[str, tuple[int, ...]]:
    """Flat name -> shape of an MPT tree with learned positions, tied
    embeddings, scale-only LayerNorms and no biases."""
    d, L, v = m["d_model"], m["n_layers"], m["vocab_size"]
    hidden = m.get("expansion_ratio", 4) * d
    blk = "blocks/block/"
    return {
        "wte/embedding": (v, d),
        "wpe": (m["max_seq_len"], d),
        "ln_f/scale": (d,),
        blk + "wqkv/kernel": (L, d, 3 * d),
        blk + "out_proj/kernel": (L, d, d),
        blk + "up_proj/kernel": (L, d, hidden),
        blk + "down_proj/kernel": (L, hidden, d),
        blk + "ln_1/scale": (L, d),
        blk + "ln_2/scale": (L, d),
    }


def nest(flat: dict) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def make(m: dict, seed: int, device: torch.device | str, dtype: torch.dtype) -> dict:
    """The flat tree for model dims ``m`` from ``seed``: normal leaves in
    ``dtype``, norm scales fp32 ones."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2**63 - 1))
    std = m.get("emb_init_std", 0.02)
    resid = std / math.sqrt(2.0 * m["n_layers"])
    normal = {n: s for n, s in shapes(m).items() if not n.endswith("/scale")}
    total = sum(math.prod(s) for s in normal.values())
    buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
    flat, at = {}, 0
    for name, shape in normal.items():
        n = math.prod(shape)
        flat[name] = buf[at:at + n].view(shape).mul_(
            resid if name.endswith(("out_proj/kernel", "down_proj/kernel")) else std)
        at += n
    for name, shape in shapes(m).items():
        if name.endswith("/scale"):
            flat[name] = torch.ones(shape, dtype=torch.float32, device=device)
    return dict(sorted(flat.items()))
