"""The traced window's training FLOPs (``counting.train_flops_per_token``,
recomputation not counted) a second, as a share of the bf16 peak, in %."""

from perfbench.counting import PEAK_FLOPS


def read(rec):
    h = rec.host
    if not h.get("seconds") or not h.get("tokens"):
        return None
    return 100.0 * h["tokens"] * h["flops_per_token"] / h["seconds"] / PEAK_FLOPS["bfloat16"]
