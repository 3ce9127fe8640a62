"""Forward FLOPs of every token the engine processed in the window (prompt
chunks and decode rows: the blocks' products, attention over each token's
visible keys, the head for each row whose logits are used;
``counting.forward_flops``) a second, as a share of the bf16 peak, in %."""

from perfbench.counting import PEAK_FLOPS


def read(rec):
    h = rec.host
    if not h.get("flops") or not h.get("seconds"):
        return None
    return 100.0 * h["flops"] / h["seconds"] / PEAK_FLOPS["bfloat16"]
