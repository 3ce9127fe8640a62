"""K1–K3's share of their roofline over the traced window, in %: the sum
of each launch's least time (``counting.flash_work`` at its shapes) over
the sum of the device time of its kernels."""

from perfbench.counting import flash_work, least_seconds


def read(rec):
    calls = rec.calls.get("flash") or []
    busy = sum(c["device_s"] for c in calls)
    if not calls or busy <= 0:
        return None
    least = sum(least_seconds(*flash_work(c["kind"], c["b"], c["s_q"], c["s_k"], c["h"],
                                          c["n_kv"], c["d"], c["causal"], c["elem"]))
                for c in calls)
    return 100.0 * least / busy
