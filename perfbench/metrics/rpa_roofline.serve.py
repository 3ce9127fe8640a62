"""K4's share of its roofline over the traced window, in %: the sum of each
call's least time (``counting.rpa_work`` over the live blocks its rows'
positions reach) over the sum of the device time of its kernels (a split
and its merge together)."""

from perfbench.counting import least_seconds, rpa_work


def _rows(pos):
    """``(queries, last position)`` of each row's real queries: a decode
    row is its one query (an idle row, at position 0, is skipped); a chunk
    row is its leading run of consecutive positions."""
    rows = []
    for r in pos:
        if len(r) == 1:
            if r[0] > 0:
                rows.append((1, int(r[0])))
            continue
        n = 1
        while n < len(r) and r[n] == r[0] + n:
            n += 1
        rows.append((n, int(r[n - 1])))
    return rows


def read(rec):
    calls = rec.calls.get("rpa") or []
    busy = sum(c["device_s"] for c in calls)
    if not calls or busy <= 0:
        return None
    least = 0.0
    for c in calls:
        rows = _rows(c["positions"].cpu().tolist())
        if rows:
            least += least_seconds(*rpa_work(rows, c["t"], c["h"], c["n_kv"], c["d"],
                                             c["elem"], c["n_ctx"], c["bs"]))
    return 100.0 * least / busy
