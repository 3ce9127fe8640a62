"""90th percentile of ``t_admit - t_submit`` (the port's ``ServeRequest``
times) over the window's admitted requests, in ms: the scheduler's share
of TTFT."""

from perfbench.runtime import percentile


def read(rec):
    waits = rec.host.get("queue_waits")
    return percentile(waits, 90) * 1e3 if waits else None
