"""The share of the traced window in which no operation ran on the card,
in % (the profiler's device records, their union against the window)."""

from perfbench.trace import idle_share


def read(rec):
    return idle_share(rec)
