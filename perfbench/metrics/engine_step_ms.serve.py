"""Host wall of the engine's steps in the window (``PagedEngine.mixed_step``,
what the batcher calls each step, timed by a wrapper on the instance) over
their count, in ms."""


def read(rec):
    walls = rec.host.get("step_walls")
    return 1e3 * sum(walls) / len(walls) if walls else None
