"""The traffic generator: a seed repeats its requests exactly; every seed
gets the mix's one schedule, with its own token ids."""

import json
from collections import Counter

import pytest

from perfbench import spec, traffic

MIX = json.loads((spec.HERE / "traffic" / "chat.json").read_text())
BIG = 2**31 + 977  # seeds may pass 32 signed bits


def _key(reqs):
    return [(r.due, tuple(r.prompt), r.max_new, r.phase) for r in reqs]


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_a_seed_repeats_its_requests_exactly(seed):
    a = traffic.open_loop(MIX, seed, 30.0, 50368)
    b = traffic.open_loop(MIX, seed, 30.0, 50368)
    assert _key(a) == _key(b)
    assert _key(a) != _key(traffic.open_loop(MIX, seed + 1, 30.0, 50368))


def test_every_seed_gets_the_same_schedule():
    runs = [traffic.phase_requests(MIX, s, "window", 0.0, 30.0, 50368) for s in (1, 2, BIG)]
    n = round(MIX["rate_per_s"] * 30.0)
    for reqs in runs:
        assert len(reqs) == n
        assert reqs[0].due == 0.0 and all(0.0 <= r.due < 30.0 for r in reqs)
        assert [r.due for r in reqs] == sorted(r.due for r in reqs)
        assert all(0 <= t < 50368 for r in reqs for t in r.prompt)
    sched = [[(r.due, len(r.prompt), r.max_new) for r in reqs] for reqs in runs]
    assert sched[0] == sched[1] == sched[2]
    assert runs[0][0].prompt != runs[1][0].prompt
    # the schedule is the mix's: another schedule seed orders the same sizes anew
    other = traffic.phase_requests(dict(MIX, schedule_seed=MIX["schedule_seed"] + 1), 1,
                                   "window", 0.0, 30.0, 50368)
    assert Counter(len(r.prompt) for r in other) == Counter(len(r.prompt) for r in runs[0])
    assert [len(r.prompt) for r in other] != [len(r.prompt) for r in runs[0]]


def test_sizes_follow_the_mix():
    for key in ("prompt_len", "output_len"):
        dist = MIX[key]
        xs = sorted(traffic.stratified(dist, 1000))
        assert xs[0] >= dist["min"] and xs[-1] == dist["max"]
        assert xs[500] == pytest.approx(dist["median"], rel=0.01)
    # a prompt and its whole answer fit the served context
    assert MIX["prompt_len"]["max"] + MIX["output_len"]["max"] <= 2048
    assert traffic.stratified({"dist": "uniform", "min": 10, "max": 20}, 2) == [12, 18]
    with pytest.raises(ValueError):
        traffic.quantile({"dist": "zipf"}, 0.5)


def test_phases_cover_warm_window_and_tail():
    reqs = traffic.open_loop(MIX, 3, 20.0, 100)
    phases = Counter(r.phase for r in reqs)
    rate = MIX["rate_per_s"]
    assert phases == {"warm": round(rate * MIX["warm_s"]), "window": round(rate * 20.0),
                      "tail": round(rate * MIX["tail_s"])}
    assert all(r.due < 0 for r in reqs if r.phase == "warm")
    assert all(r.due >= 20.0 for r in reqs if r.phase == "tail")
