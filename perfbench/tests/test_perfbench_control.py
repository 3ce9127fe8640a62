"""On the card, at each cell's own size: the control (the reference in
fp8, the precision below the configuration's bf16, put in the program's
place) fails one of the cell's limits, where the program passes them on
the same inputs; and stale KV (the serving step leaves the cache as it
was) fails them too. Card only; run there as

    python -m pytest -p no:cacheprovider perfbench/tests/test_perfbench_control.py
"""

import pytest

from perfbench.calibrate import readings
from perfbench.tests.tiny import FILES

SEED = 2**31 + 4242


@pytest.mark.cuda
@pytest.mark.parametrize("workload,seconds", [("train.mpt-125m", 3.0),
                                              ("serve.mpt-1b.chat", 10.0)])
def test_control_fails(cuda, workload, seconds):
    (r,) = readings(workload, [SEED], seconds, files=FILES[workload])
    assert r["correct"], r["checks"]
    limits = {name: lim for name, (_, lim) in r["checks"].items()}
    assert any(v > limits[name] for name, v in r["control"].items() if name in limits), (
        r["control"], limits)


@pytest.mark.cuda
def test_stale_kv_fails_at_the_cells_size(cuda):
    (r,) = readings("serve.mpt-1b.chat", [SEED], 10.0, fault="state_unchanged",
                    files=FILES["serve.mpt-1b.chat"])
    assert not r["correct"], r["checks"]
