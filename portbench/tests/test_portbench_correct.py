"""``correct`` against the limits in ``limits/``: a run with the timed
path broken underneath comes out false, once for each fault its cell can
have; a sound run comes out true; the control (the reference in float8
in the program's place) fails a limit. On the CPU at a small size, the
program in float32 so that a planted fault is all that differs from the
reference; on the card at the cells' own sizes (``card``)."""

import json

import pytest

from portbench import harness
from portbench.run import run_cell

SMALL = {
    "detect": {"driver": "detect", "pool": 3, "canvas": [128, 128],
               "faces": [1, 3], "fused": True, "warmup_calls": 1,
               "trace_calls": 1},
}
CELLS = {"n.detect.b1": "detect"}


class F32Bench(harness.Bench):
    """The benchmark with the program in float32."""

    def config(self, name):
        cfg = super().config(name)
        cfg["precision"] = "float32"
        return cfg


def small_run(cell, fault=None, seed=17):
    return run_cell(F32Bench(), cell, seed, 0.3, False, device="cpu",
                    fault=fault, traffic=SMALL[CELLS[cell]])


CASES = [(c, f) for c, kind in CELLS.items()
         for f in (None,) + harness.driver_class(kind).faults]


@pytest.mark.parametrize("cell, fault", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_planted_faults_fail(cell, fault):
    r = small_run(cell, fault)
    assert r["correct"] is (fault is None), json.dumps(r["compared"])
    if fault:
        assert any(c["value"] > c["limit"] for c in r["compared"].values())


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_control_fails_a_limit_at_a_small_size(cell):
    bench = harness.Bench()
    cfg = bench.config(bench.workload(cell)["config"])
    mix = SMALL[CELLS[cell]]
    drv = harness.driver_class(mix["driver"])(cfg, mix, 23, "cpu")
    drv.limits = limits = bench.limits(cell)
    drv.setup()
    drv.release()
    numbers = drv.control()
    assert any(numbers[k] > lim for k, lim in limits.items()), numbers


@pytest.mark.card
@pytest.mark.parametrize("cell", list(CELLS))
def test_program_holds_and_the_control_fails_on_the_card(card, cell):
    """At the cell's own size on the card, three seeds: the program within
    every limit, the control over at least one."""
    from portbench.calibrate import reading
    bench = harness.Bench()
    limits = bench.limits(cell)
    for seed in (1, 2, 3):
        drv, numbers = reading(bench, cell, seed, 2.0, card)
        assert all(numbers[k] <= lim for k, lim in limits.items()), numbers
        low = drv.control()
        assert any(low[k] > lim for k, lim in limits.items()), low
