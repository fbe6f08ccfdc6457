"""``bench/cost.py``'s frozen copy of chip_smoke.py's ``bound()`` gives
its numbers on one Vehicle Sensor and one Human Activity shape.  The
expected numbers were read from ``chip_smoke.bound`` on these inputs and
are written here, so the test imports nothing of chip_smoke."""
import numpy as np
import pytest

from bench import cost

CASES = {
    # (m, n, d, max_steps, budgets): one round at the training split's
    # padded length, budgets spread from half a pass to one
    "vehicle_sensor": ((23, 1449, 100, 1449),
                       dict(bytes=14151348, flops=174282612,
                            chain_steps=1472, mode="gram")),
    "human_activity": ((30, 229, 561, 229),
                       dict(bytes=15719280, flops=20808288,
                            chain_steps=256, mode="carry")),
}


def budgets(m, steps):
    return np.array([max(1, int(steps * (0.5 + 0.5 * t / (m - 1))))
                     for t in range(m)])


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_cost_is_bound(name):
    (m, n, d, steps), want = CASES[name]
    got = cost.solve_cost(m, n, d, steps, budgets(m, steps))
    assert {k: got[k] for k in want} == want


def test_plan_follows_the_feature_count():
    assert cost.plan(100, 1449) == (True, 32)
    assert cost.plan(180, 400) == (False, 16)
    assert cost.plan(561, 229) == (False, 64)
    assert cost.plan(561, 40) == (False, 40)


def test_round_and_omega_counts():
    assert cost.round_flops(1, 23, 100) == 2 * 23 * 23 * 100 + 2300
    assert cost.omega_flops(2, 3, 4) == 2 * (4 * 9 * 4 + 12 + 24 * 27 + 72)
