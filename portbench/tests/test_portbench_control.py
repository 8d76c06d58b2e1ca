"""On the card: each cell's control (its configuration's control "kind":
the program's own int8 path, or the reference computed in fp8 in the
program's place) comes out not correct, and the cell as served comes out
correct, at the cell's own size over a short window. Run on a card with
`python -m pytest portbench/tests -m chip`."""
import pytest

from portbench import bench
from portbench.calibrate import control

SPEC = bench.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("wl", CELLS)
def test_control_is_not_correct(card, wl):
    r = control(wl, 2 ** 31 + 1001)
    assert r["correct"] is False, r["readings"]


@pytest.mark.chip
@pytest.mark.parametrize("wl", CELLS)
def test_served_cell_is_correct(card, wl):
    r = bench.run(wl, 2 ** 31 + 1002, 3.0, False)
    assert r["correct"] is True, r["check"]
