"""With the timed path broken underneath, a run's numbers come out not
correct: each fault a cell can have (``workloads/<cell>.json``'s
``faults``, ``faults.py``), planted in the program, against limits that a
sound run at the same small size meets. And the control, the reference in
float8 put in the program's place, reads three times what the program
does on one of the cell's numbers at least (``control.py``, run on the
card at the cells' own sizes for the limits)."""

import json

import pytest

from conftest import CELLS, ROOT, small_cell

CASES = [(c, f, None) for c in CELLS for f in json.loads(
    (ROOT / "port_bench" / "workloads" / f"{c}.json").read_text())["faults"]]
# the exchange between ranks, on the training driver's four-rank path
CASES.append(("mhb_coatt.train_prepool", "no_exchange", 4))


@pytest.mark.parametrize("cell,fault,chips", CASES)
def test_fault_is_not_correct(cell, fault, chips, store_cache):
    from port_bench.run import measure

    c = small_cell(cell, chips=chips)
    sound = measure(c, 21, 1.0, False, device="cpu")
    c.limits = {k: 2 * v["value"] + 1e-6 for k, v in sound["checks"].items()}
    assert measure(c, 21, 1.0, False, device="cpu")["correct"] is True
    broken = measure(c, 21, 1.0, False, device="cpu", fault=fault)
    assert broken["correct"] is False, broken["checks"]


@pytest.mark.parametrize("cell,chips", [(c, None) for c in CELLS]
                         + [("mhb_coatt.train_prepool", 4)])
def test_control_reads_three_times_the_program(cell, chips, store_cache):
    from port_bench.control import readings

    c = small_cell(cell, chips=chips)
    names = ["float8"] + [f for f in c.faults if f == "half_batch"] + (
        ["no_exchange"] if c.chips > 1 else [])
    got = readings(c, 22, 1.0, names, device="cpu")
    for name in names:
        control = got["controls"][name]
        assert any(control[k] >= 3 * got["program"][k] for k in c.limits), \
            (name, control, got["program"])
