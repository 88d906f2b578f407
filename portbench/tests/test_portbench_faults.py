"""``correct`` as a run decides it, with the look for a card skipped: true
for the program; false for the control (the reference a precision lower)
and for each fault these cells can have, planted in the timed path: a
block that returns its state unchanged, half of the voices left out with
the mean over the rest, one sample of each block's stereo altered where it
is produced.  (One chip: no exchange between chips to leave out.)"""

import pytest
import torch

from portbench.harness import main
from small import CPU, OVERRIDES

CELLS = ("drum_kit_bus7.wide", "product_kit_chain9.rt")


def _run(cell, system, seed=2**31 + 3):
    torch.set_num_threads(2)
    return main.run_cell(cell, seed, 0.0, False, CPU, system=system, overrides=OVERRIDES)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cell):
    res = _run(cell, "program")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 5 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("system", ["control", "fault:stale_state", "fault:half_voices",
                                    "fault:altered_sample"])
def test_control_and_faults_are_not_correct(cell, system):
    res = _run(cell, system)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = main.run_cell(cell, 2**31 + 17, 1.0, False, torch.device("cuda", 0), system="control")
    assert not res["correct"], res["checks"]
