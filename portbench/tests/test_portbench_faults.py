"""A run whose timed path is broken underneath comes out not correct: the
harness's whole run on the CPU at a tiny size (its look for a card
skipped), with each fault that a cell can have planted in the program
(``portbench/faults.py``, which ``calibrate.py --faults`` plants at the
cell's own size on the card)."""

import time

import pytest
import torch

from portbench import faults as F
from portbench import harness as H

from tiny import tiny_cell

CELLS = {"track": "track.buddha1m", "refine": "refine.buddha1m"}


@pytest.mark.parametrize("fault", sorted(F.FAULTS))
def test_a_broken_program_is_not_correct(fault):
    torch.set_num_threads(2)
    cell = tiny_cell(CELLS[fault.split(".")[0]])
    with F.planted(fault):
        out = H.run_cell(cell, 2**31 + 41, 0.2, False, torch.device("cpu"),
                         time.perf_counter())
    assert out.result["correct"] is False, out.result


def test_a_planted_fault_is_removed_after():
    import polychase_tpu_torch.engine.tracker as tr

    was = tr.raycast_grouped
    with F.planted("track.half"):
        assert tr.raycast_grouped is not was
    assert tr.raycast_grouped is was
