"""A whole run of each cell, cut to a tiny size, on the card: the
program's kernels (K1, K5) under the harness, held to the cell's limits.
Skips without a card."""

import time

import pytest
import torch

from portbench import harness as H

from tiny import CELLS, tiny_cell

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", sorted(CELLS))
def test_tiny_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = H.run_cell(tiny_cell(name), 2**31 + 17, 1.0, False,
                     torch.device("cuda", 0), time.perf_counter())
    assert out.result["correct"], out.result
    assert out.result["device"]["platform"] == "gpu"
