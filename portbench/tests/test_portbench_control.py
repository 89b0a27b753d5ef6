"""The control: the reference in the program's place, computed in float32
with its matrix products in TF32 (the nearest precision below the
configurations' float32 with TF32 off), comes out not correct, where the
program's answers on the same inputs pass.  The TF32 rounding is
emulated (``reference/common.py::tf32_products``), so it runs on the CPU
too; the full-size readings are ``calibrate.py``'s on the card."""

import os
import shutil
import tempfile

import pytest
import torch

from portbench.gen.scene import make_scene, write_db

from tiny import tiny_cell


@pytest.mark.parametrize("name", ["track.buddha1m", "refine.buddha1m"])
def test_the_control_is_not_correct(name):
    torch.set_num_threads(2)
    cell = tiny_cell(name)
    dev = torch.device("cpu")
    tmp = tempfile.mkdtemp()
    try:
        scene = make_scene(cell.config, 5)
        write_db(scene, os.path.join(tmp, "f.db"))
        drv = cell.call.Caller(scene, cell.config, cell.traffic, dev,
                               os.path.join(tmp, "f.db"), 5)
        records = [drv.call(i) for i in range(cell.traffic["trace_calls"])]
        drv.release()
        ctrl = cell.call.check(scene, cell.config, cell.traffic, records, 5,
                               dev, cell.limits, control=True)
        prog = cell.call.check(scene, cell.config, cell.traffic, records, 5,
                               dev, cell.limits)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert all(v <= lim for _, v, lim in prog), prog
    assert any(v > lim for _, v, lim in ctrl), ctrl


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from portbench.reference.common import mm, tf32_products

    a = torch.tensor([[1.0 + 2.0 ** -12, 1.0 + 2.0 ** -10]])
    b = torch.ones((2, 1))
    assert float(mm(a, b)) == float(a.sum())
    with tf32_products():
        assert float(mm(a, b)) == 1.0 + (1.0 + 2.0 ** -10)
        assert float(mm(a.double(), b.double())) == float(a.double().sum())
