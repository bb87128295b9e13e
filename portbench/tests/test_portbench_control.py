"""The control comes out not correct: the plain reference put in the
program's place at the next precision below the configuration's (float32
with its transforms in TF32, emulated on the CPU by rounding the operands
to TF32's mantissa), judged by each configuration's own limits; and the
program on the same inputs is correct. The same readings at the cells'
own sizes come from `portbench/control.py` on the card."""

import pytest

from portbench import control
from portbench.tests import cells


@pytest.mark.parametrize("cell", ["p1_track_batch", "p0_track_batch"])
def test_control_fails_a_limit_and_program_passes(cell):
    c = cells.cell(cell)
    out = control.readings(c, 2 ** 31 + 11, True, device="cpu", seconds_override=[1.5, 2.0])
    limits = c.config["limits"]
    assert all(v <= limits[k] for k, v in out["program"].items()), out
    assert any(v > limits[k] for k, v in out["control"].items()), out
