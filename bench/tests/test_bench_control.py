"""The control on the card: the reference in TF32 put in the program's
place fails a cell's limits where the program passes them, at the
vs_single_scan cell's own size (one run of 80 rounds, 23 tasks).  Needs
the card; skips itself on the CPU."""
import pytest
import torch

from bench import compare, control, run


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["vs_single_scan"])
def test_control_fails_where_the_program_passes(card, workload):
    cell = run.load_cell(workload, False)
    program = control.readings(cell, 31, control=False)
    tf32 = control.readings(cell, 31, control="tf32")
    assert compare.judge(program["numbers"], cell["limits"])[0]
    assert not compare.judge(tf32["numbers"], cell["limits"])[0]
