"""The comparison fails what it must: the control (a lower precision in the
program's place) and each fault a cell can have, planted under the timed
path, all come out not correct, at test size on the CPU; the program
itself comes out correct. On the card (``-m cuda``) the control and the
faults are read at the cells' own sizes by ``controls.py``."""

from __future__ import annotations

import pytest

from portbench import controls, faults

LANE = [("xgb.lane1024", v) for v in ["control"] + [f"fault:{f}" for f in faults.LANE_FAULTS]]
LANE += [("lr.lane1024", v) for v in ["control"] + [f"fault:{f}" for f in faults.LANE_FAULTS]]
LANE += [("lr.lane64", v) for v in ["control"] + [f"fault:{f}" for f in faults.LANE_FAULTS]]
FIT = [("xgb.fit_kaggle", v) for v in ["control"] + [f"fault:{f}" for f in faults.FIT_FAULTS]]


@pytest.mark.parametrize("cell,variant", LANE + FIT)
def test_the_control_and_every_fault_come_out_not_correct(small, cell, variant):
    r = controls.read(cell, variant, 2**31 + 99, 2.0, device="cpu", pkg=small,
                      root=small.parent)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", ["xgb.lane1024", "lr.lane1024", "xgb.fit_kaggle", "lr.lane64"])
def test_the_program_comes_out_correct(small, cell):
    r = controls.read(cell, "program", 2**31 + 99, 2.0, device="cpu", pkg=small,
                      root=small.parent)
    assert r["correct"] is True, r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["xgb.lane1024", "lr.lane1024", "xgb.fit_kaggle", "lr.lane64"])
def test_on_the_card_the_control_fails_at_the_cells_size(full_root, cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells' own sizes run on the card")
    # long enough that every sampled frame is sent: 4,096 frames over 32
    # connections take ~10 s at lr.lane64's rate
    seconds = 15.0 if cell == "lr.lane64" else 3.0
    assert controls.read(cell, "program", 2**31 + 7, seconds, root=full_root)["correct"] is True
    assert controls.read(cell, "control", 2**31 + 7, seconds, root=full_root)["correct"] is False
