"""On the card, at the cell's own size: the orbit cell's program within
its limits and the control past at least one, as
``test_perfbench_card.py`` holds the static cell.  Run there with
``python -m pytest -o addopts="" perfbench/tests/test_perfbench_card_orbit.py``.
"""

from __future__ import annotations

import pytest

from perfbench import run as harness

CELLS = ["kitchen49k.gi_orbit"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_program_within_and_control_past_the_limits(card, cell):
    from perfbench import control

    row = control.readings(cell, [2 ** 31 + 17], 1, 8, device=card)[0]
    limits = harness.load_json("workloads", cell)["limits"]
    assert all(v <= limits[k] for k, v in row["program"].items()), row
    assert any(v > limits[k] for k, v in row["control"].items()), row
