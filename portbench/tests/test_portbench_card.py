"""On the card, at each cell's own size: a sound reading passes the cell's
limits and the control (TF32 on, the precision below the configurations'
float32) fails one of them; for training, so does half of every batch left
out, the curation decision inverted where the controller makes it, and,
where the window's checked step pads its batch, the mask ignored.
Each test skips without a CUDA device.

    python -m pytest portbench/tests/test_portbench_card.py -m card
"""

import pytest

from portbench import bench, calibrate

CELLS = ["mvcnn.train.guided_b128", "r3d.train.guided_b8", "mvcnn.serve.b128", "r3d.serve.b8"]
SEED = 2147483999


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _passes(cell, numbers):
    return bench.verdict(numbers, cell.limits)[0]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_sound_passes_and_the_control_fails(name):
    _card()
    cell = bench.find_cell(name)
    assert _passes(cell, calibrate.reading(cell, SEED, "sound", 3.0)["numbers"])
    assert not _passes(cell, calibrate.reading(cell, SEED, "control", 3.0)["numbers"])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS[:2])
def test_half_the_batch_fails(name):
    _card()
    cell = bench.find_cell(name)
    assert not _passes(cell, calibrate.reading(cell, SEED, "half", 3.0)["numbers"])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS[:2])
def test_the_decision_inverted_fails(name):
    _card()
    cell = bench.find_cell(name)
    assert not _passes(cell, calibrate.reading(cell, SEED, "decision", 3.0)["numbers"])


@pytest.mark.card
def test_the_mask_ignored_fails():
    _card()
    cell = bench.find_cell("mvcnn.train.guided_b128")
    assert not _passes(cell, calibrate.reading(cell, SEED, "mask", 3.0)["numbers"])
