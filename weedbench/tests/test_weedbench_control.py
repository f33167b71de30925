"""On the card: the control of each cell comes out not correct, on three
seeds, at a quarter of the cell's data. The GET cells' control is the
program's own corrupting path (its failpoint ec.shard.read.data flips a
bit in every shard interval a server fetches)."""

import pytest

from ._runs import run_cell

CONTROL = {"rs14_2.get_diskloss_chunks": "wire_corrupt"}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CONTROL))
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_the_control_is_not_correct(card, cell, seed):
    res, _ = run_cell(cell, seed, "--scale", "0.25", "--fault",
                      CONTROL[cell], seconds=3)
    assert res["correct"] is False
    assert res["device"]["platform"] == "gpu"
