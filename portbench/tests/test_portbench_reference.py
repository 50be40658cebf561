"""The plain reference agrees with the program at a size the CPU holds:
a whole run of each cell (set-up, window, check) on the CPU, with the
look for a card skipped; and the reference's flips are the program's."""

import numpy as np
import pytest

from portbench.reference import keys
from portbench.tests import tiny

CELLS = ["mvcnn.train.guided_b128", "r3d.train.guided_b8", "mvcnn.serve.b128", "r3d.serve.b8"]


@pytest.mark.parametrize("name", CELLS)
def test_a_cpu_run_is_correct(name):
    result = tiny.run(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("seed", [0, 777, 2 ** 31 + 5, 2 ** 32 + 9])
@pytest.mark.parametrize("shape", [(4, 2), (8,)])
def test_the_flips_are_the_programs(seed, shape):
    from greedy_multimodal_learning_tpu_torch.engine.train_state import train_keys
    from greedy_multimodal_learning_tpu_torch.data.transforms import draw_flips
    from greedy_multimodal_learning_tpu_torch.utils import prng

    data_key = train_keys(seed)[1]
    for step in (0, 1, 5):
        want = draw_flips(shape, prng.fold_in(data_key, step)).numpy()
        assert np.array_equal(keys.train_flips(seed, step, shape), want)


def _controller(d0, n=2):
    """A fresh controller whose next step reads the imbalance ``d0`` (the
    first modality's BDR over the others') from zero gradients."""
    import torch

    from portbench.reference import train

    M_main = torch.ones(n, dtype=torch.float64)
    M_bypass = torch.ones(n, dtype=torch.float64)
    M_bypass[0] = 10.0 ** d0
    return train.Controller(M_main, M_bypass), torch.zeros(2 * n, dtype=torch.float64), torch.ones(2 * n)


@pytest.mark.parametrize("n", [2, 3])
def test_a_decision_on_the_edge_goes_the_programs_way(n):
    from portbench.reference import train

    ctrl, gn, wn = _controller(0.0105, n)
    own, d, tie, margin = train.guided(ctrl, gn, wn, 0.01, 5)
    assert (own.curating, own.caring) == (True, 0) and not tie
    assert abs(float(d) - 0.0105) < 1e-9 and abs(margin - 5e-4) < 1e-9
    followed, _, tie, _ = train.guided(ctrl, gn, wn, 0.01, 5, follow=(False, 0), band=train.DECISION_BAND)
    assert tie and (followed.curating, followed.caring, followed.count) == (False, 0, 0)


@pytest.mark.parametrize("follow", [(False, 0), (True, 1)])
def test_a_decision_off_the_edge_stays_the_references(follow):
    from portbench.reference import train

    ctrl, gn, wn = _controller(0.02)
    out, _, tie, _ = train.guided(ctrl, gn, wn, 0.01, 5, follow=follow, band=train.DECISION_BAND)
    assert not tie and (out.curating, out.caring) == (True, 0)


def test_a_step_inside_a_window_has_no_tie():
    from portbench.reference import train

    ctrl, gn, wn = _controller(0.0)
    ctrl.curating, ctrl.count = True, 1
    out, d, tie, margin = train.guided(ctrl, gn, wn, 0.01, 5, follow=(False, 0), band=train.DECISION_BAND)
    assert not tie and out.curating and out.count == 2 and d is None and margin is None
