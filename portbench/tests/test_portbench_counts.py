"""The FLOP counts against the published hand counts, and the gating
kernels' least times against the arithmetic the kernels' own checks use
(``chip_smoke.py``'s ``bound_ms`` and ``bwd_bound_ms``)."""

import pytest
import torch

from portbench import flops
from portbench.reference.nets import Arch

MVCNN = Arch(2, 2, 40, ["visual", "skeleton"], bug_compat=True)
R3D = Arch(3, 3, 25, ["rgb", "depth", "flow"])


def test_resnet18_forward_is_1_814_gmac_a_view():
    layers, _ = flops.tower_layers(MVCNN, (224, 224))
    assert sum(m for _, m in layers) / 1e9 == pytest.approx(1.814, abs=1e-3)


def test_r3d18_forward_is_40_7_gmac_a_modality():
    layers, _ = flops.tower_layers(R3D, (16, 112, 112))
    assert sum(m for _, m in layers) / 1e9 == pytest.approx(40.7, abs=0.05)


def test_train_and_serve_flops_of_both_cells():
    assert flops.train_flops(MVCNN, (224, 224)) / 1e9 == pytest.approx(21.3, abs=0.05)
    assert flops.forward_flops(MVCNN, (224, 224)) * 128 / 1e9 == pytest.approx(929, abs=1)
    assert flops.train_flops(R3D, (16, 112, 112)) / 1e9 == pytest.approx(724, abs=1)
    assert flops.forward_flops(R3D, (16, 112, 112)) * 8 / 1e12 == pytest.approx(1.95, abs=0.01)


def test_mmtm_linears_by_hand():
    # two modalities: squeeze 2C -> C, one C -> C layer each, at C = 128, 256, 512
    assert flops.mmtm_macs(MVCNN) == sum(4 * c * c for c in (128, 256, 512))
    # three: 3C -> int(1.5 C), one back to C each
    assert flops.mmtm_macs(R3D) == sum(6 * c * int(1.5 * c) for c in (128, 256, 512))


def test_gating_sites_at_224():
    assert flops.gating_sites(MVCNN, (224, 224)) == [(784, 128), (196, 256), (49, 512)]


@pytest.mark.parametrize("S, C", [(784, 128), (196, 256), (49, 512)])
def test_gating_bounds_match_the_kernels_own_arithmetic(S, C):
    import chip_smoke

    fwd = 1e3 * flops.least_seconds(*flops.gating_fwd_counts(128, S, C))
    bwd = 1e3 * flops.least_seconds(*flops.gating_bwd_counts(128, S, C))
    assert fwd == pytest.approx(chip_smoke.bound_ms(128, S, C, torch.float32)[0], rel=1e-12)
    assert bwd == pytest.approx(chip_smoke.bwd_bound_ms(128, S, C, torch.float32)[0], rel=1e-12)
