"""The launch plan of the cluster gating kernels (ops/mmtm_gating.py::_plan),
which the CUDA entry points take as given: at the three 224² fusion sites,
ragged batches and a sample too large for a cluster, forward and backward,
f32 and bf16.  The kernels themselves run only on the card (chip_smoke.py)."""

import importlib

import pytest

# the module (the package re-exports a function of the same name)
mg = importlib.import_module("greedy_multimodal_learning_tpu_torch.ops.mmtm_gating")

SITES = {"mmtm2": (784, 128), "mmtm3": (196, 256), "mmtm4": (49, 512)}  # (S, C) at 224²
OVERSIZE = (3136, 128)  # mmtm2 at 448²: 1.53 MiB per map in f32
CASES = [(128, S, C) for S, C in SITES.values()] + [(B, 196, 256) for B in (1, 5, 127)] + [(3, *OVERSIZE)]
ITEMSIZE = {"float32": 4, "bfloat16": 2}

# an H100: 132 SMs, 15 clusters of eight 512-thread CTAs at once
# (cudaOccupancyMaxActiveClusters)
CLUSTERS = 15
SMS = 132


def _plan(case, dtype, direction, clusters=CLUSTERS, sms=SMS):
    B, S, C = case
    plan = mg._plan(B, S, C, C, ITEMSIZE[dtype], direction, clusters, sms)
    assert plan is not None
    return plan


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plan_fits_the_card_and_covers_every_row_once(case, dtype, direction):
    B, S, C = case
    plan = _plan(case, dtype, direction)
    assert 1 <= plan.K <= 8
    assert 1 <= plan.n <= mg.MAX_TILE
    assert plan.smem <= mg.SMEM_PER_CTA <= 232_448
    assert plan.smem == mg._smem_bytes(plan.n, plan.nmaps, plan.rows_max, C, C, ITEMSIZE[dtype], direction)
    assert plan.grid == min(plan.tiles, CLUSTERS)

    # the tiles take every sample once
    samples = [b for tile in mg._tile_rows(plan, B) for b in tile]
    assert samples == list(range(B))
    # the cluster's CTAs take every row of a sample once, and each share fits
    spans = [mg._split(S, plan.K, r) for r in range(plan.K)]
    assert [s for lo, size in spans for s in range(lo, lo + size)] == list(range(S))
    assert max(size for _, size in spans) == plan.rows_max

    # every bulk copy moves whole 16-byte units between 16-byte aligned addresses
    copies = mg._bulk_copies(plan, B, S, C, ITEMSIZE[dtype])
    for *_, dst, src, nbytes in copies:
        assert dst % 16 == 0 and src % 16 == 0 and nbytes % 16 == 0 and nbytes > 0
        assert dst + nbytes <= plan.smem
    moved = sum(c[-1] for c in copies)
    assert moved == plan.nmaps * B * S * C * ITEMSIZE[dtype]  # each resident map read once

    if direction == "bwd":
        chunks, rows = plan.chunks, plan.rows_per_chunk
        assert 1 <= chunks <= mg.WG_MAX_CHUNKS
        assert (chunks - 1) * rows < B <= chunks * rows  # no empty chunk, every row


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_oversize_sample_streams_in_f32(direction):
    plan = _plan((3, *OVERSIZE), "float32", direction)
    assert plan.mode == "stream" and plan.nmaps == 0 and plan.n == 1


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_every_224_site_keeps_its_maps_resident(direction, dtype, site):
    """Forward f0, f1 and backward do0, do1 in shared memory, bulk-copied
    once: four map streams forward (f read, out written), six backward (do
    and f read, df written)."""
    plan = _plan((128, *SITES[site]), dtype, direction)
    assert plan.mode == "resident" and plan.nmaps == 2


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("batch", [256, 128])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_the_dp_configs_rank_batches_stay_resident(direction, batch, site):
    """configs/training_dp_v5e8.gin's global batch of 256 in bf16 as a rank
    sees it: all of it at world 1, 128 rows at two ranks."""
    plan = _plan((batch, *SITES[site]), "bfloat16", direction)
    assert plan.mode == "resident" and plan.nmaps == 2 and plan.tiles * plan.n >= batch


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_bf16_oversize_sample_stays_resident(direction):
    """In bf16 the oversize sample's two resident maps fit a cluster (about
    200 KB a CTA)."""
    plan = _plan((3, *OVERSIZE), "bfloat16", direction)
    assert plan.mode == "resident" and plan.n == 1


def test_no_plan_when_the_rows_do_not_fit():
    assert mg._plan(4, 49, 16384, 16384, 4, "fwd", CLUSTERS, SMS) is None


@pytest.mark.parametrize("clusters", [1, 15, 30, 1000])
def test_tile_is_the_smallest_with_the_fewest_waves(clusters):
    """Of the tile sizes whose maps fit, the plan takes the fewest waves of
    tiles over the card's clusters, and of those the smallest tile; the
    persistent grid is never larger than the card holds."""
    B, S, C = 128, 196, 256
    plan = mg._plan(B, S, C, C, 2, "fwd", clusters, SMS)
    assert plan.mode == "resident" and plan.grid == min(plan.tiles, clusters)
    fits = [n for n in range(1, mg.MAX_TILE + 1)
            if mg._smem_bytes(n, 2, plan.rows_max, C, C, 2, "fwd") <= mg.SMEM_PER_CTA]
    waves = {n: -(-(-(-B // n)) // clusters) for n in fits}
    assert waves[plan.n] == min(waves.values())
    assert all(n >= plan.n for n in fits if waves[n] == waves[plan.n])


@pytest.mark.parametrize("sms", [66, 132])
def test_weight_gradient_chunks_fill_the_card(sms):
    """The weight-gradient kernel's batch chunks give at least
    WG_BLOCKS_PER_SM blocks an SM, unless the chunk count or the 8-row
    minimum stops them first."""
    B, S, C = 128, 784, 128
    plan = mg._plan(B, S, C, C, 4, "bwd", CLUSTERS, sms)
    tn, tk = mg.WG_TILE
    blocks = sum(-(-n // tn) * -(-k // tk) for n, k in ((C, 2 * C), (C, C), (C, C)))
    assert plan.rows_per_chunk >= 8 or plan.chunks == 1
    assert blocks * plan.chunks >= mg.WG_BLOCKS_PER_SM * sms or plan.chunks in (mg.WG_MAX_CHUNKS, -(-B // 8))
