"""The port's host library ``csrc/fastio.cc`` (built with g++ at first use):
its batch collation and view gather give exactly the bytes of their numpy
versions and of the JAX package's ``utils/native.py``, zero padding
included, and the port's pipeline and dataset use them.  Byte equality:
these are copies, no arithmetic."""

import numpy as np
import pytest

from greedy_multimodal_learning_tpu.utils import native as jax_native
from greedy_multimodal_learning_tpu_torch.data import BatchPipeline, MultiviewModelNet
from greedy_multimodal_learning_tpu_torch.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu_torch.ops import build
from greedy_multimodal_learning_tpu_torch.utils import native


def _samples(n, shape=(2, 7, 5, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]


def test_library_builds_into_the_hashed_build_dir():
    native.lib()
    path = build.library_path("fastio")
    assert path.exists() and path.parent == build.BUILD_DIR and path.name.startswith("libfastio-")
    # a host source hashes no CUDA header
    assert build._source("fastio").suffix == ".cc"


@pytest.mark.parametrize("n, batch", [(5, 8), (4, 4), (1, 3)], ids=["padded", "full", "one"])
def test_collate_matches_numpy_and_the_jax_package(n, batch):
    samples = _samples(n)
    got = native.collate_u8(samples, batch)
    want = native.collate_u8_numpy(samples, batch)
    assert got.shape == (batch, 2, 7, 5, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_native.collate_u8(samples, batch))
    assert not got[n:].any()


def test_collate_copies_a_noncontiguous_sample():
    base = _samples(1, (4, 6, 3))[0]
    view = base[:, ::2]
    np.testing.assert_array_equal(native.collate_u8([view], 2)[0], view)


@pytest.mark.parametrize("bad, match", [
    (lambda: native.collate_u8([], 2), "0 samples"),
    (lambda: native.collate_u8(_samples(3), 2), "3 samples for a batch of 2"),
    (lambda: native.collate_u8(_samples(1) + [np.zeros((2, 7, 5, 3), np.float32)], 2), "float32"),
    (lambda: native.collate_u8(_samples(1) + _samples(1, (2, 7, 5, 1)), 2), r"\(2, 7, 5, 1\)"),
], ids=["empty", "overflow", "dtype", "shape"])
def test_collate_rejects_bad_input(bad, match):
    with pytest.raises(ValueError, match=match):
        bad()


@pytest.mark.parametrize("views", [[0, 6], [11, 0, 3], [2]])
def test_gather_views_matches_numpy_and_the_jax_package(views):
    stack = _samples(1, (12, 6, 5, 3), seed=1)[0]
    got = native.gather_views_u8(stack, views)
    assert got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, native.gather_views_u8_numpy(stack, views))
    np.testing.assert_array_equal(got, jax_native.gather_views_u8(stack, views))


@pytest.mark.parametrize("views, stack", [
    ([0, 4], np.zeros((4, 2, 2, 3), np.uint8)),
    ([], np.zeros((4, 2, 2, 3), np.uint8)),
    ([0], np.zeros((4, 2, 2, 3), np.float32)),
], ids=["out_of_range", "empty", "dtype"])
def test_gather_views_rejects_bad_input(views, stack):
    with pytest.raises(ValueError):
        native.gather_views_u8(stack, views)


def test_pipeline_and_dataset_use_the_library(tmp_path, monkeypatch):
    """The streamed pipeline's batches come through ``collate_u8`` and the
    dataset's views through ``gather_views_u8``, and equal their numpy
    versions, the padded rows zero."""
    root = make_synthetic_modelnet(str(tmp_path), n_train=5, n_test=2, num_views=3, image_size=8)
    calls = {"collate": 0, "gather": 0}
    from greedy_multimodal_learning_tpu_torch.data import modelnet, pipeline

    def counting(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(pipeline, "collate_u8", counting("collate", native.collate_u8))
    monkeypatch.setattr(modelnet, "gather_views_u8", counting("gather", native.gather_views_u8))
    ds = MultiviewModelNet(root, "train", specific_view=[2, 0])
    b0, b1 = list(BatchPipeline(ds, range(5), batch_size=4, shuffle=False, prefetch=0))
    assert calls == {"collate": 2, "gather": 5}
    full = np.load(f"{root}/train/{ds.samples[0]['model']}.npy")
    np.testing.assert_array_equal(b0["images"][0], native.gather_views_u8_numpy(full, [2, 0]))
    np.testing.assert_array_equal(b1["images"], native.collate_u8_numpy([ds[4][1]], 4))
