"""The port's device-resident corpus (``data/pipeline.py::DeviceCachePipeline``)
on a CPU device: its batches equal, byte for byte, the port's streamed
batches and the JAX package's ``DeviceCachePipeline`` batches over three
epochs (order, padding, labels, indices, mask); ``set_epoch`` resumes the
order; a corpus over budget streams the same batches after a warning; an
upload error raises; the host cache is released; ``get_mvdcndata`` honours
``device_cache`` and caches by default; and a training run on the cached
corpus ends bit-identical to the streamed run (tests/test_pipeline_cache.py
holds the JAX package to the same).  Every comparison is exact: the cache
copies bytes, it computes nothing."""

import csv
import logging
import os

import numpy as np
import pytest

import torch

from greedy_multimodal_learning_tpu.data import DeviceCachePipeline as JaxDeviceCachePipeline
from greedy_multimodal_learning_tpu.data import MultiviewModelNet as JaxMultiviewModelNet
from greedy_multimodal_learning_tpu.data.synthetic import make_synthetic_modelnet
from greedy_multimodal_learning_tpu_torch import config as port_cfg
from greedy_multimodal_learning_tpu_torch.data import BatchPipeline, MultiviewModelNet, get_mvdcndata
from greedy_multimodal_learning_tpu_torch.data.pipeline import DeviceCachePipeline, wrap_device_cache
from greedy_multimodal_learning_tpu_torch.entries import train

REPO = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The suite runs in several worker processes at once; one thread in
    each keeps the small convolutions from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_port_config():
    port_cfg.clear_config()
    yield
    port_cfg.clear_config()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_modelnet(str(tmp_path_factory.mktemp("cache_data")), n_train=14, n_test=6, num_views=2,
                                   image_size=16, nclasses=3)


def _pipelines(root, *, batch_size=4, shuffle=True, indices=None):
    ds = MultiviewModelNet(root, "train", specific_view=[0, 1])
    indices = list(range(len(ds))) if indices is None else indices
    streamed = BatchPipeline(ds, indices, batch_size, shuffle=shuffle, seed=777)
    cached = DeviceCachePipeline(ds, indices, batch_size, shuffle=shuffle, seed=777, device=CPU)
    return streamed, cached


def _host(batch):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else (v if k == "size" else np.asarray(v))
            for k, v in batch.items()}


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["size"] == w["size"]
        for key in ("images", "labels", "indices", "mask"):
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_cached_equals_streamed_and_the_jax_package_over_three_epochs(root):
    """14 samples in batches of 4: a padded partial batch each epoch."""
    streamed, cached = _pipelines(root)
    jax_ds = JaxMultiviewModelNet(root, "train", specific_view=[0, 1])
    jax_cached = JaxDeviceCachePipeline(jax_ds, range(14), 4, shuffle=True, seed=777)
    for _ in range(3):
        cb = [_host(b) for b in cached]
        _assert_batches_equal(cb, [_host(b) for b in streamed])
        _assert_batches_equal(cb, [_host(b) for b in jax_cached])
    assert cached.resident and cached.epoch == 3
    assert jax_cached._corpus is not None


def test_cached_batches_live_on_the_device(root):
    _, cached = _pipelines(root)
    batch = next(iter(cached))
    for key in ("images", "labels", "mask"):
        assert isinstance(batch[key], torch.Tensor) and batch[key].device == CPU
    assert batch["images"].dtype == torch.uint8 and batch["images"].shape == (4, 2, 16, 16, 3)
    # indices and size stay on the host for the history
    assert isinstance(batch["indices"], np.ndarray) and isinstance(batch["size"], int)
    assert cached.corpus_nbytes() == 15 * 2 * 16 * 16 * 3  # 14 samples and the pad row


def test_set_epoch_resumes_the_streamed_order(root):
    streamed, cached = _pipelines(root)
    streamed.set_epoch(5)
    cached.set_epoch(5)
    order = [np.concatenate([_host(b)["indices"][:b["size"]] for b in p]) for p in (streamed, cached)]
    np.testing.assert_array_equal(*order)


def test_subset_indices_and_the_pad_row(root):
    """A validation-like subset maps through the row table; the padded tail
    is all-zero images, label 0, index -1, mask 0, as ``_collate`` pads."""
    streamed, cached = _pipelines(root, shuffle=False, indices=[11, 3, 7, 0, 9])
    cb = [_host(b) for b in cached]
    _assert_batches_equal(cb, [_host(b) for b in streamed])
    assert [b["size"] for b in cb] == [4, 1]
    tail = cb[-1]
    assert not tail["images"][1:].any() and not tail["labels"][1:].any()
    assert (tail["indices"][1:] == -1).all() and not tail["mask"][1:].any()
    assert tail["indices"][0] == 9


def test_budget_refusal_warns_and_streams_the_same_batches(root, caplog):
    streamed, cached = _pipelines(root, shuffle=False)
    cached.fallback_budget_bytes = 1
    with caplog.at_level(logging.WARNING):
        cb = [_host(b) for b in cached]
    assert not cached.resident and cached._streaming
    assert any("fallback budget" in r.getMessage() and "streaming" in r.getMessage() for r in caplog.records)
    _assert_batches_equal(cb, [_host(b) for b in streamed])
    assert not cached._ensure_corpus()  # latched: no second upload attempt


def test_cuda_budget_reads_the_free_device_memory(root, monkeypatch, caplog):
    """On a CUDA device the corpus may take ``budget_frac`` of the free
    memory ``torch.cuda.mem_get_info`` reports (faked here: no card)."""
    ds = MultiviewModelNet(root, "train", specific_view=[0, 1])
    cached = DeviceCachePipeline(ds, range(14), 4, device="cuda")
    need = cached.corpus_nbytes()
    seen = []

    def mem_get_info(device):
        seen.append(device)
        return free, 80 * 2**30

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    free = 2 * need
    assert cached._budget_ok()
    free = 2 * need - 2
    with caplog.at_level(logging.WARNING):
        assert not cached._budget_ok()
    assert seen == [torch.device("cuda")] * 2
    assert any("free device memory" in r.getMessage() for r in caplog.records)


def test_an_upload_error_raises(root, monkeypatch):
    """Only the budget refusal streams: any other failure of the upload
    raises (the JAX package logs and streams instead)."""
    _, cached = _pipelines(root)

    def broken(*args):
        raise RuntimeError("upload failed")

    monkeypatch.setattr("greedy_multimodal_learning_tpu_torch.data.pipeline.collate_u8", broken)
    with pytest.raises(RuntimeError, match="upload failed"):
        next(iter(cached))
    assert not cached._streaming


def test_host_cache_released_after_upload(root):
    _, cached = _pipelines(root)
    ds = cached.dataset
    assert ds._cache == {}
    pre = ds[0]  # an entry there before the upload stays
    assert cached._ensure_corpus()
    assert list(ds._cache) == [0]
    del pre


@pytest.mark.parametrize("setting, cached", [(True, True), ("auto", True), (False, False)])
def test_get_mvdcndata_device_cache(root, setting, cached):
    loaders = get_mvdcndata(root_dir=root, specific_views=[0, 1], batch_size=4, device_cache=setting, device="cpu")
    assert [isinstance(p, DeviceCachePipeline) for p in loaders] == [cached] * 3
    if cached:
        assert all(p.device == CPU for p in loaders)
        assert [p.shuffle for p in loaders] == [True, False, False]


def test_get_mvdcndata_caches_by_default_and_checks_the_setting(root):
    port_cfg.parse_config_files_and_bindings([], f"get_mvdcndata.root_dir='{root}'")
    assert all(isinstance(p, DeviceCachePipeline) for p in get_mvdcndata(batch_size=4, device="cpu"))
    with pytest.raises(ValueError, match="device_cache"):
        get_mvdcndata(batch_size=4, device_cache="yes")
    streamed, _ = _pipelines(root)
    streamed.epoch = 3
    assert wrap_device_cache(streamed, "auto", "cpu").epoch == 3


def _train(root, save, *extra):
    port_cfg.clear_config()
    port_cfg.parse_config_files_and_bindings([os.path.join(REPO, "configs", "training_guided.gin")], "\n".join([
        f"get_mvdcndata.root_dir='{root}'", "get_mvdcndata.specific_views=[0, 1]", "MMTM_MVCNN.nclasses=3",
        "train.device='cpu'", "train.batch_size=4", "train.lr=0.01", "training_loop.n_epochs=3",
        "MMTM_mitigate.use_pallas=True", *extra,
    ]))
    seen = []
    original = DeviceCachePipeline._ensure_corpus

    def spy(self):
        seen.append(self)
        return original(self)

    DeviceCachePipeline._ensure_corpus = spy
    try:
        trainer = train(str(save))
    finally:
        DeviceCachePipeline._ensure_corpus = original
    with open(os.path.join(save, "history.csv")) as f:
        rows = [{k: v for k, v in r.items() if k not in ("time", "epoch_begin_time", "train_samples_per_sec")}
                for r in csv.DictReader(f)]
    return trainer, rows, seen


def test_cached_training_run_is_bit_identical_to_the_streamed_run(root, tmp_path):
    """The ``train`` entry on the CPU, guided, two epochs: the default
    (cached) run and ``device_cache=False`` end with the same history
    and the same bits in every parameter and buffer."""
    cached, cached_rows, seen = _train(root, tmp_path / "cached")
    streamed, streamed_rows, none = _train(root, tmp_path / "streamed", "get_mvdcndata.device_cache=False")
    assert not none
    assert {p.shuffle for p in seen} == {True, False} and all(p.resident and p.device == CPU for p in seen)
    assert cached_rows == streamed_rows and len(cached_rows) == 2
    assert cached.step == streamed.step == 6  # 11 train samples (3 in val) in batches of 4, two epochs
    got, want = cached.model.state_dict(), streamed.model.state_dict()
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    for key, value in streamed.ctrl.as_dict().items():
        assert torch.equal(getattr(cached.ctrl, key), value), key
