"""The conditional-utilization-rate analysis, a copy of
``greedy_multimodal_learning_tpu/analysis/utilization.py:35-131`` (pure
numpy; the port imports nothing of the JAX package).

1. a *recording* eval over the train split stores per-batch MMTM squeeze
   maps and the sample indices in ``eval_history_batch/history.pickle``
   (``configs/recording.gin``),
2. :func:`get_mmtm_outputs` puts them back in dataset order with
   ``argsort(test_indices)``,
3. :func:`get_rescale_weights` averages them over the training run's train
   (or val) indices, read from that run's own ``history.pickle``: one
   dataset-average squeeze vector per MMTM and view, which the flow-off eval
   (``configs/eval.gin``) feeds to every MMTM.

Pickles of either package load (numpy arrays, or torch tensors that
``np.array`` converts).
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def _load_history(save_path):
    with open(os.path.join(save_path, "history.pickle"), "rb") as f:
        return pickle.load(f)


def _selected_indices(training_save_path, validation):
    history = _load_history(training_save_path)
    return np.asarray(history["val_indices"][0] if validation else history["train_indices"][0])


def get_mmtm_outputs(eval_save_path, mmtm_recorded, key):
    """The recorded maps in dataset order: one {view: (num_samples, C)
    array} dict per fusion module.  The recording nests epoch -> batch ->
    module -> view; per (module, view) the batches are concatenated and
    reordered by ``argsort(test_indices)``."""
    recording = _load_history(eval_save_path)

    per_module = [{} for _ in range(mmtm_recorded)]
    for batch_maps in recording[key][0]:
        if len(batch_maps) != mmtm_recorded:
            raise ValueError(f"{key}: a batch holds {len(batch_maps)} fusion modules, expected {mmtm_recorded}")
        for module_maps, view_maps in zip(per_module, batch_maps):
            for view_id, chunk in enumerate(view_maps):
                module_maps.setdefault(view_id, []).append(np.array(chunk))

    dataset_order = np.argsort(np.asarray(recording["test_indices"][0]))
    return [
        {view_id: np.concatenate(chunks)[dataset_order] for view_id, chunks in module_maps.items()}
        for module_maps in per_module
    ]


def get_rescale_weights(
    eval_save_path,
    training_save_path,
    key="test_squeezedmaps_array_list",
    validation=False,
    starting_mmtmindice=1,
    mmtmpositions=4,
):
    """Per-MMTM per-view dataset-average squeeze maps as float32 (C,)
    arrays; positions below ``starting_mmtmindice`` have no MMTM and are
    None.

    Fast path: a recording run with ``evalution_loop.ondevice_rescale``
    writes the means as ``rescale_means.pkl`` beside the recording
    (:mod:`.ondevice_rescale`).  They are returned when the file was made
    for this ``key`` and ``validation`` over exactly the index set this call
    selects from ``training_save_path``; otherwise the per-sample pickle is
    read."""
    from .ondevice_rescale import RESCALE_MEANS_FILENAME

    fast = os.path.join(eval_save_path, RESCALE_MEANS_FILENAME)
    if os.path.exists(fast):
        with open(fast, "rb") as f:
            blob = pickle.load(f)
        want = _selected_indices(training_save_path, validation)
        selection_matches = "selected" in blob and np.array_equal(np.asarray(blob["selected"]), want)
        if blob.get("key") == key and bool(blob.get("validation")) == bool(validation) and selection_matches:
            modules = blob["means"]  # {module_index: {view_index: (C,)}}
            weights = []
            for position in range(mmtmpositions):
                if position < starting_mmtmindice:
                    weights.append(None)
                    continue
                per_view = modules[position - starting_mmtmindice]
                weights.append([np.asarray(per_view[v], np.float32) for v in sorted(per_view)])
            return weights

    modules = get_mmtm_outputs(eval_save_path, mmtmpositions - starting_mmtmindice, key)
    selected_indices = _selected_indices(training_save_path, validation)

    mmtm_weights = []
    for position in range(mmtmpositions):
        if position < starting_mmtmindice:
            mmtm_weights.append(None)
            continue
        module_maps = modules[position - starting_mmtmindice]
        mmtm_weights.append(
            [np.asarray(module_maps[view_id][selected_indices].mean(0), np.float32) for view_id in sorted(module_maps)]
        )
    return mmtm_weights
