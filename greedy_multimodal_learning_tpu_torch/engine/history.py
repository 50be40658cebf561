"""History sink: ``history.csv`` (scalar columns) and ``history.pickle``
(the whole structure), as ``greedy_multimodal_learning_tpu/engine/history.py:24-47``
writes them.  The CSV is written with the csv module in the layout of
``pandas.DataFrame.to_csv(index=False)``: a header row, then one row per
epoch, floats as ``repr``."""

from __future__ import annotations

import csv
import logging
import os
import pickle

import numpy as np

logger = logging.getLogger(__name__)

TYPES_TO_SAVE_IN_CSV = (int, float, complex, np.int64, np.int32, np.float32, np.float64, str, bool)


def append_to_history(epoch, logs, H):
    for key, value in logs.items():
        H.setdefault(key, []).append(value)


def save_history(epoch, logs, save_path, H, save_with_structure=False):
    logger.info("".join(f"{k}={v}\t" for k, v in logs.items() if isinstance(v, TYPES_TO_SAVE_IN_CSV)))
    path = os.path.join(save_path, "history.csv")
    logger.info("Saving history to %s", path)
    columns = {k: v for k, v in H.items() if v and isinstance(v[-1], TYPES_TO_SAVE_IN_CSV)}
    rows = len(next(iter(columns.values()))) if columns else 0
    if any(len(v) != rows for v in columns.values()):
        raise ValueError("history columns of unequal length: " + str({k: len(v) for k, v in columns.items()}))
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for r in range(rows):
            writer.writerow([repr(float(v[r])) if isinstance(v[r], (float, np.floating)) else v[r]
                             for v in columns.values()])
    if save_with_structure:
        with open(os.path.join(save_path, "history.pickle"), "wb") as f:
            pickle.dump(H, f, pickle.HIGHEST_PROTOCOL)
