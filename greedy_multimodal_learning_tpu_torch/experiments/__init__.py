"""The paper's run-level experiment on the port: the counterparts of the
JAX package's drivers under ``tools/``, copied and not imported.

* :mod:`.imbalanced_modelnet` and :mod:`.imbalanced_nvgesture` make the
  modality-imbalanced corpora from a seed (``tools/make_imbalanced_*.py``:
  the same arguments write the same bytes);
* :mod:`.common` runs a train or eval phase as a subprocess of the port's
  entry or in this process (``tools/driver_common.py``);
* :mod:`.northstar` (two-view ModelNet, ``tools/run_northstar.py``) and
  :mod:`.northstar3d` (RGB + depth + flow clips, ``tools/run_northstar3d.py``)
  train each arm and seed to convergence, run the recording and flow-off
  passes on its best-val checkpoint and write the summary JSON that
  :mod:`.analyze` reads (``tools/analyze_northstar*.py``, copied), and
  holds against a reference summary (:func:`.analyze.compare`);
* :mod:`.shards` runs a suite's seeds over several driver processes side
  by side on one card and merges their summaries; :mod:`.shard_check`
  trains one run alone and side by side under deterministic cuDNN and
  compares the histories.

The drivers read each run's ``history.csv`` with the standard library, where
the originals use pandas (:func:`.common.read_history`).
"""
