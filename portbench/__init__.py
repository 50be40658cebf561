"""The benchmark of the PyTorch and CUDA port,
``greedy_multimodal_learning_tpu_torch``, on one NVIDIA H100: the harness,
its yardstick (traffic, FLOP and byte counts, peaks, trace reduction) and
the plain reference that decides ``correct``.  ``run.py`` runs one cell;
``README.md`` says how to add one."""
