"""In-process runs of the entries (``greedy_multimodal_learning_tpu/run_api.py``).

``run_entry("train", save, config, bindings)`` does what ``python -m
greedy_multimodal_learning_tpu_torch.train SAVE CONFIG BINDINGS`` does, in
the calling process: it clears the parsed bindings, parses the
``#``-separated config mixins and bindings, writes ``operative_config.gin``,
tees stdout and stderr into the save directory and calls the entry.  So a
train, a recording and a flow-off phase can follow one another in one
process, each starting from a clean configuration.  Under ``torchrun`` it
starts ``torch.distributed`` first (:func:`~.parallel.maybe_initialize_distributed`),
and only rank 0 writes ``operative_config.gin`` and tees the output.
"""

from __future__ import annotations

import gc
import logging
import os

from . import config as cfg
from .parallel import is_main_process, maybe_initialize_distributed
from .utils.logging_utils import run_with_redirection

logger = logging.getLogger(__name__)

__all__ = ["run_entry"]


def run_entry(entry, save_path, config, bindings="", redirect=True):
    """Run the ``"train"`` or ``"eval"`` entry in this process
    (``run_api.py:35-88``).

    ``config``: ``#``-separated gin files, as the CLI's CONFIG; ``bindings``:
    ``#``-separated ``Name.param=value`` lines, as its BINDINGS; ``redirect``
    tees stdout and stderr to ``save_path/stdout.txt`` and ``stderr.txt``
    (rank 0's, under ``torchrun``).
    Returns what the entry returns.  The bindings are cleared afterwards,
    also after a parse error."""
    from . import entries

    fns = {"train": entries.train, "eval": entries.eval_}
    if entry not in fns:
        raise ValueError(f"entry must be one of {sorted(fns)}, got {entry!r}")
    fn = fns[entry]
    maybe_initialize_distributed()  # run_api.py:61-66
    cfg.clear_config()
    try:
        # inside the try: a bindings string that fails half-way must not leave
        # its first lines applied for the caller's next phase
        cfg.parse_config_files_and_bindings(config.split("#"), bindings.replace("#", "\n"))
        if not os.path.exists(save_path):
            logger.info("Creating folder %s", save_path)
            os.makedirs(save_path, exist_ok=True)
        main = is_main_process()
        if main:
            with open(os.path.join(save_path, "operative_config.gin"), "w") as f:
                f.write(cfg.operative_config_str())
        call = fn
        if redirect and main:
            call = run_with_redirection(os.path.join(save_path, "stdout.txt"),
                                        os.path.join(save_path, "stderr.txt"), fn)
        return call(save_path)
    finally:
        cfg.clear_config()
        gc.collect()  # the finished phase's model and corpus before the next phase allocates its own
