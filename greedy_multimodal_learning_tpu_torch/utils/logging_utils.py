"""Logging, stream-tee, and CLI dispatch utilities.

Port of ``greedy_multimodal_learning_tpu/utils/logging_utils.py``: every run
tees stdout/stderr to ``save_path/stdout.txt`` / ``save_path/stderr.txt``,
and the CLI surface is ``prog SAVE_PATH CONFIG.gin [BINDINGS]`` with
``#``-separated config mixins and bindings.
"""

from __future__ import annotations

import argparse
import logging
import logging.handlers
import os
import sys
from contextlib import contextmanager

logger = logging.getLogger(__name__)


class Fork:
    """Write-through tee of two streams."""

    def __init__(self, file1, file2):
        self.file1 = file1
        self.file2 = file2

    def write(self, data):
        self.file1.write(data)
        self.file2.write(data)

    def flush(self):
        self.file1.flush()
        self.file2.flush()

    def isatty(self):
        return getattr(self.file1, "isatty", lambda: False)()


@contextmanager
def _replace_standard_stream(stream_name, file_):
    stream = getattr(sys, stream_name)
    setattr(sys, stream_name, file_)
    try:
        yield
    finally:
        setattr(sys, stream_name, stream)


@contextmanager
def _replace_logging_stream(file_):
    root = logging.getLogger()
    handlers = [h for h in root.handlers if isinstance(h, logging.StreamHandler)]
    saved = [(h, h.stream) for h in handlers]
    for h in handlers:
        h.stream = file_
    try:
        yield
    finally:
        for h, stream in saved:
            h.stream = stream


def run_with_redirection(stdout_path, stderr_path, func):
    """Tee stdout/stderr to files for the duration of ``func``."""

    def func_wrapper(*args, **kwargs):
        with open(stdout_path, "a", 1) as out_dst, open(stderr_path, "a", 1) as err_dst:
            out_fork = Fork(sys.stdout, out_dst)
            err_fork = Fork(sys.stderr, err_dst)
            with _replace_standard_stream("stderr", err_fork):
                with _replace_standard_stream("stdout", out_fork):
                    with _replace_logging_stream(err_fork):
                        return func(*args, **kwargs)

    return func_wrapper


def gin_wrap(fnc):
    """CLI dispatcher: ``prog SAVE_PATH CONFIG [BINDINGS]``.

    Config files are ``#``-separated mixins, bindings are ``#``-separated
    lines.  Under ``torchrun`` only rank 0 writes ``operative_config.gin``
    and tees the output."""
    from .. import config as cfg
    from ..parallel import is_main_process

    parser = argparse.ArgumentParser()
    parser.add_argument("save_path")
    parser.add_argument("config")
    parser.add_argument("bindings", nargs="?", default="")
    args = parser.parse_args()

    cfg.parse_config_files_and_bindings(args.config.split("#"), args.bindings.replace("#", "\n"))
    if not os.path.exists(args.save_path):
        logger.info("Creating folder %s", args.save_path)
        os.makedirs(args.save_path, exist_ok=True)
    if not is_main_process():  # under torchrun, rank 0 writes the run's files
        fnc(args.save_path)
        return
    with open(os.path.join(args.save_path, "operative_config.gin"), "w") as f:
        f.write(cfg.operative_config_str())
    run_with_redirection(
        os.path.join(args.save_path, "stdout.txt"),
        os.path.join(args.save_path, "stderr.txt"),
        fnc,
    )(args.save_path)


def configure_logger(
    name="",
    console_logging_level=logging.INFO,
    file_logging_level=None,
    log_file=None,
):
    """Root/module logger setup."""
    if file_logging_level is None and log_file is not None:
        print("Didnt you want to pass file_logging_level?")

    lg = logging.getLogger(name)
    if len(lg.handlers) != 0:
        return lg

    if console_logging_level is None and file_logging_level is None:
        return lg

    lg.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")

    if console_logging_level is not None:
        ch = logging.StreamHandler(sys.stdout)
        ch.setFormatter(fmt)
        ch.setLevel(console_logging_level)
        lg.addHandler(ch)

    if file_logging_level is not None:
        if log_file is None:
            raise ValueError("If file logging enabled, log_file path is required")
        fh = logging.handlers.RotatingFileHandler(log_file, maxBytes=(1048576 * 5), backupCount=7)
        fh.setFormatter(fmt)
        fh.setLevel(file_logging_level)
        lg.addHandler(fh)

    return lg
