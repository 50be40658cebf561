from .logging_utils import Fork, configure_logger, gin_wrap, run_with_redirection
