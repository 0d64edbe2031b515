"""stdout tee logger (port of mapfree_tpu/utils/logger.py; reference
lib/utils/logger.py:4-20).

The JAX package's ``set_log`` replaces ``sys.stdout`` for the rest of the
process; :func:`tee_stdout` does so for a block and puts the previous
``sys.stdout`` back after it, closing the file, so that a caller can run the
evaluation CLIs' ``main(argv)`` more than once in one process.
"""

from __future__ import annotations

import contextlib
import sys


class Logger:
    """Writes to both the terminal and a log file."""

    def __init__(self, filepath):
        self.terminal = sys.stdout
        self.log = open(filepath, "a")

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        self.log.close()


@contextlib.contextmanager
def tee_stdout(filepath):
    """Inside the block, standard output also goes to ``filepath``."""
    logger = Logger(filepath)
    sys.stdout = logger
    try:
        yield logger
    finally:
        sys.stdout = logger.terminal
        logger.close()
