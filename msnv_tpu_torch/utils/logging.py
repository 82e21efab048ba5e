"""Stdout tee + seeding utilities (ref train.py:129-151)."""

from __future__ import annotations

import random
import sys

import numpy as np


def tee_stdout(log_path: str) -> None:
    """Mirror stdout into a line-buffered log file (ref train.py:129-142)."""
    log_file = open(log_path, "a", 1)
    stdout = sys.stdout

    class Tee:
        def write(self, string):
            log_file.write(string)
            stdout.write(string)

        def flush(self):
            log_file.flush()
            stdout.flush()

    sys.stdout = Tee()


def init_random_seed(seed: int) -> None:
    """Seed python + numpy (ref train.py:145-151). torch generators are
    explicit."""
    random.seed(seed)
    np.random.seed(seed)
