"""Stdout tee + seeding utilities (ref train.py:129-151).

Under torch.distributed only rank 0 writes the log and prints
(`tee_stdout`, `say`): the ranks of one host share the results directory
that one process owns."""

from __future__ import annotations

import random
import sys

import numpy as np


def say(*args, **kwargs) -> None:
    """print() on rank 0 (or without a process group) only."""
    from msnv_tpu_torch.parallel.mesh import is_main_process
    if is_main_process():
        print(*args, **kwargs)


def tee_stdout(log_path: str) -> None:
    """Mirror stdout into a line-buffered log file (ref train.py:129-142);
    on rank 0 only."""
    from msnv_tpu_torch.parallel.mesh import is_main_process
    if not is_main_process():
        return
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
