"""Determinism helper (port of ``utils/seed.py``).

``set_seed`` seeds the host-side RNGs (python's ``random``, numpy's global
state, and ``PYTHONHASHSEED`` for subprocesses) and returns a CPU
``torch.Generator`` seeded the same way, from which a caller draws its torch
randomness explicitly instead of from torch's global state.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
