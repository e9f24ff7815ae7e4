"""The comparison that decides ``correct``: the program's uint8 pixels
against the reference's, pixel by pixel, at the same samples."""

from __future__ import annotations

import numpy as np


def u8_mean_abs(program: np.ndarray, reference: np.ndarray) -> float:
    """The mean absolute difference, in uint8 levels, of two (P, 3) uint8
    arrays of the same pixels."""
    if program.shape != reference.shape:
        raise ValueError(f"shapes differ: {program.shape} against {reference.shape}")
    return float(np.abs(program.astype(np.int64) - reference.astype(np.int64)).mean())
