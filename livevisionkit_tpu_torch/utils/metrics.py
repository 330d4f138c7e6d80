"""Trajectory quality metrics for stabilization evaluation.

The reference ships no metrics (SURVEY.md §6); these implement the
BASELINE.md acceptance criteria: absolute trajectory error (ATE) against a
smoothed ideal path and frame-to-frame jitter, both over tracked point
trajectories (T, 2).
"""

from __future__ import annotations

import numpy as np


def jitter(track: np.ndarray) -> float:
    """RMS frame-to-frame displacement of a (T, 2) point track (px)."""
    d = np.diff(np.asarray(track), axis=0)
    return float(np.sqrt((d**2).sum(axis=1).mean()))


def smooth_path(track: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian-smoothed ideal path (reflected boundaries)."""
    track = np.asarray(track)
    radius = max(int(3 * sigma), 1)
    k = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
    k /= k.sum()
    padded = np.pad(track, ((radius, radius), (0, 0)), mode="reflect")
    out = np.stack(
        [np.convolve(padded[:, c], k, mode="valid") for c in range(track.shape[1])],
        axis=1,
    )
    return out


def ate(track: np.ndarray, ideal: np.ndarray) -> float:
    """RMS distance between a track and the ideal path (px)."""
    d = np.asarray(track) - np.asarray(ideal)
    return float(np.sqrt((d**2).sum(axis=1).mean()))
