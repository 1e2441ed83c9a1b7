"""What decides ``correct``: the frames of the window checked, the pixels
of each compared, and the numbers compared with the cell's limits
(``limits/<cell>.json``).

The window's frames ``j * loop + k_j`` for ``j < frames`` are checked,
``k_j`` distinct poses drawn from the seed (frames of loops the window
did not reach are not). In each, ``pixels`` distinct pixels drawn from the
seed and the frame index are compared with the reference's colours by
their largest channel gap. The numbers, each the worst over the checked
frames: ``over_share``, the share of compared pixels whose gap exceeds
``gap_threshold`` (one 8-bit level), and ``gap_mean``, the mean gap. A
non-finite pixel is a gap of infinity."""

from __future__ import annotations

import numpy as np

NUMBERS = ("over_share", "gap_mean")


def _rng(seed: int, *salt: int):
    return np.random.default_rng([int(seed) % (1 << 64), *salt])


def checked_frames(seed: int, loop: int, frames: int) -> list:
    ks = _rng(seed, 1).choice(loop, size=frames, replace=False)
    return [j * loop + int(k) for j, k in enumerate(ks)]


def sample_pixels(seed: int, frame: int, width: int, height: int, n: int) -> np.ndarray:
    """(n, 2) int64 distinct pixels (x, y)."""
    idx = _rng(seed, 2, frame).choice(width * height, size=min(n, width * height),
                                      replace=False)
    return np.stack([idx % width, idx // width], axis=1)


def gaps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Largest channel gap per pixel of (P, 3) colours; infinite where
    ``got`` is not finite."""
    g = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max(axis=1)
    return np.where(np.isfinite(g), g, np.inf)


def numbers(frame_gaps, threshold: float) -> dict:
    """The compared numbers, each the worst over the frames' gap arrays."""
    return {"over_share": max(float((g > threshold).mean()) for g in frame_gaps),
            "gap_mean": max(float(g.mean()) for g in frame_gaps)}


def judge(found: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` for every limited number."""
    return {k: {"value": found[k], "limit": limits[k]} for k in NUMBERS}


def passed(judged: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in judged.values())
