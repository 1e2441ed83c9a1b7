"""The one generator of the benchmark's traffic: a closed camera path of
``loop_frames`` poses and animation time parameters, read from a traffic
mix's parameters (``traffic/<mix>.json``) and the configuration. The mix's
``kind`` names the file ``paths/<kind>.py`` whose ``make(traffic, config,
seed)`` returns the loop's poses, so a new kind of path is a new file. The
path itself is drawn from the mix's ``path_seed``; a run's seed draws only
where in the loop it starts, so every seed renders the same frames in
another order. Pose ``k`` and time parameter ``k`` are those of every
frame ``i`` with ``i % loop_frames == k``, so a faster build renders the
same poses in the same mix, and the path closes: frame ``loop_frames`` is
frame 0.

Time runs at ``fps`` virtual frames a second, the time parameter
``time_scale`` times the virtual seconds (the viewer's ``elapsed * 0.1``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent


def rng(seed: int, kind: str):
    """The generator a path kind draws from, for ``seed``."""
    return np.random.default_rng([int(seed) % (1 << 64), sum(map(ord, kind))])


def time_params(traffic: dict) -> list:
    n, fps, scale = traffic["loop_frames"], traffic["fps"], traffic["time_scale"]
    return [scale * (k + 1) / fps for k in range(n)]


def kind_of(traffic: dict, bench_dir: Path = BENCH_DIR):
    """The ``make`` of the mix's path kind, ``paths/<kind>.py``."""
    from rtbench import manifest

    return manifest.load_module(bench_dir / "paths" / f"{traffic['kind']}.py",
                                "path kind").make


def make(traffic: dict, config: dict, seed: int, bench_dir: Path = BENCH_DIR):
    """(poses, time parameters, start) of the loop as a run with ``seed``
    takes it: ``loop_frames`` of each, the path's pose and time parameter
    ``(k + start) % loop_frames`` at ``k``, a pose a dict of ``position``
    (3 floats), ``yaw`` and ``pitch``."""
    poses = kind_of(traffic, bench_dir)(traffic, config, traffic["path_seed"])
    times = time_params(traffic)
    n = len(poses)
    if n != traffic["loop_frames"]:
        raise ValueError(f"path kind {traffic['kind']!r} made {n} poses, "
                         f"not {traffic['loop_frames']}")
    start = int(rng(seed, "start").integers(n))
    order = [(k + start) % n for k in range(n)]
    return [poses[k] for k in order], [times[k] for k in order], start
