"""``"track"``: the camera follows the instance ``anchor_object``, with any
animation, looking at the origin of its object space (the target) as the
instance carries it: an ``orbit`` moves it with the time parameter,
``static`` and ``spin`` hold it (a spin turns about that origin).

The camera sits on the horizontal line from ``facing``'s point through
the target, beyond the target: ``"outward"`` (the default) from the world
origin, so the camera is on the far side of the target from the scene's
centre; ``"camera"`` from the target towards the configuration's
``camera_position``, so the camera is on the viewer's side. Its distance
runs once through ``distance`` (min, max) in a loop, raised by an
elevation that runs once through ``elevation_deg``; it looks at the
target, its yaw and pitch wobbling by up to ``wobble_deg`` at the
harmonics ``wobble_harmonics`` of the loop, the phases drawn.
"""

from __future__ import annotations

import math

import numpy as np

from rtbench.camerapath import rng, time_params
from rtbench.reference import scene_math


def _carried(anim: str, t: float) -> np.ndarray:
    if anim == "orbit":
        return scene_math.orbit_matrix(t)
    if anim in ("static", "spin"):
        return np.eye(4)
    raise ValueError(f"unknown animation {anim!r}")


def make(traffic: dict, config: dict, seed: int) -> list:
    n = traffic["loop_frames"]
    anim = config["objects"][traffic["anchor_object"]]["animation"]
    facing = traffic.get("facing", "outward")
    if facing not in ("outward", "camera"):
        raise ValueError(f"facing is 'outward' or 'camera', not {facing!r}")
    ph = rng(seed, "track").uniform(0.0, 2.0 * math.pi, 4)
    d_lo, d_hi = traffic["distance"]
    e_lo, e_hi = (math.radians(x) for x in traffic["elevation_deg"])
    wob = math.radians(traffic["wobble_deg"])
    hy, hp = traffic["wobble_harmonics"]
    poses = []
    for k, t in enumerate(time_params(traffic)):
        a = 2.0 * math.pi * k / n
        dist = 0.5 * (d_lo + d_hi) + 0.5 * (d_hi - d_lo) * math.sin(a + ph[0])
        elev = 0.5 * (e_lo + e_hi) + 0.5 * (e_hi - e_lo) * math.sin(a + ph[1])
        centre = _carried(anim, t)[:3, 3]
        away = centre if facing == "outward" else (
            np.asarray(config["camera_position"], np.float64) - centre)
        radial = np.array([away[0], 0.0, away[2]])
        length = np.linalg.norm(radial)
        if length < 1e-9:
            other = "camera" if facing == "outward" else "outward"
            raise ValueError(f"facing {facing!r} gives no horizontal direction "
                             f"at the target {centre.tolist()}: use {other!r}")
        radial /= length
        offset = math.cos(elev) * radial + np.array([0.0, math.sin(elev), 0.0])
        position = centre + dist * offset
        look = -offset
        yaw = math.atan2(look[2], look[0]) + wob * math.sin(hy * a + ph[2])
        pitch = math.asin(look[1]) + wob * math.sin(hp * a + ph[3])
        poses.append({"position": [float(x) for x in position], "yaw": yaw,
                      "pitch": max(-scene_math.PITCH_LIMIT,
                                   min(scene_math.PITCH_LIMIT, pitch))})
    return poses
