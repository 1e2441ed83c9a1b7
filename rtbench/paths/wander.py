"""``"wander"``: the viewer's keys and mouse from the configuration's
``camera_position`` (yaw -90 degrees, pitch 0): the ``segments`` (keys
held, mouse x and y in raw pixels a second) in an order drawn from the
path seed, ``segment_frames`` frames each, moving ``camera_speed`` times
the time parameter's step per key and turning yaw and pitch by the mouse
times the frame's seconds times ``camera_mouse_sensitivity``; the
segments fill the first half of the loop and the second half retraces it.
"""

from __future__ import annotations

from rtbench.camerapath import rng
from rtbench.reference import scene_math


def make(traffic: dict, config: dict, seed: int) -> list:
    n = traffic["loop_frames"]
    half, seg_frames = n // 2, traffic["segment_frames"]
    segments = traffic["segments"]
    if n % 2 or len(segments) * seg_frames != half:
        raise ValueError("the segments must fill half of an even loop")
    order = rng(seed, "wander").permutation(len(segments))
    dt = 1.0 / traffic["fps"]
    dtp = traffic["time_scale"] * dt
    speed = config["camera_speed"]
    sens = config["camera_mouse_sensitivity"]
    cam = scene_math.FlyCamera(config["camera_position"])
    forward = [cam.pose()]
    for i in order:
        keys, mx, my = segments[i]
        for _ in range(seg_frames):
            for key in keys:
                cam.move(key, speed * dtp)
            if mx or my:
                cam.turn(mx * dt * sens, my * dt * sens)
            forward.append(cam.pose())
    return [forward[k] if k <= half else forward[n - k] for k in range(n)]
