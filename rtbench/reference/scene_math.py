"""Host-side scene math of the reference, in float64: the fly camera's
basis from its pose, the instance animation (``spin`` accumulates a turn
about y on every step; ``orbit`` circles radius 10 about (0, 0, -5) as a
function of the time parameter), and the viewer's key moves."""

from __future__ import annotations

import math

import numpy as np

PITCH_LIMIT = 1.57
SPIN_RATE = math.pi * 1e-4      # radians a step per unit of the time parameter
ORBIT_RATE = math.pi            # radians per unit of the time parameter
ORBIT_CENTER = (0.0, 0.0, -5.0)
ORBIT_RADIUS = 10.0


def front_of(yaw: float, pitch: float) -> np.ndarray:
    cp = math.cos(pitch)
    return np.array([math.cos(yaw) * cp, math.sin(pitch), math.sin(yaw) * cp])


def basis(position, yaw: float, pitch: float) -> np.ndarray:
    """(4, 3) f32 rows: position, right, up, forward of a camera at
    ``position`` looking along ``yaw`` and ``pitch``."""
    front = front_of(yaw, pitch)
    right = np.array([-front[2], 0.0, front[0]])
    right /= np.linalg.norm(right)
    up = np.cross(right, front)
    return np.stack([np.asarray(position, np.float64), right, up, front]).astype(
        np.float32)


def rot_y(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def translate(v) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = v
    return m


def orbit_matrix(time_param: float) -> np.ndarray:
    return (translate(ORBIT_CENTER) @ rot_y(time_param * ORBIT_RATE)
            @ translate((0.0, 0.0, ORBIT_RADIUS)))


def orbit_center(time_param: float) -> np.ndarray:
    """World position of an orbiting instance's object-space origin."""
    return orbit_matrix(time_param)[:3, 3]


def instance_matrices(animations, history) -> list:
    """The 4x4 object-to-world matrix of each instance after the steps
    whose time parameters are ``history``, in order: ``spin`` starts at
    the identity and turns by ``t * SPIN_RATE`` at every step, ``orbit``
    starts at T(0, 0, 5) and is ``orbit_matrix`` of the last step,
    ``static`` stays at the identity."""
    out = []
    for anim in animations:
        if anim == "spin":
            m = np.eye(4)
            for t in history:
                m = m @ rot_y(t * SPIN_RATE)
        elif anim == "orbit":
            m = orbit_matrix(history[-1]) if len(history) else translate((0, 0, 5))
        elif anim == "static":
            m = np.eye(4)
        else:
            raise ValueError(f"unknown animation {anim!r}")
        out.append(m)
    return out


def affine_pair(m: np.ndarray):
    """(o2w, w2o) as (3, 4) f32 of a 4x4 affine matrix."""
    return (m[:3, :4].astype(np.float32),
            np.linalg.inv(m)[:3, :4].astype(np.float32))


class FlyCamera:
    """The viewer's camera moves: keys move along the basis, the mouse
    turns yaw and pitch."""

    MOVES = {"w": ("front", 1.0), "s": ("front", -1.0), "d": ("right", 1.0),
             "a": ("right", -1.0), "e": ("up", 1.0), "q": ("up", -1.0)}

    def __init__(self, position, yaw: float = -math.pi / 2, pitch: float = 0.0):
        self.position = np.asarray(position, np.float64)
        self.yaw, self.pitch = float(yaw), float(pitch)

    def vectors(self) -> dict:
        front = front_of(self.yaw, self.pitch)
        right = np.array([-front[2], 0.0, front[0]])
        right /= np.linalg.norm(right)
        return {"front": front, "right": right, "up": np.cross(right, front)}

    def move(self, key: str, distance: float) -> None:
        axis, sign = self.MOVES[key]
        self.position = self.position + sign * distance * self.vectors()[axis]

    def turn(self, dyaw: float, dpitch: float) -> None:
        self.yaw += dyaw
        self.pitch = max(-PITCH_LIMIT, min(PITCH_LIMIT, self.pitch + dpitch))

    def pose(self) -> dict:
        return {"position": [float(x) for x in self.position],
                "yaw": self.yaw, "pitch": self.pitch}
