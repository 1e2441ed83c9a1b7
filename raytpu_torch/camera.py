"""The port's own copy of ``raytpu/camera.py`` (the port imports nothing of
``raytpu``).

Fly camera with yaw/pitch Euler angles.

Semantics match the reference camera exactly (``src/camera.cpp:8-143`` +
``include/camera.h:16-35``):

* basis recompute: ``front = (cos(yaw)·cos(pitch), sin(pitch), sin(yaw)·cos(pitch))``,
  ``right = normalize(-front.z, 0, front.x)``, ``up = right × front``
  (``src/camera.cpp:16-25``);
* pitch clamped to ±1.57 rad (``src/camera.cpp:6,96-103``);
* movement along right/up/front basis vectors (``src/camera.cpp:66-89``);
* axis-snap ``look()`` presets (``src/camera.cpp:108-143``);
* default pose ``(0, 0, 20)`` looking down −Z (``include/camera.h:25``,
  initial ``yaw = −π/2`` ``src/camera.cpp:11``).

The camera is deliberately *host-side* state (plain Python floats / NumPy):
the jitted render step consumes only the packed basis via :meth:`basis`, so
interactive camera updates never trigger a retrace/recompile — the TPU analog
of the reference re-uploading the uniform buffer each frame
(``src/main.cpp:2879-2903``).
"""

from __future__ import annotations

import enum
import math
from typing import Tuple

import numpy as np

PITCH_LIMIT = 1.57  # src/camera.cpp:6


class MoveDirection(enum.IntEnum):
    """Movement directions (``include/camera.h:6-14``)."""

    RIGHT = 0
    LEFT = 1
    UP = 2
    DOWN = 3
    FORWARD = 4
    BACKWARD = 5


class Camera:
    def __init__(self, position: Tuple[float, float, float] = (0.0, 0.0, 20.0)):
        self.position = np.asarray(position, dtype=np.float64)
        self.pitch = 0.0
        self.yaw = -math.pi / 2.0  # src/camera.cpp:11
        self._update_vectors()

    # --- basis maintenance (src/camera.cpp:16-25) ---
    def _update_vectors(self) -> None:
        cp = math.cos(self.pitch)
        self.front = np.array(
            [math.cos(self.yaw) * cp, math.sin(self.pitch), math.sin(self.yaw) * cp],
            dtype=np.float64,
        )
        r = np.array([-self.front[2], 0.0, self.front[0]], dtype=np.float64)
        self.right = r / np.linalg.norm(r)
        self.up = np.cross(self.right, self.front)

    # --- movement (src/camera.cpp:66-89) ---
    def move(self, direction: MoveDirection, distance: float) -> None:
        d = MoveDirection(direction)
        if d == MoveDirection.RIGHT:
            self.position = self.position + distance * self.right
        elif d == MoveDirection.LEFT:
            self.position = self.position - distance * self.right
        elif d == MoveDirection.UP:
            self.position = self.position + distance * self.up
        elif d == MoveDirection.DOWN:
            self.position = self.position - distance * self.up
        elif d == MoveDirection.FORWARD:
            self.position = self.position + distance * self.front
        elif d == MoveDirection.BACKWARD:
            self.position = self.position - distance * self.front

    # --- mouse look (src/camera.cpp:91-106); offsets are pre-scaled by
    # sensitivity by the caller, as in src/main.cpp:2870-2871 ---
    def process_mouse_movement(self, xoffset: float, yoffset: float) -> None:
        self.yaw += xoffset
        self.pitch += yoffset
        self.pitch = max(-PITCH_LIMIT, min(PITCH_LIMIT, self.pitch))
        self._update_vectors()

    # --- axis-snap look presets (src/camera.cpp:108-143) ---
    def look(self, direction: MoveDirection) -> None:
        table = {
            MoveDirection.RIGHT: ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
            MoveDirection.LEFT: ((-1, 0, 0), (0, 1, 0), (0, 0, -1)),
            MoveDirection.UP: ((0, 1, 0), (0, 0, 1), (1, 0, 0)),
            MoveDirection.DOWN: ((0, -1, 0), (0, 0, -1), (1, 0, 0)),
            MoveDirection.FORWARD: ((0, 0, -1), (0, 1, 0), (1, 0, 0)),
            MoveDirection.BACKWARD: ((0, 0, 1), (0, 1, 0), (-1, 0, 0)),
        }
        front, up, right = table[MoveDirection(direction)]
        self.front = np.asarray(front, dtype=np.float64)
        self.up = np.asarray(up, dtype=np.float64)
        self.right = np.asarray(right, dtype=np.float64)

    # --- packed basis for the jitted render step ---
    def basis(self) -> np.ndarray:
        """(4, 3) float32: rows = position, right, up, forward.

        This is the TPU-side mirror of ``UniformStructure.camera*``
        (``src/main.cpp:1848-1851`` / ``src/shader.rgen:23-26``).
        """
        return np.stack(
            [self.position, self.right, self.up, self.front], axis=0
        ).astype(np.float32)

    def view_matrix(self) -> np.ndarray:
        """4×4 right-handed look-at view matrix (``src/camera.cpp:60-64``).

        Unused by the ray-traced path (which consumes raw basis vectors), kept
        for API parity with ``Camera::getViewingMatrix``.
        """
        f = self.front / np.linalg.norm(self.front)
        s = np.cross(f, self.up)
        s = s / np.linalg.norm(s)
        u = np.cross(s, f)
        m = np.eye(4, dtype=np.float64)
        m[0, :3] = s
        m[1, :3] = u
        m[2, :3] = -f
        m[0, 3] = -np.dot(s, self.position)
        m[1, 3] = -np.dot(u, self.position)
        m[2, 3] = np.dot(f, self.position)
        return m

    def view_matrix_without_translation(self) -> np.ndarray:
        """``src/camera.cpp:54-58``."""
        m = self.view_matrix()
        out = m.copy()
        out[:3, 3] = 0.0
        return out

    # --- state checkpointing (no reference analog — the reference loses all
    # camera state on exit; SURVEY.md §5 "checkpoint/resume") ---
    def state_dict(self) -> dict:
        # the basis is serialized explicitly: look() sets front/up/right
        # WITHOUT touching yaw/pitch (faithful to src/camera.cpp:108-143),
        # so yaw/pitch alone cannot reconstruct a post-look() pose
        return {
            "position": [float(x) for x in self.position],
            "yaw": float(self.yaw),
            "pitch": float(self.pitch),
            "front": [float(x) for x in self.front],
            "up": [float(x) for x in self.up],
            "right": [float(x) for x in self.right],
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "Camera":
        cam = cls(tuple(state["position"]))
        cam.yaw = float(state["yaw"])
        cam.pitch = float(state["pitch"])
        cam._update_vectors()
        for name in ("front", "up", "right"):
            if name in state:
                setattr(cam, name, np.asarray(state[name], dtype=np.float64))
        return cam

    def save(self, path: str) -> None:
        import json

        with open(path, "w") as fh:
            json.dump(self.state_dict(), fh)

    @classmethod
    def load(cls, path: str) -> "Camera":
        import json

        with open(path) as fh:
            return cls.from_state_dict(json.load(fh))
