"""Frontends of the port (counterparts of ``raytpu/frontend``): headless
stills and sequences, the scripted flythrough, and the windowed viewer
(``frontend/interactive.py``, imported on its own: it needs cv2 when it
runs)."""

from raytpu_torch.frontend.headless import render_sequence, render_still
from raytpu_torch.frontend.flythrough import (
    DEFAULT_SCRIPT,
    Flythrough,
    ScriptSegment,
)

__all__ = [
    "DEFAULT_SCRIPT",
    "Flythrough",
    "ScriptSegment",
    "render_sequence",
    "render_still",
]
