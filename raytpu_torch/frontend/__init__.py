"""Frontends of the port (counterparts of ``raytpu/frontend``): headless
stills and sequences, and the scripted flythrough. The windowed viewer
(``raytpu/frontend/interactive.py``) is not ported yet."""

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
