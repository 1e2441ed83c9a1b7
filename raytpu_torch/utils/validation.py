"""Render-path validation of the port (counterpart of
``raytpu/utils/validation.py``).

The analog of the reference's Vulkan validation layers
(``src/main.cpp:813-848``, gated by ``VALIDATION_LAYERS_ENABLED`` in
``include/config.h:24``), enabled by ``RenderConfig.validation=True``: the
device scene is checked when the ``Renderer`` builds it
(:func:`check_scene`), every frame before it leaves the ``Renderer``
(:func:`check_frame`), and the bounce loops' radiance and final directions
at the end of every wave (:func:`guard`). Failures report through
``log.fail`` (``RaytpuError``), the guard through ``log.error``.
:func:`interpret_kernels` is the port's kernel-debugging switch, the plain
PyTorch versions in place of the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.utils import log


def check_scene(ts) -> None:
    """Structural checks on a built :class:`TorchScene` (:25): finite
    triangles, transforms and light, materials in 0..2, and per mesh skip
    links that point forward and at most one past the mesh's last node."""
    for name in ("bvh_tri_v0", "bvh_tri_e1", "bvh_tri_e2", "tri_packed", "o2w",
                 "w2o", "light_pos"):
        arr = getattr(ts, name)
        if arr is not None and not bool(torch.isfinite(arr).all()):
            log.fail(f"scene array {name} contains non-finite values")
    mats = ts.materials.cpu().numpy()
    if mats.size and (mats.min() < 0 or mats.max() > 2):
        log.fail(f"material types out of range 0..2: {mats}")
    if ts.bvh_miss is not None:
        miss = ts.bvh_miss.cpu().numpy()
        for base, count in sorted({(r[2], r[3]) for r in ts.entry_rows}):
            m = miss[base:base + count]
            if not ((m > np.arange(count)) & (m <= count)).all():
                log.fail("BVH skip links are not monotone — corrupt build")
    log.verbose("scene validation passed")


def check_frame(image, context: str = "frame") -> None:
    """Post-render guard (:48): non-finite values fail, radiance above 1e3
    warns. ``image`` is an (H, W, 3) tensor or array."""
    img = image.cpu().numpy() if isinstance(image, torch.Tensor) else np.asarray(image)
    bad = ~np.isfinite(img)
    if bad.any():
        ys, xs = np.nonzero(bad.any(axis=-1))
        log.fail(
            f"{context}: {bad.sum()} non-finite values "
            f"(first at pixel x={xs[0]}, y={ys[0]})"
        )
    if img.max() > 1e3:
        log.warning(
            f"{context}: radiance exceeds 1e3 (max {img.max():.3g}) — "
            "suspicious for this integrator"
        )


def guard(arrays, context: str, stats=None):
    """Count the non-finite values of ``arrays`` (same-device tensors) and
    report a non-zero count through ``log.error`` (``jit_guard`` :65).

    The count is read on the host: one device sync per call, counted in
    ``stats["host_syncs"]`` when ``stats`` is a dict. The bounce loops call
    it only with ``RenderStatic.validation`` on, so a frame without
    validation pays no operation and no sync for it. Returns ``arrays``."""
    bad = sum((~torch.isfinite(a)).sum() for a in arrays)
    if stats is not None:
        stats["host_syncs"] = stats.get("host_syncs", 0) + 1
    n = int(bad.item())
    if n > 0:
        log.error(f"validation: {n} non-finite values in {context}")
    return arrays


def interpret_kernels():
    """Within the block, frames run each kernel's plain PyTorch version
    (``integrator.plain_kernels``; raytpu's forces Pallas interpret mode,
    :92)."""
    from raytpu_torch.integrator import plain_kernels

    return plain_kernels()
