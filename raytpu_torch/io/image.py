"""The port's own copy of ``raytpu/io/image.py`` (the port imports nothing
of ``raytpu``): skybox face decode and framebuffer writeback.

* decode: six RGB JPEG faces in the order right, left, top, bottom, front,
  back (``src/main.cpp:2064-2079``), the cubemap layer order +X, -X, +Y,
  -Y, +Z, -Z of a Vulkan cube image, with PIL, and where PIL is missing
  with the native decoder (``io/native.py``), as the JAX package does;
* writeback: PNG and PPM files in place of the reference's swapchain
  (``src/main.cpp:2597-2735``). The PNG encoder is the JAX package's own,
  on the standard library's zlib, so both packages write the same bytes
  for the same image.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence

import numpy as np

# Face order right,left,top,bottom,front,back == +X,-X,+Y,-Y,+Z,-Z
# (src/main.cpp:2064-2079)
SKYBOX_FACE_FILES: Sequence[str] = (
    "right.jpg",
    "left.jpg",
    "top.jpg",
    "bottom.jpg",
    "front.jpg",
    "back.jpg",
)


def read_image(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8 RGB with PIL, or where PIL
    is missing with the native JPEG decoder (``raytpu/io/image.py:40``)."""
    try:
        from PIL import Image
    except ImportError:
        from raytpu_torch.io import native

        if native.available():
            return native.read_jpeg(path)
        raise RuntimeError(f"no JPEG decoder available for {path}") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def load_skybox(skybox_dir: str) -> np.ndarray:
    """Load six cubemap faces -> (6, H, W, 3) float32 in [0, 1], in the
    Vulkan cube layer order (``src/main.cpp:2064-2079,2116-2163``)."""
    faces = []
    size = None
    for name in SKYBOX_FACE_FILES:
        img = read_image(os.path.join(skybox_dir, name))
        if size is None:
            size = img.shape
        elif img.shape != size:
            raise ValueError(
                f"skybox face {name} has shape {img.shape}, expected {size}"
            )
        faces.append(img)
    return np.stack(faces, axis=0).astype(np.float32) / 255.0


def constant_skybox(color=(0.0, 0.0, 0.0), size: int = 4) -> np.ndarray:
    """Solid-color stand-in cubemap (for tests / missing assets)."""
    c = np.asarray(color, dtype=np.float32)
    return np.broadcast_to(c, (6, size, size, 3)).copy()


def _to_uint8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    return (np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0) * 255.0 + 0.5).astype(
        np.uint8
    )


def write_ppm(path: str, img: np.ndarray) -> None:
    """Binary PPM (P6) writeback; zero dependencies, trivially diffable."""
    data = _to_uint8(img)
    h, w = data.shape[:2]
    with open(path, "wb") as fh:
        fh.write(f"P6\n{w} {h}\n255\n".encode())
        fh.write(data[..., :3].tobytes())


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal RGB8 PNG encoder (stdlib zlib only)."""
    data = _to_uint8(img)
    if data.ndim == 2:
        data = np.repeat(data[..., None], 3, axis=-1)
    h, w = data.shape[:2]
    raw = b"".join(
        b"\x00" + data[row, :, :3].tobytes() for row in range(h)
    )

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as fh:
        fh.write(png)


def write_image(path: str, img: np.ndarray) -> None:
    """Write ``img`` ((H, W, 3) float in [0, 1], or uint8) as PNG or PPM
    by the suffix of ``path``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ppm":
        write_ppm(path, img)
    elif ext == ".png":
        write_png(path, img)
    else:
        raise ValueError(f"unsupported output format: {ext} (use .png or .ppm)")


def read_png(path: str) -> np.ndarray:
    """Decode the PNGs written by :func:`write_png` (RGB8, filter 0) plus
    grayscale/RGBA variants and the Sub and Up filters."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos = 8
    idat = b""
    w = h = bitdepth = coltype = None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        tag = blob[pos + 4 : pos + 8]
        payload = blob[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, bitdepth, coltype = struct.unpack(">IIBB", payload[:10])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    if bitdepth != 8 or coltype not in (0, 2, 6):
        raise ValueError(f"{path}: only 8-bit gray, RGB and RGBA PNGs are read "
                         f"(bit depth {bitdepth}, color type {coltype})")
    channels = {0: 1, 2: 3, 6: 4}[coltype]
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    off = 0
    for row in range(h):
        ftype = raw[off]
        line = np.frombuffer(raw[off + 1 : off + 1 + stride], dtype=np.uint8).copy()
        off += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub
            line = line.astype(np.int32)
            for i in range(channels, stride):
                line[i] = (line[i] + line[i - channels]) & 0xFF
            line = line.astype(np.uint8)
        elif ftype == 2:  # Up
            line = ((line.astype(np.int32) + prev) & 0xFF).astype(np.uint8)
        else:
            raise NotImplementedError(f"PNG filter {ftype}")
        out[row] = line
        prev = line.astype(np.int32)
    return out.reshape(h, w, channels)
