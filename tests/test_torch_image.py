"""The port's image writers and reader against raytpu's
(``raytpu/io/image.py``): the same image gives the same PNG and PPM bytes,
PNGs read back, and ``write_image`` picks the format by the suffix."""

import numpy as np
import pytest

from raytpu.io import image as jimage
from raytpu_torch.io import image


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    u8 = rng.integers(0, 256, size=(17, 23, 3), dtype=np.uint8)
    f32 = rng.uniform(-0.2, 1.2, size=(9, 14, 3)).astype(np.float32)
    gray = rng.uniform(0.0, 1.0, size=(5, 6)).astype(np.float32)
    return {"u8": u8, "f32": f32, "gray": gray}


@pytest.mark.parametrize("kind", ["u8", "f32", "gray"])
@pytest.mark.parametrize("writer", ["write_png", "write_ppm"])
def test_bytes_equal_raytpus(images, tmp_path, kind, writer):
    img = images[kind]
    if writer == "write_ppm" and kind == "gray":
        img = np.repeat(img[..., None], 3, axis=-1)
    ours, theirs = tmp_path / "port", tmp_path / "raytpu"
    getattr(image, writer)(str(ours), img)
    getattr(jimage, writer)(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()


def test_png_round_trip(images, tmp_path):
    p = str(tmp_path / "x.png")
    image.write_png(p, images["u8"])
    np.testing.assert_array_equal(image.read_png(p), images["u8"])
    image.write_png(p, images["f32"])
    np.testing.assert_array_equal(image.read_png(p), image._to_uint8(images["f32"]))
    np.testing.assert_array_equal(image.read_png(p), jimage.read_png(p))


def test_write_image_dispatches_on_suffix(images, tmp_path):
    img = images["f32"]
    for suffix, writer in ((".png", image.write_png), (".PPM", image.write_ppm)):
        got, want = tmp_path / f"a{suffix}", tmp_path / f"b{suffix}"
        image.write_image(str(got), img)
        writer(str(want), img)
        assert got.read_bytes() == want.read_bytes()
    with pytest.raises(ValueError, match="unsupported output format"):
        image.write_image(str(tmp_path / "x.jpg"), img)


def test_constant_skybox_and_skybox_faces():
    np.testing.assert_array_equal(image.constant_skybox((0.25, 0.5, 0.75), size=8),
                                  jimage.constant_skybox((0.25, 0.5, 0.75), size=8))
    assert tuple(image.SKYBOX_FACE_FILES) == tuple(jimage.SKYBOX_FACE_FILES)


def test_load_skybox_reads_six_faces(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    for name in image.SKYBOX_FACE_FILES:
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(
            tmp_path / name, format="PNG")
    np.testing.assert_array_equal(image.load_skybox(str(tmp_path)),
                                  jimage.load_skybox(str(tmp_path)))
