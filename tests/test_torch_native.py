"""The port's native OBJ parser and JPEG decoder (``raytpu_torch/io/native.py``,
built from ``native/objparse.cpp`` and ``native/jpeg_decode.cpp`` with g++
at first use) against raytpu's binding of the committed
``native/libraytpu_native.so`` (bit for bit, where that library loads) and
against the Python parser and PIL (within ``tests/test_native.py``'s
bounds), and the load policies of ``io/obj.load_obj`` and
``io/image.read_image`` (raytpu's). Every file is written into
``tmp_path``: no asset is needed."""

import sys

import numpy as np
import pytest
from PIL import Image

from raytpu.io import native as jnative
from raytpu_torch import _build
from raytpu_torch.io import image, native, obj
from raytpu_torch.io.genmesh import generate_highpoly


def _committed_library():
    if not jnative.available():
        pytest.skip("the committed native library does not load here")


def _port_library():
    if not native.available():
        pytest.skip("the port's native loaders cannot be built here (no FMA)")


def _write_obj(path, pos, tris, normals=None, digits=17):
    """An OBJ file of ``pos`` and 1-based ``tris``, with ``vn`` lines of
    ``normals`` (position-aligned) where given."""
    lines = [f"v {x:.{digits}g} {y:.{digits}g} {z:.{digits}g}" for x, y, z in pos]
    if normals is not None:
        lines += [f"vn {x:.{digits}g} {y:.{digits}g} {z:.{digits}g}"
                  for x, y, z in normals]
    lines += ["f " + " ".join(str(i + 1) for i in t) for t in tris]
    path.write_text("# generated\no mesh\n" + "\n".join(lines) + "\n")
    return str(path)


@pytest.fixture
def objs(tmp_path):
    """Three OBJ files: a generated mesh with vn lines, the same positions
    with double-precision digits and no normals (smooth normals computed),
    and quads with negative indices and vn indices that are not aligned
    with the positions."""
    m = generate_highpoly(depth=2, radius=1.5)
    rng = np.random.default_rng(7)
    noisy = m.positions.astype(np.float64) + rng.normal(scale=1e-3,
                                                        size=m.positions.shape)
    quads = tmp_path / "quads.obj"
    quads.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\nv 1 0 1\n"
        "vn 0 0 1\nvn 0 1 0\n"
        "f -6//1 -5//1 -4//1 -3//1\nf 1//2 2//2 6//2 5//2\n")
    return {
        "highpoly": _write_obj(tmp_path / "highpoly.obj", m.positions,
                               m.triangles, m.normals, digits=9),
        "noisy": _write_obj(tmp_path / "noisy.obj", noisy, m.triangles),
        "quads": str(quads),
    }


@pytest.mark.parametrize("name", ["highpoly", "noisy", "quads"])
def test_native_obj_equals_raytpu_native(objs, name):
    _port_library()
    _committed_library()
    got, want = native.load_obj(objs[name]), jnative.load_obj(objs[name])
    for field in ("positions", "normals", "triangles"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("name", ["highpoly", "noisy", "quads"])
def test_native_obj_equals_python_parse(objs, name):
    _port_library()
    got, want = native.load_obj(objs[name]), obj.load_obj_numpy(objs[name])
    np.testing.assert_array_equal(got.triangles, want.triangles)
    np.testing.assert_allclose(got.positions, want.positions)
    np.testing.assert_allclose(got.normals, want.normals, atol=1e-6)
    assert got.num_triangles == (4 if name == "quads" else 320)


def test_native_obj_rejects_bad_index_and_missing_file(tmp_path):
    _port_library()
    p = tmp_path / "bad.obj"
    p.write_text("v 0 0 0\nf 1 2 3\n")
    with pytest.raises(ValueError, match="vertex index"):
        native.load_obj(str(p))
    with pytest.raises(FileNotFoundError):
        native.load_obj(str(tmp_path / "missing.obj"))


def test_load_obj_policy(objs, monkeypatch):
    """``None`` takes the native parser where it can be built, ``True``
    forces it, ``False`` takes the Python parser; without the library
    ``None`` falls to Python and ``True`` raises."""
    _port_library()
    calls = []
    monkeypatch.setattr(native, "load_obj", lambda p: calls.append("native") or "n")
    monkeypatch.setattr(obj, "load_obj_numpy", lambda p: calls.append("python") or "p")
    assert obj.load_obj(objs["quads"]) == "n"
    assert obj.load_obj(objs["quads"], use_native=True) == "n"
    assert obj.load_obj(objs["quads"], use_native=False) == "p"
    assert calls == ["native", "native", "python"]
    monkeypatch.undo()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failure", None)
    monkeypatch.setattr(_build, "host_has_fma", lambda: False)
    assert not native.available()
    mesh = obj.load_obj(objs["quads"])
    np.testing.assert_array_equal(mesh.triangles,
                                  obj.load_obj_numpy(objs["quads"]).triangles)
    with pytest.raises(RuntimeError, match="FMA"):
        obj.load_obj(objs["quads"], use_native=True)


@pytest.fixture
def jpeg(tmp_path):
    """A smooth 96x80 RGB image, like a sky face, written by PIL as a
    baseline JPEG with its default 4:2:0 chroma."""
    y, x = np.mgrid[0:80, 0:96].astype(np.float32)
    rgb = np.stack([128 + 100 * np.sin(x / 80.0), 128 + 90 * np.cos(y / 80.0),
                    (x + y) * 1.4], axis=-1)
    path = tmp_path / "face.jpg"
    Image.fromarray(np.clip(rgb, 0, 255).astype(np.uint8)).save(path, quality=92)
    return str(path)


def test_read_jpeg_equals_raytpu_native(jpeg):
    _port_library()
    _committed_library()
    got = native.read_jpeg(jpeg)
    assert got.dtype == np.uint8 and got.shape == (80, 96, 3)
    np.testing.assert_array_equal(got, jnative.read_jpeg(jpeg))


def test_read_jpeg_matches_pil(jpeg):
    """The bounds of ``test_native.test_native_jpeg_matches_pil``: IDCT
    rounding and chroma upsampling give small per-pixel differences. They
    grow with the chroma's detail: the decoder repeats chroma samples where
    PIL interpolates them (measured, with these colours varying over 13
    pixels instead of 80: mean 1.53, max 6; raytpu's decoder gives the same
    bytes)."""
    _port_library()
    ours = native.read_jpeg(jpeg)
    ref = np.asarray(Image.open(jpeg).convert("RGB"))
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert ours.shape == ref.shape
    assert diff.mean() < 0.5
    assert (diff > 16).mean() < 1e-4


def test_read_jpeg_rejects_what_it_does_not_decode(tmp_path, jpeg):
    _port_library()
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    with pytest.raises(ValueError, match="SOI"):
        native.read_jpeg(str(bad))
    prog = tmp_path / "progressive.jpg"
    Image.open(jpeg).save(prog, progressive=True, quality=92)
    with pytest.raises(ValueError):
        native.read_jpeg(str(prog))
    sof2 = tmp_path / "sof2.jpg"
    sof2.write_bytes(b"\xff\xd8\xff\xc2" + b"\x00" * 32)
    with pytest.raises(ValueError):
        native.read_jpeg(str(sof2))


def test_read_image_policy(jpeg, monkeypatch):
    """PIL decodes where it is installed; the native decoder only where it
    is missing."""
    _port_library()
    np.testing.assert_array_equal(image.read_image(jpeg),
                                  np.asarray(Image.open(jpeg).convert("RGB")))
    monkeypatch.setitem(sys.modules, "PIL", None)   # import PIL fails
    np.testing.assert_array_equal(image.read_image(jpeg), native.read_jpeg(jpeg))
