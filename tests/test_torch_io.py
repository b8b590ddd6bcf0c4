"""The port's IO (utils/io.py, native/, core/spectrum.py) against the JAX
package's: the EXR, VOL, PFM and RGBE writers give the same bytes from
the same array; each reader reads the other package's files into equal
arrays (PNG, OBJ, PLY, EXR, VOL, PFM, RGBE); the native OBJ and VOL3
parsers equal the Python ones; spd_to_rgb equals JAX's; the tensor
spectrum helpers equal JAX's."""
import numpy as np
import pytest
import torch

from mitsubaer_tpu.core import spectrum as jspec
from mitsubaer_tpu.utils import io as jio
from mitsubaer_tpu_torch.core import spectrum as tspec
from mitsubaer_tpu_torch.native import build as native_build
from mitsubaer_tpu_torch.utils import io as tio

RNG = np.random.default_rng(11)


def _img(*shape):
    return RNG.uniform(0, 3, shape).astype(np.float32)


EXR_CASES = {
    "Y": (_img(5, 7), None, None),
    "RGB": (_img(20, 9, 3), None, {"renderTime": "1.5s", "spp": "16"}),
    "RGBA": (_img(33, 4, 4), None, None),
    "frames": (_img(6, 5, 6),
               [f"frame{f:03d}.{c}" for f in range(2) for c in "RGB"],
               {"integrator": "volpath"}),
}


@pytest.mark.parametrize("name", sorted(EXR_CASES))
def test_exr_bytes_and_readers(name, tmp_path):
    img, names, ann = EXR_CASES[name]
    t, j = tmp_path / "t.exr", tmp_path / "j.exr"
    tio.write_exr(str(t), img, channel_names=names, annotations=ann)
    jio.write_exr(str(j), img, channel_names=names, annotations=ann)
    assert t.read_bytes() == j.read_bytes()
    got, got_names = tio.read_exr(str(j))
    want, want_names = jio.read_exr(str(t))
    assert got_names == want_names
    np.testing.assert_array_equal(got, want)
    # the file keeps the channels in alphabetical order
    order = slice(None) if names is None else np.argsort(names)
    np.testing.assert_array_equal(got, img.reshape(got.shape[:2] + (-1,))
                                  [..., order])


def test_vol_bytes_readers_and_native(tmp_path):
    data = _img(6, 5, 4, 3)
    t, j = tmp_path / "t.vol", tmp_path / "j.vol"
    tio.write_vol(str(t), data, (-1, -2, -3), (1, 2, 3))
    jio.write_vol(str(j), data, (-1, -2, -3), (1, 2, 3))
    assert t.read_bytes() == j.read_bytes()
    for read in (tio.read_vol, tio._read_vol_py):
        got = read(str(j))
        want = jio.read_vol(str(t))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tio.read_vol(str(t))[0], data)
    # the half and byte encodings, written by hand, native against Python
    import struct
    for enc, payload, dt in ((2, data.astype(np.float16), np.float16),
                             (3, (data / 3 * 255).astype(np.uint8), np.uint8)):
        p = tmp_path / f"e{enc}.vol"
        p.write_bytes(b"VOL\x03" + struct.pack("<iiiii", enc, 4, 5, 6, 3)
                      + struct.pack("<6f", 0, 0, 0, 1, 1, 1)
                      + payload.astype(dt).tobytes())
        a = tio.read_vol(str(p))[0]
        b = tio._read_vol_py(str(p))[0]
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, jio.read_vol(str(p))[0])


def test_native_build_is_cached():
    assert native_build() == native_build()


def _obj_text(verts, faces, style):
    lines = ["# test", "o shape"]
    lines += ["v %.6f %.6f %.6f" % tuple(v) for v in verts]
    lines += ["vt 0.5 0.5", "vn 0 0 1"]
    for f in faces:
        if style == "plain":
            toks = [str(i + 1) for i in f]
        elif style == "slashes":
            toks = [f"{i + 1}/1/1" for i in f]
        else:                                   # negative indices
            toks = [str(i - len(verts)) for i in f]
        lines.append("f " + " ".join(toks))
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("style", ["plain", "slashes", "negative"])
def test_obj_native_python_and_jax(style, tmp_path):
    verts = RNG.uniform(-1, 1, (9, 3)).astype(np.float32)
    faces = [[0, 1, 2], [2, 3, 4, 5], [6, 7, 8, 0, 1]]   # a tri, a quad, a pentagon
    p = tmp_path / "m.obj"
    p.write_text(_obj_text(verts, faces, style))
    nv, nf = tio.load_obj(str(p))
    pv, pf = tio._load_obj_py(str(p))
    jv, jf = jio.load_obj(str(p))
    for a, b in ((nv, pv), (nf, pf), (nv, jv), (nf, jf)):
        np.testing.assert_array_equal(a, b)
    assert nf.shape == (1 + 2 + 3, 3) and nf.dtype == np.int32


def test_obj_native_raises_on_a_missing_file(tmp_path):
    with pytest.raises(OSError):
        tio.load_obj(str(tmp_path / "none.obj"))


def _ply(path, verts, faces, binary):
    head = ["ply", "format " + ("binary_little_endian 1.0" if binary
                                else "ascii 1.0"),
            f"element vertex {len(verts)}", "property float x",
            "property float y", "property float z",
            f"element face {len(faces)}",
            "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        if binary:
            f.write(verts.astype("<f4").tobytes())
            for t in faces:
                f.write(np.uint8(len(t)).tobytes()
                        + np.asarray(t, "<i4").tobytes())
        else:
            for v in verts:
                f.write(("%r %r %r\n" % tuple(map(float, v))).encode())
            for t in faces:
                f.write((" ".join(map(str, [len(t), *t])) + "\n").encode())


@pytest.mark.parametrize("binary", [False, True])
def test_ply_both_packages(binary, tmp_path):
    verts = RNG.uniform(-1, 1, (6, 3)).astype(np.float32)
    faces = [[0, 1, 2], [2, 3, 4, 5]]
    p = tmp_path / "m.ply"
    _ply(p, verts, faces, binary)
    tv, tf = tio.load_ply(str(p))
    jv, jf = jio.load_ply(str(p))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tv, verts)
    assert tf.tolist() == [[0, 1, 2], [2, 3, 4], [2, 4, 5]]


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_round_trips_both_ways(channels, tmp_path):
    img = RNG.uniform(0, 1, (7, 11, channels)).astype(np.float32)
    img = img[..., 0] if channels == 1 else img
    t, j = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    tio.write_png(t, img)
    jio.write_png(j, img)
    for path in (t, j):
        np.testing.assert_array_equal(tio.read_image(path),
                                      jio.read_image(path))
    np.testing.assert_array_equal(tio.read_image(t), jio.read_image(j))


@pytest.mark.parametrize("channels", [1, 3])
def test_pfm_bytes_and_readers(channels, tmp_path):
    img = _img(5, 6, channels)
    t, j = tmp_path / "t.pfm", tmp_path / "j.pfm"
    tio.write_pfm(str(t), img)
    jio.write_pfm(str(j), img)
    assert t.read_bytes() == j.read_bytes()
    np.testing.assert_array_equal(tio.read_pfm(str(j)), jio.read_pfm(str(t)))
    np.testing.assert_array_equal(tio.read_image(str(j)),
                                  jio.read_image(str(t)))


def test_rgbe_bytes_and_readers(tmp_path):
    img = _img(4, 9, 3)
    img[0, 0] = 0.0
    t, j = tmp_path / "t.hdr", tmp_path / "j.hdr"
    tio.write_rgbe(str(t), img)
    jio.write_rgbe(str(j), img)
    assert t.read_bytes() == j.read_bytes()
    np.testing.assert_array_equal(tio.read_rgbe(str(j)), jio.read_rgbe(str(t)))
    np.testing.assert_array_equal(tio.read_image(str(j)),
                                  jio.read_image(str(t)))


@pytest.mark.parametrize("spd", [
    ([550.0], [0.7]),
    ([400, 500, 600, 700], [0.04, 0.05, 0.6, 0.65]),
    ([380, 450, 520, 610, 720], [1.0, 8.0, 15.6, 18.4, 2.0]),
])
def test_spd_to_rgb_equals_jax(spd):
    np.testing.assert_array_equal(tspec.spd_to_rgb(*spd),
                                  jspec.spd_to_rgb(*spd))
    np.testing.assert_array_equal(tspec.cie_xyz_fit([400.0, 555.5, 700.0]),
                                  jspec.cie_xyz_fit([400.0, 555.5, 700.0]))


def test_spectrum_helpers_equal_jax():
    rgb = _img(64, 3)
    rgb[:5] = 0.0
    t = torch.from_numpy(rgb)
    for name in ("luminance", "is_black", "average", "max_component"):
        np.testing.assert_allclose(getattr(tspec, name)(t).numpy(),
                                   np.asarray(getattr(jspec, name)(rgb)),
                                   rtol=1e-6, err_msg=name)
