"""The port's host data runtime (``cermvs_torch/io/native.py``, its own
build of ``cermvs_torch/csrc/dataio.cpp``) against the JAX package's
(``cermvs_tpu.io.native``), bit for bit: the PFM codec (1 and 3 channels,
either byte order, which the scale's sign gives), both resizes at odd sizes
and at fewer and more than 64 output rows (one thread, then eight), and the
fused scale and crop. The numpy version of the scale and crop holds to the
library at ``bilinear_tolerance`` (bilinear; nearest bit for bit). A build
that fails raises with the compiler's message.
"""

import numpy as np
import pytest

from cermvs_tpu.io import native as jnative
from cermvs_torch.io import native
from cermvs_torch.io import read_pfm, read_pfm_fast, write_pfm


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    assert jnative.available(), "the JAX package's native library"


def _write_pfm_big_endian(path, image):
    """A PFM with a positive scale: big-endian floats."""
    color = image.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"%d %d\n" % (image.shape[1], image.shape[0]))
        f.write(b"1.000000\n")
        np.flipud(image).astype(">f4").tofile(f)


@pytest.mark.parametrize("shape", [(17, 23), (40, 56, 3), (1, 5)])
@pytest.mark.parametrize("order", ["little", "big"])
def test_pfm_read_equals_jax(tmp_path, rng, shape, order):
    img = (rng.randn(*shape) * 1e3).astype(np.float32)
    img.flat[::7] = 0.0
    f = tmp_path / "d.pfm"
    if order == "little":
        write_pfm(f, img)
        assert float(f.read_bytes().split(b"\n")[2]) < 0
    else:
        _write_pfm_big_endian(f, img)
    got = native.read_pfm(f)
    want = jnative.read_pfm(f)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(read_pfm_fast(f), read_pfm(f))


def test_pfm_write_equals_jax(tmp_path, rng):
    img = (rng.randn(13, 29) * 50).astype(np.float32)
    native.write_pfm(tmp_path / "p.pfm", img)
    jnative.write_pfm(tmp_path / "j.pfm", img)
    assert (tmp_path / "p.pfm").read_bytes() == (
        tmp_path / "j.pfm").read_bytes()
    np.testing.assert_array_equal(read_pfm(tmp_path / "p.pfm"), img)
    with pytest.raises(ValueError, match="HxW float32"):
        native.write_pfm(tmp_path / "c.pfm", np.zeros((4, 4, 3), np.float32))
    with pytest.raises(IOError, match="pfm_read_header"):
        native.read_pfm(tmp_path / "missing.pfm")


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("src,dst", [
    ((37, 53, 3), (23, 71)),     # odd sizes, fewer than 64 rows: one thread
    ((61, 45, 1), (150, 97)),    # more than 64 rows: eight threads
    ((200, 301, 3), (131, 451)),
    ((9, 7), (64, 5)),           # (H, W), exactly 64 rows
])
def test_resize_equals_jax(rng, src, dst, nearest):
    img = (rng.rand(*src) * 255).astype(np.float32)
    if len(src) == 3 and src[2] == 1:
        img = img[..., 0]
    got = native.resize(img, *dst, nearest=nearest)
    want = jnative.resize(img, *dst, nearest=nearest)
    assert got.shape == want.shape == dst + img.shape[2:]
    np.testing.assert_array_equal(got, want)


CROPS = [
    # frames (n, h, w[, c]), resized (rh, rw), crop (y0, x0, ch, cw)
    ((3, 60, 90, 3), (54, 81), (3, 5, 48, 64)),
    ((2, 60, 90), (82, 123), (30, 51, 48, 64)),
    ((2, 121, 163, 3), (170, 228), (0, 0, 170, 228)),
    ((1, 77, 41, 3), (70, 37), (1, 2, 64, 32)),
]


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("frames,resized,crop", CROPS)
def test_scale_and_crop_equals_jax_and_numpy(rng, frames, resized, crop,
                                             nearest):
    x = (rng.rand(*frames) * 255).astype(np.float32)
    args = (*resized, *crop, nearest)
    got = native.scale_and_crop(x, *args)
    want = jnative.scale_and_crop(x, *args)
    assert got.shape == (frames[0],) + crop[2:] + frames[3:]
    np.testing.assert_array_equal(got, want)
    ref = native.scale_and_crop_reference(x, *args)
    assert ref.shape == got.shape and ref.dtype == np.float32
    if nearest:
        np.testing.assert_array_equal(ref, got)
    else:
        tol = native.bilinear_tolerance(x)
        assert 0 < tol < 0.02
        np.testing.assert_allclose(ref, got, rtol=0, atol=tol)


def test_crop_outside_the_resized_frame_raises(rng):
    x = np.zeros((1, 20, 30), np.float32)
    with pytest.raises(ValueError, match="leaves the resized"):
        native.scale_and_crop(x, 20, 30, 1, 0, 20, 30, True)


def test_failed_build_raises_with_the_compiler_message(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "dataio.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ dataio.cpp failed"):
        native.load()
    assert not list((tmp_path / "build").glob("*.so"))
