"""The port's preview helpers (utils/images.py) against the JAX package's:
the same tonemap and strips, and PNGs that decode to the pixels the JAX
package's PIL-written files hold. The port writes PNG with zlib, since the
card's machine has no PIL; PIL here only reads."""

import numpy as np
import pytest
from PIL import Image

from deepdenoiser_tpu.utils import images as jimages
from deepdenoiser_tpu_torch.utils import images


def _hdr(shape, seed=0):
    return (np.random.default_rng(seed).gamma(1.5, 0.8, shape) - 0.2).astype(np.float32)


def test_tonemap_and_side_by_side_match():
    a, b = _hdr((12, 10, 3)), _hdr((12, 7, 3), 1)
    np.testing.assert_array_equal(images.tonemap_srgb(a, 1.7), jimages.tonemap_srgb(a, 1.7))
    tm = [images.tonemap_srgb(x) for x in (a, b)]
    np.testing.assert_array_equal(images.side_by_side(*tm, pad=3), jimages.side_by_side(*tm, pad=3))


@pytest.mark.parametrize("shape", [(9, 13, 3), (9, 13, 1), (5, 4)], ids=["rgb", "grey-hwc", "grey-hw"])
def test_png_decodes_to_the_jax_package_pixels(shape, tmp_path):
    ldr = np.random.default_rng(2).uniform(-0.1, 1.1, shape).astype(np.float32)
    images.save_png(tmp_path / "port.png", ldr)
    jimages.save_png(tmp_path / "jax.png", ldr)
    got = np.asarray(Image.open(tmp_path / "port.png"))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_preview_png_matches(tmp_path):
    hdr = _hdr((8, 6, 3), 3)
    images.save_preview_png(tmp_path / "p.png", hdr, exposure=2.0)
    jimages.save_preview_png(tmp_path / "j.png", hdr, exposure=2.0)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))


def test_encode_png_refuses_other_dtypes_and_shapes():
    with pytest.raises(TypeError, match="uint8"):
        images.encode_png(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="H, W"):
        images.encode_png(np.zeros((2, 2, 4), np.uint8))
