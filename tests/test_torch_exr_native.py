"""The port's native EXR predictor (deepdenoiser_tpu_torch/data/_native.py,
csrc/exr_pack.cpp built at first use with the host compiler) against its
numpy plain versions and the JAX package's native library, bit for bit,
and EXR files crossing between the two packages through it."""

import numpy as np
import pytest

from deepdenoiser_tpu.data import _native as j_native
from deepdenoiser_tpu.data import exr_codec as jcodec
from deepdenoiser_tpu.data import synthetic as jsynthetic
from deepdenoiser_tpu_torch.data import _native, exr_codec
from deepdenoiser_tpu_torch.ops import _build

# 1080 rows of 1920 half-float RGB pixels: one plane of a 1080p frame
FRAME_BYTES = 1080 * 1920 * 3 * 2
SIZES = (1, 2, 7, 1000, 4097, FRAME_BYTES)


def _bytes(n: int) -> bytes:
    return np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()


def test_library_builds_from_the_ports_source():
    assert _native.available()
    lib = _build.library_path("exr_pack")
    assert lib.exists() and lib.parent == _build.BUILD_DIR
    assert _build._source("exr_pack").name == "exr_pack.cpp"


@pytest.mark.parametrize("n", SIZES)
def test_native_equals_numpy(n):
    data = _bytes(n)
    split = _native.split_and_predict(data)
    assert split == exr_codec._zip_split_and_predict_np(data)
    assert _native.unpredict_and_merge(data) == exr_codec._zip_unpredict_and_merge_np(data)
    assert _native.unpredict_and_merge(split) == data


@pytest.mark.parametrize("n", SIZES)
def test_native_equals_jax_native(n):
    if not j_native.available():
        pytest.skip("the JAX package's native/libexr_pack.so is not built")
    data = _bytes(n)
    assert _native.split_and_predict(data) == j_native.split_and_predict(data)
    assert _native.unpredict_and_merge(data) == j_native.unpredict_and_merge(data)


def test_codec_routes_through_native(monkeypatch):
    calls = []
    for name in ("split_and_predict", "unpredict_and_merge"):
        fn = getattr(_native, name)
        monkeypatch.setattr(_native, name, lambda d, fn=fn, name=name: calls.append(name) or fn(d))
    img = {"R": np.arange(64 * 48, dtype=np.float32).reshape(64, 48)}
    out = exr_codec.decode(exr_codec.encode(img))
    assert np.array_equal(out.channels["R"], img["R"])
    assert "split_and_predict" in calls and "unpredict_and_merge" in calls


def test_failed_build_raises(monkeypatch, tmp_path):
    (tmp_path / "broken.cpp").write_text('extern "C" int f() { return not_declared; }\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="failed for csrc/broken.cpp"):
        _build.build(["broken"])
    assert not list((tmp_path / "out").glob("*.so"))


@pytest.fixture(scope="module")
def frame():
    clean = jsynthetic.generate_clean_passes(40, 56, seed=3)
    noisy = jsynthetic.add_mc_noise(clean, spp=4, seed=4)
    return {k: np.asarray(v, np.float32)[..., 0] for k, v in noisy.items()
            if k in ("diffuse_direct", "depth", "glossy_color", "alpha")}


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("pixel_type,compression",
                         [("half", "zip"), ("float", "zips"), ("float", "rle")])
def test_exr_crosses_packages(frame, writer, pixel_type, compression):
    w, r = (jcodec, exr_codec) if writer == "jax" else (exr_codec, jcodec)
    data = w.encode(frame, pixel_type=pixel_type, compression=compression)
    assert data == r.encode(frame, pixel_type=pixel_type, compression=compression)
    got, want = r.decode(data), w.decode(data)
    assert set(got.channels) == set(frame)
    for k in frame:
        assert got.channels[k].tobytes() == want.channels[k].tobytes()
