"""The port's on-device families (deepdenoiser_tpu_torch/data/
synthetic_device.py) against the JAX package's (deepdenoiser_tpu/data/
synthetic_jax.py), on the CPU.

Every generator, randomize_scene and add_mc_noise is run on the numbers
the JAX function drew (recorded from jax.random while it runs eagerly,
tests/torch_jax_draws.py): each pass within 1e-6 + 1e-6*|ref| (the same
fp32 operations; sin, pow and log1p differ in the last bit, and the
Fourier fields' arguments reach 2*pi*32). _encode_pair takes the same
numpy pass dicts. training_batch is held to its contract: shapes,
finiteness, determinism per generator and the JAX concatenation order of
the families.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu.data import synthetic_jax as jsd
from deepdenoiser_tpu_torch import transforms
from deepdenoiser_tpu_torch.data import mc_tracer, synthetic_device

import torch_jax_draws  # noqa: E402  (tests/, on the path of every test module)
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

TOL = 1e-6


def _close(got, ref, what=""):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref)
    assert (err <= TOL + TOL * np.abs(ref)).all(), (what, float(err.max()))


def _replayed(monkeypatch, jax_fn, port_fn):
    """(JAX result, port result on the JAX draws); every draw consumed."""
    records = torch_jax_draws.record(monkeypatch)
    ref = jax_fn()
    monkeypatch.undo()
    draws = torch_jax_draws.Replay(records)
    got = port_fn(draws)
    assert draws.exhausted, (draws.used, len(records))
    return ref, got


def _passes_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k][0], ref[k], k)


@pytest.mark.parametrize("h,w,t", [(24, 32, 0.0), (40, 56, 0.0), (17, 30, 0.7)])
def test_fourier_passes_replay_jax(monkeypatch, h, w, t):
    ref, got = _replayed(
        monkeypatch, lambda: jsd.generate_clean_passes(jax.random.PRNGKey(3), h, w, t=t),
        lambda d: synthetic_device.generate_clean_passes(d, 1, h, w, t=t))
    _passes_close(got, ref)


@pytest.mark.parametrize("h,w", [(24, 32), (40, 56), (96, 96)])
def test_voronoi_passes_replay_jax(monkeypatch, h, w):
    """96x96, the training crop: penumbra radius 4, bounce radius 8."""
    ref, got = _replayed(
        monkeypatch, lambda: jsd.generate_voronoi_passes(jax.random.PRNGKey(5), h, w),
        lambda d: synthetic_device.generate_voronoi_passes(d, 1, h, w))
    _passes_close(got, ref)


@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_box_blur_matches_jax(r):
    x = np.random.default_rng(r).standard_normal((20, 26, 3)).astype(np.float32)
    _close(synthetic_device._box_blur(torch.from_numpy(x)[None], r)[0],
           jsd._box_blur(jnp.asarray(x), r), f"r={r}")


def _voronoi_np(seed=1, h=24, w=32):
    return {k: np.asarray(v) for k, v in
            jsd.generate_voronoi_passes(jax.random.PRNGKey(seed), h, w).items()}


def test_randomize_scene_replays_jax(monkeypatch):
    clean = _voronoi_np()
    ref, got = _replayed(
        monkeypatch,
        lambda: jsd.randomize_scene(jax.random.PRNGKey(2), {k: jnp.asarray(v) for k, v in clean.items()}),
        lambda d: synthetic_device.randomize_scene(d, {k: torch.from_numpy(v.copy())[None]
                                                       for k, v in clean.items()}))
    _passes_close(got, ref)


@pytest.mark.parametrize("spp", [4.0, 23.7])
def test_add_mc_noise_replays_jax(monkeypatch, spp):
    clean = _voronoi_np(seed=4)
    ref, got = _replayed(
        monkeypatch,
        lambda: jsd.add_mc_noise(jax.random.PRNGKey(2), {k: jnp.asarray(v) for k, v in clean.items()},
                                 jnp.float32(spp)),
        lambda d: synthetic_device.add_mc_noise(
            d, {k: torch.from_numpy(v.copy())[None] for k, v in clean.items()},
            torch.full((1, 1, 1, 1), spp)))
    _passes_close(got, ref)


@pytest.mark.parametrize("mode", ["joint", "group", "rgb"])
def test_encode_pair_matches_jax(mode):
    clean = _voronoi_np(seed=6, h=20, w=28)
    noisy = {k: np.asarray(v) for k, v in jsd.add_mc_noise(
        jax.random.PRNGKey(8), {k: jnp.asarray(v) for k, v in clean.items()}, 4.0).items()}
    ref = jsd._encode_pair({k: jnp.asarray(v) for k, v in noisy.items()},
                           {k: jnp.asarray(v) for k, v in clean.items()}, mode)
    got = synthetic_device._encode_pair({k: torch.from_numpy(v.copy())[None] for k, v in noisy.items()},
                                        {k: torch.from_numpy(v.copy())[None] for k, v in clean.items()},
                                        mode)
    for k in ("x", "y"):
        _close(got[k][0], ref[k], k)


# --- training_batch ---------------------------------------------------------

CHANNELS = {"joint": (transforms.joint_input_channels(), transforms.joint_output_channels()),
            "group": (transforms.group_input_channels(), 6),
            "rgb": (transforms.rgb_input_channels(), 3)}


@pytest.fixture
def cheap_mc(monkeypatch):
    monkeypatch.setattr(synthetic_device, "MC_TRAIN_GT_SPP", 8)


@pytest.mark.parametrize("family", synthetic_device.FAMILIES)
def test_training_batch_shapes_and_finite(cheap_mc, family):
    b = synthetic_device.training_batch(torch.Generator().manual_seed(0), 6, 16, "joint", family)
    cin, cout = CHANNELS["joint"]
    assert b["x"].shape == (6, 16, 16, cin) and b["y"].shape == (6, 16, 16, cout)
    assert b["x"].dtype == b["y"].dtype == torch.float32
    for v in b.values():
        assert torch.isfinite(v).all()


@pytest.mark.parametrize("mode", ["group", "rgb"])
@pytest.mark.parametrize("family", ["mixed", "mc"])
def test_training_batch_other_modes(cheap_mc, family, mode):
    b = synthetic_device.training_batch(torch.Generator().manual_seed(1), 3, 16, mode, family)
    cin, cout = CHANNELS[mode]
    assert b["x"].shape == (3, 16, 16, cin) and b["y"].shape == (3, 16, 16, cout)
    assert all(torch.isfinite(v).all() for v in b.values())


@pytest.mark.parametrize("family", synthetic_device.FAMILIES)
def test_training_batch_is_deterministic_per_generator(cheap_mc, family):
    def make(seed):
        return synthetic_device.training_batch(torch.Generator().manual_seed(seed), 4, 16,
                                               "joint", family)

    a, b, c = make(5), make(5), make(6)
    for k in ("x", "y"):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        assert not torch.equal(a[k], c[k])


def _tagged(monkeypatch):
    """Stand-ins that make each family's examples recognisable: the alpha
    pass carries a tag (Fourier 1, Voronoi 2, mc 3), which randomize_scene
    and add_mc_noise pass through and the patched encode returns as x."""
    real_f = synthetic_device.generate_clean_passes
    real_v = synthetic_device.generate_voronoi_passes

    def tag(real, value):
        def gen(draws, n, h, w):
            out = real(draws, n, h, w)
            return {**out, "alpha": torch.full((n, h, w, 1), value)}
        return gen

    def mc(draws, n, crop, mode):
        return {"x": torch.full((n, crop, crop, 1), 3.0), "y": torch.full((n, crop, crop, 1), 3.0)}

    monkeypatch.setattr(synthetic_device, "generate_clean_passes", tag(real_f, 1.0))
    monkeypatch.setattr(synthetic_device, "generate_voronoi_passes", tag(real_v, 2.0))
    monkeypatch.setattr(synthetic_device, "_mc_subbatch", mc)
    monkeypatch.setattr(synthetic_device, "_encode_pair",
                        lambda noisy, clean, mode: {"x": noisy["alpha"], "y": clean["alpha"]})


@pytest.mark.parametrize("family,batch,want", [
    ("fourier", 5, [1] * 5),
    ("voronoi", 4, [2] * 4),
    ("mixed", 7, [1] * 4 + [2] * 3),
    ("mixed", 1, [1]),
    ("mixed-mc", 16, [1] * 5 + [2] * 5 + [3] * 6),
    ("mixed-mc", 3, [1, 2, 3]),
])
def test_training_batch_concatenates_the_families_in_jax_order(monkeypatch, family, batch, want):
    _tagged(monkeypatch)
    b = synthetic_device.training_batch(torch.Generator().manual_seed(0), batch, 8, "joint", family)
    assert b["x"][:, 0, 0, 0].tolist() == want


@pytest.mark.parametrize("batch,n4", [(5, 3), (4, 2), (1, 1)])
def test_mc_family_puts_the_spp4_half_first(monkeypatch, batch, n4):
    """The noisy half at spp 4 leads, spp 16 follows; the GT of all
    examples is one render at MC_TRAIN_GT_SPP."""
    real = mc_tracer.render
    spps = []

    def render(scene, h, w, spp, draws, *args):
        out = real(scene, h, w, 1, draws, *args)
        spps.append((spp, scene.radii.shape[0]))
        return {**out, "alpha": torch.full_like(out["alpha"], float(spp))}

    monkeypatch.setattr(synthetic_device, "MC_TRAIN_GT_SPP", 32)
    monkeypatch.setattr(mc_tracer, "render", render)
    monkeypatch.setattr(synthetic_device, "_encode_pair",
                        lambda noisy, clean, mode: {"x": noisy["alpha"], "y": clean["alpha"]})
    b = synthetic_device.training_batch(torch.Generator().manual_seed(0), batch, 8, "joint", "mc")
    assert b["x"][:, 0, 0, 0].tolist() == [4.0] * n4 + [16.0] * (batch - n4)
    assert b["y"][:, 0, 0, 0].tolist() == [32.0] * batch
    assert spps == [(32, batch), (4, n4)] + ([(16, batch - n4)] if batch > n4 else [])


def test_training_batch_refuses_unknown_families_and_tiny_mixed_mc():
    with pytest.raises(ValueError, match="unknown family"):
        synthetic_device.training_batch(torch.Generator(), 4, 16, "joint", "boxes")
    with pytest.raises(ValueError, match="batch >= 3"):
        synthetic_device.training_batch(torch.Generator(), 2, 16, "joint", "mixed-mc")
