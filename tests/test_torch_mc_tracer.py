"""The port's path tracer (deepdenoiser_tpu_torch/data/mc_tracer.py) against
the JAX package's (deepdenoiser_tpu/data/mc_tracer.py), on the CPU.

* make_scene is numpy in both: bit-equal.
* make_scene_random and render, given the numbers the JAX functions drew
  (recorded from jax.random while they run eagerly, tests/torch_jax_draws.py),
  compute the same function: the scene exactly; at 4 spp on 16x24 the
  direct and indirect estimates within 1e-4 x max|ref|.
* The deterministic buffers (normal, depth, alpha, emission, environment,
  the four colour passes) at 48x64 on seeds 1, 4 and 11 against JAX's
  render run eagerly: within 1e-5 + 1e-5*|ref| but for flipped pixels (at
  most 0.2 %, each within 1 px of an edge; tests/torch_flips.py). They are
  held to the eager render because JAX's jitted render itself differs
  from it at grazing sphere pixels, where disc = b*b - c cancels (11 of
  3072 pixels at seed 11, measured), and the port computes the eager
  arithmetic.
* The port's own sample streams (torch.Generator) differ from threefry:
  their estimates are held to the JAX GT within Monte-Carlo error, and to
  the properties tests/test_mc_tracer.py asserts, by twins of its tests at
  its sizes.
"""

import jax
import numpy as np
import pytest
import torch

from deepdenoiser_tpu.data import mc_tracer as jmc
from deepdenoiser_tpu_torch.data import mc_tracer, synthetic_device
from deepdenoiser_tpu_torch.data.draws import Draws, seeded
from deepdenoiser_tpu_torch.data.synthetic import recompose_np

import torch_flips  # noqa: E402  (tests/, on the path of every test module)
import torch_jax_draws  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

H, W = 48, 64
CPU = "cpu"


def _np(frame):
    return {k: v.numpy() for k, v in frame.items()}


def _clean(height, width, seed, spp):
    return _np(mc_tracer.generate_clean_passes(height, width, seed=seed, spp=spp, device=CPU))


def _noisy(height, width, seed, spp, sample_seed=0):
    return _np(mc_tracer.generate_noisy_passes(height, width, seed=seed, spp=spp,
                                               sample_seed=sample_seed, device=CPU))


# --- against the JAX package ------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 5, 11, 31])
def test_make_scene_is_bit_equal_to_jax(seed):
    ref = jmc.make_scene(seed)
    got = mc_tracer.make_scene(seed, device=CPU)
    for name, a, b in zip(jmc.Scene._fields, ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def test_make_scene_random_replays_make_scene_jax(monkeypatch):
    records = torch_jax_draws.record(monkeypatch)
    ref = jmc.make_scene_jax(jax.random.PRNGKey(7))
    monkeypatch.undo()
    draws = torch_jax_draws.Replay(records)
    got = mc_tracer.make_scene_random(draws, 1)
    assert draws.exhausted
    for name, a, b in zip(jmc.Scene._fields, ref, got):
        a = np.asarray(a)
        np.testing.assert_allclose(b[0].numpy(), a, rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("seed", [1, 4, 11])
def test_deterministic_buffers_match_jax_under_the_flip_bar(seed):
    with jax.disable_jit():
        ref = jmc.render(jmc.make_scene(seed), H, W, 1, jax.random.PRNGKey(0))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = _np(mc_tracer.render(mc_tracer.make_scene(seed, device=CPU), H, W, 1, seeded(0, CPU)))
    torch_flips.assert_flips_only(got, ref)


@pytest.mark.parametrize("seed", [4, 5])
def test_render_replays_jax_draws(monkeypatch, seed):
    """At 4 spp on 16x24, eagerly (the fori_loop runs as a Python loop, so
    every draw is concrete): the draws come in JAX's order, and the traced
    estimates agree to 1e-4 x max|ref| but at flipped pixels."""
    records = torch_jax_draws.record(monkeypatch)
    with jax.disable_jit():
        ref = jmc.render(jmc.make_scene(seed), 16, 24, 4, jax.random.PRNGKey(seed))
    monkeypatch.undo()
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert len(records) == 4 * 6  # per sample: disk (r, phi), cosine (u1, u2), bounce disk
    draws = torch_jax_draws.Replay(records)
    got = _np(mc_tracer.render(mc_tracer.make_scene(seed, device=CPU), 16, 24, 4, draws))
    assert draws.exhausted
    assert set(got) == set(ref)
    torch_flips.assert_flips_only(got, ref)
    for name in ("diffuse_direct", "diffuse_indirect"):
        bad = torch_flips.mismatched(got, ref, (name,), atol=1e-4 * np.abs(ref[name]).max(),
                                     rtol=0.0)
        assert bad.sum() <= torch_flips.FLIP_SHARE * bad.size, (name, int(bad.sum()))
        assert not (bad & ~torch_flips.near_edges(ref)).any(), name


@pytest.mark.parametrize("seed", [0, 5], ids=["emitter", "no-emitter"])
def test_gt_matches_jax_gt_within_monte_carlo_error(seed):
    """Two independent 512-spp estimates of the same scene: the port's
    against JAX's differs no more than JAX's two keys do (RMS, x1.5)."""
    scene = jmc.make_scene(seed)
    a, b = (jmc._render_jit(scene, H, W, 512, jax.random.PRNGKey(k), tuple(jmc.LIGHT_GROUPS))
            for k in (100, 200))
    port = _np(mc_tracer.render(mc_tracer.make_scene(seed, device=CPU), H, W, 512,
                                seeded(300, CPU)))
    for name in ("diffuse_direct", "diffuse_indirect"):
        ja, jb = np.asarray(a[name]), np.asarray(b[name])
        spread = np.sqrt(np.mean((ja - jb) ** 2))
        assert spread > 0, name
        assert np.sqrt(np.mean((port[name] - ja) ** 2)) <= 1.5 * spread, name


# --- twins of tests/test_mc_tracer.py on the port ----------------------------


def test_deterministic():
    a = _noisy(H, W, seed=3, spp=4, sample_seed=5)
    b = _noisy(H, W, seed=3, spp=4, sample_seed=5)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    c = _noisy(H, W, seed=3, spp=4, sample_seed=6)
    assert np.abs(a["diffuse_direct"] - c["diffuse_direct"]).max() > 0


def test_recomposition_identity_clean_and_noisy():
    clean = _clean(H, W, seed=1, spp=32)
    noisy = _noisy(H, W, seed=1, spp=4)
    for frame in (clean, noisy):
        np.testing.assert_allclose(frame["combined"], recompose_np(frame), atol=2e-5)


def test_aux_buffers_noise_free():
    clean = _clean(H, W, seed=2, spp=8)
    noisy = _noisy(H, W, seed=2, spp=4)
    for k in ("normal", "depth", "alpha", "emission", "environment",
              "diffuse_color", "glossy_color"):
        np.testing.assert_array_equal(clean[k], noisy[k])


def test_noisy_converges_to_gt():
    gt = _clean(H, W, seed=4, spp=512)
    singles = [_noisy(H, W, seed=4, spp=8, sample_seed=s) for s in range(16)]
    key = "diffuse_direct"
    err_one = np.sqrt(np.mean((singles[0][key] - gt[key]) ** 2))
    mean = np.mean([s[key] for s in singles], axis=0)
    err_mean = np.sqrt(np.mean((mean - gt[key]) ** 2))
    assert err_one > 0
    assert err_mean < err_one / 2.5, (err_mean, err_one)


def _emitter_seeds(n=3):
    out = [seed for seed in range(40)
           if float(mc_tracer.make_scene(seed, device=CPU).emission.max()) > 0][:n]
    assert len(out) == n, "fewer than 3 emitter seeds in 40 (p < 1e-9)"
    return out


def test_indirect_noise_is_heavy_tailed():
    kurts, ratios = [], []
    for seed in _emitter_seeds(3):
        gt = _clean(H, W, seed=seed, spp=512)
        noisy = _noisy(H, W, seed=seed, spp=4)
        hitmask = gt["alpha"][..., 0] > 0.5
        resid = (noisy["diffuse_indirect"] - gt["diffuse_indirect"])[hitmask].ravel()
        resid = resid - resid.mean()
        std = resid.std()
        assert std > 0
        kurts.append(np.mean(resid**4) / std**4 - 3.0)
        ratios.append(np.abs(resid).max() / std)
    assert max(kurts) > 8.0, f"excess kurtosis {kurts} — not heavy-tailed"
    assert max(ratios) > 8.0, f"max/std {ratios} — no fireflies"


def test_direct_noise_concentrates_in_penumbrae():
    seed = 4
    gt = _clean(H, W, seed=seed, spp=512)
    realizations = np.stack([_noisy(H, W, seed=seed, spp=4, sample_seed=s)["diffuse_direct"]
                             for s in range(8)])
    pixel_std = realizations.std(axis=0).mean(-1)
    signal = gt["diffuse_direct"].mean(-1)
    hit = gt["alpha"][..., 0] > 0.5
    lit = hit & (signal > np.percentile(signal[hit], 80))
    mid = hit & (signal > np.percentile(signal[hit], 30)) & (
        signal < np.percentile(signal[hit], 60))
    # the scene is make_scene(4), bit-equal to the JAX test's: not degenerate
    assert mid.sum() >= 20 and lit.sum() >= 20
    rel_mid = (pixel_std[mid] / np.maximum(signal[mid], 1e-3)).mean()
    rel_lit = (pixel_std[lit] / np.maximum(signal[lit], 1e-3)).mean()
    assert rel_mid > 1.2 * rel_lit, (rel_mid, rel_lit)


def test_window_render_matches_full_frame_slice():
    scene = mc_tracer.make_scene(11, device=CPU)
    full = _np(mc_tracer.render(scene, H, W, 128, seeded(0, CPU)))
    ch, cw, oy, ox = 16, 16, 20, 24
    win = _np(mc_tracer.render(scene, ch, cw, 128, seeded(0, CPU), window_origin=(oy, ox),
                               full_shape=(H, W)))
    sl = np.s_[oy:oy + ch, ox:ox + cw]
    for k in ("normal", "depth", "alpha", "emission", "environment", "diffuse_color"):
        np.testing.assert_allclose(win[k], full[k][sl], atol=1e-5, err_msg=k)
    a = win["diffuse_direct"].mean()
    b = full["diffuse_direct"][sl].mean()
    assert abs(a - b) < 0.15 * max(abs(b), 1e-3), (a, b)


def test_batched_render_equals_each_scene_alone():
    """A batch of scenes with one window each traces every scene as it
    would alone (same draws: one scene's batch of one)."""
    scenes = mc_tracer.make_scene_random(Draws(torch.Generator().manual_seed(2)), 3)
    origins = (torch.tensor([0, 17, 40]), torch.tensor([5, 0, 33]))
    both = mc_tracer.render(scenes, 8, 8, 1, seeded(1, CPU), window_origin=origins,
                            full_shape=(H, W))
    for i in range(3):
        one = mc_tracer.render(mc_tracer.scene_slice(scenes, i, i + 1), 8, 8, 1, seeded(1, CPU),
                               window_origin=(origins[0][i:i + 1], origins[1][i:i + 1]),
                               full_shape=(H, W))
        for k in torch_flips.DETERMINISTIC:
            torch.testing.assert_close(both[k][i], one[k][0], rtol=0, atol=0, msg=k)


def test_make_scene_random_renders_and_is_deterministic():
    s1 = mc_tracer.make_scene_random(Draws(torch.Generator().manual_seed(7)), 1)
    s2 = mc_tracer.make_scene_random(Draws(torch.Generator().manual_seed(7)), 1)
    for a, b in zip(s1, s2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    out = _np(mc_tracer.render(mc_tracer.scene_slice(s1, 0, 1), 24, 32, 4, seeded(1, CPU)))
    comb = out["combined"][0]
    assert np.isfinite(comb).all()
    assert comb.max() > 0
    np.testing.assert_allclose(comb, recompose_np({k: v[0] for k, v in out.items()}), atol=2e-5)


def test_training_batch_mc_families(monkeypatch):
    from deepdenoiser_tpu_torch import transforms

    monkeypatch.setattr(synthetic_device, "MC_TRAIN_GT_SPP", 16)
    crop = 24
    for family, n in (("mc", 4), ("mixed-mc", 6)):
        b = synthetic_device.training_batch(torch.Generator().manual_seed(3), n, crop, "joint",
                                            family)
        assert b["x"].shape == (n, crop, crop, transforms.joint_input_channels())
        assert b["y"].shape == (n, crop, crop, transforms.joint_output_channels())
        for v in b.values():
            assert torch.isfinite(v).all()


def test_entry_points_without_a_device_resolve_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mc_tracer.make_scene(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mc_tracer.generate_noisy_passes(8, 8, seed=0, spp=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        seeded(0)


def test_frame_set_contract():
    clean, noisy = mc_tracer.generate_frame_set(8, 12, seed=1, spps=(4, 16), n_seeds=2,
                                                gt_spp=8, device=CPU)
    assert len(noisy) == 4
    for n in noisy:
        assert set(n) == set(clean)
        torch.testing.assert_close(n["depth"], clean["depth"], rtol=0, atol=0)
    assert not torch.equal(noisy[0]["diffuse_direct"], noisy[1]["diffuse_direct"])
