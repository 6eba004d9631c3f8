"""The port's sequence harness and `eval` command against the JAX
package's harness, on the CPU: the same report keys, PSNR and SSIM within
1e-3 on two tiny frames, in joint, group and rgb mode, from memory and from
a render root on disk.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu import config as jconfig
from deepdenoiser_tpu import transforms as jtransforms
from deepdenoiser_tpu.data import prepare as jprepare
from deepdenoiser_tpu.inference import sequence as jsequence
from deepdenoiser_tpu.models import factory as jfactory
from deepdenoiser_tpu_torch import cli, config, weights_io
from deepdenoiser_tpu_torch.data import exr, prepare, synthetic
from deepdenoiser_tpu_torch.inference import sequence
from deepdenoiser_tpu_torch.models import factory

REPO = Path(__file__).resolve().parents[1]
H, W = 32, 48
TOL = 1e-3
KEYS = {"n_frames", "height", "width", "grid", "latency_ms", "latency_ms_mean",
        "latency_ms_median", "fetch_overhead_ms", "psnr", "psnr_mean", "ssim", "ssim_mean"}
CHANNELS = {"joint": (jtransforms.joint_input_channels(), 24),
            "group": (jtransforms.group_input_channels(), 6),
            "rgb": (jtransforms.rgb_input_channels(), 3)}


def _frames(n=2):
    cleans = [synthetic.generate_clean_passes(H, W, seed=20 + i) for i in range(n)]
    noisy = [synthetic.add_mc_noise(c, spp=4, seed=30 + i) for i, c in enumerate(cleans)]
    return cleans, [{k: np.asarray(v, np.float32) for k, v in f.items()} for f in noisy]


def _tiny(mode, **kw):
    cin, cout = CHANNELS[mode]
    d = dict(backbone="unet", in_channels=cin, out_channels=cout, base_width=4, depth=2,
             convs_per_level=1, act="leaky_relu", predict_residual=True)
    d.update(kw)
    jcfg = jfactory.ModelConfig(**d)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(jfactory.build_model(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, d["in_channels"])))
    params = jax.tree_util.tree_map(
        lambda l: (0.05 * rng.standard_normal(l.shape)).astype(np.float32), shapes)
    return jcfg, factory.ModelConfig(**d), params


def _check_report(got, want, n):
    assert set(got) == set(want) == KEYS
    assert got["n_frames"] == want["n_frames"] == n
    assert (got["height"], got["width"]) == (H, W)
    assert got["grid"] == want["grid"]
    assert len(got["latency_ms"]) == len(got["psnr"]) == len(got["ssim"]) == n
    np.testing.assert_allclose(got["psnr"], want["psnr"], atol=TOL)
    np.testing.assert_allclose(got["ssim"], want["ssim"], atol=TOL)
    assert abs(got["psnr_mean"] - want["psnr_mean"]) <= TOL
    assert abs(got["ssim_mean"] - want["ssim_mean"]) <= TOL
    assert got["latency_ms_median"] == float(np.median(got["latency_ms"]))
    assert got["latency_ms_mean"] > 0 and min(got["latency_ms"]) > 0
    assert got["fetch_overhead_ms"] >= 0
    json.dumps(got)  # plain Python numbers all the way down


@pytest.mark.parametrize("mode,infer_kw", [
    ("joint", dict()), ("joint", dict(tile=32, tile_batch=2)), ("group", dict()), ("rgb", dict()),
], ids=["joint", "joint-tiled", "group", "rgb"])
def test_run_sequence_matches_the_jax_harness(mode, infer_kw):
    cleans, noisy = _frames()
    gts = [np.asarray(c["combined"], np.float32) for c in cleans]
    jcfg, cfg, params = _tiny(mode)
    want = jsequence.run_sequence(
        jcfg, jconfig.InferenceConfig(compute_dtype="float32", **infer_kw), params, noisy, gts,
        mode=mode)
    got = sequence.run_sequence(
        cfg, config.InferenceConfig(compute_dtype="float32", **infer_kw), params, noisy, gts,
        mode=mode, device="cpu")
    _check_report(got, want, 2)
    assert 5 < got["psnr_mean"] < 60 and 0 < got["ssim_mean"] < 1


def test_run_sequence_without_ground_truth_scores_against_the_noisy_combined():
    _, noisy = _frames(1)
    jcfg, cfg, params = _tiny("joint")
    icfg = config.InferenceConfig(compute_dtype="float32")
    got = sequence.run_sequence(cfg, icfg, params, noisy, mode="joint", device="cpu")
    want = sequence.run_sequence(cfg, icfg, params, noisy, [noisy[0]["combined"]], mode="joint",
                                 device="cpu")
    assert got["psnr"] == want["psnr"] and got["ssim"] == want["ssim"]


def test_make_sequence_denoiser_returns_device_scalars():
    cleans, noisy = _frames(1)
    _, cfg, params = _tiny("joint")
    run, grid = sequence.make_sequence_denoiser(
        cfg, config.InferenceConfig(compute_dtype="float32"), H, W, params, mode="joint",
        device="cpu")
    combined, p, s = run(noisy[0], cleans[0]["combined"])
    assert tuple(combined.shape) == (H, W, 3) and grid.n_tiles == 1
    assert isinstance(p, torch.Tensor) and p.dim() == 0 and s.dim() == 0


def test_sequence_threads_flags_and_groups_into_joint_mode():
    """A flag-conditioned model over frames lacking two light groups."""
    g2 = ("diffuse", "glossy")
    clean = synthetic.generate_clean_passes(H, W, seed=3, groups=g2)
    noisy = [synthetic.add_mc_noise(clean, spp=4, seed=4, groups=g2)]
    jcfg, cfg, params = _tiny("joint", in_channels=45)
    want = jsequence.run_sequence(jcfg, jconfig.InferenceConfig(compute_dtype="float32"), params,
                                  noisy, [clean["combined"]], mode="joint", use_flags=True)
    got = sequence.run_sequence(cfg, config.InferenceConfig(compute_dtype="float32"), params,
                                noisy, [clean["combined"]], mode="joint", use_flags=True,
                                device="cpu")
    _check_report(got, want, 1)


def _write_render_root(root, n=2):
    cleans, noisy = _frames(n)
    for i, (c, f) in enumerate(zip(cleans, noisy)):
        fd = root / f"frame{i:04d}"
        exr.save_frame_dir(fd / prepare.GT_DIR, {k: np.asarray(v, np.float32) for k, v in c.items()})
        exr.save_frame_dir(fd / "spp4_seed0", f)
        # a cleaner variant that sorts first by name: must not be the one scored
        exr.save_frame_dir(fd / "spp16_seed0", {k: np.asarray(v, np.float32)
                                                for k, v in c.items()})
    (root / "notes").mkdir()  # no ground_truth inside: not a frame
    return cleans, noisy


def test_evaluate_render_root_matches_the_jax_harness(tmp_path):
    cleans, noisy = _write_render_root(tmp_path)
    assert prepare.GT_DIR == jprepare.GT_DIR
    assert prepare._frame_dirs(tmp_path) == jprepare._frame_dirs(tmp_path)
    assert [p.name for p in prepare._frame_dirs(tmp_path)] == ["frame0000", "frame0001"]
    jcfg, cfg, params = _tiny("joint")
    want = jsequence.evaluate_render_root(
        jcfg, jconfig.InferenceConfig(compute_dtype="float32"), params, tmp_path, mode="joint")
    got = sequence.evaluate_render_root(
        cfg, config.InferenceConfig(compute_dtype="float32"), params, tmp_path, mode="joint",
        device="cpu")
    _check_report(got, want, 2)
    # the noisiest variant was scored, not the clean 'spp16' one
    direct = sequence.run_sequence(
        cfg, config.InferenceConfig(compute_dtype="float32"), params, noisy,
        [c["combined"] for c in cleans], mode="joint", device="cpu")
    np.testing.assert_allclose(got["psnr"], direct["psnr"], atol=1e-4)
    one = sequence.evaluate_render_root(
        cfg, config.InferenceConfig(compute_dtype="float32"), params, tmp_path, mode="joint",
        max_frames=1, device="cpu")
    assert one["n_frames"] == 1 and one["psnr"] == got["psnr"][:1]
    with pytest.raises(FileNotFoundError, match="no frames"):
        sequence.evaluate_render_root(cfg, config.InferenceConfig(), params, tmp_path / "notes",
                                      device="cpu")


@pytest.mark.parametrize("name,key", [
    ("spp4_seed0", (4, "spp4_seed0")), ("spp16_seed0", (16, "spp16_seed0")),
    ("noisy", (10**9, "noisy")), ("spp128", (128, "spp128")),
])
def test_variant_spp_key_matches_jax(name, key):
    assert sequence._variant_spp_key(Path(name)) == jsequence._variant_spp_key(Path(name)) == key


@pytest.mark.parametrize("source", ["preset", "config"])
def test_cli_eval_prints_the_report(tmp_path, capsys, source):
    _write_render_root(tmp_path / "renders", n=1)
    weights = str(REPO / "weights" / "flagship_ema_f16.npz")
    if source == "preset":
        src = ["--preset", "flagship"]
        want_grid = {"tile_h": 32, "tile_w": 48, "halo": 32, "n_tiles": 1}
    else:
        d = config.to_dict(config.PRESETS["flagship"])
        d["infer"].update(tile=32, tile_batch=1)
        (tmp_path / "tiled.json").write_text(json.dumps(d))
        src = ["--config", str(tmp_path / "tiled.json")]
        halo = factory.halo(config.PRESETS["flagship"].model)
        want_grid = {"tile_h": 32, "tile_w": 32, "halo": -(-halo // 16) * 16, "n_tiles": 2}
    rc = cli.main(["eval", *src, "--weights", weights, "--renders", str(tmp_path / "renders"),
                   "--device", "cpu"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out)
    assert set(report) == KEYS
    assert report["n_frames"] == 1 and report["grid"] == want_grid
    assert np.isfinite(report["psnr_mean"]) and 0 < report["ssim_mean"] <= 1


@pytest.mark.parametrize("source", ["checkpoint", "checkpoint-and-weights", "neither"])
@pytest.mark.parametrize("command", ["eval", "denoise"])
def test_cli_checkpoint_and_missing_weights_return_2(command, source, tmp_path, capsys):
    """--checkpoint runs (an empty checkpoint directory: a warning and random
    weights, as in the JAX package), --weights wins over it, and only
    neither returns 2."""
    _write_render_root(tmp_path / "renders", n=1)
    ckpt = ["--checkpoint", str(tmp_path / "run" / "checkpoints")]
    weights = ["--weights", str(REPO / "weights" / "flagship_hq_ema_f16.npz")]
    argv = {"checkpoint": ckpt, "checkpoint-and-weights": ckpt + weights, "neither": []}[source]
    out = tmp_path / "o.exr"
    rest = (["--renders", str(tmp_path / "renders")] if command == "eval"
            else ["--frame", str(tmp_path / "renders" / "frame0000" / "spp4_seed0"),
                  "--out", str(out)])
    rc = cli.main([command, "--preset", "flagship-hq", *argv, *rest, "--device", "cpu"])
    err = capsys.readouterr().err
    if source == "neither":
        assert rc == 2
        assert "one of --checkpoint or --weights is required" in err
        return
    assert rc == 0
    assert ("no checkpoint under" in err) == (source == "checkpoint")
    if command == "denoise":
        assert exr.read_exr(out).shape[:2] == (H, W) and np.isfinite(exr.read_exr(out)).all()


def test_sequence_entry_points_without_device_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run on it")
    _, noisy = _frames(1)
    _, cfg, params = _tiny("joint")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sequence.run_sequence(cfg, config.InferenceConfig(), params, noisy, mode="joint")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sequence.make_sequence_denoiser(cfg, config.InferenceConfig(), H, W, params, mode="joint")
    _write_render_root(tmp_path, n=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["eval", "--preset", "flagship-hq", "--weights",
                  str(REPO / "weights" / "flagship_hq_ema_f16.npz"), "--renders", str(tmp_path)])


@pytest.mark.parametrize("mode", ["joint", "group"])
def test_batch_frame_denoiser_matches_jax_on_8_devices(devices8, mode):
    """tests/test_sequence.py:53-81 in both packages: 8 frames over an
    8-device 'data' mesh (the port's lists the CPU 8 times), each frame
    equal to JAX's and to its own one-frame denoise."""
    from deepdenoiser_tpu.parallel import mesh as jmesh
    from deepdenoiser_tpu_torch.inference import pipeline
    from deepdenoiser_tpu_torch.parallel import mesh

    jcfg, cfg, params = _tiny(mode, depth=1, predict_residual=False)
    _, frames = _frames(8)
    batch = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
    jm = jmesh.make_mesh(8)
    jden, jgrid = jsequence.make_batch_frame_denoiser(
        jcfg, jconfig.InferenceConfig(tile=0, compute_dtype="float32"), jm, H, W, mode=mode)
    want = np.asarray(jden(params, jmesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                                     jm)))
    icfg = config.InferenceConfig(tile=0, compute_dtype="float32")
    den, grid = sequence.make_batch_frame_denoiser(
        cfg, icfg, mesh.make_mesh(8, devices=["cpu"] * 8), H, W, params, mode=mode)
    got = den(batch)
    assert tuple(got.shape) == (8, H, W, 3) and grid.halo == jgrid.halo
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    make = (pipeline.make_joint_frame_denoiser if mode == "joint"
            else pipeline.make_group_frame_denoiser)
    one, _ = make(cfg, icfg, H, W, params, device="cpu")
    for i, f in enumerate(frames):
        np.testing.assert_allclose(got[i].numpy(), one(f)["combined"].numpy(), rtol=1e-5, atol=1e-5)
