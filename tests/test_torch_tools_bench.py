"""The port's bench and profiling tools (deepdenoiser_tpu_torch/tools/
bench_model.py, bench_4k.py, bench_sequence.py, bench_input_pipeline.py,
profile.py, sweep_bench.py, sweep_joint.py, sweep_4k.py) on the CPU at
64x96.

bench_model runs beside its JAX twin, field by field. bench_4k and
bench_sequence make their frames on the device from torch's generators,
so their quality fields are held to the JAX package's joint pipeline and
metrics run on the port tool's own frames, handed over as numpy. PSNR and
gain fields agree within 0.05 dB, SSIM within 2e-3; no latency or rate is
compared, only required to be finite and positive.
"""

import dataclasses
import json
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.bench_input_pipeline as jbench_input_pipeline
import tools.bench_model as jbench_model
import tools.sweep_bench as jsweep_bench
import tools.sweep_joint as jsweep_joint
from deepdenoiser_tpu.config import InferenceConfig as JInferenceConfig
from deepdenoiser_tpu.data import shards as jshards
from deepdenoiser_tpu.inference import pipeline as jpipeline
from deepdenoiser_tpu.ops import metrics as jmetrics
from deepdenoiser_tpu.weights_io import load_release_params as jload_release_params
from deepdenoiser_tpu_torch.tools import (bench_4k, bench_input_pipeline, bench_model,
                                          bench_sequence, profile, sweep_4k, sweep_bench,
                                          sweep_joint)
from deepdenoiser_tpu_torch.tools.pretrain_flagship import REPO_ROOT, WEIGHTS_DIR
from tools.pretrain_flagship import MODELS as JMODELS
from test_torch_tools_eval import DB_TOL, SSIM_TOL, last_json, run_port_tool
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

H, W = 64, 96
SIZE = ["--height", str(H), "--width", str(W)]
CPU = torch.device("cpu")
KPN_HQ = str(WEIGHTS_DIR / "kpn_hq_ema_f16.npz")


def jax_quality(icfg: JInferenceConfig, frames, gts):
    """Per frame (PSNR, SSIM, noisy PSNR) of kpn-hq's release weights
    through the JAX joint pipeline, on numpy frames."""
    denoise, _ = jpipeline.make_joint_frame_denoiser(JMODELS["kpn-hq"], icfg, H, W)
    params = jload_release_params(KPN_HQ)
    tm = jmetrics.tonemap_for_metrics
    out = []
    for frame, gt in zip(frames, gts):
        pred = tm(denoise(params, {k: jnp.asarray(v) for k, v in frame.items()})["combined"])
        ref = tm(jnp.asarray(gt))[None]
        out.append((float(jmetrics.psnr_per_image(pred[None], ref)[0]),
                    float(jmetrics.ssim(pred[None], ref)[0]),
                    float(jmetrics.psnr_per_image(tm(jnp.asarray(frame["combined"]))[None],
                                                  ref)[0])))
    return out


def numpy_frame(frame):
    return {k: v.numpy() for k, v in frame.items()}


def test_bench_model_matches_jax(monkeypatch, capsys):
    argv = ["--model", "kpn-hq", *SIZE, "--chain", "2", "--samples", "1"]
    monkeypatch.setattr(sys, "argv", ["bench_model.py", *argv])
    monkeypatch.setenv("DDTPU_SKIP_GUARD", "1")
    capsys.readouterr()
    assert jbench_model.main() == 0
    want = last_json(capsys.readouterr().out)
    got = run_port_tool(bench_model, argv, capsys)
    assert set(got) == set(want)
    assert (got["model"], got["mode"]) == (want["model"], want["mode"]) == ("kpn-hq", "joint")
    for key in ("psnr", "noisy_psnr", "gain_db"):
        assert abs(got[key] - want[key]) <= DB_TOL, (key, got[key], want[key])
    assert abs(got["ssim"] - want["ssim"]) <= SSIM_TOL
    assert got["latency_ms"] > 0 and len(got["samples_ms"]) == 1


def test_bench_model_init_runs_seeded_random_parameters(capsys):
    got = run_port_tool(bench_model, ["--model", "kpn", "--init", *SIZE, "--chain", "1",
                                      "--samples", "2"], capsys)
    assert got["mode"] == "group" and len(got["samples_ms"]) == 2
    assert np.isfinite(got["psnr"]) and got["latency_ms"] > 0


@pytest.mark.parametrize("tiling", [[], ["--tile", "32", "--tile-batch", "2"]],
                         ids=["whole", "tiled"])
def test_bench_4k_quality_is_the_jax_pipelines_on_its_frames(tiling, capsys):
    got = run_port_tool(bench_4k, ["--model", "kpn-hq", *SIZE, "--frames", "2", *tiling],
                        capsys)
    assert got["n_frames"] == 2 and len(got["latency_ms"]) == 2
    assert all(t > 0 for t in got["latency_ms"]) and got["resolution"] == f"{W}x{H}"
    clean = bench_4k.clean_frame(H, W, CPU)
    frames = [numpy_frame(bench_4k.noisy_frame(clean, i, 4.0)) for i in range(2)]
    tile = dict(zip(tiling[::2], map(int, tiling[1::2])))
    icfg = JInferenceConfig(tile=tile.get("--tile", 0), tile_batch=tile.get("--tile-batch", 0),
                            border=32, compute_dtype="bfloat16")
    want = np.mean(jax_quality(icfg, frames, [clean["combined"].numpy()] * 2), axis=0)
    assert abs(got["psnr_mean"] - want[0]) <= DB_TOL
    assert abs(got["ssim_mean"] - want[1]) <= SSIM_TOL
    assert abs(got["psnr_noisy_mean"] - want[2]) <= DB_TOL


def test_bench_4k_frames_are_the_seeded_family():
    clean = bench_4k.clean_frame(H, W, CPU)
    again = bench_4k.clean_frame(H, W, CPU)
    assert all(torch.equal(clean[k], again[k]) for k in clean)
    a, b = bench_4k.noisy_frame(clean, 0, 4.0), bench_4k.noisy_frame(clean, 1, 4.0)
    assert torch.equal(a["diffuse_direct"], bench_4k.noisy_frame(clean, 0, 4.0)["diffuse_direct"])
    assert not torch.equal(a["diffuse_direct"], b["diffuse_direct"])
    assert torch.equal(a["normal"], clean["normal"])  # aux passes stay clean
    assert a["combined"].shape == (H, W, 3)


def test_bench_sequence_quality_is_the_jax_pipelines_on_its_frames(capsys):
    got = run_port_tool(bench_sequence, ["--model", "kpn-hq", "--weights", KPN_HQ, *SIZE,
                                         "--frames", "2", "--reps", "2"], capsys)
    assert "fetch_overhead_ms" not in got
    assert [f["t"] for f in got["frames"]] == [0.0, 0.35]
    assert got["per_frame_ms_chained"] > 0 and got["gen_chain_ms_total"] > 0
    pairs = [bench_sequence.sequence_frame(f["t"], H, W, 4.0, CPU) for f in got["frames"]]
    want = jax_quality(JInferenceConfig(tile=0, border=32, compute_dtype="bfloat16"),
                       [numpy_frame(n) for n, _ in pairs], [g.numpy() for _, g in pairs])
    for row, (psnr, ssim, base) in zip(got["frames"], want):
        assert abs(row["psnr"] - psnr) <= DB_TOL
        assert abs(row["ssim"] - ssim) <= SSIM_TOL
        assert abs(row["noisy_psnr"] - base) <= DB_TOL
        assert row["latency_ms"] > 0
    assert abs(got["gain_db_mean"] - np.mean([p - b for p, _, b in want])) <= DB_TOL


def test_bench_sequence_frames_are_reproducible_and_coherent():
    n0, g0 = bench_sequence.sequence_frame(0.35, H, W, 4.0, CPU)
    n1, g1 = bench_sequence.sequence_frame(0.35, H, W, 4.0, CPU)
    assert torch.equal(g0, g1)
    assert all(torch.equal(n0[k], n1[k]) for k in n0)
    n2, g2 = bench_sequence.sequence_frame(0.70, H, W, 4.0, CPU)
    assert not torch.equal(g0, g2)  # the scene drifts ...
    assert float((g0 - g2).abs().mean()) < float(g0.abs().mean())  # ... coherently
    assert not torch.equal(n0["diffuse_direct"], n2["diffuse_direct"])


def _jax_keys() -> set:
    """The JSON keys the JAX tool prints, read from its source."""
    src = Path(jbench_input_pipeline.__file__).read_text()
    return {"batch", "crop", "model"} | set(re.findall(r'result\["(\w+)"\]', src))


def test_bench_input_pipeline_keys_and_rates(tmp_path, capsys):
    shards = bench_input_pipeline._build_corpus(tmp_path, 32)
    got = run_port_tool(bench_input_pipeline, ["--steps", "3", "--batch", "2", "--crop", "32",
                                               "--model", "kpn-hq", "--shards", str(shards)],
                        capsys)
    assert set(got) == _jax_keys() - {"grain_fused_steps_per_s"}
    assert (got["batch"], got["crop"], got["model"]) == (2, 32, "kpn-hq")
    for key in ("host_iter_batches_per_s", "grain_2dispatch_steps_per_s",
                "synth_fused_steps_per_s", "grain_vs_synth"):
        assert np.isfinite(got[key]) and got[key] > 0, key


def test_bench_input_pipeline_corpus_is_the_jax_tools(tmp_path):
    port = bench_input_pipeline._build_corpus(tmp_path / "port", 32)
    ref = jbench_input_pipeline._build_corpus(tmp_path / "jax", 32)
    assert port.name == ref.name == "shards_c32"
    splits = sorted(p.name for p in ref.iterdir())
    assert "train" in splits and sorted(p.name for p in port.iterdir()) == splits
    for split in splits:
        assert sorted(p.name for p in (port / split).iterdir()) == \
            sorted(p.name for p in (ref / split).iterdir())
        assert json.loads((port / split / "meta.json").read_text()) == \
            json.loads((ref / split / "meta.json").read_text())
        got, want = jshards.ShardReader(port / split), jshards.ShardReader(ref / split)
        assert len(got) == len(want)
        assert split != "train" or len(want) > 1
        for i in range(len(want)):
            a, b = got[i], want[i]
            assert sorted(a) == sorted(b)
            for key in b:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{split}[{i}] {key}")
    # a second call reuses the shards
    assert bench_input_pipeline._build_corpus(tmp_path / "port", 32) == port


def test_profile_trace_holds_each_frame(tmp_path, capsys):
    capsys.readouterr()
    assert profile.main([*SIZE, "--iters", "2", "--out", str(tmp_path), "--device", "cpu"]) == 0
    trace = tmp_path / "trace.json"
    assert str(trace) in capsys.readouterr().out
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"frame_0", "frame_1"} <= names and "frame_2" not in names


def _jax_configs(module, monkeypatch):
    """The (config, tile) pairs the JAX sweep's main() hands to measure()."""
    seen = []
    monkeypatch.setattr(module, "H", 16)
    monkeypatch.setattr(module, "W", 16)
    if module is jsweep_bench:
        monkeypatch.setattr(module, "measure", lambda mcfg, tile, frame: seen.append((mcfg, tile)))
    else:
        monkeypatch.setattr(module, "measure", lambda mcfg, frame: seen.append((mcfg, 0)))
    module.main()
    return seen


@pytest.mark.parametrize("port,ref", [(sweep_bench, jsweep_bench), (sweep_joint, jsweep_joint)],
                         ids=["sweep_bench", "sweep_joint"])
def test_sweep_configs_are_the_jax_lists(port, ref, monkeypatch):
    assert (port.H, port.W, port.K) == (ref.H, ref.W, ref.K) == (1080, 1920, 6)
    want = _jax_configs(ref, monkeypatch)
    got = port.CONFIGS if port is sweep_bench else [(m, 0) for m in port.CONFIGS]
    assert len(got) == len(want) == 5
    for (mcfg, tile), (jmcfg, jtile) in zip(got, want):
        assert dataclasses.asdict(mcfg) == dataclasses.asdict(jmcfg)
        assert tile == jtile


@pytest.mark.parametrize("module", [sweep_bench, sweep_joint], ids=["sweep_bench", "sweep_joint"])
def test_sweep_measure_runs_one_config(module, monkeypatch, capsys):
    monkeypatch.setattr(module, "H", H)
    monkeypatch.setattr(module, "W", W)
    frame = sweep_bench.bench_frame(H, W, CPU)
    first = module.CONFIGS[0]
    ms = module.measure(*first, frame, CPU) if module is sweep_bench else \
        module.measure(first, frame, CPU)
    assert np.isfinite(ms) and ms > 0
    assert "ms/frame" in capsys.readouterr().out


def test_sweep_4k_runs_bench_4k_over_its_configs(monkeypatch, capsys):
    calls = []

    class Done:
        def __init__(self, rc):
            self.returncode = rc

    def fake_run(cmd, cwd, timeout):
        calls.append(cmd)
        assert timeout == sweep_4k.TIMEOUT_S == 600 and Path(cwd) == REPO_ROOT
        return Done(1 if "736" in cmd else 0)

    monkeypatch.setattr(sweep_4k.subprocess, "run", fake_run)
    assert sweep_4k.main(["--device", "cpu"]) == 1  # one config failed
    assert len(calls) == 5
    for cmd, cfg in zip(calls, sweep_4k.CONFIGS):
        assert cmd[1:] == ["-m", "deepdenoiser_tpu_torch.tools.bench_4k", "--model",
                           "flagship-hq", "--frames", "2", *cfg, "--device", "cpu"]
    assert "FAILED (1): --tile 736 --tile-batch 3" in capsys.readouterr().out
    jax_cfgs = re.findall(r'"(--tile [^"]+)"', (Path(jsweep_bench.__file__).parent
                                                / "sweep_4k.sh").read_text())
    assert [" ".join(c) for c in sweep_4k.CONFIGS] == jax_cfgs
