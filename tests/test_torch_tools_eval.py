"""The port's evaluation tools (deepdenoiser_tpu_torch/tools/eval_holdout.py,
eval_zoo.py, diag_multiscale.py, split_multilayer.py) against their JAX
twins in tools/, on the CPU at 64x96 with one frame and one spp.

Each JAX tool runs as its own tests run it: imported as tools.<name>, its
main() under a patched sys.argv, its last JSON line read from stdout.
PSNR and gain fields agree within 0.05 dB (the repo's bf16 bar; both tools
round to 0.01), SSIM within 2e-3, every other field exactly; no latency
is compared.
"""

import json
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import tools.diag_multiscale as jdiag_multiscale
import tools.eval_holdout as jeval_holdout
import tools.eval_zoo as jeval_zoo
import tools.split_multilayer as jsplit_multilayer
from tools.pretrain_flagship import MODELS as JMODELS
from deepdenoiser_tpu.models import factory as jfactory
from deepdenoiser_tpu_torch import config, weights_io
from deepdenoiser_tpu_torch.data import exr, synthetic
from deepdenoiser_tpu_torch.tools import diag_multiscale, eval_holdout, eval_zoo, split_multilayer
from deepdenoiser_tpu_torch.tools.pretrain_flagship import MODELS
from deepdenoiser_tpu_torch.training import train as train_lib
from deepdenoiser_tpu_torch.training.checkpoint import CheckpointManager
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

DB_TOL = 0.05
SSIM_TOL = 2e-3
SIZE = ["--height", "64", "--width", "96"]


def last_json(out: str) -> dict:
    """The last line of `out` that is a JSON object."""
    for line in reversed(out.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no JSON line in {out!r}")


def run_jax_tool(module, argv, monkeypatch, capsys) -> dict:
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    monkeypatch.setenv("DDTPU_SKIP_GUARD", "1")
    capsys.readouterr()
    assert module.main() == 0
    return last_json(capsys.readouterr().out)


def run_port_tool(module, argv, capsys) -> dict:
    capsys.readouterr()
    assert module.main([*argv, "--device", "cpu"]) == 0
    return last_json(capsys.readouterr().out)


def assert_row_agrees(got: dict, want: dict, db_keys=(), skip=("latency_ms",)) -> None:
    assert set(got) == set(want)
    for key, ref in want.items():
        if key in skip:
            continue
        if "ssim" in key:
            assert abs(got[key] - ref) <= SSIM_TOL, (key, got[key], ref)
        elif "psnr" in key or "gain" in key or key in db_keys:
            assert abs(got[key] - ref) <= DB_TOL, (key, got[key], ref)
        else:
            assert got[key] == ref, (key, got[key], ref)


def test_eval_holdout_matches_jax(monkeypatch, capsys):
    argv = [*SIZE, "--frames", "1", "--spp", "4"]
    want = run_jax_tool(jeval_holdout, argv, monkeypatch, capsys)["eval_holdout"]
    got = run_port_tool(eval_holdout, argv, capsys)["eval_holdout"]
    assert [r["family"] for r in got] == [r["family"] for r in want]
    assert len(got) == 4
    for g, w in zip(got, want):
        assert_row_agrees(g, w)
        assert g["latency_ms"] > 0


def test_eval_zoo_matches_jax(monkeypatch, capsys):
    argv = ["--models", "kpn-hq", "kpn", *SIZE, "--frames", "1", "--no-mc", "--quality-only"]
    want = run_jax_tool(jeval_zoo, [*argv, "--cpu"], monkeypatch, capsys)["zoo"]
    got = run_port_tool(eval_zoo, argv, capsys)["zoo"]
    assert [(r["model"], r["mode"]) for r in got] == [("kpn-hq", "joint"), ("kpn", "group")]
    for g, w in zip(got, want):
        assert g["latency_ms"] is None
        assert_row_agrees(g, w, skip=())


def test_eval_zoo_times_and_traces_when_asked(capsys):
    """The latency column and the traced Monte-Carlo family, which the JAX
    comparison leaves out (latency is not compared; the tracer draws from
    torch's generators)."""
    got = run_port_tool(eval_zoo, ["--models", "kpn-hq", "--height", "32", "--width", "48",
                                   "--frames", "1", "--chain", "2", "--mc-gt-spp", "8"],
                        capsys)["zoo"]
    (row,) = got
    assert row["latency_ms"] > 0
    assert {"mc_psnr", "mc_gain_db", "mc_ssim"} <= set(row)
    assert all(np.isfinite(v) for k, v in row.items() if k not in ("model", "mode"))


def _jax_multiscale_params():
    """The JAX package's multiscale init as numpy, its zero-initialised
    output conv filled from a seed so that the probe's gains are not 0."""
    params = jfactory.init_params(JMODELS["multiscale"], jax.random.PRNGKey(0), spatial=64)
    flat = weights_io.flatten(jax.tree_util.tree_map(np.asarray, dict(params)))
    head = "params/UNet_0/Conv_0/kernel"
    assert not flat[head].any()
    flat[head] = np.random.default_rng(5).normal(0.0, 0.05, flat[head].shape).astype(np.float32)
    return weights_io.unflatten(flat)


def test_diag_multiscale_matches_jax(monkeypatch, capsys):
    params = _jax_multiscale_params()

    monkeypatch.setattr(jeval_zoo, "load_model_params",
                        lambda name: (JMODELS[name], params, "joint"))
    monkeypatch.setattr(eval_zoo, "load_model_params",
                        lambda name: (MODELS[name], params, "joint"))
    argv = [*SIZE, "--frames", "1"]
    want = run_jax_tool(jdiag_multiscale, argv, monkeypatch, capsys)["multiscale_diag"]
    got = run_port_tool(diag_multiscale, argv, capsys)["multiscale_diag"]
    assert [r["n_scales"] for r in got] == [r["n_scales"] for r in want] == [3, 2, 1]
    for g, w in zip(got, want):
        assert_row_agrees(g, w, db_keys=("fourier", "voronoi", "spheres", "boxes"))
    assert any(r["voronoi"] != 0.0 for r in got)


def test_split_multilayer_writes_what_the_jax_tool_writes(tmp_path, monkeypatch, capsys):
    clean = synthetic.generate_clean_passes(24, 40, seed=9)
    frame = synthetic.add_mc_noise(clean, spp=4, seed=2)
    for who in ("jax", "port"):
        exr.save_multilayer_exr(tmp_path / who / "frame.exr", frame)
    monkeypatch.setattr(sys, "argv", ["split_multilayer.py", str(tmp_path / "jax" / "frame.exr")])
    assert jsplit_multilayer.main() == 0
    assert split_multilayer.main([str(tmp_path / "port" / "frame.exr")]) == 0
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    assert len(names) == len(frame) + 1
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    split = exr.load_frame_dir(tmp_path / "port", strict=False)
    for key, arr in frame.items():
        np.testing.assert_array_equal(split[key], np.asarray(arr, np.float32), err_msg=key)
    assert split_multilayer.main([]) == 2


def test_load_model_params_reads_release_files_then_port_checkpoints(tmp_path, monkeypatch):
    mcfg, params, mode = eval_zoo.load_model_params("kpn-hq")
    assert (mcfg, mode) == (MODELS["kpn-hq"], "joint")
    ref = weights_io.flatten(weights_io.load_release_params(
        eval_zoo.WEIGHTS_DIR / "kpn_hq_ema_f16.npz"))
    assert weights_io.flatten(params).keys() == ref.keys()

    monkeypatch.setattr(eval_zoo, "CHECKPOINTS_DIR", tmp_path)
    with pytest.raises(FileNotFoundError, match="no weights for 'multiscale'"):
        eval_zoo.load_model_params("multiscale")
    state = train_lib.create_state(MODELS["multiscale"], config.TrainConfig(ema_decay=0.9),
                                   seed=3, device="cpu")
    with torch.no_grad():
        for v in state.ema_params.values():
            v.add_(1.0)  # EMA apart from the raw parameters
    mgr = CheckpointManager(tmp_path / "multiscale")
    mgr.save(7, state)
    mgr.close()
    mcfg, params, mode = eval_zoo.load_model_params("multiscale")
    assert (mcfg, mode) == (MODELS["multiscale"], "joint")
    got = weights_io.state_dict_from_params(params)
    assert got.keys() == state.ema_params.keys()
    for key, ema in state.ema_params.items():
        torch.testing.assert_close(got[key], ema, rtol=0, atol=0)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the tools run on it")


@pytest.mark.parametrize("name,argv", [
    ("eval_zoo", []), ("eval_holdout", []), ("bench_model", ["--model", "kpn-hq"]),
    ("bench_4k", []), ("bench_sequence", []), ("bench_input_pipeline", []), ("profile", []),
    ("sweep_bench", []), ("sweep_joint", []), ("sweep_4k", []), ("diag_multiscale", []),
])
def test_each_tool_runs_on_the_card_by_default_and_raises_without_one(name, argv, no_card):
    module = __import__(f"deepdenoiser_tpu_torch.tools.{name}", fromlist=["main"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)


@pytest.mark.parametrize("name", [
    "eval_zoo", "eval_holdout", "bench_model", "bench_4k", "bench_sequence",
    "bench_input_pipeline", "profile", "sweep_bench", "sweep_joint", "sweep_4k",
    "diag_multiscale", "split_multilayer",
])
def test_each_tool_runs_as_a_module(name, monkeypatch, capsys):
    """`python -m deepdenoiser_tpu_torch.tools.<name>` reaches main():
    --help for the tools with flags, the usage text for split_multilayer,
    which takes paths only."""
    split = name == "split_multilayer"
    monkeypatch.setattr(sys, "argv", [name] + ([] if split else ["--help"]))
    monkeypatch.delitem(sys.modules, f"deepdenoiser_tpu_torch.tools.{name}", raising=False)
    with pytest.raises(SystemExit) as e:
        runpy.run_module(f"deepdenoiser_tpu_torch.tools.{name}", run_name="__main__")
    assert e.value.code == (2 if split else 0)
    assert "deepdenoiser_tpu_torch.tools." + name in capsys.readouterr().out
