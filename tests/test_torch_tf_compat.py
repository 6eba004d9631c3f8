"""The port's TF-checkpoint compat (compat/tf_checkpoint.py, compat/goldens.py,
tools/verify_parity.py) against the JAX package's, on the CPU.

The name maps are compared on every zoo family's full parameter tree and
on every release file's, in both directions; a checkpoint the JAX package
exports through TensorFlow is imported by both packages and forwarded by
both models (fp32, within 1e-5 x max|ref|); the four frozen goldens hold the
port at their own tolerance (2e-5).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu.compat import tf_checkpoint as jtfc
from deepdenoiser_tpu.models import factory as jfactory
from deepdenoiser_tpu.models.factory import ModelConfig as JModelConfig
from deepdenoiser_tpu_torch import weights_io
from deepdenoiser_tpu_torch.compat import goldens, tensor_bundle
from deepdenoiser_tpu_torch.compat import tf_checkpoint as tfc
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.models.factory import ModelConfig
from deepdenoiser_tpu_torch.tools import pretrain_flagship, verify_parity

REPO = Path(__file__).resolve().parents[1]
FWD_REL_TOL = 1e-5  # x max|ref|: both packages' fp32 forward of the same weights

# tiny twins of the four shipped families (as tests/test_tf_compat.py's)
ZOO_CFGS = {
    "unet": JModelConfig(backbone="unet", in_channels=5, out_channels=3,
                         base_width=4, depth=2, convs_per_level=2),
    "tiramisu": JModelConfig(backbone="tiramisu", in_channels=5, out_channels=3,
                             growth_rate=4, layers_per_block=2, depth=2,
                             up_compress=8, layers_top=1),
    "multiscale": JModelConfig(backbone="unet", in_channels=5, out_channels=3,
                               base_width=4, depth=2, convs_per_level=1, n_scales=2),
    "kpn": JModelConfig(backbone="unet", in_channels=8, out_channels=6,
                        base_width=4, depth=2, convs_per_level=1,
                        kernel_prediction=True, kpn_size=3, kpn_slots=2,
                        kpn_logit_norm=True),
}
# release file -> the recipe model it was trained as
RELEASES = {
    "flagship_ema_f16.npz": "flagship", "flagship_hq_ema_f16.npz": "flagship-hq",
    "flagship_mc_ema_f16.npz": "flagship-mc", "kpn_ema_f16.npz": "kpn",
    "kpn_hq_ema_f16.npz": "kpn-hq", "rgb_small_ema_f16.npz": "rgb-small",
    "tiramisu_ema_f16.npz": "tiramisu", "tiramisu_fast_ema_f16.npz": "tiramisu-fast",
    "tiramisu_lt1_ema_f16.npz": "tiramisu-lt1",
}


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _jax_tree(jcfg):
    """The JAX package's parameter tree of `jcfg`: its structure and shapes
    (jax.eval_shape of init_params, which compiles nothing), as zeros."""
    shapes = jax.eval_shape(lambda: jfactory.init_params(jcfg, jax.random.PRNGKey(0), spatial=16))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _params(jcfg, seed):
    """Seeded parameters of `jcfg` as the {'params': ...} numpy tree both
    packages take (initialised by the port; the tree is the JAX package's)."""
    model = factory.init_model(_port_cfg(jcfg), torch.Generator().manual_seed(seed))
    params = weights_io.params_from_state_dict(model.state_dict())
    assert jtfc.structural_diff(params, _jax_tree(jcfg)) == []
    return params


def _jax_forward(jcfg, params, x):
    return np.asarray(jax.jit(jfactory.build_model(jcfg).apply)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x)))


def _trees():
    """(name, JAX config, flat {Flax path: array}) of every tree checked."""
    out = []
    for fam, jcfg in sorted(ZOO_CFGS.items()):
        out.append((fam, jcfg, jtfc._flatten(dict(_jax_tree(jcfg)["params"]))))
    for npz, model in sorted(RELEASES.items()):
        with np.load(REPO / "weights" / npz) as z:
            flat = {k.removeprefix("params/"): None for k in z.files}
        out.append((npz, _jax_models()[model], flat))
    return out


def _jax_models():
    from tools.pretrain_flagship import MODELS

    return MODELS


@pytest.fixture(scope="module")
def trees():
    return _trees()


def test_full_name_maps_equal_the_jax_packages_both_ways(trees):
    assert len(trees) == len(ZOO_CFGS) + len(RELEASES)
    for what, jcfg, flat in trees:
        cfg = _port_cfg(jcfg)
        for path in flat:
            tf_name = tfc.full_flax_path_to_tf_name(path, cfg)
            assert tf_name == jtfc.full_flax_path_to_tf_name(path, jcfg), (what, path)
            back = tfc.full_tf_name_to_flax_path(tf_name, cfg)
            assert back == jtfc.full_tf_name_to_flax_path(tf_name, jcfg) == path, (what, tf_name)


def test_backbone_name_maps_equal_the_jax_packages_both_ways(trees):
    for what, jcfg, flat in trees:
        for path in flat:
            top, _, rest = path.partition("/")
            if top == "UNet_0":
                fwd, inv = "flax_path_to_tf_name", "tf_name_to_flax_path"
            elif top == "Tiramisu_0":
                fwd, inv = "tiramisu_flax_path_to_tf_name", "tiramisu_tf_name_to_flax_path"
            else:
                continue
            name = getattr(tfc, fwd)(rest, jcfg.depth)
            assert name == getattr(jtfc, fwd)(rest, jcfg.depth), (what, path)
            assert getattr(tfc, inv)(name, jcfg.depth) == getattr(jtfc, inv)(name, jcfg.depth) \
                == rest


@pytest.mark.parametrize("name", ["unet/head/kernel/Adam", "unet/head/kernel/Adam_1",
                                  "global_step", "beta1_power", "beta2_power",
                                  "tiramisu/stem/bias/Adam"])
def test_optimizer_slots_are_skipped(name):
    for fam in ("unet", "tiramisu"):
        cfg = _port_cfg(ZOO_CFGS[fam])
        assert tfc.full_tf_name_to_flax_path(name, cfg) is None
    assert tfc.tf_name_to_flax_path(name, 2) is None
    assert tfc.tiramisu_tf_name_to_flax_path(name, 2) is None


@pytest.mark.parametrize("fam,name", [
    ("unet", "resnet/stem/kernel"),  # unknown scope
    ("unet", "tiramisu/stem/kernel"),  # tiramisu-scoped variable into a unet
    ("tiramisu", "unet/head/kernel"),  # unet-scoped variable into a tiramisu
    ("unet", "kpn/kernel_temp"),  # the KPN temperature into a non-KPN model
    ("unet", "unet/mystery/kernel"),  # unmapped inside a known scope
    ("tiramisu", "tiramisu/side/kernel"),
])
def test_unmapped_variables_raise_the_typed_error(fam, name):
    cfg = _port_cfg(ZOO_CFGS[fam])
    with pytest.raises(tfc.UnmappedVariableError):
        tfc.full_tf_name_to_flax_path(name, cfg)
    with pytest.raises(jtfc.UnmappedVariableError):
        jtfc.full_tf_name_to_flax_path(name, ZOO_CFGS[fam])
    with pytest.raises(tfc.UnmappedVariableError):
        tfc.full_flax_path_to_tf_name("ResNet_0/Conv_0/kernel", cfg)
    assert issubclass(tfc.UnmappedVariableError, KeyError)


def _with_slots(prefix, out):
    """The checkpoint at `prefix` plus optimizer slots and a global step, as
    a training run leaves them."""
    arrays = tensor_bundle.read_bundle(prefix)
    for name, arr in list(arrays.items()):
        arrays[name + "/Adam"] = np.ones_like(arr)
        arrays[name + "/Adam_1"] = np.full_like(arr, 2.0)
    arrays["global_step"] = np.array(17, np.int64)
    arrays["beta1_power"] = np.array(0.9, np.float32)
    tensor_bundle.write_bundle(out, arrays)
    return out


@pytest.mark.parametrize("fam", sorted(ZOO_CFGS))
def test_import_then_forward_equals_the_jax_forward(tmp_path, fam):
    jcfg = ZOO_CFGS[fam]
    jparams = _params(jcfg, 2)
    prefix = tmp_path / "model.ckpt"
    jtfc.export_checkpoint(jparams, jcfg, prefix)  # through TensorFlow's Saver
    ckpt = _with_slots(prefix, tmp_path / "slots.ckpt")

    jimported = jtfc.import_checkpoint(ckpt, jcfg)
    imported = tfc.import_checkpoint(ckpt, _port_cfg(jcfg))
    assert tfc.structural_diff(imported, jimported) == []
    for path, arr in weights_io.flatten(imported).items():
        assert arr.dtype == np.float32
        assert arr.tobytes() == np.asarray(jtfc._flatten(jimported)[path]).tobytes(), path

    x = np.random.default_rng(3).standard_normal((1, 16, 16, jcfg.in_channels)).astype(np.float32)
    ref = _jax_forward(jcfg, jimported, x)
    model = factory.build_model(_port_cfg(jcfg))
    weights_io.load_into(model, imported)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= FWD_REL_TOL * np.max(np.abs(ref))


@pytest.mark.parametrize("fam", sorted(ZOO_CFGS))
def test_port_export_imports_in_both_packages(tmp_path, fam):
    jcfg = ZOO_CFGS[fam]
    params = _params(jcfg, 4)
    prefix = tmp_path / "model.ckpt"
    names = tfc.export_checkpoint(params, _port_cfg(jcfg), prefix)
    assert names == sorted(names)
    scope = "tiramisu/" if jcfg.backbone == "tiramisu" else "unet/"
    assert all(n.startswith((scope, "kpn/")) for n in names)
    for imported in (tfc.import_checkpoint(prefix, _port_cfg(jcfg)),
                     jtfc.import_checkpoint(prefix, jcfg)):  # TensorFlow reads it
        assert jtfc.structural_diff(imported, params) == []
        for path, arr in jtfc._flatten(dict(params["params"])).items():
            assert np.asarray(jtfc._flatten(imported["params"])[path]).tobytes() == arr.tobytes()


def test_unet_pair_equals_the_jax_packages(tmp_path):
    jcfg = ZOO_CFGS["unet"]
    params = _params(jcfg, 5)
    names = tfc.export_unet_checkpoint(params, jcfg.depth, tmp_path / "p.ckpt")
    assert names == jtfc.export_unet_checkpoint(params, jcfg.depth, tmp_path / "j.ckpt")
    for a in (tmp_path / "p.ckpt", tmp_path / "j.ckpt"):
        mine = tfc.import_unet_checkpoint(a, jcfg.depth)
        theirs = jtfc.import_unet_checkpoint(a, jcfg.depth)
        assert tfc.structural_diff(mine, theirs) == [] == tfc.structural_diff(mine, params)
        for path, arr in weights_io.flatten(theirs).items():
            assert weights_io.flatten(mine)[path].tobytes() == np.asarray(arr).tobytes()


def test_kernel_transform_hook_sees_every_variable(tmp_path):
    jcfg = ZOO_CFGS["kpn"]
    params = _params(jcfg, 6)
    prefix = tmp_path / "model.ckpt"
    names = tfc.export_checkpoint(params, _port_cfg(jcfg), prefix)
    seen = []

    def negate(name, arr):
        seen.append(name)
        return -arr

    imported = tfc.import_checkpoint(prefix, _port_cfg(jcfg), kernel_transform=negate)
    assert sorted(seen) == names
    ref = jtfc.import_checkpoint(prefix, jcfg, kernel_transform=lambda n, a: -a)
    for path, arr in jtfc._flatten(ref["params"]).items():
        assert np.array_equal(weights_io.flatten(imported["params"])[path], arr)


@pytest.mark.parametrize("fam", sorted(goldens.GOLDEN_CFGS))
def test_goldens_hold_on_the_cpu(fam):
    dev = goldens.check(fam, device="cpu")
    assert dev <= goldens.ATOL == 2e-5


def test_golden_configs_are_the_jax_packages():
    from deepdenoiser_tpu.compat import goldens as jgoldens

    assert goldens.ATOL == jgoldens.ATOL and goldens.SPATIAL == jgoldens.SPATIAL
    assert goldens.golden_dir() == jgoldens.golden_dir()
    assert {k: dataclasses.asdict(v) for k, v in goldens.GOLDEN_CFGS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jgoldens.GOLDEN_CFGS.items()}


def test_a_changed_golden_output_fails_the_check(tmp_path):
    import shutil

    src = goldens.golden_dir() / "unet"
    shutil.copytree(src, tmp_path / "unet")
    with np.load(src / "io.npz") as io:
        np.savez(tmp_path / "unet" / "io.npz", x=io["x"], y=io["y"] + 1e-4)
    with pytest.raises(AssertionError, match="deviation"):
        goldens.check("unet", indir=tmp_path, device="cpu")


def test_structural_diff_reports_as_the_jax_one():
    jcfg = ZOO_CFGS["unet"]
    params = _params(jcfg, 7)
    flat = jtfc._flatten(dict(params))
    first, second = sorted(flat)[:2]
    missing = weights_io.unflatten({k: v for k, v in flat.items() if k != first})
    bad_shape = weights_io.unflatten({**flat, second: np.zeros((1, 2, 3))})
    extra = weights_io.unflatten({**flat, "params/UNet_0/Extra/bias": np.zeros(3)})
    cases = [params, missing, bad_shape, extra, {"x": np.zeros((2,))}]
    for case in cases:
        assert tfc.structural_diff(case, params) == jtfc.structural_diff(case, params)
    assert tfc.structural_diff(params, params) == []
    assert tfc.structural_diff(missing, params) == [f"missing in import: {first} {flat[first].shape}"]
    assert len(tfc.structural_diff({"x": np.zeros((2,))}, params)) == len(flat) + 1


def test_verify_parity_reports_every_family_on_the_cpu(capsys):
    assert verify_parity.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == sorted(goldens.GOLDEN_CFGS)
    assert all(": OK (max deviation" in ln for ln in lines)


def test_verify_parity_imports_an_external_checkpoint(tmp_path, capsys):
    prefix = goldens.golden_dir() / "kpn" / "model.ckpt"
    assert verify_parity.main(["--device", "cpu", "--ckpt", str(prefix), "--family", "kpn"]) == 0
    assert "kpn: imported 21 variables" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        verify_parity.main(["--device", "cpu", "--ckpt", str(prefix)])
    with pytest.raises(tfc.UnmappedVariableError):  # a kpn checkpoint is no tiramisu
        verify_parity.main(["--device", "cpu", "--ckpt", str(prefix), "--family", "tiramisu"])


def test_verify_parity_reports_a_failing_family(tmp_path, monkeypatch, capsys):
    def fail(fam, device=None):
        if fam == "tiramisu":
            raise AssertionError("tiramisu: golden forward-output deviation")
        return 0.0

    monkeypatch.setattr(goldens, "check", fail)
    assert verify_parity.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "tiramisu: FAIL" in out and "unet: OK" in out


def test_the_recipe_models_cover_every_release_file():
    assert set(RELEASES.values()) <= set(pretrain_flagship.MODELS)


def test_goldens_and_verify_parity_run_on_the_card_or_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the checks run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        goldens.check("unet")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify_parity.main([])
