"""The port's holdout families (deepdenoiser_tpu_torch/data/synthetic_holdout,
synthetic_spheres, synthetic_boxes): numpy copies of the JAX package's,
bit-equal to them (numpy's RNG, the same operations), and twins of
tests/test_holdout.py on the port, the pipeline test through the port's
joint pipeline on parameters carried across from the JAX initialisation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu.config import InferenceConfig as JInferenceConfig
from deepdenoiser_tpu.data import synthetic_boxes as jboxes
from deepdenoiser_tpu.data import synthetic_holdout as jholdout
from deepdenoiser_tpu.data import synthetic_spheres as jspheres
from deepdenoiser_tpu.inference import pipeline as jpipeline
from deepdenoiser_tpu.models import factory as jfactory
from deepdenoiser_tpu_torch import passes, transforms
from deepdenoiser_tpu_torch.config import InferenceConfig
from deepdenoiser_tpu_torch.data import synthetic, synthetic_boxes, synthetic_holdout, synthetic_spheres
from deepdenoiser_tpu_torch.inference import pipeline
from deepdenoiser_tpu_torch.models import factory
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

FAMILIES = {
    "voronoi": (jholdout, synthetic_holdout),
    "spheres": (jspheres, synthetic_spheres),
    "boxes": (jboxes, synthetic_boxes),
}


@pytest.mark.parametrize("h,w,seed", [(40, 56, 3), (33, 47, 0), (96, 128, 11)])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_clean_passes_are_bit_equal_to_jax(family, h, w, seed):
    ref_mod, mod = FAMILIES[family]
    ref = ref_mod.generate_clean_passes(h, w, seed=seed)
    got = mod.generate_clean_passes(h, w, seed=seed)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got[k].dtype == ref[k].dtype, k


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_frame_sets_are_bit_equal_to_jax(family):
    ref_mod, mod = FAMILIES[family]
    ref_clean, ref_noisy = ref_mod.generate_frame_set(24, 32, seed=2, spps=(4, 16), n_seeds=2)
    clean, noisy = mod.generate_frame_set(24, 32, seed=2, spps=(4, 16), n_seeds=2)
    assert len(noisy) == len(ref_noisy) == 4
    for got, ref in [(clean, ref_clean), *zip(noisy, ref_noisy)]:
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# --- twins of tests/test_holdout.py ------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_recomposition_identity(family):
    clean = FAMILIES[family][1].generate_clean_passes(40, 56, seed=3)
    np.testing.assert_allclose(synthetic.recompose_np(clean), clean["combined"], rtol=1e-5,
                               atol=1e-6)
    noisy = synthetic.add_mc_noise(clean, spp=4, seed=1)
    np.testing.assert_allclose(synthetic.recompose_np(noisy), noisy["combined"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("family,h,w", [("voronoi", 32, 32), ("spheres", 32, 48),
                                        ("boxes", 32, 48)])
def test_pass_contract(family, h, w):
    clean = FAMILIES[family][1].generate_clean_passes(h, w, seed=7)
    assert set(clean) == set(passes.ALL_PASSES)
    for name, arr in clean.items():
        assert arr.shape == (h, w, passes.channels(name)), name
        assert arr.dtype == np.float32, name
        assert np.isfinite(arr).all(), name
    np.testing.assert_allclose(np.linalg.norm(clean["normal"], axis=-1), 1.0, atol=1e-4)
    assert clean["depth"].min() > 0.0
    assert 0.0 <= clean["alpha"].min() and clean["alpha"].max() <= 1.0


def test_holdout_is_piecewise_constant_albedo():
    hold = synthetic_holdout.generate_clean_passes(64, 64, seed=11)
    train = synthetic.generate_clean_passes(64, 64, seed=11)

    def grad_mag(a):
        return np.abs(np.diff(a, axis=0)).mean(-1)

    assert (grad_mag(hold["diffuse_color"]) < 1e-6).mean() > 0.8
    assert (grad_mag(train["diffuse_color"]) < 1e-6).mean() < 0.2


def test_spheres_structurally_distinct():
    clean = synthetic_spheres.generate_clean_passes(64, 96, seed=5)
    assert 0.05 < clean["alpha"].mean() < 0.999
    g = np.abs(np.diff(clean["diffuse_color"], axis=1)).mean(-1)
    assert (g < 1e-6).mean() > 0.5
    assert (g > 0.05).mean() > 0.005


def test_boxes_structurally_distinct():
    clean = synthetic_boxes.generate_clean_passes(96, 128, seed=5)
    geo = clean["alpha"][..., 0] > 0
    gn = np.abs(np.diff(clean["normal"], axis=1)).sum(-1)
    assert (gn[geo[:, 1:] & geo[:, :-1]] < 1e-6).mean() > 0.9
    d = clean["diffuse_direct"].sum(-1)
    top = np.quantile(d[geo & (d > 0)], 0.99)
    r = d / max(top, 1e-6)
    sel = geo & (d > 0)
    assert ((r > 0.05) & (r < 0.95))[sel].mean() > 0.2


@pytest.mark.parametrize("family", ["spheres", "boxes"])
def test_frame_set_contract(family):
    clean, noisy = FAMILIES[family][1].generate_frame_set(24, 24, seed=1, spps=(4,), n_seeds=2)
    assert len(noisy) == 2
    for n in noisy:
        assert set(n) == set(clean)


def test_holdout_denoises_through_the_ports_pipeline():
    """tests/test_holdout.py's pipeline test on the port: a tiny joint UNet
    initialised by the JAX package, carried across; the port's frame is
    finite and equals the JAX pipeline's within 1e-4 x max|ref|."""
    clean = synthetic_holdout.generate_clean_passes(48, 64, seed=5)
    noisy = synthetic.add_mc_noise(clean, spp=4, seed=2)
    kw = dict(in_channels=transforms.joint_input_channels(),
              out_channels=transforms.joint_output_channels(),
              base_width=8, depth=1, convs_per_level=1)
    jcfg = jfactory.ModelConfig(**kw)
    params = jax.tree.map(np.array, jfactory.init_params(jcfg, jax.random.PRNGKey(0), spatial=32))
    den, _ = pipeline.make_joint_frame_denoiser(
        factory.ModelConfig(**kw), InferenceConfig(tile=0, compute_dtype="float32"), 48, 64,
        params, device="cpu")
    out = den(noisy)
    assert tuple(out["combined"].shape) == (48, 64, 3)
    assert torch.isfinite(out["combined"]).all()
    jden, _ = jpipeline.make_joint_frame_denoiser(
        jcfg, JInferenceConfig(tile=0, compute_dtype="float32"), 48, 64)
    want = np.asarray(jden(params, {k: jnp.asarray(v) for k, v in noisy.items()})["combined"])
    err = np.abs(out["combined"].numpy() - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err
