"""The port's data pipeline against the JAX package's: synthetic frame sets,
render roots and prepare-data (same examples, bit-equal arrays, corpus
statistics within 1e-6), the ddshard format read across packages, D4
augmentation, the on-device batch encoder and eval decoder (atol 1e-6),
derive_pass_scales, and the loader's iterator (deterministic, whole epochs,
resumable).

Grain's shuffle order is not reproduced (data/loader.py): the iterator is
held to the same set of examples per epoch, not to Grain's order.
"""

import hashlib
import json
import os
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepdenoiser_tpu import config as jconfig
from deepdenoiser_tpu.data import augment as jaugment
from deepdenoiser_tpu.data import loader as jloader
from deepdenoiser_tpu.data import prepare as jprepare
from deepdenoiser_tpu.data import shards as jshards
from deepdenoiser_tpu.data import synthetic as jsynthetic
from deepdenoiser_tpu_torch import config
from deepdenoiser_tpu_torch.data import augment, exr, loader, prepare, shards, synthetic

CROP = 16
DATA_KW = dict(crop=CROP, crops_per_frame=3, batch_size=4, validation_fraction=0.3, read_threads=1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A synthetic render root (port-written) and its shards written by
    both packages, joint mode; and the same with use_flags over a root
    whose frame0001 lacks the subsurface group."""
    root = tmp_path_factory.mktemp("corpus")
    renders = prepare.generate_synthetic_render_root(
        root / "renders", n_frames=4, height=40, width=36, spps=(4, 16), seed=3)
    out = {"renders": renders}
    for flags in (False, True):
        r = renders
        if flags:
            r = root / "renders_flags"
            shutil.copytree(renders, r)
            for p in (r / "frame0001").rglob("subsurface_*.exr"):
                p.unlink()
        kw = dict(DATA_KW, mode="joint", use_flags=flags)
        tag = "flags" if flags else "joint"
        out[tag] = (
            prepare.prepare_dataset(r, root / f"port_{tag}", config.DataConfig(**kw),
                                    examples_per_shard=5),
            jprepare.prepare_dataset(r, root / f"jax_{tag}", jconfig.DataConfig(**kw),
                                     examples_per_shard=5),
            root / f"port_{tag}", root / f"jax_{tag}",
        )
    return out


@pytest.mark.parametrize("seed,groups", [(0, None), (7, ("diffuse", "glossy"))])
def test_generate_frame_set_matches_jax(seed, groups):
    kw = dict(spps=(4, 16), n_seeds=2, **({"groups": groups} if groups else {}))
    clean, noisy = synthetic.generate_frame_set(24, 20, seed, **kw)
    jclean, jnoisy = jsynthetic.generate_frame_set(24, 20, seed, **kw)
    assert len(noisy) == len(jnoisy) == 4
    for got, want in [(clean, jclean), *zip(noisy, jnoisy)]:
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_synthetic_render_root_matches_jax(tmp_path, corpus):
    jroot = jprepare.generate_synthetic_render_root(
        tmp_path / "jax", n_frames=4, height=40, width=36, spps=(4, 16), seed=3)
    root = corpus["renders"]
    dirs = sorted(p.relative_to(root) for p in root.rglob("*") if p.is_dir())
    assert dirs == sorted(p.relative_to(jroot) for p in jroot.rglob("*") if p.is_dir())
    for d in dirs:
        if d.parent == d or not list((root / d).glob("*.exr")):
            continue
        got, want = exr.load_frame_dir(root / d), exr.load_frame_dir(jroot / d)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{d}/{k}")


def _stats_close(got, want):
    assert set(got) == set(want)
    for name, s in want.items():
        for key, v in s.items():
            assert got[name][key] == pytest.approx(v, rel=1e-6, abs=1e-6), (name, key)


@pytest.mark.parametrize("tag", ["joint", "flags"])
def test_prepare_dataset_matches_jax(corpus, tag):
    metas, jmetas, port_dir, jax_dir = corpus[tag]
    assert set(metas) == set(jmetas) == {"train", "validation"}
    for split in metas:
        m, j = metas[split], jmetas[split]
        assert (m.crop, m.source_passes, m.target_passes, m.shard_sizes, m.flags_dim) == (
            j.crop, j.source_passes, j.target_passes, j.shard_sizes, j.flags_dim)
        _stats_close(m.stats, j.stats)
        for i in range(len(m.shard_sizes)):
            name = f"shard-{i:05d}.npz"
            with np.load(port_dir / split / name) as a, np.load(jax_dir / split / name) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in b.files:
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert metas["train"].n_examples > 0 and metas["validation"].n_examples > 0
    if tag == "flags":
        assert metas["train"].flags_dim == 4


@pytest.mark.parametrize("tag", ["joint", "flags"])
def test_shards_are_read_across_packages(corpus, tag):
    _, _, port_dir, jax_dir = corpus[tag]
    for reader_cls, other in ((shards.ShardReader, jax_dir), (jshards.ShardReader, port_dir)):
        r = reader_cls(other / "train")
        same = (jshards.ShardReader if reader_cls is shards.ShardReader else shards.ShardReader)(
            (port_dir if other == jax_dir else jax_dir) / "train")
        assert len(r) == len(same) > 5  # more than one shard of 5
        for i in (0, 4, 5, len(r) - 1):
            a, b = r[i], same[i]
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert shards.ShardMeta.from_json((jax_dir / "train" / "meta.json").read_text()).n_examples == len(r)


def test_shard_meta_json_round_trips_across_packages(corpus):
    _, _, port_dir, _ = corpus["flags"]
    text = (port_dir / "train" / "meta.json").read_text()
    m, j = shards.ShardMeta.from_json(text), jshards.ShardMeta.from_json(text)
    assert json.loads(m.to_json()) == json.loads(j.to_json())
    with pytest.raises(ValueError, match="version"):
        shards.ShardMeta.from_json(json.dumps({**json.loads(text), "version": 2}))


@pytest.mark.parametrize("seed", range(6))
def test_augment_example_matches_jax(corpus, seed):
    _, _, port_dir, _ = corpus["flags"]
    ex = shards.ShardReader(port_dir / "train")[seed]
    got = augment.augment_example(ex, np.random.default_rng(seed))
    want = jaugment.augment_example(ex, np.random.default_rng(seed))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert augment.d4_params(np.random.default_rng(seed)) == jaugment.d4_params(
        np.random.default_rng(seed))


def _raw(port_dir, n=4, split="train"):
    r = shards.ShardReader(port_dir / split)
    rows = [r[i] for i in range(n)]
    return {k: np.stack([row[k] for row in rows]) for k in rows[0]}


ENCODE_CASES = {
    "joint": dict(mode="joint"),
    "group": dict(mode="group", group="glossy"),
    "rgb": dict(mode="rgb"),
    "joint-scaled": dict(mode="joint", pass_scales=(("depth", 0.2), ("radiance", 1.7))),
    "flags": dict(mode="joint", use_flags=True),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_batch_encoder_and_eval_decoder_match_jax(corpus, case):
    kw = ENCODE_CASES[case]
    raw = _raw(corpus["flags" if case == "flags" else "joint"][2])
    encode = loader.make_batch_encoder(config.DataConfig(**kw))
    jencode = jloader.make_batch_encoder(jconfig.DataConfig(**kw))
    got = encode({k: torch.from_numpy(v) for k, v in raw.items()})
    want = jencode({k: jnp.asarray(v) for k, v in raw.items()})
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert got["x"].shape[-1] == config.input_channels(config.DataConfig(**kw))
    if case == "flags":
        assert got["mask"].shape == (4, 1, 1, 24)
    pred = np.random.default_rng(1).random(want["y"].shape).astype(np.float32)
    dec = loader.make_eval_decoder(config.DataConfig(**kw))(
        {k: torch.from_numpy(v) for k, v in raw.items()}, torch.from_numpy(pred))
    jdec = jloader.make_eval_decoder(jconfig.DataConfig(**kw))(
        {k: jnp.asarray(v) for k, v in raw.items()}, jnp.asarray(pred))
    for g, w in zip(dec, jdec):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown data mode"):
        loader.make_batch_encoder(config.DataConfig(mode="volume"))
    with pytest.raises(ValueError, match="unknown data mode"):
        loader.make_eval_decoder(config.DataConfig(mode="volume"))


def test_derive_pass_scales_matches_jax(corpus):
    metas, jmetas, _, _ = corpus["joint"]
    got = loader.derive_pass_scales(metas["train"])
    want = jloader.derive_pass_scales(jmetas["train"])
    assert [k for k, _ in got] == [k for k, _ in want] == ["depth", "radiance"]
    for (_, a), (_, b) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-6)
    empty = shards.ShardMeta(crop=4, source_passes=[], target_passes=[], shard_sizes=[], stats={})
    assert loader.derive_pass_scales(empty) == ()


def _key(batch, i):
    """An example's identity: a hash of its noisy combined crop's sorted
    values, which D4 permutes but does not change (the clean crop is the
    same for every noisy variant)."""
    v = np.sort(batch["source/combined"][i].numpy().ravel())
    return hashlib.sha1(v.tobytes()).hexdigest()


def test_iterator_is_deterministic_and_covers_each_epoch(corpus):
    _, _, port_dir, _ = corpus["joint"]
    cfg = config.DataConfig(mode="joint", **dict(DATA_KW, read_threads=2))
    n = shards.ShardReader(port_dir / "train").meta.n_examples
    per_epoch = n // cfg.batch_size
    assert per_epoch >= 2
    runs = []
    for workers in (1, 2):
        it = loader.make_iterator(port_dir / "train", config.DataConfig(
            mode="joint", **dict(DATA_KW, read_threads=workers)))
        runs.append([next(it) for _ in range(2 * per_epoch + 1)])
        assert it.get_state() == {"epoch": 2, "position": 1}
        it.close()
    for a, b in zip(*runs):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    src = loader.make_dataset(port_dir / "train", cfg, training=False)
    every = {_key(b, i) for b in loader.iterate_epoch(src) for i in range(cfg.batch_size)}
    tail = shards.ShardReader(port_dir / "train")
    for i in range(per_epoch * cfg.batch_size, n):  # rows past the last whole batch
        every.add(hashlib.sha1(np.sort(tail[i]["source/combined"].ravel()).tobytes()).hexdigest())
    for epoch in range(2):
        seen = [_key(b, i) for b in runs[0][epoch * per_epoch : (epoch + 1) * per_epoch]
                for i in range(cfg.batch_size)]
        assert len(set(seen)) == len(seen) == per_epoch * cfg.batch_size
        assert set(seen) <= every
    assert [_key(runs[0][0], i) for i in range(4)] != [_key(runs[0][per_epoch], i) for i in range(4)]


def test_iterator_resumes_from_its_state(corpus):
    _, _, port_dir, _ = corpus["joint"]
    cfg = config.DataConfig(mode="joint", **DATA_KW)
    it = loader.make_iterator(port_dir / "train", cfg)
    seq = [next(it) for _ in range(5)]
    it.close()
    resumed = loader.make_iterator(port_dir / "train", cfg)
    resumed.set_state(json.loads(json.dumps({"epoch": 0, "position": 3})))
    for want in seq[3:]:
        got = next(resumed)
        assert all(torch.equal(got[k], want[k]) for k in want)
    resumed.close()


def _loader_threads():
    return [t for t in threading.enumerate() if t.name.startswith("loader")]


def test_iterator_threads_start_on_next_and_stop_on_close(corpus):
    _, _, port_dir, _ = corpus["joint"]
    it = loader.make_iterator(port_dir / "train", config.DataConfig(
        mode="joint", **dict(DATA_KW, read_threads=0)))
    assert it.threads == min(4, len(os.sched_getaffinity(0)))
    assert not _loader_threads()
    first = next(it)
    assert 1 <= len(_loader_threads()) <= it.threads
    it.set_state({"epoch": 0, "position": 0})  # stops the threads, drops what was built ahead
    assert not _loader_threads()
    again = next(it)
    assert all(torch.equal(first[k], again[k]) for k in first)
    it.close()
    assert not _loader_threads()


def test_eval_source_is_in_order_and_unaugmented(corpus):
    _, _, port_dir, _ = corpus["joint"]
    cfg = config.DataConfig(mode="joint", **DATA_KW)
    src = loader.make_dataset(port_dir / "validation", cfg, training=False)
    reader = shards.ShardReader(port_dir / "validation")
    b = next(loader.iterate_epoch(src))
    for i in range(cfg.batch_size):
        np.testing.assert_array_equal(b["target/combined"][i].numpy(), reader[i]["target/combined"])
    assert b["source/diffuse_color"].dtype == torch.float16


def test_too_few_examples_for_a_batch_raise(corpus):
    _, _, port_dir, _ = corpus["joint"]
    cfg = config.DataConfig(mode="joint", **dict(DATA_KW, batch_size=10_000))
    with pytest.raises(ValueError, match="no batch"):
        loader.make_iterator(port_dir / "train", cfg)
    assert loader.make_dataset(port_dir / "train", cfg).batches_per_epoch == 0
