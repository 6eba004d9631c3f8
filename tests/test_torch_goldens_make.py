"""TF goldens made by the port (compat/goldens.make, verify_parity --make)
and read back by the JAX package, on the CPU.

The port initialises each family's tiny twin (seed 7), writes its TF
checkpoint with its own writer and forwards its own pinned input (numpy,
seed 11) in fp32. The JAX package's unchanged `goldens.check(fam,
indir=...)` reads those artifacts with its own reader and forwards them
with its own model: that holds the port's writer, name maps,
initialisation and forward against an independent implementation, at the
goldens' tolerance (ATOL, 2e-5).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from deepdenoiser_tpu.compat import goldens as jgoldens
from deepdenoiser_tpu_torch.compat import goldens
from deepdenoiser_tpu_torch.tools import verify_parity

FAMS = sorted(goldens.GOLDEN_CFGS)
FILES = ("model.ckpt.index", "model.ckpt.data-00000-of-00001", "io.npz")


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """The root of the port-made goldens, each family made once on first use."""
    root = tmp_path_factory.mktemp("made")

    def get(fam: str) -> Path:
        if not (root / fam / "io.npz").exists():
            goldens.make(fam, root / fam, device="cpu")
        return root

    return get


@pytest.mark.parametrize("fam", FAMS)
def test_the_jax_package_reads_the_goldens_the_port_made(made, fam):
    root = made(fam)
    with np.load(root / fam / "io.npz") as io:
        x, y = io["x"], io["y"]
    cfg = goldens.GOLDEN_CFGS[fam]
    assert x.dtype == y.dtype == np.float32
    assert x.shape == (1, goldens.SPATIAL, goldens.SPATIAL, cfg.in_channels)
    assert y.shape == (1, goldens.SPATIAL, goldens.SPATIAL, cfg.out_channels)
    assert np.isfinite(y).all() and np.abs(y).max() > 0
    assert jgoldens.check(fam, indir=root) <= jgoldens.ATOL == 2e-5


@pytest.mark.parametrize("fam", FAMS)
def test_the_port_reads_the_goldens_it_made(made, fam):
    assert goldens.check(fam, indir=made(fam), device="cpu") <= goldens.ATOL


@pytest.mark.parametrize("fam", FAMS)
def test_two_makes_write_the_same_bytes(tmp_path, fam):
    for d in ("a", "b"):
        goldens.make(fam, tmp_path / d / fam, device="cpu")
    for name in FILES:
        a, b = (tmp_path / d / fam / name for d in ("a", "b"))
        assert a.read_bytes() == b.read_bytes(), name


def test_verify_parity_make_writes_every_family(tmp_path, capsys):
    assert verify_parity.main(["--make", "--out", str(tmp_path), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == FAMS
    for fam in FAMS:
        assert sorted(p.name for p in (tmp_path / fam).iterdir()) == sorted(FILES)
    assert goldens.check("kpn", indir=tmp_path, device="cpu") <= goldens.ATOL


def _snapshot(root: Path) -> dict:
    return {p: (p.stat().st_size, p.stat().st_mtime_ns) for p in root.rglob("*")}


def test_verify_parity_make_refuses_the_committed_goldens(monkeypatch, capsys):
    committed = goldens.golden_dir().parent
    before = _snapshot(committed)
    monkeypatch.chdir(committed.parents[1])
    for out in ("tests/goldens/tf_compat", str(committed / "tf_compat" / "new")):
        with pytest.raises(SystemExit) as e:
            verify_parity.main(["--make", "--out", out, "--device", "cpu"])
        assert e.value.code == 2
        assert "never rewritten" in capsys.readouterr().err
    assert _snapshot(committed) == before


@pytest.mark.parametrize("argv,why", [
    (["--make", "--ckpt", "some/model.ckpt", "--family", "unet"], "takes no --ckpt"),
    (["--out", "somewhere", "--family", "unet"], "needs --make"),
])
def test_verify_parity_refuses_flags_it_would_ignore(tmp_path, monkeypatch, capsys, argv, why):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        verify_parity.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert why in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


def test_make_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        goldens.make("unet", tmp_path / "unet")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify_parity.main(["--make", "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())
