"""The port's TensorBundle reader and writer (compat/tensor_bundle.py, numpy
only) against TensorFlow's, on the four committed goldens, on bundles
TensorFlow writes and on bundles the port writes.

TensorFlow is imported here only as the reference; the port never
imports it. Every comparison is exact: arrays bit for bit, files byte for
byte, CRCs equal.
"""

import dataclasses
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import tensorflow as tf
import torch

from deepdenoiser_tpu.compat import tf_checkpoint as jtfc
from deepdenoiser_tpu.models import factory as jfactory
from deepdenoiser_tpu.models.factory import ModelConfig as JModelConfig
from deepdenoiser_tpu_torch import weights_io
from deepdenoiser_tpu_torch.compat import tensor_bundle as tb
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.models.factory import ModelConfig

REPO = Path(__file__).resolve().parents[1]
GOLDENS = REPO / "tests" / "goldens" / "tf_compat"
FAMILIES = ["kpn", "multiscale", "tiramisu", "unet"]
DATA = ".data-00000-of-00001"


def _tf_arrays(prefix):
    reader = tf.train.load_checkpoint(str(prefix))
    return {n: np.asarray(reader.get_tensor(n)) for n in reader.get_variable_to_shape_map()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


def _bitwise_crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for byte in data:
        c ^= byte
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
    return c ^ 0xFFFFFFFF


def _mixed_arrays(seed=0):
    """float32/float16/float64/int32/int64 tensors, a scalar step, an empty
    tensor and optimizer slots, as a training checkpoint holds them."""
    rng = np.random.default_rng(seed)
    return {
        "global_step": np.array(1234, np.int64),
        "unet/head/kernel": rng.standard_normal((1, 1, 8, 3)).astype(np.float32),
        "unet/head/kernel/Adam": rng.standard_normal((1, 1, 8, 3)).astype(np.float32),
        "unet/head/kernel/Adam_1": rng.random((1, 1, 8, 3)).astype(np.float32),
        "unet/head/bias": rng.standard_normal(3).astype(np.float32),
        "half": rng.standard_normal((5, 7)).astype(np.float16),
        "double": rng.standard_normal(4),
        "ints": rng.integers(-1000, 1000, (2, 3, 4), dtype=np.int32),
        "empty": np.zeros((0, 3), np.float32),
    }


def _tf_save(prefix, arrays):
    names = sorted(arrays)
    tf.raw_ops.SaveV2(prefix=str(prefix), tensor_names=names,
                      shape_and_slices=[""] * len(names),
                      tensors=[tf.constant(arrays[n]) for n in names])


# --------------------------------------------------------------------------
# CRC-32C
# --------------------------------------------------------------------------


@pytest.mark.parametrize("data,want", [
    (b"123456789", 0xE3069283),  # the check value of CRC-32C
    (b"", 0x00000000),
    (bytes(32), 0x8A9136AA),  # RFC 3720 B.4
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
    (bytes(range(31, -1, -1)), 0x113FDB5C),
])
def test_crc32c_known_vectors(data, want):
    assert tb.crc32c(data) == want


@pytest.mark.parametrize("n", [1, 3, 4, 5, 511, 1024, 1027, 4096 + 3, 70001])
def test_crc32c_equals_the_bitwise_definition_across_lane_splits(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tb.crc32c(data) == _bitwise_crc32c(data)


def test_mask_matches_tf_stored_crcs_and_inverts():
    """TF stores mask(crc32c(tensor bytes)) in each entry; the values come
    from TF's own files (the goldens), not from the unmasked vector."""
    for fam in FAMILIES:
        prefix = GOLDENS / fam / "model.ckpt"
        _, entries = tb.read_index(prefix)
        data = Path(f"{prefix}{DATA}").read_bytes()
        for name, e in entries.items():
            raw = data[e.offset:e.offset + e.size]
            assert e.crc32c == tb.mask(tb.crc32c(raw)), (fam, name)
            assert e.crc32c != tb.crc32c(raw)
    for v in (0, 1, 0xE3069283, 0xFFFFFFFF, 0xA282EAD8):
        assert tb.unmask(tb.mask(v)) == v
    assert tb.mask(0xE3069283) == ((((0xE3069283 >> 15) | (0xE3069283 << 17)) & 0xFFFFFFFF)
                                   + 0xA282EAD8) % 2**32


# --------------------------------------------------------------------------
# reading
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fam", FAMILIES)
def test_reader_returns_exactly_what_tf_reads_from_every_golden(fam):
    prefix = GOLDENS / fam / "model.ckpt"
    _assert_same(tb.read_bundle(prefix), _tf_arrays(prefix))


def test_golden_index_starts_with_a_bare_uncompressed_header():
    raw = (GOLDENS / "kpn" / "model.ckpt.index").read_bytes()
    assert raw[:9] == bytes.fromhex("00 00 06 08 01 1a 02 08 01")
    shards, entries = tb.read_index(GOLDENS / "kpn" / "model.ckpt")
    assert shards == 1 and entries["kpn/kernel_temp"].shape == (2,)


def test_reader_reads_what_tf_writes_bit_for_bit(tmp_path):
    arrays = _mixed_arrays()
    _tf_save(tmp_path / "tf", arrays)
    _assert_same(tb.read_bundle(tmp_path / "tf"), arrays)


def test_reader_reads_the_jax_packages_export_bit_for_bit(tmp_path):
    """export_checkpoint of the JAX package writes through TF's v1 Saver."""
    cfg = JModelConfig(backbone="unet", in_channels=8, out_channels=6, base_width=4, depth=2,
                       convs_per_level=1, kernel_prediction=True, kpn_size=3, kpn_slots=2,
                       kpn_logit_norm=True)
    model = factory.init_model(ModelConfig(**dataclasses.asdict(cfg)),
                               torch.Generator().manual_seed(3))
    params = weights_io.params_from_state_dict(model.state_dict())
    assert jtfc.structural_diff(params, jax.tree.map(  # the JAX package's tree
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: jfactory.init_params(cfg, jax.random.PRNGKey(0), 16)))) == []
    prefix = tmp_path / "model.ckpt"
    names = jtfc.export_checkpoint(params, cfg, prefix)
    got = tb.read_bundle(prefix)
    _assert_same(got, _tf_arrays(prefix))
    flat = jtfc._flatten(dict(params["params"]))
    assert sorted(got) == sorted(names)
    for path, arr in flat.items():
        assert got[jtfc.full_flax_path_to_tf_name(path, cfg)].tobytes() == \
            np.asarray(arr, np.float32).tobytes()


def _copy_golden(tmp_path, fam="unet"):
    for f in (GOLDENS / fam).glob("model.ckpt*"):
        shutil.copy(f, tmp_path / f.name)
    return tmp_path / "model.ckpt"


def test_a_flipped_data_byte_raises(tmp_path):
    prefix = _copy_golden(tmp_path)
    data = bytearray(Path(f"{prefix}{DATA}").read_bytes())
    data[len(data) // 2] ^= 0x10
    Path(f"{prefix}{DATA}").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="checksum"):
        tb.read_bundle(prefix)


def test_a_flipped_index_byte_raises(tmp_path):
    prefix = _copy_golden(tmp_path)
    index = bytearray(Path(f"{prefix}.index").read_bytes())
    index[20] ^= 0x01  # inside the first variable's key
    Path(f"{prefix}.index").write_bytes(bytes(index))
    with pytest.raises(ValueError, match="checksum"):
        tb.read_bundle(prefix)


def test_a_compressed_block_type_raises(tmp_path):
    """The type byte follows the data block (its handle is in the index
    block); 1 is Snappy. The reader refuses it rather than guess."""
    prefix = _copy_golden(tmp_path)
    index = bytearray(Path(f"{prefix}.index").read_bytes())
    foot = bytes(index[-48:])
    (_, _), pos = tb._read_handle(foot, 0)
    (ioff, isize), _ = tb._read_handle(foot, pos)
    _, handle = next(tb._block_entries(bytes(index[ioff:ioff + isize])))
    (off, size), _ = tb._read_handle(handle, 0)
    assert index[off + size] == 0
    index[off + size] = 1
    Path(f"{prefix}.index").write_bytes(bytes(index))
    with pytest.raises(ValueError, match="compressed block"):
        tb.read_bundle(prefix)


def test_a_file_that_is_no_bundle_raises(tmp_path):
    Path(f"{tmp_path / 'x'}.index").write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="magic"):
        tb.read_bundle(tmp_path / "x")


# --------------------------------------------------------------------------
# writing
# --------------------------------------------------------------------------


def test_written_bundle_reads_in_tf_with_identical_arrays(tmp_path):
    arrays = _mixed_arrays(1)
    tb.write_bundle(tmp_path / "port", arrays)
    _assert_same(_tf_arrays(tmp_path / "port"), arrays)  # TF checks every CRC as it reads


def test_written_bundle_is_tfs_byte_for_byte_and_its_crcs_are_tfs(tmp_path):
    arrays = _mixed_arrays(2)
    tb.write_bundle(tmp_path / "port", arrays)
    _tf_save(tmp_path / "tf", arrays)
    for suffix in (".index", DATA):
        assert Path(f"{tmp_path / 'port'}{suffix}").read_bytes() == \
            Path(f"{tmp_path / 'tf'}{suffix}").read_bytes(), suffix
    _, ours = tb.read_index(tmp_path / "port")
    _, theirs = tb.read_index(tmp_path / "tf")
    assert {n: e.crc32c for n, e in ours.items()} == {n: e.crc32c for n, e in theirs.items()}
    assert ours == theirs


def test_an_index_of_several_blocks_is_tfs_byte_for_byte(tmp_path):
    """1200 long names fill more than one 256 KiB data block, so the index
    block holds shortest-separator keys."""
    arrays = {f"scope_{i:05d}/" + "x" * 240: np.full((2,), i, np.float32) for i in range(1200)}
    tb.write_bundle(tmp_path / "port", arrays)
    _tf_save(tmp_path / "tf", arrays)
    port_index = Path(f"{tmp_path / 'port'}.index").read_bytes()
    assert port_index == Path(f"{tmp_path / 'tf'}.index").read_bytes()
    assert len(port_index) > 262144
    _assert_same(tb.read_bundle(tmp_path / "port"), arrays)
    assert len(_tf_arrays(tmp_path / "port")) == 1200


@pytest.mark.parametrize("fam", FAMILIES)
def test_rewriting_a_golden_reproduces_its_files(tmp_path, fam):
    prefix = GOLDENS / fam / "model.ckpt"
    n = tb.write_bundle(tmp_path / "model.ckpt", tb.read_bundle(prefix))
    total = 0
    for suffix in (".index", DATA):
        mine = Path(f"{tmp_path / 'model.ckpt'}{suffix}").read_bytes()
        assert mine == Path(f"{prefix}{suffix}").read_bytes(), suffix
        total += len(mine)
    assert n == total


def test_writer_refuses_a_dtype_tf_has_no_number_for(tmp_path):
    with pytest.raises(ValueError, match="no TF dtype"):
        tb.write_bundle(tmp_path / "x", {"c": np.zeros(2, np.complex64)})
