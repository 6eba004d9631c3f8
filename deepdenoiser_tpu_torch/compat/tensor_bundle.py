"""TensorFlow's name-based checkpoint format (TensorBundle), read and written
with numpy alone.

A checkpoint with prefix P is two files:

    P.index                    a LevelDB-format table (SSTable): the key ""
                               holds a BundleHeaderProto, every other key is
                               a variable name holding a BundleEntryProto
    P.data-00000-of-00001      the tensors' bytes, little-endian, one after
                               another

The table is a run of blocks, then a 48-byte footer: the metaindex and
index block handles (varint offset and size), zero padding to 40 bytes, and
the magic 0xdb4775248b80fb57. A block holds prefix-compressed entries
(varint shared, unshared and value lengths, the key's unshared bytes, the
value), a restart array of fixed32 offsets and its fixed32 count; it is
followed by a 5-byte trailer, the compression type and the masked CRC-32C
of the block and the type byte. The index block maps a key at or past each
data block's last key to that block's handle.

The few protobuf fields the format uses are decoded and encoded by hand:
BundleHeaderProto num_shards (1), endianness (2), version (3);
BundleEntryProto dtype (1), shape (2), shard_id (3), offset (4), size (5),
crc32c (6, fixed32, masked), slices (7). Entries with slices (partitioned
variables), big-endian bundles and compressed blocks are refused, never
guessed at.

CRC-32C (Castagnoli; `zlib.crc32` is the IEEE polynomial) is computed by
slicing-by-4 tables over many lanes at once: the bytes are cut into equal
chunks, numpy runs every chunk's CRC side by side, and the chunks' CRCs are
folded together by the shift rule crc(A || B) = Z^|B| crc(A) xor crc(B),
where Z^n is the GF(2) operator of n zero bytes. A tensor of tens of
megabytes takes a fraction of a second.

The writer lays a bundle out as TensorFlow's BundleWriter and table builder
do (entries sorted by name, data in the same order, 16-entry restarts, 256
KiB data blocks, the shortest separator keys in the index), so TensorFlow
reads what it writes and its CRCs equal TensorFlow's.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Mapping, Tuple, Union

import numpy as np

PathLike = Union[str, Path]

# ---------------------------------------------------------------------------
# CRC-32C
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78  # Castagnoli, reflected
_MASK_DELTA = 0xA282EAD8
_U32 = 0xFFFFFFFF


def _make_tables() -> np.ndarray:
    t0 = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t0 = np.where(t0 & 1, (t0 >> 1) ^ np.uint32(_POLY), t0 >> 1).astype(np.uint32)
    tables = [t0]
    for _ in range(3):
        prev = tables[-1]
        tables.append((prev >> 8) ^ t0[prev & 0xFF])
    return np.stack(tables)


_TABLES = _make_tables()  # slicing-by-4: _TABLES[k][i] = i's byte shifted k bytes on


def _op_apply(cols: List[int], v: int) -> int:
    """A GF(2) operator (its 32 columns) applied to one 32-bit vector."""
    out = 0
    b = 0
    while v:
        if v & 1:
            out ^= cols[b]
        v >>= 1
        b += 1
    return out


def _op_mul(a: List[int], b: List[int]) -> List[int]:
    return [_op_apply(a, c) for c in b]


def _zero_bytes_op(n: int) -> List[int]:
    """The operator of feeding n zero bytes to the CRC register."""
    t0 = _TABLES[0]
    base = [int(t0[(1 << b) & 0xFF]) ^ ((1 << b) >> 8) for b in range(32)]
    out = [1 << b for b in range(32)]
    while n:
        if n & 1:
            out = _op_mul(base, out)
        n >>= 1
        if n:
            base = _op_mul(base, base)
    return out


def _op_tables(cols: List[int]) -> np.ndarray:
    """Byte tables of an operator: op(v) = xor over k of tab[k][byte k of v]."""
    idx = np.arange(256, dtype=np.uint32)
    tabs = np.zeros((4, 256), dtype=np.uint32)
    for k in range(4):
        for b in range(8):
            tabs[k] ^= np.where((idx >> b) & 1, np.uint32(cols[8 * k + b]), np.uint32(0))
    return tabs


def _lanes(n_bytes: int) -> int:
    """Chunks run side by side: a power of two, at least 512 bytes each."""
    lanes = 1
    while lanes < 1 << 15 and lanes * 2 * 512 <= n_bytes:
        lanes *= 2
    return lanes


def crc32c(data) -> int:
    """CRC-32C of `data` (bytes, bytearray, memoryview or a numpy array's
    raw bytes), unmasked: crc32c(b"123456789") == 0xE3069283."""
    buf = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    n = buf.size
    lanes = _lanes(n)
    words = -(-n // (4 * lanes))  # 32-bit words a lane
    # zeros in front leave a register that starts at 0 at 0, so each chunk's
    # register (from 0) is that of its bytes alone
    padded = np.zeros(lanes * words * 4, dtype=np.uint8)
    padded[padded.size - n:] = buf
    cols = np.ascontiguousarray(padded.view("<u4").reshape(lanes, words).T)
    t0, t1, t2, t3 = _TABLES
    s = np.zeros(lanes, dtype=np.uint32)
    for j in range(words):
        s ^= cols[j]
        s = t3[s & 0xFF] ^ t2[(s >> 8) & 0xFF] ^ t1[(s >> 16) & 0xFF] ^ t0[s >> 24]
    # fold neighbouring chunks: left shifted past the right chunk's bytes
    op = _zero_bytes_op(4 * words)
    while s.size > 1:
        tabs = _op_tables(op)
        left = s[0::2]
        s = (tabs[0][left & 0xFF] ^ tabs[1][(left >> 8) & 0xFF] ^ tabs[2][(left >> 16) & 0xFF]
             ^ tabs[3][left >> 24] ^ s[1::2])
        op = _op_mul(op, op)
    # the register starts at ~0, not 0: add ~0 shifted past all n bytes
    reg = _op_apply(_zero_bytes_op(n), _U32) ^ int(s[0])
    return reg ^ _U32


def mask(crc: int) -> int:
    """The masked form TF and LevelDB store (a CRC of data holding CRCs
    must not be the CRC of the CRC)."""
    return ((((crc >> 15) | (crc << 17)) & _U32) + _MASK_DELTA) & _U32


def unmask(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & _U32
    return ((rot >> 17) | (rot << 15)) & _U32


# ---------------------------------------------------------------------------
# varints and the protobuf wire format
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    if v < 0:
        v &= (1 << 64) - 1  # int64 as protobuf encodes it
    out = bytearray()
    while True:
        byte = v & 0x7F
        v >>= 7
        if v:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        byte = buf[pos]
        pos += 1
        v |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return v, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint longer than 10 bytes")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """(field number, wire type, value) of a serialized message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            val, pos = bytes(buf[pos:pos + length]), pos + length
            if pos > len(buf):
                raise ValueError("truncated length-delimited field")
        elif wire == 5:
            val, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _int64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


# ---------------------------------------------------------------------------
# bundle entries
# ---------------------------------------------------------------------------

# TF DataType enum -> numpy dtype (little-endian)
DTYPES: Dict[int, np.dtype] = {
    1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"), 4: np.dtype("u1"),
    5: np.dtype("<i2"), 6: np.dtype("i1"), 9: np.dtype("<i8"), 10: np.dtype("?"),
    17: np.dtype("<u2"), 19: np.dtype("<f2"), 22: np.dtype("<u4"), 23: np.dtype("<u8"),
}
_ENUMS = {dt.str.lstrip("<|"): enum for enum, dt in DTYPES.items()}


@dataclasses.dataclass(frozen=True)
class Entry:
    """One variable's BundleEntryProto; `crc32c` is the stored (masked) value."""

    dtype: int
    shape: Tuple[int, ...]
    shard_id: int = 0
    offset: int = 0
    size: int = 0
    crc32c: int = 0

    def encode(self) -> bytes:
        dims = b"".join(_len_field(2, _varint(1 << 3) + _varint(d) if d else b"")
                        for d in self.shape)
        out = _varint(1 << 3) + _varint(self.dtype) + _len_field(2, dims)
        for field, v in ((3, self.shard_id), (4, self.offset), (5, self.size)):
            if v:
                out += _varint(field << 3) + _varint(v)
        if self.crc32c:
            out += _varint(6 << 3 | 5) + struct.pack("<I", self.crc32c)
        return out

    @classmethod
    def decode(cls, name: str, buf: bytes) -> "Entry":
        kw: Dict[str, object] = {"dtype": 0, "shape": ()}
        for field, _, val in _fields(buf):
            if field == 1:
                kw["dtype"] = val
            elif field == 2:
                kw["shape"] = _decode_shape(name, val)
            elif field in (3, 4, 5):
                kw[("shard_id", "offset", "size")[field - 3]] = val
            elif field == 6:
                kw["crc32c"] = val
            elif field == 7:
                raise ValueError(f"{name!r}: partitioned variable (slices) not supported")
        return cls(**kw)


def _decode_shape(name: str, buf: bytes) -> Tuple[int, ...]:
    dims: List[int] = []
    for field, _, val in _fields(buf):
        if field == 2:
            size = 0
            for f, _, v in _fields(val):
                if f == 1:
                    size = _int64(v)
            if size < 0:
                raise ValueError(f"{name!r}: unknown dimension in shape")
            dims.append(size)
        elif field == 3 and val:
            raise ValueError(f"{name!r}: shape of unknown rank")
    return tuple(dims)


_HEADER = _varint(1 << 3) + _varint(1) + _len_field(3, _varint(1 << 3) + _varint(1))
# num_shards 1, endianness LITTLE (the default, not written), version {producer 1}


def _decode_header(buf: bytes) -> int:
    """The number of data shards; a big-endian bundle raises."""
    shards = 1
    for field, _, val in _fields(buf):
        if field == 1:
            shards = val
        elif field == 2 and val != 0:
            raise ValueError("big-endian bundle not supported")
    return shards


# ---------------------------------------------------------------------------
# the LevelDB table
# ---------------------------------------------------------------------------

_MAGIC = 0xDB4775248B80FB57
_FOOTER = 48
_TRAILER = 5
_BLOCK_SIZE = 262144  # TF's table::Options
_RESTART_INTERVAL = 16


def _read_handle(buf: bytes, pos: int) -> Tuple[Tuple[int, int], int]:
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return (offset, size), pos


def _read_block(table: bytes, handle: Tuple[int, int], what: str) -> bytes:
    offset, size = handle
    if offset + size + _TRAILER > len(table):
        raise ValueError(f"{what}: block at {offset}+{size} past the end of the index")
    block = table[offset:offset + size]
    kind = table[offset + size]
    if kind != 0:
        raise ValueError(f"{what}: compressed block (type {kind}) not supported")
    stored = struct.unpack_from("<I", table, offset + size + 1)[0]
    if unmask(stored) != crc32c(table[offset:offset + size + 1]):
        raise ValueError(f"{what}: block checksum mismatch at offset {offset}")
    return block


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * n_restarts
    if end < 0:
        raise ValueError("corrupt block: restart array larger than the block")
    pos, key = 0, b""
    while pos < end:
        shared, pos = _read_varint(block, pos)
        unshared, pos = _read_varint(block, pos)
        vlen, pos = _read_varint(block, pos)
        if shared > len(key) or pos + unshared + vlen > end:
            raise ValueError("corrupt block entry")
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        yield key, block[pos:pos + vlen]
        pos += vlen


def _read_table(table: bytes, what: str) -> Dict[bytes, bytes]:
    if len(table) < _FOOTER:
        raise ValueError(f"{what}: shorter than a table footer")
    foot = table[-_FOOTER:]
    if struct.unpack_from("<Q", foot, 40)[0] != _MAGIC:
        raise ValueError(f"{what}: not a TensorBundle index (bad table magic)")
    _, pos = _read_handle(foot, 0)  # the metaindex block: nothing the bundle uses
    index_handle, _ = _read_handle(foot, pos)
    out: Dict[bytes, bytes] = {}
    for _, handle_bytes in _block_entries(_read_block(table, index_handle, what)):
        handle, _ = _read_handle(handle_bytes, 0)
        for key, value in _block_entries(_read_block(table, handle, what)):
            out[key] = value
    return out


class _BlockBuilder:
    def __init__(self, restart_interval: int):
        self.interval = restart_interval
        self.buf = bytearray()
        self.restarts = [0]
        self.count = 0
        self.last = b""

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self.count < self.interval:
            while shared < min(len(key), len(self.last)) and key[shared] == self.last[shared]:
                shared += 1
        else:
            self.restarts.append(len(self.buf))
            self.count = 0
        self.buf += _varint(shared) + _varint(len(key) - shared) + _varint(len(value))
        self.buf += key[shared:] + value
        self.last = key
        self.count += 1

    def size(self) -> int:
        return len(self.buf) + 4 * len(self.restarts) + 4

    def empty(self) -> bool:
        return not self.buf

    def finish(self) -> bytes:
        return bytes(self.buf) + b"".join(struct.pack("<I", r) for r in self.restarts) \
            + struct.pack("<I", len(self.restarts))


def _shortest_separator(start: bytes, limit: bytes) -> bytes:
    """LevelDB's bytewise FindShortestSeparator: a short key in [start, limit)."""
    n = min(len(start), len(limit))
    i = 0
    while i < n and start[i] == limit[i]:
        i += 1
    if i < n and start[i] < 0xFF and start[i] + 1 < limit[i]:
        return start[:i] + bytes([start[i] + 1])
    return start


def _short_successor(key: bytes) -> bytes:
    """LevelDB's bytewise FindShortSuccessor: a short key >= `key`."""
    for i, byte in enumerate(key):
        if byte != 0xFF:
            return key[:i] + bytes([byte + 1])
    return key


def _write_table(items: List[Tuple[bytes, bytes]]) -> bytes:
    out = bytearray()

    def emit(block: bytes) -> bytes:
        handle = _varint(len(out)) + _varint(len(block))
        trailer = b"\x00"
        out.extend(block + trailer + struct.pack("<I", mask(crc32c(block + trailer))))
        return handle

    index = _BlockBuilder(1)
    data = _BlockBuilder(_RESTART_INTERVAL)
    pending = None  # the handle of a flushed block, indexed at the next key
    last = b""
    for key, value in items:
        if pending is not None:
            index.add(_shortest_separator(last, key), pending)
            pending = None
        data.add(key, value)
        last = key
        if data.size() >= _BLOCK_SIZE:
            pending = emit(data.finish())
            data = _BlockBuilder(_RESTART_INTERVAL)
    if not data.empty():
        pending = emit(data.finish())
    meta = emit(_BlockBuilder(_RESTART_INTERVAL).finish())
    if pending is not None:
        index.add(_short_successor(last), pending)
    foot = meta + emit(index.finish())
    out += foot + b"\x00" * (40 - len(foot)) + struct.pack("<Q", _MAGIC)
    return bytes(out)


# ---------------------------------------------------------------------------
# bundles
# ---------------------------------------------------------------------------


def data_path(prefix: PathLike, shard: int = 0, num_shards: int = 1) -> Path:
    return Path(f"{prefix}.data-{shard:05d}-of-{num_shards:05d}")


def read_index(prefix: PathLike) -> Tuple[int, Dict[str, Entry]]:
    """(number of data shards, {variable name: Entry}) of the bundle with
    checkpoint prefix `prefix`."""
    index = Path(f"{prefix}.index")
    table = _read_table(index.read_bytes(), str(index))
    if b"" not in table:
        raise ValueError(f"{index}: no bundle header")
    shards = _decode_header(table.pop(b""))
    entries = {}
    for key, value in table.items():
        name = key.decode()
        entries[name] = Entry.decode(name, value)
    return shards, entries


def read_bundle(prefix: PathLike) -> Dict[str, np.ndarray]:
    """Every variable of the bundle with checkpoint prefix `prefix`
    (optimizer slots and global_step included) as numpy arrays in native
    byte order; each tensor's stored CRC-32C is checked, and a mismatch
    raises."""
    shards, entries = read_index(prefix)
    data = {s: data_path(prefix, s, shards).read_bytes()
            for s in sorted({e.shard_id for e in entries.values()})}
    out: Dict[str, np.ndarray] = {}
    for name, e in entries.items():
        if e.dtype not in DTYPES:
            raise ValueError(f"{name!r}: unsupported TF dtype enum {e.dtype}")
        dt = DTYPES[e.dtype]
        want = int(np.prod(e.shape, dtype=np.int64)) * dt.itemsize
        if e.size != want:
            raise ValueError(f"{name!r}: {e.size} bytes stored for shape {e.shape} of {dt}")
        raw = data[e.shard_id][e.offset:e.offset + e.size]
        if len(raw) != e.size:
            raise ValueError(f"{name!r}: data shard {e.shard_id} ends before its bytes")
        if crc32c(raw) != unmask(e.crc32c):
            raise ValueError(f"{name!r}: data checksum mismatch (corrupt checkpoint)")
        out[name] = np.frombuffer(raw, dtype=dt).reshape(e.shape).astype(dt.newbyteorder("="))
    return out


def write_bundle(prefix: PathLike, arrays: Mapping[str, np.ndarray]) -> int:
    """Write `arrays` as a one-shard bundle with checkpoint prefix `prefix`
    (variables in name order, as TF's BundleWriter lays them out). Returns
    the bytes written to the two files."""
    items: List[Tuple[bytes, bytes]] = [(b"", _HEADER)]
    offset = 0
    with open(data_path(prefix), "wb") as f:
        for name in sorted(arrays, key=lambda n: n.encode()):
            arr = np.asarray(arrays[name])
            kind = arr.dtype.str.lstrip("<>|=")
            if kind not in _ENUMS:
                raise ValueError(f"{name!r}: no TF dtype for {arr.dtype}")
            raw = np.ascontiguousarray(arr, dtype=DTYPES[_ENUMS[kind]]).tobytes()
            f.write(raw)
            entry = Entry(dtype=_ENUMS[kind], shape=tuple(int(d) for d in arr.shape),
                          offset=offset, size=len(raw), crc32c=mask(crc32c(raw)))
            items.append((name.encode(), entry.encode()))
            offset += len(raw)
    table = _write_table(items)
    Path(f"{prefix}.index").write_bytes(table)
    return offset + len(table)
