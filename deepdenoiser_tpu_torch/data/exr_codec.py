"""Self-contained OpenEXR scanline codec (pure numpy + stdlib zlib).

The PyTorch package's own copy of deepdenoiser_tpu/data/exr_codec.py (the
port imports nothing of the JAX package). The ZIP predictor runs in the
native host library of data/_native.py (csrc/exr_pack.cpp, built at first
use); the numpy versions (_zip_*_np) are its plain versions.
tests/test_torch_transforms.py holds the two codecs bit-equal, and
tests/test_torch_exr_native.py the native predictor to the numpy one.

The build environment ships no EXR-capable library (cv2 built without
OpenEXR, no OpenEXR/pyexr/imageio-exr backend), and the reference's data
contract is EXR in / EXR out (upstream: TensorFlow/OpenEXRDirectory.py —
SURVEY.md C5). So the framework carries its own codec.

Supported (covers everything Blender/Cycles emits for render passes):
  * single-part scanline images, EXR version 2
  * compression: NONE, ZIPS (1 line/block), ZIP (16 lines/block)
  * pixel types: HALF, FLOAT, UINT
  * increasing and decreasing line order, arbitrary data windows
  * multilayer channel names ("Layer.DiffDir.R") — exposed verbatim;
    layer grouping happens in exr.py

Write path emits ZIP-compressed FLOAT or HALF scanline files readable by
any OpenEXR implementation (validated against the format spec in
tests/test_exr_codec.py round-trips, including a fixed golden header).

Format notes (OpenEXR file layout, for the next reader of this file):
  magic int32 20000630, version int32 (=2 for plain scanline);
  header = repeated (name\\0 type\\0 size:int32 value) ending with \\0;
  then a uint64 offset table (one entry per scanline block);
  each block = y:int32, packed_size:int32, packed bytes.
  Packed layout per block: scanlines in order; within a scanline all
  channels in ALPHABETICAL channel-name order, each a contiguous row.
  ZIP/ZIPS packing = interleave-split bytes into two halves, byte-delta
  (+128+256 mod 256), then zlib deflate; stored raw if deflate grows it.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np

from deepdenoiser_tpu_torch.data import _native

MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PT_DTYPE = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}
_PT_SIZE = {_PT_UINT: 4, _PT_HALF: 2, _PT_FLOAT: 4}

COMPRESSION_NONE = 0
COMPRESSION_ZIPS = 1
COMPRESSION_ZIP = 3
_LINES_PER_BLOCK = {COMPRESSION_NONE: 1, COMPRESSION_ZIPS: 1, COMPRESSION_ZIP: 16}
# note: OpenEXR enum: 0=NO 1=RLE 2=ZIPS 3=ZIP 4=PIZ 5=PXR24 6=B44 7=B44A ...
_EXR_COMP_NO, _EXR_COMP_RLE, _EXR_COMP_ZIPS, _EXR_COMP_ZIP = 0, 1, 2, 3


@dataclass
class ChannelInfo:
    name: str
    pixel_type: int  # 0 UINT, 1 HALF, 2 FLOAT
    x_sampling: int = 1
    y_sampling: int = 1


def _read_null_str(buf: bytes, pos: int, maxlen: int = 256) -> Tuple[str, int]:
    try:
        end = buf.index(b"\x00", pos, pos + maxlen)
    except ValueError:
        raise ValueError(
            f"corrupt EXR: unterminated string at byte {pos}"
        ) from None
    return buf[pos:end].decode("utf-8", "replace"), end + 1


def _zip_unpredict_and_merge_np(data: bytes) -> bytes:
    # undo delta predictor: raw[0] = in[0]; raw[i] = raw[i-1] + in[i] - 128
    a = np.frombuffer(data, dtype=np.uint8).astype(np.int64)
    a[1:] -= 128
    raw = np.cumsum(a) % 256
    half = (len(data) + 1) // 2
    out = np.empty(len(data), dtype=np.uint8)
    out[0::2] = raw[:half].astype(np.uint8)
    out[1::2] = raw[half : half + len(data) // 2].astype(np.uint8)
    return out.tobytes()


def _zip_split_and_predict_np(data: bytes) -> bytes:
    src = np.frombuffer(data, dtype=np.uint8)
    half = (len(data) + 1) // 2
    tmp = np.empty(len(data), dtype=np.uint8)
    tmp[:half] = src[0::2]
    tmp[half:] = src[1::2]
    t = tmp.astype(np.int16)
    d = np.empty_like(t)
    d[0] = t[0]
    d[1:] = (t[1:] - t[:-1] + 128) % 256
    return d.astype(np.uint8).tobytes()


def _zip_unpredict_and_merge(data: bytes) -> bytes:
    """ZIP post-processing: one native pass (data/_native.py)."""
    return _native.unpredict_and_merge(data)


def _zip_split_and_predict(data: bytes) -> bytes:
    """ZIP preprocessing: one native pass (data/_native.py)."""
    return _native.split_and_predict(data)


def _decompress_block(data: bytes, expected: int, compression: int) -> bytes:
    if compression == _EXR_COMP_NO or len(data) == expected:
        # zlib writers store raw when deflate doesn't shrink
        if len(data) != expected:
            raise ValueError(f"bad uncompressed block size {len(data)} != {expected}")
        return data
    if compression in (_EXR_COMP_ZIP, _EXR_COMP_ZIPS):
        try:
            raw = zlib.decompress(data)
        except zlib.error as e:
            raise ValueError(f"corrupt EXR: zlib block failed ({e})") from None
        if len(raw) != expected:
            raise ValueError(
                f"corrupt EXR: block inflated to {len(raw)} != {expected}"
            )
        return _zip_unpredict_and_merge(raw)
    if compression == _EXR_COMP_RLE:
        return _rle_decompress(data, expected)
    raise NotImplementedError(f"EXR compression {compression} not supported")


def _rle_decompress(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        count = struct.unpack_from("b", data, i)[0]
        i += 1
        if count < 0:
            out += data[i : i - count]
            i += -count
        else:
            out += data[i : i + 1] * (count + 1)
            i += 1
    if len(out) != expected:
        raise ValueError("RLE length mismatch")
    return bytes(_zip_unpredict_and_merge(bytes(out)))


def _rle_compress(raw: bytes) -> bytes:
    """OpenEXR RLE: runs >= 3 as (runlen-1, byte); literals as (-n, bytes),
    both capped at 127. Applied AFTER the split+predict preprocessing."""
    data = _zip_split_and_predict(raw)
    out = bytearray()
    i, n = 0, len(data)
    lit_start = i
    def flush_literals(end):
        s = lit_start
        while s < end:
            chunk = min(127, end - s)
            out.append((256 - chunk) & 0xFF)  # signed -chunk
            out.extend(data[s : s + chunk])
            s += chunk
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            flush_literals(i)
            out.append(run - 1)
            out.append(data[i])
            i += run
            lit_start = i
        else:
            i += run
    flush_literals(i)
    return bytes(out)


class ExrImage:
    """Decoded single-part scanline EXR: channel name -> 2D array."""

    def __init__(
        self,
        channels: Dict[str, np.ndarray],
        attributes: Optional[Dict[str, object]] = None,
    ):
        self.channels = channels
        self.attributes = attributes or {}

    @property
    def height(self) -> int:
        return next(iter(self.channels.values())).shape[0]

    @property
    def width(self) -> int:
        return next(iter(self.channels.values())).shape[1]


def read(path: Union[str, Path]) -> ExrImage:
    data = Path(path).read_bytes()
    return decode(data)


def decode(data: bytes) -> ExrImage:
    if len(data) < 8 or struct.unpack_from("<i", data, 0)[0] != MAGIC:
        raise ValueError("not an EXR file (bad magic)")
    version = struct.unpack_from("<i", data, 4)[0]
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported (scanline only)")
    if version & 0x1000:
        raise NotImplementedError("multi-part EXR not supported")
    if version & 0x800:
        raise NotImplementedError("deep EXR not supported")

    pos = 8
    attrs: Dict[str, object] = {}
    channels: List[ChannelInfo] = []
    compression = _EXR_COMP_NO
    data_window = (0, 0, 0, 0)
    line_order = 0
    while True:
        if pos >= len(data):
            raise ValueError("corrupt EXR: truncated header")
        if data[pos] == 0:
            pos += 1
            break
        name, pos = _read_null_str(data, pos)
        atype, pos = _read_null_str(data, pos)
        if pos + 4 > len(data):
            raise ValueError("corrupt EXR: truncated attribute size")
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        if size < 0 or pos + size > len(data):
            raise ValueError(
                f"corrupt EXR: attribute {name!r} size {size} exceeds file"
            )
        val = data[pos : pos + size]
        pos += size
        if name == "channels" and atype == "chlist":
            cp = 0
            while cp < len(val) and val[cp] != 0:
                cname, cp = _read_null_str(val, cp)
                if cp + 16 > len(val):
                    raise ValueError("corrupt EXR: truncated channel entry")
                ptype, _plin, xs, ys = struct.unpack_from("<iB3xii", val, cp)
                cp += 16
                if ptype not in _PT_DTYPE:
                    raise ValueError(f"corrupt EXR: bad pixel type {ptype}")
                channels.append(ChannelInfo(cname, ptype, xs, ys))
            attrs["channels"] = channels
        elif name == "compression":
            if len(val) < 1:
                raise ValueError("corrupt EXR: empty compression attribute")
            compression = val[0]
            attrs["compression"] = compression
        elif name == "dataWindow" and atype == "box2i":
            if len(val) != 16:
                raise ValueError("corrupt EXR: dataWindow is not a box2i")
            data_window = struct.unpack("<4i", val)
            attrs["dataWindow"] = data_window
        elif name == "lineOrder":
            if len(val) < 1:
                raise ValueError("corrupt EXR: empty lineOrder attribute")
            line_order = val[0]
            attrs["lineOrder"] = line_order
        else:
            attrs[name] = (atype, val)

    if not channels:
        raise ValueError("EXR header missing channel list")
    x_min, y_min, x_max, y_max = data_window
    width, height = x_max - x_min + 1, y_max - y_min + 1
    if width <= 0 or height <= 0:
        raise ValueError(f"bad dataWindow {data_window}")
    # Overflow guard against fuzzed gigantic windows allocating silly
    # arrays. This must be an ABSOLUTE cap on decoded bytes, not a ratio
    # vs the compressed size: ZIP legitimately compresses constant data
    # >1000:1 (a flat 3840x2160 HALF pass is a ~37 KB file), so the former
    # 64:1 ratio guard rejected this codec's own round-trip of flat/black
    # passes (ADVICE r4 #1). Real bad windows still die here (a single
    # byte-flip in dataWindow inflates width/height past the cap) or at
    # the scanline offset-table bounds checks below.
    decoded_bytes = width * height * sum(_PT_SIZE[c.pixel_type] for c in channels)
    if decoded_bytes > (1 << 32):  # 4 GiB
        raise ValueError(
            f"corrupt EXR: dataWindow {width}x{height} x {len(channels)} "
            f"channels would decode to {decoded_bytes} bytes (cap 4 GiB)"
        )
    for c in channels:
        if c.x_sampling != 1 or c.y_sampling != 1:
            raise NotImplementedError("subsampled channels not supported")

    lines_per_block = 1 if compression in (_EXR_COMP_NO, _EXR_COMP_RLE, _EXR_COMP_ZIPS) else 16
    if compression == _EXR_COMP_ZIP:
        lines_per_block = 16
    if compression not in (_EXR_COMP_NO, _EXR_COMP_RLE, _EXR_COMP_ZIPS,
                           _EXR_COMP_ZIP):
        raise NotImplementedError(
            f"EXR compression {compression} not supported (NONE/RLE/ZIPS/ZIP)"
        )
    n_blocks = (height + lines_per_block - 1) // lines_per_block
    if pos + 8 * n_blocks > len(data):
        raise ValueError("corrupt EXR: truncated scanline offset table")
    offsets = struct.unpack_from(f"<{n_blocks}Q", data, pos)

    # channels are stored per scanline in alphabetical order
    sorted_ch = sorted(channels, key=lambda c: c.name)
    row_bytes = sum(width * _PT_SIZE[c.pixel_type] for c in sorted_ch)
    out = {
        c.name: np.empty((height, width), dtype=_PT_DTYPE[c.pixel_type])
        for c in channels
    }

    for off in offsets:
        if off + 8 > len(data):
            raise ValueError(f"corrupt EXR: scanline offset {off} exceeds file")
        y, packed_size = struct.unpack_from("<ii", data, off)
        if packed_size < 0 or off + 8 + packed_size > len(data):
            raise ValueError(
                f"corrupt EXR: scanline block size {packed_size} exceeds file"
            )
        block = data[off + 8 : off + 8 + packed_size]
        row0 = y - y_min
        if not (0 <= row0 < height):
            raise ValueError(f"corrupt EXR: scanline y {y} outside dataWindow")
        n_lines = min(lines_per_block, height - row0)
        raw = _decompress_block(block, row_bytes * n_lines, compression)
        rpos = 0
        for li in range(n_lines):
            r = row0 + li
            for c in sorted_ch:
                nbytes = width * _PT_SIZE[c.pixel_type]
                out[c.name][r] = np.frombuffer(
                    raw, dtype=_PT_DTYPE[c.pixel_type], count=width, offset=rpos
                )
                rpos += nbytes

    return ExrImage({k: v for k, v in out.items()}, attrs)


def _attr(name: str, atype: str, value: bytes) -> bytes:
    return (
        name.encode() + b"\x00" + atype.encode() + b"\x00"
        + struct.pack("<i", len(value)) + value
    )


def encode(
    channels: Mapping[str, np.ndarray],
    pixel_type: str = "float",
    compression: str = "zip",
) -> bytes:
    """Encode {channel_name: 2D array} into EXR bytes."""
    if not channels:
        raise ValueError("no channels")
    pt = {"float": _PT_FLOAT, "half": _PT_HALF, "uint": _PT_UINT}[pixel_type]
    comp = {
        "none": _EXR_COMP_NO, "zip": _EXR_COMP_ZIP, "zips": _EXR_COMP_ZIPS,
        "rle": _EXR_COMP_RLE,
    }[compression]
    lines_per_block = 16 if comp == _EXR_COMP_ZIP else 1

    names = sorted(channels)
    arrs = {}
    shape = None
    for n in names:
        a = np.asarray(channels[n])
        if a.ndim != 2:
            raise ValueError(f"channel {n} must be 2D, got {a.shape}")
        if shape is None:
            shape = a.shape
        elif a.shape != shape:
            raise ValueError("channel shapes differ")
        arrs[n] = np.ascontiguousarray(a, dtype=_PT_DTYPE[pt])
    height, width = shape

    chlist = b""
    for n in names:
        chlist += n.encode() + b"\x00" + struct.pack("<iBBBBii", pt, 0, 0, 0, 0, 1, 1)
    chlist += b"\x00"

    header = b""
    header += _attr("channels", "chlist", chlist)
    header += _attr("compression", "compression", bytes([comp]))
    box = struct.pack("<4i", 0, 0, width - 1, height - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\x00")
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    # build scanline blocks
    blocks: List[bytes] = []
    for row0 in range(0, height, lines_per_block):
        n_lines = min(lines_per_block, height - row0)
        rows = [arrs[n][row0 + li].tobytes() for li in range(n_lines) for n in names]
        raw = b"".join(rows)
        if comp == _EXR_COMP_NO:
            packed = raw
        elif comp == _EXR_COMP_RLE:
            r = _rle_compress(raw)
            packed = r if len(r) < len(raw) else raw
        else:
            z = zlib.compress(_zip_split_and_predict(raw), 6)
            packed = z if len(z) < len(raw) else raw
        blocks.append(struct.pack("<ii", row0, len(packed)) + packed)

    n_blocks = len(blocks)
    preamble = struct.pack("<ii", MAGIC, 2)
    table_start = len(preamble) + len(header)
    data_start = table_start + 8 * n_blocks
    offsets = []
    off = data_start
    for b in blocks:
        offsets.append(off)
        off += len(b)
    table = struct.pack(f"<{n_blocks}Q", *offsets)
    return preamble + header + table + b"".join(blocks)


def write(
    path: Union[str, Path],
    channels: Mapping[str, np.ndarray],
    pixel_type: str = "float",
    compression: str = "zip",
) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(encode(channels, pixel_type, compression))
