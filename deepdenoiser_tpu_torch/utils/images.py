"""Image save/preview helpers (upstream: TensorFlow/Utilities.py — SURVEY.md
C17): tone-mapped LDR previews of HDR radiance for logs and debugging.

The port of deepdenoiser_tpu/utils/images.py. PNGs are written with zlib
and struct (8-bit grey or RGB, no filtering), so nothing beyond numpy and
the standard library is needed.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def tonemap_srgb(hdr: np.ndarray, exposure: float = 1.0) -> np.ndarray:
    """HDR radiance -> sRGB-encoded [0,1] LDR (Reinhard + gamma 1/2.2)."""
    x = np.maximum(np.asarray(hdr, dtype=np.float32) * exposure, 0.0)
    x = x / (1.0 + x)
    return np.clip(x, 0.0, 1.0) ** (1.0 / 2.2)


def side_by_side(*imgs: np.ndarray, pad: int = 4) -> np.ndarray:
    """Horizontally concatenate equal-height images with a white gutter
    (noisy | denoised | ground-truth comparison strips)."""
    imgs = [np.asarray(i) for i in imgs]
    h = imgs[0].shape[0]
    assert all(i.shape[0] == h for i in imgs)
    c = imgs[0].shape[-1] if imgs[0].ndim == 3 else 1
    gutter = np.ones((h, pad, c), dtype=imgs[0].dtype)
    parts = []
    for i, img in enumerate(imgs):
        if img.ndim == 2:
            img = img[..., None]
        if i:
            parts.append(gutter)
        parts.append(img)
    return np.concatenate(parts, axis=1)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 (H, W), (H, W, 1) or (H, W, 3) -> PNG bytes."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise TypeError(f"encode_png: uint8 only, got {arr.dtype}")
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        colour = 0  # greyscale
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        colour = 2  # truecolour
    else:
        raise ValueError(f"encode_png: (H, W) or (H, W, 3), got {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b""))


def save_png(path: str | Path, ldr01: np.ndarray) -> None:
    """Write an ALREADY tone-mapped [0,1] (H, W, C) buffer as 8-bit PNG
    (save_preview_png tonemaps; this one does not)."""
    arr = (np.clip(np.asarray(ldr01, dtype=np.float32), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(encode_png(arr))


def save_preview_png(path: str | Path, hdr: np.ndarray, exposure: float = 1.0) -> None:
    """Write a tone-mapped 8-bit PNG preview of an HDR (H, W, 3) buffer."""
    save_png(path, tonemap_srgb(hdr, exposure))
