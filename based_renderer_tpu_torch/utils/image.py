"""Image IO: PNG/PPM writing for framebuffer readback.

Pure-Python PNG encoder (zlib stored blocks via the stdlib) so demos have
no dependency beyond numpy; PIL is used opportunistically when present.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def srgb_encode(img: np.ndarray) -> np.ndarray:
    """Linear -> sRGB transfer function (IEC 61966-2-1), in float64.

    When the last axis has 4 channels, channel 3 (alpha) passes through
    linear — the semantics of a VK_FORMAT_*_SRGB swapchain image (the
    reference takes the first reported surface format, in practice
    *_SRGB: reference src/main.cpp:1338-1339).  Double precision so
    the u8 quantization is bit-identical to the native
    brt_f32_to_u8_srgb path (both call this host's libm pow).
    """
    a = np.asarray(img, np.float64)
    has_alpha = a.ndim >= 1 and a.shape[-1] == 4
    rgb = a[..., :3] if has_alpha else a
    enc = np.where(
        rgb <= 0.0031308,
        rgb * 12.92,
        1.055 * np.power(np.maximum(rgb, 0.0), 1.0 / 2.4) - 0.055,
    )
    if has_alpha:
        enc = np.concatenate([enc, a[..., 3:]], axis=-1)
    return enc


def to_u8(img: np.ndarray, srgb: bool = False) -> np.ndarray:
    """float [0,1] (H, W, 3|4) -> uint8, clipping; ``srgb`` applies the
    transfer function first (u8 images pass through untouched — they are
    assumed already encoded)."""
    if img.dtype == np.uint8:
        return img
    a = srgb_encode(img) if srgb else np.asarray(img)
    return np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray, srgb: bool = False) -> None:
    """Write (H, W, 1|3|4) uint8/float image as PNG."""
    arr = to_u8(np.asarray(img), srgb=srgb)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def read_png(path) -> np.ndarray:
    """Decode an 8-bit, non-interlaced grey, RGB or RGBA PNG whose
    scanlines are all unfiltered (as ``write_png`` and the native
    runtime's writer make them) with the stdlib's zlib: (H, W, C) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, color_type, _, _, interlace = ihdr
    channels = {0: 1, 2: 3, 6: 4}.get(color_type)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {color_type}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * channels)
    if raw[:, 0].any():
        raise ValueError(f"{path}: filtered scanlines (filter types {sorted(set(raw[:, 0].tolist()))})")
    return raw[:, 1:].reshape(h, w, channels).copy()


def write_ppm(path: str, img: np.ndarray, srgb: bool = False) -> None:
    arr = to_u8(np.asarray(img), srgb=srgb)[..., :3]
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())
