"""Image IO: EXR/PFM/PNG/NPY output, bitmap reading.

Counterpart of mitsuba3 src/core/bitmap.cpp (SURVEY.md §2.3). EXR (the
reference's native HDR format) is handled by the pure-Python reader/writer
in utils/exr.py; 8-bit sRGB PNG output is encoded here with zlib, so
neither needs a third-party package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from mitsuba_customization_tpu.core.spectrum import linear_to_srgb


def write_image(path, image):
    """Write by extension: .exr/.pfm float-exact, .npy, or tonemapped .png."""
    p = str(path)
    if p.endswith(".exr"):
        from mitsuba_customization_tpu.utils.exr import write_exr

        write_exr(p, np.asarray(image, np.float32))
    elif p.endswith(".pfm"):
        from mitsuba_customization_tpu.utils.exr import write_pfm

        write_pfm(p, np.asarray(image, np.float32))
    elif p.endswith(".npy"):
        write_npy(p, image)
    else:
        write_png(p, image)


def write_png(path, image, tonemap=True):
    """Write an (H, W, 3) linear-RGB float image as 8-bit sRGB PNG."""
    img = np.asarray(image, dtype=np.float32)
    if tonemap:
        img = np.asarray(linear_to_srgb(np.clip(img, 0.0, 1.0)))
    img8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(img8))


def encode_png(img8):
    """(H, W, 3) or (H, W) uint8 -> PNG bytes (8-bit, no filtering)."""
    img8 = np.ascontiguousarray(img8, dtype=np.uint8)
    h, w = img8.shape[:2]
    color = 2 if img8.ndim == 3 else 0  # truecolor / grayscale
    rows = img8.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(tag, data):
        body = tag + data
        return (
            struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)
        )

    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


def write_npy(path, image):
    """Float-exact image dump (the EXR stand-in for goldens)."""
    np.save(path, np.asarray(image, dtype=np.float32))


def read_image(path):
    """Read an image file into linear-RGB float32 (H, W, 3)."""
    path = str(path)
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".exr"):
        from mitsuba_customization_tpu.utils.exr import read_exr

        img = read_exr(path)
        return (
            np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img
        ).astype(np.float32)
    if path.endswith(".pfm"):
        from mitsuba_customization_tpu.utils.exr import read_pfm

        img = read_pfm(path)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return img.astype(np.float32)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs the Pillow package; .exr, .pfm and .npy "
            "images read without it"
        ) from e

    img = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0
    # PNG/JPG are sRGB-encoded: linearize.
    lin = np.where(
        img <= 0.04045, img / 12.92, ((img + 0.055) / 1.055) ** 2.4
    )
    return lin.astype(np.float32)
