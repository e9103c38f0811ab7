"""8-bit image I/O for the registrator.

Binary PGM (P5) and PPM (P6) with maxval <= 255 are read and written with
numpy; an RGB input becomes gray by PIL's ``convert("L")`` integer luma,
``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``, so the port sees the same
pixels as the JAX tool (which opens every image with PIL). Any other format
goes through PIL, imported only then.
"""

from __future__ import annotations

import numpy as np

_NETPBM = (b"P5", b"P6")


def _read_netpbm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    tokens, pos = [], 0
    while len(tokens) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        tokens.append(data[pos:end])
        pos = end
    pos += 1  # the single whitespace after maxval
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit netpbm (maxval {maxval}) is not supported")
    ch = 1 if magic == b"P5" else 3
    px = np.frombuffer(data, np.uint8, count=w * h * ch, offset=pos)
    return px.reshape(h, w) if ch == 1 else px.reshape(h, w, 3)


def rgb_to_luma(rgb: np.ndarray) -> np.ndarray:
    """uint8 (H,W,3) -> uint8 (H,W) with PIL's ``convert("L")`` arithmetic."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _read_pil(path: str, mode: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{path}: only binary PGM/PPM are read without PIL, and PIL is not"
            " installed") from e
    return np.asarray(Image.open(path).convert(mode))


def _is_netpbm(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) in _NETPBM


def read_gray(path: str) -> np.ndarray:
    """Image file -> (H,W) float32 gray values 0..255."""
    if _is_netpbm(path):
        img = _read_netpbm(path)
        if img.ndim == 3:
            img = rgb_to_luma(img)
        return img.astype(np.float32)
    return _read_pil(path, "L").astype(np.float32)


def read_rgb(path: str) -> np.ndarray:
    """Image file -> (H,W,3) uint8 (a gray image repeated in the three
    channels, as PIL's ``convert("RGB")`` gives it)."""
    if _is_netpbm(path):
        img = _read_netpbm(path)
        return np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img
    return _read_pil(path, "RGB")


def write_pgm(path: str, img: np.ndarray) -> None:
    """(H,W) uint8 -> binary PGM (P5)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"PGM needs a (H,W) image; got {img.shape}")
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())
