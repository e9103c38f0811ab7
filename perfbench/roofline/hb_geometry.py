"""The least work of one launch of the H,b geometry kernel's ``jacobian``
mode (``csrc/hb_geometry.cu``), from the launch's shapes alone.

Bytes: each point read once (12 B; the chunk's shared points once, the
cache's per-image points once per row), B3's derivatives read (dpx and dpy,
with the footprint row dvds too: 4 B each a row), the row of J written (4 V
B), and the poses and intrinsics (28 B an image, 4 B a parameter).

Operations a row, counted from the equations the launch evaluates: the pose
(the quaternion's norm and the rotation of the point, 40); the lens at the
point, and with the footprint row at its second point too (the pre-warp,
the distortion and its 2 x 2 derivative under THIN_PRISM_FISHEYE, 120; the
reciprocal of z for a pinhole, 2); per column the tangent of the normalised
point, of the pixel and its chain with B3's derivatives (15), and with the
footprint row the footprint's tangent (25).

The bound is the larger of bytes over the H100 SXM's 3.35 TB/s and
operations over its 67 TFLOP/s float32 (NVIDIA's data sheet, at the 700 W
limit). It depends on the inputs alone, not on how the kernel reads them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
POSE_FLOPS = 40
LENS_FLOPS = {True: 120, False: 2}  # with a lens, a pinhole
COLUMN_FLOPS = 15
FOOTPRINT_COLUMN_FLOPS = 25


def launch_work(images: int, points: int, per_image: bool, V: int, P: int, footprint: bool,
                lens: bool):
    """(bytes, operations) of one ``jacobian`` launch over ``images`` x
    ``points`` rows with V columns, P intrinsics, the footprint row or not,
    a camera with a lens or not."""
    rows = images * points
    nbytes = (12 * (rows if per_image else points) + (8 + 4 * footprint + 4 * V) * rows
              + 28 * images + 4 * P)
    per_row = (POSE_FLOPS + LENS_FLOPS[lens] * (1 + footprint)
               + V * (COLUMN_FLOPS + FOOTPRINT_COLUMN_FLOPS * footprint))
    return nbytes, per_row * rows


def bound_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
