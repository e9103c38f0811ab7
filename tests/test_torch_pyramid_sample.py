"""Port vs JAX: the trilinear pyramid sampler (B3's plain version).

The port's plain sampler (``ops/pyramid_sample.sample_plain``, what a CPU
tensor runs) against

- the JAX flat sampler ``_sample_pyramid[_with_derivs]`` (``USE_BRICK=False``);
- the TPU path, ``brick_sample[_with_derivs]`` with the Pallas extract kernel
  ``_extract_pallas`` run in interpret mode (as ``tests/test_brick.py`` runs
  it on the CPU);

for L = 1 and L = 4, odd level sizes, pixels outside the image and scales
outside [0, L). Tolerances: ``ok`` identical; value and derivatives 1e-4
absolute + 1e-6 relative where ok (float32 values up to 255 are ~1.5e-5 per
ulp; the brick path sums its one-hot taps in another order).
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dataset_pipeline_tpu.photometric.optimizer as jpo
from dataset_pipeline_tpu.ops.brick import (
    _extract_pallas,
    brick_sample,
    brick_sample_with_derivs,
    build_brick_pyramid,
)
from dataset_pipeline_tpu_torch.ops import pyramid_sample as tps

torch.set_num_threads(2)
ATOL, RTOL = 1e-4, 1e-6


def _pyramid(rng, H, W, L):
    """Levels as ``build_image_pyramid`` makes them: odd sizes crop (h//2)."""
    pyr = [rng.rand(H, W).astype(np.float32) * 255]
    for _ in range(1, L):
        h, w = pyr[-1].shape
        pyr.append(pyr[-1][: h // 2 * 2, : w // 2 * 2].reshape(h // 2, 2, w // 2, 2).mean((1, 3)))
    return pyr


def _inputs(seed, H=97, W=131, L=4, N=3000):
    rng = np.random.RandomState(seed)
    pyr = _pyramid(rng, H, W, L)
    pix = np.stack([rng.rand(N) * (W + 8) - 4, rng.rand(N) * (H + 8) - 4], -1).astype(np.float32)
    scale = (rng.rand(N) * (L + 1.0) - 0.5).astype(np.float32)  # some outside [0, L)
    pix[:20] = np.round(pix[:20])  # observations on integer pixel coordinates
    return pyr, pix, scale


def _port(pyr, pix, scale, with_derivs):
    flat, layout = tps.flatten_pyramid([torch.from_numpy(p)[None] for p in pyr])
    return [t[0].numpy() for t in tps.pyramid_sample(
        flat, layout, torch.from_numpy(pix)[None], torch.from_numpy(scale)[None], with_derivs)]


def _check(got, ref):
    ok = np.asarray(ref[-1])
    np.testing.assert_array_equal(got[-1], ok)
    assert ok.mean() > 0.3
    for a, b in zip(got[:-1], ref[:-1]):
        np.testing.assert_allclose(a[ok], np.asarray(b)[ok], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("L,H,W", [(1, 97, 131), (4, 97, 131), (4, 64, 48), (3, 33, 35)])
def test_plain_sampler_matches_flat_jax_sampler(monkeypatch, L, H, W):
    monkeypatch.setattr(jpo, "USE_BRICK", False)
    pyr, pix, scale = _inputs(L * 100 + H, H, W, L)
    jpyr = [jnp.asarray(p) for p in pyr]
    _check(_port(pyr, pix, scale, True),
           jpo._sample_pyramid_with_derivs(jpyr, jnp.asarray(pix), jnp.asarray(scale)))
    _check(_port(pyr, pix, scale, False),
           jpo._sample_pyramid(jpyr, jnp.asarray(pix), jnp.asarray(scale)))


@pytest.mark.parametrize("L", [1, 4])
def test_plain_sampler_matches_pallas_brick_kernel_interpreted(L):
    pyr, pix, scale = _inputs(7 + L, L=L, N=2500)
    brick = build_brick_pyramid([jnp.asarray(p) for p in pyr])
    extract = partial(_extract_pallas, interpret=True)
    _check(_port(pyr, pix, scale, True),
           brick_sample_with_derivs(brick, L, jnp.asarray(pix), jnp.asarray(scale),
                                    extract=extract))
    _check(_port(pyr, pix, scale, False),
           brick_sample(brick, L, jnp.asarray(pix), jnp.asarray(scale), extract=extract))


def test_batched_images_and_float64():
    """A batch of images samples each image's own pyramid; the float64 plain
    version (the card's reference) agrees with float32 within rounding."""
    rng = np.random.RandomState(3)
    pyrs = [_pyramid(rng, 45, 61, 3) for _ in range(3)]
    flat, layout = tps.flatten_pyramid(
        [torch.from_numpy(np.stack([p[l] for p in pyrs])) for l in range(3)])
    pix = torch.from_numpy(np.stack([rng.rand(500) * 60, rng.rand(500) * 44], -1)
                           .astype(np.float32)).expand(3, 500, 2).contiguous()
    scale = torch.from_numpy((rng.rand(3, 500) * 2.5).astype(np.float32))
    out = tps.pyramid_sample(flat, layout, pix, scale)
    for b in range(3):
        one = _port(pyrs[b], pix[b].numpy(), scale[b].numpy(), True)
        for a, c in zip(out, one):
            np.testing.assert_array_equal(a[b].numpy(), c)
    out64 = tps.sample_plain(flat.double(), layout, pix.double(), scale.double())
    ok = out[-1] & out64[-1]
    for a, c in zip(out[:-1], out64[:-1]):
        np.testing.assert_allclose(a[ok].numpy(), c[ok].numpy(), rtol=1e-5, atol=2e-4)


def test_wrapper_rejects_bad_inputs():
    flat, layout = tps.flatten_pyramid([torch.zeros(2, 8, 8), torch.zeros(2, 4, 4)])
    with pytest.raises(ValueError):
        tps.pyramid_sample(flat, layout, torch.zeros(2, 5, 3), torch.zeros(2, 5))
    with pytest.raises(ValueError):
        tps.pyramid_sample(flat[:, :10], layout, torch.zeros(2, 5, 2), torch.zeros(2, 5))
    with pytest.raises(ValueError, match="unsupported device"):
        tps.pyramid_sample(flat.to("meta"), layout, torch.zeros(2, 5, 2, device="meta"),
                           torch.zeros(2, 5, device="meta"))


@pytest.mark.parametrize("shapes", [[(45, 61), (22, 30), (11, 15)], [(8, 8), (4, 4)], [(3, 5)]])
def test_pair_rows_interleave_the_flat_pyramid_rows(shapes):
    """The row-paired copy the kernel reads, against ``flatten_pyramid``:
    entry 2x + r of pair row y of level l is that level's (y + r, x); pair
    rows are padded with zeros to a multiple of 4 floats (odd widths), and
    every level starts 16-byte aligned. On the CPU the wrapper is the plain
    version."""
    rng = np.random.RandomState(len(shapes))
    pyr = [torch.from_numpy(rng.randn(2, h, w).astype(np.float32)) for h, w in shapes]
    flat, layout = tps.flatten_pyramid(pyr)
    pairs = tps.pair_rows(flat, layout)
    assert torch.equal(pairs, tps.pair_rows_plain(flat, layout))
    assert pairs.shape == (2, layout.pair_total)
    for lvl, (h, w), off in zip(pyr, shapes, layout.pair_offs):
        ps = tps.pair_stride(w)
        assert off % 4 == 0 and ps % 4 == 0 and 2 * w <= ps < 2 * w + 4
        rows = pairs[:, off:off + (h - 1) * ps].reshape(2, h - 1, ps)
        assert torch.equal(rows[..., 0:2 * w:2], lvl[:, :-1])
        assert torch.equal(rows[..., 1:2 * w:2], lvl[:, 1:])
        assert not rows[..., 2 * w:].any()
    assert layout.pair_total == sum((h - 1) * tps.pair_stride(w) for h, w in shapes)
    with pytest.raises(ValueError):
        tps.pair_rows(flat[:, 1:], layout)
