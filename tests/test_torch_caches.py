"""Port vs JAX: the registrator's disk caches, across packages.

``photometric/cache.py`` (the multi-resolution cloud, ``level_<i>.npz`` +
``metadata.json``; the photo levels with neighbours and descriptors,
``photo_level_<i>.npz`` + ``photo_metadata.json``) and the observations
cache's ``observations_cache.npz`` (``photometric/obs_cache.py``):

- the port writes what the JAX package writes: the JSON files byte for byte
  and every array member of every ``.npz`` byte for byte (the ``.npy``
  payloads inside the zip; the zip container itself carries write times);
- the port loads the JAX package's files and the JAX package loads the
  port's, to equal arrays;
- a parameter mismatch invalidates either package's cache in the other.
"""

import json
import os
import zipfile

import jax.numpy as jnp
import numpy as np
import torch

from dataset_pipeline_tpu.photometric import cache as jc
from dataset_pipeline_tpu.photometric import obs_cache as joc
from dataset_pipeline_tpu.photometric.multiscale import PointLevel as JPointLevel
from dataset_pipeline_tpu.photometric.problem import build_photo_level as jbuild
from dataset_pipeline_tpu_torch.photometric import cache as tc
from dataset_pipeline_tpu_torch.photometric import obs_cache as toc
from dataset_pipeline_tpu_torch.photometric.multiscale import PointLevel as TPointLevel
from dataset_pipeline_tpu_torch.photometric.problem import build_photo_level as tbuild

torch.set_num_threads(2)
PARAMS = {"num_points": 400, "scale_count": 2, "num_images": 2}


def _raw(cls, seed=3):
    rng = np.random.RandomState(seed)
    pts = rng.rand(400, 3).astype(np.float32)
    inten = (rng.rand(400) * 255).astype(np.float32)
    scans = (rng.rand(400) < 0.5).astype(np.uint8)
    return [cls(pts, inten, scans, 0.01), cls(pts[:100], inten[:100], scans[:100], 0.02)]


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _same_files(a_dir, b_dir):
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir))
    for n in names:
        if n.endswith(".npz"):
            assert _members(os.path.join(a_dir, n)) == _members(os.path.join(b_dir, n)), n
        else:
            assert open(os.path.join(a_dir, n), "rb").read() == \
                   open(os.path.join(b_dir, n), "rb").read(), n
    return names


def test_multiscale_cache_across_packages(tmp_path):
    jc.save_multiscale_cache(str(tmp_path / "jax"), _raw(JPointLevel), PARAMS)
    tc.save_multiscale_cache(str(tmp_path / "port"), _raw(TPointLevel), PARAMS)
    assert _same_files(tmp_path / "jax", tmp_path / "port") == [
        "level_0.npz", "level_1.npz", "metadata.json"]
    from_jax = tc.load_multiscale_cache(str(tmp_path / "jax"), PARAMS)
    from_port = jc.load_multiscale_cache(str(tmp_path / "port"), PARAMS)
    for a, b, c in zip(_raw(TPointLevel), from_jax, from_port):
        for f in ("points", "intensities", "scan_indices"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
            np.testing.assert_array_equal(getattr(c, f), getattr(a, f))
        assert a.radius == b.radius == c.radius
    assert tc.load_multiscale_cache(str(tmp_path / "jax"), {**PARAMS, "num_points": 7}) is None
    assert jc.load_multiscale_cache(str(tmp_path / "port"), {**PARAMS, "num_images": 9}) is None


def test_photo_level_cache_across_packages(tmp_path):
    jl = [jbuild(lv, seed=i, apply_gradient_filter=False) for i, lv in enumerate(_raw(JPointLevel))]
    tl = [tbuild(lv, seed=i, apply_gradient_filter=False, device="cpu")
          for i, lv in enumerate(_raw(TPointLevel))]
    jc.save_photo_levels_cache(str(tmp_path / "jax"), jl, PARAMS)
    tc.save_photo_levels_cache(str(tmp_path / "port"), tl, PARAMS)
    _same_files(tmp_path / "jax", tmp_path / "port")
    meta = json.load(open(tmp_path / "port" / "photo_metadata.json"))
    assert meta["num_levels"] == 2 and meta["version"] == tc.CACHE_VERSION
    from_jax = tc.load_photo_levels_cache(str(tmp_path / "jax"), PARAMS, device="cpu")
    from_port = jc.load_photo_levels_cache(str(tmp_path / "port"), PARAMS)
    for a, b, c in zip(jl, from_jax, from_port):
        for f in ("points", "intensities", "scan_indices", "neighbors", "fixed_descriptors"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)))
            np.testing.assert_array_equal(np.asarray(getattr(c, f)), np.asarray(getattr(a, f)))
        assert b.neighbors.dtype == torch.int64 and a.radius == b.radius == c.radius
    assert tc.load_photo_levels_cache(str(tmp_path / "jax"), {**PARAMS, "num_images": 9}) is None


def test_observations_cache_file_across_packages(tmp_path):
    jl = [jbuild(lv, seed=i, apply_gradient_filter=False) for i, lv in enumerate(_raw(JPointLevel))]
    tl = [tbuild(lv, seed=i, apply_gradient_filter=False, device="cpu")
          for i, lv in enumerate(_raw(TPointLevel))]
    rng = np.random.RandomState(5)
    jcache, tcache = joc.ObservationsCache(), toc.ObservationsCache()
    for b in range(3):
        for l in range(2):
            m = rng.rand(len(tl[l].points)) > 0.7
            jcache.set_candidates(0, b, l, jl[l], m)
            tcache.set_candidates(0, b, l, tl[l], m)
    jcache.save(str(tmp_path / "jax.npz"), jl)
    tcache.save(str(tmp_path / "port.npz"), tl)
    assert _members(tmp_path / "jax.npz") == _members(tmp_path / "port.npz")
    from_jax = toc.ObservationsCache.load(str(tmp_path / "jax.npz"), tl)
    from_port = joc.ObservationsCache.load(str(tmp_path / "port.npz"), jl)
    assert from_jax.stats() == tcache.stats() == from_port.stats() == jcache.stats()
    for key in jcache._views:
        a, b, c = jcache.view(*key), from_jax.view(*key), from_port.view(*key)
        for f in ("gather_idx", "scatter_idx", "core", "points", "neighbors", "fixed_descriptors"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)))
            np.testing.assert_array_equal(np.asarray(getattr(c, f)), np.asarray(getattr(a, f)))
    assert toc.ObservationsCache.load(str(tmp_path / "jax.npz"), tl[:1] + tl[:1]) is None
