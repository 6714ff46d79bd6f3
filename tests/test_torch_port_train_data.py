"""The training host data of the port against the JAX package: the flip
and the global rot-scale-trans of a sample, the nuScenes dataset with both
augmentation hooks, the bit-pack codec (the port's g++ library and its
numpy plain version against JAX's codec), the BEV cache (each token's
datasets of the port's file against JAX's), a cached dataset against a
rasterizing one, and the ``prepare_cache`` CLI.

On a synthetic mini-nuScenes tree of the JAX package's
``make_mini_nuscenes``; float64 transforms at atol 1e-12, maps and codes
exact. The cache needs ``h5py``, as the JAX package's does.
"""
import os

import numpy as np
import pytest

from test_torch_port_data import (AUX, CLASSES, _assert_samples_equal,
                                  indices, jax_native, tree)  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_CLASSES = ("drivable_area", "ped_crossing", "walkway", "stop_line",
               "carpark_area", "road_divider", "lane_divider", "road_block")


def _sample(indices):
    """A rasterized nuScenes sample of the tree, with images (port's)."""
    from magicdrive_tpu_torch.data.map_raster import BEVRasterizer
    from magicdrive_tpu_torch.data.nuscenes import NuScenesDataset

    ds = NuScenesDataset(indices[0], BEVRasterizer(
        indices[0].dataroot, object_classes=CLASSES, aux_data=AUX,
        backend="native"))
    return ds[1]


def _assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "metas":
            assert got[k] == v
            continue
        v = np.asarray(v)
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert np.asarray(got[k]).dtype == v.dtype, k


@pytest.mark.parametrize("direction", ["vertical", "horizontal"])
@pytest.mark.parametrize("reorder", [True, False])
def test_flip_matches_jax(tree, indices, jax_native, direction, reorder):
    """Boxes, BEV map, images, extrinsics and intrinsics flipped, the views
    reordered, as JAX's ``flip_sample``; the input left as it was."""
    from magicdrive_tpu.data.flip import flip_sample as jflip

    from magicdrive_tpu_torch.data.flip import flip_sample

    s = _sample(indices)
    before = {k: np.copy(v) for k, v in s.items() if k != "metas"}
    got, want = flip_sample(s, direction, reorder), jflip(s, direction,
                                                          reorder)
    _assert_dicts_equal(got, want)
    assert not np.array_equal(got["boxes"], s["boxes"])
    for k, v in before.items():
        np.testing.assert_array_equal(s[k], v)


def test_random_flip_matches_jax(tree, indices, jax_native):
    """``RandomFlip3DwithViews`` with "horv" and "hv" on equal generators:
    the same choices and the same samples."""
    from magicdrive_tpu.data.flip import RandomFlip3DwithViews as J

    from magicdrive_tpu_torch.data.flip import RandomFlip3DwithViews

    s = _sample(indices)
    for direction in ("horv", "hv", "v"):
        port = RandomFlip3DwithViews(0.5, direction,
                                     np.random.default_rng(5))
        ref = J(0.5, direction, np.random.default_rng(5))
        for _ in range(4):
            _assert_dicts_equal(port(s), ref(s))


def test_rot_scale_trans_matches_jax(tree, indices, jax_native):
    """Boxes (with velocities), lidar_aug_matrix, camera2lidar, lidar2camera
    and lidar2image of a drawn rotation, scale and translation, composed
    twice, as JAX's; identity ranges leave the sample as it is."""
    from magicdrive_tpu.data.rot_scale_trans import GlobalRotScaleTrans as J
    from magicdrive_tpu.data.rot_scale_trans import transform_boxes as jtb

    from magicdrive_tpu_torch.data.rot_scale_trans import (
        GlobalRotScaleTrans, transform_boxes)

    s = _sample(indices)
    kw = dict(resize_lim=(0.9, 1.1), rot_lim=(-0.4, 0.4), trans_lim=0.5)
    port = GlobalRotScaleTrans(**kw, rng=np.random.default_rng(7))
    ref = J(**kw, rng=np.random.default_rng(7))
    got, want = port(port(s)), ref(ref(s))
    _assert_dicts_equal(got, want)
    assert not np.allclose(got["lidar_aug_matrix"], np.eye(4))
    boxes9 = np.random.default_rng(8).normal(size=(5, 9))
    np.testing.assert_allclose(transform_boxes(boxes9, 0.3, 1.2, [1, 2, 3]),
                               jtb(boxes9, 0.3, 1.2, [1, 2, 3]), rtol=0,
                               atol=1e-12)
    assert GlobalRotScaleTrans()(s) is s


def test_dataset_hooks_match_jax(tree, indices, jax_native):
    """``NuScenesDataset`` with a rot-scale-trans before the map (which is
    then rasterized at lidar2global @ inv(lidar_aug_matrix)) and a flip
    after it, on equal generators: every sample as JAX's."""
    from magicdrive_tpu.data.flip import RandomFlip3DwithViews as JFlip
    from magicdrive_tpu.data.map_raster import BEVRasterizer as JRaster
    from magicdrive_tpu.data.nuscenes import NuScenesDataset as JDataset
    from magicdrive_tpu.data.rot_scale_trans import GlobalRotScaleTrans as JR

    from magicdrive_tpu_torch.data.flip import RandomFlip3DwithViews
    from magicdrive_tpu_torch.data.map_raster import BEVRasterizer
    from magicdrive_tpu_torch.data.nuscenes import NuScenesDataset
    from magicdrive_tpu_torch.data.rot_scale_trans import GlobalRotScaleTrans

    kw = dict(resize_lim=(0.95, 1.05), rot_lim=(-0.3, 0.3), trans_lim=1.0)
    root = tree[0]
    got = NuScenesDataset(
        indices[0], BEVRasterizer(root, object_classes=CLASSES,
                                  aux_data=AUX, backend="native"),
        transforms_3d=[GlobalRotScaleTrans(**kw,
                                           rng=np.random.default_rng(1))],
        transforms=[RandomFlip3DwithViews(0.5, "horv",
                                          np.random.default_rng(2))])
    want = JDataset(
        indices[1], rasterizer=JRaster(root, object_classes=CLASSES,
                                       aux_data=AUX, backend="native"),
        transforms_3d=[JR(**kw, rng=np.random.default_rng(1))],
        transforms=[JFlip(0.5, "horv", np.random.default_rng(2))])
    plain = NuScenesDataset(indices[0], BEVRasterizer(
        root, object_classes=CLASSES, aux_data=AUX, backend="native"))
    for i in range(len(want)):
        s = got[i]
        _assert_samples_equal(s, want[i])
        assert not np.array_equal(s["bev_map"], plain[i]["bev_map"])


def test_bitpack_codec_matches_jax(jax_native):
    """The g++ codec and its numpy plain version, both ways, bitwise JAX's
    codec (its native library where built, else its numpy one), on 26
    channels (8 map, 10 object, 8 aux as masks) and on 30, the most."""
    from magicdrive_tpu.data.cache import one_hot_decode as jdecode
    from magicdrive_tpu.data.cache import one_hot_encode as jencode

    from magicdrive_tpu_torch.data.cache import (one_hot_decode,
                                                 one_hot_encode)
    from magicdrive_tpu_torch.native import bitpack

    rs = np.random.default_rng(9)
    for c in (26, 30, 1):
        m = (rs.random((c, 37, 53)) < 0.3).astype(np.uint8)
        want = jencode(m)
        for enc in (bitpack.encode(m), bitpack.encode_numpy(m),
                    one_hot_encode(m)):
            assert enc.dtype == np.int32
            np.testing.assert_array_equal(enc, want)
        for dec in (bitpack.decode(want, c), bitpack.decode_numpy(want, c),
                    one_hot_decode(want, c)):
            assert dec.dtype == np.uint8
            np.testing.assert_array_equal(dec, jdecode(want, c))
            np.testing.assert_array_equal(dec, m)
    with pytest.raises(ValueError, match="30"):
        bitpack.encode(np.zeros((31, 2, 2), np.uint8))


@pytest.fixture(scope="module")
def caches(tree, indices, jax_native, tmp_path_factory):
    """(the port's cache of the tree, JAX's), each written by its
    ``build_cache``, the port's with two forked workers."""
    from magicdrive_tpu.data.cache import build_cache as jbuild
    from magicdrive_tpu.data.map_raster import BEVRasterizer as JRaster

    from magicdrive_tpu_torch.data.cache import build_cache
    from magicdrive_tpu_torch.data.map_raster import BEVRasterizer

    out = tmp_path_factory.mktemp("cache")
    kw = dict(classes=MAP_CLASSES, object_classes=CLASSES, aux_data=AUX,
              backend="native")
    port = build_cache(indices[0], BEVRasterizer(tree[0], **kw),
                       str(out / "port.h5"), progress=False, workers=2)
    ref = jbuild(indices[1], JRaster(tree[0], **kw), str(out / "jax.h5"),
                 progress=False)
    return port, ref


def _h5_contents(path):
    import h5py

    with h5py.File(path, "r") as f:
        return {(g, k): (f[g][k][:], f[g][k].dtype, f[g][k].compression)
                for g in f for k in f[g]}


def test_build_cache_matches_jax(caches, indices):
    """Every group and token of the port's file, JAX's layout: the same
    datasets, dtypes and compression, the values equal."""
    got, want = _h5_contents(caches[0]), _h5_contents(caches[1])
    assert got.keys() == want.keys()
    tokens = {info.token for info in indices[0].infos}
    assert {k for (g, k) in got} == tokens
    assert {g for (g, _) in got} == {"gt_masks_bev_static", "gt_masks_bev",
                                     "gt_aux_bev"}
    for key, (v, dtype, comp) in want.items():
        np.testing.assert_array_equal(got[key][0], v, err_msg=str(key))
        assert got[key][1:] == (dtype, comp), key


def test_cached_dataset_equals_rasterizing(tree, indices, caches):
    """A dataset reading the cache gives the rasterizing dataset's samples
    (force_all_boxes: the cache holds every labelled box); a 3D
    augmentation moves the frame off the cache, back to the rasterizer."""
    from magicdrive_tpu_torch.data.cache import BEVCache
    from magicdrive_tpu_torch.data.map_raster import BEVRasterizer
    from magicdrive_tpu_torch.data.nuscenes import NuScenesDataset
    from magicdrive_tpu_torch.data.rot_scale_trans import GlobalRotScaleTrans

    cache = BEVCache(caches[0], n_map_classes=len(MAP_CLASSES),
                     n_object_classes=len(CLASSES))
    ras = BEVRasterizer(tree[0], classes=MAP_CLASSES,
                        object_classes=CLASSES, aux_data=AUX,
                        backend="native")
    cached = NuScenesDataset(indices[0], cache=cache)
    rastered = NuScenesDataset(indices[0], ras)
    for i in range(len(rastered)):
        _assert_samples_equal(cached[i], rastered[i])
    assert cache.get("no-such-token") is None
    moved = NuScenesDataset(indices[0], ras, cache=cache, transforms_3d=[
        GlobalRotScaleTrans(rot_lim=(0.2, 0.2))])
    assert not np.array_equal(moved[0]["bev_map"], cached[0]["bev_map"])
    with pytest.raises(RuntimeError, match="no BEV source"):
        NuScenesDataset(indices[0], cache=cache, transforms_3d=[
            GlobalRotScaleTrans(rot_lim=(0.2, 0.2))])[0]
    cache.close()


def test_prepare_cache_cli_matches_jax(tree, jax_native, tmp_path, caches):
    """The port's ``cli.prepare_cache`` writes JAX's ``tools/prepare_cache``
    file on the tree, from the repository's dataset config."""
    from tools import prepare_cache as jcli

    from magicdrive_tpu_torch.cli import prepare_cache

    args = ["--dataroot", tree[0], "--version", tree[1], "--workers", "0"]
    got = prepare_cache.main([*args, "--out", str(tmp_path / "port.h5")])
    jcli.main([*args, "--out", str(tmp_path / "jax.h5")])
    a, b = _h5_contents(got), _h5_contents(str(tmp_path / "jax.h5"))
    assert a.keys() == b.keys() == _h5_contents(caches[1]).keys()
    for key in b:
        np.testing.assert_array_equal(a[key][0], b[key][0], err_msg=str(key))


def test_cache_without_h5py_names_it(monkeypatch, tmp_path):
    """The cache imports h5py where it is used: without it, reading or
    building one raises an ImportError that names the package, and the
    codec and the rest of the data path still import."""
    import sys

    from magicdrive_tpu_torch.data import cache

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        cache.BEVCache(str(tmp_path / "c.h5"), n_map_classes=8)
    with pytest.raises(ImportError, match="h5py"):
        cache.build_cache(None, None, str(tmp_path / "c.h5"))
    assert cache.one_hot_encode(np.ones((2, 3, 3), np.uint8)).max() == 3
