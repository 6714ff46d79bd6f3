"""The port's nuScenes data path against the JAX package on the same tree.

On a synthetic mini-nuScenes tree written by the JAX package's
``make_mini_nuscenes``: the port's own tree equals it file for file (the
JSON byte for byte, the JPEGs by shape: the JAX tree seeds per-sample
JPEGs with Python's salted ``hash``); the index's frames (transforms and
boxes at 1e-9, the rest exact) and its saved copy; the dataset's samples
per raster backend (bev_map exact, images at 1e-6); the map's hole and
multi-part polygons; the C++ raster core; the box geometry; the collate in
every box mode, view sharing and filter, with the training drop and add
draws from the same generator; the CLIP BPE tokenizer on a small vocab
written here; the caption framing; the viz arrays; ``build_datasets`` on
both of its paths.
"""
import filecmp
import json
import os

import numpy as np
import pytest
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer",
           "barrier", "motorcycle", "bicycle", "pedestrian", "traffic_cone")
AUX = ("visibility", "center_offset", "center_ohw", "height")
BACKENDS = ("pil", "native")


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native raster library, built as its own tests
    build it where it is missing."""
    try:
        from magicdrive_tpu.native import raster
    except OSError:
        from magicdrive_tpu.native import build

        build.build(verbose=False)
        from magicdrive_tpu.native import raster
    return raster


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from magicdrive_tpu.data.synth import make_mini_nuscenes

    return make_mini_nuscenes(tmp_path_factory.mktemp("nusc"))


@pytest.fixture(scope="module")
def indices(tree):
    from magicdrive_tpu.data.nuscenes import NuScenesIndex as JIndex

    from magicdrive_tpu_torch.data.nuscenes import NuScenesIndex

    return NuScenesIndex(*tree), JIndex(*tree)


def _datasets(tree, indices, backend):
    from magicdrive_tpu.data.map_raster import BEVRasterizer as JRaster
    from magicdrive_tpu.data.nuscenes import ImageAugConfig as JAug
    from magicdrive_tpu.data.nuscenes import NuScenesDataset as JDataset

    from magicdrive_tpu_torch.data.map_raster import BEVRasterizer
    from magicdrive_tpu_torch.data.nuscenes import (ImageAugConfig,
                                                    NuScenesDataset)

    root = tree[0]
    got = NuScenesDataset(indices[0], BEVRasterizer(
        root, object_classes=CLASSES, aux_data=AUX, backend=backend),
        aug=ImageAugConfig(final_hw=(224, 400)))
    want = JDataset(indices[1], rasterizer=JRaster(
        root, object_classes=CLASSES, aux_data=AUX, backend=backend),
        aug=JAug(final_hw=(224, 400)))
    return got, want


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_synth_tree_matches_jax(tree, tmp_path):
    """The port's tree is the JAX package's, file for file: with one JPEG
    per camera (the fixture's tree) every file is byte-equal; with a JPEG
    per sample and camera the JSON is, and each JPEG has its shape."""
    from magicdrive_tpu.data.synth import make_mini_nuscenes as jmake

    from magicdrive_tpu_torch.data.synth import make_mini_nuscenes

    root, version = make_mini_nuscenes(tmp_path / "shared")
    assert version == tree[1]
    assert _files(root) == _files(tree[0])
    for rel in _files(root):
        assert filecmp.cmp(os.path.join(root, rel),
                           os.path.join(tree[0], rel), shallow=False), rel
    root, _ = make_mini_nuscenes(tmp_path / "port", images_per_sample=True)
    jroot, _ = jmake(tmp_path / "jax", images_per_sample=True)
    assert _files(root) == _files(jroot)
    jpgs = [f for f in _files(root) if f.endswith(".jpg")]
    assert len(jpgs) == 6 * 3
    for rel in _files(root):
        a, b = os.path.join(root, rel), os.path.join(jroot, rel)
        if rel in jpgs:
            assert np.asarray(Image.open(a)).shape == \
                np.asarray(Image.open(b)).shape == (900, 1600, 3), rel
        else:
            assert filecmp.cmp(a, b, shallow=False), rel


def _assert_infos_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k, v in vars(w).items():
            mine = getattr(g, k)
            if isinstance(v, np.ndarray) and v.dtype.kind == "f":
                np.testing.assert_allclose(mine, v, rtol=0, atol=1e-9,
                                           err_msg=k)
            elif isinstance(v, np.ndarray):
                assert mine.dtype == v.dtype, k
                np.testing.assert_array_equal(mine, v, err_msg=k)
            else:
                assert mine == v, k


def test_index_matches_jax(indices, tmp_path):
    from magicdrive_tpu_torch.data.nuscenes import NuScenesIndex

    got, want = indices
    assert len(got.infos) == 3
    _assert_infos_equal(got.infos, want.infos)
    assert got.scene_of == want.scene_of
    assert got.scene_names == want.scene_names
    assert got.sample_data == want.sample_data
    got.save(str(tmp_path / "index.pkl"))
    back = NuScenesIndex.load(str(tmp_path / "index.pkl"))
    _assert_infos_equal(back.infos, want.infos)
    assert back.classes == want.classes


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "metas":
            assert got[k] == v
        elif k == "img":
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6)
        elif k == "bev_map" or np.asarray(v).dtype.kind != "f":
            assert got[k].dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-9,
                                       err_msg=k)


@pytest.mark.parametrize("backend", BACKENDS)
def test_dataset_samples_match_jax(tree, indices, backend, jax_native):
    got, want = _datasets(tree, indices, backend)
    assert len(got) == len(want) == 3
    for i in range(3):
        s = got[i]
        _assert_samples_equal(s, want[i])
    assert s["bev_map"].shape == (200, 200, 8 + 10 + 8)
    assert s["bev_map"][..., 8].sum() > 0  # a car in the object channels


def _quirk_map(root):
    """The hole and multi-part polygons of tests/test_nuscenes.py."""
    loc = "synth-quirks"
    os.makedirs(root / "maps" / "expansion", exist_ok=True)
    nodes = []

    def add_square(prefix, x0, y0, x1, y1):
        for i, (x, y) in enumerate([(x0, y0), (x1, y0), (x1, y1), (x0, y1)]):
            nodes.append({"token": f"{prefix}{i}", "x": float(x),
                          "y": float(y)})
        return [f"{prefix}{i}" for i in range(4)]

    outer = add_square("o", 900, 900, 1100, 1100)
    hole = add_square("h", 960, 960, 1040, 1040)
    part2 = add_square("q", 1150, 900, 1250, 1000)
    line = add_square("l", 950, 1000, 1050, 1010)[:2]
    map_json = {
        "node": nodes,
        "polygon": [
            {"token": "p0", "exterior_node_tokens": outer,
             "holes": [{"node_tokens": hole}]},
            {"token": "p1", "exterior_node_tokens": part2, "holes": []},
        ],
        "line": [{"token": "l0", "node_tokens": line}],
        "drivable_area": [{"token": "da0", "polygon_tokens": ["p0", "p1"]}],
        "ped_crossing": [], "walkway": [], "stop_line": [],
        "carpark_area": [], "road_block": [], "road_segment": [], "lane": [],
        "road_divider": [{"token": "rd0", "line_token": "l0"}],
        "lane_divider": [],
    }
    with open(root / "maps" / "expansion" / f"{loc}.json", "w") as f:
        json.dump(map_json, f)
    return loc


@pytest.mark.parametrize("backend", BACKENDS)
def test_map_hole_and_multipart_match_jax(tmp_path, backend, jax_native):
    from magicdrive_tpu.data.map_raster import NuScenesMapRaster as JMap

    from magicdrive_tpu_torch.data.map_raster import NuScenesMapRaster

    loc = _quirk_map(tmp_path)
    got_r = NuScenesMapRaster(str(tmp_path), loc, backend=backend)
    want_r = JMap(str(tmp_path), loc, backend=backend)
    for angle in (0.0, 33.0, 90.0):
        got = got_r.get_map_mask((1050, 1000, 400, 400), angle,
                                 ["drivable_area", "road_divider"],
                                 (400, 400))
        want = want_r.get_map_mask((1050, 1000, 400, 400), angle,
                                   ["drivable_area", "road_divider"],
                                   (400, 400))
        np.testing.assert_array_equal(got, want)
    first = got_r.get_map_mask((1050, 1000, 400, 400), 0.0,
                               ["drivable_area"], (400, 400))[0]
    assert first[100, 50] == 1 and first[200, 150] == 0  # the hole
    assert first[150, 350] == 1  # the second part


def test_raster_core_matches_jax(jax_native):
    """The port's build of its copy of the scanline core and the JAX
    package's library draw the same pixels and aux channels."""
    from magicdrive_tpu_torch.native import raster

    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 9))
        pts = rng.integers(-8, 40, (n, 2)).astype(np.int32)
        for fn in ("fill_polygon", "draw_polyline2"):
            got = np.zeros((32, 32), np.uint8)
            want = np.zeros((32, 32), np.uint8)
            getattr(raster, fn)(got, pts, 3)
            getattr(jax_native, fn)(want, pts, 3)
            np.testing.assert_array_equal(got, want)
    bc = rng.uniform(-5, 60, (12, 4, 2))
    vis, hgt = rng.uniform(0, 4, 12), rng.uniform(1, 3, 12)
    for flags in ((True, True, True, True), (False, True, False, True)):
        c = sum((1, 2, 4, 1)[i] for i, f in enumerate(flags) if f)
        got = np.zeros((50, 60, c), np.float32)
        want = np.zeros((50, 60, c), np.float32)
        raster.aux_channels(got, bc, vis, hgt, flags)
        jax_native.aux_channels(want, bc, vis, hgt, flags)
        np.testing.assert_array_equal(got, want)


def test_raster_backend_resolution():
    from magicdrive_tpu_torch.data.map_raster import resolve_raster_backend

    assert resolve_raster_backend("auto") == "native"  # g++ builds it here
    assert resolve_raster_backend("pil") == "pil"
    with pytest.raises(ValueError):
        resolve_raster_backend("cv2")


def test_bbox_geometry_matches_jax():
    from magicdrive_tpu.data import bbox as jb

    from magicdrive_tpu_torch.data import bbox as pb
    from magicdrive_tpu_torch.data.fixtures import camera_matrices

    rng = np.random.default_rng(1)
    boxes = np.concatenate([rng.uniform(-60, 60, (40, 2)),
                            rng.uniform(-2, 1, (40, 1)),
                            rng.uniform(1, 5, (40, 3)),
                            rng.uniform(-7, 7, (40, 1))], axis=1)
    K, _, l2c, l2i = camera_matrices()[1]
    aug = np.diag([0.5, 0.5, 1.0, 1.0])
    aug[:2, 3] = [-3, -7]
    for origin in ((0.5, 0.5, 0.0), (0.5, 0.5, 0.5)):
        np.testing.assert_array_equal(pb.corners_from_boxes(boxes, origin),
                                      jb.corners_from_boxes(boxes, origin))
    corners = jb.corners_from_boxes(boxes)
    pairs = [
        (pb.shift_origin(boxes), jb.shift_origin(boxes)),
        (pb.visible_mask_3d(corners, l2c), jb.visible_mask_3d(corners, l2c)),
        (pb.visible_mask_canvas(corners, l2i, aug, (224, 400)),
         jb.visible_mask_canvas(corners, l2i, aug, (224, 400))),
        (pb.project_to_image(corners, l2i, aug),
         jb.project_to_image(corners, l2i, aug)),
        (pb.project_to_image(corners, l2i), jb.project_to_image(corners, l2i)),
        (pb.in_range_bev(boxes, (-50, -50, 50, 50)),
         jb.in_range_bev(boxes, (-50, -50, 50, 50))),
        (pb.limit_yaw(boxes), jb.limit_yaw(boxes)),
        (pb.corners_from_boxes(np.zeros((0, 7))),
         jb.corners_from_boxes(np.zeros((0, 7)))),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got, want)
    sample = {"boxes": boxes, "labels": np.arange(40) % 10,
              "visibility": np.arange(40) % 4}
    got = pb.object_range_filter(sample, [-51.2, -51.2, -5, 51.2, 51.2, 3])
    want = jb.object_range_filter(sample, [-51.2, -51.2, -5, 51.2, 51.2, 3])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _assert_batches_equal(got, want):
    """Equal batches but for the stand-in tokenizers' word ids, which keep
    the same BOS/EOS framing."""
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if k in ("input_ids", "uncond_ids"):
            frame = np.isin(v, (49406, 49407))
            np.testing.assert_array_equal(got[k][frame], v[frame])
            assert not np.isin(got[k][~frame], (49406, 49407)).any()
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope="module")
def samples(tree, indices):
    return [_datasets(tree, indices, "pil")[1][i] for i in range(3)]


@pytest.mark.parametrize("mode", ["all-xyz", "cxyz"])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("filter3d", [True, False])
def test_collate_matches_jax(samples, mode, shared, filter3d):
    """Every box mode, view sharing and visibility filter (the canvas
    filter reads the images' augmentation), not in training."""
    from magicdrive_tpu.data.collate import CollateConfig as JCfg
    from magicdrive_tpu.data.collate import collate_fn as jcollate

    from magicdrive_tpu_torch.data.collate import CollateConfig, collate_fn

    kw = dict(bbox_mode=mode, bbox_max_len=3, bbox_view_shared=shared,
              use_3d_filter=filter3d, canvas_hw=(224, 400), is_train=False)
    got = collate_fn(samples, CollateConfig(**kw))
    want = jcollate(samples, JCfg(**kw))
    _assert_batches_equal(got, want)
    n_out = 1 if shared else 6
    assert got["bboxes"].shape == (3, n_out, 3, 8 if mode == "all-xyz" else 4,
                                   3)
    assert got["masks"].sum() > 0


def test_collate_training_draws_match_jax(samples):
    """The drop and add ratios take the same draws from the caller's
    generator, in the same order."""
    from magicdrive_tpu.data.collate import CollateConfig as JCfg
    from magicdrive_tpu.data.collate import collate_fn as jcollate

    from magicdrive_tpu_torch.data.collate import CollateConfig, collate_fn

    for drop, add in ((0.5, 0.0), (0.0, 0.5), (0.3, 0.7)):
        kw = dict(bbox_max_len=4, is_train=True, bbox_drop_ratio=drop,
                  bbox_add_ratio=add, bbox_add_num=2, use_3d_filter=False)
        for seed in range(4):
            got = collate_fn(samples, CollateConfig(**kw),
                             rng=np.random.default_rng(seed))
            want = jcollate(samples, JCfg(**kw),
                            rng=np.random.default_rng(seed))
            _assert_batches_equal(got, want)


def test_fixture_collate_matches_jax():
    """The fixture scenes carry lidar2image and img_aug_matrix as the JAX
    fixture's do, so every collate mode runs on them."""
    from magicdrive_tpu.data.collate import CollateConfig as JCfg
    from magicdrive_tpu.data.collate import collate_fn as jcollate
    from magicdrive_tpu.data.fixtures import make_sample as jmake

    from magicdrive_tpu_torch.data import CollateConfig, collate_fn
    from magicdrive_tpu_torch.data.fixtures import make_sample

    got_s = [make_sample(i) for i in range(2)]
    want_s = [jmake(i, with_images=False) for i in range(2)]
    for k in ("lidar2image", "img_aug_matrix"):
        np.testing.assert_array_equal(got_s[0][k], want_s[0][k])
    kw = dict(bbox_max_len=12, use_3d_filter=False, bbox_mode="cxyz")
    _assert_batches_equal(collate_fn(got_s, CollateConfig(**kw)),
                          jcollate(want_s, JCfg(**kw)))


def _clip_vocab(tmp_path):
    """A small vocab.json + merges.txt in the CLIP layout (the pattern of
    tests/test_data.py)."""
    from magicdrive_tpu.data.bpe import bytes_to_unicode

    base = list(bytes_to_unicode().values())
    vocab = base + [t + "</w>" for t in base]
    merges = ["d r", "dr i", "dri v", "driv i", "drivi n", "drivin g</w>",
              "s c", "sc e", "sce n", "scen e</w>", "a</w> t</w>",
              "i n</w>", "r a", "ra in</w>", "b o", "bo s", "bos t",
              "bost o", "bosto n</w>"]
    vocab += [m.replace(" ", "") for m in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    (tmp_path / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(vocab)}))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(merges) + "\n")
    return tmp_path


def test_bpe_matches_jax(tmp_path):
    from magicdrive_tpu.data.caption import load_clip_tokenizer as jload

    from magicdrive_tpu_torch.data.bpe import bytes_to_unicode
    from magicdrive_tpu_torch.data.caption import (load_clip_tokenizer,
                                                   tokenize_captions)

    from magicdrive_tpu.data.bpe import bytes_to_unicode as jbytes

    assert bytes_to_unicode() == jbytes()
    d = _clip_vocab(tmp_path)
    ours, theirs = load_clip_tokenizer(str(d)), jload(str(d))
    texts = ["A driving scene image at boston-seaport. Rain, driving in "
             "rain.", "", "Scene with  MIXED   Case & punctuation!!! 12 3",
             "naïve café — ünïcode ✓", "driving " * 60]
    np.testing.assert_array_equal(ours(texts), theirs(texts))
    for t in texts:
        assert ours.tokenize(t) == theirs.tokenize(t)
    assert ours.tokenize("driving") == ["driving</w>"]
    metas = [{"location": "boston-seaport", "description": "rain"}]
    ids, uncond = tokenize_captions(metas, ours)
    assert ids.shape == (1, 77) and uncond.shape == (1, 77)
    assert (uncond[0, 2:] == ours.eos_id).all()


def test_hash_tokenizer_framing_matches_jax():
    """The stand-ins agree on the framing; the port's word ids are the same
    in every process (CRC32)."""
    import zlib

    from magicdrive_tpu.data.caption import HashTokenizer as JHash

    from magicdrive_tpu_torch.data.caption import (HashTokenizer,
                                                   load_clip_tokenizer)

    texts = ["A driving scene image at singapore-onenorth. Parked cars.",
             "", "word " * 100]
    got, want = HashTokenizer()(texts), JHash()(texts)
    frame = np.isin(want, (49406, 49407))
    np.testing.assert_array_equal(got[frame], want[frame])
    assert got[0, 1] == zlib.crc32(b"a") % 49000 + 300
    assert isinstance(load_clip_tokenizer(None), HashTokenizer)


def test_viz_matches_jax(tree, indices):
    """The map, box and grid images equal the JAX package's as uint8."""
    from magicdrive_tpu.viz import box_viz as jbox
    from magicdrive_tpu.viz import img_utils as jimg
    from magicdrive_tpu.viz import map_viz as jmap

    from magicdrive_tpu_torch import viz

    s = _datasets(tree, indices, "pil")[1][0]
    names = ["drivable_area", "ped_crossing", "walkway", "stop_line",
             "carpark_area", "road_divider", "lane_divider", "road_block"]
    got = viz.visualize_map(s["bev_map"], names, CLASSES)
    want = jmap.visualize_map(s["bev_map"], names, CLASSES)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        viz.visualize_map(s["bev_map"].transpose(2, 0, 1), names,
                          channel_last=False, target_size=200),
        jmap.visualize_map(s["bev_map"].transpose(2, 0, 1), names,
                           channel_last=False, target_size=200))
    imgs = np.random.default_rng(2).uniform(0, 1, (6, 224, 400, 3))
    got = viz.draw_boxes_on_views(imgs, s["boxes"], s["labels"],
                                  s["lidar2image"], s["img_aug_matrix"],
                                  classes=CLASSES)
    want = jbox.draw_boxes_on_views(imgs, s["boxes"], s["labels"],
                                    s["lidar2image"], s["img_aug_matrix"],
                                    classes=CLASSES)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got != (imgs * 255).astype(np.uint8)).any()  # boxes drawn
    for oneline in (False, True):
        np.testing.assert_array_equal(
            viz.concat_6_views(got, oneline=oneline),
            jimg.concat_6_views(want, oneline=oneline))
    np.testing.assert_array_equal(viz.img_grid([got[0], got[1, :, :300]]),
                                  jimg.img_grid([want[0], want[1, :, :300]]))


def test_build_datasets_matches_jax(tree, jax_native, tmp_path):
    """nuScenes where the root holds the version (the maps rasterized by
    the native core, which "auto" picks in both packages), the fixture
    scenes elsewhere; a configured map cache read in both."""
    from magicdrive_tpu.config.loader import compose
    from tools.train import build_datasets as jbuild

    from magicdrive_tpu_torch.data.datasets import build_datasets

    cfgs = os.path.join(REPO, "configs")
    cfg = compose(cfgs, overrides=[f"dataset.dataset_root={tree[0]}",
                                   f"dataset.version={tree[1]}"])
    (got, got_val), (want, _) = build_datasets(cfg), jbuild(cfg)
    assert got is got_val and len(got) == len(want) == 3
    _assert_samples_equal(got[2], want[2])
    cfg = compose(cfgs, overrides=["dataset.dataset_root=/nonexistent",
                                   "exp=424x800"])
    got, want = build_datasets(cfg)[0], jbuild(cfg)[0]
    assert len(got) == len(want) == 32
    for i in (0, 31):
        assert set(got[i]) == set(want[i])
        for k, v in want[i].items():
            if k != "metas":
                np.testing.assert_array_equal(got[i][k], v, err_msg=k)
    assert got[0]["bev_map"].shape == (400, 400, 8)
    # a configured map cache (written by the JAX package) is read by both
    from magicdrive_tpu.data.cache import build_cache
    from magicdrive_tpu.data.map_raster import BEVRasterizer as JRas
    from magicdrive_tpu.data.nuscenes import NuScenesIndex as JIndex

    dc = cfg["dataset"]
    path = str(tmp_path / "cache.h5")
    build_cache(JIndex(tree[0], tree[1], classes=tuple(dc["object_classes"])),
                JRas(tree[0], classes=tuple(dc["map_classes"]),
                     object_classes=tuple(dc["object_classes"]),
                     aux_data=tuple(dc["aux_data"]), backend="auto"),
                path, progress=False)
    cfg = compose(cfgs, overrides=[
        f"dataset.dataset_root={tree[0]}", f"dataset.version={tree[1]}",
        f"dataset.cache_file.train={path}"])
    (got, _), (want, _) = build_datasets(cfg), jbuild(cfg)
    assert got.cache is not None and got.rasterizer is None
    _assert_samples_equal(got[1], want[1])
