"""The port's evaluation layer and host data against the JAX package:
``eval/inception.py``, ``eval/fid.py``, ``data/loader.py``,
``ListSetWrapper`` and ``data/torch_fixtures.py``.

The Inception network has random conv weights and random batch-norm
affines and running statistics (as ``tests/test_inception_convert.py``
makes them), saved with pytorch-fid's key set (the ``fc`` layer and the
batch norms' step counters included). The JAX package's
``convert_torch_inception`` of that state dict and its flax
``InceptionV3Pool3`` give the pool3 features that the port's module,
loaded from the same file, must give to POOL3_TOL. One JAX jit of the
Inception forward in the file. The Fréchet distance, the crop, the
pairing, the loader's batches and the demo fixtures are compared exactly.
Both FID CLIs score a generated tree against a synthetic nuScenes tree's
JPEGs (``tokens``) and two image directories (``paths``) with a second
random Inception file, its convolutions at sqrt(2 / fan_in) so that the
features of a few images differ and both packages' FIDs are finite; they
agree to FID_RTOL. Each FID takes scipy's sqrtm of a 2048 x 2048 product,
about 10 s on the CPU.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(1)

# pool3 features: |port - JAX| <= POOL3_TOL * max(mean|JAX|, 1), and rtol
# POOL3_TOL (fp32 on both sides; 94 convolutions deep)
POOL3_TOL = 2e-4
# FID of a handful of 2048-d features: the covariances are singular, so
# the features' fp32 differences move sqrtm's near-zero eigenvalues;
# relative tolerance of the two packages' FIDs
FID_RTOL = 1e-4


def _randomize(model, seed=0, std=0.08):
    """Random conv weights and batch-norm fields, every field non-trivial;
    ``std=None`` scales each conv by sqrt(2 / fan_in), so that the
    features stay of order 1 through the 94 convolutions and differ from
    image to image."""
    from magicdrive_tpu_torch.eval.inception import FrozenBatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                torch.nn.init.normal_(
                    m.weight, generator=g,
                    std=std or (2 / m.weight[0].numel()) ** 0.5)
            elif isinstance(m, FrozenBatchNorm):
                m.weight.uniform_(0.7, 1.3, generator=g)
                m.bias.uniform_(-0.1, 0.1, generator=g)
                m.running_mean.uniform_(-0.2, 0.2, generator=g)
                m.running_var.uniform_(0.6, 1.4, generator=g)


def pytorch_fid_state_dict(seed=0, std=0.08):
    """A randomized network's state dict under pytorch-fid's key set:
    with each batch norm's ``num_batches_tracked`` and the ``fc`` layer."""
    from magicdrive_tpu_torch.eval.inception import InceptionV3Pool3

    model = InceptionV3Pool3()
    _randomize(model, seed, std)
    sd = dict(model.state_dict())
    for k in [k for k in sd if k.endswith(".bn.running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = \
            torch.tensor(7)
    sd["fc.weight"] = torch.randn(1008, 2048) * 0.01
    sd["fc.bias"] = torch.zeros(1008)
    return sd


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("inception") / "pt_inception.pth")
    torch.save(pytorch_fid_state_dict(), path)
    return path


@pytest.fixture(scope="module")
def jax_pool3(weights):
    """The JAX package's pool3 features of two images, and the images."""
    from magicdrive_tpu.eval.inception import (InceptionV3Pool3,
                                               convert_torch_inception)

    sd = torch.load(weights, weights_only=True)
    variables = convert_torch_inception({k: v.numpy() for k, v in sd.items()})
    x = np.random.default_rng(0).random((2, 299, 299, 3), dtype=np.float32)
    feats = np.asarray(jax.jit(InceptionV3Pool3().apply)(
        variables, jnp.asarray(x)))
    return x, feats, variables


def _close_pool3(got, want):
    scale = max(float(np.abs(want).mean()), 1.0)
    np.testing.assert_allclose(got, want, rtol=POOL3_TOL,
                               atol=POOL3_TOL * scale)


def test_pool3_matches_jax(weights, jax_pool3):
    """The port's network from the pytorch-fid file gives JAX's features;
    the features are not degenerate."""
    from magicdrive_tpu_torch.eval.inception import load_inception

    x, want, _ = jax_pool3
    model = load_inception(weights, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert want.std() > 1e-3 and np.abs(want[0] - want[1]).max() > 1e-3
    _close_pool3(got, want)


def test_state_dict_from_jax_variables(jax_pool3):
    """The helper maps JAX's variables (params and batch_stats) onto the
    module, which then gives JAX's features."""
    from magicdrive_tpu_torch.eval.inception import (InceptionV3Pool3,
                                                     state_dict_from_jax)

    x, want, variables = jax_pool3
    model = InceptionV3Pool3().eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        _close_pool3(model(torch.from_numpy(x)).numpy(), want)


def test_pytorch_fid_key_set_loads(tmp_path):
    """Every key of the module is in pytorch-fid's set; only its fc keys
    (and the step counters) go unused. A file short of one key raises."""
    from magicdrive_tpu_torch.eval.inception import (InceptionV3Pool3,
                                                     load_inception)

    sd = pytorch_fid_state_dict(1)
    res = InceptionV3Pool3().load_state_dict(sd, strict=False)
    assert res.missing_keys == []
    assert {k for k in res.unexpected_keys
            if not k.endswith("num_batches_tracked")} == {"fc.weight",
                                                          "fc.bias"}
    assert sum(k.endswith(".conv.weight") for k in sd) == 94
    del sd["Mixed_7c.branch_pool.bn.running_mean"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="running_mean"):
        load_inception(str(tmp_path / "short.pth"), device="cpu")


def test_inception_defaults_to_the_card(monkeypatch):
    from magicdrive_tpu_torch.eval.inception import load_inception

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        load_inception()


def _gaussians(n, d, seed):
    f = np.random.default_rng(seed).normal(size=(n, d))
    return f.mean(0), np.cov(f, rowvar=False)


@pytest.mark.parametrize("n", [40, 6])
def test_frechet_distance_matches_jax(n):
    """Full-rank covariances, and singular ones (6 samples in 16 dims)."""
    from magicdrive_tpu.eval.fid import calculate_frechet_distance as jfd

    from magicdrive_tpu_torch.eval.fid import calculate_frechet_distance

    a, b = _gaussians(n, 16, 0), _gaussians(n, 16, 1)
    assert calculate_frechet_distance(*a, *b) == jfd(*a, *b)
    assert abs(calculate_frechet_distance(*a, *a)) < 1e-6


def test_frechet_distance_eps_retry_and_imaginary_check(monkeypatch):
    """Where sqrtm returns a non-finite product both retry with eps on the
    diagonal; where its diagonal keeps an imaginary part past 1e-3 both
    raise."""
    import scipy.linalg

    from magicdrive_tpu.eval.fid import calculate_frechet_distance as jfd

    from magicdrive_tpu_torch.eval.fid import calculate_frechet_distance

    real = scipy.linalg.sqrtm
    a, b = _gaussians(40, 8, 2), _gaussians(40, 8, 3)
    for fd in (calculate_frechet_distance, jfd):
        calls = []

        def first_nan(m, calls=calls):
            calls.append(m.copy())
            return np.full_like(m, np.nan) if len(calls) == 1 else real(m)

        monkeypatch.setattr(scipy.linalg, "sqrtm", first_nan)
        got = fd(*a, *b)
        assert len(calls) == 2
        np.testing.assert_allclose(
            calls[1], (a[1] + 1e-6 * np.eye(8)).dot(b[1] + 1e-6 * np.eye(8)))
        if fd is jfd:
            assert got == want
        want = got
        monkeypatch.setattr(scipy.linalg, "sqrtm",
                            lambda m: real(m) + 1e-2j * np.eye(len(m)))
        with pytest.raises(ValueError, match="Imaginary component"):
            fd(*a, *b)
        monkeypatch.setattr(scipy.linalg, "sqrtm",
                            lambda m: real(m) + 1e-4j * np.eye(len(m)))
        assert np.isfinite(fd(*a, *b))


def test_top_center_crop_matches_jax():
    from magicdrive_tpu.eval.fid import top_center_crop as jcrop

    from magicdrive_tpu_torch.eval.fid import top_center_crop

    img = Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (450, 800, 3), np.uint8))
    got, want = top_center_crop(img), jcrop(img)
    assert got.size == want.size == (1600, 892)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(scope="module")
def mini_tree(tmp_path_factory):
    """The JAX and the port index of a synthetic nuScenes tree (the JAX
    package's), a generated tree named after its image stems, the tree's
    root and version."""
    from magicdrive_tpu.data.nuscenes import NuScenesIndex as JIndex
    from magicdrive_tpu.data.synth import make_mini_nuscenes

    from magicdrive_tpu_torch.data.nuscenes import NuScenesIndex

    base = tmp_path_factory.mktemp("fid")
    root, version = make_mini_nuscenes(base / "nuscenes", n_samples=4)
    jindex, index = JIndex(root, version), NuScenesIndex(root, version)
    gen = base / "gen"
    (gen / "sub").mkdir(parents=True)
    rng = np.random.default_rng(1)
    for k, info in enumerate(index.infos[:3]):
        for path in info.image_paths[:5]:
            stem = os.path.splitext(os.path.basename(path))[0]
            for sfx in ("_gen0", "_gen1"):
                Image.fromarray(rng.integers(0, 255, (8, 16, 3), np.uint8)
                                ).save(gen / ("sub" if k else "") /
                                       f"{stem}{sfx}.png")
    (gen / "notes.txt").write_text("not an image")
    return jindex, index, str(gen), root, version


@pytest.mark.parametrize("ratio, suffixes", [
    (1.0, ("_gen0",)), (0.5, ("_gen0", "_gen1")), (0.3, ("_gen1",))])
def test_pair_real_generated_matches_jax(mini_tree, ratio, suffixes):
    from magicdrive_tpu.eval.fid import pair_real_generated as jpair

    from magicdrive_tpu_torch.eval.fid import pair_real_generated

    jindex, index, gen = mini_tree[:3]
    got = pair_real_generated(index, gen, ratio, suffixes)
    assert got == jpair(jindex, gen, ratio, suffixes)
    assert len(got[0]) > 0


def test_list_images_matches_jax(mini_tree):
    from magicdrive_tpu.eval.fid import list_images as jlist

    from magicdrive_tpu_torch.eval.fid import list_images

    gen = mini_tree[2]
    assert list_images(gen) == jlist(gen)
    assert len(list_images(gen)) == 20  # the tree reuses a file per camera


@pytest.mark.parametrize("drop_last, batch_size",
                         [(False, 4), (True, 4), (False, 3)])
def test_loader_batches_match_jax(drop_last, batch_size):
    """The port's DataLoader over the port's fixture scenes gives the JAX
    loader's batches (shuffle off) over the JAX fixture scenes, in the same
    order, on each of two passes; len() agrees. The JAX loader is handed
    the port's stand-in tokenizer (crc32 word ids; JAX's hashes words with
    Python's salted ``hash``), so every key is compared exactly."""
    from magicdrive_tpu.data.collate import CollateConfig as JCfg
    from magicdrive_tpu.data.fixtures import make_dataset as jmake
    from magicdrive_tpu.data.loader import DataLoader as JLoader

    from magicdrive_tpu_torch.data import CollateConfig, make_dataset
    from magicdrive_tpu_torch.data.caption import HashTokenizer
    from magicdrive_tpu_torch.data.loader import DataLoader

    kw = dict(batch_size=batch_size, num_workers=2, drop_last=drop_last)
    port = DataLoader(make_dataset(7, with_images=True),
                      cfg=CollateConfig(bbox_max_len=8), **kw)
    ref = JLoader(jmake(7), cfg=JCfg(bbox_max_len=8), shuffle=False,
                  tokenizer=HashTokenizer(), **kw)
    assert len(port) == len(ref)
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_loader_raises_a_worker_error():
    from magicdrive_tpu_torch.data import CollateConfig
    from magicdrive_tpu_torch.data.loader import DataLoader

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise IndexError(f"sample {i}")

    with pytest.raises(IndexError, match="sample"):
        list(DataLoader(Broken(), 2, CollateConfig()))


@pytest.mark.parametrize("count", [1, 3, 4])
def test_shard_for_process_matches_jax(count):
    from magicdrive_tpu.data.loader import shard_for_process as jshard

    from magicdrive_tpu_torch.data.loader import shard_for_process

    shards = [shard_for_process(range(10), i, count) for i in range(count)]
    assert shards == [jshard(range(10), i, count) for i in range(count)]
    assert sorted(sum(shards, [])) == list(range(10))


def test_list_set_wrapper_matches_jax():
    from magicdrive_tpu.data.nuscenes import ListSetWrapper as J

    from magicdrive_tpu_torch.data.nuscenes import ListSetWrapper

    data = [{"i": i} for i in range(6)]
    got, want = ListSetWrapper(data, [4, 1, 4]), J(data, [4, 1, 4])
    assert len(got) == len(want) == 3
    assert [got[i] for i in range(3)] == [want[i] for i in range(3)]


def _demo_pth(path, seed=0):
    """A demo fixture ``.pth`` as tests/test_nuscenes.py writes one."""
    rs = np.random.RandomState(seed)
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 316.0
    K[0, 2], K[1, 2] = 200, 112
    l2c = np.stack([np.eye(4)] * 6)
    l2c[:, :3, 3] = rs.randn(6, 3)
    raw = {
        "img": torch.from_numpy(rs.rand(6, 3, 224, 400).astype(np.float32)),
        "gt_bboxes_3d": torch.from_numpy(rs.randn(5, 9)),
        "gt_labels_3d": torch.from_numpy(rs.randint(0, 10, 5)),
        "gt_masks_bev": torch.from_numpy(
            (rs.rand(8, 200, 200) > 0.5).astype(np.uint8)),
        "camera_intrinsics": torch.from_numpy(np.stack([K] * 6)),
        "lidar2camera": torch.from_numpy(l2c),
        "img_aug_matrix": torch.from_numpy(np.stack([np.eye(4)] * 6)),
        "metas": {"location": "boston-seaport", "description": "demo",
                  "token": f"tok{seed}", "timeofday": ""},
    }
    if seed:
        raw["gt_bboxes_3d"] = torch.zeros(0, 9)
        raw["gt_labels_3d"] = torch.zeros(0, dtype=torch.long)
        del raw["metas"]
    torch.save(raw, path)


def test_folder_set_wrapper_matches_jax(tmp_path):
    """Each sample of a folder of demo fixtures equals JAX's, field by
    field (one with boxes and metas, one with neither)."""
    from magicdrive_tpu.data.torch_fixtures import FolderSetWrapper as J

    from magicdrive_tpu_torch.data.torch_fixtures import FolderSetWrapper

    _demo_pth(tmp_path / "a.pth", 0)
    _demo_pth(tmp_path / "b.pth", 1)
    got, want = FolderSetWrapper(str(tmp_path)), J(str(tmp_path))
    assert got.files == want.files and len(got) == 2
    for i in range(2):
        g, w = got[i], want[i]
        assert g.keys() == w.keys()
        assert g.pop("metas") == w.pop("metas")
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[0]["img"].shape == (6, 224, 400, 3)
    assert got[1]["boxes"].shape == (0, 7)
    with pytest.raises(FileNotFoundError):
        FolderSetWrapper(str(tmp_path / "none"))


@pytest.fixture(scope="module")
def fid_weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fidw") / "pt_inception.pth")
    torch.save(pytorch_fid_state_dict(3, std=None), path)
    return path


def _fid_both(argv, capsys):
    """(JAX's FID, the port's FID, the port's printed lines)."""
    from tools import fid as jfid

    from magicdrive_tpu_torch.cli import fid

    want = jfid.main(argv)
    capsys.readouterr()
    got = fid.main(argv, device="cpu")
    return want, got, capsys.readouterr().out


def test_fid_tokens_mode_matches_jax(mini_tree, fid_weights, capsys):
    """The generated tree against the tree's JPEGs (resized and top-center
    cropped): the same pairs, the same FID."""
    gen, root, version = mini_tree[2:]
    argv = ["tokens", "--dataroot", root, "--version", version,
            "--gen_root", gen, "--weights", fid_weights, "--batch_size", "8"]
    want, got, out = _fid_both(argv, capsys)
    assert "paired 20 real/generated images" in out
    assert np.isfinite(want) and want > 1
    np.testing.assert_allclose(got, want, rtol=FID_RTOL)


def test_fid_paths_mode_matches_jax(mini_tree, fid_weights, tmp_path,
                                    capsys):
    """Two directories, the real images cropped (a directory against
    itself: ``run_evaluation`` on the card and, for the distance alone,
    test_frechet_distance_matches_jax)."""
    real = tmp_path / "real"
    real.mkdir()
    rng = np.random.default_rng(4)
    for i in range(7):
        Image.fromarray(rng.integers(0, 255, (90, 160, 3), np.uint8)).save(
            real / f"{i}.jpg")
    gen = os.path.join(mini_tree[2], "sub")
    argv = ["paths", str(real), gen, "--weights", fid_weights,
            "--batch_size", "4"]
    want, got, _ = _fid_both(argv, capsys)
    assert np.isfinite(want) and want > 1
    np.testing.assert_allclose(got, want, rtol=FID_RTOL)
