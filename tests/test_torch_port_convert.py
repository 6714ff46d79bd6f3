"""The port's weight converter against the JAX package's
``tools/convert_weights.py``.

Synthetic released-checkpoint trees in the diffusers layout (SD-v1.5:
unet/, vae/ with the old ``query/key/value/proj_attn`` attention names,
text_encoder/ with transformers' ``position_ids``; MagicDrive: controlnet/,
unet/) hold the port's ``small_parity`` modules on seeded weights. Each
tensor is named by the JAX package's own key derivation
(``torch_weights._flax_path_to_torch_key`` and its CLIP prefixes) and laid
out by the inverse of its ``_transform``, so the names do not come from the
port. The trees are written as ``.bin`` (torch.save) and as
``.safetensors`` (with the UNet in F16), and both CLIs convert them:
  * ``magicdrive --sd15``: the two ``params.npz`` are equal leaf by leaf;
  * ``sd15``: equal outside the leaves both keep at their initial values
    (the ControlNet, the UNet's norm4/attn4/connector), which agree in
    shape and dtype;
  * a key dropped from a file fails strict mode in both, with the same
    exception, and both pass with ``--allow-missing``;
  * the JAX package's ``load_params`` reads the port's output.
The JAX tool's ``init_params`` is replaced by one ``jax.eval_shape`` of it
with seeded values, so that its conversion runs in seconds; the tool itself
is unchanged. The port's own safetensors reader is held to
``safetensors.numpy.load_file`` (F32, F16, I64, I32) and, for BF16, to
torch's values.
"""
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_port_modules import shaped

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULTIVIEW = ("norm4", "attn4", "connector")
OLD_VAE_NAMES = {".to_q.": ".query.", ".to_k.": ".key.", ".to_v.": ".value.",
                 ".to_out.0.": ".proj_attn."}


@pytest.fixture(scope="module")
def jax_init():
    """The JAX init tree of small_parity as seeded values on
    ``eval_shape``'s shapes."""
    from magicdrive_tpu.config.presets import init_params, small_parity

    preset = small_parity()
    modules = preset.modules()
    return shaped(jax.eval_shape(lambda k: init_params(preset, modules, k),
                                 jax.random.PRNGKey(0)),
                  np.random.RandomState(7))


@pytest.fixture()
def fast_jax_init(jax_init, monkeypatch):
    """The JAX tool's ``init_params`` returning a copy of ``jax_init``."""
    from magicdrive_tpu.config import presets

    monkeypatch.setattr(presets, "init_params", lambda *a, **k:
                        jax.tree_util.tree_map(np.copy, jax_init))


@pytest.fixture(scope="module")
def source():
    """The port's small_parity modules on seeded weights, as the JAX
    tree (``modules_to_jax_params``)."""
    from magicdrive_tpu_torch.config import small_parity
    from magicdrive_tpu_torch.convert import modules_to_jax_params
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules

    torch.manual_seed(11)
    modules = MagicDriveModules.create(small_parity(), device="cpu")
    with torch.no_grad():
        for _, mod in modules.items():
            for p in mod.parameters():
                p.add_(0.05 * torch.randn_like(p))
    return modules_to_jax_params(modules)


def _released(tree, clip=False):
    """One module's JAX tree as the released state dict: the JAX
    converter's key for each leaf, the inverse of its layout change."""
    from flax import traverse_util

    from magicdrive_tpu.convert import torch_weights as tw

    sd = {}
    for path, v in traverse_util.flatten_dict(tree).items():
        spath = tw._strip_collection(path)
        joined = "/".join(spath)
        key = tw._SPECIALS.get(joined) or (
            tw._clip_prefix_key(spath) if clip
            else tw._flax_path_to_torch_key(spath))
        v = np.asarray(v)
        if spath[-1] == "kernel":
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        elif joined == "uncond_cam":
            v = v.reshape(1, -1)  # Embedding(1, 21)
        sd[key] = np.ascontiguousarray(v)
    return sd


def _write(sd, path, fmt, dtype=np.float32):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sd = {k: v.astype(dtype) if v.dtype == np.float32 else v
          for k, v in sd.items()}
    if fmt == "safetensors":
        from safetensors.numpy import save_file

        save_file(sd, path + ".safetensors")
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   path + ".bin")


def _names(fmt):
    """(diffusers weights stem, transformers weights stem)."""
    return ("diffusion_pytorch_model",
            "model" if fmt == "safetensors" else "pytorch_model")


def write_sd15(src, root, fmt, drop=None):
    """An SD-v1.5 tree: the UNet without the multiview modules (F16 in
    safetensors, as the hub's fp16 variants), the VAE with its attention
    under the old names, CLIP with ``position_ids``."""
    diff, tf = _names(fmt)
    unet = {k: v for k, v in _released(src["unet"]).items()
            if not any(m in k for m in MULTIVIEW)}
    vae = {}
    for k, v in _released(src["vae"]).items():
        if ".attentions." in k:
            for new, old in OLD_VAE_NAMES.items():
                k = k.replace(new, old)
        vae[k] = v
    clip = _released(src["clip"], clip=True)
    clip["text_model.embeddings.position_ids"] = np.arange(77)[None]
    for sd in (unet, vae, clip):
        sd.pop(drop, None)
    _write(unet, os.path.join(root, "unet", diff), fmt,
           np.float16 if fmt == "safetensors" else np.float32)
    _write(vae, os.path.join(root, "vae", diff), fmt)
    _write(clip, os.path.join(root, "text_encoder", tf), fmt)
    return str(root)


def write_magicdrive(src, root, fmt, drop=None):
    diff, _ = _names(fmt)
    for name in ("controlnet", "unet"):
        sd = _released(src[name])
        sd.pop(drop, None)
        _write(sd, os.path.join(root, name, diff), fmt)
    return str(root)


def _run_both(tmp, argv):
    """Both CLIs on ``argv`` (their --out appended) -> (JAX out, port out)."""
    from tools import convert_weights as jcw

    from magicdrive_tpu_torch.cli import convert_weights as pcw

    outs = []
    for tag, main in (("jax", jcw.main), ("port", pcw.main)):
        out = str(tmp / tag)
        sd15 = argv[argv.index("--sd15") + 1] if "--sd15" in argv else None
        args = [a if a != sd15 else os.path.join(sd15, tag) for a in argv]
        main([*args, "--out", out, "--arch", "small-test"])
        outs.append(out)
    return outs


def _leaves(out):
    from magicdrive_tpu.utils.serialization import load_params

    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(
                load_params(out))}


def _at_init(key):
    return key.startswith("controlnet/") or any(m in key for m in MULTIVIEW)


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_convert_matches_jax(fmt, source, fast_jax_init, tmp_path):
    """sd15, then magicdrive --sd15, in both packages: the JAX package's
    load_params reads both outputs; magicdrive's are equal leaf by leaf,
    and sd15's outside the leaves left at their initial values."""
    sd_src = write_sd15(source, tmp_path / "sd15_src", fmt)
    md_src = write_magicdrive(source, tmp_path / "md_src", fmt)
    sd15 = tmp_path / "sd15"
    jax_sd, port_sd = _run_both(sd15, ["sd15", "--src", sd_src])
    want, got = _leaves(jax_sd), _leaves(port_sd)
    assert got.keys() == want.keys()
    with open(os.path.join(jax_sd, "manifest.json")) as f, \
            open(os.path.join(port_sd, "manifest.json")) as g:
        assert f.read() == g.read()
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        if not _at_init(k):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert sum(map(_at_init, want)) > 100

    jax_md, port_md = _run_both(tmp_path / "md", [
        "magicdrive", "--src", md_src, "--sd15", str(sd15)])
    want, got = _leaves(jax_md), _leaves(port_md)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    # the released values, not the initial ones
    flat = {f"{m}/{k}": v for m in ("unet", "controlnet")
            for k, v in _leaves_of(source[m]).items()}
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _leaves_of(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_leaves_of(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("mode, module, drop, error", [
    ("sd15", "unet", "down_blocks.1.resnets.0.conv1.weight", SystemExit),
    ("sd15", "vae", "encoder.mid_block.attentions.0.query.weight", KeyError),
    ("magicdrive", "controlnet", "bbox_embedder._class_tokens", KeyError),
])
def test_strict_mode_fails_where_jax_fails(mode, module, drop, error, source,
                                           fast_jax_init, tmp_path):
    """A key dropped from one file aborts both converters with the JAX
    tool's exception; with --allow-missing both convert, and agree
    outside the leaves left at their initial values and the dropped one."""
    from tools import convert_weights as jcw

    from magicdrive_tpu_torch.cli import convert_weights as pcw

    write = write_sd15 if mode == "sd15" else write_magicdrive
    src = write(source, tmp_path / "src", "bin", drop=drop)
    argv = [mode, "--src", src, "--arch", "small-test"]
    for main in (jcw.main, pcw.main):
        with pytest.raises(error):
            main([*argv, "--out", str(tmp_path / "x")])
    jax_out, port_out = _run_both(tmp_path, [mode, "--src", src,
                                             "--allow-missing"])
    want, got = _leaves(jax_out), _leaves(port_out)
    assert got.keys() == want.keys()
    differ = {k for k in want if not np.array_equal(got[k], want[k])}
    if mode == "sd15":
        differ = {k for k in differ if not _at_init(k)}
    else:  # the VAE and CLIP stay at init without --sd15
        differ = {k for k in differ if k.split("/")[0] in ("unet",
                                                            "controlnet")}
    assert len(differ) == 1 and next(iter(differ)).startswith(module), differ


def test_presets_of_the_image_size():
    """224x400 takes its preset, and every other size the 272x736 one, as
    the JAX tool chooses (424x800 included)."""
    from magicdrive_tpu_torch import config
    from magicdrive_tpu_torch.cli import convert_weights as pcw

    def name(*size):
        return pcw.preset_for(pcw.parse_args(
            ["sd15", "--src", "s", "--out", "o", "--image_size",
             *map(str, size)])).name

    assert name(224, 400) == config.sd15mv_rawbox_224x400().name
    assert name(272, 736) == name(424, 800) == \
        config.sd15mv_rawbox_272x736().name
    assert pcw.preset_for(pcw.parse_args(
        ["sd15", "--src", "s", "--out", "o", "--arch", "small-test"])
    ).name == "small-parity"


@pytest.mark.parametrize("dtype", ["float32", "float16", "int64", "int32"])
def test_safetensors_reader_matches_the_package(dtype, tmp_path):
    from safetensors.numpy import load_file, save_file

    from magicdrive_tpu_torch.torch_weights import load_torch_state_dict

    rs = np.random.RandomState(0)
    sd = {"a.weight": (rs.randn(3, 5, 2) * 100).astype(dtype),
          "b": (rs.randn(7) * 100).astype(dtype),
          "scalar": np.asarray(rs.randn() * 100).astype(dtype),
          "empty": np.zeros((0, 4), dtype)}
    path = str(tmp_path / "w.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    got, want = load_torch_state_dict(path), load_file(path)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_safetensors_reader_bf16(tmp_path):
    """BF16 tensors come back as float32 with torch's values, beside F32
    ones in the same file."""
    from safetensors.torch import save_file

    from magicdrive_tpu_torch.torch_weights import load_safetensors

    t = torch.randn(4, 9, generator=torch.Generator().manual_seed(0)) * 300
    save_file({"h": t.bfloat16(), "f": t}, str(tmp_path / "w.safetensors"))
    got = load_safetensors(str(tmp_path / "w.safetensors"))
    assert got["h"].dtype == np.float32
    np.testing.assert_array_equal(got["h"], t.bfloat16().float().numpy())
    np.testing.assert_array_equal(got["f"], t.numpy())


def test_normalize_vae_attention_keys_matches_jax():
    from magicdrive_tpu.convert import torch_weights as jtw

    from magicdrive_tpu_torch import torch_weights as ttw

    keys = ["encoder.mid_block.attentions.0.query.weight",
            "decoder.mid_block.attentions.0.proj_attn.bias",
            "decoder.mid_block.attentions.0.key.weight",
            "decoder.mid_block.resnets.0.conv1.weight",
            "decoder.mid_block.attentions.0.to_q.weight"]
    sd = {k: np.zeros(1) for k in keys}
    assert list(ttw.normalize_vae_attention_keys(sd)) == \
        list(jtw.normalize_vae_attention_keys(sd))


def test_find_weights_file_prefers_as_jax(tmp_path):
    from magicdrive_tpu.convert import torch_weights as jtw

    from magicdrive_tpu_torch import torch_weights as ttw

    for name in ("pytorch_model.bin", "diffusion_pytorch_model.bin",
                 "diffusion_pytorch_model.safetensors"):
        (tmp_path / name).write_bytes(b"")
        assert ttw.find_weights_file(str(tmp_path)) == \
            jtw.find_weights_file(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ttw.find_weights_file(str(tmp_path / "none"))


def test_chip_smoke_trees_convert(tmp_path):
    """``chip_smoke.write_released_trees`` (its safetensors writer among
    them) makes trees that the converter turns back into the modules,
    bitwise, and that the safetensors package reads as written."""
    import sys

    from safetensors.numpy import load_file

    from magicdrive_tpu_torch.cli import convert_weights
    from magicdrive_tpu_torch.config import small_parity
    from magicdrive_tpu_torch.convert import (iter_leaves,
                                              modules_to_jax_params)
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.utils.serialization import load_params

    sys.path.insert(0, REPO)
    import chip_smoke

    torch.manual_seed(3)
    modules = MagicDriveModules.create(small_parity(), device="cpu")
    sizes = chip_smoke.write_released_trees(modules, str(tmp_path / "rel"))
    assert set(sizes) == {"sd15", "magicdrive"}
    unet = load_file(str(tmp_path / "rel/magicdrive/unet/"
                         "diffusion_pytorch_model.safetensors"))
    for k, v in modules.unet.state_dict().items():
        np.testing.assert_array_equal(unet[k], v.numpy(), err_msg=k)
    convert_weights.main(["sd15", "--src", str(tmp_path / "rel/sd15"),
                          "--out", str(tmp_path / "sd15"), "--arch",
                          "small-test"])
    convert_weights.main(["magicdrive", "--src",
                          str(tmp_path / "rel/magicdrive"), "--sd15",
                          str(tmp_path / "sd15"), "--out",
                          str(tmp_path / "w"), "--arch", "small-test"])
    got = dict(iter_leaves(load_params(str(tmp_path / "w"))))
    want = dict(iter_leaves(modules_to_jax_params(modules)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=str(k))
