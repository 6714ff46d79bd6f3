"""Convert released torch checkpoints into a run's weights (counterpart of
``tools/convert_weights.py``).

    # Stable Diffusion v1.5 (diffusers layout: unet/ vae/ text_encoder/)
    python -m magicdrive_tpu_torch.cli.convert_weights sd15 \\
        --src /path/to/sd15 --out weights/sd15

    # the MagicDrive release (controlnet/ and unet/ from save_pretrained)
    python -m magicdrive_tpu_torch.cli.convert_weights magicdrive \\
        --src /path/to/ckpt --sd15 weights/sd15 --out RUN/weights

Writes ``params.npz`` + ``manifest.json`` (``utils.serialization``) of the
JAX package's tree (``convert.modules_to_jax_params``), which both packages
load. As in the JAX tool:
  * ``--image_size 224 400`` takes the 224x400 preset and every other size
    the 272x736 one (424x800 too); ``--arch small-test`` the narrow
    full-depth ``small_parity``;
  * ``sd15`` fills the UNet, the VAE and CLIP; the ControlNet and the
    UNet's cross-view ``norm4``/``attn4``/``connector``, which SD-v1.5 lacks,
    keep their initial values (the port's own initialisation, not the JAX
    package's ``PRNGKey(0)`` draw);
  * ``magicdrive`` fills the ControlNet and the UNet, and takes the VAE and
    CLIP from a converted ``--sd15`` directory (else they keep their
    initial values);
  * strict by default: a key of a module that its file lacks aborts
    (``--allow-missing`` keeps such weights at their initial values).

Host work only: the modules are built on the CPU in fp32 and no device is
touched.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from magicdrive_tpu_torch import config
from magicdrive_tpu_torch.convert import (module_state_dict,
                                          modules_to_jax_params)
from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
from magicdrive_tpu_torch.torch_weights import (convert_module,
                                                find_weights_file,
                                                load_torch_state_dict,
                                                normalize_vae_attention_keys)
from magicdrive_tpu_torch.utils.serialization import (load_params,
                                                      save_params)

# the UNet's multiview additions, which SD-v1.5 does not have
MULTIVIEW = ("norm4", "attn4", "connector")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m magicdrive_tpu_torch.cli.convert_weights",
        description="Convert released torch checkpoints to run weights.")
    p.add_argument("mode", choices=["sd15", "magicdrive"])
    p.add_argument("--src", required=True)
    p.add_argument("--sd15", default=None,
                   help="converted SD-v1.5 dir (for frozen vae/clip reuse)")
    p.add_argument("--out", required=True)
    p.add_argument("--image_size", type=int, nargs=2, default=(224, 400))
    p.add_argument("--arch", choices=["auto", "small-test"], default="auto",
                   help="'small-test' = narrow full-depth architecture for "
                        "the converter's self-test")
    p.add_argument("--allow-missing", action="store_true")
    return p.parse_args(argv)


def preset_for(args: argparse.Namespace) -> config.ModelPreset:
    if args.arch == "small-test":
        return config.small_parity()
    if tuple(args.image_size) == (224, 400):
        return config.sd15mv_rawbox_224x400()
    return config.sd15mv_rawbox_272x736()


def _state_dict(src: str, part: str):
    return load_torch_state_dict(find_weights_file(os.path.join(src, part)))


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = parse_args(argv)
    modules = MagicDriveModules.create(preset_for(args), device="cpu")
    strict = not args.allow_missing
    if args.mode == "sd15":
        missing = convert_module(modules.unet, _state_dict(args.src, "unet"),
                                 strict=False)
        real = [k for k in missing if not any(s in k for s in MULTIVIEW)]
        if strict and real:
            raise SystemExit(f"unet conversion missing: {real[:8]}")
        convert_module(modules.vae, normalize_vae_attention_keys(
            _state_dict(args.src, "vae")), strict=strict)
        convert_module(modules.clip, _state_dict(args.src, "text_encoder"),
                       strict=strict)
    else:
        if args.sd15:
            base = load_params(args.sd15)
            for name in ("vae", "clip"):
                convert_module(getattr(modules, name), module_state_dict(
                    base[name], clip=name == "clip"))
        convert_module(modules.controlnet,
                       _state_dict(args.src, "controlnet"), strict=strict)
        convert_module(modules.unet, _state_dict(args.src, "unet"),
                       strict=strict)
    save_params(modules_to_jax_params(modules), args.out)
    print(f"converted -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
