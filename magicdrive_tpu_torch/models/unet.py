"""SD-v1.5 UNet with the multi-view (cross-view) attention (counterpart of
``models/unet.py``), NCHW, diffusers state_dict names.

The batch axis is (B * n_cam), or (B * F * n_cam) for the video model,
whose transformers regroup the frames; ControlNet residuals enter additively at the
skip connections and after the mid block
(ref:unet_2d_condition_multiview.py:464-473,487-488).

With ``gradient_checkpointing`` the down, up and mid blocks are the JAX
package's remat units (``nn.remat``): each recomputes its forward in the
backward when gradients are being taken. Under ``remat_policy`` "dots"
(``jax.checkpoint_policies.dots_saveable``) the outputs of matrix products,
convolutions and SDPA calls are kept and the rest recomputed; under "attn"
(``save_only_these_names("attn_out")``) only the output of every
attention's core is kept: the kernels' attention ops
(``kernels.autograd.ATTENTION_OPS``) and the SDPA calls, so the recompute
runs no attention again; under None everything is recomputed. The
kernels' ops and the feed-forward kernels are recomputed under "dots".
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from magicdrive_tpu_torch.config import UNetConfig
from magicdrive_tpu_torch.core.embeddings import get_timestep_embedding
from magicdrive_tpu_torch.core.resnet import (Downsample2D, GroupNorm,
                                              ResnetBlock2D, Upsample2D)
from magicdrive_tpu_torch.core.transformer import Transformer2DModel
from magicdrive_tpu_torch.kernels.autograd import ATTENTION_OPS
from magicdrive_tpu_torch.parallel.mesh import (frame_mesh, sharded_frames,
                                               sharded_views, view_mesh)


_aten = torch.ops.aten
# the SDPA calls, which stand for the JAX package's plain attention
_SDPA = frozenset((
    _aten._scaled_dot_product_flash_attention.default,
    _aten._scaled_dot_product_efficient_attention.default,
    _aten._scaled_dot_product_cudnn_attention.default,
    _aten._scaled_dot_product_flash_attention_for_cpu.default))
# the ops whose outputs "dots" keeps: JAX's dot_general and
# conv_general_dilated, and the SDPA calls that stand for its plain
# attention's dots
_DOTS = frozenset((
    _aten.mm.default, _aten.addmm.default, _aten.bmm.default,
    _aten.baddbmm.default, _aten.convolution.default)) | _SDPA
# the ops whose outputs "attn" keeps, where JAX tags each attention's
# output ``attn_out`` (core/attention.py, core/transformer.py): the core of
# every attention, a kernel's op or an SDPA call
_ATTN = frozenset(ATTENTION_OPS) | _SDPA


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def _attn_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _ATTN else \
        CheckpointPolicy.PREFER_RECOMPUTE


def remat_context(policy: Optional[str]):
    """``checkpoint``'s ``context_fn`` for a remat policy: None recomputes
    everything, "dots" keeps the products' outputs, "attn" the attention
    cores' outputs."""
    if policy is None:
        return None
    if policy in ("dots", "attn"):
        # looked up here, so that a caller that swaps a policy function
        # reaches the units built after it
        fn = _dots_policy if policy == "dots" else _attn_policy
        return functools.partial(create_selective_checkpoint_contexts, fn)
    raise ValueError(f"remat_policy {policy!r}: dots, attn or null")


def run_block(block: nn.Module, context_fn, *args):
    """``block(*args)``; as one remat unit (``context_fn``: None or
    ``remat_context``'s) where ``block`` is marked for it and gradients are
    being taken. The recompute runs under the meshes of the forward: on the
    card the backward runs in the autograd engine's thread, which does not
    see the caller's ``sharded_views`` / ``sharded_frames``."""
    if not (block.remat and torch.is_grad_enabled()):
        return block(*args)
    kw = {} if context_fn is None else {"context_fn": context_fn}
    views, frames = view_mesh(), frame_mesh()

    def unit(*a):
        with sharded_views(views), sharded_frames(frames):
            return block(*a)
    return checkpoint(unit, *args, use_reentrant=False, **kw)


def _transformer(cfg: UNetConfig, ch: int) -> Transformer2DModel:
    return Transformer2DModel(
        cfg.num_attention_heads, ch // cfg.num_attention_heads,
        cfg.cross_attention_dim, cfg.norm_num_groups,
        cfg.neighboring_view_pair, cfg.temporal_frames,
        cfg.neighboring_attn_type, cfg.zero_module_type)


class CrossAttnDownBlock(nn.Module):
    remat = False  # a remat unit (run_block)

    def __init__(self, cfg: UNetConfig, in_ch: int, out_ch: int,
                 has_attn: bool, add_downsample: bool):
        super().__init__()
        temb = cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, temb,
                          cfg.norm_num_groups)
            for i in range(cfg.layers_per_block)])
        self.attentions = nn.ModuleList([
            _transformer(cfg, out_ch) for _ in range(cfg.layers_per_block)
        ]) if has_attn else None
        self.downsamplers = nn.ModuleList([Downsample2D(out_ch)]) \
            if add_downsample else None

    def forward(self, x, temb, context):
        res = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            res.append(x)
        return x, res


class CrossAttnUpBlock(nn.Module):
    remat = False  # a remat unit (run_block)

    def __init__(self, cfg: UNetConfig, prev_ch: int, out_ch: int,
                 skip_chs: Sequence[int], has_attn: bool,
                 add_upsample: bool):
        super().__init__()
        temb = cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([
            ResnetBlock2D((prev_ch if i == 0 else out_ch) + skip, out_ch,
                          temb, cfg.norm_num_groups)
            for i, skip in enumerate(skip_chs)])
        self.attentions = nn.ModuleList([
            _transformer(cfg, out_ch) for _ in skip_chs
        ]) if has_attn else None
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch)]) \
            if add_upsample else None

    def forward(self, x, skips, temb, context,
                out_hw: Optional[Tuple[int, int]] = None):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips[i]], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, out_hw)
        return x


class UNetMidBlock(nn.Module):
    remat = False  # a remat unit (run_block)

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        ch = cfg.block_out_channels[-1]
        temb = cfg.block_out_channels[0] * 4
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ch, ch, temb, cfg.norm_num_groups)
            for _ in range(2)])
        self.attentions = nn.ModuleList([_transformer(cfg, ch)])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


def time_embed(module: TimestepEmbedding, timesteps: torch.Tensor,
               channels: int) -> torch.Tensor:
    """Sinusoidal embedding (fp32) then the MLP in the module's dtype."""
    t = get_timestep_embedding(timesteps, channels)
    return module(t.to(module.linear_1.weight.dtype))


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        boc = cfg.block_out_channels
        self.time_embedding = TimestepEmbedding(boc[0], boc[0] * 4)
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        skip_chs = [boc[0]]
        self.down_blocks = nn.ModuleList()
        for i, ch in enumerate(boc):
            final = i == len(boc) - 1
            self.down_blocks.append(CrossAttnDownBlock(
                cfg, boc[max(i - 1, 0)], ch, cfg.down_block_has_attn[i],
                add_downsample=not final))
            skip_chs += [ch] * (cfg.layers_per_block + (0 if final else 1))
        self.mid_block = UNetMidBlock(cfg)
        self.up_blocks = nn.ModuleList()
        prev = boc[-1]
        rev = list(reversed(boc))
        n_up = cfg.layers_per_block + 1
        for i, ch in enumerate(rev):
            skips = [skip_chs.pop() for _ in range(n_up)]
            self.up_blocks.append(CrossAttnUpBlock(
                cfg, prev, ch, skips, cfg.up_block_has_attn[i],
                add_upsample=i != len(rev) - 1))
            prev = ch
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, boc[0])
        self.conv_out = nn.Conv2d(boc[0], cfg.out_channels, 3, padding=1)
        self._remat_context = None
        if cfg.gradient_checkpointing:
            self._remat_context = remat_context(cfg.remat_policy)
            for block in (*self.down_blocks, self.mid_block,
                          *self.up_blocks):
                block.remat = True

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                down_block_additional_residuals: Optional[
                    Sequence[torch.Tensor]] = None,
                mid_block_additional_residual: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """sample (B*N, 4, h, w), timesteps (B*N,), encoder_hidden_states
        (B*N, L, d) -> eps (B*N, 4, h, w) float32."""
        dt = self.conv_in.weight.dtype
        temb = time_embed(self.time_embedding, timesteps,
                          self.cfg.block_out_channels[0])
        context = encoder_hidden_states.to(dt)
        x = self.conv_in(sample.to(dt))
        ctx_fn = self._remat_context
        skips = [x]
        for block in self.down_blocks:
            x, res = run_block(block, ctx_fn, x, temb, context)
            skips.extend(res)
        if down_block_additional_residuals is not None:
            skips = [s + r.to(dt) for s, r in
                     zip(skips, down_block_additional_residuals, strict=True)]
        x = run_block(self.mid_block, ctx_fn, x, temb, context)
        if mid_block_additional_residual is not None:
            x = x + mid_block_additional_residual.to(dt)
        n_up = self.cfg.layers_per_block + 1
        for block in self.up_blocks:
            block_skips = skips[-n_up:][::-1]  # consumption order
            skips = skips[:-n_up]
            out_hw = tuple(skips[-1].shape[2:]) if skips else None
            x = run_block(block, ctx_fn, x, block_skips, temb, context,
                          out_hw)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.float()
