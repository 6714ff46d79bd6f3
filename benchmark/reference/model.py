"""The plain reference of the MagicDrive multi-view model: the SD-v1.5 UNet
with the cross-view attention, the BEV ControlNet with its camera, box and
map embedders, the SD-v1.5 VAE and the CLIP ViT-L/14 text encoder.

Plain PyTorch in float32: every attention is softmax(q k^T) v written out
in matrix products, every feed-forward two ``F.linear`` calls, nothing
fused. Module and parameter names follow the diffusers / transformers
state_dict names of the released checkpoints, so one state dict of seeded
weights loads into this model and into the system under test alike.

The control of the benchmark's comparison runs this same model with every
matrix product's operands rounded to float8 e4m3 (``lower_precision``):
the step below bfloat16.
"""
from __future__ import annotations

import contextlib
import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# the logits one attention chunk may hold (bytes of float32)
LOGIT_BYTES = 1 << 31

_QUANT = {"dtype": None}
# a fault planted in the transformer attentions' heads (``planted``)
_FAULT = {"heads": None}
# keys per tile of the "mispaired" fault
TILE = 64
# with a list under "calls", every transformer attention appends its
# shapes: ("attn", B, Lq, C, Lk, Ck, inner, self-attention) or ("pair",
# B, L, C, k, inner)
ATTENTION_LOG = {"calls": None}


def _log(*call):
    if ATTENTION_LOG["calls"] is not None:
        ATTENTION_LOG["calls"].append(call)



@contextlib.contextmanager
def lower_precision(dtype=torch.float8_e4m3fn):
    """Round every matrix product's operands to ``dtype`` (per-tensor
    scale to its largest value), the accumulation staying float32."""
    old = _QUANT["dtype"]
    _QUANT["dtype"] = dtype
    try:
        yield
    finally:
        _QUANT["dtype"] = old


@contextlib.contextmanager
def planted(fault: str):
    """A fault in the heads of every UNet and ControlNet attention (attn1,
    attn2, attn4), as a broken heads kernel would make it: "mispaired"
    pairs each key with the next key's value within tiles of ``TILE``
    keys; "flat" drops the scores, so each query takes the mean value."""
    assert fault in ("mispaired", "flat"), fault
    old = _FAULT["heads"]
    _FAULT["heads"] = fault
    try:
        yield
    finally:
        _FAULT["heads"] = old


def _heads(q, k, v, heads: int, scale: float):
    """``attention`` of a transformer block, with the planted fault."""
    fault = _FAULT["heads"]
    if fault == "flat":
        scale = 0.0
    elif fault == "mispaired":
        i = torch.arange(k.shape[1], device=k.device)
        start = i // TILE * TILE
        size = (k.shape[1] - start).clamp(max=TILE)
        k = k[:, start + (i - start + 1) % size]
    return attention(q, k, v, heads, scale)


def _round(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``t`` through ``dt`` at a per-tensor scale that maps its largest
    magnitude to the format's largest value."""
    top = torch.finfo(dt).max
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dt).to(t.dtype) * scale


class _Q8(torch.autograd.Function):
    """float8 e4m3 forward, its gradient rounded to e5m2: the usual
    recipe of float8 training."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, _QUANT["dtype"])

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def q8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the lower precision when one is set, else ``t``."""
    return t if _QUANT["dtype"] is None else _Q8.apply(t)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(q8(x), q8(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(q8(x), q8(self.weight), self.bias)


def attention(q, k, v, heads: int, scale: float, causal: bool = False):
    """(B, Lq, H*D), (B, Lk, H*D) -> (B, Lq, H*D): softmax(q k^T scale) v
    per head, in slices of the batch whose logits fit LOGIT_BYTES."""
    B, Lq, HD = q.shape
    Lk = k.shape[1]
    split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, -1
                                ).transpose(1, 2)
    step = max(1, LOGIT_BYTES // (4 * heads * Lq * Lk))
    outs = []
    for i in range(0, B, step):
        qh, kh, vh = (split(t[i:i + step]) for t in (q, k, v))
        s = (q8(qh) @ q8(kh).transpose(-1, -2)) * scale
        if causal:
            s = s.masked_fill(torch.ones(Lq, Lk, dtype=torch.bool,
                                         device=s.device).triu(1),
                              float("-inf"))
        o = q8(s.softmax(-1)) @ q8(vh)
        outs.append(o.transpose(1, 2).reshape(-1, Lq, HD))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


# ----------------------------------------------------------------------------
# embeddings


def fourier_embed(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[x, sin(x f0), cos(x f0), sin(x f1), ...] over the last axis,
    f_i = 2**i."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]
    sc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)
    return torch.cat([x, sc.reshape(*x.shape[:-1], -1)], dim=-1)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """SD-v1.5's sinusoidal embedding: [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    e = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(e), torch.sin(e)], dim=-1)


# ----------------------------------------------------------------------------
# blocks


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, temb=None, groups=32, eps=1e-5):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = Linear(temb, cout) if temb else None
        self.norm2 = nn.GroupNorm(groups, cout, eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x, out_hw=None):
        out_hw = out_hw or (2 * x.shape[2], 2 * x.shape[3])
        return self.conv(F.interpolate(x, size=tuple(out_hw),
                                       mode="nearest"))


class Attention(nn.Module):
    def __init__(self, dim, heads, dim_head, kv_dim=None, qkv_bias=False):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.scale = heads, dim_head ** -0.5
        self.to_q = Linear(dim, inner, bias=qkv_bias)
        self.to_k = Linear(kv_dim or dim, inner, bias=qkv_bias)
        self.to_v = Linear(kv_dim or dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([Linear(inner, dim)])

    def heads_of(self, x, ctx):
        return _heads(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                      self.heads, self.scale)

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        _log("attn", x.shape[0], x.shape[1], x.shape[2], ctx.shape[1],
             ctx.shape[2], self.to_q.weight.shape[0], ctx is x)
        return self.to_out[0](self.heads_of(x, ctx))


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  Linear(4 * dim, dim)])

    def forward(self, x):
        h, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](h * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    """attn1 (self), attn2 (text and boxes), attn4 (cross-view, through
    the connector linear), GEGLU feed-forward; each pre-normed and
    residual."""

    def __init__(self, dim, heads, d_head, ctx_dim, neighbors=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, d_head)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, d_head, ctx_dim)
        self.neighbors = None if neighbors is None else \
            [list(p) for p in neighbors]
        if neighbors is not None:
            self.norm4 = nn.LayerNorm(dim)
            self.attn4 = Attention(dim, heads, d_head, dim)
            self.connector = Linear(dim, dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), ctx) + x
        if self.neighbors is not None:
            x = self.connector(self.cross_view(self.norm4(x))) + x
        return self.ff(self.norm3(x)) + x

    def cross_view(self, h):
        """The "add" form: each view attends to each neighbour's tokens
        alone, q, k and v projected once; the outputs are summed and
        out-projected once, the bias counted per neighbour."""
        a, nb = self.attn4, self.neighbors
        n, k = len(nb), len(nb[0])
        BN, L, C = h.shape
        cols = [[p[i] for p in nb] for i in range(k)]
        _log("pair", BN, L, C, k, a.to_q.weight.shape[0])
        q = a.to_q(h)
        kk, vv = (t.reshape(BN // n, n, L, -1) for t in (a.to_k(h),
                                                         a.to_v(h)))
        o = sum(_heads(q, kk[:, c].reshape(BN, L, -1),
                       vv[:, c].reshape(BN, L, -1), a.heads, a.scale)
                for c in cols)
        lin = a.to_out[0]
        return F.linear(q8(o), q8(lin.weight)) + k * lin.bias


class Transformer2DModel(nn.Module):
    def __init__(self, heads, d_head, ctx_dim, groups, neighbors=None):
        super().__init__()
        c = heads * d_head
        self.norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.proj_in = Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            c, heads, d_head, ctx_dim, neighbors)])
        self.proj_out = Conv2d(c, c, 1)

    def forward(self, x, ctx):
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(
            b, hh * ww, c)
        for blk in self.transformer_blocks:
            if torch.is_grad_enabled() and CHECKPOINT["on"]:
                h = checkpoint(blk, h, ctx, use_reentrant=False)
            else:
                h = blk(h, ctx)
        return self.proj_out(h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)) + x


# the training reference recomputes each transformer block in the backward,
# so that the logits of one block at a time are held
CHECKPOINT = {"on": False}


def _transformer(u: dict, ch: int, neighbors) -> Transformer2DModel:
    heads = u["num_attention_heads"]
    return Transformer2DModel(heads, ch // heads, u["cross_attention_dim"],
                              u["norm_num_groups"], neighbors)


class CrossAttnDownBlock(nn.Module):
    def __init__(self, u, cin, cout, has_attn, down, neighbors):
        super().__init__()
        temb = u["block_out_channels"][0] * 4
        n = u["layers_per_block"]
        self.resnets = nn.ModuleList([ResnetBlock2D(
            cin if i == 0 else cout, cout, temb, u["norm_num_groups"])
            for i in range(n)])
        self.attentions = nn.ModuleList([
            _transformer(u, cout, neighbors) for _ in range(n)]) \
            if has_attn else None
        self.downsamplers = nn.ModuleList([Downsample2D(cout)]) \
            if down else None

    def forward(self, x, temb, ctx):
        res = []
        for i, r in enumerate(self.resnets):
            x = r(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, ctx)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            res.append(x)
        return x, res


class CrossAttnUpBlock(nn.Module):
    def __init__(self, u, prev, cout, skips, has_attn, up, neighbors):
        super().__init__()
        temb = u["block_out_channels"][0] * 4
        self.resnets = nn.ModuleList([ResnetBlock2D(
            (prev if i == 0 else cout) + s, cout, temb, u["norm_num_groups"])
            for i, s in enumerate(skips)])
        self.attentions = nn.ModuleList([
            _transformer(u, cout, neighbors) for _ in skips]) \
            if has_attn else None
        self.upsamplers = nn.ModuleList([Upsample2D(cout)]) if up else None

    def forward(self, x, skips, temb, ctx, out_hw=None):
        for i, r in enumerate(self.resnets):
            x = r(torch.cat([x, skips[i]], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, ctx)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, out_hw)
        return x


class UNetMidBlock(nn.Module):
    def __init__(self, u, neighbors):
        super().__init__()
        ch = u["block_out_channels"][-1]
        temb = u["block_out_channels"][0] * 4
        self.resnets = nn.ModuleList([ResnetBlock2D(
            ch, ch, temb, u["norm_num_groups"]) for _ in range(2)])
        self.attentions = nn.ModuleList([_transformer(u, ch, neighbors)])

    def forward(self, x, temb, ctx):
        return self.resnets[1](self.attentions[0](self.resnets[0](x, temb),
                                                  ctx), temb)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin, dim):
        super().__init__()
        self.linear_1 = Linear(cin, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, t):
        return self.linear_2(F.silu(self.linear_1(t)))


class UNet(nn.Module):
    """SD-v1.5 UNet; ``neighboring_view_pair`` adds attn4 to every
    transformer block."""

    def __init__(self, u: dict):
        super().__init__()
        self.u = u
        boc = u["block_out_channels"]
        nb = u.get("neighboring_view_pair")
        has = u["down_block_has_attn"]
        self.time_embedding = TimestepEmbedding(boc[0], boc[0] * 4)
        self.conv_in = Conv2d(u["in_channels"], boc[0], 3, padding=1)
        skip = [boc[0]]
        self.down_blocks = nn.ModuleList()
        for i, ch in enumerate(boc):
            final = i == len(boc) - 1
            self.down_blocks.append(CrossAttnDownBlock(
                u, boc[max(i - 1, 0)], ch, has[i], not final, nb))
            skip += [ch] * (u["layers_per_block"] + (0 if final else 1))
        self.mid_block = UNetMidBlock(u, nb)
        self.up_blocks = nn.ModuleList()
        prev, rev = boc[-1], list(reversed(boc))
        for i, ch in enumerate(rev):
            skips = [skip.pop() for _ in range(u["layers_per_block"] + 1)]
            self.up_blocks.append(CrossAttnUpBlock(
                u, prev, ch, skips, list(reversed(has))[i],
                i != len(rev) - 1, nb))
            prev = ch
        self.conv_norm_out = nn.GroupNorm(u["norm_num_groups"], boc[0])
        self.conv_out = Conv2d(boc[0], u["out_channels"], 3, padding=1)

    def forward(self, x, t, ctx, down_res=None, mid_res=None):
        temb = self.time_embedding(timestep_embedding(
            t, self.u["block_out_channels"][0]))
        x = self.conv_in(x)
        skips = [x]
        for b in self.down_blocks:
            x, r = b(x, temb, ctx)
            skips += r
        if down_res is not None:
            skips = [s + r for s, r in zip(skips, down_res, strict=True)]
        x = self.mid_block(x, temb, ctx)
        if mid_res is not None:
            x = x + mid_res
        n_up = self.u["layers_per_block"] + 1
        for b in self.up_blocks:
            bs = skips[-n_up:][::-1]
            skips = skips[:-n_up]
            x = b(x, bs, temb, ctx, tuple(skips[-1].shape[2:])
                  if skips else None)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


# ----------------------------------------------------------------------------
# ControlNet and its embedders


class BBoxEmbedder(nn.Module):
    def __init__(self, b: dict):
        super().__init__()
        self.b = b
        n_points = {"all-xyz": 8, "cxyz": 4}[b["mode"]]
        pos_dim = 3 * (1 + 2 * b["embedder_num_freq"]) * n_points
        d = b["proj_dims"]
        self.null_pos_feature = nn.Parameter(torch.zeros(pos_dim))
        self.null_class_feature = nn.Parameter(
            torch.zeros(b["class_token_dim"]))
        shape = (b["n_classes"], b["class_token_dim"])
        self.register_buffer("_class_tokens", torch.zeros(shape))
        self.bbox_proj = Linear(pos_dim, d[0])
        self.second_linear = nn.Sequential(
            Linear(d[0] + b["class_token_dim"], d[1]), nn.SiLU(),
            Linear(d[1], d[2]), nn.SiLU(), Linear(d[2], d[3]))

    def forward(self, boxes, classes, masks):
        pos = fourier_embed(boxes, self.b["embedder_num_freq"])
        pos = pos.reshape(*pos.shape[:-2], -1)
        m = masks[..., None]
        pos = pos * m + self.null_pos_feature * (1 - m)
        cls = self._class_tokens[classes.long().clamp(
            0, self.b["n_classes"] - 1)]
        cls = cls * m + self.null_class_feature * (1 - m)
        return self.second_linear(torch.cat(
            [F.silu(self.bbox_proj(pos)), cls], dim=-1))


class MapEmbedder(nn.Module):
    """The BEV map embedder; ``plus`` is the hi-res one (stride 1 first,
    adaptive pool to ``out_hw``)."""

    def __init__(self, cin, boc, cout, plus=False, out_hw=None):
        super().__init__()
        self.plus, self.out_hw = plus, out_hw
        self.conv_in = Conv2d(cin, boc[0], 3, padding=1)
        specs = []
        for i in range(len(boc) - 2):
            specs.append((boc[i], boc[i], (1, 1), (1, 1)))
            specs.append((boc[i], boc[i + 1], (1, 1) if plus else (2, 1),
                          (1, 1) if plus and i == 0 else (2, 2)))
        specs.append((boc[-2], boc[-2], (1, 1) if plus else (2, 1), (1, 1)))
        specs.append((boc[-2], boc[-1], (1, 1) if plus else (2, 1), (2, 1)))
        self.blocks = nn.ModuleList([Conv2d(ci, co, 3, stride=s, padding=p)
                                     for ci, co, p, s in specs])
        self.conv_out = Conv2d(boc[-1], cout, 3, padding=1)

    def forward(self, x):
        h = F.silu(self.conv_in(x))
        for c in self.blocks:
            h = F.silu(c(h))
        if self.plus:
            h = F.adaptive_avg_pool2d(h, tuple(self.out_hw))
        return self.conv_out(h)


def embed_camera(cam, num_freqs):
    e = fourier_embed(cam.transpose(-1, -2), num_freqs)
    return e.reshape(*e.shape[:-2], -1)


class ControlNet(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        u = dict(c["unet"], neighboring_view_pair=None)
        self.u = u
        boc = u["block_out_channels"]
        self.cam2token = Linear(c["camera_in_dim"], c["camera_out_dim"])
        ui = c["uncond_cam_in_dim"]
        self.uncond_cam = nn.Embedding(1, ui[0] * ui[1])
        self.bbox_embedder = BBoxEmbedder(c["bbox"])
        self.controlnet_cond_embedding = MapEmbedder(
            c["map_size"][0], c["map_embedder_out_channels"], boc[0],
            c["use_map_embedder_plus"], c["map_embedder_plus_size"])
        self.time_embedding = TimestepEmbedding(boc[0], boc[0] * 4)
        self.conv_in = Conv2d(u["in_channels"], boc[0], 3, padding=1)
        has = u["down_block_has_attn"]
        self.down_blocks = nn.ModuleList([CrossAttnDownBlock(
            u, boc[max(i - 1, 0)], ch, has[i], i != len(boc) - 1, None)
            for i, ch in enumerate(boc)])
        self.mid_block = UNetMidBlock(u, None)
        res = [boc[0]]
        for i, ch in enumerate(boc):
            res += [ch] * (u["layers_per_block"] + (i != len(boc) - 1))
        self.controlnet_down_blocks = nn.ModuleList([Conv2d(ch, ch, 1)
                                                     for ch in res])
        self.controlnet_mid_block = Conv2d(boc[-1], boc[-1], 1)

    def uncond_cam_token(self):
        ui = self.c["uncond_cam_in_dim"]
        return self.cam2token(embed_camera(
            self.uncond_cam.weight.reshape(ui), self.c["cam_num_freqs"]))

    def tokens(self, cam, text, boxes, classes, masks, uncond_text=None,
               drop_mask=None):
        """[camera | text | boxes] tokens (B, N, 1 + 77 + L, d); where
        ``drop_mask`` (B, N) is 1, the unconditional camera and text."""
        B, N = cam.shape[:2]
        tok = torch.cat([
            self.cam2token(embed_camera(cam, self.c["cam_num_freqs"]))[
                :, :, None],
            text[:, None].expand(B, N, -1, -1)], dim=2)
        if drop_mask is not None:
            un = torch.cat([self.uncond_cam_token()[None], uncond_text[0]])
            m = drop_mask[:, :, None, None]
            tok = tok * (1 - m) + un * m
        box = self.bbox_embedder(boxes, classes, masks)
        return torch.cat([tok, box.expand(B, N, *box.shape[2:])], dim=2)

    def forward(self, x, t, tokens, cond_feat):
        """x (B, N, 4, h, w), t (B,) -> (down residuals, mid residual)."""
        B, N = x.shape[:2]
        temb = self.time_embedding(timestep_embedding(
            t.repeat_interleave(N), self.u["block_out_channels"][0]))
        h = self.conv_in(x.reshape(B * N, *x.shape[2:])) + \
            cond_feat.repeat_interleave(N, dim=0)
        ctx = tokens.reshape(B * N, *tokens.shape[2:])
        res = [h]
        for b in self.down_blocks:
            h, r = b(h, temb, ctx)
            res += r
        h = self.mid_block(h, temb, ctx)
        return ([conv(r) for conv, r in zip(self.controlnet_down_blocks,
                                            res, strict=True)],
                self.controlnet_mid_block(h))


# ----------------------------------------------------------------------------
# VAE


class VAEAttention(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = Linear(ch, ch)
        self.to_k = Linear(ch, ch)
        self.to_v = Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])
        self.scale = ch ** -0.5

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        y = self.to_out[0](attention(self.to_q(y), self.to_k(y),
                                     self.to_v(y), 1, self.scale))
        return y.transpose(1, 2).reshape(b, c, h, w) + x


class VAEMid(nn.Module):
    def __init__(self, ch, g):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, None, g, 1e-6)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, g)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAEDownsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class EncoderBlock(nn.Module):
    def __init__(self, cin, cout, n, g, down):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(
            cin if i == 0 else cout, cout, None, g, 1e-6) for i in range(n)])
        self.downsamplers = nn.ModuleList([VAEDownsample(cout)]) \
            if down else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return x if self.downsamplers is None else self.downsamplers[0](x)


class DecoderBlock(nn.Module):
    def __init__(self, cin, cout, n, g, up):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(
            cin if i == 0 else cout, cout, None, g, 1e-6) for i in range(n)])
        self.upsamplers = nn.ModuleList([Upsample2D(cout)]) if up else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return x if self.upsamplers is None else self.upsamplers[0](x)


class Encoder(nn.Module):
    def __init__(self, v):
        super().__init__()
        boc, g = v["block_out_channels"], v["norm_num_groups"]
        self.conv_in = Conv2d(v["in_channels"], boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([EncoderBlock(
            boc[max(i - 1, 0)], ch, v["layers_per_block"], g,
            i != len(boc) - 1) for i, ch in enumerate(boc)])
        self.mid_block = VAEMid(boc[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, boc[-1], eps=1e-6)
        self.conv_out = Conv2d(boc[-1], 2 * v["latent_channels"], 3,
                               padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for b in self.down_blocks:
            x = b(x)
        return self.conv_out(F.silu(self.conv_norm_out(self.mid_block(x))))


class Decoder(nn.Module):
    def __init__(self, v):
        super().__init__()
        rev, g = list(reversed(v["block_out_channels"])), \
            v["norm_num_groups"]
        self.conv_in = Conv2d(v["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = VAEMid(rev[0], g)
        self.up_blocks = nn.ModuleList([DecoderBlock(
            rev[max(i - 1, 0)], ch, v["layers_per_block"] + 1, g,
            i != len(rev) - 1) for i, ch in enumerate(rev)])
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = Conv2d(rev[-1], v["out_channels"], 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for b in self.up_blocks:
            x = b(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAE(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        self.v = v
        self.encoder = Encoder(v)
        self.decoder = Decoder(v)
        lc = v["latent_channels"]
        self.quant_conv = Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = Conv2d(lc, lc, 1)

    def encode(self, x, noise):
        """Images (B, 3, H, W) in [-1, 1] -> scaled posterior samples."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
        return z * self.v["scaling_factor"]

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z / self.v["scaling_factor"]))


# ----------------------------------------------------------------------------
# CLIP text encoder


class CLIPAttention(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Linear(d, d), Linear(d, d)
        self.v_proj, self.out_proj = Linear(d, d), Linear(d, d)

    def forward(self, x):
        d = x.shape[-1]
        return self.out_proj(attention(
            self.q_proj(x), self.k_proj(x), self.v_proj(x), self.heads,
            (d // self.heads) ** -0.5, causal=True))


class CLIPMLP(nn.Module):
    def __init__(self, d, inner):
        super().__init__()
        self.fc1, self.fc2 = Linear(d, inner), Linear(inner, d)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))


class CLIPLayer(nn.Module):
    def __init__(self, c):
        super().__init__()
        d, eps = c["hidden_size"], c["layer_norm_eps"]
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.self_attn = CLIPAttention(d, c["num_heads"])
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = CLIPMLP(d, c["intermediate_size"])

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.token_embedding = nn.Embedding(c["vocab_size"],
                                            c["hidden_size"])
        self.position_embedding = nn.Embedding(
            c["max_position_embeddings"], c["hidden_size"])


class _Encoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(c)
                                     for _ in range(c["num_layers"])])


class _TextTransformer(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.embeddings = _Embeddings(c)
        self.encoder = _Encoder(c)
        self.final_layer_norm = nn.LayerNorm(c["hidden_size"],
                                             eps=c["layer_norm_eps"])


class CLIPText(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.text_model = _TextTransformer(c)

    def forward(self, ids):
        tm = self.text_model
        x = tm.embeddings.token_embedding(ids) + \
            tm.embeddings.position_embedding.weight[:ids.shape[1]]
        for layer in tm.encoder.layers:
            x = layer(x)
        return tm.final_layer_norm(x)


# ----------------------------------------------------------------------------


# the options this reference implements: a configuration that sets another
# value is refused rather than compared against the wrong function
IMPLEMENTED = {("unet", "neighboring_attn_type"): "add",
               ("unet", "zero_module_type"): "zero_linear",
               ("unet", "temporal_frames"): None,
               ("controlnet", "drop_cam_with_box"): False,
               ("controlnet", "use_uncond_map"): None,
               ("bbox", "trainable_class_token"): False,
               ("bbox", "minmax_normalize"): False}


def check(model: dict) -> None:
    sections = {"unet": model["unet"], "controlnet": model["controlnet"],
                "bbox": model["controlnet"]["bbox"]}
    bad = {f"{s}.{k}": sections[s].get(k) for (s, k), v in IMPLEMENTED.items()
           if sections[s].get(k, v) != v}
    if bad:
        raise ValueError(f"the reference does not implement {bad}")


class Model(nn.Module):
    """The four modules of a configuration's ``model`` section, under the
    names the system under test gives them."""

    def __init__(self, model: dict):
        check(model)
        super().__init__()
        self.unet = UNet(model["unet"])
        self.controlnet = ControlNet(model["controlnet"])
        self.vae = VAE(model["vae"])
        self.clip = CLIPText(model["clip"])


def norm_parameter_names(model: nn.Module) -> List[str]:
    """state_dict names of the GroupNorm and LayerNorm weights."""
    return [f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, (nn.GroupNorm, nn.LayerNorm))]
