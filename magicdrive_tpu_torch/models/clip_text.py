"""CLIP ViT-L/14 text encoder, the frozen SD-v1.5 text backbone
(counterpart of ``models/clip_text.py``), with the transformers
``CLIPTextModel`` state_dict names."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from magicdrive_tpu_torch.config import CLIPTextConfig
from magicdrive_tpu_torch.core.attention import scaled_dot_product_attention


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, d = x.shape
        split = lambda t: t.reshape(B, L, self.heads, -1).transpose(1, 2)
        o = scaled_dot_product_attention(
            split(self.q_proj(x)), split(self.k_proj(x)),
            split(self.v_proj(x)), is_causal=True)
        return self.out_proj(o.transpose(1, 2).reshape(B, L, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))  # quick GELU


def _layer_norm32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(x.dtype)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(_layer_norm32(self.layer_norm1, x))
        return x + self.mlp(_layer_norm32(self.layer_norm2, x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, input_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """input_ids (B, L) -> (last_hidden_state (B, L, d), pooled (B, d):
        the hidden state at the first EOS token)."""
        tm = self.text_model
        L = input_ids.shape[1]
        x = (tm.embeddings.token_embedding(input_ids)
             + tm.embeddings.position_embedding.weight[:L])
        for layer in tm.encoder.layers:
            x = layer(x)
        x = _layer_norm32(tm.final_layer_norm, x)
        eos = (input_ids == self.cfg.eos_token_id).int().argmax(-1)
        return x, x[torch.arange(x.shape[0], device=x.device), eos]
