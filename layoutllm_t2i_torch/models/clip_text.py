"""CLIP ViT-L/14 text encoder (layoutllm_t2i_tpu/models/clip_text.py).

Pre-LN transformer with a causal mask and no padding mask, quick_gelu MLP,
pooled output at each sequence's argmax(token id) (the end-of-text token).
Parameters follow the HF ``text_model.*`` state_dict names.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import nn
from . import initializers as init


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_length: int = 77
    layer_norm_eps: float = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _attn(p, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c = x.shape
    hd = c // num_heads
    q = nn.linear(p["q_proj"], x) * (hd ** -0.5)
    k = nn.linear(p["k_proj"], x)
    v = nn.linear(p["v_proj"], x)
    qh = q.reshape(b, n, num_heads, hd).transpose(1, 2)
    kh = k.reshape(b, n, num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, n, num_heads, hd).transpose(1, 2)
    sim = torch.einsum("bhnc,bhmc->bhnm", qh.float(), kh.float())  # f32 scores
    causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
    sim = sim.masked_fill(~causal, -1e30)
    attn = torch.softmax(sim, dim=-1).to(x.dtype)
    out = torch.einsum("bhnm,bhmc->bhnc", attn, vh)
    return nn.linear(p["out_proj"], out.transpose(1, 2).reshape(b, n, c))


def clip_text_apply(params, cfg: CLIPTextConfig, input_ids: torch.Tensor):
    """input_ids: (B, 77) int. Returns (last_hidden (B,77,C), pooled (B,C))."""
    b, n = input_ids.shape
    emb = params["embeddings"]
    # an id past the table clamps to its last row, as JAX's gather does
    # (HashTokenizer's word ids exceed a small test vocabulary)
    rows = input_ids.clamp(0, cfg.vocab_size - 1)
    x = emb["token_embedding"]["weight"][rows] \
        + emb["position_embedding"]["weight"][:n][None]
    for i in range(cfg.num_layers):
        lyr = params["encoder"]["layers"][str(i)]
        x = x + _attn(lyr["self_attn"],
                      nn.layer_norm(lyr["layer_norm1"], x, cfg.layer_norm_eps),
                      cfg.num_heads)
        h = nn.layer_norm(lyr["layer_norm2"], x, cfg.layer_norm_eps)
        h = nn.linear(lyr["mlp"]["fc2"], quick_gelu(nn.linear(lyr["mlp"]["fc1"], h)))
        x = x + h
    x = nn.layer_norm(params["final_layer_norm"], x, cfg.layer_norm_eps)
    eot = torch.argmax(input_ids, dim=-1)
    pooled = x[torch.arange(b, device=x.device), eot]
    return x, pooled


def clip_text_features(params, cfg: CLIPTextConfig, input_ids: torch.Tensor):
    """CLIPModel.get_text_features: text_projection over the pooled output.
    Expects params['text_projection'] beside the text_model tree (the HF
    CLIPModel key 'text_projection.weight', no bias)."""
    _, pooled = clip_text_apply(params, cfg, input_ids)
    return nn.linear(params["text_projection"], pooled)


def init_clip_text_params(ini: init.Init, cfg: CLIPTextConfig):
    c, inter = cfg.hidden_size, cfg.intermediate_size
    layers = {}
    for i in range(cfg.num_layers):
        layers[str(i)] = {
            "self_attn": {
                "q_proj": init.linear_p(ini, c, c),
                "k_proj": init.linear_p(ini, c, c),
                "v_proj": init.linear_p(ini, c, c),
                "out_proj": init.linear_p(ini, c, c),
            },
            "layer_norm1": init.norm_p(ini, c),
            "layer_norm2": init.norm_p(ini, c),
            "mlp": {
                "fc1": init.linear_p(ini, c, inter),
                "fc2": init.linear_p(ini, inter, c),
            },
        }
    return {
        "embeddings": {
            "token_embedding": {
                "weight": init.normal_p(ini, (cfg.vocab_size, c), 0.02)},
            "position_embedding": {
                "weight": init.normal_p(ini, (cfg.max_length, c), 0.01)},
        },
        "encoder": {"layers": layers},
        "final_layer_norm": init.norm_p(ini, c),
    }
