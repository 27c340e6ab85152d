"""Policy network + aesthetic predictor (layoutllm_t2i_tpu/models/policy.py).

Reference: models/policy.py:11-33 (a single Linear(768->128) over frozen CLIP
text features) and tools/aesthetic.py:9-56 (5-layer MLP on normalized CLIP
image embeddings, LAION sac+logos+ava1-l14-linearMSE weights). Parameters
are nested dicts (or ParamTrees) under the reference torch names, linear
weights (out, in); JAX trees cross over through checkpoint/from_jax.py.
"""
from __future__ import annotations

import torch

from ..ops import nn
from . import initializers as init


def policy_apply(params, emb: torch.Tensor) -> torch.Tensor:
    """emb: (N, in_dim) CLIP text features -> (N, embedding_size)."""
    return nn.linear(params["linear"], emb)


def policy_scores(params, emb_prompt: torch.Tensor,
                  emb_cand: torch.Tensor) -> torch.Tensor:
    """Scores = policy(prompt) @ policy(cand)^T (txt2img.py:472-474)."""
    ep = policy_apply(params, emb_prompt)
    ec = policy_apply(params, emb_cand)
    return ep @ ec.T


def init_policy_params(ini: init.Init, in_dim: int = 768,
                       embedding_size: int = 128):
    return {"linear": init.linear_p(ini, in_dim, embedding_size)}


# ---------------------------------------------------------------------------
# aesthetic predictor (tools/aesthetic.py) — torch keys layers.{0,2,4,6,8}

_AES_DIMS = [(768, 1024), (1024, 128), (128, 64), (64, 16), (16, 1)]
_AES_KEYS = ["0", "2", "4", "6", "8"]


def aesthetic_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x: (N, 768) L2-normalized CLIP image embedding -> (N,) score.
    The reference MLP has its ReLUs commented out — it is a linear stack with
    (inference-inactive) dropout between layers."""
    h = x
    for k in _AES_KEYS:
        h = nn.linear(params["layers"][k], h)
    return h[..., 0]


def init_aesthetic_params(ini: init.Init, input_size: int = 768):
    dims = [(input_size, 1024)] + _AES_DIMS[1:]
    return {"layers": {k: init.linear_p(ini, din, dout)
                       for k, (din, dout) in zip(_AES_KEYS, dims)}}


def l2_normalize(a: torch.Tensor, axis: int = -1, eps: float = 0.0) -> torch.Tensor:
    """normalized() from tools/aesthetic.py:51-56 (zero norms pass through)."""
    norm = torch.linalg.vector_norm(a, ord=2, dim=axis, keepdim=True)
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    return a / norm
