"""Weights bridge: the JAX package's parameter trees -> torch state_dicts.

The JAX trees are nested dicts keyed by the reference torch names, with
NumPy leaves in the TPU layouts (conv HWIO, linear (in, out)); this undoes
layoutllm_t2i_tpu/checkpoint/convert.py:34-41. It takes NumPy arrays only,
so the port never imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..utils.trees import ParamTree, flatten_tree

# names whose 2-D weights are lookup tables, not nn.Linear kernels
_EMBEDDING_SUFFIXES = (
    "token_embedding.weight",
    "position_embedding.weight",
)


def torch_layout(name: str, a) -> np.ndarray:
    """The JAX leaf ``name`` as a NumPy view in the torch layout (no copy)."""
    a = np.asarray(a)
    if a.ndim == 4:  # conv HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    if (a.ndim == 2 and name.split(".")[-1] == "weight"
            and not name.endswith(_EMBEDDING_SUFFIXES)):
        return a.T  # linear (in, out) -> (out, in)
    return a  # 0-D and 1-D tensors and embedding tables stay as they are


def tensor_from_jax(name: str, a) -> torch.Tensor:
    # np.array keeps a 0-D leaf 0-D (np.ascontiguousarray would make it 1-D)
    return torch.from_numpy(np.array(torch_layout(name, a), order="C"))


def state_dict_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested JAX parameter tree -> flat torch state_dict (reference names)."""
    return {name: tensor_from_jax(name, a)
            for name, a in flatten_tree(tree).items()}


def load_from_jax(module: ParamTree, tree: Dict[str, Any]) -> ParamTree:
    """Copy a JAX tree into ``module`` (strict: every name must match)."""
    module.load_state_dict(state_dict_from_jax(tree), strict=True)
    return module
