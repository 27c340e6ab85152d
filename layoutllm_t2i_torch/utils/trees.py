"""Parameter containers under the reference torch state_dict names."""
from __future__ import annotations

from typing import Any, Dict, Iterator

import torch
from torch import nn


class ParamTree(nn.Module):
    """A nested parameter dict as an ``nn.Module``.

    ``state_dict()`` yields the reference torch names (``input_blocks.1.0.
    in_layers.0.weight``), so checkpoints load with ``strict=True``, and the
    model functions index it like the nested dict it was built from
    (``p["in_layers"]["0"]["weight"]``, ``"bias" in p``).
    Parameters are frozen: the port only runs inference.
    """

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(torch.as_tensor(val), requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._modules:
            return self._modules[key]
        return self._parameters[key]

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._parameters

    def keys(self) -> Iterator[str]:
        yield from self._parameters
        yield from self._modules


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> flat {'a.b.c': leaf} (torch state_dict naming)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, name + "."))
        else:
            out[name] = v
    return out


def override_subtree(params, path, value):
    """A view of ``params`` (dict or ParamTree) with the nested ``path``
    replaced; everything else is shared, nothing is copied."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    out = {k: params[k] for k in params.keys()}
    out[head] = override_subtree(params[head], rest, value)
    return out
