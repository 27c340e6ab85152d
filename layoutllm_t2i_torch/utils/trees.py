"""Parameter containers under the reference torch state_dict names."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator

import torch
from torch import nn

from ..ops.quant import QuantTensor, is_quantized, place


class ParamTree(nn.Module):
    """A nested parameter dict as an ``nn.Module``.

    ``state_dict()`` yields the reference torch names (``input_blocks.1.0.
    in_layers.0.weight``), so checkpoints load with ``strict=True``, and the
    model functions index it like the nested dict it was built from
    (``p["in_layers"]["0"]["weight"]``, ``"bias" in p``).
    Parameters are built frozen (``requires_grad=False``);
    ``set_trainable`` opens exactly the ones a training mode selects.

    An int8 leaf (``ops/quant.py QuantTensor``) is held beside the
    parameters, not as one: it is indexed like them, but is neither a
    parameter nor a buffer, so neither ``state_dict`` nor a dtype cast of
    the module reaches it. A device move does (``_apply``), and leaves its
    f32 scales f32.
    """

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._quantized: Dict[str, QuantTensor] = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif is_quantized(val):
                self._quantized[key] = val
            else:
                self.register_parameter(
                    key, nn.Parameter(torch.as_tensor(val), requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._modules:
            return self._modules[key]
        if key in self._quantized:
            return self._quantized[key]
        return self._parameters[key]

    def __contains__(self, key: str) -> bool:
        return (key in self._modules or key in self._parameters
                or key in self._quantized)

    def keys(self) -> Iterator[str]:
        yield from self._parameters
        yield from self._quantized
        yield from self._modules

    def _apply(self, fn, recurse: bool = True):
        # fn is a cast or a move of every tensor; an int8 leaf takes only
        # the move (fn leaves int8 values int8, the scales follow them)
        for key, leaf in self._quantized.items():
            self._quantized[key] = place(leaf, fn(leaf.q).device)
        return super()._apply(fn, recurse)

    def set_trainable(self, predicate: Callable[[str], bool]
                      ) -> Dict[str, nn.Parameter]:
        """``requires_grad`` on exactly the parameters whose dotted
        state_dict name satisfies ``predicate``, off on every other one.
        Returns the trainable ones by name, in state_dict order."""
        out = {}
        for name, p in self.named_parameters():
            p.requires_grad_(bool(predicate(name)))
            if p.requires_grad:
                out[name] = p
        return out


def _put(tree: ParamTree, key: str, leaf) -> None:
    """Put a child into ``tree``: a ParamTree as it is (shared), a nested
    dict as a new ParamTree, an int8 leaf beside the parameters, a tensor
    as a frozen parameter (a Parameter as it is)."""
    if isinstance(leaf, ParamTree):
        tree.add_module(key, leaf)
    elif isinstance(leaf, dict):
        tree.add_module(key, ParamTree(leaf))
    elif is_quantized(leaf):
        tree._quantized[key] = leaf
    else:
        if not isinstance(leaf, nn.Parameter):
            leaf = nn.Parameter(torch.as_tensor(leaf), requires_grad=False)
        tree.register_parameter(key, leaf)


def replace_subtree(tree: ParamTree, path, value) -> ParamTree:
    """A ParamTree with ``tree``'s children, shared, and the nested
    ``path`` set to ``value`` (a nested dict of tensors or a ParamTree),
    added where it is missing. ``tree`` itself is left as it is."""
    head, rest = path[0], tuple(path[1:])
    out = ParamTree({})
    keys = list(tree.keys()) + ([] if head in tree else [head])
    for key in keys:
        if key != head:
            _put(out, key, tree[key])
        elif rest:
            _put(out, key, replace_subtree(tree[head] if head in tree
                                           else ParamTree({}), rest, value))
        else:
            _put(out, key, value)
    return out


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


def unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Flat {'a.b.c': leaf} -> nested dict (the inverse of flatten_tree)."""
    out: Dict[str, Any] = {}
    for name, leaf in flat.items():
        node = out
        *parents, last = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
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
