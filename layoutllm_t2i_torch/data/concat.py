"""Dataset concatenation with per-dataset repeats, and the name catalog (a
copy of layoutllm_t2i_tpu/data/concat.py; reference GLIGEN/dataset/
concat_dataset.py's index mapping and catalog.py's name registry).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence


class ConcatDataset:
    def __init__(self, datasets: Sequence, repeats: Sequence[int] | None = None):
        repeats = list(repeats) if repeats is not None else [1] * len(datasets)
        if len(repeats) != len(datasets):
            raise ValueError(f"{len(repeats)} repeats for {len(datasets)} "
                             "datasets")
        self.datasets = list(datasets)
        self._map: List[tuple] = []
        for d_idx, (ds, rep) in enumerate(zip(datasets, repeats)):
            for _ in range(rep):
                for i in range(len(ds)):
                    self._map.append((d_idx, i))

    def total_images(self) -> int:
        return len(self._map)

    def __len__(self):
        return len(self._map)

    def __getitem__(self, idx: int):
        d_idx, i = self._map[idx]
        return self.datasets[d_idx][i]


# name -> constructor (catalog.py's registry role, without its class-path
# indirection); data/catalog.py fills it when the package is imported
DATASET_CATALOG: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(fn):
        DATASET_CATALOG[name] = fn
        return fn
    return deco


def build_datasets(spec: Dict[str, dict], **common):
    """spec: {name: params} like the reference's train_dataset_names yaml."""
    out = []
    for name, params in spec.items():
        if name not in DATASET_CATALOG:
            raise KeyError(f"unknown dataset '{name}'; known: {list(DATASET_CATALOG)}")
        out.append(DATASET_CATALOG[name](**{**common, **params}))
    return out
