"""Weights across frameworks: the reference package's flat checkpoint keys
(``checkpoint._flatten``: "/"-joined tree paths such as ``body/0/wq/w``,
``body/0/wq/s_w`` or ``embed/w``, with the stacked leading axis kept on
``body/*``) to this package's nested parameter tree, whose key paths are
the same. A JAX ``arrays.npz`` therefore loads directly:

    params = params_from_numpy(dict(np.load("arrays.npz")), "cuda")

A reference ``PagedKVCache``'s arrays (as numpy) make the port's with
``paged_cache_from_numpy``, so both packages can start from one cache state.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.runtime.kv_cache import PagedKVCache


def params_from_numpy(flat: Dict[str, np.ndarray], device) -> dict:
    """Nested param dict of tensors on ``device`` from flat "/"-keyed
    arrays (float arrays become float32)."""
    tree: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = tree
        for k in parts[:-1]:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise ValueError(f"key {key!r} nests under a leaf")
        a = np.asarray(arr)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        node[parts[-1]] = torch.tensor(a, device=device)
    # segments with no layers are empty dicts in the tree (no arrays to key)
    for seg in ("prefix", "body", "suffix"):
        tree.setdefault(seg, {})
    return tree


def paged_cache_from_numpy(arrays: Dict[str, np.ndarray],
                           device) -> PagedKVCache:
    """The port's ``PagedKVCache`` from the reference's fields by name
    (``k``, ``v``, ``k_scale``, ``v_scale``, ``pos``, ``page_table``, e.g.
    ``{f: np.asarray(getattr(cache, f)) for f in cache._fields}``), each
    array kept in its own dtype."""
    return PagedKVCache(**{
        f: torch.tensor(np.asarray(arrays[f]), device=device)
        for f in PagedKVCache._fields})
