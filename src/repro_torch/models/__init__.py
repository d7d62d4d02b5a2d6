"""Model stack of the port (``repro.models`` in the reference): every
block kind of the configs registry — dense attention ("ga", "la"), MoE
("gm"), Griffin RG-LRU ("rg"), xLSTM ("ml", "sl") and the encoder-decoder
path ("enc" and cross-attention) — and `Model`: its loss (training, with
the flash backward and per-cycle remat) and its serving path.

Parameters cross between the packages as numpy trees of the reference's
structure: :func:`params_from_numpy` turns ``jax.device_get(params)`` into
the port's tree, and :func:`numpy_params` builds such a tree from
``numpy.random.default_rng(seed)`` without JAX, so the card and a CPU
reference compute on identical weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.placement import tree_flatten
from repro_torch.device import resolve_device

from .model import Model  # noqa: F401


def _leaf_tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(tree: Any, device=None) -> Any:
    """The reference's parameter tree with numpy leaves -> the port's tree
    of tensors on ``device`` (None: the card), same structure (``cycles``
    stays a tuple) and dtypes (a bfloat16 leaf stays bfloat16)."""
    device = resolve_device(device)
    leaves, treedef = tree_flatten(tree)
    return treedef.unflatten([_leaf_tensor(x).to(device) for x in leaves])


def _leaf_numpy(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:           # as ml_dtypes' bfloat16
        import ml_dtypes
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def numpy_params(cfg, seed: int) -> Any:
    """Parameters of ``cfg`` drawn from ``numpy.random.default_rng(seed)``
    (the port's init scales, truncated normals by rejection), as a tree of
    numpy arrays with the reference's structure and dtypes (float32, or
    ``ml_dtypes.bfloat16`` where ``cfg.param_dtype`` asks for it): the
    same weights on every host, for the reference (``jnp.asarray`` per
    leaf) and the port (:func:`params_from_numpy`)."""
    params = Model(cfg).init(np.random.default_rng(seed), device="cpu")
    leaves, treedef = tree_flatten(params)
    return treedef.unflatten([_leaf_numpy(x) for x in leaves])


__all__ = ["Model", "params_from_numpy", "numpy_params"]
