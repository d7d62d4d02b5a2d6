"""Gradient compression of the port (``repro.optim.compression``, its
single-device half): int8 error-feedback quantization of gradient trees.

Wire cost per gradient sync drops 4x (f32 -> int8 + one f32 scale per
tensor); the quantization error is carried in an error-feedback
accumulator so the *expected* update is unbiased (1-bit Adam / EF-SGD
lineage).  The ring all-reduce that puts the int8 payload on the wire,
``int8_ring_mean``, needs the multi-device layer (ROADMAP A12).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.placement import tree_flatten


def init_error_state(params: Any) -> Any:
    leaves, tdef = tree_flatten(params)
    return tdef.unflatten([torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device) for p in leaves])


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale)."""
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(g: torch.Tensor, err: torch.Tensor,
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback step: quantize (g + err), carry the residual."""
    target = g.float() + err
    q, scale = quantize(target)
    new_err = target - dequantize(q, scale)
    return q, scale, new_err


def compress_tree(grads: Any, err_state: Any) -> tuple[Any, Any, Any]:
    """(int8 tree, scale tree, new error tree), leaf by leaf."""
    flat_g, tdef = tree_flatten(grads)
    flat_e = tree_flatten(err_state)[0]
    if len(flat_g) != len(flat_e):
        raise ValueError("grads and error state must be trees of the same "
                         "structure")
    out = [ef_compress(g, e) for g, e in zip(flat_g, flat_e)]
    return tuple(tdef.unflatten([o[i] for o in out]) for i in range(3))


def decompress_tree(qs: Any, scales: Any) -> Any:
    flat_q, tdef = tree_flatten(qs)
    return tdef.unflatten([dequantize(q, s) for q, s in
                           zip(flat_q, tree_flatten(scales)[0])])


def int8_ring_mean(x, mesh, axis: str):
    """Mean of per-device gradients with int8 on the wire, over a ring of
    devices: not ported yet (ROADMAP A12, multi-device)."""
    raise NotImplementedError(
        "int8_ring_mean needs the multi-device layer, which is not ported "
        "yet: ROADMAP A12")


__all__ = ["init_error_state", "quantize", "dequantize", "ef_compress",
           "compress_tree", "decompress_tree", "int8_ring_mean"]
