"""Gradient compression of the port (``repro.optim.compression``, its
single-device half): int8 error-feedback quantization of gradient trees.

Wire cost per gradient sync drops 4x (f32 -> int8 + one f32 scale per
tensor); the quantization error is carried in an error-feedback
accumulator so the *expected* update is unbiased (1-bit Adam / EF-SGD
lineage).  ``int8_ring_mean`` puts the int8 payload on the wire: a ring
reduce-scatter and all-gather over the devices of one mesh axis, driven
by one controller (a hop is a copy to the neighbour's device, as in
``repro_torch.core.ring``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.placement import tree_flatten
from repro_torch.sharding.mesh import axis_devices, move_to


def init_error_state(params: Any) -> Any:
    leaves, tdef = tree_flatten(params)
    return tdef.unflatten([torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device) for p in leaves])


def _true_div(t: torch.Tensor, d: float) -> torch.Tensor:
    """t / d rounded once, on every device: torch's CUDA kernels divide by
    a Python scalar as a multiply by its float32 reciprocal, which can
    land one ulp away from the CPU's (and the reference's) quotient."""
    return t / torch.full((), d, dtype=t.dtype, device=t.device)


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale)."""
    scale = _true_div(torch.clamp_min(torch.max(torch.abs(x)), 1e-12), 127.0)
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


def int8_ring_mean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Mean of per-device gradients with int8 on the wire.

    x: (n, ...) float — row i is device i's local gradient, device i the
    i-th along ``axis`` of ``mesh`` (``.shape`` {axis: n}, ``.devices``).
    Ring reduce-scatter in int8 (each hop re-quantizes its partial sum —
    the standard ring-compression compromise) + int8 all-gather of the
    finished chunks.  Wire bytes: 2 * |x| * 1B vs 2 * |x| * 4B
    uncompressed.  Returns (n, ...) float32 on the first device with
    every row = the mean (each device's gathered copy).

    Ring algebra: acc_i^(0) = x_i[chunk i]; each hop sends acc rightward
    (j -> j+1) and adds the receiver's own chunk (idx - t - 1) mod n;
    after n-1 hops device i holds the FULL sum of chunk (i+1) mod n, so
    gathered chunk c sits at device (c - 1) mod n."""
    devs = axis_devices(mesh, axis)
    n = len(devs)
    if x.shape[0] != n:
        raise ValueError(f"leading dim {x.shape[0]} != axis {axis}={n}")
    size = x[0].numel()
    pad = (-size) % n
    chunks = []                    # chunks[i]: device i's (n, size/n) row
    for i in range(n):
        xi = move_to(x[i].reshape(-1), devs[i])
        if pad:
            xi = torch.nn.functional.pad(xi, (0, pad))
        chunks.append(xi.view(n, -1))
    accs = [chunks[i][i] for i in range(n)]
    for t in range(n - 1):
        wire = [quantize(a) for a in accs]
        accs = [dequantize(*(move_to(w, devs[i])
                             for w in wire[(i - 1) % n]))
                + chunks[i][(i - t - 1) % n] for i in range(n)]
    finished = [quantize(_true_div(a, n)) for a in accs]  # chunk (i+1) % n
    out = torch.empty((n,) + tuple(x.shape[1:]), dtype=torch.float32,
                      device=devs[0])
    order = [(c - 1) % n for c in range(n)]      # chunk c at device c-1
    for i in range(n):                           # all-gather onto device i
        qg = torch.stack([move_to(finished[j][0], devs[i])
                          for j in order])
        sg = torch.stack([move_to(finished[j][1], devs[i])
                          for j in order])
        full = dequantize(qg, sg[:, None]).reshape(-1)[:size]
        out[i].copy_(full.view(x.shape[1:]), non_blocking=out.is_cuda)
    return out


__all__ = ["init_error_state", "quantize", "dequantize", "ef_compress",
           "compress_tree", "decompress_tree", "int8_ring_mean"]
