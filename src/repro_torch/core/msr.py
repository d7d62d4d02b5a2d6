"""Double Circulant MSR code: encode / reconstruct / regenerate (the port of
``repro.core.msr``, paper §III).

Block convention: the file is cut into n = 2k data blocks; `data[j]` is
block a_j, a row of S symbols (int32 in [0, p)).  Node v_i (1-indexed)
stores the pair (a_{i-1}, r_i) with

    r_i = sum_{u=1..k} c_u * a_{(i - k - u) mod n}   over GF(p).

Storage per node alpha = 2 * S = B/k symbols; repair bandwidth
gamma = d * S = (k+1) * B / (2k) — eq. (7).

Blocks live on the device as int32 tensors: on the card by default, on
the CPU when the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.device import as_int32, device_of, resolve_device

from .circulant import CodeSpec, redundancy_support
from .repair import RepairEngine

MatmulFn = Callable[..., torch.Tensor]  # (A, B, p) -> (A @ B) mod p


@dataclass
class RepairPlan:
    """The embedded property, reified: everything a newcomer for node v_i
    must do, known statically from (i, spec) — no coefficient search."""
    node: int                  # v_i being regenerated (1-indexed)
    prev_node: int             # serves its redundancy block r_{prev}
    next_nodes: tuple[int, ...]  # k nodes serving their data blocks (in order)
    data_indices: tuple[int, ...]  # 0-based a-indices downloaded (a_{i..i+k-1} mod n)
    blocks_downloaded: int     # d = k + 1

    @property
    def d(self) -> int:
        return self.blocks_downloaded


class DoubleCirculantMSR:
    """The paper's [n = 2k, k] code over GF(p), vectorized over symbols.

    Parameters
    ----------
    spec : CodeSpec
        Validated code specification.
    matmul : callable, optional
        Fully custom ``(a, b, p) -> (a @ b) mod p`` on tensors.  Injecting
        one disables the circulant encode kernel and the fused engine's
        row-source products, so EVERY field operation flows through it,
        always with one concatenated ``b``.
    backend : str, optional
        Pin a registered dispatch backend (``cuda``, ``torch-int32``); None
        auto-selects from the device.
    inverse_cache_size : int
        LRU capacity of the decode-inverse cache.
    mesh : StreamMesh | int | None
        Shard every planned op over this stream-axis device mesh
        (``repro_torch.sharding.mesh``).  ``None`` inherits the ambient
        ``use_mesh(...)`` scope (or no mesh at all); a 1-shard mesh falls
        back to the plain unsharded planner.  Ignored with a custom
        ``matmul``.
    device : torch.device or str, optional
        Where the code computes; None is the card (raises without CUDA),
        or the mesh's first device when meshed (another device raises).

    Attributes
    ----------
    repair : RepairEngine
        The decode-side engine.
    backend_name : str
        Resolved backend (``"custom"`` when ``matmul`` was injected).
    """

    def __init__(self, spec: CodeSpec, matmul: MatmulFn | None = None,
                 backend: str | None = None,
                 inverse_cache_size: int = 128, mesh=None, device=None):
        self.spec = spec
        self.k, self.n, self.p = spec.k, spec.n, spec.p
        self.c = np.asarray(spec.c, dtype=np.int32)
        self._custom_matmul = matmul is not None
        if matmul is None:
            from repro_torch.kernels import dispatch
            from repro_torch.sharding import mesh as mesh_mod
            self.mesh = (mesh_mod.as_stream_mesh(mesh) if mesh is not None
                         else mesh_mod.current_mesh())
            self.device = resolve_device(mesh_mod.mesh_device(self.mesh,
                                                              device))
            be = dispatch.get(backend) if backend else dispatch.select(
                self.p, self.k, self.device)
            self.backend_name = be.name
            self._matmul = be.msr_matmul()
            self._circulant = be.circulant_encode
            engine_mm = be.matmul
            # shared per (backend, p, mesh, device): every code on this
            # backend and mesh hits one plan cache
            self.planner = be.planner(self.p, self.device, mesh=self.mesh)
        else:
            self.device = resolve_device(device)
            self.backend_name = "custom"
            self._matmul = matmul
            self._circulant = None
            engine_mm = matmul
            self.mesh = None
            self.planner = None
        self._m = spec.matrix_m()            # (n, n) M[j, i] = coef of a_j in r_{i+1}
        self._mt = np.ascontiguousarray(self._m.T)  # (n, n): r = M^T @ a
        self.repair = RepairEngine(spec, engine_mm,
                                   fused=not self._custom_matmul,
                                   inverse_cache_size=inverse_cache_size,
                                   planner=self.planner, device=self.device)

    def _blocks(self, x) -> torch.Tensor:
        return as_int32(x, self.p, device_of(x, device=self.device))

    # ---------------------------------------------------------------- encode
    def encode(self, data) -> torch.Tensor:
        """data: (n, S) data blocks -> (n, S) redundancy blocks, through the
        circulant encode kernel (k MACs/symbol); a custom-matmul code
        falls back to the dense M^T product."""
        data = self._blocks(data)
        if data.shape[0] != self.n:
            raise ValueError(f"expected {self.n} data blocks, got {data.shape[0]}")
        if self._circulant is not None:
            return self._circulant(data, tuple(int(x) for x in self.spec.c),
                                   self.p)
        return self._matmul(as_int32(self._mt, self.p, data.device), data,
                            self.p)

    def encode_planned(self, data) -> "PlanResult":
        """Planned encode: asynchronous; ``.host()`` blocks and returns the
        exact (n, S) numpy redundancy matrix."""
        from repro_torch.exec.plan import PlanResult
        if np.shape(data)[0] != self.n:
            raise ValueError(f"expected {self.n} data blocks, "
                             f"got {np.shape(data)[0]}")
        if self.planner is not None:
            return self.planner.circulant_encode(
                data, tuple(int(x) for x in self.spec.c))
        red = self.encode(data)
        return PlanResult(red, red.shape[-1])

    def node_storage(self, data) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """[(a_{i-1}, r_i)] for node v_i, i = 1..n."""
        data = self._blocks(data)
        red = self.encode(data)
        return [(data[i - 1], red[i - 1]) for i in range(1, self.n + 1)]

    # ----------------------------------------------------------- reconstruct
    def reconstruct(self, node_ids: Sequence[int], data_blocks,
                    red_blocks) -> torch.Tensor:
        """Any-k reconstruction (paper §III-B): k distinct nodes' (k, S)
        data and redundancy blocks -> the full (n, S) data matrix, via the
        LRU-cached inverse of the subset's system matrix."""
        return self.repair.reconstruct(node_ids, data_blocks, red_blocks)

    def reconstruct_with_repair(self, node_ids: Sequence[int], data_blocks,
                                red_blocks, failed: Sequence[int],
                                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Multi-failure repair: full data AND every failed node's
        redundancy block from ONE decode matmul.  ``node_ids`` must be
        sorted."""
        return self.repair.reconstruct_with_repair(node_ids, data_blocks,
                                                   red_blocks, failed)

    def systematic_read(self, data) -> torch.Tensor:
        """Systematic reconstruction (paper §III-B): the data blocks as
        stored — zero field operations."""
        return self._blocks(data)

    # ------------------------------------------------------------ regenerate
    def repair_plan(self, i: int) -> RepairPlan:
        """Determined helper set for node v_i — the embedded property."""
        if not 1 <= i <= self.n:
            raise ValueError(f"node {i} out of range 1..{self.n}")
        prev_node = (i - 2) % self.n + 1
        next_nodes = tuple((i - 1 + t) % self.n + 1 for t in range(1, self.k + 1))
        data_indices = tuple((i - 1 + t) % self.n for t in range(1, self.k + 1))
        return RepairPlan(node=i, prev_node=prev_node, next_nodes=next_nodes,
                          data_indices=data_indices, blocks_downloaded=self.k + 1)

    def regenerate(self, i: int, r_prev, next_data,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Systematic (exact) regeneration of node v_i (paper §III-C):
        r_prev (S,) and next_data (k, S) -> (a_{i-1}, r_i), one fused
        repair-matrix application."""
        return self.repair.regenerate(i, r_prev, next_data)

    def regenerate_batch(self, nodes: Sequence[int], r_prevs, next_data, *,
                         tile_symbols: int | None = None) -> torch.Tensor:
        """Batched fused regeneration: (F, S) r_prevs + (F, k, S) helpers ->
        (F, 2, S) [a_lost; r_new] stacks, one kernel launch per stream
        tile.  See RepairEngine.regenerate_batch."""
        return self.repair.regenerate_batch(nodes, r_prevs, next_data,
                                            tile_symbols=tile_symbols)

    def regenerate_reference(self, i: int, r_prev, next_data,
                             ) -> tuple[torch.Tensor, torch.Tensor]:
        """The unfused newcomer schedule: two small matmuls plus an
        elementwise correction — the oracle the fused path is held to."""
        k, p = self.k, self.p
        dev = device_of(r_prev, next_data, device=self.device)
        r_prev = as_int32(r_prev, p, dev)
        next_data = as_int32(next_data, p, dev)
        if next_data.shape[0] != k:
            raise ValueError(f"expected {k} helper data blocks, got {next_data.shape[0]}")

        # r_{i-1} = c_k a_{i-1} + sum_{u=1..k-1} c_u a_{(i-1+k-u) mod n}
        # the u-th term's block is next_data[k-u-1]  (t = k-u).
        c = self.c.astype(np.int64)
        if k > 1:
            coefs = as_int32(c[:-1][None, :], p, dev)          # c_1..c_{k-1}
            rows = next_data[torch.arange(k - 2, -1, -1, device=dev)]
            partial = self._matmul(coefs, rows, p)[0]
        else:
            partial = torch.zeros_like(r_prev)
        ck_inv = int(pow(int(c[-1]), p - 2, p))
        a_lost = torch.remainder((r_prev.to(torch.int64) - partial) * ck_inv,
                                 p).to(torch.int32)

        # r_i = sum_{u=1..k} c_u a_{(i-k-u) mod n}; term u uses t = k+1-u,
        # i.e. next_data[k-u]  (t-1 = k-u).
        coefs_all = as_int32(c[None, :], p, dev)
        rows_all = next_data[torch.arange(k - 1, -1, -1, device=dev)]
        r_new = self._matmul(coefs_all, rows_all, p)[0]
        return a_lost, r_new

    # ------------------------------------------------------------- accounting
    def gamma_regenerate_symbols(self, block_symbols: int) -> int:
        """Repair bandwidth in symbols: d * S = (k+1) * B / (2k)."""
        return (self.k + 1) * block_symbols

    def gamma_reconstruct_symbols(self, block_symbols: int) -> int:
        """Classical-EC-style repair (full reconstruction): 2k * S = B."""
        return 2 * self.k * block_symbols

    def alpha_symbols(self, block_symbols: int) -> int:
        """Per-node storage: 2 * S = B / k (MSR point)."""
        return 2 * block_symbols

    def verify_support(self) -> bool:
        for i in range(1, self.n + 1):
            sup = redundancy_support(i, self.n)
            col = self._m[:, i - 1]
            nz = [j for j in range(self.n) if col[j] != 0]
            if sorted(sup) != sorted(nz):
                return False
        return True


# ---------------------------------------------------------------- file-level
@dataclass
class EncodedFile:
    """A file encoded across n nodes: the (n, S) data and redundancy
    blocks as int32 tensors on the code's device."""
    spec: CodeSpec
    data: torch.Tensor        # (n, S) data blocks
    red: torch.Tensor         # (n, S) redundancy blocks
    orig_len: int             # original byte length (before padding)

    def node(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        return self.data[i - 1], self.red[i - 1]


def shares_from_numpy(data: np.ndarray, red: np.ndarray,
                      device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Wrap (n, S) int32 share arrays — e.g. encoded by the JAX reference —
    as int32 tensors on ``device`` (None is the card)."""
    dev = resolve_device(device)
    return (torch.tensor(np.asarray(data, np.int32), device=dev),
            torch.tensor(np.asarray(red, np.int32), device=dev))


def encode_file(payload: bytes, spec: CodeSpec,
                code: DoubleCirculantMSR | None = None, *,
                device=None) -> EncodedFile:
    """Bytes -> GF(p) symbols -> (n, S) blocks -> encode.  The payload
    crosses to the device as bytes and widens to int32 there."""
    if spec.p <= 256:
        raise ValueError("byte embedding requires p > 256")
    code = code or DoubleCirculantMSR(spec, device=device)
    n = spec.n
    raw = torch.frombuffer(bytearray(payload), dtype=torch.uint8) \
        if payload else torch.empty(0, dtype=torch.uint8)
    sym = raw.to(code.device).to(torch.int32)
    pad = (-sym.numel()) % n
    if pad:
        sym = torch.cat([sym, sym.new_zeros(pad)])
    blocks = sym.reshape(n, -1)
    return EncodedFile(spec=spec, data=blocks, red=code.encode(blocks),
                       orig_len=len(payload))


def reconstruct_file(enc: EncodedFile, node_ids: Sequence[int],
                     code: DoubleCirculantMSR | None = None) -> bytes:
    """Any-k decode of an EncodedFile back to the payload bytes (narrowed
    to uint8 on the device, then copied to the host)."""
    code = code or DoubleCirculantMSR(enc.spec, device=enc.data.device)
    idx = torch.as_tensor([i - 1 for i in node_ids], device=enc.data.device)
    blocks = code.reconstruct(node_ids, enc.data[idx], enc.red[idx])
    flat = blocks.reshape(-1)[: enc.orig_len]
    if flat.numel() and (int(flat.max()) > 255 or int(flat.min()) < 0):
        raise ValueError("symbols out of byte range; not a systematic data block")
    return flat.to(torch.uint8).cpu().numpy().tobytes()


__all__ = ["DoubleCirculantMSR", "RepairPlan", "EncodedFile",
           "encode_file", "reconstruct_file", "shares_from_numpy"]
