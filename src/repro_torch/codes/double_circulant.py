"""The paper's double-circulant MSR code behind the generic
:class:`~repro_torch.codes.base.ErasureCode` interface (the port of
``repro.codes.double_circulant``, DESIGN.md §15.1).

A thin adapter over `core.msr.DoubleCirculantMSR` /
`core.repair.RepairEngine` — every operation delegates to their planned
kernels, cached inverses and node-invariant repair matrix with untagged
plan keys and the ``[node, a, r]`` share layout (the store wraps its own
live code in it, so its objects keep the bytes, plan keys and compile
counts of the inner code):

* q = 2 blocks per share (a_{j-1}, r_j); D = n payload blocks;
* ``helper_block_ids`` stacks downloads block-major [all data rows; all
  redundancy rows], so ``decode_rows`` rides the RepairEngine's
  family-keyed inverse cache unchanged;
* the repair plan is the embedded property: d = k+1 determined helpers
  (prev sends its redundancy block, next k send their data blocks —
  one-hot send matrices, zero helper-side field ops), and the newcomer
  matrix is the node-invariant (2, k+1) fused repair matrix, so a repair
  window is two operands — each task's r_prev row and its k data rows —
  regenerated in ONE shared-matrix ``regenerate_batch`` launch.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.circulant import CodeSpec
from repro_torch.core.msr import DoubleCirculantMSR
from repro_torch.exec.plan import PlanResult

from .base import CodeClass, CodeRepairPlan, ErasureCode
from .crc import share_crc
from .registry import FAMILY_DOUBLE_CIRCULANT, register_family


@register_family(FAMILY_DOUBLE_CIRCULANT)
class DoubleCirculantCode(ErasureCode):
    """ErasureCode adapter for the [n = 2k, k], d = k+1 paper code.

    Parameters
    ----------
    code_class : CodeClass
        Must satisfy n = 2k, d = k+1 (the family's only shape).
    inner : DoubleCirculantMSR, optional
        Reuse an existing code instance — the store wraps its live
        ``store.code`` so the adapter shares its planner, decode-inverse
        cache, backend selection and device.
    mesh : StreamMesh | int | None, optional
        Stream-axis mesh of a new inner code (None: the ambient
        ``use_mesh`` scope); an ``inner`` code keeps its own.
    device : torch.device or str, optional
        Where a new inner code computes (None is the card, or the mesh's
        first device).
    """

    def __init__(self, code_class: CodeClass, *, backend: Optional[str] = None,
                 mesh=None, inner: Optional[DoubleCirculantMSR] = None,
                 device=None):
        if code_class.family != self.family:
            raise ValueError(f"wrong family {code_class.family!r}")
        if code_class.n != 2 * code_class.k or code_class.d != code_class.k + 1:
            raise ValueError(
                f"double-circulant requires n = 2k and d = k+1, got "
                f"n={code_class.n}, k={code_class.k}, d={code_class.d}")
        self.code_class = code_class
        self.n, self.k, self.d, self.p = (code_class.n, code_class.k,
                                          code_class.d, code_class.p)
        if inner is not None and (inner.k, inner.p) != (self.k, self.p):
            raise ValueError(f"inner code (k={inner.k}, p={inner.p}) does "
                             f"not match class {code_class.key()}")
        self.spec = inner.spec if inner is not None else \
            CodeSpec.make(self.k, self.p)
        self.inner = inner if inner is not None else \
            DoubleCirculantMSR(self.spec, backend=backend, mesh=mesh,
                               device=device)
        self.backend_name = self.inner.backend_name
        self.mesh = self.inner.mesh
        self.device = self.inner.device
        self.planner = self.inner.planner
        self._plans: dict[int, CodeRepairPlan] = {}

    # ------------------------------------------------------------- geometry
    @property
    def share_blocks(self) -> int:
        return 2

    @property
    def data_blocks(self) -> int:
        return self.n

    @property
    def derived_rows(self) -> int:
        return self.n                    # the (n, S) redundancy matrix

    def data_location(self, m: int) -> tuple[int, int]:
        return m + 1, 0                  # node v_{m+1} stores a_m as block 0

    # --------------------------------------------------------------- encode
    def encode_derived_planned(self, flat: np.ndarray) -> PlanResult:
        return self.inner.encode_planned(flat)

    def stripe_share_blocks(self, data: np.ndarray, derived: np.ndarray,
                            node: int) -> list:
        return [data[node - 1], derived[node - 1]]

    # --------------------------------------------------------------- decode
    def helper_block_ids(self, subset: Sequence[int],
                         ) -> list[tuple[int, int]]:
        # block-major stacking [a rows; r rows]: the cached RepairEngine
        # inverses expect exactly this download layout
        return [(j, 0) for j in subset] + [(j, 1) for j in subset]

    def decode_rows(self, subset: Sequence[int],
                    rows_needed: Sequence[int]) -> np.ndarray:
        return self.inner.repair.decode_matrix(tuple(subset))[
            list(rows_needed)]

    def share_rows(self, subset: Sequence[int],
                   lost_nodes: Sequence[int]) -> np.ndarray:
        lost = [int(f) for f in lost_nodes]
        mat = self.inner.repair.decode_repair_matrix(tuple(subset), lost)
        rows = []
        for j, f in enumerate(lost):
            rows.append(mat[f - 1])          # data block a_{f-1}
            rows.append(mat[self.n + j])     # re-encoded redundancy r_f
        return np.stack(rows)

    # ----------------------------------------------------------- regenerate
    def repair_plan(self, node: int,
                    available: Optional[Sequence[int]] = None,
                    ) -> Optional[CodeRepairPlan]:
        plan = self._plans.get(node)
        if plan is None:
            # determined by the node alone: built once per node
            inner = self.inner.repair_plan(node)
            send_red = np.array([[0, 1]], np.int32)    # prev sends r_{prev}
            send_data = np.array([[1, 0]], np.int32)   # next k send a_{j-1}
            plan = self._plans[node] = CodeRepairPlan(
                node=node, helpers=(inner.prev_node,) + inner.next_nodes,
                send_matrices=(send_red,) + (send_data,) * self.k,
                blocks_downloaded=self.k + 1)
        if available is not None:
            avail = set(available)
            if any(h not in avail for h in plan.helpers):
                return None              # embedded helpers are DETERMINED
        return plan

    def newcomer_matrix(self, plan: CodeRepairPlan) -> np.ndarray:
        # node-invariant (2, k+1) fused repair matrix — valid only for
        # the embedded helper order the plan encodes
        expected = self.repair_plan(plan.node)
        if plan.helpers != expected.helpers:
            raise ValueError(f"double-circulant repair needs the embedded "
                             f"helper order {expected.helpers}, got "
                             f"{plan.helpers}")
        return self.inner.repair.repair_matrix(plan.node)

    def supports_batched_regen(self) -> bool:
        return True

    # --------------------------------------------------------- repair window
    def window_operand_rows(self, tasks: int) -> tuple[int, ...]:
        return tasks, tasks * self.k     # r_prev rows, helper data rows

    def fill_window_task(self, operands, j: int, plan: CodeRepairPlan,
                         shares) -> None:
        r_prevs, data = operands
        r_prevs[j] = shares[0][2]
        for m, share in enumerate(shares[1:]):
            data[j * self.k + m] = share[1]

    def regenerate_window_planned(self, plans, operands) -> PlanResult:
        # both operands DMA'd as they lie, one gf_matmul launch a window
        r_prevs, data = operands
        return self.inner.repair.regenerate_batch_planned(
            [plan.node for plan in plans], r_prevs,
            data.reshape(len(plans), self.k, -1))

    # ------------------------------------------------------------- dispatch
    def apply_planned(self, mat, blocks) -> PlanResult:
        # untagged: the inner code's own plan keys
        return self.inner.repair.apply_planned(mat, blocks)

    # ------------------------------------------------------------ integrity
    def share_crc_blocks(self, blocks: Sequence[np.ndarray]) -> int:
        return share_crc(blocks[0], blocks[1])


__all__ = ["DoubleCirculantCode"]
