"""What decides ``correct``: the program's outputs against the plain
reference (``reference.py``), after the window has closed.

The benchmark keeps its own ledger of what it stored: each key's payload
(bytes the benchmark made from the seed) as of the last put the store
acknowledged.  From it the reference recomputes every share of every
stripe.  Where a share lives is the store's own choice: the check asks
the store (its public ``placement_of``), holds the answer to the
guarantee (a stripe's n shares on n distinct nodes of the store), and
reads each share from there through the public ``read_share``.  Every
comparison is exact.

Numbers compared, each with the limit 0:

* ``placement_bad`` — stripes whose placement is not n distinct nodes
  of the store;
* ``share_mismatch`` — shares present whose code node, data block or
  redundancy block differs from the reference's (a rebuilt share is
  held to the reference's regeneration from its helpers);
* ``share_missing`` — shares absent from a node that is up, and every
  share of a stripe the store cannot place;
* ``read_mismatch`` — reads whose bytes differ from the payload the key
  held when the read was served;
* ``read_error`` — reads that raised anything but the front end's
  typed load shed (a shed read counts in ``failed``, not here);
* ``nothing_checked`` — 1 when no share was there to compare.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from . import reference as ref

CHUNK_SYMBOLS = 1 << 25   # symbols of a block array compared at a time


@dataclasses.dataclass
class Obj:
    payload: bytes
    version: int
    stripes: int


class Ledger:
    """The benchmark's record of what the store should hold.
    ``placement`` is the store's answer to where stripe t of a key lives
    (physical node of each code node's share)."""

    def __init__(self, n: int, s: int,
                 placement: Callable[[str, int], Sequence[int]]):
        self.n, self.s = n, s
        self.placement_of = placement
        self.objs: dict[str, Obj] = {}

    def put(self, key: str, payload: bytes, version: int) -> Obj:
        """Record a put the store acknowledged."""
        obj = Obj(payload, version,
                  ref.n_stripes(len(payload), self.n, self.s))
        self.objs[key] = obj
        return obj

    def placement(self, key: str, t: int) -> tuple[int, ...]:
        return tuple(int(x) for x in self.placement_of(key, t))

    def shares_on(self, phys: int) -> list[tuple[str, int, int]]:
        """(key, stripe, code node) of every share placed on ``phys``."""
        out = []
        for key, obj in self.objs.items():
            for t in range(obj.stripes):
                pl = self.placement(key, t)
                if phys in pl:
                    out.append((key, t, pl.index(phys) + 1))
        return out

    def degraded(self, key: str, lost: set[int]) -> tuple[int, int]:
        """(stripes missing a data block, data blocks missing) of a read
        of ``key`` with the nodes ``lost`` down."""
        stripes = blocks = 0
        for t in range(self.objs[key].stripes):
            m = sum(1 for phys in self.placement(key, t) if phys in lost)
            stripes += m > 0
            blocks += m
        return stripes, blocks


def present(store, shares: Iterable[tuple[str, int, int]], phys: int) -> int:
    """How many of ``shares`` on node ``phys`` the store holds."""
    held = 0
    for key, t, _j in shares:
        try:
            store.read_share(phys, key, t)
        except KeyError:
            continue
        held += 1
    return held


def check_store(store, ledger: Ledger, code: dict, *, lost: set[int],
                rebuilt: set[int], device) -> dict:
    """Compare every share of every live object with the reference.

    ``lost``: nodes that are down (their shares may be absent);
    ``rebuilt``: nodes whose shares a repair rebuilt (held to the
    reference's regeneration).  Returns counts by name."""
    p, c = int(code["p"]), code["c"]
    out = {"placement_bad": 0, "share_mismatch": 0, "share_missing": 0,
           "shares_checked": 0}
    per = max(1, CHUNK_SYMBOLS // (ledger.n * ledger.s))
    for key, obj in ledger.objs.items():
        for t0 in range(0, obj.stripes, per):
            t1 = min(obj.stripes, t0 + per)
            _check_chunk(store, ledger, key, obj, t0, t1, c, p, lost,
                         rebuilt, device, out)
    return out


def placement_ok(pl: Sequence[int], n: int, n_nodes: int) -> bool:
    """The guarantee on where a stripe lives: n distinct nodes of the
    store."""
    return len(pl) == n and len(set(pl)) == n and \
        all(1 <= x <= n_nodes for x in pl)


def _check_chunk(store, ledger, key, obj, t0, t1, c, p, lost, rebuilt,
                 device, out) -> None:
    n, s = ledger.n, ledger.s
    tt = t1 - t0
    data = ref.chunk(obj.payload, n, s, slice(t0, t1), device)
    red = ref.encode(data, c, p)
    got_a = np.zeros((tt, n, s), np.int32)
    got_r = np.zeros((tt, n, s), np.int32)
    have = np.zeros((tt, n), bool)
    bad = np.zeros((tt, n), bool)
    is_rebuilt = np.zeros((tt, n), bool)
    for t in range(t0, t1):
        try:
            pl = ledger.placement(key, t)
        except KeyError:                 # the store cannot place it
            out["share_missing"] += n
            continue
        if not placement_ok(pl, n, store.n_nodes):
            out["placement_bad"] += 1
            continue
        for j, phys in enumerate(pl):
            is_rebuilt[t - t0, j] = phys in rebuilt
            try:
                share = store.read_share(phys, key, t)
            except KeyError:
                if phys not in lost:
                    out["share_missing"] += 1
                continue
            try:
                if int(share[0]) != j + 1:
                    raise ValueError("code node")
                got_a[t - t0, j] = share[1]
                got_r[t - t0, j] = share[2]
            except (ValueError, TypeError, IndexError):
                bad[t - t0, j] = True
                continue
            have[t - t0, j] = True
    want_a, want_r = data, red
    if is_rebuilt.any():
        want_a, want_r = data.clone(), red.clone()
        for j in range(1, n + 1):
            rows = torch.from_numpy(np.nonzero(is_rebuilt[:, j - 1])[0]) \
                .to(device)
            if rows.numel() == 0:
                continue
            prev, nxt = ref.helpers(j, n)
            a_new, r_new = ref.regenerate(
                j, red[rows, prev - 1], data[rows][:, [x - 1 for x in nxt]],
                c, p)
            if not (torch.equal(a_new, data[rows, j - 1])
                    and torch.equal(r_new, red[rows, j - 1])):
                raise AssertionError("reference regeneration disagrees with "
                                     "the reference encode")
            want_a[rows, j - 1] = a_new
            want_r[rows, j - 1] = r_new
    eq = ((torch.from_numpy(got_a).to(device) == want_a).all(-1)
          & (torch.from_numpy(got_r).to(device) == want_r).all(-1)).cpu() \
        .numpy()
    out["share_mismatch"] += int((have & ~eq).sum() + bad.sum())
    out["shares_checked"] += int(have.sum() + bad.sum())


def check_reads(answers: list[tuple[Optional[bytes], Optional[bytes],
                                    Optional[BaseException]]],
                shed_type: type) -> dict:
    """``answers``: (bytes returned, payload expected, error) per read."""
    mismatch = error = 0
    for got, want, err in answers:
        if err is not None:
            error += not isinstance(err, shed_type)
        elif got != want:
            mismatch += 1
    return {"read_mismatch": mismatch, "read_error": error,
            "reads_checked": len(answers)}


LIMITS = {"placement_bad": 0, "share_mismatch": 0, "share_missing": 0,
          "read_mismatch": 0, "read_error": 0, "nothing_checked": 0}


__all__ = ["Obj", "Ledger", "present", "placement_ok", "check_store",
           "check_reads", "LIMITS"]
