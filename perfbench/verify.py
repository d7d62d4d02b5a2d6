"""What decides ``correct``: the program's outputs against the plain
reference of the configuration's code family (``reference.py`` for the
double-circulant code, ``reference_pm.py`` for product-matrix MSR),
after the window has closed.

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
* ``share_mismatch`` — shares present whose code node or any block
  differs from the reference's (a rebuilt share is held to the
  reference's regeneration from its helpers, or from d helpers of the
  product-matrix code);
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
from . import reference_pm as ref_pm

CHUNK_SYMBOLS = 1 << 25   # symbols of a block array compared at a time


@dataclasses.dataclass
class Obj:
    payload: bytes
    version: int
    stripes: int


class Ledger:
    """The benchmark's record of what the store should hold.
    ``placement`` is the store's answer to where stripe t of a key lives
    (physical node of each code node's share); a stripe carries
    ``data_blocks`` payload blocks of ``s`` symbols (n by default, the
    double-circulant code's)."""

    def __init__(self, n: int, s: int,
                 placement: Callable[[str, int], Sequence[int]], *,
                 data_blocks: Optional[int] = None):
        self.n, self.s = n, s
        self.data_blocks = n if data_blocks is None else int(data_blocks)
        self.placement_of = placement
        self.objs: dict[str, Obj] = {}

    def put(self, key: str, payload: bytes, version: int) -> Obj:
        """Record a put the store acknowledged."""
        obj = Obj(payload, version,
                  ref.n_stripes(len(payload), self.data_blocks, self.s))
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

    ``code``: the configuration's (``family`` absent is the
    double-circulant code); ``lost``: nodes that are down (their shares
    may be absent); ``rebuilt``: nodes whose shares a repair rebuilt
    (held to the reference's regeneration).  Returns counts by name."""
    out = {"placement_bad": 0, "share_mismatch": 0, "share_missing": 0,
           "shares_checked": 0}
    family = code.get("family", "double-circulant")
    if family == "double-circulant":
        p, c = int(code["p"]), code["c"]

        def check(key, obj, t0, t1):
            _check_chunk(store, ledger, key, obj, t0, t1, c, p, lost,
                         rebuilt, device, out)
    elif family == "product-matrix":
        pm = ref_pm.make(int(code["n"]), int(code["k"]), int(code["d"]),
                         int(code["p"]), tuple(int(g) for g in code["g"]))

        def check(key, obj, t0, t1):
            _check_chunk_pm(store, ledger, key, obj, t0, t1, pm, lost,
                            rebuilt, device, out)
    else:
        raise ValueError(f"unknown code family {family!r}")
    per = max(1, CHUNK_SYMBOLS // (ledger.data_blocks * ledger.s))
    for key, obj in ledger.objs.items():
        for t0 in range(0, obj.stripes, per):
            check(key, obj, t0, min(obj.stripes, t0 + per))
    return out


def placement_ok(pl: Sequence[int], n: int, n_nodes: int) -> bool:
    """The guarantee on where a stripe lives: n distinct nodes of the
    store."""
    return len(pl) == n and len(set(pl)) == n and \
        all(1 <= x <= n_nodes for x in pl)


def _read_chunk(store, ledger, key, t0, t1, take, lost, rebuilt, out,
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read every share of stripes t0..t1-1 of ``key`` where the store
    places it; ``take(row, j, share)`` keeps a share's blocks and raises
    ValueError, TypeError or IndexError on one that is malformed.
    Returns the (stripes, n) masks have, bad and rebuilt."""
    n, tt = ledger.n, t1 - t0
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
                take(t - t0, j, share)
            except (ValueError, TypeError, IndexError):
                bad[t - t0, j] = True
                continue
            have[t - t0, j] = True
    return have, bad, is_rebuilt


def _check_chunk(store, ledger, key, obj, t0, t1, c, p, lost, rebuilt,
                 device, out) -> None:
    n, s = ledger.n, ledger.s
    tt = t1 - t0
    data = ref.chunk(obj.payload, n, s, slice(t0, t1), device)
    red = ref.encode(data, c, p)
    got_a = np.zeros((tt, n, s), np.int32)
    got_r = np.zeros((tt, n, s), np.int32)

    def take(row, j, share):
        got_a[row, j] = share[1]
        got_r[row, j] = share[2]

    have, bad, is_rebuilt = _read_chunk(store, ledger, key, t0, t1, take,
                                        lost, rebuilt, out)
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


def _check_chunk_pm(store, ledger, key, obj, t0, t1, pm, lost, rebuilt,
                    device, out) -> None:
    """The product-matrix body: every block of every share against
    ``reference_pm.encode``; a rebuilt share against the reference's
    regeneration from d helpers, itself held to the encode."""
    n, s, q = pm.n, ledger.s, pm.alpha
    data = ref.chunk(obj.payload, pm.data_blocks, s, slice(t0, t1), device)
    enc = ref_pm.encode(pm, data)                   # (stripes, n, q, S)
    got = np.zeros((t1 - t0, n, q, s), np.int32)

    def take(row, j, share):
        if len(share) != 1 + q:
            raise ValueError("blocks of the share")
        for b in range(q):
            got[row, j, b] = share[1 + b]

    have, bad, is_rebuilt = _read_chunk(store, ledger, key, t0, t1, take,
                                        lost, rebuilt, out)
    want = enc
    if is_rebuilt.any():
        want = enc.clone()
        for j in range(1, n + 1):
            rows = torch.from_numpy(np.nonzero(is_rebuilt[:, j - 1])[0]) \
                .to(device)
            if rows.numel() == 0:
                continue
            hs = ref_pm.helpers(pm, j)
            sends = torch.stack([ref_pm.send(pm, j, enc[rows, h - 1])
                                 for h in hs], dim=-2)
            w = ref_pm.regenerate(pm, j, hs, sends)
            if not torch.equal(w, enc[rows, j - 1]):
                raise AssertionError("reference regeneration disagrees with "
                                     "the reference encode")
            want[rows, j - 1] = w
    eq = (torch.from_numpy(got).to(device) == want).all(-1).all(-1).cpu() \
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
