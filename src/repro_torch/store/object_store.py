"""Coded object store front-end: put / get / delete / stat over MSR
stripes (the port of ``repro.store.object_store``, DESIGN.md §10).

The store owns a ring of physical nodes (possibly more than the code's
n = 2k) and, per stripe, places the n node shares — pairs
(a_{j-1}, r_j) — via the rotating rack-aware placement of
`store.stripes.StripeManager`.  Every byte it serves is a real field
computation over really-stored symbols, so failures are verifiable
bit-exactly, exactly like the cluster simulator one layer down.

Read paths (DESIGN.md §10.2):

* **systematic fast path** — a stripe whose n data shares are all
  present is served as raw bytes, zero field operations;
* **transparent degraded read** — stripes with missing data blocks are
  grouped by (helper subset, missing set) and ALL missing blocks of a
  group come out of ONE cached-inverse decode matmul: the per-stripe
  (2k, S) downloads concatenate along the symbol axis, so a get that
  spans a thousand stripes after a node failure still costs one
  `gf.gauss_inverse` (LRU-cached) and one ``gf_matmul`` launch per
  failure pattern.

Where things live: shares stay on the host as numpy, as in the
reference — nodes hold shares, and the card (``device=None``) is the
encode / decode / regenerate engine.  Every stream operand reaches it
from a pinned staging buffer of the planner's pool and every result comes
back as an ordinary (pageable) numpy array, so the CRC ledger, fault
injection and scrub are byte-identical to the reference's and a stored
share never holds page-locked memory.

Failures: ``fail_node`` wipes a node's shares and notifies subscribers
(the background `RepairScheduler` enqueues affected stripes);
``replace_node`` brings up an empty newcomer the scheduler rebuilds
shares onto.  A get never blocks on repair — it degrades while the
queue drains.
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.codes import CodeClass, default_code_class, make_code
from repro_torch.codes.double_circulant import DoubleCirculantCode
from repro_torch.core import baselines, gf, placement
from repro_torch.core.circulant import CodeSpec
from repro_torch.core.msr import DoubleCirculantMSR
from repro_torch.cluster.events import Event
from repro_torch.cluster.metrics import LinkModel, MetricsLog
from repro_torch.exec.pipeline import Pipeline
from repro_torch.io.faults import FaultInjector
from repro_torch.io.retry import RetryPolicy, RetryStats

from .stripes import StripeCodec, StripeManager, StripeMap

UP, FAILED = "up", "failed"


class UnknownKeyError(KeyError):
    """``get``/``stat``/``delete`` on a key the store has never committed
    (or has deleted).  A ``KeyError`` subclass, so generic key-miss
    handling — the repair scheduler's pop-time revalidation, ``except
    KeyError`` call sites — keeps working unchanged."""

    def __init__(self, key: str):
        super().__init__(f"unknown key {key!r}")
        self.key = key


class ShareIntegrityError(OSError):
    """A helper share repeatedly failed its put-time CRC on the read
    path feeding a repair or degraded decode (DESIGN.md §13.2).  Raised
    only after re-reads rule out a transient read-path flip — the
    stored copy is rotten; the caller should scrub/drop it (the repair
    scheduler requeues the stripe instead of installing a share rebuilt
    from garbage)."""

    def __init__(self, phys: int, key: str, t: int, attempts: int):
        super().__init__(
            f"share (key={key!r}, stripe={t}) on node {phys} failed its "
            f"CRC {attempts} times — storage rot, not a read-path flip")
        self.phys = phys
        self.key = key
        self.stripe = t


def share_crc(a: np.ndarray, r: np.ndarray) -> int:
    """CRC32 of one node share's LOGICAL payload — the checkpoint
    manifest convention (DESIGN.md §12.2) applied per share: the data
    block as raw uint8 bytes chained with the redundancy block's
    ``pack257`` halves (low bytes, then int64 indexes of 256).  Repairs
    are bit-exact, so a rebuilt share matches its put-time CRC without
    any ledger rewrite.

    Hot on the put/repair install path: zlib reads the array buffers
    directly (no ``.tobytes()`` heap copies) and ``pack257`` is folded
    inline — the truncating uint8 cast IS ``% 256`` for symbols in
    [0, 256].  The same CRC as the reference's for every GF(257) share."""
    c = zlib.crc32(np.ascontiguousarray(a, np.uint8))
    sym = np.ascontiguousarray(r, np.int32).reshape(-1)
    c = zlib.crc32(sym.astype(np.uint8), c)
    return zlib.crc32(
        np.ascontiguousarray(np.nonzero(sym == 256)[0].astype(np.int64)), c)


class StoreMetrics(MetricsLog):
    """Cluster-layer accounting plus the store's write-side counters."""

    def __init__(self):
        super().__init__()
        self.puts_total = 0
        self.put_symbols = 0          # payload symbols accepted
        self.put_stored_symbols = 0   # share symbols written (2x payload)

    def record_put(self, payload_symbols: int, stored_symbols: int) -> None:
        self.puts_total += 1
        self.put_symbols += payload_symbols
        self.put_stored_symbols += stored_symbols

    def summary(self) -> dict:
        out = super().summary()
        out["puts"] = {"total": self.puts_total,
                       "payload_symbols": self.put_symbols,
                       "stored_symbols": self.put_stored_symbols}
        return out


@dataclasses.dataclass
class ObjectStat:
    """Metadata for one stored object (``stat`` result).

    ``dtype``/``shape`` are set for array objects so ``get`` returns the
    original array type; ``meta`` carries caller extras (e.g. the
    checkpointer's tree spec).  ``share_crcs[t][j]`` is the put-time
    :func:`share_crc` of stripe ``t``'s code-node ``j+1`` share — the
    ground truth end-to-end read integrity (DESIGN.md §13.2) verifies
    against; ``None`` only for stats built by callers that predate it.
    """
    key: str
    size_bytes: int
    n_stripes: int
    stripe_symbols: int
    dtype: Optional[str] = None
    shape: Optional[tuple[int, ...]] = None
    meta: dict = dataclasses.field(default_factory=dict)
    share_crcs: Optional[list] = None
    # the object's code class (DESIGN.md §15.1); None means the store's
    # default double-circulant class (stats that predate per-object
    # classes keep working)
    code_class: Optional[CodeClass] = None


@dataclasses.dataclass
class GetResult:
    """``get_ext`` receipt: the object plus what serving it cost."""
    obj: Any
    bytes_read: int
    degraded_stripes: int
    latency_s: float


@dataclasses.dataclass
class ConvertReceipt:
    """:meth:`CodedObjectStore.convert` receipt (DESIGN.md §15.3).

    ``degraded_source_stripes`` counts source stripes that needed a
    decode during the read-out — every other stripe's payload was
    reused straight from systematic shares (the structure-aware fast
    path).  ``bytes_read`` is the read-side traffic; the write side is
    a normal put (accounted in ``store.metrics``).
    """
    key: str
    source: CodeClass
    target: CodeClass
    payload_bytes: int
    source_stripes: int
    target_stripes: int
    degraded_source_stripes: int
    bytes_read: int
    latency_s: float

    @property
    def converted(self) -> bool:
        return self.source != self.target


@dataclasses.dataclass
class StoreAudit:
    """:meth:`CodedObjectStore.audit` receipt (DESIGN.md §12.2).

    ``orphan_shares`` are (phys_node, key, stripe, reason) tuples for
    shares that no committed object accounts for — the residue a crash
    between share placement and the ``_stats`` commit would leave if
    ``put`` were not commit-last, or that direct state corruption
    leaves.  ``stat``/``get`` never see orphans (they walk ``_stats``);
    the audit exists so :meth:`CodedObjectStore.gc_orphans` and the
    drill harness can prove there are none.
    """
    orphan_shares: list = dataclasses.field(default_factory=list)
    shares_checked: int = 0

    @property
    def clean(self) -> bool:
        return not self.orphan_shares


class CodedObjectStore:
    """Multi-object MSR storage over a physical node ring.

    Parameters
    ----------
    spec : CodeSpec
        The double circulant code every stripe is encoded with.
    n_nodes : int, optional
        Physical ring size (default the code's n = 2k; larger rings
        spread stripes so one node failure touches only a fraction of
        them — that is what makes repair *priorities* meaningful).
    n_racks : int, optional
        Failure domains; default the fewest racks keeping any stripe's
        single-rack loss within n - k (`events.default_layout` formula).
    stripe_symbols : int
        Data-block size S per stripe.
    link : LinkModel, optional
        Deterministic service-time model for read/repair latencies.
    backend : str, optional
        Pin a GF dispatch backend for encode/decode.
    mesh : None or 1
        Stream-axis sharding is not ported yet; anything else raises.
    device : torch.device or str, optional
        Where encode, decode and regenerate compute: None is the CUDA
        card (raises on a host without one), ``"cpu"`` the plain torch
        versions.  Ignored when ``code`` is given (the code owns its
        device).
    io_workers, pipeline_depth : int
        The store's overlapped I/O⇄compute engine (DESIGN.md §11.3):
        share placement / download gathering runs on ``io_workers`` pool
        threads while the next window's planned GF dispatch computes;
        ``pipeline_depth=1`` disables the overlap (serial baseline) and
        ``pipeline_depth=None`` (default) auto-sizes to the machine —
        depth 2 with >= 2 CPUs, the serial schedule on a single-core
        host where overlap cannot win (DESIGN.md §16.4).
    put_tile_stripes : int
        Stripes per encode window on the put path — each window is one
        planned circulant dispatch whose share placement overlaps the
        next window's encode.
    repair_tile_tasks : int
        Repair tasks per coalesced ``regenerate_batch`` dispatch in
        :meth:`repair_stripes_embedded` (the batch axis is bucketed, so
        variable task counts share plan keys).
    faults : FaultInjector, optional
        Fault-injection seam (DESIGN.md §12.4): every share read/write
        consults ``faults.apply(op, "node:NN")`` so drills inject
        per-node transient failures and latency.  ``None`` (production)
        short-circuits the guard entirely.
    retry : RetryPolicy, optional
        How guarded share ops retry transient faults (DESIGN.md §12.3);
        give-ups surface as typed ``GiveUpError``.  Accounting lands in
        ``self.retry_stats``.

    Examples
    --------
    >>> from repro_torch.core.circulant import CodeSpec
    >>> store = CodedObjectStore(CodeSpec.make(2, 257), stripe_symbols=16,
    ...                          device="cpu")
    >>> _ = store.put("hello", b"payload bytes")
    >>> store.get("hello")
    b'payload bytes'
    """

    def __init__(self, spec: CodeSpec, *, n_nodes: Optional[int] = None,
                 n_racks: Optional[int] = None, stripe_symbols: int = 1 << 12,
                 link: Optional[LinkModel] = None,
                 backend: Optional[str] = None,
                 code: Optional[DoubleCirculantMSR] = None,
                 io_workers: int = 4, pipeline_depth: Optional[int] = None,
                 put_tile_stripes: int = 64,
                 repair_tile_tasks: int = 64,
                 faults: Optional[FaultInjector] = None,
                 retry: Optional[RetryPolicy] = None,
                 mesh=None, device=None):
        if mesh is not None and mesh != 1:
            raise NotImplementedError(
                "stream-axis mesh sharding is not ported yet; pass mesh=None")
        self.spec = spec
        self.k, self.n, self.p = spec.k, spec.n, spec.p
        self.n_nodes = int(n_nodes if n_nodes is not None else spec.n)
        if self.n_nodes < spec.n:
            raise ValueError(f"need >= n = {spec.n} physical nodes, "
                             f"got {self.n_nodes}")
        if n_racks is None:
            n_racks = self._default_racks(spec, self.n_nodes)
        self.layout = placement.rack_layout(self.n_nodes, n_racks)
        self.stripes = StripeManager(spec, self.layout,
                                     stripe_symbols=stripe_symbols,
                                     code=code, backend=backend,
                                     device=device)
        self.code = self.stripes.code
        self.S = self.stripes.stripe_symbols
        self.link = link or LinkModel()
        self.state = [UP] * self.n_nodes
        # _shares[phys-1][(key, stripe)] = [code_node, a_block, r_block]
        self._shares: list[dict[tuple[str, int], list]] = \
            [dict() for _ in range(self.n_nodes)]
        self._stats: dict[str, ObjectStat] = {}
        self._next_stripe = 0          # rotation phase for the next put
        self.metrics = StoreMetrics()
        self._subscribers: list[Callable[[Event], None]] = []
        self.put_tile_stripes = max(1, int(put_tile_stripes))
        self.repair_tile_tasks = max(1, int(repair_tile_tasks))
        # fault-injection seam (DESIGN.md §12): every share read/write is
        # guarded by faults.apply("read"/"write", "node:NN") under the
        # retry policy; faults=None short-circuits to zero overhead
        self.faults = faults
        self.retry = retry or RetryPolicy()
        self.retry_stats = RetryStats()
        # persistent overlapped I/O⇄compute engine (DESIGN.md §11.3):
        # pool threads are reused across put/get/repair calls.  Depth
        # auto-sizes to the machine (DESIGN.md §16.4): on a single-core
        # host the host/compute overlap cannot win — read-ahead and
        # install offload just add thread switching — so the default
        # degenerates to the serial depth-1 schedule there.
        if pipeline_depth is None:
            pipeline_depth = 2 if (os.cpu_count() or 1) >= 2 else 1
        self.pipeline = Pipeline(io_workers=io_workers, depth=pipeline_depth)
        # per-object code classes (DESIGN.md §15): objects default to the
        # store's double-circulant class and take the battle-tested legacy
        # paths; other classes dispatch through their family's codec
        self.default_class = default_code_class(spec)
        self._codecs: dict[str, StripeCodec] = {}

    @staticmethod
    def _default_racks(spec: CodeSpec, n_nodes: int) -> int:
        """Fewest racks (>= 2) whose rotating share windows stay within
        the n - k budget on THIS ring.  The `events.default_layout`
        formula ceil(n / (n-k)) is only exact when the window never
        wraps (n_nodes a multiple of the rack count); wrapping can put
        one extra share in a rack, so candidates are checked against
        every rotation phase and bumped until safe — n_nodes racks
        (one node per rack) always terminates the search."""
        budget = spec.n - spec.k
        for cand in range(max(2, -(-spec.n // max(1, budget))),
                          n_nodes + 1):
            layout = placement.rack_layout(n_nodes, cand)
            worst = max(placement.max_shares_per_rack(
                layout, placement.rotate_placement(layout, spec.n, t))
                for t in range(n_nodes))
            if worst <= budget:
                return cand
        return n_nodes

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Shut the store's pipeline pool down (its threads are
        non-daemon; long-lived processes that churn store instances
        should close them — or use the store as a context manager).
        The store remains usable afterwards: the pool respawns lazily.
        """
        self.pipeline.close()

    def __enter__(self) -> "CodedObjectStore":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ---------------------------------------------------------- staging pool
    def _stage_into(self, planner, rows: int, s: int):
        """A pooled (rows, extent) int32 staging buffer — pinned when the
        planner computes on the card — for a stream operand of true
        extent ``s``, or None when the code has no planner (custom matmul
        backends).

        Callers fill the buffer and hand it WHOLE to the planned op.  Its
        extent is the planner's ``stream_pad(s)``, which here is ``s``
        itself (the kernels mask the ragged edge, so there is no zero
        tail to write), and the planner DMAs its own pool's buffer as it
        lies — the flatten /
        gather copy is the only host copy (DESIGN.md §16.1).  Release the
        buffer only after the consuming ``PlanResult.host()`` returned
        (§16.2)."""
        if planner is None:
            return None
        _, pad = planner.stream_pad(s)
        return planner.staging.acquire((rows, pad), np.int32)

    def _install(self, work) -> None:
        """Run share-install work (CRC + staging copies) on the pipeline
        pool only when it can genuinely overlap the next window's
        dispatch (depth > 1).  A depth-1 store runs it inline: its pool
        has one worker, so offloading would just move the same wall
        time behind the trailing barrier AND let installs overlap the
        main thread — a depth-1 store must stay a true serial baseline
        for the overlap benchmark (DESIGN.md §16.3)."""
        if self.pipeline.depth > 1:
            self.pipeline.submit(work)
        else:
            work()

    # ------------------------------------------------------------ node state
    def subscribe(self, fn: Callable[[Event], None]) -> None:
        """Register a callback for store events (``fail`` on node loss) —
        the repair scheduler's feed, same Event type the cluster
        simulator publishes."""
        self._subscribers.append(fn)

    def _notify(self, event: Event) -> None:
        for fn in self._subscribers:
            fn(event)

    def is_up(self, node: int) -> bool:
        return self.state[node - 1] == UP

    def up_nodes(self) -> list[int]:
        return [i + 1 for i in range(self.n_nodes) if self.state[i] == UP]

    def fail_node(self, node: int, t: float = 0.0) -> None:
        """Node crash: every share it held is lost; subscribers (the
        repair scheduler) are notified with a ``fail`` event."""
        self._check_node(node)
        self.state[node - 1] = FAILED
        self._shares[node - 1].clear()
        self._notify(Event(t=t, kind="fail", node=node))

    def replace_node(self, node: int, t: float = 0.0) -> None:
        """An empty newcomer takes the failed node's slot: UP, no shares.
        Subscribers see an ``up`` event so the scheduler re-protects any
        share the slot should hold but doesn't — including shares that
        were *lost at birth* (``put`` while the node was FAILED), whose
        loss never produced a ``fail`` event."""
        self._check_node(node)
        self.state[node - 1] = UP
        self._notify(Event(t=t, kind="up", node=node))

    def _check_node(self, node: int) -> int:
        if not 1 <= node <= self.n_nodes:
            raise ValueError(f"node {node} out of range 1..{self.n_nodes}")
        return node

    # --------------------------------------------------------- fault seam
    def _guard(self, op: str, phys: int) -> None:
        """Route a share operation on physical node ``phys`` through the
        fault seam under the retry policy.  No injector → no overhead;
        persistent injected faults surface as ``GiveUpError``."""
        if self.faults is None:
            return
        ref = f"node:{phys:02d}"
        self.retry.call(lambda: self.faults.apply(op, ref),
                        op=f"{op}:{ref}", stats=self.retry_stats)

    def read_share(self, phys: int, key: str, t: int, *,
                   budget_s: Optional[float] = None) -> list:
        """The (code_node, a_block, r_block) share of stripe (key, t) on
        ``phys`` — every read path funnels through here so drills can
        inject per-node read faults.  Matched ``corrupt`` rules return a
        damaged COPY (backing storage intact — the read-path bit-rot a
        CRC-checking caller must catch); ``latency`` sleeps; transient
        kinds retry under the policy, capped by ``budget_s`` when a
        serving deadline bounds the fetch (DESIGN.md §13.1).  Raises
        ``KeyError`` when the share is absent, ``GiveUpError`` when the
        retry budget is spent."""
        if self.faults is None:
            return self._shares[phys - 1][(key, t)]
        ref = f"node:{phys:02d}"
        return self.retry.call(
            lambda: self.faults.apply_share(
                "read", ref, self._shares[phys - 1][(key, t)]),
            op=f"read:{ref}", stats=self.retry_stats, budget_s=budget_s)

    def _read_share(self, phys: int, key: str, t: int) -> list:
        return self.read_share(phys, key, t)

    def _read_share_verified(self, phys: int, key: str, t: int,
                             attempts: int = 3) -> list:
        """A share fetch CRC-gated against the put-time ledger — the
        read path feeding repairs and degraded decodes, where one
        corrupt helper silently poisons every rebuilt block.  A
        mismatch is re-read (transient read-path flip); persistent
        mismatch raises :class:`ShareIntegrityError` (storage rot —
        decode around it, don't decode FROM it).  Objects without a
        ledger pass through unchecked."""
        stat = self._stats.get(key)
        for _ in range(attempts):
            share = self.read_share(phys, key, t)
            if stat is None or stat.share_crcs is None \
                    or self._share_crc_of(stat, share) == \
                    stat.share_crcs[t][share[0] - 1]:
                return share
        raise ShareIntegrityError(phys, key, t, attempts)

    # ------------------------------------------------------- code classes
    def class_of(self, key: str) -> CodeClass:
        """The code class ``key`` was stored under (DESIGN.md §15.1)."""
        return self._stat_class(self.stat(key))

    def _stat_class(self, stat: ObjectStat) -> CodeClass:
        return stat.code_class if stat.code_class is not None \
            else self.default_class

    def _is_default(self, cc: CodeClass) -> bool:
        return cc == self.default_class

    def _codec_for(self, cc: CodeClass) -> StripeCodec:
        """The (cached) stripe codec of a code class.  The default class
        wraps the store's live code instance, so its planner, decode
        inverses and plan keys are shared with the legacy paths; other
        classes build their family from the registry on the same layout
        and device (raises if the layout cannot place them rack-safely)."""
        codec = self._codecs.get(cc.key())
        if codec is None:
            if self._is_default(cc):
                code = DoubleCirculantCode(cc, inner=self.code)
            else:
                code = make_code(cc, device=self.code.device)
            codec = StripeCodec(code, self.layout, stripe_symbols=self.S)
            self._codecs[cc.key()] = codec
        return codec

    def codec_of(self, key: str) -> StripeCodec:
        """The stripe codec serving ``key`` (placement, geometry, and the
        live :class:`~repro.codes.base.ErasureCode`)."""
        return self._codec_for(self.class_of(key))

    def _share_crc_of(self, stat: ObjectStat, share: list) -> int:
        """Put-time CRC formula of a share under the object's family."""
        cc = self._stat_class(stat)
        if self._is_default(cc):
            return share_crc(share[1], share[2])
        return self._codec_for(cc).code.share_crc_blocks(share[1:])

    # -------------------------------------------------------------- put path
    def put(self, key: str, obj: Any, *, meta: Optional[dict] = None,
            code_class: Optional[CodeClass] = None) -> ObjectStat:
        """Store ``obj`` (bytes or numpy array) under ``key``.

        The object is striped and encoded in ``put_tile_stripes``-wide
        windows, each ONE planned circulant encode launch (shape-bucketed
        plan keys — no new compiles at steady state), with window t's
        share placement overlapping window t+1's encode through the
        store pipeline (DESIGN.md §11.3).  Shares whose placed node is
        FAILED are simply absent (lost-at-birth) — a later ``get``
        degrades around them and the scheduler can rebuild them once
        the slot is replaced.  Re-putting an existing key overwrites it.

        **Atomicity** (DESIGN.md §12.2): shares are *staged* while the
        windows stream and only installed — ``_stats`` entry last —
        after every share write succeeded.  A put that dies mid-flight
        (injected ``GiveUpError``, encode error) leaves the store
        exactly as it was: no partial shares, and on overwrite the old
        object still fully readable.

        ``code_class`` selects the erasure-code family the object is
        encoded with (DESIGN.md §15.1); ``None`` (and the store's
        default class) keeps the double-circulant fast paths.
        """
        dtype = shape = None
        if isinstance(obj, np.ndarray):
            dtype, shape = str(obj.dtype), tuple(obj.shape)
            payload = obj.tobytes()
        elif isinstance(obj, (bytes, bytearray, memoryview)):
            payload = bytes(obj)
        else:
            raise TypeError(f"store objects are bytes or numpy arrays, "
                            f"got {type(obj).__name__}")
        cc = code_class if code_class is not None else self.default_class
        if not self._is_default(cc):
            return self._put_generic(key, payload, dtype, shape, meta, cc)
        blocks, smap = self.stripes.chunk(payload)
        base = self._next_stripe
        self._next_stripe += smap.n_stripes
        tile = self.put_tile_stripes
        # installs keep views into the per-put block/redundancy arrays
        # (each share aliases a disjoint slice, so scrub and fault drills
        # behave as with copies)

        planner = getattr(self.code, "planner", None)

        def flatten_window(t0: int):
            # host transpose on the pool — overlaps the previous window's
            # encode and the one before's share placement.  With the
            # planner on, the transpose lands directly in a pooled
            # (pinned on the card) staging buffer the planner DMAs as it
            # lies (zero-copy path, DESIGN.md §16.1).
            tb = blocks[t0: t0 + tile]
            tt = tb.shape[0]
            buf = self._stage_into(planner, self.n, tt * self.S)
            if buf is None:
                return tt, self.stripes.flatten(tb)
            self.stripes.flatten(tb, out=buf[:, :tt * self.S])
            return tt, buf

        def encode_window(t0: int, flat):
            tt, view = flat
            return tt, self.code.encode_planned(view), view

        staged: list[tuple[int, int, list]] = []    # (phys, t, share)
        # put-time integrity ledger: share_crcs[t][j] covers EVERY share,
        # including lost-at-birth ones a repair rebuilds later bit-exactly
        crcs: list[list[int]] = [[0] * self.n for _ in range(smap.n_stripes)]

        def place_window(t0: int, res) -> None:
            tt, planned, view = res
            raw = planned.host()        # dispatch done: staging reusable
            if planner is not None:
                planner.staging.release(view)

            def install() -> None:
                # CRC + share copies off the critical thread: the pool
                # installs window t while window t+1's encode dispatches
                red = self.stripes.unflatten(raw[:, :tt * self.S], tt)
                for t in range(t0, t0 + tt):
                    pl = self.stripes.placement(base + t)
                    for j, phys in enumerate(pl):
                        a_blk, r_blk = blocks[t, j], red[t - t0, j]
                        crcs[t][j] = share_crc(a_blk, r_blk)
                        if self.is_up(phys):
                            self._guard("write", phys)
                            staged.append((phys, t, [j + 1, a_blk, r_blk]))

            self._install(install)

        self.pipeline.map(range(0, smap.n_stripes, tile),
                          encode_window, place_window, read=flatten_window)
        # commit point: every share write succeeded.  Retire the old
        # generation (overwrite case), install the staged shares, and
        # only THEN publish the key — a crash or give-up before this
        # line leaves no observable trace of the new put.
        if key in self._stats:
            self.delete(key)
        for phys, t, share in staged:
            if self.is_up(phys):        # node may have died mid-put
                self._shares[phys - 1][(key, t)] = share
        stat = ObjectStat(key=key, size_bytes=smap.orig_bytes,
                          n_stripes=smap.n_stripes, stripe_symbols=self.S,
                          dtype=dtype, shape=shape, meta=dict(meta or {}),
                          share_crcs=crcs, code_class=self.default_class)
        stat.meta["_base_stripe"] = base
        self._stats[key] = stat
        self.metrics.record_put(smap.n_stripes * self.n * self.S,
                                2 * smap.n_stripes * self.n * self.S)
        return stat

    def _put_generic(self, key: str, payload: bytes, dtype, shape,
                     meta: Optional[dict], cc: CodeClass) -> ObjectStat:
        """Family-generic put (DESIGN.md §15.1): same windowed
        encode-overlaps-placement pipeline and the same commit-last
        atomicity as the default path, dispatched through the object's
        codec.  Shares are ``[code_node, blk_0, ..., blk_{q-1}]``."""
        codec = self._codec_for(cc)
        code = codec.code
        n, q, d_blocks = codec.n, code.share_blocks, code.data_blocks
        blocks, smap = codec.chunk(payload)
        base = self._next_stripe
        self._next_stripe += smap.n_stripes
        tile = self.put_tile_stripes

        planner = getattr(code, "planner", None)

        def flatten_window(t0: int):
            tb = blocks[t0: t0 + tile]
            tt = tb.shape[0]
            buf = self._stage_into(planner, d_blocks, tt * self.S)
            if buf is None:
                return tt, codec.flatten(tb)
            codec.flatten(tb, out=buf[:, :tt * self.S])
            return tt, buf

        def encode_window(t0: int, flat):
            tt, view = flat
            return tt, code.encode_derived_planned(view), view

        staged: list[tuple[int, int, list]] = []    # (phys, t, share)
        crcs: list[list[int]] = [[0] * n for _ in range(smap.n_stripes)]

        def place_window(t0: int, res) -> None:
            tt, planned, view = res
            raw = planned.host()
            if planner is not None:
                planner.staging.release(view)

            def install() -> None:
                derived = codec.unflatten_rows(raw[:, :tt * self.S],
                                               code.derived_rows, tt)
                for t in range(t0, t0 + tt):
                    pl = codec.placement(base + t)
                    for j, phys in enumerate(pl):
                        blks = code.stripe_share_blocks(
                            blocks[t], derived[t - t0], j + 1)
                        crcs[t][j] = code.share_crc_blocks(blks)
                        if self.is_up(phys):
                            self._guard("write", phys)
                            staged.append((phys, t, [j + 1] + [
                                np.asarray(b, np.int32) for b in blks]))

            self._install(install)

        self.pipeline.map(range(0, smap.n_stripes, tile),
                          encode_window, place_window, read=flatten_window)
        # commit point — identical semantics to the default path: retire
        # the old generation, install, publish the stat entry LAST
        if key in self._stats:
            self.delete(key)
        for phys, t, share in staged:
            if self.is_up(phys):
                self._shares[phys - 1][(key, t)] = share
        stat = ObjectStat(key=key, size_bytes=smap.orig_bytes,
                          n_stripes=smap.n_stripes, stripe_symbols=self.S,
                          dtype=dtype, shape=shape, meta=dict(meta or {}),
                          share_crcs=crcs, code_class=cc)
        stat.meta["_base_stripe"] = base
        self._stats[key] = stat
        self.metrics.record_put(smap.n_stripes * d_blocks * self.S,
                                smap.n_stripes * n * q * self.S)
        return stat

    # -------------------------------------------------------------- get path
    def get(self, key: str) -> Any:
        """The stored object, bit-exact, systematic when healthy and
        transparently degraded otherwise (see :meth:`get_ext`)."""
        return self.get_ext(key).obj

    def get_ext(self, key: str) -> GetResult:
        """Read with a receipt (bytes read, degraded stripes, latency).

        All missing data blocks of the request are batched: stripes are
        grouped by (helper subset, missing set) and each group is decoded
        in ONE cached-inverse matmul over the symbol-axis-concatenated
        downloads (DESIGN.md §10.2).  Groups run through the store
        pipeline — download gathering on the pool, the planned decode
        launch overlapped with the previous group's scatter
        (DESIGN.md §11.3).

        Raises
        ------
        UnknownKeyError
            Key never committed (a ``KeyError`` subclass).
        RuntimeError
            Some stripe has fewer than k shares left (data loss).
        """
        stat = self.stat(key)
        if not self._is_default(self._stat_class(stat)):
            return self._get_generic(stat)
        base = stat.meta["_base_stripe"]
        blocks = np.zeros((stat.n_stripes, self.n, self.S), np.int32)
        # group degraded stripes by failure pattern
        groups: dict[tuple, list[int]] = {}
        latency = 0.0
        bytes_read = 0
        for t in range(stat.n_stripes):
            pl = self.stripes.placement(base + t)
            present = self._present_code_nodes(key, t, pl)
            missing = tuple(j for j in range(self.n)
                            if j + 1 not in present)
            if not missing:
                for j in range(self.n):
                    blocks[t, j] = self._read_share(pl[j], key, t)[1]
                lat = self.link.fetch_s(self.S)
                self.metrics.record_read("systematic", lat, self.n * self.S)
                latency = max(latency, lat)
                bytes_read += self.n * self.S
                continue
            if len(present) < self.k:
                self.metrics.record_read("failed", 0.0, 0)
                raise RuntimeError(
                    f"data loss: stripe {t} of {key!r} has only "
                    f"{len(present)} of k={self.k} shares")
            helpers = tuple(sorted(present)[: self.k])
            # present data blocks are still served systematically — and
            # billed as such, one record per block, matching the cluster
            # simulator's read_all convention (the 2kS degraded billing
            # below covers only the decode download set)
            sys_lat = self.link.fetch_s(self.S)
            for j in range(self.n):
                if j + 1 in present:
                    blocks[t, j] = self._read_share(pl[j], key, t)[1]
                    self.metrics.record_read("systematic", sys_lat, self.S)
                    bytes_read += self.S
            latency = max(latency, sys_lat)
            groups.setdefault((helpers, missing), []).append(t)
        acct = {"bytes": 0, "latency": 0.0}
        planner = getattr(self.code, "planner", None)

        def gather(item):
            (helpers, _missing), ts = item
            # pooled gather staging (DESIGN.md §16.1): the per-stripe
            # downloads land directly in the buffer the decode reads —
            # no concatenate copy, no second copy to pinned memory
            buf = self._stage_into(planner, 2 * self.k, len(ts) * self.S)
            if buf is None:
                return np.concatenate([self._downloads(key, t, helpers)
                                       for t in ts], axis=1)    # (2k, G*S)
            for g, t in enumerate(ts):
                buf[:, g * self.S:(g + 1) * self.S] = \
                    self._downloads(key, t, helpers)
            return buf

        def decode(item, downloads):
            (helpers, missing), _ts = item
            mat = self.code.repair.decode_matrix(helpers)
            return self.code.repair.apply_planned(mat[list(missing)],
                                                  downloads), downloads

        def scatter(item, res) -> None:
            (_helpers, missing), ts = item
            planned, downloads = res
            decoded = planned.host()
            if planner is not None:
                planner.staging.release(downloads)
            for g, t in enumerate(ts):
                blocks[t, list(missing)] = \
                    decoded[:, g * self.S:(g + 1) * self.S]
            lat = self.link.degraded_read_s(2 * self.S, [1.0] * self.k)
            # one download set per stripe in the group
            for _ in ts:
                self.metrics.record_read("degraded", lat, 2 * self.k * self.S)
            acct["latency"] = max(acct["latency"], lat)
            acct["bytes"] += 2 * self.k * self.S * len(ts)

        self.pipeline.map(groups.items(), decode, scatter, read=gather)
        latency = max(latency, acct["latency"])
        bytes_read += acct["bytes"]
        return GetResult(obj=self.materialize(stat, blocks),
                         bytes_read=bytes_read,
                         degraded_stripes=sum(len(v) for v in groups.values()),
                         latency_s=latency)

    def _get_generic(self, stat: ObjectStat) -> GetResult:
        """Family-generic read (DESIGN.md §15.1): systematic payload
        rows served raw, missing rows decoded through the object's
        family — grouped by failure pattern, one cached-inverse matmul
        per group over symbol-axis-concatenated downloads, exactly the
        default path's shape."""
        key = stat.key
        cc = self._stat_class(stat)
        codec = self._codec_for(cc)
        code = codec.code
        n, k, q = codec.n, codec.k, code.share_blocks
        d_blocks = code.data_blocks
        base = stat.meta["_base_stripe"]
        locs = [code.data_location(m) for m in range(d_blocks)]
        blocks = np.zeros((stat.n_stripes, d_blocks, self.S), np.int32)
        groups: dict[tuple, list[int]] = {}
        latency = 0.0
        bytes_read = 0
        for t in range(stat.n_stripes):
            pl = codec.placement(base + t)
            present = self._present_code_nodes(key, t, pl)
            missing_rows = tuple(m for m, (j, _b) in enumerate(locs)
                                 if j not in present)
            if not missing_rows:
                for m, (j, b) in enumerate(locs):
                    blocks[t, m] = self._read_share(pl[j - 1], key, t)[1 + b]
                lat = self.link.fetch_s(q * self.S)
                self.metrics.record_read("systematic", lat, d_blocks * self.S)
                latency = max(latency, lat)
                bytes_read += d_blocks * self.S
                continue
            if len(present) < k:
                self.metrics.record_read("failed", 0.0, 0)
                raise RuntimeError(
                    f"data loss: stripe {t} of {key!r} has only "
                    f"{len(present)} of k={k} shares")
            helpers = tuple(sorted(present)[:k])
            sys_lat = self.link.fetch_s(q * self.S)
            for m, (j, b) in enumerate(locs):
                if j in present:
                    blocks[t, m] = self._read_share(pl[j - 1], key, t)[1 + b]
                    self.metrics.record_read("systematic", sys_lat, self.S)
                    bytes_read += self.S
            latency = max(latency, sys_lat)
            groups.setdefault((helpers, missing_rows), []).append(t)
        acct = {"bytes": 0, "latency": 0.0}
        planner = getattr(code, "planner", None)

        def gather(item):
            (helpers, _missing), ts = item
            buf = self._stage_into(planner, k * q, len(ts) * self.S)
            if buf is None:
                return np.concatenate(
                    [self._downloads_generic(key, t, helpers, codec)
                     for t in ts], axis=1)                # (k*q, G*S)
            for g, t in enumerate(ts):
                buf[:, g * self.S:(g + 1) * self.S] = \
                    self._downloads_generic(key, t, helpers, codec)
            return buf

        def decode(item, downloads):
            (helpers, missing), _ts = item
            return code.apply_planned(
                code.decode_rows(helpers, list(missing)), downloads), \
                downloads

        def scatter(item, res) -> None:
            (_helpers, missing), ts = item
            planned, downloads = res
            decoded = planned.host()
            if planner is not None:
                planner.staging.release(downloads)
            for g, t in enumerate(ts):
                blocks[t, list(missing)] = \
                    decoded[:, g * self.S:(g + 1) * self.S]
            lat = self.link.degraded_read_s(q * self.S, [1.0] * k)
            for _ in ts:
                self.metrics.record_read("degraded", lat, k * q * self.S)
            acct["latency"] = max(acct["latency"], lat)
            acct["bytes"] += k * q * self.S * len(ts)

        self.pipeline.map(groups.items(), decode, scatter, read=gather)
        latency = max(latency, acct["latency"])
        bytes_read += acct["bytes"]
        return GetResult(obj=self.materialize(stat, blocks),
                         bytes_read=bytes_read,
                         degraded_stripes=sum(len(v) for v in groups.values()),
                         latency_s=latency)

    def _downloads_generic(self, key: str, t: int, helpers: Sequence[int],
                           codec: StripeCodec) -> np.ndarray:
        """(k*q, S) stacked helper blocks in the family's
        ``helper_block_ids`` order — CRC-verified like the default
        path's ``_downloads``."""
        base = self.stat(key).meta["_base_stripe"]
        pl = codec.placement(base + t)
        shares = {j: self._read_share_verified(pl[j - 1], key, t)
                  for j in helpers}
        return np.stack([np.asarray(shares[j][1 + b], np.int32)
                         for j, b in codec.code.helper_block_ids(helpers)])

    def materialize(self, stat: ObjectStat, blocks: np.ndarray) -> Any:
        """(n_stripes, D, S) data blocks -> the stored object (bytes or
        the original array type) — the shared tail of every read path
        (``get_ext`` and the serving front end's coalesced decodes).
        D is the object's family payload width (n for the default
        double-circulant class)."""
        cc = self._stat_class(stat)
        if self._is_default(cc):
            payload = self.stripes.assemble(
                blocks, StripeMap(stat.size_bytes, stat.n_stripes, self.S))
        else:
            payload = self._codec_for(cc).assemble(
                blocks, StripeMap(stat.size_bytes, stat.n_stripes, self.S))
        if stat.dtype is None:
            return payload
        return np.frombuffer(payload, dtype=np.dtype(stat.dtype)) \
            .reshape(stat.shape).copy()

    def _present_code_nodes(self, key: str, t: int,
                            pl: Sequence[int]) -> set[int]:
        return {j + 1 for j, phys in enumerate(pl)
                if (key, t) in self._shares[phys - 1]}

    def placement_of(self, key: str, t: int) -> tuple[int, ...]:
        """Physical nodes hosting stripe ``t`` of ``key``, by code node
        (index j holds code node j+1) — the front end's placement seam.
        Length is the object's family n (the default class's n for
        legacy objects)."""
        stat = self.stat(key)
        base = stat.meta["_base_stripe"]
        cc = self._stat_class(stat)
        if self._is_default(cc):
            return self.stripes.placement(base + t)
        return self._codec_for(cc).placement(base + t)

    def present_code_nodes(self, key: str, t: int) -> set[int]:
        """Code nodes (1-indexed) of stripe (key, t) whose share is
        physically present."""
        return self._present_code_nodes(key, t, self.placement_of(key, t))

    def _downloads(self, key: str, t: int,
                   helpers: Sequence[int]) -> np.ndarray:
        """(2k, S) stacked [data; red] blocks of the helper code nodes —
        CRC-verified: a decode matmul multiplies every helper into every
        output, so one rotten input corrupts the whole stripe."""
        pl = self.stripes.placement(self.stat(key).meta["_base_stripe"] + t)
        shares = [self._read_share_verified(pl[i - 1], key, t)
                  for i in helpers]
        return np.concatenate([np.stack([s[1] for s in shares]),
                               np.stack([s[2] for s in shares])], axis=0)

    # ----------------------------------------------------------- delete/stat
    def delete(self, key: str) -> None:
        """Drop the object and notify subscribers with a ``delete`` event
        so the repair scheduler purges its queued tasks instead of
        re-validating them forever.  Raises :class:`UnknownKeyError`."""
        stat = self.stat(key)
        for t in range(stat.n_stripes):
            for shares in self._shares:
                shares.pop((key, t), None)
        del self._stats[key]
        self._notify(Event(t=0.0, kind="delete", key=key))

    def stat(self, key: str) -> ObjectStat:
        try:
            return self._stats[key]
        except KeyError:
            raise UnknownKeyError(key) from None

    def keys(self) -> list[str]:
        return sorted(self._stats)

    # -------------------------------------------------------- pytree objects
    def put_pytree(self, key: str, tree: Any) -> ObjectStat:
        """Store a tree of tensors / numpy arrays (nested dicts, lists,
        tuples) as one object, with the reference's byte layout: leaves in
        its flatten order (a dict's keys sorted), bfloat16 leaves as their
        16-bit patterns (:mod:`repro_torch.core.placement`)."""
        payload, treedef, metas = placement.pytree_to_bytes(tree)
        return self.put(key, payload,
                        meta={"treedef": treedef, "leaves": metas})

    def get_pytree(self, key: str) -> Any:
        """The tree stored by :meth:`put_pytree`, its leaves as tensors on
        the store's device."""
        stat = self.stat(key)
        if "treedef" not in stat.meta:
            raise TypeError(f"{key!r} was not stored with put_pytree")
        payload = self.get(key)
        leaves = placement.bytes_to_leaves(payload, stat.meta["leaves"],
                                           device=self.code.device)
        return stat.meta["treedef"].unflatten(leaves)

    # ------------------------------------------------------- code conversion
    def convert(self, key: str,
                target_class: CodeClass) -> ConvertReceipt:
        """Re-encode ``key`` under ``target_class``, online and atomic
        (DESIGN.md §15.3).

        The object is read through the normal (possibly degraded) read
        path — systematic source shares are reused raw, only missing
        payload rows are decoded — and re-put under the target family.
        The put's commit-last protocol makes the switch atomic: shares
        are staged first, the old generation is retired and the manifest
        republished only after every target share write succeeded.  A
        crash mid-convert (injected ``GiveUpError``, encode failure)
        leaves the source object fully readable and nothing but staged
        garbage ``gc_orphans`` collects — reads are served throughout.

        Converting to the class the object already has is a no-op.
        """
        stat = self.stat(key)
        source = self._stat_class(stat)
        if target_class == source:
            return ConvertReceipt(
                key=key, source=source, target=target_class,
                payload_bytes=stat.size_bytes,
                source_stripes=stat.n_stripes,
                target_stripes=stat.n_stripes,
                degraded_source_stripes=0, bytes_read=0, latency_s=0.0)
        if not self._is_default(target_class):
            # fail fast (unknown family, unsafe layout) BEFORE reading
            self._codec_for(target_class)
        res = self.get_ext(key)
        meta = {mk: mv for mk, mv in stat.meta.items()
                if mk != "_base_stripe"}
        new_stat = self.put(key, res.obj, meta=meta,
                            code_class=target_class)
        return ConvertReceipt(
            key=key, source=source, target=target_class,
            payload_bytes=stat.size_bytes,
            source_stripes=stat.n_stripes,
            target_stripes=new_stat.n_stripes,
            degraded_source_stripes=res.degraded_stripes,
            bytes_read=res.bytes_read, latency_s=res.latency_s)

    # ------------------------------------------------------- repair surface
    def stripe_refs(self) -> Iterator[tuple[str, int]]:
        """All (key, stripe) pairs currently stored."""
        for key, stat in self._stats.items():
            for t in range(stat.n_stripes):
                yield key, t

    def stripes_on(self, node: int) -> list[tuple[str, int]]:
        """Stripes that PLACE a share on ``node`` (present or lost) —
        what a failure of ``node`` puts at risk."""
        self._check_node(node)
        out = []
        for key, t in self.stripe_refs():
            if node in self.placement_of(key, t):
                out.append((key, t))
        return out

    def lost_code_nodes(self, key: str, t: int) -> tuple[int, ...]:
        """Code nodes (1-indexed) of stripe (key, t) whose share is absent
        — lost to failures, or never written (placed on a dead node)."""
        pl = self.placement_of(key, t)
        present = self._present_code_nodes(key, t, pl)
        return tuple(i for i in range(1, len(pl) + 1) if i not in present)

    def embedded_helpers_present(self, key: str, t: int,
                                 code_node: int) -> bool:
        """True when a d-helper regeneration plan for ``code_node`` is
        available from the shares actually present — for the default
        double-circulant class that means its d = k+1 DETERMINED helpers
        all hold their shares (the cheap (k+1)S regeneration); other
        families consult their own ``repair_plan`` (product-matrix
        accepts ANY d present helpers)."""
        stat = self.stat(key)
        if self._is_default(self._stat_class(stat)):
            base = stat.meta["_base_stripe"]
            pl = self.stripes.placement(base + t)
            plan = self.code.repair_plan(code_node)
            shares = self._shares
            needed = (plan.prev_node,) + plan.next_nodes
            return all((key, t) in shares[pl[i - 1] - 1] for i in needed)
        return self.regen_plan_for(key, t, code_node) is not None

    def regen_plan_for(self, key: str, t: int, code_node: int):
        """The object's family :class:`~repro.codes.base.CodeRepairPlan`
        for regenerating ``code_node`` from the shares present, or None
        when the family cannot build one (fall back to full decode)."""
        codec = self.codec_of(key)
        pl = self.placement_of(key, t)
        present = sorted(self._present_code_nodes(key, t, pl))
        return codec.code.repair_plan(code_node, available=present)

    def repair_stripes_embedded(self, tasks: Sequence[tuple[str, int, int]],
                                ) -> tuple[int, int]:
        """Regenerate one lost share per task through coalesced
        ``regenerate_batch`` launches (the scheduler's path,
        DESIGN.md §10.3), pipelined in ``repair_tile_tasks``-wide
        windows: window t's helper gathering runs on the pool and its
        share writes overlap window t+1's planned launch (§11.3) — one
        ``gf_matmul`` launch per window, the shared repair matrix read
        with batch stride 0.  The batch axis is bucketed in the plan
        key, so drains of different sizes share one plan.

        tasks: (key, stripe, lost_code_node) triples, each single-loss
        with a regeneration plan available (caller-checked).  The
        default class's repair matrix is node-invariant, so stripes that
        lost DIFFERENT code nodes still share a launch; tasks
        of other code classes regenerate through their family's plan
        (``d * S`` symbols each, one dispatch per task — only families
        with ``supports_batched_regen()`` coalesce).  Returns (symbols
        moved, dispatch count).
        """
        if not tasks:
            return 0, 0
        legacy, generic = [], []
        for task in tasks:
            (legacy if self._is_default(self.class_of(task[0]))
             else generic).append(task)
        if generic:
            symbols, dispatches = self._repair_generic(generic)
            if legacy:
                s2, d2 = self.repair_stripes_embedded(legacy)
                symbols, dispatches = symbols + s2, dispatches + d2
            return symbols, dispatches
        tasks = legacy
        tile = self.repair_tile_tasks
        windows = [tasks[i: i + tile] for i in range(0, len(tasks), tile)]

        def gather(window):
            r_prevs, helper_data, placements = [], [], []
            for key, t, node in window:
                base = self.stat(key).meta["_base_stripe"]
                pl = self.stripes.placement(base + t)
                plan = self.code.repair_plan(node)
                r_prevs.append(self._read_share_verified(
                    pl[plan.prev_node - 1], key, t)[2])
                helper_data.append(np.stack(
                    [self._read_share_verified(pl[i - 1], key, t)[1]
                     for i in plan.next_nodes]))
                placements.append(pl)
            return np.stack(r_prevs), np.stack(helper_data), placements

        def regen(window, gathered):
            r_prevs, helper_data, placements = gathered
            res = self.code.repair.regenerate_batch_planned(
                [node for _, _, node in window], r_prevs, helper_data)
            return res, placements

        def land(window, out) -> None:
            res, placements = out
            pairs = res.host()

            def install() -> None:
                # share copies off the critical thread (DESIGN.md §16.3)
                for (key, t, node), pl, pair in zip(window, placements,
                                                    pairs):
                    phys = pl[node - 1]
                    if not self.is_up(phys):
                        raise RuntimeError(f"replace node {phys} before "
                                           f"repairing onto it")
                    self._guard("write", phys)
                    self._shares[phys - 1][(key, t)] = [node, pair[0],
                                                        pair[1]]

            self._install(install)

        self.pipeline.map(windows, regen, land, read=gather)
        return len(tasks) * (self.k + 1) * self.S, len(windows)

    def _repair_generic(self, tasks: Sequence[tuple[str, int, int]],
                        ) -> tuple[int, int]:
        """Family-generic single-loss repairs.  Families whose
        ``supports_batched_regen()`` is True coalesce into windowed
        per-element batched dispatches (``matmul_batch`` — one dispatch
        per ``repair_tile_tasks`` window even though the newcomer
        matrices differ per task, DESIGN.md §16.5); the rest keep the
        one-dispatch-per-task plan path.  Returns (symbols moved,
        dispatch count)."""
        symbols = dispatches = 0
        by_codec: dict[tuple, tuple[StripeCodec, list]] = {}
        for task in tasks:
            codec = self.codec_of(task[0])
            by_codec.setdefault(self.class_of(task[0]).key(),
                                (codec, []))[1].append(task)
        for codec, group in by_codec.values():
            if not codec.code.supports_batched_regen():
                for key, t, node in group:
                    symbols += self._repair_stripe_regen(key, t, node)
                    dispatches += 1
                continue
            s2, d2 = self._repair_generic_batched(codec, group)
            symbols, dispatches = symbols + s2, dispatches + d2
        return symbols, dispatches

    def _repair_generic_batched(self, codec: StripeCodec,
                                tasks: Sequence[tuple[str, int, int]],
                                ) -> tuple[int, int]:
        """Coalesced single-loss regeneration for one non-default
        family: window t's helper sends gather on the pool, each window
        is ONE ``regenerate_many_planned`` dispatch (the (F, q, d)
        newcomer-matrix stack rides the batched per-element matmul),
        and installs overlap the next window's dispatch."""
        code = codec.code
        tile = self.repair_tile_tasks
        windows = [tasks[i: i + tile] for i in range(0, len(tasks), tile)]
        moved = [0]

        def gather(window):
            plans, pairs, placements = [], [], []
            for key, t, node in window:
                pl = self.placement_of(key, t)
                present = sorted(self._present_code_nodes(key, t, pl))
                plan = code.repair_plan(node, available=present)
                if plan is None:
                    raise RuntimeError(f"no regeneration plan for code "
                                       f"node {node} of stripe {t} of "
                                       f"{key!r}")
                pairs += [(sm, self._read_share_verified(pl[h - 1], key, t)
                           [1:]) for sm, h in zip(plan.send_matrices,
                                                  plan.helpers)]
                plans.append(plan)
                placements.append(pl)
            # every helper send of the window in one dispatch
            sends = code.helper_sends(pairs).reshape(
                len(plans), -1, self.S)                  # (F, d, S)
            return plans, sends, placements

        def regen(window, gathered):
            plans, sends, placements = gathered
            return (code.regenerate_many_planned(plans, sends),
                    plans, placements)

        def land(window, out) -> None:
            res, plans, placements = out
            rebuilt = res.host()                         # (F, q, S)
            for (key, t, node), plan, pl, blks in zip(window, plans,
                                                      placements, rebuilt):
                phys = pl[node - 1]
                if not self.is_up(phys):
                    raise RuntimeError(f"replace node {phys} before "
                                       f"repairing onto it")
                self._guard("write", phys)
                self._shares[phys - 1][(key, t)] = [node] + list(blks)
                moved[0] += plan.d * self.S

        self.pipeline.map(windows, regen, land, read=gather)
        return moved[0], len(windows)

    def _repair_stripe_regen(self, key: str, t: int, node: int) -> int:
        """Bandwidth-optimal single-share regeneration through the
        object's family plan (the generic counterpart of the coalesced
        embedded path): helpers apply their (1, q) send matrices, the
        newcomer one (q, d) matmul.  Returns symbols moved: d * S."""
        codec = self.codec_of(key)
        code = codec.code
        pl = self.placement_of(key, t)
        present = sorted(self._present_code_nodes(key, t, pl))
        plan = code.repair_plan(node, available=present)
        if plan is None:
            raise RuntimeError(f"no regeneration plan for code node "
                               f"{node} of stripe {t} of {key!r}")
        sends = code.helper_sends([
            (sm, self._read_share_verified(pl[h - 1], key, t)[1:])
            for sm, h in zip(plan.send_matrices, plan.helpers)])
        rebuilt = code.regenerate(plan, sends)          # (q, S)
        phys = pl[node - 1]
        if not self.is_up(phys):
            raise RuntimeError(f"replace node {phys} before repairing "
                               f"onto it")
        self._guard("write", phys)
        self._shares[phys - 1][(key, t)] = \
            [node] + [np.asarray(b, np.int32).copy() for b in rebuilt]
        return plan.d * self.S

    def repair_stripe_full(self, key: str, t: int,
                           lost: Sequence[int]) -> int:
        """Multi-loss repair: ONE decode matmul rebuilds the stripe's data
        and every lost redundancy block (`reconstruct_with_repair`).
        Returns symbols moved: k * q * S total (2k * S for the default
        class), however many shares come back (ratio 1/F vs the RS
        baseline).
        """
        stat = self.stat(key)
        if not self._is_default(self._stat_class(stat)):
            return self._repair_stripe_full_generic(key, t, lost)
        base = stat.meta["_base_stripe"]
        pl = self.stripes.placement(base + t)
        present = sorted(self._present_code_nodes(key, t, pl))
        if len(present) < self.k:
            raise RuntimeError(f"stripe {t} of {key!r} unrecoverable")
        use = tuple(present[: self.k])
        downloads = self._downloads(key, t, use)
        # planned one-matmul decode + re-encode (combined matrix rides on
        # the cached inverse; same math as reconstruct_with_repair)
        mat = self.code.repair.decode_repair_matrix(use, list(lost))
        data, red_f = self.code.repair.split_decode_output(
            self.code.repair.apply_planned(mat, downloads).host())
        for j, node in enumerate(lost):
            phys = pl[node - 1]
            if not self.is_up(phys):
                raise RuntimeError(f"replace node {phys} before repairing "
                                   f"onto it")
            self._guard("write", phys)
            self._shares[phys - 1][(key, t)] = \
                [node, data[node - 1].copy(), red_f[j].copy()]
        return 2 * self.k * self.S

    def _repair_stripe_full_generic(self, key: str, t: int,
                                    lost: Sequence[int]) -> int:
        """Family-generic multi-loss repair: one ``share_rows`` matmul
        rebuilds every block of every lost node from a k-subset."""
        codec = self.codec_of(key)
        code = codec.code
        q = code.share_blocks
        pl = self.placement_of(key, t)
        present = sorted(self._present_code_nodes(key, t, pl))
        if len(present) < codec.k:
            raise RuntimeError(f"stripe {t} of {key!r} unrecoverable")
        use = tuple(present[: codec.k])
        downloads = self._downloads_generic(key, t, use, codec)
        mat = code.share_rows(use, list(lost))
        out = code.apply_planned(mat, downloads).host()
        for j, node in enumerate(lost):
            phys = pl[node - 1]
            if not self.is_up(phys):
                raise RuntimeError(f"replace node {phys} before repairing "
                                   f"onto it")
            self._guard("write", phys)
            self._shares[phys - 1][(key, t)] = \
                [node] + [out[j * q + b].copy() for b in range(q)]
        return codec.k * q * self.S

    def rs_baseline_symbols(self, n_shares: int) -> int:
        """What a classical [n, k] RS store would download to rebuild
        ``n_shares`` lost shares: the whole file per share (§II)."""
        return baselines.rs_scenario_repair_symbols(self.k, self.S, n_shares)

    def rs_baseline_symbols_for(self, key: str, n_shares: int) -> int:
        """Per-object RS re-download baseline: the object's family file
        size B = k * q * S per rebuilt share (equals the store-wide
        :meth:`rs_baseline_symbols` for default-class objects)."""
        cc = self.class_of(key)
        if self._is_default(cc):
            return self.rs_baseline_symbols(n_shares)
        code = self._codec_for(cc).code
        return n_shares * code.gamma_reconstruct_symbols(self.S)

    # ------------------------------------------------------ share integrity
    def share_intact(self, phys: int, key: str, t: int) -> Optional[bool]:
        """CRC-verify the STORED share directly (no fault seam): the
        front end's arbiter between storage bit-rot and a transient
        read-path flip after a fetched share fails its CRC
        (DESIGN.md §13.2).  ``None`` when the share is absent or the
        object predates CRC recording."""
        self._check_node(phys)
        share = self._shares[phys - 1].get((key, t))
        stat = self._stats.get(key)
        if share is None or stat is None or stat.share_crcs is None:
            return None
        return self._share_crc_of(stat, share) == \
            stat.share_crcs[t][share[0] - 1]

    def drop_share(self, phys: int, key: str, t: int) -> bool:
        """Erase one stored share (the quarantine path: a share whose
        storage failed its CRC is an erasure — reads decode around it
        and the scheduler rebuilds it).  True if a share was dropped."""
        self._check_node(phys)
        return self._shares[phys - 1].pop((key, t), None) is not None

    def scrub_node(self, phys: int) -> list[tuple[str, int]]:
        """Targeted integrity scrub of one node: CRC-verify every stored
        share on ``phys`` against its put-time ledger, bypassing the
        fault seam (re-admission gate of the quarantine state machine,
        DESIGN.md §13.3).  Returns the (key, stripe) mismatches; shares
        without a ledger entry are skipped, not flagged."""
        self._check_node(phys)
        bad = []
        for (key, t), share in self._shares[phys - 1].items():
            stat = self._stats.get(key)
            if stat is None or stat.share_crcs is None \
                    or t >= stat.n_stripes:
                continue
            if self._share_crc_of(stat, share) != \
                    stat.share_crcs[t][share[0] - 1]:
                bad.append((key, t))
        return sorted(bad)

    # ------------------------------------------------------------ inspection
    def audit(self) -> StoreAudit:
        """Walk every physically-held share and flag orphans — shares no
        committed object accounts for (DESIGN.md §12.2): unknown key,
        stripe index past the object's extent, a share sitting on a
        node its stripe's placement never assigned it to, or (new
        orphan class, DESIGN.md §13.2) a share whose content fails its
        put-time CRC — silent bit-rot ``gc_orphans`` converts into an
        honest erasure the scheduler can repair."""
        report = StoreAudit()
        for node0, shares in enumerate(self._shares):
            for (key, t), share in shares.items():
                report.shares_checked += 1
                stat = self._stats.get(key)
                if stat is None:
                    report.orphan_shares.append(
                        (node0 + 1, key, t, "unknown key"))
                elif t >= stat.n_stripes:
                    report.orphan_shares.append(
                        (node0 + 1, key, t, "stripe out of range"))
                else:
                    pl = self.placement_of(key, t)
                    if pl[share[0] - 1] != node0 + 1:
                        report.orphan_shares.append(
                            (node0 + 1, key, t, "placement mismatch"))
                    elif stat.share_crcs is not None and \
                            self._share_crc_of(stat, share) != \
                            stat.share_crcs[t][share[0] - 1]:
                        report.orphan_shares.append(
                            (node0 + 1, key, t, "crc mismatch"))
        return report

    def gc_orphans(self) -> int:
        """Drop every orphan share :meth:`audit` flags; returns how many
        were collected (startup-recovery hygiene, DESIGN.md §12.2)."""
        orphans = self.audit().orphan_shares
        for phys, key, t, _reason in orphans:
            self._shares[phys - 1].pop((key, t), None)
        return len(orphans)

    def verify(self) -> bool:
        """Ground-truth audit: no orphan shares, and every present share
        equals a fresh encode of its object (the simulator's
        ``bit_exact`` check, store-wide)."""
        if not self.audit().clean:
            return False
        for key, stat in self._stats.items():
            base = stat.meta["_base_stripe"]
            obj = self.get(key)
            payload = obj.tobytes() if isinstance(obj, np.ndarray) else obj
            cc = self._stat_class(stat)
            if not self._is_default(cc):
                if not self._verify_generic(key, stat, payload, cc):
                    return False
                continue
            blocks, smap = self.stripes.chunk(payload)
            red = self.stripes.encode(blocks)
            for t in range(stat.n_stripes):
                pl = self.stripes.placement(base + t)
                for j, phys in enumerate(pl):
                    share = self._shares[phys - 1].get((key, t))
                    if share is None:
                        continue
                    if not (np.array_equal(share[1], blocks[t, j])
                            and np.array_equal(share[2], red[t, j])):
                        return False
        return True

    def _verify_generic(self, key: str, stat: ObjectStat, payload: bytes,
                        cc: CodeClass) -> bool:
        """Ground-truth re-encode comparison for a non-default-class
        object: every present share block equals a fresh encode."""
        codec = self._codec_for(cc)
        code = codec.code
        blocks, _smap = codec.chunk(payload)
        derived = codec.encode_window(blocks)
        for t in range(stat.n_stripes):
            pl = codec.placement(stat.meta["_base_stripe"] + t)
            for j, phys in enumerate(pl):
                share = self._shares[phys - 1].get((key, t))
                if share is None:
                    continue
                expect = code.stripe_share_blocks(blocks[t], derived[t],
                                                  j + 1)
                if not all(np.array_equal(share[1 + b],
                                          np.asarray(expect[b], np.int32))
                           for b in range(code.share_blocks)):
                    return False
        return True

    def total_lost_shares(self) -> int:
        return sum(len(self.lost_code_nodes(key, t))
                   for key, t in self.stripe_refs())


def store_from_numpy(spec: CodeSpec, shares: Sequence[dict],
                     stats, *, n_nodes: int, n_racks: Optional[int] = None,
                     stripe_symbols: int, device=None) -> CodedObjectStore:
    """A store of the port holding state written elsewhere — e.g. by the
    reference package — the store counterpart of
    :func:`repro_torch.core.msr.shares_from_numpy`.

    Parameters
    ----------
    spec : CodeSpec
        The store's default double-circulant code.
    shares : sequence of dict
        Per physical node (index phys - 1), ``{(key, t): [code_node,
        blk_0, ..., blk_{q-1}]}`` with numpy blocks — the reference's
        ``_shares`` layout.  Blocks are copied as int32.
    stats : mapping or iterable of dict
        Each object's :class:`ObjectStat` fields as plain values, with
        ``code_class`` as ``CodeClass.to_meta()`` (or None) and
        ``meta["_base_stripe"]`` its rotation phase.
    n_nodes, n_racks, stripe_symbols :
        The store's geometry (as the writer's).
    device : torch.device or str, optional
        Where the new store computes (None is the card).

    Every node starts UP; the rotation phase of the next put follows the
    last stripe held.
    """
    store = CodedObjectStore(spec, n_nodes=n_nodes, n_racks=n_racks,
                             stripe_symbols=stripe_symbols, device=device)
    if len(shares) != store.n_nodes:
        raise ValueError(f"need one share map per node: {len(shares)} "
                         f"!= {store.n_nodes}")
    for node0, held in enumerate(shares):
        store._shares[node0] = {
            (str(key), int(t)): [int(share[0])] + [
                np.array(b, dtype=np.int32) for b in share[1:]]
            for (key, t), share in held.items()}
    rows = stats.values() if isinstance(stats, dict) else stats
    for row in rows:
        row = dict(row)
        cc = row.get("code_class")
        stat = ObjectStat(
            key=str(row["key"]), size_bytes=int(row["size_bytes"]),
            n_stripes=int(row["n_stripes"]),
            stripe_symbols=int(row["stripe_symbols"]),
            dtype=row.get("dtype"),
            shape=None if row.get("shape") is None
            else tuple(int(x) for x in row["shape"]),
            meta=dict(row.get("meta") or {}),
            share_crcs=None if row.get("share_crcs") is None
            else [[int(c) for c in crcs] for crcs in row["share_crcs"]],
            code_class=None if cc is None else CodeClass.from_meta(cc))
        if stat.stripe_symbols != store.S:
            raise ValueError(f"{stat.key!r} has {stat.stripe_symbols}-symbol "
                             f"stripes, the store {store.S}")
        store._stats[stat.key] = stat
        store._next_stripe = max(store._next_stripe,
                                 stat.meta["_base_stripe"] + stat.n_stripes)
    return store


__all__ = ["CodedObjectStore", "ObjectStat", "GetResult", "ConvertReceipt",
           "StoreAudit", "StoreMetrics", "UnknownKeyError",
           "ShareIntegrityError", "share_crc", "store_from_numpy", "UP",
           "FAILED"]
