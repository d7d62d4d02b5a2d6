"""Coded object store front-end: put / get / delete / stat over MSR
stripes (the port of ``repro.store.object_store``, DESIGN.md §10).

The store owns a ring of physical nodes (possibly more than the code's
n) and, per stripe, places the n node shares via the rotating rack-aware
placement of its `store.stripes.StripeCodec`.  Every byte it serves is a
real field computation over really-stored symbols, so failures are
verifiable bit-exactly, exactly like the cluster simulator one layer
down.

Each object is stored under a code class (DESIGN.md §15.1) — the
store's double-circulant class unless the put names another — and every
operation has one implementation that runs through that class's codec:
the family's :class:`~repro_torch.codes.base.ErasureCode` says what a
share holds, which rows a decode or a repair window reads and how they
are launched; the store owns the windows, the pooled staging, the
pipeline, the CRC checks and the installs.

Read paths (DESIGN.md §10.2):

* **systematic fast path** — a stripe whose data shares are all
  present is served as raw bytes, zero field operations;
* **transparent degraded read** — stripes with missing data blocks are
  grouped by (helper subset, missing set) and ALL missing blocks of a
  group come out of ONE cached-inverse decode matmul: the per-stripe
  downloads concatenate along the symbol axis, so a get that spans a
  thousand stripes after a node failure still costs one
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
from contextlib import contextmanager
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.codes import CodeClass, default_code_class, make_code
from repro_torch.codes.crc import share_crc, share_crc_paths
from repro_torch.codes.double_circulant import DoubleCirculantCode
from repro_torch.core import baselines, placement
from repro_torch.core.circulant import CodeSpec
from repro_torch.core.msr import DoubleCirculantMSR
from repro_torch.cluster.events import Event
from repro_torch.cluster.metrics import LinkModel, MetricsLog
from repro_torch.exec.pipeline import Pipeline
from repro_torch.exec.staging import record_stage, staged, tallied
from repro_torch.io.faults import FaultInjector
from repro_torch.io.retry import RetryPolicy, RetryStats

from .stripes import StripeCodec, StripeMap

UP, FAILED = "up", "failed"

# Stripe units (symbols) from which the repair's helper gather and the
# put's share checks are shared out over the store's pool.  A task's
# share reads, CRCs and row copies are calls that hold the interpreter
# lock for a few microseconds each at small units, and threads that hand
# the lock back and forth at that pace wait on each other: on an H100
# host a drain at S = 4096 ran 2.6-3.2x faster gathering serially, while
# at S = 2^20 the fan-out was 3.8x faster than serial.  The bound between
# the two is not measured.
GATHER_FAN_OUT_MIN_SYMBOLS = 1 << 16


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
    CRC of stripe ``t``'s code-node ``j+1`` share — the ground truth
    end-to-end read integrity (DESIGN.md §13.2) verifies
    against (the family's ``share_crc_blocks``); ``None`` only for
    stats built by callers that predate it.
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

    Every object is stored under a code class (the store's
    double-circulant class unless ``put`` names another) and every
    operation has one implementation over that class's
    :class:`~repro_torch.store.stripes.StripeCodec`: the store owns the
    windows, staging, pipeline, CRC ledger and installs, the family's
    :class:`~repro_torch.codes.base.ErasureCode` what a share holds and
    which rows each launch reads.

    Parameters
    ----------
    spec : CodeSpec
        The store's double circulant code: the class of every object put
        without a ``code_class``.
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
    mesh : StreamMesh | int | None, optional
        Stream-axis device mesh for every planned GF dispatch — put
        encode, degraded-read decode, coalesced repair — forwarded to the
        code (a 1-shard mesh is the plain path).  None inherits the
        ambient ``repro_torch.sharding.mesh.use_mesh(...)`` scope.
        Shares stay numpy on the host, so CRC ledgers and receipts are
        the unsharded store's.
    device : torch.device or str, optional
        Where encode, decode and regenerate compute: None is the CUDA
        card (raises on a host without one) or the mesh's first device,
        ``"cpu"`` the plain torch versions.  Ignored when ``code`` is
        given (the code owns its device).
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
        planned encode dispatch whose share placement overlaps the
        next window's encode.
    repair_tile_tasks : int
        Repair tasks per coalesced regeneration window in
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
        self.spec = spec
        self.k, self.n, self.p = spec.k, spec.n, spec.p
        self.n_nodes = int(n_nodes if n_nodes is not None else spec.n)
        if self.n_nodes < spec.n:
            raise ValueError(f"need >= n = {spec.n} physical nodes, "
                             f"got {self.n_nodes}")
        if n_racks is None:
            n_racks = self._default_racks(spec, self.n_nodes)
        self.layout = placement.rack_layout(self.n_nodes, n_racks)
        # per-object code classes (DESIGN.md §15): one stripe codec per
        # class.  The default class's, built here, wraps the store's own
        # code, so its planner and inverses are the store's; another
        # class's is built on first use
        self.default_class = default_code_class(spec)
        self.code = code or DoubleCirculantMSR(spec, backend=backend,
                                               mesh=mesh, device=device)
        codec = StripeCodec(DoubleCirculantCode(self.default_class,
                                                inner=self.code),
                            self.layout, stripe_symbols=stripe_symbols)
        self._codecs: dict[CodeClass, StripeCodec] = {
            self.default_class: codec}
        self.S = codec.stripe_symbols
        self.link = link or LinkModel()
        self.state = [UP] * self.n_nodes
        # _shares[phys-1][(key, stripe)] = [code_node, blk_0, ..., blk_q-1]
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

    def _fan_out_helpers(self) -> int:
        """Pool threads that join a window's per-share work (the repair's
        helper gather, the put's share checks) beside the thread running
        it, through `Pipeline.fan_out`: ``io_workers - 1`` at depth > 1,
        with no fault injector and stripe units of
        ``GATHER_FAN_OUT_MIN_SYMBOLS`` or more; 0 (serial) otherwise — at
        depth 1 the store's serial baseline, under an injector so its
        seeded draws fire in the reference's order, and below the bound
        where the checks are too short to share the interpreter lock."""
        if self.pipeline.depth > 1 and self.faults is None \
                and self.S >= GATHER_FAN_OUT_MIN_SYMBOLS:
            return self.pipeline.io_workers - 1
        return 0

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

    def _read_share_verified(self, phys: int, key: str, t: int,
                             attempts: int = 3) -> list:
        """A share fetch CRC-gated against the put-time ledger — the
        read path feeding repairs and degraded decodes, where one
        corrupt helper silently poisons every rebuilt block.  A
        mismatch is re-read (transient read-path flip); persistent
        mismatch raises :class:`ShareIntegrityError` (storage rot —
        decode around it, don't decode FROM it).  Objects without a
        ledger pass through unchecked.  The CRC is stage "crc"; callers
        that read many shares run under ``tallied("crc")``, on one thread
        or summed over the threads of `Pipeline.fan_out`: one clock
        record a call or window."""
        stat = self._stats.get(key)
        for _ in range(attempts):
            share = self.read_share(phys, key, t)
            if stat is None or stat.share_crcs is None:
                return share
            with staged("crc"):
                crc = self._share_crc_of(stat, share)
            if crc == stat.share_crcs[t][share[0] - 1]:
                return share
        raise ShareIntegrityError(phys, key, t, attempts)

    # ------------------------------------------------------- code classes
    def class_of(self, key: str) -> CodeClass:
        """The code class ``key`` was stored under (DESIGN.md §15.1)."""
        return self._stat_class(self.stat(key))

    def _stat_class(self, stat: ObjectStat) -> CodeClass:
        return stat.code_class if stat.code_class is not None \
            else self.default_class

    def _codec_for(self, cc: CodeClass) -> StripeCodec:
        """The (cached) stripe codec of a code class.  The default class's
        is built with the store; another class's family comes from the
        registry on the same layout, mesh and device (raises if the
        family is unknown or the layout cannot place it rack-safely)."""
        codec = self._codecs.get(cc)
        if codec is None:
            code = make_code(cc, mesh=self.code.mesh, device=self.code.device)
            codec = StripeCodec(code, self.layout, stripe_symbols=self.S)
            self._codecs[cc] = codec
        return codec

    def codec_of(self, key: str) -> StripeCodec:
        """The stripe codec serving ``key`` (placement, geometry, and the
        live :class:`~repro.codes.base.ErasureCode`)."""
        return self._codec_for(self.class_of(key))

    def _share_crc_of(self, stat: ObjectStat, share: list) -> int:
        """Put-time CRC formula of a share under the object's family."""
        return self._codec_for(self._stat_class(stat)).code \
            .share_crc_blocks(share[1:])

    # -------------------------------------------------------------- put path
    def put(self, key: str, obj: Any, *, meta: Optional[dict] = None,
            code_class: Optional[CodeClass] = None) -> ObjectStat:
        """Store ``obj`` (bytes or numpy array) under ``key``.

        The object is striped and encoded in ``put_tile_stripes``-wide
        windows, each ONE planned encode launch of the object's family
        (shape-bucketed plan keys — no new compiles at steady state),
        with window t's share placement overlapping window t+1's encode
        through the store pipeline (DESIGN.md §11.3).  A window's shares
        are views of its encode result and the payload blocks, where they
        lie; their CRCs are shared out over the pool as the repair's
        gather is (`_fan_out_helpers`), and every share is placed after
        every check has ended.  Shares whose
        placed node is FAILED are simply absent (lost-at-birth) — a later
        ``get`` degrades around them and the scheduler can rebuild them
        once the slot is replaced.  Re-putting an existing key overwrites
        it.

        **Atomicity** (DESIGN.md §12.2): shares are *staged* while the
        windows stream and only installed — ``_stats`` entry last —
        after every share write succeeded.  A put that dies mid-flight
        (injected ``GiveUpError``, encode error) leaves the store
        exactly as it was: no partial shares, and on overwrite the old
        object still fully readable.

        ``code_class`` selects the erasure-code family the object is
        encoded with (DESIGN.md §15.1); ``None`` is the store's default
        double-circulant class.  Shares are ``[code_node, blk_0, ...,
        blk_{q-1}]`` (``[node, a, r]`` for the double-circulant class).
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
        codec = self._codec_for(cc)
        code = codec.code
        n, q, d_blocks = codec.n, code.share_blocks, code.data_blocks
        s = self.S
        with staged("chunk"):
            blocks, smap = codec.chunk(payload)
        base = self._next_stripe
        self._next_stripe += smap.n_stripes
        tile = self.put_tile_stripes
        planner = getattr(code, "planner", None)

        def flatten_window(t0: int):
            # host transpose on the pool — overlaps the previous window's
            # encode and the one before's share placement.  With the
            # planner on, the transpose lands directly in a pooled
            # (pinned on the card) staging buffer the planner DMAs as it
            # lies (zero-copy path, DESIGN.md §16.1).
            tb = blocks[t0: t0 + tile]
            tt = tb.shape[0]
            buf = self._stage_into(planner, d_blocks, tt * s)
            if buf is None:
                return tt, codec.flatten(tb)
            codec.flatten(tb, out=buf[:, :tt * s])
            return tt, buf

        def encode_window(t0: int, flat):
            tt, view = flat
            return tt, code.encode_derived_planned(view), view

        placed: list[tuple[int, int, list]] = []    # (phys, t, share)
        # put-time integrity ledger: share_crcs[t][j] covers EVERY share,
        # including lost-at-birth ones a repair rebuilds later bit-exactly
        crcs: list[list[int]] = [[0] * n for _ in range(smap.n_stripes)]

        def place_window(t0: int, res) -> None:
            tt, planned, view = res
            raw = planned.host()        # dispatch done: staging reusable
            if planner is not None:
                planner.staging.release(view)

            def install() -> None:
                # share checks + placement off the critical thread: the
                # pool installs window t while window t+1's encode
                # dispatches.  Every installed block is a C-contiguous
                # (S,) view of the per-put payload blocks or of this
                # window's encode result, where it lies: the window's
                # i-th stripe's derived rows are the (rows, S) view
                # derived[:, i] (each share aliases a disjoint slice, so
                # scrub and fault drills behave as with copies)
                derived = raw[:, :tt * s].reshape(code.derived_rows, tt, s)
                spent = []      # each thread's crc and install tallies

                @contextmanager
                def tallies():
                    # once a thread: a tally a task would cost more than
                    # a check at small stripe units
                    with tallied("crc", record=False) as crc, \
                            tallied("install", record=False) as took, \
                            staged("install"):
                        spent.append((crc, took))
                        yield

                def check(i: int) -> list:
                    t, j = divmod(i, n)
                    blks = code.stripe_share_blocks(
                        blocks[t0 + t], derived[:, t], j + 1)
                    with staged("crc"):
                        crcs[t0 + t][j] = code.share_crc_blocks(blks)
                    return blks

                try:
                    checked = self.pipeline.fan_out(
                        tt * n, check, helpers=self._fan_out_helpers(),
                        around=tallies)
                finally:
                    # summed over the threads, one record a window (an
                    # error's too: fan_out has waited for every thread)
                    for name, accs in zip(("crc", "install"), zip(*spent)):
                        if any(calls for _, calls in accs):
                            record_stage(name, sum(sec for sec, _ in accs))
                # every share checked: place them in the reference's order
                # (the fault injector's seeded draws fire as there)
                for t in range(t0, t0 + tt):
                    pl = codec.placement(base + t)
                    for j, phys in enumerate(pl):
                        if self.is_up(phys):
                            self._guard("write", phys)
                            placed.append((phys, t, [
                                j + 1, *checked[(t - t0) * n + j]]))

            self._install(install)

        self.pipeline.map(range(0, smap.n_stripes, tile),
                          encode_window, place_window, read=flatten_window)
        # commit point: every share write succeeded.  Retire the old
        # generation (overwrite case), install the staged shares, and
        # only THEN publish the key — a crash or give-up before this
        # line leaves no observable trace of the new put.
        with staged("commit"):
            if key in self._stats:
                self.delete(key)
            for phys, t, share in placed:
                if self.is_up(phys):    # node may have died mid-put
                    self._shares[phys - 1][(key, t)] = share
            stat = ObjectStat(key=key, size_bytes=smap.orig_bytes,
                              n_stripes=smap.n_stripes,
                              stripe_symbols=s, dtype=dtype,
                              shape=shape, meta=dict(meta or {}),
                              share_crcs=crcs, code_class=cc)
            stat.meta["_base_stripe"] = base
            self._stats[key] = stat
            self.metrics.record_put(smap.n_stripes * d_blocks * s,
                                    smap.n_stripes * n * q * s)
        return stat

    # -------------------------------------------------------------- get path
    def get(self, key: str) -> Any:
        """The stored object, bit-exact, systematic when healthy and
        transparently degraded otherwise (see :meth:`get_ext`)."""
        return self.get_ext(key).obj

    def get_ext(self, key: str) -> GetResult:
        """Read with a receipt (bytes read, degraded stripes, latency).

        Systematic payload rows are served raw.  All missing payload rows
        of the request are batched: stripes are grouped by (helper
        subset, missing set) and each group is decoded in ONE
        cached-inverse matmul of the object's family over the
        symbol-axis-concatenated downloads (DESIGN.md §10.2).  Groups run
        through the store pipeline — download gathering on the pool, the
        planned decode launch overlapped with the previous group's
        scatter (DESIGN.md §11.3).

        Raises
        ------
        UnknownKeyError
            Key never committed (a ``KeyError`` subclass).
        RuntimeError
            Some stripe has fewer than k shares left (data loss).
        """
        stat = self.stat(key)
        codec = self._codec_for(self._stat_class(stat))
        code = codec.code
        k, q, s = codec.k, code.share_blocks, self.S
        base = stat.meta["_base_stripe"]
        locs = [code.data_location(m) for m in range(code.data_blocks)]
        # a stripe's systematic fetch is billed as one node's: the payload
        # blocks a systematic node holds, times S
        fetch_symbols = sum(1 for j, _b in locs if j == locs[0][0]) * s
        blocks = np.zeros((stat.n_stripes, len(locs), s), np.int32)
        # group degraded stripes by failure pattern
        groups: dict[tuple, list[int]] = {}
        latency = 0.0
        bytes_read = 0
        for t in range(stat.n_stripes):
            pl = codec.placement(base + t)
            present = self._present_code_nodes(key, t, pl)
            missing = tuple(m for m, (j, _b) in enumerate(locs)
                            if j not in present)
            if not missing:
                for m, (j, b) in enumerate(locs):
                    blocks[t, m] = self.read_share(pl[j - 1], key, t)[1 + b]
                lat = self.link.fetch_s(fetch_symbols)
                self.metrics.record_read("systematic", lat, len(locs) * s)
                latency = max(latency, lat)
                bytes_read += len(locs) * s
                continue
            if len(present) < k:
                self.metrics.record_read("failed", 0.0, 0)
                raise RuntimeError(
                    f"data loss: stripe {t} of {key!r} has only "
                    f"{len(present)} of k={k} shares")
            helpers = tuple(sorted(present)[:k])
            # present payload blocks are still served systematically — and
            # billed as such, one record per block, matching the cluster
            # simulator's read_all convention (the k*q*S degraded billing
            # below covers only the decode download set)
            sys_lat = self.link.fetch_s(fetch_symbols)
            for m, (j, b) in enumerate(locs):
                if j in present:
                    blocks[t, m] = self.read_share(pl[j - 1], key, t)[1 + b]
                    self.metrics.record_read("systematic", sys_lat, s)
                    bytes_read += s
            latency = max(latency, sys_lat)
            groups.setdefault((helpers, missing), []).append(t)
        acct = {"bytes": 0, "latency": 0.0}
        planner = getattr(code, "planner", None)

        @tallied("crc")
        def gather(item):
            (helpers, _missing), ts = item
            # pooled gather staging (DESIGN.md §16.1): the per-stripe
            # downloads land directly in the buffer the decode reads —
            # no concatenate copy, no second copy to pinned memory
            buf = self._stage_into(planner, k * q, len(ts) * s)
            if buf is None:
                buf = np.empty((k * q, len(ts) * s), np.int32)
            for g, t in enumerate(ts):
                self._downloads(code, codec.placement(base + t), key, t,
                                helpers, out=buf[:, g * s:(g + 1) * s])
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
                blocks[t, list(missing)] = decoded[:, g * s:(g + 1) * s]
            lat = self.link.degraded_read_s(q * s, [1.0] * k)
            # one download set per stripe in the group
            for _ in ts:
                self.metrics.record_read("degraded", lat, k * q * s)
            acct["latency"] = max(acct["latency"], lat)
            acct["bytes"] += k * q * s * len(ts)

        self.pipeline.map(groups.items(), decode, scatter, read=gather)
        latency = max(latency, acct["latency"])
        bytes_read += acct["bytes"]
        return GetResult(obj=self.materialize(stat, blocks),
                         bytes_read=bytes_read,
                         degraded_stripes=sum(len(v) for v in groups.values()),
                         latency_s=latency)

    @tallied("crc")
    def _downloads(self, code, pl: Sequence[int], key: str, t: int,
                   helpers: Sequence[int],
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """(k*q, S) stacked blocks of the helper code nodes of stripe
        (key, t), placed at ``pl``, in the family's ``helper_block_ids``
        order, written into ``out`` (a new array when None) —
        CRC-verified: a decode matmul multiplies every helper into every
        output, so one rotten input corrupts the whole stripe."""
        shares = {j: self._read_share_verified(pl[j - 1], key, t)
                  for j in helpers}
        ids = code.helper_block_ids(helpers)
        if out is None:
            out = np.empty((len(ids), self.S), np.int32)
        for row, (j, b) in enumerate(ids):
            out[row] = shares[j][1 + b]
        return out

    def materialize(self, stat: ObjectStat, blocks: np.ndarray) -> Any:
        """(n_stripes, D, S) data blocks -> the stored object (bytes or
        the original array type) — the shared tail of every read path
        (``get_ext`` and the serving front end's coalesced decodes).
        D is the object's family payload width (n for the default
        double-circulant class)."""
        payload = self._codec_for(self._stat_class(stat)).assemble(
            blocks, StripeMap(stat.size_bytes, stat.n_stripes, self.S))
        if stat.dtype is None:
            return payload
        return np.frombuffer(payload, dtype=np.dtype(stat.dtype)) \
            .reshape(stat.shape).copy()

    def _present_code_nodes(self, key: str, t: int,
                            pl: Sequence[int]) -> set[int]:
        return {j + 1 for j, phys in enumerate(pl)
                if (key, t) in self._shares[phys - 1]}

    def _locate(self, key: str, t: int,
                ) -> tuple[StripeCodec, tuple[int, ...]]:
        """The codec of ``key``'s class and stripe ``t``'s placement."""
        stat = self.stat(key)
        codec = self._codec_for(self._stat_class(stat))
        return codec, codec.placement(stat.meta["_base_stripe"] + t)

    def placement_of(self, key: str, t: int) -> tuple[int, ...]:
        """Physical nodes hosting stripe ``t`` of ``key``, by code node
        (index j holds code node j+1) — the front end's placement seam.
        Length is the object's family n."""
        return self._locate(key, t)[1]

    def present_code_nodes(self, key: str, t: int) -> set[int]:
        """Code nodes (1-indexed) of stripe (key, t) whose share is
        physically present."""
        return self._present_code_nodes(key, t, self.placement_of(key, t))

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
        return self.regen_plan_for(key, t, code_node) is not None

    def regen_plan_for(self, key: str, t: int, code_node: int):
        """The object's family :class:`~repro.codes.base.CodeRepairPlan`
        for regenerating ``code_node`` from the shares present, or None
        when the family cannot build one (fall back to full decode)."""
        codec, pl = self._locate(key, t)
        return codec.code.repair_plan(
            code_node, available=self._present_code_nodes(key, t, pl))

    def repair_stripes_embedded(self, tasks: Sequence[tuple[str, int, int]],
                                ) -> tuple[int, int]:
        """Regenerate one lost share per task through coalesced
        regeneration launches (the scheduler's path, DESIGN.md §10.3).

        tasks: (key, stripe, lost_code_node) triples, each single-loss
        with a regeneration plan available (caller-checked).  They are
        split by code class — other classes first, in the order they
        appear, then the store's default class — and each class's tasks
        run through :meth:`_regenerate_windows`.  The double-circulant
        repair matrix is node-invariant, so stripes that lost DIFFERENT
        code nodes still share a launch.  Returns (symbols moved, window
        count).
        """
        groups: dict[CodeClass, list] = {}
        for task in tasks:
            groups.setdefault(self.class_of(task[0]), []).append(task)
        default = groups.pop(self.default_class, None)
        if default is not None:
            groups[self.default_class] = default
        symbols = dispatches = 0
        for cc, group in groups.items():
            moved, windows = self._regenerate_windows(self._codec_for(cc),
                                                      group)
            symbols, dispatches = symbols + moved, dispatches + windows
        return symbols, dispatches

    def _regenerate_windows(self, codec: StripeCodec,
                            tasks: Sequence[tuple[str, int, int]],
                            ) -> tuple[int, int]:
        """One code class's single-loss regenerations, pipelined in
        ``repair_tile_tasks``-wide windows: window t's helper gather runs
        on the pool and its share writes overlap window t+1's planned
        launch (§11.3).  The batch axis is bucketed in the plan key, so
        drains of different sizes share one plan.

        A window's operands are pooled staging buffers (their row counts
        the family's ``window_operand_rows``) that its gather fills in
        place and the planner DMAs as they lie: each task's verified
        helper shares go straight to their rows
        (``fill_window_task``), the tasks shared out over the gathering
        thread and up to ``io_workers - 1`` pool threads
        (`Pipeline.fan_out`) at depth > 1 with no fault injector and
        stripe units of ``GATHER_FAN_OUT_MIN_SYMBOLS`` or more, and taken
        one by one otherwise.  The family launches the window
        (``regenerate_window_planned``): one ``gf_matmul`` launch for the
        double-circulant class.  Every path returns the buffers to the
        pool, an error's too.  Returns (symbols moved, window count).
        """
        code = codec.code
        tile = self.repair_tile_tasks
        windows = [tasks[i: i + tile] for i in range(0, len(tasks), tile)]
        s = self.S
        planner = getattr(code, "planner", None)
        # the gathering thread and up to io_workers - 1 pool threads fill
        # a window's tasks (serial where _fan_out_helpers says so)
        helpers = self._fan_out_helpers()
        held: dict[int, list] = {}      # window -> operands not released
        launched: dict[int, Any] = {}   # window -> its PlanResult

        def operand(rows: int) -> np.ndarray:
            buf = self._stage_into(planner, rows, s)
            return np.empty((rows, s), np.int32) if buf is None else buf

        def release(w: int) -> None:
            for buf in held.pop(w, ()):
                if planner is not None:
                    planner.staging.release(buf)

        def gather(w: int):
            # the window's operands, preallocated and filled in place, row
            # by row: the planner DMAs them as they lie (DESIGN.md §16.1)
            window = windows[w]
            operands = held[w] = [
                operand(rows)
                for rows in code.window_operand_rows(len(window))]
            spent = []      # each task's crc and gather tallies

            def fill(j: int):
                key, t, node = window[j]
                with tallied("crc", record=False) as crc, \
                        tallied("gather", record=False) as took, \
                        staged("gather"):
                    spent.append((crc, took))
                    base = self.stat(key).meta["_base_stripe"]
                    pl = codec.placement(base + t)
                    present = self._present_code_nodes(key, t, pl)
                    plan = code.repair_plan(node, available=present)
                    if plan is None:
                        raise RuntimeError(f"no regeneration plan for code "
                                           f"node {node} of stripe {t} of "
                                           f"{key!r}")
                    code.fill_window_task(operands, j, plan, [
                        self._read_share_verified(pl[h - 1], key, t)
                        for h in plan.helpers])
                return pl, plan

            try:
                filled = self.pipeline.fan_out(len(window), fill,
                                               helpers=helpers)
            finally:
                # summed over the threads, one record a window (an error's
                # too: fan_out has waited for every task it started)
                for name, accs in zip(("crc", "gather"), zip(*spent)):
                    if any(calls for _, calls in accs):
                        record_stage(name, sum(sec for sec, _ in accs))
            return operands, filled

        def regen(w: int, gathered):
            operands, filled = gathered
            try:
                res = code.regenerate_window_planned(
                    [plan for _, plan in filled], operands)
            except BaseException:
                held.pop(w, None)   # a copy may still read them: retired
                raise
            launched[w] = res
            return res, filled

        def land(w: int, out) -> None:
            res, filled = out
            rebuilt = res.host()            # its copies done: reusable
            release(w)

            def install() -> None:
                # share copies off the critical thread (DESIGN.md §16.3)
                for (key, t, node), (pl, _plan), blks in zip(
                        windows[w], filled, rebuilt):
                    phys = pl[node - 1]
                    if not self.is_up(phys):
                        raise RuntimeError(f"replace node {phys} before "
                                           f"repairing onto it")
                    self._guard("write", phys)
                    self._shares[phys - 1][(key, t)] = [node, *blks]

            self._install(install)

        try:
            self.pipeline.map(range(len(windows)), regen, land, read=gather)
        finally:
            # on an error (the map has waited for its running gathers):
            # the operands of every window gathered but not landed go back
            # to the pool, those of a launched window once its copies end
            for w in list(held):
                if w in launched:
                    try:
                        launched[w].host()
                    except Exception:       # noqa: BLE001 (the map raised)
                        held.pop(w)         # never released: retired
                        continue
                release(w)
        return len(tasks) * code.gamma_regenerate_symbols(s), len(windows)

    def repair_stripe_full(self, key: str, t: int,
                           lost: Sequence[int]) -> int:
        """Multi-loss repair: ONE decode matmul (the family's
        ``share_rows``) rebuilds every block of every lost node from a
        k-subset.  Returns symbols moved: k * q * S total (2k * S for the
        double-circulant class), however many shares come back (ratio
        1/F vs the RS baseline).
        """
        codec, pl = self._locate(key, t)
        code = codec.code
        q = code.share_blocks
        present = sorted(self._present_code_nodes(key, t, pl))
        if len(present) < codec.k:
            raise RuntimeError(f"stripe {t} of {key!r} unrecoverable")
        use = tuple(present[: codec.k])
        downloads = self._downloads(code, pl, key, t, use)
        out = code.apply_planned(code.share_rows(use, list(lost)),
                                 downloads).host()
        for j, node in enumerate(lost):
            phys = pl[node - 1]
            if not self.is_up(phys):
                raise RuntimeError(f"replace node {phys} before repairing "
                                   f"onto it")
            self._guard("write", phys)
            self._shares[phys - 1][(key, t)] = \
                [node] + [out[j * q + b].copy() for b in range(q)]
        return code.gamma_reconstruct_symbols(self.S)

    def rs_baseline_symbols(self, n_shares: int) -> int:
        """What a classical [n, k] RS store would download to rebuild
        ``n_shares`` lost shares: the whole file per share (§II)."""
        return baselines.rs_scenario_repair_symbols(self.k, self.S, n_shares)

    def rs_baseline_symbols_for(self, key: str, n_shares: int) -> int:
        """Per-object RS re-download baseline: the object's family file
        size B = k * q * S per rebuilt share (equals the store-wide
        :meth:`rs_baseline_symbols` for default-class objects)."""
        return n_shares * self.codec_of(key).code.gamma_reconstruct_symbols(
            self.S)

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
            codec = self._codec_for(self._stat_class(stat))
            code = codec.code
            obj = self.get(key)
            payload = obj.tobytes() if isinstance(obj, np.ndarray) else obj
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
                    if not all(np.array_equal(share[1 + b], expect[b])
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
           "ShareIntegrityError", "share_crc", "share_crc_paths",
           "store_from_numpy", "UP",
           "FAILED"]
