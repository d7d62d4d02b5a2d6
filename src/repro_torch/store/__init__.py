"""Coded object store of the port: multi-stripe MSR storage with
put/get/delete/stat, transparent degraded reads, and a prioritized
background repair scheduler (DESIGN.md §10), computing on the CUDA card
by default (``device="cpu"`` for the plain torch versions).

The layer that turns the single-stripe engines (encode dispatch, fused
repair, decode-inverse cache) into a multi-object storage subsystem:

* `stripes.StripeCodec` — chunk arbitrary objects into fixed stripes of
  a code family, encode through one planned launch per window, place
  shares rack-aware on a physical node ring;
* `object_store.CodedObjectStore` — the front-end: one implementation
  of each operation over the object's family codec (the store's
  double-circulant class included), systematic fast-path reads, one
  cached-inverse decode matmul per failure pattern for everything
  missing; put/get/repair all run through the store's overlapped
  I/O⇄compute pipeline and the shape-bucketed execution-plan cache
  (DESIGN.md §11) — zero new compiles at steady state;
* `scheduler.RepairScheduler` — failure-event-driven repair queue,
  priority = remaining redundancy, single-loss stripes coalesced into
  windowed regeneration launches, throttled by a link-bandwidth
  budget.
"""
from .object_store import (FAILED, UP, CodedObjectStore, ConvertReceipt,
                           GetResult, ObjectStat, ShareIntegrityError,
                           StoreAudit, StoreMetrics, UnknownKeyError,
                           share_crc, share_crc_paths, store_from_numpy)
from .scheduler import DrainReport, RepairScheduler
from .stripes import StripeCodec, StripeMap

__all__ = ["CodedObjectStore", "ObjectStat", "GetResult", "ConvertReceipt",
           "StoreAudit", "StoreMetrics", "UnknownKeyError",
           "ShareIntegrityError", "share_crc", "share_crc_paths",
           "store_from_numpy", "RepairScheduler", "DrainReport",
           "StripeCodec", "StripeMap", "UP", "FAILED"]
