"""Fault-injectable I/O substrate (the port of ``repro.io``): blob
backends, retry policy, fault injection (DESIGN.md §12).

The durability seam beneath `repro_torch.store.CodedObjectStore`: every
share operation flows through the store's fault guard (and every file
through a :class:`BlobBackend`) wrapped in a :class:`RetryPolicy`, so
drills can inject torn writes, corrupt/partial reads, transient ``OSError``s and
per-node latency and assert the system recovers bit-exactly.
"""
from .blob import BlobBackend, LocalBlob, count_tmp_orphans
from .faults import FaultInjector, FaultSpec, FaultyBlob
from .retry import (TRANSIENT_ERRORS, GiveUpError, RetryPolicy, RetryStats,
                    fast_retry)

__all__ = [
    "BlobBackend", "LocalBlob", "count_tmp_orphans",
    "FaultInjector", "FaultSpec", "FaultyBlob",
    "RetryPolicy", "RetryStats", "GiveUpError", "TRANSIENT_ERRORS",
    "fast_retry",
]
