"""Per-scenario accounting (the port of ``repro.cluster.metrics``): bytes
moved, read latency, availability (DESIGN.md §9).

Two pieces:

* :class:`LinkModel` — a deterministic service-time model (per-request
  overhead + bytes / bandwidth, scaled by a per-node straggler factor).
  The simulator uses it to *choose* read paths (systematic vs degraded)
  and to report latency distributions without wall-clock noise; the
  benchmark separately measures real wall time for the decode matmuls.
* :class:`MetricsLog` — the accumulator every simulator action reports
  into: read counts by path, simulated latencies, repair/scrub traffic,
  and the RS re-download baseline the repair traffic is ratioed against.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Deterministic network/service model for simulated latencies.

    Parameters
    ----------
    bandwidth_bps : float
        Per-node sequential read bandwidth, bytes/second.
    request_overhead_s : float
        Fixed per-fetch overhead (connection + seek + RPC).
    decode_overhead_s : float
        Added cost of the degraded-read decode matmul.
    """
    bandwidth_bps: float = 1e9
    request_overhead_s: float = 1e-3
    decode_overhead_s: float = 5e-4

    def fetch_s(self, nbytes: int, slow_factor: float = 1.0) -> float:
        """Time to fetch ``nbytes`` from one node running at
        ``slow_factor`` x nominal service time."""
        return (self.request_overhead_s + nbytes / self.bandwidth_bps) \
            * slow_factor

    def degraded_read_s(self, helper_bytes: int,
                        slow_factors: list[float]) -> float:
        """A degraded read fans out to k helpers in parallel: latency is
        the slowest helper fetch plus the decode epilogue."""
        worst = max(slow_factors) if slow_factors else 1.0
        return self.fetch_s(helper_bytes, worst) + self.decode_overhead_s


class MetricsLog:
    """Accumulator for one scenario run.

    Every count is in symbols for traffic (1 symbol ~ 1 byte for GF(257)
    systematic blocks — the convention `MSRCheckpointer.gamma_bytes`
    uses) and in simulated seconds for latencies.
    """

    def __init__(self):
        self.reads_total = 0
        self.reads_systematic = 0
        self.reads_degraded = 0
        self.reads_failed = 0
        self.reads_corrupt = 0
        self.read_latencies: list[float] = []
        self.read_symbols = 0
        self.repair_events = 0
        self.repaired_nodes = 0
        self.repair_symbols = 0
        self.rs_baseline_symbols = 0
        self.scrub_passes = 0
        self.scrub_skipped = 0
        self.scrub_symbols = 0
        self.scrub_flagged = 0

    # ---------------------------------------------------------------- reads
    def record_read(self, path: str, latency_s: float, symbols: int,
                    *, corrupt: bool = False) -> None:
        """``path``: "systematic" | "degraded" | "failed".  ``corrupt``
        marks a read served from silently-damaged storage (latent until
        a scrub): the simulator knows ground truth, a real client would
        not."""
        self.reads_total += 1
        if path == "systematic":
            self.reads_systematic += 1
        elif path == "degraded":
            self.reads_degraded += 1
        elif path == "failed":
            self.reads_failed += 1
            return                      # no bytes served, no latency sample
        else:
            raise ValueError(path)
        if corrupt:
            self.reads_corrupt += 1
        self.read_latencies.append(latency_s)
        self.read_symbols += symbols

    # --------------------------------------------------------------- repair
    def record_repair(self, n_nodes: int, symbols_moved: int,
                      rs_baseline: int) -> None:
        self.repair_events += 1
        self.repaired_nodes += n_nodes
        self.repair_symbols += symbols_moved
        self.rs_baseline_symbols += rs_baseline

    def record_scrub(self, symbols_read: int, flagged: int) -> None:
        self.scrub_passes += 1
        self.scrub_symbols += symbols_read
        self.scrub_flagged += flagged

    def record_scrub_skipped(self) -> None:
        """A scheduled scrub that could not run (nodes unavailable) —
        counted separately so a skipped pass is never mistaken for a
        clean one."""
        self.scrub_skipped += 1

    # -------------------------------------------------------------- derived
    @property
    def availability(self) -> float:
        """Fraction of client reads that were servable (>= k nodes up)."""
        if self.reads_total == 0:
            return 1.0
        return 1.0 - self.reads_failed / self.reads_total

    @property
    def degraded_fraction(self) -> float:
        served = self.reads_total - self.reads_failed
        return self.reads_degraded / served if served else 0.0

    @property
    def repair_ratio_vs_rs(self) -> float | None:
        """Measured repair traffic over the RS re-download baseline —
        (k+1)/(2k) for a lone embedded repair, 1/F for an F-failure
        one-matmul batch; None when the scenario moved no repair bytes."""
        if self.rs_baseline_symbols == 0:
            return None
        return self.repair_symbols / self.rs_baseline_symbols

    def latency_stats(self) -> dict:
        lat = sorted(self.read_latencies)
        if not lat:
            return {"mean_s": 0.0, "p50_s": 0.0, "p99_s": 0.0, "max_s": 0.0}
        return {
            "mean_s": sum(lat) / len(lat),
            "p50_s": lat[len(lat) // 2],
            "p99_s": lat[min(len(lat) - 1, (99 * len(lat)) // 100)],
            "max_s": lat[-1],
        }

    def summary(self) -> dict:
        """JSON-ready roll-up (the per-scenario record in
        ``BENCH_cluster.json``)."""
        ratio = self.repair_ratio_vs_rs
        return {
            "reads": {
                "total": self.reads_total,
                "systematic": self.reads_systematic,
                "degraded": self.reads_degraded,
                "failed": self.reads_failed,
                "served_corrupt": self.reads_corrupt,
                "degraded_fraction": round(self.degraded_fraction, 4),
                "latency": {k: round(v, 6)
                            for k, v in self.latency_stats().items()},
            },
            "availability": round(self.availability, 4),
            "repair": {
                "events": self.repair_events,
                "nodes_repaired": self.repaired_nodes,
                "symbols_moved": self.repair_symbols,
                "rs_baseline_symbols": self.rs_baseline_symbols,
                "ratio_vs_rs": None if ratio is None else round(ratio, 4),
            },
            "scrub": {
                "passes": self.scrub_passes,
                "skipped": self.scrub_skipped,
                "symbols_read": self.scrub_symbols,
                "nodes_flagged": self.scrub_flagged,
            },
        }


__all__ = ["LinkModel", "MetricsLog"]
