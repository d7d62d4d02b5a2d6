"""What the readers of the program's stage clock share: the stages of
``Pipeline.stage_stats()`` the harness keeps as ``rec.counters["stage"]``
(seconds over the window), per MiB of the cell's work, and the share of
the window that the calling thread's stages leave unaccounted for.  A
program without a stage reads as nothing."""

# the calling thread's stages of a put and of a drain tick
PUT_STAGES = ("t_chunk", "t_read_wait", "t_dispatch", "t_consume",
              "t_barrier", "t_commit")
DRAIN_STAGES = ("t_select", "t_read_wait", "t_dispatch", "t_consume",
                "t_barrier")


def put_mib(rec):
    """MiB put in the window."""
    return rec.put_bytes / 2 ** 20


def share_bytes(rec):
    """Bytes of one share at one byte a symbol: the blocks a share holds
    (2 in the double-circulant code, alpha in product-matrix) times S."""
    return rec.code["share_blocks"] * rec.code["S"]


def rebuilt_mib(rec):
    """MiB of shares rebuilt."""
    return rec.rebuilt_shares * share_bytes(rec) / 2 ** 20


def ms_per_mib(rec, key: str, mib: float):
    """Milliseconds of stage ``key`` per MiB of ``mib``."""
    stage = rec.counters.get("stage") or {}
    if key not in stage or not mib:
        return None
    return 1e3 * stage[key] / mib


def unattributed_pct(rec, keys):
    """100 x the share of the window outside the stages ``keys``."""
    stage = rec.counters.get("stage") or {}
    if not rec.window_s or any(k not in stage for k in keys):
        return None
    return 100.0 * (1.0 - sum(stage[k] for k in keys) / rec.window_s)
