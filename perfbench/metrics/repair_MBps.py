"""repair_MBps: bytes of lost shares rebuilt per second of the window,
the blocks a share holds times S symbols a share at one byte a symbol (2
S in the double-circulant code).  Counted by the benchmark: the shares
its ledger places on each node it failed whose drain ended in the
window, and those of the node in progress that the store holds at the
close."""
from perfbench import stage_metrics as sm


def read(rec):
    if not rec.drain and not rec.rebuilt_shares:
        return None
    return rec.rebuilt_shares * sm.share_bytes(rec) / rec.window_s / 1e6
