"""repair_MBps: bytes of lost shares rebuilt per second of the window,
2 S symbols a share at one byte a symbol.  Counted by the benchmark:
the shares its ledger places on each node it failed whose drain ended
in the window, and those of the node in progress that the store holds
at the close."""


def read(rec):
    if not rec.drain and not rec.rebuilt_shares:
        return None
    return rec.rebuilt_shares * 2 * rec.code["S"] / rec.window_s / 1e6
