"""Closed-loop ingest: one writer puts objects back to back, each
overwriting the least recently written key with the next of
``payload_versions`` payloads made from the seed.

Set-up makes the payloads and fills the store (version v on key v),
which warms the put's shapes.  The window puts until the put that
crosses the deadline has returned.  Every object has the same size.

Mix parameters: ``payload_versions``, more than the number of keys, so
that every put changes the key's bytes.
"""
from perfbench import traffic_gen
from perfbench.profile_reduce import span


def setup(cell) -> None:
    versions = int(cell.mix["payload_versions"])
    size = cell.sizes[0]
    if any(x != size for x in cell.sizes):
        raise ValueError("closed-loop puts need equal object sizes")
    gen = traffic_gen.rng(cell.seed, traffic_gen.STREAM_OBJECTS)
    cell.versions = [traffic_gen.payload(gen, size) for _ in range(versions)]
    for i, key in enumerate(cell.keys):
        cell.put(key, cell.versions[i % versions], i % versions)


def window(cell, t0: float, seconds: float) -> None:
    import time
    rec, i = cell.rec, 0
    while time.perf_counter() - t0 < seconds:
        key_i, ver = traffic_gen.ingest_plan(len(cell.keys),
                                             len(cell.versions), i)
        key, payload = cell.keys[key_i], cell.versions[ver]
        cell.attempted += 1
        with span("put", cell.trace):
            ok = cell.put(key, payload, ver)
        if ok:
            rec.puts += 1
            rec.put_bytes += len(payload)
            rec.put_stripes += cell.ledger.objs[key].stripes
        else:
            cell.failed += 1
        i += 1


def _put_faulty(fault: str):
    """A put that leaves the store unchanged, or installs the first half
    of the object's stripes only."""
    from repro_torch.store import CodedObjectStore
    orig = CodedObjectStore.put

    def put(self, key, obj, **kw):
        if fault == "unchanged":
            return None
        stat = orig(self, key, obj, **kw)
        for t in range(stat.n_stripes // 2, stat.n_stripes):
            for shares in self._shares:
                shares.pop((key, t), None)
        return stat
    return CodedObjectStore, "put", put


FAULTS = {"unchanged": lambda: _put_faulty("unchanged"),
          "half": lambda: _put_faulty("half")}
