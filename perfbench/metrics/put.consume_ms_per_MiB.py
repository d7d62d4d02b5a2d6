"""put.consume_ms_per_MiB: the store pipeline's consume stage
(``Pipeline.stage_stats()["t_consume"]``: waiting for each window's
encode, landing it on the host and handing its install on) per MiB put.
The install's CRC and share writes on the pool, and the final barrier,
are outside every stage the program times."""


def read(rec):
    stage = rec.counters.get("stage")
    if not stage or not rec.put_bytes:
        return None
    return 1e3 * stage["t_consume"] / (rec.put_bytes / 2 ** 20)
