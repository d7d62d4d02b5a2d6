"""drain.gather_threads: ``stage_stats()["t_gather"]`` over
``stage_stats()["t_read_wait"]``, the mean number of threads filling the
repair's helper windows while the drain tick waits on them: the per-task
gather (reads, CRC verification, row copies into the window's operands)
in thread-seconds summed over the threads that share it, over the
calling thread's wait.  A program without ``t_gather`` reads as
nothing."""


def read(rec):
    stage = rec.counters.get("stage") or {}
    if "t_gather" not in stage or not stage.get("t_read_wait"):
        return None
    return stage["t_gather"] / stage["t_read_wait"]
