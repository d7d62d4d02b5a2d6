"""put.install_threads: ``stage_stats()["t_install"]`` over
``stage_stats()["t_barrier"]``, the mean number of threads at work on the
put's install while the put waits at the pipeline's closing barrier: the
per-share work (block assembly and CRC) in thread-seconds summed over the
threads that share it, over the calling thread's wait.  A program without
``t_install`` reads as nothing."""


def read(rec):
    stage = rec.counters.get("stage") or {}
    if "t_install" not in stage or not stage.get("t_barrier"):
        return None
    return stage["t_install"] / stage["t_barrier"]
