"""put.unattributed_pct: 100 x (1 - the put's calling-thread stages over
the window): the share of the window that ``t_chunk``, ``t_read_wait``,
``t_dispatch``, ``t_consume``, ``t_barrier`` and ``t_commit`` leave
unaccounted for."""
from perfbench import stage_metrics as sm


def read(rec):
    return sm.unattributed_pct(rec, sm.PUT_STAGES)
