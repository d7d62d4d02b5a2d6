"""drain.unattributed_pct: 100 x (1 - the drain tick's calling-thread
stages over the window): the share of the window that ``t_select``,
``t_read_wait``, ``t_dispatch``, ``t_consume`` and ``t_barrier`` leave
unaccounted for."""
from perfbench import stage_metrics as sm


def read(rec):
    return sm.unattributed_pct(rec, sm.DRAIN_STAGES)
