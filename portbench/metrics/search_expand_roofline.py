"""search_expand_roofline: the share of its roofline that B3 (`search_expand`, fp32)
reached in the window, in %: the least time of the window's launches by the
frozen count (`rooflines/counts.py`) over their device time in the
profiler's trace. Nothing is read when the launches traced and counted
differ."""

from portbench import trace as T


def read(record):
    return T.roofline_pct(record, "search_expand")
