"""device.idle_pct.search: the share of the traced window in which no
operation ran on the card, in %: the window less the union of the device
operations' intervals."""

from portbench import trace as T


def read(record):
    return T.idle_pct(record["trace"])
