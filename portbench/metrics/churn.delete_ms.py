"""churn.delete_ms: milliseconds per `DynamicIndex.delete` call in the window,
the compaction it triggers included:
the benchmark's own span around each call, ended by a wait for the device,
averaged over the calls (a total over a fixed window would not move when
the call got faster). Host clock."""

from portbench import trace as T


def read(record):
    return T.span_mean_ms(record["spans"], "delete")
