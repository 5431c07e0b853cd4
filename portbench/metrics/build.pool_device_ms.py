"""build.pool_device_ms: device milliseconds per build in every operation but
B1 (`rng_round`): the random init, the staging sorts and gathers, the
merges, the reverse-edge rounds. From the profiler's trace of the window."""

from portbench import trace as T


def read(record):
    builds = record["counts"].get("builds")
    us, n = T.device_us(record["trace"], lambda name: "rng_round_kernel" not in name)
    if not builds or not n:
        return None
    return us / 1e3 / builds
