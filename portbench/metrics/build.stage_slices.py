"""build.stage_slices: slices of destinations staged per build: the program's
`pools/slices` tally (`repro_torch.trace.counts()`), read around each build
of the window, over the builds. Nothing is read where the program has no
such tally."""


def read(record):
    builds = record["counts"].get("builds")
    slices = record["counters"].get("pools/slices")
    if not builds or slices is None:
        return None
    return slices / builds
