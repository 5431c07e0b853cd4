"""search.steps: beam steps per search call: the launches of every
`search_expand` variant (the program's `kernels._build.LAUNCHES`, read
around each call) over the calls of the window."""


def read(record):
    batches = record["counts"].get("batches")
    steps = record["counters"].get("search_expand")
    if not batches or not steps:
        return None
    return steps / batches
