"""build_s: seconds per whole build, from the start of the window to the end
of its last build (each ended by a wait for the device), over the builds.
Host clock."""


def read(record):
    builds = record["counts"].get("builds")
    if not builds:
        return None
    start, end = record["window"]
    return (end - start) / builds
