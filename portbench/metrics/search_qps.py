"""search_qps: every query answered in the window over the window's seconds
(each batch one search call, ended by a wait for the device). Host clock."""


def read(record):
    queries = record["counts"].get("queries")
    if not queries:
        return None
    start, end = record["window"]
    return queries / (end - start)
