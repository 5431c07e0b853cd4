"""insert_rate: every vector inserted in the window over the whole window,
whose time also holds the deletes and the compactions they trigger. Host
clock."""


def read(record):
    vectors = record["counts"].get("vectors_inserted")
    if not vectors:
        return None
    start, end = record["window"]
    return vectors / (end - start)
