"""recall_at_10: the share of the exact 10 nearest neighbours (the plain
reference's) that the cell's search returned, as the check measured it after
the window."""


def read(record):
    return record["numbers"].get("recall_at_10")
