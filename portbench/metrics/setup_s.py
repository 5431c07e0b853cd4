"""setup_s: seconds from the start of the process to the start of the window:
starting torch and the card, the kernel build (cached in the checkout after
the first run), the data, the program's state and the warm-up. Host clock."""


def read(record):
    return record["setup_seconds"]
