"""The share of the training window the loop's host spent in `next(loader)`
(the loader's batch assembly under its lock), by the host clock, in %."""


def read(record):
    return 100.0 * record["fetch_share"] if "fetch_share" in record else None
