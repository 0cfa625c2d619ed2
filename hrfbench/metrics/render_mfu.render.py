"""The whole view's share of the chip's peak, in %: a view's least time at
the H100's published peaks (`hrfbench/counts/render_batch.py`, counted on
the profiled view's batches) over the window's time per view."""


def read(record):
    if "view_work" not in record or "view_s" not in record:
        return None
    return 100.0 * record["view_work"]["least_s"] / record["view_s"]
