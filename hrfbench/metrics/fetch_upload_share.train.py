"""The share of the training window that the loop's fetches spent putting
data on its way to the device, by the program's own spans, in %: the
`loader.grid_upload` (a frame's grid read, staged, dilated into the device
ring), `loader.pool_snapshot` (the pool's metadata staged again after a
replacement) and `loader.stage` (the batch staged in pinned memory) spans
directly inside the window's `loader.fetch` spans, over `window_s`.

The window's fetches are the process's last `steps` `loader.fetch` spans:
the cell's window is the last loop over the loader. None where the program
records no such spans, or where its ring dropped spans of the window."""

PARTS = ("loader.grid_upload", "loader.pool_snapshot", "loader.stage")


def read(record):
    try:
        from humanrf_torch.utils.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    snap = snapshot()
    fetches = snap["spans"].get("loader.fetch", [])[-record["steps"]:]
    if len(fetches) < record["steps"] or (snap["dropped"] and snap["since_ns"] >= fetches[0].start_ns):
        return None
    inside = {f.seq for f in fetches}
    spent = sum(s.end_ns - s.start_ns for name in PARTS for s in snap["spans"].get(name, []) if s.parent in inside)
    return 100.0 * spent / 1e9 / record["window_s"]
