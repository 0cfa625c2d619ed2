"""The share of the training window that the loop's fetches spent waiting
for the loader's locks, by the program's own spans, in %: the `loader.lock_wait`
spans (`data_lock`, held by the replacer thread while it commits an image,
and `grid_lock` before the grid uploads) directly inside the window's
`loader.fetch` spans, over `window_s`.

The window's fetches are the process's last `steps` `loader.fetch` spans:
the cell's window is the last loop over the loader. None where the program
records no such spans, or where its ring dropped spans of the window."""


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
    waited = sum(s.end_ns - s.start_ns for s in snap["spans"].get("loader.lock_wait", []) if s.parent in inside)
    return 100.0 * waited / 1e9 / record["window_s"]
