"""The share of the training window in which the device ran the train
step's graph, in %: the CUDA event pairs the program records around each
replay (`graph.device_ms`), summed over the window's calls of the train
step, over `window_s`. The profiler-free counterpart of
`device_idle_share.train`; the batch's copies to the device and the graph's
input copies lie outside the pairs.

The window's calls are the process's last `steps` `graph.call` spans of "the
train step": the cell's window is the last loop over the step. None where
the program records no such spans or times, or where its ring dropped spans
of the window."""


def read(record):
    try:
        from humanrf_torch.utils.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    snap = snapshot()
    calls = [s for s in snap["spans"].get("graph.call", []) if s.id[0] == "the train step"][-record["steps"]:]
    if len(calls) < record["steps"] or (snap["dropped"] and snap["since_ns"] >= calls[0].start_ns):
        return None
    times = snap["device_ms"].get("graph.device_ms", {})
    if any(c.id not in times for c in calls):
        return None
    return 100.0 * sum(times[c.id] for c in calls) / 1e3 / record["window_s"]
