"""The share of the train step's device time that its optimizer takes, in
%: the program's `train.optimizer_ms` (AdamW's part of the step's graph,
timed on the device per replay) summed over the window's calls of the train
step, over their `graph.device_ms` (the whole replay) summed.

The window's calls are the process's last `steps` `graph.call` spans of "the
train step": the cell's window is the last loop over the step. None where
the program records no such spans or times, or where its ring dropped spans
of the window."""


def window_times(record, name: str):
    """→ ([`name`'s ms], [`graph.device_ms`]) of the window's train-step calls, or None."""
    try:
        from humanrf_torch.utils.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    snap = snapshot()
    calls = [s for s in snap["spans"].get("graph.call", []) if s.id[0] == "the train step"][-record["steps"]:]
    if len(calls) < record["steps"] or (snap["dropped"] and snap["since_ns"] >= calls[0].start_ns):
        return None
    part, whole = snap["device_ms"].get(name, {}), snap["device_ms"].get("graph.device_ms", {})
    if any(c.id not in part or c.id not in whole for c in calls):
        return None
    return [part[c.id] for c in calls], [whole[c.id] for c in calls]


def read(record):
    times = window_times(record, "train.optimizer_ms")
    return None if times is None else 100.0 * sum(times[0]) / sum(times[1])
