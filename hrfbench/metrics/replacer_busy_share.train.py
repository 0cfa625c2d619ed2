"""The share of the training window in which the loader's replacer thread
was loading an image, by the program's own spans, in %: the `loader.load`
spans (decode, mask and pack, the wait for `data_lock`, the commit), clipped
to the window's interval, over `window_s`. While busy, the replacer
competes with the loop's one host thread for the interpreter.

The window's interval runs from the start of the first of the process's
last `steps` `loader.fetch` spans to the end of the last of its last `steps`
calls of the train step (`graph.call`): the cell's window is the last loop
over the loader and the step. None where the program records no such spans,
or where its ring dropped spans of the window."""


def read(record):
    try:
        from humanrf_torch.utils.profiling import snapshot
    except ImportError:  # a program without the recorder
        return None
    snap = snapshot()
    steps = record["steps"]
    fetches = snap["spans"].get("loader.fetch", [])[-steps:]
    calls = [s for s in snap["spans"].get("graph.call", []) if s.id[0] == "the train step"][-steps:]
    if len(fetches) < steps or len(calls) < steps or (snap["dropped"] and snap["since_ns"] >= fetches[0].start_ns):
        return None
    t0, t1 = fetches[0].start_ns, calls[-1].end_ns
    busy = sum(max(0, min(s.end_ns, t1) - max(s.start_ns, t0)) for s in snap["spans"].get("loader.load", []))
    return 100.0 * busy / 1e9 / record["window_s"]
