"""The share of the profiled window in which no operation ran on the device,
in %: 1 − busy / window, the busy seconds the union of the trace's device
activities and the window the host's time over the profiled work."""


def read(record):
    p = record.get("profile")
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"]) if p else None
