"""The whole training step's share of the chip's peak, in %: the step's
least time at the H100's published peaks (`hrfbench/counts/train_step.py`,
counted on a check step's valid samples and rays) over the window's time
per step."""


def read(record):
    if "step_work" not in record or "step_s" not in record:
        return None
    return 100.0 * record["step_work"]["least_s"] / record["step_s"]
