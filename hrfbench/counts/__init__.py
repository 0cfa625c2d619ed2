"""The benchmark's work counts: the operations and bytes that a call or a
step needs for its inputs, from what the reference logged while it computed
the same inputs (`reference/humanrf.py::set_work_log`), and the chip's
published peaks they are divided by. One count per file."""
