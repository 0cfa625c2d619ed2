"""Stall watchdog for long CLI runs. Counterpart of `scripts/run_supervisor.py`.

A long run can wedge: a child that stops making progress without exiting.
`supervise()` watches the child's log for growth, kills a wedged child,
waits until a fresh process sees the card again (`card_alive`), and
relaunches it. Pair it with `--training.checkpoint latest` so that the
relaunch resumes instead of restarting.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

# Returned by supervise() when the wall-clock budget (deadline) expires: the
# run is partial but resumable, not failed. 124 matches coreutils timeout(1).
BUDGET_RC = 124

_PROBE = (
    "import torch\n"
    "assert torch.cuda.is_available(), 'no CUDA device'\n"
    "x = torch.ones((128, 128), device='cuda')\n"
    "print(float((x @ x).sum()))\n"
)


def card_alive(timeout: float = 240.0) -> bool:
    """Whether a fresh process sees the card and runs a tiny kernel on it."""
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE], timeout=timeout,
                           stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    except subprocess.TimeoutExpired:
        return False
    if r.returncode != 0:
        # A hung card usually times out above; a nonzero exit is more often
        # a broken install: show it instead of spinning on it silently.
        tail = (r.stderr or b"").decode(errors="replace").strip().splitlines()
        print(f"# WATCHDOG: probe exited rc={r.returncode}: {tail[-1] if tail else '(no stderr)'}", flush=True)
    return r.returncode == 0


def _kill_tree(proc: subprocess.Popen) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=20)


def supervise(
    cmd,
    log: Path,
    env,
    cwd,
    stall_timeout: float = 1500.0,
    max_restarts: int = 12,
    probe_first: bool = True,
    probe=card_alive,
    probe_retry_s: float = 180.0,
    poll_s: float = 30.0,
    deadline: float | None = None,
):
    """Run `cmd` to completion, restarting it when it wedges.

    Progress signal: the child's log grows (the trainer logs every 500
    steps and every validation), so `stall_timeout` must exceed the longest
    quiet stretch of the slowest run. On a stall: kill, wait until
    `probe()` answers, relaunch; with `--training.checkpoint latest` the run
    resumes from its newest checkpoint.

    `deadline` (absolute epoch seconds): the wall-clock budget. When it
    passes, the child is killed and (BUDGET_RC, restarts) is returned: the
    run is partial, not failed, and stays resumable when it checkpoints at
    every validation. Returns (rc, restarts)."""
    restarts = 0
    while probe_first and not probe():
        if deadline is not None and time.time() > deadline:
            print("# WATCHDOG: deadline passed while waiting for the card", flush=True)
            return BUDGET_RC, restarts
        print(f"# WATCHDOG: card unavailable before first launch; retrying in {probe_retry_s:.0f}s", flush=True)
        time.sleep(probe_retry_s)
    # The log-growth signal needs an unbuffered child: redirected to a file,
    # print() flushes every ~8 KB, hours apart at a line per 500 steps, and a
    # healthy child would look wedged.
    env = dict(env)
    env["PYTHONUNBUFFERED"] = "1"
    while True:
        with open(log, "a") as lf:
            proc = subprocess.Popen(cmd, stdout=lf, stderr=subprocess.STDOUT, text=True, cwd=cwd, env=env)
            last_size, last_growth = -1, time.time()
            while True:
                try:
                    rc = proc.wait(timeout=poll_s)
                    break
                except subprocess.TimeoutExpired:
                    pass
                if deadline is not None and time.time() > deadline:
                    print("# WATCHDOG: wall-clock budget exhausted — stopping child (partial, resumable)", flush=True)
                    _kill_tree(proc)
                    return BUDGET_RC, restarts
                size = log.stat().st_size
                if size != last_size:
                    last_size, last_growth = size, time.time()
                elif time.time() - last_growth > stall_timeout:
                    print(f"# WATCHDOG: no log growth for {stall_timeout:.0f}s — killing wedged child", flush=True)
                    _kill_tree(proc)
                    rc = None  # stalled, not a real exit
                    break
        if rc == 0:
            return 0, restarts
        restarts += 1
        if restarts > max_restarts:
            print(f"# WATCHDOG: giving up after {max_restarts} restarts", flush=True)
            return rc if rc is not None else -1, restarts
        reason = "stall" if rc is None else f"rc={rc}"
        print(f"# WATCHDOG: restart {restarts}/{max_restarts} ({reason}); probing the card ...", flush=True)
        while not probe():
            if deadline is not None and time.time() > deadline:
                print("# WATCHDOG: deadline passed while waiting for the card", flush=True)
                # A real crash (rc not in {0, None}) stays visible: BUDGET_RC
                # would mislabel it "partial, resumable".
                return (rc if rc not in (0, None) else BUDGET_RC), restarts
            print(f"# WATCHDOG: card still unavailable; retrying in {probe_retry_s:.0f}s", flush=True)
            time.sleep(probe_retry_s)
        print("# WATCHDOG: card healthy — relaunching (resumes from latest checkpoint)", flush=True)
