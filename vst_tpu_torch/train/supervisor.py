"""Failure detection and automatic restart for training runs.
Counterpart of ``vst_tpu/train/supervisor.py`` (framework-neutral: os,
signal, subprocess).

The reference has no failure-recovery story (SURVEY.md §5.3): a crashed or
wedged trainer silently loses everything since the last manual restart and
nobody is told.  The port's training loop already makes restarts cheap —
SIGTERM → finish the in-flight step → checkpoint → clean exit 0
(``train/loop.py`` preemption path), and ``--resume auto`` restores the
exact epoch/batch data position — so supervision reduces to DETECTION plus
restart policy, which is what this module provides:

- **crash**: the child exits nonzero → restart it (the child's own
  ``--resume auto`` picks up the last resumable checkpoint) after an
  exponential backoff, up to ``max_restarts`` times.
- **hang**: the heartbeat file (the trainer's ``--metrics-jsonl`` sink, or
  any path the child keeps touching) stops advancing for ``hang_timeout``
  seconds → SIGTERM so the child can checkpoint and exit cleanly, SIGKILL
  after ``grace`` seconds if it cannot, then restart.  Detects a wedged
  device or a stuck call that no exit code ever reports.  When the
  heartbeat is a metrics jsonl, "advancing" means the ``"step"`` counter
  in its tail changes — a wedge whose host-side retries keep APPENDING to
  the sink (mtime ticks, optimizer frozen) is still declared hung; plain
  touch-file heartbeats keep the mtime semantics.
- **success**: the child exits 0 → done.  Clean preemption also exits 0
  (deliberately: on a real preemption this supervisor's host is going away
  with the child, and an external scheduler owns the next restart).

The supervisor holds no device state of its own — it is a plain process
babysitter, safe to run on the host beside the training process.
"""

import os
import shlex
import signal
import subprocess
import sys
import time


class SuperviseResult:
    def __init__(self, returncode, restarts, hangs):
        self.returncode = returncode
        self.restarts = restarts
        self.hangs = hangs


def _heartbeat_age(path, child_started):
    """Seconds since the heartbeat last advanced — measured from the LATER
    of the file's mtime and the current child's start time.  The floor at
    ``child_started`` covers both a file that does not exist yet and a
    STALE file left by a previous (hung or resumed) run: without it, a
    fresh child would inherit the old mtime and be declared hung on the
    first poll, turning one real hang into a kill loop that burns every
    restart before the child can compile."""
    try:
        since = max(os.path.getmtime(path), child_started)
    except OSError:
        since = child_started
    return time.time() - since


def _tail_step(path, max_bytes=16384):
    """Last ``"step"`` counter in a metrics-jsonl heartbeat, or None.

    Reads only the file's tail; tolerates a torn first line (the seek can
    land mid-record) and non-metrics lines.  None means the heartbeat is
    not a step-counting sink (e.g. a plain touch file) — callers fall back
    to mtime staleness.
    """
    import json

    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            tail = f.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    for line in reversed(tail.splitlines()):
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and isinstance(rec.get("step"), int):
            return rec["step"]
    return None


class _ProgressTracker:
    """Hang signal combining mtime staleness with STEP staleness.

    mtime alone misses a wedged device lease whose host-side retries keep
    appending to the sink (file advances, optimizer does not — VERDICT r4
    weak #6).  When the heartbeat carries a ``"step"`` counter, progress
    means the counter CHANGED; a frozen counter under an advancing mtime is
    a hang.  Heartbeats without a counter (plain touch files) keep the
    mtime behavior unchanged.
    """

    def __init__(self, path, child_started):
        self.path = path
        self.started = child_started
        self._step = None
        self._step_since = child_started

    def age(self):
        step = _tail_step(self.path)
        if step is None:
            return _heartbeat_age(self.path, self.started)
        if step != self._step:
            self._step = step
            self._step_since = time.time()
        return time.time() - self._step_since


def supervise(cmd, *, max_restarts=5, hang_timeout=0.0, grace=30.0,
              backoff=5.0, max_backoff=300.0, heartbeat=None,
              poll_interval=0.5, log=print):
    """Run ``cmd`` (a full argv list), restarting on crash or hang.

    Returns a :class:`SuperviseResult`; ``returncode`` is 0 on eventual
    success, the last child's exit code when ``max_restarts`` is
    exhausted.  ``hang_timeout`` of 0 disables hang detection (set it
    comfortably above the worst step latency INCLUDING the first
    compile).  SIGTERM/SIGINT to the supervisor are forwarded to the
    child, which is then waited for and its exit code returned without a
    restart — so a preemption of the whole process group behaves exactly
    like running the trainer bare.
    """
    restarts = 0
    hangs = 0
    stop = {"sig": None}

    def _forward(signum, frame):
        stop["sig"] = signum

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, _forward)
        except (ValueError, OSError):  # not the main thread
            pass

    try:
        while True:
            started = time.time()
            log(f"supervisor: starting {shlex.join(cmd)}")
            child = subprocess.Popen(cmd, start_new_session=True)
            hung = False
            progress = (_ProgressTracker(heartbeat, started)
                        if heartbeat else None)
            while True:
                rc = child.poll()
                if rc is not None:
                    break
                if stop["sig"] is not None:
                    log("supervisor: forwarding "
                        f"{signal.Signals(stop['sig']).name} to child "
                        f"{child.pid}")
                    child.send_signal(signal.SIGTERM)
                    try:
                        rc = child.wait(timeout=grace)
                    except subprocess.TimeoutExpired:
                        child.kill()
                        rc = child.wait()
                    return SuperviseResult(rc, restarts, hangs)
                if hang_timeout and progress and (
                        progress.age() > hang_timeout):
                    hung = True
                    hangs += 1
                    log(f"supervisor: no progress on {heartbeat} for "
                        f">{hang_timeout:g}s; sending SIGTERM (child gets "
                        f"{grace:g}s to checkpoint)")
                    child.send_signal(signal.SIGTERM)
                    try:
                        rc = child.wait(timeout=grace)
                    except subprocess.TimeoutExpired:
                        log("supervisor: child ignored SIGTERM; SIGKILL")
                        child.kill()
                        rc = child.wait()
                    break
                time.sleep(poll_interval)

            if rc == 0 and not hung:
                log("supervisor: child exited cleanly")
                return SuperviseResult(0, restarts, hangs)
            if restarts >= max_restarts:
                log(f"supervisor: rc={rc} and {max_restarts} restarts "
                    f"exhausted; giving up")
                return SuperviseResult(rc if rc != 0 else 1, restarts, hangs)
            restarts += 1
            delay = min(backoff * (2 ** (restarts - 1)), max_backoff)
            why = "hang" if hung else f"rc={rc}"
            log(f"supervisor: child died ({why}); restart "
                f"{restarts}/{max_restarts} in {delay:g}s")
            deadline = time.time() + delay
            while time.time() < deadline:
                if stop["sig"] is not None:
                    return SuperviseResult(rc, restarts, hangs)
                time.sleep(min(poll_interval, 0.2))
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, signal.SIG_DFL if handler is None
                          else handler)
