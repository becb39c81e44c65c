"""Supervised training: crash/hang detection + automatic restart.
Counterpart of ``vst_tpu/cli/supervise.py``.

    python -m vst_tpu_torch.cli.supervise [supervisor flags] -- <train args...>

Everything after ``--`` is passed to ``python -m vst_tpu_torch.cli.train``
in a child process.  The supervisor appends ``--resume auto`` (unless a
``--resume`` is already given) so every restart continues from the last
resumable checkpoint at the exact epoch/batch it stopped, and restarts the
child on nonzero exit or on a stalled heartbeat (see
``vst_tpu_torch.train.supervisor``).  Example:

    python -m vst_tpu_torch.cli.supervise --max-restarts 5 \\
        --hang-timeout 1800 -- --trainer adaattn-image \\
           --data coco/train2014,wikiart --out-dir models \\
           --save-every-steps 200 --metrics-jsonl models/metrics.jsonl

The heartbeat defaults to the child's ``--heartbeat-file`` (touched at
every batch on every process) or, failing that, its ``--metrics-jsonl``
file; pair ``--hang-timeout`` with a cadence small enough that the file
advances every few steps, and leave headroom for the first compile.
When the heartbeat is a metrics jsonl, liveness is the ``"step"`` counter
in its tail, not the file mtime — a wedged device lease whose host-side
retries keep appending log lines is still detected as a hang.

Multi-process children (``--multihost``, ROADMAP item 20, not ported
yet) need one supervisor per host, each watching a per-host
``--heartbeat-file``; the rules for it are kept.

This is the aux subsystem the reference lacks outright (SURVEY.md §5.3:
"failure detection / elastic recovery — absent").
"""

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="vst_tpu_torch.cli.supervise",
        description="Run vst_tpu_torch.cli.train under crash/hang "
                    "supervision.")
    p.add_argument("--max-restarts", type=int, default=5)
    p.add_argument("--hang-timeout", type=float, default=0.0, metavar="S",
                   help="restart when the heartbeat file is older than S "
                        "seconds (0 = no hang detection). Must exceed the "
                        "slowest logging gap INCLUDING first compile")
    p.add_argument("--grace", type=float, default=30.0, metavar="S",
                   help="seconds between SIGTERM (child checkpoints and "
                        "exits) and SIGKILL when handling a hang")
    p.add_argument("--backoff", type=float, default=5.0, metavar="S",
                   help="restart delay; doubles per restart (cap 300s)")
    p.add_argument("--heartbeat", metavar="PATH",
                   help="file whose mtime is the liveness signal (default: "
                        "the child's --heartbeat-file, else its "
                        "--metrics-jsonl — the latter only outside "
                        "--multihost, since it advances solely on the "
                        "primary host)")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="-- followed by vst_tpu_torch.cli.train arguments")
    return p


def _find_option(argv, name):
    """Return (present, value) for ``name`` handling both ``--opt value``
    and ``--opt=value`` forms (value None when absent, trailing, or
    followed by another flag)."""
    for i, tok in enumerate(argv):
        if tok == name:
            nxt = argv[i + 1] if i + 1 < len(argv) else None
            if nxt is not None and nxt.startswith("--"):
                nxt = None
            return True, nxt
        if tok.startswith(name + "="):
            return True, tok[len(name) + 1:]
    return False, None


def main(argv=None):
    args = build_parser().parse_args(argv)
    train_args = list(args.train_args)
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    if not train_args:
        raise SystemExit("error: no train arguments given (use `-- "
                         "--trainer ... --data ...`)")

    multihost, _ = _find_option(train_args, "--multihost")
    heartbeat = args.heartbeat
    if heartbeat is None:
        # derive BEFORE appending --resume, so an appended flag can never
        # masquerade as the heartbeat path.  --heartbeat-file advances on
        # every process at every batch, so it works under --multihost too;
        # the metrics sink advances only on the primary host.
        _, heartbeat = _find_option(train_args, "--heartbeat-file")
    if heartbeat is None and not multihost:
        _, heartbeat = _find_option(train_args, "--metrics-jsonl")

    has_resume, _ = _find_option(train_args, "--resume")
    if not has_resume:
        train_args += ["--resume", "auto"]
    if args.hang_timeout and not heartbeat:
        if multihost:
            # non-primary hosts never write --metrics-jsonl, so deriving
            # the heartbeat from it would kill healthy trainers there
            raise SystemExit(
                "error: --hang-timeout with a --multihost child needs a "
                "per-host liveness file: give the trainer a per-host "
                "--heartbeat-file (touched every batch on every process) "
                "or pass --heartbeat explicitly")
        raise SystemExit(
            "error: --hang-timeout needs a heartbeat; give the trainer "
            "--heartbeat-file, or --metrics-jsonl (with a small "
            "--log-every), or pass --heartbeat explicitly")
    if multihost:
        print("supervisor: NOTE --multihost child — supervision is "
              "per-host; a restart only rejoins the collective job if "
              "every host's trainer died and every host's supervisor "
              "restarts it (partial restarts block in "
              "the process group's rendezvous)", flush=True)

    from vst_tpu_torch.train.supervisor import supervise

    cmd = [sys.executable, "-m", "vst_tpu_torch.cli.train"] + train_args
    res = supervise(
        cmd, max_restarts=args.max_restarts,
        hang_timeout=args.hang_timeout, grace=args.grace,
        backoff=args.backoff, heartbeat=heartbeat)
    if res.restarts or res.hangs:
        print(f"supervisor: done rc={res.returncode} "
              f"(restarts={res.restarts}, hangs={res.hangs})")
    raise SystemExit(res.returncode)


if __name__ == "__main__":
    main()
