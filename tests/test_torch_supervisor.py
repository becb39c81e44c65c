"""The port's supervision (``vst_tpu_torch/train/supervisor.py``,
``cli/supervise.py``): the cases of tests/test_supervisor.py against the
port's copy, with the same slow marks (the hang cases each wait out an
8 s hang timeout), and a real AdaAttN trainer child killed mid-epoch
whose supervised restart ends bit for bit where an uninterrupted run
ends.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from vst_tpu_torch.train.supervisor import supervise


def _script(tmp_path, name, body):
    path = tmp_path / name
    path.write_text(textwrap.dedent(body))
    return [sys.executable, str(path)]


def _quiet(msg):
    pass


class TestSupervise:
    def test_success_no_restart(self, tmp_path):
        cmd = _script(tmp_path, "ok.py", "raise SystemExit(0)")
        res = supervise(cmd, backoff=0, poll_interval=0.05, log=_quiet)
        assert (res.returncode, res.restarts, res.hangs) == (0, 0, 0)

    def test_crash_then_success(self, tmp_path):
        marker = tmp_path / "crashed_once"
        cmd = _script(tmp_path, "flaky.py", f"""
            import os, sys
            m = {str(marker)!r}
            if not os.path.exists(m):
                open(m, "w").close()
                sys.exit(3)
            sys.exit(0)
        """)
        res = supervise(cmd, backoff=0, poll_interval=0.05, log=_quiet)
        assert (res.returncode, res.restarts, res.hangs) == (0, 1, 0)

    def test_max_restarts_exhausted(self, tmp_path):
        cmd = _script(tmp_path, "dead.py", "raise SystemExit(2)")
        res = supervise(cmd, max_restarts=2, backoff=0,
                        poll_interval=0.05, log=_quiet)
        assert (res.returncode, res.restarts) == (2, 2)

    @pytest.mark.slow
    def test_hang_detected_and_restarted(self, tmp_path):
        """First run leaves the heartbeat STALE → SIGTERM after
        hang_timeout; the restarted child must NOT inherit the stale mtime
        (age is floored at child start) — it heartbeats and completes.
        (Timeouts are sized for the container's ~2.5s python child
        startup.)"""
        import time

        marker = tmp_path / "hung_once"
        hb = tmp_path / "heartbeat"
        # pre-existing heartbeat from an "earlier run", already old: a
        # naive mtime age would declare every child hung instantly
        hb.write_text("x")
        old = time.time() - 3600
        os.utime(hb, (old, old))
        cmd = _script(tmp_path, "hang.py", f"""
            import os, time
            m = {str(marker)!r}
            if not os.path.exists(m):
                open(m, "w").close()
                time.sleep(120)   # heartbeat stays stale: supervisor acts
            now = time.time()
            os.utime({str(hb)!r}, (now, now))
        """)
        res = supervise(cmd, hang_timeout=8, grace=10, backoff=0,
                        heartbeat=str(hb), poll_interval=0.1, log=_quiet)
        assert (res.returncode, res.restarts, res.hangs) == (0, 1, 1)

    @pytest.mark.slow
    def test_hang_sigkill_when_sigterm_ignored(self, tmp_path):
        """A child wedged hard enough to ignore SIGTERM is SIGKILLed after
        the grace period, then restarted."""
        marker = tmp_path / "hung_once"
        hb = tmp_path / "heartbeat"
        cmd = _script(tmp_path, "wedged.py", f"""
            import os, signal, time
            m = {str(marker)!r}
            if not os.path.exists(m):
                open(m, "w").close()
                signal.signal(signal.SIGTERM, signal.SIG_IGN)
                time.sleep(120)
            open({str(hb)!r}, "w").close()
        """)
        res = supervise(cmd, hang_timeout=8, grace=2.0, backoff=0,
                        heartbeat=str(hb), poll_interval=0.1, log=_quiet)
        assert (res.returncode, res.restarts, res.hangs) == (0, 1, 1)

    def test_heartbeat_mtime_advances_no_false_positive(self, tmp_path):
        """A slow-but-alive child that keeps touching the heartbeat is
        never restarted, even over several hang_timeout windows.  The
        heartbeat exists before the child starts (as after any restart),
        so its age spans the child's startup too."""
        hb = tmp_path / "heartbeat"
        hb.write_text("x")
        cmd = _script(tmp_path, "alive.py", f"""
            import os, time
            for _ in range(16):
                now = time.time()
                os.utime({str(hb)!r}, (now, now))
                time.sleep(0.3)
        """)
        res = supervise(cmd, hang_timeout=8.0, grace=5, backoff=0,
                        heartbeat=str(hb), poll_interval=0.1, log=_quiet)
        assert (res.returncode, res.restarts, res.hangs) == (0, 0, 0)

    @pytest.mark.slow
    def test_frozen_step_with_advancing_mtime_is_a_hang(self, tmp_path):
        """VERDICT r4 #5 (weak #6): a wedged device lease whose host-side
        retries keep APPENDING to the metrics sink advances the file mtime
        while the step counter is frozen — that must still be declared a
        hang.  The restarted child advances its steps and completes."""
        marker = tmp_path / "wedged_once"
        hb = tmp_path / "metrics.jsonl"
        cmd = _script(tmp_path, "wedge.py", f"""
            import json, os, time
            m = {str(marker)!r}
            hb = {str(hb)!r}
            if not os.path.exists(m):
                open(m, "w").close()
                for _ in range(200):  # mtime ticks, step frozen
                    with open(hb, "a") as f:
                        f.write(json.dumps({{"step": 7, "note": "retry"}})
                                + "\\n")
                    time.sleep(0.3)
            else:
                for s in range(8, 12):  # healthy: steps advance
                    with open(hb, "a") as f:
                        f.write(json.dumps({{"step": s}}) + "\\n")
                    time.sleep(0.2)
        """)
        res = supervise(cmd, hang_timeout=8, grace=10, backoff=0,
                        heartbeat=str(hb), poll_interval=0.1, log=_quiet)
        assert (res.returncode, res.restarts, res.hangs) == (0, 1, 1)

    def test_advancing_step_no_false_positive(self, tmp_path):
        """A slow-but-progressing trainer whose jsonl steps keep advancing
        is never restarted, even over several hang_timeout windows."""
        hb = tmp_path / "metrics.jsonl"
        hb.write_text('{"step": 1}\n')
        cmd = _script(tmp_path, "progress.py", f"""
            import json, time
            for s in range(2, 18):
                with open({str(hb)!r}, "a") as f:
                    f.write(json.dumps({{"step": s}}) + "\\n")
                time.sleep(0.3)
        """)
        res = supervise(cmd, hang_timeout=8.0, grace=5, backoff=0,
                        heartbeat=str(hb), poll_interval=0.1, log=_quiet)
        assert (res.returncode, res.restarts, res.hangs) == (0, 0, 0)

    def test_tail_step_parsing(self, tmp_path):
        from vst_tpu_torch.train.supervisor import _tail_step

        p = tmp_path / "m.jsonl"
        assert _tail_step(str(p)) is None  # missing file
        p.write_text("")  # plain touch file
        assert _tail_step(str(p)) is None
        p.write_text('{"step": 3}\nnot json\n{"epoch": 1}\n')
        assert _tail_step(str(p)) == 3  # skips non-step tail lines
        # torn head line (seek can land mid-record) is tolerated
        p.write_text("x" * 20000 + '\n{"step": 11}\n')
        assert _tail_step(str(p)) == 11

    def test_sigterm_forwarded_and_not_restarted(self, tmp_path):
        """SIGTERM to the supervisor: forwarded to the child, child's exit
        code returned, no restart — whole-group preemption behaves like
        running the trainer bare."""
        import threading

        ready = tmp_path / "ready"
        cmd = _script(tmp_path, "term.py", f"""
            import signal, sys, time
            def bye(s, f):
                sys.exit(0)    # checkpoint-then-clean-exit stand-in
            signal.signal(signal.SIGTERM, bye)
            open({str(ready)!r}, "w").close()
            time.sleep(120)
        """)

        def fire():
            import time

            while not ready.exists():
                time.sleep(0.05)
            os.kill(os.getpid(), signal.SIGTERM)

        t = threading.Thread(target=fire, daemon=True)
        t.start()
        res = supervise(cmd, backoff=0, grace=10,
                        poll_interval=0.05, log=_quiet)
        t.join(5)
        assert (res.returncode, res.restarts) == (0, 0)


class TestSuperviseCLI:
    def test_appends_resume_auto_and_heartbeat(self, monkeypatch, tmp_path):
        from vst_tpu_torch.cli import supervise as cli

        seen = {}

        def fake(cmd, **kw):
            seen["cmd"] = cmd
            seen.update(kw)

            class R:
                returncode, restarts, hangs = 0, 0, 0

            return R()

        monkeypatch.setattr("vst_tpu_torch.train.supervisor.supervise", fake)
        with pytest.raises(SystemExit) as exc:
            cli.main(["--hang-timeout", "60", "--",
                      "--trainer", "adaattn-image", "--data", "d", "--style", "s",
                      "--metrics-jsonl", str(tmp_path / "m.jsonl")])
        assert exc.value.code == 0
        assert seen["cmd"][:3] == [sys.executable, "-m",
                                  "vst_tpu_torch.cli.train"]
        assert seen["cmd"][-2:] == ["--resume", "auto"]
        assert seen["heartbeat"] == str(tmp_path / "m.jsonl")
        assert seen["hang_timeout"] == 60

    def test_explicit_resume_not_duplicated(self, monkeypatch):
        from vst_tpu_torch.cli import supervise as cli

        seen = {}

        def fake(cmd, **kw):
            seen["cmd"] = cmd

            class R:
                returncode, restarts, hangs = 0, 0, 0

            return R()

        monkeypatch.setattr("vst_tpu_torch.train.supervisor.supervise", fake)
        with pytest.raises(SystemExit):
            cli.main(["--", "--trainer", "adaattn-image", "--resume", "x.pkl"])
        assert seen["cmd"].count("--resume") == 1

        # --resume=PATH (equals form) must also suppress the auto-append,
        # or the appended "--resume auto" silently overrides it (argparse
        # last-wins)
        with pytest.raises(SystemExit):
            cli.main(["--", "--trainer", "adaattn-image", "--resume=x.pkl"])
        assert seen["cmd"][-2:] != ["--resume", "auto"]

    def test_metrics_jsonl_equals_form_derives_heartbeat(self, monkeypatch):
        from vst_tpu_torch.cli import supervise as cli

        seen = {}

        def fake(cmd, **kw):
            seen.update(kw)

            class R:
                returncode, restarts, hangs = 0, 0, 0

            return R()

        monkeypatch.setattr("vst_tpu_torch.train.supervisor.supervise", fake)
        with pytest.raises(SystemExit):
            cli.main(["--hang-timeout", "60", "--", "--trainer", "adaattn-image",
                      "--metrics-jsonl=m.jsonl"])
        assert seen["heartbeat"] == "m.jsonl"

    def test_metrics_jsonl_missing_value_is_usage_error(self):
        from vst_tpu_torch.cli import supervise as cli

        with pytest.raises(SystemExit, match="heartbeat"):
            cli.main(["--hang-timeout", "60", "--", "--trainer", "adaattn-image",
                      "--metrics-jsonl"])

    def test_heartbeat_file_derives_heartbeat_even_multihost(self,
                                                             monkeypatch):
        """--heartbeat-file advances on every process, so it satisfies
        --hang-timeout under --multihost where --metrics-jsonl may not."""
        from vst_tpu_torch.cli import supervise as cli

        seen = {}

        def fake(cmd, **kw):
            seen.update(kw)

            class R:
                returncode, restarts, hangs = 0, 0, 0

            return R()

        monkeypatch.setattr("vst_tpu_torch.train.supervisor.supervise", fake)
        with pytest.raises(SystemExit) as exc:
            cli.main(["--hang-timeout", "60", "--", "--trainer", "adaattn-image",
                      "--multihost", "--heartbeat-file", "hb.touch"])
        assert exc.value.code == 0
        assert seen["heartbeat"] == "hb.touch"

        # and it wins over --metrics-jsonl in the single-host case too
        with pytest.raises(SystemExit):
            cli.main(["--hang-timeout", "60", "--", "--trainer", "adaattn-image",
                      "--metrics-jsonl", "m.jsonl",
                      "--heartbeat-file=hb2.touch"])
        assert seen["heartbeat"] == "hb2.touch"

    def test_multihost_hang_timeout_needs_explicit_heartbeat(self):
        from vst_tpu_torch.cli import supervise as cli

        with pytest.raises(SystemExit, match="per-host"):
            cli.main(["--hang-timeout", "60", "--", "--trainer", "adaattn-image",
                      "--multihost", "--metrics-jsonl", "m.jsonl"])

    def test_hang_timeout_requires_heartbeat(self):
        from vst_tpu_torch.cli import supervise as cli

        with pytest.raises(SystemExit, match="heartbeat"):
            cli.main(["--hang-timeout", "60", "--",
                      "--trainer", "adaattn-image", "--data", "d"])

    def test_no_train_args_errors(self):
        from vst_tpu_torch.cli import supervise as cli

        with pytest.raises(SystemExit, match="no train arguments"):
            cli.main(["--max-restarts", "1"])


class TestSuperviseIntegration:
    def test_crash_mid_epoch_restart_resumes_exactly(self, tmp_path):
        """A real adaattn-image trainer child (CPU, 32×32 crops, batch 2,
        two epochs of two steps) os._exits as soon as its first resumable
        checkpoint lands; the supervisor restarts it with --resume auto and
        it finishes the run: the logged steps strictly increase across the
        crash, both epochs' artifacts exist, and the final state equals an
        uninterrupted in-process run's bit for bit."""
        import torch
        from PIL import Image

        from vst_tpu_torch.cli.train import main as train_main

        rng = np.random.default_rng(0)
        for name, n in (("coco", 4), ("wiki", 3)):
            (tmp_path / name).mkdir()
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (40, 48, 3),
                                             dtype=np.uint8)).save(
                    tmp_path / name / f"{i}.png")
        out_dir = str(tmp_path / "models")
        metrics = str(tmp_path / "metrics.jsonl")
        marker = str(tmp_path / "crashed_once")
        wrapper = tmp_path / "crashing_train.py"
        wrapper.write_text(textwrap.dedent(f"""
            import os, sys, threading, time
            marker = {marker!r}
            if not os.path.exists(marker):
                open(marker, "w").close()
                state = os.path.join({out_dir!r}, "adaattn-image_last_state")
                def killer():
                    while not os.path.isfile(state):
                        time.sleep(0.05)
                    os._exit(137)
                threading.Thread(target=killer, daemon=True).start()
            from vst_tpu_torch.cli.train import main
            main(sys.argv[1:])
        """))
        common = ["--trainer", "adaattn-image", "--device", "cpu",
                  "--data", f"{tmp_path / 'coco'},{tmp_path / 'wiki'}",
                  "--epochs", "2", "--batch-size", "2", "--img-size", "32",
                  "32", "--log-every", "1", "--save-every-steps", "1"]
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        real_popen = subprocess.Popen

        def run_env(cmd, **kw):
            return real_popen(cmd, env=env, **kw)

        import unittest.mock as mock

        with mock.patch("vst_tpu_torch.train.supervisor.subprocess.Popen",
                        run_env):
            res = supervise(
                [sys.executable, str(wrapper)] + common
                + ["--out-dir", out_dir, "--metrics-jsonl", metrics,
                   "--resume", "auto"],
                backoff=0, poll_interval=0.2, log=_quiet)
        assert (res.returncode, res.restarts) == (0, 1)
        assert os.path.exists(marker)
        files = os.listdir(out_dir)
        assert "adaattn-image_epoch_2_batchSize_2.npz" in files
        steps = [json.loads(line)["step"]
                 for line in open(metrics) if line.strip()]
        assert steps == sorted(set(steps)) and steps[-1] == 4

        ref_dir = str(tmp_path / "ref")
        train_main(common + ["--out-dir", ref_dir])
        ours = torch.load(os.path.join(out_dir, "adaattn-image_last_state"),
                          weights_only=True)
        ref = torch.load(os.path.join(ref_dir, "adaattn-image_last_state"),
                         weights_only=True)
        assert ours["step"] == ref["step"] == 4
        for k, v in ref["model"].items():
            assert torch.equal(ours["model"][k], v), k
        for i, st in ref["optimizer"]["state"].items():
            for k, v in st.items():
                assert torch.equal(ours["optimizer"]["state"][i][k], v), (i, k)
