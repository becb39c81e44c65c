"""The port's multi-process layer (``parallel/multihost.py`` and its loop
and CLI wiring), the cases of tests/test_multihost.py: a non-primary
process steps but writes nothing and touches its heartbeat, the
single-process fallbacks, and two real processes joined through
``cli.train --multihost 127.0.0.1:<port> --num-processes 2 --process-id i
--device cpu`` (gloo) against the single-process run of the same data,
with a resume whose --out-dir differs aborting on every rank; and
multi-process serving, where rank 0 decodes, scatters each batch and
gathers: ``infer_video --data-parallel 2`` and
``AdaAttNVideoStylizer(mesh=)`` give the frames of one process."""

import json
import os
import socket
import time

import numpy as np
import pytest
import torch

from vst_tpu_torch.models import rtnstv
from vst_tpu_torch.train import loop as train_loop
from vst_tpu_torch.train.checkpoint import load_params
from vst_tpu_torch.train.config import RTNSTVConfig
from vst_tpu_torch.train.state import TrainState
from tests import torch_dist as td
from tests.test_torch_cli_train import _write


class _DS:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 2), float(i), np.float32)


def _toy_state():
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.zeros(2))
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))


def _plus_one(state, batch):
    with torch.no_grad():
        state.model.w += 1.0
    state.step += 1
    return state, {"loss": state.model.w.detach().sum()}


class TestNonPrimaryProcess:
    def test_trains_but_writes_nothing(self, tmp_path, monkeypatch):
        """A non-primary process runs every step (the step's all-reduce is
        collective) and writes no checkpoint, plot or metric line."""
        monkeypatch.setattr(train_loop, "_primary", lambda: False)
        metrics = str(tmp_path / "m.jsonl")
        final = train_loop.run_training(
            _plus_one, _toy_state(), _DS(8), batch_size=2, epochs=1,
            out_dir=str(tmp_path / "out"), export_pth=False, log_every=1,
            num_workers=0, save_every_steps=1, model_name="toy",
            metrics_jsonl=metrics, loss_plots_dir=str(tmp_path / "plots"))
        assert final.step == 4
        assert os.listdir(tmp_path / "out") == []
        assert not os.path.exists(metrics)
        assert not os.path.exists(tmp_path / "plots")

    def test_heartbeat_touched_every_batch(self, tmp_path, monkeypatch):
        """The heartbeat advances on a non-primary process too, and exists
        before the first step."""
        monkeypatch.setattr(train_loop, "_primary", lambda: False)
        hb = str(tmp_path / "hb" / "host1.touch")
        mtimes = []

        def step(state, batch):
            mtimes.append(os.path.getmtime(hb))
            time.sleep(0.01)
            return _plus_one(state, batch)

        train_loop.run_training(
            step, _toy_state(), _DS(4), batch_size=2, epochs=1,
            out_dir=str(tmp_path / "out"), export_pth=False, log_every=1,
            num_workers=0, model_name="toy", heartbeat_file=hb)
        assert len(mtimes) == 2
        assert os.path.getmtime(hb) > mtimes[0]
        assert os.listdir(tmp_path / "out") == []


class TestSingleProcessFallbacks:
    def test_no_group(self):
        from vst_tpu_torch.parallel import multihost

        assert multihost.is_primary()
        assert multihost.process_index() == 0
        assert multihost.process_count() == 1
        assert train_loop._primary()

    def test_world1_put_and_replicate(self, tmp_path):
        from vst_tpu_torch.parallel import multihost

        with td.world1(tmp_path) as mesh:
            x = np.arange(8, dtype=np.float32).reshape(4, 2)
            np.testing.assert_array_equal(
                multihost.put_global_batch(mesh, x).numpy(), x)
            tree = {"w": torch.ones(3)}
            out = multihost.replicate_global(mesh, tree)
            torch.testing.assert_close(out["w"], torch.ones(3))
            assert multihost.is_primary() and multihost.process_count() == 1

    @pytest.mark.parametrize("n,device,expect", [
        (3, "cpu", 3), (0, "cpu", 1), (-1, "cpu", 1),
        (-1, "cuda", "no CUDA device"), (0, "cuda", "no CUDA device")])
    def test_local_rank_count(self, monkeypatch, n, device, expect):
        """--data-parallel's rank count: N itself, one per card, one on
        the CPU; with no card, the port's no-card error."""
        from vst_tpu_torch.parallel import multihost

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        if isinstance(expect, str):
            with pytest.raises(RuntimeError, match=expect):
                multihost.local_rank_count(n, device)
        else:
            assert multihost.local_rank_count(n, device) == expect

    @pytest.mark.parametrize("cli,argv", [
        ("train", ["--trainer", "rtnstv", "--data", "d", "--style", "s",
                   "--data-parallel", "-1"]),
        ("infer_video", ["--model", "reconet", "--weights", "w",
                         "--video", "v", "--data-parallel"])])
    def test_data_parallel_without_a_card(self, monkeypatch, cli, argv):
        """--data-parallel over every card on a host with none stops with
        the no-card error before any rank starts."""
        import importlib

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        main = importlib.import_module(f"vst_tpu_torch.cli.{cli}").main
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["--device", "cuda"])

    def test_initialize_needs_its_arguments(self):
        from vst_tpu_torch.parallel import multihost

        with pytest.raises(ValueError, match="num_processes"):
            multihost.initialize("127.0.0.1:1", device="cpu")


# ------------------------------------------------- two processes, one group

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    """RTNSTV at 24×32, global batch 4, one epoch of 8 SceneFlow samples
    (2 steps): one process alone, and two processes of one gloo group
    started together; rank 1 gets its own --out-dir, metrics file and
    heartbeat, to show what it writes."""
    from tests import test_data

    root = tmp_path_factory.mktemp("multihost")
    rng = np.random.default_rng(0)
    for layout, sub in (("monkaa", "monkaa"), ("ft3d", "flyingthings3d")):
        test_data._make_sceneflow_scene(str(root / "sceneflow" / sub), rng,
                                        5, layout)
    _write(str(root / "style.png"), rng, (32, 24))
    common = ["-m", "vst_tpu_torch.cli.train", "--trainer", "rtnstv",
              "--device", "cpu", "--data", str(root / "sceneflow"),
              "--style", str(root / "style.png"), "--epochs", "1",
              "--batch-size", "4", "--img-size", "24", "32",
              "--log-every", "1"]
    port = _free_port()
    ranks = [common + ["--multihost", f"127.0.0.1:{port}",
                       "--num-processes", "2", "--process-id", str(i),
                       "--out-dir", str(root / f"multi{i}"),
                       "--metrics-jsonl", str(root / f"multi{i}.jsonl"),
                       "--heartbeat-file", str(root / f"hb{i}")]
             for i in range(2)]
    t0 = time.time()
    runs = td.run_commands([common + ["--out-dir", str(root / "single"),
                                      "--metrics-jsonl",
                                      str(root / "single.jsonl")]] + ranks)
    return root, common, runs, t0


def test_two_processes_match_single_process(two_process_run):
    """The two-process run's per-step global losses equal the single
    process's (same data order, same global batch, same objective: the
    temporal loss divides by the global mask sum), as tests/test_multihost.py
    holds JAX's, and its two updates are the single process's within
    1e-2·lr (1e-4 relative), at every parameter but the conv biases, whose
    true gradient is 0; the non-primary rank writes no checkpoint and no
    metric line, and its heartbeat advanced."""
    root, _, runs, t0 = two_process_run
    for rc, out in runs:
        assert rc == 0, out[-3000:]
    assert "multihost: process 0/2" in runs[1][1]
    assert "data-parallel over 2 devices (2 samples/device)" in runs[1][1]
    single = [json.loads(x) for x in open(root / "single.jsonl")]
    multi = [json.loads(x) for x in open(root / "multi0.jsonl")]
    assert [s["step"] for s in single] == [m["step"] for m in multi] == [1, 2]
    for s, m in zip(single, multi):
        for key in ("loss", "CL", "SL", "RL", "TL"):
            np.testing.assert_allclose(m[key], s[key], rtol=3e-5,
                                       err_msg=f"step {s['step']} {key}")
    name = "rtnstv_epoch_1_batchSize_4.npz"
    ps = load_params(str(root / "single" / name))
    pm = load_params(str(root / "multi0" / name))
    assert set(ps) == set(pm)
    lr = RTNSTVConfig().lr
    p0 = rtnstv.init_stylizing_network(0, "cpu").state_dict()
    held = 0
    for key in ps:
        if key.endswith("conv.bias"):
            continue   # every conv feeds an instance norm: true gradient 0
        # two Adam steps from the same seeded start: the updates agree to
        # float32 rounding, where a gradient of another sign or one not
        # averaged over the ranks moves a weight by ~lr
        ds = np.asarray(ps[key]) - p0[key].numpy()
        dm = np.asarray(pm[key]) - p0[key].numpy()
        np.testing.assert_allclose(dm, ds, rtol=0, atol=1e-2 * lr,
                                   err_msg=key)
        assert np.linalg.norm(dm - ds) <= 1e-4 * np.linalg.norm(ds), key
        held += 1
    assert held >= 3 * len(ps) // 4
    assert os.listdir(root / "multi1") == []
    assert not (root / "multi1.jsonl").exists()
    assert os.path.getmtime(root / "hb1") > t0


def test_resume_mismatch_aborts_every_rank(two_process_run):
    """--resume auto where rank 0's --out-dir holds the state and rank 1's
    does not: every rank aborts with the resume-mismatch message before
    any step."""
    root, common, _, _ = two_process_run
    port = _free_port()
    runs = td.run_commands([
        common + ["--multihost", f"127.0.0.1:{port}", "--num-processes",
                  "2", "--process-id", str(i), "--resume", "auto",
                  "--out-dir", str(root / ("multi0" if i == 0 else "fresh"))]
        for i in range(2)])
    for rc, out in runs:
        assert rc != 0
        assert "multihost resume mismatch" in out, out[-2000:]
        assert "epoch/batch/step [2, 0, 2]" in out or "[1, 0, 0]" in out


# ------------------------------------------------------------- serving

def test_adaattn_video_stylizer_mesh_matches_single(tmp_path):
    """AdaAttNVideoStylizer over a 2-rank mesh (rank 0 decodes, scatters
    and gathers) yields on rank 0 the frames of mesh=None, in count and
    order and within one uint8 step; rank 1 yields none.  5 frames at
    batch 2: the padded tail batch is split too."""
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
              for _ in range(5)]
    style = rng.integers(0, 256, (1, 32, 48, 3), dtype=np.uint8)
    (ref, out), (none, rest) = td.spawn(
        td.video_stylizer, 2, tmp_path, frames, style.astype(np.float32), 2,
        "softmax")
    assert none is None and rest == []
    assert len(out) == len(ref) == 5
    for a, b in zip(out, ref):
        assert a.dtype == np.uint8 and a.shape == (32, 48, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_infer_video_data_parallel_cli(tmp_path):
    """``infer_video --data-parallel 2 --device cpu`` (two spawned ranks)
    writes the frames of the single-process run, in count and order and
    within one uint8 step; a 3-frame window (input_frame_num 3) is built on
    rank 0 and scattered whole."""
    cv2 = pytest.importorskip("cv2")
    from PIL import Image
    from vst_tpu.models.reconet import init_reconet
    from vst_tpu.train.checkpoint import save_params

    rng = np.random.default_rng(5)
    video = str(tmp_path / "in.avi")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10, (32, 24))
    for _ in range(7):
        vw.write(rng.integers(0, 256, (24, 32, 3)).astype(np.uint8))
    vw.release()
    weights = str(tmp_path / "reconet.npz")
    save_params(init_reconet(0, 3), weights)
    common = ["-m", "vst_tpu_torch.cli.infer_video", "--model", "reconet",
              "--weights", weights, "--video", video, "--size", "32", "24",
              "--input-frame-num", "3", "--batch-size", "2",
              "--frames-ext", "png", "--device", "cpu"]
    runs = td.run_commands([
        common + ["--frames-dir", str(tmp_path / "one")],
        common + ["--frames-dir", str(tmp_path / "dp"),
                  "--data-parallel", "2"]])
    for rc, out in runs:
        assert rc == 0, out[-3000:]
    assert "data-parallel serving over 2 devices (1 frames/device)" in runs[1][1]
    assert "5 frames" in runs[0][1] and "5 frames" in runs[1][1]
    ref = sorted((tmp_path / "one").glob("*.png"))
    ours = sorted((tmp_path / "dp").glob("*.png"))
    assert [p.name for p in ours] == [p.name for p in ref] and len(ref) == 5
    for a, b in zip(ours, ref):
        diff = (np.asarray(Image.open(a)).astype(int)
                - np.asarray(Image.open(b)).astype(int))
        assert np.abs(diff).max() <= 1
