"""The port's training CLI (``vst_tpu_torch/cli/train.py``) with the seven
ReCoNet trainers on the CPU at a small size (24×32, batch 2), from a
synthetic SceneFlow tree (tests/test_data.py::_make_sceneflow_scene), a
COCO tree and a style image: each trainer runs an epoch, writes its
checkpoints and resumes with ``--resume auto``; the candy, coco and SD2
trainers' losses match the JAX CLI's on the same files and seed.  The
AdaAttN trainers' CLI tests are in tests/test_torch_cli_train.py."""

import numpy as np
import pytest
import torch

from vst_tpu_torch.cli import train as cli
from tests.test_torch_cli_train import _records, _write


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads: the suite runs six workers on the machine's
    cores, and torch's default of one thread per core oversubscribes them
    (these steps then ran 50× slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


RECONET = ("reconet-candy", "reconet-starry-night", "reconet-noftl",
           "reconet-multiframe", "reconet-coco", "reconet-sd1",
           "reconet-sd2")


@pytest.fixture(scope="module")
def reconet_data(tmp_path_factory):
    """A SceneFlow root (Monkaa and FlyingThings3D scenes of 5 frames at
    32×24, flows as .pfm: 8 one-frame samples, 2 four-frame ones), a COCO
    root of 4 images, a style image, and teacher checkpoints of a seeded
    ReCoNet (for SD1) and SD1 (for SD2)."""
    from tests.test_data import _make_sceneflow_scene
    from vst_tpu_torch.models.reconet import init_reconet, init_reconet_sd1
    from vst_tpu_torch.train.checkpoint import save_params

    root = tmp_path_factory.mktemp("reconet_data")
    rng = np.random.default_rng(1)
    _make_sceneflow_scene(str(root / "sceneflow" / "monkaa"), rng, 5,
                          "monkaa")
    _make_sceneflow_scene(str(root / "sceneflow" / "flyingthings3d"), rng, 5,
                          "ft3d")
    (root / "coco" / "train2014").mkdir(parents=True)
    for i in range(4):
        _write(str(root / "coco" / "train2014" / f"{i}.png"), rng, (40, 36))
    _write(str(root / "style.png"), rng, (50, 40))
    save_params(init_reconet(5, device="cpu"), str(root / "reconet.npz"))
    save_params(init_reconet_sd1(5, device="cpu"), str(root / "sd1.npz"))
    return root


def _reconet_args(data, trainer, out_dir, epochs):
    teacher = {"reconet-sd1": "reconet.npz", "reconet-sd2": "sd1.npz"}
    args = ["--trainer", trainer, "--device", "cpu",
            "--data", str(data / ("coco" if trainer == "reconet-coco"
                                  else "sceneflow")),
            "--style", str(data / "style.png"), "--out-dir", str(out_dir),
            "--epochs", str(epochs), "--batch-size", "2", "--seed", "4",
            "--img-size", "24", "32", "--log-every", "1",
            "--metrics-jsonl", str(out_dir / "metrics.jsonl")]
    if trainer in teacher:
        args += ["--teacher-weights", str(data / teacher[trainer])]
    return args


@pytest.mark.parametrize("trainer", RECONET)
def test_reconet_trainer_runs_checkpoints_and_resumes(reconet_data,
                                                      tmp_path, trainer):
    """Each ReCoNet trainer on the CPU: an epoch (finite losses logged at
    every step, the SD1 stage's SD loss as null: NaN, as the reference's
    mismatched taps give), its .npz/.pth and _last_state, then
    ``--resume auto`` with one more epoch continues from the saved step
    and writes the second epoch's checkpoint."""
    from vst_tpu_torch.train.checkpoint import load_params

    cli.main(_reconet_args(reconet_data, trainer, tmp_path, 1))
    first = _records(tmp_path)
    n = {"reconet-multiframe": 1, "reconet-coco": 2}.get(trainer, 4)
    assert sorted(first) == list(range(1, n + 1))
    for rec in first.values():
        for k, v in rec.items():
            if k == "SDL" and trainer == "reconet-sd1":
                assert v is None
            else:
                assert v is not None and np.isfinite(v), (k, v)
    name = f"{trainer}_epoch_1_batchSize_2"
    assert (tmp_path / f"{name}.pth").exists()
    params = load_params(str(tmp_path / f"{name}.npz"))
    stem = params["conv1.conv2d.weight" if trainer != "reconet-sd2"
                  else "conv1_sd2.conv2d.weight"]
    assert stem.shape[1] == (12 if trainer == "reconet-multiframe" else 3)
    cli.main(_reconet_args(reconet_data, trainer, tmp_path, 2)
             + ["--resume", "auto"])
    assert sorted(_records(tmp_path)) == list(range(1, 2 * n + 1))
    assert (tmp_path / f"{trainer}_epoch_2_batchSize_2.npz").exists()


@pytest.mark.parametrize("trainer", ["reconet-candy", "reconet-coco",
                                     "reconet-sd2"])
def test_reconet_cli_losses_match_jax(reconet_data, tmp_path, trainer):
    """The first epoch's logged losses against the JAX CLI's on the same
    files and seed, rtol 2e-3 (the step tolerance of
    tests/test_torch_reconet_train.py)."""
    from vst_tpu.cli import train as jcli

    cli.main(_reconet_args(reconet_data, trainer, tmp_path / "port", 1))
    jargs = _reconet_args(reconet_data, trainer, tmp_path / "jax", 1)
    i = jargs.index("--device")
    jargs[i:i + 2] = ["--platform", "cpu"]
    jcli.main(jargs)
    ours, ref = _records(tmp_path / "port"), _records(tmp_path / "jax")
    assert sorted(ours) == sorted(ref)
    for s in ref:
        for k, v in ref[s].items():
            if k in ("epoch", "batch", "step", "samples_per_s"):
                continue
            np.testing.assert_allclose(ours[s][k], v, rtol=2e-3,
                                       err_msg=f"step {s} {k}")
