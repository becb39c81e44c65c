"""Multi-rank harness for the port's CPU tests: real spawned gloo process
groups, one process per rank, with a timeout of their own.

``spawn(fn, world, tmp_path, *args)`` runs ``fn(mesh_rank, world, *args)``
in ``world`` spawned processes joined through ``multihost.initialize``
(gloo, ``file://`` rendezvous under ``tmp_path``) and returns their results
in rank order.  A rank that raises fails the test with its traceback; a
group that does not finish within ``timeout`` seconds is killed and fails
the test, so a collective that hangs cannot eat the suite's time limit.

The rank functions live here, not in the test files: a spawned child
imports the module of its function, and this one imports neither JAX nor
the JAX package.  Results cross back as numpy arrays (pickled)."""

import contextlib
import os
import queue
import signal
import subprocess
import sys
import time
import traceback
import uuid

import numpy as np
import torch


def spawn(fn, world, tmp_path, *args, timeout=120.0):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = "file://" + os.path.join(str(tmp_path), f"rdzv_{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, rank, world, init, results, args))
             for rank in range(world)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise AssertionError(
                    f"{fn.__name__}: {world} ranks did not finish in "
                    f"{timeout:.0f} s (ranks done: {sorted(out)})")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise AssertionError(f"{fn.__name__}: a rank died with "
                                         f"exit code {dead[0]}")
                continue
            if not ok:
                raise AssertionError(f"{fn.__name__} rank {rank}:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_commands(commands, timeout=180.0):
    """Run each command (argv lists after the interpreter) as its own
    process group, all at once, from the repo root; return
    [(returncode, output)].  Past ``timeout`` every group is killed,
    spawned ranks included, and the test fails."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    logs = [tempfile.TemporaryFile("w+") for _ in commands]
    procs = [subprocess.Popen([sys.executable, *c], cwd=REPO, env=env,
                              stdout=log, stderr=subprocess.STDOUT,
                              text=True, start_new_session=True)
             for c, log in zip(commands, logs)]
    deadline = time.monotonic() + timeout
    try:
        rcs = [p.wait(timeout=max(deadline - time.monotonic(), 0.1))
               for p in procs]
    except subprocess.TimeoutExpired:
        raise AssertionError(f"commands did not finish in {timeout:.0f} s: "
                             f"{commands}") from None
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    out = []
    for rc, log in zip(rcs, logs):
        log.seek(0)
        out.append((rc, log.read()))
        log.close()
    return out


def _child(fn, rank, world, init, results, args):
    from vst_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    try:
        multihost.initialize(num_processes=world, process_id=rank,
                             device="cpu", init_method=init)
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        multihost.shutdown()


@contextlib.contextmanager
def world1(tmp_path):
    """A world-1 gloo group in this process and its 1-D mesh, for the
    duration of the block."""
    from vst_tpu_torch.parallel import make_mesh, multihost

    multihost.initialize(num_processes=1, process_id=0, device="cpu",
                         init_method="file://" + os.path.join(
                             str(tmp_path), f"rdzv_{uuid.uuid4().hex}"))
    try:
        yield make_mesh()
    finally:
        multihost.shutdown()


def mesh_of(n):
    """A mesh object of a ``n``-way data axis whose rank is the first: for
    the checks that run before any collective."""
    from vst_tpu_torch.parallel.mesh import Mesh

    return Mesh(("data",), (n,), {}, {}, {"data": 0}, torch.device("cpu"))


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------- rank bodies

def mesh_layouts(rank, world):
    """A 1-D mesh with shard_batch and replicate on it, and a (1, world)
    data×space mesh's groups."""
    from vst_tpu_torch.parallel import make_mesh, replicate, shard_batch

    mesh = make_mesh()
    x = torch.arange(world * 6, dtype=torch.float32).reshape(world * 2, 3)
    own = shard_batch(mesh, {"x": x, "y": [x.numpy()]})
    tree = {"w": torch.full((3,), float(rank)),
            "b": [torch.full((2,), rank, dtype=torch.int64)]}
    replicate(mesh, tree)
    grid = make_mesh(None, ("data", "space"), (1, world))
    return ({"shape": mesh.shape, "index": mesh.index, "ranks": mesh.ranks,
             "own": _np(own["x"]), "own_y": _np(own["y"][0]),
             "w": _np(tree["w"]), "b": _np(tree["b"][0])},
            {"shape": grid.shape, "index": grid.index, "ranks": grid.ranks})


def _seeded(seed, input_frame_num=1):
    from vst_tpu_torch.compat import params_from_jax
    from vst_tpu_torch.models import reconet

    return reconet.build("reconet", params_from_jax(
        reconet.init_params("reconet", seed, input_frame_num)),
        input_frame_num, "cpu")


def reconet_flow_step(rank, world, cfg, batch, style, shard, seed=0):
    """One ReCoNet flow step on this rank's shard of ``batch`` (or the
    whole batch when ``shard`` is False); the metrics, the (averaged)
    gradients and the updated parameters."""
    from vst_tpu_torch.models import vgg as pv
    from vst_tpu_torch.parallel import make_mesh, replicate, shard_batch
    from vst_tpu_torch.train import state as ps
    from vst_tpu_torch.train import steps as pst

    mesh = make_mesh() if shard else None
    vgg = pv.init_vgg16_reconet(0, device="cpu")
    state = ps.create(_seeded(seed, cfg.input_frame_num), cfg.lr)
    if mesh is not None:
        replicate(mesh, state)
        batch = shard_batch(mesh, batch)
    grams = pst.reconet_style_grams(vgg, style)
    step = pst.make_reconet_flow_step(cfg, vgg, grams, mesh)
    state, metrics = step(state, batch)
    return ({k: float(v) for k, v in metrics.items()},
            {k: _np(p.grad) for k, p in state.model.named_parameters()},
            {k: _np(v) for k, v in state.model.state_dict().items()})


def spatial_flow_steps(rank, world, cases, style, seed=0):
    """One ReCoNet flow step for each case (cfg, global batch, mesh shape)
    on a ("data", "space") mesh of that shape, the batch placed by
    ``shard_batch_spatial``: this rank's (metrics, gradients (rank 0's
    only; every rank's are equal after the step's reductions), updated
    parameters).  First ``shard_batch_spatial``'s layout on the first
    case's mesh: this rank's block of an arange batch, its mesh index, and
    the ``ValueError`` of an H that does not split."""
    from vst_tpu_torch.models import vgg as pv
    from vst_tpu_torch.parallel import (make_mesh, replicate,
                                        shard_batch_spatial)
    from vst_tpu_torch.train import state as ps
    from vst_tpu_torch.train import steps as pst

    vgg = pv.init_vgg16_reconet(0, device="cpu")
    grams = pst.reconet_style_grams(vgg, style)
    out = []
    for i, (cfg, batch, shape) in enumerate(cases):
        mesh = make_mesh(None, ("data", "space"), shape)
        if i == 0:
            n, h = 2 * shape[0], 4 * shape[1]
            x = np.arange(n * h * 3 * 2, dtype=np.float32).reshape(n, h, 3, 2)
            own = shard_batch_spatial(mesh, {"x": x, "m": [x[..., 0]]})
            try:
                shard_batch_spatial(mesh, x[:, :h - 1])
                err = None
            except ValueError as e:
                err = str(e)
            out.append((mesh.index, _np(own["x"]), _np(own["m"][0]),
                        str(own["x"].device), err))
        state = ps.create(_seeded(seed, cfg.input_frame_num), cfg.lr)
        replicate(mesh, state)
        step = pst.make_reconet_flow_step(cfg, vgg, grams, mesh)
        state, metrics = step(state, shard_batch_spatial(mesh, batch))
        out.append(({k: float(v) for k, v in metrics.items()},
                    {k: _np(p.grad) for k, p in
                     state.model.named_parameters()} if rank == 0 else None,
                    {k: _np(v) for k, v in state.model.state_dict().items()}))
    return out


# Seeds of the data × space step cases, the JAX tests' own: VGG 0, the
# trained network 1, a distillation teacher 2.
SEED_VGG, SEED_NET, SEED_TEACHER = 0, 1, 2
TEACHER = {"sd1": "reconet", "sd2": "sd1"}


@contextlib.contextmanager
def _step_dtype(name):
    """Let a step builder take ``dtype="float64"`` (the exact evaluation
    of a check; the package offers float32 and bfloat16) in the block."""
    from vst_tpu_torch.train import steps as pst

    if name in pst.DTYPES:
        yield
        return
    pst.DTYPES[name] = getattr(torch, name)
    try:
        yield
    finally:
        del pst.DTYPES[name]


def train_setup(kind, cfg, style=None):
    """(a fresh seeded model, ``build(mesh)`` → the step) of a builder
    kind: "flow" (ReCoNet's flow step), "coco", "sd1" / "sd2" (the
    distillation stages, the teacher seeded ``SEED_TEACHER``), "rtnstv",
    "adaattn_image" or "adaattn_video"; ``style`` (1, H, W, 3) gives the ReCoNet and RTNSTV
    grams.  ``cfg.dtype`` may also be "float64"."""
    new_model, build = _train_setup(kind, cfg, style)

    def build_at_dtype(mesh):
        with _step_dtype(cfg.dtype):
            return build(mesh)

    return new_model, build_at_dtype


def _train_setup(kind, cfg, style):
    from vst_tpu_torch.models import adaattn as pa
    from vst_tpu_torch.models import reconet, rtnstv
    from vst_tpu_torch.models import vgg as pv
    from vst_tpu_torch.train import steps as pst

    if kind.startswith("adaattn"):
        vgg = pv.init_vgg19_adaattn(SEED_VGG, device="cpu")
        build = {"adaattn_image": pst.make_adaattn_image_step,
                 "adaattn_video": pst.make_adaattn_video_step}[kind]
        return (lambda: pa.init_stylizing_network(SEED_NET, device="cpu"),
                lambda mesh: build(cfg, vgg, mesh))
    if kind == "rtnstv":
        vgg = pv.init_vgg19_rtnstv(SEED_VGG, device="cpu")
        grams = pst.rtnstv_style_grams(vgg, style)
        return (lambda: rtnstv.init_stylizing_network(SEED_NET, device="cpu"),
                lambda mesh: pst.make_rtnstv_step(cfg, vgg, grams, mesh))
    vgg = pv.init_vgg16_reconet(SEED_VGG, device="cpu")
    grams = pst.reconet_style_grams(vgg, style)
    if kind == "flow":
        return (lambda: reconet.init_reconet(SEED_NET, cfg.input_frame_num,
                                             device="cpu"),
                lambda mesh: pst.make_reconet_flow_step(cfg, vgg, grams,
                                                        mesh))
    if kind == "coco":
        return (lambda: reconet.init_reconet(SEED_NET, device="cpu"),
                lambda mesh: pst.make_reconet_coco_step(cfg, vgg, grams,
                                                        mesh))
    init = {"reconet": reconet.init_reconet, "sd1": reconet.init_reconet_sd1,
            "sd2": reconet.init_reconet_sd2}
    teacher = init[TEACHER[kind]](SEED_TEACHER, device="cpu")
    return (lambda: init[kind](SEED_NET, device="cpu"),
            lambda mesh: pst.make_reconet_distill_step(cfg, vgg, grams,
                                                       teacher, mesh))


def _step_result(state, metrics, grads=True):
    return ({k: float(v) for k, v in metrics.items()},
            {k: _np(p.grad) for k, p in state.model.named_parameters()}
            if grads else None,
            {k: _np(v) for k, v in state.model.state_dict().items()})


def single_train_step(kind, cfg, batch, style=None):
    """One step of ``kind`` in this process on the whole batch, no mesh:
    (metrics, gradients, updated parameters)."""
    from vst_tpu_torch.train import state as ps

    new_model, build = train_setup(kind, cfg, style)
    state, metrics = build(None)(ps.create(new_model(), cfg.lr), batch)
    return _step_result(state, metrics)


def mesh_world(shape):
    """The ranks of a step case's mesh shape: a pair (data, space) for a
    ("data", "space") mesh, one number for a "space" axis alone."""
    return shape if isinstance(shape, int) else shape[0] * shape[1]


def spatial_train_steps(rank, world, cases):
    """One step for each case (kind, cfg, global batch, mesh shape, style)
    on a mesh of that shape (``mesh_world``), the batch placed by
    ``shard_batch_spatial``: this rank's (metrics, gradients (rank 0's
    only; every rank's are equal after the step's reductions), updated
    parameters)."""
    from vst_tpu_torch.parallel import (make_mesh, replicate,
                                        shard_batch_spatial)
    from vst_tpu_torch.train import state as ps

    out = []
    for kind, cfg, batch, shape, style in cases:
        mesh = (make_mesh(None, ("space",)) if isinstance(shape, int)
                else make_mesh(None, ("data", "space"), shape))
        new_model, build = train_setup(kind, cfg, style)
        state = ps.create(new_model(), cfg.lr)
        replicate(mesh, state)
        state, metrics = build(mesh)(state, shard_batch_spatial(mesh, batch))
        out.append(_step_result(state, metrics, grads=rank == 0))
    return out


def spatial_step_cache(tmp_path_factory, cases, timeout=240.0,
                       worker=None):
    """``get(name)`` → every rank's (metrics, gradients (rank 0),
    parameters) of ``cases[name]`` = (kind, cfg, global batch, mesh
    shape, style), or what ``worker`` (``spatial_train_steps``'s
    signature) gives for it; each world's ranks spawned once, for all of
    its cases, at the first ``get`` of one of them."""
    worker = worker or spatial_train_steps
    worlds = {}

    def get(name):
        world = mesh_world(cases[name][3])
        if world not in worlds:
            names = [k for k, v in cases.items()
                     if mesh_world(v[3]) == world]
            ranks = spawn(worker, world,
                          tmp_path_factory.mktemp(f"steps{world}"),
                          [cases[k] for k in names], timeout=timeout)
            worlds[world] = {k: [r[i] for r in ranks]
                             for i, k in enumerate(names)}
        return worlds[world][name]

    return get


def assert_matches_jax(result, ref, lr):
    """A sharded step's (metrics, _, parameters) against JAX's
    single-device step's (metrics, JAX-layout parameters) on the global
    batch: every metric within rtol 1e-4 (NaN where it is NaN), the
    parameters within Adam's ±lr envelope (atol 2.1·lr): JAX's own bounds
    for its (4 × 2) step (tests/test_parallel.py)."""
    from vst_tpu_torch.compat import params_to_jax

    (m, _, p), (m_j, p_j) = result, ref
    assert set(m) == set(m_j)
    for key in m_j:
        if np.isnan(m_j[key]):
            assert np.isnan(m[key]), key
        else:
            np.testing.assert_allclose(m[key], m_j[key], rtol=1e-4,
                                       err_msg=key)
    ours = params_to_jax({k: torch.from_numpy(v) for k, v in p.items()})
    for key, want in p_j.items():
        np.testing.assert_allclose(ours[key], want, atol=2.1 * lr,
                                   err_msg=key)


def assert_ranks_agree(ranks):
    """Every rank logs the same metrics and holds the same parameters, bit
    for bit, after a step."""
    m0, _, p0 = ranks[0]
    for m, _, p in ranks[1:]:
        assert set(m) == set(m0)
        for key in m0:   # NaN (SD1's SD loss) equals NaN here
            np.testing.assert_array_equal(m[key], m0[key], err_msg=key)
        for key in p0:
            np.testing.assert_array_equal(p[key], p0[key], err_msg=key)


def assert_matches_single(result, single, p0, lr, keys=None, grad_tol=1e-4):
    """A sharded step's (metrics, gradients, parameters) against the
    single-process step's on the global batch: the metrics within rtol
    1e-5 (NaN where it is NaN); the gradients within ``grad_tol`` of each
    key's largest (the conv biases an instance norm follows, whose true
    gradient is 0, aside); the update Adam's first step on its own
    gradient, p0 − lr·g/(|g| + eps), within 1e-3·lr everywhere; and within
    1e-3·lr of the single-process parameters wherever that step's gradient
    lies above the gradient tolerance and above 1e3·eps, within 2.1·lr
    everywhere.  Below the tolerance float32 rounding decides the sign of
    a ±lr step; and the update's slope, eps/(|g| + eps)², turns a gradient
    difference δg ≤ |g| into one of at most eps/|g|·lr, 1e-3·lr at |g| =
    1e3·eps.  ``keys``: the parameters whose gradients and update are
    compared (default all)."""
    (m, g, p), (m_1, g_1, p_1) = result, single
    assert set(m) == set(m_1)
    for key in m_1:
        if np.isnan(m_1[key]):
            assert np.isnan(m[key]), key
        else:
            np.testing.assert_allclose(m[key], m_1[key], rtol=1e-5,
                                       err_msg=key)
    top = max(np.abs(v).max() for v in g_1.values())
    for key in (g_1 if keys is None else keys):
        ref = g_1[key]
        np.testing.assert_allclose(
            p[key], p0[key] - lr * g[key] / (np.abs(g[key]) + 1e-8),
            rtol=0, atol=1e-3 * lr, err_msg=key)
        np.testing.assert_allclose(p[key], p_1[key], rtol=0, atol=2.1 * lr,
                                   err_msg=key)
        scale = np.abs(ref).max()
        if scale < 1e-6 * top:   # a bias before an instance norm
            continue
        np.testing.assert_allclose(g[key], ref, rtol=0,
                                   atol=grad_tol * scale, err_msg=key)
        firm = np.abs(ref) > max(grad_tol * scale, 1e3 * 1e-8)
        np.testing.assert_allclose(p[key][firm], p_1[key][firm], rtol=0,
                                   atol=1e-3 * lr, err_msg=key)


def adaattn_step(rank, world, kind, cfg, batch, shard):
    """One AdaAttN image or video step, as ``reconet_flow_step``."""
    from vst_tpu_torch.models import adaattn as pa
    from vst_tpu_torch.models import vgg as pv
    from vst_tpu_torch.parallel import make_mesh, replicate, shard_batch
    from vst_tpu_torch.train import state as ps
    from vst_tpu_torch.train import steps as pst

    mesh = make_mesh() if shard else None
    vgg = pv.init_vgg19_adaattn(0, device="cpu")
    state = ps.create(pa.init_stylizing_network(1, device="cpu"), cfg.lr)
    if mesh is not None:
        replicate(mesh, state)
        batch = shard_batch(mesh, batch)
    build = {"image": pst.make_adaattn_image_step,
             "video": pst.make_adaattn_video_step}[kind]
    state, metrics = build(cfg, vgg, mesh)(state, batch)
    return ({k: float(v) for k, v in metrics.items()},
            {k: _np(p.grad) for k, p in state.model.named_parameters()},
            {k: _np(v) for k, v in state.model.state_dict().items()})


def sharded_moments(rank, world, activation, q, k, v):
    """The sequence-parallel moments of full q, k, v (every rank gets the
    full result through ``attention_moments(mesh=)``) and this rank's
    shard straight from the sharded function."""
    from vst_tpu_torch.models import adaattn as pa
    from vst_tpu_torch.parallel import attention as sp
    from vst_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    full = pa.attention_moments(q, k, v, activation, mesh=mesh)
    fn = {"cosine": sp.sharded_cosine_attention_moments,
          "softmax": sp.sharded_softmax_attention_moments}[activation]
    n, m = q.shape[1] // world, k.shape[1] // world
    own = fn(mesh, q[:, rank * n:(rank + 1) * n],
             k[:, rank * m:(rank + 1) * m], v[:, rank * m:(rank + 1) * m])
    return [_np(t) for t in full], [_np(t) for t in own]


def stylizer_with_mesh(rank, world, activation, content, style):
    """``stylizing_network(..., mesh=)`` of the seeded AdaAttN (VGG19 seed
    0, AdaAttN seed 1) on every rank."""
    from vst_tpu_torch.models import adaattn as pa
    from vst_tpu_torch.models import vgg as pv
    from vst_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    vgg = pv.init_vgg19_adaattn(0, device="cpu")
    net = pa.init_stylizing_network(1, device="cpu")
    with torch.no_grad():
        fc = vgg(torch.from_numpy(content))
        fs = vgg(torch.from_numpy(style))
        return _np(pa.stylizing_network(net, fc, fs, activation, mesh=mesh))


def rows_of(x, rank, world):
    """This rank's token rows (dim 1) of a full array."""
    n = x.shape[1] // world
    return x[:, rank * n:(rank + 1) * n]


def stylizer_loss(out, cot):
    """The fixed loss of the stylizer gradient checks: the mean square of
    the output times a seeded cotangent."""
    return (out * cot).square().mean()


def _stylizer_grads(net, fc, fs, activation, cot, mesh, remat):
    from vst_tpu_torch.models import adaattn as pa

    net.zero_grad()
    out = pa.stylizing_network(net, fc, fs, activation, mesh=mesh,
                               remat=remat)
    stylizer_loss(out, cot).backward()
    return {k: _np(p.grad) for k, p in net.named_parameters()}


def sharded_grads(rank, world, cases):
    """The gradients of the sequence-parallel attention for each case,
    in one group:
    - ("shard", activation, dtype, q, k, v, c1, c2): this rank's dQ, dK,
      dV from the shard-level function on its token rows of q, k, v, for
      its rows of the cotangents (c1, c2) of (M1, M2);
    - ("full", activation, q, k, v, c1, c2): dQ, dK, dV of the full
      tensors through ``attention_moments(mesh=)``;
    - ("stylizer", activation, dtype, content, style, cot, remat): the
      parameter gradients of ``stylizer_loss`` through ``stylizing_network(...,
      mesh=)`` of the seeded AdaAttN (VGG19 seed 0, AdaAttN seed 1), and
      the same without the mesh (once per activation and dtype: the
      content, style and cotangent are the same for every such case)."""
    from vst_tpu_torch.models import adaattn as pa
    from vst_tpu_torch.models import vgg as pv
    from vst_tpu_torch.parallel import attention as sp
    from vst_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    fns = {"cosine": sp.sharded_cosine_attention_moments,
           "softmax": sp.sharded_softmax_attention_moments}
    out, unsharded = [], {}
    for kind, activation, *args in cases:
        if kind == "shard":
            dtype, *arrays = args
            q, k, v, c1, c2 = (torch.from_numpy(rows_of(a, rank, world))
                               .to(dtype) for a in arrays)
            ins = [t.requires_grad_() for t in (q, k, v)]
            m1, m2 = fns[activation](mesh, *ins)
            grads = torch.autograd.grad((m1, m2), ins,
                                        (c1.to(m1.dtype), c2.to(m2.dtype)))
            out.append([_np(g.float()) for g in grads])
        elif kind == "full":
            ins = [torch.from_numpy(a).requires_grad_() for a in args[:3]]
            cot = [torch.from_numpy(a) for a in args[3:]]
            moments = pa.attention_moments(*ins, activation, mesh=mesh)
            out.append([_np(g) for g in torch.autograd.grad(moments, ins,
                                                            cot)])
        else:
            dtype, content, style, cot, remat = args
            vgg = pv.init_vgg19_adaattn(0, device="cpu", dtype=dtype)
            net = pa.init_stylizing_network(1, device="cpu", dtype=dtype)
            with torch.no_grad():
                fc = vgg(torch.from_numpy(content).to(dtype))
                fs = vgg(torch.from_numpy(style).to(dtype))
            cot = torch.from_numpy(cot).to(dtype)
            if (activation, dtype) not in unsharded:
                unsharded[activation, dtype] = _stylizer_grads(
                    net, fc, fs, activation, cot, None, False)
            out.append((_stylizer_grads(net, fc, fs, activation, cot, mesh,
                                        remat),
                        unsharded[activation, dtype]))
    return out


def video_stylizer(rank, world, frames, style, batch_size, activation):
    """``AdaAttNVideoStylizer`` with a mesh: rank 0's styled frames (the
    others get none), and rank 0's run without a mesh before it."""
    from vst_tpu_torch.infer.video import AdaAttNVideoStylizer
    from vst_tpu_torch.models import adaattn as pa
    from vst_tpu_torch.models import vgg as pv
    from vst_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    vgg = pv.init_vgg19_adaattn(0, device="cpu")
    net = pa.init_stylizing_network(1, device="cpu")
    ref = None
    if rank == 0:
        ref = list(AdaAttNVideoStylizer(vgg, net, style, activation,
                                        batch_size).stylize_frames(
                                            iter(frames)))
    out = list(AdaAttNVideoStylizer(
        vgg, net, style, activation, batch_size, mesh=mesh).stylize_frames(
            iter(frames) if rank == 0 else None))
    return ref, out


# ------------------------------------------------- spatial (H-sharded) serving

def spatial_layout(rank, world, x):
    """``shard_spatial`` of a dict on a 1-D "space" mesh, and the message
    of its ``ValueError`` on an H that does not split."""
    from vst_tpu_torch.parallel import make_mesh, shard_spatial

    mesh = make_mesh(None, ("space",))
    own = shard_spatial(mesh, {"x": x, "y": [torch.from_numpy(x)]})
    try:
        shard_spatial(mesh, np.zeros((1, x.shape[1] + 1, 2, 3), np.float32))
        err = None
    except ValueError as e:
        err = str(e)
    return _np(own["x"]), _np(own["y"][0]), str(own["x"].device), err


def spatial_layer_cases(seed=3, dtype=torch.float32):
    """Every layer kind of the H-sharded path: name → (fn(x, spatial),
    the full-frame input: a tensor, or a list (a pyramid's levels; a
    warp's source and flow), the parameters fn reads).  ``fn(x, None)``
    is the unsharded layer; a rank applies ``fn`` to its rows.  Every H
    divides by 4 ranks with the blocks each kind needs (K2's 9×9 at 8
    rows a block).  ``dtype``: of the inputs and parameters (float64 for
    the gradient checks)."""
    from vst_tpu_torch.kernels.res_block import residual_block_fused
    from vst_tpu_torch.models.adaattn import _up2
    from vst_tpu_torch.ops import conv as oc
    from vst_tpu_torch.ops.features import feature_down_sample
    from vst_tpu_torch.ops.norm import instance_norm
    from vst_tpu_torch.ops.warp import warp

    g = np.random.default_rng(seed)

    def a(*shape, scale=1.0):
        return torch.from_numpy(g.standard_normal(shape) * scale).to(dtype)

    w3, b3 = a(6, 5, 3, 3, scale=0.2), a(6, scale=0.1)
    w9, b9 = a(4, 3, 9, 9, scale=0.05), a(4, scale=0.1)
    wt, bt = a(5, 4, 3, 3, scale=0.2), a(4, scale=0.1)    # (I, O, kh, kw)
    res = [a(3, 3, 8, 8, scale=0.1), a(8, scale=0.1), a(8, scale=0.2) + 1,
           a(8, scale=0.1), a(3, 3, 8, 8, scale=0.1), a(8, scale=0.1),
           a(8, scale=0.2) + 1, a(8, scale=0.1)]
    pyramid = [a(1, 64 >> i, 48 >> i, 3, scale=2.0) for i in range(5)]
    norm = [res[2][:5].clone(), res[3][:5].clone()]
    return {
        "reflect3x3_s1": (lambda x, s: oc.conv2d_reflect(x, w3, b3,
                                                         spatial=s),
                          a(2, 32, 12, 5), [w3, b3]),
        "reflect3x3_s2": (lambda x, s: oc.conv2d_reflect(x, w3, b3, 2,
                                                         spatial=s),
                          a(2, 32, 13, 5), [w3, b3]),
        "polyphase9x9_k2": (lambda x, s: oc.conv2d_polyphase_reflect(
            x, w9, b9, spatial=s), a(1, 32, 14, 3, scale=50.0), [w9, b9]),
        "nearest_up2_conv": (lambda x, s: oc.conv2d_nearest_up2(
            x, w3, b3, spatial=s), a(2, 8, 7, 5), [w3, b3]),
        "conv_transpose_s2": (lambda x, s: oc.conv_transpose2d(
            x, wt, bt, spatial=s), a(2, 8, 6, 5), [wt, bt]),
        "zero_pad_conv3x3": (lambda x, s: oc.conv2d(
            x, w3, b3, padding=1, spatial=s), a(2, 16, 9, 5), [w3, b3]),
        "max_pool2x2": (lambda x, s: oc.max_pool2d(x, spatial=s),
                        a(2, 16, 10, 4), []),
        "feature_down_sample": (lambda x, s: feature_down_sample(
            x, 4, spatial=s), pyramid, []),
        "bilinear_up2_clamp": (lambda x, s: _up2(x, s), a(2, 8, 5, 4), []),
        "instance_norm": (lambda x, s: instance_norm(
            x, *norm, spatial=s), a(2, 16, 9, 5, scale=3.0), norm),
        "residual_block_k1": (lambda x, s: residual_block_fused(
            x, *res, spatial=s), a(2, 16, 10, 8, scale=3.0), res),
        "warp_gather": (lambda x, s: warp(x[0], x[1], spatial=s),
                        [a(2, 16, 9, 4), a(2, 16, 9, 2, scale=4.0)], []),
    }


def spatial_loss_cases(seed=4, dtype=torch.float64):
    """The train steps' losses over row blocks: name → (fn(x, spatial),
    the full-frame inputs (a list), the indices of the inputs that take a
    gradient).  ``fn(x, None)`` is the unsharded loss; on a rank, this
    rank's share (the shares sum to it over the axis).  The temporal
    losses' mask counts are totalled over the spatial context's mesh.
    ReCoNet's (Gram style, content, TV, FTL, OTL), RTNSTV's (content,
    style, TV, temporal) and AdaAttN's (global stylized, image similarity);
    and, each as a seeded weighted sum taken as a whole term
    (``losses/perceptual.py::_share``), the sums of an all-reduce they
    build on: RTNSTV's Gram,
    AdaAttN's mean and Bessel std and cosine distance.  Those that divide
    by the axis size themselves (the style losses, the global stylized
    and image similarity losses) would give the sum of the shares, and
    their gradients, that many times too large without it."""
    from vst_tpu_torch import losses
    from vst_tpu_torch.losses.adaattn import _spatial_mean_std
    from vst_tpu_torch.losses.perceptual import _share
    from vst_tpu_torch.ops.image import gram_matrix_hw

    g = np.random.default_rng(seed)

    def a(*shape, scale=1.0):
        return torch.from_numpy(g.standard_normal(shape) * scale).to(dtype)

    grams = [a(1, 4, 4, scale=1e-2), a(1, 8, 8, scale=1e-2)]
    mask = torch.from_numpy(g.random((2, 16, 12)) > 0.3).to(dtype)
    flow = a(2, 16, 12, 2, scale=3.0)
    # the RTNSTV and AdaAttN cases draw from a generator of their own
    g2 = np.random.default_rng(seed + 1)

    def b(*shape, scale=1.0):
        return torch.from_numpy(g2.standard_normal(shape) * scale).to(dtype)

    # RTNSTV's spatial loss: content and styled relu4_2 taps, a styled
    # relu1_2 tap (the Grams pair with the styled taps in order), the
    # 0–255 styled frame
    rt_grams = [b(1, 3, 3, scale=0.5), b(1, 4, 4, scale=0.5)]
    rt_inputs = [b(2, 8, 3, 4), b(2, 16, 6, 3), b(2, 8, 3, 4),
                 b(2, 16, 7, 3, scale=50.0)]

    def rtnstv(x, s):
        return losses.rtnstv_spatial_loss(
            {"relu4_2": x[0]}, {"relu1_2": x[1], "relu4_2": x[2]}, rt_grams,
            x[3], 2.0, 3.0, 5.0, s)

    wgram, wcos = b(2, 4, 4), b(2, 4, 4)
    wms = [b(2, 4), b(2, 4)]
    style_tap = b(2, 4, 5, 4, scale=2.0) + 0.5
    return {
        "style_gram": (lambda x, s: losses.reconet_style_loss(
            x, grams, spatial=s), [a(2, 16, 6, 4), a(2, 8, 3, 8)], [0, 1]),
        "content": (lambda x, s: losses.reconet_content_loss(
            x[:1], x[1:], 0, spatial=s), [a(2, 16, 5, 4), a(2, 16, 5, 4)],
            [0, 1]),
        "total_variation": (lambda x, s: losses.reconet_reg_loss(
            x[0], spatial=s), [a(2, 16, 7, 3, scale=5.0)], [0]),
        "feature_temporal": (lambda x, s: losses.reconet_feature_temporal_loss(
            x[0], x[1], x[2], x[3], spatial=s),
            [a(2, 4, 3, 5), a(2, 4, 3, 5), flow, mask], [0, 1]),
        "output_temporal": (lambda x, s: losses.reconet_output_temporal_loss(
            *x, spatial=s), [a(2, 16, 12, 3) for _ in range(4)]
            + [flow, mask], [0, 1, 2, 3]),
        "rtnstv_content": (lambda x, s: rtnstv(x, s)[0], rt_inputs,
                           [0, 2]),
        "rtnstv_style": (lambda x, s: rtnstv(x, s)[1], rt_inputs, [1, 2]),
        "rtnstv_total_variation": (lambda x, s: rtnstv(x, s)[2], rt_inputs,
                                   [3]),
        "rtnstv_temporal": (lambda x, s: losses.rtnstv_temporal_loss(
            *x, spatial=s), [b(2, 16, 12, 3, scale=50.0),
                             b(2, 16, 12, 3, scale=50.0), flow, mask],
            [0, 1]),
        "gram_hw": (lambda x, s: _share(
            (gram_matrix_hw(x[0], s) * wgram).sum(), s), [b(2, 16, 5, 4)],
            [0]),
        "mean_std": (lambda x, s: _share(sum(
            (t * wt).sum() for t, wt in zip(_spatial_mean_std(x[0], s),
                                            wms)), s),
            [b(2, 16, 5, 4, scale=2.0) + 1.0], [0]),
        "global_stylized": (lambda x, s: losses.global_stylized_loss(
            x[0], style_tap, s), [b(2, 16, 5, 4, scale=2.0)], [0]),
        "cosine_distance": (lambda x, s: _share(
            (losses.cosine_distance(x[0], x[1], s) * wcos).sum(), s),
            [b(2, 16, 5, 4), b(2, 16, 5, 4)], [0, 1]),
        "image_similarity": (lambda x, s: losses.image_similarity_loss(
            *x, spatial=s), [b(2, 16, 5, 4).abs() for _ in range(4)],
            [0, 1, 2, 3]),
    }


def spatial_cotangent(name, shape):
    """The seeded cotangent (float64) of a layer kind's whole output."""
    import zlib

    return torch.from_numpy(np.random.default_rng(
        zlib.crc32(name.encode())).standard_normal(tuple(shape)))


def spatial_grad(fn, x, params, grad_inputs, spatial, cotangent):
    """Run ``fn(x, spatial)`` (x a tensor or a list) with gradients for
    the inputs ``grad_inputs`` (indices into the list; None: all) and the
    ``params`` (which fn reads), back-propagate ``cotangent(y)`` and
    return (the output, the inputs' gradients, the parameters'
    gradients) as numpy arrays."""
    xs = list(x) if isinstance(x, list) else [x]
    idx = list(range(len(xs)) if grad_inputs is None else grad_inputs)
    xs = [t.detach().clone().requires_grad_(i in idx)
          for i, t in enumerate(xs)]
    for p in params:
        p.requires_grad_()
    try:
        y = fn(xs if isinstance(x, list) else xs[0], spatial)
        grads = torch.autograd.grad(y, [xs[i] for i in idx] + list(params),
                                    cotangent(y))
    finally:
        for p in params:
            p.requires_grad_(False)
    return (_np(y), [_np(t) for t in grads[:len(idx)]],
            [_np(t) for t in grads[len(idx):]])


def rows_cotangent(name, rank, world):
    """``cotangent(y)`` for ``spatial_grad`` of a layer kind: this rank's
    rows of ``spatial_cotangent`` at the whole output's shape (world = 1:
    the whole)."""
    def cot(y):
        r = y.shape[1]
        whole = spatial_cotangent(name, (y.shape[0], r * world,
                                         *y.shape[2:]))
        return whole[:, rank * r:(rank + 1) * r].to(y.dtype)

    return cot


EXCHANGE_CASES = [(edge, wpad) for edge in ("reflect", "zero", "clamp")
                  for wpad in (0, 1)]


def _exchange_adjoint(rank, ctx):
    """(edge, wpad) → (⟨exchange(x), g⟩, ⟨x, exchangeᵀ(g)⟩) on this rank,
    float64, 2 rows above and 1 below, x and g seeded by rank and case."""
    from vst_tpu_torch.parallel.spatial import exchange_rows

    out = {}
    for i, (edge, wpad) in enumerate(EXCHANGE_CASES):
        g = np.random.default_rng((rank, i))
        x = torch.from_numpy(g.standard_normal((2, 4, 5, 3))
                             ).requires_grad_()
        y = exchange_rows(ctx, x, 2, 1, edge, wpad,
                          "zero" if edge == "zero" else "reflect")
        cot = torch.from_numpy(g.standard_normal(tuple(y.shape)))
        (gx,) = torch.autograd.grad(y, x, cot)
        out[(edge, wpad)] = (float((y * cot).sum()), float((x * gx).sum()))
    return out


def spatial_layers(rank, world):
    """Each layer kind of ``spatial_layer_cases`` on this rank's rows:
    "fwd": name → its float32 output rows; "grad": name → (output, the
    inputs' gradients, the parameters' gradients) in float64 under the
    cotangent's rows, for every layer kind and loss share
    (``spatial_loss_cases``, whose output is the share); "adjoint": the
    exchange's inner products (``_exchange_adjoint``)."""
    from vst_tpu_torch.parallel import make_mesh, shard_spatial
    from vst_tpu_torch.parallel.spatial import SpatialContext

    mesh = make_mesh(None, ("space",))
    ctx = SpatialContext(mesh)
    fwd, grad = {}, {}
    with torch.no_grad():
        for name, (fn, x, _) in spatial_layer_cases().items():
            fwd[name] = _np(fn(shard_spatial(mesh, x), ctx))
    for name, (fn, x, params) in spatial_layer_cases(
            dtype=torch.float64).items():
        grad[name] = spatial_grad(fn, shard_spatial(mesh, x), params, None,
                                  ctx, rows_cotangent(name, rank, world))
    for name, (fn, x, idx) in spatial_loss_cases().items():
        grad[name] = spatial_grad(fn, shard_spatial(mesh, x), [], idx, ctx,
                                  torch.ones_like)
    return {"fwd": fwd, "grad": grad, "adjoint": _exchange_adjoint(rank,
                                                                   ctx)}


SPATIAL_FAMILIES = ("reconet", "sd1", "sd2", "rtnstv")


def spatial_model(family, seed=0):
    """The seeded (JAX ``init_*(seed)``) model of ``family`` on the CPU."""
    from vst_tpu_torch.models import reconet, rtnstv

    if family == "rtnstv":
        return rtnstv.init_stylizing_network(seed, device="cpu")
    return {"reconet": reconet.init_reconet, "sd1": reconet.init_reconet_sd1,
            "sd2": reconet.init_reconet_sd2}[family](seed, device="cpu")


def spatial_stylize(rank, world, x, ada=None):
    """``stylize_spatial_sharded`` of each seeded family on this rank's
    rows of x, and with ``ada`` = (content, style) ``stylize_adaattn_
    sharded`` cosine and softmax (VGG19 seed 0, AdaAttN seed 1); plus the
    ReCoNet frame assembled by ``gather_rows``."""
    from vst_tpu_torch.infer.image import (stylize_adaattn_sharded,
                                           stylize_spatial_sharded)
    from vst_tpu_torch.models import adaattn as pa
    from vst_tpu_torch.models import vgg as pv
    from vst_tpu_torch.parallel import gather_rows, make_mesh
    from vst_tpu_torch.parallel.spatial import SpatialContext

    mesh = make_mesh(None, ("space",))
    out = {f: stylize_spatial_sharded(spatial_model(f), x, mesh)
           for f in SPATIAL_FAMILIES}
    gathered = _np(gather_rows(SpatialContext(mesh), out["reconet"]))
    out = {f: _np(y) for f, y in out.items()}
    if ada is not None:
        vgg = pv.init_vgg19_adaattn(0, device="cpu")
        net = pa.init_stylizing_network(1, device="cpu")
        for act in ("cosine", "softmax"):
            out[f"adaattn_{act}"] = _np(stylize_adaattn_sharded(
                vgg, net, *ada, mesh, activation=act))
    return out, gathered


# ------------------------------------- uneven row layouts (row_layout)

# layer kind → (the rows of its input kept, the unit of its row layout):
# blocks of different rows, an odd bottom block before the stride-2 conv
# and the pool, and a bottom block that is not a multiple of 4 before K2
UNEVEN_LAYERS = {"reflect3x3_s1": (32, 1), "reflect3x3_s2": (31, 2),
                 "polyphase9x9_k2": (30, 4), "nearest_up2_conv": (8, 1),
                 "conv_transpose_s2": (8, 1), "zero_pad_conv3x3": (16, 1),
                 "max_pool2x2": (15, 2), "feature_down_sample": (64, 16),
                 "bilinear_up2_clamp": (8, 1), "instance_norm": (16, 1),
                 "residual_block_k1": (16, 1), "warp_gather": (16, 1)}


def partial_pyramid_case(dtype=torch.float32, seed=5):
    """AdaAttN's feature pyramid of a 40-row frame (the floor chain 40,
    20, 10, 5, 2 of VGG19's pools) resized to its last level: the frame's
    factor 20 is not a block's (16 or 24 rows at 2 ranks in 16-row
    units), so the resize reads the rows the frame's source index gives
    (``ops/resize.py::_resize_rows``).  (fn, the pyramid, no params)."""
    from vst_tpu_torch.ops.features import feature_down_sample

    g = np.random.default_rng(seed)
    pyramid = [torch.from_numpy(g.standard_normal((1, 40 >> i, 24 >> i, 3))
                                * 2.0).to(dtype) for i in range(5)]
    return (lambda x, s: feature_down_sample(x, 4, spatial=s), pyramid, [])


def uneven_cases(world, dtype=torch.float32, losses=False):
    """name → (fn, inputs trimmed to their kept rows, params, the level-0
    row layout over ``world`` ranks): every layer kind of
    ``spatial_layer_cases`` (``UNEVEN_LAYERS``), at 2 ranks the partial
    pyramid, and with ``losses`` every loss share of
    ``spatial_loss_cases`` (in 1-row units, float64).  An input of H_k
    rows of a case whose largest input has H_0 takes the layout's bounds
    divided by H_0/H_k."""
    from vst_tpu_torch.parallel.spatial import row_layout

    out = {}
    for name, (fn, x, params) in spatial_layer_cases(dtype=dtype).items():
        rows, unit = UNEVEN_LAYERS[name]
        xs = [t[:, :rows] for t in x] if isinstance(x, list) else x[:, :rows]
        out[name] = (fn, xs, params, row_layout(rows, world, unit))
    if world == 2:
        fn, x, params = partial_pyramid_case(dtype)
        out["feature_down_sample_partial"] = (fn, x, params,
                                              row_layout(40, 2, 16))
    if losses:
        for name, (fn, x, idx) in spatial_loss_cases().items():
            h0 = max(t.shape[1] for t in x)
            unit = h0 // min(t.shape[1] for t in x)
            out[name] = (fn, x, idx, row_layout(h0, world, unit))
    return out


def block_of(x, bounds, index):
    """Rank ``index``'s rows of x (a tensor or a list) under the level-0
    ``bounds``, each input's scaled to its own rows."""
    xs = x if isinstance(x, list) else [x]
    h0 = max(t.shape[1] for t in xs)
    s, e = bounds[index]
    own = []
    for t in xs:
        k = h0 // t.shape[1]
        own.append(t[:, s // k:min(e // k, t.shape[1])])
    return own if isinstance(x, list) else own[0]


def _uneven_cotangent(name, ctx):
    """``cotangent(y)``: this rank's rows of ``spatial_cotangent`` at the
    whole output's shape, the blocks' rows gathered (``level_rows``)."""
    from vst_tpu_torch.parallel.spatial import level_rows

    def cot(y):
        sizes = [r for r, in level_rows(ctx, y.shape[1])]
        start = sum(sizes[:ctx.index])
        whole = spatial_cotangent(name, (y.shape[0], sum(sizes),
                                         *y.shape[2:]))
        return whole[:, start:start + y.shape[1]].to(y.dtype)

    return cot


def similarity_case(seed=6):
    """AdaAttN's image-similarity loss in bfloat16 on a frame whose H·W
    (42·26 = 1092) bfloat16 cannot hold (it rounds to 1088): the four
    (2, 42, 26, 4) feature maps, and their row layout over 3 ranks in
    4-row units (16, 12 and 14 rows)."""
    from vst_tpu_torch.parallel.spatial import row_layout

    g = np.random.default_rng(seed)
    feats = [torch.from_numpy(g.standard_normal((2, 42, 26, 4))).to(
        torch.bfloat16) for _ in range(4)]
    return feats, row_layout(42, 3, 4)


def _similarity(feats, spatial):
    from vst_tpu_torch.losses import image_similarity_loss

    return image_similarity_loss(*feats, spatial=spatial)


# relayout cases: world → [(frame rows, source layout, target layout)]:
# the placement to a step's row layout, and layouts whose rows cross two
# ranks (rank 0 takes rows from ranks 1 and 2; the last rank from rank 0)
RELAYOUTS = {
    3: [(18, ((0, 6), (6, 12), (12, 18)), ((0, 2), (2, 4), (4, 18))),
        (18, ((0, 6), (6, 12), (12, 18)), ((0, 14), (14, 16), (16, 18)))],
    4: [(40, ((0, 10), (10, 20), (20, 30), (30, 40)),
         ((0, 16), (16, 24), (24, 32), (32, 40))),
        (48, ((0, 12), (12, 24), (24, 36), (36, 48)),
         ((0, 30), (30, 34), (34, 40), (40, 48)))],
}
# gather cases: world → every rank's rows
GATHERS = {3: (5, 2, 4), 4: (3, 1, 2, 6)}


def uneven_layers(rank, world):
    """On a "space" axis over uneven blocks: "fwd": each layer kind's
    float32 output rows; "grad": each layer kind's and loss share's
    float64 (output, inputs' gradients, parameters' gradients)
    (``spatial_grad``); "relayout": per ``RELAYOUTS`` case, (the moved
    rows, ⟨relayout(x), g⟩, ⟨x, relayoutᵀ(g)⟩); "gather": the gathered
    frame of ``GATHERS`` and the gradient its reduce-scatter gives this
    rank's rows under a cotangent seeded by rank; "similarity": at 3
    ranks, this rank's share of ``similarity_case``'s bfloat16 loss."""
    from vst_tpu_torch.parallel import make_mesh
    from vst_tpu_torch.parallel.spatial import (SpatialContext, gather_rows,
                                                relayout_rows)

    mesh = make_mesh(None, ("space",))
    loss_names = set(spatial_loss_cases())
    fwd, grad = {}, {}
    with torch.no_grad():
        for name, (fn, x, _, bounds) in uneven_cases(world).items():
            ctx = SpatialContext(mesh, bounds=bounds)
            fwd[name] = _np(fn(block_of(x, bounds, rank), ctx))
    for name, (fn, x, extra, bounds) in uneven_cases(
            world, torch.float64, losses=True).items():
        ctx = SpatialContext(mesh, bounds=bounds)
        if name in loss_names:
            grad[name] = spatial_grad(fn, block_of(x, bounds, rank), [],
                                      extra, ctx, torch.ones_like)
        else:
            grad[name] = spatial_grad(fn, block_of(x, bounds, rank), extra,
                                      None, ctx, _uneven_cotangent(name, ctx))
    relayout = []
    for i, (h, src, dst) in enumerate(RELAYOUTS.get(world, [])):
        ctx = SpatialContext(mesh, bounds=dst)
        whole = torch.from_numpy(np.random.default_rng(i).standard_normal(
            (2, h, 3, 2)))
        x = whole[:, src[rank][0]:src[rank][1]].clone().requires_grad_()
        y = relayout_rows(ctx, x, src, dst)
        g = torch.from_numpy(np.random.default_rng((i, rank))
                             .standard_normal(tuple(y.shape)))
        (gx,) = torch.autograd.grad(y, x, g)
        relayout.append((_np(y), float((y * g).sum()), float((x * gx).sum())))
    similarity = None
    if world == 3:
        feats, bounds = similarity_case()
        ctx = SpatialContext(mesh, bounds=bounds)
        similarity = float(_similarity(block_of(feats, bounds, rank), ctx))
    gather = None
    if world in GATHERS:
        sizes = GATHERS[world]
        start = sum(sizes[:rank])
        whole = torch.arange(2 * sum(sizes) * 3, dtype=torch.float64
                             ).reshape(2, sum(sizes), 3)
        x = whole[:, start:start + sizes[rank]].clone().requires_grad_()
        y = gather_rows(SpatialContext(mesh), x, sizes)
        g = torch.from_numpy(np.random.default_rng(rank).standard_normal(
            tuple(y.shape)))
        (gx,) = torch.autograd.grad(y, x, g)
        gather = (_np(y), _np(gx))
    return {"fwd": fwd, "grad": grad, "relayout": relayout,
            "gather": gather, "similarity": similarity}


def uneven_stylize(rank, world, frames):
    """``stylize_spatial_sharded`` of each seeded family, for each frame
    of ``frames`` (H a multiple of D that 4·D does not divide): this
    rank's rows; and the ReCoNet frame assembled by ``gather_rows`` from
    the blocks of JAX's placement of the output's rows."""
    from vst_tpu_torch.infer.image import stylize_spatial_sharded
    from vst_tpu_torch.parallel import gather_rows, make_mesh
    from vst_tpu_torch.parallel.spatial import SpatialContext, placement

    mesh = make_mesh(None, ("space",))
    results = []
    for x in frames:
        out = {f: stylize_spatial_sharded(spatial_model(f), x, mesh)
               for f in SPATIAL_FAMILIES}
        h_out = -(-x.shape[1] // 4) * 4
        sizes = [e - s for s, e in placement(h_out, world)]
        gathered = _np(gather_rows(SpatialContext(mesh), out["reconet"],
                                   sizes))
        results.append(({f: _np(y) for f, y in out.items()}, gathered))
    return results


@contextlib.contextmanager
def layout_collectives():
    """Count, into the dict it yields, the collectives that an uneven row
    layout adds: "level_rows" (an all-gather of the blocks' rows, read on
    the host), "frame_count" (an all-reduce of a count) and
    "relayout_rows" (one ``batch_isend_irecv``).  On an even layout the
    first two issue none and are not counted."""
    from vst_tpu_torch.parallel import spatial as sp

    counts = {"level_rows": 0, "frame_count": 0, "relayout_rows": 0}
    inner = {k: getattr(sp, k) for k in ("level_rows", "frame_count",
                                         "_relayout")}

    def level_rows(ctx, *rows):
        counts["level_rows"] += not ctx.even
        return inner["level_rows"](ctx, *rows)

    def frame_count(ctx, count, like):
        counts["frame_count"] += not ctx.even
        return inner["frame_count"](ctx, count, like)

    def relayout(*args):
        counts["relayout_rows"] += 1
        return inner["_relayout"](*args)

    sp.level_rows, sp.frame_count, sp._relayout = (level_rows, frame_count,
                                                   relayout)
    try:
        yield counts
    finally:
        sp.level_rows = inner["level_rows"]
        sp.frame_count = inner["frame_count"]
        sp._relayout = inner["_relayout"]


def uneven_train_steps(rank, world, cases):
    """``spatial_train_steps`` of each case, with the collectives its
    row layout adds counted (``layout_collectives``): (result, counts)."""
    out = []
    for case in cases:
        with layout_collectives() as counts:
            (result,) = spatial_train_steps(rank, world, [case])
        out.append((result, dict(counts)))
    return out


def relayout_calls(rank, world, h_even, h_uneven):
    """The collectives the row layout adds (``layout_collectives``) while
    ``stylize_spatial_sharded`` serves a frame of ``h_even`` rows (4·D
    divides it) and a step's ``_place`` lays out a flow batch of
    ``h_even`` rows in 8-row units (8·D divides it), then the same of
    ``h_uneven`` rows; whether ``_place`` handed back the placed tensors
    themselves; and the step's layout."""
    from vst_tpu_torch.infer.image import stylize_spatial_sharded
    from vst_tpu_torch.parallel import make_mesh, shard_batch_spatial
    from vst_tpu_torch.parallel import spatial as sp
    from vst_tpu_torch.train import steps as pst

    mesh = make_mesh(None, ("space",))
    out = []
    for h in (h_even, h_uneven):
        g = np.random.default_rng(h)
        frame = (g.random((1, h, 16, 3)) * 255).astype(np.float32)
        with layout_collectives() as counts:
            stylize_spatial_sharded(spatial_model("reconet"), frame, mesh)
            batch = shard_batch_spatial(mesh, [
                frame, frame, g.standard_normal((1, h, 16, 2)),
                np.ones((1, h, 16), np.float32)])
            ctx = sp.SpatialContext(mesh)
            placed = pst._place(ctx, batch, 8, "relayout_calls", 4)
        out.append((dict(counts),
                    all(a is b for a, b in zip(placed, batch)), ctx.bounds))
    return out
