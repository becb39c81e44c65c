"""The port's checkpoints (``vst_tpu_torch/train/checkpoint.py``) and the
train state carried across from JAX (``compat.train_state_from_jax``):
``.npz`` parameters read and written by both packages, the full-state
round trip (Adam moments, per-parameter step, ``state.step``), a crash
inside the save, versions, ``.pth`` and the helpers, against the JAX
package's ``vst_tpu/train/checkpoint.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vst_tpu.models import adaattn as ja
from vst_tpu.train import checkpoint as jckpt
from vst_tpu.train.state import create as j_create
from vst_tpu.train.state import make_optimizer
from vst_tpu_torch.compat import params_to_jax, train_state_from_jax
from vst_tpu_torch.models import adaattn as pa
from vst_tpu_torch.train import checkpoint as ckpt
from vst_tpu_torch.train.state import TrainState, create


def _toy_state(seed=0, steps=2):
    """A small conv + linear model after ``steps`` Adam updates."""
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.Flatten(),
                                torch.nn.Linear(4 * 4 * 4, 2))
    state = create(model, 1e-2)
    for _ in range(steps):
        _adam_update(state, torch.randn(2, 3, 6, 6))
    return state


def _adam_update(state, x):
    state.optimizer.zero_grad()
    state.model(x).square().mean().backward()
    state.optimizer.step()
    state.step += 1


def _assert_states_equal(a: TrainState, b: TrainState):
    assert a.step == b.step
    for (ka, pa_), (kb, pb) in zip(a.model.state_dict().items(),
                                   b.model.state_dict().items()):
        assert ka == kb and torch.equal(pa_, pb), ka
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i, st in sa["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], sb["state"][i][key]), (i, key)


def test_npz_written_by_the_port_loads_in_jax(tmp_path):
    path = str(tmp_path / "p.npz")
    ckpt.save_params(pa.init_stylizing_network(1, device="cpu"), path)
    loaded = jckpt.load_params(path)
    ref = ja.init_stylizing_network(1)
    assert set(loaded) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(loaded[k]),
                                      np.asarray(ref[k]), err_msg=k)


def test_npz_written_by_jax_loads_in_the_port(tmp_path):
    path = str(tmp_path / "p.npz")
    jckpt.save_params(ja.init_stylizing_network(2), path)
    loaded = ckpt.load_params(path)
    ref = pa.init_stylizing_network(2, device="cpu").state_dict()
    assert set(loaded) == set(ref)
    for k in ref:
        assert torch.equal(loaded[k], ref[k]), k


def test_state_round_trip_resumes_identically(tmp_path):
    """The saved state carries the Adam moments, the per-parameter step
    and ``state.step``: one more update on the original and on the loaded
    copy gives the same bits."""
    state = _toy_state()
    path = str(tmp_path / "last_state")
    ckpt.save_state(state, path)
    loaded = ckpt.load_state(path, like=_toy_state(seed=1, steps=0))
    _assert_states_equal(state, loaded)
    assert loaded.step == 2
    x = torch.randn(2, 3, 6, 6)
    _adam_update(state, x)
    _adam_update(loaded, x)
    _assert_states_equal(state, loaded)
    # periodic saves overwrite the same path
    ckpt.save_state(state, path)
    assert ckpt.load_state(path, like=_toy_state(steps=0)).step == 3


def test_crash_inside_save_keeps_the_previous_state(tmp_path, monkeypatch):
    state = _toy_state()
    path = str(tmp_path / "last_state")
    ckpt.save_state(state, path)
    _adam_update(state, torch.randn(2, 3, 6, 6))

    def dying_save(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", dying_save)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_state(state, path)
    monkeypatch.undo()
    assert ckpt.load_state(path, like=_toy_state(steps=0)).step == 2


@pytest.mark.parametrize("version", [ckpt.STATE_VERSION + 1, None])
def test_future_or_missing_version_rejected(tmp_path, version):
    state = _toy_state()
    payload = ckpt.snapshot(state)
    if version is not None:
        payload["__vst_state_version__"] = version
    path = str(tmp_path / "state")
    torch.save(payload, path)
    with pytest.raises(ValueError, match="state version"):
        ckpt.load_state(path, like=_toy_state(steps=0))


def test_snapshot_restore_is_a_copy():
    """A snapshot is a host copy: updates after it do not reach it, and a
    restore gives the live state copies, so restoring twice restores the
    same state (torch's load_state_dict keeps the step tensors it is given
    when they are on the parameters' device already)."""
    state = _toy_state()
    snap = ckpt.snapshot(state)
    ref = _toy_state()
    for _ in range(2):
        _adam_update(state, torch.randn(2, 3, 6, 6))
        ckpt.restore(state, snap)
        state.step = 2
        _assert_states_equal(state, ref)


def test_pth_round_trip_and_strict_import(tmp_path):
    state = pa.init_stylizing_network(1, device="cpu").state_dict()
    path = str(tmp_path / "m.pth")
    ckpt.export_pth(state, path)
    back = ckpt.import_pth(path, strict_keys=set(state))
    for k in state:
        assert torch.equal(back[k], state[k])
    with pytest.raises(ValueError, match="strict load failed"):
        ckpt.import_pth(path, strict_keys=set(state) | {"extra.weight"})
    with pytest.raises(ValueError, match="strict load failed"):
        ckpt.import_pth(path, strict_keys=set(list(state)[1:]))
    assert set(ckpt.import_pth(path)) == set(state)


def test_partial_init_from():
    """Name- and shape-matching entries are copied, the rest kept: as
    JAX's, on torch tensors."""
    params = {"a": torch.zeros(2, 3), "b": torch.zeros(4), "c": torch.ones(1)}
    donor = {"a": torch.full((2, 3), 5.0), "b": torch.full((5,), 5.0),
             "d": torch.full((1,), 5.0)}
    merged = ckpt.partial_init_from(params, donor)
    assert set(merged) == set(params)
    assert torch.equal(merged["a"], donor["a"])
    assert torch.equal(merged["b"], params["b"])
    assert torch.equal(merged["c"], params["c"])
    jmerged = jckpt.partial_init_from(
        {k: jnp.asarray(v.numpy()) for k, v in params.items()},
        {k: jnp.asarray(v.numpy()) for k, v in donor.items()})
    for k in merged:
        np.testing.assert_array_equal(np.asarray(jmerged[k]),
                                      merged[k].numpy())


@pytest.mark.parametrize("args", [("adaattn-image", 1, 8),
                                  ("reconet-candy", 12, 2)])
def test_epoch_checkpoint_name_equals_jax(args):
    assert ckpt.epoch_checkpoint_name(*args) == \
        jckpt.epoch_checkpoint_name(*args)


def test_train_state_from_jax_continues_as_jax():
    """A JAX AdaAttN state after two Adam updates, carried across: the
    parameters and moments equal JAX's, and one more update with the same
    gradient lands where optax's does (bias correction reads the
    per-parameter step, which the carried state holds as 2)."""
    lr = 1e-2
    opt = make_optimizer(lr)
    params = ja.init_stylizing_network(3)
    rng = np.random.default_rng(0)
    grads = [{k: rng.standard_normal(np.shape(v)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jstate = j_create(params, opt)
    for g in grads[:2]:
        updates, opt_state = opt.update(g, jstate.opt_state, jstate.params)
        jstate = jstate._replace(
            params=optax.apply_updates(jstate.params, updates),
            opt_state=opt_state, step=jstate.step + 1)
    adam = jstate.opt_state[0]
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    state = train_state_from_jax(to_np(jstate.params), to_np(adam.mu),
                                 to_np(adam.nu), np.asarray(adam.count), lr,
                                 device="cpu")
    assert state.step == 2
    ours = params_to_jax(state.model.state_dict())
    for k, v in jstate.params.items():
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)
    named = dict(state.model.named_parameters())
    st = state.optimizer.state[named["adaattn.0.f.weight"]]
    assert float(st["step"]) == 2.0
    np.testing.assert_array_equal(
        st["exp_avg"].numpy().transpose(2, 3, 1, 0),
        np.asarray(adam.mu["adaattn.0.f.weight"]))

    updates, _ = opt.update(grads[2], jstate.opt_state, jstate.params)
    jnext = optax.apply_updates(jstate.params, updates)
    from vst_tpu_torch.compat import params_from_jax

    g_t = params_from_jax(grads[2])
    for name, p in named.items():
        p.grad = g_t[name].clone()
    state.optimizer.step()
    ours = params_to_jax(state.model.state_dict())
    for k, v in jnext.items():
        np.testing.assert_allclose(ours[k], np.asarray(v), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
