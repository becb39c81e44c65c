"""One step of the port's ReCoNet distillation builder, the SD1 stage (its
SD loss NaN, as the reference's mismatched taps give) and the SD2 stage,
with the SD term left out of the total and put in, against the JAX
package's jitted steps in float32 and float64 at a small size."""

import numpy as np
import pytest
import torch

from tests.test_torch_reconet_steps import (_assert_metrics, _batches,
                                            _configs, _jax_run, _port_run,
                                            check_step_metrics,
                                            check_step_params, one_step_runs)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads: the suite runs six workers on the machine's
    cores, and torch's default of one thread per core oversubscribes them
    (these steps then ran 50× slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["sd1", "sd2"])
def one_step(request):
    return one_step_runs(request.param)


def test_step_metrics_match_jax(one_step):
    check_step_metrics(one_step)


def test_step_params_match_jax(one_step):
    check_step_params(one_step)


def test_distill_sd_term_in_total():
    """include_sd_in_total adds the SD loss to the total, as JAX does."""
    jcfg, pcfg = _configs("sd2", include_sd_in_total=True)
    batches = _batches("sd2", 1)
    jm, _ = _jax_run("sd2", jcfg, batches)
    pm, *_ = _port_run("sd2", pcfg, batches)
    _assert_metrics(pm[0], jm[0])
    parts = sum(pm[0][k] for k in ("FTL", "OTL", "CL", "SL", "RL", "SDL"))
    np.testing.assert_allclose(pm[0]["loss"], parts, rtol=1e-5)
