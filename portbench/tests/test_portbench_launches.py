"""The port's launch counters, read over the window."""

from portbench.core import launches


def test_every_counter_names_a_wrapper_that_counts():
    names = launches.counters()
    assert {"K1", "K2", "K3", "K4", "K5"} <= set(names)
    for target in names.values():
        assert isinstance(launches._wrapper(target).launches, int)


def test_reset_and_read():
    from vst_tpu_torch.kernels import head_conv

    head_conv.conv3x3_valid.launches = 7
    launches.reset()
    assert set(launches.read().values()) == {0}
    head_conv.conv3x3_valid.launches += 4
    assert launches.read()["K2"] == 4
    launches.reset()


def test_launches_per_unit_line():
    line = launches.per_unit({"K1": 100, "K2": 20}, 10, "frame")
    assert line == "launches per frame (10 in the window): K1 10, K2 2"
    assert launches.per_unit({}, 0, "step") == "launches per step: none read"
