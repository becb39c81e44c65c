"""The port's entry points for ``rtnstv``: ``models/rtnstv.py::build`` and
``infer/image.py::stylize_rtnstv``; the plain side from
``reference/rtnstv.py``."""


def serve_model(cfg, weights, device, dtype):
    from vst_tpu_torch.models import rtnstv as m

    return m.build(weights, device, dtype)


def stream_batch(model, batch, wire):
    """One batch of the stream's frames to its styled uint8 frames, as
    ``cli/infer_video.py --model rtnstv`` calls it."""
    from vst_tpu_torch.infer.image import stylize_rtnstv

    return stylize_rtnstv(model, batch, uint8_out=True, wire=wire)
