"""Streaming video stylization.

Counterpart of ``vst_tpu/infer/video.py`` (parity: the ReCoNet
``Inference`` iterator, ReCoNet/utilities.py:179-236 — a sliding window of
``input_frame_num`` channel-concatenated frames, clamp, uint8 out).

Frames are batched, host decode runs in a reader thread behind a bounded
queue, and up to ``pipeline_depth`` batches are in flight on the card:
each batch goes up from a pinned host buffer and comes back into one,
both copies without blocking, and a CUDA event per batch says when its
result is on the host.  This takes the place of JAX's async dispatch.
"""

import collections
from queue import Queue
from threading import Thread

import numpy as np
import torch

from vst_tpu_torch.device import resolve_device


def frames_from_video(path, resize_wh=None, interpolation="linear",
                      dtype="float32"):
    """Yield HWC RGB frames from a video file (requires cv2).

    interpolation: "linear" (ReCoNet/utilities.py:119-123) or "area".
    dtype: "float32" or "uint8" (decoder-native bytes; the stylizer casts
    on the device)."""
    import cv2

    interp = {"linear": cv2.INTER_LINEAR, "area": cv2.INTER_AREA}[interpolation]
    cap = cv2.VideoCapture(path)
    try:
        while True:
            ret, frame = cap.read()
            if not ret:
                return
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if resize_wh is not None and frame.shape[1::-1] != tuple(resize_wh):
                frame = cv2.resize(frame, tuple(resize_wh), interpolation=interp)
            yield frame if dtype == "uint8" else frame.astype(np.float32)
    finally:
        cap.release()


def video_fps(path) -> float:
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return fps


def _reader(frames, queue):
    for f in frames:
        queue.put(f)
    queue.put(None)


class StreamingStylizer:
    """Batched sliding-window streaming stylizer.

    ``model_fn(batch) -> styled`` maps a (B, H, W, 3·input_frame_num)
    tensor of 0–255 windows (CPU; pinned when ``device`` is CUDA) to
    (B, H, W, 3) frames (e.g. ``stylize_reconet`` with ``uint8_out``), or
    to packed I420 frames when ``wire="i420"``.  It may return a CUDA
    tensor, a CPU tensor or an array.

    ``first_frame``: skip initial frames so output starts at that index
    (ReCoNet/utilities.py:193-201).  ``pipeline_depth``: batches in
    flight before the oldest result is read back.  The tail batch is
    padded to ``batch_size`` so every call sees one shape.
    """

    def __init__(self, model_fn, frames, input_frame_num: int = 1,
                 batch_size: int = 4, first_frame: int | None = None,
                 output: str = "rgb_uint8", pipeline_depth: int = 3,
                 wire: str = "rgb", device="cuda"):
        self.model_fn = model_fn
        self.frames = iter(frames)
        self.input_frame_num = input_frame_num
        self.batch_size = batch_size
        self.output = output
        self.wire = wire
        self.pipeline_depth = max(1, pipeline_depth)
        self.device = resolve_device(device)
        if first_frame is None or first_frame < input_frame_num:
            first_frame = input_frame_num
        self.skip = first_frame - input_frame_num

    def __iter__(self):
        queue = Queue(maxsize=2 * self.batch_size + 4)
        Thread(target=_reader, args=(self.frames, queue), daemon=True).start()

        for _ in range(self.skip):
            if queue.get() is None:
                return

        window = collections.deque(maxlen=self.input_frame_num)
        for _ in range(self.input_frame_num):
            frame = queue.get()
            if frame is None:
                return
            window.append(frame)

        # A batch's pinned buffers are reused pipeline_depth batches later,
        # when its result has been read back.
        slots = [{} for _ in range(self.pipeline_depth)]
        inflight = collections.deque()  # (result, event, n_real) FIFO
        done = False
        k = 0
        while not done:
            batch = [np.concatenate(list(window), axis=-1)]
            while len(batch) < self.batch_size:
                frame = queue.get()
                if frame is None:
                    done = True
                    break
                window.append(frame)
                batch.append(np.concatenate(list(window), axis=-1))
            n_real = len(batch)
            if n_real < self.batch_size:
                batch = batch + [batch[-1]] * (self.batch_size - n_real)
            slot = slots[k % self.pipeline_depth]
            k += 1
            inp = self._host_tensor(slot, "in", np.stack(batch))
            inflight.append(self._dispatch(slot, self.model_fn(inp), n_real))
            while len(inflight) >= self.pipeline_depth:
                yield from self._materialize(inflight.popleft())
            if not done:
                frame = queue.get()
                if frame is None:
                    done = True
                else:
                    window.append(frame)
        while inflight:
            yield from self._materialize(inflight.popleft())

    def _host_tensor(self, slot, key, arr):
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t
        buf = slot.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = slot[key] = torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=True)
        return buf.copy_(t)

    def _dispatch(self, slot, result, n_real):
        if not (isinstance(result, torch.Tensor) and result.is_cuda):
            return result, None, n_real
        buf = slot.get("out")
        if buf is None or buf.shape != result.shape or buf.dtype != result.dtype:
            buf = slot["out"] = torch.empty(result.shape, dtype=result.dtype,
                                            pin_memory=True)
        buf.copy_(result, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return buf, event, n_real

    def _materialize(self, entry):
        result, event, n_real = entry
        if event is not None:
            event.synchronize()
            # the pinned buffer is reused: hand out copies
            frames = result[:n_real].numpy().copy()
        elif isinstance(result, torch.Tensor):
            frames = result[:n_real].cpu().numpy()
        else:
            frames = np.asarray(result)[:n_real]
        for out in frames:
            yield self._convert(out)

    def _convert(self, frame):
        if self.wire == "i420":
            from vst_tpu_torch.ops.yuv import i420_to_rgb

            order = "bgr" if self.output == "bgr_uint8" else "rgb"
            return i420_to_rgb(frame, order)
        if self.output == "rgb_uint8":
            return frame.astype(np.uint8)
        if self.output == "bgr_uint8":
            return frame.astype(np.uint8)[..., ::-1]
        return frame


def write_video(path, frames, fps: float = 30.0):
    """Encode RGB uint8 frames to a video file (imageio when an ffmpeg
    backend is present, else cv2), holding one frame at a time."""
    frames = iter(frames)
    try:
        first = next(frames)
    except StopIteration:
        return
    try:
        import imageio

        writer = imageio.get_writer(path, fps=fps)
    except Exception:  # no imageio, or no ffmpeg backend for it
        writer = None
    if writer is not None:
        with writer:
            writer.append_data(first)
            for f in frames:
                writer.append_data(f)
        return
    import cv2

    h, w = first.shape[:2]
    fourcc = cv2.VideoWriter_fourcc(
        *("mp4v" if path.lower().endswith(".mp4") else "MJPG"))
    vw = cv2.VideoWriter(path, fourcc, fps, (w, h))
    if not vw.isOpened():  # codec fallback
        path = path.rsplit(".", 1)[0] + ".avi"
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"),
                             fps, (w, h))
    if not vw.isOpened():
        raise IOError(f"cannot open a video writer for {path} "
                      "(missing directory or unsupported codec?)")
    vw.write(cv2.cvtColor(first, cv2.COLOR_RGB2BGR))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()


class StreamingVideoWriter:
    """Background-thread encoder behind a bounded queue: frames are encoded
    while later batches are in flight on the card."""

    def __init__(self, path, fps: float = 30.0, queue_size: int = 32):
        self.queue = Queue(maxsize=queue_size)
        self.error = None

        def drain():
            while True:
                item = self.queue.get()
                if item is None:  # sentinel ('is', not '==': numpy frames)
                    return
                yield item

        def run():
            try:
                write_video(path, drain(), fps)
            except Exception as e:  # surfaced on put()/close()
                self.error = e
                while self.queue.get() is not None:  # unblock the producer
                    pass

        self.thread = Thread(target=run, daemon=True)
        self.thread.start()

    def put(self, frame):
        if self.error:
            raise self.error
        self.queue.put(frame)

    def close(self):
        self.queue.put(None)
        self.thread.join()
        if self.error:
            raise self.error

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def frames_from_source(path, resize_wh=None, interpolation="linear",
                       dtype="uint8", batch_size: int = 8,
                       num_threads: int = 8):
    """The native thread-pool MJPG decoder (native/vstvideo.cc) when the
    file is an MJPG AVI and the library is built, else cv2."""
    from vst_tpu_torch.data.video_native import open_video

    native = open_video(path, num_threads) if dtype == "uint8" else None
    if native is not None:
        return _closing_frames(native, batch_size, resize_wh, interpolation)
    return frames_from_video(path, resize_wh, interpolation, dtype)


def _closing_frames(native, *args):
    with native:   # the decoder closes when the stream ends or is dropped
        yield from native.frames(*args)
