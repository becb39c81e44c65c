"""Streaming video stylization.

Counterpart of ``vst_tpu/infer/video.py`` (parity: the ReCoNet
``Inference`` iterator, ReCoNet/utilities.py:179-236 — a sliding window of
``input_frame_num`` channel-concatenated frames, clamp, uint8 out).

Frames are batched, host decode runs in a reader thread behind a bounded
queue, and up to ``pipeline_depth`` batches are in flight on the card:
each batch goes up from a pinned host buffer and comes back into one,
both copies without blocking, and a CUDA event per batch says when its
result is on the host.  This takes the place of JAX's async dispatch.

Data-parallel serving (``ShardedBatches``): rank 0 decodes, scatters each
batch's frames over the mesh's "data" axis, every rank stylizes its
slice, and rank 0 gathers the results in rank order and writes them.
"""

import collections
from queue import Queue
from threading import Thread

import numpy as np
import torch
import torch.distributed as dist

from vst_tpu_torch.device import resolve_device
from vst_tpu_torch.utils.profiling import span


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


def _read(queue):
    """The reader's next frame (None at the end), waited for in the span
    "vst::stream.read_wait"."""
    with span("vst::stream.read_wait"):
        return queue.get()


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

    Spans (``utils/profiling.py::span``), on the consuming thread, none
    open across a ``yield``: "vst::stream.read_wait" (each wait on the
    reader), ".assemble" (windows, tail padding), ".upload" (the windows
    stacked into the pinned buffer, the one host copy in), ".call"
    (``model_fn``), ".download" (the copy back enqueued and its event),
    ".result_wait" (the event) and ".hand_out" (the one host copy out and
    each frame's conversion).
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
            if _read(queue) is None:
                return

        window = collections.deque(maxlen=self.input_frame_num)
        for _ in range(self.input_frame_num):
            frame = _read(queue)
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
            windows = [tuple(window)]
            while len(windows) < self.batch_size:
                frame = _read(queue)
                if frame is None:
                    done = True
                    break
                window.append(frame)
                windows.append(tuple(window))
            n_real = len(windows)
            with span("vst::stream.assemble"):
                windows += [windows[-1]] * (self.batch_size - n_real)
            slot = slots[k % self.pipeline_depth]
            k += 1
            with span("vst::stream.upload"):
                inp = self._host_batch(slot, windows)
            with span("vst::stream.call"):
                result = self.model_fn(inp)
            with span("vst::stream.download"):
                inflight.append(self._dispatch(slot, result, n_real))
            while len(inflight) >= self.pipeline_depth:
                yield from self._materialize(inflight.popleft())
            if not done:
                frame = _read(queue)
                if frame is None:
                    done = True
                else:
                    window.append(frame)
        while inflight:
            yield from self._materialize(inflight.popleft())

    def _host_batch(self, slot, windows):
        """The windows, each one's frames concatenated on the last axis, as
        one (B, H, W, C·frames) tensor: for the card written straight into
        the slot's pinned buffer by numpy on this thread (one host copy, no
        intra-op threads), else into a new array."""
        first = np.asarray(windows[0][0])
        shape = (len(windows), *first.shape[:-1],
                 first.shape[-1] * len(windows[0]))
        if self.device.type != "cuda":
            buf = torch.from_numpy(np.empty(shape, first.dtype))
        else:
            buf = slot.get("in")
            if (buf is None or tuple(buf.shape) != shape
                    or buf.numpy().dtype != first.dtype):
                buf = slot["in"] = torch.from_numpy(
                    np.empty(shape, first.dtype)).pin_memory()
        for row, window in zip(buf.numpy(), windows):
            np.concatenate(window, axis=-1, out=row)
        return buf

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
        """The frames of one batch on the host, each converted in the span
        "vst::stream.hand_out", which is closed while the frame is out."""
        result, event, n_real = entry
        with span("vst::stream.result_wait"):
            if event is not None:
                event.synchronize()
        with span("vst::stream.hand_out"):
            if event is not None:
                # the pinned buffer is reused: hand out copies, made here
                # once, so that the conversion below need not copy again
                frames = result[:n_real].numpy().copy()
            elif isinstance(result, torch.Tensor):
                frames = result[:n_real].cpu().numpy()
            else:
                frames = np.asarray(result)[:n_real]
        for out in frames:
            with span("vst::stream.hand_out"):
                out = self._convert(out, copied=event is not None)
            yield out

    def _convert(self, frame, copied=False):
        """``frame`` in the output's form; ``copied``: it is the stylizer's
        own copy already, so one of the output's type is handed out as it
        is."""
        if self.wire == "i420":
            from vst_tpu_torch.ops.yuv import i420_to_rgb

            order = "bgr" if self.output == "bgr_uint8" else "rgb"
            return i420_to_rgb(frame, order)
        if self.output == "rgb_uint8":
            return frame.astype(np.uint8, copy=not copied)
        if self.output == "bgr_uint8":
            return frame.astype(np.uint8, copy=not copied)[..., ::-1]
        return frame


# dtypes a batch may have on the wire of ShardedBatches' header: decoded
# frames, or float 0-255 ones
_WIRE_DTYPES = (torch.uint8, torch.float32)
_HEADER = 8   # [more batches?, dtype code, ndim, dims...]


class ShardedBatches:
    """``fn`` over batches split along dim 0 across the "data" axis of
    ``mesh``.

    The axis's first rank (the root) calls the object on each whole batch:
    it broadcasts the batch's shape and dtype, scatters one contiguous
    slice to each rank, runs ``fn`` on its own slice and gathers the
    results, in rank order, into the whole batch's result.  The other
    ranks run ``serve()``, which answers the root's batches until it
    calls ``close()``.  ``stream`` is the same on every rank: the root
    iterates a stream of batches through the object, the others serve."""

    def __init__(self, mesh, fn):
        self.mesh, self.fn = mesh, fn
        self.n = mesh.shape["data"]
        self.group = mesh.groups["data"]
        self.root = mesh.ranks["data"][0]
        self.is_root = mesh.index["data"] == 0

    def _header(self, values):
        h = torch.zeros(_HEADER, dtype=torch.int64, device=self.mesh.device)
        h[:len(values)] = torch.tensor(values, dtype=torch.int64)
        dist.broadcast(h, src=self.root, group=self.group)
        return h

    def _run(self, local):
        return torch.as_tensor(self.fn(local)).to(self.mesh.device).contiguous()

    def __call__(self, batch):
        batch = torch.as_tensor(batch)
        if batch.shape[0] % self.n:
            raise ValueError(f"batch of {batch.shape[0]} must be divisible "
                             f"by the {self.n}-device mesh")
        self._header([1, _WIRE_DTYPES.index(batch.dtype), batch.dim(),
                      *batch.shape])
        parts = list(batch.to(self.mesh.device).chunk(self.n))
        local = torch.empty_like(parts[0])
        dist.scatter(local, [p.contiguous() for p in parts], src=self.root,
                     group=self.group)
        out = self._run(local)
        gathered = [torch.empty_like(out) for _ in range(self.n)]
        dist.gather(out, gathered, dst=self.root, group=self.group)
        return torch.cat(gathered)

    def serve(self):
        while True:
            h = self._header([]).tolist()
            if not h[0]:
                return
            shape = h[3:3 + h[2]]
            local = torch.empty((shape[0] // self.n, *shape[1:]),
                                dtype=_WIRE_DTYPES[h[1]],
                                device=self.mesh.device)
            dist.scatter(local, None, src=self.root, group=self.group)
            dist.gather(self._run(local), None, dst=self.root,
                        group=self.group)

    def close(self):
        self._header([0])

    def stream(self, make):
        """Root: yield from ``make(self)`` (an iterable whose batches go
        through this object), then ``close``; other ranks: ``serve`` and
        yield nothing."""
        if not self.is_root:
            self.serve()
            return
        try:
            yield from make(self)
        finally:
            self.close()


class AdaAttNVideoStylizer:
    """Arbitrary-style streaming stylizer (AdaAttN/infer_video.py:40-64):
    the style is encoded once into its attention state
    (``adaattn_style_state``), then every content batch is encoded and
    stylized against it.

    Frames (HWC RGB, uint8 or float 0–255) go through ``StreamingStylizer``:
    pinned host buffers, up to ``pipeline_depth`` batches in flight, the
    tail padded to ``batch_size``, and uint8 RGB or packed I420
    (``wire="i420"``) on the way back.  The card is the models' device.

    ``mesh``: data-parallel serving over its "data" axis
    (``ShardedBatches``): every rank builds the stylizer and calls
    ``stylize_frames``; rank 0's frames are decoded there and its iterator
    yields every styled frame, the other ranks' yield none.
    ``batch_size`` must divide by the axis size."""

    def __init__(self, vgg, model, style_255, activation="cosine",
                 batch_size: int = 2, pipeline_depth: int = 3,
                 wire: str = "rgb", mesh=None):
        from vst_tpu_torch.infer.image import (adaattn_style_state,
                                               stylize_adaattn_cached)
        from vst_tpu_torch.ops.yuv import rgb_to_i420

        if mesh is not None and batch_size % mesh.shape["data"]:
            raise ValueError(
                f"batch_size {batch_size} must be divisible by the "
                f"{mesh.shape['data']}-device mesh")
        if wire not in ("rgb", "i420"):
            raise ValueError(f"wire must be 'rgb' or 'i420', got {wire!r}")
        self.batch_size = batch_size
        self.pipeline_depth = max(1, pipeline_depth)
        self.wire = wire
        self.device = next(model.parameters()).device
        state = adaattn_style_state(vgg, model, style_255, activation)

        def run(content):
            cs = stylize_adaattn_cached(vgg, model, content, state, activation)
            return rgb_to_i420(cs) if wire == "i420" else cs.to(torch.uint8)

        self._run = run
        self._sharded = None if mesh is None else ShardedBatches(mesh, run)

    def stylize_frames(self, frames):
        """frames: iterator of HWC RGB uint8/float 0–255 → RGB uint8 (with
        a mesh: on rank 0; the others pass None and get nothing)."""
        def stream(model_fn):
            return StreamingStylizer(
                model_fn, frames, 1, self.batch_size,
                pipeline_depth=self.pipeline_depth, wire=self.wire,
                device=self.device)

        if self._sharded is None:
            return iter(stream(self._run))
        return self._sharded.stream(stream)


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
