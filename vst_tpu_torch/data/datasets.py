"""ReCoNet, RTNSTV and AdaAttN datasets: plain-Python indexers returning
HWC float32 0–255 numpy arrays, and the offline preprocessing that makes
RTNSTV's.  Counterpart of ``vst_tpu/data/datasets.py``, sample for sample
(and file for file) the same bits:

- ``Coco2014``      — ReCoNet/datasets.py:16-39
- ``FlyingThings3D`` — ReCoNet/datasets.py:42-146 (A/B/C shards)
- ``Monkaa``        — ReCoNet/datasets.py:149-253 (scene folders)
- ``SceneFlowCombined`` — ReCoNet/datasets.py:256-283 (Monkaa first)
- ``VidevoFlow``    — RTNSTV/datasets.py:162-215 (frame pairs with
  precomputed flow)
- ``VidevoFrames``  — AdaAttN/datasets.py:136-170 (frame pairs, no flow)
- ``ImageFolderCrop`` — AdaAttN's resize → random crop (utilities.py:31-43)
- ``CocoWikiArt`` / ``VidevoWikiArt`` — AdaAttN/datasets.py:32-44, 173-185

Images load through PIL with a BILINEAR (antialiased) resize, imported
where an image is loaded: a machine without PIL can import this module.
A SceneFlow or VidevoFlow sample is (img1, img2, backward flow, mask),
the flows read by ``data/native.py``.  ``get_frames`` and
``calculate_optical_flow`` (RTNSTV/datasets.py:16-85) write what
VidevoFlow reads; they need cv2, imported where they run.
"""

import os

import numpy as np

from vst_tpu_torch.data import native
from vst_tpu_torch.data.flow_np import flow_warp_mask_np, resize_bilinear_np


def list_files(directory):
    return sorted(f.path for f in os.scandir(directory) if f.is_file())


def list_folders(directory):
    return sorted(f.path for f in os.scandir(directory) if f.is_dir())


def load_image(path, size_wh=None, mode="RGB"):
    """PIL load (+ optional BILINEAR resize, size (W, H)) → HWC float32."""
    from PIL import Image

    img = Image.open(path).convert(mode)
    if size_wh is not None and img.size != tuple(size_wh):
        img = img.resize(tuple(size_wh), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def _load_flow_file(path):
    """(H, W, 2) float32 from .flo/.pfm (the native reader when built)/.npy
    /.pt (a (2, H, W) tensor)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".pt"):
        import torch

        t = torch.load(path, map_location="cpu", weights_only=True)
        return np.asarray(t).transpose(1, 2, 0).astype(np.float32)
    if path.endswith(".pfm"):
        return native.read_pfm(path)[:, :, 0:2].astype(np.float32)
    return native.read_flo(path).astype(np.float32)


class Coco2014:
    """Single images of ``<path>/train2014`` (ReCoNet/datasets.py:16-39)."""

    def __init__(self, path: str, img_size=(256, 256)):
        self.paths = list_files(os.path.join(path, "train2014"))
        self.img_size = img_size  # (H, W)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        h, w = self.img_size
        return load_image(self.paths[idx], (w, h))


class _SceneFlowBase:
    """The frame window + flow + motion-boundary sample both SceneFlow
    layouts share."""

    img_size: tuple
    frame_num: int
    frame: list
    flow: list
    motion: list

    def __len__(self):
        return len(self.frame)

    def __getitem__(self, idx):
        h, w = self.img_size
        imgs = [load_image(p, (w, h)) for p in self.frame[idx]]
        img1 = np.concatenate(imgs[0:self.frame_num], axis=-1)
        img2 = np.concatenate(imgs[1:self.frame_num + 1], axis=-1)

        fwd = _load_flow_file(self.flow[idx][0])
        bwd = _load_flow_file(self.flow[idx][1])
        oh, ow = fwd.shape[:2]
        fwd = resize_bilinear_np(fwd, (h, w))
        bwd = resize_bilinear_np(bwd, (h, w))
        # the displacement rescale as the reference writes it
        # (ReCoNet/datasets.py:130-134): channel 0 by the H ratio, channel
        # 1 by the W ratio, the same as per-axis at SceneFlow's uniform 2/3
        for f in (fwd, bwd):
            f[..., 0] *= h / oh
            f[..., 1] *= w / ow

        # motion boundaries: nonzero → 0, zero → 1 (datasets.py:137-140),
        # through PIL's BILINEAR resize, /255 (torchvision's toTensor)
        motion = load_image(self.motion[idx], (w, h), mode=None) / 255.0
        motion = (motion[..., 0] == 0).astype(np.float32)

        mask = flow_warp_mask_np(fwd, bwd) * motion
        return img1, img2, bwd, mask


def _index_windows(files, frame_num):
    return [files[i:i + frame_num + 1] for i in range(len(files) - frame_num)]


class FlyingThings3D(_SceneFlowBase):
    """The A/B/C shard layout (ReCoNet/datasets.py:42-146)."""

    def __init__(self, path, img_size=(360, 640), frame_num=1):
        if not 1 <= frame_num <= 9:
            raise ValueError(f"frame_num must be in [1, 9], got {frame_num}")
        self.img_size = img_size
        self.frame_num = frame_num
        self.frame, self.flow, self.motion = [], [], []
        fdir = os.path.join(path, "frames_finalpass/TRAIN")
        odir = os.path.join(path, "optical_flow/TRAIN")
        mdir = os.path.join(path, "motion_boundaries/TRAIN")
        for shard in ("A", "B", "C"):
            for folder in sorted(os.listdir(os.path.join(fdir, shard))):
                files = list_files(os.path.join(fdir, shard, folder, "left"))
                self.frame += _index_windows(files, frame_num)
            for folder in sorted(os.listdir(os.path.join(odir, shard))):
                fut = list_files(os.path.join(odir, shard, folder,
                                              "into_future", "left"))
                pst = list_files(os.path.join(odir, shard, folder,
                                              "into_past", "left"))
                for i in range(len(fut) - frame_num):
                    self.flow.append((fut[i + frame_num - 1],
                                      pst[i + frame_num]))
            for folder in sorted(os.listdir(os.path.join(mdir, shard))):
                files = list_files(os.path.join(mdir, shard, folder,
                                                "into_future", "left"))
                for i in range(len(files) - frame_num):
                    self.motion.append(files[i + frame_num])


class Monkaa(_SceneFlowBase):
    """The scene-folder layout (ReCoNet/datasets.py:149-253)."""

    def __init__(self, path, img_size=(360, 640), frame_num=1):
        if not 1 <= frame_num <= 9:
            raise ValueError(f"frame_num must be in [1, 9], got {frame_num}")
        self.img_size = img_size
        self.frame_num = frame_num
        self.frame, self.flow, self.motion = [], [], []
        fdir = os.path.join(path, "frames_finalpass")
        odir = os.path.join(path, "optical_flow")
        mdir = os.path.join(path, "motion_boundaries")
        for folder in sorted(os.listdir(fdir)):
            files = list_files(os.path.join(fdir, folder, "left"))
            self.frame += _index_windows(files, frame_num)
        for folder in sorted(os.listdir(odir)):
            fut = list_files(os.path.join(odir, folder, "into_future", "left"))
            pst = list_files(os.path.join(odir, folder, "into_past", "left"))
            for i in range(len(fut) - frame_num):
                self.flow.append((fut[i + frame_num - 1], pst[i + frame_num]))
        for folder in sorted(os.listdir(mdir)):
            files = list_files(os.path.join(mdir, folder, "into_future",
                                            "left"))
            for i in range(len(files) - frame_num):
                self.motion.append(files[i + frame_num])


class SceneFlowCombined:
    """Monkaa ++ FlyingThings3D (ReCoNet/datasets.py:256-283): ``path`` is
    a root holding ``monkaa`` and ``flyingthings3d``, or the pair of their
    paths."""

    def __init__(self, path, img_size=(360, 640), frame_num=1):
        if isinstance(path, (list, tuple)):
            monkaa_path, ft3d_path = path
        else:
            monkaa_path = os.path.join(path, "monkaa")
            ft3d_path = os.path.join(path, "flyingthings3d")
        self.monkaa = Monkaa(monkaa_path, img_size, frame_num)
        self.ft3d = FlyingThings3D(ft3d_path, img_size, frame_num)

    def __len__(self):
        return len(self.monkaa) + len(self.ft3d)

    def __getitem__(self, idx):
        if idx < len(self.monkaa):
            return self.monkaa[idx]
        return self.ft3d[idx - len(self.monkaa)]


class VidevoFlow:
    """Frame windows + precomputed forward/backward flow
    (RTNSTV/datasets.py:162-215): ``<path>/frames/<video>/*`` and
    ``<path>/flow/<video>/{front,back}/*``, as ``get_frames`` and
    ``calculate_optical_flow`` write them.  Frames load at their own
    size; the mask is the forward-backward consistency of the pair."""

    def __init__(self, path, frame_num=1):
        self.frame_num = frame_num
        self.frames, self.flow = [], []
        for folder in list_folders(os.path.join(path, "frames")):
            files = list_files(folder)
            self.frames += [files[i:i + frame_num + 1]
                            for i in range(len(files) - frame_num)]
        for folder in list_folders(os.path.join(path, "flow")):
            front = list_files(os.path.join(folder, "front"))
            back = list_files(os.path.join(folder, "back"))
            for i in range(len(front) - frame_num + 1):
                self.flow.append((front[i + frame_num - 1],
                                  back[i + frame_num - 1]))

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        imgs = [load_image(p) for p in self.frames[idx]]
        img1 = np.concatenate(imgs[0:self.frame_num], axis=-1)
        img2 = np.concatenate(imgs[1:self.frame_num + 1], axis=-1)
        fwd = _load_flow_file(self.flow[idx][0])
        bwd = _load_flow_file(self.flow[idx][1])
        return img1, img2, bwd, flow_warp_mask_np(fwd, bwd)


class VidevoFrames:
    """Adjacent-frame windows, no flow (AdaAttN/datasets.py:136-170)."""

    def __init__(self, path, frame_num=1):
        self.frame_num = frame_num
        self.frames = []
        for folder in list_folders(os.path.join(path, "frames")):
            files = list_files(folder)
            self.frames += [files[i:i + frame_num + 1]
                            for i in range(len(files) - frame_num)]

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        imgs = [load_image(p) for p in self.frames[idx]]
        img1 = np.concatenate(imgs[0:self.frame_num], axis=-1)
        img2 = np.concatenate(imgs[1:self.frame_num + 1], axis=-1)
        return img1, img2


class ImageFolderCrop:
    """Recursive image folder with resize → random crop (AdaAttN
    ``toTensorCrop``: Resize((512, 512)) then RandomCrop).

    size_resize / size_crop: (H, W).
    """

    def __init__(self, path, size_resize=(512, 512), size_crop=(256, 256),
                 seed=0):
        self.paths = []
        for root, _, files in sorted(os.walk(path)):
            for f in sorted(files):
                if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                    self.paths.append(os.path.join(root, f))
        self.size_resize = size_resize
        self.size_crop = size_crop
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """Vary per-item randomness across epochs (called by BatchLoader)."""
        self._epoch = epoch

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        # a generator per item: thread-safe under BatchLoader's worker pool
        # and the same for any num_workers (a shared numpy Generator is
        # neither)
        rng = np.random.default_rng((self.seed, self._epoch, idx))
        rh, rw = self.size_resize
        ch, cw = self.size_crop
        img = load_image(self.paths[idx], (rw, rh))
        top = int(rng.integers(0, rh - ch + 1))
        left = int(rng.integers(0, rw - cw + 1))
        return img[top:top + ch, left:left + cw]


class CocoWikiArt:
    """COCO content paired with a random WikiArt style per access
    (AdaAttN/datasets.py:32-44)."""

    def __init__(self, coco_path, wikiart_path, size_crop=(256, 256), seed=0):
        self.coco = ImageFolderCrop(coco_path, size_crop=size_crop, seed=seed)
        self.wikiart = ImageFolderCrop(wikiart_path, size_crop=size_crop,
                                       seed=seed + 1)
        self.seed = seed + 2
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        self.coco.set_epoch(epoch)
        self.wikiart.set_epoch(epoch)

    def __len__(self):
        return len(self.coco)

    def __getitem__(self, idx):
        rng = np.random.default_rng((self.seed, self._epoch, idx))
        widx = int(rng.integers(0, len(self.wikiart)))
        return self.coco[idx], self.wikiart[widx]


class VidevoWikiArt:
    """Consecutive Videvo frame pair + a random WikiArt style crop
    (AdaAttN/datasets.py:173-185).

    ``size_crop`` (H, W) is the style crop, which the video step encodes in
    one VGG pass with the frames, so it must be the frame size: the
    reference's 256×512 by default, as the JAX package fixes it."""

    def __init__(self, videvo_path, wikiart_path, seed=0,
                 size_crop=(256, 512)):
        self.videvo = VidevoFrames(videvo_path)
        self.wikiart = ImageFolderCrop(wikiart_path, size_crop=size_crop,
                                       seed=seed)
        self.seed = seed + 1
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        self.wikiart.set_epoch(epoch)

    def __len__(self):
        return len(self.videvo)

    def __getitem__(self, idx):
        rng = np.random.default_rng((self.seed, self._epoch, idx))
        widx = int(rng.integers(0, len(self.wikiart)))
        img1, img2 = self.videvo[idx]
        return img1, img2, self.wikiart[widx]


# ------------------------------------------------- offline preprocessing

def get_frames(video_dir, out_dir, img_size_wh=(640, 360), ext=".jpg"):
    """Every video of ``video_dir`` (sorted) as resized frames in
    ``<out_dir>/frames/<video index>/<frame index><ext>``
    (RTNSTV/datasets.py:16-50 at 640×360; AdaAttN's variant at 512×256),
    cv2's INTER_AREA resize.  Host only; needs cv2."""
    import cv2

    for vid_idx, path in enumerate(list_files(video_dir)):
        save_dir = os.path.join(out_dir, "frames", f"{vid_idx:05d}")
        os.makedirs(save_dir, exist_ok=True)
        cap = cv2.VideoCapture(path)
        frame_idx = 0
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            frame = cv2.resize(frame, img_size_wh,
                               interpolation=cv2.INTER_AREA)
            cv2.imwrite(os.path.join(save_dir, f"{frame_idx:05d}{ext}"),
                        frame)
            frame_idx += 1
        cap.release()


def calculate_optical_flow(frames_root, flow_root, engine="auto"):
    """Forward and backward flow of every adjacent pair of grayscale
    frames under ``frames_root/<video>/``, saved as ``.npy`` in
    ``flow_root/<video>/front/<i>_01.npy`` and ``back/<i+1>_10.npy``
    (RTNSTV/datasets.py:53-85 saved torch tensors; ``_load_flow_file``
    reads both).  ``engine``: "deepflow" (cv2.optflow, opencv-contrib, the
    reference's), "farneback" (plain cv2) or "auto" (deepflow where cv2
    has it).  Host only; needs cv2."""
    import cv2

    if engine == "auto":
        engine = "deepflow" if hasattr(cv2, "optflow") else "farneback"

    def calc(a, b):
        if engine == "deepflow":
            return cv2.optflow.createOptFlow_DeepFlow().calc(a, b, None)
        return cv2.calcOpticalFlowFarneback(
            a, b, None, pyr_scale=0.5, levels=5, winsize=15, iterations=3,
            poly_n=5, poly_sigma=1.2, flags=0)

    for folder in list_folders(frames_root):
        name = os.path.basename(folder)
        front = os.path.join(flow_root, name, "front")
        back = os.path.join(flow_root, name, "back")
        os.makedirs(front, exist_ok=True)
        os.makedirs(back, exist_ok=True)
        files = list_files(folder)
        for i in range(len(files) - 1):
            a = cv2.cvtColor(cv2.imread(files[i]), cv2.COLOR_BGR2GRAY)
            b = cv2.cvtColor(cv2.imread(files[i + 1]), cv2.COLOR_BGR2GRAY)
            np.save(os.path.join(front, f"{i:05d}_01.npy"), calc(a, b))
            np.save(os.path.join(back, f"{i + 1:05d}_10.npy"), calc(b, a))
