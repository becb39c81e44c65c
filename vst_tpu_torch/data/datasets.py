"""AdaAttN datasets: plain-Python indexers returning HWC float32 0–255
numpy arrays.  Counterpart of the AdaAttN part of
``vst_tpu/data/datasets.py``, sample for sample the same bits:

- ``VidevoFrames``  — AdaAttN/datasets.py:136-170 (frame pairs, no flow)
- ``ImageFolderCrop`` — AdaAttN's resize → random crop (utilities.py:31-43)
- ``CocoWikiArt`` / ``VidevoWikiArt`` — AdaAttN/datasets.py:32-44, 173-185

Images load through PIL with a BILINEAR (antialiased) resize, imported
where an image is loaded: a machine without PIL can import this module.
The ReCoNet and RTNSTV datasets come with their trainers.
"""

import os

import numpy as np


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
