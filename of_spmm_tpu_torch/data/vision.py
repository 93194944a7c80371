"""Image data pipeline: decode + geometric/color transforms + datasets; the
counterpart of the JAX package's ``data/vision.py``.

Decode and augmentation are host work: numpy / PIL transforms composed
per sample in DataLoader workers, producing fixed-shape batches the card
consumes. They are the JAX package's, bit for bit for the same
``np.random.Generator``. PIL is optional: without it (``HAVE_PIL``
False) ``Resize`` falls back to ``_resize_bilinear_np`` (which truncates
to uint8 and does not antialias) and ``decode_image`` raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np

from of_spmm_tpu_torch.data.dataset import Dataset

try:  # PIL is an optional dependency — decode paths gate on it
    from PIL import Image

    HAVE_PIL = True
except ImportError:  # pragma: no cover
    Image = None
    HAVE_PIL = False


def decode_image(path_or_bytes) -> np.ndarray:
    """Decode an image file/bytes to an (H, W, 3) uint8 array (RGB).

    Host-side analog of the reference's image_decode op
    (oneflow/user/image/image_util.cpp); requires PIL.
    """
    if not HAVE_PIL:
        raise RuntimeError("decode_image requires PIL (not installed)")
    if isinstance(path_or_bytes, (bytes, bytearray)):
        import io

        img = Image.open(io.BytesIO(path_or_bytes))
    else:
        img = Image.open(path_or_bytes)
    return np.asarray(img.convert("RGB"))


# ---------------------------------------------------------------------------
# Transforms (each is array -> array; compose with Compose)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Compose:
    transforms: Tuple[Callable, ...]

    def __call__(self, x, rng: Optional[np.random.Generator] = None):
        for t in self.transforms:
            x = t(x, rng) if _wants_rng(t) else t(x)
        return x


def _wants_rng(t) -> bool:
    return getattr(t, "_random", False)


def _as_hwc(x: np.ndarray) -> np.ndarray:
    if x.ndim != 3:
        raise ValueError(f"expected (H, W, C) image, got shape {x.shape}")
    return x


@dataclasses.dataclass(frozen=True)
class Resize:
    """Bilinear resize to (size, size) or (h, w)."""

    size: Any

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = _as_hwc(x)
        h, w = (self.size, self.size) if isinstance(self.size, int) else self.size
        if x.shape[:2] == (h, w):
            return x
        if HAVE_PIL:
            img = Image.fromarray(x)
            return np.asarray(img.resize((w, h), Image.BILINEAR))
        return _resize_bilinear_np(x, h, w)


def _resize_bilinear_np(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """Pure-numpy bilinear fallback (align_corners=False convention)."""
    H, W = x.shape[:2]
    ys = (np.arange(h) + 0.5) * H / h - 0.5
    xs = (np.arange(w) + 0.5) * W / w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    a = x[y0][:, x0].astype(np.float32)
    b = x[y0][:, x1].astype(np.float32)
    c = x[y1][:, x0].astype(np.float32)
    d = x[y1][:, x1].astype(np.float32)
    out = a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx
    return out.astype(x.dtype) if np.issubdtype(x.dtype, np.integer) else out


@dataclasses.dataclass(frozen=True)
class CenterCrop:
    size: int

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = _as_hwc(x)
        h, w = x.shape[:2]
        s = self.size
        if h < s or w < s:
            raise ValueError(f"image {h}x{w} smaller than crop {s}")
        top, left = (h - s) // 2, (w - s) // 2
        return x[top:top + s, left:left + s]


@dataclasses.dataclass(frozen=True)
class RandomCrop:
    size: int
    _random = True

    def __call__(self, x: np.ndarray, rng=None) -> np.ndarray:
        x = _as_hwc(x)
        rng = rng or np.random.default_rng()
        h, w = x.shape[:2]
        s = self.size
        top = int(rng.integers(0, h - s + 1))
        left = int(rng.integers(0, w - s + 1))
        return x[top:top + s, left:left + s]


@dataclasses.dataclass(frozen=True)
class RandomResizedCrop:
    """Random area/aspect crop then resize — the reference's fused GPU
    `ImageDecoderRandomCropResize` semantics (decode happens upstream)."""

    size: int
    scale: Tuple[float, float] = (0.08, 1.0)
    ratio: Tuple[float, float] = (3 / 4, 4 / 3)
    _random = True

    def __call__(self, x: np.ndarray, rng=None) -> np.ndarray:
        x = _as_hwc(x)
        rng = rng or np.random.default_rng()
        h, w = x.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * rng.uniform(*self.scale)
            ar = np.exp(rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                top = int(rng.integers(0, h - ch + 1))
                left = int(rng.integers(0, w - cw + 1))
                crop = x[top:top + ch, left:left + cw]
                return Resize(self.size)(crop)
        return Resize(self.size)(CenterCrop(min(h, w))(x))


@dataclasses.dataclass(frozen=True)
class RandomHorizontalFlip:
    p: float = 0.5
    _random = True

    def __call__(self, x: np.ndarray, rng=None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        return x[:, ::-1] if rng.random() < self.p else x


@dataclasses.dataclass(frozen=True)
class Normalize:
    """uint8 HWC -> float32 CHW normalized by per-channel mean/std."""

    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = _as_hwc(x).astype(np.float32) / 255.0
        x = (x - np.asarray(self.mean, np.float32)) / np.asarray(self.std, np.float32)
        return np.ascontiguousarray(x.transpose(2, 0, 1))


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


class ImageFolder(Dataset):
    """ImageNet-style layout: root/<class_name>/<image files>.

    Analog of the reference's folder datasets consumed by its benchmark
    scripts; decode+transform run in DataLoader workers.
    """

    EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 seed: int = 0):
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
        if not classes:
            raise ValueError(f"no class directories under {root}")
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith(self.EXTS):
                    self.samples.append((os.path.join(cdir, f),
                                         self.class_to_idx[c]))
        self.transform = transform
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        path, label = self.samples[i]
        img = decode_image(path)
        if self.transform is not None:
            img = (self.transform(img, self._rng)
                   if isinstance(self.transform, Compose)
                   else self.transform(img))
        return img, np.int32(label)


class CocoDetection(Dataset):
    """COCO-format detection dataset: images + per-image box/label lists.

    Parses the standard annotation JSON (the reference reads the same
    format in C++, oneflow/user/data/coco_{dataset,parser}.cpp). Returns
    (image, boxes (N,4) xywh float32, labels (N,) int32). Ragged targets
    are returned as lists — batching policy belongs to the collate_fn,
    exactly like the reference's COCO reader emits TensorBuffer lists.
    """

    def __init__(self, image_dir: str, annotation_file: str,
                 transform: Optional[Callable] = None):
        with open(annotation_file) as f:
            ann = json.load(f)
        self.image_dir = image_dir
        self.images = {im["id"]: im for im in ann["images"]}
        self.by_image: dict = {i: [] for i in self.images}
        for a in ann.get("annotations", []):
            if a["image_id"] in self.by_image:
                self.by_image[a["image_id"]].append(a)
        self.ids = sorted(self.images)
        self.transform = transform

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        img_id = self.ids[i]
        info = self.images[img_id]
        img = decode_image(os.path.join(self.image_dir, info["file_name"]))
        if self.transform is not None:
            img = self.transform(img)
        anns = self.by_image[img_id]
        boxes = np.asarray([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
        labels = np.asarray([a["category_id"] for a in anns], np.int32)
        return img, boxes, labels


def detection_collate(items: Sequence[Any]):
    """Collate for ragged detection targets: stack images, keep lists."""
    imgs = np.stack([it[0] for it in items])
    boxes = [it[1] for it in items]
    labels = [it[2] for it in items]
    return imgs, boxes, labels
