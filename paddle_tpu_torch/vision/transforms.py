"""Image transforms (counterpart of ``paddle_tpu/vision/transforms.py``):
numpy on the host, applied to each sample before the DataLoader moves
the batch to the device."""
from __future__ import annotations

import numbers
import random as pyrandom

import numpy as np

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "RandomCrop",
           "CenterCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
           "Transpose", "BrightnessTransform", "Pad", "RandomRotation",
           "Grayscale", "to_tensor", "normalize", "resize", "hflip", "vflip"]


def _as_hwc(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def to_tensor(pic, data_format="CHW"):
    img = _as_hwc(pic).astype(np.float32)
    if img.dtype == np.uint8 or img.max() > 1.5:
        img = img / 255.0
    if data_format == "CHW":
        img = img.transpose(2, 0, 1)
    return img


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    img = np.asarray(img, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    if data_format == "CHW":
        return (img - mean[:, None, None]) / std[:, None, None]
    return (img - mean) / std


def resize(img, size, interpolation="bilinear"):
    img = _as_hwc(img)
    h, w = img.shape[:2]
    if isinstance(size, int):
        if h < w:
            nh, nw = size, int(size * w / h)
        else:
            nh, nw = int(size * h / w), size
    else:
        nh, nw = size
    ys = (np.arange(nh) + 0.5) * h / nh - 0.5
    xs = (np.arange(nw) + 0.5) * w / nw - 0.5
    if interpolation == "nearest":
        yi = np.clip(np.round(ys).astype(int), 0, h - 1)
        xi = np.clip(np.round(xs).astype(int), 0, w - 1)
        return img[yi][:, xi]
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx +
           c * wy * (1 - wx) + d * wy * wx)
    return out.astype(img.dtype if img.dtype != np.uint8 else np.float32)


def hflip(img):
    return _as_hwc(img)[:, ::-1]


def vflip(img):
    return _as_hwc(img)[::-1]


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        return to_tensor(img, self.data_format)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean, self.std = mean, std
        self.data_format = data_format

    def _apply_image(self, img):
        n = img.shape[0 if self.data_format == "CHW" else -1]
        mean = (self.mean * n)[:n] if len(self.mean) < n else self.mean[:n]
        std = (self.std * n)[:n] if len(self.std) < n else self.std[:n]
        return normalize(img, mean, std, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return resize(img, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = (size, size) if isinstance(size, int) else size

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        th, tw = self.size
        i = max(0, (h - th) // 2)
        j = max(0, (w - tw) // 2)
        return img[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        self.size = (size, size) if isinstance(size, int) else size
        self.padding = padding

    def _apply_image(self, img):
        img = _as_hwc(img)
        if self.padding:
            p = self.padding if isinstance(self.padding, (list, tuple)) \
                else [self.padding] * 4
            img = np.pad(img, ((p[1], p[3]), (p[0], p[2]), (0, 0)))
        h, w = img.shape[:2]
        th, tw = self.size
        i = pyrandom.randint(0, max(0, h - th))
        j = pyrandom.randint(0, max(0, w - tw))
        return img[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if pyrandom.random() < self.prob:
            return hflip(img)
        return _as_hwc(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if pyrandom.random() < self.prob:
            return vflip(img)
        return _as_hwc(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def _apply_image(self, img):
        return _as_hwc(img).transpose(self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        alpha = 1 + np.random.uniform(-self.value, self.value)
        return np.clip(_as_hwc(img) * alpha, 0, 255).astype(np.float32)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        self.padding = padding if isinstance(padding, (list, tuple)) else \
            [padding] * 4
        self.fill = fill

    def _apply_image(self, img):
        img = _as_hwc(img)
        p = self.padding
        if len(p) == 2:
            p = [p[0], p[1], p[0], p[1]]
        return np.pad(img, ((p[1], p[3]), (p[0], p[2]), (0, 0)),
                      constant_values=self.fill)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees

    def _apply_image(self, img):
        img = _as_hwc(img)
        angle = np.random.uniform(*self.degrees)
        # nearest-neighbor rotation about center
        h, w = img.shape[:2]
        cy, cx = (h - 1) / 2, (w - 1) / 2
        rad = np.deg2rad(angle)
        yy, xx = np.mgrid[0:h, 0:w]
        ys = cy + (yy - cy) * np.cos(rad) - (xx - cx) * np.sin(rad)
        xs = cx + (yy - cy) * np.sin(rad) + (xx - cx) * np.cos(rad)
        yi = np.clip(np.round(ys).astype(int), 0, h - 1)
        xi = np.clip(np.round(xs).astype(int), 0, w - 1)
        valid = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        out = img[yi, xi]
        out[~valid] = 0
        return out


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        self.n = num_output_channels

    def _apply_image(self, img):
        img = _as_hwc(img).astype(np.float32)
        if img.shape[2] == 1:
            g = img
        else:
            g = (0.299 * img[..., 0:1] + 0.587 * img[..., 1:2] +
                 0.114 * img[..., 2:3])
        return np.repeat(g, self.n, axis=2) if self.n > 1 else g
