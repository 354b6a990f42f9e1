"""gluon.data.vision.transforms (the port's copy of
``mxnet_tpu/gluon/data/vision/transforms.py``; parity: reference
``python/mxnet/gluon/data/vision/transforms.py``, backed by
``src/operator/image/``).  Transforms run on host numpy: they feed the
input pipeline, and the reference's C++ image ops run on the CPU too."""
from __future__ import annotations

import numpy as onp

from ....ndarray import ndarray

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomLighting", "RandomColorJitter"]


def _np(x):
    if isinstance(x, ndarray):
        return x.asnumpy()
    if hasattr(x, "detach"):                     # a torch tensor
        return x.detach().cpu().numpy()
    return onp.asarray(x)


class Compose:
    def __init__(self, transforms):
        self._transforms = transforms

    def __call__(self, x, *args):
        for t in self._transforms:
            x = t(x)
        return (x,) + args if args else x


class Cast:
    def __init__(self, dtype="float32"):
        self._dtype = dtype

    def __call__(self, x):
        return _np(x).astype(self._dtype)


class ToTensor:
    """HWC uint8 [0,255] → CHW float32 [0,1]."""

    def __call__(self, x):
        x = _np(x)
        if x.ndim == 3:
            x = x.transpose(2, 0, 1)
        elif x.ndim == 4:
            x = x.transpose(0, 3, 1, 2)
        return (x / 255.0).astype(onp.float32)


class Normalize:
    def __init__(self, mean=0.0, std=1.0):
        self._mean = onp.asarray(mean, onp.float32)
        self._std = onp.asarray(std, onp.float32)

    def __call__(self, x):
        x = _np(x).astype(onp.float32)
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return (x - mean) / std


def _resize_hwc(img, size):
    """Nearest-neighbor resize on host (OpenCV-free)."""
    h, w = img.shape[:2]
    if isinstance(size, int):
        ow, oh = size, size
    else:
        ow, oh = size
    ys = (onp.arange(oh) * (h / oh)).astype(onp.int64)
    xs = (onp.arange(ow) * (w / ow)).astype(onp.int64)
    return img[ys][:, xs]


class Resize:
    def __init__(self, size, keep_ratio=False, interpolation=1):
        self._size = size

    def __call__(self, x):
        return _resize_hwc(_np(x), self._size)


class CenterCrop:
    def __init__(self, size, interpolation=1):
        self._size = (size, size) if isinstance(size, int) else size

    def __call__(self, x):
        x = _np(x)
        h, w = x.shape[:2]
        cw, ch = self._size
        x0 = max((w - cw) // 2, 0)
        y0 = max((h - ch) // 2, 0)
        out = x[y0:y0 + ch, x0:x0 + cw]
        if out.shape[:2] != (ch, cw):
            out = _resize_hwc(x, self._size)
        return out


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def __call__(self, x):
        x = _np(x)
        h, w = x.shape[:2]
        area = h * w
        for _ in range(10):
            target = onp.random.uniform(*self._scale) * area
            ar = onp.random.uniform(*self._ratio)
            cw = int(round((target * ar) ** 0.5))
            ch = int(round((target / ar) ** 0.5))
            if cw <= w and ch <= h:
                x0 = onp.random.randint(0, w - cw + 1)
                y0 = onp.random.randint(0, h - ch + 1)
                return _resize_hwc(x[y0:y0 + ch, x0:x0 + cw], self._size)
        return _resize_hwc(x, self._size)


class RandomFlipLeftRight:
    def __call__(self, x):
        x = _np(x)
        return x[:, ::-1].copy() if onp.random.rand() < 0.5 else x


class RandomFlipTopBottom:
    def __call__(self, x):
        x = _np(x)
        return x[::-1].copy() if onp.random.rand() < 0.5 else x


class RandomBrightness:
    def __init__(self, brightness):
        self._b = brightness

    def __call__(self, x):
        alpha = 1.0 + onp.random.uniform(-self._b, self._b)
        return onp.clip(_np(x).astype(onp.float32) * alpha, 0, 255)


class RandomContrast:
    def __init__(self, contrast):
        self._c = contrast

    def __call__(self, x):
        x = _np(x).astype(onp.float32)
        alpha = 1.0 + onp.random.uniform(-self._c, self._c)
        gray = x.mean()
        return onp.clip(x * alpha + gray * (1 - alpha), 0, 255)


class RandomSaturation:
    def __init__(self, saturation):
        self._s = saturation

    def __call__(self, x):
        x = _np(x).astype(onp.float32)
        alpha = 1.0 + onp.random.uniform(-self._s, self._s)
        gray = x.mean(axis=-1, keepdims=True)
        return onp.clip(x * alpha + gray * (1 - alpha), 0, 255)


class RandomLighting:
    def __init__(self, alpha):
        self._a = alpha

    def __call__(self, x):
        x = _np(x).astype(onp.float32)
        eig = onp.random.normal(0, self._a, 3)
        return onp.clip(x + eig.reshape(1, 1, 3) * 25.5, 0, 255)


class RandomColorJitter:
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        ts = []
        if brightness:
            ts.append(RandomBrightness(brightness))
        if contrast:
            ts.append(RandomContrast(contrast))
        if saturation:
            ts.append(RandomSaturation(saturation))
        self._ts = ts

    def __call__(self, x):
        for t in self._ts:
            x = t(x)
        return x


class RandomCrop:
    """Random spatial crop with optional padding (reference transforms
    RandomCrop; pad_value fills when the image is smaller)."""

    def __init__(self, size, pad=None, pad_value=0):
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad
        self._pad_value = pad_value

    def __call__(self, x):
        img = _np(x)
        if self._pad:
            p = self._pad
            img = onp.pad(img, ((p, p), (p, p), (0, 0)), mode="constant",
                          constant_values=self._pad_value)
        h, w = self._size
        ih, iw = img.shape[:2]
        if ih < h or iw < w:
            out = onp.full((max(h, ih), max(w, iw)) + img.shape[2:],
                           self._pad_value, img.dtype)
            out[:ih, :iw] = img
            img, ih, iw = out, out.shape[0], out.shape[1]
        y = onp.random.randint(0, ih - h + 1)
        xx = onp.random.randint(0, iw - w + 1)
        return img[y:y + h, xx:xx + w]


class CropResize:
    """Fixed crop then resize (reference CropResize)."""

    def __init__(self, x, y, width, height, size=None, interpolation=None):
        self._x, self._y, self._w, self._h = x, y, width, height
        self._size = size

    def __call__(self, img):
        img = _np(img)
        out = img[self._y:self._y + self._h, self._x:self._x + self._w]
        if self._size:
            out = Resize(self._size)(out)
        return out


class RandomGray:
    """Randomly convert to 3-channel grayscale (reference RandomGray)."""

    def __init__(self, p=0.5):
        self._p = p

    def __call__(self, x):
        img = _np(x)
        if onp.random.rand() < self._p:
            lum = (img[..., :3] @ onp.array([0.299, 0.587, 0.114],
                                            img.dtype if img.dtype.kind == "f"
                                            else onp.float32))
            img = onp.repeat(lum[..., None], 3, axis=-1).astype(img.dtype)
        return img


class RandomHue:
    """Random hue rotation in HSV space (reference RandomHue)."""

    def __init__(self, max_delta=0.1):
        self._d = max_delta

    def __call__(self, x):
        img = _np(x).astype(onp.float32)
        delta = onp.random.uniform(-self._d, self._d)
        # cheap YIQ-rotation approximation of hue shift (the reference's
        # image_random_hue kernel uses the same trick)
        u, w = onp.cos(delta * onp.pi), onp.sin(delta * onp.pi)
        t_yiq = onp.array([[0.299, 0.587, 0.114],
                           [0.596, -0.274, -0.321],
                           [0.211, -0.523, 0.311]], onp.float32)
        t_rgb = onp.array([[1.0, 0.956, 0.621],
                           [1.0, -0.272, -0.647],
                           [1.0, -1.107, 1.705]], onp.float32)
        rot = onp.array([[1, 0, 0], [0, u, -w], [0, w, u]], onp.float32)
        m = t_rgb @ rot @ t_yiq
        out = img[..., :3] @ m.T
        return onp.clip(out, 0, 255).astype(_np(x).dtype)


class Rotate:
    """Rotate by a fixed angle (degrees; reference Rotate with
    zoom_out=False semantics, nearest sampling)."""

    def __init__(self, rotation_degrees, zoom_in=False, zoom_out=False):
        self._deg = rotation_degrees

    def __call__(self, x):
        img = _np(x)
        theta = onp.deg2rad(self._deg)
        h, w = img.shape[:2]
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        yy, xx = onp.meshgrid(onp.arange(h), onp.arange(w), indexing="ij")
        ys = cy + (yy - cy) * onp.cos(theta) - (xx - cx) * onp.sin(theta)
        xs = cx + (yy - cy) * onp.sin(theta) + (xx - cx) * onp.cos(theta)
        yi = onp.clip(onp.round(ys).astype(int), 0, h - 1)
        xi = onp.clip(onp.round(xs).astype(int), 0, w - 1)
        inb = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
        out = img[yi, xi]
        out[~inb] = 0
        return out


class RandomRotation:
    """Random rotation from an angle range (reference RandomRotation)."""

    def __init__(self, angle_limits, zoom_in=False, zoom_out=False,
                 rotate_with_proba=1.0):
        self._limits = angle_limits
        self._p = rotate_with_proba

    def __call__(self, x):
        if onp.random.rand() >= self._p:
            return _np(x)
        deg = onp.random.uniform(*self._limits)
        return Rotate(deg)(x)


class RandomApply:
    """Apply a transform with probability p (reference RandomApply)."""

    def __init__(self, transforms, p=0.5):
        self._t = transforms
        self._p = p

    def __call__(self, x):
        if onp.random.rand() < self._p:
            return self._t(x)
        return _np(x)


# every transform here is a host-side callable; the reference's Hybrid*
# variants exist for symbolic tracing, which these already survive
HybridCompose = Compose
HybridRandomApply = RandomApply

__all__ += ["RandomCrop", "CropResize", "RandomGray", "RandomHue",
            "Rotate", "RandomRotation", "RandomApply", "HybridCompose",
            "HybridRandomApply"]
