"""Image preprocessing utilities (parity: paddle/dataset/image.py —
load_image/resize_short/center_crop/random_crop/left_right_flip/to_chw/
simple_transform).  Pure numpy (bilinear resize included) with optional PIL
decode for load_image; HWC uint8/float in, same contract as the reference.

A copy of the JAX package's ``datasets/image.py``, which imports no JAX.
"""

import numpy as np

__all__ = ["load_image", "load_image_bytes", "resize_short", "to_chw",
           "center_crop", "random_crop", "left_right_flip",
           "simple_transform"]


def load_image_bytes(data, is_color=True):
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB" if is_color else "L")
    return np.asarray(img)


def load_image(path, is_color=True):
    with open(path, "rb") as f:
        return load_image_bytes(f.read(), is_color)


def _resize_bilinear(im, out_h, out_w):
    """Numpy bilinear resize, HWC or HW."""
    h, w = im.shape[:2]
    if (h, w) == (out_h, out_w):
        return im
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    if im.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    a = im[np.ix_(y0, x0)].astype(np.float64)
    b = im[np.ix_(y0, x1)].astype(np.float64)
    c = im[np.ix_(y1, x0)].astype(np.float64)
    d = im[np.ix_(y1, x1)].astype(np.float64)
    out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
           + c * wy * (1 - wx) + d * wy * wx)
    return out.astype(im.dtype) if np.issubdtype(im.dtype, np.integer) \
        else out.astype(im.dtype)


def resize_short(im, size):
    """Scale so the SHORTER edge becomes `size` (ref image.py:197)."""
    h, w = im.shape[:2]
    if h > w:
        return _resize_bilinear(im, int(round(h * size / w)), size)
    return _resize_bilinear(im, size, int(round(w * size / h)))


def to_chw(im, order=(2, 0, 1)):
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    hs = max((h - size) // 2, 0)
    ws = max((w - size) // 2, 0)
    return im[hs:hs + size, ws:ws + size]


def random_crop(im, size, is_color=True, rng=None):
    rng = rng or np.random
    h, w = im.shape[:2]
    hs = int(rng.randint(0, max(h - size, 0) + 1))
    ws = int(rng.randint(0, max(w - size, 0) + 1))
    return im[hs:hs + size, ws:ws + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None, rng=None):
    """resize_short -> crop (random+flip when training, center otherwise)
    -> CHW float32 -> optional mean subtraction (ref image.py:327)."""
    rng = rng or np.random
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color, rng=rng)
        if rng.randint(0, 2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color)
    if im.ndim == 2:
        im = im[:, :, None]
    im = to_chw(im).astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        im -= mean.reshape(-1, 1, 1) if mean.ndim == 1 and im.ndim == 3 \
            else mean
    return im
