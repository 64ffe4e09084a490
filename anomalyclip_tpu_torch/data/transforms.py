"""Group (clip-level) transforms — the full gtransforms surface, array-native:
a copy of anomalyclip_tpu/data/transforms.py, numpy only (PIL is imported
inside ``_resize_frame``). The same ``rng`` gives the same bits.

Re-design of the reference's transform library (reference:
src/data/components/gtransforms.py:11-538 and the used pipeline
src/utils/augmentations.py:21-34). The reference operates on *lists of PIL
images*, one Python call per frame; here a clip is a single numpy array
``(T, H, W, C)`` (uint8 for geometric/photometric ops, float32 after
``GroupToFloat``) so crops/flips/normalization are vectorized slices over the
whole clip — the layout the image encoders take (NHWC) with no
per-frame Python in the hot loop.

Randomness is an explicit ``numpy.random.Generator`` threaded through
``__call__`` (the reference uses the global ``random`` module:
gtransforms.py:23, 50, 209), so a worker-thread pipeline is reproducible and
race-free.

Semantics parity notes (tested in tests/test_transforms.py):
  * ``GroupScale``/``GroupCenterCrop`` match torchvision Resize/CenterCrop
    including the long-side *truncation* (int, not round) that positions the
    reference's center crop (gtransforms.py:89-103, 35-41).
  * ``GroupOverSample`` reproduces fill_fix_offset's 5 offsets x {normal,
    flipped} crop order exactly (gtransforms.py:105-138, 224-247).
  * ``GroupTenCrop`` follows torchvision TenCrop order: tl, tr, bl, br,
    center, then the same five of the horizontally flipped clip
    (gtransforms.py:449-454).
  * ``GroupRandomColorJitter`` applies brightness/contrast/saturation/hue with
    torchvision's factor ranges and random order (gtransforms.py:390-406);
    blend math matches torchvision.transforms.functional on float tensors.
  * ``GroupSolarization`` inverts pixels >= 128 (PIL ImageOps.solarize,
    gtransforms.py:438-446); ``GroupRandomGrayscale`` uses the ITU-R 601
    luma (PIL "L") with 3 output channels (gtransforms.py:409-423).
  * ``GroupGaussianBlur`` is a true separable Gaussian (sigma ~ U[0.1, 2.0],
    gtransforms.py:426-435); PIL approximates the same kernel with box
    passes, so values agree only approximately — documented divergence in an
    augmentation that has no exactness contract.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

Clip = np.ndarray  # (T, H, W, C)


def _needs_rng(fn: Callable) -> bool:
    return getattr(fn, "_wants_rng", False)


def _rng_transform(cls):
    cls._wants_rng = True
    return cls


class Compose:
    """Chains transforms; passes ``rng`` only to those that declare they want it."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, clip: Clip, rng: Optional[np.random.Generator] = None) -> Clip:
        for t in self.transforms:
            clip = t(clip, rng) if _needs_rng(t) else t(clip)
        return clip


class IdentityTransform:
    """gtransforms.py:384-386."""

    def __call__(self, clip: Clip) -> Clip:
        return clip


# ---------------------------------------------------------------------------
# resize / crop geometry
# ---------------------------------------------------------------------------


def _resize_frame(frame: np.ndarray, size: Tuple[int, int], interpolation: str) -> np.ndarray:
    """(H, W, C) uint8 -> (size[0], size[1], C) via PIL (reference numerics)."""
    from PIL import Image

    modes = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR, "nearest": Image.NEAREST}
    new_h, new_w = size
    img = Image.fromarray(frame).resize((new_w, new_h), modes[interpolation])
    return np.asarray(img)


def resize_clip(clip: Clip, size: Tuple[int, int], interpolation: str = "bicubic") -> Clip:
    if clip.shape[1:3] == tuple(size):
        return clip
    return np.stack([_resize_frame(f, size, interpolation) for f in clip])


def _short_side_size(h: int, w: int, size: int) -> Tuple[int, int]:
    """torchvision Resize(int) semantics: short side == size, long side TRUNCATED
    (int(size * long / short)) — round() would shift the center crop by a pixel
    on half-fraction aspect ratios (see data/sources.py:preprocess_frame)."""
    if w < h:
        return max(int(h * size / w), size), size
    return size, max(int(w * size / h), size)


class GroupScale:
    """Short-side resize of the whole clip (gtransforms.py:89-103). ``size`` may
    be an int (short side) or (h, w)."""

    def __init__(self, size, interpolation: str = "bicubic"):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, clip: Clip) -> Clip:
        t, h, w, _ = clip.shape
        if isinstance(self.size, int):
            target = _short_side_size(h, w, self.size)
        else:
            target = tuple(self.size)
        return resize_clip(clip, target, self.interpolation)


class GroupResize(GroupScale):
    """Alias with bilinear default (gtransforms.py:501-506)."""

    def __init__(self, size, interpolation: str = "bilinear"):
        super().__init__(size, interpolation)


def _as_hw(size) -> Tuple[int, int]:
    if isinstance(size, (int, np.integer)):
        return int(size), int(size)
    return int(size[0]), int(size[1])


def _center_offset(margin: int) -> int:
    """torchvision CenterCrop placement: int(round(margin / 2)) under Python's
    banker's rounding — one pixel off margin // 2 when margin % 4 == 3."""
    return int(round(margin / 2.0))


class GroupCenterCrop:
    """gtransforms.py:35-41 (torchvision CenterCrop placement)."""

    def __init__(self, size):
        self.th, self.tw = _as_hw(size)

    def __call__(self, clip: Clip) -> Clip:
        h, w = clip.shape[1:3]
        top = _center_offset(h - self.th)
        left = _center_offset(w - self.tw)
        return clip[:, top : top + self.th, left : left + self.tw]


@_rng_transform
class GroupRandomCrop:
    """One crop offset shared by every frame of the clip (gtransforms.py:11-32)."""

    def __init__(self, size):
        self.th, self.tw = _as_hw(size)

    def __call__(self, clip: Clip, rng: np.random.Generator) -> Clip:
        h, w = clip.shape[1:3]
        top = int(rng.integers(0, h - self.th + 1))
        left = int(rng.integers(0, w - self.tw + 1))
        return clip[:, top : top + self.th, left : left + self.tw]


@_rng_transform
class GroupRandomHorizontalFlip:
    """p=0.5 flip of the whole clip (gtransforms.py:43-55)."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, clip: Clip, rng: np.random.Generator) -> Clip:
        if rng.random() < self.p:
            return clip[:, :, ::-1]
        return clip


def fill_fix_offset(
    more_fix_crop: bool, image_w: int, image_h: int, crop_w: int, crop_h: int
) -> List[Tuple[int, int]]:
    """The 5/13 canonical crop anchors (gtransforms.py:224-247)."""
    w_step = (image_w - crop_w) // 4
    h_step = (image_h - crop_h) // 4
    ret = [
        (0, 0),
        (4 * w_step, 0),
        (0, 4 * h_step),
        (4 * w_step, 4 * h_step),
        (2 * w_step, 2 * h_step),
    ]
    if more_fix_crop:
        ret += [
            (0, 2 * h_step),
            (4 * w_step, 2 * h_step),
            (2 * w_step, 4 * h_step),
            (2 * w_step, 0),
            (1 * w_step, 1 * h_step),
            (3 * w_step, 1 * h_step),
            (1 * w_step, 3 * h_step),
            (3 * w_step, 3 * h_step),
        ]
    return ret


def fill_fc_fix_offset(image_w: int, image_h: int, crop_w: int, crop_h: int):
    """Left/center/right full-height anchors (gtransforms.py:249-258)."""
    w_step = (image_w - crop_w) // 2
    h_step = (image_h - crop_h) // 2
    return [(0, 0), (w_step, h_step), (2 * w_step, 2 * h_step)]


class GroupOverSample:
    """10-crop oversampling: 5 fixed anchors x {normal, mirrored}
    (gtransforms.py:105-138). Returns (10, T, H, W, C) — crops fold into the
    batch axis on device (eval/evaluator.py handles the ncrops dim natively)."""

    def __init__(self, crop_size, scale_size: Optional[int] = None):
        self.ch, self.cw = _as_hw(crop_size)
        self.scale = GroupScale(scale_size) if scale_size else None

    def __call__(self, clip: Clip) -> np.ndarray:
        if self.scale is not None:
            clip = self.scale(clip)
        h, w = clip.shape[1:3]
        out = []
        for o_w, o_h in fill_fix_offset(False, w, h, self.cw, self.ch):
            crop = clip[:, o_h : o_h + self.ch, o_w : o_w + self.cw]
            out.append(crop)
            out.append(crop[:, :, ::-1])
        return np.stack(out)


class GroupFCSample:
    """3 full-height square crops (left/center/right), (3, T, H, W, C)
    (gtransforms.py:141-166)."""

    def __init__(self, crop_size, scale_size: Optional[int] = None):
        self.ch, self.cw = _as_hw(crop_size)
        self.scale = GroupScale(scale_size) if scale_size else None

    def __call__(self, clip: Clip) -> np.ndarray:
        if self.scale is not None:
            clip = self.scale(clip)
        h, w = clip.shape[1:3]
        out = [
            clip[:, o_h : o_h + h, o_w : o_w + h]
            for o_w, o_h in fill_fc_fix_offset(w, h, h, h)
        ]
        return np.stack(out)


class GroupTenCrop:
    """torchvision TenCrop order: tl, tr, bl, br, center, then the same five of
    the flipped clip (gtransforms.py:449-454). Returns (10, T, H, W, C)."""

    def __init__(self, size):
        self.th, self.tw = _as_hw(size)

    def _five(self, clip: Clip) -> List[Clip]:
        h, w = clip.shape[1:3]
        th, tw = self.th, self.tw
        ct, cl = _center_offset(h - th), _center_offset(w - tw)
        return [
            clip[:, :th, :tw],
            clip[:, :th, w - tw :],
            clip[:, h - th :, :tw],
            clip[:, h - th :, w - tw :],
            clip[:, ct : ct + th, cl : cl + tw],
        ]

    def __call__(self, clip: Clip) -> np.ndarray:
        return np.stack(self._five(clip) + self._five(clip[:, :, ::-1]))


@_rng_transform
class GroupMultiScaleCrop:
    """TSN multi-scale fixed-anchor crop + resize (gtransforms.py:169-247)."""

    def __init__(
        self,
        input_size,
        scales: Optional[Sequence[float]] = None,
        max_distort: int = 1,
        fix_crop: bool = True,
        more_fix_crop: bool = True,
        interpolation: str = "bilinear",
    ):
        self.scales = list(scales) if scales is not None else [1, 0.875, 0.75, 0.66]
        self.max_distort = max_distort
        self.fix_crop = fix_crop
        self.more_fix_crop = more_fix_crop
        self.ih, self.iw = _as_hw(input_size)
        self.interpolation = interpolation

    def __call__(self, clip: Clip, rng: np.random.Generator) -> Clip:
        h, w = clip.shape[1:3]
        crop_w, crop_h, off_w, off_h = self._sample_crop(w, h, rng)
        crop = clip[:, off_h : off_h + crop_h, off_w : off_w + crop_w]
        return resize_clip(crop, (self.ih, self.iw), self.interpolation)

    def _sample_crop(self, image_w: int, image_h: int, rng: np.random.Generator):
        base = min(image_w, image_h)
        sizes = [int(base * s) for s in self.scales]
        crop_h = [self.ih if abs(x - self.ih) < 3 else x for x in sizes]
        crop_w = [self.iw if abs(x - self.iw) < 3 else x for x in sizes]
        pairs = [
            (w, h)
            for i, h in enumerate(crop_h)
            for j, w in enumerate(crop_w)
            if abs(i - j) <= self.max_distort
        ]
        cw, ch = pairs[int(rng.integers(0, len(pairs)))]
        if not self.fix_crop:
            ow = int(rng.integers(0, image_w - cw + 1))
            oh = int(rng.integers(0, image_h - ch + 1))
        else:
            anchors = fill_fix_offset(self.more_fix_crop, image_w, image_h, cw, ch)
            ow, oh = anchors[int(rng.integers(0, len(anchors)))]
        return cw, ch, ow, oh


@_rng_transform
class GroupRandomSizedCrop:
    """Inception-style random area (8%-100%) + aspect (3/4-4/3) crop, resized to
    ``size`` (gtransforms.py:262-307)."""

    def __init__(self, size: int, interpolation: str = "bilinear"):
        self.size = int(size)
        self.interpolation = interpolation

    def __call__(self, clip: Clip, rng: np.random.Generator) -> Clip:
        h, w = clip.shape[1:3]
        area = h * w
        for _ in range(10):
            target_area = rng.uniform(0.08, 1.0) * area
            aspect = rng.uniform(3.0 / 4, 4.0 / 3)
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if rng.random() < 0.5:
                cw, ch = ch, cw
            if cw <= w and ch <= h:
                x1 = int(rng.integers(0, w - cw + 1))
                y1 = int(rng.integers(0, h - ch + 1))
                crop = clip[:, y1 : y1 + ch, x1 : x1 + cw]
                return resize_clip(crop, (self.size, self.size), self.interpolation)
        # fallback: short-side scale + random crop (gtransforms.py:303-307)
        scaled = GroupScale(self.size, self.interpolation)(clip)
        return GroupRandomCrop(self.size)(scaled, rng)


# ---------------------------------------------------------------------------
# photometric
# ---------------------------------------------------------------------------

_LUMA = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def _grayscale(clip_f: np.ndarray) -> np.ndarray:
    """(…, H, W, 3) float -> (…, H, W, 1), ITU-R 601 luma (PIL "L" weights)."""
    return clip_f @ _LUMA[:, None]


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    """torchvision functional blend: factor * a + (1 - factor) * b, clipped."""
    return np.clip(factor * a + (1.0 - factor) * b, 0.0, 255.0)


def adjust_brightness(clip_f: np.ndarray, factor: float) -> np.ndarray:
    return _blend(clip_f, np.zeros_like(clip_f), factor)


def adjust_contrast(clip_f: np.ndarray, factor: float) -> np.ndarray:
    # torchvision: blend with the mean of the grayscale image (per frame)
    mean = _grayscale(clip_f).mean(axis=(-3, -2, -1), keepdims=True)
    return _blend(clip_f, np.broadcast_to(mean, clip_f.shape), factor)


def adjust_saturation(clip_f: np.ndarray, factor: float) -> np.ndarray:
    gray = np.broadcast_to(_grayscale(clip_f), clip_f.shape)
    return _blend(clip_f, gray, factor)


def adjust_hue(clip_f: np.ndarray, factor: float) -> np.ndarray:
    """Hue rotation by ``factor`` turns (torchvision semantics, factor in
    [-0.5, 0.5]) via RGB->HSV->RGB in float."""
    x = clip_f / 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.max(axis=-1)
    minc = x.min(axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = np.where(
        maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = np.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    h = (h + factor) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    rr = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [v, q, p, p, t, v])
    gg = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [t, v, v, q, p, p])
    bb = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [p, p, t, v, v, q])
    return np.clip(np.stack([rr, gg, bb], axis=-1) * 255.0, 0.0, 255.0)


@_rng_transform
class GroupRandomColorJitter:
    """With prob p, jitter brightness/contrast/saturation/hue in a random order
    with torchvision's uniform factor ranges (gtransforms.py:390-406). One
    factor draw is shared by every frame of the clip (the reference jitters
    per-frame only because it loops PIL images; frame-coherent jitter is the
    correct video augmentation and matches the per-call factor draw)."""

    def __init__(self, p=0.8, brightness=0.4, contrast=0.4, saturation=0.2, hue=0.1):
        self.p = p
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, clip: Clip, rng: np.random.Generator) -> Clip:
        if rng.random() >= self.p:
            return clip
        f = clip.astype(np.float32)
        ops = []
        if self.brightness:
            lo, hi = max(0.0, 1 - self.brightness), 1 + self.brightness
            ops.append(("b", rng.uniform(lo, hi)))
        if self.contrast:
            lo, hi = max(0.0, 1 - self.contrast), 1 + self.contrast
            ops.append(("c", rng.uniform(lo, hi)))
        if self.saturation:
            lo, hi = max(0.0, 1 - self.saturation), 1 + self.saturation
            ops.append(("s", rng.uniform(lo, hi)))
        if self.hue:
            ops.append(("h", rng.uniform(-self.hue, self.hue)))
        order = rng.permutation(len(ops))
        fns = {
            "b": adjust_brightness,
            "c": adjust_contrast,
            "s": adjust_saturation,
            "h": adjust_hue,
        }
        for k in order:
            name, factor = ops[int(k)]
            f = fns[name](f, float(factor))
        # round, don't truncate: PIL/torchvision round on the float->uint8 cast
        # (and GroupRandomGrayscale/gaussian blur here already do)
        return np.round(f).astype(clip.dtype) if clip.dtype == np.uint8 else f


@_rng_transform
class GroupRandomGrayscale:
    """With prob p, replace RGB by 3-channel luma (gtransforms.py:409-423)."""

    def __init__(self, p: float = 0.2):
        self.p = p

    def __call__(self, clip: Clip, rng: np.random.Generator) -> Clip:
        if rng.random() >= self.p:
            return clip
        gray = _grayscale(clip.astype(np.float32))
        out = np.repeat(np.round(gray), 3, axis=-1)
        return out.astype(clip.dtype) if clip.dtype == np.uint8 else out


def gaussian_blur_clip(clip: Clip, sigma: float) -> Clip:
    """Separable Gaussian blur over H and W (edge-replicated), vectorized over
    the clip. PIL's ImageFilter.GaussianBlur approximates this kernel with box
    passes; this is the exact kernel."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    f = clip.astype(np.float32)
    padded = np.pad(f, ((0, 0), (radius, radius), (0, 0), (0, 0)), mode="edge")
    f = sum(k[i] * padded[:, i : i + clip.shape[1]] for i in range(len(k)))
    padded = np.pad(f, ((0, 0), (0, 0), (radius, radius), (0, 0)), mode="edge")
    f = sum(k[i] * padded[:, :, i : i + clip.shape[2]] for i in range(len(k)))
    out = np.clip(f, 0, 255)
    return np.round(out).astype(clip.dtype) if clip.dtype == np.uint8 else out


@_rng_transform
class GroupGaussianBlur:
    """With prob p, blur with sigma ~ U[0.1, 2.0] (gtransforms.py:426-435)."""

    def __init__(self, p: float):
        self.p = p

    def __call__(self, clip: Clip, rng: np.random.Generator) -> Clip:
        if rng.random() >= self.p:
            return clip
        return gaussian_blur_clip(clip, 0.1 + rng.random() * 1.9)


@_rng_transform
class GroupSolarization:
    """With prob p, invert pixels >= 128 (PIL ImageOps.solarize default
    threshold; gtransforms.py:438-446)."""

    def __init__(self, p: float, threshold: int = 128):
        self.p = p
        self.threshold = threshold

    def __call__(self, clip: Clip, rng: np.random.Generator) -> Clip:
        if rng.random() >= self.p:
            return clip
        return np.where(clip >= self.threshold, 255 - clip, clip).astype(clip.dtype)


# ---------------------------------------------------------------------------
# tensor-ification / normalization / padding
# ---------------------------------------------------------------------------


class GroupToFloat:
    """uint8 [0, 255] -> float32 [0, 1] (GroupToTensor, gtransforms.py:373-381),
    minus the NCHW permute: the encoders take NHWC, which is already the layout."""

    def __init__(self, div: bool = True):
        self.div = div

    def __call__(self, clip: Clip) -> Clip:
        f = clip.astype(np.float32)
        return f / 255.0 if self.div else f


class GroupNormalize:
    """Channel-wise (x - mean) / std over the last axis (gtransforms.py:479-486);
    works on (T, H, W, C) and on multi-crop (N, T, H, W, C) alike."""

    def __init__(self, mean=CLIP_MEAN, std=CLIP_STD):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, clip: Clip) -> Clip:
        return (clip - self.mean) / self.std


class LoopPad:
    """Tile the clip along T up to max_len (gtransforms.py:519-538)."""

    def __init__(self, max_len: int):
        self.max_len = max_len

    def __call__(self, clip: Clip) -> Clip:
        t = clip.shape[0]
        if t >= self.max_len:
            return clip
        reps = [clip] * (self.max_len // t)
        rem = self.max_len % t
        if rem:
            reps.append(clip[:rem])
        return np.concatenate(reps, axis=0)


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------


def get_augmentations(
    input_size: int = 224, ncrops: int = 1, normalize: bool = True
) -> Compose:
    """The pipeline the reference actually runs (src/utils/augmentations.py:21-34):
    bicubic short-side scale -> center crop -> [0,1] -> CLIP-normalize. For
    ncrops=10 the center crop is replaced by GroupOverSample, producing
    (10, T, H, W, C) with crops ready to fold into the device batch axis (the
    extension the reference's pipeline never wires up despite accepting the
    argument).

    ``normalize=False`` drops the float conversion + normalization stages and
    emits spatially-processed uint8 — the production ingest contract: every
    encoder normalizes uint8 in-graph (models/clip/model.py:
    normalize_frames_on_device) with the identical float32 arithmetic, so the
    host holds and ships 1/4 the bytes. ``normalize_frames(pipeline_uint8)``
    is bit-identical to the normalize=True output (pinned in
    tests/test_transforms.py)."""
    if ncrops == 1:
        crop: Callable = GroupCenterCrop(input_size)
    elif ncrops == 10:
        crop = GroupOverSample(input_size)
    else:
        raise ValueError(f"ncrops must be 1 or 10, got {ncrops}")
    stages: List[Callable] = [GroupScale(input_size), crop]
    if normalize:
        stages += [GroupToFloat(), GroupNormalize()]
    return Compose(stages)
