"""Image filters for the uncertainty maps (port of fmvfi_tpu/ops/filters.py).

- `gaussian_blur`: separable, scipy.ndimage.gaussian_filter's taps
  (truncate=4.0) and boundary (scipy 'reflect' == numpy 'symmetric').
- `median_filter`: scipy.ndimage.median_filter's window as a histogram rank
  filter over integral images: values are binned into `nbins` levels, each
  bin is box-counted with 2-D cumulative sums (chunked), and the median is
  read off the per-pixel CDF with sub-bin interpolation.

Both filter the last two axes of (..., H, W).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .resize import resize_bilinear


@functools.lru_cache(maxsize=16)
def _gaussian_taps(sigma: float, truncate: float = 4.0) -> tuple:
    """scipy.ndimage._gaussian_kernel1d: exp(-x^2/2s^2), normalized."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return tuple(float(v) for v in (k / k.sum()).astype(np.float32))


def pad_symmetric(x: torch.Tensor, before: int, after: int, dim: int) -> torch.Tensor:
    """numpy.pad(mode='symmetric') along `dim` (edge sample repeated), built
    from flips and concatenations; pads wider than the axis reflect again."""
    while before or after:
        n = x.shape[dim]
        lb, la = min(before, n), min(after, n)
        parts = []
        if lb:
            parts.append(torch.flip(x.narrow(dim, 0, lb), (dim,)))
        parts.append(x)
        if la:
            parts.append(torch.flip(x.narrow(dim, n - la, la), (dim,)))
        x = torch.cat(parts, dim)
        before, after = before - lb, after - la
    return x


def gaussian_blur(img: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """Separable gaussian over the last two axes, symmetric boundary."""
    taps = _gaussian_taps(float(sigma), float(truncate))
    r = (len(taps) - 1) // 2

    def conv_last(x):
        n = x.shape[-1]
        xp = pad_symmetric(x, r, r, -1)
        out = taps[0] * xp[..., 0:n]
        for t in range(1, len(taps)):
            out = out + taps[t] * xp[..., t : t + n]
        return out

    img = conv_last(img)
    return conv_last(img.transpose(-1, -2)).transpose(-1, -2)


def _box_sum(x: torch.Tensor, size: int) -> torch.Tensor:
    """Sliding size x size window sums over the last two axes of an already
    padded (..., Hp, Wp) tensor, via integral images."""
    cs = torch.cumsum(torch.cumsum(x, dim=-2), dim=-1)
    cs = torch.nn.functional.pad(cs, (1, 0, 1, 0))
    h = x.shape[-2] - size + 1
    w = x.shape[-1] - size + 1
    return (
        cs[..., size : size + h, size : size + w]
        - cs[..., size : size + h, 0:w]
        - cs[..., 0:h, size : size + w]
        + cs[..., 0:h, 0:w]
    )


def median_filter(
    img: torch.Tensor, size: int = 50, nbins: int = 1024, chunk: int = 64
) -> torch.Tensor:
    """scipy.ndimage.median_filter(img, size, mode='reflect') equivalent over
    the last two axes: the sorted window element at index n//2 (upper median
    for even n), located as the first bin whose cumulative count reaches
    rank = n//2 + 1 and interpolated inside that bin."""
    shape = img.shape
    xs = img.reshape((-1,) + tuple(shape[-2:]))  # (N, H, W)
    n_img, h, w = xs.shape
    lpad = size // 2
    rpad = size - lpad - 1
    rank = (size * size) // 2 + 1

    lo = torch.amin(xs, dim=(-2, -1), keepdim=True)
    hi = torch.amax(xs, dim=(-2, -1), keepdim=True)
    width = torch.clamp(hi - lo, min=1e-20)
    q = torch.clamp(((xs - lo) / width * nbins).to(torch.int32), 0, nbins - 1)
    qp = pad_symmetric(pad_symmetric(q, lpad, rpad, -2), lpad, rpad, -1)

    dev = img.device
    cum_prev = torch.zeros((n_img, h, w), device=dev)  # CDF up to previous chunk
    med_bin = torch.zeros((n_img, h, w), device=dev)  # bins with cum < rank
    c_below = torch.zeros((n_img, h, w), device=dev)  # count strictly below med bin
    c_in = torch.zeros((n_img, h, w), device=dev)  # count inside the median bin
    for c0 in range(0, nbins, chunk):
        bins = torch.arange(c0, min(c0 + chunk, nbins), dtype=torch.int32, device=dev)
        onehot = (qp[:, None] == bins[None, :, None, None]).float()
        bs = _box_sum(onehot, size)  # (N, nchunk, h, w)
        cums = cum_prev[:, None] + torch.cumsum(bs, dim=1)
        below = cums < rank
        med_bin = med_bin + below.sum(dim=1)
        c_below = c_below + torch.sum(bs * below, dim=1)
        prev = torch.cat([cum_prev[:, None], cums[:, :-1]], dim=1)
        first_hit = (~below) & (prev < rank)
        c_in = c_in + torch.sum(bs * first_hit, dim=1)
        cum_prev = cums[:, -1]

    frac = (rank - c_below - 0.5) / torch.clamp(c_in, min=1.0)
    frac = torch.clamp(frac, 0.0, 1.0)
    return (lo + width * (med_bin + frac) / nbins).reshape(shape)


def median_filter_fast(
    img: torch.Tensor, size: int = 50, nbins: int = 256, downsample: int = 2
) -> torch.Tensor:
    """The rank filter on a `downsample`x box-reduced image (window
    size/downsample), bilinearly upsampled back (align_corners=False)."""
    if downsample == 1:
        return median_filter(img, size, nbins)
    d = downsample
    h, w = img.shape[-2], img.shape[-1]
    x = pad_symmetric(pad_symmetric(img, 0, (-h) % d, -2), 0, (-w) % d, -1)
    hd, wd = x.shape[-2] // d, x.shape[-1] // d
    x = x.reshape(x.shape[:-2] + (hd, d, wd, d)).mean(dim=(-3, -1))
    m = median_filter(x, max(size // d, 3), nbins)
    lead = m.shape[:-2]
    m = m.reshape((-1, 1, hd, wd))
    m = resize_bilinear(m, (hd * d, wd * d), align_corners=False)
    return m.reshape(lead + (hd * d, wd * d))[..., :h, :w]
