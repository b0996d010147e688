"""Binary morphology and blurs in torch ops (port of
``tpubody.image.morphology``).

Replaces the cv2 calls sprinkled through the reference pipeline
(cv2.erode lib/Normal2Depth.py:18, cv2.morphologyEx MORPH_CLOSE :548,
medianBlur/blur lib/Warp.py:441-450).  Images are (H, W) or (H, W, C), as
in ``tpubody``.  Nothing here is a convolution: the box filter is an
average pool, so it is float32 whatever ``torch.backends.cudnn.allow_tf32``
says (skinning weights smoothed in TF32 would miss the 1e-4 budget).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# median_blur: channels sorted at once (k^2 shifted copies of each).
_MEDIAN_CHANNELS = 8


def _max_window(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Maximum over a ksize x ksize window of an (H, W) float image; the
    border is padded with -inf, so it never wins."""
    return F.max_pool2d(x[None, None], ksize, stride=1,
                        padding=ksize // 2)[0, 0]


def erode(mask: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Binary/greyscale erosion with a ksize x ksize box element (ksize
    odd).  The border is padded with +inf: the image edge does not erode."""
    m = mask.to(torch.float32)
    return (-_max_window(-m, ksize)).to(mask.dtype)


def dilate(mask: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    m = mask.to(torch.float32)
    return _max_window(m, ksize).to(mask.dtype)


def close(mask: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Morphological closing (dilate then erode; cv2.MORPH_CLOSE)."""
    return erode(dilate(mask, ksize), ksize)


def open_(mask: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    return dilate(erode(mask, ksize), ksize)


def boundary(mask: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Inner boundary ring: mask minus its erosion."""
    m = mask.to(torch.bool)
    return m & ~erode(m, ksize)


def box_blur(img: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Mean filter over a ksize box (zero padding, divided by ksize^2);
    channels handled independently.  img (H, W) or (H, W, C)."""
    squeeze = img.dim() == 2
    x = img[..., None] if squeeze else img
    x = x.permute(2, 0, 1)[None]                       # (1, C, H, W)
    y = F.avg_pool2d(x, ksize, stride=1, padding=ksize // 2,
                     count_include_pad=True)
    y = y[0].permute(1, 2, 0)
    return y[..., 0] if squeeze else y


def median_blur(img: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Median filter (exact, via sort over the unrolled window).

    ksize is expected small (3/5, as in the reference's medianBlur use
    lib/Warp.py:441).  The border is replicated.  The k^2 shifted copies
    are stacked for a few channels at a time: at 1024^2 that is
    k^2 * 4 MB a channel.
    """
    squeeze = img.dim() == 2
    x = img[..., None] if squeeze else img
    pad = ksize // 2
    H, W = x.shape[:2]
    xp = F.pad(x.permute(2, 0, 1)[None], (pad, pad, pad, pad),
               mode="replicate")[0]                    # (C, H + 2p, W + 2p)
    out = []
    for c in range(0, xp.shape[0], _MEDIAN_CHANNELS):
        ch = xp[c:c + _MEDIAN_CHANNELS]
        stack = torch.stack([ch[:, dy:dy + H, dx:dx + W]
                             for dy in range(ksize) for dx in range(ksize)])
        out.append(torch.sort(stack, dim=0).values[(ksize * ksize) // 2])
    med = torch.cat(out).permute(1, 2, 0)
    return med[..., 0] if squeeze else med


def masked_box_smooth(img: torch.Tensor, mask: torch.Tensor,
                      ksize: int = 3) -> torch.Tensor:
    """Box blur that averages only over valid (mask) pixels."""
    m = mask.to(img.dtype)
    num = box_blur(img * (m[..., None] if img.dim() == 3 else m), ksize)
    den = box_blur(m, ksize)
    den = torch.clamp(den, min=1e-8)
    return num / (den[..., None] if img.dim() == 3 else den)
