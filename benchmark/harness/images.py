"""Photo-like test images made on the device from a seed: smooth
gradients and a blob, a textured region, a hard edge and thin stripes.

The repository's card smoke script makes the same kind of content with
numpy on the host (chip_smoke.py synth_images); this is that generator
rewritten in PyTorch so that a run's set-up makes its images on the card
in a few calls. The same seed on the same device gives the same images.
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _uniform(g, n, lo, hi, device):
    return torch.rand(n, generator=g, device=device) * (hi - lo) + lo


def _randint(g, lo, hi, device) -> int:
    return int(torch.randint(lo, hi, (1,), generator=g, device=device))


def synth_images(g: torch.Generator, n: int, h: int, w: int,
                 device) -> torch.Tensor:
    """uint8 [n, h, w, 3] on `device`."""
    y = torch.linspace(0.0, 1.0, h, device=device)[:, None]
    x = torch.linspace(0.0, 1.0, w, device=device)[None, :]
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    th, tw = h // 3, w // 3
    sw = min(64, w // 4)
    for i in range(n):
        f = _uniform(g, 3, 1.0, 4.0, device)
        ph = _uniform(g, 3, 0.0, 6.28, device)
        img = torch.stack([
            128 + 90 * torch.sin(f[c] * 3.1 * x + ph[c])
            * torch.cos(f[(c + 1) % 3] * 2.3 * y + ph[(c + 2) % 3])
            for c in range(3)], dim=-1)
        cyx = _uniform(g, 2, 0.2, 0.8, device)
        blob = torch.exp(-((x - cyx[1]) ** 2 + (y - cyx[0]) ** 2) * 20.0)
        img = img + blob[..., None] * _uniform(g, 3, -80.0, 80.0, device)
        ty, tx = _randint(g, 0, h - th, device), _randint(g, 0, w - tw, device)
        img[ty:ty + th, tx:tx + tw] += 18.0 * torch.randn(
            (th, tw, 3), generator=g, device=device)
        ey = _randint(g, h // 4, 3 * h // 4, device)
        img[ey:, : w // 5] = _uniform(g, 3, 0.0, 255.0, device)
        sx = _randint(g, 0, w - sw, device)
        img[:, sx:sx + sw:4] = 255.0
        out[i] = torch.clamp(img + 0.5, 0, 255).to(torch.uint8)
    return out

