"""Traffic generators, frozen: the law of ``chip_smoke.py:face_sample``
(the r04 weights were trained on such faces), drawn on the device so that
set-up stays short.

An image is a noisy background (uniform integers in [40, 200), each pixel
averaged with its upper and left neighbours, wrapping) with simple face
renders (a skin-tone ellipse, dark eyes, a mouth). The background comes
from a torch.Generator on the device; every other draw (face counts,
sizes, centres, colours) from a numpy RandomState, in the order the
original draws them. Both are made from the seed, any whole number.

A traffic mix's file only sets the parameters these take.
"""

from __future__ import annotations

import numpy as np
import torch


def rng_for(seed: int, stream: int = 0) -> np.random.RandomState:
    """A RandomState for ``seed`` (any whole number, negative or past 64
    bits too) and a stream number, through numpy's SeedSequence."""
    return np.random.RandomState(_seq(seed, stream).generate_state(8))


def torch_gen(seed: int, device, stream: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(_seq(seed, stream).generate_state(2, np.uint64)[0])
                  & ((1 << 63) - 1))
    return g


def _seq(seed: int, stream: int) -> np.random.SeedSequence:
    seed = int(seed)
    words = [abs(seed) >> (32 * i) & 0xFFFFFFFF
             for i in range(max(1, (abs(seed).bit_length() + 31) // 32))]
    return np.random.SeedSequence(words + [int(seed < 0), stream])


def backgrounds(gen: torch.Generator, n: int, h: int, w: int, device
                ) -> torch.Tensor:
    """(n, h, w, 3) f32: uniform integers in [40, 200), each pixel the mean
    of itself and its upper and left neighbours (wrapping)."""
    img = torch.randint(40, 200, (n, h, w, 3), generator=gen, device=device,
                        dtype=torch.int32).float()
    return (img + torch.roll(img, 1, 1) + torch.roll(img, 1, 2)) / 3


def draw_faces(rng, img: torch.Tensor, n_faces: int):
    """Renders n_faces faces into img (h, w, 3) f32 in place. Returns
    (boxes (n, 4) xyxy, keypoints (n, 5, 3): eyes, nose, mouth corners,
    visibility 1). A face's box is as high as its size, drawn from
    [24, min(h, w) / 3]."""
    h, w = img.shape[:2]
    dev = img.device
    boxes, kps = [], []
    for _ in range(n_faces):
        s = rng.uniform(24, min(h, w) / 3)
        cx, cy = rng.uniform(s, w - s), rng.uniform(s, h - s)
        y0, y1 = max(int(cy - 0.6 * s) - 2, 0), min(int(cy + 0.6 * s) + 3, h)
        x0, x1 = max(int(cx - 0.5 * s) - 2, 0), min(int(cx + 0.5 * s) + 3, w)
        yy = torch.arange(y0, y1, device=dev, dtype=torch.float64)[:, None]
        xx = torch.arange(x0, x1, device=dev, dtype=torch.float64)[None, :]
        win = img[y0:y1, x0:x1]
        face = ((xx - cx) / (0.40 * s)) ** 2 + ((yy - cy) / (0.50 * s)) ** 2
        skin = (rng.randint(90, 160), rng.randint(120, 190),
                rng.randint(170, 240))
        win[face <= 1] = torch.tensor(skin, dtype=img.dtype, device=dev)
        for ex in (-0.18, 0.18):
            eye = (xx - cx - ex * s) ** 2 + (yy - cy + 0.13 * s) ** 2
            win[eye <= (0.07 * s) ** 2] = 30
        mouth = (torch.abs(yy - cy - 0.27 * s) <= max(0.03 * s, 1)) & \
            (torch.abs(xx - cx) <= 0.14 * s)
        win[mouth] = torch.tensor((40, 40, 120), dtype=img.dtype, device=dev)
        boxes.append((cx - 0.4 * s, cy - 0.5 * s, cx + 0.4 * s, cy + 0.5 * s))
        kps.append([(cx - 0.18 * s, cy - 0.13 * s, 1.0),
                    (cx + 0.18 * s, cy - 0.13 * s, 1.0),
                    (cx, cy + 0.07 * s, 1.0),
                    (cx - 0.14 * s, cy + 0.27 * s, 1.0),
                    (cx + 0.14 * s, cy + 0.27 * s, 1.0)])
    return (np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(kps, np.float32).reshape(-1, 5, 3))


def _uint8(img: torch.Tensor) -> torch.Tensor:
    return img.clamp(0, 255).to(torch.uint8)


def frame_pool(seed: int, n: int, h: int, w: int, faces, device
               ) -> np.ndarray:
    """n BGR frames (n, h, w, 3) uint8 on the host, each with
    randint(faces[0], faces[1] + 1) faces."""
    rng = rng_for(seed)
    img = backgrounds(torch_gen(seed, device), n, h, w, device)
    for i in range(n):
        draw_faces(rng, img[i], rng.randint(faces[0], faces[1] + 1))
    return _uint8(img).cpu().numpy()
