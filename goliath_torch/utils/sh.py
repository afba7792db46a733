"""Real spherical harmonics (port of the JAX package's utils/sh.py).

Basis ordered (l, m) for l = 0..deg, m = -l..l, with the Condon-Shortley
phase folded into the associated-Legendre recurrence and sqrt(2) K cos/sin
for m != 0, as in the JAX package. The recurrence is unrolled for a static
degree.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import torch


def _factratio(n: int, d: int) -> float:
    if n >= d:
        p = 1.0
        for i in range(d + 1, n + 1):
            p *= i
        return p
    p = 1.0
    for i in range(n + 1, d + 1):
        p *= i
    return 1.0 / p


@lru_cache(maxsize=None)
def _kval(m: int, l: int) -> float:
    return math.sqrt(((2 * l + 1) / (4 * math.pi)) * _factratio(l - m, l + m))


def _assoc_legendre(m: int, l: int, x: torch.Tensor) -> torch.Tensor:
    """P_l^m(x) with Condon-Shortley phase; unrolled for static (m, l)."""
    pmm = torch.ones_like(x)
    if m > 0:
        somx2 = torch.sqrt(((1.0 + x) * (1.0 - x)).clamp(min=1e-8))
        fact = 1.0
        for _ in range(1, m + 1):
            pmm = -pmm * fact * somx2
            fact += 2.0
    if l == m:
        return pmm
    pmmp1 = x * (2 * m + 1) * pmm
    if l == m + 1:
        return pmmp1
    pll = pmmp1
    for i in range(m + 2, l + 1):
        pll = (x * (2 * i - 1) * pmmp1 - (i + m - 1) * pmm) / (i - m)
        pmm = pmmp1
        pmmp1 = pll
    return pll


def _sh_basis_one(m: int, l: int, ct: torch.Tensor, phi: torch.Tensor
                  ) -> torch.Tensor:
    if m > 0:
        return (math.sqrt(2.0) * _kval(m, l) * torch.cos(m * phi)
                * _assoc_legendre(m, l, ct))
    if m < 0:
        return (math.sqrt(2.0) * _kval(-m, l) * torch.sin(-m * phi)
                * _assoc_legendre(-m, l, ct))
    return _kval(0, l) * _assoc_legendre(0, l, ct)


def dir2angle(dirs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit dirs [..., 3] -> (cos(theta), phi). theta from +z, phi in xy."""
    ct = dirs[..., 2].clamp(-1.0, 1.0)
    phi = torch.atan2(dirs[..., 1], dirs[..., 0])
    return ct, phi


def dir2sh(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """SH basis values at unit directions: [..., (deg+1)^2]."""
    ct, phi = dir2angle(dirs)
    shs = [
        _sh_basis_one(m, l, ct, phi)
        for l in range(deg + 1)
        for m in range(-l, l + 1)
    ]
    return torch.stack(shs, dim=-1)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH coefficients sh [..., C, (deg+1)^2] at dirs [..., 3]."""
    return torch.einsum("...ck,...k->...c", sh, dir2sh(deg, dirs))
