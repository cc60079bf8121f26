"""Simulation box: h matrix, periodic wrap, minimum image.

Counterpart of ddcmd_tpu/core/box.py.  Particles live in the box centred
on the origin, components in [-L/2, L/2) for an orthorhombic box;
`back_in_box` re-centres with a round (half to even, as jnp.round).  A
general (triclinic) h goes through fractional coordinates s = r hinv^T;
`ortho` is fixed when the box is built (the barostat's diagonal scale
keeps a box orthorhombic).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


def inv3x3(h: torch.Tensor) -> torch.Tensor:
    """Analytic 3x3 inverse (adjugate over determinant), as the JAX
    package computes it, so fractional coordinates agree bit for bit."""
    a, b, c = h[:, 0], h[:, 1], h[:, 2]
    cbc = torch.linalg.cross(b, c)
    cca = torch.linalg.cross(c, a)
    cab = torch.linalg.cross(a, b)
    det = torch.dot(a, cbc)
    return torch.stack([cbc, cca, cab], dim=0) / det


def nearest_image(d: torch.Tensor, geom: torch.Tensor) -> torch.Tensor:
    """Minimum image of displacement(s) d (..., 3) for a box geometry:
    (3,) lengths, or the full (3,3) h of a triclinic box (round in
    fractional coordinates)."""
    if geom.dim() == 1:
        return d - geom * torch.round(d / geom)
    return d - torch.round(d @ inv3x3(geom).T) @ geom.T


def geom_volume(geom: torch.Tensor) -> torch.Tensor:
    """Volume of a box geometry: the product of (3,) lengths, |det h| of
    a (3,3) h."""
    if geom.dim() == 1:
        return torch.prod(geom)
    return torch.abs(torch.linalg.det(geom))


def perp_spans(geom: torch.Tensor) -> torch.Tensor:
    """Per-axis perpendicular spans of a box geometry, volume / |a_j x
    a_k| (the lengths when orthorhombic): the widths the cells and
    bricks measure rlist against."""
    if geom.dim() == 1:
        return geom
    a = geom.T  # rows = lattice vectors
    v = geom_volume(geom)
    return torch.stack([
        v / torch.linalg.norm(torch.linalg.cross(a[1], a[2])),
        v / torch.linalg.norm(torch.linalg.cross(a[2], a[0])),
        v / torch.linalg.norm(torch.linalg.cross(a[0], a[1]))])


def nearest_image_pbc(d: torch.Tensor, geom: torch.Tensor,
                      pbc_mask: torch.Tensor | None = None) -> torch.Tensor:
    """nearest_image on the periodic axes only: pbc_mask is Box.pbc_mask
    (1.0 on a periodic axis, 0.0 on a non-periodic one, whose
    displacement is kept whole), None for a fully periodic box.  (1,)
    slices of lengths and mask reduce one Cartesian component."""
    if pbc_mask is None:
        return nearest_image(d, geom)
    if geom.dim() == 1:
        return d - geom * torch.round(d / geom) * pbc_mask
    return d - (torch.round(d @ inv3x3(geom).T) * pbc_mask) @ geom.T


def pbc_mask_or_none(box: "Box"):
    """The box's pbc_mask where an axis is not periodic, else None (the
    list terms then take the plain minimum image)."""
    return None if box.pbc & 7 == 7 else box.pbc_mask


@dataclass
class Box:
    h: torch.Tensor         # (3,3) lattice vectors as columns, internal length
    pbc: int                # bit i => axis i periodic
    pbc_mask: torch.Tensor  # (3,) 1.0 on periodic axes, made once on the device
    ortho: bool = True      # h diagonal

    @classmethod
    def from_h(cls, h, pbc: int = 7, dtype=torch.float32,
               device="cpu") -> "Box":
        h = np.asarray(h, dtype=np.float64).reshape(3, 3)
        ortho = bool(np.allclose(h, np.diag(np.diagonal(h))))
        mask = torch.tensor([(pbc >> i) & 1 for i in range(3)], dtype=dtype,
                            device=device)
        return cls(h=torch.as_tensor(h, dtype=dtype, device=device), pbc=pbc,
                   pbc_mask=mask, ortho=ortho)

    @property
    def lengths(self) -> torch.Tensor:
        return torch.diagonal(self.h)

    @property
    def geom(self) -> torch.Tensor:
        """The pair engines' geometry: (3,) lengths for an orthorhombic
        box, the full (3,3) h for a triclinic one."""
        return self.lengths if self.ortho else self.h

    @property
    def volume(self) -> torch.Tensor:
        return geom_volume(self.geom)

    @property
    def perp_spans(self) -> torch.Tensor:
        """Per-axis perpendicular spans (the lengths when orthorhombic)."""
        return perp_spans(self.geom)

    def scale(self, lam: torch.Tensor) -> "Box":
        """h <- diag(lam) @ h (barostat volume change, nglfconstraint.c:64)."""
        return dataclasses.replace(self, h=lam[:, None] * self.h)

    def back_in_box(self, r: torch.Tensor) -> torch.Tensor:
        """Wrap positions into the origin-centred box (backInBox_fast)."""
        if self.ortho:
            L = self.lengths
            return r - L * torch.round(r / L) * self.pbc_mask
        s = r @ inv3x3(self.h).T
        s = s - torch.round(s) * self.pbc_mask
        return s @ self.h.T

    def min_image(self, dr: torch.Tensor) -> torch.Tensor:
        """Minimum-image reduction of displacement(s) (nearestImage)."""
        return self.back_in_box(dr)
