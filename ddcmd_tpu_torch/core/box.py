"""Simulation box: orthorhombic h, periodic wrap, minimum image.

Counterpart of ddcmd_tpu/core/box.py, orthorhombic only.  Particles live
in the box centred on the origin, components in [-L/2, L/2);
`back_in_box` re-centres with a round (half to even, as jnp.round).  A
triclinic h raises NotImplementedError (ROADMAP queue 1, item 20).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Box:
    h: torch.Tensor         # (3,3) lattice vectors as columns, internal length
    pbc: int                # bit i => axis i periodic
    pbc_mask: torch.Tensor  # (3,) 1.0 on periodic axes, made once on the device

    @classmethod
    def from_h(cls, h, pbc: int = 7, dtype=torch.float32,
               device="cpu") -> "Box":
        h = np.asarray(h, dtype=np.float64).reshape(3, 3)
        if not np.allclose(h, np.diag(np.diagonal(h))):
            raise NotImplementedError(
                "triclinic boxes are not ported yet (ROADMAP queue 1, "
                "item 20: the ops/cellpair.py fallback engine)")
        mask = torch.tensor([(pbc >> i) & 1 for i in range(3)], dtype=dtype,
                            device=device)
        return cls(h=torch.as_tensor(h, dtype=dtype, device=device), pbc=pbc,
                   pbc_mask=mask)

    @property
    def lengths(self) -> torch.Tensor:
        return torch.diagonal(self.h)

    @property
    def volume(self) -> torch.Tensor:
        return torch.prod(self.lengths)

    def scale(self, lam: torch.Tensor) -> "Box":
        """h <- diag(lam) @ h (barostat volume change, nglfconstraint.c:64)."""
        return dataclasses.replace(self, h=lam[:, None] * self.h)

    def back_in_box(self, r: torch.Tensor) -> torch.Tensor:
        """Wrap positions into the origin-centred box (backInBox_fast)."""
        L = self.lengths
        return r - L * torch.round(r / L) * self.pbc_mask

    def min_image(self, dr: torch.Tensor) -> torch.Tensor:
        """Minimum-image reduction of displacement(s) (nearestImage)."""
        return self.back_in_box(dr)
