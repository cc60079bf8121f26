"""Brick-mesh step helpers shared by the mesh engines.

Counterpart of the helpers of ddcmd_tpu/parallel/brickstep.py
(_wrap, _volume), orthorhombic only: the NPT chunk's brick guard reads
the box lengths themselves where the JAX package takes the
perpendicular widths of a triclinic h (_perp_widths).  The (N,K)-list brick
engine of that module, make_brick_step, is not ported (ROADMAP queue 1,
item 25); the cell engine is parallel/brickstep_cells.
"""

from __future__ import annotations

import torch

def _wrap(r, g):
    """Wrap origin-centred positions back into the (3,) box."""
    return r - g * torch.round(r / g)


def _volume(g):
    return torch.prod(g)
