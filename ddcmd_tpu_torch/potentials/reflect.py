"""REFLECT 'potential': specular reflection off the box faces in z.

Counterpart of ddcmd_tpu/potentials/reflect.py (reference ddcMD
src/reflect.c:41-75): registered as a POTENTIAL, it moves positions and
velocities, so it runs as a post-drift hook of the step, not as a force
term.  Its decks are the slabs with a non-periodic z axis (pbc < 7).
"""

from __future__ import annotations

import torch


def reflect(state, box):
    """Mirror every particle past the +-Lz/2 faces back inside and flip
    its z velocity."""
    top = 0.5 * box.lengths[2]
    bot = -top
    z, vz = state.r[:, 2], state.v[:, 2]
    over, under = z > top, z < bot
    z_new = torch.where(over, 2.0 * top - z,
                        torch.where(under, 2.0 * bot - z, z))
    vz_new = torch.where(over | under, -vz, vz)
    return state.replace(r=torch.cat([state.r[:, :2], z_new[:, None]], 1),
                         v=torch.cat([state.v[:, :2], vz_new[:, None]], 1))
