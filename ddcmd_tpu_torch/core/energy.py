"""Energy/virial/temperature accounting (ETYPE equivalent).

Counterpart of ddcmd_tpu/core/energy.py (kinetic_terms, ddcMD
src/energy.c:48-160; eval_energyInfo, src/energyInfo.c:75-160).  Global
scalars are masked reductions that stay on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class EnergyInfo:
    """Global (per-step) energy accounting; virials are 3x3 symmetric."""

    eion: torch.Tensor       # potential energy (kJ/mol), summed
    rk: torch.Tensor         # kinetic energy
    virial: torch.Tensor     # (3,3) configurational virial: sum f_ij (x) r_ij
    tion: torch.Tensor       # (3,3) kinetic tensor: sum m v (x) v
    number: torch.Tensor     # particle count (float)

    @classmethod
    def zero(cls, dtype=torch.float32, device="cpu") -> "EnergyInfo":
        z = torch.zeros((), dtype=dtype, device=device)
        z33 = torch.zeros((3, 3), dtype=dtype, device=device)
        return cls(eion=z, rk=z, virial=z33, tion=z33, number=z)


def kinetic_terms(v, mass, fmask):
    """Masked kinetic energy + kinetic tensor (energy.c:48).

    Returns (rk, tion) where tion[a,b] = sum_i m_i v_ia v_ib.
    """
    mv = (mass * fmask)[:, None] * v          # (N,3)
    tion = mv.T @ v                            # (3,3), full f32 (TF32 off)
    rk = 0.5 * torch.trace(tion)
    return rk, tion
