"""Particle state: fixed-capacity padded SoA of tensors.

Counterpart of ddcmd_tpu/core/state.py.  Arrays hold `n_pad` rows
(`pad_to`), of which the first `n_local` are particles; `mask`/`fmask`
mark them.  Padding keeps every shape static across rebuilds, as in the
JAX package, so the pair kernel's slot layout and the per-step tensors
never reallocate.

Positions/velocities/forces are (n_pad, 3) in internal units (nm, nm/ps).
The 64-bit global ids stay on the host (numpy uint64): no device code of
the ported path reads them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


def pad_to(n: int, multiple: int = 128) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass
class State:
    r: torch.Tensor          # (n_pad, 3) positions
    v: torch.Tensor          # (n_pad, 3) velocities
    f: torch.Tensor          # (n_pad, 3) forces (filled by energy eval)
    pe: torch.Tensor         # (n_pad,) per-particle potential energy
    q: torch.Tensor          # (n_pad,) charge
    mass: torch.Tensor       # (n_pad,) mass (1 on padding rows)
    species: torch.Tensor    # (n_pad,) int64 species index
    group: torch.Tensor      # (n_pad,) int64 group index
    gid: np.ndarray          # (n_pad,) uint64 global ids (host)
    n_local: int

    @property
    def n_pad(self) -> int:
        return self.r.shape[0]

    @property
    def device(self) -> torch.device:
        return self.r.device

    @property
    def mask(self) -> torch.Tensor:
        return torch.arange(self.n_pad, device=self.device) < self.n_local

    @property
    def fmask(self) -> torch.Tensor:
        return self.mask.to(self.r.dtype)

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)

    @classmethod
    def create(cls, r, v, q, mass, species, group, gid, *,
               dtype=torch.float32, device="cpu",
               pad_multiple: int = 128) -> "State":
        r = np.asarray(r, dtype=np.float64).reshape(-1, 3)
        n = r.shape[0]
        n_pad = pad_to(max(n, 1), pad_multiple)

        def padf(a, shape_tail=()):
            a = np.asarray(a, dtype=np.float64).reshape((n,) + shape_tail)
            out = np.zeros((n_pad,) + shape_tail, dtype=np.float64)
            out[:n] = a
            return torch.as_tensor(out, dtype=dtype, device=device)

        def padi(a):
            out = np.zeros(n_pad, dtype=np.int64)
            out[:n] = np.asarray(a, dtype=np.int64).reshape(n)
            return torch.as_tensor(out, device=device)

        gid_pad = np.zeros(n_pad, dtype=np.uint64)
        gid_pad[:n] = np.asarray(gid, dtype=np.uint64).reshape(n)

        # padded slots get unit mass so 1/mass is finite everywhere
        mass_pad = np.ones(n_pad)
        mass_pad[:n] = np.asarray(mass, dtype=np.float64)

        return cls(
            r=padf(r, (3,)),
            v=padf(v, (3,)),
            f=torch.zeros((n_pad, 3), dtype=dtype, device=device),
            pe=torch.zeros((n_pad,), dtype=dtype, device=device),
            q=padf(q),
            mass=torch.as_tensor(mass_pad, dtype=dtype, device=device),
            species=padi(species),
            group=padi(group),
            gid=gid_pad,
            n_local=int(n),
        )
