"""RESTRAINT potential: harmonic positional restraints.

Counterpart of ddcmd_tpu/potentials/restraint.py (reference ddcMD
src/restraint.c).  Deck: `restraint POTENTIAL {type=RESTRAINT;
parmfile=restraint.data;}`, the parmfile holding a RESTRAINTLIST object
whose entries are `RESTRAINTPARMS {gid=..; kb=..; x0/y0/z0; fcx/fcy/fcz}`.
Energy kb (r - r0)^2 per restrained atom (CHARMM convention, no 1/2).
compile_restraint is host numpy, copied from the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.box import nearest_image
from ..objects import DeckError, ObjectDB


@dataclass
class RestraintParms:
    gids: np.ndarray       # (m,) uint64 restrained atoms
    r0: np.ndarray         # (m,3) anchors, internal
    kb: np.ndarray         # (m,) spring constants
    axis_mask: np.ndarray  # (m,3) 1.0 where the axis is restrained


def compile_restraint(db: ObjectDB, name: str) -> RestraintParms | None:
    pot = db.get(name, "POTENTIAL")
    parmfile = pot.get_str("parmfile", "restraint.data")
    lists = db.by_class("RESTRAINTLIST")
    if not lists:
        raise DeckError(f"{name}: no RESTRAINTLIST object (compile {parmfile})")
    entries = lists[0].get_strv("restraintList")
    if not entries:
        return None
    gids, r0s, kbs, masks = [], [], [], []
    for ename in entries:
        e = db.get(ename, "RESTRAINTPARMS")
        gids.append(e.get_int("gid"))
        r0s.append([e.get_with_units("x0", "0.0", "l"),
                    e.get_with_units("y0", "0.0", "l"),
                    e.get_with_units("z0", "0.0", "l")])
        kbs.append(e.get_with_units("kb", "0.0", "energy/l^2"))
        masks.append([float(e.get_int("fcx", 1)), float(e.get_int("fcy", 1)),
                      float(e.get_int("fcz", 1))])
    return RestraintParms(
        gids=np.asarray(gids, dtype=np.uint64),
        r0=np.asarray(r0s, dtype=np.float64),
        kb=np.asarray(kbs, dtype=np.float64),
        axis_mask=np.asarray(masks, dtype=np.float64))


def restraint_eval(r, box_geom, rows, r0, kb, axis_mask):
    """Harmonic restraints on the given state rows; returns (f, e,
    virial, pe).  box_geom: (3,) lengths or a (3,3) h."""
    n_pad = r.shape[0]
    dr = nearest_image(r[rows] - r0, box_geom.to(r.dtype)) * axis_mask
    e_i = kb * (dr * dr).sum(-1)
    f_i = -2.0 * kb[:, None] * dr
    f = torch.zeros((n_pad, 3), dtype=r.dtype, device=r.device)
    f.index_add_(0, rows, f_i)
    pe = torch.zeros((n_pad,), dtype=r.dtype, device=r.device)
    pe.index_add_(0, rows, e_i)
    return f, e_i.sum(), f_i.T @ dr, pe
