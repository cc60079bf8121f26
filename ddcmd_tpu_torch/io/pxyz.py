"""pxyz files: the domain decomposition of a checkpoint.

A copy of ddcmd_tpu/io/pxyz.py (reference ddc_writePXYZ.c / readPXYZ.c:
per-rank domain centres written at each checkpoint so that a restart
reproduces the decomposition), in the same text format.  The file
records the mesh shape, the brick centres and, when the run is load
balanced, the wall fractions (tensor or ORCB plans) so that a restart of
a balanced run resumes the saved walls (readPXYZ.c:1-50).  A
Simulation's snapshot records one domain, a slab plan (parallel/
slab.py) the mesh shape n 1 1.  Two divergences: restore_plan_lb warns
when a pxyz exists but cannot be read, where the JAX package returns "no
saved state" in silence; and a slab plan's walls are written as the x
walls of an (n, 1, 1) tensor plan, which a restart reads back.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from ..objects import ObjectDB
from ..objects import units as U


def _fmt(arr):
    return " ".join(f"{float(x):.12g}" for x in np.asarray(arr).ravel())


def write_pxyz(path: str, box_lengths, plan=None) -> None:
    """plan: None (single domain), parallel.slab.SlabPlan, or
    parallel.brick.BrickPlan (whose walls/voronoi state, when set, is
    serialized for restart)."""
    L = np.asarray(box_lengths, dtype=np.float64) * U.LENGTH_TO_ANG
    walls = getattr(plan, "walls", None)
    voronoi = getattr(plan, "voronoi", None)
    if plan is None:
        shape = (1, 1, 1)
    elif hasattr(plan, "shape"):
        shape = tuple(plan.shape)
    else:
        # a slab plan: the mesh (n, 1, 1), its walls the x walls of that
        # mesh's tensor plan (the JAX package writes a line per fraction,
        # which its reader cannot take back)
        shape = (plan.n_dev, 1, 1)
        if walls is not None:
            walls = (tuple(walls), (0.0, 1.0), (0.0, 1.0))
    nx, ny, nz = shape
    centers = []
    if voronoi is not None:
        # live balanced centers, in the lb frame scaled to Ang
        c = np.asarray(voronoi["centers"], dtype=np.float64).reshape(-1, 3)
        centers = list(c * U.LENGTH_TO_ANG)
    else:
        for i in range(nx):
            for j in range(ny):
                for k in range(nz):
                    c = (np.array([i, j, k]) + 0.5) / np.array(shape) - 0.5
                    centers.append(c * L)
    lb = ("voronoi" if voronoi is not None else
          "walls" if walls is not None else "none")
    with open(path, "w") as f:
        f.write(f"pxyz PXYZ {{ nrecord={len(centers)}; shape={nx} {ny} {nz}; "
                f"units=Ang; lb={lb}; }}\n")
        for d, c in enumerate(centers):
            f.write(f"{d:6d} {c[0]:16.8f} {c[1]:16.8f} {c[2]:16.8f}\n")
        if walls is not None:
            # per-axis wall FRACTIONS, one line per axis:
            #   wall <axis> <ndim> <shape...> <flat values...>
            # (tensor axes are 1-D; hierarchical ORCB y/z walls are
            # (nx, ny+1) / (nx, ny, nz+1) and flatten row-major)
            for a, w in enumerate(walls):
                w = np.asarray(w, dtype=np.float64)
                shp = " ".join(str(s) for s in w.shape)
                f.write(f"wall {a} {w.ndim} {shp} {_fmt(w)}\n")
        if voronoi is not None:
            f.write(f"margins {_fmt(np.asarray(voronoi['margins']) * U.LENGTH_TO_ANG)}\n")
            f.write(f"L0 {_fmt(np.asarray(voronoi['L0']) * U.LENGTH_TO_ANG)}\n")


def read_pxyz(path: str):
    """Returns (shape tuple, centers (n,3) internal units)."""
    full = read_pxyz_full(path)
    return full["shape"], full["centers"]


def read_pxyz_full(path: str) -> dict:
    """Full decomposition state: dict with shape, centers, and -- when
    present -- walls (tuple of per-axis fraction arrays, matching
    BrickPlan.walls shapes) and voronoi (dict centers/margins/L0 in
    internal units, centers still flat (n_dev, 3))."""
    with open(path) as f:
        lines = f.read().splitlines()
    db = ObjectDB().compile_string(lines[0])
    hdr = db.by_class("PXYZ")[0]
    shape = tuple(int(x) for x in hdr.get_strv("shape"))
    lb = hdr.get_str("lb", "none")
    centers = []
    walls_by_axis: dict[int, np.ndarray] = {}
    margins = None
    L0 = None
    for line in lines[1:]:
        toks = line.split()
        if not toks:
            continue
        if toks[0] == "wall":
            a = int(toks[1])
            nd = int(toks[2])
            shp = tuple(int(t) for t in toks[3:3 + nd])
            vals = np.asarray([float(t) for t in toks[3 + nd:]])
            walls_by_axis[a] = vals.reshape(shp)
        elif toks[0] == "margins":
            margins = np.asarray([float(t) for t in toks[1:]]) * U.ANG_TO_LENGTH
        elif toks[0] == "L0":
            L0 = np.asarray([float(t) for t in toks[1:]]) * U.ANG_TO_LENGTH
        elif len(toks) >= 4:
            centers.append([float(t) * U.ANG_TO_LENGTH for t in toks[1:4]])
    out = dict(shape=shape, centers=np.asarray(centers), lb=lb)
    if walls_by_axis:
        out["walls"] = tuple(walls_by_axis.get(a) for a in range(3))
    if lb == "voronoi":
        out["voronoi"] = dict(
            centers=out["centers"],
            margins=margins if margins is not None else np.zeros(3),
            L0=L0)
    return out


def restore_plan_lb(pxyz_path: str, shape, lb_kind: str | None):
    """Restart hook: when the snapshot's pxyz matches this run's mesh
    shape and balancer family, return the saved (walls, voronoi) to
    install in the BrickPlan; (None, None) otherwise.  The decomposition
    then resumes exactly where the balanced run checkpointed instead of
    recomputing a fresh one (readPXYZ.c restart of domain centers)."""
    if not os.path.exists(pxyz_path) or lb_kind is None:
        return None, None
    try:
        full = read_pxyz_full(pxyz_path)
    except Exception as err:
        # the one divergence from the JAX package, which returns "no saved
        # state" in silence here
        warnings.warn(f"{pxyz_path} exists but cannot be read "
                      f"({type(err).__name__}: {err}); the decomposition "
                      "is computed afresh", stacklevel=2)
        return None, None
    if tuple(full["shape"]) != tuple(shape):
        return None, None
    if lb_kind == "voronoi" and full.get("lb") == "voronoi":
        vor = full["voronoi"]
        nx, ny, nz = shape
        vor = dict(centers=np.asarray(vor["centers"]).reshape(nx, ny, nz, 3),
                   margins=np.asarray(vor["margins"]),
                   L0=np.asarray(vor["L0"]))
        return None, vor
    if lb_kind in ("tensor", "bisection") and full.get("lb") == "walls":
        walls = full.get("walls")
        if walls is None:
            return None, None
        hier = any(w is not None and np.asarray(w).ndim > 1 for w in walls)
        if hier != (lb_kind == "bisection"):
            return None, None
        return tuple(np.asarray(w) for w in walls), None
    return None, None
