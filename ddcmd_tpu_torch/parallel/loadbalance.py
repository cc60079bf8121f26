"""Load balancing: equal-work domain walls.

A copy of ddcmd_tpu/parallel/loadbalance.py (host numpy; importing the
JAX package imports jax), held statement for statement equal to it by
tests/test_torch_host.py.  Reference: the loadBalance.c registry with
the zRamp (zRampLoadBalance.c:55-239) and bisection (recbis ORCB)
balancers.  Domains are fixed-capacity bricks, so "balance" means
choosing the brick WALL positions so per-brick particle counts (and pair
work ~ density^2) equalize.

zramp_walls is the zRamp algorithm: bin the particle density along the
axis (optionally smeared), raise it to workPower (work ~ rho^2,
zRampLoadBalance.c:62-66), then integrate to equal-work wall positions
(findCenters, zRampLoadBalance.c:173-209).  tensor_walls applies it per
axis (the tensor-product ORCB a fixed brick topology admits);
orcb_walls is true recursive bisection with per-slab y walls and
per-column z walls.
"""

from __future__ import annotations

import numpy as np


def _density(x, lo, length, nz, smear_radius=0.0, smear="impulse"):
    """Binned density along one axis (computeDensity,
    zRampLoadBalance.c:73-171); x in [lo, lo+length)."""
    r = (x - lo) * nz / length
    bins = np.zeros(nz)
    if smear_radius <= 0:
        idx = np.clip(r.astype(int), 0, nz - 1)
        np.add.at(bins, idx, 1.0)
        return bins
    l_smear = min(2.0 * smear_radius * nz / length, 1.0)
    inv = 1.0 / l_smear
    wall = np.floor(r + 0.5)
    delta = np.clip(wall - r, -0.5 * l_smear, 0.5 * l_smear)
    if smear == "hat":
        w0 = 0.5 + 2 * delta * inv * (1.0 - np.abs(delta) * inv)
    else:
        w0 = 0.5 + delta * inv
    i0 = (wall.astype(int) - 1) % nz
    i1 = wall.astype(int) % nz
    np.add.at(bins, np.clip(i0, 0, nz - 1), w0)
    np.add.at(bins, np.clip(i1, 0, nz - 1), 1.0 - w0)
    return bins


def _equal_work_walls(density, n_dev):
    """Wall positions (in bin units) splitting the density into n_dev
    equal integrals (findCenters walls loop, zRampLoadBalance.c:180-209)."""
    nz = len(density)
    total = density.sum()
    target = total / n_dev
    walls = np.zeros(n_dev + 1)
    for ii in range(n_dev - 1):
        fpos = walls[ii]
        ipos = int(np.floor(fpos))
        acc = 0.0
        delta = 0.0
        while True:
            weight = 1.0 - (fpos - np.floor(fpos))
            if ipos >= nz or acc + density[ipos] * weight > target:
                break
            acc += density[ipos] * weight
            delta += weight
            ipos += 1
            fpos = ipos
        frac = (target - acc) / max(density[min(ipos, nz - 1)], 1e-300)
        walls[ii + 1] = walls[ii] + delta + min(max(frac, 0.0), 1.0)
    walls[n_dev] = nz
    return walls / nz


def zramp_walls(x, lo, length, n_dev, *, nz=0, smear_radius=0.0,
                smear="impulse", work_power=2):
    """Equal-work wall FRACTIONS (n_dev+1,) in [0,1] along one axis.

    work_power=2 reproduces the reference's work ~ density^2 weighting;
    use 1 for pure count balancing.
    """
    nz = nz or max(8 * n_dev, 64)
    d = _density(np.asarray(x, dtype=np.float64), lo, length, nz,
                 smear_radius, smear)
    w = d ** work_power
    if w.sum() <= 0:
        return np.linspace(0.0, 1.0, n_dev + 1)
    walls = _equal_work_walls(w, n_dev)
    walls[0], walls[-1] = 0.0, 1.0
    return walls


def tensor_walls(r, box_lengths, shape, **kw):
    """Per-axis equal-count walls for a brick mesh (tensor-product ORCB)."""
    out = []
    for ax, n in enumerate(shape):
        L = float(box_lengths[ax])
        out.append(zramp_walls(np.asarray(r)[:, ax], -0.5 * L, L, n, **kw))
    return out


def _split_fracs(f, weight, n_dev):
    """Equal-weight wall FRACTIONS (n_dev+1,) in [0,1] for samples f in
    [0,1]: weighted-quantile splits (the recursive-bisection split step,
    ddcMD src/bisectionCalc.c:45-98 computes the same median
    plane per level, by trial bisection on the work integral)."""
    walls = np.linspace(0.0, 1.0, n_dev + 1)
    if len(f) == 0:
        return walls
    order = np.argsort(f)
    fs = f[order]
    w = (np.ones(len(f)) if weight is None else
         np.asarray(weight, dtype=np.float64)[order])
    cw = np.cumsum(w)
    total = cw[-1]
    if total <= 0:
        return walls
    for k in range(1, n_dev):
        j = int(np.searchsorted(cw, total * k / n_dev))
        j = min(j, len(fs) - 1)
        # split halfway between the straddling samples so neither sits
        # exactly on a wall (ownership ties)
        hi = fs[j]
        lo = fs[j - 1] if j > 0 else 0.0
        walls[k] = 0.5 * (lo + hi)
    return np.maximum.accumulate(walls)


def orcb_walls(r, box_lengths, shape, *, work=None, min_frac=None):
    """TRUE orthogonal recursive coordinate bisection for a brick mesh:
    x walls are global, y walls are computed PER x-slab, z walls per
    (x, y) column -- the hierarchical domain tree of the reference's
    bisection balancer (ddcMD src/bisectionCalc.c:7-136),
    restricted to the mesh's fixed split order so the staged x->y->z
    ppermute halo exchange stays valid (each phase's sender and receiver
    share the same wall set).

    Returns (wx (nx+1,), wy (nx, ny+1), wz (nx, ny, nz+1)) fraction
    arrays.  Unlike tensor_walls this equalizes NON-separable density
    (droplets, bilayers-in-vacuum, shock fronts): per-leaf counts are
    balanced exactly up to the min-width clamp.

    min_frac: optional per-axis minimum brick width as a fraction of the
    axis (1-hop halos need every brick wider than rlist)."""
    nx, ny, nz = shape
    r = np.asarray(r, dtype=np.float64)
    L = np.asarray(box_lengths, dtype=np.float64)
    f = r / L[None, :] + 0.5
    f = f - np.floor(f)                       # wrap into [0,1)
    w = None if work is None else np.asarray(work, dtype=np.float64)
    mf = (0.0, 0.0, 0.0) if min_frac is None else tuple(min_frac)

    wx = clamp_walls(_split_fracs(f[:, 0], w, nx), mf[0])
    wy = np.zeros((nx, ny + 1))
    wz = np.zeros((nx, ny, nz + 1))
    for i in range(nx):
        si = (f[:, 0] >= wx[i]) & (f[:, 0] < wx[i + 1])
        wy[i] = clamp_walls(
            _split_fracs(f[si, 1], None if w is None else w[si], ny), mf[1])
        for j in range(ny):
            sj = si & (f[:, 1] >= wy[i, j]) & (f[:, 1] < wy[i, j + 1])
            wz[i, j] = clamp_walls(
                _split_fracs(f[sj, 2], None if w is None else w[sj], nz),
                mf[2])
    return wx, wy, wz


def walls_assign(f, walls, shape):
    """Owning (ix, iy, iz) per particle for hierarchical OR tensor walls;
    f: (n, 3) box fractions in [0, 1)."""
    nx, ny, nz = shape
    wx, wy, wz = [np.asarray(w) for w in walls]
    cx = np.clip(np.searchsorted(wx[1:-1], f[:, 0], side="right"), 0, nx - 1)
    cy = np.empty(len(f), dtype=np.int64)
    cz = np.empty(len(f), dtype=np.int64)
    for i in range(nx):
        si = cx == i
        wyi = wy if wy.ndim == 1 else wy[i]
        cy[si] = np.clip(np.searchsorted(wyi[1:-1], f[si, 1], side="right"),
                         0, ny - 1)
        for j in range(ny):
            sj = si & (cy == j)
            wzij = wz if wz.ndim == 1 else wz[i, j]
            cz[sj] = np.clip(
                np.searchsorted(wzij[1:-1], f[sj, 2], side="right"),
                0, nz - 1)
    return cx, cy, cz


def clamp_walls(walls, min_frac):
    """Enforce a minimum wall spacing (1-hop halos need every domain
    wider than rlist): forward/backward projection keeping 0 and 1."""
    w = np.asarray(walls, dtype=np.float64).copy()
    n = len(w) - 1
    if min_frac * n > 1.0:
        return np.linspace(0.0, 1.0, n + 1)   # box too small: uniform
    for i in range(1, n + 1):
        w[i] = max(w[i], w[i - 1] + min_frac)
    w[-1] = 1.0
    for i in range(n - 1, 0, -1):
        w[i] = min(w[i], w[i + 1] - min_frac)
    return w
