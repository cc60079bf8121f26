"""Voronoi-centre domains over the fixed brick mesh.

Counterpart of ddcmd_tpu/parallel/voronoi.py.  The reference assigns
each particle to the NEAREST domain centre (voronoiCalcParticle-
Destinations, ddcMD src/ddcAssignment.c:105-147; domainset_particle,
src/domain.c:165-190) and balances load by moving the centres
(voronoiLoadBalance, loadBalance.c:65-68).  The mesh's communication
graph is the fixed brick neighbourhood, so the centres are clamped to a
displacement box about their brick's centre that keeps every Voronoi
cell inside its brick's 26 neighbours: (1 + beta) |a| < (3 - beta)
a_min, a the brick edges.  Halo windows widen by each axis's bisector
margin (face_margins, a certified upper bound of the cells' excursion
beyond the nominal faces); migration routes a row to its nearest of the
27 neighbourhood centres.  Under a triclinic box every function here
works in the scaled-fractional frame (the fraction s = h^-1 r times the
perpendicular spans, where a tilted box is Euclidean): the callers
(parallel/brick.py, run/parallel_sim.py) pass positions, centres and the
spans of that frame as `r` and `box_lengths` (the JAX package's
parallel_sim.py:150-151).

The host half (nominal_centers, beta_max, face_margins, clamp_centers,
balance_step, assign_host) is the JAX package's numpy, copied
statement for statement (tests/test_torch_host.py holds them equal);
neighborhood_centers and dest_offsets run in torch on the rank's
device and take the rank's brick index from parallel/mesh.BrickMesh.
"""

from __future__ import annotations

import numpy as np
import torch

OFFSETS = np.array([(dx, dy, dz)
                    for dx in (-1, 0, 1)
                    for dy in (-1, 0, 1)
                    for dz in (-1, 0, 1)], dtype=np.int32)   # (27, 3)
SELF_IDX = 13                                                # (0,0,0)


def nominal_centers(box_lengths, shape) -> np.ndarray:
    """(nx, ny, nz, 3) brick centers in origin-centered global coords."""
    L = np.asarray(box_lengths, dtype=np.float64)
    nx, ny, nz = shape
    ax = [(np.arange(n) + 0.5) / n * L[i] - 0.5 * L[i]
          for i, n in enumerate(shape)]
    gx, gy, gz = np.meshgrid(*ax, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1)


def beta_max(box_lengths, shape) -> float:
    """Largest per-axis center displacement fraction (of the half brick)
    that keeps every Voronoi cell inside its 26-neighborhood (docstring
    inequality).  0 when the bricks are too anisotropic for ANY motion."""
    a = np.asarray(box_lengths, dtype=np.float64) / np.asarray(shape)
    norm = float(np.sqrt(np.sum(a * a)))
    amin = float(np.min(a))
    b = (3.0 * amin - norm) / (norm + amin)
    return float(np.clip(b * 0.98, 0.0, 0.49))   # 2% slack off the bound


def _wrap_delta(d, L):
    return d - L * np.round(d / L)


def face_margins(centers: np.ndarray, box_lengths, shape,
                 n_samp: int = 49) -> np.ndarray:
    """(3,) per-axis max excursion of any Voronoi cell beyond its home
    brick's face planes.

    The cell boundary beyond the +ax face of brick b is the MIN over the
    9 (+1-along-ax) neighbors of their bisector planes with b's center
    -- the diagonal neighbors cut off the face-pair bisector's tilt, so
    taking only the face pair wildly overestimates.  depth(t) =
    min_j [(0.5 |d_j|^2 - t . d_jt) / d_ju + ci_ax - face] is concave
    piecewise-linear in the transverse point t; it is maximized by
    sampling an n_samp^2 grid over the (displacement-dilated) face
    rectangle and adding the Lipschitz safety max_j |d_jt|/d_ju * h/2
    of the grid spacing h, so the result is a certified upper bound."""
    L = np.asarray(box_lengths, dtype=np.float64)
    a = L / np.asarray(shape)
    nom = nominal_centers(L, shape)
    dmax = np.abs(centers - nom).reshape(-1, 3).max(axis=0)  # per-axis
    cflat = centers.reshape(-1, 3)
    idx3 = np.stack(np.indices(shape), axis=-1).reshape(-1, 3)
    strides = np.array([shape[1] * shape[2], shape[2], 1])
    delta_ax = cflat - nom.reshape(-1, 3)

    def once(dilate):
        margins = np.zeros(3)
        for ax in range(3):
            if shape[ax] == 1:
                continue
            tax = [k for k in range(3) if k != ax]
            t_half = [a[k] / 2 + dmax[k] + dilate[k] for k in tax]
            g0 = np.linspace(-t_half[0], t_half[0], n_samp)
            g1 = np.linspace(-t_half[1], t_half[1], n_samp)
            T0, T1 = np.meshgrid(g0, g1, indexing="ij")
            h = max(g0[1] - g0[0], g1[1] - g1[0])
            for sign in (1, -1):
                depth = np.full((len(cflat),) + T0.shape, np.inf)
                lip = np.zeros(len(cflat))
                for o0 in (-1, 0, 1):
                    for o1 in (-1, 0, 1):
                        off = np.zeros(3, dtype=np.int64)
                        off[ax] = sign
                        off[tax[0]] = o0
                        off[tax[1]] = o1
                        raw = idx3 + off
                        jidx = raw % np.asarray(shape)
                        img = (raw - jidx) // np.asarray(shape)
                        j = jidx @ strides
                        # explicit periodic image of the neighbor (index
                        # arithmetic, NOT min-image: with 2 bricks/axis
                        # both images are distinct real neighbors)
                        d = cflat[j] + img * L[None, :] - cflat
                        du = sign * d[:, ax]       # toward the face (>0)
                        tdot = (T0[None] * d[:, tax[0], None, None]
                                + T1[None] * d[:, tax[1], None, None])
                        xu = (0.5 * np.sum(d * d, axis=1)[:, None, None]
                              - sign * tdot) / du[:, None, None]
                        # t is measured from the brick-center axis line;
                        # the center's own transverse offset is covered
                        # by the dmax-dilated window
                        exc = (xu + sign * delta_ax[:, ax, None, None]
                               - a[ax] / 2.0)
                        depth = np.minimum(depth, exc)
                        lip = np.maximum(
                            lip, np.hypot(d[:, tax[0]], d[:, tax[1]]) / du)
                m = float((depth.max(axis=(1, 2)) + lip * h * 0.71).max())
                margins[ax] = max(margins[ax], m)
        return np.maximum(margins, 0.0)

    # fixed point on the transverse window (the cell's own excursion
    # widens where neighbors' bisectors must be sampled)
    m = once(0.25 * a)
    for _ in range(3):
        m2 = once(np.maximum(0.25 * a, 1.1 * m))
        if np.all(m2 <= m * 1.01 + 1e-12):
            return np.maximum(m, m2)
        m = m2
    return m


def clamp_centers(centers: np.ndarray, box_lengths, shape,
                  rlist: float) -> tuple[np.ndarray, np.ndarray]:
    """Project centers into the ownership displacement box and shrink
    until the halo-window constraints hold:
      W = rlist + margin <= brick width  (1-hop staged windows)
      2*a - 2*margin > rlist             (non-neighbor cells can't touch)
    Returns (clamped centers, (3,) margins)."""
    L = np.asarray(box_lengths, dtype=np.float64)
    a = L / np.asarray(shape)
    nom = nominal_centers(L, shape)
    b = beta_max(L, shape)
    lim = b * a / 2.0
    # axes with <3 bricks have no non-neighbor bricks, but margins still
    # widen halo windows; keep displacement there too (lim applies)
    disp = np.clip(centers - nom, -lim, lim)
    for _ in range(24):
        m = face_margins(nom + disp, L, shape)
        if np.all(rlist + m <= a) and np.all(2 * a - 2 * m > rlist):
            break
        disp *= 0.7
    else:
        disp[:] = 0.0
        m = np.zeros(3)
    return nom + disp, m


def balance_step(centers: np.ndarray, r: np.ndarray, box_lengths,
                 shape, rlist: float, eta: float = 0.5,
                 inner_iters: int = 4):
    """Density-weighted Lloyd update: each center moves toward the mass
    centroid of its own cell, then is re-clamped into the ownership
    displacement box.  Dense regions pull the surrounding centers in, so
    cells there SHRINK and counts flatten -- the centroidal scheme the
    reference seeds from bisection centroids (recursive_bisection_domset,
    ddcMD src/domain.c:366-401; a pure count-diffusion rule is
    degenerate on 2-brick axes where +1/-1 reach the same rank).

    r: (N, 3) ALL particle positions (the host rebalance path gathers
    them anyway for redistribution).  Returns (centers, margins)."""
    L = np.asarray(box_lengths, dtype=np.float64)
    a = L / np.asarray(shape)
    cur = centers
    margins = face_margins(cur, L, shape)
    for _ in range(inner_iters):
        dest = assign_host(r, cur, L, shape)
        counts = np.bincount(dest, minlength=int(np.prod(shape)))
        nbar = counts.mean()
        cf = cur.reshape(-1, 3)
        new = cf.copy()
        for d in range(len(cf)):
            sel = dest == d
            if not sel.any():
                # empty cell: advance toward the global load centroid
                dr = _wrap_delta(r - cf[d], L).mean(axis=0)
            else:
                dr = _wrap_delta(r[sel] - cf[d], L).mean(axis=0)
            nrm = np.linalg.norm(dr)
            if nrm < 1e-12:
                continue
            u = dr / nrm
            # a center RETREATS from its cell's mass when overloaded
            # (its bisectors recede, neighbors advance into the load)
            # and ADVANCES toward it when underloaded
            s = (nbar - counts[d]) / (nbar + counts[d] + 1.0)
            new[d] = cf[d] + eta * s * a.min() * 0.5 * u
        cur, margins = clamp_centers(new.reshape(cur.shape), L, shape,
                                     rlist)
    return cur, margins


def assign_host(r: np.ndarray, centers: np.ndarray, box_lengths,
                shape) -> np.ndarray:
    """Host-exact nearest-center owner (flat device id) per particle
    (domainset_particle over the full set, min image)."""
    L = np.asarray(box_lengths, dtype=np.float64)
    cf = centers.reshape(-1, 3)
    dest = np.zeros(len(r), dtype=np.int64)
    best = np.full(len(r), np.inf)
    for d in range(len(cf)):
        dr = _wrap_delta(np.asarray(r, dtype=np.float64) - cf[d], L)
        d2 = np.sum(dr * dr, axis=1)
        upd = d2 < best
        best[upd] = d2[upd]
        dest[upd] = d
    return dest


def neighborhood_centers(centers, box_lengths, shape, idx3):
    """(27, 3) centres of brick idx3's neighbourhood in its own frame
    (periodic images shifted by the box), in OFFSETS order, from the
    (nx, ny, nz, 3) centres tensor at the live box."""
    L = box_lengths
    rows = []
    for off in OFFSETS:
        raw = [int(idx3[k]) + int(off[k]) for k in range(3)]
        wrapped = [raw[k] % shape[k] for k in range(3)]
        img = torch.tensor([(raw[k] - wrapped[k]) // shape[k]
                            for k in range(3)], dtype=L.dtype,
                           device=L.device)
        rows.append(centers[wrapped[0], wrapped[1], wrapped[2]] + img * L)
    return torch.stack(rows)


def dest_offsets(r, c27, box_lengths):
    """(N, 3) int64 per-axis hop (-1, 0, +1) to the nearest neighbourhood
    centre, (0, 0, 0) staying.  Distances take the minimum image per
    candidate: on a 2-brick axis a particle can be nearest to an image
    absent from the table, and the minimum image folds it onto the
    tabled entry of the same brick, as assign_host does."""
    d = r[:, None, :] - c27[None, :, :].to(r.dtype)
    d = d - box_lengths * torch.round(d / box_lengths)
    best = torch.argmin(torch.sum(d * d, dim=-1), dim=1)
    return torch.as_tensor(OFFSETS, dtype=torch.int64, device=r.device)[best]
