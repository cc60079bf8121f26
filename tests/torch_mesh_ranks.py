"""Multi-rank helpers for tests/test_torch_mesh.py: spawn one process per
brick over gloo and run a rank function in each.

This module imports torch and the port only (never jax): the spawned
children import it to find their target, so a test module that imports
jax stays out of them.
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT = 120.0      # s for all ranks of one run


def _entry(fn, rank, world, rdv, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_dir, *args, timeout=JOIN_TIMEOUT):
    """fn(rank, *args) in `world` spawned gloo ranks (a file:// rendezvous
    in tmp_dir).  Every rank is joined within `timeout` seconds all told
    or killed; raises unless all exit 0."""
    rdv = os.path.join(str(tmp_dir), f"rdv_{fn.__name__}")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, rdv, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise TimeoutError(f"ranks {hung} of {world} still running after "
                           f"{timeout} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes}")


def _psim(deck_dir, shape):
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    return ParallelSimulation(*load(deck_dir), shape=shape, device="cpu")


def halo_invariants(rank, deck_dir, shape, out):
    """The frozen-routing refresh reproduces the exchange's ghosts, and
    the reverse reduce of one unit per valid ghost row lands on exactly
    its source rows (tests/test_pallas_shard.py:83-123)."""
    from ddcmd_tpu_torch.parallel.brick import (halo_exchange_3d,
                                                halo_reduce_3d,
                                                halo_refresh_3d)

    ps = _psim(deck_dir, shape)
    f, m, plan, mesh = ps.fields, ps.mask, ps.plan, ps.mesh
    Lv = ps.step_fn.Lv
    ghosts, gmask, ov, routing = halo_exchange_3d(
        {k: f[k] for k in ("r", "q")}, m, Lv, plan, mesh)
    pool_r = halo_refresh_3d(f["r"], routing, plan, mesh)
    same = torch.where(gmask[:, None], pool_r[m.shape[0]:] - ghosts["r"], 0.0)
    ship = torch.cat([torch.zeros((m.shape[0], 1)), gmask[:, None].float()])
    copies = halo_reduce_3d(ship, routing, plan, m.shape[0], mesh)
    np.savez(f"{out}_{rank}.npz", ov=bool(ov), same=float(same.abs().max()),
             copies=copies.numpy(), n_ghost=int(gmask.sum()),
             mask=m.numpy())


def first_forces(rank, deck_dir, shape, out):
    """First forces (gathered by gid), energy and virial of the mesh."""
    ps = _psim(deck_dir, shape)
    ps.f, e, virial, ov = ps.step_fn.first_forces(ps.fields, ps.mask)
    g = ps.gather_by_gid(("f",))
    if rank == 0:
        np.savez(out, e=float(e), virial=virial.numpy(), ov=bool(ov),
                 f=g["f"], ncore=np.asarray(ps.cplan.ncore))


def _owned_gids(ps) -> np.ndarray:
    """Every rank's owned gids, mesh-wide, in rank order (duplicates
    kept)."""
    m = ps.mesh.all_gather(ps.mask.to(torch.int64)).numpy().reshape(-1)
    g = ps.mesh.all_gather(ps.fields["gid"]).numpy().reshape(-1)
    return g[m.astype(bool)]


def chunk_migrate(rank, deck_dir, shape, out):
    """Chunks with migration: the owned gids mesh-wide before and after
    (so a row duplicated and another lost cannot hide in the count), the
    rows that changed brick, finite scalars and forces."""
    ps = _psim(deck_dir, shape)
    gids0 = _owned_gids(ps)
    gid0 = set(ps.fields["gid"][ps.mask].tolist())
    ps.first_energy()
    ps.run(4 * ps.chunk_steps)
    gids1 = _owned_gids(ps)
    gid1 = set(ps.fields["gid"][ps.mask].tolist())
    moved = torch.tensor([len(gid1 - gid0)], dtype=torch.int64)
    n = ps.mesh.psum(ps.mask.sum().reshape(1))
    moved = ps.mesh.psum(moved)
    if rank == 0:
        np.savez(out, n=int(n[0]), moved=int(moved[0]), loop=ps.loop,
                 gids0=gids0, gids1=gids1,
                 finite=bool(torch.isfinite(ps.f[ps.mask]).all()))


def bilayer_npt(rank, deck_dir, shape, out, npt=True):
    """The bilayer through the mesh: first forces (gathered by gid) and
    energy; with `npt`, one NPT step from the first state (its box
    against barostat_scale on the same virial), then one NPT chunk with
    migration: every rank's owned (gid, head gid), the constraint
    residual and the box after it."""
    from ddcmd_tpu_torch.core.box import Box
    from ddcmd_tpu_torch.integrators.constraints import constraint_residual
    from ddcmd_tpu_torch.integrators.nglf import barostat_scale

    ps = _psim(deck_dir, shape)
    e = ps.first_energy()
    g = ps.gather_by_gid(("f",))
    if not npt:
        if rank == 0:
            np.savez(out, e=e, f=g["f"], excl=ps.step_fn.excl,
                     npt=ps.barostat is not None)
        return
    st = ps.step_fn
    _, _, _, _, L1, _, ov1 = st.chunk_npt(ps.fields, ps.mask, ps.f, ps.vird,
                                          ps.Lv, ps.loop, steps=1)
    box0 = Box.from_h(np.diag(ps.Lv.numpy()))
    _, box1 = barostat_scale(ps.sysdef.state, box0, torch.diag(ps.vird),
                             ps.barostat, ps.sysdef.cfg.dt)
    lines = []
    ps.run(ps.chunk_steps, print_fn=lines.append)
    m = ps.mesh.all_gather(ps.mask.to(torch.int64)).numpy().reshape(-1)
    owned = m.astype(bool)
    gids = ps.mesh.all_gather(ps.fields["gid"]).numpy().reshape(-1)[owned]
    hgids = ps.mesh.all_gather(ps.fields["hgid"]).numpy().reshape(-1)[owned]
    where = np.repeat(np.arange(ps.mesh.size), ps.plan.local_cap)[owned]
    r = ps.gather_by_gid(("r",))["r"]
    if rank == 0:
        bt = ps.sysdef.bonded
        resid = constraint_residual(
            SimpleNamespace(r=r), bt.cons_atoms, bt.cons_pairs,
            bt.cons_dist, box_lengths=ps.Lv.numpy())
        np.savez(out, e=e, f=g["f"], L1=L1.numpy(),
                 L1_ref=box1.lengths.numpy(), ov1=bool(ov1),
                 gids=gids, hgids=hgids, where=where, resid=resid,
                 L=ps.Lv.numpy(), loop=ps.loop, chunk=ps.chunk_steps,
                 excl=ps.step_fn.excl, npt=ps.barostat is not None,
                 finite=bool(torch.isfinite(ps.f[ps.mask]).all()),
                 n_lines=len(lines))


def affine_run(rank, deck_dir, shape, steps, out):
    """The first energy, then `steps` steps of the mesh: positions and
    velocities gathered by gid."""
    ps = _psim(deck_dir, shape)
    e = ps.first_energy()
    ps.run(steps)
    g = ps.gather_by_gid(("r", "v"))
    if rank == 0:
        np.savez(out, e=e, r=g["r"], v=g["v"], loop=ps.loop,
                 L=ps.Lv.numpy())
