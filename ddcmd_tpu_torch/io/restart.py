"""Checkpoint write: snapshot dir + atoms# shards + restart object file.

Counterpart of ddcmd_tpu/io/restart.py (reference writeRestart, ddcMD
src/io.c:58-114).  Properties kept: the restart file is itself an object
deck that participates in config compilation (both packages load it with
models.load(d, restart=...)); the `restart` symlink is replaced
atomically; the atoms# FILEHEADER is self-describing.

Each snapshot directory gets the phase profile table `profile`
(utils/profile.PROFILE; with DDCMD_PROFILE_PHASES set, the writer first
times the phases with the Simulation's profile_phases, as the JAX
package's io/restart.py:156-166 does) and the pxyz domain file
(io/pxyz.write_pxyz: one domain for a Simulation, the live BrickPlan of
the mesh, whose load-balanced walls a restart resumes).  Not written:
the JAX package's PRNG keyData (the port's thermostat noise is keyed by
deck seed, global step and the NaN rollback's attempt, core/groups.
kick_noise, so a restart at loop L replays the noise of loop L by
construction; a JAX run loaded from a port checkpoint draws from its
deck seed).
Integrator state beyond the box is written into the restart's INTEGRATOR
object, as the JAX package writes it (io/restart.py:134-141): NPTGLF's
zeta and NGLFNK's piston velocities bdot.
"""

from __future__ import annotations

import os

import numpy as np

from ..objects import units as U
from .collection import write_collection


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def write_snapshot(sim, run_dir: str = ".") -> str:
    """Lightweight trajectory dump at snapshotrate (writeBXYZ analog,
    ddcMD src/io.c:144): atoms shard + bxyz, no restart symlink update;
    with an ORDERSH term also its q{L}#000000 shards (and cluster.000000
    with clusterWrite=1; writeqlocal, ddcMD src/masters.c:348)."""
    snapdir = write_checkpoint(sim, run_dir, update_symlink=False)
    write_bxyz(sim, snapdir)
    if any(p[0] == "ORDERSH" for p in sim.sysdef.potentials):
        from ..potentials.ordersh import write_qlocal_files

        write_qlocal_files(sim, snapdir)
    return snapdir


def write_bxyz(sim, snapdir: str) -> str:
    """bxyz: compact binary per-particle dump (collection_writeBXYZ
    mode 1, ddcMD src/collection_write.c:338-410):
    checksum u4 | id b8 | pinfo b2 | rx ry rz vx vy vz energy virial f4
    in external units (Angstrom, Angstrom/fs, eV)."""
    sd = sim.sysdef
    ss = sim.ss
    n = sd.state.n_local
    r = _host(ss.state.r[:n]) * U.LENGTH_TO_ANG
    v = _host(ss.state.v[:n]) * (U.LENGTH_TO_ANG / U.TIME_TO_FS)
    pe = _host(ss.state.pe[:n]) / U.unit_scale("eV")
    gid = ss.state.gid[:n]
    col = sd.collection
    groups = [g.name for g in sd.groups]
    specs = [s.name for s in sd.species]
    smap = {s: i for i, s in enumerate(specs)}
    gmap = {g: i for i, g in enumerate(groups)}
    n_groups = max(1, len(groups))
    pinfo = np.array([smap.get(s, 0) * n_groups + gmap.get(g, 0)
                      for s, g in zip(col.species_names, col.group_names)],
                     dtype="<u2")
    lrec = 4 + 8 + 2 + 8 * 4
    recs = np.zeros((n, lrec), dtype=np.uint8)
    recs[:, 4:12] = gid.astype("<u8").view(np.uint8).reshape(n, 8)
    recs[:, 12:14] = pinfo.view(np.uint8).reshape(n, 2)
    payload = np.concatenate(
        [r, v, pe[:, None], np.zeros((n, 1))], axis=1).astype("<f4")
    recs[:, 14:] = payload.view(np.uint8).reshape(n, 32)
    from .fastio import crc32_rows

    recs[:, 0:4] = crc32_rows(recs, skip=4).astype("<u4").view(
        np.uint8).reshape(n, 4)
    path = os.path.join(snapdir, "bxyz#000000")
    hdr = (f"bxyz FILEHEADER {{type=FIXRECORDBINARY; lrec={lrec};"
           f" nrecord={n}; nfields=11; endian_key=875770417;\n"
           "field_names=checksum id pinfo rx ry rz vx vy vz energy virial;\n"
           "field_types=u4 b8 b2 f4 f4 f4 f4 f4 f4 f4 f4;\n"
           "field_units=1 1 1 Angstrom Angstrom Angstrom Angstrom/fs "
           "Angstrom/fs Angstrom/fs eV eV;\n"
           f"groups={' '.join(groups)};\nspecies={' '.join(specs)};\n}}\n\n")
    with open(path, "wb") as f:
        f.write(hdr.encode())
        f.write(recs.tobytes())
    return path


def write_checkpoint(sim, run_dir: str = ".", update_symlink: bool = True,
                     atoms_writer=None) -> str:
    """Write snapshot.<loop>/ with atoms#000000 + restart + pxyz; update
    the `restart` symlink in run_dir.  Returns the snapshot directory.

    atoms_writer(snapdir, mode, loop, time_fs): an override for the
    particle records -- the mesh's per-rank N-writer (pio's
    Pio_setNumWriteFiles analog) plugs in here, so the restart, pxyz and
    profile scaffolding stays shared (the JAX package's hook,
    io/restart.py:81-107).  `sim.parallel_plan`, when set, is the
    decomposition the pxyz records."""
    sd = sim.sysdef
    ss = sim.ss
    loop = int(ss.loop)
    # host-side f64 time: the loop count is exact
    time_fs = (sd.cfg.time + (loop - sd.cfg.loop) * sd.cfg.dt) * U.TIME_TO_FS
    ndig = max(sd.cfg.nLoopDigits, 6)
    snapdir = os.path.join(run_dir, f"snapshot.{loop:0{ndig}d}")
    os.makedirs(snapdir, exist_ok=True)

    col = sd.collection
    h = _host(ss.box.h)
    sysobj = sd.db.get(sd.cfg.system_name, "SYSTEM")
    colobj = sd.db.find(sysobj.get_str("collection", "collection"),
                        "COLLECTION")
    mode = colobj.get_str("mode", "VARRECORDASCII") if colobj else "VARRECORDASCII"
    n = ss.state.n_local
    if atoms_writer is not None:
        atoms_writer(snapdir, mode, loop, time_fs)
    else:
        write_collection(
            os.path.join(snapdir, "atoms#000000"),
            gid=ss.state.gid[:n],
            species_names=col.species_names,
            group_names=col.group_names,
            class_names=col.class_names,
            r=_host(ss.state.r[:n]), v=_host(ss.state.v[:n]), h=h,
            loop=loop, time_fs=time_fs,
            group_list=[g.name for g in sd.groups],
            species_list=[s.name for s in sd.species],
            gid_format="hex" if sd.cfg.gidFormat == "hex" else "dec",
            datatype=mode,
            nfiles=sd.cfg.nfiles,
            precision=sd.cfg.checkpointprecision,
        )

    hang = h * U.LENGTH_TO_ANG
    hstr = "\n".join("     %22.14g %22.14g %22.14g" % tuple(row) for row in hang)
    with open(os.path.join(snapdir, "restart"), "w") as f:
        f.write(f"simulate SIMULATE {{ loop={loop}; time={time_fs:.6f} ;}}\n")
        f.write(f"box BOX {{\nh={hstr} ;\n}}\n")
        if sd.integrator_type == "NPTGLF":
            # zeta is restart-persisted (nptglf_writedynamic, nptglf.c:34)
            zeta_ext = U.convert(float(ss.zeta), None, "pressure*t")
            f.write(f"{sd.cfg.integrator_name} INTEGRATOR {{ "
                    f"zeta={zeta_ext:.12e} ; }}\n")
        elif sd.integrator_type == "NGLFNK":
            # piston velocities dL/dt persist across restarts (the
            # integrator writedynamic contract, integrator.c:173-175)
            bd = [U.convert(float(x), None, "l/t") for x in _host(ss.bdot)]
            f.write(f"{sd.cfg.integrator_name} INTEGRATOR {{ bdot="
                    + " ".join(f"{x:.12e}" for x in bd)
                    + " Angstrom/fs ; }\n")
        f.write(f"collection COLLECTION {{ mode={mode}; size={n};"
                f" files={os.path.basename(snapdir)}/atoms#;}}\n")

    # per-phase timing table into the snapshot (dumpprofile, ddcMD.c:209-
    # 223); the phases are timed only when asked for: they re-run the
    # rebuild, force, kick and step outside the run's dispatches
    from ..utils.profile import PROFILE

    if os.environ.get("DDCMD_PROFILE_PHASES") and \
            hasattr(sim, "profile_phases"):
        sim.profile_phases()
    PROFILE.write(snapdir)

    # the domain decomposition file (writePXYZ, io.c:113)
    from .pxyz import write_pxyz

    write_pxyz(os.path.join(snapdir, "pxyz"), _host(ss.box.lengths),
               getattr(sim, "parallel_plan", None))

    if not update_symlink:
        return snapdir
    # atomic restart symlink (io.c:106-110)
    link = os.path.join(run_dir, "restart")
    tmp = link + ".tmp"
    target = os.path.join(os.path.basename(snapdir), "restart")
    if os.path.islink(tmp) or os.path.exists(tmp):
        os.remove(tmp)
    os.symlink(target, tmp)
    os.replace(tmp, link)
    return snapdir
