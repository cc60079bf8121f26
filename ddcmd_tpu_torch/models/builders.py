"""Programmatic model families: deck builders for canonical systems.

A copy of the JAX package's builders, cut to the families the port runs:
the Martini water box (the main path), the atoms-file writer and the
loader.  Everything is written in the same deck grammar the parser reads
back (objects/parser.py), so both packages build identical decks.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["write_atoms", "martini_water", "load"]


def write_atoms(path, r, v, species, groups, h, classes=None):
    """VARRECORDASCII atoms# shard with FILEHEADER (collection_write
    analog; units are Angstrom / Angstrom/fs external)."""
    n = len(r)
    classes = classes or ["ATOM"] * n
    rows = [f"{i} {classes[i]} {species[i]} {groups[i]} "
            + " ".join("%.8f" % x for x in r[i])
            + " " + " ".join("%.8f" % x for x in v[i]) for i in range(n)]
    hflat = " ".join("%.6f" % x for x in np.asarray(h).T.reshape(-1))
    hdr = (f"particle FILEHEADER {{type=MULTILINE; datatype=VARRECORDASCII;"
           f" checksum=NONE;\nloop=0; time=0.0;\nnfiles=1; nrecord={n};"
           f" nfields=10;\n"
           f"field_names=id class type group rx ry rz vx vy vz;\n"
           f"field_types=u s s s f f f f f f;\n"
           f"h= {hflat} ;\n}}\n\n")
    with open(path, "w") as f:
        f.write(hdr + "\n".join(rows) + "\n")
    return n


def _lattice(n_target, L, jitter, seed):
    rng = np.random.default_rng(seed)
    m = int(np.ceil(n_target ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_target]
    r = ((g + 0.5) / m - 0.5) * L + (rng.random((n_target, 3)) - 0.5) * jitter
    return r, rng


def martini_water(out_dir, *, n=6173, density_nm3=7.47, T=310.0,
                  dt_fs=20.0, seed=2):
    """Martini coarse-grained water at the waterbox state point; MMFF
    objects inline (the waterbox martini.data schema, bioMMFF.c)."""
    L_nm = (n / density_nm3) ** (1 / 3)
    L = L_nm * 10.0
    r, rng = _lattice(n, L, 0.4, seed)
    v = np.zeros((n, 3))
    write_atoms(os.path.join(out_dir, "atoms#000000"), r, v,
                ["WxW"] * n, ["solvent"] * n, np.diag([L] * 3))
    deck = f"""
simulate SIMULATE {{ type=MD; system=system; integrator=integ; dt={dt_fs};
  maxloop=100000; printrate=100; checkpointrate=10000; ddc=ddc; }}
ddc DDC {{ updateRate=20; }}
martini POTENTIAL {{ type=MARTINI; parmfile=martini.data;
  rcoulomb=11 Angstrom; rmax=11 Angstrom; epsilon_r=15; epsilon_rf=-1; }}
integ INTEGRATOR {{ type=NGLF; T={T}K; }}
system SYSTEM {{ type=NORMAL; potential=martini; neighbor=nbr;
  groups=solvent; box=box; collection=collection; species=WxW; }}
WxW SPECIES {{ type=ATOM; mass=72.0; charge=0; }}
box BOX {{ type=ORTHORHOMBIC; pbc=7; h= {L:.6f} 0 0 0 {L:.6f} 0 0 0 {L:.6f} ; }}
nbr NEIGHBOR {{ type=NORMAL; deltaR=4.0 Angstrom; }}
solvent GROUP {{ type=LANGEVIN; Teq={T}K; tau=1.0ps; }}
collection COLLECTION {{ mode=VARRECORDASCII; size={n}; files=atoms#; }}
"""
    mmff = """
martini MMFF {
  resiParms=W ;
  atomTypeList=P4 ;
  ljParms=P4_P4 ;
}
P4 MASSPARMS { atomType=P4; atomTypeID=0; mass=72.0 M_p ; }
W RESIPARMS { resID=1; resType=0; resName=W; charge=0.0;
  groupList=W_g0; centerAtom=0; }
W_g0 GROUPPARMS { groupID=0; atomList=W_W ; }
W_W ATOMPARMS { atomID=0; atomName=W; atomType=P4; atomTypeID=0;
  charge=0.0; mass=72.0 M_p ; }
P4_P4 LJPARMS { atomtypeI=P4; indexI=0; atomtypeJ=P4; indexJ=0;
  sigma=0.47 nm; eps=5.0 kJ*mol^-1; }
"""
    with open(os.path.join(out_dir, "object.data"), "w") as f:
        f.write(deck)
    with open(os.path.join(out_dir, "martini.data"), "w") as f:
        f.write(mmff)
    return out_dir


def load(out_dir, restart=None):
    """Compile a built model dir into (db, base_dir) ready for Simulation."""
    from ..run.cli import load_db

    decks = [os.path.join(out_dir, "object.data")]
    return load_db(decks, restart, out_dir), out_dir
