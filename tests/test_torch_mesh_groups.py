"""Slice 14 under the brick mesh: ParallelSimulation runs the affine
group kinds whose coefficients do not change in time (FREE, FROZEN,
FIXEDVELOCITY, QUENCH, BERENDSEN with its temperature summed over the
ranks, a constant PISTON) and matches the single-device Simulation over
two gloo ranks; every other item-22 feature raises naming item 25; and
the reference finding behind those refusals: the JAX mesh runs EXTFORCE,
the hook groups (SHEAR, DOUBLE_MIRROR) and GLOBAL_ENERGY as if the deck
had none of them.

Tolerances: the mesh's first energy rel 2e-5 of Simulation's (f32),
positions after 20 steps 1e-4 nm, velocities 1e-3 of their scale; the
JAX mesh runs equal to 1e-12 (f64, the same arithmetic).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import torch_mesh_ranks as ranks
from ddcmd_tpu.models import load as j_load
from ddcmd_tpu_torch.models import load as t_load
from ddcmd_tpu_torch.models import martini_water
from ddcmd_tpu_torch.run.simulate import Simulation as TSimulation

torch.set_num_threads(2)

# the mesh's affine kinds in z slabs of the water box (velocities A/fs)
AFFINE = {"mob": "type=FREE;", "wall": "type=FROZEN;",
          "fix": "type=FIXEDVELOCITY; velocity=0 2e-3 0 Angstrom/fs;",
          "q": "type=QUENCH;",
          "ber": "type=BERENDSEN; Teq=400K; tau=0.1ps;",
          "pist": "type=PISTON; vz=1e-3 Angstrom/fs;"}


def _slabs(names, L):
    def assign(r):
        k = np.clip(((r[:, 2] / L + 0.5) * len(names)).astype(int), 0,
                    len(names) - 1)
        return [names[i] for i in k]
    return assign


def _water(d, groups=AFFINE):
    os.makedirs(d)
    martini_water(str(d), n=1700)
    L = chip_smoke.box_edge(str(d))
    chip_smoke.regroup(str(d), groups, _slabs(list(groups), L))
    return str(d)


def test_mesh_runs_affine_kinds_as_simulation(tmp_path):
    """Two gloo bricks along x: the first energy and 20 steps (one chunk
    with its migration) of the affine-kind deck against Simulation on
    the CPU; FROZEN rows stay at rest, FIXEDVELOCITY rows at their
    velocity, the BERENDSEN slab heats toward its 400 K."""
    d = _water(tmp_path / "deck")
    out = str(tmp_path / "mesh.npz")
    ranks.run_ranks(ranks.affine_run, 2, tmp_path, d, (2, 1, 1), 20, out)
    got = np.load(out)
    sim = TSimulation(*t_load(d), run_dir=d, device="cpu")
    sim.first_energy()
    e0 = float(sim.ss.energy.eion)
    assert float(got["e"]) == pytest.approx(e0, rel=2e-5)
    sim.run(20, print_fn=lambda s: None)
    n = sim.sysdef.state.n_local
    r = sim.ss.box.back_in_box(sim.ss.state.r)[:n].numpy()
    v = sim.ss.state.v[:n].numpy()
    L = sim.ss.box.lengths.numpy()
    dr = got["r"] - r
    dr -= L * np.round(dr / L)
    assert int(got["loop"]) == 20
    assert np.abs(dr).max() <= 1e-4
    assert np.abs(got["v"] - v).max() <= 1e-3 * np.abs(v).max()
    g = sim.ss.state.group[:n].numpy()
    names = [x.name for x in sim.sysdef.groups]
    assert np.all(got["v"][g == names.index("wall")] == 0.0)
    np.testing.assert_allclose(got["v"][g == names.index("fix")][:, 1], 0.2,
                               rtol=1e-6)
    np.testing.assert_allclose(got["v"][g == names.index("pist")][:, 2], 0.1,
                               rtol=1e-6)
    vb = got["v"][g == names.index("ber")]
    assert np.abs(vb).max() > 0.0


REFUSED = {
    "NGLFNK": lambda t: t.replace("type=NGLF;", "type=NGLFNK; tau=0.5ps; "
                                  "P=1 bar; W=1000 1000 1000 amu;"),
    "NVEGLF": lambda t: t.replace("type=NGLF;", "type=NVEGLF;"),
    "NVEGLF_SIMPLE": lambda t: t.replace("type=NGLF;",
                                         "type=NVEGLF_SIMPLE;"),
    "box\\(t\\) \\(strain\\)": lambda t: t.replace("pbc=7;",
                                                   "pbc=7; dudt=1e-6;"),
    "box\\(t\\) \\(volume\\)": lambda t: t.replace(
        "pbc=7;", "pbc=7; Veq=140 Angstrom^3;"),
    "GROUP solvent of type EXTFORCE": lambda t: t.replace(
        "type=LANGEVIN; Teq=310.0K; tau=1.0ps;",
        "type=EXTFORCE; force=0 0 0.01 eV/Angstrom;"),
    "GROUP solvent of type SHEAR": lambda t: t.replace(
        "type=LANGEVIN; Teq=310.0K; tau=1.0ps;",
        "type=SHEAR; tau=0.1ps; top_width=5 Angstrom; bottom_width=5 "
        "Angstrom; top_center=10 Angstrom; bottom_center=-10 Angstrom;"),
    "GROUP solvent of type SHWALL": lambda t: t.replace(
        "type=LANGEVIN; Teq=310.0K; tau=1.0ps;", "type=SHWALL;"),
    "GROUP solvent of type DOUBLE_MIRROR": lambda t: t.replace(
        "type=LANGEVIN; Teq=310.0K; tau=1.0ps;", "type=DOUBLE_MIRROR;"),
    "GROUP solvent of type UNIONGROUP": lambda t: t.replace(
        "type=LANGEVIN; Teq=310.0K; tau=1.0ps;",
        "type=UNIONGROUP; groups=m1;") + "m1 GROUP { type=FREE; }\n",
    "GLOBAL_ENERGY": lambda t: t.replace(
        "Teq=310.0K; tau=1.0ps;", "Teq=310.0K; tau=1.0ps; "
        "Teq_dynamics=GLOBAL_ENERGY; Cp=0.05 kJ*mol^-1*K^-1;"),
    "time-dependent Teq or PISTON vz": lambda t: t.replace(
        "type=LANGEVIN; Teq=310.0K; tau=1.0ps;",
        "type=PISTON; vz=RAMP(0,1e-3,0,1ps);"),
    # Simulation runs the NEXTFILE master (tests/test_torch_runtime.py);
    # the mesh has no such path, as the JAX mesh
    "NEXTFILE.*item 23": (lambda t: t.replace("type=NGLF;",
                                              "type=NEXTFILE;"),
                          "NEXTFILE.*item 25"),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_mesh_refuses_what_the_jax_mesh_drops(tmp_path, what):
    """NGLFNK, the NVEGLF variants, box(t), EXTFORCE, the hook groups,
    GLOBAL_ENERGY and time-dependent coefficients raise under the mesh
    naming item 25 (NPTGLF, deformationRate and a BERENDSEN schedule are
    tests/test_torch_host.py's cases), as does the NEXTFILE master."""
    import torch.distributed as dist

    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    martini_water(str(tmp_path), n=400)
    p = tmp_path / "object.data"
    text = p.read_text()
    edit, pattern = (REFUSED[what] if isinstance(REFUSED[what], tuple)
                     else (REFUSED[what], what + ".*item 25"))
    new = edit(text)
    assert new != text
    p.write_text(new)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        with pytest.raises(NotImplementedError, match=pattern):
            ParallelSimulation(*t_load(str(tmp_path)), shape=(1, 1, 1),
                               device="cpu")
    finally:
        dist.destroy_process_group()


def _jax_mesh_run(d, steps=5):
    from ddcmd_tpu.run.parallel_sim import ParallelSimulation

    ps = ParallelSimulation(*j_load(d), shape=(1, 1, 1), dtype=jnp.float64)
    ps.first_energy()
    ps.run(steps)
    m = np.asarray(ps.mask).reshape(-1).astype(bool)
    return (np.asarray(ps.fields["r"]).reshape(-1, 3)[m],
            np.asarray(ps.fields["v"]).reshape(-1, 3)[m])


def test_jax_mesh_ignores_extforce_hooks_and_global_energy(tmp_path):
    """The finding behind the group refusals: the JAX ParallelSimulation
    reads no EXTFORCE force, passes its kicks no hook context and
    computes the coefficients once (brickstep_pallas.py:332,346;
    parallel_sim.py:224).  An EAM crystal whose z slabs are EXTFORCE,
    SHEAR, DOUBLE_MIRROR and a GLOBAL_ENERGY Langevin group runs on it as
    the same deck with FREE slabs and a Langevin slab at the starting
    Teq, while a Simulation's EXTFORCE term does change the energy (the
    port's, whose EXTFORCE term test_torch_groups.py holds to the JAX
    package's, at no JAX compile)."""
    L = 4 * 3.615
    hooked = {
        "ext": "type=EXTFORCE; force=0 0 0.05 eV/Angstrom;",
        "sh": chip_smoke.shear_groups(L, v=5e-3)["sh"],
        "mir": (f"type=DOUBLE_MIRROR; point1=0 0 {-L / 2 + 1} Angstrom; "
                f"point2=0 0 {L / 2 - 1} Angstrom; v1=0.05 Angstrom/fs; "
                "v2=-0.05 Angstrom/fs;"),
        "ge": ("type=LANGEVIN; Teq=300.0K; tau=0.1ps; "
               "Teq_dynamics=GLOBAL_ENERGY; Cp=1e-4 kJ*mol^-1*K^-1;")}
    plain = {"ext": "type=FREE;", "sh": "type=FREE;", "mir": "type=FREE;",
             "ge": "type=LANGEVIN; Teq=300.0K; tau=0.1ps;"}
    decks = {}
    for name, groups in (("hooked", hooked), ("plain", plain)):
        d = str(tmp_path / name)
        os.makedirs(d)
        chip_smoke.eam_deck(d, 4, 5)
        chip_smoke.regroup(d, groups, _slabs(list(groups), L))
        decks[name] = d
    got, ref = (_jax_mesh_run(decks[k]) for k in ("hooked", "plain"))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    e = {}
    for k, d in decks.items():
        ts = TSimulation(*t_load(d), run_dir=d, device="cpu",
                         dtype=torch.float64)
        ts.first_energy()
        e[k] = float(ts.ss.energy.eion)
    assert abs(e["hooked"] - e["plain"]) > 1.0


def test_jax_mesh_berendsen_uses_each_bricks_temperature(tmp_path):
    """A reference finding (ROADMAP queue 3): the JAX mesh's front kick
    (brickstep_pallas.py:332) sums a BERENDSEN group's kinetic energy
    over its own brick only, so at more than one brick each brick
    rescales by its own temperature; the port's mesh sums it over the
    ranks (test_mesh_runs_affine_kinds_as_simulation holds it to
    Simulation).  One step of a BERENDSEN crystal whose x < 0 half starts
    twice as fast, on the JAX mesh at (1,1,1) and at (2,1,1): the front
    kick is v' = lam v + c f with the same f, so (r_2 - r_1) / (dt v0) =
    lam_brick - lam_global on each atom, the closed form
    sqrt(1 + (2 dt/2 / tau)(Teq / T - 1)) at each brick's own T, not 0."""
    import re

    from ddcmd_tpu_torch.objects import units as U

    d = str(tmp_path)
    chip_smoke.eam_deck(d, 5, 5)
    chip_smoke.regroup(d, {"ber": "type=BERENDSEN; Teq=600K; tau=0.1ps;"},
                       lambda r: ["ber"] * len(r))
    atoms = os.path.join(d, "atoms#000000")
    with open(atoms) as f:
        lines = f.read().split("\n")
    rows = [i for i, ln in enumerate(lines) if ln.split(" ", 1)[0].isdigit()]
    rng = np.random.default_rng(3)
    for i in rows:
        p = lines[i].split(" ")
        v = rng.standard_normal(3) * 2e-3 * (2.0 if float(p[4]) < 0 else 1.0)
        lines[i] = " ".join(p[:7] + ["%.8f" % x for x in v])
    with open(atoms, "w") as f:
        f.write("\n".join(lines))
    cols = np.array([[float(x) for x in lines[i].split()[4:10]]
                     for i in rows])
    r0, v0 = cols[:, :3] * 0.1, cols[:, 3:] * 100.0   # A -> nm, A/fs -> nm/ps
    with open(os.path.join(d, "object.data")) as f:
        mass = float(re.search(r"mass=([\d.]+);", f.read()).group(1))
    L = chip_smoke.box_edge(d) * 0.1

    def moved(shape):
        from ddcmd_tpu.run.parallel_sim import ParallelSimulation

        ps = ParallelSimulation(*j_load(d), shape=shape, dtype=jnp.float64)
        ps.first_energy()
        ps.run(1)
        m = np.asarray(ps.mask).reshape(-1).astype(bool)
        gid = np.asarray(ps.fields["gid"]).reshape(m.size, -1)[m]
        r = np.asarray(ps.fields["r"]).reshape(-1, 3)[m][
            np.lexsort(gid.T[::-1])]
        dr = r - r0
        return dr - L * np.round(dr / L)

    dt, half, tau, teq = 0.002, 0.001, 0.1, 600.0

    def lam(sel):
        T = mass * (v0[sel] ** 2).sum() / (3 * sel.sum() * U.kB)
        return np.sqrt(1.0 + 2.0 * half / tau * (teq / T - 1.0))

    k = (moved((2, 1, 1)) - moved((1, 1, 1))) / (dt * v0)
    x = r0[:, 0] - L * np.round(r0[:, 0] / L)
    everyone = np.ones(len(x), bool)
    for brick in (x < 0, x >= 0):
        want = lam(brick) - lam(everyone)
        assert abs(want) > 1e-3
        assert np.abs(k[brick] - want).max() <= 1e-8, (brick.sum(), want)
