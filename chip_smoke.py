"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py [--kernels-only | --list-only | --charmm-only |
                           --integrators-only | --masters-only |
                           --transforms-only | --analyses-only |
                           --rebuilds-only | --loadbalance-only |
                           --listmesh-only | --triclinic-only |
                           --outputs-only | --dynamics-only |
                           --mesh-transforms-only]

Needs one CUDA card, the CUDA toolkit (nvcc) and this checkout; imports
nothing of JAX.  Phases, one line each (any failure raises, exit != 0):

  1. device: the card's name and power limit (nvidia-smi), CUDA, nvcc;
  2. build: compile every kernel of the main paths from csrc/, one nvcc
     process per source, all started together (ptxas registers, spills);
  3. kernel vs plain: each kernel's wrapper against its plain PyTorch
     twin on the same CUDA tensors, with CUDA-event times per call:
     - the per-cell kernel at the water box's shapes (80 cells, cap 128,
       one LJ type, no Coulomb) and on charged two-type systems whose
       grids have 3-, 2- and 1-cell axes;
     - the per-cell kernel with exclusions on a small bilayer whose grid
       stays on the per-cell kernel;
     - the column kernel on the full bilayer's packed slots (the grid, G
       and cap plan_lanes and choose_col_group give), on a charged grid
       with nz == G (aliased union), and against the per-cell kernel on
       the same full-bilayer slots (their times side by side, and beside
       the times of the bodies they replaced);
     - both pair kernels on a ragged occupancy (cells of 0, 1, 31, 32, 33
       and cap live slots, a tenth of the live slots masked) at cap 128
       and 256, charged, two LJ types, without and with exclusion
       channels, the column kernel at G = 2 and G = nz = 4; and on the
       same slots packed from a binning made before the particles moved
       by up to half the skin, so particles lie outside their cells;
     - the per-cell EAM kernels (density and force pass) on the nc = 12
       crystal's slots: RATIONAL (the deck's form), FS, SC, EXP, AT and
       a T = 2 FS alloy with an asymmetric density; the column EAM
       kernels on the nc = 32 crystal's slots, on an nz == G grid, and
       against the per-cell EAM kernels on the nc = 32 slots (their times
       side by side, and beside the times of the bodies they replaced);
       both on a ragged occupancy (cells of 0, 1, 31, 32, 33 and cap live
       slots, a tenth of the slots masked inside the counts) at cap 128
       and at cap 256;
     - the per-cell pair and EAM kernels on plans of more than 65,535
       cells at cap 32, most cells empty;
     - the full-stencil kernel (TPU #3) on the water box's records, on
       the full bilayer's (T = 5, reaction field; two calls also against
       each other), on charged grids with 2- and 1-cell axes, on the
       ragged and drifted records at cap 128 and 256 and on the
       65,600-cell plan at cap 32, each but the last also against the
       per-cell kernel on the same records, and its device time on the
       water box's and the full bilayer's records;
     - the extended-grid kernels (TPU #6, #7) of the brick mesh: the pair
       kernel on the (1,1,1) water plan's slots (and against the
       per-cell kernel there), on one brick of a (2,2,2) plan at the
       water density with its halo shell filled (charged, T = 2), on
       a grid with 2-cell periodic axes, and with exclusions on the full
       bilayer's (1,1,1) plan and on one brick of the nx = 8 bilayer's
       (2,2,2) plan; the EAM passes on the (1,1,1) nc = 32 plan and on
       one brick of a (2,2,2) plan at the copper density; the sentinel
       cell's q side stays exactly 0;
     and, for each main-path case, the least time the card could take
     (bound_ms: operations over the f32 peak or bytes over the memory
     rate, from the in-cutoff pairs these inputs hold), and for the water
     box's #1 and #6 the kernel's device time (torch.profiler), which the
     event time around the wrapper (its host time) hides on 80 cells;
     then TPU #3's own main path, its entry point cellpair_eval_full on
     the water box's and the full bilayer's start states (no simulate
     path reaches it), against the half-stencil evaluation;
  4. water slice: the Martini water box through `ddcmd_tpu_torch.run.cli
     simulate`, SLICE_STEPS NVT steps in dispatches of 400;
  5. small-bilayer slice: a 2,888-bead bilayer through the CLI, 400 NPT
     steps on the per-cell kernel with exclusions;
  6. bilayer slice: the ~100k-bead DPPC bilayer through the CLI in two
     stages, as bench.py runs it: 3000 steps at dt = 5 fs, a checkpoint,
     then RUN_STEPS NPT steps at dt = 20 fs from that restart;
  7. EAM crystal, nc = 12 (6,912 Cu atoms, RATIONAL, per-cell EAM
     kernels): EAM_STEPS NVT steps through the CLI, a checkpoint, then 2000
     NVE steps (a FREE group) from that restart, whose energy drift is
     read;
  8. EAM crystal, nc = 32 (131,072 atoms, column EAM kernels): 2000 NVT
     steps through the CLI;
  9. agreement: small deterministic runs on the card (water box; a small
     bilayer with bonds, constraints, exclusions and the barostat; a
     500-atom EAM crystal) against the same runs on the CPU (plain
     twins);
 10. mesh water: `ParallelSimulation` on the water box at (1,1,1): first
     energy against the single-device Simulation's, MESH_STEPS NVT steps in
     dispatches of 400 through the extended-grid pair kernel only;
 11. mesh EAM: the nc = 32 crystal (131,072 atoms) the same way, 2000
     NVT steps through the two extended-grid EAM passes only;
 12. mesh bilayer (run inside phase 6, from its 20 fs restart): the
     100,296-bead bilayer through `ParallelSimulation` at (1,1,1), first
     energy against the single-device Simulation's on the same restart,
     1000 NPT steps (bonds, angles, RATTLE, in-kernel exclusions) through
     the extended-grid pair kernel with exclusions only;
 13. PAIR: the Lennard-Jones fluid (models.lj_fluid, LANGEVIN 120 K)
     through the CLI at 4,096 atoms (LJ_STEPS, per-cell kernel) and
     131,072 atoms (LJ_BIG_STEPS, the kernel its plan gives), the plan and
     the kernel printed, the mean T gated, that kernel held against its
     plain version on the run's slots; a two-species variant (per-pair
     PAIRPARMS, T = 2) through the CLI at 4,096 atoms and on the
     131,072-atom start state, kernel vs plain on its slots;
 14. mesh PAIR: the 131,072-atom fluid through `ParallelSimulation` at
     (1,1,1): first energy against the single-device one, MESH_LJ_STEPS
     NVT steps through the extended-grid pair kernel only;
 15. NPT water: the water box under the reference deck's NGLFCONSTRAINT
     barostat (P0 1 bar, beta 3.0e-4/bar, tauBarostat 1 ps), NPT_STEPS
     steps through the CLI and through the mesh at (1,1,1) (first energy
     against Simulation's): mean T and the box gated, mean P printed;
 16. the plain cell-block engine, which launches no kernel: (a) the
     4,096-atom fluid's first energy and forces against the kernels' on
     the same state; (b) a pbc = 3 REFLECT slab of 4,096 atoms, 1000 f32
     steps, every atom within the walls; (c) a monoclinic box (tilt 0.2)
     of 13,824 atoms, 250 steps in f32 and in f64, their first energies
     against each other, the NVE drift printed; (d) small slab and
     triclinic runs on the card against the same runs on the CPU;
 17. tabulated EAM (tabular_eam_deck samples the crystal's three FIT
     functions into table files in the run directory): (b, in phase 3)
     the tabularFit=rational refit's kernels (#4 on the nc = 12 refit
     deck's slots, #5 on the nc = 32 one's, #7 on its (1,1,1) plan) in
     their RATIONAL_SHIFTED form against their plain versions, with
     device times and bounds; (c) the refit through the CLI at nc = 12
     (#4) and nc = 32 (#5), TAB_STEPS NVT steps each, first energies against
     the RATIONAL deck's, and at nc = 32 through the mesh at (1,1,1) (#7,
     first energy against Simulation's); (d) the unfitted nc = 32 TABULAR
     deck on the plain cell-block EAM engine (no kernel), its first
     energy and forces against the RATIONAL deck's kernels', 20 steps
     with the peak memory; small triclinic, f64 and five-species EAM
     decks on the card against the CPU.  The refit runs print steps/s,
     the busy share and CUDA kernels a step of a profiled window;
 18. the (N,K)-list engine (nbr/celllist.py and the list terms, plain
     PyTorch, no kernel): (a) the list on the start states of (A), the
     nc = 32 crystal with an ORDERSH bias beside its EAM term, and (B),
     the 131,072-atom TableFunction fluid: the card's list against the
     CPU's, with its build time, peak memory, K and largest count; (c)
     (A) under auto (NLIST_A_STEPS) and (B) on engine "nlist"
     (NLIST_STEPS) through Simulation: mean T, steps/s, busy share, CUDA
     kernels a step, peak memory, no kernel launched, sqrt(phi) of (A)
     and a snapshot with its q6#000000 shard; (b) the list engine
     against the kernels on one state (the nc = 32 crystal against #5,
     the analytic LJ fluid against #2, (B) against the analytic deck on
     #2 with the shift added back), each also against the list engine
     in f64; (d) small ORDERSH, PAIRENERGY, table, widened-exclusion
     bilayer and pbc = 3 slab decks on the card against the CPU.

 19. CHARMM all-atom decks (potentials/charmm.py, the bonded families in
     the batched and the generic evaluators): (a) (C), the c36 solvated
     tripeptide of BASELINE.md:195 (3,630 atoms, L = 40 A), 12000 f32
     LANGEVIN steps through the CLI, demoted to the list engine with the
     warning, no kernel launched, mean T, steps/s, busy share, CUDA
     kernels a step, list build and peak memory, and its first energy
     and forces against f64 on the same state; (b) f64 NVE at 0.25 fs
     from rest, 1000 steps, on the JAX test's 102-atom deck and on (C):
     |dEtot| after 100 steps (JAX's 0.5 kJ/mol a 102 atoms), max |dEtot|,
     drift;
     (c) (E), the CHARMM ethane fluid at 4,096 molecules in 10.0 nm
     (32,768 atoms, T = 2, RF, 8-member exclusion channels) through
     Simulation on the kernel its plan gives (#2), that kernel against
     its plain version on (E)'s records with device time and bound, the
     kernels' first forces against the cell-block engine in f64, 5000
     NVT steps with rates; in (a) and (c) the bonded term's CUDA graph
     against its eager function, with both times; (d) (E)
     through ParallelSimulation at (1,1,1) on #6; (e) small c36 and
     ethane decks on the card against the CPU.
 20. integrators and box motion (ROADMAP item 22): (a) NPTGLF on the
     nc = 32 crystal (131,072 Cu atoms at its zero-pressure lattice
     constant 4.30 A, 1 bar, LANGEVIN 300 K) through the CLI, 2000 steps
     on #5: mean T, the box, zeta, mean P, the volume's range; (b)
     NGLFNK on the 131,072-atom LJ fluid (120 K, 500 bar) through the
     CLI, 2000 steps on #2: Lx == Ly exactly, mean T, the box, bdot;
     both with steps/s, busy share and CUDA kernels a step; (c) STRAIN
     (dudt = 0 0 1e-6 /fs) on the nc = 32 crystal, 500 steps on #5:
     Lz against exp(int u dt), Lx and Ly fixed, Pzz; (d) SHEAR on the LJ
     fluid (slices at +-L/4 driven at +-1e-3 A/fs), 500 steps on #2:
     the slices' mean vy and temperatures, the z profile; (e) small
     decks on the card against the CPU with the same noise (a deck for
     each GROUP type and GLOBAL_ENERGY, NVEGLF, NVEGLF_SIMPLE, NPTGLF,
     NGLFNK orthorhombic and triclinic, STRAIN, VOLUME, an off-diagonal
     DEFORMATION_RATE, ROTATION), a restart of zeta and bdot, and NVEGLF
     with the nc = 12 deck's LANGEVIN group against NGLF with a FREE
     group over 100 steps on #4.  Each path's kernel against its plain
     version on that path's last records, with its bound, printed as a
     row of its own in the kernels' JSON line (*_nptglf, *_nglfnk,
     *_strain, *_shear, *_small, *_nveglf) with that path's launches.
 21. the run-time layer and the masters (ROADMAP item 23): (a, run inside
     phase 6 on its 20 fs restart) the full bilayer split into LANGEVIN
     groups lipid and water (printrate 100, printGraphs=1, dispatches of
     100 on a 20-step rebuild cadence) through Simulation.run(3000) on
     #2, with ddcMD_CMDS written at +400 (profile), +800 (both groups'
     Teq to 340 K) and +2400 (checkpoint exit): the stop, the profile
     table, mean T and each group file's T on 340 K, a group row at
     every printrate, a graphs line a dispatch with the plan's pair
     slots, the checkpoint loading; the per-group pe sums of the nx = 8
     two-group bilayer's first energy, card vs CPU; (b) the rollback
     ladder on the water box (#1, 1000 steps): a one-shot NaN at loop
     400 redone once with fresh noise, the later draws kick_noise's at
     attempt 0, then a persistent fault raising the kill switch after 3
     retries with the restart link unchanged; (c) NEXTFILE over (b)'s
     snapshots (eion against (b)'s printed rows) and NGLFTEST at 20 fs,
     subDivide 4, beside the f32 rounding floor; (d) thermalize (card vs
     CPU), readWrite (bit-equal positions), eightFold and 200 steps of
     the 49,384-bead deck through the CLI (first energy 8x, its kernel
     named), testForce --f64, testPressure (lj_fluid n = 500 with its
     slope check, the water box without), integrationTest.  Rows of its
     own: cellpair_half_col_masters, cellpair_half_masters and the
     eightFold deck's kernel (*_eightfold).
 22. transforms (ROADMAP item 24a): (a) the water box with SIMULATE
     transform= REPLICATE 2x2x2 at rate 200, 390 steps through
     Simulation.run: #1 until loop 200, where the same Simulation
     re-plans 49,384 beads past the 256-cell gate and goes on on #2
     (launches read at the replica and at the end), the replica's first
     energy against 8x the energy before it, unique gids, mean T over
     the last 100 steps, steps/s of both halves; (b) SELECTSUBSET zmin=0
     on the replica (about half the beads); (c) the transform master
     through the CLI (THERMALIZE, REPLICATE, SETVELOCITY vcm=0) into a
     checkpoint, |p| and the count read back.  Rows of its own:
     cellpair_half_transform (#1 on the records just before the
     replica) and cellpair_half_col_transform (#2 on the last records).
 23. analyses (ROADMAP item 24b): (a) the water box (#1) with twelve
     SIMULATE analysis= objects (PAIRCORRELATION, VCMWRITE every 30
     steps, off the 20-step cadence, KINETICENERGYDISTN, ZDENSITY, SSF,
     VELOCITYAUTOCORRELATION, FORCEAVERAGE, DATASUBSET, COARSEGRAIN, DSF,
     SUBSETWRITE, PAIRANALYSIS) and printStress, 1000 steps through the
     CLI beside the same deck without analyses (steps/s of both, the
     analyses' host ms an eval): VCMWRITE's rows at 30, 60, ..., 990,
     g(r)'s core, first peak and tail, each ZDENSITY frame's count, the
     VAF's C(0) against 3 kT/m, -tr(stress)/3 against printinfo's
     pressure; then 300 more steps under ddcMD_CMDS (`analysis`, and
     VCMWRITE's eval_rate to 60); (b) the nc = 12 crystal (#4, 6,912
     atoms: _knn's cell-list route): the analysis master on the perfect
     lattice (CENTROSYM, ACKLAND_JONES, QUATERNION's CRC32s), then 300
     NVT steps through the CLI with the three (>= 95% FCC); (c) the
     analysis master on (a)'s and (b)'s checkpoints, card vs CPU (every
     file's numbers within AN_FLOAT_TOL of their column's largest
     magnitude, stress.data's of the stress tensor's largest in their
     own row).  Rows
     of its own: cellpair_half_analysis (#1 on (a)'s last records),
     eam_rho_analysis and eam_force_analysis (#4 on (b)'s).
 24. the last refusals of Simulation (ROADMAP items 27-30): (a) the nx =
     24 bilayer patch (25,376 beads) staged at 5 fs as phase 6 stages
     the full one, then 600 steps at 20 fs through Simulation.run on #2
     with transform= REPLICATE 2x2x1 200 steps in (101,504 beads; the
     topology built anew) and VELOCITYAUTOCORRELATION every 20 steps
     across it: each force term's energy and virial against 4x those
     before it, bonded counts and constraints 4x, the RATTLE residual,
     mean T over the last 200 steps, the VAF rows against C(t) over the
     kept gids; (b) the nc = 12 crystal at a = 4.30 A with pbc = 3 and
     its z doubled (two free (100) surfaces) on the cell-block EAM engine
     under auto:
     first energy and forces against engine "nlist", the surface energy,
     100 NVE steps and their drift; (c) the 500-atom LJ slab (2 list
     cells on its non-periodic z) on engine "nlist" in f64: card against
     the CPU and against the same deck with z doubled.  Row of its own:
     cellpair_half_col_rebuild (#2 on (a)'s last records).
 25. the mesh's load balance (ROADMAP item 25, first part): (a) the dry
     run's zRamp deck (martini_bilayer nx = ny = 12, water 1.2 nm) under
     a (2,2,2) ZRAMP plan (tensor walls) and a BISECTION plan (ORCB
     walls) of its start state: each plan's eight bricks through the
     mesh's per-rank pair function on #6 with exclusions, their halo
     shells filled from the host and the ghost shares reduced home by
     row, forces and energy against Simulation's pair term on the same
     state; #6 against its plain version on the narrowest and the widest
     brick of each plan, with bounds; (b) the nc = 12 crystal's eight
     bricks under walls x 0.42, y 0.58 through the two #7 passes (the
     densities reduced and the embedding taken between them) against
     Simulation, #7 against its plain version on the widest brick; (c)
     the water box through ParallelSimulation at (1,1,1), 1000 NVT steps
     without load balance and 1000 with ZRAMP at rate 100 on #6 (the
     rebalances counted, steps/s of both), the checkpoint (pxyz beside
     it), its restart through Simulation (first energy within 2e-5) and
     through the mesh (the walls resumed), run_analyses (PAIRCORRELATION,
     VCMWRITE, KINETICENERGYDISTN, ZDENSITY, SSF sharded, the VAF on the
     gathered view) against the gathered view and against Simulation's
     evals on the restart.  Rows of its own: cellpair_half_ext_excl_walls,
     cellpair_half_ext_orcb, eam_rho_ext_walls and eam_force_ext_walls,
     each with the launches of (a) or (b)'s eight bricks.
 26. the mesh's brick (N,K)-list engine (ROADMAP item 25, second part;
     plain PyTorch, no kernel launched): (a) phase 18's (B) table fluid
     (131,072 atoms) through ParallelSimulation at (1,1,1): its first
     energy and forces against Simulation(engine="nlist") on the same
     state, LISTMESH_STEPS steps with the mean T in (B)'s window, steps/s
     beside Simulation's list engine; (b) phase 19's (C) tripeptide
     (3,630 atoms; its 30-member exclusion component masked by gid, its
     junction and CMAP terms resolved per term): f64 first energy within
     1e-8 of Simulation(engine="nlist", f64), a short f64 NVE run and
     its max |dEtot|, f32 against f64 at phase 19's gates; (c) the
     unfitted TABULAR nc = 12 crystal against Simulation's cell-block
     EAM engine, then LISTMESH_EAM_STEPS steps; (d) phase 25's zRamp
     bilayer under a (2,2,2) VORONOI plan after one balance_step and
     under a uniform (4,4,2) plan of bricks narrower than 2 rlist, every
     brick through the list engine's per-rank functions (the list of its
     owned rows with the excluded partners dropped, martini_nonbond)
     with its halo filled from the host, against Simulation's pair term;
     (e) the 400-bead water box on the list engine, card against CPU.
 27. triclinic bricks and the 1-D slab engine (ROADMAP item 25, the last
     of what the JAX mesh has; plain PyTorch, no kernel launched): (a)
     the water box with its b vector tilted by TRI_TILT L (same
     fractions, same density) through ParallelSimulation at (1,1,1) on
     the list engine, first energy and forces against
     Simulation(engine="nlist"), TRI_STEPS LANGEVIN steps with the mean T
     over the last TRI_TAIL, steps/s over the last TRI_SIM_STEPS beside
     Simulation's list engine restarted from the same state; (b)
     phase 25's zRamp bilayer tilted the same way, its bricks under a
     uniform, a ZRAMP and a VORONOI (2,2,2) plan (one balance_step)
     through the list engine's per-rank functions, halos filled from the
     host and windows in the fraction, against Simulation's list pair
     term; (c) the NPT water deck tilted, in f64, TRI_STEPS steps
     through the mesh at (1,1,1): first energy against Simulation's, the
     box within 20%, the tilt ratio h01 / h00 kept, the mean T; (d) the
     water box in SLAB_N x-slabs, uniform and between ZRAMP walls,
     through the slab step's per-rank forces (parallel/step.pool_forces)
     with host halos against the single-device list, then SLAB_STEPS f64
     steps of make_sharded_step at one slab on the same box, FREE, the
     first SLAB_CMP of them against Simulation's list engine.
 28. the mesh's outputs at their rates and run(migrate_rate=) (ROADMAP
     queue 1, item 2): (a) the water box (6,173 beads, f32) through
     ParallelSimulation at (1,1,1) on #6 with phase 23's WATER_ANALYSES,
     printStress, printGraphs and two LANGEVIN groups, OUT_STEPS steps:
     every dispatch ends on each rate's multiple, VCMWRITE, stress.data,
     the group files and the graphs have their rows, -tr(stress)/3
     matches the printed pressure, #6 at least once a step and no other
     kernel, steps/s beside the same deck without outputs (not gated);
     (b) the same outputs in f64 on a FREE deck at OUT_B_RATES,
     OUT_B_STEPS steps through the mesh's list engine and through
     Simulation(engine="nlist") from one state: counts within
     AN_COUNT_TOL, the files within AN_FLOAT_TOL (outputs_agree), the
     stress and group files within 1e-8 beyond their printed digits,
     nlocal equal; (c) the NPT water deck in f64, OUT_C_STEPS steps at
     the default cadence and with migrate_rate = 2 chunk_steps (the chunk
     length), loop exact, box and energies finite, the first forces'
     gap to Simulation's printed; then (a)'s run continued OUT_C_STEPS
     NVT steps with migrate_rate = 2 chunk_steps (per-step dispatches on
     #6), mean T within TEMP_TOL of 310 K, the counters set to 0 just
     before this leg: #6 at least once a step and no other kernel; (d)
     #6 against its plain version on (a)'s last records (row
     cellpair_half_ext_outputs, (a)'s launches) and on the NVT leg's
     (row cellpair_half_ext_migrate_rate, that leg's launches).
 29. item 22's dynamics under the mesh (ParallelSimulation at (1,1,1)):
     (a) NPTGLF on the nc = 12 crystal at its zero-pressure lattice
     constant 4.30 A (LANGEVIN 300 K) on #7: mean T, the box within 20%,
     zeta; (b) NGLFNK on the 4,096-atom LJ fluid on #6: Lx == Ly exactly,
     mean T, the box, bdot; (c) STRAIN (dudt = 0 0 1e-6 /fs) on the
     water box on #6: Lz against exp(int u dt), Lx and Ly fixed; (d)
     SHEAR on the 4,096-atom fluid on #6: the slices' mean vy; (e)
     NVEGLF on the nc = 12 crystal (its LANGEVIN group ignored) against
     NGLF with a FREE group, 100 steps each on #7, energies equal.  Each
     f32 leg's first energy and forces against Simulation's on the same
     deck, then 1000 steps ((a), (b)) or 500 ((c), (d)) with the launches
     counted (counters set to 0 just before the run), the mean T over
     the last 500; then a 20-step f64 leg of the path on a small
     deck (the nc = 4 crystal, the 500-atom fluid, the 400-bead water
     box; no noise) held to Simulation(engine="nlist") one step a
     dispatch: box, zeta or bdot, e_pot, rk.  Each f32 leg's kernels
     against their plain versions on that leg's last records, in rows of
     the leg's own with its launches: eam_rho_ext_dynamics_nptglf /
     eam_force_ext_dynamics_nptglf ((a)), cellpair_half_ext_dynamics_
     nglfnk, _strain and _shear ((b)-(d)), eam_rho_ext_dynamics_nveglf /
     eam_force_ext_dynamics_nveglf ((e)).
 30. SIMULATE transform= under the mesh (ParallelSimulation at (1,1,1)):
     (a) the water box (6,173 beads, f32, LANGEVIN 310 K) on #6 with
     transform= REPLICATE 2x2x2 at loop 200, 390 steps in all (phase 22
     (a)'s run): the replica's first energy within MT_E8_REL of 8x the
     first energy just before it and within MT_SIM_REL of Simulation's
     on the same state (Simulation's fast and rebuild steps are the
     mesh's), 49,384 unique gids, #6 at least once a step and no other
     kernel, the mean T over the last 100 steps; (b) the nx = 8 bilayer
     (2,888 beads, f32, NPT) staged MT_BL_STAGE steps at 5 fs on #6 with
     exclusions, replicated 2x2x1 (11,552 beads, the topology built
     anew) and run MT_BL_AFTER steps: each bonded family (f64, over the
     mesh's rebuilt topology at the transform's own positions) within
     MT_FAMILY_REL of 4x that before it, the RATTLE residual under
     RATTLE_TOL, #6 with exclusions at least once a step; (c) the f64
     same-count leg of tests/test_torch_mesh_transforms.py (400 FREE
     beads; THERMALIZE, SETVELOCITY, BOX, GIDSHUFFLE at rate 20; 60
     steps) against Simulation(engine="nlist"): every step's e_pot and
     rk, r and v by gid within MT_F64_TOL of their scale.  Rows of its
     own: cellpair_half_ext_transform (#6 on (a)'s last records at the
     live box, (a)'s launches) and cellpair_half_ext_excl_transform (on
     (b)'s, (b)'s launches).

Every main-path phase (and each entry-point call of TPU #3) sets the
launch counters to 0 just before it and reads them just after.  Prints
the kernels' JSON line, the card line, and last {"ok": true, "device":
{...}}.  --kernels-only stops after phase 3 and prints no result;
--list-only builds the kernels, runs phase 18 alone and prints no
result; --charmm-only does the same with phase 19, --integrators-only
with phase 20, --masters-only with phase 21 (making the bilayer's restart
as phase 6's first stage does), --transforms-only with phase 22,
--analyses-only with phase 23, --rebuilds-only with phase 24,
--loadbalance-only with phase 25, --listmesh-only with phase 26,
--triclinic-only with phase 27, --outputs-only with phase 28,
--dynamics-only with phase 29, --mesh-transforms-only with phase 30.
The line before the card line gives the script's seconds in all.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from types import SimpleNamespace

import numpy as np
import torch

SLICE_STEPS = 2000
DISPATCH = 400
TAIL = 1000              # steps the temperature and rate are read over
TIMED_CALLS = 200        # kernel calls per timing
PLAIN_CALLS = 3          # plain-twin calls per timing, after one warm-up
                         # call (each takes 10-500 ms at full size)
BILAYER_NX = 48          # the builder's default: ~100k beads
EQ_STEPS, EQ_DT = 3000, 5.0
RUN_STEPS = 2000
SMALL_NX, SMALL_STEPS = 8, 400
BILAYER_T = 323.0
TEMP_TOL = 10.0          # K, on the mean T over the last TAIL steps
EAM_NC, EAM_STEPS, EAM_NVE_STEPS = 12, 3000, 2000
EAM_BIG_NC, EAM_BIG_STEPS = 32, 2000
EAM_BIG_PLAN = ((11, 12, 12), 4, 29)    # its cells, G and union size U
EAM_T = 300.0
# the TABULAR decks' sampled functions (tabular_eam_deck)
TAB_R_ROWS, TAB_RHO_ROWS, TAB_RHO_MAX = 4000, 8000, 400.0
# phase 17: the refit decks' steps through the CLI (nc = 12 and 32) and
# the mesh, the unfitted TABULAR deck's on the cell-block EAM engine, the
# steps of a busy-share window
TAB_STEPS, MESH_TAB_STEPS, TAB_CB_STEPS, PROFILE_STEPS = 1500, 1500, 20, 10
# the refit's first energy against the RATIONAL deck's, and the table
# lookups' energy and forces (the JAX package's tests/test_eam.py
# tolerances for tabularFit=rational and for tabular against analytic)
FIT_E_REL, TAB_E_REL, TAB_F_REL = 5e-3, 2e-3, 2e-2
# a five-species FS alloy (alloy_eam_deck): per-species a b c m n l of
# form FS, near the copper values of EAM_FORM_DECKS
ALLOY_FS = {"Cu": "0.8 2.0 1.5 5.0 7.0 3.6", "Ag": "0.7 2.6 1.6 5.5 7.5 4.1",
            "Au": "0.75 2.3 1.55 5.2 7.2 3.8", "Ni": "0.85 1.8 1.45 4.8 6.8 3.5",
            "Pd": "0.72 2.4 1.58 5.4 7.4 4.0"}
# us/call of the bodies the sweep design replaced (PERF.md, H100 80GB
# HBM3 at 700 W): one CTA of cap threads per
# (direction, cell), the pair arithmetic inside the distance sweep; the
# column kernels with their union staged in shared memory, one CTA an SM;
# the full stencil (#3) with one CTA of cap threads a cell over its 27
# blocks
OLD_BODY_US = {"eam_rho": 106.6, "eam_force": 93.7, "eam_rho_col": 1155.4,
               "eam_force_col": 1388.3, "eam_rho_ext": 484.4,
               "eam_force_ext": 589.6, "eam_rho_on_col_slots": 477.3,
               "eam_force_on_col_slots": 590.0,
               "cellpair_half": 84.9, "cellpair_half_excl": 55.5,
               "cellpair_half_col": 713.8, "cellpair_half_ext": 120.5,
               "cellpair_half_ext_excl": 272.4,
               "cellpair_half_on_col_slots": 275.0,
               "cellpair_full": 672.6, "cellpair_full_water": 224.2}
RAGGED_COUNTS = (0, 1, 31, 32, 33)        # live slots of the ragged cells,
RAGGED_CAPS = (128, 256)                  # and cap itself, at each of these caps
BIG_NCELLS = (41, 40, 40)                 # 65,600 cells: past a 16-bit grid axis
RAGGED_RCUT, RAGGED_SKIN = 0.6, 0.3       # the pair kernels' ragged cases
NVE_DRIFT_TOL = 1e-3     # eV/atom, max |Etot - Etot0| over the NVE leg
DEVICE = "cuda:0"
T_START = time.perf_counter()   # the phase lines' clock
MESH_STEPS, MESH_EAM_STEPS, MESH_BL_STEPS = 2000, 2000, 1000
# PAIR Lennard-Jones fluids (models.lj_fluid: 0.0208 atoms/A^3, 8.5 A
# cutoff, 1.2 A skin, LANGEVIN 120 K): 4,096 atoms (58.2 A box) and
# 131,072 (184.9 A), the two-species variant's steps, the mesh's
LJ_N, LJ_STEPS, LJ_BIG_N, LJ_BIG_STEPS = 4096, 2000, 131072, 1500
LJ_T2_STEPS, MESH_LJ_STEPS, LJ_T = 500, 1500, 120.0
# the reference deck's integrator (BASELINE.md:14) on the water box
NPT_INTEGRATOR = ("type=NGLFCONSTRAINT; T=310.0K; P0=1.0 bar; "
                  "beta=3.0e-4/bar; tauBarostat=1.0 ps;")
NPT_STEPS = 2000
# the plain cell-block engine: the REFLECT slab's steps, the monoclinic
# box's lattice edge (24^3 = 13,824 atoms) and steps
CB_SLAB_STEPS, CB_TRI_M, CB_TRI_STEPS = 1000, 24, 250
# phase 18, the (N,K)-list engine: the ORDERSH bias of tests/test_eam.py:274
# (beside the crystal's EAM term, config (A)) and the PAIRENERGY series of
# tests/test_eam.py:236 (beside it in a card-vs-CPU case)
# (c): steps and the T window of (B); (A), at 5.9 steps/s the slowest
# path of the script, runs NLIST_A_STEPS and reads T over its last
# NLIST_A_TAIL (its LANGEVIN group, tau 0.1 ps, refills the crystal's
# equipartition dip within ~200 steps)
NLIST_STEPS, NLIST_TAIL = 400, 200
NLIST_A_STEPS, NLIST_A_TAIL = 300, 100
# (b): (e rel, force over the scale) of the list engine against #5 (the
# EAM gates), against #2, and of the table deck against the analytic deck
# on #2.  The LJ force gate 2e-5 and the table's 1e-5 (tests/test_eam.py:
# 337-415) cannot hold in f32 on the 131,072-atom lattice start (box
# 18.5 nm, force scale ~53): positions carry ulp(9 nm) ~ 1e-6 nm, and
# against the list engine in f64 on that state #2 itself sits 1.0e-4 of
# the scale away, the list in f32 1.4e-4, the table in f32 1.4e-4 (and
# the table in f64 3.7e-5 from the analytic LJ); H100 80GB HBM3, 700 W.
# So both force gates are 3e-4 of the scale; the energies keep 1e-4
NLIST_EAM_GATES, NLIST_LJ_GATES, NLIST_TAB_GATES = \
    (2e-5, 5e-5), (1e-4, 3e-4), (1e-4, 3e-4)
ORDERSH_POT = ("osh POTENTIAL { type=ORDERSH; L=6; r1o=2.6 Angstrom; "
               "r2o=3.0 Angstrom; lamda=1.0 kJ/mol; }")
PAIRENERGY_POT = ("pen POTENTIAL { type=PAIRENERGY; rmax=5.5 Angstrom; "
                  "r_expansion=5.5 Angstrom; "
                  "Cu-Cu_2body= 0.0 0.05 -0.002 0.0001 ; }")
# phase 19, CHARMM: (C) the c36 solvated tripeptide of BASELINE.md:195
# (L = 40 A, 1,200 TIP3 waters, 3,630 atoms, LANGEVIN 300 K, dt 1 fs)
# and (E) the ethane fluid at 4,096 molecules in a 10.0 nm box (32,768
# atoms; 9.0 nm starts two hydrogens 1.30 A apart, 10.0 nm 1.92 A): f32
# steps and the T window.  Neither start is at 300 K: (E) starts at rest
# and its LANGEVIN group (tau 1 ps) heats it as 1 - exp(-t / 1 ps) (by
# 1,000-step blocks 156.9, 257.9, 286.3, 294.9, 297.5 K on the card);
# (C)'s strained start releases its structure energy over ~10 ps (419.8,
# 363.6, 339.6, 324.2, 316.2, 311.5, 305.5, 302.6, 302.1 K; H100 80GB
# HBM3, 700 W; 308.1 K over steps 7,001-8,000 in another call), so (C)
# runs 12,000 steps and (E) 5,000, and each reads T over its last
# 1,000.  The f64 NVE legs from rest (dt 0.25 fs), read every
# C36_NVE_CHUNK steps: the JAX test's 102-atom deck is held to its own
# bound (test_c36_nve_100_steps: |dEtot| <= 0.5 kJ/mol after 100 steps);
# (C) oscillates by kJ/mol from read to read as its strained start
# relaxes, so each of its reads over the first 100 steps is held to the
# JAX package's reading on the same deck (C36_NVE_JAX: dEtot, kJ/mol,
# at steps 10, 20, ..., 100 of ddcmd_tpu's Simulation(engine="nlist")
# in f64 on the CPU; tests/test_torch_charmm_nve.py recomputes them)
# within C36_NVE_BAND kJ/mol
C36_L, C36_MAX_W, C36_STEPS, C36_TAIL = 40.0, 1200, 8000, 1000
C36_NVE_DT, C36_NVE_STEPS, C36_NVE_CHUNK = 0.25, 1000, 10
C36_NVE_GATE, C36_NVE_BAND = 0.5, 1e-3
C36_NVE_JAX = (-3.7426797909557, -3.8104900740345, -3.4079127853420,
               -0.5003685773299, -4.1930815436244, -3.6023058823066,
               -2.8665111439059, -0.7193743629596, -4.2629365347166,
               -3.4783965701954)
ETH_N, ETH_L, ETH_STEPS, CHARMM_T = 4096, 10.0, 5000, 300.0
# the least time the card could take (H100 SXM peaks at 700 W): f32
# outside the tensor cores, and HBM3
PEAK_F32, PEAK_BW = 67e12, 3.35e12
# f32 operations the function needs, whatever the algorithm: for each
# in-cutoff pair of these inputs its distance test (3 sub, 3 mul, 2 add,
# the validity product) and its arithmetic, counted from the sources
# (csrc/cellpair_half.cu: LJ 41, reaction field 14 more; csrc/eam_half.cu
# with eam_forms.cuh, RATIONAL of Horner degree D: density pass 13 + 8 (D
# - 1), force pass 40 + 16 (D - 1): eam_ops).  The tests of pairs outside the
# cutoff are a cell list's overhead, not the function's work (an exact
# prune can skip them), so the bound does not count them
OPS_TEST = 9
OPS_LJ, OPS_RF = 41, 14
# the analytic EAM forms besides the crystal's RATIONAL, one species each
# (per-species values in the units compile_eam documents; rmax = the
# crystal's 5.5 A, so all forms share its plan)
EAM_FORM_DECKS = {
    "FS": "form=FS; Cu = 0.8 2.0 1.5 5.0 7.0 3.6;",
    "SC": "form=SC; Cu = 0.012 3.61 9 6 39.432;",
    "EXP": ("form=EXP; atomvolume=11.81 Angstrom^3; phi_e=0.59 eV; "
            "r_e=2.556 Angstrom; alpha=5.09; beta=5.85; gamma=8.0; "
            "E_c=3.54 eV;"),
    "AT": "form=AT; Cu = 1.5 1.0 2.4 1.0 4.5 0.1 -0.02 0.001 4.0;",
}


def phase(name, text):
    print(f"[{name}] {text} [{time.perf_counter() - T_START:.1f} s]",
          flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def nvcc_line():
    from ddcmd_tpu_torch.ops.cellpair_half import nvcc_path

    out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[-1]


def synthetic(n, L, seed=11):
    """Charged two-type LJ + RF system on a jittered lattice (the
    JAX package's tests/test_nbr_martini.make_system)."""
    rng = np.random.default_rng(seed)
    m = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n]
    r = (g + 0.5) / m * L - 0.5 * L + (rng.random((n, 3)) - 0.5) * (0.25 * L / m)
    q = rng.choice([-1.0, 0.0, 1.0], size=n) * 0.3
    tidx = rng.integers(0, 2, size=n)
    return (r, q, tidx, *synthetic_tables())


def synthetic_tables():
    """(tables, rcut) of synthetic's two LJ types with a reaction field."""
    from ddcmd_tpu_torch.objects import units as U

    sigma = np.array([[0.47, 0.57], [0.57, 0.47]])
    eps = np.array([[5.0, 5.6], [5.6, 5.0]])
    rcut = 1.1
    sr6 = (sigma / rcut) ** 6
    f32 = lambda x: float(np.float32(x))                       # noqa: E731
    tables = dict(sigma=sigma, eps=eps, shift=-4 * eps * (sr6 ** 2 - sr6),
                  rcut2=f32(rcut ** 2), krf=f32(0.5 / rcut ** 3),
                  crf=f32(1.5 / rcut), keR=f32(U.ke / 15.0))
    return tables, rcut


def made_grid(ncells, cap, rlist):
    """A cell grid of a given shape and capacity (plan_lanes sizes its
    own from the density)."""
    from ddcmd_tpu_torch.ops.cellpair import CellBlockGrid, _build_stencil

    return CellBlockGrid(tuple(ncells), cap, rlist, *_build_stencil(ncells))


def ragged_system(ncells=(3, 3, 4), cap=128, seed=23):
    """A box of `ncells` cells whose occupancies cycle through
    RAGGED_COUNTS and cap (0, 1, 31, 32, 33 and cap atoms), what the
    kernels' tile cutting and queue flush must survive: each cell's atoms
    sit on a jittered m x m x 4 sub-lattice strictly inside it (m = 6 in
    cells of 1.3 nm at cap 128, 8 in cells of 1.73 nm at cap 256; closest
    pairs ~2 A), in shuffled order, with random species 0/1 and a
    particle mask that drops a tenth of them.  Binned with a mask of ones
    the dropped atoms stay inside the cells' counts.  Returns (r (n, 3)
    f32, box lengths, species (n,), mask (n,) f32, grid), all host."""
    m = {128: 6, 256: 8}[cap]
    edge = 1.3 * m / 6
    assert cap <= m * m * 4
    occupancy = (*RAGGED_COUNTS, cap)
    rng = np.random.default_rng(seed)
    sites = (np.stack(np.meshgrid(np.arange(m), np.arange(m), np.arange(4),
                                  indexing="ij"), -1).reshape(-1, 3) + 0.5) \
        / np.array([m, m, 4]) * edge
    L = np.array(ncells, np.float64) * edge
    r = []
    for k, c3 in enumerate(np.ndindex(*ncells)):
        pick = rng.permutation(len(sites))[:occupancy[k % len(occupancy)]]
        r.append(np.array(c3) * edge - L / 2 + sites[pick])
    r = np.concatenate(r)
    r = r + np.clip(rng.standard_normal(r.shape) * 0.01, -0.03, 0.03)
    r = r[rng.permutation(len(r))].astype(np.float32)
    n = len(r)
    return (r, L.tolist(), rng.integers(0, 2, n),
            (rng.random(n) >= 0.1).astype(np.float32),
            made_grid(ncells, cap, 0.65))


def slab_lattice(ncells, edge, layers=3, per_edge=3, seed=29):
    """Atoms on a jittered cubic lattice (per_edge^3 a cell, never
    crossing a cell face) in the first `layers` cell layers along x of a
    box of `ncells` cells of `edge` nm; the rest of the box is empty.
    Returns (r (n, 3), box lengths)."""
    h = edge / per_edge
    m = [layers * per_edge, ncells[1] * per_edge, ncells[2] * per_edge]
    g = np.stack(np.meshgrid(*[np.arange(k) for k in m], indexing="ij"),
                 -1).reshape(-1, 3)
    L = np.array(ncells, np.float64) * edge
    rng = np.random.default_rng(seed)
    r = (g + 0.5) * h - L / 2 + (rng.random(g.shape) - 0.5) * 0.2 * h
    return r, L.tolist()


def packed_inputs(r, q, tidx, L, grid, tables, dev, G=1, ex=None,
                  r_pack=None, valid=None):
    """Pack as the main path does (cellpair_eval_half), on the card; the
    arguments of the column kernel when G > 1.  ex (n, 2): the exclusion
    channels; r_pack: the positions packed into slots binned at r (a
    stale binning); valid (n,): the validity row of each particle (1 by
    default)."""
    from ddcmd_tpu_torch.ops.cellpair import build_cell_slots, half_grid
    from ddcmd_tpu_torch.ops.cellpair_half import grid_tensors, pack_slots

    n = len(r)
    n_pad = ((n + 127) // 128) * 128
    pad = lambda a, shape: torch.tensor(np.concatenate(          # noqa: E731
        [np.asarray(a), np.zeros((n_pad - n,) + shape)]),
        dtype=torch.float32, device=dev)
    rt = pad(r, (3,))
    qt = pad(q, ())
    tt = pad(tidx, ()).long()
    fmask = (torch.arange(n_pad, device=dev) < n).float()
    Lt = torch.tensor(L, dtype=torch.float32, device=dev)
    perm, ov = build_cell_slots(rt, fmask, Lt, grid)
    assert not bool(ov), "overflow packing the comparison case"
    hg = half_grid(grid)
    gt = grid_tensors(hg, dev, G)
    slots, _ = pack_slots(rt if r_pack is None else pad(r_pack, (3,)), qt,
                          tt, perm, Lt, hg, gt["frac_centers"],
                          excl_vals=None if ex is None else pad(ex, (2,)))
    if valid is not None:
        vt = torch.cat([pad(valid, ()), torch.zeros(1, device=dev)])
        slots[:, 5, :] = vt[perm].reshape(hg.ncell, hg.cap)
    L8 = torch.zeros((1, 8), dtype=torch.float32, device=dev)
    L8[0, :3] = Lt / gt["ncells"]
    L8[0, 3] = tables["rcut2"]
    counts = (perm.reshape(hg.ncell, hg.cap) != n_pad).sum(
        1, dtype=torch.int32)
    tabs = [torch.tensor(np.asarray(tables[k]), dtype=torch.float32,
                         device=dev).contiguous()
            for k in ("sigma", "eps", "shift")]
    if G > 1:
        return (slots, gt["stencil"], gt["member_u"], L8, counts, *tabs)
    return (slots, gt["stencil"], L8, counts, *tabs)


def pad_p(out_p, out_q):
    """The p side padded to every slot cell of out_q (an extended grid's
    p side covers its first n_prog cells only)."""
    ncell, _, cap = out_q.shape
    return torch.nn.functional.pad(out_p, (0, 0, 0,
                                           ncell * cap - out_p.shape[0]))


def per_slot(*outs):
    """(f, pe per slot, e, virial6) of a pair kernel's outputs: (out_p,
    out_q, out_cell) of a half-stencil kernel, (out_p, out_cell) of the
    full-stencil kernel, which writes no q side."""
    out_p, out_cell = outs[0], outs[-1]
    f, pe = out_p[:, :3].double(), out_p[:, 3].double()
    if len(outs) == 3:
        out_q = outs[1]
        ncell, _, cap = out_q.shape
        out_p = pad_p(out_p, out_q)
        back = out_q.transpose(1, 2).reshape(ncell * cap, 8)
        f = (out_p[:, :3] + back[:, :3]).double()
        pe = (out_p[:, 3] + back[:, 3]).double()
    return f, pe, out_cell[:, 0].double().sum(), out_cell[:, 1:7].double().sum(0)


def cell_view(args):
    """(slots, per-cell stencil, L8, counts) of a kernel call's arguments,
    a column call's table unfolded into the per-cell stencil it encodes."""
    from ddcmd_tpu_torch.ops.cellpair_half import col_to_cell_stencil

    if args[2].dtype == torch.int32:            # (slots, stencil_col, member_u, ...)
        return (args[0], col_to_cell_stencil(args[1], args[2]), args[3],
                args[4])
    return args[:4]


def full_call(grid, args, kw, dev):
    """The full-stencil call (TPU #3) on the records of a half-stencil
    or column call's arguments: the same slots, L8, counts and tables
    with `grid`'s 27-direction stencil (grid: the plan_lanes grid).
    Returns (args, kw, hargs): hargs the per-cell half-stencil call (#1)
    on the same records, which tests each unordered pair once."""
    from ddcmd_tpu_torch.ops.cellpair import half_grid
    from ddcmd_tpu_torch.ops.cellpair_full import self_index
    from ddcmd_tpu_torch.ops.cellpair_half import pack_stencil

    slots, _, L8, counts = cell_view(args)
    rest = (L8, counts, *args[-3:])
    fargs = (slots, torch.as_tensor(pack_stencil(grid), device=dev), *rest)
    hargs = (slots, torch.as_tensor(pack_stencil(half_grid(grid)),
                                    device=dev), *rest)
    return fargs, dict(s_self=self_index(grid), krf=kw["krf"], crf=kw["crf"],
                       keR=kw["keR"], coulomb=kw["coulomb"]), hargs


def full_vs_half(name, fargs, fkw, hargs):
    """#3 against #1 (no exclusions) on the same records: the same
    physics, summed in another order, at the tolerances of agree()."""
    from ddcmd_tpu_torch.ops import cellpair_full as cf
    from ddcmd_tpu_torch.ops import cellpair_half as ch

    hkw = {k: v for k, v in fkw.items() if k != "s_self"}
    got = per_slot(*cf.cellpair_full(*fargs, **fkw))
    ref = per_slot(*ch.cellpair_half(*hargs, **hkw))
    torch.cuda.synchronize()
    ferr, scale = agree(f"full vs half stencil: {name}", got, ref)
    phase("kernel", f"full-stencil #3 vs half-stencil #1 on {name}: force "
          f"err {ferr:.3g} (scale {scale:.4g}), e {float(got[2]):.8g} vs "
          f"{float(ref[2]):.8g}")


def sweep_work(slots, stencil, L8, counts):
    """(candidate pairs, in-cutoff pairs) of one half-stencil sweep on
    these inputs.  Candidates, reported only: counts[c] * counts[tgt] per
    (cell, direction), counts[c] (counts[c] - 1) / 2 in the self block 0,
    what a sweep trimmed by `counts` alone would test.  In cutoff, what
    the bound counts: both slots valid and 0 < d2 < rcut^2.  Each
    unordered pair is counted once."""
    n_prog, cap = stencil.shape[0], slots.shape[2]
    L8 = L8.reshape(-1)
    home = slots[:n_prog]
    nc = counts[:n_prog].long()
    upper = (torch.arange(cap, device=slots.device)[None, :]
             > torch.arange(cap, device=slots.device)[:, None])
    cand = hits = 0
    for s in range(stencil.shape[1] // 4):
        tgt = stencil[:, 4 * s].long()
        cand += int((nc * (nc - 1) // 2).sum() if s == 0
                    else (nc * counts[tgt].long()).sum())
        sh = stencil[:, 4 * s + 1:4 * s + 4].float() * L8[0:3]
        Q = slots[tgt]
        d2 = sum((home[:, a, :, None] - (Q[:, a] + sh[:, a:a + 1])[:, None, :])
                 ** 2 for a in range(3))
        ok = (home[:, 5, :, None] * Q[:, 5, None, :] > 0) & (d2 < L8[3]) \
            & (d2 > 0)
        if s == 0:
            ok &= upper
        hits += int(ok.sum())
    return cand, hits


def bound(args, outs, ops_pair, work=None):
    """(bound_ms, bound_by, candidates, in-cutoff pairs): the larger of
    the f32 operations these inputs need over PEAK_F32 and the bytes the
    call must move (each input read once, each output written once) over
    PEAK_BW.  The operations are the distance test and the ops_pair
    operations of every in-cutoff pair (sweep_work) of `work`, a
    half-stencil call's arguments on the same records (`args` by
    default): a full-stencil call computes the same function, each pair
    met from both sides, and its bound counts each pair once."""
    cand, hits = sweep_work(*cell_view(args if work is None else work))
    ops = (OPS_TEST + ops_pair) * hits
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs)
                 if torch.is_tensor(t))
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BW
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", cand, hits)


def compare(name, kernel, plain, args, kw, with_bound=False, work=None,
            device_key=None):
    """Kernel vs plain twin on the same CUDA tensors, at the tolerances
    of tests/test_pallas_cellpair.py; returns (max_abs_err of the force,
    ms per kernel call, ms per plain call, bound_ms, bound_by), the bound
    None unless with_bound (its operations from `work`, see bound).  With
    device_key, the kernels of that name are also timed on the device
    (device_us), which on small grids the event time around the wrapper,
    its host time, hides."""
    outs = kernel(*args, **kw)
    got = per_slot(*outs)
    ref = per_slot(*plain(*args, **kw))
    torch.cuda.synchronize()
    ferr, scale = agree(name, got, ref)
    ms = time_calls(lambda: kernel(*args, **kw), TIMED_CALLS)
    plain_ms = time_calls(lambda: plain(*args, **kw), PLAIN_CALLS, warm=1)
    bnd, by, text = None, None, ""
    if device_key:
        dev_us = device_us(lambda: kernel(*args, **kw), TIMED_CALLS,
                           device_key)
        text += f"; device {dev_us:.2f} us/call (profiler)"
    if with_bound:
        bnd, by, cand, hits = bound(
            args, outs, OPS_LJ + (OPS_RF if kw["coulomb"] else 0),
            work=work)
        text += (f"; bound {1e3 * bnd:.3f} us ({by}; {cand} candidate "
                 f"pairs, {hits} in cutoff)")
    phase("kernel", f"{name}: force err {ferr:.3g} (scale {scale:.4g}), "
          f"e {float(got[2]):.6g} vs {float(ref[2]):.6g}; kernel "
          f"{1e3 * ms:.2f} us/call, plain {1e3 * plain_ms:.2f} us/call{text}")
    return ferr, ms, plain_ms, bnd, by


def agree(name, got, ref):
    """Raise unless two (f, pe, e, virial6) sets agree within the
    tolerances of tests/test_pallas_cellpair.py."""
    (f1, pe1, e1, v1), (f0, pe0, e0, v0) = got, ref
    scale = max(1.0, float(f0.abs().max()))
    ferr = float((f1 - f0).abs().max())
    checks = {
        "force": ferr <= 2e-5 * scale,
        "e": abs(float(e1 - e0)) <= 1e-4 * abs(float(e0)) + 1e-2,
        "virial": bool(((v1 - v0).abs() <= 2e-3 * v0.abs() + 0.5).all()),
        "pe": bool(((pe1 - pe0).abs() <= 1e-3 * pe0.abs() + 2e-3).all()),
    }
    if not all(checks.values()):
        raise AssertionError(f"{name}: outputs disagree: {checks} (force "
                             f"err {ferr:.3g}, scale {scale:.4g})")
    return ferr, scale


def device_us(fn, n, key):
    """Mean device time, us, of the kernels whose name holds `key` that
    one call of fn launches (torch.profiler over n calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if key in e.key) / n
    if us <= 0:
        raise AssertionError(f"the profiler saw no {key} kernel")
    return us


def time_calls(fn, n, warm=3):
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def water_deck(d, n, printrate, free=False):
    """martini_water deck; free=True swaps the Langevin group for FREE
    (a deterministic run)."""
    from ddcmd_tpu_torch.models import martini_water

    martini_water(d, n=n)
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    text = text.replace("printrate=100;", f"printrate={printrate};")
    if free:
        text = text.replace("type=LANGEVIN; Teq=310.0K; tau=1.0ps;",
                            "type=FREE;")
    with open(p, "w") as f:
        f.write(text)
    return p


def bilayer_deck(d, nx, dt_fs, printrate, free=False):
    """martini_bilayer deck (full width at nx = 48); free=True swaps the
    Langevin group for FREE (a deterministic run)."""
    from ddcmd_tpu_torch.models import martini_bilayer

    kw = dict(water_nm=1.2) if nx < 8 else {}
    martini_bilayer(d, nx=nx, ny=nx, dt_fs=dt_fs, **kw)
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    text = text.replace("printrate=200;", f"printrate={printrate};")
    if free:
        text = text.replace(f"type=LANGEVIN; Teq={BILAYER_T}K; tau=1.0ps;",
                            "type=FREE;")
    with open(p, "w") as f:
        f.write(text)
    return p


def read_rows(run_dir):
    with open(os.path.join(run_dir, "data")) as f:
        return np.array([ln.split() for ln in f.read().splitlines()[1:]],
                        dtype=np.float64)


def tail_rate(sim, tail=TAIL):
    """steps/s over the last `tail` accepted steps (dispatch host clock)."""
    steps = secs = 0
    for k, s in reversed(sim.dispatch_log):
        if steps >= tail:
            break
        steps, secs = steps + k, secs + s
    return steps / secs, steps


def cli_run(argv, device=None):
    from ddcmd_tpu_torch.run import cli

    with contextlib.redirect_stdout(io.StringIO()):
        return cli.run(argv + ["--device", str(device or DEVICE)])


def sim_kernel_inputs(sim):
    """The pair kernel call the main path makes on sim's current state:
    (kernel, args, kw) plus the half grid."""
    ss, perm, ov = sim._build_nbr(sim.ss)
    assert not bool(ov), "overflow packing the comparison case"
    term = sim.force_fn.terms[0]
    kernel, args, kw = term.kernel_inputs(ss.state, ss.box, perm)
    return kernel, args, kw, term.grid


def eam_deck(d, nc, printrate, free=False, a_lat=None, edit=None,
             jitter=None):
    """eam_crystal deck (4 nc^3 Cu atoms, RATIONAL); free=True swaps the
    Langevin group for FREE (NVE, deterministic); a_lat, the lattice
    constant in A (eam_crystal's 3.615 by default); edit(text) edits the
    deck further; jitter, the start lattice's noise in A (eam_crystal's
    0.03 by default; 0 a perfect lattice)."""
    from ddcmd_tpu_torch.models import eam_crystal

    kw = {k: v for k, v in (("a_lat", a_lat), ("jitter", jitter))
          if v is not None}
    eam_crystal(d, nc=nc, **kw)
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    text = text.replace("printrate=100;", f"printrate={printrate};")
    if free:
        text = text.replace(f"type=LANGEVIN; Teq={EAM_T}K; tau=0.1ps;",
                            "type=FREE;")
    if edit is not None:
        text = edit(text)
    with open(p, "w") as f:
        f.write(text)
    return p



def tabular_eam_deck(d, nc, printrate, fit=False, free=False):
    """The eam_deck crystal with form TABULAR: the deck's three FIT
    functions (models/builders.py:eam_crystal) sampled in internal units
    into pair.dat (r, phi, rho; TAB_R_ROWS rows over 1.5-5.5 A) and
    embed.dat (rho, F; TAB_RHO_ROWS rows over 0-TAB_RHO_MAX, more than
    five times the density of the crystal's atoms), as tests/test_eam.py
    writes its FS tables; fit=True adds tabularFit=rational (the refit
    the EAM kernels run)."""
    from ddcmd_tpu_torch.objects import units as U

    p = eam_deck(d, nc, printrate, free)
    eV = U.unit_scale("eV")
    r_ang = np.linspace(1.5, 5.5, TAB_R_ROWS)
    cols = (r_ang * U.unit_scale("Angstrom"), 0.012 * (3.6 / r_ang) ** 6 * eV,
            (3.6 / r_ang) ** 4)
    np.savetxt(os.path.join(d, "pair.dat"), np.stack(cols, 1), fmt="%.17g")
    rho = np.linspace(0.0, TAB_RHO_MAX, TAB_RHO_ROWS)
    F = (-0.3 * rho + 0.002 * rho * rho) / (1.0 + 0.05 * rho) * eV
    np.savetxt(os.path.join(d, "embed.dat"), np.stack([rho, F], 1),
               fmt="%.17g")
    with open(p) as f:
        text = f.read()
    old = "form=RATIONAL; rmax=5.5 Angstrom;\n  density_type=elementwise;"
    assert old in text
    text = text.replace(old, "form=TABULAR; rmax=5.5 Angstrom; "
                        "Cu-Cu_pair=pair.dat; Cu_embed=embed.dat;"
                        + (" tabularFit=rational;" if fit else ""))
    with open(p, "w") as f:
        f.write(text)
    return p


def triclinic_eam_deck(d, nc, printrate, tilt=0.05, seed=7):
    """The eam_deck crystal (FREE group) sheared into a monoclinic box with
    b = (tilt L, L, 0): the fcc sites in fractional coordinates mapped
    through h, jittered by 0.03 A."""
    p = eam_deck(d, nc, printrate, free=True)
    L = 3.615 * nc
    h = np.diag([L, L, L])
    h[0, 1] = tilt * L
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    frac = (cells[:, None, :] + base).reshape(-1, 3) / nc - 0.5
    rng = np.random.default_rng(seed)
    r = frac @ h.T + rng.standard_normal(frac.shape) * 0.03
    n = len(r)
    hflat = " ".join("%.6f" % x for x in h.reshape(-1))
    rows = [f"{i} ATOM Cu free " + " ".join("%.8f" % x for x in r[i])
            + " 0 0 0" for i in range(n)]
    with open(os.path.join(d, "atoms#000000"), "w") as f:
        f.write(f"particle FILEHEADER {{type=MULTILINE; "
                f"datatype=VARRECORDASCII; checksum=NONE;\nloop=0; "
                f"time=0.0;\nnfiles=1; nrecord={n}; nfields=10;\n"
                f"field_names=id class type group rx ry rz vx vy vz;\n"
                f"field_types=u s s s f f f f f f;\nh= {hflat} ;\n}}\n\n"
                + "\n".join(rows) + "\n")
    with open(p) as f:
        text = f.read()
    box = text[text.index("box BOX"):]
    box = box[:box.index("}") + 1]
    text = text.replace(box, f"box BOX {{ type=GENERAL; pbc=7; h= {hflat} ; }}")
    with open(p, "w") as f:
        f.write(text)
    return p


def ordersh_eam_deck(d, nc, printrate, free=False):
    """The eam_deck crystal with the ORDERSH bias of ORDERSH_POT beside
    its EAM term (a list-only term: the deck runs on the (N,K)-list
    engine)."""
    p = eam_deck(d, nc, printrate, free)
    _add_potential(p, ORDERSH_POT)
    return p


def pairenergy_deck(d, nc, printrate, free=False):
    """The eam_deck crystal with the PAIRENERGY series of PAIRENERGY_POT
    beside its EAM term (tests/test_eam.py:236's series)."""
    p = eam_deck(d, nc, printrate, free)
    _add_potential(p, PAIRENERGY_POT)
    return p


def _add_potential(p, obj):
    """Add the POTENTIAL object `obj` (its name first) to the deck's
    system beside its `pot`."""
    with open(p) as f:
        text = f.read()
    assert "potential=pot;" in text
    text = text.replace("potential=pot;", f"potential=pot {obj.split()[0]};")
    with open(p, "w") as f:
        f.write(text + "\n" + obj + "\n")


def table_lj_deck(d, n, printrate, free=False):
    """lj_fluid's TableFunction deck (the LJ sampled into cubic rows,
    table.data): it runs on engine="nlist" only."""
    from ddcmd_tpu_torch.models import lj_fluid

    lj_fluid(d, n=n, table=True)
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    text = text.replace("printrate=100;", f"printrate={printrate};")
    if free:
        text = text.replace("type=LANGEVIN; Teq=120.0K; tau=0.5ps;",
                            "type=FREE;")
    with open(p, "w") as f:
        f.write(text)
    return p


def widen_exclusions(sd):
    """Widen a bilayer's exclusion graph past the cell engines' 12-member
    encoding, in memory: consecutive DPPC instances pair up into one
    24-bead residue instance each ("DPPC2"), joined by one more exclusion
    (the first lipid's last bead, the second's first), so every merged
    instance is one 24-member component and every bonded term stays
    inside its instance.  Edits sd (either package's SystemDef) in place
    and returns it."""
    insts, merged, extra = sd.residue_instances, [], []
    i = 0
    while i < len(insts):
        name, rows = insts[i]
        if (name == "DPPC" and i + 1 < len(insts)
                and insts[i + 1][0] == "DPPC"):
            nxt = insts[i + 1][1]
            merged.append(("DPPC2", list(rows) + list(nxt)))
            extra.append((rows[-1], nxt[0]))
            i += 2
        else:
            merged.append((name, rows))
            i += 1
    assert extra, "no DPPC pair to join"
    sd.residue_instances[:] = merged
    ex = np.asarray(sd.bonded.exclusions)
    sd.bonded.exclusions = np.concatenate(
        [ex, np.asarray(extra, ex.dtype)]).astype(ex.dtype)
    return sd


@contextlib.contextmanager
def widened(*modules):
    """Within the block, the build_system of each simulate module (the
    port's, and in tests the JAX package's) widens the bilayer's
    exclusions (widen_exclusions)."""
    saved = [m.build_system for m in modules]

    def wrap(build):
        return lambda *a, **kw: widen_exclusions(build(*a, **kw))

    for m, build in zip(modules, saved):
        m.build_system = wrap(build)
    try:
        yield
    finally:
        for m, build in zip(modules, saved):
            m.build_system = build


# --- phase 19's decks: copies of the JAX package's CHARMM test fixtures
# (tests/test_charmm.py:make_fixture, tests/test_charmm_c36.py:
# make_solvated_fixture), which chip_smoke.py cannot import (they import
# JAX); tests/test_torch_charmm.py holds them byte-equal

ETHANE_RTF = """* synthetic topology
*
36  1

MASS     1 CT3   12.01100 C
MASS     2 HA     1.00800 H

RESI ETHA  0.00 ! ethane
GROUP
ATOM C1  CT3  -0.27
ATOM H11 HA    0.09
ATOM H12 HA    0.09
ATOM H13 HA    0.09
GROUP
ATOM C2  CT3  -0.27
ATOM H21 HA    0.09
ATOM H22 HA    0.09
ATOM H23 HA    0.09
BOND C1 C2  C1 H11  C1 H12  C1 H13
BOND C2 H21 C2 H22  C2 H23

END
"""

ETHANE_PAR = """* synthetic parameters
*

BONDS
CT3 CT3  222.50     1.5280
CT3 HA   322.00     1.1110

ANGLES
HA  CT3 HA    35.50    108.40    5.40   1.80200
HA  CT3 CT3   34.60    110.10   22.53   2.17900

DIHEDRALS
X   CT3 CT3 X      0.1525  3     0.00

NONBONDED nbxmod  5 atom cdiel fshift vatom vdistance vfswitch -
cutnb 14.0 ctofnb 12.0 ctonnb 10.0 eps 1.0 e14fac 1.0 wmin 1.5
CT3    0.0       -0.0780    2.040   0.0  -0.01  1.900
HA     0.0       -0.0240    1.340

END
"""

ETHANE_DECK = """
simulate SIMULATE {{
  type=MD; system=system; integrator=nglf; dt=1; maxloop=1000;
  printrate=100; ddc=ddc;
}}
ddc DDC {{ updateRate=10; }}
charmm POTENTIAL {{
  type=CHARMM; topfile=top.rtf; parfile=par.prm;
  cutoff=9.0 Angstrom; rcoulomb=9.0 Angstrom; epsilon_r=1.0; epsilon_rf=-1;
}}
nglf INTEGRATOR {{type=NGLF; T=300K;}}
system SYSTEM {{
  type=NORMAL; potential=charmm; neighbor=nbr; groups=free;
  box=box; collection=collection;
}}
box BOX {{ type=ORTHORHOMBIC; pbc=7; h= {L} 0 0 0 {L} 0 0 0 {L} ; }}
nbr NEIGHBOR {{ type=NORMAL; deltaR=2.0; }}
free GROUP {{ type=LANGEVIN; Teq=300K; tau=1ps; }}
collection COLLECTION {{ mode=VARRECORDASCII; size={n}; files=atoms#; }}
"""

# ethane geometry (Ang), roughly tetrahedral
ETHANE_ATOMS = [
    ("C1", (0.000, 0.000, 0.000)),
    ("H11", (-0.390, 0.970, 0.300)),
    ("H12", (-0.390, -0.720, 0.720)),
    ("H13", (-0.390, -0.250, -1.020)),
    ("C2", (1.528, 0.000, 0.000)),
    ("H21", (1.920, 0.970, -0.300)),
    ("H22", (1.920, -0.720, -0.720)),
    ("H23", (1.920, -0.250, 1.020)),
]


def charmm_ethane_deck(d, n_mol=8, L=2.2):
    """The synthetic CHARMM ethane fluid (RTF/PAR with autogenerated
    X CT3 CT3 X torsions, Urey-Bradley 1-3 springs, 1-4 LJ pairs,
    reaction-field Coulomb; LANGEVIN 300 K, cutoff 9 A, deltaR 2 A): n_mol
    molecules anchored at C1 on a lattice in an L nm box, each with a
    random rotation.  Returns the deck's path."""
    with open(os.path.join(d, "top.rtf"), "w") as f:
        f.write(ETHANE_RTF)
    with open(os.path.join(d, "par.prm"), "w") as f:
        f.write(ETHANE_PAR)
    rng = np.random.default_rng(11)
    rows = []
    gid = 0
    m = int(np.ceil(n_mol ** (1 / 3)))
    centers = (np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), -1)
               .reshape(-1, 3)[:n_mol] + 0.5) / m * L - L / 2
    for c in centers:
        rot = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        for name, pos in ETHANE_ATOMS:
            p = (rot @ np.asarray(pos)) * 0.1 + c  # Ang->nm, rotated
            rows.append(f"{gid} ATOM {name}xETHA free "
                        + " ".join("%.6f" % (x * 10) for x in p) + " 0 0 0")
            gid += 1
    n = len(rows)
    hdr = (f"particle FILEHEADER {{type=MULTILINE; datatype=VARRECORDASCII; checksum=NONE;\n"
           f"loop=0; time=0.0;\nnfiles=1; nrecord={n}; nfields=10;\n"
           f"field_names=id class type group rx ry rz vx vy vz;\n"
           f"field_types=u s s s f f f f f f;\n"
           f"h= {L*10} 0 0 0 {L*10} 0 0 0 {L*10} ;\n}}\n\n")
    with open(os.path.join(d, "atoms#000000"), "w") as f:
        f.write(hdr + "\n".join(rows) + "\n")
    p = os.path.join(d, "object.data")
    with open(p, "w") as f:
        f.write(ETHANE_DECK.format(L=L * 10, n=n))
    return p


def _unit(v):
    v = np.asarray(v, dtype=np.float64)
    return v / np.linalg.norm(v)


def _cone(center, axis, bond, n, tilt_deg=70.5, phase=0.0):
    """n positions at `bond` from center, tilted off `axis` (methyl/NH3
    hydrogens)."""
    u = _unit(axis)
    a = np.array([1.0, 0.0, 0.0])
    if abs(u @ a) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    e1 = _unit(np.cross(u, a))
    e2 = np.cross(u, e1)
    t = np.radians(tilt_deg)
    out = []
    for k in range(n):
        ph = phase + 2 * np.pi * k / n
        d = u * np.cos(t) + (e1 * np.cos(ph) + e2 * np.sin(ph)) * np.sin(t)
        out.append(center + bond * d)
    return out


def _build_tripeptide():
    """ALA(NTER)-GLY-ALA(CTER) coordinates (Angstrom), atoms in RTF
    order per (patched) residue."""
    shift = np.array([3.8, 0.3, 0.2])
    out = []  # (species, xyz)
    for i, res in enumerate(("ALAn", "GLY", "ALAc")):
        N = np.array([0.0, 0.0, 0.0]) + i * shift
        CA = np.array([1.2, 0.8, 0.0]) + i * shift
        C = np.array([2.5, 0.3, 0.5]) + i * shift
        O = np.array([2.7, -0.9, 0.7]) + i * shift
        # HN bisects away from CA and the previous C (stays clear of -O)
        HN = N + 0.997 * _unit([0.14, -0.88, -0.45])
        # HA points away from N, C and CB
        HA = CA + 1.08 * _unit([0.0, 0.57, 0.92])
        CB = CA + 1.538 * _unit([-0.105, 0.945, -1.208])
        HBs = _cone(CB, CB - CA, 1.111, 3)
        delim = {"ALAn": "n", "GLY": "x", "ALAc": "c"}[res]
        rn = "ALA" if res != "GLY" else "GLY"

        def add(name, p):
            out.append((f"{name}{delim}{rn}", p))

        if res == "ALAn":
            HTs = _cone(N, N - CA, 1.04, 3, phase=0.5)
            add("N", N)
            add("HT1", HTs[0])
            add("HT2", HTs[1])
            add("HT3", HTs[2])
            add("CA", CA)
            add("HA", HA)
            add("CB", CB)
            add("HB1", HBs[0])
            add("HB2", HBs[1])
            add("HB3", HBs[2])
            add("C", C)
            add("O", O)
        elif res == "GLY":
            # two backbone HAs, no CB
            HA1 = CA + 1.08 * _unit([0.0, 0.57, 0.92])
            HA2 = CA + 1.08 * _unit([-0.25, 0.45, -1.05])
            add("N", N)
            add("HN", HN)
            add("CA", CA)
            add("HA1", HA1)
            add("HA2", HA2)
            add("C", C)
            add("O", O)
        else:  # ALAc: CTER replaces (C, O) group with (C, OT1, OT2)
            OT1 = O
            OT2 = C + 1.26 * _unit([0.5, 1.05, -0.35])
            add("N", N)
            add("HN", HN)
            add("CA", CA)
            add("HA", HA)
            add("CB", CB)
            add("HB1", HBs[0])
            add("HB2", HBs[1])
            add("HB3", HBs[2])
            add("C", C)
            add("OT1", OT1)
            add("OT2", OT2)
    return out


C36_DECK = """
simulate SIMULATE {{
  type=MD; system=system; integrator=integ; dt={dt}; maxloop=1000;
  printrate=100; ddc=ddc;
}}
ddc DDC {{ updateRate=10; }}
charmm POTENTIAL {{
  type=CHARMM; topfile=c36ish_prot.rtf; parfile=c36ish_prot.prm;
  cutoff=9.0 Angstrom; rcoulomb=9.0 Angstrom; epsilon_r=1.0; epsilon_rf=-1;
}}
integ INTEGRATOR {{ type=NGLF; T=300K; }}
system SYSTEM {{
  type=NORMAL; potential=charmm; neighbor=nbr; groups={grp};
  box=box; collection=collection;
}}
box BOX {{ type=ORTHORHOMBIC; pbc=7; h= {L} 0 0 0 {L} 0 0 0 {L} ; }}
nbr NEIGHBOR {{ type=NORMAL; deltaR=2.0; }}
free GROUP {{ type=FREE; }}
lang GROUP {{ type=LANGEVIN; Teq=300K; tau=1ps; }}
collection COLLECTION {{ mode=VARRECORDASCII; size={n}; files=atoms#; }}
"""


def charmm_tripeptide_deck(d, L=20.0, max_w=24, nve=False, dt_fs=0.5):
    """The c36 solvated tripeptide: ALA(NTER)-GLY-ALA(CTER) with one CMAP
    on GLY, centred, and up to max_w TIP3 waters on a 3.2 A grid clear of
    it, in an L A box (tests/data/c36ish_prot.rtf, .prm; cutoff 9 A,
    reaction field, deltaR 2 A); LANGEVIN 300 K, or FREE with nve.
    Returns the deck's path."""
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "data")
    for f in ("c36ish_prot.rtf", "c36ish_prot.prm"):
        shutil.copy(os.path.join(data, f), os.path.join(d, f))
    atoms = _build_tripeptide()
    pep = np.array([p for _, p in atoms])
    # center the peptide so it doesn't straddle the periodic boundary
    com = pep.mean(0)
    atoms = [(sp, p - com) for sp, p in atoms]
    pep = pep - com
    # water grid, skipping sites near the peptide (min-image distance)
    wbox = np.arange(-L / 2 + 1.8, L / 2 - 1.2, 3.2)
    hoff = [np.array([0.76, 0.59, 0.0]), np.array([-0.76, 0.59, 0.0])]
    n_w = 0
    for x in wbox:
        for y in wbox:
            for z in wbox:
                c = np.array([x, y, z])
                dv = pep - c
                dv = dv - L * np.round(dv / L)
                if np.min(np.linalg.norm(dv, axis=1)) < 3.4:
                    continue
                if n_w >= max_w:
                    break
                atoms.append((f"OH2xTIP3", c))
                atoms.append((f"H1xTIP3", c + hoff[0]))
                atoms.append((f"H2xTIP3", c + hoff[1]))
                n_w += 1
    grp = "free" if nve else "lang"
    rows = []
    for gid, (sp, p) in enumerate(atoms):
        rows.append(f"{gid} ATOM {sp} {grp} "
                    + " ".join("%.6f" % x for x in p) + " 0 0 0")
    n = len(rows)
    hdr = (f"particle FILEHEADER {{type=MULTILINE; datatype=VARRECORDASCII;"
           f" checksum=NONE;\nloop=0; time=0.0;\nnfiles=1; nrecord={n};"
           f" nfields=10;\n"
           f"field_names=id class type group rx ry rz vx vy vz;\n"
           f"field_types=u s s s f f f f f f;\n"
           f"h= {L} 0 0 0 {L} 0 0 0 {L} ;\n}}\n\n")
    with open(os.path.join(d, "atoms#000000"), "w") as f:
        f.write(hdr + "\n".join(rows) + "\n")
    p = os.path.join(d, "object.data")
    with open(p, "w") as f:
        f.write(C36_DECK.format(L=L, n=n, grp=grp, dt=dt_fs))
    return p



def alloy_eam_deck(d, nc, printrate, free=True):
    """The eam_deck crystal as a five-species FS alloy (ALLOY_FS: each
    atom's species by its row, round robin), more species than the EAM
    kernels take."""
    p = eam_deck(d, nc, printrate, free)
    names = list(ALLOY_FS)
    path = os.path.join(d, "atoms#000000")
    with open(path) as f:
        head, body = f.read().split("\n\n", 1)
    rows = body.strip().splitlines()
    rows = [ln.replace(" ATOM Cu ", f" ATOM {names[i % len(names)]} ", 1)
            for i, ln in enumerate(rows)]
    with open(path, "w") as f:
        f.write(head + "\n\n" + "\n".join(rows) + "\n")
    with open(p) as f:
        text = f.read()
    start = text.index("pot POTENTIAL")
    end = text.index("nglf INTEGRATOR")
    fs = " ".join(f"{k} = {v};" for k, v in ALLOY_FS.items())
    text = (text[:start] + f"pot POTENTIAL {{ type=EAM; form=FS; rmax=5.5 "
            f"Angstrom; {fs} }}\n" + text[end:])
    text = text.replace("species=Cu;", f"species={' '.join(names)};")
    text = text.replace("Cu SPECIES { type=ATOM; mass=63.55; charge=0; }",
                        "\n".join(f"{k} SPECIES {{ type=ATOM; mass=63.55; "
                                  "charge=0; }" for k in names))
    with open(p, "w") as f:
        f.write(text)
    return p

def eam_form_tables(form, dev):
    """Kernel tables of one EAM_FORM_DECKS form for one species, Cu."""
    from ddcmd_tpu_torch.core.species import Species
    from ddcmd_tpu_torch.objects import ObjectDB
    from ddcmd_tpu_torch.ops.eam_half import eam_kernel_tables
    from ddcmd_tpu_torch.potentials.eam import compile_eam, eam_device_tables

    db = ObjectDB()
    db.compile_string("pot POTENTIAL { type=EAM; rmax=5.5 Angstrom; "
                      + EAM_FORM_DECKS[form] + " }")
    parms = compile_eam(db, "pot", [Species("Cu", 0, "ATOM", 0.0, 63.55)])
    return eam_kernel_tables(eam_device_tables(parms, device=dev))


def eam_alloy_tables(dev):
    """A T = 2 FS alloy whose density b is asymmetric (the JAX package's
    tests/test_pallas_cellpair.py alloy): the case that tells
    rho(t_p, t_q) from rho(t_q, t_p)."""
    from ddcmd_tpu_torch.objects import units as U
    from ddcmd_tpu_torch.ops.eam_half import eam_kernel_tables
    from ddcmd_tpu_torch.potentials.eam import EamParms, eam_device_tables

    eV, Ang, rcut = U.unit_scale("eV"), U.unit_scale("Angstrom"), 0.55
    parms = EamParms(
        "FS", 2, rcut,
        dict(a=np.array([[0.8, 0.7], [0.7, 0.9]]) * eV,
             b=np.array([[2.0, 3.5], [1.2, 2.6]]) * eV * eV,
             c=np.array([[1.5, 1.4], [1.4, 1.6]]) * Ang,
             m=np.full((2, 2), 5.0), n=np.full((2, 2), 7.0),
             ro=np.full((2, 2), 1.0) * Ang, x=np.full((2, 2), rcut)), {})
    return eam_kernel_tables(eam_device_tables(parms, device=dev))


def with_tables(slots, args, tables, seed=None):
    """The same packed call with another form's parameter table (the
    last argument); with a seed, the records' species row set to random
    types 0..T-1 (an alloy on the same positions)."""
    if seed is not None:
        T = int(tables["n_species"])
        t = np.random.default_rng(seed).integers(0, T, slots.shape[::2])
        slots = slots.clone()
        slots[:, 4, :] = torch.as_tensor(t, dtype=torch.float32,
                                         device=slots.device)
    kw = dict(form=tables["kform"], T=int(tables["n_species"]),
              degree=tables["degree"])
    return slots, (*args[:-1], tables["params"]), kw


def eam_sums(rho_out, force_out):
    """Per-slot rho, total pe (pass A); per-slot force, virial6 (pass B)."""
    (p, q), (fp, fq, cell) = rho_out, force_out
    p, fp = pad_p(p, q), pad_p(fp, fq)
    ncell, _, cap = q.shape
    rho = (p[:, 0] + q[:, 0].reshape(-1)).double()
    e = (p[:, 1].double().sum() + q[:, 1].double().sum())
    f = (fp + fq[:, 0:3].transpose(1, 2).reshape(ncell * cap, 3)).double()
    assert not q[:, 2:].any() and not fq[:, 3:].any(), "unused q-side rows"
    return rho, e, f, cell[:, 0:6].double().sum(0)


def eam_agree(name, got, ref):
    """Raise unless two eam_sums agree within the tolerances of
    tests/test_pallas_cellpair.py:305-309 (energy rel 2e-5, force 5e-5
    of max(1, |f|max), virial rel 5e-3 abs 1.0; rho per slot, as the
    energy, rel 2e-5 of its largest value); returns (max |d rho|, max
    |d f|, force scale)."""
    (r1, e1, f1, v1), (r0, e0, f0, v0) = got, ref
    rerr = float((r1 - r0).abs().max())
    scale = max(1.0, float(f0.abs().max()))
    ferr = float((f1 - f0).abs().max())
    checks = {
        "rho": rerr <= 2e-5 * float(r0.abs().max()),
        "e": abs(float(e1 - e0)) <= 2e-5 * abs(float(e0)),
        "force": ferr < 5e-5 * scale,
        "virial": bool(((v1 - v0).abs() <= 5e-3 * v0.abs() + 1.0).all()),
    }
    if not all(checks.values()):
        raise AssertionError(f"{name}: outputs disagree: {checks} (rho err "
                             f"{rerr:.3g}, force err {ferr:.3g}, scale "
                             f"{scale:.4g})")
    return rerr, ferr, scale


def eam_ops(kw):
    """(density pass, force pass) f32 operations of an in-cutoff pair of a
    RATIONAL deck of Horner degree D (csrc/eam_forms.cuh).  Density pass:
    the values P/Q of its two fits, 4 a Horner step and a divide and a
    multiply each (8 (D - 1) + 4), the two cut tests and selects (4), and
    0.5 e and the four sums (5): 13 + 8 (D - 1); the derivative sums are
    dead code there and not counted.  Force pass: the Horner sums of the
    values and derivatives, 8 a step a fit, with the divide, the value
    and the derivative's 3 a fit (16 (D - 1) + 10), then the factors 2,
    the cuts, the force, its six sums and the virial: 40 + 16 (D - 1).
    The shifted form of a
    tabularFit=rational refit adds u = (r2 - X0) S for each fit (4) and,
    in the force pass, the chain rule's factor S on each derivative (2)."""
    assert kw["form"] in ("RATIONAL", "RATIONAL_SHIFTED"), kw
    steps = kw["degree"] - 1
    shifted = kw["form"] == "RATIONAL_SHIFTED"
    return 13 + 8 * steps + 4 * shifted, 40 + 16 * steps + 6 * shifted


def eam_compare(name, kernels, plains, slots, args, kw, tables,
                with_bound=False, device=False):
    """Both EAM kernels against their twins on the same CUDA tensors:
    pass A on `slots`, pass B on a copy holding the twin's dF in row 6.
    Returns {"rho": (max |d rho|, ms, plain ms, bound_ms, bound_by),
    "force": (max |d f|, ms, plain ms, bound_ms, bound_by)}, the bounds
    None unless with_bound (the rational forms only: eam_ops); with
    `device`, each pass's device time (device_us) is printed too."""
    from ddcmd_tpu_torch.ops.eam_half import embed_slots

    (rho_k, force_k), (rho_p, force_p) = kernels, plains
    ref_a = rho_p(slots, *args, **kw)
    fslots = slots.clone()
    embed_slots(fslots, *ref_a, tables)
    out_a, out_b = rho_k(slots, *args, **kw), force_k(fslots, *args, **kw)
    got = eam_sums(out_a, out_b)
    ref = eam_sums(ref_a, force_p(fslots, *args, **kw))
    torch.cuda.synchronize()
    rerr, ferr, scale = eam_agree(name, got, ref)
    bnd = {"rho": (None, None), "force": (None, None)}
    text = ""
    if with_bound:
        ops_a, ops_b = eam_ops(kw)
        ba = bound((slots, *args), out_a, ops_a)
        bb = bound((fslots, *args), out_b, ops_b)
        bnd = {"rho": ba[:2], "force": bb[:2]}
        text = (f"; bounds {1e3 * ba[0]:.3f} / {1e3 * bb[0]:.3f} us "
                f"({ba[1]} / {bb[1]}; {OPS_TEST} + {ops_a} / {OPS_TEST} + "
                f"{ops_b} operations a pair at degree {kw['degree']}, "
                f"{ba[2]} candidate pairs, {ba[3]} in cutoff)")
    if device:
        text += "; device {:.2f} / {:.2f} us/call (profiler)".format(
            device_us(lambda: rho_k(slots, *args, **kw), TIMED_CALLS,
                      "eam_half"),
            device_us(lambda: force_k(fslots, *args, **kw), TIMED_CALLS,
                      "eam_half"))
    t = {"rho": (rerr, time_calls(lambda: rho_k(slots, *args, **kw),
                                  TIMED_CALLS),
                 time_calls(lambda: rho_p(slots, *args, **kw), PLAIN_CALLS,
                            warm=1),
                 *bnd["rho"]),
         "force": (ferr, time_calls(lambda: force_k(fslots, *args, **kw),
                                    TIMED_CALLS),
                   time_calls(lambda: force_p(fslots, *args, **kw),
                              PLAIN_CALLS, warm=1), *bnd["force"])}
    phase("kernel", f"{name}: rho err {rerr:.3g}, force err {ferr:.3g} "
          f"(scale {scale:.4g}), e {float(got[1]):.8g} vs "
          f"{float(ref[1]):.8g}; rho kernel {1e3 * t['rho'][1]:.2f} us/call, "
          f"plain {1e3 * t['rho'][2]:.2f}; force kernel "
          f"{1e3 * t['force'][1]:.2f} us/call, plain "
          f"{1e3 * t['force'][2]:.2f}{text}")
    return t


def eam_sim_inputs(nc, dev, fit=False):
    """The EAM call the main path makes on the nc crystal's start state
    (eam_deck's, or with `fit` the tabularFit=rational deck's):
    (rho kernel, force kernel, slots, args, kw, tables, half grid, G)."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.simulate import Simulation

    with tempfile.TemporaryDirectory() as d:
        if fit:
            tabular_eam_deck(d, nc, 100, fit=True)
        else:
            eam_deck(d, nc, 100)
        sim = Simulation(*load(d), run_dir=d, device=dev)
    ss, perm, ov = sim._build_nbr(sim.ss)
    assert not bool(ov), "overflow packing the comparison case"
    term = sim.force_fn.terms[0]
    return (*term.kernel_inputs(ss.state, ss.box, perm), term.tables,
            term.grid, term.G)


def eam_crystal_inputs(nc, G, tables, dev, seed=3):
    """eam_kernel_inputs for a jittered fcc crystal of nc^3 unit cells on
    its plan_lanes grid, with the column group forced to G and random
    species 0..T-1."""
    from ddcmd_tpu_torch.ops.cellpair import build_cell_slots, half_grid
    from ddcmd_tpu_torch.ops.cellpair_half import grid_tensors, plan_lanes
    from ddcmd_tpu_torch.ops.eam_half import eam_kernel_inputs

    a = 0.3615
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    r = ((cells[:, None, :] + base).reshape(-1, 3) * a - nc * a / 2
         + rng.standard_normal((4 * nc ** 3, 3)) * 0.006)
    n = len(r)
    L = torch.tensor([nc * a] * 3, dtype=torch.float32, device=dev)
    rt = torch.tensor(r, dtype=torch.float32, device=dev)
    fmask = torch.ones(n, device=dev)
    grid = plan_lanes([nc * a] * 3, 0.55, 0.1, n)
    perm, ov = build_cell_slots(rt, fmask, L, grid)
    assert not bool(ov), "overflow packing the comparison case"
    hg = half_grid(grid)
    sidx = torch.as_tensor(rng.integers(0, int(tables["n_species"]), n),
                           device=dev)
    return eam_kernel_inputs(rt, sidx, fmask, perm, L, hg, tables,
                             grid_tensors(hg, dev, G)), hg


def eam_kernel_phase(dev):
    """Phase 3, EAM; returns {kernel entry: (max_abs_err, ms, plain_ms)}
    of the main-path case of each EAM kernel."""
    from ddcmd_tpu_torch.ops import eam_half as eh
    from ddcmd_tpu_torch.ops.cellpair_half import pack_stencil

    cell = ((eh.eam_rho_half, eh.eam_force_half),
            (eh.eam_rho_half_plain, eh.eam_force_half_plain))
    col = ((eh.eam_rho_half_col, eh.eam_force_half_col),
           (eh.eam_rho_half_col_plain, eh.eam_force_half_col_plain))
    res = {}
    # per-cell, on the nc = 12 crystal's slots: the deck's RATIONAL, the
    # other forms and the asymmetric alloy on the same positions
    rho_k, _, slots, args, kw, tables, hg, G = eam_sim_inputs(EAM_NC, dev)
    assert rho_k is eh.eam_rho_half and G == 1, (rho_k, G)
    assert (hg.ncells, hg.cap) == ((4, 5, 5), 128), (hg.ncells, hg.cap)
    what = f"nc={EAM_NC} crystal, {hg.ncell} cells, cap {hg.cap}"
    t = eam_compare(f"per-cell EAM RATIONAL T=1: {what}", *cell, slots,
                    args, kw, tables, with_bound=True, device=True)
    res["eam_rho"], res["eam_force"] = t["rho"], t["force"]
    for form in EAM_FORM_DECKS:
        ft = eam_form_tables(form, dev)
        eam_compare(f"per-cell EAM {form} T=1: {what}", *cell,
                    *with_tables(slots, args, ft), ft)
    at = eam_alloy_tables(dev)
    eam_compare(f"per-cell EAM FS alloy T=2 (asymmetric rho): {what}", *cell,
                *with_tables(slots, args, at, seed=5), at)
    del slots, args

    # column, on the nc = 32 crystal's slots, then against the per-cell
    # kernels on the same slots
    rho_k, _, slots, args, kw, tables, hg, G = eam_sim_inputs(EAM_BIG_NC, dev)
    U = args[0].shape[1]
    assert rho_k is eh.eam_rho_half_col and (hg.ncells, G, U) == \
        EAM_BIG_PLAN, (rho_k, hg.ncells, G, U)
    t = eam_compare(f"column EAM RATIONAL T=1: nc={EAM_BIG_NC} crystal, "
                    f"{hg.ncell} cells, cap {hg.cap}, G={G}, U={U}", *col,
                    slots, args, kw, tables, with_bound=True, device=True)
    res["eam_rho_col"], res["eam_force_col"] = t["rho"], t["force"]
    cell_args = (torch.as_tensor(pack_stencil(hg), device=dev), *args[2:])
    fslots = slots.clone()
    eh.embed_slots(fslots, *eh.eam_rho_half_plain(slots, *cell_args, **kw),
                   tables)
    got = eam_sums(eh.eam_rho_half_col(slots, *args, **kw),
                   eh.eam_force_half_col(fslots, *args, **kw))
    ref = eam_sums(eh.eam_rho_half(slots, *cell_args, **kw),
                   eh.eam_force_half(fslots, *cell_args, **kw))
    torch.cuda.synchronize()
    rerr, ferr, scale = eam_agree("column vs per-cell EAM", got, ref)
    ms_rho = time_calls(lambda: eh.eam_rho_half(slots, *cell_args, **kw),
                        TIMED_CALLS)
    ms_force = time_calls(lambda: eh.eam_force_half(fslots, *cell_args, **kw),
                          TIMED_CALLS)
    phase("kernel", f"column vs per-cell EAM kernels on the nc={EAM_BIG_NC} "
          f"slots: rho err {rerr:.3g}, force err {ferr:.3g} (scale "
          f"{scale:.4g}); per-cell rho kernel {1e3 * ms_rho:.2f} us/call, "
          f"force kernel {1e3 * ms_force:.2f} us/call, beside the column "
          f"kernels' {1e3 * res['eam_rho_col'][1]:.2f}, "
          f"{1e3 * res['eam_force_col'][1]:.2f} in this run")
    res["eam_rho_on_col_slots"] = (rerr, ms_rho)
    res["eam_force_on_col_slots"] = (ferr, ms_force)
    del slots, fslots, args, cell_args

    # the tabularFit=rational refit (kernel form RATIONAL_SHIFTED) on its
    # main paths' start slots: #4 on the nc = 12 refit deck's, #5 on the
    # nc = 32 refit deck's
    for nc, kernels, suffix, rho_want in (
            (EAM_NC, cell, "refit", eh.eam_rho_half),
            (EAM_BIG_NC, col, "col_refit", eh.eam_rho_half_col)):
        rho_k, _, slots, args, kw, tables, hg, G = eam_sim_inputs(nc, dev,
                                                                  fit=True)
        assert rho_k is rho_want and kw["form"] == "RATIONAL_SHIFTED", kw
        U = args[0].shape[1] if G > 1 else None
        assert G == 1 or (hg.ncells, G, U) == EAM_BIG_PLAN, (hg.ncells, G, U)
        t = eam_compare(
            f"{'column' if G > 1 else 'per-cell'} EAM RATIONAL_SHIFTED T=1: "
            f"nc={nc} refit deck (tabularFit=rational, Horner degree "
            f"{kw['degree']}, {args[-1].shape[1]} floats a row), {hg.ncell} "
            f"cells, cap {hg.cap}" + (f", G={G}, U={U}" if G > 1 else ""),
            *kernels, slots, args, kw, tables, with_bound=True, device=True)
        res[f"eam_rho_{suffix}"] = t["rho"]
        res[f"eam_force_{suffix}"] = t["force"]
        del slots, args

    # column on a grid with nz == G (aliased union), the alloy
    at = eam_alloy_tables(dev)
    (rho_k, _, slots, args, kw), hg = eam_crystal_inputs(8, 3, at, dev)
    assert rho_k is eh.eam_rho_half_col and hg.ncells[2] == 3, hg.ncells
    eam_compare(f"column EAM FS alloy T=2: nc=8 crystal, cells {hg.ncells}, "
                f"nz == G = 3 (aliased union, U={args[0].shape[1]})", *col,
                slots, args, kw, at)
    for cap in RAGGED_CAPS:
        ragged_eam_cases(dev, cell, col, tables, at, cap)
    big_grid_cases(dev, tables)
    return res


def ragged_eam_cases(dev, cell, col, tables, alloy, cap):
    """The per-cell and column EAM kernels against their plain versions
    on ragged_system(cap=cap): RATIONAL with one species and the
    asymmetric T = 2 alloy, the column kernels at G = 2 and at G = nz =
    4."""
    from ddcmd_tpu_torch.ops.cellpair import build_cell_slots, half_grid
    from ddcmd_tpu_torch.ops.cellpair_half import grid_tensors
    from ddcmd_tpu_torch.ops.eam_half import eam_kernel_inputs

    r, L, sidx, fmask, grid = ragged_system(cap=cap)
    n = len(r)
    rt = torch.tensor(r, device=dev)
    Lt = torch.tensor(L, dtype=torch.float32, device=dev)
    # binned unmasked, so the masked atoms keep their slots
    perm, ov = build_cell_slots(rt, torch.ones(n, device=dev), Lt, grid)
    assert not bool(ov), "overflow packing the ragged case"
    hg = half_grid(grid)
    for name, tab, species in (("RATIONAL T=1", tables, np.zeros(n, np.int64)),
                               ("FS alloy T=2", alloy, sidx)):
        for G in (1, 2, 4):
            _, _, slots, args, kw = eam_kernel_inputs(
                rt, torch.as_tensor(species, device=dev),
                torch.tensor(fmask, device=dev), perm, Lt, hg, tab,
                grid_tensors(hg, dev, G))
            counts = args[-2]
            live = torch.arange(hg.cap, device=dev)[None, :] < counts[:, None]
            assert sorted(set(counts.tolist())) == [*RAGGED_COUNTS, cap], \
                sorted(set(counts.tolist()))
            assert bool(((slots[:, 5] == 0) & live).any()), \
                "no masked slot inside the counts"
            what = ("per-cell EAM" if G == 1 else
                    f"column EAM G={G} (U={args[0].shape[1]})")
            eam_compare(f"{what} {name}: ragged occupancy, cells "
                        f"{hg.ncells} of {(*RAGGED_COUNTS, cap)} live slots, "
                        f"{int((fmask == 0).sum())} of {n} atoms masked",
                        *(cell if G == 1 else col), slots, args, kw, tab)


def big_grid_cases(dev, tables):
    """Plans of more than 65,535 cells (BIG_NCELLS) at cap 32, atoms in
    three cell layers and the rest empty: the per-cell pair kernel (#1,
    charged, T = 2), the full-stencil kernel (#3) on the same records and
    the per-cell EAM kernels (#4, the crystal's RATIONAL) against their
    plain versions."""
    from ddcmd_tpu_torch.ops import cellpair_full as cf
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.ops import eam_half as eh
    from ddcmd_tpu_torch.ops.cellpair import build_cell_slots, half_grid
    from ddcmd_tpu_torch.ops.cellpair_half import grid_tensors

    ncell = int(np.prod(BIG_NCELLS))
    assert ncell > 65535
    # #1: cells of 1.5 nm at rlist 1.4, 27 beads a live cell
    tabs, rcut = synthetic_tables()
    r, L = slab_lattice(BIG_NCELLS, 1.5)
    rng = np.random.default_rng(31)
    grid = made_grid(BIG_NCELLS, 32, rcut + 0.3)
    a = packed_inputs(r, rng.choice([-1.0, 0.0, 1.0], size=len(r)) * 0.3,
                      rng.integers(0, 2, size=len(r)), L, grid, tabs, dev)
    empty = float((a[3] == 0).float().mean())
    assert a[0].shape[0] == ncell and empty > 0.9, (a[0].shape, empty)
    what = (f"{ncell} cells {BIG_NCELLS}, cap 32, {len(r)} beads, "
            f"{100 * empty:.1f}% of the cells empty, charged T=2")
    kw = dict(krf=tabs["krf"], crf=tabs["crf"], keR=tabs["keR"],
              coulomb=True)
    compare(f"per-cell: {what}", ch.cellpair_half, ch.cellpair_half_plain, a,
            kw)
    fa, fkw, _ = full_call(grid, a, kw, dev)
    compare(f"full stencil: {what}", cf.cellpair_full, cf.cellpair_full_plain,
            fa, fkw)
    del a, fa
    # #4: cells of 0.75 nm at rlist 0.65, 27 atoms a live cell, 2.5 A apart
    r, L = slab_lattice(BIG_NCELLS, 0.75)
    n = len(r)
    grid = made_grid(BIG_NCELLS, 32, 0.65)
    rt = torch.tensor(r, dtype=torch.float32, device=dev)
    Lt = torch.tensor(L, dtype=torch.float32, device=dev)
    fmask = torch.ones(n, device=dev)
    perm, ov = build_cell_slots(rt, fmask, Lt, grid)
    assert not bool(ov), "overflow packing the big-grid case"
    hg = half_grid(grid)
    rho_k, force_k, slots, args, kw = eh.eam_kernel_inputs(
        rt, torch.zeros(n, dtype=torch.int64, device=dev), fmask, perm, Lt,
        hg, tables, grid_tensors(hg, dev, 1))
    empty = float((args[-2] == 0).float().mean())
    assert slots.shape[0] == ncell and empty > 0.9, (slots.shape, empty)
    eam_compare(f"per-cell EAM RATIONAL T=1: {ncell} cells {BIG_NCELLS}, cap "
                f"32, {n} atoms, {100 * empty:.1f}% of the cells empty",
                (rho_k, force_k),
                (eh.eam_rho_half_plain, eh.eam_force_half_plain), slots,
                args, kw, tables)


def kernel_phase(dev):
    """Phase 3; returns {kernel entry: (max_abs_err, ms, plain_ms)} of
    the main-path case of each kernel."""
    from ddcmd_tpu_torch.core.system import build_system
    from ddcmd_tpu_torch.models import load, martini_water
    from ddcmd_tpu_torch.ops import cellpair_full as cf
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.ops.cellpair_half import plan_lanes
    from ddcmd_tpu_torch.potentials.martini import martini_device_tables
    from ddcmd_tpu_torch.run.simulate import Simulation

    pair = (ch.cellpair_half, ch.cellpair_half_plain)
    col = (ch.cellpair_half_col, ch.cellpair_half_col_plain)
    full = (cf.cellpair_full, cf.cellpair_full_plain)
    res = {}
    with tempfile.TemporaryDirectory() as d:
        martini_water(d, n=6173)
        sd = build_system(load(d)[0], d, device=dev)
    L = sd.box.lengths.cpu().numpy().astype(np.float64)
    grid = plan_lanes(L, sd.rcut_max, sd.neighbor_deltaR, sd.state.n_local)
    assert (grid.ncell, grid.cap) == (80, 128), (grid.ncells, grid.cap)
    mtab = martini_device_tables(sd.potentials[0][2])
    water = dict(mtab, sigma=mtab["sigma"][:1, :1].numpy(),
                 eps=mtab["eps"][:1, :1].numpy(),
                 shift=mtab["shift"][:1, :1].numpy())
    n = sd.state.n_local
    r = sd.box.back_in_box(sd.state.r)[:n].cpu().numpy()
    args = packed_inputs(r, np.zeros(n), np.zeros(n, np.int64), L, grid,
                         water, dev)
    kw = dict(krf=water["krf"], crf=water["crf"], keR=water["keR"],
              coulomb=False)
    res["cellpair_half"] = compare(
        "per-cell: waterbox 6173 beads, 80 cells, cap 128, T=1", *pair,
        args, kw, with_bound=True, device_key="cellpair_half_kernel")
    # TPU #3, the full stencil, on the same water records, and against #1
    fa, fkw, ha = full_call(grid, args, kw, dev)
    res["cellpair_full_water"] = compare(
        "full stencil: waterbox 6173 beads, 80 cells, cap 128, T=1", *full,
        fa, fkw, with_bound=True, work=ha, device_key="cellpair_full_kernel")
    full_vs_half("the water slots", fa, fkw, ha)
    for n_syn, L_syn in ((800, 6.6), (220, 4.2), (60, 2.6)):
        r, q, tidx, tabs, rcut = synthetic(n_syn, L_syn)
        g = plan_lanes([L_syn] * 3, rcut, 0.3, n_syn)
        a = packed_inputs(r, q, tidx, [L_syn] * 3, g, tabs, dev)
        kwc = dict(krf=tabs["krf"], crf=tabs["crf"], keR=tabs["keR"],
                   coulomb=True)
        what = f"charged T=2 n={n_syn} L={L_syn} cells {g.ncells}"
        compare(f"per-cell: {what}", *pair, a, kwc)
        if min(g.ncells) <= 2:
            # #3 where -1 and +1 reach one cell through two images (2-cell
            # axes) or are the home cell's own images (1-cell axes)
            fa, fkw, ha = full_call(g, a, kwc, dev)
            compare(f"full stencil: {what} ({min(g.ncells)}-cell axes)",
                    *full, fa, fkw)
            full_vs_half(what, fa, fkw, ha)

    # (a) per-cell kernel with exclusions on a small bilayer
    with tempfile.TemporaryDirectory() as d:
        bilayer_deck(d, SMALL_NX, 20.0, 200)
        sim = Simulation(*load(d), run_dir=d, device=dev)
        kernel, a, kw, hg = sim_kernel_inputs(sim)
    assert kernel is ch.cellpair_half and kw["excl"], (kernel, kw)
    res["cellpair_half_excl"] = compare(
        f"per-cell + exclusions: bilayer nx={SMALL_NX} "
        f"{sim.sysdef.state.n_local} beads, cells {hg.ncells}, cap "
        f"{hg.cap}, T={a[-1].shape[0]}, Coulomb", *pair, a, kw,
        with_bound=True)

    # (b) the column kernel on the full bilayer's packed slots
    with tempfile.TemporaryDirectory() as d:
        bilayer_deck(d, BILAYER_NX, EQ_DT, 200)
        sim = Simulation(*load(d), run_dir=d, device=dev)
        kernel, a, kw, hg = sim_kernel_inputs(sim)
    G = a[2].shape[0]
    assert kernel is ch.cellpair_half_col and kw["excl"], (kernel, kw)
    res["cellpair_half_col"] = compare(
        f"column + exclusions: full bilayer {sim.sysdef.state.n_local} "
        f"beads, cells {hg.ncells}, G={G}, U={a[1].shape[1]}, cap "
        f"{hg.cap}", *col, a, kw, with_bound=True)
    # (d) column kernel vs per-cell kernel on the same slots
    from ddcmd_tpu_torch.ops.cellpair_half import pack_stencil

    cell_args = (a[0], torch.as_tensor(pack_stencil(hg), device=dev), *a[3:])
    got = per_slot(*ch.cellpair_half_col(*a, **kw))
    ref = per_slot(*ch.cellpair_half(*cell_args, **kw))
    torch.cuda.synchronize()
    ferr, scale = agree("column vs per-cell", got, ref)
    ms_cell = time_calls(lambda: ch.cellpair_half(*cell_args, **kw),
                         TIMED_CALLS)
    phase("kernel", f"column vs per-cell kernel on the full bilayer slots: "
          f"force err {ferr:.3g} (scale {scale:.4g}); per-cell kernel "
          f"{1e3 * ms_cell:.2f} us/call, beside the column kernel's "
          f"{1e3 * res['cellpair_half_col'][1]:.2f} in this run")
    res["cellpair_half_on_col_slots"] = (ferr, ms_cell)
    # (e) TPU #3 on the full bilayer's records (it has no exclusions:
    # rows 6-7 are not read), and against #1 without exclusions there
    fa, fkw, ha = full_call(sim.grid, a, kw, dev)
    res["cellpair_full"] = compare(
        f"full stencil: full bilayer {sim.sysdef.state.n_local} beads, "
        f"cells {sim.grid.ncells}, cap {hg.cap}, T={a[-1].shape[0]}, "
        f"Coulomb", *full, fa, fkw, with_bound=True, work=ha,
        device_key="cellpair_full_kernel")
    full_vs_half("the full bilayer slots", fa, fkw, ha)
    # its atomic sums are unordered: two calls agree within tolerance
    ferr, scale = agree("two calls of #3 on the full bilayer slots",
                        per_slot(*cf.cellpair_full(*fa, **fkw)),
                        per_slot(*cf.cellpair_full(*fa, **fkw)))
    phase("kernel", f"two calls of #3 on the full bilayer slots: force "
          f"err {ferr:.3g} (scale {scale:.4g})")
    del sim, a, cell_args, fa, ha

    # (c) the column kernel on a charged grid with nz == G
    r, q, tidx, tabs, rcut = synthetic(6173, 9.4)
    g = plan_lanes([9.4] * 3, rcut, 0.3, 6173)
    G = g.ncells[2]
    assert 2 <= G <= 5, g.ncells
    a = packed_inputs(r, q, tidx, [9.4] * 3, g, tabs, dev, G=G)
    compare(f"column: charged T=2 n=6173 cells {g.ncells}, nz == G = {G} "
            f"(aliased union, U={a[1].shape[1]})", *col, a,
            dict(krf=tabs["krf"], crf=tabs["crf"], keR=tabs["keR"],
                 coulomb=True))
    for cap in RAGGED_CAPS:
        ragged_pair_cases(dev, cap)
    return res


def ragged_pair_tables():
    """(tables, rcut) of two LJ types with a reaction field at
    RAGGED_RCUT, sized for ragged_system's ~2 A closest pairs."""
    from ddcmd_tpu_torch.objects import units as U

    sigma = np.array([[0.20, 0.24], [0.24, 0.22]])
    eps = np.array([[5.0, 5.6], [5.6, 4.4]])
    rcut = RAGGED_RCUT
    sr6 = (sigma / rcut) ** 6
    f32 = lambda x: float(np.float32(x))                       # noqa: E731
    return dict(sigma=sigma, eps=eps, shift=-4 * eps * (sr6 ** 2 - sr6),
                rcut2=f32(rcut ** 2), krf=f32(0.5 / rcut ** 3),
                crf=f32(1.5 / rcut), keR=f32(U.ke / 15.0)), rcut


def chain_exclusions(r, rng):
    """Exclusion pairs of chains of four mutual near neighbours (three
    bonds and the two 1-3 pairs each) over about a third of the
    particles, as the exclusion channels encode them."""
    free = np.ones(len(r), bool)
    pairs = []
    for i in rng.permutation(len(r))[:len(r) // 12]:
        if not free[i]:
            continue
        d = np.linalg.norm(r - r[i], axis=1)
        d[~free] = np.inf
        chain = np.argsort(d)[:4]
        if not np.isfinite(d[chain]).all():
            continue
        free[chain] = False
        a, b, c, e = (int(x) for x in chain)
        pairs += [(a, b), (b, c), (c, e), (a, c), (b, e)]
    return np.asarray(pairs, np.int64)


def drift(rng, n, skin=RAGGED_SKIN):
    """(n, 3) displacements of at most skin / 2: one common step of 0.9
    skin / 2 along +-x, which carries the particles near an x face across
    it, and a jitter of at most 0.1 skin / 2 each, which moves them apart
    by less than their closest distance."""
    u = np.array([rng.choice([-1.0, 1.0]), 0.0, 0.0])
    j = rng.standard_normal((n, 3))
    j *= rng.random((n, 1)) / np.linalg.norm(j, axis=1, keepdims=True)
    return (0.9 * u + 0.1 * j) * skin / 2


def ragged_pair_cases(dev, cap):
    """The pair kernels against their plain versions on
    ragged_system(cap=cap), charged, T = 2, a tenth of the live slots
    masked in the validity row: #1, and #2 at G = 2 and at G = nz = 4,
    without and with exclusion channels, and #3 over the full stencil of
    the same records (also against #1); then the same on a drifted
    state: the slots packed from a binning made before every particle
    moved by up to RAGGED_SKIN / 2, so particles lie outside their cells
    (what the box pruning must not drop a pair for)."""
    from ddcmd_tpu_torch.ops import cellpair_full as cf
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.run.forces import _excl_channels

    r, L, tidx, valid, grid = ragged_system(cap=cap)
    n = len(r)
    rng = np.random.default_rng(41)
    q = rng.choice([-0.3, 0.0, 0.3], n)
    tabs, _ = ragged_pair_tables()
    kw = dict(krf=tabs["krf"], crf=tabs["crf"], keR=tabs["keR"],
              coulomb=True)
    moved = r + drift(rng, n)
    pair = {1: (ch.cellpair_half, ch.cellpair_half_plain)}
    pair[2] = pair[4] = (ch.cellpair_half_col, ch.cellpair_half_col_plain)
    full = (cf.cellpair_full, cf.cellpair_full_plain)
    for drifted in (False, True):
        ex = _excl_channels(chain_exclusions(moved if drifted else r, rng), n)
        for excl in (False, True):
            for G in (1, 2, 4):
                a = packed_inputs(r, q, tidx, L, grid, tabs, dev, G=G,
                                  ex=ex if excl else None,
                                  r_pack=moved if drifted else None,
                                  valid=valid)
                counts = a[-4]
                live = torch.arange(cap, device=dev)[None, :] < counts[:, None]
                assert sorted(set(counts.tolist())) == \
                    [*RAGGED_COUNTS, cap], sorted(set(counts.tolist()))
                assert bool(((a[0][:, 5] == 0) & live).any()), \
                    "no masked slot inside the counts"
                if drifted:
                    edge = float(L[0]) / grid.ncells[0]
                    outside = (a[0][:, 0:3].abs() > edge / 2).any(1) & live
                    assert bool(outside.any()), "no particle left its cell"
                what = "per-cell" if G == 1 else \
                    f"column G={G} (U={a[1].shape[1]})"
                state = ("drifted by up to skin/2 after binning"
                         if drifted else "ragged occupancy")
                text = (f"{state}, cells {grid.ncells} of "
                        f"{(*RAGGED_COUNTS, cap)} live slots, "
                        f"{int((valid == 0).sum())} of {n} masked, charged T=2")
                compare(f"{what}{' + exclusions' if excl else ''}: {text}",
                        *pair[G], a, dict(kw, excl=excl))
                if G == 1 and not excl:
                    # #3 over the 27 directions on the same records
                    fa, fkw, ha = full_call(grid, a, kw, dev)
                    compare(f"full stencil: {text}", *full, fa, fkw)
                    full_vs_half(text, fa, fkw, ha)


ENTRY_DECKS = (("water box", lambda d: water_deck(d, 6173, 100)),
               ("full bilayer", lambda d: bilayer_deck(d, BILAYER_NX, EQ_DT,
                                                       200)))


def start_sim(make_deck, dev):
    """A Simulation on the start state of the deck make_deck(dir) writes."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.simulate import Simulation

    with tempfile.TemporaryDirectory() as d:
        make_deck(d)
        return Simulation(*load(d), run_dir=d, device=dev)


def entry_calls(sim, dev):
    """TPU #3's entry point on sim's current state: (full, half, what),
    full() = make_cellpair_full + cellpair_eval_full, half() =
    cellpair_eval_half (#1 without exclusions) on the same state, each
    returning (f, e, virial, pe), and a description of the state."""
    from ddcmd_tpu_torch.ops.cellpair import half_grid
    from ddcmd_tpu_torch.ops.cellpair_full import (cellpair_eval_full,
                                                   make_cellpair_full)
    from ddcmd_tpu_torch.ops.cellpair_half import (cellpair_eval_half,
                                                   grid_tensors, pack_stencil)
    from ddcmd_tpu_torch.potentials.martini import martini_device_tables

    ss, perm, ov = sim._build_nbr(sim.ss)
    assert not bool(ov), "overflow packing the entry-point case"
    st, sd = ss.state, sim.sysdef
    parms = next(p[2] for p in sd.potentials if p[0] == "MARTINI")
    tables = martini_device_tables(parms, device=dev)
    tidx = torch.as_tensor(parms.species_lj_type, device=dev)[st.species]
    coul = bool(st.q.abs().max() > 0)
    grid = sim.grid
    stencil = torch.as_tensor(pack_stencil(grid), device=dev)
    eval_fn = make_cellpair_full(grid, tables, coulomb=coul)
    hg = half_grid(grid)
    gt = grid_tensors(hg, dev)
    r, q, L = st.r, st.q, ss.box.lengths
    what = (f"{st.n_local} particles, cells {grid.ncells}, cap {grid.cap}, "
            f"T={tables['sigma'].shape[0]}, Coulomb {coul}")
    return ((lambda: cellpair_eval_full(r, q, tidx, perm, L, grid, tables,
                                        stencil, eval_fn)),
            (lambda: cellpair_eval_half(r, q, tidx, perm, L, hg, tables, gt,
                                        coulomb=coul)), what)


def full_entry_phase(dev, counters_zero, all_counters):
    """TPU #3 through its entry point, its main path (no simulate path
    reaches it): make_cellpair_full + cellpair_eval_full on the water
    box's and the full bilayer's start states, every launch counter set
    to 0 just before each call and read just after; the result held
    against cellpair_eval_half (#1 without exclusions) on the same state
    at the tolerances of agree().  Returns #3's launches."""
    launches = 0
    for name, make_deck in ENTRY_DECKS:
        full, half, what = entry_calls(start_sim(make_deck, dev), dev)
        counters_zero()
        f, e, vir, pe = full()
        torch.cuda.synchronize()
        c = all_counters()
        assert c["cellpair_full"] == 1 and sum(c.values()) == 1, c
        launches += c["cellpair_full"]
        ref = half()
        v6 = lambda v: torch.stack([v[0, 0], v[1, 1], v[2, 2], v[0, 1],  # noqa: E731
                                    v[0, 2], v[1, 2]]).double()
        ok = torch.isfinite(f).all() and torch.isfinite(e)
        assert ok, f"{name}: non-finite entry-point result"
        ferr, scale = agree(f"entry point on the {name}",
                            (f.double(), pe.double(), e.double(), v6(vir)),
                            (ref[0].double(), ref[3].double(),
                             ref[1].double(), v6(ref[2])))
        ms = time_calls(full, PLAIN_CALLS)
        phase("full-entry", f"cellpair_eval_full on the {name} ({what}): "
              f"e {float(e):.8g} vs half-stencil {float(ref[1]):.8g}, "
              f"force err {ferr:.3g} (scale {scale:.4g}); #3 launched "
              f"{c['cellpair_full']} time(s), no other kernel; "
              f"{1e3 * ms:.2f} us a call (events)")
        del full, half
    return launches


def brick_inputs(r, q, tidx, L, shape, idx3, rcut, skin, rcut2, dev,
                 ex=None):
    """One brick's extended-grid call of a `shape` plan, as the mesh step
    packs it: the rows whose brick-frame fraction lies in brick idx3's
    core or halo shell (so the halo cells are filled), binned and packed
    on the card, with the exclusion channels `ex` (n, 2) when given.
    Returns (plan, (slots, stencil, L8, counts))."""
    from ddcmd_tpu_torch.parallel import shard_cells as sc

    cp = sc.plan_shard_cells(L, shape, rcut, skin, len(r))
    geom = sc.dev_geom(cp, idx3, dev)
    Lv = torch.tensor(L, dtype=torch.float32, device=dev)
    u = sc.brick_frame_frac(torch.tensor(r, dtype=torch.float32, device=dev),
                            Lv, cp, geom)
    inside = torch.ones(len(r), dtype=torch.bool, device=dev)
    for a in range(3):
        if cp.open_axes[a]:
            h = 1.0 / cp.ncore[a]
            inside &= (u[:, a] >= -0.5 - h) & (u[:, a] < 0.5 + h)
    perm, counts, ov = sc.bin_pool_ext(u, inside, cp)
    assert not bool(ov), "overflow packing the comparison case"
    span_cart = geom[1] * Lv
    slots = sc.pack_slots_ext(
        u, torch.tensor(q, device=dev), torch.tensor(tidx, device=dev), perm,
        span_cart, cp, None if ex is None else torch.tensor(ex, device=dev))
    return cp, (slots, torch.as_tensor(cp.stencil_packed, device=dev),
                sc.ext_L8(span_cart, cp, rcut2), counts)


def bilayer_arrays(nx, dev):
    """The nx bilayer deck's start state on the host: positions in the
    box, charges, LJ types, exclusion channels (run/forces.
    _excl_channels), box lengths, rcut and skin, and the Martini kernel
    tables on `dev` (T = 5, reaction field)."""
    from ddcmd_tpu_torch.core.system import build_system
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.potentials.martini import martini_device_tables
    from ddcmd_tpu_torch.run.forces import _excl_channels

    with tempfile.TemporaryDirectory() as d:
        bilayer_deck(d, nx, EQ_DT, 200)
        sd = build_system(load(d)[0], d)
    n = sd.state.n_local
    parms = sd.potentials[0][2]
    return dict(r=sd.box.back_in_box(sd.state.r)[:n].numpy(),
                q=sd.state.q[:n].numpy(),
                tidx=parms.species_lj_type[sd.state.species[:n].numpy()],
                ex=_excl_channels(sd.bonded.exclusions, n),
                L=sd.box.lengths.numpy().astype(np.float64),
                rcut=sd.rcut_max, skin=sd.neighbor_deltaR,
                tables=martini_device_tables(parms, device=dev))


def sentinel_zero(name, out_q):
    """The sentinel's q-side rows (the last slot cell) stay exactly 0."""
    if out_q[-1].any():
        raise AssertionError(f"{name}: out_q[sentinel] is not 0")


def fcc(nc, seed, a=0.3615):
    """A jittered fcc crystal of nc^3 unit cells: (positions, box edge)."""
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    cells = np.stack(np.meshgrid(*[np.arange(nc)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    r = ((cells[:, None, :] + base).reshape(-1, 3) * a - nc * a / 2
         + rng.standard_normal((4 * nc ** 3, 3)) * 0.006)
    return r, nc * a


def ext_kernel_phase(dev):
    """Phase 3, extended grids (TPU #6 and #7); returns {kernel entry:
    (max_abs_err, ms, plain_ms, bound_ms, bound_by)} of the mesh phases'
    calls, the (1,1,1) plans."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.ops import eam_half as eh
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    ext = (ch.cellpair_half_ext, ch.cellpair_half_plain)
    res = {}
    # (a) the (1,1,1) water plan's slots, and #1 on the same cells
    with tempfile.TemporaryDirectory() as d:
        water_deck(d, 6173, 100)
        ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev)
    kernel, args, kw = ps.step_fn.kernel_inputs(ps.fields, ps.mask)
    cp = ps.cplan
    assert kernel is ch.cellpair_half_ext and cp.n_slot == cp.n_prog + 1
    res["cellpair_half_ext"] = compare(
        f"extended grid (1,1,1): water box 6173 beads, {cp.n_prog} core "
        f"cells + sentinel, cap {cp.cap}, T=1", *ext, args, kw,
        with_bound=True, device_key="cellpair_half_kernel")
    outs = kernel(*args, **kw)
    sentinel_zero("extended grid (1,1,1)", outs[1])
    slots, stencil, L8, counts = args[:4]
    npc = cp.n_prog * cp.cap
    got = per_slot(*outs)
    ref = per_slot(*ch.cellpair_half(slots[:cp.n_prog].contiguous(), stencil,
                                     L8, counts[:cp.n_prog].contiguous(),
                                     *args[4:], **kw))
    torch.cuda.synchronize()
    ferr, scale = agree("extended vs per-cell kernel",
                        (got[0][:npc], got[1][:npc], got[2], got[3]), ref)
    phase("kernel", f"extended-grid vs per-cell kernel on the (1,1,1) water "
          f"slots: force err {ferr:.3g} (scale {scale:.4g})")
    del ps

    # (b) one brick of a (2,2,2) plan at the water density: charged, T=2
    r, q, tidx, tabs, rcut = synthetic(6173, 9.4)
    cp, a = brick_inputs(r, q, tidx, [9.4] * 3, (2, 2, 2), (1, 0, 1), rcut,
                         0.4, tabs["rcut2"], dev)
    t3 = [torch.tensor(np.asarray(tabs[k]), dtype=torch.float32, device=dev)
          for k in ("sigma", "eps", "shift")]
    kwc = dict(krf=tabs["krf"], crf=tabs["crf"], keR=tabs["keR"],
               coulomb=True)
    halo = int(a[3][cp.n_prog:-1].sum())
    assert halo > 0 and int(a[3][-1]) == 0, (halo, int(a[3][-1]))
    compare(f"extended grid, brick (1,0,1) of (2,2,2): charged T=2 n=6173 "
            f"L=9.4, ncore {cp.ncore}, {cp.n_slot} slot cells, "
            f"{int(a[3][:cp.n_prog].sum())} core + {halo} halo particles",
            *ext, (*a, *t3), kwc)
    sentinel_zero("extended grid (2,2,2) brick", ch.cellpair_half_ext(
        *a, *t3, **kwc)[1])

    # (c) 2-cell periodic axes: a (2,1,1) plan in a 9.4 x 3.2 x 3.2 box
    L = np.array([9.4, 3.2, 3.2])
    m = np.round(L * 7.47 ** (1 / 3)).astype(int)     # the water density
    g = np.stack(np.meshgrid(*[np.arange(k) for k in m], indexing="ij"),
                 -1).reshape(-1, 3)
    rng = np.random.default_rng(5)
    n = len(g)
    r = ((g + 0.5) / m - 0.5) * L + (rng.random((n, 3)) - 0.5) * 0.1
    q = rng.choice([-1.0, 0.0, 1.0], size=n) * 0.3
    tidx = rng.integers(0, 2, size=n)
    cp, a = brick_inputs(r, q, tidx, L, (2, 1, 1), (1, 0, 0), rcut, 0.4,
                         tabs["rcut2"], dev)
    assert cp.ncore[1:] == (2, 2), cp.ncore
    compare(f"extended grid, brick (1,0,0) of (2,1,1): box {L.tolist()}, "
            f"{n} beads, ncore "
            f"{cp.ncore} (2-cell periodic y and z)", *ext, (*a, *t3), kwc)

    # (d) #6 with exclusions: the full bilayer's (1,1,1) plan, then one
    # brick of a (2,2,2) plan of the nx = 8 bilayer
    with tempfile.TemporaryDirectory() as d:
        bilayer_deck(d, BILAYER_NX, EQ_DT, 200)
        ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev)
    kernel, args, kw = ps.step_fn.kernel_inputs(ps.fields, ps.mask)
    cp = ps.cplan
    assert kernel is ch.cellpair_half_ext and kw["excl"], kw
    res["cellpair_half_ext_excl"] = compare(
        f"extended grid (1,1,1) + exclusions: full bilayer "
        f"{ps.sysdef.state.n_local} beads, {cp.n_prog} core cells "
        f"{cp.ncore} + sentinel, cap {cp.cap}, T={args[-1].shape[0]}, "
        f"Coulomb", *ext, args, kw, with_bound=True)
    sentinel_zero("extended grid (1,1,1) + exclusions",
                  kernel(*args, **kw)[1])
    del ps, args
    b = bilayer_arrays(SMALL_NX, dev)
    t5 = [b["tables"][k] for k in ("sigma", "eps", "shift")]
    kwx = dict(krf=b["tables"]["krf"], crf=b["tables"]["crf"],
               keR=b["tables"]["keR"], coulomb=True, excl=True)
    cp, a = brick_inputs(b["r"], b["q"], b["tidx"], b["L"], (2, 2, 2),
                         (1, 1, 0), b["rcut"], b["skin"],
                         b["tables"]["rcut2"], dev, ex=b["ex"])
    halo = int(a[3][cp.n_prog:-1].sum())
    assert halo > 0 and int(a[3][-1]) == 0, (halo, int(a[3][-1]))
    assert a[0][:, 6].any(), "no exclusion channels in the records"
    compare(f"extended grid + exclusions, brick (1,1,0) of (2,2,2): bilayer "
            f"nx={SMALL_NX} {len(b['r'])} beads, ncore {cp.ncore}, "
            f"{cp.n_slot} slot cells, {int(a[3][:cp.n_prog].sum())} core + "
            f"{halo} halo beads, T=5, Coulomb", *ext, (*a, *t5), kwx)
    sentinel_zero("extended grid + exclusions (2,2,2) brick",
                  ch.cellpair_half_ext(*a, *t5, **kwx)[1])

    # (e) EAM: the (1,1,1) nc = 32 plan, then a brick of a (2,2,2) plan at
    # the copper density
    eam_ext = ((eh.eam_rho_half_ext, eh.eam_force_half_ext),
               (eh.eam_rho_half_plain, eh.eam_force_half_plain))
    with tempfile.TemporaryDirectory() as d:
        eam_deck(d, EAM_BIG_NC, 100)
        ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev)
    kernel, args, kw = ps.step_fn.kernel_inputs(ps.fields, ps.mask)
    cp, tables, params = ps.cplan, ps.tables, args[-1]
    assert kernel is eh.eam_rho_half_ext
    t = eam_compare(f"extended-grid EAM (1,1,1): nc={EAM_BIG_NC} crystal, "
                    f"{cp.n_prog} core cells + sentinel, cap {cp.cap}",
                    *eam_ext, args[0], args[1:], kw, tables, with_bound=True,
                    device=True)
    res["eam_rho_ext"], res["eam_force_ext"] = t["rho"], t["force"]
    sentinel_zero("extended-grid EAM (1,1,1)", kernel(*args, **kw)[1])
    del ps, args
    # the tabularFit=rational refit (RATIONAL_SHIFTED) on its (1,1,1) plan
    with tempfile.TemporaryDirectory() as d:
        tabular_eam_deck(d, EAM_BIG_NC, 100, fit=True)
        ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev)
    rkernel, rargs, rkw = ps.step_fn.kernel_inputs(ps.fields, ps.mask)
    assert rkernel is eh.eam_rho_half_ext and \
        rkw["form"] == "RATIONAL_SHIFTED", rkw
    t = eam_compare(f"extended-grid EAM RATIONAL_SHIFTED (1,1,1): nc="
                    f"{EAM_BIG_NC} refit deck, {ps.cplan.n_prog} core cells "
                    f"+ sentinel, cap {ps.cplan.cap}, Horner degree "
                    f"{rkw['degree']}", *eam_ext, rargs[0], rargs[1:], rkw,
                    ps.tables, with_bound=True, device=True)
    res["eam_rho_ext_refit"] = t["rho"]
    res["eam_force_ext_refit"] = t["force"]
    sentinel_zero("extended-grid EAM refit (1,1,1)",
                  rkernel(*rargs, **rkw)[1])
    del ps, rargs
    r, L = fcc(EAM_BIG_NC, seed=4)
    cp, a = brick_inputs(r, np.zeros(len(r)), np.zeros(len(r), np.int64),
                         [L] * 3, (2, 2, 2), (0, 1, 1), 0.55, 0.1,
                         tables["rcut2"], dev)
    eam_compare(f"extended-grid EAM, brick (0,1,1) of (2,2,2): nc="
                f"{EAM_BIG_NC} crystal, ncore {cp.ncore}, {cp.n_slot} slot "
                f"cells, {int(a[3][cp.n_prog:].sum())} halo atoms", *eam_ext,
                a[0], (*a[1:], params), kw, tables)
    fslots = a[0].clone()
    fslots[:, 6, :] = 0.01
    for k in eam_ext[0]:
        sentinel_zero(f"{k.__name__} brick", k(fslots, *a[1:], params,
                                                **kw)[1])
    return res


def mesh_phases(card, dev, counters_zero, counters, single_rates):
    """Phases 10 and 11: ParallelSimulation at (1,1,1) on the card;
    returns the extended-grid kernels' launch counts of their runs."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    launches = {}
    cases = (("water", lambda d: water_deck(d, 6173, 10), MESH_STEPS, 310.0,
              ("cellpair_half_ext",)),
             ("eam", lambda d: eam_deck(d, EAM_BIG_NC, 10), MESH_EAM_STEPS,
              EAM_T, ("eam_rho_ext", "eam_force_ext")))
    for name, make_deck, steps, T0, kernels in cases:
        with tempfile.TemporaryDirectory() as d:
            make_deck(d)
            sim = Simulation(*load(d), run_dir=d, device=dev)
            sim.first_energy()
            e1 = float(sim.ss.energy.eion)
            del sim
            ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev)
        e_mesh = ps.first_energy()
        rel = abs(e_mesh - e1) / abs(e1)
        assert rel <= 2e-5, f"{name}: mesh first energy {e_mesh} vs {e1}"
        lines = []
        counters_zero()
        ps.run(steps, print_fn=lines.append, max_steps_per_dispatch=DISPATCH)
        c = counters()
        for k in kernels:
            assert c[k] >= steps, c
            launches[k] = c[k]
        assert not any(v for k, v in c.items() if k not in kernels), c
        n = ps.sysdef.state.n_local
        assert ps.loop == steps and int(ps.mask.sum()) == n
        loops = np.array([int(ln.split()[0]) for ln in lines])
        temps = np.array([float(ln.split("T=")[1].split()[0])
                          for ln in lines])
        epot = np.array([float(ln.split("epot/N=")[1].split()[0])
                         for ln in lines])
        assert np.isfinite(temps).all() and np.isfinite(epot).all(), \
            "non-finite scalars"
        temp = float(temps[loops > steps - TAIL].mean())
        assert abs(temp - T0) <= TEMP_TOL, f"{name}: mean T {temp}"
        rate, tail = tail_rate(ps)
        cp = ps.cplan
        phase("mesh", f"{name} at (1,1,1): {n} particles, ncore {cp.ncore} "
              f"cap {cp.cap}; first energy {e_mesh:.8g} vs single-device "
              f"{e1:.8g} (rel {rel:.2g}); {steps} NVT steps (dispatch "
              f"{DISPATCH}): mean T {temp:.2f} K over the last {TAIL} steps, "
              f"launches {[c[k] for k in kernels]}, {rate:.1f} steps/s over "
              f"the last {tail} steps vs single-device "
              f"{single_rates[name]:.1f} (JAX yardstick: within ~15% of "
              f"unsharded, bench.py:307-308; not gated) on {card}")
        del ps
    return launches


def mesh_bilayer_phase(card, dev, d, counters_zero, all_counters,
                       single_rate):
    """Phase 12: the full bilayer through ParallelSimulation at (1,1,1)
    from phase 6's 20 fs restart in `d`: first energy against the
    single-device Simulation's on the same restart, then MESH_BL_STEPS
    NPT steps through #6 with exclusions only.  Returns #6-excl's
    launches."""
    from ddcmd_tpu_torch.integrators.constraints import constraint_residual
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    restart = os.path.join(d, "restart")
    sim = Simulation(*load(d, restart), run_dir=d, device=dev)
    sim.first_energy()
    e1 = float(sim.ss.energy.eion)
    del sim
    ps = ParallelSimulation(*load(d, restart), shape=(1, 1, 1), device=dev)
    e_mesh = ps.first_energy()
    rel = abs(e_mesh - e1) / abs(e1)
    assert rel <= 2e-5, f"mesh bilayer first energy {e_mesh} vs {e1}"
    L0 = ps.Lv.cpu().numpy().astype(np.float64)
    lines = []
    loop0 = ps.loop
    counters_zero()
    ps.run(MESH_BL_STEPS, print_fn=lines.append,
           max_steps_per_dispatch=DISPATCH)
    c = all_counters()
    steps = MESH_BL_STEPS
    assert c["cellpair_half_ext_excl"] >= steps, c
    assert c["cellpair_half_ext"] == c["cellpair_half_ext_excl"], c
    assert not any(v for k, v in c.items()
                   if k not in ("cellpair_half_ext",
                                "cellpair_half_ext_excl")), c
    n = ps.sysdef.state.n_local
    assert ps.loop == loop0 + steps and int(ps.mask.sum()) == n
    loops = np.array([int(ln.split()[0]) for ln in lines])
    temps = np.array([float(ln.split("T=")[1].split()[0]) for ln in lines])
    assert np.isfinite(temps).all(), "non-finite scalars"
    temp = float(temps[loops > loop0 + steps - TAIL].mean())
    assert abs(temp - BILAYER_T) <= TEMP_TOL, f"mesh bilayer mean T {temp}"
    L1 = ps.Lv.cpu().numpy().astype(np.float64)
    assert np.isfinite(L1).all() and (np.abs(L1 / L0 - 1.0) <= 0.2).all(), \
        (L0, L1)
    bt = ps.sysdef.bonded
    resid = constraint_residual(
        SimpleNamespace(r=ps.gather_by_gid(("r",))["r"]), bt.cons_atoms,
        bt.cons_pairs, bt.cons_dist, box_lengths=L1)
    assert resid < 5e-3, f"mesh bilayer RATTLE residual {resid}"
    rate, tail = tail_rate(ps)
    cp = ps.cplan
    phase("mesh", f"bilayer at (1,1,1): {n} beads, ncore {cp.ncore} cap "
          f"{cp.cap}, chunk {ps.chunk_steps} steps; first energy "
          f"{e_mesh:.8g} vs single-device {e1:.8g} (rel {rel:.2g}) on the "
          f"20 fs restart; {steps} NPT steps (dispatch {DISPATCH}): box "
          f"{L0.round(4).tolist()} -> {L1.round(4).tolist()} nm, mean T "
          f"{temp:.2f} K over the last {TAIL} steps, RATTLE residual "
          f"{resid:.3g}, #6 with exclusions launched "
          f"{c['cellpair_half_ext_excl']} times, {rate:.1f} steps/s over the "
          f"last {tail} steps vs single-device {single_rate:.1f} (stage 2, "
          f"same call) on {card}")
    return c["cellpair_half_ext_excl"]


def eam_slice_phases(card, counters_zero, counters, eam_counters):
    """Phases 7 and 8, the EAM crystal through the CLI; returns the EAM
    kernels' launch counts of their main-path runs and phase 8's steps/s
    over its last TAIL steps."""
    from ddcmd_tpu_torch.io.restart import write_checkpoint
    from ddcmd_tpu_torch.ops import cellpair_half as ch

    # --- phase 7: the EAM crystal, nc = 12, per-cell EAM kernels ------------
    with tempfile.TemporaryDirectory() as d_eq, \
            tempfile.TemporaryDirectory() as d:
        deck_eq = eam_deck(d_eq, EAM_NC, printrate=10)
        deck = eam_deck(d, EAM_NC, printrate=10, free=True)
        counters_zero()
        sim = cli_run(["simulate", "-o", deck_eq, "-n", str(EAM_STEPS),
                       "--run-dir", d_eq])
        n_rho, n_force, n_rho_col, n_force_col = eam_counters()
        assert n_rho >= EAM_STEPS and n_force >= EAM_STEPS, eam_counters()
        assert n_rho_col == n_force_col == 0 and not any(counters()), (
            eam_counters(), counters())
        launches = {"eam_rho": n_rho, "eam_force": n_force}
        rows = read_rows(d_eq)
        assert sim.ss.loop == EAM_STEPS and np.isfinite(rows).all()
        temp = float(rows[rows[:, 0] > EAM_STEPS - TAIL][:, 5].mean())
        assert abs(temp - EAM_T) <= TEMP_TOL, f"mean T over the last {TAIL}: {temp}"
        rate, steps = tail_rate(sim)
        n_eam = sim.sysdef.state.n_local
        phase("eam", f"eam_crystal nc={EAM_NC}: {n_eam} atoms, cells "
              f"{sim.grid.ncells} cap {sim.grid.cap} "
              f"G={sim.force_fn.terms[0].G}, {EAM_STEPS} NVT steps at dt=2 fs "
              f"(dispatch {DISPATCH}): mean T {temp:.2f} K over the last "
              f"{TAIL} steps, Etot/atom {rows[-1, 2]:.6f} eV, rho/force "
              f"kernel launches {n_rho}/{n_force}, redos {sim.redos}, "
              f"{rate:.1f} steps/s over the last {steps} steps on {card}")
        # the NVE leg: the same deck with a FREE group from a checkpoint
        write_checkpoint(sim, d)
        run_dir = os.path.join(d, "run")
        sim = cli_run(["simulate", "-o", deck, "-r",
                       os.path.join(d, "restart"), "-n", str(EAM_NVE_STEPS),
                       "--run-dir", run_dir])
        rows = read_rows(run_dir)
    assert sim.ss.loop == EAM_STEPS + EAM_NVE_STEPS and np.isfinite(rows).all()
    drift = float(np.abs(rows[:, 2] - rows[0, 2]).max())
    rate, steps = tail_rate(sim)
    phase("eam", f"NVE leg: {EAM_NVE_STEPS} steps from the checkpoint, "
          f"max |Etot - Etot0| {drift:.3g} eV/atom (bound {NVE_DRIFT_TOL}), "
          f"mean T {rows[:, 5].mean():.2f} K, {rate:.1f} steps/s")
    assert drift < NVE_DRIFT_TOL, f"NVE drift {drift} eV/atom"

    # --- phase 8: the EAM crystal, nc = 32, column EAM kernels ---------------
    with tempfile.TemporaryDirectory() as d:
        deck = eam_deck(d, EAM_BIG_NC, printrate=10)
        counters_zero()
        sim = cli_run(["simulate", "-o", deck, "-n", str(EAM_BIG_STEPS),
                       "--run-dir", d])
        n_rho, n_force, n_rho_col, n_force_col = eam_counters()
        rows = read_rows(d)
    assert n_rho_col >= EAM_BIG_STEPS and n_force_col >= EAM_BIG_STEPS, \
        eam_counters()
    assert n_rho == n_force == 0 and not any(counters()), (
        eam_counters(), counters())
    launches["eam_rho_col"], launches["eam_force_col"] = n_rho_col, n_force_col
    assert sim.ss.loop == EAM_BIG_STEPS and np.isfinite(rows).all()
    temp = float(rows[rows[:, 0] > EAM_BIG_STEPS - TAIL][:, 5].mean())
    assert abs(temp - EAM_T) <= TEMP_TOL, f"mean T over the last {TAIL}: {temp}"
    rate, steps = tail_rate(sim)
    term = sim.force_fn.terms[0]
    phase("eam", f"eam_crystal nc={EAM_BIG_NC}: {sim.sysdef.state.n_local} "
          f"atoms, {EAM_BIG_STEPS} NVT steps at dt=2 fs: cells "
          f"{term.grid.ncells} ({term.grid.ncell}) cap {term.grid.cap} "
          f"G={term.G} U={len(ch.col_plan_grid(term.grid, term.G)[0])}; mean "
          f"T {temp:.2f} K over the last {TAIL} steps, Etot/atom "
          f"{rows[-1, 2]:.6f} eV, column rho/force launches "
          f"{n_rho_col}/{n_force_col}, redos {sim.redos}, {rate:.1f} steps/s "
          f"over the last {steps} steps on {card}")
    return launches, rate


def lj_deck(d, n, printrate, two=False, free=False, edit=None):
    """lj_fluid deck (LANGEVIN 120 K, 8.5 A cutoff, 1.2 A skin, 4 fs) at
    the builder's density; two=True makes every odd atom a second
    species, with the three species pairs as PAIRPARMS objects (T = 2);
    free=True swaps the Langevin group for FREE; edit(text) edits the
    deck further."""
    from ddcmd_tpu_torch.models import lj_fluid

    lj_fluid(d, n=n)
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    text = text.replace("printrate=100;", f"printrate={printrate};")
    if free:
        text = text.replace("type=LANGEVIN; Teq=120.0K; tau=0.5ps;",
                            "type=FREE;")
    if two:
        text = (text.replace("species=Ar;", "species=Ar Kr;")
                + "Kr SPECIES { type=ATOM; mass=83.8; charge=0; }\n"
                "Ar-Ar PAIRPARMS { eps=0.0104 eV; sigma=3.4 Angstrom; }\n"
                "Ar-Kr PAIRPARMS { eps=0.0123 eV; sigma=3.5 Angstrom; }\n"
                "Kr-Kr PAIRPARMS { eps=0.0141 eV; sigma=3.6 Angstrom; }\n")
        atoms = os.path.join(d, "atoms#000000")
        with open(atoms) as f:
            lines = f.read().split("\n")
        for i, ln in enumerate(lines):
            head = ln.split(" ", 1)[0]
            if head.isdigit() and int(head) % 2:
                lines[i] = ln.replace(" ATOM Ar ", " ATOM Kr ", 1)
        with open(atoms, "w") as f:
            f.write("\n".join(lines))
    if edit is not None:
        text = edit(text)
    with open(p, "w") as f:
        f.write(text)
    return p


def slab_edit(text):
    """pbc = 3 with REFLECT walls in z (tests/test_pbc.py:83-120)."""
    return (text.replace("pbc=7", "pbc=3")
            .replace("potential=pot;", "potential=pot walls;")
            + "\nwalls POTENTIAL { type=REFLECT; }\n")


def triclinic_deck(d, m, tilt=0.2, spacing=4.0, seed=5, printrate=50):
    """An LJ fluid on an m^3 lattice (4 A spacing, sigma 3.4 A, 7 A
    cutoff) in a monoclinic box with b = (tilt L, L, 0) and a FREE group
    on NGLF, dt 4 fs, as tests/test_triclinic.py:142-200 builds its 216
    atoms."""
    L = m * spacing
    h = np.diag([L, L, L]).astype(np.float64)
    h[0, 1] = tilt * L
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    # a jitter of 0.48 A whatever m (0.02 of the 216-atom box's edge)
    s = (g + 0.5) / m - 0.5 + (rng.random((m ** 3, 3)) - 0.5) * 0.12 / m
    r = s @ h.T
    n = len(r)
    v = rng.standard_normal((n, 3)) * 0.002
    rows = [f"{i} ATOM Ar free " + " ".join("%.8f" % x for x in r[i])
            + " " + " ".join("%.8f" % x for x in v[i]) for i in range(n)]
    hflat = " ".join("%.6f" % x for x in h.reshape(-1))
    with open(os.path.join(d, "atoms#000000"), "w") as f:
        f.write(f"particle FILEHEADER {{type=MULTILINE; "
                f"datatype=VARRECORDASCII; checksum=NONE;\nloop=0; "
                f"time=0.0;\nnfiles=1; nrecord={n}; nfields=10;\n"
                f"field_names=id class type group rx ry rz vx vy vz;\n"
                f"field_types=u s s s f f f f f f;\nh= {hflat} ;\n}}\n\n"
                + "\n".join(rows) + "\n")
    p = os.path.join(d, "object.data")
    with open(p, "w") as f:
        f.write(f"""
simulate SIMULATE {{ type=MD; system=system; integrator=nve; dt=4;
  maxloop=100000; printrate={printrate}; ddc=ddc; }}
ddc DDC {{ updateRate=10; }}
pot POTENTIAL {{ type=PAIR; cutoff=7.0 Angstrom; eps=0.01 eV;
  sigma=3.4 Angstrom; }}
nve INTEGRATOR {{ type=NGLF; T=100K; }}
system SYSTEM {{ type=NORMAL; potential=pot; neighbor=nbr; groups=free;
  box=box; collection=collection; species=Ar; }}
Ar SPECIES {{ type=ATOM; mass=39.948; charge=0; }}
box BOX {{ type=GENERAL; pbc=7; h= {hflat} ; }}
nbr NEIGHBOR {{ type=NORMAL; deltaR=1.2; }}
free GROUP {{ type=FREE; }}
collection COLLECTION {{ mode=VARRECORDASCII; size={n}; files=atoms#; }}
""")
    return p


def npt_water_deck(d, n, printrate, free=False):
    """martini_water under the reference deck's integrator (BASELINE.md:14):
    NGLFCONSTRAINT, T 310 K, P0 1 bar, beta 3.0e-4/bar, tauBarostat 1 ps."""
    p = water_deck(d, n, printrate, free=free)
    with open(p) as f:
        text = f.read()
    with open(p, "w") as f:
        f.write(text.replace("type=NGLF; T=310.0K;", NPT_INTEGRATOR))
    return p


def mesh_lines(lines):
    """(loops, T, epot/N, P, V) of the mesh's print lines."""
    def col(key):
        return np.array([float(ln.split(key)[1].split()[0]) for ln in lines])

    loops = np.array([int(ln.split()[0]) for ln in lines])
    out = (loops, col("T="), col("epot/N="), col("P="), col("V="))
    assert all(np.isfinite(a).all() for a in out[1:]), "non-finite scalars"
    return out


def pair_phases(card, dev, counters_zero, all_counters):
    """Phases 13 and 14: PAIR Lennard-Jones fluids through the CLI on the
    pair kernels (#1 at n = 4,096, the plan's kernel at n = 131,072), a
    T = 2 variant with its kernel held against the plain version on its
    slots, then the n = 131,072 deck through ParallelSimulation at
    (1,1,1) on #6.  Returns ({kernel entry: launches}, {name: steps/s})."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    launches = {"cellpair_half": 0, "cellpair_half_col": 0,
                "cellpair_half_ext": 0}
    rates = {}
    for n, steps in ((LJ_N, LJ_STEPS), (LJ_BIG_N, LJ_BIG_STEPS)):
        with tempfile.TemporaryDirectory() as d:
            deck = lj_deck(d, n, printrate=10)
            counters_zero()
            sim = cli_run(["simulate", "-o", deck, "-n", str(steps),
                           "--run-dir", d])
            c = all_counters()
            rows = read_rows(d)
        term = sim.force_fn.terms[0]
        name = "cellpair_half_col" if term.G > 1 else "cellpair_half"
        assert sim.engine == "kernel" and sim.ss.loop == steps
        assert c[name] >= steps, c
        assert not any(v for k, v in c.items() if k != name), c
        assert np.isfinite(rows).all(), "non-finite printinfo row"
        temp = float(rows[rows[:, 0] > steps - TAIL][:, 5].mean())
        assert abs(temp - LJ_T) <= TEMP_TOL, f"lj n={n}: mean T {temp}"
        launches[name] += c[name]
        rate, tail = tail_rate(sim)
        rates[f"lj{n}"] = rate
        kernel, args, kw, _ = sim_kernel_inputs(sim)
        plain = (ch.cellpair_half_col_plain if term.G > 1
                 else ch.cellpair_half_plain)
        res = compare(f"{name} on the lj_fluid n={n} slots after {steps} "
                      "steps", kernel, plain, args, kw, with_bound=True)
        edge = 10 * float(sim.ss.box.lengths[0])
        phase("pair", f"lj_fluid {n} atoms (box {edge:.1f} A), LANGEVIN "
              f"{LJ_T:.0f} K, {steps} steps: cells {sim.grid.ncells} cap "
              f"{sim.grid.cap} G={term.G}, {name} "
              f"launched {c[name]} times and no other kernel; mean T "
              f"{temp:.2f} K over the last {TAIL} steps, Etot/atom "
              f"{rows[-1, 2]:.6f}; redos {sim.redos}; {rate:.1f} steps/s "
              f"over the last {tail} steps; kernel {1e3 * res[1]:.2f} vs "
              f"plain {1e3 * res[2]:.2f} us/call on {card}")
        del sim
    # T = 2: per-pair PAIRPARMS; the run's kernel and the column kernel
    # against their plain versions on its slots
    for n, steps in ((LJ_N, LJ_T2_STEPS), (LJ_BIG_N, 0)):
        with tempfile.TemporaryDirectory() as d:
            deck = lj_deck(d, n, printrate=10, two=True)
            if steps:
                counters_zero()
                sim = cli_run(["simulate", "-o", deck, "-n", str(steps),
                               "--run-dir", d])
                c = all_counters()
                rows = read_rows(d)
                assert np.isfinite(rows).all(), "non-finite printinfo row"
            else:
                sim = Simulation(*load(d), run_dir=d, device=dev)
        term = sim.force_fn.terms[0]
        assert sim.sysdef.potentials[0][2].n_species == 2
        kernel, args, kw, _ = sim_kernel_inputs(sim)
        assert args[5 if term.G > 1 else 4].shape == (2, 2), "T != 2"
        plain = (ch.cellpair_half_col_plain if term.G > 1
                 else ch.cellpair_half_plain)
        name = "cellpair_half_col" if term.G > 1 else "cellpair_half"
        compare(f"{name}, T=2 lj_fluid n={n} slots (cells {sim.grid.ncells}"
                f" cap {sim.grid.cap} G={term.G})", kernel, plain, args, kw)
        if steps:
            assert c[name] >= steps and not any(
                v for k, v in c.items() if k != name), c
            launches[name] += c[name]
            phase("pair", f"T=2 lj_fluid {n} atoms, {steps} steps through "
                  f"the CLI: {name} launched {c[name]} times, T "
                  f"{rows[-1, 5]:.2f} K")
        del sim
    # --- phase 14: the n = 131,072 deck through the mesh at (1,1,1) -------
    with tempfile.TemporaryDirectory() as d:
        lj_deck(d, LJ_BIG_N, printrate=10)
        sim = Simulation(*load(d), run_dir=d, device=dev)
        sim.first_energy()
        e1 = float(sim.ss.energy.eion)
        del sim
        ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev)
    e_mesh = ps.first_energy()
    rel = abs(e_mesh - e1) / abs(e1)
    assert rel <= 2e-5, f"PAIR mesh first energy {e_mesh} vs {e1}"
    lines = []
    counters_zero()
    ps.run(MESH_LJ_STEPS, print_fn=lines.append,
           max_steps_per_dispatch=DISPATCH)
    c = all_counters()
    assert c["cellpair_half_ext"] >= MESH_LJ_STEPS, c
    assert not any(v for k, v in c.items() if k != "cellpair_half_ext"), c
    launches["cellpair_half_ext"] += c["cellpair_half_ext"]
    n = ps.sysdef.state.n_local
    assert ps.loop == MESH_LJ_STEPS and int(ps.mask.sum()) == n
    loops, temps, _, _, _ = mesh_lines(lines)
    temp = float(temps[loops > MESH_LJ_STEPS - TAIL].mean())
    assert abs(temp - LJ_T) <= TEMP_TOL, f"PAIR mesh mean T {temp}"
    rate, tail = tail_rate(ps)
    rates["lj_mesh"] = rate
    phase("mesh", f"lj_fluid {n} atoms at (1,1,1): ncore {ps.cplan.ncore} "
          f"cap {ps.cplan.cap}, force kind {ps.force_kind} (RF constants "
          f"0); first energy {e_mesh:.8g} vs single-device {e1:.8g} (rel "
          f"{rel:.2g}); {MESH_LJ_STEPS} NVT steps: #6 launched "
          f"{c['cellpair_half_ext']} times and no other kernel, mean T "
          f"{temp:.2f} K over the last {TAIL} steps, {rate:.1f} steps/s over "
          f"the last {tail} steps vs single-device "
          f"{rates[f'lj{LJ_BIG_N}']:.1f} on {card}")
    return launches, rates


def npt_water_phase(card, dev, counters_zero, all_counters):
    """Phase 15: the reference deck's NPT water box (item 26) through the
    CLI and through the mesh at (1,1,1), NPT_STEPS each from the lattice
    start; the mesh's first energy against Simulation's.  Returns
    ({kernel entry: launches}, {name: steps/s})."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    with tempfile.TemporaryDirectory() as d:
        deck = npt_water_deck(d, 6173, printrate=10)
        counters_zero()
        sim = cli_run(["simulate", "-o", deck, "-n", str(NPT_STEPS),
                       "--run-dir", d])
        c = all_counters()
        rows = read_rows(d)
        assert sim.barostat is not None and sim.ss.loop == NPT_STEPS
        assert c["cellpair_half"] >= NPT_STEPS, c
        assert not any(v for k, v in c.items() if k != "cellpair_half"), c
        assert np.isfinite(rows).all(), "non-finite printinfo row"
        L0 = sim.sysdef.box.lengths.cpu().numpy().astype(np.float64)
        L1 = sim.ss.box.lengths.cpu().numpy().astype(np.float64)
        assert np.isfinite(L1).all() and \
            (np.abs(L1 / L0 - 1.0) <= 0.2).all(), (L0, L1)
        tail_rows = rows[rows[:, 0] > NPT_STEPS - TAIL]
        temp = float(tail_rows[:, 5].mean())
        assert abs(temp - 310.0) <= TEMP_TOL, f"NPT water mean T {temp}"
        p_mean = float(tail_rows[:, 6].mean())
        p_sd = float(tail_rows[:, 6].std())
        rate, tail = tail_rate(sim)
        e_first = None
        phase("npt-water", f"martini_water 6173 beads, NGLFCONSTRAINT P0 1 "
              f"bar beta 3.0e-4/bar tau 1 ps, {NPT_STEPS} steps through the "
              f"CLI: cells {sim.grid.ncells} cap {sim.grid.cap}, #1 launched "
              f"{c['cellpair_half']} times; box {(10 * L0).round(3).tolist()} "
              f"-> {(10 * L1).round(3).tolist()} A; mean T {temp:.2f} K, "
              f"mean P {p_mean:.4g} +- {p_sd:.3g} "
              f"{sim.printinfo.u_press} over the last {TAIL} steps (a 6k-bead "
              f"box's pressure is not gated); redos {sim.redos}; {rate:.1f} "
              f"steps/s over the last {tail} steps on {card}")
        launches = {"cellpair_half": c["cellpair_half"]}
        rates = {"npt_water": rate}
        del sim
        from ddcmd_tpu_torch.run.simulate import Simulation

        s0 = Simulation(*load(d), run_dir=d, device=dev)
        s0.first_energy()
        e_first = float(s0.ss.energy.eion)
        del s0
        ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev)
    e_mesh = ps.first_energy()
    rel = abs(e_mesh - e_first) / abs(e_first)
    assert rel <= 2e-5, f"NPT water mesh first energy {e_mesh} vs {e_first}"
    L0 = ps.Lv.cpu().numpy().astype(np.float64)
    lines = []
    counters_zero()
    ps.run(NPT_STEPS, print_fn=lines.append, max_steps_per_dispatch=DISPATCH)
    c = all_counters()
    assert c["cellpair_half_ext"] >= NPT_STEPS, c
    assert not any(v for k, v in c.items() if k != "cellpair_half_ext"), c
    launches["cellpair_half_ext"] = c["cellpair_half_ext"]
    assert ps.loop == NPT_STEPS and int(ps.mask.sum()) == 6173
    loops, temps, _, press, _ = mesh_lines(lines)
    sel = loops > NPT_STEPS - TAIL
    temp = float(temps[sel].mean())
    assert abs(temp - 310.0) <= TEMP_TOL, f"NPT water mesh mean T {temp}"
    L1 = ps.Lv.cpu().numpy().astype(np.float64)
    assert np.isfinite(L1).all() and (np.abs(L1 / L0 - 1.0) <= 0.2).all(), \
        (L0, L1)
    rate, tail = tail_rate(ps)
    rates["npt_water_mesh"] = rate
    phase("npt-water", f"mesh at (1,1,1): first energy {e_mesh:.8g} vs "
          f"Simulation {e_first:.8g} (rel {rel:.2g}); {NPT_STEPS} NPT steps "
          f"(chunk {ps.chunk_steps}): #6 launched {c['cellpair_half_ext']} "
          f"times, box {(10 * L0).round(3).tolist()} -> "
          f"{(10 * L1).round(3).tolist()} A, mean T {temp:.2f} K, mean P "
          f"{press[sel].mean():.4g} +- {press[sel].std():.3g} over the last "
          f"{TAIL} steps; {rate:.1f} steps/s over the last {tail} steps on "
          f"{card}")
    return launches, rates


def cellblock_phase(card, dev, counters_zero, all_counters):
    """Phase 16: the plain cell-block engine on the card, which launches
    no kernel: (a) lj_fluid n = 4,096 first energy and forces on it
    against the kernel engine on the same state; (b) the pbc = 3 REFLECT
    slab at n = 4,096 with a FREE group, CB_SLAB_STEPS f32 steps; (c) a
    monoclinic box (tilt 0.2) of 13,824 atoms with a FREE group,
    CB_TRI_STEPS steps in f32 and in f64; (d) small deterministic slab
    and triclinic runs on the card against the same runs on the CPU."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.cli import load_db
    from ddcmd_tpu_torch.run.simulate import Simulation

    def idle(what):
        c = all_counters()
        assert not any(c.values()), f"{what}: kernels launched {c}"

    # (a) the kernels' f32 state on both engines; the kernels' forces are
    # held to the cell-block engine's in f64 on that state (its f32
    # |p|^2 + |q|^2 - 2 p.q distances carry ~2e-5 of the force scale, as
    # the JAX engine's do)
    with tempfile.TemporaryDirectory() as d:
        lj_deck(d, LJ_N, printrate=100)
        kern = Simulation(*load(d), run_dir=d, device=dev)
        kern.first_energy()
        st, box = kern.ss.state, kern.ss.box
        counters_zero()
        cbs = {}
        for dt in (torch.float32, torch.float64):
            s = Simulation(*load(d), run_dir=d, device=dev,
                           engine="cellblock", dtype=dt)
            s.ss = s.ss.replace(
                state=s.ss.state.replace(r=st.r.to(dt)),
                box=dataclasses.replace(s.ss.box, h=box.h.to(dt)))
            s.first_energy()
            cbs[dt] = s
        torch.cuda.synchronize()
        idle("cellblock first energy")
    n = kern.sysdef.state.n_local
    ref = cbs[torch.float64]
    f_ref = ref.ss.state.f[:n]
    scale = float(f_ref.abs().max())
    e_ref = float(ref.ss.energy.eion)

    def err(sim):
        return (float((sim.ss.state.f[:n].double() - f_ref).abs().max()),
                float(sim.ss.energy.eion))

    ferr, e0 = err(kern)
    ferr32, e32 = err(cbs[torch.float32])
    assert ferr <= 2e-5 * scale and abs(e0 - e_ref) <= 1e-4 * abs(e_ref), \
        (ferr, scale, e0, e_ref)
    phase("cellblock", f"(a) lj_fluid {n} atoms, first energy on the cell-"
          f"block engine (cells {ref.grid.ncells} cap {ref.grid.cap}, no "
          f"kernel launched) in f64 vs the kernels (cells "
          f"{kern.grid.ncells} cap {kern.grid.cap}): e {e_ref:.10g} vs "
          f"{e0:.8g}, force err {ferr:.3g} (scale {scale:.4g}); the "
          f"cell-block engine in f32: e {e32:.8g}, force err {ferr32:.3g}")
    del kern, cbs, ref

    # (b) the REFLECT slab
    def slab(d, n, printrate):
        return lj_deck(d, n, printrate, free=True, edit=slab_edit)

    with tempfile.TemporaryDirectory() as d:
        slab(d, LJ_N, 100)
        sim = Simulation(*load(d), run_dir=d, device=dev)
        assert sim.engine == "cellblock" and sim.post_drift_fn is not None
        sim.first_energy()
        e0 = float(sim.ss.energy.eion + sim.ss.energy.rk)
        counters_zero()
        t0 = time.perf_counter()
        sim.run(CB_SLAB_STEPS, print_fn=lambda s: None,
                max_steps_per_dispatch=DISPATCH)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        idle("REFLECT slab")
    r = sim.ss.state.r[:n].cpu().numpy()
    half = 0.5 * float(sim.ss.box.lengths[2])
    assert np.isfinite(r).all(), "non-finite slab positions"
    assert (np.abs(r[:, 2]) <= half * (1 + 1e-6)).all(), "atom past a wall"
    e1 = float(sim.ss.energy.eion + sim.ss.energy.rk)
    phase("cellblock", f"(b) pbc=3 REFLECT slab, {n} atoms FREE, "
          f"{CB_SLAB_STEPS} f32 steps: every atom within +-Lz/2 "
          f"(max |z| {np.abs(r[:, 2]).max() * 10:.4f} of {half * 10:.4f} A), "
          f"Etot {e0:.6g} -> {e1:.6g} kJ/mol (drift {e1 - e0:.4g}, "
          f"{(e1 - e0) / n:.3g} a atom), redos {sim.redos}, "
          f"{CB_SLAB_STEPS / secs:.1f} steps/s on {card}")
    del sim

    # (c) the monoclinic box, f32 then f64
    e_first = {}
    for dtype in (torch.float32, torch.float64):
        with tempfile.TemporaryDirectory() as d:
            deck = triclinic_deck(d, CB_TRI_M)
            sim = Simulation(load_db([deck], None, d), d, run_dir=d,
                             device=dev, dtype=dtype)
            assert sim.engine == "cellblock" and not sim.sysdef.box.ortho
            sim.first_energy()
            e_first[dtype] = float(sim.ss.energy.eion)
            e0 = e_first[dtype] + float(sim.ss.energy.rk)
            counters_zero()
            t0 = time.perf_counter()
            sim.run(CB_TRI_STEPS, print_fn=lambda s: None,
                    max_steps_per_dispatch=DISPATCH)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            idle(f"triclinic {dtype}")
        e1 = float(sim.ss.energy.eion + sim.ss.energy.rk)
        n = sim.sysdef.state.n_local
        assert np.isfinite(e1), "non-finite triclinic energy"
        phase("cellblock", f"(c) monoclinic box tilt 0.2, {n} atoms FREE, "
              f"{CB_TRI_STEPS} {str(dtype)[6:]} steps: cells "
              f"{sim.grid.ncells} cap {sim.grid.cap}; NVE drift "
              f"{e1 - e0:.4g} kJ/mol ({(e1 - e0) / n:.3g} a atom; the CPU test"
              f" gates 3e-4 a atom at 216 atoms); redos {sim.redos}; "
              f"{CB_TRI_STEPS / secs:.1f} steps/s on {card}")
        del sim
    rel = abs(e_first[torch.float64] - e_first[torch.float32]) / abs(
        e_first[torch.float64])
    assert rel <= 1e-4, f"triclinic f64 vs f32 first energy: rel {rel}"
    phase("cellblock", f"(c) first energy f64 {e_first[torch.float64]:.10g} "
          f"vs f32 {e_first[torch.float32]:.8g} (rel {rel:.2g})")

    # (d) card vs CPU, small deterministic runs
    card_vs_cpu((("pbc=3 REFLECT slab 256 atoms FREE f32 40 steps",
                  lambda d: slab(d, 256, 100), torch.float32, 40),
                 ("monoclinic 125 atoms FREE f64 40 steps",
                  lambda d: triclinic_deck(d, 5), torch.float64, 40)),
                counters_zero, all_counters)


def card_vs_cpu(cases, counters_zero, all_counters, engine="cellblock",
                modulo_box=False):
    """Each (name, make_deck, dtype, steps[, opts]) case through Simulation
    on the card and on the CPU: both on `engine`, the card run launching
    no kernel (the plain cell-block engines, the list engine), energies,
    positions and the box agreeing as in phase 9; with modulo_box the
    positions are compared modulo the box's lattice vectors, as phase 9
    compares them (an atom at a face may be wrapped to either side).
    opts: "engine", the engine asked for (default auto); "context", a
    context manager both runs are built in (widened)."""
    from ddcmd_tpu_torch.run.cli import load_db
    from ddcmd_tpu_torch.run.simulate import Simulation

    def final(where, make_deck, dtype, n_steps, opts):
        with tempfile.TemporaryDirectory() as d:
            deck = make_deck(d)
            with opts.get("context", contextlib.nullcontext)():
                s = Simulation(load_db([deck], None, d), d, run_dir=d,
                               device=where, dtype=dtype,
                               engine=opts.get("engine", "auto"))
            assert s.engine == engine, s.engine
            counters_zero()
            s.run(n_steps, print_fn=lambda line: None)
            c = all_counters()
            assert not any(c.values()), f"{where} run: kernels launched {c}"
            return (float(s.ss.energy.eion), float(s.ss.energy.rk),
                    s.ss.state.r.cpu().double().numpy(),
                    s.ss.box.h.cpu().double().numpy())

    for name, make_deck, dtype, n_steps, *opts in cases:
        opts = opts[0] if opts else {}
        (e1, k1, r1, h1), (e0, k0, r0, h0) = (
            final(w, make_deck, dtype, n_steps, opts) for w in (DEVICE, "cpu"))
        if modulo_box:
            s = (r1 - r0) @ np.linalg.inv(h0).T
            dr = float(np.abs((s - np.round(s)) @ h0.T).max())
        else:
            dr = float(np.abs(r1 - r0).max())
        ok = (math.isclose(e1, e0, rel_tol=1e-4, abs_tol=1e-2)
              and math.isclose(k1, k0, rel_tol=1e-3, abs_tol=1e-2)
              and dr < 1e-3 and np.allclose(h1, h0, rtol=1e-5))
        phase("agree", f"{name}, card vs CPU: eion {e1:.8g} vs {e0:.8g}, rk "
              f"{k1:.6g} vs {k0:.6g}, max |dr| {dr:.3g} nm")
        if not ok:
            raise AssertionError(f"{name}: card and CPU runs disagree")


def window_stats(run, steps):
    """(device busy share, CUDA kernels a step) of run(), `steps` steps
    under torch.profiler: the CUDA kernels' time over the window's host
    wall time (the profiler's own cost included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in kernels) / 1e6 / wall,
            len(kernels) / steps)


def kernels_us(fn, n):
    """Device time, us, of every CUDA kernel one call of fn launches
    (torch.profiler over n calls, after one warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / n


def bonded_graph_check(sim):
    """The bonded term's CUDA graph replay against its eager function on
    sim's state (the graph's atomics reorder the sums: force 1e-5 of the
    scale, e rel 1e-5), with both times by events and the eager kernels'
    device time a call.  Returns (within the gates, text)."""
    graphed = sim.force_fn.terms[-1].graphed
    st, geom = sim.ss.state, sim.ss.box.geom
    eager = graphed.fn(st.r, geom)
    got = graphed(st.r, geom)
    scale = float(eager[0].abs().max())
    ferr = float((got[0] - eager[0]).abs().max()) / scale
    eerr = abs(float(got[1] - eager[1])) / abs(float(eager[1]))
    us_graph = 1e3 * time_calls(lambda: graphed(st.r, geom), 50)
    us_eager = 1e3 * time_calls(lambda: graphed.fn(st.r, geom), 20)
    dev_us = kernels_us(lambda: graphed.fn(st.r, geom), 10)
    return ferr <= 1e-5 and eerr <= 1e-5, (
        f"the bonded term: CUDA graph {us_graph:.1f} us a call by events, "
        f"eager {us_eager:.1f} ({dev_us:.1f} us of device time in its "
        f"kernels); graph vs eager force {ferr:.2g} of the scale, e rel "
        f"{eerr:.2g}")


def first_state(d, dev, stats=False):
    """(engine, first energy, forces (n, 3) f64) of the deck in d through
    Simulation on dev; with `stats`, also window_stats of PROFILE_STEPS
    steps from that state."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.simulate import Simulation

    s = Simulation(*load(d), run_dir=d, device=dev)
    s.first_energy()
    n = s.sysdef.state.n_local
    out = (s.engine, float(s.ss.energy.eion), s.ss.state.f[:n].double())
    if not stats:
        return out
    return out + (window_stats(lambda: s.run(
        PROFILE_STEPS, print_fn=lambda line: None), PROFILE_STEPS + 1),)


def tabular_phase(card, dev, counters_zero, all_counters):
    """Phase 17, tabulated EAM (tabular_eam_deck writes the table files in
    each run directory): (c) the tabularFit=rational refit through the
    CLI at nc = 32 on the column kernels (#5) and at nc = 12 on the
    per-cell ones (#4), TAB_STEPS NVT steps each, its first energy held to
    the RATIONAL deck's; the nc = 32 refit through the mesh at (1,1,1) on
    #7, MESH_TAB_STEPS steps, its first energy held to Simulation's; (d)
    the unfitted nc = 32 TABULAR deck on the plain cell-block EAM engine
    (no kernel), its first energy and forces held to the RATIONAL deck's
    on the same start state, TAB_CB_STEPS steps; small triclinic, f64
    and five-species EAM decks on the card against the CPU.  Returns the
    refit kernels' launches {kernels entry: n}."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    launches = {}
    quiet = lambda line: None                                  # noqa: E731

    def refit_run(nc, deck, d, ran, names):
        """The refit deck in d through the CLI on the kernels `ran` (their
        launches kept under `names`), its gates and its phase line."""
        counters_zero()
        sim = cli_run(["simulate", "-o", deck, "-n", str(TAB_STEPS),
                       "--run-dir", d])
        c = all_counters()
        assert all(c[k] >= TAB_STEPS for k in ran), c
        assert not any(v for k, v in c.items() if k not in ran), c
        launches.update({n: c[k] for k, n in zip(ran, names)})
        rows = read_rows(d)
        assert sim.ss.loop == TAB_STEPS and np.isfinite(rows).all()
        temp = float(rows[rows[:, 0] > TAB_STEPS - TAIL][:, 5].mean())
        assert abs(temp - EAM_T) <= TEMP_TOL, f"refit mean T {temp}"
        rate, steps = tail_rate(sim)
        busy, kps = window_stats(
            lambda: sim.run(PROFILE_STEPS, print_fn=quiet), PROFILE_STEPS + 1)
        term = sim.force_fn.terms[0]
        phase("tabular", f"(c) refit deck nc={nc} ({sim.sysdef.state.n_local}"
              f" atoms, tabularFit=rational, {term.tables['kform']} of "
              f"degree {term.tables['degree']}) through the CLI: plan "
              f"{sim.grid.ncells} cap {sim.grid.cap} G={term.G}; "
              f"{TAB_STEPS} NVT steps: mean T {temp:.2f} K over the last "
              f"{TAIL}, launches {[c[k] for k in ran]} "
              f"({c[ran[0]] / TAB_STEPS:.3f} a step each), {rate:.1f} "
              f"steps/s over the last {steps} steps, busy {100 * busy:.1f}% "
              f"over {PROFILE_STEPS} profiled steps ({kps:.1f} CUDA kernels "
              f"a step) on {card}")
        del sim

    # nc = 12: the refit on #4
    with tempfile.TemporaryDirectory() as d_rat, \
            tempfile.TemporaryDirectory() as d_fit:
        eam_deck(d_rat, EAM_NC, 10)
        deck = tabular_eam_deck(d_fit, EAM_NC, 10, fit=True)
        _, e_rat, _ = first_state(d_rat, dev)
        eng, e_fit, _ = first_state(d_fit, dev)
        rel = abs(e_fit - e_rat) / abs(e_rat)
        assert eng == "kernel" and rel <= FIT_E_REL, (eng, e_fit, e_rat)
        phase("tabular", f"(c) refit deck nc={EAM_NC}: first energy "
              f"{e_fit:.8g} vs the RATIONAL deck's {e_rat:.8g} (rel "
              f"{rel:.3g}, gate {FIT_E_REL})")
        refit_run(EAM_NC, deck, d_fit, ("eam_rho", "eam_force"),
                  ("eam_rho_refit", "eam_force_refit"))

    nc = EAM_BIG_NC
    with tempfile.TemporaryDirectory() as d_rat, \
            tempfile.TemporaryDirectory() as d_fit, \
            tempfile.TemporaryDirectory() as d_tab:
        eam_deck(d_rat, nc, 10)
        deck_fit = tabular_eam_deck(d_fit, nc, 10, fit=True)
        deck_tab = tabular_eam_deck(d_tab, nc, 10)
        _, e_rat, f_rat, (busy, kps) = first_state(d_rat, dev, stats=True)
        eng, e_fit, _ = first_state(d_fit, dev)
        rel = abs(e_fit - e_rat) / abs(e_rat)
        assert eng == "kernel" and rel <= FIT_E_REL, (eng, e_fit, e_rat)
        phase("tabular", f"(c) refit deck nc={nc}: first energy {e_fit:.8g}"
              f" vs the RATIONAL deck's {e_rat:.8g} (rel {rel:.3g}, gate "
              f"{FIT_E_REL}); the RATIONAL deck from its start: busy "
              f"{100 * busy:.1f}% over {PROFILE_STEPS} profiled steps "
              f"({kps:.1f} CUDA kernels a step) on {card}")
        refit_run(nc, deck_fit, d_fit, ("eam_rho_col", "eam_force_col"),
                  ("eam_rho_col_refit", "eam_force_col_refit"))

        # the nc = 32 refit through the mesh at (1,1,1)
        ps = ParallelSimulation(*load(d_fit), shape=(1, 1, 1), device=dev)
        e_mesh = ps.first_energy()
        rel = abs(e_mesh - e_fit) / abs(e_fit)
        assert rel <= 2e-5, f"refit mesh first energy {e_mesh} vs {e_fit}"
        lines = []
        counters_zero()
        ps.run(MESH_TAB_STEPS, print_fn=lines.append,
               max_steps_per_dispatch=DISPATCH)
        c = all_counters()
        ran = ("eam_rho_ext", "eam_force_ext")
        assert all(c[k] >= MESH_TAB_STEPS for k in ran), c
        assert not any(v for k, v in c.items() if k not in ran), c
        launches["eam_rho_ext_refit"] = c["eam_rho_ext"]
        launches["eam_force_ext_refit"] = c["eam_force_ext"]
        loops, temps, _, _, _ = mesh_lines(lines)
        assert ps.loop == MESH_TAB_STEPS and np.isfinite(temps).all()
        temp = float(temps[loops > MESH_TAB_STEPS - TAIL].mean())
        assert abs(temp - EAM_T) <= TEMP_TOL, f"refit mesh mean T {temp}"
        rate, steps = tail_rate(ps)
        busy, kps = window_stats(
            lambda: ps.run(PROFILE_STEPS, print_fn=quiet), PROFILE_STEPS)
        phase("tabular", f"(c) refit deck nc={nc} through the mesh at "
              f"(1,1,1): ncore {ps.cplan.ncore} cap {ps.cplan.cap}; first "
              f"energy {e_mesh:.8g} vs Simulation {e_fit:.8g} (rel "
              f"{rel:.2g}, gate 2e-5); {MESH_TAB_STEPS} NVT steps on #7 "
              f"alone: mean T {temp:.2f} K, launches {c['eam_rho_ext']}/"
              f"{c['eam_force_ext']}, {rate:.1f} steps/s over the last "
              f"{steps} steps, busy {100 * busy:.1f}% ({kps:.1f} CUDA "
              f"kernels a step) on {card}")
        del ps

        # (d) the unfitted TABULAR deck on the plain cell-block EAM engine
        counters_zero()
        eng, e_tab, f_tab = first_state(d_tab, dev)
        c = all_counters()
        assert eng == "cellblock" and not any(c.values()), (eng, c)
        scale = float(f_rat.abs().max())
        ferr = float((f_tab - f_rat).abs().max())
        rel = abs(e_tab - e_rat) / abs(e_rat)
        assert rel <= TAB_E_REL and ferr <= TAB_F_REL * scale, (
            e_tab, e_rat, ferr, scale)
        del f_rat, f_tab
        counters_zero()
        torch.cuda.reset_peak_memory_stats()
        sim = cli_run(["simulate", "-o", deck_tab, "-n", str(TAB_CB_STEPS),
                       "--run-dir", d_tab])
        c = all_counters()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        assert sim.engine == "cellblock" and not any(c.values()), c
        rows = read_rows(d_tab)
        assert sim.ss.loop == TAB_CB_STEPS and np.isfinite(rows).all()
        rate, steps = tail_rate(sim)
        busy, kps = window_stats(lambda: sim.run(2, print_fn=quiet), 3)
        phase("tabular", f"(d) TABULAR deck nc={nc} through the CLI on the "
              f"plain cell-block EAM engine: cells {sim.grid.ncells} cap "
              f"{sim.grid.cap}, no kernel launched; first energy "
              f"{e_tab:.8g} vs the RATIONAL deck's {e_rat:.8g} on its "
              f"kernels (rel {rel:.3g}, gate {TAB_E_REL}), force err "
              f"{ferr:.4g} (scale {scale:.4g}, gate {TAB_F_REL} of it); "
              f"{TAB_CB_STEPS} NVT steps: T {rows[-1, 5]:.2f} K at the end, "
              f"{rate:.2f} steps/s over the last {steps} steps, busy "
              f"{100 * busy:.1f}% over 2 profiled steps ({kps:.1f} CUDA "
              f"kernels a step), peak memory {peak:.2f} GiB on {card}")
        del sim

    card_vs_cpu((("triclinic EAM crystal nc=4 (tilt 0.05) FREE f32 40 steps",
                  lambda d: triclinic_eam_deck(d, 4, 100), torch.float32, 40),
                 ("EAM crystal nc=4 FREE f64 40 steps",
                  lambda d: eam_deck(d, 4, 100, free=True), torch.float64,
                  40),
                 ("five-species FS alloy nc=4 FREE f32 40 steps",
                  lambda d: alloy_eam_deck(d, 4, 100), torch.float32, 40)),
                counters_zero, all_counters, modulo_box=True)
    return launches


def rows_as_sets(name, a, b, r, geom, rlist, tol=1e-5):
    """Hold two (N,K) lists of the same state (card, CPU) to each other as
    sets a row: the same counts, and in each row the same partners, but
    for a pair whose f64 distance lies within tol (relative) of rlist
    (its f32 cutoff test may go either way).  Returns the rows that
    differ."""
    a, b = torch.sort(a.cpu(), dim=1)[0], torch.sort(b.cpu(), dim=1)[0]
    bad = torch.nonzero((a != b).any(dim=1)).flatten().tolist()
    r64 = r.detach().cpu().double()
    g = geom.detach().cpu().double()
    sentinel = r64.shape[0]
    for i in bad:
        sa, sb = set(a[i].tolist()), set(b[i].tolist())
        for j in (sa ^ sb) - {sentinel}:
            d = r64[i] - r64[j]
            d = d - g * torch.round(d / g)
            dist = float(torch.linalg.norm(d))
            assert abs(dist - rlist) <= tol * rlist, (
                f"{name}: row {i}: partner {j} at {dist} nm, rlist {rlist}")
    return len(bad)


def nlist_phase(card, dev, counters_zero, all_counters):
    """Phase 18, the (N,K)-list engine (plain PyTorch, no kernel) at full
    width: (a) the list on the start states of (A), the nc = 32 crystal
    with the ORDERSH bias beside its EAM term, and (B), the 131,072-atom
    TableFunction fluid: the card's build against the CPU's, its time,
    peak memory, K and largest count; (b) the list engine against the
    kernels on one state: the nc = 32 RATIONAL crystal on "nlist" against
    #5, the analytic LJ fluid on "nlist" against #2, (B) against the
    analytic deck on #2 (the shift added back); (c) (A) under auto
    (NLIST_A_STEPS) and (B) on engine "nlist" (NLIST_STEPS) through
    Simulation: mean T, steps/s, busy share, CUDA kernels a step, peak
    memory, no custom kernel launched, sqrt(phi) of (A) and one snapshot
    of (A) with its q6 shard; (d) small decks on the card against the CPU."""
    from ddcmd_tpu_torch.io.restart import write_snapshot
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.nbr.celllist import build_neighbor_list
    from ddcmd_tpu_torch.ops.cellpair import CellBlockGrid, build_cell_slots
    from ddcmd_tpu_torch.potentials.ordersh import make_ordersh_eval
    from ddcmd_tpu_torch.run import simulate as tsim

    quiet = lambda line: None                                  # noqa: E731

    def idle(what):
        c = all_counters()
        assert not any(c.values()), f"{what}: kernels launched {c}"

    def gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30

    def sim_of(d, engine="auto"):
        return tsim.Simulation(*load(d), run_dir=d, device=dev,
                               engine=engine)

    failed = []     # the (b) cases that missed a gate
    with tempfile.TemporaryDirectory() as da, \
            tempfile.TemporaryDirectory() as db:
        ordersh_eam_deck(da, EAM_BIG_NC, 10)
        table_lj_deck(db, LJ_BIG_N, 10)

        # --- (a) the list, card against CPU --------------------------------
        for name, d, engine in (("(A) EAM + ORDERSH", da, "auto"),
                                ("(B) table LJ", db, "nlist")):
            sim = sim_of(d, engine)
            assert sim.engine == "nlist", sim.engine
            st, g, grid = sim.ss.state, sim.ss.box.geom, sim.grid
            pbc = sim.sysdef.box.pbc
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() / 2 ** 30
            nbr, cnt, ov = build_neighbor_list(st.r, st.fmask, g, grid,
                                               pbc=pbc)
            peak = gib() - base
            ms = time_calls(lambda: build_neighbor_list(
                st.r, st.fmask, g, grid, pbc=pbc), 5, warm=1)
            # the plain cell-block engine's rebuild on the same state
            sd = sim.sysdef
            cbg = CellBlockGrid.plan(g.cpu().double().numpy(), sd.rcut_max,
                                     sd.neighbor_deltaR, st.n_local)
            ms_cb = time_calls(lambda: build_cell_slots(
                st.r, st.fmask, g, cbg), 5, warm=1)
            cpu = build_neighbor_list(st.r.cpu(), st.fmask.cpu(), g.cpu(),
                                      grid, pbc=pbc)
            assert not bool(ov) and not bool(cpu[2]), "list overflow"
            assert torch.equal(cnt.cpu(), cpu[1]), f"{name}: counts differ"
            nd = rows_as_sets(name, nbr, cpu[0], st.r, g, grid.rlist)
            phase("nlist", f"(a) {name}: {st.n_local} atoms, cells "
                  f"{grid.ncells} cap {grid.cell_capacity}, K "
                  f"{grid.max_neighbors}, largest count {int(cnt.max())}: "
                  f"the card's list equals the CPU's ({nd} rows differ "
                  f"only at rlist); build {ms:.3f} ms by events, peak "
                  f"{peak:.2f} GiB above the state (the cell-block "
                  f"engine's binning, cells {cbg.ncells} cap {cbg.cap}: "
                  f"{ms_cb:.3f} ms) on {card}")
            del sim, nbr, cpu

        # --- (c) the slice: (A) under auto, (B) on "nlist" ---------------
        for name, d, engine, T, n_steps, tail in (
                ("(A)", da, "auto", EAM_T, NLIST_A_STEPS, NLIST_A_TAIL),
                ("(B)", db, "nlist", LJ_T, NLIST_STEPS, NLIST_TAIL)):
            sim = sim_of(d, engine)
            assert sim.engine == "nlist", sim.engine
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rows = []
            counters_zero()
            t0 = time.perf_counter()
            sim.run(n_steps, print_fn=rows.append,
                    max_steps_per_dispatch=DISPATCH)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            idle(f"{name} run")
            peak = gib()
            data = np.array([ln.split() for ln in rows], dtype=np.float64)
            assert np.isfinite(data).all(), f"{name}: non-finite row"
            temp = float(data[data[:, 0] > n_steps - tail, 5].mean())
            assert abs(temp - T) <= TEMP_TOL, f"{name}: mean T {temp}"
            steps = sum(k for k, _ in sim.dispatch_log)
            rate = steps / sum(t for _, t in sim.dispatch_log)
            busy, kps = window_stats(lambda: sim.run(
                PROFILE_STEPS, print_fn=quiet), PROFILE_STEPS + 1)
            idle(f"{name} profiled window")
            extra = ""
            if name == "(A)":
                osh = next(p[2] for p in sim.sysdef.potentials
                           if p[0] == "ORDERSH")
                ss, nbr, _ = sim._build_nbr(sim.ss)
                phi = make_ordersh_eval(osh, ss.state.n_local)(
                    ss.state.r, ss.state.fmask, nbr, ss.box.geom)[4]
                snap = write_snapshot(sim, d)
                q6 = os.path.join(snap, "q6#000000")
                size = os.path.getsize(q6)
                assert size > ss.state.n_local * 4 * 15, size
                extra = (f"; sqrt(phi) {math.sqrt(float(phi)):.5f} (ideal "
                         f"fcc 0.57452); snapshot {os.path.basename(snap)} "
                         f"with q6#000000 ({size} bytes)")
                del ss, nbr
            phase("nlist", f"(c) {name} {sim.sysdef.state.n_local} atoms, "
                  f"{n_steps} steps through Simulation (engine "
                  f"{sim.engine}, cells {sim.grid.ncells} cap "
                  f"{sim.grid.cell_capacity} K {sim.grid.max_neighbors}): "
                  f"mean T {temp:.2f} K over the last {tail} steps, "
                  f"Etot {data[-1, 2]:.6g}, redos {sim.redos}, no custom "
                  f"kernel launched; {rate:.2f} steps/s, busy {100 * busy:.1f}%"
                  f" over {PROFILE_STEPS} profiled steps ({kps:.1f} CUDA "
                  f"kernels a step), peak {peak:.2f} GiB{extra} on {card}")
            del sim

        # --- (b) the list engine against the kernels, one state ---------
        def first(d, eng, dtype=torch.float32):
            """(first energy, forces (n,3) f64, the Simulation) of the deck
            in d on `eng` in `dtype`, from the deck's start state; a
            kernel engine must launch its kernels, the list none."""
            s = tsim.Simulation(*load(d), run_dir=d, device=dev,
                                engine=eng, dtype=dtype)
            assert s.engine == eng, s.engine
            counters_zero()
            s.first_energy()
            torch.cuda.synchronize()
            c = all_counters()
            assert any(c.values()) if eng == "kernel" else not any(
                c.values()), f"{eng}: launches {c}"
            n = s.sysdef.state.n_local
            return float(s.ss.energy.eion), s.ss.state.f[:n].double(), s

        def errs(got, ref):
            """(e rel, force err over the reference's force scale)"""
            return (abs(got[0] - ref[0]) / abs(ref[0]),
                    float((got[1] - ref[1]).abs().max())
                    / float(ref[1].abs().max()))

        def gate(name, got, ref, ref64, e_gate, f_gate, what):
            """Print got against ref (and both against the f64 list
            engine ref64, the rounding each f32 engine carries), and hold
            got to ref at the gates: a miss fails the phase at its end,
            after every case has printed its numbers."""
            e_rel, f_rel = errs(got, ref)
            g64, r64 = errs(got, ref64), errs(ref, ref64)
            phase("nlist", f"(b) {name}: e {got[0]:.8g} vs {ref[0]:.8g} "
                  f"(rel {e_rel:.2g}, gate {e_gate:g}), force err "
                  f"{f_rel:.3g} of the scale {float(ref[1].abs().max()):.4g} "
                  f"(gate {f_gate:g}); against the list engine in f64: "
                  f"{what} e rel {g64[0]:.2g} force {g64[1]:.3g}, the "
                  f"reference e rel {r64[0]:.2g} force {r64[1]:.3g}")
            if not (e_rel <= e_gate and f_rel <= f_gate):
                failed.append((name, e_rel, f_rel))

        with tempfile.TemporaryDirectory() as de:
            eam_deck(de, EAM_BIG_NC, 50)
            ref64 = first(de, "nlist", torch.float64)
            got, ref = first(de, "nlist"), first(de, "kernel")
            gate(f"nc={EAM_BIG_NC} RATIONAL crystal, list engine vs #5 "
                 f"(G={ref[2].force_fn.terms[0].G})", got, ref, ref64,
                 NLIST_EAM_GATES[0], NLIST_EAM_GATES[1], "the list in f32")
            del ref64, got, ref

        with tempfile.TemporaryDirectory() as dl:
            lj_deck(dl, LJ_BIG_N, 50)
            ref64 = first(dl, "nlist", torch.float64)
            got, ref = first(dl, "nlist"), first(dl, "kernel")
            gate(f"lj_fluid {LJ_BIG_N} atoms, list engine vs #2 "
                 f"(G={ref[2].force_fn.terms[0].G})", got, ref, ref64,
                 NLIST_LJ_GATES[0], NLIST_LJ_GATES[1], "the list in f32")
            # (B) from the same start state (the builder's seed): the table
            # against the analytic deck on #2, whose pairs carry the shift
            # -v(rc) (shift=1), added back over the pairs within rc
            tab = first(db, "nlist")
            tab64 = first(db, "nlist", torch.float64)
            assert torch.equal(tab[2].ss.state.r, got[2].ss.state.r)
            pot = got[2].sysdef.potentials[0][2]
            shift = float(pot.shift[0, 0])
            ss, nbr, _ = got[2]._build_nbr(got[2].ss)
            dr = ss.box.min_image(ss.state.r[:, None, :] - torch.cat(
                [ss.state.r, ss.state.r.new_zeros((1, 3))])[nbr])
            npair = int(((nbr != ss.state.n_pad)
                         & ((dr * dr).sum(-1) < pot.rcut ** 2)).sum()) // 2
            del ss, nbr, dr
            back = lambda x: (x[0] + npair * shift, x[1])      # noqa: E731
            tb, t32 = errs(back(tab64), ref64), errs(tab, tab64)
            phase("nlist", f"(b) (B) table deck: {npair} pairs within rc, "
                  f"shift {shift:.4g} a pair; the table in f64 against "
                  f"the analytic deck in f64 (the table's own error): e rel "
                  f"{tb[0]:.2g}, force {tb[1]:.3g}; the table in f32 "
                  f"against f64: e rel {t32[0]:.2g}, force {t32[1]:.3g}")
            gate("(B) table deck on the list engine, the shift added back, "
                 f"vs the analytic deck on #2", back(tab), ref, ref64,
                 NLIST_TAB_GATES[0], NLIST_TAB_GATES[1], "the table in f32")
            del ref64, got, ref, tab, tab64

    # --- (d) small decks, card against CPU --------------------------------
    slab3 = lambda d: lj_deck(d, 1000, 100, free=True,          # noqa: E731
                              edit=slab_edit)
    card_vs_cpu((("EAM + ORDERSH crystal nc=5 (500 atoms) FREE f32 40 steps",
                  lambda d: ordersh_eam_deck(d, 5, 100, free=True),
                  torch.float32, 40),
                 ("EAM + PAIRENERGY crystal nc=5 FREE f32 40 steps",
                  lambda d: pairenergy_deck(d, 5, 100, free=True),
                  torch.float32, 40),
                 ("table LJ 500 atoms FREE f32 40 steps",
                  lambda d: table_lj_deck(d, 500, 100, free=True),
                  torch.float32, 40, dict(engine="nlist")),
                 ("bilayer nx=8 widened exclusions FREE NPT f32 20 steps",
                  lambda d: bilayer_deck(d, SMALL_NX, EQ_DT, 100, free=True),
                  torch.float32, 20,
                  dict(context=lambda: widened(tsim))),
                 ("pbc=3 REFLECT LJ slab 1000 atoms FREE f32 40 steps",
                  slab3, torch.float32, 40, dict(engine="nlist"))),
                counters_zero, all_counters, engine="nlist", modulo_box=True)
    assert not failed, f"(b) gates missed: {failed}"


def charmm_phase(card, dev, counters_zero, all_counters):
    """Phase 19, CHARMM all-atom decks: (a) (C), the c36 solvated
    tripeptide (3,630 atoms), through the CLI in f32 for C36_STEPS steps:
    auto demotes it to the list engine with the warning, no kernel
    launches, mean T, steps/s, busy share, CUDA kernels a step, the list
    build, the peak memory and the bonded term's CUDA graph against its
    eager function; its first energy and forces against f64 on the same
    state; (b) in f64 with a FREE group at dt 0.25 fs, C36_NVE_STEPS steps
    from rest: the JAX test's 102-atom deck against its bound (|dEtot| <=
    0.5 kJ/mol after 100 steps), (C)'s reads over the first 100 steps
    against the JAX package's (C36_NVE_JAX), max |dEtot| and the drift,
    and (C) in f32 as the control; (c) (E), the ethane fluid (32,768
    atoms), through Simulation on the kernel its plan gives (#2): that
    kernel against its plain version on (E)'s records, the kernels' first
    forces against the cell-block engine's in f64, ETH_STEPS NVT steps
    with rates and the bonded graph's check; (d) (E) through
    ParallelSimulation at (1,1,1) on #6: #6 against its plain version on
    the mesh's own records, the first energy against (c)'s, two chunks;
    (e) small decks on the card against the CPU.  Every gate is
    checked after every part has printed.  Returns ({kernels JSON entry:
    launches}, {entry: compare result})."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.nbr.celllist import build_neighbor_list
    from ddcmd_tpu_torch.objects import units as U
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    quiet = lambda line: None                                  # noqa: E731

    def idle(what):
        c = all_counters()
        assert not any(c.values()), f"{what}: kernels launched {c}"

    def gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30

    def sim_of(d, where=dev, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # (C)'s demotion warning
            return Simulation(*load(d), run_dir=d, device=where, **kw)

    def on_state(d, src, dtype, **kw):
        """A Simulation of the deck in d in dtype from src's positions,
        after its first energy."""
        s = sim_of(d, dtype=dtype, **kw)
        s.ss = s.ss.replace(state=s.ss.state.replace(
            r=src.ss.state.r.to(dtype)))
        s.first_energy()
        return s

    def errs(got, ref):
        """(e rel, force err over the reference's force scale, scale)"""
        n = ref.sysdef.state.n_local
        f0 = ref.ss.state.f[:n].double().cpu()
        scale = float(f0.abs().max())
        e0 = float(ref.ss.energy.eion)
        return (abs(float(got.ss.energy.eion) - e0) / abs(e0),
                float((got.ss.state.f[:n].double().cpu() - f0).abs().max())
                / scale, scale)

    def printrate(deck, k):
        with open(deck) as f:
            text = f.read()
        with open(deck, "w") as f:
            f.write(text.replace("printrate=100;", f"printrate={k};"))

    launches, res = {}, {}
    missed = []     # the gates missed, raised at the phase's end

    def gate(ok, what):
        if not ok:
            missed.append(what)

    def blocks(data, k=1000):
        """mean T of each k-step block of printinfo rows"""
        return " ".join(
            "%.1f" % data[(data[:, 0] > a) & (data[:, 0] <= a + k), 5].mean()
            for a in range(0, int(data[-1, 0]), k))

    def bonded_check(what, sim):
        ok, text = bonded_graph_check(sim)
        gate(ok, f"{what} bonded graph vs eager: {text}")
        return text

    # --- (a) (C) through the CLI, f32 -------------------------------------
    with tempfile.TemporaryDirectory() as d:
        deck = charmm_tripeptide_deck(d, C36_L, C36_MAX_W, dt_fs=1.0)
        printrate(deck, 10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters_zero()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sim = cli_run(["simulate", "-o", deck, "-n", str(C36_STEPS),
                           "--run-dir", d])
        torch.cuda.synchronize()
        idle("(C) run")
        peak = gib()
        rows = read_rows(d)
        demoted = [str(x.message) for x in caught
                   if "demoting" in str(x.message)]
        assert demoted and sim.engine == "nlist", (sim.engine, demoted)
        assert sim.ss.loop == C36_STEPS and np.isfinite(rows).all(), \
            "(C): non-finite printinfo row"
        temp = float(rows[rows[:, 0] > C36_STEPS - C36_TAIL, 5].mean())
        rate, tail = tail_rate(sim, C36_TAIL)
        st, g, grid = sim.ss.state, sim.ss.box.geom, sim.grid
        ms_list = time_calls(lambda: build_neighbor_list(
            st.r, st.fmask, g, grid, pbc=sim.sysdef.box.pbc), 5, warm=1)
        busy, kps = window_stats(lambda: sim.run(
            PROFILE_STEPS, print_fn=quiet), PROFILE_STEPS + 1)
        idle("(C) profiled window")
        bonded_text = bonded_check("(C)", sim)
        n = sim.sysdef.state.n_local
        phase("charmm", f"(a) (C) c36 tripeptide + {C36_MAX_W} TIP3, {n} "
              f"atoms, L {C36_L:.0f} A, f32, {C36_STEPS} LANGEVIN steps at "
              f"1 fs through the CLI: {demoted[0]!r}; engine {sim.engine} "
              f"(cells {grid.ncells} cap {grid.cell_capacity} K "
              f"{grid.max_neighbors}), no kernel launched, every energy "
              f"finite, redos {sim.redos}; mean T {temp:.2f} K over the "
              f"last {C36_TAIL} steps (by 1000 steps: {blocks(rows)}), Etot/atom "
              f"{rows[-1, 2]:.6g}; "
              f"{rate:.2f} steps/s over the last {tail} steps, busy "
              f"{100 * busy:.1f}% over {PROFILE_STEPS} profiled steps "
              f"({kps:.1f} CUDA kernels a step), list build {ms_list:.3f} "
              f"ms by events, peak {peak:.3f} GiB; {bonded_text} on {card}")
        gate(abs(temp - CHARMM_T) <= TEMP_TOL, f"(C): mean T {temp}")
        del sim
        # the first energy and forces in f32 against f64 on the same state
        s32 = sim_of(d)
        s32.first_energy()
        s64 = on_state(d, s32, torch.float64)
        e_rel, f_rel, scale = errs(s32, s64)
        phase("charmm", f"(a) (C) first energy f32 "
              f"{float(s32.ss.energy.eion):.8g} vs f64 "
              f"{float(s64.ss.energy.eion):.10g} (rel {e_rel:.3g}, gate "
              f"{NLIST_LJ_GATES[0]:g}), force err {f_rel:.3g} of the scale "
              f"{scale:.5g} (gate {NLIST_LJ_GATES[1]:g})")
        gate(e_rel <= NLIST_LJ_GATES[0] and f_rel <= NLIST_LJ_GATES[1],
             f"(C) f32 vs f64: e rel {e_rel}, force {f_rel}")
        del s32, s64

    # --- (b) NVE in f64: the JAX test's deck, then (C) ------------------------
    def nve(what, L, max_w, dtype, steps):
        """dEtot (kJ/mol) every C36_NVE_CHUNK steps of `steps` NVE steps
        from rest, with the atoms, the final T, steps/s and the redos."""
        with tempfile.TemporaryDirectory() as d:
            charmm_tripeptide_deck(d, L, max_w, nve=True, dt_fs=C36_NVE_DT)
            sim = sim_of(d, dtype=dtype)
            assert sim.engine == "nlist", sim.engine
            sim.first_energy()
            n = sim.sysdef.state.n_local
            etots = [float(sim.ss.energy.eion + sim.ss.energy.rk)]
            t0 = time.perf_counter()
            for _ in range(steps // C36_NVE_CHUNK):
                sim.run(C36_NVE_CHUNK, print_fn=quiet)
                etots.append(float(sim.ss.energy.eion + sim.ss.energy.rk))
            secs = time.perf_counter() - t0
            idle(f"{what} NVE")
        etots = np.asarray(etots)
        assert np.isfinite(etots).all(), f"{what} NVE: non-finite energy"
        temp = 2 * float(sim.ss.energy.rk) / (3 * n * U.kB)
        return etots - etots[0], n, temp, steps / secs, sim.redos

    k100 = 100 // C36_NVE_CHUNK
    for what, L, max_w in (("the JAX test's deck", 20.0, 24),
                           ("(C)", C36_L, C36_MAX_W)):
        de, n, temp, rate, redos = nve(what, L, max_w, torch.float64,
                                       C36_NVE_STEPS)
        t_ns = np.arange(len(de)) * C36_NVE_CHUNK * C36_NVE_DT * 1e-6
        slope = np.polyfit(t_ns, de, 1)[0] / n
        if what == "(C)":
            off = float(np.abs(de[1:k100 + 1] - C36_NVE_JAX).max())
            text = (f"reads over the first 100 steps within {off:.3g} "
                    f"kJ/mol of the JAX package's (gate {C36_NVE_BAND:g})")
            gate(off <= C36_NVE_BAND, f"(C) NVE: {off} kJ/mol off JAX's")
        else:
            text = f"gate {C36_NVE_GATE} kJ/mol"
            gate(abs(de[k100]) <= C36_NVE_GATE,
                 f"{what} NVE: |dEtot| {abs(de[k100])} after 100 steps")
        phase("charmm", f"(b) {what}, {n} atoms, NVE f64, FREE, dt "
              f"{C36_NVE_DT} fs, {C36_NVE_STEPS} steps from rest: |dEtot| "
              f"after 100 steps {abs(de[k100]):.10g} kJ/mol ({text}), max "
              f"|dEtot| {np.abs(de).max():.4g} kJ/mol, drift "
              f"{slope:.4g} kJ/mol/ns/atom (fit over {len(de)} reads), "
              f"final T {temp:.1f} K; {rate:.2f} steps/s (reads included), "
              f"redos {redos} on {card}")
    # the control: (C) with f32 positions and forces, against the same
    # JAX reads, shows what the band tells apart
    de, *_ = nve("(C) f32", C36_L, C36_MAX_W, torch.float32, 100)
    off = float(np.abs(de[1:] - C36_NVE_JAX).max())
    phase("charmm", f"(b) control: (C) in f32, 100 NVE steps: |dEtot| "
          f"after 100 steps {abs(de[-1]):.6g} kJ/mol, reads within "
          f"{off:.3g} kJ/mol of the JAX package's f64 reads")

    # --- (c) (E) through Simulation on the kernels -------------------------
    with tempfile.TemporaryDirectory() as d:
        deck = charmm_ethane_deck(d, ETH_N, ETH_L)
        printrate(deck, 10)
        sim = sim_of(d)
        term = sim.force_fn.terms[0]
        name = "cellpair_half_col" if term.G > 1 else "cellpair_half"
        assert sim.engine == "kernel", sim.engine
        kernel, args, kw, _ = sim_kernel_inputs(sim)
        sig = args[5 if term.G > 1 else 4]
        assert kw["excl"] and kw["coulomb"] and sig.shape == (2, 2), kw
        plain = (ch.cellpair_half_col_plain if term.G > 1
                 else ch.cellpair_half_plain)
        res[name] = compare(
            f"{name} on (E)'s records, {sim.sysdef.state.n_local} atoms, "
            f"cells {sim.grid.ncells} cap {sim.grid.cap} G={term.G}, T=2, "
            "RF, exclusions", kernel, plain, args, kw, with_bound=True,
            device_key="cellpair_half_kernel")
        # the kernels' first forces against the cell-block engine's in f64
        counters_zero()
        sim.first_energy()
        c = all_counters()
        assert c[name] >= 1, c
        e_first = float(sim.ss.energy.eion)
        cb = on_state(d, sim, torch.float64, engine="cellblock")
        e_rel, f_rel, scale = errs(sim, cb)
        phase("charmm", f"(c) (E) the kernels' first energy "
              f"{e_first:.8g} vs the cell-block engine in f64 "
              f"{float(cb.ss.energy.eion):.10g} (rel {e_rel:.3g}), force "
              f"err {f_rel:.3g} of the scale {scale:.5g}")
        gate(e_rel <= 1e-4 and f_rel <= 2e-5,
             f"(E) kernels vs cell-block f64: e rel {e_rel}, force {f_rel}")
        del cb
        rows = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters_zero()
        sim.run(ETH_STEPS, print_fn=rows.append,
                max_steps_per_dispatch=DISPATCH)
        torch.cuda.synchronize()
        c = all_counters()
        peak = gib()
        assert c[name] >= ETH_STEPS, c
        assert not any(v for k, v in c.items()
                       if k not in (name, "cellpair_half_excl")), c
        launches[f"{name}_charmm"] = c[name]
        data = np.array([ln.split() for ln in rows], dtype=np.float64)
        assert np.isfinite(data).all(), "(E): non-finite row"
        temp = float(data[data[:, 0] > ETH_STEPS - TAIL, 5].mean())
        rate, tail = tail_rate(sim)
        busy, kps = window_stats(lambda: sim.run(
            PROFILE_STEPS, print_fn=quiet), PROFILE_STEPS + 1)
        bonded_text = bonded_check("(E)", sim)
        n = sim.sysdef.state.n_local
        phase("charmm", f"(c) (E) ethane {ETH_N} molecules, {n} atoms, "
              f"box {ETH_L} nm, f32, {ETH_STEPS} LANGEVIN steps at 1 fs "
              f"through Simulation: cells {sim.grid.ncells} cap "
              f"{sim.grid.cap} G={term.G}, {name} launched {c[name]} times "
              f"and no other kernel; mean T {temp:.2f} K over the last "
              f"{TAIL} steps (by 1000 steps: {blocks(data)}), Etot/atom "
              f"{data[-1, 2]:.6g}, redos "
              f"{sim.redos}; {rate:.2f} steps/s over the last {tail} steps,"
              f" busy {100 * busy:.1f}% over {PROFILE_STEPS} profiled steps "
              f"({kps:.1f} CUDA kernels a step); {bonded_text}; peak "
              f"{peak:.3f} GiB on {card}")
        gate(abs(temp - CHARMM_T) <= TEMP_TOL, f"(E): mean T {temp}")
        del sim

        # --- (d) (E) through the mesh at (1,1,1) --------------------------
        ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev)
        e_mesh = ps.first_energy()
        rel = abs(e_mesh - e_first) / abs(e_first)
        # #6 against its plain version on the mesh's own records
        name = "cellpair_half_ext_excl"
        kernel, args, kw = ps.step_fn.kernel_inputs(ps.fields, ps.mask)
        cp = ps.cplan
        assert kernel is ch.cellpair_half_ext and kw["excl"] and \
            kw["coulomb"] and args[4].shape == (2, 2), kw
        res[name] = compare(
            f"{name} on (E)'s mesh records at (1,1,1), "
            f"{ps.sysdef.state.n_local} atoms, {cp.n_prog} core cells "
            f"{cp.ncore} + sentinel, cap {cp.cap}, T=2, RF, exclusions",
            kernel, ch.cellpair_half_plain, args, kw, with_bound=True,
            device_key="cellpair_half_kernel")
        sentinel_zero(f"{name} on (E)'s mesh records", kernel(*args, **kw)[1])
        del args
        counters_zero()
        ps.run(2 * ps.chunk_steps, print_fn=quiet)
        torch.cuda.synchronize()
        c = all_counters()
        assert c[name] >= 2 * ps.chunk_steps, c
        assert not any(v for k, v in c.items() if k not in (
            "cellpair_half_ext", name)), c
        launches[f"{name}_charmm"] = c[name]
        assert torch.isfinite(ps.f[ps.mask]).all(), "(E) mesh: forces"
        phase("charmm", f"(d) (E) through ParallelSimulation at (1,1,1): "
              f"ncore {cp.ncore} cap {cp.cap}; first energy "
              f"{e_mesh:.8g} vs Simulation's {e_first:.8g} (rel {rel:.3g}, "
              f"gate 2e-5); {2 * ps.chunk_steps} steps, #6 with exclusions "
              f"launched {c[name]} times, forces finite")
        gate(rel <= 2e-5, f"(E) mesh first energy rel {rel}")
        del ps

    # --- (e) small decks, card against CPU --------------------------------
    cases = (("c36 tripeptide L=20 A, 24 TIP3, f64 nlist",
              lambda d: charmm_tripeptide_deck(d), torch.float64, "nlist",
              (1e-9, 1e-9)),
             ("ethane 216 molecules 4.0 nm, f64 nlist",
              lambda d: charmm_ethane_deck(d, 216, 4.0), torch.float64,
              "nlist", (1e-9, 1e-9)),
             ("ethane 216 molecules 4.0 nm, f32 on #1",
              lambda d: charmm_ethane_deck(d, 216, 4.0), torch.float32,
              "kernel", (1e-4, 2e-5)))
    for what, make, dtype, engine, (e_gate, f_gate) in cases:
        with tempfile.TemporaryDirectory() as d:
            make(d)
            card_sim = sim_of(d, dtype=dtype, engine=engine)
            cpu_sim = sim_of(d, "cpu", dtype=dtype, engine=engine)
            for s in (card_sim, cpu_sim):
                s.first_energy()
        e_rel, f_rel, scale = errs(card_sim, cpu_sim)
        phase("agree", f"{what}, first energy card vs CPU: "
              f"{float(card_sim.ss.energy.eion):.10g} vs "
              f"{float(cpu_sim.ss.energy.eion):.10g} (rel {e_rel:.3g}, gate "
              f"{e_gate:g}), force err {f_rel:.3g} of the scale {scale:.5g} "
              f"(gate {f_gate:g})")
        gate(e_rel <= e_gate and f_rel <= f_gate,
             f"{what}: e rel {e_rel}, force {f_rel}")
    assert not missed, f"phase 19 gates missed: {missed}"
    return launches, res


# --- phase 20 (item 22): the integrators, the GROUP types and box(t) ------
# The RATIONAL deck's FITs put eam_crystal's fcc lattice (a = 3.615 A) at
# 43.9 GPa; its static pressure crosses zero at a = 4.30 A (-0.03 GPa; at
# 4.25 and 4.40 A +1.11 and -1.90 GPa, so B ~28.5 GPa at 19.9 A^3 an
# atom; f64 on the CPU, 256 atoms).  NPTGLF at 1 bar from 3.615 A expands
# the crystal past its tensile limit (~2 GPa) without bound (864 atoms on
# the CPU: 11.8 -> 92 A^3 an atom in 3.7 ps, zeta still growing), so (a)
# and (c) start from the zero-pressure lattice
INT_A_LAT = 4.30
# NPTGLF moves the volume an atom as d2V/dt2 = (P - Peq)/Gamma: a period
# of 2 pi sqrt(Gamma V/B), ~1.0 ps at Gamma = 2.2 amu/A^4
NPT_GAMMA, INT_NPT_STEPS = 2.2, 2000
# NGLFNK on the LJ fluid: the atoms' affine flow S dL/dt carries N m / 12
# (436,000 amu at n = 131,072) of an axis's inertia beside W, and its
# kinetic pressure pushes the piston on (dL/dt grows as N m (dL/dt)^2 /
# (12 W L)): W = 4,300 amu (a ~3 ps period by the static B ~1.7 GPa)
# diverged at step 152 on the card, 1e4 heated the fluid to 259 K,
# 3e4-1e6 held it within 6-18 K of 120 K (2,000 steps each, H100 80GB
# HBM3, 700.00 W).  With W = 1e5 amu the box grows ~8% toward 500 bar
# over the 8 ps (the period is set by the flow's inertia: ~30 ps)
NK_P, NK_TAU, NK_W, NK_STEPS = 500.0, 0.5, 1e5, 2000
STRAIN_U, STRAIN_STEPS = 1e-6, 500          # dudt on z, 1/fs
SHEAR_V, SHEAR_TAU, SHEAR_STEPS = 1e-3, 0.2, 500    # A/fs, ps
INT_SMALL_N, INT_SMALL_STEPS = 500, 20      # (e): card vs CPU
NVE_CHECK_STEPS = 100
# the small decks' NPTGLF: the LJ fluid's B ~1.7 GPa at 48.1 A^3 an atom
# gives a ~1 ps period at 0.054 amu/A^4
SMALL_LJ_GAMMA = 0.054


def nptglf_edit(gamma=NPT_GAMMA, pressure=1.0):
    """The deck's NGLF integrator made NPTGLF (Gamma in amu/A^4, pressure
    in bar, zeta 0)."""
    return lambda text: text.replace(
        "type=NGLF;", f"type=NPTGLF; Gamma={gamma} amu/Angstrom^4; "
        f"pressure={pressure} bar; zeta=0 bar*fs;", 1)


def nglfnk_edit(W=NK_W, P=NK_P, tau=NK_TAU):
    """The deck's NGLF integrator made NGLFNK (piston mass W amu an axis,
    P bar, friction time tau ps; T stays the deck's)."""
    return lambda text: text.replace(
        "type=NGLF;", f"type=NGLFNK; tau={tau} ps; P={P} bar; "
        f"W={W} {W} {W} amu;", 1)


def box_edit(keywords):
    """The deck's BOX with `keywords` added (a box(t))."""
    return lambda text: text.replace("pbc=7;", f"pbc=7; {keywords}", 1)


def tilt_edit(text, tilt=0.1):
    """The deck's orthorhombic box with its b vector tilted by tilt Lx in
    x (the lengths kept)."""
    import re

    m = re.search(r"h= (\S+) 0 0 0 (\S+) 0 0 0 (\S+) ;", text)
    Lx, Ly, Lz = (float(m.group(i)) for i in (1, 2, 3))
    return text.replace(m.group(0), f"h= {Lx} {tilt * Lx:.6f} 0 0 {Ly} "
                        f"0 0 0 {Lz} ;")


def chain(*edits):
    def edit(text):
        for e in edits:
            text = e(text)
        return text
    return edit


def regroup(d, groups, assign, extra="", printrate=0, atoms=None,
            by_species=False):
    """Give the deck in d the GROUP objects `groups` ({name: body}) in
    place of its one group (the SYSTEM's groups=), each atom in the group
    assign(r) names (r: (n, 3) positions in A; with by_species, assign
    gets the atoms' species names instead); `extra`: more deck objects
    (UNIONGROUP members); `atoms`: the atoms file to regroup (a restart's
    snapshot; d/atoms#000000 by default).  With more than one group the
    deck's printrate becomes `printrate`: 0 by default (no per-group
    energy files)."""
    import re

    atoms = atoms or os.path.join(d, "atoms#000000")
    with open(atoms) as f:
        lines = f.read().split("\n")
    # records: id class type group rx ry rz vx vy vz, whitespace-separated
    # (a checkpoint pads its columns)
    rows = [i for i, ln in enumerate(lines)
            if len(ln.split()) >= 10 and ln.split()[0].isdigit()]
    if by_species:
        keys = [lines[i].split()[2] for i in rows]
    else:
        keys = np.array([[float(x) for x in lines[i].split()[4:7]]
                         for i in rows])
    for i, g in zip(rows, assign(keys)):
        parts = lines[i].split()
        parts[3] = g
        lines[i] = " ".join(parts)
    with open(atoms, "w") as f:
        f.write("\n".join(lines))
    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    old = re.search(r"groups=(\w+);", text).group(1)
    text = re.sub(rf"^{old} GROUP \{{[^}}]*\}}\n", "", text, flags=re.M)
    text = text.replace(f"groups={old};", f"groups={' '.join(groups)};")
    if len(groups) > 1:
        text = re.sub(r"printrate=\d+;", f"printrate={printrate};", text)
    text += "".join(f"{k} GROUP {{ {v} }}\n" for k, v in groups.items())
    with open(p, "w") as f:
        f.write(text + extra)
    return p


def box_edge(d):
    """The deck's first box edge, A."""
    import re

    with open(os.path.join(d, "object.data")) as f:
        return float(re.search(r"h= (\S+) ", f.read()).group(1))


def shear_groups(L, v=SHEAR_V, tau=SHEAR_TAU, temp=LJ_T, style="SHEAR"):
    """One SHEAR (or SHWALL) group over every atom: slices at +-L/4 (SHWALL:
    at the z faces), L/4 wide, driven at +-v A/fs in y and held at temp
    K."""
    body = (f"type={style}; tau={tau} ps; top_width={L / 4:.6f} Angstrom; "
            f"bottom_width={L / 4:.6f} Angstrom; top_velocity={v} "
            f"Angstrom/fs; bottom_velocity={-v} Angstrom/fs; "
            f"top_temp={temp} K; bottom_temp={temp} K;")
    if style == "SHEAR":
        body += (f" top_center={L / 4:.6f} Angstrom; bottom_center="
                 f"{-L / 4:.6f} Angstrom;")
    return {"sh": body}


def group_decks(n=INT_SMALL_N):
    """(name, make_deck) of a small LJ fluid deck for each GROUP type and
    Teq_dynamics=GLOBAL_ENERGY: slabs of the box in z take the other
    groups; velocities in A/fs, forces in eV/A."""
    def deck(groups, assign=None, extra=""):
        def make(d):
            p = lj_deck(d, n, printrate=10)
            L = box_edge(d)
            g = groups(L) if callable(groups) else groups
            first = next(iter(g))
            regroup(d, g, (lambda r: assign(r, L)) if assign
                    else (lambda r: [first] * len(r)), extra)
            return p
        return make

    def slab(r, L, names=("mob", "wall")):
        return [names[1] if z < -L / 4 else names[0] for z in r[:, 2]]

    free = "type=FREE;"
    return (
        ("FROZEN slab beside FREE", deck(
            {"mob": free, "wall": "type=FROZEN;"}, slab)),
        ("FIXEDVELOCITY slab beside FREE", deck(
            {"mob": free, "wall": "type=FIXEDVELOCITY; velocity=0 2e-3 0 "
             "Angstrom/fs;"}, slab)),
        ("EXTFORCE slab beside FREE", deck(
            {"mob": free, "wall": "type=EXTFORCE; force=0 0 0.02 "
             "eV/Angstrom;"}, slab)),
        ("PISTON slab (vz ramp) beside FREE", deck(
            {"mob": free, "wall": "type=PISTON; vz=RAMP(0,2e-3,0,40fs);"},
            slab)),
        ("QUENCH", deck({"q": "type=QUENCH;"})),
        ("BERENDSEN 240 K", deck({"ber": "type=BERENDSEN; Teq=240K; "
                                  "tau=0.05ps;"})),
        ("SHEAR", deck(lambda L: shear_groups(L))),
        ("SHWALL", deck(lambda L: shear_groups(L, style="SHWALL"))),
        ("DOUBLE_MIRROR", deck(lambda L: {"mir": (
            f"type=DOUBLE_MIRROR; point1=0 0 {-L / 2 + 3:.6f} Angstrom; "
            f"point2=0 0 {L / 2 - 3:.6f} Angstrom; normal1=0 0 1; "
            "normal2=0 0 -1; v1=2e-3 Angstrom/fs; v2=-2e-3 Angstrom/fs;")})),
        ("UNIONGROUP of LANGEVIN and EXTFORCE", deck(
            {"u": "type=UNIONGROUP; groups=bath push;"}, extra=(
                "bath GROUP { type=LANGEVIN; Teq=120K; tau=0.2ps; }\n"
                "push GROUP { type=EXTFORCE; force=0.02 0 0 eV/Angstrom; }\n"
            ))),
        ("IONIZATION, NONE and an unknown type (FREE)", deck(
            {"ion": "type=IONIZATION;", "none": "type=NONE;",
             "odd": "type=SOMETHING;"},
            lambda r, L: [("ion", "none", "odd")[i % 3]
                          for i in range(len(r))])),
        ("LANGEVIN Teq_dynamics=GLOBAL_ENERGY", deck(
            {"ge": "type=LANGEVIN; Teq=120K; tau=0.2ps; "
             "Teq_dynamics=GLOBAL_ENERGY; Cp=0.05 kJ*mol^-1*K^-1;"})),
    )


@contextlib.contextmanager
def host_noise():
    """Runs on the card draw the CPU's thermostat noise (kick_noise on a
    CPU generator, copied to the card), so a run on the card and its CPU
    twin integrate the same noise."""
    from ddcmd_tpu_torch.run import simulate

    orig = simulate.kick_noise
    gen = torch.Generator()

    def draw(generator, seed, step, callsite, shape, dtype=torch.float32,
             attempt=0):
        return orig(gen, seed, step, callsite, shape, dtype,
                    attempt).to(generator.device)

    simulate.kick_noise = draw
    try:
        yield
    finally:
        simulate.kick_noise = orig


def integrator_decks(n=INT_SMALL_N):
    """(name, make_deck) of phase 20 (e)'s integrator and box(t) decks."""
    def lj(edit):
        return lambda d: lj_deck(d, n, printrate=10, edit=edit)

    c, s = math.cos(0.1), math.sin(0.1)
    return (
        ("NVEGLF (LANGEVIN group ignored)", lj(
            lambda t: t.replace("type=NGLF;", "type=NVEGLF;"))),
        ("NVEGLF_SIMPLE", lj(
            lambda t: t.replace("type=NGLF;", "type=NVEGLF_SIMPLE;"))),
        ("NPTGLF, EAM nc=5 at a=4.30 A", lambda d: eam_deck(
            d, 5, 10, a_lat=INT_A_LAT, edit=nptglf_edit())),
        ("NPTGLF, LJ fluid", lj(nptglf_edit(SMALL_LJ_GAMMA, 500.0))),
        ("NGLFNK orthorhombic", lj(nglfnk_edit(W=200.0, P=2000.0))),
        ("NGLFNK triclinic (cell-block)", lj(chain(
            nglfnk_edit(W=200.0, P=2000.0), tilt_edit))),
        ("STRAIN dudt=0 0 1e-5", lj(box_edit("dudt=0 0 1e-5;"))),
        ("VOLUME Veq=46 A^3", lj(box_edit("Veq=46 Angstrom^3;"))),
        ("DEFORMATION_RATE off-diagonal (cell-block)", lj(box_edit(
            "deformationRate=5e-6 2e-5 0 0 0 0 0 0 0;"))),
        ("ROTATION (cell-block)", lj(box_edit(
            f"rotationMatrix={c} {-s} 0 {s} {c} 0 0 0 1;"))),
    )


def mesh_dynamics_decks(n=INT_SMALL_N):
    """(name, make_deck) of item 22's decks that ParallelSimulation runs
    as Simulation does (phase 29, tests/test_torch_mesh_dynamics.py): the
    n-atom LJ fluid with a FREE group (no noise), updateRate and
    printrate 10 (so both drivers' dispatches, which refresh the group
    coefficients at their start, end at the same loops), under NVEGLF
    (its LANGEVIN group kept: the NVE variants ignore it), NVEGLF_SIMPLE,
    NPTGLF,
    NGLFNK at a 0 K target (its draws' amplitude zero), STRAIN,
    DEFORMATION_RATE (off-diagonal: a tilting box), VOLUME, EXTFORCE, a
    SHEAR group whose top slice spans z = 0 and whose bottom slice spans
    the periodic seam, SHWALL, DOUBLE_MIRROR, UNIONGROUP of FREE
    members, a BERENDSEN Teq ramp, a PISTON vz(t) slab, and the nx = 2
    bilayer (132 beads, FREE, 10 fs) under NGLFNEW with its constraints
    and the Berendsen barostat; then GLOBAL_ENERGY, a LANGEVIN target
    (noisy)."""
    printrate = 10

    def rate(t):
        return (t.replace("updateRate=20;", "updateRate=10;")
                .replace("updateRate=12;", "updateRate=10;"))

    def lj(edit=None, free=True):
        return lambda d: lj_deck(d, n, printrate=printrate, free=free,
                                 edit=chain(rate, edit or (lambda t: t)))

    def grouped(groups, assign=None, extra=""):
        def make(d):
            p = lj_deck(d, n, printrate=printrate, free=True, edit=rate)
            L = box_edge(d)
            g = groups(L) if callable(groups) else groups
            first = next(iter(g))
            regroup(d, g, (lambda r: assign(r, L)) if assign
                    else (lambda r: [first] * len(r)), extra,
                    printrate=printrate)
            return p
        return make

    def slab(r, L):
        return ["wall" if z < -L / 4 else "mob" for z in r[:, 2]]

    def seam_shear(L):
        body = shear_groups(L)["sh"]
        return {"sh": body.replace(
            f"top_center={L / 4:.6f}", f"top_center={L / 16:.6f}").replace(
            f"bottom_center={-L / 4:.6f}",
            f"bottom_center={-L / 2 + L / 16:.6f}")}

    def bilayer(d):
        p = bilayer_deck(d, 2, 10.0, printrate, free=True)
        edit_deck(p, lambda t: rate(t).replace("type=NGLFCONSTRAINT;",
                                               "type=NGLFNEW;"))
        return p

    return (
        ("NVEGLF", lj(lambda t: t.replace("type=NGLF;", "type=NVEGLF;"),
                      free=False)),
        ("NVEGLF_SIMPLE", lj(lambda t: t.replace("type=NGLF;",
                                                 "type=NVEGLF_SIMPLE;"))),
        ("NPTGLF", lj(nptglf_edit(SMALL_LJ_GAMMA, 500.0))),
        ("NGLFNK", lj(chain(nglfnk_edit(W=200.0, P=2000.0),
                            lambda t: t.replace("T=120.0K;", "T=0K;")))),
        ("STRAIN", lj(box_edit("dudt=0 0 1e-4;"))),
        ("DEFORMATION_RATE", lj(box_edit(
            "deformationRate=5e-6 2e-5 0 0 0 0 0 0 0;"))),
        ("VOLUME", lj(box_edit("Veq=46 Angstrom^3;"))),
        ("EXTFORCE", grouped({"mob": "type=FREE;", "wall": (
            "type=EXTFORCE; force=0 0 0.02 eV/Angstrom;")}, slab)),
        ("SHEAR", grouped(seam_shear)),
        ("SHWALL", grouped(lambda L: shear_groups(L, style="SHWALL"))),
        ("DOUBLE_MIRROR", grouped(lambda L: {"mir": (
            f"type=DOUBLE_MIRROR; point1=0 0 {-L / 2 + 3:.6f} Angstrom; "
            f"point2=0 0 {L / 2 - 3:.6f} Angstrom; normal1=0 0 1; "
            "normal2=0 0 -1; v1=2e-3 Angstrom/fs; v2=-2e-3 Angstrom/fs;")})),
        ("UNIONGROUP", grouped({"u": "type=UNIONGROUP; groups=m1 m2;"},
                               extra="m1 GROUP { type=FREE; }\n"
                               "m2 GROUP { type=FREE; }\n")),
        ("BERENDSEN_RAMP", grouped({"ber": (
            "type=BERENDSEN; Teq=RAMP(120,240,0,80fs); tau=0.05ps;")})),
        ("PISTON_VZ", grouped({"mob": "type=FREE;", "wall": (
            "type=PISTON; vz=RAMP(0,2e-3,0,40fs);")}, slab)),
        ("NGLFNEW_CONSTRAINTS", bilayer),
        ("GLOBAL_ENERGY", grouped({"ge": (
            "type=LANGEVIN; Teq=120K; tau=0.2ps; "
            "Teq_dynamics=GLOBAL_ENERGY; Cp=0.05 kJ*mol^-1*K^-1;")})),
    )


def small_run(where, make_deck, steps):
    """Simulation (engine auto) of make_deck's deck on `where` for `steps`
    steps with the CPU's noise: ((engine, eion, rk, positions, h, zeta,
    bdot) as f64 host values, the Simulation)."""
    from ddcmd_tpu_torch.run.cli import load_db
    from ddcmd_tpu_torch.run.simulate import Simulation

    with tempfile.TemporaryDirectory() as d:
        deck = make_deck(d)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s = Simulation(load_db([deck], None, d), d, run_dir=d,
                           device=where)
            with host_noise():
                s.run(steps, print_fn=lambda line: None)
    ss = s.ss
    return (s.engine, float(ss.energy.eion), float(ss.energy.rk),
            ss.state.r.cpu().double().numpy(),
            ss.box.h.cpu().double().numpy(),
            float(ss.zeta), ss.bdot.cpu().double().numpy()), s


def shear_profile(sim, L):
    """(mean vy in 8 z bins (A/fs), top and bottom slice: mean vy and T K)
    of sim's state; the slices as the SHEAR hook reads them (|z -+ L/4|
    < L/8)."""
    st = sim.ss.state
    n = st.n_local
    return shear_profile_arrays(st.r[:n].cpu().double().numpy(),
                                st.v[:n].cpu().double().numpy(),
                                st.mass[:n].cpu().double().numpy(), L)


def shear_profile_arrays(r, v, m, L):
    """shear_profile of positions r (nm, any image), velocities v and
    masses m in a cubic box of edge L (A)."""
    from ddcmd_tpu_torch.objects import units as U

    r = r * 10.0
    r = r - L * np.round(r / L)
    vy = v[:, 1] * (U.LENGTH_TO_ANG / U.TIME_TO_FS)
    bins = np.clip(((r[:, 2] / L + 0.5) * 8).astype(int), 0, 7)
    prof = [float(vy[bins == b].mean()) for b in range(8)]
    out = []
    for c in (L / 4, -L / 4):
        dz = r[:, 2] - c
        dz -= L * np.round(dz / L)
        sel = np.abs(dz) < L / 8
        vcm = (m[sel, None] * v[sel]).sum(0) / m[sel].sum()
        ke = 0.5 * (m[sel] * ((v[sel] - vcm) ** 2).sum(1)).sum()
        temp = 2 * ke / (3 * (sel.sum() - 1) * U.kB)
        out.append((float(vcm[1] * U.LENGTH_TO_ANG / U.TIME_TO_FS), temp))
    return prof, out


def integrators_phase(card, dev, counters_zero, all_counters):
    """Phase 20, ROADMAP item 22 (integrators/nptglf.py, nglfnk.py, the
    GROUP types and box(t)) on the kernels #5 and #2: (a) NPTGLF on the
    nc = 32 crystal (131,072 Cu atoms at a = INT_A_LAT) through the CLI,
    INT_NPT_STEPS steps on #5; (b) NGLFNK on the 131,072-atom LJ fluid
    through the CLI, NK_STEPS steps on #2; (c) STRAIN (dudt = 0 0
    STRAIN_U) on the nc = 32 crystal, STRAIN_STEPS steps on #5; (d) SHEAR
    on the LJ fluid, SHEAR_STEPS steps on #2; each kernel against its
    plain version on its run's last records; (e) small decks on the card
    against the CPU (a deck for each GROUP type and GLOBAL_ENERGY, NVEGLF
    and NVEGLF_SIMPLE, NPTGLF, NGLFNK orthorhombic and triclinic, STRAIN,
    VOLUME, an off-diagonal DEFORMATION_RATE, ROTATION), a restart of
    zeta and bdot, and NVEGLF with the nc = 12 deck's LANGEVIN group
    against NGLF with a FREE group over NVE_CHECK_STEPS steps on #4.
    Every gate is checked after every part has printed.  Returns {kernels
    JSON row: (the kernel's entry, launches, its comparison's (max_abs_err,
    ms, plain_ms, bound_ms, bound_by))}: a row of its own for each path,
    its launches that path's and its comparison on that path's records."""
    from ddcmd_tpu_torch.io.restart import write_checkpoint
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.objects import units as U
    from ddcmd_tpu_torch.run.simulate import Simulation

    t_phase = time.perf_counter()
    quiet = lambda line: None                                  # noqa: E731
    bar = U.unit_scale("bar")
    rows_out = {}
    failed = []

    def gate(ok, what):
        if not ok:
            failed.append(what)

    def cli(deck, d, steps):
        counters_zero()
        sim = cli_run(["simulate", "-o", deck, "-n", str(steps),
                       "--run-dir", d])
        return sim, all_counters(), read_rows(d)

    def eam_rows(suffix, c, out, col=True):
        for p in ("rho", "force"):
            base = f"eam_{p}_col" if col else f"eam_{p}"
            rows_out[f"{base}_{suffix}"] = (base, c[base], out[p])

    def box_ok(rows):
        L = rows[:, 8:11]
        return bool(np.isfinite(L).all()
                    and (np.abs(L / L[0] - 1.0) <= 0.2).all())

    # --- (a) NPTGLF on the nc = 32 crystal, #5 ----------------------------
    with tempfile.TemporaryDirectory() as d:
        deck = eam_deck(d, EAM_BIG_NC, 10, a_lat=INT_A_LAT,
                        edit=nptglf_edit())
        sim, c, rows = cli(deck, d, INT_NPT_STEPS)
        n = sim.sysdef.state.n_local
        tail = rows[rows[:, 0] > INT_NPT_STEPS - TAIL]
        temp = float(tail[:, 5].mean())
        zeta = float(sim.ss.zeta)
        gate(sim.sysdef.integrator_type == "NPTGLF" and sim.force_fn.terms[
            0].G > 1 and sim.ss.loop == INT_NPT_STEPS, "(a) setup")
        gate(np.isfinite(rows).all(), "(a) finite rows")
        gate(abs(temp - EAM_T) <= TEMP_TOL, f"(a) mean T {temp}")
        gate(box_ok(rows), "(a) box within 20%")
        gate(math.isfinite(zeta), f"(a) zeta {zeta}")
        gate(c["eam_rho_col"] >= INT_NPT_STEPS
             and c["eam_force_col"] >= INT_NPT_STEPS
             and not any(v for k, v in c.items()
                         if k not in ("eam_rho_col", "eam_force_col")),
             f"(a) launches {c}")
        va = rows[:, 7]
        phase("integrators", f"(a) NPTGLF nc={EAM_BIG_NC} ({n} Cu atoms, a "
              f"= {INT_A_LAT} A, Gamma {NPT_GAMMA} amu/A^4, pressure 1 bar, "
              f"LANGEVIN {EAM_T:.0f} K, 2 fs), {INT_NPT_STEPS} steps through "
              f"the CLI: cells {sim.grid.ncells} G={sim.force_fn.terms[0].G}"
              f"; #5 launched {c['eam_rho_col']} / {c['eam_force_col']} "
              f"times, #4 {c['eam_rho']}; mean T {temp:.2f} K and mean P "
              f"{tail[:, 6].mean():.6g} {sim.printinfo.u_press} over the "
              f"last {TAIL} steps; V/atom {va.min():.4f}-{va.max():.4f} "
              f"{sim.printinfo.u_vol} (start {va[0]:.4f}), last zeta "
              f"{zeta:.6g}; redos {sim.redos}; {sim_rate_busy(sim)} on {card}")
        eam_rows("nptglf", c, sim_eam_check(sim, "(a)"))
        del sim

    # --- (b) NGLFNK on the 131,072-atom LJ fluid, #2 ------------------------
    with tempfile.TemporaryDirectory() as d:
        deck = lj_deck(d, LJ_BIG_N, printrate=10, edit=nglfnk_edit())
        sim, c, rows = cli(deck, d, NK_STEPS)
        tail = rows[rows[:, 0] > NK_STEPS - TAIL]
        temp = float(tail[:, 5].mean())
        h = sim.ss.box.h
        bdot = sim.ss.bdot.cpu().double().numpy()
        gate(sim.ss.loop == NK_STEPS and sim.force_fn.terms[0].G > 1,
             "(b) setup")
        gate(np.isfinite(rows).all(), "(b) finite rows")
        gate(bool(h[0, 0] == h[1, 1]) and bool(
            (rows[:, 8] == rows[:, 9]).all()), "(b) Lx == Ly")
        gate(abs(temp - LJ_T) <= TEMP_TOL, f"(b) mean T {temp}")
        gate(box_ok(rows), "(b) box within 20%")
        gate(np.isfinite(bdot).all() and bool(np.any(bdot != 0.0)),
             f"(b) bdot {bdot}")
        gate(c["cellpair_half_col"] >= NK_STEPS and not any(
            v for k, v in c.items() if k != "cellpair_half_col"),
            f"(b) launches {c}")
        L = rows[:, 8:11]
        phase("integrators", f"(b) NGLFNK lj_fluid {LJ_BIG_N} atoms (T "
              f"{LJ_T:.0f} K, tau {NK_TAU} ps, P {NK_P} bar, W {NK_W} amu an "
              f"axis, 4 fs), {NK_STEPS} steps through the CLI: cells "
              f"{sim.grid.ncells} G={sim.force_fn.terms[0].G}; #2 launched "
              f"{c['cellpair_half_col']} times; Lx == Ly on every row "
              f"{bool((rows[:, 8] == rows[:, 9]).all())} and at the end "
              f"{bool(h[0, 0] == h[1, 1])}; Lx {L[:, 0].min():.4f}-"
              f"{L[:, 0].max():.4f}, Lz {L[:, 2].min():.4f}-"
              f"{L[:, 2].max():.4f} A (start {L[0, 0]:.4f}); mean T "
              f"{temp:.2f} K, mean P {tail[:, 6].mean():.6g} "
              f"{sim.printinfo.u_press} over the last {TAIL} steps; bdot "
              f"{np.round(bdot, 6).tolist()} nm/ps; redos {sim.redos}; "
              f"{sim_rate_busy(sim)} on {card}")
        rows_out["cellpair_half_col_nglfnk"] = (
            "cellpair_half_col", c["cellpair_half_col"],
            sim_pair_check(sim, "(b)"))
        del sim

    # --- (c) STRAIN on the nc = 32 crystal, #5 -----------------------------
    with tempfile.TemporaryDirectory() as d:
        deck = eam_deck(d, EAM_BIG_NC, 10, a_lat=INT_A_LAT,
                        edit=box_edit(f"dudt=0 0 {STRAIN_U};"))
        sim, c, rows = cli(deck, d, STRAIN_STEPS)
        L0 = sim.sysdef.box.lengths.cpu().double().numpy()
        L1 = sim.ss.box.lengths.cpu().double().numpy()
        expect = math.exp(STRAIN_U * STRAIN_STEPS * sim.sysdef.cfg.dt
                          * U.TIME_TO_FS)
        zerr = abs(L1[2] / L0[2] / expect - 1.0)
        xyerr = float(np.abs(L1[:2] / L0[:2] - 1.0).max())
        e = sim.ss.energy
        pzz = float((e.virial[2, 2] + e.tion[2, 2]) / sim.ss.box.volume)
        pxx = float((e.virial[0, 0] + e.tion[0, 0]) / sim.ss.box.volume)
        gate(np.isfinite(rows).all(), "(c) finite rows")
        gate(zerr <= 1e-5, f"(c) Lz/Lz0 off exp(int u dt) by {zerr}")
        gate(xyerr <= 1e-6, f"(c) Lx, Ly moved by {xyerr}")
        gate(c["eam_rho_col"] >= STRAIN_STEPS
             and c["eam_force_col"] >= STRAIN_STEPS
             and not any(v for k, v in c.items()
                         if k not in ("eam_rho_col", "eam_force_col")),
             f"(c) launches {c}")
        phase("integrators", f"(c) STRAIN dudt=0 0 {STRAIN_U}/fs on nc="
              f"{EAM_BIG_NC} (a = {INT_A_LAT} A), {STRAIN_STEPS} steps: Lz/"
              f"Lz0 {L1[2] / L0[2]:.9f} vs exp(int u dt) {expect:.9f} (rel "
              f"{zerr:.3g}), Lx, Ly moved {xyerr:.3g}; Pzz {pzz / bar:.6g} "
              f"bar, Pxx {pxx / bar:.6g} bar at the end; #5 launched "
              f"{c['eam_rho_col']} / {c['eam_force_col']} times; T "
              f"{rows[-1, 5]:.2f} K; redos {sim.redos}; {sim_rate_busy(sim)} "
              f"on {card}")
        eam_rows("strain", c, sim_eam_check(sim, "(c)"))
        del sim

    # --- (d) SHEAR on the 131,072-atom LJ fluid, #2 -------------------------
    with tempfile.TemporaryDirectory() as d:
        deck = lj_deck(d, LJ_BIG_N, printrate=10)
        Lb = box_edge(d)
        regroup(d, shear_groups(Lb), lambda r: ["sh"] * len(r))
        sim, c, rows = cli(deck, d, SHEAR_STEPS)
        prof, ((vt, tt), (vb, tb)) = shear_profile(sim, Lb)
        gate(np.isfinite(rows).all(), "(d) finite rows")
        gate(vt > 0 > vb, f"(d) slice mean vy {vt}, {vb}")
        gate(c["cellpair_half_col"] >= SHEAR_STEPS and not any(
            v for k, v in c.items() if k != "cellpair_half_col"),
            f"(d) launches {c}")
        phase("integrators", f"(d) SHEAR lj_fluid {LJ_BIG_N} atoms, slices "
              f"at +-L/4 (L {Lb:.2f} A) L/4 wide, +-{SHEAR_V} A/fs in y, "
              f"{LJ_T:.0f} K, tau {SHEAR_TAU} ps, {SHEAR_STEPS} steps: "
              f"top slice vy {vt:.4g} A/fs at {tt:.2f} K, bottom {vb:.4g} "
              f"A/fs at {tb:.2f} K; vy by z bin "
              f"{[round(x, 6) for x in prof]}; mean T {rows[-1, 5]:.2f} K; "
              f"#2 launched {c['cellpair_half_col']} times; redos "
              f"{sim.redos}; {sim_rate_busy(sim)} on {card}")
        rows_out["cellpair_half_col_shear"] = (
            "cellpair_half_col", c["cellpair_half_col"],
            sim_pair_check(sim, "(d)"))
        del sim
    t_big = time.perf_counter() - t_phase

    # --- (e) small decks, card vs CPU -------------------------------------
    counters_zero()
    last = {}       # the last card run on #1 ("pair") and on #4 ("eam")
    for name, make_deck in (*group_decks(), *integrator_decks()):
        got, sim = small_run(DEVICE, make_deck, INT_SMALL_STEPS)
        ref, _ = small_run("cpu", make_deck, INT_SMALL_STEPS)
        term = sim.force_fn.terms[0]
        if sim.engine == "kernel" and term.G == 1:
            last["eam" if hasattr(term, "tables") else "pair"] = (sim, name)
        del sim, term
        (eng1, e1, k1, r1, h1, z1, b1), (eng0, e0, k0, r0, h0, z0, b0) = \
            got, ref
        s = (r1 - r0) @ np.linalg.inv(h0).T
        dr = float(np.abs((s - np.round(s)) @ h0.T).max())
        ok = (eng1 == eng0 and math.isclose(e1, e0, rel_tol=1e-4,
                                            abs_tol=1e-2)
              and math.isclose(k1, k0, rel_tol=1e-3, abs_tol=1e-2)
              and dr < 1e-3 and np.allclose(h1, h0, rtol=1e-5)
              and math.isclose(z1, z0, rel_tol=1e-3, abs_tol=1e-3)
              and np.allclose(b1, b0, rtol=1e-3, atol=1e-5))
        gate(ok, f"(e) {name}")
        phase("agree", f"(e) {name} ({eng1}), {INT_SMALL_STEPS} steps, card "
              f"vs CPU: eion {e1:.8g} vs {e0:.8g}, rk {k1:.6g} vs {k0:.6g}, "
              f"max |dr| {dr:.3g} nm, h {np.abs(h1 - h0).max():.3g}, zeta "
              f"{z1:.6g} vs {z0:.6g}, bdot {np.abs(b1 - b0).max():.3g}")
    c = all_counters()
    gate(c["cellpair_half"] >= INT_SMALL_STEPS
         and c["eam_rho"] >= INT_SMALL_STEPS and not any(
             v for k, v in c.items()
             if k not in ("cellpair_half", "eam_rho", "eam_force")),
         f"(e) small decks' launches {c}")
    phase("integrators", f"(e) the card runs launched {c}")
    rows_out["cellpair_half_small"] = (
        "cellpair_half", c["cellpair_half"],
        sim_pair_check(last["pair"][0], f"(e) {last['pair'][1]}"))
    eam_rows("small", c, sim_eam_check(last["eam"][0],
                                       f"(e) {last['eam'][1]}"), col=False)
    del last
    # a restart of zeta (NPTGLF) and bdot (NGLFNK): 10 steps, a
    # checkpoint, 10 more from it, against 20 in one run
    for name, edit in (("NPTGLF zeta", nptglf_edit(SMALL_LJ_GAMMA, 500.0)),
                       ("NGLFNK bdot", nglfnk_edit(W=200.0, P=2000.0))):
        with tempfile.TemporaryDirectory() as d, \
                tempfile.TemporaryDirectory() as d2:
            lj_deck(d, INT_SMALL_N, printrate=10, edit=edit)
            lj_deck(d2, INT_SMALL_N, printrate=10, edit=edit)
            one = Simulation(*load(d2), run_dir=d2, device=dev)
            one.run(INT_SMALL_STEPS, print_fn=quiet)
            half = Simulation(*load(d), run_dir=d, device=dev)
            half.run(INT_SMALL_STEPS // 2, print_fn=quiet)
            write_checkpoint(half, d)
            back = Simulation(*load(d, restart=os.path.join(d, "restart")),
                              run_dir=d, device=dev)
            zb = (float(back.ss.zeta), back.ss.bdot.cpu().double().numpy())
            za = (float(half.ss.zeta), half.ss.bdot.cpu().double().numpy())
            back.run(INT_SMALL_STEPS // 2, print_fn=quiet)
        ok_state = (math.isclose(zb[0], za[0], rel_tol=1e-6, abs_tol=1e-9)
                    and np.allclose(zb[1], za[1], rtol=1e-6, atol=1e-9))
        e_b, e_1 = float(back.ss.energy.eion), float(one.ss.energy.eion)
        ok_run = math.isclose(e_b, e_1, rel_tol=1e-4, abs_tol=1e-2)
        gate(ok_state and ok_run, f"(e) restart of {name}")
        phase("agree", f"(e) restart of {name} after {INT_SMALL_STEPS // 2} "
              f"steps: zeta {za[0]:.9g} -> {zb[0]:.9g}, bdot "
              f"{np.round(za[1], 9).tolist()} -> "
              f"{np.round(zb[1], 9).tolist()}; {INT_SMALL_STEPS} steps "
              f"with the restart eion {e_b:.8g} vs in one run {e_1:.8g}")
    # NVEGLF with the nc = 12 deck's LANGEVIN group == NGLF with FREE, #4
    energies = {}
    for name, free, edit in (
            ("NVEGLF", False,
             lambda t: t.replace("type=NGLF;", "type=NVEGLF;")),
            ("NGLF FREE", True, None)):
        with tempfile.TemporaryDirectory() as d:
            eam_deck(d, EAM_NC, 1, free=free, edit=edit)
            sim = Simulation(*load(d), run_dir=d, device=dev)
            lines = []
            counters_zero()
            sim.run(NVE_CHECK_STEPS, print_fn=lines.append)
            c = all_counters()
            gate(c["eam_rho"] >= NVE_CHECK_STEPS and not any(
                v for k, v in c.items() if k not in ("eam_rho", "eam_force")),
                f"(e) {name} launches {c}")
            energies[name] = np.array([[float(x) for x in ln.split()[2:5]]
                                       for ln in lines])
            if name == "NVEGLF":
                eam_rows("nveglf", c, sim_eam_check(sim, "(e) NVEGLF"),
                         col=False)
            del sim
    a, b = energies["NVEGLF"], energies["NGLF FREE"]
    scale = float(np.abs(b).max())
    err = float(np.abs(a - b).max()) / scale
    gate(a.shape == b.shape == (NVE_CHECK_STEPS, 3) and err <= 1e-6,
         f"(e) NVEGLF vs NGLF FREE {err}")
    phase("integrators", f"(e) NVEGLF with the nc={EAM_NC} deck's LANGEVIN "
          f"group vs NGLF with a FREE group, {NVE_CHECK_STEPS} steps on #4 "
          f"({c['eam_rho']} / {c['eam_force']} launches a run): "
          f"max |d E| {err:.3g} of the energy scale {scale:.6g} eV/atom "
          f"(Etot, Ekin, Epot every step)")
    phase("integrators", f"phase 20: {time.perf_counter() - t_phase:.1f} s "
          f"((a)-(d) {t_big:.1f} s)")
    assert not failed, f"phase 20 gates missed: {failed}"
    return rows_out


def bilayer_stage1(d_eq, d, nx=BILAYER_NX):
    """Phase 6's first stage, as bench.py runs it: the full bilayer's
    deck (nx = BILAYER_NX; phase 24 stages nx = REBUILD_NX) at EQ_DT in
    d_eq through the CLI for EQ_STEPS steps, checkpointed into d beside
    the 20 fs deck, so the restart's relative files= path resolves
    against d.  Returns (the 20 fs deck, the box lengths nm)."""
    from ddcmd_tpu_torch.io.restart import write_checkpoint

    deck_eq = bilayer_deck(d_eq, nx, EQ_DT, 200)
    deck = bilayer_deck(d, nx, 20.0, 10)
    t0 = time.perf_counter()
    sim_eq = cli_run(["simulate", "-o", deck_eq, "-n", str(EQ_STEPS),
                      "--run-dir", d_eq])
    eq_s = time.perf_counter() - t0
    assert sim_eq.ss.loop == EQ_STEPS
    write_checkpoint(sim_eq, d)
    L_eq = sim_eq.ss.box.lengths.cpu().numpy().astype(np.float64)
    phase("bilayer", f"stage 1: {sim_eq.sysdef.state.n_local} beads, "
          f"{EQ_STEPS} steps at dt={EQ_DT} fs in {eq_s:.1f} s (set-up "
          f"included), box {L_eq.round(4).tolist()} nm, cells "
          f"{sim_eq.grid.ncells} cap {sim_eq.grid.cap}, redos "
          f"{sim_eq.redos}; checkpoint written")
    return deck, L_eq


# --- phase 21 (item 23): the run-time layer and the masters ---------------
# (a): the command file on the full bilayer from phase 6's 20 fs restart,
# written at these loops past the restart; Teq 323 -> MASTERS_T K at +800
MASTERS_STEPS, MASTERS_PRINTRATE, MASTERS_T = 3000, 100, 340.0
MASTERS_CMDS = {
    400: "profile\n",
    800: "".join(f"{g} GROUP {{ type=LANGEVIN; Teq={MASTERS_T}K; tau=1.0ps; "
                 "}\n" for g in ("lipid", "water")),
    2400: "checkpoint exit\n"}
MASTERS_EXIT = 2400
# the commands are read, and the group files written, at dispatch ends:
# dispatches of one printrate, on a rebuild cadence that divides it (the
# bilayer deck's updateRate 12 would end them at 96, 192, ...)
MASTERS_DISPATCH, MASTERS_UPDATE_RATE = 100, 20
MASTERS_TAIL = 400          # steps the T gates read, before the exit
MASTERS_SMALL_NX = 8        # the per-group pe sums, card vs CPU
# (b): the rollback ladder on the water box; the one-shot NaN at the end
# of the dispatch that ends at ROLLBACK_AT, snapshots every 200 steps
ROLLBACK_STEPS, ROLLBACK_AT, ROLLBACK_SNAP = 1000, 400, 200
# (c): NGLFTEST's substeps; f32 positions round at |r| 2^-24
NGLFTEST_SUB = 4
F32_EPS = 2.0 ** -24
# (d): the eightFold deck's run through the CLI
EIGHTFOLD_STEPS = 200


def sim_pair_check(sim, what, saved=None):
    """The pair kernel of sim's main path (#2 at G > 1, else #1) against
    its plain version on sim's current records (or on `saved`, the
    sim_kernel_inputs and G of an earlier plan), with its bound:
    compare's (max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    from ddcmd_tpu_torch.ops import cellpair_half as ch

    (kernel, args, kw, hg), G = saved or (sim_kernel_inputs(sim),
                                          sim.force_fn.terms[0].G)
    return compare(f"pair kernel on {what}'s last records (cells "
                   f"{hg.ncells}, G={G})", kernel,
                   ch.cellpair_half_col_plain if G > 1
                   else ch.cellpair_half_plain, args, kw, with_bound=True)


def sim_eam_check(sim, what):
    """#5 (#4 at G = 1) against its plain version on sim's last records,
    with its bound: eam_compare's {"rho": ..., "force": ...}."""
    from ddcmd_tpu_torch.ops import eam_half as eh

    plains = {eh.eam_rho_half_col: eh.eam_rho_half_col_plain,
              eh.eam_force_half_col: eh.eam_force_half_col_plain,
              eh.eam_rho_half: eh.eam_rho_half_plain,
              eh.eam_force_half: eh.eam_force_half_plain}
    ss, perm, ov = sim._build_nbr(sim.ss)
    assert not bool(ov), "overflow packing the comparison case"
    term = sim.force_fn.terms[0]
    rho_k, force_k, slots, args, kw = term.kernel_inputs(
        ss.state, ss.box, perm)
    return eam_compare(
        f"EAM kernels on {what}'s last records (cells "
        f"{term.grid.ncells}, G={term.G})", (rho_k, force_k),
        (plains[rho_k], plains[force_k]), slots, args, kw, term.tables,
        with_bound=True)


def sim_rate_busy(sim):
    """steps/s over the last TAIL accepted steps, and the busy share and
    CUDA kernels a step of PROFILE_STEPS more steps under the profiler."""
    rate, tail = tail_rate(sim)
    busy, kps = window_stats(lambda: sim.run(
        PROFILE_STEPS, print_fn=lambda line: None), PROFILE_STEPS + 1)
    return (f"{rate:.2f} steps/s over the last {tail} steps, busy "
            f"{100 * busy:.1f}% over {PROFILE_STEPS} profiled steps "
            f"({kps:.1f} CUDA kernels a step)")


def lipid_or_water(species):
    return ["water" if s == "WxW" else "lipid" for s in species]


def two_group_bilayer(d, atoms=None, printrate=MASTERS_PRINTRATE,
                      graphs=True):
    """The bilayer deck in d split into LANGEVIN groups lipid and water at
    BILAYER_T (the species decide), printrate `printrate`, with a
    PRINTINFO that sets printGraphs=1."""
    lang = f"type=LANGEVIN; Teq={BILAYER_T}K; tau=1.0ps;"
    p = regroup(d, {"lipid": lang, "water": lang}, lipid_or_water,
                printrate=printrate, atoms=atoms, by_species=True)
    if graphs:
        with open(p) as f:
            text = f.read()
        with open(p, "w") as f:
            f.write(text.replace("type=MD;", "type=MD; printinfo=pi;", 1)
                    + "pi PRINTINFO { printGraphs=1; }\n")
    return p


def group_rows(run_dir, name):
    """group_<name>.data as an array: loop, members, T, KE and PE a member."""
    with open(os.path.join(run_dir, f"group_{name}.data")) as f:
        return np.array([ln.split() for ln in f], dtype=np.float64)


def masters_bilayer_part(card, dev, d, counters_zero, all_counters,
                         failed):
    """Phase 21 (a): the command file on the full bilayer (#2), from the
    20 fs restart in d (phase 6's), split into two LANGEVIN groups at
    BILAYER_T with printrate MASTERS_PRINTRATE and printGraphs=1; a
    Simulation.run(MASTERS_STEPS) whose print_fn writes MASTERS_CMDS into
    ddcMD_CMDS; then the per-group pe sums of the two-group nx =
    MASTERS_SMALL_NX bilayer's first energy, card vs CPU.  Gates go into
    `failed`.  Returns its kernels JSON row ("cellpair_half_col",
    launches, #2 against its plain version on the run's last records)."""
    from ddcmd_tpu_torch.io.restart import write_checkpoint
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.simulate import Simulation
    from ddcmd_tpu_torch.utils.profile import PROFILE

    def gate(ok, what):
        if not ok:
            failed.append(f"(a) {what}")

    t0 = time.perf_counter()
    restart = os.path.join(d, "restart")
    snap = os.path.dirname(os.path.realpath(restart))
    deck = two_group_bilayer(d, atoms=os.path.join(snap, "atoms#000000"))
    with open(deck) as f:
        text = f.read()
    with open(deck, "w") as f:
        f.write(text.replace("updateRate=12;",
                             f"updateRate={MASTERS_UPDATE_RATE};"))
    run_dir = os.path.join(d, "masters")
    os.makedirs(run_dir)
    sim = Simulation(*load(d, restart), run_dir=run_dir, device=dev)
    start = sim.ss.loop
    rows = []

    def print_fn(line):
        rows.append([float(x) for x in line.split()])
        text = MASTERS_CMDS.get(int(line.split()[0]) - start)
        if text:
            with open(os.path.join(run_dir, "ddcMD_CMDS"), "w") as f:
                f.write(text)

    counters_zero()
    sim.run(MASTERS_STEPS, print_fn=print_fn,
            on_checkpoint=lambda s: write_checkpoint(s, run_dir),
            max_steps_per_dispatch=MASTERS_DISPATCH)
    c = all_counters()
    end = sim.ss.loop
    rows = np.array(rows)
    tail = rows[rows[:, 0] > end - MASTERS_TAIL]
    t_all = float(tail[:, 5].mean())
    gate(end == start + MASTERS_EXIT, f"stopped at loop {end}")
    gate(not os.path.exists(os.path.join(run_dir, "ddcMD_CMDS")),
         "ddcMD_CMDS left behind")
    gate(abs(t_all - MASTERS_T) <= TEMP_TOL, f"mean T {t_all}")
    # a group file's T counts 3 degrees of freedom a bead (as the JAX
    # package's); the lipids' RATTLE constraints take n_constraints of
    # theirs, so their file reads T (3 N - n_c) / (3 N)
    n_c = sim.sysdef.n_constraints
    groups = {}
    for g in ("lipid", "water"):
        gr = group_rows(run_dir, g)
        groups[g] = float(gr[gr[:, 0] > end - MASTERS_TAIL][:, 2].mean())
        dof = 3.0 * gr[0, 1]
        scale = dof / (dof - n_c) if g == "lipid" else 1.0
        gate(gr[:, 0].tolist() == list(range(
            start + MASTERS_PRINTRATE, end + 1, MASTERS_PRINTRATE)),
            f"group_{g}.data rows {gr[:, 0].tolist()}")
        gate(abs(groups[g] * scale - MASTERS_T) <= TEMP_TOL,
             f"{g} mean T {groups[g]} (x {scale})")
    with open(os.path.join(run_dir, "graphs")) as f:
        graphs = f.read().splitlines()
    g = sim.grid
    slots = g.ncell * g.n_stencil * g.cap * g.cap
    gate(len(graphs) == len(sim.dispatch_log)
         and graphs[-1].split()[-2] == f"pair_slots={slots}",
         f"graphs: {len(graphs)} lines for {len(sim.dispatch_log)} "
         f"dispatches, last {graphs[-1:]}")
    phases = {k: PROFILE.timers[k].total / PROFILE.timers[k].calls
              for k in ("phase.nbr_rebuild", "phase.force",
                        "phase.group_kick", "phase.step_fused")
              if k in PROFILE.timers}
    gate(len(phases) == 4 and min(phases.values()) > 0,
         f"profile phases {phases}")
    with open(os.path.join(run_dir, f"snapshot.{end:06d}", "profile")) as f:
        gate("phase.step_fused" in f.read(), "the snapshot's profile table")
    db, _ = load(d, os.path.join(run_dir, "restart"))
    back = Simulation(db, run_dir, run_dir=run_dir, device=dev)
    dr = float((back.ss.state.r - sim.ss.state.r).abs().max())
    gate(back.ss.loop == end and dr < 1e-5, f"checkpoint at {back.ss.loop}, "
         f"max |dr| {dr}")
    del back
    gate(c["cellpair_half_col"] >= MASTERS_EXIT and not any(
        v for k, v in c.items() if k != "cellpair_half_col"),
        f"launches {c}")
    busy = sim_rate_busy(sim)
    phase("masters", f"(a) the command file on the bilayer ("
          f"{sim.sysdef.state.n_local} beads, lipid and water LANGEVIN at "
          f"{BILAYER_T:.0f} K, printrate {MASTERS_PRINTRATE}, printGraphs=1) "
          f"from loop {start}: profile at +400, Teq {MASTERS_T:.0f} K at "
          f"+800, checkpoint exit at +{MASTERS_EXIT}; stopped at loop {end}; "
          f"mean T over the last {MASTERS_TAIL} steps {t_all:.2f} K, lipid "
          f"{groups['lipid']:.2f} K (its file's; {n_c} constraints), water "
          f"{groups['water']:.2f} K; phases "
          f"{ {k[6:]: round(1e3 * v, 3) for k, v in phases.items()} } ms a "
          f"call; graphs {len(graphs)} lines, last '{graphs[-1].strip()}'; "
          f"#2 launched {c['cellpair_half_col']} times (G="
          f"{sim.force_fn.terms[0].G}); redos {sim.redos}; {busy} on {card}")
    row = ("cellpair_half_col", c["cellpair_half_col"],
           sim_pair_check(sim, "(a)"))
    del sim
    # the per-group pe sums of one state, card vs CPU
    sums = {}
    for where in (dev, "cpu"):
        with tempfile.TemporaryDirectory() as ds:
            bilayer_deck(ds, MASTERS_SMALL_NX, 20.0, MASTERS_PRINTRATE)
            two_group_bilayer(ds, graphs=False)
            s = Simulation(*load(ds), run_dir=ds, device=where)
            s.first_energy()
            s._emit_group_files()
            sums[str(where)] = (
                [float(np.prod(group_rows(ds, g)[0, [1, 4]]))
                 for g in ("lipid", "water")], float(s.ss.energy.eion))
            del s
    (pc, ec), (pp, ep) = sums[str(dev)], sums["cpu"]
    ok = all(abs(a - b) <= 1e-4 * abs(b) + 1e-2 for a, b in zip(pc, pp))
    gate(ok and abs(sum(pc) - ec) <= 1e-4 * abs(ec),
         f"group pe sums {pc} vs {pp}")
    phase("masters", f"(a) nx={MASTERS_SMALL_NX} two-group bilayer, first "
          f"energy: group pe sums (lipid, water) {[round(x, 4) for x in pc]}"
          f" on the card vs {[round(x, 4) for x in pp]} on the CPU, "
          f"eion {ec:.6f} vs {ep:.6f}; (a) took "
          f"{time.perf_counter() - t0:.1f} s")
    return row


def nan_once(sim, at_loop):
    """Wrap sim's step so that the first step that ends at `at_loop`
    returns bead 0's velocity NaN (its row's kinetic energy too)."""
    from ddcmd_tpu_torch.core.energy import kinetic_terms

    orig = sim.step_fn
    fired = []

    def step(ss, *args, **kw):
        out = orig(ss, *args, **kw)
        if out.loop == at_loop and not fired:
            fired.append(True)
            v = out.state.v.clone()
            v[0, 0] = float("nan")
            rk, tion = kinetic_terms(v, out.state.mass, out.state.fmask)
            out = out.replace(state=out.state.replace(v=v),
                              energy=dataclasses.replace(
                                  out.energy, rk=rk, tion=tion))
        return out

    sim.step_fn = step
    return fired


def record_noise(sim):
    """[(step, attempt, draw)] of every kick draw sim makes, in order."""
    out = []
    orig = sim._noise

    def rec(step, attempt=0):
        noise, draws = orig(step, attempt)
        out.append((step, attempt, noise.clone()))
        return noise, draws

    sim._noise = rec
    return out


def masters_phase(card, dev, counters_zero, all_counters, failed,
                  n_water=6173):
    """Phase 21 (b)-(d): (b) the rollback ladder on the water box (#1):
    ROLLBACK_STEPS steps with a one-shot NaN at loop ROLLBACK_AT and
    snapshots every ROLLBACK_SNAP steps, then a persistent fault (two
    beads on one site) after a checkpoint; (c) NEXTFILE over (b)'s
    snapshots at 200, 400 and 600 and NGLFTEST at the deck's 20 fs,
    subDivide NGLFTEST_SUB; (d) the masters through the CLI: thermalize,
    readWrite, eightFold and a EIGHTFOLD_STEPS-step run of the 8n deck,
    testForce --f64, testPressure, integrationTest.  Gates go into
    `failed`.  Returns {kernels JSON row: (entry, launches, comparison)}:
    #1 on (b)'s records with (b) and (c)'s launches, and the eightFold
    deck's kernel on its records with that run's launches."""
    from ddcmd_tpu_torch.core.groups import kick_noise
    from ddcmd_tpu_torch.io.restart import write_checkpoint
    from ddcmd_tpu_torch.models import lj_fluid, load
    from ddcmd_tpu_torch.objects import units as U
    from ddcmd_tpu_torch.run.simulate import Simulation
    from ddcmd_tpu_torch.run.testpressure import testpressure_master

    t_phase = time.perf_counter()
    quiet = lambda line: None                                  # noqa: E731
    rows_out = {}

    def gate(ok, what):
        if not ok:
            failed.append(what)

    def edit(d, fn):
        p = os.path.join(d, "object.data")
        with open(p) as f:
            text = f.read()
        with open(p, "w") as f:
            f.write(fn(text))
        return p

    keep = tempfile.mkdtemp()
    try:
        # --- (b) the rollback ladder on the water box, #1 ------------------
        d = os.path.join(keep, "b")
        os.makedirs(d)
        water_deck(d, n_water, printrate=10)
        edit(d, lambda t: t.replace("type=MD;", "type=MD; snapshotrate="
                                    f"{ROLLBACK_SNAP};", 1))
        sim = Simulation(*load(d), run_dir=d, device=dev)
        n = sim.sysdef.state.n_local
        fired = nan_once(sim, ROLLBACK_AT)
        draws = record_noise(sim)
        lines = []
        counters_zero()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sim.run(ROLLBACK_STEPS, print_fn=lines.append,
                    on_checkpoint=lambda s: None)
        c_b = all_counters()
        nan_warn = [str(w.message) for w in caught
                    if "non-finite" in str(w.message)]
        gate(fired and sim.ss.loop == ROLLBACK_STEPS
             and sim.redos["nan"] == 1 and sim.redos["overflow"] == 0,
             f"(b) one-shot NaN: loop {sim.ss.loop}, redos {sim.redos}")
        gate(len(nan_warn) == 1 and nan_warn[0].startswith(
            f"non-finite energy at step {ROLLBACK_AT} (chunk "
            f"{ROLLBACK_AT - ROLLBACK_SNAP}+{ROLLBACK_SNAP}"),
            f"(b) warnings {nan_warn}")
        by_key = {(s, a): x for s, a, x in draws}
        retry = [s for s, a in by_key if a == 1]
        gate(len(retry) == ROLLBACK_SNAP and not any(
            torch.equal(by_key[(s, 0)], by_key[(s, 1)]) for s in retry),
            f"(b) the retry's draws ({len(retry)} steps) equal the first "
            "attempt's")
        gen = torch.Generator(device=dev)
        shape = (2, sim.ss.state.n_pad, 3)
        after = [(s, a, x) for s, a, x in draws if s >= ROLLBACK_AT]
        gate(all(a == 0 and torch.equal(x, kick_noise(
            gen, sim.sysdef.random_seed, s, 0, shape)) for s, a, x in after),
            "(b) the draws after the retry are not kick_noise at attempt 0")
        del sim._noise, draws, by_key       # stop recording
        printed = {int(ln.split()[0]): float(ln.split()[4]) for ln in lines}
        busy = sim_rate_busy(sim)
        phase("masters", f"(b) rollback on the water box ({n} beads, "
              f"{ROLLBACK_STEPS} steps): NaN injected at loop {ROLLBACK_AT}; "
              f"'{nan_warn[0] if nan_warn else None}'; redos {sim.redos}; "
              f"retry draws differ on {len(retry)} steps, later draws "
              f"equal kick_noise at attempt 0 on {len(after)} steps; #1 "
              f"launched {c_b['cellpair_half']} times; {busy} on {card}")
        rows_b = sim_pair_check(sim, "(b)")
        # the persistent fault: after a checkpoint, two beads on one site
        write_checkpoint(sim, d)
        link = os.readlink(os.path.join(d, "restart"))
        sim.run(ROLLBACK_SNAP // 2, print_fn=quiet,
                on_checkpoint=lambda s: None)
        at = sim.ss.loop
        r = sim.ss.state.r.clone()
        r[1] = r[0]
        sim.ss = sim.ss.replace(state=sim.ss.state.replace(r=r))
        raised = None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                sim.run(ROLLBACK_SNAP // 2, print_fn=quiet)
            except FloatingPointError as err:
                raised = str(err)
        kill_snap = os.path.join(d, f"snapshot.{at:06d}", "restart")
        gate(raised is not None and "kill switch" in raised
             and sim.redos["nan"] == 4 and os.path.exists(kill_snap)
             and os.readlink(os.path.join(d, "restart")) == link,
             f"(b) persistent fault: {raised}, redos {sim.redos}")
        phase("masters", f"(b) persistent fault at loop {at}: "
              f"FloatingPointError '{raised}' after 3 retries, kill-switch "
              f"snapshot {os.path.exists(kill_snap)}, restart link still "
              f"{os.readlink(os.path.join(d, 'restart'))}")
        del sim

        # --- (c) NEXTFILE over (b)'s snapshots, NGLFTEST, #1 ---------------
        counters_zero()
        dn = os.path.join(keep, "c")
        os.makedirs(dn)
        water_deck(dn, n_water, printrate=10)
        loops = tuple(ROLLBACK_SNAP * k for k in (1, 2, 3))
        files = " ".join(os.path.join(d, f"snapshot.{lp:06d}", "atoms#")
                         for lp in loops)
        edit(dn, lambda t: t.replace("type=NGLF;",
                                     f"type=NEXTFILE; files={files};"))
        sim = Simulation(*load(dn), run_dir=dn, device=dev)
        energies = []
        orig = sim.first_energy

        def first_energy():
            ss = orig()
            energies.append(float(ss.energy.eion))
            return ss

        sim.first_energy = first_energy
        t0 = time.perf_counter()
        sim.run(print_fn=quiet)
        nf_s = time.perf_counter() - t0
        c_e = sim.printinfo.c_energy
        errs = [abs(e * c_e / n / printed[lp] - 1.0)
                for e, lp in zip(energies, loops)]
        gate(len(energies) == 3 and max(errs) <= 2e-5,
             f"(c) NEXTFILE eion rel errors {errs}")
        phase("masters", f"(c) NEXTFILE over (b)'s snapshots {loops}: Epot "
              f"{[round(e * c_e / n, 8) for e in energies]} vs printed "
              f"{[printed[lp] for lp in loops]} eV/bead (rel "
              f"{max(errs):.3g}), {nf_s / 3 * 1e3:.1f} ms a file")
        del sim
        dt_dir = os.path.join(keep, "t")
        os.makedirs(dt_dir)
        water_deck(dt_dir, n_water, printrate=10)
        edit(dt_dir, lambda t: t.replace(
            "type=NGLF;", f"type=NGLFTEST; subDivide={NGLFTEST_SUB};"))
        sim = Simulation(*load(dt_dir), run_dir=dt_dir, device=dev)
        out = []
        busy, kpe = window_stats(lambda: sim.run(print_fn=out.append),
                                 1 + 1 + NGLFTEST_SUB + 32)
        c_c = all_counters()
        meds = [float(ln.split("median=")[1].split()[0]) for ln in out]
        # f32 position rounding, |r| 2^-24 at the median |r| (the
        # positions are origin-centred); the multi-step error at dt/4 is
        # about one floor (2.98e-7 nm in f64 on the CPU), so only the one
        # step's truncation error stands 10x above it
        floor = float(sim.ss.state.r[:n].norm(dim=1).median()) * F32_EPS
        gate(len(meds) == 2 and meds[1] <= meds[0]
             and meds[0] >= 10.0 * floor and all(os.path.exists(
                 os.path.join(dt_dir, f)) for f in ("SingleStep.dist",
                                                    "MultiStep.dist")),
             f"(c) NGLFTEST medians {meds}, f32 floor {floor}")
        gate(c_c["cellpair_half"] >= 3 + 1 + NGLFTEST_SUB + 32 and not any(
            v for k, v in c_c.items() if k != "cellpair_half"),
            f"(c) launches {c_c}")
        phase("masters", f"(c) NGLFTEST dt 20 fs, subDivide {NGLFTEST_SUB}, "
              f"reference 32 substeps: {'; '.join(out)}; f32 floor "
              f"median |r| 2^-24 = {floor:.3g} nm: single "
              f"{meds[0] / floor:.1f}x, multi {meds[1] / floor:.1f}x; busy "
              f"{100 * busy:.1f}%, {kpe:.1f} CUDA kernels an evaluation; "
              f"(c) launched #1 {c_c['cellpair_half']} times")
        rows_out["cellpair_half_masters"] = (
            "cellpair_half", c_b["cellpair_half"] + c_c["cellpair_half"],
            rows_b)
        del sim

        # --- (d) the masters through the CLI ------------------------------
        dd = os.path.join(keep, "d")
        os.makedirs(dd)
        deck = water_deck(dd, n_water, printrate=10)
        with open(deck, "a") as f:
            f.write("it INTEGRATIONTEST { testPotentialPotential=martini "
                    "martini; }\n")

        def cli(master, *extra, where=None, run_dir=None):
            rd = run_dir or os.path.join(keep, f"{master}_{where or 'card'}")
            return cli_run([master, "-o", deck, "--run-dir", rd, *extra],
                           where), rd

        temps = []
        for where in (None, "cpu"):
            s, _ = cli("thermalize", where=where)
            v = s.ss.state.v[:n].cpu().double().numpy()
            m = s.ss.state.mass[:n].cpu().double().numpy()
            temps.append(float((m[:, None] * v * v).sum() / (3 * n * U.kB)))
        gate(abs(temps[0] / temps[1] - 1.0) <= 1e-6,
             f"(d) thermalize T {temps}")
        s, rd = cli("readWrite")
        db, _ = load(dd, os.path.join(rd, "restart"))
        back = Simulation(db, rd, run_dir=rd, device=dev)
        same = bool(torch.equal(back.ss.state.r, s.ss.state.r))
        gate(same, "(d) readWrite positions through the codec")
        s.first_energy()
        e1 = float(s.ss.energy.eion)
        del back, s
        cli("eightFold", run_dir=dd)
        restart8 = os.path.join(dd, "snapshot.8fold", "restart")
        s8 = Simulation(*load(dd, restart8), run_dir=dd, device=dev)
        s8.first_energy()
        e8 = float(s8.ss.energy.eion)
        del s8
        run8 = os.path.join(keep, "run8")
        counters_zero()
        sim8, _ = cli("simulate", "-r", restart8, "-n", str(EIGHTFOLD_STEPS),
                      run_dir=run8)
        c8 = all_counters()
        G8 = sim8.force_fn.terms[0].G
        k8 = "cellpair_half_col" if G8 > 1 else "cellpair_half"
        rows8 = read_rows(run8)
        gate(abs(e8 / (8 * e1) - 1.0) <= 2e-5 and sim8.ss.loop ==
             EIGHTFOLD_STEPS and np.isfinite(rows8).all()
             and c8[k8] >= EIGHTFOLD_STEPS,
             f"(d) eightFold: first energy {e8} vs 8 x {e1}, {c8}")
        phase("masters", f"(d) thermalize T {temps[0]:.6f} K on the card, "
              f"{temps[1]:.6f} K on the CPU; readWrite positions bit-equal "
              f"{same}; eightFold {8 * n} beads: first energy {e8:.6f} vs 8 "
              f"x {e1:.6f} (rel {abs(e8 / (8 * e1) - 1):.3g}), "
              f"{EIGHTFOLD_STEPS} steps through the CLI on "
              f"{'#2' if G8 > 1 else '#1'} (cells {sim8.grid.ncells} G={G8}, "
              f"{c8[k8]} launches), T {rows8[-1, 5]:.2f} K, "
              f"{tail_rate(sim8, EIGHTFOLD_STEPS // 2)[0]:.2f} steps/s")
        rows_out[f"{k8}_eightfold"] = (k8, c8[k8], sim_pair_check(
            sim8, "(d) eightFold"))
        del sim8
        (worst, _), _ = cli("testForce", "--f64")
        gate(worst < 5e-3, f"(d) testForce worst {worst}")
        dl = os.path.join(keep, "lj")
        os.makedirs(dl)
        lj_fluid(dl, n=500)
        res = testpressure_master(*load(dl), device=dev, delta0=1e-2,
                                  n_halvings=9, out_dir=dl, verbose=False)
        lj_best = [min(r[2] for r in rows) / abs(p)
                   for _, p, rows in res["atomic"]]
        gate(max(lj_best) < 1e-6, f"(d) testPressure lj best {lj_best}")
        res_w = testpressure_master(*load(dd), device=dev, delta0=1e-2,
                                    n_halvings=9, out_dir=dd,
                                    check_slope=False, verbose=False)
        w_best = {k: [min(r[2] for r in rows) / abs(p)
                      for _, p, rows in res_w[k]]
                  for k in ("atomic", "molecular") if res_w[k] is not None}
        w_text = {k: [float(f"{x:.3g}") for x in v]
                  for k, v in w_best.items()}
        (_, it), _ = cli("integrationTest")
        gate(it == [("martini", "martini", 0.0)], f"(d) integrationTest {it}")
        phase("masters", f"(d) testForce --f64 worst rel err {worst:.3g}; "
              f"testPressure lj_fluid 500 (delta0 1e-2, 9 halvings): slope "
              f"check passed, best err / |P| by axis "
              f"{[float(f'{x:.3g}') for x in lj_best]}; water box "
              f"(check_slope=False) best err / |P| "
              f"{w_text}; "
              f"integrationTest martini vs martini max rel err {it[0][2]}; "
              f"phase 21 (b)-(d) {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    return rows_out


# --- phase 22 (item 24a): transforms ---------------------------------------
# the water box with SIMULATE transform= REPLICATE 2x2x2 at TRANSFORM_AT:
# a run of TRANSFORM_STEPS ends before the rate's second multiple, its
# temperature read over the last TRANSFORM_TAIL steps; the replica's first
# energy against 8x the energy before it
TRANSFORM_AT, TRANSFORM_STEPS, TRANSFORM_TAIL = 200, 390, 100
TRANSFORM_E_REL = 1e-5
WATER_T = 310.0


def transforms_phase(card, dev, counters_zero, all_counters, failed,
                     n_water=6173):
    """Phase 22 (ROADMAP item 24a): (a) the water box (n_water beads, #1)
    with transform= REPLICATE nx = ny = nz = 2 at rate TRANSFORM_AT,
    TRANSFORM_STEPS steps through Simulation.run: at loop TRANSFORM_AT the
    same Simulation re-plans the 8 n_water beads past the 256-cell gate
    and goes on on the column kernel #2; (b) SELECTSUBSET zmin=0 on the
    replica; (c) the transform master through the CLI (THERMALIZE,
    REPLICATE, SETVELOCITY vcm=0) into a checkpoint.  Gates go into
    `failed`.  Returns {kernels JSON row: (entry, launches, comparison)}:
    #1 on the records just before the replica and #2 on the run's last
    records, each with the run's launches."""
    from ddcmd_tpu_torch.io.collection import read_collection
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.run.simulate import Simulation

    t_phase = time.perf_counter()

    def gate(ok, what):
        if not ok:
            failed.append(f"phase 22 {what}")

    def rate(log):
        return sum(k for k, _ in log) / max(sum(t for _, t in log), 1e-9)

    keep = tempfile.mkdtemp()
    try:
        # --- (a) REPLICATE at its rate: #1, then #2 ------------------------
        d = os.path.join(keep, "a")
        os.makedirs(d)
        edit_deck(water_deck(d, n_water, printrate=10), transforms_edit(
            {"rep": "type=REPLICATE; nx=2; ny=2; nz=2;"}, TRANSFORM_AT))
        sim = Simulation(*load(d), run_dir=d, device=dev)
        n0 = sim.sysdef.state.n_local
        seen = {"calls": 0}
        apply = sim.apply_transform

        def spy(tobj):
            seen["calls"] += 1
            if seen["calls"] > 1:
                return apply(tobj)
            # what the run holds just before the replica: its energy,
            # plan, launches and dispatches, and #1's inputs there
            seen.update(loop=sim.ss.loop, e0=float(sim.ss.energy.eion),
                        cells0=sim.grid.ncells, c0=all_counters(),
                        disp=len(sim.dispatch_log),
                        saved=(sim_kernel_inputs(sim),
                               sim.force_fn.terms[0].G))
            t0 = time.perf_counter()
            apply(tobj)
            torch.cuda.synchronize()
            seen.update(secs=time.perf_counter() - t0,
                        e1=float(sim.ss.energy.eion))

        sim.apply_transform = spy
        lines = []
        counters_zero()
        sim.run(TRANSFORM_STEPS, print_fn=lines.append)
        c = all_counters()
        n = sim.sysdef.state.n_local
        G = sim.force_fn.terms[0].G
        rows = np.array([ln.split() for ln in lines], dtype=np.float64)
        temp = float(rows[rows[:, 0] > TRANSFORM_STEPS - TRANSFORM_TAIL,
                          5].mean())
        c0 = seen.get("c0", {})
        rel = abs(seen.get("e1", 0.0) / (8.0 * seen.get("e0", 1.0)) - 1.0)
        gids = np.unique(sim.ss.state.gid[:n]).size
        gate(seen["calls"] == 1 and seen.get("loop") == TRANSFORM_AT
             and sim.ss.loop == TRANSFORM_STEPS and n == 8 * n0
             and gids == n,
             f"(a) {seen['calls']} replicas, the first at loop "
             f"{seen.get('loop')}, {n} beads, {gids} gids")
        gate(seen["saved"][1] == 1 and G > 1
             and c0.get("cellpair_half", 0) >= TRANSFORM_AT
             and c0.get("cellpair_half_col", 1) == 0
             and c["cellpair_half"] == c0["cellpair_half"]
             and c["cellpair_half_col"] >= TRANSFORM_STEPS - TRANSFORM_AT
             and not any(v for k, v in c.items()
                         if k not in ("cellpair_half", "cellpair_half_col")),
             f"(a) launches {c0} at the replica, {c} at the end, G {G}")
        gate(rel <= TRANSFORM_E_REL, f"(a) first energy {seen.get('e1')} vs "
             f"8 x {seen.get('e0')}")
        gate(np.isfinite(rows).all() and abs(temp - WATER_T) <= TEMP_TOL,
             f"(a) mean T {temp}")
        before = sim.dispatch_log[:seen["disp"]]
        after = sim.dispatch_log[seen["disp"]:]
        phase("transforms", f"(a) water box {n0} beads, transform= "
              f"REPLICATE 2x2x2 at rate {TRANSFORM_AT}, {TRANSFORM_STEPS} "
              f"steps through Simulation: cells {seen['cells0']} (#1, "
              f"{c0['cellpair_half']} launches, {rate(before):.2f} steps/s) "
              f"-> {n} beads, cells {sim.grid.ncells} G={G} cap "
              f"{sim.grid.cap} (#2, {c['cellpair_half_col']} launches, "
              f"{rate(after):.2f} steps/s); the replica and its first "
              f"energy {seen['secs']:.3f} s; first energy {seen['e1']:.6f} "
              f"vs 8 x {seen['e0']:.6f} (rel {rel:.3g}); {gids} unique "
              f"gids; mean T {temp:.2f} K over the last {TRANSFORM_TAIL} "
              f"steps; redos {sim.redos} on {card}")
        rows_out = {
            "cellpair_half_transform": ("cellpair_half", c["cellpair_half"],
                                        sim_pair_check(
                                            sim, "(a) before the replica",
                                            seen.pop("saved"))),
            "cellpair_half_col_transform": (
                "cellpair_half_col", c["cellpair_half_col"],
                sim_pair_check(sim, "(a) the replica"))}

        # --- (b) SELECTSUBSET zmin=0 on the replica -------------------------
        sim.db.compile_string("half TRANSFORM { type=SELECTSUBSET; zmin=0 "
                              "Angstrom; }\n")
        # the run's positions as the host reads them (unwrapped since the
        # last rebuild; the first energy wraps the kept ones)
        upper = int((sim.ss.state.r[:n, 2] >= 0).sum())
        counters_zero()
        apply(sim.db.get("half", "TRANSFORM"))
        cb = all_counters()
        m = sim.sysdef.state.n_local
        e2 = float(sim.ss.energy.eion)
        gate(m == upper and 0.4 * n < m < 0.6 * n and np.isfinite(e2),
             f"(b) SELECTSUBSET: {m} of {n} beads ({upper} at z >= 0), "
             f"e {e2}")
        phase("transforms", f"(b) SELECTSUBSET zmin=0: {n} -> {m} beads "
              f"(the {upper} at z >= 0), cells {sim.grid.ncells} G="
              f"{sim.force_fn.terms[0].G} cap {sim.grid.cap}, first energy "
              f"{e2:.6f} ({ {k: v for k, v in cb.items() if v} })")
        del sim

        # --- (c) the transform master through the CLI -----------------------
        dm = os.path.join(keep, "c")
        os.makedirs(dm)
        deck = water_deck(dm, n_water, printrate=10)
        with open(deck, "a") as f:
            f.write("therm TRANSFORM { type=THERMALIZE; temperature=310 K; "
                    "seed=3; }\nrep TRANSFORM { type=REPLICATE; nx=2; ny=2; "
                    "nz=2; }\nvcm TRANSFORM { type=SETVELOCITY; vcm=0 0 0; "
                    "}\n")
        rd = os.path.join(dm, "run")
        counters_zero()
        t0 = time.perf_counter()
        s = cli_run(["transform", "-o", deck, "--run-dir", rd])
        secs = time.perf_counter() - t0
        cm = all_counters()
        col = read_collection("snapshot.000000/atoms#", rd)
        mass = s.ss.state.mass[:col.n].double().cpu().numpy()[:, None]
        p = np.abs((mass * col.v).sum(0)).max() / (mass * np.abs(col.v)).sum()
        gate(col.n == 8 * n0 and np.unique(col.gid).size == col.n
             and p < 1e-6 and cm["cellpair_half"] >= 1
             and cm["cellpair_half_col"] >= 2,
             f"(c) master: {col.n} beads, |p| {p}, launches {cm}")
        phase("transforms", f"(c) transform master through the CLI: "
              f"THERMALIZE, REPLICATE 2x2x2, SETVELOCITY vcm=0 -> "
              f"{col.n} beads in snapshot.000000, |p| / sum m|v| {p:.3g}, "
              f"#1 {cm['cellpair_half']} and #2 {cm['cellpair_half_col']} "
              f"launches, {secs:.1f} s; phase 22 "
              f"{time.perf_counter() - t_phase:.1f} s")
        del s
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    return rows_out



# --- phase 23 (item 24b): analyses -----------------------------------------
def analyses_edit(objects, print_stress=False):
    """A deck edit that lists the ANALYSIS objects `objects` ({name:
    keyword text}) in SIMULATE analysis= and appends them; print_stress
    adds a PRINTINFO with printStress=1."""
    def edit(text):
        names = " ".join(objects)
        keys = f"analysis={names};" + (" printinfo=pinfo;" if print_stress
                                       else "")
        text = text.replace("type=MD;", f"type=MD; {keys}", 1)
        text += "".join(f"{name} ANALYSIS {{ {kw} }}\n"
                        for name, kw in objects.items())
        if print_stress:
            text += "pinfo PRINTINFO { printStress=1; }\n"
        return text
    return edit


def edit_deck(path, edit):
    """Apply `edit` (text -> text) to the deck file at path."""
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(edit(text))
    return path


# (a): the water box's run through the CLI, its continuation under
# ddcMD_CMDS; (b): the crystal's steps; the analyses' rates
ANALYSIS_STEPS, ANALYSIS_MORE, EAM_ANALYSIS_STEPS = 1000, 300, 300
AN_RATES = "eval_rate=100; outputrate=500;"
WATER_ANALYSES = {
    "gr": f"type=PAIRCORRELATION; delta_r=0.02 nm; length=75; {AN_RATES}",
    "vcm": "type=VCMWRITE; eval_rate=30; outputrate=500;",
    "ke": f"type=KINETICENERGYDISTN; nBins=50; max=20 kJ/mol; {AN_RATES}",
    "zd": f"type=ZDENSITY; nBins=50; {AN_RATES}",
    "ssf": f"type=SSF; nShells=16; kmax=3 1/nm; {AN_RATES}",
    "vaf": f"type=VELOCITYAUTOCORRELATION; {AN_RATES}",
    "fa": f"type=FORCEAVERAGE; {AN_RATES}",
    "ds": f"type=DATASUBSET; {AN_RATES}",
    "cg": f"type=COARSEGRAIN; nx=8; ny=8; nz=8; {AN_RATES}",
    "dsf": f"type=DSF; m=1 2 3; weight=number; {AN_RATES}",
    "sub": f"type=SUBSETWRITE; {AN_RATES}",
    "pa": "type=PAIRANALYSIS; rmax=0.5 nm; eval_rate=500; outputrate=500;",
}
EAM_ANALYSES = {
    "cs": "type=CENTROSYM; eval_rate=100; outputrate=300;",
    "aj": "type=ACKLAND_JONES; eval_rate=100; outputrate=300;",
    "qu": "type=QUATERNION; NNs=12; eval_rate=100; outputrate=300;",
}
# (c): integer histograms and counts card vs CPU (of their total), and
# floats (of their column's largest magnitude)
AN_COUNT_TOL, AN_FLOAT_TOL = 1e-6, 1e-5


@contextlib.contextmanager
def analysis_clock():
    """Time every analysis class's eval and output: yields a namespace
    whose `secs` maps (class name, "eval" | "output") to [host wall
    seconds, calls], `outputs` lists each output's (analysis name,
    loop) and `zd_frames` each ZDENSITY frame's count."""
    from ddcmd_tpu_torch.analysis import registry as areg

    log = SimpleNamespace(secs={}, outputs=[], zd_frames=[])
    saved = []
    for cls in set(areg.REGISTRY.values()):
        for meth in ("eval", "output"):
            fn = cls.__dict__[meth]
            saved.append((cls, meth, fn))

            def timed(self, sim, *a, fn=fn, meth=meth, cls=cls):
                zd = meth == "eval" and cls is areg.ZDensity
                before = (self.state["hist"].sum() if zd
                          and self.state["hist"] is not None else 0.0)
                t0 = time.perf_counter()
                try:
                    return fn(self, sim, *a)
                finally:
                    tot = log.secs.setdefault((cls.__name__, meth),
                                              [0.0, 0])
                    tot[0] += time.perf_counter() - t0
                    tot[1] += 1
                    if meth == "output":
                        log.outputs.append((self.name, sim.ss.loop))
                    elif zd:
                        log.zd_frames.append(
                            float(self.state["hist"].sum() - before))

            setattr(cls, meth, timed)
    try:
        yield log
    finally:
        for cls, meth, fn in saved:
            setattr(cls, meth, fn)


def ms_an_call(log, meth=None):
    """"class [method] ms" for each timed class (of `meth` only when
    given) of an analysis_clock log."""
    return ", ".join(
        f"{cls}{'' if meth else ' ' + m} {1e3 * s / n:.2f}"
        for (cls, m), (s, n) in sorted(log.secs.items())
        if meth in (None, m))


def analysis_rows(path):
    with open(path) as f:
        return np.array([ln.split() for ln in f if not ln.startswith("#")],
                        dtype=np.float64)


def analysis_files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(dirpath, f)) as fh:
                out[os.path.relpath(os.path.join(dirpath, f), root)] = \
                    fh.read()
    return out


def masters_agree(card, cpu, dir_card, dir_cpu, skip_files=()):
    """The analysis master's results on the card against the CPU's on one
    state: the integer histograms and counts (g(r), the KE and z
    histograms, the Ackland-Jones classes, the pair count) within
    AN_COUNT_TOL of their total; QUATERNION's file byte-equal (it reads
    the positions only); every number of the other files within
    AN_FLOAT_TOL of the largest magnitude of its column, but
    stress.data's within AN_FLOAT_TOL of the largest magnitude of the
    stress tensor in its own row (a column of one row whose component
    sits near zero would turn f32 rounding into any share); files named
    in skip_files (base names) are left to the caller.  Returns (worst
    count share, worst float share, what differs and by how much, the
    stress.data share named first)."""
    from ddcmd_tpu_torch.analysis import registry as areg

    worst_n, worst_f, skip, lines = 0.0, 0.0, set(skip_files), []
    for a, b in zip(card.analyses, cpu.analyses):
        if isinstance(a, (areg.PairCorrelation, areg.KineticEnergyDistn,
                          areg.ZDensity)):
            x, y = a.state["hist"], b.state["hist"]
            skip.add(a.filename)
        elif isinstance(a, areg.AcklandJones):
            x, y = (np.bincount(s.state["kinds"], minlength=5)
                    for s in (a, b))
            skip.add(a.filename)
        elif isinstance(a, areg.PairAnalysis):
            x, y = np.array([a.state["cnt"]]), np.array([b.state["cnt"]])
        else:
            continue
        moved, total = float(np.abs(x - y).sum()), float(np.abs(y).sum())
        share = moved / max(total, 1.0)
        worst_n = max(worst_n, share)
        if share:
            lines.append(f"{a.name} {share:.3g} ({moved:g} of {total:g})")
    worst_f, more = files_agree(analysis_files(dir_card),
                                analysis_files(dir_cpu), skip,
                                row_scaled=("stress.data",))
    return worst_n, worst_f, lines + more


def _numbers(tokens):
    """The tokens that read as numbers, as floats."""
    out = []
    for t in tokens:
        try:
            out.append(float(t))
        except ValueError:
            pass
    return out


def files_agree(fa, fb, skip=(), row_scaled=()):
    """Two runs' files ({relative path: text}, analysis_files): the same
    names; each file whose base name is not in `skip` equal, or of as
    many lines with each number within its column's largest magnitude
    times the returned share (QUATERNION's file must be byte-equal: inf
    otherwise).  In a file whose base name is in `row_scaled` every
    number after a row's first is scaled by the largest magnitude of
    those numbers in its own row (a tensor a row), and its share is
    listed first even when the files are equal.
    Returns (worst share, what differs and by how much)."""
    assert sorted(fa) == sorted(fb), (sorted(fa), sorted(fb))
    worst_f, lines, first = 0.0, [], []
    for name, text in fa.items():
        by_row = os.path.basename(name) in row_scaled
        if os.path.basename(name) in skip or (text == fb[name]
                                              and not by_row):
            continue
        if "quaternion" in name:
            return float("inf"), lines + [name]
        scale, pairs = {}, []
        assert len(text.splitlines()) == len(fb[name].splitlines()), name
        for x, y in zip(text.splitlines(), fb[name].splitlines()):
            tx, ty = x.split(), y.split()
            assert len(tx) == len(ty), (name, x, y)
            row = max(map(abs, _numbers(ty[1:])), default=0.0)
            for k, (p, q) in enumerate(zip(tx, ty)):
                try:
                    fp, fq = float(p), float(q)
                except ValueError:
                    assert p == q, (name, p, q)
                    continue
                if by_row and k:
                    pairs.append((None, fp, fq, row))
                    continue
                scale[k] = max(scale.get(k, 0.0), abs(fq))
                pairs.append((k, fp, fq, None))
        err = max((abs(fp - fq) / max(scale[k] if s is None else s, 1e-30)
                   for k, fp, fq, s in pairs), default=0.0)
        worst_f = max(worst_f, err)
        if by_row:
            first.append(f"{name} {err:.3g} of its row's largest")
        elif err:
            lines.append(f"{name} {err:.3g}")
    return worst_f, first + lines


def outputs_agree(da, db, L, skip=()):
    """Two runs' output directories of one deck (analysis_files; the
    mesh's graphs lines differ by design and are not read, nor the files
    named in `skip`): (float
    share, exact share, vcm gap, what differs).  float share: every
    analysis file by files_agree, and the SUBSETWRITE records' positions
    to the periodic image of box edge L (a row on the box edge may wrap
    to either side) and velocities, each over its column's largest
    magnitude; exact share: stress.data and the group files, each number
    over its column's largest magnitude less half a unit of its printed
    last digit (the files print T to 4 decimals); vcm gap: VCMWRITE's
    largest absolute difference (a FREE run's centre-of-mass velocity is
    zero to rounding, so its columns have no scale)."""
    fa, fb = analysis_files(da), analysis_files(db)
    assert sorted(fa) == sorted(fb), (sorted(fa), sorted(fb))
    exact = [k for k in fa if k == "stress.data" or k.startswith("group_")]
    subset = [k for k in fa if k.startswith("subset/")]
    skip = {"graphs", "vcm.data", *skip, *exact, *subset}
    worst_f, lines = files_agree({k: v for k, v in fa.items() if k not in skip},
                                 {k: v for k, v in fb.items() if k not in skip})
    for k in subset:
        (ha, ra), (hb, rb) = (atoms_records(t[k]) for t in (fa, fb))
        assert ha == hb and ra.shape == rb.shape, k
        d = ra[:, :3] - rb[:, :3]
        d -= L * np.round(d / L)
        err = max(float(np.abs(d).max()) / max(np.abs(rb[:, :3]).max(), 1e-30),
                  float((np.abs(ra[:, 3:] - rb[:, 3:]).max(0)
                         / np.maximum(np.abs(rb[:, 3:]).max(0), 1e-30)).max()))
        worst_f = max(worst_f, err)
        if err:
            lines.append(f"{k} {err:.3g}")
    worst_x = 0.0
    for k in exact:
        xa, xb = analysis_rows(os.path.join(da, k)), analysis_rows(
            os.path.join(db, k))
        assert xa.shape == xb.shape and (xa[:, 0] == xb[:, 0]).all(), k
        digits = [4, 8, 8] if k.startswith("group_") else [8] * 6
        res = np.zeros(xa.shape[1])
        if k.startswith("group_"):
            assert (xa[:, 1] == xb[:, 1]).all(), k
            res[2:] = [0.5 * 10.0 ** -p for p in digits]
            cols = range(2, xa.shape[1])
        else:
            cols = range(1, xa.shape[1])
        for c in cols:
            scale = max(np.abs(xb[:, c]).max(), 1e-30)
            gap = np.abs(xa[:, c] - xb[:, c]).max()
            if k == "stress.data":
                # %16.8e: nine significant digits
                res[c] = 0.5e-8 * scale
            err = max(0.0, gap - res[c]) / scale
            worst_x = max(worst_x, err)
            if err:
                lines.append(f"{k} column {c} {err:.3g}")
    va, vb = (analysis_rows(os.path.join(x, "vcm.data")) for x in (da, db))
    assert (va[:, 0] == vb[:, 0]).all()
    return worst_f, worst_x, float(np.abs(va[:, 1:] - vb[:, 1:]).max()), lines


def atoms_records(text):
    """(header, (n, 6) r and v) of an atoms file's records, in gid
    order."""
    head, body = text.split("}\n", 1)
    recs = sorted((ln.split() for ln in body.splitlines() if ln.strip()),
                  key=lambda p: int(p[0]))
    return head, np.array([p[4:10] for p in recs], np.float64)


def quaternion_records(path):
    """QUATERNION's FIXRECORDASCII file: (records, records whose CRC32
    fails, records with a valid colour)."""
    import zlib

    with open(path, "rb") as f:
        blob = f.read()
    body = blob[blob.index(b"}\n\n") + 3:]
    recs = [body[i:i + 112] for i in range(0, len(body), 112)]
    bad = sum(int(r[:8], 16) != zlib.crc32(r[8:]) & 0xFFFFFFFF
              for r in recs)
    coloured = sum(float(r.split()[6]) >= 0 for r in recs)
    return len(recs), bad, coloured


def analyses_phase(card, dev, counters_zero, all_counters, failed,
                   n_water=6173, nc=EAM_NC):
    """Phase 23 (ROADMAP item 24b): (a) the water box (n_water beads, #1)
    with every WATER_ANALYSES object and printStress, ANALYSIS_STEPS
    steps through the CLI beside the same deck without analyses, then
    ANALYSIS_MORE more under ddcMD_CMDS (`analysis` and VCMWRITE's
    eval_rate 60); (b) the nc crystal (#4, the _knn cell-list route):
    the analysis master on the perfect start lattice, then
    EAM_ANALYSIS_STEPS NVT steps through the CLI with EAM_ANALYSES; (c)
    the analysis master on (a)'s and (b)'s checkpoints on the card and
    the CPU.  Gates go into `failed`.  Returns {kernels JSON row: (entry,
    launches, comparison)}: #1 on (a)'s last records, #4's two passes on
    (b)'s."""
    from ddcmd_tpu_torch.analysis.registry import AcklandJones
    from ddcmd_tpu_torch.io.restart import write_checkpoint
    from ddcmd_tpu_torch.objects import units as U

    t_phase = time.perf_counter()
    quiet = lambda line: None                                  # noqa: E731

    def gate(ok, what):
        if not ok:
            failed.append(f"phase 23 {what}")

    def rate(sim):
        return sum(k for k, _ in sim.dispatch_log) / sum(
            s for _, s in sim.dispatch_log)

    keep = tempfile.mkdtemp()
    try:
        # --- (a) the water box on #1 --------------------------------------
        d0 = os.path.join(keep, "a0")
        os.makedirs(d0)
        deck0 = water_deck(d0, n_water, printrate=100)
        counters_zero()
        s0 = cli_run(["simulate", "-o", deck0, "-n", str(ANALYSIS_STEPS),
                      "--run-dir", d0])
        rate0 = rate(s0)
        del s0
        d = os.path.join(keep, "a")
        os.makedirs(d)
        deck_a = edit_deck(water_deck(d, n_water, printrate=100),
                           analyses_edit(WATER_ANALYSES, print_stress=True))
        counters_zero()
        with analysis_clock() as log:
            sim = cli_run(["simulate", "-o", deck_a, "-n",
                           str(ANALYSIS_STEPS), "--run-dir", d])
        c = all_counters()
        rate_a = rate(sim)
        prows = read_rows(d)
        n = sim.sysdef.state.n_local
        names = [a.name for a in sim.analyses]
        gate(sim.ss.loop == ANALYSIS_STEPS and np.isfinite(prows).all()
             and names == [*WATER_ANALYSES, "printStress"],
             f"(a) loop {sim.ss.loop}, analyses {names}")
        gate(c["cellpair_half"] >= ANALYSIS_STEPS and not any(
            v for k, v in c.items() if k != "cellpair_half"),
            f"(a) launches {c}")
        vcm = analysis_rows(os.path.join(d, "vcm.data"))
        gate(vcm[:, 0].tolist() == list(range(30, ANALYSIS_STEPS + 1, 30)),
             f"(a) VCMWRITE rows at {vcm[:, 0].tolist()}")
        gr = analysis_rows(os.path.join(d, "paircorrelation.dat"))
        r_nm, g = gr[:, 0] / 10.0, gr[:, 1]
        peak = float(r_nm[np.argmax(g)])
        tail = float(g[(r_nm > 1.2) & (r_nm < 1.5)].mean())
        gate(not g[r_nm < 0.3].any() and 0.45 <= peak <= 0.65
             and abs(tail - 1.0) <= 0.05,
             f"(a) g(r): peak at {peak} nm, mean {tail} over 1.2-1.5 nm")
        zd = log.zd_frames
        gate(len(zd) == ANALYSIS_STEPS // 100 and min(zd) >= 0.99 * n,
             f"(a) ZDENSITY frames {zd}")
        # C(0) = <v.v> at the VAF's first eval: 3 kT/m at that step's
        # printed T (one mass), and beside the thermostat's WATER_T
        mass = float(sim.sysdef.state.mass[0])
        vaf = analysis_rows(os.path.join(d, "vaf.dat"))
        c0 = float(vaf[0, 1])
        t0_vaf = float(prows[prows[:, 0] == vaf[0, 0], 5][0])
        c0_ref = 3.0 * U.kB * t0_vaf / mass
        c0_bath = 3.0 * U.kB * WATER_T / mass
        gate(abs(c0 / c0_ref - 1.0) <= 0.05, f"(a) VAF C(0) {c0} vs {c0_ref}")
        st = analysis_rows(os.path.join(d, "stress.data"))
        press = dict(zip(prows[:, 0].astype(int), prows[:, 6]))
        gpa = U.convert(1.0, "GPa", "bar")
        p_err = max(abs(-row[1:4].sum() / 3.0 / (press[int(row[0])] * gpa)
                        - 1.0) for row in st)
        gate(st[:, 0].tolist() == list(range(100, ANALYSIS_STEPS + 1, 100))
             and p_err <= 1e-4,
             f"(a) STRESSWRITE loops {st[:, 0].tolist()}, rel {p_err}")
        host = sum(s for s, _ in log.secs.values())
        phase("analyses", f"(a) water box {n} beads, {len(names)} analyses "
              f"(VCMWRITE every 30 steps, the rest every 100, output every "
              f"500), {ANALYSIS_STEPS} steps through the CLI: "
              f"{c['cellpair_half']} #1 launches, {len(sim.dispatch_log)} "
              f"dispatches, {rate_a:.2f} steps/s vs {rate0:.2f} without "
              f"analyses ({rate_a / rate0:.3f}x), analyses' host time "
              f"{host:.2f} s; ms an eval: {ms_an_call(log, 'eval')}; "
              f"VCMWRITE rows 30..990 by 30; g(r) "
              f"peak {peak:.2f} nm, {tail:.4f} over 1.2-1.5 nm; ZDENSITY "
              f"frames {min(zd):.0f}-{max(zd):.0f} of {n}; VAF C(0) "
              f"{c0:.5g} vs 3 kT/m {c0_ref:.5g} at loop {vaf[0, 0]:.0f}'s "
              f"T {t0_vaf:.2f} K ({c0_bath:.5g} at {WATER_T} K); "
              f"-tr(stress)/3 vs "
              f"printinfo's pressure max rel {p_err:.3g} on {card}")

        # --- (a) continued under ddcMD_CMDS -------------------------------
        # `analysis` read after the first dispatch, then (a command file
        # holds commands or object text) VCMWRITE's eval_rate to 60; the
        # rescan's loop read by a spy
        cmds = os.path.join(d, "ddcMD_CMDS")
        rescans = []
        rescan = sim._rescan_objects
        sim._rescan_objects = lambda: (rescans.append(sim.ss.loop),
                                       rescan())
        half = ANALYSIS_MORE // 2
        outs = []
        for text in ("analysis\n", "vcm ANALYSIS { type=VCMWRITE; "
                     "eval_rate=60; outputrate=500; }\n"):
            with open(cmds, "w") as f:
                f.write(text)
            with analysis_clock() as log, \
                    contextlib.redirect_stdout(io.StringIO()):
                sim.run(half, print_fn=quiet)
            outs += log.outputs
        cmd = [loop for nm, loop in outs if nm == "gr" and loop % 500]
        at = cmd[0] if cmd else None
        written = {nm for nm, loop in outs if loop == at}
        end = ANALYSIS_STEPS + ANALYSIS_MORE
        moved = rescans[0] if rescans else end
        later = [int(x) for x in
                 analysis_rows(os.path.join(d, "vcm.data"))[:, 0]
                 if x > moved]
        gate(written == set(names) and len(rescans) == 1
             and sim.analyses[names.index("vcm")].eval_rate == 60
             and later == list(range(moved - moved % 60 + 60, end + 1, 60))
             and len(later) >= 2,
             f"(a) command at {cmd}, wrote {sorted(written)}; rescan at "
             f"{rescans}, VCMWRITE rows after it {later}")
        row_a = sim_pair_check(sim, "(a)")
        write_checkpoint(sim, d)
        phase("analyses", f"(a) {ANALYSIS_MORE} more steps, two command "
              f"files: `analysis` at loop {at} wrote {len(written)} of "
              f"{len(names)} analyses; VCMWRITE eval_rate=60 rescanned at "
              f"loop {moved}, its rows after it at {later}")
        rows_out = {"cellpair_half_analysis": ("cellpair_half",
                                               c["cellpair_half"], row_a)}
        del sim

        # --- (b) the nc crystal on #4, _knn's cell-list route --------------
        db = os.path.join(keep, "b")
        os.makedirs(db)
        deck_b = eam_deck(db, nc, 100, jitter=0.0,
                          edit=analyses_edit(EAM_ANALYSES))
        rb0 = os.path.join(keep, "b0")
        t0 = time.perf_counter()
        with analysis_clock() as log:
            m = cli_run(["analysis", "-o", deck_b, "--run-dir", rb0])
        m_secs = time.perf_counter() - t0
        na = m.sysdef.state.n_local
        cs = m.analyses[0].state["cs"] * U.LENGTH_TO_ANG ** 2
        kinds = np.bincount(m.analyses[1].state["kinds"], minlength=5)
        recs, bad, coloured = quaternion_records(os.path.join(
            rb0, "snapshot.000000000000", "quaternion#000000"))
        gate(na > 4096 and cs.max() < 1e-6 and kinds[1] == na
             and recs == na and bad == 0,
             f"(b) master: cs max {cs.max()}, classes {kinds.tolist()}, "
             f"{recs} quaternion records, {bad} bad CRC32s")
        phase("analyses", f"(b) analysis master on the perfect nc={nc} "
              f"lattice ({na} atoms, _knn's cell-list route on the card): "
              f"CENTROSYM max {cs.max():.3g} A^2, Ackland-Jones "
              f"{dict(zip(AcklandJones.LABELS, kinds.tolist()))}, "
              f"QUATERNION "
              f"{recs} records, {bad} bad CRC32s, {coloured} coloured; "
              f"{m_secs:.2f} s (ms: {ms_an_call(log)})")
        del m
        counters_zero()
        with analysis_clock() as log:
            sim_b = cli_run(["simulate", "-o", deck_b, "-n",
                             str(EAM_ANALYSIS_STEPS), "--run-dir", db])
        cb = all_counters()
        with open(os.path.join(db, "acklandJones.dat")) as f:
            last = f.read().splitlines()[-1]
        fcc = int(last.split("FCC=")[1].split()[0])
        brows = read_rows(db)
        gate(sim_b.ss.loop == EAM_ANALYSIS_STEPS and np.isfinite(brows).all()
             and fcc >= 0.95 * na,
             f"(b) run: loop {sim_b.ss.loop}, {last}")
        eam = ("eam_rho", "eam_force")
        gate(all(cb[k] >= EAM_ANALYSIS_STEPS for k in eam) and not any(
            v for k, v in cb.items() if k not in eam), f"(b) launches {cb}")
        out_b = sim_eam_check(sim_b, "(b)")
        for p in ("rho", "force"):
            rows_out[f"eam_{p}_analysis"] = (f"eam_{p}", cb[f"eam_{p}"],
                                             out_b[p])
        write_checkpoint(sim_b, db)
        phase("analyses", f"(b) {EAM_ANALYSIS_STEPS} NVT steps from the "
              f"perfect lattice through the CLI with CENTROSYM, "
              f"ACKLAND_JONES and QUATERNION every 100: {last}; T "
              f"{brows[-1, 5]:.2f} K; #4 {cb['eam_rho']} / "
              f"{cb['eam_force']} launches; {rate(sim_b):.2f} steps/s; "
              f"ms an eval: {ms_an_call(log, 'eval')}")
        del sim_b

        # --- (c) the master on one state, card vs CPU ------------------------
        for what, deck, rd in (("water box", deck_a, d),
                               (f"nc={nc} crystal", deck_b, db)):
            got, dirs, secs = {}, {}, {}
            for where in ("cuda", "cpu"):
                dirs[where] = os.path.join(rd, f"master-{where}")
                t0 = time.perf_counter()
                got[where] = cli_run(
                    ["analysis", "-o", deck, "-r", os.path.join(rd, "restart"),
                     "--run-dir", dirs[where]], where)
                secs[where] = time.perf_counter() - t0
            wn, wf, diff = masters_agree(got["cuda"], got["cpu"],
                                         dirs["cuda"], dirs["cpu"])
            n_rows = got["cpu"].sysdef.state.n_local
            dr = float((got["cuda"].ss.state.r[:n_rows].cpu()
                        - got["cpu"].ss.state.r[:n_rows]).abs().max())
            gate(wn <= AN_COUNT_TOL and wf <= AN_FLOAT_TOL,
                 f"(c) {what}: counts {wn}, floats {wf}")
            phase("agree", f"(c) analysis master on the {what}'s checkpoint "
                  f"(loop {got['cpu'].ss.loop}), card vs CPU: "
                  f"{len(got['cpu'].analyses)} analyses, positions after "
                  f"the first energy max |dr| {dr:.3g} nm; counts differ "
                  f"by {wn:.3g} of their total, floats by {wf:.3g} of "
                  f"their column's scale, stress.data's of its row's "
                  f"({'; '.join(diff) or 'equal'}); "
                  f"{secs['cuda']:.2f} s on the card, {secs['cpu']:.2f} s "
                  f"on the CPU")
            del got
        phase("analyses", f"phase 23 {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    return rows_out


# --- phase 24 (items 27-30): the last refusals of Simulation ---------------
# (a) the nx = 24 bilayer patch (25,376 beads, 192 x 192 x 110.8 A),
# staged at EQ_DT as phase 6 stages the full one, then REBUILD_STEPS at
# 20 fs with transform= REPLICATE 2 x 2 x 1 REBUILD_AT steps in (101,504
# beads at 384 x 384 x 110.8 A) and VELOCITYAUTOCORRELATION every
# VAF_RATE steps in blocks of VAF_LENGTH evals (the first block spans
# the replica, the second starts on all 101,504); T read over the last
# REBUILD_TAIL steps, within REBUILD_T_TOL of BILAYER_T; the replica's
# energy of each term against 4x that before it (f32) and the VAF rows
# against C(t) in f64 over the kept gids, within VAF_TOL of C(0)
REBUILD_NX, REBUILD_AT, REBUILD_STEPS, REBUILD_TAIL = 24, 200, 600, 200
REBUILD_E_REL, REBUILD_T_TOL, RATTLE_TOL = 1e-5, 3.0, 5e-3
VAF_RATE, VAF_LENGTH, VAF_TOL = 20, 15, 1e-6
# (b) the nc = 12 crystal at its zero-pressure lattice constant INT_A_LAT
# (at the builder's 3.615 A the deck sits at 43.9 GPa, and a free surface
# lowers its energy) with pbc = 3 and its z doubled (two free (100)
# surfaces) on the cell-block EAM engine: against engine "nlist" within
# SLAB_REL of the force scale, SLAB_NVE FREE steps; (c) the 500-atom LJ
# slab (2 list cells on z) on engine "nlist" in f64, card against the CPU
# and against the same deck with z doubled, within LIST_REL of the scale
# (in f32 the card's forces sat 1.86e-6 of the scale from the CPU's in
# PR 18's first run: reduction order and contraction, no pair missing;
# a pair through the wall or a one-sided pair moves a force by ~1e-2)
SLAB_NC, SLAB_NVE, SLAB_REL, LIST_REL = 12, 100, 1e-5, 1e-6
EV_PER_NM2 = 0.1602177         # J/m^2 in one eV/nm^2


def pad_z(factor, pbc=3):
    """A deck edit: the BOX's z length times `factor` (vacuum on z, the
    atoms where they are) and pbc = `pbc`."""
    def edit(text):
        start = text.index(" h=", text.index("BOX {"))
        end = text.index(";", start)
        h = text[start + 3:end].split()
        h[8] = repr(float(h[8]) * factor)
        return (text[:start] + " h= " + " ".join(h) + " "
                + text[end:]).replace("pbc=7", f"pbc={pbc}")
    return edit


def term_energies(sim):
    """(e, virial) of each force term of sim at its current state, on
    a handle built there."""
    ss, handle, overflow = sim._build_nbr(sim.ss)
    assert not bool(overflow), "overflow building the term check's handle"
    return [(float(e), v.double().cpu().numpy()) for _, e, v, _ in
            (t(ss.state, ss.box, handle) for t in sim.force_fn.terms)]


def first_fe(sim):
    """The first energy's forces (n, 3) f64 on the host and eion."""
    sim.first_energy()
    n = sim.sysdef.state.n_local
    return (sim.ss.state.f[:n].double().cpu().numpy(),
            float(sim.ss.energy.eion))


def rebuilds_phase(card, dev, counters_zero, all_counters, failed):
    """Phase 24 (ROADMAP items 27-30), gates into `failed`: (a) the nx =
    REBUILD_NX bilayer patch staged, then a REPLICATE 2 x 2 x 1 mid-run
    on #2 with VELOCITYAUTOCORRELATION across it; (b) an EAM slab with
    two free surfaces on the cell-block EAM engine; (c) the LJ slab's
    list on a 2-cell non-periodic axis.  Returns {kernels JSON row:
    (entry, launches, comparison)}: #2 on (a)'s last records with the
    run's launches."""
    from ddcmd_tpu_torch.analysis.registry import VelocityAutocorrelation
    from ddcmd_tpu_torch.integrators.constraints import constraint_residual
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.objects import units as U
    from ddcmd_tpu_torch.run.simulate import Simulation

    t_phase = time.perf_counter()

    def gate(ok, what):
        if not ok:
            failed.append(f"phase 24 {what}")

    def rate(log):
        return sum(k for k, _ in log) / max(sum(t for _, t in log), 1e-9)

    keep = tempfile.mkdtemp()
    try:
        # --- (a) items 29 and 30: REPLICATE 2 x 2 x 1 on the patch ----------
        d_eq, d = os.path.join(keep, "eq"), os.path.join(keep, "a")
        os.makedirs(d_eq)
        os.makedirs(d)
        deck, _ = bilayer_stage1(d_eq, d, nx=REBUILD_NX)
        at = EQ_STEPS + REBUILD_AT          # the restart's loop + REBUILD_AT
        edit_deck(deck, lambda s: s.replace(
            "type=MD;", "type=MD; analysis=vaf; transform=rep;", 1)
            + f"vaf ANALYSIS {{ type=VELOCITYAUTOCORRELATION; "
            f"length={VAF_LENGTH}; eval_rate={VAF_RATE}; "
            f"outputrate={REBUILD_STEPS}; }}\n"
            f"rep TRANSFORM {{ type=REPLICATE; nx=2; ny=2; nz=1; "
            f"rate={at}; }}\n")
        run_dir = os.path.join(d, "run")
        os.makedirs(run_dir)
        sim = Simulation(*load(d, os.path.join(d, "restart")),
                         run_dir=run_dir, device=dev)
        n0 = sim.sysdef.state.n_local
        vaf = next(a for a in sim.analyses
                   if isinstance(a, VelocityAutocorrelation))
        seen, vaf_seen = {"calls": 0}, []
        apply, vaf_eval = sim.apply_transform, vaf.eval

        def spy(tobj):
            seen["calls"] += 1
            if seen["calls"] > 1:
                return apply(tobj)
            bt = sim.sysdef.bonded
            seen.update(loop=sim.ss.loop, terms0=term_energies(sim),
                        counts0=dict(bt.counts(),
                                     sys=sim.sysdef.n_constraints),
                        disp=len(sim.dispatch_log))
            t0 = time.perf_counter()
            apply(tobj)
            torch.cuda.synchronize()
            seen["secs"] = time.perf_counter() - t0
            bt = sim.sysdef.bonded
            seen.update(terms1=term_energies(sim),
                        counts1=dict(bt.counts(),
                                     sys=sim.sysdef.n_constraints))

        def vaf_spy(s):
            n = s.sysdef.state.n_local
            vaf_seen.append((s.ss.state.gid[:n].copy(),
                             s.ss.state.v[:n].double().cpu().numpy()))
            vaf_eval(s)
            vaf_seen[-1] += (vaf.state["rows"][-1][1],)

        sim.apply_transform, vaf.eval = spy, vaf_spy
        lines = []
        counters_zero()
        sim.run(REBUILD_STEPS, print_fn=lines.append)
        c = all_counters()
        sd = sim.sysdef
        n = sd.state.n_local
        rows = np.array([ln.split() for ln in lines], dtype=np.float64)
        end = EQ_STEPS + REBUILD_STEPS
        temp = float(rows[rows[:, 0] > end - REBUILD_TAIL, 5].mean())
        L1 = sim.ss.box.lengths.double().cpu().numpy()
        bt = sd.bonded
        resid = float(constraint_residual(sim.ss.state, bt.cons_atoms,
                                          bt.cons_pairs, bt.cons_dist,
                                          box_lengths=L1))
        rel = max(abs(a / (4.0 * b) - 1.0) for (a, _), (b, _) in
                  zip(seen.get("terms1", []), seen.get("terms0", [])))
        vir = max(np.abs(va - 4.0 * vb).max() / (4.0 * np.abs(vb).max())
                  for (_, va), (_, vb) in zip(seen["terms1"],
                                              seen["terms0"]))
        c0, c1 = seen["counts0"], seen["counts1"]
        gate(seen["calls"] == 1 and seen.get("loop") == at and n == 4 * n0
             and np.unique(sim.ss.state.gid[:n]).size == n,
             f"(a) {seen['calls']} replicas, the first at loop "
             f"{seen.get('loop')}, {n} beads")
        gate(rel <= REBUILD_E_REL, f"(a) term energies {seen['terms1']} vs "
             f"4 x {seen['terms0']} (rel {rel})")
        gate(c1 == {k: 4 * v for k, v in c0.items()},
             f"(a) counts {c1} vs 4 x {c0}")
        gate(resid < RATTLE_TOL, f"(a) RATTLE residual {resid}")
        gate(np.isfinite(rows).all()
             and abs(temp - BILAYER_T) <= REBUILD_T_TOL, f"(a) mean T {temp}")
        gate(c["cellpair_half_col"] >= REBUILD_STEPS
             and not any(v for k, v in c.items()
                         if k != "cellpair_half_col"),
             f"(a) launches {c}")
        # the VAF against C(t) over the gids present at both times, in
        # f64, each block from its first eval's v(0)
        verr, blocks = 0.0, []
        for i, (g, v, got) in enumerate(vaf_seen):
            if i % VAF_LENGTH == 0:
                g0, v0 = g, v
                c00 = (v0 * v0).sum() / len(g0)
                blocks.append(len(g0))
            _, now, then = np.intersect1d(g, g0, return_indices=True)
            ref = (v[now] * v0[then]).sum() / len(now)
            verr = max(verr, abs(got - ref) / c00)
        gate(len(vaf_seen) == REBUILD_STEPS // VAF_RATE
             and blocks == [n0, n] and verr <= VAF_TOL,
             f"(a) VAF: {len(vaf_seen)} evals, blocks over {blocks} "
             f"particles, err {verr} of C(0)")
        before = sim.dispatch_log[:seen["disp"]]
        after = sim.dispatch_log[seen["disp"]:]
        phase("rebuilds", f"(a) bilayer patch nx={REBUILD_NX} {n0} beads, "
              f"transform= REPLICATE 2x2x1 at loop {at} -> {n} beads, box "
              f"{L1.round(4).tolist()} nm, cells {sim.grid.ncells} G="
              f"{sim.force_fn.terms[0].G} cap {sim.grid.cap}; the replica, "
              f"its topology and first energy {seen['secs']:.3f} s; term "
              f"energies {[round(e, 3) for e, _ in seen['terms1']]} vs 4 x "
              f"{[round(e, 3) for e, _ in seen['terms0']]} (rel {rel:.3g}, "
              f"virial {vir:.3g}); counts {c1}; RATTLE residual "
              f"{resid:.3g}; mean T {temp:.2f} K over the last "
              f"{REBUILD_TAIL} steps; VAF {len(vaf_seen)} evals in blocks "
              f"over {blocks} particles, max |C - C_ref| {verr:.3g} of "
              f"C(0); #2 {c['cellpair_half_col']} launches; "
              f"{rate(before):.2f} steps/s before, {rate(after):.2f} "
              f"after; redos {sim.redos} on {card}")
        rows_out = {"cellpair_half_col_rebuild": (
            "cellpair_half_col", c["cellpair_half_col"],
            sim_pair_check(sim, "(a) the replica"))}
        del sim

        # --- (b) item 27: an EAM slab on the cell-block EAM engine ----------
        db_, ds = os.path.join(keep, "bulk"), os.path.join(keep, "b")
        os.makedirs(db_)
        os.makedirs(ds)
        eam_deck(db_, SLAB_NC, 10, free=True, a_lat=INT_A_LAT)
        eam_deck(ds, SLAB_NC, 10, free=True, a_lat=INT_A_LAT,
                 edit=pad_z(2.0))
        counters_zero()
        slab = Simulation(*load(ds), run_dir=ds, device=dev)
        f_cb, e_cb = first_fe(slab)
        f_nl, e_nl = first_fe(Simulation(*load(ds), run_dir=ds, device=dev,
                                         engine="nlist"))
        _, e_bulk = first_fe(Simulation(*load(db_), run_dir=db_,
                                        device=dev, engine="cellblock"))
        na = slab.sysdef.state.n_local
        L = slab.sysdef.box.lengths.double().cpu().numpy()
        ferr = np.abs(f_cb - f_nl).max() / np.abs(f_nl).max()
        erel = abs(e_cb / e_nl - 1.0)
        eV = U.unit_scale("eV")
        gamma = (e_cb - e_bulk) / eV / (2.0 * L[0] * L[1]) * EV_PER_NM2
        lines = []
        t0 = time.perf_counter()
        slab.run(SLAB_NVE, print_fn=lines.append)
        secs = time.perf_counter() - t0
        cb = all_counters()
        rows = np.array([ln.split() for ln in lines], dtype=np.float64)
        drift = float(np.abs(rows[:, 2] - rows[0, 2]).max())
        gate(slab.engine == "cellblock" and ferr <= SLAB_REL
             and erel <= SLAB_REL,
             f"(b) {slab.engine}: force {ferr}, e {e_cb} vs {e_nl}")
        gate(gamma > 0 and np.isfinite(rows).all()
             and torch.isfinite(slab.ss.state.r).all()
             and not any(cb.values()),
             f"(b) surface energy {gamma}, {SLAB_NVE} NVE steps, "
             f"launches {cb}")
        phase("rebuilds", f"(b) EAM slab nc={SLAB_NC} {na} atoms, pbc=3, "
              f"box {L.round(4).tolist()} nm, engine {slab.engine} cells "
              f"{slab.grid.ncells} cap {slab.grid.cap}: first energy "
              f"{e_cb:.6f} vs {e_nl:.6f} on engine nlist (rel {erel:.3g}), "
              f"forces {ferr:.3g} of the scale; surface energy (E_slab - "
              f"E_bulk)/2A {gamma:.4f} J/m^2 (E_bulk {e_bulk:.6f}); "
              f"{SLAB_NVE} NVE steps {SLAB_NVE / secs:.2f} steps/s, max "
              f"|Etot - Etot0| {drift:.3g} eV/atom; no kernel launched")
        del slab

        # --- (c) item 28: the list on a 2-cell non-periodic axis ------------
        dl, dp = os.path.join(keep, "c"), os.path.join(keep, "cp")
        os.makedirs(dl)
        os.makedirs(dp)
        lj_deck(dl, 500, 10, edit=slab_edit)
        lj_deck(dp, 500, 10, edit=lambda s: pad_z(2.0)(slab_edit(s)))
        counters_zero()
        f64 = dict(engine="nlist", dtype=torch.float64)
        thin = Simulation(*load(dl), run_dir=dl, device=dev, **f64)
        f_c, e_c = first_fe(thin)
        f_h, e_h = first_fe(Simulation(*load(dl), run_dir=dl, device="cpu",
                                       **f64))
        padded = Simulation(*load(dp), run_dir=dp, device=dev, **f64)
        f_p, e_p = first_fe(padded)
        cc = all_counters()
        scale = np.abs(f_h).max()
        errs = (np.abs(f_c - f_h).max() / scale,
                np.abs(f_c - f_p).max() / scale)
        rels = (abs(e_c / e_h - 1.0), abs(e_c / e_p - 1.0))
        gate(thin.grid.ncells[2] == 2 and padded.grid.ncells[2] >= 4
             and max(errs + rels) <= LIST_REL and not any(cc.values()),
             f"(c) forces {errs}, e {rels}, cells {thin.grid.ncells}, "
             f"{padded.grid.ncells}, launches {cc}")
        phase("rebuilds", f"(c) LJ slab 500 atoms, pbc=3, engine nlist f64, "
              f"cells {thin.grid.ncells} (padded z: {padded.grid.ncells}): "
              f"first energy {e_c:.6f}, the CPU's {e_h:.6f}, the padded "
              f"box's {e_p:.6f}; forces card vs CPU {errs[0]:.3g}, vs the "
              f"padded box {errs[1]:.3g} of the scale; phase 24 "
              f"{time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    return rows_out


# --- phase 25 (item 25, first part): the mesh's load balance --------------
# (a) the dry run's zRamp deck (__graft_entry__.py:410-444), a (2,2,2)
# ZRAMP and a BISECTION plan of its start state, every brick evaluated
# on the card by the mesh's own per-rank pair function with its halo
# shell filled from the host, the ghost shares reduced home by row (what
# halo_reduce_3d does across ranks): forces and energy against
# Simulation's pair term on the same state; (b) the nc = 12 crystal under
# the skewed walls of tests/test_pallas_shard.py:338-372, its eight
# bricks through the two EAM passes with the densities reduced and the
# embedding taken between them, against Simulation's; (c) the water box
# through ParallelSimulation at (1,1,1), LB_STEPS NVT steps without load
# balance and with ZRAMP at LB_RATE, the checkpoint, its restarts and
# the analyses
LB_BILAYER = dict(nx=12, ny=12, water_nm=1.2)
LB_SKEW = (np.array([0.0, 0.42, 1.0]), np.array([0.0, 0.58, 1.0]),
           np.array([0.0, 0.5, 1.0]))
LB_STEPS, LB_RATE = 1000, 100
# (a), (b): forces over the scale and the energy, relative, of the eight
# bricks against Simulation's evaluation on the card (f32 both, other
# cells and other summation orders: the mesh tests' 2e-5 (pair) and 5e-5
# (EAM) of the scale against f64)
LB_F_TOL, LB_EAM_F_TOL, LB_E_REL = 5e-5, 1e-4, 2e-5
# (c): the analyses of the mesh against Simulation's on the restart: the
# histograms exactly, the floats to AN_MESH_TOL of their scale
LB_ANALYSES = {
    "gr": "type=PAIRCORRELATION; delta_r=0.02 nm; length=60;",
    "vcm": "type=VCMWRITE;",
    "ke": "type=KINETICENERGYDISTN; nBins=50; max=20 kJ/mol;",
    "zd": "type=ZDENSITY; nBins=50;",
    "ssf": "type=SSF; nShells=16; kmax=4 1/nm;",
    "vaf": "type=VELOCITYAUTOCORRELATION;",
}
AN_MESH_TOL = 1e-6


def lb_walls(kind, r, L, shape, rlist):
    """The walls ParallelSimulation computes for `kind` from positions r
    (its _lb_walls)."""
    from ddcmd_tpu_torch.parallel.loadbalance import (clamp_walls,
                                                      orcb_walls,
                                                      tensor_walls)

    if kind == "BISECTION":
        return orcb_walls(r, L, shape, min_frac=tuple(
            1.05 * rlist / L[a] for a in range(3)))
    return tuple(tuple(clamp_walls(w, 1.05 * rlist / L[a])) for a, w in
                 enumerate(tensor_walls(r, L, shape, work_power=2)))


def brick_pools(r, L, cp, dev):
    """Each brick of plan cp as the mesh step bins it, its halo shell
    filled from the host: [(idx3, pool rows, brick-frame fractions, slot
    permutation, counts, Cartesian span)] for the rows whose brick-frame
    fraction lies in the brick's core or halo shell."""
    from ddcmd_tpu_torch.parallel import shard_cells as sc

    Lv = torch.tensor(L, dtype=torch.float32, device=dev)
    rt = torch.tensor(r, dtype=torch.float32, device=dev)
    out = []
    for idx3 in np.ndindex(*cp.shape):
        geom = sc.dev_geom(cp, idx3, dev)
        u = sc.brick_frame_frac(rt, Lv, cp, geom)
        inside = torch.ones(len(r), dtype=torch.bool, device=dev)
        for a in range(3):
            if cp.open_axes[a]:
                h = 1.0 / cp.ncore[a]
                inside &= (u[:, a] >= -0.5 - h) & (u[:, a] < 0.5 + h)
        rows = torch.nonzero(inside).reshape(-1)
        perm, counts, ov = sc.bin_pool_ext(
            sc.bin_frac(u[rows], rt[rows], Lv, cp, idx3),
            torch.ones(len(rows), dtype=torch.bool, device=dev), cp)
        assert not bool(ov), f"cell overflow binning brick {idx3}"
        out.append((idx3, rows, u[rows], perm, counts, geom[1] * Lv))
    return out


def lb_pair_bricks(a, kind, dev):
    """(a) for one plan: the eight bricks of a (2,2,2) `kind` plan of the
    bilayer state `a` (bilayer_lb_arrays) through shard_pair_eval with
    exclusions, their shares reduced by row, plus the reaction-field self
    energy.  Returns (f (n, 3), e,
    virial, plan, walls, pools, the kernel's args and kw of each brick)."""
    from ddcmd_tpu_torch.parallel import shard_cells as sc

    shape, n = (2, 2, 2), len(a["r"])
    walls = lb_walls(kind, a["r"], a["L"], shape, a["rlist"])
    sf_min = sc.walls_span_minmax(walls, shape)[0]
    assert (sf_min * a["L"] >= 2 * a["rlist"]).all(), (
        f"{kind}: a brick under 2 rlist ({sf_min * a['L']})")
    cp = sc.plan_shard_cells(a["L"], shape, a["rcut"], a["skin"], n,
                             walls=walls)
    t = a["tables"]
    eval_fn = sc.make_shard_pair_kernel(cp, t, True, dev, excl=True)
    q, tidx, ex = (torch.tensor(a[k], device=dev) for k in ("q", "tidx",
                                                            "ex"))
    f = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    e = torch.zeros((), dtype=torch.float32, device=dev)
    vir = torch.zeros((3, 3), dtype=torch.float32, device=dev)
    pools, calls = brick_pools(a["r"], a["L"], cp, dev), []
    for idx3, rows, u, perm, counts, span in pools:
        fb, vb, pe = sc.shard_pair_eval(u, q[rows], tidx[rows], perm, counts,
                                        span, cp, t, eval_fn, ex_pool=ex[rows])
        f.index_add_(0, rows, fb)
        e, vir = e + pe.sum(), vir + vb
        slots = sc.pack_slots_ext(u, q[rows], tidx[rows], perm, span, cp,
                                  ex[rows])
        calls.append(((slots, eval_fn.stencil,
                       sc.ext_L8(span, cp, t["rcut2"]), counts,
                       *eval_fn.tabs), eval_fn.kw))
    # the reaction-field self energy of every bead (BrickStepCells._rebuild's
    # pe_self, counted once across the mesh)
    e = e - 0.5 * (q * q).sum() * t["keR"] * t["crf"]
    return f, e, vir, cp, walls, pools, calls


def bilayer_lb_arrays(d, dev):
    """The zRamp deck's start state on the host (bilayer_arrays at
    LB_BILAYER) and Simulation's pair term on it: its forces, energy and
    virial."""
    from ddcmd_tpu_torch.core.system import build_system
    from ddcmd_tpu_torch.models import load, martini_bilayer
    from ddcmd_tpu_torch.potentials.martini import martini_device_tables
    from ddcmd_tpu_torch.run.forces import _excl_channels
    from ddcmd_tpu_torch.run.simulate import Simulation

    martini_bilayer(d, **LB_BILAYER)
    sd = build_system(load(d)[0], d)
    n = sd.state.n_local
    parms = sd.potentials[0][2]
    a = dict(r=sd.state.r[:n].numpy(), q=sd.state.q[:n].numpy(),
             tidx=parms.species_lj_type[sd.state.species[:n].numpy()],
             ex=_excl_channels(sd.bonded.exclusions, n),
             L=sd.box.lengths.numpy().astype(np.float64), rcut=sd.rcut_max,
             skin=sd.neighbor_deltaR, rlist=sd.rcut_max + sd.neighbor_deltaR,
             tables=martini_device_tables(parms, device=dev))
    sim = Simulation(*load(d), run_dir=d, device=dev)
    ss, handle, ov = sim._build_nbr(sim.ss)
    assert not bool(ov)
    fr, er, vr, _ = sim.force_fn.terms[0](ss.state, ss.box, handle)
    a.update(f_ref=fr[:n].double(), e_ref=float(er), v_ref=vr.double(),
             engine=sim.engine)
    return a


def held(name, f, e, f_ref, e_ref, f_tol):
    """(force err over the scale, e rel) of f, e against the reference;
    raises past f_tol or LB_E_REL."""
    scale = max(1.0, float(f_ref.abs().max()))
    ferr = float((f.double() - f_ref).abs().max()) / scale
    rel = abs(float(e) - e_ref) / abs(e_ref)
    if ferr > f_tol or rel > LB_E_REL:
        raise AssertionError(f"{name}: force err {ferr:.3g} of the scale, "
                             f"e rel {rel:.3g}")
    return ferr, rel


def eam_lb_bricks(d, dev):
    """(b): the nc = 12 crystal's eight bricks under LB_SKEW through the
    two EAM passes (shard_eam_rho, the densities and pair energies reduced
    by row, the embedding, shard_eam_force), against Simulation's first
    energy and forces.  Returns (ferr, e rel, plan, the brick calls of
    the widest brick: (slots, args, kw, tables))."""
    from ddcmd_tpu_torch.core.system import build_system
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.parallel import shard_cells as sc
    from ddcmd_tpu_torch.potentials.eam import _embedding, eam_device_tables
    from ddcmd_tpu_torch.run.simulate import Simulation

    eam_deck(d, EAM_NC, 100)
    sd = build_system(load(d)[0], d)
    n = sd.state.n_local
    r = sd.state.r[:n].numpy()
    L = sd.box.lengths.numpy().astype(np.float64)
    shape = (2, 2, 2)
    sf_min = sc.walls_span_minmax(LB_SKEW, shape)[0]
    assert (sf_min * L >= 2 * (sd.rcut_max + sd.neighbor_deltaR)).all()
    cp = sc.plan_shard_cells(L, shape, sd.rcut_max, sd.neighbor_deltaR, n,
                             walls=LB_SKEW)
    tables = eam_device_tables(sd.potentials[0][2], device=dev)
    rho_fn, force_fn = sc.make_shard_eam_kernels(cp, tables, dev)
    tidx = torch.zeros(n, dtype=torch.int64, device=dev)
    pools = brick_pools(r, L, cp, dev)
    red = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    passes = []
    for idx3, rows, u, perm, counts, span in pools:
        rp, slots, L8 = sc.shard_eam_rho(u, tidx[rows], perm, counts, span,
                                         cp, tables, rho_fn)
        red.index_add_(0, rows, rp)
        passes.append((rows, perm, counts, slots, L8))
    F_emb, dF = _embedding(tables["form"], tables["embed"], tidx, red[:, 0])
    f = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for rows, perm, counts, slots, L8 in passes:
        fb, _ = sc.shard_eam_force(slots, L8, counts, dF[rows], perm, cp,
                                   force_fn)
        f.index_add_(0, rows, fb)
    e = red[:, 1].sum() + F_emb.sum()
    sim = Simulation(*load(d), run_dir=d, device=dev)
    sim.first_energy()
    ferr, rel = held("EAM walls bricks vs Simulation", f, e,
                     sim.ss.state.f[:n].double(),
                     float(sim.ss.energy.eion), LB_EAM_F_TOL)
    wide = max(range(len(pools)), key=lambda k: float(
        torch.prod(pools[k][5])))
    _, _, counts, slots, L8 = passes[wide]
    return ferr, rel, cp, pools[wide][0], (
        slots, (rho_fn.stencil, L8, counts, rho_fn.params), rho_fn.kw,
        tables)


def mesh_lb_run(d, dev, lb):
    """(c): the water box through ParallelSimulation at (1,1,1), with
    `lb` ("" or a LOADBALANCE type) at LB_RATE: LB_STEPS steps in chunks.
    Returns (ps, steps/s over the run, launches of #6)."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation

    if lb:
        edit_deck(os.path.join(d, "object.data"), lambda t: t.replace(
            "ddc DDC { updateRate=20; }",
            "ddc DDC { updateRate=20; loadBalance=bal; }\n"
            f"bal LOADBALANCE {{ type={lb}; rate={LB_RATE}; }}"))
    ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev)
    ps.first_energy()
    ch.cellpair_half_ext.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps.run(LB_STEPS, max_steps_per_dispatch=DISPATCH)
    torch.cuda.synchronize()
    rate = LB_STEPS / (time.perf_counter() - t0)
    return ps, rate, ch.cellpair_half_ext.launches


def an_states(analyses):
    """{name: {state key: float64 array}} of evaluated analyses."""
    return {a.name: {k: np.asarray(v, np.float64) for k, v in
                     a.state.items() if isinstance(v, (np.ndarray, list))
                     and len(v)} for a in analyses}


def loadbalance_phase(card, dev, counters_zero, all_counters, failed):
    """Phase 25 (ROADMAP item 25, first part), gates into `failed`.
    Returns {kernels JSON row: (kernel entry, launches, compare result)}
    for cellpair_half_ext_excl_walls (ZRAMP bricks), cellpair_half_ext_orcb
    (BISECTION bricks) and eam_{rho,force}_ext_walls."""
    from ddcmd_tpu_torch.analysis.registry import build_analysis
    from ddcmd_tpu_torch.io.pxyz import read_pxyz_full
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.ops import eam_half as eh
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    rows = {}
    ext = (ch.cellpair_half_ext, ch.cellpair_half_plain)
    # (a) the zRamp bilayer's bricks under ZRAMP and BISECTION walls
    with tempfile.TemporaryDirectory() as d:
        a = bilayer_lb_arrays(d, dev)
    n = len(a["r"])
    for kind, row in (("ZRAMP", "cellpair_half_ext_excl_walls"),
                      ("BISECTION", "cellpair_half_ext_orcb")):
        counters_zero()
        f, e, vir, cp, walls, pools, calls = lb_pair_bricks(a, kind, dev)
        torch.cuda.synchronize()
        launches = all_counters()["cellpair_half_ext_excl"]
        ferr, rel = held(f"{kind} bricks vs Simulation", f, e, a["f_ref"],
                         a["e_ref"], LB_F_TOL)
        if launches != len(pools):
            failed.append(f"(a) {kind}: {launches} launches of #6 for "
                          f"{len(pools)} bricks")
        vol = [float(torch.prod(p[5])) for p in pools]
        res = {}
        for which, k in (("narrowest", int(np.argmin(vol))),
                         ("widest", int(np.argmax(vol)))):
            args, kw = calls[k]
            res[which] = compare(
                f"#6 + exclusions, {which} brick {pools[k][0]} of the "
                f"{kind} plan (zRamp bilayer {n} beads, ncore {cp.ncore}, "
                f"cap {cp.cap}, span {pools[k][5].cpu().numpy().round(3)} "
                f"nm, {int(args[3][:cp.n_prog].sum())} core + "
                f"{int(args[3][cp.n_prog:].sum())} halo beads)", *ext, args,
                kw, with_bound=True, device_key="cellpair_half_kernel")
            sentinel_zero(f"{kind} {which} brick", ext[0](*args, **kw)[1])
        rows[row] = ("cellpair_half_ext_excl", launches, res["widest"])
        wtxt = [np.round(np.asarray(w), 4).tolist() for w in walls]
        phase("loadbalance", f"(a) {kind} (2,2,2) walls {wtxt}: 8 bricks "
              f"on #6 with exclusions ({launches} launches), forces vs "
              f"Simulation's pair term ({a['engine']}) {ferr:.3g} of the "
              f"scale, e {float(e):.8g} vs {a['e_ref']:.8g} (rel "
              f"{rel:.2g}), virial trace {float(torch.trace(vir)):.6g} vs "
              f"{float(torch.trace(a['v_ref'])):.6g}; "
              f"{time.perf_counter() - T_START:.0f} s")
    del a

    # (b) #7 on the nc = 12 crystal's bricks under skewed walls
    eam_ext = ((eh.eam_rho_half_ext, eh.eam_force_half_ext),
               (eh.eam_rho_half_plain, eh.eam_force_half_plain))
    with tempfile.TemporaryDirectory() as d:
        counters_zero()
        ferr, rel, cp, idx3, (slots, args, kw, tables) = eam_lb_bricks(d, dev)
        torch.cuda.synchronize()
        c = all_counters()
    t = eam_compare(f"#7 on brick {idx3} of the nc = {EAM_NC} crystal under "
                    f"walls x 0.42, y 0.58 (ncore {cp.ncore}, cap {cp.cap})",
                    *eam_ext, slots, args, kw, tables, with_bound=True,
                    device=True)
    if c["eam_rho_ext"] != 8 or c["eam_force_ext"] != 8:
        failed.append(f"(b) #7 launches {c['eam_rho_ext']}/"
                      f"{c['eam_force_ext']} for 8 bricks")
    rows["eam_rho_ext_walls"] = ("eam_rho_ext", c["eam_rho_ext"], t["rho"])
    rows["eam_force_ext_walls"] = ("eam_force_ext", c["eam_force_ext"],
                                   t["force"])
    phase("loadbalance", f"(b) nc = {EAM_NC} crystal, 8 bricks under walls "
          f"x 0.42 y 0.58 through #7 ({c['eam_rho_ext']} + "
          f"{c['eam_force_ext']} launches): forces vs Simulation's "
          f"{ferr:.3g} of the scale, e rel {rel:.2g}; "
          f"{time.perf_counter() - T_START:.0f} s")

    # (c) the water box through the mesh at (1,1,1), with and without
    # ZRAMP at LB_RATE; the checkpoint, its restarts, the analyses
    with tempfile.TemporaryDirectory() as d:
        water_deck(d, 6173, 100)
        ps0, rate0, _ = mesh_lb_run(d, dev, "")
        del ps0
        edit_deck(os.path.join(d, "object.data"), lambda text: text + "".join(
            f"{k} ANALYSIS {{ {v} }}\n" for k, v in LB_ANALYSES.items()))
        counters_zero()
        ps, rate, n6 = mesh_lb_run(d, dev, "ZRAMP")
        want = (LB_STEPS - 1) // LB_RATE
        if ps.n_rebalance != want:
            failed.append(f"(c) {ps.n_rebalance} rebalances, want {want}")
        if n6 < LB_STEPS:
            failed.append(f"(c) #6 launched {n6} times in {LB_STEPS} steps")
        e_mesh = ps.first_energy()
        snap = ps.write_checkpoint(d)
        files = sorted(os.listdir(snap))
        saved = read_pxyz_full(os.path.join(snap, "pxyz"))
        run_dir = os.path.join(d, "an")
        os.makedirs(run_dir)
        done = ps.run_analyses(run_dir)
        view = ps.view()
        mesh_an, view_an = ([build_analysis(o.name, o) for o in
                             ps.db.by_class("ANALYSIS")] for _ in range(2))
        for an, gan in zip(mesh_an, view_an):
            (an.eval_sharded(ps) if hasattr(an, "eval_sharded")
             else an.eval(view))
            gan.eval(view)
        mesh_an, view_an = an_states(mesh_an), an_states(view_an)
        # the mesh keeps positions unwrapped between rebuilds, Simulation
        # reads the restart into the box: ZDENSITY's range drops the rows
        # outside, so Simulation's histogram is held to the view's rows
        # wrapped into the box
        n_all = ps.sysdef.state.n_local
        z = view.ss.state.r[:n_all, 2].cpu().numpy()
        Lz = float(view.ss.box.lengths[2])
        zd = [o for o in ps.db.by_class("ANALYSIS") if o.name == "zd"][0]
        zd_wrapped = np.histogram(z - Lz * np.round(z / Lz),
                                  bins=zd.get_int("nBins", 100),
                                  range=(-Lz / 2, Lz / 2))[0].astype(float)
        n_out = int((np.abs(z) > Lz / 2).sum())
        restart = os.path.join(d, "restart")
        sim = Simulation(*load(d, restart=restart), run_dir=d, device=dev)
        sim.first_energy()
        e_sim = float(sim.ss.energy.eion)
        sim_an = [build_analysis(o.name, o) for o in sim.db.by_class(
            "ANALYSIS")]
        for an in sim_an:
            an.eval(sim)
        sim_an = an_states(sim_an)
        ps2 = ParallelSimulation(*load(d, restart=restart), shape=(1, 1, 1),
                                 device=dev)
        e_mesh2 = ps2.first_energy()
        walls2 = ps2.plan.walls
    rel = abs(e_sim - e_mesh) / abs(e_mesh)
    if rel > 2e-5:
        failed.append(f"(c) restart under Simulation: e {e_sim} vs the "
                      f"mesh's {e_mesh}")
    if abs(e_mesh2 - e_mesh) > 2e-5 * abs(e_mesh):
        failed.append(f"(c) restart under the mesh: e {e_mesh2} vs {e_mesh}")
    if any(not np.array_equal(np.asarray(w), saved["walls"][k])
           for k, w in enumerate(walls2)):
        failed.append("(c) the mesh restart did not resume the pxyz walls")
    if "pxyz" not in files or sorted(done) != sorted(LB_ANALYSES):
        failed.append(f"(c) snapshot {files}, analyses {done}")
    errs = []
    for name, st in mesh_an.items():
        for k, v in st.items():
            for what, ref in (("view", view_an[name][k]),
                              ("Simulation", zd_wrapped if name == "zd"
                               else sim_an[name][k])):
                if name in ("gr", "ke", "zd"):
                    ok = np.array_equal(v if what == "view" or name != "zd"
                                        else sim_an[name][k], ref)
                    errs.append(f"{name}.{k} vs {what} "
                                f"{'equal' if ok else 'DIFFER'}")
                else:
                    scale = max(float(np.abs(ref).max()), 1e-30)
                    err = float(np.abs(v - ref).max()) / scale
                    ok = err <= AN_MESH_TOL
                    errs.append(f"{name}.{k} vs {what} {err:.2g}")
                if not ok:
                    failed.append(f"(c) analysis {name}.{k}: mesh vs {what}")
    errs.append(f"{n_out} rows outside the box's z")
    phase("loadbalance", f"(c) water box 6173 beads at (1,1,1): {LB_STEPS} "
          f"steps {rate:.1f} steps/s with ZRAMP rate={LB_RATE} "
          f"({ps.n_rebalance} rebalances, #6 launched {n6} times) vs "
          f"{rate0:.1f} steps/s without load balance (phase 10's box); "
          f"checkpoint {files}; first energy {e_mesh:.8g}, restart under "
          f"Simulation {e_sim:.8g} (rel {rel:.2g}, {sim.engine}), under the "
          f"mesh {e_mesh2:.8g} with the pxyz walls resumed; analyses "
          f"{done}, mesh (sharded) vs the gathered view and vs "
          f"Simulation: {', '.join(errs)}; "
          f"{time.perf_counter() - T_START:.0f} s on {card}")
    return rows


# --- phase 26 (item 25, second part): the mesh's brick list engine --------
# (a) phase 18's (B) table fluid through ParallelSimulation at (1,1,1) on
# the list engine: the first energy against Simulation(engine="nlist")
# on the same state, LISTMESH_STEPS steps with the mean T over the last
# LISTMESH_TAIL in (B)'s window, steps/s beside Simulation's; (b) phase
# 19's (C) tripeptide at (1,1,1): f64 against Simulation's list engine in
# f64, a short f64 NVE run, f32 against f64; (c) the unfitted nc = 12
# TABULAR crystal against Simulation's cell-block EAM engine, then
# LISTMESH_EAM_STEPS steps; (d) phase 25's zRamp bilayer under a (2,2,2)
# VORONOI plan after one balance_step and under a uniform (4,4,2) plan
# of bricks narrower than 2 rlist, every brick through the list engine's
# per-rank functions with its halo filled from the host, against
# Simulation's pair term; (e) a small list-mesh run, card against CPU
LISTMESH_STEPS, LISTMESH_TAIL, LISTMESH_SIM_STEPS = 300, 100, 50
LISTMESH_NVE_STEPS, LISTMESH_EAM_STEPS = 100, 200
# the first energy (relative) and forces (over the scale) of the mesh's
# list engine against Simulation's on one state (both f32, other lists,
# other summation orders): the list engine's f32 floors of phase 18
LISTMESH_E_REL, LISTMESH_F_TOL = 1e-5, 1e-4
LISTMESH_F64_REL = 1e-8
# (d): the bricks' forces over the scale against Simulation's pair term
# (f32 both): the mesh tests' pair tolerance against f64
LISTMESH_BRICK_F_TOL = 2e-5


def mesh_rows(lines):
    """(loop, T) of the mesh's print lines (ParallelSimulation.
    _print_scalars)."""
    import re

    return np.array([(float(ln.split()[0]),
                      float(re.search(r" T=\s*(\S+)", ln).group(1)))
                     for ln in lines], dtype=np.float64)


def list_bricks(a, owner, windows, dev):
    """(d): the bricks of one plan through the list engine's per-rank
    functions (BrickStepList._pool_list's list with n_rows, the excluded
    partners dropped by gid, martini_nonbond on the local rows), each
    brick's pool its owned rows (owner == b) and the rows within its halo
    window (windows[b]: per axis (centre, half width + window) in nm,
    in the load-balance frame a["r_lb"] of a triclinic state a["h"]),
    filled from the host.  Returns (f (n, 3), e, brick sizes)."""
    from ddcmd_tpu_torch.nbr.celllist import CellGrid, build_neighbor_list
    from ddcmd_tpu_torch.parallel.brickstep import (BrickStepList,
                                                    exclusion_gids)
    from ddcmd_tpu_torch.potentials.martini import martini_nonbond

    n = len(a["r"])
    # a triclinic state carries its h, and its positions and spans in the
    # load-balance frame (the fraction scaled by the spans), where the
    # windows are measured
    spans, frame = a.get("spans", a["L"]), a.get("r_lb", a["r"])
    rt = torch.tensor(a["r"], dtype=torch.float32, device=dev)
    Lv = torch.tensor(a.get("h", a["L"]), dtype=torch.float32, device=dev)
    q, tidx = (torch.tensor(a[k], device=dev) for k in ("q", "tidx"))
    gid = torch.arange(n, device=dev)
    exgid = torch.as_tensor(exclusion_gids(a["exclusions"], np.arange(n), n),
                            device=dev)
    grid = CellGrid.plan(spans, a["rcut"], a["skin"], n, n, positions=frame)
    f = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    e = torch.zeros((), dtype=torch.float32, device=dev)
    sizes = []
    for b, win in enumerate(windows):
        own = np.nonzero(owner == b)[0]
        near = np.ones(n, bool)
        for ax, (c, w) in enumerate(win):
            x = frame[:, ax] - c
            near &= np.abs(x - spans[ax] * np.round(x / spans[ax])) < w
        rows = torch.as_tensor(np.concatenate(
            [own, np.nonzero(near & (owner != b))[0]]), device=dev)
        r_pool, pool_gid = rt[rows], gid[rows]
        ones = torch.ones(len(rows), dtype=torch.float32, device=dev)
        nbr, _, ov = build_neighbor_list(r_pool, ones, Lv, grid,
                                         n_rows=len(own))
        assert not bool(ov), f"list overflow in brick {b}"
        nbr = BrickStepList._drop_excluded(nbr, pool_gid, ones > 0,
                                           exgid[rows[:len(own)]])
        fb, eb, _, _, _ = martini_nonbond(
            r_pool, q[rows], tidx[rows], ones, nbr, Lv, a["tables"],
            n_rows=len(own))
        f[rows[:len(own)]] = fb
        e = e + eb
        sizes.append((len(own), len(rows) - len(own)))
    return f, e, sizes


def listmesh_phase(card, dev, counters_zero, all_counters, failed):
    """Phase 26 (ROADMAP item 25, second part): the brick list engine,
    which launches no custom kernel; gates into `failed`."""
    from ddcmd_tpu_torch.core.system import build_system
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.parallel import voronoi as vor
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    quiet = lambda line: None                                  # noqa: E731

    def idle(what):
        c = all_counters()
        if any(c.values()):
            failed.append(f"{what}: kernels launched {c}")

    def errs(got_e, got_f, ref_e, ref_f):
        ref_f = torch.as_tensor(ref_f).double().cpu()
        scale = float(ref_f.abs().max())
        return (abs(got_e - ref_e) / abs(ref_e),
                float((torch.as_tensor(got_f).double().cpu()
                       - ref_f).abs().max()) / scale, scale)

    def mesh(d, **kw):
        ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev, **kw)
        if ps.shard_engine != "nlist":
            failed.append(f"{d}: engine {ps.shard_engine}")
        return ps

    def sim_first(d, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")      # the (C) demotion warning
            s = Simulation(*load(d), run_dir=d, device=dev, **kw)
        s.first_energy()
        n = s.sysdef.state.n_local
        return s, float(s.ss.energy.eion), s.ss.state.f[:n]

    def timed_run(ps, steps):
        lines = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ps.run(steps, print_fn=lines.append)
        torch.cuda.synchronize()
        return lines, steps / (time.perf_counter() - t0)

    # (a) the 131,072-atom table fluid
    with tempfile.TemporaryDirectory() as d:
        table_lj_deck(d, LJ_BIG_N, 10)
        counters_zero()
        ps = mesh(d)
        e = ps.first_energy()
        f = ps.gather_by_gid(("f",))["f"]
        sim, e_ref, f_ref = sim_first(d, engine="nlist")
        e_rel, f_rel, scale = errs(e, f, e_ref, f_ref)
        if e_rel > LISTMESH_E_REL or f_rel > LISTMESH_F_TOL:
            failed.append(f"(a) first energy rel {e_rel}, forces {f_rel}")
        lines, rate = timed_run(ps, LISTMESH_STEPS)
        idle("(a) mesh run")
        rows = mesh_rows(lines)
        temp = float(rows[rows[:, 0] > LISTMESH_STEPS - LISTMESH_TAIL,
                          1].mean())
        if not (np.isfinite(rows).all() and abs(temp - LJ_T) <= TEMP_TOL):
            failed.append(f"(a) mean T {temp}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(LISTMESH_SIM_STEPS, print_fn=quiet,
                max_steps_per_dispatch=DISPATCH)
        torch.cuda.synchronize()
        sim_rate = LISTMESH_SIM_STEPS / (time.perf_counter() - t0)
        phase("listmesh", f"(a) (B) table LJ {LJ_BIG_N} atoms through "
              f"ParallelSimulation (1,1,1) on the list engine (cells "
              f"{ps.grid.ncells} cap {ps.grid.cell_capacity} K "
              f"{ps.grid.max_neighbors}): first energy {e:.9g} vs "
              f"Simulation(engine=nlist) {e_ref:.9g} (rel {e_rel:.2g}, gate "
              f"{LISTMESH_E_REL:g}), forces {f_rel:.3g} of the scale "
              f"{scale:.4g} (gate {LISTMESH_F_TOL:g}); {LISTMESH_STEPS} "
              f"steps: mean T {temp:.2f} K over the last {LISTMESH_TAIL} "
              f"(window {LJ_T:g} +- {TEMP_TOL:g}), {rate:.2f} steps/s (the "
              f"list rebuilt every step) vs Simulation's list engine "
              f"{sim_rate:.2f} steps/s over {LISTMESH_SIM_STEPS} steps; no "
              f"custom kernel launched on {card}")
        del ps, sim

    # (b) the (C) tripeptide: f64, its NVE leg, f32 against f64
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as dn:
        charmm_tripeptide_deck(d, C36_L, C36_MAX_W, dt_fs=1.0)
        counters_zero()
        ps64 = mesh(d, dtype=torch.float64)
        e64 = ps64.first_energy()
        f64 = ps64.gather_by_gid(("f",))["f"]
        _, es, fs = sim_first(d, engine="nlist", dtype=torch.float64)
        rel64, frel64, scale = errs(e64, f64, es, fs)
        if rel64 > LISTMESH_F64_REL:
            failed.append(f"(b) f64 first energy rel {rel64}")
        ps32 = mesh(d)
        e32 = ps32.first_energy()
        rel32, frel32, _ = errs(e32, ps32.gather_by_gid(("f",))["f"], e64,
                                f64)
        if rel32 > NLIST_LJ_GATES[0] or frel32 > NLIST_LJ_GATES[1]:
            failed.append(f"(b) f32 vs f64: e rel {rel32}, forces {frel32}")
        charmm_tripeptide_deck(dn, C36_L, C36_MAX_W, nve=True,
                               dt_fs=C36_NVE_DT)
        psn = mesh(dn, dtype=torch.float64)
        n_c = psn.sysdef.state.n_local

        def etot(ps):
            """Etot of the mesh's current state (first_energy recomputes
            the forces the state already holds)."""
            m = ps.mask
            return ps.first_energy() + float(0.5 * (
                ps.fields["mass"][m, None] * ps.fields["v"][m] ** 2).sum())

        de = [etot(psn)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LISTMESH_NVE_STEPS // C36_NVE_CHUNK):
            psn.run(C36_NVE_CHUNK)
            de.append(etot(psn))
        torch.cuda.synchronize()
        rate = LISTMESH_NVE_STEPS / (time.perf_counter() - t0)
        idle("(b) mesh runs")
        de = np.asarray(de) - de[0]
        # Simulation's f64 list engine on the same deck, its first 100
        # steps read at the same loops: the mesh's reads equal them
        sn, _, _ = sim_first(dn, engine="nlist", dtype=torch.float64)
        sde = [float(sn.ss.energy.eion + sn.ss.energy.rk)]
        for _ in range(100 // C36_NVE_CHUNK):
            sn.run(C36_NVE_CHUNK, print_fn=quiet)
            sde.append(float(sn.ss.energy.eion + sn.ss.energy.rk))
        sde = np.asarray(sde) - sde[0]
        k = min(len(de), len(sde))
        off = float(np.abs(de[:k] - sde[:k]).max())
        t_ns = np.arange(len(de)) * C36_NVE_CHUNK * C36_NVE_DT * 1e-6
        drift = float(np.polyfit(t_ns, de / n_c, 1)[0])
        if not np.isfinite(de).all() or off > C36_NVE_BAND:
            failed.append(f"(b) NVE: {off} kJ/mol off Simulation's reads")
        phase("listmesh", f"(b) (C) c36 tripeptide {n_c} atoms at (1,1,1) "
              f"on the list engine (exclusions masked by gid, "
              f"{int(ps64._exgid.shape[1])} partners a row at most; "
              f"junction and CMAP terms per term): f64 first energy "
              f"{e64:.12g} vs Simulation(engine=nlist, f64) {es:.12g} (rel "
              f"{rel64:.2g}, gate {LISTMESH_F64_REL:g}), forces "
              f"{frel64:.3g} of the scale {scale:.5g}; f32 vs the f64 mesh: e "
              f"rel {rel32:.3g} (gate {NLIST_LJ_GATES[0]:g}), forces "
              f"{frel32:.3g} (gate {NLIST_LJ_GATES[1]:g}); f64 NVE, FREE, dt "
              f"{C36_NVE_DT} fs, {LISTMESH_NVE_STEPS} steps from rest: "
              f"|dEtot| after {(k - 1) * C36_NVE_CHUNK} steps {de[k - 1]:.6g} "
              f"kJ/mol, max {np.abs(de).max():.4g}, drift {drift:.4g} "
              f"kJ/mol/ns/atom (fit over {len(de)} reads); reads over the "
              f"first 100 steps within {off:.3g} kJ/mol of Simulation's (gate "
              f"{C36_NVE_BAND:g}); {rate:.2f} steps/s (a read every "
              f"{C36_NVE_CHUNK}); no custom kernel launched on {card}")
        del ps64, ps32, psn, sn

    # (c) the unfitted TABULAR crystal
    with tempfile.TemporaryDirectory() as d:
        tabular_eam_deck(d, EAM_NC, 10)
        counters_zero()
        ps = mesh(d)
        e = ps.first_energy()
        f = ps.gather_by_gid(("f",))["f"]
        sim, e_ref, f_ref = sim_first(d)
        counters_zero()
        e_rel, f_rel, scale = errs(e, f, e_ref, f_ref)
        if e_rel > NLIST_EAM_GATES[0] or f_rel > NLIST_EAM_GATES[1]:
            failed.append(f"(c) vs cell-block: e rel {e_rel}, forces {f_rel}")
        lines, rate = timed_run(ps, LISTMESH_EAM_STEPS)
        idle("(c) mesh run")
        rows = mesh_rows(lines)
        if not (np.isfinite(rows).all() and ps.loop == LISTMESH_EAM_STEPS):
            failed.append("(c) run")
        phase("listmesh", f"(c) unfitted TABULAR nc = {EAM_NC} crystal "
              f"({ps.sysdef.state.n_local} atoms) at (1,1,1) on the list "
              f"engine: first energy {e:.9g} vs Simulation's {sim.engine} "
              f"engine {e_ref:.9g} (rel {e_rel:.2g}, gate "
              f"{NLIST_EAM_GATES[0]:g}), forces {f_rel:.3g} of the scale "
              f"{scale:.4g} (gate {NLIST_EAM_GATES[1]:g}); "
              f"{LISTMESH_EAM_STEPS} steps, last T {rows[-1, 1]:.2f} K, "
              f"{rate:.2f} steps/s on {card}")
        del ps, sim

    # (d) the zRamp bilayer's bricks: Voronoi (2,2,2), uniform (4,4,2)
    with tempfile.TemporaryDirectory() as d:
        a = bilayer_lb_arrays(d, dev)
        a["exclusions"] = build_system(load(d)[0], d).bonded.exclusions
    L, rl, n = a["L"], a["rlist"], len(a["r"])
    c0 = vor.nominal_centers(L, (2, 2, 2))
    centers, margins = vor.balance_step(c0, a["r"].astype(np.float64), L,
                                        (2, 2, 2), rl)
    plans = [("VORONOI (2,2,2) after one balance_step",
              vor.assign_host(a["r"], centers, L, (2, 2, 2)),
              [[(c0.reshape(-1, 3)[b, ax], L[ax] / 4 + rl + margins[ax])
                for ax in range(3)] for b in range(8)])]
    shape = (4, 4, 2)
    fr = a["r"] / L + 0.5
    cj = [np.clip(np.floor((fr[:, ax] - np.floor(fr[:, ax])) * shape[ax]
                           ).astype(int), 0, shape[ax] - 1) for ax in range(3)]
    plans.append((f"uniform {shape}, bricks {np.round(L / shape, 3).tolist()} "
                  f"nm (2 rlist {2 * rl:.2f})",
                  (cj[0] * shape[1] + cj[1]) * shape[2] + cj[2],
                  [[((i3[ax] + 0.5) * L[ax] / shape[ax] - 0.5 * L[ax],
                     L[ax] / shape[ax] / 2 + rl) for ax in range(3)]
                   for i3 in np.ndindex(*shape)]))
    for what, owner, windows in plans:
        counters_zero()
        f, e, sizes = list_bricks(a, owner, windows, dev)
        torch.cuda.synchronize()
        idle(f"(d) {what}")
        try:
            ferr, rel = held(f"(d) {what}", f, e, a["f_ref"], a["e_ref"],
                             LISTMESH_BRICK_F_TOL)
        except AssertionError as err:
            failed.append(str(err))
            ferr = rel = float("nan")
        own = [s[0] for s in sizes]
        phase("listmesh", f"(d) zRamp bilayer {n} beads, {what}: "
              f"{len(sizes)} bricks through the list engine's per-rank "
              f"functions (owned {min(own)}-{max(own)}, ghosts "
              f"{min(s[1] for s in sizes)}-{max(s[1] for s in sizes)}; "
              f"margins {np.round(margins, 3).tolist()} nm): forces vs "
              f"Simulation's pair term ({a['engine']}) {ferr:.3g} of the "
              f"scale (gate {LISTMESH_BRICK_F_TOL:g}), e {float(e):.8g} vs "
              f"{a['e_ref']:.8g} (rel {rel:.2g}, gate {LB_E_REL:g}) on "
              f"{card}")
    del a

    # (e) card against CPU: the 400-bead water box, FREE, 40 steps
    out = {}
    os.environ["DDCMD_SHARD_ENGINE"] = "nlist"
    try:
        for where in ("cuda", "cpu"):
            with tempfile.TemporaryDirectory() as d:
                water_deck(d, 400, printrate=100, free=True)
                ps = ParallelSimulation(*load(d), shape=(1, 1, 1),
                                        device=where)
                e0 = ps.first_energy()
                ps.run(40)
                g = ps.gather_by_gid(("r",))
                out[where] = (e0, ps.first_energy(), g["r"], ps.shard_engine,
                              ps._live_L())
    finally:
        del os.environ["DDCMD_SHARD_ENGINE"]
    (a0, a1, ra, ea, Lw), (b0, b1, rb, eb, _) = out["cuda"], out["cpu"]
    dr = ra - rb
    dr = float(np.abs(dr - Lw * np.round(dr / Lw)).max())
    ok = (ea == eb == "nlist" and math.isclose(a0, b0, rel_tol=1e-5)
          and math.isclose(a1, b1, rel_tol=1e-4) and dr < 1e-3)
    if not ok:
        failed.append(f"(e) card vs CPU: {a0} {b0} {a1} {b1} {dr}")
    phase("listmesh", f"(e) water 400 beads FREE at (1,1,1) on the list "
          f"engine, 40 steps, card vs CPU: first energy {a0:.8g} vs "
          f"{b0:.8g}, after {a1:.8g} vs {b1:.8g}, max |dr| {dr:.3g} nm; "
          f"{time.perf_counter() - T_START:.0f} s on {card}")


# --- phase 27 (item 25, the last of the JAX mesh): triclinic bricks and --
# the 1-D slab engine (plain PyTorch, no kernel).  (a) the water box with
# its b vector tilted by TRI_TILT L (same fractions, same density) through
# ParallelSimulation at (1,1,1) on the list engine: its first energy and
# forces against Simulation(engine="nlist"), TRI_STEPS steps with the mean
# T over the last TRI_TAIL, steps/s over the last TRI_SIM_STEPS beside
# Simulation's list engine restarted from the mesh's checkpoint there; (b)
# phase 25's zRamp bilayer tilted the same way, its bricks under a uniform,
# a ZRAMP and a VORONOI (2,2,2) plan (one balance_step) through the list
# engine's per-rank functions, halos from the host, windows in the
# fraction, against Simulation's pair term on the list engine; (c) the
# NPT water deck tilted, TRI_STEPS steps through the mesh in f64: the
# box, the tilt ratio, the mean T; (d) the water box in SLAB_N
# x-slabs, uniform and between ZRAMP walls, through the slab step's
# per-rank forces (parallel/step.pool_forces) with host halos against the
# single-device list, then SLAB_STEPS steps of make_sharded_step at one
# slab in f64 on the same box, FREE, the first SLAB_CMP against
# Simulation's list engine
TRI_TILT = 0.2
TRI_STEPS, TRI_TAIL, TRI_SIM_STEPS = 1000, 500, 200
# (a), (c): the mesh's first energy (relative) and forces (of the scale)
# against Simulation's on one state; (b): the bricks against Simulation's
# pair term; (c): the tilt ratio h01 / h00 against its start
TRI_E_REL, TRI_F_TOL = 2e-5, 1e-5
TRI_BRICK_F_TOL, TRI_BRICK_E_REL = 2e-5, 1e-6
TRI_RATIO_REL = 1e-6
# (d): SLAB_N slabs, forces over the scale of the single-device list; one
# slab SLAB_STEPS steps, its first SLAB_CMP (one migration) against
# Simulation's in f64 (an f32 pair of runs parts by ~2e-2 nm in 200 steps
# of a water box: the dynamics is chaotic)
SLAB_N, SLAB_F_TOL, SLAB_STEPS, SLAB_CMP, SLAB_DR = 4, 1e-5, 200, 20, 1e-5


def tilt_deck(d, tilt=TRI_TILT):
    """Tilt the deck in d: its BOX's b vector by tilt Lx in x (tilt_edit)
    and every position of atoms#000000 with it, x' = x + tilt (Lx / Ly) y
    (the same fractions, the same density); the file header's h too."""
    import re

    p = os.path.join(d, "object.data")
    with open(p) as f:
        text = f.read()
    m = re.search(r"h= (\S+) 0 0 0 (\S+) 0 0 0 (\S+) ;", text)
    k = tilt * float(m.group(1)) / float(m.group(2))
    with open(p, "w") as f:
        f.write(tilt_edit(text, tilt))
    a = os.path.join(d, "atoms#000000")
    with open(a) as f:
        head, body = f.read().split("}\n", 1)
    names = re.search(r"field_names=([^;]*);", head).group(1).split()
    ix, iy = names.index("rx"), names.index("ry")
    hm = re.search(r"h= (.*?) ;", head)
    h = [float(x) for x in hm.group(1).split()]
    h[1] = tilt * h[0]
    head = head.replace(hm.group(0), "h= " + " ".join(
        f"{x:.6f}" for x in h) + " ;")
    rows = []
    for line in body.split("\n"):
        tok = line.split()
        if len(tok) == len(names):
            tok[ix] = f"{float(tok[ix]) + k * float(tok[iy]):.8f}"
            line = " ".join(tok)
        rows.append(line)
    with open(a, "w") as f:
        f.write(head + "}\n" + "\n".join(rows))


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def tilted_bilayer_arrays(d, dev):
    """(b): phase 25's zRamp bilayer (LB_BILAYER) tilted by TRI_TILT: its
    start state on the host with the h, the perpendicular spans and the
    positions of the load-balance frame (the fraction scaled by the
    spans), its exclusions, and Simulation's pair term on it (the list
    engine, f32 and f64: the forces, the energy)."""
    from ddcmd_tpu_torch.core.system import build_system
    from ddcmd_tpu_torch.models import load, martini_bilayer
    from ddcmd_tpu_torch.potentials.martini import martini_device_tables
    from ddcmd_tpu_torch.run.parallel_sim import lb_frame
    from ddcmd_tpu_torch.run.simulate import Simulation

    martini_bilayer(d, **LB_BILAYER)
    tilt_deck(d)
    sd = build_system(load(d)[0], d)
    n = sd.state.n_local
    parms = sd.potentials[0][2]
    h = sd.box.h.numpy().astype(np.float64)
    r = sd.state.r[:n].numpy()
    spans, r_lb = lb_frame(h, r)
    a = dict(r=r, q=sd.state.q[:n].numpy(), h=h, L=np.diagonal(h).copy(),
             spans=spans, r_lb=r_lb,
             tidx=parms.species_lj_type[sd.state.species[:n].numpy()],
             exclusions=sd.bonded.exclusions, rcut=sd.rcut_max,
             skin=sd.neighbor_deltaR, rlist=sd.rcut_max + sd.neighbor_deltaR,
             tables=martini_device_tables(parms, device=dev))
    # the reference: Simulation's list engine in f32, the bricks'
    # arithmetic; and in f64, against which both f32 list evaluations of
    # this tilted state sit ~2.2e-5 of the force scale off (the h's
    # minimum image in f32)
    for key, dtype in (("", torch.float32), ("_f64", torch.float64)):
        sim = Simulation(*load(d), run_dir=d, device=dev, engine="nlist",
                         dtype=dtype)
        ss, handle, ov = sim._build_nbr(sim.ss)
        assert not bool(ov)
        fr, er, _, _ = sim.force_fn.terms[0](ss.state, ss.box, handle)
        a.update({f"f_ref{key}": fr[:n].double(), f"e_ref{key}": float(er)})
    a["engine"] = sim.engine
    return a


def tilted_plans(a, shape=(2, 2, 2)):
    """(b): [(name, owner per row, windows per brick)] of a uniform, a
    ZRAMP and a VORONOI plan of the tilted state `a`, windows per axis
    (centre, half width + rlist (+ the Voronoi margin)) in the
    load-balance frame, the owners as ParallelSimulation assigns them."""
    from ddcmd_tpu_torch.parallel import voronoi as vor
    from ddcmd_tpu_torch.parallel.loadbalance import walls_assign

    S, rl = a["spans"], a["rlist"]
    fr = a["r_lb"] / S + 0.5
    fr = fr - np.floor(fr)
    ravel = np.ravel_multi_index
    bricks = list(np.ndindex(*shape))
    out = []
    walls = lb_walls("ZRAMP", a["r_lb"], S, shape, rl)
    for name, w in (("uniform", None), ("ZRAMP", walls)):
        if w is None:
            cj = [np.clip(np.floor(fr[:, ax] * shape[ax]).astype(int), 0,
                          shape[ax] - 1) for ax in range(3)]
            w = [np.linspace(0.0, 1.0, n + 1) for n in shape]
        else:
            cj = walls_assign(fr, w, shape)
        owner = ravel(tuple(cj), shape)
        windows = [[((w[ax][i3[ax]] + w[ax][i3[ax] + 1] - 1.0) / 2 * S[ax],
                     (w[ax][i3[ax] + 1] - w[ax][i3[ax]]) / 2 * S[ax] + rl)
                    for ax in range(3)] for i3 in bricks]
        out.append((f"{name} {shape}", owner, windows))
    c0 = vor.nominal_centers(S, shape)
    centers, margins = vor.balance_step(c0, a["r_lb"].astype(np.float64), S,
                                        shape, rl)
    out.append((f"VORONOI {shape} after one balance_step (margins "
                f"{np.round(margins, 3).tolist()} nm)",
                vor.assign_host(a["r_lb"], centers, S, shape),
                [[(c0[i3][ax], S[ax] / shape[ax] / 2 + rl + margins[ax])
                  for ax in range(3)] for i3 in bricks]))
    return out


def slab_rows(a, plan):
    """(d): [(owned rows, ghost rows)] of each slab of `plan` over the
    water state `a`: the owners distribute gives; the ghosts the rows that
    parallel/slab.halo_exchange ships to the slab, by its send_masks, the
    -1 neighbour's toward it first, then the +1 neighbour's."""
    from ddcmd_tpu_torch.parallel.slab import (distribute, send_masks,
                                               slab_bounds)

    n, Lx, k = len(a["r"]), float(a["L"][0]), plan.n_dev
    buf, _, counts = distribute({"r": a["r"], "i": np.arange(n)}, Lx, plan)
    own = [buf["i"][s * plan.local_cap:s * plan.local_cap + counts[s]]
           for s in range(k)]
    ships = []
    for s in range(k):
        lo, hi = send_masks(torch.as_tensor(a["r"][own[s], 0]),
                            torch.ones(len(own[s]), dtype=torch.bool), Lx,
                            plan, s)
        ships.append((own[s][lo.numpy()], own[s][hi.numpy()]))
    out = []
    for s in range(k):
        ghost = np.concatenate([ships[(s - 1) % k][1], ships[(s + 1) % k][0]])
        # a slab's halo is the rows within rlist of its faces (the wrapped
        # distance from its centre under half its width + rlist), not the
        # rest of the box
        lo, hi = slab_bounds(Lx, k, s, plan.walls)
        d = a["r"][ghost, 0] - 0.5 * (lo + hi)
        d = np.abs(d - Lx * np.round(d / Lx))
        assert (d < 0.5 * (hi - lo) + plan.rlist + 1e-5).all(), f"slab {s}"
        assert len(ghost) < n - len(own[s]), (
            f"slab {s}: {len(ghost)} ghosts of {n - len(own[s])} rows")
        out.append((own[s], ghost))
    return out


def slab_phase_forces(a, plan, dev):
    """(d): every slab of `plan` through parallel/step.pool_forces with its
    halo filled from the host: (forces by row, e, [(owned, ghosts)])."""
    from ddcmd_tpu_torch.nbr.celllist import CellGrid
    from ddcmd_tpu_torch.parallel.step import pool_forces

    n = len(a["r"])
    rt = torch.tensor(a["r"], dtype=torch.float32, device=dev)
    q = torch.tensor(a["q"], dtype=torch.float32, device=dev)
    sp = torch.tensor(a["species"], device=dev)
    tmap = torch.tensor(a["tmap"], device=dev)
    Lv = torch.tensor(a["L"], dtype=torch.float32, device=dev)
    grid = CellGrid.plan(a["L"], a["rcut"], a["skin"], n, n,
                         positions=a["r"])
    f = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    e = torch.zeros((), dtype=torch.float32, device=dev)
    sizes = []
    for own, ghost in slab_rows(a, plan):
        rows = torch.as_tensor(np.concatenate([own, ghost]), device=dev)
        m = torch.ones(len(own), dtype=torch.bool, device=dev)
        gm = torch.ones(len(ghost), dtype=torch.bool, device=dev)
        fs, es, _, _, ov = pool_forces(rt[rows], q[rows], sp[rows], m, gm, Lv,
                                       grid, a["tables"], tmap)
        assert not bool(ov), "list overflow in a slab"
        f[rows[:len(own)]] = fs
        e = e + es
        sizes.append((len(own), len(ghost)))
    return f, e, sizes


def slab_run(d, where, steps, snap=SLAB_CMP):
    """(d): the deck in d (the water box, FREE) through make_sharded_step
    at one slab in f64 on `where`, `steps` steps with a migration every
    updateRate: (positions by gid after `snap` steps, the box, the first
    energy, [e_pot, rk, tr virial] after `snap` steps and after the last,
    any overflow, steps/s)."""
    from ddcmd_tpu_torch.core.system import build_system
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.nbr.celllist import CellGrid
    from ddcmd_tpu_torch.parallel.slab import SlabPlan, collect, distribute
    from ddcmd_tpu_torch.parallel.step import make_mesh, make_sharded_step
    from ddcmd_tpu_torch.potentials.martini import martini_device_tables

    f64 = torch.float64
    sd = build_system(load(d)[0], d, dtype=f64)
    n = sd.state.n_local
    parms = sd.potentials[0][2]
    L = sd.box.lengths.numpy().astype(np.float64)
    plan = SlabPlan(n_dev=1, local_cap=n, halo_cap=8, migrate_cap=8,
                    rlist=sd.rcut_max + sd.neighbor_deltaR)
    step, first, migrate = make_sharded_step(
        make_mesh(1, where), plan,
        CellGrid.plan(L, sd.rcut_max, sd.neighbor_deltaR, n, n),
        martini_device_tables(parms, dtype=f64, device=where),
        sd.group_table.coefficients(0.0, 0.5 * sd.cfg.dt, dtype=f64,
                                    device=where),
        sd.cfg.dt, L, parms.species_lj_type, n, seed=sd.random_seed)
    arrays = {k: getattr(sd.state, k)[:n].numpy()
              for k in ("r", "v", "q", "mass", "species", "group")}
    buf, mask, _ = distribute(dict(arrays, gid=np.arange(n)), float(L[0]),
                              plan)
    fields = {k: torch.as_tensor(v, device=where) for k, v in buf.items()}
    mask = torch.as_tensor(mask, device=where)
    f, e0, _, ov = first(fields, mask)
    k = max(1, int(sd.cfg.ddc_update_rate))
    _sync(where)
    t0 = time.perf_counter()
    for i in range(steps):
        fields, f, scal, ov_s = step(fields, mask, f, i)
        ov = ov | ov_s
        if (i + 1) % k == 0:
            fields, mask, f, ov_m = migrate(fields, mask, f)
            ov = ov | ov_m
        if i + 1 == snap:
            got = collect(fields, mask, plan)
            r = np.zeros((n, 3))
            r[got["gid"]] = got["r"]
            scal_snap = scal.double().cpu().numpy()
    _sync(where)
    rate = steps / (time.perf_counter() - t0)
    return (r, L, float(e0), scal_snap, scal.double().cpu().numpy(),
            bool(ov), rate)


def triclinic_slab_phase(card, dev, counters_zero, all_counters, failed):
    """Phase 27 (ROADMAP item 25, the last of what the JAX mesh has):
    triclinic bricks and the slab engine, no custom kernel; gates into
    `failed`."""
    from ddcmd_tpu_torch.core.system import build_system
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.parallel.loadbalance import zramp_walls
    from ddcmd_tpu_torch.parallel.slab import SlabPlan
    from ddcmd_tpu_torch.potentials.martini import martini_device_tables
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    t_phase = time.perf_counter()
    quiet = lambda line: None                                  # noqa: E731

    def idle(what):
        c = all_counters()
        if any(c.values()):
            failed.append(f"{what}: kernels launched {c}")

    def mesh_vs_sim(d, dtype=torch.float32, **kw):
        """The mesh at (1,1,1) and Simulation on the deck in d, in dtype:
        (mesh, Simulation, e, e_ref, e rel, forces over the scale)."""
        ps = ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev,
                                dtype=dtype)
        if ps.shard_engine != "nlist" or ps.sysdef.box.ortho:
            failed.append(f"{d}: engine {ps.shard_engine}, ortho "
                          f"{ps.sysdef.box.ortho}")
        e = ps.first_energy()
        f = torch.as_tensor(ps.gather_by_gid(("f",))["f"]).double()
        sim = Simulation(*load(d), run_dir=d, device=dev, dtype=dtype, **kw)
        sim.first_energy()
        e_ref = float(sim.ss.energy.eion)
        f_ref = sim.ss.state.f[:sim.sysdef.state.n_local].double().cpu()
        return (ps, sim, e, e_ref, abs(e - e_ref) / abs(e_ref),
                float((f - f_ref).abs().max() / f_ref.abs().max()))

    def timed(fn, steps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        return steps / (time.perf_counter() - t0)

    # (a) the tilted water box at (1,1,1)
    with tempfile.TemporaryDirectory() as d:
        water_deck(d, 6173, printrate=10)
        tilt_deck(d)
        counters_zero()
        ps, sim, e, e_ref, rel, ferr = mesh_vs_sim(d, engine="nlist")
        if rel > TRI_E_REL or ferr > TRI_F_TOL:
            failed.append(f"(a) first energy rel {rel}, forces {ferr}")
        del sim
        # both rates from one thermalised state over one step count: the
        # mesh's last TRI_SIM_STEPS, and Simulation restarted from the
        # mesh's checkpoint before them
        lines = []
        ps.run(TRI_STEPS - TRI_SIM_STEPS, print_fn=lines.append)
        ps.write_checkpoint(d)
        rate = timed(lambda: ps.run(TRI_SIM_STEPS, print_fn=lines.append),
                     TRI_SIM_STEPS)
        rows = mesh_rows(lines)
        temp = float(rows[rows[:, 0] > TRI_STEPS - TRI_TAIL, 1].mean())
        if not (np.isfinite(rows).all() and abs(temp - 310.0) <= TEMP_TOL
                and ps.loop == TRI_STEPS):
            failed.append(f"(a) mean T {temp}")
        sim = Simulation(*load(d, restart=os.path.join(d, "restart")),
                         run_dir=d, device=dev, engine="nlist")
        sim.first_energy()
        sim_rate = timed(lambda: sim.run(TRI_SIM_STEPS, print_fn=quiet,
                                         max_steps_per_dispatch=DISPATCH),
                         TRI_SIM_STEPS)
        idle("(a)")
        h = ps.Lv.double().cpu().numpy()
        phase("triclinic", f"(a) martini_water 6173 beads, b tilted by "
              f"{TRI_TILT} L (h01 {10 * h[0, 1]:.4f} A), through "
              f"ParallelSimulation (1,1,1) on the list engine (cells "
              f"{ps.grid.ncells} cap {ps.grid.cell_capacity} K "
              f"{ps.grid.max_neighbors}): first energy {e:.9g} vs "
              f"Simulation(engine=nlist) {e_ref:.9g} (rel {rel:.2g}, gate "
              f"{TRI_E_REL:g}), forces {ferr:.3g} of the scale (gate "
              f"{TRI_F_TOL:g}); {TRI_STEPS} LANGEVIN steps: mean T "
              f"{temp:.2f} K over the last {TRI_TAIL} (window 310 +- "
              f"{TEMP_TOL:g}); over steps {TRI_STEPS - TRI_SIM_STEPS}-"
              f"{TRI_STEPS} {rate:.2f} steps/s (halo and list every step) "
              f"vs Simulation's list engine {sim_rate:.2f} steps/s over "
              f"{TRI_SIM_STEPS} steps from the mesh's checkpoint at step "
              f"{TRI_STEPS - TRI_SIM_STEPS}; no custom kernel launched on "
              f"{card}")
        del ps, sim

    # (b) the tilted zRamp bilayer's bricks: uniform, ZRAMP, VORONOI
    with tempfile.TemporaryDirectory() as d:
        a = tilted_bilayer_arrays(d, dev)
    for what, owner, windows in tilted_plans(a):
        counters_zero()
        f, e, sizes = list_bricks(a, owner, windows, dev)
        _sync(dev)
        idle(f"(b) {what}")
        f = f.double().cpu()
        scale = max(1.0, float(a["f_ref"].abs().max()))
        ferr = float((f - a["f_ref"].cpu()).abs().max()) / scale
        f64err = float((f - a["f_ref_f64"].cpu()).abs().max()) / scale
        rel = abs(float(e) - a["e_ref"]) / abs(a["e_ref"])
        if ferr > TRI_BRICK_F_TOL or rel > TRI_BRICK_E_REL:
            failed.append(f"(b) {what}: forces {ferr}, e rel {rel}")
        own = [s[0] for s in sizes]
        phase("triclinic", f"(b) zRamp bilayer {len(a['r'])} beads tilted "
              f"by {TRI_TILT} L, {what}: {len(sizes)} bricks through the list "
              f"engine's per-rank functions, windows in the fraction (owned "
              f"{min(own)}-{max(own)}, ghosts {min(s[1] for s in sizes)}-"
              f"{max(s[1] for s in sizes)}): forces vs Simulation's pair term "
              f"({a['engine']}, f32) {ferr:.3g} of the scale (gate "
              f"{TRI_BRICK_F_TOL:g}; vs its f64 {f64err:.3g}), e "
              f"{float(e):.8g} vs {a['e_ref']:.8g} (rel {rel:.2g}, gate "
              f"{TRI_BRICK_E_REL:g}; f64 {a['e_ref_f64']:.8g}) on {card}")
    del a

    # (c) the tilted NPT water deck at (1,1,1), in f64: in f32 each step
    # rounds h01 and h00 apart, and their ratio walks ~5e-8 a step
    with tempfile.TemporaryDirectory() as d:
        npt_water_deck(d, 6173, printrate=10)
        tilt_deck(d)
        counters_zero()
        ps, sim, e, e_ref, rel, ferr = mesh_vs_sim(d, torch.float64)
        del sim
        if rel > TRI_E_REL:
            failed.append(f"(c) first energy rel {rel}")
        h0 = ps.Lv.double().cpu().numpy()
        lines = []
        rate = timed(lambda: ps.run(TRI_STEPS, print_fn=lines.append),
                     TRI_STEPS)
        idle("(c)")
        h1 = ps.Lv.double().cpu().numpy()
        loops, temps, _, press, vols = mesh_lines(lines)
        sel = loops > TRI_STEPS - TRI_TAIL
        temp = float(temps[sel].mean())
        ratio = (h1[0, 1] / h1[0, 0]) / (h0[0, 1] / h0[0, 0]) - 1.0
        box = np.diagonal(h1) / np.diagonal(h0) - 1.0
        if not (np.isfinite(h1).all() and np.abs(box).max() <= 0.2
                and abs(ratio) <= TRI_RATIO_REL
                and abs(temp - 310.0) <= TEMP_TOL and ps.barostat):
            failed.append(f"(c) box {box}, tilt ratio {ratio}, T {temp}")
        phase("triclinic", f"(c) NPT water 6173 beads (NGLFCONSTRAINT P0 1 "
              f"bar) tilted by {TRI_TILT} L through the mesh at (1,1,1) in "
              f"f64: first energy {e:.12g} vs Simulation ({e_ref:.12g}, rel "
              f"{rel:.2g}, gate {TRI_E_REL:g}); {TRI_STEPS} steps: h "
              f"diagonal {np.round(10 * np.diagonal(h0), 4).tolist()} -> "
              f"{np.round(10 * np.diagonal(h1), 4).tolist()} A (+-20%), tilt "
              f"ratio h01/h00 moved {ratio:.3g} (gate {TRI_RATIO_REL:g}), "
              f"mean T {temp:.2f} K and P {press[sel].mean():.4g} over the "
              f"last {TRI_TAIL}; {rate:.2f} steps/s on {card}")
        del ps

    # (d) the slab engine: SLAB_N slabs of the water box, then one slab
    # card vs CPU
    with tempfile.TemporaryDirectory() as d:
        water_deck(d, 6173, printrate=10)
        sd = build_system(load(d)[0], d)
    n = sd.state.n_local
    parms = sd.potentials[0][2]
    a = dict(r=sd.state.r[:n].numpy(), q=sd.state.q[:n].numpy(),
             species=sd.state.species[:n].numpy(),
             tmap=np.asarray(parms.species_lj_type),
             L=sd.box.lengths.numpy().astype(np.float64), rcut=sd.rcut_max,
             skin=sd.neighbor_deltaR,
             tables=martini_device_tables(parms, device=dev))
    rl = sd.rcut_max + sd.neighbor_deltaR
    Lx = float(a["L"][0])
    f_ref, e_ref, _ = slab_reference(a, dev)
    scale = float(f_ref.abs().max())
    for name, walls in (("uniform", None),
                        ("ZRAMP", tuple(zramp_walls(a["r"][:, 0], -Lx / 2,
                                                    Lx, SLAB_N,
                                                    work_power=1)))):
        plan = SlabPlan(n_dev=SLAB_N, local_cap=n, halo_cap=n,
                        migrate_cap=256, rlist=rl, walls=walls)
        counters_zero()
        f, e, sizes = slab_phase_forces(a, plan, dev)
        _sync(dev)
        idle(f"(d) {name}")
        ferr = float((f.double().cpu() - f_ref).abs().max()) / scale
        rel = abs(float(e) - e_ref) / abs(e_ref)
        if ferr > SLAB_F_TOL or rel > TRI_E_REL:
            failed.append(f"(d) {name} slabs: forces {ferr}, e rel {rel}")
        shown = np.round(walls, 4).tolist() if walls else "uniform"
        phase("triclinic", f"(d) water 6173 beads in {SLAB_N} {name} "
              f"x-slabs (walls {shown}; owned "
              f"{[s[0] for s in sizes]}, ghosts {[s[1] for s in sizes]}) "
              f"through the slab step's per-rank forces with host halos: "
              f"forces vs the single-device list {ferr:.3g} of the scale "
              f"{scale:.4g} (gate {SLAB_F_TOL:g}), e {float(e):.9g} vs "
              f"{e_ref:.9g} (rel {rel:.2g}) on {card}")
    with tempfile.TemporaryDirectory() as d:
        water_deck(d, 6173, printrate=10, free=True)
        counters_zero()
        ra, Ls, a0, sa, sa_end, ov, rate = slab_run(d, dev, SLAB_STEPS)
        sim = Simulation(*load(d), run_dir=d, device=dev, engine="nlist",
                         dtype=torch.float64)
        sim.first_energy()
        b0 = float(sim.ss.energy.eion)
        sim.run(SLAB_CMP, print_fn=quiet, max_steps_per_dispatch=DISPATCH)
        idle("(d) one slab")
    st = sim.ss.state
    rb = np.zeros_like(ra)
    rb[torch.as_tensor(st.gid[:len(ra)]).cpu().numpy()] = (
        st.r[:len(ra)].cpu().numpy())
    dr = ra - rb
    dr = float(np.abs(dr - Ls * np.round(dr / Ls)).max())
    b1 = float(sim.ss.energy.eion)
    e_cmp, e_end = sa[0] + sa[1], sa_end[0] + sa_end[1]
    if (ov or dr >= SLAB_DR or not np.isfinite(sa_end).all()
            or not math.isclose(sa[0], b1, rel_tol=1e-9)):
        failed.append(f"(d) one slab vs Simulation: |dr| {dr}, e_pot "
                      f"{sa[0]} {b1}")
    phase("triclinic", f"(d) water 6173 beads FREE, one slab, "
          f"{SLAB_STEPS} f64 steps of make_sharded_step (a migration every "
          f"updateRate, {rate:.2f} steps/s), the first {SLAB_CMP} against "
          f"Simulation(engine=nlist, f64): first energy {a0:.12g} vs "
          f"{b0:.12g}, e_pot at step {SLAB_CMP} {sa[0]:.12g} vs {b1:.12g}, "
          f"max |dr| {dr:.3g} nm (gate {SLAB_DR:g}); e_pot + rk "
          f"{e_cmp:.12g} at step {SLAB_CMP}, {e_end:.12g} at step "
          f"{SLAB_STEPS} (drift {(e_end - e_cmp) / abs(e_cmp):.3g} "
          f"relative); phase 27 {time.perf_counter() - t_phase:.1f} s on "
          f"{card}")


def slab_reference(a, dev):
    """(d): the single-device list on the water state (f32): (forces
    (n, 3) f64 on the host, energy, the list's overflow)."""
    from ddcmd_tpu_torch.nbr.celllist import CellGrid, build_neighbor_list
    from ddcmd_tpu_torch.potentials.martini import martini_nonbond

    n = len(a["r"])
    r = torch.tensor(a["r"], dtype=torch.float32, device=dev)
    Lv = torch.tensor(a["L"], dtype=torch.float32, device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    grid = CellGrid.plan(a["L"], a["rcut"], a["skin"], n, n,
                         positions=a["r"])
    nbr, _, ov = build_neighbor_list(r, ones, Lv, grid)
    assert not bool(ov), "single-device list overflow"
    f, e, _, _, _ = martini_nonbond(
        r, torch.tensor(a["q"], dtype=torch.float32, device=dev),
        torch.tensor(a["tmap"], device=dev)[torch.tensor(a["species"],
                                                         device=dev)],
        ones, nbr, Lv, a["tables"])
    return f.double().cpu(), float(e), bool(ov)


# --- phase 28: the mesh's outputs at their rates and migrate_rate ----------
# (a) the water box (6,173 beads, f32, #6) at (1,1,1) with phase 23's
# WATER_ANALYSES, printStress, printGraphs and two LANGEVIN groups (x < 0
# and the rest; printrate 100), OUT_STEPS steps beside the same deck
# without outputs; (b) the same outputs in f64 on a FREE deck at rates
# the 20-step cadence divides (OUT_B_RATES), OUT_B_STEPS steps through
# the mesh's list engine and through Simulation(engine="nlist"), from the
# deck's start; (c) the NPT water deck (f64) OUT_C_STEPS steps at the
# default cadence and with migrate_rate = 2 chunk_steps, then (a)'s run
# continued OUT_C_STEPS steps under NVT with migrate_rate = 2 chunk_steps
# (per-step dispatches on #6); (d) #6 against its plain version on (a)'s
# last records and on the NVT leg's
OUT_STEPS, OUT_B_STEPS, OUT_C_STEPS, OUT_WARM = 1000, 100, 200, 100
OUT_B_RATES = "eval_rate=20; outputrate=100;"


def outputs_deck(d, n, free=False, rates=None, outputs=True, npt=False):
    """The water box (n beads) with two groups, `solvent` (x < 0) and
    `half`, LANGEVIN at 310 K or FREE, printrate 100; with `outputs`
    phase 23's WATER_ANALYSES (every rate replaced by `rates` when
    given), printStress and printGraphs; `npt`: the NPT water deck."""
    make = npt_water_deck if npt else water_deck
    deck = make(d, n, printrate=100, free=free)
    if outputs:
        objects = WATER_ANALYSES if rates is None else {
            k: " ".join(w for w in v.split() if not w.startswith(
                ("eval_rate=", "outputrate="))) + " " + rates
            for k, v in WATER_ANALYSES.items()}
        edit_deck(deck, lambda t: analyses_edit(objects, print_stress=True)(
            t).replace("printStress=1;", "printStress=1; printGraphs=1;"))
    body = "type=FREE;" if free else "type=LANGEVIN; Teq=310.0K; tau=1.0ps;"
    return regroup(d, {"solvent": body, "half": body},
                   lambda r: np.where(r[:, 0] < 0, "solvent", "half"),
                   printrate=100)


def outputs_phase(card, dev, counters_zero, all_counters, failed,
                  n_water=6173):
    """Phase 28: ParallelSimulation's outputs at their rates and
    run(migrate_rate=) on the card (see the constants above).  Gates go
    into `failed`.  Returns {kernels JSON row: (entry, launches,
    comparison)}: #6 with (a)'s launches on (a)'s last records, and with
    (c)'s NVT leg's launches on that leg's last records."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.objects import units as U
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    t_phase = time.perf_counter()
    quiet = lambda line: None                                  # noqa: E731

    def gate(ok, what):
        if not ok:
            failed.append(f"phase 28 {what}")

    def mesh(d, **kw):
        return ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev,
                                  run_dir=d, **kw)

    def multiples(r, end, start=0):
        return list(range(start - start % r + r, end + 1, r))

    def compare_ext(ps, what):
        """#6 against its plain version on ps's current records."""
        kernel, args, kw = ps.step_fn.kernel_inputs(ps.fields, ps.mask)
        cp = ps.cplan
        assert kernel is ch.cellpair_half_ext
        return compare(f"{what}, {cp.n_prog} core cells, cap {cp.cap}",
                       ch.cellpair_half_ext, ch.cellpair_half_plain, args,
                       kw, with_bound=True)

    keep = tempfile.mkdtemp()
    try:
        # --- (a) the water box on #6 with its outputs -----------------------
        d0, d = os.path.join(keep, "a0"), os.path.join(keep, "a")
        os.makedirs(d0)
        os.makedirs(d)
        outputs_deck(d0, n_water, outputs=False)
        outputs_deck(d, n_water)
        # steps/s by the host clock around run(), the outputs' host work
        # included; the bare deck after OUT_WARM warm-up steps
        bare = mesh(d0)
        bare.run(OUT_WARM, print_fn=quiet)
        t0 = time.perf_counter()
        bare.run(OUT_STEPS, print_fn=quiet, max_steps_per_dispatch=DISPATCH)
        rate0 = OUT_STEPS / (time.perf_counter() - t0)
        del bare
        ps = mesh(d)
        lines = []
        counters_zero()
        t0 = time.perf_counter()
        ps.run(OUT_STEPS, print_fn=lines.append,
               max_steps_per_dispatch=DISPATCH)
        rate_a = OUT_STEPS / (time.perf_counter() - t0)
        c = all_counters()
        n = ps.sysdef.state.n_local
        ends = np.cumsum([k for k, _ in ps.dispatch_log]).tolist()
        names = [a.name for a in ps.analyses]
        rates = sorted({r for a in ps.analyses
                        for r in (a.eval_rate, a.output_rate) if r} | {100})
        gate(ps.shard_engine == "pallas" and ps.loop == OUT_STEPS
             and names == [*WATER_ANALYSES, "printStress"]
             and all(set(multiples(r, OUT_STEPS)) <= set(ends)
                     for r in rates) and ends[-1] == OUT_STEPS,
             f"(a) engine {ps.shard_engine}, loop {ps.loop}, analyses "
             f"{names}, dispatch ends {ends}")
        gate(c["cellpair_half_ext"] >= OUT_STEPS and not any(
            v for k, v in c.items() if k != "cellpair_half_ext"),
            f"(a) launches {c}")
        vcm = analysis_rows(os.path.join(d, "vcm.data"))
        gate(vcm[:, 0].tolist() == multiples(30, OUT_STEPS),
             f"(a) VCMWRITE rows at {vcm[:, 0].tolist()}")
        st = analysis_rows(os.path.join(d, "stress.data"))
        press = {int(ln.split()[0]): float(ln.split("P=")[1].split()[0])
                 for ln in lines}
        gpa = U.convert(1.0, "GPa", "bar")
        # the print line's P has 6 decimals of GPa
        p_gap = max(abs(-row[1:4].sum() / 3.0 / gpa - press[int(row[0])])
                    for row in st)
        gate(st[:, 0].tolist() == multiples(100, OUT_STEPS)
             and np.isfinite(st).all() and np.abs(st[:, 1:4]).min() > 0
             and p_gap <= 1e-6,
             f"(a) STRESSWRITE loops {st[:, 0].tolist()}, -tr/3 vs the "
             f"printed P {p_gap} GPa")
        groups = {g: analysis_rows(os.path.join(d, f"group_{g}.data"))
                  for g in ("solvent", "half")}
        counts = sum(x[:, 1] for x in groups.values())
        gate(all(x[:, 0].tolist() == multiples(100, OUT_STEPS)
                 and np.isfinite(x).all() for x in groups.values())
             and (counts == n).all(),
             f"(a) group files {[x[:, :2].tolist() for x in groups.values()]}")
        with open(os.path.join(d, "graphs")) as f:
            graphs = f.read().splitlines()
        owned = [sum(int(x) for x in ln.split("owned=")[1].split(","))
                 for ln in graphs]
        gate(len(graphs) == len(ends) and set(owned) == {n}
             and all(f"nlocal={n} " in ln for ln in graphs),
             f"(a) graphs: {len(graphs)} lines for {len(ends)} dispatches, "
             f"owned {sorted(set(owned))}")
        files = sorted(analysis_files(d))
        phase("outputs", f"(a) water box {n} beads at (1,1,1) on #6, "
              f"{len(names)} analyses (VCMWRITE every 30, the rest every "
              f"100, output every 500), printStress, printGraphs, two "
              f"groups: {OUT_STEPS} steps in {len(ends)} dispatches, each "
              f"ending on every rate's multiple; {c['cellpair_half_ext']} "
              f"#6 launches; {rate_a:.2f} steps/s by the host clock around "
              f"run(), the outputs included, vs {rate0:.2f} for the deck "
              f"without them after {OUT_WARM} warm-up steps "
              f"({rate_a / rate0:.3f}x; not gated); "
              f"stress.data rows 100..{OUT_STEPS} by 100, -tr/3 within "
              f"{p_gap:.2g} GPa of the printed P; group rows 100..."
              f"{OUT_STEPS}, {int(groups['solvent'][-1, 1])} + "
              f"{int(groups['half'][-1, 1])} beads, T "
              f"{groups['solvent'][-1, 2]:.2f} / {groups['half'][-1, 2]:.2f}"
              f" K; {len(graphs)} graphs lines, last '{graphs[-1]}'; "
              f"{len(files)} files on {card}")

        # (d) on (a)'s last records
        row_a = compare_ext(ps, f"extended grid (1,1,1) after phase 28 (a): "
                            f"water box {n} beads")
        launches_a = c["cellpair_half_ext"]

        # --- (b) f64 FREE against Simulation ---------------------------------
        db = os.path.join(keep, "b")
        os.makedirs(os.path.join(db, "mesh"))
        os.makedirs(os.path.join(db, "sim"))
        outputs_deck(db, n_water, free=True, rates=OUT_B_RATES)
        t0 = time.perf_counter()
        pb = ParallelSimulation(*load(db), shape=(1, 1, 1), device=dev,
                                dtype=torch.float64,
                                run_dir=os.path.join(db, "mesh"))
        pb.run(OUT_B_STEPS, print_fn=quiet)
        t_mesh = time.perf_counter() - t0
        t0 = time.perf_counter()
        sb = Simulation(*load(db), run_dir=os.path.join(db, "sim"),
                        device=dev, dtype=torch.float64, engine="nlist")
        sb.run(OUT_B_STEPS, print_fn=quiet)
        t_sim = time.perf_counter() - t0
        L = box_edge(db)
        wf, wx, vcm_gap, diff = outputs_agree(os.path.join(db, "mesh"),
                                              os.path.join(db, "sim"), L)
        sub = {os.path.basename(k) for k in analysis_files(
            os.path.join(db, "mesh")) if k.startswith(("subset/",
                                                         "group_"))}
        wn, _, more = masters_agree(
            pb, sb, os.path.join(db, "mesh"), os.path.join(db, "sim"),
            skip_files={"graphs", "vcm.data", "stress.data", *sub})
        nl = {w: {ln.split("nlocal=")[1].split()[0] for ln in open(
            os.path.join(db, w, "graphs"))} for w in ("mesh", "sim")}
        gate(pb.shard_engine == "nlist" and wn <= AN_COUNT_TOL
             and wf <= AN_FLOAT_TOL and wx <= 1e-8 and vcm_gap <= 1e-12
             and nl["mesh"] == nl["sim"] == {str(n)},
             f"(b) counts {wn}, floats {wf}, stress and groups {wx}, vcm "
             f"{vcm_gap}, nlocal {nl}: {diff + more}")
        phase("outputs", f"(b) the same outputs in f64 (FREE, rates "
              f"'{OUT_B_RATES}'), {OUT_B_STEPS} steps, the mesh's list "
              f"engine vs Simulation(engine=nlist) from one state: counts "
              f"differ by {wn:.3g} of their total (gate {AN_COUNT_TOL}), "
              f"floats by {wf:.3g} of their column's scale (gate "
              f"{AN_FLOAT_TOL}), stress.data and the group files by "
              f"{wx:.3g} beyond their print (gate 1e-8), VCM by {vcm_gap:.3g}"
              f" (gate 1e-12), nlocal {sorted(nl['mesh'])} in both graphs "
              f"({'; '.join(diff + more) or 'equal'}); {t_mesh:.2f} s the "
              f"mesh, {t_sim:.2f} s Simulation on {card}")
        del pb, sb

        # --- (c) migrate_rate: the NPT deck in f64, then NVT on #6 ----------
        dc = os.path.join(keep, "c")
        os.makedirs(dc)
        npt_water_deck(dc, n_water, printrate=100)
        sc = Simulation(*load(dc), run_dir=dc, device=dev,
                        dtype=torch.float64, engine="nlist")
        sc.first_energy()
        f_sim = sc.ss.state.f[:n].cpu().numpy()
        del sc
        out = {}
        for what in ("default", "migrate_rate"):
            pc = ParallelSimulation(*load(dc), shape=(1, 1, 1), device=dev,
                                    dtype=torch.float64, run_dir=dc)
            pc.first_energy()
            mr = None
            if what == "default":
                f_mesh = pc.gather_by_gid(("f",))["f"]
            else:
                mr = 2 * pc.chunk_steps
            rows = []
            t0 = time.perf_counter()
            pc.run(OUT_C_STEPS, migrate_rate=mr, print_fn=rows.append)
            secs = time.perf_counter() - t0
            out[what] = (pc.loop, pc._live_L(), pc._last_row[:2].copy(),
                         len(pc.dispatch_log), OUT_C_STEPS / secs)
            del pc
        fgap = float(np.abs(f_mesh - f_sim).max() / np.abs(f_sim).max())
        gate(all(o[0] == OUT_C_STEPS and np.isfinite(o[1]).all()
                 and np.isfinite(o[2]).all() for o in out.values()),
             f"(c) NPT {out}")
        # (a)'s f32 run continued under NVT, migrate_rate 2 chunk_steps
        k = ps.chunk_steps
        rks = []
        real = ps._dispatch

        def recorded(*a, **kw):
            got = real(*a, **kw)
            if not got[2]:
                rks.extend(got[1][:, 1].tolist())
            return got

        ps._dispatch = recorded
        loop0 = ps.loop
        counters_zero()
        ps.run(OUT_C_STEPS, migrate_rate=2 * k, print_fn=quiet)
        c = all_counters()
        launches = c["cellpair_half_ext"]
        dof = 3.0 * n - ps.sysdef.n_constraints
        temp = float(np.mean([2.0 * x / (dof * U.kB) for x in rks]))
        gate(ps.loop == loop0 + OUT_C_STEPS and len(rks) == OUT_C_STEPS
             and abs(temp - 310.0) <= TEMP_TOL
             and launches >= OUT_C_STEPS and not any(
                 v for k_, v in c.items() if k_ != "cellpair_half_ext"),
             f"(c) NVT migrate_rate: loop {ps.loop}, {len(rks)} rows, mean "
             f"T {temp}, launches {c}")
        (lo, Lo, eo, no, ro), (lm, Lm, em, nm, rm) = (out["default"],
                                                     out["migrate_rate"])
        box_gap = float(np.abs(Lm / Lo - 1.0).max())
        phase("outputs", f"(c) NPT water deck f64 at (1,1,1) (list engine), "
              f"{OUT_C_STEPS} steps from one state: default cadence loop "
              f"{lo}, box {Lo.round(4).tolist()} nm, e_pot {eo[0]:.8g}, "
              f"{no} dispatches, {ro:.2f} steps/s; migrate_rate={2 * k} "
              f"(the chunk length) loop {lm}, box {Lm.round(4).tolist()} nm, "
              f"e_pot {em[0]:.8g}, {nm} dispatches, {rm:.2f} steps/s (the "
              f"boxes {box_gap:.3g} apart, relative); the "
              f"first forces' gap to Simulation(engine=nlist, f64) "
              f"{fgap:.3g} of the scale; (a)'s f32 run continued "
              f"{OUT_C_STEPS} NVT steps with migrate_rate={2 * k} "
              f"(per-step dispatches, a migration every {2 * k}): mean T "
              f"{temp:.2f} K, #6 launched {launches} times in this leg "
              f"({launches_a} in (a)) on {card}")

        # --- (d) #6 against its plain version on the NVT leg's records ------
        row_c = compare_ext(ps, f"extended grid (1,1,1) after phase 28 (c)'s "
                            f"NVT leg: water box {n} beads")
        phase("outputs", f"phase 28 {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    return {"cellpair_half_ext_outputs": ("cellpair_half_ext", launches_a,
                                          row_a),
            "cellpair_half_ext_migrate_rate": ("cellpair_half_ext", launches,
                                               row_c)}


# --- phase 29: item 22's dynamics under the brick mesh ----------------------
# Five paths through ParallelSimulation at (1,1,1) on the card, each an
# f32 leg (its first energy and forces held to Simulation's on the same
# deck, then phase 20's gates for the path: a mean T over the last
# DYN_TAIL of DYN_STEPS steps; the box and the slices' gates after
# DYN_SHORT_STEPS) and a DYN_F64_STEPS-step f64 leg held to
# Simulation(engine="nlist") step by step (dispatches of one step: box,
# zeta or bdot, energies): (a) NPTGLF on the nc = EAM_NC crystal at its
# zero-pressure lattice constant INT_A_LAT (#7); (b) NGLFNK on the LJ_N
# fluid (#6); (c) STRAIN on the water box (#6); (d) SHEAR on the LJ_N
# fluid (#6); (e) NVEGLF on the nc = EAM_NC crystal with its LANGEVIN
# group against NGLF with a FREE group, DYN_NVE_STEPS steps each (#7)
DYN_STEPS, DYN_TAIL, DYN_SHORT_STEPS = 1000, 500, 500
DYN_F64_STEPS, DYN_NVE_STEPS = 20, 100
DYN_E_REL, DYN_F_TOL, DYN_F64_TOL = 2e-5, 1e-4, 1e-9
DYN_WATER_N = 6173


def run_rows(ps, steps, **kw):
    """ps.run(steps, **kw) -> every accepted step's scalar row
    (brickstep.SCALAR_COLS: e_pot, rk, tr virial, virial diagonal, volume,
    virial)."""
    rows = []
    real = ps._dispatch

    def recorded(*a, **k):
        got = real(*a, **k)
        if not got[2]:
            rows.append(got[1])
        return got

    ps._dispatch = recorded
    try:
        ps.run(steps, **kw)
    finally:
        ps._dispatch = real
    return np.concatenate(rows)


def dynamics_paths():
    """(key, tag of its kernels rows, what, f32 deck, f64 deck, the
    kernels its f32 leg launches, its steps) of phase 29's paths."""
    small = dict(mesh_dynamics_decks())
    pair, eam = ("cellpair_half_ext",), ("eam_rho_ext", "eam_force_ext")
    nve = lambda t: t.replace("type=NGLF;", "type=NVEGLF;")   # noqa: E731
    strain = box_edit(f"dudt=0 0 {STRAIN_U};")

    def shear_lj(d):
        p = lj_deck(d, LJ_N, printrate=10)
        L = box_edge(d)
        regroup(d, shear_groups(L), lambda r: ["sh"] * len(r))
        return p

    def water(n, free):
        return lambda d: edit_deck(water_deck(d, n, 10, free=free), strain)

    return (
        ("a", "nptglf", f"NPTGLF nc={EAM_NC} Cu crystal at a = {INT_A_LAT} A",
         lambda d: eam_deck(d, EAM_NC, 10, a_lat=INT_A_LAT,
                            edit=nptglf_edit()),
         lambda d: eam_deck(d, 4, 10, free=True, a_lat=INT_A_LAT,
                            edit=nptglf_edit()), eam, DYN_STEPS),
        ("b", "nglfnk", f"NGLFNK lj_fluid {LJ_N} atoms",
         lambda d: lj_deck(d, LJ_N, printrate=10, edit=nglfnk_edit()),
         small["NGLFNK"], pair, DYN_STEPS),
        ("c", "strain", f"STRAIN dudt=0 0 {STRAIN_U}/fs on the water box",
         water(DYN_WATER_N, False), water(400, True), pair, DYN_SHORT_STEPS),
        ("d", "shear", f"SHEAR lj_fluid {LJ_N} atoms", shear_lj, small["SHEAR"], pair,
         DYN_SHORT_STEPS),
        ("e", "nveglf", f"NVEGLF nc={EAM_NC} Cu crystal (LANGEVIN group ignored)",
         lambda d: eam_deck(d, EAM_NC, 10, edit=nve),
         lambda d: eam_deck(d, 4, 10, edit=nve), eam, DYN_NVE_STEPS),
    )


def dynamics_phase(card, dev, counters_zero, all_counters, failed):
    """Phase 29: item 22's dynamics through ParallelSimulation on the card
    (see the constants above).  Gates go into `failed`.  Returns {kernels
    JSON row: (entry, launches, comparison)}: each f32 leg's kernels
    against their plain versions on that leg's last records (its moved
    box's frozen cell grid and halo), with that leg's launches."""
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.objects import units as U
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.ops import eam_half as eh
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation, live_h
    from ddcmd_tpu_torch.run.simulate import Simulation

    t_phase = time.perf_counter()
    quiet = lambda line: None                                  # noqa: E731
    launches = {"cellpair_half_ext": 0, "eam_rho_ext": 0, "eam_force_ext": 0}
    out = {}

    def gate(ok, what):
        if not ok:
            failed.append(f"phase 29 {what}")

    def mesh(d, dtype=torch.float32):
        return ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev,
                                  dtype=dtype, run_dir=d)

    def first_gap(d, ps):
        """(e rel, f max err / scale) of the mesh's first energy and
        forces against Simulation's on the same deck (f32, the card)."""
        sim = Simulation(*load(d), run_dir=d, device=dev)
        sim.first_energy()
        n = sim.sysdef.state.n_local
        e1, f1 = float(sim.ss.energy.eion), sim.ss.state.f[:n].cpu().numpy()
        del sim
        e = ps.first_energy()
        f = ps.gather_by_gid(("f",))["f"]
        scale = float(np.abs(f1).max())
        return abs(e - e1) / abs(e1), float(np.abs(f - f1).max()) / scale

    def f64_leg(make, key):
        """The path's f64 deck through the mesh and Simulation(engine=
        "nlist") one step a dispatch: the largest gap over the steps of
        box, zeta, bdot, e_pot and rk, each over its scale."""
        with tempfile.TemporaryDirectory() as d:
            make(d)
            sim = Simulation(*load(d), run_dir=d, device=dev,
                             dtype=torch.float64, engine="nlist")
            ps = mesh(d, torch.float64)
            ps.first_energy()
            gaps = []
            for _ in range(DYN_F64_STEPS):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    sim.run(1, print_fn=quiet)
                row = run_rows(ps, 1, print_fn=quiet)[-1]
                ss = sim.ss
                h = ss.box.h.cpu().double().numpy()
                pairs = ((live_h(ps._live_geom()), h),
                         (float(ps.zeta), float(ss.zeta)),
                         (ps.bdot.cpu().double().numpy(),
                          ss.bdot.cpu().double().numpy()),
                         (row[0], float(ss.energy.eion)),
                         (row[1], float(ss.energy.rk)))
                gaps.append(max(float(np.abs(np.asarray(a) - b).max())
                                / max(float(np.abs(b).max()), 1e-300)
                                for a, b in pairs))
            moved = float(np.abs(np.diagonal(h) / np.diagonal(
                sim.sysdef.box.h.cpu().double().numpy()) - 1.0).max())
            ok = (ps.loop == sim.ss.loop == DYN_F64_STEPS
                  and ps.shard_engine == "nlist" and max(gaps) <= DYN_F64_TOL)
            gate(ok, f"({key}) f64 leg gaps {max(gaps)}")
            return max(gaps), moved

    def leg_rows(key, tag, ps, c):
        """The leg's kernels against their plain versions on its last
        records, binned at the live box as the next chunk bins them (the
        deck's box would fold a moved box's rows onto wrong images):
        {row: (entry, the leg's launches, comparison)}."""
        kernel, args, kw = ps.step_fn.kernel_inputs(ps.fields, ps.mask,
                                                    ps.Lv)
        where = f"(1,1,1) after phase 29 ({key}) {tag}"
        if kernel is ch.cellpair_half_ext:
            return {f"cellpair_half_ext_dynamics_{tag}": (
                "cellpair_half_ext", c["cellpair_half_ext"], compare(
                    f"extended grid {where}", ch.cellpair_half_ext,
                    ch.cellpair_half_plain, args, kw, with_bound=True))}
        assert kernel is eh.eam_rho_half_ext
        t = eam_compare(f"extended-grid EAM {where}",
                        (eh.eam_rho_half_ext, eh.eam_force_half_ext),
                        (eh.eam_rho_half_plain, eh.eam_force_half_plain),
                        args[0], args[1:], kw, ps.tables, with_bound=True)
        return {f"eam_rho_ext_dynamics_{tag}": ("eam_rho_ext",
                                                c["eam_rho_ext"], t["rho"]),
                f"eam_force_ext_dynamics_{tag}": (
                    "eam_force_ext", c["eam_force_ext"], t["force"])}

    for key, tag, what, make32, make64, kernels, n_steps in dynamics_paths():
        t_path = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            make32(d)
            ps = mesh(d)
            e_rel, f_rel = first_gap(d, ps)
            n = ps.sysdef.state.n_local
            L0 = ps._live_L()
            counters_zero()
            rows = run_rows(ps, n_steps, print_fn=quiet,
                            max_steps_per_dispatch=DISPATCH)
            c = all_counters()
            steps = rows.shape[0]
            gate(e_rel <= DYN_E_REL and f_rel <= DYN_F_TOL,
                 f"({key}) first energy rel {e_rel}, forces {f_rel}")
            gate(ps.shard_engine == "pallas" and np.isfinite(rows).all()
                 and ps.loop == steps, f"({key}) engine "
                 f"{ps.shard_engine}, loop {ps.loop}, finite rows")
            gate(all(c[k] >= steps for k in kernels) and not any(
                v for k, v in c.items() if k not in kernels),
                f"({key}) launches {c}")
            for k in kernels:
                launches[k] += c[k]
            dof = 3.0 * n - ps.sysdef.n_constraints
            temp = float(np.mean(2.0 * rows[-DYN_TAIL:, 1] / (dof * U.kB)))
            L1 = ps._live_L()
            box = float(np.abs(L1 / L0 - 1.0).max())
            text = ""
            if key in ("a", "b"):
                T0 = EAM_T if key == "a" else LJ_T
                gate(abs(temp - T0) <= TEMP_TOL and box <= 0.2,
                     f"({key}) mean T {temp}, box moved {box}")
                if key == "a":
                    gate(math.isfinite(float(ps.zeta)) and float(ps.zeta) != 0,
                         f"(a) zeta {float(ps.zeta)}")
                    text = (f"zeta {float(ps.zeta):.6g}, V/atom "
                            f"{rows[:, 6].min() / n:.6g}-"
                            f"{rows[:, 6].max() / n:.6g} nm^3 (start "
                            f"{np.prod(L0) / n:.6g})")
                else:
                    bdot = ps.bdot.cpu().double().numpy()
                    gate(bool(L1[0] == L1[1]) and np.isfinite(bdot).all()
                         and bool(np.any(bdot != 0.0)),
                         f"(b) Lx {L1[0]} Ly {L1[1]}, bdot {bdot}")
                    text = (f"Lx == Ly {bool(L1[0] == L1[1])}, bdot "
                            f"{np.round(bdot, 6).tolist()} nm/ps")
                text += f"; mean T {temp:.2f} K over the last {DYN_TAIL}"
            elif key == "c":
                expect = math.exp(STRAIN_U * steps * ps.sysdef.cfg.dt
                                  * U.TIME_TO_FS)
                zerr = abs(L1[2] / L0[2] / expect - 1.0)
                xyerr = float(np.abs(L1[:2] / L0[:2] - 1.0).max())
                gate(zerr <= 1e-5 and xyerr <= 1e-6,
                     f"(c) Lz off exp(int u dt) by {zerr}, Lx, Ly {xyerr}")
                text = (f"Lz/Lz0 {L1[2] / L0[2]:.9f} vs exp(int u dt) "
                        f"{expect:.9f} (rel {zerr:.3g}), Lx, Ly moved "
                        f"{xyerr:.3g}; mean T {temp:.2f} K")
            elif key == "d":
                g = ps.gather_by_gid(("r", "v", "mass"))
                prof, ((vt, tt), (vb, tb)) = shear_profile_arrays(
                    g["r"].astype(np.float64), g["v"].astype(np.float64),
                    g["mass"].astype(np.float64), box_edge(d))
                gate(vt > 0 > vb, f"(d) slice mean vy {vt}, {vb}")
                text = (f"top slice vy {vt:.4g} A/fs at {tt:.2f} K, bottom "
                        f"{vb:.4g} A/fs at {tb:.2f} K; vy by z bin "
                        f"{[round(x, 6) for x in prof]}")
            else:
                # NGLF with a FREE group on the same crystal: the same rows
                with tempfile.TemporaryDirectory() as d2:
                    eam_deck(d2, EAM_NC, 10, free=True)
                    ref = mesh(d2)
                    ref.first_energy()
                    rows_ref = run_rows(ref, DYN_NVE_STEPS, print_fn=quiet)
                    del ref
                scale = float(np.abs(rows_ref[:, :2]).max())
                err = float(np.abs(rows[:, :2] - rows_ref[:, :2]).max()) \
                    / scale
                etot = (rows[:, 0] + rows[:, 1]) / n
                gate(rows.shape == rows_ref.shape and err <= 1e-6,
                     f"(e) NVEGLF vs NGLF FREE {err}")
                text = (f"e_pot and e_kin against NGLF with a FREE group "
                        f"within {err:.3g} of their scale {scale:.6g}; "
                        f"Etot/atom drift {etot.max() - etot.min():.3g} "
                        "kJ/mol")
            gap64, moved64 = f64_leg(make64, key)
            rate = steps / sum(t for _, t in ps.dispatch_log)
            phase("dynamics", f"({key}) {what}: {n} particles at (1,1,1) on "
                  f"{'#7' if kernels[0].startswith('eam') else '#6'} "
                  f"(ncore {ps.cplan.ncore}, cap {ps.cplan.cap}), first "
                  f"energy rel {e_rel:.2g} and forces {f_rel:.2g} of the "
                  f"scale against Simulation, {steps} f32 steps "
                  f"({len(ps.dispatch_log)} dispatches, {rate:.2f} steps/s "
                  f"by the dispatch clock): {text}; box moved {box:.4g}; launches "
                  f"{ {k: c[k] for k in kernels} }; f64 leg "
                  f"{DYN_F64_STEPS} steps one a dispatch against "
                  f"Simulation(engine=nlist): largest gap {gap64:.3g} of the "
                  f"scale (gate {DYN_F64_TOL:g}), its box moved "
                  f"{moved64:.3g}; {time.perf_counter() - t_path:.1f} s on "
                  f"{card}")
            out.update(leg_rows(key, tag, ps, c))
            del ps

    gate(all(launches.values()), f"launches {launches}")
    phase("dynamics", f"phase 29 {time.perf_counter() - t_phase:.1f} s "
          f"(launches {launches})")
    return out


# --- phase 30: SIMULATE transform= under the brick mesh ---------------------
# (a) the water box (MT_WATER_N beads, f32, #6) at (1,1,1) with
# transform= REPLICATE 2x2x2 at TRANSFORM_AT, TRANSFORM_STEPS steps in all
# (phase 22 (a)'s run through ParallelSimulation); (b) the nx = MT_BL_NX
# bilayer (f32, #6 with exclusions) staged MT_BL_STAGE steps at EQ_DT,
# then REPLICATE 2x2x1 and MT_BL_AFTER steps; (c) the f64 same-count leg
# of tests/test_torch_mesh_transforms.py (MT_SMALL_N FREE beads, the
# transforms of MT_SAME at rate MT_RATE, MT_F64_STEPS steps) against
# Simulation(engine="nlist"); (d) #6 against its plain version on (a)'s
# and (b)'s last records at the live box
MT_WATER_N, MT_BL_NX, MT_BL_STAGE, MT_BL_AFTER = 6173, 8, 100, 100
MT_SMALL_N, MT_RATE, MT_F64_STEPS = 400, 20, 60
MT_E8_REL, MT_SIM_REL, MT_FAMILY_REL, MT_F64_TOL = 2.05e-7, 2e-5, 1e-7, 1e-10
# the same-count transforms, in the order they apply at each multiple
MT_SAME = ("therm", "vcm", "shrink", "shuffle")


def transforms_edit(objects, rate=None):
    """A deck edit that lists the TRANSFORM objects `objects` ({name:
    keyword text}) in SIMULATE transform= and appends them, each with
    rate=`rate` when given."""
    def edit(text):
        tail = f" rate={rate};" if rate else ""
        return (text.replace("type=MD;", "type=MD; transform="
                             + " ".join(objects) + ";", 1)
                + "".join(f"{k} TRANSFORM {{ {v}{tail} }}\n"
                          for k, v in objects.items()))
    return edit


def same_count_transforms(d):
    """MT_SAME's objects for the deck in d: THERMALIZE to 310 K (seeded),
    SETVELOCITY vcm = 0, a BOX 2% smaller on each axis, GIDSHUFFLE."""
    L = 0.98 * box_edge(d)
    return {"therm": "type=THERMALIZE; temperature=310 K; seed=3;",
            "vcm": "type=SETVELOCITY; vcm=0 0 0;",
            "shrink": f"type=BOX; hNew={L!r} 0 0 0 {L!r} 0 0 0 {L!r} "
                      "Angstrom;",
            "shuffle": "type=GIDSHUFFLE; seed=7;"}


def family_energies(sd, r, geom):
    """{family: energy} of the bonded terms of the system sd (its
    topology as run/forces.bonded_tables gives it, in f64) at positions
    r (n, 3) and box geom, each family of potentials/bonded.FAMILIES
    evaluated alone by bonded_eval."""
    from ddcmd_tpu_torch.potentials.bonded import FAMILIES, bonded_eval
    from ddcmd_tpu_torch.run.forces import bonded_tables

    f64 = torch.float64
    tabs = bonded_tables(sd, f64)
    keys = {k for k, _ in FAMILIES}
    r = torch.as_tensor(np.asarray(r, np.float64), dtype=f64)
    geom = torch.as_tensor(np.asarray(geom, np.float64), dtype=f64)
    out = {}
    for key, _ in FAMILIES:
        if key in tabs:
            one = {k: v for k, v in tabs.items() if k not in keys or k == key}
            out[key] = float(bonded_eval(r, geom, one, r.shape[0], f64)[1])
    return out


def mesh_transform_deck(d, n=MT_SMALL_N, objects=None, rate=MT_RATE,
                        free=True, printrate=MT_RATE):
    """The water box (n beads, FREE unless free=False) with SIMULATE
    transform= naming `objects` ({name: keyword text}; MT_SAME's by
    default), each at `rate`."""
    deck = water_deck(d, n, printrate, free=free)
    objects = same_count_transforms(d) if objects is None else objects
    return edit_deck(deck, transforms_edit(objects, rate))


def sim_step_rows(sim):
    """Install a recorder of Simulation's accepted per-step rows: returns
    a function that gives their (e_pot, rk) columns (steps, 2) in loop
    order (a redone dispatch replaces the one it redoes)."""
    rows = {}
    real = sim._dispatch

    def dispatch(ss, *a, **k):
        got = real(ss, *a, **k)
        rows[int(ss.loop)] = got[1][:, :2]
        return got

    sim._dispatch = dispatch
    return lambda: np.concatenate([rows[k] for k in sorted(rows)])


def mesh_transforms_phase(card, dev, counters_zero, all_counters, failed):
    """Phase 30: SIMULATE transform= through ParallelSimulation on the
    card (see the constants above).  Gates go into `failed`.  Returns
    {kernels JSON row: (entry, launches, comparison)}: #6 on (a)'s last
    records with (a)'s launches, #6 with exclusions on (b)'s with
    (b)'s."""
    from ddcmd_tpu_torch.integrators.constraints import constraint_residual
    from ddcmd_tpu_torch.models import load
    from ddcmd_tpu_torch.objects import units as U
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.run.parallel_sim import ParallelSimulation
    from ddcmd_tpu_torch.run.simulate import Simulation

    t_phase = time.perf_counter()
    quiet = lambda line: None                                  # noqa: E731
    out = {}

    def gate(ok, what):
        if not ok:
            failed.append(f"phase 30 {what}")

    def rate(log):
        return sum(k for k, _ in log) / max(sum(t for _, t in log), 1e-9)

    def mesh(d, dtype=torch.float32):
        return ParallelSimulation(*load(d), shape=(1, 1, 1), device=dev,
                                  dtype=dtype, run_dir=d)

    def spied(ps, families=False):
        """Wrap ps.apply_transform; returns the list that gets, for each
        call, the first energy and the gathered r and v (and the bonded
        families) just before it, and after it the seconds it took, its
        host result's f64 positions and box, the first energy and the
        gathered forces (and the families at the card's positions)."""
        seen, real = [], ps.apply_transform

        def wrapped(tobj):
            g = ps.gather_by_gid(("r", "v"))
            rec = dict(loop=ps.loop, e0=ps.first_energy(), r=g["r"],
                       v=g["v"], n0=ps.sysdef.state.n_local,
                       disp=len(ps.dispatch_log))
            if families:
                rec["fam0"] = family_energies(ps.sysdef, g["r"],
                                              ps._live_geom())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctx = real(tobj)
            torch.cuda.synchronize()
            rec.update(secs=time.perf_counter() - t0, r1=ctx.r,
                       L1=np.diagonal(ctx.h).copy(), e1=ps.first_energy())
            g = ps.gather_by_gid(("r", "f"))
            rec["f1"] = g["f"]
            if families:
                rec["fam_card"] = family_energies(ps.sysdef, g["r"],
                                                  ps._live_geom())
            seen.append(rec)
            return ctx

        ps.apply_transform = wrapped
        return seen

    def kernel_row(ps, what):
        """#6 against its plain version on ps's current records, binned
        at the live box."""
        kernel, args, kw = ps.step_fn.kernel_inputs(ps.fields, ps.mask,
                                                    ps.Lv)
        cp = ps.cplan
        assert kernel is ch.cellpair_half_ext
        return compare(f"{what}, {cp.n_prog} core cells, cap {cp.cap}",
                       ch.cellpair_half_ext, ch.cellpair_half_plain, args,
                       kw, with_bound=True)

    def same_state(d, rec, name):
        """Simulation (f32, the card) on the deck in d with rec's r and v,
        then the transform `name`: (first energy, forces)."""
        sim = Simulation(*load(d), run_dir=d, device=dev)
        st, n0 = sim.ss.state, rec["n0"]
        r, v = st.r.clone(), st.v.clone()
        r[:n0] = torch.as_tensor(rec["r"], dtype=r.dtype, device=dev)
        v[:n0] = torch.as_tensor(rec["v"], dtype=v.dtype, device=dev)
        sim.ss = sim.ss.replace(state=st.replace(r=r, v=v))
        sim.apply_transform(sim.db.get(name, "TRANSFORM"))
        n = sim.sysdef.state.n_local
        got = (float(sim.ss.energy.eion),
               sim.ss.state.f[:n].double().cpu().numpy())
        del sim
        return got

    keep = tempfile.mkdtemp()
    try:
        # --- (a) the water box replicated 2x2x2 at its rate on #6 ----------
        d = os.path.join(keep, "a")
        os.makedirs(d)
        edit_deck(water_deck(d, MT_WATER_N, printrate=10), transforms_edit(
            {"rep": "type=REPLICATE; nx=2; ny=2; nz=2;"}, TRANSFORM_AT))
        ps = mesh(d)
        n0 = ps.sysdef.state.n_local
        engine0 = ps.shard_engine
        seen = spied(ps)
        counters_zero()
        rows = run_rows(ps, TRANSFORM_STEPS, print_fn=quiet,
                        max_steps_per_dispatch=DISPATCH)
        c = all_counters()
        n = ps.sysdef.state.n_local
        rec = seen[0] if seen else {}
        gids = np.unique(ps.gather_by_gid(("gid",))["gid"]).size
        temp = float(np.mean(2.0 * rows[-TRANSFORM_TAIL:, 1]
                             / (3.0 * n * U.kB)))
        rel8 = abs(rec.get("e1", 0.0) / (8.0 * rec.get("e0", 1.0)) - 1.0)
        e_sim, f_sim = same_state(d, rec, "rep")
        rel_sim = abs(rec["e1"] - e_sim) / abs(e_sim)
        f_gap = float(np.abs(rec["f1"] - f_sim).max()) / float(
            np.abs(f_sim).max())
        gate(len(seen) == 1 and rec.get("loop") == TRANSFORM_AT
             and ps.loop == TRANSFORM_STEPS and n == 8 * n0 and gids == n
             and engine0 == ps.shard_engine == "pallas",
             f"(a) {len(seen)} replicas, the first at loop "
             f"{rec.get('loop')}, {n} beads, {gids} gids, engine "
             f"{engine0} -> {ps.shard_engine}")
        gate(rel8 <= MT_E8_REL, f"(a) first energy {rec.get('e1')} vs 8 x "
             f"{rec.get('e0')} (rel {rel8})")
        gate(rel_sim <= MT_SIM_REL, f"(a) first energy {rec['e1']} vs "
             f"Simulation's {e_sim} on the same state (rel {rel_sim})")
        gate(c["cellpair_half_ext"] >= TRANSFORM_STEPS and not any(
            v for k, v in c.items() if k != "cellpair_half_ext"),
            f"(a) launches {c}")
        gate(np.isfinite(rows).all() and abs(temp - WATER_T) <= TEMP_TOL,
             f"(a) mean T {temp}")
        cp = ps.cplan
        log = ps.dispatch_log
        phase("mesh-transforms", f"(a) water box {n0} beads at (1,1,1), "
              f"transform= REPLICATE 2x2x2 at rate {TRANSFORM_AT}, "
              f"{TRANSFORM_STEPS} steps through ParallelSimulation: -> {n} "
              f"beads, ncore {cp.ncore} cap {cp.cap}, {gids} unique gids; "
              f"the replica and its first energy {rec['secs']:.3f} s; "
              f"first energy {rec['e1']:.6f} vs 8 x {rec['e0']:.6f} (rel "
              f"{rel8:.3g}, gate {MT_E8_REL:g}), vs Simulation's on the "
              f"same state {e_sim:.6f} (rel {rel_sim:.3g}, gate "
              f"{MT_SIM_REL:g}; forces {f_gap:.3g} of the scale); #6 "
              f"{c['cellpair_half_ext']} launches; "
              f"{rate(log[:rec['disp']]):.2f} steps/s before, "
              f"{rate(log[rec['disp']:]):.2f} after (dispatch clock); "
              f"mean T {temp:.2f} K over the last {TRANSFORM_TAIL} steps "
              f"on {card}")
        out["cellpair_half_ext_transform"] = (
            "cellpair_half_ext", c["cellpair_half_ext"], kernel_row(
                ps, f"extended grid (1,1,1) after phase 30 (a): water box "
                f"replica {n} beads"))
        del ps
        torch.cuda.empty_cache()

        # --- (b) the nx = 8 bilayer replicated 2x2x1 on #6 with exclusions -
        d = os.path.join(keep, "b")
        os.makedirs(d)
        edit_deck(bilayer_deck(d, MT_BL_NX, EQ_DT, 10), transforms_edit(
            {"rep": "type=REPLICATE; nx=2; ny=2; nz=1;"}))
        ps = mesh(d)
        n0 = ps.sysdef.state.n_local
        seen = spied(ps, families=True)
        counters_zero()
        rows = run_rows(ps, MT_BL_STAGE, print_fn=quiet)
        ps.apply_transform(ps.db.get("rep", "TRANSFORM"))
        rows = np.concatenate([rows, run_rows(ps, MT_BL_AFTER,
                                              print_fn=quiet)])
        c = all_counters()
        n = ps.sysdef.state.n_local
        rec = seen[0]
        fam1 = family_energies(ps.sysdef, rec["r1"], rec["L1"])
        fam_rel = max(abs(fam1[k] / (4.0 * rec["fam0"][k]) - 1.0)
                      for k in rec["fam0"])
        card_rel = max(abs(rec["fam_card"][k] / (4.0 * rec["fam0"][k])
                           - 1.0) for k in rec["fam0"])
        view = ps.view()
        bt = ps.sysdef.bonded
        resid = float(constraint_residual(
            view.ss.state, bt.cons_atoms, bt.cons_pairs, bt.cons_dist,
            box_lengths=ps._live_L()))
        steps = MT_BL_STAGE + MT_BL_AFTER
        gate(n == 4 * n0 and ps.loop == steps and ps.shard_engine == "pallas"
             and sorted(fam1) == sorted(rec["fam0"])
             and fam_rel <= MT_FAMILY_REL,
             f"(b) {n} beads from {n0}, loop {ps.loop}, engine "
             f"{ps.shard_engine}, families {fam1} vs 4 x {rec['fam0']} "
             f"(rel {fam_rel})")
        gate(np.isfinite(rows).all() and resid < RATTLE_TOL,
             f"(b) RATTLE residual {resid}")
        gate(c["cellpair_half_ext_excl"] >= steps
             and c["cellpair_half_ext"] == c["cellpair_half_ext_excl"]
             and not any(v for k, v in c.items() if k not in (
                 "cellpair_half_ext", "cellpair_half_ext_excl")),
             f"(b) launches {c}")
        temp = float(np.mean(2.0 * rows[-50:, 1] / (
            (3.0 * n - ps.sysdef.n_constraints) * U.kB)))
        phase("mesh-transforms", f"(b) bilayer nx={MT_BL_NX} {n0} beads at "
              f"(1,1,1), {MT_BL_STAGE} NPT steps at {EQ_DT} fs, REPLICATE "
              f"2x2x1 -> {n} beads (the topology built anew: "
              f"{bt.counts()}), {MT_BL_AFTER} steps more; the replica, its "
              f"topology and first energy {rec['secs']:.3f} s; bonded "
              f"families {[round(fam1[k], 4) for k in sorted(fam1)]} vs 4 "
              f"x {[round(rec['fam0'][k], 4) for k in sorted(fam1)]} (rel "
              f"{fam_rel:.3g}, gate {MT_FAMILY_REL:g}; at the card's f32 "
              f"positions {card_rel:.3g}, not gated); first energy "
              f"{rec['e1']:.6f} vs 4 x {rec['e0']:.6f} (rel "
              f"{abs(rec['e1'] / (4 * rec['e0']) - 1):.3g}, not gated); "
              f"RATTLE residual {resid:.3g}; T {temp:.2f} K over the last "
              f"50 steps (not gated: the deck's synthetic start, staged "
              f"{MT_BL_STAGE} steps); #6 with exclusions "
              f"{c['cellpair_half_ext_excl']} "
              f"launches on {card}")
        out["cellpair_half_ext_excl_transform"] = (
            "cellpair_half_ext_excl", c["cellpair_half_ext_excl"],
            kernel_row(ps, f"extended grid (1,1,1) with exclusions after "
                       f"phase 30 (b): bilayer replica {n} beads"))
        del ps, view
        torch.cuda.empty_cache()

        # --- (c) the f64 same-count leg against Simulation -----------------
        d = os.path.join(keep, "c")
        os.makedirs(d)
        mesh_transform_deck(d)
        ps = mesh(d, torch.float64)
        sim = Simulation(*load(d), run_dir=d, device=dev,
                         dtype=torch.float64, engine="nlist")
        sim_rows = sim_step_rows(sim)
        t0 = time.perf_counter()
        ps.first_energy()
        rows = run_rows(ps, MT_F64_STEPS, print_fn=quiet)
        secs = time.perf_counter() - t0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sim.run(MT_F64_STEPS, print_fn=quiet)
        ref = sim_rows()
        n = sim.sysdef.state.n_local
        g = ps.gather_by_gid(("r", "v"))
        h = sim.ss.box.h.cpu().numpy()
        s_ = (g["r"] - sim.ss.state.r[:n].cpu().numpy()) @ np.linalg.inv(h).T
        gaps = {
            "e_pot": float(np.abs(rows[:, 0] - ref[:, 0]).max()
                           / np.abs(ref[:, 0]).max()),
            "rk": float(np.abs(rows[:, 1] - ref[:, 1]).max()
                        / np.abs(ref[:, 1]).max()),
            "r": float(np.abs((s_ - np.round(s_)) @ h.T).max()
                       / np.abs(h).max()),
            "v": float(np.abs(g["v"] - sim.ss.state.v[:n].cpu().numpy())
                       .max() / np.abs(g["v"]).max())}
        same_gid = bool(np.array_equal(ps.sysdef.collection.gid,
                                       sim.sysdef.collection.gid))
        ends = np.cumsum([k for k, _ in ps.dispatch_log]).tolist()
        gate(ps.loop == sim.ss.loop == MT_F64_STEPS
             and rows.shape[0] == ref.shape[0] == MT_F64_STEPS
             and ends == list(range(MT_RATE, MT_F64_STEPS + 1, MT_RATE))
             and same_gid and max(gaps.values()) <= MT_F64_TOL,
             f"(c) loop {ps.loop}, dispatch ends {ends}, gids equal "
             f"{same_gid}, gaps {gaps}")
        phase("mesh-transforms", f"(c) f64 water box {n} FREE beads at "
              f"(1,1,1), {'/'.join(MT_SAME)} at rate {MT_RATE}, "
              f"{MT_F64_STEPS} steps ({secs:.2f} s) against "
              f"Simulation(engine=nlist): every step's e_pot "
              f"{gaps['e_pot']:.3g} and rk {gaps['rk']:.3g}, r "
              f"{gaps['r']:.3g} and v {gaps['v']:.3g} of their scale "
              f"(gate {MT_F64_TOL:g}), the collection's gids equal "
              f"{same_gid}; phase 30 {time.perf_counter() - t_phase:.1f} s "
              f"on {card}")
        del ps, sim
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    import ddcmd_tpu_torch  # noqa: F401  (pins TF32 off)
    from ddcmd_tpu_torch.integrators.constraints import constraint_residual
    from ddcmd_tpu_torch.ops import cellpair_full as cf
    from ddcmd_tpu_torch.ops import cellpair_half as ch
    from ddcmd_tpu_torch.ops import eam_half as eh
    from ddcmd_tpu_torch.ops.cellpair_half import build_kernels

    dev = torch.device(DEVICE)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{card} | {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {nvcc_line()}")

    t0 = time.perf_counter()
    libs = build_kernels(force=True)
    build_s = time.perf_counter() - t0
    for name, lib in libs.items():
        with open(os.path.join(os.path.dirname(lib), f"{name}.ptxas.txt")) as f:
            ptxas = " | ".join(ln.strip() for ln in f
                               if "registers" in ln or "spill" in ln)
        phase("build", f"{name}.cu -> {os.path.relpath(lib)}; ptxas: {ptxas}")
    phase("build", f"{len(libs)} sources in parallel in {build_s:.2f} s")

    counted = (ch.cellpair_half, ch.cellpair_half_col, eh.eam_rho_half,
               eh.eam_force_half, eh.eam_rho_half_col, eh.eam_force_half_col,
               ch.cellpair_half_ext, eh.eam_rho_half_ext,
               eh.eam_force_half_ext, cf.cellpair_full)

    def counters_zero():
        ch.cellpair_half.launches_excl = 0
        ch.cellpair_half_ext.launches_excl = 0
        for k in counted:
            k.launches = 0

    def counters():
        """(pair, pair with exclusions, pair column) launches"""
        return (ch.cellpair_half.launches, ch.cellpair_half.launches_excl,
                ch.cellpair_half_col.launches)

    def eam_counters():
        """(rho, force, rho column, force column) launches"""
        return tuple(k.launches for k in counted[2:6])

    def ext_counters():
        """(pair, rho, force) launches of the extended-grid kernels, and
        the full-stencil kernel's"""
        return tuple(k.launches for k in counted[6:])

    def all_counters():
        """{kernels JSON entry: launches} of every counted kernel"""
        names = ("cellpair_half", "cellpair_half_col", "eam_rho",
                 "eam_force", "eam_rho_col", "eam_force_col",
                 "cellpair_half_ext", "eam_rho_ext", "eam_force_ext",
                 "cellpair_full")
        return dict(zip(names, (k.launches for k in counted)),
                    cellpair_half_excl=ch.cellpair_half.launches_excl,
                    cellpair_half_ext_excl=ch.cellpair_half_ext.launches_excl)

    if "--list-only" in argv:
        nlist_phase(card, dev, counters_zero, all_counters)
        return
    if "--charmm-only" in argv:
        charmm_phase(card, dev, counters_zero, all_counters)
        return
    if "--integrators-only" in argv:
        integrators_phase(card, dev, counters_zero, all_counters)
        return
    if "--transforms-only" in argv:
        failed = []
        transforms_phase(card, dev, counters_zero, all_counters, failed)
        assert not failed, f"phase 22 gates missed: {failed}"
        return
    if "--analyses-only" in argv:
        failed = []
        analyses_phase(card, dev, counters_zero, all_counters, failed)
        assert not failed, f"phase 23 gates missed: {failed}"
        return
    if "--rebuilds-only" in argv:
        failed = []
        rebuilds_phase(card, dev, counters_zero, all_counters, failed)
        assert not failed, f"phase 24 gates missed: {failed}"
        return
    if "--loadbalance-only" in argv:
        failed = []
        loadbalance_phase(card, dev, counters_zero, all_counters, failed)
        assert not failed, f"phase 25 gates missed: {failed}"
        return
    if "--listmesh-only" in argv:
        failed = []
        listmesh_phase(card, dev, counters_zero, all_counters, failed)
        assert not failed, f"phase 26 gates missed: {failed}"
        return
    if "--triclinic-only" in argv:
        failed = []
        triclinic_slab_phase(card, dev, counters_zero, all_counters, failed)
        assert not failed, f"phase 27 gates missed: {failed}"
        return
    if "--outputs-only" in argv:
        failed = []
        outputs_phase(card, dev, counters_zero, all_counters, failed)
        assert not failed, f"phase 28 gates missed: {failed}"
        return
    if "--dynamics-only" in argv:
        failed = []
        dynamics_phase(card, dev, counters_zero, all_counters, failed)
        assert not failed, f"phase 29 gates missed: {failed}"
        return
    if "--mesh-transforms-only" in argv:
        failed = []
        mesh_transforms_phase(card, dev, counters_zero, all_counters, failed)
        assert not failed, f"phase 30 gates missed: {failed}"
        return
    if "--masters-only" in argv:
        failed = []
        with tempfile.TemporaryDirectory() as d_eq, \
                tempfile.TemporaryDirectory() as d:
            bilayer_stage1(d_eq, d)
            masters_bilayer_part(card, dev, d, counters_zero, all_counters,
                                 failed)
        masters_phase(card, dev, counters_zero, all_counters, failed)
        assert not failed, f"phase 21 gates missed: {failed}"
        return
    res = kernel_phase(dev)
    res.update(eam_kernel_phase(dev))
    res.update(ext_kernel_phase(dev))
    launches = {"cellpair_full": full_entry_phase(dev, counters_zero,
                                                  all_counters)}
    if "--kernels-only" in argv:
        return
    # --- phase 4: the water slice through the CLI ---------------------------
    with tempfile.TemporaryDirectory() as d:
        deck = water_deck(d, 6173, printrate=10)
        counters_zero()
        sim = cli_run(["simulate", "-o", deck, "-n", str(SLICE_STEPS),
                       "--run-dir", d])
        n_all, n_excl, n_col = counters()
        rows = read_rows(d)
    assert sim.device == dev and sim.ss.loop == SLICE_STEPS
    assert np.isfinite(rows).all(), "non-finite printinfo row"
    assert n_all >= SLICE_STEPS and n_excl == 0 and n_col == 0, counters()
    assert not any(eam_counters()) and not any(ext_counters()), (
        eam_counters(), ext_counters())
    launches["cellpair_half"] = n_all
    single_rates = {"water": tail_rate(sim)[0]}
    temp = float(rows[rows[:, 0] > SLICE_STEPS - TAIL][:, 5].mean())
    assert abs(temp - 310.0) <= TEMP_TOL, f"mean T over the last {TAIL} steps: {temp}"
    rate, steps = tail_rate(sim)
    phase("water", f"martini_water 6173 beads NVT {SLICE_STEPS} steps "
          f"(dispatch {DISPATCH}): Etot/bead {rows[-1, 2]:.6f} eV, mean T "
          f"{temp:.2f} K over the last {TAIL} steps, kernel launches "
          f"{n_all}, {rate:.1f} steps/s over the last {steps} steps "
          f"on {card}")

    # --- phase 5: a small bilayer: per-cell kernel with exclusions ----------
    with tempfile.TemporaryDirectory() as d:
        deck = bilayer_deck(d, SMALL_NX, EQ_DT, 10)
        counters_zero()
        sim = cli_run(["simulate", "-o", deck, "-n", str(SMALL_STEPS),
                       "--run-dir", d])
        n_all, n_excl, n_col = counters()
        rows = read_rows(d)
    assert np.isfinite(rows).all(), "non-finite printinfo row"
    assert n_excl >= SMALL_STEPS and n_col == 0, counters()
    launches["cellpair_half_excl"] = n_excl
    phase("small-bilayer", f"{sim.sysdef.state.n_local} beads, cells "
          f"{sim.grid.ncells} cap {sim.grid.cap}, {SMALL_STEPS} NPT steps at "
          f"dt={EQ_DT} fs: T {rows[-1, 5]:.2f} K, per-cell kernel with "
          f"exclusions launched {n_excl} times, redos {sim.redos}")

    # --- phase 6: the full bilayer, staged as bench.py runs it --------------
    with tempfile.TemporaryDirectory() as d_eq, \
            tempfile.TemporaryDirectory() as d:
        deck, L_eq = bilayer_stage1(d_eq, d)
        run_dir = os.path.join(d, "run")
        counters_zero()
        sim = cli_run(["simulate", "-o", deck, "-r",
                       os.path.join(d, "restart"), "-n", str(RUN_STEPS),
                       "--run-dir", run_dir])
        n_all, n_excl, n_col = counters()
        rows = read_rows(run_dir)
        sd = sim.sysdef
        assert sim.ss.loop == EQ_STEPS + RUN_STEPS, sim.ss.loop
        assert np.isfinite(rows).all(), "non-finite printinfo row"
        assert n_col >= RUN_STEPS, counters()
        launches["cellpair_half_col"] = n_col
        L0 = sd.box.lengths.cpu().numpy().astype(np.float64)
        L1 = sim.ss.box.lengths.cpu().numpy().astype(np.float64)
        assert np.allclose(L0, L_eq, rtol=1e-6), (L0, L_eq)
        assert np.isfinite(L1).all() and \
            (np.abs(L1 / L0 - 1.0) <= 0.2).all(), (L0, L1)
        tail = rows[rows[:, 0] > EQ_STEPS + RUN_STEPS - TAIL]
        temp = float(tail[:, 5].mean())
        assert abs(temp - BILAYER_T) <= TEMP_TOL, \
            f"mean T over the last {TAIL}: {temp}"
        bt = sd.bonded
        resid = constraint_residual(sim.ss.state, bt.cons_atoms, bt.cons_pairs,
                                    bt.cons_dist, box_lengths=L1)
        assert resid < 5e-3, f"RATTLE residual {resid}"
        rate, steps = tail_rate(sim)
        graph_ok, graph_text = bonded_graph_check(sim)
        assert graph_ok, f"bilayer stage 2: {graph_text}"
        phase("bilayer", f"stage 2: {sd.state.n_local} beads, {RUN_STEPS} NPT "
              f"steps at dt=20 fs from the restart (dispatch {DISPATCH}): "
              f"cells {sim.grid.ncells} G={sim.force_fn.terms[0].G} "
              f"cap {sim.grid.cap}; stale redos {sim.redos['stale']}, "
              f"overflow replans {sim.redos['overflow']}; box "
              f"{L0.round(4).tolist()} -> "
              f"{L1.round(4).tolist()} nm; mean T {temp:.2f} K over the last "
              f"{TAIL} steps; Etot/bead {rows[-1, 2]:.6f} eV; RATTLE residual "
              f"{resid:.3g}; column kernel launches {n_col}; {rate:.2f} "
              f"steps/s over the last {steps} steps; {graph_text} on {card}")
        # --- phase 12: the same restart through the mesh at (1,1,1) --------
        launches["cellpair_half_ext_excl"] = mesh_bilayer_phase(
            card, dev, d, counters_zero, all_counters, rate)
        # --- phase 21 (a): the command file on the same restart -----------
        masters_failed = []
        masters_rows = {"cellpair_half_col_masters": masters_bilayer_part(
            card, dev, d, counters_zero, all_counters, masters_failed)}

    eam_launches, single_rates["eam"] = eam_slice_phases(
        card, counters_zero, counters, eam_counters)
    launches.update(eam_launches)
    assert not any(ext_counters()), ext_counters()

    # --- phase 9: small-input agreement, card vs CPU -------------------------
    def final(where, make_deck, n):
        with tempfile.TemporaryDirectory() as d:
            deck = make_deck(d)
            s = cli_run(["simulate", "-o", deck, "-n", str(n), "--run-dir", d],
                        where)
            return (float(s.ss.energy.eion), float(s.ss.energy.rk),
                    s.ss.state.r.cpu().numpy(),
                    s.ss.box.lengths.cpu().numpy().astype(np.float64))

    cases = (("water 400 beads FREE 40 steps",
              lambda d: water_deck(d, 400, printrate=100, free=True), 40),
             ("bilayer nx=4 FREE NPT 20 steps",
              lambda d: bilayer_deck(d, 4, 20.0, 100, free=True), 20),
             ("EAM crystal nc=5 (500 atoms) FREE 40 steps",
              lambda d: eam_deck(d, 5, 100, free=True), 40))
    for name, make_deck, n in cases:
        (e1, k1, r1, L1), (e0, k0, r0, L0) = (final(w, make_deck, n)
                                              for w in ("cuda", "cpu"))
        dr = r1 - r0
        dr -= L0 * np.round(dr / L0)
        ok = (math.isclose(e1, e0, rel_tol=1e-4, abs_tol=1e-2)
              and math.isclose(k1, k0, rel_tol=1e-3, abs_tol=1e-2)
              and float(np.abs(dr).max()) < 1e-3
              and np.allclose(L1, L0, rtol=1e-5))
        phase("agree", f"{name}, card vs CPU: eion {e1:.6g} vs {e0:.6g}, "
              f"rk {k1:.6g} vs {k0:.6g}, max |dr| {np.abs(dr).max():.3g} nm, "
              f"box {L1.round(5).tolist()} vs {L0.round(5).tolist()}")
        if not ok:
            raise AssertionError(f"{name}: card run disagrees with the CPU run")

    # --- phases 10 and 11: ParallelSimulation at (1,1,1) ------------------
    launches.update(mesh_phases(card, dev, counters_zero, all_counters,
                                single_rates))
    # --- phases 13-16: PAIR, the NPT water box, the cell-block engine -------
    pair_launches, _ = pair_phases(card, dev, counters_zero, all_counters)
    npt_launches, _ = npt_water_phase(card, dev, counters_zero, all_counters)
    for k, v in (*pair_launches.items(), *npt_launches.items()):
        launches[k] += v
    cellblock_phase(card, dev, counters_zero, all_counters)
    # --- phase 17: tabulated EAM ------------------------------------------
    launches.update(tabular_phase(card, dev, counters_zero, all_counters))
    # --- phase 18: the (N,K)-list engine (no kernel) -------------------------
    nlist_phase(card, dev, counters_zero, all_counters)
    # --- phase 19: CHARMM, (C) on the list engine, (E) on #2 and #6 --------
    charmm_launches, charmm_res = charmm_phase(card, dev, counters_zero,
                                               all_counters)
    launches.update(charmm_launches)
    # --- phase 20: item 22's integrators, groups and box(t) on #5 and #2 ----
    int_rows = integrators_phase(card, dev, counters_zero, all_counters)
    # --- phase 21 (b)-(d): item 23's rollback, masters on #1 (and #2) --------
    masters_rows.update(masters_phase(card, dev, counters_zero, all_counters,
                                      masters_failed))
    assert not masters_failed, f"phase 21 gates missed: {masters_failed}"
    # --- phase 22: item 24a's transforms, #1 then #2 in one run -------------
    transforms_failed = []
    transform_rows = transforms_phase(card, dev, counters_zero, all_counters,
                                      transforms_failed)
    assert not transforms_failed, \
        f"phase 22 gates missed: {transforms_failed}"
    # --- phase 23: item 24b's analyses on #1 and #4 ---------------------------
    analyses_failed = []
    analysis_rows_out = analyses_phase(card, dev, counters_zero,
                                       all_counters, analyses_failed)
    assert not analyses_failed, f"phase 23 gates missed: {analyses_failed}"
    # --- phase 24: items 27-30, the bilayer patch's replica on #2 -------------
    rebuilds_failed = []
    rebuild_rows = rebuilds_phase(card, dev, counters_zero, all_counters,
                                  rebuilds_failed)
    assert not rebuilds_failed, f"phase 24 gates missed: {rebuilds_failed}"
    # --- phase 25: item 25's load balance, #6 and #7 under walls ------------
    lb_failed = []
    lb_rows = loadbalance_phase(card, dev, counters_zero, all_counters,
                                lb_failed)
    assert not lb_failed, f"phase 25 gates missed: {lb_failed}"
    # --- phase 26: item 25's brick list engine (no kernel) -----------------
    lm_failed = []
    listmesh_phase(card, dev, counters_zero, all_counters, lm_failed)
    assert not lm_failed, f"phase 26 gates missed: {lm_failed}"
    # --- phase 27: item 25's triclinic bricks and slab engine (no kernel) --
    tri_failed = []
    triclinic_slab_phase(card, dev, counters_zero, all_counters, tri_failed)
    assert not tri_failed, f"phase 27 gates missed: {tri_failed}"
    # --- phase 28: the mesh's outputs at their rates, migrate_rate (#6) ----
    out_failed = []
    out_rows = outputs_phase(card, dev, counters_zero, all_counters,
                             out_failed)
    assert not out_failed, f"phase 28 gates missed: {out_failed}"
    # --- phase 29: item 22's dynamics under the mesh (#6, #7) --------------
    dyn_failed = []
    dyn_rows = dynamics_phase(card, dev, counters_zero, all_counters,
                              dyn_failed)
    assert not dyn_failed, f"phase 29 gates missed: {dyn_failed}"
    # --- phase 30: SIMULATE transform= under the mesh (#6, #6 excl) --------
    mt_failed = []
    mt_rows = mesh_transforms_phase(card, dev, counters_zero, all_counters,
                                    mt_failed)
    assert not mt_failed, f"phase 30 gates missed: {mt_failed}"
    assert "jax" not in sys.modules

    for name, old_us in OLD_BODY_US.items():
        phase("redesign", f"{name}: {1e3 * res[name][1]:.2f} us/call, the "
              f"body it replaced {old_us:.1f} us/call "
              f"({old_us / (1e3 * res[name][1]):.2f}x) on {card}")
    cellpair, eam = "ddcmd_tpu/ops/pallas_cellpair.py", "ddcmd_tpu/ops/pallas_eam.py"
    shard = "ddcmd_tpu/parallel/pallas_shard.py"
    kernels = {   # entry: (source, the TPU kernel it replaces)
        "cellpair_half": ("cellpair_half.cu", f"{cellpair}:559"),
        "cellpair_half_excl": ("cellpair_half.cu", f"{cellpair}:559"),
        "cellpair_half_col": ("cellpair_half.cu", f"{cellpair}:837"),
        "eam_rho": ("eam_half.cu", f"{eam}:230"),
        "eam_force": ("eam_half.cu", f"{eam}:269"),
        "eam_rho_col": ("eam_half_col.cu", f"{eam}:363"),
        "eam_force_col": ("eam_half_col.cu", f"{eam}:411"),
        "cellpair_half_ext": ("cellpair_half.cu", f"{shard}:361"),
        "cellpair_half_ext_excl": ("cellpair_half.cu", f"{shard}:361"),
        "cellpair_full": ("cellpair_half.cu", f"{cellpair}:389"),
        "eam_rho_ext": ("eam_half.cu", f"{shard}:434"),
        "eam_force_ext": ("eam_half.cu", f"{shard}:434"),
        # the tabularFit=rational refit (kernel form RATIONAL_SHIFTED)
        "eam_rho_refit": ("eam_half.cu", f"{eam}:230"),
        "eam_force_refit": ("eam_half.cu", f"{eam}:269"),
        "eam_rho_col_refit": ("eam_half_col.cu", f"{eam}:363"),
        "eam_force_col_refit": ("eam_half_col.cu", f"{eam}:411"),
        "eam_rho_ext_refit": ("eam_half.cu", f"{shard}:434"),
        "eam_force_ext_refit": ("eam_half.cu", f"{shard}:434"),
    }
    # the pair kernels of (E), the CHARMM ethane fluid (T = 2, RF,
    # exclusions), on its own records: #2 in Simulation, #6 in the mesh
    for name, out in charmm_res.items():
        kernels[f"{name}_charmm"] = kernels[name]
        res[f"{name}_charmm"] = out
    # phase 20's paths, each on its own records: (a) NPTGLF and (c) STRAIN
    # on #5, (b) NGLFNK and (d) SHEAR on #2, (e)'s small decks on #1 and
    # #4, the NVEGLF check on #4
    # phase 21's paths: (a) the command file on #2, (b)-(c) the rollback,
    # NEXTFILE and NGLFTEST on #1, (d) the eightFold deck's kernel; phase
    # 22's run: #1 before the replica, #2 after it; phase 23's: #1 on the
    # water box with its analyses, #4 on the crystal with its classifiers;
    # phase 24's: #2 on the bilayer patch's replica; phase 25's: #6 with
    # exclusions on the widest brick of the ZRAMP and of the BISECTION
    # plan, #7 on the widest brick of the skewed-walls crystal; phase 28's:
    # #6 on the water box after its outputs run (a) and after its NVT
    # migrate_rate leg (c); phase 29's: #7 on (a)'s NPTGLF and (e)'s NVEGLF
    # crystal, #6 on (b)'s NGLFNK and (d)'s SHEAR fluid and (c)'s strained
    # water, each with that leg's launches; phase 30's: #6 on (a)'s water
    # replica, #6 with exclusions on (b)'s bilayer replica
    for row, (name, n, out) in (*int_rows.items(), *masters_rows.items(),
                                *transform_rows.items(),
                                *analysis_rows_out.items(),
                                *rebuild_rows.items(), *lb_rows.items(),
                                *out_rows.items(), *dyn_rows.items(),
                                *mt_rows.items()):
        kernels[row] = kernels[name]
        launches[row] = n
        res[row] = out
    idle = [name for name in kernels if not launches.get(name)]
    assert not idle, f"kernels never launched on their paths: {idle}"
    # no single PyTorch call computes a cell-list half-stencil sum, so
    # library_ms is null for every kernel
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "ddcmd_tpu_torch/csrc/" + src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": res[name][0],
         "ms": res[name][1], "plain_ms": res[name][2],
         "bound_ms": res[name][3], "bound_by": res[name][4],
         "library_ms": None}
        for name, (src, tpu) in kernels.items()]}))
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
