"""Model families: programmatic deck builders (the Martini water box,
the Martini DPPC bilayer, the Lennard-Jones fluid and the EAM copper
crystal)."""

from .builders import (eam_crystal, lj_fluid, load, martini_bilayer,
                       martini_water, write_atoms)

__all__ = ["eam_crystal", "lj_fluid", "load", "martini_bilayer",
           "martini_water", "write_atoms"]
