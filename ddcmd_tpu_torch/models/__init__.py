"""Model families: programmatic deck builders (the Martini water box,
the Martini DPPC bilayer and the EAM copper crystal)."""

from .builders import (eam_crystal, load, martini_bilayer, martini_water,
                       write_atoms)

__all__ = ["eam_crystal", "load", "martini_bilayer", "martini_water",
           "write_atoms"]
