"""Model families: programmatic deck builders (the Martini water box and
the Martini DPPC bilayer)."""

from .builders import load, martini_bilayer, martini_water, write_atoms

__all__ = ["load", "martini_bilayer", "martini_water", "write_atoms"]
