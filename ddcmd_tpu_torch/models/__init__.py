"""Model families: programmatic deck builders (the Martini water box)."""

from .builders import load, martini_water, write_atoms

__all__ = ["load", "martini_water", "write_atoms"]
