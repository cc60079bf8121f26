from .parser import DeckError, DeckObject, ObjectDB, read_fileheader
from . import units

__all__ = ["DeckError", "DeckObject", "ObjectDB", "read_fileheader", "units"]
