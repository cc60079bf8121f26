"""SPECIES table (reference: ddcMD src/species.c).

Host-side metadata; per-particle species index lives in State.species.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..objects import ObjectDB
from ..objects import units as U


@dataclass
class Species:
    name: str
    index: int
    type: str      # ATOM
    charge: float  # e
    mass: float    # amu
    deck_id: int = -1


def species_from_deck(db: ObjectDB, names: list[str]) -> list[Species]:
    out = []
    for i, name in enumerate(names):
        obj = db.get(name, "SPECIES")
        out.append(Species(
            name=name,
            index=i,
            type=obj.get_str("type", "ATOM"),
            charge=obj.get_with_units("charge", "0.0", "q"),
            mass=obj.get_with_units("mass", "1.0", "m"),
            deck_id=obj.get_int("id", -1),
        ))
    return out
