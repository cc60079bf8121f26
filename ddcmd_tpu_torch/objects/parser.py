"""ddcMD object-database deck parser.

Parses the `name CLASS { key=value; ... }` grammar used by every ddcMD
config file (decks, restart files, martini.data, FILEHEADERs).  The
reference implementation lives in LLNL's simutil object.c (missing from
the mount; grammar reconstructed from call sites, e.g.
ddcMD src/simulate.c:141-169 and the annotated template deck
ddcMD examples/object/object.data).

Grammar notes:
  * `//` comments run to end of line.
  * Braces / `=` / `;` may be glued to words (`GROUPPARMS{`, `type=MD;`).
  * A value is the token list between `=` and `;` (lists are
    whitespace-separated: `groups= group free;`).
  * Values may carry unit suffixes, with or without a space
    (`11.0 Angstrom`, `310K`, `3.0e-4/bar`).
  * Multiple objects may share a file; later definitions of the same
    (name, class) MERGE into earlier ones with later keywords winning --
    this is how `restart` overrides `object.data` (SIMULATE loop/time,
    BOX h) when both are compiled into one DB
    (ddcMD src/objectSetup.c:40-44).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

from . import units as U


class DeckError(ValueError):
    pass


_SPECIALS = "{}=;"


def tokenize(text: str):
    """Yield (token, is_special) preserving deck semantics."""
    out = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*/", i + 2)
            if j < 0:
                raise DeckError("unterminated /* comment")
            i = j + 2
            continue
        if c.isspace():
            i += 1
            continue
        if c in _SPECIALS:
            out.append(c)
            i += 1
            continue
        j = i
        while j < n and (not text[j].isspace()) and text[j] not in _SPECIALS \
                and not (text[j] == "/" and j + 1 < n and text[j + 1] in "/*"):
            j += 1
        out.append(text[i:j])
        i = j
    return out


@dataclass
class DeckObject:
    """One `name CLASS { ... }` object."""

    name: str
    objclass: str
    keywords: dict[str, list[str]] = field(default_factory=dict)

    # -- typed getters mirroring object_get ---------------------------------

    def has(self, key: str) -> bool:
        return key in self.keywords

    def raw(self, key: str, default: str | None = None) -> list[str]:
        if key in self.keywords:
            return self.keywords[key]
        if default is None:
            return []
        return default.split()

    def get_str(self, key: str, default: str | None = None) -> str:
        toks = self.raw(key, default)
        if not toks:
            if default is None:
                raise DeckError(f"{self.name} {self.objclass}: missing keyword {key!r}")
            return default
        return toks[0]

    def get_literal(self, key: str, default: str | None = None) -> str:
        toks = self.raw(key, default)
        return " ".join(toks)

    def get_strv(self, key: str, default: str = "") -> list[str]:
        return self.raw(key, default)

    def get_int(self, key: str, default: int | None = None) -> int:
        toks = self.raw(key, None if default is None else str(default))
        if not toks:
            raise DeckError(f"{self.name} {self.objclass}: missing keyword {key!r}")
        return int(toks[0], 0)

    def get_bool(self, key: str, default: int = 0) -> bool:
        return bool(self.get_int(key, default))

    def get_float(self, key: str, default: float | None = None) -> float:
        toks = self.raw(key, None if default is None else repr(default))
        if not toks:
            raise DeckError(f"{self.name} {self.objclass}: missing keyword {key!r}")
        return float(toks[0])

    def get_floatv(self, key: str, default: str = "") -> list[float]:
        return [float(t) for t in self.raw(key, default)]

    def get_with_units(self, key: str, default_value: str, default_unit: str) -> float:
        """object_get(..., WITH_UNITS, default_value, default_unit)."""
        toks = self.raw(key, None)
        text = " ".join(toks) if toks else default_value
        return U.parse_with_units(text, default_unit)

    def get_with_unitsv(self, key: str, default_value: str, default_unit: str) -> list[float]:
        """List-of-values variant; every element shares one optional unit
        suffix (`h= 93.8 0 0 ... ;` carries none)."""
        toks = self.raw(key, None)
        if not toks:
            toks = default_value.split()
        nums: list[float] = []
        unit = ""
        for t in toks:
            m = U._VALUE_RE.match(t)
            if m and not m.group(2):
                nums.append(float(m.group(1).replace("d", "e").replace("D", "E")))
            elif m:  # number glued to unit, e.g. 310K
                nums.append(float(m.group(1)))
                unit = m.group(2)
            else:
                unit = (unit + " " + t).strip()
        scale = U.unit_scale(unit if unit else default_unit)
        return [v * scale for v in nums]


class ObjectDB:
    """The compiled object database: (name -> DeckObject), class-indexed."""

    def __init__(self):
        # keyed by (name, class): distinct classes may share a name, e.g. the
        # waterbox deck has both `martini POTENTIAL` and `martini MMFF`.
        self.objects: dict[tuple[str, str], DeckObject] = {}

    # -- compilation ---------------------------------------------------------

    def compile_string(self, text: str):
        toks = tokenize(text)
        i, n = 0, len(toks)
        while i < n:
            name = toks[i]
            if name in _SPECIALS:
                raise DeckError(f"expected object name, got {name!r}")
            if i + 1 >= n:
                raise DeckError(f"dangling token {name!r}")
            objclass = toks[i + 1]
            if toks[i + 2] != "{":
                raise DeckError(f"expected '{{' after '{name} {objclass}'")
            i += 3
            obj = self.objects.get((name, objclass))
            if obj is None:
                obj = DeckObject(name, objclass)
                self.objects[(name, objclass)] = obj
            while i < n and toks[i] != "}":
                key = toks[i]
                if i + 1 >= n or toks[i + 1] != "=":
                    raise DeckError(f"{name} {objclass}: expected '=' after {key!r}")
                i += 2
                vals: list[str] = []
                while i < n and toks[i] != ";":
                    if toks[i] in "{}=":
                        raise DeckError(f"{name} {objclass}: bad token {toks[i]!r} in value of {key!r}")
                    vals.append(toks[i])
                    i += 1
                if i >= n:
                    raise DeckError(f"{name} {objclass}: unterminated value for {key!r}")
                i += 1  # consume ';'
                obj.keywords[key] = vals
            if i >= n:
                raise DeckError(f"{name} {objclass}: missing closing '}}'")
            i += 1  # consume '}'
        return self

    def compile_file(self, path: str | os.PathLike):
        with open(path) as f:
            self.compile_string(f.read())
        return self

    # -- lookup --------------------------------------------------------------

    def find(self, name: str, objclass: str | None = None) -> DeckObject | None:
        if objclass is not None:
            return self.objects.get((name, objclass))
        matches = [o for (n, _c), o in self.objects.items() if n == name]
        if not matches:
            return None
        if len(matches) > 1:
            raise DeckError(
                f"object name {name!r} is ambiguous (classes "
                f"{[o.objclass for o in matches]}); pass objclass")
        return matches[0]

    def get(self, name: str, objclass: str | None = None) -> DeckObject:
        obj = self.find(name, objclass)
        if obj is None:
            raise DeckError(f"object {name!r}" + (f" of class {objclass}" if objclass else "") + " not found")
        return obj

    def by_class(self, objclass: str) -> list[DeckObject]:
        return [o for o in self.objects.values() if o.objclass == objclass]

    def replace_keyword(self, name: str, key: str, value: str, objclass: str | None = None):
        self.get(name, objclass).keywords[key] = value.split()


_FILEHEADER_RE = re.compile(r"\}", re.M)


def read_fileheader(path: str | os.PathLike) -> tuple[DeckObject, int]:
    """Read the embedded FILEHEADER object at the top of an atoms# shard.

    Returns (header_object, data_offset_bytes).  The header is object
    text terminated by the first '}' (see
    ddcMD examples/waterbox/snapshot.mem/atoms#000000:1-13).
    """
    with open(path, "rb") as f:
        head = f.read(65536).decode("utf-8", errors="replace")
    m = _FILEHEADER_RE.search(head)
    if not m:
        raise DeckError(f"{path}: no FILEHEADER found")
    text = head[: m.end()]
    db = ObjectDB().compile_string(text)
    hdr = db.by_class("FILEHEADER")
    if not hdr:
        raise DeckError(f"{path}: leading object is not a FILEHEADER")
    # data starts after the closing '}' + following newline(s)
    off = m.end()
    while off < len(head) and head[off] in " \t\r\n":
        off += 1
    return hdr[0], off
