"""Unit system for ddcmd_tpu.

The reference (ddcMD) uses internal units of bohr/Rydberg/fs/e
(ddcMD src/ddcMD.c:42-73) and external units of
Angstrom/amu/fs/e/K.  Those were chosen for a C code doing all math in
f64.  On TPU we compute in f32, so we instead pick the "GROMACS-natural"
internal system, in which Martini/CHARMM parameters are O(1) and the
equations of motion need no conversion constants:

    length      nm
    time        ps
    mass        amu (g/mol)
    charge      e
    temperature K
    energy      kJ/mol   (== amu nm^2 / ps^2, consistent)
    pressure    kJ/mol/nm^3 (= 16.6054 bar)

Deck compatibility: values in object decks may carry unit suffixes
("11.0 Angstrom", "310K", "3.0e-4/bar", "72.0 M_p").  `convert` parses
any such unit expression and returns the value in internal units.  Bare
numbers are interpreted in the per-call default unit, mirroring
ddcMD's object_get(..., WITH_UNITS, default_value, default_unit)
convention (e.g. ddcMD src/bioMartini.c:1231-1240).

Dimension symbols ("l", "t", "m", "T", "pressure", "1/pressure",
"energy", ...) are accepted as unit names and map to ddcMD's *external*
units (Angstrom, fs, amu, K, ...), which is what a bare deck number
means in the reference.
"""

from __future__ import annotations

import math
import re
from fractions import Fraction

# ----------------------------------------------------------------------------
# Physical constants (CODATA 2018), expressed in internal units.
# ----------------------------------------------------------------------------

#: Boltzmann constant, kJ/(mol K)
kB = 0.00831446261815324
#: Coulomb constant 1/(4 pi eps0), kJ/mol * nm / e^2
ke = 138.93545764438198
#: Avogadro
N_A = 6.02214076e23

# Unit magnitudes in internal units ------------------------------------------
_BOHR_NM = 0.052917721090380
_HARTREE = 2625.4996394798254  # kJ/mol
_RYDBERG = 0.5 * _HARTREE
_EV = 96.48533212331001  # kJ/mol
_KCAL = 4.184  # kJ
_BAR = 0.06022140760  # kJ/mol/nm^3  (1e5 Pa * 1e-27 m^3/nm^3 * N_A / 1e3)
_ATM = 1.01325 * _BAR
_GPA = 1e4 * _BAR
_M_PROTON = 1.007276466621  # amu
_M_ELECTRON = 5.48579909065e-4  # amu
_KG = 1e3 * N_A  # amu
_METER = 1e9  # nm
_SECOND = 1e12  # ps
_JOULE = N_A / 1e3  # kJ/mol
_COULOMB = 1.0 / 1.602176634e-19  # e

# Dimension exponents: (length, mass, time, charge, temperature, amount)
_DIMLESS = (0, 0, 0, 0, 0, 0)


def _d(l=0, m=0, t=0, q=0, T=0, n=0):
    return (l, m, t, q, T, n)


# name -> (scale_to_internal, dims)
_UNITS: dict[str, tuple[float, tuple]] = {}


def _add(names, scale, dims):
    for n in names:
        _UNITS[n] = (float(scale), dims)


# length
_add(["nm"], 1.0, _d(l=1))
_add(["Angstrom", "angstrom", "Ang", "ang", "A", "Bohr_Ang"], 0.1, _d(l=1))
_add(["bohr", "a0", "Bohr"], _BOHR_NM, _d(l=1))
_add(["um", "micron"], 1e3, _d(l=1))
_add(["mm"], 1e6, _d(l=1))
_add(["cm"], 1e7, _d(l=1))
_add(["meter"], _METER, _d(l=1))
# ddcMD dimension letters usable inside compound unit strings
# ("m*l^2/t^2/T" etc.); they denote the *external* unit of that dimension.
# NOTE: "m" therefore means mass (amu) here, not meters.
_add(["l"], 0.1, _d(l=1))
# time
_add(["ps"], 1.0, _d(t=1))
_add(["fs", "t"], 1e-3, _d(t=1))
_add(["ns"], 1e3, _d(t=1))
_add(["us"], 1e6, _d(t=1))
_add(["s"], _SECOND, _d(t=1))
# mass
_add(["amu", "u", "Da", "dalton", "m"], 1.0, _d(m=1))
_add(["M_p", "Mp", "m_p"], _M_PROTON, _d(m=1))
_add(["M_e", "m_e"], _M_ELECTRON, _d(m=1))
_add(["kg"], _KG, _d(m=1))
_add(["g", "gram"], _KG / 1e3, _d(m=1))
# charge
_add(["e", "e-charge"], 1.0, _d(q=1))
_add(["C", "coulomb"], _COULOMB, _d(q=1))
# temperature
_add(["K", "Kelvin", "kelvin", "T"], 1.0, _d(T=1))
# amount
_add(["mol", "mole"], 1.0, _d(n=0))  # internal energies are already molar
# energy
_add(["kJ"], 1.0, _d(l=2, m=1, t=-2))  # per-mole implied (see module docstring)
_add(["J"], 1e-3, _d(l=2, m=1, t=-2))
_add(["kcal"], _KCAL, _d(l=2, m=1, t=-2))
_add(["cal"], _KCAL / 1e3, _d(l=2, m=1, t=-2))
_add(["eV"], _EV, _d(l=2, m=1, t=-2))
_add(["Ry", "Rydberg"], _RYDBERG, _d(l=2, m=1, t=-2))
_add(["Hartree", "Ha"], _HARTREE, _d(l=2, m=1, t=-2))
# pressure
_add(["bar"], _BAR, _d(l=-1, m=1, t=-2))
_add(["atm"], _ATM, _d(l=-1, m=1, t=-2))
_add(["Pa"], 1e-5 * _BAR, _d(l=-1, m=1, t=-2))
_add(["kPa"], 1e-2 * _BAR, _d(l=-1, m=1, t=-2))
_add(["MPa"], 10.0 * _BAR, _d(l=-1, m=1, t=-2))
_add(["GPa"], _GPA, _d(l=-1, m=1, t=-2))
# misc
_add(["cc"], 1e21, _d(l=3))  # cm^3
# ddcMD composite dimension words usable inside unit expressions,
# valued at the reference's external units (Ang, amu, fs, e, K)
_add(["pressure"], 1.0 / (0.1 * 1e-3 * 1e-3), _d(l=-1, m=1, t=-2))  # amu/Ang/fs^2
_add(["energy"], 1.0 / (1e-3 * 1e-3) * 0.01, _d(l=2, m=1, t=-2))    # amu*Ang^2/fs^2
_add(["velocity"], 0.1 / 1e-3, _d(l=1, t=-1))                        # Ang/fs
_add(["i"], 1.0 / 1e-3, _d(q=1, t=-1))                               # e/fs (current)

# ddcMD dimension symbols -> external unit (what a bare deck number means).
# External units per ddcMD src/ddcMD.c:71-73:
#   Ang, amu, fs, e/fs (current), K.
_DIMSYMBOLS = {
    "l": "Angstrom",
    "t": "fs",
    "m": "amu",
    "T": "K",
    "q": "e",
    "energy": "amu*Angstrom^2/fs^2",
    "pressure": "amu/Angstrom/fs^2",
    "1/pressure": "Angstrom*fs^2/amu",
    "velocity": "Angstrom/fs",
    "l/t": "Angstrom/fs",
    "m*l^2/t^2/T": "amu*Angstrom^2/fs^2/K",
    "m*l^2/t^2": "amu*Angstrom^2/fs^2",
    "m/l^3": "amu/Angstrom^3",
}

_TOKEN_RE = re.compile(r"\s*([A-Za-z_][A-Za-z0-9_\-]*|\^|[*/()]|-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)")


class UnitError(ValueError):
    pass


class _Parser:
    """Parse unit expressions: terms joined by * and /, each a name with
    optional ^exponent (integer or simple fraction); parentheses allowed."""

    def __init__(self, text: str):
        self.tokens = []
        pos = 0
        while pos < len(text):
            mm = _TOKEN_RE.match(text, pos)
            if not mm:
                if text[pos:].strip() == "":
                    break
                raise UnitError(f"bad unit expression: {text!r} at {pos}")
            self.tokens.append(mm.group(1))
            pos = mm.end()
        self.i = 0

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def parse(self):
        scale, dims = self.expr()
        if self.peek() is not None:
            raise UnitError(f"trailing tokens in unit: {self.tokens[self.i:]}")
        return scale, dims

    def expr(self):
        scale, dims = self.factor()
        while self.peek() in ("*", "/"):
            op = self.next()
            s2, d2 = self.factor()
            if op == "*":
                scale *= s2
                dims = tuple(a + b for a, b in zip(dims, d2))
            else:
                scale /= s2
                dims = tuple(a - b for a, b in zip(dims, d2))
        return scale, dims

    def factor(self):
        tok = self.next()
        if tok is None:
            raise UnitError("empty unit expression")
        if tok == "(":
            scale, dims = self.expr()
            if self.next() != ")":
                raise UnitError("unbalanced parens in unit")
        elif _isnumber(tok):
            scale, dims = float(tok), _DIMLESS
        else:
            if tok not in _UNITS:
                raise UnitError(f"unknown unit {tok!r}")
            scale, dims = _UNITS[tok]
        if self.peek() == "^":
            self.next()
            exp_tok = self.next()
            neg = False
            if exp_tok == "-":  # pragma: no cover - tokenizer folds the sign
                neg = True
                exp_tok = self.next()
            try:
                exp = Fraction(exp_tok)
            except (ValueError, ZeroDivisionError) as err:
                raise UnitError(f"bad exponent {exp_tok!r}") from err
            if neg:
                exp = -exp
            scale = scale ** float(exp)
            dims = tuple(a * exp for a in dims)
        return scale, dims


def _isnumber(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _resolve(unit: str):
    unit = unit.strip()
    if unit in ("", "1", "none", "None"):
        return 1.0, _DIMLESS
    if unit in _DIMSYMBOLS:
        unit = _DIMSYMBOLS[unit]
    if unit.startswith("/"):
        unit = "1" + unit
    return _Parser(unit).parse()


def unit_scale(unit: str) -> float:
    """Multiplier converting a value in `unit` to internal units."""
    return _resolve(unit)[0]


def convert(value: float, from_unit: str | None = None, to_unit: str | None = None) -> float:
    """Mirror of ddcMD units_convert(value, from, to): None = internal."""
    s_from, d_from = _resolve(from_unit) if from_unit else (1.0, None)
    s_to, d_to = _resolve(to_unit) if to_unit else (1.0, None)
    if d_from is not None and d_to is not None and d_from != d_to:
        raise UnitError(f"incompatible units {from_unit!r} -> {to_unit!r}")
    return value * s_from / s_to


_VALUE_RE = re.compile(r"^\s*([+-]?(?:\d+\.?\d*|\.\d+)(?:[eEdD][+-]?\d+)?)\s*(.*)$")


def parse_with_units(text: str, default_unit: str | None = None) -> float:
    """Parse a deck value like '11.0 Angstrom', '310K', '3.0e-4/bar', '20'.

    A bare number is interpreted in `default_unit` (ddcMD object_get
    WITH_UNITS semantics).  Returns the value in internal units.
    """
    mm = _VALUE_RE.match(text)
    if not mm:
        raise UnitError(f"cannot parse value {text!r}")
    num = float(mm.group(1).replace("d", "e").replace("D", "E"))
    unit = mm.group(2).strip()
    if not unit:
        unit = default_unit or ""
    return num * unit_scale(unit) if unit else num


# ddcMD-style checkpoint unit names (what goes in restart files); we keep
# writing the reference's external conventions so files stay compatible
# (ddcMD src/ddcMD.c:73 "checkpointUnits(Ang,amu,fs,e/fs,K)").
CHECKPOINT_UNITS = ("Ang", "amu", "fs", "e/fs", "K", " ", "cd")

#: scale: internal length -> Angstrom
LENGTH_TO_ANG = 10.0
ANG_TO_LENGTH = 0.1
#: scale: internal velocity (nm/ps) -> Ang/fs
VEL_TO_ANG_FS = 10.0 / 1e3
ANG_FS_TO_VEL = 1e3 / 10.0
#: internal time (ps) -> fs
TIME_TO_FS = 1e3
FS_TO_TIME = 1e-3
