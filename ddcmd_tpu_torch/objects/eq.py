"""eq parser: time-dependent target expressions (Teq/Peq/Veq ramps).

Reference: ddcMD src/eq.c:11-152.  Grammar:
  "310"                      constant
  "RAMP(v0, v1, t0, tau)"    linear ramp from v0 to v1 over [t0, t0+tau]
  "STEP(v0, v1, t0, -)"      step at t0
  "EXP(v0, v1, t0, tau)"     exponential relaxation
  "COS(v0, v1, t0, tau)"     oscillation with period tau
Each argument may carry its own unit suffix; bare values use the
provided return/arg default units.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

from . import units as U


@dataclass
class EqTarget:
    kind: str
    v0: float
    v1: float = 0.0
    t0: float = 0.0
    tau: float = 1.0

    def __call__(self, t: float) -> float:
        if self.kind == "CONSTANT":
            return self.v0
        if t < self.t0:
            return self.v0
        if self.kind == "STEP":
            return self.v1
        if self.kind == "RAMP":
            if t > self.t0 + self.tau:
                return self.v1
            return self.v0 + (self.v1 - self.v0) * (t - self.t0) / self.tau
        if self.kind == "EXP":
            f = math.exp((self.t0 - t) / self.tau)
            return self.v0 * f + self.v1 * (1.0 - f)
        if self.kind == "COS":
            return 0.5 * ((self.v0 + self.v1) + (self.v0 - self.v1)
                          * math.cos(2.0 * math.pi * (t - self.t0) / self.tau))
        raise ValueError(self.kind)

    def integral(self, t1: float, t2: float) -> float:
        """Closed-form time integral (reference eq*Integral forms)."""
        def F(t):
            if self.kind == "CONSTANT":
                return self.v0 * t
            if t < self.t0:
                return self.v0 * t
            if self.kind == "STEP":
                return self.v1 * t
            if self.kind == "RAMP":
                if t > self.t0 + self.tau:
                    return self.v1 * t
                return self.v0 * t + 0.5 * (self.v1 - self.v0) * (t - self.t0) ** 2 / self.tau
            if self.kind == "EXP":
                f = math.exp((self.t0 - t) / self.tau)
                return -self.tau * (self.v0 * f + self.v1 * (1.0 - f))
            if self.kind == "COS":
                return 0.5 * ((self.v0 + self.v1) * t
                              + self.tau / (2 * math.pi) * (self.v0 - self.v1)
                              * math.sin(2 * math.pi * (t - self.t0) / self.tau))
            raise ValueError(self.kind)
        return F(t2) - F(t1)


_FN_RE = re.compile(r"^\s*(RAMP|STEP|EXP|COS)\s*\((.*)\)\s*$", re.I)


def _value(tok: str, default_unit: str) -> float:
    return U.parse_with_units(tok.strip(), default_unit)


def eq_parse(text: str, return_unit: str, arg_unit: str) -> EqTarget:
    text = text.strip().strip('"')
    m = _FN_RE.match(text)
    if not m:
        return EqTarget(kind="CONSTANT", v0=_value(text, return_unit))
    kind = m.group(1).upper()
    args = [a for a in re.split(r"[,\s]+", m.group(2).strip()) if a]
    # args may be "310 K" pairs; re-join number+unit tokens
    merged: list[str] = []
    for a in args:
        if merged and not _is_number_start(a):
            merged[-1] += " " + a
        else:
            merged.append(a)
    if len(merged) < 4:
        raise ValueError(f"eq expression needs 4 args: {text!r}")
    return EqTarget(
        kind=kind,
        v0=_value(merged[0], return_unit),
        v1=_value(merged[1], return_unit),
        t0=_value(merged[2], arg_unit),
        tau=_value(merged[3], arg_unit),
    )


def _is_number_start(tok: str) -> bool:
    return bool(re.match(r"^[+-]?(\d|\.\d)", tok))
