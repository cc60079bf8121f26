"""printinfo: per-printrate thermodynamic table.

Counterpart of ddcmd_tpu/run/printinfo.py (a copy: it is host code).
Reference: ddcMD src/printinfo.c:100-260.  Column set and
formats mirror printinfoA: loop, time, Etotal/Ekin/Epot per atom, Temp,
Press, Volume per atom, lx/ly/lz -- each in the unit chosen by the
PRINTINFO object (deck: PRESSURE=bar; ENERGY=kJ/mol; TIME=ns; ...).
Rank-0 writes to stdout and appends to ./data.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..objects import ObjectDB
from ..objects import units as U


@dataclass
class PrintInfo:
    c_time: float
    c_energy: float
    c_temp: float
    c_press: float
    c_vol: float
    c_len: float
    u_time: str
    u_energy: str
    u_temp: str
    u_press: str
    u_vol: str
    u_len: str
    print_molecular_pressure: bool
    print_stress: bool
    print_graphs: bool = False
    datafile: str = "data"
    _wrote_header: bool = False

    @classmethod
    def from_deck(cls, db: ObjectDB, name: str | None) -> "PrintInfo":
        obj = db.find(name, "PRINTINFO") if name else None

        def conv(key, default):
            unit = obj.get_str(key, default) if obj is not None else default
            return U.convert(1.0, None, unit), unit

        c_t, u_t = conv("TIME", "fs")
        c_e, u_e = conv("ENERGY", "eV")
        c_T, u_T = conv("TEMPERATURE", "K")
        c_p, u_p = conv("PRESSURE", "GPa")
        c_v, u_v = conv("VOLUME", "Ang^3")
        c_l, u_l = conv("LENGTH", "Ang")
        return cls(
            c_time=c_t, c_energy=c_e, c_temp=c_T, c_press=c_p, c_vol=c_v, c_len=c_l,
            u_time=u_t, u_energy=u_e, u_temp=u_T, u_press=u_p, u_vol=u_v, u_len=u_l,
            print_molecular_pressure=bool(obj.get_int("printMolecularPressure", 0)) if obj else False,
            print_stress=bool(obj.get_int("printStress", 0)) if obj else False,
            print_graphs=bool(obj.get_int("printGraphs", 0)) if obj else False,
        )

    def header(self) -> str:
        cols = [
            ("#loop", 12), (f"time({self.u_time})", 16),
            (f"Etotal({self.u_energy})", 18), (f"Ekin({self.u_energy})", 18),
            (f"Epot({self.u_energy})", 18), (f"Temp({self.u_temp})", 18),
            (f"Press({self.u_press})", 18), (f"Volume({self.u_vol})", 18),
            (f"lx({self.u_len})", 15), (f"ly({self.u_len})", 15), (f"lz({self.u_len})", 15),
        ]
        return " ".join(f"{name:>{w}}" for name, w in cols)

    def row(self, loop, time, eion, rk, temperature, pressure, volume, h_diag, n_global) -> str:
        etot = self.c_energy * (eion + rk) / n_global
        ekin = self.c_energy * rk / n_global
        epot = self.c_energy * eion / n_global
        return (
            f"{loop:>12d} {self.c_time * time:16.6f} {etot:18.12f} {ekin:18.12f} "
            f"{epot:18.12f} {self.c_temp * temperature:18.8f} "
            f"{self.c_press * pressure:18.12f} {self.c_vol * volume / n_global:18.12f} "
            f"{self.c_len * h_diag[0]:15.8f} {self.c_len * h_diag[1]:15.8f} "
            f"{self.c_len * h_diag[2]:15.8f}"
        )

    def emit(self, line: str, run_dir: str = "."):
        if not self._wrote_header:
            hdr = self.header()
            print(hdr)
            with open(os.path.join(run_dir, self.datafile), "a") as f:
                f.write(hdr + "\n")
            self._wrote_header = True
        print(line)
        with open(os.path.join(run_dir, self.datafile), "a") as f:
            f.write(line + "\n")
