"""Reading/writing particle collections (atoms# shard files).

Mirrors the reference's pio + collection_read/collection_write formats
(ddcMD src/collection_read.c:39-73,
ddcMD src/collection_write.c:60-160) so existing snapshots
restart unchanged:

  * `files=dir/atoms#` names a family of shards atoms#000000, atoms#000001...
  * each shard may start with a FILEHEADER object (rank 0's shard always
    does) describing datatype/fields/h-matrix;
  * VARRECORDASCII: newline-delimited whitespace-split records;
  * FIXRECORDASCII: fixed recordLength byte records (leading checksum field);
  * fields per the header's field_names/field_types (u=uint, s=string,
    f=float); lengths/velocities are in checkpoint units Ang, Ang/fs.
"""

from __future__ import annotations

import glob
import os
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..objects import DeckError, ObjectDB, read_fileheader
from ..objects import units as U


@dataclass
class CollectionData:
    """Host-side particle data in INTERNAL units (nm, nm/ps)."""

    gid: np.ndarray            # (n,) uint64
    species_names: list[str]   # per particle
    group_names: list[str]     # per particle
    class_names: list[str]     # per particle (ATOM, ...)
    r: np.ndarray              # (n,3) nm
    v: np.ndarray              # (n,3) nm/ps
    header: object | None = None
    extra: dict = field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.gid)


def shard_paths(files_value: str, base_dir: str | os.PathLike = ".") -> list[str]:
    """Expand `files=snapshot.mem/atoms#` into the existing shard list."""
    pattern = os.path.join(base_dir, files_value)
    if "#" in pattern:
        paths = sorted(glob.glob(pattern.replace("#", "#[0-9]*")))
        if not paths and os.path.exists(pattern):
            paths = [pattern]
    else:
        paths = [pattern]
    if not paths:
        raise FileNotFoundError(f"no collection shards match {pattern!r}")
    return paths


def _parse_records(tokens_rows, field_names, field_types):
    cols: dict[str, list] = {name: [] for name in field_names}
    for row in tokens_rows:
        if len(row) < len(field_names):
            if not row:
                continue
            raise DeckError(f"short record: {row!r}")
        for name, ftype, tok in zip(field_names, field_types, row):
            if ftype.startswith("f"):
                cols[name].append(float(tok))
            else:
                # integer fields stay as raw tokens; base (dec/hex per the
                # header's field_format) is resolved by the caller
                cols[name].append(tok)
    return cols


def _parse_all(bodies: list[bytes], field_names, field_types, nrecord, gid_hex):
    """Parse shards via the native codec; pure-Python fallback."""
    from . import fastio

    max_records = nrecord if nrecord > 0 else sum(
        b.count(b"\n") + 1 for b in bodies)
    body = b"\n".join(bodies)
    native = fastio.parse_records(body, field_types, max_records, gid_hex)
    if native is not None:
        n, kinds, floats, uints, strs = native
        cols: dict[str, object] = {}
        fi = ui = si = 0
        for name, k in zip(field_names, kinds):
            if k == fastio.FK_FLOAT:
                cols[name] = floats[fi]
                fi += 1
            elif k in (fastio.FK_UDEC, fastio.FK_UHEX):
                cols[name] = uints[ui]
                ui += 1
            else:
                cols[name] = [s.decode() for s in strs[si]]
                si += 1
        return cols

    rows = []
    for b in bodies:
        for line in b.decode("utf-8", errors="replace").splitlines():
            line = line.strip()
            if line:
                rows.append(line.split())
    return _parse_records(rows, field_names, field_types)


def read_collection(files_value: str, base_dir: str | os.PathLike = ".",
                    gid_hex: bool | None = None,
                    header_length: int | None = None) -> CollectionData:
    """header_length: byte offset override for the data start, from the
    COLLECTION deck's headerLength keyword (the reference rewrites the
    FILEHEADER's headerLength from it, objectSetup.c:63-73) -- lets old
    snapshots with nonstandard header framing load."""
    paths = shard_paths(files_value, base_dir)
    header, _ = read_fileheader(paths[0])
    # legacy FILEHEADER keyword defaults (collection_read,
    # ddcMD src/collection.c:171-172): headers from old ddcMD
    # snapshots may lack the groups/types lists -- default them to the
    # single group "group" and species type "ATOM"
    if not header.has("groups"):
        header.keywords["groups"] = ["group"]
    if not header.has("types"):
        header.keywords["types"] = ["ATOM"]
    datatype = header.get_str("datatype", "VARRECORDASCII")
    field_names = header.get_strv("field_names")
    field_types = header.get_strv("field_types")
    if len(field_names) != len(field_types):
        raise DeckError("field_names/field_types length mismatch")

    # id column may be written in hex (deck gidFormat=hex); the header's
    # field_format records it (reference writes fmt with gidFormat(),
    # collection_write.c:69).
    if gid_hex is None:
        gid_hex = False
        fmt_toks = header.get_strv("field_format")
        if fmt_toks and "id" in field_names:
            i = field_names.index("id")
            if i < len(fmt_toks):
                gid_hex = fmt_toks[i].rstrip().endswith("x")

    nrecord = header.get_int("nrecord", -1)
    if datatype == "FIXRECORDBINARY":
        return _read_binary(paths, header, gid_hex,
                            header_length=header_length)
    if datatype not in ("VARRECORDASCII", "FIXRECORDASCII", "ASCII"):
        raise NotImplementedError(f"collection datatype {datatype} not supported")

    bodies = []
    for p in paths:
        with open(p, "rb") as f:
            blob = f.read()
        off = 0
        head = blob[:256].decode("utf-8", errors="replace")
        if head.lstrip().split(None, 2)[1:2] == ["FILEHEADER"]:
            _, off = read_fileheader(p)
        if header_length and header_length > 0:
            off = header_length        # COLLECTION headerLength override
        bodies.append(blob[off:])

    cols = _parse_all(bodies, field_names, field_types, nrecord, gid_hex)
    n = len(next(iter(cols.values()))) if cols else 0
    if nrecord >= 0 and n != nrecord:
        raise DeckError(f"expected {nrecord} records, parsed {n}")

    base = 16 if gid_hex else 10
    ids = cols.get("id", ["0"] * n)
    if isinstance(ids, np.ndarray):
        gid = ids.astype(np.uint64)
    else:
        gid = np.asarray([int(str(t), base) for t in ids], dtype=np.uint64)

    cAng = U.ANG_TO_LENGTH  # file lengths are Ang (checkpoint units)
    cVel = U.ANG_FS_TO_VEL
    r = np.stack([np.asarray(cols[k], dtype=np.float64) * cAng for k in ("rx", "ry", "rz")], axis=1)
    if "vx" in cols:
        v = np.stack([np.asarray(cols[k], dtype=np.float64) * cVel for k in ("vx", "vy", "vz")], axis=1)
    else:
        v = np.zeros_like(r)

    known = {"id", "checksum", "class", "type", "group", "rx", "ry", "rz", "vx", "vy", "vz"}
    extra = {k: cols[k] for k in cols if k not in known}

    return CollectionData(
        gid=gid,
        # records without type/group columns (old snapshots) fall back
        # to the header's (possibly legacy-defaulted) lists
        species_names=list(cols.get("type",
                                    [header.get_str("types", "ATOM")] * n)),
        group_names=list(cols.get("group",
                                  [header.get_str("groups", "group")] * n)),
        class_names=list(cols.get("class", ["ATOM"] * n)),
        r=r,
        v=v,
        header=header,
        extra=extra,
    )


def _read_binary(paths, header, gid_hex, header_length=None):
    """FIXRECORDBINARY shards: little-endian packed records per the
    header's field_types byte codes (u4/b8/b2/f8/f4; reference framing
    collection_write.c:340-410, pinfo codec pinfoEncode)."""
    field_names = header.get_strv("field_names")
    field_types = header.get_strv("field_types")
    lrec = header.get_int("recordLength")
    groups_l = header.get_strv("groups")
    # legacy spelling: species list under "types" (collection.c:172)
    species_l = header.get_strv("species") or header.get_strv("types")

    fmt = []
    for ft in field_types:
        kind, size = ft[0], int(ft[1:]) if len(ft) > 1 else 8
        fmt.append((kind, size))
    if header_length and header_length > 0:
        body = b"".join(open(p, "rb").read()[header_length:] for p in paths)
    else:
        body = b"".join(_body_of(p) for p in paths)
    n = len(body) // lrec
    recs = np.frombuffer(body[: n * lrec], dtype=np.uint8).reshape(n, lrec)

    cols = {}
    off = 0
    for (name, (kind, size)) in zip(field_names, fmt):
        chunk = recs[:, off: off + size]
        if kind == "f":
            cols[name] = chunk.copy().view(f"<f{size}").reshape(n)
        else:  # u/b: little-endian unsigned
            buf = np.zeros((n, 8), dtype=np.uint8)
            buf[:, :size] = chunk
            cols[name] = buf.view("<u8").reshape(n)
        off += size

    gid = cols.get("id", np.zeros(n, dtype=np.uint64)).astype(np.uint64)
    pinfo = cols.get("pinfo", np.zeros(n, dtype=np.uint64)).astype(np.int64)
    n_groups = max(len(groups_l), 1)
    sp_idx = (pinfo // n_groups).astype(int)
    gr_idx = (pinfo % n_groups).astype(int)
    species_names = [species_l[i] if i < len(species_l) else "?" for i in sp_idx]
    group_names = [groups_l[i] if i < len(groups_l) else "?" for i in gr_idx]

    cAng, cVel = U.ANG_TO_LENGTH, U.ANG_FS_TO_VEL
    r = np.stack([cols[k].astype(np.float64) * cAng for k in ("rx", "ry", "rz")], axis=1)
    if "vx" in cols:
        v = np.stack([cols[k].astype(np.float64) * cVel for k in ("vx", "vy", "vz")], axis=1)
    else:
        v = np.zeros_like(r)
    return CollectionData(gid=gid, species_names=species_names,
                          group_names=group_names, class_names=["ATOM"] * n,
                          r=r, v=v, header=header)


def _strip_header(blob: bytes) -> bytes:
    head = blob[:256].decode("utf-8", errors="replace")
    if head.lstrip().split(None, 2)[1:2] == ["FILEHEADER"]:
        end = blob.index(b"}") + 1
        while end < len(blob) and blob[end:end + 1] in (b"\n", b"\r", b" "):
            end += 1
        return blob[end:]
    return blob


def _body_of(p):
    with open(p, "rb") as f:
        blob = f.read()
    head = blob[:256].decode("utf-8", errors="replace")
    off = 0
    if head.lstrip().split(None, 2)[1:2] == ["FILEHEADER"]:
        _, off = read_fileheader(p)
    return blob[off:]


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

_HEADER_TEMPLATE = """particle FILEHEADER {{type=MULTILINE; datatype={datatype}; checksum={checksum};
{lrec_line}loop={loop}; time={time:.6f};
nfiles={nfiles}; nrecord={nrecord}; nfields={nfields};
field_names={field_names};
field_types={field_types};
field_units={field_units};
field_format={field_format};
h= {h};
groups = {groups} ;
species = {species} ;
types = {types} ;
}}

"""


def write_collection(path: str, *, gid, species_names, group_names, class_names,
                     r, v, h, loop: int = 0, time_fs: float = 0.0,
                     group_list=(), species_list=(), type_list=("ATOM",),
                     gid_format: str = "dec", datatype: str = "VARRECORDASCII",
                     nfiles: int = 1, precision: str = "FULL") -> None:
    """Write one atoms# shard compatible with collection_read.

    `r` in internal nm (written as Ang), `v` in nm/ps (written as Ang/fs),
    `h` internal (3,3) (written as Ang). Mirrors collection_writeBLOCK
    (ddcMD src/collection_write.c:86-160).  datatype
    VARRECORDASCII writes newline-delimited records without a checksum
    column (as in the committed waterbox snapshot); FIXRECORDASCII pads
    every record to a fixed length and prepends a crc32 checksum field.

    nfiles > 1 splits the records across atoms#000000..#00000k shards
    with the FILEHEADER only in shard 0 (pio N-writer layout,
    Pio_setNumWriteFiles, ddcMD src/simulate.c:212).
    """
    n = len(gid)
    if nfiles > 1 and datatype.upper() not in ("FIXRECORDBINARY", "BINARY"):
        assert path.endswith("000000"), path
        base = path[:-6]
        cuts = np.linspace(0, n, nfiles + 1).astype(int)
        sl = slice(cuts[0], cuts[1])
        write_collection(path, gid=gid[sl], species_names=species_names[sl],
                         group_names=group_names[sl],
                         class_names=class_names[sl], r=r[sl], v=v[sl], h=h,
                         loop=loop, time_fs=time_fs, group_list=group_list,
                         species_list=species_list, type_list=type_list,
                         gid_format=gid_format, datatype=datatype)
        # patch the shard-0 header's nfiles/nrecord to global values
        blob = open(path, "rb").read()
        blob = blob.replace(b"nfiles=1;", b"nfiles=%d;" % nfiles, 1)
        blob = blob.replace(b"nrecord=%d;" % (cuts[1] - cuts[0]),
                            b"nrecord=%d;" % n, 1)
        open(path, "wb").write(blob)
        for k in range(1, nfiles):
            sl = slice(cuts[k], cuts[k + 1])
            tmp = base + "%06d" % k
            write_collection(tmp, gid=gid[sl],
                             species_names=species_names[sl],
                             group_names=group_names[sl],
                             class_names=class_names[sl], r=r[sl], v=v[sl],
                             h=h, loop=loop, time_fs=time_fs,
                             group_list=group_list, species_list=species_list,
                             type_list=type_list, gid_format=gid_format,
                             datatype=datatype)
            # continuation shards carry records only (header lives in #000000)
            blob = open(tmp, "rb").read()
            open(tmp, "wb").write(_strip_header(blob))
        return
    if datatype.upper() in ("FIXRECORDBINARY", "BINARY"):
        return _write_binary(path, gid=gid, species_names=species_names,
                             group_names=group_names, r=r, v=v, h=h,
                             loop=loop, time_fs=time_fs,
                             group_list=group_list or sorted(set(group_names)),
                             species_list=species_list or sorted(set(species_names)),
                             type_list=type_list, precision=precision)
    fixed = datatype.upper() == "FIXRECORDASCII"
    r = np.asarray(r, dtype=np.float64) * U.LENGTH_TO_ANG
    v = np.asarray(v, dtype=np.float64) * (1.0 / U.ANG_FS_TO_VEL)
    h = np.asarray(h, dtype=np.float64).reshape(3, 3) * U.LENGTH_TO_ANG
    hstr = "\n".join("    %.6g %22.14g %22.14g" % tuple(row) for row in h).lstrip()

    gid_fmt = "%14x" if gid_format == "hex" else "%14d"
    if fixed:
        field_names = "checksum id class type group rx ry rz vx vy vz"
        field_types = "u u s s s f f f f f f"
        field_units = "1 1 1 1 1 Ang Ang Ang Ang/fs Ang/fs Ang/fs"
        field_format = "%08x " + gid_fmt + " %s %s %s" + " %21.13e" * 6
        nfields = 11
    else:
        field_names = "id class type group rx ry rz vx vy vz"
        field_types = "u s s s f f f f f f"
        field_units = "1 1 1 1 Ang Ang Ang Ang/fs Ang/fs Ang/fs"
        field_format = gid_fmt + " %s %s %s" + " %21.13e" * 6
        nfields = 10

    gid = np.asarray(gid, dtype=np.uint64)

    # build record payloads (native codec when available)
    from . import fastio

    strs = np.stack([
        np.asarray(class_names, dtype="S16"),
        np.asarray(species_names, dtype="S16"),
        np.asarray(group_names, dtype="S16"),
    ])
    floats = np.concatenate([r.T, v.T], axis=0)
    blob = fastio.format_records(gid, strs, floats, gid_format == "hex")
    if blob is None:  # pure-Python fallback
        lines = []
        for i in range(n):
            lines.append(("%s %s %12s %s  " % (
                gid_fmt % int(gid[i]), class_names[i], species_names[i],
                group_names[i]))
                + " ".join("%21.13e" % x for x in (*r[i], *v[i])) + "\n")
        blob = "".join(lines).encode()

    lrec = None
    if fixed:
        # pad every record to a common length, prefix crc32 of the payload
        # (pio FIXRECORDASCII framing: bufsize/lrec records,
        # collection_read.c:39-73)
        recs = blob.splitlines()
        lrec = 8 * ((max(len(x) for x in recs) + 10 + 7) // 8)
        out = bytearray()
        for x in recs:
            body = x.ljust(lrec - 10)
            out += b"%08x " % (zlib.crc32(body) & 0xFFFFFFFF)
            out += body + b"\n"
        blob = bytes(out)

    header = _HEADER_TEMPLATE.format(
        datatype="FIXRECORDASCII" if fixed else "VARRECORDASCII",
        lrec_line=(f"recordLength={lrec};\n" if fixed else ""),
        checksum="CRC32" if fixed else "NONE",
        loop=loop,
        time=time_fs,
        nfiles=1,
        nrecord=n,
        nfields=nfields,
        field_names=field_names,
        field_types=field_types,
        field_units=field_units,
        field_format=field_format,
        h=hstr,
        groups=" ".join(group_list) or "group",
        species=" ".join(species_list) or " ".join(sorted(set(species_names))),
        types=" ".join(type_list),
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(blob)


def _write_binary(path, *, gid, species_names, group_names, r, v, h,
                  loop, time_fs, group_list, species_list, type_list,
                  precision="FULL"):
    """FIXRECORDBINARY writer: checksum u4 | id b8 | pinfo b2 | r f8 x3 |
    v f8 x3 (FULL) or f4 x3 (BRIEF, checkpointprecision=BRIEF --
    simulate.c:192-197, collection_write.c:217,300), padded to 8 bytes.
    pinfo = species_index * n_groups + group_index against the header's
    species/groups lists (pinfo codec role, collection_write.c:340-410)."""
    n = len(gid)
    r = np.asarray(r, dtype=np.float64) * U.LENGTH_TO_ANG
    v = np.asarray(v, dtype=np.float64) * (1.0 / U.ANG_FS_TO_VEL)
    h = np.asarray(h, dtype=np.float64).reshape(3, 3) * U.LENGTH_TO_ANG
    hstr = "\n".join("    %.6g %22.14g %22.14g" % tuple(row) for row in h).lstrip()
    group_list = list(group_list)
    species_list = list(species_list)
    gmap = {g: i for i, g in enumerate(group_list)}
    smap = {s: i for i, s in enumerate(species_list)}
    n_groups = max(len(group_list), 1)
    pinfo = np.array([smap[s] * n_groups + gmap[g]
                      for s, g in zip(species_names, group_names)],
                     dtype=np.uint16)

    brief = precision.upper().startswith("BRIEF")
    vsize = 4 if brief else 8
    lrec = 8 * ((4 + 8 + 2 + 3 * 8 + 3 * vsize + 7) // 8)
    recs = np.zeros((n, lrec), dtype=np.uint8)
    recs[:, 4:12] = np.asarray(gid, dtype="<u8").view(np.uint8).reshape(n, 8)
    recs[:, 12:14] = pinfo.astype("<u2").view(np.uint8).reshape(n, 2)
    recs[:, 14:38] = r.astype("<f8").view(np.uint8).reshape(n, 24)
    recs[:, 38:38 + 3 * vsize] = v.astype(
        "<f4" if brief else "<f8").view(np.uint8).reshape(n, 3 * vsize)
    from .fastio import crc32_rows

    recs[:, 0:4] = crc32_rows(recs, skip=4).astype("<u4").view(
        np.uint8).reshape(n, 4)

    header = _HEADER_TEMPLATE.format(
        datatype="FIXRECORDBINARY",
        lrec_line=f"recordLength={lrec};\nendian_key=875770417;\n",
        checksum="CRC32",
        loop=loop, time=time_fs, nfiles=1, nrecord=n, nfields=9,
        field_names="checksum id pinfo rx ry rz vx vy vz",
        field_types="u4 b8 b2 f8 f8 f8" + (" f4" if brief else " f8") * 3,
        field_units="1 1 1 Ang Ang Ang Ang/fs Ang/fs Ang/fs",
        field_format="binary",
        h=hstr,
        groups=" ".join(group_list),
        species=" ".join(species_list),
        types=" ".join(type_list),
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(recs.tobytes())
