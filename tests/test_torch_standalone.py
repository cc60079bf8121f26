"""The port stands alone: no module of ddcmd_tpu_torch/, and not
chip_smoke.py, imports the JAX package or reads a file of it.  The record
codec builds from the port's own copy of the C source."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "ddcmd_tpu_torch")
# callables through which a string would become a path that is read,
# built or loaded
_PATH_CALLS = {"open", "join", "Path", "CDLL", "run", "Popen", "load",
               "compile_file", "listdir", "exists", "getmtime"}


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PORT):
        if "_build" in dirpath or "__pycache__" in dirpath:
            continue
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _jax_path(node) -> bool:
    """A string constant that names the JAX package as a path: the
    component "ddcmd_tpu" alone or a path under "ddcmd_tpu/"."""
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and (node.value == "ddcmd_tpu"
                 or node.value.startswith("ddcmd_tpu/")))


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_never_reaches_the_jax_package(path):
    """No absolute import of ddcmd_tpu (or jax), no "ddcmd_tpu" path
    component anywhere, and no path under ddcmd_tpu/ handed to a call
    that opens, joins, builds or loads it.  A JAX file named in a
    docstring, a comment or chip_smoke.py's kernels line is fine."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names
                    if a.name.split(".")[0] in ("ddcmd_tpu", "jax")]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if (node.module or "").split(".")[0] in ("ddcmd_tpu", "jax"):
                bad.append(node.module)
        elif isinstance(node, ast.Constant) and node.value == "ddcmd_tpu":
            bad.append(f"path component at line {node.lineno}")
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if name in _PATH_CALLS:
                for arg in node.args + [k.value for k in node.keywords]:
                    if any(_jax_path(a) for a in ast.walk(arg)):
                        bad.append(f"{name}(...) at line {node.lineno}")
    assert not bad, bad


_PROBE = r"""
import json, os, pkgutil, sys, importlib
root, port = sys.argv[1], sys.argv[2]
jax_dir = os.path.join(root, "ddcmd_tpu") + os.sep
seen = []
def hook(event, args):
    if event == "open" and isinstance(args[0], str) and \
            os.path.abspath(args[0]).startswith(jax_dir):
        seen.append(args[0])
sys.addaudithook(hook)
sys.path.insert(0, root)
import ddcmd_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(ddcmd_tpu_torch.__path__,
                                              "ddcmd_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from ddcmd_tpu_torch.io import fastio
fastio._BUILD = sys.argv[3]
lib = fastio.get_lib()
print(json.dumps({"opened": seen, "mods": len(mods), "lib": lib is not None,
                  "src": fastio._SRC,
                  "loaded": sorted(k for k in sys.modules
                                   if k.split(".")[0] in ("ddcmd_tpu",
                                                          "jax"))}))
"""


def test_port_imports_and_builds_without_the_jax_package(tmp_path):
    """In a fresh interpreter: import every module of the port and build
    the record codec into an empty directory; nothing opens a file under
    ddcmd_tpu/, neither ddcmd_tpu nor jax gets imported, and the codec
    library is compiled from ddcmd_tpu_torch/csrc/recio.c."""
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, ROOT, PORT, str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["opened"] == [] and res["loaded"] == [], res
    assert res["mods"] > 30
    assert res["src"] == os.path.join(PORT, "csrc", "recio.c")
    assert os.path.exists(res["src"])
    if res["lib"]:
        assert os.path.exists(tmp_path / "libddcmdrecio.so")
    # the copy's code is the JAX package's codec; only comments differ
    with open(res["src"]) as f:
        port_c = f.read()
    with open(os.path.join(ROOT, "ddcmd_tpu", "native", "recio.c")) as f:
        jax_c = f.read()
    code = lambda c: re.sub(r"/\*.*?\*/", "", c, flags=re.S)  # noqa: E731
    assert code(port_c) == code(jax_c)
