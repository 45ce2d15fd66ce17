"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/torch_kernels/<name>-<hash>.so`` under
the repository root (listed in ``.gitignore``), then loaded with ctypes.
The hash covers the source, every header under ``csrc/`` it includes and the
flags, so an edited source or header rebuilds.
Nothing is built at import time: ``load`` builds on first use, and
``build_all`` starts one ``nvcc`` per source, all at once.
``set_build_dir`` moves the build directory (the CLI's
``--compile-cache``) before the first build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Iterable, Tuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "torch_kernels")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("fused_dstep", "fused_sweep", "fused_adam", "threefry")
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)

_LIBS: Dict[str, ctypes.CDLL] = {}


def set_build_dir(path: str) -> str:
    """Build into (and load from) ``path`` from now on; returns it
    absolute.  A library already loaded in this process stays loaded."""
    global BUILD_DIR
    BUILD_DIR = os.path.abspath(os.path.expanduser(path))
    return BUILD_DIR


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME/bin/nvcc or PATH): the "
                       "port's CUDA kernels are built on the machine with "
                       "the card")


def _source_closure(filename: str, seen=None) -> bytes:
    """The bytes of ``csrc/<filename>`` followed by those of every header
    under ``csrc/`` it includes with quotes, transitively, each once."""
    seen = set() if seen is None else seen
    if filename in seen:
        return b""
    seen.add(filename)
    with open(os.path.join(CSRC, filename), "rb") as f:
        text = f.read()
    for inc in _INCLUDE.findall(text):
        if os.path.exists(os.path.join(CSRC, inc.decode())):
            text += _source_closure(inc.decode(), seen)
    return text


def target(name: str) -> str:
    """Path of the library built from the current source, the headers it
    includes and the flags."""
    digest = hashlib.sha256(_source_closure(name + ".cu")
                            + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, Tuple[str, float]]:
    """Build every missing library, one ``nvcc`` per source started
    together.  Returns {name: (path, seconds)}; the ``-Xptxas -v``
    report lands beside each library as ``.log``.  Raises on a failed
    build with the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    out: Dict[str, Tuple[str, float]] = {}
    t0 = time.perf_counter()
    for name in names:
        so = target(name)
        if os.path.exists(so):
            out[name] = (so, 0.0)
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), so, tmp)
    for name, (proc, so, tmp) in procs.items():
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(rc={proc.returncode}):\n{text}")
        with open(so[:-3] + ".log", "w") as f:
            f.write(text)
        os.replace(tmp, so)
        out[name] = (so, time.perf_counter() - t0)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        path, _ = build_all([name])[name]
        _LIBS[name] = ctypes.CDLL(path)
    return _LIBS[name]


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of the
    current build, or '' if it has not been built here."""
    log = target(name)[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return "".join(line for line in f if "ptxas" in line)
