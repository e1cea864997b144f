"""Build the sources under csrc/ into shared libraries with a plain C
interface, loaded with ctypes.

Each CUDA source is compiled by its own ``nvcc`` process for ``sm_90a``,
each host source (the JPEG decoder) by the host C++ compiler (``g++`` or
``c++``), at first use, into ``build/kernels/`` at the root of the checkout
(listed in .gitignore). The library's file name carries a hash of the
source, the headers it includes and the flags, so an edited source or
header is rebuilt and a stale library is never loaded.
``build_all`` starts one compiler per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# kernel library name -> source file under csrc/
SOURCES = {"composite_fwd": "composite_fwd.cu",
           "composite_bwd": "composite_bwd.cu",
           "attention_fwd": "attention_fwd.cu",
           "attention_bwd": "attention_bwd.cu"}
# kernel library name -> headers under csrc/ that its source includes
INCLUDES = {"composite_fwd": ("composite_common.cuh",),
            "composite_bwd": ("composite_common.cuh",)}

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
_SHARED = ("-shared", "-Xcompiler", "-fPIC")
# kernel library name -> nvcc flags. K1 and K2 take -fmad=false: no
# contraction of a*b+c into one FMA, so each product and sum rounds as the
# plain PyTorch version's separate elementwise ops do (bit-exact K1). K3 is
# held to a tolerance, and its inner products run as FMAs at full rate.
NVCC_FLAGS = {"composite_fwd": _ARCH + ("-fmad=false",) + _SHARED,
              "composite_bwd": _ARCH + ("-fmad=false",) + _SHARED,
              "attention_fwd": _ARCH + _SHARED,
              "attention_bwd": _ARCH + _SHARED}

# host library name -> C++ source under csrc/ (standard library only)
HOST_SOURCES = {"jpeg_decode": "jpeg_decode.cpp"}
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
ALL_SOURCES = {**SOURCES, **HOST_SOURCES}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> Path:
    """The CUDA toolkit's nvcc (its directory also holds cuobjdump)."""
    found = shutil.which("nvcc")
    if found:
        return Path(found)
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def cxx_path() -> Path:
    """The host C++ compiler: g++, else c++, from PATH."""
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return Path(found)
    raise RuntimeError("no host C++ compiler (g++ or c++) on PATH: the JPEG "
                       "decoder needs one")


def _flags(name: str) -> tuple:
    return HOST_FLAGS if name in HOST_SOURCES else NVCC_FLAGS[name]


def library_path(name: str) -> Path:
    text = b"".join((CSRC_DIR / f).read_bytes()
                    for f in (ALL_SOURCES[name], *INCLUDES.get(name, ())))
    digest = hashlib.sha1(text + " ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = tuple(ALL_SOURCES)) -> Dict[str, Path]:
    """Compile every named library that is not built yet, one compiler
    process per source, all started together. Returns name -> library
    path; raises with the compiler's output if a build fails."""
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, path in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            compiler = cxx_path() if name in HOST_SOURCES else nvcc_path()
            cmd = [str(compiler), *_flags(name), "-o", str(tmp),
                   str(CSRC_DIR / ALL_SOURCES[name])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("compiler failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one library, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _loaded[name] = lib
    return lib
