"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
`ctypes` (no PyTorch headers, so a build takes seconds).  The sources in
`PY_MODULES` also include ``Python.h`` and are imported as extension
modules, whose entry point costs the host less a call.  Builds run at
first use, into ``build/repro_torch_kernels/`` at the root of the
checkout (``REPRO_TORCH_BUILD_DIR`` overrides it), under a file name
that carries a hash of the source and flags, so an edited source is
rebuilt and an unchanged one is reused.  `build_all` starts one ``nvcc``
per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path

__all__ = ["PY_MODULES", "SOURCES", "build_all", "load", "load_module"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("pair_apply", "sample_chunk", "cell_mixing", "rwkv6",
           "flash_attention", "flash_attention_sm90")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
PY_MODULES = ("cell_mixing",)
_LIBS: dict = {}
_MODULES: dict = {}


def _build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return _CSRC.parents[2] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def _flags(name: str) -> tuple:
    if name in PY_MODULES:
        return (*_FLAGS, "-I", sysconfig.get_paths()["include"])
    return _FLAGS


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(_flags(name)).encode()
    digest = hashlib.sha256(src + flags).hexdigest()[:12]
    return _build_dir() / f"lib{name}-{digest}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=SOURCES) -> dict:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source started together.  Returns the compiler log of each build
    (``-Xptxas -v``: registers, shared memory, spills)."""
    jobs = {name: _start(name) for name in names}
    return {name: _finish(name, job) for name, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib


def load_module(name: str):
    """Kernel `name`'s library imported as an extension module (a source
    in `PY_MODULES`), built first if needed."""
    mod = _MODULES.get(name)
    if mod is None:
        build_all((name,))
        path = str(_target(name))
        spec = importlib.util.spec_from_file_location(
            name, path, loader=importlib.machinery.ExtensionFileLoader(
                name, path))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[name] = mod
    return mod
