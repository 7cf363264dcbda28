"""Build the port's CUDA kernels from the checkout and load them.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` entry points and is
compiled by ``nvcc`` alone (no PyTorch headers, so a build takes seconds)
into ``build/repro_torch/lib<name>-<hash>.so`` at the root of the
checkout, then loaded with ``ctypes``.  The file name carries a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
Nothing is built at import time: the first launch builds, or
:func:`build_all` builds every source at once, one ``nvcc`` process per
source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[Path]:
    """Every kernel source of the port."""
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``; raises when there is none."""
    cands = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in cands:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the port's CUDA kernels are "
            "built from src/repro_torch/csrc on the machine with the card")
    return found


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives (content-addressed)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log = proc.communicate()[0]
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder never sees half
    return log


def build_all() -> dict[str, str]:
    """Build every stale source in parallel; returns ``{name: nvcc log}``
    for what was built (``-Xptxas -v`` reports registers and spills)."""
    jobs = {s.stem: _start(s.stem) for s in sources()}
    logs = {}
    for name, job in jobs.items():
        if job is not None:
            logs[name] = _finish(name, job)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


_CTYPES = {"p": ctypes.c_void_p, "l": ctypes.c_int64, "i": ctypes.c_int}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _resolve(name: str, fn_name: str, signature: str):
    """The typed ctypes function ``fn_name`` of ``csrc/<name>.cu``,
    resolved once."""
    fn = getattr(load(name), fn_name)
    fn.argtypes = [_CTYPES[c] for c in signature + "p"]
    fn.restype = ctypes.c_int
    _fns[name, fn_name] = fn
    return fn


def launch(name: str, fn_name: str, signature: str, like, *args) -> None:
    """Call the ``extern "C"`` launcher ``fn_name`` of ``csrc/<name>.cu``
    with ``args`` and, last, the current CUDA stream of ``like``'s
    device, with that device current.  ``signature`` types the arguments,
    one letter each (``p`` pointer, ``l`` int64, ``i`` int; the stream is
    added).  The launcher returns ``cudaGetLastError()``; a non-zero one
    raises.

    Per call this costs a dict lookup, the current device's index and the
    raw stream handle (no ``torch.cuda.Stream`` object); the device is
    switched only when ``like`` is not on the current one.  The caller
    has initialised CUDA: ``like`` lies on a card."""
    fn = _fns.get((name, fn_name)) or _resolve(name, fn_name, signature)
    dev = like.get_device()
    if dev == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"{fn_name} (csrc/{name}.cu) launch failed: CUDA "
                           f"error {err}")
