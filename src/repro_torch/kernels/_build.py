"""Build and load the CUDA kernels of ``csrc/`` at first use.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` into an object file,
all sources at once in parallel processes, and links the objects into one
shared library with a plain C interface, which is loaded with ``ctypes``
(no PyTorch headers, so the build takes seconds).  The library goes into
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the sources, so an edited source is
rebuilt and an unchanged one is loaded as it is.  A missing ``nvcc`` or a
failed build raises with the compiler's output; nothing falls back.

A plan store houses the library too (:func:`use_store_dir`, the
counterpart of the reference's ``compat.enable_compilation_cache``):
``load`` then looks in ``<persist_dir>/kernels/`` first, and a library
missing there lands there atomically, copied from ``build/repro_torch/``
or built in place.  A process started over a populated store, from a
checkout that never built, loads the library without running ``nvcc``.
A store that cannot be written raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load", "build_info", "use_store_dir", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_info: dict = {}
_store_dir: Path | None = None   # ``<persist_dir>/kernels``, if a store


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "repro_torch are compiled from source at first use")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out: Path) -> tuple[str, dict[str, float]]:
    """Compile every source to an object in parallel, then link them into
    ``out``; returns the compilers' combined output and each source's
    compile seconds."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [out.with_name(f"{out.stem}.{p.stem}.{os.getpid()}.o")
            for p in _sources()]
    jobs = [([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)], o)
            for p, o in zip(_sources(), objs)]
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd, _ in jobs]
    texts, seconds = {}, {}

    def finish(i, proc):  # one thread per compiler: each one's own time
        texts[i] = proc.communicate()[0]
        seconds[_sources()[i].name] = time.perf_counter() - t0

    waiters = [threading.Thread(target=finish, args=(i, proc))
               for i, (_, proc) in enumerate(procs)]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    logs, failed = [], None
    for i, (cmd, proc) in enumerate(procs):
        logs.append(texts[i])
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, texts[i])
    try:
        if failed is None:
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-shared", "-o", str(tmp), *(str(o) for o in objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed = (cmd, proc.returncode, proc.stdout + proc.stderr)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    if failed is not None:
        tmp.unlink(missing_ok=True)
        cmd, rc, text = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return "".join(logs), seconds


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.radic_batched_partial.argtypes = [vp, i32, i32, i32, vp, i32, i64,
                                          vp, i32, vp, vp]
    lib.radic_batched_partial.restype = i32
    lib.radic_bygrid_partial.argtypes = [vp, i32, i32, i32, vp, i32, i64,
                                         vp, i32, vp, vp]
    lib.radic_bygrid_partial.restype = i32
    lib.radic_batched_grad_partial.argtypes = [vp, vp, i32, i32, i32, vp,
                                               i32, i64, vp, i32, vp, vp]
    lib.radic_batched_grad_partial.restype = i32
    lib.radic_grad_tile.argtypes = [i32]
    lib.radic_grad_tile.restype = i32
    lib.radic_partial_smem_bytes.argtypes = [i32, i32, i32]
    lib.radic_partial_smem_bytes.restype = i32
    lib.radic_partial_route.argtypes = [i32, i32]
    lib.radic_partial_route.restype = i32
    lib.radic_grad_smem_bytes.argtypes = [i32, i32, i32]
    lib.radic_grad_smem_bytes.restype = i32
    lib.radic_unrank.argtypes = [vp, i32, i32, i32, vp, vp, i32, vp]
    lib.radic_unrank.restype = i32
    lib.radic_minor_det.argtypes = [vp, i32, i32, i32, vp, i32, vp, vp]
    lib.radic_minor_det.restype = i32
    lib.radic_minor_det_work_elems.argtypes = [i32, i32, i32]
    lib.radic_minor_det_work_elems.restype = i64
    lib.radic_error_string.argtypes = [i32]
    lib.radic_error_string.restype = ctypes.c_char_p
    return lib


def use_store_dir(persist_dir) -> bool:
    """Make :func:`load` find the library under ``<persist_dir>/kernels/``
    (process-global).  Deferential, as the reference's
    ``enable_compilation_cache``: once the library is loaded this returns
    False and changes nothing; a store named earlier keeps the library."""
    global _store_dir
    with _lock:
        if _lib is not None:
            return False
        if _store_dir is None:
            _store_dir = Path(persist_dir) / "kernels"
        return True


def _copy(src: Path, out: Path) -> None:
    """Copy ``src`` to ``out`` atomically: a concurrent loader sees all
    or nothing."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    shutil.copyfile(src, tmp)
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The kernel library, built on first call (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            local = BUILD_DIR / f"libradic_{_digest()}.so"
            out = local if _store_dir is None else _store_dir / local.name
            t0 = time.perf_counter()
            log, each, origin = "", {}, "loaded"
            if not out.exists():
                if out != local and local.exists():
                    _copy(local, out)
                    origin = "copied"
                else:
                    log, each = _compile(out)
                    origin = "built"
            _lib = _bind(ctypes.CDLL(str(out)))
            _info.update(path=str(out), seconds=time.perf_counter() - t0,
                         log=log, built=origin == "built", origin=origin,
                         each=each)
        return _lib


def build_info() -> dict:
    """Path, seconds from the call to the library bound (``each``: per
    source, from the start of the parallel compile to its end), compiler
    log, and ``origin`` of the loaded library: ``"built"`` by ``nvcc``,
    ``"copied"`` into the store from ``build/repro_torch/``, or
    ``"loaded"`` as it was found."""
    with _lock:
        return dict(_info)
