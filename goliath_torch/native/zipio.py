"""ctypes binding of the native zip reader (``zipreader.cpp``, the port's own
copy of the JAX package's).

Builds ``libzipio.so`` with ``g++`` and zlib at first use, into
``build/zipio/`` at the root of the checkout (never beside the source), and
exposes:

  NativeZip(path)        central directory parsed once; .read(name),
                         .namelist(), .exists(name), .size(name)
  open_cached(path)      one NativeZip per path for the process
  read_many(pairs, ...)  batch read [(path, member), ...] on a C++ thread
                         pool, without the interpreter lock
  have_native()          False where the library cannot be built; callers
                         then read through Python ``zipfile``

The first call of ``have_native()`` logs which reader is in use; a failed
build logs the compiler's stderr (``build_error()`` returns it).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "zipreader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zipio"
SO_PATH = BUILD_DIR / "libzipio.so"

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_tried = False
_build_error: Optional[str] = None


def _compile() -> Optional[str]:
    """Build SO_PATH from the source; returns None, or why it failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, then an atomic rename: processes that build at once
    # never load a half-written library
    tmp = SO_PATH.with_name(f"libzipio.{os.getpid()}.tmp.so")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
           "-o", str(tmp), "-lz", "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{' '.join(cmd)}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return (f"{' '.join(cmd)} exited {proc.returncode}:\n"
                f"{proc.stderr.strip()}")
    os.replace(tmp, SO_PATH)
    return None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, cstr, u8p = ctypes.c_int64, ctypes.c_char_p, \
        ctypes.POINTER(ctypes.c_uint8)
    lib.gz_open.argtypes, lib.gz_open.restype = [cstr], i64
    lib.gz_close.argtypes, lib.gz_close.restype = [i64], None
    lib.gz_num_entries.argtypes, lib.gz_num_entries.restype = [i64], i64
    lib.gz_entry_name.argtypes, lib.gz_entry_name.restype = [i64, i64], cstr
    lib.gz_entry_size.argtypes, lib.gz_entry_size.restype = [i64, cstr], i64
    lib.gz_read.argtypes, lib.gz_read.restype = [i64, cstr, u8p, i64], i64
    lib.gz_read_many.argtypes = [
        ctypes.POINTER(i64), ctypes.POINTER(cstr), ctypes.POINTER(u8p),
        ctypes.POINTER(i64), ctypes.POINTER(i64), i64, i64]
    lib.gz_read_many.restype = i64
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _build_error
    if _tried:
        return _lib
    with _lib_lock:
        if _tried:
            return _lib
        stale = (not SO_PATH.exists()
                 or SO_PATH.stat().st_mtime < _SRC.stat().st_mtime)
        _build_error = _compile() if stale else None
        if _build_error is None:
            try:
                _lib = _declare(ctypes.CDLL(str(SO_PATH)))
            except OSError as e:
                _build_error = f"cannot load {SO_PATH}: {e}"
        if _lib is not None:
            logger.info("zip reader: native core %s", SO_PATH)
        else:
            logger.warning("zip reader: Python zipfile; the native core did "
                           "not build: %s", _build_error)
        _tried = True
    return _lib


def have_native() -> bool:
    return _get_lib() is not None


def build_error() -> Optional[str]:
    """Why the native core is unavailable (the compiler's stderr), or None."""
    _get_lib()
    return _build_error


def reader_name() -> str:
    """Which reader the data loader uses: ``native (<library>)`` or
    ``zipfile (<why the native core is unavailable>)``."""
    return (f"native ({SO_PATH})" if have_native()
            else f"zipfile ({build_error()})")


class NativeZip:
    """One parsed zip archive; thread-safe reads via pread."""

    def __init__(self, path: str | os.PathLike):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(f"native zip core unavailable: {_build_error}")
        self._lib = lib
        self.path = str(path)
        self._h = lib.gz_open(self.path.encode())
        if self._h < 0:
            raise OSError(f"cannot open zip: {path} (rc={self._h})")

    def namelist(self) -> List[str]:
        n = self._lib.gz_num_entries(self._h)
        return [self._lib.gz_entry_name(self._h, i).decode()
                for i in range(n)]

    def exists(self, name: str) -> bool:
        return self._lib.gz_entry_size(self._h, name.encode()) >= 0

    def size(self, name: str) -> int:
        s = self._lib.gz_entry_size(self._h, name.encode())
        if s < 0:
            raise KeyError(name)
        return int(s)

    def read(self, name: str) -> bytes:
        sz = self.size(name)
        buf = (ctypes.c_uint8 * sz)()
        r = self._lib.gz_read(self._h, name.encode(), buf, sz)
        if r < 0:
            raise OSError(f"zip read failed ({r}): {name} in {self.path}")
        return ctypes.string_at(buf, int(r))

    def close(self) -> None:
        if self._h >= 0:
            self._lib.gz_close(self._h)
            self._h = -1

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


_open_cache: dict = {}
_open_lock = threading.Lock()


def open_cached(path: str | os.PathLike) -> NativeZip:
    key = str(path)
    with _open_lock:
        z = _open_cache.get(key)
        if z is None:
            z = _open_cache[key] = NativeZip(key)
        return z


def read_many(pairs: Sequence[Tuple[str, str]], nthreads: int = 8
              ) -> List[Optional[bytes]]:
    """Batch read [(zip_path, member), ...] on the C++ thread pool: one
    bytes per pair, or None for a missing or corrupt member."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native zip core unavailable: {_build_error}")
    n = len(pairs)
    if n == 0:
        return []
    zips = [open_cached(p) for p, _ in pairs]
    names_b = [m.encode() for _, m in pairs]
    caps_list = [max(int(lib.gz_entry_size(z._h, m)), 0)
                 for z, m in zip(zips, names_b)]
    bufs = [(ctypes.c_uint8 * s)() for s in caps_list]
    handles = (ctypes.c_int64 * n)(*[z._h for z in zips])
    names = (ctypes.c_char_p * n)(*names_b)
    caps = (ctypes.c_int64 * n)(*caps_list)
    outs = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[ctypes.cast(b, ctypes.POINTER(ctypes.c_uint8)) for b in bufs])
    sizes = (ctypes.c_int64 * n)()
    lib.gz_read_many(handles, names, outs, caps, sizes, n, nthreads)
    return [ctypes.string_at(b, int(s)) if s >= 0 else None
            for b, s in zip(bufs, sizes)]
