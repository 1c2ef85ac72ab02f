"""On-demand g++ build of the native libraries (shared helper).

pybind11 is not available in this environment, so every native component is
a plain C-ABI shared library built with the baked-in compiler and consumed
via ctypes.  Concurrent node processes may race to build: compile into a
temp file and ``os.replace`` (atomic) so every racer ends with a whole
library.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

_CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir, "_native_build")


def build_native_lib(src_path: str, lib_name: str,
                     extra_flags: tuple = ()) -> str:
    cache = os.path.abspath(_CACHE_DIR)
    os.makedirs(cache, exist_ok=True)
    lib_path = os.path.join(cache, lib_name)
    if (os.path.exists(lib_path)
            and os.path.getmtime(lib_path) >= os.path.getmtime(src_path)):
        return lib_path
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=cache)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src_path,
             "-o", tmp, *extra_flags],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path
