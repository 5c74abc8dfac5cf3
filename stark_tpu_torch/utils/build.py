"""Build a shared library from sources in the package, at first use.

The output lands in ``stark_tpu_torch/_build/`` (listed in .gitignore)
under a name keyed by the sources' bytes, the command line and the host
machine type, so an edited source or a checkout copied to another machine
never loads a stale library.  Concurrent builds (test workers, or threads
of one process building the same source) each compile to a private
temporary name and ``os.replace`` it into place, so no lock is needed.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")


def build_library(
    stem: str, sources: list[str], deps: list[str], command: list[str]
) -> str:
    """Compile ``sources`` (absolute paths) with ``command + ["-o", out] +
    sources`` and return the library path.  ``deps`` are further files
    (headers) whose bytes key the build.  Raises RuntimeError with the
    compiler's output when the build fails."""
    key = hashlib.sha256()
    for path in list(sources) + list(deps):
        with open(path, "rb") as f:
            key.update(f.read())
    key.update(" ".join(command).encode())
    key.update(platform.machine().encode())
    out = os.path.join(BUILD_DIR, f"lib{stem}-{key.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(
        command + ["-o", tmp] + list(sources),
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {stem} failed ({' '.join(command)}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out
