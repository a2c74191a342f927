"""Building the port's shared libraries at first use.

Both the CUDA kernels (``ops/flash_attention.py``, nvcc) and the host
tokenization core (``native/``, g++) are compiled from the package's own
sources into ``_build/`` beside the package. A library is named by a sha256
of everything that went into it (sources, headers, compiler flags), so a
changed source gets a new file and a library built from the same text is
reused. A compiler writes to a temporary file of its own in the build
directory, which is then renamed onto the final name (``os.replace`` is
atomic): processes that build the same library at once each publish a
complete file, and a loader never sees a partial one.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Iterable, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def library_path(name: str, inputs: Iterable[bytes], build_dir: Path = BUILD_DIR) -> Path:
    """``build_dir/lib{name}_{digest}.so``, the digest a sha256 over
    ``inputs`` (each length-prefixed, so no two input lists collide)."""
    h = hashlib.sha256()
    for part in inputs:
        h.update(len(part).to_bytes(8, "little") + part)
    return Path(build_dir) / f"lib{name}_{h.hexdigest()[:16]}.so"


def compile_library(cmd: Sequence[str], lib: Path) -> Tuple[float, str]:
    """Run ``cmd`` with ``-o <temporary file>`` appended, then rename the
    result onto ``lib``. Returns (seconds, the compiler's stderr); raises
    RuntimeError with the stderr when the compiler fails."""
    lib = Path(lib)
    lib.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run(list(cmd) + ["-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}) "
                               f"building {lib.name}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.perf_counter() - t0, proc.stderr
