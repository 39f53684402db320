"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` compiles on first use into its own shared library
under `build/durf_tpu_torch_kernels/` at the root of the checkout (a
directory git ignores), named by a hash of the sources so that an edit
rebuilds. The libraries expose plain C functions: pointers come from
`tensor.data_ptr()`, the stream from `torch.cuda.current_stream()`, and each
launcher returns the launch's cudaError_t (0 = success).

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o lib<name>-<hash>.so csrc/<name>.cu
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

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "durf_tpu_torch_kernels"
SOURCES = (
    "fused_mlp", "obj_mlp", "fused_mlp_gated", "fused_mlp_bwd", "obj_mlp_bwd",
    "fused_mlp_gated_bwd",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}
# name -> (seconds, ptxas report) of the builds this process ran.
build_log: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    build_log[name] = (time.perf_counter() - t0, log)


def build_all(names=SOURCES) -> None:
    """Compile every kernel source that is not built yet, all nvcc
    processes at once, and wait for them."""
    with _lock:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of csrc/<name>.cu, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def sass_counts(names, opcodes=("HGMMA", "UTMALDG", "UTMASTG", "SYNCS", "HMMA"),
                function: str = "") -> dict:
    """How often each opcode occurs in the built libraries' machine code
    (cuobjdump -sass): wgmma shows as HGMMA, TMA loads and stores as
    UTMALDG / UTMASTG, mbarrier waits as SYNCS, mma.sync as HMMA. With
    `function`, only in the kernels whose mangled name contains it. Empty
    where the toolkit has no cuobjdump."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    out = {}
    for name in names:
        sass = subprocess.run([str(tool), "-sass", str(_lib_path(name))], capture_output=True,
                              text=True, timeout=300).stdout
        counts, inside = dict.fromkeys(opcodes, 0), not function
        for line in sass.splitlines():
            if "Function :" in line:
                inside = function in line
            elif inside:
                for op in opcodes:
                    counts[op] += line.count(op)
        out[name] = counts
    return out


def offsets(values) -> ctypes.Array:
    """A C array of int64 (layer offsets handed to a launcher)."""
    return (ctypes.c_longlong * len(values))(*values)


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a non-zero CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with error code {err}")
