"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file compiles with its own ``nvcc``, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ``ctypes``.  The library is built at first use
into ``_build/`` beside this package, under a name keyed by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once.  Nothing here runs at import time: the
package imports on machines with no ``nvcc`` and no card.

The second build path, :func:`build_generated`, serves the whole-scan
kernels G and I, whose user callbacks are compiled in: a source
generated per filter (kernels/ukf_scan.py) includes the kernel template
``csrc/ukf_scan.cuh`` and becomes its own small library, keyed by a hash
of the generated source, the headers and the flags.

Every C entry point returns a ``cudaError_t``; :func:`check` raises on a
non-zero code, so a refused launch is an error and never a silent no-op.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _I64, _U32, _U64, _F = (ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int64, ctypes.c_uint32,
                                ctypes.c_uint64, ctypes.c_float)
_SIGNATURES = {
    "llpf_philox_bits": [_P, _I64, _U32, _U32, _P, _P],
    "llpf_curand_philox_bits": [_P, _I64, _U32, _U32, _P, _P],
    "llpf_normal": [_P, _I64, _U64, _U32, _U32, _P],
    "llpf_add_gaussian_noise": [_P, _P, _P, _I64, _I, _U64, _U32, _P],
    "llpf_systematic_gather": [_P, _P, _P, _I64, _I, _I, _P],
    "llpf_systematic_index_gather": [_P, _P, _P, _P, _I64, _I, _I, _P],
    "llpf_pf_scan_grid": [_I, _I, _P],
    "llpf_pf_scan": [_P] * 27 + [_I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _I,
                                 _I, _U64, _I, _P],
    "llpf_assoc_scan": [_P, _P, _P, _I64, _I64, _I, _I, _P],
    "llpf_assoc_scan_full": [_P, _P, _P, _I64, _I64, _I, _P],
    "llpf_bank_loglik": [_P, _I, _P, _P, _I64, _P, _P, _I64, _I, _I, _I, _I,
                         _P],
    "llpf_akf_scan": [_P] * 9 + [_F, _I, _I, _I] + [_P] * 9,
    "llpf_ffbs_backward": [_P] * 9 + [_I, _I, _I, _I, _U64, _I, _P],
}
# entry points of the callback-specialised modules (build_generated)
_GEN_SIGNATURES = {
    "llpf_ekf_scan": [_P] * 7 + [_F, _F, _I] + [_P] * 9,
    "llpf_ukf_scan": [_P] * 7 + [_F] * 6 + [_I] + [_P] * 9,
}
# headers the generated sources include
_GEN_HEADERS = ("ukf_scan.cuh", "callback_ops.cuh", "scan_common.cuh")


@dataclass
class KernelInfo:
    """One hand-written kernel: where it lives, what TPU kernel it
    replaces, and how many times its wrapper has launched it."""

    name: str
    source: str
    replaces: str
    launches: int = 0


@dataclass
class _Loaded:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float
    log: str


_STATE: dict = {}


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _build() -> tuple[Path, float, str]:
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    tag = h.hexdigest()[:16]
    out = BUILD_DIR / f"libllpf_{tag}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for s in srcs:
        if s.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{s.stem}_{tag}.{pid}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(s)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log.append(f"== {Path(cmd[-1]).name} ==\n{text}")
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text}")
    if failed:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{pid}.tmp")
    cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp),
           *[str(obj) for _, obj, _ in jobs]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for _, obj, _ in jobs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, "\n".join(log)


def library() -> _Loaded:
    """The loaded kernel library, built on first call."""
    if "lib" not in _STATE:
        path, secs, log = _build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _STATE["lib"] = _Loaded(lib, path, secs, log)
    return _STATE["lib"]


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def default_device(device=None):
    """``device`` as a ``torch.device``; when None, the card.  Without a
    card that raises: code that means the CPU says so."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build on "
                           "the CPU")
    return torch.device("cuda")


_RAW_STREAM: list = []


def raw_stream_fn():
    """The function ``i -> pointer`` that reads device i's current CUDA
    stream without building a ``torch.cuda.Stream`` object, resolved
    once."""
    if not _RAW_STREAM:
        import torch

        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        _RAW_STREAM.append(raw if raw is not None else (
            lambda i: torch.cuda.current_stream(i).cuda_stream))
    return _RAW_STREAM[0]


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer."""
    return raw_stream_fn()(t.get_device())


def require_cuda_f32(name: str, t, shape=None) -> None:
    """Check a kernel input: CUDA, float32, contiguous, no autograd."""
    import torch

    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.requires_grad:
        raise RuntimeError(f"{name} requires grad, but the CUDA kernels are "
                           "forward-only; use method='sequential' to "
                           "differentiate")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


#: callback-specialised libraries built by this process (compiled, not
#: found on disk); the seconds nvcc took, last first
GEN_BUILDS: list = []


def build_generated(source: str) -> ctypes.CDLL:
    """The library of one generated source (see module doc), built with
    one ``nvcc`` at first use and loaded; a source seen before loads from
    ``_build/`` or from this process's cache without compiling."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.encode())
    for name in _GEN_HEADERS:
        h.update((SRC_DIR / name).read_bytes())
    tag = h.hexdigest()[:16]
    cache = _STATE.setdefault("gen", {})
    if tag in cache:
        return cache[tag]
    out = BUILD_DIR / f"libllpf_cb_{tag}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        pid = os.getpid()
        src = BUILD_DIR / f"cb_{tag}.{pid}.cu"
        src.write_text(source)
        tmp = out.with_suffix(f".{pid}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-shared", "-o",
               str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        src.unlink(missing_ok=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
        GEN_BUILDS.insert(0, (time.perf_counter() - t0, proc.stdout
                              + proc.stderr))
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _GEN_SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    cache[tag] = lib
    return lib
