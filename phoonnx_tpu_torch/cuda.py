"""Build, load and call the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use, from the sources in this package only, into
``build/phoonnx_tpu_torch/<hash>/`` beside the package, keyed by a hash
of the sources and flags, so an edited source rebuilds and an unchanged
one is reused. :func:`build` compiles every library at once, one ``nvcc``
process per library, all started together.

Kernels A, B and C take float32 or bfloat16 tensors: each of their
sources is compiled twice, as ``lib<name>.so`` (float32) and
``lib<name>_bf16.so`` (the same source with ``-DPHX_BF16``, which sets
the element type the kernel loads and stores; its arithmetic stays
float32). :func:`library` names the build a dtype takes.

Importing this module touches neither ``nvcc`` nor the card: the CPU
test suite imports every module of the port.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "phoonnx_tpu_torch"
# the kernels built in both element types; kernel D (float32 only); the
# noise kernel (one build writes float32 or bfloat16)
TYPED = ("fused_encoder", "fused_flow", "fused_stage")
LIBRARIES = (*TYPED, *(f"{name}_bf16" for name in TYPED), "mas", "noise")
BF16_SUFFIX = "_bf16"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, object] = {}

# Launches of each kernel, by the name of its wrapper's module: a wrapper
# adds one where it launches its kernel (:func:`count_launch`), and a CUDA
# graph's replay adds those of its capture (``infer/graphs.py``). Each
# wrapper module reads its own count as ``<module>.launches``.
LAUNCHES: collections.Counter = collections.Counter()

c_ptr = ctypes.c_void_p
c_int = ctypes.c_int
c_float = ctypes.c_float


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_ROOT / _digest() / f"lib{name}.so"


def library(name: str, dtype: torch.dtype) -> str:
    """The build of kernel source ``name`` for tensors of ``dtype``."""
    if dtype == torch.float32:
        return name
    if dtype == torch.bfloat16 and name in TYPED:
        return name + BF16_SUFFIX
    raise TypeError(f"kernel {name} takes float32"
                    + (" or bfloat16" if name in TYPED else "")
                    + f" tensors, not {dtype}")


def _compile_command(name: str, out: Path) -> list:
    """nvcc's arguments for library ``name``."""
    flags = list(NVCC_FLAGS)
    if name.endswith(BF16_SUFFIX):
        name = name[:-len(BF16_SUFFIX)]
        flags.append("-DPHX_BF16")
    return [_nvcc(), *flags, "-o", str(out), str(CSRC / f"{name}.cu")]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU, with the CUDA toolkit")


def build(names: Iterable[str] = LIBRARIES) -> float:
    """Compile the libraries that are not built yet, in parallel. Returns
    the seconds spent; raises RuntimeError with nvcc's output on failure."""
    start = time.perf_counter()
    with _LOCK:
        procs = []
        for name in names:
            target = library_path(name)
            if target.exists():
                continue
            target.parent.mkdir(parents=True, exist_ok=True)
            partial = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = _compile_command(name, partial)
            procs.append((name, target, partial, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for name, target, partial, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{name}: nvcc exited {proc.returncode}\n"
                              f"{out.decode(errors='replace')}")
            else:
                os.replace(partial, target)
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - start


def load(name: str) -> ctypes.CDLL:
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        with _LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                lib.phx_error_string.argtypes = [c_int]
                lib.phx_error_string.restype = ctypes.c_char_p
                _LOADED[name] = lib
    return lib


def function(library: str, symbol: str, argtypes: Sequence, restype=c_int):
    """A C entry point with its ctypes signature declared."""
    key = (library, symbol)
    fn = _FUNCS.get(key)
    if fn is None:
        fn = getattr(load(library), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FUNCS[key] = fn
    return fn


def check(library: str, status: int, what: str) -> None:
    """Raise if a launch sequence returned a CUDA error."""
    if status != 0:
        msg = load(library).phx_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


_OCCUPANCY: Dict[tuple, tuple] = {}


def occupancy(library: str, symbol: str, device: torch.device,
              *args: int) -> tuple:
    """(blocks an SM holds at once, SM count) of a persistent kernel on
    ``device``, from its C query ``symbol(*args, int out[2])`` run with
    that device current; cached per device and arguments."""
    key = (library, symbol, device.index, *args)
    found = _OCCUPANCY.get(key)
    if found is None:
        out = (c_int * 2)()
        fn = function(library, symbol, [c_int] * len(args) + [c_ptr])
        with torch.cuda.device(device):
            status = fn(*args, ctypes.cast(out, c_ptr))
        check(library, status, symbol)
        found = _OCCUPANCY[key] = (out[0], out[1])
    return found


def scratch(device: torch.device, sizes: Sequence[int]):
    """One float32 allocation carved into buffers of the given counts of
    4-byte elements, each 256-byte aligned: (the tensor that owns them,
    their addresses). One allocation costs the host less than several."""
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // 64) * 64
    buf = torch.empty(max(total, 1), device=device)
    base = buf.data_ptr()
    return buf, [base + 4 * off for off in offsets]


def launch_key(module: str, dtype: torch.dtype = torch.float32) -> str:
    """The ``LAUNCHES`` key of the kernel that the wrapper module
    ``module`` (its ``__name__``) launches on tensors of ``dtype``: the
    module's name, with ``_bf16`` for the bfloat16 build."""
    return module if dtype == torch.float32 else module + BF16_SUFFIX


def count_launch(module: str, dtype: torch.dtype = torch.float32) -> None:
    """One launch of the kernel that the wrapper module ``module``
    launches, in its build for ``dtype``."""
    LAUNCHES[launch_key(module, dtype)] += 1


def launch_count(module: str, name: str) -> int:
    """The ``launches`` and ``launches_bf16`` attributes of a wrapper
    module, for its module ``__getattr__``: its float32 and bfloat16
    kernels' counts in ``LAUNCHES``."""
    if name == "launches":
        return LAUNCHES[module]
    if name == "launches" + BF16_SUFFIX:
        return LAUNCHES[module + BF16_SUFFIX]
    raise AttributeError(f"module {module!r} has no attribute {name!r}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, device: torch.device,
            dtype: torch.dtype = torch.float32,
            shape: Optional[Sequence[int]] = None) -> None:
    """Check a kernel argument: device, dtype, contiguity and shape."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes "
                        f"{dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
