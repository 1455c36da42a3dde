"""The engine's programs as CUDA graphs.

The JAX engine runs each synthesis phase as one program compiled per shape
bucket. The port captures each such program once per key as a CUDA graph
and replays it: one replay launches the whole phase (kernels A, B and C
and every plain op around them) with one host call.

A program is a function of tensors (or ``None``) only; its static
parameters (a frame budget, a window) are bound beforehand and belong to
its key. The first call at a key runs the program eagerly, which fills
every lazy cache (the kernels' libraries and occupancy queries, the iSTFT
tables, cuBLAS handles), and returns that call's outputs; then the
program is captured. Later calls copy their inputs into the graph's
static inputs, replay it and return copies of its static outputs.

Reentrancy: :meth:`Graphs.run` returns fresh tensors, as a JAX program
does, so a caller may hold them across any number of later replays (a
stream paused between its chunks, a request waiting for its frame count
while another thread replays the same key). Its device work (the input
copies, the warm-up, the capture, the replay and the output copies) runs
under one lock on the engine's own stream, which waits for the caller's
current stream before and is waited for after: the engine's replays run
one after another on the device whatever thread or stream calls them.

Inputs: tensors on the host are packed into one pinned buffer and reach
the static inputs in one asynchronous copy; device tensors are copied on
the device.

Launch counts: a kernel wrapper counts in Python (``cuda.LAUNCHES``) and a
replay runs no Python, so each graph keeps the count increments of its
capture and adds them at every replay; the capture itself launches
nothing and counts nothing.

Precision: each warm-up and capture runs in the engine's matmul-precision
scope (``engine._prec_scope``), so the library products a graph captures
(cuBLAS, cuDNN) are those of the engine's precision; a replay runs what
was captured and needs no scope.

Memory: all graphs of an engine draw from one pool. A capture reuses only
memory that earlier captures freed (their temporaries), so one graph's
replay may write over another graph's static outputs; that is safe
because every replay's outputs are copied off, on the same stream and
under the same lock, before any other replay runs. The static inputs lie
outside the pool. A capture that runs out of device memory raises with
its key and the pool's size.

Counts: ``Graphs.replays`` counts the replays of each key (a key's first
call, which captures it, is not one) and ``Graphs.captures`` the
captures, under the same lock. While a ``torch.profiler`` trace is open,
a capture is also a ``graphs.capture`` span (``observability``).

Collection: Python's cyclic collector is held off while a capture runs.
A collection inside a capture would finalize whatever dead cycles hold,
such as a dropped engine's graphs, and destroying a CUDA graph in the
capturing thread invalidates the capture.
"""

import collections
import contextlib
import gc
import threading
from typing import Dict, Optional, Sequence

import torch

from phoonnx_tpu_torch import cuda, observability

# byte alignment of each host input inside the staging buffer
_ALIGN = 64

# the captures in progress in the process, and whether the cyclic
# collector was enabled before the first of them
_NO_GC_LOCK = threading.Lock()
_NO_GC = {"captures": 0, "was_enabled": False}


@contextlib.contextmanager
def _no_collection():
    """Hold Python's cyclic collector off for a capture (the module
    docstring's Collection); captures on several threads share the hold,
    and the collector's state before the first is restored after the
    last."""
    with _NO_GC_LOCK:
        if _NO_GC["captures"] == 0:
            _NO_GC["was_enabled"] = gc.isenabled()
            gc.disable()
        _NO_GC["captures"] += 1
    try:
        yield
    finally:
        with _NO_GC_LOCK:
            _NO_GC["captures"] -= 1
            if _NO_GC["captures"] == 0 and _NO_GC["was_enabled"]:
                gc.enable()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _map(fn, out):
    """``fn`` over a program's outputs (a tensor or a tuple of tensors and
    ``None``), keeping their structure."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    return tuple(None if t is None else fn(t) for t in out)


class CapturedProgram:
    """One program captured at one key on the current stream; call it to
    replay."""

    def __init__(self, fn, args: Sequence, pool):
        stream = torch.cuda.current_stream()
        dev = stream.device
        self._host, self._device, self._specs = [], [], []
        total = 0
        for i, a in enumerate(args):
            if a is not None and not isinstance(a, torch.Tensor):
                raise TypeError(f"program input {i} is a {type(a).__name__}; "
                                "a captured program takes tensors only")
            self._specs.append(None if a is None else
                               (tuple(a.shape), a.dtype, bool(a.is_cuda)))
            if a is None:
                continue
            if a.is_cuda:
                self._device.append(i)
            else:
                self._host.append((i, total))
                total += -(-_nbytes(a) // _ALIGN) * _ALIGN
        self._stage = torch.empty(max(total, 1), dtype=torch.uint8,
                                  device=dev)
        static = list(args)
        for i, off in self._host:
            a = args[i]
            static[i] = self._stage[off:off + _nbytes(a)].view(
                a.dtype).view(a.shape)
        for i in self._device:
            static[i] = torch.empty_like(args[i])
        self.static_in = static
        self._load(args)

        # the warm-up's outputs answer this call
        self.first = fn(*static)

        before = dict(cuda.LAUNCHES)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: another thread's CUDA calls (an allocation, a
            # copy) do not invalidate this capture
            with _no_collection(), torch.cuda.graph(
                    self.graph, pool=pool, stream=stream,
                    capture_error_mode="thread_local"):
                self.static_out = fn(*static)
        finally:
            self.launches = {k: n - before.get(k, 0)
                             for k, n in cuda.LAUNCHES.items()
                             if n != before.get(k, 0)}
            cuda.LAUNCHES.clear()
            cuda.LAUNCHES.update(before)
        # the memory the capture added to the pool
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def _load(self, args: Sequence) -> None:
        if len(args) != len(self._specs):
            raise ValueError(f"{len(args)} inputs, the program takes "
                             f"{len(self._specs)}")
        for i, (a, spec) in enumerate(zip(args, self._specs)):
            got = None if a is None else (tuple(a.shape), a.dtype,
                                          bool(a.is_cuda))
            if got != spec:
                raise ValueError(f"program input {i}: {got} where the graph "
                                 f"was captured with {spec}")
        if self._host:
            # a fresh pinned buffer each call: the host allocator keeps it
            # until the asynchronous copy that reads it has run
            buf = torch.empty(self._stage.numel(), dtype=torch.uint8,
                              pin_memory=True)
            for i, off in self._host:
                a = args[i]
                buf[off:off + _nbytes(a)].view(a.dtype).view(
                    a.shape).copy_(a)
            self._stage.copy_(buf, non_blocking=True)
        for i in self._device:
            if args[i].data_ptr() != self.static_in[i].data_ptr():
                self.static_in[i].copy_(args[i])

    def __call__(self, *args):
        """Replay on ``args``: copies of the outputs."""
        self._load(args)
        self.graph.replay()
        cuda.LAUNCHES.update(self.launches)
        return _map(torch.clone, self.static_out)


class Graphs:
    """An engine's captured programs on one device, by key."""

    def __init__(self, device: torch.device,
                 matmul_precision: Optional[str] = None):
        self.device = device
        self.matmul_precision = matmul_precision
        self.programs: Dict[tuple, CapturedProgram] = {}
        self.replays: "collections.Counter[tuple]" = collections.Counter()
        self.captures = 0
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None
        self._lock = threading.Lock()

    @torch.inference_mode()
    def run(self, key: tuple, fn, args: Sequence):
        """``fn(*args)`` through the graph of ``key``, captured at the
        key's first call; fresh output tensors. Always in inference mode:
        the static inputs are inference tensors, which only inference mode
        may update."""
        with self._lock, torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            current = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                program = self.programs.get(key)
                if program is None:
                    with observability.span("graphs.capture", key=str(key)):
                        program = self._capture(key, fn, args)
                    self.programs[key] = program
                    self.captures += 1
                    out, program.first = program.first, None
                else:
                    out = program(*args)
                    self.replays[key] += 1
            current.wait_stream(self._stream)
            # made on the engine's stream, used on the caller's
            _map(lambda t: t.record_stream(current), out)
        return out

    def _capture(self, key: tuple, fn, args: Sequence) -> CapturedProgram:
        """Capture ``fn`` at ``key``; out of device memory, raise naming the
        key and what the engine's graphs already hold (no graph is
        dropped and nothing runs eagerly in its place)."""
        from phoonnx_tpu_torch.infer.engine import _prec_scope

        try:
            with _prec_scope(self.matmul_precision):
                return CapturedProgram(fn, args, self._pool)
        except Exception as exc:
            if not _out_of_memory(exc):
                raise
            raise torch.OutOfMemoryError(
                f"out of device memory capturing the graph of {key}, with "
                f"{len(self.programs)} graphs holding "
                f"{self.pool_bytes / 2 ** 20:.1f} MiB in this engine's pool: "
                f"{exc}") from exc

    @property
    def pool_bytes(self) -> int:
        """Device memory the captures added to the pool."""
        return sum(p.pool_bytes for p in self.programs.values())


def _out_of_memory(exc: BaseException) -> bool:
    """Whether ``exc`` or an error it was raised from or while handling is
    the allocator's out-of-memory error: inside a capture, that error
    makes the capture's end fail too, and the end's error is the one that
    surfaces."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        if isinstance(exc, torch.OutOfMemoryError):
            return True
        seen.add(id(exc))
        exc = exc.__cause__ or exc.__context__
    return False
