"""The data-parallel group and what moves across it.

PyTorch port of the data-parallel half of ``phoonnx_tpu/parallel/mesh.py``
(``:30-101``). A JAX ``Mesh`` with a ``data`` axis becomes :class:`Mesh`:
the process group's size, this process's rank and its device. Parameters
are replicated (rank 0's are broadcast after init, resume and warm
start), each rank takes its rows of every global batch, and the step
averages the gradients across ranks with ``all_reduce`` over a few flat
buffers, where XLA inserts the all-reduce for GSPMD. Only ``all_reduce``
and ``broadcast`` are used: gloo carries both for CUDA tensors, so ranks
that share one card run the whole path over gloo.

Not ported: the tensor-parallel half (``_tp_spec_for``,
``shard_params_tp``, ``mesh.py:107-160``), which no entry point reaches.
"""

import socket
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from phoonnx_tpu_torch.parallel import multihost

# the most elements of one flat buffer of a collective: 128 MiB of float32
BUCKET_ELEMENTS = 1 << 25


@dataclass(frozen=True)
class Mesh:
    """The data-parallel group: ``size`` ranks (the default process
    group), this process's ``rank`` and the ``device`` it computes on."""

    size: int
    rank: int
    device: torch.device


def _device_id(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"


def _check_devices(device: torch.device, size: int) -> None:
    """NCCL takes one device a rank: raise, naming the ranks, where two
    share one (the comparison runs over a gloo group of its own, before
    any NCCL collective could fail or hang on it)."""
    side = dist.new_group(backend="gloo")
    try:
        ids: List[Optional[str]] = [None] * size
        dist.all_gather_object(ids, _device_id(device), group=side)
    finally:
        dist.destroy_process_group(side)
    first = {}
    for rank, ident in enumerate(ids):
        if ident in first:
            raise ValueError(
                f"ranks {first[ident]} and {rank} share CUDA device "
                f"{ident}: the nccl backend takes one device a rank; name "
                "backend='gloo' for ranks that share a card")
        first[ident] = rank


def make_mesh(n_data: Optional[int] = None, device=None) -> Mesh:
    """The data-parallel group over every process of the process group
    (one rank without one). ``device``: this rank's device; None is
    ``cuda:LOCAL_RANK``. The group must span every process: a rank left
    out would wait at the first collective."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = size
    if n_data == 0:
        raise ValueError(f"mesh would be EMPTY: n_data=0 of {size} ranks")
    if n_data > size:
        raise ValueError(f"mesh wants {n_data} ranks, have {size}")
    if n_data < size:
        raise ValueError(
            f"mesh of {n_data} ranks would leave out {size - n_data} of "
            f"the {size} processes; size the mesh to span every process")
    device = torch.device(device if device is not None
                          else f"cuda:{multihost.local_rank()}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if dist.is_initialized() and dist.get_backend() == "nccl":
            _check_devices(device, size)
    return Mesh(size=size, rank=rank, device=device)


def batch_sharding(mesh: Mesh, global_batch: int,
                   grad_accum: int = 1) -> np.ndarray:
    """This rank's rows of a global batch, as JAX lays a batch sharded
    over the data axis and sliced into ``grad_accum`` micro-batches
    (``step.py:272-276``): micro-batch ``i`` is global rows ``[i * B/k,
    (i + 1) * B/k)`` and this rank's part of it is its ``1/size`` share.
    The rows come micro-batch by micro-batch, so that the rank's own
    micro-batch ``i`` is its share of the global one."""
    if global_batch % (mesh.size * grad_accum):
        raise ValueError(
            f"global batch {global_batch} must divide evenly across "
            f"{mesh.size} ranks x grad_accum {grad_accum} (trailing rows "
            "would silently never train)")
    micro = global_batch // grad_accum
    per = micro // mesh.size
    start = mesh.rank * per
    return np.concatenate([np.arange(i * micro + start, i * micro + start
                                     + per) for i in range(grad_accum)])


def shard_batch(mesh: Mesh, batch: Dict[str, Any],
                grad_accum: int = 1) -> Dict[str, Any]:
    """This rank's rows (:func:`batch_sharding`) of a host batch dict."""
    rows = batch_sharding(mesh, len(next(iter(batch.values()))), grad_accum)
    return {key: value[rows] for key, value in batch.items()}


def _runs(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` in order, cut into runs of one dtype and
    device of at most :data:`BUCKET_ELEMENTS` (a larger tensor alone)."""
    runs: List[List[int]] = []
    size = 0
    for i, t in enumerate(tensors):
        last = tensors[runs[-1][0]] if runs else None
        if (last is None or t.dtype != last.dtype or t.device != last.device
                or size + t.numel() > BUCKET_ELEMENTS):
            runs.append([])
            size = 0
        runs[-1].append(i)
        size += t.numel()
    return runs


def all_mean(mesh: Mesh, tensors: Sequence[torch.Tensor]
             ) -> List[torch.Tensor]:
    """The mean across ranks of each tensor (new tensors, in order): one
    ``all_reduce`` a flat buffer, not one a tensor. Every rank gets the
    same bits."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    with torch.no_grad():
        for run in _runs(tensors):
            flat = torch.cat([tensors[i].reshape(-1) for i in run])
            dist.all_reduce(flat)
            flat /= mesh.size
            pieces = flat.split([tensors[i].numel() for i in run])
            for i, piece in zip(run, pieces):
                out[i] = piece.view(tensors[i].shape)
    return out


def replicated(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite ``tensors`` in place with rank 0's values, one
    ``broadcast`` a flat buffer on the mesh's device (tensors elsewhere,
    such as AdamW's step counts on the host, are copied there and
    back)."""
    with torch.no_grad():
        moved = [t.to(mesh.device) for t in tensors]
        for run in _runs(moved):
            flat = torch.cat([moved[i].reshape(-1) for i in run])
            dist.broadcast(flat, 0)
            pieces = flat.split([tensors[i].numel() for i in run])
            for i, piece in zip(run, pieces):
                tensors[i].copy_(piece.view(tensors[i].shape))


def shard_train_state(mesh: Mesh, state):
    """Replicate a train state across the group (DP: parameters
    everywhere): rank 0's parameters, optimizer moments and step count
    overwrite every rank's. Returns ``state``."""
    from phoonnx_tpu_torch.train.step import leaves

    tensors = []
    for tree, opt in ((state.params_g, state.opt_g),
                      (state.params_d, state.opt_d)):
        for p in leaves(tree):
            tensors.append(p)
            moments = opt.state.get(p, {})
            tensors += [moments[key] for key in sorted(moments)
                        if isinstance(moments[key], torch.Tensor)]
    step = torch.tensor([state.step], dtype=torch.int64)
    replicated(mesh, tensors + [step])
    state.step = int(step)
    return state
