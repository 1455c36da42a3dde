"""Multi-process initialization for data-parallel training.

PyTorch port of ``phoonnx_tpu/parallel/multihost.py``. JAX's distributed
runtime becomes ``torch.distributed``'s process group: every process runs
the same program, :func:`initialize` joins them, and each process is one
rank of the data-parallel group (``parallel/mesh.py``) on one device.
Where XLA inserts the gradient all-reduce, the step averages the
gradients itself (``train/step.py``).

Usage (the same command on every host; one process a GPU):

    python -m torch.distributed.run --nproc-per-node N \\
        -m phoonnx_tpu_torch.train.trainer --dataset-dir out/ ...

``torch.distributed.run`` sets ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``; :func:`initialize` reads them.
"""

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

LOG = logging.getLogger(__name__)

# what torch.distributed.run sets for every process it starts
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the process group; returns True if multi-process.

    Explicit arguments win (``coordinator_address`` as ``host:port`` or
    an init URL such as ``tcp://host:port``); otherwise the launcher's
    environment (:data:`LAUNCH_ENV`) is used. Without either this is a
    no-op that returns False. After the group has formed, a second call
    returns what the first did. A partial request, in the arguments or in
    the environment, raises: it never degrades to N independent
    single-process trainers.

    ``backend``: ``"nccl"`` (one CUDA device a rank) or ``"gloo"`` (the
    CPU, or ranks that share one CUDA device); None takes nccl where a
    CUDA device is available, else gloo.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    given = {"coordinator_address": coordinator_address,
             "num_processes": num_processes, "process_id": process_id}
    if any(v is not None for v in given.values()):
        missing = [name for name, v in given.items() if v is None]
        if missing:
            raise ValueError(
                f"an explicit multi-process request needs "
                f"coordinator_address, num_processes and process_id; "
                f"{', '.join(missing)} not given")
        address, world, rank = (coordinator_address, int(num_processes),
                                int(process_id))
    else:
        present = [v for v in LAUNCH_ENV if os.environ.get(v)]
        if not present:
            LOG.debug("single process; no process group")
            return False
        missing = [v for v in LAUNCH_ENV if not os.environ.get(v)]
        if missing:
            raise ValueError(
                f"partial launcher environment: {', '.join(present)} set, "
                f"{', '.join(missing)} not (torch.distributed.run sets all "
                f"of {', '.join(LAUNCH_ENV)})")
        address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if not 0 <= rank < world:
        raise ValueError(f"process {rank} of {world}: want 0 <= rank < "
                         "world size")
    if "://" not in address:
        address = f"tcp://{address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=address, world_size=world,
                            rank=rank)
    LOG.info("process group: rank %d of %d (%s)", rank, world, backend)
    return world > 1


def local_rank() -> int:
    """This process's index among the processes of its host
    (``LOCAL_RANK``; 0 without a launcher)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def process_batch_slice(global_batch: int) -> slice:
    """This process's rows of a globally indexed batch.

    Each process loads the same global batch and keeps its rows; the
    gradient mean across processes stands in for GSPMD's one global
    array.
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    index = dist.get_rank() if dist.is_initialized() else 0
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} must divide evenly across "
            f"{n} processes (trailing rows would silently never train)")
    per = global_batch // n
    return slice(per * index, per * (index + 1))
