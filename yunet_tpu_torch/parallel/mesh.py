"""Data parallelism over processes — the counterpart of
``yunet_tpu/parallel/mesh.py``.

JAX drives every local chip from one process and builds one ``dp`` mesh
over them; its ``shard_map`` body reduces with ``pmean``/``psum``. The
port follows PyTorch's idiom instead: one process per card (``torchrun``
sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT), so every
``dp`` shard is one rank holding one card:

  - ``pmean``/``psum``             -> ``torch.distributed.all_reduce``
  - ``process_index``/``_count``   -> rank / world size
  - the per-process device count   -> always 1

A ``Mesh`` stands where JAX's mesh stands: the train step, ``fit`` and the
eval hook take it as their ``mesh`` argument. ``batch_sharding`` and
``replicated_sharding`` have no counterpart: a rank holds its own rows of
the batch and a full copy of the state as plain tensors on its card, and
no array spans processes, so there is no sharding to describe.

The train step cannot use DistributedDataParallel: it takes its gradients
with ``torch.autograd.grad``, where DDP's reducer hooks do not fire, and
it also reduces what DDP does not (the positives count inside the loss and
the BN running statistics). It reduces them itself (train/step.py).

The backend follows the device: NCCL for a card, gloo for the CPU. Two
ranks on one card under NCCL fail with NCCL's own error; gloo for ranks
that share a card is the caller's choice, made by initialising the group
before calling in (``torch.distributed.init_process_group("gloo", ...)``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

# what torchrun (torch.distributed.run) sets in each worker
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the ``dp`` axis: its rank, the world size
    (``size``, as JAX's ``mesh.size``) and the device the rank trains on.
    The collectives run on the default process group."""
    rank: int
    size: int
    device: torch.device

    def check(self) -> None:
        """Raise unless the default process group is initialised and this
        mesh is its rank and size."""
        if not dist.is_available() or not dist.is_initialized():
            raise ValueError(f"a mesh of {self.size} ranks needs an "
                             "initialised process group "
                             "(parallel.initialize_distributed)")
        rank, size = dist.get_rank(), dist.get_world_size()
        if (rank, size) != (self.rank, self.size):
            raise ValueError(f"the mesh is rank {self.rank} of {self.size}, "
                             f"the process group rank {rank} of {size}")


def local_device(device=None) -> torch.device:
    """``device`` if given, else the card of this rank: cuda:LOCAL_RANK."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def initialize_distributed(backend: Optional[str] = None, *,
                           device=None) -> bool:
    """Join the default process group. An initialised group is joined as
    it is; otherwise the group is initialised from torchrun's environment
    with ``backend``, by default NCCL when ``device`` (default: this
    rank's card) is a card and gloo for the CPU. With NCCL the rank's card
    becomes the current device. Returns True when this call initialised
    the group (its caller then destroys it)."""
    if dist.is_initialized():
        return False
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            "distributed training needs an initialised process group or "
            f"torchrun's environment; {', '.join(missing)} not set (launch "
            "with yunet_tpu_torch/tools/dist_train.sh or python -m "
            "torch.distributed.run)")
    device = local_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def make_mesh(device=None, *, always: bool = False) -> Optional[Mesh]:
    """The mesh of this rank in the default process group, on ``device``
    (default: this rank's card). None without a group or at world size 1,
    as JAX's ``make_mesh`` is None on one device, unless ``always``: then a
    group must be initialised, and a world of one gets a mesh."""
    initialised = dist.is_available() and dist.is_initialized()
    if not initialised:
        if always:
            raise ValueError("make_mesh(always=True) needs an initialised "
                             "process group")
        return None
    size = dist.get_world_size()
    if size == 1 and not always:
        return None
    return Mesh(dist.get_rank(), size, local_device(device))


def shard_batch(batch: Dict, mesh: Optional[Mesh]) -> Dict:
    """This rank's rows of a global batch: rows [rank*B, (rank+1)*B) of
    every array, B = global rows / world size (JAX's shard_batch places
    the same rows on the rank's device). The batch as it is for no
    mesh."""
    if mesh is None:
        return batch
    out = {}
    for k, v in batch.items():
        rows = len(v)
        if rows % mesh.size:
            raise ValueError(f"{k}: {rows} rows do not split over "
                             f"{mesh.size} ranks")
        per = rows // mesh.size
        out[k] = v[mesh.rank * per:(mesh.rank + 1) * per]
    return out


def broadcast_(tensors, mesh: Mesh) -> None:
    """Every tensor of ``tensors`` (one dtype) set in place to rank 0's
    value, in one broadcast over a flat buffer."""
    tensors = list(tensors)
    if not tensors or mesh.size == 1:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.broadcast(flat, 0)
    unflatten_into_(flat, tensors)


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (nothing without a mesh)."""
    if mesh is not None:
        dist.barrier()


def unflatten_into_(flat: torch.Tensor, tensors) -> None:
    """Copy consecutive slices of ``flat`` into ``tensors``, in order."""
    i = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[i:i + n].view_as(t))
            i += n
