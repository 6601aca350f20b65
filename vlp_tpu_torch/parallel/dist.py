"""One process per GPU on ``torch.distributed``: the port's counterpart of
the JAX CLIs' data-parallel mesh (``vlp_tpu/parallel/mesh.py``'s data axis)
and of ``jax.experimental.multihost_utils``.

A :class:`Dist` is one process's place in a data-parallel group, or a
single process with no group (world 1), whose helpers then do nothing.
:func:`from_cli` forms the group a CLI asks for, in this order:

* ``--jax_distributed --coordinator_address host:port --num_processes N
  --process_id i`` (the JAX CLI's own flags): a group at
  ``tcp://host:port``;
* otherwise torchrun's environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) when ``WORLD_SIZE > 1``;
* otherwise a single process.

On ``cuda`` the backend is NCCL and the device ``cuda:{local_rank}``
(``torch.cuda.set_device`` before the group forms); on ``cpu`` it is gloo.
A group that fails to form raises: NCCL never falls back to gloo.
:func:`init` takes the backend as a parameter, so that two ranks can share
one card under gloo (NCCL refuses two ranks on one device); a group the
caller has already formed (``torch.distributed.is_initialized()``) is
adopted with its own backend, and left to the caller to tear down.

Tensor parallelism (:meth:`Dist.with_tensor_parallel`, ``--tensor_parallel
N``) splits the world into groups of N consecutive ranks
(``parallel/mesh.py``): the ranks of a tensor-parallel group hold shards of
one model and read one batch, and the world's data-parallel groups are the
ranks of equal tensor-parallel index.  Everything that belongs to data
parallelism follows the data-parallel index and group, not the global rank
and the world: the seed fold, the gradient and metric means, the batch
split and :meth:`Dist.shard`.  Without tensor parallelism both are the
rank and the world, as before.

Gradients are reduced explicitly (:meth:`Dist.all_reduce_grads`), once per
optimizer step, not by ``DistributedDataParallel``: its reducer is armed
only by ``DDP.forward``, and the train step calls
``VLPModel.pretrain_losses`` and SCST ``prefill`` / ``scst_replay_hidden``
/ ``lm_logits``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as tdist

from vlp_tpu_torch import tracing
from vlp_tpu_torch.ops.philox import step_seed
from vlp_tpu_torch.ops.tp import TP, broadcast_from_first
from vlp_tpu_torch.parallel import mesh

BUCKET_BYTES = 25 << 20   # gradients flattened per all-reduce


@dataclasses.dataclass
class Dist:
    """This process's rank, the world size, its device, and the group's
    backend (None: no group)."""
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    # when set, (start, end) of each gradient reduction: CUDA events on the
    # card, host seconds on the CPU
    time_reductions: bool = False
    reductions: List[Any] = dataclasses.field(default_factory=list)
    # tensor parallelism: the group size and this rank's group, and the
    # data-parallel group of the ranks of its tensor-parallel index (None:
    # the whole world, or no collective where it has one rank)
    tp: int = 1
    tp_group: Any = None
    dp_group: Any = None
    # False for a group the caller formed (``from_cli`` adopted it)
    owns_group: bool = True

    @property
    def grouped(self) -> bool:
        return self.backend is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def dp_grouped(self) -> bool:
        """Whether the data-parallel means run a collective: a group was
        formed and, under tensor parallelism, it has more than one
        data-parallel rank (without it, the world is the data-parallel
        group, of any size, as before)."""
        return self.grouped and (self.tp == 1 or self.dp_world > 1)

    @property
    def dp_index(self) -> int:
        return mesh.rank_layout(self.rank, self.tp)[0]

    @property
    def tp_index(self) -> int:
        return mesh.rank_layout(self.rank, self.tp)[1]

    @property
    def dp_world(self) -> int:
        return self.world // self.tp

    @property
    def tensor_parallel(self) -> Optional[TP]:
        """This rank's place in its tensor-parallel group (None without
        tensor parallelism)."""
        if self.tp == 1:
            return None
        return TP(index=self.tp_index, size=self.tp, group=self.tp_group)

    @property
    def data_parallel(self) -> Optional[TP]:
        """This rank's place in its data-parallel group (None with one
        data-parallel rank): the group over whose global batch the GSPMD
        layout normalises its masked-LM loss (``VLPModel.loss_group``)."""
        if self.dp_world == 1:
            return None
        return TP(index=self.dp_index, size=self.dp_world,
                  group=self.dp_group)

    def with_tensor_parallel(self, tp: int) -> "Dist":
        """This rank of the world split into tensor-parallel groups of
        ``tp`` (``mesh.group_ranks``): forms every group on every rank, in
        one order.  ``tp`` 1 returns this Dist."""
        if tp == 1:
            return self
        tps, dps = mesh.group_ranks(self.world, tp)
        if not self.grouped:
            raise ValueError(f"--tensor_parallel {tp} needs a group of "
                             f"{tp} or more processes, not one")
        tp_group = dp_group = None
        for ranks in tps:
            g = tdist.new_group(ranks)
            if self.rank in ranks:
                tp_group = g
        if len(dps[0]) > 1:
            for ranks in dps:
                g = tdist.new_group(ranks)
                if self.rank in ranks:
                    dp_group = g
        return dataclasses.replace(self, tp=tp, tp_group=tp_group,
                                   dp_group=dp_group, reductions=[])

    def rank_seed(self, seed: int) -> int:
        """This rank's seed of a step's randomness: ``step_seed(seed,
        dp_index)`` when there is more than one data-parallel rank (JAX
        folds in ``axis_index("data")``), ``seed`` itself otherwise, so
        that a world of one draws what a single process draws, and the
        ranks of a tensor-parallel group draw alike."""
        return (step_seed(seed, self.dp_index) if self.dp_world > 1
                else seed)

    def destroy(self) -> None:
        """Tear down the group this Dist formed (not one it adopted)."""
        if self.grouped and self.owns_group and tdist.is_initialized():
            tdist.destroy_process_group()
        self.backend = None

    # -- collectives -------------------------------------------------------
    def broadcast_params(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank (a full model:
        under tensor parallelism, broadcast before sharding)."""
        if not self.grouped:
            return
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                tdist.broadcast(t.data, src=0)

    def all_reduce_grads(self, params: Iterable[torch.nn.Parameter], *,
                         check: bool = True) -> None:
        """Replace each ``.grad`` by its mean over the data-parallel ranks
        (under tensor parallelism, the ranks of this rank's tensor-parallel
        index: a shard's gradient is averaged with the same shard's): one
        all-reduce per bucket of up to BUCKET_BYTES, flattened.  The ranks
        must agree on which parameters have no gradient; ``check`` verifies
        it first (:meth:`check_grad_agreement`, which syncs the host: a
        captured step checks once, before its capture, and reduces with
        ``check=False``).  The agreement check and the buckets are the
        spans ``dist.grad_agreement`` and ``dist.grad_buckets``."""
        if not self.dp_grouped:
            return
        start = self._mark()
        params = [p for p in params if p.requires_grad]
        if check:
            self.check_grad_agreement(params)
        grads = [p.grad for p in params if p.grad is not None]
        with tracing.span("dist.grad_buckets"):
            bucket: List[torch.Tensor] = []
            size = 0
            for g in grads + [None]:
                if bucket and (g is None or g.dtype != bucket[0].dtype
                               or size + g.numel() * g.element_size()
                               > BUCKET_BYTES):
                    self._reduce_bucket(bucket)
                    bucket, size = [], 0
                if g is not None:
                    bucket.append(g)
                    size += g.numel() * g.element_size()
        if start is not None:
            self.reductions.append((start, self._mark()))

    def check_grad_agreement(self, params: Iterable[torch.nn.Parameter]
                             ) -> None:
        """Raise unless every data-parallel rank has a gradient for the same
        parameters (one all-reduce and a host sync)."""
        if not self.dp_grouped:
            return
        params = [p for p in params if p.requires_grad]
        with tracing.span("dist.grad_agreement"):
            has = torch.tensor([p.grad is not None for p in params],
                               dtype=torch.int32, device=self.device)
            tdist.all_reduce(has, group=self.dp_group)
            agree = bool(((has == 0) | (has == self.dp_world)).all())
        if not agree:
            raise RuntimeError("data parallel: the ranks disagree on which "
                               "parameters have a gradient")

    def _reduce_bucket(self, bucket: List[torch.Tensor]) -> None:
        """One flat all-reduce of the bucket's tensors, their mean copied
        back in one multi-tensor launch."""
        flat = torch.cat([x.reshape(-1) for x in bucket])
        tdist.all_reduce(flat, group=self.dp_group)
        flat.div_(self.dp_world)
        views, offset = [], 0
        for x in bucket:
            views.append(flat[offset:offset + x.numel()].view_as(x))
            offset += x.numel()
        torch._foreach_copy_(bucket, views)

    def _mark(self):
        if not self.time_reductions:
            return None
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def reduction_ms(self) -> List[float]:
        """Milliseconds of each gradient reduction timed so far (with
        ``time_reductions``; CUDA events on the card: synchronises)."""
        if self.device.type == "cuda" and self.reductions:
            torch.cuda.synchronize(self.device)
            return [a.elapsed_time(b) for a, b in self.reductions]
        return [(b - a) * 1e3 for a, b in self.reductions]

    def all_reduce_mean(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """The mean over the data-parallel ranks of a dict of scalars
        (tensors keep their dtype and device; floats come back as floats).
        Under tensor parallelism the ranks of a group hold the same
        values."""
        if not self.dp_grouped:
            return metrics
        keys = sorted(metrics)
        vals = torch.stack([torch.as_tensor(metrics[k]).to(
            self.device, torch.float32).reshape(()) for k in keys])
        tdist.all_reduce(vals, group=self.dp_group)
        vals = vals / self.dp_world
        out = {}
        for k, v in zip(keys, vals):
            m = metrics[k]
            out[k] = (v.to(m.device, m.dtype) if torch.is_tensor(m)
                      else float(v))
        return out

    def broadcast_ints(self, values: List[int]) -> List[int]:
        """Rank 0's ints on every rank."""
        if not self.grouped:
            return list(values)
        t = torch.tensor(values, dtype=torch.int64, device=self.device)
        tdist.broadcast(t, src=0)
        return [int(x) for x in t.tolist()]

    def broadcast_in_tp_group(self, tensors: Iterable[torch.Tensor]) -> None:
        """The tensor-parallel group's first rank's ``tensors`` on every
        rank of the group, in place (a batch: the ranks of a group must
        read the same one, whatever each one's loader drew)."""
        broadcast_from_first(tensors, self.tensor_parallel)

    def barrier(self) -> None:
        if self.backend == "nccl":
            tdist.barrier(device_ids=[self.device.index])
        elif self.grouped:
            tdist.barrier()

    def gather_objects(self, obj) -> Optional[list]:
        """Every rank's ``obj``, in rank order, on rank 0 (None elsewhere);
        ``[obj]`` without a group."""
        if not self.grouped:
            return [obj]
        out = [None] * self.world if self.is_main else None
        tdist.gather_object(obj, out, dst=0)
        return out

    def all_gather_objects(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        if not self.grouped:
            return [obj]
        out = [None] * self.world
        tdist.all_gather_object(out, obj)
        return out

    def shard(self, n: int) -> range:
        """This data-parallel rank's contiguous slice of ``n`` items:
        ceil(n / dp_world) each, the last ranks taking what is left
        (possibly nothing); the ranks of a tensor-parallel group take the
        same slice."""
        per = -(-n // self.dp_world)
        lo = min(n, self.dp_index * per)
        return range(lo, min(n, lo + per))


def init(device, *, init_method: str, world_size: int, rank: int,
         local_rank: int = 0, backend: Optional[str] = None) -> Dist:
    """Form a group of ``world_size`` processes at ``init_method``
    (``tcp://host:port`` or ``env://``).  ``device`` is the device type:
    on ``cuda`` the process takes ``cuda:{local_rank}`` and, unless
    ``backend`` says otherwise, NCCL; on ``cpu`` gloo."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda but torch.cuda.is_available() is "
                               "False; pass --device cpu")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    elif kind == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device!r}")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=world_size, rank=rank)
    return Dist(rank=rank, world=world_size, device=dev, backend=backend)


def from_cli(device, *, jax_distributed: bool = False,
             coordinator_address: Optional[str] = None,
             num_processes: Optional[int] = None,
             process_id: Optional[int] = None) -> Dist:
    """The group a CLI's flags and environment ask for (module
    docstring), or a single process on ``device``.  With the JAX flags the
    local rank is ``LOCAL_RANK`` if set, else the process id modulo the
    node's GPUs.  A group that is already initialized is adopted as it is
    (its backend, this process's current CUDA device on ``cuda``); it
    never forms a gloo group on ``cuda`` by itself."""
    kind = torch.device(device).type
    if tdist.is_initialized():
        if kind == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device cuda but torch.cuda.is_available()"
                                   " is False; pass --device cpu")
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            dev = torch.device(kind)
        return Dist(rank=tdist.get_rank(), world=tdist.get_world_size(),
                    device=dev, backend=tdist.get_backend(),
                    owns_group=False)
    if jax_distributed:
        if (coordinator_address is None or num_processes is None
                or process_id is None):
            raise ValueError("--jax_distributed needs --coordinator_address "
                             "host:port, --num_processes and --process_id")
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = (process_id % max(torch.cuda.device_count(), 1)
                     if kind == "cuda" else 0)
        return init(kind, init_method=f"tcp://{coordinator_address}",
                    world_size=num_processes, rank=process_id,
                    local_rank=int(local))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        return init(kind, init_method="env://", world_size=world,
                    rank=int(os.environ["RANK"]),
                    local_rank=int(os.environ.get("LOCAL_RANK", "0")))
    return Dist(device=torch.device(device))
