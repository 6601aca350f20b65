"""The manual tensor-parallel layout (counterpart of the shard_map part of
``vlp_tpu/parallel/mesh.py``, ``shard_map_tp_pspec`` / ``tp_param_specs``).

Rank layout: ``rank -> (dp_index, tp_index) = (rank // tp, rank % tp)``,
the device order of JAX ``make_mesh(data, model)``: the ranks of one
tensor-parallel group are consecutive, so with torchrun's node-major ranks
a group lies within a node when the node's process count divides by tp.

Which parameters shard, under the reference state-dict names and
PyTorch's ``[out, in]`` weights (JAX's ``[in, out]`` kernels transposed):

* column-parallel, ``attention.self.{query,key,value}`` and
  ``intermediate.dense`` of every encoder layer: weight dim 0 and the bias
  (JAX ``_TP_COL``: q/k/v_proj, ffn_in);
* row-parallel, ``attention.output.dense`` and ``output.dense``: weight
  dim 1, the bias replicated (added once, after the sum; JAX ``_TP_ROW``:
  out_proj, ffn_out);
* everything else replicated: embeddings, LayerNorms, the pooler and
  every head.

The rules apply to parameters and to BertAdam's moments alike, and raise
on widths that do not divide.  Shards are contiguous: rank t holds rows
(columns) ``t * n / tp .. (t + 1) * n / tp``, so rank t holds heads
``t * H / tp ..`` of a layer.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as tdist

_LAYER = re.compile(r"(?:^|\.)encoder\.layer\.\d+\.(.+)\.(weight|bias)$")
_COL = ("attention.self.query", "attention.self.key", "attention.self.value",
        "intermediate.dense")      # shard the output dim
_ROW = ("attention.output.dense", "output.dense")   # shard the input dim


def rank_layout(rank: int, tp: int) -> Tuple[int, int]:
    """(dp_index, tp_index) of global ``rank`` under tensor parallelism
    ``tp``."""
    return rank // tp, rank % tp


def group_ranks(world: int, tp: int) -> Tuple[List[List[int]],
                                              List[List[int]]]:
    """(the tensor-parallel groups, the data-parallel groups) of a world:
    lists of global ranks, each group in index order."""
    if tp < 1 or world % tp:
        raise ValueError(f"the world ({world} ranks) does not divide into "
                         f"tensor-parallel groups of {tp}")
    dp = world // tp
    tps = [[d * tp + t for t in range(tp)] for d in range(dp)]
    dps = [[d * tp + t for d in range(dp)] for t in range(tp)]
    return tps, dps


def shard_dim(name: str) -> Optional[int]:
    """The dim of parameter ``name`` (a reference state-dict name) that
    tensor parallelism shards, or None (replicated)."""
    m = _LAYER.search(name)
    if m is None:
        return None
    module, leaf = m.groups()
    if module in _COL:
        return 0
    if module in _ROW and leaf == "weight":
        return 1
    return None


def tp_param_specs(shapes: Mapping[str, torch.Size], tp: int
                   ) -> Dict[str, Optional[int]]:
    """{name: sharded dim or None} of a state dict's shapes; raises where a
    sharded dim does not divide by ``tp`` (a replicated query beside a
    sharded key would change the attention width mid-layer)."""
    out = {}
    for name, shape in shapes.items():
        d = shard_dim(name)
        if d is not None and shape[d] % tp:
            raise ValueError(f"{name} dim {d} ({shape[d]}) does not divide "
                             f"by tensor_parallel={tp}")
        out[name] = d
    return out


def shard_state_dict(sd: Mapping[str, torch.Tensor], tp_index: int,
                     tp: int) -> Dict[str, torch.Tensor]:
    """Rank ``tp_index``'s shard of a full state dict (parameters or a
    moment dict): sharded entries sliced and copied, replicated ones as
    they are."""
    specs = tp_param_specs({k: v.shape for k, v in sd.items()}, tp)
    out = {}
    for k, v in sd.items():
        d = specs[k]
        if d is None:
            out[k] = v
        else:
            n = v.shape[d] // tp
            out[k] = v.narrow(d, tp_index * n, n).clone()
    return out


def gather_state_dict(shards: List[Mapping[str, torch.Tensor]]
                      ) -> Dict[str, torch.Tensor]:
    """The full state dict from every rank's shard, in tp-index order:
    sharded entries concatenated, replicated ones from shard 0."""
    out = {}
    for k, v in shards[0].items():
        d = shard_dim(k)
        out[k] = v if d is None else torch.cat([s[k] for s in shards], dim=d)
    return out


def gather_full(sd: Mapping[str, torch.Tensor], tp_index: int, tp: int,
                group) -> Dict[str, torch.Tensor]:
    """:func:`gather_state_dict` as a collective over the tensor-parallel
    ``group``: each sharded entry is placed at its offset in a zero tensor
    of the full shape and sum-all-reduced (an all-gather that every
    backend takes for CUDA tensors; adding zeros leaves the bits as they
    are).  Every rank of the group must call it; every rank gets the full
    dict."""
    out = {}
    for k, v in sd.items():
        d = shard_dim(k)
        if d is None or tp == 1:
            out[k] = v
            continue
        shape = list(v.shape)
        shape[d] *= tp
        full = torch.zeros(shape, dtype=v.dtype, device=v.device)
        full.narrow(d, tp_index * v.shape[d], v.shape[d]).copy_(v)
        tdist.all_reduce(full, group=group)
        out[k] = full
    return out


def shard_model_(model: torch.nn.Module, tp_index: int, tp: int) -> None:
    """Replace each sharded parameter of a full model by rank
    ``tp_index``'s shard, in place (module by module: ``nn.Linear`` keeps
    working, its weight now ``[out / tp, in]`` or ``[out, in / tp]``)."""
    specs = tp_param_specs({n: p.shape for n, p in model.named_parameters()},
                           tp)
    with torch.no_grad():
        for name, p in model.named_parameters():
            d = specs[name]
            if d is not None:
                n = p.shape[d] // tp
                p.data = p.data.narrow(d, tp_index * n, n).clone()
