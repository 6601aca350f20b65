"""The tensor-parallel layouts (counterpart of ``vlp_tpu/parallel/mesh.py``:
``shard_map_tp_pspec`` / ``tp_param_specs`` for the manual layout,
``param_pspec`` / ``param_sharding_tree`` for the GSPMD one).

Rank layout: ``rank -> (dp_index, tp_index) = (rank // tp, rank % tp)``,
the device order of JAX ``make_mesh(data, model)``: the ranks of one
tensor-parallel group are consecutive, so with torchrun's node-major ranks
a group lies within a node when the node's process count divides by tp.

Which parameters shard, under the reference state-dict names and
PyTorch's ``[out, in]`` weights (JAX's ``[in, out]`` kernels transposed).
Layout ``"shard_map"`` (``--tp_impl shard_map``):

* column-parallel, ``attention.self.{query,key,value}`` and
  ``intermediate.dense`` of every encoder layer: weight dim 0 and the bias
  (JAX ``_TP_COL``: q/k/v_proj, ffn_in);
* row-parallel, ``attention.output.dense`` and ``output.dense``: weight
  dim 1, the bias replicated (added once, after the sum; JAX ``_TP_ROW``:
  out_proj, ffn_out);
* everything else replicated: embeddings, LayerNorms, the pooler and
  every head.

Layout ``"gspmd"`` (``--tp_impl gspmd``) shards those and also:

* the three embedding tables (word, position, token type; the tied MLM
  decoder is the word table), dim 0, their vocab;
* column-parallel ``cls.predictions.transform.dense``, ``vis_embed.0``
  and ``ans_classifier.0``: weight dim 0 and the bias;
* row-parallel ``vis_embed.2`` and ``ans_classifier.2``: weight dim 1;
* the MLM bias ``cls.predictions.bias``, with the vocab.

JAX replicates every bias.  Here a column-parallel layer's bias (and the
vocab-long MLM bias) is stored with its columns, as the manual layout does
for q/k/v: the arithmetic is the same, and a replicated bias beside
sharded columns would need a gradient all-reduce of its own.

The rules apply to parameters and to BertAdam's moments alike.  Under
``"shard_map"`` a width that does not divide raises; under ``"gspmd"`` the
entry is replicated, as ``param_sharding_tree`` does (``VLPModel.shard_``
still raises for heads and FFN widths that do not divide).  So the rule
is one of (name, full shape, tp): :func:`tp_param_specs` applies it to the
full shapes once, and every caller that holds shards reads its result
(``VLPModel.shard_`` keeps it as ``model.tp_specs``).  Shards are
contiguous: rank t holds rows (columns) ``t * n / tp .. (t + 1) * n /
tp``, so rank t holds heads ``t * H / tp ..`` of a layer and vocab ids
``t * V / tp ..``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

LAYOUTS = ("shard_map", "gspmd")

_LAYER = re.compile(r"(?:^|\.)encoder\.layer\.\d+\.(.+)\.(weight|bias)$")
_COL = ("attention.self.query", "attention.self.key", "attention.self.value",
        "intermediate.dense")      # shard the output dim
_ROW = ("attention.output.dense", "output.dense")   # shard the input dim
# the GSPMD layout's further entries (JAX param_pspec)
_TABLES = ("bert.embeddings.word_embeddings.weight",
           "bert.embeddings.position_embeddings.weight",
           "bert.embeddings.token_type_embeddings.weight",
           "cls.predictions.decoder.weight", "cls.predictions.bias")
_HEAD_COL = ("cls.predictions.transform.dense", "vis_embed.0",
             "ans_classifier.0")
_HEAD_ROW = ("vis_embed.2", "ans_classifier.2")


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


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown tensor-parallel layout {layout!r}: one "
                         f"of {LAYOUTS}")


def shard_dim(name: str, shape: Optional[Sequence[int]] = None,
              tp: int = 1, layout: str = "shard_map") -> Optional[int]:
    """The dim of parameter ``name`` (a reference state-dict name, full
    shape ``shape``) that tensor parallelism of ``tp`` shards under
    ``layout``, or None (replicated).  Under ``"gspmd"`` an entry whose
    dim does not divide by ``tp`` is replicated; ``"shard_map"`` depends
    on the name alone (:func:`tp_param_specs` raises there instead)."""
    _check_layout(layout)
    d = None
    m = _LAYER.search(name)
    if m is not None:
        module, leaf = m.groups()
        if module in _COL:
            d = 0
        elif module in _ROW and leaf == "weight":
            d = 1
    elif layout == "gspmd":
        module, _, leaf = name.rpartition(".")
        if name in _TABLES or module in _HEAD_COL:
            d = 0
        elif module in _HEAD_ROW and leaf == "weight":
            d = 1
    if (layout == "gspmd" and d is not None and shape is not None
            and shape[d] % tp):
        return None
    return d


def tp_param_specs(shapes: Mapping[str, torch.Size], tp: int,
                   layout: str = "shard_map") -> Dict[str, Optional[int]]:
    """{name: sharded dim or None} of a state dict's full shapes.  Under
    ``"shard_map"`` it raises where a sharded dim does not divide by
    ``tp`` (a replicated query beside a sharded key would change the
    attention width mid-layer); under ``"gspmd"`` such an entry is
    replicated."""
    out = {}
    for name, shape in shapes.items():
        d = shard_dim(name, shape, tp, layout)
        if d is not None and shape[d] % tp:
            raise ValueError(f"{name} dim {d} ({shape[d]}) does not divide "
                             f"by tensor_parallel={tp}")
        out[name] = d
    return out


def shard_state_dict(sd: Mapping[str, torch.Tensor], tp_index: int,
                     tp: int, layout: str = "shard_map"
                     ) -> Dict[str, torch.Tensor]:
    """Rank ``tp_index``'s shard of a full state dict (parameters or a
    moment dict): sharded entries sliced and copied, replicated ones as
    they are."""
    specs = tp_param_specs({k: v.shape for k, v in sd.items()}, tp, layout)
    out = {}
    for k, v in sd.items():
        d = specs[k]
        if d is None:
            out[k] = v
        else:
            n = v.shape[d] // tp
            out[k] = v.narrow(d, tp_index * n, n).clone()
    return out


def gather_state_dict(shards: List[Mapping[str, torch.Tensor]],
                      specs: Mapping[str, Optional[int]]
                      ) -> Dict[str, torch.Tensor]:
    """The full state dict from every rank's shard, in tp-index order:
    sharded entries concatenated, replicated ones from shard 0.  ``specs``:
    :func:`tp_param_specs` of the full shapes (``model.tp_specs``)."""
    out = {}
    for k, v in shards[0].items():
        d = specs[k]
        out[k] = v if d is None else torch.cat([s[k] for s in shards], dim=d)
    return out


def gather_full(sd: Mapping[str, torch.Tensor], tp_index: int, tp: int,
                group, specs: Mapping[str, Optional[int]]
                ) -> Dict[str, torch.Tensor]:
    """:func:`gather_state_dict` as a collective over the tensor-parallel
    ``group``: each sharded entry is placed at its offset in a zero tensor
    of the full shape and sum-all-reduced (an all-gather that every
    backend takes for CUDA tensors; adding zeros leaves the bits as they
    are).  ``specs`` as for :func:`gather_state_dict`.  Every rank of the
    group must call it; every rank gets the full dict.  Entries that are
    one tensor (the tied decoder) are gathered once."""
    out, done = {}, {}
    for k, v in sd.items():
        d = specs[k]
        if d is None or tp == 1:
            out[k] = v
            continue
        key = (v.data_ptr(), tuple(v.shape), v.dtype)
        if key not in done:
            shape = list(v.shape)
            shape[d] *= tp
            full = torch.zeros(shape, dtype=v.dtype, device=v.device)
            full.narrow(d, tp_index * v.shape[d], v.shape[d]).copy_(v)
            tdist.all_reduce(full, group=group)
            done[key] = full
        out[k] = done[key]
    return out


def shard_model_(model: torch.nn.Module, tp_index: int, tp: int,
                 layout: str = "shard_map") -> Dict[str, Optional[int]]:
    """Replace each sharded parameter of a full model by rank
    ``tp_index``'s shard, in place (module by module: ``nn.Linear`` and
    ``nn.Embedding`` keep working on the smaller weight, and a tied
    parameter stays one parameter).  Returns the specs of the full state
    dict."""
    specs = tp_param_specs({k: v.shape for k, v in
                            model.state_dict().items()}, tp, layout)
    with torch.no_grad():
        for name, p in model.named_parameters():
            d = specs[name]
            if d is not None:
                n = p.shape[d] // tp
                p.data = p.data.narrow(d, tp_index * n, n).clone()
    return specs
