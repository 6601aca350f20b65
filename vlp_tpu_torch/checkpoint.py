"""Checkpoints of the port: weights from a JAX params tree or a reference
``.bin``, and the training run's own epoch and step checkpoints.

The port's modules carry the reference state-dict names, so every path ends
in ``VLPModel.load_state_dict``.  ``load_torch_state_dict``,
``apply_surgery`` (the reference ``from_pretrained`` surgery) and
``_torch_to_flax_map`` are copies of the numpy half of
``vlp_tpu/checkpoint.py``.

A training run writes, under its output directory:

* ``model.{N}.bin`` — after epoch N, a torch state dict under the reference
  keys (the tied decoder shares the word embeddings' storage), loadable by
  :func:`load_reference_bin` and by the reference stack;
* ``optim.{N}.bin`` — BertAdam's ``{"step", "m", "v"}``, plus
  ``"loss_scale"`` (``{"scale", "good_steps"}``) under ``--true_fp16``;
* ``model.s{S}.bin`` / ``optim.s{S}.bin`` — the same after optimizer step S
  (``--save_steps``), the latest two kept.

Resume takes the newer of the largest epoch and the latest step that have
both files (the reference's ``_get_max_epoch_model``,
run_img2txt_dist.py:33-43, over ``.bin`` names).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from vlp_tpu_torch.config import VLPConfig


# ---------------------------------------------------------------------------
# torch .bin -> numpy state dict + surgery
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}


def apply_surgery(sd: Dict[str, np.ndarray], cfg: VLPConfig,
                  task_idx: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Rename + reshape a reference state dict to match ``cfg``."""
    out = {}
    for k, v in sd.items():
        k = k.replace("gamma", "weight").replace("beta", "bias")
        out[k] = np.asarray(v)
    sd = out

    _k = "bert.embeddings.token_type_embeddings.weight"
    if _k in sd and sd[_k].shape[0] != cfg.type_vocab_size:
        old = sd[_k]
        if cfg.type_vocab_size > old.shape[0]:
            new = np.zeros((cfg.type_vocab_size, old.shape[1]), old.dtype)
            new[:old.shape[0]] = old
            if cfg.type_vocab_size >= 6:
                new[2] = old[0]   # L2R
                new[3] = old[0]   # R2L
                new[4] = old[0]   # S2S source
                new[5] = old[1]   # S2S target
            sd[_k] = new
        else:
            sd[_k] = old[:cfg.type_vocab_size]

    _k = "bert.embeddings.position_embeddings.weight"
    if _k in sd and sd[_k].shape[0] != cfg.max_position_embeddings:
        old = sd[_k]
        if cfg.max_position_embeddings > old.shape[0]:
            reps = -(-cfg.max_position_embeddings // old.shape[0])
            sd[_k] = np.concatenate([old] * reps)[:cfg.max_position_embeddings]
        else:
            sd[_k] = old[:cfg.max_position_embeddings]

    _k = "cls.predictions.transform.dense.weight"
    r = max(cfg.relax_projection, 1)
    H = cfg.hidden_size
    if _k in sd and sd[_k].shape[0] != r * H:
        n_state = sd[_k].shape[0] // H
        assert (n_state == 1) != (r == 1), (n_state, r)
        vec_keys = ("cls.predictions.transform.dense.bias",
                    "cls.predictions.transform.LayerNorm.weight",
                    "cls.predictions.transform.LayerNorm.bias")
        if n_state == 1:      # replicate 1 -> r
            sd[_k] = np.tile(sd[_k], (r, 1))
            for vk in vec_keys:
                sd[vk] = np.tile(sd[vk], r)
        else:                 # select r -> 1
            ti = task_idx if task_idx is not None and 0 <= task_idx <= 3 else 0
            sd[_k] = sd[_k].reshape(n_state, H, H)[ti]
            for vk in vec_keys:
                sd[vk] = sd[vk].reshape(n_state, H)[ti]
    return sd


# torch name -> (flax path, transpose?)
def _torch_to_flax_map(cfg: VLPConfig) -> Dict[str, tuple]:
    m: Dict[str, tuple] = {
        "bert.embeddings.word_embeddings.weight":
            (("embeddings", "word_embeddings", "embedding"), False),
        "bert.embeddings.position_embeddings.weight":
            (("embeddings", "position_embeddings", "embedding"), False),
        "bert.embeddings.token_type_embeddings.weight":
            (("embeddings", "token_type_embeddings", "embedding"), False),
        "bert.embeddings.LayerNorm.weight":
            (("embeddings", "LayerNorm", "scale"), False),
        "bert.embeddings.LayerNorm.bias":
            (("embeddings", "LayerNorm", "bias"), False),
        "bert.pooler.dense.weight": (("pooler_dense", "kernel"), True),
        "bert.pooler.dense.bias": (("pooler_dense", "bias"), False),
        "cls.predictions.transform.dense.weight":
            (("mlm", "transform_dense", "kernel"), True),
        "cls.predictions.transform.dense.bias":
            (("mlm", "transform_dense", "bias"), False),
        "cls.predictions.transform.LayerNorm.weight":
            (("mlm", "transform_ln", "scale"), False),
        "cls.predictions.transform.LayerNorm.bias":
            (("mlm", "transform_ln", "bias"), False),
        "cls.predictions.bias": (("mlm", "bias"), False),
        "vis_embed.0.weight": (("vis_fc1", "kernel"), True),
        "vis_embed.0.bias": (("vis_fc1", "bias"), False),
        "vis_embed.2.weight": (("vis_fc2", "kernel"), True),
        "vis_embed.2.bias": (("vis_fc2", "bias"), False),
        "vis_pe_embed.0.weight": (("vis_pe_fc", "kernel"), True),
        "vis_pe_embed.0.bias": (("vis_pe_fc", "bias"), False),
        "ans_classifier.0.weight": (("ans_fc1", "kernel"), True),
        "ans_classifier.0.bias": (("ans_fc1", "bias"), False),
        "ans_classifier.2.weight": (("ans_fc2", "kernel"), True),
        "ans_classifier.2.bias": (("ans_fc2", "bias"), False),
    }
    for i in range(cfg.num_hidden_layers):
        p = f"bert.encoder.layer.{i}."
        li = f"layer_{i}"
        for tname, fname in (("attention.self.query", "q_proj"),
                             ("attention.self.key", "k_proj"),
                             ("attention.self.value", "v_proj"),
                             ("attention.output.dense", "out_proj"),
                             ("intermediate.dense", "ffn_in"),
                             ("output.dense", "ffn_out")):
            m[p + tname + ".weight"] = ((li, fname, "kernel"), True)
            m[p + tname + ".bias"] = ((li, fname, "bias"), False)
        m[p + "attention.output.LayerNorm.weight"] = ((li, "attn_ln", "scale"),
                                                      False)
        m[p + "attention.output.LayerNorm.bias"] = ((li, "attn_ln", "bias"),
                                                    False)
        m[p + "output.LayerNorm.weight"] = ((li, "ffn_ln", "scale"), False)
        m[p + "output.LayerNorm.bias"] = ((li, "ffn_ln", "bias"), False)
    return m


TIED_DECODER = "cls.predictions.decoder.weight"
WORD_EMBEDDINGS = "bert.embeddings.word_embeddings.weight"


# the legacy BERT heads' own parameters (models/heads_legacy.py): reference
# name -> (flax path in a vlp_tpu heads_legacy module, transpose?).  The
# JAX package's LEGACY_HEAD_MAP plus ``extract``, which it leaves out.
LEGACY_HEAD_MAP: Dict[str, tuple] = {
    "cls.seq_relationship.weight": (("seq_relationship", "kernel"), True),
    "cls.seq_relationship.bias": (("seq_relationship", "bias"), False),
    "classifier.weight": (("classifier", "kernel"), True),
    "classifier.bias": (("classifier", "bias"), False),
    "qa_outputs.weight": (("qa_outputs", "kernel"), True),
    "qa_outputs.bias": (("qa_outputs", "bias"), False),
    "R_xy.dense.weight": (("pair_dense", "kernel"), True),
    "R_xy.dense.bias": (("pair_dense", "bias"), False),
    "rel_emb.weight": (("rel_emb", "embedding"), False),
    "extract.weight": (("extract", "kernel"), True),
    "extract.bias": (("extract", "bias"), False),
}


def state_dict_from_flax(np_params, cfg: VLPConfig, legacy: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """JAX params as a numpy tree (``tree_map(np.asarray, params)``) ->
    the port's state dict: dense kernels transposed, the tied decoder set to
    the word embeddings (where the tree has an MLM head).  Paths absent from the tree (the VQA head of a
    caption model) are skipped.  ``legacy``: the tree of a
    ``vlp_tpu.models.heads_legacy`` module, whose backbone sits under
    ``("backbone", "vlp")`` and whose head parameters follow
    :data:`LEGACY_HEAD_MAP`."""
    mapping = _torch_to_flax_map(cfg)
    if legacy:
        mapping = {tk: (("backbone", "vlp") + path, t)
                   for tk, (path, t) in mapping.items()}
        mapping.update(LEGACY_HEAD_MAP)
    out: Dict[str, torch.Tensor] = {}
    for tk, (path, transpose) in mapping.items():
        node = np_params
        for p in path:
            node = node.get(p) if isinstance(node, dict) else None
            if node is None:
                break
        if node is None:
            continue
        v = np.asarray(node)
        # a copy: JAX hands out read-only buffers
        out[tk] = torch.from_numpy(np.array(v.T if transpose else v,
                                            order="C"))
    if WORD_EMBEDDINGS in out and "cls.predictions.bias" in out:
        out[TIED_DECODER] = out[WORD_EMBEDDINGS]
    return out


def require_bin(path: str) -> None:
    """Raise on a directory: the JAX train CLI writes its ``model.N`` as
    orbax directories, which the port cannot read (orbax needs ``jax``).
    The JAX package's convert CLI writes the reference ``.bin`` that the
    port loads."""
    if os.path.isdir(path):
        raise IsADirectoryError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package?); vlp_tpu_torch loads reference .bin files.  Convert "
            "it where the JAX package is installed: python -m "
            f"vlp_tpu.cli.convert --direction jax2torch --input {path} "
            f"--output {path.rstrip(os.sep)}.bin, with the run's "
            "--vocab_size / --new_segment_ids / --relax_projection / "
            "--tasks / --config_path")


def load_reference_bin(path: str, cfg: VLPConfig,
                       task_idx: Optional[int] = 3
                       ) -> Dict[str, torch.Tensor]:
    """A reference ``model.N.bin`` after the ``from_pretrained`` surgery
    (gamma/beta rename, type-vocab expansion, position tiling,
    relax-projection select to head ``task_idx``), as torch tensors.
    Every CLI loads its weights through here; a directory raises
    (:func:`require_bin`)."""
    require_bin(path)
    sd = apply_surgery(load_torch_state_dict(path), cfg, task_idx)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def load_into(model: torch.nn.Module, sd: Dict[str, torch.Tensor]
              ) -> List[str]:
    """Load ``sd`` into ``model``; keys the checkpoint lacks keep their
    initial values and keys the model lacks are ignored, as in the
    reference's ``from_pretrained``.  A shape mismatch raises.  Returns the
    missing keys."""
    own = model.state_dict()
    result = model.load_state_dict({k: v for k, v in sd.items() if k in own},
                                   strict=False)
    return list(result.missing_keys)


# ---------------------------------------------------------------------------
# the training run's checkpoints
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"^(model|optim)\.(s?)(\d+)\.bin$")


def _scan(output_dir: str, step: bool) -> Optional[int]:
    """Largest N (epoch, or step with ``step``) whose model and optim files
    both exist."""
    found = {"model": set(), "optim": set()}
    if os.path.isdir(output_dir):
        for name in os.listdir(output_dir):
            m = _NAME_RE.match(name)
            if m and bool(m.group(2)) == step:
                found[m.group(1)].add(int(m.group(3)))
    both = found["model"] & found["optim"]
    return max(both) if both else None


def get_max_epoch_model(output_dir: str) -> Optional[int]:
    """Largest epoch N with both ``model.N.bin`` and ``optim.N.bin``."""
    return _scan(output_dir, step=False)


def get_latest_step_checkpoint(output_dir: str) -> Optional[int]:
    """Largest step S with both ``model.sS.bin`` and ``optim.sS.bin``."""
    return _scan(output_dir, step=True)


def _save(obj, path: str) -> None:
    # write, then rename: a cut save never leaves a torn file under the
    # name the resume scan looks for
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _model_state_cpu(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict on the CPU; tensors that share storage (the
    tied decoder) stay shared."""
    out, seen = {}, {}
    for k, v in model.state_dict().items():
        key = (v.data_ptr(), tuple(v.shape), v.dtype)
        if key not in seen:
            seen[key] = v.detach().to("cpu", copy=True)
        out[k] = seen[key]
    return out


def save_checkpoint(output_dir: str, tag, model: torch.nn.Module,
                    optimizer) -> None:
    """Write ``model.{tag}.bin`` and ``optim.{tag}.bin``; raises when the
    optimizer does not hold exactly the model's parameters."""
    names = {n for n, _ in model.named_parameters()}
    if set(optimizer.params) != names:
        raise ValueError("save_checkpoint: the optimizer's parameters are "
                         "not the model's")
    os.makedirs(output_dir, exist_ok=True)
    opt = optimizer.state_dict()
    opt.update(m={n: t.detach().cpu() for n, t in opt["m"].items()},
               v={n: t.detach().cpu() for n, t in opt["v"].items()})
    _save(_model_state_cpu(model),
          os.path.join(output_dir, f"model.{tag}.bin"))
    _save(opt, os.path.join(output_dir, f"optim.{tag}.bin"))


KEEP_STEP_CHECKPOINTS = 2


def save_step_checkpoint(output_dir: str, step: int, model,
                         optimizer) -> None:
    """Write ``model.s{step}.bin`` / ``optim.s{step}.bin`` and delete all
    but the latest ``KEEP_STEP_CHECKPOINTS`` step checkpoints."""
    save_checkpoint(output_dir, f"s{step}", model, optimizer)
    steps = []
    for name in os.listdir(output_dir):
        m = _NAME_RE.match(name)
        if m and m.group(2) and m.group(1) == "model":
            steps.append(int(m.group(3)))
    for old in sorted(steps)[:-KEEP_STEP_CHECKPOINTS]:
        for prefix in ("model", "optim"):
            path = os.path.join(output_dir, f"{prefix}.s{old}.bin")
            if os.path.exists(path):
                os.unlink(path)


def restore_model(output_dir: str, tag, model: torch.nn.Module) -> None:
    """Load ``model.{tag}.bin`` into ``model`` in place; raises on a
    missing parameter."""
    sd = torch.load(os.path.join(output_dir, f"model.{tag}.bin"),
                    map_location="cpu", weights_only=True)
    missing = load_into(model, sd)
    if missing:
        raise ValueError(f"model.{tag}.bin lacks {missing[:5]}")


def restore_optimizer(output_dir: str, tag, optimizer) -> None:
    """Load ``optim.{tag}.bin`` into ``optimizer`` (the loss scale too,
    when it scales its loss); raises on moments that do not match its
    parameters."""
    optimizer.load_state_dict(torch.load(
        os.path.join(output_dir, f"optim.{tag}.bin"), map_location="cpu",
        weights_only=True))
