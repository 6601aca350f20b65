"""Random weights from a seed, made on the device in one generator call:
every matrix and embedding table N(0, 0.02) from one flat buffer, biases
0, LayerNorm scales 1 (the initialisation BERT states).  The program and
the reference each get the same values from the same seed."""

from __future__ import annotations

from typing import Dict

import torch

from benchmarks.reference.model import param_shapes


def make_weights(cfg: dict, with_vqa: bool, seed: int, device,
                 dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """name -> tensor.  Matrices and tables in ``dtype`` (the type they
    are served in); LayerNorm parameters and the MLM output bias float32.
    """
    shapes = param_shapes(cfg, with_vqa)
    mats = [n for n, s in shapes.items() if len(s) == 2]
    total = sum(shapes[n][0] * shapes[n][1] for n in mats)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(0.0, cfg["initializer_range"], generator=g)
    out, at = {}, 0
    for n in mats:
        k = shapes[n][0] * shapes[n][1]
        out[n] = flat[at:at + k].view(shapes[n])
        at += k
    for n, s in shapes.items():
        if len(s) == 1:
            one = ".LayerNorm.weight" in n
            vec_dtype = (torch.float32 if ".LayerNorm." in n
                         or n == "cls.predictions.bias" else dtype)
            out[n] = (torch.ones if one else torch.zeros)(
                s, dtype=vec_dtype, device=device)
    return out


def program_state(weights: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The weights under the program's state-dict names: the tied MLM
    decoder reads the word table."""
    return dict(weights, **{"cls.predictions.decoder.weight":
                            weights["bert.embeddings.word_embeddings.weight"]})
