"""BertAdam as the reference optimizer states it (pytorch-pretrained-BERT
``optimization.py``): each weight's gradient clipped to norm 1 on its own,
Adam moments without bias correction (beta 0.9 / 0.999, eps 1e-6),
decoupled weight decay on every weight but biases and LayerNorms, and the
``warmup_linear`` schedule evaluated at the count of completed updates.
Plain PyTorch, float32."""

from __future__ import annotations

from typing import Dict, Optional

import torch

B1, B2, EPS, MAX_NORM = 0.9, 0.999, 1e-6, 1.0


def warmup_linear(x: float, warmup: float) -> float:
    if x < warmup:
        return x / warmup
    return max((x - 1.0) / (warmup - 1.0), 0.0)


def decays(name: str) -> bool:
    return not (name.endswith("bias") or ".LayerNorm." in name)


def clipped(g: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(g * g))
    return g * torch.where(norm > MAX_NORM, MAX_NORM / (norm + 1e-6),
                           torch.ones((), device=g.device))


class BertAdam:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 warmup: float, t_total: int, weight_decay: float):
        self.params = params
        self.lr, self.warmup, self.t_total = lr, warmup, t_total
        self.wd = weight_decay
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.done = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]
             ) -> Dict[str, torch.Tensor]:
        """One update; returns the clipped gradients it took."""
        lr = self.lr * warmup_linear(self.done / self.t_total, self.warmup)
        taken = {}
        for n, p in self.params.items():
            g = grads.get(n)
            g = torch.zeros_like(p) if g is None else clipped(g.float())
            taken[n] = g
            m = self.m[n].mul_(B1).add_((1 - B1) * g)
            v = self.v[n].mul_(B2).add_((1 - B2) * g * g)
            u = m / (torch.sqrt(v) + EPS)
            if self.wd > 0 and decays(n):
                u = u + self.wd * p
            p.add_(-lr * u)
        self.done += 1
        return taken
