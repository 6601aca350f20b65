"""BertAdam in PyTorch (counterpart of ``vlp_tpu/optim.py``), bit-faithful
to the reference optimizer (``optimization.py:33-182``):

* each parameter's gradient is clipped to norm 1 on its own, inside the
  step (scale ``1 / (||g|| + 1e-6)`` where ``||g|| > 1``);
* Adam moments without bias correction;
* decoupled weight decay added to the update, masked off for biases and
  LayerNorm parameters (``default_weight_decay_mask``); the fine-tune
  variant decays toward the initial weights, ``wd * (2 p - p_init)``;
* the learning-rate schedule is evaluated from the number of completed
  updates, so the first update uses step 0 (lr 0 under warmup).

State is fp32.  Parameters and moments are dicts keyed by the parameters'
reference names (``model.named_parameters()``); the step updates the
parameters in place.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import torch

# the reference's constants (optimization.py:74-77)
B1, B2, EPS, MAX_GRAD_NORM = 0.9, 0.999, 1e-6, 1.0

# --- schedules (optimization.py:33-55); x = step / t_total, fp32 ----------


def warmup_linear(x: torch.Tensor, warmup: float = 0.002) -> torch.Tensor:
    return torch.where(x < warmup, x / warmup,
                       torch.clamp((x - 1.0) / (warmup - 1.0), min=0.0))


def warmup_constant(x: torch.Tensor, warmup: float = 0.002) -> torch.Tensor:
    return torch.where(x < warmup, x / warmup, torch.ones_like(x))


def warmup_cosine(x: torch.Tensor, warmup: float = 0.002) -> torch.Tensor:
    return torch.where(x < warmup, x / warmup,
                       0.5 * (1.0 + torch.cos(math.pi * x)))


SCHEDULES: Dict[str, Callable] = {
    "warmup_linear": warmup_linear,
    "warmup_constant": warmup_constant,
    "warmup_cosine": warmup_cosine,
}


def default_weight_decay_mask(names: Iterable[str]) -> Dict[str, bool]:
    """Decay everything except biases and LayerNorm scales/biases
    (run_img2txt_dist.py:395): kernels and embedding tables decay."""
    return {n: not (n.endswith("bias") or ".LayerNorm." in n) for n in names}


class BertAdam:
    """The reference BertAdam over ``params`` (name -> parameter):
    ``step()`` applies one update from the parameters' ``.grad`` (averaged
    by the caller; ``None`` counts as zero) and increments ``step_count``.

    ``anchors`` (name -> fp32 tensor) switches on the fine-tune decay
    ``wd * (2 p - anchor)``; see :func:`bert_adam_finetune`."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, *,
                 warmup: float = -1.0, t_total: int = -1,
                 schedule: str = "warmup_linear", weight_decay: float = 0.01,
                 anchors: Optional[Dict[str, torch.Tensor]] = None):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}")
        self.params = dict(params)
        self.lr, self.warmup, self.t_total = lr, warmup, t_total
        self.schedule = SCHEDULES[schedule]
        self.weight_decay = weight_decay
        self.decay = default_weight_decay_mask(self.params)
        self.anchors = anchors
        self.m = {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in self.params.items()}
        self.step_count = 0

    def lr_at(self, step: int) -> torch.Tensor:
        """fp32 learning rate of the update after ``step`` completed ones."""
        if self.t_total > 0 and self.warmup >= 0:
            x = torch.tensor(float(step), dtype=torch.float32) / self.t_total
            return self.lr * self.schedule(x, self.warmup)
        return torch.tensor(self.lr, dtype=torch.float32)

    @staticmethod
    def _clip(g: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(g * g))
        one = torch.ones((), device=g.device)
        return g * torch.where(norm > MAX_GRAD_NORM,
                               MAX_GRAD_NORM / (norm + 1e-6), one)

    @torch.no_grad()
    def step(self) -> None:
        lr_t = None
        for n, p in self.params.items():
            if lr_t is None:
                lr_t = self.lr_at(self.step_count).to(p.device)
            # a parameter the loss does not reach (the pooler without the
            # pretext loss) has a zero gradient, as in JAX: its moments
            # decay and weight decay still applies
            g = (torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                 else self._clip(p.grad.float()))
            m = B1 * self.m[n] + (1 - B1) * g
            v = B2 * self.v[n] + (1 - B2) * g * g
            self.m[n], self.v[n] = m, v
            u = m / (torch.sqrt(v) + EPS)
            if self.weight_decay > 0:
                wd = self.weight_decay if self.decay[n] else 0.0
                p32 = p.float()
                u = u + wd * (p32 if self.anchors is None
                              else 2.0 * p32 - self.anchors[n])
            p.add_((-lr_t * u).to(p.dtype))
        self.step_count += 1

    def state_dict(self) -> dict:
        return {"step": self.step_count, "m": dict(self.m),
                "v": dict(self.v)}

    def load_state_dict(self, state: dict) -> None:
        """Restore (m, v, step); the saved moments must cover exactly this
        optimizer's parameters, with the same shapes."""
        for key in ("m", "v"):
            saved = state[key]
            if set(saved) != set(self.params):
                raise ValueError(
                    f"optimizer state {key!r} does not match the parameters:"
                    f" missing {sorted(set(self.params) - set(saved))[:3]},"
                    f" extra {sorted(set(saved) - set(self.params))[:3]}")
            for n, t in saved.items():
                if t.shape != self.params[n].shape:
                    raise ValueError(f"optimizer state {key}[{n}]: shape "
                                     f"{tuple(t.shape)} != "
                                     f"{tuple(self.params[n].shape)}")
            getattr(self, key).update(
                {n: t.to(device=self.params[n].device, dtype=torch.float32)
                 for n, t in saved.items()})
        self.step_count = int(state["step"])


def bert_adam_finetune(params: Dict[str, torch.Tensor], lr: float, *,
                       init_params: Dict[str, torch.Tensor],
                       missing_key_substrings=(), **kw) -> BertAdam:
    """Fine-tune-anchored BertAdam (reference BertAdamFineTune,
    optimization.py:185-283): decay toward ``init_params``; parameters
    whose name contains any of ``missing_key_substrings`` (freshly
    initialised heads) decay toward zero."""
    anchors = {}
    for n, p in params.items():
        a = init_params[n].detach().to(device=p.device, dtype=torch.float32)
        if any(s in n for s in missing_key_substrings):
            a = torch.zeros_like(a)
        anchors[n] = a.clone()
    return BertAdam(params, lr, anchors=anchors, **kw)
