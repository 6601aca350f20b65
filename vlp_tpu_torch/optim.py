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

Under tensor parallelism (``clip_group``, ``clip_sharded``) a sharded
parameter's clip takes the norm of the whole parameter: the squared norms
of this rank's shards are stacked and sum-all-reduced over the
tensor-parallel group, once per step (JAX ``default_tp_clip_mask`` and
``_make_clip``, ``vlp_tpu/optim.py:71-105``).  Everything else in the
update is elementwise, so it needs no collective.

State is fp32.  Parameters and moments are dicts keyed by the parameters'
reference names (``model.named_parameters()``); the step updates the
parameters, the moments and its step count (a device tensor) in place, so
a captured CUDA graph of training steps (``train_step.make_multi_step``)
reads and writes the same tensors at every replay.

``DynamicLossScale`` is the fp16 loss scaling of ``--true_fp16`` (the
reference's apex ``FP16_Optimizer``, optimization_fp16.py:7-80; JAX
``optim.DynamicLossScale``).  Its state, ``{"scale", "good_steps"}`` as
device tensors, rides on the optimizer (``BertAdam.loss_scale``) and in
its ``state_dict``, as apex keeps it in the optimizer's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as tdist

from vlp_tpu_torch import tracing

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
    by the caller; ``None`` counts as zero) and increments ``step_count``,
    a 0-d int64 tensor on the parameters' device.

    ``anchors`` (name -> fp32 tensor) switches on the fine-tune decay
    ``wd * (2 p - anchor)``; see :func:`bert_adam_finetune`.

    ``loss_scale`` holds a :class:`DynamicLossScale` state when the run
    scales its loss (None otherwise); ``state_dict`` carries it.

    ``clip_sharded`` names the parameters that are shards of a
    tensor-parallel group ``clip_group``: their clip norms are summed over
    the group (module docstring)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, *,
                 warmup: float = -1.0, t_total: int = -1,
                 schedule: str = "warmup_linear", weight_decay: float = 0.01,
                 anchors: Optional[Dict[str, torch.Tensor]] = None,
                 clip_group=None, clip_sharded: Iterable[str] = ()):
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
        dev = next(iter(self.params.values())).device
        self.step_count = torch.zeros((), dtype=torch.int64, device=dev)
        self.loss_scale: Optional[Dict[str, torch.Tensor]] = None
        self.clip_group = clip_group
        self.clip_sharded = [n for n in self.params if n in set(clip_sharded)]

    def lr_at(self, step) -> torch.Tensor:
        """fp32 learning rate of the update after ``step`` completed ones
        (an int, or an integer tensor, which gives a tensor on its
        device)."""
        step = torch.as_tensor(step)
        if self.t_total > 0 and self.warmup >= 0:
            x = step.to(torch.float32) / self.t_total
            return self.lr * self.schedule(x, self.warmup)
        return torch.full((), self.lr, dtype=torch.float32,
                          device=step.device)

    @staticmethod
    def _clip(g: torch.Tensor,
              sumsq: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``g`` clipped to norm MAX_GRAD_NORM, the norm taken from
        ``sumsq`` (the whole parameter's squared norm) where given."""
        norm = torch.sqrt(torch.sum(g * g) if sumsq is None else sumsq)
        one = torch.ones((), device=g.device)
        return g * torch.where(norm > MAX_GRAD_NORM,
                               MAX_GRAD_NORM / (norm + 1e-6), one)

    @torch.no_grad()
    def step(self, finite: Optional[torch.Tensor] = None) -> None:
        """One update.  ``finite`` (a 0-d bool tensor on the parameters'
        device: the loss scaler's verdict on this step's gradients) makes
        the update conditional on the device, with no sync: where it is
        False the parameters, both moments and the schedule's step count
        stay as they were (JAX ``_apply_grads`` keeps ``opt_state``
        whole).  Nothing here reads a device value on the host.  The
        update is the span ``optim.step`` (n: the parameter tensors)."""
        with tracing.span("optim.step", len(self.params)):
            self._update(finite)

    def _update(self, finite: Optional[torch.Tensor]) -> None:
        lr_t = self.lr_at(self.step_count)
        sumsq = self._sharded_sumsq()
        for n, p in self.params.items():
            # a parameter the loss does not reach (the pooler without the
            # pretext loss) has a zero gradient, as in JAX: its moments
            # decay and weight decay still applies
            g = (torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                 else self._clip(p.grad.float(), sumsq.get(n)))
            # the moments in place, in the order of the reference's
            # out-of-place update (the same bits)
            m_old, v_old = self.m[n], self.v[n]
            if finite is None:
                m = m_old.mul_(B1).add_((1 - B1) * g)
                v = v_old.mul_(B2).add_((1 - B2) * g * g)
            else:
                m = B1 * m_old + (1 - B1) * g
                v = B2 * v_old + (1 - B2) * g * g
            u = m / (torch.sqrt(v) + EPS)
            if self.weight_decay > 0:
                wd = self.weight_decay if self.decay[n] else 0.0
                p32 = p.float()
                u = u + wd * (p32 if self.anchors is None
                              else 2.0 * p32 - self.anchors[n])
            upd = -lr_t * u
            if finite is not None:
                m_old.copy_(torch.where(finite, m, m_old))
                v_old.copy_(torch.where(finite, v, v_old))
                upd = torch.where(finite, upd, torch.zeros_like(upd))
            p.add_(upd.to(p.dtype))
        self.step_count.add_(1 if finite is None
                             else finite.to(torch.int64))

    def _sharded_sumsq(self) -> Dict[str, torch.Tensor]:
        """{name: the whole parameter's squared gradient norm} of the
        sharded parameters: one sum all-reduce over ``clip_group`` of their
        stacked local squared norms ({} without tensor parallelism)."""
        if self.clip_group is None or not self.clip_sharded:
            return {}
        local = []
        for n in self.clip_sharded:
            g = self.params[n].grad
            local.append(torch.zeros((), device=self.step_count.device)
                         if g is None else torch.sum(g.float() * g.float()))
        sq = torch.stack(local)
        tdist.all_reduce(sq, group=self.clip_group)
        return dict(zip(self.clip_sharded, sq.unbind()))

    def state_dict(self) -> dict:
        """``{"step", "m", "v"}``, plus ``"loss_scale"`` (``{"scale",
        "good_steps"}`` as Python numbers) when the run scales its loss."""
        out = {"step": int(self.step_count),
               "m": {n: t.clone() for n, t in self.m.items()},
               "v": {n: t.clone() for n, t in self.v.items()}}
        if self.loss_scale is not None:
            out["loss_scale"] = {
                "scale": float(self.loss_scale["scale"]),
                "good_steps": int(self.loss_scale["good_steps"])}
        return out

    def load_state_dict(self, state: dict) -> None:
        """Restore (m, v, step) and, when this optimizer scales its loss
        and the state has one, the loss scale; the saved moments must
        cover exactly this optimizer's parameters, with the same
        shapes."""
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
            mine = getattr(self, key)
            for n, t in saved.items():
                mine[n].copy_(t)
        self.step_count.fill_(int(state["step"]))
        if self.loss_scale is not None and "loss_scale" in state:
            saved = state["loss_scale"]
            self.loss_scale["scale"].fill_(float(saved["scale"]))
            self.loss_scale["good_steps"].fill_(int(saved["good_steps"]))


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


class DynamicLossScale:
    """fp16 dynamic loss scaling (JAX ``optim.DynamicLossScale``; the
    reference ``FP16_Optimizer_State``, optimization_fp16.py:7-80): scale
    the loss, unscale the gradients, skip the update on non-finite
    gradients and halve the scale; double it after ``growth_interval``
    good steps in a row.

    ``static=True`` freezes the scale at ``init_scale`` (apex
    ``static_loss_scale``, run_img2txt_dist.py:419-420): an overflow still
    skips the update, but the scale never halves or grows.  Every decision
    is a device tensor: nothing here syncs with the host.  The skip itself
    is ``BertAdam.step(finite=...)`` (JAX's ``apply_or_skip`` and the
    ``opt_state`` select of ``_apply_grads``)."""

    def __init__(self, init_scale: float = 2.0 ** 15,
                 growth_interval: int = 2000, factor: float = 2.0,
                 static: bool = False):
        self.init_scale = init_scale
        self.growth_interval = growth_interval
        self.factor = factor
        self.static = static

    def init(self, device="cpu") -> Dict[str, torch.Tensor]:
        return {"scale": torch.tensor(self.init_scale, dtype=torch.float32,
                                      device=device),
                "good_steps": torch.tensor(0, dtype=torch.int32,
                                           device=device)}

    def scale_loss(self, loss: torch.Tensor,
                   state: Dict[str, torch.Tensor]) -> torch.Tensor:
        return loss * state["scale"]

    def unscale_and_check(self, grads: Dict[str, torch.Tensor],
                          state: Dict[str, torch.Tensor]
                          ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(fp32 gradients times 1 / scale, whether every element of every
        one is finite: a 0-d bool tensor).  An fp32 gradient is unscaled in
        place, so a parameter's ``.grad`` keeps its buffer (a captured step
        writes the same memory at every replay); another dtype is cast to
        a new fp32 tensor first."""
        inv = 1.0 / state["scale"]
        grads = {n: g.float().mul_(inv) for n, g in grads.items()}
        finite = torch.stack([torch.isfinite(g).all()
                              for g in grads.values()]).all()
        return grads, finite

    def update(self, state: Dict[str, torch.Tensor],
               finite: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.static:
            return state
        scale = torch.where(finite, state["scale"],
                            state["scale"] / self.factor)
        good = torch.where(finite, state["good_steps"] + 1,
                           torch.zeros_like(state["good_steps"]))
        grow = good >= self.growth_interval
        scale = torch.where(grow, scale * self.factor, scale)
        good = torch.where(grow, torch.zeros_like(good), good)
        return {"scale": scale, "good_steps": good}
