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

On a CUDA device the update is the hand-written multi-tensor kernel of
``csrc/bert_adam.cu`` (:class:`FusedPlan`, two launches for every
parameter); ``_update``, its plain version, takes CPU tensors.

``DynamicLossScale`` is the fp16 loss scaling of ``--true_fp16`` (the
reference's apex ``FP16_Optimizer``, optimization_fp16.py:7-80; JAX
``optim.DynamicLossScale``).  Its state, ``{"scale", "good_steps"}`` as
device tensors, rides on the optimizer (``BertAdam.loss_scale``) and in
its ``state_dict``, as apex keeps it in the optimizer's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as tdist

from vlp_tpu_torch import tracing

# the reference's constants (optimization.py:74-77), and the clip's epsilon
B1, B2, EPS, MAX_GRAD_NORM = 0.9, 0.999, 1e-6, 1.0
CLIP_EPS = 1e-6

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
        # the kernel's plan and scratch, made once (on the card only)
        self.plan = FusedPlan(self) if dev.type == "cuda" else None

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
                               MAX_GRAD_NORM / (norm + CLIP_EPS), one)

    @torch.no_grad()
    def step(self, finite: Optional[torch.Tensor] = None) -> None:
        """One update.  ``finite`` (a 0-d bool tensor on the parameters'
        device: the loss scaler's verdict on this step's gradients) makes
        the update conditional on the device, with no sync: where it is
        False the parameters, both moments and the schedule's step count
        stay as they were (JAX ``_apply_grads`` keeps ``opt_state``
        whole).  Nothing here reads a device value on the host.  The
        update is the span ``optim.step`` (n: the parameter tensors).

        CUDA parameters take the kernel (:meth:`_fused`), CPU ones the
        plain version (:meth:`_update`)."""
        with tracing.span("optim.step", len(self.params)):
            if self.plan is None:
                self._update(finite)
            else:
                self._fused(finite)

    def _fused(self, finite: Optional[torch.Tensor]) -> None:
        """:meth:`_update` as ``csrc/bert_adam.cu``'s two launches, with
        the schedule's few scalar ops in PyTorch between the table's
        refresh and the norms, and the tensor-parallel sum of the sharded
        squared norms between the norms and the update."""
        plan = self.plan
        plan.refresh()
        lr_t = self.lr_at(self.step_count)
        plan.norms()
        if self.clip_group is not None and plan.n_sharded:
            tdist.all_reduce(plan.sumsq[:plan.n_sharded],
                             group=self.clip_group)
        plan.update(lr_t, finite, self.step_count, self.weight_decay)

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


# --- the fused update's host side (csrc/bert_adam.cu) -----------------------

CHUNK = 16384   # elements of a chunk (a multiple of 4: 16-byte vectors)
# the tensor table's int64 columns (csrc/bert_adam.cu TensorRow); a null
# gradient or anchor is 0
TABLE_COLUMNS = ("p", "grad", "m", "v", "anchor", "chunk_begin", "numel",
                 "decay")
_POINTERS = 5   # the leading columns that hold pointers


def _capturing(device: torch.device) -> bool:
    """Whether ``device``'s current stream is capturing a CUDA graph."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class FusedPlan:
    """The host side of the fused update of one :class:`BertAdam`: its
    tables and scratch, allocated here, once.

    * ``names``: the parameters in table order, the ``clip_sharded`` ones
      first, so that their squared norms are the leading slice
      ``sumsq[:n_sharded]``, which the step sum-all-reduces;
    * the chunks: ``chunk`` elements each but a tensor's last, so that
      every element of every parameter lies in exactly one;
      ``host_chunks`` (int64 [n_chunks, 3], (tensor, start, length), on
      the host: ``tensor_chunks``) lists them, ``owner`` (int32
      [n_chunks], on the device) maps each to its tensor;
    * ``host`` and ``table``: int64 [n_tensors, 8] (``TABLE_COLUMNS``),
      pinned on the host and on the device.  :meth:`refresh` rewrites the
      pointers of the rows whose tensors moved (a new ``.grad``) and copies
      the table to the device once: the span ``optim.table`` (n: the rows
      rewritten);
    * scratch: ``partials`` (fp64 [n_chunks]), ``tickets`` (int32
      [n_tensors], zero between launches), ``sumsq`` (fp32 [n_tensors]).

    It holds the optimizer's dicts (parameters, moments, anchors), not the
    optimizer: no reference cycle keeps either alive.

    Nothing here launches a kernel but :meth:`norms` and :meth:`update`; on
    the CPU the tables stay there (the tests build plans on the CPU)."""

    def __init__(self, opt: "BertAdam", chunk: int = CHUNK):
        if chunk <= 0 or chunk % 4:
            raise ValueError(f"a chunk is a positive multiple of 4 elements,"
                             f" got {chunk}")
        self.chunk = chunk
        self._params, self._m, self._v = opt.params, opt.m, opt.v
        self._anchors = opt.anchors
        sharded = set(opt.clip_sharded)
        self.names = opt.clip_sharded + [n for n in opt.params
                                         if n not in sharded]
        self.n_sharded = len(opt.clip_sharded)
        self.device = next(iter(opt.params.values())).device
        for n in self.names:
            self._check(n)
        n_t = len(self.names)
        rows, chunks = [], []
        for t, n in enumerate(self.names):
            numel = opt.params[n].numel()
            begin = len(chunks)
            chunks += [(t, s, min(chunk, numel - s))
                       for s in range(0, numel, chunk)]
            rows.append([0] * _POINTERS
                        + [begin, numel, int(opt.decay[n])])
        cuda = self.device.type == "cuda"
        self.host = torch.tensor(rows, dtype=torch.int64).pin_memory() \
            if cuda else torch.tensor(rows, dtype=torch.int64)
        self.table = torch.empty_like(self.host, device=self.device)
        self.host_chunks = torch.tensor(chunks, dtype=torch.int64).reshape(
            -1, 3)
        self.owner = self.host_chunks[:, 0].to(torch.int32).to(self.device)
        self.n_chunks = len(chunks)
        self.partials = torch.zeros(self.n_chunks, dtype=torch.float64,
                                    device=self.device)
        self.tickets = torch.zeros(n_t, dtype=torch.int32,
                                   device=self.device)
        self.sumsq = torch.zeros(n_t, dtype=torch.float32,
                                 device=self.device)
        self._keys: List[Optional[tuple]] = [None] * n_t
        self._copied = torch.cuda.Event() if cuda else None
        self._blocks: Optional[int] = None

    def tensor_chunks(self, t: int) -> torch.Tensor:
        """The chunks of tensor ``t`` (table order), from the host copy."""
        begin, numel = self.host[t, 5:7].tolist()
        return self.host_chunks[begin:begin + -(-numel // self.chunk)]

    def _check(self, n: str) -> None:
        """Raise unless parameter ``n``, its gradient (if any), moments and
        anchor are contiguous fp32 tensors of its shape on the plan's
        device: what the kernel takes."""
        p = self._params[n]
        parts = [("parameter", p), ("gradient", p.grad), ("m", self._m[n]),
                 ("v", self._v[n])]
        if self._anchors is not None:
            parts.append(("anchor", self._anchors[n]))
        for what, x in parts:
            if x is None:
                continue
            if (x.dtype != torch.float32 or not x.is_contiguous()
                    or x.device != self.device or x.shape != p.shape):
                raise ValueError(
                    f"BertAdam's fused update takes contiguous fp32 tensors "
                    f"on {self.device}: the {what} of {n!r} is "
                    f"{x.dtype} {tuple(x.shape)} on {x.device}"
                    f"{'' if x.is_contiguous() else ', not contiguous'}")

    def refresh(self) -> int:
        """Bring the table's pointers up to date: returns the rows
        rewritten (0 when no tensor moved, as in every step that zeroes and
        reuses its gradients).  A rewrite inside a CUDA-graph capture
        raises: the graph would keep the table it was captured with."""
        params, m, v, anchors = self._params, self._m, self._v, self._anchors
        changed = []
        for t, n in enumerate(self.names):
            p = params[n]
            g = p.grad
            key = (p.data_ptr(), 0 if g is None else g.data_ptr(),
                   m[n].data_ptr(), v[n].data_ptr(),
                   0 if anchors is None else anchors[n].data_ptr())
            if key != self._keys[t]:
                changed.append((t, n, key))
        if not changed:
            return 0
        if _capturing(self.device):
            raise RuntimeError(
                f"BertAdam: {len(changed)} parameter tensors (first "
                f"{changed[0][1]!r}) moved during a CUDA-graph capture; a "
                f"captured step must reuse the buffers of its warm-up")
        with tracing.span("optim.table", len(changed)):
            for _, n, _ in changed:
                self._check(n)
            if self._copied is not None:
                self._copied.synchronize()   # the last copy has read host
            for t, _, key in changed:
                self.host[t, :_POINTERS] = torch.tensor(key,
                                                        dtype=torch.int64)
                self._keys[t] = key
            self.table.copy_(self.host, non_blocking=True)
            if self._copied is not None:
                self._copied.record()
                if self._blocks is None:   # outside any capture, once
                    self._blocks = self._update_blocks()
        return len(changed)

    @staticmethod
    def _update_blocks() -> int:
        """The update's persistent grid on the current device."""
        from vlp_tpu_torch.ops import _build
        blocks = _build.library().vlp_bert_adam_blocks()
        if blocks <= 0:
            _build.check(-blocks, "bert_adam_update")
        return blocks

    def norms(self) -> None:
        """Pass 1: each tensor's squared gradient norm into ``sumsq``."""
        from vlp_tpu_torch.ops import _build
        err = _build.library().vlp_bert_adam_norms(
            self.table.data_ptr(), self.owner.data_ptr(), self.n_chunks,
            self.chunk, self.partials.data_ptr(), self.tickets.data_ptr(),
            self.sumsq.data_ptr(), _build.stream_ptr(self.device))
        _build.check(err, "bert_adam_norms")
        _build.count_launch("bert_adam_norms")

    def update(self, lr_t: torch.Tensor, finite: Optional[torch.Tensor],
               step_count: torch.Tensor, weight_decay: float) -> None:
        """Pass 2: the update of every parameter and its moments from
        ``sumsq``, at the fp32 learning rate ``lr_t``, and ``step_count``
        advanced; where ``finite`` (a bool) is False, nothing changes."""
        from vlp_tpu_torch.ops import _build
        for what, x, dtype in (("lr", lr_t, torch.float32),
                               ("finite", finite, torch.bool),
                               ("step_count", step_count, torch.int64)):
            if x is not None and (x.dtype != dtype or x.numel() != 1
                                  or x.device != self.device):
                raise ValueError(f"BertAdam's fused update takes {what} as "
                                 f"one {dtype} on {self.device}, got "
                                 f"{x.dtype} {tuple(x.shape)} on {x.device}")
        err = _build.library().vlp_bert_adam_update(
            self.table.data_ptr(), self.owner.data_ptr(), self.n_chunks,
            self.chunk, self.sumsq.data_ptr(), lr_t.data_ptr(),
            None if finite is None else finite.data_ptr(),
            step_count.data_ptr(), B1, 1 - B1, B2, 1 - B2, EPS,
            MAX_GRAD_NORM, CLIP_EPS, weight_decay, int(weight_decay > 0),
            self._blocks, _build.stream_ptr(self.device))
        _build.check(err, "bert_adam_update")
        _build.count_launch("bert_adam_update")


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
