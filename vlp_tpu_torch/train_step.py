"""One training step on PyTorch (counterpart of
``vlp_tpu/parallel/train_step.py``): forward + backward + BertAdam, on one
device, with optional gradient accumulation over micro-batches; and K
steps as one CUDA graph (:func:`make_multi_step`, the device loop of
``--device_loop_steps``).

PyTorch runs eagerly, so where the JAX package returns a new train state,
the step here updates the model's parameters and the optimizer's moments in
place.  The dropout of a step follows from one 64-bit seed
(:func:`step_seed` of the run seed, epoch and step), so a resumed run takes
the same draws as an uninterrupted one.

With a :class:`~vlp_tpu_torch.optim.DynamicLossScale` (``--true_fp16``)
the step scales the loss before the backward, unscales the fp32 gradients
once (after the last micro-batch), and on a non-finite gradient skips the
update of the parameters, BertAdam's moments and its schedule step and
halves the scale, as JAX ``_apply_grads`` does; the decision stays on the
device.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vlp_tpu_torch import tracing
from vlp_tpu_torch.config import VLPConfig
from vlp_tpu_torch.models.model import DropoutRNG, VLPModel
from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops.philox import as_int64, step_seed
from vlp_tpu_torch.optim import BertAdam, DynamicLossScale
from vlp_tpu_torch.parallel.dist import Dist


def dummy_batch(cfg: VLPConfig, batch_size: int, device="cpu",
                task: str = "img2txt") -> Dict[str, torch.Tensor]:
    """An all-zero batch of the training shapes; ``task="vqa2"`` adds the
    answer scores ``ans_scores`` [B, num_answers]."""
    B, L, nv = batch_size, cfg.seq_len, cfg.len_vis_input

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    b = dict(
        input_ids=z(B, L), segment_ids=z(B, L),
        mode=torch.ones((B,), dtype=torch.int32, device=device),
        text_end=torch.full((B,), cfg.prefix_len + 5, dtype=torch.int32,
                            device=device),
        vis_keep=torch.ones((B, nv), device=device),
        vis_masked_pos=torch.ones((B, max(nv // 4, 1)), dtype=torch.int32,
                                  device=device),
        masked_pos=z(B, cfg.max_pred), masked_ids=z(B, cfg.max_pred),
        masked_weights=z(B, cfg.max_pred, dtype=torch.float32),
        task_idx=torch.full((B,), 3, dtype=torch.int32, device=device),
        vis_feats=z(B, nv, cfg.vis_feat_dim, dtype=torch.float32),
        vis_pe=z(B, nv, cfg.vis_pe_dim, dtype=torch.float32),
    )
    if task == "vqa2":
        b["ans_scores"] = z(B, cfg.num_answers, dtype=torch.float32)
    return b


def loss_fn(model: VLPModel, batch, seed, *, drop_worst_ratio: float,
            mask_image_regions: bool, task: str = "img2txt"):
    """(loss, metrics) of one training forward whose dropout follows from
    ``seed`` (an int, or the forward's own :class:`DropoutRNG`; under
    tensor parallelism its attention seeds fold the model's
    ``tp_fold``)."""
    drop = (seed if isinstance(seed, DropoutRNG)
            else DropoutRNG(seed, batch["input_ids"].device,
                            attn_fold=model.tp_fold))
    out = model.pretrain_losses(batch, drop=drop,
                                drop_worst_ratio=drop_worst_ratio,
                                mask_image_regions=mask_image_regions,
                                task=task)
    return out["loss"], out


def micro_seeds(seed: int, grad_accum: int) -> List[int]:
    """The dropout seed of each micro-batch of a step: the step's own
    without accumulation, ``step_seed(seed, i)`` for micro-batch i."""
    if grad_accum <= 1:
        return [seed]
    return [step_seed(seed, i) for i in range(grad_accum)]


def grads_with_accum(model: VLPModel, batch, seed, *,
                     drop_worst_ratio: float, mask_image_regions: bool,
                     task: str = "img2txt", grad_accum: int = 1,
                     scale: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """Leave the step's gradients in the parameters' ``.grad``: averaged
    over ``grad_accum`` micro-batches (the batch's leading dim is
    ``grad_accum * micro_batch``), with drop-worst per micro-batch, as the
    reference normalises loss / accum (run_img2txt_dist.py:566-575).
    ``seed`` is the step's seed (:func:`micro_seeds` gives each
    micro-batch's), or one :class:`DropoutRNG` per micro-batch.
    ``scale`` (a loss scale) multiplies each loss before its backward, so
    the gradients left are scaled; the metrics are not.  Returns the
    metrics, averaged over the micro-batches (detached).

    A gradient buffer, once made, is zeroed and reused, not dropped: a
    captured step (:func:`make_multi_step`) accumulates into the same
    tensors at every replay.  Each micro-batch's forward is the span
    ``step.forward``, its backward ``step.backward``."""
    for p in model.parameters():
        if p.grad is not None:
            p.grad.zero_()
    drops = (list(seed) if isinstance(seed, (list, tuple))
             else micro_seeds(seed, grad_accum))

    def forward(micro, drop):
        with tracing.span("step.forward"):
            return loss_fn(model, micro, drop,
                           drop_worst_ratio=drop_worst_ratio,
                           mask_image_regions=mask_image_regions,
                           task=task)[1]

    def backward(loss):
        with tracing.span("step.backward"):
            (loss if scale is None else loss * scale).backward()

    if grad_accum <= 1:
        metrics = forward(batch, drops[0])
        backward(metrics["loss"])
        return {k: v.detach() for k, v in metrics.items()}
    B = batch["input_ids"].shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} does not split into {grad_accum} "
                         "micro-batches")
    mb = B // grad_accum
    sums: Dict[str, torch.Tensor] = {}
    for i in range(grad_accum):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        metrics = forward(micro, drops[i])
        backward(metrics["loss"])
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + v.detach()
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(grad_accum)
    return {k: v / grad_accum for k, v in sums.items()}


def attach_loss_scale(optimizer: BertAdam,
                      loss_scale: Optional[DynamicLossScale]) -> None:
    """Put ``loss_scale.init()`` on the optimizer, on its parameters'
    device: the one place a run's scale state is made (the step builders
    call it; a resume then restores the saved state over it)."""
    if loss_scale is not None and optimizer.loss_scale is None:
        dev = next(iter(optimizer.params.values())).device
        optimizer.loss_scale = loss_scale.init(dev)


def loss_scale_of(optimizer: BertAdam,
                  loss_scale: Optional[DynamicLossScale]
                  ) -> Optional[torch.Tensor]:
    """The scale this step multiplies its loss by (None without loss
    scaling)."""
    return None if loss_scale is None else optimizer.loss_scale["scale"]


def apply_grads(optimizer: BertAdam, loss_scale: Optional[DynamicLossScale],
                metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The optimizer step on the gradients in ``.grad`` (JAX
    ``_apply_grads``).  With ``loss_scale``: unscale them, step only if
    every one is finite (``BertAdam.step(finite=...)``), update the scale
    on the optimizer, and add ``loss_scale`` (the new scale) and
    ``skipped_step`` (1.0 on an overflow) to the metrics."""
    if loss_scale is None:
        optimizer.step()
        return metrics
    state = optimizer.loss_scale
    grads = {n: p.grad for n, p in optimizer.params.items()
             if p.grad is not None}
    # in place (the parameters, so their gradients, are fp32): a captured
    # step's .grad keeps the buffer its replays write
    _, finite = loss_scale.unscale_and_check(grads, state)
    optimizer.step(finite=finite)
    # in place: a captured step writes the state its next replay reads
    for k, v in loss_scale.update(state, finite).items():
        if v is not state[k]:
            state[k].copy_(v)
    return dict(metrics, loss_scale=state["scale"].clone(),
                skipped_step=1.0 - finite.float())


def make_train_step(model: VLPModel, optimizer: BertAdam, *,
                    mask_image_regions: bool = False, task: str = "img2txt",
                    grad_accum: int = 1,
                    loss_scale: Optional[DynamicLossScale] = None,
                    dist: Optional[Dist] = None) -> Callable:
    """Returns ``train_step(batch, seed, drop_worst_ratio) -> metrics``,
    which updates ``model`` and ``optimizer`` in place; ``seed`` is the
    step's seed or one :class:`DropoutRNG` per micro-batch
    (:func:`grads_with_accum`).  ``loss_scale`` switches on the
    loss-scaled update (:func:`apply_grads`).  ``dist`` (a data-parallel
    group, ``parallel.dp_step``) folds an int seed per rank
    (``Dist.rank_seed``) and averages the gradients and the metrics over
    its ranks between the backward and the update, after checking that
    the ranks agree on which parameters have a gradient."""
    return _train_step(model, optimizer, dist or Dist(), check=True,
                       mask_image_regions=mask_image_regions, task=task,
                       grad_accum=grad_accum, loss_scale=loss_scale)


def _train_step(model, optimizer, dist: Dist, *, check: bool,
                mask_image_regions: bool, task: str, grad_accum: int,
                loss_scale: Optional[DynamicLossScale]) -> Callable:
    """:func:`make_train_step`'s step; ``check=False`` leaves out the
    ranks' agreement check (a host sync), which a captured step makes once
    before its capture."""
    attach_loss_scale(optimizer, loss_scale)

    def train_step(batch, seed, drop_worst_ratio: float = 0.0):
        model.train()
        if not isinstance(seed, (list, tuple)):
            seed = dist.rank_seed(seed)
        metrics = grads_with_accum(model, batch, seed,
                                   drop_worst_ratio=drop_worst_ratio,
                                   mask_image_regions=mask_image_regions,
                                   task=task, grad_accum=grad_accum,
                                   scale=loss_scale_of(optimizer, loss_scale))
        model.align_replicated_grads()
        dist.all_reduce_grads(model.parameters(), check=check)
        metrics = dist.all_reduce_mean(metrics)
        metrics = apply_grads(optimizer, loss_scale, metrics)
        # state a model moves outside autograd after each update (the MoE
        # routers' selection biases, models/kimi_vl.py)
        after_step = getattr(model, "after_step", None)
        if after_step is not None:
            after_step(dist)
        return metrics

    return train_step


# --------------------------------------------------------------------------
# The device loop: K optimizer steps per dispatch (--device_loop_steps)
# --------------------------------------------------------------------------

def make_multi_step(model: VLPModel, optimizer: BertAdam, *, K: int,
                    mask_image_regions: bool = False, task: str = "img2txt",
                    grad_accum: int = 1,
                    loss_scale: Optional[DynamicLossScale] = None,
                    dist: Optional[Dist] = None) -> Callable:
    """Device-loop training (JAX ``make_multi_step``,
    ``vlp_tpu/parallel/train_step.py:221``): returns
    ``multi_step(stacked_batch, seeds, drop_worst_ratio) -> metrics``,
    K optimizer steps over ``stacked_batch`` ({key: [K, B, ...]}), step i
    taking row i and the dropout of ``seeds[i]``, exactly as K calls of
    :func:`make_train_step`'s step would.  The metrics come back stacked,
    {key: [K]}.  ``dist`` (``parallel.dp_step.make_dp_multi_step``) puts
    the data-parallel all-reduce in each step and folds each seed per rank
    (``Dist.rank_seed``).

    On the CPU the K steps run eagerly.  On ``cuda`` they are one CUDA graph
    (:class:`CapturedSteps`), captured at the first call and replayed at
    every later one: the JAX package's ``lax.scan`` over K steps in one
    dispatch."""
    if K < 1:
        raise ValueError(f"the device loop takes K >= 1 steps, got {K}")
    dist = dist or Dist()
    device = next(iter(optimizer.params.values())).device
    captured = device.type == "cuda"
    step = _train_step(model, optimizer, dist, check=not captured,
                       mask_image_regions=mask_image_regions, task=task,
                       grad_accum=grad_accum, loss_scale=loss_scale)
    if captured:
        state = [*model.parameters(), *model.buffers(),
                 *optimizer.m.values(), *optimizer.v.values(),
                 optimizer.step_count]
        if optimizer.loss_scale is not None:
            state += list(optimizer.loss_scale.values())
        return CapturedSteps(
            step, K, grad_accum, model.cfg.num_hidden_layers, device, state,
            seed_of=dist.rank_seed, attn_fold=model.tp_fold,
            before_capture=lambda: dist.check_grad_agreement(
                model.parameters()))

    def multi_step(stacked_batch, seeds: Sequence[int],
                   drop_worst_ratio: float = 0.0):
        _check_group(stacked_batch, seeds, K)
        return stack_metrics([
            step(group_row(stacked_batch, i), seed, drop_worst_ratio)
            for i, seed in enumerate(seeds)])

    return multi_step


def group_row(stacked_batch, i: int) -> Dict[str, torch.Tensor]:
    """Step i's batch of a stacked group: row i of every [K, B, ...]."""
    return {k: v[i] for k, v in stacked_batch.items()}


def stack_metrics(metrics: Sequence[Dict[str, torch.Tensor]]
                  ) -> Dict[str, torch.Tensor]:
    """K steps' metrics as {key: [K]}."""
    return {k: torch.stack([torch.as_tensor(m[k]) for m in metrics])
            for k in metrics[0]}


def _check_group(stacked_batch, seeds, K: int) -> None:
    if len(seeds) != K:
        raise ValueError(f"a group of {K} steps takes {K} seeds, got "
                         f"{len(seeds)}")
    for k, v in stacked_batch.items():
        if v.shape[0] != K:
            raise ValueError(f"stacked {k!r} has {v.shape[0]} rows, not {K}")


@contextlib.contextmanager
def _sync_errors():
    """Raise on any host-device synchronisation (a capture would fail on
    it, less legibly)."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


class CapturedSteps:
    """K training steps as one CUDA graph, replayed once per group: the
    port's counterpart of the JAX device loop's one dispatch.

    What changes between replays lives in device memory that the graph
    reads: the stacked batch (the caller's static [K, B, ...] buffers), the
    attention-dropout seeds (``slots``, [K, micro-batches, layers] int64,
    one copy from a pinned host table per group; K1 and K2 read them, see
    ``ops.attention``) and, for hidden dropout, one ``torch.Generator`` per
    (step, micro-batch), registered with the graph
    (``CUDAGraph.register_generator_state``) and seeded before each replay,
    so a replay's generator draws from its new seed at offset 0, as the
    eager step's fresh generator does.  Each seed comes from
    ``DropoutRNG.plan`` (with the model's tensor-parallel fold,
    ``attn_fold``), so replayed step i draws bit for bit what the eager
    step with the same seed draws.  Parameters, BertAdam's moments
    and step count and the loss scale are updated in place, gradients
    accumulate into buffers the graph zeroes.

    The first call (and a call with another ``drop_worst_ratio`` or other
    batch buffers) captures: one eager warm-up step on a side stream (the
    kernels' ``cudaFuncSetAttribute``, cuBLAS's and NCCL's set-up), under
    ``set_sync_debug_mode("error")`` so that a host sync on the step raises
    there; the training state is restored after it; then ``before_capture``
    (the ranks' agreement check of a data-parallel step) and the capture
    of the K steps.  A failure raises: nothing falls back
    to eager steps.  Launch counts: the warm-up's are dropped, the
    capture's recorded and added at every replay (``_build.recording``).

    The returned metrics are the graph's own output tensors, overwritten by
    the next call: copy them out first (``host_copy.fetch``)."""

    def __init__(self, step: Callable, K: int, grad_accum: int,
                 n_slots: int, device: torch.device,
                 state: List[torch.Tensor], *, seed_of: Callable,
                 before_capture: Callable, attn_fold: Optional[int] = None):
        self.step, self.K, self.device = step, K, device
        self.micro = max(grad_accum, 1)
        self.state, self.seed_of = state, seed_of
        self.attn_fold = attn_fold
        self.before_capture = before_capture
        self.slots = torch.zeros((K, self.micro, n_slots), dtype=torch.int64,
                                 device=device)
        self._host_slots = torch.zeros(self.slots.shape, dtype=torch.int64,
                                       pin_memory=True)
        self._copied = torch.cuda.Event()
        self.gens = [[torch.Generator(device=device)
                      for _ in range(self.micro)] for _ in range(K)]
        self._hidden = [[0] * self.micro for _ in range(K)]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._key = None
        self.launches: Dict[str, int] = {}
        self.out: Dict[str, torch.Tensor] = {}
        self.captures = self.replays = 0
        self.capture_seconds = 0.0   # warm-ups and captures, host clock

    def _drops(self, i: int) -> List[DropoutRNG]:
        return [DropoutRNG.from_slots(self.slots[i, j], self.gens[i][j])
                for j in range(self.micro)]

    def _plan(self, seeds: Sequence[int]) -> None:
        """The group's seeds into the host table, then one copy into the
        slots; the hidden generators' seeds kept for the replay."""
        self._copied.synchronize()   # the table's previous copy is done
        n_slots = self.slots.shape[-1]
        for i, seed in enumerate(seeds):
            for j, s in enumerate(micro_seeds(self.seed_of(seed),
                                              self.micro)):
                hidden, attn = DropoutRNG.plan(s, n_slots, self.attn_fold)
                self._hidden[i][j] = hidden
                self._host_slots[i, j] = torch.tensor(
                    [as_int64(a) for a in attn], dtype=torch.int64)
        self.slots.copy_(self._host_slots, non_blocking=True)
        self._copied.record()

    def _seed_generators(self, rows) -> None:
        for i in rows:
            for gen, seed in zip(self.gens[i], self._hidden[i]):
                gen.manual_seed(seed)

    def _capture(self, stacked_batch, ratio: float) -> None:
        self.graph, self.out = None, {}
        snapshot = [t.detach().clone() for t in self.state]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), _build.recording(), _sync_errors():
            self._seed_generators([0])
            self.step(group_row(stacked_batch, 0), self._drops(0), ratio)
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            for t, saved in zip(self.state, snapshot):
                t.copy_(saved)
        del snapshot
        self.before_capture()
        graph = torch.cuda.CUDAGraph()
        for row in self.gens:
            for gen in row:
                graph.register_generator_state(gen)
        with _build.recording() as launches, torch.cuda.graph(graph):
            out = stack_metrics([
                self.step(group_row(stacked_batch, i), self._drops(i), ratio)
                for i in range(self.K)])
        self.graph, self.out = graph, out
        self.launches = dict(launches)
        self.captures += 1

    def __call__(self, stacked_batch, seeds: Sequence[int],
                 drop_worst_ratio: float = 0.0) -> Dict[str, torch.Tensor]:
        with tracing.span("loop.replay"):
            return self._call(stacked_batch, seeds, drop_worst_ratio)

    def _call(self, stacked_batch, seeds: Sequence[int],
              drop_worst_ratio: float) -> Dict[str, torch.Tensor]:
        _check_group(stacked_batch, seeds, self.K)
        self._plan(seeds)
        key = (drop_worst_ratio, sorted(
            (k, v.data_ptr(), tuple(v.shape), v.dtype)
            for k, v in stacked_batch.items()))
        if self.graph is None or key != self._key:
            t0 = time.perf_counter()
            with tracing.span("loop.capture"):
                self._capture(stacked_batch, drop_worst_ratio)
            torch.cuda.synchronize(self.device)
            self.capture_seconds += time.perf_counter() - t0
            self._key = key
        self._seed_generators(range(self.K))
        self.graph.replay()
        _build.add_launches(self.launches)
        self.replays += 1
        return self.out


def stack_batches(batches, out, skip=()) -> None:
    """[{k: [B, ...]}] * K into the recycled {k: [K, B, ...]} buffers
    ``out`` (JAX ``stack_batches``, ``vlp_tpu/parallel/train_step.py:256``;
    here always into given buffers: :class:`GroupStaging`'s pinned ones).
    ``skip`` names keys the loader already wrote in place."""
    keys = [k for k in batches[0] if k not in skip]
    if set(keys) != set(out) - set(skip):
        raise ValueError(f"batch keys {sorted(keys)} are not the staging's "
                         f"{sorted(set(out) - set(skip))}")
    for k in keys:
        dst = out[k]
        for j, b in enumerate(batches):
            v = np.asarray(b[k])
            if (len(batches),) + v.shape != dst.shape or v.dtype != dst.dtype:
                raise ValueError(f"batch {k!r} {v.shape} {v.dtype} does not "
                                 f"fit the staging's {dst.shape[1:]} "
                                 f"{dst.dtype}")
            dst[j] = v


_ALIGN = 256   # bytes between the keys of a staging slab
_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float16): torch.float16,
                 np.dtype(np.float32): torch.float32}


class GroupStaging:
    """The K-step loop's batch buffers (JAX ``cli/train.py:349-358``,
    ``:675-700``, and ``loader.stacked_feature_slabs``): ``n_slots`` host
    slabs, pinned on ``cuda``, each one block of memory holding a
    [K, B, ...] array per batch key, and one device block of the same
    layout, whose typed views (``staged``) a captured group reads.

    The loader writes each batch's region features straight into a slab's
    rows (:meth:`feature_slabs`, ``TrainLoader(feature_slabs=...)``),
    :func:`stack_batches` the token keys (:meth:`stack`), and
    :meth:`upload` copies a whole slab to the device in one copy.  Group g
    (counted from the epoch's first batch) uses slab ``g % n_slots``, as
    the loader's rotation puts its batches there.

    ``layout``: {key: (per-example shape, numpy dtype)}.  ``n_slots``
    covers the loader's lead over the group in flight (K pending batches,
    ``prefetch`` queued, the TrainLoader's own, and one in build): the
    margin of ``data.loader.stacked_feature_slabs``, whose file stays a
    line-for-line copy of the JAX package's (a test holds the two counts
    equal).  A slab is refilled only after the copy out of it has
    finished, which the caller ensures by waiting for the previous
    group's metrics before it takes the next group's batches."""

    def __init__(self, layout: Dict[str, Tuple[tuple, np.dtype]], K: int,
                 batch_size: int, device, *, prefetch: int):
        self.K, self.device = K, torch.device(device)
        self.n_slots = max(3, 1 + -(-(K + prefetch + 2) // K))
        offsets, total = {}, 0
        for k, (shape, dtype) in layout.items():
            shape = (K, batch_size) + tuple(shape)
            offsets[k] = (total, shape, np.dtype(dtype))
            total += -(-int(np.prod(shape)) * np.dtype(dtype).itemsize
                       // _ALIGN) * _ALIGN
        pin = self.device.type == "cuda"
        self._host = [torch.empty(total, dtype=torch.uint8, pin_memory=pin)
                      for _ in range(self.n_slots)]
        self._dev = torch.empty(total, dtype=torch.uint8, device=self.device)
        self.host = []
        for buf in self._host:
            raw = buf.numpy()
            self.host.append({
                k: raw[off:off + int(np.prod(shape)) * dt.itemsize]
                .view(dt).reshape(shape)
                for k, (off, shape, dt) in offsets.items()})
        self.staged = {
            k: self._dev[off:off + int(np.prod(shape)) * dt.itemsize]
            .view(_TORCH_DTYPES[dt]).view(shape)
            for k, (off, shape, dt) in offsets.items()}

    def feature_slabs(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """(vis_feats, vis_pe) row views of every slab, in batch order."""
        return [(slab["vis_feats"][k], slab["vis_pe"][k])
                for slab in self.host for k in range(self.K)]

    def stack(self, slot: int, batches) -> None:
        """The group's token keys into slab ``slot``; its features must
        already be there (the loader wrote them)."""
        slab = self.host[slot]
        for j, b in enumerate(batches):
            for k in ("vis_feats", "vis_pe"):
                if (b[k].__array_interface__["data"][0]
                        != slab[k][j].__array_interface__["data"][0]):
                    raise ValueError(f"batch {j} of the group did not write "
                                     f"its {k} into staging slab {slot}")
        stack_batches(batches, slab, skip=("vis_feats", "vis_pe"))

    @property
    def device_block(self) -> torch.Tensor:
        """The device block the staged views share (one uint8 tensor)."""
        return self._dev

    def upload(self, slot: int) -> Dict[str, torch.Tensor]:
        """Copy slab ``slot`` to the device block (asynchronous from pinned
        memory) and return the staged views."""
        with tracing.span("io.upload", self._dev.nbytes):
            self._dev.copy_(self._host[slot], non_blocking=True)
        return self.staged


def staging_layout(builder, example, store
                   ) -> Dict[str, Tuple[tuple, np.dtype]]:
    """A training batch's keys with their per-example shapes and dtypes,
    from ``builder`` (a ``TrainExampleBuilder``) on ``example`` and its
    features in ``store``: what the loader's batches hold."""
    feat, pe = store.get(example.feature_key)
    one = builder(example.tokens, feat, pe, np.random.default_rng(0),
                  ans_scores=getattr(example, "ans_scores", None))
    return {k: (np.shape(v), np.asarray(v).dtype) for k, v in one.items()}
