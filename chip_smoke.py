"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels
from ``vlp_tpu_torch/csrc``, holds each against its plain PyTorch version at
the shapes of its main path (caption decoding, training, SCST and the
``[B, H, L, D]`` attention op, whose kernels must also equal the
``[B, L, H, D]`` ones bit for bit), checks the card against the CPU end to
end (fp32 beam traces; fp32 train-step losses with attention dropout on; the
fp32 SCST loss and gradients with attention dropout on; fp32 VQA answer
logits and fine-tune losses) and the SCST replay against its sampled rollout
on the card, then drives the user's entry points at bert-base width with
random weights from a seed -- ``vlp_tpu_torch.cli.decode`` (beam 5 and
greedy, B=100), ``vlp_tpu_torch.cli.train`` (the COCO fine-tune flags on
synthetic data, B=64, 2 epochs of 20 steps), ``vlp_tpu_torch.cli.train
--scst`` (B=64, 8 steps), ``vlp_tpu_torch.cli.train --tasks vqa2`` (bi
mode, B=64, 12 steps), ``vlp_tpu_torch.cli.eval_vqa2`` (B=256, 1,024
questions), the ``layout="bhld"`` attention op (bf16 and fp16),
``vlp_tpu_torch.cli.train --true_fp16`` (fp16 K1 dropout + K2, dynamic
loss scaling, B=64, 1 epoch of 20 steps then a resume to epoch 2, and a
skipped step on an overflow), the train CLI at ``--max_len_b 40`` (L=256,
B=64, 8 steps: K1's row-block body and K2's tiled body) and the nine
legacy BERT heads (two layers deep: card vs CPU in fp32, one fp16
forward, a bf16 fine-tune step) -- and checks that each path launched its
kernels.  Phase 2 also holds the fp32 attention bodies
(split TF32) at L=256 and 512 against their plain versions and times them
at B=64 L=128 and B=16 L=256 and 512 beside fp32 SDPA, with the
backward's peak memory; times the decode step (K3 greedy, K4 beam 5, K5
SCST) in bf16 and fp32 at gen_len 0, 9 and 18 beside SDPA over the joint
keys (fp32: in alternating turns with SDPA's parts prebuilt, and the
blocks per SM of the fp32 body); times ``dropout_mask`` beside an
empty launch and a ``zero_`` of its bytes; and holds the fp16 forms of K1
and K2 (``--true_fp16``) against their plain versions at B=64 L=128 (as
the bf16 and fp32 ones) and at L = 103-528 in both layouts, bit for bit
across layouts and against ``dropout_mask``'s keep bits, with a non-finite
dO reaching every gradient, gates K1 (both branches) and K2 past their
one-block bodies at B=64, L = 160, 256 and 528 in both layouts and both
16-bit dtypes, and times every 16-bit form of K1 and K2 beside SDPA in
its dtype and the bound at L = 128, 256 and 528 (plain versions with
PLAIN_REPS calls a round).  Phase 2 ends with the fused BertAdam update
(``csrc/bert_adam.cu``) against the plain one at both benchmark
configurations' parameter sets (bit for bit at the same norms; a skipped
step, a None gradient, anchors, weight decay 0, a captured step; at most
ADAM_MAX_LAUNCHES launch calls a step), timed beside its bound; every
main path then expects one launch of each of its two kernels a step, and
the script fails if ``BertAdam.step`` ran the plain update on CUDA
parameters.  Phase 2 also holds Kimi-VL's expert-row kernels
(``csrc/moe_rows.cu``: gather, SwiGLU, weighted combine and their
backwards) at the Kimi cell's shape against their plain versions with the
rows past the held-row count NaN, twice bit for bit, and the whole expert
layer, every undefined row NaN, against the masked full-buffer passes and
captured against eager, each timed beside its bound; phase 4j counts
their launches.  Phase 6 runs data parallel:
the train, decode and VQA CLIs over NCCL at world size 1, which must equal
the runs without a group bit for bit, and two gloo ranks on the one card
(this script re-run with ``--dp-worker``, DP2_LAYERS deep), which must stay
in sync and, in fp32, equal the single-process step on the global batch.
Phase 7 runs tensor parallelism: K1 (both branches) and K2 at a rank's
heads (H = 6 and 3) against their plain versions in three dtypes, with
``dropout_mask``'s bits under a tp-folded seed and the bf16 times beside
SDPA; then two gloo ranks on the one card (``--tp-worker``): fp32 TP steps
against the single-process step, and ``vlp_tpu_torch.cli.train
--tensor_parallel 2`` (bert-base, 12 layers, B=64, 4 steps, each rank's
group formed by the caller) with exact launch counts at H = 6 and
bit-identical replicated parameters, whose gathered ``model.1.bin``
decodes in a world-1 model; and with two or more GPUs the same CLI over
NCCL, eager and with ``--device_loop_steps 2``.  Phase 7e runs the GSPMD
layout the same way (``--tp_impl gspmd``: vocab-parallel embeddings,
MLM logits and loss, sharded region and answer heads): each fp32 GSPMD
step (4 layers, ``--relax_projection``, label smoothing 0.1, then a VQA
step) against one process's step from the same state, then the CLI with
the same launch and bit checks, a rank's parameter + moment bytes and
peak allocation beside 7c's, and the step's collectives (recorded from
``ops.tp``) replayed and timed.  Phase 4 also holds the decode CLI's
depth-1 pipeline to the same CLI run batch by batch (equal captions) and
runs an upload, ``beam_dispatch`` and a greedy dispatch under
``torch.cuda.set_sync_debug_mode("error")``.  Phase 8 runs the
learnability proof (``vlp_tpu_torch.cli.e2e_synthetic``) at bert-base
width: a partial MLE phase through the device loop, greedy CIDEr, SCST,
and the trained model's beam-5 CIDEr, each above the tool's bar, with
the exact launches of K1 (both branches), K2, K3, K4, K5 and K6.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab-times ROOT   # another checkout's kernels

``--ab-times`` times K1/K2 (bf16 at L = 128, 256 and 528 with K1's
deterministic branch and SDPA with its mask prebuilt; fp32), K1 at the
prefill's and the VQA eval's shapes, the decode step (bf16 and fp32) and
``dropout_mask`` of the checkout at ROOT with phase 2's timing; run it on
two trees in turns (parent, change, change, parent) in one call.

Prints one line per phase, then a JSON line with each kernel's launches,
error against its plain version, times (kernel, plain version, the bound,
one PyTorch library call where one exists: SDPA with its mask built in the
call and prebuilt) and, for the attention kernels, the body the timed
dtype runs, the card's ``nvidia-smi`` name and power limit, and as its
last line ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, when there is no GPU or any phase
fails.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

T0 = time.time()

BF16_TOL = dict(atol=3e-2, rtol=1e-2)   # one bf16 ulp at 2-4 is 1.6e-2
FP16_TOL = dict(atol=4e-3, rtol=2e-3)   # two fp16 ulps at 2-4 (1.95e-3
# each), four relative (2^-11 each): tests/test_torch_kernels.py's
FP32_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = {torch.float32: FP32_TOL, torch.bfloat16: BF16_TOL,
       torch.float16: FP16_TOL}
REPS = 20
PLAIN_REPS = 2             # a plain version's calls per timed round
ROUNDS = 5
SPIN_CYCLES = 20_000_000     # ~10 ms of the card's clock
REPS_STEADY = 5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 and TF32
# FLOP/s on the tensor cores, fp32 FLOP/s on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12
TRAIN_STEPS = (2, 20)        # main-path train CLI: epochs, steps per epoch
LOOP_K = 4                   # phase 4h: --device_loop_steps
LOOP_LOSS_RTOL = 1e-3        # phase 4h against 4b (see the phase)
LOOP_PARAM_ATOL = 1e-3
GROUP_SKIP_LAYERS = 2        # phase 4f's device-loop group: its depth
SCST_STEPS = 8               # main-path SCST CLI: steps of one epoch
SCST_B, SCST_T = 64, 20      # the reference SCST recipe's 16x4 batch, T
VQA_B, VQA_QUESTIONS = 256, 1024   # main-path VQA eval: batch, questions
VQA_STEPS = 12               # main-path VQA fine-tune: steps at B=64
DECODE_GEN_LENS = (0, 9, 18)   # decode steps timed: first, middle, last
# phase 8 (PERF.md: the runs that chose them): B=64 (the SCST recipe's);
# the tool's bert-base learning rates; MLE partial (40 steps) so that SCST
# has room to raise CIDEr
E2E_B, E2E_STEPS, E2E_SCST_STEPS = 64, 40, 40
ADAM_KERNELS = ("bert_adam_norms", "bert_adam_update")


def body(dtype) -> str:
    """The attention kernel body a dtype runs: bf16 the bf16 tensor-core
    one, fp16 the same body instantiated for fp16, fp32 the split-TF32
    one."""
    return {torch.bfloat16: "v2 mma", torch.float16: "v2 mma (fp16)"}.get(
        dtype, "fp32 split-tf32")


def kname(name: str, dtype) -> str:
    """The kernel entry (launch counter) of attention kernel ``name`` in
    ``dtype``: the fp16 forms count apart, under ``name + "_fp16"``."""
    return name + "_fp16" if dtype == torch.float16 else name


def note_err(results, name: str, err: float) -> None:
    """Keep the largest error of kernel ``name`` against its plain version
    over every gate of the script as its ``max_abs_err``."""
    r = results.setdefault(name, {})
    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)


def decode_body(dtype) -> str:
    """The decode-step body a dtype runs: bf16 the tensor-core one, fp32
    the CUDA-core one over the visible slots (a lane per column)."""
    return "v2 mma" if dtype == torch.bfloat16 else "fp32 v2 cuda-core"


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def adam_launches(steps: int) -> dict:
    """The fused BertAdam's launches over ``steps`` optimizer steps (a
    skipped one included): one of each pass a step."""
    return {k: steps for k in ADAM_KERNELS}


def time_ms(fn, reps=REPS) -> float:
    """Device milliseconds of one call: ``reps`` calls queued back to back
    behind a spin of the card (``torch.cuda._sleep``), so that the host's
    launch latency hides behind it, timed by CUDA events; the median of
    ROUNDS rounds.  A function that synchronises (or launches more than the
    spin can hide) is timed with its host time."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def plain_ms(fn) -> float:
    """``time_ms`` of a plain PyTorch version, PLAIN_REPS calls a round:
    tens to thousands of times a kernel's time, it needs fewer calls."""
    return time_ms(fn, PLAIN_REPS)


def bound(nbytes: float, flops: float,
          flop_rate: float = BF16_FLOP_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the HBM rate and
    the operations over the peak of their type (bf16 on the tensor cores
    unless ``flop_rate`` says otherwise)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def fp32_bound(nbytes: float, flops: float) -> dict:
    """Both least times of fp32 work: fp32 on the CUDA cores (``bound``
    at 67 TFLOP/s, as ``bound_cuda_core_ms``) and split TF32 on the tensor
    cores (three TF32 products per fp32 one at 495 TFLOP/s).  The lower,
    the least time the card could take for fp32-accurate work, is the
    ``bound_ms`` a kernel is judged on."""
    core = bound(nbytes, flops, FP32_FLOP_PER_S)
    tf32 = bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
    best = min(core, tf32, key=lambda b: b["bound_ms"])
    return dict(best, bound_cuda_core_ms=core["bound_ms"],
                bound_tf32_ms=tf32["bound_ms"])


def product_flop(mode, text_end, colkeep, prefix, L, H, D=64) -> int:
    """FLOP of one L x L x D attention product (S = QK^T, P V, ...) over
    the (row, key) entries these inputs leave visible (the structural mask
    and colkeep), summed over the batch and H heads.  A hidden entry's
    probability is an exact 0, so the function needs no work there; a row
    that sees nothing spreads over all L keys and counts L."""
    from vlp_tpu_torch.ops.attention import _mask_bias
    seen = (_mask_bias(mode, text_end, colkeep, prefix, L) == 0).sum(-1)
    return 2 * D * H * int(torch.where(seen == 0, L, seen).sum())


def compare(name, got, want, tol) -> float:
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, **tol)
    log(f"{name}: max_abs_err={err:.3e} tol={tol} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def phase_kernels(dev, results):
    """K1 (deterministic) at the decode prefill's and the VQA eval's shapes,
    K3 and K4 at the decoding path's."""
    from vlp_tpu_torch.config import MODE_BI, MODE_S2S
    from vlp_tpu_torch.ops import attention as attn
    from vlp_tpu_torch.ops import decode_attention as dec

    g = torch.Generator(device=dev).manual_seed(0)
    H, D, P = 12, 64, 102

    # ---- K1: the decode prefill (s2s, text_end = L, colkeep 1), an encode
    # of mixed modes, and the VQA eval's bi-mode encode at B=VQA_B
    def k1_inputs(B, L, dtype, kind):
        qkv = torch.randn(B, L, 3 * H * D, generator=g, device=dev).to(dtype)
        q, k, v = (t.view(B, L, H, D) for t in qkv.split(H * D, dim=-1))
        # int32 metadata, as the model passes it (no cast in the wrapper)
        if kind == "prefill":
            mode = torch.full((B,), MODE_S2S, dtype=torch.int32, device=dev)
            te = torch.full((B,), L, dtype=torch.int32, device=dev)
            ck = torch.ones(B, L, device=dev)
            return q, k, v, mode, te, ck
        if kind == "vqa":
            mode = torch.full((B,), MODE_BI, device=dev)
        else:
            mode = torch.randint(MODE_BI, MODE_S2S + 1, (B,), generator=g,
                                 device=dev)
        te = torch.randint(P + 1, L + 1, (B,), generator=g, device=dev)
        ck = (torch.rand(B, L, generator=g, device=dev) > 0.1).float()
        return q, k, v, mode.int(), te.int(), ck

    def k1_times(args, err):
        """bf16 times of K1, its plain version and SDPA (mask built in the
        call, and prebuilt), and the bound."""
        B, L = args[0].shape[:2]
        mask = sdpa_mask(args[0], *args[3:], P)
        pd = product_flop(*args[3:], P, L, H, D)
        return dict(
            body=body(torch.bfloat16), max_abs_err=err,
            ms=time_ms(lambda: attn.attention(*args, prefix=P)),
            plain_ms=plain_ms(lambda: attn.attention_plain(*args, prefix=P)),
            library_ms=time_ms(lambda: sdpa(*args, P)),
            library_prebuilt_mask_ms=time_ms(lambda: sdpa(*args, P,
                                                          mask=mask)),
            **bound(4 * B * L * H * D * 2 + 8 * B + 4 * B * L, 2 * pd))

    for label, B, L in (("prefill", 100, P + 1), ("encode", 100, 128),
                        ("vqa", VQA_B, 128)):
        errs = []
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            args = k1_inputs(B, L, dtype, label)
            errs.append(compare(
                f"K1 attention_fwd {label} B={B} L={L} {dtype} "
                f"({body(dtype)})",
                attn.attention(*args, prefix=P),
                attn.attention_plain(*args, prefix=P), tol))
        if label == "encode":
            continue
        r = k1_times(args, max(errs))
        log(f"K1 {label} bf16 B={B} L={L} time ({r['body']}): kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms (prebuilt mask "
            f"{r['library_prebuilt_mask_ms']:.4f}), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        if label == "prefill":
            results["attention_fwd"] = r
        else:   # the VQA eval's shape, beside the prefill's
            results["attention_fwd"]["vqa_encode"] = dict(B=B, L=L, **r)

    # ---- K3 (own beam) and K4 (ancestry bias): B = 100, P = 102, G = 24
    cases = (("decode_attention", 1, False), ("decode_attention", 5, False),
             ("decode_attention_anc", 5, True))
    for name, K, anc in cases:
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            errs = []
            # gen_len 23: the step's second new token falls past slot G-1
            for gen_len in DECODE_GEN_LENS + (23,):
                q, k, v, pk, pv, gk, gv = decode_inputs(g, dev, 100, K, dtype)
                bias = (decode_anc_bias(g, dev, 100, K, gen_len) if anc
                        else None)
                gk2, gv2 = gk.clone(), gv.clone()
                got = dec.decode_attention(q, k, v, pk, pv, gk, gv, gen_len,
                                           n_heads=H, beam_bias=bias)
                want = dec.decode_attention_plain(
                    q, k, v, pk, pv, gk2, gv2, gen_len, n_heads=H,
                    beam_bias=bias)
                errs.append(compare(
                    f"{'K4' if anc else 'K3'} {name} B=100 K={K} "
                    f"gen_len={gen_len} {dtype} ({decode_body(dtype)})", got,
                    want, tol))
                if not (torch.equal(gk, gk2) and torch.equal(gv, gv2)):
                    fail(f"{name}: generated-cache writes not bit-exact")
            log(f"{name} K={K} {dtype}: cache writes bit-exact")
            # time at the main path's shape: greedy K3 (K=1), beam K4
            # (K=5); bf16 (the main paths) and fp32 (the fp32 gates' body)
            if anc or K == 1:
                r = decode_times(
                    dec, lambda: decode_inputs(g, dev, 100, K, dtype),
                    (lambda gl: decode_anc_bias(g, dev, 100, K, gl))
                    if anc else None, max(errs), name, dtype=dtype)
                if dtype == torch.bfloat16:
                    results[name].update(r)
                else:
                    results[name] = dict(fp32=r)


DECODE_P, DECODE_G = 102, 24   # the recipes' prompt and generated slots


def decode_inputs(g, dev, B, K, dtype, S=2, P=DECODE_P, G=DECODE_G, H=12):
    """One decode step's operands from ``g``: q/k/v [B*K, S, H*64], the
    prompt cache pk/pv as the prefill hands it over ([:, :P] views of
    [B, P+1, H*64] projections) and the generated cache gk/gv
    [B*K, G, H*64]."""
    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)
    q, k, v = (r(B * K, S, H * 64) for _ in range(3))
    pk, pv = (r(B, P + 1, H * 64)[:, :P] for _ in range(2))
    return q, k, v, pk, pv, r(B * K, G, H * 64), r(B * K, G, H * 64)


def decode_anc_bias(g, dev, B, K, gen_len, G=DECODE_G):
    """K4's ancestry bias [B*K, K*G] from ``g``: each slot's lineage a random
    beam of the example, the step's new slots the row's own."""
    anc = torch.randint(0, K, (B * K, G), generator=g, device=dev)
    own = torch.arange(B * K, device=dev) % K
    anc[:, gen_len:gen_len + 2] = own[:, None]
    beams = torch.arange(K, device=dev)[None, :, None]
    bias = torch.full((B * K, K, G), -10000.0, device=dev)
    return bias.masked_fill(anc[:, None, :] == beams, 0.0).reshape(
        B * K, K * G)


def decode_work(B, K, S, P, G, H, gen_len, elem, anc, D=64):
    """(bytes, FLOP) that one decode step needs, the visible slots only:
    q read and out written (B*K*S rows); the prompt's K/V once per example;
    each beam's committed slots' K/V (min(gen_len, G)); the K/V of the new
    tokens that get a slot (< G), read and written; with ``anc`` (K4) the
    ancestry bias of each row's visible columns.  FLOP: QK^T and PV over a
    row's columns, the prompt and its visible slots (K4: of every beam).
    ``elem``: bytes per activation element."""
    BK, HD = B * K, H * D
    vis = min(G, gen_len + S)        # slots a row can see
    new = vis - min(G, gen_len)      # new tokens that get a slot
    cols = P + (K * vis if anc else vis)
    nbytes = (2 * BK * S * HD * elem + 2 * B * P * HD * elem
              + 2 * BK * (vis - new) * HD * elem
              + 4 * BK * new * HD * elem
              + (BK * K * vis * 4 if anc else 0))
    return nbytes, 4 * BK * S * H * cols * D


def dropout_mask_bound(B, H, L) -> dict:
    """The least time of ``dropout_mask``: its fp32 [B, H, L, L] output
    written once (it reads nothing; Philox's integer work is not in the
    table of peaks)."""
    return bound(B * H * L * L * 4, 0)


def decode_times(dec, make_inputs, bias_for, err, name, drop_seed=None,
                 rate=0.0, dtype=torch.bfloat16):
    """Times of one decode-step kernel (K3, K4 or K5) in ``dtype`` at each of
    DECODE_GEN_LENS: the kernel, its plain version, SDPA over the joint
    keys (``decode_sdpa``: joint K/V and mask built in the call, and
    prebuilt) and the bound, which counts the visible slots only: q and out
    of the S new rows, the prompt K/V once per example, each beam's
    committed slots' K/V once (and, for K4, the ancestry bias of the
    visible columns), and the K/V of the new tokens that get a slot (< G),
    read and written (``decode_work``).  The row's own numbers are the last
    step's; ``batch_mean`` is the mean over the timed steps, the per-batch
    figure.  SDPA writes no cache slots and draws its own dropout bits
    (K5): a time bar only.  fp32 gets both fp32 bounds (``fp32_bound``),
    TURNS alternating readings of the kernel and of SDPA with its parts
    prebuilt, and the blocks of its body that one SM holds."""
    from vlp_tpu_torch.ops import _build
    per = {}
    elem = 2 if dtype == torch.bfloat16 else 4
    for gen_len in DECODE_GEN_LENS:
        q, k, v, pk, pv, gk, gv = make_inputs()
        bias = bias_for(gen_len) if bias_for else None
        BK, S, HD = q.shape
        B, P, _ = pk.shape
        G, K, H = gk.shape[1], BK // pk.shape[0], HD // 64
        kw = dict(n_heads=H, beam_bias=bias, drop_seed=drop_seed,
                  drop_rate=rate)
        parts = decode_sdpa_parts(q, pk, pv, gk, gv, gen_len, H, bias)
        before = _build.KERNELS[name].launches
        dec.decode_attention(q, k, v, pk, pv, gk, gv, gen_len, **kw)
        if _build.KERNELS[name].launches != before + 1:
            fail(f"{name}: the timed call is not this kernel")
        nbytes, flops = decode_work(B, K, S, P, G, H, gen_len, elem,
                                    bias is not None)

        def kernel():
            return dec.decode_attention(q, k, v, pk, pv, gk, gv, gen_len,
                                        **kw)

        def prebuilt():
            return decode_sdpa(q, pk, pv, gk, gv, gen_len, H, bias, rate,
                               parts=parts)

        per[gen_len] = r = dict(
            ms=time_ms(kernel),
            plain_ms=plain_ms(lambda: dec.decode_attention_plain(
                q, k, v, pk, pv, gk, gv, gen_len, **kw)),
            library_ms=time_ms(lambda: decode_sdpa(
                q, pk, pv, gk, gv, gen_len, H, bias, rate)),
            library_prebuilt_mask_ms=time_ms(prebuilt),
            **(bound(nbytes, flops) if elem == 2
               else fp32_bound(nbytes, flops)))
        log(f"{name} B={B} K={K} gen_len={gen_len} {dtype} time "
            f"({decode_body(dtype)}): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
            f"(joint K/V and mask prebuilt {r['library_prebuilt_mask_ms']:.4f})"
            f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        if elem == 4:
            # the fp32 body against SDPA with its parts prebuilt, in TURNS
            # alternating readings, and the blocks an SM holds
            ks, ls = [], []
            for _ in range(TURNS):
                ks.append(time_ms(kernel))
                ls.append(time_ms(prebuilt))
            r.update(
                ms_turns=ks, library_prebuilt_turns=ls,
                under_library_prebuilt=all(x <= y for x, y in zip(ks, ls)),
                blocks_per_sm=_build.library()
                .vlp_decode_attention_f32_blocks_per_sm(
                    K, S, P, G, gen_len, int(bias is not None),
                    int(rate > 0)))
            log(f"{name} fp32 gen_len={gen_len} in turns: kernel {ks}, SDPA "
                f"prebuilt {ls}; every turn under SDPA prebuilt: "
                f"{r['under_library_prebuilt']}; {r['blocks_per_sm']} "
                f"blocks per SM")
    keys = ("ms", "plain_ms", "library_ms", "library_prebuilt_mask_ms",
            "bound_ms")
    mean = {key: statistics.mean(per[gl][key] for gl in DECODE_GEN_LENS)
            for key in keys}
    log(f"{name} {dtype} mean over gen_len {DECODE_GEN_LENS}: " + ", ".join(
        f"{key} {val:.4f}" for key, val in mean.items()))
    return dict(body=decode_body(dtype), max_abs_err=err,
                gen_len=DECODE_GEN_LENS[-1], **per[DECODE_GEN_LENS[-1]],
                batch_mean=mean, per_gen_len=per)


def phase_scst_kernels(dev, results):
    """K5 (the decode step with dropout) and K6 (its multipliers) at the
    SCST rollout's shapes: B=64, K=1, P=102, G=24, H=12, 19 decode steps.
    K5 against its plain version in fp32 and bf16 at several gen_len; K6
    bit for bit against the plain Philox; K5's output against the plain K3
    math times K6's multipliers.  Times in bf16 at gen_len 18."""
    from vlp_tpu_torch.ops import decode_attention as dec
    from vlp_tpu_torch.ops import philox

    g = torch.Generator(device=dev).manual_seed(4)
    B, S, P, G, H, W = SCST_B, 2, DECODE_P, DECODE_G, 12, SCST_T - 1
    rate = 0.1
    seeds = [philox.step_seed(0xC0FFEE, 1, t, 5) for t in range(W)]

    def inputs(dtype):
        return decode_inputs(g, dev, B, 1, dtype, S, P, G, H)

    # K6: every row bit for bit, and its keep fraction
    scales = dec.decode_dropout_scales(seeds, B, n_heads=H, S=S, P=P, G=G,
                                       rate=rate, device=dev)
    torch.cuda.synchronize()
    for t, sd in enumerate(seeds):
        want = philox.decode_keep_scale(sd, B, H, S, P, G, rate, device=dev)
        if not torch.equal(scales[t * B:(t + 1) * B], want):
            fail(f"decode_dropout_scales: step {t}'s multipliers differ from "
                 "the plain Philox")
    frac = (scales > 0).float().mean().item()
    if abs(frac - (1 - rate)) >= 0.005:
        fail(f"decode_dropout_scales keeps {frac:.5f}, not {1 - rate}")
    log(f"K6 decode_dropout_scales W={W} B={B}: bit-exact, keep fraction "
        f"{frac:.5f}")

    errs = {torch.float32: [], torch.bfloat16: []}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for t, gen_len in enumerate(DECODE_GEN_LENS + (23,)):
            ops = inputs(dtype)
            copies = [x.clone() for x in ops[5:]]
            got = dec.decode_attention(*ops, gen_len, n_heads=H,
                                       drop_seed=seeds[t], drop_rate=rate)
            want = dec.decode_attention_plain(*ops[:5], *copies, gen_len,
                                              n_heads=H, drop_seed=seeds[t],
                                              drop_rate=rate)
            tag = f"B={B} gen_len={gen_len} {dtype} ({decode_body(dtype)})"
            errs[dtype].append(compare(f"K5 decode_attention_drop {tag}",
                                       got, want, tol))
            if not (torch.equal(ops[5], copies[0])
                    and torch.equal(ops[6], copies[1])):
                fail("decode_attention_drop: cache writes not bit-exact")
            # K5 = the K3 math times K6's multipliers (rows t*B..)
            mult = scales[t * B:(t + 1) * B]
            k3x6 = dec.decode_attention_plain(
                *ops[:5], *[x.clone() for x in copies], gen_len, n_heads=H,
                drop_mult=mult)
            compare(f"K5 vs K3 x K6 {tag}", got, k3x6, tol)
    # times at the main path's shape at the timed steps: bf16, and fp32
    # (the fp32 gates' body)
    k5 = decode_times(dec, lambda: inputs(torch.bfloat16), None,
                      max(errs[torch.bfloat16]), "decode_attention_drop",
                      drop_seed=seeds[0], rate=rate)
    k5["fp32"] = decode_times(dec, lambda: inputs(torch.float32), None,
                              max(errs[torch.float32]),
                              "decode_attention_drop",
                              drop_seed=seeds[0], rate=rate,
                              dtype=torch.float32)
    k6 = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: dec.decode_dropout_scales(
            seeds, B, n_heads=H, S=S, P=P, G=G, rate=rate, device=dev)),
        plain_ms=plain_ms(lambda: torch.cat([
            philox.decode_keep_scale(sd, B, H, S, P, G, rate, device=dev)
            for sd in seeds])),
        library_ms=None, **bound(W * B * H * S * (P + G) * 4, 0))
    # what holds it back: an empty launch (the card's per-launch floor in
    # this timing) and a fill of the same bytes by one PyTorch call
    filled = torch.empty((W * B, H, S, P + G), device=dev)
    k6.update(launch_floor_ms=time_ms(lambda: torch.cuda._sleep(0)),
              fill_ms=time_ms(filled.zero_))
    results["decode_attention_drop"] = k5
    results["decode_dropout_scales"] = k6
    log(f"decode_dropout_scales B={B} time: kernel {k6['ms']:.4f} ms, plain "
        f"{k6['plain_ms']:.4f} ms, bound {k6['bound_ms']:.4f} ms "
        f"({k6['bound_by']}); an empty launch {k6['launch_floor_ms']:.4f} ms, "
        f"zero_ of the same bytes {k6['fill_ms']:.4f} ms")


def sdpa_mask(q, mode, text_end, colkeep, prefix, layout="blhd"):
    """SDPA's additive [B, 1, L, L] mask (-10000 where hidden) in q's
    dtype."""
    from vlp_tpu_torch.ops.attention import _mask_bias
    L = q.shape[1 if layout == "blhd" else 2]
    return _mask_bias(mode, text_end, colkeep, prefix, L)[:, None].to(q.dtype)


def sdpa(q, k, v, mode, text_end, colkeep, prefix, dropout_p=0.0,
         layout="blhd", mask=None):
    """One PyTorch library call computing the same attention (additive
    -10000 mask), in and out in ``layout``: [B, L, H, D], or [B, H, L, D],
    SDPA's own, with no transpose.  The mask is built inside the call
    unless ``mask`` (``sdpa_mask``) is given: library_ms times the former,
    library_prebuilt_mask_ms the latter.  The port never calls it."""
    import torch.nn.functional as F
    if mask is None:
        mask = sdpa_mask(q, mode, text_end, colkeep, prefix, layout)
    if layout == "blhd":
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, dropout_p=dropout_p).transpose(1, 2)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          dropout_p=dropout_p)


def decode_sdpa_parts(q, pk, pv, gk, gv, gen_len, n_heads, beam_bias=None):
    """(q, keys, values, additive mask) with which one
    ``F.scaled_dot_product_attention`` call computes decode step
    ``gen_len`` of ``decode_attention_plain`` over caches that already hold
    the step's new tokens: with ``beam_bias`` (K4) q as [B, H, K*S, D]
    against the example's joint keys cat(prompt, all K beams' slots)
    [B, H, P+K*G, D] under a [B, 1, K*S, P+K*G] mask (0 / -10000
    visibility, slot <= gen_len + s, plus the ancestry bias), nothing
    expanded; without (K3, K5) q as [B*K, H, S, D] against cat(prompt
    repeated over the K beams, the beam's own slots) under a
    [1, 1, S, P+G] mask.  The mask is in q's dtype."""
    from vlp_tpu_torch.ops.masks import NEG_INF
    BK, S, HD = q.shape
    B, P, _ = pk.shape
    G = gk.shape[1]
    K, H = BK // B, n_heads
    D = HD // H
    zeros = torch.zeros((S, P), device=q.device)
    vis = torch.full((S, G), NEG_INF, device=q.device).masked_fill(
        torch.arange(G, device=q.device)[None, :]
        <= gen_len + torch.arange(S, device=q.device)[:, None], 0.0)

    def heads(x):
        return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)

    if beam_bias is None:
        pkx, pvx = ((x if K == 1 else x.repeat_interleave(K, dim=0))
                    for x in (pk, pv))
        keys, vals = torch.cat([pkx, gk], 1), torch.cat([pvx, gv], 1)
        mask = torch.cat([zeros, vis], 1)[None, None]
        return heads(q), heads(keys), heads(vals), mask.to(q.dtype)
    keys = torch.cat([pk, gk.view(B, K * G, HD)], 1)
    vals = torch.cat([pv, gv.view(B, K * G, HD)], 1)
    gen = vis.repeat(1, K) + beam_bias.view(B, K, 1, K * G)
    mask = torch.cat([zeros.expand(B, K, S, P), gen], -1)
    return (q.view(B, K * S, H, D).transpose(1, 2), heads(keys),
            heads(vals), mask.view(B, 1, K * S, P + K * G).to(q.dtype))


def decode_sdpa(q, pk, pv, gk, gv, gen_len, n_heads, beam_bias=None,
                dropout_p=0.0, parts=None):
    """One decode step as one PyTorch library call (``decode_sdpa_parts``,
    built in the call unless ``parts`` hands them in); the context
    [B*K, S, H*D].  It writes no cache slots.  The port never calls it."""
    import torch.nn.functional as F
    qh, kh, vh, mask = parts or decode_sdpa_parts(q, pk, pv, gk, gv, gen_len,
                                                  n_heads, beam_bias)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                         dropout_p=dropout_p)
    return out.transpose(1, 2).reshape(q.shape)


def kernel_split(fn, calls=10) -> dict:
    """Device microseconds per call of each CUDA kernel that ``fn``
    launches (``torch.profiler``), over ``calls`` calls after one warm-up;
    empty if the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            # "void (anonymous namespace)::name<args>(params)" -> "name<args>"
            m = re.search(r"(\w+(<[^>]*>)?)\(", e.key)
            name = m.group(1) if m else e.key
            out[name] = round(e.device_time_total / calls, 1)
    return out


# the attention kernels of each layout: the deterministic forward, its
# dropout branch and the backward
FORMS = {"blhd": ("attention_fwd", "attention_fwd_drop", "attention_bwd"),
         "bhld": ("attention_fwd_bhld", "attention_fwd_bhld_drop",
                  "attention_bwd_bhld")}


def form_times(attn, q, k, v, mode, te, ck, dout, P, rate, seed,
               layout="blhd", forms=(0, 1, 2)) -> dict:
    """Device ms (``time_ms``) of the attention kernels ``FORMS[layout][i]``
    for i in ``forms`` on these inputs (the dropout branch at ``rate``),
    each beside its plain version (``plain_ms``), SDPA in the same layout
    (mask built in the call, and prebuilt) and the bound:
    {kernel entry (``kname``): times}."""
    B, L = ck.shape
    H, D = q.shape[2 if layout == "blhd" else 1], q.shape[3]
    act = q.numel() * q.element_size()     # one [B, L, H, D] tensor
    meta = 8 * B + 4 * B * L
    pd = product_flop(mode, te, ck, P, L, H, D)
    mask = sdpa_mask(q, mode, te, ck, P, layout=layout)
    kw = dict(prefix=P, layout=layout)
    drop = dict(dropout_rate=rate, seed=seed, **kw)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    # SDPA's graphs for its backward: mask built in the call, and prebuilt
    built, pre = (sdpa(*leaves, mode, te, ck, P, rate, mask=m, layout=layout)
                  for m in (None, mask))
    fwd_bound = bound(4 * act + meta, 2 * pd)
    calls = (
        (lambda: attn.attention(q, k, v, mode, te, ck, **kw),
         lambda: attn.attention_plain(q, k, v, mode, te, ck, **kw),
         lambda m=None: sdpa(q, k, v, mode, te, ck, P, layout=layout,
                             mask=m), fwd_bound),
        (lambda: attn._forward_cuda(q, k, v, mode, te, ck, P,
                                    dropout=(rate, seed), layout=layout),
         lambda: attn.attention_plain(q, k, v, mode, te, ck, **drop),
         lambda m=None: sdpa(q, k, v, mode, te, ck, P, rate, layout=layout,
                             mask=m), fwd_bound),
        (lambda: attn._backward_cuda(q, k, v, mode, te, ck, dout, P, rate,
                                     seed, layout),
         lambda: attn.attention_bwd_plain(q, k, v, mode, te, ck, dout,
                                          **drop),
         lambda m=None: torch.autograd.grad(built if m is None else pre,
                                            leaves, dout, retain_graph=True),
         bound(7 * act + meta, 5 * pd)))
    out = {}
    for i in forms:
        fn, plain_fn, lib, bnd = calls[i]
        out[kname(FORMS[layout][i], q.dtype)] = dict(
            B=B, L=L, body=body(q.dtype), ms=time_ms(fn),
            plain_ms=plain_ms(plain_fn), library_ms=time_ms(lib),
            library_prebuilt_mask_ms=time_ms(lambda: lib(mask)), **bnd)
    return out


def log_times(name, r, what="") -> None:
    log(f"{name} B={r['B']} L={r['L']} time ({r['body']}{what}): kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
        f"{r['library_ms']:.4f} ms (prebuilt mask "
        f"{r['library_prebuilt_mask_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})")


LONG_GATE_LENS = (160, 256, 528)   # the long bodies' gates
LONG_TIMED_LENS = (256, 528)       # and their times


def phase_long_attention(attn, inputs, B, P, seed, rate, results):
    """K1 and K2 in bf16 and fp16 past the one-block bodies (K1 L <= 128,
    K2 L <= 144): K1's row-block body and K2's tiled body (any --max_len_b
    >= 26 with 100 regions rounds the training length up to 256; 528 is
    the kernels' limit) at B=64, rate 0.1.  At each of LONG_GATE_LENS, in
    both layouts: K1 at rate 0 and ``rate`` and K2 against their plain
    versions, two calls of K1's dropout branch and of K2 bit for bit, and
    bhld = blhd on transposed inputs bit for bit.  Then, under ``L256`` /
    ``L528`` of each kernel's entry, times (``form_times``) at L=256 of
    every form of K1 and K2 in both layouts and both 16-bit dtypes, at
    L=528 of K1 (both branches) and K2 in blhd and both 16-bit dtypes,
    with the blocks per SM of bf16 K1's body, and the bf16 backward's
    device time by kernel at L=256."""
    from vlp_tpu_torch.ops import _build
    for dtype in (torch.bfloat16, torch.float16):
        for L in LONG_GATE_LENS:
            q, k, v, mode, te, ck, dout = inputs(dtype, L)
            tr = [t.transpose(1, 2).contiguous() for t in (q, k, v, dout)]
            got = {}
            for layout, (a, b_, c, d) in (("blhd", (q, k, v, dout)),
                                          ("bhld", tr)):
                tag = f"B={B} L={L} {dtype} ({body(dtype)}, long)"
                fwd = [attn.attention(a, b_, c, mode, te, ck, prefix=P,
                                      layout=layout)]

                def drop(a=a, b_=b_, c=c, layout=layout):
                    return attn._forward_cuda(a, b_, c, mode, te, ck, P,
                                              dropout=(rate, seed),
                                              layout=layout)

                fwd.append(drop())
                for i, r, out in ((0, 0.0, fwd[0]), (1, rate, fwd[1])):
                    name = kname(FORMS[layout][i], dtype)
                    want = attn.attention_plain(
                        a, b_, c, mode, te, ck, prefix=P, dropout_rate=r,
                        seed=seed, layout=layout)
                    note_err(results, name, compare(
                        f"K1 {name} {tag} rate={r}", out, want, TOL[dtype]))
                if not torch.equal(fwd[1], drop()):
                    fail(f"{FORMS[layout][1]} {tag}: two calls differ")
                args = (a, b_, c, mode, te, ck, d, P, rate, seed, layout)
                got[layout] = fwd + list(attn._backward_cuda(*args))
                want = attn.attention_bwd_plain(
                    a, b_, c, mode, te, ck, d, prefix=P, dropout_rate=rate,
                    seed=seed, layout=layout)
                name = kname(FORMS[layout][2], dtype)
                for n, x, y in zip(("dq", "dk", "dv"), got[layout][2:],
                                   want):
                    note_err(results, name, compare(
                        f"K2 {name} {n} {tag} rate={rate}", x, y,
                        TOL[dtype]))
                again = attn._backward_cuda(*args)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y)
                           for x, y in zip(got[layout][2:], again)):
                    fail(f"{name} {tag}: two calls differ")
            if not all(torch.equal(x.transpose(1, 2), y)
                       for x, y in zip(got["bhld"], got["blhd"])):
                fail(f"attention {dtype} L={L}: bhld differs from blhd on "
                     "transposed inputs")
            log(f"K1 and K2 {dtype} L={L}: both layouts bit-identical "
                "across two calls and to each other")
    lib = _build.library()
    for L in LONG_TIMED_LENS:
        for dtype in (torch.bfloat16, torch.float16):
            q, k, v, mode, te, ck, dout = inputs(dtype, L)
            for layout in ("blhd", "bhld") if L == 256 else ("blhd",):
                ins = (q, k, v, dout) if layout == "blhd" else [
                    t.transpose(1, 2).contiguous() for t in (q, k, v, dout)]
                times = form_times(attn, *ins[:3], mode, te, ck, ins[3], P,
                                   rate, seed, layout)
                for name, r in times.items():
                    results.setdefault(name, {})[f"L{L}"] = r
                    log_times(name, r)
            if dtype == torch.bfloat16:
                for i in (0, 1):
                    r = results[FORMS["blhd"][i]][f"L{L}"]
                    r["blocks_per_sm"] = lib.vlp_attention_fwd_blocks_per_sm(
                        L, i)
                log(f"K1 bf16 L={L}: blocks per SM (deterministic, dropout) "
                    f"{results['attention_fwd'][f'L{L}']['blocks_per_sm']}, "
                    f"{results['attention_fwd_drop'][f'L{L}']['blocks_per_sm']}"
                    f"; at L=128 {lib.vlp_attention_fwd_blocks_per_sm(128, 1)}")
            if dtype == torch.bfloat16 and L == 256:
                r = results["attention_bwd"]["L256"]
                r["kernels_us"] = {f"rate {x}": kernel_split(
                    lambda: attn._backward_cuda(q, k, v, mode, te, ck, dout,
                                                P, x, seed))
                    for x in (0.0, rate)}
                log(f"attention_bwd tiled L={L}, device us per call by "
                    f"kernel: {r['kernels_us']}")
            del q, k, v, dout


TURNS = 3      # readings of each kernel and SDPA, taken in turns


def k1_k2_times(attn, q, k, v, mode, te, ck, dout, P, rate, seed,
                layout="blhd", turns=1, prebuilt=False) -> dict:
    """Device ms (``time_ms``) of ``attn``'s K1 (the dropout branch at
    ``rate``) and K2 and of SDPA's forward and backward on the same inputs
    in ``layout``, read in turns -- K1, SDPA forward, K2, SDPA backward --
    ``turns`` times, so that a drift of the card reaches each alike: lists
    of readings under fwd_ms, sdpa_fwd_ms, bwd_ms, sdpa_bwd_ms.
    ``prebuilt`` adds, in each turn, SDPA's forward with its mask prebuilt
    (sdpa_fwd_prebuilt_ms) and K1's deterministic branch beside SDPA's
    without dropout, mask prebuilt (det_ms, sdpa_det_prebuilt_ms)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = sdpa(*leaves, mode, te, ck, P, rate, layout=layout)
    fns = dict(
        fwd_ms=lambda: attn._forward_cuda(q, k, v, mode, te, ck, P,
                                          dropout=(rate, seed),
                                          layout=layout),
        sdpa_fwd_ms=lambda: sdpa(q, k, v, mode, te, ck, P, rate,
                                 layout=layout),
        bwd_ms=lambda: attn._backward_cuda(q, k, v, mode, te, ck, dout, P,
                                           rate, seed, layout),
        sdpa_bwd_ms=lambda: torch.autograd.grad(lib_out, leaves, dout,
                                                retain_graph=True))
    if prebuilt:
        mask = sdpa_mask(q, mode, te, ck, P, layout=layout)
        fns.update(
            sdpa_fwd_prebuilt_ms=lambda: sdpa(q, k, v, mode, te, ck, P, rate,
                                              layout=layout, mask=mask),
            det_ms=lambda: attn.attention(q, k, v, mode, te, ck, prefix=P,
                                          layout=layout),
            sdpa_det_prebuilt_ms=lambda: sdpa(q, k, v, mode, te, ck, P,
                                              layout=layout, mask=mask))
    out = {key: [] for key in fns}
    for _ in range(turns):
        for key, fn in fns.items():
            out[key].append(time_ms(fn))
    return out


FP32_GATE_B = 16
FP32_GATE_LENS = (256, 512)        # past the first fp32 versions' lengths
# (B, L) at which fp32 K1 and K2 are timed: the fp32 gates' training shape
# (12 launches of each per fp32 train step), and the gates' lengths
FP32_TIMED = ((64, 128), (16, 256), (16, 512))


def phase_fp32_long(attn, inputs, H, D, P, seed, rate):
    """fp32 K1 and K2 (the split-TF32 bodies) at FP32_GATE_LENS,
    B=FP32_GATE_B, both layouts, rate 0 and ``rate``: each against its
    plain version within FP32_TOL, bhld = blhd on transposed inputs and two
    calls bit for bit.  Then, at ``rate`` and each (B, L) of FP32_TIMED,
    each layout's time beside fp32 SDPA (forward and backward in TURNS
    turns, ``k1_k2_times``: the medians, each turn's readings, and whether
    every turn was at or under SDPA; forward + backward), both fp32 bounds
    (``fp32_bound``, over the visible entries, ``product_flop``), and the
    backward's device time by kernel; at B=16, L=512 its peak memory
    beside the L x L scratch the first version allocated.  Returns (max errors,
    {name: times})."""
    from vlp_tpu_torch.ops import _build
    B = FP32_GATE_B
    errs = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for L in FP32_GATE_LENS:
        q, k, v, mode, te, ck, dout = inputs(torch.float32, L, B)
        tr = [t.transpose(1, 2).contiguous() for t in (q, k, v, dout)]
        for r in (0.0, rate):
            got = {}
            for layout, (a, b_, c, d) in (("blhd", (q, k, v, dout)),
                                          ("bhld", tr)):
                tag = f"fp32 B={B} L={L} {layout} rate={r}"
                call = (lambda a=a, b_=b_, c=c, layout=layout, r=r:
                        attn._forward_cuda(a, b_, c, mode, te, ck, P,
                                           dropout=(r, seed), layout=layout))
                out = call()
                errs["fwd"] = max(errs["fwd"], compare(
                    f"K1 attention_fwd {tag}", out, attn.attention_plain(
                        a, b_, c, mode, te, ck, prefix=P, dropout_rate=r,
                        seed=seed, layout=layout), FP32_TOL))
                if not torch.equal(out, call()):
                    fail(f"attention_fwd {tag}: two calls differ")
                got[layout, "fwd"] = (out,)
                args = (a, b_, c, mode, te, ck, d, P, r, seed, layout)
                grads = attn._backward_cuda(*args)
                want = attn.attention_bwd_plain(
                    a, b_, c, mode, te, ck, d, prefix=P, dropout_rate=r,
                    seed=seed, layout=layout)
                errs["bwd"] = max([errs["bwd"]] + [
                    compare(f"K2 attention_bwd {n} {tag}", x, y, FP32_TOL)
                    for n, x, y in zip(("dq", "dk", "dv"), grads, want)])
                again = attn._backward_cuda(*args)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(grads, again)):
                    fail(f"attention_bwd {tag}: two calls differ")
                got[layout, "bwd"] = grads
            for (layout, what), xs in got.items():
                if layout == "bhld" and not all(
                        torch.equal(x.transpose(1, 2), y)
                        for x, y in zip(xs, got["blhd", what])):
                    fail(f"fp32 {what} L={L} rate={r}: bhld differs from "
                         "blhd on transposed inputs")
        log(f"fp32 L={L}: both layouts within FP32_TOL, bit-identical "
            "across two calls and to each other")
        del q, k, v, dout, tr

    for B, L in FP32_TIMED:
        q, k, v, mode, te, ck, dout = inputs(torch.float32, L, B)
        tr = [t.transpose(1, 2).contiguous() for t in (q, k, v, dout)]
        act = B * L * H * D * 4              # one fp32 [B, L, H*D] tensor
        meta = 8 * B + 4 * B * L
        pd = product_flop(mode, te, ck, P, L, H, D)
        for layout, (a, b_, c, d) in (("blhd", (q, k, v, dout)),
                                      ("bhld", tr)):
            turns = k1_k2_times(attn, a, b_, c, mode, te, ck, d, P, rate,
                                seed, layout, TURNS)
            for what, n_bytes, flop in (("fwd", 4 * act + meta, 2 * pd),
                                        ("bwd", 7 * act + meta, 5 * pd)):
                ks, ls = turns[f"{what}_ms"], turns[f"sdpa_{what}_ms"]
                times[f"{what}_L{L}_{layout}"] = dict(
                    B=B, L=L, rate=rate, ms=statistics.median(ks),
                    library_ms=statistics.median(ls), ms_turns=ks,
                    library_turns=ls,
                    under_library=all(x <= y for x, y in zip(ks, ls)),
                    **fp32_bound(n_bytes, flop))
            r = times[f"fwd_L{L}_{layout}"]
            r["plain_ms"] = plain_ms(lambda: attn.attention_plain(
                a, b_, c, mode, te, ck, prefix=P, dropout_rate=rate,
                seed=seed, layout=layout))
            log(f"attention_fwd fp32 B={B} L={L} {layout} rate={rate} "
                f"time ({body(torch.float32)}): kernel {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, fp32 SDPA "
                f"{r['library_ms']:.4f} ms (in turns: kernel {r['ms_turns']}"
                f", SDPA {r['library_turns']}; every turn at or under SDPA: "
                f"{r['under_library']}), bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}; fp32 CUDA cores "
                f"{r['bound_cuda_core_ms']:.4f})")
            lv = [t.detach().requires_grad_() for t in (a, b_, c)]

            def fwd_bwd():
                out = attn.FusedAttention.apply(*lv, mode, te, ck, P, rate,
                                                seed, layout)
                return torch.autograd.grad(out, lv, d)

            r = times[f"bwd_L{L}_{layout}"]
            r.update(
                plain_ms=plain_ms(lambda: attn.attention_bwd_plain(
                    a, b_, c, mode, te, ck, d, prefix=P, dropout_rate=rate,
                    seed=seed, layout=layout)),
                fwd_bwd_ms=time_ms(fwd_bwd),
                library_fwd_bwd_ms=time_ms(lambda: torch.autograd.grad(
                    sdpa(*lv, mode, te, ck, P, rate, layout=layout), lv,
                    d)))
            log(f"attention_bwd fp32 B={B} L={L} {layout} rate={rate} "
                f"time ({body(torch.float32)}): kernel {r['ms']:.4f} ms "
                f"(fwd+bwd {r['fwd_bwd_ms']:.4f}), plain {r['plain_ms']:.4f} "
                f"ms, fp32 SDPA backward {r['library_ms']:.4f} ms (fwd+bwd "
                f"{r['library_fwd_bwd_ms']:.4f}; in turns: kernel "
                f"{r['ms_turns']}, SDPA {r['library_turns']}; every turn at "
                f"or under SDPA: {r['under_library']}), bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}; fp32 CUDA cores "
                f"{r['bound_cuda_core_ms']:.4f})")
        r = times[f"bwd_L{L}_blhd"]
        r["kernels_us"] = kernel_split(lambda: attn._backward_cuda(
            q, k, v, mode, te, ck, dout, P, rate, seed))
        log(f"attention_bwd fp32 B={B} L={L}, device us per call by kernel: "
            f"{r['kernels_us']}")
        if (B, L) == (16, 512):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            attn._backward_cuda(q, k, v, mode, te, ck, dout, P, rate, seed)
            torch.cuda.synchronize()
            n = _build.library().vlp_attention_bwd_scratch_floats(L, 0)
            r["memory_mb"] = mem = dict(
                peak=(torch.cuda.max_memory_allocated() - base) / 1e6,
                grads=3 * act / 1e6, scratch=B * H * n * 4 / 1e6,
                first_version_scratch=B * H * 2 * L * L * 4 / 1e6)
            log(f"attention_bwd fp32 B={B} L={L}: peak memory of one call "
                f"{mem['peak']:.1f} MB (gradients {mem['grads']:.1f}, "
                f"scratch {mem['scratch']:.1f}; the first version's P and "
                f"dS scratch was {mem['first_version_scratch']:.1f} MB)")
        del q, k, v, dout, tr
    return errs, times


TRAIN_SEED = 0x5DEECE66D0123457


def seed_arg(attn, seed: int, dev):
    """A dropout seed as the kernels under test take it with no launch of
    its own: a device slot (``ops.attention.seed_slot``, made once) where
    the checkout has one, else the int (an older checkout under
    ``--ab-times``, whose kernels take it by value), so that a time is the
    kernel's alone."""
    return attn.seed_slot(seed, dev) if hasattr(attn, "seed_slot") else seed


def train_inputs(g, dev, dtype, B, L, H=12, D=64, P=102):
    """Training-shaped attention inputs in blhd: q/k/v, int32 mode (s2s and
    bi in turn) and text_end, colkeep with zeros among the regions, dout."""
    from vlp_tpu_torch.config import MODE_BI, MODE_S2S
    qkv = torch.randn(B, L, 3 * H * D, generator=g, device=dev).to(dtype)
    q, k, v = (t.view(B, L, H, D) for t in qkv.split(H * D, dim=-1))
    mode = torch.tensor([MODE_S2S, MODE_BI] * (B // 2), device=dev)
    te = torch.randint(P + 1, L + 1, (B,), generator=g, device=dev)
    ck = torch.ones(B, L, device=dev)
    ck[:, 1:P - 1] = (torch.rand(B, P - 2, generator=g, device=dev)
                      > 0.3).float()
    dout = torch.randn(B, L, H, D, generator=g, device=dev).to(dtype)
    return q, k, v, mode.int(), te.int(), ck, dout


# (dtype, B, L) of the parent-vs-change timing (--ab-times): the bf16
# training shape and the tiled bf16 backward, and FP32_TIMED
AB_SHAPES = ((torch.bfloat16, 64, 128), (torch.bfloat16, 64, 256),
             (torch.bfloat16, 64, 528),
             *((torch.float32, B, L) for B, L in FP32_TIMED))


# (kernel, B, K) of the decode steps that --ab-times times in bf16 and
# fp32 at DECODE_GEN_LENS: greedy K3, beam-5 K4, the SCST rollout's K5
AB_DECODE = (("decode_attention", 100, 1), ("decode_attention_anc", 100, 5),
             ("decode_attention_drop", SCST_B, 1))
AB_MASK = (64, 12, 128)    # dropout_mask's B, H, L: the training shape


def decode_ab_times(dec, g, dev) -> dict:
    """Device ms (``time_ms``) of ``dec.decode_attention`` at AB_DECODE, in
    bf16 and fp32, at each of DECODE_GEN_LENS (K5 at rate 0.1)."""
    out = {}
    for name, B, K in AB_DECODE:
        for dtype in (torch.bfloat16, torch.float32):
            ms = {}
            for gen_len in DECODE_GEN_LENS:
                ops = decode_inputs(g, dev, B, K, dtype)
                kw = dict(n_heads=12)
                if name == "decode_attention_anc":
                    kw["beam_bias"] = decode_anc_bias(g, dev, B, K, gen_len)
                if name == "decode_attention_drop":
                    kw.update(drop_seed=TRAIN_SEED, drop_rate=0.1)
                ms[gen_len] = time_ms(lambda: dec.decode_attention(
                    *ops, gen_len, **kw))
            out[f"{name} {str(dtype)[6:]} B={B} K={K}"] = ms
    return out


def ab_times(root: str) -> None:
    """``python3 chip_smoke.py --ab-times ROOT``: with the ``vlp_tpu_torch``
    under ROOT (another checkout of the repository, built there at first
    use), ``k1_k2_times`` (one turn, blhd, rate 0.1) at AB_SHAPES, the
    decode step at AB_DECODE (``decode_ab_times``) and ``dropout_mask`` at
    AB_MASK; prints one JSON line.  Run it on two trees in turns (A, B, B,
    A) in one call to compare their kernels on one card."""
    sys.path.insert(0, os.path.abspath(root))
    import vlp_tpu_torch
    from vlp_tpu_torch.ops import _build
    from vlp_tpu_torch.ops import attention as attn
    from vlp_tpu_torch.ops import decode_attention as dec
    if not vlp_tpu_torch.__file__.startswith(os.path.abspath(root)):
        fail(f"--ab-times imported {vlp_tpu_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        fail("--ab-times needs an NVIDIA GPU")
    vlp_tpu_torch.configure_precision()
    dev = torch.device("cuda", 0)
    _build.library()
    g = torch.Generator(device=dev).manual_seed(1)
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    for dtype, B, L in AB_SHAPES:
        ins = train_inputs(g, dev, dtype, B, L)
        out[f"{str(dtype)[6:]} B={B} L={L}"] = {
            key: val[0] for key, val in k1_k2_times(
                attn, *ins, 102, 0.1, seed_arg(attn, TRAIN_SEED, dev),
                prebuilt=dtype == torch.bfloat16).items()}
        del ins
    # K1's deterministic branch at the decode prefill's and the VQA eval's
    # shapes (phase 2's k1_inputs)
    from vlp_tpu_torch.config import MODE_BI, MODE_S2S
    for label, B, L in (("prefill", 100, 103), ("vqa", VQA_B, 128)):
        q, k, v, mode, te, ck, _ = train_inputs(g, dev, torch.bfloat16, B, L)
        if label == "prefill":
            mode.fill_(MODE_S2S), te.fill_(L), ck.fill_(1.0)
        else:
            mode.fill_(MODE_BI)
        out[f"attention_fwd {label} bf16 B={B} L={L}"] = time_ms(
            lambda: attn.attention(q, k, v, mode, te, ck, prefix=102))
        del q, k, v
    out.update(decode_ab_times(dec, g, dev))
    B, H, L = AB_MASK
    seed = seed_arg(attn, TRAIN_SEED, dev)
    out[f"dropout_mask [{B},{H},{L},{L}]"] = time_ms(
        lambda: attn.dropout_mask(B, H, L, 0.1, seed, dev))
    print(json.dumps(out))


def phase_train_kernels(dev, results):
    """K1 (both branches), K2 and dropout_mask at the training shape
    (B=64, L=128, H=12, D=64): fp32, bf16 and fp16, mixed modes, zeros in
    colkeep, rate 0 and 0.1, each against its plain version; the mask bit
    for bit.  Times in bf16 and fp16 at rate 0.1 (``form_times``), the
    tiled K2 at L=256 and 528 beside them (``phase_long_attention``), and
    the fp32 bodies (``phase_fp32_long``)."""
    from vlp_tpu_torch.ops import attention as attn
    from vlp_tpu_torch.ops import philox

    g = torch.Generator(device=dev).manual_seed(1)
    B, L, H, D, P = 64, 128, 12, 64, 102
    seed, rate = seed_arg(attn, TRAIN_SEED, dev), 0.1

    def inputs(dtype, L=L, B=B):
        return train_inputs(g, dev, dtype, B, L)

    # the mask, bit for bit, and its keep fraction
    mask = attn.dropout_mask(B, H, L, rate, seed, dev)
    want = philox.keep_scale(seed, B, H, L, rate, device=dev)
    torch.cuda.synchronize()
    if not torch.equal(mask, want):
        fail(f"dropout_mask: {(mask != want).sum().item()} multipliers "
             "differ from the plain Philox")
    frac = (mask > 0).float().mean().item()
    if abs(frac - (1 - rate)) >= 0.005:
        fail(f"dropout_mask keeps {frac:.5f}, not {1 - rate} +- 0.005")
    log(f"dropout_mask B={B} H={H} L={L}: bit-exact, keep fraction "
        f"{frac:.5f}")
    # beside it, what holds it back: an empty launch (the card's per-launch
    # floor in this timing) and a fill of the same bytes by one PyTorch call
    filled = torch.empty((B, H, L, L), device=dev)
    results["dropout_mask"] = dm = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: attn.dropout_mask(B, H, L, rate, seed, dev)),
        plain_ms=plain_ms(lambda: philox.keep_scale(seed, B, H, L, rate,
                                                   device=dev)),
        library_ms=None, launch_floor_ms=time_ms(
            lambda: torch.cuda._sleep(0)),
        fill_ms=time_ms(filled.zero_), **dropout_mask_bound(B, H, L))
    log(f"dropout_mask [{B},{H},{L},{L}]: an empty launch "
        f"{dm['launch_floor_ms']:.4f} ms, zero_ of the same bytes "
        f"{dm['fill_ms']:.4f} ms")
    del filled

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v, mode, te, ck, dout = inputs(dtype)
        tag = f"B={B} L={L} {dtype} ({body(dtype)})"
        name = kname("attention_fwd", dtype)
        note_err(results, name, compare(
            f"K1 {name} {tag}", attn.attention(q, k, v, mode, te, ck,
                                               prefix=P),
            attn.attention_plain(q, k, v, mode, te, ck, prefix=P),
            TOL[dtype]))
        for r in (0.0, rate):
            fwd = attn._forward_cuda(q, k, v, mode, te, ck, P,
                                     dropout=(r, seed))
            want = attn.attention_plain(q, k, v, mode, te, ck, prefix=P,
                                        dropout_rate=r, seed=seed)
            name = kname("attention_fwd_drop", dtype)
            note_err(results, name, compare(f"K1 {name} {tag} rate={r}", fwd,
                                            want, TOL[dtype]))
            got = attn._backward_cuda(q, k, v, mode, te, ck, dout, P, r, seed)
            want = attn.attention_bwd_plain(q, k, v, mode, te, ck, dout,
                                            prefix=P, dropout_rate=r,
                                            seed=seed)
            name = kname("attention_bwd", dtype)
            for n, a, b_ in zip(("dq", "dk", "dv"), got, want):
                note_err(results, name, compare(f"K2 {name} {n} {tag} "
                                                f"rate={r}", a, b_,
                                                TOL[dtype]))

    # times at the main path's shape, rate 0.1, in bf16 and fp16 (bf16's
    # deterministic forward under "train_shape": its entry is the decode
    # prefill's), with K1 + K2 through autograd beside SDPA's
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v, mode, te, ck, dout = inputs(dtype)
        times = form_times(attn, q, k, v, mode, te, ck, dout, P, rate, seed)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        mask = sdpa_mask(q, mode, te, ck, P)

        def fused_step():
            out = attn.FusedAttention.apply(*leaves, mode, te, ck, P, rate,
                                            seed)
            return torch.autograd.grad(out, leaves, dout)

        def library_step(mask=None):
            return torch.autograd.grad(
                sdpa(*leaves, mode, te, ck, P, rate, mask=mask), leaves, dout)

        times[kname("attention_bwd", dtype)].update(
            fwd_bwd_ms=time_ms(fused_step),
            library_fwd_bwd_ms=time_ms(library_step),
            library_prebuilt_mask_fwd_bwd_ms=time_ms(
                lambda: library_step(mask)))
        for name, r in times.items():
            if name == "attention_fwd":
                results[name]["train_shape"] = r
            else:
                results[name].update(r)
            log_times(name, r)
        r = times[kname("attention_bwd", dtype)]
        log(f"K1+K2 fwd+bwd {dtype} ({body(dtype)}): {r['fwd_bwd_ms']:.4f} "
            f"ms; SDPA fwd+bwd {r['library_fwd_bwd_ms']:.4f} ms (prebuilt "
            f"mask {r['library_prebuilt_mask_fwd_bwd_ms']:.4f})")
        del q, k, v, dout, leaves, mask
    phase_long_attention(attn, inputs, B, P, seed, rate, results)
    fp32_errs, fp32_times = phase_fp32_long(attn, inputs, H, D, P, seed, rate)
    results["attention_fwd_drop"]["fp32"] = dict(
        max_abs_err=fp32_errs["fwd"], **{
            k: v for k, v in fp32_times.items() if k.startswith("fwd")})
    results["attention_bwd"]["fp32"] = dict(max_abs_err=fp32_errs["bwd"], **{
        k: v for k, v in fp32_times.items() if k.startswith("bwd")})
    r = results["dropout_mask"]
    log(f"dropout_mask bf16 B={B} time: kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


def phase_mla_kernels(dev, results):
    """K1 and K2 at MLA's widths (Kimi-VL: q.k 192, v 128, H=16), bf16 at
    rate 0, at the Kimi cell's shape (B=256, L=128, its s2s masks), through
    ``FusedAttention`` against the plain versions, timed beside the plain
    versions, SDPA (its mask built in the call and prebuilt) and the bound
    (``benchmarks/work_kimi.py``'s bytes and visible-entry products)."""
    from vlp_tpu_torch.config import MODE_S2S
    from vlp_tpu_torch.ops import attention as attn

    g = torch.Generator(device=dev).manual_seed(22)
    B, L, H, P = 256, 128, 16, 102
    dq, dv = attn.MLA_QK_DIM, attn.MLA_V_DIM
    q, k = (torch.randn(B, L, H, dq, generator=g, device=dev).bfloat16()
            for _ in range(2))
    v = torch.randn(B, L, H, dv, generator=g, device=dev).bfloat16()
    dout = torch.randn(B, L, H, dv, generator=g, device=dev).bfloat16()
    mode = torch.full((B,), MODE_S2S, dtype=torch.int32, device=dev)
    te = torch.randint(P + 9, P + 22, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    ck = torch.ones(B, L, device=dev)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = attn.FusedAttention.apply(*leaves, mode, te, ck, P, 0.0, None)
    grads = torch.autograd.grad(out, leaves, dout)
    errs = {"attention_fwd_mla": compare(
        "K1 MLA (192, 128) bf16", out,
        attn.attention_plain(q, k, v, mode, te, ck, prefix=P), BF16_TOL)}
    want = attn.attention_bwd_plain(q, k, v, mode, te, ck, dout, prefix=P)
    errs["attention_bwd_mla"] = max(
        compare(f"K2 MLA (192, 128) bf16 d{n}", a, b, BF16_TOL)
        for n, a, b in zip("qkv", grads, want))
    vis = product_flop(mode, te, ck, P, L, H, 1) // (2 * H)
    meta = 8 * B + 4 * B * L
    act = B * L * H * 2                       # bf16 bytes a column
    mask = sdpa_mask(q, mode, te, ck, P)
    built, pre = (sdpa(*leaves, mode, te, ck, P, mask=m)
                  for m in (None, mask))
    calls = {
        "attention_fwd_mla": (
            lambda: attn._forward_cuda(q, k, v, mode, te, ck, P,
                                       dropout=(0.0, None)),
            lambda: attn.attention_plain(q, k, v, mode, te, ck, prefix=P),
            lambda m=None: sdpa(q, k, v, mode, te, ck, P, mask=m),
            bound((2 * dq + 2 * dv) * act + meta, 2 * H * vis * (dq + dv))),
        "attention_bwd_mla": (
            lambda: attn._backward_cuda(q, k, v, mode, te, ck, dout, P, 0.0,
                                        None),
            lambda: attn.attention_bwd_plain(q, k, v, mode, te, ck, dout,
                                             prefix=P),
            lambda m=None: torch.autograd.grad(built if m is None else pre,
                                               leaves, dout,
                                               retain_graph=True),
            bound((4 * dq + 3 * dv) * act + meta,
                  2 * H * vis * (3 * dq + 2 * dv)))}
    for name, (fn, plain_fn, lib, bnd) in calls.items():
        r = results[name] = dict(
            max_abs_err=errs[name], B=B, L=L, body="v2 mma (192, 128)",
            ms=time_ms(fn), plain_ms=plain_ms(plain_fn),
            library_ms=time_ms(lib),
            library_prebuilt_mask_ms=time_ms(lambda: lib(mask)), **bnd)
        log_times(name, r)


# Kimi-VL's expert layer at the Kimi cell's shape: B=128 sequences of 128
# tokens, top-6 of 64 experts, 8 held, hidden 2048, expert width 1408
MOE_T, MOE_K, MOE_E, MOE_HELD, MOE_H, MOE_I = 16384, 6, 64, 8, 2048, 1408
# a training step's launches per MoE layer: the forward's three, the
# backward's recomputed gather and SwiGLU and the three backwards
MOE_STEP_LAUNCHES = dict(moe_gather=2, moe_gather_bwd=1, moe_swiglu=2,
                         moe_swiglu_bwd=1, moe_combine=1, moe_combine_bwd=1)


def moe_layer_inputs(dev, seed=24) -> dict:
    """One expert layer's inputs at the Kimi cell's shape: unit-variance
    token rows routed by a random router as the cell's is initialised
    (N(0, 0.02), sigmoid scores, top-6 normalised and scaled by 2.446),
    the held experts 0..7 (fp32, N(0, 0.02)) and a shared output."""
    from vlp_tpu_torch.models.kimi_vl import sort_pairs

    g = torch.Generator(device=dev).manual_seed(seed)
    T, k, H, inter = MOE_T, MOE_K, MOE_H, MOE_I

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x = r(T, H).bfloat16()
    scores = torch.sigmoid(x.float() @ r(MOE_E, H, scale=0.02).t())
    idx = scores.topk(k, dim=-1).indices
    w = scores.gather(1, idx)
    w = (w / w.sum(-1, keepdim=True) * 2.446).contiguous()
    order, row_of, counts, offs = sort_pairs(idx, range(MOE_HELD))
    R = T * min(k, MOE_HELD)
    return dict(x=x, w=w, order=order[:R], row_of=row_of, counts=counts,
                offs=offs, count=int(offs[-1]), R=R,
                gate_up=r(MOE_HELD, 2 * inter, H, scale=0.02),
                down=r(MOE_HELD, H, inter, scale=0.02),
                base=r(T, H).bfloat16(), dy=r(T, H).bfloat16())


def masked_held_rows(x, order, row_of, k, offs, w, gate_up, down, base):
    """The expert rows as masked full-buffer passes, the yardstick: the
    same products, with ``where`` masks, the weighting and an
    ``index_select`` combine, every pass over all R rows."""
    from vlp_tpu_torch.models.kimi_vl import grouped_mm
    R, T, H = order.shape[0], row_of.shape[0] // k, x.shape[1]
    valid = torch.arange(R, device=x.device) < offs[-1]
    w_row = torch.where(valid, w.reshape(-1)[order], 0.0)
    xg = torch.where(valid[:, None], x.index_select(0, order // k), 0.0)
    gg, u = grouped_mm(xg, gate_up, offs).split(down.shape[-1], dim=-1)
    y = grouped_mm(F.silu(gg) * u, down, offs)
    y = torch.where(valid[:, None], y, 0.0) * w_row[:, None].to(y.dtype)
    y = torch.cat([y, y.new_zeros(T * k - R, H)]).index_select(0, row_of)
    return y.view(T, k, H).sum(1) + base


class PoisonedGroupedMM(torch.autograd.Function):
    """``torch._grouped_mm`` with the rows it leaves undefined (past the
    last offset) set to NaN, in its output and in a's gradient."""

    @staticmethod
    def forward(ctx, a, w, offs):
        ctx.save_for_backward(a, w, offs)
        out = torch._grouped_mm(a, w.transpose(-2, -1), offs=offs)
        out[int(offs[-1]):] = float("nan")
        return out

    @staticmethod
    def backward(ctx, g):
        a, w, offs = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (a, w)]
        with torch.enable_grad():
            out = torch._grouped_mm(leaves[0], leaves[1].transpose(-2, -1),
                                    offs=offs)
            da, dw = torch.autograd.grad(out, leaves, g)
        da[int(offs[-1]):] = float("nan")
        return da, dw, None


@contextlib.contextmanager
def poisoned_rows():
    """Every row the expert layer leaves undefined is NaN: the grouped
    products' (:class:`PoisonedGroupedMM`) and, through PyTorch's
    deterministic mode, every ``torch.empty`` of the row kernels."""
    from vlp_tpu_torch.models import kimi_vl
    plain = kimi_vl.grouped_mm
    kimi_vl.grouped_mm = lambda a, w, offs: PoisonedGroupedMM.apply(
        a, w.to(a.dtype), offs)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        kimi_vl.grouped_mm = plain


def moe_layer_grads(inp, fn=None):
    """(y, dx, dw, d gate_up, d down, d base) of one layer's held rows
    (``HeldRows``, or ``fn`` with its arguments) from the gradient dy."""
    from vlp_tpu_torch.models.kimi_vl import HeldRows
    leaves = [inp[n].detach().requires_grad_()
              for n in ("x", "w", "gate_up", "down", "base")]
    x, w, gate_up, down, base = leaves
    y = (fn or HeldRows.apply)(x, inp["order"], inp["row_of"], MOE_K,
                               inp["offs"], w, gate_up, down, base)
    return [y.detach()] + list(torch.autograd.grad(y, leaves, inp["dy"]))


def phase_moe_rows(dev, results):
    """Kimi-VL's expert-row kernels (``csrc/moe_rows.cu``) at the Kimi
    cell's shape: each against its plain version with the rows past the
    held-row count NaN in its inputs (none may reach an output), twice
    bit-identical; the whole layer (``HeldRows``, forward and backward)
    with every undefined row NaN against the masked full-buffer passes, twice
    bit-identical, and captured in a CUDA graph against eager; each
    kernel's time beside its plain version's, the masked passes' and the
    bound (the held rows' bytes over the HBM rate); the layer's time,
    beside the masked passes'."""
    from vlp_tpu_torch.ops import moe_rows as mr

    inp = moe_layer_inputs(dev)
    T, k, H, inter = MOE_T, MOE_K, MOE_H, MOE_I
    R, n, offs = inp["R"], inp["count"], inp["offs"]
    order, row_of, w = inp["order"], inp["row_of"], inp["w"]
    g = torch.Generator(device=dev).manual_seed(25)

    def rows(width):   # a buffer whose rows past the count are NaN
        t = torch.randn(R, width, generator=g, device=dev).bfloat16()
        t[n:] = float("nan")
        return t

    x, base, dy = inp["x"], inp["base"], inp["dy"]
    gu, dh, y_rows, dxg = rows(2 * inter), rows(inter), rows(H), rows(H)
    e = 2                                    # bf16 bytes
    idx_bytes = 8 * T * k + 4 * MOE_HELD     # row_of (or order) and offs
    valid = torch.arange(R, device=dev) < offs[-1]
    w_row = torch.where(valid, w.reshape(-1)[order], 0.0)[:, None]
    gg, uu = gu.split(inter, dim=-1)
    pad = dxg.new_zeros(T * k - R, H)
    calls = {
        "moe_gather": (
            lambda: mr.gather(x, order, offs, k),
            lambda: mr.gather_plain(x, order, offs, k),
            lambda: torch.where(valid[:, None], x.index_select(0, order // k),
                                0.0),
            2 * n * H * e + 8 * n + 4 * MOE_HELD, n),
        "moe_gather_bwd": (
            lambda: mr.gather_bwd(dxg, row_of, offs, k),
            lambda: mr.gather_bwd_plain(dxg, row_of, offs, k),
            lambda: torch.cat([torch.where(valid[:, None], dxg, 0.0), pad])
            .index_select(0, row_of).view(T, k, H).sum(1),
            n * H * e + T * H * e + idx_bytes, None),
        "moe_swiglu": (
            lambda: mr.swiglu(gu, offs),
            lambda: mr.swiglu_plain(gu, offs),
            lambda: F.silu(gg) * uu,
            3 * n * inter * e + 4 * MOE_HELD, n),
        "moe_swiglu_bwd": (
            lambda: mr.swiglu_bwd(dh, gu, offs),
            lambda: mr.swiglu_bwd_plain(dh, gu, offs),
            lambda: torch.cat([torch.ops.aten.silu_backward(dh * uu, gg),
                               dh * F.silu(gg)], dim=-1),
            5 * n * inter * e + 4 * MOE_HELD, n),
        "moe_combine": (
            lambda: mr.combine(y_rows, w, row_of, offs, k, base),
            lambda: mr.combine_plain(y_rows, w, row_of, offs, k, base),
            lambda: torch.cat([torch.where(valid[:, None], y_rows, 0.0)
                               * w_row.to(y_rows.dtype), pad])
            .index_select(0, row_of).view(T, k, H).sum(1) + base,
            n * H * e + 2 * T * H * e + 4 * T * k + idx_bytes, None),
        "moe_combine_bwd": (
            lambda: mr.combine_bwd(dy, y_rows, w, row_of, offs, k),
            lambda: mr.combine_bwd_plain(dy, y_rows, w, row_of, offs, k),
            lambda: (torch.where(valid[:, None], dy.index_select(
                0, order // k) * w_row.to(dy.dtype), 0.0),
                (dy.index_select(0, order // k) * torch.where(
                    valid[:, None], y_rows, 0.0)).float().sum(-1)),
            T * H * e + 2 * n * H * e + 8 * T * k + idx_bytes, n),
    }
    for name, (fn, plain_fn, masked_fn, nbytes, cut) in calls.items():
        got, again, want = fn(), fn(), plain_fn()
        torch.cuda.synchronize()
        outs = [(got, want, again)] if torch.is_tensor(got) else list(
            zip(got, want, again))
        err = 0.0
        for i, (a, b, c) in enumerate(outs):
            a, b, c = ((t[:cut] if cut is not None and t.shape[0] == R else t)
                       for t in (a, b, c))
            err = max(err, compare(f"{name} [{i}] (rows past the count NaN)",
                                   a, b, BF16_TOL))
            if not torch.equal(a, c):
                fail(f"{name}: two runs differ")
        results[name] = r = dict(
            max_abs_err=err, T=T, k=k, held_rows=n, buffer_rows=R,
            ms=time_ms(fn), plain_ms=plain_ms(plain_fn),
            masked_ms=time_ms(masked_fn), **bound(nbytes, 0.0))
        log(f"{name}: {n} of {R} rows, kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, masked passes {r['masked_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of it")

    # the whole layer, forward and backward
    with poisoned_rows():
        got = moe_layer_grads(inp)
        again = moe_layer_grads(inp)
    torch.cuda.synchronize()
    want = moe_layer_grads(inp, masked_held_rows)
    layer_err = {}
    for name, a, b, c in zip(("y", "dx", "dw", "dgate_up", "ddown", "dbase"),
                             got, want, again):
        tol = BF16_TOL if name in ("y", "dx", "dbase") else dict(
            atol=2e-2 * float(b.abs().max()), rtol=2e-2)
        layer_err[name] = compare(f"expert layer {name} (undefined rows NaN) "
                                  "vs the masked passes", a, b, tol)
        if not torch.equal(a, c):
            fail(f"expert layer {name}: two runs differ")
    with deterministic():
        eager = moe_layer_grads(inp)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            moe_layer_grads(inp)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = moe_layer_grads(inp)
        graph.replay()
        torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(eager, captured)):
        fail("expert layer: the captured layer differs from the eager one")
    layer = dict(held_rows=n, buffer_rows=R, max_abs_err=layer_err,
                 captured_equals_eager=True,
                 ms=time_ms(lambda: moe_layer_grads(inp)),
                 masked_ms=time_ms(lambda: moe_layer_grads(inp,
                                                         masked_held_rows)))
    results["moe_layer"] = layer
    log(f"phase 2 expert layer: forward + backward {layer['ms']:.3f} ms "
        f"(masked passes {layer['masked_ms']:.3f} ms), {n} of {R} rows held; "
        "captured equals eager")


SEED_B = 0xC0FFEE0123456789   # a second seed, past 2^63 (negative int64)


def phase_seed_slots(dev):
    """K1's dropout branch, K2 and dropout_mask read their seed from device
    memory (``ops.attention.seed_slot``): at the training shape in bf16,
    each seed passed as a slot of a device table (at an offset) gives bit
    for bit what the same seed passed as an int gives (the wrapper writes
    it into a slot of its own), both kept in memory in this run; and a
    K1 + K2 pair captured in a CUDA graph, replayed after a new seed is
    written into its slot, equals the eager pair with that seed.  These
    launches are comparisons, not a main path: they are not counted."""
    from vlp_tpu_torch.ops import _build
    from vlp_tpu_torch.ops import attention as attn
    from vlp_tpu_torch.ops import philox

    g = torch.Generator(device=dev).manual_seed(7)
    B, L, H, P, rate = 64, 128, 12, 102, 0.1
    q, k, v, mode, te, ck, dout = train_inputs(g, dev, torch.bfloat16, B, L)
    seeds = (TRAIN_SEED, SEED_B)
    table = torch.tensor([0] + [philox.as_int64(x) for x in seeds],
                         dtype=torch.int64, device=dev)

    def pair(seed):
        out = attn._forward_cuda(q, k, v, mode, te, ck, P,
                                 dropout=(rate, seed))
        return (out, *attn._backward_cuda(q, k, v, mode, te, ck, dout, P,
                                          rate, seed))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    with _build.recording():
        for i, seed in enumerate(seeds):
            by_value, by_slot = pair(seed), pair(table[i + 1])
            masks = [attn.dropout_mask(B, H, L, rate, x, dev)
                     for x in (seed, table[i + 1])]
            torch.cuda.synchronize()
            if not same(by_value, by_slot):
                fail(f"K1/K2 with seed {seed:#x} in a device slot differ "
                     "from the seed passed as an int")
            if not torch.equal(*masks):
                fail(f"dropout_mask with seed {seed:#x} in a device slot "
                     "differs from the seed passed as an int")
        if same(pair(seeds[0]), pair(seeds[1])):
            fail("two seeds drew the same K1/K2 outputs")
        slot = torch.full((), philox.as_int64(seeds[0]), dtype=torch.int64,
                          device=dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = pair(slot)
        slot.fill_(philox.as_int64(seeds[1]))
        graph.replay()
        want = pair(seeds[1])
        torch.cuda.synchronize()
        if not same(captured, want):
            fail("a captured K1 + K2 pair replayed with a new seed in its "
                 "slot differs from the eager pair with that seed")
    log(f"seeds from device memory, B={B} L={L} bf16 rate {rate}: K1 "
        "dropout, K2 and dropout_mask bit-identical for a seed in a device "
        "slot and the same seed as an int (2 seeds); a captured K1 + K2 "
        "replayed with a new seed in its slot = the eager pair")


# the benchmark's two configurations, whose parameter sets phase 2f takes
ADAM_CONFIGS = (("vlp-base-coco-cap", False), ("vlp-base-vqa2", True))
ADAM_STEPS = 3
# runtime calls that put work on the device (benchmarks' launches metric)
LAUNCH_CALLS = ("launchkernel", "graphlaunch", "memcpy", "memset",
                "launchcooperativekernel")
ADAM_MAX_LAUNCHES = 12          # a fused BertAdam step's launch calls, at most
_PLAIN_ON_CUDA = []             # BertAdam._update calls on CUDA parameters


def guard_plain_update() -> None:
    """Record every call of the plain update (``BertAdam._update``) on
    CUDA parameters: ``BertAdam.step`` must take the kernel there, so
    ``main`` fails if any is recorded.  A gate runs the plain update on
    purpose through :func:`plain_update`, past the record."""
    from vlp_tpu_torch import optim as optim_lib
    plain = optim_lib.BertAdam._update

    def guarded(self, finite):
        if self.plan is not None:
            _PLAIN_ON_CUDA.append(len(self.params))
        return plain(self, finite)

    guarded.plain = plain
    optim_lib.BertAdam._update = guarded


def plain_update(opt, finite=None) -> None:
    """The plain update of ``opt`` (a gate's reference), unrecorded."""
    from vlp_tpu_torch import optim as optim_lib
    fn = optim_lib.BertAdam._update
    with torch.no_grad():
        getattr(fn, "plain", fn)(opt, finite)


def adam_param_set(config: str, vqa: bool, dev, seed: int) -> dict:
    """A benchmark configuration's parameters (names and shapes from a
    ``VLPModel`` on the meta device), N(0, 0.02) fp32 on ``dev``."""
    import dataclasses

    from vlp_tpu_torch.config import VLPConfig
    from vlp_tpu_torch.models.model import VLPModel
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "benchmarks", "configs", config + ".json")) as f:
        raw = json.load(f)
    fields = {fl.name for fl in dataclasses.fields(VLPConfig)}
    cfg = VLPConfig(**{k: v for k, v in raw.items() if k in fields})
    with torch.device("meta"):
        model = VLPModel(cfg, with_vqa=vqa)
    g = torch.Generator(device=dev).manual_seed(seed)
    return {n: torch.nn.Parameter(0.02 * torch.randn(
                p.shape, generator=g, device=dev))
            for n, p in model.named_parameters()}


def adam_twin(params, make):
    """(parameters cloned, ``make(their dict)``)."""
    twin = {n: torch.nn.Parameter(p.detach().clone())
            for n, p in params.items()}
    return twin, make(twin)


def adam_grads(params, g, none: str) -> dict:
    """Random gradients, alternately of norm ~3 (clipped) and ~0.3 (not);
    parameter ``none`` gets None."""
    out = {}
    for i, (n, p) in enumerate(params.items()):
        norm = 3.0 if i % 2 == 0 else 0.3
        out[n] = None if n == none else torch.randn(
            p.shape, generator=g, device=p.device) * (norm / p.numel() ** 0.5)
    return out


def set_grads(params, grads) -> None:
    for n, p in params.items():
        p.grad = None if grads[n] is None else grads[n].clone()


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 units in the last place between a and b, elementwise (int64:
    the distance of their bit patterns on the ordered integer line)."""
    def ordered(x):
        i = x.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(2 ** 31) - i, i)
    return (ordered(a) - ordered(b)).abs()


def clip_scales(sumsq: torch.Tensor) -> torch.Tensor:
    """_clip's scale from squared norms, as the plain update computes it."""
    from vlp_tpu_torch import optim as optim_lib
    norm = torch.sqrt(sumsq)
    return torch.where(norm > optim_lib.MAX_GRAD_NORM,
                       optim_lib.MAX_GRAD_NORM / (norm + optim_lib.CLIP_EPS),
                       torch.ones_like(norm))


def launch_calls(fn) -> int:
    """Runtime calls that put work on the device during ``fn()``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if any(c in e.key.lower() for c in LAUNCH_CALLS))


def adam_gate(params, make, g, none, label, steps=ADAM_STEPS) -> dict:
    """The fused update of ``make(params)`` against two plain twins over
    ``steps`` steps of the same random gradients (step 1 skipped through
    ``finite`` False, step 2 with ``finite`` True):

    * twin A takes the kernel's squared norms (``_sharded_sumsq``): every
      tensor, clipped or not, must equal the kernel's bit for bit in p, m
      and v: the update is the plain one, op for op;
    * twin B takes its own (``torch.sum``): the tensors that do not clip
      must equal the kernel's bit for bit; for those that clip, the
      kernel's clip scale must lie within 2 ulps of the scale from the
      exact (fp64) norm, and its distance from B's scale and B's p, m and
      v are reported (in ulps: B's fp32 sum has errors of its own, and
      an element whose moment nearly cancels has few bits to agree on);
    * a skipped step leaves p, m, v and the step count bit-identical;
    * each step launches each pass once, and at most ADAM_MAX_LAUNCHES
      runtime calls put work on the device."""
    from vlp_tpu_torch.ops import _build

    fused = make(params)
    twin_a, plain_a = adam_twin(params, make)
    twin_b, plain_b = adam_twin(params, make)
    plan = fused.plan
    order = {n: t for t, n in enumerate(plan.names)}
    worst = dict(scale_vs_exact=0, scale_vs_plain=0, p=0, m=0, v=0)
    clipped = set()
    for step in range(steps):
        finite = (None if step == 0 else
                  torch.tensor(step != 1, device=plan.device))
        grads = adam_grads(params, g, none)
        for ps in (params, twin_a, twin_b):
            set_grads(ps, grads)
        before = [t.clone() for t in (*params.values(), *fused.m.values(),
                                      *fused.v.values(), fused.step_count)]
        launches = {k: _build.KERNELS[k].launches for k in ADAM_KERNELS}
        fused.step(finite)
        torch.cuda.synchronize()
        if any(_build.KERNELS[k].launches != launches[k] + 1
               for k in ADAM_KERNELS):
            fail(f"BertAdam {label}: a step did not launch each pass once")
        sumsq = dict(zip(plan.names, plan.sumsq.clone().unbind()))
        plain_a._sharded_sumsq = lambda: sumsq
        plain_update(plain_a, finite)
        plain_update(plain_b, finite)
        torch.cuda.synchronize()
        if step == 1:
            after = [*params.values(), *fused.m.values(), *fused.v.values(),
                     fused.step_count]
            if not all(torch.equal(a, b) for a, b in zip(before, after)):
                fail(f"BertAdam {label}: a skipped step (finite False) "
                     "changed the state")
        mine = {n: (params[n], fused.m[n], fused.v[n]) for n in params}
        for n, (p, m, v) in mine.items():
            if not (torch.equal(p, twin_a[n]) and torch.equal(m, plain_a.m[n])
                    and torch.equal(v, plain_a.v[n])):
                fail(f"BertAdam {label} step {step}: {n} differs from the "
                     "plain update at the kernel's norm")
        exact = {n: (torch.zeros((), dtype=torch.float64, device=plan.device)
                     if grads[n] is None else
                     grads[n].double().pow(2).sum()) for n in params}
        for n, (p, m, v) in mine.items():
            if grads[n] is not None and float(sumsq[n].sqrt()) > 1.0:
                clipped.add(n)
                s_k = clip_scales(sumsq[n])
                s_b = clip_scales(torch.sum(grads[n] * grads[n]))
                s_x = (1.0 / (exact[n].sqrt() + 1e-6)).float()
                worst["scale_vs_exact"] = max(worst["scale_vs_exact"],
                                              int(ulps(s_k, s_x)))
                worst["scale_vs_plain"] = max(worst["scale_vs_plain"],
                                              int(ulps(s_k, s_b)))
                for key, x, y in (("p", p, twin_b[n]), ("m", m, plain_b.m[n]),
                                  ("v", v, plain_b.v[n])):
                    worst[key] = max(worst[key], int(ulps(x, y).max()))
            elif not (torch.equal(p, twin_b[n])
                      and torch.equal(m, plain_b.m[n])
                      and torch.equal(v, plain_b.v[n])):
                fail(f"BertAdam {label} step {step}: {n}, not clipped, "
                     "differs from the plain update")
        if int(fused.step_count) != int(plain_b.step_count):
            fail(f"BertAdam {label}: step count {int(fused.step_count)}, "
                 f"plain {int(plain_b.step_count)}")
    if worst["scale_vs_exact"] > 2:
        fail(f"BertAdam {label}: a clip scale {worst['scale_vs_exact']} "
             "ulps from the exact one")
    with_grads = sum(x is not None for x in grads.values())
    if not clipped or len(clipped) == with_grads:
        fail(f"BertAdam {label}: the gradients clipped {len(clipped)} "
             "tensors: not some of them")
    calls = launch_calls(fused.step)
    plain_calls = launch_calls(lambda: plain_update(plain_b))
    if calls > ADAM_MAX_LAUNCHES:
        fail(f"BertAdam {label}: {calls} launch calls a step, not <= "
             f"{ADAM_MAX_LAUNCHES}")
    rep = dict(tensors=len(params), clipped=len(clipped),
               launch_calls=calls, plain_launch_calls=plain_calls,
               max_ulps_vs_plain_norms=worst)
    log(f"BertAdam {label}: {rep}")
    del fused, plain_a, plain_b, twin_a, twin_b
    return rep


def phase_fused_adam(dev, results):
    """The fused BertAdam update (``csrc/bert_adam.cu``) against the plain
    one on the card at both benchmark configurations' parameter sets (210
    and 214 tensors; :func:`adam_gate`), the caption set also with
    fine-tune anchors (fresh heads anchored at zero) and with weight decay
    0; a captured step replayed twice against two eager steps, bit for
    bit; then the kernel's time (both passes, and the whole step with the
    schedule's scalar ops) beside its bound (32 bytes an element) and the
    plain update's time (host-bound: also its device time from the
    profiler)."""
    from vlp_tpu_torch import optim as optim_lib
    from vlp_tpu_torch.ops import _build

    g = torch.Generator(device=dev).manual_seed(21)
    norms_r, update_r = {}, {}
    for config, vqa in ADAM_CONFIGS:
        params = adam_param_set(config, vqa, dev, 1)
        none = next(n for n in params if "pooler" in n) if any(
            "pooler" in n for n in params) else list(params)[-1]

        def make(ps):
            return optim_lib.BertAdam(ps, 3e-5, warmup=0.1, t_total=100)
        gates = {"plain": adam_gate(params, make, g, none, config)}
        if not vqa:
            init = {n: p.detach() + 0.01 for n, p in params.items()}

            def finetune(ps):
                return optim_lib.bert_adam_finetune(
                    ps, 3e-5, init_params=init, warmup=0.1, t_total=100,
                    missing_key_substrings=("cls.",))
            gates["anchors"] = adam_gate(params, finetune, g, none,
                                         config + " anchors", steps=2)
            del init
            gates["weight_decay_0"] = adam_gate(
                params, lambda ps: optim_lib.BertAdam(ps, 3e-5,
                                                      weight_decay=0.0),
                g, none, config + " weight_decay 0", steps=2)
            # a captured step, replayed twice, against two eager steps
            grads = adam_grads(params, g, none)
            eager = make(params)
            twin, captured = adam_twin(params, make)
            set_grads(params, grads)
            set_grads(twin, grads)
            captured.plan.refresh()
            graph = torch.cuda.CUDAGraph()
            with _build.recording() as rec, torch.cuda.graph(graph):
                captured.step()
            if dict(rec) != adam_launches(1):
                fail(f"BertAdam captured step recorded {dict(rec)}")
            for _ in range(2):
                eager.step()
                graph.replay()
            torch.cuda.synchronize()
            same = all(torch.equal(params[n], twin[n])
                       and torch.equal(eager.m[n], captured.m[n])
                       and torch.equal(eager.v[n], captured.v[n])
                       for n in params)
            if not same or int(captured.step_count) != 2:
                fail("BertAdam: a captured step replayed twice differs from "
                     "two eager steps")
            log("BertAdam: a captured step replayed twice = two eager steps, "
                "bit for bit")
            del graph, eager, captured, twin
        # times: a fresh optimizer on fixed gradients
        set_grads(params, adam_grads(params, g, none))
        opt = make(params)
        twin, plain = adam_twin(params, make)
        set_grads(twin, {n: p.grad for n, p in params.items()})
        opt.step()
        plan = opt.plan
        lr_t = opt.lr_at(opt.step_count)
        numel = sum(p.numel() for p in params.values())
        with _build.recording():
            norms_ms = time_ms(plan.norms)
            kernel_ms = time_ms(lambda: (plan.norms(), plan.update(
                lr_t, None, opt.step_count, opt.weight_decay)))
            step_ms = time_ms(opt.step)
        plain_time = plain_ms(lambda: plain_update(plain))
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            plain_update(plain)
            torch.cuda.synchronize()
        plain_device_ms = sum(e.self_device_time_total
                              for e in prof.key_averages()) / 1e3
        key = "vqa" if vqa else "caption"
        norms_r[key] = dict(tensors=len(params), ms=norms_ms,
                            **bound(4 * numel, 0))
        update_r[key] = dict(
            tensors=len(params), params=numel, chunks=plan.n_chunks,
            blocks=plan._blocks, ms=kernel_ms, step_ms=step_ms,
            plain_ms=plain_time, plain_device_ms=plain_device_ms,
            **bound(32 * numel, 0), gates=gates)
        log(f"BertAdam {config} ({len(params)} tensors, {numel} elements, "
            f"{plan.n_chunks} chunks, {plan._blocks} blocks): kernel "
            f"{kernel_ms:.4f} ms (norms {norms_ms:.4f}), step {step_ms:.4f} "
            f"ms, bound {update_r[key]['bound_ms']:.4f} ms "
            f"({100 * update_r[key]['bound_ms'] / kernel_ms:.1f}%); plain "
            f"{plain_time:.4f} ms (device {plain_device_ms:.4f} ms)")
        del opt, plain, twin, params
        torch.cuda.empty_cache()
    results["bert_adam_norms"] = norms_r
    results["bert_adam_update"] = update_r


def bhld_inputs(g, dev, dtype, strided=False, B=64, L=128, H=12, P=102):
    """[B, H, L, 64] q/k/v and dout at the training shape, mixed modes,
    zeros in colkeep; ``strided``: q/k/v are slices of one [B, H, L, 192]
    tensor (row stride 192, not 64)."""
    from vlp_tpu_torch.config import MODE_BI, MODE_S2S
    D = 64
    if strided:
        qkv = torch.randn(B, H, L, 3 * D, generator=g, device=dev).to(dtype)
        q, k, v = qkv.split(D, dim=-1)
    else:
        q, k, v = (torch.randn(B, H, L, D, generator=g, device=dev).to(dtype)
                   for _ in range(3))
    mode = torch.tensor([MODE_S2S, MODE_BI] * (B // 2), device=dev)
    te = torch.randint(P + 1, L + 1, (B,), generator=g, device=dev)
    ck = torch.ones(B, L, device=dev)
    ck[:, 1:P - 1] = (torch.rand(B, P - 2, generator=g, device=dev)
                      > 0.3).float()
    dout = torch.randn(B, H, L, D, generator=g, device=dev).to(dtype)
    return q, k, v, mode.int(), te.int(), ck, dout


def phase_bhld_kernels(dev, results):
    """The [B, H, L, D] pair (counterparts of ``_fwd_kernel`` and
    ``_bwd_kernel``) at the training shape B=64, L=128, H=12, D=64: the
    forward (both branches) and the backward against their plain versions
    in fp32, bf16 and fp16, on contiguous and on strided inputs; then, with
    dropout 0.1, bit for bit against the blhd kernels (K1, K2) on the
    transposed inputs.  Times in bf16 and fp16 (``form_times``, the
    dropout branch at rate 0.1; the library call is SDPA in its own
    [B, H, L, D] layout)."""
    from vlp_tpu_torch.ops import attention as attn

    g = torch.Generator(device=dev).manual_seed(6)
    B, L, H, D, P = 64, 128, 12, 64, 102
    seed, rate = seed_arg(attn, 0x243F6A8885A308D3, dev), 0.1

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        fwd, drop, bwd = (kname(n, dtype) for n in FORMS["bhld"])
        for strided in (False, True):
            q, k, v, mode, te, ck, dout = bhld_inputs(g, dev, dtype, strided)
            tag = (f"B={B} L={L} {dtype} ({body(dtype)})"
                   f"{' strided' if strided else ''}")
            note_err(results, fwd, compare(
                f"{fwd} {tag}",
                attn.attention(q, k, v, mode, te, ck, prefix=P,
                               layout="bhld"),
                attn.attention_plain(q, k, v, mode, te, ck, prefix=P,
                                     layout="bhld"), TOL[dtype]))
            for r in (0.0, rate):
                kw = dict(prefix=P, dropout_rate=r, seed=seed, layout="bhld")
                note_err(results, drop, compare(
                    f"{drop} {tag} rate={r}",
                    attn._forward_cuda(q, k, v, mode, te, ck, P,
                                       dropout=(r, seed), layout="bhld"),
                    attn.attention_plain(q, k, v, mode, te, ck, **kw),
                    TOL[dtype]))
                got = attn._backward_cuda(q, k, v, mode, te, ck, dout, P, r,
                                          seed, "bhld")
                want = attn.attention_bwd_plain(q, k, v, mode, te, ck, dout,
                                                **kw)
                for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
                    if a.shape != (B, H, L, D) or not a.is_contiguous():
                        fail(f"{bwd} {name}: not a contiguous [B, H, L, D] "
                             "tensor")
                    note_err(results, bwd, compare(
                        f"{bwd} {name} {tag} rate={r}", a, b_, TOL[dtype]))

        # the same seed draws the same multipliers in both layouts
        q, k, v, mode, te, ck, dout = bhld_inputs(g, dev, dtype)
        tq, tk, tv, tdo = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, dout))
        pairs = [("deterministic forward",
                  attn.attention(q, k, v, mode, te, ck, prefix=P,
                                 layout="bhld"),
                  attn.attention(tq, tk, tv, mode, te, ck, prefix=P)),
                 ("dropout forward",
                  attn._forward_cuda(q, k, v, mode, te, ck, P,
                                     dropout=(rate, seed), layout="bhld"),
                  attn._forward_cuda(tq, tk, tv, mode, te, ck, P,
                                     dropout=(rate, seed)))]
        pairs += zip(("dq", "dk", "dv"),
                     attn._backward_cuda(q, k, v, mode, te, ck, dout, P, rate,
                                         seed, "bhld"),
                     attn._backward_cuda(tq, tk, tv, mode, te, ck, tdo, P,
                                         rate, seed))
        torch.cuda.synchronize()
        for what, a, b_ in pairs:
            b_ = b_.transpose(1, 2)
            if not torch.equal(a, b_):
                diff = (a.float() - b_.float()).abs().max().item()
                fail(f"bhld vs blhd {dtype} rate={rate}: {what} differs "
                     f"(max {diff:.3e})")
        log(f"bhld vs blhd on transposed inputs, {dtype}, dropout {rate}: "
            f"forward and dq/dk/dv bit for bit")

    # times at the main path's shape: contiguous, rate 0.1
    for dtype in (torch.bfloat16, torch.float16):
        for name, r in form_times(attn, *bhld_inputs(g, dev, dtype), P, rate,
                                  seed, "bhld").items():
            results[name].update(r)
            log_times(name, r, ", SDPA in bhld")


FP16_GATE_LENS = (103, 128, 256, 528)   # ragged, one block, the tiled body


def phase_fp16_kernels(dev, results):
    """The fp16 forms of K1 and K2 (``--true_fp16``; the 16-bit bodies
    instantiated for fp16) beyond the B=64 gates of the phases above: at
    FP16_GATE_LENS, B=16, both layouts, rate 0 and 0.1, each against its
    plain version run in fp16 within FP16_TOL, and bhld = blhd on
    transposed inputs bit for bit; the keep bits of the forward and the
    backward equal ``dropout_mask``'s (q = k = 0 in bi mode makes
    P = 1/L, and an identity V or dO shows P o keep); one inf or NaN in dO
    leaves dQ, dK and dV non-finite.  Then each fp16 form's time beside
    its bf16 body's (``bf16_ms``, from the phases above) at L=128 and
    256."""
    from vlp_tpu_torch.config import MODE_BI
    from vlp_tpu_torch.ops import attention as attn

    g = torch.Generator(device=dev).manual_seed(16)
    B, H, P = 16, 12, 102
    seed, rate = seed_arg(attn, 0x6A09E667F3BCC908, dev), 0.1
    f16 = torch.float16

    for L in FP16_GATE_LENS:
        q, k, v, mode, te, ck, dout = train_inputs(g, dev, f16, B, L)
        te = torch.randint(P + 1, L + 1, (B,), generator=g,
                           device=dev).int()
        tr = [t.transpose(1, 2).contiguous() for t in (q, k, v, dout)]
        got = {}
        for layout, (a, b_, c, d) in (("blhd", (q, k, v, dout)),
                                      ("bhld", tr)):
            fwd, drop, bwd = (kname(n, f16) for n in FORMS[layout])
            kw = dict(prefix=P, layout=layout)
            tag = f"B={B} L={L} {layout}"
            note_err(results, fwd, compare(
                f"{fwd} {tag}", attn.attention(a, b_, c, mode, te, ck, **kw),
                attn.attention_plain(a, b_, c, mode, te, ck, **kw),
                FP16_TOL))
            for r in (0.0, rate):
                outs = [attn._forward_cuda(a, b_, c, mode, te, ck, P,
                                           dropout=(r, seed), layout=layout),
                        *attn._backward_cuda(a, b_, c, mode, te, ck, d, P, r,
                                             seed, layout)]
                note_err(results, drop, compare(
                    f"{drop} {tag} rate={r}", outs[0], attn.attention_plain(
                        a, b_, c, mode, te, ck, dropout_rate=r, seed=seed,
                        **kw), FP16_TOL))
                want = attn.attention_bwd_plain(a, b_, c, mode, te, ck, d,
                                                dropout_rate=r, seed=seed,
                                                **kw)
                for name, x, y in zip(("dq", "dk", "dv"), outs[1:], want):
                    note_err(results, bwd, compare(
                        f"{bwd} {name} {tag} rate={r}", x, y, FP16_TOL))
                if r:
                    got[layout] = outs
        torch.cuda.synchronize()
        if not all(torch.equal(x.transpose(1, 2), y)
                   for x, y in zip(got["bhld"], got["blhd"])):
            fail(f"fp16 L={L}: bhld differs from blhd on transposed inputs")
        log(f"fp16 K1/K2 L={L}: bhld = blhd bit for bit (rate {rate})")
        del q, k, v, dout, tr, got

    # the keep bits the fp16 kernels drew are dropout_mask's
    for Bk, L in ((64, 128), (16, 528)):
        z = torch.zeros(Bk, L, H, 64, dtype=f16, device=dev)
        eye = torch.zeros_like(z)
        eye[:, torch.arange(64), :, torch.arange(64)] = 1.0
        md = torch.full((Bk,), MODE_BI, dtype=torch.int32, device=dev)
        full = torch.full((Bk,), L, dtype=torch.int32, device=dev)
        ones = torch.ones(Bk, L, device=dev)
        out = attn._forward_cuda(z, z, eye, md, full, ones, P,
                                 dropout=(rate, seed))
        dv = attn._backward_cuda(z, z, z, md, full, ones, eye, P, rate,
                                 seed)[2]
        keep = attn.dropout_mask(Bk, H, L, rate, seed, dev) > 0
        torch.cuda.synchronize()
        if not (torch.equal(out[..., :64].permute(0, 2, 1, 3) != 0,
                            keep[..., :64])
                and torch.equal(dv[..., :64].permute(0, 2, 3, 1) != 0,
                                keep[:, :, :64, :])):
            fail(f"fp16 B={Bk} L={L}: the kernels' keep bits differ from "
                 "dropout_mask's")
        log(f"fp16 K1/K2 B={Bk} L={L}: keep bits = dropout_mask's "
            f"(forward: every row x keys 0-63; backward: rows 0-63 x every "
            f"key)")
        del z, eye, out, dv, keep

    # a non-finite dO reaches every gradient (the loss scaler reads them)
    for L in (128, 256):
        q, k, v, mode, te, ck, dout = train_inputs(g, dev, f16, B, L)
        for bad in (float("inf"), float("nan")):
            d = dout.clone()
            d[0, 5, 1, 7] = bad
            grads = attn._backward_cuda(q, k, v, mode, te, ck, d, P, rate,
                                        seed)
            torch.cuda.synchronize()
            if any(torch.isfinite(x).all() for x in grads):
                fail(f"fp16 K2 L={L}: a {bad} in dO left a gradient finite")
        log(f"fp16 K2 L={L}: an inf or a NaN in dO makes dq, dk, dv "
            "non-finite")

    # each fp16 form beside its bf16 body, both timed in the phases above
    for name in FORMS["blhd"] + FORMS["bhld"]:
        r16, r = results[name + "_fp16"], results[name]
        r16["bf16_ms"] = r.get("train_shape", r)["ms"]
        r16["L256"]["bf16_ms"] = r["L256"]["ms"]
        log(f"{name}_fp16 B=64: L=128 {r16['ms']:.4f} ms (bf16 body "
            f"{r16['bf16_ms']:.4f}), L=256 {r16['L256']['ms']:.4f} ms (bf16 "
            f"body {r16['L256']['bf16_ms']:.4f})")


def phase_fp16_main_path(vocab_path, out_dir):
    """``cli.train --true_fp16`` at bert-base width through the fp16 K1
    dropout and K2, with dynamic loss scaling: the COCO fine-tune flags of
    phase 4b, B=64, 1 epoch of 20 steps, then a rerun for 2 epochs that
    resumes at epoch 2.  Exact launch counts over both runs; finite
    losses; the scale state of optim.1.bin and optim.2.bin consistent with
    the steps each holds (each skipped step halves the scale from 2^15 and
    does not advance BertAdam's step) and restored across the resume.
    Then, outside the counts, a skipped step on the card: an inf feature
    leaves params and moments as they were and halves the scale."""
    from vlp_tpu_torch.cli import train as train_cli
    from vlp_tpu_torch.ops import _build

    spe = TRAIN_STEPS[1]
    out = os.path.join(out_dir, "train_fp16")
    base = ["--do_train", "--true_fp16", "--new_segment_ids",
            "--enable_butd", "--bert_model", vocab_path, "--do_lower_case",
            "--dataset", "coco", "--max_pred", "20", "--mask_prob", "0.15",
            "--train_batch_size", "64", "--learning_rate", "3e-5",
            "--s2s_prob", "1", "--bi_prob", "0", "--synthetic_data",
            "--steps_per_epoch", str(spe), "--output_dir", out,
            "--device", "cuda"]
    _build.reset_launch_counts()
    first = train_cli.main(base + ["--num_train_epochs", "1"])
    second = train_cli.main(base + ["--num_train_epochs", "2"])
    torch.cuda.synchronize()
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    n = 12 * 2 * spe
    want = {k: (n if k in ("attention_fwd_drop_fp16", "attention_bwd_fp16")
                else 0) for k in counts}
    want.update(adam_launches(2 * spe))
    log(f"true-fp16 train launch counts {counts}, expected {want}")
    if counts != want:
        fail("the --true_fp16 train path did not launch the fp16 kernels "
             "as expected")
    losses = np.asarray(first["losses"] + second["losses"])
    if len(losses) != 2 * spe or not np.isfinite(losses).all():
        fail(f"--true_fp16 main path: bad losses {losses}")
    if first["model"].dtype != torch.float16:
        fail("--true_fp16 did not train in fp16")
    with open(os.path.join(out, "training.log")) as f:
        text = f.read()
    for line in ("true-fp16: fp16 activations + dynamic loss scaling",
                 "Recover model: 1"):
        if line not in text:
            fail(f"--true_fp16 main path: {line!r} not in the log")
    states = {}
    for epoch in (1, 2):
        opt = torch.load(os.path.join(out, f"optim.{epoch}.bin"),
                         map_location="cpu", weights_only=True)
        ls, step = opt["loss_scale"], opt["step"]
        skipped = epoch * spe - step
        states[epoch] = dict(ls, step=step, skipped=skipped)
        if ls["scale"] * 2.0 ** skipped != 2.0 ** 15:
            fail(f"optim.{epoch}.bin: scale {ls['scale']} after {skipped} "
                 f"skipped steps of {epoch * spe} (from 2^15)")
    log(f"true-fp16 scale state: optim.1.bin {states[1]}, optim.2.bin "
        f"{states[2]}; losses first 10 mean {losses[:10].mean():.4f}, "
        f"last 10 {losses[-10:].mean():.4f}")
    rates = {"train_fp16_scale_state": states}
    rates["train_fp16_skip"] = fp16_skipped_step(torch.device("cuda"))
    rates["train_fp16_group_skip"] = fp16_group_skip(torch.device("cuda"))
    return counts, rates


def fp16_skipped_step(dev, B=8, seed=3, cfg=None) -> dict:
    """One good loss-scaled step of an fp16 model (bert-base unless
    ``cfg``) on ``dev``, then a batch with an inf region feature: the step
    is skipped, so every parameter and both moments stay as they were (bit
    for bit), BertAdam's step does not advance, and the scale halves."""
    from vlp_tpu_torch import optim as optim_lib
    from vlp_tpu_torch import train_step as ts
    from vlp_tpu_torch.config import VLPConfig
    from vlp_tpu_torch.models.model import VLPModel

    cfg = cfg or VLPConfig(dtype="float16", vocab_size=28996,
                           type_vocab_size=6)
    model = VLPModel(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    model.to(dev)
    opt = optim_lib.BertAdam(dict(model.named_parameters()), 3e-5,
                             warmup=0.1, t_total=100)
    ls = optim_lib.DynamicLossScale()
    step = ts.make_train_step(model, opt, loss_scale=ls)
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = ts.dummy_batch(cfg, B, device=dev)
    batch["input_ids"] = torch.randint(5, cfg.vocab_size, batch[
        "input_ids"].shape, generator=g, device=dev).int()
    batch["masked_pos"] = torch.randint(cfg.prefix_len, cfg.seq_len, batch[
        "masked_pos"].shape, generator=g, device=dev).int()
    batch["masked_ids"] = torch.randint(5, cfg.vocab_size, batch[
        "masked_ids"].shape, generator=g, device=dev).int()
    batch["masked_weights"].fill_(1.0)
    batch["vis_feats"] = torch.randn(batch["vis_feats"].shape, generator=g,
                                     device=dev)
    good = step(batch, 1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    m_before = {n: t.clone() for n, t in opt.m.items()}
    v_before = {n: t.clone() for n, t in opt.v.items()}
    scale, n_step = float(opt.loss_scale["scale"]), int(opt.step_count)
    bad = dict(batch, vis_feats=batch["vis_feats"].clone())
    bad["vis_feats"][0, 0, 0] = float("inf")
    m = step(bad, 2)
    torch.cuda.synchronize()
    kept = all(torch.equal(p, before[n]) and torch.equal(opt.m[n], m_before[n])
               and torch.equal(opt.v[n], v_before[n])
               for n, p in model.named_parameters())
    out = dict(good_loss=float(good["loss"]),
               good_skipped=float(good["skipped_step"]),
               skipped=float(m["skipped_step"]), scale_before=scale,
               scale_after=float(opt.loss_scale["scale"]),
               step_before=n_step, step_after=int(opt.step_count),
               params_and_moments_kept=kept)
    log(f"true-fp16 skipped step at bert-base, B={B}: {out}")
    if not (out["skipped"] == 1.0 and kept
            and out["scale_after"] == scale / 2
            and out["step_after"] == n_step
            and out["good_skipped"] == 0.0
            and np.isfinite(out["good_loss"])):
        fail("an overflow did not skip the fp16 step as it should")
    return out


def fp16_batch(cfg, B, g, dev):
    """fp16_skipped_step's batch: random tokens, targets and features."""
    from vlp_tpu_torch import train_step as ts
    batch = ts.dummy_batch(cfg, B, device=dev)
    for key, lo, hi in (("input_ids", 5, cfg.vocab_size),
                        ("masked_pos", cfg.prefix_len, cfg.seq_len),
                        ("masked_ids", 5, cfg.vocab_size)):
        batch[key] = torch.randint(lo, hi, batch[key].shape, generator=g,
                                   device=dev).int()
    batch["masked_weights"].fill_(1.0)
    batch["vis_feats"] = torch.randn(batch["vis_feats"].shape, generator=g,
                                     device=dev)
    return batch


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (its own CUDA embedding backward
    sums in a run-to-run order otherwise: phase 4h), without the NaN fill
    of new tensors, whose writes a timed run would include."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def fp16_group_skip(dev, **kw) -> dict:
    """``_fp16_group_skip`` under deterministic algorithms."""
    with deterministic():
        return _fp16_group_skip(dev, **kw)


def _fp16_group_skip(dev, B=8, K=LOOP_K, bad=2, seed=5) -> dict:
    """A K-step group of the fp16 device loop (one CUDA-graph replay,
    dynamic loss scaling, dropout 0.1) whose step ``bad`` has an inf region
    feature, against the same K steps taken one at a time by a twin model:
    only step ``bad`` is skipped, the scale halves once, BertAdam's step
    advances K - 1 times, and parameters, moments and losses equal the
    eager twin's bit for bit (bert-base width, GROUP_SKIP_LAYERS deep,
    B=8)."""
    from vlp_tpu_torch import optim as optim_lib
    from vlp_tpu_torch import train_step as ts
    from vlp_tpu_torch.config import VLPConfig
    from vlp_tpu_torch.models.model import VLPModel

    cfg = VLPConfig(dtype="float16", vocab_size=28996, type_vocab_size=6,
                    num_hidden_layers=GROUP_SKIP_LAYERS)
    twins = []
    for _ in range(2):
        model = VLPModel(cfg)
        model.init_weights(torch.Generator().manual_seed(seed))
        model.to(dev)
        opt = optim_lib.BertAdam(dict(model.named_parameters()), 3e-5,
                                 warmup=0.1, t_total=100)
        twins.append((model, opt))
    ls = optim_lib.DynamicLossScale()
    g = torch.Generator(device=dev).manual_seed(seed)
    batches = [fp16_batch(cfg, B, g, dev) for _ in range(K)]
    batches[bad]["vis_feats"][0, 0, 0] = float("inf")
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    seeds = [ts.step_seed(seed, i) for i in range(K)]
    (gm, gopt), (em, eopt) = twins
    group = ts.make_multi_step(gm, gopt, K=K, loss_scale=ls)(stacked, seeds)
    step = ts.make_train_step(em, eopt, loss_scale=ls)
    eager = ts.stack_metrics([step(b, s) for b, s in zip(batches, seeds)])
    torch.cuda.synchronize()
    skipped = [float(x) for x in group["skipped_step"]]
    differ = [n for (n, p), q in zip(gm.named_parameters(), em.parameters())
              if not torch.equal(p, q)]
    differ += [f"{key}.{n}" for key in ("m", "v") for n in gopt.m
               if not torch.equal(getattr(gopt, key)[n],
                                  getattr(eopt, key)[n])]
    if not torch.equal(group["loss"].nan_to_num(),
                       eager["loss"].nan_to_num()):
        differ.append(f"losses {group['loss'].tolist()} vs "
                      f"{eager['loss'].tolist()}")
    same = not differ
    out = dict(skipped=skipped,
               eager_skipped=[float(x) for x in eager["skipped_step"]],
               scale=float(gopt.loss_scale["scale"]),
               eager_scale=float(eopt.loss_scale["scale"]),
               step=int(gopt.step_count), replay_equals_eager=same,
               differ=differ[:5])
    log(f"true-fp16 group of {K} (one replay) with an overflow in step "
        f"{bad}, bert-base width {GROUP_SKIP_LAYERS} layers, B={B}: "
        f"{out}")
    want = [1.0 if i == bad else 0.0 for i in range(K)]
    if not (skipped == want == out["eager_skipped"] and same
            and out["scale"] == out["eager_scale"] == 2.0 ** 14
            and out["step"] == K - 1):
        fail("an overflow inside a device-loop group did not skip exactly "
             "its step")
    return out


# phase 4i: the device loop's modes, each a twin captured in groups of
# LOOP_MODE_K against an eager twin (bert-base width, GROUP_SKIP_LAYERS
# deep, B=LOOP_MODE_B, dropout 0.1), over LOOP_MODE_GROUPS replays; the
# CLI flags each stands for in the comment
LOOP_MODE_K, LOOP_MODE_GROUPS, LOOP_MODE_B = 2, 3, 8
LOOP_MODES = {
    "plain": {},
    "accum": dict(grad_accum=2),        # --gradient_accumulation_steps 2
    "vqa2": dict(task="vqa2"),          # --tasks vqa2
    # --true_fp16 --loss_scale 128
    "static_loss_scale": dict(dtype="float16", static_scale=128.0),
    # --max_drop_worst_ratio 0.25 --drop_after 1: the ratio switches on
    # after the first group, so the graph is captured again
    "drop_after": dict(ratios=(0.0, 0.25, 0.25)),
}


def loop_mode_twin(spec, dev, seed=7):
    """A model and its BertAdam for one LOOP_MODES entry."""
    from vlp_tpu_torch import optim as optim_lib
    from vlp_tpu_torch.config import VLPConfig
    from vlp_tpu_torch.models.model import VLPModel

    cfg = VLPConfig(dtype=spec.get("dtype", "bfloat16"), vocab_size=28996,
                    type_vocab_size=6, num_hidden_layers=GROUP_SKIP_LAYERS)
    model = VLPModel(cfg, with_vqa=spec.get("task") == "vqa2")
    model.init_weights(torch.Generator().manual_seed(seed))
    model.to(dev)
    return model, optim_lib.BertAdam(dict(model.named_parameters()), 1e-4,
                                     warmup=0.1, t_total=100)


def loop_mode_batches(cfg, spec, dev, n, seed=7):
    """``n`` random batches of LOOP_MODE_B (fp16_group_skip's, plus soft
    answer scores and bi mode for VQA)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(n):
        b = fp16_batch(cfg, LOOP_MODE_B, g, dev)
        if spec.get("task") == "vqa2":
            b["mode"].zero_()
            hit = torch.rand((LOOP_MODE_B, cfg.num_answers), generator=g,
                             device=dev) < 0.002
            b["ans_scores"] = hit * torch.rand(hit.shape, generator=g,
                                               device=dev)
        out.append(b)
    return out


def loop_mode_run(spec, dev, batches, seeds, captured, stale=None):
    """The steps of ``batches`` on a fresh twin: as LOOP_MODE_GROUPS
    replays of a captured group (``captured``) from one set of staging
    buffers, or one eager step at a time.  ``stale`` (a control) leaves
    the attention seed slots ("attention") or the hidden-dropout
    generators' seeds ("hidden") of every group after the first as the
    first group's.  Returns (losses, model, optimizer, loop)."""
    from vlp_tpu_torch import optim as optim_lib
    from vlp_tpu_torch import train_step as ts

    K = LOOP_MODE_K
    ratios = spec.get("ratios", (0.0,) * LOOP_MODE_GROUPS)
    ls = (optim_lib.DynamicLossScale(init_scale=spec["static_scale"],
                                     static=True)
          if "static_scale" in spec else None)
    model, opt = loop_mode_twin(spec, dev)
    kw = dict(task=spec.get("task", "img2txt"),
              grad_accum=spec.get("grad_accum", 1), loss_scale=ls)
    losses = []
    if not captured:
        step = ts.make_train_step(model, opt, **kw)
        for i, (b, s) in enumerate(zip(batches, seeds)):
            losses.append(float(step(b, s, ratios[i // K])["loss"]))
        return losses, model, opt, None
    multi = ts.make_multi_step(model, opt, K=K, **kw)
    staged = {k: torch.empty((K,) + tuple(v.shape), dtype=v.dtype,
                             device=dev) for k, v in batches[0].items()}
    for grp in range(LOOP_MODE_GROUPS):
        rows = range(grp * K, (grp + 1) * K)
        for k, buf in staged.items():
            buf.copy_(torch.stack([batches[i][k] for i in rows]))
        out = multi(staged, [seeds[i] for i in rows], ratios[grp])
        losses += [float(x) for x in out["loss"]]
        if grp == 0 and stale is not None:
            plan = multi._plan

            def stale_plan(group_seeds, plan=plan):
                keep = (multi.slots.clone(), [r[:] for r in multi._hidden])
                plan(group_seeds)
                if stale == "attention":
                    multi.slots.copy_(keep[0])
                else:
                    multi._hidden = keep[1]

            multi._plan = stale_plan
    return losses, model, opt, multi


def loop_mode_differ(a, b) -> list:
    """What differs, bit for bit, between two runs of loop_mode_run."""
    (la, ma, oa, _), (lb, mb, ob, _) = a, b
    differ = [] if la == lb else [f"losses {la} vs {lb}"]
    differ += [n for (n, p), q in zip(ma.named_parameters(),
                                      mb.parameters())
               if not torch.equal(p, q)]
    differ += [f"{key}.{n}" for key in ("m", "v") for n in oa.m
               if not torch.equal(getattr(oa, key)[n], getattr(ob, key)[n])]
    if not torch.equal(oa.step_count, ob.step_count):
        differ.append("step_count")
    return differ


def phase_loop_modes(dev) -> dict:
    """The device loop's modes that phase 4h's recipe leaves out
    (LOOP_MODES: gradient accumulation, VQA, a static loss scale, the
    drop-worst ratio switching on at --drop_after), each captured once (the
    ratio's switch: twice) and replayed LOOP_MODE_GROUPS times, bit-equal
    to the same steps taken one at a time under deterministic algorithms:
    losses, parameters, BertAdam's moments and step.  Then two controls on
    the plain mode, whose replays after the first reuse the first group's
    attention seed slots or its hidden-dropout seeds: each must differ
    from the eager steps, which shows the check sees stale seeds."""
    from vlp_tpu_torch.config import VLPConfig

    K, G = LOOP_MODE_K, LOOP_MODE_GROUPS
    seeds = [(1 << 40) + 977 * i for i in range(K * G)]
    out = {}
    with deterministic():
        for name, spec in LOOP_MODES.items():
            cfg = VLPConfig(dtype=spec.get("dtype", "bfloat16"),
                            vocab_size=28996, type_vocab_size=6)
            batches = loop_mode_batches(cfg, spec, dev, K * G)
            eager = loop_mode_run(spec, dev, batches, seeds, False)
            runs = {None: loop_mode_run(spec, dev, batches, seeds, True)}
            if name == "plain":
                for stale in ("attention", "hidden"):
                    runs[stale] = loop_mode_run(spec, dev, batches, seeds,
                                                True, stale=stale)
            torch.cuda.synchronize()
            for stale, run in runs.items():
                loop = run[3]
                key = name if stale is None else f"{name}_stale_{stale}"
                out[key] = dict(differ=loop_mode_differ(run, eager)[:4],
                                captures=loop.captures,
                                replays=loop.replays)
            if not all(np.isfinite(eager[0])) or len(set(eager[0])) < K * G:
                fail(f"device loop mode {name}: eager losses {eager[0]}")
            del eager, runs
    for key, r in out.items():
        log(f"device loop mode {key} (K={K}, {G} replays, bert-base width "
            f"{GROUP_SKIP_LAYERS} layers, B={LOOP_MODE_B}, deterministic "
            f"algorithms) against the eager steps: {r}")
    for name, spec in LOOP_MODES.items():
        r = out[name]
        want = len(set(spec.get("ratios", (0.0,))))
        if r["differ"] or r["captures"] != want or r["replays"] != G:
            fail(f"device loop mode {name}: {r}, not bit-equal to the "
                 f"eager steps over {want} capture(s) and {G} replays")
    for stale in ("attention", "hidden"):
        if not out[f"plain_stale_{stale}"]["differ"]:
            fail(f"the device loop's check did not see stale {stale} "
                 "dropout seeds")
    return out


KIMI_LAYERS = 2      # phase 4j: the dense layer and one MoE layer
KIMI_B, KIMI_K, KIMI_GROUPS = 16, 2, 2


def kimi_twin(dev, cfg, seed=11):
    """Kimi-VL's model (published widths, KIMI_LAYERS deep, 8 of 64
    experts held) with weights from ``seed``, and its BertAdam."""
    from vlp_tpu_torch import optim as optim_lib
    from vlp_tpu_torch.models.kimi_vl import KimiVLModel

    with torch.device(dev):
        model = KimiVLModel(cfg)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return model, optim_lib.BertAdam(dict(model.named_parameters()), 1e-4,
                                     warmup=0.1, t_total=100)


def phase_kimi_loop(dev) -> dict:
    """The Kimi-VL training step (MLA through K1/K2 at (192, 128), the
    expert layer's sort, grouped products and combine, the balance loss
    and the routers' bias update) captured as a device-loop group
    (KIMI_GROUPS replays of K = KIMI_K steps) and taken one step at a
    time, under deterministic algorithms: losses, parameters, BertAdam's
    moments and step, the selection biases and the row counters bit for
    bit.  The warm-up before the capture runs under
    ``set_sync_debug_mode("error")``, so a host sync in the step raises."""
    import dataclasses as dc

    from vlp_tpu_torch import train_step as ts
    from vlp_tpu_torch.config import VLPConfig
    from vlp_tpu_torch.models.kimi_vl import KimiVLConfig

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmarks", "configs", "kimi-vl-a3b-ep8.json")
    cfg = dc.replace(KimiVLConfig.from_json_file(path),
                     num_hidden_layers=KIMI_LAYERS)
    vcfg = VLPConfig(vocab_size=cfg.vocab_size, type_vocab_size=6)
    n = KIMI_K * KIMI_GROUPS
    g = torch.Generator(device=dev).manual_seed(12)
    batches = [fp16_batch(vcfg, KIMI_B, g, dev) for _ in range(n)]
    runs = {}
    with deterministic():
        for captured in (False, True):
            model, opt = kimi_twin(dev, cfg)
            losses = []
            if captured:
                multi = ts.make_multi_step(model, opt, K=KIMI_K)
                staged = {k: torch.empty((KIMI_K,) + tuple(v.shape),
                                         dtype=v.dtype, device=dev)
                          for k, v in batches[0].items()}
                for grp in range(KIMI_GROUPS):
                    rows = range(grp * KIMI_K, (grp + 1) * KIMI_K)
                    for k, buf in staged.items():
                        buf.copy_(torch.stack([batches[i][k] for i in rows]))
                    out = multi(staged, list(rows))
                    losses += [float(x) for x in out["loss"]]
            else:
                step = ts.make_train_step(model, opt)
                losses = [float(step(b, i)["loss"])
                          for i, b in enumerate(batches)]
            torch.cuda.synchronize()
            runs[captured] = (losses, model.state_dict(),
                              model.rows_per_expert().clone(), opt,
                              multi if captured else None)
    (le, se, re_, oe, _), (lc, sc, rc, oc, multi) = runs[False], runs[True]
    differ = [] if le == lc else [f"losses {le} vs {lc}"]
    differ += [k for k in se if not torch.equal(se[k], sc[k])]
    differ += [f"{key}.{name}" for key in ("m", "v") for name in oe.m
               if not torch.equal(getattr(oe, key)[name],
                                  getattr(oc, key)[name])]
    if not torch.equal(re_, rc):
        differ.append("rows_per_expert")
    moved = sum(float(t.abs().sum()) for k, t in sc.items()
                if k.endswith("e_score_correction_bias"))
    out = dict(losses=lc, differ=differ[:6], captures=multi.captures,
               replays=multi.replays, bias_moved=moved,
               rows=rc.tolist(), launches=dict(multi.launches))
    log(f"phase 4j: Kimi-VL ({KIMI_LAYERS} layers at published widths, "
        f"B={KIMI_B}, K={KIMI_K} x {KIMI_GROUPS} replays, deterministic "
        f"algorithms) captured vs eager: {out}")
    if differ or multi.captures != 1 or multi.replays != KIMI_GROUPS:
        fail(f"phase 4j: the captured Kimi-VL steps differ from the eager "
             f"ones: {differ[:6]}")
    if not moved or not all(np.isfinite(lc)) or len(set(lc)) < n:
        fail(f"phase 4j: losses {lc}, selection biases moved {moved}")
    mla = {k: v for k, v in multi.launches.items() if k.endswith("_mla")}
    if mla != {"attention_fwd_mla": KIMI_K * KIMI_LAYERS,
               "attention_bwd_mla": KIMI_K * KIMI_LAYERS}:
        fail(f"phase 4j: a group launched {mla}")
    moe = {k: v for k, v in multi.launches.items() if k.startswith("moe_")}
    if moe != {name: KIMI_K * (KIMI_LAYERS - 1) * c
               for name, c in MOE_STEP_LAUNCHES.items()}:
        fail(f"phase 4j: a group launched {moe} of the expert-row kernels")
    return out


HEADS_LAYERS = 2   # the legacy heads' depth (width stays bert-base): the
# CPU's fp32 forward of every head is the phase's cost


def phase_legacy_heads(dev):
    """The nine legacy BERT heads at bert-base width, HEADS_LAYERS deep:
    each forward on the card against the CPU in fp32 (the same seeded
    weights and inputs, FP32_TOL; B=2, L=128, text-only in bi mode), one
    forward in fp16 on the card against the fp32 one
    (BertForSequenceClassification, within 5e-2 of its logits' size), and
    a BertForSequenceClassification train step in bf16 through K1 dropout
    and K2 (bi mode) and BertAdam.  Launches, per layer: K1 fp32 one per
    card forward, K1 fp16 one, K1 dropout and K2 bf16 one each."""
    from vlp_tpu_torch import optim as optim_lib
    from vlp_tpu_torch.config import VLPConfig
    from vlp_tpu_torch.models import heads_legacy as heads
    from vlp_tpu_torch.models.model import DropoutRNG
    from vlp_tpu_torch.ops import _build

    cfg = VLPConfig(vocab_size=28996, dtype="float32",
                    num_hidden_layers=HEADS_LAYERS)
    B, C, L, H = 2, 2, cfg.seq_len, cfg.hidden_size
    rng = np.random.default_rng(9)
    ids = torch.from_numpy(rng.integers(5, cfg.vocab_size, (B, L)))
    alen = torch.from_numpy(rng.integers(L // 2, L + 1, (B,))).int()
    text = dict(input_ids=ids, attention_len=alen)
    calls = {
        "BertForMaskedLM": ({}, text),
        "BertForPreTraining": ({}, text),
        "BertForNextSentencePrediction": ({}, text),
        "BertForSequenceClassification": (dict(num_labels=3), text),
        "BertForMultipleChoice": (dict(num_choices=C), dict(
            input_ids=torch.from_numpy(rng.integers(5, cfg.vocab_size,
                                                    (B, C, L))),
            attention_len=torch.from_numpy(rng.integers(
                L // 2, L + 1, (B, C))).int())),
        "BertForTokenClassification": (dict(num_labels=5), text),
        "BertForQuestionAnswering": ({}, text),
        "BertForExtractiveSummarization": ({}, dict(
            text, sentence_positions=torch.from_numpy(
                rng.integers(0, L, (B, 4))))),
        "PairRelHead": (dict(num_rel=4), dict(
            pair_x=torch.from_numpy(rng.normal(size=(B, 6, H))).float(),
            pair_y=torch.from_numpy(rng.normal(size=(B, 6, H))).float(),
            pair_r=torch.from_numpy(rng.integers(0, 4, (B, 6))),
            pair_pos_neg_mask=torch.from_numpy(
                np.where(rng.random((B, 6)) > 0.5, 1.0, -1.0)).float())),
    }

    def flat(x):
        return list(x) if isinstance(x, tuple) else [x]

    _build.reset_launch_counts()
    errs = {}
    for name, (ctor, call) in calls.items():
        head = getattr(heads, name)(cfg, **ctor)
        gen = torch.Generator().manual_seed(1)
        if hasattr(head, "init_weights"):
            head.init_weights(gen)
        else:
            for prm in head.parameters():
                prm.data.normal_(0.0, 0.02, generator=gen)
        head.eval()
        with torch.no_grad():
            want = flat(head(**call))
            head.to(dev)
            got = flat(head(**{k: v.to(dev) for k, v in call.items()}))
        errs[name] = max(compare(f"{name} card vs CPU, fp32", a,
                                 b.to(dev), FP32_TOL)
                         for a, b in zip(got, want))
        if name == "BertForSequenceClassification":
            fp32_logits = got[0]
            half = getattr(heads, name)(cfg.replace(dtype="float16"), **ctor)
            half.load_state_dict(head.state_dict())
            half.to(dev).eval()
            with torch.no_grad():
                logits16 = half(**{k: v.to(dev) for k, v in call.items()})
            tol = 5e-2 * float(fp32_logits.abs().max())
            err16 = float((logits16 - fp32_logits).abs().max())
            log(f"{name} fp16 on the card vs fp32: max abs err {err16:.3e} "
                f"(tol {tol:.3e})")
            if not torch.isfinite(logits16).all() or err16 > tol:
                fail(f"{name}: the fp16 forward disagrees with fp32")
            errs[name + " fp16"] = err16
            del half
        del head
        torch.cuda.empty_cache()

    # a train step of the sequence classifier in bf16 (bi mode: K1 dropout
    # and K2), as a user fine-tunes it
    head = heads.BertForSequenceClassification(
        cfg.replace(dtype="bfloat16"), num_labels=3)
    head.init_weights(torch.Generator().manual_seed(1))
    head.to(dev).train()
    opt = optim_lib.BertAdam(dict(head.named_parameters()), 3e-5)
    labels = torch.tensor([0, 2], device=dev)
    before = head.classifier.weight.detach().clone()
    loss = head(ids.to(dev), attention_len=alen.to(dev), labels=labels,
                drop=DropoutRNG(11, dev))
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    if not torch.isfinite(loss) or torch.equal(head.classifier.weight,
                                               before):
        fail("BertForSequenceClassification: the train step did not move")
    log(f"BertForSequenceClassification bf16 train step on the card: loss "
        f"{float(loss.detach()):.4f}")
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    # every head but PairRelHead runs the encoder once on the card
    n = HEADS_LAYERS
    want = dict({k: 0 for k in counts}, attention_fwd=n * (len(calls) - 1),
                attention_fwd_fp16=n, attention_fwd_drop=n, attention_bwd=n,
                **adam_launches(1))
    log(f"legacy heads launch counts {counts}, expected {want}")
    if counts != want:
        fail("the legacy heads did not launch the kernels as expected")
    del head, opt
    torch.cuda.empty_cache()
    return counts, errs


def phase_bhld_main_path(dev):
    """The public [B, H, L, D] op as a user calls it, at the training shape
    (B=64, L=128, H=12, D=64), in bf16 and in fp16: one inference call
    (``attention(..., layout="bhld")``) and one training forward and
    backward through autograd (``FusedAttention``, dropout 0.1) each.
    Each launches its bhld kernel of that dtype once and no other
    kernel."""
    from vlp_tpu_torch.ops import _build
    from vlp_tpu_torch.ops import attention as attn

    g = torch.Generator(device=dev).manual_seed(7)
    _build.reset_launch_counts()
    outs = []
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v, mode, te, ck, dout = bhld_inputs(g, dev, dtype)
        leaves = [t.requires_grad_() for t in (q, k, v)]
        with torch.no_grad():
            out = attn.attention(q, k, v, mode, te, ck, prefix=102,
                                 layout="bhld")
        y = attn.FusedAttention.apply(*leaves, mode, te, ck, 102, 0.1, 99,
                                      "bhld")
        grads = torch.autograd.grad(y, leaves, dout)
        outs += [(t, q.shape) for t in (out, y, *grads)]
    torch.cuda.synchronize()
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    want = {k: int(k.removesuffix("_fp16") in FORMS["bhld"]) for k in counts}
    log(f"bhld op launch counts {counts}, expected {want}")
    if counts != want:
        fail("the bhld op did not launch its kernels as expected")
    if not all(torch.isfinite(t).all() and t.shape == shape
               for t, shape in outs):
        fail("the bhld op returned non-finite or misshapen tensors")
    return counts


def phase_end_to_end(dev, vocab_path, seed=0, word_scale=5.0):
    """fp32 bert-base, same weights: Decoder on the card (kernels) vs on
    the CPU (plain versions), beam 5, B=4, T=20.  Returns the max score
    difference; raises if the traces differ."""
    from vlp_tpu_torch.cli.common import resolve_tokenizer
    from vlp_tpu_torch.config import VLPConfig
    from vlp_tpu_torch.data.example_builder import (DecodeExampleBuilder,
                                                    collate)
    from vlp_tpu_torch.decode import DecodeParams, Decoder
    from vlp_tpu_torch.models.model import VLPModel

    vocab = resolve_tokenizer(vocab_path, False).vocab
    T = 20
    cfg = VLPConfig(vocab_size=len(vocab), max_len_b=T, relax_projection=0,
                    dtype="float32")
    model = VLPModel(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        # random weights at std 0.02 give logits of std ~0.5, whose top
        # candidates sit close enough for fp32 summation order to reorder
        # them; a wider tied embedding spreads them apart
        model.bert.embeddings.word_embeddings.weight.mul_(word_scale)
    model.eval()
    model_gpu = copy.deepcopy(model).to(dev)
    rng = np.random.default_rng(seed)
    builder = DecodeExampleBuilder(cfg, vocab, new_segment_ids=True,
                                   max_tgt_length=T)
    nv = cfg.len_vis_input
    batch = collate([builder(
        rng.normal(size=(nv, cfg.vis_feat_dim)).astype(np.float32),
        rng.uniform(size=(nv, cfg.vis_pe_dim)).astype(np.float32))
        for _ in range(4)])
    dp = DecodeParams(mask_id=vocab["[MASK]"], eos_id=vocab["[SEP]"],
                      beam_size=5, max_tgt_length=T,
                      forbid_duplicate_ngrams=True)
    outs = {}
    for name, m, d in (("cpu", model, torch.device("cpu")),
                       ("cuda", model_gpu, dev)):
        tb = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        outs[name] = Decoder(m, cfg, dp).beam_search(tb)
    c, gpu = outs["cpu"], outs["cuda"]
    for key in ("wids", "ptrs", "pred_seq"):
        if not np.array_equal(c[key], gpu[key]):
            fail(f"end to end: beam {key} differ between kernels and plain")
    if not np.isfinite(gpu["scores"]).all():
        fail("end to end: non-finite beam scores")
    err = float(np.abs(c["scores"] - gpu["scores"]).max())
    # the tolerance of the JAX package's own kernel-vs-XLA beam test
    # (tests/test_decode.py): cumulative scores reach a few hundred, where
    # one fp32 ulp is 3e-5
    if not np.allclose(gpu["scores"], c["scores"], rtol=1e-4, atol=1e-4):
        fail(f"end to end: beam scores differ by {err}")
    log(f"end to end fp32 beam-5 B=4 T={T}: ids/ptrs/pred_seq identical, "
        f"max score diff {err:.3e}; pred_seq[0]={gpu['pred_seq'][0].tolist()}")
    return err


def phase_train_end_to_end(dev, vocab_path, steps=2, B=8):
    """fp32 bert-base, same weights and batches: ``steps`` train steps on
    the card (K1 dropout + K2 kernels) and on the CPU (plain versions),
    hidden dropout 0 and attention dropout 0.1 from the same seeds, so the
    attention masks are identical.  Returns the largest relative loss
    difference; raises above 1e-4."""
    from vlp_tpu_torch import optim, train_step
    from vlp_tpu_torch.cli.common import resolve_tokenizer
    from vlp_tpu_torch.config import VLPConfig
    from vlp_tpu_torch.data.example_builder import TrainExampleBuilder, collate
    from vlp_tpu_torch.models.model import VLPModel

    vocab = resolve_tokenizer(vocab_path, False).vocab
    words = [w for w in vocab if not w.startswith("[")]
    cfg = VLPConfig(vocab_size=len(vocab), relax_projection=0,
                    dtype="float32", hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.1, label_smoothing=0.1,
                    max_pred=3)
    rng = np.random.default_rng(0)
    nv = cfg.len_vis_input
    batches = []
    for _ in range(steps):
        exs = []
        for i in range(B):
            b = TrainExampleBuilder(cfg, vocab, mode="s2s" if i % 2 else "bi",
                                    vis_mask_prob=0.2)
            toks = [words[j] for j in rng.integers(0, len(words), 9)]
            exs.append(b(toks, rng.normal(size=(nv, cfg.vis_feat_dim)),
                         rng.uniform(size=(nv, cfg.vis_pe_dim)), rng))
        batches.append(collate(exs))
    model = VLPModel(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    runs = {}
    for name, m, d in (("cpu", model, torch.device("cpu")),
                       ("cuda", copy.deepcopy(model).to(dev), dev)):
        opt = optim.BertAdam(dict(m.named_parameters()), 3e-5)
        step = train_step.make_train_step(m, opt, mask_image_regions=True)
        t = time.time()
        runs[name] = [float(step({k: torch.from_numpy(v).to(d)
                                  for k, v in nb.items()},
                                 train_step.step_seed(11, i))["loss"])
                      for i, nb in enumerate(batches)]
        log(f"train end to end on {name}: losses {runs[name]} "
            f"({time.time() - t:.1f} s)")
    got, want = np.asarray(runs["cuda"]), np.asarray(runs["cpu"])
    if not np.isfinite(got).all():
        fail("train end to end: non-finite losses on the card")
    err = float(np.max(np.abs(got - want) / np.abs(want)))
    if not np.allclose(got, want, rtol=1e-4, atol=0):
        fail(f"train end to end: card and CPU losses differ by rel {err}")
    return err


def phase_vqa_end_to_end(dev, vocab_path, steps=2, B=8):
    """fp32 bert-base with the 3,129-way answer head, same weights: the
    answer logits of bi-mode questions on the card (K1) and on the CPU
    (plain versions) within 1e-4, the answer ids identical wherever the
    top two logits are more than 1e-3 apart; then ``steps`` VQA fine-tune
    steps (K1 dropout + K2 on the card) on soft answer scores, hidden
    dropout 0 and attention dropout 0.1 from the same seeds, losses within
    rtol 1e-4."""
    from vlp_tpu_torch import optim, train_step
    from vlp_tpu_torch.cli.common import resolve_tokenizer
    from vlp_tpu_torch.config import VLPConfig
    from vlp_tpu_torch.data.example_builder import TrainExampleBuilder, collate
    from vlp_tpu_torch.models.model import VLPModel

    vocab = resolve_tokenizer(vocab_path, False).vocab
    words = [w for w in vocab if not w.startswith("[")]
    cfg = VLPConfig(vocab_size=len(vocab), relax_projection=0,
                    dtype="float32", hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.1)
    rng = np.random.default_rng(2)
    nv, A = cfg.len_vis_input, cfg.num_answers
    builder = TrainExampleBuilder(cfg, vocab, mode="bi", mask_prob=0.0,
                                  load_vqa_ann=True)
    batches = []
    for _ in range(steps):
        exs = []
        for _ in range(B):
            scores = np.zeros(A, np.float32)
            scores[rng.choice(np.arange(1, A), 3, replace=False)] = \
                rng.choice([0.3, 0.6, 0.9, 1.0], 3)
            toks = [words[j] for j in rng.integers(0, len(words),
                                                   rng.integers(4, 12))]
            exs.append(builder(toks, rng.normal(size=(nv, cfg.vis_feat_dim)),
                               rng.uniform(size=(nv, cfg.vis_pe_dim)), rng,
                               ans_scores=scores))
        batches.append(collate(exs))
    model = VLPModel(cfg, with_vqa=True)
    model.init_weights(torch.Generator().manual_seed(0))
    runs = {}
    for name, m, d in (("cpu", model, torch.device("cpu")),
                       ("cuda", copy.deepcopy(model).to(dev), dev)):
        tbs = [{k: torch.from_numpy(v).to(d) for k, v in nb.items()}
               for nb in batches]
        m.eval()
        with torch.no_grad():
            logits = m.vqa_logits(tbs[0]).cpu()
        opt = optim.BertAdam(dict(m.named_parameters()), 3e-5)
        step = train_step.make_train_step(m, opt, task="vqa2")
        t = time.time()
        losses = [float(step(tb, train_step.step_seed(13, i))["loss"])
                  for i, tb in enumerate(tbs)]
        runs[name] = (logits, losses)
        log(f"VQA end to end on {name}: losses {losses} "
            f"({time.time() - t:.1f} s)")
    (lc, loss_c), (lg, loss_g) = runs["cpu"], runs["cuda"]
    if lg.shape != (B, A) or not torch.isfinite(lg).all():
        fail(f"VQA end to end: logits of shape {tuple(lg.shape)} or "
             "non-finite on the card")
    logit_err = (lg - lc).abs().max().item()
    top2 = lc[:, 1:].topk(2, dim=-1).values
    apart = (top2[:, 0] - top2[:, 1]) > 1e-3
    ids_c, ids_g = lc[:, 1:].argmax(-1) + 1, lg[:, 1:].argmax(-1) + 1
    log(f"VQA end to end fp32 B={B}: max |logit diff| {logit_err:.3e}; ids "
        f"compared on {int(apart.sum())} of {B} questions (top-2 gap "
        f"> 1e-3): card {ids_g.tolist()}, CPU {ids_c.tolist()}")
    if not torch.allclose(lg, lc, rtol=1e-4, atol=1e-4):
        fail(f"VQA end to end: card and CPU logits differ by {logit_err}")
    if not torch.equal(ids_g[apart], ids_c[apart]):
        fail("VQA end to end: the card picks other answers than the CPU")
    got, want = np.asarray(loss_g), np.asarray(loss_c)
    loss_err = float(np.max(np.abs(got - want) / np.abs(want)))
    if not (np.isfinite(got).all()
            and np.allclose(got, want, rtol=1e-4, atol=0)):
        fail(f"VQA end to end: card and CPU losses differ by rel {loss_err}")
    return {"vqa_logit_abs_err": logit_err, "vqa_loss_rel_err": loss_err,
            "vqa_ids_compared": int(apart.sum())}


def phase_main_path(vocab_path, out_dir, gpu_line):
    """The user's entry point at bert-base width, bf16, through the
    kernels: beam 5 then greedy over 200 synthetic images, B=100."""
    from vlp_tpu_torch import parallel
    from vlp_tpu_torch.cli import decode as cli
    from vlp_tpu_torch.ops import _build

    base = ["--bert_model", vocab_path, "--new_segment_ids", "--enable_butd",
            "--synthetic_data", "--num_synthetic", "200", "--batch_size",
            "100", "--max_tgt_length", "20", "--forbid_duplicate_ngrams",
            "--device", "cuda"]
    n_batches = 2
    _build.reset_launch_counts()
    rates = {}
    for mode, extra in (("beam5", ["--beam_size", "5"]),
                        ("greedy", ["--beam_size", "1"])):
        out = os.path.join(out_dir, mode)
        stats = cli.main(base + extra + ["--output_dir", out])["random"]
        torch.cuda.synchronize()
        with open(os.path.join(out, "preds-random-val.json")) as f:
            preds = json.load(f)
        if len(preds) != 200 or not all(isinstance(p["caption"], str)
                                        for p in preds):
            fail(f"main path {mode}: malformed predictions")
        rates[mode] = stats["n_images"] / stats["decode_seconds"]
        log(f"main path {mode} B=100: {stats['n_images']} captions in "
            f"{stats['decode_seconds']:.3f} s = {rates[mode]:.2f} captions/s "
            f"on {gpu_line} (first call of the CLI, loader included); "
            f"e.g. {preds[0]['caption']!r}")
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    want = dict({k: 0 for k in counts},
                attention_fwd=12 * n_batches * 2,
                decode_attention=12 * 19 * n_batches,
                decode_attention_anc=12 * 19 * n_batches)
    log(f"launch counts {counts}, expected {want}")
    if counts != want:
        fail("the main path did not launch the kernels as expected")
    # the depth-1 pipeline changes no caption: each mode again with every
    # batch's search run to its end (beam_search) before the next upload
    for mode, extra in (("beam5", ["--beam_size", "5"]),
                        ("greedy", ["--beam_size", "1"])):
        ref = os.path.join(out_dir, mode + "_unpipelined")
        args = cli.build_parser().parse_args(base + extra
                                             + ["--output_dir", ref])
        dist = parallel.from_cli(torch.device("cuda", 0))
        try:
            cli.decode(args, dist, pipelined=False)
        finally:
            dist.destroy()
        got, want = (read_json(os.path.join(d, "preds-random-val.json"))
                     for d in (os.path.join(out_dir, mode), ref))
        if got != want:
            fail(f"main path {mode}: the pipelined CLI's captions differ "
                 "from beam_search's / greedy's batch by batch")
    log("main path: pipelined captions equal the unpipelined ones, beam 5 "
        "and greedy")
    return counts, rates


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def dispatch_checks(dev, beam, greedy, batch) -> str:
    """A batch's upload and dispatch (``Decoder.beam_dispatch``; greedy
    with ``host_copy.fetch``) make no host sync: they run under
    ``torch.cuda.set_sync_debug_mode("error")``, at the decode path's
    shapes (B=100, beam 5, T=20), and what they collect equals
    ``beam_search`` / ``greedy``."""
    from vlp_tpu_torch.cli.decode import upload
    from vlp_tpu_torch.host_copy import fetch, fetched

    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    want_beam = beam.beam_search(tb)["pred_seq"]
    want_greedy = greedy.greedy(tb)[0].cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = time.perf_counter()
        staged = upload(batch, dev)
        handles = (beam.beam_dispatch(staged),
                   fetch({"ids": greedy.greedy(staged)[0]}))
        host_ms = (time.perf_counter() - t) * 1e3
    except RuntimeError as e:
        fail(f"a decode dispatch synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not (np.array_equal(beam.beam_collect(handles[0])["pred_seq"],
                           want_beam)
            and np.array_equal(fetched(handles[1])["ids"], want_greedy)):
        fail("beam_dispatch / beam_collect or the greedy fetch differ from "
             "beam_search / greedy")
    return (f"an upload and both dispatches without a host sync "
            f"({host_ms:.1f} ms of host to queue them), their results equal "
            "beam_search's and greedy's")


def train_flags(vocab_path, out):
    """Phase 4b's train CLI flags: the COCO fine-tune recipe (README) on
    synthetic data, B=64, TRAIN_STEPS, dropout 0.1, bf16 on the card, a
    profile of 4 steps (``profile.txt``: the device's busy share)."""
    epochs, spe = TRAIN_STEPS
    return ["--do_train", "--new_segment_ids", "--enable_butd",
            "--bert_model", vocab_path, "--do_lower_case", "--dataset",
            "coco", "--max_pred", "20", "--mask_prob", "0.15",
            "--train_batch_size", "64", "--learning_rate", "3e-5",
            "--num_train_epochs", str(epochs), "--s2s_prob", "1",
            "--bi_prob", "0", "--synthetic_data", "--steps_per_epoch",
            str(spe), "--output_dir", out, "--device", "cuda",
            "--profile_steps", "4"]


def busy_share(out: str) -> str:
    """The first line of a CLI's ``profile.txt``: wall, device time and
    the device's busy share over the profiled steps."""
    with open(os.path.join(out, "profile.txt")) as f:
        return f.readline().strip()


def device_ms(profile_line: str) -> float:
    """The summed device ms of a ``busy_share`` line."""
    return float(re.search(r"summed ([0-9.]+) ms", profile_line).group(1))


def phase_train_main_path(vocab_path, out_dir, gpu_line):
    """The train CLI at bert-base width, bf16, through the kernels: the
    COCO fine-tune flags (README) on synthetic data, B=64, 2 epochs of 20
    steps, attention dropout 0.1.  Every step launches K1-dropout and K2
    once per layer; model.2.bin then decodes through the decode CLI.  Its
    losses, peak memory and profile go to phase 4h."""
    from vlp_tpu_torch.cli import decode as decode_cli
    from vlp_tpu_torch.cli import train as train_cli
    from vlp_tpu_torch.ops import _build

    epochs, spe = TRAIN_STEPS
    out = os.path.join(out_dir, "train")
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = train_cli.main(train_flags(vocab_path, out))
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    n = 12 * epochs * spe
    want = {k: (n if k in ("attention_fwd_drop", "attention_bwd") else 0)
            for k in counts}
    want.update(adam_launches(epochs * spe))
    log(f"train launch counts {counts}, expected {want}")
    if counts != want:
        fail("the train path did not launch the kernels as expected")
    losses = np.asarray(res["losses"])
    if len(losses) != epochs * spe or not np.isfinite(losses).all():
        fail(f"train main path: bad losses {losses}")
    first, last = losses[:10].mean(), losses[-10:].mean()
    log(f"train losses: first 10 mean {first:.4f}, last 10 mean {last:.4f}")
    if not last < first:
        fail("train main path: the loss did not fall")
    rates = {"train_peak_gb": peak_gb, "train_profile": busy_share(out),
             "train_losses": res["losses"]}
    log(f"train main path B=64 on {gpu_line}: peak memory {peak_gb:.3f} GB; "
        f"profile of steps 1-4: {rates['train_profile']}")
    dec_out = os.path.join(out_dir, "train_decode")
    stats = decode_cli.main([
        "--bert_model", vocab_path, "--new_segment_ids", "--enable_butd",
        "--synthetic_data", "--num_synthetic", "100", "--batch_size", "100",
        "--beam_size", "5", "--max_tgt_length", "20",
        "--forbid_duplicate_ngrams", "--device", "cuda",
        "--model_recover_path", os.path.join(out, "model.2.bin"),
        "--output_dir", dec_out])["model.2.bin"]
    with open(os.path.join(dec_out, "preds-model.2.bin-val.json")) as f:
        preds = json.load(f)
    if stats["n_images"] != 100 or len(preds) != 100:
        fail("model.2.bin did not decode")
    log(f"model.2.bin decodes: {preds[0]['caption']!r}")
    return counts, rates


def phase_train_loop_main_path(vocab_path, out_dir, gpu_line, bf16_rates):
    """The train CLI of phase 4b with ``--device_loop_steps LOOP_K``: each
    group of 4 steps is one CUDA-graph replay.  Exact launch counts with
    the replays (480 K1-dropout and 480 K2 over 40 steps), 10 replays of
    one capture, every step's loss within LOOP_LOSS_RTOL relative of phase
    4b's and the final parameters (model.2.bin) within LOOP_PARAM_ATOL of
    phase 4b's (a replayed step draws the dropout of the eager step with
    the same seed; bit for bit only under deterministic algorithms, which
    phases 4f, 4i and 6a hold).  Its busy share and peak memory beside
    phase 4b's."""
    from vlp_tpu_torch.cli import train as train_cli
    from vlp_tpu_torch.ops import _build

    epochs, spe = TRAIN_STEPS
    out = os.path.join(out_dir, "train_loop")
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = train_cli.main(train_flags(vocab_path, out)
                         + ["--device_loop_steps", str(LOOP_K)])
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    n = 12 * epochs * spe
    want = {k: (n if k in ("attention_fwd_drop", "attention_bwd") else 0)
            for k in counts}
    want.update(adam_launches(epochs * spe))
    loop = res["device_loop"]
    log(f"train K={LOOP_K} launch counts {counts}, expected {want}; "
        f"{loop}")
    if counts != want:
        fail("the device loop did not launch the kernels as expected")
    if loop["replays"] != epochs * spe // LOOP_K or loop["captures"] != 1:
        fail(f"the device loop made {loop['replays']} replays of "
             f"{loop['captures']} captures, not {epochs * spe // LOOP_K} "
             "of 1")
    losses = np.asarray(res["losses"])
    ref = np.asarray(bf16_rates["train_losses"])
    if losses.shape != ref.shape or not np.isfinite(losses).all():
        fail(f"train K={LOOP_K}: bad losses {losses}")
    rel = float(np.max(np.abs(losses - ref) / np.abs(ref)))
    mine, theirs = (torch.load(os.path.join(d, "model.2.bin"),
                               map_location="cpu", weights_only=True)
                    for d in (out, os.path.join(out_dir, "train")))
    differ = {k: float((v.float() - theirs[k].float()).abs().max())
              for k, v in mine.items() if not torch.equal(v, theirs[k])}
    log(f"train K={LOOP_K} vs phase 4b: losses max rel {rel:.3e}, "
        f"{len(differ)} of {len(mine)} tensors of model.2.bin differ "
        f"{sorted(differ.items(), key=lambda x: -x[1])[:3]}")
    # not bit for bit: PyTorch's embedding backward sums in an order that
    # changes from run to run (on an H100, two eager runs of phase 4b's
    # recipe ended with token_type_embeddings 6e-8 apart, and a K=4 run
    # and an eager one differed by 3.8e-5 relative in a loss by step 9 and
    # by 1.1e-4 in the word embeddings by step 16); phases 4i and 6a hold
    # the loop against the eager step bit for bit under deterministic
    # algorithms
    worst = max(differ.values(), default=0.0)
    if rel > LOOP_LOSS_RTOL or worst > LOOP_PARAM_ATOL:
        fail(f"train K={LOOP_K}: losses {rel:.3e} relative (limit "
             f"{LOOP_LOSS_RTOL}) or parameters {worst:.3e} (limit "
             f"{LOOP_PARAM_ATOL}) from phase 4b's")
    rates = {"train_loop_peak_gb": peak_gb,
             "train_loop_capture_seconds": loop["capture_seconds"],
             "train_loop_profile": busy_share(out)}
    log(f"train K={LOOP_K} B=64: capture (warm-up included) "
        f"{loop['capture_seconds']:.3f} s; peak memory {peak_gb:.3f} GB (phase 4b {bf16_rates['train_peak_gb']:.3f}); "
        f"profile of group 1 (steps 4-7): {rates['train_loop_profile']} "
        f"(phase 4b, steps 1-4: {bf16_rates['train_profile']}): device ms a "
        f"step {device_ms(rates['train_loop_profile']) / 4:.2f}, phase 4b "
        f"{device_ms(bf16_rates['train_profile']) / 4:.2f}; on {gpu_line}")
    return counts, rates


LONG_TRAIN_MAX_LEN_B = 40   # 100 regions + 3 + 40 = 143 tokens: L = 256
LONG_TRAIN_STEPS = 8


def phase_train_long_main_path(vocab_path, out_dir):
    """The train CLI as phase 4b (bf16, B=64, the COCO fine-tune flags) at
    a longer caption budget, --max_len_b LONG_TRAIN_MAX_LEN_B, which
    rounds the sequence up to L = 256: one epoch of LONG_TRAIN_STEPS
    steps through K1's row-block body (dropout) and K2's tiled body, each
    launched once per layer and step."""
    from vlp_tpu_torch.cli import train as train_cli
    from vlp_tpu_torch.ops import _build

    out = os.path.join(out_dir, "train_long")
    args = ["--do_train", "--new_segment_ids", "--enable_butd",
            "--bert_model", vocab_path, "--do_lower_case", "--dataset",
            "coco", "--max_pred", "20", "--mask_prob", "0.15",
            "--train_batch_size", "64", "--learning_rate", "3e-5",
            "--num_train_epochs", "1", "--s2s_prob", "1", "--bi_prob", "0",
            "--max_len_b", str(LONG_TRAIN_MAX_LEN_B), "--synthetic_data",
            "--steps_per_epoch", str(LONG_TRAIN_STEPS), "--output_dir", out,
            "--device", "cuda"]
    _build.reset_launch_counts()
    res = train_cli.main(args)
    torch.cuda.synchronize()
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    n = 12 * LONG_TRAIN_STEPS
    want = {k: (n if k in ("attention_fwd_drop", "attention_bwd") else 0)
            for k in counts}
    want.update(adam_launches(LONG_TRAIN_STEPS))
    log(f"train (--max_len_b {LONG_TRAIN_MAX_LEN_B}) launch counts {counts}, "
        f"expected {want}")
    if counts != want:
        fail("the long train path did not launch the kernels as expected")
    losses = np.asarray(res["losses"])
    if len(losses) != LONG_TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"long train path: bad losses {losses}")
    return counts


def _scst_setup(vocab_path, B, seed, **cfg_kw):
    """A bert-base SCST trainer (random weights from ``seed``, on the CPU)
    and a decode batch of B synthetic images as numpy arrays."""
    from vlp_tpu_torch.cli.common import resolve_tokenizer
    from vlp_tpu_torch.config import VLPConfig
    from vlp_tpu_torch.data.example_builder import (DecodeExampleBuilder,
                                                    collate)
    from vlp_tpu_torch.models.model import VLPModel

    vocab = resolve_tokenizer(vocab_path, False).vocab
    cfg = VLPConfig(vocab_size=len(vocab), max_len_b=SCST_T,
                    relax_projection=0, **cfg_kw)
    model = VLPModel(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    nv = cfg.len_vis_input
    builder = DecodeExampleBuilder(cfg, vocab, new_segment_ids=True,
                                   max_tgt_length=SCST_T)
    batch = collate([builder(
        rng.normal(size=(nv, cfg.vis_feat_dim)).astype(np.float32),
        rng.uniform(size=(nv, cfg.vis_pe_dim)).astype(np.float32))
        for _ in range(B)])
    return cfg, model, vocab, batch, rng


def phase_scst_end_to_end(dev, vocab_path, B=4):
    """fp32 bert-base, attention dropout 0.1 and hidden dropout 0 (the
    Philox masks are the same on both devices; the hidden masks come from
    each device's own generator): the SCST loss and gradients of fixed raw
    and cleaned ids and reward, on the card (K1 dropout, K2, K6) and on the
    CPU (plain versions).  Then, on the card with both dropouts 0.1, the
    replay's log-probs against the sampled rollout's, fp32 and bf16."""
    from vlp_tpu_torch import scst

    cfg, model, vocab, batch, rng = _scst_setup(
        vocab_path, B, 0, dtype="float32", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.1)
    kw = dict(mask_id=vocab["[MASK]"], eos_id=vocab["[SEP]"],
              max_tgt_length=SCST_T)
    raw = rng.integers(cfg.vocab_size // 2, cfg.vocab_size,
                       size=(B, SCST_T))
    raw[0, SCST_T // 2] = vocab["[SEP]"]   # a live token after EOS
    clean = scst.clean_rollout(raw, vocab["[SEP]"], 0)
    reward = np.repeat(rng.normal(size=(B, 1)), SCST_T, 1).astype(np.float32)
    runs = {}
    for name, m, d in (("cpu", model, torch.device("cpu")),
                       ("cuda", copy.deepcopy(model).to(dev), dev)):
        tr = scst.SCSTTrainer(m, cfg, **kw)
        tb = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        loss = tr.pg_loss(tb, *(torch.from_numpy(a).to(d)
                                for a in (raw, clean, reward)),
                          tr.dropout(99, d))
        loss.backward()
        norms = {n: (0.0 if p.grad is None else p.grad.double().norm().item())
                 for n, p in m.named_parameters()}
        runs[name] = (loss.item(), norms)
    (l_cpu, n_cpu), (l_gpu, n_gpu) = runs["cpu"], runs["cuda"]
    total = {k: float(np.sqrt(sum(v * v for v in n.values())))
             for k, n in (("cpu", n_cpu), ("cuda", n_gpu))}
    rel = {n: abs(n_gpu[n] - n_cpu[n]) / max(n_cpu[n], 1e-30) for n in n_cpu}
    big = [n for n in n_cpu if n_cpu[n] >= 1e-3 * total["cpu"]]
    log(f"SCST card vs CPU fp32 B={B}: loss {l_gpu:.8f} / {l_cpu:.8f}, grad "
        f"norm {total['cuda']:.8f} / {total['cpu']:.8f}, max per-parameter "
        f"rel diff {max(rel.values()):.3e} (over {len(big)} of {len(rel)} "
        f"parameters holding >= 1e-3 of the norm: "
        f"{max(rel[n] for n in big):.3e})")
    if not (np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
            and abs(total["cuda"] - total["cpu"]) <= 1e-4 * total["cpu"]
            and max(rel[n] for n in big) <= 1e-4):
        fail("SCST card vs CPU: loss or gradient norms differ beyond 1e-4")
    out = {"loss_rel": abs(l_gpu - l_cpu) / abs(l_cpu),
           "grad_norm_rel": abs(total["cuda"] - total["cpu"]) / total["cpu"]}

    for dtype in ("float32", "bfloat16"):
        cfg, model, vocab, batch, _ = _scst_setup(vocab_path, 8, 1,
                                                  dtype=dtype)
        tr = scst.SCSTTrainer(model.to(dev), cfg, **kw)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        _, _, sample_raw, lps = tr.rollouts(tb, 5)
        with torch.no_grad():
            replay = tr.forced_logprobs(tb, torch.from_numpy(sample_raw).to(
                dev), tr.dropout(5, dev))
            other = tr.forced_logprobs(tb, torch.from_numpy(sample_raw).to(
                dev), tr.dropout(6, dev))
        diff = (replay - lps).abs().max().item()
        moved = (other - lps).abs().max().item()
        log(f"SCST replay vs rollout on the card, {dtype} B=8 T={SCST_T}, "
            f"dropout 0.1: max |log-prob diff| {diff:.3e} (another seed's "
            f"masks: {moved:.3e})")
        if not (torch.isfinite(replay).all() and moved > 1e-3):
            fail(f"SCST replay {dtype}: non-finite, or dropout not active")
        if dtype == "float32" and not torch.allclose(replay, lps, rtol=1e-4,
                                                     atol=1e-4):
            fail("SCST fp32 replay log-probs differ from the rollout's")
        out[f"replay_vs_rollout_{dtype}"] = diff
    return out


def phase_scst_main_path(vocab_path, out_dir, gpu_line):
    """The SCST CLI at bert-base width, bf16, through the kernels: B=64,
    T=20, both dropouts 0.1, lr 1e-6, SCST_STEPS steps of synthetic data.
    Each step launches K1 (the greedy prefill) 12 times, K1-dropout 24
    (the sampled prefill and the replay's), K2 12, K3 and K5 12 x 19 each
    and K6 12."""
    from vlp_tpu_torch import tracing
    from vlp_tpu_torch.cli import train as train_cli
    from vlp_tpu_torch.ops import _build

    out = os.path.join(out_dir, "scst")
    args = ["--do_train", "--scst", "--new_segment_ids", "--enable_butd",
            "--bert_model", vocab_path, "--do_lower_case", "--dataset",
            "coco", "--max_pred", "0", "--mask_prob", "0",
            "--train_batch_size", str(SCST_B), "--learning_rate", "1e-6",
            "--num_train_epochs", "1", "--synthetic_data",
            "--steps_per_epoch", str(SCST_STEPS), "--output_dir", out,
            "--device", "cuda"]
    _build.reset_launch_counts()
    with tracing.recording() as spans:
        res = train_cli.main(args)
    torch.cuda.synchronize()
    # SCST drops its gradients every step (p.grad = None): how often the
    # fused BertAdam's table was rewritten, and how many rows
    tables = [sp.n for sp in spans if sp.name == "optim.table"]
    log(f"SCST: BertAdam's table rewritten {len(tables)} times in "
        f"{SCST_STEPS} steps (rows {tables})")
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    n, steps = SCST_STEPS, 12 * (SCST_T - 1)
    want = dict({k: 0 for k in counts}, attention_fwd=12 * n,
                attention_fwd_drop=24 * n, attention_bwd=12 * n,
                decode_attention=steps * n, decode_attention_drop=steps * n,
                decode_dropout_scales=12 * n, **adam_launches(n))
    log(f"SCST launch counts {counts}, expected {want}")
    if counts != want:
        fail("the SCST path did not launch the kernels as expected")
    losses = np.asarray(res["losses"])
    if len(losses) != n or not np.isfinite(losses).all():
        fail(f"SCST main path: bad losses {losses}")
    if not os.path.isfile(os.path.join(out, "model.1.bin")):
        fail("SCST main path wrote no model.1.bin")
    log(f"SCST main path B={SCST_B} on {gpu_line}: losses "
        f"{losses.tolist()}")
    return counts


def write_answer_vocab(path: str, n: int = 3129) -> str:
    """A synthetic VQA answer vocabulary of ``n`` lines, ``<unk>`` first
    (the size of the VQA 2.0 answer list)."""
    with open(path, "w") as f:
        f.write("\n".join(["<unk>"] + [f"answer{i}" for i in range(1, n)])
                + "\n")
    return path


def write_vqa_index(path: str, vocab_path: str, n: int, seed: int = 0,
                    n_answers: int = 3129) -> str:
    """A VQA imdb index (the ``.npy`` that ``load_vqa_index`` reads) of
    ``n`` questions of 4-11 random vocabulary words, each with 10 human
    answers drawn from three of the answer vocabulary's candidates, so
    that every question has non-zero soft answer scores.  No feature file
    goes with it: the train CLI then draws each image's features from its
    synthetic store."""
    from vlp_tpu_torch.cli.common import resolve_tokenizer
    words = [w for w in resolve_tokenizer(vocab_path, False).vocab
             if not w.startswith("[")]
    rng = np.random.default_rng(seed)
    recs = [{"has_answer": True}]
    for i in range(n):
        cands = [f"answer{j}" for j in rng.choice(np.arange(1, n_answers), 3,
                                                  replace=False)]
        recs.append(dict(
            image_name=f"COCO_train2014_{i:012d}", feature_path=f"{i}.npy",
            image_id=i, question_str=" ".join(
                words[j] for j in rng.integers(0, len(words),
                                               rng.integers(4, 12))),
            answers=[cands[j] for j in rng.choice(3, 10, p=[0.6, 0.3, 0.1])]))
    np.save(path, np.array(recs, dtype=object), allow_pickle=True)
    return path


def phase_vqa_main_path(vocab_path, answers_path, out_dir, gpu_line):
    """VQA 2.0 through the user's entry points at bert-base width, bf16:
    ``cli.train --tasks vqa2`` on a VQA index with soft answer scores (bi
    mode, B=64, VQA_STEPS steps, dropout 0.1; K1-dropout and K2 once per
    layer and step), then ``cli.eval_vqa2`` on its model.1.bin over
    VQA_QUESTIONS synthetic questions at B=256 (K1 once per layer and
    batch).  Returns the counts of each run and the rates."""
    from vlp_tpu_torch.cli import eval_vqa2 as eval_cli
    from vlp_tpu_torch.cli import train as train_cli
    from vlp_tpu_torch.ops import _build

    out = os.path.join(out_dir, "vqa_train")
    index = write_vqa_index(os.path.join(out_dir, "vqa_train.npy"),
                            vocab_path, 64 * VQA_STEPS)
    flags = ["--new_segment_ids", "--enable_butd", "--bert_model",
             vocab_path, "--do_lower_case", "--answer_vocab_file",
             answers_path, "--device", "cuda"]
    _build.reset_launch_counts()
    res = train_cli.main(flags + [
        "--do_train", "--tasks", "vqa2", "--s2s_prob", "0", "--bi_prob", "1",
        "--train_batch_size", "64", "--learning_rate", "3e-5",
        "--num_train_epochs", "1", "--src_file", index, "--steps_per_epoch",
        str(VQA_STEPS), "--output_dir", out])
    torch.cuda.synchronize()
    train_counts = {k: v.launches for k, v in _build.KERNELS.items()}
    n = 12 * VQA_STEPS
    want = {k: (n if k in ("attention_fwd_drop", "attention_bwd") else 0)
            for k in train_counts}
    want.update(adam_launches(VQA_STEPS))
    log(f"VQA train launch counts {train_counts}, expected {want}")
    if train_counts != want:
        fail("the VQA train path did not launch the kernels as expected")
    losses = np.asarray(res["losses"])
    if len(losses) != VQA_STEPS or not np.isfinite(losses).all():
        fail(f"VQA train main path: bad losses {losses}")
    if not losses[-3:].mean() < losses[:3].mean():
        fail(f"VQA train main path: the loss did not fall: {losses}")
    rates = {}
    log(f"VQA train main path B=64 on {gpu_line}: losses {losses.tolist()}")

    bin_path = os.path.join(out, "model.1.bin")
    eval_out = os.path.join(out_dir, "vqa_eval")
    _build.reset_launch_counts()
    stats = eval_cli.main(flags + [
        "--synthetic_data", "--num_synthetic", str(VQA_QUESTIONS),
        "--batch_size", str(VQA_B), "--model_recover_path", bin_path,
        "--output_dir", eval_out])["model.1.bin"]
    torch.cuda.synchronize()
    eval_counts = {k: v.launches for k, v in _build.KERNELS.items()}
    want = {k: (12 * -(-VQA_QUESTIONS // VQA_B) if k == "attention_fwd"
                else 0) for k in eval_counts}
    log(f"VQA eval launch counts {eval_counts}, expected {want}")
    if eval_counts != want:
        fail("the VQA eval path did not launch the kernels as expected")
    with open(os.path.join(eval_out, "vqa2-results-model.1.bin-val.json")) as f:
        preds = json.load(f)
    with open(answers_path) as f:
        answers = set(f.read().split())
    if ([p["question_id"] for p in preds] != list(range(VQA_QUESTIONS))
            or not all(p["answer"] in answers - {"<unk>"} for p in preds)):
        fail("VQA eval main path: malformed predictions")
    rates["vqa_questions_per_sec_cli"] = (stats["n_questions"]
                                          / stats["eval_seconds"])
    log(f"VQA eval main path B={VQA_B}: {stats['n_questions']} questions in "
        f"{stats['eval_seconds']:.3f} s = "
        f"{rates['vqa_questions_per_sec_cli']:.2f} questions/s on "
        f"{gpu_line} (first call of the CLI, example building included); "
        f"{len({p['answer'] for p in preds})} distinct answers")
    return train_counts, eval_counts, rates


DP_STEPS = 2 * LOOP_K        # phase 6a: train steps at world size 1 (two
# replays of the device loop's group)
DP2_LAYERS = 4               # phase 6b: the two ranks' depth
DP_LR = 1e-3                 # phase 6b: constant lr, so the steps move


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def param_hash(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def phase_dp_world1(vocab_path, answers_path, out_dir, gpu_line):
    """Data parallel at world size 1 over NCCL against no group, bf16
    through the kernels: ``cli.train`` at bert-base width (B=64, DP_STEPS
    steps, dropout 0.1) with ``--jax_distributed`` on a group of one, then
    ``cli.decode`` (beam 5, B=100, on phase 4b's model.2.bin) and
    ``cli.eval_vqa2`` (B=256, on phase 4d's model.1.bin) on a group of one
    passed in.  Losses, final parameters and predictions must be identical
    to the runs without a group, and the launch counts equal; prints each
    step's all-reduce time (``--profile_steps 1``, which also traces the
    second step: the split of its all-reduce between the agreement check
    and the buckets, on the host and on the device).  The phase runs under
    ``torch.use_deterministic_algorithms``: PyTorch's own CUDA backward
    is not reproducible bit for bit from run to run (two train runs
    without a group once ended with token_type_embeddings 6e-8 apart), so
    only a deterministic order isolates what the group adds.  Then the
    train run again with ``--device_loop_steps LOOP_K``, without a group
    and over NCCL (the all-reduce inside the captured graph): both equal
    the step-at-a-time run without a group bit for bit.  Returns the group
    runs' counts and rates."""
    flags = ["--do_train", "--new_segment_ids", "--enable_butd",
             "--bert_model", vocab_path, "--do_lower_case", "--dataset",
             "coco", "--max_pred", "20", "--mask_prob", "0.15",
             "--train_batch_size", "64", "--learning_rate", "3e-5",
             "--num_train_epochs", "1", "--s2s_prob", "1", "--bi_prob", "0",
             "--synthetic_data", "--steps_per_epoch", str(DP_STEPS),
             "--device", "cuda", "--profile_steps", "1"]
    with deterministic():
        return _dp_world1(flags, vocab_path, answers_path, out_dir, gpu_line)


def _dp_world1(flags, vocab_path, answers_path, out_dir, gpu_line):
    import torch.distributed as tdist
    from vlp_tpu_torch import parallel
    from vlp_tpu_torch.cli import decode as decode_cli
    from vlp_tpu_torch.cli import eval_vqa2 as eval_cli
    from vlp_tpu_torch.cli import train as train_cli
    from vlp_tpu_torch.ops import _build

    runs, counts = {}, {}
    for mode in ("no_group", "nccl"):
        group = ([] if mode == "no_group" else [
            "--jax_distributed", "--coordinator_address",
            f"127.0.0.1:{free_port()}", "--num_processes", "1",
            "--process_id", "0"])
        _build.reset_launch_counts()
        runs[mode] = train_cli.main(flags + group + [
            "--output_dir", os.path.join(out_dir, f"dp1_train_{mode}")])
        torch.cuda.synchronize()
        counts[mode] = {k: v.launches for k, v in _build.KERNELS.items()}
        log(f"DP world 1 train ({mode}) B=64, deterministic algorithms, on "
            f"{gpu_line}: losses {runs[mode]['losses']}")
    if tdist.is_initialized():
        fail("cli.train left its process group behind")
    want = {k: (12 * DP_STEPS if k in ("attention_fwd_drop", "attention_bwd")
                else 0) for k in counts["nccl"]}
    want.update(adam_launches(DP_STEPS))
    if not counts["nccl"] == counts["no_group"] == want:
        fail(f"DP world 1 train launch counts {counts}, expected {want}")
    if runs["nccl"]["losses"] != runs["no_group"]["losses"]:
        fail("DP world 1 train: the losses differ from the run without a "
             "group")
    sd = {m: runs[m]["model"].state_dict() for m in runs}
    if not all(torch.equal(v, sd["no_group"][k])
               for k, v in sd["nccl"].items()):
        fail("DP world 1 train: the parameters differ from the run without "
             "a group")
    ar = runs["nccl"]["allreduce_ms"]
    if len(ar) != DP_STEPS or runs["no_group"]["allreduce_ms"]:
        fail(f"DP world 1 train: {len(ar)} all-reduce times")
    log(f"DP world 1 train over NCCL: losses and parameters bit-identical "
        f"to no group, launch counts {counts['nccl']}; all-reduce ms per "
        f"step {[round(x, 4) for x in ar]} (step 1 under torch.profiler) on "
        f"{gpu_line}")
    with open(os.path.join(out_dir, "dp1_train_nccl", "profile.txt")) as f:
        table = f.read().splitlines()
    rows = [ln for ln in table if ln.lstrip().startswith(
        ("dist.grad_", "nccl:all_reduce", "Name"))]
    if not any("dist.grad_buckets" in ln for ln in rows):
        fail("DP world 1 train: the profile holds no all-reduce range")
    log(f"DP world 1 all-reduce trace of step 1 ({ar[1]:.4f} ms between "
        f"its CUDA events; {table[0]}):\n" + "\n".join(rows))

    # the device loop over NCCL: DP_STEPS steps as groups of LOOP_K, the
    # bucketed all-reduce inside the captured graph; with deterministic
    # algorithms each run equals the step-at-a-time run without a group
    for mode in ("no_group_loop", "nccl_loop"):
        group = ([] if mode == "no_group_loop" else [
            "--jax_distributed", "--coordinator_address",
            f"127.0.0.1:{free_port()}", "--num_processes", "1",
            "--process_id", "0"])
        _build.reset_launch_counts()
        runs[mode] = train_cli.main(flags + group + [
            "--device_loop_steps", str(LOOP_K), "--output_dir",
            os.path.join(out_dir, f"dp1_train_{mode}")])
        torch.cuda.synchronize()
        counts[mode] = {k: v.launches for k, v in _build.KERNELS.items()}
    want = {k: (12 * DP_STEPS if k in ("attention_fwd_drop", "attention_bwd")
                else 0) for k in counts["nccl_loop"]}
    want.update(adam_launches(DP_STEPS))
    loops = [runs[m]["device_loop"] for m in ("no_group_loop", "nccl_loop")]
    if not counts["nccl_loop"] == counts["no_group_loop"] == want:
        fail(f"DP world 1 device loop launch counts {counts}, expected "
             f"{want}")
    if any(lp["replays"] != DP_STEPS // LOOP_K or lp["captures"] != 1
           for lp in loops):
        fail(f"DP world 1 device loop: {loops}, not one capture replayed "
             f"{DP_STEPS // LOOP_K} times")
    for mode in ("no_group_loop", "nccl_loop"):
        sd_loop = runs[mode]["model"].state_dict()
        if (runs[mode]["losses"] != runs["no_group"]["losses"]
                or not all(torch.equal(v, sd["no_group"][k])
                           for k, v in sd_loop.items())):
            fail(f"DP world 1 device loop (K={LOOP_K}, {mode}): losses or "
                 "parameters differ from the step-at-a-time run without a "
                 "group")
    log(f"DP world 1 device loop (K={LOOP_K}, {DP_STEPS // LOOP_K} replays, "
        f"deterministic algorithms) over NCCL and without a group: losses "
        f"and parameters bit-identical to the step-at-a-time run without a "
        f"group, launch counts {counts['nccl_loop']}")

    dec_args = ["--bert_model", vocab_path, "--new_segment_ids",
                "--enable_butd", "--synthetic_data", "--num_synthetic", "100",
                "--batch_size", "100", "--beam_size", "5",
                "--max_tgt_length", "20", "--forbid_duplicate_ngrams",
                "--device", "cuda", "--model_recover_path",
                os.path.join(out_dir, "train", "model.2.bin")]
    vqa_args = ["--new_segment_ids", "--enable_butd", "--bert_model",
                vocab_path, "--do_lower_case", "--answer_vocab_file",
                answers_path, "--device", "cuda", "--synthetic_data",
                "--num_synthetic", "512", "--batch_size", str(VQA_B),
                "--model_recover_path",
                os.path.join(out_dir, "vqa_train", "model.1.bin")]
    outputs = {}
    dist = parallel.init("cuda", init_method=f"tcp://127.0.0.1:{free_port()}",
                         world_size=1, rank=0)
    try:
        for mode, d in (("no_group", None), ("nccl", dist)):
            for name, cli, args, fname in (
                    ("decode", decode_cli, dec_args,
                     "preds-model.2.bin-val.json"),
                    ("vqa", eval_cli, vqa_args,
                     "vqa2-results-model.1.bin-val.json")):
                out = os.path.join(out_dir, f"dp1_{name}_{mode}")
                _build.reset_launch_counts()
                cli.main(args + ["--output_dir", out], dist=d)
                torch.cuda.synchronize()
                counts[name, mode] = {k: v.launches
                                      for k, v in _build.KERNELS.items()}
                with open(os.path.join(out, fname), "rb") as f:
                    outputs[name, mode] = f.read()
    finally:
        dist.destroy()
    for name in ("decode", "vqa"):
        if outputs[name, "nccl"] != outputs[name, "no_group"]:
            fail(f"DP world 1 {name}: predictions differ from no group")
        if counts[name, "nccl"] != counts[name, "no_group"]:
            fail(f"DP world 1 {name}: launch counts differ: "
                 f"{counts[name, 'nccl']} vs {counts[name, 'no_group']}")
    log("DP world 1 decode (beam 5, 100 images) and VQA eval (512 "
        "questions) over NCCL: predictions identical to no group")
    return ({"train": counts["nccl"], "train_loop": counts["nccl_loop"],
             "decode": counts["decode", "nccl"],
             "vqa": counts["vqa", "nccl"]},
            {"dp1_allreduce_ms": ar})


def dp_worker(rank: int, port: int, vocab_path: str, out: str) -> None:
    """Rank ``rank`` of 2 on the one card, gloo (NCCL refuses two ranks on
    one device), bert-base width, DP2_LAYERS deep: (a) fp32, dropout 0,
    global B=16, 2 ``dp_step`` steps, and on rank 0 the single-process
    step on the global batch beside it; (b) bf16, dropout 0.1, the same 2
    steps; (c) SCST, bf16, both dropouts 0.1, global B=8, 2 steps.  Writes
    each run's parameter hash, its launch counts (the single-process
    reference's and the SCST ground truth's greedy decode not among them)
    and rank 0's comparison to ``out``."""
    import vlp_tpu_torch
    from vlp_tpu_torch import optim, parallel, scst
    from vlp_tpu_torch import train_step as ts
    from vlp_tpu_torch.cli.common import resolve_tokenizer
    from vlp_tpu_torch.config import VLPConfig
    from vlp_tpu_torch.data.example_builder import TrainExampleBuilder, collate
    from vlp_tpu_torch.models.model import VLPModel
    from vlp_tpu_torch.ops import _build
    from vlp_tpu_torch.parallel.dp_step import make_dp_train_step

    vlp_tpu_torch.configure_precision()
    dev = torch.device("cuda", 0)
    dist = parallel.init("cuda", init_method=f"tcp://127.0.0.1:{port}",
                         world_size=2, rank=rank, local_rank=0,
                         backend="gloo")
    dist.time_reductions = True
    res = {"counts": {}}

    def counted(name, run):
        """``run()``, with the launches it made alone kept under ``name``."""
        _build.reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        res["counts"][name] = {k: v.launches
                               for k, v in _build.KERNELS.items()}
        return out

    try:
        vocab = resolve_tokenizer(vocab_path, False).vocab
        words = [w for w in vocab if not w.startswith("[")]
        rng = np.random.default_rng(0)
        GB, half = 16, 8
        base = VLPConfig(vocab_size=len(vocab), relax_projection=0,
                         max_pred=3, num_hidden_layers=DP2_LAYERS)
        nv = base.len_vis_input
        batches = []
        for _ in range(2):
            exs = []
            for i in range(GB):
                b = TrainExampleBuilder(base, vocab,
                                        mode="s2s" if i % 2 else "bi",
                                        vis_mask_prob=0.2)
                toks = [words[j] for j in rng.integers(0, len(words), 9)]
                exs.append(b(toks, rng.normal(size=(nv, base.vis_feat_dim)),
                             rng.uniform(size=(nv, base.vis_pe_dim)), rng))
            batches.append(collate(exs))

        def model_of(cfg):
            m = VLPModel(cfg)
            m.init_weights(torch.Generator().manual_seed(0))
            return m.to(dev)

        def train(cfg, step_fn, rows, grad_accum=1):
            m = model_of(cfg)
            opt = optim.BertAdam(dict(m.named_parameters()), DP_LR,
                                 warmup=0.1, t_total=-1)
            step = step_fn(m, opt, mask_image_regions=True,
                           grad_accum=grad_accum)
            losses = [float(step({k: torch.from_numpy(v[rows]).to(dev)
                                  for k, v in nb.items()},
                                 ts.step_seed(11, i))["loss"])
                      for i, nb in enumerate(batches)]
            return m, losses

        def dp(m, opt, **kw):
            return make_dp_train_step(m, opt, dist, **kw)

        mine = slice(rank * half, (rank + 1) * half)
        fp32 = base.replace(dtype="float32", hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
        m, res["fp32_losses"] = counted("fp32", lambda: train(fp32, dp, mine))
        res["fp32_hash"] = param_hash(m)
        if rank == 0:
            ref, res["fp32_ref_losses"] = train(
                fp32, ts.make_train_step, slice(None), grad_accum=2)
            init = model_of(fp32).state_dict()
            got, want = m.state_dict(), ref.state_dict()
            res["fp32_max_abs_err"] = max(
                (got[k].float() - want[k].float()).abs().max().item()
                for k in got)
            res["fp32_within_tol"] = all(
                torch.allclose(got[k].float(), want[k].float(), **FP32_TOL)
                for k in got)
            res["fp32_moved"] = max((got[k].float() - init[k].float()).abs()
                                    .max().item() for k in got)
            del ref, init
        del m
        m, res["bf16_losses"] = counted("bf16", lambda: train(
            base.replace(dtype="bfloat16"), dp, mine))
        res["bf16_hash"] = param_hash(m)
        del m

        cfg, model, svocab, batch, srng = _scst_setup(
            vocab_path, 8, 0, dtype="bfloat16", num_hidden_layers=DP2_LAYERS)
        model = model.to(dev)
        tr = scst.SCSTTrainer(
            model, cfg, mask_id=svocab["[MASK]"], eos_id=svocab["[SEP]"],
            max_tgt_length=SCST_T, dist=dist, optimizer=optim.BertAdam(
                dict(model.named_parameters()), 1e-6))
        # the ground truth: the global batch's greedy captions for even
        # examples, random ids for odd ones, so that the greedy n-grams
        # carry CIDEr weight and the rewards (and the gradients) are not
        # 0, as they mostly are for random weights
        greedy, _ = tr.decoder.greedy({k: torch.from_numpy(v).to(dev)
                                       for k, v in batch.items()})
        gt = scst.clean_rollout(greedy.cpu().numpy(), svocab["[SEP]"], 0)
        gt[1::2] = srng.integers(1000, cfg.vocab_size, size=(4, SCST_T))
        gt = np.concatenate([gt, np.full((8, 1), svocab["[SEP]"])], axis=1)
        rows = slice(rank * 4, (rank + 1) * 4)
        tb = {k: torch.from_numpy(v[rows]).to(dev) for k, v in batch.items()}
        res["scst_losses"] = counted("scst", lambda: [
            tr.step(tb, gt[rows], ts.step_seed(5, i))[0] for i in range(2)])
        res["scst_hash"] = param_hash(model)
        res["allreduce_ms"] = dist.reduction_ms()
    finally:
        dist.destroy()
    with open(out, "w") as f:
        json.dump(res, f)


def phase_dp_two_ranks(vocab_path, out_dir):
    """Two ranks on the one card (``dp_worker``, spawned as two processes of
    this script): fp32 DP equals the single-process step on the global
    batch within FP32_TOL, and after bf16 training and SCST the two ranks'
    parameters are bit-identical.  Each rank's launches in each of the
    three runs must be what its steps launch.  Returns the three runs'
    launch counts, summed over the ranks."""
    port = free_port()
    outs = [os.path.join(out_dir, f"dp2_rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-worker", str(r),
         str(port), vocab_path, outs[r]]) for r in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0, 0]:
        fail(f"DP two ranks: the workers exited with {rcs}")
    r0, r1 = (json.load(open(o)) for o in outs)
    log(f"DP two ranks fp32: losses {r0['fp32_losses']} / "
        f"{r1['fp32_losses']}, single-process {r0['fp32_ref_losses']}; "
        f"max |param - single-process| {r0['fp32_max_abs_err']:.3e} (tol "
        f"{FP32_TOL}), params moved up to {r0['fp32_moved']:.3e}")
    if not (r0["fp32_within_tol"] and r0["fp32_moved"] > 1e-4):
        fail("DP two ranks fp32: parameters differ from the single-process "
             "step on the global batch, or did not move")
    if not all(np.isfinite(x) and x != 0 for x in r0["scst_losses"]):
        fail(f"DP two ranks SCST: losses {r0['scst_losses']}, not finite "
             "and non-zero")
    for what in ("fp32", "bf16", "scst"):
        if r0[f"{what}_hash"] != r1[f"{what}_hash"]:
            fail(f"DP two ranks {what}: the ranks' parameters differ")
        if r0[f"{what}_losses"] != r1[f"{what}_losses"]:
            fail(f"DP two ranks {what}: the ranks report different losses")
    log(f"DP two ranks: fp32, bf16 (losses {r0['bf16_losses']}) and SCST "
        f"(losses {r0['scst_losses']}) replicas bit-identical; gloo "
        f"all-reduce ms {[round(x, 2) for x in r0['allreduce_ms']]}")
    # each rank's launches, per run: 2 steps of one micro-batch,
    # DP2_LAYERS layers
    n = 2 * DP2_LAYERS
    zero = {k: 0 for k in r0["counts"]["fp32"]}
    step = dict(zero, attention_fwd_drop=n, attention_bwd=n,
                **adam_launches(2))
    dec = n * (SCST_T - 1)
    want = {"fp32": step, "bf16": step,
            "scst": dict(zero, attention_fwd=n, attention_fwd_drop=2 * n,
                         attention_bwd=n, decode_attention=dec,
                         decode_attention_drop=dec,
                         decode_dropout_scales=n, **adam_launches(2))}
    for r in (r0, r1):
        if r["counts"] != want:
            fail(f"DP two ranks launch counts {r['counts']}, expected {want}")
    log(f"DP two ranks launch counts per rank as expected: {want}")
    return {k: sum(r["counts"][run][k] for r in (r0, r1) for run in want)
            for k in zero}


# ---- phase 7: tensor parallelism (--tensor_parallel 2) ----------------------
TP_HEADS = (6, 3)            # phase 7a: a rank's heads at tp = 2 and 4
TP_STEPS = 4                 # phase 7c: train CLI steps
TP_B = 64                    # phase 7c: global batch (dp = 1)
TP_ANSWERS = 3129            # phase 7e(a): the VQA step's answer vocab


def phase_tp_kernels(dev, results):
    """Phase 7a: K1 (both branches) and K2 at a tensor-parallel rank's
    heads, H = 6 (tp = 2) and H = 3 (tp = 4), B=64, L=128, in fp32, bf16
    and fp16, each against its plain version with phase 2's tolerances
    (dropout at rate 0 and 0.1, the seed folded as rank 1's,
    ``step_seed(TRAIN_SEED, 1)``); ``dropout_mask`` at H = 6 with that
    seed bit for bit against ``philox.keep_scale``; the bf16 dropout
    branch and K2 timed (``form_times``: kernel, plain version, SDPA, the
    bound).  Results under ``attention_fwd_drop_h6`` / ``attention_bwd_h6``
    (the H = 6 times at their top level, H = 3 under ``h3``)."""
    from vlp_tpu_torch.ops import attention as attn
    from vlp_tpu_torch.ops import philox

    g = torch.Generator(device=dev).manual_seed(3)
    B, L, P, rate = 64, 128, 102, 0.1
    seed = seed_arg(attn, philox.step_seed(TRAIN_SEED, 1), dev)
    mask = attn.dropout_mask(B, 6, L, rate, seed, dev)
    want = philox.keep_scale(seed, B, 6, L, rate, device=dev)
    torch.cuda.synchronize()
    if not torch.equal(mask, want):
        fail(f"dropout_mask H=6: {(mask != want).sum().item()} multipliers "
             "differ from the plain Philox under the tp-folded seed")
    log(f"dropout_mask B={B} H=6 L={L}, tp-folded seed: bit-exact, keep "
        f"fraction {(mask > 0).float().mean().item():.5f}")
    del mask, want
    for H in TP_HEADS:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q, k, v, mode, te, ck, dout = train_inputs(g, dev, dtype, B, L,
                                                       H=H)
            tag = f"H={H} B={B} L={L} {dtype} ({body(dtype)})"
            e = errs.setdefault(str(dtype)[6:], {})
            e["attention_fwd"] = compare(
                f"K1 {tag}", attn.attention(q, k, v, mode, te, ck, prefix=P),
                attn.attention_plain(q, k, v, mode, te, ck, prefix=P),
                TOL[dtype])
            for r in (0.0, rate):
                e["attention_fwd_drop"] = max(e.get("attention_fwd_drop", 0),
                                              compare(
                    f"K1 dropout {tag} rate={r}",
                    attn._forward_cuda(q, k, v, mode, te, ck, P,
                                       dropout=(r, seed)),
                    attn.attention_plain(q, k, v, mode, te, ck, prefix=P,
                                         dropout_rate=r, seed=seed),
                    TOL[dtype]))
                got = attn._backward_cuda(q, k, v, mode, te, ck, dout, P, r,
                                          seed)
                ref = attn.attention_bwd_plain(q, k, v, mode, te, ck, dout,
                                               prefix=P, dropout_rate=r,
                                               seed=seed)
                for n, a, b_ in zip(("dq", "dk", "dv"), got, ref):
                    e["attention_bwd"] = max(e.get("attention_bwd", 0),
                                             compare(f"K2 {n} {tag} rate={r}",
                                                     a, b_, TOL[dtype]))
            del q, k, v, dout
        q, k, v, mode, te, ck, dout = train_inputs(g, dev, torch.bfloat16, B,
                                                   L, H=H)
        times = form_times(attn, q, k, v, mode, te, ck, dout, P, rate, seed,
                           forms=(1, 2))
        del q, k, v, dout
        for name, r in times.items():
            log_times(f"{name} H={H}", r)
            r.update(H=H, max_abs_err=errs["bfloat16"][name],
                     max_abs_err_by_dtype={d: x[name]
                                           for d, x in errs.items()})
            entry = results.setdefault(f"{name}_h6", {})
            if H == 6:
                entry.update(r)
            else:
                entry[f"h{H}"] = r


def tp_flags(vocab_path, out, *extra):
    """Phase 7c's train CLI flags: phase 4b's (``train_flags``) with
    ``--tensor_parallel 2``, one epoch of TP_STEPS steps, a profile of
    step 2 (rank 0's ``profile.txt``)."""
    return train_flags(vocab_path, out) + [
        "--tensor_parallel", "2", "--num_train_epochs", "1",
        "--steps_per_epoch", str(TP_STEPS), "--profile_steps", "1", *extra]


def _largest_gap(got, want) -> tuple:
    """(max |got - want| over a state dict's entries, the entry's name)."""
    return max(((got[k].float() - want[k].float()).abs().max().item(), k)
               for k in want)


RELU_INPUTS = ("vis_embed.0", "vis_embed.2", "vis_pe_embed.0")


def _relu_signs(sd, b) -> list:
    """Which inputs of the region MLPs' and the geometry projection's
    ReLUs (the outputs of RELU_INPUTS) are positive, for state dict
    ``sd`` on batch ``b`` (the plain fp32 products)."""
    import torch.nn.functional as F
    with torch.no_grad():
        a0 = F.linear(b["vis_feats"].float(), sd["vis_embed.0.weight"],
                      sd["vis_embed.0.bias"])
        a2 = F.linear(F.relu(a0), sd["vis_embed.2.weight"],
                      sd["vis_embed.2.bias"])
        p = F.linear(b["vis_pe"].float(), sd["vis_pe_embed.0.weight"],
                     sd["vis_pe_embed.0.bias"])
    return [t > 0 for t in (a0, a2, p)]


def _relu_flips(sa, sb, b) -> dict:
    """How many of those ReLU inputs differ in sign between two states,
    by layer."""
    return {n: int((x != y).sum()) for n, x, y in zip(
        RELU_INPUTS, _relu_signs(sa, b), _relu_signs(sb, b))}


@contextlib.contextmanager
def _halved_region_product(model):
    """One process's ``model.vis_embed[2]`` as two half-sums over its input
    dim added together, what the row-parallel g gives at tp = 2 (the
    module's other denses unchanged): fp32 reassociation without tensor
    parallelism."""
    import torch.nn.functional as F
    from vlp_tpu_torch.models import model as mm
    plain = mm._row_parallel

    def halves(lin, x, tp):
        if lin is not model.vis_embed[2]:
            return plain(lin, x, tp)
        h = x.shape[-1] // 2
        w = lin.weight.to(x.dtype)
        return ((F.linear(x[..., :h], w[:, :h])
                 + F.linear(x[..., h:], w[:, h:])) + lin.bias.to(x.dtype))

    mm._row_parallel = halves
    try:
        yield
    finally:
        mm._row_parallel = plain


def fp32_tp_steps(rank, dist, dev, cfg, task, batches, layout, tag,
                  restart=False) -> dict:
    """Phase 7b / 7e(a): fp32 steps of one task on this rank's shard
    under ``layout`` (seeds ``step_seed(11, i)``), the gathered
    parameters after each, and on rank 0 the single-process steps on the
    same batches from the same init beside them.  ``restart``: each
    single-process step starts from the tensor-parallel run's gathered
    state (parameters and BertAdam's moments) before that step, so each
    step is held against one process's step from the same state; beside
    it two single-process runs go on freely, one plain and one with its
    region product halved (``_halved_region_product``), and the gaps to
    the plain run are reported, not gated: the tensor-parallel run's, the
    halved run's and the restarted run's (one process's steps from the
    tensor-parallel run's states), with the ReLU inputs whose sign differs
    after the first step.  Returns ``{tag}_losses`` and on rank 0
    ``{tag}_ref_losses``, ``{tag}_max_abs_err`` (the largest over the
    steps), ``{tag}_within_tol`` (parameters and losses within FP32_TOL
    after every step), ``{tag}_moved`` and with ``restart`` the
    ``{tag}_free_running`` gaps and flips (tensor-parallel and halved runs
    against the plain one)."""
    from vlp_tpu_torch import optim
    from vlp_tpu_torch import train_step as ts
    from vlp_tpu_torch.models.model import VLPModel
    from vlp_tpu_torch.parallel import mesh
    from vlp_tpu_torch.parallel.tp_step import (make_tp_train_step,
                                                sharded_names)

    vqa = task == "vqa2"

    def model_of():
        m = VLPModel(cfg, with_vqa=vqa)
        m.init_weights(torch.Generator().manual_seed(0))
        return m.to(dev)

    def single():
        ref = model_of()
        ropt = optim.BertAdam(dict(ref.named_parameters()), DP_LR,
                              warmup=0.1, t_total=-1)
        return ref, ropt, ts.make_train_step(ref, ropt, **kw)

    kw = dict(mask_image_regions=not vqa, task=task)
    m = model_of().shard_(dist.tensor_parallel, layout=layout)
    opt = optim.BertAdam(dict(m.named_parameters()), DP_LR, warmup=0.1,
                         t_total=-1, clip_group=dist.tp_group,
                         clip_sharded=sharded_names(m))
    step = make_tp_train_step(m, opt, dist, **kw)

    def gathered(sd):
        return mesh.gather_full(sd, dist.tp_index, 2, dist.tp_group,
                                m.tp_specs)

    res = {f"{tag}_losses": [], f"{tag}_ref_losses": []}
    ref = free = halved = init = None
    if rank == 0:
        ref, ropt, rstep = single()
        if restart:
            free, halved = single(), single()
        init = model_of().state_dict()
    errs, ok, after_first = [], True, None
    for i, b in enumerate(batches):
        seed = ts.step_seed(11, i)
        if free is not None and i == 1:
            plain = free[0].state_dict()
            res[f"{tag}_free_running_relu_flips"] = {
                "tp": _relu_flips(after_first, plain, b),
                "halved": _relu_flips(halved[0].state_dict(), plain, b)}
        if restart and i:
            state = (gathered(m.state_dict()), gathered(opt.m),
                     gathered(opt.v))
            if rank == 0:
                ref.load_state_dict(state[0])
                for mine, theirs in ((ropt.m, state[1]), (ropt.v, state[2])):
                    for n, t in mine.items():
                        t.copy_(theirs[n])
        res[f"{tag}_losses"].append(float(step(b, seed)["loss"]))
        got = gathered(m.state_dict())
        if rank == 0:
            res[f"{tag}_ref_losses"].append(float(rstep(b, seed)["loss"]))
            want = ref.state_dict()
            errs.append(max((got[k].float() - want[k].float()).abs().max()
                            .item() for k in want))
            ok = ok and all(torch.allclose(got[k].float(), want[k].float(),
                                           **FP32_TOL) for k in want)
            if free is not None:
                free[2](b, seed)
                with _halved_region_product(halved[0]):
                    halved[2](b, seed)
                if i == 0:
                    after_first = {k: v.clone() for k, v in got.items()}
    if rank == 0:
        res[f"{tag}_max_abs_err"] = max(errs)
        res[f"{tag}_within_tol"] = ok and bool(np.allclose(
            res[f"{tag}_losses"], res[f"{tag}_ref_losses"], **FP32_TOL))
        res[f"{tag}_moved"] = max(
            (got[k].float() - init[k].float()).abs().max().item()
            for k in init)
        if free is not None:
            plain = free[0].state_dict()
            res[f"{tag}_free_running_max_abs_err"], res[
                f"{tag}_free_running_worst"] = _largest_gap(got, plain)
            res[f"{tag}_halved_max_abs_err"], res[
                f"{tag}_halved_worst"] = _largest_gap(
                    halved[0].state_dict(), plain)
            res[f"{tag}_restarted_max_abs_err"], res[
                f"{tag}_restarted_worst"] = _largest_gap(
                    ref.state_dict(), plain)
    return res


def replicated_hash(model) -> str:
    """sha256 of the parameters the model's tensor-parallel layout leaves
    whole (``model.tp_specs``)."""
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        if model.tp_specs.get(k) is None:
            h.update(k.encode())
            h.update(v.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def tp_worker(rank: int, port: int, vocab_path: str, out_dir: str,
              out: str, backend: str, layout: str = "shard_map") -> None:
    """Rank ``rank`` of dp x tp = 1 x 2 under ``--tp_impl layout``, its
    group formed here: gloo, both ranks on cuda:0 (NCCL refuses two ranks
    on one device), or NCCL on cuda:{rank}.  Under gloo: (b) two fp32 TP
    steps at bert-base width, DP2_LAYERS deep, dropout 0, global B=16, and
    on rank 0 the single-process step on the same batch beside them (under
    ``"gspmd"``, phase 7e(a), with ``--relax_projection`` and label
    smoothing 0.1, each step from the same state, then one VQA step); then
    (c) the train CLI (``tp_flags``), which adopts the group.  Under NCCL:
    the CLI, then the CLI with ``--device_loop_steps 2``.  Writes each CLI
    run's launch counts, losses, step times, replicated-parameter hash,
    parameter and moment bytes, peak allocated bytes and the model's
    collectives of a step (every all-reduce of ``ops.tp``, recorded during
    the run: shape, dtype, op), then the time of the main run's step of
    recorded collectives replayed and of the batch's broadcast, to
    ``out``."""
    import torch.distributed as tdist

    import vlp_tpu_torch
    from vlp_tpu_torch import parallel
    from vlp_tpu_torch.cli import train as train_cli
    from vlp_tpu_torch.cli.common import resolve_tokenizer
    from vlp_tpu_torch.config import VLPConfig
    from vlp_tpu_torch.data.example_builder import TrainExampleBuilder, collate
    from vlp_tpu_torch.ops import _build
    from vlp_tpu_torch.ops import tp as tp_ops

    vlp_tpu_torch.configure_precision()
    gspmd = layout == "gspmd"
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    tdist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                             world_size=2, rank=rank)
    res = {"counts": {}}
    try:
        if backend == "gloo":
            vocab = resolve_tokenizer(vocab_path, False).vocab
            words = [w for w in vocab if not w.startswith("[")]
            rng = np.random.default_rng(0)
            GB = 16
            cfg = VLPConfig(vocab_size=len(vocab), relax_projection=0,
                            max_pred=3, num_hidden_layers=DP2_LAYERS,
                            dtype="float32", hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
            if gspmd:
                cfg = cfg.replace(relax_projection=4, label_smoothing=0.1,
                                  num_answers=TP_ANSWERS)
            nv = cfg.len_vis_input

            def batch_of(task):
                exs = []
                for i in range(GB):
                    vqa = task == "vqa2"
                    b = TrainExampleBuilder(
                        cfg, vocab, mode="bi" if vqa or i % 2 == 0
                        else "s2s", vis_mask_prob=0.0 if vqa else 0.2,
                        mask_prob=0.0 if vqa else 0.15, load_vqa_ann=vqa)
                    toks = [words[j] for j in rng.integers(0, len(words), 9)]
                    kw = {}
                    if vqa:
                        scores = np.zeros(TP_ANSWERS, np.float32)
                        scores[rng.choice(TP_ANSWERS, 3, replace=False)] = (
                            rng.choice([0.3, 0.6, 1.0], 3))
                        kw = dict(ans_scores=scores)
                    exs.append(b(toks, rng.normal(size=(nv, cfg.vis_feat_dim)),
                                 rng.uniform(size=(nv, cfg.vis_pe_dim)), rng,
                                 **kw))
                return {k: torch.from_numpy(v).to(dev)
                        for k, v in collate(exs).items()}

            dist = parallel.from_cli("cuda").with_tensor_parallel(2)
            tasks = [("img2txt", [batch_of("img2txt") for _ in range(2)])]
            if gspmd:
                tasks.append(("vqa2", [batch_of("vqa2")]))
            for task, batches in tasks:
                tag = "fp32" if task == "img2txt" else "fp32_vqa"
                res.update(fp32_tp_steps(rank, dist, dev, cfg, task,
                                         batches, layout, tag,
                                         restart=gspmd))
            torch.cuda.empty_cache()
        runs = [("main", [])]
        if backend == "nccl":
            runs.append(("loop", ["--device_loop_steps", "2"]))
        calls = []
        all_reduce_ = tp_ops._all_reduce_

        def recorded(t, group, op=tdist.ReduceOp.SUM):
            calls.append((list(t.shape), str(t.dtype)[6:], str(op)))
            return all_reduce_(t, group, op)

        prefix = "tp_gspmd" if gspmd else "tp"
        for name, extra in runs:
            calls.clear()
            tp_ops._all_reduce_ = recorded
            torch.cuda.reset_peak_memory_stats(dev)
            _build.reset_launch_counts()
            r = train_cli.main(tp_flags(
                vocab_path, os.path.join(out_dir, f"{prefix}_{name}"),
                "--tp_impl", layout, *extra))
            torch.cuda.synchronize()
            tp_ops._all_reduce_ = all_reduce_
            res["counts"][name] = {k: v.launches
                                   for k, v in _build.KERNELS.items()}
            opt = r["optimizer"]
            res[name] = dict(
                losses=r["losses"],
                hash=replicated_hash(r["model"]),
                param_bytes=sum(p.numel() * p.element_size()
                                for p in r["model"].parameters()),
                moment_bytes=sum(t.numel() * t.element_size()
                                 for d in (opt.m, opt.v)
                                 for t in d.values()),
                peak_allocated_bytes=torch.cuda.max_memory_allocated(dev),
                collectives=calls[:len(calls) // TP_STEPS],
                n_collectives=len(calls),
                profile=busy_share(os.path.join(out_dir, f"{prefix}_{name}"))
                if rank == 0 else None)
            del r, opt
            torch.cuda.empty_cache()
        # one step's recorded collectives, replayed on tensors of their
        # shapes, and its batch broadcast (the region features, the bulk of
        # it): host clock around a synchronised group, the second reading
        step_calls = [(torch.ones(shape, device=dev,
                                  dtype=getattr(torch, dtype)),
                       getattr(tdist.ReduceOp, op.split(".")[-1]))
                      for shape, dtype, op in res["main"]["collectives"]]
        feats = torch.randn(TP_B, 100, 2048, device=dev)
        for key, fn in (("collectives_ms_per_step",
                         lambda: [tdist.all_reduce(t, op=op)
                                  for t, op in step_calls]),
                        ("broadcast_ms_per_step",
                         lambda: tdist.broadcast(feats, src=0))):
            for _ in range(2):
                torch.cuda.synchronize()
                tdist.barrier()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                res[key] = (time.perf_counter() - t0) * 1e3
    finally:
        tdist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


def run_tp_workers(vocab_path, out_dir, backend, layout="shard_map"):
    """The two ``tp_worker`` processes (this script with ``--tp-worker``)
    under ``--tp_impl layout``; returns their records in rank order."""
    port = free_port()
    outs = [os.path.join(out_dir, f"tp_{layout}_{backend}_rank{r}.json")
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-worker", str(r),
         str(port), vocab_path, out_dir, outs[r], backend, layout])
        for r in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0, 0]:
        fail(f"TP {layout} {backend}: the workers exited with {rcs}")
    return [json.load(open(o)) for o in outs]


def check_tp_runs(recs, backend, gpu_line, path="tp2") -> dict:
    """Each CLI run of the workers: exactly 12 x TP_STEPS K1-dropout and K2
    launches a rank (at H = 6) and nothing else, finite losses that the
    ranks report alike, replicated parameters bit-identical across the
    ranks, a whole number of steps' collectives.  Returns, under keys
    ``{path}_{backend}_...``, the runs' launch counts summed over the
    ranks, rates, rank 0's parameter + moment and peak allocated bytes,
    the collectives of a step and their replayed time."""
    r0, r1 = recs
    pre = f"{path}_{backend}"
    out = {}
    for name in r0["counts"]:
        zero = {k: 0 for k in r0["counts"][name]}
        want = dict(zero, attention_fwd_drop=12 * TP_STEPS,
                    attention_bwd=12 * TP_STEPS, **adam_launches(TP_STEPS))
        for r in recs:
            if r["counts"][name] != want:
                fail(f"TP {pre} {name}: launch counts "
                     f"{r['counts'][name]}, expected {want} a rank")
        losses = r0[name]["losses"]
        if len(losses) != TP_STEPS or not np.isfinite(losses).all():
            fail(f"TP {pre} {name}: bad losses {losses}")
        if r1[name]["losses"] != losses:
            fail(f"TP {pre} {name}: the ranks report different losses")
        if r0[name]["hash"] != r1[name]["hash"]:
            fail(f"TP {pre} {name}: the replicated parameters of the "
                 "two ranks differ")
        # steps 3 and 4: step 1 sets up, step 2 runs under the profiler
        if r0[name]["n_collectives"] % TP_STEPS:
            fail(f"TP {pre} {name}: {r0[name]['n_collectives']} "
                 f"collectives in {TP_STEPS} steps")
        out[f"{pre}_{name}_profile"] = r0[name]["profile"]
        for key in ("param_bytes", "moment_bytes", "peak_allocated_bytes"):
            out[f"{pre}_{name}_{key}"] = r0[name][key]
        colls = r0[name]["collectives"]
        out[f"{pre}_{name}_collectives_per_step"] = len(colls)
        out[f"{pre}_{name}_collective_bytes_per_step"] = sum(
            int(np.prod(shape)) * torch.tensor([], dtype=getattr(
                torch, dtype)).element_size() for shape, dtype, _ in colls)
        log(f"TP {pre} {name}: rank 0 holds {r0[name]['param_bytes']} "
            f"parameter + {r0[name]['moment_bytes']} moment bytes, peak "
            f"allocated {r0[name]['peak_allocated_bytes']} bytes; "
            f"{len(colls)} collectives a step "
            f"({out[f'{pre}_{name}_collective_bytes_per_step']} "
            "bytes)")
        log(f"TP {pre} {name}: launch counts a rank as expected "
            f"({12 * TP_STEPS} K1-dropout + {12 * TP_STEPS} K2 at H=6), "
            f"losses {losses}, replicated parameters bit-identical "
            f"({backend}) on {gpu_line}; rank 0's profile of step 2: "
            f"{r0[name]['profile']}")
        out[f"{pre}_{name}_counts"] = {
            k: r0["counts"][name][k] + r1["counts"][name][k] for k in zero}
    for key in ("collectives_ms_per_step", "broadcast_ms_per_step"):
        out[f"{pre}_{key}"] = r0[key]
    return out


def phase_tp_main_path(vocab_path, out_dir, gpu_line):
    """Phase 7b-7d.  (b) fp32 TP steps equal the single-process step within
    FP32_TOL (phase 6b's tolerance for ``dp_step``); (c) the train CLI with
    ``--tensor_parallel 2`` on two gloo ranks sharing the card: launches,
    bit-identical replicated parameters and the f/g all-reduce time a
    step (gloo through the host on one card, not NVLink), then the
    gathered ``model.1.bin`` loaded into a world-1 model decodes a batch
    on K1 + K4; (d) with two or more GPUs, the CLI over NCCL, eager and
    with ``--device_loop_steps 2``.  Returns (the gloo run's launch
    counts summed over the ranks, rates)."""
    recs = run_tp_workers(vocab_path, out_dir, "gloo")
    r0 = recs[0]
    log(f"TP fp32 (b): losses {recs[0]['fp32_losses']} / "
        f"{recs[1]['fp32_losses']}, single-process "
        f"{r0['fp32_ref_losses']}; max |gathered param - single-process| "
        f"{r0['fp32_max_abs_err']:.3e} (tol {FP32_TOL}, losses too), params "
        f"moved up to {r0['fp32_moved']:.3e}")
    if not (r0["fp32_within_tol"] and r0["fp32_moved"] > 1e-4):
        fail("TP fp32: the gathered parameters or the losses differ from "
             "the single-process step, or the step did not move them")
    rates = check_tp_runs(recs, "gloo", gpu_line)
    log(f"TP gloo, a step's f/g all-reduces "
        f"({rates['tp2_gloo_main_collectives_per_step']} recorded, replayed) "
        f"{r0['collectives_ms_per_step']:.2f} ms, the batch's broadcast (its "
        f"[{TP_B}, 100, 2048] fp32 features) "
        f"{r0['broadcast_ms_per_step']:.2f} ms: gloo through the host on "
        "one card, not NVLink")
    decode_gathered(vocab_path, os.path.join(out_dir, "tp_main"),
                    os.path.join(out_dir, "tp_decode"), "TP")
    if torch.cuda.device_count() >= 2:
        rates.update(check_tp_runs(run_tp_workers(vocab_path, out_dir,
                                                  "nccl"), "nccl", gpu_line))
        log("phase 7d: TP over NCCL, eager and with --device_loop_steps 2, "
            "as expected")
    else:
        log(f"phase 7d: not run: {torch.cuda.device_count()} GPU on this "
            "machine, and NCCL (which the TP device loop's CUDA graph needs) "
            "takes one device a rank")
    return rates.pop("tp2_gloo_main_counts"), rates


def decode_gathered(vocab_path, ckpt_dir, dec_out, what):
    """The gathered ``model.1.bin`` of a tensor-parallel CLI run, loaded
    into a world-1 model, decodes 100 images (beam 5) on K1 + K4 and on
    nothing else."""
    from vlp_tpu_torch.cli import decode as decode_cli
    from vlp_tpu_torch.ops import _build

    _build.reset_launch_counts()
    stats = decode_cli.main([
        "--bert_model", vocab_path, "--new_segment_ids", "--enable_butd",
        "--synthetic_data", "--num_synthetic", "100", "--batch_size", "100",
        "--beam_size", "5", "--max_tgt_length", "20", "--device", "cuda",
        "--model_recover_path", os.path.join(ckpt_dir, "model.1.bin"),
        "--output_dir", dec_out])["model.1.bin"]
    torch.cuda.synchronize()
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    want = dict({k: 0 for k in counts}, attention_fwd=12,
                decode_attention_anc=12 * 19)
    with open(os.path.join(dec_out, "preds-model.1.bin-val.json")) as f:
        preds = json.load(f)
    if stats["n_images"] != 100 or len(preds) != 100 or counts != want:
        fail(f"{what} model.1.bin did not decode on K1 + K4: {stats}, launch "
             f"counts {counts}, expected {want}")
    log(f"{what} gathered model.1.bin decodes in a world-1 model (K1 + K4 "
        f"as expected): {preds[0]['caption']!r}")


def phase_tp_gspmd_main_path(vocab_path, out_dir, gpu_line, tp_rates):
    """Phase 7e: ``--tp_impl gspmd`` on two gloo ranks sharing the card.
    (a) fp32 GSPMD steps (bert-base width, DP2_LAYERS deep, dropout 0,
    ``--relax_projection``, label smoothing 0.1, region masking; then one
    VQA step) equal the single-process steps within FP32_TOL; (b) the
    train CLI with ``--tensor_parallel 2 --tp_impl gspmd`` (phase 7c's
    flags): launches at H = 6, bit-identical replicated parameters, the
    collectives of a step and their time, a rank's
    parameter + moment bytes and peak allocation beside phase 7c's
    shard_map run (``tp_rates``), and the gathered ``model.1.bin``
    decoding on K1 + K4 in world 1.  Returns (the CLI run's launch counts
    summed over the ranks, rates)."""
    recs = run_tp_workers(vocab_path, out_dir, "gloo", layout="gspmd")
    r0 = recs[0]
    rates = {}
    for tag, what in (("fp32", "img2txt, 2 steps"), ("fp32_vqa", "vqa2")):
        log(f"TP gspmd {tag} ({what}): losses {recs[0][f'{tag}_losses']} / "
            f"{recs[1][f'{tag}_losses']}, single-process from the same "
            f"state {r0[f'{tag}_ref_losses']}; max |gathered param - "
            f"single-process| after a step {r0[f'{tag}_max_abs_err']:.3e} "
            f"(tol {FP32_TOL}, losses too), params moved up to "
            f"{r0[f'{tag}_moved']:.3e}; not gated, free-running against "
            f"the plain single-process run: GSPMD "
            f"{r0[f'{tag}_free_running_max_abs_err']:.3e} in "
            f"{r0[f'{tag}_free_running_worst']}, one process with "
            f"vis_embed.2's product halved "
            f"{r0[f'{tag}_halved_max_abs_err']:.3e} in "
            f"{r0[f'{tag}_halved_worst']}, one process restarted from "
            f"the GSPMD states {r0[f'{tag}_restarted_max_abs_err']:.3e} in "
            f"{r0[f'{tag}_restarted_worst']}; ReLU inputs of differing sign "
            f"after step 1 "
            f"{r0.get(f'{tag}_free_running_relu_flips', 'n/a (one step)')}")
        for k in ("max_abs_err", "free_running_max_abs_err",
                  "free_running_worst", "halved_max_abs_err", "halved_worst",
                  "restarted_max_abs_err", "restarted_worst",
                  "free_running_relu_flips"):
            if f"{tag}_{k}" in r0:
                rates[f"tp2_gspmd_{tag}_{k}"] = r0[f"{tag}_{k}"]
        if not (r0[f"{tag}_within_tol"] and r0[f"{tag}_moved"] > 1e-4):
            fail(f"TP gspmd {tag}: the gathered parameters or the losses "
                 "differ from the single-process step, or the step did not "
                 "move them")
    rates.update(check_tp_runs(recs, "gloo", gpu_line, path="tp2_gspmd"))
    g, m = "tp2_gspmd_gloo_main", "tp2_gloo_main"
    both = {**tp_rates, **rates}
    state = {k: both[f"{k}_param_bytes"] + both[f"{k}_moment_bytes"]
             for k in (g, m)}
    rates["tp2_gspmd_state_bytes_saved_per_rank"] = state[m] - state[g]
    rates["tp2_gspmd_peak_bytes_saved_per_rank"] = (
        both[f"{m}_peak_allocated_bytes"] - both[f"{g}_peak_allocated_bytes"])
    log(f"TP gspmd vs shard_map, rank 0: parameter + moment bytes "
        f"{state[g]} vs {state[m]} ({state[m] - state[g]} fewer), peak "
        f"allocated {both[f'{g}_peak_allocated_bytes']} vs "
        f"{both[f'{m}_peak_allocated_bytes']}; collectives a step "
        f"{both[f'{g}_collectives_per_step']} vs "
        f"{both[f'{m}_collectives_per_step']}, replayed "
        f"{both['tp2_gspmd_gloo_collectives_ms_per_step']:.2f} vs "
        f"{both['tp2_gloo_collectives_ms_per_step']:.2f} ms (gloo through "
        f"the host on one card) on {gpu_line}")
    if state[g] >= state[m]:
        fail("TP gspmd: a rank holds no fewer parameter and moment bytes "
             "than under shard_map")
    decode_gathered(vocab_path, os.path.join(out_dir, "tp_gspmd_main"),
                    os.path.join(out_dir, "tp_gspmd_decode"), "TP gspmd")
    return rates.pop(f"{g}_counts"), rates


def phase_e2e_learn(gpu_line):
    """Phase 8: the learnability proof at bert-base width, bf16
    (``vlp_tpu_torch.cli.e2e_synthetic``, dropout 0.1, B=E2E_B):
    E2E_STEPS MLE steps in device-loop groups of 10 (one CUDA-graph
    replay a group: K1 dropout + K2), greedy CIDEr before and after (K1 +
    K3), E2E_SCST_STEPS SCST steps (K1 + K3 greedy, K1 dropout + K5
    sampled, the replay's K1 dropout + K2 + K6), and then the trained
    model's beam-5 CIDEr over the same 32 eval images (K1 + K4).  Fails
    if the tool prints FAIL, if beam 5 is not above the tool's bar,
    max(1, untrained + 1), or if the kernels were not launched as the
    run's counts say."""
    from vlp_tpu_torch.cli import e2e_synthetic as e2e
    from vlp_tpu_torch.ops import _build

    _build.reset_launch_counts()
    t0 = time.time()
    res = e2e.main(["--batch", str(E2E_B), "--steps", str(E2E_STEPS),
                    "--scst_steps", str(E2E_SCST_STEPS), "--device", "cuda"])
    beam, caps = res["task"].score(res["model"], beam_size=5)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    n_mle, n_scst = res["steps"], res["scst_steps"]
    evals, steps = 3, 12 * (res["task"].cfg.max_len_b - 1)
    want = dict({k: 0 for k in counts},
                attention_fwd=12 * (evals + n_scst + 1),
                attention_fwd_drop=12 * n_mle + 24 * n_scst,
                attention_bwd=12 * (n_mle + n_scst),
                decode_attention=steps * (evals + n_scst),
                decode_attention_anc=steps,
                decode_attention_drop=steps * n_scst,
                decode_dropout_scales=12 * n_scst,
                **adam_launches(n_mle + n_scst))
    log(f"e2e_learn launch counts {counts}, expected {want}")
    bar = max(1.0, res["untrained_cider"] + 1.0)
    numbers = {k: v for k, v in res.items() if k not in ("model", "task")}
    numbers.update(beam5_cider=beam, seconds=seconds)
    log(f"phase 8 e2e_learn on {gpu_line}: {json.dumps(numbers)}; beam 5 "
        f"e.g. {caps[0][0]!r}")
    if not res["ok"]:
        fail("phase 8: the learnability tool printed FAIL")
    if not beam > bar:
        fail(f"phase 8: beam-5 CIDEr {beam:.3f} is not above {bar:.3f}")
    if counts != want:
        fail("phase 8 did not launch the kernels as expected")
    return counts, numbers


def phase_steady_state(dev, vocab_path):
    """Device-side decode rate at the main path's shapes, without the CLI's
    loader and first-call costs: one prepared batch of B=100, one warm-up
    call, then the median of REPS_STEADY timed calls per mode; then the
    same decoders and batch through :func:`dispatch_checks`."""
    from vlp_tpu_torch.cli.common import resolve_tokenizer
    from vlp_tpu_torch.config import VLPConfig
    from vlp_tpu_torch.data.example_builder import (DecodeExampleBuilder,
                                                    collate)
    from vlp_tpu_torch.decode import DecodeParams, Decoder
    from vlp_tpu_torch.models.model import VLPModel

    vocab = resolve_tokenizer(vocab_path, False).vocab
    cfg = VLPConfig(vocab_size=len(vocab), relax_projection=0)
    model = VLPModel(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(dev).cast_for_inference().eval()
    rng = np.random.default_rng(0)
    nv = cfg.len_vis_input
    builder = DecodeExampleBuilder(cfg, vocab, new_segment_ids=True)
    batch = collate([builder(
        rng.normal(size=(nv, cfg.vis_feat_dim)).astype(np.float32),
        rng.uniform(size=(nv, cfg.vis_pe_dim)).astype(np.float32))
        for _ in range(100)])
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    decoders = {mode: Decoder(model, cfg, DecodeParams(
        mask_id=vocab["[MASK]"], eos_id=vocab["[SEP]"], beam_size=K,
        max_tgt_length=20, forbid_duplicate_ngrams=True))
        for mode, K in (("beam5", 5), ("greedy", 1))}
    rates = {}
    for mode, dec in decoders.items():
        K = dec.dp.beam_size
        secs = []
        for i in range(REPS_STEADY + 1):
            t = time.perf_counter()
            out = dec(tb)
            if K == 1:
                out = out[0].cpu()   # the beam path ends on the host already
            torch.cuda.synchronize()
            if i:
                secs.append(time.perf_counter() - t)
        rates[mode] = 100 / statistics.median(secs)
        log(f"steady state {mode} B=100: {rates[mode]:.2f} captions/s "
            f"(median of {REPS_STEADY} batches: {sorted(secs)} s)")
    log("steady state: " + dispatch_checks(dev, decoders["beam5"],
                                           decoders["greedy"], batch))
    return rates


def phase_vqa_steady_state(dev, vocab_path):
    """Device-side VQA rate at the eval path's shape, without the CLI's
    example building: one prepared batch of B=256 bi-mode questions (its
    fp32 features uploaded in each call, as the CLI does), bert-base bf16
    with the 3,129-way head, one warm-up call, then the median of
    REPS_STEADY timed calls up to the answer ids on the host."""
    from vlp_tpu_torch.cli.common import resolve_tokenizer
    from vlp_tpu_torch.cli.decode import to_device
    from vlp_tpu_torch.config import VLPConfig
    from vlp_tpu_torch.data.example_builder import TrainExampleBuilder, collate
    from vlp_tpu_torch.models.model import VLPModel

    vocab = resolve_tokenizer(vocab_path, False).vocab
    words = [w for w in vocab if not w.startswith("[")]
    cfg = VLPConfig(vocab_size=len(vocab), relax_projection=0)
    model = VLPModel(cfg, with_vqa=True)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(dev).cast_for_inference().eval()
    rng = np.random.default_rng(0)
    nv = cfg.len_vis_input
    builder = TrainExampleBuilder(cfg, vocab, mode="bi", mask_prob=0.0)
    batch = collate([builder(
        [words[j] for j in rng.integers(0, len(words), 8)],
        rng.normal(size=(nv, cfg.vis_feat_dim)).astype(np.float32),
        rng.uniform(size=(nv, cfg.vis_pe_dim)).astype(np.float32), rng)
        for _ in range(VQA_B)])
    keys = ("input_ids", "segment_ids", "mode", "text_end", "vis_feats",
            "vis_pe")
    batch = {k: batch[k] for k in keys}
    secs = []
    with torch.no_grad():
        for i in range(REPS_STEADY + 1):
            t = time.perf_counter()
            ids = model.vqa_inference(to_device(batch, dev)).cpu()
            if i:
                secs.append(time.perf_counter() - t)
    if ids.shape != (VQA_B,) or not bool((ids >= 1).all()):
        fail("VQA steady state: malformed answer ids")
    rate = VQA_B / statistics.median(secs)
    log(f"steady state VQA B={VQA_B}: {rate:.2f} questions/s (median of "
        f"{REPS_STEADY} batches: {sorted(secs)} s)")
    return rate


def main():
    if sys.argv[1:2] == ["--dp-worker"]:
        rank, port, vocab_path, out = sys.argv[2:6]
        dp_worker(int(rank), int(port), vocab_path, out)
        return
    if sys.argv[1:2] == ["--tp-worker"]:
        rank, port, vocab_path, out_dir, out, backend, layout = sys.argv[2:9]
        tp_worker(int(rank), int(port), vocab_path, out_dir, out, backend,
                  layout)
        return
    if sys.argv[1:2] == ["--ab-times"]:
        ab_times(sys.argv[2])
        return
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an "
             "NVIDIA GPU")
    import vlp_tpu_torch
    from vlp_tpu_torch.cli.common import write_synthetic_vocab
    from vlp_tpu_torch.ops import _build

    vlp_tpu_torch.configure_precision()
    guard_plain_update()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"phase 1: device {kind} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    t = time.time()
    _build.library()
    log(f"phase 1: kernels built from {_build.CSRC} in "
        f"{time.time() - t:.2f} s")
    with open(os.path.join(_build.build_dir(), "build.log")) as f:
        for line in f:
            if any(w in line for w in ("registers", "Compiling entry",
                                       "spill")):
                log("  ptxas: " + line.strip())

    results = {}
    phase_kernels(dev, results)
    phase_train_kernels(dev, results)
    phase_scst_kernels(dev, results)
    phase_bhld_kernels(dev, results)
    phase_fp16_kernels(dev, results)
    phase_seed_slots(dev)
    phase_fused_adam(dev, results)
    phase_mla_kernels(dev, results)
    phase_moe_rows(dev, results)
    log("phase 2: kernels agree with their plain versions")

    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        vocab_path = write_synthetic_vocab(os.path.join(tmp, "vocab.txt"),
                                           size=28996)
        answers_path = write_answer_vocab(os.path.join(tmp, "answers.txt"))
        phase_end_to_end(dev, vocab_path)
        log("phase 3: end-to-end beam traces identical")
        err = phase_train_end_to_end(dev, vocab_path)
        log(f"phase 3b: card and CPU train losses agree (max rel {err:.2e})")
        scst_checks = phase_scst_end_to_end(dev, vocab_path)
        log(f"phase 3c: SCST card vs CPU and replay vs rollout agree "
            f"{scst_checks}")
        vqa_checks = phase_vqa_end_to_end(dev, vocab_path)
        log(f"phase 3d: VQA card vs CPU agree {vqa_checks}")
        paths["decode"], rates = phase_main_path(vocab_path, tmp, smi)
        log("phase 4: decode main path went through its kernels")
        paths["train"], train_rates = phase_train_main_path(vocab_path, tmp,
                                                            smi)
        log("phase 4b: train main path went through its kernels")
        paths["train_l256"] = phase_train_long_main_path(vocab_path, tmp)
        log("phase 4b2: train main path at L=256 went through the long "
            "bodies")
        paths["scst"] = phase_scst_main_path(vocab_path, tmp, smi)
        log("phase 4c: SCST main path went through its kernels")
        paths["vqa_train"], paths["vqa"], vqa_rates = phase_vqa_main_path(
            vocab_path, answers_path, tmp, smi)
        log("phase 4d: VQA train and eval paths went through their kernels")
        paths["bhld"] = phase_bhld_main_path(dev)
        log("phase 4e: the bhld op went through its kernels")
        paths["train_fp16"], fp16_rates = phase_fp16_main_path(vocab_path,
                                                               tmp)
        log("phase 4f: --true_fp16 train main path went through the fp16 "
            "kernels")
        paths["legacy_heads"], heads_errs = phase_legacy_heads(dev)
        log("phase 4g: the legacy heads agree card vs CPU and train")
        paths["train_loop"], loop_rates = phase_train_loop_main_path(
            vocab_path, tmp, smi, train_rates)
        train_rates.update(loop_rates)
        log(f"phase 4h: the device loop (K={LOOP_K}) replayed the train "
            "path through its kernels, equal to phase 4b")
        loop_modes = phase_loop_modes(dev)
        log("phase 4i: the device loop's modes bit-equal to eager steps, "
            "stale seeds seen")
        kimi_loop = phase_kimi_loop(dev)
        per_group = kimi_loop.pop("launches")
        paths["kimi_loop"] = {k: per_group.get(k, 0) * KIMI_GROUPS
                              for k in _build.KERNELS}
        log("phase 4j: the captured Kimi-VL steps bit-equal to eager steps")
        steady = phase_steady_state(dev, vocab_path)
        vqa_rates["vqa_questions_per_sec_steady"] = phase_vqa_steady_state(
            dev, vocab_path)
        log(f"phase 5: steady-state rates on {smi}")
        dp_paths, dp_rates = phase_dp_world1(vocab_path, answers_path, tmp,
                                             smi)
        paths.update({f"dp1_{k}": v for k, v in dp_paths.items()})
        log("phase 6a: world size 1 over NCCL identical to no group, the "
            "device loop too")
        paths["dp2"] = phase_dp_two_ranks(vocab_path, tmp)
        log("phase 6b: two ranks on the one card in sync")
        phase_tp_kernels(dev, results)
        log("phase 7a: K1 and K2 at a tensor-parallel rank's heads (H = 6, "
            "3) agree with their plain versions")
        paths["tp2"], tp_rates = phase_tp_main_path(vocab_path, tmp, smi)
        log("phase 7b-c: --tensor_parallel 2 went through its kernels at "
            "H = 6, fp32 equal to one process, replicated parameters "
            "bit-identical")
        paths["tp2_gspmd"], gspmd_rates = phase_tp_gspmd_main_path(
            vocab_path, tmp, smi, tp_rates)
        tp_rates.update(gspmd_rates)
        log("phase 7e: --tensor_parallel 2 --tp_impl gspmd went through its "
            "kernels at H = 6, fp32 equal to one process, replicated "
            "parameters bit-identical, fewer bytes a rank than shard_map")

        paths["e2e_learn"], e2e_numbers = phase_e2e_learn(smi)
        log("phase 8: the learnability proof passed at bert-base width "
            "through its kernels, beam 5 above the bar")

    if _PLAIN_ON_CUDA:
        fail(f"BertAdam.step ran the plain update on CUDA parameters "
             f"{len(_PLAIN_ON_CUDA)} times")
    log("BertAdam.step took the fused update on every CUDA parameter set")
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "flax", "vlp_tpu")]
    if leaked:
        fail(f"JAX or the JAX package was imported: {leaked[:5]}")
    kernels = []
    for name, k in _build.KERNELS.items():
        by_path = {p: c[name] for p, c in paths.items()}
        kernels.append(dict(
            name=name, route=k.route, source=k.source, replaces=k.replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            **results[name]))
    for name in ("attention_fwd_drop", "attention_bwd"):
        # the tensor-parallel paths' launches, at a rank's H = 6, apart
        k = _build.KERNELS[name]
        by_path = {p: paths[p][name] for p in ("tp2", "tp2_gspmd")}
        kernels.append(dict(
            name=f"{name}_h6", route=k.route, source=k.source,
            replaces=k.replaces, launches=sum(by_path.values()),
            launches_by_path=by_path, **results[f"{name}_h6"]))
    print(json.dumps({"kernels": kernels, "captions_per_sec_cli": rates,
                      "captions_per_sec_steady": steady, **train_rates,
                      **fp16_rates, "legacy_heads_max_abs_err": heads_errs,
                      **vqa_rates, **dp_rates, **tp_rates,
                      "scst_checks": scst_checks, "e2e_learn": e2e_numbers,
                      "device_loop_modes": loop_modes,
                      "kimi_loop": kimi_loop,
                      "moe_layer": results["moe_layer"],
                      "vqa_checks": vqa_checks}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
