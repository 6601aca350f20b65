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
questions) and the ``layout="bhld"`` attention op -- and checks that each
path launched its kernels.  Phase 2 also holds the fp32 attention bodies
(split TF32) at L=256 and 512 against their plain versions and times them
at B=64 L=128 and B=16 L=256 and 512 beside fp32 SDPA, with the
backward's peak memory; times the decode step (K3 greedy, K4 beam 5, K5
SCST) in bf16 and fp32 at gen_len 0, 9 and 18 beside SDPA over the joint
keys (fp32: in alternating turns with SDPA's parts prebuilt, and the
blocks per SM of the fp32 body); and times ``dropout_mask`` beside an
empty launch and a ``zero_`` of its bytes.  Phase 6 runs data parallel:
the train, decode and VQA CLIs over NCCL at world size 1, which must equal
the runs without a group bit for bit, and two gloo ranks on the one card
(this script re-run with ``--dp-worker``), which must stay in sync and, in
fp32, equal the single-process step on the global batch.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab-times ROOT   # another checkout's kernels

``--ab-times`` times K1/K2, the decode step (bf16 and fp32) and
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

T0 = time.time()

BF16_TOL = dict(atol=3e-2, rtol=1e-2)   # one bf16 ulp at 2-4 is 1.6e-2
FP32_TOL = dict(atol=1e-4, rtol=1e-4)
REPS = 20
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
SCST_STEPS = 8               # main-path SCST CLI: steps of one epoch
SCST_B, SCST_T = 64, 20      # the reference SCST recipe's 16x4 batch, T
VQA_B, VQA_QUESTIONS = 256, 1024   # main-path VQA eval: batch, questions
VQA_STEPS = 12               # main-path VQA fine-tune: steps at B=64
DECODE_GEN_LENS = (0, 9, 18)   # decode steps timed: first, middle, last


def body(dtype) -> str:
    """The attention kernel body a dtype runs: bf16 the bf16 tensor-core
    one, fp32 the split-TF32 one."""
    return "v2 mma" if dtype == torch.bfloat16 else "fp32 split-tf32"


def decode_body(dtype) -> str:
    """The decode-step body a dtype runs: bf16 the tensor-core one, fp32
    the CUDA-core one over the visible slots (a lane per column)."""
    return "v2 mma" if dtype == torch.bfloat16 else "fp32 v2 cuda-core"


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn) -> float:
    """Device milliseconds of one call: REPS calls queued back to back
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
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / REPS)
    return statistics.median(out)


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
            plain_ms=time_ms(lambda: attn.attention_plain(*args, prefix=P)),
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
            plain_ms=time_ms(lambda: dec.decode_attention_plain(
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
        plain_ms=time_ms(lambda: torch.cat([
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


LONG_GATE_LENS = (160, 256, 528)   # the tiled backward's gates
LONG_TIMED_LENS = (256, 528)       # and its times


def phase_long_backward(attn, inputs, B, H, D, P, seed, rate):
    """K2 in bf16 past the one-block body's L <= 144: the tiled body (any
    --max_len_b >= 26 with 100 regions rounds the training length up to
    256; 528 is the bf16 forward's limit) at B=64, rate 0.1.  At each of
    LONG_GATE_LENS, in both layouts: against its plain version, two calls
    bit for bit, and bhld = blhd on transposed inputs bit for bit.  Then
    its time at LONG_TIMED_LENS beside SDPA's backward (mask built in the
    forward, and prebuilt) and the bound.  Returns {L: times}."""
    err = 0.0
    for L in LONG_GATE_LENS:
        q, k, v, mode, te, ck, dout = inputs(torch.bfloat16, L)
        tr = [t.transpose(1, 2).contiguous() for t in (q, k, v, dout)]
        got = {}
        for layout, (a, b_, c, d) in (("blhd", (q, k, v, dout)),
                                      ("bhld", tr)):
            args = (a, b_, c, mode, te, ck, d, P, rate, seed, layout)
            got[layout] = attn._backward_cuda(*args)
            want = attn.attention_bwd_plain(
                a, b_, c, mode, te, ck, d, prefix=P, dropout_rate=rate,
                seed=seed, layout=layout)
            tag = (f"B={B} L={L} bf16 ({body(torch.bfloat16)}, tiled) "
                   f"{layout} rate={rate}")
            err = max([err] + [compare(f"K2 attention_bwd {name} {tag}", x,
                                       y, BF16_TOL)
                               for name, x, y in zip(("dq", "dk", "dv"),
                                                     got[layout], want)])
            again = attn._backward_cuda(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y)
                       for x, y in zip(got[layout], again)):
                fail(f"attention_bwd {tag}: two calls differ")
        if not all(torch.equal(x.transpose(1, 2), y)
                   for x, y in zip(got["bhld"], got["blhd"])):
            fail(f"attention_bwd L={L}: bhld differs from blhd on "
                 "transposed inputs")
        log(f"K2 tiled L={L}: both layouts bit-identical across two calls "
            "and to each other")
    times = {}
    for L in LONG_TIMED_LENS:
        q, k, v, mode, te, ck, dout = inputs(torch.bfloat16, L)
        mask = sdpa_mask(q, mode, te, ck, P)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = sdpa(*leaves, mode, te, ck, P, rate)
        lib_out_pre = sdpa(*leaves, mode, te, ck, P, rate, mask=mask)
        act = B * L * H * D * 2
        r = dict(
            B=B, L=L, max_abs_err=err,
            ms=time_ms(lambda: attn._backward_cuda(
                q, k, v, mode, te, ck, dout, P, rate, seed)),
            plain_ms=time_ms(lambda: attn.attention_bwd_plain(
                q, k, v, mode, te, ck, dout, prefix=P, dropout_rate=rate,
                seed=seed)),
            library_ms=time_ms(lambda: torch.autograd.grad(
                lib_out, leaves, dout, retain_graph=True)),
            library_prebuilt_mask_ms=time_ms(lambda: torch.autograd.grad(
                lib_out_pre, leaves, dout, retain_graph=True)),
            **bound(7 * act + 8 * B + 4 * B * L,
                    5 * product_flop(mode, te, ck, P, L, H, D)))
        if L == 256:
            r["kernels_us"] = {f"rate {x}": kernel_split(
                lambda: attn._backward_cuda(q, k, v, mode, te, ck, dout, P, x,
                                            seed)) for x in (0.0, rate)}
            log(f"attention_bwd tiled L={L}, device us per call by kernel: "
                f"{r['kernels_us']}")
        log(f"attention_bwd bf16 B={B} L={L} time (tiled): kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA backward "
            f"{r['library_ms']:.4f} ms (prebuilt mask "
            f"{r['library_prebuilt_mask_ms']:.4f}), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        times[L] = r
        del q, k, v, dout, mask, leaves, lib_out, lib_out_pre
    return times


TURNS = 5      # readings of each kernel and SDPA, taken in turns


def k1_k2_times(attn, q, k, v, mode, te, ck, dout, P, rate, seed,
                layout="blhd", turns=1) -> dict:
    """Device ms (``time_ms``) of ``attn``'s K1 (the dropout branch at
    ``rate``) and K2 and of SDPA's forward and backward on the same inputs
    in ``layout``, read in turns -- K1, SDPA forward, K2, SDPA backward --
    ``turns`` times, so that a drift of the card reaches each alike: lists
    of readings under fwd_ms, sdpa_fwd_ms, bwd_ms, sdpa_bwd_ms."""
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
            r["plain_ms"] = time_ms(lambda: attn.attention_plain(
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
                plain_ms=time_ms(lambda: attn.attention_bwd_plain(
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
                attn, *ins, 102, 0.1, TRAIN_SEED).items()}
        del ins
    out.update(decode_ab_times(dec, g, dev))
    B, H, L = AB_MASK
    out[f"dropout_mask [{B},{H},{L},{L}]"] = time_ms(
        lambda: attn.dropout_mask(B, H, L, 0.1, TRAIN_SEED, dev))
    print(json.dumps(out))


def phase_train_kernels(dev, results):
    """K1's dropout branch, K2 and dropout_mask at the training shape
    (B=64, L=128, H=12, D=64): fp32 and bf16, mixed modes, zeros in
    colkeep, rate 0 and 0.1, each against its plain version; the mask bit
    for bit.  Times in bf16 at rate 0.1, and the tiled K2 at L=256 and 528
    beside them (``phase_long_backward``)."""
    from vlp_tpu_torch.ops import attention as attn
    from vlp_tpu_torch.ops import philox

    g = torch.Generator(device=dev).manual_seed(1)
    B, L, H, D, P = 64, 128, 12, 64, 102
    seed, rate = TRAIN_SEED, 0.1

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
        plain_ms=time_ms(lambda: philox.keep_scale(seed, B, H, L, rate,
                                                   device=dev)),
        library_ms=None, launch_floor_ms=time_ms(
            lambda: torch.cuda._sleep(0)),
        fill_ms=time_ms(filled.zero_), **dropout_mask_bound(B, H, L))
    log(f"dropout_mask [{B},{H},{L},{L}]: an empty launch "
        f"{dm['launch_floor_ms']:.4f} ms, zero_ of the same bytes "
        f"{dm['fill_ms']:.4f} ms")
    del filled

    errs = {"attention_fwd_drop": 0.0, "attention_bwd": 0.0}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        q, k, v, mode, te, ck, dout = inputs(dtype)
        for r in (0.0, rate):
            fwd = attn._forward_cuda(q, k, v, mode, te, ck, P,
                                     dropout=(r, seed))
            want = attn.attention_plain(q, k, v, mode, te, ck, prefix=P,
                                        dropout_rate=r, seed=seed)
            tag = f"B={B} L={L} {dtype} ({body(dtype)}) rate={r}"
            errs["attention_fwd_drop"] = max(
                errs["attention_fwd_drop"],
                compare(f"K1 attention_fwd_drop {tag}", fwd, want, tol))
            got = attn._backward_cuda(q, k, v, mode, te, ck, dout, P, r, seed)
            want = attn.attention_bwd_plain(q, k, v, mode, te, ck, dout,
                                            prefix=P, dropout_rate=r,
                                            seed=seed)
            for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
                errs["attention_bwd"] = max(
                    errs["attention_bwd"],
                    compare(f"K2 attention_bwd {name} {tag}", a, b_, tol))

    # times at the main path's shape: bf16, rate 0.1
    q, k, v, mode, te, ck, dout = inputs(torch.bfloat16)
    meta = 8 * B + 4 * B * L
    act = B * L * H * D * 2               # one bf16 [B, L, H*D] tensor
    pd = product_flop(mode, te, ck, P, L, H, D)
    mask = sdpa_mask(q, mode, te, ck, P)
    fwd = dict(
        body=body(torch.bfloat16), max_abs_err=errs["attention_fwd_drop"],
        ms=time_ms(lambda: attn._forward_cuda(q, k, v, mode, te, ck, P,
                                              dropout=(rate, seed))),
        plain_ms=time_ms(lambda: attn.attention_plain(
            q, k, v, mode, te, ck, prefix=P, dropout_rate=rate, seed=seed)),
        library_ms=time_ms(lambda: sdpa(q, k, v, mode, te, ck, P, rate)),
        library_prebuilt_mask_ms=time_ms(lambda: sdpa(
            q, k, v, mode, te, ck, P, rate, mask=mask)),
        **bound(4 * act + meta, 2 * pd))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = sdpa(*leaves, mode, te, ck, P, rate)
    lib_out_pre = sdpa(*leaves, mode, te, ck, P, rate, mask=mask)
    bwd = dict(
        body=body(torch.bfloat16), max_abs_err=errs["attention_bwd"],
        ms=time_ms(lambda: attn._backward_cuda(q, k, v, mode, te, ck, dout,
                                               P, rate, seed)),
        plain_ms=time_ms(lambda: attn.attention_bwd_plain(
            q, k, v, mode, te, ck, dout, prefix=P, dropout_rate=rate,
            seed=seed)),
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, dout, retain_graph=True)),
        library_prebuilt_mask_ms=time_ms(lambda: torch.autograd.grad(
            lib_out_pre, leaves, dout, retain_graph=True)),
        **bound(7 * act + meta, 5 * pd))

    def fused_step():
        out = attn.FusedAttention.apply(*leaves, mode, te, ck, P, rate, seed)
        return torch.autograd.grad(out, leaves, dout)

    def library_step(mask=None):
        return torch.autograd.grad(
            sdpa(*leaves, mode, te, ck, P, rate, mask=mask), leaves, dout)

    fwd_bwd = dict(ms=time_ms(fused_step), library_ms=time_ms(library_step),
                   library_prebuilt_mask_ms=time_ms(
                       lambda: library_step(mask)))
    bwd.update(fwd_bwd_ms=fwd_bwd["ms"],
               library_fwd_bwd_ms=fwd_bwd["library_ms"],
               library_prebuilt_mask_fwd_bwd_ms=fwd_bwd[
                   "library_prebuilt_mask_ms"])
    long = phase_long_backward(attn, inputs, B, H, D, P, seed, rate)
    bwd["long"] = long[256]
    bwd["long_528"] = long[528]
    fp32_errs, fp32_times = phase_fp32_long(attn, inputs, H, D, P, seed, rate)
    fwd["fp32"] = dict(max_abs_err=fp32_errs["fwd"], **{
        k: v for k, v in fp32_times.items() if k.startswith("fwd")})
    bwd["fp32"] = dict(max_abs_err=fp32_errs["bwd"], **{
        k: v for k, v in fp32_times.items() if k.startswith("bwd")})
    results["attention_fwd_drop"] = fwd
    results["attention_bwd"] = bwd
    for name in ("attention_fwd_drop", "attention_bwd", "dropout_mask"):
        r = results[name]
        which = f" ({r['body']})" if "body" in r else ""
        pre = r.get("library_prebuilt_mask_ms")
        log(f"{name} bf16 B={B} time{which}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms"
            + ("" if pre is None else f" (prebuilt mask {pre:.4f})")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"K1+K2 fwd+bwd bf16 ({body(torch.bfloat16)}): "
        f"{fwd_bwd['ms']:.4f} ms; SDPA fwd+bwd "
        f"{fwd_bwd['library_ms']:.4f} ms (prebuilt mask "
        f"{fwd_bwd['library_prebuilt_mask_ms']:.4f})")


BHLD = ("attention_fwd_bhld", "attention_fwd_bhld_drop", "attention_bwd_bhld")


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
    in fp32 and bf16, on contiguous and on strided inputs; then, with
    dropout 0.1, bit for bit against the blhd kernels (K1, K2) on the
    transposed inputs.  Times in bf16 (the dropout branch at rate 0.1); the
    library call is SDPA in its own [B, H, L, D] layout."""
    from vlp_tpu_torch.ops import attention as attn

    g = torch.Generator(device=dev).manual_seed(6)
    B, L, H, D, P = 64, 128, 12, 64, 102
    seed, rate = 0x243F6A8885A308D3, 0.1
    errs = dict.fromkeys(BHLD, 0.0)

    def track(name, err):
        errs[name] = max(errs[name], err)

    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for strided in (False, True):
            q, k, v, mode, te, ck, dout = bhld_inputs(g, dev, dtype, strided)
            tag = (f"B={B} L={L} {dtype} ({body(dtype)})"
                   f"{' strided' if strided else ''}")
            track("attention_fwd_bhld", compare(
                f"attention_fwd_bhld {tag}",
                attn.attention(q, k, v, mode, te, ck, prefix=P,
                               layout="bhld"),
                attn.attention_plain(q, k, v, mode, te, ck, prefix=P,
                                     layout="bhld"), tol))
            for r in (0.0, rate):
                kw = dict(prefix=P, dropout_rate=r, seed=seed, layout="bhld")
                track("attention_fwd_bhld_drop", compare(
                    f"attention_fwd_bhld_drop {tag} rate={r}",
                    attn._forward_cuda(q, k, v, mode, te, ck, P,
                                       dropout=(r, seed), layout="bhld"),
                    attn.attention_plain(q, k, v, mode, te, ck, **kw), tol))
                got = attn._backward_cuda(q, k, v, mode, te, ck, dout, P, r,
                                          seed, "bhld")
                want = attn.attention_bwd_plain(q, k, v, mode, te, ck, dout,
                                                **kw)
                for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
                    if a.shape != (B, H, L, D) or not a.is_contiguous():
                        fail(f"attention_bwd_bhld {name}: not a contiguous "
                             f"[B, H, L, D] tensor")
                    track("attention_bwd_bhld", compare(
                        f"attention_bwd_bhld {name} {tag} rate={r}", a, b_,
                        tol))

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

    # times at the main path's shape: bf16, contiguous, rate 0.1
    q, k, v, mode, te, ck, dout = bhld_inputs(g, dev, torch.bfloat16)
    meta = 8 * B + 4 * B * L
    act = B * L * H * D * 2               # one bf16 [B, H, L, D] tensor
    pd = product_flop(mode, te, ck, P, L, H, D)
    kw = dict(prefix=P, layout="bhld")
    mask = sdpa_mask(q, mode, te, ck, P, layout="bhld")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = sdpa(*leaves, mode, te, ck, P, rate, layout="bhld")
    lib_out_pre = sdpa(*leaves, mode, te, ck, P, rate, layout="bhld",
                       mask=mask)
    results["attention_fwd_bhld"] = dict(
        body=body(torch.bfloat16), max_abs_err=errs["attention_fwd_bhld"],
        ms=time_ms(lambda: attn.attention(q, k, v, mode, te, ck, **kw)),
        plain_ms=time_ms(lambda: attn.attention_plain(q, k, v, mode, te, ck,
                                                      **kw)),
        library_ms=time_ms(lambda: sdpa(q, k, v, mode, te, ck, P,
                                        layout="bhld")),
        library_prebuilt_mask_ms=time_ms(lambda: sdpa(
            q, k, v, mode, te, ck, P, layout="bhld", mask=mask)),
        **bound(4 * act + meta, 2 * pd))
    results["attention_fwd_bhld_drop"] = dict(
        body=body(torch.bfloat16), max_abs_err=errs["attention_fwd_bhld_drop"],
        ms=time_ms(lambda: attn._forward_cuda(
            q, k, v, mode, te, ck, P, dropout=(rate, seed), layout="bhld")),
        plain_ms=time_ms(lambda: attn.attention_plain(
            q, k, v, mode, te, ck, dropout_rate=rate, seed=seed, **kw)),
        library_ms=time_ms(lambda: sdpa(q, k, v, mode, te, ck, P, rate,
                                        layout="bhld")),
        library_prebuilt_mask_ms=time_ms(lambda: sdpa(
            q, k, v, mode, te, ck, P, rate, layout="bhld", mask=mask)),
        **bound(4 * act + meta, 2 * pd))
    results["attention_bwd_bhld"] = dict(
        body=body(torch.bfloat16), max_abs_err=errs["attention_bwd_bhld"],
        ms=time_ms(lambda: attn._backward_cuda(q, k, v, mode, te, ck, dout,
                                               P, rate, seed, "bhld")),
        plain_ms=time_ms(lambda: attn.attention_bwd_plain(
            q, k, v, mode, te, ck, dout, dropout_rate=rate, seed=seed,
            **kw)),
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, dout, retain_graph=True)),
        library_prebuilt_mask_ms=time_ms(lambda: torch.autograd.grad(
            lib_out_pre, leaves, dout, retain_graph=True)),
        **bound(7 * act + meta, 5 * pd))
    for name in BHLD:
        r = results[name]
        log(f"{name} bf16 B={B} time ({r['body']}): kernel {r['ms']:.4f} "
            f"ms, plain {r['plain_ms']:.4f} ms, SDPA (bhld) "
            f"{r['library_ms']:.4f} ms (prebuilt mask "
            f"{r['library_prebuilt_mask_ms']:.4f}), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


def phase_bhld_main_path(dev):
    """The public [B, H, L, D] op as a user calls it, at the training shape
    (B=64, L=128, H=12, D=64, bf16): one inference call
    (``attention(..., layout="bhld")``) and one training forward and
    backward through autograd (``FusedAttention``, dropout 0.1).  Each
    launches its bhld kernel once and no other kernel."""
    from vlp_tpu_torch.ops import _build
    from vlp_tpu_torch.ops import attention as attn

    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, mode, te, ck, dout = bhld_inputs(g, dev, torch.bfloat16)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    _build.reset_launch_counts()
    with torch.no_grad():
        out = attn.attention(q, k, v, mode, te, ck, prefix=102,
                             layout="bhld")
    y = attn.FusedAttention.apply(*leaves, mode, te, ck, 102, 0.1, 99,
                                  "bhld")
    grads = torch.autograd.grad(y, leaves, dout)
    torch.cuda.synchronize()
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    want = {k: (1 if k in BHLD else 0) for k in counts}
    log(f"bhld op launch counts {counts}, expected {want}")
    if counts != want:
        fail("the bhld op did not launch its kernels as expected")
    if not all(torch.isfinite(t).all() and t.shape == q.shape
               for t in (out, y, *grads)):
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


def phase_train_end_to_end(dev, vocab_path, steps=3, B=8):
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


def phase_vqa_end_to_end(dev, vocab_path, steps=3, B=8):
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
    return counts, rates


def phase_train_main_path(vocab_path, out_dir, gpu_line):
    """The train CLI at bert-base width, bf16, through the kernels: the
    COCO fine-tune flags (README) on synthetic data, B=64, 2 epochs of 20
    steps, attention dropout 0.1.  Every step launches K1-dropout and K2
    once per layer; model.2.bin then decodes through the decode CLI."""
    from vlp_tpu_torch.cli import decode as decode_cli
    from vlp_tpu_torch.cli import train as train_cli
    from vlp_tpu_torch.ops import _build

    epochs, spe = TRAIN_STEPS
    out = os.path.join(out_dir, "train")
    args = ["--do_train", "--new_segment_ids", "--enable_butd",
            "--bert_model", vocab_path, "--do_lower_case", "--dataset",
            "coco", "--max_pred", "20", "--mask_prob", "0.15",
            "--train_batch_size", "64", "--learning_rate", "3e-5",
            "--num_train_epochs", str(epochs), "--s2s_prob", "1",
            "--bi_prob", "0", "--synthetic_data", "--steps_per_epoch",
            str(spe), "--output_dir", out, "--device", "cuda"]
    _build.reset_launch_counts()
    res = train_cli.main(args)
    torch.cuda.synchronize()
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    n = 12 * epochs * spe
    want = {k: (n if k in ("attention_fwd_drop", "attention_bwd") else 0)
            for k in counts}
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
    warm = 5
    step_s = float(np.median(res["step_seconds"][warm:]))
    iter_s = float(np.median(res["iter_seconds"][warm:]))
    rates = {"train_samples_per_sec": 64 / step_s,
             "train_samples_per_sec_with_loader": 64 / iter_s}
    log(f"train main path B=64: {rates['train_samples_per_sec']:.2f} "
        f"samples/s (median step {step_s * 1e3:.2f} ms after {warm} "
        f"warm-up steps; {rates['train_samples_per_sec_with_loader']:.2f} "
        f"with the loader's waits) on {gpu_line}")
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
    res = train_cli.main(args)
    torch.cuda.synchronize()
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    n, steps = SCST_STEPS, 12 * (SCST_T - 1)
    want = dict({k: 0 for k in counts}, attention_fwd=12 * n,
                attention_fwd_drop=24 * n, attention_bwd=12 * n,
                decode_attention=steps * n, decode_attention_drop=steps * n,
                decode_dropout_scales=12 * n)
    log(f"SCST launch counts {counts}, expected {want}")
    if counts != want:
        fail("the SCST path did not launch the kernels as expected")
    losses = np.asarray(res["losses"])
    if len(losses) != n or not np.isfinite(losses).all():
        fail(f"SCST main path: bad losses {losses}")
    if not os.path.isfile(os.path.join(out, "model.1.bin")):
        fail("SCST main path wrote no model.1.bin")
    warm = 3
    step_s = float(np.median(res["step_seconds"][warm:]))
    iter_s = float(np.median(res["iter_seconds"][warm:]))
    rates = {"scst_samples_per_sec": SCST_B / step_s,
             "scst_samples_per_sec_with_loader": SCST_B / iter_s}
    log(f"SCST main path B={SCST_B}: {rates['scst_samples_per_sec']:.2f} "
        f"samples/s (median step {step_s * 1e3:.2f} ms after {warm} warm-up "
        f"steps; {rates['scst_samples_per_sec_with_loader']:.2f} with the "
        f"loader's waits) on {gpu_line}; losses {losses.tolist()}")
    return counts, rates


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
    log(f"VQA train launch counts {train_counts}, expected {want}")
    if train_counts != want:
        fail("the VQA train path did not launch the kernels as expected")
    losses = np.asarray(res["losses"])
    if len(losses) != VQA_STEPS or not np.isfinite(losses).all():
        fail(f"VQA train main path: bad losses {losses}")
    if not losses[-3:].mean() < losses[:3].mean():
        fail(f"VQA train main path: the loss did not fall: {losses}")
    warm = 3
    step_s = float(np.median(res["step_seconds"][warm:]))
    iter_s = float(np.median(res["iter_seconds"][warm:]))
    rates = {"vqa_train_samples_per_sec": 64 / step_s,
             "vqa_train_samples_per_sec_with_loader": 64 / iter_s}
    log(f"VQA train main path B=64: "
        f"{rates['vqa_train_samples_per_sec']:.2f} samples/s (median step "
        f"{step_s * 1e3:.2f} ms after {warm} warm-up steps; "
        f"{rates['vqa_train_samples_per_sec_with_loader']:.2f} with the "
        f"loader's waits) on {gpu_line}; losses {losses.tolist()}")

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


DP_STEPS = 6                 # phase 6a: train steps at world size 1
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
    only a deterministic order isolates what the group adds.  Returns the
    group runs' counts and rates."""
    flags = ["--do_train", "--new_segment_ids", "--enable_butd",
             "--bert_model", vocab_path, "--do_lower_case", "--dataset",
             "coco", "--max_pred", "20", "--mask_prob", "0.15",
             "--train_batch_size", "64", "--learning_rate", "3e-5",
             "--num_train_epochs", "1", "--s2s_prob", "1", "--bi_prob", "0",
             "--synthetic_data", "--steps_per_epoch", str(DP_STEPS),
             "--device", "cuda", "--profile_steps", "1"]
    # the deterministic choices only: no NaN fill of new tensors, whose
    # writes the all-reduce times would include
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _dp_world1(flags, vocab_path, answers_path, out_dir, gpu_line)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def _dp_world1(flags, vocab_path, answers_path, out_dir, gpu_line):
    import torch.distributed as tdist
    from vlp_tpu_torch import parallel
    from vlp_tpu_torch.cli import decode as decode_cli
    from vlp_tpu_torch.cli import eval_vqa2 as eval_cli
    from vlp_tpu_torch.cli import train as train_cli
    from vlp_tpu_torch.ops import _build

    runs, counts, rates = {}, {}, {}
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
        step_s = float(np.median(runs[mode]["step_seconds"][2:]))
        rates[mode] = 64 / step_s
        log(f"DP world 1 train ({mode}) B=64: {rates[mode]:.2f} samples/s "
            f"(median step {step_s * 1e3:.2f} ms after 2 warm-up steps, "
            f"deterministic algorithms) on "
            f"{gpu_line}; losses {runs[mode]['losses']}")
    if tdist.is_initialized():
        fail("cli.train left its process group behind")
    want = {k: (12 * DP_STEPS if k in ("attention_fwd_drop", "attention_bwd")
                else 0) for k in counts["nccl"]}
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
    return ({"train": counts["nccl"], "decode": counts["decode", "nccl"],
             "vqa": counts["vqa", "nccl"]},
            {"dp1_train_samples_per_sec": rates["nccl"],
             "dp1_train_samples_per_sec_no_group": rates["no_group"],
             "dp1_allreduce_ms": ar})


def dp_worker(rank: int, port: int, vocab_path: str, out: str) -> None:
    """Rank ``rank`` of 2 on the one card, gloo (NCCL refuses two ranks on
    one device), bert-base at full width and depth: (a) fp32, dropout 0,
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
                         max_pred=3)
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

        cfg, model, svocab, batch, srng = _scst_setup(vocab_path, 8, 0,
                                                      dtype="bfloat16")
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
    # each rank's launches, per run: 2 steps of one micro-batch, 12 layers
    zero = {k: 0 for k in r0["counts"]["fp32"]}
    step = dict(zero, attention_fwd_drop=24, attention_bwd=24)
    dec = 12 * (SCST_T - 1) * 2
    want = {"fp32": step, "bf16": step,
            "scst": dict(zero, attention_fwd=24, attention_fwd_drop=48,
                         attention_bwd=24, decode_attention=dec,
                         decode_attention_drop=dec,
                         decode_dropout_scales=24)}
    for r in (r0, r1):
        if r["counts"] != want:
            fail(f"DP two ranks launch counts {r['counts']}, expected {want}")
    log(f"DP two ranks launch counts per rank as expected: {want}")
    return {k: sum(r["counts"][run][k] for r in (r0, r1) for run in want)
            for k in zero}


def phase_steady_state(dev, vocab_path):
    """Device-side decode rate at the main path's shapes, without the CLI's
    loader and first-call costs: one prepared batch of B=100, one warm-up
    call, then the median of REPS_STEADY timed calls per mode."""
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
    rates = {}
    for mode, K in (("beam5", 5), ("greedy", 1)):
        dec = Decoder(model, cfg, DecodeParams(
            mask_id=vocab["[MASK]"], eos_id=vocab["[SEP]"], beam_size=K,
            max_tgt_length=20, forbid_duplicate_ngrams=True))
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
        paths["scst"], scst_rates = phase_scst_main_path(vocab_path, tmp,
                                                         smi)
        log("phase 4c: SCST main path went through its kernels")
        paths["vqa_train"], paths["vqa"], vqa_rates = phase_vqa_main_path(
            vocab_path, answers_path, tmp, smi)
        log("phase 4d: VQA train and eval paths went through their kernels")
        paths["bhld"] = phase_bhld_main_path(dev)
        log("phase 4e: the bhld op went through its kernels")
        steady = phase_steady_state(dev, vocab_path)
        vqa_rates["vqa_questions_per_sec_steady"] = phase_vqa_steady_state(
            dev, vocab_path)
        log(f"phase 5: steady-state rates on {smi}")
        dp_paths, dp_rates = phase_dp_world1(vocab_path, answers_path, tmp,
                                             smi)
        paths.update({f"dp1_{k}": v for k, v in dp_paths.items()})
        log("phase 6a: world size 1 over NCCL identical to no group")
        paths["dp2"] = phase_dp_two_ranks(vocab_path, tmp)
        log("phase 6b: two ranks on the one card in sync")

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
    print(json.dumps({"kernels": kernels, "captions_per_sec_cli": rates,
                      "captions_per_sec_steady": steady, **train_rates,
                      **scst_rates, **vqa_rates, **dp_rates,
                      "scst_checks": scst_checks,
                      "vqa_checks": vqa_checks}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
