"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels
from ``vlp_tpu_torch/csrc``, holds each against its plain PyTorch version at
the shapes of its main path (caption decoding and training), checks the card
against the CPU end to end (fp32 beam traces; fp32 train-step losses with
attention dropout on), then drives the user's entry points at bert-base
width with random weights from a seed -- ``vlp_tpu_torch.cli.decode``
(beam 5 and greedy, B=100) and ``vlp_tpu_torch.cli.train`` (the COCO
fine-tune flags on synthetic data, B=64, 2 epochs of 20 steps) -- and
checks that each path launched its kernels.

    python3 chip_smoke.py

Prints one line per phase, then a JSON line with each kernel's launches,
error against its plain version, times (kernel, plain version, the bound,
one PyTorch library call where one exists), the card's ``nvidia-smi`` name
and power limit, and as its last line ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, when there is no GPU or any phase
fails.
"""

from __future__ import annotations

import copy
import json
import os
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
REPS_STEADY = 5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TRAIN_STEPS = (2, 20)        # main-path train CLI: epochs, steps per epoch


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn) -> float:
    """Median milliseconds of one call over REPS calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the HBM rate and
    the operations over the bf16 tensor-core peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


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
    """K1 (deterministic), K3 and K4 at the decoding path's shapes."""
    from vlp_tpu_torch.config import MODE_BI, MODE_S2S
    from vlp_tpu_torch.ops import attention as attn
    from vlp_tpu_torch.ops import decode_attention as dec

    g = torch.Generator(device=dev).manual_seed(0)
    H, D, P = 12, 64, 102

    # ---- K1: prefill (s2s, text_end = L, colkeep 1) and an encode shape
    def k1_inputs(B, L, dtype, prefill):
        qkv = torch.randn(B, L, 3 * H * D, generator=g, device=dev).to(dtype)
        q, k, v = (t.view(B, L, H, D) for t in qkv.split(H * D, dim=-1))
        if prefill:
            mode = torch.full((B,), MODE_S2S, device=dev)
            te = torch.full((B,), L, device=dev)
            ck = torch.ones(B, L, device=dev)
        else:
            mode = torch.randint(MODE_BI, MODE_S2S + 1, (B,), generator=g,
                                 device=dev)
            te = torch.randint(P + 1, L + 1, (B,), generator=g, device=dev)
            ck = (torch.rand(B, L, generator=g, device=dev) > 0.1).float()
        return q, k, v, mode, te, ck

    for label, L, prefill in (("prefill", P + 1, True),
                              ("encode", 128, False)):
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            args = k1_inputs(100, L, dtype, prefill)
            err = compare(f"K1 attention_fwd {label} B=100 L={L} {dtype}",
                          attn.attention(*args, prefix=P),
                          attn.attention_plain(*args, prefix=P), tol)
            if prefill and dtype == torch.bfloat16:
                ms = time_ms(lambda: attn.attention(*args, prefix=P))
                plain_ms = time_ms(
                    lambda: attn.attention_plain(*args, prefix=P))
                log(f"K1 prefill bf16 time: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms")
                B, L = 100, P + 1
                results["attention_fwd"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=time_ms(lambda: sdpa(*args, P)),
                    **bound(4 * B * L * H * D * 2 + 8 * B + 4 * B * L,
                            4 * B * H * L * L * D))

    # ---- K3 (own beam) and K4 (ancestry bias): B = 100, P = 102, G = 24
    G = 24

    def dec_inputs(B, K, dtype):
        def r(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dtype)
        q, k, v = (r(B * K, 2, H * D) for _ in range(3))
        # the prefill hands over [:, :P] views of [B, P+1, H*D] projections
        pk, pv = (r(B, P + 1, H * D)[:, :P] for _ in range(2))
        return q, k, v, pk, pv, r(B * K, G, H * D), r(B * K, G, H * D)

    def anc_bias(B, K, gen_len):
        anc = torch.randint(0, K, (B * K, G), generator=g, device=dev)
        own = torch.arange(B * K, device=dev) % K
        anc[:, gen_len:gen_len + 2] = own[:, None]
        beams = torch.arange(K, device=dev)[None, :, None]
        bias = torch.full((B * K, K, G), -10000.0, device=dev)
        return bias.masked_fill(anc[:, None, :] == beams, 0.0).reshape(
            B * K, K * G)

    cases = (("decode_attention", 1, False), ("decode_attention", 5, False),
             ("decode_attention_anc", 5, True))
    for name, K, anc in cases:
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            errs = []
            for gen_len in (0, 7, 18):
                q, k, v, pk, pv, gk, gv = dec_inputs(100, K, dtype)
                bias = anc_bias(100, K, gen_len) if anc else None
                gk2, gv2 = gk.clone(), gv.clone()
                got = dec.decode_attention(q, k, v, pk, pv, gk, gv, gen_len,
                                           n_heads=H, beam_bias=bias)
                want = dec.decode_attention_plain(
                    q, k, v, pk, pv, gk2, gv2, gen_len, n_heads=H,
                    beam_bias=bias)
                errs.append(compare(
                    f"{'K4' if anc else 'K3'} {name} B=100 K={K} "
                    f"gen_len={gen_len} {dtype}", got, want, tol))
                if not (torch.equal(gk, gk2) and torch.equal(gv, gv2)):
                    fail(f"{name}: generated-cache writes not bit-exact")
            log(f"{name} K={K} {dtype}: cache writes bit-exact")
            # time at the main path's shape: greedy K3 (K=1), beam K4 (K=5)
            if dtype == torch.bfloat16 and (anc or K == 1):
                step = (lambda: dec.decode_attention(
                    q, k, v, pk, pv, gk, gv, gen_len, n_heads=H,
                    beam_bias=bias))
                plain = (lambda: dec.decode_attention_plain(
                    q, k, v, pk, pv, gk2, gv2, gen_len, n_heads=H,
                    beam_bias=bias))
                ms, plain_ms = time_ms(step), time_ms(plain)
                log(f"{name} K={K} bf16 time: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms")
                # q/k/v/out of the S=2 new rows, the prompt K/V once per
                # example, the visible generated slots of all K beams (K4
                # reads every beam of its example), the new K/V written,
                # and the ancestry bias
                BK, S, vis = 100 * K, 2, gen_len + 2
                nbytes = (4 * BK * S * H * D * 2 + 2 * 100 * P * H * D * 2
                          + 2 * BK * vis * H * D * 2 + 2 * BK * S * H * D * 2
                          + (BK * K * G * 4 if anc else 0))
                cols = P + (K * vis if anc else vis)
                results[name] = dict(
                    max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                    library_ms=None,
                    **bound(nbytes, 4 * BK * S * H * cols * D))


def sdpa(q, k, v, mode, text_end, colkeep, prefix, dropout_p=0.0):
    """One PyTorch library call computing the same attention (additive
    -10000 mask, [B, L, H, D] in and out): the yardstick of library_ms.
    The port never calls it."""
    import torch.nn.functional as F
    from vlp_tpu_torch.ops.attention import _mask_bias
    bias = _mask_bias(mode, text_end, colkeep, prefix, q.shape[1])
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=bias[:, None].to(q.dtype), dropout_p=dropout_p)
    return out.transpose(1, 2)


def phase_train_kernels(dev, results):
    """K1's dropout branch, K2 and dropout_mask at the training shape
    (B=64, L=128, H=12, D=64): fp32 and bf16, mixed modes, zeros in
    colkeep, rate 0 and 0.1, each against its plain version; the mask bit
    for bit.  Times in bf16 at rate 0.1."""
    from vlp_tpu_torch.config import MODE_BI, MODE_S2S
    from vlp_tpu_torch.ops import attention as attn
    from vlp_tpu_torch.ops import philox

    g = torch.Generator(device=dev).manual_seed(1)
    B, L, H, D, P = 64, 128, 12, 64, 102
    seed, rate = 0x5DEECE66D0123457, 0.1

    def inputs(dtype):
        qkv = torch.randn(B, L, 3 * H * D, generator=g, device=dev).to(dtype)
        q, k, v = (t.view(B, L, H, D) for t in qkv.split(H * D, dim=-1))
        mode = torch.tensor([MODE_S2S, MODE_BI] * (B // 2), device=dev)
        te = torch.randint(P + 1, L + 1, (B,), generator=g, device=dev)
        ck = torch.ones(B, L, device=dev)
        ck[:, 1:P - 1] = (torch.rand(B, P - 2, generator=g, device=dev)
                          > 0.3).float()
        dout = torch.randn(B, L, H, D, generator=g, device=dev).to(dtype)
        return q, k, v, mode, te, ck, dout

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
    results["dropout_mask"] = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: attn.dropout_mask(B, H, L, rate, seed, dev)),
        plain_ms=time_ms(lambda: philox.keep_scale(seed, B, H, L, rate,
                                                   device=dev)),
        library_ms=None, **bound(B * H * L * L * 4, 0))

    errs = {"attention_fwd_drop": 0.0, "attention_bwd": 0.0}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        q, k, v, mode, te, ck, dout = inputs(dtype)
        for r in (0.0, rate):
            fwd = attn._forward_cuda(q, k, v, mode, te, ck, P,
                                     dropout=(r, seed))
            want = attn.attention_plain(q, k, v, mode, te, ck, prefix=P,
                                        dropout_rate=r, seed=seed)
            tag = f"B={B} L={L} {dtype} rate={r}"
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
    pd = L * L * D * 2 * B * H            # FLOP of one L x L x D product
    fwd = dict(
        max_abs_err=errs["attention_fwd_drop"],
        ms=time_ms(lambda: attn._forward_cuda(q, k, v, mode, te, ck, P,
                                              dropout=(rate, seed))),
        plain_ms=time_ms(lambda: attn.attention_plain(
            q, k, v, mode, te, ck, prefix=P, dropout_rate=rate, seed=seed)),
        library_ms=time_ms(lambda: sdpa(q, k, v, mode, te, ck, P, rate)),
        **bound(4 * act + meta, 2 * pd))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = sdpa(*leaves, mode, te, ck, P, rate)
    bwd = dict(
        max_abs_err=errs["attention_bwd"],
        ms=time_ms(lambda: attn._backward_cuda(q, k, v, mode, te, ck, dout,
                                               P, rate, seed)),
        plain_ms=time_ms(lambda: attn.attention_bwd_plain(
            q, k, v, mode, te, ck, dout, prefix=P, dropout_rate=rate,
            seed=seed)),
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, dout, retain_graph=True)),
        **bound(7 * act + meta, 5 * pd))

    def fused_step():
        out = attn.FusedAttention.apply(*leaves, mode, te, ck, P, rate, seed)
        return torch.autograd.grad(out, leaves, dout)

    def library_step():
        return torch.autograd.grad(sdpa(*leaves, mode, te, ck, P, rate),
                                   leaves, dout)

    fwd_bwd = dict(ms=time_ms(fused_step), library_ms=time_ms(library_step))
    bwd.update(fwd_bwd_ms=fwd_bwd["ms"],
               library_fwd_bwd_ms=fwd_bwd["library_ms"])
    results["attention_fwd_drop"] = fwd
    results["attention_bwd"] = bwd
    for name in ("attention_fwd_drop", "attention_bwd", "dropout_mask"):
        r = results[name]
        log(f"{name} bf16 B={B} time: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"K1+K2 fwd+bwd bf16: {fwd_bwd['ms']:.4f} ms; SDPA fwd+bwd "
        f"{fwd_bwd['library_ms']:.4f} ms")


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


def main():
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
            if "registers" in line or "Compiling entry" in line:
                log("  ptxas: " + line.strip())

    results = {}
    phase_kernels(dev, results)
    phase_train_kernels(dev, results)
    log("phase 2: kernels agree with their plain versions")

    with tempfile.TemporaryDirectory() as tmp:
        vocab_path = write_synthetic_vocab(os.path.join(tmp, "vocab.txt"),
                                           size=28996)
        phase_end_to_end(dev, vocab_path)
        log("phase 3: end-to-end beam traces identical")
        err = phase_train_end_to_end(dev, vocab_path)
        log(f"phase 3b: card and CPU train losses agree (max rel {err:.2e})")
        counts, rates = phase_main_path(vocab_path, tmp, smi)
        log("phase 4: decode main path went through its kernels")
        train_counts, train_rates = phase_train_main_path(vocab_path, tmp,
                                                          smi)
        log("phase 4b: train main path went through its kernels")
        steady = phase_steady_state(dev, vocab_path)
        log(f"phase 5: steady-state rates on {smi}")

    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "flax", "vlp_tpu")]
    if leaked:
        fail(f"JAX or the JAX package was imported: {leaked[:5]}")
    kernels = []
    for name, k in _build.KERNELS.items():
        kernels.append(dict(
            name=name, route=k.route, source=k.source, replaces=k.replaces,
            launches=counts[name] + train_counts[name],
            launches_by_path={"decode": counts[name],
                              "train": train_counts[name]},
            **results[name]))
    print(json.dumps({"kernels": kernels, "captions_per_sec_cli": rates,
                      "captions_per_sec_steady": steady, **train_rates}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
