"""Caption decoding as the decode CLI runs it: ``EvalLoader`` over the
packed fp16 store (prefetching, recycled slabs), the batch uploaded
through pinned memory, ``Decoder.beam_dispatch`` queued, the previous
batch's ``beam_collect`` (the host back-trace) and its detokenisation
while the device decodes: a pipeline of depth 1.  A caption completes
when its tokens are on the host.

``correct``: once the window has closed, a sample of the captions it
completed, drawn from the seed, is scored by the plain reference
teacher-forced over each prompt and its served tokens; the number compared
is the widest gap between the beam's cumulative log-probability along
the served caption and the reference's.  And every sampled caption has to
be the one its beam trace spells.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmarks import inputs as inputs_lib
from benchmarks import harness, training, work
from benchmarks import weights as weights_lib
from benchmarks.reference import data as ref_data
from benchmarks.reference import model as ref_model


def run(ctx) -> None:
    from vlp_tpu_torch import configure_precision
    from vlp_tpu_torch.cli.decode import upload
    from vlp_tpu_torch.data.dataset import CaptionExample
    from vlp_tpu_torch.data.example_builder import DecodeExampleBuilder
    from vlp_tpu_torch.data.loader import EvalLoader
    from vlp_tpu_torch.data.tokenization import BertTokenizer, detokenize
    from vlp_tpu_torch.decode import DecodeParams, Decoder
    from vlp_tpu_torch.models.model import VLPModel
    dev = ctx.device
    cfg, tr = ctx.cfg, ctx.traffic
    configure_precision()
    seeds = training.run_seeds(ctx.seed)
    inp = inputs_lib.make_inputs(cfg, tr, seeds["inputs"], dev)
    ctx.mark("inputs")
    store = training.write_store(inp, cfg, os.path.join(ctx.workdir,
                                                        "features.vlps"))
    ctx.mark("store")
    vocab_file = os.path.join(ctx.workdir, "vocab.txt")
    with open(vocab_file, "w") as f:
        f.write("\n".join(inp.vocab) + "\n")
    T, B = tr["max_tgt_length"], tr["batch_size"]
    tokenizer = BertTokenizer(vocab_file, do_lower_case=True,
                              max_len=T + cfg["len_vis_input"] + 3)
    vcfg = training.program_config(cfg, relax_projection=0, max_pred=3,
                                   max_len_b=T)
    with torch.device(dev):
        model = VLPModel(vcfg)
    model.cast_for_inference()
    model.load_state_dict(weights_lib.program_state(weights_lib.make_weights(
        cfg, False, seeds["weights"], dev, dtype=model.dtype)))
    model.eval()
    ctx.mark("model")
    vocab = inp.vocab_index
    decoder = Decoder(model, vcfg, DecodeParams(
        mask_id=vocab["[MASK]"], eos_id=vocab["[SEP]"], pad_id=vocab["[PAD]"],
        beam_size=tr["beam_size"], length_penalty=tr["length_penalty"],
        forbid_duplicate_ngrams=tr["forbid_duplicate_ngrams"],
        ngram_size=tr["ngram_size"], min_len=0, max_tgt_length=T))
    rng = np.random.default_rng(np.random.SeedSequence((ctx.seed, 2)))
    images = np.concatenate([rng.permutation(inp.n_images) for _ in range(
        -(-tr["captions"] // inp.n_images))])[:tr["captions"]]
    eval_list = [CaptionExample(inputs_lib.image_key(int(img)), [],
                                image_id=e) for e, img in enumerate(images)]
    builder = DecodeExampleBuilder(vcfg, vocab, new_segment_ids=True,
                                   max_tgt_length=T)

    def passes():
        """The eval list over and over, one EvalLoader a pass."""
        while True:
            yield from EvalLoader(eval_list, store, builder, B,
                                  feature_slab_slots=3, prefetch=True)

    loader = passes()
    captions = {}

    def collect(chunk, handle):
        out = decoder.beam_collect(handle)
        for i, ex in enumerate(chunk):
            words = []
            for tok in tokenizer.convert_ids_to_tokens(
                    [int(x) for x in out["pred_seq"][i]]):
                if tok in ("[SEP]", "[PAD]"):
                    break
                words.append(tok)
            captions[ex.image_id] = " ".join(detokenize(words))
        return out

    # set-up: the cell's one batch shape, decoded twice
    for _ in range(tr["setup_batches"]):
        batch, chunk, _ = next(loader)
        collect(chunk, decoder.beam_dispatch(upload(batch, dev)))
    harness.sync(dev)
    ctx.spans.clear()

    done, kept, profiled = [], [], 0
    t0 = ctx.open_window()
    pending = None
    i = 0
    while True:
        ctx.step_begin(i)
        profiling = ctx.profiler is not None and ctx.profiler.active
        with ctx.span("loader"):
            batch, chunk, _ = next(loader)
        with ctx.span("step"):
            handle = decoder.beam_dispatch(upload(batch, dev))
        profiled += profiling
        t_done = None
        if pending is not None:
            with ctx.span("collect"):
                out = collect(*pending)
            t_done = time.monotonic()
            if t_done <= ctx.window_end:
                done.append((t_done, len(pending[0]), 1))
                kept.append(([ex.feature_key for ex in pending[0]], out))
        ctx.step_end(i)
        pending = (chunk, handle)
        if t_done is not None and ctx.window_over(t_done):
            break
        i += 1
    collect(*pending)
    loader.close()
    harness.sync(dev)
    peak = harness.memory_peak(dev)
    store.close()
    del model, decoder, handle, pending
    harness.release(dev)

    gap, mismatched = score_gaps(ctx, dev, seeds, inp, kept, "fp32")
    limits = tr["limits"]
    checks = [{"name": "score_gap", "value": gap,
               "limit": limits["score_gap"]},
              {"name": "path_mismatch", "value": mismatched,
               "limit": limits["path_mismatch"]}]
    K = tr["beam_size"]
    P = cfg["len_vis_input"] + 2
    H = cfg["num_attention_heads"]
    per_batch = cfg["num_hidden_layers"] * (
        work.attention_fwd_ms(B, P + 1, H, [1] * B, [P + 1] * B, P)
        + sum(work.decode_step_ms(B, K, 2, P, work.gen_slots(T), H, t)
              for t in range(T - 1)))
    ctx.record.update(
        attempted=sum(d[1] for d in done), failed=0, done=done,
        window_start=t0, memory_peak_bytes=peak, checks=checks,
        profiled_steps=profiled, profiled_samples=B * profiled,
        attn_bound_ms=per_batch * profiled,
        flop_per_sample=work.beam_flop_per_caption(cfg, K, T))


def served_path(wids, ptrs, scores, eos: int):
    """The caption the back-trace picks from one example's beam trace
    (``[T, K]`` each), as the reference decoder states it (length
    penalty 0): the best beam at the first frame where every beam has
    ended, or at the last frame, and its cumulative scores along the
    way.  Returns (tokens, cumulative scores)."""
    T, K = wids.shape
    last = T - 1
    for t in range(T):
        if (wids[t] == eos).all():
            last = t
            break
    best, frame, pos = -np.inf, -1, -1
    for f in range(last + 1):
        for k in range(K):
            if (wids[f, k] == eos or f == last) and scores[f, k] > best:
                best, frame, pos = scores[f, k], f, k
    toks, cum = [], []
    for f in range(frame, -1, -1):
        toks.append(int(wids[f, pos]))
        cum.append(float(scores[f, pos]))
        pos = int(ptrs[f, pos])
    return toks[::-1], cum[::-1]


def sample_captions(ctx, inp, kept):
    """A sample, drawn from the seed, of the captions the window
    completed, the longest among them: (image, served tokens, the beam's
    cumulative scores along them, whether the served tokens are the
    trace's path)."""
    rng = np.random.default_rng(np.random.SeedSequence((ctx.seed, 3)))
    flat = [(b, i) for b, (keys, _) in enumerate(kept)
            for i in range(len(keys))]
    eos = inp.vocab_index["[SEP]"]
    if not flat:
        return []
    n = min(ctx.traffic["check_captions"], len(flat))
    pick = [flat[j] for j in rng.choice(len(flat), n, replace=False)]
    lengths = [int((kept[b][1]["pred_seq"][i] != 0).sum()) for b, i in flat]
    longest = flat[int(np.argmax(lengths))]
    if longest not in pick:
        pick[-1] = longest
    out = []
    for b, i in pick:
        keys, res = kept[b]
        toks, cum = served_path(res["wids"][i], res["ptrs"][i],
                                res["scores"][i], eos)
        served = [int(x) for x in res["pred_seq"][i][:len(toks)]]
        out.append((int(keys[i]), toks, cum, served == toks))
    return out


def reference_cums(ctx, dev, seeds, inp, picks, precision: str):
    """The reference's cumulative log-probabilities of each sampled
    caption's tokens, run in ``precision`` on the served (bfloat16)
    weights."""
    cfg = ctx.cfg
    ref_model.no_tf32()
    W = {n: t.float() for n, t in weights_lib.make_weights(
        cfg, False, seeds["weights"], dev, dtype=torch.bfloat16).items()}
    q = ref_model.Precision(precision)
    cums = []
    for img, toks, _, _ in picks:
        prompt = ref_data.decode_prompt(inp, cfg, img)
        pr = {k: torch.from_numpy(np.asarray(v))[None].to(dev)
              for k, v in prompt.items()}
        pr["mask_id"] = inp.vocab_index["[MASK]"]
        lp = ref_model.caption_logprobs(W, cfg, pr,
                                        torch.tensor([toks], device=dev), q)
        cums.append(torch.cumsum(lp[0].double(), 0).tolist())
    return cums


def widest_gap(cums_a, cums_b) -> float:
    return max(max(abs(x - y) for x, y in zip(a, b))
               for a, b in zip(cums_a, cums_b))


def score_gaps(ctx, dev, seeds, inp, kept, precision: str):
    """(widest gap between the beam's cumulative log-probability and the
    reference's over the sampled captions, number of sampled captions
    whose served tokens are not their trace's path); with
    ``ctx.controls`` also the control's and the altered-token fault's
    gaps in ``ctx.record["control"]``."""
    picks = sample_captions(ctx, inp, kept)
    if not picks:           # nothing completed in the window: not correct
        return 1e9, 0
    ref = reference_cums(ctx, dev, seeds, inp, picks, precision)
    ok = [j for j, p in enumerate(picks) if p[3]]
    gap = widest_gap([picks[j][2] for j in ok], [ref[j] for j in ok]) \
        if ok else 1e9
    if ctx.controls:
        low = reference_cums(ctx, dev, seeds, inp, picks, "fp8")
        rng = np.random.default_rng(np.random.SeedSequence((ctx.seed, 4)))
        altered = []
        for img, toks, cum, good in picks:
            toks = list(toks)
            t = int(rng.integers(len(toks)))
            toks[t] = int(rng.integers(inputs_lib.FIRST_WORD,
                                       len(inp.vocab)))
            altered.append((img, toks, cum, good))
        alt = reference_cums(ctx, dev, seeds, inp, altered, precision)
        ctx.record["control"] = {
            "fp8": {"score_gap": widest_gap(low, ref)},
            "token_altered": {"score_gap": widest_gap(
                [p[2] for p in picks], alt)}}
    return gap, len(picks) - len(ok)
