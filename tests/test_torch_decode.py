"""Port decoder (vlp_tpu_torch/decode.py) against the JAX Decoder on
identical weights and batches: greedy ids exact and log-probs at 1e-5; beam
search (min_len, duplicate-ngram forbid, length penalty) with ids and back
pointers exact, scores at 1e-4 and the back-traced captions exact.  The JAX
side runs its Pallas prefill and decode kernels (interpret mode) with the
fused beam reorder, as the port does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.decode import DecodeParams as JaxDecodeParams
from vlp_tpu.decode import Decoder as JaxDecoder
from vlp_tpu_torch.decode import DecodeParams, Decoder

from tests.test_torch_model import EOS, MASK, decode_batch, make_pair, \
    tiny_cfg


def _batches(cfg, B, rng):
    nb = decode_batch(cfg, B, rng)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


@pytest.mark.parametrize("T", [4, 6])
def test_greedy_matches_jax(T, rng):
    cfg = tiny_cfg(max_len_b=T)
    jmodel, params, model = make_pair(cfg, seed=2)
    jb, tb = _batches(cfg, 3, rng)
    kw = dict(mask_id=MASK, eos_id=EOS, max_tgt_length=T)
    ids_j, lp_j = JaxDecoder(jmodel, cfg, JaxDecodeParams(**kw)).greedy(
        params, jb)
    ids, lp = Decoder(model, cfg, DecodeParams(**kw)).greedy(tb)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), atol=1e-5,
                               rtol=1e-5)


BEAM_CASES = {
    "minlen_forbid_lp": dict(min_len=2, forbid_duplicate_ngrams=True,
                             ngram_size=2, length_penalty=0.5),
    "forbid_ignore": dict(forbid_duplicate_ngrams=True, ngram_size=2,
                          forbid_ignore_ids=(7, 9)),
    "plain": dict(),
}


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_beam_matches_jax(case, rng):
    T, K = 5, 3
    cfg = tiny_cfg(max_len_b=T)
    jmodel, params, model = make_pair(cfg, seed=3)
    jb, tb = _batches(cfg, 2, rng)
    kw = dict(mask_id=MASK, eos_id=EOS, beam_size=K, max_tgt_length=T,
              **BEAM_CASES[case])
    jdec = JaxDecoder(jmodel, cfg, JaxDecodeParams(**kw))
    assert jdec.dp.reorder_impl == "fused" and cfg.pallas_decode
    want = jdec.beam_search(params, jb)
    got = Decoder(model, cfg, DecodeParams(**kw)).beam_search(tb)
    np.testing.assert_array_equal(got["wids"], want["wids"])
    np.testing.assert_array_equal(got["ptrs"], want["ptrs"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(got["pred_seq"], want["pred_seq"])


def test_forbidden_candidates_match_jax():
    """The n-gram forbid set on hand-made histories, every step."""
    T, BK, V = 7, 4, 12
    rng = np.random.default_rng(5)
    seqs = rng.integers(0, 3, size=(T, BK)).astype(np.int32)
    for n in (2, 3):
        kw = dict(beam_size=2, max_tgt_length=T, ngram_size=n,
                  forbid_duplicate_ngrams=True, forbid_ignore_ids=(1,))
        jdec = JaxDecoder(None, None, JaxDecodeParams(**kw))
        tdec = Decoder(None, None, DecodeParams(**kw))
        for t in range(T):
            cj, fj = jdec._forbidden_candidates(jnp.asarray(seqs), t, V)
            ct, ft = tdec._forbidden_candidates(
                torch.from_numpy(seqs).long(), t, V)
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
            np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_dispatch_then_collect_equals_the_search(mode, rng):
    """The decode CLI's pipeline halves: ``beam_collect(beam_dispatch(b))``
    equals ``beam_search(b)``, and a greedy result fetched through
    ``host_copy.fetch`` / ``fetched`` equals ``greedy(b)``, bit for
    bit."""
    from vlp_tpu_torch.host_copy import fetch, fetched

    T = 5
    cfg = tiny_cfg(max_len_b=T)
    _, _, model = make_pair(cfg, seed=4)
    _, tb = _batches(cfg, 3, rng)
    dec = Decoder(model, cfg, DecodeParams(
        mask_id=MASK, eos_id=EOS, beam_size=3 if mode == "beam" else 1,
        max_tgt_length=T, forbid_duplicate_ngrams=True, ngram_size=2))
    if mode == "beam":
        want = dec.beam_search(tb)
        got = dec.beam_collect(dec.beam_dispatch(tb))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    else:
        want = dec.greedy(tb)[0].numpy()
        got = fetched(fetch({"ids": dec.greedy(tb)[0]}))["ids"]
        np.testing.assert_array_equal(got, want)
