"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card, and the wrappers' device dispatch and build bookkeeping on the
CPU.  JAX-free, so that it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests marked ``cuda`` skip (through the ``cuda`` fixture) without a GPU."""

import os
import shutil

import numpy as np
import pytest
import torch

from vlp_tpu_torch.config import MODE_BI, MODE_S2S
from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops import attention as attn
from vlp_tpu_torch.ops import decode_attention as dec
from vlp_tpu_torch.ops import philox

NEG = -10000.0
FP32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=1e-2)  # one bf16 ulp at 2-4 is 1.6e-2
DTYPES = [(torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _anc_bias(g, B, K, G, gen_len, dev):
    anc = torch.randint(0, K, (B * K, G), generator=g, device=dev)
    anc[:, gen_len:gen_len + 2] = (torch.arange(B * K, device=dev) % K)[:, None]
    beams = torch.arange(K, device=dev)[None, :, None]
    bias = torch.full((B * K, K, G), NEG, device=dev)
    return bias.masked_fill(anc[:, None, :] == beams, 0.0).reshape(B * K,
                                                                   K * G)


def test_cpu_tensors_take_the_plain_versions_without_a_build():
    """On the CPU the wrappers never build or launch anything."""
    before = {k: v.launches for k, v in _build.KERNELS.items()}
    q = torch.randn(2, 5, 2, 4)
    one = torch.ones(2, dtype=torch.int32)
    attn.attention(q, q, q, one, one * 5, torch.ones(2, 5), prefix=2)
    B, K, S, P, G, HD = 1, 2, 2, 3, 8, 8
    x = torch.randn(B * K, S, HD)
    gk, gv = torch.zeros(B * K, G, HD), torch.zeros(B * K, G, HD)
    dec.decode_attention(x, x, x, torch.randn(B, P, HD), torch.randn(B, P, HD),
                         gk, gv, 0, n_heads=2,
                         beam_bias=torch.zeros(B * K, K * G))
    assert {k: v.launches for k, v in _build.KERNELS.items()} == before
    assert _build.library.cache_info().currsize == 0 or \
        torch.cuda.is_available()


def test_build_dir_follows_the_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", str(src))
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    first = _build.build_dir()
    assert first == _build.build_dir()
    with open(src / "decode_attention.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.build_dir() != first


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not os.path.exists(tmp_path / "build")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", ["prefill", "encode"])
def test_attention_kernel_matches_plain(cuda, dtype, tol, shape):
    g = torch.Generator(device=cuda).manual_seed(0)
    H, D, P = 12, 64, 102
    B, L = (8, P + 1) if shape == "prefill" else (8, 128)
    qkv = torch.randn(B, L, 3 * H * D, generator=g, device=cuda).to(dtype)
    q, k, v = (t.view(B, L, H, D) for t in qkv.split(H * D, dim=-1))
    if shape == "prefill":
        mode = torch.full((B,), MODE_S2S, device=cuda)
        te = torch.full((B,), L, device=cuda)
        ck = torch.ones(B, L, device=cuda)
    else:
        mode = torch.randint(MODE_BI, MODE_S2S + 1, (B,), generator=g,
                             device=cuda)
        te = torch.randint(P + 1, L + 1, (B,), generator=g, device=cuda)
        ck = (torch.rand(B, L, generator=g, device=cuda) > 0.1).float()
    before = _build.KERNELS["attention_fwd"].launches
    got = attn.attention(q, k, v, mode, te, ck, prefix=P)
    assert _build.KERNELS["attention_fwd"].launches == before + 1
    want = attn.attention_plain(q, k, v, mode, te, ck, prefix=P)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("K,anc", [(1, False), (5, False), (5, True)],
                         ids=["K3_greedy", "K3_beam", "K4_anc"])
def test_decode_kernel_matches_plain(cuda, dtype, tol, K, anc):
    g = torch.Generator(device=cuda).manual_seed(1)
    B, S, P, G, H = 6, 2, 102, 24, 12
    HD = H * 64
    for gen_len in (0, 9, 18, 23):
        def r(*shape):
            return torch.randn(*shape, generator=g, device=cuda).to(dtype)
        q, k, v = (r(B * K, S, HD) for _ in range(3))
        pk, pv = (r(B, P + 1, HD)[:, :P] for _ in range(2))  # strided
        gk, gv = r(B * K, G, HD), r(B * K, G, HD)
        bias = _anc_bias(g, B, K, G, gen_len, cuda) if anc else None
        gk2, gv2 = gk.clone(), gv.clone()
        got = dec.decode_attention(q, k, v, pk, pv, gk, gv, gen_len,
                                   n_heads=H, beam_bias=bias)
        want = dec.decode_attention_plain(q, k, v, pk, pv, gk2, gv2, gen_len,
                                          n_heads=H, beam_bias=bias)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert torch.equal(gk, gk2) and torch.equal(gv, gv2)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.randn(2, 9, 2, 32, device=cuda)       # head width 32
    one = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="D == 64"):
        attn.attention(q, q, q, one, one * 9, torch.ones(2, 9, device=cuda),
                       prefix=4)
    x = torch.randn(2, 2, 128, device=cuda)
    gk = torch.zeros(2, 8, 128, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dec.decode_attention(x, x, x, torch.randn(1, 3, 128, device=cuda),
                             torch.randn(1, 3, 128, device=cuda),
                             gk.transpose(0, 1).contiguous().transpose(0, 1),
                             gk, 0, n_heads=2)
    np.testing.assert_equal(gk.cpu().numpy(), 0)


def _train_inputs(g, dev, dtype, B=6, L=128, H=12, P=102):
    """Training-shaped attention inputs: mixed modes, some zero colkeep."""
    qkv = torch.randn(B, L, 3 * H * 64, generator=g, device=dev).to(dtype)
    q, k, v = (t.view(B, L, H, 64) for t in qkv.split(H * 64, dim=-1))
    mode = torch.tensor([MODE_S2S, MODE_BI] * (B // 2), device=dev)
    te = torch.randint(P + 1, L + 1, (B,), generator=g, device=dev)
    ck = torch.ones(B, L, device=dev)
    ck[:, 1:P - 1] = (torch.rand(B, P - 2, generator=g, device=dev)
                      > 0.3).float()
    return q, k, v, mode, te, ck


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_training_attention_kernels_match_plain(cuda, dtype, tol, rate):
    """K1's dropout branch forward and K2 backward, through
    FusedAttention, against attention_plain / attention_bwd_plain."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, mode, te, ck = _train_inputs(g, cuda, dtype)
    seed = 0x0123456789ABCDEF
    dout = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    counts = {n: _build.KERNELS[n].launches
              for n in ("attention_fwd_drop", "attention_bwd")}
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = attn.FusedAttention.apply(*leaves, mode, te, ck, 102, rate, seed)
    grads = torch.autograd.grad(out, leaves, dout)
    assert {n: _build.KERNELS[n].launches for n in counts} == \
        {n: c + 1 for n, c in counts.items()}
    want = attn.attention_plain(q, k, v, mode, te, ck, prefix=102,
                                dropout_rate=rate, seed=seed)
    want_grads = attn.attention_bwd_plain(q, k, v, mode, te, ck, dout,
                                          prefix=102, dropout_rate=rate,
                                          seed=seed)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), **tol)
    for got, exp in zip(grads, want_grads):
        assert got.dtype == dtype and got.is_contiguous()
        torch.testing.assert_close(got.float(), exp.float(), **tol)


@pytest.mark.cuda
def test_dropout_mask_kernel_is_bit_exact(cuda):
    seed, rate = 2 ** 64 - 12345, 0.1
    before = _build.KERNELS["dropout_mask"].launches
    got = attn.dropout_mask(8, 12, 128, rate, seed, cuda)
    assert _build.KERNELS["dropout_mask"].launches == before + 1
    assert torch.equal(got, philox.keep_scale(seed, 8, 12, 128, rate,
                                              device=cuda))
    assert torch.equal(got.cpu(), philox.keep_scale(seed, 8, 12, 128, rate))
    assert abs(float((got > 0).float().mean()) - 0.9) < 0.005
    # an L that is not a multiple of 4
    assert torch.equal(attn.dropout_mask(2, 3, 103, rate, seed, cuda).cpu(),
                       philox.keep_scale(seed, 2, 3, 103, rate))


@pytest.mark.cuda
def test_backward_rejects_a_length_that_does_not_fit(cuda):
    x = torch.randn(1, 200, 1, 64, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="L <="):
        attn._backward_cuda(x, x, x, one, one * 200,
                            torch.ones(1, 200, device=cuda), x, 4, 0.0, None)
