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
# fp16 (--true_fp16): the 16-bit bodies instantiated for fp16.  They round
# P o keep and dS to fp16 (2^-11 relative, 8x finer than bf16's 2^-8) where
# the plain versions keep fp32, and both round their outputs to fp16: two
# fp16 ulps at [2, 4) (1.95e-3 each) absolute and four ulps relative,
# against bf16's 3e-2 / 1e-2.
FP16_TOL = dict(atol=4e-3, rtol=2e-3)


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
    dec.decode_attention(x[:B], x[:B], x[:B], torch.randn(B, P, HD),
                         torch.randn(B, P, HD), gk[:B], gv[:B], 0, n_heads=2,
                         drop_seed=5, drop_rate=0.1)
    dec.decode_dropout_scales([1, 2], B, n_heads=2, S=S, P=P, G=G, rate=0.1,
                              device="cpu")
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
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_decode_dropout_kernel_matches_plain(cuda, dtype, tol):
    """K5 (the SCST rollout step, K == 1) against its plain version, and K3
    at rate 0."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, S, P, G, H = 6, 2, 102, 24, 12
    HD = H * 64
    seed = 2 ** 64 - 977
    for gen_len in (0, 9, 18, 23):
        def r(*shape):
            return torch.randn(*shape, generator=g, device=cuda).to(dtype)
        q, k, v = (r(B, S, HD) for _ in range(3))
        pk, pv = (r(B, P + 1, HD)[:, :P] for _ in range(2))
        gk, gv = r(B, G, HD), r(B, G, HD)
        gk2, gv2 = gk.clone(), gv.clone()
        before = _build.KERNELS["decode_attention_drop"].launches
        got = dec.decode_attention(q, k, v, pk, pv, gk, gv, gen_len,
                                   n_heads=H, drop_seed=seed, drop_rate=0.1)
        assert _build.KERNELS["decode_attention_drop"].launches == before + 1
        want = dec.decode_attention_plain(q, k, v, pk, pv, gk2, gv2, gen_len,
                                          n_heads=H, drop_seed=seed,
                                          drop_rate=0.1)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert torch.equal(gk, gk2) and torch.equal(gv, gv2)
    before = _build.KERNELS["decode_attention"].launches
    dec.decode_attention(q, k, v, pk, pv, gk, gv, 3, n_heads=H,
                         drop_seed=seed, drop_rate=0.0)
    assert _build.KERNELS["decode_attention"].launches == before + 1


def _decode_inputs(g, dev, dtype, B, K, S, P, G, H):
    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)
    q, k, v = (r(B * K, S, H * 64) for _ in range(3))
    pk, pv = (r(B, P + 1, H * 64)[:, :P] for _ in range(2))  # strided
    return q, k, v, pk, pv, r(B * K, G, H * 64), r(B * K, G, H * 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("anc", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("case", ["two_mtiles", "P37", "K13"])
def test_decode_kernel_edge_shapes_match_plain(cuda, dtype, tol, anc, case):
    """Shapes past the main path's: K*S = 20 query rows (two m16 tiles of
    the bf16 body, two passes of the fp32 one), a prompt of 37 columns (the
    generated columns start off an 8-column tile) and 13 beams (414 joint
    columns at gen_len = G - 1, within P + K*G <= 417, the first fp32
    body's limit: the fp32 body runs passes of 2 rows, K4's bias read from
    global memory), with gen_len = G - 1 among the steps (one new token
    dropped, every slot visible)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    B, K, S, P, G, H = 3, 5, 2, 102, 24, 4
    if case == "two_mtiles":
        K = 10
    elif case == "K13":
        K = 13
    else:
        P = 37
    for gen_len in (0, 9, G - 1):
        q, k, v, pk, pv, gk, gv = _decode_inputs(g, cuda, dtype, B, K, S, P,
                                                 G, H)
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
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_decode_dropout_kernel_is_plain_times_the_regenerated_mask(cuda, dtype,
                                                                   tol):
    """K5's output is the plain K3 math times K6's multipliers (the replay's
    contract), at the SCST shape and at gen_len = G - 1."""
    g = torch.Generator(device=cuda).manual_seed(12)
    B, S, P, G, H = 4, 2, 102, 24, 12
    seeds = [philox.step_seed(9, 2, t, 1) for t in range(3)]
    mult = dec.decode_dropout_scales(seeds, B, n_heads=H, S=S, P=P, G=G,
                                     rate=0.1, device=cuda)
    for t, gen_len in enumerate((0, 18, G - 1)):
        ops = _decode_inputs(g, cuda, dtype, B, 1, S, P, G, H)
        copies = [x.clone() for x in ops[5:]]
        got = dec.decode_attention(*ops, gen_len, n_heads=H,
                                   drop_seed=seeds[t], drop_rate=0.1)
        want = dec.decode_attention_plain(*ops[:5], *copies, gen_len,
                                          n_heads=H,
                                          drop_mult=mult[t * B:(t + 1) * B])
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert torch.equal(ops[5], copies[0]) and torch.equal(ops[6],
                                                              copies[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("kind", ["K3", "K4", "K5"])
def test_decode_kernel_reads_only_the_visible_slots(cuda, dtype, tol, kind):
    """Cache slots from gen_len + S on are never read: filled with NaN, the
    kernel's output equals the plain version's on clean copies, and its
    cache writes are bit-exact (the NaN slots left as they were), up to
    gen_len = G - 1 (one new token dropped)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    B, S, P, G, H = 4, 2, 102, 24, 12
    K = 5 if kind == "K4" else 1
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    for gen_len in (0, 9, G - 2, G - 1):
        q, k, v, pk, pv, gk, gv = _decode_inputs(g, cuda, dtype, B, K, S, P,
                                                 G, H)
        kw = dict(n_heads=H)
        if kind == "K4":
            kw["beam_bias"] = _anc_bias(g, B, K, G, gen_len, cuda)
        if kind == "K5":
            kw.update(drop_seed=2 ** 63 + 5, drop_rate=0.1)
        clean_k, clean_v = gk.clone(), gv.clone()
        gk[:, gen_len + S:] = float("nan")
        gv[:, gen_len + S:] = float("nan")
        want = dec.decode_attention_plain(q, k, v, pk, pv, clean_k, clean_v,
                                          gen_len, **kw)
        got = dec.decode_attention(q, k, v, pk, pv, gk, gv, gen_len, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        clean_k[:, gen_len + S:] = float("nan")
        clean_v[:, gen_len + S:] = float("nan")
        assert torch.equal(gk.view(bits), clean_k.view(bits))
        assert torch.equal(gv.view(bits), clean_v.view(bits))


# (B, H, S, P, G): the SCST shape at a small B; an odd B with P+G = 125;
# P+G = 128; an odd total of rows (W*B*H*S) with P+G = 125
K6_SHAPES = [(8, 12, 2, 102, 24), (5, 12, 2, 101, 24), (3, 12, 2, 104, 24),
             (5, 3, 1, 101, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K6_SHAPES,
                         ids=["scst", "oddB-125", "128", "oddrows-125"])
@pytest.mark.parametrize("W", [1, 19, 128])
def test_decode_dropout_scales_kernel_is_bit_exact(cuda, W, shape):
    """K6 writes K5's multipliers: row t*B + b from seeds[t], bit for bit
    philox.decode_keep_scale on the card and on the CPU, for row widths P+G
    that leave rows 8- or 4-byte aligned and row counts that do not fill
    the last segment."""
    B, H, S, P, G = shape
    seeds = [philox.step_seed(3, 1, t, 0) for t in range(W)]
    seeds[min(4, W - 1)] = 2 ** 64 - 1
    before = _build.KERNELS["decode_dropout_scales"].launches
    got = dec.decode_dropout_scales(seeds, B, n_heads=H, S=S, P=P, G=G,
                                    rate=0.1, device=cuda)
    assert _build.KERNELS["decode_dropout_scales"].launches == before + 1
    assert got.shape == (W * B, H, S, P + G)
    want = dec.decode_dropout_scales(seeds, B, n_heads=H, S=S, P=P, G=G,
                                     rate=0.1, device="cpu")
    assert torch.equal(got.cpu(), want)
    t = min(4, W - 1)
    assert torch.equal(got[t * B:(t + 1) * B], philox.decode_keep_scale(
        seeds[t], B, H, S, P, G, 0.1, device=cuda))
    # the keep fraction within 4 standard deviations of 0.9 (0.0018 at the
    # SCST shape, 0.028 at the smallest)
    assert abs(float((got > 0).float().mean()) - 0.9) < 4 * (
        0.09 / got.numel()) ** 0.5
    with pytest.raises(ValueError, match="128"):
        dec.decode_dropout_scales(list(range(1, 130)), 1, n_heads=1, S=2,
                                  P=4, G=8, rate=0.1, device=cuda)


def _k6_segments(W, B, H, S, cols, grid, seg_rows=8):
    """decode_dropout.cu's split of the output among `grid` blocks, in
    Python: units of `unit` rows dealt out evenly (the first units % grid
    blocks take one more), each block's contiguous rows walked in segments
    of seg_rows rows; yields (first row, rows)."""
    rows = W * B * H * S
    unit = 1 if cols % 4 == 0 else 2 if cols % 2 == 0 else 4
    units = -(-rows // unit)
    grid = min(grid, units)
    per_block, extra = divmod(units, grid)
    for blk in range(grid):
        u_begin = blk * per_block + min(blk, extra)
        begin = min(rows, u_begin * unit)
        end = min(rows, (u_begin + per_block + (blk < extra)) * unit)
        for r0 in range(begin, end, seg_rows):
            yield r0, min(seg_rows, end - r0)


@pytest.mark.parametrize("grid", [1, 7, 132 * 12])
@pytest.mark.parametrize("W", [1, 19, 128])
@pytest.mark.parametrize("shape", K6_SHAPES)
def test_decode_dropout_segments_cover_the_output_aligned(shape, W, grid):
    """Every row of K6's output lies in exactly one segment, every segment
    starts on a 16-byte boundary, and only the last one of the output can
    end off it (its tail of n % 4 floats is stored one float at a time)."""
    B, H, S, P, G = shape
    cols, rows = P + G, W * B * H * S
    seen = np.zeros(rows, np.int64)
    for r0, n in _k6_segments(W, B, H, S, cols, grid):
        assert (r0 * cols * 4) % 16 == 0
        assert (n * cols) % 4 == 0 or r0 + n == rows
        seen[r0:r0 + n] += 1
    assert (seen == 1).all()


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
    with pytest.raises(ValueError, match="K == 1"):
        dec.decode_attention(x, x, x, torch.randn(1, 3, 128, device=cuda),
                             torch.randn(1, 3, 128, device=cuda), gk, gk, 0,
                             n_heads=2, drop_seed=1, drop_rate=0.1)


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


def _mla_inputs(g, dev, B=6, L=128, H=16, P=102):
    """MLA-shaped attention inputs (q.k 192 beside v 128, bf16), cut from
    one projection's output as the model cuts them: mixed modes, some zero
    colkeep."""
    dq, dv = attn.MLA_QK_DIM, attn.MLA_V_DIM
    x = torch.randn(B, L, H * (2 * dq + dv), generator=g,
                    device=dev).bfloat16()
    q, k, v = x.split([H * dq, H * dq, H * dv], dim=-1)
    q, k = q.contiguous().view(B, L, H, dq), k.contiguous().view(B, L, H, dq)
    v = v.contiguous().view(B, L, H, dv)
    mode = torch.tensor([MODE_S2S, MODE_BI] * (B // 2), device=dev)
    te = torch.randint(min(P + 1, L), L + 1, (B,), generator=g, device=dev)
    ck = torch.ones(B, L, device=dev)
    ck[:, 1:P - 1] = (torch.rand(B, P - 2, generator=g, device=dev)
                      > 0.3).float()
    return q, k, v, mode, te, ck


@pytest.mark.cuda
@pytest.mark.parametrize("L", [16, 103, 123, 128])
def test_mla_attention_kernels_match_plain(cuda, L):
    """K1 / K2 at MLA's (192, 128), through FusedAttention at rate 0 (as
    the Kimi-VL model calls them), against the plain versions, counted
    under their own names."""
    g = torch.Generator(device=cuda).manual_seed(3)
    P = min(102, L - 1)
    q, k, v, mode, te, ck = _mla_inputs(g, cuda, L=L, P=P)
    dout = torch.randn(v.shape, generator=g, device=cuda).bfloat16()
    names = ("attention_fwd_mla", "attention_bwd_mla")
    counts = {n: _build.KERNELS[n].launches for n in names}
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = attn.FusedAttention.apply(*leaves, mode, te, ck, P, 0.0, None)
    grads = torch.autograd.grad(out, leaves, dout)
    assert {n: _build.KERNELS[n].launches for n in names} == \
        {n: c + 1 for n, c in counts.items()}
    want = attn.attention_plain(q, k, v, mode, te, ck, prefix=P)
    want_grads = attn.attention_bwd_plain(q, k, v, mode, te, ck, dout,
                                          prefix=P)
    torch.cuda.synchronize()
    assert out.shape == v.shape
    torch.testing.assert_close(out.float(), want.float(), **BF16_TOL)
    for got, exp in zip(grads, want_grads):
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert got.shape == exp.shape
        torch.testing.assert_close(got.float(), exp.float(), **BF16_TOL)


@pytest.mark.cuda
def test_mla_wrappers_reject_what_the_kernels_do_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, mode, te, ck = _mla_inputs(g, cuda, B=2, L=128)
    with pytest.raises(ValueError, match="no dropout"):
        attn.FusedAttention.apply(q, k, v, mode, te, ck, 102, 0.1, 7)
    with pytest.raises(TypeError, match="bf16"):
        attn.attention(q.float(), k.float(), v.float(), mode, te, ck,
                       prefix=102)
    q2, k2, v2, mode2, te2, ck2 = _mla_inputs(g, cuda, B=2, L=144)
    with pytest.raises(ValueError, match="L <= 128"):
        attn.attention(q2, k2, v2, mode2, te2, ck2, prefix=102)
    with pytest.raises(ValueError, match="D == 64"):   # v of 64 is not MLA
        attn.attention(q, k, v[..., :64], mode, te, ck, prefix=102)


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
@pytest.mark.parametrize("L", [1, 4, 5, 103, 128, 256])
def test_dropout_mask_kernel_is_bit_exact_at_length(cuda, L):
    """Rows of L floats that are 16-byte aligned (L % 4 == 0: one 16-byte
    store a counter) and that are not, a last block of rows that L leaves
    short, and two blocks of columns (L = 256)."""
    seed, rate, B, H = 0x9E3779B97F4A7C15, 0.1, 3, 5
    before = _build.KERNELS["dropout_mask"].launches
    got = attn.dropout_mask(B, H, L, rate, seed, cuda)
    assert _build.KERNELS["dropout_mask"].launches == before + 1
    assert got.shape == (B, H, L, L)
    assert torch.equal(got.cpu(), philox.keep_scale(seed, B, H, L, rate))


@pytest.mark.cuda
def test_backward_rejects_a_length_that_does_not_fit(cuda):
    n = _build.library().vlp_attention_bwd_max_len() + 1
    x = torch.randn(1, n, 1, 64, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="L <="):
        attn._backward_cuda(x, x, x, one, one * n,
                            torch.ones(1, n, device=cuda), x, 4, 0.0, None)


def _bhld_inputs(g, dev, dtype, strided, B=6, L=128, H=12, P=102):
    """[B, H, L, 64] q/k/v (``strided``: slices of one [B, H, L, 192]
    tensor) and dout, with training-shaped mask metadata."""
    if strided:
        qkv = torch.randn(B, H, L, 3 * 64, generator=g, device=dev).to(dtype)
        q, k, v = qkv.split(64, dim=-1)
    else:
        q, k, v = (torch.randn(B, H, L, 64, generator=g, device=dev).to(dtype)
                   for _ in range(3))
    _, _, _, mode, te, ck = _train_inputs(g, dev, dtype, B=B, L=L, H=1, P=P)
    dout = torch.randn(B, H, L, 64, generator=g, device=dev).to(dtype)
    return q, k, v, mode, te, ck, dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("strided", [False, True], ids=["packed", "strided"])
def test_bhld_kernels_match_plain(cuda, dtype, tol, rate, strided):
    """The [B, H, L, D] forward (both branches) and backward, through
    attention(layout="bhld") and FusedAttention, against their plain
    versions; each call launches its own kernel once."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, mode, te, ck, dout = _bhld_inputs(g, cuda, dtype, strided)
    seed = 0x0123456789ABCDEF
    names = ("attention_fwd_bhld", "attention_fwd_bhld_drop",
             "attention_bwd_bhld")
    counts = {n: _build.KERNELS[n].launches for n in names}
    det = attn.attention(q, k, v, mode, te, ck, prefix=102, layout="bhld")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = attn.FusedAttention.apply(*leaves, mode, te, ck, 102, rate, seed,
                                    "bhld")
    grads = torch.autograd.grad(out, leaves, dout)
    assert {n: _build.KERNELS[n].launches for n in names} == \
        {n: c + 1 for n, c in counts.items()}
    kw = dict(prefix=102, layout="bhld")
    want = attn.attention_plain(q, k, v, mode, te, ck, dropout_rate=rate,
                                seed=seed, **kw)
    want_grads = attn.attention_bwd_plain(q, k, v, mode, te, ck, dout,
                                          dropout_rate=rate, seed=seed, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        det.float(), attn.attention_plain(q, k, v, mode, te, ck,
                                          **kw).float(), **tol)
    torch.testing.assert_close(out.float(), want.float(), **tol)
    for got, exp in zip(grads, want_grads):
        assert got.shape == q.shape and got.is_contiguous()
        torch.testing.assert_close(got.float(), exp.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bhld_kernels_equal_blhd_on_transposed_inputs(cuda, dtype):
    """With dropout on, one seed: the bhld kernels' forward and gradients
    are the blhd kernels' with dims 1 and 2 swapped, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, mode, te, ck, dout = _bhld_inputs(g, cuda, dtype, False)
    seed = 2 ** 63 + 12345
    runs = []
    for layout, xs in (("bhld", (q, k, v, dout)),
                       ("blhd", [x.transpose(1, 2).contiguous()
                                 for x in (q, k, v, dout)])):
        leaves = [x.detach().requires_grad_() for x in xs[:3]]
        out = attn.FusedAttention.apply(*leaves, mode, te, ck, 102, 0.1,
                                        seed, layout)
        grads = torch.autograd.grad(out, leaves, xs[3])
        runs.append([t if layout == "bhld" else t.transpose(1, 2)
                     for t in (out, *grads)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bhld_wrappers_reject_what_the_kernels_do_not_take(cuda):
    one = torch.ones(2, dtype=torch.int32, device=cuda)
    ck = torch.ones(2, 16, device=cuda)
    x = torch.randn(2, 3, 64, 16, device=cuda).transpose(2, 3)  # [B,H,L,D]
    with pytest.raises(ValueError, match="contiguous"):
        attn.attention(x, x, x, one, one * 16, ck, prefix=4, layout="bhld")
    y = torch.randn(2, 3, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="layout"):
        attn.attention(y, y, y, one, one * 16, ck, prefix=4, layout="lbhd")


def _check_fwd_bwd(q, k, v, mode, te, ck, dout, tol, rate, layout="blhd",
                   prefix=102):
    """Both forward branches and the backward through the wrappers against
    their plain versions."""
    seed = 0x243F6A8885A308D3
    kw = dict(prefix=prefix, layout=layout)
    det = attn.attention(q, k, v, mode, te, ck, **kw)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = attn.FusedAttention.apply(*leaves, mode, te, ck, prefix, rate, seed,
                                    layout)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        det.float(), attn.attention_plain(q, k, v, mode, te, ck,
                                          **kw).float(), **tol)
    torch.testing.assert_close(out.float(), attn.attention_plain(
        q, k, v, mode, te, ck, dropout_rate=rate, seed=seed,
        **kw).float(), **tol)
    for got, exp in zip(grads, attn.attention_bwd_plain(
            q, k, v, mode, te, ck, dout, dropout_rate=rate, seed=seed, **kw)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), exp.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("L", [103, 127])
def test_ragged_lengths_match_plain(cuda, dtype, tol, rate, L):
    """An L that is not a multiple of 16: the padded columns take no share
    of the softmax and the padded rows are not stored."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, mode, te, ck = _train_inputs(g, cuda, dtype, B=4, L=L, H=3)
    dout = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    _check_fwd_bwd(q, k, v, mode, te, ck, dout, tol, rate)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fully_masked_example_matches_plain(cuda, rate):
    """A bi-mode example whose every column is dropped by colkeep: its rows
    spread over the L real columns only (L = 103, so 9 padded ones).  The
    bf16 body only: such a row's fp32 scores sit at -10000 + s, where one
    fp32 ulp is ~1e-3, so a summation order other than the plain
    version's moves P by ~1e-3 relative and the fp32 tolerance (1e-4)
    does not hold for it even between two plain orders."""
    dtype, tol = torch.bfloat16, BF16_TOL
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, mode, te, ck = _train_inputs(g, cuda, dtype, B=4, L=103, H=2)
    mode[1], te[1] = MODE_BI, 103
    ck[1] = 0.0
    dout = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    _check_fwd_bwd(q, k, v, mode, te, ck, dout, tol, rate)
    # the all-masked rows' P sums to 1 over the L real columns: P V = 1
    # for V = 1 (the padded V rows are zeros)
    q, k, v1 = (t.contiguous() for t in (q, k, torch.ones_like(v)))
    out = attn.attention(q, k, v1, mode, te, ck, prefix=102)
    torch.testing.assert_close(out[1].float(), torch.ones_like(out[1]).float(),
                               **tol)


# past L = 128: lengths that fill their last 16-row, 64-key or 128-row tile
# and lengths that do not, up to the kernels' limit
LONG_FWD_LENGTHS = [144, 145, 160, 256, 417, 528]


def _long_inputs(g, dev, dtype, L, layout, B=2, H=2):
    """Training-shaped inputs at length L in ``layout`` (text_end >= 103)."""
    q, k, v, mode, te, ck = _train_inputs(g, dev, dtype, B=B, L=L, H=H)
    te = torch.randint(103, L + 1, (B,), generator=g, device=dev)
    if layout == "bhld":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return q, k, v, mode, te, ck


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES + [(torch.float16, FP16_TOL)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["blhd", "bhld"])
@pytest.mark.parametrize("L", LONG_FWD_LENGTHS)
def test_long_forward_matches_plain(cuda, dtype, tol, rate, layout, L):
    """Lengths past one 128-column chunk: the 16-bit row-block body (two
    passes over streamed 64-key tiles) and the fp32 body over several key
    tiles, in both layouts."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, mode, te, ck = _long_inputs(g, cuda, dtype, L, layout)
    seed = 0x13198A2E03707344
    got = attn._forward_cuda(q, k, v, mode, te, ck, 102, dropout=(rate, seed),
                             layout=layout)
    want = attn.attention_plain(q, k, v, mode, te, ck, prefix=102,
                                dropout_rate=rate, seed=seed, layout=layout)
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("L", [160, 256, 528])
def test_long_forward_is_deterministic_and_bhld_equals_blhd(cuda, dtype, L):
    """The row-block body, both branches: two calls give the same bits, and
    bhld on transposed inputs gives blhd's bits (one body, vlp::Strides;
    the same Philox counter)."""
    g = torch.Generator(device=cuda).manual_seed(15)
    q, k, v, mode, te, ck = _long_inputs(g, cuda, dtype, L, "blhd", H=3)
    tr = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    for rate in (0.0, 0.1):
        drop = (rate, 0xB7E151628AED2A6A)
        first = attn._forward_cuda(q, k, v, mode, te, ck, 102, dropout=drop)
        again = attn._forward_cuda(q, k, v, mode, te, ck, 102, dropout=drop)
        bhld = attn._forward_cuda(*tr, mode, te, ck, 102, dropout=drop,
                                  layout="bhld")
        torch.cuda.synchronize()
        assert torch.equal(first, again)
        assert torch.equal(bhld.transpose(1, 2), first)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("L", [160, 528])
def test_long_forward_fully_masked_example_matches_plain(cuda, rate, L):
    """The row-block body on a bi-mode example whose every column is dropped
    by colkeep (no key tile is skipped for it): its rows spread over the L
    real columns, as the plain version's do, and P V = 1 for V = 1."""
    g = torch.Generator(device=cuda).manual_seed(16)
    q, k, v, mode, te, ck = _long_inputs(g, cuda, torch.bfloat16, L, "blhd",
                                         B=4)
    mode[1], te[1] = MODE_BI, L
    ck[1] = 0.0
    seed = 0x6A09E667F3BCC908
    got = attn._forward_cuda(q, k, v, mode, te, ck, 102, dropout=(rate, seed))
    want = attn.attention_plain(q, k, v, mode, te, ck, prefix=102,
                                dropout_rate=rate, seed=seed)
    q1, k1, v1 = (t.contiguous() for t in (q, k, torch.ones_like(v)))
    ones = attn.attention(q1, k1, v1, mode, te, ck, prefix=102)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    torch.testing.assert_close(ones[1].float(),
                               torch.ones_like(ones[1]).float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16_TOL),
                                       (torch.float16, FP16_TOL)])
@pytest.mark.parametrize("pad", [1, 2, 4], ids=["align2", "align4", "align8"])
def test_long_forward_unaligned_bhld_strides_match_plain(cuda, dtype, tol,
                                                         pad):
    """The row-block body at L = 256 on bhld q/k/v whose row stride (and,
    for q, base) is not 16-byte aligned: narrower copies into its Q rows
    and key tiles, both branches, and the same bits as aligned inputs."""
    g = torch.Generator(device=cuda).manual_seed(17)
    B, H, L, D = 2, 3, 256, 64
    qkv = torch.randn(B, H, L, 3 * D + pad, generator=g,
                      device=cuda).to(dtype)
    q, k, v = (qkv[..., pad + i * D:pad + (i + 1) * D] if i == 0 else
               qkv[..., i * D:(i + 1) * D] for i in range(3))
    _, _, _, mode, te, ck = _train_inputs(g, cuda, dtype, B=B, L=L, H=1)
    for rate in (0.0, 0.1):
        drop = (rate, 0xBB67AE8584CAA73B)
        got = attn._forward_cuda(q, k, v, mode, te, ck, 102, dropout=drop,
                                 layout="bhld")
        packed = attn._forward_cuda(*(t.contiguous() for t in (q, k, v)),
                                    mode, te, ck, 102, dropout=drop,
                                    layout="bhld")
        want = attn.attention_plain(q, k, v, mode, te, ck, prefix=102,
                                    dropout_rate=rate, seed=drop[1],
                                    layout="bhld")
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert torch.equal(got, packed)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["blhd", "bhld"])
@pytest.mark.parametrize("L", [144, 145, 160, 192, 256, 384, 528])
def test_long_backward_matches_plain(cuda, rate, layout, L):
    """bf16 past the one-block body (L <= 144): the tiled body, in both
    layouts, against attention_bwd_plain, at lengths that fill their last
    64-row tile and lengths that do not."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q, k, v, mode, te, ck = _train_inputs(g, cuda, torch.bfloat16, B=2, L=L,
                                          H=3)
    te = torch.randint(103, L + 1, (2,), generator=g, device=cuda)
    dout = torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16)
    if layout == "bhld":
        q, k, v, dout = (t.transpose(1, 2).contiguous()
                         for t in (q, k, v, dout))
    seed = 0x3243F6A8885A308D
    got = attn._backward_cuda(q, k, v, mode, te, ck, dout, 102, rate, seed,
                              layout)
    want = attn.attention_bwd_plain(q, k, v, mode, te, ck, dout, prefix=102,
                                    dropout_rate=rate, seed=seed,
                                    layout=layout)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == q.shape and torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(), **BF16_TOL)


@pytest.mark.cuda
def test_bf16_backward_takes_the_forward_lengths(cuda):
    """The backward's limit is the bf16 forward's, in both dtypes: the
    forward and the backward take L = max_len, both refuse max_len + 1."""
    lib = _build.library()
    L = lib.vlp_attention_bwd_max_len()
    assert L == 528
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        for n in (L, L + 1):
            x = torch.randn(1, n, 1, 64, device=cuda).to(dtype)
            args = (x, x, x, one, one * n, torch.ones(1, n, device=cuda))
            if n == L:
                attn.attention(*args, prefix=4)
                attn._backward_cuda(*args, x, 4, 0.0, None)
                continue
            with pytest.raises(RuntimeError, match="attention_fwd"):
                attn.attention(*args, prefix=4)
            with pytest.raises(ValueError, match="L <="):
                attn._backward_cuda(*args, x, 4, 0.0, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_backward_at_its_max_len_matches_plain(cuda, dtype, tol):
    L = _build.library().vlp_attention_bwd_max_len()
    assert L >= 134      # the first version's limit
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, mode, te, ck = _train_inputs(g, cuda, dtype, B=2, L=L, H=2)
    te = torch.randint(103, L + 1, (2,), generator=g, device=cuda)
    dout = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    _check_fwd_bwd(q, k, v, mode, te, ck, dout, tol, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("pad", [1, 2, 4], ids=["align2", "align4", "align8"])
def test_bhld_unaligned_strides_match_plain(cuda, dtype, tol, pad):
    """bhld q/k/v/dout whose row stride (and, for q, base) is not 16-byte
    aligned: the kernels stage with narrower copies and still agree."""
    g = torch.Generator(device=cuda).manual_seed(10)
    B, H, L, D = 4, 3, 128, 64
    qkv = torch.randn(B, H, L, 3 * D + pad, generator=g,
                      device=cuda).to(dtype)
    q, k, v = (qkv[..., pad + i * D:pad + (i + 1) * D] if i == 0 else
               qkv[..., i * D:(i + 1) * D] for i in range(3))
    dout = torch.randn(B, H, L, D + pad, generator=g,
                       device=cuda).to(dtype)[..., :D]
    _, _, _, mode, te, ck = _train_inputs(g, cuda, dtype, B=B, L=L, H=1)
    _check_fwd_bwd(q, k, v, mode, te, ck, dout, tol, 0.1, layout="bhld")


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_long_fully_masked_example_matches_plain(cuda, rate):
    """The tiled backward (L = 256) on a bi-mode example whose every column
    is dropped by colkeep: its rows' softmax spreads over the -10000
    columns as the plain version's does."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, mode, te, ck = _train_inputs(g, cuda, torch.bfloat16, B=4,
                                          L=256, H=2)
    mode[1], te[1] = MODE_BI, 256
    ck[1] = 0.0
    dout = torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16)
    _check_fwd_bwd(q, k, v, mode, te, ck, dout, BF16_TOL, rate)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [1, 2, 4], ids=["align2", "align4", "align8"])
def test_long_bhld_unaligned_strides_match_plain(cuda, pad):
    """The tiled backward on bhld inputs whose row stride (and, for q,
    base) is not 16-byte aligned: narrower copies into its tiles."""
    g = torch.Generator(device=cuda).manual_seed(12)
    B, H, L, D = 2, 3, 256, 64
    qkv = torch.randn(B, H, L, 3 * D + pad, generator=g,
                      device=cuda).to(torch.bfloat16)
    q, k, v = (qkv[..., pad + i * D:pad + (i + 1) * D] if i == 0 else
               qkv[..., i * D:(i + 1) * D] for i in range(3))
    dout = torch.randn(B, H, L, D + pad, generator=g,
                       device=cuda).to(torch.bfloat16)[..., :D]
    _, _, _, mode, te, ck = _train_inputs(g, cuda, torch.bfloat16, B=B, L=L,
                                          H=1)
    _check_fwd_bwd(q, k, v, mode, te, ck, dout, BF16_TOL, 0.1,
                   layout="bhld")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["blhd", "bhld"])
@pytest.mark.parametrize("L", [128, 256, 528])
def test_backward_is_deterministic(cuda, layout, L):
    """Two calls on the same inputs give bit-identical dq, dk and dv: no sum
    depends on the order in which blocks run."""
    g = torch.Generator(device=cuda).manual_seed(14)
    q, k, v, mode, te, ck = _train_inputs(g, cuda, torch.bfloat16, B=2, L=L,
                                          H=3)
    dout = torch.randn(q.shape, generator=g, device=cuda).to(torch.bfloat16)
    if layout == "bhld":
        q, k, v, dout = (t.transpose(1, 2).contiguous()
                         for t in (q, k, v, dout))
    args = (q, k, v, mode, te, ck, dout, 102, 0.1, 0x9E3779B97F4A7C15,
            layout)
    first = attn._backward_cuda(*args)
    second = attn._backward_cuda(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _fp32_prefix(L):
    """The prefix of the fp32 length tests: the model's 102 where L leaves
    a caption after it, else half of L."""
    return 102 if L > 102 else L // 2


def _fp32_long_inputs(g, dev, L, layout, B=4, H=3, pad=0):
    """fp32 training-shaped inputs at length L in ``layout`` (``pad``: bhld
    q/k/v/dout sliced off wider rows, so that their row stride, and q's
    base, are not 16-byte aligned), prefix ``_fp32_prefix(L)``, example 1
    bi-mode with every column dropped by colkeep.  That example's q and k
    are multiples of 1/8 in [-1, 1]: its scores, and -10000 + s, are then
    exact in fp32 whatever the summation order (and exact in TF32: the
    split's lo parts are 0).  With random q and k, -10000 + s rounds to a
    multiple of 2^-10, so two summation orders move P by ~1e-3 relative
    and even two plain versions differ beyond FP32_TOL at L = 512
    (test_fully_masked_example_matches_plain)."""
    P = _fp32_prefix(L)
    q, k, v, mode, te, ck = _train_inputs(g, dev, torch.float32, B=B, L=L,
                                          H=H, P=P)
    te = torch.randint(P + 1, L + 1, (B,), generator=g, device=dev)
    mode[1], te[1] = MODE_BI, L
    ck[1] = 0.0
    q[1], k[1] = (torch.randint(-8, 9, q[1].shape, generator=g,
                                device=dev) / 8.0 for _ in range(2))
    dout = torch.randn(q.shape, generator=g, device=dev)
    if layout == "blhd":
        return q, k, v, mode, te, ck, dout
    ts = [t.transpose(1, 2) for t in (q, k, v, dout)]
    if pad:
        wide = [torch.zeros(*t.shape[:3], 64 + pad, device=dev) for t in ts]
        for w, t in zip(wide, ts):
            w[..., pad:] = t
        ts = [w[..., pad:] for w in wide]
    else:
        ts = [t.contiguous() for t in ts]
    return (*ts[:3], mode, te, ck, ts[3])


FP32_SEED = 0x6A09E667F3BCC909


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["blhd", "bhld"])
@pytest.mark.parametrize("L", [16, 103, 128, 135, 144, 418, 512, 528])
def test_fp32_long_forward_matches_plain(cuda, rate, layout, L):
    """The one split-TF32 fp32 forward at every length it serves: short
    ones (one key tile, a ragged last tile) and those past the first fp32
    forward's L <= 417, both layouts and branches, an all-masked example
    among them; bhld equals blhd bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(15)
    q, k, v, mode, te, ck, _ = _fp32_long_inputs(g, cuda, L, layout)
    P = _fp32_prefix(L)
    got = attn._forward_cuda(q, k, v, mode, te, ck, P,
                             dropout=(rate, FP32_SEED), layout=layout)
    want = attn.attention_plain(q, k, v, mode, te, ck, prefix=P,
                                dropout_rate=rate, seed=FP32_SEED,
                                layout=layout)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **FP32_TOL)
    if layout == "bhld":
        blhd = attn._forward_cuda(
            *(t.transpose(1, 2).contiguous() for t in (q, k, v)), mode, te,
            ck, P, dropout=(rate, FP32_SEED))
        assert torch.equal(got.transpose(1, 2), blhd)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["blhd", "bhld"])
@pytest.mark.parametrize("L", [16, 103, 128, 135, 144, 256, 417, 528])
def test_fp32_long_backward_matches_plain(cuda, rate, layout, L):
    """The one tiled split-TF32 fp32 backward at every length it serves,
    short ones among them, both layouts, an all-masked example among them:
    against its plain version, two calls bit for bit, and bhld = blhd bit
    for bit."""
    g = torch.Generator(device=cuda).manual_seed(16)
    q, k, v, mode, te, ck, dout = _fp32_long_inputs(g, cuda, L, layout)
    P = _fp32_prefix(L)
    args = (q, k, v, mode, te, ck, dout, P, rate, FP32_SEED, layout)
    got = attn._backward_cuda(*args)
    again = attn._backward_cuda(*args)
    want = attn.attention_bwd_plain(q, k, v, mode, te, ck, dout, prefix=P,
                                    dropout_rate=rate, seed=FP32_SEED,
                                    layout=layout)
    torch.cuda.synchronize()
    for a, a2, b in zip(got, again, want):
        assert a.shape == q.shape and torch.isfinite(a).all()
        torch.testing.assert_close(a, b, **FP32_TOL)
        assert torch.equal(a, a2)
    if layout == "bhld":
        blhd = attn._backward_cuda(
            *(t.transpose(1, 2).contiguous() for t in (q, k, v)), mode, te,
            ck, dout.transpose(1, 2).contiguous(), P, rate, FP32_SEED)
        for a, b in zip(got, blhd):
            assert torch.equal(a.transpose(1, 2), b)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [1, 2, 4], ids=["align2", "align4", "align8"])
def test_fp32_long_bhld_unaligned_strides_match_plain(cuda, pad):
    """The fp32 long bodies on bhld inputs whose row stride (and base) is
    not 16-byte aligned, through the wrappers."""
    g = torch.Generator(device=cuda).manual_seed(17)
    q, k, v, mode, te, ck, dout = _fp32_long_inputs(g, cuda, 512, "bhld",
                                                    pad=pad)
    assert q.stride(2) == 64 + pad
    _check_fwd_bwd(q, k, v, mode, te, ck, dout, FP32_TOL, 0.1,
                   layout="bhld")


@pytest.mark.cuda
@pytest.mark.parametrize("L", [128, 512])
def test_fp32_randn_inputs_match_plain(cuda, L):
    """fp32 forward and backward on torch.randn inputs (no multiples of 1/8,
    so every TF32 split has a nonzero lo part) and no all-masked example,
    rate 0.1, against the plain versions at FP32_TOL."""
    g = torch.Generator(device=cuda).manual_seed(18)
    q, k, v, mode, te, ck = _train_inputs(g, cuda, torch.float32, B=2, L=L,
                                          H=4)
    te = torch.randint(103, L + 1, (2,), generator=g, device=cuda)
    dout = torch.randn(q.shape, generator=g, device=cuda)
    _check_fwd_bwd(q, k, v, mode, te, ck, dout, FP32_TOL, 0.1)


@pytest.mark.cuda
def test_fp32_backward_scratch_is_linear_in_L(cuda):
    """The fp32 backward keeps per (example, head) only each row's m, 1/l
    and rowsum and one keep word per row and 32 keys: no L x L scratch."""
    lib = _build.library()
    for L in (16, 128, 135, 512, 528):
        rows = -(-L // 64) * 64
        assert lib.vlp_attention_bwd_scratch_floats(L, 0) == \
            (3 + -(-L // 32)) * rows
    assert lib.vlp_attention_bwd_scratch_floats(512, 0) * 50 < 2 * 512 ** 2


FP16_LENGTHS = [103, 128, 256, 528]   # ragged, one block, and the tiled body


def _fp16_inputs(g, dev, L, layout, B=2, H=3):
    q, k, v, mode, te, ck = _train_inputs(g, dev, torch.float16, B=B, L=L,
                                          H=H)
    te = torch.randint(103, L + 1, (B,), generator=g, device=dev)
    dout = torch.randn(q.shape, generator=g, device=dev).half()
    if layout == "bhld":
        q, k, v, dout = (t.transpose(1, 2).contiguous()
                         for t in (q, k, v, dout))
    return q, k, v, mode, te, ck, dout


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["blhd", "bhld"])
@pytest.mark.parametrize("L", FP16_LENGTHS)
def test_fp16_attention_kernels_match_plain(cuda, rate, layout, L):
    """K1 (deterministic through ``attention``, dropout through
    ``FusedAttention``) and K2 in fp16 against their plain versions run in
    fp16; each launch counts under its ``_fp16`` name only."""
    g = torch.Generator(device=cuda).manual_seed(21)
    q, k, v, mode, te, ck, dout = _fp16_inputs(g, cuda, L, layout)
    seed = 0x0DDB1A5E5BAD5EED
    sfx = "_bhld" if layout == "bhld" else ""
    names = [f"attention_fwd{sfx}{x}" for x in ("", "_drop")] + \
        [f"attention_bwd{sfx}"]
    before = {n: _build.KERNELS[n].launches for n in _build.KERNELS}
    det = attn.attention(q, k, v, mode, te, ck, prefix=102, layout=layout)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = attn.FusedAttention.apply(*leaves, mode, te, ck, 102, rate, seed,
                                    layout)
    grads = torch.autograd.grad(out, leaves, dout)
    after = {n: _build.KERNELS[n].launches for n in _build.KERNELS}
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} \
        == {n + "_fp16": 1 for n in names}
    kw = dict(prefix=102, layout=layout)
    want_det = attn.attention_plain(q, k, v, mode, te, ck, **kw)
    want = attn.attention_plain(q, k, v, mode, te, ck, dropout_rate=rate,
                                seed=seed, **kw)
    want_grads = attn.attention_bwd_plain(q, k, v, mode, te, ck, dout,
                                          dropout_rate=rate, seed=seed, **kw)
    torch.cuda.synchronize()
    for got, exp in ((det, want_det), (out, want), *zip(grads, want_grads)):
        assert got.dtype == torch.float16 and got.shape == q.shape
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), exp.float(), **FP16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("L", FP16_LENGTHS)
def test_fp16_bhld_equals_blhd_bit_for_bit(cuda, L):
    g = torch.Generator(device=cuda).manual_seed(22)
    q, k, v, mode, te, ck, dout = _fp16_inputs(g, cuda, L, "blhd")
    seed, rate = 0x5EED0F16, 0.1
    tr = [t.transpose(1, 2).contiguous() for t in (q, k, v, dout)]
    blhd = [attn.attention(q, k, v, mode, te, ck, prefix=102),
            attn._forward_cuda(q, k, v, mode, te, ck, 102,
                               dropout=(rate, seed)),
            *attn._backward_cuda(q, k, v, mode, te, ck, dout, 102, rate,
                                 seed)]
    bhld = [attn.attention(*tr[:3], mode, te, ck, prefix=102, layout="bhld"),
            attn._forward_cuda(*tr[:3], mode, te, ck, 102,
                               dropout=(rate, seed), layout="bhld"),
            *attn._backward_cuda(*tr[:3], mode, te, ck, tr[3], 102, rate,
                                 seed, "bhld")]
    torch.cuda.synchronize()
    for a, b in zip(bhld, blhd):
        assert torch.equal(a.transpose(1, 2), b)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [128, 528])
def test_fp16_keep_bits_equal_dropout_mask(cuda, L):
    """With q = k = 0 in bi mode over the whole row, P = 1/L everywhere,
    so the forward with V the identity on its first 64 keys shows P o keep
    of keys 0..63 of every row, and the backward's dV with dO the identity
    on rows 0..63 shows rows 0..63 against every key: their zeros are the
    keep bits the kernels drew, and they are dropout_mask's."""
    B, H, seed, rate = 2, 3, 0xFEEDFACECAFEBEEF, 0.1
    z = torch.zeros(B, L, H, 64, dtype=torch.float16, device=cuda)
    eye = torch.zeros_like(z)
    n = min(L, 64)
    eye[:, torch.arange(n), :, torch.arange(n)] = 1.0
    mode = torch.full((B,), MODE_BI, dtype=torch.int32, device=cuda)
    te = torch.full((B,), L, dtype=torch.int32, device=cuda)
    ck = torch.ones(B, L, device=cuda)
    out = attn._forward_cuda(z, z, eye, mode, te, ck, 102,
                             dropout=(rate, seed))
    _, _, dv = attn._backward_cuda(z, z, z, mode, te, ck, eye, 102, rate,
                                   seed)
    keep = attn.dropout_mask(B, H, L, rate, seed, cuda) > 0
    torch.cuda.synchronize()
    # out[b, i, h, d] = P o keep[b, h, i, d]; dv[b, j, h, d] = P o keep
    # [b, h, d, j]
    assert torch.equal(out[..., :n].permute(0, 2, 1, 3) != 0,
                       keep[..., :n])
    assert torch.equal(dv[..., :n].permute(0, 2, 3, 1) != 0,
                       keep[:, :, :n, :])


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
@pytest.mark.parametrize("layout", ["blhd", "bhld"])
@pytest.mark.parametrize("L", [128, 256])
def test_fp16_backward_passes_a_nonfinite_dout_through(cuda, bad, layout, L):
    """The loss scaler's overflow check reads the gradients: one inf or
    NaN in dO must leave dQ, dK and dV non-finite, not clamped or masked
    away."""
    g = torch.Generator(device=cuda).manual_seed(23)
    q, k, v, mode, te, ck, dout = _fp16_inputs(g, cuda, L, layout)
    if layout == "blhd":
        dout[0, 5, 1, 7] = bad
    else:
        dout[0, 1, 5, 7] = bad
    grads = attn._backward_cuda(q, k, v, mode, te, ck, dout, 102, 0.1,
                                0x1234, layout)
    torch.cuda.synchronize()
    for x in grads:
        assert not torch.isfinite(x).all()
    finite = attn._backward_cuda(q, k, v, mode, te, ck,
                                 torch.nan_to_num(dout, posinf=0.0), 102,
                                 0.1, 0x1234, layout)
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in finite)
