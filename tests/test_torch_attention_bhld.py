"""The port's ``layout="bhld"`` attention (vlp_tpu_torch/ops/attention.py,
the counterpart of ``attention_pallas(layout="bhld")``) against the JAX
package on the CPU.

* Dropout off: the forward (``attention`` and ``FusedAttention``) and the
  q/k/v gradients match ``jax.vjp`` of ``attention_pallas(layout="bhld")``,
  whose ``_fwd_kernel`` and ``_bwd_kernel`` run in interpret mode.  fp32,
  forward within 2e-5, gradients within 2e-4.
* Dropout on: JAX's CPU dropout is ``jax.random`` (attention.py:432-454),
  so against JAX only the distribution could agree; instead the port's bhld
  plain versions are held bit for bit against its blhd plain versions on
  transposed inputs, which is what the kernels must do on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.ops import attention as jattn
from vlp_tpu_torch.ops import attention as tattn

B, H, L, D, PREFIX = 2, 2, 128, 16, 102
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(rng, mode):
    """[B, H, L, D] q/k/v/dout; row 0 of each batch s2s or bi, text_end
    inside the caption, one masked region."""
    q, k, v, do = (rng.normal(size=(B, H, L, D)).astype(np.float32)
                   for _ in range(4))
    md = np.asarray([1, 1] if mode == "s2s" else [0, 0], np.int32)
    te = np.asarray([PREFIX + 9, PREFIX + 20], np.int32)
    ck = np.ones((B, L), np.float32)
    ck[:, 7] = 0.0
    return q, k, v, do, md, te, ck


@jax.jit
def _pallas_vjp(q, k, v, do, md, te, ck):
    def f(q, k, v):
        return jattn.attention_pallas(q, k, v, md, te, ck, prefix=PREFIX,
                                      layout="bhld")

    out, vjp = jax.vjp(f, q, k, v)
    return out, vjp(do)


@pytest.mark.parametrize("mode", ["s2s", "bi"])
def test_bhld_matches_jax_pallas(mode, rng):
    q, k, v, do, md, te, ck = _inputs(rng, mode)
    out_j, grads_j = _pallas_vjp(*(jnp.asarray(a)
                                   for a in (q, k, v, do, md, te, ck)))
    tq, tk, tv, tdo, tm, tte, tck = (torch.from_numpy(a)
                                     for a in (q, k, v, do, md, te, ck))
    out = tattn.attention(tq, tk, tv, tm, tte, tck, prefix=PREFIX,
                          layout="bhld")
    assert out.shape == (B, H, L, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **FWD_TOL)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fused = tattn.FusedAttention.apply(*leaves, tm, tte, tck, PREFIX, 0.0,
                                       None, "bhld")
    np.testing.assert_allclose(fused.detach().numpy(), np.asarray(out_j),
                               **FWD_TOL)
    grads = torch.autograd.grad(fused, leaves, tdo)
    plain = tattn.attention_bwd_plain(tq, tk, tv, tm, tte, tck, tdo,
                                      prefix=PREFIX, layout="bhld")
    for got, want, which in zip(grads, grads_j, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL,
                                   err_msg=f"d{which}")
    for got, auto in zip(plain, grads):
        np.testing.assert_array_equal(got.numpy(), auto.numpy())


def test_bhld_dropout_equals_blhd_on_transposed_inputs(rng):
    """One seed, rate 0.1: the bhld forward and gradients are the blhd
    ones with dims 1 and 2 swapped, bit for bit (the same Philox counter
    (column/4, row, head, example) in both layouts)."""
    q, k, v, do, md, te, ck = _inputs(rng, "s2s")
    md[1] = 0
    tq, tk, tv, tdo, tm, tte, tck = (torch.from_numpy(a)
                                     for a in (q, k, v, do, md, te, ck))
    seed = 0xFEEDFACE01234567
    runs = {}
    for layout in ("bhld", "blhd"):
        x = [t if layout == "bhld" else t.transpose(1, 2).contiguous()
             for t in (tq, tk, tv, tdo)]
        leaves = [t.clone().requires_grad_() for t in x[:3]]
        out = tattn.FusedAttention.apply(*leaves, tm, tte, tck, PREFIX, 0.1,
                                         seed, layout)
        grads = torch.autograd.grad(out, leaves, x[3])
        if layout == "blhd":
            out, grads = out.transpose(1, 2), [g.transpose(1, 2)
                                               for g in grads]
        runs[layout] = [out.detach()] + list(grads)
    for a, b in zip(runs["bhld"], runs["blhd"]):
        assert torch.equal(a, b)
    no_drop = tattn.attention(tq, tk, tv, tm, tte, tck, prefix=PREFIX,
                              layout="bhld")
    assert (runs["bhld"][0] - no_drop).abs().max() > 1e-3


def test_unknown_layouts_raise():
    q = torch.zeros(1, 1, 4, 8)
    one = torch.ones(1, dtype=torch.int32)
    for call in (lambda: tattn.attention(q, q, q, one, one, torch.ones(1, 4),
                                         prefix=2, layout="hbld"),
                 lambda: tattn.FusedAttention.apply(q, q, q, one, one,
                                                    torch.ones(1, 4), 2, 0.0,
                                                    None, "bhdl")):
        with pytest.raises(ValueError, match="layout"):
            call()
