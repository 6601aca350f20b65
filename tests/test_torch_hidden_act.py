"""``hidden_act`` relu and swish (a reference ``bert_config.json`` sets
it): the port's model (vlp_tpu_torch/models/model.py ``ACT``, every FFN
and the MLM head's transform) against the JAX VLPModel on identical
weights and batches, fp32, dropout off: the encoder's output, the losses
and every gradient, at the tolerances of tests/test_torch_train_step.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import (LOSS_TOL, TOL, _by_name,
                                         init_params, make_batch, tiny_cfg)
from vlp_tpu.parallel import train_step as jts
from vlp_tpu_torch import train_step as tts
from vlp_tpu_torch.models.model import VLPModel


@pytest.mark.parametrize("act", ["relu", "swish"])
def test_hidden_act_matches_jax(act, rng):
    cfg = tiny_cfg(hidden_act=act)
    params = init_params(cfg, 3)
    jmodel = jts.create_model(cfg)
    model = VLPModel(cfg)
    model.load_state_dict(_by_name(params, cfg), strict=True)
    batch = make_batch(cfg, 4, rng, 0.3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}

    keys = ("input_ids", "segment_ids", "mode", "text_end", "vis_feats",
            "vis_pe")
    seq_j, _ = jmodel.apply({"params": params}, *(jb[k] for k in keys),
                            method=jmodel.encode)
    with torch.no_grad():
        seq, _ = model.encode(*(tb[k] for k in keys))
    np.testing.assert_allclose(seq.numpy(), np.asarray(seq_j), **TOL)

    grads_j, metrics_j = jax.jit(lambda p, b: jts.grads_with_accum(
        jmodel, p, b, jax.random.PRNGKey(1), drop_worst_ratio=0.0,
        mask_image_regions=True, task="img2txt"))(params, jb)
    metrics = tts.grads_with_accum(model, tb, 7, drop_worst_ratio=0.0,
                                   mask_image_regions=True)
    for key in ("loss", "masked_lm_loss", "pretext_loss"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(metrics_j[key]), **LOSS_TOL,
                                   err_msg=key)
    want = _by_name(grads_j, cfg)
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)
