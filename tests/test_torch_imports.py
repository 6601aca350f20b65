"""The port imports neither JAX nor the JAX package: a fresh interpreter
imports every module of vlp_tpu_torch and runs a tiny CPU train step, a
tiny CPU decode, a tiny SCST step and a tiny VQA step and answer through
it, the tensor-parallel helpers (f/g and the GSPMD collectives without a
group, a shard and gather round trip under both layouts, a rank's GSPMD
model, the vocab-parallel loss) and the learnability tool
(``cli.e2e_synthetic``: one group of steps, one SCST step), after which
none of vlp_tpu, jax, flax, optax or orbax is loaded."""

import os
import subprocess
import sys

SCRIPT = r"""
import importlib, pkgutil, sys
import vlp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vlp_tpu_torch.__path__,
                                               "vlp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("vlp_tpu_torch.cli.decode", "vlp_tpu_torch.cli.train",
             "vlp_tpu_torch.ops._build", "vlp_tpu_torch.train_step",
             "vlp_tpu_torch.data.loader", "vlp_tpu_torch.evals.coco",
             "vlp_tpu_torch.scst", "vlp_tpu_torch.ops.decode_attention",
             "vlp_tpu_torch.ops.philox", "vlp_tpu_torch.cli.eval_vqa2",
             "vlp_tpu_torch.evals.vqa", "vlp_tpu_torch.ops.tp",
             "vlp_tpu_torch.parallel.mesh", "vlp_tpu_torch.parallel.tp_step",
             "vlp_tpu_torch.losses", "vlp_tpu_torch.parallel.dist",
             "vlp_tpu_torch.models.model", "vlp_tpu_torch.cli.e2e_synthetic",
             "vlp_tpu_torch.host_copy"):
    assert name in names, name

import torch
from vlp_tpu_torch import optim, train_step
from vlp_tpu_torch.config import VLPConfig
from vlp_tpu_torch.decode import DecodeParams, Decoder
from vlp_tpu_torch.models.model import VLPModel
cfg = VLPConfig.tiny(len_vis_input=3, max_len_b=4, vis_feat_dim=8,
                     vis_pe_dim=8)
model = VLPModel(cfg)
model.init_weights(torch.Generator().manual_seed(0))
opt = optim.BertAdam(dict(model.named_parameters()), 1e-3)
step = train_step.make_train_step(model, opt, mask_image_regions=True)
metrics = step(train_step.dummy_batch(cfg, 2), seed=3)
assert torch.isfinite(metrics["loss"]) and opt.step_count == 1
model.eval()
B, L = 2, cfg.seq_len
batch = dict(input_ids=torch.zeros(B, L, dtype=torch.int32),
             segment_ids=torch.zeros(B, L, dtype=torch.int32),
             position_ids=torch.arange(L).expand(B, L),
             task_idx=torch.full((B,), 3), vis_feats=torch.randn(B, 3, 8),
             vis_pe=torch.randn(B, 3, 8))
out = Decoder(model, cfg, DecodeParams(beam_size=2, max_tgt_length=4,
                                       mask_id=5, eos_id=4))(batch)
assert out["pred_seq"].shape == (B, 4)
from vlp_tpu_torch.scst import SCSTTrainer
cfg = cfg.replace(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
model = VLPModel(cfg)
tr = SCSTTrainer(model, cfg, mask_id=5, eos_id=4, max_tgt_length=4,
                 optimizer=optim.BertAdam(dict(model.named_parameters()),
                                          1e-3))
loss, m = tr.step(batch, torch.randint(6, 20, (B, 5)).numpy(), seed=1)
assert torch.isfinite(torch.tensor(loss))
vqa = VLPModel(cfg, with_vqa=True)
opt = optim.BertAdam(dict(vqa.named_parameters()), 1e-3)
step = train_step.make_train_step(vqa, opt, task="vqa2")
metrics = step(train_step.dummy_batch(cfg, 2, task="vqa2"), seed=3)
assert torch.isfinite(metrics["vqa2_loss"]) and opt.step_count == 1
vqa.eval()
with torch.no_grad():
    ids = vqa.vqa_inference(train_step.dummy_batch(cfg, 2, task="vqa2"))
assert ids.shape == (2,) and bool((ids >= 1).all())
from vlp_tpu_torch.ops import tp as tp_ops
from vlp_tpu_torch.parallel import mesh
x = torch.ones(3, requires_grad=True)
assert tp_ops.sum_partial(tp_ops.replicate_for_branch(x, None), None) is x
full = {k: v.detach() for k, v in vqa.state_dict().items()}
back = mesh.gather_state_dict([mesh.shard_state_dict(full, t, 2)
                               for t in range(2)],
                              mesh.tp_param_specs(
                                  {k: v.shape for k, v in full.items()}, 2))
assert all(torch.equal(back[k], full[k]) for k in full)
# the GSPMD layout: its shard and gather, a rank's model, the collectives
# and the vocab-parallel loss without a group
from vlp_tpu_torch import losses
specs = mesh.tp_param_specs({k: v.shape for k, v in full.items()}, 2,
                            "gspmd")
back = mesh.gather_state_dict([mesh.shard_state_dict(full, t, 2, "gspmd")
                               for t in range(2)], specs)
assert all(torch.equal(back[k], full[k]) for k in full)
vqa.shard_(tp_ops.TP(index=1, size=2), layout="gspmd")
assert vqa.tp_specs == specs
assert vqa.cls.predictions.decoder.weight.shape[0] == cfg.vocab_size // 2
rows = tp_ops.vocab_parallel_rows(torch.tensor([0, 3]), torch.ones(2, 4),
                                  tp_ops.TP(index=1, size=2))
assert rows.sum().item() == 4.0
for f in (tp_ops.gather_last, tp_ops.sum_in_rank_order,
          tp_ops.max_over_group):
    assert torch.equal(f(x, None), x)
z = torch.randn(2, 3, 8)
t = torch.randint(0, 8, (2, 3))
assert torch.allclose(
    losses.mlm_position_loss_vocab_parallel(z, t, 0.1, 8,
                                            tp_ops.TP(index=0, size=1)),
    losses.mlm_position_loss(z, t, 0.1, 8))
# the learnability tool: one device-loop group, a greedy score, one SCST
# step
from vlp_tpu_torch.cli import e2e_synthetic
out = e2e_synthetic.main(["--device", "cpu", "--steps", "2",
                          "--device_loop", "2", "--batch", "4",
                          "--eval_images", "4", "--scst_steps", "1"])
assert out["steps"] == 2 and out["scst_steps"] == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("vlp_tpu", "jax", "jaxlib", "flax",
                                    "optax", "orbax"))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
