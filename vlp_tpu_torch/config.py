"""Configuration for the TPU-native VLP framework.

One frozen dataclass covers the reference's ``BertConfig``
(reference pytorch_pretrained_bert/modeling.py:77-171) plus the derived
geometry the reference computes in its CLI
(reference vlp/run_img2txt_dist.py:193: ``max_seq_length = max_len_b +
len_vis_input + 3``).

TPU-first deviations from the reference:
  * the on-device sequence length is padded up to a lane-aligned multiple of
    128 (``seq_len``); the logical 123-token layout lives inside it.  Padding
    tokens are masked out structurally, so numerics are unaffected.
  * attention masks are never materialised as ``B x L x L`` tensors on the
    host; each example carries scalar metadata (``mode``, ``text_end``) plus a
    100-long region-keep vector (see vlp_tpu/ops/masks.py).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class VLPConfig:
    """Model + task geometry configuration (reference BertConfig parity)."""

    # --- transformer backbone (modeling.py:81-96 defaults) ---
    vocab_size: int = 28996              # bert-base-cased
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 6             # new_segment_ids => 6 (run_img2txt_dist.py:313)
    relax_projection: int = 4            # 4 task-specific MLM projections (0 = off)
    initializer_range: float = 0.02
    label_smoothing: float = 0.0

    # --- VLP task geometry ---
    len_vis_input: int = 100             # number of region tokens (asserted ==100 upstream)
    vis_feat_dim: int = 2048             # Faster-RCNN fc6 region feature dim
    vis_cls_dim: int = 1601              # detector class-probability dim
    vis_pe_dim: int = 1607               # 6 geometry + 1601 cls probs (seq2seq_loader.py:350)
    max_len_b: int = 20                  # caption token budget
    max_pred: int = 20                   # max masked-LM predictions per example
    num_answers: int = 3129              # VQA2 answer vocabulary (modeling.py:1029)

    # --- numerics ---
    dtype: str = "bfloat16"              # activation dtype on TPU
    use_pallas_attention: bool = True    # fused-attention kernel vs XLA reference path
    # Fused decode-step attention kernel (ops/decode_attention.py) and its
    # column cache layout [*, H*D].  None = follow use_pallas_attention.
    # When active, KV caches are carried in the kernel layout; dropout-
    # active rollouts (SCST sampling) transpose into the XLA path.
    use_pallas_decode: "bool | None" = None
    # Attention-prob dropout impl for SCST sampled rollouts on the kernel
    # path: "auto" = fused decode kernel with on-chip PRNG when on real TPU
    # (falls back to the column-layout XLA math off-TPU, where pltpu.prng
    # has no lowering); "xla" = always the XLA math (A/B benchmarking /
    # bit-exact CPU<->TPU rollout comparison).
    decode_dropout_impl: str = "auto"
    fuse_qkv_proj: bool = False          # one runtime-concatenated QKV matmul
                                         # (param tree unchanged).  Measured
                                         # SLOWER on v5e (1310 vs 1340
                                         # samples/sec): the per-step fp32
                                         # kernel concat outweighs the saved
                                         # activation reads.  Off by default.

    # Manual tensor parallelism (shard_map): the bound mesh-axis name over
    # which attention heads and FFN columns are sharded.  When set, the
    # model inserts the Megatron f/g collectives (ops/tp.py) itself and
    # derives per-shard head counts from the actual parameter shapes, so
    # every shard runs the ordinary single-device program — Pallas kernels
    # included (GSPMD TP cannot partition Mosaic custom calls and must ride
    # XLA attention).  Only the training forward supports it; build the
    # step model with cfg.replace(tp_axis="model") and shard params with
    # parallel/mesh.tp_param_specs.  None = off (every other code path).
    tp_axis: "str | None" = None

    # The reference INTENDS to block masked-region attention columns
    # (seq2seq_loader.py:303-304) but `input_mask[:, pos].fill_(0)` writes to
    # an advanced-indexing copy — a silent no-op on every torch version, so
    # the published models were trained WITHOUT column blocking (features are
    # still zeroed, modeling.py:1050-1057).  Default False = actual reference
    # behavior; True = the intended semantics.
    block_masked_regions_in_attention: bool = False

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def pallas_decode(self) -> bool:
        """Effective decode-kernel switch (None defers to
        use_pallas_attention)."""
        if self.use_pallas_decode is None:
            return self.use_pallas_attention
        return self.use_pallas_decode

    @property
    def prefix_len(self) -> int:
        """[CLS] + regions + [SEP] — everything before the caption."""
        return self.len_vis_input + 2

    @property
    def logical_seq_len(self) -> int:
        """The reference's max_seq_length (run_img2txt_dist.py:193)."""
        return self.max_len_b + self.len_vis_input + 3

    @property
    def seq_len(self) -> int:
        """On-device (lane-aligned) sequence length."""
        return _round_up(self.logical_seq_len, 128)

    @property
    def max_txt_len(self) -> int:
        """Caption tokens + trailing [SEP]."""
        return self.max_len_b + 1

    # ------------------------------------------------------------------
    def replace(self, **kw: Any) -> "VLPConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_dict(cls, d: dict) -> "VLPConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json_file(cls, path: str) -> "VLPConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_reference_json(cls, path: str, **overrides: Any) -> "VLPConfig":
        """Load a reference-format bert_config.json (HF/UniLM field names)."""
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        mapped = {k: v for k, v in d.items()
                  if k in {f.name for f in dataclasses.fields(cls)}}
        mapped.update(overrides)
        return cls(**mapped)

    # small-model factory used across unit tests
    @classmethod
    def tiny(cls, **kw: Any) -> "VLPConfig":
        base = dict(
            vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            type_vocab_size=6, relax_projection=4, max_pred=5,
            dtype="float32", use_pallas_attention=False,
        )
        base.update(kw)
        return cls(**base)


# Special-token ids in the stock BERT vocabularies (tokenization.py vocab).
# These are *defaults*; CLIs re-derive them from the actual vocab file.
PAD_ID = 0
UNK_ID = 100
CLS_ID = 101
SEP_ID = 102
MASK_ID = 103

# Attention-mask modes (per-example scalar metadata).
MODE_BI = 0    # full bidirectional over non-pad tokens
MODE_S2S = 1   # prefix visible to all; causal within the caption
