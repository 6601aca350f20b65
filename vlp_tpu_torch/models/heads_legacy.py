"""The reference's HuggingFace-era BERT task heads over the port's backbone
(counterpart of ``vlp_tpu/models/heads_legacy.py``; reference
modeling.py:878-978, 1497-1966).  The VLP CLIs never build them; they run
text-only, as a pure-text BERT: zero region features, the bidirectional
mask, and ``text_end = attention_len`` (the whole row without one).

    from vlp_tpu_torch.models.heads_legacy import BertForSequenceClassification
    head = BertForSequenceClassification(cfg, num_labels=3)
    ckpt.load_into(head, ckpt.load_reference_bin("bert.bin", cfg))
    logits = head(input_ids, attention_len=lens)              # deterministic
    loss = head(input_ids, labels=y, drop=DropoutRNG(seed, dev))  # training

Every head but ``PairRelHead`` is a :class:`VLPModel` with its task layer
added under the reference's parameter name (``cls.seq_relationship``,
``classifier``, ``qa_outputs``; ``extract``, which the reference builds
differently), so a reference-named legacy state dict, after
``checkpoint.apply_surgery``, loads as the VLP one does.  ``PairRelHead``
stands alone (``R_xy.dense``, ``rel_emb``).  The encoder runs the attention
kernels in bi mode: K1 without ``drop``, K1 dropout + K2 with a
:class:`DropoutRNG`, which also draws the heads' own dropout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vlp_tpu_torch import torch_dtype
from vlp_tpu_torch.config import MODE_BI, VLPConfig
from vlp_tpu_torch.models.model import (ACT, DropoutRNG, VLPModel, _Dense,
                                        _hidden_dropout, _linear)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[labels] over the last axis (fp32).  An index
    past the end reads NaN and a negative one wraps, as JAX's
    ``take_along_axis`` does."""
    n = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    logp = torch.cat([logp, torch.full_like(logp[..., :1], float("nan"))],
                     dim=-1)
    idx = torch.where(labels < 0, labels + n, labels).clamp(0, n).long()
    return -torch.gather(logp, -1, idx[..., None])[..., 0]


class _TextBackbone(VLPModel):
    """:class:`VLPModel` driven text-only (JAX ``_TextBackbone``).  A head
    that reads no MLM logits has no MLM head (``with_mlm=False``), as in
    the reference and in the JAX package's parameter tree: ``cls`` is then
    an empty container for ``cls.seq_relationship``."""

    def __init__(self, cfg: VLPConfig, with_mlm: bool = True):
        super().__init__(cfg)
        if not with_mlm:
            self.cls = nn.Module()

    def text_encode(self, input_ids, token_type_ids=None, attention_len=None,
                    drop: Optional[DropoutRNG] = None):
        """(seq_out, pooled) of ``input_ids`` [B, L] in bi mode."""
        cfg = self.cfg
        B, L = input_ids.shape
        dev = input_ids.device
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        text_end = (torch.full((B,), L, dtype=torch.int32, device=dev)
                    if attention_len is None else attention_len.int())
        mode = torch.full((B,), MODE_BI, dtype=torch.int32, device=dev)
        feats = torch.zeros((B, cfg.len_vis_input, cfg.vis_feat_dim),
                            device=dev)
        pe = torch.zeros((B, cfg.len_vis_input, cfg.vis_pe_dim), device=dev)
        return self.encode(input_ids, token_type_ids, mode, text_end, feats,
                           pe, drop=drop)

    def mlm_logits(self, seq: torch.Tensor) -> torch.Tensor:
        """fp32 [B, L, V]: the tied MLM head at every position, head 0."""
        task_idx = torch.zeros((seq.shape[0],), dtype=torch.int32,
                               device=seq.device)
        return self.lm_logits(seq, task_idx)

    def head_dropout(self, x, drop: Optional[DropoutRNG]):
        return _hidden_dropout(drop, x, self.cfg.hidden_dropout_prob)


class BertForMaskedLM(_TextBackbone):
    """MLM logits, or the mean NLL over labels other than -1 and 0."""

    def forward(self, input_ids, token_type_ids=None, attention_len=None,
                masked_lm_labels=None, drop: Optional[DropoutRNG] = None):
        seq, _ = self.text_encode(input_ids, token_type_ids, attention_len,
                                  drop)
        logits = self.mlm_logits(seq)
        if masked_lm_labels is None:
            return logits
        nll = _nll(logits, masked_lm_labels)
        mask = ((masked_lm_labels != -1) & (masked_lm_labels != 0)).float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)


class BertForPreTraining(_TextBackbone):
    """MLM + next-sentence logits (modeling.py:878-945)."""

    def __init__(self, cfg: VLPConfig):
        super().__init__(cfg)
        self.cls.seq_relationship = nn.Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, attention_len=None,
                drop: Optional[DropoutRNG] = None):
        seq, pooled = self.text_encode(input_ids, token_type_ids,
                                       attention_len, drop)
        nsp = _linear(self.cls.seq_relationship, pooled).float()
        return self.mlm_logits(seq), nsp


class BertForNextSentencePrediction(_TextBackbone):
    def __init__(self, cfg: VLPConfig):
        super().__init__(cfg, with_mlm=False)
        self.cls.seq_relationship = nn.Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, attention_len=None,
                drop: Optional[DropoutRNG] = None):
        _, pooled = self.text_encode(input_ids, token_type_ids,
                                     attention_len, drop)
        return _linear(self.cls.seq_relationship, pooled).float()


class BertForSequenceClassification(_TextBackbone):
    def __init__(self, cfg: VLPConfig, num_labels: int = 2):
        super().__init__(cfg, with_mlm=False)
        self.classifier = nn.Linear(cfg.hidden_size, num_labels)

    def forward(self, input_ids, token_type_ids=None, attention_len=None,
                labels=None, drop: Optional[DropoutRNG] = None):
        _, pooled = self.text_encode(input_ids, token_type_ids,
                                     attention_len, drop)
        pooled = self.head_dropout(pooled, drop)
        logits = _linear(self.classifier, pooled).float()
        if labels is None:
            return logits
        return _nll(logits, labels).mean()


class BertForMultipleChoice(_TextBackbone):
    """input_ids [B, C, L]: the choices flattened into the batch."""

    def __init__(self, cfg: VLPConfig, num_choices: int = 2):
        super().__init__(cfg, with_mlm=False)
        self.num_choices = num_choices
        self.classifier = nn.Linear(cfg.hidden_size, 1)

    def forward(self, input_ids, token_type_ids=None, attention_len=None,
                labels=None, drop: Optional[DropoutRNG] = None):
        B, C, L = input_ids.shape

        def flat(x):
            return None if x is None else x.reshape(B * C, *x.shape[2:])

        _, pooled = self.text_encode(flat(input_ids), flat(token_type_ids),
                                     flat(attention_len), drop)
        pooled = self.head_dropout(pooled, drop)
        logits = _linear(self.classifier, pooled).float().reshape(B, C)
        if labels is None:
            return logits
        return _nll(logits, labels).mean()


class BertForTokenClassification(_TextBackbone):
    def __init__(self, cfg: VLPConfig, num_labels: int = 2):
        super().__init__(cfg, with_mlm=False)
        self.classifier = nn.Linear(cfg.hidden_size, num_labels)

    def forward(self, input_ids, token_type_ids=None, attention_len=None,
                labels=None, drop: Optional[DropoutRNG] = None):
        seq, _ = self.text_encode(input_ids, token_type_ids, attention_len,
                                  drop)
        seq = self.head_dropout(seq, drop)
        logits = _linear(self.classifier, seq).float()
        if labels is None:
            return logits
        return _nll(logits, labels).mean()


class BertForQuestionAnswering(_TextBackbone):
    def __init__(self, cfg: VLPConfig):
        super().__init__(cfg, with_mlm=False)
        self.qa_outputs = nn.Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, attention_len=None,
                start_positions=None, end_positions=None,
                drop: Optional[DropoutRNG] = None):
        seq, _ = self.text_encode(input_ids, token_type_ids, attention_len,
                                  drop)
        logits = _linear(self.qa_outputs, seq).float()
        start, end = logits[..., 0], logits[..., 1]
        if start_positions is None or end_positions is None:
            return start, end
        L = seq.shape[1]
        # positions clipped to [0, L]; L itself reads NaN, as in JAX
        sp, ep = (x.clamp(0, L) for x in (start_positions, end_positions))
        return (_nll(start, sp).mean() + _nll(end, ep).mean()) / 2


class BertForExtractiveSummarization(_TextBackbone):
    """Per-token extraction scores, gathered at ``sentence_positions``
    (modeling.py:1497-1523 capability; the reference's secondary heads
    are not kept, as in the JAX package)."""

    def __init__(self, cfg: VLPConfig):
        super().__init__(cfg, with_mlm=False)
        self.extract = nn.Linear(cfg.hidden_size, 1)

    def forward(self, input_ids, token_type_ids=None, attention_len=None,
                sentence_positions=None, drop: Optional[DropoutRNG] = None):
        seq, _ = self.text_encode(input_ids, token_type_ids, attention_len,
                                  drop)
        if sentence_positions is not None:
            idx = sentence_positions.long()[..., None].expand(
                -1, -1, seq.shape[-1])
            seq = torch.gather(seq, 1, idx)
        return _linear(self.extract, seq).float()[..., 0]


class PairRelHead(nn.Module):
    """Pairwise relation scoring (modeling.py:948-978 capability): the
    per-pair loss -log sigmoid(score * pos_neg_mask)."""

    def __init__(self, cfg: VLPConfig, num_rel: int = 2):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.R_xy = _Dense(2 * H, H)
        self.rel_emb = nn.Embedding(num_rel, H)
        self.act = ACT[cfg.hidden_act]
        self.dtype = torch_dtype(cfg.dtype)

    def forward(self, pair_x, pair_y, pair_r, pair_pos_neg_mask):
        """pair_x/pair_y [..., H]; pair_r int [...]; the mask +1 / -1."""
        xy = torch.cat([pair_x, pair_y], dim=-1).to(self.dtype)
        xy = self.act(_linear(self.R_xy.dense, xy))
        r = F.embedding(pair_r.long(), self.rel_emb.weight)
        score = (xy.float() * r).sum(dim=-1)
        return -F.logsigmoid(score * pair_pos_neg_mask.float())


HEADS = (BertForMaskedLM, BertForPreTraining, BertForNextSentencePrediction,
         BertForSequenceClassification, BertForMultipleChoice,
         BertForTokenClassification, BertForQuestionAnswering,
         BertForExtractiveSummarization, PairRelHead)
