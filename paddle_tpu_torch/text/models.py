"""BERT (counterpart of ``paddle_tpu/text/models.py``): the bert-base
pretraining model of the root bench's BERT rung, on the port's ``nn``
and its tensor API.

A post-LN ``nn.TransformerEncoder`` with GELU, a tanh pooler over the
first token, a masked-LM head whose decoder is tied to the word
embeddings (plus ``decoder_bias``, a parameter the layer creates) and a
next-sentence head. The parameter names are the JAX model's, so
``convert.load_jax_params`` carries a JAX model's ``state_dict``
across. With no attention mask and lengths that are multiples of 128,
each layer's attention takes the flash route: kernel B10 on the card.
``attention_probs_dropout_prob=0.0`` keeps it there while training
(dropout inside attention takes the dense route).
"""
from __future__ import annotations

from .. import ops as paddle
from ..nn import (GELU, Dropout, Embedding, Layer, LayerNorm, Linear, Tanh,
                  TransformerEncoder, TransformerEncoderLayer)
from ..nn import functional as F

__all__ = ["BertModel", "BertForPretraining", "BertPretrainingCriterion",
           "bert_base", "bert_tiny"]


class BertEmbeddings(Layer):
    def __init__(self, vocab_size, hidden_size, max_position,
                 type_vocab_size, dropout):
        super().__init__()
        self.word_embeddings = Embedding(vocab_size, hidden_size)
        self.position_embeddings = Embedding(max_position, hidden_size)
        self.token_type_embeddings = Embedding(type_vocab_size,
                                               hidden_size)
        self.layer_norm = LayerNorm(hidden_size)
        self.dropout = Dropout(dropout)

    def forward(self, input_ids, token_type_ids=None):
        b, s = input_ids.shape
        pos = paddle.arange(s).reshape([1, s]).expand([b, s])
        emb = self.word_embeddings(input_ids) \
            + self.position_embeddings(pos)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertModel(Layer):
    """Encoder trunk and tanh pooler (over the first token).
    ``attention_probs_dropout_prob`` None follows
    ``hidden_dropout_prob`` (canonical BERT)."""

    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512,
                 type_vocab_size=2, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.embeddings = BertEmbeddings(
            vocab_size, hidden_size, max_position_embeddings,
            type_vocab_size, hidden_dropout_prob)
        layer = TransformerEncoderLayer(
            hidden_size, num_attention_heads, intermediate_size,
            dropout=hidden_dropout_prob, activation="gelu",
            attn_dropout=attention_probs_dropout_prob,
            normalize_before=False)
        self.encoder = TransformerEncoder(layer, num_hidden_layers)
        self.pooler_dense = Linear(hidden_size, hidden_size)
        self.pooler_act = Tanh()

    def forward(self, input_ids, token_type_ids=None,
                attention_mask=None):
        h = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None:
            # a [b, s] 1/0 mask as an additive [b, 1, 1, s] bias
            am = (1.0 - paddle.cast(attention_mask, "float32")) * -1e4
            attention_mask = am.reshape([am.shape[0], 1, 1, am.shape[1]])
        seq = self.encoder(h, attention_mask)
        pooled = self.pooler_act(self.pooler_dense(seq[:, 0]))
        return seq, pooled


class BertForPretraining(Layer):
    """Masked-LM (transform, then the decoder tied to the word
    embeddings) and next-sentence heads."""

    def __init__(self, bert: BertModel, vocab_size=None):
        super().__init__()
        self.bert = bert
        d = bert.hidden_size
        vocab_size = vocab_size or \
            bert.embeddings.word_embeddings.weight.shape[0]
        self.transform = Linear(d, d)
        self.transform_act = GELU()
        self.transform_norm = LayerNorm(d)
        self.decoder_bias = self.create_parameter([vocab_size],
                                                  is_bias=True)
        self.nsp = Linear(d, 2)

    def forward(self, input_ids, token_type_ids=None,
                attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_norm(self.transform_act(self.transform(seq)))
        w = self.bert.embeddings.word_embeddings.weight
        mlm_logits = paddle.matmul(h, w, transpose_y=True) \
            + self.decoder_bias
        return mlm_logits, self.nsp(pooled)


class BertPretrainingCriterion(Layer):
    """The masked-LM cross entropy over the labelled positions (-100:
    none) plus the next-sentence cross entropy."""

    def forward(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels):
        vocab = mlm_logits.shape[-1]
        flat_logits = mlm_logits.reshape([-1, vocab])
        flat_labels = mlm_labels.reshape([-1])
        mask = paddle.cast(flat_labels != -100, "float32")
        safe = paddle.where(flat_labels == -100,
                            paddle.zeros_like(flat_labels), flat_labels)
        per_tok = F.cross_entropy(flat_logits, safe, reduction="none") \
            .reshape([-1])
        denom = mask.sum().clip(min=1.0)
        mlm_loss = (per_tok * mask).sum() / denom
        nsp_loss = F.cross_entropy(nsp_logits, nsp_labels.reshape([-1]))
        return mlm_loss + nsp_loss


def bert_base(**kw):
    """bert-base-uncased's geometry (110M parameters)."""
    return BertModel(vocab_size=30522, hidden_size=768,
                     num_hidden_layers=12, num_attention_heads=12,
                     intermediate_size=3072, **kw)


def bert_tiny(**kw):
    """A test-sized geometry."""
    cfg = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=64,
               max_position_embeddings=64)
    cfg.update(kw)
    return BertModel(**cfg)
