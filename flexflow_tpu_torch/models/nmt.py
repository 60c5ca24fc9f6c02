"""NMT seq2seq model: embeddings, stacked LSTM encoder and decoder, and a
vocabulary projection.

The PyTorch counterpart of flexflow_tpu/models/nmt.py (reference: the
standalone NMT example, nmt/nmt.cc), built on the framework's ops.
"""
from __future__ import annotations

from ..core.model import FFModel
from ..ff_types import AggrMode, DataType


def build_nmt(model: FFModel, batch_size: int, src_vocab: int = 32000,
              tgt_vocab: int = 32000, src_len: int = 32, tgt_len: int = 32,
              embed_dim: int = 256, hidden: int = 512, num_layers: int = 2):
    """reference: nmt.cc top_level_task. The encoder's LSTM stack runs
    over the source embeddings and one more LSTM sums it up in its last
    state; the decoder's stack runs over the target embeddings (teacher
    forcing), each position's state plus the encoder summary (a (b, 1, h)
    broadcast add), then the vocabulary projection and a softmax. Returns
    ([src, tgt], probabilities)."""
    src = model.create_tensor((batch_size, src_len), DataType.DT_INT32,
                              name="src")
    tgt = model.create_tensor((batch_size, tgt_len), DataType.DT_INT32,
                              name="tgt")
    enc = model.embedding(src, src_vocab, embed_dim, AggrMode.AGGR_MODE_NONE)
    for _ in range(num_layers):
        enc = model.lstm(enc, hidden, return_sequences=True)
    enc_last = model.lstm(enc, hidden, return_sequences=False)  # (b, h)
    dec = model.embedding(tgt, tgt_vocab, embed_dim, AggrMode.AGGR_MODE_NONE)
    for _ in range(num_layers):
        dec = model.lstm(dec, hidden, return_sequences=True)
    enc_cond = model.reshape(enc_last, (batch_size, 1, hidden))
    dec = model.add(dec, enc_cond)
    logits = model.dense(dec, tgt_vocab)
    probs = model.softmax(logits)
    return [src, tgt], probs
