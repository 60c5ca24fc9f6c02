"""MultiHeadAttention operator.

The PyTorch counterpart of flexflow_tpu/ops/attention.py (reference:
src/ops/attention.cc). Inputs are (batch, seq, embed); the weights keep the
JAX package's names and layouts: wq/wk/wv (embed, heads, head_dim), wo
(heads, v_head_dim, embed), bias_o (embed,).

`_forward` takes the folded fast path into the flash kernels
(kernels/attention.py: the forward kernel, and in training the backward
kernel through its autograd Function) whenever the tensors are on CUDA,
in any compute dtype; the kernels raise on a shape they do not take. On
the CPU it takes the dense masked path. FF_ATTENTION_IMPL picks the path
as in the JAX package: "auto" (unset: flash on CUDA, dense on the CPU),
"flash" (the folded path on any device; on the CPU its wrappers run the
kernels' plain versions) or "dense" (the masked reference path, on any
device); "chunked", "ring" and "ulysses" are not ported and raise.
Dropout is not ported yet: where the JAX package would apply it
(dropout > 0, training, an rng given) `_forward` raises; serving with
dropout > 0 runs as in inference, as in JAX.

`_forward_decode` is the serving step (executor.build_decode): it appends
this block's K/V to the op's cache IN PLACE (the cache is the op's own
buffer, so no per-step copy of it is made) and attends the block's
queries against the prefix. FF_DECODE_IMPL picks the single-token path:
"paged" (the paged flash-decode kernel, kernels/decode.py), "dense" (the
per-row masked reference path) or "auto" (paged when the tensors are on
CUDA). Multi-token blocks (prefill) always take the dense path.
"""
from __future__ import annotations

import dataclasses
import math
import os
import warnings

import torch

from ..ff_types import OperatorType
from .registry import WeightSpec, register_op


@dataclasses.dataclass(frozen=True)
class MultiHeadAttentionParams:
    """reference: include/flexflow/ops/attention_params.h"""

    embed_dim: int
    num_heads: int
    kdim: int = 0  # 0 = embed_dim // num_heads (per-head projection size)
    vdim: int = 0
    dropout: float = 0.0
    bias: bool = True
    add_bias_kv: bool = False
    add_zero_attn: bool = False
    causal: bool = False

    @property
    def qk_head_dim(self):
        return self.kdim or self.embed_dim // self.num_heads

    @property
    def v_head_dim(self):
        return self.vdim or self.embed_dim // self.num_heads

    @property
    def head_dim(self):
        return self.qk_head_dim


def _infer(params: MultiHeadAttentionParams, in_shapes, in_dtypes):
    q, k, v = in_shapes
    return [(q[0], q[1], params.embed_dim)], [in_dtypes[0]]


def _weights(params: MultiHeadAttentionParams, in_shapes, in_dtypes):
    q, k, v = in_shapes
    h = params.num_heads
    dqk, dv = params.qk_head_dim, params.v_head_dim
    dt = in_dtypes[0]
    ws = [
        WeightSpec("wq", (q[-1], h, dqk), dt, "glorot_uniform", ("", "head", "")),
        WeightSpec("wk", (k[-1], h, dqk), dt, "glorot_uniform", ("", "head", "")),
        WeightSpec("wv", (v[-1], h, dv), dt, "glorot_uniform", ("", "head", "")),
        WeightSpec("wo", (h, dv, params.embed_dim), dt, "glorot_uniform",
                   ("head", "", "")),
    ]
    if params.bias:
        ws.append(WeightSpec("bias_o", (params.embed_dim,), dt, "zero"))
    return ws


def _cast_inputs(inputs, weights, cdt):
    xs = list(inputs)
    ws = [weights[n] for n in ("wq", "wk", "wv", "wo")]
    if cdt is not None:
        xs = [x.to(cdt) for x in xs]
        ws = [w.to(cdt) for w in ws]
    return xs, ws


def _project_out(params, weights, spec, attn, wo, dtype):
    """Attention rows -> (b, s, embed) by einsum `spec`, plus the output
    bias."""
    out = torch.einsum(spec, attn, wo).to(dtype)
    if params.bias:
        out = out + weights["bias_o"].to(out.dtype)
    return out


def _dense_attention(q, k, v, keep):
    """Masked softmax attention on (b, s, h, d) operands: scores in f32,
    masked with the f32 minimum where `keep` is False, probs in q's dtype
    (the JAX package's dense path). `keep` broadcasts to (b, h, s, t)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if keep is not None:
        scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs.float(),
                        v.float()).to(q.dtype)


def _attention_impl() -> str:
    impl = os.environ.get("FF_ATTENTION_IMPL", "auto")
    if impl not in ("auto", "dense", "flash", "chunked", "ring", "ulysses"):
        raise ValueError(
            f"FF_ATTENTION_IMPL={impl!r}: "
            "expected auto|dense|flash|chunked|ring|ulysses")
    if impl in ("chunked", "ring", "ulysses"):
        raise NotImplementedError(
            f"FF_ATTENTION_IMPL={impl}: not ported to flexflow_tpu_torch "
            "yet (auto, flash and dense are)")
    return impl


def _forward(params: MultiHeadAttentionParams, weights, inputs, ctx):
    from ..kernels.attention import flash_attention_folded

    if params.dropout > 0.0 and ctx.training and ctx.rng is not None:
        raise NotImplementedError(
            f"MHA dropout {params.dropout} in training: the dropout hash "
            "(_mix32/_keep_bits/_keep_tile) is not ported to "
            "flexflow_tpu_torch yet; set dropout=0")
    impl = _attention_impl()
    (q_in, k_in, v_in), (wq, wk, wv, wo) = _cast_inputs(
        inputs, weights, ctx.compute_dtype)
    b, seq_len, _ = q_in.shape
    kv_len = k_in.shape[1]
    h = params.num_heads
    dqk, dv = params.qk_head_dim, params.v_head_dim
    if impl == "flash" or (impl == "auto" and q_in.device.type == "cuda"):
        # folded fast path: project straight into (b*h, s, d); the kernels
        # raise on a dtype or shape they do not take
        qf = torch.einsum("bse,ehd->bhsd", q_in, wq).reshape(b * h, seq_len, dqk)
        kf = torch.einsum("bse,ehd->bhsd", k_in, wk).reshape(b * h, kv_len, dqk)
        vf = torch.einsum("bse,ehd->bhsd", v_in, wv).reshape(b * h, kv_len, dv)
        attn = flash_attention_folded(qf.contiguous(), kf.contiguous(),
                                      vf.contiguous(), params.causal)
        return [_project_out(params, weights, "bhsd,hde->bse",
                             attn.view(b, h, seq_len, dv), wo, q_in.dtype)]
    q = torch.einsum("bse,ehd->bshd", q_in, wq)
    k = torch.einsum("bse,ehd->bshd", k_in, wk)
    v = torch.einsum("bse,ehd->bshd", v_in, wv)
    keep = None
    if params.causal:
        keep = torch.ones(seq_len, kv_len, dtype=torch.bool,
                          device=q.device).tril()
    attn = _dense_attention(q, k, v, keep)
    return [_project_out(params, weights, "bshd,hde->bse", attn, wo,
                         q_in.dtype)]


_PAGED_BLOCK_WARNED: set = set()


def _decode_impl() -> str:
    impl = os.environ.get("FF_DECODE_IMPL", "auto")
    if impl not in ("auto", "dense", "paged"):
        raise ValueError(
            f"FF_DECODE_IMPL={impl!r}: expected one of auto|dense|paged")
    return impl


def _forward_decode(params, weights, inputs, ctx, cache, t):
    """Incremental decode step with a KV cache. Inputs are the NEW
    positions' slices (b, s0, e) starting at position t; cache holds (k, v)
    of shape (b, max_len, h, d) with positions < t valid. `t` is an int
    (every row at the same position) or a (b,) int tensor of per-row
    positions (continuous batching). Returns ([out], cache), the cache
    updated in place."""
    from ..kernels.decode import (decode_page_size, paged_flash_decode,
                                  paged_view_of_cache)

    (q_in, k_in, v_in), (wq, wk, wv, wo) = _cast_inputs(
        inputs, weights, ctx.compute_dtype)
    q = torch.einsum("bse,ehd->bshd", q_in, wq)
    k_new = torch.einsum("bse,ehd->bshd", k_in, wk)
    v_new = torch.einsum("bse,ehd->bshd", v_in, wv)
    k_cache, v_cache = cache
    b, s0 = q.shape[:2]
    per_row_t = isinstance(t, torch.Tensor) and t.dim() == 1
    if per_row_t:
        # row i writes positions t[i] .. t[i] + s0 - 1
        pos = t.to(device=q.device, dtype=torch.long)[:, None] \
            + torch.arange(s0, device=q.device)[None, :]
        rows = torch.arange(b, device=q.device)[:, None].expand(b, s0)
        k_cache[rows, pos] = k_new.to(k_cache.dtype)
        v_cache[rows, pos] = v_new.to(v_cache.dtype)
    else:
        t = int(t)
        k_cache[:, t:t + s0] = k_new.to(k_cache.dtype)
        v_cache[:, t:t + s0] = v_new.to(v_cache.dtype)

    impl = _decode_impl()
    use_paged = s0 == 1 and (impl == "paged"
                             or (impl == "auto" and q.device.type == "cuda"))
    if impl == "paged" and s0 != 1 and ctx.op_name not in _PAGED_BLOCK_WARNED:
        _PAGED_BLOCK_WARNED.add(ctx.op_name)
        warnings.warn(
            f"attention paged decode on {ctx.op_name or 'a MHA op'} "
            "(FF_DECODE_IMPL=paged) falls back to the dense path: the paged "
            "flash-decode kernel attends ONE query token per slot; "
            "multi-token blocks (prefill) keep the dense masked path")
    if use_paged:
        kp, vp, table = paged_view_of_cache(
            k_cache.to(q.dtype), v_cache.to(q.dtype),
            decode_page_size(k_cache.shape[1]))
        if per_row_t:
            lengths = t.to(device=q.device, dtype=torch.int32) + 1
        else:
            lengths = torch.full((b,), t + 1, dtype=torch.int32,
                                 device=q.device)
        attn = paged_flash_decode(q[:, 0].contiguous(), kp, vp, table,
                                  lengths)[:, None]        # (b, 1, h, dv)
    else:
        cache_pos = torch.arange(k_cache.shape[1], device=q.device)
        if per_row_t:
            q_pos = pos                                    # (b, s0)
        else:
            q_pos = (t + torch.arange(s0, device=q.device))[None, :]
        keep = cache_pos[None, None, None, :] <= q_pos[:, None, :, None]
        attn = _dense_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                                keep)
    return [_project_out(params, weights, "bshd,hde->bse", attn, wo,
                         q_in.dtype)], \
        (k_cache, v_cache)


def init_decode_cache(params: MultiHeadAttentionParams, batch: int,
                      max_len: int, dtype, device):
    """Fresh (k, v) cache for one MHA op."""
    h, dqk, dv = params.num_heads, params.qk_head_dim, params.v_head_dim
    return (
        torch.zeros((batch, max_len, h, dqk), dtype=dtype, device=device),
        torch.zeros((batch, max_len, h, dv), dtype=dtype, device=device),
    )


register_op(
    OperatorType.OP_MULTIHEAD_ATTENTION,
    "MultiHeadAttention",
    infer=_infer,
    weights=_weights,
    forward=_forward,
    num_inputs=3,
    forward_decode=_forward_decode,
)
