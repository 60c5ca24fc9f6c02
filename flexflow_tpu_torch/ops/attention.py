"""MultiHeadAttention operator.

The PyTorch counterpart of flexflow_tpu/ops/attention.py (reference:
src/ops/attention.cc). Inputs are (batch, seq, embed); the weights keep the
JAX package's names and layouts: wq/wk/wv (embed, heads, head_dim), wo
(heads, v_head_dim, embed), bias_o (embed,).

`_forward` takes the folded fast path into the flash kernels
(kernels/attention.py: the forward kernel, and in training the backward
kernel through its autograd Function) whenever the tensors are on CUDA,
in any compute dtype; the kernels raise on a shape they do not take. On
the CPU it takes the dense masked path, or, once the f32 scores of the
call would pass STREAMING_SCORE_BYTES, streams through
`chunked_attention` (what the JAX package's one-device dispatch,
`local_attention`, runs off its kernels' device). FF_ATTENTION_IMPL
picks the path as in the JAX package: "auto" (unset: the above), "flash" (the folded path on any device; on the
CPU its wrappers run the kernels' plain versions), "chunked"
(`chunked_attention` on any device) or "dense" (the masked reference
path, on any device); "ring" and "ulysses" need multi-device execution,
which is not ported, and raise.
Attention dropout applies where the JAX package applies it (dropout > 0,
training, an rng given): the folded path hands the rate and
`dropout_seeds(rng)` to the flash kernels, which rebuild the
counter-based keep-mask per tile; the dense path multiplies its
probabilities by the same mask built whole (`attention_dropout_mask`),
so both paths drop the same elements. The chunked path threads no
dropout: where it would run with dropout the op takes the dense path
instead, with the JAX package's one-time warning. Serving never drops.
The seeds are the op's seed-table entry on the device (what a captured train step
reads at replay) or, called with a host int, `dropout_seeds` of it.
Serving reads its compute-dtype weights from the executor's cache
(ops/common.py `WeightCache`) instead of casting them per call.

`_forward_decode` is the serving step (executor.build_decode): it appends
this block's K/V to the op's cache IN PLACE (the cache is the op's own
buffer, so no per-step copy of it is made) and attends the block's
queries against the prefix. FF_DECODE_IMPL picks the single-token path:
"paged" (the paged flash-decode kernel, kernels/decode.py), "dense" (the
per-row masked reference path) or "auto" (paged when the tensors are on
CUDA). Multi-token blocks (prefill) always take the dense path.
Cross-attention decodes against encoder K/V projected once
(`cross_decode_kv`) with plain products (`_forward_decode_cross`), as the
JAX package computes them outside its kernels.
"""
from __future__ import annotations

import dataclasses
import math
import os
import warnings

import torch

from ..ff_types import OperatorType
from .common import cast_weight
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


def _cast_inputs(inputs, weights, ctx):
    """Inputs and projection weights in the compute dtype; the weights
    from serving's cache where the context carries one."""
    cdt = ctx.compute_dtype
    xs = list(inputs)
    if cdt is not None:
        xs = [x.to(cdt) for x in xs]
    return xs, [cast_weight(ctx, weights[n], cdt)
                for n in ("wq", "wk", "wv", "wo")]


def _project_out(params, weights, spec, attn, wo, dtype, ctx):
    """Attention rows -> (b, s, embed) by einsum `spec`, plus the output
    bias."""
    out = torch.einsum(spec, attn, wo).to(dtype)
    if params.bias:
        out = out + cast_weight(ctx, weights["bias_o"], out.dtype)
    return out


def _dense_attention(q, k, v, keep, dropout: float = 0.0, seeds=None):
    """Masked softmax attention on (b, s, h, d) operands: scores in f32,
    masked with the f32 minimum where `keep` is False, probs in q's dtype
    (the JAX package's dense path). `keep` broadcasts to (b, h, s, t).
    `dropout` > 0 zeroes the probs that `attention_dropout_mask(seeds)`
    drops and scales the rest by 1/(1 - dropout)."""
    from ..kernels.attention import attention_dropout_mask

    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if keep is not None:
        scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout > 0.0:
        b, h, s, t = probs.shape
        drop_keep = attention_dropout_mask(seeds, dropout, b * h, s, t,
                                           device=probs.device)
        probs = torch.where(drop_keep.view(b, h, s, t),
                            probs * (1.0 / (1.0 - dropout)), 0.0
                            ).to(probs.dtype)
    return torch.einsum("bhst,bthd->bshd", probs.float(),
                        v.float()).to(q.dtype)


# "auto" streams off the card once one call's f32 scores (4*b*h*s*t
# bytes) would pass this (the JAX package's per-device budget)
STREAMING_SCORE_BYTES = 256 * 1024 * 1024

_FALLBACK_WARNED: set = set()
_FALLBACK_DETAIL = {
    "kernel": "FF_ATTENTION_IMPL={impl} does not thread the dropout rng "
              "(only the flash kernels do)",
    "backend": "the flash kernels need a CUDA device, and off the card "
               "the streaming path (chunked) threads no dropout rng",
}


def _dropout_fallback(impl: str, op_name: str, reason: str) -> None:
    """Warn once per (impl, op, reason) that attention dropout keeps the
    dense path where `impl` would have streamed."""
    key = (impl, op_name, reason)
    if key in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(key)
    warnings.warn(
        f"attention dropout on {op_name or 'a MHA op'} "
        f"(FF_ATTENTION_IMPL={impl}) falls back to the dense path: "
        + _FALLBACK_DETAIL[reason].format(impl=impl))


def _attention_impl() -> str:
    impl = os.environ.get("FF_ATTENTION_IMPL", "auto")
    if impl not in ("auto", "dense", "flash", "chunked", "ring", "ulysses"):
        raise ValueError(
            f"FF_ATTENTION_IMPL={impl!r}: "
            "expected auto|dense|flash|chunked|ring|ulysses")
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"FF_ATTENTION_IMPL={impl}: sequence parallelism needs "
            "multi-device execution, which is not ported to "
            "flexflow_tpu_torch yet (auto, flash, chunked and dense are)")
    return impl


def _forward(params: MultiHeadAttentionParams, weights, inputs, ctx):
    from ..kernels import attention as katt

    impl = _attention_impl()
    use_dropout = params.dropout > 0.0 and ctx.training and ctx.rng is not None
    # a seed-table entry on the device as it is; from a host int, looked
    # up at call time, as the JAX package does, so a test can inject the
    # same seeds into both packages
    seeds = None
    if use_dropout:
        seeds = (ctx.rng if isinstance(ctx.rng, torch.Tensor)
                 else katt.dropout_seeds(ctx.rng))
    rate = params.dropout if use_dropout else 0.0
    (q_in, k_in, v_in), (wq, wk, wv, wo) = _cast_inputs(
        inputs, weights, ctx)
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
        attn = katt.flash_attention_folded(
            qf.contiguous(), kf.contiguous(), vf.contiguous(), params.causal,
            dropout=rate, seeds=seeds)
        return [_project_out(params, weights, "bhsd,hde->bse",
                             attn.view(b, h, seq_len, dv), wo, q_in.dtype, ctx)]
    score_bytes = 4 * b * h * seq_len * kv_len
    streaming = impl == "chunked" or (
        impl == "auto" and score_bytes > STREAMING_SCORE_BYTES)
    if streaming and use_dropout:
        _dropout_fallback(impl, ctx.op_name,
                          "kernel" if impl == "chunked" else "backend")
        streaming = False
    q = torch.einsum("bse,ehd->bshd", q_in, wq)
    k = torch.einsum("bse,ehd->bshd", k_in, wk)
    v = torch.einsum("bse,ehd->bshd", v_in, wv)
    if streaming:
        # O(seq) memory: chunked on request, or "auto" off the card
        attn = katt.chunked_attention(q, k, v, causal=params.causal)
    else:
        keep = None
        if params.causal:
            keep = torch.ones(seq_len, kv_len, dtype=torch.bool,
                              device=q.device).tril()
        attn = _dense_attention(q, k, v, keep, rate, seeds)
    return [_project_out(params, weights, "bshd,hde->bse", attn, wo,
                         q_in.dtype, ctx)]


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
        inputs, weights, ctx)
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
                         q_in.dtype, ctx)], \
        (k_cache, v_cache)


def cross_decode_kv(params: MultiHeadAttentionParams, weights, k_in, v_in,
                    ctx):
    """The FULL encoder-side K/V of a cross-attention op, for decode
    (executor.build_decode's init): k_in/v_in are the static encoder
    outputs (b, s_enc, e). Computed once per sequence; each decode step
    then attends its queries against them without projecting again."""
    cdt = ctx.compute_dtype
    if cdt is not None:
        k_in, v_in = k_in.to(cdt), v_in.to(cdt)
    wk = cast_weight(ctx, weights["wk"], cdt)
    wv = cast_weight(ctx, weights["wv"], cdt)
    k = torch.einsum("bse,ehd->bshd", k_in, wk).to(k_in.dtype)
    v = torch.einsum("bse,ehd->bshd", v_in, wv).to(k_in.dtype)
    return (k, v)


def _forward_decode_cross(params, weights, q_in, ctx, kv):
    """Cross-attention decode step: project this block's queries and
    attend over the precomputed full encoder K/V (cross_decode_kv). No
    causal mask: every decoder position sees the whole encoder sequence,
    as in the full forward. Plain products, as the JAX package computes
    them outside its kernels."""
    cdt = ctx.compute_dtype
    if cdt is not None:
        q_in = q_in.to(cdt)
    wq = cast_weight(ctx, weights["wq"], cdt)
    wo = cast_weight(ctx, weights["wo"], cdt)
    q = torch.einsum("bse,ehd->bshd", q_in, wq).to(q_in.dtype)
    k, v = kv
    attn = _dense_attention(q, k.to(q.dtype), v.to(q.dtype), None)
    return [_project_out(params, weights, "bshd,hde->bse", attn, wo,
                         q_in.dtype, ctx)]


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
    draws=lambda p: p.dropout > 0.0,
)
