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
(`chunked_attention` on any device), "dense" (the masked reference
path, on any device), "ring" or "ulysses" (sequence parallelism over a
mesh's "seq" axis, below; without one they warn with JAX's "sp_mesh"
reason and stream as JAX's `local_attention` does: the flash kernels on
the card, `chunked_attention` off it).

On a device mesh (the mesh executor, parallel/mesh.py; the JAX
package's `_forward` on a mesh) q, k and v are DTensors of the global
(b, s, h, d) arrays. Where the flash kernels would run (FF_ATTENTION_IMPL
"flash", or "auto" on a card) and the batch divides the data axis, the
heads the model axis, with no seq or expert axis, they run per shard:
`local_map` around the folded kernels, on the one-device path's (b, h,
s, d) projections with the batch over "data" (and over "fsdp" with it
where it divides both, as the activations are sharded; JAX's spec names
"data" alone) and the heads over "model" (the placements of JAX's
P("data", None, "model", None) on (b, s, h, d)), so the backward kernel
runs per shard too
(`MESH_PATHS["local_map"]`). Where those dims do not divide, chunked
attention runs instead, as in JAX, on local shards too (its running
buffers are plain tensors DTensor cannot propagate): the batch over
"data" where it divides, the heads over "model" where they divide, and
the query positions over an axis that divides neither, with K and V
whole over it (`MESH_PATHS["chunked"]` and `"rows_over_<axis>"`; query
rows are independent, so this is exact, and a causal mask takes each
rank's global query offset), so each rank holds and computes 1/(data x
model) of q, the scores and the output, as under JAX's GSPMD. Only
where the positions do not divide either is an axis held whole
(`"replicated_over_<axis>"`). Dropout on a mesh of more than one device
takes the dense path with its mask built over the global shape, as
JAX's `_dropout_fallback(..., "mesh")` does; on a mesh of one device
the flash kernels keep their dropout, as on one device.
Sequence parallelism (a "seq" axis, the JAX package's SP dispatch): where
attention streams on a seq-sharded mesh (always on the card, past the
score budget off it, or on request) and the op is self-attention whose
sequence, batch and heads divide the seq, data and model axes, it runs
per shard through `local_map` on (b, s, h, d) blocks placed (data, seq,
model): `ring_attention` by default or with FF_ATTENTION_IMPL=ring (K
and V rotate round the seq group), `ulysses_attention` with
FF_ATTENTION_IMPL=ulysses where the local heads divide the seq axis (two
all-to-alls; the flash kernels on the whole sequence of h/n heads on the
card). The projections run inside the same per-shard call, so the
sequence stays sharded from the op's input to its output
(`MESH_PATHS["ring"]`, `["ulysses"]`). A requested ring or Ulysses that
cannot run warns once per (impl, op, reason) with JAX's reasons:
"sp_mesh" (no seq axis), "sp_shape" (not self-attention, or a dim does
not divide), "sp_heads" (Ulysses' local heads do not divide the seq
axis); under attention dropout both fall back to the dense path with the
"kernel" reason, as in JAX.
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

import collections
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


def _project_out_local(params, weights, spec, attn, wo, dtype, ctx):
    """`_project_out` of the flash path's (b, h, s, d) rows on a mesh,
    contracted on each rank's local heads through `local_map`: per mesh
    axis, the batch's rows sharded give the output's rows sharded (wo's
    gradient a partial sum), the heads sharded with wo's give a `Partial`
    output summed where it is read, both whole stay whole. The einsum
    over DTensors would flatten a heads-sharded (b, s, d, h) view, which
    torch 2.11's DTensor refuses; on one device's shards it is the plain
    executor's einsum."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    plan = []  # (out, wo in, attn grad, wo grad) per mesh dim
    for p in spec:
        if p == Shard(0):
            plan.append((p, Replicate(), p, Partial()))
        elif p == Shard(1):
            plan.append((Partial(), Shard(0), p, Shard(0)))
        else:
            plan.append((p, p, p, p))
    out_pl, wo_pl, a_grad, wo_grad = (list(c) for c in zip(*plan))
    out = local_map(lambda a, w: torch.einsum("bhsd,hde->bse", a, w),
                    out_placements=out_pl, in_placements=(list(spec), wo_pl),
                    in_grad_placements=(a_grad, wo_grad),
                    device_mesh=attn.device_mesh,
                    redistribute_inputs=True)(attn, wo).to(dtype)
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
    from ..parallel.mesh import like

    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if keep is not None:
        scores = scores.masked_fill(like(~keep, scores),
                                    torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout > 0.0:
        b, h, s, t = probs.shape
        drop_keep = attention_dropout_mask(seeds, dropout, b * h, s, t,
                                           device=probs.device)
        probs = torch.where(like(drop_keep.view(b, h, s, t), probs),
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
    "mesh": "on a device mesh the per-shard flash kernels and chunked "
            "attention thread no dropout rng",
    # the sequence-parallel (ring/ulysses) fallbacks: the requested SP
    # path cannot run, so the op attends without it
    "sp_mesh": "FF_ATTENTION_IMPL={impl} needs a seq-sharded mesh "
               "(sequence_parallel_degree > 1)",
    "sp_shape": "ring/ulysses need self-attention with batch, heads and "
                "seq divisible by their mesh degrees",
    "sp_heads": "ulysses needs the per-device head count divisible by the "
                "seq axis (heads scatter over it)",
}
_SP_REASONS = ("sp_mesh", "sp_shape", "sp_heads")


def reset_attention_fallback_warnings() -> None:
    """Forget which (impl, layer, reason) fallbacks already warned
    (tests; a fresh process starts empty)."""
    _FALLBACK_WARNED.clear()
# the mesh dispatch's routes, counted per call (tests and chip_smoke.py
# read them): "local_map" (the flash kernels per shard), "ring" and
# "ulysses" (sequence parallelism per shard), "chunked" (and
# "rows_over_data"/"rows_over_model" where the batch or the heads do not
# divide that axis and the query positions shard over it instead,
# "replicated_over_<axis>" where the positions do not divide it either),
# "dense"
MESH_PATHS: collections.Counter = collections.Counter()
# {op name: the shape of this rank's q in its last per-shard call on a
# mesh: (b, h, s, d) on the flash path, (b, s, h, d) chunked} (the tests
# read it)
MESH_LOCAL_Q: dict = {}


def _dropout_fallback(impl: str, op_name: str, reason: str) -> None:
    """Count every fallback (`ff_attention_fallback_total{reason}`, a
    no-op without a telemetry session) and warn once per (impl, op,
    reason): attention dropout keeping the dense path where `impl` would
    have streamed, or a requested ring/ulysses that cannot run (the JAX
    package's `_dropout_fallback`)."""
    from .. import obs

    obs.count("ff_attention_fallback_total",
              help="attention ops that fell back to the dense path",
              reason=reason)
    key = (impl, op_name, reason)
    if key in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(key)
    kind = "sequence parallelism" if reason in _SP_REASONS else "dropout"
    warnings.warn(
        f"attention {kind} on {op_name or 'a MHA op'} "
        f"(FF_ATTENTION_IMPL={impl}) falls back to the dense path: "
        + _FALLBACK_DETAIL[reason].format(impl=impl))


def _attention_impl() -> str:
    impl = os.environ.get("FF_ATTENTION_IMPL", "auto")
    if impl not in ("auto", "dense", "flash", "chunked", "ring", "ulysses"):
        raise ValueError(
            f"FF_ATTENTION_IMPL={impl!r}: "
            "expected auto|dense|flash|chunked|ring|ulysses")
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
    if ctx.mesh is not None:
        return _forward_mesh(params, weights, ctx, impl, use_dropout, rate,
                             seeds, q_in, k_in, v_in, wq, wk, wv, wo)
    sp = impl in ("ring", "ulysses")
    if sp and use_dropout:
        _dropout_fallback(impl, ctx.op_name, "kernel")
    elif sp:
        # no seq axis: JAX's local_attention streams instead (the flash
        # kernels on the card, chunked off it)
        _dropout_fallback(impl, ctx.op_name, "sp_mesh")
    on_card = q_in.device.type == "cuda"
    if impl == "flash" or (impl == "auto" and on_card) or (
            sp and not use_dropout and on_card):
        # folded fast path: project straight into (b*h, s, d); the kernels
        # raise on a dtype or shape they do not take
        qf = torch.einsum("bse,ehd->bhsd", q_in, wq).reshape(b * h, seq_len, dqk)
        kf = torch.einsum("bse,ehd->bhsd", k_in, wk).reshape(b * h, kv_len, dqk)
        vf = torch.einsum("bse,ehd->bhsd", v_in, wv).reshape(b * h, kv_len, dv)
        attn = katt.flash_attention_folded(
            qf.contiguous(), kf.contiguous(), vf.contiguous(), params.causal,
            dropout=rate, seeds=seeds,
            bwd_range=f"{ctx.op_name}.bwd" if ctx.profile_ranges else None)
        return [_project_out(params, weights, "bhsd,hde->bse",
                             attn.view(b, h, seq_len, dv), wo, q_in.dtype, ctx)]
    score_bytes = 4 * b * h * seq_len * kv_len
    streaming = impl == "chunked" or (sp and not use_dropout) or (
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


def _batch_axes(mesh, b: int) -> tuple:
    """The mesh axes that shard a batch of `b` rows in the attention op:
    "data" where it divides, and "fsdp" with it where it divides both."""
    data, fsdp = mesh.shape.get("data", 1), mesh.shape.get("fsdp", 1)
    if b % data:
        return ()
    return ("data", "fsdp") if fsdp > 1 and b % (data * fsdp) == 0 \
        else ("data",)


def _mesh_placements(mesh, by_axis) -> list:
    """Placements over `mesh`'s live axes: Shard(dim) for the axes of
    size > 1 named in `by_axis` ({axis: dim}), Replicate() for the rest
    (a size-1 axis shards nothing, and a Shard over it would only turn
    the weights' gradients Partial)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(by_axis[a]) if a in by_axis and mesh.shape[a] > 1
            else Replicate() for a in mesh.live_axes]


def _forward_mesh(params, weights, ctx, impl, use_dropout, rate, seeds,
                  q_in, k_in, v_in, wq, wk, wv, wo):
    """The MHA forward on a device mesh (the JAX package's `_forward` on a
    mesh): ring or Ulysses attention per shard on a seq-sharded mesh
    (`_sp_mesh`), the flash kernels per shard through `local_map` where
    batch and heads divide the data and model axes, chunked attention
    where they do not (`_chunked_mesh`: the query positions sharded over
    an axis that divides neither), dense with a global dropout mask
    under dropout on a mesh of more than one device. On a mesh of one
    device every shard is the whole array, so the flash kernels keep
    their dropout, as they do on one device."""
    from torch.distributed.tensor.experimental import local_map

    from ..kernels import attention as katt

    mesh = ctx.mesh
    shape = mesh.shape
    data, model = shape.get("data", 1), shape.get("model", 1)
    seq, expert = shape.get("seq", 1), shape.get("expert", 1)
    b, seq_len, _ = q_in.shape
    kv_len = k_in.shape[1]
    h = params.num_heads
    # the batch's axes: "data", and "fsdp" with it where the batch divides
    # both, as the activations shard it (the ZeRO batch rule; JAX's spec
    # names "data" alone, so its fsdp ranks attend the same rows)
    batch_axes = _batch_axes(mesh, b)
    batch_ways = 1
    for a in batch_axes:
        batch_ways *= shape[a]
    # the axes that shard this op (JAX's degree product; pipe does not
    # divide it)
    mesh_nontrivial = batch_ways * model * seq * expert > 1
    flash_shardable = (seq == 1 and expert == 1 and b % data == 0
                       and h % model == 0)
    on_card = q_in.device.type == "cuda"
    sp_impl = impl in ("ring", "ulysses")
    # only the axes that shard the scores divide the per-device footprint
    score_bytes = 4 * b * h * seq_len * kv_len // max(
        1, batch_ways * model * seq)
    # a ring/ulysses request that cannot run streams as JAX's
    # local_attention does: the flash kernels per shard on the card
    want_flash = impl == "flash" or ((impl == "auto" or sp_impl) and on_card
                                     and flash_shardable)
    # on the card "auto" streams on a seq-sharded mesh too: through the
    # ring below (JAX's prefer_flash with seq_degree > 1)
    streaming = want_flash or impl == "chunked" or sp_impl or (
        impl == "auto" and (score_bytes > STREAMING_SCORE_BYTES
                            or (on_card and seq > 1)))
    # the flash kernels hash the dropout mask over each call's folded
    # (b*h, s, t) index, which is the global one only where a shard is
    # the whole array
    flash_dropout = want_flash and flash_shardable and not mesh_nontrivial
    if use_dropout and streaming and not flash_dropout:
        _dropout_fallback(impl, ctx.op_name,
                          "kernel" if impl in ("chunked", "ring", "ulysses")
                          else "mesh" if mesh_nontrivial else "backend")
        streaming = want_flash = False
    # sequence parallelism (JAX's sp_shardable rule): ring by default,
    # ulysses on request where the local heads divide the seq axis
    sp_shardable = (seq > 1 and streaming and kv_len == seq_len
                    and seq_len % seq == 0 and b % data == 0
                    and h % model == 0)
    use_ulysses = (sp_shardable and impl == "ulysses"
                   and (h // model) % seq == 0)
    use_ring = sp_shardable and impl in ("auto", "ring")
    if sp_impl and not (use_ring or use_ulysses) and not use_dropout:
        _dropout_fallback(impl, ctx.op_name,
                          "sp_mesh" if seq <= 1 else
                          "sp_heads" if impl == "ulysses" and sp_shardable
                          else "sp_shape")
    if use_ring or use_ulysses:
        return [_sp_mesh(params, weights, ctx, use_ulysses, batch_axes,
                         q_in, k_in, v_in, wq, wk, wv, wo)]
    dm = mesh.device_mesh
    if want_flash and flash_shardable:
        # the one-device folded path's projections, per shard: (b, h, s,
        # d) with the batch over its axes and the heads over "model"
        # (JAX's P("data", None, "model", None) on (b, s, h, d))
        spec = _mesh_placements(mesh, dict({a: 0 for a in batch_axes},
                                           model=1))
        bwd_range = f"{ctx.op_name}.bwd" if ctx.profile_ranges else None
        name = ctx.op_name

        def per_shard(ql, kl, vl):
            MESH_LOCAL_Q[name] = tuple(ql.shape)
            bl, hl = ql.shape[:2]
            fold = [x.reshape(bl * hl, x.shape[2], x.shape[3]).contiguous()
                    for x in (ql, kl, vl)]
            o = katt.flash_attention_folded(*fold, params.causal,
                                            dropout=rate, seeds=seeds,
                                            bwd_range=bwd_range)
            return o.view(bl, hl, ql.shape[2], -1)

        qf, kf, vf = (torch.einsum("bse,ehd->bhsd", x, w) for x, w in
                      ((q_in, wq), (k_in, wk), (v_in, wv)))
        MESH_PATHS["local_map"] += 1
        attn = local_map(per_shard, out_placements=spec,
                         in_placements=(spec, spec, spec), device_mesh=dm,
                         redistribute_inputs=True)(qf, kf, vf)
        return [_project_out_local(params, weights, spec, attn, wo,
                                   q_in.dtype, ctx)]
    q = torch.einsum("bse,ehd->bshd", q_in, wq)
    k = torch.einsum("bse,ehd->bshd", k_in, wk)
    v = torch.einsum("bse,ehd->bshd", v_in, wv)
    if streaming:
        if impl == "flash":
            warnings.warn(
                "FF_ATTENTION_IMPL=flash ignored: batch/heads don't divide "
                "the data/model mesh axes (or the seq axis is sharded) — "
                "using chunked attention")
        attn = _chunked_mesh(params, ctx, q, k, v, b, h, seq_len)
    else:
        keep = None
        if params.causal:
            keep = torch.ones(seq_len, kv_len, dtype=torch.bool,
                              device=q_in.device).tril()
        MESH_PATHS["dense"] += 1
        attn = _dense_attention(q, k, v, keep, rate, seeds)
    return [_project_out(params, weights, "bshd,hde->bse", attn, wo,
                         q_in.dtype, ctx)]


def _sp_mesh(params, weights, ctx, use_ulysses, batch_axes, q_in, k_in,
             v_in, wq, wk, wv, wo):
    """Sequence-parallel attention per shard (JAX's shard_map of
    `ring_attention` / `ulysses_attention` over P("data", "seq", "model",
    None)): one `local_map` over the op's inputs (b, s, e) with the batch
    over its axes and the sequence over "seq", and its weights with the
    heads over "model", projects this rank's q, k and v blocks (b/data,
    s/seq, h/model, d), attends them over the seq group and projects
    the rows out, a partial sum over "model" (the output projection
    contracts the heads). The weights' gradients are partial sums over
    the axes that shard the rows, the inputs' over "model"."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..kernels import attention as katt

    mesh = ctx.mesh
    dm = mesh.device_mesh
    x_pl = _mesh_placements(mesh, dict({a: 0 for a in batch_axes}, seq=1))
    on_model = [a == "model" and mesh.shape[a] > 1 for a in mesh.live_axes]
    rows = [isinstance(p, Shard) for p in x_pl]

    def weight(head_dim):
        pl = _mesh_placements(mesh, {"model": head_dim})
        return pl, [Partial() if r else p for r, p in zip(rows, pl)]

    (w_pl, w_grad), (wo_pl, wo_grad) = weight(1), weight(0)
    x_grad = [Partial() if m else p for m, p in zip(on_model, x_pl)]
    group = dm.get_group("seq")
    fn = katt.ulysses_attention if use_ulysses else katt.ring_attention
    name, dtype = ctx.op_name, q_in.dtype

    def per_shard(qi, ki, vi, wq_, wk_, wv_, wo_):
        q, k, v = (torch.einsum("bse,ehd->bshd", x, w) for x, w in
                   ((qi, wq_), (ki, wk_), (vi, wv_)))
        MESH_LOCAL_Q[name] = tuple(q.shape)
        attn = fn(q, k, v, group, causal=params.causal)
        return torch.einsum("bshd,hde->bse", attn, wo_).to(dtype)

    MESH_PATHS["ulysses" if use_ulysses else "ring"] += 1
    out = local_map(
        per_shard, out_placements=x_grad,
        in_placements=(x_pl,) * 3 + (w_pl,) * 3 + (wo_pl,),
        in_grad_placements=(x_grad,) * 3 + (w_grad,) * 3 + (wo_grad,),
        device_mesh=dm, redistribute_inputs=True)(
            q_in, k_in, v_in, wq, wk, wv, wo)
    if params.bias:
        out = out + cast_weight(ctx, weights["bias_o"], out.dtype)
    return out


def _chunked_mesh(params, ctx, q, k, v, b, h, seq_len):
    """Chunked attention on a mesh, on local shards (its running buffers
    are plain tensors DTensor cannot propagate): (b, s, h, d) with the
    batch over its axes (`_batch_axes`) and the heads over "model" where
    they divide. An axis that divides neither shards the query positions
    (s) instead, K and V held whole over it: each rank attends its own
    rows against every key, at its global query offset under a causal
    mask, and the K and V gradients it returns are partial sums over
    that axis; the output rows are gathered back over it for the output
    projection. Where the positions do not divide the axes left, those
    axes hold q whole too (each of their ranks computes their share
    again)."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..kernels import attention as katt

    mesh = ctx.mesh
    by_axis = {a: 0 for a in _batch_axes(mesh, b)}
    rows = [] if by_axis or mesh.shape.get("data", 1) == 1 else ["data"]
    if h % mesh.shape.get("model", 1) == 0:
        by_axis["model"] = 2
    else:
        rows.append("model")
    # the row axes in DeviceMesh order: DTensor splits the positions by
    # the first one, each part by the next
    rows.sort(key=mesh.live_axes.index)
    n_rows = 1
    for a in rows:
        n_rows *= mesh.shape[a]
    MESH_PATHS["chunked"] += 1
    if seq_len % n_rows:
        for a in rows:
            MESH_PATHS[f"replicated_over_{a}"] += 1
        rows = []
    kv_spec = _mesh_placements(mesh, by_axis)
    q_spec = list(kv_spec)
    grad_spec = list(kv_spec)
    offset, part = 0, seq_len
    coord = mesh.device_mesh.get_coordinate()
    for a in rows:
        MESH_PATHS[f"rows_over_{a}"] += 1
        dim = mesh.live_axes.index(a)
        q_spec[dim], grad_spec[dim] = Shard(1), Partial()
        part //= mesh.shape[a]
        offset += coord[dim] * part
    name = ctx.op_name

    def per_shard(ql, kl, vl):
        MESH_LOCAL_Q[name] = tuple(ql.shape)
        return katt.chunked_attention(ql, kl, vl, causal=params.causal,
                                      q_offset=offset)

    attn = local_map(
        per_shard, out_placements=q_spec,
        in_placements=(q_spec, kv_spec, kv_spec),
        in_grad_placements=(q_spec, grad_spec, grad_spec),
        device_mesh=mesh.device_mesh, redistribute_inputs=True)(q, k, v)
    # the rows gathered back for the output projection, whose einsum
    # DTensor cannot run on sharded positions (it folds them into the
    # batch)
    return attn.redistribute(mesh.device_mesh, kv_spec) if rows else attn


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
    updated in place. On a device mesh (DTensor inputs) the step runs per
    shard (`_forward_decode_mesh`)."""
    from ..parallel.mesh import is_dtensor

    (q_in, k_in, v_in), (wq, wk, wv, wo) = _cast_inputs(
        inputs, weights, ctx)
    if ctx.mesh is not None and is_dtensor(q_in):
        return [_forward_decode_mesh(params, weights, ctx, cache, t, q_in,
                                     k_in, v_in, wq, wk, wv, wo)], cache
    q = torch.einsum("bse,ehd->bshd", q_in, wq)
    k_new = torch.einsum("bse,ehd->bshd", k_in, wk)
    v_new = torch.einsum("bse,ehd->bshd", v_in, wv)
    attn = _decode_attend(q, k_new, v_new, cache, t, ctx.op_name)
    return [_project_out(params, weights, "bshd,hde->bse", attn, wo,
                         q_in.dtype, ctx)], cache


def _decode_attend(q, k_new, v_new, cache, t, op_name):
    """Write this block's K/V (b, s0, h, d) into the cache (k, v) (b,
    max_len, h, d) in place at position t (an int, or a (b,) tensor of
    per-row positions), then attend the block's queries q against the
    prefix: the paged-decode kernel for one-token blocks
    (FF_DECODE_IMPL), the dense masked path otherwise. Plain tensors,
    whole or one rank's shard. Returns (b, s0, h, dv)."""
    from ..kernels.decode import (decode_page_size, paged_flash_decode,
                                  paged_view_of_cache)

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
    if impl == "paged" and s0 != 1 and op_name not in _PAGED_BLOCK_WARNED:
        _PAGED_BLOCK_WARNED.add(op_name)
        warnings.warn(
            f"attention paged decode on {op_name or 'a MHA op'} "
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
        return paged_flash_decode(q[:, 0].contiguous(), kp, vp, table,
                                  lengths)[:, None]        # (b, 1, h, dv)
    cache_pos = torch.arange(k_cache.shape[1], device=q.device)
    if per_row_t:
        q_pos = pos                                        # (b, s0)
    else:
        q_pos = (t + torch.arange(s0, device=q.device))[None, :]
    keep = cache_pos[None, None, None, :] <= q_pos[:, None, :, None]
    return _dense_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                            keep)


def decode_cache_placements(mesh, params: MultiHeadAttentionParams,
                            batch: int) -> list:
    """The placements of an MHA op's (b, max_len, h, d) KV cache on
    `mesh` (and of the step's (b, s0, h, d) rows): the slots over the
    batch's axes where the batch divides them (`_batch_axes`), the heads
    over "model" where they divide it; whole over every other axis."""
    by_axis = {a: 0 for a in _batch_axes(mesh, batch)}
    if params.num_heads % mesh.shape.get("model", 1) == 0:
        by_axis["model"] = 2
    return _mesh_placements(mesh, by_axis)


def _forward_decode_mesh(params, weights, ctx, cache, t, q_in, k_in, v_in,
                         wq, wk, wv, wo):
    """The decode step on a device mesh, per shard (the JAX package's
    device-local decode under GSPMD): one `local_map` over the block's
    inputs (b, s0, e), with the slots over the batch's axes, and the
    weights with the heads over "model" projects this rank's q, k and v
    (b/data, s0, h/model, d), writes k and v into the rank's strips of
    the cache (DTensors placed by `decode_cache_placements`, so their
    local tensors are written in place and never gathered), attends
    (`_decode_attend`: the paged-decode kernel on the local strips for a
    one-token block on the card), and projects the rows out. The output
    is a partial sum over "model" where the heads shard it (the output
    bias is added on the model axis's first rank alone, so the sum holds
    it once); the executor reduces it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..parallel.mesh import distribute, local

    mesh = ctx.mesh
    dm = mesh.device_mesh
    c_pl = decode_cache_placements(mesh, params, q_in.shape[0])
    if any(tuple(c.placements) != tuple(c_pl) for c in cache):
        raise ValueError(
            f"decode cache of {ctx.op_name} is placed "
            f"{[tuple(c.placements) for c in cache]}, the step wants "
            f"{tuple(c_pl)} (init_decode_cache with the executor's mesh)")
    # the cache's placements say it all, axis by axis: its slots' axes
    # shard the rows, its heads' axis the projections' heads
    rows = [p == Shard(0) for p in c_pl]
    heads = [p == Shard(2) for p in c_pl]

    def placed(dim, where):
        return [Shard(dim) if w else Replicate() for w in where]

    x_pl, w_pl, wo_pl = placed(0, rows), placed(1, heads), placed(0, heads)
    out_pl = [Partial() if h else p for h, p in zip(heads, x_pl)]
    bias_here = not any(heads) or dm.get_coordinate()[heads.index(True)] == 0
    per_row = isinstance(t, torch.Tensor) and t.dim() == 1
    if per_row:
        # this rank's slots' positions: a local slice of the whole vector
        t = distribute(t, mesh, [Shard(0) if isinstance(p, Shard) else p
                                 for p in x_pl])
    bias = (local(cast_weight(ctx, weights["bias_o"], q_in.dtype))
            if params.bias and bias_here else None)
    name, dtype = ctx.op_name, q_in.dtype
    whole_t = None if per_row else t

    def per_shard(qi, ki, vi, wq_, wk_, wv_, wo_, kc, vc, tl):
        q = torch.einsum("bse,ehd->bshd", qi, wq_)
        k_new = torch.einsum("bse,ehd->bshd", ki, wk_)
        v_new = torch.einsum("bse,ehd->bshd", vi, wv_)
        MESH_LOCAL_Q[name] = tuple(q.shape)
        attn = _decode_attend(q, k_new, v_new, (kc, vc),
                              whole_t if tl is None else tl, name)
        out = torch.einsum("bshd,hde->bse", attn, wo_).to(dtype)
        if bias is not None:
            out = out + bias.to(out.dtype)
        return out

    MESH_PATHS["decode_local_map"] += 1
    return local_map(
        per_shard, out_placements=out_pl,
        in_placements=(x_pl,) * 3 + (w_pl,) * 3 + (wo_pl, c_pl, c_pl,
                                                    x_pl if per_row
                                                    else None),
        device_mesh=dm, redistribute_inputs=True)(
            q_in, k_in, v_in, wq, wk, wv, wo, cache[0], cache[1],
            t if per_row else None)


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
                      max_len: int, dtype, device, mesh=None):
    """Fresh (k, v) cache for one MHA op. On a device mesh each is a
    DTensor placed by `decode_cache_placements`: every rank allocates its
    own strips alone (b/data slots, h/model heads), none whole."""
    h, dqk, dv = params.num_heads, params.qk_head_dim, params.v_head_dim
    shapes = ((batch, max_len, h, dqk), (batch, max_len, h, dv))
    if mesh is None:
        return tuple(torch.zeros(s, dtype=dtype, device=device)
                     for s in shapes)
    from torch.distributed.tensor import DTensor, Shard

    pl = decode_cache_placements(mesh, params, batch)
    out = []
    for shape in shapes:
        loc = list(shape)
        for axis, p in zip(mesh.live_axes, pl):
            if isinstance(p, Shard):
                loc[p.dim] //= mesh.shape[axis]
        out.append(DTensor.from_local(
            torch.zeros(loc, dtype=dtype, device=device), mesh.device_mesh,
            pl, run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride()))
    return tuple(out)


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
