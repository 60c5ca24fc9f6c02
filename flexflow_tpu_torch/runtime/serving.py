"""Generation APIs and continuous batching over compiled models.

The PyTorch counterpart of flexflow_tpu/runtime/serving.py, serving slice:

  * `incremental_generate` -- KV-cache greedy decoding of a causal
    decoder (static inputs too): one-shot prefill, then one position per
    step (executor.build_decode);
  * `greedy_generate` and `incremental_seq2seq_generate` -- greedy
    seq2seq decoding of an encoder-decoder model, by the full forward per
    token or by the KV-cache step (the encoder once), over one loop;
  * `beam_generate` and `incremental_beam_generate` -- beam search (sums
    of log-probs) by the full forward or by the KV-cache step, the
    per-beam caches gathered in place on a reorder;
  * `ContinuousBatcher` -- an iteration-level scheduler (Orca-style) over a
    running batch of `slots` sequences, each at its own position. Every
    iteration it retires finished slots and releases their KV pages,
    admits queued requests (batch-1 prefill padded to a power-of-two
    bucket, the prefilled cache strip spliced into the running batch) and
    runs ONE batched decode step with a per-slot position vector, built
    from the decode-searched executor (FFModel.compile_decode) when the
    model has one that splices with the prefill build.

Every one-token step passes per-row positions, so on a card it replays
the decode step's captured graph; `_eager=True` runs the steps eagerly.

On a process group (one process per device, the model compiled over a
mesh) the APIs run SPMD: every rank calls them with the same prompts
(checked: a mismatch raises on every rank), the steps run at the
executor's degrees, and the logits come back whole on every rank, so
every rank picks the same tokens and beams. The batcher runs in lockstep:
rank 0's queue alone takes requests, and every iteration rank 0
broadcasts its decisions (the admissions, the expired slots, the stop;
one integer when there are none) before every rank runs the same prefill, slot insertion and decode step
(`ContinuousBatcher`).

Not ported yet: fault injection, the health monitor, SLO tracking, decode
re-search, the prefix-sharing page pool and prefill-skip memo, fleet
spools, ReplicaSet and BatchScheduler.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
import uuid
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..parallel.executor import _tensors
from ..parallel.mesh import full, is_dtensor, local
from . import distributed as rdist
from .kvcache import KVCacheConfig, KVCacheExhaustedError, PagePool

_IDLE_WAIT_S = 0.005  # serving-loop poll interval with no active slot


class NotCompiledError(RuntimeError):
    """A serving API was called on a model that was never compiled."""


class ServingConfigError(ValueError):
    """A serving request or configuration the runtime cannot honour."""


class RequestShedError(RuntimeError):
    """A request the runtime refused or abandoned; `reason` says why."""

    def __init__(self, msg: str, *, reason: Optional[str] = None):
        super().__init__(msg)
        self.reason = reason


class DeadlineExceededError(RequestShedError):
    def __init__(self, msg: str, *, stage: str = "queue"):
        super().__init__(msg, reason="deadline")
        self.stage = stage


class QueueFullError(RequestShedError):
    def __init__(self, msg: str):
        super().__init__(msg, reason="queue_full")


def _argmax_last(logits: torch.Tensor) -> np.ndarray:
    """Greedy choice over the vocab axis, on the device; ties go to the
    first index, as numpy's argmax does."""
    return logits.argmax(dim=-1).cpu().numpy()


def _host_rows(logits: torch.Tensor) -> np.ndarray:
    """Output rows on the host in float32 (numpy has no bfloat16)."""
    return logits.float().cpu().numpy()


def _assert_same_call(api: str, *arrays, **kw) -> None:
    """The SPMD contract of the generation APIs on a process group: every
    rank calls `api` with the same prompts and arguments (a digest of
    each compared with one all-gather; a mismatch raises on every rank,
    where it would otherwise hang or desynchronize a collective, as fit's
    `_assert_same_global_batch` guards its batches). A no-op without a
    group."""
    if rdist.process_count() <= 1:
        return
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.shape}{a.dtype}".encode())
        h.update(a.tobytes())
    rdist.assert_same(
        (api, h.hexdigest(), repr(sorted(kw.items()))),
        f"multi-process contract violated: every rank must call {api} "
        "with the same prompts and arguments (runtime/serving.py)")


def _check_encoder_ids(encoder_ids, enc_t) -> None:
    if tuple(np.shape(encoder_ids)) != tuple(enc_t.dims):
        raise ServingConfigError(
            f"encoder_ids shape {tuple(np.shape(encoder_ids))} != compiled "
            f"input shape {tuple(enc_t.dims)}")


def greedy_generate(model, encoder_ids: np.ndarray, *,
                    max_new_tokens: Optional[int] = None,
                    start_token_id: int = 0,
                    eos_token_id: Optional[int] = None,
                    pad_token_id: int = 0) -> np.ndarray:
    """Greedy autoregressive decode over a compiled encoder-decoder model
    whose two graph inputs are (encoder_ids, decoder_ids) and whose output
    is per-position vocab logits. Re-runs the full forward with the decoder
    prefix grown by one token per step (no KV cache); the causal mask keeps
    the padded tail out of position t's view."""
    if model.executor is None:
        raise NotCompiledError("compile() the model first")
    fwd = model.executor.build_forward()
    enc_t, dec_t = model._fit_input_tensors[:2]
    bs, dec_len = dec_t.dims[0], dec_t.dims[1]
    _check_encoder_ids(encoder_ids, enc_t)
    want = dec_len - 1 if max_new_tokens is None else max_new_tokens
    steps = min(want, dec_len - 1)
    enc = np.asarray(encoder_ids, enc_t.data_type.np_dtype)
    _assert_same_call("greedy_generate", enc, steps=steps,
                      start=start_token_id, eos=eos_token_id,
                      pad=pad_token_id)

    def next_logits(t, dec):
        return fwd(model.params, [enc, dec], model.state.net_state)[:, t]

    return _greedy_decode_loop(
        bs, dec_len, steps, next_logits, dec_t.data_type.np_dtype,
        start_token_id=start_token_id, eos_token_id=eos_token_id,
        pad_token_id=pad_token_id)


def _greedy_decode_loop(bs, dec_len, steps, next_logits, dec_dt, *,
                        start_token_id, eos_token_id, pad_token_id):
    """The shared greedy seq2seq loop: greedy_generate (full forward per
    token) and incremental_seq2seq_generate (KV-cache step per token)
    differ ONLY in how position t's logits are produced. next_logits(t,
    dec) -> (bs, vocab) values for position t given the decoder buffer so
    far."""
    dec = np.full((bs, dec_len), pad_token_id, dec_dt)
    dec[:, 0] = start_token_id
    if steps <= 0:
        return dec[:, :1]
    finished = np.zeros(bs, bool)
    for t in range(steps):
        nxt = _argmax_last(next_logits(t, dec))
        if eos_token_id is not None:
            nxt = np.where(finished, pad_token_id, nxt)
            finished |= nxt == eos_token_id
        dec[:, t + 1] = nxt
        if eos_token_id is not None and finished.all():
            break
    return dec[:, :t + 2]


def incremental_seq2seq_generate(model, encoder_ids: np.ndarray, *,
                                 max_new_tokens: Optional[int] = None,
                                 start_token_id: int = 0,
                                 eos_token_id: Optional[int] = None,
                                 pad_token_id: int = 0,
                                 assume_causal: bool = False,
                                 _eager: bool = False) -> np.ndarray:
    """KV-cache greedy decode for a compiled encoder-decoder model: the
    signature and tokens of greedy_generate, but O(1) a token. The encoder
    runs ONCE (executor.build_decode computes the static subgraph and the
    cross-attention K/V at init), each step feeds one decoder position
    through the liveness-analyzed decoder subgraph (parallel/decode.py).
    The steps pass their position as a per-row vector, so on a card they
    replay the decode step's captured graph (`_eager=True` runs them
    eagerly instead)."""
    if model.executor is None:
        raise NotCompiledError("compile() the model first")
    if len(model._fit_input_tensors) < 2:
        raise ServingConfigError(
            "incremental_seq2seq_generate needs an encoder-decoder model "
            "(two graph inputs); use incremental_generate for decoder-only")
    enc_t, dec_t = model._fit_input_tensors[:2]
    bs, dec_len = dec_t.dims[0], dec_t.dims[1]
    _check_encoder_ids(encoder_ids, enc_t)
    want = dec_len - 1 if max_new_tokens is None else max_new_tokens
    steps = min(want, dec_len - 1)
    _assert_same_call("incremental_seq2seq_generate", encoder_ids,
                      steps=steps, start=start_token_id, eos=eos_token_id,
                      pad=pad_token_id, causal=assume_causal)
    if steps <= 0:
        return np.full((bs, 1), start_token_id, dec_t.data_type.np_dtype)
    init_caches, step = model.executor.build_decode(
        bs, dec_len, assume_causal=assume_causal)
    caches = init_caches(model.params,
                         [np.asarray(encoder_ids, enc_t.data_type.np_dtype)])

    def next_logits(t, dec):
        logits, _ = step(model.params, caches, np.full(bs, t, np.int32),
                         [dec[:, t:t + 1]], _eager=_eager)
        return logits[:, -1]

    return _greedy_decode_loop(
        bs, dec_len, steps, next_logits, dec_t.data_type.np_dtype,
        start_token_id=start_token_id, eos_token_id=eos_token_id,
        pad_token_id=pad_token_id)


def incremental_generate(model, prompt_ids: np.ndarray, *,
                         max_new_tokens: int, max_len: Optional[int] = None,
                         eos_token_id: Optional[int] = None,
                         pad_token_id: int = 0, static_inputs=(),
                         decode_input: Optional[int] = None,
                         assume_causal: bool = False,
                         _eager: bool = False) -> np.ndarray:
    """KV-cache greedy decoding for a causal decoder-only model (token ids
    in, per-position vocab logits out). prompt_ids: (batch, prompt_len)
    ints. Returns (batch, prompt_len + max_new_tokens) including the
    prompt, pad-filled after an EOS. The one-token steps pass their
    position as a per-row vector, so on a card they replay the decode
    step's captured graph (`_eager=True` runs them eagerly instead).

    static_inputs: arrays for any non-decode graph inputs (an explicit
    attention-mask or bias input), passed to init_caches; decode_input
    selects which graph input the prompt drives (default: build_decode's,
    the last); assume_causal vouches for primitive-op attention whose
    causality can't be proven from baked constants (parallel/decode.py)."""
    if model.executor is None:
        raise NotCompiledError("compile() the model first")
    prompt_ids = np.asarray(prompt_ids)
    bs, plen = prompt_ids.shape
    _assert_same_call("incremental_generate", prompt_ids, *static_inputs,
                      new=max_new_tokens, max_len=max_len, eos=eos_token_id,
                      pad=pad_token_id, decode_input=decode_input,
                      causal=assume_causal)
    if max_new_tokens <= 0:
        return prompt_ids.copy()
    total = plen + max_new_tokens
    cap = max_len or total
    if cap < total:
        raise ServingConfigError(f"max_len {cap} < prompt+new {total}")
    init_caches, step = model.executor.build_decode(
        bs, cap, decode_input=decode_input, assume_causal=assume_causal)
    caches = init_caches(model.params, list(static_inputs))
    dec_idx = (decode_input if decode_input is not None
               else len(model._fit_input_tensors) - 1)
    id_dt = model._fit_input_tensors[dec_idx].data_type.np_dtype
    out = np.full((bs, total), pad_token_id, id_dt)
    out[:, :plen] = prompt_ids
    finished = np.zeros(bs, bool)
    # one-shot prefill: the whole prompt in one step, every prompt
    # position's K/V written at once
    logits, caches = step(model.params, caches, 0,
                          [prompt_ids.astype(id_dt)])
    nxt = _argmax_last(logits[:, -1])
    if eos_token_id is not None:
        finished |= nxt == eos_token_id
    out[:, plen] = nxt
    for t in range(plen, total - 1):
        if eos_token_id is not None and finished.all():
            break
        logits, caches = step(model.params, caches,
                              np.full(bs, t, np.int32), [out[:, t:t + 1]],
                              _eager=_eager)
        nxt = _argmax_last(logits[:, 0])
        if eos_token_id is not None:
            nxt = np.where(finished, pad_token_id, nxt)
            finished |= nxt == eos_token_id
        out[:, t + 1] = nxt
    return out


def _reorder_beams(caches, src_beams: np.ndarray) -> None:
    """Per-beam caches follow their beams: the "prefix" and "mha" caches
    are gathered along the batch axis IN PLACE, so a captured decode step
    keeps replaying on the same tensors. "static" and "mha_static"
    (cross-attention encoder K/V) stay as they are: they are
    beam-invariant, and constant-derived statics have leading axis 1."""
    tensors = _tensors({"prefix": caches["prefix"], "mha": caches["mha"]})
    if not tensors or np.array_equal(src_beams, np.arange(len(src_beams))):
        return
    idx = torch.as_tensor(src_beams, dtype=torch.long,
                          device=local(tensors[0]).device)
    with torch.no_grad():
        for c in tensors:
            if _batch_sharded(c):
                # beams spread over ranks: gathered whole, each rank keeps
                # its reordered rows
                from torch.distributed.tensor import distribute_tensor

                moved = distribute_tensor(full(c).index_select(0, idx),
                                          c.device_mesh, c.placements,
                                          src_data_rank=None)
                local(c).copy_(local(moved))
            else:
                loc = local(c)
                loc.copy_(loc.index_select(0, idx))


def _copy_row(dst, slot_idx: int, row) -> None:
    """dst[slot_idx] = row[0], in place: `dst` a batch cache and `row` a
    batch-1 one, each a tensor or a DTensor (on a mesh the prefill's and
    the batch step's caches may be placed by two strategies). A rank
    writes the part of the row that its local tensor of `dst` holds, cut
    from the row whole (gathered, on every rank alike, only where the
    row is sharded)."""
    whole = full(row)[0]
    if not is_dtensor(dst):
        dst[slot_idx].copy_(whole)
        return
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, dst.device_mesh, dst.placements)
    if not offset[0] <= slot_idx < offset[0] + shape[0]:
        return  # another rank's slot
    for d in range(1, len(shape)):
        whole = whole.narrow(d - 1, offset[d], shape[d])
    local(dst)[slot_idx - offset[0]].copy_(whole)


def _batch_sharded(c) -> bool:
    from torch.distributed.tensor import Shard

    return is_dtensor(c) and any(isinstance(p, Shard) and p.dim == 0
                                 for p in c.placements)


def incremental_beam_generate(model, prompt_ids: np.ndarray, *,
                              num_beams: int = 4, max_new_tokens: int,
                              max_len: Optional[int] = None,
                              eos_token_id: Optional[int] = None,
                              pad_token_id: int = 0,
                              encoder_ids: Optional[np.ndarray] = None,
                              static_inputs=(), assume_causal: bool = False,
                              _eager: bool = False) -> np.ndarray:
    """Beam search over the KV-cache decoder: the decode step is built at
    batch=num_beams, each step feeds ONE position per beam, and on a beam
    reorder the per-beam caches are gathered along the batch axis on the
    device, in place. Scores are sums of log-probs (probability and logit
    output heads both handled: _as_log_probs), no length penalty; samples
    decode one after another. The one-token steps pass per-row positions,
    so on a card they replay the captured step (`_eager=True`: eagerly).

    prompt_ids: (n, prompt_len). Returns (n, prompt_len + max_new_tokens)
    top beams. For encoder-decoder models pass encoder_ids (n, enc_len)
    and a prompt of start tokens: each sample's encoder statics and
    cross-attention K/V are computed once at its init."""
    if model.executor is None:
        raise NotCompiledError("compile() the model first")
    prompt_ids = np.asarray(prompt_ids)
    plen = prompt_ids.shape[1]
    _assert_same_call("incremental_beam_generate", prompt_ids,
                      *([] if encoder_ids is None else [encoder_ids]),
                      *static_inputs, beams=num_beams, new=max_new_tokens,
                      max_len=max_len, eos=eos_token_id, pad=pad_token_id,
                      causal=assume_causal)
    if max_new_tokens <= 0:
        return prompt_ids.copy()
    in_t = model._fit_input_tensors[-1]
    total = plen + max_new_tokens
    cap = max_len or total
    if cap < total:
        raise ServingConfigError(f"max_len {cap} < prompt+new {total}")
    init_caches, step = model.executor.build_decode(
        num_beams, cap, assume_causal=assume_causal)
    id_dt = in_t.data_type.np_dtype
    prob_hint = model.output_probability_like()
    if encoder_ids is not None:
        enc_t = model._fit_input_tensors[0]
        enc_rows = np.asarray(encoder_ids, enc_t.data_type.np_dtype)
        if enc_rows.shape[0] != prompt_ids.shape[0]:
            raise ServingConfigError(
                f"encoder_ids rows {enc_rows.shape[0]} != prompt rows "
                f"{prompt_ids.shape[0]}")

    outs = []
    for i, row in enumerate(prompt_ids.astype(id_dt)):
        if encoder_ids is None:
            # static_inputs (if any) must be shaped for batch=num_beams
            caches = init_caches(model.params, list(static_inputs))
        else:
            enc_block = np.broadcast_to(
                enc_rows[i], (num_beams,) + enc_rows[i].shape).copy()
            # static_inputs are the non-decode inputs AFTER the encoder
            # ids (input order), shaped for batch=num_beams
            caches = init_caches(model.params,
                                 [enc_block] + list(static_inputs))
        beams = np.full((num_beams, total), pad_token_id, id_dt)
        beams[:, :plen] = row
        scores = np.full(num_beams, -np.inf)
        scores[0] = 0.0  # beams identical until the first branch
        done = np.zeros(num_beams, bool)
        # prefill: the same prompt in every beam slot, one block step
        block = np.broadcast_to(row, (num_beams, plen)).copy()
        logits, caches = step(model.params, caches, 0, [block])
        logp = _as_log_probs(_host_rows(logits[:, -1]), prob_hint)
        for t in range(plen, total):
            src_beams, toks, scores = _beam_topk(
                scores, logp, done, pad_token_id, num_beams)
            beams = beams[src_beams]
            beams[:, t] = np.where(done[src_beams], pad_token_id, toks)
            if eos_token_id is not None:
                done = done[src_beams] | (beams[:, t] == eos_token_id)
            _reorder_beams(caches, src_beams)
            if (eos_token_id is not None and done.all()) or t == total - 1:
                break
            logits, caches = step(model.params, caches,
                                  np.full(num_beams, t, np.int32),
                                  [beams[:, t:t + 1]], _eager=_eager)
            logp = _as_log_probs(_host_rows(logits[:, 0]), prob_hint)
        outs.append(beams[0])
    return np.stack(outs)


def _log_softmax(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    e = np.exp(x - m)
    return (x - m) - np.log(e.sum(axis=-1, keepdims=True))


def _as_log_probs(x: np.ndarray,
                  probability: Optional[bool] = None) -> np.ndarray:
    """Model outputs may be PROBABILITIES (the framework convention: CE
    models end in softmax/sigmoid) or raw logits. log-softmax of
    probabilities is NOT log(p): it flattens every gap to < 1 nat and
    corrupts beam accumulation. The caller passes the answer from the
    graph's tail op (model.output_probability_like()); the numeric sniff
    (non-negative rows summing to ~1) is only the fallback for the
    undetermined case."""
    if probability is None:
        probability = bool(
            (x >= 0).all() and np.allclose(x.sum(axis=-1), 1.0, atol=1e-3))
    if probability:
        return np.log(np.clip(x, 1e-30, None))
    return _log_softmax(x)


def _beam_topk(scores, logp, done, pad_token_id, num_beams):
    """One beam-search selection step, shared by beam_generate and
    incremental_beam_generate: finished beams propagate unchanged via a
    single pad candidate; top-k via argpartition (O(n), no full sort)."""
    vocab = logp.shape[-1]
    cand = scores[:, None] + np.where(done[:, None], -np.inf, logp)
    for b in np.nonzero(done)[0]:
        cand[b, pad_token_id] = scores[b]
    flat = np.argpartition(cand.ravel(), -num_beams)[-num_beams:]
    flat = flat[np.argsort(cand.ravel()[flat])[::-1]]
    return flat // vocab, flat % vocab, cand.ravel()[flat]


def beam_generate(model, encoder_ids: np.ndarray, *, num_beams: int = 4,
                  max_new_tokens: Optional[int] = None,
                  start_token_id: int = 0,
                  eos_token_id: Optional[int] = None,
                  pad_token_id: int = 0) -> np.ndarray:
    """Beam-search decode over the same full forward as greedy_generate
    (scores are sums of per-token log-probs; no length penalty). Each step
    runs the beams of ONE sample as a batch-shaped forward, so the
    compiled batch must be >= num_beams; samples decode one after another.
    num_beams=1 is greedy."""
    if model.executor is None:
        raise NotCompiledError("compile() the model first")
    fwd = model.executor.build_forward()
    enc_t, dec_t = model._fit_input_tensors[:2]
    bs, dec_len = dec_t.dims[0], dec_t.dims[1]
    if num_beams > bs:
        raise ServingConfigError(
            f"num_beams {num_beams} > compiled batch {bs}; recompile with a "
            "larger batch")
    if tuple(encoder_ids.shape[1:]) != tuple(enc_t.dims[1:]):
        raise ServingConfigError(
            f"encoder_ids row shape {tuple(encoder_ids.shape[1:])} != "
            f"compiled {tuple(enc_t.dims[1:])}")
    want = dec_len - 1 if max_new_tokens is None else max_new_tokens
    steps = min(want, dec_len - 1)
    _assert_same_call("beam_generate", encoder_ids, beams=num_beams,
                      steps=steps, start=start_token_id, eos=eos_token_id,
                      pad=pad_token_id)
    n_rows = encoder_ids.shape[0]
    if steps <= 0:
        return np.full((n_rows, 1), start_token_id, dec_t.data_type.np_dtype)
    prob_hint = model.output_probability_like()

    outs = []
    for row in np.asarray(encoder_ids, enc_t.data_type.np_dtype):
        # beams packed into the compiled batch; unused slots repeat beam 0
        enc = np.broadcast_to(row, (bs,) + row.shape).copy()
        beams = np.full((num_beams, dec_len), pad_token_id,
                        dec_t.data_type.np_dtype)
        beams[:, 0] = start_token_id
        scores = np.full(num_beams, -np.inf)
        scores[0] = 0.0  # all beams identical at t=0: keep one alive
        done = np.zeros(num_beams, bool)
        for t in range(steps):
            dec = np.full((bs, dec_len), pad_token_id, beams.dtype)
            dec[:num_beams] = beams
            logp = _as_log_probs(_host_rows(
                fwd(model.params, [enc, dec],
                    model.state.net_state)[:num_beams, t]), prob_hint)
            src, tok, scores = _beam_topk(scores, logp, done, pad_token_id,
                                          num_beams)
            beams = beams[src]
            beams[:, t + 1] = tok
            done = done[src]
            if eos_token_id is not None:
                done = done | (tok == eos_token_id)
                if done.all():
                    break
        # fixed width for every sample (early-stopped rows carry pad after
        # EOS) so the batch stacks even when samples finish at different t
        outs.append(beams[int(np.argmax(scores)), : steps + 1])
    return np.stack(outs, axis=0)


# ----------------------------------------------------------------------
# serving configuration, requests, admission
# ----------------------------------------------------------------------
@dataclasses.dataclass
class ServingConfig:
    """Knobs of the continuous-batching runtime. `max_len` caps
    prompt+generated tokens per sequence (the decode cache width); `slots`
    is the decode batch. The KV page pool exactly covers `slots`
    full-length sequences."""

    max_len: int
    slots: int = 4
    page_size: int = 16
    eos_token_id: Optional[int] = None
    # vouch that primitive-op self-attention is causal where no baked
    # mask proves it (parallel/decode.py build_plan)
    assume_causal: bool = False
    # import the decode strategy from this strategy_io file
    # (FFModel.compile_decode) when the model has no decode executor yet
    decode_strategy_path: Optional[str] = None

    def __post_init__(self):
        if self.max_len <= 1:
            raise ServingConfigError(f"max_len must be > 1: {self.max_len}")
        if self.slots <= 0:
            raise ServingConfigError(f"slots must be positive: {self.slots}")

    def kv_config(self) -> KVCacheConfig:
        per_slot = -(-self.max_len // self.page_size)
        return KVCacheConfig(num_pages=self.slots * per_slot,
                             page_size=self.page_size)


class GenerationRequest:
    """One decode request: prompt ids in, prompt+generated ids out.
    Completion is exactly once; `result()` raises the request's typed
    error instead of returning garbage or hanging."""

    def __init__(self, prompt: np.ndarray, max_new_tokens: int, *,
                 deadline_s: float = 30.0):
        self.id = uuid.uuid4().hex[:12]
        self.prompt = np.asarray(prompt)
        if self.prompt.ndim != 1:
            raise ServingConfigError(
                f"prompt must be a 1-D token array, got shape "
                f"{self.prompt.shape}")
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = time.monotonic() + float(deadline_s)
        self._event = threading.Event()
        self._lock = threading.Lock()
        self.tokens: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None

    def _finish(self, *, tokens: Optional[np.ndarray] = None,
                error: Optional[BaseException] = None) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self.tokens = tokens
            self.error = error
            self._event.set()
            return True

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.id} unanswered after "
                               f"{timeout}s")
        if self.error is not None:
            raise self.error
        return self.tokens


class AdmissionQueue:
    """Bounded FIFO. `offer` sheds at enqueue (queue full, dead on
    arrival); `poll` sheds requests whose deadline passed while queued;
    `requeue` (backpressure) pushes to the front, exempt from the bound."""

    def __init__(self, max_depth: int):
        self.max_depth = max_depth
        # set by a batcher that follows rank 0 in lockstep: this rank's
        # queue takes no requests
        self.follower_of: Optional[int] = None
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def offer(self, req: GenerationRequest) -> None:
        if self.follower_of is not None:
            raise ServingConfigError(
                f"this queue's batcher runs in lockstep with rank "
                f"{self.follower_of} of the process group, whose queue "
                f"alone takes requests: offer them on rank "
                f"{self.follower_of}")
        now = time.monotonic()
        if now >= req.deadline:
            err = DeadlineExceededError(
                f"request {req.id} dead on arrival "
                f"({now - req.deadline:.3f}s past deadline)", stage="enqueue")
            req._finish(error=err)
            raise err
        with self._lock:
            if len(self._q) >= self.max_depth:
                full = QueueFullError(
                    f"admission queue at capacity ({self.max_depth})")
                req._finish(error=full)
                raise full
            self._q.append(req)
            self._nonempty.notify()

    def requeue(self, req: GenerationRequest) -> None:
        with self._lock:
            self._q.appendleft(req)
            self._nonempty.notify()

    def poll(self, timeout: float = 0.0) -> Optional[GenerationRequest]:
        """Next live request, shedding expired ones at dequeue."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                while self._q:
                    req = self._q.popleft()
                    if req.done():
                        continue
                    now = time.monotonic()
                    if now >= req.deadline:
                        req._finish(error=DeadlineExceededError(
                            f"request {req.id} expired in queue "
                            f"({now - req.deadline:.3f}s past deadline)",
                            stage="dequeue"))
                        continue
                    return req
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._nonempty.wait(remaining)


# ----------------------------------------------------------------------
# continuous (in-flight) batching
# ----------------------------------------------------------------------
@dataclasses.dataclass
class _Slot:
    req: GenerationRequest
    seq_key: str
    tokens: List[int]
    prompt_len: int
    pos: int  # cache positions written == len(tokens) - 1


class ContinuousBatcher:
    """Iteration-level decode scheduler for one replica: a running batch of
    `config.slots` sequences, each at its own position. Every iteration:

      1. admit queued requests into free slots -- KV pages reserved
         worst-case (backpressure when the pool cannot cover it, a typed
         shed when it never could), the prompt prefilled through a batch-1
         decode step, the prefilled cache strip spliced into the batch;
      2. run ONE batched decode step for every active slot (on a card,
         a replay of the step's CUDA graph, captured in the serving
         thread at the first step);
      3. retire finished slots (EOS, max_new_tokens, blown deadline) and
         release their KV pages.

    Decoder-only models only (one graph input).

    On a process group of more than one rank (the model compiled over a
    mesh) the batcher runs in lockstep: every rank builds one over the
    same model and config and starts it; rank 0's queue alone takes
    requests (`offer` on another rank's queue raises). Every iteration
    rank 0 decides (the slots whose request expired or was abandoned, the
    requests it admits, each with its slot and its page reservation,
    whether to stop) and broadcasts that over the group (one integer in
    an iteration that decided nothing); then every rank
    runs the same retirements, prefills, slot insertions and decode step,
    and retires by the same logits. A follower's requests are mirrors of
    rank 0's (`mirrors`, by request id), answered as rank 0's are.
    `stop()` on rank 0 stops every rank's loop."""

    def __init__(self, model, config: ServingConfig,
                 queue_: AdmissionQueue):
        if model.executor is None:
            raise NotCompiledError("compile() the model first")
        if len(model._fit_input_tensors) != 1:
            raise ServingConfigError(
                "continuous batching serves decoder-only models (one graph "
                "input)")
        self.model = model
        self.config = config
        self.queue = queue_
        self.pool = PagePool(config.kv_config())
        self._device_lock = threading.RLock()
        ex = model.executor
        # prefill always builds from the training (compute-bound)
        # strategy: a prompt is a full-sequence forward
        self._init1, self._step1 = ex.build_decode(
            1, config.max_len, assume_causal=config.assume_causal)
        # the batched decode step prefers the decode-searched strategy
        # when the model has one (or the config names one) AND its caches
        # splice with the prefill build's (_insert_slot copies the
        # prefilled strips into the running batch); anything else falls
        # back to the training executor, counted and warned once
        self.decode_strategy_active = False
        dex = model.decode_executor
        if dex is None and config.decode_strategy_path:
            dex = model.compile_decode(
                strategy_path=config.decode_strategy_path)
        initB, stepB = ex.build_decode(config.slots, config.max_len,
                                       assume_causal=config.assume_causal)
        if dex is not None:
            from ..parallel.decode import (DecodeExactnessError,
                                           decode_fallback)
            try:
                initB_d, stepB_d = dex.build_decode(
                    config.slots, config.max_len,
                    assume_causal=config.assume_causal)
                problem = self._decode_executor_mismatch(dex, initB_d)
                if problem is not None:
                    decode_fallback("continuous batcher",
                                    "decode_strategy_incompatible", problem)
                else:
                    initB, stepB = initB_d, stepB_d
                    self.decode_strategy_active = True
            except DecodeExactnessError as e:
                decode_fallback("continuous batcher",
                                "decode_strategy_unbuildable", str(e))
        self._initB, self._stepB = initB, stepB
        self._id_dt = model._fit_input_tensors[-1].data_type.np_dtype
        self._caches = None
        self.slots: List[Optional[_Slot]] = [None] * config.slots
        self._stop = threading.Event()
        self.dead = False
        self.death_cause: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._admit_seq = 0  # per-admission nonce: pool keys stay unique
        # lockstep over a process group (class docstring)
        self._lockstep = rdist.process_count() > 1
        self._leader = rdist.process_index() == 0
        self.mirrors = {}
        if self._lockstep and not self._leader:
            queue_.follower_of = 0
        self.stats = {"admitted": 0, "finished": 0, "iterations": 0,
                      "prefills": 0, "retired_eos": 0, "shed_decode": 0,
                      "tokens": 0}

    def _decode_executor_mismatch(self, dex, initB_d) -> Optional[str]:
        """None if the decode-searched lowering can serve the batched
        step, else a readable reason. The two lowerings splice when (a)
        every weight-bearing op of the decode graph finds its weights in
        the (training) param store by op name, and (b) the decode build's
        caches match the prefill build's section by section: the
        guid-keyed "static"/"prefix"/"mha_static" sections must agree
        (guids differ across lowerings, so in practice both are empty, as
        for decoder-only fused-MHA graphs), and "mha" must cover the same
        op names with the same per-slot shapes and dtypes. Probed by
        building both cache sets once (the JAX package probes shapes
        without allocating; the port allocates and drops them)."""
        params = self.model.params
        missing = [op.name for op in dex.topo
                   if op.weights and not op.is_parallel_op
                   and op.name not in params]
        if missing:
            return (f"decode graph ops {missing} have no weights in the "
                    f"model's param store")
        try:
            dec = initB_d(params)
            pre = self._init1(params)
        except (AssertionError, RuntimeError, ValueError) as e:
            return f"cache shape probe failed: {e}"
        for section in ("static", "prefix", "mha_static"):
            d_keys, p_keys = set(dec[section]), set(pre[section])
            if d_keys != p_keys:
                return (f"{section!r} cache keys differ between the decode- "
                        f"and train-searched lowerings "
                        f"({len(d_keys)} vs {len(p_keys)} entries)")
        if set(dec["mha"]) != set(pre["mha"]):
            return ("attention cache op names differ between the decode- "
                    "and train-searched lowerings")
        for name, dleaves in dec["mha"].items():
            for a, b in zip(dleaves, pre["mha"][name]):
                if a.shape[1:] != b.shape[1:] or a.dtype != b.dtype:
                    return (f"attention cache leaf mismatch for {name!r}: "
                            f"{tuple(a.shape)}/{a.dtype} vs "
                            f"{tuple(b.shape)}/{b.dtype}")
        return None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ContinuousBatcher":
        if self._thread is None:
            self._thread = threading.Thread(target=self._serve_loop,
                                            daemon=True,
                                            name="ff-serve")
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    # -- admission ---------------------------------------------------------
    def _bucket(self, plen: int) -> int:
        b = 1
        while b < plen:
            b *= 2
        return min(b, self.config.max_len)

    def _reserve_tokens(self, plen: int, max_new: int) -> int:
        # prefill touches the padded bucket; decode grows to plen +
        # max_new - 1 written positions
        return min(self.config.max_len,
                   max(self._bucket(plen), plen + max_new))

    def _pick_admission(self):
        """The next request to admit and its pool key, its pages reserved
        (rank 0, or the one process): None when the queue is empty or the
        pool presses back (the request requeued), False when the request
        was shed (too long, or never fitting the pool) and the next may
        be tried."""
        req = self.queue.poll(timeout=0.0)
        if req is None:
            return None
        plen = len(req.prompt)
        if plen < 1 or plen + req.max_new_tokens > self.config.max_len:
            req._finish(error=RequestShedError(
                f"request {req.id}: prompt {plen} + max_new "
                f"{req.max_new_tokens} exceeds max_len {self.config.max_len}",
                reason="too_long"))
            return False
        self._admit_seq += 1
        seq_key = f"{req.id}:{self._admit_seq}"
        try:
            self.pool.reserve(
                seq_key, self._reserve_tokens(plen, req.max_new_tokens))
        except KVCacheExhaustedError as e:
            if e.never_fits:
                req._finish(error=RequestShedError(
                    f"request {req.id} can never fit the KV page pool: {e}",
                    reason="kv_exhausted"))
                return False
            self.queue.requeue(req)  # backpressure: wait for retirements
            return None
        return req, seq_key

    def _admit(self, req: GenerationRequest, seq_key: str,
               slot_idx: int) -> None:
        """Prefill an admitted request (its pages reserved) into slot
        `slot_idx`."""
        plen = len(req.prompt)
        try:
            first, caches1 = self._prefill(req, plen)
            self._insert_slot(slot_idx, caches1)
        except BaseException:
            self.pool.release(seq_key)
            raise
        self.pool.touch(seq_key, self._bucket(plen))
        self.slots[slot_idx] = _Slot(
            req=req, seq_key=seq_key,
            tokens=list(req.prompt.tolist()) + [first],
            prompt_len=plen, pos=plen)
        self.stats["admitted"] += 1
        self.stats["prefills"] += 1
        self._maybe_retire(slot_idx)

    def _plan(self) -> Optional[dict]:
        """This iteration's decisions, rank 0's on every rank in lockstep
        (the one process's otherwise), already applied to this rank's
        slots and page pool: {"admit": [(request, pool key, slot)]}, or
        None to stop. Rank 0 retires the slots whose request expired or
        was abandoned, then takes requests into the free slots while the
        pool covers them; a follower retires the same slots and reserves
        the same pages. Only an iteration in which rank 0 decided
        something sends its decisions (`broadcast_optional`)."""
        plan = None
        if self._leader:
            if self._stop.is_set():
                plan = {"stop": True, "expire": [], "admit": []}
            else:
                expire = [i for i, slot in enumerate(self.slots)
                          if slot is not None and self._lockstep
                          and self._timed_out(i)]
                admit = []
                free = [i for i, slot in enumerate(self.slots)
                        if slot is None]
                while free:
                    got = self._pick_admission()
                    if got is None:
                        break
                    if got:
                        admit.append(got + (free.pop(0),))
                plan = {"stop": False, "expire": expire, "admit": admit}
        if not self._lockstep:
            return None if plan["stop"] else plan
        wire = None
        if self._leader and (plan["stop"] or plan["expire"]
                             or plan["admit"]):
            wire = dict(plan, admit=[
                (req.id, req.prompt, req.max_new_tokens, key, slot)
                for req, key, slot in plan["admit"]])
        # an iteration with nothing decided broadcasts one integer
        wire = rdist.broadcast_optional(wire)
        if wire is None:
            return plan if self._leader else {"admit": []}
        if wire["stop"]:
            return None
        if not self._leader:
            for i in wire["expire"]:
                self._timed_out(i)
            plan = {"admit": []}
            for rid, prompt, new, key, slot in wire["admit"]:
                req = GenerationRequest(prompt, new, deadline_s=math.inf)
                req.id = rid
                self.mirrors[rid] = req
                self.pool.reserve(key, self._reserve_tokens(len(prompt), new))
                plan["admit"].append((req, key, slot))
        return plan

    def _prefill(self, req: GenerationRequest, plen: int):
        """The prompt through the batch-1 decode step, padded to a
        power-of-two bucket. The padded tail's K/V sits at positions >=
        plen, which decode overwrites before the causal mask exposes
        them."""
        padded = np.zeros((1, self._bucket(plen)), self._id_dt)
        padded[0, :plen] = req.prompt.astype(self._id_dt)
        with self._device_lock:
            caches1 = self._init1(self.model.params)
            logits, caches1 = self._step1(self.model.params, caches1, 0,
                                          [padded])
            first = int(_argmax_last(logits[0, plen - 1]))
        return first, caches1

    def _insert_slot(self, slot_idx: int, caches1) -> None:
        """Write a prefilled batch-1 cache strip wholesale into the running
        batch at `slot_idx`, replacing whatever a previous occupant left.
        On a mesh each rank writes the part of the row its own strips
        hold (`_copy_row`)."""
        with self._device_lock:
            if self._caches is None:
                self._caches = self._initB(self.model.params)
            for g, c in self._caches["prefix"].items():
                row = caches1["prefix"][g]
                if tuple(c.shape) != (self.config.slots,) + tuple(
                        row.shape[1:]):
                    raise ServingConfigError(
                        f"prefix cache guid {g} has no per-slot leading "
                        f"axis (batch shape {tuple(c.shape)} vs row "
                        f"{tuple(row.shape)}): this graph folds batch with "
                        "another axis and cannot be continuously batched")
                _copy_row(c, slot_idx, row)
            for opname, (kB, vB) in self._caches["mha"].items():
                k1, v1 = caches1["mha"][opname]
                _copy_row(kB, slot_idx, k1)
                _copy_row(vB, slot_idx, v1)

    # -- retirement --------------------------------------------------------
    def _release(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        self.slots[slot_idx] = None
        if slot is not None:
            self.pool.release(slot.seq_key)

    def _timed_out(self, slot_idx: int) -> bool:
        """Retire slot `slot_idx` if its request was answered elsewhere
        (aborted) or blew its deadline; whether it did. In lockstep only
        rank 0 asks (its clock and its requests decide) and the followers
        retire what it names (`_plan`)."""
        slot = self.slots[slot_idx]
        if self._lockstep and not self._leader:
            slot.req._finish(error=RequestShedError(
                f"request {slot.req.id} retired by rank 0",
                reason="leader"))
            self._release(slot_idx)
            return True
        if slot.req.done():  # aborted elsewhere
            self._release(slot_idx)
            return True
        if time.monotonic() > slot.req.deadline:
            self.stats["shed_decode"] += 1
            slot.req._finish(error=DeadlineExceededError(
                f"request {slot.req.id} blew its deadline mid-decode after "
                f"{len(slot.tokens) - slot.prompt_len} token(s)",
                stage="decode"))
            self._release(slot_idx)
            return True
        return False

    def _maybe_retire(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        if slot is None:
            return
        # in lockstep the clock and the abandoned requests are rank 0's
        # call, made at the next iteration's plan
        if not self._lockstep and self._timed_out(slot_idx):
            return
        generated = len(slot.tokens) - slot.prompt_len
        eos = self.config.eos_token_id
        hit_eos = eos is not None and slot.tokens[-1] == eos
        if generated >= slot.req.max_new_tokens or hit_eos:
            self.stats["retired_eos"] += int(hit_eos)
            if slot.req._finish(tokens=np.asarray(slot.tokens, self._id_dt)):
                self.stats["finished"] += 1
                self.stats["tokens"] += generated
            self._release(slot_idx)

    # -- the iteration loop ------------------------------------------------
    def _decode_iteration(self) -> None:
        t_vec = np.zeros(self.config.slots, np.int32)
        toks = np.zeros((self.config.slots, 1), self._id_dt)
        active = []
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            active.append(i)
            t_vec[i] = slot.pos
            toks[i, 0] = slot.tokens[slot.pos]
        with self._device_lock:
            logits, self._caches = self._stepB(self.model.params,
                                               self._caches, t_vec, [toks])
            nxt = _argmax_last(logits[:, 0])
        for i in active:
            slot = self.slots[i]
            slot.tokens.append(int(nxt[i]))
            slot.pos += 1
            self.pool.touch(slot.seq_key,
                            max(self._bucket(slot.prompt_len), slot.pos))
            self._maybe_retire(i)

    def _serve_loop(self) -> None:
        try:
            device = self.model.executor.device
            if device.type == "cuda" and device.index is not None:
                # a thread starts on card 0: serve on the model's card
                torch.cuda.set_device(device)
            while True:
                plan = self._plan()
                if plan is None:
                    break
                for req, seq_key, slot_idx in plan["admit"]:
                    self._admit(req, seq_key, slot_idx)
                if self.active_slots == 0:
                    if not plan["admit"]:
                        time.sleep(_IDLE_WAIT_S)
                    continue
                self._decode_iteration()
                self.stats["iterations"] += 1
        except Exception as e:  # the replica died: fail its requests
            self.dead = True
            self.death_cause = e
            for i, slot in enumerate(self.slots):
                if slot is not None:
                    slot.req._finish(error=RequestShedError(
                        f"serving loop died: {e!r}", reason="died"))
                    self._release(i)
