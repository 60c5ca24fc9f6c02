"""Generation APIs, continuous batching and the serving fleet over
compiled models.

The PyTorch counterpart of flexflow_tpu/runtime/serving.py:

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
    bucket, the prefilled cache strip copied into the running batch) and
    runs ONE batched decode step with a per-slot position vector, built
    from the decode-searched executor (FFModel.compile_decode) when the
    model has one that splices with the prefill build;
  * **prefix sharing** -- admission reserves through the page pool's
    content-addressed index (`reserve(..., tokens=prompt)`): published
    prompt pages are attached refcounted and discounted from the KV
    charge, and a prompt seen verbatim before skips its prefill (the
    prefill memo, an LRU of prefilled strips: identical prompt and
    weights give the identical strip);
  * **admission control** -- a bounded queue with end-to-end deadlines
    (checked at enqueue, dequeue and every iteration), a `TokenBucket`
    whose refill follows the latency p95 by AIMD, and KV-page
    backpressure; every refusal is a typed `RequestShedError` counted in
    `ff_serving_shed_total{reason}`;
  * **replica failover** -- `ReplicaSet` runs N batchers off one shared
    queue, each watched by a `HealthMonitor` (runtime/elastic.py); a dead
    or hung replica's in-flight requests go back to the front of the
    queue (owner-checked, so a late corpse cannot answer them) while a
    warm spare, or a rebuild through `restore_elastic`, replaces it; the
    replica count follows the queue depth and the SLO violation rate;
  * **dynamic batching** -- `BatchScheduler` packs single-shot forward
    requests to the compiled batch, with a degraded direct path when its
    worker dies.

Every one-token step passes per-row positions, so on a card it replays
the decode step's captured graph; `_eager=True` runs the steps eagerly.
Replicas of one process share one device lock (`ReplicaSet`), under
which every step, prefill, capture and warm-up runs.

On a process group (one process per device, the model compiled over a
mesh) the APIs run SPMD: every rank calls them with the same prompts
(checked: a mismatch raises on every rank), the steps run at the
executor's degrees, and the logits come back whole on every rank, so
every rank picks the same tokens and beams. The batcher runs in lockstep:
rank 0's queue alone takes requests, and every iteration rank 0
broadcasts its decisions (the admissions with their shared pages, the
expired slots, the stop; one integer when there are none) before every
rank runs the same prefill or prefill-memo hit, slot insertion and
decode step (`ContinuousBatcher`).

Fault sites (`FaultInjector`): ``replica_death`` and ``slow_worker`` in
the batcher, ``serving_worker`` in BatchScheduler's worker, and the page
pool's ``kv_exhaustion``, ``shared_page_corruption``, ``release_race``
and ``cow_fault``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import queue
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs.request_trace import (
    NULL_REQUEST_TRACE,
    SLOMonitor,
    mint_request_trace,
    record_request_stages,
)
from ..parallel.executor import _tensors
from ..parallel.mesh import full, is_dtensor, local
from . import distributed as rdist
from .kvcache import KVCacheConfig, KVCacheExhaustedError, PagePool
from .resilience import ResilienceError
from .verify import NotCompiledError, ServingConfigError

logger = logging.getLogger("flexflow_tpu_torch.runtime.serving")


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
# typed admission failures: every request not answered gets one of these
# and an ff_serving_shed_total increment
# ----------------------------------------------------------------------
class RequestShedError(ResilienceError):
    """The runtime refused or abandoned a request on purpose (load
    shedding, not a fault); `reason` says why. Not a TimeoutError: a
    retry policy must not hammer an overloaded service."""

    reason = "shed"

    def __init__(self, msg: str, *, reason: Optional[str] = None):
        super().__init__(msg)
        if reason is not None:
            self.reason = reason


class DeadlineExceededError(RequestShedError):
    """The request's deadline passed (or provably cannot be met) before a
    result; `stage` says where: enqueue, dequeue, admit, decode or
    failover."""

    reason = "deadline"

    def __init__(self, msg: str, *, stage: str = "queue"):
        super().__init__(msg)
        self.stage = stage


class QueueFullError(RequestShedError):
    """The bounded admission queue is at capacity."""

    reason = "queue_full"


class RateLimitedError(RequestShedError):
    """The token bucket is empty: the offered load exceeds the (possibly
    p95-adapted) sustainable rate."""

    reason = "rate_limited"


class ReplicaDeathError(ResilienceError):
    """A serving replica crashed (or the ``replica_death`` fault site
    simulated it). Raised inside the replica's serve loop; the ReplicaSet
    requeues its in-flight work and replaces it."""


def _shed(reason: str, n: float = 1.0) -> None:
    from .. import obs

    obs.count("ff_serving_shed_total", n,
              help="requests shed by admission control/deadlines",
              reason=reason)


# ----------------------------------------------------------------------
# serving configuration, requests, admission
# ----------------------------------------------------------------------
@dataclasses.dataclass
class ServingConfig:
    """Knobs of the continuous-batching runtime.

    `max_len` caps prompt+generated tokens per sequence (the decode cache
    width); `slots` is the decode batch of one replica. The KV page pool
    covers `slots` full-length sequences unless `num_pages` says
    otherwise; `watermark` holds a share of it back from admission.
    `share_prefixes` attaches published prompt pages at admission and
    publishes each prompt's full pages; `prefix_cache_entries` bounds the
    prefill memo (0: no prefill skip, page sharing stays). `rate_limit`
    (requests/s) turns on the token bucket, and `adaptive_rate` lets its
    refill follow the latency p95 toward `target_p95_s`. `slo_ttft_s` and
    `slo_p99_s` are the SLO monitor's targets (None: not checked).
    `decode_retune` re-runs compile_decode() between batches when the
    admitted prompt lengths drift by more than `decode_retune_threshold`
    (relative) over at least `decode_retune_min_admissions` requests, at
    most once per `decode_retune_cooldown_iters` iterations (the tuner's
    serving leg). `precompile` warms the batched step (on a card: its
    graph capture) and every prefill bucket before the replica takes
    traffic."""

    max_len: int
    slots: int = 4
    page_size: int = 16
    num_pages: Optional[int] = None
    watermark: float = 0.0
    share_prefixes: bool = True
    prefix_cache_entries: int = 8
    max_queue_depth: int = 64
    default_deadline_s: float = 30.0
    default_max_new_tokens: int = 16
    rate_limit: Optional[float] = None
    rate_burst: int = 8
    adaptive_rate: bool = False
    target_p95_s: float = 1.0
    slo_ttft_s: Optional[float] = None
    slo_p99_s: Optional[float] = None
    eos_token_id: Optional[int] = None
    # vouch that primitive-op self-attention is causal where no baked
    # mask proves it (parallel/decode.py build_plan)
    assume_causal: bool = False
    # import the decode strategy from this strategy_io file
    # (FFModel.compile_decode) when the model has no decode executor yet
    decode_strategy_path: Optional[str] = None
    decode_retune: bool = False
    decode_retune_threshold: float = 0.5
    decode_retune_min_admissions: int = 8
    decode_retune_cooldown_iters: int = 50
    idle_wait_s: float = 0.005
    precompile: bool = True

    def __post_init__(self):
        if self.max_len <= 1:
            raise ServingConfigError(f"max_len must be > 1: {self.max_len}")
        if self.slots <= 0:
            raise ServingConfigError(f"slots must be positive: {self.slots}")
        if self.max_queue_depth <= 0:
            raise ServingConfigError(
                f"max_queue_depth must be positive: {self.max_queue_depth}")

    def kv_config(self) -> KVCacheConfig:
        pages = self.num_pages
        if pages is None:
            pages = self.slots * KVCacheConfig(
                num_pages=1, page_size=self.page_size).pages_for(self.max_len)
        return KVCacheConfig(num_pages=pages, page_size=self.page_size,
                             watermark=self.watermark)


class GenerationRequest:
    """One decode request: prompt ids in, prompt+generated ids out.

    Completion is exactly once and owner-checked: a failover requeue bumps
    `generation`, so a stalled replica that wakes up later cannot answer
    work handed to a sibling. `result()` raises the request's typed error
    instead of returning garbage or hanging."""

    def __init__(self, prompt: np.ndarray, max_new_tokens: int, *,
                 deadline_s: float = 30.0):
        self.id = uuid.uuid4().hex[:12]
        self.prompt = np.asarray(prompt)
        if self.prompt.ndim != 1:
            raise ServingConfigError(
                f"prompt must be a 1-D token array, got shape "
                f"{self.prompt.shape}")
        self.max_new_tokens = int(max_new_tokens)
        self.submitted_t = time.monotonic()
        self.deadline = self.submitted_t + float(deadline_s)
        self.admitted_t: Optional[float] = None  # the last slot admission
        self.first_token_t: Optional[float] = None
        self.finished_t: Optional[float] = None
        self.generation = 0  # bumped on a failover requeue
        # the request's flight recorder (obs/request_trace.py), minted by
        # ReplicaSet.submit or AdmissionQueue.offer
        self.trace = NULL_REQUEST_TRACE
        self._event = threading.Event()
        self._lock = threading.Lock()
        self.tokens: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None

    def _finish(self, *, tokens: Optional[np.ndarray] = None,
                error: Optional[BaseException] = None,
                generation: Optional[int] = None) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            if generation is not None and generation != self.generation:
                return False  # requeued to another replica meanwhile
            self.tokens = tokens
            self.error = error
            self.finished_t = time.monotonic()
            self._event.set()
            return True

    def _requeue_bump(self) -> Optional[int]:
        """Take ownership away from a dead replica; the new generation,
        or None when the request already finished."""
        with self._lock:
            if self._event.is_set():
                return None
            self.generation += 1
            return self.generation

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        from .resilience import InferenceTimeout

        if not self._event.wait(timeout):
            raise InferenceTimeout(f"request {self.id} unanswered after "
                                   f"{timeout}s")
        if self.error is not None:
            raise self.error
        return self.tokens


class TokenBucket:
    """Token bucket whose refill rate AIMD-adapts (`adapt`) to the serving
    p95 against a latency target, so sustained overload tightens
    admission instead of growing the queue. `clock` is injectable."""

    def __init__(self, rate: float, burst: int, *,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = max(1, int(burst))
        self._clock = clock
        self._tokens = float(self.burst)
        self._last = clock()
        self._lock = threading.Lock()
        self.min_rate = max(0.1, self.rate / 64.0)
        self.max_rate = self.rate * 16.0

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def adapt(self, p95_s: float, target_p95_s: float) -> float:
        """One AIMD step: a p95 over target cuts the refill by 0.7, under
        target grows it by 1 request/s; NaN (no samples) leaves it. Returns
        the new rate (also the ff_serving_admission_rate gauge)."""
        from .. import obs

        with self._lock:
            if p95_s == p95_s:
                if p95_s > target_p95_s:
                    self.rate = max(self.min_rate, self.rate * 0.7)
                else:
                    self.rate = min(self.max_rate, self.rate + 1.0)
            rate = self.rate
        obs.gauge_set("ff_serving_admission_rate", rate,
                      help="token-bucket refill rate (requests/s)")
        return rate


class AdmissionQueue:
    """Bounded FIFO shared by every replica's batcher. `offer` sheds at
    enqueue (queue full, dead on arrival); `poll` sheds requests whose
    deadline passed while queued, so they never reach the device;
    `requeue` (backpressure, failover) pushes to the front, exempt from
    the bound; `drain` fails every queued request (shutdown)."""

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

    def _export_depth(self) -> None:
        from .. import obs

        obs.gauge_set("ff_serving_queue_depth", len(self),
                      help="requests waiting for a decode slot")

    def _export_depth_locked(self) -> None:
        from .. import obs

        obs.gauge_set("ff_serving_queue_depth", len(self._q),
                      help="requests waiting for a decode slot")

    def offer(self, req: GenerationRequest) -> None:
        if self.follower_of is not None:
            raise ServingConfigError(
                f"this queue's batcher runs in lockstep with rank "
                f"{self.follower_of} of the process group, whose queue "
                f"alone takes requests: offer them on rank "
                f"{self.follower_of}")
        if req.trace is NULL_REQUEST_TRACE:
            # the mint is deterministic per id: an unsampled request
            # stays unsampled
            req.trace = mint_request_trace(req.id)
        now = time.monotonic()
        if now >= req.deadline:
            err = DeadlineExceededError(
                f"request {req.id} dead on arrival "
                f"({now - req.deadline:.3f}s past deadline)", stage="enqueue")
            _shed("deadline")
            req.trace.shed("deadline", stage="enqueue")
            req._finish(error=err)
            raise err
        with self._lock:
            if len(self._q) >= self.max_depth:
                full_ = QueueFullError(
                    f"admission queue at capacity ({self.max_depth})")
                _shed("queue_full")
                req.trace.shed("queue_full", stage="enqueue")
                req._finish(error=full_)
                raise full_
            req.trace.queue_begin(depth=len(self._q))
            self._q.append(req)
            self._nonempty.notify()
        self._export_depth()

    def requeue(self, req: GenerationRequest) -> None:
        with self._lock:
            self._q.appendleft(req)
            self._nonempty.notify()
        self._export_depth()

    def poll(self, timeout: float = 0.0) -> Optional[GenerationRequest]:
        """Next live request, shedding expired ones at dequeue."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                while self._q:
                    req = self._q.popleft()
                    if req.done():
                        continue  # aborted or shed elsewhere
                    now = time.monotonic()
                    if now >= req.deadline:
                        _shed("deadline")
                        req.trace.shed("deadline", stage="dequeue")
                        req._finish(error=DeadlineExceededError(
                            f"request {req.id} expired in queue "
                            f"({now - req.deadline:.3f}s past deadline)",
                            stage="dequeue"))
                        continue
                    self._export_depth_locked()
                    return req
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._nonempty.wait(remaining)

    def drain(self, error_factory) -> int:
        """Fail every queued request with `error_factory(req)`; the number
        drained."""
        with self._lock:
            pending = list(self._q)
            self._q.clear()
        n = 0
        for req in pending:
            if req._finish(error=error_factory(req)):
                _shed("aborted")
                n += 1
        self._export_depth()
        return n


# ----------------------------------------------------------------------
# continuous (in-flight) batching
# ----------------------------------------------------------------------
@dataclasses.dataclass
class _Slot:
    req: GenerationRequest
    generation: int
    seq_key: str
    tokens: List[int]
    prompt_len: int
    pos: int  # cache positions written == len(tokens) - 1


class ContinuousBatcher:
    """Iteration-level decode scheduler for one replica: a running batch of
    `config.slots` sequences, each at its own position. Every iteration:

      1. admit queued requests into free slots -- the deadline re-checked,
         KV pages reserved worst-case through the prefix index (published
         prompt pages attached, backpressure when the pool cannot cover
         the rest, a typed shed when it never could), the prompt prefilled
         through a batch-1 decode step (or taken from the prefill memo
         when seen verbatim before), the strip copied into the running
         batch, and the prompt's full pages published;
      2. run ONE batched decode step for every active slot (on a card,
         a replay of the step's CUDA graph, captured at warm-up or at the
         first step in the serving thread, under the device lock);
      3. retire finished slots (EOS, max_new_tokens, blown deadline) and
         release their KV pages.

    Decoder-only models only (one graph input).

    Faults: ``replica_death`` raises out of the loop (the dying thread
    hands its slots back to the queue; a ReplicaSet replaces it),
    ``slow_worker`` stalls an iteration inside the monitored step window,
    the pool's sites fire in the pool.

    On a process group of more than one rank (the model compiled over a
    mesh) the batcher runs in lockstep: every rank builds one over the
    same model and config and starts it; rank 0's queue alone takes
    requests (`offer` on another rank's queue raises). Every iteration
    rank 0 decides (the slots whose request expired or was abandoned, the
    requests it admits, each with its slot, its page reservation and its
    shared pages; whether to stop) and broadcasts that over the group (one
    integer in an iteration that decided nothing); then every rank runs
    the same retirements, reservations, prefills or memo hits (each
    rank's memo sees the same admissions in the same order), slot
    insertions and decode step, and retires by the same logits. A follower's requests are mirrors of
    rank 0's (`mirrors`, by request id), answered as rank 0's are.
    `stop()` on rank 0 stops every rank's loop. The decode retune is not
    run in lockstep (its re-search would have to run on every rank at
    once)."""

    def __init__(self, model, config: ServingConfig,
                 queue_: AdmissionQueue, *,
                 name: str = "replica0",
                 pool: Optional[PagePool] = None,
                 fault_injector=None,
                 monitor=None,
                 on_dead: Optional[Callable] = None,
                 device_lock: Optional[threading.RLock] = None,
                 slo: Optional[SLOMonitor] = None):
        if model.executor is None:
            raise NotCompiledError("compile() the model first")
        if len(model._fit_input_tensors) != 1:
            raise ServingConfigError(
                "continuous batching serves decoder-only models (one graph "
                "input); use BatchScheduler/incremental_seq2seq_generate "
                "for encoder-decoder graphs")
        self.model = model
        self.config = config
        self.queue = queue_
        self.name = name
        self.fault_injector = fault_injector
        self.monitor = monitor
        self.on_dead = on_dead
        self.slo = slo  # a ReplicaSet's shared SLOMonitor, or None
        self.pool = pool or PagePool(config.kv_config(),
                                     fault_injector=fault_injector)
        # every replica of one process runs its device work under one lock
        # (a ReplicaSet hands its own to each): steps, prefills, warm-ups
        # and graph captures never interleave across replicas
        self._device_lock = device_lock or threading.RLock()
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
                    decode_fallback(self.name,
                                    "decode_strategy_incompatible", problem)
                else:
                    initB, stepB = initB_d, stepB_d
                    self.decode_strategy_active = True
            except DecodeExactnessError as e:
                decode_fallback(self.name, "decode_strategy_unbuildable",
                                str(e))
        self._initB, self._stepB = initB, stepB
        self._id_dt = model._fit_input_tensors[-1].data_type.np_dtype
        self._caches = None
        self.slots: List[Optional[_Slot]] = [None] * config.slots
        self._stop = threading.Event()
        self.dead = False
        self.death_cause: Optional[BaseException] = None
        self.draining = False
        self._thread: Optional[threading.Thread] = None
        self._iteration = 0
        self._admit_seq = 0  # per-admission nonce: pool keys stay unique
        # slot teardown mutex: _release and _strand_slots take the slot
        # under it before touching the pool, so a wedged serve thread
        # waking mid-steal and the watchdog never both release one key
        self._teardown_lock = threading.Lock()
        # the prefill memo: (bucket, prompt bytes) -> (first token, batch-1
        # cache strip). The same prompt under the same weights prefills to
        # the same strip, so replaying it is exact; an LRU of
        # prefix_cache_entries, cleared by a decode retune. A strip is
        # only ever copied into the running batch, never aliased by it.
        self._prefix_cache: "OrderedDict" = OrderedDict()
        # per-token service-time EWMA: the "cannot meet its deadline"
        # shed at admission, once the first iterations were measured
        self._token_ewma_s: Optional[float] = None
        # decode-retune drift watch: the admitted prompt-length EWMA
        # against the one frozen at the last decode build
        self._plen_ewma: Optional[float] = None
        self._plen_at_build: Optional[float] = None
        self._plen_admissions = 0
        self._retune_cooldown_until = 0
        # lockstep over a process group (class docstring)
        self._lockstep = rdist.process_count() > 1
        self._leader = rdist.process_index() == 0
        self.mirrors = {}
        if self._lockstep and not self._leader:
            queue_.follower_of = 0
        if self._lockstep and config.decode_retune:
            raise ServingConfigError(
                "decode_retune re-searches the decode strategy inside one "
                "batcher; in lockstep over a process group every rank "
                "would have to re-search at once, which is not supported: "
                "set decode_retune=False")
        self.stats = {"admitted": 0, "finished": 0, "iterations": 0,
                      "prefills": 0, "retired_eos": 0, "shed_decode": 0,
                      "stranded_requeued": 0, "decode_retunes": 0,
                      "prefix_hits": 0, "prefill_skips": 0}

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
                                            name=f"ff-serve-{self.name}")
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def thread_alive(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and not self.dead)

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def in_flight(self) -> List[_Slot]:
        return [s for s in self.slots if s is not None]

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

    def _memo_key(self, prompt: np.ndarray):
        if not (self.config.share_prefixes
                and self.config.prefix_cache_entries > 0):
            return None
        return (self._bucket(len(prompt)),
                np.asarray(prompt).astype(self._id_dt).tobytes())

    def _pick_admission(self):
        """The next request to admit, its pool key and its reservation
        (rank 0, or the one process): None when the queue is empty or the
        pool presses back (the request requeued), False when the request
        was shed (too long, past its deadline, never fitting the pool)
        and the next may be tried."""
        from .. import obs

        req = self.queue.poll(timeout=0.0)
        if req is None:
            return None
        now = time.monotonic()
        plen = len(req.prompt)
        if plen < 1 or plen + req.max_new_tokens > self.config.max_len:
            _shed("too_long")
            req.trace.shed("too_long", stage="admit", replica=self.name)
            req._finish(error=RequestShedError(
                f"request {req.id}: prompt {plen} + max_new "
                f"{req.max_new_tokens} exceeds max_len {self.config.max_len}",
                reason="too_long"))
            return False
        # with a measured service time, a request whose decode provably
        # outlives its deadline never runs
        if self._token_ewma_s is not None:
            need = req.max_new_tokens * self._token_ewma_s
            if now + need > req.deadline:
                _shed("deadline")
                req.trace.shed("deadline", stage="admit", replica=self.name)
                req._finish(error=DeadlineExceededError(
                    f"request {req.id} cannot meet its deadline: needs "
                    f"~{need:.3f}s, has {max(0.0, req.deadline - now):.3f}s",
                    stage="admit"))
                return False
        self._admit_seq += 1
        seq_key = f"{req.id}:{req.generation}:{self.name}:{self._admit_seq}"
        try:
            rr = self.pool.reserve(
                seq_key, self._reserve_tokens(plen, req.max_new_tokens),
                tokens=(req.prompt.tolist() if self.config.share_prefixes
                        else None))
        except KVCacheExhaustedError as e:
            if e.never_fits:
                _shed("kv_exhausted")
                req.trace.shed("kv_exhausted", stage="admit",
                               replica=self.name,
                               pages_needed=e.pages_needed)
                obs.record_failure(e, replica=self.name, request=req.id,
                                   kv_snapshot=self.pool.snapshot())
                req._finish(error=RequestShedError(
                    f"request {req.id} can never fit the KV page pool: {e}",
                    reason="kv_exhausted"))
                return False
            self.queue.requeue(req)  # backpressure: wait for retirements
            req.trace.event("kv_backpressure", replica=self.name,
                            pages_needed=e.pages_needed,
                            pages_free=e.pages_free)
            obs.event("serving_kv_backpressure", cat="serving",
                      replica=self.name, request=req.id,
                      pages_needed=e.pages_needed, pages_free=e.pages_free)
            return None
        self._materialize(seq_key, req.prompt)
        return req, seq_key, rr

    def _materialize(self, seq_key: str, prompt: np.ndarray) -> None:
        """Back a reserved prompt's padded bucket with pages and publish
        its full pages, at once: a later admission of the same plan
        attaches them, as it would after this one's prefill (the pool is
        bookkeeping; no strip is read through it)."""
        self.pool.touch(seq_key, self._bucket(len(prompt)))
        if self.config.share_prefixes:
            self.pool.publish(seq_key, prompt.tolist())

    def _admit(self, req: GenerationRequest, seq_key: str, rr,
               slot_idx: int) -> None:
        """Prefill an admitted request (its pages reserved as `rr` and
        materialized) into slot `slot_idx`, from the memo when it holds
        the prompt. In lockstep every rank's memo sees the same admissions
        in the same order, so every rank takes the same hits."""
        from .. import obs

        plen = len(req.prompt)
        bucket = self._bucket(plen)
        generation = req.generation
        req.admitted_t = time.monotonic()
        req.trace.admitted(self.name, generation=generation, slot=slot_idx,
                           prompt_len=plen)
        if rr.shared_pages:
            self.stats["prefix_hits"] += 1
        if req.trace.sampled:
            req.trace.event("kv_reserve", replica=self.name, pages=rr.pages,
                            shared=rr.shared_pages, **self.pool.snapshot())
        key = self._memo_key(req.prompt)
        cached = self._prefix_cache.get(key) if key is not None else None
        span = req.trace.span("prefill", replica=self.name, bucket=bucket,
                              prompt_len=plen, skipped=cached is not None)
        try:
            if cached is not None:
                first, caches1 = cached
                self._prefix_cache.move_to_end(key)
                self.stats["prefill_skips"] += 1
            else:
                first, caches1 = self._prefill(req, plen)
                if key is not None:
                    self._prefix_cache[key] = (first, caches1)
                    while (len(self._prefix_cache)
                           > self.config.prefix_cache_entries):
                        self._prefix_cache.popitem(last=False)
            self._insert_slot(slot_idx, caches1)
        except BaseException:
            self.pool.release(seq_key)
            raise
        span.done()
        req.first_token_t = time.monotonic()
        obs.observe("ff_serving_ttft_seconds",
                    req.first_token_t - req.submitted_t,
                    help="time from submit to first generated token")
        self.slots[slot_idx] = _Slot(
            req=req, generation=generation, seq_key=seq_key,
            tokens=list(req.prompt.tolist()) + [first],
            prompt_len=plen, pos=plen)
        self.stats["admitted"] += 1
        self.stats["prefills"] += 1  # admissions, memo hits included
        self._note_admitted_plen(plen)
        self._maybe_retire(slot_idx)

    def _plan(self) -> Optional[dict]:
        """This iteration's decisions, rank 0's on every rank in lockstep
        (the one process's otherwise), with this rank's slots and page
        pool already updated: {"admit": [(request, pool key, reservation,
        slot)]}, or None to stop. Rank 0 retires the slots whose
        request expired or was abandoned, then takes requests into the
        free slots while the pool covers them; a follower retires the same
        slots and reserves the same pages (attaching the same shared
        ones). Only an iteration in which rank 0 decided something sends
        its decisions (`broadcast_optional`)."""
        plan = None
        if self._leader:
            if self._stop.is_set() or (self.draining
                                       and self.active_slots == 0):
                plan = {"stop": True, "expire": [], "admit": []}
            else:
                expire = [i for i, slot in enumerate(self.slots)
                          if slot is not None and self._lockstep
                          and self._timed_out(i)]
                admit = []
                free = [i for i, slot in enumerate(self.slots)
                        if slot is None]
                while free and not self.draining:
                    got = self._pick_admission()
                    if got is None:
                        break
                    if got:
                        req, key, rr = got
                        admit.append((req, key, rr, free.pop(0)))
                plan = {"stop": False, "expire": expire, "admit": admit}
        if not self._lockstep:
            return None if plan["stop"] else plan
        wire = None
        if self._leader and (plan["stop"] or plan["expire"]
                             or plan["admit"]):
            wire = dict(plan, admit=[
                (req.id, req.prompt, req.max_new_tokens, key,
                 rr.shared_pages, slot)
                for req, key, rr, slot in plan["admit"]])
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
            for rid, prompt, new, key, shared, slot in wire["admit"]:
                req = GenerationRequest(prompt, new, deadline_s=math.inf)
                req.id = rid
                self.mirrors[rid] = req
                rr = self.pool.reserve(
                    key, self._reserve_tokens(len(prompt), new),
                    tokens=(prompt.tolist() if self.config.share_prefixes
                            else None))
                if rr.shared_pages != shared:
                    raise ServingConfigError(
                        f"rank {rdist.process_index()} attached "
                        f"{rr.shared_pages} shared page(s) for request "
                        f"{rid}, rank 0 attached {shared}")
                self._materialize(key, prompt)
                plan["admit"].append((req, key, rr, slot))
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
        """Copy a prefilled batch-1 cache strip wholesale into the running
        batch at `slot_idx`, replacing whatever a previous occupant left
        (a copy: the batch's buffers are the captured step's, and a
        memoized strip stays as it was). On a mesh each rank writes the
        part of the row its own strips hold (`_copy_row`)."""
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
        # take, then release: whoever swaps the slot out owns the one
        # pool release of its key
        with self._teardown_lock:
            slot = self.slots[slot_idx]
            self.slots[slot_idx] = None
        if slot is not None:
            freed = self.pool.release(slot.seq_key)
            if slot.req.trace.sampled:
                slot.req.trace.event("kv_release", replica=self.name,
                                     pages=freed, **self.pool.snapshot())

    def _timed_out(self, slot_idx: int) -> bool:
        """Retire slot `slot_idx` if its request was answered elsewhere
        (aborted, requeued) or blew its deadline; whether it did. In
        lockstep only rank 0 asks (its clock and its requests decide) and
        the followers retire what it names (`_plan`)."""
        slot = self.slots[slot_idx]
        if self._lockstep and not self._leader:
            slot.req._finish(error=RequestShedError(
                f"request {slot.req.id} retired by rank 0",
                reason="leader"))
            self._release(slot_idx)
            return True
        if slot.req.done():  # aborted or requeued elsewhere
            self._release(slot_idx)
            return True
        if time.monotonic() > slot.req.deadline:
            _shed("deadline")
            self.stats["shed_decode"] += 1
            generated = len(slot.tokens) - slot.prompt_len
            slot.req.trace.shed("deadline", stage="decode",
                                replica=self.name, tokens=generated)
            slot.req._finish(error=DeadlineExceededError(
                f"request {slot.req.id} blew its deadline mid-decode after "
                f"{generated} token(s)", stage="decode"),
                generation=slot.generation)
            self._release(slot_idx)
            return True
        return False

    def _finish_slot(self, slot_idx: int) -> None:
        """Answer the slot's request (if this replica still owns it): the
        latency, TTFT-derived stages and SLO verdicts recorded; then
        release its pages."""
        from .. import obs

        slot = self.slots[slot_idx]
        generated = len(slot.tokens) - slot.prompt_len
        if slot.req._finish(tokens=np.asarray(slot.tokens, self._id_dt),
                            generation=slot.generation):
            obs.observe("ff_serving_latency_seconds",
                        time.monotonic() - slot.req.submitted_t,
                        help="end-to-end serving request latency")
            obs.count("ff_serving_requests_total",
                      help="serving requests answered")
            obs.count("ff_serving_tokens_total", generated,
                      help="tokens generated by the serving runtime")
            self.stats["finished"] += 1
            stages = record_request_stages(slot.req, generated=generated,
                                           slo=self.slo, replica=self.name)
            slot.req.trace.completed(
                self.name, generation=slot.generation, tokens=generated,
                **{f"{k}_s": round(v, 6) for k, v in stages.items()})
        self._release(slot_idx)

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
            self._finish_slot(slot_idx)

    # -- the iteration loop ------------------------------------------------
    def _decode_iteration(self) -> None:
        t_vec = np.zeros(self.config.slots, np.int32)
        toks = np.zeros((self.config.slots, 1), self._id_dt)
        active = []
        sampled_any = False
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            active.append(i)
            sampled_any = sampled_any or slot.req.trace.sampled
            t_vec[i] = slot.pos
            toks[i, 0] = slot.tokens[slot.pos]
            if self.config.share_prefixes:
                # this step writes K/V at slot.pos. Only full prompt pages
                # are published and decode writes land past them, so this
                # is a no-op in steady state; a shared page in the write
                # path would be copied private here first
                self.pool.note_write(slot.seq_key, slot.pos)
        span_t0 = time.perf_counter() if sampled_any else 0.0
        with self._device_lock:
            logits, self._caches = self._stepB(self.model.params,
                                               self._caches, t_vec, [toks])
            nxt = _argmax_last(logits[:, 0])
        span_dur = (time.perf_counter() - span_t0) if sampled_any else 0.0
        occupancy = len(active)
        for i in active:
            slot = self.slots[i]
            if slot is None:
                continue  # taken by a concurrent teardown sweep mid-step
            slot.tokens.append(int(nxt[i]))
            slot.pos += 1
            new_pages = self.pool.touch(
                slot.seq_key, max(self._bucket(slot.prompt_len), slot.pos))
            if slot.req.trace.sampled:
                slot.req.trace.iteration(
                    self.name, t0=span_t0, dur_s=span_dur,
                    iteration=self._iteration, slot=i, pos=slot.pos,
                    occupancy=occupancy)
                if new_pages:
                    slot.req.trace.event("kv_touch", replica=self.name,
                                         pages=len(new_pages), pos=slot.pos)
            self._maybe_retire(i)

    def _warmup_compiles(self) -> None:
        """Run the batched decode step and every prefill bucket once before
        taking traffic. The batched step runs on the caches the batch will
        use (they are made here): on a card that captures the one CUDA
        graph its steps replay, keyed by those caches' addresses (a
        position-0 write that every slot insertion overwrites). All under
        the device lock, so no sibling replica launches work meanwhile."""
        params = self.model.params
        with self._device_lock:
            if self._caches is None:
                self._caches = self._initB(params)
            self._stepB(params, self._caches,
                        np.zeros(self.config.slots, np.int32),
                        [np.zeros((self.config.slots, 1), self._id_dt)])
            b = 1
            while True:
                caches1 = self._init1(params)
                self._step1(params, caches1, 0,
                            [np.zeros((1, b), self._id_dt)])
                if b >= self.config.max_len:
                    break
                b = min(2 * b, self.config.max_len)

    def _strand_slots(self) -> int:
        """Hand every occupied slot back to the shared queue (or shed it
        typed when its deadline is gone): the dying replica's half of
        failover. The serve thread calls this on any dead exit, so a
        request admitted in the very window where the ReplicaSet declared
        the replica dead is still rescued. Safe from the ReplicaSet too
        (stuck-thread steal): slots are taken under the teardown mutex,
        so page refs transfer exactly once, and completion stays exactly
        once through the generation check."""
        from .. import obs

        requeued = 0
        for i in range(len(self.slots)):
            with self._teardown_lock:
                slot = self.slots[i]
                self.slots[i] = None
            if slot is None:
                continue
            self.pool.release(slot.seq_key)
            gen = slot.req._requeue_bump()
            if gen is None:
                continue  # finished meanwhile
            if time.monotonic() >= slot.req.deadline:
                _shed("deadline")
                slot.req.trace.shed("deadline", stage="failover",
                                    replica=self.name)
                slot.req._finish(error=DeadlineExceededError(
                    f"request {slot.req.id} expired during replica "
                    "failover", stage="failover"))
                continue
            slot.req.trace.requeued(self.name, generation=gen,
                                    tokens_done=len(slot.tokens)
                                    - slot.prompt_len)
            self.queue.requeue(slot.req)
            requeued += 1
        if requeued:
            self.stats["stranded_requeued"] += requeued
            obs.count("ff_serving_requeues_total", requeued,
                      help="in-flight requests requeued by failover")
        return requeued

    # -- online decode re-search (the StrategyTuner's serving leg) ---------
    def _note_admitted_plen(self, plen: int) -> None:
        """Feed one admission's prompt length into the drift watch; the
        first decode_retune_min_admissions requests freeze the baseline."""
        if not self.config.decode_retune:
            return
        self._plen_admissions += 1
        self._plen_ewma = (float(plen) if self._plen_ewma is None
                           else 0.8 * self._plen_ewma + 0.2 * float(plen))
        if (self._plen_at_build is None and self._plen_admissions
                >= self.config.decode_retune_min_admissions):
            self._plen_at_build = self._plen_ewma

    def _retune_wanted(self) -> bool:
        cfg = self.config
        if (not cfg.decode_retune
                or self._iteration < self._retune_cooldown_until
                or self._plen_at_build is None
                or self._plen_ewma is None
                or self._plen_admissions < cfg.decode_retune_min_admissions):
            return False
        base = max(1.0, self._plen_at_build)
        return abs(self._plen_ewma - base) / base > cfg.decode_retune_threshold

    def _retune_decode(self) -> None:
        """Re-run the decode-objective strategy search and swap the
        batched decode step in. Only called with an empty batch: the live
        caches belong to the outgoing lowering, so they are dropped (the
        next admission builds new ones), and so is the prefill memo. A
        candidate `_decode_executor_mismatch` refuses, or any failure,
        keeps the current step serving; every attempt lands in
        ff_strategy_swaps_total{leg="serving"}."""
        from .. import obs
        from ..parallel.decode import DecodeExactnessError, decode_fallback
        from .tuner import SWAP_METRIC, SWAP_METRIC_HELP

        cfg = self.config
        self._retune_cooldown_until = (self._iteration
                                       + cfg.decode_retune_cooldown_iters)
        obs.event("decode_retune_started", cat="serving", replica=self.name,
                  plen_ewma=round(self._plen_ewma or 0.0, 2),
                  plen_at_build=round(self._plen_at_build or 0.0, 2))
        outcome = "rolled_back"
        detail = None
        try:
            with self._device_lock:
                dex = self.model.compile_decode()
                initB_d, stepB_d = dex.build_decode(
                    cfg.slots, cfg.max_len, assume_causal=cfg.assume_causal)
                problem = self._decode_executor_mismatch(dex, initB_d)
                if problem is not None:
                    detail = problem
                    decode_fallback(self.name, "decode_retune_incompatible",
                                    problem)
                else:
                    self._initB, self._stepB = initB_d, stepB_d
                    self._caches = None  # rebuilt by the next admission
                    # memoized strips came from the old serving epoch
                    self._prefix_cache.clear()
                    self.decode_strategy_active = True
                    outcome = "committed"
        except DecodeExactnessError as e:
            detail = str(e)
            decode_fallback(self.name, "decode_retune_unbuildable", str(e))
        except Exception as e:  # a failed retune must not kill the replica
            detail = str(e)
            logger.warning("decode retune failed on %s; keeping the "
                           "current decode strategy: %s", self.name, e)
        # either way the drift baseline resets to what the decision saw
        self._plen_at_build = self._plen_ewma
        self.stats["decode_retunes"] += 1
        obs.count(SWAP_METRIC, help=SWAP_METRIC_HELP, outcome=outcome,
                  leg="serving")
        obs.event("decode_retune_finished", cat="serving",
                  replica=self.name, outcome=outcome,
                  **({"detail": detail[:200]} if detail else {}))

    def _serve_loop(self) -> None:
        from .. import obs

        try:
            device = self.model.executor.device
            if device.type == "cuda" and device.index is not None:
                # a thread starts on card 0: serve on the model's card
                torch.cuda.set_device(device)
            if self.config.precompile:
                with obs.span("serving_warmup", cat="serving",
                              replica=self.name):
                    self._warmup_compiles()
            while not self.dead:
                plan = self._plan()
                if plan is None:
                    break
                for req, seq_key, rr, slot_idx in plan["admit"]:
                    self._admit(req, seq_key, rr, slot_idx)
                if self.fault_injector is not None and \
                        self.fault_injector.fire(
                            "replica_death", self._iteration,
                            replica=self.name) is not None:
                    raise ReplicaDeathError(
                        f"replica {self.name} death injected at iteration "
                        f"{self._iteration}")
                if self.active_slots == 0:
                    if self._retune_wanted():
                        self._retune_decode()
                    elif not plan["admit"]:
                        time.sleep(self.config.idle_wait_s)
                    continue
                it = self._iteration
                if self.monitor is not None:
                    self.monitor.step_started(it)
                t0 = time.monotonic()
                if self.fault_injector is not None:
                    slow = self.fault_injector.fire("slow_worker", it,
                                                    replica=self.name)
                    if slow is not None:
                        # a wedged device: the iteration stalls inside the
                        # monitored step window, so the watchdog sees it
                        time.sleep(float(slow.get("delay_s", 1.0)))
                self._decode_iteration()
                dt = time.monotonic() - t0
                if self.monitor is not None:
                    self.monitor.step_finished(it)
                # each active sequence gains one token per iteration, so
                # the iteration's wall time is the per-token service time
                self._token_ewma_s = (dt if self._token_ewma_s is None
                                      else 0.8 * self._token_ewma_s
                                      + 0.2 * dt)
                self._iteration += 1
                self.stats["iterations"] += 1
                obs.gauge_set("ff_serving_batch_occupancy",
                              self.active_slots, help="occupied decode slots",
                              replica=self.name)
        except BaseException as e:  # the replica died: hand off and stop
            self.dead = True
            self.death_cause = e
            logger.exception("serving replica %s died", self.name)
            obs.event("replica_died", cat="serving", replica=self.name,
                      error=type(e).__name__, detail=str(e)[:300])
            self._strand_slots()
            if self.on_dead is not None:
                self.on_dead(self, e)
        else:
            # marked dead from outside (watchdog failover) mid-iteration:
            # what it still holds goes back to the queue
            if self.dead and not self._stop.is_set():
                self._strand_slots()


# ----------------------------------------------------------------------
# multi-replica failover and autoscaling
# ----------------------------------------------------------------------
@dataclasses.dataclass
class _Replica:
    name: str
    model: object
    batcher: ContinuousBatcher
    monitor: object  # runtime.elastic.HealthMonitor


class ReplicaSet:
    """N continuous-batching replicas off ONE shared admission queue, in
    one process.

    * **admission** happens once, at `submit`: the token bucket (optionally
      p95-adaptive), then the bounded queue; every refusal is typed and
      counted.
    * **health**: each replica gets a HealthMonitor watching its
      per-iteration step progress and a heartbeat probing its serve
      thread; a hung or dead replica fails over.
    * **failover**: the dead replica's in-flight requests go back to the
      front of the queue (generation-bumped, so the corpse cannot answer
      them; blown deadlines are shed typed) while siblings keep draining
      it, and a restart thread brings a replacement up: a **warm spare**
      when one is left (`warm_spares`: built and warmed at start, so
      activation is a restore of `_ensure_checkpoint`'s checkpoint), else
      a rebuild through `restore_elastic` when `ckpt_dir` is given (a
      fresh `model_fn()` otherwise), with exponential backoff and a
      budget of `max_replica_restarts`.
    * **autoscaling**: a queue depth of `scale_up_queue_depth`, or a
      sustained SLO violation rate (`SLOMonitor.should_scale_up`), adds a
      replica up to `max_replicas`; `scale_down_idle_s` of idle drains one
      down to `min_replicas`.
    * every replica and spare is built under `artifact_store.ambient()`,
      so `model_fn`'s compile() replays a stored strategy.

    * the fleet observatory: an anomaly sentinel watches the queue depth,
      latency and TTFT p95, the shed rate, KV occupancy and each
      replica's heartbeat gap every autoscale tick, and a scale-up names
      the anomaly behind it; with `fleet_spool_dir` every replica's
      counters and the set's own are spooled each tick
      (obs/fleet.py), and once more with a terminal status at a death,
      a scale-down or `stop`, so the fleet rollup conserves requests.

    Every replica shares one device lock. A process group of more than
    one rank is refused (ROADMAP queue 1 item 7)."""

    def __init__(self, model_fn: Callable[[], object],
                 config: ServingConfig, *,
                 replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 ckpt_dir: Optional[str] = None,
                 fault_injector=None,
                 health_timeout_s: float = 30.0,
                 compile_grace_s: Optional[float] = None,
                 max_replica_restarts: int = 3,
                 restart_backoff_s: float = 0.2,
                 warm_spares: int = 0,
                 scale_up_queue_depth: Optional[int] = None,
                 scale_down_idle_s: float = 10.0,
                 autoscale_interval_s: float = 0.25,
                 artifact_store=None,
                 fleet_spool_dir: Optional[str] = None):
        if rdist.process_count() > 1:
            raise NotImplementedError(
                f"ReplicaSet on a process group of "
                f"{rdist.process_count()} ranks: its replicas, queue and "
                "failover live in one process and are not run in "
                "lockstep across ranks yet (ROADMAP queue 1 item 7); serve "
                "a mesh with one ContinuousBatcher per rank")
        self.model_fn = model_fn
        self.config = config
        self.artifact_store = artifact_store
        self.min_replicas = max(1, replicas)
        self.max_replicas = max(self.min_replicas, max_replicas or replicas)
        self.ckpt_dir = ckpt_dir
        self.fault_injector = fault_injector
        self.health_timeout_s = health_timeout_s
        self.compile_grace_s = compile_grace_s
        self.max_replica_restarts = max(0, max_replica_restarts)
        self.restart_backoff_s = restart_backoff_s
        self.warm_spares = max(0, warm_spares)
        self._spares: List[ContinuousBatcher] = []
        # one device lock across every replica (and restart/restore work)
        self._device_lock = threading.RLock()
        self.scale_up_queue_depth = (scale_up_queue_depth
                                     or 2 * config.slots)
        self.scale_down_idle_s = scale_down_idle_s
        self.autoscale_interval_s = autoscale_interval_s
        self.queue = AdmissionQueue(config.max_queue_depth)
        self.bucket: Optional[TokenBucket] = None
        if config.rate_limit is not None:
            self.bucket = TokenBucket(config.rate_limit, config.rate_burst)
        # one SLO monitor across the set: the batchers' _finish_slot feed
        # it, the autoscaler and adaptive admission read it
        self.slo = SLOMonitor(ttft_target_s=config.slo_ttft_s,
                              latency_p99_target_s=config.slo_p99_s)
        self._lock = threading.Lock()
        self._replicas: Dict[str, _Replica] = {}
        # each failed replica's last stats, pool audit and death time
        # (time.monotonic()), by name (`aggregate_stats()["retired"]`)
        self.retired: Dict[str, dict] = {}
        self._counter = 0
        self._restarts = 0
        self._pending_restarts = 0
        self._closed = False
        self._started = False
        self._scaler: Optional[threading.Thread] = None
        self._scaler_stop = threading.Event()
        self._idle_since: Optional[float] = None
        self._rate_check = 0
        from ..obs.metrics import Histogram

        # local latency reservoir: the adaptive bucket reads p95 without
        # a telemetry session
        self.latency = Histogram(threading.Lock())
        self.stats = {"submitted": 0, "requeued": 0, "restarts": 0,
                      "spares_used": 0, "scale_ups": 0, "scale_downs": 0,
                      "cold_start_s": []}
        # fleet observatory (obs/fleet.py, obs/anomaly.py)
        from ..obs.anomaly import AnomalySentinel

        self.sentinel = AnomalySentinel()
        self.fleet_spool_dir = fleet_spool_dir
        self._spools: Dict[str, object] = {}
        # replica name -> (iterations seen, monotonic time it changed)
        self._progress: Dict[str, Tuple[int, float]] = {}
        self._shed_seen = 0.0

    # -- fleet observatory -----------------------------------------------
    @staticmethod
    def _series_rec(name: str, kind: str, value) -> dict:
        if kind == "histogram":
            return {"name": name, "kind": kind, "labels": {},
                    "state": value}
        return {"name": name, "kind": kind, "labels": {},
                "value": float(value)}

    def _replica_series(self, batcher: ContinuousBatcher) -> List[dict]:
        st = batcher.stats
        snap = batcher.pool.snapshot()
        rec = self._series_rec
        return [
            rec("ff_serving_requests_total", "counter", st["finished"]),
            rec("ff_serving_admitted_total", "counter", st["admitted"]),
            rec("ff_serving_prefills_total", "counter", st["prefills"]),
            rec("ff_serving_shed_decode_total", "counter",
                st["shed_decode"]),
            rec("ff_serving_stranded_requeued_total", "counter",
                st["stranded_requeued"]),
            rec("ff_serving_active_slots", "gauge", batcher.active_slots),
            rec("ff_kv_pages_in_use", "gauge", snap["pages_in_use"]),
            rec("ff_kv_pages_shared", "gauge", snap["pages_shared"]),
        ]

    def _write_replica_spool(self, batcher: ContinuousBatcher,
                             status: str = "live") -> None:
        if self.fleet_spool_dir is None:
            return
        from ..obs.fleet import MetricSpool

        sp = self._spools.get(batcher.name)
        if sp is None:
            sp = MetricSpool(self.fleet_spool_dir, batcher.name,
                             replica=batcher.name)
            self._spools[batcher.name] = sp
        try:
            sp.write(series=self._replica_series(batcher), status=status)
        except OSError as e:
            logger.warning("fleet spool write for %s failed (%s)",
                           batcher.name, e)

    def _write_set_spool(self, status: str = "live") -> None:
        if self.fleet_spool_dir is None:
            return
        from ..obs.fleet import MetricSpool

        sp = self._spools.get("replicaset")
        if sp is None:
            sp = MetricSpool(self.fleet_spool_dir, "replicaset")
            self._spools["replicaset"] = sp
        st = self.stats
        rec = self._series_rec
        series = [
            rec("ff_serving_submitted_total", "counter", st["submitted"]),
            rec("ff_serving_requeued_total", "counter", st["requeued"]),
            rec("ff_replica_restarts_total", "counter", st["restarts"]),
            rec("ff_replica_scale_ups_total", "counter", st["scale_ups"]),
            rec("ff_serving_queue_depth", "gauge", len(self.queue)),
            rec("ff_serving_replicas", "gauge", self.replica_count()),
            rec("ff_serving_latency_seconds", "histogram",
                self.latency.state()),
        ]
        try:
            sp.write(series=series, status=status)
        except OSError as e:
            logger.warning("fleet replicaset spool write failed (%s)", e)

    def _observe_fleet(self, depth: int) -> None:
        """One autoscale tick of sentinel feeding and spool refresh.
        Hysteresis 1: the tick already integrates over the interval, and
        the scale-up wants the anomaly tag the tick the pressure appears.
        Absolute min_delta floors: a queue depth of 1 against an all-zero
        baseline is not an incident, a slots-sized jump is. Direction
        "high": a draining queue or falling latency is recovery, and a
        recovery-tagged detector in cooldown would mask the next real
        spike from the scale-up's blame window."""
        now = time.monotonic()
        s = self.sentinel
        s.observe("queue_depth", float(depth),
                  min_delta=float(self.config.slots), hysteresis=1,
                  direction="high")
        if self.latency.count >= 8:
            s.observe("serving_latency_p95", self.latency.quantile(0.95),
                      min_delta=0.1, hysteresis=1, direction="high")
        if self.slo.ttft.count >= 8:
            s.observe("ttft_p95", self.slo.ttft.quantile(0.95),
                      min_delta=0.05, hysteresis=1, direction="high")
        with self._lock:
            reps = list(self._replicas.values())
        shed = 0.0
        occupancy = 0.0
        for r in reps:
            b = r.batcher
            shed += b.stats["shed_decode"]
            snap = b.pool.snapshot()
            occupancy = max(occupancy, snap["pages_in_use"]
                            / max(1, b.pool.config.num_pages))
            it = b.stats["iterations"]
            last = self._progress.get(b.name)
            if last is None or last[0] != it:
                self._progress[b.name] = (it, now)
            elif b.thread_alive():
                s.observe_gap(f"replica_heartbeat:{b.name}",
                              now - last[1],
                              limit_s=self.health_timeout_s)
            self._write_replica_spool(b)
        if reps:
            s.observe("kv_occupancy", occupancy, min_delta=0.2,
                      hysteresis=1, direction="high")
        delta = max(0.0, shed - self._shed_seen)
        self._shed_seen = shed
        s.observe("shed_rate",
                  delta / max(self.autoscale_interval_s, 1e-6),
                  min_delta=1.0, hysteresis=1, direction="high")
        self._write_set_spool()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ReplicaSet":
        if self._started:
            return self
        self._started = True
        # spares first, built and warmed while nothing serves, so a
        # failover in the very first iteration finds them ready
        for i in range(self.warm_spares):
            t0 = time.perf_counter()
            with self._device_lock, self._store_scope():
                model = self.model_fn()
            self.stats["cold_start_s"].append(time.perf_counter() - t0)
            batcher = self._new_batcher(model, name=f"spare{i}")
            batcher._warmup_compiles()
            with self._lock:
                self._spares.append(batcher)
        for _ in range(self.min_replicas):
            self._add_replica()
        if self.ckpt_dir is not None:
            self._ensure_checkpoint()
        self._scaler = threading.Thread(target=self._autoscale_loop,
                                        daemon=True,
                                        name="ff-serve-autoscaler")
        self._scaler.start()
        return self

    def stop(self, timeout: float = 15.0, abort_pending: bool = True) -> None:
        self._closed = True
        self._scaler_stop.set()
        if self._scaler is not None:
            self._scaler.join(timeout=2.0)
        deadline = time.monotonic() + timeout
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            rep.batcher.draining = True
        while time.monotonic() < deadline:
            if len(self.queue) == 0 and all(
                    r.batcher.active_slots == 0 for r in reps):
                break
            time.sleep(0.02)
        if abort_pending:
            self.queue.drain(lambda req: RequestShedError(
                f"request {req.id} aborted: serving shut down",
                reason="aborted"))
        for rep in reps:
            rep.batcher.stop(timeout=5.0)
            for slot_idx, slot in enumerate(rep.batcher.slots):
                if slot is not None and abort_pending:
                    if slot.req._finish(error=RequestShedError(
                            f"request {slot.req.id} aborted: serving shut "
                            "down", reason="aborted"),
                            generation=slot.generation):
                        _shed("aborted")
                    rep.batcher._release(slot_idx)
            rep.monitor.stop()
            # final spool after the serve thread stopped: the tallies are
            # final, so the fleet rollup conserves counters exactly
            self._write_replica_spool(rep.batcher, status="exited")
        self._write_set_spool(status="exited")

    # -- replica management ----------------------------------------------
    def _store_scope(self):
        """The ambient-store context every replica and spare build runs
        under; a no-op without a store."""
        if self.artifact_store is not None:
            return self.artifact_store.ambient()
        return contextlib.nullcontext()

    def _build_model(self, *, elastic: bool):
        t0 = time.perf_counter()
        try:
            with self._device_lock, self._store_scope():
                if elastic and self.ckpt_dir is not None:
                    from .elastic import ElasticRestoreError, restore_elastic

                    try:
                        model, _info = restore_elastic(self.model_fn,
                                                       self.ckpt_dir,
                                                       verbose=False)
                        return model
                    except ElasticRestoreError:
                        pass  # nothing restorable: a fresh build below
                return self.model_fn()
        finally:
            self.stats["cold_start_s"].append(time.perf_counter() - t0)

    def _new_batcher(self, model,
                     name: Optional[str] = None) -> ContinuousBatcher:
        if name is None:
            with self._lock:
                name = f"replica{self._counter}"
                self._counter += 1
        return ContinuousBatcher(
            model, self.config, self.queue, name=name,
            fault_injector=self.fault_injector,
            on_dead=self._on_batcher_dead,
            device_lock=self._device_lock,
            slo=self.slo)

    def _activate(self, batcher: ContinuousBatcher) -> _Replica:
        from . import elastic as el
        from .. import obs

        monitor = el.HealthMonitor(
            timeout_s=self.health_timeout_s,
            compile_grace_s=self.compile_grace_s,
            heartbeat_fn=self._thread_heartbeat(batcher),
            heartbeat_interval_s=max(0.05, self.health_timeout_s / 4.0),
            on_hang=lambda info, b=batcher: self._on_hang(b, info))
        batcher.monitor = monitor
        rep = _Replica(name=batcher.name, model=batcher.model,
                       batcher=batcher, monitor=monitor)
        with self._lock:
            self._replicas[rep.name] = rep
        monitor.start()
        batcher.start()
        obs.event("replica_started", cat="serving", replica=rep.name)
        obs.gauge_set("ff_serving_replicas", self.replica_count(),
                      help="live serving replicas")
        return rep

    def _take_spare(self) -> Optional[ContinuousBatcher]:
        """A warm spare whose mesh still matches the live topology, with
        the latest checkpoint restored onto it; a stale spare is
        dropped."""
        while True:
            with self._lock:
                if not self._spares:
                    return None
                batcher = self._spares.pop()
            if batcher.model.executor.mesh_is_live():
                if self.ckpt_dir is not None:
                    from .resilience import CheckpointManager

                    with self._device_lock:
                        CheckpointManager(self.ckpt_dir).restore_latest(
                            batcher.model, elastic=True)
                return batcher

    def _add_replica(self, *, elastic: bool = False,
                     allow_spare: bool = False) -> _Replica:
        if allow_spare:
            spare = self._take_spare()
            if spare is not None:
                self.stats["spares_used"] += 1
                return self._activate(spare)
        return self._activate(self._new_batcher(
            self._build_model(elastic=elastic)))

    def _thread_heartbeat(self, batcher: ContinuousBatcher):
        """A heartbeat probing the serve thread: a beat that finds it dead
        (crashed outside the step window) names it as a straggler, which
        escalates through on_hang."""

        def beat() -> Optional[list]:
            if batcher.dead or (
                    batcher._thread is not None
                    and not batcher._thread.is_alive()
                    and not batcher._stop.is_set()):
                return [batcher.name]
            return None

        return beat

    def _ensure_checkpoint(self) -> None:
        """Save the first replica's weights at step 0 when `ckpt_dir`
        holds no checkpoint: what spares and rebuilds restore, so every
        replica serves the same weights."""
        from .resilience import CheckpointManager

        mgr = CheckpointManager(self.ckpt_dir)
        if mgr.latest_step() is None:
            with self._lock:
                rep = next(iter(self._replicas.values()), None)
            if rep is not None:
                with self._device_lock:
                    mgr.save(rep.model, step=0,
                             extra_meta={"serving": {"replica": rep.name}})

    def replica_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values()
                       if r.batcher.thread_alive())

    def replica_names(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    # -- failover --------------------------------------------------------
    def _on_hang(self, batcher: ContinuousBatcher, info: dict) -> None:
        from .. import obs

        obs.event("replica_hang", cat="serving", replica=batcher.name,
                  **{k: v for k, v in info.items() if k != "step"})
        self._fail_replica(batcher, ReplicaDeathError(
            f"replica {batcher.name} hung: {info.get('kind', 'unknown')}"))

    def _on_batcher_dead(self, batcher: ContinuousBatcher,
                         exc: BaseException) -> None:
        self._fail_replica(batcher, exc)

    def _fail_replica(self, batcher: ContinuousBatcher,
                      exc: BaseException) -> None:
        """Take a replica out of rotation and restart it in the
        background. Idempotent: the watchdog and the serve loop may both
        report one death. Rescuing the slots is the serve thread's job
        (`_strand_slots` on its dead exit); only a thread wedged past a
        grace join has its slots stolen from here."""
        from .. import obs

        with self._lock:
            rep = self._replicas.pop(batcher.name, None)
            # the restart is reserved as the replica leaves rotation: the
            # autoscaler counts pending restarts as capacity, and a gap
            # here (the forensics below take tens of ms) let a tick with
            # the requeued requests in the queue scale up on top of it
            restarts = None
            if rep is not None and not self._closed and \
                    self._restarts < self.max_replica_restarts:
                self._restarts += 1
                self._pending_restarts += 1
                restarts = self._restarts
        if rep is None:
            return  # already handled
        started = False
        try:
            died_t = time.monotonic()
            batcher.dead = True
            rep.monitor.stop()
            if batcher._thread is not None and (
                    batcher._thread is not threading.current_thread()):
                batcher._thread.join(timeout=5.0)
                if batcher._thread.is_alive():
                    logger.warning("replica %s thread is wedged; stealing its "
                                   "in-flight slots", batcher.name)
                    batcher._strand_slots()
            requeued = batcher.stats["stranded_requeued"]
            self.stats["requeued"] += requeued
            logger.warning("replica %s failed (%s: %s); requeued %d in-flight "
                           "request(s)", batcher.name, type(exc).__name__, exc,
                           requeued)
            obs.event("replica_failover", cat="serving", replica=batcher.name,
                      requeued=requeued, error=type(exc).__name__,
                      detail=str(exc)[:300], died_t=died_t)
            obs.gauge_set("ff_serving_replicas", self.replica_count(),
                          help="live serving replicas")
            try:
                kv_pool: dict = {"snapshot": batcher.pool.snapshot(),
                                 "audit": batcher.pool.audit().to_dict()}
            except Exception as e:  # forensics only
                kv_pool = {"error": f"{type(e).__name__}: {e}"}
            self.retired[batcher.name] = {
                "died_t": died_t, "error": type(exc).__name__,
                "requeued": requeued, "stats": dict(batcher.stats),
                "kv_pool_audit": kv_pool.get("audit", kv_pool)}
            obs.forensics_dump("replica_death", error=exc,
                               replica=batcher.name, requeued=requeued,
                               stats=dict(batcher.stats), kv_pool=kv_pool)
            # terminal spool: the fleet rollup keeps this replica's final
            # tallies (counter conservation through the kill) and reads the
            # explicit "dead" status without waiting out the age window
            self._write_replica_spool(batcher, status="dead")
            self._spools.pop(batcher.name, None)
            if restarts is None:
                if not self._closed:
                    obs.event("replica_restart_budget_exhausted",
                              cat="serving", replica=batcher.name,
                              restarts=self._restarts)
                return
            if not self._closed:
                threading.Thread(
                    target=self._restart_replica,
                    args=(batcher.name, restarts), daemon=True,
                    name=f"ff-serve-restart-{batcher.name}").start()
                started = True
        finally:
            if restarts is not None and not started:
                # closed meanwhile, or the teardown above raised: the
                # reserved restart never runs, so it holds no capacity
                with self._lock:
                    self._restarts -= 1
                    self._pending_restarts -= 1

    @staticmethod
    def pool_release_quiet(batcher: ContinuousBatcher, slot: _Slot) -> None:
        # sweeps that race the serve loop's own release pass missing_ok,
        # so the typed double-release guard stays armed for real bugs
        try:
            batcher.pool.release(slot.seq_key, missing_ok=True)
        except Exception:  # best-effort cleanup
            pass

    def _restart_replica(self, dead_name: str, attempt: int) -> None:
        from .. import obs

        time.sleep(self.restart_backoff_s * (2.0 ** (attempt - 1)))
        try:
            rep = self._add_replica(elastic=True, allow_spare=True)
        except BaseException as e:
            logger.exception("restart of dead replica %s failed", dead_name)
            obs.event("replica_restart_failed", cat="serving",
                      replica=dead_name, error=type(e).__name__,
                      detail=str(e)[:300])
            return
        finally:
            with self._lock:
                self._pending_restarts -= 1
        self.stats["restarts"] += 1
        obs.count("ff_replica_restarts_total",
                  help="serving replicas restarted after death/hang")
        obs.event("replica_restarted", cat="serving", dead=dead_name,
                  replacement=rep.name, attempt=attempt,
                  elastic=self.ckpt_dir is not None)

    # -- autoscaling -----------------------------------------------------
    def _autoscale_loop(self) -> None:
        from .. import obs

        while not self._scaler_stop.wait(self.autoscale_interval_s):
            depth = len(self.queue)
            self._observe_fleet(depth)
            with self._lock:
                pending = self._pending_restarts
            # replicas mid-restart count toward capacity: scaling up to
            # replace one failover is already replacing over-provisions
            n = self.replica_count() + pending
            slo_pressure = self.slo.should_scale_up()
            if ((depth >= self.scale_up_queue_depth or slo_pressure)
                    and n < self.max_replicas):
                try:
                    rep = self._add_replica(allow_spare=True)
                except BaseException as e:
                    obs.event("replica_scale_up_failed", cat="serving",
                              error=type(e).__name__, detail=str(e)[:300])
                    continue
                self.stats["scale_ups"] += 1
                # the sentinel saw this tick's observations already
                # (_observe_fleet runs first), so the pressure behind this
                # scale-up is in its blame window
                blame = self.sentinel.blame(
                    max_age_s=max(5.0, 20 * self.autoscale_interval_s))
                obs.event("replica_scale_up", cat="serving",
                          replica=rep.name, queue_depth=depth,
                          cause=("slo" if slo_pressure
                                 and depth < self.scale_up_queue_depth
                                 else "queue_depth"),
                          anomaly=blame or "",
                          slo_violation_rate=round(
                              self.slo.violation_rate(), 4))
                self._idle_since = None
                continue
            with self._lock:
                reps = list(self._replicas.values())
            if depth > 0 or any(r.batcher.active_slots for r in reps):
                self._idle_since = None
                continue
            if n <= self.min_replicas:
                continue
            now = time.monotonic()
            if self._idle_since is None:
                self._idle_since = now
                continue
            if now - self._idle_since >= self.scale_down_idle_s:
                self._scale_down_one()
                self._idle_since = None

    def _scale_down_one(self) -> None:
        from .. import obs

        with self._lock:
            victims = [r for r in self._replicas.values()
                       if r.batcher.thread_alive()]
            if len(victims) <= self.min_replicas:
                return
            rep = victims[-1]
            del self._replicas[rep.name]
        # drain, don't kill: draining stops admissions and the loop exits
        # once the last slot retires; stragglers past the grace window
        # are requeued as on failover
        rep.batcher.draining = True
        grace = time.monotonic() + 30.0
        while rep.batcher.active_slots and time.monotonic() < grace:
            time.sleep(0.02)
        for i in range(len(rep.batcher.slots)):
            with rep.batcher._teardown_lock:
                slot = rep.batcher.slots[i]
                rep.batcher.slots[i] = None
            if slot is None:
                continue
            gen = slot.req._requeue_bump()
            self.pool_release_quiet(rep.batcher, slot)
            if gen is not None:
                slot.req.trace.requeued(rep.name, generation=gen,
                                        scale_down=True)
                self.queue.requeue(slot.req)
                self.stats["requeued"] += 1
        rep.batcher.stop(timeout=5.0)
        rep.monitor.stop()
        self.stats["scale_downs"] += 1
        self._write_replica_spool(rep.batcher, status="exited")
        self._spools.pop(rep.name, None)
        obs.event("replica_scale_down", cat="serving", replica=rep.name)
        obs.gauge_set("ff_serving_replicas", self.replica_count(),
                      help="live serving replicas")

    # -- client API ------------------------------------------------------
    def _latency_p95(self) -> float:
        from .. import obs

        # the SLO monitor's window holds every completed request, not only
        # blocking generate() callers: the preferred signal when fed
        if self.slo.sample_count > 0:
            q = self.slo.latency_quantile(0.95)
            if q == q:
                return q
        tel = obs.active()
        if tel is not None:
            h = tel.metrics.find("ff_serving_latency_seconds")
            if h is not None and getattr(h, "count", 0):
                return h.quantile(0.95)
        return self.latency.quantile(0.95)

    def submit(self, prompt: np.ndarray, *,
               max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None) -> GenerationRequest:
        """Admission-controlled enqueue. Raises (typed, counted)
        RateLimitedError, QueueFullError or DeadlineExceededError; a
        returned request ends in a result or a typed error."""
        if self._closed or not self._started:
            raise ServingConfigError(
                "ReplicaSet is not accepting requests (call start(); not "
                "after stop())")
        req = GenerationRequest(
            prompt,
            max_new_tokens if max_new_tokens is not None
            else self.config.default_max_new_tokens,
            deadline_s=(deadline_s if deadline_s is not None
                        else self.config.default_deadline_s))
        req.trace = mint_request_trace(req.id)
        if self.bucket is not None:
            if self.config.adaptive_rate:
                self._rate_check += 1
                if self._rate_check % 16 == 0:
                    self.bucket.adapt(self._latency_p95(),
                                      self.config.target_p95_s)
            if not self.bucket.try_acquire():
                err = RateLimitedError(
                    f"request {req.id} rate-limited "
                    f"({self.bucket.rate:.1f} req/s)")
                _shed("rate_limited")
                req.trace.shed("rate_limited", stage="submit")
                req._finish(error=err)
                raise err
        self.queue.offer(req)  # sheds typed on full/dead on arrival
        self.stats["submitted"] += 1
        return req

    def generate(self, prompt: np.ndarray, *,
                 max_new_tokens: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 timeout: Optional[float] = None) -> np.ndarray:
        """Blocking submit and result; feeds the local latency reservoir
        the adaptive rate limiter reads."""
        req = self.submit(prompt, max_new_tokens=max_new_tokens,
                          deadline_s=deadline_s)
        out = req.result(timeout)
        self.latency.observe(time.monotonic() - req.submitted_t)
        return out

    def queue_depth(self) -> int:
        return len(self.queue)

    def aggregate_stats(self) -> dict:
        with self._lock:
            reps = list(self._replicas.values())
        agg = dict(self.stats)
        agg["replicas"] = {r.name: dict(r.batcher.stats) for r in reps}
        agg["queue_depth"] = len(self.queue)
        # beside JAX's keys: each live replica's pool audit, and the
        # replicas that failed (`retired`)
        agg["kv_pool_audits"] = {r.name: r.batcher.pool.audit().to_dict()
                                 for r in reps}
        agg["retired"] = {n: dict(v) for n, v in self.retired.items()}
        return agg


# ----------------------------------------------------------------------
# dynamic batching of single-shot forwards
# ----------------------------------------------------------------------
class InferenceRequest:
    def __init__(self, inputs: List[np.ndarray],
                 deadline: Optional[float] = None):
        self.id = uuid.uuid4().hex
        self.inputs = inputs
        self.deadline = deadline  # absolute monotonic; None = no deadline
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class BatchScheduler:
    """Dynamic batcher of single-shot forward requests: requests are
    packed (the tail padded with the last row) to the compiled batch and
    run through the executor's forward.

    `max_delay_s`: how long to wait to fill a batch before running a
    partial one. `infer` raises a typed InferenceTimeout (retried under
    `retry_policy`); when the worker thread is dead it runs the request
    unbatched on the caller's thread (DEGRADED: slower, but up). A
    crashed worker restarts up to `max_worker_restarts` times with
    exponential backoff (`restart_backoff_s` base), the state under one
    lock; once the budget is spent the scheduler stays degraded. The
    ``serving_worker`` fault site kills the worker. A request still
    queued past its deadline is shed at dequeue (DeadlineExceededError,
    counted) and never runs; `max_queue_depth` bounds the queue
    (QueueFullError)."""

    def __init__(self, model, *, max_delay_s: float = 0.005,
                 retry_policy=None, fault_injector=None,
                 max_worker_restarts: int = 3,
                 restart_backoff_s: float = 0.25,
                 max_queue_depth: Optional[int] = None):
        if model.executor is None:
            raise NotCompiledError("compile() the model first")
        from .resilience import RetryPolicy

        self.model = model
        self.batch_size = model.executor.input_pts[0].material_shape()[0]
        self.max_delay_s = max_delay_s
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=2, base_delay_s=0.01, max_delay_s=0.5)
        self.fault_injector = fault_injector
        self.max_worker_restarts = max(0, max_worker_restarts)
        self.restart_backoff_s = restart_backoff_s
        self.max_queue_depth = max_queue_depth
        self._q: "queue.Queue[InferenceRequest]" = queue.Queue()
        self._fwd = model.executor.build_forward()
        self._device_lock = threading.Lock()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="ff-batch-worker")
        self._started = False
        self._worker_error: Optional[BaseException] = None
        # guards the restart state (_worker_error, _next_restart_t and the
        # worker_restarts stat), which the worker and every infer() race on
        self._restart_lock = threading.Lock()
        self._next_restart_t = 0.0
        self.stats = {"requests": 0, "batches": 0, "padded_slots": 0,
                      "degraded": 0, "timeouts": 0, "worker_restarts": 0,
                      "shed": 0, "degraded_retries": 0}

    def start(self):
        if not self._started:
            self._worker.start()
            self._started = True
        return self

    def stop(self):
        self._stop.set()
        if self._started:
            self._worker.join(timeout=5)

    def worker_alive(self) -> bool:
        return (self._started and self._worker.is_alive()
                and self._worker_error is None)

    def _maybe_restart_worker(self) -> bool:
        """Start a fresh worker after a crash once the backoff window has
        passed, at most `max_worker_restarts` times. True when a live
        worker is there (already, or just restarted); False keeps the
        caller on the degraded path."""
        if self.worker_alive():
            return True
        if not self._started or self._stop.is_set():
            return False
        with self._restart_lock:
            if self.worker_alive():  # another caller restarted it
                return True
            if self.stats["worker_restarts"] >= self.max_worker_restarts:
                return False  # budget spent: stay degraded
            if time.monotonic() < self._next_restart_t:
                return False  # still backing off
            self.stats["worker_restarts"] += 1
            from .. import obs

            obs.count("ff_serving_worker_restarts_total",
                      help="serving worker threads restarted after crash")
            obs.event("serving_worker_restart", cat="serving",
                      restarts=self.stats["worker_restarts"])
            self._worker_error = None
            self._worker = threading.Thread(target=self._loop, daemon=True,
                                            name="ff-batch-worker")
            self._worker.start()
            return True

    def submit(self, inputs: List[np.ndarray],
               deadline: Optional[float] = None) -> InferenceRequest:
        """Each request carries ONE sample per model input (no batch
        axis). `deadline` is absolute time.monotonic(): past it the
        worker sheds the request, typed."""
        if (self.max_queue_depth is not None
                and self._q.qsize() >= self.max_queue_depth):
            self.stats["shed"] += 1
            _shed("queue_full")
            raise QueueFullError(
                f"BatchScheduler queue at capacity ({self.max_queue_depth})")
        req = InferenceRequest([np.asarray(a) for a in inputs],
                               deadline=deadline)
        self._q.put(req)
        return req

    def infer(self, inputs: List[np.ndarray],
              timeout: float = 30.0) -> np.ndarray:
        """Blocking single-sample inference. A timeout raises
        InferenceTimeout, retried per `retry_policy`; a dead worker
        degrades to direct unbatched execution; a request whose deadline
        passes while queued is shed (DeadlineExceededError: not retried,
        not run)."""
        from .. import obs
        from .resilience import InferenceTimeout, retry

        t_start = time.perf_counter()
        deadline = time.monotonic() + timeout

        def attempt():
            if not self._maybe_restart_worker():
                return self._infer_direct(inputs)
            req = self.submit(inputs, deadline=deadline)
            if not req.event.wait(timeout):
                self.stats["timeouts"] += 1
                if not self.worker_alive():
                    # died while we waited: the queue will never answer
                    return self._degraded_retry(req, inputs)
                raise InferenceTimeout(
                    f"request {req.id} unanswered after {timeout}s "
                    f"(queue depth {self._q.qsize()})")
            if req.error is not None:
                if isinstance(req.error, RequestShedError):
                    raise req.error  # shed on purpose: never re-run
                # the worker failed on this batch: answer degraded
                return self._degraded_retry(req, inputs)
            return req.result

        try:
            out = retry(attempt, self.retry_policy)
        except BaseException:
            obs.count("ff_serving_errors_total",
                      help="serving requests that failed after retries")
            raise
        obs.observe("ff_serving_latency_seconds",
                    time.perf_counter() - t_start,
                    help="end-to-end serving request latency")
        obs.count("ff_serving_requests_total",
                  help="serving requests answered")
        return out

    def _degraded_retry(self, req: InferenceRequest,
                        inputs: List[np.ndarray]) -> np.ndarray:
        """An in-flight request orphaned by a worker death, re-run on the
        degraded path (counted, and an event)."""
        from .. import obs

        self.stats["degraded_retries"] += 1
        obs.count("ff_serving_degraded_retries_total",
                  help="in-flight requests re-run unbatched after a "
                       "worker death")
        obs.event("serving_degraded_retry", cat="serving", request=req.id,
                  error=type(req.error).__name__ if req.error else "orphaned")
        return self._infer_direct(inputs)

    def _run(self, arrays: List[np.ndarray]) -> np.ndarray:
        """The compiled forward over one full batch, on the host in
        float32."""
        with self._device_lock:
            out = self._fwd(self.model.params, arrays,
                            self.model.state.net_state)
            return _host_rows(out)

    def _infer_direct(self, inputs: List[np.ndarray]) -> np.ndarray:
        """DEGRADED mode: one request on the caller's thread, broadcast
        to the compiled batch (the same forward, no queue)."""
        self.stats["degraded"] += 1
        arrays = [np.ascontiguousarray(np.broadcast_to(
            np.asarray(a)[None], (self.batch_size,) + np.asarray(a).shape))
            for a in inputs]
        return self._run(arrays)[0]

    def _shed_if_expired(self, req: InferenceRequest) -> bool:
        """Dequeue-time deadline check: a request whose caller gave up
        never reaches the device."""
        if req.deadline is None or time.monotonic() < req.deadline:
            return False
        self.stats["shed"] += 1
        _shed("deadline")
        req.error = DeadlineExceededError(
            f"request {req.id} expired while queued", stage="dequeue")
        req.event.set()
        return True

    def _loop(self):
        n_inputs = len(self.model.executor.input_pts)
        device = self.model.executor.device
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        while not self._stop.is_set():
            batch: List[InferenceRequest] = []
            try:
                got = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if not self._shed_if_expired(got):
                batch.append(got)
            fill_by = time.monotonic() + self.max_delay_s
            while len(batch) < self.batch_size:
                remaining = fill_by - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    got = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if not self._shed_if_expired(got):
                    batch.append(got)
            if not batch:
                continue
            try:
                if self.fault_injector is not None:
                    self.fault_injector.fire("serving_worker",
                                             self.stats["batches"])
                pad = self.batch_size - len(batch)
                arrays = []
                for i in range(n_inputs):
                    rows = [r.inputs[i] for r in batch]
                    arrays.append(np.stack(rows + [rows[-1]] * pad, axis=0))
                out = self._run(arrays)
            except BaseException as e:
                # the worker is no longer trusted: fail the in-flight
                # requests (their callers re-run degraded) and exit, the
                # backoff published under the restart lock
                with self._restart_lock:
                    self._worker_error = e
                    self._next_restart_t = time.monotonic() + (
                        self.restart_backoff_s
                        * (2.0 ** self.stats["worker_restarts"]))
                for r in batch:
                    r.error = e
                    r.event.set()
                return
            for j, r in enumerate(batch):
                r.result = out[j]
                r.event.set()
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            self.stats["padded_slots"] += pad
