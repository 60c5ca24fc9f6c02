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

Not ported yet: fault injection, the health monitor, SLO tracking, decode
re-search, the prefix-sharing page pool and prefill-skip memo, fleet
spools, ReplicaSet and BatchScheduler.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..parallel.executor import _tensors
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
                          device=tensors[0].device)
    with torch.no_grad():
        for c in tensors:
            c.copy_(c.index_select(0, idx))


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
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def offer(self, req: GenerationRequest) -> None:
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

    Decoder-only models only (one graph input)."""

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

    def _try_admit_one(self) -> bool:
        req = self.queue.poll(timeout=0.0)
        if req is None:
            return False
        plen = len(req.prompt)
        if plen < 1 or plen + req.max_new_tokens > self.config.max_len:
            req._finish(error=RequestShedError(
                f"request {req.id}: prompt {plen} + max_new "
                f"{req.max_new_tokens} exceeds max_len {self.config.max_len}",
                reason="too_long"))
            return True
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
                return True
            self.queue.requeue(req)  # backpressure: wait for retirements
            return False
        slot_idx = self.slots.index(None)
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
        return True

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
        batch at `slot_idx`, replacing whatever a previous occupant left."""
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
                c[slot_idx].copy_(row[0])
            for opname, (kB, vB) in self._caches["mha"].items():
                k1, v1 = caches1["mha"][opname]
                kB[slot_idx].copy_(k1[0])
                vB[slot_idx].copy_(v1[0])

    # -- retirement --------------------------------------------------------
    def _release(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        self.slots[slot_idx] = None
        if slot is not None:
            self.pool.release(slot.seq_key)

    def _maybe_retire(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        if slot is None:
            return
        if slot.req.done():  # aborted elsewhere
            self._release(slot_idx)
            return
        generated = len(slot.tokens) - slot.prompt_len
        if time.monotonic() > slot.req.deadline:
            self.stats["shed_decode"] += 1
            slot.req._finish(error=DeadlineExceededError(
                f"request {slot.req.id} blew its deadline mid-decode after "
                f"{generated} token(s)", stage="decode"))
            self._release(slot_idx)
            return
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
            while not self._stop.is_set():
                while None in self.slots and self._try_admit_one():
                    pass
                if self.active_slots == 0:
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
