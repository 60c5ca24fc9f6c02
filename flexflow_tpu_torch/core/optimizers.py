"""Optimizers: SGD (momentum/nesterov/weight decay) and Adam.

The PyTorch counterpart of flexflow_tpu/core/optimizers.py (reference:
src/runtime/optimizer.cc + optimizer_kernel.cu), with the same semantics:
  SGD: weight decay added to the raw gradient, w -= lr * v with the
    momentum buffer v = mu * v + g, nesterov stepping along g + mu * v;
  Adam: the reference's bias-corrected alpha_t (beta1_t, beta2_t advance
    each step and are kept as f32 scalars, as the JAX package keeps them),
    eps OUTSIDE the sqrt: w -= alpha_t * m / (sqrt(v) + eps).

Gradients may arrive half-width (bf16 under mixed precision); the update
math runs in the master weight's dtype. Where the JAX package returns new
arrays, these update the weights and buffers IN PLACE (under no_grad) to
save a copy of every weight; `update` returns the same dicts it was given.
The math is elementwise, so on a device mesh it runs on DTensors as they
are placed: a `Shard` weight (an fsdp weight, or the slice a rank owns
under the overlapped gradient sync) with its `Shard` gradient updates
each rank's shard in place, and the slots, made by `zeros_like`, keep
the weight's placement (ZeRO), as the JAX package's slots inherit its
sharding.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

Params = Dict[str, Dict[str, torch.Tensor]]


def _zeros_like(params: Params) -> Params:
    return {op: {n: torch.zeros_like(w) for n, w in ws.items()}
            for op, ws in params.items()}


def _leaves(*trees):
    """(tree0 leaf, tree1 leaf, ...) for every (op, name) of trees[0]."""
    for op, ws in trees[0].items():
        for n in ws:
            yield tuple(t[op][n] for t in trees)


class Optimizer:
    """Base (reference: include/flexflow/optimizer.h:27-34)."""

    def init_state(self, params: Params) -> Any:
        raise NotImplementedError

    def state_slots_per_weight(self) -> int:
        """How many weight-sized buffers init_state allocates per
        parameter: the search's memory accounting charges `weights *
        slots` on top of params and grads (search/memory_optimization.py)."""
        return 0

    def update(self, params: Params, grads: Params, state):
        """Updates params and state in place; returns (params, state)."""
        raise NotImplementedError


@dataclasses.dataclass
class SGDOptimizer(Optimizer):
    """reference: optimizer.h:36-60 SGDOptimizer."""

    lr: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    def state_slots_per_weight(self) -> int:
        return 1 if self.momentum != 0.0 else 0

    def init_state(self, params):
        if self.momentum == 0.0:
            return {"v": None}
        return {"v": _zeros_like(params)}

    @torch.no_grad()
    def update(self, params, grads, state):
        wd, mu, lr = self.weight_decay, self.momentum, self.lr
        if mu == 0.0:
            for w, g in _leaves(params, grads):
                g = g.to(w.dtype) + wd * w
                w.sub_(lr * g)
            return params, state
        for w, g, v in _leaves(params, grads, state["v"]):
            g = g.to(w.dtype) + wd * w
            v.mul_(mu).add_(g)
            w.sub_(lr * (g + mu * v) if self.nesterov else lr * v)
        return params, state


@dataclasses.dataclass
class AdamOptimizer(Optimizer):
    """reference: optimizer.h:62-117 AdamOptimizer (alpha_t bias correction
    maintained step to step exactly like AdamOptimizer::next())."""

    alpha: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    epsilon: float = 1e-8

    def state_slots_per_weight(self) -> int:
        return 2  # m and v

    def init_state(self, params):
        dev = next((w.device for ws in params.values() for w in ws.values()),
                   None)
        one = torch.ones((), dtype=torch.float32, device=dev)
        return {"m": _zeros_like(params), "v": _zeros_like(params),
                "beta1_t": one.clone(), "beta2_t": one.clone()}

    @torch.no_grad()
    def update(self, params, grads, state):
        # reference AdamOptimizer::next(): beta_t *= beta, alpha_t = alpha *
        # sqrt(1 - beta2_t) / (1 - beta1_t), all in f32
        state["beta1_t"].mul_(self.beta1)
        state["beta2_t"].mul_(self.beta2)
        alpha_t = (self.alpha * torch.sqrt(1.0 - state["beta2_t"])
                   / (1.0 - state["beta1_t"]))
        b1, b2, wd, eps = self.beta1, self.beta2, self.weight_decay, self.epsilon
        for w, g, m, v in _leaves(params, grads, state["m"], state["v"]):
            g = g.to(w.dtype) + wd * w
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * g * g)
            w.sub_(alpha_t * m / (torch.sqrt(v) + eps))
        return params, state
