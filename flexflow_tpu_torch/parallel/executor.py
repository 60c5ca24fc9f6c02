"""PCG executor: weights, the forward walk and the serving decode step.

The PyTorch counterpart of flexflow_tpu/parallel/executor.py, for what
serving needs on one device: `init_params`, `apply`/`build_forward` and
`build_decode`, with `compute_dtype` (bf16 compute over f32 master weights
under mixed precision). The train step, meshes and sharding come with the
training slice. PyTorch runs eagerly, so the "built" functions are plain
closures; everything runs under `torch.inference_mode`.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..core.initializers import get_initializer
from ..ops.attention import init_decode_cache
from ..ops.registry import FwdCtx, get_op_def
from ..ff_types import OperatorType
from ..pcg.graph import Graph

Params = Dict[str, Dict[str, torch.Tensor]]


class PCGExecutor:
    """Runs a PCG on one device."""

    def __init__(self, graph: Graph, device: torch.device, *,
                 compute_dtype: Optional[torch.dtype] = None, seed: int = 0,
                 input_order: Optional[List] = None):
        self.graph = graph
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.seed = seed
        self.topo = graph.topo_order()
        # user-facing input order is tensor creation order
        self.input_pts = (list(input_order) if input_order is not None
                          else graph.input_tensors())
        outs = graph.output_tensors()
        if not outs:
            raise ValueError("graph has no output tensor")
        self.logits_pt = outs[-1]
        self._decode_builds = {}

    # -- parameter init ----------------------------------------------------
    def init_params(self) -> Params:
        """Every op's weights from its initializers, drawn in topo order
        from one CPU generator seeded by `seed`, then moved to the device."""
        gen = torch.Generator().manual_seed(self.seed)
        params: Params = {}
        for op in self.topo:
            if not op.weights:
                continue
            params[op.name] = {
                name: get_initializer(op.initializers.get(
                    name, "glorot_uniform"))(
                    gen, wpt.material_shape(), wpt.data_type.torch_dtype
                ).to(self.device)
                for name, wpt in zip(op.weight_names, op.weights)
            }
        return params

    def _ctx(self, op_name: str = "") -> FwdCtx:
        return FwdCtx(training=False, compute_dtype=self.compute_dtype,
                      op_name=op_name)

    def _as_input(self, pt, array) -> torch.Tensor:
        return torch.as_tensor(array, dtype=pt.data_type.torch_dtype,
                               device=self.device)

    # -- forward -----------------------------------------------------------
    @torch.inference_mode()
    def apply(self, params: Params, inputs: Dict[int, torch.Tensor]
              ) -> Dict[int, torch.Tensor]:
        """Walk the PCG and compute every tensor. Returns guid -> value."""
        vals = dict(inputs)
        for op in self.topo:
            opdef = get_op_def(op.op_type)
            outs = opdef.forward(op.params, params.get(op.name, {}),
                                 [vals[t.guid] for t in op.inputs],
                                 self._ctx(op.name))
            for t, o in zip(op.outputs, outs):
                vals[t.guid] = o
        return vals

    def build_forward(self) -> Callable:
        """fwd(params, batch_inputs) -> the graph output."""

        def fwd(params, batch_inputs):
            if len(batch_inputs) != len(self.input_pts):
                raise ValueError(f"model takes {len(self.input_pts)} inputs, "
                                 f"got {len(batch_inputs)}")
            vals = self.apply(params, {
                pt.guid: self._as_input(pt, a)
                for pt, a in zip(self.input_pts, batch_inputs)})
            return vals[self.logits_pt.guid]

        return fwd

    # -- incremental decode (serving KV cache) -----------------------------
    def build_decode(self, batch: int, max_len: int):
        """(init_caches, step) for KV-cache decoding of a causal decoder.

        init_caches(params=None) zero-fills one (k, v) cache per
        self-attention op: {"mha": {op_name: (k, v)}}. step(params,
        caches, t, [token_block]) runs the block's positions: t is an int
        (every row at the same position) or a (batch,) int array of
        per-row positions (continuous batching). Returns (logits, caches);
        the caches are updated in place."""
        from . import decode as dec

        key = (batch, max_len)
        if key in self._decode_builds:
            return self._decode_builds[key]
        plan = dec.build_plan(self.topo, self.input_pts)
        if plan.static_ops or len(self.input_pts) != 1:
            raise dec.DecodeExactnessError(
                "graphs with static (non-decode) inputs or ops are not "
                "ported yet: decoder-only graphs with one input decode")
        if not plan.info.get(self.logits_pt.guid, dec.AxisInfo()).is_live:
            raise NotImplementedError(
                "the graph output does not depend on the decode input")
        cdt = self.compute_dtype or torch.float32
        mha = [op for op in plan.live_ops
               if op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION]

        def init_caches(params=None):
            return {"mha": {op.name: init_decode_cache(
                op.params, batch, max_len, cdt, self.device) for op in mha}}

        @torch.inference_mode()
        def step(params, caches, t, batch_inputs):
            (tok,) = batch_inputs
            tok = self._as_input(plan.decode_pt, tok)
            if not isinstance(t, int):
                t = torch.as_tensor(t, dtype=torch.int32)
                if t.dim() == 0:
                    t = int(t)
                elif t.shape[0] != tok.shape[0]:
                    raise ValueError(f"per-row positions: {t.shape[0]} "
                                     f"positions for {tok.shape[0]} rows")
                else:
                    t = t.to(self.device)  # once, not once per layer
            vals = {plan.decode_pt.guid: tok}
            for op in plan.live_ops:
                d = get_op_def(op.op_type)
                w = params.get(op.name, {})
                ins = [vals[x.guid] for x in op.inputs]
                if op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION:
                    outs, caches["mha"][op.name] = d.forward_decode(
                        op.params, w, ins, self._ctx(op.name),
                        caches["mha"][op.name], t)
                else:
                    outs = d.forward(op.params, w, ins, self._ctx(op.name))
                for x, v in zip(op.outputs, outs):
                    vals[x.guid] = v
            return vals[self.logits_pt.guid], caches

        built = (init_caches, step)
        self._decode_builds[key] = built
        return built
