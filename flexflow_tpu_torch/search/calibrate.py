"""Calibrate the analytic cost model against the card.

The PyTorch counterpart of tools/calibrate_cost_model.py. It measures
every distinct (op, shard shape) of the benchmark model zoo on the
device through search/measure.py (CUDA graphs of R and 4R calls, the
machinery of --measured-search), compares each measurement with the
uncalibrated roofline of the H100 (`h100_machine().chip`), and fits
per-op-class efficiency factors:

    implied_mxu_eff = flops / (peak * measured)     [compute-bound ops]
    implied_hbm_eff = bytes / (hbm_bw * measured)   [memory-bound ops]

`flops` is what the cost model charges the op at its shard: its padded
FLOPs at the chip's tile quanta (cost_model.py op_padded_flops), so a
fitted efficiency turns the charge back into the measured time. The JAX
tool divides unpadded FLOPs, which its cost model then charges padded:
on the H100's quanta (k and n padded to 128) that would price a 64-wide
attention head's products at twice what was fitted.

The fit (median per op class; `fit_calibration`, the JAX tool's
arithmetic) is written to flexflow_tpu_torch/search/calibration_h100.json,
which CostModel applies by default on a machine whose chip is the
H100's (search/cost_model.py load_default_calibration). The file is
rewritten after every measured row, so a cut run still leaves a usable
fit. A card's measured ops are cached under build/ (keyed by the
device's name).

Run on the card from the repo root:

    python -m flexflow_tpu_torch.search.calibrate [--out PATH]

`--device cpu` times on the host clock, uncached (tests only: a CPU's
times are no fit of a card). The tile quanta the FLOPs are padded to
come from search/tile_sweep.py.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(HERE, "calibration_h100.json")
DEFAULT_CACHE = os.path.join(os.path.dirname(os.path.dirname(HERE)), "build",
                             "calibration_measured_cache.json")

# classes whose compute- and memory-bound shapes get separate fits
# (CostModel._calibration_class selects '<NAME>@mem' when the
# uncalibrated roofline says a shape is memory-bound)
REGIME_SPLIT_CLASSES = {"OP_LINEAR"}


def zoo_graphs():
    """(name, graph) for the calibration grid: the JAX tool's models at
    its shapes (the OSDI'22 benchmark models, a second and third
    Transformer shape, DLRM and MLP_Unify at three batches, the
    primitive attention graph of imported models, MoE), the Transformer
    also data-parallel over 4 so sharded shapes are measured too. Only
    graphs are built: nothing is placed on a device."""
    from ..config import FFConfig
    from ..core.model import FFModel
    from ..ff_types import DataType
    from ..models.alexnet import build_alexnet
    from ..models.dlrm import build_dlrm
    from ..models.misc import build_mlp_unify, build_moe
    from ..models.transformer import build_transformer
    from ..parallel import strategies
    from ..pcg.lowering import layers_to_pcg

    out = []

    def add(name, build, dp_degrees=(1, 4)):
        for dp in dp_degrees:
            m = FFModel(FFConfig(device="cpu"))
            build(m)
            g, _ = layers_to_pcg(m.layers)
            if dp > 1:
                strategies.apply_data_parallel(g, dp, axis_idx=0)
            out.append((f"{name}@dp{dp}", g))

    add("transformer",
        lambda m: build_transformer(m, batch_size=8, seq_length=512,
                                    hidden_size=1024, num_heads=16,
                                    num_layers=1))
    add("transformer_s128",
        lambda m: build_transformer(m, batch_size=32, seq_length=128,
                                    hidden_size=512, num_heads=8,
                                    num_layers=1), dp_degrees=(1,))
    add("alexnet",
        lambda m: build_alexnet(m, batch_size=64, num_classes=10,
                                height=224, width=224), dp_degrees=(1,))
    add("dlrm", lambda m: build_dlrm(m, batch_size=64), dp_degrees=(1,))
    add("dlrm_b512", lambda m: build_dlrm(m, batch_size=512),
        dp_degrees=(1,))
    add("dlrm_b2048", lambda m: build_dlrm(m, batch_size=2048),
        dp_degrees=(1,))
    add("mlp_unify", lambda m: build_mlp_unify(m, batch_size=32),
        dp_degrees=(1,))
    add("mlp_unify_b256", lambda m: build_mlp_unify(m, batch_size=256),
        dp_degrees=(1,))
    add("mlp_unify_b2048", lambda m: build_mlp_unify(m, batch_size=2048),
        dp_degrees=(1,))

    # layer norm and the primitive batch_matmul + softmax attention of an
    # imported graph
    def build_primitive_attention(m, batch, seq, hidden):
        x = m.create_tensor((batch, seq, hidden), DataType.DT_FLOAT)
        t = m.layer_norm(x, axes=(-1,))
        scores = m.batch_matmul(t, m.transpose(t, (0, 2, 1)))
        probs = m.softmax(scores, axis=-1)
        ctx = m.batch_matmul(probs, t)
        t2 = m.layer_norm(ctx, axes=(-1,))
        m.dense(t2, hidden)

    add("prim_attn_s512",
        lambda m: build_primitive_attention(m, 8, 512, 1024),
        dp_degrees=(1,))
    add("prim_attn_s256",
        lambda m: build_primitive_attention(m, 16, 256, 512),
        dp_degrees=(1,))
    add("prim_attn_s128",
        lambda m: build_primitive_attention(m, 32, 128, 1024),
        dp_degrees=(1,))

    def build_moe_graph(m, batch, input_dim, hidden, num_exp):
        build_moe(m, batch_size=batch, input_dim=input_dim, num_classes=16,
                  num_exp=num_exp, num_select=2, hidden=hidden)

    add("moe_b256", lambda m: build_moe_graph(m, 256, 512, 1024, 8),
        dp_degrees=(1,))
    add("moe_b1024", lambda m: build_moe_graph(m, 1024, 512, 1024, 8),
        dp_degrees=(1,))
    add("moe_b4096", lambda m: build_moe_graph(m, 4096, 256, 512, 16),
        dp_degrees=(1,))
    return out


def _row_class(r, peak, hbm):
    name = r["op"]
    if name in REGIME_SPLIT_CLASSES:
        if r["bytes"] / hbm > r["flops"] / peak:
            return f"{name}@mem"
    return name


def fit_calibration(rows: List[dict], device_kind: str, bf16: bool,
                    chip) -> dict:
    """The per-op-class fit of measured rows against `chip`'s roofline:
    the JAX tool's `write_outputs` arithmetic, without its file writes.
    A class is compute-bound when its median implied mxu efficiency is
    physical (<= 1.2) and at least its implied hbm efficiency, else
    memory-bound; efficiencies clamp at 0.95 (mxu) and 0.98 (hbm); the
    global mxu fallback is the median of the matmul classes', the hbm
    one of every memory-bound class's; `fit_err` is the calibrated
    roofline's median |predicted - measured| / measured over the class's
    rows."""
    peak = chip.peak_flops_bf16 if bf16 else chip.peak_flops_f32
    hbm = chip.hbm_bandwidth

    by_class = {}
    for r in rows:
        by_class.setdefault(_row_class(r, peak, hbm), []).append(r)
    op_class = {}
    for cls, rs in sorted(by_class.items()):
        mxu = [r["implied_mxu_fwd"] for r in rs]
        hbmv = [r["implied_hbm_fwd"] for r in rs]
        # bwd/fwd ratios outside [0.5, 4] are differencing noise (a
        # failed backward measurement floors at 0.1 * fwd): absent a
        # clean ratio the cost model keeps its default
        ratios = [r["bwd_over_fwd"] for r in rs
                  if 0.5 <= r["bwd_over_fwd"] <= 4.0]
        med_m, med_h = float(np.median(mxu)), float(np.median(hbmv))
        entry = {"n": len(rs)}
        if ratios:
            entry["bwd_over_fwd"] = round(float(np.median(ratios)), 3)
        if med_m <= 1.2 and med_m >= med_h:
            entry["mxu_efficiency"] = round(min(med_m, 0.95), 3)
            entry["bound"] = "compute"
        else:
            entry["hbm_efficiency"] = round(min(med_h, 0.98), 3)
            entry["bound"] = "memory"
        op_class[cls] = entry

    mm = [op_class[c]["mxu_efficiency"] for c in
          ("OP_LINEAR", "OP_CONV2D", "OP_BATCHMATMUL",
           "OP_MULTIHEAD_ATTENTION")
          if c in op_class and "mxu_efficiency" in op_class[c]]
    ew = [op_class[c]["hbm_efficiency"] for c in op_class
          if "hbm_efficiency" in op_class[c]]
    calib = {
        "device": device_kind,
        "dtype": "bf16" if bf16 else "f32",
        "mxu_efficiency": round(float(np.median(mm)), 3) if mm else None,
        "hbm_efficiency": round(float(np.median(ew)), 3) if ew else None,
        "op_class": op_class,
    }

    g_m = calib["mxu_efficiency"] or 0.55
    g_h = calib["hbm_efficiency"] or 0.8
    for cls, rs in by_class.items():
        e = op_class[cls]
        m_eff = e.get("mxu_efficiency", g_m)
        h_eff = e.get("hbm_efficiency", g_h)
        errs = []
        for r in rs:
            pred = max(r["flops"] / (peak * m_eff),
                       r["bytes"] / (hbm * h_eff))
            if r["fwd_s"] > 0:
                errs.append(abs(pred - r["fwd_s"]) / r["fwd_s"])
        if errs:
            e["fit_err"] = round(float(np.median(errs)), 3)
    return calib


def card_name_and_power(device) -> tuple:
    """(the device's name, the card's power limit as nvidia-smi reads it,
    or None where it cannot be read)."""
    import torch

    if device.type != "cuda":
        return "cpu", None
    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        limit = out.stdout.strip().splitlines()[device.index or 0].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        limit = None
    return name, limit


def _write(path: str, calib: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(calib, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def calibrate(out_path: str, device: str = "cuda",
              cache_path: Optional[str] = DEFAULT_CACHE) -> dict:
    """Measure the zoo's distinct ops on `device` in bf16, fit them
    against the H100's roofline and write the fit to `out_path` after
    every row. Returns the last fit."""
    import torch

    from ..config import resolve_device
    from .cost_model import op_bytes, op_padded_flops
    from .machine_model import h100_machine
    from ..pcg.machine_view import MachineView
    from .measure import OperatorMeasurer, _local_shape

    dev = resolve_device(device)
    device_kind, power_limit = card_name_and_power(dev)
    print(f"calibrating on: {device_kind} ({power_limit})", flush=True)
    # the JAX tool's cap on a first measurement's repetitions; the host
    # clock (tests) times a few calls, whose times fit no card anyway
    max_repeats = 2048 if dev.type == "cuda" else 2
    bf16 = True
    machine = h100_machine()
    chip = machine.chip
    peak = chip.peak_flops_bf16 if bf16 else chip.peak_flops_f32
    hbm = chip.hbm_bandwidth
    if cache_path:
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)),
                    exist_ok=True)
    meas = OperatorMeasurer(repeats=32, compute_dtype=torch.bfloat16,
                            device=dev, cache_path=cache_path)
    view = MachineView(start_device_id=0, dim=(1,), stride=(1,))

    def fit():
        calib = fit_calibration(rows, device_kind, bf16, chip)
        calib["power_limit"] = power_limit
        calib["source"] = "python -m flexflow_tpu_torch.search.calibrate"
        return calib

    rows: List[dict] = []
    seen = set()
    for name, g in zoo_graphs():
        for op in g.topo_order():
            if op.is_parallel_op or not op.inputs:
                continue
            shard_shapes = tuple(_local_shape(t) for t in op.inputs)
            w_shapes = tuple(_local_shape(w) for w in op.weights)
            key = (op.op_type, repr(op.params), shard_shapes, w_shapes)
            if key in seen:
                continue
            seen.add(key)
            # the analytic estimate seeds the repetition count: the
            # shard's share of the bytes, its padded FLOPs
            gvol0 = sum(int(np.prod(t.material_shape())) for t in op.inputs)
            lvol0 = sum(int(np.prod(s)) for s in shard_shapes)
            frac = lvol0 / max(1, gvol0)
            out_deg = op.outputs[0].get_total_degree() if op.outputs else 1
            fl = op_padded_flops(op, max(1, out_deg), chip)
            by = op_bytes(op) * frac
            est = machine.compute_cost(fl, by, True)
            if est < 2e-6:
                continue  # negligible op: the roofline's noise floor
            meas.repeats = int(min(max_repeats, max(16, 30e-3 / (3 * est))))
            print(f"  measuring {name} {op.op_type.name} {shard_shapes} "
                  f"R={meas.repeats}...", flush=True)
            fwd_t, bwd_t = meas(op, view)
            if fwd_t != fwd_t:  # NaN: the op cannot run alone
                continue
            if fwd_t > 0 and not (0.5 <= bwd_t / fwd_t <= 4.0):
                # an outlier backward ratio: measure again with 4x the
                # repeats (force=True skips the cached reading)
                meas.repeats = int(min(2 * max_repeats, meas.repeats * 4))
                print(f"    bwd/fwd={bwd_t / fwd_t:.2f} outlier, "
                      f"re-measuring R={meas.repeats}", flush=True)
                f2, b2 = meas(op, view, force=True)
                if f2 == f2 and f2 > 0 and 0.5 <= b2 / f2 <= 4.0:
                    fwd_t, bwd_t = f2, b2
            rows.append({
                "model": name, "op": op.op_type.name,
                "shapes": str(shard_shapes),
                "flops": fl, "bytes": by,
                "fwd_s": fwd_t, "bwd_s": bwd_t,
                "implied_mxu_fwd": fl / (peak * fwd_t) if fwd_t else None,
                "implied_hbm_fwd": by / (hbm * fwd_t) if fwd_t else None,
                "bwd_over_fwd": bwd_t / fwd_t if fwd_t else None,
            })
            print(f"  {name:20s} {op.op_type.name:24s} "
                  f"fwd={fwd_t * 1e6:8.1f}us bwd={bwd_t * 1e6:8.1f}us "
                  f"mxu={rows[-1]['implied_mxu_fwd']:.3f} "
                  f"hbm={rows[-1]['implied_hbm_fwd']:.3f}", flush=True)
            _write(out_path, fit())
    calib = fit()
    _write(out_path, calib)
    print(f"wrote {out_path}", flush=True)
    print(json.dumps({"rows": rows}), flush=True)
    return calib


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flexflow_tpu_torch.search.calibrate",
        description="Fit the cost model's per-op-class efficiencies to "
                    "times measured on the device.")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the fit's JSON (default: the shipped "
                         "calibration_h100.json)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    calibrate(args.out, args.device,
              DEFAULT_CACHE if args.device == "cuda" else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
