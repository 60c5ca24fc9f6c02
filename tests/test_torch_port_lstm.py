"""The LSTM op and the NMT model on flexflow_tpu_torch against the JAX
package's: the op's forward and gradients (input and the three weights)
in f32 and with a bf16 compute dtype, for both `return_sequences`; the op
against torch.nn.LSTM (tests/test_utils_and_more.py's check); `build_nmt`
at small widths over three train steps and through `fit`; and the NMT
scan (iterations_per_dispatch) bit-equal to stepwise `fit`.

Inputs and weights are made with numpy from a seed and carried into both
packages. f32 on the CPU, where the two differ only in the order of
their sums: outputs within atol 1e-5 and gradients within rtol 1e-4,
atol 1e-5 (a weight gradient sums over batch and steps). With a bf16
compute dtype both round the operands, the hidden state h and the
output to bf16 and keep the gates and the cell state c in f32; an f32
sum that lands on the other side of a bf16 rounding boundary moves h by
one bf16 step, and the next steps carry it: outputs within 2^-6
relative (two bf16 steps) plus atol 2^-9, gradients within rtol 2^-5,
atol 2e-3. NMT's losses and partials within rtol 1e-5, its weights after
three steps within rtol 1e-4, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu.models.nmt import build_nmt as jbuild_nmt
from flexflow_tpu.ops import lstm as jlstm
from flexflow_tpu.ops.registry import FwdCtx as JCtx
from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.ff_types import LossType, MetricsType
from flexflow_tpu_torch.models import build_nmt
from flexflow_tpu_torch.ops import lstm as tlstm
from flexflow_tpu_torch.ops.registry import FwdCtx as TCtx
from flexflow_tpu_torch.runtime.weights import params_from_numpy

TOL = {"f32": dict(out=(0.0, 1e-5), grad=(1e-4, 1e-5)),
       "bf16": dict(out=(2.0 ** -6, 2.0 ** -9), grad=(2.0 ** -5, 2e-3))}
RTOL, W_RTOL, W_ATOL = 1e-5, 1e-4, 1e-5
B, S, F, H = 3, 7, 5, 6


def _case(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, F).astype(np.float32)
    w = {"wx": 0.5 * rng.randn(F, 4 * H), "wh": 0.5 * rng.randn(H, 4 * H),
         "bias": 0.1 * rng.randn(4 * H)}
    return x, {n: a.astype(np.float32) for n, a in w.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seqs", [True, False])
def test_lstm_forward_and_gradients_match_jax(dtype, seqs):
    x, w = _case(0)
    jp = jlstm.LSTMParams(hidden_size=H, return_sequences=seqs)
    tp = tlstm.LSTMParams(hidden_size=H, return_sequences=seqs)
    jcdt, tcdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                  else (None, None))
    out_shape = (B, S, H) if seqs else (B, H)
    cot = np.random.RandomState(1).randn(*out_shape).astype(np.float32)
    names = ["x", "wx", "wh", "bias"]

    def jloss(x_, wx, wh, bias):
        (o,) = jlstm._forward(jp, {"wx": wx, "wh": wh, "bias": bias}, [x_],
                              JCtx(training=True, compute_dtype=jcdt))
        return jnp.sum(o.astype(jnp.float32) * cot), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                     has_aux=True)(
        jnp.asarray(x), *(jnp.asarray(w[n]) for n in names[1:]))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in [x] + [w[n] for n in names[1:]]]
    (to,) = tlstm._forward(tp, dict(zip(names[1:], leaves[1:])), [leaves[0]],
                           TCtx(training=True, compute_dtype=tcdt))
    tg = torch.autograd.grad((to.float() * torch.from_numpy(cot)).sum(),
                             leaves)
    assert tuple(to.shape) == out_shape
    assert to.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    rtol, atol = TOL[dtype]["out"]
    np.testing.assert_allclose(to.float().detach().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               rtol=rtol, atol=atol)
    rtol, atol = TOL[dtype]["grad"]
    for n, t, j in zip(names, tg, jg):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j.astype(jnp.float32)),
                                   rtol=rtol, atol=atol, err_msg=f"d{n}")


def _cell_loop(x, w, c_dtype):
    """The JAX op's recurrence written out with a bf16 compute dtype:
    bf16 operands, f32 products and gates, h carried in bf16, c in
    `c_dtype`."""
    wx, wh = (torch.from_numpy(w[n]).bfloat16().float() for n in ("wx", "wh"))
    xg = torch.from_numpy(x).bfloat16().float() @ wx + torch.from_numpy(
        w["bias"])
    h = torch.zeros(B, H, dtype=torch.bfloat16)
    c = torch.zeros(B, H, dtype=c_dtype)
    hs = []
    for t in range(S):
        i, f, g, o = (xg[:, t] + h.float() @ wh).chunk(4, dim=-1)
        c = (torch.sigmoid(f) * c.float()
             + torch.sigmoid(i) * torch.tanh(g)).to(c_dtype)
        h = (torch.sigmoid(o) * torch.tanh(c.float())).bfloat16()
        hs.append(h)
    return torch.stack(hs, dim=1)


def test_lstm_keeps_c_in_f32_and_h_in_the_compute_dtype():
    """Under a bf16 compute dtype the op is the written-out recurrence
    with c in f32, bit for bit, and not the one with c in bf16 (what
    torch.nn.LSTM in bf16 keeps)."""
    x, w = _case(2)
    (out,) = tlstm._forward(tlstm.LSTMParams(hidden_size=H),
                            {n: torch.from_numpy(a) for n, a in w.items()},
                            [torch.from_numpy(x)],
                            TCtx(compute_dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, _cell_loop(x, w, torch.float32))
    assert not torch.equal(out, _cell_loop(x, w, torch.bfloat16))


def test_lstm_matches_torch_nn_lstm():
    """tests/test_utils_and_more.py's check on the port: torch's packed
    (4h, f) gate order i, f, g, o is FF's; its two biases sum to FF's
    one."""
    rng = np.random.RandomState(0)
    b, s, f, h = 2, 5, 4, 6
    x = rng.randn(b, s, f).astype(np.float32)
    torch.manual_seed(0)
    tl = torch.nn.LSTM(f, h, batch_first=True, bias=True)
    weights = {"wx": tl.weight_ih_l0.detach().T.contiguous(),
               "wh": tl.weight_hh_l0.detach().T.contiguous(),
               "bias": (tl.bias_ih_l0 + tl.bias_hh_l0).detach()}
    (ours,) = tlstm._forward(tlstm.LSTMParams(hidden_size=h), weights,
                             [torch.from_numpy(x)], TCtx())
    with torch.no_grad():
        theirs, (h_n, _) = tl(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=1e-5)
    (last,) = tlstm._forward(tlstm.LSTMParams(hidden_size=h,
                                              return_sequences=False),
                             weights, [torch.from_numpy(x)], TCtx())
    np.testing.assert_allclose(last.numpy(), h_n[0].numpy(), atol=1e-5)


# -- NMT ---------------------------------------------------------------------

NB, VOCAB, SRC, TGT, EMB, HID, LAYERS = 4, 50, 6, 5, 8, 16, 2


def _nmt_kw():
    return dict(src_vocab=VOCAB, tgt_vocab=VOCAB, src_len=SRC, tgt_len=TGT,
                embed_dim=EMB, hidden=HID, num_layers=LAYERS)


def _port(spd=1):
    m = FFModel(FFConfig(batch_size=NB, device="cpu",
                         iterations_per_dispatch=spd))
    build_nmt(m, NB, **_nmt_kw())
    m.compile(SGDOptimizer(lr=0.1),
              LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              [MetricsType.METRICS_ACCURACY,
               MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return m


def _pair():
    cfg = jff.FFConfig()
    cfg.batch_size = NB
    cfg.workersPerNode = 1
    jm = jff.FFModel(cfg)
    jbuild_nmt(jm, NB, **_nmt_kw())
    jm.compile(jff.SGDOptimizer(lr=0.1),
               jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [jff.MetricsType.METRICS_ACCURACY,
                jff.MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    tm = _port()
    params_from_numpy(tm, {op: {n: np.asarray(a) for n, a in ws.items()}
                           for op, ws in jm.state.params.items()})
    return jm, tm


def _data(n, seed):
    rng = np.random.RandomState(seed)
    return ([rng.randint(0, VOCAB, (n, SRC)).astype(np.int32),
             rng.randint(0, VOCAB, (n, TGT)).astype(np.int32)],
            rng.randint(0, VOCAB, (n, TGT, 1)).astype(np.int32))


def _assert_params_close(tparams, jparams, what):
    assert set(tparams) == set(jparams)
    for op, ws in tparams.items():
        for n, w in ws.items():
            np.testing.assert_allclose(w.numpy(), np.asarray(jparams[op][n]),
                                       rtol=W_RTOL, atol=W_ATOL,
                                       err_msg=f"{what} {op}.{n}")


def test_nmt_three_train_steps_match_jax():
    jm, tm = _pair()
    assert [(op.name, op.op_type.name) for op in tm.executor.topo] == \
        [(op.name, op.op_type.name) for op in jm.executor.topo]
    xs, y = _data(3 * NB, 0)
    jstep, tstep = jm.executor.build_train_step(), \
        tm.executor.build_train_step()
    jst, tst = jm.state, tm.state
    for i in range(3):
        bx = [a[i * NB:(i + 1) * NB] for a in xs]
        by = y[i * NB:(i + 1) * NB]
        jst, jp = jstep(jst, bx, by, jax.random.PRNGKey(0))
        tst, tp = tstep(tst, bx, by)
        assert set(tp) == set(jp)
        for k in tp:
            np.testing.assert_allclose(float(tp[k]), float(jp[k]), rtol=RTOL,
                                       err_msg=f"step {i} {k}")
    _assert_params_close(tst.params, jst.params, "nmt")


def test_nmt_fit_matches_jax():
    """`fit` over four batches, as examples/python/nmt.py runs it: the
    folded metrics and the weights."""
    jm, tm = _pair()
    xs, y = _data(4 * NB, 1)
    jpm = jm.fit(xs, y, batch_size=NB, epochs=1, verbose=False)
    tpm = tm.fit(xs, y, batch_size=NB, epochs=1, verbose=False)
    assert tpm.train_all == jpm.train_all == 4 * NB
    assert tpm.train_rows == jpm.train_rows == 4 * NB * TGT
    assert tpm.train_correct == jpm.train_correct
    np.testing.assert_allclose(tpm.sparse_cce_loss, jpm.sparse_cce_loss,
                               rtol=RTOL)
    _assert_params_close(tm.params, jm.state.params, "nmt fit")


def test_nmt_scan_is_stepwise_bit_for_bit():
    """fit with iterations_per_dispatch 2 over five batches (two chunks
    and a tail) against stepwise fit from the same weights."""
    a, b = _port(), _port(spd=2)
    for op, ws in a.params.items():
        for n, w in ws.items():
            assert torch.equal(w, b.params[op][n])
    xs, y = _data(5 * NB, 2)
    pa = a.fit(xs, y, epochs=2, verbose=False)
    pb = b.fit(xs, y, epochs=2, verbose=False)
    assert pa.train_correct == pb.train_correct
    assert pa.sparse_cce_loss == pb.sparse_cce_loss
    for op, ws in a.params.items():
        for n, w in ws.items():
            assert torch.equal(w, b.params[op][n]), f"{op}.{n}"
