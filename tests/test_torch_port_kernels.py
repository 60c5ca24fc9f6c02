"""flexflow_tpu_torch kernels against the JAX package's Pallas kernels.

The port's kernels run on the card only; on the CPU their wrappers take
the plain PyTorch versions, which are what these tests hold against the
JAX kernels run in Pallas interpret mode (and the JAX dense references).
Inputs are made with numpy from a seed and handed to both. Everything is
f32, so the two differ only in summation order: atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels import attention as jattn
from flexflow_tpu.kernels import decode as jdec
from flexflow_tpu_torch.kernels import attention as tattn
from flexflow_tpu_torch.kernels import build
from flexflow_tpu_torch.kernels import decode as tdec

ATOL = 1e-5


def _paged_inputs(seed=0, b=3, h=2, d=8, dv=8, page=4, pp=4):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, d).astype(np.float32)
    k = rng.randn(h, b * pp, page, d).astype(np.float32)
    v = rng.randn(h, b * pp, page, dv).astype(np.float32)
    # scattered, non-contiguous page assignment per slot
    table = rng.permutation(b * pp).reshape(b, pp).astype(np.int32)
    # ragged: a full slot, a freshly admitted 1-token slot, a mid one
    lengths = np.array([pp * page, 1, 7], np.int32)[:b]
    return q, k, v, table, lengths


@pytest.mark.parametrize("dv", [8, 12])
def test_paged_decode_plain_matches_jax_kernel_and_reference(dv):
    q, k, v, table, lengths = _paged_inputs(dv=dv)
    ours = tdec.paged_flash_decode(*map(torch.from_numpy,
                                        (q, k, v, table, lengths)))
    jk = jdec.paged_flash_decode(q, k, v, table, lengths, interpret=True)
    jr = jdec.paged_decode_reference(q, k, v, table, lengths)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jr), atol=ATOL)
    tr = tdec.paged_decode_reference(*map(torch.from_numpy,
                                          (q, k, v, table, lengths)))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL)


def test_paged_decode_plain_never_reads_dead_table_entries():
    """Entries past a slot's live pages may be junk (kernels/decode.py):
    the plain version, like the kernel, must not dereference them."""
    q, k, v, table, lengths = _paged_inputs(seed=1)
    junk = table.copy()
    junk[1, 1:] = 10 ** 6  # slot 1 has one live token: pages 1.. are dead
    junk[2, 2:] = -7       # slot 2 has 7 tokens: pages 2.. are dead
    ours = tdec.paged_flash_decode(*map(torch.from_numpy,
                                        (q, k, v, junk, lengths)))
    ref = jdec.paged_decode_reference(q, k, v, table, lengths)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


def test_paged_decode_zero_length_slot_is_zero_like_jax():
    q, k, v, table, lengths = _paged_inputs(seed=2)
    lengths = np.array([0, 5, 16], np.int32)
    ours = tdec.paged_flash_decode(*map(torch.from_numpy,
                                        (q, k, v, table, lengths)))
    jk = jdec.paged_flash_decode(q, k, v, table, lengths, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jk), atol=ATOL)
    assert not ours[0].any()


def test_paged_view_of_cache_is_a_view_and_matches_jax():
    rng = np.random.RandomState(3)
    b, max_len, h, d = 2, 8, 3, 4
    kc = rng.randn(b, max_len, h, d).astype(np.float32)
    vc = rng.randn(b, max_len, h, d).astype(np.float32)
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    kp, vp, table = tdec.paged_view_of_cache(tk, tv, 4)
    jkp, jvp, jtable = jdec.paged_view_of_cache(jnp.asarray(kc),
                                                jnp.asarray(vc), 4)
    assert kp.data_ptr() == tk.data_ptr()  # no copy
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(jvp))
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    with pytest.raises(ValueError):
        tdec.paged_view_of_cache(tk, tv, 3)


@pytest.mark.parametrize("max_len,pref", [(512, 16), (12, 16), (7, 4), (1, 16)])
def test_decode_page_size_matches_jax(max_len, pref):
    assert tdec.decode_page_size(max_len, pref) == \
        jdec.decode_page_size(max_len, pref)


def _flash_inputs(seed, bh=4, sq=16, sk=16, d=8, dv=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(bh, sq, d).astype(np.float32),
            rng.randn(bh, sk, d).astype(np.float32),
            rng.randn(bh, sk, dv).astype(np.float32))


@pytest.mark.parametrize("causal,sq,sk,dv", [
    (False, 16, 16, 8),
    (True, 16, 16, 8),
    (True, 16, 16, 12),   # v head dim differs from the qk one
    (False, 8, 24, 12),
    (True, 24, 8, 8),     # more queries than keys: top-left causal
])
def test_flash_fwd_plain_matches_jax_kernel(causal, sq, sk, dv):
    q, k, v = _flash_inputs(0, sq=sq, sk=sk, dv=dv)
    o, lse = tattn._flash_fwd_folded(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal)
    jo, jlse = jattn._flash_fwd_folded(q, k, v, causal=causal,
                                       interpret=True)
    assert lse.shape == (4, 1, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL)


def test_flash_fwd_masked_row_stays_finite_like_jax():
    """Scores at the -1e30 mask value: row 0 under the causal mask sees
    one key only, and with huge-magnitude scores the masked keys sit at
    the NEG_INF floor next to live ones. The port must give JAX's finite
    values (masking with -1e30, never -inf; l clamped at 1e-30)."""
    q, k, v = _flash_inputs(1)
    q = q * 1e3
    o, lse = tattn._flash_fwd_folded(*map(torch.from_numpy, (q, k, v)),
                                     causal=True)
    jo, jlse = jattn._flash_fwd_folded(q, k, v, causal=True, interpret=True)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6)
    # row 0 sees key 0 only: its output is exactly v[:, 0]
    np.testing.assert_allclose(o[:, 0].numpy(), v[:, 0], atol=ATOL)


def test_flash_attention_folded_and_fold_helpers_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 3, 4).astype(np.float32)
    f = tattn._bhsd_to_fold(torch.from_numpy(x))
    np.testing.assert_array_equal(f.numpy(),
                                  np.asarray(jattn._bhsd_to_fold(x)))
    np.testing.assert_array_equal(tattn._fold_to_bhsd(f, 2, 3).numpy(), x)
    q, k, v = _flash_inputs(5)
    o = tattn.flash_attention_folded(*map(torch.from_numpy, (q, k, v)), True)
    jo = jattn.flash_attention_folded(q, k, v, True, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL)


def test_flash_supported_shapes():
    assert tattn.flash_supported(512, 512, 64, 64)
    assert tattn.flash_supported(4096, 4096, 64, 64)  # no VMEM cap here
    assert tattn.flash_supported(16, 16, 8, 8)        # the CUDA-core kernel
    assert tattn.flash_supported(16, 16, 64, 72)      # takes any head dim
    assert not tattn.flash_supported(16, 16, 64, 264)  # <= 256 per lane set
    assert not tattn.flash_supported(0, 16, 64, 64)
    assert tattn.NEG_INF == jattn.NEG_INF


@pytest.mark.parametrize("dtype,d,dv,path", [
    (torch.bfloat16, 64, 64, "wgmma"), (torch.float16, 64, 64, "wgmma"),
    (torch.bfloat16, 128, 128, "wgmma"), (torch.float16, 128, 128, "wgmma"),
    (torch.bfloat16, 64, 128, "wmma"), (torch.bfloat16, 64, 32, "wmma"),
    (torch.float16, 256, 256, "wmma"), (torch.bfloat16, 32, 32, "wmma"),
    (torch.bfloat16, 40, 40, "rows"), (torch.float16, 64, 24, "rows"),
    (torch.float32, 64, 64, "rows"), (torch.float32, 128, 128, "rows")])
def test_flash_path_table(dtype, d, dv, path):
    """The kernel path by shape: wgmma for 16-bit d == dv in (64, 128),
    WMMA for other 16-bit head dims that are multiples of 16, the CUDA
    cores for f32 and the rest; its code is the kernels' `Path`."""
    assert tattn.flash_path(dtype, d, dv) == path
    assert tattn._path_code("flash_fwd", dtype, d, dv, None) == \
        tattn.FLASH_PATHS.index(path)
    assert tattn.FLASH_PATHS == ("rows", "wmma", "wgmma")
    with pytest.raises(ValueError, match="unknown path"):
        tattn._path_code("flash_fwd", dtype, d, dv, "tiles")


def test_cpu_tensors_never_launch_a_kernel():
    build.reset_launch_counts()
    q, k, v = _flash_inputs(6)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tattn.flash_attention_folded(*leaves, True).sum().backward()
    tdec.paged_flash_decode(*map(torch.from_numpy, _paged_inputs()))
    tattn.flash_attention_folded(*leaves, True, dropout=0.5,
                                 seeds=(1, 2)).sum().backward()
    assert build.launch_counts == {"flash_fwd": 0, "flash_bwd": 0,
                                   "paged_decode": 0, "flash_fwd_dropout": 0,
                                   "flash_bwd_dropout": 0}
    assert build.path_counts == {k: 0 for k in build.PATH_KERNELS}


def test_kernel_build_is_keyed_by_source_and_flags():
    """The library name hashes the sources and nvcc flags, so an edited
    kernel rebuilds; nothing is compiled to compute it."""
    a = build._target("flash_fwd")
    assert a.name.startswith("libflash_fwd-") and a.suffix == ".so"
    assert a.parent == build.BUILD_DIR
    assert a != build._target("paged_decode")
    assert a != build._target("flash_bwd")
    for name in build.KERNEL_SOURCES:
        assert (build.CSRC_DIR / f"{name}.cu").exists()
    assert set(build.KERNEL_SOURCES) == {"flash_fwd", "flash_bwd",
                                         "paged_decode"}


_BWD_CASES = [
    (False, 16, 16, 8),
    (True, 16, 16, 8),
    (True, 16, 16, 12),   # v head dim differs from the qk one
    (False, 8, 24, 12),
    (True, 24, 8, 8),     # more queries than keys: top-left causal
    (True, 8, 24, 8),     # keys no query sees: dk = dv = 0
]


@pytest.mark.parametrize("causal,sq,sk,dv", _BWD_CASES)
def test_flash_bwd_plain_matches_jax_kernel(causal, sq, sk, dv):
    """flash_bwd_plain against the JAX backward kernel in interpret mode,
    fed the JAX forward's O and lse and one cotangent."""
    q, k, v = _flash_inputs(7, sq=sq, sk=sk, dv=dv)
    do = np.random.RandomState(8).randn(4, sq, dv).astype(np.float32)
    jo, jlse = jattn._flash_fwd_folded(q, k, v, causal=causal, interpret=True)
    jg = jattn._flash_bwd_folded(q, k, v, jo, jlse, do, causal=causal,
                                 interpret=True)
    tg = tattn._flash_bwd_folded(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, jo, jlse, do)),
        causal=causal)
    for name, t, j in zip(("dq", "dk", "dv"), tg, jg):
        assert t.shape == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   err_msg=name)
    if sk > sq and causal:  # keys past the last query get nothing
        assert not tg[1][:, sq:].any() and not tg[2][:, sq:].any()


def _flash_grads_torch(q, k, v, w, causal, fn):
    """Gradients of sum(fn(q, k, v) * w) by torch autograd."""
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (fn(*leaves, causal) * torch.from_numpy(w)).sum().backward()
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("causal,sq,sk,dv", _BWD_CASES)
def test_flash_function_matches_jax_grad(causal, sq, sk, dv):
    """The autograd Function (forward and backward plain versions on the
    CPU) against jax.grad through the JAX package's custom VJP, both
    Pallas kernels in interpret mode."""
    q, k, v = _flash_inputs(9, sq=sq, sk=sk, dv=dv)
    w = np.random.RandomState(10).randn(4, sq, dv).astype(np.float32)
    ours = _flash_grads_torch(q, k, v, w, causal, tattn.flash_attention_folded)
    jg = jax.grad(
        lambda a, b, c: jnp.sum(jattn.flash_attention_folded(
            a, b, c, causal, interpret=True) * w), argnums=(0, 1, 2))(q, k, v)
    for name, t, j in zip(("dq", "dk", "dv"), ours, jg):
        np.testing.assert_allclose(t, np.asarray(j), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal,sq,sk,dv", _BWD_CASES)
def test_flash_function_matches_dense_autograd(causal, sq, sk, dv):
    """The Function's gradients against torch autograd through the port's
    dense masked path (the MHA op's CPU path), on the same operands."""
    from flexflow_tpu_torch.ops.attention import _dense_attention

    def dense(a, b, c, causal):
        keep = (torch.ones(sq, sk, dtype=torch.bool).tril() if causal
                else None)
        unfold = [tattn._fold_to_bhsd(x, 2, 2) for x in (a, b, c)]
        return tattn._bhsd_to_fold(_dense_attention(*unfold, keep))

    q, k, v = _flash_inputs(11, sq=sq, sk=sk, dv=dv)
    w = np.random.RandomState(12).randn(4, sq, dv).astype(np.float32)
    ours = _flash_grads_torch(q, k, v, w, causal, tattn.flash_attention_folded)
    ref = _flash_grads_torch(q, k, v, w, causal, dense)
    for name, t, r in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(t, r, atol=ATOL, err_msg=name)


def test_flash_function_hands_the_forward_lse_to_the_backward(monkeypatch):
    """The forward's lse (not a recomputation) reaches the backward, with
    q, k, v and O; dO arrives contiguous even from a transposed graph."""
    seen = {}
    real = tattn._flash_bwd_folded

    def spy(qf, kf, vf, of, lse, dof, *, causal, **dropout):
        seen.update(lse=lse, o=of, dof=dof, causal=causal, **dropout)
        return real(qf, kf, vf, of, lse, dof, causal=causal, **dropout)

    monkeypatch.setattr(tattn, "_flash_bwd_folded", spy)
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _flash_inputs(13))
    o = tattn.flash_attention_folded(q, k, v, True)
    o.transpose(1, 2).sum(1).pow(2).sum().backward()
    ref_o, ref_lse = tattn._flash_fwd_folded(q.detach(), k.detach(),
                                             v.detach(), causal=True)
    assert seen["causal"] is True and seen["dof"].is_contiguous()
    assert seen["dropout"] == 0.0 and seen["seeds"] is None
    assert torch.equal(seen["lse"], ref_lse) and seen["lse"].shape == (4, 1, 16)
    assert torch.equal(seen["o"], ref_o)


def test_flash_attention_folded_saves_nothing_without_grad():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _flash_inputs(14))
    with torch.no_grad():
        o = tattn.flash_attention_folded(q, k, v, False)
    assert o.grad_fn is None
    plain = tattn.flash_attention_folded(*(x.detach() for x in (q, k, v)))
    assert plain.grad_fn is None
    assert isinstance(tattn.flash_attention_folded(q, k, v).grad_fn,
                      tattn.FlashAttentionFolded._backward_cls)
