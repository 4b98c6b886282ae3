"""Head widths past 128 and decode rows of any width, held to the JAX
package on the CPU, and the smoke run's multi-seed step check and the
tensor-core forward's arithmetic, checked without a card.

- Fused training attention at d 160 (zero-padded to the built width 256)
  and d 256, and past 256 at d 300 (zero-padded to 320), 320 and 512
  (the kernels split the outputs' columns into 64-column chunks, one
  block each: ``built_width``, ``column_chunks``), forward and backward,
  per head and in the packed layout: the port's plain version through
  its padding functions against the JAX package's ``fused_attention`` /
  ``fused_attention_packed``, which on the CPU take their own fallback
  (no Pallas tier is built for these widths there). fp32, rtol 1e-5 and
  atol 1e-5: the same math summed in another order.
- Decode at fp32 d 6 (24-byte rows), fp32 d 192 (768 bytes), bf16 d 12,
  and past 2048 bytes fp32 d 640 (2560 bytes) and bf16 d 1536 (3072
  bytes; the kernels split the output's columns into 2048-byte chunks)
  through ``attention_with_cache`` and ``paged_attention_cache``, on
  unpadded caches and on caches whose rows are padded to 16 bytes as the
  sessions allocate them, against the JAX package's (its plain
  ``_ref_attention_cache`` at these rows): fp32 rtol 1e-5, atol 1e-6;
  bf16 atol 2**-7 (both round the output to bf16 from fp32 sums in
  another order). A dense decode session of head width 6 gives the JAX
  session's greedy tokens exactly, with its caches' rows padded to 8.
- ``chip_smoke.step_verdict``, the multi-seed step check, on readings
  taken on the H100 (PERF.md): the SIMT forward's six seeds pass in
  both phases, and each planted fault's readings fail.
- ``tools/fwd_rehearsal.py``'s ``emulate_forward`` at the kernel's piece
  count (read from its source) against the JAX ``fused_attention`` on
  the same bf16-rounded inputs, under chip_smoke.py's LONG_RTOL.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as smoke
from paddle_tpu.fluid import dygraph
from paddle_tpu.kernels import attention as JA
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.kernels import attention as PA
from paddle_tpu_torch.models import transformer as PT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def reference_fallback(monkeypatch):
    """The JAX package on the CPU without its Pallas interpreter: every
    call takes the package's own plain fallback."""
    monkeypatch.delenv("PADDLE_TPU_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("PADDLE_TPU_ATTN_FORCE", raising=False)


# -- fused attention at d 160 and 256 ----------------------------------------
@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("bias_shape", [(2, 1, 1, 24), (2, 3, 24, 24)],
                         ids=["padding_mask", "per_row"])
def test_wide_heads_match_reference(reference_fallback, d, bias_shape):
    rng = np.random.RandomState(d + bias_shape[1])
    B, H, S = 2, 3, 24
    q, k, v, do = (rng.randn(B, H, S, d).astype(np.float32)
                   for _ in range(4))
    bias = rng.randn(*bias_shape).astype(np.float32)
    bias[..., -4:] = -1e4

    def jax_loss(q_, k_, v_, b_):
        return jnp.sum(JA.fused_attention(q_, k_, v_, b_) * do)

    want_out = np.asarray(JA.fused_attention(q, k, v, bias))
    want_grads = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(q, k, v, bias)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    scale = d ** -0.5
    # the plain version on operands padded to the built width, as the
    # card's route pads them (padded_forward / padded_backward)
    o, lse = PA.padded_forward(PA._ref_flash_attention, *leaves, scale,
                               0.0, None)
    grads = PA.padded_backward(PA._ref_flash_attention_backward, *leaves,
                               None, torch.from_numpy(do), o, lse, scale,
                               0.0, True)
    assert PA.built_width(d) == 256
    np.testing.assert_allclose(o.detach().numpy(), want_out, **TOL)
    for name, g, w in zip("q k v bias".split(), grads, want_grads):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=name, **TOL)
    out = PA.fused_attention(*leaves)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)


@pytest.mark.parametrize("d", [160, 256])
def test_wide_heads_packed_match_reference(reference_fallback, d):
    rng = np.random.RandomState(d)
    B, S, H = 2, 20, 2
    q, k, v, do = (rng.randn(B, S, H * d).astype(np.float32)
                   for _ in range(4))
    bias = np.zeros((B, 1, 1, S), np.float32)
    bias[1, ..., 15:] = -1e4

    def jax_loss(q_, k_, v_, b_):
        return jnp.sum(JA.fused_attention_packed(q_, k_, v_, b_,
                                                 n_heads=H) * do)

    want_out = np.asarray(JA.fused_attention_packed(q, k, v, bias,
                                                    n_heads=H))
    want_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v, bias)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = PA.fused_attention_packed(*leaves, torch.from_numpy(bias),
                                    n_heads=H)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for name, g, w in zip("q k v".split(), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_past_256_raises_with_its_own_message(reference_fallback):
    """Past 256 the kernels once raised; d 300 now reaches them
    zero-padded to 320 (five 64-column chunks), and the plain version
    through the same padding matches the reference's fallback, forward
    and gradients."""
    assert (PA.built_width(300), PA.column_chunks(300)) == (320, 5)
    _wide_heads_case(300, (2, 1, 1, 24), 24)


def _wide_heads_case(d, bias_shape, S):
    """The plain version through padded_forward / padded_backward at
    head width d against the reference's fused_attention and its
    gradients."""
    rng = np.random.RandomState(d + bias_shape[1])
    B, H = 2, 3
    q, k, v, do = (rng.randn(B, H, S, d).astype(np.float32)
                   for _ in range(4))
    bias = rng.randn(*bias_shape).astype(np.float32)
    bias[..., -4:] = -1e4

    def jax_loss(q_, k_, v_, b_):
        return jnp.sum(JA.fused_attention(q_, k_, v_, b_) * do)

    want_out = np.asarray(JA.fused_attention(q, k, v, bias))
    want_grads = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(q, k, v, bias)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    o, lse = PA.padded_forward(PA._ref_flash_attention, *leaves, d ** -0.5,
                               0.0, None)
    grads = PA.padded_backward(PA._ref_flash_attention_backward, *leaves,
                               None, torch.from_numpy(do), o, lse,
                               d ** -0.5, 0.0, True)
    np.testing.assert_allclose(o.detach().numpy(), want_out, **TOL)
    for name, g, w in zip("q k v bias".split(), grads, want_grads):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("bias_shape", [(2, 1, 1, 24), (2, 3, 24, 24)],
                         ids=["padding_mask", "per_row"])
def test_heads_past_256_match_reference(reference_fallback, d, bias_shape):
    """Built widths past 256 (no padding: 5 and 8 column chunks)."""
    assert PA.built_width(d) == d and PA.column_chunks(d) == d // 64
    _wide_heads_case(d, bias_shape, 24)


@pytest.mark.parametrize("d", [320, 512])
def test_heads_past_256_packed_match_reference(reference_fallback, d):
    rng = np.random.RandomState(d + 1)
    B, S, H = 2, 20, 2
    q, k, v, do = (rng.randn(B, S, H * d).astype(np.float32)
                   for _ in range(4))
    bias = np.zeros((B, 1, 1, S), np.float32)
    bias[1, ..., 13:] = -1e4

    def jax_loss(q_, k_, v_):
        return jnp.sum(JA.fused_attention_packed(q_, k_, v_, bias,
                                                 n_heads=H) * do)

    want_out = np.asarray(JA.fused_attention_packed(q, k, v, bias,
                                                    n_heads=H))
    want_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = PA.fused_attention_packed(*leaves, torch.from_numpy(bias),
                                    n_heads=H)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    for name, g, w in zip("q k v".split(), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


# -- decode rows of any width ------------------------------------------------
DECODE_CASES = [(np.float32, 6), (np.float32, 192), ("bfloat16", 12),
                (np.float32, 640), ("bfloat16", 1536)]


def _decode_tol(dtype):
    return dict(rtol=1e-5, atol=1e-6) if dtype == np.float32 else \
        dict(rtol=0, atol=2 ** -7)


def _as_torch(a, dtype):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _as_jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16) if dtype == "bfloat16" else a


@pytest.mark.parametrize("dtype,d", DECODE_CASES,
                         ids=["f32_d6", "f32_d192", "bf16_d12", "f32_d640",
                              "bf16_d1536"])
def test_decode_any_row_matches_reference(reference_fallback, dtype, d):
    """Dense and paged decode on unpadded caches and on caches padded to
    16-byte rows (the sessions' layout), against the JAX package."""
    rng = np.random.RandomState(d)
    B, H, Q, C, ptok = 3, 2, 1, 40, 8
    q = rng.randn(B, H, Q, d).astype(np.float32)
    k, v = (rng.randn(B, H, C, d).astype(np.float32) for _ in range(2))
    lens = np.array([1, 17, 55], np.int32)
    want = np.asarray(JA.attention_with_cache(
        _as_jax(q, dtype), _as_jax(k, dtype), _as_jax(v, dtype), lens),
        np.float32)
    tol = _decode_tol(dtype)
    qt, kt, vt = (_as_torch(a, dtype) for a in (q, k, v))
    lt = torch.from_numpy(lens)
    width = PA.decode_row_width(d, qt.dtype)
    assert width * qt.element_size() % 16 == 0 and width - d < 16
    padded = [torch.nn.functional.pad(t, (0, width - d)) for t in (kt, vt)]
    for kc, vc in ((kt, vt), padded):
        got = PA.attention_with_cache(qt, kc, vc, lt)
        assert got.shape == qt.shape and got.dtype == qt.dtype
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
    # the same cache as a paged pool: page p of slot b is pool row
    # b * C / ptok + p
    npages = C // ptok
    table = np.arange(B * npages, dtype=np.int32).reshape(B, npages)
    pools = [a.reshape(B, H, npages, ptok, d).transpose(0, 2, 1, 3, 4)
             .reshape(B * npages, H, ptok, d) for a in (k, v)]
    want_paged = np.asarray(JA.paged_attention_cache(
        _as_jax(q, dtype), *(_as_jax(p, dtype) for p in pools), table,
        lens), np.float32)
    np.testing.assert_allclose(want_paged, want, **tol)
    for pool_rows in (0, width - d):
        pt = [torch.nn.functional.pad(_as_torch(p, dtype), (0, pool_rows))
              for p in pools]
        got = PA.paged_attention_cache(qt, *pt, torch.from_numpy(table), lt)
        np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_cache_update_writes_the_first_d_of_padded_rows():
    """kv_cache_update and paged_kv_cache_update write a [.., d] token
    into the first d columns of rows padded to 16 bytes and leave the
    padding zero, as the reference writes its unpadded rows."""
    rng = np.random.RandomState(0)
    B, H, C, d, T = 2, 2, 8, 6, 3
    new = rng.randn(B, H, T, d).astype(np.float32)
    lens = np.array([2, 5], np.int32)     # no write crosses the ring end
    want, want_len = JA.kv_cache_update(np.zeros((B, H, C, d), np.float32),
                                        new, lens)
    cache = torch.zeros(B, H, C, PA.decode_row_width(d, torch.float32))
    got, got_len = PA.kv_cache_update(cache, torch.from_numpy(new),
                                      torch.from_numpy(lens))
    np.testing.assert_array_equal(got[..., :d].numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert not got[..., d:].any()
    pool = torch.zeros(5, H, 4, 8)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    PA.paged_kv_cache_update(pool, torch.from_numpy(new), table,
                             torch.from_numpy(lens))
    dense = PA.gather_paged_cache(pool, table)
    np.testing.assert_array_equal(dense[..., :d].numpy(), np.asarray(want))
    assert not pool[..., d:].any()


def test_decode_session_head_width_6_matches_reference(reference_fallback):
    """Greedy tokens of a dense session over a model of head width 6
    (24-byte fp32 rows; the port's caches pad them to 8 elements) equal
    the JAX session's, with a ring that wraps."""
    kw = dict(d_model=24, n_heads=4, d_inner=48, n_layers=2, max_len=64)
    with dygraph.guard():
        ref = JT.Transformer(512, 512, **kw)
        arrays = {n: np.array(p.numpy()) for n, p in
                  ref.named_parameters()}
    port = PT.load_jax_params(PT.Transformer(512, 512, device="cpu", **kw),
                              arrays)
    rng = np.random.RandomState(6)
    B, S, P, C, new = 2, 6, 4, 8, 9
    src = rng.randint(2, 512, (B, S)).astype(np.int64)
    prompt = rng.randint(2, 512, (B, P)).astype(np.int64)
    plens = np.array([4, 2], np.int64)
    sess = PT.build_decode_session(port, B, S, P, C)
    assert sess._caches[0].shape[-1] == 8
    got, got_fin = sess.generate(src, prompt, plens, new)
    with dygraph.guard():
        want, want_fin = JT.build_decode_session(ref, B, S, P, C).generate(
            src, prompt, plens, new)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_fin, np.asarray(want_fin))


# -- the multi-seed step check ------------------------------------------------
WATCH = ("word_emb", "layer_0_attn_q.w_0", "layer_5_attn_k.w_0",
         "layer_11_ffn2.w_0", "mlm_out_bias")
# Readings of data seeds 0-5 on the H100 (tools/attention_fault_check.py,
# PERF.md): each (phase, copy) as (the loss's signed relative
# differences, each watched first moment's largest relative difference
# over the seeds, in WATCH's order). "sound" and the faults but
# v_not_transposed ran with the SIMT forward (--forward simt), whose
# packed readings are tools/step_check_spread.py's to three digits;
# "tensor_cores" is the shipped forward, v_not_transposed its fault,
# "pieces_1" P in one bf16 piece (not shipped).
READINGS = {
    ("bert_long", "sound"): (
        [4.04e-6, 5.35e-6, -1.47e-6, -5.9e-6, -7.19e-6, 5.54e-6],
        [0.0134, 0.014, 0.0382, 0.0103, 0.0001]),
    ("bert_packed", "sound"): (
        [-1.66e-6, 3.13e-6, -6.83e-5, 9.82e-5, -5.55e-5, -3.06e-5],
        [0.0154, 0.0142, 0.0338, 0.009, 0.0]),
    ("bert_long", "skip_tile"): (
        [1.68e-5, -7.93e-6, 1.36e-5, -3.66e-5, 1.51e-5, 6e-6],
        [0.0169, 0.6836, 0.5573, 0.0135, 0.0024]),
    ("bert_packed", "skip_tile"): (
        [2.67e-4, -1.32e-5, 9.98e-4, 6.3e-4, -2.47e-4, 1.67e-5],
        [0.1413, 1.816, 3.6128, 0.1412, 0.0001]),
    ("bert_packed", "no_mask"): (
        [-3e-4, 3.48e-4, -3.49e-4, 1.01e-4, -2.17e-4, 9.48e-5],
        [0.0947, 0.4581, 0.3874, 0.0559, 0.0001]),
    ("bert_packed", "pair_by_head"): (
        [1.78e-4, -3.37e-4, 7.82e-5, 1.11e-5, -2.67e-4, 6.99e-5],
        [0.0792, 0.1472, 0.2801, 0.0441, 0.0]),
    ("bert_long", "row_stride_d"): (
        [-1.17e-3, 4.07e-4, -8.02e-4, 2.2e-3, -2.56e-4, 2.78e-3],
        [1.15, 29.5263, 4.0305, 1.0047, 0.0125]),
    ("bert_packed", "row_stride_d"): (
        [-3.13e-3, -9.09e-4, -6.33e-3, 8.62e-3, 4.66e-3, 6.34e-3],
        [1.1293, 8.3721, 5.6635, 0.9991, 0.0014]),
    ("bert_long", "k_not_transposed"): (
        [4.04e-6, 5.35e-6, -1.47e-6, -5.9e-6, -7.19e-6, 5.54e-6],
        [0.0134, 1.993, 0.0496, 0.0103, 0.0001]),
    ("bert_packed", "k_not_transposed"): (
        [-1.66e-6, 3.13e-6, -6.83e-5, 9.82e-5, -5.55e-5, -3.06e-5],
        [0.0154, 2.2944, 0.1352, 0.009, 0.0]),
    ("bert_long", "tensor_cores"): (
        [2.78e-5, 1.47e-5, -1.84e-6, -8.03e-6, -1.03e-5, 1.7e-5],
        [0.014, 0.0155, 0.0305, 0.009, 0.0001]),
    ("bert_packed", "tensor_cores"): (
        [2.59e-5, -5.01e-5, 7.31e-7, -3.7e-6, -2.77e-5, -4.36e-5],
        [0.0124, 0.0152, 0.0354, 0.01, 0.0]),
    ("bert_long", "v_not_transposed"): (
        [-2.09e-3, 1.37e-4, -2.06e-3, 2.44e-3, 2.44e-3, 2.17e-3],
        [1.3172, 17529.3711, 1555.3986, 0.9958, 0.0149]),
    ("bert_packed", "v_not_transposed"): (
        [1e-3, -2.77e-3, -1.19e-2, 3.77e-3, -1.95e-3, -1.54e-3],
        [1.9987, 2974.144, 1016.1231, 1.0028, 0.0014]),
    ("bert_long", "pieces_1"): (
        [1.36e-5, 2.86e-6, 4.15e-6, -1.41e-5, -9.69e-6, 1.75e-6],
        [0.014, 0.0175, 0.0305, 0.0112, 0.0024]),
    ("bert_packed", "pieces_1"): (
        [6.83e-6, -2.34e-5, -4.2e-5, 8.11e-5, -9.23e-5, -1.7e-5],
        [0.0139, 0.0142, 0.0342, 0.009, 0.0]),
}
GRAD_RTOL = {"bert_long": smoke.LONG_GRAD_RTOL,
             "bert_packed": smoke.PACKED_GRAD_RTOL}


def _verdict(phase, signed, grads):
    recs = [dict(data_seed=i, loss_kernel=7.0, loss_plain=7.0,
                 loss_signed_rel=x, grad_rel=dict(zip(WATCH, grads)))
            for i, x in enumerate(signed)]
    return smoke.step_verdict(recs, GRAD_RTOL[phase],
                              smoke.STEP_LOSS_MEAN[phase])


@pytest.mark.parametrize("copy", ["sound", "tensor_cores"])
@pytest.mark.parametrize("phase", ["bert_long", "bert_packed"])
def test_step_verdict_passes_sound_forwards_at_every_seed(phase, copy):
    """The SIMT forward (the limits were set from it) and the shipped
    tensor-core forward pass at every seed."""
    signed, grads = READINGS[phase, copy]
    rec = _verdict(phase, signed, grads)
    assert rec["passes"], rec
    assert rec["loss_max_abs"] == max(abs(x) for x in signed)
    if (phase, copy) == ("bert_packed", "sound"):
        # the one-seed limit, 1e-5, failed 4 of these 6
        assert sum(abs(x) > 1e-5 for x in signed) == 4


@pytest.mark.parametrize("fault", ["skip_tile", "no_mask", "pair_by_head",
                                   "row_stride_d", "k_not_transposed",
                                   "v_not_transposed", "pieces_1"])
def test_step_verdict_fails_each_planted_fault(fault):
    """Each fault, and P in one bf16 piece, fails the check in at least
    one phase (a phase whose readings a fault does not move, as the mask
    faults at bert_long's batch of one unpadded row, holds the sound
    readings)."""
    over = {}
    for phase in ("bert_long", "bert_packed"):
        signed, grads = READINGS.get((phase, fault),
                                     READINGS[phase, "sound"])
        over[phase] = _verdict(phase, signed, grads)["over"]
    assert any(over.values()), over


def test_step_limits_lie_between_sound_and_faulty_readings():
    """STEP_LOSS_MAX above every sound reading and below the smallest
    fault reading of the one-seed check (1.78e-4, the head-keyed mask
    at seed 0);
    each phase's STEP_LOSS_MEAN above the sound forward's |mean|."""
    sound = [abs(x) for phase in ("bert_long", "bert_packed")
             for x in READINGS[phase, "sound"][0]]
    assert max(sound) < smoke.STEP_LOSS_MAX < 1.78e-4
    for phase in ("bert_long", "bert_packed"):
        signed = READINGS[phase, "sound"][0]
        assert abs(sum(signed) / 6) < smoke.STEP_LOSS_MEAN[phase]


def test_step_verdict_fails_a_loss_that_is_not_finite():
    signed, grads = READINGS["bert_long", "sound"]
    recs = [dict(data_seed=i, loss_kernel=float("nan") if i == 2 else 7.0,
                 loss_signed_rel=x, grad_rel=dict(zip(WATCH, grads)))
            for i, x in enumerate(signed)]
    assert smoke.step_verdict(recs, smoke.LONG_GRAD_RTOL,
                              smoke.STEP_LOSS_MEAN["bert_long"])["over"] == [
        "loss_not_finite"]


# -- the tensor-core forward's arithmetic ------------------------------------
@pytest.mark.parametrize("B,H,S,d,bias_rows", [(2, 2, 150, 64, 1),
                                               (1, 3, 96, 16, 96)],
                         ids=["padding_mask_ragged", "per_row_d16"])
def test_forward_emulation_matches_reference(monkeypatch, B, H, S, d,
                                             bias_rows):
    """The shipped piece count's arithmetic against the JAX package's
    fused_attention (its Pallas kernel in interpret mode) on the same
    bf16-rounded inputs: out within LONG_RTOL's bf16 limit of its
    largest magnitude."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    R = _tool("fwd_rehearsal")
    rng = np.random.RandomState(S + d)
    q, k, v = (torch.from_numpy(rng.randn(B, H, S, d).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    bias = rng.randn(B, 1, bias_rows, S).astype(np.float32)
    bias[0, ..., -7:] = -1e4
    pieces = R.kernel_pieces()
    o, _ = R.emulate_forward(q, k, v, torch.from_numpy(bias), d ** -0.5,
                             0.0, None, pieces)
    want = np.asarray(JA.fused_attention(*(t.float().numpy()
                                           for t in (q, k, v)), bias))
    rel = np.abs(o.float().numpy() - want).max() / np.abs(want).max()
    assert pieces == 2 and rel <= smoke.LONG_RTOL[torch.bfloat16]["out"]
