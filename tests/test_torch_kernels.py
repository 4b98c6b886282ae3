"""The port's decode-attention module (paddle_tpu_torch/kernels/attention.py)
held to the JAX package's: the same numpy inputs go through both, with
the JAX side's Pallas kernels run in interpret mode. On the CPU the
port's wrappers take their plain PyTorch versions; the CUDA kernels are
held to those plain versions by tests/test_torch_cuda.py on the card.

Tolerances: attention outputs in fp32 at rtol 1e-5, atol 1e-6 (same
math, different summation order); cache and pool writes exactly."""

import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import attention as JA
from paddle_tpu_torch.kernels import attention as PA

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route the JAX package through its Pallas kernels on the CPU."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")

    def force(tier):
        monkeypatch.setenv("PADDLE_TPU_ATTN_FORCE", tier)
    return force


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# Every case keeps at least one live column per row: at a capacity that
# is not a multiple of 128, the JAX decode kernel pads the cache with
# zero columns, and a row whose causal window is empty then averages the
# padding in too (see test_empty_window_matches_reference_plain_version).
@pytest.mark.parametrize("Q,C,lens,causal", [
    (1, 256, [1, 100, 256], False),       # below capacity, full ring
    (1, 200, [7, 200, 523], False),       # ragged capacity, wrapped ring
    (4, 256, [4, 61, 256], True),         # speculative-verify window
    (4, 200, [5, 130, 200], True),        # window at ragged capacity
])
def test_attention_with_cache_matches_reference(pallas_interpret, Q, C,
                                                lens, causal):
    pallas_interpret("decode")
    rng = np.random.RandomState(Q * 1000 + C)
    B, H, d = len(lens), 2, 16
    q, k, v = _rand(rng, B, H, Q, d), _rand(rng, B, H, C, d), \
        _rand(rng, B, H, C, d)
    cache_len = np.array(lens, np.int32)
    assert JA._use_decode_kernel(k), "JAX side did not reach its kernel"
    want = np.asarray(JA.attention_with_cache(q, k, v, cache_len,
                                              causal_window=causal))
    got = PA.attention_with_cache(*_t(q, k, v, cache_len),
                                  causal_window=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_empty_window_matches_reference_plain_version():
    """A causal row whose window is empty (cache_len < Q - r) masks every
    column and averages V uniformly over the capacity. The port follows
    the reference's plain version here; the reference's Pallas decode
    kernel, at a capacity it pads to a multiple of 128, averages its
    zero padding in as well (ROADMAP, queue 3)."""
    rng = np.random.RandomState(3)
    B, H, Q, C, d = 2, 2, 4, 200, 8
    q, k, v = _rand(rng, B, H, Q, d), _rand(rng, B, H, C, d), \
        _rand(rng, B, H, C, d)
    cache_len = np.array([2, 150], np.int32)
    want = np.asarray(JA._ref_attention_cache(
        q, k, v, cache_len, 1.0 / math.sqrt(d), causal_window=True))
    got = PA.attention_with_cache(*_t(q, k, v, cache_len),
                                  causal_window=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy()[0, :, 0], v[0].mean(axis=1),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("npages", [3, 7, 13])
def test_paged_attention_cache_matches_reference(pallas_interpret, npages):
    """Odd and prime page counts, pages scattered over the pool, and
    idle rows (length 1, whole table on scratch page 0) beside live
    ones, as a paged decode step sees them."""
    pallas_interpret("paged")
    rng = np.random.RandomState(npages)
    B, H, d, ptok = 4, 2, 8, 8
    C = npages * ptok
    P = 2 * npages + 1
    k_pool, v_pool = _rand(rng, P, H, ptok, d), _rand(rng, P, H, ptok, d)
    q = _rand(rng, B, H, 1, d)
    table = np.zeros((B, npages), np.int32)
    table[:2] = rng.permutation(np.arange(1, P))[:2 * npages].reshape(
        2, npages)
    cache_len = np.array([C - 3, C + 5, 1, 1], np.int32)
    assert JA._use_paged_kernel(table, ptok), "JAX side did not reach " \
        "its kernel"
    want = np.asarray(JA.paged_attention_cache(q, k_pool, v_pool, table,
                                               cache_len))
    got = PA.paged_attention_cache(*_t(q, k_pool, v_pool, table, cache_len))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    dense = PA.attention_with_cache(
        _t(q)[0], PA.gather_paged_cache(*_t(k_pool, table)),
        PA.gather_paged_cache(*_t(v_pool, table)), _t(cache_len)[0])
    np.testing.assert_array_equal(got.numpy(), dense.numpy())


@pytest.mark.parametrize("T,lens", [
    (4, [0, 0, 0]),        # prefill write at slot 0
    (1, [3, 8, 21]),       # decode writes, the last two past the ring
    (3, [6, 2, 9]),        # a write that would cross the ring end clamps
])
def test_kv_cache_update_matches_reference(T, lens):
    rng = np.random.RandomState(T)
    B, H, C, d = 3, 2, 8, 4
    cache, new = _rand(rng, B, H, C, d), _rand(rng, B, H, T, d)
    cache_len = np.array(lens, np.int32)
    want, want_len = JA.kv_cache_update(cache, new, cache_len)
    got, got_len = PA.kv_cache_update(*_t(cache, new, cache_len))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


@pytest.mark.parametrize("T,lens", [
    (1, [5, 13, 40]),      # decode write, the last one wrapped twice
    (5, [6, 14, 0]),       # writes crossing a page and the ring end
])
def test_paged_kv_cache_update_matches_reference(T, lens):
    rng = np.random.RandomState(10 + T)
    B, H, d, ptok, npages = 3, 2, 4, 4, 4
    P = B * npages + 1
    pool, new = _rand(rng, P, H, ptok, d), _rand(rng, B, H, T, d)
    table = rng.permutation(np.arange(1, P)).reshape(B, npages).astype(
        np.int32)
    cache_len = np.array(lens, np.int32)
    want, want_len = JA.paged_kv_cache_update(jnp.asarray(pool), new, table,
                                              cache_len)
    got, got_len = PA.paged_kv_cache_update(*_t(pool, new, table,
                                                cache_len))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(
        PA.gather_paged_cache(*_t(np.asarray(want), table)).numpy(),
        np.asarray(JA.gather_paged_cache(np.asarray(want), table)))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never computes a CPU
    tensor itself (the public functions route those to the plain
    version)."""
    q = torch.zeros(1, 1, 1, 8)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        PA.decode_attention_kernel(q, q, q, lens, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        PA.paged_attention_kernel(q, q, q, torch.zeros(1, 1,
                                                       dtype=torch.int32),
                                  lens, 1.0)


def test_port_imports_without_jax_triton_or_nvcc():
    """The port's package (its compile cache, telemetry, coordination
    service and serving fleet, the recurrent layers, schedules, clips,
    nets and the book models too) and chip_smoke.py import in a fresh
    interpreter without pulling in jax, any paddle_tpu module or triton,
    and without a CUDA compiler on PATH: the kernels build only at their
    first CUDA launch."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.models.transformer\n"
        "from paddle_tpu_torch.models.transformer import (\n"
        "    ContinuousDecodeSession, SpeculativeDecodeSession,\n"
        "    build_speculative_session)\n"
        "import paddle_tpu_torch.inference.serving\n"
        "import paddle_tpu_torch.inference\n"
        "import paddle_tpu_torch.kernels.attention\n"
        "import paddle_tpu_torch.fluid.executor, paddle_tpu_torch.fluid.layers\n"
        "import paddle_tpu_torch.fluid.optimizer, paddle_tpu_torch.models.bert\n"
        "import paddle_tpu_torch.fluid.io, paddle_tpu_torch.fluid.compat\n"
        "import paddle_tpu_torch.fluid.core.proto_io\n"
        "import paddle_tpu_torch.fluid.core.tensor_io\n"
        "import paddle_tpu_torch.fluid.regularizer\n"
        "import paddle_tpu_torch.fluid.layers.metric_op\n"
        "import paddle_tpu_torch.fluid.ops.metrics\n"
        "import paddle_tpu_torch.models.lenet, paddle_tpu_torch.models.resnet\n"
        "import paddle_tpu_torch.models.deepfm, paddle_tpu_torch.embedding\n"
        "import paddle_tpu_torch.embedding.host, paddle_tpu_torch.fluid.reader\n"
        "import paddle_tpu_torch.fluid.dataset, paddle_tpu_torch.fluid.faults\n"
        "import paddle_tpu_torch.fluid.layers.py_reader\n"
        "import paddle_tpu_torch.fluid.core, paddle_tpu_torch.fluid.ops.autodiff\n"
        "import paddle_tpu_torch.distributed\n"
        "import paddle_tpu_torch.distributed.preemption\n"
        "import paddle_tpu_torch.distributed.wire\n"
        "import paddle_tpu_torch.distributed.coordination\n"
        "import paddle_tpu_torch.fluid.compile_cache\n"
        "import paddle_tpu_torch.telemetry, paddle_tpu_torch.telemetry.flight\n"
        "import paddle_tpu_torch.telemetry.pusher\n"
        "import paddle_tpu_torch.telemetry.aggregate\n"
        "import paddle_tpu_torch.serving, paddle_tpu_torch.serving.replica\n"
        "import paddle_tpu_torch.serving.router\n"
        "import paddle_tpu_torch.serving.supervisor\n"
        "import paddle_tpu_torch.serving.client\n"
        "import paddle_tpu_torch.serving.protocol\n"
        "import paddle_tpu_torch.fluid.clip, paddle_tpu_torch.fluid.nets\n"
        "import paddle_tpu_torch.fluid.layers.rnn\n"
        "import paddle_tpu_torch.fluid.layers.control_flow\n"
        "import paddle_tpu_torch.fluid.layers.sequence_lod\n"
        "import paddle_tpu_torch.fluid.layers.learning_rate_scheduler\n"
        "import paddle_tpu_torch.fluid.layers.math_op_patch\n"
        "import paddle_tpu_torch.fluid.ops.rnn_ops\n"
        "import paddle_tpu_torch.fluid.ops.sequence_ops\n"
        "import paddle_tpu_torch.models.seq2seq\n"
        "import paddle_tpu_torch.models.word2vec\n"
        "import paddle_tpu_torch.models.vgg\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'triton') or\n"
        "       m == 'paddle_tpu' or m.startswith(('paddle_tpu.', 'jax.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, PATH="/usr/bin:/bin")
    env.pop("CUDA_HOME", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
