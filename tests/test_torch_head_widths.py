"""Head widths and row sizes the port's attention kernels are not built
for, checked on the CPU.

- Fused training attention: the kernels are built for d 16, 32, 64, 128
  and 256, and past 256 for every multiple of 64 (``built_width``);
  ``flash_attention`` and ``flash_attention_backward`` zero-pad any
  other d to the next of these (``padded_forward``,
  ``padded_backward``) and slice o, dq, dk and dv back. The padding
  functions drive the plain version here: plain on the padded operands
  against plain at the true d, forward (o, lse) and backward (dq, dk, dv,
  dbias), fp32 at rtol 1e-5 (atol 1e-6: the padded columns add exact
  zeros, so the two differ only in the order of the sums).
- Decode: a key row of any width is covered by its 16-byte pieces (the
  row rounded up to 16 bytes), rounded up to a power of two of lanes,
  with 2 or 4 pieces a lane past 512 bytes, and past 2048 bytes by 32
  lanes of 4 pieces on each 2048-byte chunk of its columns, one block a
  chunk (``decode_lanes``, ``decode_chunks``: the rule of
  ``csrc/decode_attention.cu``); a row of no bytes is refused.
- A BERT program at d 48 (hidden 96, 2 heads), which the kernels take
  only through the padding, with ``use_fused_attention=True`` and
  ``"packed"``: its 10-step loss matches the reference's at rtol 1e-4
  from the reference's startup state (the reference's Pallas kernels in
  interpret mode; the port's CPU run takes the plain version).
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as JB
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch.kernels import attention as A
from paddle_tpu_torch.models import bert as PB

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(B, H, S, d, bias_shape, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.tensor(rng.randn(B, H, S, d), dtype=torch.float32)
                   for _ in range(4))
    bias = torch.tensor(rng.randn(*bias_shape), dtype=torch.float32)
    bias[..., -2:] = -1e4
    return q, k, v, do, bias


@pytest.mark.parametrize("bias_shape,p", [((2, 1, 1, 37), 0.0),
                                          ((2, 3, 37, 37), 0.1)],
                         ids=["padding_mask", "per_row_dropout"])
@pytest.mark.parametrize("d", [8, 24, 48, 80, 100, 160, 200])
def test_padding_holds_plain_on_padded_to_plain(d, bias_shape, p):
    B, H, S = 2, 3, 37
    q, k, v, do, bias = _inputs(B, H, S, d, bias_shape, d)
    seed = torch.tensor([1000 + d], dtype=torch.int64)
    scale = d ** -0.5
    width = A.built_width(d)
    assert width > d and width in A._HEAD_DIMS
    o, lse = A.padded_forward(A._ref_flash_attention, q, k, v, bias, scale,
                              p, seed)
    want_o, want_lse = A._ref_flash_attention(q, k, v, bias, scale, p, seed)
    assert o.shape == q.shape
    torch.testing.assert_close(o, want_o, **TOL)
    torch.testing.assert_close(lse, want_lse, **TOL)
    got = A.padded_backward(A._ref_flash_attention_backward, q, k, v, bias,
                            seed, do, o, lse, scale, p, True)
    want = A._ref_flash_attention_backward(q, k, v, bias, seed, do, want_o,
                                           want_lse, scale, p, True)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, **TOL, msg=name)


def test_built_widths_and_the_limit():
    """Up to 256 the next of _HEAD_DIMS; past it (once a raise) the next
    multiple of 64, its columns split into that many 64-column chunks,
    one block each."""
    widths = [A.built_width(d) for d in range(1, 257)]
    assert widths == [16] * 16 + [32] * 16 + [64] * 32 + [128] * 64 + \
        [256] * 128
    assert [A.built_width(d) for d in (257, 300, 320, 321, 512, 1000)] == \
        [320, 320, 320, 384, 512, 1024]
    assert [A.column_chunks(d) for d in (16, 256, 257, 512, 1000)] == \
        [1, 1, 5, 8, 16]


def test_padding_leaves_a_built_width_as_it_is():
    """A built width passes with its strides (a packed layout's heads
    reach the kernels without a copy); another is padded with zeros."""
    packed = A._split_heads(torch.randn(2, 5, 3 * 64), 3)
    assert A._pad_heads(packed, 64) is packed
    t = torch.randn(2, 3, 5, 48)
    padded = A._pad_heads(t, 64)
    assert padded.shape == (2, 3, 5, 64) and padded.is_contiguous()
    assert torch.equal(padded[..., :48], t)
    assert not padded[..., 48:].any()


@pytest.mark.parametrize("row_bytes,lanes", [
    (16, (1, 1)), (32, (2, 1)), (48, (4, 1)), (64, (4, 1)), (96, (8, 1)),
    (128, (8, 1)), (192, (16, 1)), (256, (16, 1)), (384, (32, 1)),
    (512, (32, 1)), (8, (1, 1)), (24, (2, 1)), (100, (8, 1)),
    (528, (32, 2)), (768, (32, 2)), (1024, (32, 2)), (1040, (32, 4)),
    (2048, (32, 4)), (2049, (32, 4)), (2560, (32, 4)), (3072, (32, 4)),
    (4096, (32, 4))])
def test_decode_lanes_round_up_to_a_power_of_two(row_bytes, lanes):
    assert A.decode_lanes(row_bytes) == lanes
    assert A.decode_chunks(row_bytes) == -(-row_bytes // 2048)


@pytest.mark.parametrize("row_bytes,match", [(0, "1 byte or more")])
def test_decode_lanes_refuse_other_rows(row_bytes, match):
    with pytest.raises(ValueError, match=match):
        A.decode_lanes(row_bytes)


# -- a BERT program at d 48 against the reference ----------------------------
SEQ, BATCH, STEPS = 64, 2, 10


def _cfg(B, fused):
    cfg = B.BertConfig(vocab_size=1024, hidden=96, n_layers=2, n_heads=2,
                       ffn_hidden=192, max_seq=SEQ)
    cfg.use_fused_attention = fused
    cfg.hidden_dropout = cfg.attn_dropout = 0.0
    return cfg


def _build(B, unique_name, fused):
    with unique_name.guard():
        return B.build_pretrain_program(_cfg(B, fused), seq_len=SEQ)


@pytest.mark.parametrize("fused", [True, "packed"],
                         ids=["per_head", "packed"])
def test_bert_d48_trajectory_matches_reference(monkeypatch, fused):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    main, startup, loss = _build(JB, jfluid.unique_name, fused)
    feed = JB.synthetic_batch(_cfg(JB, fused), BATCH, SEQ, seed=0)
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(startup, scope=jscope)
    names = [v.name for v in main.list_vars() if v.persistable]
    start = {n: np.array(jscope.find_var(n)) for n in names}
    want = [float(jexe.run(main, feed=feed, fetch_list=[loss],
                           scope=jscope)[0][0]) for _ in range(STEPS)]

    pmain, _, ploss = _build(PB, pfluid.unique_name, fused)
    attention = [op for op in pmain.global_block().ops
                 if op.type.startswith("fused_multihead_attention")]
    assert len(attention) == 2
    scope = pfluid.Scope()
    for n, a in start.items():
        scope.set_var(n, torch.tensor(a))
    exe = pfluid.Executor("cpu")
    got = [float(exe.run(pmain, feed=feed, fetch_list=[ploss],
                         scope=scope)[0][0]) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
