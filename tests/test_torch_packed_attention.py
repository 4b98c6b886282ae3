"""The port's packed-layout attention (``fused_attention_packed``, the
``fused_multihead_attention_packed`` op, BERT's
``use_fused_attention="packed"``) held to the JAX package on the CPU.

- Kernels: the same numpy inputs through the reference's
  ``fused_attention_packed`` with its Pallas kernels in interpret mode,
  at the shapes where its dispatch picks the packed tier (d 16), the
  resident tier (d 64, H even) and, under ``PADDLE_TPU_ATTN_FORCE=packed``,
  the packed tier at d 64; each case asserts the tier the reference took.
  Both bias shapes the tiers take, [B, 1, 1, S] and [B, H, 1, S].
  Tolerance fp32 rtol 1e-5 on the output, 1e-4 on the gradients of q, k,
  v and bias (atol 1e-5: the same math summed in another order; dbias
  sums S rows, 4.8e-6 absolute read here).
- Dropout: the packages draw different masks, so parity runs at p = 0;
  at p > 0 the port's keep rate and 1/(1-p) scaling, one mask in the
  forward and the backward, and the packed entry equal to the per-head
  entry on the transposed operands.
- Programs: BERT-tiny's packed desc equals the reference's (fp32 and
  AMP), the lowering matches the JAX registry's, and a 10-step loss
  trajectory from the reference's startup state matches within rtol 1e-4
  (fp32) and 4e-3 (AMP: one bf16 rounding step, as
  tests/test_torch_amp.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as JF
from paddle_tpu.fluid import registry as JR
from paddle_tpu.kernels import attention as JA
from paddle_tpu.models import bert as JB
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch.fluid import framework as PF
from paddle_tpu_torch.fluid import registry as PR
from paddle_tpu_torch.kernels import attention as PA
from paddle_tpu_torch.models import bert as PB

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SEQ, BATCH, STEPS = 64, 2, 10


@pytest.fixture
def reference_tiers(monkeypatch):
    """The reference's Pallas kernels in interpret mode; counts the calls
    of its packed and resident tiers' wrappers."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    calls = dict.fromkeys(("packed", "packed_bwd", "res", "res_bwd"), 0)
    for key, name in (("packed", "_pallas_attention_packed"),
                      ("packed_bwd", "_pallas_attention_packed_bwd"),
                      ("res", "_pallas_attention_res"),
                      ("res_bwd", "_pallas_attention_res_bwd")):
        def counted(*a, _key=key, _fn=getattr(JA, name), **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(JA, name, counted)
    return calls


@pytest.mark.parametrize("d,force,tier", [
    (16, None, "packed"),      # BERT-tiny's head width: 2d % 128 != 0
    (64, None, "res"),         # tests/test_kernels.py:546's shape
    (64, "packed", "packed"),  # the measurement hatch
])
@pytest.mark.parametrize("bias_heads", [1, 4])
def test_packed_matches_reference_tiers(reference_tiers, monkeypatch, d,
                                        force, tier, bias_heads):
    if force:
        monkeypatch.setenv("PADDLE_TPU_ATTN_FORCE", force)
    B, S, H = 4, 64, 4
    rng = np.random.RandomState(d + bias_heads)
    q, k, v, do = (rng.randn(B, S, H * d).astype(np.float32)
                   for _ in range(4))
    bias = rng.randn(B, bias_heads, 1, S).astype(np.float32)
    bias[0, ..., -5:] = -1e4          # padded keys of the first row
    qj, bj = jnp.asarray(q), jnp.asarray(bias)
    assert JA._use_res_kernel(qj, H, 0.0, bj) == (tier == "res")
    assert JA._use_packed_kernel(qj, H, 0.0, bj)

    def jax_loss(q_, k_, v_, b_):
        return jnp.sum(JA.fused_attention_packed(q_, k_, v_, b_,
                                                 n_heads=H) * do)

    want_out = np.asarray(JA.fused_attention_packed(q, k, v, bias,
                                                    n_heads=H))
    want_grads = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(q, k, v, bias)
    assert reference_tiers[tier] == 2 and reference_tiers[tier + "_bwd"] == 1

    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    out = PA.fused_attention_packed(*leaves, n_heads=H)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), want_out, **OUT_TOL)
    for name, g, w in zip("q k v bias".split(), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("B,S,H,d,itemsize,bias_heads", [
    (128, 128, 12, 64, 2, 1),      # bert_packed: BERT-base, AMP
    (128, 128, 12, 64, 4, 12),     # fp32, per-head bias
    (8, 256, 3, 64, 2, 3),         # odd H: the packed tier
    (128, 128, 4, 16, 2, 1),       # BERT-tiny
    (2, 512, 12, 64, 2, 1),        # past the packed tier's S
    (32, 512, 12, 64, 4, 1),       # the resident blocks overflow VMEM
])
def test_reference_tier_names_the_tpu_packed_dispatch(monkeypatch, B, S, H,
                                                      d, itemsize,
                                                      bias_heads):
    """The tier chip_smoke.py reports a packed launch under is the one
    the JAX package's own packed dispatch takes for that shape."""
    import chip_smoke

    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    dtype = jnp.bfloat16 if itemsize == 2 else jnp.float32
    q = jax.ShapeDtypeStruct((B, S, H * d), dtype)
    bias = jax.ShapeDtypeStruct((B, bias_heads, 1, S), jnp.float32)
    want = ("resident" if JA._use_res_kernel(q, H, 0.0, bias) else
            "packed" if JA._use_packed_kernel(q, H, 0.0, bias) else
            chip_smoke.reference_tier(S, d))
    assert chip_smoke.reference_tier(
        S, d, (B, H, itemsize, (B, bias_heads, 1, S))) == want


def _seed(n):
    return torch.tensor([n], dtype=torch.int64)


def test_packed_dropout_keep_rate_scale_and_one_mask():
    """Uniform weights (q = k = 0) and v = 1: each output is its row's
    kept share over S (1 - p), and dv holds the dropped weights' column
    sums, so the backward used the forward's mask."""
    B, S, H, d, p = 2, 64, 3, 16, 0.25
    q = torch.zeros(B, S, H * d)
    v = torch.ones(B, S, H * d, requires_grad=True)
    seed = _seed(5)
    out = PA.fused_attention_packed(q, q, v, n_heads=H, dropout_prob=p,
                                    seed=seed)
    keep = PA.dropout_keep_mask(B, H, S, p, seed).float()
    want = keep.sum(-1) / (S * (1 - p))                     # [B, H, S]
    torch.testing.assert_close(PA._split_heads(out.detach(), H)[..., 0],
                               want, rtol=1e-5, atol=1e-6)
    assert abs(keep.mean().item() - (1 - p)) < 0.02
    (dv,) = torch.autograd.grad(out.sum(), v)
    want_dv = (keep / (S * (1 - p))).sum(-2)                # [B, H, S]
    torch.testing.assert_close(PA._split_heads(dv, H)[..., 0], want_dv,
                               rtol=1e-5, atol=1e-6)


def test_packed_equals_per_head_entry_with_dropout():
    """One seed, one Philox mask: the packed entry and fused_attention on
    the transposed operands give the same output and gradients."""
    B, S, H, d, p = 2, 40, 3, 16, 0.1
    rng = np.random.RandomState(1)
    q, k, v, do = (torch.tensor(rng.randn(B, S, H * d), dtype=torch.float32)
                   for _ in range(4))
    bias = torch.tensor(rng.randn(B, 1, 1, S), dtype=torch.float32)
    seed = _seed(77)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
        out = fn(*leaves)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, do))

    packed = run(lambda q_, k_, v_, b_: PA.fused_attention_packed(
        q_, k_, v_, b_, n_heads=H, dropout_prob=p, seed=seed))
    heads = run(lambda q_, k_, v_, b_: PA._merge_heads(PA.fused_attention(
        *(PA._split_heads(t, H) for t in (q_, k_, v_)), b_, dropout_prob=p,
        seed=seed)))
    for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"), packed, heads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=name)


def test_packed_entry_refuses_bad_heads_and_gives_meta_shapes():
    q = torch.zeros(2, 8, 30)
    with pytest.raises(ValueError, match="n_heads"):
        PA.fused_attention_packed(q, q, q, n_heads=4)
    m = torch.empty(2, 8, 48, device="meta")
    out = PA.fused_attention_packed(m, m, m, n_heads=3)
    assert out.device.type == "meta" and out.shape == (2, 8, 48)
    heads = PA._split_heads(torch.zeros(2, 8, 48), 3)
    with pytest.raises(ValueError, match="CUDA"):
        PA.fused_attention_fwd_kernel(heads, heads, heads, None, (0, 0, 0),
                                      None, 1.0, 0.0)


def test_packed_op_matches_reference_lowering():
    """fused_multihead_attention_packed through both registries (p = 0,
    an explicit scale and a per-head bias)."""
    rng = np.random.RandomState(3)
    B, S, H, d = 2, 12, 3, 16
    feeds = {n: rng.randn(B, S, H * d).astype(np.float32)
             for n in ("q", "k", "v")}
    feeds["b"] = rng.randn(B, H, 1, S).astype(np.float32)
    vars_ = [dict(name=n, shape=list(a.shape), dtype="float32",
                  persistable=False, stop_gradient=False, is_data=False,
                  is_parameter=False, trainable=False)
             for n, a in feeds.items()]
    vars_.append(dict(vars_[0], name="out", shape=[]))
    op = dict(type="fused_multihead_attention_packed",
              inputs={"Q": ["q"], "K": ["k"], "V": ["v"], "Bias": ["b"]},
              outputs={"Out": ["out"]},
              attrs={"dropout_prob": 0.1, "is_test": True, "n_heads": H,
                     "scale": 0.2})
    desc = dict(version=1, random_seed=0, param_grad_map={},
                blocks=[dict(idx=0, parent_idx=-1, vars=vars_, ops=[op])])
    jblock = JF.Program.from_desc(desc).global_block()
    jenv = {n: jnp.asarray(a) for n, a in feeds.items()}
    JR.lower_op(JR.LowerCtx(jblock, jenv, jax.random.PRNGKey(0)),
                jblock.ops[0])
    pblock = PF.Program.from_desc(desc).global_block()
    penv = {n: torch.tensor(a) for n, a in feeds.items()}
    PR.lower_op(PR.LowerCtx(pblock, penv, torch.Generator().manual_seed(0),
                            "cpu"), pblock.ops[0])
    np.testing.assert_allclose(penv["out"].numpy(), np.asarray(jenv["out"]),
                               **OUT_TOL)


# -- BERT-tiny with the packed layout ----------------------------------------
def _cfg(B, dropout=0.0):
    cfg = B.BertConfig.tiny()
    cfg.use_fused_attention = "packed"
    cfg.hidden_dropout = cfg.attn_dropout = dropout
    return cfg


def _build(B, unique_name, amp=False, dropout=0.0):
    with unique_name.guard():
        return B.build_pretrain_program(_cfg(B, dropout), seq_len=SEQ,
                                        use_amp=amp)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_packed_bert_desc_matches_reference(amp):
    jm, js, jl = _build(JB, jfluid.unique_name, amp, dropout=0.1)
    pm, ps, pl = _build(PB, pfluid.unique_name, amp, dropout=0.1)
    assert pl.name == jl.name
    assert ps.to_desc() == js.to_desc()
    got = pm.to_desc()
    assert got == jm.to_desc()
    ops = got["blocks"][0]["ops"]
    packed = [o for o in ops if o["type"] == "fused_multihead_attention_packed"]
    assert len(packed) == 2 and all(o["attrs"]["n_heads"] == 4
                                    for o in packed)
    assert not any(o["type"] == "transpose" and "attn" in str(o["inputs"])
                   for o in ops)
    if amp:
        # Q, K, V run bf16 already (the projections' outputs, whose
        # declared dtype a gray op leaves as it was); the fp32 bias is
        # cast down in front of the white op
        assert all(o["inputs"]["Bias"][0].endswith(".cast_bfloat16")
                   for o in packed)


@pytest.mark.parametrize("amp,rtol", [(False, 1e-4), (True, 4e-3)],
                         ids=["fp32", "amp"])
def test_packed_bert_tiny_trajectory_matches_reference(amp, rtol):
    main, startup, loss = _build(JB, jfluid.unique_name, amp)
    feed = JB.synthetic_batch(_cfg(JB), BATCH, SEQ, seed=0)
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(startup, scope=jscope)
    names = [v.name for v in main.list_vars() if v.persistable]
    start = {n: np.array(jscope.find_var(n)) for n in names}
    want = [float(jexe.run(main, feed=feed, fetch_list=[loss],
                           scope=jscope)[0][0]) for _ in range(STEPS)]

    pmain, _, ploss = _build(PB, pfluid.unique_name, amp)
    scope = pfluid.Scope()
    for n, a in start.items():
        scope.set_var(n, torch.tensor(a))
    exe = pfluid.Executor("cpu")
    got = [float(exe.run(pmain, feed=feed, fetch_list=[ploss],
                         scope=scope)[0][0]) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert got[-1] < got[0]


def test_packed_bert_trains_with_dropout_on_cpu():
    """BERT-tiny packed with its dropouts (0.1) on: finite losses that
    fall on a memorised batch; two scopes seeded alike agree."""
    main, startup, loss = _build(PB, pfluid.unique_name, dropout=0.1)
    feed = PB.synthetic_batch(_cfg(PB), BATCH, SEQ, seed=0)
    runs = []
    for _ in range(2):
        scope, exe = pfluid.Scope(), pfluid.Executor("cpu")
        exe.run(startup, scope=scope)
        runs.append([float(exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=scope)[0][0]) for _ in range(4)])
    assert runs[0] == runs[1]
    assert np.all(np.isfinite(runs[0])) and runs[0][-1] < runs[0][0]
