"""The port's recurrent, structured-loss, reduce and LoD-rebinding ops
(paddle_tpu_torch/fluid/ops/rnn_ops.py ``dynamic_gru`` / ``cudnn_lstm``,
structured_loss_ops.py, math.py, loss.py, misc_ops.py) held to the JAX
package on the CPU.

- Each op: the same seeded numpy inputs through both registries'
  lowerings, with sequences of lengths 0 and 1, one at the time bound,
  and padding rows of random values past ``sum(lengths)``; outputs and
  the gradients of every float input under a random cotangent at rtol
  1e-5 (fp32), integer outputs (Viterbi paths, ``ctc_align``, edit
  distances) exactly. A LoD op runs over the flat row bound (the
  reference's) and at the tight time bound.
- ``nce`` and the sampled softmax draw from the port's generator, so
  they are held to a jnp oracle of the reference's formula fed the
  port's own samples, forward and gradients; their draws and the cudnn
  LSTM's dropout masks replay under a ``DrawRecord``.
- The cudnn LSTM's dropout at p 0.5: the keep rate, the 1 / keep
  scaling, and the same mask in the forward and the backward.
- Every op lowers on ``meta`` tensors (no value read on the host).
- The layers build the reference's descs; the refusals raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import framework as JF
from paddle_tpu.fluid import lod as JL
from paddle_tpu.fluid import registry as JR
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch.fluid import framework as PF
from paddle_tpu_torch.fluid import lod as PL
from paddle_tpu_torch.fluid import registry as PR

RTOL, ATOL = 1e-5, 1e-6
I32, I64 = np.int32, np.int64

_R = np.random.RandomState(22)


def _f(*shape, scale=1.0):
    return (_R.randn(*shape) * scale).astype(np.float32)


def _ids(rows, high, low=0):
    return _R.randint(low, high, (rows, 1)).astype(I64)


# 11 tokens in 14 rows: an empty sequence, a length-1 one, and the
# longest (5) at the tight bound
LENS = np.array([3, 1, 0, 5, 2], I32)
ROWS = 14
N = LENS.shape[0]


def _desc(op_type, inputs, outputs, attrs):
    vars_ = {}
    for items in inputs.values():
        for name, arr in items.items():
            vars_[name] = dict(name=name, shape=list(arr.shape),
                               dtype=str(arr.dtype), persistable=False,
                               stop_gradient=False, is_data=False,
                               is_parameter=False, trainable=False)
    for names in outputs.values():
        for name in names:
            vars_.setdefault(name, dict(
                name=name, shape=[], dtype="float32", persistable=False,
                stop_gradient=False, is_data=False, is_parameter=False,
                trainable=False))
    op = dict(type=op_type, inputs={s: list(d) for s, d in inputs.items()},
              outputs=dict(outputs), attrs=dict(attrs))
    return dict(version=1, random_seed=0, param_grad_map={},
                blocks=[dict(idx=0, parent_idx=-1, vars=list(vars_.values()),
                             ops=[op])])


def _port_env(block, feeds, lods, bounds, args=None, wrt=(), record=None,
              gen=None):
    env = {n: torch.tensor(a) for n, a in feeds.items()}
    env.update(zip(wrt, args or ()))
    env.update((PL.lod_name(n), torch.tensor(v)) for n, v in lods.items())
    env.update((PL.bound_name(n), b) for n, b in (bounds or {}).items())
    ctx = PR.LowerCtx(block, env, gen or torch.Generator().manual_seed(0),
                      "cpu")
    ctx.draw_record = record
    if record is not None:
        record.at_op(0)
    PR.lower_op(ctx, block.ops[0])
    return env


def _lower_both(op_type, inputs, outputs, attrs, lods, bounds_list=(None,),
                wrt=()):
    """For each time-bound map in ``bounds_list``: {name: (reference's,
    port's)} of each output, output @LOD, and gradient (``name@GRAD``) of
    each input in ``wrt`` under one random cotangent on every float
    output. The reference runs once, over its flat bound."""
    desc = _desc(op_type, inputs, outputs, attrs)
    feeds = {n: a for d in inputs.values() for n, a in d.items()}
    out_names = [n for names in outputs.values() for n in names]
    jblock = JF.Program.from_desc(desc).global_block()
    pblock = PF.Program.from_desc(desc).global_block()

    def jrun(args):
        env = {n: jnp.asarray(a) for n, a in feeds.items()}
        env.update(zip(wrt, args))
        env.update((JL.lod_name(n), jnp.asarray(v)) for n, v in lods.items())
        JR.lower_op(JR.LowerCtx(jblock, env, jax.random.PRNGKey(0)),
                    jblock.ops[0])
        return env

    def f(*args):
        env = jrun(list(args))
        outs = {n: env[n] for n in out_names if n in env}
        outs.update((JL.lod_name(n), env[JL.lod_name(n)]) for n in list(outs)
                    if JL.lod_name(n) in env)
        fl = {n: v for n, v in outs.items()
              if jnp.issubdtype(v.dtype, jnp.floating)}
        return fl, outs

    # one compiled trace gives the outputs and, where asked, the gradients
    fl, vjp, jouts = jax.vjp(jax.jit(f),
                             *[jnp.asarray(feeds[n]) for n in wrt],
                             has_aux=True)
    want = {n: np.asarray(v) for n, v in jouts.items()}
    cot = {n: np.asarray(_R.randn(*want[n].shape), np.float32) for n in fl}
    fl = list(fl)
    if wrt:
        want.update((n + "@GRAD", np.asarray(g)) for n, g in zip(
            wrt, vjp({n: jnp.asarray(cot[n]) for n in fl})))
    results = []
    for bounds in bounds_list:
        pargs = [torch.tensor(feeds[n], requires_grad=True) for n in wrt]
        penv = _port_env(pblock, feeds, lods, bounds, pargs, wrt)
        got = {n: penv[n].detach().numpy() for n in want
               if not n.endswith("@GRAD")}
        if wrt:
            # an output that depends on no input (a parity slot of
            # zeros) has no graph: its cotangent adds nothing
            live = [n for n in fl if penv[n].requires_grad]
            grads = torch.autograd.grad(
                [penv[n] for n in live], pargs,
                [torch.tensor(cot[n]) for n in live], allow_unused=True)
            got.update((n + "@GRAD", np.zeros_like(feeds[n]) if g is None
                        else g.numpy()) for n, g in zip(wrt, grads))
        results.append({n: (want[n], got[n]) for n in want})
    return results


def _check(pairs, skip=()):
    for name, (want, got) in pairs.items():
        if name in skip:
            continue
        assert got.shape == want.shape, (name, got.shape, want.shape)
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got.astype(I64),
                                          want.astype(I64), err_msg=name)


def _tight(lods):
    """The flat bound, the longest length, and the executor's bucket."""
    return (None, {n: max(int(v.max()), 1) for n, v in lods.items()},
            {n: PL.length_bound(int(v.max()), ROWS) for n, v in lods.items()})


# -- dynamic_gru --------------------------------------------------------------

H = 4


def _gru_case(reverse=False, origin=False, h0=False, act="tanh"):
    ins = {"Input": {"x": _f(ROWS, 3 * H, scale=0.5)},
           "Weight": {"w": _f(H, 3 * H, scale=0.5)},
           "Bias": {"b": _f(1, 3 * H, scale=0.5)}}
    if h0:
        ins["H0"] = {"h0": _f(N, H, scale=0.5)}
    attrs = {"is_reverse": reverse, "origin_mode": origin,
             "gate_activation": "sigmoid", "activation": act}
    return ("dynamic_gru", ins, {"Hidden": ["h"]}, attrs, {"x": LENS},
            [n for d in ins.values() for n in d])


GRU_CASES = {
    "forward": _gru_case(),
    "reverse": _gru_case(reverse=True),
    "origin": _gru_case(origin=True),
    "origin_reverse_h0": _gru_case(reverse=True, origin=True, h0=True),
    "h0": _gru_case(h0=True),
    "relu": _gru_case(act="relu", reverse=True),
}


@pytest.mark.parametrize("case", sorted(GRU_CASES))
def test_dynamic_gru_matches_reference(case):
    op_type, inputs, outputs, attrs, lods, wrt = GRU_CASES[case]
    for pairs in _lower_both(op_type, inputs, outputs, attrs, lods,
                             _tight(lods), wrt=wrt):
        assert {"h", "h@LOD", "x@GRAD", "w@GRAD"} <= set(pairs)
        _check(pairs)


# -- the cudnn LSTM -----------------------------------------------------------

def _lstm_case(layers, T=4, B=3, I=5, Hd=4, dropout=0.0, is_test=False):
    size = sum((I if i == 0 else Hd) * 4 * Hd + Hd * 4 * Hd + 4 * Hd
               for i in range(layers))
    ins = {"Input": {"x": _f(T, B, I)},
           "InitH": {"h0": _f(layers, B, Hd, scale=0.5)},
           "InitC": {"c0": _f(layers, B, Hd, scale=0.5)},
           "W": {"w": _f(size, scale=0.3)}}
    attrs = {"hidden_size": Hd, "num_layers": layers,
             "dropout_prob": dropout, "is_test": is_test}
    return ("cudnn_lstm", ins, {"Out": ["o"], "LastH": ["lh"],
                                "LastC": ["lc"]}, attrs, {},
            ["x", "h0", "c0", "w"])


@pytest.mark.parametrize("layers,op_type,is_test", [
    (2, "cudnn_lstm", False), (2, "lstm", False), (3, "cudnn_lstm", True),
    (1, "lstm", False)])
def test_cudnn_lstm_matches_reference(layers, op_type, is_test):
    """Dropout 0 (and the eval path at p 0.5) for parity: the blob's
    layout, the [i, f, c~, o] gates and LastH / LastC stacked over
    layers."""
    _, inputs, outputs, attrs, lods, wrt = _lstm_case(
        layers, dropout=0.5 if is_test else 0.0, is_test=is_test)
    (pairs,) = _lower_both(op_type, inputs, outputs, attrs, lods, wrt=wrt)
    assert pairs["lh"][0].shape == (layers, 3, 4)
    _check(pairs)


def _plain_lstm(x, h0, c0, w, Hd, masks, keep):
    """The stacked LSTM written out with the given inter-layer masks."""
    outs, off = x, 0
    for layer in range(h0.shape[0]):
        in_dim = outs.shape[-1]
        wx = w[off:off + in_dim * 4 * Hd].reshape(in_dim, 4 * Hd)
        off += in_dim * 4 * Hd
        wh = w[off:off + Hd * 4 * Hd].reshape(Hd, 4 * Hd)
        off += Hd * 4 * Hd
        b = w[off:off + 4 * Hd]
        off += 4 * Hd
        h, c, hs = h0[layer], c0[layer], []
        for t in range(outs.shape[0]):
            g = outs[t] @ wx + b + h @ wh
            c = torch.sigmoid(g[:, Hd:2 * Hd]) * c + torch.sigmoid(
                g[:, :Hd]) * torch.tanh(g[:, 2 * Hd:3 * Hd])
            h = torch.sigmoid(g[:, 3 * Hd:]) * torch.tanh(c)
            hs.append(h)
        outs = torch.stack(hs)
        if layer < h0.shape[0] - 1:
            outs = outs * masks[layer] / keep
    return outs


def test_cudnn_lstm_dropout_rate_scale_and_mask():
    """p 0.5 in training: the masks (uniform draws below 1 - p, recorded
    by a DrawRecord) keep about half of each inner layer's outputs,
    scale the kept by 2, and the same masks give the forward and the
    backward: the op's output and its input gradients equal a plain
    stacked LSTM's under those masks."""
    p, Hd = 0.5, 32
    _, inputs, outputs, attrs, _, wrt = _lstm_case(
        3, T=8, B=16, I=8, Hd=Hd, dropout=p)
    desc = _desc("cudnn_lstm", inputs, outputs, attrs)
    block = PF.Program.from_desc(desc).global_block()
    feeds = {n: a for d in inputs.values() for n, a in d.items()}
    args = [torch.tensor(feeds[n], requires_grad=True) for n in wrt]
    record = PR.DrawRecord()
    env = _port_env(block, feeds, {}, None, args, wrt, record=record)
    draws = record.draws[0]
    assert len(draws) == 2 and all(d.shape == (8, 16, Hd) for d in draws)
    masks = [(d < 1 - p).float() for d in draws]
    rate = float(torch.stack(masks).mean())
    assert abs(rate - (1 - p)) < 0.03, rate
    oracle_args = [torch.tensor(feeds[n], requires_grad=True) for n in wrt]
    want = _plain_lstm(*oracle_args, Hd, masks, 1 - p)
    torch.testing.assert_close(env["o"], want, rtol=RTOL, atol=ATOL)
    cot = torch.randn(want.shape, generator=torch.Generator().manual_seed(1))
    got_g = torch.autograd.grad(env["o"], args, cot)
    want_g = torch.autograd.grad(want, oracle_args, cot)
    for n, g, w in zip(wrt, got_g, want_g):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=n)
    record.replaying = True
    again = _port_env(block, feeds, {}, None, args, wrt, record=record)
    assert torch.equal(again["o"], env["o"])


# -- the CRF ------------------------------------------------------------------

K = 4
CRF_INPUTS = {"Emission": {"em": _f(ROWS, K)},
              "Transition": {"tr": _f(K + 2, K, scale=0.5)},
              "Label": {"lab": _ids(ROWS, K)}}


def test_linear_chain_crf_matches_reference():
    """LogLikelihood, Alpha and the exponentials, with the emission's and
    the transition's gradients."""
    lods = {"em": LENS, "lab": LENS}
    for pairs in _lower_both(
            "linear_chain_crf", CRF_INPUTS,
            {"LogLikelihood": ["ll"], "Alpha": ["al"],
             "EmissionExps": ["ee"], "TransitionExps": ["te"]}, {}, lods,
            _tight(lods), wrt=["em", "tr"]):
        assert {"ll", "al", "em@GRAD", "tr@GRAD"} <= set(pairs)
        assert pairs["ll"][1].shape == (N, 1)
        _check(pairs)


@pytest.mark.parametrize("ties", [False, True])
def test_crf_decoding_paths_equal_reference(ties):
    """The Viterbi paths exactly, with the emission's LoD; with ``ties``
    the scores are small integers, so many candidates tie and the lower
    tag must win."""
    em = CRF_INPUTS["Emission"]["em"]
    tr = CRF_INPUTS["Transition"]["tr"]
    if ties:
        em = np.round(em).astype(np.float32)
        tr = np.round(tr).astype(np.float32)
    lods = {"em": LENS}
    for pairs in _lower_both(
            "crf_decoding", {"Emission": {"em": em},
                             "Transition": {"tr": tr}},
            {"ViterbiPath": ["path"]}, {}, lods, _tight(lods)):
        assert pairs["path"][1].dtype == I64
        _check(pairs)


# -- CTC, greedy decoding, edit distance --------------------------------------

V = 5
# the last sequence needs 3 labels in 2 frames: an impossible alignment
CTC_LLENS = np.array([3, 1, 0, 5, 2], I32)
CTC_TLENS = np.array([2, 1, 0, 2, 3], I32)
CTC_LABELS = np.array([[1], [1], [3], [2], [4], [4], [2], [3], [1],
                       [2], [3]], I64)


@pytest.mark.parametrize("norm", [False, True])
def test_warpctc_lod_matches_reference(norm):
    """Repeated labels, an empty pair and an impossible alignment (a
    finite loss, optax's convention); the logits' gradients."""
    lods = {"lg": CTC_LLENS, "y": CTC_TLENS}
    for pairs in _lower_both(
            "warpctc", {"Logits": {"lg": _f(ROWS, V)},
                        "Label": {"y": CTC_LABELS}},
            {"Loss": ["loss"], "WarpCTCGrad": ["wg"]},
            {"blank": 0, "norm_by_times": norm}, lods,
            _tight(lods)[:2], wrt=["lg"]):
        assert np.isfinite(pairs["loss"][1]).all()
        _check(pairs, skip=("wg",))


def test_warpctc_padded_matches_reference():
    lg = _f(3, 6, V)
    y = np.array([[1, 2, 2, 0], [3, 1, 4, 2], [2, 0, 0, 0]], I64)
    (pairs,) = _lower_both(
        "warpctc", {"Logits": {"lg": lg}, "Label": {"y": y},
                    "LogitsLength": {"ll": np.array([6, 3, 1], I64)},
                    "LabelLength": {"yl": np.array([3, 4, 0], I64)}},
        {"Loss": ["loss"], "WarpCTCGrad": ["wg"]},
        {"blank": 0, "padded": True, "norm_by_times": True}, {},
        wrt=["lg"])
    _check(pairs)


def test_ctc_align_equals_reference():
    ids = np.array([[0], [2], [2], [1], [0], [1], [1], [3], [0], [0], [2],
                    [5], [4], [6]], I64)
    lods = {"ids": LENS}
    for pairs in _lower_both("ctc_align", {"Input": {"ids": ids}},
                             {"Output": ["out"]}, {"blank": 0}, lods,
                             _tight(lods)):
        assert "out@LOD" in pairs
        _check(pairs)


HYP_LENS = np.array([3, 1, 0, 5, 2], I32)
REF_LENS = np.array([2, 0, 3, 4, 1], I32)


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance_lod_equals_reference(normalized):
    lods = {"h": HYP_LENS, "r": REF_LENS}
    for pairs in _lower_both(
            "edit_distance", {"Hyps": {"h": _ids(ROWS, 3)},
                              "Refs": {"r": _ids(12, 3)}},
            {"Out": ["d"], "SequenceNum": ["sn"]},
            {"normalized": normalized}, lods, _tight(lods)):
        _check(pairs)


def test_edit_distance_padded_equals_reference():
    (pairs,) = _lower_both(
        "edit_distance", {"Hyps": {"h": _ids(4, 3).reshape(2, 2)},
                          "Refs": {"r": _ids(6, 3).reshape(2, 3)},
                          "HypsLength": {"hl": np.array([2, 1], I64)},
                          "RefsLength": {"rl": np.array([3, 0], I64)}},
        {"Out": ["d"], "SequenceNum": ["sn"]},
        {"normalized": False, "padded": True}, {})
    _check(pairs)


# -- the sampled losses -------------------------------------------------------

@pytest.mark.parametrize("bias", [True, False])
def test_hierarchical_sigmoid_matches_reference(bias):
    C = 7
    ins = {"X": {"x": _f(6, 5)}, "W": {"w": _f(C - 1, 5)},
           "Label": {"lab": _ids(6, C)}}
    if bias:
        ins["Bias"] = {"b": _f(C - 1, 1)}
    (pairs,) = _lower_both(
        "hierarchical_sigmoid", ins, {"Out": ["out"], "PreOut": ["pre"]},
        {"num_classes": C}, {},
        wrt=["x", "w"] + (["b"] if bias else []))
    _check(pairs)


def _sampled(op_type, ins, outs, attrs, wrt, oracle, sample_slot):
    """The port's op on ``ins``; then ``oracle(samples, *wrt arrays)``
    (jnp) fed the port's samples: every float output and the gradients
    of ``wrt`` under one cotangent."""
    desc = _desc(op_type, ins, outs, attrs)
    block = PF.Program.from_desc(desc).global_block()
    feeds = {n: a for d in ins.values() for n, a in d.items()}
    args = [torch.tensor(feeds[n], requires_grad=True) for n in wrt]
    env = _port_env(block, feeds, {}, None, args, wrt)
    samples = env[outs[sample_slot][0]].numpy()
    fl = [n for names in outs.values() for n in names
          if env[n].is_floating_point()]
    want, vjp = jax.vjp(jax.jit(lambda *a: oracle(jnp.asarray(samples), *a)),
                        *[jnp.asarray(feeds[n]) for n in wrt])
    cot = [_R.randn(*np.shape(w)).astype(np.float32) for w in want]
    got_g = torch.autograd.grad([env[n] for n in fl], args,
                                [torch.tensor(c) for c in cot])
    for n, w in zip(fl, want):
        np.testing.assert_allclose(env[n].detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    for n, g, w in zip(wrt, got_g, vjp(tuple(jnp.asarray(c) for c in cot))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=n + "@GRAD")
    return samples, block, feeds


def test_nce_matches_the_reference_formula_on_its_samples():
    B, D, C, S = 6, 5, 9, 7
    lab = _ids(B, C)

    def oracle(neg, x, w, b):
        # the reference's lowering (structured_loss_ops.py _nce)
        l = jnp.asarray(lab[:, 0])
        pos = jnp.sum(x * w[l], axis=1) + b[l]
        negl = jnp.einsum("bd,bsd->bs", x, w[neg]) + b[neg]
        logq = jnp.log(jnp.asarray(S / C, x.dtype))
        cost = -(jax.nn.log_sigmoid(pos - logq)
                 + jnp.sum(jax.nn.log_sigmoid(-(negl - logq)), axis=1))
        return cost[:, None], negl

    samples, block, feeds = _sampled(
        "nce", {"Input": {"x": _f(B, D)}, "Label": {"lab": lab},
                "Weight": {"w": _f(C, D)}, "Bias": {"b": _f(C)}},
        {"Cost": ["cost"], "SampleLogits": ["sl"], "SampleLabels": ["sy"]},
        {"num_total_classes": C, "num_neg_samples": S}, ["x", "w", "b"],
        oracle, "SampleLabels")
    assert samples.shape == (B, S) and samples.dtype == I64
    assert samples.min() >= 0 and samples.max() < C
    # repeats, so the weight gradient sums rows of one class
    assert len(np.unique(samples)) < samples.size


def test_sampled_softmax_matches_the_reference_formula_on_its_samples():
    B, C, S = 6, 8, 5
    lab = _ids(B, C)

    def oracle(neg, logits):
        l = jnp.asarray(lab[:, 0])
        true = logits[jnp.arange(B), l][:, None]
        negl = jnp.take_along_axis(logits, neg, axis=1)
        logq = jnp.log(jnp.asarray(S / C, logits.dtype))
        cat = jnp.concatenate([true, jnp.where(neg == l[:, None], -1e30,
                                               negl - logq)], axis=1)
        return (-jax.nn.log_softmax(cat, axis=1)[:, :1],)

    for op_type in ("sampled_softmax_with_cross_entropy", "sample_logits"):
        samples, _, _ = _sampled(
            op_type, {"Logits": {"lg": _f(B, C)}, "Label": {"lab": lab}},
            {"Loss": ["loss"], "Samples": ["smp"]}, {"num_samples": S},
            ["lg"], oracle, "Samples")
        assert samples.shape == (B, S) and samples.max() < C
        # the masked hits of the true class happen at these sizes
        assert (samples == lab).any()


def test_draws_replay_under_a_draw_record():
    """A recorded run's negatives come back when the record replays
    (recompute's second forward), with no draw from the generator."""
    ins = {"Input": {"x": _f(4, 3)}, "Label": {"lab": _ids(4, 6)},
           "Weight": {"w": _f(6, 3)}}
    desc = _desc("nce", ins, {"Cost": ["c"], "SampleLabels": ["s"]},
                 {"num_total_classes": 6, "num_neg_samples": 5})
    block = PF.Program.from_desc(desc).global_block()
    feeds = {n: a for d in ins.values() for n, a in d.items()}
    gen = torch.Generator().manual_seed(3)
    record = PR.DrawRecord()
    first = _port_env(block, feeds, {}, None, record=record, gen=gen)
    state = gen.get_state()
    record.replaying = True
    again = _port_env(block, feeds, {}, None, record=record, gen=gen)
    assert torch.equal(first["s"], again["s"])
    assert torch.equal(first["c"], again["c"])
    assert torch.equal(gen.get_state(), state)
    other = _port_env(block, feeds, {}, None, gen=gen)
    assert not torch.equal(first["s"], other["s"])


# -- cos_sim, square_error_cost, the reduce family, arg_max -------------------

X3 = _f(3, 4, 5)
# planted ties (max and min) and a zero for the product
TIED = np.round(_f(3, 4, 5)).astype(np.float32)
NEAR1 = (1 + 0.3 * _f(3, 4, 5)).astype(np.float32)
NEAR1[1, 2, 3] = 0.0

DENSE_CASES = {
    "cos_sim": ("cos_sim", {"X": {"x": _f(6, 5)}, "Y": {"y": _f(6, 5)}},
                {}, ["x", "y"]),
    "cos_sim_broadcast": ("cos_sim", {"X": {"x": _f(6, 5)},
                                      "Y": {"y": _f(1, 5)}}, {}, ["x", "y"]),
    "square_error_cost": ("square_error_cost", {"X": {"x": _f(6, 3)},
                                                "Y": {"y": _f(6, 3)}},
                          {}, ["x", "y"]),
    "arg_max": ("arg_max", {"X": {"x": TIED}}, {"axis": -1}, []),
}
_DIMS = {"all": {"reduce_all": True, "dim": [0], "keep_dim": False},
         "dim1": {"reduce_all": False, "dim": [1], "keep_dim": False},
         "dims_keep": {"reduce_all": False, "dim": [-1, 0],
                       "keep_dim": True}}
for _t in ("mean", "max", "min", "prod", "all", "any"):
    for _d, _a in _DIMS.items():
        _x = {"max": TIED, "min": TIED, "prod": NEAR1,
              "all": NEAR1, "any": np.where(TIED > 1, TIED, 0)}.get(_t, X3)
        DENSE_CASES["reduce_%s_%s" % (_t, _d)] = (
            "reduce_" + _t, {"X": {"x": _x.astype(np.float32)}}, _a,
            [] if _t in ("all", "any") else ["x"])


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_op_and_gradient_match_reference(case):
    """Max and min share a tied maximum's gradient evenly, as JAX does."""
    op_type, inputs, attrs, wrt = DENSE_CASES[case]
    (pairs,) = _lower_both(op_type, inputs, {"Out": ["out"]}, attrs, {},
                           wrt=wrt)
    _check(pairs)


# -- lod_reset / lod_append ---------------------------------------------------

def test_lod_reset_and_append_match_reference():
    """The new lengths from an attribute, from Y's LoD and from Y's int
    offsets equal the reference's; the time bound comes along where the
    host knows the target, else the op falls back to the rows."""
    x = _f(ROWS, 2)
    cases = [
        ("lod_reset", {"X": {"x": x}}, {"target_lod": [0, 4, 4, 11, 14]},
         {}, PL.length_bound(7, ROWS)),
        ("lod_reset", {"X": {"x": x}, "Y": {"y": _f(ROWS, 1)}}, {},
         {"y": LENS}, 5),
        ("lod_reset", {"X": {"x": x},
                       "Y": {"y": np.array([0, 2, 9, 14], I32)}}, {}, {},
         None),
        ("lod_append", {"X": {"x": x}}, {"level": [0, 1, 3, 14]}, {},
         PL.length_bound(11, ROWS)),
    ]
    for op_type, inputs, attrs, lods, bound in cases:
        (pairs,) = _lower_both(op_type, inputs, {"Out": ["out"]}, attrs,
                               lods, ({"y": 5} if lods else None,))
        assert "out@LOD" in pairs
        _check(pairs)
        block = PF.Program.from_desc(_desc(op_type, inputs, {"Out": ["out"]},
                                           attrs)).global_block()
        env = _port_env(block, {n: a for d in inputs.values()
                                for n, a in d.items()}, lods,
                        {"y": 5} if lods else None)
        assert env.get(PL.bound_name("out")) == bound, (op_type, attrs)


# -- no value read on the host ------------------------------------------------

def test_no_op_reads_a_value_on_the_host():
    """Each new op lowers on ``meta`` tensors, lengths included, so a step
    of them captures into a CUDA graph."""
    cases = {k: v[:5] for k, v in GRU_CASES.items()}
    cases["lstm"] = _lstm_case(2, dropout=0.5)[:5]
    cases["crf"] = ("linear_chain_crf", CRF_INPUTS,
                    {"LogLikelihood": ["ll"], "Alpha": ["al"]}, {},
                    {"em": LENS, "lab": LENS})
    cases["viterbi"] = ("crf_decoding", {k: CRF_INPUTS[k] for k in (
        "Emission", "Transition")}, {"ViterbiPath": ["p"]}, {},
        {"em": LENS})
    cases["ctc"] = ("warpctc", {"Logits": {"lg": _f(ROWS, V)},
                                "Label": {"y": CTC_LABELS}},
                    {"Loss": ["l"]}, {}, {"lg": CTC_LLENS, "y": CTC_TLENS})
    cases["align"] = ("ctc_align", {"Input": {"i": _ids(ROWS, 4)}},
                      {"Output": ["o"]}, {}, {"i": LENS})
    cases["edit"] = ("edit_distance", {"Hyps": {"h": _ids(ROWS, 3)},
                                       "Refs": {"r": _ids(12, 3)}},
                     {"Out": ["d"], "SequenceNum": ["sn"]}, {},
                     {"h": HYP_LENS, "r": REF_LENS})
    cases["nce"] = ("nce", {"Input": {"x": _f(4, 3)},
                            "Label": {"l": _ids(4, 6)},
                            "Weight": {"w": _f(6, 3)}},
                    {"Cost": ["c"]}, {"num_total_classes": 6}, {})
    cases["sampled"] = ("sample_logits", {"Logits": {"x": _f(4, 6)},
                                          "Label": {"l": _ids(4, 6)}},
                        {"Loss": ["c"]}, {"num_samples": 3}, {})
    cases["reset"] = ("lod_reset", {"X": {"x": _f(ROWS, 2)},
                                    "Y": {"y": np.array([0, 2, 14], I32)}},
                      {"Out": ["o"]}, {}, {})
    meta = torch.device("meta")
    for case, (op_type, inputs, outputs, attrs, lods) in cases.items():
        block = PF.Program.from_desc(_desc(op_type, inputs, outputs,
                                           attrs)).global_block()
        env = {n: torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                              device=meta)
               for d in inputs.values() for n, a in d.items()}
        env.update((PL.lod_name(n), torch.empty(v.shape, dtype=torch.int32,
                                                device=meta))
                   for n, v in lods.items())
        env.update((PL.bound_name(n), int(v.max())) for n, v in lods.items())
        PR.lower_op(PR.LowerCtx(block, env, None, meta), block.ops[0])
        for names in outputs.values():
            assert all(env[n].device.type == "meta" for n in names), case


# -- the layers ---------------------------------------------------------------

def _layers_program(fluid):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = L.data("w", [1], dtype="int64", lod_level=1)
        emb = L.embedding(words, size=[20, 6])
        h0 = L.data("h0", [4])
        gru = L.dynamic_gru(L.fc(emb, size=12), size=4, h_0=h0,
                            is_reverse=True, origin_mode=True)
        emission = L.fc(gru, size=3)
        tags = L.data("tags", [1], dtype="int64", lod_level=1)
        ll = L.linear_chain_crf(emission, tags,
                                param_attr=fluid.ParamAttr(name="crf"))
        path = L.crf_decoding(emission, fluid.ParamAttr(name="crf"))
        ctc = L.warpctc(L.fc(gru, size=5), tags, blank=0)
        greedy = L.ctc_greedy_decoder(L.fc(gru, size=5), blank=0)
        dist, num = L.edit_distance(greedy, tags, ignored_tokens=[1])
        seq = L.data("seq", [6, 3], append_batch_size=False)
        ih = L.data("ih", [2, 3, 4], append_batch_size=False)
        ic = L.data("ic", [2, 3, 4], append_batch_size=False)
        out, lh, lc = L.lstm(seq, ih, ic, 6, 4, 2, dropout_prob=0.2)
        x = L.data("x", [5])
        lab = L.data("lab", [1], dtype="int64")
        nce = L.nce(x, lab, num_total_classes=9, num_neg_samples=3)
        hs = L.hsigmoid(x, lab, num_classes=7)
        ss = L.sampled_softmax_with_cross_entropy(L.fc(x, size=9), lab, 4)
        cs = L.cos_sim(x, L.fc(x, size=5))
        se = L.square_error_cost(cs, L.data("y", [1]))
        reds = [getattr(L, "reduce_" + t)(x, dim=d, keep_dim=k)
                for t in ("mean", "max", "min", "prod")
                for d, k in ((None, False), (1, True), ([0, 1], False))]
        reset = L.lod_reset(emb, y=tags)
        appended = L.lod_append(L.lod_reset(x, target_lod=[0, 2, 5]),
                                [0, 1, 2])
    return main, [ll, path, ctc, dist, num, out, lh, lc, nce, hs, ss, se,
                  reset, appended] + reds


def test_layers_build_the_reference_desc():
    jm, _ = _layers_program(jfluid)
    pm, _ = _layers_program(pfluid)
    assert pm.to_desc() == jm.to_desc()


def test_refusals_in_the_reference_words():
    L = pfluid.layers
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.unique_name.guard(), pfluid.program_guard(main, startup):
        x = L.data("x", [5])
        lab = L.data("lab", [1], dtype="int64")
        with pytest.raises(NotImplementedError, match="bidirectional"):
            L.lstm(L.data("s", [4, 2, 5], append_batch_size=False), None,
                   None, 4, 4, 1, is_bidirec=True)
        with pytest.raises(NotImplementedError, match="uniform"):
            L.nce(x, lab, 9, sampler="log_uniform")
        with pytest.raises(NotImplementedError, match="custom trees"):
            L.hsigmoid(x, lab, 7, is_custom=True)
        with pytest.raises(NotImplementedError, match="customized"):
            L.sampled_softmax_with_cross_entropy(
                x, lab, 3, use_customized_samples=True)
