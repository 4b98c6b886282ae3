"""The port's GRU seq2seq (paddle_tpu_torch/models/seq2seq.py: layers.rnn
over GRUCell, BeamSearchDecoder and dynamic_decode) held to the JAX
package on the CPU, at the reference's small defaults (vocabularies 32,
embedding 16, hidden 32, length 6, beam 4).

- Programs: the training, monolithic decode, encoder and split decode
  programs, built by both packages inside ``unique_name.guard()``, have
  the same desc and the same ProgramDesc bytes.
- Training: 10 Adam steps from the reference's startup state (copied
  with ``copy_scope``), a fresh ``synthetic_pairs`` batch each step,
  losses at rtol 1e-4 (the parity protocol), and they fall.
- Beam decode, from the startup state and from the trained one: the
  sequences equal the reference's exactly and the last step's beam
  scores agree at rtol 1e-5; the split route (encoder once, then the
  decode fed its state on the device, ``run_split_infer``) equals the
  monolithic one; the decode program exported by
  ``save_inference_model`` and served by the port's ``Predictor`` gives
  the same sequences.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import seq2seq as JS
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch import inference as PI
from paddle_tpu_torch.models import seq2seq as PS

STEPS, BATCH, DECODE_BATCH = 10, 8, 6
BUILDERS = ("build_train_program", "build_infer_program",
            "build_encoder_program", "build_decode_program")


def _build(fluid, M, builder):
    with fluid.unique_name.guard():
        return getattr(M, builder)()


@pytest.mark.parametrize("builder", BUILDERS)
def test_programs_match_reference(builder):
    ref = _build(jfluid, JS, builder)
    port = _build(pfluid, PS, builder)
    for want, got in zip(ref[:2], port[:2]):
        assert got.to_desc() == want.to_desc()
        assert got.serialize_to_string() == want.serialize_to_string()


def _persistables(*programs):
    return sorted({v.name for p in programs for v in p.list_vars()
                   if v.persistable})


@pytest.fixture(scope="module")
def trained():
    """Both packages' scopes at the reference's startup state, then after
    STEPS steps; the losses."""
    jm, js, jl = _build(jfluid, JS, "build_train_program")
    pm, _, pl = _build(pfluid, PS, "build_train_program")
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(js, scope=jscope)
    names = _persistables(jm)
    start = {n: np.array(jscope.find_var(n)) for n in names}
    pscope, pexe = pfluid.Scope(), pfluid.Executor("cpu")
    pfluid.copy_scope(jscope, pscope, names, device="cpu")
    rng = np.random.RandomState(0)
    want, got = [], []
    for _ in range(STEPS):
        feed = JS.synthetic_pairs(rng, BATCH)
        want.append(float(np.asarray(jexe.run(jm, feed=feed, fetch_list=[jl],
                                              scope=jscope)[0])))
        got.append(float(np.asarray(pexe.run(pm, feed=feed, fetch_list=[pl],
                                              scope=pscope)[0])))
    return dict(start=start, jscope=jscope, pscope=pscope, want=want,
                got=got)


def test_training_trajectory_matches_reference(trained):
    np.testing.assert_allclose(trained["got"], trained["want"], rtol=1e-4)
    assert trained["got"][-1] < trained["got"][0]


def _last_scores(main):
    """The last beam_search op's selected_scores var."""
    op = [op for op in main.global_block().ops if op.type == "beam_search"][-1]
    return op.output("selected_scores")[0]


def _scopes(trained, which):
    if which == "trained":
        return trained["jscope"], trained["pscope"]
    jscope, pscope = jfluid.Scope(), pfluid.Scope()
    for n, a in trained["start"].items():
        jscope.set_var(n, a)
        pscope.set_var(n, torch.from_numpy(a.copy()))
    return jscope, pscope


def _src(seed=5):
    return JS.synthetic_pairs(np.random.RandomState(seed),
                              DECODE_BATCH)["s2s_src"]


@pytest.mark.parametrize("which", ["startup", "trained"])
def test_beam_decode_matches_reference(trained, which):
    jscope, pscope = _scopes(trained, which)
    jm, _, jseq = _build(jfluid, JS, "build_infer_program")
    pm, _, pseq = _build(pfluid, PS, "build_infer_program")
    feed = {"s2s_src": _src()}
    want = jfluid.Executor().run(jm, feed=feed,
                                 fetch_list=[jseq, _last_scores(jm)],
                                 scope=jscope)
    got = pfluid.Executor("cpu").run(pm, feed=feed,
                                     fetch_list=[pseq, _last_scores(pm)],
                                     scope=pscope)
    assert got[0].shape == (6, DECODE_BATCH * 4)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-5)
    if which == "startup":     # an untrained model: varied tokens
        assert len(np.unique(got[0])) > 4


def test_split_route_and_predictor_match_monolithic(trained, tmp_path):
    _, pscope = _scopes(trained, "startup")
    exe = pfluid.Executor("cpu")
    mono, _, seq = _build(pfluid, PS, "build_infer_program")
    enc, _, enc_state = _build(pfluid, PS, "build_encoder_program")
    dec, _, dec_seq = _build(pfluid, PS, "build_decode_program")
    src = _src(7)
    want = exe.run(mono, feed={"s2s_src": src}, fetch_list=[seq],
                   scope=pscope)[0]
    got = PS.run_split_infer(exe, pscope, enc, enc_state, dec, dec_seq, src)
    np.testing.assert_array_equal(got, want)
    # the reference's split route on the same state
    jscope, _ = _scopes(trained, "startup")
    jenc, _, jstate = _build(jfluid, JS, "build_encoder_program")
    jdec, _, jseq = _build(jfluid, JS, "build_decode_program")
    ref = JS.run_split_infer(jfluid.Executor(), jscope, jenc, jstate, jdec,
                             jseq, src)
    np.testing.assert_array_equal(got, np.asarray(ref))
    # the decode program exported and served
    state = exe.run(enc, feed={"s2s_src": src}, fetch_list=[enc_state],
                    scope=pscope)[0]
    with pfluid.scope_guard(pscope):
        pfluid.io.save_inference_model(str(tmp_path), ["s2s_enc_state"],
                                       [dec_seq], exe, main_program=dec)
    pred = PI.create_predictor(PI.Config(str(tmp_path), place="cpu"))
    np.testing.assert_array_equal(pred.run({"s2s_enc_state": state})[0],
                                  want)
