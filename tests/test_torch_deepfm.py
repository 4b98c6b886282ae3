"""The port's sparse embedding engine (device tier) and DeepFM, BASELINE
config 4 (paddle_tpu_torch/embedding, fluid/ops/embedding_ops.py, the
SelectedRows gradients of fluid/backward.py and fluid/ops/autodiff.py,
the row-sparse updates of fluid/ops/optimizer_ops.py,
models/deepfm.py), held to the JAX package on the CPU.

Every check feeds the same numpy inputs through both packages; the port
starts from the reference's startup state (``fluid.copy_scope``).
Tolerances:
- descs: equal (dicts and protobuf bytes), built in ``unique_name.guard``;
- the lookup with ``dedup`` on and off: equal to a plain gather and to
  the reference's dedup gather to the bit (rows are copied);
- SelectedRows gradients: rows equal, values within 1e-6;
- the fused updates after 2 steps: parameters and slots within 1e-6;
  untouched rows (and their slots) equal to the bit;
- 10-step DeepFM losses: rtol 1e-4 (the parity protocol's trajectory
  tolerance); the port's sparse against its dense run: rtol 2e-3, as the
  reference's own tests/test_sparse.py holds its two;
- AMP (bf16, dynamic loss scaling): rtol 4e-3;
- the served ``pred``: within 1e-5.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import inference as JI
from paddle_tpu.fluid.contrib import mixed_precision as JMP
from paddle_tpu.models import deepfm as JD
import paddle_tpu_torch.fluid as pfluid
from paddle_tpu_torch import embedding as PE
from paddle_tpu_torch import inference as PI
from paddle_tpu_torch.fluid.contrib import mixed_precision as PMP
from paddle_tpu_torch.models import deepfm as PD

ATOL = 1e-6
TRAJ_RTOL = 1e-4
SPARSE_DENSE_RTOL = 2e-3
AMP_RTOL = 4e-3
SERVE_ATOL = 1e-5
BATCH = 32


def _reference_state(main, startup):
    scope, exe = jfluid.Scope(), jfluid.Executor()
    exe.run(startup, scope=scope)
    return scope, exe, [v.name for v in main.list_vars() if v.persistable]


def _port_scope(jscope, names):
    scope = pfluid.Scope()
    pfluid.copy_scope(jscope, scope, names, device="cpu")
    return scope


def _loss(out):
    return float(np.asarray(out[0]).reshape(-1)[0])


def _deepfm(fluid, M, **kw):
    with fluid.unique_name.guard():
        return M.build_train_program(M.DeepFMConfig.tiny(), **kw)


def _batches(n, batch=BATCH, seed=0):
    cfg = JD.DeepFMConfig.tiny()
    return [JD.synthetic_batch(cfg, batch, seed=seed + i) for i in range(n)]


# -- programs ------------------------------------------------------------------

@pytest.mark.parametrize("is_sparse", [True, False], ids=["sparse", "dense"])
def test_deepfm_desc_matches_reference(is_sparse):
    ref = _deepfm(jfluid, JD, is_sparse=is_sparse)
    port = _deepfm(pfluid, PD, is_sparse=is_sparse)
    for want, got in zip(ref[:2], port[:2]):
        assert got.to_desc() == want.to_desc()
        assert got.serialize_to_string() == want.serialize_to_string()
    block = port[0].global_block()
    lookups = [op.type for op in block.ops if "lookup" in op.type]
    assert lookups == (["embedding_lookup"] * 2 if is_sparse
                       else ["lookup_table"] * 2)
    ad = next(op for op in block.ops if op.type == "autodiff")
    if is_sparse:
        assert ad.attr("sparse_wrt") == [
            ["fm_w1", "sparse_ids", block.ops[0].output("Out")[0]],
            ["fm_emb", "sparse_ids", block.ops[2].output("Out")[0]]]
        for p, dim in (("fm_w1", 1), ("fm_emb", 8)):
            g = block.var(p + "@GRAD")
            assert (g.type, g.shape) == ("selected_rows", (-1, dim))
            assert block.var(p + "@GRAD@ROWS").dtype == np.dtype("int32")
    else:
        assert not ad.attr("sparse_wrt")


def test_program_from_desc_reads_selected_rows_back(reference_runs):
    """The desc records no var type (as the reference's): a program read
    back from it marks a var beside a ``<name>@ROWS`` var
    ``selected_rows`` again, and trains as the program it came from, to
    the bit."""
    from paddle_tpu_torch.fluid.framework import Program

    pm, _, pl, _ = _deepfm(pfluid, PD)
    back = Program.from_desc(pm.to_desc())
    kinds = {n: v.type for n, v in back.global_block().vars.items()
             if v.type != "lod_tensor"}
    assert kinds == {"fm_w1@GRAD": "selected_rows",
                     "fm_emb@GRAD": "selected_rows"}
    state = reference_runs[True][0]
    feeds = _batches(2, seed=40)
    got = []
    for prog in (pm, back):
        scope = pfluid.Scope()
        for n, a in state.items():
            scope.set_var(n, torch.from_numpy(np.array(a)))
        exe = pfluid.Executor("cpu")
        got.append([_loss(exe.run(prog, feed=f, fetch_list=[pl.name],
                                  scope=scope)) for f in feeds]
                   + [scope.find_var("fm_emb").numpy()])
    assert got[0][:2] == got[1][:2]
    np.testing.assert_array_equal(got[0][2], got[1][2])


def test_deepfm_config_and_batch_match_reference():
    for M in (JD, PD):
        with pytest.raises(ValueError, match="num_fields"):
            M.DeepFMConfig(num_fields=0)
        with pytest.raises(ValueError, match="embedding_size"):
            M.DeepFMConfig(embedding_size=2.5)
    want, got = JD.DeepFMConfig(), PD.DeepFMConfig()
    assert vars(got) == vars(want)
    assert vars(PD.DeepFMConfig.tiny()) == vars(JD.DeepFMConfig.tiny())
    for k, v in JD.synthetic_batch(JD.DeepFMConfig.tiny(), 8, seed=3).items():
        np.testing.assert_array_equal(
            PD.synthetic_batch(PD.DeepFMConfig.tiny(), 8, seed=3)[k], v)


@pytest.mark.parametrize("op_type", ["lookup_table", "lookup_table_v2"])
def test_sparse_lookup_table_matches_reference(op_type):
    """A hand-built ``lookup_table`` (or ``_v2``) op with ``is_sparse``
    takes the sparse route without dedup: the same desc as the
    reference's, a SelectedRows gradient, and the same SGD step."""
    progs = {}
    for name, fluid in (("ref", jfluid), ("port", pfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ids = fluid.layers.data("ids", shape=[3, 1], dtype="int64")
            w = fluid.layers.create_parameter([12, 4], "float32", name="w")
            out = main.global_block().create_var(name="looked", shape=(-1, 3, 4),
                                                 dtype="float32")
            main.global_block().append_op(
                op_type, inputs={"W": [w], "Ids": [ids]},
                outputs={"Out": [out]},
                attrs={"is_sparse": True, "padding_idx": 5})
            h = fluid.layers.fc(fluid.layers.reshape(out, [0, 12]), 2)
            loss = fluid.layers.mean(fluid.layers.elementwise_mul(h, h))
            fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        progs[name] = (main, startup, loss)
    (jm, js, jl), (pm, _, pl) = progs["ref"], progs["port"]
    assert pm.to_desc() == jm.to_desc()
    assert pm.global_block().var("w@GRAD").type == "selected_rows"
    feed = {"ids": np.array([[[3], [5], [3]], [[11], [0], [3]]], np.int64)}
    jscope, jexe, names = _reference_state(jm, js)
    pscope, pexe = _port_scope(jscope, names), pfluid.Executor("cpu")
    fetch = [jl.name, "w@GRAD", "w@GRAD@ROWS"]
    for _ in range(2):
        want = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
        got = pexe.run(pm, feed=feed, fetch_list=fetch, scope=pscope)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got[1], want[1], atol=ATOL)
        np.testing.assert_array_equal(got[2], want[2])
        assert got[2].dtype == np.int32 and got[1].shape == (6, 4)
    for n in names:
        np.testing.assert_allclose(pscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   atol=ATOL, err_msg=n)


# -- the lookup and its gradient -------------------------------------------------

def _lookup_program(fluid, vocab=20, dim=3, padding_idx=None, is_sparse=True,
                    dedup=True):
    """ids [B, 4] -> embedding -> fc(2) -> mean of squares, SGD lr 0:
    a cotangent that differs at every lookup position."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[4], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[vocab, dim],
                                     is_sparse=is_sparse,
                                     padding_idx=padding_idx,
                                     param_attr=fluid.ParamAttr(name="w"))
        if not dedup:
            main.global_block().ops[-1].attrs["dedup"] = False
        h = fluid.layers.fc(fluid.layers.reshape(emb, [0, 4 * dim]), 2)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(h, h))
        fluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
    return main, startup, loss, emb


IDS = np.array([[1, 2, 2, 7], [7, 1, 1, 0], [19, 3, 2, 2]], np.int64)


@pytest.mark.parametrize("padding_idx", [None, 2], ids=["nopad", "pad2"])
def test_dedup_gather_is_a_plain_gather(padding_idx):
    """The lookup's output with ``dedup`` on and off equals a plain
    gather of the same ids and the reference's output (its dedup gather
    with ``dedup`` on), to the bit."""
    outs = {}
    for dedup in (True, False):
        main, startup, _, emb = _lookup_program(pfluid, padding_idx=padding_idx,
                                                dedup=dedup)
        jm, js, _, jemb = _lookup_program(jfluid, padding_idx=padding_idx,
                                          dedup=dedup)
        jscope, jexe, names = _reference_state(jm, js)
        pscope = _port_scope(jscope, names)
        want = np.asarray(jexe.run(jm, feed={"ids": IDS}, fetch_list=[jemb],
                                   scope=jscope)[0])
        got = pfluid.Executor("cpu").run(
            main, feed={"ids": IDS}, fetch_list=[emb], scope=pscope)[0]
        np.testing.assert_array_equal(got, want)
        w = np.asarray(jscope.find_var("w"))
        plain = w[IDS]
        if padding_idx is not None:
            plain[IDS == padding_idx] = 0.0
        np.testing.assert_array_equal(got, plain)
        outs[dedup] = got
    np.testing.assert_array_equal(outs[True], outs[False])


@pytest.mark.parametrize("padding_idx", [None, 2], ids=["nopad", "pad2"])
def test_sparse_gradient_matches_reference(padding_idx):
    """``w@GRAD`` (values [n, dim], one row a lookup position) and
    ``w@GRAD@ROWS`` (the flat ids, int32, duplicates kept) as the
    reference binds them; padded positions get zero values."""
    jm, js, jl, _ = _lookup_program(jfluid, padding_idx=padding_idx)
    pm, _, pl, _ = _lookup_program(pfluid, padding_idx=padding_idx)
    jscope, jexe, names = _reference_state(jm, js)
    pscope = _port_scope(jscope, names)
    fetch = ["w@GRAD", "w@GRAD@ROWS"]
    want = jexe.run(jm, feed={"ids": IDS}, fetch_list=fetch, scope=jscope)
    got = pfluid.Executor("cpu").run(pm, feed={"ids": IDS}, fetch_list=fetch,
                                     scope=pscope)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[1].dtype == np.int32
    assert got[1].tolist() == IDS.reshape(-1).tolist()
    assert got[0].shape == (IDS.size, 3)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=ATOL)
    if padding_idx is not None:
        assert not got[0][IDS.reshape(-1) == padding_idx].any()


def test_shared_table_takes_a_dense_gradient():
    """A table a sparse lookup reads and another op reads too (a tied
    output projection) gets a dense gradient, as in the reference's
    backward: no ``sparse_wrt``, ``w@GRAD`` [vocab, dim] within 1e-6 of
    the reference's, which passes through both of its dedup gather's
    gathers."""
    progs = {}
    for name, fluid in (("ref", jfluid), ("port", pfluid)):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 6
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ids = fluid.layers.data("ids", shape=[4], dtype="int64")
            emb = fluid.layers.embedding(
                ids, size=[20, 3], is_sparse=True,
                param_attr=fluid.ParamAttr(name="w"))
            h = fluid.layers.reduce_sum(emb, dim=1)
            w = main.global_block().var("w")
            logits = fluid.layers.matmul(h, w, transpose_y=True)
            loss = fluid.layers.mean(
                fluid.layers.elementwise_mul(logits, logits))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        progs[name] = (main, startup)
    (jm, js), (pm, _) = progs["ref"], progs["port"]
    assert pm.to_desc() == jm.to_desc()
    ad = next(op for op in pm.global_block().ops if op.type == "autodiff")
    assert not ad.attr("sparse_wrt")
    jscope, jexe, names = _reference_state(jm, js)
    pscope = _port_scope(jscope, names)
    want = jexe.run(jm, feed={"ids": IDS}, fetch_list=["w@GRAD"],
                    scope=jscope)[0]
    got = pfluid.Executor("cpu").run(pm, feed={"ids": IDS},
                                     fetch_list=["w@GRAD"], scope=pscope)[0]
    assert got.shape == (20, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


# -- the fused row-sparse updates ----------------------------------------------

def _optimizer(fluid, kind):
    opt = fluid.optimizer
    return {"sgd": lambda: opt.SGD(learning_rate=0.3),
            "momentum": lambda: opt.Momentum(learning_rate=0.2,
                                             momentum=0.9),
            "nesterov": lambda: opt.Momentum(learning_rate=0.2, momentum=0.9,
                                             use_nesterov=True),
            "adagrad": lambda: opt.Adagrad(learning_rate=0.2,
                                           initial_accumulator_value=0.1),
            "adam": lambda: opt.Adam(learning_rate=0.1, lazy_mode=True)}[kind]()


def _update_program(fluid, kind, is_sparse=True, vocab=30, dim=3):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 2
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[4], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[vocab, dim],
                                     is_sparse=is_sparse,
                                     param_attr=fluid.ParamAttr(name="w"))
        h = fluid.layers.fc(fluid.layers.reshape(emb, [0, 4 * dim]), 2)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(h, h))
        _optimizer(fluid, kind).minimize(loss)
    return main, startup, loss


OPTIMIZERS = ["sgd", "momentum", "nesterov", "adagrad", "adam"]


@pytest.mark.parametrize("kind", OPTIMIZERS)
def test_fused_sparse_update_matches_reference(kind):
    """Two steps on a batch with repeated ids: every parameter and slot
    within 1e-6 of the reference's; the rows the batch does not touch,
    and their slots, equal to the bit; the touched rows moved."""
    jm, js, jl = _update_program(jfluid, kind)
    pm, _, pl = _update_program(pfluid, kind)
    assert pm.to_desc() == jm.to_desc()
    jscope, jexe, names = _reference_state(jm, js)
    pscope, pexe = _port_scope(jscope, names), pfluid.Executor("cpu")
    before = {n: np.array(jscope.find_var(n)) for n in names}
    for _ in range(2):
        jexe.run(jm, feed={"ids": IDS}, fetch_list=[jl], scope=jscope)
        pexe.run(pm, feed={"ids": IDS}, fetch_list=[pl], scope=pscope)
    touched = sorted(set(IDS.reshape(-1).tolist()))
    untouched = [i for i in range(30) if i not in touched]
    rows = [n for n in names if before[n].shape[:1] == (30,)]
    assert len(rows) == {"sgd": 1, "adam": 3}.get(kind, 2)
    for n in names:
        got = pscope.find_var(n).numpy()
        np.testing.assert_allclose(got, np.asarray(jscope.find_var(n)),
                                   atol=ATOL, err_msg=n)
        if n in rows:
            np.testing.assert_array_equal(got[untouched],
                                          before[n][untouched], err_msg=n)
    assert (pscope.find_var("w").numpy()[touched] != before["w"][touched]
            ).any(axis=1).all()


def test_sparse_sgd_accumulates_duplicates():
    """SGD's sparse update equals its dense one (duplicate rows
    accumulate, as in the reference's test_sparse_matches_dense_sgd)."""
    ws = {}
    for sparse in (True, False):
        jm, js, _ = _update_program(jfluid, "sgd", is_sparse=sparse)
        pm, _, pl = _update_program(pfluid, "sgd", is_sparse=sparse)
        jscope, _, names = _reference_state(jm, js)
        pscope, pexe = _port_scope(jscope, names), pfluid.Executor("cpu")
        for _ in range(2):
            pexe.run(pm, feed={"ids": IDS}, fetch_list=[pl], scope=pscope)
        ws[sparse] = pscope.find_var("w").numpy()
    np.testing.assert_allclose(ws[True], ws[False], atol=ATOL)


@pytest.mark.parametrize("is_sparse", [True, False], ids=["sparse", "dense"])
def test_out_of_range_id_matches_reference(is_sparse):
    """Adam, vocab 10, an id of 12 (and -11, below -vocab): the lookup
    reads NaN rows there, as the reference's ``jnp.take`` does; that
    position's update is dropped, the other rows train, and every
    parameter stays finite and within 1e-6 of the reference's. No host
    check and no device assert: the CPU raises no IndexError."""
    progs = {}
    for name, fluid in (("ref", jfluid), ("port", pfluid)):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 4
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ids = fluid.layers.data("ids", shape=[3], dtype="int64")
            emb = fluid.layers.embedding(
                ids, size=[10, 2], is_sparse=is_sparse,
                param_attr=fluid.ParamAttr(name="w_oor"))
            loss = fluid.layers.mean(fluid.layers.reduce_sum(emb, dim=-1))
            fluid.optimizer.Adam(learning_rate=0.1).minimize(loss)
        progs[name] = (main, startup, loss, emb)
    (jm, js, jl, jemb), (pm, _, pl, pemb) = progs["ref"], progs["port"]
    feed = {"ids": np.array([[1, 12, 2], [-11, 1, -1]], np.int64)}
    jscope, jexe, names = _reference_state(jm, js)
    pscope, pexe = _port_scope(jscope, names), pfluid.Executor("cpu")
    w0 = np.array(jscope.find_var("w_oor"))
    want = jexe.run(jm, feed=feed, fetch_list=[jemb], scope=jscope)[0]
    got = pexe.run(pm, feed=feed, fetch_list=[pemb], scope=pscope)[0]
    nan = np.isnan(np.asarray(want))
    assert nan[0, 1].all() and nan[1, 0].all() and nan.sum() == 4
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan], np.asarray(want)[~nan])
    np.testing.assert_array_equal(got[1, 2], w0[9])   # -1 counts from the end
    for n in names:
        g = pscope.find_var(n).numpy()
        assert np.isfinite(g).all(), n
        np.testing.assert_allclose(g, np.asarray(jscope.find_var(n)),
                                   atol=ATOL, err_msg=n)
    w1 = pscope.find_var("w_oor").numpy()
    moved = (w1 != w0).any(axis=1)
    assert moved[[1, 2, 9]].all()
    assert not moved[[0, 3, 4, 5, 6, 7, 8]].any()


@pytest.mark.parametrize("kind", OPTIMIZERS)
def test_row_named_from_both_ends_matches_reference(kind):
    """A batch that names row 9 of 10 both as 9 and as -1: the reference
    makes the raw ids unique, so the row takes two updates, each from
    the row as it was, with its own lane's gradient. Every parameter and
    slot within 1e-6 of the reference's after 2 steps; rows 0, 4 and 5,
    which no id names, equal to the bit."""
    progs = {}
    for name, fluid in (("ref", jfluid), ("port", pfluid)):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 7
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ids = fluid.layers.data("ids", shape=[3], dtype="int64")
            emb = fluid.layers.embedding(
                ids, size=[10, 2], is_sparse=True,
                param_attr=fluid.ParamAttr(name="w_ends"))
            h = fluid.layers.fc(fluid.layers.reshape(emb, [0, 6]), 2)
            loss = fluid.layers.mean(fluid.layers.elementwise_mul(h, h))
            _optimizer(fluid, kind).minimize(loss)
        progs[name] = (main, startup, loss)
    (jm, js, jl), (pm, _, pl) = progs["ref"], progs["port"]
    feed = {"ids": np.array([[9, -1, 2], [-1, 3, 9], [1, 6, 7],
                             [8, -2, 3]], np.int64)}
    jscope, jexe, names = _reference_state(jm, js)
    pscope, pexe = _port_scope(jscope, names), pfluid.Executor("cpu")
    before = {n: np.array(jscope.find_var(n)) for n in names}
    for _ in range(2):
        jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)
        pexe.run(pm, feed=feed, fetch_list=[pl], scope=pscope)
    for n in names:
        got = pscope.find_var(n).numpy()
        np.testing.assert_allclose(got, np.asarray(jscope.find_var(n)),
                                   atol=ATOL, err_msg=n)
        if before[n].shape[:1] == (10,):
            np.testing.assert_array_equal(got[[0, 4, 5]],
                                          before[n][[0, 4, 5]], err_msg=n)
    assert (pscope.find_var("w_ends").numpy()[9] != before["w_ends"][9]).all()


# -- DeepFM trajectories ---------------------------------------------------------

@pytest.fixture(scope="module")
def reference_runs():
    """The reference's 10-step losses on fresh batches, sparse and dense,
    and its startup state."""
    runs = {}
    for sparse in (True, False):
        jm, js, jl, _ = _deepfm(jfluid, JD, is_sparse=sparse)
        jscope, jexe, names = _reference_state(jm, js)
        state = {n: np.array(jscope.find_var(n)) for n in names}
        losses = [_loss(jexe.run(jm, feed=f, fetch_list=[jl], scope=jscope))
                  for f in _batches(10)]
        runs[sparse] = (state, losses, {n: np.array(jscope.find_var(n))
                                        for n in names})
    return runs


def _port_run(is_sparse, state, feeds, iters=1):
    pm, _, pl, _ = _deepfm(pfluid, PD, is_sparse=is_sparse)
    scope = pfluid.Scope()
    for n, a in state.items():
        scope.set_var(n, torch.from_numpy(np.array(a)))
    exe = pfluid.Executor("cpu")
    if iters == 1:
        losses = [_loss(exe.run(pm, feed=f, fetch_list=[pl], scope=scope))
                  for f in feeds]
    else:
        stacked = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
        losses = np.asarray(exe.run(pm, feed=stacked, fetch_list=[pl],
                                    scope=scope, iters=iters)[0]
                            ).reshape(-1).tolist()
    return losses, scope


@pytest.mark.parametrize("is_sparse", [True, False], ids=["sparse", "dense"])
def test_deepfm_trajectory_matches_reference(reference_runs, is_sparse):
    state, want, final = reference_runs[is_sparse]
    got, scope = _port_run(is_sparse, state, _batches(10))
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    for n, a in final.items():
        np.testing.assert_allclose(scope.find_var(n).numpy(), a, rtol=1e-3,
                                   atol=1e-5, err_msg=n)


def test_deepfm_sparse_matches_dense(reference_runs):
    """The port's sparse and dense runs from one state on one batch, 5
    steps, within 2e-3; the loss falls (the reference's
    test_deepfm_sparse_matches_dense)."""
    state = reference_runs[True][0]
    feeds = _batches(1) * 5
    sparse = _port_run(True, state, feeds)[0]
    dense = _port_run(False, state, feeds)[0]
    assert sparse[-1] < sparse[0]
    np.testing.assert_allclose(dense, sparse, rtol=SPARSE_DENSE_RTOL)


def test_iters_k_equals_single_steps(reference_runs):
    """``iters=4`` over stacked batches equals 4 single steps: the losses
    and every persistable, to the bit."""
    state = reference_runs[True][0]
    feeds = _batches(4, seed=20)
    single, s1 = _port_run(True, state, feeds)
    window, s2 = _port_run(True, state, feeds, iters=4)
    assert window == single
    for n in state:
        assert torch.equal(s1.find_var(n), s2.find_var(n)), n


def test_deepfm_amp_matches_reference():
    """bf16 AMP with dynamic loss scaling (init 1024): the SelectedRows
    gradients are unscaled and gated with their rows kept; the same desc
    as the reference's, 5 steps' losses within 4e-3, the rows no batch
    touched equal to the bit and every parameter finite."""
    progs = {}
    for name, fluid, M, mp in (("ref", jfluid, JD, JMP),
                               ("port", pfluid, PD, PMP)):
        cfg = M.DeepFMConfig.tiny()
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 7
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ids = fluid.layers.data("sparse_ids", shape=[cfg.num_fields],
                                    dtype="int64")
            dense = fluid.layers.data("dense_x", shape=[cfg.num_dense],
                                      dtype="float32")
            label = fluid.layers.data("label", shape=[1], dtype="int64")
            _, loss = M.deepfm_forward(ids, dense, label, cfg)
            mp.decorate(fluid.optimizer.Adam(learning_rate=1e-2),
                        init_loss_scaling=1024.0,
                        use_dynamic_loss_scaling=True).minimize(loss)
        progs[name] = (main, startup, loss)
    (jm, js, jl), (pm, _, pl) = progs["ref"], progs["port"]
    assert pm.to_desc() == jm.to_desc()
    block = pm.global_block()
    for p in ("fm_w1", "fm_emb"):
        for suffix in (".unscaled", ".gated"):
            assert block.var(p + "@GRAD" + suffix).type == "selected_rows"
            assert block.has_var(p + "@GRAD" + suffix + "@ROWS")
    jscope, jexe, names = _reference_state(jm, js)
    pscope, pexe = _port_scope(jscope, names), pfluid.Executor("cpu")
    feeds = _batches(5, seed=30)
    want = [_loss(jexe.run(jm, feed=f, fetch_list=[jl], scope=jscope))
            for f in feeds]
    got = [_loss(pexe.run(pm, feed=f, fetch_list=[pl], scope=pscope))
           for f in feeds]
    np.testing.assert_allclose(got, want, rtol=AMP_RTOL)
    touched = np.unique(np.concatenate([f["sparse_ids"].reshape(-1)
                                        for f in feeds]))
    untouched = np.setdiff1d(np.arange(1000), touched)
    for n in names:
        assert np.isfinite(pscope.find_var(n).float().numpy()).all(), n
    for n in ("fm_w1", "fm_emb"):
        np.testing.assert_array_equal(
            pscope.find_var(n).numpy()[untouched],
            np.asarray(jscope.find_var(n))[untouched], err_msg=n)


def test_regularizer_skips_sparse_gradient():
    """L2Decay leaves a SelectedRows gradient alone with the reference's
    warning (decaying the untouched rows would densify it) and still
    decays the dense ones: the same desc as the reference's."""
    descs = []
    for fluid, M in ((jfluid, JD), (pfluid, PD)):
        cfg = M.DeepFMConfig.tiny()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ids = fluid.layers.data("sparse_ids", shape=[cfg.num_fields],
                                    dtype="int64")
            dense = fluid.layers.data("dense_x", shape=[cfg.num_dense],
                                      dtype="float32")
            label = fluid.layers.data("label", shape=[1], dtype="int64")
            _, loss = M.deepfm_forward(ids, dense, label, cfg)
            opt = fluid.optimizer.Momentum(
                learning_rate=0.1, momentum=0.9,
                regularization=fluid.regularizer.L2Decay(1e-4))
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                opt.minimize(loss)
        skipped = sorted(str(w.message) for w in caught
                         if "regularization skipped" in str(w.message))
        assert skipped == ["regularization skipped for sparse gradient of "
                           "'fm_emb'", "regularization skipped for sparse "
                           "gradient of 'fm_w1'"]
        descs.append(main.to_desc())
    assert descs[1] == descs[0]
    momentum = [o for o in descs[1]["blocks"][0]["ops"]
                if o["type"] == "momentum"]
    assert {o["inputs"]["Grad"][0] for o in momentum} >= {"fm_w1@GRAD",
                                                         "fm_emb@GRAD"}


def test_merge_and_densify_selected_rows_match_reference():
    """``merge_selected_rows`` (the first occurrence of an id carries its
    rows' sum, later duplicates zeros, the rows unchanged) and
    ``get_tensor_from_selected_rows`` (the dense [height, dim] gradient)
    as the reference computes them, through their layers."""
    outs = []
    for fluid in (jfluid, pfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ids = fluid.layers.data("ids", shape=[4], dtype="int64")
            emb = fluid.layers.embedding(
                ids, size=[20, 3], is_sparse=True,
                param_attr=fluid.ParamAttr(name="w_m"))
            h = fluid.layers.fc(fluid.layers.reshape(emb, [0, 12]), 2)
            loss = fluid.layers.mean(fluid.layers.elementwise_mul(h, h))
            fluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
            g = main.global_block().var("w_m@GRAD")
            merged = fluid.layers.merge_selected_rows(g)
            dense = fluid.layers.get_tensor_from_selected_rows(merged,
                                                               height=20)
        outs.append((main, startup, [merged.name, merged.name + "@ROWS",
                                     dense.name]))
    (jm, js, fetch), (pm, _, pfetch) = outs
    assert pm.to_desc() == jm.to_desc() and pfetch == fetch
    assert pm.global_block().var(fetch[0]).type == "selected_rows"
    jscope, jexe, names = _reference_state(jm, js)
    pscope = _port_scope(jscope, names)
    want = jexe.run(jm, feed={"ids": IDS}, fetch_list=fetch, scope=jscope)
    got = pfluid.Executor("cpu").run(pm, feed={"ids": IDS}, fetch_list=fetch,
                                     scope=pscope)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)
    flat = IDS.reshape(-1)
    later = [i for i in range(flat.size) if flat[i] in flat[:i]]
    assert later and not got[0][later].any()


# -- serving ---------------------------------------------------------------------

def test_predictor_serves_reference_deepfm_model(tmp_path):
    """The reference's trained DeepFM ``pred`` saved with
    ``save_inference_model`` (fed ``sparse_ids`` and ``dense_x``) and
    served by the port's Predictor within 1e-5 of the reference's
    Predictor; the port saves the same ``__model__`` bytes; the pruned
    program keeps ``embedding_lookup`` forward-only and marks nothing for
    a gradient."""
    saved = {}
    for name, fluid, M, exe in (("ref", jfluid, JD, jfluid.Executor()),
                                ("port", pfluid, PD,
                                 pfluid.Executor("cpu"))):
        main, startup, loss, pred = _deepfm(fluid, M)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if name == "ref":   # a trained model: one step
            exe.run(main, feed=_batches(1)[0], fetch_list=[loss], scope=scope)
        d = str(tmp_path / name)
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(d, ["sparse_ids", "dense_x"],
                                          [pred], exe, main_program=main)
        saved[name] = d
    assert (tmp_path / "ref" / "__model__").read_bytes() == \
        (tmp_path / "port" / "__model__").read_bytes()
    feed = {k: v for k, v in _batches(1, batch=16, seed=9)[0].items()
            if k != "label"}
    predictor = PI.create_predictor(PI.Config(saved["ref"], place="cpu"))
    ops = predictor.program.global_block().ops
    assert [o.type for o in ops].count("embedding_lookup") == 2
    assert not {"autodiff", "adam"} & {o.type for o in ops}
    got = predictor.run(feed)[0]
    want = np.asarray(JI.create_predictor(JI.Config(saved["ref"])).run(
        feed)[0])
    assert got.shape == (16, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=SERVE_ATOL)


# -- what is not ported ----------------------------------------------------------

def _sparse_embedding(**kw):
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup), pfluid.unique_name.guard():
        ids = pfluid.layers.data("ids", shape=[2], dtype="int64")
        return pfluid.layers.embedding(
            ids, size=[10, 2], is_sparse=True,
            param_attr=pfluid.ParamAttr(name="t"), **kw)


def _autodiff_with(attr, value):
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup), pfluid.unique_name.guard():
        x = pfluid.layers.data("x", shape=[3], dtype="float32")
        loss = pfluid.layers.mean(pfluid.layers.fc(x, 2))
        pfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    next(op for op in main.global_block().ops
         if op.type == "autodiff").attrs[attr] = value
    scope, exe = pfluid.Scope(), pfluid.Executor("cpu")
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": np.ones((2, 3), np.float32)},
            fetch_list=[loss], scope=scope)


def _recompute_sparse(fluid):
    """Recompute over a program with a SelectedRows gradient: the
    reference's and the port's refusal."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[2], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[10, 2], is_sparse=True)
        loss = fluid.layers.mean(fluid.layers.fc(emb, 2))
        opt = fluid.optimizer.RecomputeOptimizer(fluid.optimizer.SGD(0.1))
        opt._set_checkpoints([emb])
        opt.minimize(loss)
    exe = fluid.Executor() if fluid is jfluid else fluid.Executor("cpu")
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed={"ids": np.ones((2, 2), np.int64)},
            fetch_list=[loss], scope=scope)


# recompute is ported; with SelectedRows gradients both packages refuse
# it in the reference's words
@pytest.mark.parametrize("case,match", [
    ("is_distributed", "ROADMAP queue 8"),
    pytest.param("checkpoints",
                 "recompute \\+ sparse embedding grads not supported yet",
                 id="checkpoints-ROADMAP queue 1 item 3"),
    ("dist_push", "ROADMAP queue 8"),
])
def test_unported_tiers_raise_naming_their_roadmap_items(case, match):
    with pytest.raises(NotImplementedError, match=match):
        if case == "is_distributed":
            _sparse_embedding(is_distributed=True)
        elif case == "checkpoints":
            _recompute_sparse(pfluid)
        else:
            _autodiff_with("dist_push", [["t", "x", "x", 0.1, "sgd"]])
    if case == "checkpoints":
        # the reference's refusal reaches the caller inside its
        # op-attributed EnforceError
        with pytest.raises(RuntimeError, match=match):
            _recompute_sparse(jfluid)


def test_embedding_package_introspection():
    pm = _deepfm(pfluid, PD)[0]
    jm = _deepfm(jfluid, JD)[0]
    from paddle_tpu import embedding as JE

    assert [o.output("Out") for o in PE.find_sparse_lookup_ops(pm)] == \
        [o.output("Out") for o in JE.find_sparse_lookup_ops(jm)]
    assert PE.find_host_lookup_ops(pm) == [] and not PE.has_host_table("x")
    assert PE.SPARSE_LOOKUP_TYPES == JE.lookup.SPARSE_LOOKUP_TYPES
    assert PE.HOST_LOOKUP_TYPES == JE.lookup.HOST_LOOKUP_TYPES
    dense = _deepfm(pfluid, PD, is_sparse=False)[0]
    assert PE.find_sparse_lookup_ops(dense) == []
    with pytest.raises(ValueError, match="residence"):
        _sparse_embedding(residence="disk")


def test_sparse_step_builds_no_vocab_sized_tensor():
    """chip_smoke.py's SelectedRows step check on the CPU at the tiny
    config: the gradients' shapes, no aten op making a [vocab, ...]
    tensor in a sparse step, untouched rows and moments frozen to the
    bit after 3 steps; and the same spy finds the dense program's
    [vocab, dim] gradients (so it can see one)."""
    import chip_smoke as smoke

    main, startup, loss, _ = _deepfm(pfluid, PD)
    scope = pfluid.Scope()
    pfluid.Executor("cpu").run(startup, scope=scope)
    feed = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    smoke.deepfm_sparse_step(pfluid, torch.device("cpu"), main, feed, loss,
                             scope, 1000)
    dense, _, dloss, _ = _deepfm(pfluid, PD, is_sparse=False)
    sc = smoke.clone_scope(pfluid, scope)
    seen = smoke.vocab_sized_outputs(lambda: pfluid.Executor("cpu").run(
        dense, feed=feed, fetch_list=[dloss], scope=sc), 1000, sc)
    assert "aten.embedding_dense_backward.default" in seen


def _card_vs_cpu_rows(fault):
    """Rows as ``chip_smoke.card_vs_cpu`` gives them (card vs CPU, CPU vs
    float64, step, name, card vs CPU, CPU vs float64: the largest
    difference over the largest magnitude, then the L2 difference over
    the L2 norm of the update), with the readings of a sound H100 run
    at step 2, where one relu input took the other sign on the card
    (fm_emb's largest difference 1.05e-2 against noise of 2.4e-6, its
    L2 difference 2.6e-4 of its update), and one planted fault."""
    rows = [(8e-8, 1e-8, 0, "loss", 8e-8, 1e-8),
            (1.6e-5, 3.5e-6, 0, "fm_emb", 8.1e-7, 6.4e-7),
            (8.6e-8, 2e-8, 1, "loss", 8.6e-8, 2e-8),
            (1.05e-2, 2.4e-6, 1, "fm_emb", 2.6e-4, 3.5e-6),
            (5.9e-3, 1.5e-5, 1, "deep_fc0.b_0", 5.0e-4, 3.3e-6)]
    if fault == "state_after_step_1":
        rows[1] = (2e-3, 3.5e-6, 0, "fm_emb", 1e-4, 6.4e-7)
    elif fault == "loss":
        rows[2] = (1e-3, 2e-8, 1, "loss", 1e-3, 2e-8)
    elif fault == "update":
        rows[3] = (1.05e-2, 2.4e-6, 1, "fm_emb", 0.3, 3.5e-6)
    return rows


@pytest.mark.parametrize("fault", [None, "state_after_step_1", "loss",
                                   "update"])
def test_card_vs_cpu_judges_later_state_by_update_gap(fault):
    """chip_smoke.py's card-vs-CPU verdict for DeepFM: every loss and
    the state after step 1 by their largest difference, the later state
    by each tensor's L2 difference over the L2 norm of its update,
    against max(the limit, 3 x the CPU's own against float64). A few
    parted elements pass; each planted fault is caught."""
    import chip_smoke as smoke

    losses = [(0.69, 0.69, 0.69)] * 2
    rec = smoke.card_vs_cpu_record(
        losses, _card_vs_cpu_rows(fault), smoke.DEEPFM_CPU_RTOL,
        state_steps=1, update_rtol=smoke.DEEPFM_CPU_UPDATE_RTOL)
    assert bool(rec["over"]) == (fault is not None), rec
    assert rec["later_update_rel_l2"] == (0.3 if fault == "update"
                                          else 5.0e-4)


def test_card_vs_cpu_rows_on_the_cpu():
    """``chip_smoke.card_vs_cpu`` run with the CPU in the card's place at
    the tiny config: a loss row and a row a persistable each step, six
    fields each, the two fp32 runs equal, and its record passes."""
    import chip_smoke as smoke

    main, startup, loss, _ = _deepfm(pfluid, PD)
    cpu = pfluid.Scope()
    pfluid.Executor("cpu").run(startup, scope=cpu)
    losses, rows = smoke.card_vs_cpu(
        pfluid, torch.device("cpu"), main, loss, cpu, _batches(2),
        lambda f: dict(f, dense_x=f["dense_x"].astype(np.float64)))
    names = cpu.local_var_names()
    assert len(rows) == 2 * (1 + len(names)) and len(losses) == 2
    assert all(len(r) == 6 and r[0] == 0.0 and r[4] == 0.0 for r in rows)
    assert all(r[5] > 0.0 for r in rows if r[3] == "fm_emb")
    rec = smoke.card_vs_cpu_record(losses, rows, smoke.DEEPFM_CPU_RTOL,
                                   state_steps=1,
                                   update_rtol=smoke.DEEPFM_CPU_UPDATE_RTOL)
    assert not rec["over"] and rec["steps"] == 2
