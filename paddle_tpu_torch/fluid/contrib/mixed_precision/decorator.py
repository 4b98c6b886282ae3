"""mixed_precision.decorate: the AMP optimizer wrapper (the port's copy
of ``paddle_tpu/fluid/contrib/mixed_precision/decorator.py``, emitting
the same ops under the same names).

Defaults: bfloat16, whose exponent range is fp32's, with a static loss
scale of 1.0, so the ``autodiff`` op gets ``loss_scale`` 1.0 and no
scaling ops are added. Dynamic loss scaling multiplies the objective by
the ``loss_scaling`` variable (the ``autodiff`` op's ``loss_scale_var``),
divides the gradients by the scale they were computed with, checks them
with ``isfinite`` and, on an overflow, selects zeros for the whole
gradient set that step. After ``decr_every_n_nan_or_inf`` overflow steps
in a row the scale is multiplied by ``decr_ratio``; after
``incr_every_n_steps`` clean steps by ``incr_ratio``. Every update is an
op of the program, on the device.

A SelectedRows gradient is unscaled and gated like a dense one, on its
values; each derived gradient keeps the ``selected_rows`` type and its
rows (an ``assign`` of ``<grad>@ROWS``). Not ported: the
parameter-server ``distributed_push`` payloads the reference also
unscales (the port has no PS tier yet).
"""

from ... import unique_name
from ...framework import default_startup_program
from .fp16_lists import AutoMixedPrecisionLists
from .fp16_utils import rewrite_program

__all__ = ["decorate", "OptimizerWithMixedPrecision"]


def _scalar_var(block, name, dtype, value):
    v = block.create_var(name=name, shape=[1], dtype=dtype, persistable=True)
    sb = default_startup_program().global_block()
    sb.create_var(name=name, shape=[1], dtype=dtype, persistable=True)
    sb.append_op("fill_constant", outputs={"Out": [name]},
                 attrs={"shape": [1], "dtype": dtype, "value": value})
    return v


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio, dest_dtype):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._dest_dtype = dest_dtype
        self._loss_scaling = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        main = loss.block.program
        rewrite_program(main, self._amp_lists, self._dest_dtype)
        params_grads = self._optimizer.backward(
            loss, startup_program, parameter_list, no_grad_set)
        block = main.global_block()

        helper_name = unique_name.generate("loss_scaling")
        if self._use_dynamic:
            self._loss_scaling = _scalar_var(
                block, helper_name, "float32", self._init_loss_scaling)
            self._good_steps = _scalar_var(
                block, helper_name + "_good", "int32", 0)
            self._bad_steps = _scalar_var(
                block, helper_name + "_bad", "int32", 0)

        for op in block.ops:
            if op.type == "autodiff":
                if self._use_dynamic:
                    op.attrs["loss_scale_var"] = self._loss_scaling.name
                else:
                    op.attrs["loss_scale"] = self._init_loss_scaling

        if self._use_dynamic:
            finite_names = []
            for _, g in params_grads:
                fname = g.name + ".finite"
                block.create_var(name=fname, shape=[], dtype="bool",
                                 stop_gradient=True)
                block.append_op("isfinite", {"X": [g.name]}, {"Out": [fname]})
                finite_names.append(fname)
            all_finite = finite_names[0]
            for fn in finite_names[1:]:
                nxt = unique_name.generate("all_finite")
                block.create_var(name=nxt, shape=[], dtype="bool",
                                 stop_gradient=True)
                block.append_op("logical_and", {"X": [all_finite], "Y": [fn]},
                                {"Out": [nxt]})
                all_finite = nxt
            gate = unique_name.generate("amp_gate")
            block.create_var(name=gate, shape=[], dtype="float32",
                             stop_gradient=True)
            block.append_op("cast", {"X": [all_finite]}, {"Out": [gate]},
                            {"out_dtype": "float32"})
            # the scale the gradients were computed with, taken before
            # the update below rebinds the variable
            pre = unique_name.generate("loss_scaling_pre")
            block.create_var(name=pre, shape=[1], dtype="float32",
                             stop_gradient=True)
            block.append_op("assign", {"X": [self._loss_scaling.name]},
                            {"Out": [pre]})
            self._append_scale_update(block, gate)

        inv = 1.0 / self._init_loss_scaling
        new_pg = []
        for p, g in params_grads:
            if inv == 1.0 and not self._use_dynamic:
                new_pg.append((p, g))
                continue

            sparse = getattr(g, "type", "lod_tensor") == "selected_rows"

            def derive(suffix, rows=True, g=g):
                """A var derived from ``g``; a SelectedRows gradient's
                keeps its type and binds its rows (``<name>@ROWS``), or
                the optimizer would take its [n, dim] values for a dense
                gradient."""
                keep = sparse and rows
                nv = g.block.create_var(
                    name=g.name + suffix, shape=g.shape, dtype=g.dtype,
                    stop_gradient=True,
                    type="selected_rows" if keep else "lod_tensor")
                if keep:
                    g.block.create_var(name=nv.name + "@ROWS", shape=(-1,),
                                       dtype="int32", stop_gradient=True)
                    block.append_op("assign", {"X": [g.name + "@ROWS"]},
                                    {"Out": [nv.name + "@ROWS"]})
                return nv

            scaled = derive(".unscaled")
            if self._use_dynamic:
                block.append_op("elementwise_div",
                                {"X": [g.name], "Y": [pre]},
                                {"Out": [scaled.name]}, {"axis": -1})
                # select, not multiply: inf * 0 is nan
                zeros = derive(".zeros", rows=False)
                block.append_op("zeros_like", {"X": [g.name]},
                                {"Out": [zeros.name]})
                gated = derive(".gated")
                block.append_op("where",
                                {"Condition": [all_finite],
                                 "X": [scaled.name], "Y": [zeros.name]},
                                {"Out": [gated.name]})
                scaled = gated
            else:
                block.append_op("scale", {"X": [g.name]},
                                {"Out": [scaled.name]},
                                {"scale": inv, "bias": 0.0,
                                 "bias_after_scale": True})
            new_pg.append((p, scaled))
        return new_pg

    def _append_scale_update(self, block, gate_name):
        """loss_scaling, good_steps and bad_steps updated in elementwise
        arithmetic:

        ready      = good+1 >= incr_every_n_steps
        decr_ready = bad+1  >= decr_every_n_nan_or_inf
        scale' = finite ? (ready ? scale*incr : scale)
                        : (decr_ready ? scale*decr : scale)
        good'  = finite ? (ready ? 0 : good+1) : 0
        bad'   = finite ? 0 : (decr_ready ? 0 : bad+1)
        """
        s, good, bad = (self._loss_scaling.name, self._good_steps.name,
                        self._bad_steps.name)

        def tmp(dtype="float32"):
            n = unique_name.generate("amp_ls")
            block.create_var(name=n, shape=[1], dtype=dtype,
                             stop_gradient=True)
            return n

        def op(type, inputs, attrs=None, dtype="float32"):
            out = tmp(dtype)
            block.append_op(type, inputs, {"Out": [out]}, attrs)
            return out

        def affine(x, scale, bias=1.0):
            return op("scale", {"X": [x]}, {"scale": scale, "bias": bias,
                                            "bias_after_scale": True})

        def mul(x, y, type="elementwise_mul"):
            return op(type, {"X": [x], "Y": [y]}, {"axis": -1})

        def plus1_float(counter):
            return affine(op("cast", {"X": [counter]},
                             {"out_dtype": "float32"}), 1.0)

        def ge_const(x, value):
            thresh = tmp()
            block.append_op("fill_constant", outputs={"Out": [thresh]},
                            attrs={"shape": [1], "dtype": "float32",
                                   "value": float(value)})
            gb = op("greater_equal", {"X": [x], "Y": [thresh]},
                    dtype="bool")
            return op("cast", {"X": [gb]}, {"out_dtype": "float32"})

        good1 = plus1_float(good)
        bad1 = plus1_float(bad)
        ready = ge_const(good1, self._incr_every_n_steps)
        decr_ready = ge_const(bad1, self._decr_every_n_nan_or_inf)

        # factor = finite (1 + ready (incr - 1))
        #          + (1 - finite) (1 + decr_ready (decr - 1))
        t2 = mul(affine(ready, self._incr_ratio - 1.0), gate_name)
        notf = affine(gate_name, -1.0)
        t3 = mul(notf, affine(decr_ready, self._decr_ratio - 1.0))
        factor = mul(t2, t3, "elementwise_add")
        block.append_op("assign", {"X": [mul(s, factor)]}, {"Out": [s]})

        def update_counter(counter, keep_gate, ready_f, c1):
            # counter' = keep_gate * (1 - ready_f) * (counter + 1)
            t6 = mul(mul(affine(ready_f, -1.0), keep_gate), c1)
            newc = op("cast", {"X": [t6]}, {"out_dtype": "int32"},
                      dtype="int32")
            block.append_op("assign", {"X": [newc]}, {"Out": [counter]})

        update_counter(good, gate_name, ready, good1)
        update_counter(bad, notf, decr_ready, bad1)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.5,
             use_dynamic_loss_scaling=False, dest_dtype="bfloat16"):
    """Wrap an optimizer for mixed-precision training: bfloat16, static
    scale 1.0 by default."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        dest_dtype)
