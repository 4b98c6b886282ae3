"""append_backward: the gradient entry point (the port's counterpart of
``paddle_tpu/fluid/backward.py``). One ``autodiff`` op is appended whose
lowering asks torch autograd for the gradients of the loss with respect
to every trainable parameter (``ops/autodiff.py``).

A parameter that only one sparse lookup reads (``embedding_lookup``, or
``lookup_table`` with ``is_sparse``) gets a SelectedRows gradient: a
``selected_rows`` grad var of shape (-1, dim...) for the values and an
int32 ``<grad>@ROWS`` var for the rows, listed in the ``autodiff`` op's
``sparse_wrt`` attr as [param, ids, lookup output].

``checkpoints`` (``RecomputeOptimizer``) are recorded on the
``autodiff`` op for recompute. Gradients flow through ``cond``,
``switch``, ``StaticRNN`` and a bounded ``while_loop``, not through a
``While`` or an unbounded ``while_loop`` (``ops/autodiff.py``). Not ported yet: the parameter-server push
(``distributed_lookup_table``), which the ``autodiff`` op refuses.
"""

from ..embedding.lookup import is_sparse_lookup
from .framework import Variable, grad_var_name

__all__ = ["append_backward"]


def _collect_params(program, parameter_list=None, no_grad_set=None):
    no_grad = set(no_grad_set or [])
    if parameter_list is not None:
        names = [p.name if isinstance(p, Variable) else p
                 for p in parameter_list]
        params = [program.global_block().var(n) for n in names]
    else:
        params = program.all_parameters()
    return [p for p in params
            if getattr(p, "trainable", True) and not p.stop_gradient
            and p.name not in no_grad]


def _sparse_params(block):
    """{param name: its one sparse lookup op}. Two passes, whatever the
    op order: collect every sparse lookup's W, then drop a W that any
    other op reads or writes, or that more than one lookup reads."""
    lookups = {}
    for op in block.ops:
        if is_sparse_lookup(op):
            for w in op.input("W"):
                lookups.setdefault(w, []).append(op)
    for op in block.ops:
        sparse_w = set(op.input("W")) if is_sparse_lookup(op) else set()
        for name in op.input_arg_names() + op.output_arg_names():
            if name in lookups and name not in sparse_w:
                lookups[name] = None  # another use: a dense gradient
    return {k: v[0] for k, v in lookups.items() if v and len(v) == 1}


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append the gradient of ``loss`` with respect to the trainable
    parameters. Returns ``[(param, grad_var), ...]``."""
    program = loss.block.program
    block = loss.block
    params = _collect_params(program, parameter_list, no_grad_set)
    if not params:
        raise ValueError("No trainable parameters to differentiate")
    sparse = _sparse_params(block)
    grad_vars, wrt, gnames, sparse_wrt = [], [], [], []
    for p in params:
        gname = grad_var_name(p.name)
        if p.name in sparse:
            lookup = sparse[p.name]
            gv = block.create_var(
                name=gname, shape=(-1,) + tuple(p.shape[1:]), dtype=p.dtype,
                persistable=False, stop_gradient=True, type="selected_rows")
            block.create_var(name=gname + "@ROWS", shape=(-1,),
                             dtype="int32", persistable=False,
                             stop_gradient=True)
            sparse_wrt.append([p.name, lookup.input("Ids")[0],
                               lookup.output("Out")[0]])
        else:
            gv = block.create_var(name=gname, shape=p.shape, dtype=p.dtype,
                                  persistable=False, stop_gradient=True)
        grad_vars.append(gv)
        wrt.append(p.name)
        gnames.append(gname)
        program.param_grad_map[p.name] = gname
    # loss@GRAD exists for API parity (the constant 1 is implicit)
    block.create_var(name=grad_var_name(loss.name), shape=loss.shape,
                     dtype=loss.dtype, stop_gradient=True)
    attrs = {"loss": loss.name, "wrt": wrt, "grad_names": gnames,
             "loss_scale": 1.0}
    if sparse_wrt:
        attrs["sparse_wrt"] = sparse_wrt
    if checkpoints:
        attrs["checkpoints"] = [c.name if isinstance(c, Variable) else c
                                for c in checkpoints]
    block.append_op("autodiff", inputs={"Loss": [loss]},
                    outputs={"Grads": gnames}, attrs=attrs)
    return list(zip(params, grad_vars))
