"""append_backward: the gradient entry point (the port's counterpart of
``paddle_tpu/fluid/backward.py``). One ``autodiff`` op is appended whose
lowering asks torch autograd for the gradients of the loss with respect
to every trainable parameter (``ops/autodiff.py``).

Dense parameters only: SelectedRows gradients of sparse lookups, the
parameter-server push and recompute ``checkpoints`` are not ported yet.
"""

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


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Append the gradient of ``loss`` with respect to the trainable
    parameters. Returns ``[(param, grad_var), ...]``."""
    program = loss.block.program
    block = loss.block
    params = _collect_params(program, parameter_list, no_grad_set)
    if not params:
        raise ValueError("No trainable parameters to differentiate")
    grad_vars, wrt, gnames = [], [], []
    for p in params:
        gname = grad_var_name(p.name)
        grad_vars.append(block.create_var(
            name=gname, shape=p.shape, dtype=p.dtype, persistable=False,
            stop_gradient=True))
        wrt.append(p.name)
        gnames.append(gname)
        program.param_grad_map[p.name] = gname
    # loss@GRAD exists for API parity (the constant 1 is implicit)
    block.create_var(name=grad_var_name(loss.name), shape=loss.shape,
                     dtype=loss.dtype, stop_gradient=True)
    block.append_op(
        "autodiff", inputs={"Loss": [loss]}, outputs={"Grads": gnames},
        attrs={"loss": loss.name, "wrt": wrt, "grad_names": gnames,
               "loss_scale": 1.0})
    return list(zip(params, grad_vars))
