"""Scope and Executor: run a Program's global block eagerly on one device.

The port's counterpart of ``paddle_tpu/fluid/executor.py`` for
``iters=1``. The reference traces a block into one jitted XLA step; the
port lowers it op by op (``registry.lower_op``), each op launching its
torch work or kernel at once. A run

1. normalises the feeds to their declared dtypes on the device (numpy
   has no bfloat16, so a feed declared bfloat16 raises);
2. gathers the program's persistables from the scope;
3. binds each ``wrt`` parameter of the block's ``autodiff`` op as a fresh
   autograd leaf, so the forward ops build the graph as they run;
4. lowers the ops in order: those before ``autodiff`` with autograd on,
   each ``stop_gradient`` output detached where it is produced, the rest
   under ``torch.no_grad()``; an environment entry is dropped after its
   last reader, so activations live no longer than autograd needs them;
5. commits the persistables written and those created (a startup
   program's) to the scope, and returns the fetches as numpy (bfloat16
   ones as float32).

RNG: each scope holds one ``torch.Generator`` on the executor's device,
seeded from ``program.random_seed`` at its first run, as the reference
seeds its ``@rng_state@`` var, and kept across runs; random ops draw from
it in op order.

Not ported yet: ``iters=k`` windows, ``fetch_mode="async"``,
``CompiledProgram``, the compile cache, the anomaly policy, readers,
checkpoints and the profiler hooks.
"""

import contextlib

import numpy as np
import torch

from .. import resolve_device
from . import framework
from .framework import Variable
from .registry import LowerCtx, lower_op

__all__ = ["Scope", "global_scope", "scope_guard", "Executor", "copy_scope"]

# Programs are held to the reference in fp32, so fp32 products must not
# drop to TF32 on the card (AMP programs cast to bf16 explicitly).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Scope:
    """name -> tensor store, plus the generator random ops draw from.
    (Nested scopes wait for the control-flow ops that need them.)"""

    def __init__(self):
        self.vars = {}
        self.generator = None

    def find_var(self, name):
        return self.vars.get(name)

    def has_var(self, name):
        return name in self.vars

    def set_var(self, name, value):
        self.vars[name] = value

    def local_var_names(self):
        return list(self.vars)

    def rng(self, device, seed):
        """The scope's generator, made on ``device`` and seeded with
        ``seed`` at first use."""
        if self.generator is None:
            self.generator = torch.Generator(device=device)
            self.generator.manual_seed(int(seed))
        elif self.generator.device != torch.device(device):
            raise RuntimeError("this scope's generator lives on %s, not %s"
                               % (self.generator.device, device))
        return self.generator


_scope_stack = [Scope()]


def global_scope():
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


def copy_scope(src, dst, names, device="cuda"):
    """Copy the persistables ``names`` from ``src`` (any scope whose values
    convert to numpy, such as the reference package's after its startup
    program) into ``dst`` on ``device``, names and layouts unchanged. The
    two packages draw different random numbers, so parity runs start from
    the same copied state."""
    device = resolve_device(device)
    for n in names:
        val = src.find_var(n)
        if val is None:
            raise KeyError("%r is not in the source scope" % n)
        dst.set_var(n, torch.from_numpy(np.array(val)).to(device))


class Executor:
    """Runs programs on ``place`` ("cuda" by default; "cpu" runs the
    kernels' plain versions). ``promote_products`` lets mul and matmul
    take operands of two float types (a Predictor's bf16 weights against
    fp32 activations); training leaves it off, so a missed cast raises."""

    def __init__(self, place=None, promote_products=False):
        self.place = resolve_device("cuda" if place is None else place)
        self.promote_products = bool(promote_products)

    def _feed(self, block, name, value):
        var = block._find_var_recursive(name)
        if var is not None and var.dtype == framework.BFLOAT16:
            raise TypeError(
                "feed %r is declared bfloat16, which numpy cannot hold; "
                "feed float32 and cast inside the program" % name)
        arr = np.asarray(value)
        if var is not None and arr.dtype != var.dtype:
            arr = arr.astype(var.dtype)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.place)

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        program = program or framework.default_main_program()
        scope = scope or global_scope()
        block = program.global_block()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]

        env = {n: self._feed(block, n, v) for n, v in (feed or {}).items()}
        persistable = {v.name for v in program.list_vars() if v.persistable}
        for n in persistable:
            if n not in env and scope.has_var(n):
                env[n] = scope.find_var(n)
        ops = block.ops
        grad_at = next((i for i, op in enumerate(ops)
                        if op.type == "autodiff"), len(ops))
        wrt = set(ops[grad_at].attr("wrt")) if grad_at < len(ops) else set()
        for n in wrt:
            env[n] = env[n].detach().requires_grad_(True)
        drop_after = _last_readers(ops, set(fetch_names) | persistable)

        ctx = LowerCtx(block, env, scope.rng(self.place, program.random_seed),
                       self.place)
        ctx.promote_products = self.promote_products
        for i, op in enumerate(ops):
            with torch.set_grad_enabled(i <= grad_at < len(ops)):
                lower_op(ctx, op)
            if i < grad_at:
                for n in op.output_arg_names():
                    v = block._find_var_recursive(n)
                    if n in env and v is not None and v.stop_gradient \
                            and n not in wrt:
                        env[n] = env[n].detach()
            for n in drop_after[i]:
                env.pop(n, None)

        for n in persistable:
            if n in env and (n in ctx.written or not scope.has_var(n)):
                scope.set_var(n, env[n].detach())
        fetches = [env[n].detach() for n in fetch_names]
        if return_numpy:
            # numpy has no bfloat16: a bf16 fetch comes back as float32
            return [(t.float() if t.dtype == torch.bfloat16 else t)
                    .cpu().numpy() for t in fetches]
        return fetches


def _last_readers(ops, keep):
    """For each op index, the env names no later op touches (kept names
    excepted): the run drops them once that op has run."""
    last = {}
    for i, op in enumerate(ops):
        for n in op.input_arg_names() + op.output_arg_names():
            last[n] = i
        if op.type == "autodiff":
            for n in [op.attr("loss"), op.attr("loss_scale_var")] + list(
                    op.attr("wrt")):
                if n:
                    last[n] = i
    out = [[] for _ in ops]
    for n, i in last.items():
        if n not in keep:
            out[i].append(n)
    return out
