"""Op registry: op type -> lowering rule, on torch tensors.

The port's counterpart of ``paddle_tpu/fluid/registry.py``, kept apart
from the JAX registry. A lowering rule ``lower(ctx, op)`` reads its
inputs with ``ctx.get_input`` and binds its outputs with
``ctx.set_output``. The executor runs the rules eagerly, op by op, so
each rule computes its op at once on the tensors' device. Shape
inference runs the same rules on ``meta`` tensors.

Randomness comes from one explicit ``torch.Generator`` (the scope's, see
``executor.py``): random ops draw from it in op order through
``LowerCtx.next_seed``, ``random_bytes``, ``uniform``, ``randint`` and
``normal``, where the JAX registry splits a threaded PRNG key. A ``DrawRecord`` set
on the context (``draw_record``) keeps what each op drew, and replays
it: recompute runs a segment of ops a second time in the backward, and
its ops must see the primal run's draws (the reference's
``replay_keys``) without moving the generator.

A control-flow op lowers its sub-blocks with ``lower_block``, in a child
context (``LowerCtx.child``) over an environment of its own: the child
shares the parent's generator, device, draw record and flags, and the
op decides which of the child's bindings reach the parent.
"""

import torch

from .framework import convert_dtype


class OpRegistry:
    def __init__(self):
        self._ops = {}

    def register(self, type):
        """Decorator: ``fn(ctx, op)`` lowers ops of ``type``."""
        def deco(fn):
            self._ops[type] = fn
            return fn
        return deco

    def get(self, type):
        lower = self._ops.get(type)
        if lower is None:
            raise NotImplementedError(
                "Op %r has no lowering rule registered in the port "
                "(see paddle_tpu_torch/fluid/ops/)" % type)
        return lower

    def has(self, type):
        return type in self._ops


registry = OpRegistry()
register = registry.register


class DrawRecord:
    """The draws of a stretch of ops, per op index, in op order: while
    recording each draw is made and kept; once ``replaying``, each op is
    handed back the tensors it drew (the seeds ``[1]`` int64, the masks'
    uint8 words), with no generator draw and no host sync, so a replay
    is safe inside a CUDA graph capture. The kept tensors live as long
    as the record."""

    def __init__(self):
        self.draws = {}
        self.replaying = False
        self._op = None
        self._next = 0

    def at_op(self, index):
        """The draws that follow are op ``index``'s."""
        self._op, self._next = index, 0

    def take(self, draw):
        """``draw()``'s tensor, recorded; or, replaying, the one the op
        drew at this place."""
        i, self._next = self._next, self._next + 1
        if not self.replaying:
            t = draw()
            self.draws.setdefault(self._op, []).append(t)
            return t
        got = self.draws.get(self._op, ())
        if i >= len(got):
            raise RuntimeError(
                "a replayed op (index %s) asked for draw %d, which its "
                "recorded run did not make" % (self._op, i))
        return got[i]


class LowerCtx:
    """The environment a block is lowered in.

    - ``env``: name -> torch tensor;
    - ``written``: persistable names assigned while lowering (optimizer
      updates), which the executor commits back to the Scope;
    - ``generator``: the torch.Generator random ops draw from, on
      ``device``; None under shape inference, where ``device`` is meta
      and draws give shapes only;
    - ``promote_products``: whether mul and matmul promote operands of
      two float types to their common type (else they raise);
    - ``sparse_outs``: the outputs of the sparse lookups whose cotangent
      the block's ``autodiff`` op reads as a SelectedRows gradient; each
      such lookup binds its output as an autograd leaf in
      ``sparse_leaves`` (``ops/tensor_ops.py``, ``sparse_leaf``);
    - ``draw_record``: None, or the ``DrawRecord`` the draws go through;
    - ``wrt``: the names bound as autograd leaves, which a sub-block's
      ``stop_gradient`` detaching leaves alone.
    """

    draw_record = None
    wrt = frozenset()

    def __init__(self, block, env, generator, device):
        self.block = block
        self.program = block.program
        self.env = env
        self.generator = generator
        self.device = torch.device(device)
        self.written = set()
        self.promote_products = False
        self.sparse_outs = frozenset()
        self.sparse_leaves = {}

    def child(self, block, env):
        """A context for lowering the sub-block ``block`` in ``env``: the
        same generator, device, draw record and flags. Its ``written``
        is its own; the control-flow op sets in the parent what its
        carry keeps."""
        c = LowerCtx(block, env, self.generator, self.device)
        c.promote_products = self.promote_products
        c.sparse_outs = self.sparse_outs
        c.sparse_leaves = self.sparse_leaves
        c.draw_record = self.draw_record
        c.wrt = self.wrt
        return c

    def get(self, name):
        if name not in self.env:
            raise KeyError(
                "Var %r not materialized; it must be fed, persistable, or "
                "produced by an earlier op" % name)
        return self.env[name]

    def get_input(self, op, slot, default=None):
        names = op.input(slot)
        if not names:
            return default
        return self.get(names[0])

    def get_inputs(self, op, slot):
        return [self.get(n) for n in op.input(slot)]

    def set(self, name, value):
        self.env[name] = value
        v = self.block._find_var_recursive(name)
        if v is not None and v.persistable:
            self.written.add(name)

    def set_output(self, op, slot, value):
        names = op.output(slot)
        if names:
            self.set(names[0], value)

    def var(self, name):
        return self.block._find_var_recursive(name)

    def var_dtype(self, name):
        v = self.var(name)
        return convert_dtype(None if v is None else v.dtype)

    # -- draws from the generator, in op order ------------------------------
    @property
    def abstract(self):
        return self.generator is None

    def _draw(self, draw):
        if self.draw_record is None:
            return draw()
        return self.draw_record.take(draw)

    def next_seed(self):
        """An int64 tensor [1] on the device: a kernel's 64-bit seed, drawn
        without a host sync."""
        if self.abstract:
            return torch.empty(1, dtype=torch.int64, device=self.device)
        return self._draw(lambda: torch.randint(
            0, 2 ** 62, (1,), dtype=torch.int64, device=self.device,
            generator=self.generator))

    def random_bytes(self, shape):
        """uint8 tensor of uniform random words."""
        if self.abstract:
            return torch.empty(shape, dtype=torch.uint8, device=self.device)
        return self._draw(lambda: torch.randint(
            0, 256, tuple(shape), dtype=torch.uint8, device=self.device,
            generator=self.generator))

    def uniform(self, shape, low, high):
        """fp32 tensor uniform in [low, high)."""
        if self.abstract:
            return torch.empty(shape, dtype=torch.float32, device=self.device)
        u = self._draw(lambda: torch.rand(
            tuple(shape), dtype=torch.float32, device=self.device,
            generator=self.generator))
        return u * (high - low) + low

    def randint(self, shape, high):
        """int64 tensor uniform in [0, high)."""
        if self.abstract:
            return torch.empty(shape, dtype=torch.int64, device=self.device)
        return self._draw(lambda: torch.randint(
            0, int(high), tuple(shape), dtype=torch.int64, device=self.device,
            generator=self.generator))

    def normal(self, shape, mean, std):
        """fp32 tensor normal with ``mean`` and ``std``."""
        if self.abstract:
            return torch.empty(shape, dtype=torch.float32, device=self.device)
        n = self._draw(lambda: torch.randn(
            tuple(shape), dtype=torch.float32, device=self.device,
            generator=self.generator))
        return n * std + mean


def to_torch_dtype(dtype):
    """torch dtype of an IR dtype spec (numpy dtype, its name, or
    ``"bfloat16"``)."""
    return _TORCH_DTYPES[convert_dtype(dtype)]


def to_numpy_dtype(dtype):
    """IR dtype of a torch dtype: a numpy dtype, or ``BFLOAT16``."""
    return _NUMPY_DTYPES[dtype]


_TORCH_DTYPES = {convert_dtype(n): getattr(torch, n) for n in (
    "float32", "float64", "float16", "bfloat16", "int8", "uint8", "int16",
    "int32", "int64", "bool")}
_NUMPY_DTYPES = {t: n for n, t in _TORCH_DTYPES.items()}


class EnforceError(RuntimeError):
    """Op-attributed error: which op failed and where user code created
    it."""


class EnforceNotImplementedError(EnforceError, NotImplementedError):
    """Op-attributed error of a lowering that met something the port
    has not ported yet: a NotImplementedError as well."""


def attribute_op_error(op, exc):
    """Re-raise ``exc`` wrapped with the op's identity and creation site."""
    lines = ["op %r failed during lowering: %s: %s"
             % (op.type, type(exc).__name__, exc)]
    ins = {k: v for k, v in op.inputs.items() if v}
    outs = {k: v for k, v in op.outputs.items() if v}
    lines.append("  inputs: %r  outputs: %r" % (ins, outs))
    stack = getattr(op, "callstack", None)
    if stack:
        lines.append("  created at (most recent user frame first):")
        lines.extend("    " + s for s in stack)
    cls = EnforceNotImplementedError if isinstance(
        exc, NotImplementedError) else EnforceError
    raise cls("\n".join(lines)) from exc


def propagate_lod(ctx, op):
    """Dataflow LoD propagation (the reference's rule, its ShareLoD): if
    the op's inputs that carry an @LOD binding agree on the sequence
    count and the token dim, each output of that token dim without a
    binding of its own inherits the first one's lengths, and its time
    bound where one is known. Runs on the environment the op ran in (an
    ``autodiff`` segment's copy included)."""
    from .lod import bound_name, lod_name

    env = ctx.env
    in_lods = [n for n in op.input_arg_names()
               if lod_name(n) in env and n in env]
    if not in_lods:
        return
    leads = set()
    first = env[lod_name(in_lods[0])]
    for n in in_lods:
        v = env[n]
        if not isinstance(v, torch.Tensor) or v.dim() == 0 or \
                env[lod_name(n)].shape != first.shape:
            return
        leads.add(v.shape[0])
    if len(leads) != 1:
        return
    lead = leads.pop()
    bound = env.get(bound_name(in_lods[0]))
    for out in op.output_arg_names():
        if lod_name(out) in env or out not in env:
            continue
        v = env[out]
        if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == lead:
            env[lod_name(out)] = first
            if bound is not None:
                env[bound_name(out)] = bound


def lower_op(ctx, op):
    """Lower ONE op, naming the op and its creation site on failure, then
    propagate LoD bindings to its outputs (``propagate_lod``)."""
    try:
        registry.get(op.type)(ctx, op)
    except EnforceError:
        raise
    except Exception as e:  # noqa: BLE001 — attribute, then re-raise
        attribute_op_error(op, e)
    propagate_lod(ctx, op)


def lower_block(ctx, block, env):
    """Lower every op of the sub-block ``block`` in ``env`` (a child of
    ``ctx``), in the autograd mode the parent runs in; where gradients
    are on, each ``stop_gradient`` output is detached where it is
    produced, as in the global block. Returns ``env``."""
    sub = ctx.child(block, env)
    grads = torch.is_grad_enabled()
    for op in block.ops:
        lower_op(sub, op)
        if not grads:
            continue
        for n in op.output_arg_names():
            v = block._find_var_recursive(n)
            if v is not None and v.stop_gradient and n not in ctx.wrt \
                    and isinstance(env.get(n), torch.Tensor):
                env[n] = env[n].detach()
    return env
