"""Graph-building IR: Program / Block / Operator / Variable / Parameter.

The port's copy of the subset of ``paddle_tpu/fluid/framework.py`` that
the static-graph training path uses. The IR is the same declarative
program of named ops over named vars, with the same plain-dict exchange
format (``Program.to_desc`` / ``Program.from_desc``), so a program built
by either package runs in the other. Shapes are inferred by running each
op's torch lowering on ``meta`` tensors (``shape_inference.py``); the
executor (``executor.py``) lowers a block eagerly, op by op.

``serialize_to_string`` / ``parse_from_string`` write and read the
reference's protobuf bytes through the port's own wire codec
(``core/proto_io.py``); ``_prune`` cuts a program to the ops its fetch
targets need (``io.save_inference_model``).

Sub-blocks: ``Program._create_block`` opens a block whose parent is the
current one and ``_rollback`` returns to the parent; the control-flow
layers (``layers/control_flow.py``) build their bodies and branches
there, and name them by index in their op's attrs (``sub_block``,
``true_block``, ``blocks``, ...). Such an op reads and writes more than
it declares: ``transitive_args`` adds what its sub-blocks' ops read and
write, at any depth, for pruning, shape inference and the executor's
liveness.

The dygraph switch (``_dygraph_tracer``, ``in_dygraph_mode``,
``_dygraph_guard``) is the one ``dygraph.guard()`` sets. Not carried
over yet: name scopes. ``Variable`` carries the reference's operator
sugar (``+ - * / **``, unary minus, ``< <= > >=``), which appends ops
through ``layers/math_op_patch.py`` as the reference does.
"""

import contextlib
import copy
import itertools
import os
import sys

import numpy as np

from . import unique_name

# version of the exchange format (the reference's compat.PROGRAM_VERSION)
PROGRAM_VERSION = 1

_DTYPES = {name: np.dtype(name) for name in (
    "float32", "float64", "float16", "int8", "uint8", "int16", "int32",
    "int64", "bool")}


class BFloat16Dtype:
    """The IR's bfloat16, the AMP type. Plain numpy has no bfloat16 (the
    JAX package borrows ``ml_dtypes``'s, which the card's machine may
    lack), so the port spells it with this one object: its ``name`` is
    "bfloat16", the desc's spelling in both packages, and it equals
    any dtype of that name. Tensors of this type are torch.bfloat16."""

    name = "bfloat16"
    itemsize = 2

    def __eq__(self, other):
        return getattr(other, "name", other) == self.name

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return "dtype('bfloat16')"


BFLOAT16 = BFloat16Dtype()


def convert_dtype(dtype):
    """Normalise a dtype spec (str / np.dtype / torch.bfloat16) to
    np.dtype, or to ``BFLOAT16`` for bfloat16; None is float32."""
    if dtype is None:
        return np.dtype("float32")
    if isinstance(dtype, str) and dtype in _DTYPES:
        return _DTYPES[dtype]
    if dtype == BFLOAT16 or str(dtype) == "torch.bfloat16":
        return BFLOAT16
    return np.dtype(dtype)


def dtype_str(dtype):
    return convert_dtype(dtype).name


class Variable:
    """A named tensor slot in a Block: static metadata only. At run time
    the value lives in a Scope (persistables) or in the executor's
    environment. ``shape`` may hold -1 for the batch dimension.

    ``type`` is "lod_tensor" (dense) or "selected_rows": a SelectedRows
    gradient, whose NAME binds the [n, dim...] values and NAME + "@ROWS"
    the int32 row ids, one per lookup position (the reference's
    encoding). As in the reference, ``to_desc`` does not record it;
    ``Program.from_desc`` reads it back from the "@ROWS" var beside.

    ``lod_level`` > 0 marks a ragged (LoD) var: a flat ``[rows, ...]``
    value with its lengths under NAME + "@LOD" (``fluid/lod.py``). The
    layers set it, as the reference's do; ``to_desc`` does not record
    it either."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 persistable=False, stop_gradient=False, is_data=False,
                 type="lod_tensor", lod_level=0):
        self.block = block
        self.name = name or unique_name.generate("_generated_var")
        self.shape = tuple(shape) if shape is not None else ()
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type
        self.lod_level = lod_level
        self.op = None  # producing op, set by append_op

    # -- operator sugar: each appends the op that the reference appends
    # (``layers/math_op_patch.py``); ``==`` stays identity --
    def _binary(self, other, op_type, reverse=False):
        from .layers import math_op_patch

        return math_op_patch.binary_op(self, other, op_type, reverse)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    def __radd__(self, other):
        return self._binary(other, "elementwise_add", True)

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    def __rmul__(self, other):
        return self._binary(other, "elementwise_mul", True)

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", True)

    def __pow__(self, other):
        return self._binary(other, "elementwise_pow")

    def __neg__(self):
        from .layers.nn import scale

        return scale(self, scale=-1.0)

    def __lt__(self, other):
        return self._binary(other, "less_than")

    def __le__(self, other):
        return self._binary(other, "less_equal")

    def __gt__(self, other):
        return self._binary(other, "greater_than")

    def __ge__(self, other):
        return self._binary(other, "greater_equal")

    @property
    def grad_name(self):
        return grad_var_name(self.name)

    def astype(self, dtype):
        from .layers.tensor import cast

        return cast(self, dtype)

    def __repr__(self):
        return "Variable(name=%s, shape=%s, dtype=%s%s)" % (
            self.name, self.shape, dtype_str(self.dtype),
            ", persistable" if self.persistable else "")

    def to_desc(self):
        return {
            "name": self.name,
            "shape": list(self.shape),
            "dtype": dtype_str(self.dtype),
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", False),
        }


class Parameter(Variable):
    """A trainable persistable Variable."""

    def __init__(self, block, shape, dtype, name=None, trainable=True,
                 learning_rate=1.0):
        super().__init__(block, name=name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=not trainable)
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": learning_rate}


GRAD_SUFFIX = "@GRAD"


def grad_var_name(name):
    return name + GRAD_SUFFIX


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _user_callsite(max_frames=3):
    """File:line of the nearest frames outside this package: the user's
    layer call site, named in op-attributed errors."""
    frames = []
    f = sys._getframe(2)
    while f is not None and len(frames) < max_frames:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG_DIR):
            frames.append("%s:%d in %s" % (fn, f.f_lineno, f.f_code.co_name))
        f = f.f_back
    return frames


class Operator:
    """One IR op: type + named input/output var lists + attrs. What it
    computes is its lowering rule in the op registry (``registry.py``)."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: _as_name_list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: _as_name_list(v)
                        for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        self.callstack = _user_callsite()

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def input_arg_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_arg_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def __repr__(self):
        return "{%s: (%s) -> (%s)}" % (
            self.type,
            ", ".join("%s=%s" % kv for kv in self.inputs.items()),
            ", ".join("%s=%s" % kv for kv in self.outputs.items()))

    def to_desc(self):
        return {
            "type": self.type,
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": {k: list(v) for k, v in self.outputs.items()},
            "attrs": _sanitize_attrs(self.attrs),
        }


# attrs of a control-flow op that name outer vars its sub-blocks hand back
# (a branch or a body may return an outer var as it is)
_NAMED_READS = ("true_outs", "false_outs", "body_out_names", "cond_out",
                "step_outputs", "mem_post")


def sub_block_ids(op):
    """The indices of the blocks ``op`` runs: its ``sub_block`` and
    ``*_block`` attrs, and a ``switch``'s ``blocks``."""
    ids = []
    for key, val in op.attrs.items():
        if key == "sub_block" or key.endswith("_block"):
            if isinstance(val, int) and not isinstance(val, bool):
                ids.append(val)
        elif key == "blocks" and isinstance(val, (list, tuple)):
            ids.extend(v for v in val if isinstance(v, int))
    return ids


def transitive_args(op):
    """(reads, writes): the names ``op`` reads and writes, its own args
    plus those of every op of its sub-blocks at any depth (the
    reference's ``_transitive_args``). Names local to a sub-block are
    among them; they never meet a parent block's names (unique-name
    generation), so a caller only ever keeps more for them."""
    reads = set(op.input_arg_names())
    writes = set(op.output_arg_names())
    blocks = op.block.program.blocks
    seen, stack = set(), [op]
    while stack:
        o = stack.pop()
        for key in _NAMED_READS:
            val = o.attrs.get(key)
            if isinstance(val, str):
                reads.add(val)
            elif isinstance(val, (list, tuple)):
                reads.update(v for v in val if isinstance(v, str))
        for idx in sub_block_ids(o):
            if 0 <= idx < len(blocks) and idx not in seen:
                seen.add(idx)
                for sub_op in blocks[idx].ops:
                    reads.update(sub_op.input_arg_names())
                    writes.update(sub_op.output_arg_names())
                    stack.append(sub_op)
    return reads, writes


def walk_ops(ops):
    """``ops`` and every op of their sub-blocks, at any depth."""
    for op in ops:
        yield op
        blocks = op.block.program.blocks
        for idx in sub_block_ids(op):
            if 0 <= idx < len(blocks):
                yield from walk_ops(blocks[idx].ops)


def _as_name_list(v):
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [_as_name(x) for x in v]
    return [_as_name(v)]


def _as_name(v):
    return v.name if isinstance(v, Variable) else str(v)


def _sanitize_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, np.generic):
            out[k] = v.item()
        elif isinstance(v, Variable):
            out[k] = v.name
        else:
            out[k] = v
    return out


class Block:
    """An ordered op list + var table."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError("Variable %r not found in block %d"
                             % (name, self.idx))
        return v

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def create_var(self, **kwargs):
        name = kwargs.get("name")
        if name and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[v.name] = v
        self.program._bump()
        return v

    def create_parameter(self, **kwargs):
        p = Parameter(self, **kwargs)
        # parameters live in the global block's var table
        self.program.global_block().vars[p.name] = p
        self.program._bump()
        return p

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        for name in op.output_arg_names():
            v = self._find_var_recursive(name)
            if v is not None and v.op is None:
                v.op = op
        self.program._bump()
        return op

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def to_desc(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_desc() for v in self.vars.values()],
            "ops": [op.to_desc() for op in self.ops],
        }


class Program:
    """A multi-block IR program. ``random_seed`` seeds the generator of
    the scope that first runs it (see ``executor.py``).

    ``_uid`` is a token no other Program shares (``id`` can be reused
    once a Program is collected) and ``_mutation`` an edit counter,
    bumped by every var or op a block adds and by rewrites that replace
    ops: the executor keys its compiled steps by both, so a program
    edited after a run is lowered and captured anew."""

    _uid_counter = itertools.count()

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._mutation = 0
        self._uid = next(Program._uid_counter)
        # set by append_backward: param name -> grad var name
        self.param_grad_map = {}

    def _bump(self):
        self._mutation += 1

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def block(self, idx):
        return self.blocks[idx]

    @property
    def num_blocks(self):
        return len(self.blocks)

    def _create_block(self, parent_idx=None):
        """A new block whose parent is ``parent_idx`` (the current block
        by default); it becomes the current block."""
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump()
        return b

    def _rollback(self):
        """Make the current block's parent the current block again."""
        self.current_block_idx = self.current_block().parent_idx

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def clone(self, for_test=False):
        """Deep copy of the IR. ``for_test=True`` switches ops with an
        ``is_test`` attr to eval mode (dropout off)."""
        p = Program.__new__(Program)
        p._uid = next(Program._uid_counter)
        p._mutation = 0
        p.random_seed = self.random_seed
        p.param_grad_map = dict(self.param_grad_map)
        p.current_block_idx = 0
        p.blocks = []
        for blk in self.blocks:
            nb = Block(p, blk.idx, blk.parent_idx)
            for v in blk.vars.values():
                nv = copy.copy(v)
                nv.block = nb
                nv.op = None
                nb.vars[nv.name] = nv
            for op in blk.ops:
                attrs = dict(op.attrs)
                if for_test and attrs.get("is_test") is False:
                    attrs["is_test"] = True
                nb.ops.append(Operator(nb, op.type, op.inputs, op.outputs,
                                       attrs))
            p.blocks.append(nb)
        return p

    def _prune(self, targets):
        """A clone in eval mode (``for_test``) that keeps only the ops
        the ``targets`` (Variables or names) need: walking the global
        block backwards, an op stays when it writes a needed name, and
        what it reads becomes needed. A control-flow op's reads and
        writes are its transitive ones (``transitive_args``), so a
        branch's reads of parent-block vars keep their producers.
        Optimizer updates and the backward drop out unless a target
        reads them. Every var and every sub-block is kept."""
        needed = set(_as_name_list(targets))
        p = self.clone(for_test=True)
        blk = p.global_block()
        kept = []
        for op in reversed(blk.ops):
            reads, writes = transitive_args(op)
            if needed & writes:
                kept.append(op)
                needed.update(reads)
        blk.ops = kept[::-1]
        return p

    def serialize_to_string(self):
        """The program's ``ProgramDesc`` protobuf bytes, as the
        reference's ``serialize_to_string`` writes them."""
        from .core import proto_io

        return proto_io.program_to_bytes(self.to_desc())

    @staticmethod
    def parse_from_string(data):
        """The Program of ``ProgramDesc`` bytes, through the load gate
        (``compat.check_program_compatible``)."""
        from .core import proto_io

        return Program.from_desc(proto_io.program_from_bytes(data))

    def to_desc(self):
        return {
            "version": PROGRAM_VERSION,
            "random_seed": self.random_seed,
            "blocks": [b.to_desc() for b in self.blocks],
            "param_grad_map": dict(self.param_grad_map),
        }

    @staticmethod
    def from_desc(desc):
        p = Program.__new__(Program)
        p._uid = next(Program._uid_counter)
        p._mutation = 0
        p.random_seed = desc.get("random_seed", 0)
        p.param_grad_map = dict(desc.get("param_grad_map", {}))
        p.current_block_idx = 0
        p.blocks = []
        for bdesc in desc["blocks"]:
            blk = Block(p, bdesc["idx"], bdesc.get("parent_idx", -1))
            for vdesc in bdesc["vars"]:
                if vdesc.get("is_parameter"):
                    v = Parameter(blk, shape=vdesc["shape"],
                                  dtype=vdesc["dtype"], name=vdesc["name"],
                                  trainable=vdesc.get("trainable", True))
                else:
                    v = Variable(
                        blk, name=vdesc["name"], shape=vdesc["shape"],
                        dtype=vdesc["dtype"],
                        persistable=vdesc.get("persistable", False),
                        stop_gradient=vdesc.get("stop_gradient", False),
                        is_data=vdesc.get("is_data", False))
                blk.vars[v.name] = v
            # the desc records no var type (as in the reference's): a var
            # beside its "@ROWS" var is a SelectedRows var
            for name, v in blk.vars.items():
                if name + "@ROWS" in blk.vars:
                    v.type = "selected_rows"
            for odesc in bdesc["ops"]:
                blk.ops.append(Operator(blk, odesc["type"], odesc["inputs"],
                                        odesc["outputs"], odesc["attrs"]))
            p.blocks.append(blk)
        return p

    def __repr__(self):
        lines = []
        for blk in self.blocks:
            lines.append("block %d (parent %d):" % (blk.idx, blk.parent_idx))
            for op in blk.ops:
                lines.append("  " + repr(op))
        return "\n".join(lines)


_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def switch_main_program(program):
    global _main_program
    old, _main_program = _main_program, program
    return old


def switch_startup_program(program):
    global _startup_program
    old, _startup_program = _startup_program, program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


class CPUPlace:
    """The host (``fluid.CPUPlace()``): where ``Executor``,
    ``dygraph.guard`` and ``resolve_device`` run when asked."""

    _device = "cpu"

    def __repr__(self):
        return "CPUPlace"


class CUDAPlace:
    """One card (``fluid.CUDAPlace(i)``)."""

    def __init__(self, device_id=0):
        self.device_id = int(device_id)
        self._device = "cuda:%d" % self.device_id

    def __repr__(self):
        return "CUDAPlace(%d)" % self.device_id


# -- the dygraph switch (set by dygraph.guard) ---------------------------------

_dygraph_tracer_ = None


def _dygraph_tracer():
    return _dygraph_tracer_


def in_dygraph_mode():
    return _dygraph_tracer_ is not None


@contextlib.contextmanager
def _dygraph_guard(tracer):
    global _dygraph_tracer_
    old = _dygraph_tracer_
    _dygraph_tracer_ = tracer
    try:
        yield
    finally:
        _dygraph_tracer_ = old
