"""Saving and loading variables and inference models (the port's
counterpart of the parameter and inference-model half of
``paddle_tpu/fluid/io.py``).

On disk the formats are the reference's, so either package reads what
the other wrote:

- one ``<name>.npy`` per variable, or one combined PTC1 file
  (``core/tensor_io.py``) when a ``filename`` is given;
- an inference model directory: ``__model__`` (or ``model_filename``),
  the pruned program as ``ProgramDesc`` protobuf bytes with its feed and
  fetch names (``core/proto_io.py``), beside its parameters.

Values come from and go to ``executor.global_scope()`` (the scope of the
innermost ``scope_guard``), as in the reference; loaded tensors are put
on the executor's device. Writes are atomic (temporary file, fsync,
rename).

Not ported: ``save``/``load`` of whole training states,
``CheckpointManager`` (ROADMAP queue 1 item 5), and
``save_inference_model(prelower=True)``, whose executables need the
compile cache (queue 1 item 5).
"""

import io as _io
import os

import numpy as np
import torch

from . import framework
from .executor import global_scope
from .framework import Program, Variable

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model"]


def _atomic_write_bytes(path, data):
    """Temporary file + fsync + rename: ``path`` holds either the old
    bytes or the new ones, never a prefix of the new."""
    tmp = "%s.tmp-%d" % (path, os.getpid())
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:  # leave no temporary file behind, then re-raise
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _is_persistable(var):
    return var.persistable


def _is_param(var):
    return isinstance(var, framework.Parameter)


def _selected(main_program, vars, predicate):
    main_program = main_program or framework.default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars() if predicate(v)]
    return vars


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    """Write the scope's values of ``vars`` (or of the program's vars
    that ``predicate`` accepts) to ``dirname``: one ``.npy`` each, or
    all in the PTC1 file ``filename``. Vars the scope lacks are skipped.
    A bfloat16 value needs the PTC1 file (``.npy`` has no bfloat16)."""
    vars = _selected(main_program, vars, predicate)
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    values = {v.name: scope.find_var(v.name) for v in vars
              if scope.find_var(v.name) is not None}
    if filename is not None:
        from .core import tensor_io

        tensor_io.save_combine(os.path.join(dirname, filename), values)
        return
    for name, val in values.items():
        if isinstance(val, torch.Tensor):
            if val.dtype == torch.bfloat16:
                raise TypeError("%r is bfloat16, which .npy cannot hold: "
                                "save it with filename= (PTC1)" % name)
            val = val.detach().cpu().numpy()
        buf = _io.BytesIO()
        np.save(buf, np.asarray(val))
        _atomic_write_bytes(os.path.join(dirname, name + ".npy"),
                            buf.getvalue())


def _load_combined(path):
    """A combined tensor file: PTC1, or a legacy ``.npz``."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"PTC1":
        from .core import tensor_io

        return tensor_io.load_combine(path)
    data = np.load(path, allow_pickle=False)
    return {name: data[name] for name in data.files}


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program, predicate=_is_param,
                     filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    """Read ``vars`` (or the program's vars ``predicate`` accepts) from
    ``dirname`` into the scope as tensors on ``executor.place``; a var
    with no file (or no entry in ``filename``) is left as it is."""
    vars = _selected(main_program, vars, predicate)
    scope = global_scope()
    if filename is not None:
        data = _load_combined(os.path.join(dirname, filename))
    else:
        data = {}
        for v in vars:
            path = os.path.join(dirname, v.name + ".npy")
            if os.path.exists(path):
                data[v.name] = np.load(path)
    for v in vars:
        if v.name in data:
            val = data[v.name]
            if not isinstance(val, torch.Tensor):
                val = torch.from_numpy(np.ascontiguousarray(val))
            scope.set_var(v.name, val.to(executor.place))


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program, predicate=_is_param,
                     filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False, prelower=False,
                         prelower_batch_sizes=(1,)):
    """Prune ``main_program`` to what ``target_vars`` need (in eval mode)
    and save it with the parameters it reads, in the reference's layout.
    ``export_for_deployment=False`` keeps the whole program as built;
    ``program_only=True`` writes ``__model__`` alone. Returns the fetch
    names. ``prelower=True`` (executables serialized beside the model)
    needs the compile cache, which the port does not have yet, and
    raises ``NotImplementedError``."""
    if prelower:
        raise NotImplementedError(
            "save_inference_model(prelower=True) serializes compiled "
            "executables; the port has no compile cache yet")
    main_program = main_program or framework.default_main_program()
    if export_for_deployment:
        pruned = main_program._prune(target_vars)
    else:
        pruned = main_program.clone(for_test=False)
    fetch_names = [v.name if isinstance(v, Variable) else v
                   for v in target_vars]
    os.makedirs(dirname, exist_ok=True)
    desc = pruned.to_desc()
    desc["feed_names"] = list(feeded_var_names)
    desc["fetch_names"] = fetch_names
    from .core import proto_io

    _atomic_write_bytes(os.path.join(dirname, model_filename or "__model__"),
                        proto_io.program_to_bytes(desc))
    if not program_only:
        # only the persistables the pruned program still reads
        needed = {n for blk in pruned.blocks for op in blk.ops
                  for n in op.input_arg_names()}
        vars = [v for v in main_program.list_vars()
                if v.persistable and v.name in needed]
        save_vars(executor, dirname, main_program, vars=vars,
                  filename=params_filename)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Load a saved inference model: its program (through the load gate,
    ``compat.check_program_compatible``) and its persistables into the
    scope. Returns (program, feed names, fetch Variables)."""
    from .core import proto_io

    with open(os.path.join(dirname, model_filename or "__model__"),
              "rb") as f:
        desc = proto_io.program_from_bytes(f.read())
    program = Program.from_desc(desc)
    load_vars(executor, dirname, program, predicate=_is_persistable,
              filename=params_filename)
    fetch_vars = [program.global_block().var(n)
                  for n in desc.get("fetch_names", [])]
    return program, list(desc.get("feed_names", [])), fetch_vars
