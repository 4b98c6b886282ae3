"""LayerHelper: what the layer functions share: parameter creation (with
its init op in the startup program), output var creation, activations
and shape inference of each appended op. The port's copy of
``paddle_tpu/fluid/layer_helper.py``."""

from . import framework, initializer, unique_name
from .framework import default_main_program, default_startup_program
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name_prefix = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if default_initializer is None:
            default_initializer = (initializer.Constant(0.0) if is_bias
                                   else initializer.Xavier())
        init = attr.initializer or default_initializer
        name = attr.name or unique_name.generate(
            self.name_prefix + (".b" if is_bias else ".w"))
        shape = [int(s) for s in shape]
        param = self.block.create_parameter(
            shape=shape, dtype=dtype, name=name, trainable=attr.trainable,
            learning_rate=attr.learning_rate)
        param.regularizer = attr.regularizer
        # mirror the parameter and its init op into the startup program
        startup_block = self.startup_program.global_block()
        sp = framework.Parameter(startup_block, shape=shape, dtype=dtype,
                                 name=name, trainable=attr.trainable)
        startup_block.vars[sp.name] = sp
        init(sp, startup_block)
        return param

    def create_variable_for_type_inference(self, dtype="float32",
                                           stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(self.name_prefix + ".tmp"), shape=(),
            dtype=dtype, stop_gradient=stop_gradient)

    def append_op(self, **kwargs):
        op = self.block.append_op(kwargs["type"], inputs=kwargs.get("inputs"),
                                  outputs=kwargs.get("outputs"),
                                  attrs=kwargs.get("attrs"))
        self._infer_shapes(op)
        return op

    def _infer_shapes(self, op):
        """Static shapes by running the op's lowering on meta tensors.
        As in the reference, shapes are advisory: an op the rule cannot
        run abstractly keeps the shapes it had, and execution uses the
        real ones."""
        from .shape_inference import infer_op_shapes

        try:
            infer_op_shapes(op)
        except Exception:  # noqa: BLE001 — advisory, as in the reference
            pass

    def append_activation(self, out_var, act=None):
        act = act or self.kwargs.get("act")
        if act is None:
            return out_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(out_var.dtype)
        self.append_op(type=act_type, inputs={"X": [out_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp
