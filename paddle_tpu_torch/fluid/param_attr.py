"""ParamAttr: per-parameter configuration (the port's copy of
``paddle_tpu/fluid/param_attr.py`` without regularizers, model averaging
and the tensor-parallel ``shard`` spec, which wait for later slices)."""


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 trainable=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.trainable = trainable

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        # an Initializer instance
        return ParamAttr(initializer=arg)
