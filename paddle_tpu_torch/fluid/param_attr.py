"""ParamAttr: per-parameter configuration (the port's copy of
``paddle_tpu/fluid/param_attr.py``): name, initializer, learning-rate
multiplier, regularizer and trainable. Model averaging is accepted and
unused, as in the reference; the tensor-parallel ``shard`` spec raises
(multi-device, ROADMAP queue 7)."""


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False,
                 shard=None):
        if shard is not None:
            raise NotImplementedError(
                "ParamAttr(shard=...) lays a parameter out over a device "
                "mesh (Megatron tensor parallelism), which the port has not "
                "ported yet (ROADMAP queue 7)")
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average

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
