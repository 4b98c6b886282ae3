"""Layer containers: the port's copy of
``paddle_tpu/fluid/dygraph/container.py`` (reference
``dygraph/container.py:20``)."""

from .layers import Layer

__all__ = ["Sequential"]


class Sequential(Layer):
    """Chains sub-layers in construction order: ``Sequential(l1, l2)``
    or ``Sequential(("a", l1), ("b", l2))``. The reference requires a
    leading ``name_scope`` string; it is accepted optionally here (the
    2.x signature dropped it)."""

    def __init__(self, *layers):
        name_scope = None
        if layers and isinstance(layers[0], str):
            name_scope, layers = layers[0], layers[1:]
        super().__init__(name_scope)
        if layers and isinstance(layers[0], (tuple, list)):
            for name, layer in layers:
                self.add_sublayer(str(name), layer)
        else:
            for idx, layer in enumerate(layers):
                self.add_sublayer(str(idx), layer)

    def forward(self, input):
        for layer in self._modules.values():
            input = layer(input)
        return input

    def __getitem__(self, name):
        return self._modules[str(name)]

    def __setitem__(self, name, layer):
        if not isinstance(layer, Layer):
            raise TypeError("Sequential holds Layers, got %r" % (layer,))
        self.add_sublayer(str(name), layer)

    def __delitem__(self, name):
        del self._modules[str(name)]

    def __len__(self):
        return len(self._modules)
