"""Eager layers (``paddle_tpu/fluid/dygraph`` counterparts) as
``torch.nn.Module``s."""
