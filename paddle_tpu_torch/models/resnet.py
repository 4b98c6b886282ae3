"""ResNet for ImageNet-style classification, BASELINE config 2 (the
port's counterpart of ``paddle_tpu/models/resnet.py``): the same layer
calls in the same order, so inside ``unique_name.guard()`` both packages
build the same program desc, at depths 18, 34, 50, 101 and 152.

``data_format`` selects the activation layout end to end. "NCHW" is the
reference's default; "NHWC" runs every convolution, batch norm and pool
on channels-last views (``fluid/ops/nn.py``): the feed stays NCHW and
one transpose at the graph's entry converts. ``build_train_program``
trains with Momentum(0.9) and L2Decay(1e-4); ``use_amp=True`` wraps it
in ``mixed_precision.decorate`` (bf16, static loss scale 1.0), as the
reference does.
"""

from .. import fluid
from ..fluid import layers, optimizer
from ..fluid.contrib import mixed_precision

_DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def _conv_bn(x, filters, ksize, stride=1, act=None, name=None, fmt="NCHW"):
    conv = layers.conv2d(
        x, num_filters=filters, filter_size=ksize, stride=stride,
        padding=(ksize - 1) // 2, bias_attr=False, data_format=fmt,
        param_attr=fluid.ParamAttr(name=name + "_w") if name else None)
    return layers.batch_norm(conv, act=act, data_layout=fmt)


def _shortcut(x, filters, stride, fmt):
    in_c = x.shape[-1] if fmt == "NHWC" else x.shape[1]
    if in_c != filters or stride != 1:
        return _conv_bn(x, filters, 1, stride, fmt=fmt)
    return x


def _basic_block(x, filters, stride, fmt):
    y = _conv_bn(x, filters, 3, stride, act="relu", fmt=fmt)
    y = _conv_bn(y, filters, 3, 1, fmt=fmt)
    return layers.relu(
        layers.elementwise_add(y, _shortcut(x, filters, stride, fmt)))


def _bottleneck_block(x, filters, stride, fmt):
    y = _conv_bn(x, filters, 1, act="relu", fmt=fmt)
    y = _conv_bn(y, filters, 3, stride, act="relu", fmt=fmt)
    y = _conv_bn(y, filters * 4, 1, fmt=fmt)
    return layers.relu(
        layers.elementwise_add(y, _shortcut(x, filters * 4, stride, fmt)))


def resnet_forward(img, label=None, depth=50, num_classes=1000,
                   data_format="NCHW"):
    """Returns (logits, loss, accuracy); the last two are None without a
    label."""
    kind, blocks = _DEPTH_CFG[depth]
    block_fn = _basic_block if kind == "basic" else _bottleneck_block
    fmt = data_format

    x = img
    if fmt == "NHWC":
        x = layers.transpose(x, [0, 2, 3, 1])   # the feed stays NCHW
    x = _conv_bn(x, 64, 7, stride=2, act="relu", fmt=fmt)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max", data_format=fmt)
    for stage, n in enumerate(blocks):
        filters = 64 * (2 ** stage)
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            x = block_fn(x, filters, stride, fmt)
    x = layers.pool2d(x, pool_type="avg", global_pooling=True,
                      data_format=fmt)
    logits = layers.fc(x, size=num_classes)
    if label is None:
        return logits, None, None
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return logits, loss, acc


def build_train_program(depth=50, num_classes=1000, image_size=224,
                        lr=0.1, momentum=0.9, seed=7, use_amp=False,
                        data_format="NCHW"):
    """(main, startup, loss, accuracy): NCHW fp32 images, int64 labels."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        img = layers.data(name="img", shape=[3, image_size, image_size],
                          dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        _, loss, acc = resnet_forward(img, label, depth, num_classes,
                                      data_format=data_format)
        opt = optimizer.Momentum(
            learning_rate=lr, momentum=momentum,
            regularization=fluid.regularizer.L2Decay(1e-4))
        if use_amp:
            opt = mixed_precision.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss, acc


def build_infer_program(depth=50, num_classes=1000, image_size=224, seed=7):
    """(main, startup, logits), NCHW."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        img = layers.data(name="img", shape=[3, image_size, image_size],
                          dtype="float32")
        logits, _, _ = resnet_forward(img, None, depth, num_classes)
    return main, startup, logits
