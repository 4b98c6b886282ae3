"""LeNet-5 on MNIST, BASELINE config 1 (the port's counterpart of
``paddle_tpu/models/lenet.py``, the reference's
``tests/book/test_recognize_digits.py`` conv_net): the same layer calls
in the same order, so inside ``unique_name.guard()`` both packages build
the same program desc."""

from .. import fluid
from ..fluid import layers, optimizer


def lenet_forward(img, label=None):
    """Two 5x5 convolutions with relu and 2x2 max pooling, then three fc
    layers. Returns (logits, loss, accuracy); the last two are None
    without a label."""
    conv1 = layers.conv2d(img, num_filters=6, filter_size=5, padding=2,
                          act="relu")
    pool1 = layers.pool2d(conv1, pool_size=2, pool_stride=2)
    conv2 = layers.conv2d(pool1, num_filters=16, filter_size=5, act="relu")
    pool2 = layers.pool2d(conv2, pool_size=2, pool_stride=2)
    fc1 = layers.fc(pool2, size=120, act="relu")
    fc2 = layers.fc(fc1, size=84, act="relu")
    logits = layers.fc(fc2, size=10)
    if label is None:
        return logits, None, None
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return logits, loss, acc


def build_train_program(lr=1e-3, seed=7):
    """(main, startup, loss, accuracy): 28x28 images, int64 labels, Adam."""
    main = fluid.Program()
    startup = fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        img = layers.data(name="img", shape=[1, 28, 28], dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        _, loss, acc = lenet_forward(img, label)
        optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, acc


def build_infer_program(seed=7):
    """(main, startup, logits)."""
    main = fluid.Program()
    startup = fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        img = layers.data(name="img", shape=[1, 28, 28], dtype="float32")
        logits, _, _ = lenet_forward(img)
    return main, startup, logits
