"""VGG16 with batch norm and dropout in PyTorch (counterpart of
``paddle_tpu/models/vgg.py``; the PaddlePaddle book's chapter 3,
``test_image_classification.py``'s ``vgg_bn_drop``, the CIFAR-10
configuration). ``width_mult`` slims every convolution stack for small
CPU tests; 1.0 is the book's network."""

import numpy as np

from .. import fluid
from ..fluid import layers, optimizer

__all__ = ["vgg16_bn_drop", "build_train_program", "synthetic_cifar"]


def vgg16_bn_drop(input, class_dim=10, width_mult=1.0):
    from ..fluid import nets

    def conv_block(ipt, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input=ipt, pool_size=2, pool_stride=2,
            conv_num_filter=[max(8, int(num_filter * width_mult))] * groups,
            conv_filter_size=3, conv_act="relu",
            conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts,
            pool_type="max")

    conv1 = conv_block(input, 64, 2, [0.3, 0.0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0.0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0.0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0.0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0.0])

    drop = layers.dropout(conv5, dropout_prob=0.5)
    fc_dim = max(16, int(512 * width_mult))
    fc1 = layers.fc(drop, size=fc_dim, act=None)
    bn = layers.batch_norm(fc1, act="relu")
    drop2 = layers.dropout(bn, dropout_prob=0.5)
    fc2 = layers.fc(drop2, size=fc_dim, act=None)
    predict = layers.fc(fc2, size=class_dim, act="softmax")
    return predict


def build_train_program(class_dim=10, image_shape=(3, 32, 32), lr=1e-3,
                        width_mult=1.0, seed=5):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        img = layers.data("vgg_img", list(image_shape), dtype="float32")
        label = layers.data("vgg_label", [1], dtype="int64")
        predict = vgg16_bn_drop(img, class_dim, width_mult)
        loss = layers.mean(layers.cross_entropy(predict, label))
        acc = layers.accuracy(predict, label)
        optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, acc


def synthetic_cifar(rng, n, class_dim=10, image_shape=(3, 32, 32)):
    """Class-separable images: class k brightens channel-0 band k."""
    labels = rng.randint(0, class_dim, (n, 1)).astype(np.int64)
    imgs = rng.rand(n, *image_shape).astype(np.float32) * 0.1
    band = image_shape[1] // class_dim
    for i, k in enumerate(labels[:, 0]):
        imgs[i, 0, k * band:(k + 1) * band or None, :] += 1.0
    return {"vgg_img": imgs, "vgg_label": labels}
