"""Sentiment classification over variable-length text in PyTorch
(counterpart of ``paddle_tpu/models/sentiment.py``; the PaddlePaddle
book's chapter 6, ``test_understand_sentiment.py``: the convolution
net and the stacked-LSTM net). Reviews are LoD sequences of word ids
(``fluid/lod.py``), so a batch of any lengths runs at one static shape
a row bound and a time bound."""

import numpy as np

from .. import fluid
from ..fluid import layers, nets, optimizer

__all__ = ["conv_net", "stacked_lstm_net", "build_train_program",
           "synthetic_reviews"]


def conv_net(data, label, input_dim, class_dim=2, emb_dim=32, hid_dim=32):
    """The book's ``convolution_net``: two sequence-conv + pool towers
    (windows 3 and 4, tanh, sqrt pooling), a softmax fc over both."""
    emb = layers.embedding(data, size=[input_dim, emb_dim], is_sparse=False)
    conv3 = nets.sequence_conv_pool(emb, num_filters=hid_dim, filter_size=3,
                                    act="tanh", pool_type="sqrt")
    conv4 = nets.sequence_conv_pool(emb, num_filters=hid_dim, filter_size=4,
                                    act="tanh", pool_type="sqrt")
    predict = layers.fc([conv3, conv4], size=class_dim, act="softmax")
    loss = layers.mean(layers.cross_entropy(predict, label))
    acc = layers.accuracy(predict, label)
    return loss, acc, predict


def stacked_lstm_net(data, label, input_dim, class_dim=2, emb_dim=32,
                     hid_dim=32, stacked_num=3):
    """The book's ``stacked_lstm_net``: an fc + ``dynamic_lstm`` ladder
    whose direction alternates with depth, max-pooled over time."""
    emb = layers.embedding(data, size=[input_dim, emb_dim], is_sparse=False)
    fc1 = layers.fc(emb, size=hid_dim)
    lstm1, _ = layers.dynamic_lstm(fc1, size=hid_dim)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(inputs, size=hid_dim)
        lstm, _ = layers.dynamic_lstm(fc, size=hid_dim,
                                      is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(inputs[1], pool_type="max")
    predict = layers.fc([fc_last, lstm_last], size=class_dim, act="softmax")
    loss = layers.mean(layers.cross_entropy(predict, label))
    acc = layers.accuracy(predict, label)
    return loss, acc, predict


def build_train_program(net="conv", input_dim=256, lr=1e-3, seed=3):
    """(main, startup, loss, acc) of ``net`` ("conv" or "lstm") over
    reviews fed to ``snt_words`` (int64, lod_level 1) with labels in
    ``snt_label``, trained by Adam."""
    builder = conv_net if net == "conv" else stacked_lstm_net
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        data = layers.data("snt_words", [1], dtype="int64", lod_level=1)
        label = layers.data("snt_label", [1], dtype="int64")
        loss, acc, predict = builder(data, label, input_dim)
        optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, acc


def synthetic_reviews(rng, n, input_dim=256, max_len=12):
    """Separable synthetic text from numpy ``rng``: positive reviews
    draw words from the top half of the vocabulary, negative ones from
    the bottom half, lengths in [4, max_len)."""
    labels = rng.randint(0, 2, n).astype(np.int64)
    lens, flat = [], []
    for y in labels:
        ln = int(rng.randint(4, max_len))
        lo, hi = (input_dim // 2, input_dim) if y else (0, input_dim // 2)
        flat.extend(rng.randint(lo, hi, ln).tolist())
        lens.append(ln)
    words = np.asarray(flat, np.int64)[:, None]
    return {"snt_words": fluid.create_lod_tensor(words, [lens]),
            "snt_label": labels[:, None]}
