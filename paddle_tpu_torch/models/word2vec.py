"""N-gram word2vec in PyTorch (counterpart of
``paddle_tpu/models/word2vec.py``; the PaddlePaddle book's chapter 4,
``test_word2vec.py``: four context words predict the next word through a
shared embedding, a sigmoid hidden layer and a softmax over the
vocabulary, trained on ``cross_entropy``)."""

import numpy as np

from .. import fluid
from ..fluid import layers, optimizer

__all__ = ["build_train_program", "synthetic_ngrams", "N_CONTEXT"]

N_CONTEXT = 4


def _embed(word, vocab_size, embed_size):
    return layers.embedding(
        word, size=[vocab_size, embed_size],
        param_attr=fluid.ParamAttr(name="shared_w2v_emb"))


def word2vec_forward(words, next_word, vocab_size, embed_size=32,
                     hidden_size=64):
    """words: list of N_CONTEXT [N,1] int64 vars; returns (loss, predict)."""
    embeds = [_embed(w, vocab_size, embed_size) for w in words]
    concat = layers.concat(embeds, axis=1)
    hidden = layers.fc(concat, size=hidden_size, act="sigmoid")
    predict = layers.fc(hidden, size=vocab_size, act="softmax")
    loss = layers.mean(layers.cross_entropy(predict, next_word))
    return loss, predict


def build_train_program(vocab_size=128, embed_size=32, hidden_size=64,
                        lr=1e-3, seed=11):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        words = [layers.data("w2v_ctx%d" % i, [1], dtype="int64")
                 for i in range(N_CONTEXT)]
        nxt = layers.data("w2v_next", [1], dtype="int64")
        loss, predict = word2vec_forward(words, nxt, vocab_size, embed_size,
                                         hidden_size)
        optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, predict


def synthetic_ngrams(rng, n, vocab_size=128):
    """Deterministic-language synthetic corpus: next = (first ctx + 1) %
    vocab — a learnable bigram-style rule, zero-egress replacement for the
    imikolov download."""
    ctx = rng.randint(0, vocab_size, (n, N_CONTEXT)).astype(np.int64)
    nxt = ((ctx[:, 0] + 1) % vocab_size).astype(np.int64)
    feed = {"w2v_ctx%d" % i: ctx[:, i:i + 1] for i in range(N_CONTEXT)}
    feed["w2v_next"] = nxt[:, None]
    return feed
