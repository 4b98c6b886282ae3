"""The CRF sequence tagger in PyTorch (counterpart of
``paddle_tpu/models/tagger.py``; the PaddlePaddle book's semantic-role
labelling chapter, ``test_label_semantic_roles.py``): word embeddings,
an fc, a ``dynamic_gru`` feature layer and an emission fc, trained by
the ``linear_chain_crf`` loss and decoded by Viterbi ``crf_decoding``.
Sentences are LoD sequences (``fluid/lod.py``)."""

import numpy as np

from .. import fluid
from ..fluid import layers, optimizer

__all__ = ["build_train_program", "build_decode_program",
           "synthetic_tagging"]

_CRF_PARAM = "tagger_crf_T"


def _features(words, vocab, emb_dim, hidden, num_tags):
    emb = layers.embedding(
        words, size=[vocab, emb_dim],
        param_attr=fluid.ParamAttr(name="tagger_emb"))
    fc1 = layers.fc(emb, size=hidden, act="tanh",
                    param_attr=fluid.ParamAttr(name="tagger_fc1_w"),
                    bias_attr=fluid.ParamAttr(name="tagger_fc1_b"))
    hidden_seq = layers.dynamic_gru(
        layers.fc(fc1, size=hidden * 3,
                  param_attr=fluid.ParamAttr(name="tagger_gru_in_w"),
                  bias_attr=fluid.ParamAttr(name="tagger_gru_in_b")),
        size=hidden,
        param_attr=fluid.ParamAttr(name="tagger_gru_w"),
        bias_attr=fluid.ParamAttr(name="tagger_gru_b"))
    return layers.fc(hidden_seq, size=num_tags,
                     param_attr=fluid.ParamAttr(name="tagger_emit_w"),
                     bias_attr=fluid.ParamAttr(name="tagger_emit_b"))


def build_train_program(vocab=64, num_tags=5, emb_dim=16, hidden=24,
                        lr=5e-3, seed=17):
    """(main, startup, loss): the mean negative CRF log-likelihood of the
    tags fed to ``tg_tags`` given the words fed to ``tg_words`` (both
    int64, lod_level 1), trained by Adam."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        words = layers.data("tg_words", [1], dtype="int64", lod_level=1)
        tags = layers.data("tg_tags", [1], dtype="int64", lod_level=1)
        emission = _features(words, vocab, emb_dim, hidden, num_tags)
        ll = layers.linear_chain_crf(
            emission, tags, param_attr=fluid.ParamAttr(name=_CRF_PARAM))
        loss = layers.mean(layers.scale(ll, scale=-1.0))
        optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


def build_decode_program(vocab=64, num_tags=5, emb_dim=16, hidden=24,
                         seed=17):
    """(main, startup, path): the Viterbi tags of ``tg_words``, on the
    training program's parameter names (run it on the trained scope)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        words = layers.data("tg_words", [1], dtype="int64", lod_level=1)
        emission = _features(words, vocab, emb_dim, hidden, num_tags)
        path = layers.crf_decoding(
            emission, param_attr=fluid.ParamAttr(name=_CRF_PARAM))
    return main, startup, path


def synthetic_tagging(rng, n, vocab=64, num_tags=5, max_len=8):
    """``n`` sentences of lengths in [3, max_len) from the numpy ``rng``,
    tagged by the rule tag = word % num_tags: (feed, lengths)."""
    lens, flat = [], []
    for _ in range(n):
        ln = int(rng.randint(3, max_len))
        flat.extend(rng.randint(0, vocab, ln).tolist())
        lens.append(ln)
    words = np.asarray(flat, np.int64)[:, None]
    tags = (words % num_tags).astype(np.int64)
    return {"tg_words": fluid.create_lod_tensor(words, [lens]),
            "tg_tags": fluid.create_lod_tensor(tags, [lens])}, lens
