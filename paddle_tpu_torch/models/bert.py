"""BERT/ERNIE-style transformer encoder for masked-LM pretraining, built
as a static-graph Program (BASELINE config 3).

The port's counterpart of ``paddle_tpu/models/bert.py``: the same layer
calls in the same order, so inside ``unique_name.guard()`` both packages
build the same program desc (op types, slots, attrs, var names, shapes
and dtypes), and a desc built by either runs in the other.

``_mha`` keeps the reference's ``use_fused_attention="auto"`` rule: from
S >= 256 it emits one ``fused_multihead_attention`` op per layer (the
fused CUDA kernels on the card, at any S: set ``BertConfig.max_seq`` to
the sequence length for long-context runs, such as S 8192), below that
the einsum chain. The 256 threshold was measured on a TPU (v5e).
``use_fused_attention="packed"`` emits one
``fused_multihead_attention_packed`` op per layer on the projections'
[B, S, H*d] outputs, with no head split or merge in the program.
``use_amp=True`` wraps Adam in ``mixed_precision.decorate`` (bf16,
static loss scale 1.0), as the reference does. Not ported yet:
tensor-parallel layouts (the reference's ``tp_axis``).

The port's own additions: ``build_pretrain_program(py_reader_batch=B)``
takes its batches from a ``layers.py_reader`` of static batch B
(``main.py_reader``; one tuple a batch in ``PRETRAIN_FEEDS`` order,
``reader_batch``) instead of ``layers.data`` feeds, the layer calls
otherwise the same; ``recompute=True`` trains through
``RecomputeOptimizer`` with each encoder layer's output as a checkpoint
(``bert_encoder(layer_outputs=)``).
"""

import copy
import math

import numpy as np

from .. import fluid
from ..fluid import layers, optimizer
from ..fluid.contrib import mixed_precision


class BertConfig:
    def __init__(self, vocab_size=30522, hidden=768, n_layers=12, n_heads=12,
                 ffn_hidden=3072, max_seq=512, type_vocab=2,
                 hidden_dropout=0.1, attn_dropout=0.1):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.ffn_hidden = ffn_hidden
        self.max_seq = max_seq
        self.type_vocab = type_vocab
        self.hidden_dropout = hidden_dropout
        self.attn_dropout = attn_dropout

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny():
        return BertConfig(vocab_size=1024, hidden=64, n_layers=2, n_heads=4,
                          ffn_hidden=128, max_seq=64)


def _mha(x, attn_bias, cfg, prefix):
    h, n_heads = cfg.hidden, cfg.n_heads
    d = h // n_heads
    q = layers.fc(x, h, num_flatten_dims=2, name=prefix + "_q")
    k = layers.fc(x, h, num_flatten_dims=2, name=prefix + "_k")
    v = layers.fc(x, h, num_flatten_dims=2, name=prefix + "_v")

    seq = x.shape[1]
    use_fused = getattr(cfg, "use_fused_attention", "auto")
    if use_fused == "auto":
        # the reference's rule, measured on a TPU (v5e): the einsum chain
        # below S = 256, the fused kernel from there on
        use_fused = seq >= 256
    if use_fused == "packed":
        # q, k, v stay in the projections' [B, S, H*d] layout end to end
        ctx = layers.fused_attention_packed(
            q, k, v, n_heads, attn_bias,
            dropout_prob=cfg.attn_dropout or 0.0)
    elif use_fused:
        def split_heads(t):
            t = layers.reshape(t, [0, 0, n_heads, d])
            return layers.transpose(t, [0, 2, 1, 3])  # [B, nH, S, d]

        ctx = layers.fused_attention(
            split_heads(q), split_heads(k), split_heads(v), attn_bias,
            dropout_prob=cfg.attn_dropout or 0.0)
        ctx = layers.reshape(layers.transpose(ctx, [0, 2, 1, 3]), [0, 0, h])
    else:
        q4 = layers.reshape(q, [0, 0, n_heads, d])
        k4 = layers.reshape(k, [0, 0, n_heads, d])
        v4 = layers.reshape(v, [0, 0, n_heads, d])
        scores = layers.scale(layers.einsum("bqhd,bkhd->bhqk", q4, k4),
                              scale=1.0 / math.sqrt(d))
        scores = layers.elementwise_add(scores, attn_bias)
        weights = layers.softmax(scores)
        if cfg.attn_dropout:
            weights = layers.dropout(
                weights, cfg.attn_dropout,
                dropout_implementation="upscale_in_train")
        ctx = layers.reshape(layers.einsum("bhqk,bkhd->bqhd", weights, v4),
                             [0, 0, h])
    return layers.fc(ctx, h, num_flatten_dims=2, name=prefix + "_out")


def _encoder_layer(x, attn_bias, cfg, prefix):
    attn = _mha(x, attn_bias, cfg, prefix + "_attn")
    if cfg.hidden_dropout:
        attn = layers.dropout(attn, cfg.hidden_dropout,
                              dropout_implementation="upscale_in_train")
    x = layers.layer_norm(layers.elementwise_add(x, attn), begin_norm_axis=2)
    ffn = layers.fc(x, cfg.ffn_hidden, num_flatten_dims=2, act="gelu",
                    name=prefix + "_ffn1")
    ffn = layers.fc(ffn, cfg.hidden, num_flatten_dims=2,
                    name=prefix + "_ffn2")
    if cfg.hidden_dropout:
        ffn = layers.dropout(ffn, cfg.hidden_dropout,
                             dropout_implementation="upscale_in_train")
    return layers.layer_norm(layers.elementwise_add(x, ffn),
                             begin_norm_axis=2)


def bert_encoder(src_ids, pos_ids, sent_ids, input_mask, cfg,
                 layer_outputs=None):
    """input_mask: [B, S, 1] float (1 = token, 0 = pad). Returns [B, S, H].
    ``layer_outputs``, a list, gets each encoder layer's output var (its
    second ``layer_norm``'s: recompute's checkpoints)."""
    if src_ids.shape[-1] > cfg.max_seq:
        raise ValueError("seq_len %d exceeds cfg.max_seq %d: positions past "
                         "it have no position embedding"
                         % (src_ids.shape[-1], cfg.max_seq))
    emb = layers.embedding(src_ids, size=[cfg.vocab_size, cfg.hidden],
                           param_attr=fluid.ParamAttr(name="word_emb"))
    emb = layers.elementwise_add(
        emb, layers.embedding(pos_ids, size=[cfg.max_seq, cfg.hidden],
                              param_attr=fluid.ParamAttr(name="pos_emb")))
    emb = layers.elementwise_add(
        emb, layers.embedding(sent_ids, size=[cfg.type_vocab, cfg.hidden],
                              param_attr=fluid.ParamAttr(name="sent_emb")))
    x = layers.layer_norm(emb, begin_norm_axis=2)
    if cfg.hidden_dropout:
        x = layers.dropout(x, cfg.hidden_dropout,
                           dropout_implementation="upscale_in_train")

    # additive attention bias [B, 1, 1, S]: 0 keep, -1e4 mask
    mask = layers.transpose(input_mask, [0, 2, 1])  # [B, 1, S]
    bias = layers.scale(mask, scale=1e4, bias=-1e4)
    attn_bias = layers.unsqueeze(bias, axes=[1])

    for i in range(cfg.n_layers):
        x = _encoder_layer(x, attn_bias, cfg, "layer_%d" % i)
        if layer_outputs is not None:
            layer_outputs.append(x)
    return x


def _mlm_logits(x2d, cfg):
    """Vocab projection of the MLM head, by default TIED to the word
    embedding table (matmul against it, transpose_y) plus a bias;
    ``cfg.tie_mlm_decoder=False`` gives an untied fc."""
    if getattr(cfg, "tie_mlm_decoder", True):
        name = getattr(cfg, "embedding_param_name", "word_emb")
        try:
            table = fluid.default_main_program().global_block().var(name)
        except ValueError:
            # head built without bert_encoder in this program
            table = None
        if table is not None:
            logits = layers.matmul(x2d, table, transpose_y=True)
            bias = layers.create_parameter(
                [cfg.vocab_size], "float32", name="mlm_out_bias",
                default_initializer=fluid.initializer.Constant(0.0))
            return layers.elementwise_add(logits, bias)
    return layers.fc(x2d, cfg.vocab_size, name="mlm_logits")


def _weighted_mean(ce, w):
    num = layers.reduce_sum(layers.elementwise_mul(ce, w))
    den = layers.reduce_sum(w)
    return layers.elementwise_div(
        num, layers.elementwise_add(den, layers.fill_constant([1], "float32",
                                                              1e-6)))


def mlm_loss(enc, mask_label, mask_weight, cfg):
    """Masked-LM loss over all positions, weighted by mask_weight
    [B, S, 1] (1 on masked positions)."""
    x = layers.fc(enc, cfg.hidden, num_flatten_dims=2, act="gelu",
                  name="mlm_transform")
    x = layers.layer_norm(x, begin_norm_axis=2)
    b, s = enc.shape[0], enc.shape[1]
    logits = layers.reshape(
        _mlm_logits(layers.reshape(x, [-1, cfg.hidden]), cfg),
        [b, s, cfg.vocab_size])
    ce = layers.softmax_with_cross_entropy(logits, mask_label)  # [B, S, 1]
    return _weighted_mean(ce, mask_weight)


def mlm_loss_masked(enc, mask_pos, mask_label, mask_weight, cfg):
    """Masked-LM loss over GATHERED masked positions only (``mask_pos``
    flat indices into [B*S, H]): the vocab projection runs on B*P rows
    instead of B*S; padding slots carry weight 0."""
    h = cfg.hidden
    flat = layers.reshape(enc, [-1, h])                        # [B*S, H]
    sel = layers.gather(flat, layers.reshape(mask_pos, [-1]))  # [B*P, H]
    x = layers.fc(sel, h, act="gelu", name="mlm_transform")
    x = layers.layer_norm(x, begin_norm_axis=1)
    logits = _mlm_logits(x, cfg)
    ce = layers.softmax_with_cross_entropy(
        logits, layers.reshape(mask_label, [-1, 1]))           # [B*P, 1]
    w = layers.reshape(mask_weight, [-1, 1])
    return _weighted_mean(ce, w)


def max_predictions(seq_len):
    """Standard BERT budget: 15% of positions, at least 1."""
    return max(1, int(seq_len * 0.15))


def _feeds(seq_len):
    return (layers.data("src_ids", shape=[seq_len], dtype="int64"),
            layers.data("pos_ids", shape=[seq_len], dtype="int64"),
            layers.data("sent_ids", shape=[seq_len], dtype="int64"),
            layers.data("input_mask", shape=[seq_len, 1], dtype="float32"))


PRETRAIN_FEEDS = ("src_ids", "pos_ids", "sent_ids", "input_mask",
                  "mask_pos", "mask_label", "mask_weight")


def _reader_feeds(seq_len, batch, masked_gather):
    """A py_reader of static batch ``batch`` whose slots stand for the
    data feeds, in ``PRETRAIN_FEEDS`` order: (reader, slot vars)."""
    n = max_predictions(seq_len)
    tail = ([batch, n], [batch, n], [batch, n]) if masked_gather else \
        ([batch, seq_len, 1], [batch, seq_len, 1])
    shapes = [[batch, seq_len]] * 3 + [[batch, seq_len, 1]] + list(tail)
    dtypes = ["int64"] * 3 + ["float32"] + (
        ["int64", "int64", "float32"] if masked_gather
        else ["int64", "float32"])
    reader = layers.py_reader(capacity=2, shapes=shapes, dtypes=dtypes,
                              name="bert_reader")
    return reader, layers.read_file(reader)


def reader_batch(feed, masked_gather=True):
    """A ``synthetic_batch`` feed as one py_reader batch (a tuple in
    ``PRETRAIN_FEEDS`` order)."""
    names = PRETRAIN_FEEDS if masked_gather else PRETRAIN_FEEDS[:4] + (
        "mask_label", "mask_weight")
    return tuple(feed[n] for n in names)


def build_pretrain_program(cfg=None, seq_len=128, lr=1e-4, seed=7,
                           use_amp=False, masked_gather=True,
                           py_reader_batch=None, recompute=False):
    """(main, startup, loss) of MLM pretraining with Adam; ``use_amp``
    trains in bf16 mixed precision. ``py_reader_batch``: feed from a
    py_reader (``main.py_reader``) of that static batch;
    ``recompute``: recompute each encoder layer in the backward (module
    docstring)."""
    cfg = cfg or BertConfig.base()
    n_pred = max_predictions(seq_len)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        if py_reader_batch:
            main.py_reader, slots = _reader_feeds(
                seq_len, int(py_reader_batch), masked_gather)
            feeds, heads = slots[:4], slots[4:]
        else:
            feeds = _feeds(seq_len)
        layer_outputs = []
        enc = bert_encoder(*feeds, cfg, layer_outputs=layer_outputs)
        if masked_gather:
            if not py_reader_batch:
                heads = (
                    layers.data("mask_pos", shape=[n_pred], dtype="int64"),
                    layers.data("mask_label", shape=[n_pred],
                                dtype="int64"),
                    layers.data("mask_weight", shape=[n_pred],
                                dtype="float32"))
            loss = mlm_loss_masked(enc, *heads, cfg)
        else:
            if not py_reader_batch:
                heads = (
                    layers.data("mask_label", shape=[seq_len, 1],
                                dtype="int64"),
                    layers.data("mask_weight", shape=[seq_len, 1],
                                dtype="float32"))
            loss = mlm_loss(enc, *heads, cfg)
        opt = optimizer.Adam(learning_rate=lr)
        if recompute:
            opt = optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(layer_outputs)
        if use_amp:
            opt = mixed_precision.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def build_encoder_program(cfg=None, seq_len=128, seed=7):
    """Inference-mode encoder: dropout disabled so the forward is
    deterministic."""
    cfg = copy.copy(cfg or BertConfig.base())
    cfg.hidden_dropout = 0.0
    cfg.attn_dropout = 0.0
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        enc = bert_encoder(*_feeds(seq_len), cfg)
    return main, startup, enc


def synthetic_batch(cfg, batch, seq_len, seed=0, masked_gather=True):
    """A feed dict of random tokens and masked positions from ``seed``
    (numpy; the same arrays as the reference's)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, cfg.vocab_size, (batch, seq_len)).astype("int64")
    pos = np.tile(np.arange(seq_len, dtype="int64"), (batch, 1))
    sent = np.zeros((batch, seq_len), "int64")
    imask = np.ones((batch, seq_len, 1), "float32")
    feed = {"src_ids": src, "pos_ids": pos, "sent_ids": sent,
            "input_mask": imask}
    if masked_gather:
        n_pred = max_predictions(seq_len)
        # flat indices into [B*S]: row b picks n_pred distinct positions
        local = np.stack([rng.choice(seq_len, n_pred, replace=False)
                          for _ in range(batch)])
        feed["mask_pos"] = (local + np.arange(batch)[:, None] *
                            seq_len).astype("int64")
        feed["mask_label"] = rng.randint(
            0, cfg.vocab_size, (batch, n_pred)).astype("int64")
        feed["mask_weight"] = np.ones((batch, n_pred), "float32")
    else:
        feed["mask_label"] = rng.randint(
            0, cfg.vocab_size, (batch, seq_len, 1)).astype("int64")
        feed["mask_weight"] = (rng.rand(batch, seq_len, 1) <
                               0.15).astype("float32")
    return feed
