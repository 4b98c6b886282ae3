"""DeepFM CTR model, BASELINE config 4: the sparse-embedding workload
(the port's copy of ``paddle_tpu/models/deepfm.py``, building the same
program). The fields are a dense [B, F] id matrix, so one lookup a table
feeds every field; with ``is_sparse=True`` both tables go through the
sparse embedding engine's device tier (``embedding_lookup``), their
gradients are SelectedRows pairs and Adam updates only the rows a batch
touches. With ``residence="host"`` the second-order table lives in host
memory behind a device row cache (``embedding/host.py``).
"""

import operator

from .. import fluid
from ..fluid import layers, optimizer


def _at_least_one(name, value):
    try:
        value = operator.index(value)
    except TypeError:
        raise ValueError("DeepFMConfig.%s must be an int >= 1, got %r"
                         % (name, value))
    if value < 1:
        raise ValueError("DeepFMConfig.%s must be an int >= 1, got %r"
                         % (name, value))
    return value


class DeepFMConfig:
    def __init__(self, sparse_feature_dim=int(1e5), num_fields=26,
                 num_dense=13, embedding_size=10, fc_sizes=(400, 400, 400)):
        self.sparse_feature_dim = _at_least_one(
            "sparse_feature_dim", sparse_feature_dim)
        self.num_fields = _at_least_one("num_fields", num_fields)
        self.num_dense = _at_least_one("num_dense", num_dense)
        self.embedding_size = _at_least_one("embedding_size", embedding_size)
        self.fc_sizes = tuple(fc_sizes)

    @staticmethod
    def tiny():
        return DeepFMConfig(sparse_feature_dim=1000, num_fields=8,
                            num_dense=4, embedding_size=8, fc_sizes=(32, 32))


def deepfm_forward(sparse_ids, dense_x, label, cfg, is_sparse=True,
                   residence=None):
    """sparse_ids: [B, F] int64; dense_x: [B, D] float32; label: [B, 1].
    Returns (pred, loss). ``residence`` goes to ``layers.embedding`` for
    the second-order table ``fm_emb`` (the big one): ``"host"`` puts it
    on a registered ``HostEmbeddingTable``; the first-order table stays
    on the device tier."""
    # ---- first order: per-field scalar weights
    w1 = layers.embedding(sparse_ids, size=[cfg.sparse_feature_dim, 1],
                          is_sparse=is_sparse,
                          param_attr=fluid.ParamAttr(name="fm_w1"))  # [B,F,1]
    first = layers.reduce_sum(w1, dim=1)  # [B, 1]

    # ---- second order: 0.5 * ((sum e)^2 - sum e^2)
    emb = layers.embedding(sparse_ids,
                           size=[cfg.sparse_feature_dim, cfg.embedding_size],
                           is_sparse=is_sparse, residence=residence,
                           param_attr=fluid.ParamAttr(name="fm_emb"))  # [B,F,E]
    sum_e = layers.reduce_sum(emb, dim=1)                       # [B, E]
    sum_sq = layers.elementwise_mul(sum_e, sum_e)
    sq_sum = layers.reduce_sum(layers.elementwise_mul(emb, emb), dim=1)
    second = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum), dim=1,
                          keep_dim=True), scale=0.5)            # [B, 1]

    # ---- deep part
    deep = layers.reshape(emb, [0, cfg.num_fields * cfg.embedding_size])
    deep = layers.concat([deep, dense_x], axis=1)
    for i, sz in enumerate(cfg.fc_sizes):
        deep = layers.fc(deep, sz, act="relu", name="deep_fc%d" % i)
    deep_out = layers.fc(deep, 1, name="deep_out")

    logit = layers.elementwise_add(
        layers.elementwise_add(first, second), deep_out)
    pred = layers.sigmoid(logit)
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(
            logit, layers.cast(label, "float32")))
    return pred, loss


def build_train_program(cfg=None, lr=1e-3, is_sparse=True, seed=7,
                        residence=None):
    """(main, startup, loss, pred): DeepFM trained by Adam at ``lr``."""
    cfg = cfg or DeepFMConfig()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        sparse_ids = layers.data("sparse_ids", shape=[cfg.num_fields],
                                 dtype="int64")
        dense_x = layers.data("dense_x", shape=[cfg.num_dense],
                              dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        pred, loss = deepfm_forward(sparse_ids, dense_x, label, cfg,
                                    is_sparse=is_sparse, residence=residence)
        optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, pred


def synthetic_batch(cfg, batch, seed=0):
    """A numpy batch: in-vocabulary ids, uniform dense features, 0/1
    labels, from ``seed``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    # modulo makes in-vocab true by construction, and the assert checks it
    ids = rng.randint(0, cfg.sparse_feature_dim,
                      (batch, cfg.num_fields)) % cfg.sparse_feature_dim
    assert ids.min() >= 0 and ids.max() < cfg.sparse_feature_dim
    return {
        "sparse_ids": ids.astype("int64"),
        "dense_x": rng.rand(batch, cfg.num_dense).astype("float32"),
        "label": rng.randint(0, 2, (batch, 1)).astype("int64"),
    }
