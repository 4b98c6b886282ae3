"""The MovieLens recommender in PyTorch (counterpart of
``paddle_tpu/models/recommender.py``; the PaddlePaddle book's
``test_recommender_system.py``): a user tower (id, gender, age, job
embeddings through fcs) and a movie tower (id embedding; the category
ids' embeddings sum-pooled; the title words through
``nets.sequence_conv_pool``), each fused by a 200-wide tanh fc, scored by
``cos_sim`` x 5 against the rating with a mean squared error, trained by
SGD. The categories and the title are LoD sequences."""

import numpy as np

from .. import fluid
from ..fluid import layers, nets, optimizer

__all__ = ["USR_VOCAB", "MOV_VOCAB", "JOB_VOCAB", "AGE_VOCAB", "CAT_VOCAB",
           "TITLE_VOCAB", "user_tower", "movie_tower", "build_train_program",
           "synthetic_batch"]

USR_VOCAB = 6041      # movielens max_user_id + 1
MOV_VOCAB = 3953      # movielens max_movie_id + 1
JOB_VOCAB = 21
AGE_VOCAB = 7
CAT_VOCAB = 19
TITLE_VOCAB = 5175


def user_tower():
    """(the user's 200-wide feature, its data vars)."""
    uid = layers.data("user_id", [1], dtype="int64")
    gender = layers.data("gender_id", [1], dtype="int64")
    age = layers.data("age_id", [1], dtype="int64")
    job = layers.data("job_id", [1], dtype="int64")

    def emb_fc(x, vocab, dim, size):
        e = layers.embedding(x, size=[vocab, dim], is_sparse=False)
        e = layers.reshape(e, [-1, dim])
        return layers.fc(e, size)

    feats = [emb_fc(uid, USR_VOCAB, 32, 32),
             emb_fc(gender, 2, 16, 16),
             emb_fc(age, AGE_VOCAB, 16, 16),
             emb_fc(job, JOB_VOCAB, 16, 16)]
    combined = layers.fc(layers.concat(feats, axis=1), 200, act="tanh")
    return combined, [uid, gender, age, job]


def movie_tower():
    """(the movie's 200-wide feature, its data vars)."""
    mid = layers.data("movie_id", [1], dtype="int64")
    cats = layers.data("category_id", [1], dtype="int64", lod_level=1)
    title = layers.data("movie_title", [1], dtype="int64", lod_level=1)

    m = layers.embedding(mid, size=[MOV_VOCAB, 32], is_sparse=False)
    m = layers.fc(layers.reshape(m, [-1, 32]), 32)

    ce = layers.embedding(cats, size=[CAT_VOCAB, 32], is_sparse=False)
    c = layers.sequence_pool(ce, "sum")

    te = layers.embedding(title, size=[TITLE_VOCAB, 32], is_sparse=False)
    t = nets.sequence_conv_pool(te, num_filters=32, filter_size=3,
                                act="tanh", pool_type="sum")

    combined = layers.fc(layers.concat([m, c, t], axis=1), 200,
                         act="tanh")
    return combined, [mid, cats, title]


def build_train_program(lr=0.2):
    """(main, startup, loss, feed names): the mean squared error of
    5 cos_sim(user, movie) against the rating fed to ``score``."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 90
    with fluid.program_guard(main, startup):
        usr, usr_vars = user_tower()
        mov, mov_vars = movie_tower()
        score = layers.cos_sim(usr, mov)
        scaled = layers.scale(score, scale=5.0)
        label = layers.data("score", [1], dtype="float32")
        loss = layers.reduce_mean(
            layers.square_error_cost(scaled, label))
        optimizer.SGD(learning_rate=lr).minimize(loss)
    feeds = [v.name for v in usr_vars + mov_vars] + ["score"]
    return main, startup, loss, feeds


def synthetic_batch(batch, rng=None, title_maxlen=4, cat_maxlen=3):
    """A feed of ``batch`` MovieLens-shaped rows from the numpy ``rng``:
    ids in each vocabulary, 1 to ``cat_maxlen`` categories and 1 to
    ``title_maxlen`` title words a film (LoDTensors), ratings 1-5."""
    rng = rng or np.random.RandomState(0)

    def ragged(vocab, maxlen):
        lens = rng.randint(1, maxlen + 1, batch)
        flat = rng.randint(0, vocab, int(lens.sum()))
        return fluid.create_lod_tensor(
            flat.astype(np.int64).reshape(-1, 1), [list(map(int, lens))])

    return {
        "user_id": rng.randint(0, USR_VOCAB, (batch, 1)).astype(np.int64),
        "gender_id": rng.randint(0, 2, (batch, 1)).astype(np.int64),
        "age_id": rng.randint(0, AGE_VOCAB, (batch, 1)).astype(np.int64),
        "job_id": rng.randint(0, JOB_VOCAB, (batch, 1)).astype(np.int64),
        "movie_id": rng.randint(0, MOV_VOCAB, (batch, 1)).astype(np.int64),
        "category_id": ragged(CAT_VOCAB, cat_maxlen),
        "movie_title": ragged(TITLE_VOCAB, title_maxlen),
        "score": rng.randint(1, 6, (batch, 1)).astype(np.float32),
    }
