"""Encoder-decoder NMT with beam-search inference, in PyTorch (counterpart
of ``paddle_tpu/models/seq2seq.py``; the PaddlePaddle book's chapter 8,
``test_machine_translation.py``: a GRU seq2seq trained with teacher
forcing and decoded with beam search).

Fixed-length padded sequences (static shapes), ``layers.rnn`` unrolled
over a GRUCell whose parameters every step shares, and the
``BeamSearchDecoder`` / ``dynamic_decode`` loop for inference. The
programs, parameter names and synthetic data are the reference's, so
its scope copies across (``fluid.copy_scope``). On the card the training
step and the whole decode loop each run as one CUDA graph."""

import numpy as np

from .. import fluid
from ..fluid import layers, optimizer

__all__ = ["build_train_program", "build_infer_program",
           "build_encoder_program", "build_decode_program",
           "run_split_infer", "synthetic_pairs"]


def _encoder(src, vocab_size, emb_dim, hidden):
    emb = layers.embedding(
        src, size=[vocab_size, emb_dim],
        param_attr=fluid.ParamAttr(name="s2s_src_emb"))
    cell = layers.GRUCell(hidden_size=hidden, name="s2s_enc")
    outs, final = layers.rnn(cell, emb)
    return final


def _decoder_cell(hidden):
    return layers.GRUCell(hidden_size=hidden, name="s2s_dec")


def _tgt_embedding(vocab_size, emb_dim):
    def embed(ids):
        return layers.embedding(
            ids, size=[vocab_size, emb_dim],
            param_attr=fluid.ParamAttr(name="s2s_tgt_emb"))
    return embed


def _output_fn(vocab_size):
    def out(h):
        return layers.fc(h, size=vocab_size,
                         param_attr=fluid.ParamAttr(name="s2s_proj_w"),
                         bias_attr=fluid.ParamAttr(name="s2s_proj_b"))
    return out


def build_train_program(src_vocab=32, tgt_vocab=32, emb_dim=16, hidden=32,
                        src_len=6, tgt_len=6, lr=5e-3, seed=9):
    """Teacher forcing: decoder consumes <go>+target[:-1], predicts
    target."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        src = layers.data("s2s_src", [src_len], dtype="int64")
        tgt_in = layers.data("s2s_tgt_in", [tgt_len], dtype="int64")
        tgt_out = layers.data("s2s_tgt_out", [tgt_len, 1], dtype="int64")
        enc_final = _encoder(src, src_vocab, emb_dim, hidden)
        dec_cell = _decoder_cell(hidden)
        dec_emb = _tgt_embedding(tgt_vocab, emb_dim)(tgt_in)
        dec_outs, _ = layers.rnn(dec_cell, dec_emb,
                                 initial_states=enc_final)
        # flatten timesteps so the shared 2-D output projection applies
        flat = layers.reshape(dec_outs, [-1, hidden])
        logits = _output_fn(tgt_vocab)(flat)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            logits, layers.reshape(tgt_out, [-1, 1])))
        optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


def build_infer_program(src_vocab=32, tgt_vocab=32, emb_dim=16, hidden=32,
                        src_len=6, max_tgt_len=6, beam_size=4, go_id=0,
                        end_id=1, seed=9):
    """Beam-search decode sharing the training parameter names."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        src = layers.data("s2s_src", [src_len], dtype="int64")
        enc_final = _encoder(src, src_vocab, emb_dim, hidden)
        dec_cell = _decoder_cell(hidden)
        decoder = layers.BeamSearchDecoder(
            dec_cell, start_token=go_id, end_token=end_id,
            beam_size=beam_size,
            embedding_fn=_tgt_embedding(tgt_vocab, emb_dim),
            output_fn=_output_fn(tgt_vocab))
        # decode FROM the encoder's final state (get_initial_states would
        # start from zeros — the classic silent seq2seq bug)
        final, _ = layers.dynamic_decode(decoder, inits=enc_final,
                                         max_step_num=max_tgt_len)
    return main, startup, final["sequences"]


def build_encoder_program(src_vocab=32, emb_dim=16, hidden=32, src_len=6,
                          seed=9):
    """Encoder-only half of the split inference pipeline: source in,
    final encoder state out. Run ONCE per source batch — the historical
    ``build_infer_program`` re-ran this inside every beam-search session
    even though the encoder state never changes."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        src = layers.data("s2s_src", [src_len], dtype="int64")
        enc_final = _encoder(src, src_vocab, emb_dim, hidden)
    return main, startup, enc_final


def build_decode_program(tgt_vocab=32, emb_dim=16, hidden=32, max_tgt_len=6,
                         beam_size=4, go_id=0, end_id=1, seed=9):
    """Beam-search half: decodes from a FED encoder state
    (``s2s_enc_state`` [B, hidden] float32), so the encoder runs outside
    the decode loop. Same parameter names as the monolithic program —
    bit-identical sequences from the same scope."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup):
        enc_state = layers.data("s2s_enc_state", [hidden], dtype="float32")
        dec_cell = _decoder_cell(hidden)
        decoder = layers.BeamSearchDecoder(
            dec_cell, start_token=go_id, end_token=end_id,
            beam_size=beam_size,
            embedding_fn=_tgt_embedding(tgt_vocab, emb_dim),
            output_fn=_output_fn(tgt_vocab))
        final, _ = layers.dynamic_decode(decoder, inits=enc_state,
                                         max_step_num=max_tgt_len)
    return main, startup, final["sequences"]


def run_split_infer(exe, scope, enc_prog, enc_state_var, dec_prog, seq_var,
                    src, return_numpy=True):
    """Split inference: encoder once, beam decode from the cached state.
    The encoder state crosses programs as a device tensor (no host
    round trip). Returns the decoded ``sequences`` fetch."""
    from .transformer import run_cached_phases
    outs = run_cached_phases(
        exe, scope,
        enc_prog, {"s2s_src": src}, [enc_state_var],
        dec_prog, {}, [seq_var],
        bridge={"s2s_enc_state": 0}, return_numpy=return_numpy)
    return outs[0]


def synthetic_pairs(rng, n, vocab=32, src_len=6, go_id=0, end_id=1):
    """Echo task over tokens >= 2 (0 = <go>, 1 = <end>): the target repeats
    the LAST source token then closes with <end> — a deterministic
    language the encoder's final state can carry exactly."""
    src = rng.randint(2, vocab, (n, src_len)).astype(np.int64)
    tgt = np.tile(src[:, -1:], (1, src_len))
    tgt[:, -1] = end_id
    tgt_in = np.concatenate([np.full((n, 1), go_id, np.int64),
                             tgt[:, :-1]], axis=1)
    return {"s2s_src": src, "s2s_tgt_in": tgt_in,
            "s2s_tgt_out": tgt[:, :, None]}
