"""The decode kernels' split of the key axis, rehearsed on the CPU.

``tools/decode_rehearsal.py::emulate_split_decode`` computes what the
kernels of csrc/decode_attention.cu compute when they cut each (b, h)'s
key axis into pieces: each piece's online softmax over tiles, the empty
partial (m = -inf) of a row with no column in a piece, the all-masked
partials of an empty causal window (m = -1e30), and the combine in piece
order. It is held to the JAX package's Pallas decode and paged kernels in
interpret mode and to its plain version, on the same numpy inputs, at
every count of pieces from 1 to capacity / tile: fp32 at rtol 1e-5, atol
1e-6 (the same math, summed in another order), also where the host's
longest length is shorter than a row (the last piece runs on to the
capacity). Then ``decode_splits``, the host's rule for the count: from
shapes and the longest length the host holds, one piece at the dense
path's shape and at the serving phase's short rows, several at the
serving path's mix, the same for a paged cache and its gathered dense
cache. The card runs the kernels themselves
against the plain version at forced counts (tests/test_torch_cuda.py).
"""

import os
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.kernels import attention as JA
from paddle_tpu_torch.kernels import attention as PA

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import decode_rehearsal as R  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
C, TILE, D = 256, 32, 16


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def pallas():
    """The JAX package's Pallas decode and paged kernels (interpret mode)
    on three inputs, computed once: a dense ring at Q 1 with lens of 1, a
    wrapped ring and a full one; speculative verify rows at Q 4 with
    empty windows; a paged pool through permuted page tables."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
        rng = np.random.RandomState(9)
        for name, Q, lens, causal in (("ring", 1, [1, 70, 256, 300], False),
                                      ("verify", 4, [2, 3, 100, 256], True)):
            mp.setenv("PADDLE_TPU_ATTN_FORCE", "decode")
            q, k, v = _rand(rng, 4, 2, Q, D), _rand(rng, 4, 2, C, D), \
                _rand(rng, 4, 2, C, D)
            cache_len = np.array(lens, np.int32)
            assert JA._use_decode_kernel(k)
            want = np.asarray(JA.attention_with_cache(
                q, k, v, cache_len, causal_window=causal))
            out[name] = (q, k, v, cache_len, causal, want)
        mp.setenv("PADDLE_TPU_ATTN_FORCE", "paged")
        ptok, npages = 32, C // 32
        P = 3 * npages + 1
        pools = _rand(rng, P, 2, ptok, D), _rand(rng, P, 2, ptok, D)
        q = _rand(rng, 3, 2, 1, D)
        table = rng.permutation(np.arange(1, P))[:3 * npages].reshape(
            3, npages).astype(np.int32)
        cache_len = np.array([C, 33, 1], np.int32)
        assert JA._use_paged_kernel(table, ptok)
        want = np.asarray(JA.paged_attention_cache(q, *pools, table,
                                                   cache_len))
        out["paged"] = (q, pools, table, cache_len, want)
    return out


@pytest.mark.parametrize("splits", range(1, C // TILE + 1))
@pytest.mark.parametrize("case", ["ring", "verify"])
def test_split_matches_pallas_decode_kernel(pallas, case, splits):
    """Pieces of whole tiles (granule = tile, so every count from 1 to 8
    cuts 8 tiles differently), against the Pallas decode kernel: lens of
    1, a wrapped ring, a full one, and at Q 4 rows whose causal window is
    empty (C 256 is a multiple of 128, where the Pallas kernel pads
    nothing)."""
    q, k, v, cache_len, causal, want = pallas[case]
    got = R.emulate_split_decode(*_t(q, k, v, cache_len), D ** -0.5, causal,
                                 splits, TILE, granule=TILE)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("splits", range(1, C // TILE + 1))
def test_split_matches_pallas_paged_kernel(pallas, splits):
    """Pieces of whole pages (32-token pages, granule 32) of a pool read
    through permuted page tables, gathered to the dense ring, against the
    Pallas paged kernel."""
    q, (k_pool, v_pool), table, cache_len, want = pallas["paged"]
    k, v = (PA.gather_paged_cache(*_t(p, table)) for p in (k_pool, v_pool))
    got = R.emulate_split_decode(_t(q)[0], k, v, _t(cache_len)[0],
                                 D ** -0.5, False, splits, TILE, granule=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_empty_windows_at_a_ragged_capacity(splits):
    """At C 200 (not a multiple of 128) a row whose causal window is empty
    averages V over the whole capacity: every piece is all-masked
    (m = -1e30, distinct from an empty piece's -inf) and the combine
    weighs them by their column counts. Held to the plain version, as
    the port holds its kernels (the Pallas kernel averages its zero
    padding in; ROADMAP queue 3)."""
    rng = np.random.RandomState(3)
    q, k, v = _rand(rng, 2, 2, 4, 8), _rand(rng, 2, 2, 200, 8), \
        _rand(rng, 2, 2, 200, 8)
    cache_len = np.array([2, 150], np.int32)
    want = np.asarray(JA._ref_attention_cache(q, k, v, cache_len, 8 ** -0.5,
                                              causal_window=True))
    got = R.emulate_split_decode(*_t(q, k, v, cache_len), 8 ** -0.5, True,
                                 splits, TILE, granule=TILE)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy()[0, :, 0], v[0].mean(axis=1),
                               rtol=RTOL, atol=ATOL)


def test_kernel_pieces_at_the_serving_shape():
    """The wrappers' own pieces (multiples of 128 columns, from
    ``decode_splits`` at the serving path's shape on 132 SMs) at 2 of its
    16 heads: one slot full, one across three pages, three short and
    three of length 1."""
    rng = np.random.RandomState(4)
    B, H, Cap, d = 8, 2, 1024, 64
    q, k, v = _rand(rng, B, H, 1, d), _rand(rng, B, H, Cap, d), \
        _rand(rng, B, H, Cap, d)
    cache_len = np.array([1024, 300, 96, 70, 65, 1, 1, 1], np.int32)
    splits = PA.decode_splits(B, 16, 1, Cap, d, torch.float32, 132)
    assert splits > 1
    want = np.asarray(JA._ref_attention_cache(q, k, v, cache_len, d ** -0.5))
    got = R.emulate_split_decode(*_t(q, k, v, cache_len), d ** -0.5, False,
                                 splits, TILE)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("longest", [1, 96, 128, 300, 1024, 5000])
def test_pieces_over_the_hosts_longest_length(longest):
    """The wrappers' pieces at the serving path's shape cut over the
    longest length the host passes: exact (1024), past the capacity
    (5000), or short of the longest row (1, 96, 128, 300: fewer pieces,
    the last running on to the capacity), each against the plain
    version."""
    rng = np.random.RandomState(6)
    B, H, Cap, d = 8, 2, 1024, 64
    q, k, v = _rand(rng, B, H, 1, d), _rand(rng, B, H, Cap, d), \
        _rand(rng, B, H, Cap, d)
    cache_len = np.array([1024, 300, 96, 70, 65, 1, 1, 1], np.int32)
    splits = PA.decode_splits(B, 16, 1, Cap, d, torch.float32, 132,
                              longest)
    want = np.asarray(JA._ref_attention_cache(q, k, v, cache_len, d ** -0.5))
    got = R.emulate_split_decode(*_t(q, k, v, cache_len), d ** -0.5, False,
                                 splits, TILE, longest=longest)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fault", R.FAULTS)
def test_planted_faults_leave_the_tolerance(fault):
    """Each fault that tools/decode_fault_check.py plants in the kernels,
    planted in the emulation, moves the serving shape's result far past
    the tolerance the sound emulation keeps."""
    rng = np.random.RandomState(5)
    B, H, Cap, d = 8, 2, 1024, 64
    q, k, v = _rand(rng, B, H, 1, d), _rand(rng, B, H, Cap, d), \
        _rand(rng, B, H, Cap, d)
    cache_len = _t(np.array([1024, 300, 96, 70, 65, 1, 1, 1], np.int32))[0]
    q, k, v = _t(q, k, v)
    want = PA._ref_attention_cache(q, k, v, cache_len, d ** -0.5)
    got = R.emulate_split_decode(q, k, v, cache_len, d ** -0.5, False, 8,
                                 TILE, fault=fault)
    assert (got - want).abs().max().item() > 100 * (ATOL + RTOL)


# -- the host's rule -------------------------------------------------------

def test_decode_splits_one_piece_at_the_dense_path():
    """64 streams of 16 heads fill 132 SMs several times over: one piece,
    whatever the type, and for the speculative verify rows (Q 4)."""
    for dtype in (torch.float32, torch.bfloat16):
        assert PA.decode_splits(64, 16, 1, 1024, 64, dtype, 132) == 1
    assert PA.decode_splits(64, 16, 4, 1024, 64, torch.float32, 132) == 1


def test_decode_splits_several_pieces_at_the_serving_path():
    """8 streams of 16 heads leave most SMs idle in one piece: the key
    axis splits until the blocks are several times the SMs; 2 streams of
    a long slot split into at most 8 pieces (about twice the SMs in
    blocks), where the card measured fastest (PERF.md)."""
    s = PA.decode_splits(8, 16, 1, 1024, 64, torch.float32, 132)
    assert s == 8 and 8 * 16 * s >= 2 * 132
    s = PA.decode_splits(2, 16, 1, 8192, 64, torch.float32, 132)
    assert s == 8 and 2 * 16 * s >= 1.9 * 132


@pytest.mark.parametrize("capacity,ptok", [(1024, 128), (8192, 128),
                                           (320, 64), (200, 8), (100, 4),
                                           (3000, 8)])
@pytest.mark.parametrize("B,H", [(1, 1), (2, 16), (8, 16), (64, 16)])
def test_decode_pieces_cover_the_capacity_in_whole_pages(capacity, ptok, B,
                                                         H):
    """The pieces are contiguous, cover the capacity once and, below it,
    end on a page boundary (pages that divide 128 columns) and a tile
    boundary (32 keys); a paged cache of npages * ptok columns and its
    gathered dense cache get the same count."""
    for Q in (1, 4):
        s = PA.decode_splits(B, H, Q, capacity, 64, torch.float32, 132)
        piece = PA.decode_piece(capacity, s)
        assert -(-capacity // piece) == s
        starts = list(range(0, capacity, piece))
        assert len(starts) == s and starts[-1] + piece >= capacity
        if s > 1:
            assert piece % ptok == 0 and piece % 32 == 0
        npages = capacity // ptok
        if npages * ptok == capacity:
            assert PA.decode_splits(B, H, Q, npages * ptok, 64,
                                    torch.float32, 132) == s


def test_decode_splits_follow_the_hosts_longest_length():
    """At the serving path's shape a step whose rows all end within 128
    columns (the serving phase's steps: prompts of 32-64 tokens, up to
    32 new ones) takes one piece, so no combine; longer rows take up to
    8 pieces of 128 columns; the dense path takes one whatever the
    length. ``decode_pieces`` gives a launch's (piece, count): one piece
    is the whole capacity, and more leave the last one inside it."""
    def count(B, longest, cap=1024):
        return PA.decode_splits(B, 16, 1, cap, 64, torch.float32, 132,
                                longest)
    assert [count(8, n) for n in (1, 96, 128, 129, 300, 1024, 5000, None)] \
        == [1, 1, 1, 2, 3, 8, 8, 8]
    assert [count(64, n) for n in (96, 1024, None)] == [1, 1, 1]
    assert count(2, 3000, 8192) == 8 and count(2, 8192, 8192) == 8
    for longest in (1, 96, 300, 1024, None):
        piece, n = PA.decode_pieces(8, 16, 1, 1024, 64, torch.float32, 132,
                                    longest)
        assert n == count(8, longest)
        assert (piece, n) == (1024, 1) if n == 1 else \
            (n - 1) * piece < 1024 and piece % 128 == 0
    assert PA.decode_pieces(8, 16, 1, 1024, 64, torch.float32, 132, 300,
                            splits=8) == (128, 3)
    with pytest.raises(TypeError):
        PA.decode_span(1024, 96.0)


def test_decode_splits_reads_no_tensor(monkeypatch):
    """The rule takes shapes, never a tensor: the lengths stay on the
    device, so it adds no host sync. A tensor argument raises, and with
    every way of reading a tensor's value on the host disabled the rule
    still answers."""
    with pytest.raises(TypeError):
        PA.decode_splits(torch.tensor(8), 16, 1, 1024, 64, torch.float32,
                         132)
    with pytest.raises(TypeError):
        PA.decode_splits(8, 16, 1, 1024, 64, torch.float32, 132,
                         torch.tensor(96, dtype=torch.int32))

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was read on the host")

    for name in ("item", "tolist", "__int__", "__index__", "__bool__",
                 "__float__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    assert PA.decode_splits(8, 16, 1, 1024, 64, torch.float32, 132) > 1
    assert PA.decode_splits(64, 16, 1, 1024, 64, torch.float32, 132) == 1
    assert PA.decode_splits(8, 16, 1, 1024, 64, torch.float32, 132, 96) == 1


def test_decode_splits_one_piece_past_2048_bytes():
    """Rows past 2048 bytes split their output's columns across blocks
    and take one piece; so does every row at a capacity of one granule."""
    assert PA.decode_splits(1, 1, 1, 8192, 640, torch.float32, 132) == 1
    assert PA.decode_splits(1, 1, 1, 128, 64, torch.float32, 132) == 1
    assert PA.decode_block_rows(4, 640 * 4) == 1
    assert [PA.decode_block_rows(Q, 256) for Q in (1, 2, 4, 5, 8)] == \
        [1, 4, 4, 8, 8]
    assert [PA.decode_block_rows(Q, 2048) for Q in (1, 2, 3)] == [1, 2, 2]


def test_card_fault_check_still_plants():
    """Every fault and variant of tools/decode_fault_check.py finds the
    text it replaces in csrc/decode_attention.cu as often as it expects,
    so the card-side check plants what it says it plants."""
    import decode_fault_check as F
    path = os.path.join(F.ROOT, F.SOURCE)
    with open(path) as f:
        text = f.read()
    for name, plants in F.PLANTS.items():
        for old, new, count in plants:
            assert text.count(old) == count, (name, old)
            assert new not in text, (name, new)
