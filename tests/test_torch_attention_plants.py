"""What keeps the card-side checks of the fused-attention kernels in step
with their source, checked on the CPU:

* every planted fault and variant of ``tools/attention_fault_check.py``
  plants into a copy of the current ``csrc/fused_attention.cu`` (each
  text it replaces occurs the stated number of times), so an edit of the
  kernels that would leave one unplanted fails here, not after a chip
  run; and each fault reaches the routes it is meant for (the SIMT
  kernels, the 16-bit tensor-core forward and backward, the fp32
  3xTF32 kernels and the kernels past d 256);
* the wrappers' row-alignment rule (``_rows``): an operand whose rows
  do not all start on a 16-byte boundary and which the tensor-core
  kernels copy with 16-byte ``cp.async`` (16-bit at every d, fp32 up to
  d 128) is copied contiguous, and no other operand is.
"""

import importlib.util
import os
import re
import shutil

import pytest
import torch

from paddle_tpu_torch.kernels import attention as A

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FC = _tool("attention_fault_check")


@pytest.mark.parametrize("fault", sorted(FC.PLANTS))
def test_fault_plants_into_current_source(tmp_path, fault):
    src = os.path.join(ROOT, FC.SOURCE)
    dst = os.path.join(str(tmp_path), FC.SOURCE)
    os.makedirs(os.path.dirname(dst))
    shutil.copy(src, dst)
    FC.plant(str(tmp_path), fault)
    with open(src) as f:
        sound = f.read()
    with open(dst) as f:
        planted = f.read()
    assert (planted == sound) == (fault == "sound")
    for old, new, count in FC.PLANTS[fault]:
        assert sound.count(old) == count, (old, count)
        assert planted.count(new) >= count, new


# the kernels of each route in csrc/fused_attention.cu
SIMT = ("attn_fwd", "attn_bwd_dq", "attn_bwd_dkdv")
MMA_FORWARD = ("attn_fwd_mma",)
MMA_BACKWARD = ("attn_bwd_dq_mma", "attn_bwd_dkdv_mma")
TF32 = ("attn_fwd_tf32x3", "attn_bwd_dq_tf32x3", "attn_bwd_dkdv_tf32x3")
WIDE = ("attn_fwd_wide", "attn_bwd_dq_wide", "attn_bwd_dkdv_wide")
ROUTES = (SIMT, MMA_FORWARD, MMA_BACKWARD, TF32, WIDE)


def _functions(text):
    """{name: [(start, end), ...]}: the spans of the source's functions
    (comments blanked out). Each ends at a ``}`` alone on a line; its
    name is the first one called before the ``) {`` that opens its
    body."""
    spans, start = {}, 0
    for m in re.finditer(r"\n}\n", text):
        head = re.split(r"\)\s*\{\n", text[start:m.end()], 1)[0]
        names = [n for n in re.findall(r"(\w+)(?:<[^<>()]*>)?\(", head)
                 if n != "__launch_bounds__"]
        if names:
            spans.setdefault(names[0], []).append((start, m.end()))
        start = m.end()
    return spans


def _reached(text, spans, kernel):
    """The spans of ``kernel`` and of every function it calls, at any
    depth."""
    todo, seen = [kernel], set()
    while todo:
        name = todo.pop()
        if name in seen or name not in spans:
            continue
        seen.add(name)
        for a, b in spans[name]:
            todo += re.findall(r"(\w+)(?:<[^<>()]*>)?\(", text[a:b])
    return [span for name in seen for span in spans[name]]


def test_every_fault_reaches_both_backward_routes():
    """Each of the four faults of every route changes a line that each
    route runs (in the kernel or in a function it calls): the SIMT
    kernels, the 16-bit tensor-core forward and backward, the fp32
    3xTF32 kernels and the kernels past d 256. k_not_transposed reaches
    the 16-bit dq kernel alone, v_not_transposed the 16-bit forward
    alone, tf32x1 the 3xTF32 kernels alone. The variants reach the
    16-bit forward alone (forward_simt its route's width limit, defined
    beside it), the fp32 ones (fp32_simt, lo_rounded, q_split_each_tile,
    dkdv_cols_64) the 3xTF32 kernels alone (their constants, likewise)."""
    with open(os.path.join(ROOT, FC.SOURCE)) as f:
        text = re.sub(r"//[^\n]*", lambda m: " " * len(m.group()), f.read())
    spans = _functions(text)
    assert set(sum(ROUTES, ())) <= set(spans)

    def reaches(at, kernels):
        return any(a <= i < b for kernel in kernels
                   for a, b in _reached(text, spans, kernel) for i in at)

    tf32_alone = [False, False, False, True, False]
    alone = {"k_not_transposed": [False, False, True, False, False],
             "v_not_transposed": [False, True, False, False, False],
             "tf32x1": tf32_alone, "fp32_simt": tf32_alone,
             "lo_rounded": tf32_alone, "q_split_each_tile": tf32_alone,
             "dkdv_cols_64": tf32_alone}
    for name, subs in FC.PLANTS.items():
        at = [i for old, _, _ in subs for i in _find_all(text, old)]
        routes = [reaches(at, kernels) for kernels in ROUTES]
        if name == "sound":
            assert not at
        elif name in alone:
            assert routes == alone[name], (name, routes)
        elif name in FC.VARIANTS:
            assert routes == [False, True, False, False, False], (name,
                                                                  routes)
        else:
            assert routes == [True] * 5, (name, routes)


def _find_all(text, sub):
    i = text.find(sub)
    while i >= 0:
        yield i
        i = text.find(sub, i + 1)


def _bf16(*shape):
    g = torch.Generator().manual_seed(len(shape))
    return torch.randn(*shape, generator=g).to(torch.bfloat16)


def _views():
    """(name, operand, copied?) on CPU bfloat16 and float32 tensors."""
    B, S, H, d = 2, 6, 3, 16
    flat = _bf16(B * H * S * d + 1)
    qkv = _bf16(B, S, 3 * H * d)
    wide = _bf16(B, H, S, d + 4)
    one = _bf16(1, 1, 1, 8 * S * d + 3)
    return [
        ("contiguous", _bf16(B, H, S, d), False),
        ("packed_heads", A._split_heads(_bf16(B, S, H * d), H), False),
        ("qkv_slice", A._split_heads(qkv[..., H * d:2 * H * d], H), False),
        ("offset_one_element", flat[1:].view(B, H, S, d), True),
        ("row_stride_d_plus_4", wide[..., :d], True),
        ("rows_not_contiguous", _bf16(B, H, d, S).transpose(2, 3), True),
        # a dimension of size 1 takes any stride
        ("odd_stride_of_size_one", one[..., :S * d].view(1, 1, S, d)
         .as_strided((1, 1, S, d), (3, 5, d, 1)), False),
        # float32 up to d 128 runs on the 3xTF32 kernels' 16-byte copies
        ("float32_offset", torch.zeros(B * H * S * d + 1)[1:]
         .view(B, H, S, d), True),
        ("float32_offset_d256", torch.zeros(B * H * S * 256 + 1)[1:]
         .view(B, H, S, 256), False),
        ("float32_row_stride_d_plus_1", torch.zeros(B, H, S, d + 1)[..., :d],
         True),
    ]


@pytest.mark.parametrize("name,t,copied", _views(),
                         ids=[v[0] for v in _views()])
def test_rows_copies_exactly_the_misaligned_operands(name, t, copied):
    got = A._rows(t)
    assert (got.data_ptr() != t.data_ptr()) == copied, name
    assert torch.equal(got, t)
    assert A._rows_aligned(got)
    if copied:
        assert got.is_contiguous() and got.data_ptr() % 16 == 0


def test_backward_wrappers_refuse_a_misaligned_bf16_operand():
    """The dq and dk/dv wrappers check what ``_rows`` ensures: a
    bfloat16 operand whose rows are not 16-byte aligned is refused, one
    that is passes; float32 likewise up to d 128 (the 3xTF32 kernels'
    16-byte copies), and at d 256 (the SIMT kernels) any row address."""
    B, H, S, d = 1, 2, 4, 16
    q = _bf16(B, H, S, d)
    bad = _bf16(B * H * S * d + 1)[1:].view(B, H, S, d)
    with pytest.raises(ValueError, match="16-byte boundary"):
        A._check_operand("k", bad, q, aligned=True)
    A._check_operand("k", A._rows(bad), q, aligned=True)
    A._check_operand("k", bad, q)
    f32 = torch.zeros(B * H * S * d + 1)[1:].view(B, H, S, d)
    with pytest.raises(ValueError, match="16-byte boundary"):
        A._check_operand("k", f32, f32, aligned=True)
    A._check_operand("k", A._rows(f32), f32, aligned=True)
    f32 = torch.zeros(B * H * S * 256 + 1)[1:].view(B, H, S, 256)
    A._check_operand("k", f32, f32, aligned=True)
