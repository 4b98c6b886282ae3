"""Loss layers (counterparts in ``paddle_tpu/fluid/layers/loss.py``):
cross entropies, ``square_error_cost``, and the structured and sampled
losses (``warpctc``, ``edit_distance``, ``nce``, ``hsigmoid``,
``sampled_softmax_with_cross_entropy``; their ops in
``ops/structured_loss_ops.py``). As in the reference, ``nce`` and the
sampled softmax draw uniformly: another sampler, customised samples or
kept accidental hits raise."""

from ..layer_helper import LayerHelper

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "sigmoid_cross_entropy_with_logits", "square_error_cost",
           "warpctc", "edit_distance", "nce", "hsigmoid",
           "sampled_softmax_with_cross_entropy"]


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """-log of ``input``'s probability at the label (or against a soft
    label), over probabilities such as a softmax's output."""
    helper = LayerHelper("cross_entropy", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy", **locals())
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "axis": axis})
    if return_softmax:
        return loss, softmax
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x], "Label": [label]}, outputs={"Out": [out]},
        attrs={"ignore_index": ignore_index, "normalize": normalize})
    return out


def square_error_cost(input, label):
    """(input - label)^2 elementwise."""
    helper = LayerHelper("square_error_cost", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="square_error_cost",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """CTC loss [n, 1] of LoD logits (before the softmax) against LoD
    labels; or of padded logits [B, T, V] and labels [B, N] when both
    lengths are given."""
    helper = LayerHelper("warpctc", **locals())
    loss = helper.create_variable_for_type_inference("float32")
    grad = helper.create_variable_for_type_inference("float32")
    loss.shape = (-1, 1)
    inputs = {"Logits": [input], "Label": [label]}
    padded = input_length is not None and label_length is not None
    if padded:
        inputs["LogitsLength"] = [input_length]
        inputs["LabelLength"] = [label_length]
    helper.append_op(
        type="warpctc", inputs=inputs,
        outputs={"Loss": [loss], "WarpCTCGrad": [grad]},
        attrs={"blank": int(blank), "norm_by_times": bool(norm_by_times),
               "padded": padded})
    return loss


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Levenshtein distance [n, 1] of each hypothesis against its
    reference (LoD, or padded with both lengths), and the count of
    pairs. ``ignored_tokens`` are erased from both first (LoD only)."""
    from . import sequence_lod

    padded = input_length is not None and label_length is not None
    if ignored_tokens:
        if padded:
            raise NotImplementedError(
                "ignored_tokens with the padded API is not supported")
        input = sequence_lod.sequence_erase(input, ignored_tokens)
        label = sequence_lod.sequence_erase(label, ignored_tokens)
    helper = LayerHelper("edit_distance", **locals())
    out = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64")
    out.shape = (-1, 1)
    inputs = {"Hyps": [input], "Refs": [label]}
    if padded:
        inputs["HypsLength"] = [input_length]
        inputs["RefsLength"] = [label_length]
    helper.append_op(
        type="edit_distance", inputs=inputs,
        outputs={"Out": [out], "SequenceNum": [seq_num]},
        attrs={"normalized": bool(normalized), "padded": padded})
    return out, seq_num


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation cost [B, 1] against
    ``num_neg_samples`` negatives drawn uniformly a row."""
    if sampler != "uniform" or custom_dist is not None:
        raise NotImplementedError(
            "nce supports sampler='uniform' only (got %r)" % sampler)
    if sample_weight is not None:
        raise NotImplementedError("nce sample_weight is not supported")
    helper = LayerHelper("nce", **locals())
    dim = int(input.shape[-1])
    w = helper.create_parameter(param_attr, [num_total_classes, dim],
                                "float32")
    b = helper.create_parameter(bias_attr, [num_total_classes],
                                "float32", is_bias=True)
    cost = helper.create_variable_for_type_inference("float32")
    slog = helper.create_variable_for_type_inference("float32")
    slab = helper.create_variable_for_type_inference("int64")
    cost.shape = (-1, 1)
    inputs = {"Input": [input], "Label": [label], "Weight": [w]}
    if b is not None:
        inputs["Bias"] = [b]
    helper.append_op(
        type="nce", inputs=inputs,
        outputs={"Cost": [cost], "SampleLogits": [slog],
                 "SampleLabels": [slab]},
        attrs={"num_total_classes": int(num_total_classes),
               "num_neg_samples": int(num_neg_samples)})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None,
             is_custom=False, is_sparse=False):
    """Hierarchical sigmoid cost [B, 1] over the complete binary tree of
    ``num_classes`` leaves; custom trees raise."""
    if is_custom or path_table is not None:
        raise NotImplementedError(
            "hsigmoid custom trees (path_table/path_code) not supported")
    helper = LayerHelper("hsigmoid", **locals())
    dim = int(input.shape[-1])
    w = helper.create_parameter(param_attr, [num_classes - 1, dim],
                                "float32")
    b = helper.create_parameter(bias_attr, [num_classes - 1, 1], "float32",
                                is_bias=True)
    out = helper.create_variable_for_type_inference("float32")
    pre = helper.create_variable_for_type_inference("float32")
    out.shape = (-1, 1)
    inputs = {"X": [input], "Label": [label], "W": [w]}
    if b is not None:
        inputs["Bias"] = [b]
    helper.append_op(
        type="hierarchical_sigmoid", inputs=inputs,
        outputs={"Out": [out], "PreOut": [pre]},
        attrs={"num_classes": int(num_classes)})
    return out


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1, remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """Softmax cross-entropy [B, 1] over the true class and
    ``num_samples`` classes drawn uniformly a row, with the log q
    correction and accidental hits masked."""
    if use_customized_samples or customized_samples is not None:
        raise NotImplementedError(
            "sampled_softmax customized samples are not supported")
    if num_true != 1:
        raise NotImplementedError("num_true != 1 is not supported")
    if not remove_accidental_hits:
        raise NotImplementedError(
            "remove_accidental_hits=False is not supported (hits are "
            "always masked)")
    helper = LayerHelper("sampled_softmax", **locals())
    loss = helper.create_variable_for_type_inference("float32")
    samples = helper.create_variable_for_type_inference("int64")
    loss.shape = (-1, 1)
    helper.append_op(
        type="sampled_softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Loss": [loss], "Samples": [samples]},
        attrs={"num_samples": int(num_samples)})
    return loss
