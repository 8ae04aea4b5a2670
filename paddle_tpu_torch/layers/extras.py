"""Layer wrappers over registered ops that had no python-API surface yet
(parity: layers/nn.py + layers/detection.py + layers/ops.py — the reference
auto-generates many of these with generate_layer_fn; this module is the
equivalent hand-rolled thin layer over the op registry).

Every function builds output vars and appends one op; shapes are
best-effort static metadata (the executor derives real shapes at trace
time).  A copy of the JAX package's ``layers/extras.py``: a builder whose op
the port has no rule for yet raises "no lowering registered" when the
executor plans the program."""

import numpy as np

from ..layer_helper import LayerHelper

__all__ = [
    # detection
    "multiclass_nms", "bipartite_match", "target_assign", "density_prior_box",
    "box_decoder_and_assign", "generate_proposals", "rpn_target_assign",
    "collect_fpn_proposals", "distribute_fpn_proposals",
    "retinanet_detection_output", "polygon_box_transform", "yolov3_loss",
    "box_clip", "anchor_generator", "roi_pool", "psroi_pool",
    "mine_hard_examples", "detection_output", "deformable_conv",
    # misc
    "edit_distance", "mean_iou", "chunk_eval", "affine_grid", "spectral_norm",
    "bilinear_tensor_product", "cos_sim", "unique", "size", "crop_tensor",
    "crop", "add_position_encoding", "random_crop", "hash",
    "teacher_student_sigmoid_loss", "fsp_matrix", "shuffle_channel",
    "space_to_depth", "temporal_shift", "strided_slice", "pad_constant_like",
    "multiplex", "log_loss", "rank_loss", "bpr_loss", "center_loss",
    "data_norm", "resize_trilinear", "scatter_nd", "scatter_nd_add",
    "shard_index", "isfinite", "has_inf", "has_nan", "im2sequence",
    "lod_reset", "row_conv", "soft_relu", "stanh", "py_func",
    "get_tensor_from_selected_rows", "merge_selected_rows",
    "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
    "ctc_greedy_decoder", "linear_chain_crf", "crf_decoding",
    "conv3d_transpose", "adaptive_pool3d",
    # compositions
    "mse_loss", "dice_loss", "npair_loss", "image_resize_short", "ones_like",
    "rank", "affine_channel", "lod_append", "sequence_conv",
    "sequence_enumerate", "sequence_expand", "sequence_pad",
    "sequence_reshape", "sequence_scatter", "sequence_slice",
    "sequence_unpad", "autoincreased_step_counter", "create_parameter",
    # decode-time / remaining surface
    "Print", "logical_xor", "beam_search", "beam_search_decode",
    "gather_tree", "sigmoid_focal_loss", "unfold", "continuous_value_model",
    "lstm", "dynamic_lstmp", "double_buffer", "tensor_array_to_tensor",
    "tree_conv", "prroi_pool", "filter_by_instag",
]


def _op(type_, inputs, out_slots, attrs=None, dtype="float32", name=None):
    """Append `type_` and return created output var(s).  out_slots:
    dict slot -> (dtype, shape) or list of such for multi-var slots."""
    helper = LayerHelper(type_, name=name)
    outs = {}
    created = {}
    for slot, spec in out_slots.items():
        specs = spec if isinstance(spec, list) else [spec]
        vs = [helper.create_variable_for_type_inference(dt, shape)
              for dt, shape in specs]
        outs[slot] = vs
        created[slot] = vs if isinstance(spec, list) else vs[0]
    ins = {k: (v if isinstance(v, list) else [v])
           for k, v in inputs.items() if v is not None
           and not (isinstance(v, list) and not v)}
    helper.append_op(type=type_, inputs=ins, outputs=outs, attrs=attrs or {})
    return created


def _shape(v):
    return tuple(getattr(v, "shape", ()) or ())


# -- detection ---------------------------------------------------------------

def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None, return_rois_num=False):
    N = _shape(bboxes)[0]
    kt = keep_top_k if keep_top_k > 0 else nms_top_k
    o = _op("multiclass_nms", {"BBoxes": bboxes, "Scores": scores},
            {"Out": ("float32", (N, kt, 6)),
             "NmsRoisNum": ("int32", (N,))},
            {"background_label": background_label,
             "score_threshold": score_threshold, "nms_top_k": nms_top_k,
             "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
             "normalized": normalized, "nms_eta": nms_eta}, name=name)
    return (o["Out"], o["NmsRoisNum"]) if return_rois_num else o["Out"]


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    s = _shape(dist_matrix)
    B, C = (s[0], s[2]) if len(s) == 3 else (1, s[1])
    attrs = {}
    if match_type:
        attrs["match_type"] = match_type
    if dist_threshold is not None:
        attrs["dist_threshold"] = dist_threshold
    o = _op("bipartite_match", {"DistMat": dist_matrix},
            {"ColToRowMatchIndices": ("int32", (B, C)),
             "ColToRowMatchDist": ("float32", (B, C))}, attrs, name=name)
    return o["ColToRowMatchIndices"], o["ColToRowMatchDist"]


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0, name=None):
    mi = _shape(matched_indices)
    K = _shape(input)[-1] if _shape(input) else 1
    o = _op("target_assign",
            {"X": input, "MatchIndices": matched_indices,
             "NegIndices": negative_indices},
            {"Out": ("float32", mi + (K,)),
             "OutWeight": ("float32", mi + (1,))},
            {"mismatch_value": mismatch_value}, name=name)
    return o["Out"], o["OutWeight"]


def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=[0.1, 0.1, 0.2, 0.2],
                      clip=False, steps=[0.0, 0.0], offset=0.5,
                      flatten_to_2d=False, name=None):
    H, W = _shape(input)[2], _shape(input)[3]
    P = sum(len(fixed_ratios or []) * d * d for d in (densities or []))
    o = _op("density_prior_box", {"Input": input, "Image": image},
            {"Boxes": ("float32", (H, W, P, 4)),
             "Variances": ("float32", (H, W, P, 4))},
            {"densities": densities or [], "fixed_sizes": fixed_sizes or [],
             "fixed_ratios": fixed_ratios or [], "variances": list(variance),
             "clip": clip, "step_w": steps[0], "step_h": steps[1],
             "offset": offset}, name=name)
    return o["Boxes"], o["Variances"]


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip, name=None):
    R = _shape(target_box)[0]
    C4 = _shape(target_box)[1]
    o = _op("box_decoder_and_assign",
            {"PriorBox": prior_box, "PriorBoxVar": prior_box_var,
             "TargetBox": target_box, "BoxScore": box_score},
            {"DecodeBox": ("float32", (R, C4)),
             "OutputAssignBox": ("float32", (R, 4))},
            {"box_clip": box_clip}, name=name)
    return o["DecodeBox"], o["OutputAssignBox"]


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None,
                       return_rois_num=False):
    N = _shape(scores)[0]
    o = _op("generate_proposals",
            {"Scores": scores, "BboxDeltas": bbox_deltas, "ImInfo": im_info,
             "Anchors": anchors, "Variances": variances},
            {"RpnRois": ("float32", (N, post_nms_top_n, 4)),
             "RpnRoisProbs": ("float32", (N, post_nms_top_n, 1)),
             "RpnRoisNum": ("int32", (N,))},
            {"pre_nms_topN": pre_nms_top_n, "post_nms_topN": post_nms_top_n,
             "nms_thresh": nms_thresh, "min_size": min_size, "eta": eta},
            name=name)
    if return_rois_num:
        return o["RpnRois"], o["RpnRoisProbs"], o["RpnRoisNum"]
    return o["RpnRois"], o["RpnRoisProbs"]


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True, name=None):
    B = _shape(gt_boxes)[0]
    fg_cap = int(rpn_fg_fraction * rpn_batch_size_per_im)
    sc_cap = fg_cap + rpn_batch_size_per_im
    o = _op("rpn_target_assign",
            {"Anchor": anchor_box, "GtBoxes": gt_boxes, "ImInfo": im_info},
            {"LocationIndex": ("int32", (B * fg_cap,)),
             "ScoreIndex": ("int32", (B * sc_cap,)),
             "TargetLabel": ("int32", (B * sc_cap, 1)),
             "TargetBBox": ("float32", (B * fg_cap, 4)),
             "BBoxInsideWeight": ("float32", (B * fg_cap, 4))},
            {"rpn_batch_size_per_im": rpn_batch_size_per_im,
             "rpn_straddle_thresh": rpn_straddle_thresh,
             "rpn_fg_fraction": rpn_fg_fraction,
             "rpn_positive_overlap": rpn_positive_overlap,
             "rpn_negative_overlap": rpn_negative_overlap,
             "use_random": use_random}, name=name)
    return (o["LocationIndex"], o["ScoreIndex"], o["TargetLabel"],
            o["TargetBBox"], o["BBoxInsideWeight"])


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, name=None):
    o = _op("collect_fpn_proposals",
            {"MultiLevelRois": list(multi_rois),
             "MultiLevelScores": list(multi_scores)},
            {"FpnRois": ("float32", (post_nms_top_n, 4)),
             "RoisNum": ("int32", ())},
            {"post_nms_topN": post_nms_top_n}, name=name)
    return o["FpnRois"]


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, name=None):
    R = _shape(fpn_rois)[0]
    n_lvl = max_level - min_level + 1
    o = _op("distribute_fpn_proposals", {"FpnRois": fpn_rois},
            {"MultiFpnRois": [("float32", (R, 4))] * n_lvl,
             "RestoreIndex": ("int32", (R, 1)),
             "MultiLevelRoIsNum": [("int32", ())] * n_lvl},
            {"min_level": min_level, "max_level": max_level,
             "refer_level": refer_level, "refer_scale": refer_scale},
            name=name)
    return o["MultiFpnRois"], o["RestoreIndex"]


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0, name=None):
    N = _shape(im_info)[0] if _shape(im_info) else 1
    o = _op("retinanet_detection_output",
            {"BBoxes": list(bboxes), "Scores": list(scores),
             "Anchors": list(anchors), "ImInfo": im_info},
            {"Out": ("float32", (N, keep_top_k, 6)),
             "NmsRoisNum": ("int32", (N,))},
            {"score_threshold": score_threshold, "nms_top_k": nms_top_k,
             "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
             "nms_eta": nms_eta}, name=name)
    return o["Out"]


def polygon_box_transform(input, name=None):
    return _op("polygon_box_transform", {"Input": input},
               {"Output": ("float32", _shape(input))}, name=name)["Output"]


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    N = _shape(x)[0]
    H, W = _shape(x)[2], _shape(x)[3]
    B = _shape(gt_box)[1]
    o = _op("yolov3_loss",
            {"X": x, "GTBox": gt_box, "GTLabel": gt_label,
             "GTScore": gt_score},
            {"Loss": ("float32", (N,)),
             "ObjectnessMask": ("float32", (N, len(anchor_mask), H, W)),
             "GTMatchMask": ("int32", (N, B))},
            {"anchors": list(anchors), "anchor_mask": list(anchor_mask),
             "class_num": class_num, "ignore_thresh": ignore_thresh,
             "downsample_ratio": downsample_ratio,
             "use_label_smooth": use_label_smooth}, name=name)
    return o["Loss"]


def box_clip(input, im_info, name=None):
    return _op("box_clip", {"Input": input, "ImInfo": im_info},
               {"Output": ("float32", _shape(input))}, name=name)["Output"]


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=[0.1, 0.1, 0.2, 0.2], stride=None, offset=0.5,
                     name=None):
    H, W = _shape(input)[2], _shape(input)[3]
    A = len(anchor_sizes or []) * len(aspect_ratios or [])
    o = _op("anchor_generator", {"Input": input},
            {"Anchors": ("float32", (H, W, A, 4)),
             "Variances": ("float32", (H, W, A, 4))},
            {"anchor_sizes": list(anchor_sizes or []),
             "aspect_ratios": list(aspect_ratios or []),
             "variances": list(variance), "stride": list(stride or []),
             "offset": offset}, name=name)
    return o["Anchors"], o["Variances"]


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_num=None, name=None):
    C = _shape(input)[1]
    R = _shape(rois)[0]
    o = _op("roi_pool", {"X": input, "ROIs": rois, "RoisNum": rois_num},
            {"Out": ("float32", (R, C, pooled_height, pooled_width)),
             "Argmax": ("int32", (R, C, pooled_height, pooled_width))},
            {"pooled_height": pooled_height, "pooled_width": pooled_width,
             "spatial_scale": spatial_scale}, name=name)
    return o["Out"]


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, rois_num=None, name=None):
    R = _shape(rois)[0]
    return _op("psroi_pool",
               {"X": input, "ROIs": rois, "RoisNum": rois_num},
               {"Out": ("float32", (R, output_channels, pooled_height,
                                    pooled_width))},
               {"output_channels": output_channels,
                "spatial_scale": spatial_scale,
                "pooled_height": pooled_height,
                "pooled_width": pooled_width}, name=name)["Out"]


def mine_hard_examples(cls_loss, match_indices, match_dist, loc_loss=None,
                       neg_pos_ratio=3.0, neg_dist_threshold=0.5,
                       sample_size=0, mining_type="max_negative", name=None):
    s = _shape(match_indices)
    o = _op("mine_hard_examples",
            {"ClsLoss": cls_loss, "LocLoss": loc_loss,
             "MatchIndices": match_indices, "MatchDist": match_dist},
            {"NegIndices": ("int32", s),
             "UpdatedMatchIndices": ("int32", s)},
            {"neg_pos_ratio": neg_pos_ratio,
             "neg_dist_threshold": neg_dist_threshold,
             "sample_size": sample_size, "mining_type": mining_type},
            name=name)
    return o["NegIndices"], o["UpdatedMatchIndices"]


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     name=None):
    """SSD head: decode loc deltas against priors then multiclass NMS
    (parity: layers/detection.py detection_output)."""
    raise NotImplementedError(
        "detection_output: layers.detection (box_coder) waits (ROADMAP "
        "Queue 1 item 3)")


def deformable_conv(input, offset, mask, num_filters, filter_size, stride=1,
                    padding=0, dilation=1, groups=1, deformable_groups=1,
                    im2col_step=1, param_attr=None, bias_attr=None,
                    modulated=True, name=None):
    helper = LayerHelper("deformable_conv", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    k = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size, filter_size)
    s = stride if isinstance(stride, (list, tuple)) else (stride, stride)
    p = padding if isinstance(padding, (list, tuple)) else (padding, padding)
    d = dilation if isinstance(dilation, (list, tuple)) \
        else (dilation, dilation)
    cin = _shape(input)[1]
    w = helper.create_parameter(
        helper.param_attr(), [num_filters, cin // groups, k[0], k[1]],
        input.dtype)
    Ho = _shape(offset)[2]
    Wo = _shape(offset)[3]
    o = helper.create_variable_for_type_inference(
        input.dtype, (_shape(input)[0], num_filters, Ho, Wo))
    ins = {"Input": [input], "Offset": [offset], "Filter": [w]}
    if modulated and mask is not None:
        ins["Mask"] = [mask]
    helper.append_op(
        type="deformable_conv" if modulated else "deformable_conv_v1",
        inputs=ins, outputs={"Output": [o]},
        attrs={"strides": list(s), "paddings": list(p),
               "dilations": list(d), "groups": groups,
               "deformable_groups": deformable_groups,
               "im2col_step": im2col_step})
    return o


# -- misc --------------------------------------------------------------------

def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    B = _shape(input)[0]
    o = _op("edit_distance",
            {"Hyps": input, "Refs": label, "HypsLength": input_length,
             "RefsLength": label_length},
            {"Out": ("float32", (B, 1)), "SequenceNum": ("int32", ())},
            {"normalized": normalized}, name=name)
    return o["Out"], o["SequenceNum"]


def mean_iou(input, label, num_classes, name=None):
    o = _op("mean_iou", {"Predictions": input, "Labels": label},
            {"MeanIou": ("float32", ()), "OutWrong": ("int32", (num_classes,)),
             "OutCorrect": ("int32", (num_classes,))},
            {"num_classes": num_classes}, name=name)
    return o["MeanIou"], o["OutWrong"], o["OutCorrect"]


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None, name=None):
    o = _op("chunk_eval",
            {"Inference": input, "Label": label, "SeqLength": seq_length},
            {"Precision": ("float32", ()), "Recall": ("float32", ()),
             "F1": ("float32", ()), "NumInferChunks": ("int32", ()),
             "NumLabelChunks": ("int32", ()),
             "NumCorrectChunks": ("int32", ())},
            {"chunk_scheme": chunk_scheme, "num_chunk_types": num_chunk_types,
             "excluded_chunk_types": excluded_chunk_types or []}, name=name)
    return (o["Precision"], o["Recall"], o["F1"], o["NumInferChunks"],
            o["NumLabelChunks"], o["NumCorrectChunks"])


def affine_grid(theta, out_shape, name=None):
    shape = [int(s) for s in out_shape] if not hasattr(out_shape, "dtype") \
        else None
    N = _shape(theta)[0]
    H, W = (shape[2], shape[3]) if shape else (-1, -1)
    return _op("affine_grid", {"Theta": theta},
               {"Output": ("float32", (N, H, W, 2))},
               {"output_shape": shape or []}, name=name)["Output"]


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    helper = LayerHelper("spectral_norm", name=name)
    s = _shape(weight)
    h = s[dim]
    w = int(np.prod(s)) // h if s else 1
    u = helper.create_parameter(helper.param_attr(), [h], "float32",
                                suffix="u")
    v = helper.create_parameter(helper.param_attr(), [w], "float32",
                                suffix="v")
    o = helper.create_variable_for_type_inference("float32", s)
    helper.append_op(type="spectral_norm",
                     inputs={"Weight": [weight], "U": [u], "V": [v]},
                     outputs={"Out": [o]},
                     attrs={"dim": dim, "power_iters": power_iters,
                            "eps": eps})
    return o


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    M, N = _shape(x)[-1], _shape(y)[-1]
    w = helper.create_parameter(helper.param_attr(), [size, M, N], x.dtype)
    b = helper.create_parameter(helper.param_attr(is_bias=True), [1, size],
                                x.dtype, is_bias=True)
    o = helper.create_variable_for_type_inference(x.dtype,
                                                  (_shape(x)[0], size))
    ins = {"X": [x], "Y": [y], "Weight": [w]}
    if b is not None:
        ins["Bias"] = [b]
    helper.append_op(type="bilinear_tensor_product", inputs=ins,
                     outputs={"Out": [o]})
    return helper.append_activation(o)


def cos_sim(X, Y, name=None):
    B = _shape(X)[0]
    o = _op("cos_sim", {"X": X, "Y": Y},
            {"Out": ("float32", (B, 1)), "XNorm": ("float32", (B, 1)),
             "YNorm": ("float32", (_shape(Y)[0], 1))}, name=name)
    return o["Out"]


def unique(x, dtype="int32", name=None):
    n = _shape(x)[0] if _shape(x) else 1
    o = _op("unique", {"X": x},
            {"Out": (x.dtype, (n,)), "Index": (dtype, (n,))},
            {"dtype": dtype}, name=name)
    return o["Out"], o["Index"]


def size(input, name=None):
    return _op("size", {"Input": input}, {"Out": ("int32", ())},
               name=name)["Out"]


def crop_tensor(x, shape=None, offsets=None, name=None):
    out_shape = tuple(shape) if isinstance(shape, (list, tuple)) else _shape(x)
    return _op("crop_tensor", {"X": x},
               {"Out": (x.dtype, out_shape)},
               {"shape": list(shape) if isinstance(shape, (list, tuple))
                else [], "offsets": list(offsets) if offsets else None},
               name=name)["Out"]


def crop(x, shape=None, offsets=None, name=None):
    return crop_tensor(x, shape=shape, offsets=offsets, name=name)


def add_position_encoding(input, alpha, beta, name=None):
    return _op("add_position_encoding", {"X": input},
               {"Out": (input.dtype, _shape(input))},
               {"alpha": alpha, "beta": beta}, name=name)["Out"]


def random_crop(x, shape, seed=None, name=None):
    lead = _shape(x)[:len(_shape(x)) - len(shape)]
    o = _op("random_crop", {"X": x},
            {"Out": (x.dtype, tuple(lead) + tuple(shape)),
             "SeedOut": ("int32", ())},
            {"shape": list(shape), "seed": seed or 0}, name=name)
    return o["Out"]


def hash(input, hash_size, num_hash=1, name=None):
    n = _shape(input)[0]
    return _op("hash", {"X": input},
               {"Out": ("int32", (n, num_hash, 1))},
               {"mod_by": hash_size, "num_hash": num_hash}, name=name)["Out"]


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _op("teacher_student_sigmoid_loss",
               {"X": input, "Label": label},
               {"Y": ("float32", _shape(input))})["Y"]


def fsp_matrix(x, y, name=None):
    return _op("fsp", {"X": x, "Y": y},
               {"Out": ("float32", (_shape(x)[0], _shape(x)[1],
                                    _shape(y)[1]))}, name=name)["Out"]


def shuffle_channel(x, group, name=None):
    return _op("shuffle_channel", {"X": x}, {"Out": (x.dtype, _shape(x))},
               {"group": group}, name=name)["Out"]


def space_to_depth(x, blocksize, name=None):
    n, c, h, w = _shape(x)
    return _op("space_to_depth", {"X": x},
               {"Out": (x.dtype, (n, c * blocksize * blocksize,
                                  h // blocksize, w // blocksize))},
               {"blocksize": blocksize}, name=name)["Out"]


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _op("temporal_shift", {"X": x}, {"Out": (x.dtype, _shape(x))},
               {"seg_num": seg_num, "shift_ratio": shift_ratio},
               name=name)["Out"]


def strided_slice(input, axes, starts, ends, strides, name=None):
    return _op("strided_slice", {"Input": input},
               {"Out": (input.dtype, tuple([-1] * len(_shape(input))))},
               {"axes": list(axes), "starts": list(starts),
                "ends": list(ends), "strides": list(strides)},
               name=name)["Out"]


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _op("pad_constant_like", {"X": x, "Y": y},
               {"Out": (y.dtype, _shape(x))}, {"pad_value": pad_value},
               name=name)["Out"]


def multiplex(inputs, index, name=None):
    return _op("multiplex", {"X": list(inputs), "Ids": index},
               {"Out": (inputs[0].dtype, _shape(inputs[0]))},
               name=name)["Out"]


def log_loss(input, label, epsilon=1e-4, name=None):
    return _op("log_loss", {"Predicted": input, "Labels": label},
               {"Loss": ("float32", _shape(input))},
               {"epsilon": epsilon}, name=name)["Loss"]


def rank_loss(label, left, right, name=None):
    return _op("rank_loss", {"Label": label, "Left": left, "Right": right},
               {"Out": ("float32", _shape(label))}, name=name)["Out"]


def bpr_loss(input, label, name=None):
    return _op("bpr_loss", {"X": input, "Label": label},
               {"Loss": ("float32", (_shape(input)[0], 1))}, name=name)["Loss"]


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    helper = LayerHelper("center_loss", param_attr=param_attr)
    D = _shape(input)[-1]
    centers = helper.create_parameter(helper.param_attr(),
                                      [num_classes, D], input.dtype,
                                      suffix="centers")
    loss = helper.create_variable_for_type_inference(
        input.dtype, (_shape(input)[0], 1))
    sdiff = helper.create_variable_for_type_inference(input.dtype,
                                                      _shape(input))
    cout = helper.create_variable_for_type_inference(input.dtype,
                                                     (num_classes, D))
    from . import tensor as T

    alpha_var = T.fill_constant([1], "float32", alpha)
    helper.append_op(
        type="center_loss",
        inputs={"X": [input], "Label": [label], "Centers": [centers],
                "CenterUpdateRate": [alpha_var]},
        outputs={"Loss": [loss], "SampleCenterDiff": [sdiff],
                 "CentersOut": [centers if update_center else cout]},
        attrs={"cluster_num": num_classes, "lambda": 1.0,
               "need_update": update_center})
    return loss


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=False, slot_dim=-1):
    helper = LayerHelper("data_norm", param_attr=param_attr, act=act,
                         name=name)
    D = _shape(input)[-1]
    bsize = helper.create_parameter(helper.param_attr(), [D], "float32",
                                    suffix="batch_size")
    bsum = helper.create_parameter(helper.param_attr(), [D], "float32",
                                   suffix="batch_sum")
    bsq = helper.create_parameter(helper.param_attr(), [D], "float32",
                                  suffix="batch_square_sum")
    o = helper.create_variable_for_type_inference(input.dtype, _shape(input))
    means = helper.create_variable_for_type_inference("float32", (D,))
    scales = helper.create_variable_for_type_inference("float32", (D,))
    helper.append_op(type="data_norm",
                     inputs={"X": [input], "BatchSize": [bsize],
                             "BatchSum": [bsum], "BatchSquareSum": [bsq]},
                     outputs={"Y": [o], "Means": [means], "Scales": [scales]},
                     attrs={"epsilon": epsilon})
    return helper.append_activation(o)


def resize_trilinear(input, out_shape=None, scale=None, name=None,
                     actual_shape=None, align_corners=True, align_mode=1):
    n, c = _shape(input)[0], _shape(input)[1]
    if out_shape:
        d, h, w = out_shape
    else:
        d = h = w = -1
    return _op("trilinear_interp", {"X": input},
               {"Out": (input.dtype, (n, c, d, h, w))},
               {"out_d": d, "out_h": h, "out_w": w,
                "align_corners": align_corners, "align_mode": align_mode},
               name=name)["Out"]


def scatter_nd(index, updates, shape, name=None):
    return _op("scatter_nd", {"Index": index, "Updates": updates},
               {"Out": (updates.dtype, tuple(shape))},
               {"shape": list(shape)}, name=name)["Out"]


def scatter_nd_add(ref, index, updates, name=None):
    return _op("scatter_nd_add",
               {"X": ref, "Index": index, "Updates": updates},
               {"Out": (ref.dtype, _shape(ref))}, name=name)["Out"]


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    return _op("shard_index", {"X": input},
               {"Out": (input.dtype, _shape(input))},
               {"index_num": index_num, "nshards": nshards,
                "shard_id": shard_id, "ignore_value": ignore_value})["Out"]


def isfinite(x, name=None):
    return _op("isfinite", {"X": x}, {"Out": ("bool", ())}, name=name)["Out"]


def has_inf(x, name=None):
    return _op("isinf", {"X": x}, {"Out": ("bool", ())}, name=name)["Out"]


def has_nan(x, name=None):
    return _op("isnan", {"X": x}, {"Out": ("bool", ())}, name=name)["Out"]


def im2sequence(input, filter_size=1, stride=1, padding=0, input_image_size=None,
                out_stride=1, name=None):
    k = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size, filter_size)
    return _op("im2sequence", {"X": input},
               {"Out": (input.dtype, (-1, int(np.prod(k)) * _shape(input)[1]))},
               {"kernels": list(k),
                "strides": list(stride) if isinstance(stride, (list, tuple))
                else [stride, stride],
                "paddings": list(padding) if isinstance(padding, (list, tuple))
                else [padding, padding, padding, padding]}, name=name)["Out"]


def lod_reset(x, y=None, target_lod=None):
    return _op("lod_reset", {"X": x, "Y": y},
               {"Out": (x.dtype, _shape(x))},
               {"target_lod": target_lod or []})["Out"]


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    D = _shape(input)[-1]
    w = helper.create_parameter(helper.param_attr(),
                                [future_context_size + 1, D], input.dtype)
    o = helper.create_variable_for_type_inference(input.dtype, _shape(input))
    helper.append_op(type="row_conv", inputs={"X": [input], "Filter": [w]},
                     outputs={"Out": [o]})
    return helper.append_activation(o)


def soft_relu(x, threshold=40.0, name=None):
    return _op("soft_relu", {"X": x}, {"Out": (x.dtype, _shape(x))},
               {"threshold": threshold}, name=name)["Out"]


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _op("stanh", {"X": x}, {"Out": (x.dtype, _shape(x))},
               {"scale_a": scale_a, "scale_b": scale_b}, name=name)["Out"]


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Parity: layers/nn.py py_func — a host-Python op: ``func`` gets the
    inputs as numpy arrays on the host.  ``out`` must be vars made
    beforehand (create_variable_for_type_inference) whose shapes and
    dtypes declare the results.  Like the JAX package's, it has no
    gradient (``backward_func`` is accepted and unused)."""
    from ..ops.misc_ops4 import register_py_func
    from ..framework import default_main_program

    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    fid = register_py_func(func)
    block = default_main_program().global_block()
    block.append_op(type="py_func", inputs={"X": list(xs)},
                    outputs={"Out": list(outs)},
                    attrs={"forward_callable_id": fid,
                           "out_shapes": [list(_shape(o)) for o in outs],
                           "out_dtypes": [str(o.dtype) for o in outs]})
    return out


def get_tensor_from_selected_rows(x, name=None):
    return _op("get_tensor_from_selected_rows", {"X": x},
               {"Out": ("float32", _shape(x))}, name=name)["Out"]


def merge_selected_rows(x, name=None):
    return _op("merge_selected_rows", {"X": x},
               {"Out": ("float32", _shape(x))}, name=name)["Out"]


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    return _op("uniform_random_batch_size_like", {"Input": input},
               {"Out": (dtype, tuple(shape))},
               {"shape": list(shape), "input_dim_idx": input_dim_idx,
                "output_dim_idx": output_dim_idx, "min": min, "max": max,
                "seed": seed, "dtype": dtype})["Out"]


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    return _op("gaussian_random_batch_size_like", {"Input": input},
               {"Out": (dtype, tuple(shape))},
               {"shape": list(shape), "input_dim_idx": input_dim_idx,
                "output_dim_idx": output_dim_idx, "mean": mean, "std": std,
                "seed": seed, "dtype": dtype})["Out"]


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0,
                       name=None):
    """argmax over classes then ctc_align (merge repeated, drop blanks) —
    layers/nn.py ctc_greedy_decoder."""
    from .tensor import argmax

    ids = argmax(input, axis=-1)
    B, T = _shape(ids)[0], _shape(ids)[1]
    o = _op("ctc_align", {"Input": ids, "InputLength": input_length},
            {"Output": ("int32", (B, T)), "OutputLength": ("int32", (B, 1))},
            {"blank": blank, "merge_repeated": True,
             "padding_value": padding_value}, name=name)
    return o["Output"], o["OutputLength"]


def linear_chain_crf(input, label, param_attr=None, length=None):
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    C = _shape(input)[-1]
    w = helper.create_parameter(helper.param_attr(), [C + 2, C], "float32")
    B = _shape(input)[0]
    alpha = helper.create_variable_for_type_inference("float32", _shape(input))
    emission = helper.create_variable_for_type_inference("float32",
                                                         _shape(input))
    transition = helper.create_variable_for_type_inference("float32",
                                                           (C + 2, C))
    ll = helper.create_variable_for_type_inference("float32", (B, 1))
    ins = {"Emission": [input], "Label": [label], "Transition": [w]}
    if length is not None:
        ins["Length"] = [length]
    helper.append_op(type="linear_chain_crf", inputs=ins,
                     outputs={"Alpha": [alpha],
                              "EmissionExps": [emission],
                              "TransitionExps": [transition],
                              "LogLikelihood": [ll]})
    return ll


def crf_decoding(input, param_attr, label=None, length=None):
    helper = LayerHelper("crf_decoding", param_attr=param_attr)
    C = _shape(input)[-1]
    w = helper.create_parameter(helper.param_attr(), [C + 2, C], "float32")
    B, T = _shape(input)[0], _shape(input)[1]
    o = helper.create_variable_for_type_inference("int32", (B, T))
    ins = {"Emission": [input], "Transition": [w]}
    if label is not None:
        ins["Label"] = [label]
    if length is not None:
        ins["Length"] = [length]
    helper.append_op(type="crf_decoding", inputs=ins,
                     outputs={"ViterbiPath": [o]})
    return o


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv3d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    k = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size,) * 3
    cin = _shape(input)[1]
    w = helper.create_parameter(helper.param_attr(),
                                [cin, num_filters, k[0], k[1], k[2]],
                                input.dtype)
    o = helper.create_variable_for_type_inference(
        input.dtype, (_shape(input)[0], num_filters, -1, -1, -1))
    s = stride if isinstance(stride, (list, tuple)) else (stride,) * 3
    p = padding if isinstance(padding, (list, tuple)) else (padding,) * 3
    d = dilation if isinstance(dilation, (list, tuple)) else (dilation,) * 3
    helper.append_op(type="conv3d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [o]},
                     attrs={"strides": list(s), "paddings": list(p),
                            "dilations": list(d), "groups": groups})
    return helper.append_activation(o)


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    n, c = _shape(input)[0], _shape(input)[1]
    k = pool_size if isinstance(pool_size, (list, tuple)) else [pool_size] * 3
    return _op("pool3d", {"X": input},
               {"Out": (input.dtype, (n, c, k[0], k[1], k[2]))},
               {"pooling_type": pool_type, "ksize": list(k),
                "adaptive": True}, name=name)["Out"]


# -- compositions ------------------------------------------------------------

def mse_loss(input, label):
    from .nn import mean, square_error_cost

    return mean(square_error_cost(input, label))


def dice_loss(input, label, epsilon=1e-5):
    """Parity: layers/nn.py dice_loss — 1 - 2*|X n Y| / (|X| + |Y|)."""
    from . import tensor as T
    from .math_ops import (elementwise_add, elementwise_div,
                           elementwise_mul, elementwise_sub, scale)
    from .nn import reduce_sum

    label_oh = T.one_hot(label, _shape(input)[-1])
    inter = reduce_sum(elementwise_mul(input, label_oh))
    union = elementwise_add(reduce_sum(input), reduce_sum(label_oh))
    one = T.fill_constant([1], "float32", 1.0)
    eps = T.fill_constant([1], "float32", epsilon)
    return elementwise_sub(
        one, elementwise_div(scale(inter, 2.0),
                             elementwise_add(union, eps)))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Parity: layers/nn.py npair_loss — similarity CE + L2 reg term."""
    from .math_ops import elementwise_add, elementwise_mul, scale
    from .nn import (matmul, mean, reduce_sum, softmax_with_cross_entropy,
                     transpose)

    sim = matmul(anchor, transpose(positive, [1, 0]))
    ce = softmax_with_cross_entropy(sim, labels, soft_label=False)
    l2 = scale(elementwise_add(reduce_sum(elementwise_mul(anchor, anchor)),
                               reduce_sum(elementwise_mul(positive,
                                                          positive))),
               l2_reg * 0.25)
    return elementwise_add(mean(ce), l2)


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    from .nn import image_resize

    n, c, h, w = _shape(input)
    short = min(h, w) if h > 0 and w > 0 else out_short_len
    ratio = out_short_len / max(short, 1)
    return image_resize(input, out_shape=[int(h * ratio), int(w * ratio)],
                        resample=resample)


def ones_like(x, out=None):
    return _op("fill_any_like", {"X": x}, {"Out": (x.dtype, _shape(x))},
               {"value": 1.0})["Out"]


def rank(input):
    from . import tensor as T

    return T.fill_constant([1], "int32", len(_shape(input)))


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None,
                   act=None):
    o = _op("affine_channel", {"X": x, "Scale": scale, "Bias": bias},
            {"Out": (x.dtype, _shape(x))},
            {"data_layout": data_layout}, name=name)["Out"]
    helper = LayerHelper("affine_channel", act=act, name=name)
    return helper.append_activation(o)


def lod_append(x, level):
    return x


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    from . import tensor as T
    from ..framework import default_main_program

    block = default_main_program().global_block()
    name = counter_name or "@STEP_COUNTER@"
    if name in block.vars:
        counter = block.vars[name]
    else:
        counter = T.create_global_var([1], float(begin - step), "float32",
                                      persistable=True, name=name)
    block.append_op(type="increment", inputs={"X": [counter]},
                    outputs={"Out": [counter]}, attrs={"step": float(step)})
    return counter


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    helper = LayerHelper("create_parameter", param_attr=attr, name=name)
    return helper.create_parameter(helper.param_attr(is_bias=is_bias),
                                   list(shape), dtype,
                                   default_initializer=default_initializer)


# sequence-layer aliases over the padded-batch sequence ops
def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, name=None, seq_len=None):
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    D = _shape(input)[-1]
    w = helper.create_parameter(helper.param_attr(),
                                [filter_size * D, num_filters], input.dtype)
    o = helper.create_variable_for_type_inference(
        input.dtype, _shape(input)[:-1] + (num_filters,))
    ins = {"X": [input], "Filter": [w]}
    if seq_len is not None:
        ins["SeqLen"] = [seq_len]
    helper.append_op(type="sequence_conv", inputs=ins,
                     outputs={"Out": [o]},
                     attrs={"contextLength": filter_size,
                            "contextStart": padding_start
                            if padding_start is not None
                            else -(filter_size // 2),
                            "contextStride": filter_stride})
    b = helper.create_parameter(helper.param_attr(is_bias=True),
                                [num_filters], input.dtype, is_bias=True)
    if b is not None:
        from .math_ops import elementwise_add

        o = elementwise_add(o, b)
    return helper.append_activation(o)


def sequence_enumerate(input, win_size, pad_value=0, name=None, seq_len=None):
    o = _op("sequence_enumerate",
            {"X": input, "SeqLen": seq_len},
            {"Out": (input.dtype, _shape(input) + (win_size,))},
            {"win_size": win_size, "pad_value": pad_value}, name=name)
    return o["Out"]


def sequence_expand(x, y, ref_level=-1, name=None):
    k = _shape(y)[1] if len(_shape(y)) > 1 else 1
    return _op("sequence_expand", {"X": x, "Y": y},
               {"Out": (x.dtype, (-1,) + tuple(_shape(x)[1:]))},
               {"ref_level": ref_level}, name=name)["Out"]


def sequence_pad(x, pad_value, maxlen=None, name=None, seq_len=None):
    o = _op("sequence_pad", {"X": x, "SeqLen": seq_len},
            {"Out": (x.dtype, _shape(x)), "Length": ("int64", (-1,))},
            name=name)
    return o["Out"], o["Length"]


def sequence_unpad(x, length, name=None):
    o = _op("sequence_unpad", {"X": x, "Length": length},
            {"Out": (x.dtype, _shape(x)), "SeqLen": ("int64", (-1,))},
            name=name)
    return o["Out"]


def sequence_reshape(input, new_dim):
    return _op("sequence_reshape", {"X": input},
               {"Out": (input.dtype, (-1, new_dim))},
               {"new_dim": new_dim})["Out"]


def sequence_scatter(input, index, updates, name=None, seq_len=None):
    return _op("sequence_scatter",
               {"X": input, "Ids": index, "Updates": updates,
                "SeqLen": seq_len},
               {"Out": (input.dtype, _shape(input))}, name=name)["Out"]


def sequence_slice(input, offset, length, name=None):
    return _op("sequence_slice",
               {"X": input, "Offset": offset, "Length": length},
               {"Out": (input.dtype, _shape(input))}, name=name)["Out"]


# -- decode-time / remaining surface ----------------------------------------

def Print(input, first_n=-1, message=None, summarize=20, print_tensor_name=True,
          print_tensor_type=True, print_tensor_shape=True,
          print_tensor_lod=True, print_phase="both"):
    """Parity: layers/control_flow.py Print (print op)."""
    _op("print", {"In": input}, {"Out": (input.dtype, _shape(input))},
        {"first_n": first_n, "message": message or "",
         "summarize": summarize})
    return input


def logical_xor(x, y, out=None, name=None):
    return _op("logical_xor", {"X": x, "Y": y},
               {"Out": ("bool", _shape(x))}, name=name)["Out"]


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """Parity: layers/nn.py beam_search over beam_search_op.cc."""
    B, K = _shape(pre_ids)[0], beam_size
    o = _op("beam_search",
            {"pre_ids": pre_ids, "pre_scores": pre_scores, "ids": ids,
             "scores": scores},
            {"selected_ids": ("int64", (B, K)),
             "selected_scores": ("float32", (B, K)),
             "parent_idx": ("int32", (B, K))},
            {"beam_size": beam_size, "end_id": end_id,
             "is_accumulated": is_accumulated}, name=name)
    if return_parent_idx:
        return o["selected_ids"], o["selected_scores"], o["parent_idx"]
    return o["selected_ids"], o["selected_scores"]


def beam_search_decode(ids, scores, beam_size, end_id, name=None):
    o = _op("beam_search_decode", {"Ids": ids, "Scores": scores},
            {"SentenceIds": ("int64", (-1, beam_size, -1)),
             "SentenceScores": ("float32", (-1, beam_size))},
            {"beam_size": beam_size, "end_id": end_id}, name=name)
    return o["SentenceIds"], o["SentenceScores"]


def gather_tree(ids, parents):
    return _op("gather_tree", {"Ids": ids, "Parents": parents},
               {"Out": (ids.dtype, _shape(ids))})["Out"]


def sigmoid_focal_loss(x, label, fg_num, gamma=2, alpha=0.25):
    return _op("sigmoid_focal_loss",
               {"X": x, "Label": label, "FgNum": fg_num},
               {"Out": ("float32", _shape(x))},
               {"gamma": gamma, "alpha": alpha})["Out"]


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    k = kernel_sizes if isinstance(kernel_sizes, (list, tuple)) \
        else [kernel_sizes] * 2
    s = strides if isinstance(strides, (list, tuple)) else [strides] * 2
    p = paddings if isinstance(paddings, (list, tuple)) else [paddings] * 4
    d = dilations if isinstance(dilations, (list, tuple)) else [dilations] * 2
    C = _shape(x)[1]
    return _op("unfold", {"X": x},
               {"Y": (x.dtype, (_shape(x)[0], C * k[0] * k[1], -1))},
               {"kernel_sizes": list(k), "strides": list(s),
                "paddings": list(p), "dilations": list(d)}, name=name)["Y"]


def continuous_value_model(input, cvm, use_cvm=True):
    D = _shape(input)[-1]
    return _op("cvm", {"X": input, "CVM": cvm},
               {"Y": (input.dtype, (_shape(input)[0],
                                    D if use_cvm else D - 2))},
               {"use_cvm": use_cvm})["Y"]


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """Parity: layers/nn.py lstm (the cudnn_lstm fused multi-layer LSTM,
    cudnn_lstm_op.cc) — composed from the lstm op per layer+direction;
    input [B, T, D].  is_bidirec runs a reversed second direction per layer
    and concatenates (cudnn's CUDNN_BIDIRECTIONAL mode)."""
    helper = LayerHelper("lstm", name=name)
    h = input
    D = hidden_size

    def one_direction(src, layer, tag, reverse):
        from .nn import matmul, reshape

        din = _shape(src)[-1]
        w = helper.create_parameter(
            helper.param_attr(), [din, 4 * D], input.dtype,
            suffix="w%d%s" % (layer, tag),
            default_initializer=default_initializer)
        wh = helper.create_parameter(
            helper.param_attr(), [D, 4 * D], input.dtype,
            suffix="wh%d%s" % (layer, tag),
            default_initializer=default_initializer)
        B, T = _shape(src)[0], _shape(src)[1]
        proj = reshape(matmul(reshape(src, [-1, din]), w), [-1, T, 4 * D])
        # the lstm op's own is_reverse handles the time flip (+unflip of
        # Hidden) — no sequence_reverse pair needed (ops/rnn_ops.py)
        return _op("lstm", {"Input": proj, "Weight": wh},
                   {"Hidden": (input.dtype, (B, T, D)),
                    "Cell": (input.dtype, (B, T, D)),
                    "LastHidden": (input.dtype, (B, D)),
                    "LastCell": (input.dtype, (B, D))},
                   {"is_reverse": reverse})

    for layer in range(num_layers):
        o = one_direction(h, layer, "", False)
        if is_bidirec:
            from .tensor import concat

            orev = one_direction(h, layer, "r", True)
            h = concat([o["Hidden"], orev["Hidden"]], axis=-1)
        else:
            h = o["Hidden"]
    if is_bidirec:
        # CUDNN_BIDIRECTIONAL returns both directions' final states
        from .tensor import concat

        return (h, concat([o["LastHidden"], orev["LastHidden"]], axis=-1),
                concat([o["LastCell"], orev["LastCell"]], axis=-1))
    return h, o["LastHidden"], o["LastCell"]


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=False, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None, seq_len=None):
    """Parity: layers/nn.py dynamic_lstmp over lstmp_op.cc."""
    helper = LayerHelper("dynamic_lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    D = size // 4
    P = proj_size
    w = helper.create_parameter(helper.param_attr(), [P, 4 * D], dtype)
    pw = helper.create_parameter(helper.param_attr(), [D, P], dtype,
                                 suffix="proj")
    b = helper.create_parameter(helper.param_attr(is_bias=True), [1, 4 * D],
                                dtype, is_bias=True)
    B, T = _shape(input)[0], _shape(input)[1]
    ins = {"Input": input, "Weight": w, "ProjWeight": pw, "Bias": b}
    if seq_len is not None:
        ins["SeqLen"] = seq_len
    o = _op("lstmp", ins,
            {"Projection": (dtype, (B, T, P)), "Cell": (dtype, (B, T, D)),
             "LastProjection": (dtype, (B, P)),
             "LastCell": (dtype, (B, D))},
            {"gate_activation": gate_activation,
             "cell_activation": cell_activation,
             "candidate_activation": candidate_activation,
             "proj_activation": proj_activation,
             "is_reverse": is_reverse, "use_peepholes": use_peepholes})
    return o["Projection"], o["Cell"]


def double_buffer(reader, place=None, name=None):
    """Parity: layers/io.py double_buffer — prefetch is built into the
    DataLoader/py_reader pipeline (reader.py device prefetch); passthrough."""
    return reader


def tensor_array_to_tensor(input, axis=1, name=None):
    """Parity: layers/tensor.py tensor_array_to_tensor — concat the array."""
    from . import tensor as T

    o = T.concat(list(input), axis=axis)
    sizes = T.fill_constant([len(input)], "int32", 1)
    return o, sizes


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1, max_depth=2,
              act="tanh", param_attr=None, bias_attr=None, name=None):
    """Tree-based convolution (ref layers/nn.py tree_conv over
    tree_conv_op.cc).  nodes_vector [B, N, F], edge_set [B, E, 2];
    returns [B, N, output_size, num_filters]."""
    helper = LayerHelper("tree_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    F = _shape(nodes_vector)[-1]
    B, N = _shape(nodes_vector)[0], _shape(nodes_vector)[1]
    w = helper.create_parameter(helper.param_attr(),
                                [F, 3, output_size, num_filters],
                                nodes_vector.dtype)
    o = helper.create_variable_for_type_inference(
        nodes_vector.dtype, (B, N, output_size, num_filters))
    helper.append_op(type="tree_conv",
                     inputs={"NodesVector": [nodes_vector],
                             "EdgeSet": [edge_set], "Filter": [w]},
                     outputs={"Out": [o]},
                     attrs={"max_depth": max_depth})
    b = helper.create_parameter(helper.param_attr(is_bias=True),
                                [num_filters], nodes_vector.dtype,
                                is_bias=True)
    if b is not None:
        from .math_ops import elementwise_add
        o = elementwise_add(o, b)
    return helper.append_activation(o)


def prroi_pool(input, rois, spatial_scale=1.0, pooled_height=1,
               pooled_width=1, batch_roi_nums=None, name=None):
    """Precise RoI pooling (ref layers/nn.py prroi_pool over
    prroi_pool_op.cc)."""
    N, C = _shape(input)[0], _shape(input)[1]
    R = _shape(rois)[0]
    ins = {"X": input, "ROIs": rois}
    if batch_roi_nums is not None:
        ins["BatchRoINums"] = batch_roi_nums
    return _op("prroi_pool", ins,
               {"Out": ("float32", (R, C, pooled_height, pooled_width))},
               {"spatial_scale": spatial_scale,
                "pooled_height": pooled_height,
                "pooled_width": pooled_width}, name=name)["Out"]


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True):
    """ref contrib filter_by_instag (filter_by_instag_op.cc); see the
    lowering's static-shape contract (ops/misc_ops5.py)."""
    B = _shape(ins)[0]
    o = _op("filter_by_instag",
            {"Ins": ins, "Ins_tag": ins_tag, "Filter_tag": filter_tag},
            {"Out": ("float32", _shape(ins)),
             "LossWeight": ("float32", (B, 1)),
             "IndexMap": ("int32", (B, 1))},
            {"is_lod": is_lod})
    return o["Out"], o["LossWeight"], o["IndexMap"]
