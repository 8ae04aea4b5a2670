"""Inputs for the op rules of ROADMAP Queue 1 item 3-B (tranches 1-3:
``ops/math_ops.py``, ``ops/nn_ops.py``, ``ops/tensor_ops.py``; tranche 4
with ``ctc_align`` and ``edit_distance``: ``RULE_CASES_4``), made with
numpy from fixed seeds, so that the CPU tests hold the port's rules to the
JAX package's on them and ``chip_smoke.py`` runs the same rules on the
card: one row a rule and setting, then the traps (bilinear shrinking,
which JAX antialiases; nearest at half-pixel centres; the 2-D ``p_norm``;
``isfinite``; negative ``strided_slice`` steps; ``gather_nd`` and
``scatter`` ids out of range; ``group_norm`` at N = 1; both ``gelu``
forms; ``kldiv_loss``'s four reductions), the inputs of ROADMAP Queue 3's
faults, and tranche 4's attribute edges.  ``cast_rows`` gives every row
with its float slots cast to int32 and to bool (Queue 3 entry 8).

A row is ``(id, op, ins, attrs, grad_slots, grad_out)``: ``ins`` maps each
input slot to a list of numpy arrays; the gradients are those of a seeded
cotangent against ``outs[grad_out][0]`` into ``grad_slots``.
"""

import numpy as np

__all__ = ["RULE_CASES", "RULE_CASES_4", "REFUSALS", "QUEUE3_ROWS",
           "COLLECTIVE_CASES", "cast_rows"]


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _r(seed, *shape, lo=-2.0, hi=2.0):
    """Uniform in [lo, hi), f32."""
    return (np.random.RandomState(seed).rand(*shape) * (hi - lo) + lo).astype(
        np.float32)


def _ints(seed, lo, hi, *shape, dtype=np.int64):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(dtype)


def _unary(op, x):
    return (op, op, {"X": [x]}, {}, ["X"], "Out")


# (id, op, ins, attrs, grad slots, grad output)
RULE_CASES = [
    # -- math_ops: binaries and unary functions ---------------------------
    ("floordiv_f32", "elementwise_floordiv",
     {"X": [_r(1, 3, 4, lo=-9, hi=9)], "Y": [_r(2, 3, 4, lo=0.5, hi=3)
                                            * np.sign(_r(3, 3, 4))]}, {}, [], None),
    ("floordiv_int", "elementwise_floordiv",
     {"X": [_ints(4, -9, 9, 3, 4, dtype=np.int32)],
      "Y": [np.array([3, -3, 2, 5], np.int32)]}, {}, [], None),
    ("min_axis", "elementwise_min",
     {"X": [np.round(_randn(5, 2, 3, 4))], "Y": [np.round(_randn(6, 3))]},
     {"axis": 1}, ["X", "Y"], "Out"),
    ("logical_xor", "logical_xor",
     {"X": [_ints(7, 0, 2, 4, 5).astype(bool)],
      "Y": [_ints(8, 0, 2, 4, 5).astype(bool)]}, {}, [], None),
    _unary("abs", _randn(9, 3, 5)),
    _unary("acos", _r(10, 3, 5, lo=-0.95, hi=0.95)),
    _unary("asin", _r(11, 3, 5, lo=-0.95, hi=0.95)),
    _unary("atan", _randn(12, 3, 5) * 3),
    _unary("ceil", _randn(13, 3, 5) * 3),
    _unary("cos", _randn(14, 3, 5) * 3),
    _unary("cosh", _randn(15, 3, 5)),
    _unary("erf", _randn(16, 3, 5)),
    _unary("exp", _randn(17, 3, 5)),
    _unary("log", _r(18, 3, 5, lo=0.05, hi=4)),
    _unary("log10", _r(19, 3, 5, lo=0.05, hi=4)),
    _unary("log1p", _r(20, 3, 5, lo=-0.9, hi=4)),
    _unary("log2", _r(21, 3, 5, lo=0.05, hi=4)),
    _unary("reciprocal", _r(22, 3, 5, lo=0.3, hi=3) * np.sign(_r(23, 3, 5))),
    ("round_halves", "round",
     {"X": [np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.4, -3.7], np.float32)]},
     {}, ["X"], "Out"),
    _unary("rsqrt", _r(24, 3, 5, lo=0.1, hi=4)),
    _unary("sin", _randn(25, 3, 5) * 3),
    _unary("sinh", _randn(26, 3, 5)),
    _unary("square", _randn(27, 3, 5)),
    _unary("tan", _r(28, 3, 5, lo=-1.2, hi=1.2)),
    ("abs_int", "abs", {"X": [_ints(29, -5, 5, 6, dtype=np.int32)]}, {}, [], None),
    ("ceil_int", "ceil", {"X": [_ints(29, -5, 5, 6, dtype=np.int32)]}, {}, [],
     None),
    # -- math_ops: products, pow, arg/sort, scans, tests, norms -----------
    ("matmul", "matmul", {"X": [_randn(30, 4, 5)], "Y": [_randn(31, 5, 3)]},
     {}, ["X", "Y"], "Out"),
    ("matmul_tx_ty_alpha", "matmul",
     {"X": [_randn(32, 2, 5, 4)], "Y": [_randn(33, 2, 3, 5)]},
     {"transpose_X": True, "transpose_Y": True, "alpha": 0.125},
     ["X", "Y"], "Out"),
    ("matmul_heads_bcast", "matmul",
     {"X": [_randn(34, 2, 3, 4, 8)], "Y": [_randn(35, 1, 3, 8, 4)]},
     {"transpose_Y": False, "alpha": 0.5}, ["X", "Y"], "Out"),
    ("matmul_vec", "matmul", {"X": [_randn(36, 3, 5)], "Y": [_randn(37, 5)]},
     {}, ["X", "Y"], "Out"),
    ("bmm", "bmm", {"X": [_randn(38, 3, 4, 5)], "Y": [_randn(39, 3, 5, 2)]},
     {}, ["X", "Y"], "Out"),
    ("pow_2", "pow", {"X": [_randn(40, 3, 4)]}, {"factor": 2.0}, ["X"], "Out"),
    ("pow_1_5", "pow", {"X": [_r(41, 3, 4, lo=0.1, hi=3)]}, {"factor": 1.5},
     ["X"], "Out"),
    ("pow_neg", "pow", {"X": [_r(42, 3, 4, lo=0.2, hi=3)]}, {"factor": -0.5},
     ["X"], "Out"),
    ("arg_max_ties_nan", "arg_max",
     {"X": [np.array([[1, 3, 3, 0], [2, np.nan, 5, np.nan], [4, 4, 4, 4]],
                     np.float32)]}, {"axis": 1}, [], None),
    ("arg_max_axis0", "arg_max", {"X": [_randn(43, 4, 5)]}, {"axis": 0}, [],
     None),
    ("arg_min_ties", "arg_min",
     {"X": [np.array([[1, 0, 0, 3], [2, 2, -1, -1]], np.float32)]}, {}, [], None),
    ("argsort_ties", "argsort",
     {"X": [np.round(_randn(44, 3, 7))]}, {"axis": -1}, ["X"], "Out"),
    ("argsort_desc_axis0", "argsort",
     {"X": [np.round(_randn(45, 6, 3))]}, {"axis": 0, "descending": True},
     ["X"], "Out"),
    ("argsort_nan", "argsort",
     {"X": [np.array([[3, np.nan, 1, 2, np.nan]], np.float32)]},
     {"descending": True}, [], None),
    ("cumsum", "cumsum", {"X": [_randn(46, 3, 6)]}, {"axis": 1}, ["X"], "Out"),
    ("cumsum_reverse", "cumsum", {"X": [_randn(47, 3, 6)]},
     {"axis": 1, "reverse": True}, ["X"], "Out"),
    ("cumsum_exclusive", "cumsum", {"X": [_randn(48, 4, 3)]},
     {"axis": 0, "exclusive": True}, ["X"], "Out"),
    ("cumsum_rev_excl", "cumsum", {"X": [_randn(49, 3, 5)]},
     {"reverse": True, "exclusive": True}, ["X"], "Out"),
    ("isnan", "isnan",
     {"X": [np.array([1, np.nan, np.inf, -np.inf, 0], np.float32)]}, {}, [], None),
    ("isinf", "isinf",
     {"X": [np.array([1, np.nan, np.inf, -np.inf, 0], np.float32)]}, {}, [], None),
    ("kron", "kron", {"X": [_randn(50, 2, 3)], "Y": [_randn(51, 3, 2)]}, {},
     ["X", "Y"], "Out"),
    ("kron_3d", "kron", {"X": [_randn(52, 2, 1, 2)], "Y": [_randn(53, 2, 2)]},
     {}, ["X", "Y"], "Out"),
    ("dot", "dot", {"X": [_randn(54, 4, 6)], "Y": [_randn(55, 4, 6)]}, {},
     ["X", "Y"], "Out"),
    ("p_norm_axis", "p_norm", {"X": [_randn(56, 3, 5)]},
     {"porder": 2.0, "axis": 1}, ["X"], "Out"),
    ("p_norm_p3_keep", "p_norm", {"X": [_randn(57, 3, 5)]},
     {"porder": 3.0, "axis": 0, "keepdim": True}, ["X"], "Out"),
    ("p_norm_p1", "p_norm", {"X": [_randn(58, 4, 3)]},
     {"porder": 1.0, "axis": -1}, ["X"], "Out"),
    ("p_norm_inf", "p_norm", {"X": [_randn(59, 4, 3)]},
     {"porder": float("inf"), "axis": -1}, ["X"], "Out"),
    ("p_norm_vector", "p_norm", {"X": [_randn(60, 7)]}, {}, ["X"], "Out"),
    # -- nn_ops: activations ---------------------------------------------
    ("relu6", "relu6", {"X": [np.r_[_r(61, 10, lo=-2, hi=8), 0.0, 6.0]
                              .astype(np.float32)]}, {}, ["X"], "Out"),
    ("relu6_threshold", "relu6", {"X": [_r(62, 3, 4, lo=-2, hi=5)]},
     {"threshold": 3.0}, ["X"], "Out"),
    ("logsigmoid", "logsigmoid", {"X": [_randn(63, 3, 5) * 6]}, {}, ["X"], "Out"),
    ("leaky_relu", "leaky_relu",
     {"X": [np.r_[_randn(64, 9), 0.0].astype(np.float32)]}, {"alpha": 0.1},
     ["X"], "Out"),
    ("elu", "elu", {"X": [np.r_[_randn(65, 9), 0.0].astype(np.float32)]},
     {"alpha": 0.7}, ["X"], "Out"),
    ("selu", "selu", {"X": [np.r_[_randn(66, 9), 0.0].astype(np.float32)]}, {},
     ["X"], "Out"),
    ("softplus", "softplus", {"X": [_randn(67, 3, 5) * 8]}, {}, ["X"], "Out"),
    ("softsign", "softsign", {"X": [_randn(68, 3, 5) * 3]}, {}, ["X"], "Out"),
    ("softshrink", "softshrink", {"X": [_randn(69, 3, 5)]}, {"lambda": 0.4},
     ["X"], "Out"),
    ("hard_shrink", "hard_shrink", {"X": [_randn(70, 3, 5)]},
     {"threshold": 0.3}, ["X"], "Out"),
    ("hard_sigmoid", "hard_sigmoid", {"X": [_randn(71, 3, 5) * 4]}, {},
     ["X"], "Out"),
    ("hard_swish", "hard_swish", {"X": [_randn(72, 3, 5) * 4]}, {}, ["X"], "Out"),
    ("swish", "swish", {"X": [_randn(73, 3, 5) * 3]}, {"beta": 1.5}, ["X"],
     "Out"),
    ("mish", "mish", {"X": [_randn(74, 3, 5) * 3]}, {}, ["X"], "Out"),
    ("thresholded_relu", "thresholded_relu", {"X": [_randn(75, 3, 5) * 2]},
     {"threshold": 0.5}, ["X"], "Out"),
    ("stanh", "stanh", {"X": [_randn(76, 3, 5) * 2]}, {}, ["X"], "Out"),
    ("brelu", "brelu", {"X": [_randn(77, 3, 5) * 10]},
     {"t_min": -1.0, "t_max": 4.0}, ["X"], "Out"),
    ("prelu_all", "prelu", {"X": [_randn(78, 2, 3, 4)],
                            "Alpha": [np.array([0.25], np.float32)]},
     {"mode": "all"}, ["X", "Alpha"], "Out"),
    ("prelu_channel", "prelu", {"X": [_randn(79, 2, 3, 2, 2)],
                                "Alpha": [_r(80, 3, lo=0, hi=1)]},
     {"mode": "channel"}, ["X", "Alpha"], "Out"),
    ("log_softmax", "log_softmax", {"X": [_randn(81, 3, 7) * 3]}, {},
     ["X"], "Out"),
    ("log_softmax_axis1", "log_softmax", {"X": [_randn(82, 2, 5, 3)]},
     {"axis": 1}, ["X"], "Out"),
    # -- nn_ops: convolutions --------------------------------------------
    ("depthwise_conv2d", "depthwise_conv2d",
     {"Input": [_randn(83, 2, 4, 7, 6)], "Filter": [_randn(84, 4, 1, 3, 3)]},
     {"strides": [1, 2], "paddings": [1, 1], "groups": 1},
     ["Input", "Filter"], "Output"),
    ("conv2d_transpose", "conv2d_transpose",
     {"Input": [_randn(85, 2, 3, 4, 5)], "Filter": [_randn(86, 3, 2, 3, 3)]},
     {"strides": [2, 2], "paddings": [1, 0]}, ["Input", "Filter"], "Output"),
    ("conv2d_transpose_dil", "conv2d_transpose",
     {"Input": [_randn(87, 1, 2, 4, 4)], "Filter": [_randn(88, 2, 3, 2, 2)]},
     {"strides": [1, 2], "paddings": [0, 1], "dilations": [2, 1],
      "output_size": [99, 99]}, ["Input", "Filter"], "Output"),
    ("conv3d", "conv3d",
     {"Input": [_randn(89, 1, 4, 4, 5, 5)], "Filter": [_randn(90, 4, 2, 2, 3, 3)]},
     {"strides": [1, 2, 1], "paddings": [1, 0, 1], "groups": 2},
     ["Input", "Filter"], "Output"),
    # -- nn_ops: norms ---------------------------------------------------
    ("layer_norm", "layer_norm",
     {"X": [_randn(91, 2, 3, 8) * 3 + 1], "Scale": [_randn(92, 8)],
      "Bias": [_randn(93, 8)]}, {"begin_norm_axis": 2},
     ["X", "Scale", "Bias"], "Y"),
    ("layer_norm_axis1_noaffine", "layer_norm",
     {"X": [_randn(94, 3, 2, 4)]}, {"begin_norm_axis": 1, "epsilon": 1e-3},
     ["X"], "Y"),
    ("group_norm", "group_norm",
     {"X": [_randn(95, 2, 6, 3, 2)], "Scale": [_randn(96, 6)],
      "Bias": [_randn(97, 6)]}, {"groups": 3}, ["X", "Scale", "Bias"], "Y"),
    ("group_norm_n1", "group_norm",
     {"X": [_randn(98, 1, 4, 3, 3)], "Scale": [_randn(99, 4)],
      "Bias": [_randn(100, 4)]}, {"groups": 2}, ["X", "Scale"], "Y"),
    ("instance_norm", "instance_norm",
     {"X": [_randn(101, 2, 3, 4, 3)], "Scale": [_randn(102, 3)],
      "Bias": [_randn(103, 3)]}, {}, ["X", "Scale", "Bias"], "Y"),
    ("l2_normalize", "l2_normalize", {"X": [_randn(104, 3, 5)]}, {"axis": 1},
     ["X"], "Out"),
    ("l2_normalize_axis0", "l2_normalize", {"X": [_randn(105, 4, 2, 3)]},
     {"axis": 0}, ["X"], "Norm"),
    # -- nn_ops: losses --------------------------------------------------
    ("huber_loss", "huber_loss", {"X": [_randn(106, 6, 1) * 2],
                                  "Y": [_randn(107, 6, 1) * 2]},
     {"delta": 1.0}, ["X", "Y"], "Out"),
    ("smooth_l1_loss", "smooth_l1_loss", {"X": [_randn(108, 4, 3, 2)],
                                          "Y": [_randn(109, 4, 3, 2)]},
     {"sigma": 2.0}, ["X", "Y"], "Out"),
    ("smooth_l1_loss_1d", "smooth_l1_loss", {"X": [_randn(110, 5)],
                                             "Y": [_randn(111, 5)]},
     {}, ["X", "Y"], "Out"),
    ("label_smooth", "label_smooth",
     {"X": [np.eye(5, dtype=np.float32)[[0, 3, 1]]],
      "PriorDist": [np.full((1, 5), 0.2, np.float32)]}, {"epsilon": 0.2},
     ["X"], "Out"),
    ("margin_rank_loss", "margin_rank_loss",
     {"X1": [_randn(112, 6, 1)], "X2": [_randn(113, 6, 1)],
      "Label": [np.sign(_randn(114, 6, 1))]}, {"margin": 0.1},
     ["X1", "X2"], "Out"),
    # -- nn_ops: resizes and the rest ------------------------------------
    ("interp_bilinear_up", "interpolate", {"X": [_randn(115, 2, 3, 4, 5)]},
     {"out_h": 7, "out_w": 9, "interp_method": "bilinear",
      "align_corners": True}, ["X"], "Out"),
    ("interp_bilinear_down", "interpolate", {"X": [_randn(116, 1, 2, 4, 4)]},
     {"out_h": 2, "out_w": 2, "interp_method": "bilinear"}, ["X"], "Out"),
    ("interp_bilinear_mixed", "bilinear_interp", {"X": [_randn(117, 1, 2, 9, 4)]},
     {"out_h": 4, "out_w": 7, "interp_method": "bilinear"}, ["X"], "Out"),
    ("interp_nearest_up", "nearest_interp", {"X": [_randn(118, 1, 2, 4, 4)]},
     {"out_h": 7, "out_w": 6, "interp_method": "nearest"}, ["X"], "Out"),
    ("interp_nearest_down", "interpolate", {"X": [_randn(119, 1, 2, 7, 9)]},
     {"out_h": 3, "out_w": 4, "interp_method": "nearest"}, ["X"], "Out"),
    ("grid_sampler", "grid_sampler",
     {"X": [_randn(120, 2, 3, 5, 6)], "Grid": [_r(121, 2, 4, 3, 2, lo=-1.2, hi=1.2)]},
     {}, ["X", "Grid"], "Output"),
    ("pixel_shuffle", "pixel_shuffle", {"X": [_randn(122, 2, 8, 3, 2)]},
     {"upscale_factor": 2}, ["X"], "Out"),
    ("lrn", "lrn", {"X": [_randn(123, 2, 7, 3, 2)]},
     {"n": 5, "k": 2.0, "alpha": 0.1, "beta": 0.75}, ["X"], "Out"),
    ("temporal_shift", "temporal_shift", {"X": [_randn(124, 6, 8, 2, 2)]},
     {"seg_num": 3, "shift_ratio": 0.25}, ["X"], "Out"),
    ("multihead_matmul", "multihead_matmul",
     {"Q": [_randn(125, 2, 2, 5, 4)], "K": [_randn(126, 2, 2, 6, 4)],
      "V": [_randn(127, 2, 2, 6, 4)], "BiasQK": [_randn(128, 2, 1, 5, 6)]},
     {"alpha": 0.5}, ["Q", "K", "V", "BiasQK"], "Out"),
    ("trilinear_align", "trilinear_interp", {"X": [_randn(129, 1, 2, 3, 4, 3)]},
     {"out_d": 5, "out_h": 3, "out_w": 6}, ["X"], "Out"),
    ("trilinear_half_pixel", "trilinear_interp",
     {"X": [_randn(130, 2, 1, 4, 3, 5)]},
     {"out_d": 2, "out_h": 5, "out_w": 3, "align_corners": False}, ["X"], "Out"),
    # -- tensor_ops ------------------------------------------------------
    ("fill_zeros_like", "fill_zeros_like", {"X": [_randn(131, 3, 2)]}, {}, [],
     None),
    ("assign_value_f32", "assign_value", {},
     {"values": np.array([[1.5, -2.0], [0.1, 3.0]], np.float64),
      "dtype": "float32", "shape": [2, 2]}, [], None),
    ("assign_value_int", "assign_value", {},
     {"values": np.array([1, -2, 7]), "dtype": "int32", "shape": [3]}, [], None),
    ("share_data", "share_data", {"X": [_randn(132, 3, 2)]}, {}, ["X"], "Out"),
    ("flatten2", "flatten2", {"X": [_randn(133, 2, 3, 4)]}, {"axis": 2},
     ["X"], "Out"),
    ("flatten2_axis0", "flatten2", {"X": [_randn(134, 2, 3)]}, {"axis": 0},
     ["X"], "Out"),
    ("slice", "slice", {"Input": [_randn(135, 4, 5, 6)]},
     {"axes": [0, 2], "starts": [1, -4], "ends": [3, 100]}, ["Input"], "Out"),
    ("strided_slice", "strided_slice", {"Input": [_randn(136, 6, 7)]},
     {"axes": [0, 1], "starts": [0, 1], "ends": [6, 7], "strides": [2, 3]},
     ["Input"], "Out"),
    ("expand_as", "expand_as", {"X": [_randn(137, 3, 1)],
                                "target_tensor": [_randn(138, 2, 3, 4)]}, {},
     ["X"], "Out"),
    ("unstack", "unstack", {"X": [_randn(139, 3, 4, 2)]}, {"axis": 1},
     ["X"], "Y"),
    ("gather_nd", "gather_nd", {"X": [_randn(140, 4, 5, 3)],
                                "Index": [np.array([[[1, 2], [3, 0]], [[0, 4], [1, 2]]],
                                                   np.int64)]}, {},
     ["X"], "Out"),
    ("gather_nd_full", "gather_nd", {"X": [_randn(141, 4, 5)],
                                     "Index": [np.array([[1, 2], [3, 4], [3, 4]],
                                                        np.int64)]}, {},
     ["X"], "Out"),
    ("scatter_overwrite", "scatter",
     {"X": [_randn(142, 6, 3)], "Ids": [np.array([4, 0, 2], np.int64)],
      "Updates": [_randn(143, 3, 3)]}, {}, ["X", "Updates"], "Out"),
    ("scatter_add_repeats", "scatter",
     {"X": [_randn(144, 5, 2)], "Ids": [np.array([[1], [3], [1], [1]], np.int64)],
      "Updates": [_randn(145, 4, 2)]}, {"overwrite": False},
     ["X", "Updates"], "Out"),
    ("range_attrs_int", "range", {}, {"start": 2, "end": 13, "step": 3,
                                      "dtype": "int32"}, [], None),
    ("range_attrs_float", "range", {}, {"start": 0.5, "end": 2.0, "step": 0.25,
                                        "dtype": "float32"}, [], None),
    ("range_tensors", "range",
     {"Start": [np.array([1.5], np.float32)], "End": [np.array([4.0], np.float32)],
      "Step": [np.array([0.5], np.float32)]}, {"_static_len": 5}, [], None),
    ("shape", "shape", {"Input": [_randn(146, 3, 1, 4)]}, {}, [], None),
    ("pad2d_constant", "pad2d", {"X": [_randn(147, 1, 2, 3, 4)]},
     {"paddings": [1, 0, 2, 1], "pad_value": 0.5}, ["X"], "Out"),
    ("pad2d_reflect", "pad2d", {"X": [_randn(148, 1, 2, 4, 4)]},
     {"paddings": [1, 2, 2, 1], "mode": "reflect"}, ["X"], "Out"),
    ("pad2d_edge", "pad2d", {"X": [_randn(149, 2, 1, 3, 3)]},
     {"paddings": [2, 1, 0, 2], "mode": "edge"}, ["X"], "Out"),
    ("pad", "pad", {"X": [_randn(150, 2, 3)]},
     {"paddings": [1, 0, 2, 3], "pad_value": -1.0}, ["X"], "Out"),
    ("tile", "tile", {"X": [_randn(151, 2, 3)]}, {"repeat_times": [2, 1, 2]},
     ["X"], "Out"),
    ("tile_short", "tile", {"X": [_randn(152, 2, 3)]}, {"repeat_times": [3]},
     ["X"], "Out"),
    ("linspace_f32", "linspace", {}, {"start": -1.0, "stop": 2.0, "num": 7,
                                      "dtype": "float32"}, [], None),
    ("linspace_int", "linspace", {}, {"start": 0.0, "stop": 10.0, "num": 4,
                                      "dtype": "int32"}, [], None),
    ("linspace_int_exact", "linspace", {}, {"start": 0.0, "stop": 10.0,
                                            "num": 11, "dtype": "int32"},
     [], None),
    ("linspace_one", "linspace", {}, {"start": 3.0, "stop": 5.0, "num": 1,
                                      "dtype": "float32"}, [], None),
    ("diag_vector", "diag", {"Diagonal": [_randn(153, 4)]}, {}, ["Diagonal"],
     "Out"),
    ("diag_matrix", "diag", {"Diagonal": [_randn(154, 3, 4)]}, {},
     ["Diagonal"], "Out"),
    ("eye", "eye", {}, {"num_rows": 3, "num_columns": 5, "dtype": "float32"},
     [], None),
    ("eye_square_int", "eye", {}, {"num_rows": 4, "dtype": "int32"}, [], None),
    ("flip", "flip", {"X": [_randn(155, 3, 4, 2)]}, {"axis": [0, 2]}, ["X"],
     "Out"),
    ("roll", "roll", {"X": [_randn(156, 3, 4)]}, {"shifts": [1, -2],
                                                  "axis": [0, 1]}, ["X"], "Out"),
    ("roll_flat", "roll", {"X": [_randn(157, 3, 4)]}, {"shifts": [5]},
     ["X"], "Out"),
    ("shard_index", "shard_index", {"X": [np.array([[0], [7], [13], [19], [-1]],
                                                   np.int64)]},
     {"index_num": 20, "nshards": 3, "shard_id": 1, "ignore_value": -1}, [], None),
]
RULE_CASES += [("gelu_erf", "gelu", {"X": [_randn(160, 4, 6) * 3]},
                {"approximate": False}, ["X"], "Out"),
               ("gelu_tanh", "gelu", {"X": [_randn(160, 4, 6) * 3]},
                {"approximate": True}, ["X"], "Out")]
_KL_TARGET = _r(161, 4, 5, lo=0, hi=1)
_KL_TARGET[0, :2] = 0.0                    # clipped at 1e-20: 0, not NaN
RULE_CASES += [("kldiv_" + red, "kldiv_loss",
                {"X": [_randn(162, 4, 5)], "Target": [_KL_TARGET]},
                {"reduction": red}, ["X", "Target"], "Loss")
               for red in ("none", "mean", "sum", "batchmean")]
RULE_CASES += [
    ("p_norm_matrix_ones", "p_norm", {"X": [np.ones((2, 3), np.float32)]}, {},
     ["X"], "Out"),
    ("p_norm_matrix", "p_norm", {"X": [_randn(163, 3, 4)]}, {"porder": 2.0},
     ["X"], "Out"),
]
for _i, _bad in enumerate((None, np.nan, np.inf)):
    _v = _randn(164, 3, 4)
    if _bad is not None:
        _v[1, 2] = _bad
    RULE_CASES.append(("isfinite_%s" % _bad, "isfinite", {"X": [_v]}, {}, [],
                       None))
RULE_CASES += [
    ("strided_slice_neg_%d" % i, "strided_slice", {"Input": [_randn(165, 6, 7)]},
     {"axes": [0, 1], "starts": st, "ends": en, "strides": sd}, ["Input"], "Out")
    for i, (st, en, sd) in enumerate((
        ([5, 6], [0, 1], [-1, -2]),
        ([-1, -2], [-100, -100], [-2, -3]),
        ([100, 3], [1, -100], [-3, -1]),
        ([-3, 0], [100, 100], [2, 4]),
        ([2, 5], [2, 1], [-1, 1])))]         # the last is empty
RULE_CASES += [
    ("gather_nd_out_of_range", "gather_nd",
     {"X": [_randn(166, 4, 5)],
      "Index": [np.array([[1, 7], [-1, 0], [-6, 2], [4, -9]], np.int64)]}, {},
     ["X"], "Out"),
] + [
    ("scatter_out_of_range_%s" % ow, "scatter",
     {"X": [_randn(167, 5, 3)], "Ids": [np.array([1, 9, -2, -8, 0], np.int64)],
      "Updates": [_randn(168, 5, 3)]}, {"overwrite": ow}, ["X", "Updates"], "Out")
    for ow in (True, False)
] + [
    ("group_norm_n1_g%d" % g, "group_norm", {"X": [_randn(171, 1, 4, 2, 3)]},
     {"groups": g}, ["X"], "Y") for g in (1, 2, 4)
]

# rules that refuse in both packages: (id, op, ins, attrs)
REFUSALS = [
    ("where_index", "where_index",
     {"Condition": [np.array([1, 0, 1], np.int32)]}, {}),
    ("unique_with_counts", "unique_with_counts",
     {"X": [np.array([1, 1, 2], np.int64)]}, {}),
    ("maximum_entry_count", "maximum_entry_count",
     {"X": [np.array([1, 1, 2], np.int64)]}, {}),
    ("conv2d_transpose_groups", "conv2d_transpose",
     {"Input": [_randn(172, 1, 4, 3, 3)], "Filter": [_randn(173, 4, 1, 2, 2)]},
     {"groups": 2}),
]

# -- ROADMAP Queue 3's eight faults (entries 1-7 here; entry 8 is every
# row's float slots cast to int32 and to bool, ``cast_rows``) -------------
QUEUE3_CASES = [
    ("floordiv_by_zero_f32", "elementwise_floordiv",
     {"X": [np.array([1, -1, 0, 3.5, 2], np.float32)],
      "Y": [np.array([0, 0, 0, 0, -2], np.float32)]}, {}, [], None),
    ("floordiv_by_zero_int", "elementwise_floordiv",
     {"X": [np.array([5, 0, -5, -7, 7], np.int32)],
      "Y": [np.array([0, 0, 0, 2, -2], np.int32)]}, {}, [], None),
    ("abs_signed_zeros", "abs",
     {"X": [np.array([0.0, -0.0, 1.5, -1.0, -0.0], np.float32)]}, {}, ["X"],
     "Out"),
] + [
    ("p_norm_zero_%s" % name, "p_norm", {"X": [np.zeros((2, 3), np.float32)]},
     {"porder": p, "axis": -1}, ["X"], "Out")
    for name, p in (("p1", 1.0), ("p2", 2.0), ("p3", 3.0), ("inf", float("inf")))
] + [
    ("p_norm_matrix_nan", "p_norm",
     {"X": [np.array([[1, np.nan, 2], [3, 4, 5]], np.float32)]}, {}, [], None),
    ("gelu_erf_infinities", "gelu",
     {"X": [np.array([np.inf, -np.inf, 1.0, -2.0], np.float32)]},
     {"approximate": False}, [], None),
    ("pad2d_reflect_past_axis", "pad2d",
     {"X": [np.arange(24, dtype=np.float32).reshape(1, 2, 3, 4)]},
     {"paddings": [3, 4, 4, 5], "mode": "reflect"}, ["X"], "Out"),
    ("roll_shifts_no_axis", "roll", {"X": [_randn(174, 2, 3, 4)]},
     {"shifts": [1, 2]}, ["X"], "Out"),
]
RULE_CASES += QUEUE3_CASES
QUEUE3_ROWS = len(QUEUE3_CASES)


def cast_rows(cases=None):
    """Queue 3 entry 8's probe: each row with a float input slot, its float
    slots cast to int32 (round(2 x)) and to bool (x > 0), forward only:
    (id, op, ins, attrs) with "_int32" or "_bool" on the id."""
    rows = []
    for cid, op, ins, attrs, _, _ in (RULE_CASES if cases is None else cases):
        if not any(np.issubdtype(a.dtype, np.floating)
                   for v in ins.values() for a in v):
            continue
        for kind in ("int32", "bool"):
            with np.errstate(invalid="ignore"):   # a NaN casts to INT_MIN
                cast = {k: [(np.round(2 * a).astype(np.int32) if kind == "int32"
                             else a > 0) if np.issubdtype(a.dtype, np.floating)
                            else a for a in v] for k, v in ins.items()}
            rows.append(("%s_%s" % (cid, kind), op, cast, attrs))
    return rows


# -- item 3-B tranche 4 with ctc_align and edit_distance (27 rules) --------

def _tied3(seed, *shape):
    """Values on four levels: many 2 x 2 x 2 windows hold tied maxima."""
    return np.random.RandomState(seed).randint(-2, 2, shape).astype(np.float32)


_SEQ_LEN = np.array([5, 2, 0], np.int64)
_UNPOOL_IDX = np.array([[[[0, 3, 5], [12, 15, 22]],
                         [[7, -2, 4], [30, 17, 23]]]], np.int32)
_AUC_STAT = np.arange(16, dtype=np.int64) % 3
RULE_CASES_4 = [
    # -- sequence_ops --------------------------------------------------------
    ("sequence_softmax", "sequence_softmax",
     {"X": [_randn(200, 3, 5) * 2], "SeqLen": [_SEQ_LEN]}, {}, ["X"], "Out"),
    ("sequence_softmax_3d", "sequence_softmax",
     {"X": [_randn(201, 2, 4, 3)], "SeqLen": [np.array([4, 1], np.int64)]}, {},
     ["X"], "Out"),
    ("sequence_softmax_no_len", "sequence_softmax", {"X": [_randn(202, 2, 4)]},
     {}, ["X"], "Out"),
    ("sequence_expand_as", "sequence_expand_as",
     {"X": [_randn(203, 3, 2)], "Y": [_randn(204, 3, 4, 1)]}, {}, ["X"], "Out"),
    ("sequence_concat", "sequence_concat",
     {"X": [_randn(205, 2, 3, 2), _randn(206, 2, 1, 2)]}, {}, [], None),
    ("sequence_pad", "sequence_pad",
     {"X": [_randn(207, 3, 4, 2)], "SeqLen": [np.array([4, 1, 3], np.int64)]},
     {"padded_length": 4}, ["X"], "Out"),
    ("sequence_unpad", "sequence_unpad",
     {"X": [_randn(208, 3, 4)], "Length": [np.array([2, 4, 0], np.int64)]}, {},
     ["X"], "Out"),
    ("im2sequence", "im2sequence", {"X": [_randn(209, 2, 3, 6, 5)]},
     {"kernels": [3, 2], "strides": [1, 2], "paddings": [0, 0, 0, 0]},
     ["X"], "Out"),
    ("im2sequence_column", "im2sequence", {"X": [_randn(210, 2, 4, 6, 8)]},
     {"kernels": [6, 1], "strides": [1, 1]}, ["X"], "Out"),
    ("sequence_slice", "sequence_slice",
     {"X": [_randn(211, 3, 6, 2)], "Offset": [np.array([[1], [4], [0]], np.int64)],
      "Length": [np.array([[3], [5], [0]], np.int64)]}, {}, ["X"], "Out"),
    ("sequence_erase", "sequence_erase",
     {"X": [_ints(212, 0, 6, 3, 7)], "SeqLen": [np.array([7, 4, 0], np.int64)]},
     {"tokens": [2, 5]}, [], None),
    ("sequence_enumerate", "sequence_enumerate",
     {"X": [_ints(213, 0, 9, 3, 5)], "SeqLen": [_SEQ_LEN]},
     {"win_size": 3, "pad_value": -1}, [], None),
    ("sequence_expand", "sequence_expand",
     {"X": [_randn(214, 3, 2)], "Y": [_randn(215, 3, 4)]}, {}, ["X"], "Out"),
    ("sequence_scatter", "sequence_scatter",
     {"X": [_randn(216, 3, 6)],
      "Ids": [np.array([[1, 4, 1], [-1, 7, 2], [0, 0, 5]], np.int64)],
      "Updates": [_randn(217, 3, 3)], "SeqLen": [np.array([3, 2, 1], np.int64)]},
     {}, ["X", "Updates"], "Out"),
    ("sequence_topk_avg_pooling", "sequence_topk_avg_pooling",
     {"X": [np.round(_randn(218, 2, 3, 2, 5))],
      "COLUMN": [np.array([5, 3], np.int64)]},
     {"topks": [1, 3, 6], "channel_num": 3}, ["X"], "Out"),
    # -- ctc_ops, ctc_align, edit_distance ----------------------------------
    ("warpctc", "warpctc",
     {"Logits": [_randn(219, 3, 6, 5) * 2],
      "Label": [np.array([[1, 2, 2], [3, 0, 0], [4, 1, 0]], np.int32)],
      "LogitsLength": [np.array([6, 4, 5], np.int64)],
      "LabelLength": [np.array([3, 1, 2], np.int64)]}, {"blank": 0},
     ["Logits"], "Loss"),
    ("warpctc_norm_by_times", "warpctc",
     {"Logits": [_randn(220, 4, 7, 6)],
      "Label": [np.array([[0, 0, 1], [2, 3, 4], [1, 1, 1], [0, 2, 0]], np.int32)],
      "LogitsLength": [np.array([7, 5, 6, 1], np.int64)],
      "LabelLength": [np.array([2, 3, 0, 1], np.int64)]},
     {"blank": 5, "norm_by_times": True}, ["Logits"], "Loss"),
    ("warpctc_no_lengths", "warpctc",
     {"Logits": [_randn(221, 2, 5, 4)],
      "Label": [np.array([[1, 3], [2, 2]], np.int32)]}, {"blank": 0},
     ["Logits"], "Loss"),
    ("ctc_align", "ctc_align",
     {"Input": [np.array([[0, 1, 1, 0, 2, 2, 0, 1], [3, 3, 3, 0, 3, 1, 1, 1],
                          [1, 2, 0, 0, 1, 0, 0, 0]], np.int32)],
      "InputLength": [np.array([[8], [5], [0]], np.int64)]},
     {"blank": 0, "merge_repeated": True}, [], None),
    ("ctc_align_no_merge", "ctc_align",
     {"Input": [np.array([[0, 1, 1, 0, 2, 2, 3, 3], [3, 3, 3, 0, 3, 1, 1, 1]],
                         np.int32)]},
     {"blank": 3, "merge_repeated": False, "padding_value": -1}, [], None),
    ("edit_distance", "edit_distance",
     {"Hyps": [_ints(222, 0, 4, 4, 6)], "Refs": [_ints(223, 0, 4, 4, 5)],
      "HypsLength": [np.array([6, 3, 0, 2], np.int64)],
      "RefsLength": [np.array([5, 5, 2, 0], np.int64)]},
     {"normalized": False}, [], None),
    ("edit_distance_normalized", "edit_distance",
     {"Hyps": [_ints(224, 0, 3, 3, 7)], "Refs": [_ints(225, 0, 3, 3, 4)]},
     {"normalized": True}, [], None),
    # -- rnn_ops -----------------------------------------------------------------
    ("gru", "gru",
     {"Input": [_randn(226, 2, 4, 9)], "Weight": [_randn(227, 3, 9) * 0.5],
      "Bias": [_randn(228, 1, 9)], "H0": [_randn(229, 2, 3)],
      "SeqLen": [np.array([4, 2], np.int64)]}, {},
     ["Input", "Weight", "Bias", "H0"], "Hidden"),
    ("gru_reverse_origin", "gru",
     {"Input": [_randn(230, 3, 5, 6)], "Weight": [_randn(231, 2, 6) * 0.5],
      "SeqLen": [np.array([5, 3, 0], np.int64)]},
     {"is_reverse": True, "origin_mode": True, "activation": "relu"},
     ["Input", "Weight"], "Hidden"),
    ("gru_last_hidden", "gru",
     {"Input": [_randn(232, 2, 3, 6)], "Weight": [_randn(233, 2, 6) * 0.5]},
     {"gate_activation": "sigmoid"}, ["Input", "Weight"], "LastHidden"),
    ("lstm", "lstm",
     {"Input": [_randn(234, 2, 4, 8)], "Weight": [_randn(235, 2, 8) * 0.5],
      "Bias": [_randn(236, 1, 8)], "H0": [_randn(237, 2, 2)],
      "C0": [_randn(238, 2, 2)], "SeqLen": [np.array([3, 4], np.int64)]}, {},
     ["Input", "Weight", "H0", "C0"], "Hidden"),
    ("lstm_reverse_cell", "lstm",
     {"Input": [_randn(239, 3, 4, 8)], "Weight": [_randn(240, 2, 8) * 0.5],
      "SeqLen": [np.array([4, 1, 2], np.int64)]},
     {"is_reverse": True, "candidate_activation": "relu"}, ["Input", "Weight"],
     "Cell"),
    ("lstmp", "lstmp",
     {"Input": [_randn(241, 2, 3, 8)], "Weight": [_randn(242, 3, 8) * 0.5],
      "ProjWeight": [_randn(243, 2, 3) * 0.5], "Bias": [_randn(244, 1, 8)],
      "H0": [_randn(245, 2, 2)], "SeqLen": [np.array([3, 2], np.int64)]},
     {"proj_activation": "tanh"}, ["Input", "Weight", "ProjWeight"],
     "Projection"),
    ("lstmp_reverse_last", "lstmp",
     {"Input": [_randn(246, 2, 4, 8)], "Weight": [_randn(247, 3, 8) * 0.5],
      "ProjWeight": [_randn(248, 2, 3) * 0.5],
      "SeqLen": [np.array([2, 4], np.int64)]},
     {"is_reverse": True}, ["Input", "ProjWeight"], "LastProjection"),
    # -- pooling_ops -------------------------------------------------------------
    ("pool3d_max_ties_ceil", "pool3d", {"X": [_tied3(249, 2, 2, 5, 4, 5)]},
     {"pooling_type": "max", "ksize": [2, 2, 2], "strides": [2, 2, 2],
      "paddings": [1, 0, 1], "ceil_mode": True}, ["X"], "Out"),
    ("pool3d_avg_exclusive", "pool3d", {"X": [_randn(250, 1, 2, 4, 5, 3)]},
     {"pooling_type": "avg", "ksize": [3, 2, 2], "strides": [1, 2, 1],
      "paddings": [1, 1, 0]}, ["X"], "Out"),
    ("pool3d_avg_inclusive_ceil", "pool3d", {"X": [_randn(251, 1, 2, 5, 4, 3)]},
     {"pooling_type": "avg", "ksize": [2, 3, 2], "strides": [2, 2, 2],
      "paddings": [0, 1, 1], "exclusive": False, "ceil_mode": True},
     ["X"], "Out"),
    ("pool3d_global_max_ties", "pool3d", {"X": [_tied3(252, 2, 3, 2, 2, 3)]},
     {"pooling_type": "max", "global_pooling": True}, ["X"], "Out"),
    ("pool3d_adaptive_avg", "pool3d", {"X": [_randn(253, 1, 2, 4, 6, 4)]},
     {"pooling_type": "avg", "ksize": [2, 3, 2], "adaptive": True}, ["X"], "Out"),
    ("max_pool2d_with_index", "max_pool2d_with_index",
     {"X": [_tied3(254, 2, 2, 7, 6)]},
     {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1],
      "ceil_mode": True}, ["X"], "Out"),
    ("max_pool2d_with_index_global", "max_pool2d_with_index",
     {"X": [_randn(255, 2, 3, 3, 4)]}, {"global_pooling": True}, ["X"], "Out"),
    ("maxout", "maxout", {"X": [_tied3(256, 2, 6, 3, 2)]}, {"groups": 3},
     ["X"], "Out"),
    ("maxout_last_axis", "maxout", {"X": [_randn(257, 2, 3, 4)]},
     {"groups": 2, "axis": -1}, ["X"], "Out"),
    ("unpool", "unpool",
     {"X": [_randn(258, 1, 2, 2, 3)], "Indices": [_UNPOOL_IDX]},
     {"ksize": [2, 2], "strides": [2, 2]}, ["X"], "Out"),
    ("spp_max", "spp", {"X": [_tied3(259, 2, 2, 5, 7)]},
     {"pyramid_height": 3, "pooling_type": "max"}, ["X"], "Out"),
    ("spp_avg", "spp", {"X": [_randn(260, 1, 3, 6, 5)]},
     {"pyramid_height": 2, "pooling_type": "avg"}, ["X"], "Out"),
    # -- metric_ops --------------------------------------------------------------
    ("auc", "auc",
     {"Predict": [np.stack([1 - np.r_[_r(261, 6, lo=0, hi=1), 0.0, 1.0],
                            np.r_[_r(261, 6, lo=0, hi=1), 0.0, 1.0]], 1)
                  .astype(np.float32)],
      "Label": [_ints(262, 0, 2, 8, 1)], "StatPos": [_AUC_STAT],
      "StatNeg": [_AUC_STAT[::-1].copy()]}, {"num_thresholds": 15}, [], None),
    ("precision_recall", "precision_recall",
     {"Indices": [np.array([[0], [2], [1], [1], [0], [2]], np.int32)],
      "Labels": [np.array([[0], [1], [1], [2], [0], [2]], np.int32)],
      "Weights": [_r(263, 6, 1, lo=0.5, hi=2)],
      "StatesInfo": [np.round(_r(264, 3, 4, lo=0, hi=5))]},
     {"class_number": 3}, [], None),
    ("precision_recall_unweighted", "precision_recall",
     {"Indices": [np.array([[0], [2], [2], [1]], np.int64)],
      "Labels": [np.array([[0], [1], [2], [2]], np.int64)]},
     {"class_number": 4}, [], None),
    # -- sampling_ops: sample_logits with given samples (the draws are
    # pinned by range, seed and distribution in the tests) ------------------
    ("sample_logits_custom", "sample_logits",
     {"Logits": [_randn(265, 3, 7) * 2],
      "Labels": [np.array([[1, 4], [0, 6], [2, 2]], np.int64)],
      "CustomizedSamples": [np.array([[1, 4, 0, 4, 5], [0, 6, 3, 1, 6],
                                      [2, 2, 2, 5, 1]], np.int64)],
      "CustomizedProbabilities": [_r(266, 3, 5, lo=0.05, hi=0.9)]},
     {"num_samples": 3, "use_customized_samples": True,
      "remove_accidental_hits": True}, ["Logits"], "SampledLogits"),
    ("sample_logits_custom_keep_hits", "sample_logits",
     {"Logits": [_randn(267, 2, 5)],
      "Labels": [np.array([[3], [0]], np.int64)],
      "CustomizedSamples": [np.array([[3, 3, 1], [0, 4, 0]], np.int64)],
      "CustomizedProbabilities": [_r(268, 2, 3, lo=0.05, hi=0.9)]},
     {"num_samples": 2, "use_customized_samples": True,
      "remove_accidental_hits": False}, ["Logits"], "SampledLogits"),
]
# attribute edges: pads past the window, more bins than pixels, lengths of
# 0 and past T, offsets outside the row, windows past T, infeasible
# alignments (T < labels + repeats) and no time steps
RULE_CASES_4 += [
    ("pool3d_pad_past_window", "pool3d", {"X": [_randn(269, 1, 2, 3, 4, 3)]},
     {"pooling_type": "max", "ksize": [2, 2, 2], "strides": [1, 2, 2],
      "paddings": [2, 1, 2]}, ["X"], "Out"),
    ("max_pool2d_with_index_pad_past_window", "max_pool2d_with_index",
     {"X": [_randn(270, 1, 2, 3, 4)]},
     {"ksize": [2, 2], "strides": [1, 1], "paddings": [2, 2]}, ["X"], "Out"),
    ("spp_bins_past_axis", "spp", {"X": [_randn(271, 1, 2, 5, 3)]},
     {"pyramid_height": 4, "pooling_type": "max"}, ["X"], "Out"),
    ("sequence_slice_edges", "sequence_slice",
     {"X": [_randn(272, 3, 5)], "Offset": [np.array([[-2], [4], [9]], np.int64)],
      "Length": [np.array([[4], [5], [2]], np.int64)]}, {}, ["X"], "Out"),
    ("sequence_enumerate_past_t", "sequence_enumerate",
     {"X": [_ints(273, 0, 9, 2, 3)], "SeqLen": [np.array([9, 3], np.int64)]},
     {"win_size": 5, "pad_value": 7}, [], None),
    ("sequence_erase_all", "sequence_erase",
     {"X": [np.array([[2, 2, 5], [1, 2, 3]], np.int64)]}, {"tokens": [2, 5]},
     [], None),
    ("ctc_align_past_t", "ctc_align",
     {"Input": [np.array([[1, 1, 0, 2], [0, 0, 0, 0]], np.int32)],
      "InputLength": [np.array([[9], [4]], np.int64)]}, {"blank": 0}, [], None),
    ("warpctc_edges", "warpctc",
     {"Logits": [_randn(274, 3, 3, 4)],
      "Label": [np.array([[1, 1], [2, 3], [1, 2]], np.int32)],
      "LogitsLength": [np.array([3, 0, 1], np.int64)],
      "LabelLength": [np.array([2, 2, 1], np.int64)]}, {"blank": 0},
     ["Logits"], "Loss"),
]
RULE_CASES += RULE_CASES_4


# -- item 3-B tranche 8: the 15 collective op types (with item 5-A) --------
# Each input array holds every rank's value on a leading axis of 2 (rank r
# takes [r]); the rules run with ring 0 mapped to the dp axis of a 2-rank
# world (and as identities with no axis for the ring).
COLLECTIVE_CASES = [
    ("c_allreduce_sum", "c_allreduce_sum", {"X": [_randn(300, 2, 3, 4)]},
     {"ring_id": 0}, ["X"], "Out"),
    ("c_allreduce_max", "c_allreduce_max", {"X": [_randn(301, 2, 3, 4)]},
     {"ring_id": 0}, [], None),
    ("c_allreduce_min", "c_allreduce_min", {"X": [_randn(302, 2, 3, 4)]},
     {"ring_id": 0}, [], None),
    ("c_allreduce_prod", "c_allreduce_prod",
     {"X": [_r(303, 2, 3, 4, lo=0.5, hi=2.0)]}, {"ring_id": 0}, ["X"], "Out"),
    ("c_allgather", "c_allgather", {"X": [_randn(304, 2, 3, 4)]},
     {"ring_id": 0, "nranks": 2}, ["X"], "Out"),
    ("c_reducescatter", "c_reducescatter", {"X": [_randn(305, 2, 4, 3)]},
     {"ring_id": 0, "nranks": 2}, ["X"], "Out"),
    ("c_broadcast", "c_broadcast", {"X": [_randn(306, 2, 3, 4)]},
     {"ring_id": 0, "root": 1}, ["X"], "Out"),
    ("c_ppermute", "c_ppermute", {"X": [_randn(307, 2, 3, 4)]},
     {"ring_id": 0, "shift": 1}, ["X"], "Out"),
    ("c_sync_calc_stream", "c_sync_calc_stream", {"X": [_randn(308, 2, 3)]},
     {}, ["X"], "Out"),
    ("c_sync_comm_stream", "c_sync_comm_stream", {"X": [_randn(309, 2, 3)]},
     {"ring_id": 0}, ["X"], "Out"),
    ("c_comm_init", "c_comm_init", {}, {"ring_id": 0, "nranks": 2}, [], None),
    ("c_comm_init_all", "c_comm_init_all", {}, {"ring_id": 0}, [], None),
    ("c_gen_nccl_id", "c_gen_nccl_id", {}, {}, [], None),
    ("allreduce", "allreduce", {"X": [_randn(310, 2, 5)]}, {"ring_id": 0},
     ["X"], "Out"),
    ("broadcast", "broadcast", {"X": [_randn(311, 2, 5)]},
     {"ring_id": 0, "root": 0}, ["X"], "Out"),
]
