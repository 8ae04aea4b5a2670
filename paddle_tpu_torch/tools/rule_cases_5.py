"""Inputs for item 3-B's tranche 5 (ROADMAP Queue 1): the 59 op rules of
``ops/misc_ops.py``, ``misc_ops2.py``, ``misc_ops3.py`` and
``misc_ops4.py``, made with numpy from fixed seeds, so that the CPU tests
hold the port's rules to the JAX package's on them and ``chip_smoke.py``
phase 44 runs the same rules on the card.  Rows have
``tools/rule_cases.py``'s form, ``(id, op, ins, attrs, grad_slots,
grad_out)``; ``rule_cases.cast_rows(RULE_CASES_5)`` gives their int32 and
bool probes.

Besides one row a rule and setting: the kinks (``hinge_loss`` at margin
1, ``modified_huber_loss`` at -1 and 1, ``soft_relu`` at its threshold,
``l1_norm`` and ``proximal_gd`` at 0), the attribute edges (negative
axes, Offsets inputs past the axis, a -1 in a shape, ``one_hot_v2`` ids
out of range, ``lod_reset``'s Y against ``target_lod``, ``chunk_eval``
under each scheme and with ``excluded_chunk_types``, ``average_accumulates``
reaching its kMax roll and filling its window).  ``REFUSALS_5`` raise in
both packages (static offsets past the axis, indivisible shapes).  The
random rules (``random_crop`` and the two ``*_batch_size_like``), the
SelectedRows inputs and ``py_func`` are not rows: their tests hold them
by contract.
"""

import numpy as np

from .rule_cases import _ints, _r, _randn

__all__ = ["RULE_CASES_5", "REFUSALS_5", "TRANCHE_5"]

TRANCHE_5 = """
hinge_loss log_loss rank_loss bpr_loss sigmoid_focal_loss minus l1_norm norm
multiplex reverse crop pad_constant_like unfold gather_tree space_to_depth
shuffle_channel affine_channel row_conv conv_shift cvm
scatter_nd_add cross_entropy2 center_loss data_norm lod_reset gru_unit
sequence_reshape
chunk_eval mean_iou spectral_norm affine_grid bilinear_tensor_product
squared_l2_distance modified_huber_loss unique size fill_any_like one_hot_v2
crop_tensor add_position_encoding random_crop lstm_unit deformable_conv
fsp teacher_student_sigmoid_loss hash average_accumulates proximal_gd is_empty
uniform_random_batch_size_like gaussian_random_batch_size_like
get_tensor_from_selected_rows merge_selected_rows positive_negative_pair
py_func scatter_nd soft_relu conv3d_transpose tree_conv""".split()


def _labels01(seed, *shape):
    return _ints(seed, 0, 2, *shape).astype(np.float32)


def _probs(seed, n, c):
    z = np.exp(_randn(seed, n, c))
    return (z / z.sum(1, keepdims=True)).astype(np.float32)


def _tags(seed, lo, hi, B, L):
    """Tag ids and a copy with about a third of them redrawn (so that some
    chunks match and some do not)."""
    lab = _ints(seed, lo, hi, B, L)
    inf = lab.copy()
    flip = np.random.RandomState(seed + 1).rand(B, L) < 0.35
    inf[flip] = _ints(seed + 2, lo, hi, B, L)[flip]
    return inf, lab


def _chunk_row(cid, scheme, n_types, num_tag, seed, **attrs):
    inf, lab = _tags(seed, 0, n_types * num_tag + 1, 4, 9)
    return (cid, "chunk_eval",
            {"Inference": [inf], "Label": [lab],
             "SeqLength": [np.array([9, 5, 1, 0], np.int64)]},
            dict({"num_chunk_types": n_types, "chunk_scheme": scheme}, **attrs),
            [], None)


def _tree_edges():
    """Two trees, 1-based node ids, (parent, child) pairs up to a 0."""
    return np.array([[[1, 2], [1, 3], [2, 4], [2, 5], [3, 6]],
                     [[1, 2], [2, 3], [1, 4], [0, 0], [4, 5]]], np.int32)


def _avg_ins(seed, nacc, oacc, nupd):
    return {"param": [_randn(seed, 3, 2)], "in_sum_1": [_randn(seed + 1, 3, 2)],
            "in_sum_2": [_randn(seed + 2, 3, 2)],
            "in_sum_3": [_randn(seed + 3, 3, 2)],
            "in_num_accumulates": [np.array([nacc], np.int64)],
            "in_old_num_accumulates": [np.array([oacc], np.int64)],
            "in_num_updates": [np.array([nupd], np.int64)]}


_AVG = {"average_window": 0.15, "max_average_window": 20,
        "min_average_window": 3}
_PROX_P = _randn(540, 4, 3)
_PROX_G = _randn(541, 4, 3)
_PROX_G[0, :2] = _PROX_P[0, :2] / 0.5          # prox = p - lr g = 0 exactly
_PROX_G[1, 0] = (_PROX_P[1, 0] - 0.05) / 0.5    # |prox| = lr l1 (the max's tie)

RULE_CASES_5 = [
    # -- misc_ops: losses ---------------------------------------------------
    ("hinge_loss", "hinge_loss",
     {"Logits": [_randn(500, 6, 1)], "Labels": [_labels01(501, 6, 1)]}, {},
     ["Logits"], "Loss"),
    ("hinge_loss_at_margin_1", "hinge_loss",
     {"Logits": [np.array([[1.0], [-1.0], [0.5], [2.0]], np.float32)],
      "Labels": [np.array([[1.0], [0.0], [1.0], [0.0]], np.float32)]}, {},
     ["Logits", "Labels"], "Loss"),
    ("log_loss", "log_loss",
     {"Predicted": [_r(502, 5, 1, lo=0.05, hi=0.95)],
      "Labels": [_labels01(503, 5, 1)]}, {"epsilon": 1e-4},
     ["Predicted"], "Loss"),
    ("rank_loss", "rank_loss",
     {"Label": [_labels01(504, 5, 1)], "Left": [_randn(505, 5, 1)],
      "Right": [_randn(506, 5, 1)]}, {}, ["Left", "Right"], "Out"),
    ("bpr_loss", "bpr_loss",
     {"X": [_randn(507, 4, 5)], "Label": [np.array([[0], [4], [2], [2]],
                                                   np.int64)]}, {},
     ["X"], "Loss"),
    ("bpr_loss_label_out_of_range", "bpr_loss",
     {"X": [_randn(508, 3, 4)], "Label": [np.array([[7], [-1], [1]], np.int64)]},
     {}, [], None),
    ("sigmoid_focal_loss", "sigmoid_focal_loss",
     {"X": [_randn(509, 6, 4)],
      "Label": [np.array([[0], [1], [4], [-1], [2], [3]], np.int32)],
      "FgNum": [np.array([3], np.int32)]}, {"gamma": 2.0, "alpha": 0.25},
     ["X"], "Out"),
    ("sigmoid_focal_loss_gamma_1_5_fg_0", "sigmoid_focal_loss",
     {"X": [_randn(510, 3, 2)], "Label": [np.array([[2], [0], [1]], np.int32)],
      "FgNum": [np.array([0], np.int32)]}, {"gamma": 1.5, "alpha": 0.6},
     ["X"], "Out"),
    # -- misc_ops: tensor utils ---------------------------------------------
    ("minus", "minus", {"X": [_randn(511, 3, 4)], "Y": [_randn(512, 3, 4)]},
     {}, ["X", "Y"], "Out"),
    ("l1_norm", "l1_norm", {"X": [_randn(513, 3, 4)]}, {}, ["X"], "Out"),
    ("l1_norm_at_zero", "l1_norm",
     {"X": [np.array([[0.0, -0.0, 1.5], [-2.0, 0.0, 0.25]], np.float32)]}, {},
     ["X"], "Out"),
    ("norm", "norm", {"X": [_randn(514, 2, 3, 4)]}, {"axis": 1}, ["X"], "Out"),
    ("norm_negative_axis", "norm", {"X": [_randn(515, 2, 3, 4)]},
     {"axis": -1, "epsilon": 1e-6}, ["X"], "Norm"),
    ("multiplex", "multiplex",
     {"X": [_randn(516, 4, 3), _randn(517, 4, 3), _randn(518, 4, 3)],
      "Ids": [np.array([[0], [2], [1], [0]], np.int32)]}, {}, ["X"], "Out"),
    ("multiplex_ids_out_of_range", "multiplex",
     {"X": [_randn(519, 3, 2), _randn(520, 3, 2)],
      "Ids": [np.array([[3], [-1], [1]], np.int32)]}, {}, ["X"], "Out"),
    ("reverse", "reverse", {"X": [_randn(521, 2, 3, 4)]}, {"axis": [0, 2]},
     ["X"], "Out"),
    ("reverse_negative_axis", "reverse", {"X": [_randn(522, 2, 3, 4)]},
     {"axis": [-1]}, ["X"], "Out"),
    ("crop", "crop", {"X": [_randn(523, 3, 5, 4)]},
     {"shape": [2, 3, 2], "offsets": [1, 1, 2]}, ["X"], "Out"),
    ("crop_like_y", "crop", {"X": [_randn(524, 3, 5, 4)],
                             "Y": [_randn(525, 2, 2, 2)]},
     {"offsets": [0, 3, 1]}, ["X"], "Out"),
    ("crop_offsets_input_past_axis", "crop",
     {"X": [_randn(526, 3, 5, 4)], "Offsets": [np.array([2, 4, -1], np.int32)]},
     {"shape": [2, 3, 2]}, ["X"], "Out"),
    ("pad_constant_like", "pad_constant_like",
     {"X": [_randn(527, 3, 4, 5)], "Y": [_randn(528, 2, 3, 5)]},
     {"pad_value": 1.5}, ["Y"], "Out"),
    ("pad_constant_like_crops", "pad_constant_like",
     {"X": [_randn(529, 3, 2)], "Y": [_randn(530, 2, 4)]}, {}, ["Y"], "Out"),
    ("unfold", "unfold", {"X": [_randn(531, 2, 3, 5, 6)]},
     {"kernel_sizes": [2, 3], "strides": [1, 2], "paddings": [1, 0, 0, 1],
      "dilations": [1, 1]}, ["X"], "Y"),
    ("unfold_dilated", "unfold", {"X": [_randn(532, 1, 2, 6, 5)]},
     {"kernel_sizes": [2, 2], "strides": [2, 1], "paddings": [1, 1],
      "dilations": [2, 1]}, ["X"], "Y"),
    ("gather_tree", "gather_tree",
     {"Ids": [_ints(533, 0, 9, 4, 2, 3)], "Parents": [_ints(534, 0, 3, 4, 2, 3)]},
     {}, [], None),
    ("space_to_depth", "space_to_depth", {"X": [_randn(535, 1, 8, 4, 6)]},
     {"blocksize": 2}, ["X"], "Out"),
    ("shuffle_channel", "shuffle_channel", {"X": [_randn(536, 2, 6, 3, 2)]},
     {"group": 3}, ["X"], "Out"),
    ("affine_channel", "affine_channel",
     {"X": [_randn(537, 2, 3, 4, 5)], "Scale": [_randn(538, 3)],
      "Bias": [_randn(539, 3)]}, {}, ["X", "Scale", "Bias"], "Out"),
    ("affine_channel_nhwc", "affine_channel",
     {"X": [_randn(542, 2, 4, 5, 3)], "Scale": [_randn(543, 3)],
      "Bias": [_randn(544, 3)]}, {"data_layout": "NHWC"},
     ["X", "Scale"], "Out"),
    # -- misc_ops: sequence/CTR extras --------------------------------------
    ("row_conv", "row_conv",
     {"X": [_randn(545, 2, 5, 3)], "Filter": [_randn(546, 3, 3)]}, {},
     ["X", "Filter"], "Out"),
    ("row_conv_filter_past_t", "row_conv",
     {"X": [_randn(547, 2, 2, 3)], "Filter": [_randn(548, 4, 3)]}, {},
     ["X", "Filter"], "Out"),
    ("conv_shift", "conv_shift",
     {"X": [_randn(549, 3, 7)], "Y": [_randn(550, 3, 3)]}, {}, ["X", "Y"], "Out"),
    ("conv_shift_even_k", "conv_shift",
     {"X": [_randn(551, 2, 5)], "Y": [_randn(552, 2, 4)]}, {}, ["X", "Y"], "Out"),
    ("cvm", "cvm",
     {"X": [np.concatenate([_r(553, 4, 2, lo=0, hi=9), _randn(554, 4, 3)], 1)]},
     {"use_cvm": True}, ["X"], "Y"),
    ("cvm_drop", "cvm",
     {"X": [np.concatenate([_r(555, 4, 2, lo=0, hi=9), _randn(556, 4, 3)], 1)]},
     {"use_cvm": False}, ["X"], "Y"),
    # -- misc_ops2 ------------------------------------------------------------
    ("scatter_nd_add", "scatter_nd_add",
     {"X": [_randn(557, 5, 3)], "Index": [np.array([[1], [3], [1], [-1]], np.int64)],
      "Updates": [_randn(558, 4, 3)]}, {}, ["X", "Updates"], "Out"),
    ("scatter_nd_add_out_of_range", "scatter_nd_add",
     {"X": [_randn(559, 5, 4)],
      "Index": [np.array([[0, 1], [4, 9], [-6, 0], [0, 1]], np.int64)],
      "Updates": [_randn(560, 4)]}, {}, ["X", "Updates"], "Out"),
    ("cross_entropy2", "cross_entropy2",
     {"X": [_probs(561, 4, 5)], "Label": [np.array([[0], [2], [4], [1]], np.int64)]},
     {"ignore_index": 2}, ["X"], "Y"),
    ("cross_entropy2_3d_zero_prob", "cross_entropy2",
     {"X": [np.where(_ints(562, 0, 4, 2, 3, 4) == 0, 0.0, _probs(563, 6, 4)
                     .reshape(2, 3, 4)).astype(np.float32)],
      "Label": [_ints(564, 0, 4, 2, 3, 1)]}, {}, ["X"], "Y"),
    ("center_loss", "center_loss",
     {"X": [_randn(565, 5, 3)], "Label": [np.array([[0], [2], [0], [3], [1]],
                                                   np.int64)],
      "Centers": [_randn(566, 4, 3)],
      "CenterUpdateRate": [np.array([0.3], np.float32)]},
     {"need_update": True}, ["X", "Centers"], "Loss"),
    ("center_loss_update_out_of_range", "center_loss",
     {"X": [_randn(567, 4, 2)], "Label": [np.array([[1], [5], [1], [-1]],
                                                   np.int64)],
      "Centers": [_randn(568, 3, 2)]}, {"need_update": True, "alpha": 0.5},
     ["X", "Centers"], "CentersOut"),
    ("center_loss_no_update", "center_loss",
     {"X": [_randn(569, 3, 2)], "Label": [np.array([[1], [0], [1]], np.int64)],
      "Centers": [_randn(570, 2, 2)]}, {"need_update": False},
     ["X", "Centers"], "Loss"),
    ("data_norm", "data_norm",
     {"X": [_randn(571, 4, 3)], "BatchSize": [_r(572, 3, lo=10, hi=20)],
      "BatchSum": [_randn(573, 3)], "BatchSquareSum": [_r(574, 3, lo=10, hi=20)]},
     {}, ["X", "BatchSum"], "Y"),
    ("data_norm_update_stats", "data_norm",
     {"X": [_randn(575, 4, 3)], "BatchSize": [_r(576, 3, lo=10, hi=20)],
      "BatchSum": [_randn(577, 3)], "BatchSquareSum": [_r(578, 3, lo=10, hi=20)]},
     {"update_stats": True}, ["X"], "BatchSquareSumOut"),
    ("lod_reset_y", "lod_reset",
     {"X": [_randn(579, 3, 4)], "Y": [np.array([0, 2, 3, 4], np.int32)]}, {},
     ["X"], "Out"),
    ("lod_reset_target_lod", "lod_reset", {"X": [_randn(580, 3, 4)]},
     {"target_lod": [0, 1, 4, 6]}, ["X"], "Out"),
    ("lod_reset_y_over_target_lod", "lod_reset",
     {"X": [_randn(581, 3, 4)], "Y": [np.array([[0], [3], [3]], np.int64)]},
     {"target_lod": [0, 1, 4, 6]}, [], None),
    ("gru_unit", "gru_unit",
     {"Input": [_randn(582, 3, 12)], "HiddenPrev": [_randn(583, 3, 4)],
      "Weight": [_randn(584, 4, 12) * 0.5], "Bias": [_randn(585, 1, 12)]}, {},
     ["Input", "HiddenPrev", "Weight", "Bias"], "Hidden"),
    ("gru_unit_enums_origin_mode", "gru_unit",
     {"Input": [_randn(586, 2, 9)], "HiddenPrev": [_randn(587, 2, 3)],
      "Weight": [_randn(588, 3, 9) * 0.5]},
     {"gate_activation": 1, "activation": 3, "origin_mode": True},
     ["Input", "HiddenPrev", "Weight"], "Gate"),
    ("sequence_reshape", "sequence_reshape",
     {"X": [_randn(589, 2, 4, 6)], "SeqLen": [np.array([4, 2], np.int64)]},
     {"new_dim": 3}, ["X"], "Out"),
    ("sequence_reshape_wider", "sequence_reshape",
     {"X": [_randn(590, 2, 4, 2)], "SeqLen": [np.array([3, 1], np.int64)]},
     {"new_dim": 4}, ["X"], "Out"),
    # -- misc_ops3 ------------------------------------------------------------
    _chunk_row("chunk_eval_iob", "IOB", 3, 2, 591),
    _chunk_row("chunk_eval_ioe", "IOE", 3, 2, 594),
    _chunk_row("chunk_eval_iobes", "IOBES", 2, 4, 597),
    _chunk_row("chunk_eval_plain", "plain", 4, 1, 600),
    _chunk_row("chunk_eval_iob_excluded", "IOB", 3, 2, 603,
               excluded_chunk_types=[1]),
    ("chunk_eval_no_seq_length", "chunk_eval",
     {"Inference": [_tags(606, 0, 7, 3, 6)[0]],
      "Label": [_tags(606, 0, 7, 3, 6)[1]]},
     {"num_chunk_types": 3, "chunk_scheme": "IOB"}, [], None),
    ("mean_iou", "mean_iou",
     {"Predictions": [_ints(609, 0, 4, 2, 8, dtype=np.int32)],
      "Labels": [_ints(610, 0, 4, 2, 8, dtype=np.int32)]}, {"num_classes": 4},
     [], None),
    ("mean_iou_in_states_out_of_range", "mean_iou",
     {"Predictions": [np.array([0, 1, 5, -1, 2, 2], np.int32)],
      "Labels": [np.array([0, 2, 1, 1, -2, 2], np.int32)],
      "InWrongs": [np.array([1, 0, 2, 0], np.int32)],
      "InCorrects": [np.array([0, 3, 0, 0], np.int32)],
      "InMeanIou": [np.array([0.25], np.float32)]}, {"num_classes": 4}, [], None),
    ("spectral_norm", "spectral_norm",
     {"Weight": [_randn(611, 4, 3, 2)], "U": [_randn(612, 4)],
      "V": [_randn(613, 6)]}, {"dim": 0, "power_iters": 2}, ["Weight"], "Out"),
    ("spectral_norm_dim1", "spectral_norm",
     {"Weight": [_randn(614, 3, 4, 2)], "U": [_randn(615, 4)],
      "V": [_randn(616, 6)]}, {"dim": 1, "power_iters": 1, "eps": 1e-10},
     ["Weight"], "Out"),
    ("affine_grid", "affine_grid", {"Theta": [_randn(617, 2, 2, 3)]},
     {"output_shape": [2, 1, 4, 5]}, ["Theta"], "Output"),
    ("affine_grid_one_row", "affine_grid", {"Theta": [_randn(618, 1, 2, 3)]},
     {"output_shape": [1, 1, 1, 3]}, ["Theta"], "Output"),
    ("bilinear_tensor_product", "bilinear_tensor_product",
     {"X": [_randn(619, 3, 4)], "Y": [_randn(620, 3, 5)],
      "Weight": [_randn(621, 2, 4, 5)], "Bias": [_randn(622, 1, 2)]}, {},
     ["X", "Y", "Weight", "Bias"], "Out"),
    ("squared_l2_distance", "squared_l2_distance",
     {"X": [_randn(623, 4, 3)], "Y": [_randn(624, 4, 3)]}, {}, ["X", "Y"], "Out"),
    ("squared_l2_distance_broadcast", "squared_l2_distance",
     {"X": [_randn(625, 4, 3)], "Y": [_randn(626, 1, 3)]}, {}, ["X", "Y"],
     "sub_result"),
    ("modified_huber_loss_kinks", "modified_huber_loss",
     {"X": [np.array([[-1.0], [1.0], [-2.0], [0.5], [2.0], [-0.3]], np.float32)],
      "Y": [np.array([[1.0], [1.0], [1.0], [0.0], [1.0], [0.0]], np.float32)]},
     {}, ["X"], "Out"),
    ("modified_huber_loss", "modified_huber_loss",
     {"X": [_randn(627, 6, 1) * 2], "Y": [_labels01(628, 6, 1)]}, {}, ["X"],
     "Out"),
    ("unique", "unique",
     {"X": [np.array([3, 1, 3, 2, 1, 7, 2, 3, 0], np.float32)]}, {}, [], None),
    ("unique_int_index_int64", "unique",
     {"X": [_ints(629, -3, 3, 3, 4, dtype=np.int32)]}, {"dtype": "int64"},
     [], None),
    ("unique_signed_zeros_nan", "unique",
     {"X": [np.array([0.0, -0.0, np.nan, 1.0, np.nan, -0.0, 1.0], np.float32)]},
     {}, [], None),
    ("size", "size", {"Input": [_randn(630, 3, 4, 5)]}, {}, [], None),
    ("size_empty", "size", {"Input": [np.zeros((0, 3), np.float32)]}, {}, [],
     None),
    ("fill_any_like", "fill_any_like", {"X": [_randn(631, 2, 3)]},
     {"value": 2.5, "dtype": -1}, [], None),
    ("fill_any_like_int32", "fill_any_like", {"X": [_randn(632, 2, 3)]},
     {"value": -2.5, "dtype": "int32"}, [], None),
    ("one_hot_v2", "one_hot_v2",
     {"X": [np.array([[0], [3], [1], [2]], np.int64)]}, {"depth": 4}, [], None),
    ("one_hot_v2_out_of_range", "one_hot_v2",
     {"X": [np.array([[4], [-1], [1], [9]], np.int64)]}, {"depth": 4}, [], None),
    ("crop_tensor", "crop_tensor", {"X": [_randn(633, 4, 5, 6)]},
     {"shape": [2, -1, 3], "offsets": [1, 0, 2]}, ["X"], "Out"),
    ("crop_tensor_shape_input", "crop_tensor",
     {"X": [_randn(634, 4, 5, 6)], "Shape": [np.array([3, 2, 0], np.int32)]},
     {"offsets": [1, 3, 0]}, ["X"], "Out"),
    ("crop_tensor_offsets_input_past_axis", "crop_tensor",
     {"X": [_randn(635, 4, 5, 6)], "Offsets": [np.array([3, -2, 5], np.int32)]},
     {"shape": [2, 3, 3]}, ["X"], "Out"),
    ("add_position_encoding", "add_position_encoding",
     {"X": [_randn(636, 2, 5, 8)]}, {"alpha": 0.7, "beta": 1.3}, ["X"], "Out"),
    ("add_position_encoding_d2", "add_position_encoding",
     {"X": [_randn(637, 2, 3, 2)]}, {}, ["X"], "Out"),
    ("lstm_unit", "lstm_unit",
     {"X": [_randn(638, 3, 16)], "C_prev": [_randn(639, 3, 4)]},
     {"forget_bias": 0.5}, ["X", "C_prev"], "H"),
    ("deformable_conv", "deformable_conv",
     {"Input": [_randn(640, 2, 4, 5, 6)],
      "Offset": [_randn(641, 2, 2 * 2 * 9, 5, 6) * 1.5],
      "Mask": [_r(642, 2, 2 * 9, 5, 6, lo=0, hi=1)],
      "Filter": [_randn(643, 4, 2, 3, 3)]},
     {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1], "groups": 2,
      "deformable_groups": 2}, ["Input", "Offset", "Mask", "Filter"], "Output"),
    ("deformable_conv_strided_no_mask", "deformable_conv",
     {"Input": [_randn(644, 1, 2, 7, 6)],
      "Offset": [_randn(645, 1, 2 * 4, 3, 4) * 2],
      "Filter": [_randn(646, 3, 2, 2, 2)]},
     {"strides": [2, 2], "paddings": [0, 1], "dilations": [2, 1]},
     ["Input", "Offset", "Filter"], "Output"),
    # -- misc_ops4 ------------------------------------------------------------
    ("fsp", "fsp", {"X": [_randn(647, 2, 3, 4, 5)], "Y": [_randn(648, 2, 2, 4, 5)]},
     {}, ["X", "Y"], "Out"),
    ("teacher_student_sigmoid_loss", "teacher_student_sigmoid_loss",
     {"X": [_randn(649, 8, 1) * 3],
      "Label": [np.array([[-2], [-1], [0.3], [1.5], [-2], [-1], [0.9], [1.0]],
                         np.float32)]}, {}, ["X"], "Y"),
    ("hash", "hash",
     {"X": [np.array([[1, 2, 3], [-1, 0, 7], [2 ** 40 + 5, 9, 1], [1, 2, 3]],
                     np.int64)]}, {"num_hash": 3, "mod_by": 1000}, [], None),
    ("hash_int32_large_mod", "hash",
     {"X": [_ints(650, -2 ** 31, 2 ** 31 - 1, 5, 1, dtype=np.int32)]},
     {"num_hash": 2, "mod_by": 2 ** 31 + 11}, [], None),
    ("average_accumulates", "average_accumulates", _avg_ins(651, 1, 0, 5), _AVG,
     ["param"], "out_sum_1"),
    ("average_accumulates_kmax_roll", "average_accumulates",
     _avg_ins(655, 1, 2, 16383), dict(_AVG, min_average_window=5),
     ["param", "in_sum_1"], "out_sum_2"),
    ("average_accumulates_window_full", "average_accumulates",
     _avg_ins(659, 7, 2, 40), _AVG, ["param", "in_sum_2"], "out_sum_3"),
    ("proximal_gd", "proximal_gd",
     {"Param": [_PROX_P], "Grad": [_PROX_G],
      "LearningRate": [np.array([0.5], np.float32)]}, {"l1": 0.1, "l2": 0.2},
     ["Param", "Grad"], "ParamOut"),
    ("is_empty", "is_empty", {"X": [_randn(663, 2, 3)]}, {}, [], None),
    ("is_empty_zero_rows", "is_empty", {"X": [np.zeros((0, 3), np.float32)]},
     {}, [], None),
    ("get_tensor_from_selected_rows_dense", "get_tensor_from_selected_rows",
     {"X": [_randn(664, 3, 2)]}, {}, ["X"], "Out"),
    ("merge_selected_rows_dense", "merge_selected_rows",
     {"X": [_randn(665, 3, 2)]}, {}, ["X"], "Out"),
    ("positive_negative_pair", "positive_negative_pair",
     {"Score": [np.round(_randn(666, 8, 1))],
      "Label": [_ints(667, 0, 3, 8, 1).astype(np.float32)],
      "QueryID": [np.array([[0], [0], [1], [0], [1], [1], [2], [0]], np.int64)]},
     {}, [], None),
    ("positive_negative_pair_weighted_accumulated", "positive_negative_pair",
     {"Score": [np.round(_randn(668, 6, 2))],
      "Label": [_ints(669, 0, 2, 6, 1).astype(np.float32)],
      "QueryID": [np.array([1, 1, 1, 2, 2, 1], np.int64)],
      "Weight": [_r(670, 6, 1, lo=0.5, hi=2)],
      "AccumulatePositivePair": [np.array([2.0], np.float32)],
      "AccumulateNegativePair": [np.array([1.0], np.float32)],
      "AccumulateNeutralPair": [np.array([0.5], np.float32)]},
     {"column": 0}, ["Weight"], "PositivePair"),
    ("scatter_nd", "scatter_nd",
     {"Index": [np.array([[0, 1], [2, 4], [0, 1], [1, -1]], np.int64)],
      "Updates": [_randn(671, 4, 3)]}, {"shape": [3, 5, 3]}, ["Updates"], "Out"),
    ("scatter_nd_out_of_range", "scatter_nd",
     {"Index": [np.array([[3], [1], [-4], [0]], np.int64)],
      "Updates": [_randn(672, 4, 2)]}, {"shape": [3, 2]}, ["Updates"], "Out"),
    ("soft_relu_at_threshold", "soft_relu",
     {"X": [np.array([[2.0, -2.0, 3.0], [-3.0, 0.5, 1.999]], np.float32)]},
     {"threshold": 2.0}, ["X"], "Out"),
    ("soft_relu", "soft_relu", {"X": [_randn(673, 3, 4) * 20]}, {}, ["X"], "Out"),
    ("conv3d_transpose", "conv3d_transpose",
     {"Input": [_randn(674, 1, 2, 3, 4, 3)], "Filter": [_randn(675, 2, 3, 2, 3, 2)]},
     {"strides": [2, 1, 2], "paddings": [0, 1, 1], "dilations": [1, 2, 1]},
     ["Input", "Filter"], "Output"),
    ("conv3d_transpose_plain", "conv3d_transpose",
     {"Input": [_randn(676, 2, 3, 2, 2, 2)], "Filter": [_randn(677, 3, 2, 2, 2, 2)]},
     {}, ["Input", "Filter"], "Output"),
    ("tree_conv", "tree_conv",
     {"NodesVector": [_randn(678, 2, 6, 3)], "EdgeSet": [_tree_edges()],
      "Filter": [_randn(679, 3, 3, 2, 4)]}, {"max_depth": 2},
     ["NodesVector", "Filter"], "Out"),
    ("tree_conv_depth_3", "tree_conv",
     {"NodesVector": [_randn(680, 2, 6, 2)], "EdgeSet": [_tree_edges()],
      "Filter": [_randn(681, 2, 3, 1, 3)]}, {"max_depth": 3},
     ["NodesVector", "Filter"], "Out"),
]

# raise in both packages: static offsets past the axis, indivisible shapes
REFUSALS_5 = [
    ("crop_offsets_past_axis", "crop", {"X": [_randn(682, 3, 5, 4)]},
     {"shape": [2, 3, 2], "offsets": [2, 1, 0]}),
    ("crop_tensor_offsets_past_axis", "crop_tensor", {"X": [_randn(683, 4, 5)]},
     {"shape": [2, 3], "offsets": [1, 3]}),
    ("space_to_depth_indivisible", "space_to_depth",
     {"X": [_randn(684, 1, 6, 4, 4)]}, {"blocksize": 2}),
    ("sequence_reshape_indivisible", "sequence_reshape",
     {"X": [_randn(685, 2, 4, 6)]}, {"new_dim": 5}),
]
