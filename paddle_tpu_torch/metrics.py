"""Python-side metrics (parity: python/paddle/fluid/metrics.py).  A copy of
the JAX package's ``metrics.py``: numpy on fetched values, on the host."""

import numpy as np

__all__ = ["MetricBase", "Accuracy", "Precision", "Recall", "Auc",
           "CompositeMetric", "ChunkEvaluator", "EditDistance", "DetectionMAP"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or type(self).__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1.0):
        self.value += float(np.asarray(value)) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("Accuracy: no updates")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        return self.tp / max(self.tp + self.fp, 1)


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        return self.tp / max(self.tp + self.fn, 1)


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self._num_thresholds + 1)
        self._stat_neg = np.zeros(self._num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_score = preds[:, -1] if preds.ndim > 1 else preds
        buckets = np.clip((pos_score * self._num_thresholds).astype(int), 0,
                          self._num_thresholds)
        for b, l in zip(buckets, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def eval(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.5
        tp = np.cumsum(self._stat_pos[::-1])[::-1]
        fp = np.cumsum(self._stat_neg[::-1])[::-1]
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        return float(-np.trapezoid(tpr, fpr))


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class ChunkEvaluator(MetricBase):
    """Parity: metrics.py:513 — accumulate chunk counts from the chunk_eval
    op (ops/misc_ops3.py) and report (precision, recall, f1)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks))
        self.num_label_chunks += int(np.asarray(num_label_chunks))
        self.num_correct_chunks += int(np.asarray(num_correct_chunks))

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(MetricBase):
    """Parity: metrics.py:611 — average edit distance + instance error rate
    from the edit_distance op's per-sequence distances."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num=None):
        d = np.asarray(distances, np.float64).reshape(-1)
        seq_num = int(seq_num) if seq_num is not None else d.size
        self.total_distance += float(d.sum())
        self.seq_num += seq_num
        self.instance_error += int((d > 0).sum())

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("EditDistance: no updates")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class DetectionMAP(MetricBase):
    """Mean average precision over detection results (parity:
    metrics.py:805 DetectionMAP / operators/detection/detection_map_op.cc).

    The reference evaluates mAP with graph ops inside the program; this
    translation accumulates on the host (detection outputs are tiny next to
    the model) — update() takes the multiclass_nms-format detections
    [[label, score, x1, y1, x2, y2], ...] plus ground-truth boxes/labels
    per image, eval() returns mAP (11-point or integral)."""

    def __init__(self, name=None, overlap_threshold=0.5,
                 evaluate_difficult=False, ap_version="integral"):
        super().__init__(name)
        assert ap_version in ("integral", "11point")
        self.overlap_threshold = overlap_threshold
        self.evaluate_difficult = evaluate_difficult
        self.ap_version = ap_version
        self.reset()

    def reset(self):
        self._dets = []      # (image_id, label, score, box)
        self._gts = []       # (image_id, label, box, difficult)
        self._img = 0

    def update(self, detections, gt_boxes, gt_labels, gt_difficult=None):
        img = self._img
        self._img += 1
        for det in np.asarray(detections, np.float64).reshape(-1, 6):
            if det[0] < 0:
                continue             # padding rows (static-shape NMS)
            self._dets.append((img, int(det[0]), float(det[1]), det[2:6]))
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        gt_labels = np.asarray(gt_labels).reshape(-1)
        if gt_difficult is None:
            gt_difficult = np.zeros(len(gt_labels), bool)
        gt_difficult = np.asarray(gt_difficult).reshape(-1).astype(bool)
        for box, lab, diff in zip(gt_boxes, gt_labels, gt_difficult):
            if lab < 0:
                continue
            self._gts.append((img, int(lab), box, bool(diff)))

    @staticmethod
    def _iou(a, b):
        ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = ix * iy
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def _ap(self, recalls, precisions):
        if self.ap_version == "11point":
            return float(np.mean([
                max([p for r, p in zip(recalls, precisions) if r >= t],
                    default=0.0)
                for t in np.linspace(0, 1, 11)]))
        ap, prev_r = 0.0, 0.0
        # integral AP over the PR curve (descending score order)
        for r, p in zip(recalls, precisions):
            ap += (r - prev_r) * p
            prev_r = r
        return float(ap)

    def eval(self):
        labels = sorted({lab for _, lab, _, _ in self._gts})
        aps = []
        for lab in labels:
            gts = [(img, box, diff) for img, l, box, diff in self._gts
                   if l == lab]
            # difficult GTs are excluded from npos (detection_map_op.cc
            # GetInputPos; evaluate_difficult=True counts them)
            npos = sum(1 for _, _, diff in gts
                       if self.evaluate_difficult or not diff)
            if npos == 0:
                continue
            dets = sorted((d for d in self._dets if d[1] == lab),
                          key=lambda d: -d[2])
            matched = set()
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for i, (img, _, _score, box) in enumerate(dets):
                # reference matching: pick the max-overlap GT over ALL GTs
                # of the image; TP only when overlap STRICTLY exceeds the
                # threshold AND that GT is unmatched; a match to an excluded
                # difficult GT is ignored (neither TP nor FP)
                best_iou, best_j = 0.0, -1
                for j, (gimg, gbox, _diff) in enumerate(gts):
                    if gimg != img:
                        continue
                    iou = self._iou(box, gbox)
                    if iou > best_iou:
                        best_iou, best_j = iou, j
                if best_iou > self.overlap_threshold and best_j >= 0:
                    if not self.evaluate_difficult and gts[best_j][2]:
                        continue                    # ignored (difficult)
                    if best_j in matched:
                        fp[i] = 1                   # GT already claimed
                    else:
                        tp[i] = 1
                        matched.add(best_j)
                else:
                    fp[i] = 1
            ctp, cfp = np.cumsum(tp), np.cumsum(fp)
            recalls = ctp / npos
            precisions = ctp / np.maximum(ctp + cfp, 1e-12)
            aps.append(self._ap(recalls, precisions))
        return float(np.mean(aps)) if aps else 0.0
