"""Pure-numpy oracles for the reference's custom operators.

These are sequential, loop-level transcriptions of the *behavior* of the
reference C++ CPU kernels (cited per function), used only as property-test
oracles for the fixed-shape JAX ops (tests/ and chip_smoke.py). They favor
legibility over speed; only the IoU table and the greedy scan's argmax are
numpy-vectorized, so the oracles also run at full anchor counts.
"""

from __future__ import annotations

import math

import numpy as np


def multibox_prior_oracle(fh, fw, sizes, ratios, steps=(-1.0, -1.0), offsets=(0.5, 0.5), clip=False):
    """Oracle for operator/multibox_prior.cc:30-71 (+-inl.h:119-128)."""
    if steps[0] > 0 and steps[1] > 0:
        step_y, step_x = steps[0], steps[1]
    else:  # C++ resets BOTH when either is unset (multibox_prior-inl.h)
        step_y, step_x = 1.0 / fh, 1.0 / fw
    out = []
    for r in range(fh):
        cy = (r + offsets[0]) * step_y
        for c in range(fw):
            cx = (c + offsets[1]) * step_x
            for s in sizes:
                w = s * fh / fw / 2.0
                h = s / 2.0
                out.append([cx - w, cy - h, cx + w, cy + h])
            s0 = sizes[0]
            for ratio in ratios[1:]:
                sr = math.sqrt(ratio)
                w = s0 * fh / fw * sr / 2.0
                h = s0 / sr / 2.0
                out.append([cx - w, cy - h, cx + w, cy + h])
    out = np.asarray(out, np.float32)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    return out


def _iou(a, b):
    """IoU of two corner boxes with the zero-union guard
    (multibox_target-inl.h:44-50,154-161)."""
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    if union == 0.0:
        return 0.0
    return inter / union


def _iou_table(anchors, gts):
    """(A, L) float64 IoU table, :func:`_iou` vectorized."""
    a = np.asarray(anchors, np.float64)[:, None, :]
    g = np.asarray(gts, np.float64)[None, :, :]
    iw = np.maximum(0.0, np.minimum(a[..., 2], g[..., 2]) - np.maximum(a[..., 0], g[..., 0]))
    ih = np.maximum(0.0, np.minimum(a[..., 3], g[..., 3]) - np.maximum(a[..., 1], g[..., 1]))
    inter = iw * ih
    union = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
             + (g[..., 2] - g[..., 0]) * (g[..., 3] - g[..., 1]) - inter)
    safe = np.where(union == 0.0, 1.0, union)
    return np.where(union == 0.0, 0.0, inter / safe)


def bipartite_match_oracle(overlaps, num_valid):
    """Phase 1 of operator/multibox_target.cc:113-149: repeatedly match the
    best (anchor, gt) pair among the unmatched ones while its IoU > 1e-6.

    The C++ scan is row-major with a strict ``>``, so it keeps the FIRST
    maximum in row-major order — which is what ``np.argmax`` over the
    flattened table returns. Returns (match_gt (A,) int, -1 if unmatched;
    match_iou (A,) float, -1 if unmatched).
    """
    A = overlaps.shape[0]
    match_gt = np.full(A, -1)
    match_iou = np.full(A, -1.0)
    if num_valid == 0:
        return match_gt, match_iou
    ov = np.array(overlaps[:, :num_valid], np.float64)
    for _ in range(num_valid):
        j, k = divmod(int(np.argmax(ov)), num_valid)
        if ov[j, k] <= 1e-6:
            break
        match_gt[j], match_iou[j] = k, ov[j, k]
        ov[j, :] = -1.0  # anchor and gt are both consumed
        ov[:, k] = -1.0
    return match_gt, match_iou


def multibox_target_oracle(
    anchors,
    labels,
    cls_preds,
    overlap_threshold=0.5,
    ignore_label=-1.0,
    negative_mining_ratio=-1.0,
    negative_mining_thresh=0.5,
    variances=(0.1, 0.1, 0.2, 0.2),
    overlaps=None,
):
    """Oracle for operator/multibox_target.cc:73-284.

    anchors (A, 4), labels (B, L, 6), cls_preds (B, C, A) ->
    loc_target (B, A, 5), loc_mask (B, A, 5), cls_target (B, A).

    ``overlaps``: optional (B, A, L) anchor-GT IoU table to use instead of
    the float64 one computed here — given the op's own float32 table, every
    IoU threshold decision sees the values the op saw.
    """
    anchors = np.asarray(anchors, np.float64)
    labels = np.asarray(labels, np.float64)
    cls_preds = np.asarray(cls_preds, np.float64)
    B, L, _ = labels.shape
    A = anchors.shape[0]
    C = cls_preds.shape[1]
    loc_target = np.zeros((B, A, 5))
    loc_mask = np.zeros((B, A, 5))
    cls_target = np.full((B, A), ignore_label)

    for b in range(B):
        num_valid = 0
        for i in range(L):
            if labels[b, i, 0] == -1.0:
                break
            num_valid += 1
        if num_valid == 0:
            continue

        if overlaps is None:
            iou = _iou_table(anchors, labels[b, :num_valid, 1:5])
        else:
            iou = np.asarray(overlaps[b, :, :num_valid], np.float64)

        # phase 1: greedy bipartite (cc:113-149)
        mg, mi = bipartite_match_oracle(iou, num_valid)
        match_gt = [int(g) for g in mg]
        match_iou = [float(v) for v in mi]
        anchor_flags = [1 if g >= 0 else -1 for g in match_gt]  # -1 ignore, 0 negative, 1 positive
        num_positive = sum(f == 1 for f in anchor_flags)

        # phase 2: threshold matching (cc:151-180)
        if overlap_threshold > 0:
            for j in range(A):
                if anchor_flags[j] == 1:
                    continue
                best_gt, max_iou = -1, -1.0
                for k in range(num_valid):
                    if iou[j, k] > max_iou:
                        best_gt, max_iou = k, iou[j, k]
                if best_gt != -1:
                    match_iou[j] = max_iou
                    match_gt[j] = best_gt
                    if max_iou > overlap_threshold:
                        num_positive += 1
                        anchor_flags[j] = 1

        # phase 3: negatives (cc:182-249)
        if negative_mining_ratio > 0:
            num_negative = int(num_positive * negative_mining_ratio)
            num_negative = min(num_negative, A - num_positive)
            if num_negative > 0:
                cand = []
                for j in range(A):
                    if anchor_flags[j] == 1:
                        continue
                    if match_iou[j] < 0:
                        best_gt, max_iou = -1, -1.0
                        for k in range(num_valid):
                            if iou[j, k] > max_iou:
                                best_gt, max_iou = k, iou[j, k]
                        if best_gt != -1:
                            match_iou[j] = max_iou
                            match_gt[j] = best_gt
                    if match_iou[j] < negative_mining_thresh and anchor_flags[j] == -1:
                        logits = cls_preds[b, :, j]
                        m = logits.max()
                        prob0 = math.exp(logits[0] - m) / np.exp(logits - m).sum()
                        cand.append((-prob0, j))
                # std::stable_sort on descending -prob == ascending prob,
                # ties keep anchor order
                cand.sort(key=lambda t: t[0], reverse=True)
                for _, j in cand[:num_negative]:
                    anchor_flags[j] = 0
        else:
            for j in range(A):
                if anchor_flags[j] != 1:
                    anchor_flags[j] = 0

        # target assignment (cc:251-281)
        vx, vy, vw, vh = variances
        for j in range(A):
            if anchor_flags[j] == 1:
                g = labels[b, match_gt[j]]
                cls_target[b, j] = g[0] + 1
                loc_mask[b, j, :] = 1
                al, at, ar, ab = anchors[j]
                aw, ah = ar - al, ab - at
                ax, ay = (al + ar) / 2, (at + ab) / 2
                gl, gt_, gr, gb, gz = g[1], g[2], g[3], g[4], g[5]
                gw, gh = gr - gl, gb - gt_
                gx, gy = (gl + gr) / 2, (gt_ + gb) / 2
                loc_target[b, j] = [
                    (gx - ax) / aw / vx,
                    (gy - ay) / ah / vy,
                    math.log(gw / aw) / vw,
                    math.log(gh / ah) / vh,
                    gz / 0.1,
                ]
            elif anchor_flags[j] == 0:
                cls_target[b, j] = 0
    return loc_target, loc_mask, cls_target


def multibox_detection_oracle(
    cls_prob,
    loc_pred,
    anchors,
    threshold=0.01,
    clip=True,
    variances=(0.1, 0.1, 0.2, 0.2),
    nms_threshold=0.5,
    force_suppress=False,
    nms_topk=400,
):
    """Oracle for operator/multibox_detection.cc:53-169.

    Returns the full (B, A, 7) buffer with the reference's exact semantics,
    including the unsorted-tail quirk when valid_count > nms_topk.
    """
    cls_prob = np.asarray(cls_prob, np.float64)
    loc_pred = np.asarray(loc_pred, np.float64).reshape(cls_prob.shape[0], -1, 5)
    anchors = np.asarray(anchors, np.float64).reshape(-1, 4)
    B, C, A = cls_prob.shape
    vx, vy, vw, vh = variances
    out = np.full((B, A, 7), -1.0)

    for b in range(B):
        valid = 0
        for i in range(A):
            score, cid = -1.0, 0
            for j in range(1, C):
                if cls_prob[b, j, i] > score:
                    score, cid = cls_prob[b, j, i], j
            if cid > 0 and score < threshold:
                cid = 0
            if cid > 0:
                al, at, ar, ab = anchors[i]
                aw, ah = ar - al, ab - at
                ax, ay = (al + ar) / 2, (at + ab) / 2
                px, py, pw, ph, pz = loc_pred[b, i]
                ox = px * vx * aw + ax
                oy = py * vy * ah + ay
                ow = math.exp(pw * vw) * aw / 2
                oh = math.exp(ph * vh) * ah / 2
                oz = pz * 0.1
                row = [ox - ow, oy - oh, ox + ow, oy + oh, oz]
                if clip:
                    row = [min(1.0, max(0.0, v)) for v in row]
                out[b, valid] = [cid - 1, score] + row[:4] + [row[4]]
                valid += 1
        if valid < 1 or nms_threshold <= 0 or nms_threshold > 1:
            continue
        temp = out[b].copy()
        order = sorted(range(valid), key=lambda i: -out[b, i, 1])  # stable
        nkeep = min(valid, nms_topk) if nms_topk > 0 else valid
        for i in range(nkeep):
            out[b, i] = temp[order[i]]
        greedy_nms_oracle(out[b], valid, nms_threshold, force_suppress)
    return out


def greedy_nms_oracle(rows, n, nms_threshold, force_suppress=False):
    """Greedy NMS over the first ``n`` rows ``[id, score, x1, y1, x2, y2,
    ...]`` in their order (multibox_detection.cc:144-166): a kept row sets
    the id of every later same-class (any class with ``force_suppress``)
    row with IoU >= threshold to -1; rows with id < 0 take no part.
    Modifies ``rows`` in place and returns it."""
    for i in range(n):
        if rows[i, 0] < 0:
            continue
        for j in range(i + 1, n):
            if rows[j, 0] < 0:
                continue
            if force_suppress or rows[i, 0] == rows[j, 0]:
                if _iou(rows[i, 2:6], rows[j, 2:6]) >= nms_threshold:
                    rows[j, 0] = -1
    return rows
