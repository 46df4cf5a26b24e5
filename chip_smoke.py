"""Drive DSPNet's main path once on NVIDIA GPUs and check what comes out.

Run from the repository root:

    python chip_smoke.py          # one GPU: device, kernels, infer, train
    python chip_smoke.py --four   # four GPUs: data-parallel train step only

Phases, in one process so that compiles are shared:

* ``device``: what JAX sees, the card's name and power limit
  (``nvidia-smi``), versions, the compile-cache directory and which
  optional packages import.
* ``kernels``: decode+NMS and MultiBoxTarget at full anchor counts against
  the numpy oracles of ``tests/oracles.py``, and their times alone.
* ``infer``: the b128 512x512 bf16 inference program, ``Detector.predict_raw``
  at b1 512x1024 on uint8 frames, and the float32 forward at default (TF32)
  against highest matmul precision.
* ``train``: ``MultiTaskSolver`` at 512x1024: five bf16 steps at b8 and one
  float32 step.
* ``four`` (``--four``, and then the only compute phase): one float32 train
  step over a global batch of 16 on a data=4 mesh and on a data=2 x model=2
  spatial mesh, each against one GPU, leaf by leaf; then the data=4 bf16
  step time.

Every phase raises on a failed check. The last line printed is one JSON
object, ``{"ok": true, "device": {...}}``, printed only after every phase
passed. ``main`` refuses any platform but ``gpu``. The phase functions take
their sizes as arguments so that the tests can run them small on a CPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import numpy as np

NETWORK = "resnet-50_multi"
NUM_CLASSES = 8  # det classes; the seg head has 19

# float32 forward, TF32 (default precision on tensor cores) vs "highest":
# TF32 keeps 10 mantissa bits (relative rounding 2^-11 = 4.9e-4 per
# operand) and ~60 conv layers compound it to ~1e-2 of the logit scale at
# most; a wrong kernel or layout shows as O(1). Pixels whose two best seg
# logits lie within that error may flip their argmax.
TF32_MAX_REL_DIFF = 3e-2
TF32_MIN_SEG_AGREEMENT = 0.95

# --four: a mesh changes only the order of float32 reductions (per-shard
# partial sums, then an all-reduce) and the per-device batch the conv
# algorithms see, so its step must reproduce one GPU's as closely as
# reordering the same sums on one GPU does. At random init the step is
# dominated by cancellation (permuting the batch rows on one device moves
# the gradients by a few percent), so the noise floor is measured in the
# same run: one GPU, same batch with its rows permuted. For the updated
# params, the first update (the momentum buffer) and batch_stats:
#   relative L2 over all leaves: mesh <= FOUR_NOISE_FACTOR * permuted + FOUR_FLOOR
#   each leaf: max |x_mesh - x_one| <= FOUR_LEAF_FACTOR * max |x_permuted - x_one|
#                                      + FOUR_FLOOR * max |x_one|
# The BN statistics are the exception: a channel mean of normalised
# activations is a cancelling sum (bn0's mean is ~1e-3 of the activations'
# RMS), and splitting it into per-shard partial sums moves it by float32
# rounding of the RMS, not of the mean, while permuting the batch on one
# GPU barely moves it. So each running mean and var is compared per
# channel on the scale its sum has, (1 - momentum) * sqrt(E[x^2]) and
# (1 - momentum) * E[x^2] of the batch (read back from the one-GPU
# running stats, which start at mean 0, var 1):
#   |stat_mesh - stat_one| <= FOUR_LEAF_FACTOR * max |stat_permuted - stat_one|
#                             + FOUR_STATS_RTOL * scale
# A sharding fault (a dropped shard, a double-counted all-reduce, per-shard
# BN statistics) moves the loss, the statistics or every update by O(1);
# per-shard statistics over random images move a mean by ~1/sqrt(pixels
# per shard) ~ 1e-3 of its scale at 512x1024.
FOUR_LOSS_RTOL = 1e-4
FOUR_NOISE_FACTOR = 3.0
FOUR_LEAF_FACTOR = 10.0
FOUR_FLOOR = 1e-5
FOUR_STATS_RTOL = 1e-5

def log(msg: str) -> None:
    print(msg, flush=True)


def _max_rel(a, b) -> float:
    """max |a - b| / max |b| (0 for an all-zero b equal to a)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = np.max(np.abs(b)) if b.size else 0.0
    diff = np.max(np.abs(a - b)) if b.size else 0.0
    return float(diff / scale) if scale > 0 else float(diff)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------- device


def phase_device() -> dict:
    import jax
    import jaxlib

    from dspnet_tpu.utils.benchmark import gpu_name_and_power_limit

    devs = jax.devices()
    log(f"[device] jax {jax.__version__} jaxlib {jaxlib.__version__}; "
        f"{len(devs)} device(s): platform={devs[0].platform} "
        f"kind={devs[0].device_kind!r}")
    log(f"[device] nvidia-smi name, power.limit: {gpu_name_and_power_limit()}")
    log(f"[device] compile cache: {jax.config.jax_compilation_cache_dir}")
    found = {}
    for name in ("flax", "cv2", "orbax.checkpoint"):
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    log(f"[device] optional packages importable: {found}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# --------------------------------------------------------------- kernels


def synthetic_detections(anchors, batch: int, seed: int = 0, objects: int = 20,
                         per_object: int = 16):
    """(cls_prob (B, C, A), loc_preds (B, A, 5)) float32 with ``objects``
    clusters of ``per_object`` consecutive (so overlapping) anchors per
    image above the 0.01 score threshold, each cluster of one class, and
    every other anchor below it: NMS has real suppression to do and the
    valid count stays under K=400, where the op and the reference agree
    row for row."""
    rng = np.random.RandomState(seed)
    A = anchors.shape[0]
    C = NUM_CLASSES + 1
    logits = rng.randn(batch, C, A).astype(np.float32)
    logits[:, 0] = 9.0  # background: every foreground prob < 0.01
    for b in range(batch):
        for start in rng.randint(0, A - per_object, objects):
            idx = np.arange(start, start + per_object)
            logits[b, 0, idx] = rng.uniform(-2.0, 2.0, per_object)
            logits[b, 1 + rng.randint(NUM_CLASSES), idx] += 3.0
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    cls_prob = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
    loc = (rng.randn(batch, A, 5) * 0.5).astype(np.float32)
    return cls_prob, loc


def synthetic_labels(batch: int, gt_counts, num_labels: int = 200,
                     seed: int = 0):
    """(B, L, 6) rows ``[cls, x1, y1, x2, y2, dist]``; image b has
    ``gt_counts[b % len(gt_counts)]`` valid rows, then -1 padding."""
    rng = np.random.RandomState(seed)
    labels = np.full((batch, num_labels, 6), -1.0, np.float32)
    for b in range(batch):
        n = gt_counts[b % len(gt_counts)]
        w = rng.uniform(0.02, 0.4, n)
        h = rng.uniform(0.02, 0.4, n)
        x1 = rng.uniform(0.0, 1.0 - w)
        y1 = rng.uniform(0.0, 1.0 - h)
        labels[b, :n] = np.stack([rng.randint(0, NUM_CLASSES, n), x1, y1,
                                  x1 + w, y1 + h, rng.uniform(0.05, 1.0, n)],
                                 -1)
    return labels


def phase_kernels(nms_hw=(512, 512), nms_batch: int = 128, nms_checked: int = 8,
                  target_hw=(512, 1024), target_batch: int = 8,
                  gt_counts=(0, 1, 7, 16, 50), n_timed: int = 20) -> dict:
    """decode+NMS and MultiBoxTarget, float32, against tests/oracles.py;
    returns their times alone (ms)."""
    import jax

    from dspnet_tpu.api import create_model
    from dspnet_tpu.ops import boxes as box_ops
    from dspnet_tpu.ops.detection import multibox_detection
    from dspnet_tpu.ops.target import multibox_target
    from dspnet_tpu.utils.benchmark import timed
    from tests import oracles

    # decode + NMS at K=400 on the anchors of the b128 inference program
    anchors = create_model(NETWORK, nms_hw, NUM_CLASSES).anchors
    cls_prob, loc = synthetic_detections(anchors, nms_batch)
    detect = jax.jit(lambda c, l: multibox_detection(
        c, l, anchors, threshold=0.01, nms_threshold=0.45, nms_topk=400))
    cls_dev, loc_dev = jax.device_put((cls_prob, loc))
    got = np.asarray(detect(cls_dev, loc_dev))
    idx = np.linspace(0, nms_batch - 1, nms_checked).astype(int)
    want = oracles.multibox_detection_oracle(
        cls_prob[idx], loc[idx], anchors, threshold=0.01, nms_threshold=0.45,
        nms_topk=400)
    valid = (want[:, :, 1] >= 0).sum(axis=1)
    _check(valid.max() <= 400, f"synthetic valid counts {valid} exceed K")
    want = want[:, :400]
    got = got[idx]
    _check(np.array_equal(got[..., 0] >= 0, want[..., 0] >= 0),
           "NMS keep mask differs from the oracle")
    _check(np.array_equal(got[..., 0], want[..., 0]),
           "class ids / suppression differ from the oracle")
    rel = _max_rel(got[..., 1:], want[..., 1:])
    _check(np.allclose(got[..., 1:], want[..., 1:], rtol=1e-5, atol=1e-6),
           f"scores/boxes/distances differ from the oracle (max rel {rel:.3g})")
    kept = int((got[..., 0] >= 0).sum())
    log(f"[kernels] decode+NMS A={anchors.shape[0]} K=400, {nms_checked} of "
        f"{nms_batch} images vs oracle: keep masks and ids equal "
        f"({int(valid.sum())} valid rows, {kept} kept, "
        f"{int(valid.sum()) - kept} suppressed); rows max rel diff {rel:.3g}")
    nms_ms = timed(detect, cls_dev, loc_dev, n=n_timed) * 1e3
    log(f"[kernels] decode+NMS b{nms_batch} alone: {nms_ms:.3f} ms")

    # MultiBoxTarget on the train resolution's anchors
    anchors = create_model(NETWORK, target_hw, NUM_CLASSES).anchors
    labels = synthetic_labels(target_batch, gt_counts)
    cls_preds = np.random.RandomState(1).randn(
        target_batch, NUM_CLASSES + 1, anchors.shape[0]).astype(np.float32)
    target = jax.jit(lambda l, c: multibox_target(
        anchors, l, c, overlap_threshold=0.5, negative_mining_ratio=3.0,
        negative_mining_thresh=0.5))
    lab_dev, cls_dev = jax.device_put((labels, cls_preds))
    loc_t, loc_m, cls_t = (np.asarray(x) for x in target(lab_dev, cls_dev))
    ious = np.asarray(jax.jit(jax.vmap(
        lambda l: box_ops.iou_matrix(anchors, l[:, 1:5])))(lab_dev))
    w_loc_t, w_loc_m, w_cls_t = oracles.multibox_target_oracle(
        anchors, labels, cls_preds, overlap_threshold=0.5,
        negative_mining_ratio=3.0, negative_mining_thresh=0.5, overlaps=ious)
    _check(np.array_equal(cls_t, w_cls_t), "cls_target differs from the oracle")
    _check(np.array_equal(loc_m, w_loc_m), "loc_mask differs from the oracle")
    # relative to the largest target: a small offset like (gx - ax) / aw
    # / 0.1 cancels in float32 and carries absolute, not relative, error
    rel = _max_rel(loc_t, w_loc_t)
    _check(rel <= 1e-5, f"loc_target differs from the oracle (max rel {rel:.3g})")
    counts = [gt_counts[b % len(gt_counts)] for b in range(target_batch)]
    log(f"[kernels] multibox_target A={anchors.shape[0]} b{target_batch} "
        f"(valid GT rows {counts} of {labels.shape[1]}) vs oracle: cls_target "
        f"and loc_mask equal ({int((w_cls_t > 0).sum())} positives, "
        f"{int((w_cls_t == 0).sum())} negatives); loc_target max rel diff "
        f"{rel:.3g}")
    target_ms = timed(target, lab_dev, cls_dev, n=n_timed) * 1e3
    log(f"[kernels] multibox_target b{target_batch} alone: {target_ms:.3f} ms")
    return {"nms_ms": nms_ms, "target_ms": target_ms}


# ----------------------------------------------------------------- infer


def _init_variables(model, hw, seed: int = 0):
    import jax
    import jax.numpy as jnp

    return jax.jit(lambda r, x: model.init(r, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 3), jnp.float32))


def _check_det_seg(det, seg, batch: int, hw, num_anchors: int, what: str):
    det = np.asarray(det)
    seg = np.asarray(seg)
    k = min(400, num_anchors)  # nms_topk rows
    _check(det.shape == (batch, k, 7), f"{what}: det shape {det.shape}")
    _check(bool(np.isfinite(det).all()), f"{what}: non-finite det rows")
    _check(seg.shape == (batch, hw[0] // 4, hw[1] // 4),
           f"{what}: seg shape {seg.shape}")
    _check(int(seg.min()) >= 0 and int(seg.max()) < 19,
           f"{what}: seg ids outside [0, 19)")


def phase_infer(hw=(512, 512), batch: int = 128, serve_hw=(512, 1024),
                precision_batch: int = 2, n_timed: int = 10) -> dict:
    import jax
    import jax.numpy as jnp

    from dspnet_tpu.api import create_model
    from dspnet_tpu.detect.detector import Detector
    from dspnet_tpu.utils.benchmark import inference_program, timed
    from dspnet_tpu.utils.precision import bf16_variables

    bundle = create_model(NETWORK, hw, NUM_CLASSES)
    variables = _init_variables(bundle.model, hw)
    images = jax.random.normal(jax.random.PRNGKey(1), (batch, *hw, 3),
                               jnp.float32)
    forward = inference_program(bundle.model, bundle.anchors)
    v16 = bf16_variables(variables)
    t0 = time.perf_counter()
    det, seg = forward(v16, images)
    _check_det_seg(det, seg, batch, hw, bundle.num_anchors, "inference program")
    compile_s = time.perf_counter() - t0
    infer_ms = timed(forward, v16, images, n=n_timed) * 1e3
    log(f"[infer] b{batch} {hw[0]}x{hw[1]} bf16 forward+decode+NMS+seg argmax: "
        f"finite, shapes ok; first call {compile_s:.1f} s, then "
        f"{infer_ms:.3f} ms/batch ({batch / infer_ms * 1e3:.1f} img/s)")

    # float32 forward: TF32 (default precision) vs highest
    apply = jax.jit(lambda v, x: bundle.model.apply(v, x, train=False))
    x = images[:precision_batch]
    outs = {}
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            outs[prec] = jax.tree.map(np.asarray, apply(variables, x))
    rel = {k: _max_rel(outs["default"][k], outs["highest"][k])
           for k in outs["highest"]}
    agree = float(np.mean(np.argmax(outs["default"]["seg_logits"], -1)
                          == np.argmax(outs["highest"]["seg_logits"], -1)))
    log(f"[infer] f32 b{precision_batch} forward, default vs highest matmul "
        f"precision: max rel diff {rel}; seg argmax agreement {agree:.5f} "
        f"(limits {TF32_MAX_REL_DIFF}, {TF32_MIN_SEG_AGREEMENT})")
    _check(all(np.isfinite(v).all() for v in outs["highest"].values()),
           "non-finite f32 outputs")
    _check(max(rel.values()) <= TF32_MAX_REL_DIFF,
           f"default-precision logits differ by {rel}")
    _check(agree >= TF32_MIN_SEG_AGREEMENT, f"seg argmax agreement {agree}")

    # the serving entry: Detector.predict_raw on uint8 BGR frames
    sb = create_model(NETWORK, serve_hw, NUM_CLASSES)
    det_api = Detector(sb.model, bf16_variables(_init_variables(sb.model, serve_hw)),
                       sb.anchors, serve_hw)
    frame = np.random.RandomState(2).randint(0, 256, (1, *serve_hw, 3), np.uint8)

    def serve():
        return {k: np.asarray(v) for k, v in det_api.predict_raw(frame).items()}

    res = serve()
    _check_det_seg(res["det"], res["seg"], 1, serve_hw, sb.num_anchors,
                   "Detector.predict_raw")
    serve_ms = timed(serve, n=n_timed) * 1e3
    log(f"[infer] Detector.predict_raw b1 {serve_hw[0]}x{serve_hw[1]} uint8: "
        f"finite, shapes ok; {serve_ms:.3f} ms/call with host transfers")
    return {"infer_ms": infer_ms, "serve_ms": serve_ms}


# ----------------------------------------------------------------- train


def _memory_line(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory analysis unavailable"
    return (f"arguments {ma.argument_size_in_bytes / 2**30:.3f} GiB, outputs "
            f"{ma.output_size_in_bytes / 2**30:.3f} GiB, temporaries "
            f"{ma.temp_size_in_bytes / 2**30:.3f} GiB, aliased "
            f"{ma.alias_size_in_bytes / 2**30:.3f} GiB")


def phase_train(hw=(512, 1024), batch: int = 8, steps: int = 5) -> dict:
    import jax
    import jax.numpy as jnp

    from dspnet_tpu.api import create_model
    from dspnet_tpu.train.solver import MultiTaskSolver
    from dspnet_tpu.utils.benchmark import canonical_train_batch

    H, W = hw
    bundle = create_model(NETWORK, hw, NUM_CLASSES)
    result = {}
    for dtype, pre_s2d, n in (("bfloat16", True, steps), ("float32", False, 1)):
        # seg loss normalized by valid pixels: the reference's per-pixel
        # sum (seg_normalize="null") is calibrated to lr 5e-4 and diverges
        # within a few steps at the solver's default lr 1e-3
        solver = MultiTaskSolver(bundle.model, bundle.anchors,
                                 compute_dtype=dtype, batch_size=batch,
                                 seg_normalize="valid")
        state = solver.init_state(jax.random.PRNGKey(0),
                                  jnp.zeros((1, H, W, 3)))
        data = canonical_train_batch(batch, H, W, pre_s2d=pre_s2d)
        t0 = time.perf_counter()
        compiled = solver.lower_train_step(state, data).compile()
        log(f"[train] {dtype} b{batch} {H}x{W} step compiled in "
            f"{time.perf_counter() - t0:.1f} s: {_memory_line(compiled)}")
        losses = []
        t0 = time.perf_counter()
        for i in range(n):
            if i == 1:
                jax.block_until_ready(state)
                t0 = time.perf_counter()
            state, metrics = solver.train_step(state, data)
            losses.append(metrics["loss"])
        jax.block_until_ready(state)
        step_ms = (time.perf_counter() - t0) / max(n - 1, 1) * 1e3
        losses = [float(x) for x in losses]
        _check(all(np.isfinite(losses)), f"{dtype} losses {losses}")
        _check(max(losses) <= 10 * losses[0], f"{dtype} loss diverges: {losses}")
        _check(int(state.step) == n, f"{dtype} state.step {int(state.step)}")
        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        log(f"[train] {dtype} losses {losses}; "
            + (f"{step_ms:.3f} ms/step over steps 2..{n}; " if n > 1 else "")
            + (f"device peak {peak / 2**30:.3f} GiB" if peak else
               "device peak not reported"))
        result[dtype] = step_ms
        del state, data, compiled
    return {"train_ms": result["bfloat16"]}


# ------------------------------------------------------------------ four


def _one_step(host_batch, hw, global_batch: int, mesh, spatial: bool,
              remat: bool = False):
    """One float32 train step from PRNGKey(0) on ``mesh`` (None: one
    device). Returns the loss, the initial params and the host copies of
    (params, momentum buffer, batch_stats) after the step."""
    import jax
    import jax.numpy as jnp

    from dspnet_tpu.api import create_model
    from dspnet_tpu.parallel.mesh import shard_batch
    from dspnet_tpu.train.solver import MultiTaskSolver

    bundle = create_model(NETWORK, hw, NUM_CLASSES, remat=remat)
    solver = MultiTaskSolver(bundle.model, bundle.anchors,
                             batch_size=global_batch, mesh=mesh,
                             spatial=spatial, seg_normalize="valid")
    state = solver.init_state(jax.random.PRNGKey(0),
                              jnp.zeros((1, *hw, 3), jnp.float32))
    init = jax.device_get(state.params)
    batch = (jax.device_put(host_batch) if mesh is None
             else shard_batch(mesh, host_batch, spatial=spatial))
    state, metrics = solver.train_step(state, batch)
    after = jax.device_get((state.params, state.opt_state.momentum,
                            state.batch_stats))
    return float(metrics["loss"]), init, after


def _leaves(tree):
    import jax

    return [(jax.tree_util.keystr(p), np.asarray(v, np.float64))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _stats_scales(batch_stats) -> dict:
    """Per-channel scale of each running BN statistic after one step from
    mean 0, var 1 (see FOUR_STATS_RTOL), keyed like :func:`_leaves`."""
    import jax

    from dspnet_tpu.models.layers import BN_MOMENTUM

    m = BN_MOMENTUM
    scales = {}

    def visit(path, node):
        if "mean" in node and "var" in node:
            mean = np.asarray(node["mean"], np.float64) / (1 - m)
            var = (np.asarray(node["var"], np.float64) - m) / (1 - m)
            sq = np.maximum(var, 0.0) + mean ** 2  # E[x^2] of the batch
            key = jax.tree_util.keystr(path)
            scales[key + "['mean']"] = (1 - m) * np.sqrt(sq)
            scales[key + "['var']"] = (1 - m) * sq
        for k, v in node.items():
            if isinstance(v, dict):
                visit(path + (jax.tree_util.DictKey(k),), v)

    visit((), batch_stats)
    return scales


def _compare_step(name, one, permuted, got) -> str:
    """``got`` (a mesh) against ``one`` (one GPU) within the noise floor
    that ``permuted`` (one GPU, batch rows permuted) shows."""
    loss1, init1, after1 = one
    lossn, initn, aftern = got
    _check(np.isfinite(loss1) and np.isfinite(lossn), f"{name}: non-finite loss")
    rel = abs(lossn - loss1) / abs(loss1)
    _check(rel <= FOUR_LOSS_RTOL, f"{name}: loss {lossn!r} vs one GPU {loss1!r}")
    for (path, a), (_, b) in zip(_leaves(init1), _leaves(initn)):
        _check(np.array_equal(a, b), f"{name}: initial {path} differs")
    parts = [f"loss {lossn!r} vs {loss1!r} (rel {rel:.3g})"]
    stats_scales = _stats_scales(after1[2])
    for what, x1, xp, xn in zip(("params", "first update", "batch_stats"),
                                after1, permuted[2], aftern):
        worst, sq_n, sq_p, sq_1 = 0.0, 0.0, 0.0, 0.0
        for (path, a), (_, p), (_, b) in zip(_leaves(x1), _leaves(xp),
                                             _leaves(xn)):
            if what == "batch_stats":
                dn, dp = np.abs(b - a), np.max(np.abs(p - a))
                bound = FOUR_LEAF_FACTOR * dp + FOUR_STATS_RTOL * stats_scales[path]
            else:
                dn, dp = np.max(np.abs(b - a)), np.max(np.abs(p - a))
                bound = FOUR_LEAF_FACTOR * dp + FOUR_FLOOR * np.max(np.abs(a))
            ratio = np.max(np.where(bound > 0, dn / np.where(bound > 0, bound, 1),
                                    np.where(dn > 0, np.inf, 0.0)))
            _check(ratio <= 1, f"{name}: {what} {path} differs by "
                   f"{np.max(dn):.3g}, {ratio:.3g} times its bound "
                   f"(permuted batch: {dp:.3g})")
            worst = max(worst, float(ratio))
            sq_n += np.sum((b - a) ** 2)
            sq_p += np.sum((p - a) ** 2)
            sq_1 += np.sum(a ** 2)
        rel_n, rel_p = np.sqrt(sq_n / sq_1), np.sqrt(sq_p / sq_1)
        _check(rel_n <= FOUR_NOISE_FACTOR * rel_p + FOUR_FLOOR,
               f"{name}: {what} rel L2 {rel_n:.3g} vs permuted batch "
               f"{rel_p:.3g}")
        parts.append(f"{what}: rel L2 {rel_n:.3g} (permuted batch "
                     f"{rel_p:.3g}), worst leaf at {worst:.2f} of its bound")
    return "; ".join(parts)


def phase_four(hw=(512, 1024), global_batch: int = 16, per_device_bf16: int = 4,
               remat: bool = False, n_timed: int = 5) -> dict:
    """float32 at highest precision: data=4 and data=2 x model=2 (spatial)
    meshes each against one device on the same global batch; then the
    data=4 bf16 step time at ``per_device_bf16`` images per device."""
    import jax

    from dspnet_tpu.api import create_model
    from dspnet_tpu.parallel.mesh import make_mesh, shard_batch
    from dspnet_tpu.train.solver import MultiTaskSolver
    from dspnet_tpu.utils.benchmark import canonical_train_arrays, timed_train_steps

    devices = jax.devices()
    _check(len(devices) >= 4, f"--four needs 4 devices, JAX has {len(devices)}")
    H, W = hw
    host_batch = canonical_train_arrays(global_batch, H, W)
    perm = np.roll(np.arange(global_batch), global_batch // 2 + 1)
    with jax.default_matmul_precision("highest"):
        one = _one_step(host_batch, hw, global_batch, None, False, remat=remat)
        permuted = _one_step({k: v[perm] for k, v in host_batch.items()}, hw,
                             global_batch, None, False, remat=remat)
        log(f"[four] f32 b{global_batch} {H}x{W} one GPU, batch rows permuted: "
            f"loss {permuted[0]!r} vs {one[0]!r}")
        for name, n_data, n_model in (("data=4", 4, 1),
                                      ("data=2 x model=2 spatial", 2, 2)):
            mesh = make_mesh(n_data=n_data, n_model=n_model,
                             devices=devices[:4])
            got = _one_step(host_batch, hw, global_batch, mesh, n_model > 1,
                            remat=remat)
            log(f"[four] f32 b{global_batch} {H}x{W} {name} vs one GPU: "
                + _compare_step(name, one, permuted, got))

    B = 4 * per_device_bf16
    mesh = make_mesh(n_data=4, n_model=1, devices=devices[:4])
    bundle = create_model(NETWORK, hw, NUM_CLASSES, remat=remat)
    solver = MultiTaskSolver(bundle.model, bundle.anchors,
                             compute_dtype="bfloat16", batch_size=B, mesh=mesh)
    state = solver.init_state(jax.random.PRNGKey(0),
                              np.zeros((1, H, W, 3), np.float32))
    batch = shard_batch(mesh, canonical_train_arrays(B, H, W, pre_s2d=True))
    state, dt = timed_train_steps(solver, state, batch, n=n_timed, warmup=2)
    log(f"[four] bf16 data=4 step, {per_device_bf16} images per GPU "
        f"(global b{B}) {H}x{W}: {dt * 1e3:.3f} ms/step "
        f"({B / dt:.1f} img/s)")
    return {"four_bf16_ms": dt * 1e3}


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-GPU data-parallel phase")
    args = p.parse_args(argv)

    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found platform {platform!r}",
              file=sys.stderr)
        return 1
    device = phase_device()
    if args.four:
        phase_four()
    else:
        k = phase_kernels()
        i = phase_infer()
        t = phase_train()
        log(f"[shares] decode+NMS {k['nms_ms']:.3f} ms of the b128 inference "
            f"program's {i['infer_ms']:.3f} ms "
            f"({k['nms_ms'] / i['infer_ms']:.1%}); multibox_target "
            f"{k['target_ms']:.3f} ms of the b8 bf16 train step's "
            f"{t['train_ms']:.3f} ms ({k['target_ms'] / t['train_ms']:.1%})")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
