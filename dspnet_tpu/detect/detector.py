"""Multitask inference API.

Capability parity with the reference detector family
(detect/multitask_detector.py, det_detector.py, seg_detector.py,
detector.py): one class, task-driven. The reference re-binds an MXNet
executor per call (multitask_detector.py:224); here the full
preprocess->forward->decode->NMS->argmax path is ONE jitted program compiled
once and reused (also the bench path).

API mirrors the reference:
  * ``detect(images)``       — batched: per-image det rows with id >= 0 +
                               seg argmax map (multitask_detector.py:166-272)
  * ``im_detect_single``     — single image file/array
                               (multitask_detector.py:307-334)
  * ``visualize_detection``  — cv2 overlay with per-class colors and the
                               "NNm" distance text, nearest-first
                               (multitask_detector.py:336-399)
  * ``detect_and_visualize`` — image path(s) / video / webcam
                               (multitask_detector.py:401-458)
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dspnet_tpu.data.augment import MEAN_PIXELS
from dspnet_tpu.data.cs_labels import train_id_palette
from dspnet_tpu.ops.detection import multibox_detection
from dspnet_tpu.ops.nms import nms as cpu_nms


def start_d2h(res: dict) -> None:
    """Kick off async device->host copies for every result leaf, so the
    transfers overlap each other and later ``np.asarray`` calls find the
    bytes on the host. Advisory API, skipped on non-array leaves."""
    for v in res.values():
        start = getattr(v, "copy_to_host_async", None)
        if start is not None:
            start()


class Detector:
    def __init__(
        self,
        model,
        variables,
        anchors: np.ndarray,
        data_shape: Tuple[int, int],
        mean_pixels=MEAN_PIXELS,
        classes: Optional[Sequence[str]] = None,
        nms_thresh: float = 0.5,
        force_suppress: bool = False,
        nms_topk: int = 400,
        score_threshold: float = 0.01,
        mesh=None,
        seg_probabilities: bool = False,
    ):
        """``mesh``: a `jax.sharding.Mesh` with a 'data' axis — serving
        batches shard over it (params replicated), scaling throughput
        with the device count. Batches whose size doesn't divide
        the data axis are padded on device and sliced back (so batch-1
        serving works on any mesh); single-chip behavior is unchanged when
        None. ``seg_probabilities``: also return the full (B, H/4, W/4, C)
        softmax as ``seg_prob`` — needed only by the Cityscapes result-PNG
        writer, and ~20x more device->host bytes than the argmax map, so
        off by default."""
        self.model = model
        self.variables = variables
        self.mesh = mesh
        self.seg_probabilities = seg_probabilities
        # trace-time numpy constant: a device-resident jax.Array closed over
        # the jitted fn would be fetched to the host during lowering
        self.anchors = np.asarray(anchors, np.float32)
        self.data_shape = tuple(data_shape)
        self.mean_pixels = mean_pixels
        self.classes = list(classes) if classes else None
        self.nms_thresh = nms_thresh
        self.force_suppress = force_suppress
        self.nms_topk = nms_topk
        self.score_threshold = score_threshold
        self.palette = train_id_palette()
        # variables are an ARGUMENT of the jitted fn (not a closure constant)
        # so updating weights (e.g. per-epoch validation) reuses the compile
        if mesh is not None:
            from dspnet_tpu.parallel.mesh import batch_sharding, replicated

            rep, dat = replicated(mesh), batch_sharding(mesh)
            jit_kw = dict(in_shardings=(rep, dat), out_shardings=dat)
            self._predict = jax.jit(self._forward, **jit_kw)
            self._predict_raw = jax.jit(self._forward_raw, **jit_kw)
        else:
            self._predict = jax.jit(self._forward)
            self._predict_raw = jax.jit(self._forward_raw)

    def update_variables(self, variables):
        self.variables = variables

    # ------------------------------------------------------------- core

    def _forward(self, variables, images):
        out = self.model.apply(variables, images, train=False)
        results = {}
        if "cls_logits" in out:
            cls_prob = jax.nn.softmax(out["cls_logits"], axis=-1)  # (B, A, C)
            det = multibox_detection(
                jnp.swapaxes(cls_prob, 1, 2),
                out["loc_preds"],
                self.anchors,
                threshold=self.score_threshold,
                nms_threshold=self.nms_thresh,
                force_suppress=self.force_suppress,
                nms_topk=self.nms_topk,
            )
            results["det"] = det
        if "seg_logits" in out:
            # uint8 trainId map: 4x fewer device->host bytes than the int32
            # argmax (the seg D2H is per-batch on every eval/serving path;
            # trainIds are < 256 by the cs_labels contract) — VERDICT r4 #6
            results["seg"] = jnp.argmax(out["seg_logits"], axis=-1).astype(
                jnp.uint8)
            if self.seg_probabilities:
                results["seg_prob"] = jax.nn.softmax(out["seg_logits"], axis=-1)
        return results

    def _forward_raw(self, variables, raw_bgr):
        """uint8 BGR in, normalize on device — the serving-default entry.

        Shipping uint8 instead of preprocessed f32 cuts host->device traffic
        4x."""
        images = raw_bgr[..., ::-1].astype(jnp.float32) - jnp.asarray(
            self.mean_pixels, jnp.float32)
        return self._forward(variables, images)

    def transform(self, img_bgr: np.ndarray) -> np.ndarray:
        """Resize + mean-sub RGB float (reference multitask_detector.py:65-76)."""
        import cv2
        h, w = self.data_shape
        img = cv2.resize(img_bgr, (w, h), interpolation=cv2.INTER_LINEAR)
        return img[:, :, ::-1].astype(np.float32) - np.asarray(self.mean_pixels, np.float32)

    def _run_padded(self, fn, batch):
        """Pad the batch to a multiple of the mesh's data axis (repeat of the
        last row) and slice results back — lets any batch size, including 1,
        run on a multi-chip mesh. ``batch`` may be a device array (the
        DeviceAugIterator / --native-u8 paths); jnp ops keep it on device —
        no D2H round-trip per batch."""
        batch = jnp.asarray(batch)  # no-op for device arrays
        if self.mesh is None:
            return fn(self.variables, batch)
        n = self.mesh.shape["data"]
        B = batch.shape[0]
        pad = (-B) % n
        if pad:
            batch = jnp.concatenate(
                [batch, jnp.repeat(batch[-1:], pad, axis=0)])
        res = fn(self.variables, batch)
        if pad:
            res = {k: v[:B] for k, v in res.items()}
        return res

    def predict(self, images):
        """images (B, H, W, 3) preprocessed float (numpy or device array)
        -> jitted forward results."""
        return self._run_padded(self._predict, images)

    def predict_raw(self, raw_bgr):
        """raw (B, H, W, 3) uint8 BGR at data_shape -> jitted forward results."""
        return self._run_padded(self._predict_raw, raw_bgr)

    @staticmethod
    def _filter_rows(rows: np.ndarray, det_threshold: float) -> np.ndarray:
        """Keep rows with id >= 0 (non-suppressed sentinel) and score >=
        threshold (reference multitask_detector.py:268-271)."""
        return rows[(rows[:, 0] >= 0) & (rows[:, 1] >= det_threshold)]

    def detect(self, images: np.ndarray, det_threshold: float = 0.0):
        """Returns (list of per-image (n, 7) arrays with id >= 0 and
        score >= det_threshold, seg maps (B, H/4, W/4) or None)."""
        res = self.predict(images)
        start_d2h(res)  # overlap det/seg transfers (one blocking RTT each)
        dets_out: List[np.ndarray] = []
        if "det" in res:
            det = np.asarray(res["det"])
            for b in range(det.shape[0]):
                dets_out.append(self._filter_rows(det[b], det_threshold))
        seg = np.asarray(res["seg"]) if "seg" in res else None
        return dets_out, seg

    def im_detect_single(self, image, det_threshold: float = 0.0):
        """image: path or BGR array. Returns ((n, 7) dets, seg map or None)."""
        import cv2
        if isinstance(image, str):
            image = cv2.imread(image, cv2.IMREAD_COLOR)
            assert image is not None
        h, w = self.data_shape
        raw = cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)
        res = self.predict_raw(raw[None])  # uint8 H2D + on-device normalize
        start_d2h(res)
        dets_out = np.zeros((0, 7), np.float32)
        if "det" in res:
            dets_out = self._filter_rows(np.asarray(res["det"])[0], det_threshold)
        seg = np.asarray(res["seg"])[0] if "seg" in res else None
        return dets_out, seg

    # ---------------------------------------------------------- visualize

    def visualize_detection(
        self,
        img_bgr: np.ndarray,
        dets: np.ndarray,
        seg: Optional[np.ndarray] = None,
        thresh: float = 0.6,
        seg_alpha: float = 0.5,
    ) -> np.ndarray:
        """Draw boxes (class color, 'NNm' distance text, nearest drawn last)
        + optional seg overlay. Returns BGR image."""
        import cv2
        img = img_bgr.copy()
        height, width = img.shape[:2]
        if seg is not None:
            seg_rgb = self.palette[np.clip(seg, 0, 255)]
            seg_bgr = cv2.resize(
                seg_rgb[:, :, ::-1], (width, height), interpolation=cv2.INTER_NEAREST
            )
            img = cv2.addWeighted(img, 1.0 - seg_alpha, seg_bgr, seg_alpha, 0)
        rng = random.Random(1)  # stable per-class colors like the reference
        # (:356) without reseeding the process-global random module
        colors = {}
        rows = [r for r in np.asarray(dets) if r[0] >= 0 and r[1] >= thresh]
        rows.sort(key=lambda r: -r[6])  # farthest first, nearest on top (:365)
        for r in rows:
            cid = int(r[0])
            if cid not in colors:
                colors[cid] = (rng.randint(0, 255), rng.randint(0, 255), rng.randint(0, 255))
            xmin = int(r[2] * width)
            ymin = int(r[3] * height)
            xmax = int(r[4] * width)
            ymax = int(r[5] * height)
            cv2.rectangle(img, (xmin, ymin), (xmax, ymax), colors[cid], 2)
            cname = self.classes[cid] if self.classes else str(cid)
            dist_m = r[6] * 255.0
            cv2.putText(
                img,
                f"{cname} {dist_m:.0f}m",
                (xmin, max(12, ymin - 4)),
                cv2.FONT_HERSHEY_SIMPLEX,
                0.5,
                colors[cid],
                1,
            )
        return img

    def detect_and_visualize(
        self,
        inputs,
        out_dir: str = ".",
        thresh: float = 0.6,
        video_nms: float = 0.95,
        show: bool = False,
    ) -> List[str]:
        """Image path(s) or a video path ('.mp4'/'.avi'/int webcam id).

        Video frames get the reference's extra host-side NMS pass at 0.95
        (multitask_detector.py:450). Returns written file paths.
        """
        import cv2
        os.makedirs(out_dir, exist_ok=True)
        written = []
        if isinstance(inputs, (str, int)) and (
            isinstance(inputs, int) or inputs.endswith((".mp4", ".avi"))
        ):
            from dspnet_tpu.detect.pipeline import ServingPipeline

            cap = cv2.VideoCapture(inputs)
            writer = None
            h, w = self.data_shape
            # pipelined dispatch: keep 2 frames in flight so each frame's
            # H2D + forward + D2H overlaps its neighbors'; results stay
            # identical and in order, delayed by the window depth
            pipe = ServingPipeline(self, depth=2, raw=True)

            def handle(frame, res):
                nonlocal writer
                dets = (self._filter_rows(np.asarray(res["det"])[0], 0.0)
                        if "det" in res else np.zeros((0, 7), np.float32))
                seg = np.asarray(res["seg"])[0] if "seg" in res else None
                if dets.shape[0] > 1:
                    scaled = np.hstack(
                        [dets[:, 2:6] * np.array([w, h, w, h]), dets[:, 1:2]]
                    ).astype(np.float32)
                    keep = cpu_nms(scaled, video_nms)
                    dets = dets[keep]
                vis = self.visualize_detection(frame, dets, seg, thresh)
                if writer is None:
                    path = os.path.join(out_dir, "detection_out.mp4")
                    writer = cv2.VideoWriter(
                        path, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                        (vis.shape[1], vis.shape[0]),
                    )
                    written.append(path)
                writer.write(vis)

            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                raw = cv2.resize(frame, (w, h), interpolation=cv2.INTER_LINEAR)
                done = pipe.submit(raw, tag=frame)
                if done is not None:
                    handle(*done)
            for frame, res in pipe.drain():
                handle(frame, res)
            if writer is not None:
                writer.release()
            cap.release()
            return written
        paths = [inputs] if isinstance(inputs, str) else list(inputs)
        for p in paths:
            img = cv2.imread(p, cv2.IMREAD_COLOR)
            assert img is not None, p
            dets, seg = self.im_detect_single(img)
            vis = self.visualize_detection(img, dets, seg, thresh)
            out = os.path.join(out_dir, os.path.splitext(os.path.basename(p))[0] + "_out.jpg")
            cv2.imwrite(out, vis)
            written.append(out)
        return written
