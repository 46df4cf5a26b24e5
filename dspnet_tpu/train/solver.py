"""MultiTaskSolver — the jitted training/eval step and loop.

Redesign of the reference's hand-rolled solver (multi_solver.py:182-521).
The reference re-binds a fresh executor every iteration
(multi_solver.py:250-251, a known perf sink) and updates params one array at
a time on the Python side; here the whole step — forward, target assignment
(on device), losses, backward, SGD update, BN stat update — is ONE jitted
XLA program, compiled once, optionally partitioned over a device mesh for
data parallelism (params replicated, batch sharded; XLA inserts the
gradient all-reduce).
"""

from __future__ import annotations

import dataclasses
import re
from functools import partial
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from dspnet_tpu.ops import target as target_ops
from dspnet_tpu.train import losses as loss_mod
from dspnet_tpu.train.optim import mxnet_sgd


class TrainingDiverged(RuntimeError):
    """Raised by :meth:`MultiTaskSolver.fit` when a synced loss is NaN/inf.

    With SGD+momentum a non-finite loss never recovers (the gradients, and
    on the next update the params, are already non-finite), so continuing —
    or letting ``run_resumable.sh`` restart into — a diverged run only burns
    device time and writes NaN checkpoints. The reference has no such guard
    (its loop logs NaN metrics forever, multi_solver.py:341-353). Detection
    piggybacks on the metric host-syncs the loop already performs, so the
    guard adds no device round-trips."""


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    params: Any
    batch_stats: Any
    opt_state: Any

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def freeze_mask(params, pattern: Optional[str]):
    """Boolean pytree: True where the param trains. ``pattern`` is a regex
    matched (anchored at the start, like the reference's
    ``re.compile(pattern).match(name)``, multi_train.py:327-331) against the
    '/'-joined param path."""
    if not pattern:
        return jax.tree.map(lambda _: True, params)
    rx = re.compile(pattern)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]

    def path_str(path):
        return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)

    leaves = [not rx.match(path_str(p)) for p, _ in flat]
    treedef = jax.tree_util.tree_structure(params)
    return jax.tree_util.tree_unflatten(treedef, leaves)


class MultiTaskSolver:
    """Owns model, anchors, optimizer, and the compiled train/eval steps.

    Args:
      model: a DSPNet/SSDNet module (dspnet_tpu.models.nn).
      anchors: (A, 4) numpy anchor table (trace-time constant).
      learning_rate: float or optax schedule.
      momentum / weight_decay / batch_size: MXNet SGD conventions
        (multi_solver.py:221-222).
      mesh: optional jax.sharding.Mesh for data parallelism.
      freeze_pattern: regex of param paths to exclude from updates.
      seg_grad_scale / seg_normalize: see train.losses.
    """

    def __init__(
        self,
        model,
        anchors: np.ndarray,
        learning_rate=1e-3,
        momentum: float = 0.9,
        weight_decay: float = 5e-4,
        batch_size: int = 1,
        mesh=None,
        freeze_pattern: Optional[str] = None,
        seg_grad_scale: float = 4.0,
        seg_normalize: str = "null",
        overlap_threshold: float = 0.5,
        negative_mining_ratio: float = 3.0,
        negative_mining_thresh: float = 0.5,
        compute_dtype: str = "float32",
        spatial: bool = False,
        grad_accum: int = 1,
    ):
        self.model = model
        # numpy, not jnp: a trace-time constant embedded in the program
        self.anchors = np.asarray(anchors, np.float32)
        self.mesh = mesh
        self.spatial = spatial  # shard image width over the 'model' mesh axis
        self.freeze_pattern = freeze_pattern
        self.seg_grad_scale = seg_grad_scale
        self.seg_normalize = seg_normalize
        self.overlap_threshold = overlap_threshold
        self.negative_mining_ratio = negative_mining_ratio
        self.negative_mining_thresh = negative_mining_thresh
        self.compute_dtype = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
        # gradient accumulation: k microbatches of `batch_size` are summed on
        # device before ONE optimizer update — an effective global batch of
        # batch_size*k at the HBM footprint of one microbatch (losses are
        # per-microbatch normalized, like any BN-style accumulation). The
        # MXNet rescale_grad convention extends to the effective batch.
        self.grad_accum = int(grad_accum)
        assert self.grad_accum >= 1
        self.tx = mxnet_sgd(
            learning_rate, momentum, weight_decay,
            rescale_grad=1.0 / (batch_size * self.grad_accum),
        )
        self._train_step = None
        self._eval_step = None
        self._micro_step = None
        self._apply_step = None
        self._zero_grads = None

    # ---------------------------------------------------------------- init

    def init_state(self, rng, sample_images) -> TrainState:
        # jit the init: un-jitted, every op of the init dispatches eagerly
        variables = jax.jit(partial(self.model.init, train=True))(rng, sample_images)
        params = variables["params"]
        batch_stats = variables.get("batch_stats", {})
        # jitted: un-jitted tx.init dispatches one zeros_like per leaf
        opt_state = jax.jit(self.tx.init)(params)
        state = TrainState(
            step=jnp.zeros([], jnp.int32),
            params=params,
            batch_stats=batch_stats,
            opt_state=opt_state,
        )
        if self.mesh is not None:
            rep = NamedSharding(self.mesh, P())
            state = jax.device_put(state, rep)
        return state

    # ---------------------------------------------------------- step builder

    def _loss_fn(self, params, batch_stats, batch, train: bool):
        images = batch["images"]
        if self.compute_dtype != jnp.float32:
            # mixed precision: f32 master weights, bf16 compute;
            # losses/targets stay f32 (cast back below)
            params = jax.tree.map(
                lambda x: x.astype(self.compute_dtype)
                if jnp.issubdtype(x.dtype, jnp.floating) else x,
                params,
            )
            images = images.astype(self.compute_dtype)
        variables = {"params": params}
        if batch_stats:
            variables["batch_stats"] = batch_stats
        mutable = ["batch_stats"] if (train and batch_stats) else False
        ret = self.model.apply(variables, images, train=train, mutable=mutable)
        outputs, new_stats = (ret if mutable else (ret, {}))
        if mutable:
            new_stats = new_stats.get("batch_stats", {})
        outputs = jax.tree.map(lambda x: x.astype(jnp.float32), outputs)
        if mutable:
            new_stats = jax.tree.map(lambda x: x.astype(jnp.float32), new_stats)

        loc_t = loc_m = cls_t = None
        if "cls_logits" in outputs and "label_det" in batch:
            # target assignment consumes (B, C, A) logits like the reference op
            cls_preds_ca = jnp.swapaxes(outputs["cls_logits"], 1, 2)
            loc_t, loc_m, cls_t = target_ops.multibox_target(
                self.anchors,
                batch["label_det"],
                cls_preds_ca,
                overlap_threshold=self.overlap_threshold,
                negative_mining_ratio=self.negative_mining_ratio,
                negative_mining_thresh=self.negative_mining_thresh,
            )
            # classic 4-coordinate SSD heads drop the distance channel
            lc = outputs["loc_preds"].shape[-1]
            loc_t = jax.lax.stop_gradient(loc_t[..., :lc])
            loc_m = jax.lax.stop_gradient(loc_m[..., :lc])
            cls_t = jax.lax.stop_gradient(cls_t)

        total, metrics = loss_mod.multitask_loss(
            outputs,
            loc_t,
            loc_m,
            cls_t,
            batch.get("seg_label"),
            seg_grad_scale=self.seg_grad_scale,
            seg_normalize=self.seg_normalize,
        )
        return total, (metrics, new_stats)

    def _apply_updates(self, state: TrainState, grads, new_stats):
        """tx update + freeze masking + param apply (shared by the fused
        step and the gradient-accumulation apply)."""
        updates, new_opt = self.tx.update(grads, state.opt_state, state.params)
        if self.freeze_pattern:
            mask = freeze_mask(state.params, self.freeze_pattern)
            updates = jax.tree.map(
                lambda u, m: u if m else jnp.zeros_like(u), updates, mask
            )
            # also keep frozen params' momentum at zero — otherwise it
            # silently integrates grad + weight decay and applies a
            # spurious jump if the pattern is later removed on resume
            # (reference fixed_param_names never enters the updater)
            new_opt = new_opt._replace(momentum=jax.tree.map(
                lambda mo, m: mo if m else jnp.zeros_like(mo),
                new_opt.momentum, mask))
        new_params = jax.tree.map(lambda p, u: p + u, state.params, updates)
        return state.replace(
            step=state.step + 1,
            params=new_params,
            batch_stats=new_stats if new_stats else state.batch_stats,
            opt_state=new_opt,
        )

    def _jit_with_batch(self, fn, n_carry: int):
        """jit ``fn(*carry, batch)``: carry args replicated and donated,
        batch sharded on axis 0 over the mesh's 'data' axis (spatial mode
        additionally width-shards image-like leaves — the batch key set
        decides the sharding tree, so memoize one jitted wrapper per key
        set; a fresh jax.jit per call would retrace the whole train graph
        every step). Outputs are replicated."""
        donate = tuple(range(n_carry))
        if self.mesh is None:
            return jax.jit(fn, donate_argnums=donate)
        rep = NamedSharding(self.mesh, P())
        if not self.spatial:
            # pytree-prefix shardings: carry replicated, batch on axis 0
            dat = NamedSharding(self.mesh, P("data"))
            return jax.jit(fn, in_shardings=(*(rep,) * n_carry, dat),
                           out_shardings=rep, donate_argnums=donate)
        from dspnet_tpu.parallel.mesh import batch_shardings_for

        cache: Dict[frozenset, Any] = {}

        def _get(batch):
            key = frozenset(batch)
            if key not in cache:
                cache[key] = jax.jit(
                    fn,
                    in_shardings=(*(rep,) * n_carry, batch_shardings_for(
                        self.mesh, batch, spatial=True)),
                    out_shardings=rep,
                    donate_argnums=donate,
                )
            return cache[key]

        def jitted(*args):
            return _get(args[-1])(*args)

        # compile-only entry (jax.jit exposes .lower natively in the
        # non-spatial branches; mirror it so full-shape sharding can be
        # compile-checked without executing, tests/test_parallel.py)
        jitted.lower = lambda *args: _get(args[-1]).lower(*args)
        return jitted

    def _build_train_step(self):
        def step(state: TrainState, batch: Dict):
            grad_fn = jax.value_and_grad(
                lambda p: self._loss_fn(p, state.batch_stats, batch, train=True),
                has_aux=True,
            )
            (_, (metrics, new_stats)), grads = grad_fn(state.params)
            new_state = self._apply_updates(state, grads, new_stats)
            return new_state, metrics

        return self._jit_with_batch(step, n_carry=1)

    def _build_eval_step(self):
        def step(state: TrainState, batch: Dict):
            _, (metrics, _) = self._loss_fn(state.params, state.batch_stats, batch, train=False)
            return metrics

        return jax.jit(step)

    def _build_accum_steps(self):
        """Gradient-accumulation programs: a microbatch step adds grads into
        a device accumulator (BN stats update per microbatch, standard
        accumulation semantics), then one apply step consumes the
        accumulator for a single optimizer update. Effective global batch =
        batch_size * grad_accum at one microbatch's activation footprint."""

        def micro(state: TrainState, acc, batch: Dict):
            grad_fn = jax.value_and_grad(
                lambda p: self._loss_fn(p, state.batch_stats, batch, train=True),
                has_aux=True,
            )
            (_, (metrics, new_stats)), grads = grad_fn(state.params)
            acc = jax.tree.map(jnp.add, acc, grads)
            if new_stats:
                state = state.replace(batch_stats=new_stats)
            return state, acc, metrics

        def apply(state: TrainState, acc):
            return self._apply_updates(state, acc, None)

        def zeros(params):
            return jax.tree.map(jnp.zeros_like, params)

        micro_j = self._jit_with_batch(micro, n_carry=2)
        if self.mesh is not None:
            rep = NamedSharding(self.mesh, P())
            apply_j = jax.jit(apply, in_shardings=(rep, rep),
                              out_shardings=rep, donate_argnums=(0, 1))
            zeros_j = jax.jit(zeros, out_shardings=rep)
        else:
            apply_j = jax.jit(apply, donate_argnums=(0, 1))
            zeros_j = jax.jit(zeros)
        return micro_j, apply_j, zeros_j

    # ---------------------------------------------------------------- API

    def train_step(self, state: TrainState, batch: Dict):
        assert self.grad_accum == 1, \
            "grad_accum > 1 trains through fit() (microbatch accumulation)"
        if self._train_step is None:
            self._train_step = self._build_train_step()
        return self._train_step(state, batch)

    def lower_train_step(self, state: TrainState, batch: Dict):
        """The train step lowered for ``state`` and ``batch``, not run;
        ``.compile()`` on it gives the cost and memory analyses."""
        if self._train_step is None:
            self._train_step = self._build_train_step()
        return self._train_step.lower(state, batch)

    def eval_step(self, state: TrainState, batch: Dict):
        if self._eval_step is None:
            self._eval_step = self._build_eval_step()
        return self._eval_step(state, batch)

    def make_detector(self, state: TrainState, data_shape, **kwargs):
        """Detector over the current train state (weights hot-swappable via
        update_variables without recompiling)."""
        from dspnet_tpu.detect.detector import Detector

        variables = {"params": state.params}
        if state.batch_stats:
            variables["batch_stats"] = state.batch_stats
        return Detector(self.model, variables, self.anchors, data_shape, **kwargs)

    @staticmethod
    def detector_variables(state: TrainState):
        variables = {"params": state.params}
        if state.batch_stats:
            variables["batch_stats"] = state.batch_stats
        return variables

    @staticmethod
    def _check_finite(metrics: Dict[str, float], epoch: int, batch: int):
        """Abort on NaN/inf loss (see :class:`TrainingDiverged`). Runs only
        on already-host-synced floats — never forces a device sync itself."""
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            raise TrainingDiverged(
                f"non-finite training metrics {bad} at epoch {epoch} batch "
                f"{batch}: {metrics}. The run has diverged (params are "
                "already non-finite); lower --lr, or with the reference's "
                "unnormalized seg loss (--seg-normalize null, a per-pixel "
                "SUM calibrated to lr 5e-4) use --seg-normalize valid for "
                "larger learning rates.")

    def fit(
        self,
        state: TrainState,
        train_iter,
        num_epochs: int = 1,
        eval_iter=None,
        eval_every: int = 1,
        data_shape=None,
        log_fn=print,
        epoch_end_callback=None,
        log_every: int = 20,
        batch_end_callback=None,
        epoch_offset: int = 0,
        metrics_sink=None,
    ) -> TrainState:
        """Reference-style fit loop (multi_solver.py:182-353): per-batch train
        step, periodic metric logging, per-epoch checkpoint callback. Batches
        are prefetched to device on a background thread so the step never
        stalls on host->device transfer.

        ``epoch_offset`` shifts the epoch numbers in log lines (a resumed run
        reports absolute epochs, like the reference's begin_epoch-based loop,
        multi_solver.py:232); callbacks still receive the 0-based loop epoch.

        ``metrics_sink(absolute_epoch, split, metrics_dict)`` receives the
        per-epoch train means (split='train') and validation results
        (split='val') as plain floats — the structured counterpart of the
        log lines (the CLI's --metrics-jsonl writes them as JSON lines for
        training-curve tooling).

        Checkpoint semantics under ``grad_accum > 1``: chunks are counted in
        microbatches and carry ACROSS epoch boundaries, and the pending
        gradient accumulator is NOT part of the checkpointed state.  A
        checkpoint taken mid-chunk therefore excludes up to ``grad_accum - 1``
        summed microbatch gradients, and a crash+resume replays that epoch
        from a fresh chunk phase.  The final partial-chunk apply also lands
        AFTER the last epoch's checkpoint, so the returned state can differ
        from the last save by one tail update.  This is at most one optimizer
        step of drift, the same exposure as the reference's per-epoch
        checkpointing (multi_solver.py:347-348) losing in-flight batches.
        """
        from dspnet_tpu.data.prefetch import prefetch_to_device

        sharding = None
        if self.mesh is not None:
            from dspnet_tpu.parallel.mesh import shard_batch

            # shard_batch also assembles global arrays from per-process
            # local batches under multi-process DP (mesh.distributed_init)
            sharding = partial(shard_batch, self.mesh, spatial=self.spatial)

        accum = self.grad_accum
        if accum > 1 and self._micro_step is None:
            self._micro_step, self._apply_step, self._zero_grads = \
                self._build_accum_steps()
        # the accumulator carries ACROSS epoch boundaries (chunks are counted
        # in microbatches, not per-epoch) — resetting each epoch would make
        # every epoch whose batch count is not a multiple of grad_accum apply
        # an under-scaled tail update (rescale assumes k summed grads)
        acc = None
        micro_n = 0

        for epoch in range(num_epochs):
            ep = epoch + epoch_offset  # absolute epoch for log lines
            agg: Dict[str, Any] = {}
            counts: Dict[str, int] = {}  # seg keys appear only on seg batches
            n = 0
            for batch in prefetch_to_device(train_iter, size=2, sharding=sharding):
                if accum == 1:
                    state, metrics = self.train_step(state, batch)
                else:
                    if acc is None:
                        acc = self._zero_grads(state.params)
                    state, acc, metrics = self._micro_step(state, acc, batch)
                    micro_n += 1
                    if micro_n % accum == 0:
                        state = self._apply_step(state, acc)
                        acc = None
                n += 1
                # accumulate ON DEVICE — float() here would sync the host
                # every step and serialize dispatch with device compute
                for k, v in metrics.items():
                    agg[k] = agg.get(k, 0.0) + v
                    counts[k] = counts.get(k, 0) + 1
                if n % log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}  # sync point
                    log_fn(f"epoch {ep} batch {n}: " + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
                    self._check_finite(m, ep, n)
                if batch_end_callback is not None:
                    # reference batch_end_callback slot (multi_solver.py:
                    # 341-345) — e.g. StatMonitor (mx.mon.Monitor analog)
                    batch_end_callback(state, n)
            if n:
                means = {k: float(v) / counts[k] for k, v in agg.items()}
                log_fn(f"epoch {ep} done: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in means.items()))
                self._check_finite(means, ep, n)
                if metrics_sink is not None:
                    metrics_sink(ep, "train", means)
            if epoch_end_callback is not None:
                epoch_end_callback(epoch, state)
            # per-epoch validation pass (reference multi_solver.py:355-517).
            # Multi-process runs evaluate on process 0 only: the detector is
            # a process-local (non-collective) computation, so global-mesh
            # variables are host-copied first (DP/spatial sharding replicate
            # params, so every process holds full copies and np.asarray is a
            # local read); other processes skip straight to the next epoch
            # and wait at its first train-step collective.
            if eval_iter is not None and eval_every > 0 and (ep + 1) % eval_every == 0 \
                    and jax.process_index() == 0:
                from dspnet_tpu.evaluate.loop import evaluate_model

                if not hasattr(self, "_val_detector"):
                    assert data_shape is not None, "fit(eval_iter=...) needs data_shape"
                    self._val_detector = self.make_detector(state, data_shape)
                variables = self.detector_variables(state)
                if jax.process_count() > 1:
                    # re-home the replicated global-mesh weights as LOCAL
                    # single-device arrays: addressable_data(0) is the
                    # process-local shard already on device — zero-copy, no
                    # D2H (hand-fetching the pytree with np.asarray pays
                    # serial per-leaf round-trips AND re-uploads the full
                    # weight set on every predict)
                    variables = jax.tree_util.tree_map(
                        lambda x: x.addressable_data(0), variables)
                self._val_detector.update_variables(variables)
                results = evaluate_model(self._val_detector, eval_iter, log_fn=log_fn)
                log_fn(f"epoch {ep} validation: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in results.items()
                    if isinstance(v, float) and k in ("mAP", "mIoU", "accuracy", "derror")))
                if metrics_sink is not None:
                    metrics_sink(ep, "val", {
                        k: float(v) for k, v in results.items()
                        if isinstance(v, (int, float)) and np.isfinite(v)})
            # (MultiTaskIterator reshuffles + resamples aug params in its own
            # __iter__; no explicit reset here or epochs would double-shuffle)
        if acc is not None:
            # training ended mid-chunk: apply the partial sum (one final
            # smaller-than-nominal effective batch — unavoidable at the end)
            state = self._apply_step(state, acc)
        return state
