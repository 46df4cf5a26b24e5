"""Training CLI — parity with reference multi_train.py:20-100,188-536.

Example (synthetic smoke run):
  python -m dspnet_tpu.cli.multi_train --network resnet-18_multi \
      --data-shape 3,128,256 --batch-size 2 --synthetic 4 --end-epoch 1
"""

from __future__ import annotations

import argparse
import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np

from dspnet_tpu.api import create_model
from dspnet_tpu.cli.common import parse_data_shape, resolve_dataset, setup_logging
from dspnet_tpu.data.iterator import MultiTaskIterator
from dspnet_tpu.parallel.mesh import make_mesh
from dspnet_tpu.train.lr import lr_scheduler_from_epochs
from dspnet_tpu.train.solver import MultiTaskSolver, TrainingDiverged
from dspnet_tpu.utils.checkpoint import CheckpointManagerWrapper, checkpoint_prefix


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a DSPNet multitask network.")
    p.add_argument("--network", default="resnet-50_multi")
    p.add_argument("--data-shape", default="3,512,1024")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--class-names", default="",
                   help="comma list or file of one name per line; sets the "
                        "name->id table for XML-backed datasets (defaults: "
                        "8 -> Cityscapes det names, 20 -> VOC names)")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.0005)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=0.0005)
    p.add_argument("--lr-steps", default="80,160,240,320")
    p.add_argument("--lr-factor", type=float, default=0.5)
    p.add_argument("--begin-epoch", type=int, default=0)
    p.add_argument("--end-epoch", type=int, default=2000)
    p.add_argument("--resume", type=int, default=-1,
                   help="resume from epoch N (0 = latest checkpoint, -1 off)")
    p.add_argument("--freeze", default="", help="regex of params to freeze")
    p.add_argument("--model-dir", default="model")
    p.add_argument("--dataset-root", default="")
    p.add_argument("--synthetic", type=int, default=0, help="use N synthetic samples")
    p.add_argument("--synthetic-val", type=int, default=0,
                   help="synthetic validation-set size (0 = same as --synthetic); "
                        "lets epoch-scale runs keep per-epoch eval cheap")
    p.add_argument("--synthetic-dir", default="/tmp/dspnet_synth")
    p.add_argument("--num-devices", type=int, default=0, help="0 = all")
    p.add_argument("--coordinator", default="",
                   help="multi-process DP, one process per GPU of one host: "
                        "coordinator host:port (jax.distributed). All "
                        "processes run this CLI with the same flags plus "
                        "their own --process-id, which is also the GPU the "
                        "process opens; --batch-size is the GLOBAL batch")
    p.add_argument("--num-processes", type=int, default=1,
                   help="with --coordinator: total process count")
    p.add_argument("--process-id", type=int, default=0,
                   help="with --coordinator: this process's rank")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="devices on the 'model' mesh axis (spatial image-width "
                        "partitioning of activations); data axis gets the rest")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--monitor", type=int, default=0,
                   help="log param stats every N batches (reference "
                        "mx.mon.Monitor, multi_train.py:76-79,379); fetches "
                        "the full state to host - debugging only")
    p.add_argument("--pattern", default=".*",
                   help="with --monitor: regex of param paths to log")
    p.add_argument("--metrics-jsonl", default="",
                   help="append per-epoch train/val metrics as JSON lines "
                        "({epoch, split, time, ...metrics}) — structured "
                        "training curves without log parsing")
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="save every N epochs (reference: every epoch); the "
                        "final epoch is always saved")
    p.add_argument("--seg-normalize", default="null", choices=["null", "valid"])
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="model compute precision (f32 master weights either way)")
    p.add_argument("--loader", default="python",
                   choices=["python", "native", "device", "det"],
                   help="input pipeline: pure python, the native C++ loader, "
                        "on-device augmentation (host decodes raw uint8 only), "
                        "or the plain-SSD DetIterator (IoU-constrained random "
                        "crop/pad/mirror, VOC-style det-only training — "
                        "reference dataset/iterator.py DetIter)")
    p.add_argument("--loader-threads", type=int, default=8)
    p.add_argument("--predownscale", action="store_true",
                   help="with --loader device: host-resize raws to the train "
                        "resolution before H2D (fewer bytes on the wire; "
                        "allows mixed raw resolutions)")
    p.add_argument("--input-s2d", default="auto", choices=["auto", "on", "off"],
                   help="deliver images as their 2x2 space-to-depth transform "
                        "([B,H/2,W/2,12]) so the resnet stem's input relayout "
                        "never runs on device (free in the host loaders; "
                        "models/layers.space_to_depth). auto = on for resnet "
                        "multitask/seg with even dims on the python/native/"
                        "device loaders")
    p.add_argument("--native-u8", action="store_true",
                   help="with --loader native: transfer the warped batch as "
                        "uint8 and mean-sub on device (4x less H2D, "
                        "bit-identical images)")
    p.add_argument("--seg-fast", action="store_true",
                   help="seg score conv at native stream resolutions "
                        "(FCN-style score-then-upsample) — faster, different "
                        "numerics; use the same flag at eval/demo time")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="accumulate gradients over N batches before each "
                        "optimizer update (effective batch = batch-size*N at "
                        "one batch's activation memory); chunks span epoch "
                        "boundaries and the pending accumulator is not "
                        "checkpointed, so a crash+resume drops at most one "
                        "partial chunk (<N microbatches) of gradient")
    p.add_argument("--remat", action="store_true",
                   help="per-unit rematerialization (jax.checkpoint) — trades "
                        "FLOPs for device memory")
    args = p.parse_args(argv)
    args.data_shape = parse_data_shape(args.data_shape)
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.coordinator:
        # must precede every other JAX call (backend not yet initialized);
        # reference analog: the KVStore ctx list, train_multitask.py:235-246
        from dspnet_tpu.parallel.mesh import distributed_init

        distributed_init(args.coordinator, args.num_processes, args.process_id,
                         local_device_id=args.process_id)
    log = setup_logging()
    H, W = args.data_shape
    bundle = create_model(args.network, (H, W), args.num_classes, remat=args.remat,
                          seg_fast=args.seg_fast)
    log.info("network=%s task=%s anchors=%d data=%dx%d",
             bundle.name, bundle.task, bundle.num_anchors, H, W)

    train_index = resolve_dataset(args, "train")
    # label-space invariant: every GT class id must fit the head being
    # trained — a dataset indexed with the wrong name table fails HERE, not
    # as a silently-scrambled mAP hundreds of epochs later
    max_cid = max((int(s.label[:, 0].max()) for s in train_index.samples
                   if s.label.size), default=-1)
    assert max_cid < args.num_classes, (
        f"dataset labels carry class id {max_cid} but --num-classes is "
        f"{args.num_classes}; pass --class-names matching the annotation "
        f"names (or fix --num-classes)")
    # multi-host: each host reads its rank::world slice of the global epoch
    # and loads 1/world of the global batch (mesh.shard_batch assembles)
    shard = (jax.process_index(), jax.process_count())
    assert args.batch_size % shard[1] == 0, \
        "--batch-size is global and must be a multiple of the process count"
    local_batch = args.batch_size // shard[1]
    if shard != (0, 1):
        log.info("input shard %d/%d, local batch %d", shard[0], shard[1],
                 local_batch)
    s2d_on = (args.input_s2d == "on" or (
        args.input_s2d == "auto"
        and bundle.task in ("multi", "seg")
        and bundle.cfg.network == "resnet"
        and H % 2 == 0 and W % 2 == 0
        and args.loader in ("python", "native", "device")))
    if s2d_on:
        log.info("input-s2d: images delivered as [B,%d,%d,12] space-to-depth",
                 H // 2, W // 2)
    if args.loader == "native":
        from dspnet_tpu.data.native_loader import NativeMultiTaskIterator, native_available

        assert native_available(), "the native loader does not build here (make -C native)"
        train_iter = NativeMultiTaskIterator(
            train_index, local_batch, (H, W), enable_aug=True,
            num_threads=args.loader_threads, shard=shard,
            device_normalize=args.native_u8, s2d=s2d_on,
        )
        log.info("using native C++ loader (%d threads%s)", args.loader_threads,
                 ", uint8 H2D" if args.native_u8 else "")
    elif args.loader == "device":
        from dspnet_tpu.data.device_pipeline import DeviceAugIterator

        train_iter = DeviceAugIterator(
            train_index, local_batch, (H, W), enable_aug=True, shard=shard,
            num_threads=args.loader_threads, predownscale=args.predownscale,
            s2d=s2d_on,
        )
        log.info("using on-device augmentation pipeline%s",
                 " (host predownscale)" if args.predownscale else "")
    elif args.loader == "det":
        from dspnet_tpu.data.det_iterator import DetIterator

        assert bundle.task in ("ssd", "det"), \
            "--loader det is the det-only SSD pipeline (no seg labels); " \
            f"network task is '{bundle.task}'"
        assert shard == (0, 1), "--loader det does not shard across processes"
        train_iter = DetIterator(train_index, local_batch, (H, W),
                                 is_train=True)
        log.info("using plain-SSD DetIterator (crop/pad/mirror augmentation)")
    else:
        train_iter = MultiTaskIterator(train_index, local_batch, (H, W),
                                       enable_aug=True, shard=shard,
                                       s2d=s2d_on)

    devices = jax.devices()
    n_dev = args.num_devices or len(devices)
    n_model = args.model_parallel
    assert n_dev % n_model == 0, "--model-parallel must divide the device count"
    n_data = n_dev // n_model
    spatial = n_model > 1
    mesh = (make_mesh(n_data=n_data, n_model=n_model, devices=devices)
            if n_dev > 1 else None)
    if mesh is not None:
        assert args.batch_size % n_data == 0, "batch size must divide the data axis"
        log.info("mesh: data=%d x model=%d%s", n_data, n_model,
                 " (spatial width partitioning)" if spatial else "")

    base_lr, schedule = lr_scheduler_from_epochs(
        args.lr, args.lr_steps, args.lr_factor, len(train_index),
        args.batch_size * args.grad_accum,  # optimizer steps per epoch
        args.begin_epoch,
    )
    solver = MultiTaskSolver(
        bundle.model,
        bundle.anchors if bundle.anchors is not None else np.zeros((1, 4), np.float32),
        learning_rate=schedule,
        momentum=args.momentum,
        weight_decay=args.wd,
        batch_size=args.batch_size,
        mesh=mesh,
        freeze_pattern=args.freeze or None,
        seg_normalize=args.seg_normalize,
        compute_dtype=args.compute_dtype,
        spatial=spatial,
        grad_accum=args.grad_accum,
    )
    sample = jnp.zeros((args.batch_size, H, W, 3), jnp.float32)
    state = solver.init_state(jax.random.PRNGKey(233), sample)

    prefix = checkpoint_prefix(args.model_dir, args.network, H)
    ckpt = CheckpointManagerWrapper(prefix)
    begin = args.begin_epoch
    if args.resume > 0 or (args.resume == 0 and ckpt.latest_epoch() is not None):
        state, epoch = ckpt.restore(args.resume if args.resume > 0 else None, state)
        begin = epoch + 1
        log.info("resumed from epoch %d", epoch)
    elif args.resume == 0:
        # --resume 0 on an empty model dir starts fresh — lets an
        # auto-restarting driver (scripts/run_resumable.sh) pass the same
        # flags for the first run and every retry
        log.info("no checkpoint under %s yet; starting fresh", prefix)

    last_epoch = args.end_epoch - begin - 1

    def epoch_cb(epoch, st):
        # reference saves every epoch (mx.callback.do_checkpoint period=1,
        # multi_train.py:370); --checkpoint-every N amortizes the save cost
        # (a full f32 state D2H+write can dwarf small-epoch compute) while
        # always keeping the final epoch
        if (epoch + 1) % args.checkpoint_every == 0 or epoch == last_epoch:
            # intermediate saves are async (on-device snapshot now, D2H +
            # write on a background thread overlapping the next epoch); the
            # final save blocks so the run exits with the write committed
            ckpt.save(begin + epoch, st, block=epoch == last_epoch)
            log.info("checkpoint save %s: %s step %d",
                     "committed" if epoch == last_epoch else "started",
                     prefix, begin + epoch)

    eval_iter = None
    if args.eval_every > 0 and shard[0] == 0:
        # reference evaluates every epoch (multi_solver.py:355); in
        # multi-process runs process 0 evaluates the FULL val set on its
        # local device (solver.fit host-copies the replicated weights),
        # other ranks leave eval_iter None and rejoin at the next epoch's
        # first collective
        try:
            val_index = resolve_dataset(args, "val")
            eval_iter = MultiTaskIterator(
                val_index, local_batch, (H, W), enable_aug=False,
                shuffle=False, pad_last=True,
            )
        except (FileNotFoundError, AssertionError):
            log.info("no validation split found; skipping per-epoch eval")

    metrics_sink = None
    if args.metrics_jsonl and jax.process_index() == 0:
        import json
        import time as _time

        def metrics_sink(ep, split, metrics):
            with open(args.metrics_jsonl, "a") as f:
                f.write(json.dumps(
                    {"epoch": ep, "split": split, "time": _time.time(),
                     **metrics}) + "\n")

    batch_cb = None
    if args.monitor > 0:
        from dspnet_tpu.utils.profiler import StatMonitor

        mon = StatMonitor(interval=args.monitor, pattern=args.pattern, logger=log)
        batch_cb = lambda st, n: mon.tic_toc(st.params)  # noqa: E731

    try:
        state = solver.fit(
            state,
            train_iter,
            num_epochs=args.end_epoch - begin,
            eval_iter=eval_iter,
            eval_every=args.eval_every,
            data_shape=(H, W),
            log_fn=log.info,
            epoch_end_callback=epoch_cb,
            log_every=args.log_every,
            batch_end_callback=batch_cb,
            epoch_offset=begin,
            metrics_sink=metrics_sink,
        )
    except TrainingDiverged as e:
        # exit 3 = deterministic failure: run_resumable.sh must NOT retry
        # (a resume replays the same seeded epoch and diverges again)
        log.error(str(e))
        ckpt.close()
        sys.exit(3)
    ckpt.close()
    return state


if __name__ == "__main__":
    main()
