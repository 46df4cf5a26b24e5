"""Checkpoint save/restore (Orbax) with the reference naming contract.

The reference writes `{prefix}-symbol.json` + `{prefix}-{epoch:04d}.params`
per epoch via mx.callback.do_checkpoint (multi_train.py:370,
multi_solver.py:347-348), with prefix `{dir}/multitask_{net}_{height}`
(multi_train.py:287). Here each epoch is an Orbax step directory under
`{prefix}` carrying params, batch_stats, and optimizer state, so
``--resume N`` works the same way (multi_train.py:336-341).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional


def _ocp():
    """Orbax, imported on first use so the rest of the package loads
    without it."""
    import orbax.checkpoint as ocp

    return ocp


def checkpoint_prefix(model_dir: str, net_name: str, data_height: int) -> str:
    """`{dir}/multitask_{net}_{height}` (multi_train.py:287)."""
    return os.path.join(os.path.abspath(model_dir), f"multitask_{net_name}_{data_height}")


class CheckpointManagerWrapper:
    def __init__(self, prefix: str, max_to_keep: Optional[int] = None):
        # orbax/tensorstore reject relative paths at commit time (from a
        # background thread, leaving a stale tmp dir) — normalize here
        prefix = os.path.abspath(prefix)
        self.prefix = prefix
        os.makedirs(prefix, exist_ok=True)
        ocp = _ocp()
        options = ocp.CheckpointManagerOptions(max_to_keep=max_to_keep, create=True)
        # pre-register the item handler: a restore-only manager otherwise has
        # no handler for the 'default' item, so item_metadata() silently
        # returns an empty tree (breaking the template-free restore_raw path)
        self.mgr = ocp.CheckpointManager(
            prefix, options=options,
            item_handlers=ocp.StandardCheckpointHandler())
        self._save_thread: Optional[threading.Thread] = None
        self._save_exc: Optional[BaseException] = None
        self._snap_fn = None

    @staticmethod
    def _payload(state: Any):
        return {
            "params": state.params,
            "batch_stats": state.batch_stats,
            "opt_state": state.opt_state,
            "step": state.step,
        }

    def _join(self):
        """Wait for any in-flight async save; re-raise its failure (a
        silently dropped checkpoint would defeat crash recovery)."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        if self._save_exc is not None:
            exc, self._save_exc = self._save_exc, None
            raise RuntimeError("async checkpoint save failed") from exc

    def _snapshot(self, payload):
        """Device-side copy of every jax.Array leaf as ONE jitted program.

        Two constraints shape this: (a) the training loop DONATES the state
        buffers on the next step, so a background save reading the original
        arrays would race a donation — the snapshot breaks the aliasing on
        device before training resumes; (b) per-leaf ``jnp.copy`` dispatches
        would be hundreds of tiny programs, so all leaves copy in one jit
        call. Non-array leaves (python ints
        in optimizer state) pass through untouched to keep restore types.
        """
        import jax

        leaves, treedef = jax.tree_util.tree_flatten(payload)
        idx = [i for i, x in enumerate(leaves) if isinstance(x, jax.Array)]
        if idx:
            if self._snap_fn is None:
                import jax.numpy as jnp

                self._snap_fn = jax.jit(
                    lambda xs: tuple(jnp.copy(x) for x in xs))
            copies = self._snap_fn(tuple(leaves[i] for i in idx))
            for i, c in zip(idx, copies):
                leaves[i] = c
        return jax.tree_util.tree_unflatten(treedef, leaves)

    def save(self, epoch: int, state: Any, block: bool = True):
        """Write a checkpoint. ``block=False`` returns after an on-device
        snapshot and runs the device->host fetch + disk write on a
        background thread, so the save overlaps the next epoch instead of
        stalling it (the reference's
        per-epoch do_checkpoint is fully synchronous, multi_train.py:370).
        The next save/restore/close joins the in-flight write first."""
        self._join()
        ocp = _ocp()
        payload = self._payload(state)
        if not block:
            payload = self._snapshot(payload)

            def run():
                try:
                    self.mgr.save(epoch, args=ocp.args.StandardSave(payload))
                    self.mgr.wait_until_finished()
                except BaseException as e:  # surfaced by the next _join
                    self._save_exc = e

            self._save_thread = threading.Thread(
                target=run, name=f"ckpt-save-{epoch}", daemon=True)
            self._save_thread.start()
            return
        self.mgr.save(epoch, args=ocp.args.StandardSave(payload))
        self.mgr.wait_until_finished()

    def restore(self, epoch: Optional[int], template_state: Any):
        self._join()
        if epoch is None:
            epoch = self.mgr.latest_step()
        assert epoch is not None, f"no checkpoints under {self.prefix}"
        payload = {
            "params": template_state.params,
            "batch_stats": template_state.batch_stats,
            "opt_state": template_state.opt_state,
            "step": template_state.step,
        }
        restored = self.mgr.restore(
            epoch, args=_ocp().args.StandardRestore(payload))
        return template_state.replace(
            params=restored["params"],
            batch_stats=restored["batch_stats"],
            opt_state=restored["opt_state"],
            step=restored["step"],
        ), epoch

    def restore_raw(self, epoch: Optional[int] = None):
        """Template-free restore: the stored tree as plain numpy dicts.

        Unlike :meth:`restore`, this never validates against a target state,
        so a checkpoint from a DIFFERENT architecture/optimizer can be read
        and partially merged (the transfer-init path)."""
        self._join()
        if epoch is None:
            epoch = self.mgr.latest_step()
        assert epoch is not None, f"no checkpoints under {self.prefix}"
        # restore every leaf directly as host numpy (concrete np template):
        # a template-free jax.Array restore replays the SAVED device
        # topology, which fails for checkpoints written by a different
        # mesh/process count (e.g. reading a pod-DP checkpoint on one host
        # for transfer/eval), and restoring onto a device then fetching
        # back pays serial per-leaf round-trips. A sharding-less
        # ShapeDtypeStruct does NOT work: orbax then replays the sharding
        # recorded in the checkpoint file. The merge/transfer consumers
        # re-place leaves on device themselves
        import jax
        import numpy as _np

        ocp = _ocp()
        meta = self.mgr.item_metadata(epoch)
        meta = getattr(meta, "tree", meta)  # TreeMetadata wrapper -> plain tree

        def as_numpy_template(m):
            if getattr(m, "dtype", None) is None:  # scalar / non-array leaf
                return ocp.RestoreArgs()
            return _np.zeros(m.shape, m.dtype)

        template = jax.tree.map(as_numpy_template, meta)
        return self.mgr.restore(
            epoch, args=ocp.args.StandardRestore(template)), epoch

    def latest_epoch(self) -> Optional[int]:
        self._join()
        return self.mgr.latest_step()

    def close(self):
        self._join()
        self.mgr.close()


def save_params_only(path: str, params, batch_stats=None):
    """One-shot save of inference variables (detector deployments)."""
    ckptr = _ocp().StandardCheckpointer()
    payload = {"params": params}
    if batch_stats is not None:
        payload["batch_stats"] = batch_stats
    ckptr.save(os.path.abspath(path), payload)
    ckptr.wait_until_finished()


def load_params_only(path: str, template):
    ckptr = _ocp().StandardCheckpointer()
    return ckptr.restore(os.path.abspath(path), target=template)
