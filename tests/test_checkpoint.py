"""Checkpoint wrapper semantics — async save, snapshot isolation, join.

The per-epoch save must not stall training: ``save(block=False)`` snapshots on
device and writes on a background thread. The snapshot must survive the
training loop DONATING the original state buffers on the very next step.
"""

import numpy as np
import pytest


class _State:
    def __init__(self, params, batch_stats, opt_state, step):
        self.params = params
        self.batch_stats = batch_stats
        self.opt_state = opt_state
        self.step = step


def _mk_state():
    import jax.numpy as jnp

    return _State(
        params={"w": jnp.arange(64.0, dtype=jnp.float32).reshape(8, 8)},
        batch_stats={"mean": jnp.full((4,), 2.0)},
        opt_state={"m": jnp.ones((8, 8))},
        step=jnp.asarray(3, jnp.int32),
    )


def test_async_save_survives_donation(tmp_path):
    import jax

    from dspnet_tpu.utils.checkpoint import CheckpointManagerWrapper

    mgr = CheckpointManagerWrapper(str(tmp_path / "ck"))
    state = _mk_state()
    mgr.save(0, state, block=False)

    # donate + clobber the ORIGINAL buffers while the write is in flight —
    # exactly what the next train step does to the epoch-end state
    clobber = jax.jit(lambda x: x * 0 - 1, donate_argnums=0)
    state.params["w"] = clobber(state.params["w"])
    state.opt_state["m"] = clobber(state.opt_state["m"])

    assert mgr.latest_epoch() == 0  # joins the background write
    restored, ep = mgr.restore_raw(0)
    assert ep == 0
    np.testing.assert_array_equal(
        np.asarray(restored["params"]["w"]),
        np.arange(64.0, dtype=np.float32).reshape(8, 8))
    np.testing.assert_array_equal(np.asarray(restored["opt_state"]["m"]),
                                  np.ones((8, 8), np.float32))
    assert int(np.asarray(restored["step"])) == 3
    mgr.close()


def test_async_save_failure_surfaces_on_join(tmp_path, monkeypatch):
    # a silently dropped background save would defeat crash recovery — the
    # next join must re-raise
    from dspnet_tpu.utils.checkpoint import CheckpointManagerWrapper

    mgr = CheckpointManagerWrapper(str(tmp_path / "ck"))
    state = _mk_state()

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(mgr.mgr, "save", boom)
    mgr.save(0, state, block=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr._join()
    monkeypatch.undo()
    mgr.close()


def test_sequential_async_saves_all_commit(tmp_path):
    from dspnet_tpu.utils.checkpoint import CheckpointManagerWrapper

    mgr = CheckpointManagerWrapper(str(tmp_path / "ck"))
    state = _mk_state()
    for ep in range(3):  # each save joins the previous one first
        mgr.save(ep, state, block=ep == 2)
    assert mgr.latest_epoch() == 2
    for ep in range(3):
        restored, _ = mgr.restore_raw(ep)
        np.testing.assert_array_equal(
            np.asarray(restored["params"]["w"]).ravel()[:3],
            [0.0, 1.0, 2.0])
    mgr.close()
