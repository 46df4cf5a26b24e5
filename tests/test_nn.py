"""The in-repo module layer (dspnet_tpu/models/nn.py) against flax.linen.

The reference is the SAME model source run on flax.linen: the model
modules are re-imported with ``dspnet_tpu.models.nn`` pointing at
``flax.linen``, so any difference in naming, initialisation shapes, layer
semantics or state handling between the two layers shows up here.
"""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dspnet_tpu.models as models_pkg
from dspnet_tpu.models import dspnet as ours
from dspnet_tpu.models import factory, nn
from dspnet_tpu.models.layers import BN_MOMENTUM, BatchNorm

_MODEL_MODULES = ["layers", "resnet", "heads", "seg_head", "vgg", "inception",
                  "dspnet"]


@pytest.fixture(scope="module")
def flax_ref():
    """dspnet_tpu.models.dspnet re-imported on flax.linen; sys.modules and
    the package attributes are restored afterwards."""
    linen = pytest.importorskip("flax.linen")
    names = ["dspnet_tpu.models." + m for m in _MODEL_MODULES + ["nn"]]
    saved_mods = {n: sys.modules.get(n) for n in names}
    saved_attrs = {m: getattr(models_pkg, m, None) for m in _MODEL_MODULES + ["nn"]}
    try:
        sys.modules["dspnet_tpu.models.nn"] = linen
        models_pkg.nn = linen
        for n in names[:-1]:
            sys.modules.pop(n, None)
        ref = importlib.import_module("dspnet_tpu.models.dspnet")
    finally:
        for n, m in saved_mods.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
        for a, m in saved_attrs.items():
            if m is None:
                delattr(models_pkg, a)
            else:
                setattr(models_pkg, a, m)
    assert ref.DSPNet is not ours.DSPNet
    return ref


def _build(mod, net, task, size, remat=False):
    cfg = factory.get_config(net, size)
    if task == "ssd":
        return mod.SSDNet(cfg=cfg, num_classes=20, remat=remat)
    return mod.DSPNet(cfg=cfg, num_classes=8, task=task, remat=remat)


def _paths(tree):
    return {jax.tree_util.keystr(p): (v.shape, v.dtype)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# every preset models/factory.py builds, under each task its backbone allows
PRESETS = [
    ("resnet-18", "multi", 512, (128, 256), False),
    ("resnet-18", "det", 512, (128, 256), True),
    ("resnet-18", "ssd", 512, (128, 128), False),
    ("resnet-50", "multi", 512, (128, 256), True),
    ("resnet-50", "seg", 512, (128, 256), False),
    ("resnet-50", "ssd", 512, (128, 128), False),
    ("resnet101", "ssd", 512, (128, 128), True),
    ("vgg16_reduced", "ssd", 300, (300, 300), False),
    ("vgg16_reduced", "ssd", 512, (512, 512), False),
    ("inceptionv3", "ssd", 300, (300, 300), False),
    ("legacy_vgg16_ssd", "ssd", 300, (300, 300), False),
    ("legacy_vgg16_ssd", "ssd", 512, (512, 512), False),
]


@pytest.mark.parametrize("net,task,size,hw,remat", PRESETS)
def test_variable_tree_matches_flax(flax_ref, net, task, size, hw, remat):
    x = jnp.zeros((1,) + hw + (3,))
    got = jax.eval_shape(lambda: _build(ours, net, task, size, remat).init(
        jax.random.PRNGKey(0), x, train=True))
    want = jax.eval_shape(lambda: _build(flax_ref, net, task, size, remat).init(
        jax.random.PRNGKey(0), x, train=True))
    assert set(got) == {"params", "batch_stats"} or set(got) == {"params"}
    assert _paths(got) == _paths(want)


@pytest.fixture(scope="module")
def shared():
    model = _build(ours, "resnet-18", "multi", 512)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 128, 256, 3))
    return x, model.init(jax.random.PRNGKey(0), x, train=True)


@pytest.mark.parametrize("mode", ["train", "eval", "bf16"])
def test_outputs_match_flax_on_shared_variables(flax_ref, shared, mode):
    x, v = shared
    m_ours = _build(ours, "resnet-18", "multi", 512)
    m_ref = _build(flax_ref, "resnet-18", "multi", 512)
    if mode == "train":
        got, got_s = m_ours.apply(v, x, train=True, mutable=["batch_stats"])
        want, want_s = m_ref.apply(v, x, train=True, mutable=["batch_stats"])
        for a, b in zip(jax.tree.leaves(got_s), jax.tree.leaves(want_s)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        if mode == "bf16":
            v = jax.tree.map(lambda a: a.astype(jnp.bfloat16), v)
            x = x.astype(jnp.bfloat16)
        got = m_ours.apply(v, x, train=False)
        want = m_ref.apply(v, x, train=False)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                      np.asarray(want[k], np.float32))


@pytest.mark.parametrize("remat", [False, True])
def test_captured_intermediates_match_flax(flax_ref, remat):
    """``capture_intermediates`` records every module's output under the
    paths and with the shapes flax.linen records."""
    x = jnp.zeros((1, 128, 256, 3))

    def inter(mod):
        model = _build(mod, "resnet-18", "multi", 512, remat)

        def run():
            v = model.init(jax.random.PRNGKey(0), x, train=False)
            return model.apply(v, x, train=False, capture_intermediates=True,
                               mutable=["intermediates"])[1]

        return jax.eval_shape(run)

    got, want = inter(ours), inter(flax_ref)
    assert len(_paths(got)) > 50
    assert _paths(got) == _paths(want)


def _grads(model, v, x):
    def loss(p):
        out, stats = model.apply({"params": p, "batch_stats": v["batch_stats"]},
                                 x, train=True, mutable=["batch_stats"])
        return sum(jnp.mean(o ** 2) for o in out.values()), stats

    return jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])


def test_remat_grads_equal_plain(flax_ref, shared):
    """Rematerialised residual units give the plain gradients and BN stats
    (up to f32 reassociation of the recomputed forward), and exactly what
    flax's lifted remat gives."""
    x, v = shared
    (l0, s0), g0 = _grads(_build(ours, "resnet-18", "multi", 512), v, x)
    (l1, s1), g1 = _grads(_build(ours, "resnet-18", "multi", 512, True), v, x)
    (l2, s2), g2 = _grads(_build(flax_ref, "resnet-18", "multi", 512, True), v, x)
    assert float(l0) == pytest.approx(float(l1), rel=1e-6)
    scale = max(float(jnp.max(jnp.abs(g))) for g in jax.tree.leaves(g0))
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-4, atol=1e-5 * scale)
    for a, b in zip(jax.tree.leaves(s0), jax.tree.leaves(s1)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    assert float(l1) == float(l2)
    for a, b in zip(jax.tree.leaves((g1, s1)), jax.tree.leaves((g2, s2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_batchnorm_running_stat_update():
    """Two train-mode calls move the running stats by the MXNet rule
    ``r <- m*r + (1-m)*batch_stat`` (biased variance); eval mode reads them
    and writes nothing."""
    x1 = jax.random.normal(jax.random.PRNGKey(2), (4, 5, 6, 3)) * 2 + 1
    x2 = jax.random.normal(jax.random.PRNGKey(3), (4, 5, 6, 3)) - 0.5
    bn = BatchNorm()
    v = bn.init(jax.random.PRNGKey(0), x1, train=True)
    stats = v["batch_stats"]["BatchNorm_0"]
    np.testing.assert_array_equal(np.asarray(stats["mean"]), 0.0)
    np.testing.assert_array_equal(np.asarray(stats["var"]), 1.0)
    mean, var = np.zeros(3), np.ones(3)
    for x in (x1, x2):
        _, upd = bn.apply(v, x, train=True, mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
        xn = np.asarray(x, np.float64).reshape(-1, 3)
        mean = BN_MOMENTUM * mean + (1 - BN_MOMENTUM) * xn.mean(0)
        var = BN_MOMENTUM * var + (1 - BN_MOMENTUM) * xn.var(0)
        got = v["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(np.asarray(got["mean"]), mean, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(got["var"]), var, rtol=1e-5, atol=1e-6)
    y = bn.apply(v, x1, train=False)
    want = (np.asarray(x1) - mean) / np.sqrt(var + 2e-5)
    np.testing.assert_allclose(np.asarray(y), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="immutable"):
        bn.apply(v, x1, train=True)  # train mode writes stats: needs mutable


class _Pair(nn.Module):
    features: int

    @nn.compact
    def __call__(self, x):
        x = nn.Conv(self.features, (3, 3), padding="SAME")(x)
        x = nn.Conv(self.features, (1, 1), use_bias=False)(x)
        return nn.Conv(self.features, (1, 1), name="head")(nn.relu(x))


def test_auto_names_and_deterministic_init():
    x = jnp.ones((1, 4, 4, 2))
    v = _Pair(3).init(jax.random.PRNGKey(0), x)
    assert set(v["params"]) == {"Conv_0", "Conv_1", "head"}
    assert set(v["params"]["Conv_1"]) == {"kernel"}
    assert v["params"]["Conv_0"]["kernel"].shape == (3, 3, 2, 3)
    again = _Pair(3).init(jax.random.PRNGKey(0), x)
    for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(again)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # distinct paths draw distinct values
    assert not np.allclose(np.asarray(v["params"]["Conv_1"]["kernel"]),
                           np.asarray(v["params"]["head"]["kernel"]))


def test_missing_parameter_and_duplicate_name_raise():
    x = jnp.ones((1, 4, 4, 2))
    with pytest.raises(KeyError, match="Conv_0/kernel"):
        _Pair(3).apply({"params": {}}, x)

    class Dup(nn.Module):
        @nn.compact
        def __call__(self, x):
            nn.Conv(2, (1, 1), name="c")(x)
            return nn.Conv(2, (1, 1), name="c")(x)

    with pytest.raises(ValueError, match="duplicate"):
        Dup().init(jax.random.PRNGKey(0), x)
    with pytest.raises(RuntimeError, match="not bound"):
        _Pair(3)(x)


@pytest.mark.parametrize("fn", ["max_pool", "avg_pool"])
def test_pools_match_flax(fn):
    linen = pytest.importorskip("flax.linen")
    x = jax.random.normal(jax.random.PRNGKey(4), (2, 9, 7, 3))
    for window, stride, pad in [((3, 3), (2, 2), ((1, 1), (1, 1))),
                                ((2, 2), (2, 2), ((0, 0), (0, 0))),
                                ((3, 3), (1, 1), ((1, 2), (0, 1)))]:
        got = getattr(nn, fn)(x, window, stride, pad)
        want = getattr(linen, fn)(x, window, strides=stride, padding=pad)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
