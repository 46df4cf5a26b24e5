"""Model construction / golden-shape tests.

The reference dumps full per-layer shape tables for resnet-50 at 320x640 and
512x1024 (utils.py:35-37); the anchor totals (4822 / 12264) and output shapes
there are our golden references. The analytic feature-shape math in the
factory is cross-checked against real forward passes at small resolutions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dspnet_tpu.models import factory
from dspnet_tpu.models.dspnet import DSPNet, SSDNet


def test_factory_shapes_resnet50_512():
    cfg = factory.get_config("resnet-50", 512)
    det = cfg.drop_first_tap()
    shapes = factory.feature_shapes(det, (512, 1024))
    assert shapes == [(32, 64), (16, 32), (8, 16), (4, 8), (2, 4), (1, 2)]
    anchors = factory.build_anchors(det, (512, 1024))
    assert anchors.shape == (12264, 4)  # utils.py:37 multibox_anchors
    anchors320 = factory.build_anchors(det, (320, 640))
    assert anchors320.shape == (4822, 4)  # utils.py:35


def test_factory_shapes_vgg300_ssd():
    cfg = factory.get_config("vgg16_reduced", 300)
    shapes = factory.feature_shapes(cfg, (300, 300))
    assert shapes == [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]
    anchors = factory.build_anchors(cfg, (300, 300))
    assert anchors.shape == (8732, 4)  # canonical SSD300 anchor count


@pytest.mark.parametrize("network,num_layers", [("resnet-18", 18), ("resnet-50", 50)])
def test_dspnet_multi_forward_shapes(network, num_layers):
    H, W = 128, 256  # small stand-in, same aspect as 512x1024
    cfg = factory.get_config(network, 512)
    model = DSPNet(cfg=cfg, num_classes=8, task="multi")
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), x, train=False)
    out = model.apply(variables, x, train=False)

    det_cfg = cfg.drop_first_tap()
    A = factory.build_anchors(det_cfg, (H, W)).shape[0]
    assert out["loc_preds"].shape == (1, A, 5)
    assert out["cls_logits"].shape == (1, A, 9)
    assert out["seg_logits"].shape == (1, H // 4, W // 4, 19)


def test_dspnet_train_mode_updates_batch_stats():
    cfg = factory.get_config("resnet-18", 512)
    model = DSPNet(cfg=cfg, num_classes=8, task="multi")
    x = jnp.ones((1, 128, 256, 3), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), x, train=True)
    assert "batch_stats" in variables
    _, updates = model.apply(variables, x, train=True, mutable=["batch_stats"])
    assert "batch_stats" in updates


@pytest.mark.parametrize(
    "network,size,hw",
    [("vgg16_reduced", 300, (300, 300)), ("inceptionv3", 300, (300, 300)),
     ("resnet101", 512, (128, 128))],
)
def test_ssd_forward_matches_analytic_anchors(network, size, hw):
    cfg = factory.get_config(network, size)
    model = SSDNet(cfg=cfg, num_classes=20)
    x = jnp.zeros((1, hw[0], hw[1], 3), jnp.float32)
    out = jax.eval_shape(
        lambda: model.init_with_output(jax.random.PRNGKey(0), x, train=False)[0]
    )
    A = factory.build_anchors(cfg, hw).shape[0]
    assert out["loc_preds"].shape == (1, A, 4)
    assert out["cls_logits"].shape == (1, A, 21)


def test_resize_bilinear_align_corners_oracle():
    """MXNet GridGenerator+BilinearSampler math (x_src=(x+1)(W-1)/2),
    transcribed to numpy, vs the separable-matmul implementation."""
    import numpy as np
    import jax.numpy as jnp
    from dspnet_tpu.models.layers import resize_bilinear_align_corners

    def oracle(x, th, tw):
        b, h, w, c = x.shape
        out = np.zeros((b, th, tw, c), np.float32)
        for yd in range(th):
            ys = 0.0 if th == 1 else yd * (h - 1) / (th - 1)
            y0, fy = int(np.floor(ys)), ys - int(np.floor(ys))
            y1 = min(y0 + 1, h - 1)
            for xd in range(tw):
                xs = 0.0 if tw == 1 else xd * (w - 1) / (tw - 1)
                x0, fx = int(np.floor(xs)), xs - int(np.floor(xs))
                x1 = min(x0 + 1, w - 1)
                out[:, yd, xd] = (
                    x[:, y0, x0] * (1 - fy) * (1 - fx) + x[:, y0, x1] * (1 - fy) * fx
                    + x[:, y1, x0] * fy * (1 - fx) + x[:, y1, x1] * fy * fx
                )
        return out

    rng = np.random.RandomState(0)
    for (h, w), (th, tw) in [((4, 6), (16, 24)), ((16, 16), (5, 3)),
                             ((1, 7), (4, 4)), ((8, 8), (8, 12))]:
        x = rng.randn(2, h, w, 3).astype(np.float32)
        got = np.asarray(resize_bilinear_align_corners(jnp.asarray(x), (th, tw)))
        np.testing.assert_allclose(got, oracle(x, th, tw), rtol=1e-5, atol=1e-5)
    # bf16 inputs stay close (2-term lerp with f32 accumulation)
    x = rng.randn(1, 8, 8, 4).astype(np.float32)
    got = np.asarray(resize_bilinear_align_corners(
        jnp.asarray(x, jnp.bfloat16), (32, 32)).astype(jnp.float32))
    np.testing.assert_allclose(got, oracle(x, 32, 32), rtol=2e-2, atol=2e-2)


def test_concat_conv_equals_conv_of_concat():
    """_ConcatConv3x3 must equal nn.Conv over the channel concat exactly
    (same single kernel parameter, distributed computation)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from flax import linen as nn
    from dspnet_tpu.models.seg_head import _ConcatConv3x3

    rng = jax.random.PRNGKey(0)
    streams = [jax.random.normal(jax.random.PRNGKey(i), (2, 8, 8, c))
               for i, c in enumerate([4, 8, 16])]
    m = _ConcatConv3x3(5)
    v = m.init(rng, streams, (8, 8))
    assert v["params"]["kernel"].shape == (3, 3, 28, 5)
    got = m.apply(v, streams, (8, 8))
    ref_conv = nn.Conv(5, (3, 3), padding=[(1, 1), (1, 1)], use_bias=False)
    ref = ref_conv.apply({"params": {"kernel": v["params"]["kernel"]}},
                         jnp.concatenate(streams, axis=-1))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_deconv2x_bilinear_init():
    """Deconv2x: exact 2x output, bilinear-filter channel-diagonal init
    (reference multi_init.py:13-21,160-168), constant-preserving interior."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from dspnet_tpu.models.layers import Deconv2x, bilinear_upsample_kernel

    m = Deconv2x(2)
    x = jnp.zeros((1, 5, 5, 2)).at[0, 2, 2, 0].set(1.0)
    v = m.init(jax.random.PRNGKey(0), x)
    y = np.asarray(m.apply(v, x))
    assert y.shape == (1, 10, 10, 2)
    # channel-diagonal: channel 1 sees nothing from channel 0's delta
    assert np.allclose(y[..., 1], 0)
    # the delta's footprint is exactly the 4x4 bilinear filter
    filt = bilinear_upsample_kernel(4)
    ys, xs = np.nonzero(y[0, :, :, 0])
    sub = y[0, ys.min():ys.min() + 4, xs.min():xs.min() + 4, 0]
    np.testing.assert_allclose(sub, filt, atol=1e-6)
    # constant input -> constant interior (proper partition of unity)
    yc = np.asarray(m.apply(v, jnp.ones((1, 6, 6, 2))))
    np.testing.assert_allclose(yc[0, 2:-2, 2:-2], 1.0, atol=1e-6)


def test_seg_fast_variant_same_params_and_shapes():
    """seg_fast=True (score-then-upsample) keeps the exact parameter tree of
    the reference-exact head, so checkpoints are shape-compatible."""
    import jax

    from dspnet_tpu.api import create_model

    x = jnp.ones((1, 128, 256, 3), jnp.float32)
    exact = create_model("resnet-18_multi", (128, 256))
    fast = create_model("resnet-18_multi", (128, 256), seg_fast=True)
    ve = jax.jit(lambda r: exact.model.init(r, x, train=False))(jax.random.PRNGKey(0))
    vf = jax.jit(lambda r: fast.model.init(r, x, train=False))(jax.random.PRNGKey(0))
    assert jax.tree.map(jnp.shape, ve) == jax.tree.map(jnp.shape, vf)
    oe = exact.model.apply(ve, x, train=False)
    of = fast.model.apply(vf, x, train=False)
    assert oe["seg_logits"].shape == of["seg_logits"].shape
    # different numerics by design (conv and resize don't commute)
    assert not np.allclose(np.asarray(oe["seg_logits"]),
                           np.asarray(of["seg_logits"]), atol=1e-3)


def test_batchnorm_matches_flax_reference():
    """The bandwidth-lean BatchNorm (layers._BatchNormImpl) must reproduce
    flax nn.BatchNorm numerics (f32): train-mode normalize, running-stat
    update, and eval-mode normalize, for both learned-scale and fix_gamma."""
    from flax import linen as fnn

    from dspnet_tpu.models.layers import BN_EPS, BN_MOMENTUM, BatchNorm

    rng = jax.random.PRNGKey(7)
    x = jax.random.normal(rng, (2, 8, 6, 5), jnp.float32) * 3.0 + 1.5

    for fix_gamma in (False, True):
        ours = BatchNorm(fix_gamma=fix_gamma)
        ref = fnn.BatchNorm(
            use_running_average=False, momentum=BN_MOMENTUM, epsilon=BN_EPS,
            use_scale=not fix_gamma, use_bias=True)

        v_ours = ours.init(rng, x, train=True)
        v_ref = ref.init(rng, x)
        # same tree layout (BatchNorm_0 scope lives in the wrapper for ours)
        p = jax.tree_util.tree_map(
            lambda a: a + 0.3, v_ours["params"])  # non-trivial bias/scale
        v_ours = {"params": p, "batch_stats": v_ours["batch_stats"]}
        v_ref = {"params": p["BatchNorm_0"], "batch_stats": v_ref["batch_stats"]}

        y_ours, m_ours = ours.apply(v_ours, x, train=True, mutable=["batch_stats"])
        y_ref, m_ref = ref.apply(v_ref, x, mutable=["batch_stats"])
        np.testing.assert_allclose(np.asarray(y_ours), np.asarray(y_ref),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(
            np.asarray(m_ours["batch_stats"]["BatchNorm_0"]["mean"]),
            np.asarray(m_ref["batch_stats"]["mean"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(m_ours["batch_stats"]["BatchNorm_0"]["var"]),
            np.asarray(m_ref["batch_stats"]["var"]), rtol=1e-5, atol=1e-6)

        # eval mode against the updated stats
        ref_eval = fnn.BatchNorm(
            use_running_average=True, momentum=BN_MOMENTUM, epsilon=BN_EPS,
            use_scale=not fix_gamma, use_bias=True)
        y_oe = ours.apply(
            {"params": p, "batch_stats": m_ours["batch_stats"]}, x, train=False)
        y_re = ref_eval.apply(
            {"params": p["BatchNorm_0"], "batch_stats": m_ref["batch_stats"]}, x)
        np.testing.assert_allclose(np.asarray(y_oe), np.asarray(y_re),
                                   rtol=2e-5, atol=2e-5)


def test_space_to_depth_conv_matches_plain_conv():
    """SpaceToDepthConv must equal the plain 7x7/2 pad-3 conv it replaces
    (same kernel param layout), on even and odd input sizes."""
    from flax import linen as fnn

    from dspnet_tpu.models.layers import SpaceToDepthConv

    rng = jax.random.PRNGKey(3)
    for hw in ((32, 48), (31, 47)):
        x = jax.random.normal(rng, (2, hw[0], hw[1], 3), jnp.float32)
        mod = SpaceToDepthConv(16)
        v = mod.init(rng, x)
        assert v["params"]["kernel"].shape == (7, 7, 3, 16)
        y = mod.apply(v, x)
        ref = fnn.Conv(16, (7, 7), strides=(2, 2),
                       padding=[(3, 3), (3, 3)], use_bias=False)
        y_ref = ref.apply({"params": v["params"]}, x)
        assert y.shape == y_ref.shape
        np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                                   rtol=1e-5, atol=1e-5)


def test_space_to_depth_sum_batch_cotangent_exact():
    """sum_batch_cotangent reroutes the stem's input dgrad through a batch-1
    conv of the batch-summed cotangent. In the stem graph it serves —
    fix_gamma bn_data over a non-differentiated image, then conv0 — every
    param grad (bn beta, conv kernel) must be EXACT vs the plain path, and
    the forward value identical, on even and odd input sizes."""
    from dspnet_tpu.models import nn

    from dspnet_tpu.models.layers import BatchNorm, SpaceToDepthConv

    class Stem(nn.Module):
        fast_grad: bool

        @nn.compact
        def __call__(self, x):
            x = BatchNorm(fix_gamma=True, name="bn_data")(x, train=True)
            return SpaceToDepthConv(16, name="conv0")(
                x, sum_batch_cotangent=self.fast_grad)

    rng = jax.random.PRNGKey(7)
    for hw in ((32, 48), (31, 47)):
        x = jax.random.normal(rng, (4, hw[0], hw[1], 3), jnp.float32)
        v = Stem(fast_grad=False).init(rng, x)
        y0 = Stem(fast_grad=False).apply(
            {"params": v["params"], "batch_stats": v["batch_stats"]}, x,
            mutable=["batch_stats"])[0]
        w = jax.random.normal(jax.random.PRNGKey(8), y0.shape)

        def loss(params, fast):
            y, _ = Stem(fast_grad=fast).apply(
                {"params": params, "batch_stats": v["batch_stats"]}, x,
                mutable=["batch_stats"])
            return jnp.sum(y * w)

        l0, g0 = jax.value_and_grad(loss)(v["params"], False)
        l1, g1 = jax.value_and_grad(loss)(v["params"], True)
        np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
        # identical in exact arithmetic; the reroute reassociates the batch
        # sum (before the conv instead of after), so allow f32 rounding
        np.testing.assert_allclose(
            np.asarray(g0["bn_data"]["BatchNorm_0"]["bias"]),
            np.asarray(g1["bn_data"]["BatchNorm_0"]["bias"]),
            rtol=5e-5, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(g0["conv0"]["kernel"]),
            np.asarray(g1["conv0"]["kernel"]), rtol=5e-5, atol=1e-5)


def test_stem_s2d_before_bn_matches_bn_first():
    """The reordered stem (space_to_depth -> fold-4 bn_data -> pre_s2d
    conv0, resnet.py even-dim path) must match the bn-first composition:
    identical forward, batch stats, and param grads (param SHAPES are the
    checkpoint contract: bn per original channel, kernel (7,7,C,F)).
    BN commutes with s2d exactly (same pixel multiset per channel); only
    f32 reassociation differs."""
    from dspnet_tpu.models import nn

    from dspnet_tpu.models.layers import (
        BatchNorm, SpaceToDepthConv, space_to_depth)

    class StemOld(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = BatchNorm(fix_gamma=True, name="bn_data")(x, train=True)
            return SpaceToDepthConv(16, name="conv0")(
                x, sum_batch_cotangent=True)

    class StemNew(nn.Module):
        @nn.compact
        def __call__(self, x):
            x2 = space_to_depth(x)
            x2 = BatchNorm(fix_gamma=True, fold=4, name="bn_data")(
                x2, train=True, stats_input=x)
            return SpaceToDepthConv(16, name="conv0")(
                x2, sum_batch_cotangent=True, pre_s2d=True)

    rng = jax.random.PRNGKey(7)
    x = jax.random.normal(rng, (4, 32, 48, 3), jnp.float32) * 2 + 0.5
    v = StemOld().init(rng, x)
    vn = StemNew().init(rng, x)
    assert jax.tree.map(lambda a: a.shape, v) == jax.tree.map(
        lambda a: a.shape, vn), "param/stat tree contract changed"
    w = jax.random.normal(jax.random.PRNGKey(8), (4, 16, 24, 16))

    def run(mod, params):
        y, m = mod.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x,
            mutable=["batch_stats"])
        return jnp.sum(y * w), (y, m["batch_stats"])

    (l0, (y0, s0)), g0 = jax.value_and_grad(run, has_aux=True, argnums=1)(
        StemOld(), v["params"])
    (l1, (y1, s1)), g1 = jax.value_and_grad(run, has_aux=True, argnums=1)(
        StemNew(), v["params"])
    np.testing.assert_allclose(np.asarray(y0), np.asarray(y1),
                               rtol=2e-5, atol=2e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(
            np.asarray(s0["bn_data"]["BatchNorm_0"][k]),
            np.asarray(s1["bn_data"]["BatchNorm_0"][k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(g0["bn_data"]["BatchNorm_0"]["bias"]),
        np.asarray(g1["bn_data"]["BatchNorm_0"]["bias"]),
        rtol=5e-5, atol=1e-5)
    # f32 reassociation across the batch*space contraction: loose rel tol
    np.testing.assert_allclose(
        np.asarray(g0["conv0"]["kernel"]),
        np.asarray(g1["conv0"]["kernel"]), rtol=5e-4, atol=5e-5)


def test_bn_boundary_beta_grad_exact_in_stem_context():
    """bn_boundary_beta computes bn_data's beta grad from boundary strips
    of the conv-output cotangent, using the identity that a train-mode
    BatchNorm's input cotangent sums to exactly zero per channel. In the
    real stem context (bn_data -> conv0 -> bn0(train) -> relu -> loss) the
    param grads must match plain autodiff; the test also checks the
    identity premise directly."""
    from dspnet_tpu.models import nn

    from dspnet_tpu.models.layers import (
        BatchNorm, SpaceToDepthConv, space_to_depth)

    class Stem(nn.Module):
        mode: str  # "plain" | "batch_sum" | "boundary"

        @nn.compact
        def __call__(self, x):
            x2 = space_to_depth(x)
            x2 = BatchNorm(fix_gamma=True, fold=4, name="bn_data")(
                x2, train=True, stats_input=x)
            y = SpaceToDepthConv(16, name="conv0")(
                x2, sum_batch_cotangent=self.mode != "plain", pre_s2d=True,
                bn_boundary_beta=self.mode == "boundary")
            y = BatchNorm(name="bn0")(y, train=True)
            return nn.relu(y)

    rng = jax.random.PRNGKey(11)
    x = jax.random.normal(rng, (4, 24, 32, 3), jnp.float32) * 2 + 0.5
    v = Stem(mode="plain").init(rng, x)
    w = jax.random.normal(jax.random.PRNGKey(12), (4, 12, 16, 16))

    def loss(params, mode):
        y, _ = Stem(mode=mode).apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x,
            mutable=["batch_stats"])
        return jnp.sum(y * w)

    grads = {m: jax.grad(loss)(v["params"], m)
             for m in ("plain", "batch_sum", "boundary")}
    # the boundary mode substitutes 0 for the interior sum of the cotangent;
    # its grads matching plain autodiff IS the verification of the premise
    for m in ("batch_sum", "boundary"):
        np.testing.assert_allclose(
            np.asarray(grads[m]["bn_data"]["BatchNorm_0"]["bias"]),
            np.asarray(grads["plain"]["bn_data"]["BatchNorm_0"]["bias"]),
            rtol=2e-3, atol=2e-5, err_msg=m)
        np.testing.assert_allclose(
            np.asarray(grads[m]["conv0"]["kernel"]),
            np.asarray(grads["plain"]["conv0"]["kernel"]),
            rtol=5e-4, atol=5e-5, err_msg=m)
        np.testing.assert_allclose(
            np.asarray(grads[m]["bn0"]["BatchNorm_0"]["bias"]),
            np.asarray(grads["plain"]["bn0"]["BatchNorm_0"]["bias"]),
            rtol=5e-5, atol=1e-6, err_msg=m)


def test_concat_conv_tap_split_upsampled_stream():
    """Exact-mode tap-split (1x1-contract at native res -> resize -> 9
    shifted adds, same-resolution streams grouped) must equal
    resize-then-conv3x3 for every upsampled stream, in train (f32
    contraction) and eval mode."""
    from flax import linen as fnn

    from dspnet_tpu.models.layers import resize_bilinear_align_corners
    from dspnet_tpu.models.seg_head import _ConcatConv3x3

    rng = jax.random.PRNGKey(1)
    F = 2
    streams = [
        jax.random.normal(jax.random.PRNGKey(10), (2, 4, 6, 32)),   # 2x up
        jax.random.normal(jax.random.PRNGKey(13), (2, 4, 6, 16)),   # 2x up (grouped)
        jax.random.normal(jax.random.PRNGKey(11), (2, 2, 3, 24)),   # 4x up
        jax.random.normal(jax.random.PRNGKey(12), (2, 8, 12, 8)),   # native
    ]
    grid = (8, 12)
    m = _ConcatConv3x3(F)
    v = m.init(rng, streams, grid)

    resized = jnp.concatenate(
        [resize_bilinear_align_corners(s, grid) for s in streams], axis=-1)
    ref = fnn.Conv(F, (3, 3), padding=[(1, 1), (1, 1)], use_bias=False).apply(
        {"params": {"kernel": v["params"]["kernel"]}}, resized)
    for train in (False, True):
        got = m.apply(v, streams, grid, train)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)

    # bf16 serving path: at inference the contraction/resize/shifted adds
    # run in the SERVING dtype (seg_head.py acc_dtype), exercising the
    # reassociated bf16 accumulation. Bound it against the bf16
    # resize-then-conv graph it replaces (loose: bf16 has ~2^-8 steps and
    # the 9-term tap sum reassociates).
    streams_bf = [s.astype(jnp.bfloat16) for s in streams]
    resized_bf = jnp.concatenate(
        [resize_bilinear_align_corners(s, grid) for s in streams_bf], axis=-1)
    ref_bf = fnn.Conv(
        F, (3, 3), padding=[(1, 1), (1, 1)], use_bias=False,
        dtype=jnp.bfloat16).apply(
        {"params": {"kernel": v["params"]["kernel"]}}, resized_bf)
    got_bf = m.apply(v, streams_bf, grid, False)
    assert got_bf.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(got_bf, dtype=np.float32),
        np.asarray(ref_bf, dtype=np.float32), rtol=2e-2, atol=2e-2)


def test_legacy_ssd_settled():
    """Legacy hand-written SSD graphs (reference legacy_vgg16_ssd_{300,512}
    .py): at 300 the graph is layer-for-layer the vgg16_reduced preset
    (legacy_vgg16_ssd_300.py:100-123 vs symbol_factory vgg 300), so the
    alias is exact; at 512 the last extra layer is a 4x4 pad-1 stride-1
    conv (legacy_vgg16_ssd_512.py:117-118) shrinking the final anchor grid
    to 1x1 — 24564 anchors, NOT the preset's 24576."""
    from dspnet_tpu.api import create_model, parse_network_name
    from dspnet_tpu.models import factory

    # 300: proven alias — identical config and identical anchor table
    cfg_p = factory.get_config("vgg16_reduced", 300)
    cfg_l = factory.get_config("legacy_vgg16_ssd", 300)
    assert cfg_l == cfg_p
    np.testing.assert_array_equal(
        factory.build_anchors(cfg_l, (300, 300)),
        factory.build_anchors(cfg_p, (300, 300)))

    # 512: own geometry
    assert parse_network_name("legacy_vgg16_ssd_512") == ("legacy_vgg16_ssd", "ssd")
    cfg512 = factory.get_config("legacy_vgg16_ssd", 512)
    shapes = factory.feature_shapes(cfg512, (512, 512))
    assert shapes == [(64, 64), (32, 32), (16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    # 4*64^2 + 6*32^2 + 6*16^2 + 6*8^2 + 6*4^2 + 4*2^2 + 4*1^2
    anchors = factory.build_anchors(cfg512, (512, 512))
    assert anchors.shape == (24564, 4)
    # the lone last-grid anchor set sits at the image center (step 1.0)
    cx = (anchors[-4:, 0] + anchors[-4:, 2]) / 2
    cy = (anchors[-4:, 1] + anchors[-4:, 3]) / 2
    np.testing.assert_allclose(cx, 0.5, atol=1e-6)
    np.testing.assert_allclose(cy, 0.5, atol=1e-6)

    bundle = create_model("legacy_vgg16_ssd_512", (512, 512), num_classes=20)
    assert bundle.anchors.shape == (24564, 4)
    v = jax.jit(lambda r, x: bundle.model.init(r, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 512, 512, 3)))
    k = v["params"]["multi_feat"]["multi_feat_6_conv_3x3"]["conv"]["kernel"]
    assert k.shape == (4, 4, 128, 256), k.shape  # the legacy conv12_2
    out = bundle.model.apply(v, jnp.zeros((2, 512, 512, 3)), train=False)
    assert out["loc_preds"].shape == (2, 24564, 4)


def test_deconv2x_output_geometry():
    """Deconv2x must produce an exact 2x upsample with the bilinear init
    (reference multi_init.py:160-168); a constant input maps to the same
    constant away from borders."""
    from dspnet_tpu.models.layers import Deconv2x

    x = jnp.ones((2, 5, 7, 3), jnp.float32)
    m = Deconv2x(3)
    v = m.init(jax.random.PRNGKey(0), x)
    y = np.asarray(m.apply(v, x))
    assert y.shape == (2, 10, 14, 3)
    np.testing.assert_allclose(y[:, 1:-1, 1:-1], 1.0, rtol=1e-6)
