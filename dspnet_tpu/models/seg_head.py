"""Pyramid-pooling semantic-segmentation head.

Contract: reference symbol/multitask_symbol_builder.py:541-589 —
* res3 / res4 taps are gradient-blocked, then 1x1-reduce -> BN -> 3x3 -> BN
  (128 / 256 channels);
* the top backbone feature goes through BatchNorm *directly* (the reference
  builds a ``res5_reduced`` 1x1 conv but then feeds the raw ``conv_feat``
  into ``res5_reduced_bn`` — builder.py:556-558 — so the conv is dead code;
  we reproduce the live path and drop the dead conv);
* three avg-pool branches (k1/s1 identity, k2/s2, k4/s4) of the BN'd top
  feature, each 1x1-conv (128/256/512) + BN;
* all six streams bilinear-resampled to (H/8, W/8) and concatenated
  (the reference hardcodes the 512x1024 grid (64, 128),
  builder.py:574-575 — we generalize to input/8 so other resolutions work);
* 3x3 conv -> seg_classes -> BN -> 4x4/2 transposed conv (bilinear init) to
  (H/4, W/4, seg_classes) logits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from dspnet_tpu.models import nn


from dspnet_tpu.models.layers import (
    BatchNorm,
    Deconv2x,
    avg_pool,
    conv,
    resize_bilinear_align_corners,
)


class _ConcatConv3x3(nn.Module):
    """3x3 conv over a channel-concatenation of multi-resolution streams,
    computed as the sum of per-slice convs — same parameter layout (one
    (3,3,sum(C_i),features) kernel at <name>/kernel, like nn.Conv over the
    concat), and the (B, H/8, W/8, 3320) concat tensor is never
    materialized in device memory.

    ``fast=False`` (default, reference-exact): every stream is bilinear-
    resized to ``grid_hw`` first, then convolved — conv distributes over
    the channel concat, so this is mathematically identical to the
    builder.py:574-584 graph (fp summation order differs via the tap-split
    below; see the reassociation bound in the tap-split paragraph).

    ``fast=True`` (opt-in variant): each stream is convolved at its NATIVE
    resolution and the ``features``-channel partial result is resized to
    ``grid_hw`` before summing — FCN-style score-then-upsample. The top
    (2048-channel, H/32) stream dominates the concat, so this cuts the
    score-conv FLOPs ~9x at resnet-50/512. Different numerics from the
    reference (conv and resize don't commute); train and eval with the same
    setting. Parameter shapes are identical in both modes.

    Exact-mode tap-split optimization: for every UPSAMPLED stream,
    resize-then-conv3x3 is computed as 1x1-conv-at-native-res
    (C -> 9*features per-tap channels) -> resize -> 9 shifted adds.
    Channel contraction commutes with the (channel-preserving, linear)
    bilinear resize and with spatial shifts, so this is the SAME linear
    map — only fp summation order differs. The 2048-channel PSP stream
    never materializes at grid resolution (~6x less HBM traffic on the
    head's dominant stream), and no upsampled stream pays a grid-res 3x3.
    Streams sharing a native resolution (the identity-pool branch and the
    top feature, both H/32) are contracted together and share one
    resize + shifted-add pass. Contractions, resizes and the shifted adds
    run in f32 while training (grad fidelity, conv-accumulator-like
    summation) and in the serving dtype at inference — the pad + 9
    slice/add sweep over the grid-res 9f-channel tensor is the head's
    dominant HBM traffic, and serving in bf16 halves its bytes; the
    9-term reassociation error (~2^-8 relative) is below the bf16
    quantization the streams already carry."""

    features: int
    fast: bool = False

    def _tap_contract(self, s, k, acc_dtype):
        """1x1 tap contraction: (3,3,c,f) kernel -> (1,1,c,9f), tap-major
        output channels (ky,kx,f)."""
        c = s.shape[-1]
        k1 = k.astype(acc_dtype).transpose(2, 0, 1, 3).reshape(
            1, 1, c, 9 * self.features)
        return jax.lax.conv_general_dilated(
            s.astype(acc_dtype), k1, (1, 1), [(0, 0), (0, 0)],
            dimension_numbers=jax.lax.conv_dimension_numbers(
                s.shape, k1.shape, ("NHWC", "HWIO", "NHWC")),
        )

    @staticmethod
    def _shifted_taps(z, f, grid_hw):
        """Sum the 9 resized tap channels with their spatial shifts, in
        z's dtype (f32 in training, serving dtype at inference)."""
        th, tw = int(grid_hw[0]), int(grid_hw[1])
        zp = jnp.pad(z, ((0, 0), (1, 1), (1, 1), (0, 0)))
        out = None
        for t in range(9):
            dy, dx = t // 3, t % 3
            part = jax.lax.slice(
                zp, (0, dy, dx, t * f),
                (zp.shape[0], dy + th, dx + tw, (t + 1) * f))
            out = part if out is None else out + part
        return out

    @nn.compact
    def __call__(self, streams, grid_hw, train: bool = False):
        total_c = sum(s.shape[-1] for s in streams)
        kernel = self.param(
            "kernel",
            nn.initializers.lecun_normal(),
            (3, 3, total_c, self.features),
        )
        dn = ("NHWC", "HWIO", "NHWC")
        f = self.features
        # exact mode: tap contractions/resizes/shifted adds run in f32
        # during TRAINING (grad fidelity through the reduce convs,
        # conv-accumulator-like summation); at inference everything runs in
        # the serving dtype, like the resize-then-conv it replaces would
        # (see class docstring for the reassociation-error bound)
        acc_dtype = jnp.float32 if train else streams[0].dtype

        split_groups = {}  # (h, w) -> list of (stream, kernel slice)
        out = None
        off = 0
        for s in streams:
            c = s.shape[-1]
            k = jax.lax.slice_in_dim(kernel, off, off + c, axis=2)
            off += c
            if not self.fast:
                # exact-mode tap-split for EVERY stream: contract channels
                # at native res, resize the 9f-channel result (identity for
                # grid-res streams), combine with 9 shifted adds (see class
                # docstring). Streams sharing a resolution are contracted
                # together and pay ONE resize + shifted-add pass (sum of
                # convs == conv of concat). Grid-res streams too: their
                # direct 3x3 conv has only 19 output channels (reference
                # op multitask_symbol_builder.py:312-318); as a 1x1 tap
                # contraction the outputs are 9f=171 channels, a wider
                # matrix product.
                split_groups.setdefault(s.shape[1:3], []).append((s, k))
                continue
            y = jax.lax.conv_general_dilated(
                s, k.astype(s.dtype), (1, 1), [(1, 1), (1, 1)],
                dimension_numbers=jax.lax.conv_dimension_numbers(
                    s.shape, k.shape, dn),
            )
            if y.shape[1:3] != tuple(grid_hw):
                y = resize_bilinear_align_corners(y, grid_hw)
            # sum the partial outputs in f32 so bf16 mode accumulates like
            # the single nn.Conv this replaces (per-conv accumulation is f32
            # inside the conv either way; preferred_element_type=f32 is not
            # usable here — its VJP produces a mixed-dtype conv)
            y = y.astype(jnp.float32)
            out = y if out is None else out + y

        # ONE shifted-add pass for every group: the 9 tap shifts are linear
        # in z, so sum the resized tap tensors first and shift once — each
        # extra pass costs ~9 grid-res slice+add sweeps, the dominant HBM
        # traffic of the exact head at large batch. acc_dtype everywhere:
        # f32 in training, the serving dtype at inference (see docstring).
        z_total = None
        for hw, group in split_groups.items():
            z = sum(self._tap_contract(s, k, acc_dtype) for s, k in group)
            if tuple(hw) != tuple(grid_hw):
                z = resize_bilinear_align_corners(z, grid_hw)
            z = z.astype(acc_dtype)
            z_total = z if z_total is None else z_total + z
        if z_total is not None:
            y = self._shifted_taps(z_total, f, grid_hw)
            out = y if out is None else out + y
        return out.astype(streams[0].dtype)


class SegHead(nn.Module):
    seg_classes: int = 19
    fast: bool = False  # see _ConcatConv3x3.fast

    @nn.compact
    def __call__(self, res3, res4, conv_feat, grid_hw, train: bool = False):
        res3 = jax.lax.stop_gradient(res3)  # BlockGrad (builder.py:542,549)
        r3 = conv(res3, 128, 1, 1, 0, use_bias=False, name="res3_reduced")
        r3 = BatchNorm(fix_gamma=True, name="res3_reduced_bn")(r3, train)
        r3 = conv(r3, 128, 3, 1, 1, use_bias=False, name="res3_reduced2")
        r3 = BatchNorm(fix_gamma=True, name="res3_reduced2_bn")(r3, train)

        res4 = jax.lax.stop_gradient(res4)
        r4 = conv(res4, 256, 1, 1, 0, use_bias=False, name="res4_reduced")
        r4 = BatchNorm(fix_gamma=True, name="res4_reduced_bn")(r4, train)
        r4 = conv(r4, 256, 3, 1, 1, use_bias=False, name="res4_reduced2")
        r4 = BatchNorm(fix_gamma=True, name="res4_reduced2_bn")(r4, train)

        r5 = BatchNorm(fix_gamma=True, name="res5_reduced_bn")(conv_feat, train)

        p1 = avg_pool(r5, 1, 1)
        p2 = avg_pool(r5, 2, 2)
        p4 = avg_pool(r5, 4, 4)
        s4 = conv(p4, 128, 1, 1, 0, use_bias=False, name="score2_pool4")
        s4 = BatchNorm(fix_gamma=True, name="score2_pool4_bn")(s4, train)
        s2 = conv(p2, 256, 1, 1, 0, use_bias=False, name="score2_pool2")
        s2 = BatchNorm(fix_gamma=True, name="score2_pool2_bn")(s2, train)
        s1 = conv(p1, 512, 1, 1, 0, use_bias=False, name="score2_pool1")
        s1 = BatchNorm(fix_gamma=True, name="score2_pool1_bn")(s1, train)

        streams = [s4, s2, s1, r5, r4, r3]  # concat order: builder.py:582
        x = _ConcatConv3x3(self.seg_classes, fast=self.fast,
                           name="score3_conv")(streams, grid_hw, train)
        x = BatchNorm(fix_gamma=True, name="score3_conv_bn")(x, train)
        return Deconv2x(self.seg_classes, name="score4_conv")(x)
