"""Pre-activation ResNet backbone (identity-mappings variant), NHWC Flax.

Architecture contract follows the reference symbol/resnet.py:11-169:
* leading fixed BatchNorm on raw data (``bn_data``, fix_gamma) then
  7x7/2 conv -> BN -> relu -> 3x3/2 maxpool;
* 4 stages; stage i > 1 downsamples in its first unit; bottleneck for
  depth >= 50 (filters [64,256,512,1024,2048]) else basic
  (filters [64,64,128,256,512]);
* pre-act residual units: BN-relu-conv chains, projection shortcut from the
  first activation when dims change.

The SSD factory taps the residual-add outputs, which the reference names
``_plusN`` with N counting adds across the whole network
(multitask_symbol_factory.py:58,72). We return every add output in order so
callers can index the same way.
"""

from __future__ import annotations

from typing import Sequence

from dspnet_tpu.models import nn

from dspnet_tpu.models.layers import (
    BatchNorm,
    SpaceToDepthConv,
    conv,
    max_pool,
    space_to_depth,
)

UNITS = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
    200: [3, 24, 36, 3],
    269: [3, 30, 48, 8],
}


def filters_for(num_layers: int) -> list[int]:
    if num_layers >= 50:
        return [64, 256, 512, 1024, 2048]
    return [64, 64, 128, 256, 512]


class ResidualUnit(nn.Module):
    """Pre-act residual unit (reference symbol/resnet.py:11-68)."""

    num_filter: int
    stride: tuple
    dim_match: bool
    bottle_neck: bool = True

    @nn.compact
    def __call__(self, x, train: bool = False):
        if self.bottle_neck:
            act1 = nn.relu(BatchNorm(name="bn1")(x, train))
            c = conv(act1, self.num_filter // 4, 1, 1, 0, use_bias=False, name="conv1")
            c = nn.relu(BatchNorm(name="bn2")(c, train))
            c = conv(c, self.num_filter // 4, 3, self.stride, 1, use_bias=False, name="conv2")
            c = nn.relu(BatchNorm(name="bn3")(c, train))
            c = conv(c, self.num_filter, 1, 1, 0, use_bias=False, name="conv3")
        else:
            act1 = nn.relu(BatchNorm(name="bn1")(x, train))
            c = conv(act1, self.num_filter, 3, self.stride, 1, use_bias=False, name="conv1")
            c = nn.relu(BatchNorm(name="bn2")(c, train))
            c = conv(c, self.num_filter, 3, 1, 1, use_bias=False, name="conv2")
        if self.dim_match:
            shortcut = x
        else:
            shortcut = conv(
                act1, self.num_filter, 1, self.stride, 0, use_bias=False, name="sc"
            )
        return c + shortcut


class ResNet(nn.Module):
    """Backbone; ``__call__`` returns the list of residual-add outputs
    (``plus_outputs[N]`` == the reference's ``_plusN`` internal).

    ``remat=True`` rematerializes each residual unit in the backward pass
    (jax.checkpoint) — trades ~30% extra FLOPs for O(depth) less activation
    memory, the counterpart of MXNet's ``memonger`` mirror option
    (reference symbol/resnet.py:49-50,66-67).
    """

    num_layers: int = 50
    remat: bool = False

    @nn.compact
    def __call__(self, x, train: bool = False) -> Sequence:
        units = UNITS[self.num_layers]
        filter_list = filters_for(self.num_layers)
        bottle_neck = self.num_layers >= 50
        # the train flag is a python bool -> static for the checkpointed fn
        Unit = nn.remat(ResidualUnit, static_argnums=(2,)) if self.remat else ResidualUnit

        # 7x7/2 stem as a space-to-depth 4x4/1 conv (same math + param
        # layout, a better-tiled backward) — see layers.SpaceToDepthConv.
        # sum_batch_cotangent: the only param upstream of conv0 is bn_data's
        # beta (fix_gamma, image input), whose grad is a batch-sum — so the
        # stem's input dgrad can run as ONE batch-1 conv (exact).
        # s2d BEFORE bn_data (stats folded back per original channel —
        # identical math, see _BatchNormImpl.fold): hoisting the relayout to
        # the raw input collapses three stem layout copies into one.
        if x.shape[-1] == 12:
            # pre-space-to-depth input: the loader already delivered
            # space_to_depth(image) ([B, H/2, W/2, 12], (dy, dx, c) channel
            # order), so no relayout exists on device at all — the H2D DMA
            # wrote the final arrangement. bn_data stats fold back per
            # original RGB channel (identical math, see _BatchNormImpl).
            x = BatchNorm(fix_gamma=True, fold=4, name="bn_data")(x, train)
            # bn_boundary_beta: conv0's output feeds ONLY the train-mode
            # bn0 below, so its cotangent sums to zero per channel and
            # bn_data's beta grad needs boundary strips only (layers.py)
            x = SpaceToDepthConv(filter_list[0], name="conv0")(
                x, sum_batch_cotangent=train, pre_s2d=True,
                bn_boundary_beta=train)
        elif x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
            x2 = space_to_depth(x)
            # stats from the pre-s2d view (identical values, contiguous
            # layout — keeps the stats reduce fused, see _BatchNormImpl)
            x = BatchNorm(fix_gamma=True, fold=4, name="bn_data")(
                x2, train, stats_input=x)
            x = SpaceToDepthConv(filter_list[0], name="conv0")(
                x, sum_batch_cotangent=train, pre_s2d=True,
                bn_boundary_beta=train)
        else:
            x = BatchNorm(fix_gamma=True, name="bn_data")(x, train)
            x = SpaceToDepthConv(filter_list[0], name="conv0")(
                x, sum_batch_cotangent=train)
        x = nn.relu(BatchNorm(name="bn0")(x, train))
        x = max_pool(x, 3, 2, 1)

        plus_outputs = []
        for i in range(4):
            stride = (1, 1) if i == 0 else (2, 2)
            x = Unit(
                filter_list[i + 1], stride, False, bottle_neck,
                name=f"stage{i + 1}_unit1",
            )(x, train)
            plus_outputs.append(x)
            for j in range(units[i] - 1):
                x = Unit(
                    filter_list[i + 1], (1, 1), True, bottle_neck,
                    name=f"stage{i + 1}_unit{j + 2}",
                )(x, train)
                plus_outputs.append(x)
        return plus_outputs


def tap_index(name: str) -> int:
    """'_plus7' -> 7 (reference internal-symbol naming)."""
    assert name.startswith("_plus"), name
    return int(name[len("_plus"):])
