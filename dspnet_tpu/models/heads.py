"""Multi-scale feature extraction + SSD/multitask prediction heads.

Contracts:
* extra pyramid layers: 1x1 conv (max(min_filter, f/2)) + relu, then 3x3
  stride-s pad-p conv (f) + relu — reference symbol/common.py:79-134
  (multi_layer_feature).
* per-scale heads: 3x3 pad-1 convs emitting ``K * loc_channels`` location
  regressors and ``K * num_classes`` class logits; NHWC flatten order
  (h, w, anchor, channel) matches the reference's NCHW->NHWC transpose +
  Flatten (symbol/common.py:393-412). ``loc_channels=5`` is the DSPNet
  multitask head (4 box + 1 distance, common.py:393); ``4`` is classic SSD
  (common.py:243).
* optional channel-L2 normalization with learned scale on selected layers
  (common.py:366-373).

The reference concatenates flattened per-layer outputs then reshapes to
(B, C, A) / (B, A*5); we return (B, A, C) and (B, A, 5) — same element
order, the layout XLA prefers (class/coord minor).
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
from dspnet_tpu.models import nn

from dspnet_tpu.models.layers import ConvAct, L2Normalize, conv


def num_anchors_per_cell(sizes: Sequence[float], ratios: Sequence[float]) -> int:
    return len(sizes) - 1 + len(ratios)


class MultiLayerFeature(nn.Module):
    """Append extra stride-2 pyramid layers after the backbone taps."""

    num_filters: tuple
    strides: tuple
    pads: tuple
    min_filter: int = 128
    # per-layer conv kernel size; () = all 3x3. Only the legacy 512 SSD
    # graph deviates (4x4 last layer, legacy_vgg16_ssd_512.py:117-118).
    kernels: tuple = ()

    @nn.compact
    def __call__(self, tap_layers: Sequence, train: bool = False):
        # the reference asserts the preset lists line up (common.py:113);
        # a short num_filters would otherwise silently drop pyramid scales
        assert len(self.num_filters) == len(self.strides) == len(self.pads), (
            self.num_filters, self.strides, self.pads)
        layers = list(tap_layers)
        n_taps = len(tap_layers)
        for k in range(n_taps, len(self.num_filters)):
            f, s, p = self.num_filters[k], self.strides[k], self.pads[k]
            ksz = self.kernels[k] if self.kernels else 3
            assert f > 0
            num_1x1 = max(self.min_filter, f // 2)
            x = ConvAct(num_1x1, (1, 1), (1, 1), (0, 0), name=f"multi_feat_{k}_conv_1x1")(
                layers[-1], train
            )
            x = ConvAct(f, (ksz, ksz), (s, s), (p, p),
                        name=f"multi_feat_{k}_conv_3x3")(x, train)
            layers.append(x)
        return layers


class MultiBoxHead(nn.Module):
    """Per-scale loc/cls conv heads -> concatenated (B, A, *) predictions."""

    num_classes: int  # including background
    sizes: tuple  # per-layer size tuples
    ratios: tuple  # per-layer ratio tuples
    loc_channels: int = 5
    normalizations: tuple = ()  # per-layer scale or <=0 for none

    @nn.compact
    def __call__(self, layers: Sequence, train: bool = False):
        del train
        loc_parts, cls_parts = [], []
        for k, x in enumerate(layers):
            if self.normalizations and self.normalizations[k] > 0:
                x = L2Normalize(float(self.normalizations[k]), name=f"norm_{k}")(x)
            K = num_anchors_per_cell(self.sizes[k], self.ratios[k])
            b, h, w, _ = x.shape
            loc = conv(x, K * self.loc_channels, 3, 1, 1, name=f"loc_pred_{k}")
            cls = conv(x, K * self.num_classes, 3, 1, 1, name=f"cls_pred_{k}")
            loc_parts.append(loc.reshape(b, h * w * K, self.loc_channels))
            cls_parts.append(cls.reshape(b, h * w * K, self.num_classes))
        return jnp.concatenate(loc_parts, axis=1), jnp.concatenate(cls_parts, axis=1)
