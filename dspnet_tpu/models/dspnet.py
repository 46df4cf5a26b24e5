"""DSPNet — the single-shot multitask network (det + distance + seg).

One Flax module produces every head's raw predictions in a single traced
graph; the reference's four near-duplicate symbol builders
(multitask_symbol_builder.py get_{det,seg,multi}_symbol[_train]) collapse
into a ``task`` field plus a ``train`` flag. Losses / target assignment /
NMS live outside the module (dspnet_tpu.train.losses, dspnet_tpu.ops.*) so
the same apply fn serves training, eval, and serving.

Outputs (NHWC in, dict out):
  * ``loc_preds``  (B, A, 5)   — 4 box offsets + 1 distance (task det/multi)
  * ``cls_logits`` (B, A, C+1) — raw class scores incl. background
  * ``seg_logits`` (B, H/4, W/4, 19) (task seg/multi)

The plain 4-coordinate SSD variant (reference symbol/symbol_builder.py,
legacy_vgg16_ssd_*) is the same module with ``loc_channels=4`` and
``task='det'`` — see :class:`SSDNet`.
"""

from __future__ import annotations

from typing import Any, Dict

from dspnet_tpu.models import nn

from dspnet_tpu.models.factory import NetConfig
from dspnet_tpu.models.heads import MultiBoxHead, MultiLayerFeature
from dspnet_tpu.models.inception import InceptionV3
from dspnet_tpu.models.resnet import ResNet, tap_index
from dspnet_tpu.models.seg_head import SegHead
from dspnet_tpu.models.vgg import VGG16Reduced


class DSPNet(nn.Module):
    """Multitask net. ``task`` in {'det', 'seg', 'multi'} mirrors the
    reference's network-name suffix dispatch (multi_train.py:309-317)."""

    cfg: NetConfig
    num_classes: int = 8  # object classes excluding background
    seg_classes: int = 19
    task: str = "multi"
    loc_channels: int = 5
    remat: bool = False
    seg_fast: bool = False  # score conv at native stream res (SegHead.fast)

    @nn.compact
    def __call__(self, images, train: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        if cfg.network != "resnet":
            raise NotImplementedError(
                "multitask heads require the 3-tap resnet presets (the "
                "reference's seg/multi builders index from_layers[0:3], "
                "multitask_symbol_builder.py:498-500)"
            )
        plus = ResNet(cfg.num_layers, remat=self.remat, name="backbone")(images, train)
        res3 = plus[tap_index(cfg.from_layers[0])]
        res4 = plus[tap_index(cfg.from_layers[1])]
        conv_feat = plus[tap_index(cfg.from_layers[2])]

        out: Dict[str, Any] = {}
        if self.task in ("det", "multi"):
            det_cfg = cfg.drop_first_tap()
            layers = MultiLayerFeature(
                det_cfg.num_filters, det_cfg.strides, det_cfg.pads,
                det_cfg.min_filter, det_cfg.kernels, name="multi_feat",
            )([res4, conv_feat], train)
            loc_preds, cls_logits = MultiBoxHead(
                self.num_classes + 1,
                det_cfg.sizes,
                det_cfg.ratios,
                self.loc_channels,
                det_cfg.normalizations,
                name="multibox",
            )(layers, train)
            out["loc_preds"] = loc_preds
            out["cls_logits"] = cls_logits
        if self.task in ("seg", "multi"):
            h, w = images.shape[1], images.shape[2]
            if images.shape[-1] == 12:  # pre-space-to-depth input (resnet.py)
                h, w = h * 2, w * 2
            out["seg_logits"] = SegHead(self.seg_classes, fast=self.seg_fast,
                                        name="seg")(
                res3, res4, conv_feat, (h // 8, w // 8), train
            )
        return out


class SSDNet(nn.Module):
    """Classic 4-coordinate SSD (reference symbol/symbol_builder.py:20-99):
    no tap dropping, no seg head; supports vgg16_reduced / inceptionv3 /
    resnet backbones."""

    cfg: NetConfig
    num_classes: int = 20
    loc_channels: int = 4
    remat: bool = False

    @nn.compact
    def __call__(self, images, train: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        if cfg.network == "resnet":
            plus = ResNet(cfg.num_layers, remat=self.remat, name="backbone")(images, train)
            taps = [plus[tap_index(n)] for n in cfg.from_layers if n]
        elif cfg.network == "vgg16_reduced":
            td = VGG16Reduced(name="backbone")(images, train)
            taps = [td[n] for n in cfg.from_layers if n]
        elif cfg.network == "inceptionv3":
            td = InceptionV3(name="backbone")(images, train)
            taps = [td[n] for n in cfg.from_layers if n]
        else:
            raise NotImplementedError(cfg.network)

        layers = MultiLayerFeature(
            cfg.num_filters, cfg.strides, cfg.pads, cfg.min_filter,
            cfg.kernels, name="multi_feat",
        )(taps, train)
        loc_preds, cls_logits = MultiBoxHead(
            self.num_classes + 1,
            cfg.sizes,
            cfg.ratios,
            self.loc_channels,
            cfg.normalizations,
            name="multibox",
        )(layers, train)
        return {"loc_preds": loc_preds, "cls_logits": cls_logits}
