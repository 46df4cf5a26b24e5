"""VGG16-reduced backbone (SSD variant), NHWC Flax.

Contract: reference symbol/vgg16_reduced.py:3-86 — standard VGG16 conv trunk,
pool3 uses ceil ("full") pooling, pool5 becomes 3x3 stride-1 pad-1, fc6 is a
dilated (6) 3x3 conv, fc7 a 1x1 conv. Taps used by the SSD factory:
``relu4_3`` (stride 8) and ``relu7`` (stride 16).
"""

from __future__ import annotations

from dspnet_tpu.models import nn

from dspnet_tpu.models.layers import conv, max_pool, max_pool_full


class VGG16Reduced(nn.Module):
    @nn.compact
    def __call__(self, x, train: bool = False):
        del train  # no batchnorm in this backbone
        taps = {}

        def block(x, n_convs, filters, name):
            for i in range(n_convs):
                x = nn.relu(conv(x, filters, 3, 1, 1, name=f"{name}_{i + 1}"))
            return x

        x = block(x, 2, 64, "conv1")
        x = max_pool(x, 2, 2)
        x = block(x, 2, 128, "conv2")
        x = max_pool(x, 2, 2)
        x = block(x, 3, 256, "conv3")
        x = max_pool_full(x, 2, 2)  # pooling_convention="full" (vgg16_reduced.py:40-42)
        x = block(x, 3, 512, "conv4")
        taps["relu4_3"] = x
        x = max_pool(x, 2, 2)
        x = block(x, 3, 512, "conv5")
        x = max_pool(x, 3, 1, 1)  # pool5: stride 1 keeps resolution
        # fc6: dilated 3x3
        x = nn.relu(
            nn.Conv(1024, (3, 3), padding=[(6, 6), (6, 6)], kernel_dilation=(6, 6), name="fc6")(x)
        )
        x = nn.relu(conv(x, 1024, 1, 1, 0, name="fc7"))
        taps["relu7"] = x
        return taps
