"""InceptionV3 backbone, NHWC Flax.

Contract: reference symbol/inceptionv3.py:10-168 (standard InceptionV3 with
BN fix_gamma on every conv). The SSD factory taps
``ch_concat_mixed_7_chconcat`` (end of the 17x17 stage) and
``ch_concat_mixed_10_chconcat`` (end of the 8x8 stage)
(multitask_symbol_factory.py:44).
"""

from __future__ import annotations

import jax.numpy as jnp
from dspnet_tpu.models import nn

from dspnet_tpu.models.layers import BatchNorm, avg_pool, max_pool


class ConvBN(nn.Module):
    features: int
    kernel: tuple = (1, 1)
    stride: tuple = (1, 1)
    pad: tuple = (0, 0)

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = nn.Conv(
            self.features,
            self.kernel,
            strides=self.stride,
            padding=[(self.pad[0], self.pad[0]), (self.pad[1], self.pad[1])],
            use_bias=False,
            name="conv",
        )(x)
        # reference inceptionv3.py:12 passes no eps, so the MXNet default
        # 1e-3 applies (resnet/seg builders use 2e-5 explicitly)
        x = BatchNorm(fix_gamma=True, epsilon=1e-3, name="bn")(x, train)
        return nn.relu(x)


def _cat(*xs):
    return jnp.concatenate(xs, axis=-1)


class InceptionA(nn.Module):  # Inception7A
    p: tuple  # (1x1, 3red, 3a, 3b, 5red, 5, proj)
    pool: str = "avg"

    @nn.compact
    def __call__(self, x, train=False):
        n1, n3r, n3a, n3b, n5r, n5, proj = self.p
        t1 = ConvBN(n1, name="t1")(x, train)
        t5 = ConvBN(n5r, name="t5a")(x, train)
        t5 = ConvBN(n5, (5, 5), pad=(2, 2), name="t5b")(t5, train)
        t3 = ConvBN(n3r, name="t3a")(x, train)
        t3 = ConvBN(n3a, (3, 3), pad=(1, 1), name="t3b")(t3, train)
        t3 = ConvBN(n3b, (3, 3), pad=(1, 1), name="t3c")(t3, train)
        pl = avg_pool(x, 3, 1, 1) if self.pool == "avg" else max_pool(x, 3, 1, 1)
        tp = ConvBN(proj, name="tp")(pl, train)
        return _cat(t1, t5, t3, tp)


class InceptionB(nn.Module):  # Inception7B (downsample)
    p: tuple  # (3x3, d3red, d3a, d3b)

    @nn.compact
    def __call__(self, x, train=False):
        n3, dr, d1, d2 = self.p
        t3 = ConvBN(n3, (3, 3), (2, 2), (0, 0), name="t3")(x, train)
        td = ConvBN(dr, name="tda")(x, train)
        td = ConvBN(d1, (3, 3), pad=(1, 1), name="tdb")(td, train)
        td = ConvBN(d2, (3, 3), (2, 2), (0, 0), name="tdc")(td, train)
        pl = max_pool(x, 3, 2, 0)
        return _cat(t3, td, pl)


class InceptionC(nn.Module):  # Inception7C (7x1/1x7 factorized)
    p: tuple  # (1x1, d7red, d7a, d7b, q7red, q7a..q7d, proj)

    @nn.compact
    def __call__(self, x, train=False):
        n1, dr, d1, d2, qr, q1, q2, q3, q4, proj = self.p
        t1 = ConvBN(n1, name="t1")(x, train)
        td = ConvBN(dr, name="tda")(x, train)
        td = ConvBN(d1, (1, 7), pad=(0, 3), name="tdb")(td, train)
        td = ConvBN(d2, (7, 1), pad=(3, 0), name="tdc")(td, train)
        tq = ConvBN(qr, name="tqa")(x, train)
        tq = ConvBN(q1, (7, 1), pad=(3, 0), name="tqb")(tq, train)
        tq = ConvBN(q2, (1, 7), pad=(0, 3), name="tqc")(tq, train)
        tq = ConvBN(q3, (7, 1), pad=(3, 0), name="tqd")(tq, train)
        tq = ConvBN(q4, (1, 7), pad=(0, 3), name="tqe")(tq, train)
        pl = avg_pool(x, 3, 1, 1)
        tp = ConvBN(proj, name="tp")(pl, train)
        return _cat(t1, td, tq, tp)


class InceptionD(nn.Module):  # Inception7D (downsample)
    p: tuple  # (3red, 3x3, d7red, d7a, d7b, d7_3x3)

    @nn.compact
    def __call__(self, x, train=False):
        n3r, n3, dr, d1, d2, d3 = self.p
        t3 = ConvBN(n3r, name="t3a")(x, train)
        t3 = ConvBN(n3, (3, 3), (2, 2), (0, 0), name="t3b")(t3, train)
        td = ConvBN(dr, name="tda")(x, train)
        td = ConvBN(d1, (1, 7), pad=(0, 3), name="tdb")(td, train)
        td = ConvBN(d2, (7, 1), pad=(3, 0), name="tdc")(td, train)
        td = ConvBN(d3, (3, 3), (2, 2), (0, 0), name="tdd")(td, train)
        pl = max_pool(x, 3, 2, 0)
        return _cat(t3, td, pl)


class InceptionE(nn.Module):  # Inception7E (expanded)
    p: tuple  # (1x1, d3red, d3a, d3b, 33red, 33, 33a, 33b, proj)
    pool: str = "avg"

    @nn.compact
    def __call__(self, x, train=False):
        n1, dr, d1, d2, tr, t33, t1a, t1b, proj = self.p
        t1 = ConvBN(n1, name="t1")(x, train)
        td = ConvBN(dr, name="tda")(x, train)
        tda = ConvBN(d1, (1, 3), pad=(0, 1), name="tdb")(td, train)
        tdb = ConvBN(d2, (3, 1), pad=(1, 0), name="tdc")(td, train)
        tt = ConvBN(tr, name="tta")(x, train)
        tt = ConvBN(t33, (3, 3), pad=(1, 1), name="ttb")(tt, train)
        tta = ConvBN(t1a, (1, 3), pad=(0, 1), name="ttc")(tt, train)
        ttb = ConvBN(t1b, (3, 1), pad=(1, 0), name="ttd")(tt, train)
        pl = avg_pool(x, 3, 1, 1) if self.pool == "avg" else max_pool(x, 3, 1, 1)
        tp = ConvBN(proj, name="tp")(pl, train)
        return _cat(t1, tda, tdb, tta, ttb, tp)


class InceptionV3(nn.Module):
    """Returns dict with the factory's tap names
    ('ch_concat_mixed_7_chconcat', 'ch_concat_mixed_10_chconcat')."""

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = ConvBN(32, (3, 3), (2, 2), name="conv")(x, train)
        x = ConvBN(32, (3, 3), name="conv_1")(x, train)
        x = ConvBN(64, (3, 3), pad=(1, 1), name="conv_2")(x, train)
        x = max_pool(x, 3, 2, 0)
        x = ConvBN(80, name="conv_3")(x, train)
        x = ConvBN(192, (3, 3), name="conv_4")(x, train)
        x = max_pool(x, 3, 2, 0)
        x = InceptionA((64, 64, 96, 96, 48, 64, 32), "avg", name="mixed")(x, train)
        x = InceptionA((64, 64, 96, 96, 48, 64, 64), "avg", name="mixed_1")(x, train)
        x = InceptionA((64, 64, 96, 96, 48, 64, 64), "avg", name="mixed_2")(x, train)
        x = InceptionB((384, 64, 96, 96), name="mixed_3")(x, train)
        x = InceptionC((192, 128, 128, 192, 128, 128, 128, 128, 192, 192), name="mixed_4")(x, train)
        x = InceptionC((192, 160, 160, 192, 160, 160, 160, 160, 192, 192), name="mixed_5")(x, train)
        x = InceptionC((192, 160, 160, 192, 160, 160, 160, 160, 192, 192), name="mixed_6")(x, train)
        x = InceptionC((192, 192, 192, 192, 192, 192, 192, 192, 192, 192), name="mixed_7")(x, train)
        mixed_7 = x
        x = InceptionD((192, 320, 192, 192, 192, 192), name="mixed_8")(x, train)
        x = InceptionE((320, 384, 384, 384, 448, 384, 384, 384, 192), "avg", name="mixed_9")(x, train)
        x = InceptionE((320, 384, 384, 384, 448, 384, 384, 384, 192), "max", name="mixed_10")(x, train)
        return {
            "ch_concat_mixed_7_chconcat": mixed_7,
            "ch_concat_mixed_10_chconcat": x,
        }
