"""Shared NHWC building blocks.

Notes: everything is NHWC, BatchNorm matches MXNet conventions (momentum 0.9 moving-average update,
``fix_gamma`` -> no learned scale), and the reference's
GridGenerator+BilinearSampler resampling (identity affine grid) is replaced
by an explicit align-corners bilinear resize — the exact math of
MXNet's sampler pair (grid in [-1,1] with endpoints at corner pixel centers,
``x_src = (x+1)(W-1)/2``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from dspnet_tpu.models import nn

BN_EPS = 2e-5
BN_MOMENTUM = 0.9


class _BatchNormImpl(nn.Module):
    """Bandwidth-lean BatchNorm core (see BatchNorm below for the contract).

    flax's nn.BatchNorm promotes the whole activation to float32 for the
    normalize in mixed precision, which materializes an f32 copy of every
    activation and the layout copies it forces. Here statistics are still accumulated in f32 (the converts fuse
    into the reductions, nothing f32-sized is materialized) and the
    normalize is folded to a per-channel affine y = x*A + B computed in f32
    on (C,)-vectors, applied in the activation dtype — one fused
    multiply-add that XLA sinks into the producer conv's epilogue."""

    use_scale: bool = True
    momentum: float = BN_MOMENTUM
    epsilon: float = BN_EPS
    fold: int = 1

    @nn.compact
    def __call__(self, x, use_running_average: bool, stats_input=None):
        # fold > 1: the input carries `fold` spatial phases of a
        # (c/fold)-channel tensor in its channel dim, c-minor (the stem's
        # space-to-depth layout, see resnet.py). Params/stats stay per
        # ORIGINAL channel — shapes and checkpoint paths unchanged — and
        # batch statistics reduce over all phases jointly, so the math is
        # the plain BN of the pre-s2d tensor (same pixel multiset per
        # channel; only f32 reassociation differs).
        #
        # stats_input: optional view of x carrying the SAME traced values
        # in a different spatial arrangement (e.g. the pre-space-to-depth
        # image; channel dim may be c or fold*c), used only for the
        # batch-statistics reduction. BN stats are permutation-invariant,
        # so this is mathematically free — but it lets XLA keep the stats
        # reduce fused over the contiguous layout instead of re-deriving it
        # through the transpose.
        c = x.shape[-1] // self.fold
        ra_mean = self.variable(
            "batch_stats", "mean", lambda: jnp.zeros((c,), jnp.float32))
        ra_var = self.variable(
            "batch_stats", "var", lambda: jnp.ones((c,), jnp.float32))
        bias = self.param("bias", nn.initializers.zeros, (c,))
        scale = (self.param("scale", nn.initializers.ones, (c,))
                 if self.use_scale else None)
        axes = tuple(range(x.ndim - 1))
        if use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            # f32 accumulation; the convert fuses into the reduce (the big
            # tensor is only ever read in its own dtype). Same fast-variance
            # formula as flax's _compute_stats.
            xs = x if stats_input is None else stats_input
            xf = xs.astype(jnp.float32)
            saxes = tuple(range(xs.ndim - 1))
            mean = jnp.mean(xf, axis=saxes)
            mean2 = jnp.mean(xf * xf, axis=saxes)
            if xs.shape[-1] != c:  # folded stats: join the phases
                mean = mean.reshape(-1, c).mean(0)
                mean2 = mean2.reshape(-1, c).mean(0)
            var = jnp.maximum(mean2 - mean * mean, 0.0)
            if not self.is_initializing():
                ra_mean.value = (
                    self.momentum * ra_mean.value + (1 - self.momentum) * mean)
                ra_var.value = (
                    self.momentum * ra_var.value + (1 - self.momentum) * var)
        mul = jax.lax.rsqrt(var + self.epsilon)
        if scale is not None:
            mul = mul * scale.astype(jnp.float32)
        add = bias.astype(jnp.float32) - mean * mul
        if self.fold > 1:
            mul = jnp.tile(mul, self.fold)
            add = jnp.tile(add, self.fold)
        return x * mul.astype(x.dtype) + add.astype(x.dtype)


class BatchNorm(nn.Module):
    """MXNet-convention BatchNorm (momentum 0.9, eps 2e-5).

    ``fix_gamma=True`` mirrors mx.sym.BatchNorm(fix_gamma=True): scale pinned
    to 1, only bias (beta) learned. ``use_running_average`` is the inference
    switch (MXNet `use_global_stats` semantics at test time).

    Param/stat tree paths keep flax nn.BatchNorm's ``<name>/BatchNorm_0/
    {scale,bias,mean,var}`` layout — a checkpoint contract relied on by
    utils/mxnet_import.py and every saved Orbax state.
    """

    fix_gamma: bool = False
    momentum: float = BN_MOMENTUM
    epsilon: float = BN_EPS
    fold: int = 1

    @nn.compact
    def __call__(self, x, train: bool, stats_input=None):
        return _BatchNormImpl(
            use_scale=not self.fix_gamma,
            momentum=self.momentum,
            epsilon=self.epsilon,
            fold=self.fold,
            name="BatchNorm_0",
        )(x, use_running_average=not train, stats_input=stats_input)


def conv(x, features, kernel, stride=1, pad="same_explicit", use_bias=True, name=None):
    """MXNet-style Convolution: explicit symmetric padding, NHWC."""
    if isinstance(kernel, int):
        kernel = (kernel, kernel)
    if isinstance(stride, int):
        stride = (stride, stride)
    if pad == "same_explicit":
        pad = ((kernel[0] - 1) // 2, (kernel[1] - 1) // 2)
    if isinstance(pad, int):
        pad = (pad, pad)
    padding = [(pad[0], pad[0]), (pad[1], pad[1])]
    return nn.Conv(
        features=features,
        kernel_size=kernel,
        strides=stride,
        padding=padding,
        use_bias=use_bias,
        name=name,
    )(x)


@jax.custom_vjp
def _batch_mean_cotangent_port(z):
    """Constant zeros of shape [1, *z.shape[1:]] "attached" to ``z``.

    Forward is a literal zeros constant (free — XLA folds every consumer of
    it out of the forward graph). Backward routes the port's cotangent g
    back to ``z`` as g / B broadcast over the batch: per-sample values are
    the batch MEAN of the true cotangent, so any consumer of z's gradient
    that only uses batch-sums (per h, w, c) sees EXACT values. Used by
    SpaceToDepthConv(sum_batch_cotangent=True)."""
    return jnp.zeros((1,) + z.shape[1:], z.dtype)


def _port_fwd(z):
    return _batch_mean_cotangent_port(z), z.shape[0]


def _port_bwd(batch, g):
    return (jnp.broadcast_to(g / batch, (batch,) + g.shape[1:]),)


_batch_mean_cotangent_port.defvjp(_port_fwd, _port_bwd)


@jax.custom_vjp
def _bn_boundary_cotangent_port(z, k4):
    """Constant zeros shaped like ``conv(z, k4, stride 1, pad (2,1)x(2,1))``,
    "attached" to ``z`` — the analytic replacement for the batch-1 dgrad
    conv of SpaceToDepthConv(sum_batch_cotangent=True).

    The stem's input-side gradient exists ONLY to produce bn_data's beta
    grad, a full (b, h, w) SUM of the input cotangent per channel. That sum
    is ``sum_{kh,kw,o} k4[kh,kw,c,o] * RectSum(kh,kw,o)`` where RectSum is
    the cotangent g summed over the output positions each kernel tap
    actually touched. Two identities collapse it:

    1. **The full sum of g is exactly zero per channel** when the conv's
       only consumer is a train-mode BatchNorm normalizing over (b, h, w)
       (resnet's bn0): the BN backward output is orthogonal to constants
       (``dx = (gamma/sigma)(gy - mean(gy) - xhat*mean(gy*xhat))`` sums to
       zero because sum(xhat) = 0). A constant shift of bn_data's beta
       changes conv0's output by a constant, and bn0 removes constants —
       the only leakage is the padding boundary.
    2. RectSum therefore equals MINUS the strip sums the tap's shift
       excludes: up to 2 top / 1 bottom rows and 1 left / 2 right columns
       (pad (2,1)x(2,1), 4x4 taps), with corner blocks added back by
       inclusion-exclusion.

    The backward thus reads only boundary strips of g (a few MB) instead of
    batch-summing the full cotangent and running a dgrad conv. The returned z-cotangent is the constant field
    ``beta_c / (B*Ho*Wo)`` — correct for every consumer that only uses
    (b, h, w)-sums of it (the sum_batch_cotangent contract, which resnet's
    stem satisfies: fix_gamma bn_data over the non-differentiated image).

    CONTRACT (caller asserts by choosing this mode): (a) z's gradient is
    consumed only through per-channel (b, h, w) sums; (b) the conv output
    feeds a train-mode BatchNorm over (b, h, w) and nothing else.
    """
    b, ho, wo, _ = z.shape
    return jnp.zeros((b, ho, wo, k4.shape[-1]), z.dtype)


def _bn_port_fwd(z, k4):
    return _bn_boundary_cotangent_port(z, k4), (z.shape, k4)


def _bn_port_bwd(res, g):
    zshape, k4 = res
    b, ho, wo, cin = zshape
    # boundary strip sums of g, per output channel o: pad is (2 before,
    # 1 after) in BOTH dims, so taps exclude up to 2 top rows / 1 bottom
    # row / 2 left cols / 1 right col; corner blocks restore the
    # inclusion-exclusion overlaps. Slice in g's dtype FIRST, convert the
    # small strips to f32 after — converting g up front makes XLA
    # materialize a full f32 copy of the cotangent just to feed these
    # few-MB reads.
    def _f32(strip):
        return strip.astype(jnp.float32)

    top = jnp.sum(_f32(g[:, :2]), axis=(0, 2))          # [2, F] rows 0,1
    bot = jnp.sum(_f32(g[:, -1:]), axis=(0, 2))         # [1, F]
    left = jnp.sum(_f32(g[:, :, :2]), axis=(0, 1))      # [2, F] cols 0,1
    right = jnp.sum(_f32(g[:, :, -1:]), axis=(0, 1))    # [1, F]
    tl = jnp.sum(_f32(g[:, :2, :2]), axis=0)            # [2, 2, F]
    tr = jnp.sum(_f32(g[:, :2, -1:]), axis=0)           # [2, 1, F]
    bl = jnp.sum(_f32(g[:, -1:, :2]), axis=0)           # [1, 2, F]
    br = jnp.sum(_f32(g[:, -1:, -1:]), axis=0)          # [1, 1, F]

    zero = jnp.zeros_like(top[0])

    def T(n):  # sum of the n excluded top rows
        return top[:n].sum(0) if n else zero

    def Bo(n):
        return bot[-n:].sum(0) if n else zero

    def L(n):
        return left[:n].sum(0) if n else zero

    def R(n):
        return right[-n:].sum(0) if n else zero

    def TL(n, m):
        return tl[:n, :m].sum((0, 1)) if n and m else zero

    def TR(n, m):
        return tr[:n, -m:].sum((0, 1)) if n and m else zero

    def BL(n, m):
        return bl[-n:, :m].sum((0, 1)) if n and m else zero

    def BR(n, m):
        return br[-n:, -m:].sum((0, 1)) if n and m else zero

    rect = []
    for kh in range(4):
        nt, nb = max(0, 2 - kh), max(0, kh - 2)
        row = []
        for kw in range(4):
            nl, nr = max(0, 2 - kw), max(0, kw - 2)
            # S (= 0 by identity 1) minus excluded strips, corners restored
            row.append(-T(nt) - Bo(nb) - L(nl) - R(nr)
                       + TL(nt, nl) + TR(nt, nr) + BL(nb, nl) + BR(nb, nr))
        rect.append(jnp.stack(row))
    rect = jnp.stack(rect)  # [4, 4, F]
    beta = jnp.einsum("hwcf,hwf->c", k4.astype(jnp.float32), rect)  # [cin]
    zcot = jnp.broadcast_to(
        (beta / (b * ho * wo)).astype(g.dtype), (b, ho, wo, cin))
    return zcot, jnp.zeros_like(k4)


_bn_boundary_cotangent_port.defvjp(_bn_port_fwd, _bn_port_bwd)


def space_to_depth(x):
    """[B, H, W, C] -> [B, H/2, W/2, 4C], channel order (dy, dx, c) with c
    minor — the layout SpaceToDepthConv(pre_s2d=True) consumes. Kept as a
    free function so the stem can hoist the one unavoidable relayout copy
    to the RAW input (before bn_data) instead of paying three copies
    (bn output relayout + 6-D transpose + conv-input copy); s2d-then-bn
    leaves a single transpose."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).transpose(
        0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


class SpaceToDepthConv(nn.Module):
    """7x7 stride-2 pad-3 stem conv, computed as a 4x4 stride-1 conv over
    the 2x2 space-to-depth transform of the input.

    Mathematically identical to the plain conv (a reindexing: output pixel
    (y,x) reads input u=2y+ky-3 which decomposes as u=2i+di, so each kernel
    row ky maps to a unique (i-offset, parity) pair), but far friendlier to
    the backward pass: the image's 3 channels become 12, spatial extent
    halves, and the kernel-gradient conv over the raw-resolution image
    tiles better. Whether it wins on the GPU is open (ROADMAP S3/D3). The parameter stays ``kernel (7,7,C,F)`` — checkpoint
    layout is unchanged; the transform is re-derived from it every step
    (param-sized, negligible).
    """

    features: int

    @nn.compact
    def __call__(self, x, sum_batch_cotangent: bool = False,
                 pre_s2d: bool = False, bn_boundary_beta: bool = False):
        """``sum_batch_cotangent=True`` reroutes the backward input-gradient
        through a batch-1 dgrad conv of the batch-summed output cotangent.
        Value-identical forward; the input cotangent becomes the per-sample
        batch MEAN (sum-preserving per (h, w, c)), so it is EXACT whenever
        every parameter gradient upstream of ``x`` consumes only batch-sums
        of it — true for the resnet stem, where ``x`` is a fix_gamma
        BatchNorm of the (non-differentiated) input image and the only
        upstream param is bn_data's beta (grad = sum over b,h,w of the
        cotangent). Why: XLA's full dgrad conv here has 12 output channels
        and runs at a small fraction of the matrix units' rate — only to be
        batch+space-summed into a 3-channel beta grad. Only set this under a trainable graph that
        satisfies the batch-sum condition.

        ``pre_s2d=True``: the caller already applied :func:`space_to_depth`
        (e.g. to hoist the relayout above bn_data); ``x`` is
        [B, H/2, W/2, 4C] in (dy, dx, c) channel order. The parameter stays
        the logical ``(7, 7, C, F)`` kernel either way.

        ``bn_boundary_beta=True`` (requires sum_batch_cotangent and the s2d
        path): additionally asserts the conv output feeds a TRAIN-mode
        BatchNorm over (b, h, w) and nothing else, which makes the full sum
        of the output cotangent exactly zero per channel — the input-side
        gradient then comes from boundary strips alone
        (:func:`_bn_boundary_cotangent_port`), no dgrad conv at all."""
        if pre_s2d:
            b, _, _, c4 = x.shape
            c = c4 // 4
        else:
            b, h, w, c = x.shape
        kernel = self.param(
            "kernel",
            nn.initializers.lecun_normal(),
            (7, 7, c, self.features),
        )
        k = kernel.astype(x.dtype)

        def apply_conv(z, kz, stride, pad):
            dn = jax.lax.conv_dimension_numbers(
                z.shape, kz.shape, ("NHWC", "HWIO", "NHWC"))
            return jax.lax.conv_general_dilated(
                z, kz, stride, pad, dimension_numbers=dn)

        def conv_sum_cotangent(z, kz, stride, pad):
            if not sum_batch_cotangent or z.shape[0] <= 1:
                return apply_conv(z, kz, stride, pad)
            zs = jax.lax.stop_gradient(z)
            y = apply_conv(zs, kz, stride, pad)  # wgrad path: exact (value z)
            if (bn_boundary_beta and stride == (1, 1)
                    and pad == ((2, 1), (2, 1))
                    and z.shape[1] >= 4 and z.shape[2] >= 4):
                # input-side gradient from boundary strips only (see
                # _bn_boundary_cotangent_port; forward term is zeros)
                return y + _bn_boundary_cotangent_port(
                    z, jax.lax.stop_gradient(kz))
            # _batch_mean_cotangent_port: constant-zero [1,h,w,c] forward
            # (XLA folds the whole port branch out of the forward graph),
            # whose cotangent returns to z as g/B per sample (sum-preserving)
            z1 = _batch_mean_cotangent_port(z)
            # dgrad path: batch-1 conv of the batch-summed cotangent (the
            # kernel grad of this branch is exactly 0 — input value is 0 —
            # so stop it instead of paying a second wgrad conv)
            y1 = apply_conv(z1, jax.lax.stop_gradient(kz), stride, pad)
            return y + jnp.broadcast_to(y1, y.shape)

        if not pre_s2d and (x.shape[1] % 2 or x.shape[2] % 2):
            # odd input: the s2d reindexing needs even dims
            return conv_sum_cotangent(x, k, (2, 2), ((3, 3), (3, 3)))
        # kernel: pad ky,kx 7->8 at the front, then split each into
        # (offset, parity); channel order (di, dj, c) matches space_to_depth
        kp = jnp.pad(k, ((1, 0), (1, 0), (0, 0), (0, 0)))
        k4 = kp.reshape(4, 2, 4, 2, c, self.features).transpose(
            0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * c, self.features)
        x2 = x if pre_s2d else space_to_depth(x)
        return conv_sum_cotangent(x2, k4, (1, 1), ((2, 1), (2, 1)))


class ConvAct(nn.Module):
    """conv + (optional BN) + relu — reference symbol/common.py:4-38."""

    features: int
    kernel: tuple = (1, 1)
    stride: tuple = (1, 1)
    pad: tuple = (0, 0)
    use_batchnorm: bool = False

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = conv(x, self.features, self.kernel, self.stride, self.pad, name="conv")
        if self.use_batchnorm:
            x = BatchNorm(name="bn")(x, train)
        return nn.relu(x)


class L2Normalize(nn.Module):
    """Channel L2-normalization with learned per-channel scale
    (reference symbol/common.py:366-373, used for VGG relu4_3)."""

    init_scale: float = 20.0

    @nn.compact
    def __call__(self, x):
        norm = jnp.sqrt(jnp.sum(jnp.square(x), axis=-1, keepdims=True) + 1e-10)
        scale = self.param(
            "scale", lambda key, shape: jnp.full(shape, self.init_scale), (x.shape[-1],)
        )
        return x / norm * scale


def max_pool(x, kernel, stride, pad=(0, 0)):
    """MXNet 'valid'-convention max pool (floor output size).

    The backward stays XLA's reduce_window VJP (select_and_scatter).
    """
    if isinstance(kernel, int):
        kernel = (kernel, kernel)
    if isinstance(stride, int):
        stride = (stride, stride)
    if isinstance(pad, int):
        pad = (pad, pad)
    return nn.max_pool(
        x,
        window_shape=kernel,
        strides=stride,
        padding=[(pad[0], pad[0]), (pad[1], pad[1])],
    )


def max_pool_full(x, kernel, stride, pad=(0, 0)):
    """MXNet 'full'-convention max pool (ceil output size) — used by the
    legacy VGG-SSD pool5 path."""
    if isinstance(kernel, int):
        kernel = (kernel, kernel)
    if isinstance(stride, int):
        stride = (stride, stride)
    if isinstance(pad, int):
        pad = (pad, pad)
    h, w = x.shape[1], x.shape[2]

    def extra(size, k, s, p):
        # ceil vs floor difference of ((size + 2p - k) / s)
        import math

        out_ceil = int(math.ceil((size + 2 * p - k) / s)) + 1
        out_floor = int(math.floor((size + 2 * p - k) / s)) + 1
        return (out_ceil - out_floor) * s

    eh = extra(h, kernel[0], stride[0], pad[0])
    ew = extra(w, kernel[1], stride[1], pad[1])
    return nn.max_pool(
        x,
        window_shape=kernel,
        strides=stride,
        padding=[(pad[0], pad[0] + eh), (pad[1], pad[1] + ew)],
    )


def avg_pool(x, kernel, stride, pad=(0, 0)):
    if isinstance(kernel, int):
        kernel = (kernel, kernel)
    if isinstance(stride, int):
        stride = (stride, stride)
    if isinstance(pad, int):
        pad = (pad, pad)
    return nn.avg_pool(
        x,
        window_shape=kernel,
        strides=stride,
        padding=[(pad[0], pad[0]), (pad[1], pad[1])],
    )


def _bilinear_axis_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) align-corners bilinear interpolation matrix (trace-time
    numpy constant): row d holds the two source weights for output d."""
    W = np.zeros((dst, src), np.float32)
    if dst == 1 or src == 1:
        W[:, 0] = 1.0
        return W
    pos = np.arange(dst, dtype=np.float64) * ((src - 1) / (dst - 1))
    lo = np.clip(np.floor(pos).astype(np.int64), 0, src - 1)
    hi = np.clip(lo + 1, 0, src - 1)
    frac = (pos - lo).astype(np.float32)
    np.add.at(W, (np.arange(dst), lo), 1.0 - frac)
    np.add.at(W, (np.arange(dst), hi), frac)
    return W


def resize_bilinear_align_corners(x, target_hw: Sequence[int]):
    """Bilinear resize with align_corners=True on NHWC.

    Equivalent to the reference's GridGenerator(identity affine) +
    BilinearSampler pair (multitask_symbol_builder.py:574-581): source
    coordinate ``x_src = (x_norm + 1) * (W_src - 1) / 2`` with the normalized
    grid hitting +-1 exactly at corner pixel centers.

    The interpolation is separable, so it runs as two small dense matmuls
    (out = Wy @ x @ Wx^T) instead of gather chains — gathers materialize four full-size intermediates of the widest
    stream (2048 channels in the PSP head), which made this op as expensive
    as the whole backbone.
    """
    th, tw = int(target_hw[0]), int(target_hw[1])
    b, h, w, c = x.shape
    if (h, w) == (th, tw):
        return x
    # fractional weights truncate to zero in integer dtypes — resize int
    # maps (seg ids, raw uint8) with nearest sampling instead
    assert jnp.issubdtype(x.dtype, jnp.floating), (
        f"bilinear resize needs a floating dtype, got {x.dtype}")
    wy = jnp.asarray(_bilinear_axis_matrix(h, th), x.dtype)
    wx = jnp.asarray(_bilinear_axis_matrix(w, tw), x.dtype)
    # f32 accumulation keeps bf16 inputs exact enough (each row
    # has at most two nonzeros, so this is numerically a 2-term lerp)
    out = jnp.einsum("hs,bswc->bhwc", wy, x, preferred_element_type=jnp.float32)
    out = jnp.einsum("wt,bhtc->bhwc", wx, out, preferred_element_type=jnp.float32)
    return out.astype(x.dtype)


def bilinear_upsample_kernel(size: int, dtype=np.float32) -> np.ndarray:
    """Bilinear upsampling filter for deconv init
    (reference multi_init.py:13-21, upsample_filt)."""
    factor = (size + 1) // 2
    center = factor - 1 if size % 2 == 1 else factor - 0.5
    og = np.ogrid[:size, :size]
    return ((1 - abs(og[0] - center) / factor) * (1 - abs(og[1] - center) / factor)).astype(dtype)


class Deconv2x(nn.Module):
    """4x4 stride-2 pad-1 transposed conv (exact 2x upsample), initialized
    with the bilinear filter like the reference (multi_init.py:160-168).

    Output geometry matches mx.sym.Deconvolution(kernel=4, stride=2, pad=1,
    no_bias). NOTE flax ConvTranspose does not flip the kernel
    (transpose_kernel=False), so numerical equivalence to MXNet holds for
    the symmetric bilinear filter but NOT for arbitrary learned weights —
    importing MXNet-trained deconv kernels needs a spatial flip + in/out
    transpose (utils/mxnet_import._deconv_kernel).

    Only this plain path exists: XLA lowers the input-dilated transposed
    conv directly at the seg head's 19-channel shapes.
    """

    features: int

    @nn.compact
    def __call__(self, x):
        c_in = x.shape[-1]

        def init(key, shape, dtype=jnp.float32):
            # flax ConvTranspose kernel: (kh, kw, in, out)
            filt = bilinear_upsample_kernel(4)
            k = np.zeros(shape, np.float32)
            for i in range(min(c_in, self.features)):
                k[:, :, i, i] = filt
            return jnp.asarray(k, dtype)

        # lax.conv_transpose padding applies to the dilated input;
        # MXNet's deconv pad p corresponds to (k - 1 - p) = 2 per side
        # for k=4, p=1, giving exactly 2x output size.
        return nn.ConvTranspose(
            features=self.features,
            kernel_size=(4, 4),
            strides=(2, 2),
            padding=((2, 2), (2, 2)),
            use_bias=False,
            kernel_init=init,
        )(x)
