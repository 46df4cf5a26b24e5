"""Mixed-precision helpers.

Tensor cores run bfloat16 at twice the TF32 rate; the inference path casts params + activations to
bf16 and decodes boxes in float32 (box decode / NMS stay exact).

Training: ``MultiTaskSolver(compute_dtype='bfloat16')`` keeps float32 master
weights and casts params + activations to bf16 inside the step (losses and
the optimizer update stay f32). NO loss scaling is used — bf16 shares
float32's exponent range, so gradients don't underflow the way fp16's
5-bit-exponent grads do; the canonical 512x1024 resnet-50 bf16 convergence
run (val mAP 0.69, see README) matched the f32 trajectory without it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cast_floating(tree, dtype):
    """Cast every floating leaf of a pytree to ``dtype``."""

    def cast(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x

    return jax.tree.map(cast, tree)


def bf16_variables(variables):
    return cast_floating(variables, jnp.bfloat16)
