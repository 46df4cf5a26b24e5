"""visualize_net — inspect a network's structure and compiled form.

The reference renders a graphviz plot of the MXNet symbol (reference
tools/visualize_net.py:19-25). The equivalents here are (a) a table of the
variable tree — values per module (two path levels), per collection —
and (b) the lowered StableHLO of the jitted forward — what XLA actually
compiles.

Usage::

    python -m dspnet_tpu.tools.visualize_net --network resnet-50_multi \
        --data-shape 3,512,1024
    python -m dspnet_tpu.tools.visualize_net --network vgg16_reduced \
        --data-shape 300 --hlo net.stablehlo.txt
"""

from __future__ import annotations

import argparse
from collections import defaultdict


def summarize(variables, depth: int = 2) -> str:
    """Table of ``variables`` ({collection: nested dict of arrays or shape
    structs}): arrays and values per module path cut at ``depth``."""
    import jax
    import numpy as np

    rows = defaultdict(lambda: [0, 0])
    totals = defaultdict(int)
    for col, tree in variables.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [str(getattr(k, "key", k)) for k in path]
            row = rows[(col, "/".join(keys[:depth]))]
            row[0] += 1
            row[1] += int(np.prod(leaf.shape))
            totals[col] += int(np.prod(leaf.shape))
    width = max([len(m) for _, m in rows] + [6])
    lines = [f"{'collection':<12} {'module':<{width}} {'arrays':>6} {'values':>12}"]
    for (col, mod), (n, size) in sorted(rows.items()):
        lines.append(f"{col:<12} {mod:<{width}} {n:>6} {size:>12,}")
    for col, size in sorted(totals.items()):
        lines.append(f"total {col}: {size:,}")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description="Print a network summary (+ optional HLO).")
    p.add_argument("--network", default="vgg16_reduced")
    p.add_argument("--num-classes", type=int, default=20)
    p.add_argument("--data-shape", default="300")
    p.add_argument("--train", action="store_true", help="summarize the train-mode graph")
    p.add_argument("--hlo", default="", help="write lowered StableHLO text here")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from dspnet_tpu.api import create_model
    from dspnet_tpu.cli.common import parse_data_shape

    H, W = parse_data_shape(args.data_shape)
    bundle = create_model(args.network, (H, W), args.num_classes)
    model = bundle.model
    x = jnp.zeros((1, H, W, 3), jnp.float32)

    variables = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x,
                                                  train=args.train))
    print(summarize(variables))
    print(f"task={bundle.task} anchors={bundle.num_anchors} input={H}x{W}")

    if args.hlo:
        mutable = ["batch_stats"] if args.train else False
        lowered = jax.jit(
            lambda v, x: model.apply(v, x, train=args.train, mutable=mutable)
        ).lower(variables, x)
        with open(args.hlo, "w") as f:
            f.write(lowered.as_text())
        print(f"wrote {args.hlo}")


if __name__ == "__main__":
    main()
