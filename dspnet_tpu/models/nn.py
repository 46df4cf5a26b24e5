"""Minimal functional module layer — the subset of ``flax.linen`` the
networks use, on plain JAX.

A :class:`Module` subclass is a dataclass whose ``@compact`` ``__call__``
declares parameters (:meth:`Module.param`) and state
(:meth:`Module.variable`) inline and builds child modules as it goes.
Children are named like Flax names them — an explicit ``name=`` or
``<ClassName>_<n>`` counted per class within the parent's call — so the
variable trees keep Flax's paths (``backbone/bn_data/BatchNorm_0/bias``):
saved checkpoints, ``utils/mxnet_import.py`` and the golden tests rely on
them. ``init`` returns ``{collection: nested dict}``; ``apply`` runs with
given variables and, with ``mutable=[...]``, also returns the updated
collections.

Initial values are drawn as Flax draws them: each parameter's key is the
init key folded with a SHA-1 hash of its module path and a per-module
counter, so a model initialised here from a key equals the same model
initialised by ``flax.linen`` from that key.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import hashlib
import threading
from typing import Any, Callable, Iterable, Mapping

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

initializers = jax.nn.initializers
relu = jax.nn.relu

_ctx = threading.local()  # stack of modules whose compact call is running


def _stack():
    if not hasattr(_ctx, "modules"):
        _ctx.modules = []
    return _ctx.modules


class _Root:
    """State shared by every scope of one init/apply: the variables (nested
    dicts per collection), which collections may change, and the init key."""

    def __init__(self, variables: Mapping, mutable, rng=None,
                 capture_intermediates: bool = False):
        self.initializing = rng is not None
        self.rng = rng
        self.mutable = mutable  # True (all) or a set of collection names
        self.capture_intermediates = capture_intermediates
        self.vars = {col: _copy_tree(t) if self.is_mutable(col) else t
                     for col, t in variables.items()}

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable


def _copy_tree(tree):
    """Copy the dict nodes (arrays are immutable) so writes stay local."""
    if isinstance(tree, Mapping):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def _lookup(tree, path):
    for key in path:
        if not isinstance(tree, Mapping) or key not in tree:
            return None
        tree = tree[key]
    return tree


class _Scope:
    """One module's position in the variable trees."""

    def __init__(self, root: _Root, path: tuple):
        self.root = root
        self.path = path
        self.rng_count = 0  # parameter keys drawn in this scope

    def get(self, col: str, name: str):
        return _lookup(self.root.vars.get(col), self.path + (name,))

    def put(self, col: str, name: str, value):
        if not self.root.is_mutable(col):
            raise ValueError(
                f"collection '{col}' is immutable here; pass "
                f"mutable=['{col}'] to apply ({'/'.join(self.path + (name,))})")
        node = self.root.vars.setdefault(col, {})
        for key in self.path:
            node = node.setdefault(key, {})
        node[name] = value

    def subtree(self):
        """{collection: this module's nested dict} for every collection."""
        out = {}
        for col, tree in self.root.vars.items():
            sub = _lookup(tree, self.path)
            if sub is not None:
                out[col] = sub
        return out

    def next_rng(self):
        """Key for the next parameter of this scope: the init key folded
        with SHA-1(path names, draw count), as ``flax.core.scope`` does."""
        self.rng_count += 1
        m = hashlib.sha1()
        for part in self.path:
            m.update(part.encode("utf-8"))
        n = self.rng_count
        m.update(n.to_bytes((n.bit_length() + 7) // 8, byteorder="big"))
        return jax.random.fold_in(
            self.root.rng, np.uint32(int.from_bytes(m.digest()[:4], "big")))


class Variable:
    """Handle on one state entry; ``.value`` reads and writes it."""

    def __init__(self, scope: _Scope, col: str, name: str):
        self._scope, self._col, self._name = scope, col, name

    @property
    def value(self):
        return self._scope.get(self._col, self._name)

    @value.setter
    def value(self, v):
        self._scope.put(self._col, self._name, v)


def compact(fn: Callable) -> Callable:
    """Mark ``__call__`` as the method that declares variables and children
    inline; children built during the call are scoped under this module."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._scope is None:
            raise RuntimeError(
                f"{type(self).__name__} is not bound: call it through "
                "init/apply or from a parent module's compact method")
        stack = _stack()
        stack.append(self)
        self._children = {}
        self._autoname = {}
        try:
            out = fn(self, *args, **kwargs)
        finally:
            stack.pop()
        if self._scope.root.capture_intermediates:
            self._scope.put("intermediates", "__call__", (out,))
        return out

    return wrapped


class Module:
    """Base class; subclasses are made dataclasses automatically. Construct
    with the fields (positional or keyword) plus an optional ``name=``."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, eq=False)
        field_init = cls.__init__

        def __init__(self, *args, name: str | None = None, **kw):
            field_init(self, *args, **kw)
            self._bind_to_parent(name)

        cls.__init__ = __init__

    def _bind_to_parent(self, name):
        self.name = name
        self._scope = None
        stack = _stack()
        if not stack:
            return  # a top-level module: bound by init/apply
        parent = stack[-1]
        if name is None:
            prefix = type(self).__name__
            n = parent._autoname.get(prefix, 0)
            parent._autoname[prefix] = n + 1
            name = self.name = f"{prefix}_{n}"
        if name in parent._children:
            raise ValueError(f"duplicate child name '{name}' in "
                             f"{type(parent).__name__}")
        parent._children[name] = self
        self._scope = _Scope(parent._scope.root, parent._scope.path + (name,))

    # ------------------------------------------------ inside compact calls

    def param(self, name: str, init_fn: Callable, *init_args):
        value = self._scope.get("params", name)
        if value is None:
            if not self._scope.root.initializing:
                raise KeyError("missing parameter "
                               + "/".join(self._scope.path + (name,)))
            value = init_fn(self._scope.next_rng(), *init_args)
            self._scope.put("params", name, value)
        return value

    def variable(self, col: str, name: str, init_fn: Callable, *init_args):
        scope = self._scope
        if scope.get(col, name) is None:
            if not (scope.root.initializing or scope.root.is_mutable(col)):
                raise KeyError(f"missing variable {col}:"
                               + "/".join(scope.path + (name,)))
            scope.put(col, name, init_fn(*init_args))
        return Variable(scope, col, name)

    def is_initializing(self) -> bool:
        return self._scope.root.initializing

    # ------------------------------------------------------- entry points

    def _run(self, root: _Root, args, kwargs):
        bound = copy.copy(self)
        bound._scope = _Scope(root, ())
        return bound(*args, **kwargs)

    def init_with_output(self, rngs, *args, **kwargs):
        """``(output, variables)`` of a first call; variables are
        ``{collection: nested dict}``."""
        rng = rngs["params"] if isinstance(rngs, Mapping) else rngs
        root = _Root({}, True, rng=rng)
        out = self._run(root, args, kwargs)
        return out, root.vars

    def init(self, rngs, *args, **kwargs):
        """Variables ``{collection: nested dict}`` for a first call."""
        return self.init_with_output(rngs, *args, **kwargs)[1]

    def apply(self, variables: Mapping, *args, mutable=False,
              capture_intermediates: bool = False, **kwargs):
        """Run with ``variables``; with ``mutable`` (a collection name, a
        list of them, or True) returns ``(out, updated collections)``.
        ``capture_intermediates`` records every module's output as
        ``intermediates/<path>/__call__`` (``mutable`` must include
        ``"intermediates"``)."""
        if isinstance(mutable, str):
            mutable = {mutable}
        elif mutable is not True:
            mutable = set(mutable or ())
        root = _Root(variables, mutable,
                     capture_intermediates=capture_intermediates)
        out = self._run(root, args, kwargs)
        if not mutable:
            return out
        return out, {col: t for col, t in root.vars.items()
                     if root.is_mutable(col)}


def remat(cls, static_argnums: Iterable[int] = ()):
    """``cls`` whose call is rematerialised in the backward pass
    (:func:`jax.checkpoint`). ``static_argnums`` index the call's arguments
    with ``self`` as 0, as in ``flax.linen.remat``."""

    def __call__(self, *args):
        scope = self._scope
        if scope.root.initializing:
            return cls.__call__(self, *args)
        mutable = scope.root.mutable

        def run(sub, *call_args):
            # the variables enter as arguments, so jax.checkpoint sees every
            # input and the state writes come back as outputs
            inner = copy.copy(self)
            root = _Root(sub, mutable, capture_intermediates=(
                scope.root.capture_intermediates))
            inner._scope = _Scope(root, ())
            out = cls.__call__(inner, *call_args)
            return out, {c: t for c, t in root.vars.items()
                         if root.is_mutable(c)}

        out, new = jax.checkpoint(run, static_argnums=tuple(static_argnums))(
            scope.subtree(), *args)
        for col, tree in new.items():
            for name, value in tree.items():
                scope.put(col, name, value)
        return out

    return type("Checkpoint" + cls.__name__, (cls,), {"__call__": __call__})


# ------------------------------------------------------------------ layers


def _pairs(padding):
    if isinstance(padding, str):
        return padding
    return [tuple(p) for p in padding]


class Conv(Module):
    """2-d convolution over NHWC inputs; kernel ``(kh, kw, in, features)``
    (HWIO), ``lecun_normal`` kernel and zero bias init."""

    features: int
    kernel_size: tuple
    strides: Any = 1
    padding: Any = "SAME"
    kernel_dilation: Any = 1
    use_bias: bool = True
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def _params(self, x):
        kernel = self.param("kernel", self.kernel_init,
                            (*self.kernel_size, x.shape[-1], self.features),
                            jnp.float32)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           jnp.float32) if self.use_bias else None)
        # compute in the promoted dtype of input and parameters
        dtype = jnp.result_type(x, kernel, *(() if bias is None else (bias,)))
        return kernel, bias, dtype

    @compact
    def __call__(self, x):
        kernel, bias, dtype = self._params(x)
        x, kernel = x.astype(dtype), kernel.astype(dtype)
        dn = lax.conv_dimension_numbers(x.shape, kernel.shape,
                                        ("NHWC", "HWIO", "NHWC"))
        y = lax.conv_general_dilated(
            x, kernel, _tuple(self.strides), _pairs(self.padding),
            rhs_dilation=_tuple(self.kernel_dilation), dimension_numbers=dn)
        if bias is not None:
            y = y + bias.astype(dtype)
        return y


class ConvTranspose(Conv):
    """2-d transposed convolution (``lax.conv_transpose``, kernel not
    flipped); kernel ``(kh, kw, in, features)``."""

    @compact
    def __call__(self, x):
        kernel, bias, dtype = self._params(x)
        y = lax.conv_transpose(
            x.astype(dtype), kernel.astype(dtype), _tuple(self.strides),
            _pairs(self.padding))
        if bias is not None:
            y = y + bias.astype(dtype)
        return y


def _tuple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _pool(x, init, reduce_fn, window_shape, strides, padding):
    window_shape = tuple(window_shape)
    strides = tuple(strides) if strides else (1,) * len(window_shape)
    batch_dims = x.ndim - len(window_shape) - 1
    dims = (1,) * batch_dims + window_shape + (1,)
    strides = (1,) * batch_dims + strides + (1,)
    if not isinstance(padding, str):
        padding = ((0, 0),) * batch_dims + tuple(map(tuple, padding)) + ((0, 0),)
    return lax.reduce_window(x, init, reduce_fn, dims, strides, padding)


def max_pool(x, window_shape, strides=None, padding="VALID"):
    return _pool(x, -jnp.inf, lax.max, window_shape, strides, padding)


def avg_pool(x, window_shape, strides=None, padding="VALID"):
    """Mean over the window, padding counted (``count_include_pad``)."""
    y = _pool(x, 0.0, lax.add, window_shape, strides, padding)
    return y / np.prod(window_shape)
