"""A minimal module system in plain JAX.

Layers and models declare their hyper-parameters as dataclass fields and
create parameters inline in ``__call__`` (``self.param``), the way the
reference's torch modules declare theirs in ``__init__``. Calling a module
inside another one nests its parameters under its ``name`` (default
``ClassName_<k>``), so a model's parameter tree reads
``{"params": {"conv1": {"weight": ...}, "Dense_0": {...}}}``.

- ``Model(...).init(key, *args)`` runs one forward pass that creates the
  parameters and returns ``{"params": tree}``.
- ``Model(...).apply(variables, *args, rngs=..., mutable=[...])`` runs the
  forward pass on given parameters. Names in ``mutable`` are collections
  that ``self.sow`` may write (the layers sow activation-range telemetry);
  with ``mutable`` set, ``apply`` returns ``(out, collections)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import zlib
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import optax

_ctx = threading.local()


class _Scope:
    def __init__(self, params, key, rngs, mutable):
        self.params = params
        self.key = key  # parameter-init key; None when applying
        self.rngs = rngs or {}
        self.mutable = set(mutable)
        self.collections: dict = {}
        self.path: tuple = ()
        self.counters: dict = {}
        self.rng_counter = 0
        self.sow_enabled = True

    @property
    def initializing(self) -> bool:
        return self.key is not None

    def child_name(self, cls_name: str) -> str:
        k = (self.path, cls_name)
        i = self.counters.get(k, 0)
        self.counters[k] = i + 1
        return f"{cls_name}_{i}"

    def node(self, tree: dict, create: bool) -> dict:
        for p in self.path:
            if p not in tree:
                if not create:
                    raise KeyError(f"no parameters at {'/'.join(self.path)}")
                tree[p] = {}
            tree = tree[p]
        return tree


def _scope() -> _Scope:
    s = getattr(_ctx, "scope", None)
    if s is None:
        raise RuntimeError(
            "module called outside init/apply; use Model(...).init or .apply"
        )
    return s


@contextlib.contextmanager
def _entered(scope: _Scope):
    prev = getattr(_ctx, "scope", None)
    _ctx.scope = scope
    try:
        yield scope
    finally:
        _ctx.scope = prev


class Module:
    """Base class: subclasses become dataclasses with a trailing ``name``
    field; their ``__call__`` runs in the parameter scope of that name."""

    name: Optional[str]

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls.__annotations__ = {
            **cls.__dict__.get("__annotations__", {}),
            "name": Optional[str],
        }
        cls.name = None
        dataclasses.dataclass(cls, eq=False)
        call = cls.__call__

        def scoped_call(self, *args, **kwargs):
            scope = getattr(_ctx, "scope", None)
            if scope is None:
                raise RuntimeError(
                    f"{type(self).__name__} called outside init/apply"
                )
            if getattr(scope, "root", None) is self:
                scope.root = None  # the root module owns the top level
                return call(self, *args, **kwargs)
            name = self.name or scope.child_name(type(self).__name__)
            outer = scope.path
            scope.path = outer + (name,)
            try:
                return call(self, *args, **kwargs)
            finally:
                scope.path = outer

        cls.__call__ = scoped_call

    # ---------------------------------------------------------- in __call__

    def param(self, name: str, init_fn: Callable, shape, dtype=jnp.float32):
        scope = _scope()
        node = scope.node(scope.params, create=scope.initializing)
        if name not in node:
            if not scope.initializing:
                raise KeyError(
                    f"missing parameter {'/'.join(scope.path + (name,))}"
                )
            path = "/".join(scope.path + (name,))
            key = jax.random.fold_in(scope.key, zlib.crc32(path.encode()))
            node[name] = init_fn(key, shape, dtype)
        return node[name]

    def sow(self, collection: str, name: str, value) -> None:
        """Append ``value`` to ``collection`` when the caller made it
        mutable; a no-op otherwise."""
        scope = _scope()
        if collection not in scope.mutable or not scope.sow_enabled:
            return
        node = scope.node(
            scope.collections.setdefault(collection, {}), create=True
        )
        node[name] = node.get(name, ()) + (value,)

    def make_rng(self, name: str) -> jax.Array:
        scope = _scope()
        if name not in scope.rngs:
            raise KeyError(f"apply(..., rngs={{{name!r}: key}}) is required")
        scope.rng_counter += 1
        return jax.random.fold_in(scope.rngs[name], scope.rng_counter)

    # ------------------------------------------------------------ top level

    def init(self, key, *args, **kwargs) -> dict:
        scope = _Scope({}, key, kwargs.pop("rngs", None), ())
        scope.root = self
        with _entered(scope):
            self(*args, **kwargs)
        return {"params": scope.params}

    def apply(self, variables, *args, rngs=None, mutable=False, **kwargs):
        if mutable is True or isinstance(mutable, str):
            raise TypeError("mutable takes a list of collection names")
        scope = _Scope(variables["params"], None, rngs, mutable or ())
        scope.root = self
        with _entered(scope):
            out = self(*args, **kwargs)
        if mutable:
            return out, {k: scope.collections.get(k, {}) for k in mutable}
        return out


def remat(fn: Callable) -> Callable:
    """``fn(module, *args)`` under ``jax.checkpoint`` when applying: the
    backward recomputes its activations instead of storing them. The init
    pass runs it plainly, and sown telemetry is skipped inside it."""

    def wrapped(module, *args):
        scope = _scope()
        if scope.initializing:
            return fn(module, *args)
        prev, scope.sow_enabled = scope.sow_enabled, False
        try:
            return jax.checkpoint(lambda *a: fn(module, *a))(*args)
        finally:
            scope.sow_enabled = prev

    return wrapped


def lecun_normal(key, shape, dtype=jnp.float32):
    return jax.nn.initializers.lecun_normal()(key, shape, dtype)


def zeros(key, shape, dtype=jnp.float32):
    return jnp.zeros(shape, dtype)


class Dense(Module):
    """``x @ kernel + bias``."""

    features: int

    def __call__(self, x):
        kernel = self.param("kernel", lecun_normal, (x.shape[-1], self.features))
        bias = self.param("bias", zeros, (self.features,))
        return jnp.dot(x, kernel) + bias


class Dropout(Module):
    """Inverted dropout; draws from the ``"dropout"`` rng when active."""

    rate: float
    deterministic: bool = False

    def __call__(self, x):
        if self.deterministic or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), keep, x.shape)
        return jnp.where(mask, x / keep, 0.0).astype(x.dtype)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    """Parameters, optimizer state and step count of one training run."""

    step: jax.Array
    params: Any
    opt_state: Any
    apply_fn: Callable = dataclasses.field(metadata=dict(static=True))
    tx: Any = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def create(cls, *, apply_fn, params, tx) -> "TrainState":
        return cls(
            step=jnp.zeros((), jnp.int32), params=params,
            opt_state=tx.init(params), apply_fn=apply_fn, tx=tx,
        )

    def apply_gradients(self, *, grads) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
        return dataclasses.replace(
            self, step=self.step + 1,
            params=optax.apply_updates(self.params, updates),
            opt_state=opt_state,
        )

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)
