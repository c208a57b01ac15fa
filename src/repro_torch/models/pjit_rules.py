"""Logical-axis sharding rules (``repro.models.pjit_rules``), and the
port's partition-spec type ``P``.

The launcher binds logical axis names (``batch``, ``seq``, ``heads``, ...)
to mesh axes for the architecture at hand; ``sharding_rules`` makes a
binding current and ``current_rules`` reads it. Several assigned
architectures have head counts (14, 28, 24) that do not divide the 16-way
``model`` axis; column-sharding their ``wq`` would split inside a head, so
their attention weights replicate and attention runs context-parallel
(``seq`` over ``model``) while the MLP and embeddings stay tensor-parallel.

Applying a binding to a tensor needs a device mesh, which is not ported
yet; JAX's ``constrain`` comes with it.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Iterator, Optional, Tuple, Union

Axis = Union[str, Tuple[str, ...], None]


def _canonical(part: Any) -> Any:
    """One entry as ``jax.sharding.PartitionSpec`` keeps it: a sequence of
    axis names becomes a tuple, one name alone its string, none ``None``."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        if not part:
            return None
        return part[0] if len(part) == 1 else part
    return part


class P:
    """An immutable partition spec: per tensor dim, ``None`` (replicated),
    a mesh axis name, or a tuple of names that jointly shard the dim.
    Entries are canonical as JAX's ``PartitionSpec``'s, so ``tuple(spec)``
    of the two compare equal. Not a tuple itself, so tree utilities treat a
    spec as a leaf."""

    __slots__ = ("_parts",)

    def __init__(self, *parts: Any) -> None:
        object.__setattr__(self, "_parts", tuple(_canonical(p) for p in parts))

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("P is immutable")

    def __iter__(self) -> Iterator[Any]:
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i: Any) -> Any:
        return self._parts[i]

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, P):
            return self._parts == other._parts
        if isinstance(other, tuple):
            return self._parts == tuple(_canonical(o) for o in other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self._parts) + ")"


_RULES: contextvars.ContextVar[Optional[Dict[str, Axis]]] = contextvars.ContextVar(
    "sharding_rules", default=None
)


@contextlib.contextmanager
def sharding_rules(rules: Optional[Dict[str, Axis]]):
    token = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(token)


def current_rules() -> Optional[Dict[str, Axis]]:
    return _RULES.get()


def rules_for(cfg, multi_pod: bool, model_size: int = 16,
              kind: str = "train") -> Dict[str, Axis]:
    """Bind logical axes for an architecture on the production mesh."""
    dp: Axis = ("pod", "data") if multi_pod else ("data",)
    heads_div = cfg.n_heads > 0 and cfg.n_heads % model_size == 0
    kv_div = cfg.n_kv_heads > 0 and cfg.n_kv_heads % model_size == 0
    return {
        "batch": dp,
        # context parallelism only when head-sharding is impossible and the
        # op sees a full sequence (train/prefill)
        "seq": None if (heads_div or kind == "decode") else "model",
        "heads": "model" if heads_div else None,
        "kv_heads": "model" if kv_div else None,
        "d_ff": "model" if cfg.d_ff and cfg.d_ff % model_size == 0 else None,
        "d_model": None,
        "vocab": "model" if cfg.vocab_size % model_size == 0 else None,
        "ssm_inner": "model" if cfg.d_inner and cfg.d_inner % model_size == 0 else None,
    }


def attention_weights_replicated(cfg, model_size: int = 16) -> bool:
    """True when q-heads cannot shard over the model axis — attention
    weights replicate and attention runs context-parallel."""
    return cfg.n_heads > 0 and cfg.n_heads % model_size != 0
