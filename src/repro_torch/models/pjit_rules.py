"""Logical-axis sharding rules (``repro.models.pjit_rules``), the port's
partition-spec type ``P``, and its translation to DTensor placements.

The launcher binds logical axis names (``batch``, ``seq``, ``heads``, ...)
to mesh axes for the architecture at hand; ``sharding_rules`` makes a
binding current and ``current_rules`` reads it. Several assigned
architectures have head counts (14, 28, 24) that do not divide the 16-way
``model`` axis; column-sharding their ``wq`` would split inside a head, so
their attention weights replicate and attention runs context-parallel
(``seq`` over ``model``) while the MLP and embeddings stay tensor-parallel.

Model code annotates activations with ``constrain(x, "batch", "seq",
"heads", None)``. A binding applies to tensors only when it carries the
device mesh under ``"_mesh"`` (as JAX's dry-run binds it) and the tensor is
a ``DTensor``: then ``constrain`` redistributes it to the binding's
placements (JAX's ``with_sharding_constraint``); otherwise it returns the
tensor itself, so the one-device paths are untouched. ``sharding_rules``
with a mesh also lets plain tensors mix with DTensors as replicated values
(``implicit_replication``): the model builds positions and masks as plain
tensors, the same on every rank.

Where DTensor's own operators would gather, refuse an in-place write or
differ between PyTorch versions, model code runs on each rank's shards
with plain tensors: ``local_shard`` / ``from_shards`` cross between a
DTensor and this rank's shard, ``shard_span`` / ``placement_span`` give
the shard's range of a dim, ``rule_placements`` the placements the rules
give a tensor's dims, and ``all_reduce`` is the functional collective the
dry-run counts.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch

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
        if rules is not None and rules.get("_mesh") is not None:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
        else:
            yield
    finally:
        _RULES.reset(token)


def current_rules() -> Optional[Dict[str, Axis]]:
    return _RULES.get()


def _axes(part: Any) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    return () if part is None else (part,) if isinstance(part, str) else tuple(part)


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a ``DTensor`` (without importing DTensor's module
    on the one-device paths)."""
    return hasattr(x, "device_mesh")


def placements(spec: P, mesh) -> List[Any]:
    """DTensor placements of ``spec`` on a ``DeviceMesh`` with named dims:
    per mesh dim, ``Shard(d)`` where tensor dim d names it and
    ``Replicate()`` elsewhere. A tuple entry such as ``("pod", "data")``
    shards its dim over each of those mesh dims, the first name the major
    one, so its names must come in the mesh's order (DTensor's order); a
    spec that names a mesh axis twice raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out: List[Any] = [Replicate()] * mesh.ndim
    for d, part in enumerate(spec):
        axes = _axes(part)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: axes {axes} out of the mesh's order {names}")
        for m in dims:
            if isinstance(out[m], Shard):
                raise ValueError(f"{spec} names mesh axis {names[m]!r} twice")
            out[m] = Shard(d)
    return out


def _divides(spec: P, shape: torch.Size, mesh) -> bool:
    names = mesh.mesh_dim_names
    return all(n % math.prod(mesh.size(names.index(a)) for a in _axes(part)) == 0
               for part, n in zip(spec, shape))


def unflatten(x: torch.Tensor, dim: int, sizes: Tuple[int, ...]) -> torch.Tensor:
    """``x`` with dim ``dim`` split into ``sizes``. DTensor shards a split
    dim's outer part only, so a DTensor sharded on ``dim`` over a mesh dim
    that does not divide ``sizes[0]`` is first gathered on it there
    (GSPMD reshards such a split by itself)."""
    dim %= x.ndim
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        mesh = x.device_mesh
        pl = [Replicate() if isinstance(p, Shard) and p.dim == dim and sizes[0] % mesh.size(i)
              else p for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:]))


class _Flatten(torch.autograd.Function):
    """A merge of dims whose backward splits the gradient by ``unflatten``
    (DTensor's own backward of the merge cannot split a dim it shards
    unevenly)."""

    @staticmethod
    def forward(ctx, x, dim, sizes, shape):
        ctx.dim, ctx.sizes = dim, sizes
        return x.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, ctx.dim, ctx.sizes), None, None, None


def flatten(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with its dims ``dim .. dim + n - 1`` merged into one."""
    sizes = tuple(x.shape[dim:dim + n])
    shape = tuple(x.shape[:dim]) + (math.prod(sizes),) + tuple(x.shape[dim + n:])
    if not is_dtensor(x):
        return x.reshape(shape)
    return _Flatten.apply(x, dim, sizes, shape)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    DTensor built from a local gradient takes its strides as those of its
    global shape, and a permuted einsum gradient would break later views."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_shard(t: torch.Tensor, mesh, pl: List[Any],
                grad: Optional[List[Any]] = None) -> torch.Tensor:
    """This rank's shard of ``t`` redistributed to the placements ``pl``: a
    plain tensor counts as replicated (the same on every rank). ``grad``
    gives the placements of the gradient flowing back into it, where they
    differ from ``pl`` (a replicated input of a computation cut over a
    mesh dim gets a partial gradient there)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return _ContiguousGrad.apply(t.redistribute(mesh, pl).to_local(grad_placements=grad))


def from_shards(local: torch.Tensor, mesh, pl: List[Any]) -> torch.Tensor:
    """A DTensor of this rank's shard ``local`` in placements ``pl`` (every
    sharded dim divides evenly)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False)


def placement_span(size: int, dim: int, pl: List[Any], mesh) -> Tuple[int, int]:
    """(offset, length) of this rank's shard of a dim of ``size`` that is
    tensor dim ``dim`` under the placements ``pl``: each mesh dim that
    shards it cuts the piece left by the ones before it, the first the
    major one (DTensor's order). Raises where a mesh dim does not divide
    the piece it cuts."""
    from torch.distributed.tensor import Shard

    n, off = size, 0
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            k = mesh.size(i)
            if n % k:
                raise ValueError(f"a dim of {size} does not divide over mesh dim "
                                 f"{mesh.mesh_dim_names[i]!r} of {k}")
            n //= k
            off += mesh.get_local_rank(i) * n
    return off, n


def shard_span(t: torch.Tensor, dim: int) -> Tuple[int, int]:
    """(offset, length) of this rank's shard of the DTensor ``t``'s dim
    ``dim`` (``placement_span``)."""
    from torch.distributed.tensor import Shard

    pl = [Shard(p.dim % t.ndim) if isinstance(p, Shard) else p for p in t.placements]
    return placement_span(t.shape[dim], dim % t.ndim, pl, t.device_mesh)


def all_reduce(t: torch.Tensor, op: str, mesh, dims: List[int]) -> torch.Tensor:
    """``t`` reduced by ``op`` ("max" or "sum") over the mesh dims ``dims``,
    one functional collective per mesh dim (what the dry-run counts)."""
    from torch.distributed import _functional_collectives as funcol

    for i in dims:
        t = funcol.all_reduce(t, op, (mesh, i))
        if hasattr(t, "wait"):
            t = t.wait()
    return t


def rule_placements(shape: Tuple[int, ...], mesh, logical: Dict[int, str]) -> List[Any]:
    """Placements of a tensor of ``shape`` whose dims ``logical`` names
    (tensor dim -> logical axis): per mesh dim, ``Shard(d)`` where the
    active rules bind dim d's axis to it and its shards divide the piece
    left (a dim of one element stays whole, as in ``constrain``), else
    ``Replicate()`` (everything replicated without rules)."""
    from torch.distributed.tensor import Replicate, Shard

    rules = _RULES.get() or {}
    names = mesh.mesh_dim_names
    out: List[Any] = [Replicate()] * mesh.ndim
    for d, name in logical.items():
        n = shape[d]
        for a in _axes(rules.get(name)):
            i = names.index(a) if a in names else None
            if i is not None and not isinstance(out[i], Shard) and n > 1 \
                    and n % mesh.size(i) == 0:
                out[i] = Shard(d)
                n //= mesh.size(i)
    return out


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to the placements the active rules
    give its logical axes (JAX's ``with_sharding_constraint``). No-op
    without active rules, without a mesh in them, on a tensor that is not a
    DTensor, on rank mismatch, and where a mesh axis would not divide its
    dim (DTensor shards such a dim unevenly, and views of it then fail;
    JAX pads instead). A dim of one element stays whole: DTensor's views
    drop a sharded one (a batch of one on a mesh dim of one)."""
    rules = _RULES.get()
    if rules is None or rules.get("_mesh") is None:
        return x
    if not is_dtensor(x) or len(logical) != x.ndim:
        return x
    mesh = rules["_mesh"]
    spec = P(*(rules.get(name) if name and n > 1 else None
               for name, n in zip(logical, x.shape)))
    if not _divides(spec, x.shape, mesh):
        return x
    return x.redistribute(mesh, placements(spec, mesh))


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
