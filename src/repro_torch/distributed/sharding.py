"""Logical-axis sharding rules (MaxText-style) mapping model axes onto the mesh.

The port of ``repro/distributed/sharding.py``. Model code never names mesh
axes; it tags tensors with *logical* axes (``constrain(x, ("batch", "seq",
"embed"))``) and parameters carry logical-axis metadata. A rule set maps
logical axes -> mesh axes; swapping rule sets re-shards the whole model
(train FSDP+TP vs serve TP vs sequence-parallel variants) without touching
model code.

The rule sets and their resolution (``RULE_SETS``, ``_rules``,
``logical_to_spec``) are the reference's, pure Python over
``mesh.axis_names`` and ``mesh.shape[a]``. What they resolve to differs:
the reference's ``NamedSharding`` over a JAX ``Mesh`` becomes DTensor
placements over a ``DeviceMesh`` (``spec_to_placements``), and
``jax.lax.with_sharding_constraint`` becomes ``DTensor.redistribute``.

Rules resolve inside an ``axis_rules(mesh, rules)`` context, where `mesh` is
the port's mesh wrapper (``launch/mesh.py``). With no context active, or on
a plain tensor, ``constrain`` returns its input, so single-device code runs
unmodified.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

# A logical axis maps to: a mesh axis name, a tuple of mesh axes (joint sharding),
# or None (replicated).
MeshAxes = Union[str, Tuple[str, ...], None]
AxisRules = Dict[str, MeshAxes]

_state = threading.local()


class P(tuple):
    """PartitionSpec: one entry per tensor dim, each a mesh axis name, a tuple
    of mesh axes (joint sharding, major to minor) or None; trailing None
    entries dropped. ``tuple(P(...))`` equals the reference's."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# --------------------------------------------------------------------------- rule sets
def _rules(**kw: MeshAxes) -> AxisRules:
    base: AxisRules = {
        "batch": ("pod", "data"),   # missing mesh axes are dropped at resolve time
        "seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "expert_ff": None,
        "layers": None,
        "fsdp": None,               # weight dim co-sharded with the data axis
        "state": None,              # SSM/RWKV recurrent state feature dims
        "cache_seq": None,          # KV-cache sequence dim (SP decode shards this)
        "conv": None,
        # fallback: shard the attention query sequence over `model` when the head
        # count cannot divide it (e.g. 56 or 14 heads on a 16-way axis) — context-
        # parallel attention instead of replicated scores. Resolved AFTER `heads`
        # (see _PRIORITY in logical_to_spec).
        "seq_attn": "model",
    }
    base.update(kw)
    return base


RULE_SETS: Dict[str, AxisRules] = {
    # Training: FSDP over data (weights sharded on their 'fsdp'-tagged dim) + TP over
    # model. The paper-faithful baseline for big archs.
    "train_fsdp": _rules(fsdp=("pod", "data")),
    # Training without FSDP (small archs where replicated weights are cheaper than
    # per-layer all-gathers).
    "train_dp": _rules(),
    # Training with Megatron-style sequence parallelism: residual stream sequence-
    # sharded over the model axis between blocks (activation-memory hillclimb).
    "train_fsdp_sp": _rules(fsdp=("pod", "data"), seq="model"),
    # Small archs: pure data parallelism over EVERY mesh axis (model axis carries
    # batch, weights replicated) — TP would replicate tiny head counts anyway.
    "train_dp_all": _rules(
        batch=("pod", "data", "model"), heads=None, kv_heads=None, ff=None,
        vocab=None, experts=None,
    ),
    # ZeRO-1 companion to train_dp_all: optimizer state sharded over all axes on the
    # fsdp-tagged dims; params/grads stay replicated, update all-gathers params.
    "train_zero1": _rules(
        batch=("pod", "data", "model"), heads=None, kv_heads=None, ff=None,
        vocab=None, experts=None, fsdp=("pod", "data", "model"),
    ),
    # Serving: pure TP, weights replicated over data, batch over data. The KV cache
    # seq dim shards over `model` when kv_heads cannot (GQA K < tp).
    "serve_tp": _rules(cache_seq="model"),
    # Serving for models too big for TP-only: weights also sharded over data.
    "serve_fsdp_tp": _rules(fsdp=("pod", "data"), cache_seq="model"),
    # MoE serving without per-layer weight gathers: expert weights shard their ff
    # dim over data (TP-within-expert, moe_impl="ep_ff"); dense weights replicate
    # over data (they are small once heads/ff shard over model).
    "serve_moe_eptp": _rules(expert_ff=("pod", "data"), cache_seq="model"),
    # Long-context decode: KV cache sequence-sharded over the data axis
    # (flash-decoding style), batch replicated (batch=1 cells).
    "serve_sp_cache": _rules(batch=None, cache_seq=("pod", "data")),
}


# --------------------------------------------------------------------------- context
@contextlib.contextmanager
def axis_rules(mesh, rules: Union[str, AxisRules, None]):
    """Activate (mesh, rules) for model code in this thread.

    On a mesh with a ``DeviceMesh`` the context also lets plain tensors meet
    DTensors as replicated ones (DTensor's ``implicit_replication``): model
    code makes index, mask and RoPE tensors from shapes alone, the same on
    every rank."""
    if isinstance(rules, str):
        rules = RULE_SETS[rules]
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, rules)
    try:
        if getattr(mesh, "device_mesh", None) is not None:
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _state.ctx = prev


def current_mesh():
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def current_rules() -> Optional[AxisRules]:
    ctx = getattr(_state, "ctx", None)
    return ctx[1] if ctx else None


@contextlib.contextmanager
def mesh_context(mesh, rules: Union[str, AxisRules] = "train_fsdp"):
    """Activate the axis rules on `mesh`. A ``DeviceMesh`` needs no global
    activation, as the reference's ``with mesh`` gives a JAX mesh."""
    with axis_rules(mesh, rules):
        yield


# --------------------------------------------------------------------------- resolution
def logical_to_spec(
    logical: Sequence[Optional[str]],
    rules: Optional[AxisRules] = None,
    mesh=None,
    shape: Optional[Sequence[int]] = None,
    priority: Optional[Sequence[str]] = None,
) -> P:
    """Resolve a tuple of logical axis names to a PartitionSpec on the current mesh.

    Mesh axes named by a rule but absent from the mesh are dropped (so the same rule
    set serves the single-pod and multi-pod meshes). A mesh axis may shard at most one
    tensor dim; later duplicates resolve to replicated. When `shape` is given, axes
    that do not divide the dim are dropped (e.g. kv_heads=8 on a 16-way model axis
    falls back to replicated KV — standard GQA TP behaviour).
    """
    rules = rules if rules is not None else (current_rules() or {})
    mesh = mesh if mesh is not None else current_mesh()
    mesh_axes = set(mesh.axis_names) if mesh is not None else None
    used: set = set()
    out: list = [None] * len(logical)

    def resolve(i: int, name: str) -> None:
        target: MeshAxes = rules.get(name)
        if isinstance(target, str):
            target = (target,)
        if not target:
            return
        picked = []
        dim = shape[i] if shape is not None and i < len(shape) else None
        for a in target:
            if mesh_axes is not None and a not in mesh_axes:
                continue
            if a in used:
                continue
            if dim is not None and mesh is not None:
                size = mesh.shape[a]
                if dim % (size * _prod(mesh.shape[b] for b in picked)) != 0:
                    continue
            picked.append(a)
        used.update(picked)
        if len(picked) == 1:
            out[i] = picked[0]
        elif picked:
            out[i] = tuple(picked)

    # two passes: model-owning axes claim mesh axes before positional fallbacks
    # (seq_attn/cache_seq only take `model` if heads could not). A caller-supplied
    # `priority` promotes named axes to resolve FIRST (e.g. decode attention keeps
    # the cache sequence sharding through the score computation).
    low_priority = {"seq_attn", "cache_seq"} - set(priority or ())
    for name in priority or ():
        for i, n in enumerate(logical):
            if n == name:
                resolve(i, n)
    for i, name in enumerate(logical):
        if name is not None and name not in low_priority and name not in (priority or ()):
            resolve(i, name)
    for i, name in enumerate(logical):
        if name is not None and name in low_priority:
            resolve(i, name)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _prod(it) -> int:
    r = 1
    for v in it:
        r *= v
    return r


def spec_to_placements(spec: Sequence[MeshAxes], mesh, ndim: int) -> List:
    """DTensor placements of a PartitionSpec: for each mesh dim ``a``,
    ``Shard(i)`` where `a` appears in entry `i` of `spec`, else
    ``Replicate()``. A mesh dim of extent 1 splits nothing and is
    ``Replicate()`` whatever the spec says (DTensor restricts the views of a
    sharded dim even where the shard is the whole).

    DTensor splits a tensor dim sharded over several mesh dims in mesh-dim
    order, major to minor; JAX splits it in the entry's order. The two lay
    the tensor out alike only when the entry follows the mesh's order (as
    every rule set does), so another order raises."""
    if len(spec) > ndim:
        raise ValueError(f"spec {tuple(spec)} has more entries than {ndim} dims")
    names = tuple(mesh.axis_names)
    dim_of: Dict[str, int] = {}
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(
                f"joint sharding {axes} of dim {i} does not follow the mesh's axis "
                f"order {names}; DTensor would lay it out differently from the spec")
        for a in axes:
            dim_of[a] = i
    return [Shard(dim_of[a]) if a in dim_of and mesh.shape[a] > 1 else Replicate()
            for a in names]


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]],
              priority: Optional[Sequence[str]] = None) -> torch.Tensor:
    """Apply a logical sharding constraint: a DTensor inside an ``axis_rules``
    context is redistributed to the resolved placements. A plain tensor, or
    any tensor outside a context, comes back as it is (the reference's
    constraint is a no-op without a mesh)."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_spec(logical, rules, mesh, x.shape, priority)
    placements = spec_to_placements(spec, mesh, x.ndim)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh.device_mesh, placements)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The port's ``jax.sharding.NamedSharding``: a mesh, a PartitionSpec and
    the memory kind the placed tensor lives in (None: the device)."""

    mesh: object
    spec: P
    memory_kind: Optional[str] = None

    def placements(self, ndim: int) -> List:
        return spec_to_placements(self.spec, self.mesh, ndim)


def named_sharding(
    logical: Sequence[Optional[str]],
    mesh=None,
    rules: Union[str, AxisRules, None] = None,
    memory_kind: Optional[str] = None,
    shape: Optional[Sequence[int]] = None,
) -> NamedSharding:
    """Build a NamedSharding for a logical-axis tuple (for in/out placements)."""
    if isinstance(rules, str):
        rules = RULE_SETS[rules]
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("named_sharding requires a mesh (argument or context)")
    spec = logical_to_spec(logical, rules, mesh, shape)
    if memory_kind is None:
        return NamedSharding(mesh, spec)
    from repro_torch.core.offload import resolve_memory_kind

    return NamedSharding(mesh, spec,
                         memory_kind=resolve_memory_kind(memory_kind,
                                                         getattr(mesh, "device_type", "cuda")))


def local_block(x: torch.Tensor, device_mesh, placements: Sequence) -> torch.Tensor:
    """This rank's block of the full tensor `x` under `placements` on
    `device_mesh`: a tensor dim sharded over several mesh dims is cut in
    mesh-dim order, as DTensor lays it out."""
    coord = device_mesh.get_coordinate()
    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = device_mesh.size(mesh_dim)
            d = pl.dim
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide over {n}")
            size = x.shape[d] // n
            x = x.narrow(d, coord[mesh_dim] * size, size)
    return x


def _in_tier(local: torch.Tensor, memory_kind: Optional[str], device) -> torch.Tensor:
    from repro_torch.core.offload import HOST, to_tier

    if local.is_meta:                     # shapes only (the dry run): nothing to place
        return local
    if memory_kind == HOST:
        return to_tier(local, HOST, device)
    return local.clone(memory_format=torch.contiguous_format)   # never a view of x


def _from_local(local: torch.Tensor, device_mesh, placements, shape, stride) -> DTensor:
    """``DTensor.from_local`` that keeps `local` where it is: ``from_local``
    moves a shard onto the mesh's device type, and a host-tier shard of a
    card's mesh must stay in pinned host memory."""
    if local.device.type == device_mesh.device_type or local.is_meta:
        return DTensor.from_local(local, device_mesh, placements, run_check=False,
                                  shape=shape, stride=stride)
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta

    spec = DTensorSpec(device_mesh, tuple(placements),
                       tensor_meta=TensorMeta(torch.Size(shape), tuple(stride), local.dtype))
    return DTensor(local, spec, requires_grad=False)


def device_put(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """The port's ``jax.device_put(x, sharding)``. A plain `x` is the full
    tensor, which every rank holds (as after a seeded init or a checkpoint
    read): the DTensor's local shard is this rank's block of it, cut with no
    collective. A DTensor `x` is redistributed. The shard lives in pinned
    host memory when the sharding's memory kind is ``pinned_host``; a meta
    `x` gives a meta shard (shapes only)."""
    dm = sharding.mesh.device_mesh
    placements = sharding.placements(x.ndim)
    if isinstance(x, DTensor):
        if tuple(x.placements) != tuple(placements):
            x = x.redistribute(dm, placements)
        local = x.to_local()
        shape, stride = x.shape, x.stride()
        dev = local.device if not local.is_pinned() else torch.device(dm.device_type)
    else:
        local = local_block(x, dm, placements)
        shape, stride, dev = x.shape, x.contiguous().stride(), x.device
    local = _in_tier(local, sharding.memory_kind, dev)
    return _from_local(local, dm, placements, shape, stride)


def place_like(x: torch.Tensor, template: DTensor) -> DTensor:
    """The full tensor `x` placed as `template` is: its mesh, its placements,
    and its shard's memory (pinned host memory where the template's is)."""
    local = local_block(x, template.device_mesh, template.placements)
    t_local = template.to_local()
    if t_local.is_pinned():
        local = local.contiguous().pin_memory()
    else:
        local = local.to(t_local.device).clone(memory_format=torch.contiguous_format)
    return _from_local(local, template.device_mesh, template.placements, x.shape,
                       x.contiguous().stride())


def full_tensor(x: DTensor) -> torch.Tensor:
    """The whole of DTensor `x`, gathered on every rank (a collective); a shard
    held in host memory crosses to the mesh's device for the gather first."""
    local = x.to_local()
    dev = torch.device(x.device_mesh.device_type)
    if local.device.type != dev.type:
        x = DTensor.from_local(local.to(dev), x.device_mesh, x.placements,
                               run_check=False, shape=x.shape, stride=x.stride())
    return x.full_tensor()


def gather_fsdp(tree):
    """`tree`'s DTensor parameters gathered over the mesh axes the ``fsdp`` rule
    names, their other shardings kept: the per-layer weight all-gather of
    FSDP, which GSPMD inserts where the reference uses an fsdp-sharded weight.
    Outside a context, or for plain tensors, the tree comes back unchanged."""
    mesh, rules = current_mesh(), current_rules()
    target = (rules or {}).get("fsdp")
    if mesh is None or not target:
        return tree
    axes = {target} if isinstance(target, str) else set(target)
    gather = [a in axes for a in mesh.axis_names]

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if not isinstance(x, DTensor):
            return x
        placements = [Replicate() if g and isinstance(pl, Shard) else pl
                      for g, pl in zip(gather, x.placements, strict=True)]
        if tuple(placements) == tuple(x.placements):
            return x
        return x.redistribute(mesh.device_mesh, placements)

    return one(tree)


# --------------------------------------------------------------------------- local blocks
def shard_dims(x: DTensor, mesh) -> Dict[str, int]:
    """{mesh axis: tensor dim} for each mesh axis that shards `x`."""
    return {a: pl.dim for a, pl in zip(mesh.axis_names, x.placements, strict=True)
            if isinstance(pl, Shard)}


def _placements(mesh, dims) -> List:
    """Placements with ``Shard(d)`` on each mesh axis `dims` maps to d."""
    return [Shard(dims[a]) if a in dims else Replicate() for a in mesh.axis_names]


def local_in(x, mesh, dims, grad_partial=()) -> torch.Tensor:
    """The local block of `x` laid out as `dims` ({mesh axis: tensor dim}), as
    a ``shard_map`` in_spec hands it to its body (the ops DTensor has no
    sharding rule for run on such blocks). Its gradient is summed over the
    mesh axes in `grad_partial`: the ranks along them use the same block for
    different parts of the result. A plain tensor counts as replicated."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh.device_mesh,
                               [Replicate()] * len(mesh.axis_names), run_check=False)
    x = x.redistribute(mesh.device_mesh, _placements(mesh, dims))
    grad = [Partial() if a in grad_partial else pl
            for a, pl in zip(mesh.axis_names, x.placements, strict=True)]
    return x.to_local(grad_placements=grad)


def global_out(t: torch.Tensor, mesh, dims, reduce_axes=(), mean: bool = False) -> DTensor:
    """The shard_map out_spec: the local result `t`, laid out as `dims`,
    summed (``psum``) or, with `mean`, averaged (``pmean``, a sum of ``t / n``)
    over `reduce_axes`: DTensor's ``Partial -> Replicate``, whose backward
    hands each rank the replicated gradient."""
    if mean:
        t = t / math.prod(mesh.shape[a] for a in reduce_axes)
    placements = [Partial() if a in reduce_axes else pl
                  for a, pl in zip(mesh.axis_names, _placements(mesh, dims), strict=True)]
    d = DTensor.from_local(t, mesh.device_mesh, placements, run_check=False)
    return d.redistribute(mesh.device_mesh, _placements(mesh, dims))
