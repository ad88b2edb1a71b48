"""Logical-axis sharding rules (MaxText-style) for params & activations,
placed with DTensor.

Models annotate activations with *logical* names via ``constrain``; a
context-installed rule table maps logical names to mesh axes. With no
rules installed, or on a plain tensor, everything is a no-op, so the
single-device paths are untouched.

Mesh axes:
  pod    — slow inter-pod axis (pure data parallel)
  data   — intra-pod data parallel; doubles as the FSDP axis for params
  model  — tensor/expert parallel axis

``repro`` is single-controller GSPMD (``with_sharding_constraint`` on a
traced program); this port is SPMD: every rank runs the same eager
program on DTensors over a ``DeviceMesh``. A spec stays ``repro``'s
per-tensor-dim tuple of mesh-axis names (``P`` below), so the two
packages' specs compare leaf by leaf; ``NamedSharding.placements`` turns
it into one DTensor placement per mesh dim. A dim split over two axes
(``("pod", "data")``) is ``Shard(d)`` on both mesh dims: DTensor splits
in mesh-dim order, major to minor, as GSPMD splits ``P(("pod",
"data"))``; a tuple in the other order raises.

While rules are installed (``logical_rules``), plain tensors that meet
DTensors (positions, masks, rotary tables made inside the step) are
taken as replicated (DTensor's ``implicit_replication``): every rank
builds them alike, as GSPMD replicates an unannotated constant. Ops
that DTensor has no sharding rule for (``searchsorted``, ``index_add``
in MoE's dispatch) get a replicate-only rule here, and their callers
``constrain`` their inputs to replicated first.
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

_STATE = threading.local()

# logical name -> mesh axis (or tuple of axes); None = replicate
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "cache_seq": None,         # flipped to 'data' for long-context decode
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "expert": "model",
    "fsdp": "data",
    "expert_fsdp": "data",   # FSDP axis of expert weights (separable)
    "tp": "model",
    "state": None,
}


class P(tuple):
    """A partition spec: per tensor dim, None, a mesh-axis name or a
    tuple of names. A tuple, so it compares with ``jax``'s
    ``PartitionSpec`` entry by entry (``tuple(spec)``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def rules_for(mesh, *, shard_cache_seq: bool = False,
              fsdp: bool = True) -> Dict[str, Any]:
    """Rule table adapted to the mesh actually in use."""
    rules = dict(DEFAULT_RULES)
    axes = set(_axis_names(mesh)) if mesh is not None else set()
    if "pod" not in axes:
        rules["batch"] = "data" if "data" in axes else None
    if "model" not in axes:
        for k in ("heads", "kv_heads", "ff", "vocab", "expert", "tp"):
            rules[k] = None
    if "data" not in axes or not fsdp:
        rules["fsdp"] = None
        rules["expert_fsdp"] = None
    if shard_cache_seq and "data" in axes:
        rules["cache_seq"] = "data"
    return rules


_REGISTERED = False


def _register_missing_rules() -> None:
    """DTensor rules for ops that have none (once a process; DTensor's
    registry is process-wide): replicate-only for MoE's dispatch."""
    global _REGISTERED
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    @register_sharding(aten.searchsorted.Tensor)
    def _searchsorted(sorted_seq, values, **_kw):
        return [([Replicate()], [Replicate(), Replicate()])]

    @register_sharding([aten.index_add.default, aten.index_add_.default])
    def _index_add(x, dim, index, source, **_kw):
        return [([Replicate()],
                 [Replicate(), None, Replicate(), Replicate()])]

    # cumsum's gradient on the card flips: a dim not flipped may stay
    # sharded
    @register_sharding(aten.flip.default)
    def _flip(x, dims):
        nd = len(x.shape)
        flipped = {d % nd for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None]) for d in range(nd)
            if d not in flipped]

    _REGISTERED = True


@contextlib.contextmanager
def logical_rules(rules: Optional[Dict[str, Any]]):
    """Install ``rules`` for ``constrain`` (thread-local). With rules,
    plain tensors meeting DTensors count as replicated (see the module
    docstring)."""
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        if rules is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            _register_missing_rules()
            with implicit_replication():
                yield
    finally:
        _STATE.rules = prev


def current_rules() -> Optional[Dict[str, Any]]:
    return getattr(_STATE, "rules", None)


def spec_for(names: Sequence[Optional[str]],
             rules: Optional[Dict[str, Any]] = None) -> P:
    rules = rules if rules is not None else (current_rules() or {})
    return P(*(None if n is None else rules.get(n) for n in names))


def spec_placements(spec: Sequence, mesh) -> List:
    """One DTensor placement per mesh dim for ``spec``. Raises
    ``ValueError`` for an axis the mesh lacks, an axis used twice, or a
    dim split over axes out of the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = _axis_names(mesh)
    out: List = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = tuple(part) if isinstance(part, (tuple, list)) else (part,)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: mesh axes are {names}, "
                                 f"no {a!r}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} splits over {axes}, "
                             f"against the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 f"shards two dims")
            # a mesh axis of one rank lays the dim out as Replicate does
            # (DTensor's views refuse some reshapes of a Shard dim there)
            if mesh.shape[i] > 1:
                out[i] = Shard(d)
    return out


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""

    def __init__(self, mesh, spec: Sequence):
        self.mesh = mesh
        self.spec = P(*spec)

    @property
    def placements(self) -> List:
        return spec_placements(self.spec, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class _Constrain(torch.autograd.Function):
    """Redistribute to ``placements`` forward, and the gradient to the
    same placements backward: the transpose of GSPMD's sharding
    constraint is the same constraint on the cotangent. Without it the
    partial sums of a block's input gradient would ride the residual
    stream backward, and every matmul they meet would run unsharded."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if tuple(placements) == tuple(x.placements):
            return x.view_as(x)
        return _redistribute(x, placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(ctx.placements) != tuple(g.placements):
            g = _redistribute(g, ctx.placements)
        return g, None


def _redistribute(x, placements):
    # contiguous shards: DTensor views a shard by its global strides
    return x.redistribute(x.device_mesh, placements).contiguous()


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor (and its gradient) to the placements the
    installed rules give ``names``; a no-op on a plain tensor or without
    rules."""
    rules = current_rules()
    if rules is None or not _is_dtensor(x):
        return x
    if len(names) != x.ndim:
        raise ValueError(f"constrain: {len(names)} names for a "
                         f"{x.ndim}-d tensor")
    want = spec_placements(spec_for(names, rules), x.device_mesh)
    if x.requires_grad and torch.is_grad_enabled():
        return _Constrain.apply(x, want)
    if tuple(want) == tuple(x.placements):
        return x
    return _redistribute(x, want)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: DTensor views a
    gradient that leaves ``shard_map`` by its global strides."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def shard_map(fn, in_names: Sequence, out_names: Sequence,
              partial: Optional[str] = None):
    """``fn`` on each rank's shards (``jax``'s ``shard_map``): for math
    that is independent along the sharded dims (attention per sequence
    and head), so DTensor need not place each of its ops. ``in_names``
    has one tuple of logical names per argument (None: a non-tensor);
    ``out_names`` one per output of ``fn`` (a single tuple: one output).
    A logical name shards only where its mesh extent divides every dim
    that carries it, and the inputs are redistributed to that (gradients
    too); plain tensors count as replicated. The gradient of an input
    replicated along a mesh axis that shards another input is the sum
    of the ranks' (each computed a part). With ``partial`` ("sum" or
    "max"), ``fn`` reduces over its shard of the mesh axes that shard an
    input but not an output, and the outputs are that reduction over
    the ranks of those axes: each rank's result is stacked on a new
    leading dim sharded over them and reduced there (a DTensor partial
    placement would take the wrong gradient). Without rules, or with no
    DTensor among the arguments, ``fn`` runs as it is."""
    def call(*args):
        rules = current_rules()
        dts = [a for a in args if _is_dtensor(a)]
        if rules is None or not dts:
            return fn(*args)
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        mesh = dts[0].device_mesh
        dims: Dict[str, List[int]] = {}
        for a, names in zip(args, in_names):
            if names is not None:
                for d, n in zip(a.shape, names):
                    if n is not None:
                        dims.setdefault(n, []).append(d)
        keep = {n for n, ds in dims.items()
                if rules.get(n) is not None
                and all(d % _axis_size(mesh, rules[n]) == 0 for d in ds)}

        def placements(names):
            return spec_placements(
                spec_for([n if n in keep else None for n in names], rules),
                mesh)

        ins, in_pl = [], []
        for a, names in zip(args, in_names):
            if names is None:
                ins.append(a)
                in_pl.append(None)
                continue
            if not _is_dtensor(a):
                a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            ins.append(a)
            in_pl.append(placements(names))
        single = len(out_names) == 0 or not isinstance(out_names[0],
                                                      (tuple, list))
        outs = [out_names] if single else list(out_names)
        split = {i for pl in in_pl if pl is not None
                 for i, p in enumerate(pl) if not p.is_replicate()}
        reduced = split if partial is not None else set()

        def out_placements(names):
            out = placements(names)
            if partial is None:
                return out
            # the ranks' results stacked on a new dim 0
            return [Shard(0) if i in reduced and p.is_replicate()
                    else Shard(p.dim + 1) if isinstance(p, Shard) else p
                    for i, p in enumerate(out)]

        def local(*xs):
            out = fn(*(_ContiguousGrad.apply(x)
                       if isinstance(x, torch.Tensor) and x.requires_grad
                       else x for x in xs))
            if partial is None:
                return out
            return out[None] if single else tuple(o[None] for o in out)

        # an input replicated along a mesh axis that splits the work has
        # a partial gradient on each rank: their sum
        from torch.distributed.tensor import Partial
        grad_pl = tuple(
            None if pl is None else
            [Partial("sum") if i in split and p.is_replicate() else p
             for i, p in enumerate(pl)] for pl in in_pl)
        out_pl = tuple(out_placements(n) for n in outs)
        result = local_map(local, out_placements=out_pl[0] if single
                           else out_pl, in_placements=tuple(in_pl),
                           in_grad_placements=grad_pl, device_mesh=mesh,
                           redistribute_inputs=True)(*ins)
        if partial is None:
            return result
        reduce = {"sum": lambda t: t.sum(0),
                  "max": lambda t: t.amax(0)}[partial]
        return reduce(result) if single else \
            tuple(reduce(r) for r in result)
    return call


def unbind_layers(x: torch.Tensor) -> List[torch.Tensor]:
    """``x.unbind(0)`` for a stacked leaf (layers on dim 0). For a
    DTensor each layer keeps the stack's placements, its gradient too,
    so the stack of the layers' gradients is placed as the leaf is
    (else DTensor places each by the sizes, and the step's cost stops
    being linear in the depth)."""
    layers = list(x.unbind(0))
    if not _is_dtensor(x) or not (x.requires_grad and
                                  torch.is_grad_enabled()):
        return layers
    from torch.distributed.tensor import Shard
    if any(isinstance(p, Shard) and p.dim == 0 for p in x.placements):
        return layers
    want = [Shard(p.dim - 1) if isinstance(p, Shard) else p
            for p in x.placements]
    return [_Constrain.apply(layer, want) for layer in layers]


def placed_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` placed as ``ref`` is (a gradient as its parameter: partial
    sums over the data axis are reduced once, here, not at each use in
    the optimizer); a no-op on plain tensors."""
    if not (_is_dtensor(x) and _is_dtensor(ref)) or \
            tuple(x.placements) == tuple(ref.placements):
        return x
    return _redistribute(x, list(ref.placements))


def replicated(x: torch.Tensor) -> torch.Tensor:
    """``constrain`` to replicated on every mesh axis: the input of an
    op that has only a replicate rule."""
    return constrain(x, *([None] * x.ndim))


def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """The whole value of a DTensor (a collective), or ``x`` itself."""
    return x.full_tensor() if _is_dtensor(x) else x


# ----------------------------------------------------------------------
# Parameter specs by naming convention
# ----------------------------------------------------------------------

# key-name pattern -> logical axes per trailing dims (applied right-
# aligned; leading stacked-layer / expert dims handled separately).
_PARAM_PATTERNS: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # projections into the sharded dimension: (d_model, out_tp)
    (r"(w_q|w_kv?|w_v|w_gate|w_up|w_in|in_proj|w_dq|w_uq|w_ukv|qkv|"
     r"w_shared_gate|w_shared_up|lm_head(_\d+)?)$", ("fsdp", "tp")),
    # projections out of the sharded dimension: (in_tp, d_model)
    (r"(w_o|w_out|w_down|out_proj|w_shared_down)$", ("tp", "fsdp")),
    # embeddings: (vocab, d_model)
    (r"embed(_\d+)?$", ("tp", "fsdp")),
    # router: small, replicate
    (r"router$", (None, None)),
    # kv low-rank down-proj (d_model, small): shard only d_model
    (r"w_dkv$", ("fsdp", None)),
    # conv kernels (k, channels): shard channels
    (r"conv_w$", (None, "tp")),
    (r"(conv_b|dt_bias|a_log|d_skip)$", ("tp",)),
    # biases on tp outputs
    (r"(b_q|b_kv|b_v|b_in|b_gate|b_up)$", ("tp",)),
    (r"(b_o|b_out|b_down)$", (None,)),
    # per-head gates / recurrent weights (xlstm)
    (r"(w_ig|w_fg|w_og|b_ig|b_fg|b_og|r_.*)$", (None,)),
    # norms & everything small: replicate
    (r"(scale|bias)$", (None,)),
)


def _match_param(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    for pat, spec in _PARAM_PATTERNS:
        if re.search(pat, name):
            spec = tuple(spec)
            if len(spec) > ndim:
                spec = spec[-ndim:]
            if len(spec) < ndim:
                # leading dims: stacked layers (None) / experts ('expert')
                lead: Tuple[Optional[str], ...] = (None,) * (ndim - len(spec))
                spec = lead + spec
            return spec
    return (None,) * ndim


def _trees():
    # imported when called: the models import ``constrain`` from here
    from repro_torch.models import model
    return model


def _leaf_name(path: Tuple) -> str:
    """``repro``'s ``path[-1].key``: the last dict key on the path."""
    return str(path[-1]) if path and isinstance(path[-1], str) else ""


def param_logical_axes(params: Any, n_expert_hint: int = 0) -> Any:
    """Tree of logical-axis tuples matching ``params``.

    Heuristics: the final key name selects the trailing-dim rule;
    a leading dim equal to the expert count is tagged 'expert'
    (stacked-layer leading dims stay replicated).
    """
    def visit(path, leaf):
        axes = list(_match_param(_leaf_name(path), leaf.ndim))
        if n_expert_hint and leaf.ndim >= 3:
            # find the expert dim among leading dims; experts consume the
            # 'model' axis, so drop 'tp' from the matrix dims (a mesh
            # axis may appear only once per spec)
            for i in range(leaf.ndim - 2):
                if leaf.shape[i] == n_expert_hint and "expert" not in axes:
                    axes = [None if a == "tp" else
                            ("expert_fsdp" if a == "fsdp" else a)
                            for a in axes]
                    axes[i] = "expert"
                    break
        return tuple(axes)

    return _trees().tree_map_with_path(visit, params)


def param_specs(params: Any, rules: Dict[str, Any],
                n_expert_hint: int = 0) -> Any:
    axes = param_logical_axes(params, n_expert_hint)
    # walk ``params``'s structure: the axes tuples are its leaves
    return _trees().tree_map(lambda _, a: spec_for(a, rules), params, axes)


def param_shardings(params: Any, mesh, rules: Dict[str, Any],
                    n_expert_hint: int = 0) -> Any:
    specs = param_specs(params, rules, n_expert_hint)
    return _trees().tree_map(lambda _, s: NamedSharding(mesh, s), params,
                             specs)


def distribute_tree(tree: Any, shardings: Any) -> Any:
    """Each leaf of ``tree`` as a DTensor placed by the ``NamedSharding``
    at the same place in ``shardings`` (every rank holds the whole
    value; DTensor keeps each rank's shard)."""
    from torch.distributed.tensor import distribute_tensor

    def put(leaf, sh):
        return distribute_tensor(leaf, sh.mesh, sh.placements)

    return _trees().tree_map(put, tree, shardings)


def distribute_params(params: Any, mesh, rules: Dict[str, Any],
                      n_expert_hint: int = 0) -> Any:
    """``params`` on ``mesh`` as DTensors placed by the rules."""
    _register_missing_rules()
    return distribute_tree(
        params, param_shardings(params, mesh, rules, n_expert_hint))


# ----------------------------------------------------------------------
# Decode-state / batch specs (divisibility-safe)
# ----------------------------------------------------------------------

def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    names = _axis_names(mesh)
    shape = tuple(mesh.shape)
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= shape[names.index(a)]
        return out
    return shape[names.index(axis)]


def safe_spec(shape: Tuple[int, ...], names: Sequence[Optional[str]],
              mesh, rules: Dict[str, Any]) -> P:
    """spec_for, but drops any axis whose mesh extent does not divide
    the dim (guaranteed-even sharding)."""
    parts = []
    used: set = set()
    for dim, n in zip(shape, names):
        axis = rules.get(n) if n else None
        flat = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
        if axis is None or any(a in used for a in flat if a):
            parts.append(None)
            continue
        sz = _axis_size(mesh, axis)
        if sz > 1 and dim % sz == 0:
            parts.append(axis)
            used.update(a for a in flat if a)
        else:
            parts.append(None)
    return P(*parts)


def decode_state_specs(state: Any, mesh, rules: Dict[str, Any]) -> Any:
    """Shardings for the decode state tree (KV caches, SSM/xLSTM
    states), matched by leaf key name with divisibility fallbacks:
    KV caches prefer head sharding, then head_dim, then replicate."""
    def visit(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        nd = leaf.ndim

        def sp(*names):
            # right-align names onto the trailing dims (leading dims are
            # stacked-layer axes from the scanned segments)
            pad = (None,) * (nd - len(names))
            return NamedSharding(mesh, safe_spec(shape, pad + names, mesh,
                                                 rules))
        if name in ("k", "v"):                  # (B, W, KH, D)
            s = sp("batch", "cache_seq", "kv_heads", None)
            if s.spec[-2] is None:              # heads didn't divide
                s = sp("batch", "cache_seq", None, "tp")
            return s
        if name in ("c_kv", "k_rope"):          # (B, W, r)
            return sp("batch", "cache_seq", None)
        if name == "slot_pos":
            return sp("batch", "cache_seq")
        if name == "ssm":                       # (B, H, P, N)
            return sp("batch", "heads", None, None)
        if name == "conv":                      # (B, k-1, C)
            return sp("batch", None, "tp")
        if name == "c" and nd >= 4:             # mlstm (B, H, dqk, dv)
            return sp("batch", "heads", None, None)
        if name == "n" and nd >= 3:
            return sp("batch", "heads", None)
        if name == "m" and nd >= 2:
            return sp("batch", "heads")
        if name in ("c", "n", "h") and nd >= 2:  # slstm (B, D)
            return sp("batch", "tp")
        return sp(*([None] * nd))

    return _trees().tree_map_with_path(visit, state)


def batch_specs_sharding(batch: Any, mesh, rules: Dict[str, Any]) -> Any:
    def visit(path, leaf):
        names: Tuple[Optional[str], ...] = \
            ("batch",) + (None,) * (leaf.ndim - 1)
        return NamedSharding(mesh, safe_spec(tuple(leaf.shape), names,
                                             mesh, rules))
    return _trees().tree_map_with_path(visit, batch)
