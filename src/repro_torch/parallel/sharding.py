"""Logical-axis sharding rules (DP / TP / FSDP / EP / SP) on DTensor
placements: the port of ``repro/parallel/sharding.py``.

Params and activations carry *logical* axis names; a rules table maps them
to mesh axes per (arch, shape, mesh). Divisibility is checked: a logical
axis is only mapped onto a mesh axis when the dimension divides evenly
(e.g. whisper-tiny's 6 heads are replicated across a 16-way model axis,
and its MLP picks up the TP sharding instead). ``make_rules``, ``_fit``,
``padded_vocab`` and ``pspec`` are the reference's line for line; a mesh
is anything :func:`mesh_shape` reads, a plain ``{axis: size}`` dict
included, so the rules need no process group.

The reference's ``PartitionSpec`` is :class:`PSpec`, a tuple with the same
entries (``None``, an axis, a tuple of axes) and the same trailing-``None``
trim. :func:`placements` turns one into DTensor placements: tensor dim
``d`` sharded over mesh axes ``("pod", "data")`` is ``Shard(d)`` on both
mesh dims, pod first, as JAX's tuple orders them. ``constrain`` (the
reference's ``with_sharding_constraint``) is ``redistribute`` on a
DTensor and a no-op on a plain tensor, as the reference's is a no-op off a
mesh. :func:`on_mesh_of` puts a tensor the model made (positions, masks,
zeros) on the mesh of the DTensor it meets, replicated.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

Axes = Optional[Tuple[str, ...]]
Rules = Dict[str, Axes]


class PSpec(tuple):
    """``PartitionSpec``: one entry per tensor dim (``None``, a mesh axis,
    or a tuple of mesh axes), trailing ``None`` dropped."""

    def __new__(cls, *parts):
        parts = list(parts)
        while parts and parts[-1] is None:
            parts.pop()
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PSpec{tuple(self)!r}"


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size (the reference's ``Mesh.shape``) of a
    ``DeviceMesh``, of anything with a ``shape`` dict (``StageMesh``), or of
    a plain ``{axis: size}`` dict, which is returned as it is."""
    if isinstance(mesh, dict):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_size(mesh, axes: Axes) -> int:
    if not axes:
        return 1
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def _fit(mesh, dim: int, axes: Axes) -> Axes:
    """Return `axes` if `dim` divides their product, else None (replicate)."""
    if not axes:
        return None
    return tuple(axes) if dim % axis_size(mesh, axes) == 0 else None


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axes: ('pod','data') on the multi-pod mesh, ('data',) else."""
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def make_rules(mesh, cfg, shape=None, *, fsdp: Optional[bool] = None) -> Rules:
    """Build the logical->mesh table for one (arch, shape, mesh) cell."""
    dp = dp_axes(mesh)
    model = ("model",) if "model" in mesh_shape(mesh) else None
    use_fsdp = cfg.use_fsdp if fsdp is None else fsdp

    n_q = cfg.n_heads
    n_kv = cfg.n_kv_heads
    batch = shape.global_batch if shape is not None else None
    # KV-cache sequence sharding (SP/flash-decode style): used when the batch
    # can't cover the data axis (512k single-seq decode) and/or when the KV
    # heads don't divide the model axis (GQA kv<16: never replicate a 100GB+
    # cache across TP ranks — shard its time dimension instead).
    kv_axes: list = []
    if shape is not None and shape.kind == "decode":
        if batch is not None and batch % axis_size(mesh, dp) != 0:
            kv_axes += list(dp)
        if model and n_kv % axis_size(mesh, model) != 0:
            kv_axes += list(model)

    r: Rules = {
        # --- activations ---
        "batch": None if (batch is not None and batch % axis_size(mesh, dp)) else dp,
        "act_seq": None,
        "act_embed": None,
        "act_heads": _fit(mesh, n_q, model),
        "act_kv_heads": _fit(mesh, n_kv, model),
        "act_ffn": _fit(mesh, max(cfg.d_ff, 1), model),
        "kv_seq": (_fit(mesh, shape.seq_len, tuple(kv_axes))
                   if (kv_axes and shape is not None) else None),
        "act_experts": None,
        # --- params ---
        "embed": dp if use_fsdp else None,          # FSDP dim
        "q_heads": _fit(mesh, n_q, model),
        "kv_heads": _fit(mesh, n_kv, model),
        "head_dim": None,
        "ffn": _fit(mesh, max(cfg.d_ff, 1), model),
        "vocab": _fit(mesh, padded_vocab(cfg, mesh), model),
        "layers": None,
        "norm": None,
        "conv": None,
        "ssm_state": None,
        "ssm_heads": None,
        "ssm_inner": None,
    }

    if cfg.ssm is not None:
        d_in = cfg.ssm.d_inner(cfg.d_model)
        n_sh = d_in // cfg.ssm.head_dim
        r["ssm_heads"] = _fit(mesh, n_sh, model)
        r["ssm_inner"] = _fit(mesh, d_in, model) if r["ssm_heads"] is None else None

    if cfg.moe is not None:
        exp_axes = _fit(mesh, cfg.moe.num_experts, model)
        r["experts"] = exp_axes
        r["act_experts"] = exp_axes
        # EP when expert count divides; else TP inside each expert.
        r["ffn_exp"] = None if exp_axes else _fit(mesh, cfg.moe.d_ff_expert, model)
    else:
        r["experts"] = None
        r["ffn_exp"] = None
    return r


def padded_vocab(cfg, mesh=None) -> int:
    """Vocab padded so the `model` axis shards it evenly (multiple of 256);
    no mesh pads as the reference's 1×1 host mesh does."""
    if cfg.vocab == 0:
        return 0
    mult = 256
    if mesh is not None and "model" in mesh_shape(mesh):
        mult = math.lcm(256, mesh_shape(mesh)["model"])
    return ((cfg.vocab + mult - 1) // mult) * mult


def pspec(names: Sequence[Optional[str]], rules: Rules) -> PSpec:
    """Logical axis names -> PSpec under `rules`.

    Guards against the same mesh axis appearing twice in one spec (XLA error):
    later duplicates degrade to replication.
    """
    used: set = set()
    parts = []
    for n in names:
        axes = rules.get(n) if n else None
        if axes and not (set(axes) & used):
            used.update(axes)
            parts.append(axes[0] if len(axes) == 1 else tuple(axes))
        else:
            parts.append(None)
    return PSpec(*parts)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_pspecs(axes_tree, rules: Rules):
    """Map a tree (dicts, lists, tuples) of logical-axes tuples to PSpecs."""
    if _is_axes(axes_tree):
        return pspec(axes_tree, rules)
    if isinstance(axes_tree, dict):
        return {k: tree_pspecs(v, rules) for k, v in axes_tree.items()}
    return type(axes_tree)(tree_pspecs(v, rules) for v in axes_tree)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: PSpec, ndim: int):
    """DTensor placements of a rank-``ndim`` tensor under ``spec`` on a
    ``DeviceMesh``: per mesh dim ``Shard(d)`` where tensor dim ``d`` names
    that axis, else ``Replicate()``. A tensor dim over several mesh axes
    must name them in mesh order (major first), as the rules do."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than rank {ndim}")
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _entry_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shard_shape(shape, spec: PSpec, mesh) -> Tuple[int, ...]:
    """The per-device shape of a ``shape`` tensor under ``spec`` (the
    reference's ``NamedSharding(mesh, spec).shard_shape(shape)``); raises
    ``ValueError`` where a dim does not divide by its axes, as jit does."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = list(shape)
    for d, entry in enumerate(spec):
        n = axis_size(mesh, _entry_axes(entry))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} ({out[d]}) does not "
                             f"divide over {entry} ({n} shards)")
        out[d] //= n
    return tuple(out)


def local_shape_and_offset(shape, mesh, placements):
    """(this rank's local shape, its global offset) of a ``shape`` tensor
    laid out by ``placements`` on a ``DeviceMesh`` (read from the mesh's
    rank table, with a fake mode set aside)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():
        local, off = compute_local_shape_and_global_offset(
            tuple(shape), mesh, tuple(placements))
    return tuple(local), tuple(int(o) for o in off)


_DTENSOR = []      # the DTensor class, imported at first use


def _is_dtensor(x) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def constrain(x, mesh, names: Sequence[Optional[str]], rules: Rules):
    """``x`` laid out by logical ``names`` (the reference's
    ``with_sharding_constraint``): a DTensor is redistributed on its mesh,
    and so is its gradient in the backward pass (``_laid_out``); a plain
    tensor (no mesh) comes back as it is."""
    if not _is_dtensor(x):
        return x
    return _laid_out(x, placements(x.device_mesh, pspec(names, rules),
                                   x.ndim))


def _laid_out(x, pl):
    """``x`` redistributed to placements ``pl``, and its gradient too (a
    hook): the transpose of a sharding constraint constrains the
    cotangent alike, as JAX's does. Left to itself DTensor keeps a
    gradient as a partial sum and may gather a weight to multiply it."""
    pl = tuple(pl)
    mesh = x.device_mesh
    y = x if pl == tuple(x.placements) else x.redistribute(mesh, pl)
    if y.requires_grad:
        y.register_hook(lambda g: g if tuple(g.placements) == pl
                        else g.redistribute(mesh, pl))
    return y


def settle(x):
    """A DTensor's pending partial sums reduced (``Partial`` placements
    made ``Replicate``, its gradient's too); a plain tensor as it is.

    DTensor leaves a lookup into a sharded dim (the embedding on a
    vocab-sharded table) as a masked partial, which later ops cannot read,
    and a gradient that is itself a partial sum cannot be redistributed
    back to the masked partial, hence the reduced gradient. The CE's
    target logit, a sum over the sharded vocab, is settled too."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate
    return _laid_out(x, [Replicate() if isinstance(p, Partial) else p
                         for p in x.placements])


def gathered(x, dim: int):
    """``x`` with tensor dim ``dim`` whole on every rank (an all-gather on
    each mesh dim that shards it, FSDP's gather of a weight before use;
    its backward reduce-scatters the gradient); a plain tensor as it is."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_shard(dim) else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh,
                                                              pl)


def project(h, w):
    """``h @ w`` (h [..., d], w [d, n]). On a mesh, over every mesh dim
    of size > 1 where both operands are replicated (a projection whose
    heads do not divide the model axis, as GQA's k and v at 4 or 8 heads
    on 16), the contraction is split: h's last dim and w's first are
    taken as local slices, and the partial products are all-reduced.
    Each rank then does 1/n of the product instead of all of it, as XLA
    partitions such a projection. Plain tensors: ``h @ w``."""
    if not _is_dtensor(h):
        return h @ w
    from torch.distributed.tensor import Replicate, Shard
    mesh = h.device_mesh
    split = [i for i, (a, b) in enumerate(zip(h.placements, w.placements))
             if isinstance(a, Replicate) and isinstance(b, Replicate)
             and mesh.size(i) > 1]
    n = math.prod(mesh.size(i) for i in split)
    if not split or h.shape[-1] % n:
        return h @ w
    hp = [Shard(h.ndim - 1) if i in split else p
          for i, p in enumerate(h.placements)]
    wp = [Shard(0) if i in split else p for i, p in enumerate(w.placements)]
    y = h.redistribute(mesh, hp) @ w.redistribute(mesh, wp)
    return y.redistribute(mesh, [Replicate() if i in split else p
                                 for i, p in enumerate(y.placements)])


def on_mesh_of(t, like):
    """``t`` (a tensor the model made) as a replicated DTensor on the mesh
    of ``like`` when ``like`` is a DTensor and ``t`` is not; else ``t``."""
    if not _is_dtensor(like) or _is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    m = like.device_mesh
    return DTensor.from_local(t, m, [Replicate()] * m.ndim, run_check=False)
