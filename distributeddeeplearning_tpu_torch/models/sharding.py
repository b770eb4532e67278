"""Logical-axis rules of the pjit engine (the port's copy of the JAX
package's ``models/sharding.py``) and the logical axes of every port
parameter.

The JAX models annotate each weight with logical axes
(``nn.with_logical_partitioning``); a rules table maps logical axes to
mesh axes. The port's modules carry no annotations, so
:func:`logical_axes` reads them off the parameter's name, in the port's
layout (a Dense ``weight`` is ``[out, in]``, flax's ``kernel`` ``[in,
out]``; a conv ``weight`` OIHW, flax's HWIO), as the JAX models declare
them: ``tok_embed`` ``(vocab, embed)``, ``pos_embed`` ``(None, seq,
embed)``, ``cls_token`` ``(None, None, embed)``, the patch conv's
kernel ``(None, None, None, embed)``, ``qkv`` ``(embed, heads)``,
``proj`` ``(heads, embed)``, ``fc1`` ``(embed, mlp)``, ``fc2`` ``(mlp,
embed)``, ViT's ``head`` ``(embed, classes)``, each Dense bias its
kernel's last axis, the pipeline head's ``proj`` ``(embed, vocab)``,
the MoE block's ``router`` ``(embed, expert)``, ``w1`` ``(expert, embed,
mlp)``, ``b1`` ``(expert, mlp)``, ``w2`` ``(expert, mlp, embed)`` and
``b2`` ``(expert, embed)`` (flax's layouts, which the port keeps);
LayerNorm, the patch conv's bias and every ResNet and EfficientNet
parameter carry none (replicated). :func:`flax_path` is the flax tree
path ``models/convert.py`` maps the name to.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

LOGICAL_RULES = (
    ("batch", ("replica", "data")),
    ("seq", None),  # sequence sharding is ring attention's (ENGINE=sp)
    ("embed", None),
    ("heads", "model"),
    ("head_dim", None),
    ("mlp", "model"),
    ("classes", None),
    ("vocab", None),
    ("expert", "expert"),
    ("act_embed", None),
)

DATA_PARALLEL_RULES = tuple(
    (name, ("replica", "data") if name == "batch" else None) for name, _ in LOGICAL_RULES
)

# FSDP / ZeRO-3: every annotated kernel's "embed" dim over the data
# axis (the batch's own); unannotated parameters stay replicated.
FSDP_RULES = tuple(
    (name, ("replica", "data") if name == "batch" else ("data" if name == "embed" else None))
    for name, _ in LOGICAL_RULES
)


def rules_table(name: str):
    """``"tp"`` (tensor parallel, the default), ``"fsdp"`` (weights
    over the data axis), ``"dp"`` (replicated but the batch)."""
    tables = {"tp": LOGICAL_RULES, "fsdp": FSDP_RULES, "dp": DATA_PARALLEL_RULES}
    if name not in tables:
        raise ValueError(f"unknown sharding rules {name!r}; use {sorted(tables)}")
    return tables[name]


def rules_for_mesh(mesh, rules=LOGICAL_RULES):
    """A rules table projected onto ``mesh``: a target axis the mesh
    lacks becomes replicated (one table serves every topology)."""
    present = set(mesh.axis_names)

    def project(target):
        if target is None:
            return None
        if isinstance(target, str):
            return target if target in present else None
        kept = tuple(a for a in target if a in present)
        return kept if kept else None

    return tuple((name, project(target)) for name, target in rules)


# The transformer families' Dense layers: flax kernel axes [in, out].
_DENSE_AXES = {
    "qkv": ("embed", "heads"),
    "proj": ("heads", "embed"),
    "fc1": ("embed", "mlp"),
    "fc2": ("mlp", "embed"),
}

# The MoE block's parameters (models/moe.py), in flax's layout.
_MOE_AXES = {
    "router": ("embed", "expert"),
    "w1": ("expert", "embed", "mlp"),
    "b1": ("expert", "mlp"),
    "w2": ("expert", "mlp", "embed"),
    "b2": ("expert", "embed"),
}


def logical_axes(name: str, ndim: int, family: str = "transformer") -> Tuple[Optional[str], ...]:
    """The logical axes of port parameter ``name`` (rank ``ndim``) in
    the port's layout; ``family`` ``"transformer"`` (LM, ViT, the
    pipeline LM's parts) or ``"conv"`` (ResNet, EfficientNet: none)."""
    none = (None,) * ndim
    if family != "transformer":
        return none
    parts = name.split(".")
    leaf = parts[-1]
    owner = parts[-2] if len(parts) > 1 else ""
    if leaf == "tok_embed":
        return ("vocab", "embed")
    if leaf == "pos_embed":
        return (None, "seq", "embed")
    if leaf == "cls_token":
        return (None, None, "embed")
    if owner == "moe" and leaf in _MOE_AXES:
        return _MOE_AXES[leaf]
    if owner == "patch_embed":
        return ("embed", None, None, None) if leaf == "weight" else none
    if owner in _DENSE_AXES or owner == "head":
        if owner == "head":  # ViT's classifier
            flax = ("embed", "classes")
        elif owner == "proj" and len(parts) >= 2 and parts[0] == "head":
            flax = ("embed", "vocab")  # the pipeline LM's untied head
        else:
            flax = _DENSE_AXES[owner]
        if leaf == "weight":
            return (flax[1], flax[0])
        if leaf == "bias":
            return (flax[1],)
    return none


_BLOCK = re.compile(r"^\d+$")


def flax_path(name: str) -> Tuple[str, ...]:
    """The flax tree path of port parameter ``name`` (transformer
    families), as ``models/convert.py`` maps it: ``blocks.<i>`` is
    ``block<i>`` (the pipeline stage's ``layers.<i>`` is ``layer<i>``),
    a LayerNorm ``weight`` is ``scale``, a Dense or conv ``weight`` is
    ``kernel``."""
    parts = name.split(".")
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p in ("blocks", "layers") and i + 1 < len(parts) and _BLOCK.match(parts[i + 1]):
            out.append(("block" if p == "blocks" else "layer") + parts[i + 1])
            i += 2
            continue
        out.append(p)
        i += 1
    if out[-1] == "weight":
        out[-1] = "scale" if out[-2].startswith("ln") else "kernel"
    return tuple(out)


def mesh_axes_of(name: str, ndim: int, rules, family: str = "transformer"):
    """Per dim of port parameter ``name``: the mesh axis (or tuple) the
    (projected) ``rules`` shard it over, or ``None``."""
    table = dict(rules)
    return tuple(None if ax is None else table.get(ax)
                 for ax in logical_axes(name, ndim, family))
