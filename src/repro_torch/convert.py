"""Carries parameters, optimizer states and caches between the JAX package's
trees and the port's modules: neither side imports the other.

The JAX tree stacks the layers on a leading axis (``layers.ln1`` is
``(L, d)``, ``layers.attn.wq`` is ``(L, d, h*hd)``, ``dense_ffn.wg`` is
``(L, d, d_ff)``; for mamba2 and zamba2 ``layers.wz`` is ``(L, d,
d_inner)``; seamless stacks ``encoder.*`` and ``decoder.*``); the port's
state dict has one entry per layer (``layers.3.attn.wq``, ``layers.3.wz``,
``decoder.3.cross_attn.wq``). zamba2's one ``shared_attn`` tree and the
unstacked leaves (``embed``, ``ln_f``, ``ln_enc``, ``head``) keep their
dotted names. A MoE transformer groups its layers in super-blocks of
``moe_every``: the MoE sits at the last position of each, ``moe.*`` stacked
over the ``nb`` super-blocks, and the dense FFNs of the other positions are
``dense_ffn.*`` stacked ``nb * (moe_every - 1)`` (none when ``moe_every`` is
1). Layer ``b * moe_every + j`` of the port takes ``moe.*[b]`` as its
``moe.*`` when ``j`` is the last position, else ``dense_ffn.*[b *
(moe_every - 1) + j]`` as its ``ffn.*``. Matrices keep their ``(d_in,
d_out)`` layout, so the conversion is a copy. The DLRM's tree has no stacked
layers: its MLPs are lists, whose entries become ``bottom.0.w`` and so on.

``from_jax_*`` take trees of numpy arrays or tensors (a tensor's slices are
views of it); ``to_jax_*`` return trees of tensors, each stacked leaf a new
tensor on the state's device (or, with ``stack=checkpoint.Stacked``, the
layers' own tensors, unstacked) and each other leaf the state's own tensor
(detached). ``to_jax_train_state`` / ``load_jax_train_state`` carry the
port's train state ``{"model", "params", "opt"}`` to the reference's
``{"params", "opt": {"m", "v", "step"[, "master"]}}`` and back; the
checkpointer saves that tree, so a checkpoint is the same files whichever
package wrote it.

``from_jax_stage``, ``from_jax_env``, ``from_jax_cluster`` and
``from_jax_placement`` carry the analytic evaluator's inputs (a lowered
``CompiledStage``; a ``(NodeConfig, topology)`` environment; a
``ClusterConfig``, ``ClusterSpec`` or ``PodSpec``; a placement) over to the
port's classes, field for field, so that the port's engine and study runner
can be held to the reference's on identical inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cluster, compiled, placement, topology
from repro_torch.models.transformer import is_moe_layer

_TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")
_FAMILIES = _TRANSFORMER_FAMILIES + ("ssm", "hybrid", "encdec")
# The stacks of each family other than the transformer's: (tree name, layers)
_STACKS = {"ssm": lambda cfg: (("layers", cfg.num_layers),),
           "hybrid": lambda cfg: (("layers", cfg.num_layers),),
           "encdec": lambda cfg: (("encoder", cfg.encdec.encoder_layers),
                                  ("decoder", cfg.encdec.decoder_layers))}


def _to_tensor(arr) -> torch.Tensor:
    """numpy -> torch, bfloat16 included: numpy knows bf16 only as an
    extension type, so its 16 bits are reinterpreted. A tensor is taken as
    it is."""
    if torch.is_tensor(arr):
        return arr
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _leaves(tree: Mapping, prefix: str = ""):
    """(dotted name, leaf) of a nested dict, in its own order."""
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def _nest(flat: Mapping[str, object]) -> dict:
    """{"a.b": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for name, value in flat.items():
        *path, last = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[last] = value
    return out


def _moe_slot(cfg: ModelConfig, i: int):
    """Layer ``i``'s FFN in the JAX tree: ("moe", super-block) or
    ("dense_ffn", its index in the dense stack)."""
    if cfg.moe is None:
        return "dense_ffn", i
    b, j = divmod(i, cfg.moe.moe_every)
    if is_moe_layer(cfg, i):
        return "moe", b
    return "dense_ffn", b * (cfg.moe.moe_every - 1) + j


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def reference_leaf(cfg: ModelConfig, name: str
                   ) -> Tuple[Tuple[str, ...], Optional[Tuple[int, int]]]:
    """Where one of the port's parameters lies in the JAX package's tree:
    its path there, and, for a layer's leaf, (the stack's length, the
    layer's index in it); None for a leaf that is not stacked.
    ``layers.3.attn.wq`` -> (("layers", "attn", "wq"), (L, 3))."""
    _check_family(cfg)
    top, *rest = name.split(".")
    if cfg.family in _STACKS:
        stacks = dict(_STACKS[cfg.family](cfg))
        if top in stacks:
            return (top, *rest[1:]), (stacks[top], int(rest[0]))
        return tuple(name.split(".")), None
    if top != "layers":
        return (top, *rest), None
    i, sub, *leaf = rest
    i = int(i)
    if sub in ("ln1", "ln2"):
        return ("layers", sub), (cfg.num_layers, i)
    if sub == "attn":
        return ("layers", "attn", *leaf), (cfg.num_layers, i)
    group, k = _moe_slot(cfg, i)
    every = range(cfg.num_layers)
    n = sum(1 for j in every if _moe_slot(cfg, j)[0] == group)
    return (group, *leaf), (n, k)


def from_jax_params(params: Mapping, cfg: ModelConfig
                    ) -> Dict[str, torch.Tensor]:
    """Nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` of
    any JAX model but the DLRM) -> a state dict for ``load_state_dict`` of
    the model ``get_model(cfg)`` builds."""
    _check_family(cfg)
    if cfg.family in _STACKS:
        stacks = dict(_STACKS[cfg.family](cfg))
        state = {}
        for top, tree in params.items():
            if top in stacks:
                for name, stacked in _leaves(tree):
                    for i in range(stacks[top]):
                        state[f"{top}.{i}.{name}"] = _to_tensor(stacked[i])
            elif isinstance(tree, Mapping):
                for name, leaf in _leaves(tree, f"{top}."):
                    state[name] = _to_tensor(leaf)
            else:
                state[top] = _to_tensor(tree)
        return state
    state = {"embed": _to_tensor(params["embed"]),
             "ln_f": _to_tensor(params["ln_f"])}
    if "head" in params:
        state["head"] = _to_tensor(params["head"])
    layers = params["layers"]
    for i in range(cfg.num_layers):
        state[f"layers.{i}.ln1"] = _to_tensor(layers["ln1"][i])
        state[f"layers.{i}.ln2"] = _to_tensor(layers["ln2"][i])
        for name, stacked in layers["attn"].items():
            state[f"layers.{i}.attn.{name}"] = _to_tensor(stacked[i])
        group, k = _moe_slot(cfg, i)
        sub = "moe" if group == "moe" else "ffn"
        for name, stacked in _leaves(params[group]):
            state[f"layers.{i}.{sub}.{name}"] = _to_tensor(stacked[k])
    return state


def to_jax_params(state_dict: Mapping[str, torch.Tensor], cfg: ModelConfig,
                  stack: Callable = torch.stack) -> dict:
    """The inverse of ``from_jax_params``: the port's state dict (or any
    dict keyed by its parameter names, such as an optimizer moment) -> the
    JAX package's tree, the layers stacked by ``stack`` (a list of the
    layers' tensors -> the leaf; ``checkpoint.Stacked`` keeps them
    unstacked for the checkpointer)."""
    _check_family(cfg)
    sd = {k: v.detach() for k, v in state_dict.items()}

    def stacked_leaf(names: List[str]):
        return stack([sd[n] for n in names])

    def stacked(layers: List[int], sub: str) -> dict:
        """Every leaf under ``layers.{i}.{sub}`` stacked over ``layers``."""
        head = f"layers.{layers[0]}.{sub}"
        names = [k[len(head):] for k in sd if k.startswith(head)]
        return _nest({n: stacked_leaf([f"layers.{i}.{sub}{n}"
                                       for i in layers])
                      for n in names})

    if cfg.family in _STACKS:
        stacks = dict(_STACKS[cfg.family](cfg))
        tree = _nest({k: v for k, v in sd.items()
                      if k.split(".", 1)[0] not in stacks})
        for top, n in stacks.items():
            head = f"{top}.0."
            names = [k[len(head):] for k in sd if k.startswith(head)]
            tree[top] = _nest({name: stacked_leaf(
                [f"{top}.{i}.{name}" for i in range(n)]) for name in names})
        return tree
    tree = {"embed": sd["embed"], "ln_f": sd["ln_f"]}
    if "head" in sd:
        tree["head"] = sd["head"]
    every = list(range(cfg.num_layers))
    tree["layers"] = {"ln1": stacked_leaf([f"layers.{i}.ln1" for i in every]),
                      "ln2": stacked_leaf([f"layers.{i}.ln2" for i in every]),
                      "attn": stacked(every, "attn.")}
    dense = [i for i in every if _moe_slot(cfg, i)[0] == "dense_ffn"]
    moe = [i for i in every if _moe_slot(cfg, i)[0] == "moe"]
    if dense:
        tree["dense_ffn"] = stacked(dense, "ffn.")
    if moe:
        tree["moe"] = stacked(moe, "moe.")
    return tree


def from_jax_dlrm_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX DLRM's tree of numpy arrays (``tables`` and the lists
    ``bottom`` / ``top`` of ``{w, b}``) -> a state dict for ``DLRM``."""
    state = {"tables": _to_tensor(params["tables"])}
    for mlp in ("bottom", "top"):
        for i, layer in enumerate(params[mlp]):
            for name in ("w", "b"):
                state[f"{mlp}.{i}.{name}"] = _to_tensor(layer[name])
    return state


def to_jax_dlrm_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of ``from_jax_dlrm_params``."""
    sd = {k: v.detach() for k, v in state_dict.items()}
    tree = {"tables": sd["tables"]}
    for mlp in ("bottom", "top"):
        n = sum(1 for k in sd if k.startswith(f"{mlp}.") and k.endswith(".w"))
        tree[mlp] = [{name: sd[f"{mlp}.{i}.{name}"] for name in ("w", "b")}
                     for i in range(n)]
    return tree


def _converters(model, stack: Callable = torch.stack) -> tuple:
    """(to JAX tree, from JAX tree) for the model's parameter names."""
    cfg = model.cfg
    if isinstance(cfg, ModelConfig):
        return (lambda sd: to_jax_params(sd, cfg, stack),
                lambda tree: from_jax_params(tree, cfg))
    return to_jax_dlrm_params, from_jax_dlrm_params


_PARAM_TREES = ("m", "v", "master")


def to_jax_train_state(state: Mapping, stack: Callable = torch.stack
                       ) -> dict:
    """The port's train state -> the JAX package's tree: ``params``, and the
    optimizer's ``m``, ``v`` (and ``master``) in the params' layout, beside
    its ``step``. ``stack`` as in ``to_jax_params``."""
    to_tree, _ = _converters(state["model"], stack)
    opt = state["opt"]
    out_opt = {k: to_tree(opt[k]) for k in _PARAM_TREES if k in opt}
    out_opt["step"] = opt["step"]
    return {"params": to_tree(state["params"]), "opt": out_opt}


def _copy_into(dst: torch.Tensor, src) -> None:
    src = _to_tensor(src)
    if src.data_ptr() == dst.data_ptr() and src.stride() == dst.stride():
        return                       # the state's own tensor, already there
    dst.copy_(src)


@torch.no_grad()
def load_jax_train_state(state: Mapping, tree: Mapping) -> None:
    """Copy a JAX-layout train state (tensors or numpy arrays) into the
    port's train state IN PLACE: the parameters stay the model's own."""
    _, from_tree = _converters(state["model"])
    opt = state["opt"]
    pairs = [(state["params"], tree["params"])]
    pairs += [(opt[k], tree["opt"][k]) for k in _PARAM_TREES if k in opt]
    for dst, src_tree in pairs:
        src = from_tree(src_tree)
        for name, t in dst.items():
            _copy_into(t, src[name])
    _copy_into(opt["step"], tree["opt"]["step"])


def cache_to_numpy(cache: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's cache as numpy arrays in the JAX package's layout (dense:
    ``k``/``v`` (L, b, S, hkv, d); mamba2: ``conv`` (L, b, width - 1,
    conv_ch), ``ssm`` (L, b, h, p, n), and zamba2's ``attn_k``/``attn_v``
    (n_groups, b, S, hkv, d); seamless: ``self_k``/``self_v`` (L, b, S,
    hkv, d), ``cross_k``/``cross_v`` (L, b, src, hkv, d); ``pos`` (b,));
    bf16 widens to fp32.
    The arrays are copies: the port updates its cache in place, so a view
    would change under the caller at the next decode step."""
    out = {}
    for name, t in cache.items():
        t = t.detach().cpu()
        out[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return out


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _copy_field(value):
    return np.array(value, copy=True) if isinstance(value, np.ndarray) \
        else value


def from_jax_stage(stage) -> compiled.CompiledStage:
    """A reference ``CompiledStage`` as the port's: every array copied with
    its dtype, the two passes as the port's ``CompiledPass``."""
    kw = {name: _copy_field(v) for name, v in _fields(stage).items()}
    for name in ("fwd", "bwd"):
        kw[name] = compiled.CompiledPass(
            **{k: _copy_field(v) for k, v in _fields(kw[name]).items()})
    return compiled.CompiledStage(**kw)


_TOPOLOGIES = {cls.__name__: cls for cls in (
    topology.HierarchicalSwitch, topology.Torus, topology.SingleSwitch)}


def _from_jax_topology(topo):
    """A topology of the three families becomes the port's class of the
    same name with the same fields; any other object implementing the
    protocol (or None) is its own counterpart and is passed through."""
    cls = _TOPOLOGIES.get(type(topo).__name__)
    return cls(**_fields(topo)) if cls is not None else topo


def from_jax_env(env) -> tuple:
    """A reference ``(NodeConfig, topology)`` as the port's."""
    node, topo = env
    return cluster.NodeConfig(**_fields(node)), _from_jax_topology(topo)


def from_jax_cluster(obj):
    """A reference ``ClusterConfig``, ``ClusterSpec`` or ``PodSpec`` as the
    port's class of the same name, with its node, topologies, pods and cost
    model carried over field for field."""
    kind = type(obj).__name__
    kw = _fields(obj)
    if kind == "PodSpec":
        kw["node"] = cluster.NodeConfig(**_fields(obj.node))
        kw["fabric"] = _from_jax_topology(obj.fabric)
        return cluster.PodSpec(**kw)
    if obj.cost is not None:
        kw["cost"] = cluster.CostModel(**_fields(obj.cost))
    if kind == "ClusterConfig":
        kw["node"] = cluster.NodeConfig(**_fields(obj.node))
        kw["topology"] = _from_jax_topology(obj.topology)
        return cluster.ClusterConfig(**kw)
    if kind == "ClusterSpec":
        kw["pods"] = tuple(from_jax_cluster(p) for p in obj.pods)
        kw["interconnect"] = _from_jax_topology(obj.interconnect)
        return cluster.ClusterSpec(**kw)
    raise TypeError(f"not a reference cluster: {kind}")


_PLACEMENTS = {cls.__name__: cls for cls in (
    placement.PaperPlacement, placement.EMAwarePlacement,
    placement.ExplicitPlacement)}


def from_jax_placement(pl):
    """A reference placement as the port's class of the same name (None
    stays None)."""
    if pl is None:
        return None
    return _PLACEMENTS[type(pl).__name__](**_fields(pl))
