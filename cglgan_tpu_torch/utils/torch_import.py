"""Import reference ``torch.save(net_g.state_dict())`` checkpoints.

Port of ``cglgan_tpu/utils/torch_import.py``.  Every reference trainer
saves its per-server generator as a raw torch ``state_dict`` at the end of
training (and every 5000 rounds for CAP/Mix/FeGAN) —
``CGLGAN/MNIST/main.py:191``, ``capgan.py:186-198``, ``fegan.py:174-181``,
``FLGAN/MNIST/flgan.py:233`` — and nothing in the reference ever loads one
back.  A user migrating here arrives with directories of those ``.pt``
files.  This module turns them into the port's ``(params, state)`` trees,
so that they can be sampled, scored (``tpufed-torch import-torch
--eval-dataset``), served (``tpufed-torch export``) or trained further
(``tpufed-torch run --init-from-torch``).

Design: the state dict is split into **module groups** (keys sharing
everything up to the last ``.weight``/``.bias``/``.running_*`` component,
in insertion order — torch preserves ``nn.Sequential`` definition order)
and each group is classified by shape: 2-D weight = Linear, 4-D = Conv2d,
a ``running_mean`` = BatchNorm.  The family is detected from the group
sequence (the first Linear's fan-in/out, ``paths.*`` head groups, convs)
and the groups are consumed in the zoo's construction order.  Conversions:
Linear weight transposed (torch ``(out, in)`` -> ours ``(in, out)``); Conv
OIHW kept; BN ``weight/bias/running_mean/running_var`` -> ``scale/bias``
params + ``mean/var`` state.

An imported generator is one member, unstacked: the layout of the FedAvg
family's shared G, and of one slot of a stacked G (multipath heads
``(k, ...)``).  ``Model.apply`` takes it with a leading member axis of 1.

Only generators are importable — the reference never saves a
discriminator.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from cglgan_tpu_torch.core import device as device_mod
from cglgan_tpu_torch.core import threefry
from cglgan_tpu_torch.models import zoo
from cglgan_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

# state_dict key leaves per group kind
_LEAVES = ("weight", "bias", "running_mean", "running_var",
           "num_batches_tracked")


class TorchImportError(ValueError):
    pass


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pt`` file into an ordered ``{key: tensor}`` on
    the host."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not hasattr(obj, "items"):
        raise TorchImportError(
            f"{path}: expected a state_dict, got {type(obj).__name__}")
    return {str(k): torch.as_tensor(v).detach() for k, v in obj.items()}


# ---------------------------------------------------------------------------
# grouping + classification
# ---------------------------------------------------------------------------

class _Group:
    def __init__(self, prefix: str):
        self.prefix = prefix
        self.tensors: Dict[str, torch.Tensor] = {}

    @property
    def kind(self) -> str:
        if "running_mean" in self.tensors:
            return "bn"
        w = self.tensors.get("weight")
        if w is None:
            raise TorchImportError(
                f"module {self.prefix!r} has no weight tensor")
        if w.ndim == 2:
            return "linear"
        if w.ndim == 4:
            return "conv"
        raise TorchImportError(
            f"module {self.prefix!r}: unsupported weight rank {w.ndim}")


def _groups(sd: Dict[str, torch.Tensor]) -> List[_Group]:
    groups: Dict[str, _Group] = {}
    order: List[_Group] = []
    for key, value in sd.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf not in _LEAVES:
            raise TorchImportError(f"unrecognised state_dict key {key!r}")
        if leaf == "num_batches_tracked":
            continue
        g = groups.get(prefix)
        if g is None:
            g = groups[prefix] = _Group(prefix)
            order.append(g)
        g.tensors[leaf] = value
    return order


def _split_paths(groups: List[_Group]) -> Tuple[List[_Group],
                                                List[List[_Group]]]:
    """Separate trunk groups from per-head groups (``paths.{i}.*``)."""
    trunk: List[_Group] = []
    heads: Dict[int, List[_Group]] = {}
    for g in groups:
        if g.prefix.startswith("paths."):
            idx = int(g.prefix.split(".")[1])
            heads.setdefault(idx, []).append(g)
        else:
            trunk.append(g)
    n = len(heads)
    if sorted(heads) != list(range(n)):
        raise TorchImportError(f"non-contiguous path indices {sorted(heads)}")
    return trunk, [heads[i] for i in range(n)]


# ---------------------------------------------------------------------------
# family detection
# ---------------------------------------------------------------------------

def detect_generator(sd: Dict[str, torch.Tensor]) -> Dict:
    """Infer ``{family, num_heads, img_shape}`` from a generator state_dict:
    conv presence, ``paths.*`` heads, the first Linear's dims and the final
    Linear's output size."""
    trunk, heads = _split_paths(_groups(sd))
    if not trunk:
        raise TorchImportError("empty state_dict")
    kinds = [g.kind for g in trunk]
    has_conv = "conv" in kinds or any(
        g.kind == "conv" for h in heads for g in h)
    n = len(heads)
    if has_conv:
        # every conv generator starts with the latent projection
        # (model/lsgan.py:7 `l1 = Linear(100, ...)`); a conv state_dict
        # that opens with a conv (or a non-100 fan-in linear) is the conv
        # DISCRIMINATOR
        first = trunk[0]
        if (first.kind != "linear"
                or first.tensors["weight"].shape[1] != 100):
            raise TorchImportError(
                f"conv state_dict opens with {first.kind} "
                f"{first.prefix!r}, not the latent Linear(100, ...) — is "
                "this a discriminator checkpoint? (the reference only "
                "saves net_g)")
        family = "conv-multipath" if heads else "conv"
        return {"family": family, "num_heads": max(n, 1),
                "img_shape": (1, 32, 32)}
    first = trunk[0]
    if first.kind != "linear":
        raise TorchImportError(
            f"first module {first.prefix!r} is {first.kind}, not linear")
    dout, din = first.tensors["weight"].shape
    if din != 100:
        raise TorchImportError(
            f"first linear fan-in {din} != latent 100 — is this a "
            "discriminator checkpoint? (the reference only saves net_g)")
    last = heads[0][-1] if heads else trunk[-1]
    out = last.tensors["weight"].shape[0]
    if out == 2:  # 2DMG families emit 2-D points
        if heads:
            return {"family": "2dmg-multipath", "num_heads": n,
                    "img_shape": (2,)}
        family = "2dmg-small" if dout == 32 else "2dmg-mlp"
        return {"family": family, "num_heads": 1, "img_shape": (2,)}
    side = int(round(out ** 0.5))
    if side * side != out:
        raise TorchImportError(f"non-square generator output dim {out}")
    family = "mnist-multipath" if heads else "mnist-mlp"
    return {"family": family, "num_heads": max(n, 1),
            "img_shape": (1, side, side)}


# ---------------------------------------------------------------------------
# group -> tree conversion
# ---------------------------------------------------------------------------

def _take(it, want: str, ctx: str) -> _Group:
    try:
        g = next(it)
    except StopIteration:
        raise TorchImportError(f"{ctx}: ran out of modules wanting {want}")
    if g.kind != want:
        raise TorchImportError(
            f"{ctx}: expected {want}, found {g.kind} ({g.prefix!r})")
    return g


def _linear(g: _Group) -> Dict:
    return {"w": g.tensors["weight"].t().contiguous(),
            "b": g.tensors["bias"]}


def _conv(g: _Group) -> Dict:
    return {"w": g.tensors["weight"], "b": g.tensors["bias"]}


def _bn(g: _Group) -> Tuple[Dict, Dict]:
    return ({"scale": g.tensors["weight"], "bias": g.tensors["bias"]},
            {"mean": g.tensors["running_mean"],
             "var": g.tensors["running_var"]})


def _fill_mlp(spec, groups: List[_Group], ctx: str):
    params: List = []
    state: List = []
    it = iter(groups)
    for entry in spec:
        if entry[0] == "linear":
            params.append(_linear(_take(it, "linear", ctx)))
            state.append(None)
        elif entry[0] == "bn":
            p, s = _bn(_take(it, "bn", ctx))
            params.append(p)
            state.append(s)
        else:
            params.append(None)
            state.append(None)
    rest = list(it)
    if rest:
        raise TorchImportError(
            f"{ctx}: {len(rest)} unconsumed modules "
            f"(first: {rest[0].prefix!r}) — architecture mismatch")
    return params, state


def _stack(trees):
    """Stack identical trees on a new leading axis (the heads' layout)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _check_shapes(got, want, ctx: str) -> None:
    gl, wl = tree_leaves(got), tree_leaves(want)
    if len(gl) != len(wl) or any(g.shape != w.shape for g, w in zip(gl, wl)):
        raise TorchImportError(
            f"{ctx}: imported tree shapes do not match the family template "
            f"({[tuple(g.shape) for g in gl]} vs "
            f"{[tuple(w.shape) for w in wl]})")


def _template(model: zoo.Model, dtype):
    """The family's ``init`` of one member, unstacked (values unused)."""
    params, state = model.init(threefry.key(0).unsqueeze(0), dtype)
    one = lambda tree: tree_map(lambda x: x[0], tree)
    return one(params), one(state)


def import_generator(sd: Dict[str, torch.Tensor], family: str,
                     num_heads: int = 1,
                     img_shape: Tuple[int, ...] = (1, 28, 28),
                     dtype=torch.float32, device=None):
    """Convert a reference generator state_dict into ``(params, state)``
    for ``zoo.build_generator(family, num_heads, img_shape)``: one member,
    unstacked, each leaf in the template's dtype on ``device`` (default
    ``cuda``; ``"cpu"`` only when asked)."""
    dev = device_mod.resolve(device)
    trunk, heads = _split_paths(_groups(sd))
    out = 1
    for d in img_shape:
        out *= int(d)

    if family in ("2dmg-small", "2dmg-mlp", "mnist-mlp"):
        if heads:
            raise TorchImportError(
                f"state_dict has {len(heads)} paths but {family} is "
                "single-path")
        spec = {"2dmg-small": [("linear", 100, 32), ("lrelu", 0.2),
                               ("linear", 32, 2), ("tanh",)],
                "2dmg-mlp": [("linear", 100, 256), ("lrelu", 0.2),
                             ("linear", 256, 128), ("lrelu", 0.2),
                             ("linear", 128, 2), ("tanh",)],
                "mnist-mlp": zoo._mnist_g_spec(out)}[family]
        params, state = _fill_mlp(spec, trunk, family)
    elif family in ("2dmg-multipath", "mnist-multipath"):
        if len(heads) != num_heads:
            raise TorchImportError(
                f"state_dict has {len(heads)} paths, expected {num_heads}")
        if family == "2dmg-multipath":
            tspec = [("linear", 100, 32), ("lrelu", 0.2)]
            hspec = [("linear", 32, 2), ("tanh",)]
        else:
            tspec = zoo._MNIST_TRUNK_SPEC
            hspec = zoo._mnist_head_spec(out)
        tp, ts = _fill_mlp(tspec, trunk, f"{family} trunk")
        per = [_fill_mlp(hspec, h, f"{family} head {i}")
               for i, h in enumerate(heads)]
        params = {"trunk": tp, "heads": _stack([p for p, _ in per])}
        state = {"trunk": ts, "heads": _stack([s for _, s in per])}
    elif family == "conv":
        if heads:
            raise TorchImportError("conv family is single-path; state_dict "
                                   f"has {len(heads)} paths")
        it = iter(trunk)
        params = {"l1": _linear(_take(it, "linear", "conv")),
                  "c1": _conv(_take(it, "conv", "conv"))}
        bn1p, bn1s = _bn(_take(it, "bn", "conv"))
        params["c2"] = _conv(_take(it, "conv", "conv"))
        bn2p, bn2s = _bn(_take(it, "bn", "conv"))
        params["c3"] = _conv(_take(it, "conv", "conv"))
        params["bn1"], params["bn2"] = bn1p, bn2p
        state = {"bn1": bn1s, "bn2": bn2s}
        if list(it):
            raise TorchImportError("conv: unconsumed modules")
    elif family == "conv-multipath":
        if len(heads) != num_heads:
            raise TorchImportError(
                f"state_dict has {len(heads)} paths, expected {num_heads}")
        it = iter(trunk)
        tparams = {"l1": _linear(_take(it, "linear", "conv-mp")),
                   "c1": _conv(_take(it, "conv", "conv-mp"))}
        bn1p, bn1s = _bn(_take(it, "bn", "conv-mp"))
        tparams["bn1"] = bn1p
        tparams["c2"] = _conv(_take(it, "conv", "conv-mp"))
        if list(it):
            raise TorchImportError("conv-multipath: unconsumed trunk modules")
        hp, hs = [], []
        for i, h in enumerate(heads):
            hit = iter(h)
            bp, bs = _bn(_take(hit, "bn", f"conv-mp head {i}"))
            c = _conv(_take(hit, "conv", f"conv-mp head {i}"))
            if list(hit):
                raise TorchImportError(
                    f"conv-multipath head {i}: unconsumed modules")
            hp.append({"bn": bp, "c": c})
            hs.append({"bn": bs})
        params = {"trunk": tparams, "heads": _stack(hp)}
        state = {"trunk": {"bn1": bn1s}, "heads": _stack(hs)}
    else:
        raise TorchImportError(f"unknown generator family {family!r}")

    # validate against the family template, then take its dtype and the
    # device asked for
    tmpl_p, tmpl_s = _template(
        zoo.build_generator(family, num_heads, img_shape), dtype)
    _check_shapes(params, tmpl_p, f"{family} params")
    _check_shapes(state, tmpl_s, f"{family} state")
    place = lambda tree, tmpl: tree_unflatten(tree, [
        x.to(device=dev, dtype=t.dtype)
        for x, t in zip(tree_leaves(tree), tree_leaves(tmpl))])
    return place(params, tmpl_p), place(state, tmpl_s)


def _skeleton(tree):
    """A tree's structure: containers and ``None`` holes, leaves as 0."""
    return tree_map(lambda _: 0, tree)


def warm_start_generators(state, paths):
    """Warm-start a freshly initialised FedState's generators from
    reference ``.pt`` checkpoints — continue training a reference model
    here.

    Handles both generator layouts: algorithms that stack one G per
    server/worker on a leading axis (MD-GAN/AC-GAN/CGL families — pass
    one ``.pt`` per server, or one to broadcast) and algorithms that
    share a single G (FL-GAN/FeGAN — pass exactly one).  Parameters and
    BN running stats are replaced; D, the optimizer state, ``lam`` and
    ``t`` stay as they are (the reference saves no optimizer state).
    Each leaf is cast to the template's dtype and put on its device."""
    imports = [import_generator_file(p, device="cpu") for p in paths]
    keys = {(i[3]["family"], i[3]["num_heads"], tuple(i[3]["img_shape"]))
            for i in imports}
    if len(keys) > 1:
        raise TorchImportError(
            f"checkpoints disagree on the generator architecture: {keys}")

    def merge(tmpl, singles, what):
        ref = singles[0]
        if _skeleton(tmpl) != _skeleton(ref):
            raise TorchImportError(
                f"imported {what} tree does not match the run's generator "
                f"family (imported {imports[0][3]['family']!r})")
        t_leaves = tree_leaves(tmpl)
        s_leaves = tree_leaves(ref)
        if not t_leaves:
            return tmpl
        if t_leaves[0].shape == s_leaves[0].shape:
            if len(singles) != 1:
                raise TorchImportError(
                    "this algorithm shares ONE generator across workers "
                    f"(FL-GAN/FeGAN layout); got {len(singles)} checkpoints "
                    "— pass a single .pt")
            new = ref
        elif t_leaves[0].shape[1:] == s_leaves[0].shape:
            S = t_leaves[0].shape[0]
            if len(singles) == 1:
                singles = singles * S
            elif len(singles) != S:
                raise TorchImportError(
                    f"run has {S} stacked generators; got {len(singles)} "
                    "checkpoints (pass 1 to broadcast, or one per server)")
            new = tree_map(lambda *xs: torch.stack(xs), *singles)
        else:
            raise TorchImportError(
                f"imported generator shapes do not match the run's "
                f"({tuple(s_leaves[0].shape)} vs template "
                f"{tuple(t_leaves[0].shape)})")

        def put(n, o):
            if n.shape != o.shape:
                raise TorchImportError(
                    f"{what} leaf shape {tuple(n.shape)} != template "
                    f"{tuple(o.shape)}")
            return n.to(device=o.device, dtype=o.dtype)

        return tree_map(put, new, tmpl)

    g = state.g
    g = g._replace(params=merge(g.params, [i[1] for i in imports], "params"),
                   bn=merge(g.bn, [i[2] for i in imports], "bn"))
    return state._replace(g=g)


def import_generator_file(path: str, family: Optional[str] = None,
                          num_heads: Optional[int] = None,
                          img_shape: Optional[Tuple[int, ...]] = None,
                          dtype=torch.float32, device=None):
    """One-call import: load ``path``, auto-detect unless overridden.
    Returns ``(model, params, state, info)``: the zoo ``Model``, the
    unstacked trees on ``device`` and the detection dict."""
    sd = load_torch_state_dict(path)
    info = detect_generator(sd)
    if family is not None:
        info["family"] = family
    if num_heads is not None:
        info["num_heads"] = num_heads
    if img_shape is not None:
        info["img_shape"] = tuple(img_shape)
    params, state = import_generator(
        sd, info["family"], info["num_heads"], info["img_shape"], dtype,
        device)
    model = zoo.build_generator(info["family"], info["num_heads"],
                                info["img_shape"])
    return model, params, state, info
