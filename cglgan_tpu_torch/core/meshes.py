"""Device meshes for the federation: the ``clients`` and ``model`` axes over
``torch.distributed``.

Port of ``cglgan_tpu/core/meshes.py``.  There a mesh is a
``jax.sharding.Mesh``, per-client state is placed split over its
``clients`` axis, the generators optionally column-split over its ``model``
axis, and GSPMD partitions one jitted round.  Here a mesh is one process a
card (NCCL, ``cuda:rank``), or a gloo process group on the host when the
caller asks for ``device="cpu"``: a
``torch.distributed.device_mesh.DeviceMesh`` of a ``clients`` dimension
and, with ``model_shards > 1``, a ``model`` dimension, as the reference's
``devices.reshape(-1, model_shards)``: rank r sits at clients r // ms and
model r % ms.  Each rank holds its clients coordinate's block of the
per-client state and data shards (the ranks of one clients coordinate hold
the same block); the generators are replicated, or with tensor
parallelism split over ``model`` (``place_model_tp``, computed by
``models/tp.py``); the federated exchanges of ``fed/collectives.py``
compute the rank-local partial and make the one collective the reference's
round lowers to, over the ``clients`` group.

Layouts (the reference's specs):
* ``P(CLIENTS)``: leaves ``(W, ...)``, a contiguous block of W / n rows a
  rank (the FedAvg family's per-worker state);
* ``P(None, CLIENTS)``: leaves ``(S, k, ...)``, each server's k clients
  split k / n a rank (the CGL and MD-GAN families' D stacks).  The port
  keeps those stacks flat ``(S * k, ...)``, so ``place`` takes
  ``groups=S`` and views a flat leaf as ``(S, k, ...)``;
* ``TP``: Megatron column sharding (``model_tp_spec``): the last dim of
  every leaf with more than ``lead`` dims split over ``model`` where the
  shards divide it, every other leaf whole;
* ``P()``: replicated.

Every collective goes through the mesh's ``Recorder``: its kind, the axis
it ran over and the bytes of each array it moves, in the order they were
made.

Ranks that share a card (``spawn(..., share_cards=True)``, for
``chip_smoke.py`` and the tests only): rank r runs on ``cuda:r % cards``
in a gloo group, and every collective here stages its buffers through host
memory.  Nothing picks this on its own: a mesh of cards is NCCL, one rank
a card.
"""
from __future__ import annotations

import os
import tempfile
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence)

import torch
import torch.distributed as dist

from cglgan_tpu_torch.utils.tree import tree_leaves, tree_unflatten

CLIENTS = "clients"
MODEL = "model"
# the layout spec of a tree split by ``place_model_tp``
TP = "model_tp"


def P(*axes) -> tuple:
    """A partition spec: the mesh axis each leading dimension is split
    over (None: whole), as ``jax.sharding.PartitionSpec``."""
    return tuple(axes)


class Recorder:
    """The collectives a mesh made: ``(kind, axis, [bytes of each array])``
    in their order; ``take()`` returns them and starts a new log (taken
    around a round, the round's collectives)."""

    def __init__(self) -> None:
        self.log: List[tuple] = []

    def add(self, kind: str, axis: str,
            tensors: Sequence[torch.Tensor]) -> None:
        self.log.append((kind, axis, [t.numel() * t.element_size()
                                      for t in tensors]))

    def take(self) -> List[tuple]:
        out, self.log = self.log, []
        return out


class ModelAxis(NamedTuple):
    """A mesh's ``model`` axis, the context of the tensor-parallel G
    forward (``models/tp.py``): its process group, this rank's index on it
    and its size."""
    mesh: Any
    group: Any
    rank: int
    size: int


class Mesh:
    """A ``(clients[, model])`` mesh: the ``DeviceMesh``, this rank's
    clients index (``rank``) and the clients size (``size``), the model
    index and size, whether this rank is the global rank 0 (``lead``, where
    ``gather_state`` puts the whole state), this rank's device and the
    recorder.  ``tp`` is the model axis where it has more than one rank,
    else None."""

    model_group = None
    model_rank = 0
    model_size = 1
    tp: Optional[ModelAxis] = None
    lead = True
    stage = False

    def __init__(self, device_mesh, device: torch.device,
                 stage: bool = False) -> None:
        self.device_mesh = device_mesh
        self.group = device_mesh.get_group(CLIENTS)
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        if MODEL in device_mesh.mesh_dim_names:
            self.model_group = device_mesh.get_group(MODEL)
            self.model_rank = dist.get_rank(self.model_group)
            self.model_size = dist.get_world_size(self.model_group)
        if self.model_size > 1:
            self.tp = ModelAxis(self, self.model_group, self.model_rank,
                                self.model_size)
        self.lead = dist.get_rank() == 0
        self.device = device
        # collectives through host memory: ranks sharing a card
        self.stage = stage
        self.recorder = Recorder()
        self._shapes: Dict[int, "Mesh"] = {}

    def block(self, n: int) -> slice:
        """This rank's contiguous block of a clients axis of ``n`` members;
        raises ValueError where the ranks do not divide it (the reference's
        ``device_put`` refuses such a sharding)."""
        if n % self.size:
            raise ValueError(f"a clients axis of {n} does not divide over "
                             f"a mesh of {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def group_of(self, axis: str):
        return self.model_group if axis == MODEL else self.group

    def with_model_shards(self, model_shards: int) -> "Mesh":
        """A mesh of the same ranks whose ``model`` axis has
        ``model_shards`` ranks (this one where it has); made once, and by
        every rank, in the same order (it creates process groups)."""
        if model_shards == self.model_size:
            return self
        if model_shards not in self._shapes:
            self._shapes[model_shards] = fed_mesh(
                dist.get_world_size(), model_shards, self.device,
                share_cards=self.stage)
        return self._shapes[model_shards]


def client_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The 1-D ``clients`` mesh over the initialised default process group
    (``spawn`` sets it up)."""
    return fed_mesh(n_devices, 1, device)


def fed_mesh(n_devices: Optional[int] = None, model_shards: int = 1,
             device=None, share_cards: bool = False) -> Mesh:
    """A ``(clients, model)`` mesh of ``(n / model_shards, model_shards)``
    ranks over the initialised default process group (``spawn`` sets it
    up); ``model_shards == 1`` is the 1-D clients mesh.  One rank a card,
    ``cuda:rank``, or gloo ranks on the host with ``device="cpu"``;
    ``share_cards``: the group is gloo and the collectives stage through
    host memory.  ``n_devices`` must be the world size where given; raises
    ValueError where ``model_shards`` does not divide it."""
    if model_shards < 1:
        raise ValueError("model_shards must be >= 1")
    # checked before any process group is touched, as the reference's
    world = dist.get_world_size() if n_devices is None else n_devices
    if world % model_shards:
        raise ValueError(f"{world} devices not divisible by "
                         f"model_shards={model_shards}")
    if world != dist.get_world_size():
        raise ValueError(f"a mesh of {world} ranks in a world of "
                         f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device("cuda", dist.get_rank()) if device is None \
        else torch.device(device)
    stage = share_cards and dev.type == "cuda"
    shape, names = ((world,), (CLIENTS,)) if model_shards == 1 else \
        ((world // model_shards, model_shards), (CLIENTS, MODEL))
    return Mesh(init_device_mesh("cpu" if stage else dev.type, shape,
                                 mesh_dim_names=names), dev, stage)


def model_shards_of(mesh: Optional[Mesh]) -> int:
    """The ``model`` axis' size (1 without a mesh or a model axis)."""
    return 1 if mesh is None else mesh.model_size


def model_tp_spec(shape: Sequence[int], ms: int, lead: int = 0) -> tuple:
    """Megatron column sharding of one leaf of ``shape`` over ``ms`` model
    shards, the reference's rule: the last dim split over ``model`` where
    the leaf has more than ``lead`` dims (the leading stacked-federation
    axes stay whole) and ``ms`` divides it; otherwise replicated."""
    if ms > 1 and len(shape) > lead and shape[-1] % ms == 0:
        return P(*([None] * (len(shape) - 1) + [MODEL]))
    return P()


class TPPlan(NamedTuple):
    """How a tree was split by ``place_model_tp``: ``lead`` and the paths
    (``map_paths``) of its split leaves, so that ``gather_state`` can tell a
    block from a whole leaf of the same shape.  Paths name NamedTuple
    fields and dict keys alike, so that a state and its checkpoint
    (``utils/checkpoint.py``: NamedTuples as dicts) have the same."""
    lead: int
    split: frozenset


def tp_plan(tree, ms: int, lead: int = 1) -> TPPlan:
    """The plan of the whole ``tree`` split over ``ms`` model shards."""
    split = set()
    map_paths(tree, lambda path, x: split.add(path) if model_tp_spec(
        tuple(x.shape), ms, lead) != P() else None)
    return TPPlan(lead, frozenset(split))


def place_model_tp(tree, mesh: Optional[Mesh], lead: int = 1):
    """This rank's block of every leaf of the whole ``tree`` under
    ``model_tp_spec``: of its last dim where it is split, the leaf itself
    where it stays whole.  No model axis: the tree as it is."""
    tp = None if mesh is None else mesh.tp
    if tp is None:
        return tree

    def put(x):
        if model_tp_spec(tuple(x.shape), tp.size, lead) == P():
            return x
        per = x.shape[-1] // tp.size
        return x[..., tp.rank * per:(tp.rank + 1) * per].clone()
    return _tensors(put, tree)


def _block_rows(x: torch.Tensor, mesh: Mesh, spec: tuple,
                groups: Optional[int]) -> torch.Tensor:
    if spec == P(CLIENTS):
        return x[mesh.block(x.shape[0])].clone()
    if spec != P(None, CLIENTS):
        raise ValueError(f"unsupported spec {spec}")
    if groups is None:                                  # (S, k, ...)
        return x[:, mesh.block(x.shape[1])].clone()
    sk = x.reshape((groups, -1) + tuple(x.shape[1:]))
    return sk[:, mesh.block(sk.shape[1])].reshape(
        (-1,) + tuple(x.shape[1:])).clone()


def _tensors(fn, tree):
    """``fn`` on every tensor of ``tree``: NamedTuples (a NetState, an
    AdamState), dicts, lists and tuples walked; None and other leaves (the
    round counter) kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tensors(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: _tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(fn, v) for v in tree)
    return tree


def place(tree, mesh: Optional[Mesh], spec: tuple, groups=None):
    """This rank's block of every leaf (``P(CLIENTS)``: of axis 0;
    ``P(None, CLIENTS)``: of axis 1 of ``(S, k, ...)`` leaves, or with
    ``groups=S`` of flat ``(S * k, ...)`` leaves viewed so, returned flat;
    ``TP``: ``place_model_tp`` with ``groups`` its ``TPPlan``); ``P()`` and
    no mesh leave the tree as it is."""
    if mesh is None or spec == P():
        return tree
    if spec == TP:
        return place_model_tp(tree, mesh, groups.lead)
    return _tensors(lambda x: _block_rows(x, mesh, spec, groups), tree)


def _field(obj, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _with_field(obj, name: str, value):
    if isinstance(obj, dict):
        return {**obj, name: value}
    return obj._replace(**{name: value})


def _at_paths(state, layout: Dict[str, tuple], fn):
    """``state`` with the subtree at each dotted path of ``layout``
    replaced by ``fn(subtree, spec, groups)``; fields are attributes of
    NamedTuples or keys of the plain dicts a checkpoint holds."""
    for path, (spec, groups) in layout.items():
        names = path.split(".")

        def swap(obj, i):
            sub = _field(obj, names[i])
            new = fn(sub, spec, groups) if i + 1 == len(names) \
                else swap(sub, i + 1)
            return _with_field(obj, names[i], new)
        state = swap(state, 0)
    return state


def place_state(state, mesh: Optional[Mesh], layout: Dict[str, tuple]):
    """``place`` a whole state: ``layout`` maps dotted field paths
    (``"d"``, ``"g.opt"``) to ``(spec, groups)`` (for ``TP``, ``(TP,
    TPPlan)``); the other fields are replicated.  No mesh: the state as it
    is."""
    if mesh is None:
        return state
    return _at_paths(state, layout,
                     lambda sub, spec, groups: place(sub, mesh, spec, groups))


def gather_state(state, mesh: Optional[Mesh], layout: Dict[str, tuple]):
    """The inverse of ``place_state``: the whole state on the lead rank
    (clients 0, model 0), None on the other ranks.  A split leaf is one
    ``gather`` over ``model`` among the ranks of clients 0, a client stack
    one over ``clients`` among the ranks of model 0; the other ranks of
    the mesh make no collective.  No mesh: the state as it is."""
    if mesh is None:
        return state

    def whole(sub, spec, groups):
        if spec == TP:
            if mesh.rank or mesh.tp is None:
                return sub
            split = groups.split
            return map_paths(sub, lambda path, x: gather_model(
                x, mesh) if path in split else x)
        if spec == P() or mesh.model_rank:
            return sub
        return _tensors(lambda x: gather_clients(
            x, mesh, groups if spec == P(None, CLIENTS) else 1, 0), sub)
    out = _at_paths(state, layout, whole)
    return out if mesh.lead else None


def map_paths(tree, fn, path: str = ""):
    """``_tensors`` with each tensor's path: ``fn(path, tensor)``, the
    path ``.name`` for a NamedTuple field or a dict key, ``[i]`` for a
    list or tuple entry."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_paths(getattr(tree, n), fn,
                                                 f"{path}.{n}")
                            for n in tree._fields))
    if isinstance(tree, dict):
        return {k: map_paths(v, fn, f"{path}.{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_paths(v, fn, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return tree


def commit_tree(tree, mesh: Optional[Mesh]):
    """Identity.  The reference commits every leaf to the mesh so that jit
    dispatch stays on its fast path; torch has no committed placement to
    make: a leaf lives on its rank's device once it is made there."""
    return tree


# ---------------------------------------------------------------------------
# collectives: every one is recorded; on shared cards, through the host
# ---------------------------------------------------------------------------

def _wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` where the group's backend takes it: host memory on a mesh of
    shared cards (gloo), else ``x``."""
    return x.cpu() if mesh.stage else x


def _memory_order(t: torch.Tensor) -> Optional[List[int]]:
    """The dims of a dense ``t`` from outermost to innermost in memory
    (its ``permute`` by them is a contiguous view), None where ``t`` is
    contiguous or not dense."""
    if t.is_contiguous():
        return None
    perm = sorted(range(t.ndim), key=lambda d: -t.stride(d))
    return perm if t.permute(perm).is_contiguous() else None


def _pack(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, tuple]:
    """Flat buffers, one a dtype: {dtype: (buffer, [(index, shape,
    memory order)])}.  A dense tensor goes in its memory order, so that
    ``_unpack`` gives it back with its strides: the reductions that read
    it then sum in the order they would without a mesh."""
    by: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        by.setdefault(t.dtype, []).append(i)
    plan = {}
    for dt, idx in by.items():
        perms = [_memory_order(tensors[i]) for i in idx]
        flat = [tensors[i].reshape(-1) if perm is None
                else tensors[i].permute(perm).reshape(-1)
                for i, perm in zip(idx, perms)]
        plan[dt] = (torch.cat(flat), [(i, tensors[i].shape, perm)
                                      for i, perm in zip(idx, perms)])
    return plan


def _unpack(bufs: Dict[torch.dtype, torch.Tensor], plan, n: int) -> list:
    out: List[Any] = [None] * n
    for dt, (_, places) in plan.items():
        flat, at = bufs[dt], 0
        for i, shape, perm in places:
            size = shape.numel()
            part = flat[at:at + size]
            if perm is None:
                out[i] = part.reshape(shape)
            else:
                out[i] = part.reshape([shape[d] for d in perm]).permute(
                    sorted(range(len(perm)), key=perm.__getitem__))
            at += size
    return out


def all_reduce(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh],
               axis: str = CLIENTS) -> List[torch.Tensor]:
    """The sums over the ranks of ``axis`` of ``tensors``, as ONE
    all-reduce of a flat bucket a dtype (XLA's fused tuple all-reduce).
    No mesh: the tensors as they are."""
    tensors = list(tensors)
    if mesh is None:
        return tensors
    plan = _pack(tensors)
    bufs = {}
    for dt, (buf, places) in plan.items():
        mesh.recorder.add("all_reduce", axis,
                          [tensors[i] for i, _, _ in places])
        wire = _wire(buf, mesh)
        dist.all_reduce(wire, group=mesh.group_of(axis))
        bufs[dt] = wire.to(buf.device)
    return _unpack(bufs, plan, len(tensors))


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = CLIENTS
               ) -> torch.Tensor:
    """Every rank's ``x`` on ``axis``, stacked ``(size, *x.shape)`` in rank
    order."""
    group = mesh.group_of(axis)
    wire = _wire(x.contiguous(), mesh)
    parts = [torch.empty_like(wire)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    out = torch.stack(parts).to(x.device)
    mesh.recorder.add("all_gather", axis, [out])
    return out


def _gather(x: torch.Tensor, mesh: Mesh, axis: str, dst: int):
    """Every rank's ``x`` on ``axis`` stacked on rank ``dst`` of it (a
    ``gather``), None on the others."""
    group = mesh.group_of(axis)
    n = dist.get_world_size(group)
    wire = _wire(x.contiguous(), mesh)
    mine = dist.get_rank(group) == dst
    lst = [torch.empty_like(wire) for _ in range(n)] if mine else None
    dist.gather(wire, lst, dst=dist.get_global_rank(group, dst),
                group=group)
    mesh.recorder.add("gather", axis, [x] * n)
    return torch.stack(lst).to(x.device) if mine else None


def gather_model(x: torch.Tensor, mesh: Mesh) -> Optional[torch.Tensor]:
    """The inverse of ``place_model_tp`` for one split leaf: every model
    rank's block, joined along the last dim on model rank 0 (None on the
    others)."""
    parts = _gather(x, mesh, MODEL, 0)
    return None if parts is None else torch.cat(parts.unbind(0), dim=-1)


def gather_clients(x: torch.Tensor, mesh: Optional[Mesh], groups: int = 1,
                   dst: Optional[int] = None):
    """The inverse of ``place(x, mesh, ..., groups)`` for one flat leaf:
    every rank's rows back in the unsharded order, ``(S * k, ...)``.
    ``dst``: only that clients rank gets the result (a ``gather``; the
    others get None); by default every rank does (an ``all_gather``).  No
    mesh: x."""
    if mesh is None:
        return x
    if dst is None:
        parts = all_gather(x, mesh)
    else:
        parts = _gather(x, mesh, CLIENTS, dst)
        if parts is None:
            return None
    rest = tuple(x.shape[1:])
    sk = parts.reshape((mesh.size, groups, -1) + rest).transpose(0, 1)
    return sk.reshape((-1,) + rest)


def exchange(sends: Sequence[tuple], recvs: Sequence[tuple], mesh: Mesh
             ) -> List[torch.Tensor]:
    """Point-to-point over ``clients``, all in one ``batch_isend_irecv``:
    ``sends`` [(peer rank, 1-D buffer)], ``recvs`` [(peer rank, numel,
    dtype)].  Returns the received buffers in ``recvs`` order (messages
    between two ranks match in the order they are posted)."""
    where = torch.device("cpu") if mesh.stage else mesh.device
    got = [torch.empty(n, dtype=dt, device=where) for _, n, dt in recvs]
    peer = lambda q: dist.get_global_rank(mesh.group, q)
    ops = [dist.P2POp(dist.isend, _wire(buf.contiguous(), mesh), peer(q),
                      mesh.group) for q, buf in sends]
    ops += [dist.P2POp(dist.irecv, buf, peer(q), mesh.group)
            for (q, _, _), buf in zip(recvs, got)]
    for _, buf in sends:
        mesh.recorder.add("send", CLIENTS, [buf])
    for buf in got:
        mesh.recorder.add("recv", CLIENTS, [buf])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [buf.to(mesh.device) for buf in got]


def move_rows(tree, rows_out: Dict[int, List[int]],
              rows_in: Dict[int, List[int]], keep: tuple, mesh: Mesh):
    """Move member rows of every leaf of ``tree`` (this rank's block)
    between ranks: to each peer q the local rows ``rows_out[q]``, in the
    order q takes them; from each peer q the rows that land at the local
    rows ``rows_in[q]``; ``keep`` = (dst rows, src rows) within this rank.
    One flat bucket a peer and dtype; rows nobody writes keep their
    value."""
    leaves = tree_leaves(tree)
    as_idx = lambda rows: torch.tensor(rows, dtype=torch.long,
                                       device=mesh.device)
    shapes = lambda n: [torch.Size((n,) + tuple(x.shape[1:]))
                        for x in leaves]

    def layout(n: int) -> list:
        """[(dtype, numel)] of the buckets of n rows, in ``_pack`` order."""
        by: Dict[torch.dtype, int] = {}
        for x, s in zip(leaves, shapes(n)):
            by[x.dtype] = by.get(x.dtype, 0) + s.numel()
        return list(by.items())

    sends = []
    for q, rows in rows_out.items():
        plan = _pack([x.index_select(0, as_idx(rows)) for x in leaves])
        sends += [(q, buf) for buf, _ in plan.values()]
    recvs = [(q, n, dt) for q, rows in rows_in.items()
             for dt, n in layout(len(rows))]
    got = iter(exchange(sends, recvs, mesh))
    out = [x.clone() for x in leaves]
    if keep[0]:
        dst, src = as_idx(keep[0]), as_idx(keep[1])
        for o, x in zip(out, leaves):
            o[dst] = x.index_select(0, src)
    for q, rows in rows_in.items():
        plan = {dt: (None, [(i, s, None) for i, (x, s) in
                            enumerate(zip(leaves, shapes(len(rows))))
                            if x.dtype == dt])
                for dt, _ in layout(len(rows))}
        parts = _unpack({dt: next(got) for dt in plan}, plan, len(leaves))
        dst = as_idx(rows)
        for o, part in zip(out, parts):
            o[dst] = part
    return tree_unflatten(tree, out)


# ---------------------------------------------------------------------------
# one process a rank
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn: Callable, n: int, device_type: str,
               out_dir: str, threads: int, args: tuple, model_shards: int,
               share_cards: bool) -> None:
    """A spawned rank: join the group, build the mesh, run ``fn(mesh,
    *args)``, save what it returns for the parent, leave the group.  The
    ranks meet at a file store in the job's own directory: no port that
    another job on the host could take in the meantime."""
    if device_type == "cpu" or share_cards:
        # the ranks share the host's cores
        torch.set_num_threads(threads)
    if device_type == "cuda":
        index = rank % torch.cuda.device_count() if share_cards else rank
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
        if share_cards:
            backend = "gloo"
        else:
            # the ranks of one host find each other on the loopback
            # interface
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
            backend = "nccl"
    else:
        dev = torch.device("cpu")
        backend = "gloo"
    store = os.path.join(out_dir, "store")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=n, rank=rank)
    try:
        out = fn(fed_mesh(n, model_shards, dev, share_cards=share_cards),
                 *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, device=None, *args, model_shards: int = 1,
          share_cards: bool = False) -> list:
    """Run ``fn(mesh, *args)`` on ``n`` ranks, one process each (start
    method ``spawn``; ``fn`` a module-level function, pickled by name), on
    a ``(n / model_shards, model_shards)`` mesh (``fed_mesh``), and return
    what each rank's ``fn`` returned, in rank order (CPU tensors only).
    ``device``: None or ``"cuda"``, one NCCL rank a card, raising where
    fewer than ``n`` cards are present; ``"cpu"``: ``n`` gloo ranks on the
    host.  ``share_cards`` (CUDA only; for ``chip_smoke.py`` and the tests):
    rank r on ``cuda:r % cards``, gloo, collectives through host memory.
    A rank that raises stops the others, and the error is raised here."""
    dev = torch.device("cuda" if device is None else device)
    if model_shards < 1 or n % model_shards:
        raise ValueError(f"{n} devices not divisible by "
                         f"model_shards={model_shards}")
    if dev.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < (1 if share_cards else n):
            raise RuntimeError(f"a mesh of {n} ranks needs "
                               f"{1 if share_cards else n} CUDA devices "
                               f"and {have} are present; pass "
                               "device='cpu' for gloo ranks on the host")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    elif share_cards:
        raise ValueError("share_cards puts ranks on CUDA cards")
    threads = max(1, torch.get_num_threads() // n)
    with tempfile.TemporaryDirectory(prefix="tpufed-mesh-") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, n, dev.type, tmp, threads, args,
                              model_shards, share_cards),
            nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n)]
