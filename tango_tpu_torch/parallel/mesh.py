"""The device mesh over torch.distributed: port of tango_tpu/parallel/mesh.py.

One process drives each device. The mesh is 2-D, ('data', 'model'), with
rank r at (r // model, r % model): JAX's process-major layout
(`np.asarray(devices).reshape(data, model)`). Where XLA derives every
collective from sharding annotations, here each use places its own:

  * data parallelism: every data rank takes its rows of a batch
    (`process_local_batch_slice`, `shard_batch`, `shard_batch_or_replicate`);
    training all-reduces the gradients as a mean over 'data'
    (`all_reduce_grads`) and reports losses reduced the same way
    (`mean_over_data`); serving gathers the rows back (`gather_rows`).
  * Megatron tensor parallelism over 'model': the rules below (JAX's
    `_TP_RULES`, on the port's parameter names) pick the column-parallel
    projections (to_q/k/v/qkv/kv, net_0_proj, T5's q/k/v and wi*) and the
    row-parallel ones (to_out_0, net_2, T5's o and wo); everything else is
    replicated. The modules that own them say which whole heads (or hidden
    units) a model rank keeps (`tp_layout`), run `copy_to_model` in front of the
    column-parallel layer and `reduce_from_model` after the row-parallel
    one, and add the row-parallel bias once, after the reduction.
  * sequence parallelism over 'model' (`shard_latents_seq`, the UNet's
    `latent_sharder`): each model rank runs the UNet on its contiguous slab
    of the latent time axis, with replicated parameters (never with TP: the
    two are alternative uses of 'model'). Where XLA derives the exchanges
    from a sharding constraint, the modules call them here, over
    `model_group`: the neighbours' boundary rows for a convolution
    (`halo_rows`), the GroupNorm partial sums (`all_reduce_over_model_`),
    the slabs gathered in rank order (`gather_seq`: a self-attention's
    keys and values, a level that runs whole, the output), and an int8
    convolution's per-sample amax, the largest over the slabs
    (`all_max_over_model_`, the scale the meshless quantize takes over the
    whole tensor). Each counts its
    calls and the bytes it receives from the other ranks in the mesh's
    `seq_stats`, its backward under "<kind>_grad".

    SP trains with one gradient rule, which every exchange's backward keeps
    (XLA derives these; here they are written out as autograd Functions):
    a tensor every model rank holds whole (replicated) carries a *partial*
    gradient, whose sum over the model ranks is the true one; a T-slab
    carries its own slab's true gradient. So the halo exchange's backward
    sends each halo row's gradient back to the rank that owns the row and
    adds it there (one all-gather of the edges' gradients, the mirror of the
    forward's); the slab -> whole gather's backward is a reduce-scatter (the
    sum over the model ranks, each keeping its slab); the whole -> slab
    narrow keeps its zero-padded backward; the UNet's output, whose loss
    every model rank computes whole and alike, passes its gradient divided
    by 'model' (`partial_grad`); GroupNorm all-reduces its backward's group
    sums; and the replicated parameters' partial gradients are summed over
    'model' with the mean over 'data' (`all_reduce_grads(seq=True)`).

A world of one gives a trivial mesh without a process group: every
collective of an axis of size 1 is the identity, so `mesh=make_mesh()` in
one process computes exactly what no mesh does.

Backends: NCCL where every rank has a card of its own, gloo where ranks
share a card or run on the CPU. Under gloo every collective of a card's
tensor is staged through the host (`_all_reduce_`, the gathers), where
gloo takes every dtype, bf16 included.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import functools
import os
import re
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# Megatron-style column/row rules by parameter-name suffix, JAX's _TP_RULES on
# the port's names. A spec names the sharded axis of the torch weight, which
# is (out, in): JAX's P(None, 'model') on a Dense kernel (in, out) is
# ("model", None) here, its P('model', None) is (None, "model").
COLUMN, ROW = ("model", None), (None, "model")
_TP_RULES = [
    (r"(to_q|to_k|to_v|to_qkv|to_kv)\.weight$", COLUMN),
    (r"to_out_0\.weight$", ROW),
    (r"net_0_proj\.weight$", COLUMN),          # GEGLU
    (r"net_2\.weight$", ROW),
    (r"(proj_in|proj_out)\.weight$", (None, None)),  # small; replicate
    # T5 encoder
    (r"attn\.(q|k|v)\.weight$", COLUMN),
    (r"attn\.o\.weight$", ROW),
    (r"ff\.(wi|wi_0|wi_1)\.weight$", COLUMN),
    (r"ff\.wo\.weight$", ROW),
]


def _spec_for(name: str, ndim: int) -> tuple:
    """The rule's spec for parameter `name`; () replicates."""
    for pat, spec in _TP_RULES:
        if re.search(pat, name):
            # the rules describe 2-D matmul weights only: any same-named
            # leaf that is not 2-D (a conv kernel) replicates
            if any(a is not None for a in spec) and ndim != 2:
                return ()
            return spec
    return ()  # replicate (convs, norms, biases, embeddings)


def param_shardings(module: nn.Module) -> Dict[str, tuple]:
    """Each float parameter's spec under the rules. int8 weights replicate:
    JAX's are `kernel_q` leaves, which no rule names."""
    return {n: _spec_for(n, p.dim()) if p.is_floating_point() else ()
            for n, p in module.named_parameters()}


def split_span(n: int, parts: int, index: int) -> Tuple[int, int]:
    """Part `index` of range(n) split into `parts` contiguous spans as evenly
    as possible, the first n % parts one longer: 5 heads over 2 -> 3 and 2;
    2 over 4 -> 1, 1, 0, 0."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


def rank_grid(world: int, data: int = -1, model: int = 1) -> np.ndarray:
    """The (data, model) array of ranks: rank r at (r // model, r % model)."""
    if data == -1:
        if world % model:
            raise ValueError(f"model={model} does not divide the world of {world}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} processes")
    return np.arange(world).reshape(data, model)


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on the ('data', 'model') mesh and its two groups:
    `data_group`, the ranks holding the same model shard (the gradient
    all-reduce), and `model_group`, the ranks sharing one batch slice (the
    Megatron collectives). A group is None where its axis has size 1."""

    devices: np.ndarray                      # the rank grid, JAX's mesh.devices
    rank: int
    device: torch.device
    backend: Optional[str] = None
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    # sequence parallelism's collectives: kind -> calls, "<kind>_bytes" ->
    # bytes received from the other model ranks
    seq_stats: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.devices.shape[0], "model": self.devices.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["model"]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape["model"]

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def __deepcopy__(self, memo):
        # a handle on the process groups, which cannot be copied: a module
        # copied with its latent sharder (DPO's reference UNet) shares it
        return self

    def comm_device(self) -> torch.device:
        """Where a gathered tensor travels: the card under NCCL, the host
        under gloo (which stages every gather there)."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if os.environ.get(name) else None


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL where every rank of this host has a card of its own; gloo where
    ranks share a card (NCCL refuses two ranks on one device) or run on the
    CPU."""
    if device.type != "cuda" or local_world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def init_distributed(device=None, timeout: datetime.timedelta = datetime.timedelta(minutes=10)):
    """Start the default process group from the launch environment; returns
    (rank, world size, device).

    Two launchers set it: torchrun (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT) and JAX's variables (JAX_COORDINATOR=host:port,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID), so one launch line serves both
    packages. Without either (or with a world of one) no group is started.
    The device is `device` where the caller names one with its index (the
    CPU for the tests), else cuda:{LOCAL_RANK % device_count()}. The backend is
    `choose_backend`'s; it is logged, and nothing switches it after a
    failure. `timeout` bounds every collective of the group."""
    if os.environ.get("JAX_COORDINATOR"):
        world = _env_int("JAX_NUM_PROCESSES")
        rank = _env_int("JAX_PROCESS_ID")
        if world is None or rank is None:
            raise RuntimeError("JAX_COORDINATOR needs JAX_NUM_PROCESSES and JAX_PROCESS_ID "
                               "off a TPU pod")
        init_method = f"tcp://{os.environ['JAX_COORDINATOR']}"
        local = _env_int("LOCAL_RANK")
        local_rank = rank if local is None else local
        local_world = _env_int("LOCAL_WORLD_SIZE") or world
    else:
        world = _env_int("WORLD_SIZE") or 1
        rank = _env_int("RANK") or 0
        init_method = "env://"
        local_rank = _env_int("LOCAL_RANK") or 0
        local_world = _env_int("LOCAL_WORLD_SIZE") or world
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run the ranks on "
                               "the CPU")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world == 1:
        return 0, 1, dev
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dev
    backend = choose_backend(dev, local_world)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout)
    print(f"# tango_tpu_torch.parallel: rank {rank} of {world}, backend {backend}, "
          f"device {dev}", file=sys.stderr, flush=True)
    return rank, world, dev


def make_mesh(data: int = -1, model: int = 1, device=None) -> Mesh:
    """The ('data', 'model') mesh of the default process group (a world of
    one without one). data=-1 takes every remaining rank. Every rank must
    call it: the groups are created collectively."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    grid = rank_grid(world, data, model)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    mesh = Mesh(grid, rank, torch.device(device),
                dist.get_backend() if dist.is_initialized() else None)
    if world == 1:
        return mesh
    # every rank creates every group, in the same order
    for m in range(grid.shape[1]):
        g = dist.new_group(grid[:, m].tolist()) if grid.shape[0] > 1 else None
        if rank in grid[:, m]:
            mesh.data_group = g
    for d in range(grid.shape[0]):
        g = dist.new_group(grid[d].tolist()) if grid.shape[1] > 1 else None
        if rank in grid[d]:
            mesh.model_group = g
    return mesh


# ---------------------------------------------------------------- parameters

def shard_params(module: nn.Module, mesh: Mesh, tp: bool = True) -> nn.Module:
    """Shard `module`'s parameters over 'model' by the rules, in place.

    tp=False replicates every parameter (each rank keeps its whole copy: the
    sequence-parallel composition, `shard_latents_seq`). Each module that owns
    rule-sharded weights says which slice a model rank keeps
    (`tp_layout(parts, index)` -> {parameter: (axis, full-layout indices)})
    and takes its share of the heads (`enter_tp_(mesh, parts, index)`); the
    sliced set must be the rules' set."""
    if not tp or mesh.shape["model"] == 1:
        return module
    parts, index = mesh.shape["model"], mesh.model_index
    want = {n for n, s in param_shardings(module).items() if any(a is not None for a in s)}
    done = set()
    for prefix, m in module.named_modules():
        if not hasattr(m, "tp_layout") or getattr(m, "tp_mesh", None) is not None:
            continue
        layout = m.tp_layout(parts, index)
        if not layout:
            continue  # int8 layers: replicated
        for name, (axis, idx) in layout.items():
            owner, leaf = _owner(m, name)
            p = getattr(owner, leaf)
            kept = p.detach().index_select(axis, idx.to(p.device)).clone()
            setattr(owner, leaf, nn.Parameter(kept, requires_grad=p.requires_grad))
            done.add(f"{prefix}.{name}" if prefix else name)
        m.enter_tp_(mesh, parts, index)
    if done != want:
        raise RuntimeError(f"the TP rules and the modules disagree: sharded {sorted(done - want)}"
                           f", left whole {sorted(want - done)}")
    return module


def _owner(module: nn.Module, name: str):
    *path, leaf = name.split(".")
    for p in path:
        module = getattr(module, p)
    return module, leaf


def full_state_dict(module: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The module's state dict with every TP-sharded parameter gathered over
    'model' and put back in its full layout: what the meshless module holds,
    bit for bit. Every rank of the model group must call it."""
    sd = module.state_dict()
    if mesh.model_group is None:
        return sd
    parts = mesh.shape["model"]
    for prefix, m in module.named_modules():
        if getattr(m, "tp_mesh", None) is None:
            continue
        layouts = [m.tp_layout(parts, r) for r in range(parts)]
        for name in layouts[0]:
            key = f"{prefix}.{name}" if prefix else name
            axis = layouts[0][name][0]
            idx = [lay[name][1] for lay in layouts]
            local = sd[key]
            dev = mesh.comm_device()
            width = max(len(i) for i in idx)
            pad = list(local.shape)
            pad[axis] = width - local.shape[axis]
            y = torch.cat([local.to(dev), local.new_zeros(pad, device=dev)], axis).contiguous()
            got = [torch.empty_like(y) for _ in range(parts)]
            dist.all_gather(got, y, group=mesh.model_group)
            shape = list(local.shape)
            shape[axis] = sum(len(i) for i in idx)
            out = local.new_empty(shape)
            for part, i in zip(got, idx):
                out.index_copy_(axis, i.to(out.device), part.narrow(axis, 0, len(i)).to(out.device))
            sd[key] = out
    return sd


def replicated(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Make every rank's copy of `module` rank 0's: broadcast each parameter
    and buffer over the world, in place."""
    if mesh.size == 1:
        return module
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            if mesh.backend == "gloo" and t.device.type != "cpu":  # staged, as _all_reduce_
                host = t.data.cpu()
                dist.broadcast(host, src=0)
                t.data.copy_(host)
            else:
                dist.broadcast(t.data, src=0)
    return module


# -------------------------------------------------------------------- batches

def process_local_batch_slice(mesh: Mesh, global_batch_size: int) -> slice:
    """The contiguous rows of a global batch that this rank's data index
    owns; model ranks of one data index share them."""
    d = mesh.shape["data"]
    if global_batch_size % d:
        raise ValueError(f"a batch of {global_batch_size} rows does not divide the data axis "
                         f"of {d}")
    per = global_batch_size // d
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def _map(batch, fn):
    if isinstance(batch, dict):
        return {k: _map(v, fn) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(v, fn) for v in batch)
    return fn(batch)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of every leaf of a global batch (leading axis);
    raises where the rows do not divide 'data', as JAX's placement does."""
    return _map(batch, lambda x: x[process_local_batch_slice(mesh, len(x))])


def shard_batch_or_replicate(batch, mesh: Mesh):
    """Serving's placement: this rank's rows of each leaf whose rows divide
    'data', the whole leaf otherwise (a batch-1 generate: every data rank
    computes the same row)."""
    d = mesh.shape["data"]
    return _map(batch, lambda x: x[process_local_batch_slice(mesh, len(x))]
                if len(x) % d == 0 else x)


def local_rows(mesh: Optional[Mesh], n: int) -> slice:
    """The rows of an n-row batch this rank computes under
    `shard_batch_or_replicate`: all of them without a mesh or where n does
    not divide 'data'."""
    if mesh is None or n % mesh.shape["data"]:
        return slice(0, n)
    return process_local_batch_slice(mesh, n)


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh], n: int) -> torch.Tensor:
    """The n-row batch whose rows `local_rows(mesh, n)` this rank holds in
    `x`, gathered over 'data' onto every rank."""
    if mesh is None or mesh.data_group is None or n % mesh.shape["data"]:
        return x
    # int16 (waveforms) travels as int32: NCCL takes no int16
    y = x.to(mesh.comm_device(), torch.int32 if x.dtype == torch.int16 else x.dtype)
    out = [torch.empty_like(y) for _ in range(mesh.shape["data"])]
    dist.all_gather(out, y.contiguous(), group=mesh.data_group)
    return torch.cat(out).to(x.device, x.dtype)


def pad_rows(n: int, mesh: Optional[Mesh]) -> int:
    """n rounded up to a multiple of 'data'."""
    d = 1 if mesh is None else mesh.shape["data"]
    return -(-n // d) * d


def shard_latents_seq(latents, mesh=None):
    """Sequence parallelism's placement of a (B, T, ...) tensor: this rank's
    contiguous slab of T, by `model_index`, where 'model' divides T; the
    tensor whole where it does not, or without a mesh, or where 'model' is
    1 (JAX constrains only the axes the shape can honour).

    `UNet2DConditionModel(latent_sharder=functools.partial(
    shard_latents_seq, mesh=mesh))` runs the UNet on such slabs
    (`seq_mesh` reads the mesh back), with the parameters replicated
    (`shard_params(tp=False)`), never TP-sharded."""
    if mesh is None or mesh.shape["model"] == 1 or latents.shape[1] % mesh.shape["model"]:
        return latents
    return latents.narrow(1, *slab_span(latents.shape[1], mesh))


def slab_span(length: int, mesh: Mesh) -> Tuple[int, int]:
    """(first row, rows) of this rank's slab of `length` rows split over
    'model' (which divides it), in rank order."""
    n = length // mesh.shape["model"]
    return mesh.model_index * n, n


def seq_mesh(sharder) -> Optional[Mesh]:
    """The mesh over whose 'model' axis a latent sharder splits T, None where
    it splits nothing: a sharder is None or JAX's form,
    `functools.partial(shard_latents_seq, mesh=mesh)`. The port's modules
    exchange rows with the other ranks themselves, so they must know the
    mesh; any other callable raises TypeError."""
    if sharder is None:
        return None
    if not (isinstance(sharder, functools.partial) and sharder.func is shard_latents_seq):
        raise TypeError(f"latent_sharder {sharder!r}: the port takes "
                        "functools.partial(shard_latents_seq, mesh=mesh)")
    mesh = sharder.keywords.get("mesh", sharder.args[0] if sharder.args else None)
    return None if mesh is None or mesh.shape["model"] == 1 else mesh


# ---------------------------------------------------------------- collectives

def _all_reduce_(t: torch.Tensor, group, mesh: Mesh, op=None) -> torch.Tensor:
    """Sum `t` over `group` in place (or reduce it by `op`, a
    `dist.ReduceOp`). Under gloo a card's tensor is staged through the host:
    gloo's host algorithms take every dtype (bf16 too)."""
    op = dist.ReduceOp.SUM if op is None else op
    if mesh.backend == "gloo" and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=op, group=group)
    return t


def _gather_model(x: torch.Tensor, mesh: Mesh, kind: str) -> list:
    """Every model rank's `x` (equal shapes), in rank order, on x's device;
    counted in `mesh.seq_stats` under `kind`."""
    y = x.to(mesh.comm_device()).contiguous()
    parts = [torch.empty_like(y) for _ in range(mesh.shape["model"])]
    dist.all_gather(parts, y, group=mesh.model_group)
    mesh.seq_stats[kind] += 1
    mesh.seq_stats[f"{kind}_bytes"] += (len(parts) - 1) * y.numel() * y.element_size()
    return [p.to(x.device) for p in parts]


def _reduce_scatter_model(g: torch.Tensor, mesh: Mesh, dim: int, kind: str) -> torch.Tensor:
    """The sum over the model ranks of g (each rank's whole), cut along `dim`
    into slabs in rank order, this rank's slab kept: one reduce-scatter,
    staged as the gathers are; counted in `mesh.seq_stats` under `kind`."""
    parts = mesh.shape["model"]
    src = torch.stack(g.chunk(parts, dim)).to(mesh.comm_device())  # (parts, *slab), contiguous
    out = src.new_empty(src.shape[1:])
    dist.reduce_scatter_tensor(out.view(-1), src.view(-1), group=mesh.model_group)
    mesh.seq_stats[kind] += 1
    mesh.seq_stats[f"{kind}_bytes"] += (parts - 1) * out.numel() * out.element_size()
    return out.to(g.device)


class _GatherSeq(torch.autograd.Function):
    """The slabs gathered whole; backward, the reduce-scatter of the whole's
    partial gradients."""

    @staticmethod
    def forward(ctx, x, mesh, dim, kind):
        ctx.mesh, ctx.dim, ctx.kind = mesh, dim, kind
        return torch.cat(_gather_model(x, mesh, kind), dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter_model(g.contiguous(), ctx.mesh, ctx.dim, f"{ctx.kind}_grad"),
                None, None, None)


def gather_seq(x: torch.Tensor, mesh: Mesh, dim: int, kind: str = "gather") -> torch.Tensor:
    """The whole of a tensor whose slabs along `dim` the model ranks hold (in
    rank order, of equal lengths), on every model rank. Its backward sums
    the whole's partial gradients over the model ranks into each slab."""
    return _GatherSeq.apply(x, mesh, dim, kind)


class _Halo(torch.autograd.Function):
    """The neighbours' boundary rows (`halo_rows`); backward, each halo row's
    gradient added on the rank that owns the row."""

    @staticmethod
    def forward(ctx, x, mesh, above, below, dim):
        ctx.mesh, ctx.rows, ctx.dim, ctx.shape = mesh, (above, below), dim, x.shape
        n = x.shape[dim]
        edges = _gather_model(torch.cat([x.narrow(dim, 0, below),
                                         x.narrow(dim, n - above, above)], dim), mesh, "halo")
        i, parts = mesh.model_index, mesh.shape["model"]
        zeros = lambda rows: x.new_zeros(x.shape[:dim] + (rows,) + x.shape[dim + 1:])  # noqa: E731
        top = edges[i - 1].narrow(dim, below, above) if i > 0 else zeros(above)
        bottom = edges[i + 1].narrow(dim, 0, below) if i < parts - 1 else zeros(below)
        return top, bottom

    @staticmethod
    def backward(ctx, g_top, g_bottom):
        # the top rows were the previous rank's last `above`, the bottom the
        # next rank's first `below`: every rank sends both gradients back,
        # and the rows past the first and the last rank (zeros) have no owner
        (above, below), dim, mesh = ctx.rows, ctx.dim, ctx.mesh
        edges = _gather_model(torch.cat([g_top, g_bottom], dim), mesh, "halo_grad")
        i, parts = mesh.model_index, mesh.shape["model"]
        n = ctx.shape[dim]
        dx = g_top.new_zeros(ctx.shape)
        if i > 0:
            dx.narrow(dim, 0, below).add_(edges[i - 1].narrow(dim, above, below))
        if i < parts - 1:
            dx.narrow(dim, n - above, above).add_(edges[i + 1].narrow(dim, 0, above))
        return dx, None, None, None, None


def halo_rows(x: torch.Tensor, mesh: Mesh, above: int, below: int, dim: int = 2):
    """The rows a convolution of this rank's slab reads beyond it: the
    previous rank's last `above` rows and the next rank's first `below`
    rows along `dim`, zeros past the first and the last rank (the
    convolution's zero padding). One all-gather of every rank's edges, and
    one of their gradients backward."""
    n = x.shape[dim]
    if above > n or below > n:
        raise ValueError(f"halo of {above} / {below} rows over a slab of {n}")
    return _Halo.apply(x, mesh, above, below, dim)


class _PartialGrad(torch.autograd.Function):
    """Identity forward; the gradient divided by 'model' backward."""

    @staticmethod
    def forward(ctx, x, parts):
        ctx.parts = parts
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.parts, None


def partial_grad(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x unchanged, its gradient divided by 'model': where every model rank
    computes the same loss from a tensor, each rank's gradient of it is the
    true one, and this makes it the partial one of the gradient rule."""
    return _PartialGrad.apply(x, mesh.shape["model"])


def all_reduce_over_model_(t: torch.Tensor, mesh: Mesh, kind: str = "group_norm"):
    """Sum `t` over the model ranks in place (GroupNorm's partial sums of
    the slabs); counted in `mesh.seq_stats` under `kind`."""
    mesh.seq_stats[kind] += 1
    mesh.seq_stats[f"{kind}_bytes"] += (mesh.shape["model"] - 1) * t.numel() * t.element_size()
    return _all_reduce_(t, mesh.model_group, mesh)


def all_max_over_model_(t: torch.Tensor, mesh: Mesh):
    """The largest of `t` over the model ranks, in place (an int8
    convolution's per-sample amax of the slabs: the whole tensor's); counted
    in `mesh.seq_stats` as `int8_amax`."""
    mesh.seq_stats["int8_amax"] += 1
    mesh.seq_stats["int8_amax_bytes"] += (mesh.shape["model"] - 1) * t.numel() * t.element_size()
    return _all_reduce_(t, mesh.model_group, mesh, dist.ReduceOp.MAX)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient over 'model' backward.
    In front of a column-parallel layer, whose ranks each see part of the
    input's gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.mesh.model_group, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over 'model' forward; identity backward. After a
    row-parallel layer, whose ranks each hold a partial sum."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce_(x.contiguous().clone(), mesh.model_group, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    if mesh is None or mesh.model_group is None:
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    if mesh is None or mesh.model_group is None:
        return x
    return _ReduceFromModel.apply(x, mesh)


def all_reduce_grads(params, mesh: Optional[Mesh], bucket: int = 1 << 26,
                     seq: bool = False) -> None:
    """Replace every gradient by its mean over 'data', in flat buckets of at
    most `bucket` elements of one dtype (one collective a bucket). seq=True
    (sequence parallelism: parameters replicated over 'model', their
    gradients partial) also sums over 'model': one all-reduce over every
    rank, divided by the data size."""
    if mesh is None or mesh.size == 1 or (not seq and mesh.data_group is None):
        return
    group = None if seq else mesh.data_group  # None: every rank
    grads = [p.grad for p in params if p.grad is not None]
    d = mesh.shape["data"]
    i = 0
    while i < len(grads):
        j, n = i, 0
        while j < len(grads) and grads[j].dtype == grads[i].dtype and (
                j == i or n + grads[j].numel() <= bucket):
            n += grads[j].numel()
            j += 1
        flat = _all_reduce_(torch.cat([g.reshape(-1) for g in grads[i:j]]), group,
                            mesh).div_(d)
        k = 0
        for g in grads[i:j]:
            g.copy_(flat[k:k + g.numel()].view_as(g))
            k += g.numel()
        i = j


def mean_over_data(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A (detached) scalar's mean over 'data': the global loss of equal-sized
    data ranks."""
    if mesh is None or mesh.data_group is None:
        return x
    return _all_reduce_(x.detach().clone(), mesh.data_group, mesh) / mesh.shape["data"]
