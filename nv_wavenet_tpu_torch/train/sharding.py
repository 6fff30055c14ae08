"""Tensor parallelism (the 'model' axis) and sequence parallelism (the 'seq'
axis) of the port's trainer: the mesh's process groups, the collectives as
autograd Functions, and the full <-> per-rank carry of the parameters.

The port's counterpart of the sharding rules of `nv_wavenet_tpu/train/
trainer.py` (`make_mesh`, `batch_partition_spec`, `param_partition_spec`,
:111-156).  There XLA inserts every collective from the annotations; here
each one is code:

  * the mesh: one process a position, rank (d * model + m) * seq + s, so
    'data' is outermost and spans hosts.  Each rank belongs to a model
    group (its (d, s) peers), a seq group (its (d, m) peers) and a data x
    seq group (its m peers), which reduces the gradients (DDP).
  * TP, Megatron style: `cond_layer` and every `skip_i` are column
    parallel (their output channels split over 'model'), `conv_out` row
    parallel (its input S split); everything else is replicated.
    `copy_to_model` (identity forward, the gradient all-reduced backward)
    feeds a column-parallel conv a replicated input: the upsampled mel and
    each layer's gated activations.  `reduce_from_model` (all-reduce
    forward, identity backward) sums conv_out's partial products.
    `gather_model` joins the conditioning's shards on their channels;
    every model rank then computes the same downstream, so its backward
    takes this rank's slice of the gradient (a reduce would count it
    `model` times).
  * SP: audio time split over 'seq', the mel whole on every rank (each seq
    rank upsamples all of it and keeps its window).  `halo_pad` puts the
    previous seq rank's last d steps in front of a dilated conv's input
    (zeros on seq rank 0) and sends the halo's gradient back to be added to
    them; `shift_right` is the next-sample shift across the same seams.
  * every collective is built from `broadcast` and `all_reduce`, the two
    that gloo takes on CUDA tensors as NCCL does: gloo on the CPU and for
    processes sharing one card (NCCL refuses two ranks on one card), NCCL
    across cards (`parallel.mesh.initialize_multihost` chooses;
    `tools/train_mesh_probe.py` holds the meshes on NCCL).  An all-gather
    is one broadcast from each member.  A collective that fails raises.
    The backward's model-group all-reduces run while DDP's bucket
    all-reduces over the data x seq group may still be in flight on
    another communicator; every rank issues both in one order.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from nv_wavenet_tpu_torch.utils import tracing

AXES = ("data", "model", "seq")


class TrainMesh:
    """A data x model x seq mesh over the processes of the default process
    group (whose size must be data * model * seq), with this rank's
    coordinates and groups.  Every rank must build it, in the same order
    as every other mesh: the groups are made collectively.  Each collective
    is a span and two counters of `utils/tracing.py` (`_count`)."""

    def __init__(self, data: int, model: int = 1, seq: int = 1):
        for name, n in zip(AXES, (data, model, seq)):
            if not isinstance(n, int) or n < 1:
                raise ValueError(f"{name}={n!r}: each mesh axis is a "
                                 f"positive int")
        self.data, self.model, self.seq = data, model, seq
        self.rank, self.size = 0, 1
        if dist.is_available() and dist.is_initialized():
            self.rank, self.size = dist.get_rank(), dist.get_world_size()
        if self.size != data * model * seq:
            raise ValueError(
                f"data={data} x model={model} x seq={seq} = "
                f"{data * model * seq} mesh positions, but the process "
                f"group has {self.size} process(es)")
        r = self.rank
        self.data_rank = r // (model * seq)
        self.model_rank = (r // seq) % model
        self.seq_rank = r % seq

        def pos(d, m, s):
            return (d * model + m) * seq + s

        members = {
            "model": [[pos(d, m, s) for m in range(model)]
                      for d in range(data) for s in range(seq)],
            "seq": [[pos(d, m, s) for s in range(seq)]
                    for d in range(data) for m in range(model)],
            "data_seq": [[pos(d, m, s) for d in range(data)
                          for s in range(seq)] for m in range(model)]}
        self.ranks: Dict[str, List[int]] = {}
        self.groups: Dict[str, object] = {}
        for axis, lists in members.items():
            for ranks in lists:
                # new_group is collective over the whole world: every rank
                # makes every group of more than one member, in one order
                group = dist.new_group(ranks) if len(ranks) > 1 else None
                if r in ranks:
                    self.ranks[axis], self.groups[axis] = ranks, group

    def __repr__(self) -> str:
        return (f"TrainMesh(data={self.data}, model={self.model}, "
                f"seq={self.seq}; rank {self.rank} at (d={self.data_rank}, "
                f"m={self.model_rank}, s={self.seq_rank}))")

    @staticmethod
    def _count(kind: str, t: torch.Tensor):
        """The span of one collective (`nvw:mesh.<kind>`), its call and its
        bytes counted (`mesh.<kind>`, `mesh.<kind>.bytes`)."""
        tracing.count("mesh." + kind, 1)
        tracing.count("mesh." + kind + ".bytes", t.numel() * t.element_size())
        return tracing.span("mesh." + kind)

    def all_reduce(self, t: torch.Tensor, axis: str, kind: str) -> None:
        """Sum `t` in place over this rank's `axis` group."""
        if len(self.ranks[axis]) > 1:
            with self._count(kind, t):
                dist.all_reduce(t, group=self.groups[axis])

    def all_gather(self, t: torch.Tensor, axis: str,
                   kind: str) -> List[torch.Tensor]:
        """Every member's `t` (all of one shape), in the group's order: one
        broadcast from each member."""
        ranks = self.ranks[axis]
        if len(ranks) == 1:
            return [t]
        t = t.contiguous()
        out = []
        with self._count(kind, t):
            for src in ranks:
                buf = t if src == self.rank else torch.empty_like(t)
                dist.broadcast(buf, src=src, group=self.groups[axis])
                out.append(buf)
        return out

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of a scalar over every rank (model peers hold equal
        values, so it is the mean over the data x seq positions)."""
        if self.size == 1:
            return t
        t = t.clone()
        with self._count("loss", t):
            dist.all_reduce(t)
        return t / self.size


# ---------------------------------------------------------------------------
# the rules: which parameters are sharded, and how a batch is split
# ---------------------------------------------------------------------------

def param_partition(name: str) -> Optional[int]:
    """The dim of parameter `name` (a `WaveNetTrain` state_dict key) split
    over 'model', None where it is replicated (`param_partition_spec`):
    cond_layer's and each skip conv's output channels, conv_out's input S
    (its product contracts over the shards, then an all-reduce)."""
    if name.startswith(("cond_layer.", "skip_layers.")):
        return 0
    if name == "conv_out.weight":
        return 1
    return None


def check_shapes(net, model: int, seq: int,
                 segment_length: Optional[int] = None) -> None:
    """Raise ValueError, with the reason, where the mesh cannot shard
    `net` (a `WaveNetTrain`) or a segment of `segment_length` samples."""
    R, S, L = net.n_residual_channels, net.n_skip_channels, net.n_layers
    if (2 * R * L) % model:
        raise ValueError(f"model={model} must divide the 2RL = {2 * R * L} "
                         f"conditioning channels that cond_layer shards")
    if S % model:
        raise ValueError(f"model={model} must divide the S = {S} skip "
                         f"channels that the skip convs and conv_out shard")
    if segment_length is None or seq == 1:
        return
    if segment_length % seq:
        raise ValueError(f"seq={seq} must divide the segment of "
                         f"{segment_length} samples")
    if segment_length // seq < net.max_dilation:
        raise ValueError(
            f"segment {segment_length} / seq {seq} = "
            f"{segment_length // seq} samples a rank < max_dilation "
            f"{net.max_dilation}: a dilated conv's halo would span two ranks")


def batch_partition(mesh: TrainMesh, mel: torch.Tensor,
                    audio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's part of its data rank's batch (mel [b, F, n_mel], audio
    [b, T]): audio's time window T/seq * s ..., the mel whole.

    JAX's `batch_partition_spec` leaves the mel unsharded when its frame
    count does not divide 'seq', which holds for every mel the data
    pipeline makes from a segment that divides seq x hop (T/hop + 1
    frames; 81 at configs/config.json).  Where it does divide, XLA shards
    the mel and exchanges the transposed conv's overlap; the port keeps it
    whole there too, the same values, since each seq rank upsamples all of
    it."""
    T = audio.shape[1]
    if T % mesh.seq:
        raise ValueError(f"seq={mesh.seq} must divide the audio's {T} "
                         f"samples")
    n = T // mesh.seq
    return mel, audio[:, mesh.seq_rank * n:(mesh.seq_rank + 1) * n]


# ---------------------------------------------------------------------------
# the collectives and their gradients
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.mesh.all_reduce(g, "model", "copy_to_model (bwd)")
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        x = x.contiguous().clone()
        mesh.all_reduce(x, "model", "reduce_from_model")
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[1]
        return torch.cat(mesh.all_gather(x, "model", "gather_model"), 1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.model_rank * ctx.width
        return g[:, lo:lo + ctx.width].contiguous(), None


class _HaloPad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, d, mesh):
        ctx.d, ctx.mesh = d, mesh
        tails = mesh.all_gather(x[..., -d:], "seq", "halo")
        s = mesh.seq_rank
        prev = tails[s - 1] if s > 0 else torch.zeros_like(tails[0])
        return torch.cat([prev, x], -1)

    @staticmethod
    def backward(ctx, g):
        d, mesh = ctx.d, ctx.mesh
        gx = g[..., d:].clone()
        halos = mesh.all_gather(g[..., :d], "seq", "halo (bwd)")
        s = mesh.seq_rank
        if s + 1 < mesh.seq:
            gx[..., -d:] += halos[s + 1]
        return gx, None, None


def copy_to_model(x: torch.Tensor, mesh: Optional[TrainMesh]):
    """x, the input of a column-parallel conv; its gradient is summed over
    the model group."""
    if mesh is None or mesh.model == 1:
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Optional[TrainMesh]):
    """x summed over the model group (a row-parallel conv's partial
    products); the gradient passes unchanged."""
    if mesh is None or mesh.model == 1:
        return x
    return _ReduceFromModel.apply(x, mesh)


def gather_model(x: torch.Tensor, mesh: Optional[TrainMesh]):
    """[b, C, t] shards -> [b, model * C, t] in model-rank order; the
    gradient's backward is this rank's slice."""
    if mesh is None or mesh.model == 1:
        return x
    return _GatherModel.apply(x, mesh)


def halo_pad(x: torch.Tensor, d: int, mesh: Optional[TrainMesh]):
    """[..., t] -> [..., d + t]: a causal conv's left padding, the previous
    seq rank's last d steps (zeros on the first), F.pad(x, (d, 0)) without
    a seq axis."""
    if mesh is None or mesh.seq == 1:
        return F.pad(x, (d, 0))
    if d > x.shape[-1]:
        raise ValueError(f"a halo of {d} steps spans more than one rank's "
                         f"{x.shape[-1]}")
    return _HaloPad.apply(x, d, mesh)


def shift_right(x: torch.Tensor, mesh: Optional[TrainMesh]):
    """[..., t] moved one step later: the first step the previous seq
    rank's last (zero on the first rank), the last step dropped."""
    if mesh is None or mesh.seq == 1:
        return F.pad(x[..., :-1], (1, 0))
    return halo_pad(x, 1, mesh)[..., :-1]


# ---------------------------------------------------------------------------
# the full <-> per-rank carry
# ---------------------------------------------------------------------------

def shard_state_dict(full: Mapping[str, torch.Tensor], model: int,
                     model_rank: int) -> Dict[str, torch.Tensor]:
    """Model rank `model_rank`'s shard of a full state dict (copies)."""
    out = {}
    for k, v in full.items():
        dim = param_partition(k)
        if dim is not None:
            n = v.shape[dim] // model
            v = v.narrow(dim, model_rank * n, n)
        out[k] = v.clone()
    return out


def gather_state_dict(shards: Sequence[Mapping[str, torch.Tensor]]
                      ) -> Dict[str, torch.Tensor]:
    """The full state dict from every model rank's shard, in rank order."""
    out = {}
    for k, v in shards[0].items():
        dim = param_partition(k)
        out[k] = v if dim is None else torch.cat([s[k] for s in shards], dim)
    return out


def collect_state_dict(mesh: TrainMesh, local: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """The full tensors from this rank's shards of tensors keyed like a
    state dict (parameters, their gradients or Adam's moments): a
    collective over the model group, which every rank must call."""
    if mesh.model == 1:
        return dict(local)
    parts = {k: (mesh.all_gather(v, "model", "collect")
                 if param_partition(k) is not None else None)
             for k, v in local.items()}
    return gather_state_dict([{k: local[k] if p is None else p[m]
                               for k, p in parts.items()}
                              for m in range(mesh.model)])


def shard_module(net, mesh: TrainMesh) -> None:
    """Replace `net`'s (a full `WaveNetTrain`'s) sharded convs by this model
    rank's shards of them, in place; parameter order is kept."""
    check_shapes(net, mesh.model, mesh.seq)
    if mesh.model == 1:
        return
    local = shard_state_dict(net.state_dict(), mesh.model, mesh.model_rank)
    n, R, S, L = (mesh.model, net.n_residual_channels, net.n_skip_channels,
                  net.n_layers)
    net.cond_layer = nn.Conv1d(net.n_cond_channels, 2 * R * L // n, 1)
    net.skip_layers = nn.ModuleList(nn.Conv1d(R, S // n, 1)
                                    for _ in range(L))
    net.conv_out = nn.Conv1d(S // n, net.n_out_channels, 1, bias=False)
    net.model_parallel = n
    net.load_state_dict(local)
