"""The ``(data, model)`` mesh of a run over several devices (the JAX
package's ``parallel/mesh.py``).

One device is one process (``parallel/multihost.py``), so the mesh is a
two-dimensional ``DeviceMesh`` over the processes of the run, the model
axis fastest: process ``r`` sits at ``(r // model, r % model)``.

* :func:`make_mesh`: the mesh, with the JAX package's ``data=-1`` rule
  and errors;
* :func:`shard_batch`: this process's rows of a global batch on the data
  axis, the split ``data.BucketedLoader(process_index=...,
  process_count=...)`` makes (the processes of one data index take the
  same rows);
* :func:`param_specs`: the placement of every parameter, keyed by its
  (HF) name: the JAX package's rules (``_PARAM_RULES``), column-parallel
  q, k, v and FFN up-projection, row-parallel output projection and FFN
  down-projection on the model axis, everything else replicated; with
  ``fsdp`` its data-axis dimension too (``_fsdp_augment``);
* :func:`shard_tree`: a model placed on the mesh. The model axis first
  (tensor parallelism, ``parallel/tensor.py``): each process keeps its
  slice of the split parameters, and the attention and FFN sublayers run
  on their local heads and hidden units between the model axis's
  collectives, the residual stream split over time too when the
  encoder's ``activation_partition`` names the model axis (sequence
  parallelism). Then the data axis: ``DistributedDataParallel`` over the
  data axis's processes (gradients averaged over them in the backward), or
  with ``fsdp=True`` FSDP2's ``fully_shard`` over the data sub-mesh (each
  transformer layer a group, the rest one group at the root: parameters
  all-gathered before use, gradients reduce-scattered, the optimizer's
  state sharded with the parameters);
* :func:`full_state_dict` / :func:`load_full_state_dict` and the
  optimizer-state pair: a single device's tensors, gathered over both
  axes, and sharded back.

The numerics are a single device's on the global batch: the masked means
and the SpecAugment draws of a training forward read the global batch
(``parallel/global_batch.py``), the averaged gradient is the global
batch's, and the model axis's collectives sum what the unsharded products
sum.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from aptai_tpu_torch.parallel.multihost import is_primary, process_count
from aptai_tpu_torch.parallel.tensor import ModelAxis

DATA_AXIS = "data"
MODEL_AXIS = "model"

# The JAX package keeps leaves below this many elements replicated under
# FSDP. FSDP2 shards every parameter of a group and has no per-parameter
# replication, so here the floor also decides the groups: a module whose
# parameters are all smaller is left to its parent's group rather than
# made a group of its own, and a parameter below it is sharded on its
# first dimension. Memory only; the numerics are the same.
FSDP_MIN_SIZE = 65_536

# the model methods besides forward that training and evaluation call (the
# loss adapters from cached features, APTAI's predict); neither calls
# another, and FSDP2 all-gathers the root group's parameters around each
FSDP_FORWARD_METHODS = ("train_from_features", "predict")

# the JAX package's tensor-parallel rules (``parallel/mesh.py::
# _PARAM_RULES``) on this package's modules: the dimension of each split
# parameter, in nn.Linear's (out, in) layout (the transpose of the JAX
# kernel's). The fused q/k/v product stays replicated, as there.
COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "intermediate_dense")
ROW_PARALLEL = ("out_proj", "output_dense")


def make_mesh(data: int = -1, model: int = 1, device: Optional[str] = None):
    """The ``(data, model)`` mesh over the run's processes, a
    ``DeviceMesh`` with the dimensions ``"data"`` and ``"model"``, the
    model axis fastest; ``data=-1`` takes every process. ``None`` when
    this process runs alone (no process group): there is nothing to
    place, and the step is the single-device one. ``device``: the kind of
    device the processes compute on, the card under NCCL and the CPU under
    gloo unless named (``"cuda"`` under gloo: processes sharing a card).

    Raises the JAX package's ``ValueError`` when the processes do not
    divide by ``model`` or the mesh needs more than there are;
    ``NotImplementedError`` for a mesh over part of the processes."""
    n = process_count()
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs more than {n} devices")
    if data * model != n:
        raise NotImplementedError(
            f"a {data}x{model} mesh in a run of {n} processes; every "
            "process takes a place on the mesh (data=-1)")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def replicated(mesh) -> Tuple:
    """The DTensor placements of a tensor every process holds whole."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in range(mesh.ndim))


def batch_sharding(mesh) -> Tuple:
    """The DTensor placements of a batch split on its leading dimension
    over the data axis (and whole on the model axis)."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0),) + tuple(Replicate() for _ in range(mesh.ndim - 1))


def axis_size(mesh, axis: str) -> int:
    """The number of processes on ``axis`` of ``mesh`` (1 without one)."""
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_device(mesh) -> torch.device:
    """The device this process drives on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(mesh, batch):
    """This process's rows ``[r·B/N, (r+1)·B/N)`` of the global batch
    ``batch`` (a dict of arrays or tensors with the batch leading), ``r``
    its index on the data axis of ``mesh`` and ``N`` the axis's size (the
    processes of one data index, which differ on the model axis, take the
    same rows); the batch as it is without a mesh. A batch that does not
    divide raises ``ValueError`` (the JAX package replicates it with a
    warning)."""
    if mesh is None:
        return batch
    n = axis_size(mesh, DATA_AXIS)
    r = mesh.get_local_rank(DATA_AXIS)
    sizes = {len(v) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"batch keys disagree on the batch size: {sizes}")
    b = sizes.pop()
    if b % n:
        raise ValueError(f"batch {b} does not divide over the {n} "
                         "processes of the data axis")
    lo, hi = r * (b // n), (r + 1) * (b // n)
    return {k: v[lo:hi] for k, v in batch.items()}


def frozen_parameter_names(model: nn.Module) -> List[str]:
    """Names of ``model``'s parameters that require a gradient yet never get
    one in a training forward: the feature extractor of an encoder built
    with ``freeze_feature_encoder`` (run under ``no_grad``), and
    SpecAugment's mask embedding when no time mask is drawn."""
    from aptai_tpu_torch.models.wav2vec2 import Wav2Vec2Model

    names = []
    for prefix, m in model.named_modules():
        if not isinstance(m, Wav2Vec2Model):
            continue
        dot = prefix + "." if prefix else ""
        if m.freeze_feature_encoder:
            names += [dot + "feature_extractor." + n for n, p in
                      m.feature_extractor.named_parameters()
                      if p.requires_grad]
        if hasattr(m, "masked_spec_embed") and m.cfg.mask_time_prob == 0:
            names.append(dot + "masked_spec_embed")
    return names


def _layer_groups(model: nn.Module, min_size: int) -> Iterable[nn.Module]:
    from aptai_tpu_torch.models.wav2vec2 import EncoderLayer

    for m in model.modules():
        if isinstance(m, EncoderLayer) and sum(
                p.numel() for p in m.parameters()) >= min_size:
            yield m


def _split_modules(model: nn.Module):
    """``(prefix, module, {parameter: dim})`` of the modules the model axis
    splits: each attention (a fused q/k/v product stays whole) and each
    FFN."""
    from aptai_tpu_torch.models.wav2vec2 import FeedForward, SelfAttention

    for prefix, m in model.named_modules():
        if not isinstance(m, (SelfAttention, FeedForward)):
            continue
        dims = {}
        for name, _ in m.named_children():
            if name in COLUMN_PARALLEL:
                dims[f"{name}.weight"] = 0
                dims[f"{name}.bias"] = 0
            elif name in ROW_PARALLEL:
                dims[f"{name}.weight"] = 1
        yield prefix, m, dims


def model_parallel_dims(model: nn.Module) -> Dict[str, int]:
    """``{parameter name: dimension}`` of ``model``'s parameters the model
    axis splits (the JAX package's ``_PARAM_RULES``, in nn.Linear's
    layout); every other parameter is replicated on it."""
    out = {}
    for prefix, _, dims in _split_modules(model):
        dot = prefix + "." if prefix else ""
        out.update({dot + k: d for k, d in dims.items()})
    return out


def _fsdp_dim(shape, taken: Optional[int], n_data: int) -> Optional[int]:
    """The JAX package's ``_fsdp_augment`` on this package's layout: the
    largest dimension not split by the model axis that divides over the
    data axis (a tie goes to the later one: the JAX kernels' dimensions
    are these in reverse order, and the JAX rule takes the first)."""
    free = [i for i in range(len(shape)) if i != taken
            and shape[i] % n_data == 0]
    if not free:
        return None
    return max(free, key=lambda i: (shape[i], i))


def param_specs(model: nn.Module, data: int = 1, fsdp: bool = False,
                fsdp_min_size: int = FSDP_MIN_SIZE
                ) -> Dict[str, Tuple[Optional[str], ...]]:
    """The placement of each of ``model``'s (unsharded) parameters on a
    mesh whose data axis holds ``data`` processes, keyed by name: per
    dimension the mesh axis that splits it, or None. The JAX package's
    ``param_shardings`` (``_PARAM_RULES``, then ``_fsdp_augment``) in
    nn.Linear's (out, in) and nn.Conv1d's (out, in, k) layouts, which
    reverse the JAX kernels' dimensions; as there, a rule's model-axis
    dimension is named whatever the axis's size (one process: no split).
    With ``fsdp`` on a data axis of several processes a parameter of at
    least ``fsdp_min_size`` elements is split on the data axis too, on its
    largest other dimension that divides; FSDP2 splits the smaller ones on
    their first dimension (:func:`fsdp_placements`), which this table
    does not show, as the JAX package replicates them."""
    split = model_parallel_dims(model)
    out = {}
    for name, p in model.named_parameters():
        axes: List[Optional[str]] = [None] * p.dim()
        dim = split.get(name)
        if dim is not None:
            axes[dim] = MODEL_AXIS
        if fsdp and data > 1 and p.numel() >= fsdp_min_size:
            d = _fsdp_dim(p.shape, dim, data)
            if d is not None:
                axes[d] = DATA_AXIS
        out[name] = tuple(axes)
    return out


def fsdp_placements(model: nn.Module, data: int, fsdp_min_size: int):
    """``{id(parameter): Shard(dim)}`` for FSDP2 over a data axis of
    ``data`` processes, from :func:`param_specs` of the unsharded
    ``model``: its data dimension, or the first for a parameter the JAX
    package replicates (FSDP2 shards every parameter of a group)."""
    from torch.distributed.tensor import Shard

    specs = param_specs(model, data, fsdp=True, fsdp_min_size=fsdp_min_size)
    out = {}
    for name, p in model.named_parameters():
        axes = specs[name]
        out[id(p)] = Shard(axes.index(DATA_AXIS) if DATA_AXIS in axes
                           else 0)
    return out


def _sequence_parallel(model: nn.Module) -> bool:
    from aptai_tpu_torch.models.wav2vec2 import Encoder

    specs = {m.cfg.activation_partition for m in model.modules()
             if isinstance(m, Encoder)}
    return any(s is not None and s[1] == MODEL_AXIS for s in specs)


def split_model_axis(model: nn.Module, mesh) -> nn.Module:
    """Place ``model`` on the model axis of ``mesh`` in place: each split
    parameter keeps this process's slice (the same ``Parameter`` object, so
    an optimizer built over the model still holds it), and the encoder's
    attention, FFN, layers and stack run their sublayers between the
    axis's collectives. A model already placed, or a model axis of one
    process, leaves the model as it is."""
    from aptai_tpu_torch.models.wav2vec2 import Encoder, EncoderLayer

    n = axis_size(mesh, MODEL_AXIS)
    if n == 1:
        return model
    axis = ModelAxis(mesh.get_group(MODEL_AXIS),
                     mesh.get_local_rank(MODEL_AXIS), n,
                     sequence=_sequence_parallel(model))
    for _, m, dims in _split_modules(model):
        if m.model_axis is not None:
            continue
        with torch.no_grad():
            for name, dim in dims.items():
                p = m.get_parameter(name)
                p.data = p.data.narrow(dim, axis.shard(p.shape[dim]).start,
                                       p.shape[dim] // axis.size).clone()
        m.model_axis = axis
    for m in model.modules():
        if isinstance(m, (Encoder, EncoderLayer)):
            m.model_axis = axis
    return model


def placed_model_axis(model: nn.Module) -> Optional[ModelAxis]:
    """The :class:`ModelAxis` ``model`` was placed on (None: replicated)."""
    for _, m, _ in _split_modules(model):
        return m.model_axis
    return None


def shard_tree(model: nn.Module, mesh, fsdp: bool = False,
               fsdp_min_size: int = FSDP_MIN_SIZE) -> nn.Module:
    """``model`` placed on ``mesh`` (moved to its device): first on the
    model axis (:func:`split_model_axis`), then on the data axis:

    * ``fsdp=False``: a ``DistributedDataParallel`` of it over the data
      axis's processes, whose backward averages the gradients over them.
      The parameters that never get a gradient
      (:func:`frozen_parameter_names`) are left out of its buckets, so no
      ``find_unused_parameters`` pass is needed;
    * ``fsdp=True``: ``model`` itself, sharded in place by ``fully_shard``
      over the data sub-mesh, each parameter on the dimension
      :func:`fsdp_placements` gives: every transformer layer a group (one
      with fewer than ``fsdp_min_size`` parameters joins the root's), then
      the root; the methods of ``FSDP_FORWARD_METHODS`` it has gather the
      root's parameters as ``forward`` does. Build its optimizer after
      this call (the parameters become sharded ``DTensor``s).

    Without a mesh, ``model`` as it is."""
    if mesh is None:
        return model
    model = model.to(mesh_device(mesh))
    n_data = axis_size(mesh, DATA_AXIS)
    placements = (fsdp_placements(model, n_data, fsdp_min_size)
                  if fsdp else None)
    split_model_axis(model, mesh)
    if not fsdp:
        from torch.nn.parallel import DistributedDataParallel

        DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
            model, frozen_parameter_names(model))
        device_ids = ([torch.cuda.current_device()]
                      if mesh.device_type == "cuda" else None)
        return DistributedDataParallel(
            model, device_ids=device_ids, broadcast_buffers=False,
            process_group=mesh.get_group(DATA_AXIS))
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)

    data_mesh = mesh[DATA_AXIS]

    def place(p):
        return placements[id(p)]

    for layer in list(_layer_groups(model, fsdp_min_size)):
        fully_shard(layer, mesh=data_mesh, shard_placement_fn=place)
    fully_shard(model, mesh=data_mesh, shard_placement_fn=place)
    for name in FSDP_FORWARD_METHODS:
        if callable(getattr(model, name, None)):
            register_fsdp_forward_method(model, name)
    return model


def is_fsdp(model: nn.Module) -> bool:
    """True for a module sharded by :func:`shard_tree` (``fsdp=True``)."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def _whole(t: torch.Tensor, dim: Optional[int],
           axis: Optional[ModelAxis]) -> torch.Tensor:
    """A single device's tensor from this process's part: all-gathered on
    the data axis (an FSDP ``DTensor``) and on the model axis (``dim``).
    A collective: every process calls it."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    if dim is not None and axis is not None:
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(axis.size)]
        dist.all_gather(parts, t, group=axis.group)
        t = torch.cat(parts, dim)
    return t


def gather_full(model: nn.Module, tensors: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """A single device's tensors from this process's parts of tensors
    shaped like ``model``'s parameters and keyed by their names (its state
    dict, its gradients, Adam's moments), gathered over the mesh, on every
    process (a collective: every process calls it)."""
    axis, dims = placed_model_axis(model), model_parallel_dims(model)
    return {k: _whole(v, dims.get(k), axis) for k, v in tensors.items()}


def _own_slice(t: torch.Tensor, dim: Optional[int],
               axis: Optional[ModelAxis]) -> torch.Tensor:
    if dim is None or axis is None:
        return t
    return t.narrow(dim, axis.shard(t.shape[dim]).start,
                    t.shape[dim] // axis.size)


def _placed(model: nn.Module) -> bool:
    return is_fsdp(model) or placed_model_axis(model) is not None


def full_state_dict(model: nn.Module) -> Optional[dict]:
    """``model``'s state dict as a single device holds it: gathered over the
    mesh from a placed model (a collective: every process calls it) and
    returned on the primary only, on its host (``{}`` elsewhere); an
    unplaced model's ``state_dict()`` as it is."""
    if not _placed(model):
        return model.state_dict()
    axis = placed_model_axis(model)
    dims = model_parallel_dims(model)
    primary = is_primary()
    out = {}
    for name, t in model.state_dict().items():
        t = _whole(t, dims.get(name), axis)
        if primary:
            out[name] = t.detach().cpu()
    return out


def full_optimizer_state(model: nn.Module, optimizer) -> dict:
    """``optimizer``'s state keyed by ``model``'s parameter names,
    ``{name: {"step", "exp_avg", ...}}``, a single device's tensors:
    gathered over the mesh to the primary's host from a placed model (a
    collective; ``{}`` elsewhere), by reference from an unplaced one."""
    names = {id(p): n for n, p in model.named_parameters()}
    owned = [p for g in optimizer.param_groups for p in g["params"]
             if optimizer.state.get(p)]
    if not _placed(model):
        return {names[id(p)]: optimizer.state[p] for p in owned}
    axis = placed_model_axis(model)
    dims = model_parallel_dims(model)
    primary = is_primary()
    out = {}
    for p in owned:
        name = names[id(p)]
        state = {}
        for k, v in optimizer.state[p].items():
            if torch.is_tensor(v) and v.dim() > 0:
                v = _whole(v, dims.get(name), axis)
            elif hasattr(v, "full_tensor"):
                v = v.full_tensor()
            if primary:
                state[k] = v.detach().cpu() if torch.is_tensor(v) else v
        if primary:
            out[name] = state
    return out


def load_full_state_dict(model: nn.Module, state_dict) -> None:
    """Load a single device's state dict into ``model``, keeping this
    process's slices on a placed model (every process passes the same
    dict)."""
    axis = placed_model_axis(model)
    if axis is not None:
        dims = model_parallel_dims(model)
        state_dict = {k: _own_slice(v, dims.get(k), axis)
                      for k, v in state_dict.items()}
    if not is_fsdp(model):
        model.load_state_dict(state_dict)
        return
    from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                         set_model_state_dict)

    set_model_state_dict(model, state_dict, options=StateDictOptions(
        full_state_dict=True))


def full_shapes(model: nn.Module) -> Dict[str, torch.Size]:
    """A single device's shape of each of ``model``'s parameters."""
    axis = placed_model_axis(model)
    dims = model_parallel_dims(model) if axis is not None else {}
    out = {}
    for name, p in model.named_parameters():
        shape = list(p.shape)
        if name in dims:
            shape[dims[name]] *= axis.size
        out[name] = torch.Size(shape)
    return out


def load_full_optimizer_state(model: nn.Module, optimizer,
                              torch_state_dict) -> None:
    """Load an optimizer ``state_dict`` of a single device's tensors (its
    ``state`` keyed by index, as ``optimizer.state_dict()`` gives it) into
    ``optimizer``, keeping this process's slices on a placed model."""
    axis = placed_model_axis(model)
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for g in optimizer.param_groups
             for p in g["params"]]
    if axis is not None:
        dims = model_parallel_dims(model)
        state = {}
        for i, v in torch_state_dict["state"].items():
            dim = dims.get(order[i])
            state[i] = {k: (_own_slice(t, dim, axis)
                            if torch.is_tensor(t) and t.dim() > 0 else t)
                        for k, t in v.items()}
        torch_state_dict = {**torch_state_dict, "state": state}
    if not is_fsdp(model):
        optimizer.load_state_dict(torch_state_dict)
        return
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, set_optimizer_state_dict)

    groups = []
    for g, saved in zip(optimizer.param_groups,
                        torch_state_dict["param_groups"]):
        groups.append({**saved, "params": [names[id(p)]
                                           for p in g["params"]]})
    state = {order[i]: v for i, v in torch_state_dict["state"].items()}
    set_optimizer_state_dict(model, optimizer, {
        "state": state, "param_groups": groups},
        options=StateDictOptions(full_state_dict=True))
