"""The data axis of a run over several devices (the data-parallel and FSDP
half of the JAX package's ``parallel/mesh.py``).

One device is one process (``parallel/multihost.py``), so the mesh is a
``DeviceMesh`` over the processes of the run:

* :func:`make_mesh`: the ``(data, model)`` mesh with the JAX package's
  ``data=-1`` rule and errors; the model axis (tensor parallelism) is not
  implemented yet, so ``model > 1`` raises;
* :func:`shard_batch`: this process's rows of a global batch, the split
  ``data.BucketedLoader(process_index=..., process_count=...)`` makes;
* :func:`shard_tree`: a model placed on the data axis: replicated under
  ``DistributedDataParallel`` (gradients averaged over the axis in the
  backward), or, with ``fsdp=True``, sharded by FSDP2's ``fully_shard``
  (each transformer layer a group, the rest one group at the root:
  parameters all-gathered before use, gradients reduce-scattered, and the
  optimizer's state sharded with the parameters).

The numerics are a single device's on the global batch: the masked means
and the SpecAugment draws of a training forward read the global batch
(``parallel/global_batch.py``), and the averaged gradient is the global
batch's.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from aptai_tpu_torch.parallel.multihost import process_count

DATA_AXIS = "data"
MODEL_AXIS = "model"

# The JAX package keeps leaves below this many elements replicated under
# FSDP. FSDP2 shards every parameter of a group on its first dimension and
# has no per-parameter replication, so here the floor is the size of a
# group: a module whose parameters are all smaller is left to its parent's
# group rather than made a group of its own. Memory only; the numerics are
# the same.
FSDP_MIN_SIZE = 65_536

# the model methods besides forward that training and evaluation call (the
# loss adapters from cached features, APTAI's predict); neither calls
# another, and FSDP2 all-gathers the root group's parameters around each
FSDP_FORWARD_METHODS = ("train_from_features", "predict")


def make_mesh(data: int = -1, model: int = 1):
    """The ``(data, model)`` mesh over the run's processes, a
    ``DeviceMesh`` with one ``"data"`` dimension; ``data=-1`` takes every
    process. ``None`` when this process runs alone (no process group):
    there is nothing to place, and the step is the single-device one.

    Raises the JAX package's ``ValueError`` when the processes do not
    divide by ``model`` or the mesh needs more than there are;
    ``NotImplementedError`` for ``model > 1`` and for a mesh over part of
    the processes."""
    n = process_count()
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs more than {n} devices")
    if model > 1:
        raise NotImplementedError(
            "the model axis (tensor parallelism) is not implemented yet "
            "(ROADMAP Queue 1 item 8e-ii); use model=1")
    if data != n:
        raise NotImplementedError(
            f"a {data}-process data axis in a run of {n} processes; every "
            "process takes a share of the batch (data=-1)")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (data,), mesh_dim_names=(DATA_AXIS,))


def mesh_device(mesh) -> torch.device:
    """The device this process drives on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(mesh, batch):
    """This process's rows ``[r·B/N, (r+1)·B/N)`` of the global batch
    ``batch`` (a dict of arrays or tensors with the batch leading), ``r``
    its index on the data axis of ``mesh`` and ``N`` the axis's size; the
    batch as it is without a mesh. A batch that does not divide raises
    ``ValueError`` (the JAX package replicates it with a warning)."""
    if mesh is None:
        return batch
    n = mesh.size()
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


def shard_tree(model: nn.Module, mesh, fsdp: bool = False,
               fsdp_min_size: int = FSDP_MIN_SIZE) -> nn.Module:
    """``model`` placed on the data axis of ``mesh`` (moved to its device):

    * ``fsdp=False``: a ``DistributedDataParallel`` of it, whose backward
      averages the gradients over the axis. The parameters that never get
      a gradient (:func:`frozen_parameter_names`) are left out of its
      buckets, so no ``find_unused_parameters`` pass is needed;
    * ``fsdp=True``: ``model`` itself, sharded in place by ``fully_shard``:
      every transformer layer a group (one with fewer than
      ``fsdp_min_size`` parameters joins the root's), then the root; the
      methods of ``FSDP_FORWARD_METHODS`` it has gather the root's
      parameters as ``forward`` does. Build its optimizer after this call (the
      parameters become sharded ``DTensor``s).

    Without a mesh, ``model`` as it is."""
    if mesh is None:
        return model
    model = model.to(mesh_device(mesh))
    if not fsdp:
        from torch.nn.parallel import DistributedDataParallel

        DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
            model, frozen_parameter_names(model))
        device_ids = ([torch.cuda.current_device()]
                      if mesh.device_type == "cuda" else None)
        return DistributedDataParallel(model, device_ids=device_ids,
                                       broadcast_buffers=False,
                                       process_group=mesh.get_group())
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)

    for layer in list(_layer_groups(model, fsdp_min_size)):
        fully_shard(layer, mesh=mesh)
    fully_shard(model, mesh=mesh)
    for name in FSDP_FORWARD_METHODS:
        if callable(getattr(model, name, None)):
            register_fsdp_forward_method(model, name)
    return model


def is_fsdp(model: nn.Module) -> bool:
    """True for a module sharded by :func:`shard_tree` (``fsdp=True``)."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def full_state_dict(model: nn.Module) -> Optional[dict]:
    """``model``'s state dict with full tensors on the host: gathered from
    every process of an FSDP model (a collective: every process calls it)
    and returned on the primary only (``{}`` elsewhere); an unsharded
    model's ``state_dict()`` as it is."""
    if not is_fsdp(model):
        return model.state_dict()
    from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                         get_model_state_dict)

    return get_model_state_dict(model, options=StateDictOptions(
        full_state_dict=True, cpu_offload=True))


def full_optimizer_state(model: nn.Module, optimizer) -> dict:
    """``optimizer``'s state keyed by ``model``'s parameter names,
    ``{name: {"step", "exp_avg", ...}}``, full tensors: gathered to the
    primary's host from an FSDP model (a collective; ``{}`` elsewhere),
    by reference from an unsharded one."""
    if not is_fsdp(model):
        names = {id(p): n for n, p in model.named_parameters()}
        return {names[id(p)]: optimizer.state[p]
                for g in optimizer.param_groups for p in g["params"]
                if optimizer.state.get(p)}
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, get_optimizer_state_dict)

    osd = get_optimizer_state_dict(model, optimizer, options=StateDictOptions(
        full_state_dict=True, cpu_offload=True))
    return {k: v for k, v in osd.get("state", {}).items() if v}


def load_full_state_dict(model: nn.Module, state_dict) -> None:
    """Load a full state dict into ``model``, sharding it back onto an FSDP
    model (every process passes the same dict)."""
    if not is_fsdp(model):
        model.load_state_dict(state_dict)
        return
    from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                         set_model_state_dict)

    set_model_state_dict(model, state_dict, options=StateDictOptions(
        full_state_dict=True))


def load_full_optimizer_state(model: nn.Module, optimizer,
                              torch_state_dict) -> None:
    """Load an optimizer ``state_dict`` (its ``state`` keyed by index, as
    ``optimizer.state_dict()`` gives it) into ``optimizer``, sharding it
    onto an FSDP model's parameters."""
    if not is_fsdp(model):
        optimizer.load_state_dict(torch_state_dict)
        return
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, set_optimizer_state_dict)

    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for g in optimizer.param_groups
             for p in g["params"]]
    groups = []
    for g, saved in zip(optimizer.param_groups,
                        torch_state_dict["param_groups"]):
        groups.append({**saved, "params": [names[id(p)]
                                           for p in g["params"]]})
    state = {order[i]: v for i, v in torch_state_dict["state"].items()}
    set_optimizer_state_dict(model, optimizer, {
        "state": state, "param_groups": groups},
        options=StateDictOptions(full_state_dict=True))
