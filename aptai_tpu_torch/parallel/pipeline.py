"""The pipe axis: the encoder's transformer stack as a pipeline over
processes (the JAX package's ``parallel/pipeline.py``).

Each of ``S`` processes along the ``"pipe"`` dimension of a
``DeviceMesh`` holds ``L/S`` of the encoder's ``L`` layers (the others'
parameters are dropped from its model, :func:`place_stage`), and ``M``
microbatches pass from stage to stage as point-to-point sends and
receives between neighbouring processes. Everything outside the stack
(the feature extractor, the projection, the positional conv before it and
the final LayerNorm after it) runs whole on every process, from the
model's own parameters, through the encoder's ``layer_stack_fn`` hook.

Two schedules, as in the JAX package:

* ``interleave=1``: GPipe. Stage ``s`` runs microbatch ``j`` at tick
  ``s + j``; a stage receives its input from stage ``s − 1`` (stage 0
  takes it from the stack's input) and sends its output to ``s + 1``.
* ``interleave=V>1``: the circular schedule. Each stage holds ``V``
  chunks of ``L/(S·V)`` layers at stride ``S`` (stage ``s`` holds the
  global chunks ``v·S + s``, :func:`interleaved_layer_order`), the
  microbatches run in groups of ``S`` in the grouped order, and the last
  stage sends a microbatch that has chunks left to stage 0 (the ring's
  wraparound edge). Because ``M`` is a multiple of ``S`` the wraparound
  arrives exactly on the tick stage 0 consumes it.

The JAX loop runs a static ``V·M + S − 1`` ticks on every device and
discards the ticks on which a device holds no microbatch; here a stage
runs only its ``V·M`` working ticks, in tick order, so each stage applies
each of its ``L/S`` layers once a microbatch: ``M · L/S`` layer calls
(attention launches) a forward, whatever the schedule. The hand-offs are
the same either way (a stage sends on tick ``t`` exactly when its
neighbour works on tick ``t + 1``).

Sends are non-blocking and a stage receives before it computes, so the
forward cannot deadlock: the messages follow the ticks, each from tick
``t`` to tick ``t + 1``. The gradients go the other way through autograd
Functions:

* :class:`_Recv` receives a stage's input; its backward sends the input's
  gradient back to the stage that sent it.
* :class:`_Send` sends a stage's output and returns an empty token; its
  backward receives the output's gradient from the next stage. The tokens
  feed the broadcast below, so that every send is on the path of the
  process's backward.
* :class:`_Broadcast`, the JAX package's ``psum`` of a one-stage-hot
  buffer: the last stage's finished microbatches go to every pipe process.
  Each process then computes the same loss and so holds the same gradient
  of the output; the backward hands it to the last stage once and to no
  other stage (a summing backward would hand the stack ``S`` copies).
* :class:`_StackInput`: only stage 0 reads the stack's input. Its backward
  (the last of the process's pipe nodes to run) first waits for the
  process's gradient sends, then broadcasts stage 0's gradient of the
  input over the pipe, so every process holds a single device's gradient
  of the layers before the stack (and of the final LayerNorm after it,
  which every process computes whole).

Autograd runs a process's ready nodes in the reverse of their creation
order, which is the reverse of the ticks: the backward's messages run
from tick ``t + 1`` to tick ``t``, and it cannot deadlock either. Every
pipe process must take the backward of the same loss.

On the card under NCCL the hand-offs are sends of the CUDA tensors. gloo
(processes sharing one card) does not take CUDA tensors point to point,
so there each hand-off is staged through a pinned host buffer; the stage
still computes on the card.

:func:`pipelined_encoder_apply` runs the encoder deterministically (no
dropout, SpecAugment or recomputation, whatever the model's mode), as the
JAX function does: the layers' dropout draws are not threaded through the
schedule. The pipe composes with the data axis (each process pipes its
rows of the batch within its data index); a mesh whose ``"model"``
dimension exceeds 1 raises, since the JAX schedule runs no tensor
parallelism inside a stage. This module imports nothing of the package.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

PIPE_AXIS = "pipe"

_LAYER_KEY = re.compile(r"^(.*encoder\.layers\.)(\d+)\.(.+)$")


def split_layer_params(state_dict: Dict[str, torch.Tensor]
                       ) -> Tuple[Dict[str, torch.Tensor],
                                  Dict[str, torch.Tensor]]:
    """Split an encoder state dict (a ``Wav2Vec2Model``'s HF names,
    ``encoder.layers.{i}.*``, or a task model's under ``wav2vec2.``) into
    ``(stacked, rest)``: ``stacked`` maps each layer parameter's name
    within its layer (``attention.q_proj.weight``, ...) to the ``L``
    layers' tensors stacked on a new leading dimension; ``rest`` is every
    other entry."""
    found: Dict[int, Dict[str, torch.Tensor]] = {}
    prefixes = set()
    rest = {}
    for name, value in state_dict.items():
        m = _LAYER_KEY.match(name)
        if m is None:
            rest[name] = value
            continue
        prefixes.add(m.group(1))
        found.setdefault(int(m.group(2)), {})[m.group(3)] = value
    if not found:
        raise ValueError("no encoder.layers.<i> entries in the state dict")
    if len(prefixes) > 1:
        raise ValueError(f"layers under several prefixes: {sorted(prefixes)}")
    indices = sorted(found)
    if indices != list(range(len(indices))):
        raise ValueError(f"non-contiguous layer indices: {indices}")
    stacked = {k: torch.stack([found[i][k] for i in indices])
               for k in found[0]}
    return stacked, rest


def unstack_layer_params(stacked: Dict[str, torch.Tensor],
                         prefix: str = "encoder.layers."
                         ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`split_layer_params`'s stacking: the entries
    ``{prefix}{i}.{name}`` (``prefix="wav2vec2.encoder.layers."`` for a
    task model), e.g. to merge the stages' layers back into one state
    dict."""
    n = next(iter(stacked.values())).shape[0]
    return {f"{prefix}{i}.{k}": v[i] for i in range(n)
            for k, v in stacked.items()}


def interleaved_layer_order(n_layers: int, n_stages: int, interleave: int):
    """The layers in stage order for the interleaved schedule: stage ``s``
    holds the contiguous ``s``-th ``1/S`` of the returned list, its chunks
    ``v·S + s`` for ``v`` in ``range(V)``, each of ``n_layers/(S·V)``
    consecutive layers."""
    csz, rem = divmod(n_layers, n_stages * interleave)
    if rem:
        raise ValueError(
            f"{n_layers} layers not divisible into {n_stages} stages x "
            f"{interleave} chunks")
    order = []
    for s in range(n_stages):
        for v in range(interleave):
            chunk = v * n_stages + s
            order.extend(range(chunk * csz, (chunk + 1) * csz))
    return order


def schedule_ticks(num_microbatches: int, n_stages: int,
                   interleave: int = 1) -> int:
    """The schedule's ticks, ``V·M + S − 1``: each stage works on ``V·M``
    of them (a ``1/V`` stage unit each), so the bubble is
    ``(S − 1)/(V·M + S − 1)``."""
    return interleave * num_microbatches + n_stages - 1


def _axis_size(mesh, axis: str) -> int:
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no {axis!r} dimension: "
                         f"{mesh.mesh_dim_names}")
    return mesh.size(mesh.mesh_dim_names.index(axis))


def stage_sharding(mesh, n_layers: int, *, interleave: int = 1,
                   axis: str = PIPE_AXIS) -> List[int]:
    """The layers this process holds as its stage on ``axis`` of ``mesh``
    (a ``DeviceMesh``), in the order it runs them: the contiguous ``s``-th
    ``1/S`` of :func:`interleaved_layer_order` (of ``range(n_layers)``
    under GPipe)."""
    n_stages = _axis_size(mesh, axis)
    if n_stages == 1:
        interleave = 1
    order = interleaved_layer_order(n_layers, n_stages, interleave)
    per = n_layers // n_stages
    s = mesh.get_local_rank(axis)
    return order[s * per:(s + 1) * per]


class StageElsewhere(nn.Module):
    """The place of a transformer layer that another stage of the pipe axis
    holds: no parameters, and a forward that raises."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"layer {self.index} is held by another stage of "
                           "the pipe axis")


def place_stage(model: nn.Module, mesh, *, interleave: int = 1,
                axis: str = PIPE_AXIS) -> List[int]:
    """Keep only this process's stage of ``model``'s layers (a
    ``Wav2Vec2Model``): the other layers become :class:`StageElsewhere`,
    so the process holds ``1/S`` of the stack's parameters, and its state
    dict keeps the layers' own names. In place, as the model axis splits
    a model (build the optimizer after it); a model already placed for
    the same stage is left as it is. Returns the stage's layers."""
    layers = model.encoder.layers
    held = stage_sharding(mesh, len(layers), interleave=interleave,
                          axis=axis)
    missing = [i for i in held if isinstance(layers[i], StageElsewhere)]
    if missing:
        raise ValueError(f"layers {missing} of this stage were dropped by "
                         "an earlier placement on another pipe layout")
    keep = set(held)
    for i in range(len(layers)):
        if i not in keep and not isinstance(layers[i], StageElsewhere):
            layers[i] = StageElsewhere(i)
    return held


class _PipeAxis:
    """The pipe axis as one process sees it for one call: its group, its
    stage, the global ranks of its neighbours, and the sends it has yet to
    wait for."""

    def __init__(self, mesh, axis: str, like: torch.Tensor):
        self.group = mesh.get_group(axis)
        self.size = _axis_size(mesh, axis)
        self.stage = mesh.get_local_rank(axis)
        ranks = dist.get_process_group_ranks(self.group)
        self.first, self.last = ranks[0], ranks[-1]
        self.prev = ranks[(self.stage - 1) % self.size]
        self.next = ranks[(self.stage + 1) % self.size]
        self.is_last = self.stage == self.size - 1
        # gloo sends host memory only: stage a CUDA hand-off through a
        # pinned host buffer
        self.host = like.is_cuda and dist.get_backend(self.group) == "gloo"
        self.pending = []  # (work, buffer) of sends not waited for

    def send(self, x: torch.Tensor, peer: int) -> None:
        x = x.detach().contiguous()
        if self.host:
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            buf.copy_(x)
            x = buf
        self.pending.append((dist.isend(x, peer, group=self.group), x))

    def recv(self, shape, dtype, device, peer: int) -> torch.Tensor:
        if self.host:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            dist.recv(buf, peer, group=self.group)
            return buf.to(device)
        buf = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(buf, peer, group=self.group)
        return buf

    def wait(self) -> None:
        for work, _ in self.pending:
            work.wait()
        self.pending.clear()


class _StackInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, pipe, broadcast):
        ctx.pipe, ctx.broadcast = pipe, broadcast
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g):
        pipe = ctx.pipe
        pipe.wait()
        if not ctx.broadcast:
            return None, None, None
        # stage 0's gradient is the single device's; the other stages'
        # (zeros) are replaced by it
        g = (g.contiguous() if pipe.stage == 0
             else torch.empty_like(g, memory_format=torch.contiguous_format))
        dist.broadcast(g, pipe.first, group=pipe.group)
        return g, None, None


class _Recv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, pipe, peer, shape):
        ctx.pipe, ctx.peer = pipe, peer
        return pipe.recv(shape, anchor.dtype, anchor.device, peer)

    @staticmethod
    def backward(ctx, g):
        ctx.pipe.send(g, ctx.peer)
        return None, None, None, None


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, pipe, peer):
        ctx.pipe, ctx.peer = pipe, peer
        ctx.meta = (y.shape, y.dtype, y.device)
        pipe.send(y, peer)
        return y.new_empty((0,))

    @staticmethod
    def backward(ctx, _):
        return ctx.pipe.recv(*ctx.meta, ctx.peer), None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, pipe, *tokens):
        ctx.is_last, ctx.n_tokens = pipe.is_last, len(tokens)
        out = local.view_as(local) if pipe.is_last else torch.empty_like(
            local)
        dist.broadcast(out, pipe.last, group=pipe.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return ((g if ctx.is_last else None), None) + (None,) * ctx.n_tokens


def _check_schedule(n_layers: int, n_stages: int, interleave: int,
                    batch: int, num_microbatches: int, data: int = 1):
    """The JAX package's refusals, in its order."""
    if n_layers % (n_stages * interleave):
        raise ValueError(f"{n_layers} layers not divisible into "
                         f"{n_stages} stages x {interleave} chunks")
    if batch % num_microbatches:
        raise ValueError(f"batch {batch} not divisible into "
                         f"{num_microbatches} microbatches")
    if interleave > 1 and num_microbatches % n_stages:
        # the grouped order needs whole groups of S microbatches so the
        # ring wraparound lands exactly on stage 0's consuming tick
        raise ValueError(f"interleave={interleave} needs microbatches "
                         f"({num_microbatches}) divisible by stages "
                         f"({n_stages})")
    mb = batch // num_microbatches
    if mb % data:
        raise ValueError(f"a microbatch of {mb} rows does not divide over "
                         f"the {data} processes of the data axis")


def pipeline_layer_stack(encoder: nn.Module, h: torch.Tensor,
                         frame_lengths: torch.Tensor, mesh, *,
                         num_microbatches: Optional[int] = None,
                         interleave: int = 1,
                         axis: str = PIPE_AXIS) -> torch.Tensor:
    """Run ``encoder``'s transformer stack (a placed ``Encoder``,
    :func:`place_stage`) on ``h`` (B, T, C) as a pipeline over ``axis``:
    GPipe at ``interleave=1``, the circular schedule at ``V > 1`` (``M``
    then a multiple of ``S``). Returns the stack's output (B, T, C) on
    every pipe process: the sequential layer loop's, microbatch by
    microbatch. Plug it into the encoder through ``layer_stack_fn``."""
    pipe = _PipeAxis(mesh, axis, h)
    n_stages = pipe.size
    v_chunks = 1 if n_stages == 1 else interleave
    b = h.shape[0]
    m = num_microbatches if num_microbatches is not None else n_stages
    _check_schedule(len(encoder.layers), n_stages, v_chunks, b, m)
    held = stage_sharding(mesh, len(encoder.layers), interleave=v_chunks,
                          axis=axis)
    layers = [encoder.layers[i] for i in held]
    if any(isinstance(layer, StageElsewhere) for layer in layers):
        raise ValueError("the encoder is not placed for this stage: "
                         "place_stage first")
    csz = len(layers) // v_chunks
    mb = b // m
    if torch.is_grad_enabled():
        needs = h.requires_grad
        h = _StackInput.apply(h if needs else h.detach().requires_grad_(),
                              pipe, needs)
    h_mb, lens_mb = h.split(mb), frame_lengths.split(mb)
    s, last = pipe.stage, n_stages - 1
    outs: List[Optional[torch.Tensor]] = [None] * m
    tokens = []
    for r in range(v_chunks * m):  # this stage's working ticks, s + r
        g, w = divmod(r, v_chunks * n_stages)
        v, jj = divmod(w, n_stages)
        j = g * n_stages + jj
        if s == 0 and v == 0:
            x = h_mb[j]
        else:  # from stage s - 1, or the wraparound from stage S - 1
            x = _Recv.apply(h, pipe, pipe.prev, h_mb[j].shape)
        for layer in layers[v * csz:(v + 1) * csz]:
            x = layer(x, lens_mb[j])
        if s == last and v == v_chunks - 1:
            outs[j] = x
        else:
            tokens.append(_Send.apply(x, pipe, pipe.next))
    local = torch.cat(outs) if s == last else h
    out = _Broadcast.apply(local, pipe, *tokens)
    pipe.wait()
    return out


def pipelined_encoder_apply(model: nn.Module, audio: torch.Tensor,
                            audio_lengths: torch.Tensor, mesh, *,
                            num_microbatches: Optional[int] = None,
                            interleave: int = 1, axis: str = PIPE_AXIS,
                            data_axis: Optional[str] = None):
    """``model``'s forward (a ``Wav2Vec2Model``) with its transformer stack
    pipelined over ``axis`` of ``mesh``: ``(hidden, frame_lengths,
    extract_features)`` as the model returns them, on every pipe process,
    and differentiable (a training step is a backward through it, taken on
    every pipe process). The model keeps only this process's stage of the
    layers (:func:`place_stage`, in place). Deterministic: no dropout,
    SpecAugment or recomputation, whatever the model's mode.

    ``audio`` (B, L) and ``audio_lengths`` (B,) are the whole batch. With
    ``data_axis``, the process runs its rows ``[d·B/D, (d+1)·B/D)`` on the
    data axis and returns those (the JAX function returns the whole batch
    from its global arrays); without one, every data index runs the whole
    batch. Raises the JAX package's ``ValueError``s (layers that do not
    split into the stages and chunks, a batch that does not split into the
    microbatches, an interleaved ``M`` that is not a multiple of ``S``),
    one for a microbatch that does not split over the data axis, and one
    for a mesh with a model axis."""
    names = mesh.mesh_dim_names or ()
    if "model" in names and mesh.size(names.index("model")) > 1:
        raise ValueError("the pipe axis runs no tensor parallelism inside a "
                         "stage: the mesh's model dimension must be 1")
    if getattr(model.encoder, "model_axis", None) is not None:
        raise ValueError("the pipe axis runs no tensor parallelism inside a "
                         "stage: the model is split on a model axis")
    n_stages = _axis_size(mesh, axis)
    n_layers = len(model.encoder.layers)
    if interleave > 1 and n_stages > 1:
        interleaved_layer_order(n_layers, n_stages, interleave)
    v_chunks = 1 if n_stages == 1 else interleave
    b = audio.shape[0]
    m = num_microbatches if num_microbatches is not None else n_stages
    data = _axis_size(mesh, data_axis) if data_axis is not None else 1
    _check_schedule(n_layers, n_stages, v_chunks, b, m, data)
    if data > 1:
        d = mesh.get_local_rank(data_axis)
        rows = slice(d * (b // data), (d + 1) * (b // data))
        audio, audio_lengths = audio[rows], audio_lengths[rows]
    place_stage(model, mesh, interleave=v_chunks, axis=axis)

    def stack_fn(h, frame_lengths):
        return pipeline_layer_stack(
            model.encoder, h, frame_lengths, mesh,
            num_microbatches=m, interleave=v_chunks, axis=axis)

    modes = {mod: mod.training for mod in model.modules()}
    model.eval()
    try:
        return model(audio, audio_lengths, layer_stack_fn=stack_fn)
    finally:
        for mod, mode in modes.items():
            mod.training = mode
