"""Checkpoints with the JAX package's experiment-directory scheme and files
(``aptai_tpu/train/checkpoints.py``):

  <exp_dir>/
    experiment_args.json      — full config
    vocab.json                — phoneme vocabulary
    best-model-ckpt/          — params at the best target metric
    last-model-ckpt/          — params + optimizer state + step (resume)
    model-ckpts/e%04d/        — optional per-epoch params

with the same JSON files and keys (``model_cfg.json``, ``train_meta.json``)
and the same tensor files: ``params.msgpack`` and ``opt_state.msgpack`` in
flax's msgpack format (``flax.serialization.to_bytes``). A model's state
dict crosses the weight bridge of ``models/convert.py`` into the JAX
package's parameter tree (:func:`flax_params_tree`), and the optimizer's
Adam state (:class:`JaxAdamState`) into the optax state that
``aptai_tpu.train.harness.torch_adam(...).init`` gives for the same run
(:func:`optax_adam_state`), so the JAX package's ``CheckpointManager``,
``fit`` and ``load_predictor`` read a run of this package unchanged, and
this package reads a JAX run's. A tree that is not a model's state dict is
written as it is, as the JAX manager writes any pytree.

:func:`save_msgpack` is an encoder of the msgpack subset flax writes, and
:func:`msgpack_restore` its decoder (neither needs the ``msgpack``
package); the encoder streams each array's bytes to the file. Directories
of older runs of this package hold ``params.pt`` (a ``state_dict``) and
``opt_state.pt`` (an optimizer ``state_dict``, both ``torch.save``); they
are still read, and where one sits beside a ``params.msgpack`` it is the
newer file (this package resumed a JAX run there). A write removes the
directory's ``.pt`` files, so no stale file stays beside a fresh one.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
import time
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from aptai_tpu_torch.models.convert import (any_state_dict_from_jax,
                                            jax_params_from_any_state_dict,
                                            jax_tree_family,
                                            state_dict_family)
from aptai_tpu_torch.parallel.mesh import (full_shapes,
                                           load_full_optimizer_state)
from aptai_tpu_torch.utils.trees import fetch_pytree

PARAMS = "params.pt"
OPT_STATE = "opt_state.pt"
FLAX_PARAMS = "params.msgpack"
FLAX_OPT_STATE = "opt_state.msgpack"


# the device→host copy of a checkpoint write: every tensor of a (nested)
# state dict detached and on the CPU, fetched in one pipelined pass
to_host = fetch_pytree


def save_state(path, tree) -> None:
    """``torch.save`` of ``tree`` moved to the host."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save(to_host(tree), path)


def load_state(path, map_location=None):
    """A tree written by :func:`save_state`, its tensors on
    ``map_location`` (the CPU by default)."""
    return torch.load(path, map_location=map_location or "cpu",
                      weights_only=True)


def save_json(path, obj) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if dataclasses.is_dataclass(obj):
        obj = dataclasses.asdict(obj)
    Path(path).write_text(json.dumps(obj, indent=2, default=str))


def load_json(path) -> Dict:
    return json.loads(Path(path).read_text())


class CheckpointManager:
    """best / last / per-epoch checkpoints with target-metric selection.

    ``write_seconds`` holds the split of the newest ``update`` or
    ``save_interrupt`` call's writes: ``bridge_s`` (the weight bridge's
    layouts, on the tensors' device), ``host_s`` (the device→host copy),
    ``encode_s`` (the msgpack headers, :func:`msgpack_parts`), ``disk_s``
    (writing the files) and ``bytes`` written."""

    def __init__(self, exp_dir, target_metric: str,
                 bigger_is_better: bool = False,
                 save_all_epochs: bool = False):
        self.exp_dir = Path(exp_dir)
        self.target_metric = target_metric
        self.bigger_is_better = bigger_is_better
        self.save_all_epochs = save_all_epochs
        self.best_value: Optional[float] = None
        self.best_dir = self.exp_dir / "best-model-ckpt"
        self.last_dir = self.exp_dir / "last-model-ckpt"
        self.all_dir = self.exp_dir / "model-ckpts"
        self.write_seconds: Dict[str, float] = {}
        self.exp_dir.mkdir(parents=True, exist_ok=True)

    def is_improvement(self, value: float) -> bool:
        """The reference's comparison: ties count as improvements
        (train_phoneme_recognizer.py:458-462 uses <= / >=)."""
        if self.best_value is None:
            return True
        if self.bigger_is_better:
            return self.best_value <= value
        return self.best_value >= value

    def has_last(self) -> bool:
        """A last checkpoint is there: ``params.msgpack`` (either package's)
        or an older run's ``params.pt``."""
        return ((self.last_dir / PARAMS).exists()
                or (self.last_dir / FLAX_PARAMS).exists())

    def update(self, epoch: int, metrics: Dict[str, float], params,
               opt_state=None, step: int = 0,
               model_cfg: Optional[Dict] = None,
               save_last: bool = True) -> bool:
        """Save last (and per-epoch), and best when the target improves;
        True if this epoch became the new best.

        ``params`` is a state dict (or another tree of tensors and arrays)
        and ``opt_state`` a :class:`JaxAdamState` (or another tree), their
        tensors possibly on the card: they cross the bridge and move to
        the host only when this epoch writes. ``save_last=False`` skips the
        last checkpoint this epoch (the ``--ckpt_every`` cadence); an
        improving epoch writes it anyway, so ``train_meta.json`` stays
        coherent with the newest params on disk.
        """
        value = float(metrics[self.target_metric])
        improved = self.is_improvement(value)
        if improved:
            self.best_value = value
        save_last = save_last or improved
        self._clear_seconds()
        if improved or self.save_all_epochs or save_last:
            tree = self._host(flax_params_tree, params)

        if improved:
            self._save(self.best_dir, FLAX_PARAMS, tree)
            if model_cfg is not None:
                save_json(self.best_dir / "model_cfg.json", model_cfg)

        if self.save_all_epochs:
            self._save(self.all_dir / f"e{epoch:04d}", FLAX_PARAMS, tree)

        if save_last:
            self._write_last(params, tree, opt_state, model_cfg, {
                "epoch": epoch,
                "step": int(step),
                "best_value": self.best_value,
                "metrics": {k: float(v) for k, v in metrics.items()},
            })
        return improved

    def _clear_seconds(self) -> None:
        self.write_seconds = dict.fromkeys(
            ("bridge_s", "host_s", "encode_s", "disk_s", "bytes"), 0.0)

    def _host(self, convert, *args):
        """``convert(*args)`` (the bridge, on the tensors' device), then on
        the host; both timed into ``write_seconds``."""
        t0 = time.perf_counter()
        tree = convert(*args)
        _sync(tree)
        t1 = time.perf_counter()
        tree = fetch_pytree(tree)
        self.write_seconds["bridge_s"] += t1 - t0
        self.write_seconds["host_s"] += time.perf_counter() - t1
        return tree

    def _save(self, ckpt_dir: Path, name: str, tree) -> None:
        """``tree`` as ``ckpt_dir/name``; the directory's superseded
        ``.pt`` files of this package's older format go."""
        t0 = time.perf_counter()
        parts = msgpack_parts(tree)
        t1 = time.perf_counter()
        self.write_seconds["bytes"] += write_parts(ckpt_dir / name, parts)
        self.write_seconds["encode_s"] += t1 - t0
        self.write_seconds["disk_s"] += time.perf_counter() - t1
        for old in (PARAMS, OPT_STATE):
            (ckpt_dir / old).unlink(missing_ok=True)

    def _write_last(self, params, tree, opt_state, model_cfg, meta) -> None:
        self._save(self.last_dir, FLAX_PARAMS, tree)
        if opt_state is not None:
            if isinstance(opt_state, JaxAdamState):
                opt_tree = self._host(optax_adam_state, opt_state, params)
            else:
                opt_tree = fetch_pytree(opt_state)
            self._save(self.last_dir, FLAX_OPT_STATE, opt_tree)
        save_json(self.last_dir / "train_meta.json", meta)
        if model_cfg is not None:
            save_json(self.last_dir / "model_cfg.json", model_cfg)

    def save_interrupt(self, resume_epoch: int, params, opt_state=None,
                       step: int = 0, model_cfg: Optional[Dict] = None):
        """The preemption write: a ``last-model-ckpt`` whose meta resumes
        at ``resume_epoch``. A mid-epoch interrupt passes the interrupted
        epoch itself, which a resume repeats (the partial epoch's params,
        moments and step counter are kept); an epoch-boundary interrupt
        passes ``epoch + 1``."""
        self._clear_seconds()
        tree = self._host(flax_params_tree, params)
        self._write_last(params, tree, opt_state, model_cfg, {
            "epoch": resume_epoch - 1,
            "step": int(step),
            "best_value": self.best_value,
            "metrics": {},
            "preempted": True,
        })

    def restore_last(self, map_location=None):
        """``(params, opt_state or None, meta)`` of the last checkpoint,
        tensors on ``map_location``; the best watermark comes back too.

        A model's ``params.msgpack`` crosses the bridge and its
        ``opt_state.msgpack`` comes back as a :class:`JaxAdamState`
        (:func:`load_optimizer_state` keys it into an optimizer by
        parameter name); another tree comes back as tensors. An older
        run's ``params.pt`` wins over a ``params.msgpack`` beside it."""
        meta = load_json(self.last_dir / "train_meta.json")
        self.best_value = meta.get("best_value")
        params = read_params(self.last_dir, map_location)
        opt_state = None
        if (self.last_dir / PARAMS).exists():
            if (self.last_dir / OPT_STATE).exists():
                opt_state = load_state(self.last_dir / OPT_STATE,
                                       map_location)
        elif (self.last_dir / FLAX_OPT_STATE).exists():
            opt_tree = load_flax_params(self.last_dir / FLAX_OPT_STATE)
            params_tree = load_flax_params(self.last_dir / FLAX_PARAMS)
            opt_state = (jax_adam_state(opt_tree, params_tree)
                         if jax_tree_family(params_tree)
                         else _tensors(opt_tree, map_location))
        return params, opt_state, meta

    def restore_best(self, map_location=None):
        return read_params(self.best_dir, map_location)


def _sync(tree) -> None:
    """Wait for the card's work on ``tree`` (the bridge's transposes), so
    the copy that follows is timed alone."""
    if any(isinstance(t, torch.Tensor) and t.is_cuda
           for t in _leaves(tree)):
        torch.cuda.synchronize()


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tensors(tree, map_location=None):
    """A restored flax tree with its numpy leaves as tensors."""
    if isinstance(tree, Mapping):
        return {k: _tensors(v, map_location) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy()).to(map_location or "cpu")
    if isinstance(tree, torch.Tensor):
        return tree.to(map_location or "cpu")
    return tree


def flax_params_tree(params):
    """What a ``params.msgpack`` holds for ``params``: the JAX package's
    parameter tree of a model's state dict (``models/convert.py``), any
    other tree as it is."""
    if isinstance(params, Mapping) and state_dict_family(params):
        return jax_params_from_any_state_dict(params)
    return params


def read_params(ckpt_dir, map_location=None) -> Dict:
    """The ``state_dict`` of a checkpoint directory: ``params.pt`` (an
    older run of this package; tensors on ``map_location``) where there is
    one, else ``params.msgpack`` through the bridge of its family (CPU
    tensors), or as tensors when it is not a model's tree."""
    ckpt_dir = Path(ckpt_dir)
    if (ckpt_dir / PARAMS).exists():
        return load_state(ckpt_dir / PARAMS, map_location)
    tree = load_flax_params(ckpt_dir / FLAX_PARAMS)
    if jax_tree_family(tree):
        return any_state_dict_from_jax(tree)
    return _tensors(tree, map_location)


# -- a JAX run's optax Adam state -----------------------------------------------

@dataclasses.dataclass
class JaxAdamState:
    """An Adam state in the optax form, its moments under this package's
    parameter names: one ``count`` of updates for every parameter, the
    first and second moments, and the L2 weight decay (which makes the
    optax state a chain after ``add_decayed_weights``). A JAX run's last
    checkpoint reads into one (float32 CPU tensors;
    :func:`jax_adam_state`); :meth:`from_optimizer` takes one from a live
    optimizer (its tensors, by reference) for
    :func:`optax_adam_state` to write."""

    count: int
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]
    weight_decay: float = 0.0

    @classmethod
    def from_optimizer(cls, optimizer: torch.optim.Optimizer,
                       model: torch.nn.Module) -> "JaxAdamState":
        """The state of ``optimizer`` (a ``torch.optim.Adam`` over
        ``model``'s parameters) keyed by parameter name.

        optax keeps one ``count``; torch a ``step`` per parameter, and
        none for a parameter it never stepped (no gradient: a feature
        encoder run under ``no_grad``), which leaves it out here: the JAX
        package holds zero moments for such a parameter (``stop_gradient``)
        and :func:`optax_adam_state` writes zeros. A parameter whose step
        lags the others' but whose moments are all zero is the same case
        (this package resumed a JAX run, which gave it zero moments at the
        count of then). Any other disagreement of the steps raises
        ``ValueError``, as do groups that disagree on the weight decay and
        ``amsgrad``, which optax's Adam does not have."""
        names = {id(p): n for n, p in model.named_parameters()}
        return cls.from_named_state(
            {names[id(p)]: optimizer.state[p]
             for group in optimizer.param_groups for p in group["params"]
             if optimizer.state.get(p)}, optimizer)

    @classmethod
    def from_named_state(cls, named: Mapping[str, Mapping],
                         optimizer: torch.optim.Optimizer) -> "JaxAdamState":
        """:meth:`from_optimizer` from ``optimizer``'s per-parameter states
        keyed by parameter name (``{name: {"step", "exp_avg",
        "exp_avg_sq"}}``; an FSDP model's, gathered whole by
        ``parallel.mesh.full_optimizer_state``)."""
        decays = {float(g.get("weight_decay", 0.0))
                  for g in optimizer.param_groups}
        if len(decays) > 1:
            raise ValueError(f"the optimizer's parameter groups disagree on "
                             f"the weight decay {sorted(decays)}: optax "
                             "holds one")
        if any(g.get("amsgrad") for g in optimizer.param_groups):
            raise ValueError("amsgrad has no optax Adam state")
        exp_avg, exp_avg_sq, steps = {}, {}, {}
        for name, state in named.items():
            exp_avg[name] = state["exp_avg"]
            exp_avg_sq[name] = state["exp_avg_sq"]
            steps[name] = int(float(state["step"]))
        count = max(steps.values(), default=0)
        for name, step in steps.items():
            if step == count:
                continue
            if exp_avg[name].any() or exp_avg_sq[name].any():
                raise ValueError(
                    f"Adam steps disagree: parameter {name!r} has taken "
                    f"{step} steps, others {count}; optax keeps one count")
            del exp_avg[name], exp_avg_sq[name]
        return cls(count, exp_avg, exp_avg_sq,
                   decays.pop() if decays else 0.0)

    def torch_state_dict(self, optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module) -> Dict:
        """``optimizer``'s ``state_dict`` holding these moments, each keyed
        to its parameter by the name ``model`` gives it; ``step`` is the
        optax ``count`` (float32, as ``torch.optim.Adam`` keeps it). The
        moments are a single device's, also for a model placed on a mesh
        (``parallel.mesh.load_full_optimizer_state`` slices them)."""
        names = {id(p): n for n, p in model.named_parameters()}
        shapes = full_shapes(model)
        state, index = {}, 0
        for group in optimizer.param_groups:
            for p in group["params"]:
                name = names[id(p)]
                m = self.exp_avg.get(name)
                if m is None:
                    raise ValueError(f"the JAX Adam state has no moments "
                                     f"for parameter {name!r}")
                if torch.isnan(m).any():
                    raise ValueError(f"parameter {name!r} is frozen "
                                     "(optax.masked) in the JAX run but "
                                     "trained by this optimizer")
                if m.shape != shapes[name]:
                    raise ValueError(f"the JAX Adam moments of {name!r} have "
                                     f"shape {tuple(m.shape)}, the parameter "
                                     f"{tuple(shapes[name])}")
                state[index] = {
                    "step": torch.tensor(float(self.count), dtype=torch.float32),
                    "exp_avg": m, "exp_avg_sq": self.exp_avg_sq[name]}
                index += 1
        out = optimizer.state_dict()
        out["state"] = state
        return out


def _adam_stage(opt_tree) -> Mapping:
    """The ``ScaleByAdamState`` of a flax state dict of
    ``aptai_tpu.train.harness.torch_adam``'s optax state: ``scale_by_adam``,
    chained after ``add_decayed_weights`` (an empty state) when weight
    decay is on (a chain is keyed ``"0"``, ``"1"``), the whole wrapped in
    ``optax.masked`` (``inner_state``) when there are frozen prefixes."""
    state = opt_tree
    if isinstance(state, Mapping) and set(state) == {"inner_state"}:
        state = state["inner_state"]
    if isinstance(state, Mapping) and state and all(
            isinstance(k, str) and k.isdigit() for k in state):
        stages = [state[str(i)] for i in range(len(state))]
        adam = [s for s in stages
                if isinstance(s, Mapping) and {"count", "mu", "nu"} == set(s)]
        if len(adam) == 1 and all(s is adam[0] or s == {} for s in stages):
            return adam[0]
    shape = (sorted(state) if isinstance(state, Mapping)
             else type(state).__name__)
    raise ValueError(
        "cannot map this optax state onto torch.optim.Adam: expected "
        "scale_by_adam, optionally chained after add_decayed_weights and "
        f"wrapped in optax.masked; found keys {shape}")


def _unmask(moments, params):
    """``moments`` with each ``optax.MaskedNode`` leaf (an empty dict in the
    state dict: a frozen parameter) replaced by NaNs of its parameter's
    shape, so the tree crosses the bridge whole and a frozen leaf stays
    recognisable."""
    if isinstance(params, Mapping):
        if not isinstance(moments, Mapping) or set(moments) != set(params):
            raise ValueError("the JAX Adam moments do not have the "
                             "parameters' tree structure")
        return {k: _unmask(moments[k], params[k]) for k in params}
    if isinstance(moments, Mapping) and not moments:
        return np.full(tuple(params.shape), np.nan, np.float32)
    return moments


def jax_adam_state(opt_tree, params_tree) -> JaxAdamState:
    """A JAX run's ``opt_state.msgpack`` tree → :class:`JaxAdamState`, its
    moments crossing the same bridge as ``params_tree`` (the checkpoint's
    ``params.msgpack`` tree, whose structure they have). Raises
    ``ValueError`` for a state it cannot map."""
    adam = _adam_stage(opt_tree)
    if set(adam["mu"]) < set(params_tree):
        # the JAX FORCE trainer's cache mode: moments of the head alone,
        # the tower merged into the params at the fold's end
        params_tree = {k: params_tree[k] for k in adam["mu"]}
    return JaxAdamState(
        int(adam["count"]),
        any_state_dict_from_jax(_unmask(adam["mu"], params_tree)),
        any_state_dict_from_jax(_unmask(adam["nu"], params_tree)))


# top-level keys that the JAX trainers mask out of the optimizer
# (``torch_adam(frozen_prefixes=...)``), by family
_JAX_FROZEN = {"force_aptai": ("w2v2_pr",), "force_head": ("w2v2_pr",)}


def optax_adam_state(adam: JaxAdamState, params: Mapping) -> Dict:
    """The flax state dict of the optax state that
    ``aptai_tpu.train.harness.torch_adam(...).init`` gives for the run of
    ``params`` (a model's state dict), holding ``adam``: ``scale_by_adam``'s
    ``{count, mu, nu}``, chained after ``add_decayed_weights``
    (``{"0": {}, "1": ...}``) under weight decay, wrapped in
    ``optax.masked`` (``{"inner_state": ...}``, a frozen parameter's
    moments ``{}``) for the families whose JAX trainer freezes a subtree
    (FORCE's ``w2v2_pr`` tower, also in its head-only form). A parameter
    without moments gets zeros; one with moments under a frozen subtree
    raises ``ValueError``. The moments cross the bridge on their device."""
    family = state_dict_family(params)
    if family is None:
        raise ValueError("an Adam state is written for a model's state "
                         f"dict; names {sorted(params)[:8]}")
    frozen = _JAX_FROZEN.get(family, ())
    trained = {k: v for k, v in params.items()
               if not k.startswith(tuple(f + "." for f in frozen))}
    stray = sorted(set(adam.exp_avg) - set(trained))
    if stray:
        raise ValueError(f"Adam moments for parameters the JAX trainer "
                         f"freezes or the model lacks: {stray[:8]}")

    def moments(by_name):
        sd = {k: by_name[k] if k in by_name
              else torch.zeros(v.shape, dtype=torch.float32)
              for k, v in trained.items()}
        tree = jax_params_from_any_state_dict(sd)
        for key in frozen:
            if key in tree_shape:
                tree[key] = _masked(tree_shape[key])
        return tree

    tree_shape = {}
    if any(k.startswith(tuple(f + "." for f in frozen)) for k in params):
        tree_shape = jax_params_from_any_state_dict(
            {k: v.new_empty(v.shape, device="meta") for k, v in
             params.items()})
    state = {"count": np.array(adam.count, np.int32),
             "mu": moments(adam.exp_avg), "nu": moments(adam.exp_avg_sq)}
    state = {"0": {}, "1": state} if adam.weight_decay else {"0": state}
    return {"inner_state": state} if frozen else state


def _masked(tree):
    """``optax.MaskedNode`` (an empty dict) for every leaf of ``tree``."""
    if isinstance(tree, Mapping):
        return {k: _masked(v) for k, v in tree.items()}
    return {}


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module, opt_state) -> None:
    """Load a restored ``opt_state`` into ``optimizer`` (over ``model``'s
    parameters): this package's ``state_dict``, or a
    :class:`JaxAdamState`; sharded onto an FSDP model's parameters."""
    if isinstance(opt_state, JaxAdamState):
        opt_state = opt_state.torch_state_dict(optimizer, model)
    load_full_optimizer_state(model, optimizer, opt_state)


# -- the JAX package's params.msgpack -----------------------------------------

# flax/serialization.py ``_MsgpackExtType``
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A msgpack decoder for what ``flax.serialization.msgpack_serialize``
    writes: maps, arrays, strings, binaries, numbers, nil, booleans, and
    the ndarray and numpy-scalar ext types."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _uint(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def _int(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big", signed=True)

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self._take(self._uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):
            n = self._uint(1 << (b - 0xC7))
            return self._ext(self._int(1), n)
        if b == 0xCA:
            return struct.unpack(">f", self._take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self._take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self._uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            return self._int(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:
            return self._ext(self._int(1), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self._uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self._array(self._uint(2 << (b - 0xDC)))
        if b in (0xDE, 0xDF):
            return self._map(self._uint(2 << (b - 0xDE)))
        raise ValueError(f"msgpack type byte {b:#x} is not used by flax")

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, code: int, n: int):
        data = self._take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not an array")
        shape, name, raw = _Reader(data).read()
        if isinstance(name, bytes):
            name = name.decode()
        if name == "bfloat16":
            arr = torch.from_numpy(np.frombuffer(raw, np.uint16).copy()
                                   ).view(torch.bfloat16).reshape(shape)
        else:
            arr = np.frombuffer(raw, np.dtype(name)).reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr


def _unchunk(tree):
    """Arrays that flax split into ``MAX_CHUNK_SIZE`` pieces, joined."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` returns for ``data``:
    nested dicts of numpy arrays (C order), numpy scalars for the scalar
    leaves, and ``torch.bfloat16`` tensors for bfloat16 leaves (numpy has
    no bfloat16)."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack tree")
    return _unchunk(tree)


def load_flax_params(path):
    """The tree of a JAX package ``params.msgpack`` file."""
    return msgpack_restore(Path(path).read_bytes())


# -- writing flax msgpack -----------------------------------------------------

# flax/serialization.py: an array of more bytes is written as a
# ``__msgpack_chunked_array__`` dict of flat pieces of at most this many
# bytes (msgpack's limit is 2**31 - 1 bytes an object); read when a tree is
# written, so a test can lower it together with flax's
MAX_CHUNK_SIZE = 2**30


def _sized(n: int, small_tag: Optional[int], small_max: int, tags) -> bytes:
    """A msgpack length header: ``small_tag | n`` up to ``small_max``,
    else the first of ``tags`` (1-, 2- and 4-byte lengths) that holds n."""
    if small_tag is not None and n <= small_max:
        return bytes([small_tag | n])
    for tag, size in zip(tags, (1, 2, 4)):
        if tag is not None and n < 1 << (8 * size):
            return bytes([tag]) + n.to_bytes(size, "big")
    raise ValueError(f"msgpack cannot hold a length of {n}")


def _int(v: int) -> bytes:
    """msgpack-python's encoding of an int (the smallest form)."""
    if -0x20 <= v < 0x80:
        return (v & 0xFF).to_bytes(1, "big")
    for size, (utag, itag) in zip((1, 2, 4, 8), ((0xCC, 0xD0), (0xCD, 0xD1),
                                                 (0xCE, 0xD2), (0xCF, 0xD3))):
        if 0 <= v < 1 << (8 * size):
            return bytes([utag]) + v.to_bytes(size, "big")
        if -(1 << (8 * size - 1)) <= v < 0:
            return bytes([itag]) + v.to_bytes(size, "big", signed=True)
    raise ValueError(f"msgpack cannot hold the int {v}")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _sized(n, None, 0, (0xC7, 0xC8, 0xC9)) + bytes([code])


@dataclasses.dataclass
class _Leaf:
    """An array leaf as flax writes it: dtype name, shape, and the
    elements flat in C order (bfloat16's as int16)."""

    name: str
    shape: tuple
    flat: np.ndarray


def _leaf(x) -> _Leaf:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return _Leaf("bfloat16", tuple(x.shape),
                         x.view(torch.int16).numpy().reshape(-1))
        x = x.numpy()
    x = np.asarray(x, order="C")  # ascontiguousarray would make 0-d 1-d
    return _Leaf(x.dtype.name, x.shape, x.reshape(-1))


def _pack_array(write, code: int, leaf: _Leaf) -> None:
    """flax's ``_ndarray_to_bytes`` inside an ext of type ``code``: a
    3-array of the shape, the dtype name and the bytes, which are written
    from the array's own buffer."""
    raw = leaf.flat.view(np.uint8)
    head = (bytes([0x93])
            + _sized(len(leaf.shape), 0x90, 15, (None, 0xDC, 0xDD))
            + b"".join(_int(int(d)) for d in leaf.shape) + _str(leaf.name)
            + _sized(raw.nbytes, None, 0, (0xC4, 0xC5, 0xC6)))
    write(_ext_header(code, len(head) + raw.nbytes) + head)
    write(memoryview(raw))


def _pack_chunked(write, leaf: _Leaf) -> None:
    """flax's ``_chunk``: a dict of the shape and the flat array in
    pieces of at most ``MAX_CHUNK_SIZE`` bytes, its keys in the order flax
    inserts them (chunking follows flax's key-sorting ``tree_map``)."""
    n = max(1, int(MAX_CHUNK_SIZE / leaf.flat.itemsize))
    pieces = [leaf.flat[i:i + n] for i in range(0, leaf.flat.size, n)]
    write(_sized(3, 0x80, 15, ()) + _str(CHUNKED) + b"\xc3" + _str("shape")
          + _sized(len(leaf.shape), 0x80, 15, (None, 0xDE, 0xDF)))
    for i, d in enumerate(leaf.shape):
        write(_str(str(i)) + _int(int(d)))
    write(_str("chunks") + _sized(len(pieces), 0x80, 15, (None, 0xDE, 0xDF)))
    for i, p in enumerate(pieces):
        write(_str(str(i)))
        _pack_array(write, EXT_NDARRAY, _Leaf(leaf.name, p.shape, p))


def _pack(write, obj) -> None:
    if isinstance(obj, Mapping):
        write(_sized(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        if not all(isinstance(k, str) for k in obj):
            raise TypeError(f"flax msgpack keys are strings: {list(obj)}")
        for k in sorted(obj):  # flax's tree_map puts dict keys in order
            write(_str(k))
            _pack(write, obj[k])
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        leaf = _leaf(obj)
        if leaf.flat.nbytes > MAX_CHUNK_SIZE:
            _pack_chunked(write, leaf)
        else:
            _pack_array(write, EXT_NDARRAY, leaf)
    elif isinstance(obj, np.generic):
        _pack_array(write, EXT_NPSCALAR, _leaf(np.asarray(obj)))
    elif obj is None or isinstance(obj, bool):
        write({None: b"\xc0", False: b"\xc2", True: b"\xc3"}[obj])
    elif isinstance(obj, int):
        write(_int(obj))
    elif isinstance(obj, float):
        write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        write(_str(obj))
    elif isinstance(obj, bytes):
        write(_sized(len(obj), None, 0, (0xC4, 0xC5, 0xC6)) + obj)
    else:
        raise TypeError(f"flax msgpack does not write {type(obj).__name__}")


def msgpack_parts(tree) -> list:
    """The msgpack encoding of ``tree`` as :func:`msgpack_serialize` gives
    it, in pieces: headers as ``bytes`` and each array's data as a
    ``memoryview`` of its own buffer (no copy)."""
    parts = []
    _pack(parts.append, tree)
    return parts


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` gives for
    ``tree``: nested string-keyed dicts (written in sorted key order, as
    flax's ``tree_map`` leaves them) of arrays, tensors, numpy scalars
    and Python scalars; a bfloat16 tensor is written as flax writes a
    bfloat16 array."""
    out = io.BytesIO()
    _pack(out.write, tree)
    return out.getvalue()


def write_parts(path, parts) -> int:
    """:func:`msgpack_parts` written to ``path``, each array's bytes from
    its own buffer, so no copy of the whole tree is made. The file appears
    whole (written beside, then renamed). Returns the bytes written."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        for part in parts:
            f.write(part)
        size = f.tell()
    os.replace(tmp, path)
    return size


def save_msgpack(path, tree) -> int:
    """``tree`` in flax's msgpack format at ``path``
    (:func:`msgpack_parts`, :func:`write_parts`); returns the bytes
    written."""
    return write_parts(path, msgpack_parts(tree))
