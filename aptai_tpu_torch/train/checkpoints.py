"""Checkpoints with the JAX package's experiment-directory scheme
(``aptai_tpu/train/checkpoints.py``):

  <exp_dir>/
    experiment_args.json      — full config
    vocab.json                — phoneme vocabulary
    best-model-ckpt/          — params at the best target metric
    last-model-ckpt/          — params + optimizer state + step (resume)
    model-ckpts/e%04d/        — optional per-epoch params

with the same JSON files and keys (``model_cfg.json``, ``train_meta.json``).
Tensors are stored in this package's own format: ``params.pt`` holds a
model's ``state_dict()`` on the CPU and ``opt_state.pt`` an optimizer's
``state_dict()`` (its tensors on the CPU), both written with ``torch.save``
and read with ``torch.load(weights_only=True)``.

The JAX package's ``params.msgpack`` and ``opt_state.msgpack``
(``flax.serialization.to_bytes``) are read by :func:`msgpack_restore`, a
decoder of the msgpack subset flax writes, into nested dicts of numpy
arrays. Parameters cross the bridge in ``models/convert.py``; so do the
Adam moments of a JAX run's last checkpoint (:func:`jax_adam_state`), which
have the parameters' tree structure. A manager therefore resumes a JAX
run's directory; it writes this package's files beside the JAX ones, which
it never rewrites. Writing flax msgpack is not implemented.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from aptai_tpu_torch.models.convert import any_state_dict_from_jax

PARAMS = "params.pt"
OPT_STATE = "opt_state.pt"
FLAX_PARAMS = "params.msgpack"
FLAX_OPT_STATE = "opt_state.msgpack"


def to_host(tree):
    """A (nested) state dict with every tensor detached and on the CPU: the
    device→host copy of a checkpoint write."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


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
    """best / last / per-epoch checkpoints with target-metric selection."""

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
        """A last checkpoint of either package is there: ``params.pt`` or
        the JAX package's ``params.msgpack``."""
        return ((self.last_dir / PARAMS).exists()
                or (self.last_dir / FLAX_PARAMS).exists())

    def update(self, epoch: int, metrics: Dict[str, float], params,
               opt_state=None, step: int = 0,
               model_cfg: Optional[Dict] = None,
               save_last: bool = True) -> bool:
        """Save last (and per-epoch), and best when the target improves;
        True if this epoch became the new best.

        ``params`` / ``opt_state`` are state dicts, their tensors possibly
        on the card: they move to the host only when this epoch writes.
        ``save_last=False`` skips the last checkpoint this epoch (the
        ``--ckpt_every`` cadence); an improving epoch writes it anyway, so
        ``train_meta.json`` stays coherent with the newest params on disk.
        """
        value = float(metrics[self.target_metric])
        improved = self.is_improvement(value)
        if improved:
            self.best_value = value
        save_last = save_last or improved
        if improved or self.save_all_epochs or save_last:
            params = to_host(params)

        if improved:
            save_state(self.best_dir / PARAMS, params)
            if model_cfg is not None:
                save_json(self.best_dir / "model_cfg.json", model_cfg)

        if self.save_all_epochs:
            save_state(self.all_dir / f"e{epoch:04d}" / PARAMS, params)

        if save_last:
            self._write_last(params, opt_state, model_cfg, {
                "epoch": epoch,
                "step": int(step),
                "best_value": self.best_value,
                "metrics": {k: float(v) for k, v in metrics.items()},
            })
        return improved

    def _write_last(self, params, opt_state, model_cfg, meta) -> None:
        save_state(self.last_dir / PARAMS, params)
        if opt_state is not None:
            save_state(self.last_dir / OPT_STATE, opt_state)
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
        self._write_last(to_host(params), opt_state, model_cfg, {
            "epoch": resume_epoch - 1,
            "step": int(step),
            "best_value": self.best_value,
            "metrics": {},
            "preempted": True,
        })

    def restore_last(self, map_location=None):
        """``(params, opt_state or None, meta)`` of the last checkpoint,
        tensors on ``map_location``; the best watermark comes back too.

        Where the directory holds only the JAX package's files, the params
        cross the bridge and ``opt_state`` is a :class:`JaxAdamState`
        (:func:`load_optimizer_state` keys it into an optimizer by
        parameter name). A ``params.pt`` is newer than a ``params.msgpack``
        beside it (this package resumed the JAX run), so it wins."""
        meta = load_json(self.last_dir / "train_meta.json")
        self.best_value = meta.get("best_value")
        params = read_params(self.last_dir, map_location)
        opt_state = None
        if (self.last_dir / PARAMS).exists():
            if (self.last_dir / OPT_STATE).exists():
                opt_state = load_state(self.last_dir / OPT_STATE,
                                       map_location)
        elif (self.last_dir / FLAX_OPT_STATE).exists():
            opt_state = jax_adam_state(
                load_flax_params(self.last_dir / FLAX_OPT_STATE),
                load_flax_params(self.last_dir / FLAX_PARAMS))
        return params, opt_state, meta

    def restore_best(self, map_location=None):
        return read_params(self.best_dir, map_location)


def read_params(ckpt_dir, map_location=None) -> Dict:
    """The ``state_dict`` of a checkpoint directory: ``params.pt`` (its
    tensors on ``map_location``), else a JAX run's ``params.msgpack``
    through the bridge of its family (CPU tensors)."""
    ckpt_dir = Path(ckpt_dir)
    if (ckpt_dir / PARAMS).exists():
        return load_state(ckpt_dir / PARAMS, map_location)
    return any_state_dict_from_jax(load_flax_params(ckpt_dir / FLAX_PARAMS))


# -- a JAX run's optax Adam state -----------------------------------------------

@dataclasses.dataclass
class JaxAdamState:
    """The optax Adam state of a JAX run's last checkpoint, its moments
    under this package's parameter names (float32 CPU tensors)."""

    count: int
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]

    def torch_state_dict(self, optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module) -> Dict:
        """``optimizer``'s ``state_dict`` holding these moments, each keyed
        to its parameter by the name ``model`` gives it; ``step`` is the
        optax ``count`` (float32, as ``torch.optim.Adam`` keeps it)."""
        names = {id(p): n for n, p in model.named_parameters()}
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
                if m.shape != p.shape:
                    raise ValueError(f"the JAX Adam moments of {name!r} have "
                                     f"shape {tuple(m.shape)}, the parameter "
                                     f"{tuple(p.shape)}")
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
    return JaxAdamState(
        int(adam["count"]),
        any_state_dict_from_jax(_unmask(adam["mu"], params_tree)),
        any_state_dict_from_jax(_unmask(adam["nu"], params_tree)))


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module, opt_state) -> None:
    """Load a restored ``opt_state`` into ``optimizer`` (over ``model``'s
    parameters): this package's ``state_dict``, or a
    :class:`JaxAdamState`."""
    if isinstance(opt_state, JaxAdamState):
        opt_state = opt_state.torch_state_dict(optimizer, model)
    optimizer.load_state_dict(opt_state)


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
