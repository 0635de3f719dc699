"""The port's flax msgpack writer and its inverse weight bridge against the
JAX package and flax, on the CPU at tiny sizes:

* each family's parameter file (APTAI, W2V2PR, Wav2Vec2Pretrain,
  ForceAPTAI whole and head-only, an APTAI with ``fused_qkv`` and
  ``do_stable_layer_norm=False``): the port's bytes for its model's
  ``state_dict()`` equal the JAX manager's file of the JAX tree of the
  same weights (``save_pytree``: flax ``to_bytes`` after a host fetch
  that leaves every dict's keys sorted); ``msgpack_restore`` of them
  equals that of ``flax.serialization.to_bytes`` of the tree (keys,
  dtypes, shapes, bits); ``from_bytes`` restores them into the JAX
  model's ``init`` template, float32 leaf for leaf; the bridge
  round-trips both ways bit for bit;
* a bfloat16 leaf, numpy scalars and arrays chunked with both packages'
  ``MAX_CHUNK_SIZE`` lowered together: byte for byte;
* the optax Adam state of the JAX trainers' four shapes (plain, weight
  decay, masked, decay + masked): a JAX state read into a torch optimizer
  and written back is the JAX manager's bytes, and restores into
  ``torch_adam(...).init(params)``;
* steps that disagree, and moments where the JAX trainer freezes, raise;
* the frozen FE under weight decay: the JAX package's moments grow, the
  port's file holds zeros (the divergence ROADMAP Queue 3 pins).
"""

import functools

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from aptai_tpu.models import APTAI as JaxAPTAI
from aptai_tpu.models import W2V2PR as JaxW2V2PR
from aptai_tpu.models import ForceAPTAI as JaxForceAPTAI
from aptai_tpu.models import configs as jcfg
from aptai_tpu.train import checkpoints as jckpt
from aptai_tpu.train import harness as jharness
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models.aptai import APTAI
from aptai_tpu_torch.models.convert import (any_state_dict_from_jax,
                                            jax_params_from_any_state_dict)
from aptai_tpu_torch.models.force_aptai import ForceAPTAI
from aptai_tpu_torch.train import checkpoints as tckpt
from aptai_tpu_torch.train.harness import torch_adam

from _torch_port import (one_torch_thread, random_jax_aptai_params,
                         random_jax_force_params, random_jax_w2v2_pr_params)
from _torch_pretrain_tiny import TINY
from _torch_pretrain_tiny import jax_model as jax_pretrain_model
from _torch_pretrain_tiny import port_from_jax as port_pretrain_from_jax
from _torch_pretrain_tiny import random_jax_params as random_jax_pretrain

STACK = dict(conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))
V = 9
VARIANT = dict(fused_qkv=True, do_stable_layer_norm=False)
FAMILIES = ("aptai", "w2v2_pr", "pretrain", "force_aptai", "force_head",
            "aptai_fused_qkv_post_ln")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _template(kind):
    """The parameter shapes and dtypes of the JAX model's ``init``, as the
    JAX loader and builders call it (traced, not run)."""
    n, key = 3200, jax.random.PRNGKey(0)
    audio, lengths = jnp.zeros((1, n)), jnp.full((1,), n, jnp.int32)
    if kind == "pretrain":
        cfg = jcfg.tiny_config(**TINY)
        model, key = jax_pretrain_model(), {
            "params": key, "gumbel": key, "negatives": key}
    else:
        cfg = jcfg.tiny_config(**STACK, **(
            VARIANT if kind == "aptai_fused_qkv_post_ln" else {}))
    t = int(cfg.feat_extract_output_lengths(np.asarray(n)))
    args = {"aptai": (jnp.zeros((1, t), jnp.int32), jnp.zeros((1, t, 9))),
            "w2v2_pr": (jnp.full((1, 4), -100, jnp.int32),),
            "force_aptai": (jnp.zeros((1, 200, 9)),),
            "pretrain": (jnp.zeros((1, t), bool), jnp.float32(2.0))}
    if kind.startswith("aptai"):
        model, kind = JaxAPTAI(cfg, num_phonemes=V), "aptai"
    elif kind == "w2v2_pr":
        model = JaxW2V2PR(cfg)
    elif kind.startswith("force"):
        model, kind = JaxForceAPTAI(cfg, vocab_size=V), "force_aptai"
    kw = {"deterministic": True} if kind == "pretrain" else {}
    return jax.eval_shape(functools.partial(model.init, **kw), key, audio,
                          lengths, *args[kind])["params"]


def _jax_tree_and_port(kind):
    """The JAX package's tree of noisy random weights (its own HF
    converter) and the port model holding them."""
    cfg = tcfg.tiny_config(**STACK)
    if kind == "pretrain":
        cfg = tcfg.tiny_config(**TINY)
        tree = random_jax_pretrain(cfg, 4)
        return tree, port_pretrain_from_jax(cfg, tree)
    if kind.startswith("aptai"):
        if kind != "aptai":
            cfg = tcfg.tiny_config(**STACK, **VARIANT)
        tree = random_jax_aptai_params(cfg, V, 1)
        model = APTAI(cfg, num_phonemes=V)
    elif kind == "w2v2_pr":
        tree = random_jax_w2v2_pr_params(cfg, 2)
        from aptai_tpu_torch.models.w2v2_pr import W2V2PR
        model = W2V2PR(cfg)
    else:
        tree = random_jax_force_params(jcfg.tiny_config(**STACK), V, 5)
        model = ForceAPTAI(cfg, vocab_size=V)
    model.load_state_dict(any_state_dict_from_jax(tree), strict=True)
    return tree, model


def _same_leaves(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same_leaves(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert got.tobytes() == want.tobytes(), path


@pytest.mark.parametrize("kind", FAMILIES)
def test_params_file_is_flax_bytes(kind, tmp_path):
    tree, model = _jax_tree_and_port(kind)
    sd = model.state_dict()
    if kind == "force_head":  # the cache mode's head-only saves
        tree = {k: v for k, v in tree.items() if k != "w2v2_pr"}
        sd = {k: v for k, v in sd.items() if not k.startswith("w2v2_pr.")}
    jckpt.save_pytree(tmp_path / "jax.msgpack", tree)
    tckpt.save_msgpack(tmp_path / "params.msgpack",
                       tckpt.to_host(tckpt.flax_params_tree(sd)))
    got = (tmp_path / "params.msgpack").read_bytes()
    assert got == (tmp_path / "jax.msgpack").read_bytes()
    _same_leaves(serialization.msgpack_restore(got),
                 serialization.msgpack_restore(serialization.to_bytes(tree)))

    # the JAX model's own template: its keys, float32 everywhere
    template = _template(kind)
    if kind == "force_head":
        template = {k: v for k, v in template.items() if k != "w2v2_pr"}
    restored = serialization.from_bytes(template, got)
    for (path, leaf), spec in zip(jax.tree_util.tree_leaves_with_path(
            restored), jax.tree.leaves(template)):
        assert leaf.dtype == spec.dtype == np.float32, path
        assert leaf.shape == spec.shape, path

    # the bridge, both ways, bit for bit
    back = jax_params_from_any_state_dict(sd)
    _same_leaves({k: v for k, v in jax.tree.map(
        lambda t: t.numpy(), back).items()}, jax.tree.map(np.asarray, tree))
    sd2 = any_state_dict_from_jax(back)
    assert sd2.keys() == sd.keys()
    assert all(torch.equal(sd2[k], v) for k, v in sd.items())


def test_bf16_scalars_and_chunks_are_flax_bytes(monkeypatch):
    rng = np.random.default_rng(0)
    bf = rng.standard_normal((5, 3)).astype(np.float32)
    tree = {"w": rng.standard_normal((40, 3)).astype(np.float32),
            "b": jnp.asarray(bf, jnp.bfloat16),
            "s": {"f": np.float32(2.5), "i": np.int64(-7),
                  "count": np.array(4, np.int32)}, "e": {},
            "many": {str(i): np.arange(i, dtype=np.int16)
                     for i in range(12)}}
    port = dict(tree, b=torch.from_numpy(bf).to(torch.bfloat16))
    assert tckpt.msgpack_serialize(port) == fser.msgpack_serialize(tree)
    # 40 × 3 float32 in 11 pieces of 12 elements, bfloat16 in 3 of 6
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 48)
    monkeypatch.setattr(tckpt, "MAX_CHUNK_SIZE", 48)
    got = tckpt.msgpack_serialize(port)
    assert got == fser.msgpack_serialize(tree)
    raw = serialization.msgpack_restore(got)
    assert raw["b"].dtype == jnp.bfloat16 and raw["s"]["i"] == -7
    ours = tckpt.msgpack_restore(got)
    np.testing.assert_array_equal(ours["w"], tree["w"])
    assert torch.equal(ours["b"], port["b"])
    assert ours["s"]["f"] == np.float32(2.5) and ours["e"] == {}


# (family, weight decay, JAX frozen prefixes)
OPTAX = {"plain": ("aptai", 0.0, ()),
         "decay": ("aptai", 1e-2, ()),
         "masked": ("force_aptai", 0.0, ("w2v2_pr",)),
         "decay_masked": ("force_head", 1e-2, ("w2v2_pr",))}


def _adam_filled(state, rng):
    """The optax state ``state`` with its Adam count 2 and random moments
    (``optax.MaskedNode`` leaves kept): the JAX trainer's state after
    two updates, without compiling them."""
    if isinstance(state, optax.ScaleByAdamState):
        draw = lambda a: np.abs(rng.standard_normal(a.shape)).astype(
            np.float32)
        return state._replace(count=np.array(2, np.int32),
                              mu=jax.tree.map(draw, state.mu),
                              nu=jax.tree.map(draw, state.nu))
    if isinstance(state, optax.MaskedState):
        return state._replace(inner_state=_adam_filled(state.inner_state,
                                                       rng))
    return tuple(_adam_filled(s, rng) for s in state)


@pytest.mark.parametrize("shape", list(OPTAX))
def test_optax_state_read_and_written_back(shape, tmp_path):
    """The JAX trainer's optax state (its ``init``, then a count and
    moments of two updates); the port reads it into ``torch_adam`` and
    writes it back: the JAX manager's bytes, restorable into the
    ``init``."""
    kind, decay, frozen = OPTAX[shape]
    tree, model = _jax_tree_and_port(kind)
    if kind == "force_head":
        tree = {k: v for k, v in tree.items() if k != "w2v2_pr"}
    params = jax.tree.map(np.asarray, tree)
    tx = jharness.torch_adam(weight_decay=decay, frozen_prefixes=frozen)
    state = _adam_filled(tx.init(params), np.random.default_rng(7))
    jckpt.save_pytree(tmp_path / "jax.msgpack", state)
    want = (tmp_path / "jax.msgpack").read_bytes()

    restored = tckpt.jax_adam_state(serialization.msgpack_restore(want),
                                    params)
    opt = torch_adam(model, weight_decay=decay)
    tckpt.load_optimizer_state(opt, model, restored)
    sd = model.state_dict()
    if kind == "force_head":
        sd = {k: v for k, v in sd.items() if not k.startswith("w2v2_pr.")}
    adam = tckpt.JaxAdamState.from_optimizer(opt, model)
    assert adam.count == 2 and adam.weight_decay == decay
    got = tckpt.msgpack_serialize(tckpt.to_host(
        tckpt.optax_adam_state(adam, sd)))
    assert got == want
    back = serialization.from_bytes(tx.init(params), got)
    inner = back.inner_state if frozen else back
    scale = inner[-1]
    assert scale.count.dtype == np.int32 and int(scale.count) == 2
    assert all(leaf.dtype == np.float32
               for leaf in jax.tree.leaves((scale.mu, scale.nu)))


def test_disagreeing_steps_and_frozen_moments_raise():
    tree, model = _jax_tree_and_port("force_aptai")
    head = [p for n, p in model.named_parameters()
            if not n.startswith("w2v2_pr.")]
    opt = torch.optim.Adam(head, lr=1e-3)
    for p in head:
        p.grad = torch.ones_like(p)
    opt.step()
    sd = model.state_dict()
    # a parameter stepped once more than the others
    lone = opt.state[model.frame_lin.weight]
    lone["step"] = lone["step"] + 1
    with pytest.raises(ValueError, match="Adam steps disagree"):
        tckpt.JaxAdamState.from_optimizer(opt, model)
    # lagging with zero moments: the JAX package's zeros, at the count
    lone["step"] = lone["step"] - 2
    lone["exp_avg"].zero_()
    lone["exp_avg_sq"].zero_()
    adam = tckpt.JaxAdamState.from_optimizer(opt, model)
    assert adam.count == 1 and len(adam.exp_avg) == len(head) - 1
    mu = tckpt.optax_adam_state(adam, sd)["inner_state"]["0"]["mu"]
    assert not mu["frame_lin"]["kernel"].any()
    assert mu["w2v2_pr"]["pr_head"]["kernel"] == {}
    # moments for a tower parameter, which the JAX trainer masks
    tower = "w2v2_pr.pr_head.weight"
    adam.exp_avg[tower] = adam.exp_avg_sq[tower] = sd[tower]
    with pytest.raises(ValueError, match="freezes"):
        tckpt.optax_adam_state(adam, sd)


def test_frozen_fe_under_weight_decay_pins_the_divergence():
    """The JAX package freezes APTAI's FE by ``stop_gradient``: a zero
    gradient, which ``add_decayed_weights`` turns into ``decay * param``,
    so under weight decay its FE moments grow and the FE decays. The
    port's FE runs under ``no_grad``: Adam never steps it, and its file
    holds zero moments for it (exact at decay 0; ROADMAP Queue 3)."""
    tree, model = _jax_tree_and_port("aptai")
    params = jax.tree.map(np.asarray, tree)
    fe = lambda t: t["encoder"]["feature_extractor"]["layers_0"]["conv"][
        "kernel"]
    # the JAX step on the FE's kernel (zero gradient) and a head's
    small = {"encoder": {"feature_extractor": {"layers_0": {"conv": {
        "kernel": fe(params)}}}}, "tv_linear": params["tv_linear"]}
    grads = jax.tree.map(np.ones_like, small)
    grads["encoder"] = jax.tree.map(np.zeros_like, small["encoder"])
    for decay in (0.0, 1e-2):
        tx = jharness.torch_adam(weight_decay=decay)
        _, state = tx.update(grads, tx.init(small), small)
        assert bool(np.any(fe(state[-1].mu))) == (decay > 0)
        assert np.all(state[-1].mu["tv_linear"]["kernel"])

    opt = torch_adam(model, weight_decay=1e-2)
    before = model.wav2vec2.feature_extractor.conv_layers[0].conv.weight
    before = before.detach().clone()
    for name, p in model.named_parameters():
        if not name.startswith("wav2vec2.feature_extractor."):
            p.grad = torch.ones_like(p)
    opt.step()
    conv = model.wav2vec2.feature_extractor.conv_layers[0].conv.weight
    assert torch.equal(conv, before) and conv not in opt.state
    adam = tckpt.JaxAdamState.from_optimizer(opt, model)
    mu = tckpt.optax_adam_state(adam, model.state_dict())["1"]["mu"]
    assert not fe(mu).any() and fe(mu).shape == fe(params).shape
