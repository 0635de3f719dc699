"""aptai_tpu_torch's builders on the CPU: the pretrained encoder and the
FORCE tower from each checkpoint format (this package's run, the JAX
package's, an HF-named torch file, the reference's
``pytorch_model.bin``).
"""

import dataclasses
import json

import pytest
import torch

from aptai_tpu.models.hf_convert import convert_w2v2_pr
from aptai_tpu.train import checkpoints as jckpt
from aptai_tpu_torch.models import configs as tcfg
from aptai_tpu_torch.models import random_w2v2_pr
from aptai_tpu_torch.train import builders
from aptai_tpu_torch.train import config as tconfig
from aptai_tpu_torch.train.checkpoints import CheckpointManager

from _torch_port import one_torch_thread


# the 7-layer conv stack (49 frames a second, as the manifests), tiny widths
STACK = dict(conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
             conv_stride=(5, 2, 2, 2, 2, 2, 2))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


# -- builders -----------------------------------------------------------------

def _pr_sources(tmp_path):
    """One tiny W2V2PR's weights as each builder input: a port run, a JAX
    run (msgpack through the bridge), an HF-named torch file (torch ≥ 2.1
    weight-norm names) and the reference's ``pytorch_model.bin``."""
    cfg_t = tcfg.tiny_config(**STACK)
    pr = random_w2v2_pr(cfg_t, seed=7)
    sd = pr.state_dict()
    model_cfg = {"backbone": dataclasses.asdict(cfg_t), "vocab": {},
                 "kind": "w2v2_pr"}
    CheckpointManager(tmp_path / "port_run", "m").update(
        0, {"m": 1.0}, sd, model_cfg=model_cfg)
    jckpt.CheckpointManager(tmp_path / "jax_run", "m").update(
        0, {"m": 1.0}, convert_w2v2_pr(
            {k: v.numpy() for k, v in sd.items()}, cfg_t.num_hidden_layers),
        model_cfg=model_cfg)
    pc = "wav2vec2.encoder.pos_conv_embed.conv."
    hf = {k.replace(f"{pc}weight_g", f"{pc}parametrizations.weight.original0")
          .replace(f"{pc}weight_v", f"{pc}parametrizations.weight.original1"):
          v for k, v in sd.items()}
    torch.save(hf, tmp_path / "hf.pt")
    ref = tmp_path / "ref_run" / "best-model-ckpt"
    ref.mkdir(parents=True)
    torch.save(hf, ref / "pytorch_model.bin")
    (ref / "model_cfg.json").write_text(json.dumps(model_cfg))
    return cfg_t, sd


@pytest.mark.parametrize("source", ["port_run", "jax_run", "hf.pt"])
def test_pretrained_encoder_from_each_format(tmp_path, source, capsys):
    cfg_t, sd = _pr_sources(tmp_path)
    cfg = tconfig.APTAIConfig(platform="cpu",
                              pretrained_checkpoint=str(tmp_path / source))
    model, _ = builders.build_aptai_model(cfg, {f"p{i}": i for i in range(5)},
                                          tiny=cfg_t, seed=1)
    got = model.wav2vec2.state_dict()
    assert all(torch.equal(v, sd[f"wav2vec2.{k}"]) for k, v in got.items())
    if source != "hf.pt":  # a graft reports what it spliced
        assert f"{len(got)} leaves spliced" in capsys.readouterr().out


@pytest.mark.parametrize("source", ["port_run", "jax_run", "ref_run"])
def test_force_tower_from_each_format(tmp_path, source):
    cfg_t, sd = _pr_sources(tmp_path)
    cfg = tconfig.ForceAPTAIConfig(platform="cpu", dtype="float32")
    vocab = {f"p{i}": i for i in range(cfg_t.vocab_size)}
    model, model_cfg = builders.build_force_model(cfg, vocab,
                                                  str(tmp_path / source))
    assert model_cfg["pr_spliced"] and model.cfg == cfg_t
    got = model.w2v2_pr.state_dict()
    assert set(got) == set(sd)
    assert all(torch.equal(v, sd[k]) for k, v in got.items())
    _, unspliced = builders.build_force_model(
        cfg, vocab, str(tmp_path / "nowhere"), tiny=cfg_t)
    assert not unspliced["pr_spliced"]
