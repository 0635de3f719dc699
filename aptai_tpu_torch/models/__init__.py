from aptai_tpu_torch.models.aptai import APTAI, PREDICT_FIELDS, random_aptai
from aptai_tpu_torch.models.configs import Wav2Vec2Config, tiny_config
from aptai_tpu_torch.models.convert import state_dict_from_jax
from aptai_tpu_torch.models.wav2vec2 import Wav2Vec2Model

__all__ = ["APTAI", "PREDICT_FIELDS", "Wav2Vec2Config", "Wav2Vec2Model",
           "random_aptai", "state_dict_from_jax", "tiny_config"]
