from aptai_tpu_torch.models.aptai import APTAI, PREDICT_FIELDS, random_aptai
from aptai_tpu_torch.models.configs import Wav2Vec2Config, tiny_config
from aptai_tpu_torch.models.convert import (force_aptai_state_dict_from_jax,
                                            state_dict_from_jax,
                                            w2v2_pr_state_dict_from_jax)
from aptai_tpu_torch.models.force_aptai import ForceAPTAI, random_force_aptai
from aptai_tpu_torch.models.modules import (ConvBank, CrossAttention,
                                            PhonemeEncoder, RNNHead,
                                            sinusoidal_positional_encoding)
from aptai_tpu_torch.models.w2v2_pr import (ENCODE_FIELDS, W2V2PR,
                                            random_w2v2_pr)
from aptai_tpu_torch.models.wav2vec2 import Wav2Vec2Model

__all__ = ["APTAI", "ConvBank", "CrossAttention", "ENCODE_FIELDS",
           "ForceAPTAI", "PREDICT_FIELDS", "PhonemeEncoder", "RNNHead",
           "W2V2PR", "Wav2Vec2Config", "Wav2Vec2Model",
           "force_aptai_state_dict_from_jax", "random_aptai",
           "random_force_aptai", "random_w2v2_pr",
           "sinusoidal_positional_encoding", "state_dict_from_jax",
           "tiny_config", "w2v2_pr_state_dict_from_jax"]
