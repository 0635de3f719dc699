from aptai_tpu_torch.models.aptai import APTAI, PREDICT_FIELDS, random_aptai
from aptai_tpu_torch.models.configs import Wav2Vec2Config, tiny_config
from aptai_tpu_torch.models.convert import (state_dict_from_jax,
                                            w2v2_pr_state_dict_from_jax)
from aptai_tpu_torch.models.w2v2_pr import (ENCODE_FIELDS, W2V2PR,
                                            random_w2v2_pr)
from aptai_tpu_torch.models.wav2vec2 import Wav2Vec2Model

__all__ = ["APTAI", "ENCODE_FIELDS", "PREDICT_FIELDS", "W2V2PR",
           "Wav2Vec2Config", "Wav2Vec2Model", "random_aptai",
           "random_w2v2_pr", "state_dict_from_jax", "tiny_config",
           "w2v2_pr_state_dict_from_jax"]
