from aptai_tpu_torch.ops.attention import (flash_attention_bhtd_bwd_plain,
                                           flash_attention_bhtd_cuda,
                                           flash_attention_bhtd_plain,
                                           flash_attention_bwd_cuda,
                                           multi_head_attention_bhtd)
from aptai_tpu_torch.ops.fir import fir_lowpass, lowpass_fir_taps

__all__ = ["fir_lowpass", "flash_attention_bhtd_bwd_plain",
           "flash_attention_bhtd_cuda", "flash_attention_bhtd_plain",
           "flash_attention_bwd_cuda", "lowpass_fir_taps",
           "multi_head_attention_bhtd"]
