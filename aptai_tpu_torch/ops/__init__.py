from aptai_tpu_torch.ops.align import dtw_force_align, viterbi_align
from aptai_tpu_torch.ops.attention import (flash_attention_bhtd_bwd_plain,
                                           flash_attention_bhtd_cuda,
                                           flash_attention_bhtd_plain,
                                           flash_attention_bwd_cuda,
                                           multi_head_attention_bhtd)
from aptai_tpu_torch.ops.ctc import ctc_forward_score, ctc_loss, greedy_decode
from aptai_tpu_torch.ops.fir import fir_lowpass, lowpass_fir_taps
from aptai_tpu_torch.ops.forward_sum import (forward_sum_loss,
                                             off_diag_prior_logprobs)
from aptai_tpu_torch.ops.fused_conv import (fused_conv_ln_gelu,
                                            fused_conv_ln_gelu_cuda,
                                            fused_conv_ln_gelu_plain)
from aptai_tpu_torch.ops.lstm import LSTMParams, bilstm, lstm
from aptai_tpu_torch.ops.signal import (butter_lowpass_filtfilt, filtfilt,
                                        interp1d_linear, interpolate_nan,
                                        mel_filterbank, melspectrogram, mfcc,
                                        resample, stft_magnitude)

__all__ = ["LSTMParams", "bilstm", "butter_lowpass_filtfilt",
           "ctc_forward_score", "ctc_loss", "dtw_force_align", "filtfilt",
           "fir_lowpass", "flash_attention_bhtd_bwd_plain",
           "flash_attention_bhtd_cuda", "flash_attention_bhtd_plain",
           "flash_attention_bwd_cuda", "forward_sum_loss",
           "fused_conv_ln_gelu", "fused_conv_ln_gelu_cuda",
           "fused_conv_ln_gelu_plain", "greedy_decode", "interp1d_linear",
           "interpolate_nan", "lowpass_fir_taps", "lstm", "mel_filterbank",
           "melspectrogram", "mfcc", "multi_head_attention_bhtd",
           "off_diag_prior_logprobs", "resample", "stft_magnitude",
           "viterbi_align"]
