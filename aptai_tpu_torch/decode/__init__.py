"""CTC decoders on the host: the prefix beam search and its two uses.
The batched greedy decode is :func:`aptai_tpu_torch.ops.ctc.greedy_decode`.
"""

from aptai_tpu_torch.decode.beam import (BeamHypothesis, beam_search,
                                         decode_best, decode_with_times)

__all__ = ["BeamHypothesis", "beam_search", "decode_best",
           "decode_with_times"]
