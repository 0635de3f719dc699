"""CTC decoders: the prefix beam search on the host (the C++ twin first,
then the pure-Python one) and its uses, the batched beam search on the
device, and the edit distance. The batched greedy decode is
:func:`aptai_tpu_torch.ops.ctc.greedy_decode`.
"""

from aptai_tpu_torch.decode.beam import (BeamHypothesis, beam_decode_padded,
                                         beam_search, decode_best,
                                         decode_with_times)
from aptai_tpu_torch.decode.device import beam_decode_device
from aptai_tpu_torch.decode.native import (beam_search_native, edit_distance,
                                           native_available)

__all__ = ["BeamHypothesis", "beam_decode_device", "beam_decode_padded",
           "beam_search", "beam_search_native", "decode_best",
           "decode_with_times", "edit_distance", "native_available"]
