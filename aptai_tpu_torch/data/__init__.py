"""The data layer (the JAX package's ``aptai_tpu/data``): the vocabulary,
wav IO, the corpora over their CSV manifests (read without pandas,
:mod:`aptai_tpu_torch.data.manifest`), collation, bucketed and prefetched
loaders, and the synthetic corpora."""

from aptai_tpu_torch.data.audio_io import load_wav_16k
from aptai_tpu_torch.data.batching import (BucketedLoader, PrefetchLoader,
                                           collate_ctc, collate_tv)
from aptai_tpu_torch.data.commonphone import CommonPhoneDataset
from aptai_tpu_torch.data.hprc import (HPRC_SPEAKERS, HPRCDataset,
                                       speaker_onehot)
from aptai_tpu_torch.data.synthetic import (make_synthetic_commonphone,
                                            make_synthetic_hprc)
from aptai_tpu_torch.data.textgrid import parse_textgrid, textgrid_phonemes
from aptai_tpu_torch.data.vocab import (BLANK_TOKEN, SIL_TOKEN, build_vocab,
                                        ids_to_phonemes, load_vocab,
                                        phonemes_to_ids, save_vocab)

__all__ = ["BLANK_TOKEN", "BucketedLoader", "CommonPhoneDataset",
           "HPRCDataset", "HPRC_SPEAKERS", "PrefetchLoader", "SIL_TOKEN",
           "build_vocab", "collate_ctc", "collate_tv", "ids_to_phonemes",
           "load_vocab", "load_wav_16k", "make_synthetic_commonphone",
           "make_synthetic_hprc", "parse_textgrid", "phonemes_to_ids",
           "save_vocab", "speaker_onehot", "textgrid_phonemes"]
