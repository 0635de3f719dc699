from aptai_tpu_torch.data.vocab import (BLANK_TOKEN, SIL_TOKEN, build_vocab,
                                        ids_to_phonemes, load_vocab,
                                        phonemes_to_ids, save_vocab)

__all__ = ["BLANK_TOKEN", "SIL_TOKEN", "build_vocab", "ids_to_phonemes",
           "load_vocab", "phonemes_to_ids", "save_vocab"]
