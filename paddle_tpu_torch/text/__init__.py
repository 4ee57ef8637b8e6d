"""Text of the port (counterpart of ``paddle_tpu/text``): ``models``
(BERT). The datasets (``Conll05st``, ``Imdb``, ``Imikolov``,
``Movielens``, ``UCIHousing``, ``WMT14``, ``WMT16``) and Viterbi
decoding (``ViterbiDecoder``, ``viterbi_decode``) come with the long
tail of the port (ROADMAP.md A12): their names raise
``NotImplementedError`` saying so."""
from . import models
from .models import (BertForPretraining, BertModel,  # noqa: F401
                     BertPretrainingCriterion, bert_base, bert_tiny)

_LATER = ("Conll05st", "Imdb", "Imikolov", "Movielens", "UCIHousing",
          "WMT14", "WMT16", "ViterbiDecoder", "viterbi_decode")

__all__ = ["models", "BertModel", "BertForPretraining",
           "BertPretrainingCriterion", "bert_base", "bert_tiny"]


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"paddle_tpu_torch.text.{name} comes with the long tail of the "
            "port (ROADMAP.md A12)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
