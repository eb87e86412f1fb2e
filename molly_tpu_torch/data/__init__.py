"""The port's own copy of the data layer (``molly_tpu/data``): tokenizers,
the parquet SFT dataset, collators and the host input pipeline. Numpy only;
``pandas`` / ``pyarrow`` are imported inside ``OmicsDataset``."""

from .tokenizers import (
    OMICS_SPECIAL_TOKENS,
    ByteTextTokenizer,
    HFTextTokenizer,
    NucleotideTokenizer,
    ProteinTokenizer,
    load_text_tokenizer,
)
from .omics_dataset import (
    DataConfig,
    OmicsDataset,
    OmicsSampleEncoder,
    StreamingOmicsDataset,
    task_name_to_id,
    LABEL_IGNORE,
    ENCODER_PAD_ID,
    NUM_DOMAIN_TASKS,
    UNKNOWN_TASK_ID,
)
from .collate import (collate_train, collate_test, iterate_batches,
                      iterate_stream_batches)


def default_modality_tokenizers():
    """(dna_rna, protein) tokenizers — native C++ when buildable, else Python."""
    try:
        from .native_tokenizers import (NativeNucleotideTokenizer,
                                        NativeProteinTokenizer,
                                        native_available)
        if native_available():
            return NativeNucleotideTokenizer(), NativeProteinTokenizer()
    except Exception:
        pass
    return NucleotideTokenizer(), ProteinTokenizer()
