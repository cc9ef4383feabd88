from federated_multi_modal_tpu_torch.tokenizer.bpe import (
    CONTEXT_LENGTH,
    EOT_TOKEN,
    SOT_TOKEN,
    VOCAB_SIZE,
    ClipTokenizer,
    get_tokenizer,
    tokenize,
)

__all__ = [
    "CONTEXT_LENGTH",
    "EOT_TOKEN",
    "SOT_TOKEN",
    "VOCAB_SIZE",
    "ClipTokenizer",
    "get_tokenizer",
    "tokenize",
]
