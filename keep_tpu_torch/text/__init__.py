from keep_tpu_torch.text.bpe import BPETokenizer  # noqa: F401
from keep_tpu_torch.text.tokenizer import WordPieceTokenizer  # noqa: F401
