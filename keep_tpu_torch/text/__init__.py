from keep_tpu_torch.text.tokenizer import WordPieceTokenizer  # noqa: F401
