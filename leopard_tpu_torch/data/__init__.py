"""Host-side data modules: anyres tiling, chat and conversation templates,
the tokenizer, the processor, the native index builders and the training
datasets and loader."""
