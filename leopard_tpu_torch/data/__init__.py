"""Host-side data modules: anyres tiling, chat and conversation templates,
the tokenizer, the LLaVA and Idefics2 processors, the native index builders
and the training datasets and loader."""
