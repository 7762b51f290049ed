"""Host-side data modules: anyres tiling, chat templates, the tokenizer."""
